"""The card's idle share over the traced window: 1 - the union of its
operations' intervals over the window (layer: device, the H100; moves
train_device_ms_per_step)."""
from portbench.harness.reading import device_trace, idle_share

NAME, UNIT = "device.idle_share.train", "%"


def read(record):
    trace = device_trace(record)
    return None if trace is None else idle_share(trace)
