"""Device kernels, copies and sets in the traced window over the real
windows generated in it (layer: infer, `GestureGenerator.generate_batch`;
moves frames_per_s)."""
from portbench.harness.reading import device_trace

NAME, UNIT = "infer.device_ops_per_window", "ops/window"


def read(record):
    trace = device_trace(record)
    if trace is None or not record.get("windows"):
        return None
    return len(trace.ops()) / record["windows"]
