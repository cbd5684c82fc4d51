"""Samples trained a second over the traced window: batch x its steps
over its wall time, which ends in a synchronise (layer: train; moves
train_device_ms_per_step). The host paces the step, so the host's speed
moves this rate from run to run by 10-15 %; the tracer slows it too."""
NAME, UNIT = "train.samples_per_s", "samples/s"


def read(record):
    if record.get("trace") is None or not record.get("steps"):
        return None
    return record["samples_per_s"]
