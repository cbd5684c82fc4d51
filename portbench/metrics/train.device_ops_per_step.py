"""Device kernels, copies and sets in the traced window over the training
steps in it (layer: train, `train/seq_ae_trainer.TrainStep` and
`train/optim.Adam`; moves train_device_ms_per_step)."""
from portbench.harness.reading import device_trace

NAME, UNIT = "train.device_ops_per_step", "ops/step"


def read(record):
    trace = device_trace(record)
    if trace is None or not record.get("steps"):
        return None
    return len(trace.ops()) / record["steps"]
