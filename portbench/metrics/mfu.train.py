"""The whole training step's share of the card's bf16 peak: 3x the
tokenizer's analytic forward a step (`work/g2v.train_b_flops`) times the
traced window's steps, over the window's length, over 989 TFLOP/s
(layer: model step; moves train_device_ms_per_step)."""
from portbench.harness.reading import device_trace
from portbench.work.peaks import PEAK_BF16_FLOPS

NAME, UNIT = "mfu.train", "%"


def read(record):
    trace = device_trace(record)
    if trace is None or not record.get("model_flops") \
            or "steps" not in record:
        return None
    return 100.0 * record["model_flops"] / trace.window_s / PEAK_BF16_FLOPS
