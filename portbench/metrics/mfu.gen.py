"""The whole generation step's share of the card's bf16 peak: the
analytic operations of the real windows, chunks and frames generated in
the traced window (`work/g2v.generation_flops`), over the window's
length, over 989 TFLOP/s (layer: model step; moves frames_per_s)."""
from portbench.harness.reading import device_trace
from portbench.work.peaks import PEAK_BF16_FLOPS

NAME, UNIT = "mfu.gen", "%"


def read(record):
    trace = device_trace(record)
    if trace is None or not record.get("model_flops") \
            or "windows" not in record:
        return None
    return 100.0 * record["model_flops"] / trace.window_s / PEAK_BF16_FLOPS
