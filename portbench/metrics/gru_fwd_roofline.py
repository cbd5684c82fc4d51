"""The GRU forward kernel's share of its roofline in training (the
gate-saving variant, 4 launches a step at T=20, B=128, H=200): the least
time of its launches (`work/g2v.gru_gates_work`) over the device time of
the trace's forward GRU kernels (layer: kernels, `ops/gru_kernel` ->
`csrc/gru_sequence.cu`; moves train_device_ms_per_step)."""
from portbench.harness.reading import device_trace, roofline_share

NAME, UNIT = "gru_fwd_roofline", "%"
KERNELS = ("gru_sequence_kernel",)
EXCLUDE = ("backward",)


def read(record):
    trace = device_trace(record)
    if trace is None or not record.get("gru_fwd_work"):
        return None
    return roofline_share(trace, KERNELS, record["gru_fwd_work"], EXCLUDE)
