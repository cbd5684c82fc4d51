"""The GRU backward kernel's share of its roofline (4 launches a step at
T=20, B=128, H=200, one dgh @ w_hh a step): the least time of its
launches (`work/g2v.gru_backward_work`) over the device time of the
trace's GRU backward kernels (layer: kernels, `ops/gru_kernel` ->
`csrc/gru_sequence_backward.cu`; moves train_device_ms_per_step)."""
from portbench.harness.reading import device_trace, roofline_share

NAME, UNIT = "gru_bwd_roofline", "%"
KERNELS = ("gru_sequence_backward",)


def read(record):
    trace = device_trace(record)
    if trace is None or not record.get("gru_bwd_work"):
        return None
    return roofline_share(trace, KERNELS, record["gru_bwd_work"])
