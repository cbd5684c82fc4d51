"""The chunk-decoder kernel's share of its roofline: the least time of
the rollouts of the real chunks (operations at 67 TFLOP/s fp32 against
bytes at 3.35 TB/s, `work/g2v.chunk_decoder_work`, one launch a call)
over the device time of the trace's chunk-decoder kernels (layer:
kernels, `ops/decoder_kernel` -> `csrc/chunk_decoder.cu`; moves
frames_per_s)."""
from portbench.harness.reading import device_trace, roofline_share

NAME, UNIT = "chunk_decoder_roofline", "%"
KERNELS = ("chunk_decode",)


def read(record):
    trace = device_trace(record)
    if trace is None or not record.get("chunk_decoder_work"):
        return None
    return roofline_share(trace, KERNELS, record["chunk_decoder_work"])
