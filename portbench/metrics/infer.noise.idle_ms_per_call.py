"""The card's idle time under the drawing of a sampled decode's Gumbel
noise on the host and its copy to the card (span g2v.gen.noise, in
`_noise`) over the generation calls (spans g2v.gen.call) in the traced
window (layer: infer; moves frames_per_s). A port without the span, or
a greedy decode, gives nothing."""
from portbench.harness.program_spans import idle_ms_per, span_count
from portbench.harness.reading import device_trace
from portbench.programs import g2v_record

NAME, UNIT = "infer.noise.idle_ms_per_call", "ms/call"


def read(record):
    trace = device_trace(record)
    if trace is None:
        return None
    spans = g2v_record.spans()
    if not span_count(trace, spans, "g2v.gen.noise"):
        return None
    return idle_ms_per(trace, spans, "g2v.gen.noise", "g2v.gen.call")
