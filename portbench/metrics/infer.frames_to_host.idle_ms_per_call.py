"""The card's idle time under the frames' copy to the host (span
g2v.gen.frames_to_host, in `_frames`) over the generation calls (spans
g2v.gen.call) in the traced window (layer: infer; moves frames_per_s)."""
from portbench.harness.program_spans import idle_ms_per
from portbench.harness.reading import device_trace
from portbench.programs import g2v_record

NAME, UNIT = "infer.frames_to_host.idle_ms_per_call", "ms/call"


def read(record):
    trace = device_trace(record)
    if trace is None:
        return None
    return idle_ms_per(trace, g2v_record.spans(), "g2v.gen.frames_to_host",
                       "g2v.gen.call")
