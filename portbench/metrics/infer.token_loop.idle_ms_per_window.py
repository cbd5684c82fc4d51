"""The card's idle time under the program's token loop (span
g2v.gen.token_loop, `_predict_windows`' decode) over the serial windows
it ran (spans g2v.gen.token_window, one a window of the carried decode)
in the traced window (layer: infer; moves frames_per_s)."""
from portbench.harness.program_spans import idle_ms_per
from portbench.harness.reading import device_trace
from portbench.programs import g2v_record

NAME, UNIT = "infer.token_loop.idle_ms_per_window", "ms/window"


def read(record):
    trace = device_trace(record)
    if trace is None:
        return None
    return idle_ms_per(trace, g2v_record.spans(), "g2v.gen.token_loop",
                       "g2v.gen.token_window")
