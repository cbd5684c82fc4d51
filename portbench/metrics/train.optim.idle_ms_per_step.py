"""The card's idle time under the step's optimizer (span g2v.step.optim,
`Adam.step`) over the steps (spans g2v.step) in the traced window
(layer: train; moves train_device_ms_per_step, as the cell's metric:
the host's pace does not move the card's busy time)."""
from portbench.harness.program_spans import idle_ms_per
from portbench.harness.reading import device_trace
from portbench.programs import g2v_record

NAME, UNIT = "train.optim.idle_ms_per_step", "ms/step"


def read(record):
    trace = device_trace(record)
    if trace is None:
        return None
    return idle_ms_per(trace, g2v_record.spans(), "g2v.step.optim",
                       "g2v.step")
