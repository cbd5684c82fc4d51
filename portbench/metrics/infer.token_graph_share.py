"""The share of the carried token decode's serial windows that ran as the
replay of a CUDA graph: 100 x the program's counter
gen.token_graph_replays over gen.token_windows, over the run's calls: the
set-up's warm-up and the window's, all of the cell's one shape (layer:
infer; moves frames_per_s). Read in traced runs. A port that counts no
windows gives nothing."""
from portbench.harness.reading import device_trace
from portbench.programs import g2v_record

NAME, UNIT = "infer.token_graph_share", "%"


def read(record):
    if device_trace(record) is None:
        return None
    counts = g2v_record.counters()
    windows = counts.get("gen.token_windows", 0)
    if not windows:
        return None
    return 100.0 * counts.get("gen.token_graph_replays", 0) / windows
