"""The share of the rolled-out chunks whose frames the generation calls
return: 100 x the program's counter gen.chunks_real over gen.chunks_rolled
(B x N a rollout, padding included), over the run's calls: the set-up's
warm-up and the window's, all of the cell's one shape, so the share is
each call's (layer: infer; moves frames_per_s). Read in traced runs."""
from portbench.harness.reading import device_trace
from portbench.programs import g2v_record

NAME, UNIT = "infer.chunk_yield", "%"


def read(record):
    if device_trace(record) is None:
        return None
    counts = g2v_record.counters()
    rolled = counts.get("gen.chunks_rolled", 0)
    if not rolled:
        return None
    return 100.0 * counts.get("gen.chunks_real", 0) / rolled
