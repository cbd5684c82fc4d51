"""The share of the token decoder's computed positions that its choices
read: 100 x the program's counter gen.token_positions_read over
gen.token_positions_computed, over the run's calls: the set-up's warm-up
and the window's, all of the cell's one shape (layer: infer; moves
frames_per_s). The transformer's uncached decode re-runs its whole
(n_steps - 1)-slot buffer for each token and reads one slot: 20 % at
n_steps = 6. Read in traced runs. A port that counts no positions gives
nothing."""
from portbench.harness.reading import device_trace
from portbench.programs import g2v_record

NAME, UNIT = "infer.token_decoder_yield", "%"


def read(record):
    if device_trace(record) is None:
        return None
    counts = g2v_record.counters()
    computed = counts.get("gen.token_positions_computed", 0)
    if not computed:
        return None
    return 100.0 * counts.get("gen.token_positions_read", 0) / computed
