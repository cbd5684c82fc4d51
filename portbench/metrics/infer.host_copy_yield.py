"""The share of the frames copied to the host that the generation calls
return: 100 x the program's counter gen.frames_returned over
gen.frames_copied, over the run's calls: the set-up's warm-up and the
window's, all of the cell's one shape, so the share is each call's. A
copy of the padded frames reads the real frames' share of them; a copy of
the real frames alone reads 100 (layer: infer; moves frames_per_s). Read
in traced runs. A port that counts no copied frames gives nothing."""
from portbench.harness.reading import device_trace
from portbench.programs import g2v_record

NAME, UNIT = "infer.host_copy_yield", "%"


def read(record):
    if device_trace(record) is None:
        return None
    counts = g2v_record.counters()
    copied = counts.get("gen.frames_copied", 0)
    if not copied:
        return None
    return 100.0 * counts.get("gen.frames_returned", 0) / copied
