"""The benchmark's harness: BENCHMARK.json against its contract, the
files found by name, a cell and a metric added as files alone, the
import rules, and the judge seeing each fault a cell can have.

CPU tests at small widths; the control's test at the cells' own size is
marked `gpu` and skips without a card.
"""
import ast
import json
import math
import re
import shutil
import sys

import numpy as np
import pytest

from conftest import ROOT, small_run

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "gesture2vec_tpu"}
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_benchmark_file_keeps_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    assert all(w["chips"] == 1 for w in BENCH["workloads"])
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_and_units_use_the_allowed_characters(kind):
    names = [e["name"] for e in BENCH[kind]]
    assert len(names) == len(set(names))
    for e in BENCH[kind]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] \
                    and "\t" not in e[key]
        for key in e.get("reduced", []):
            assert NAME.match(key)


@pytest.mark.parametrize("cell", CELLS)
def test_every_file_loads_by_name(cell):
    from portbench.harness import registry

    entry = registry.cell_entry(BENCH, cell)
    workload = registry.workload(cell)
    assert workload["config"] == entry["config"]
    config = registry.config(entry["config"])
    assert config["name"] == entry["config"]
    assert hasattr(registry.driver(workload["driver"]), "run")
    for m in registry.per_layer_of(BENCH, cell):
        reader = registry.metric(m["name"])
        assert reader.NAME == m["name"] and reader.UNIT == m["unit"]
    assert set(workload["limits"]) and all(
        isinstance(v, (int, float)) for v in workload["limits"].values())


def test_config_files_match_their_entries():
    for c in BENCH["configs"]:
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["name"] == c["name"]
        assert data["reduced"] == c["reduced"]
        assert c["file"].startswith("portbench/")


@pytest.mark.parametrize("cell", CELLS)
def test_every_layer_metric_cell_reports_its_moves(cell):
    from portbench.harness import registry

    reported = {m["name"] for m in registry.end_to_end_of(BENCH, cell)}
    assert "setup_s" in reported and len(reported) >= 2
    layer = registry.per_layer_of(BENCH, cell)
    assert layer
    for m in layer:
        assert m["moves"] in reported


def test_a_cell_and_a_metric_added_as_files_alone_are_found(tmp_path):
    """A later change adds a workload file, a metric file and their
    entries; nothing that exists is edited."""
    from portbench.harness import registry

    base = tmp_path / "portbench"
    shutil.copytree(ROOT / "portbench", base,
                    ignore=shutil.ignore_patterns("__pycache__"))
    wl = json.loads((base / "workloads" / "gen_batch.paper.json")
                    .read_text())
    wl["name"] = "gen_batch.paper_short"
    wl["traffic"]["max_s"] = 60.0
    (base / "workloads" / "gen_batch.paper_short.json").write_text(
        json.dumps(wl))
    (base / "metrics" / "probe.count.py").write_text(
        'NAME, UNIT = "probe.count", "calls"\n\n\n'
        'def read(record):\n    return record.get("calls")\n')
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({**bench["workloads"][0],
                               "name": "gen_batch.paper_short"})
    bench["per_layer"].append({"name": "probe.count", "unit": "calls",
                               "better": "higher", "source": "host_clock",
                               "layer": "infer", "moves": "frames_per_s",
                               "workloads": ["gen_batch.paper_short"]})
    assert registry.workload("gen_batch.paper_short",
                             base)["traffic"]["max_s"] == 60.0
    entries = registry.per_layer_of(bench, "gen_batch.paper_short")
    assert [m["name"] for m in entries] == ["probe.count"]
    assert registry.read_metrics(entries, {"calls": 7}, base) == {
        "probe.count": {"value": 7, "unit": "calls"}}
    assert registry.read_metrics(entries, {}, base) == {}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(
    p.relative_to(ROOT).as_posix()
    for p in (ROOT / "portbench").rglob("*.py")))
def test_nothing_imports_jax_or_the_jax_package(path):
    """By whole top-level names: gesture2vec_tpu_torch passes; the
    reference imports nothing of the program either."""
    tops = {name.split(".")[0] for name in _imports(ROOT / path)}
    assert not tops & FORBIDDEN, tops & FORBIDDEN
    if path.startswith("portbench/reference/") \
            or path.startswith("portbench/work/"):
        assert "gesture2vec_tpu_torch" not in tops


def test_run_refuses_without_a_card(monkeypatch, capsys):
    import torch

    from portbench import run as bench_run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(bench_run, "cache_env", lambda: None)
    rc = bench_run.main(["--workload", CELLS[0], "--seed", "1",
                         "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""


def test_forbidden_modules_compare_whole_names(monkeypatch):
    from portbench import run as bench_run

    monkeypatch.setattr(sys, "modules", {"gesture2vec_tpu_torch.x": None,
                                         "jaxtyping": None, "numpy": None})
    assert bench_run.forbidden_modules() == []
    monkeypatch.setattr(sys, "modules", {"jax.numpy": None,
                                         "gesture2vec_tpu.ops": None})
    assert bench_run.forbidden_modules() == ["gesture2vec_tpu", "jax"]


# ------------------------------------------------------------ faults
def _correct(cell, out):
    from portbench.harness import registry

    limits = registry.workload(cell)["limits"]
    return out["failed"] == 0 and all(
        out["readings"][k] <= v for k, v in limits.items())


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_small_run_is_correct(cell):
    _, out = small_run(cell)
    assert _correct(cell, out), out["readings"]
    assert out["attempted"] > 0


@pytest.mark.parametrize("cell", [c for c in CELLS
                                  if c.startswith("gen_batch")])
def test_a_token_altered_where_it_is_produced_fails(cell, monkeypatch):
    from gesture2vec_tpu_torch.models import text2token

    original = text2token.Text2Token.decode_tokens

    def altered(self, *args, **kwargs):
        res = original(self, *args, **kwargs)
        res["tokens"][0, -1] = (res["tokens"][0, -1] + 1) % self.n_tokens
        return res

    monkeypatch.setattr(text2token.Text2Token, "decode_tokens", altered)
    _, out = small_run(cell)
    assert not _correct(cell, out), out["readings"]


@pytest.mark.parametrize("cell", [c for c in CELLS
                                  if c.startswith("gen_batch")])
def test_an_answer_altered_where_it_is_produced_fails(cell, monkeypatch):
    from gesture2vec_tpu_torch.infer import text2gesture

    original = text2gesture.ChunkSynthesis._frames

    def altered(self, frames):
        out = original(self, frames)
        out[0, 5, 0] += 0.05 * float(np.abs(out).max())
        return out

    monkeypatch.setattr(text2gesture.ChunkSynthesis, "_frames", altered)
    _, out = small_run(cell)
    assert not _correct(cell, out), out["readings"]


@pytest.mark.parametrize("cell", [c for c in CELLS if c.startswith("train")])
def test_a_step_that_leaves_its_state_unchanged_fails(cell, monkeypatch):
    from gesture2vec_tpu_torch.train import optim

    monkeypatch.setattr(optim.Adam, "step", lambda self: None)
    _, out = small_run(cell)
    assert not _correct(cell, out), out["readings"]


@pytest.mark.parametrize("cell", [c for c in CELLS if c.startswith("train")])
def test_half_the_batch_left_out_fails(cell, monkeypatch):
    from gesture2vec_tpu_torch.train import seq_ae_trainer

    original = seq_ae_trainer.TrainStep.loss

    def half(self, batch, epoch=0.0):
        return original(self, batch[: batch.shape[0] // 2], epoch)

    monkeypatch.setattr(seq_ae_trainer.TrainStep, "loss", half)
    _, out = small_run(cell)
    assert not _correct(cell, out), out["readings"]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_at_the_cells_size(cell, card):
    """The reference in TF32 put in the program's place, at the cell's
    own size, on three seeds: every seed fails one of the limits."""
    for seed in (2100000001, 2100000002, 2100000003):
        _, out = small_run(cell, seed=seed, seconds=0.0, control=True,
                           device=card)
        from portbench.harness import registry

        limits = registry.workload(cell)["limits"]
        ctrl = out["control_readings"]
        assert any(ctrl[k] > v for k, v in limits.items()), ctrl
        assert _correct(cell, out), out["readings"]
        assert all(math.isfinite(out["readings"][k]) for k in limits)


@pytest.mark.parametrize("cell", CELLS)
def test_a_run_gives_every_end_to_end_metric_of_its_cell(cell):
    """A driver's end-to-end numbers name each of the cell's metrics;
    a device number is None on the CPU, never a host-clock stand-in."""
    from portbench.harness import registry

    _, out = small_run(cell)
    names = {m["name"]: m for m in registry.end_to_end_of(BENCH, cell)}
    assert set(out["end_to_end"]) == set(names)
    for name, m in names.items():
        value = out["end_to_end"][name]
        if m["source"] == "device_trace":
            assert value is None
        else:
            assert value > 0


def test_the_device_clock_takes_the_union_of_operations():
    from portbench.harness.trace import union_ns

    assert union_ns([(5, 6), (0, 2), (1, 3), (2, 2)]) == 4
    assert union_ns([(0, 10), (2, 3)]) == 10
    assert union_ns([]) == 0
