"""The benchmark's recommended-recipe cell (`gen_batch.recipe`) on the
CPU at small widths: the port's generator against the plain reference
(`portbench/reference/g2v_recipe.py`), greedy and sampled, carried over
several windows with residual stages; each fault planted in the program
breaks one of the cell's limits; the reference imports neither JAX nor
the port; the decoder-position counters count replayed and eager windows
alike; the two new readers; the new BENCHMARK.json entries resolve; the
frozen operation count equals the port's."""
import ast
import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from gesture2vec_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parent.parent
CELL = "gen_batch.recipe"
SMALL = dict(hidden_size=16, codes=32, n_words=60, wordembed_dim=12,
             pose_dim=9, dae_latent=4, max_words=8)
# 1, 2 and 4 windows, padded to a bucket of 4
SMALL_TRAFFIC = dict(transcripts=3, min_s=6.0, max_s=20.0,
                     distinct_batches=2)
GREEDY = dict(temperature=0.0, stage0_temperature=-1.0)
POSITIONS = ("gen.token_positions_computed", "gen.token_positions_read")


def _cell(config=(), traffic=()):
    from portbench.harness import registry

    workload = registry.workload(CELL)
    config_ = registry.config(workload["config"])
    config_.update(SMALL, **dict(config))
    workload["traffic"].update(SMALL_TRAFFIC, **dict(traffic))
    return workload, config_


def _run(seed, config=(), traffic=()):
    """The driver's output of one run of the cell at small widths."""
    from portbench import run as bench_run
    from portbench.harness import registry

    workload, config_ = _cell(config, traffic)
    ctx = bench_run.Context(CELL, workload, config_, seed, 0.0, False,
                            device="cpu", t0=time.perf_counter())
    return registry.driver(workload["driver"]).run(ctx)


def _broken(readings, limits):
    return [k for k, lim in limits.items() if readings[k] > lim]


@pytest.mark.parametrize("decode", ["greedy", "sampled"])
def test_the_recipe_matches_the_reference(decode):
    out = _run(2 ** 31 + 5, GREEDY if decode == "greedy" else ())
    r = out["readings"]
    assert r["mismatch"] == 0
    assert r["token_gap"] <= 1e-5
    assert r["latent_err"] <= 1e-5 and r["frame_err"] <= 1e-5
    # every real window of the three transcripts decoded, carried
    assert out["record"]["windows"] == out["record"]["calls"] * (1 + 2 + 4)


def _faulty(fault):
    """The program's generator with one fault planted."""
    from gesture2vec_tpu_torch.models import transformer
    from portbench.programs import g2v_recipe as program

    build = program.generator

    def generator(cfg, weights, seed, device):
        if fault == "bf16_transformer":
            cls = transformer.TransformerText2Token

            class Bf16(cls):
                def __init__(self, *args, **kwargs):
                    super().__init__(*args, compute_dtype=torch.bfloat16,
                                     **kwargs)

            transformer.TransformerText2Token = Bf16
            try:
                return build(cfg, weights, seed, device)
            finally:
                transformer.TransformerText2Token = cls
        gen = build(cfg, weights, seed, device)
        if fault == "independent_heads":
            gen.t2t_model.decoder.stage_conditional = False
        elif fault == "dropped_row":
            hidden = gen.seq_decoder.token_hidden
            gen.seq_decoder.token_hidden = lambda tok, stage, *rest: hidden(
                tok, stage[:, :-1], *rest)
        elif fault == "wrong_carry":
            window = gen._token_window

            def carried_early(bufs):
                window(bufs)
                bufs["seed"][:, 0] = bufs["tokens"][:, 1]

            gen._token_window = carried_early
        elif fault == "noiseless_primary":
            decode = gen._decode_windows

            def noiseless(enc, hidden, seed, mask, gumbel):
                gumbel = gumbel.clone()
                gumbel[..., 0, :] = 0.0
                return decode(enc, hidden, seed, mask, gumbel)

            gen._decode_windows = noiseless
        elif fault == "altered_token":
            model = gen.t2t_model
            decode = model.decode_tokens

            def altered(*args, **kwargs):
                res = decode(*args, **kwargs)
                res["tokens"][0, -1] = (res["tokens"][0, -1] + 1) % \
                    model.n_tokens
                return res

            model.decode_tokens = altered
        return gen

    return generator


@pytest.mark.parametrize("fault", ["independent_heads", "dropped_row",
                                   "wrong_carry", "noiseless_primary",
                                   "altered_token", "bf16_transformer"])
def test_each_planted_fault_fails_the_judge(fault, monkeypatch):
    from portbench.programs import g2v_recipe as program

    monkeypatch.setattr(program, "generator", _faulty(fault))
    # bf16 shows only where rounding flips a choice: more windows
    traffic = {"min_s": 60.0, "max_s": 120.0} \
        if fault == "bf16_transformer" else ()
    workload, _ = _cell()
    out = _run(12345678901, traffic=traffic)
    assert _broken(out["readings"], workload["limits"]), out["readings"]


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    return names


def test_the_reference_imports_neither_jax_nor_the_port():
    todo, seen, found = ["portbench.reference.g2v_recipe"], set(), set()
    while todo:
        mod = todo.pop()
        if mod in seen:
            continue
        seen.add(mod)
        for name in _imports(ROOT / (mod.replace(".", "/") + ".py")):
            found.add(name.split(".")[0])
            if name.startswith("portbench.") and \
                    (ROOT / (name.replace(".", "/") + ".py")).is_file():
                todo.append(name)
    assert "portbench.reference.g2v" in seen
    assert not found & {"jax", "jaxlib", "flax", "optax", "gesture2vec_tpu",
                        "gesture2vec_tpu_torch"}


class _Replay:
    """A stand-in for a captured window on the CPU: its replay runs the
    window function on the staged buffers, as the graph does."""

    def __init__(self, gen, bufs):
        self.gen, self.bufs = gen, bufs

    def replay(self):
        self.gen._token_window(self.bufs)


@pytest.mark.parametrize("path", ["eager", "replayed", "uncarried"])
@pytest.mark.parametrize("model,per_row", [("recipe", (25, 5)),
                                           ("paper", (5, 5))])
def test_the_position_counters_count_every_window(model, per_row, path,
                                                  monkeypatch):
    from portbench.drivers.gen_batch import durations
    from portbench.harness import registry
    from portbench.harness import weights as wts
    from portbench.programs import g2v, g2v_recipe
    from portbench.reference import g2v as ref
    from portbench.reference import g2v_recipe as ref_recipe

    cfg = registry.config("g2v_" + model)
    cfg.update(SMALL)
    spec = (ref_recipe if model == "recipe" else ref).weight_spec(cfg)
    build = (g2v_recipe if model == "recipe" else g2v).generator
    gen = build(cfg, wts.make(spec, 3, "cpu"), 3, "cpu")
    if path == "replayed":
        def captured(first, seed):
            bufs = {k: v.clone() for k, v in first.items()}
            bufs["seed"] = seed.clone()
            return _Replay(gen, bufs), bufs

        monkeypatch.setattr(gen, "_token_graph_ok", lambda enc, W: True)
        monkeypatch.setattr(gen, "_token_graph", captured)
    gen.window_carry = path != "uncarried"
    durs = durations(SMALL_TRAFFIC)
    rng = np.random.default_rng(3)
    words = [ref.transcript(rng, d, cfg["n_words"], 2.5) for d in durs]
    before = profiling.counters()
    gen.generate_batch(words, durs)
    after = profiling.counters()

    def delta(name):
        return after.get(name, 0) - before.get(name, 0)

    rows = len(durs) * 4                       # 3 rows of a bucket of 4
    assert (delta(POSITIONS[0]), delta(POSITIONS[1])) == (
        per_row[0] * rows, per_row[1] * rows)
    assert delta("gen.token_graph_replays") == (4 if path == "replayed"
                                                else 0)


def _trace():
    from portbench.harness.trace import Trace

    # the card busy over [1, 2) ms and [5, 6) ms of a 10 ms window
    return Trace([("k", 1_000_000, 2_000_000), ("k", 5_000_000, 6_000_000)],
                 [], (0, 10_000_000))


@pytest.mark.parametrize("counts,want", [
    ({POSITIONS[0]: 7600, POSITIONS[1]: 1520}, 20.0),
    ({POSITIONS[0]: 1520, POSITIONS[1]: 1520}, 100.0),
    ({}, None),
    ({"gen.token_windows": 608}, None),
])
def test_the_token_decoder_yield_reads_the_counters(counts, want,
                                                    monkeypatch):
    from portbench.harness import registry
    from portbench.programs import g2v_record

    reader = registry.metric("infer.token_decoder_yield")
    monkeypatch.setattr(g2v_record, "counters", lambda: dict(counts))
    assert reader.read({"trace": None}) is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    got = reader.read({"trace": _trace()})
    assert got == (None if want is None else pytest.approx(want))


@pytest.mark.parametrize("spans,want", [
    # two calls; noise spans over [0, 3) and [4, 5.5) ms, the card idle
    # over [0, 1), [2, 3) and [4, 5) of them: 3 ms over 2 calls
    ([("g2v.gen.call", 0, 4_000_000), ("g2v.gen.noise", 0, 3_000_000),
      ("g2v.gen.call", 4_000_000, 10_000_000),
      ("g2v.gen.noise", 4_000_000, 5_500_000)], 1.5),
    # a port without the span, or a greedy decode
    ([("g2v.gen.call", 0, 10_000_000)], None),
    ([], None),
])
def test_the_noise_idle_reads_the_spans(spans, want, monkeypatch):
    from portbench.harness import registry
    from portbench.programs import g2v_record

    reader = registry.metric("infer.noise.idle_ms_per_call")
    monkeypatch.setattr(g2v_record, "spans", lambda: list(spans))
    assert reader.read({"trace": None}) is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    got = reader.read({"trace": _trace()})
    assert got == (None if want is None else pytest.approx(want))


@pytest.mark.parametrize("decode", ["greedy", "sampled"])
def test_a_sampled_call_keeps_one_noise_span_under_a_profiler(decode):
    from portbench.drivers.gen_batch import durations
    from portbench.harness import weights as wts
    from portbench.programs import g2v_recipe
    from portbench.reference import g2v as ref
    from portbench.reference import g2v_recipe as ref_recipe

    _, cfg = _cell(GREEDY if decode == "greedy" else ())
    gen = g2v_recipe.generator(
        cfg, wts.make(ref_recipe.weight_spec(cfg), 4, "cpu"), 4, "cpu")
    durs = durations(SMALL_TRAFFIC)
    rng = np.random.default_rng(4)
    words = [ref.transcript(rng, d, cfg["n_words"], 2.5) for d in durs]
    before = len(profiling.spans())
    gen.generate_batch(words, durs)
    assert len(profiling.spans()) == before      # no profiler, no span
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        gen.generate_batch(words, durs)
    names = [n for n, _, _ in profiling.spans()[before:]]
    assert names.count("g2v.gen.call") == 1
    assert names.count("g2v.gen.noise") == (decode == "sampled")


def test_the_new_benchmark_entries_resolve():
    from portbench.harness import registry

    bench = registry.benchmark()
    entry = registry.cell_entry(bench, CELL)
    assert (entry["config"], entry["chips"]) == ("g2v_recipe", 1)
    workload = registry.workload(CELL)
    assert workload["config"] == "g2v_recipe"
    config = registry.config(workload["config"])
    (listed,) = [c for c in bench["configs"] if c["name"] == "g2v_recipe"]
    assert listed["file"] == "portbench/configs/g2v_recipe.json"
    assert listed["reduced"] == config["reduced"] == []
    assert hasattr(registry.driver(workload["driver"]), "run")
    assert [m["name"] for m in registry.end_to_end_of(bench, CELL)] == [
        "frames_per_s", "setup_s"]
    names = [m["name"] for m in registry.per_layer_of(bench, CELL)]
    assert set(names) == {
        "infer.device_ops_per_window", "mfu.gen", "chunk_decoder_roofline",
        "device.idle_share.gen", "infer.token_loop.idle_ms_per_window",
        "infer.frames_to_host.idle_ms_per_call",
        "infer.unnormalize.idle_ms_per_call", "infer.chunk_yield",
        "infer.token_graph_share", "infer.token_decoder_yield",
        "infer.noise.idle_ms_per_call", "infer.host_copy_yield"}
    for name in names:
        assert registry.metric(name).NAME == name


def test_the_frozen_count_equals_the_port():
    from gesture2vec_tpu_torch.utils import flops
    from portbench.work import g2v, g2v_recipe

    cfg = json.loads((ROOT / "portbench/configs/g2v_recipe.json")
                     .read_text())
    kw = dict(max_words=48, embed=300, hidden=200, n_layers=2, n_steps=6,
              codes=512)
    for batch in (1, 304, 2815):
        assert g2v_recipe.transformer_t2t_flops(batch, **kw) == \
            flops.transformer_t2t_forward_flops(batch, **kw)
    f = g2v_recipe.generation_flops(cfg, 2815, 2815 * 6, 2815 * 120)
    want = (flops.transformer_t2t_forward_flops(2815, **kw)
            + 3 * g2v.dense_flops(2815 * 5, 200, 512)
            + g2v.chunk_decoder_work(2815 * 6, 40, 200, 20)[0]
            + g2v.dense_flops(2815 * 120, 40, 135))
    assert f == pytest.approx(want, rel=1e-12)
