"""The readers of the program's own spans and counters: the trace keeps
what it read before when the program's spans are on it, the idle time
under a span and the span count on hand-made intervals, each reader on an
untraced record, on a port that records nothing, and on a traced run at
the CPU tests' widths, whose program spans lie inside the drivers' own."""
import json
import time

import pytest

from conftest import ROOT, SMALL_GEN, SMALL_GEN_TRAFFIC, SMALL_TRAIN, \
    SMALL_TRAIN_TRAFFIC

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
SPAN_READERS = {
    "infer.token_loop.idle_ms_per_window": ("g2v.gen.token_loop",
                                            "g2v.gen.token_window"),
    "infer.frames_to_host.idle_ms_per_call": ("g2v.gen.frames_to_host",
                                              "g2v.gen.call"),
    "infer.unnormalize.idle_ms_per_call": ("g2v.gen.unnormalize",
                                           "g2v.gen.call"),
    "train.forward.idle_ms_per_step": ("g2v.step.forward", "g2v.step"),
    "train.backward.idle_ms_per_step": ("g2v.step.backward", "g2v.step"),
    "train.optim.idle_ms_per_step": ("g2v.step.optim", "g2v.step"),
    "train.feed.idle_ms_per_step": ("g2v.feed.wait", "g2v.step"),
}
READERS = sorted(SPAN_READERS) + ["infer.chunk_yield"]
# ns: how far apart two readings of one instant on the host's clock may lie
SLACK = 50_000


class _Event:
    """A kineto event as `trace.from_events` reads one."""

    def __init__(self, name, start, end, on_card=False):
        import torch

        self._name, self._s, self._d = name, start, end - start
        self._type = (torch.autograd.DeviceType.CUDA if on_card
                      else torch.autograd.DeviceType.CPU)

    def name(self):
        return self._name

    def device_type(self):
        return self._type

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d


def _trace(ops, window=(0, 100)):
    from portbench.harness.trace import Trace

    return Trace(ops, [], window)


def test_the_trace_reads_as_before_with_the_programs_spans_on_it():
    from portbench.harness.trace import from_events

    bench = [_Event("bench.window", 0, 1000),
             _Event("bench.gen.call", 10, 900),
             _Event("chunk_decode_kernel", 100, 300, True),
             _Event("Memcpy DtoH", 400, 800, True),
             _Event("bench.infer.rollout", 90, 310),
             _Event("bench.infer.rollout", 95, 305, True)]
    program = [_Event("g2v.gen.call", 12, 898),
               _Event("g2v.gen.rollout", 92, 309),
               _Event("g2v.gen.rollout", 96, 304, True),
               _Event("g2v.gen.frames_to_host", 390, 810),
               _Event("g2v.gen.frames_to_host", 395, 805, True)]
    before = from_events(bench, (0, 1000))
    after = from_events(bench + program, (0, 1000))
    assert after.spans == before.spans
    assert after.device_ops == before.device_ops == [
        ("chunk_decode_kernel", 100, 300), ("Memcpy DtoH", 400, 800)]
    assert json.dumps(after.breakdown()) == json.dumps(before.breakdown())


def test_idle_under_and_span_count_on_hand_made_intervals():
    from portbench.harness.program_spans import (idle_ms_per, idle_under,
                                                 in_window, span_count)

    trace = _trace([("k", 10, 20), ("k", 30, 40), ("k", 35, 60)])
    # gaps: (0, 10), (20, 30), (60, 100)
    spans = [("a", 5, 25), ("a", 15, 28), ("a", 50, 120), ("b", 0, 100),
             ("a", 150, 160), ("a", -20, -5)]
    assert in_window(trace, spans)[2] == ("a", 50, 100)
    assert idle_under(trace, spans, "a") == pytest.approx(
        (5 + 8 + 40) / 1e9)                 # (5, 10), (20, 28), (60, 100)
    assert idle_under(trace, spans, "b") == pytest.approx(60 / 1e9)
    assert idle_under(trace, spans, "c") == 0
    assert span_count(trace, spans, "a") == 3
    assert span_count(trace, spans, "b") == 1
    assert idle_ms_per(trace, spans, "a", "b") == pytest.approx(53e-6)
    assert idle_ms_per(trace, spans, "a", "c") is None


@pytest.mark.parametrize("name", READERS)
def test_a_new_reader_is_declared_for_its_cell(name):
    (entry,) = [m for m in BENCH["per_layer"] if m["name"] == name]
    cell = "gen_batch.paper" if name.startswith("infer") \
        else "train_b.paper"
    assert entry["workloads"] == [cell]
    assert entry["source"] == ("program_counter" if name ==
                               "infer.chunk_yield" else "program_span")


@pytest.mark.parametrize("name", READERS)
def test_a_new_reader_gives_none_untraced(name):
    from portbench.harness import registry

    assert registry.metric(name).read({"trace": None}) is None
    assert registry.metric(name).read({}) is None


@pytest.mark.parametrize("name", READERS)
def test_a_new_reader_gives_none_for_a_port_that_records_nothing(
        name, monkeypatch):
    """The parent's port has neither spans() nor counters()."""
    import torch

    from gesture2vec_tpu_torch.utils import profiling
    from portbench.harness import registry

    monkeypatch.delattr(profiling, "spans")
    monkeypatch.delattr(profiling, "counters")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert registry.metric(name).read({"trace": _trace([])}) is None


@pytest.mark.parametrize("name", READERS)
def test_a_new_reader_refuses_without_a_card(name):
    import torch

    from portbench.harness import registry

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError):
        registry.metric(name).read({"trace": _trace([])})


@pytest.mark.parametrize("name", sorted(SPAN_READERS))
def test_a_span_reader_reads_idle_time_per_span(name, monkeypatch):
    import torch

    from portbench.harness import registry
    from portbench.programs import g2v_record

    under, per = SPAN_READERS[name]
    spans = [(per, 0, 50), (under, 5, 25), (per, 50, 100), (under, 55, 90),
             ("g2v.other", 0, 100)]
    monkeypatch.setattr(g2v_record, "spans", lambda: spans)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    trace = _trace([("k", 10, 20), ("k", 60, 70)])
    # idle under `under`: (5, 10), (20, 25), (55, 60), (70, 90)
    got = registry.metric(name).read({"trace": trace})
    assert got == pytest.approx(1e3 * 35e-9 / 2)


def test_the_chunk_yield_reads_the_counters(monkeypatch):
    import torch

    from portbench.harness import registry
    from portbench.programs import g2v_record

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    reader = registry.metric("infer.chunk_yield")
    monkeypatch.setattr(g2v_record, "counters", lambda: {
        "gen.chunks_rolled": 58368, "gen.chunks_real": 16890})
    assert reader.read({"trace": _trace([])}) == pytest.approx(
        100 * 16890 / 58368)
    monkeypatch.setattr(g2v_record, "counters", lambda: {})
    assert reader.read({"trace": _trace([])}) is None


def _traced_run(cell):
    """(record, the program's spans in its window) of one traced run of
    the cell at the CPU tests' widths."""
    from gesture2vec_tpu_torch.utils import profiling
    from portbench import run as bench_run
    from portbench.harness import registry
    from portbench.harness.program_spans import in_window

    workload = registry.workload(cell)
    config = registry.config(workload["config"])
    train = workload["driver"] == "train_step"
    config.update(SMALL_TRAIN if train else SMALL_GEN)
    workload["traffic"].update(SMALL_TRAIN_TRAFFIC if train
                               else SMALL_GEN_TRAFFIC)
    ctx = bench_run.Context(cell, workload, config, 12345678901, 0.2, True,
                            device="cpu", t0=time.perf_counter())
    record = registry.driver(workload["driver"]).run(ctx)["record"]
    return record, in_window(record["trace"], profiling.spans())


def _within(spans, outer):
    return all(any(s - SLACK <= ps and pe <= e + SLACK for _, s, e in outer)
               for _, ps, pe in spans)


def _named(spans, name):
    return [sp for sp in spans if sp[0] == name]


def test_a_traced_generation_run_puts_the_programs_spans_in_the_drivers():
    from gesture2vec_tpu_torch.infer.text2gesture import bucket_windows
    from portbench.drivers import gen_batch

    record, spans = _traced_run("gen_batch.paper")
    trace = record["trace"]
    calls = _named(spans, "g2v.gen.call")
    assert len(calls) == record["calls"]
    assert _within(calls, _named(trace.spans, "bench.gen.call"))
    assert _within(_named(spans, "g2v.gen.rollout"),
                   _named(trace.spans, "bench.infer.rollout"))
    durs = gen_batch.durations(SMALL_GEN_TRAFFIC)
    unit = 120 / 20
    wins = [max(int(-(-d // unit)), 1) for d in durs]
    assert len(_named(spans, "g2v.gen.token_window")) == \
        record["calls"] * bucket_windows(max(wins))


def test_a_traced_training_run_puts_the_programs_spans_in_the_drivers():
    record, spans = _traced_run("train_b.paper")
    trace = record["trace"]
    steps = _named(spans, "g2v.step")
    assert len(steps) == record["steps"]
    assert _within(steps, _named(trace.spans, "bench.train.step"))
    assert _within(_named(spans, "g2v.feed.wait"),
                   _named(trace.spans, "bench.train.feed"))
    for phase in ("forward", "backward", "optim"):
        assert len(_named(spans, f"g2v.step.{phase}")) == record["steps"]
