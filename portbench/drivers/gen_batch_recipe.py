"""Offline batch generation with the recommended recipe: the traffic of
`drivers/gen_batch.py` (a closed loop of one caller running
`GestureGenerator.generate_batch` back to back over the cell's
transcripts), with the transformer Part d, the 4-stage residual-VQ
tokenizer and the configuration's decode (`programs/g2v_recipe.py`).

`frames_per_s` is the real (unpadded) frames of every call in the window
over the wall time of those calls; each call ends when its frames are
on the host.

Correctness: one call of the window, drawn from the seed by a reservoir,
is judged by `reference/g2v_recipe.judge` after the window: its tokens,
its residual codes and chunk latents (observed on their way into the
rollout and the DAE, `_decode_chunks`), the Gumbel noise it drew
(observed as `_noise` returns it) and its frames, for every transcript.
"""
from __future__ import annotations

import time

import numpy as np

from portbench.drivers.gen_batch import Observer, durations
from portbench.harness import hostload
from portbench.harness import trace as tr
from portbench.harness import weights as wts
from portbench.programs import g2v_recipe as program
from portbench.reference import g2v as ref_g2v
from portbench.reference import g2v_recipe as ref
from portbench.work import g2v as work_g2v
from portbench.work import g2v_recipe as work


class NoiseObserver(Observer):
    """`Observer`, also keeping the Gumbel noise of the last call (None
    when the decode is greedy)."""

    def __init__(self, gen, spans: bool):
        super().__init__(gen, spans)
        self.noise = None
        draw = gen._noise

        def observed(*args, **kwargs):
            self.noise = draw(*args, **kwargs)
            return self.noise

        gen._noise = observed


def _answers(cfg, result, observer, n_win):
    """The program's answers of one call, transcript by transcript."""
    T = cfg["sentence_frame_length"] // cfg["n_poses"]
    rows_per_win = T * cfg["n_poses"]
    seen = observer.pred["tokens"].cpu().numpy()
    out = []
    for b, (frames, tokens) in enumerate(result):
        n_tok = n_win[b] * T
        noise = observer.noise
        out.append(ref.Answer(
            tokens, observer.pred["stage"][b, :n_tok],
            None if noise is None else noise[b, :n_win[b]].clone(),
            observer.latents[b, :n_win[b] * rows_per_win], frames,
            consistent=np.array_equal(seen[b, :n_tok], tokens)))
    return out


def run(ctx) -> dict:
    cfg, traffic, dev = ctx.config, ctx.workload["traffic"], ctx.device
    durs = durations(traffic)
    rng = np.random.default_rng(ctx.seed)
    pool = [[ref_g2v.transcript(rng, d, cfg["n_words"],
                                traffic["words_per_s"]) for d in durs]
            for _ in range(int(traffic["distinct_batches"]))]
    spec = ref.weight_spec(cfg)
    gen = program.generator(cfg, wts.make(spec, ctx.seed, dev), ctx.seed, dev)
    observer = NoiseObserver(gen, ctx.trace)
    unit = cfg["sentence_frame_length"] / cfg["fps"]
    n_win = [max(int(np.ceil(d / unit)), 1) for d in durs]
    T = cfg["sentence_frame_length"] // cfg["n_poses"]
    frames_per_call = sum(n_win) * cfg["sentence_frame_length"]
    # warm-up: the cell's one shape (every call pads to the same bucket)
    gen.generate_batch(pool[0], durs)
    ctx.sync()
    ctx.settle()
    setup_s = time.perf_counter() - ctx.t0

    keep = np.random.default_rng([ctx.seed, 1])
    kept, calls, busy = None, 0, 0.0
    tracer = ctx.tracer() if ctx.trace else None
    if tracer:
        tracer.start()
    with tr.span(tr.WINDOW, ctx.trace):
        start = time.perf_counter()
        host_load = hostload.Window()
        while calls == 0 or time.perf_counter() - start < ctx.seconds:
            batch = pool[calls % len(pool)]
            t = time.perf_counter()
            with tr.span("gen.call", ctx.trace):
                result = gen.generate_batch(batch, durs)
            busy += time.perf_counter() - t
            host_load.mark(frames_per_call)
            calls += 1
            if keep.random() * calls < 1.0:
                kept = (batch, _answers(cfg, result, observer, n_win))
            del result
        host_load = host_load.close()
    if tracer:
        tracer.stop()
    trace = tracer.trace() if tracer else None
    peak = ctx.memory_peak()

    windows = calls * sum(n_win)
    chunks = windows * T
    frames = calls * frames_per_call
    # the program's state goes before the reference runs
    del gen, observer
    ctx.free()
    weights = wts.make(spec, ctx.seed, dev)
    readings = ref.judge(cfg, weights, kept[0], durs, kept[1], dev)
    control = ref.judge(cfg, weights, kept[0], durs, kept[1], dev,
                        control=True) if ctx.control else None
    record = {"trace": trace, "host": host_load, "calls": calls,
              "windows": windows,
              "model_flops": work.generation_flops(cfg, windows, chunks,
                                                   frames),
              "chunk_decoder_work": [work_g2v.chunk_decoder_work(
                  sum(n_win) * T, cfg["dae_latent"], cfg["hidden_size"],
                  cfg["n_poses"])] * calls}
    return {"attempted": calls * len(durs), "failed": 0,
            "end_to_end": {"frames_per_s": frames / busy,
                           "setup_s": setup_s},
            "readings": readings, "control_readings": control,
            "record": record,
            "memory_peak_bytes": peak}
