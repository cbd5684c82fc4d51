"""Part-b training: the port's `seq_ae_trainer.TrainStep` back to back at
the configuration's batch, fed as the trainer feeds it.

Traffic (the cell's `traffic`): a corpus of `windows` windows of
n_poses latent frames made from the seed and held in host RAM
(`reference/train_b.corpus`), walked in the trainer's order (a
permutation an epoch) and moved to the card by the port's
`utils/prefetch` (a worker thread, pinned memory, one host -> card copy a
batch); dropout masks from one torch.Generator on the card, seeded from
the seed. `train_device_ms_per_step` is the card's busy time over the
window (`harness/trace.DeviceClock`, the union of its operations'
intervals, in every untraced run) over the window's steps: what a step
costs the card, which the host's speed does not move.
`train.samples_per_s`, batch x the steps over the wall time ending in
`torch.cuda.synchronize()`, is read in traced runs (per layer: the
host's speed moves it, run to run, by more than any bound can hold).

Correctness: set-up builds one step object (model, optimizer state,
feed), runs its first three steps through the same call and feed as the
window, then hands that object to the window. The reference follows
those three steps (`reference/train_b`): each step's loss, the first
step's gradient as Adam got it (its first moment / (1 - b1)), and the
parameters' change over the three.
"""
from __future__ import annotations

import time

import numpy as np

from portbench.harness import hostload
from portbench.harness import trace as tr
from portbench.harness import weights as wts
from portbench.programs import g2v as program
from portbench.reference import train_b as ref
from portbench.work import g2v as work

CHECKED_STEPS = 3
# the device clock's lap: 64 steps, some 245,000 operations, well inside
# what the profiler holds whole
CLOCK_LAP_STEPS = 64


def run(ctx) -> dict:
    import torch

    from gesture2vec_tpu_torch.models.layers import dropout_generator
    from gesture2vec_tpu_torch.utils.prefetch import prefetch

    cfg, traffic, dev = ctx.config, ctx.workload["traffic"], ctx.device
    bs = cfg["batch_size"]
    windows = ref.corpus(np.random.default_rng(ctx.seed),
                         int(traffic["windows"]), cfg["n_poses"],
                         cfg["dae_latent"])
    spec = ref.weight_spec(cfg)
    names = ref.leaf_names(spec)
    model, opt, step = program.train_step(cfg, wts.make(spec, ctx.seed, dev),
                                          dev)
    gen = torch.Generator(device=dev).manual_seed(ctx.seed)
    gen_state = gen.get_state()
    feed = prefetch(ref.batches(windows, bs, ctx.seed), device=dev)
    leaves = dict(model.named_parameters())
    start = {n: leaves[n].detach().clone() for n in names}
    losses, first = [], None
    try:
        for i in range(CHECKED_STEPS):
            with dropout_generator(gen):
                loss, _ = step(next(feed), 0.0)
            losses.append(loss)
            if i == 0:
                by_param = {id(p): m for p, m in zip(opt.params, opt.mu)}
                first = {n: by_param[id(leaves[n])] / (1.0 - opt.b1)
                         for n in names}
                change1 = {n: leaves[n].detach() - start[n] for n in names}
        change = {n: leaves[n].detach() - start[n] for n in names}
        got = {"losses": [float(v) for v in losses], "grad": first,
               "change1": change1, "change": change}
        ctx.sync()
        clock = ctx.device_clock(CLOCK_LAP_STEPS)
        if clock:
            clock.warm()
        ctx.settle()
        setup_s = time.perf_counter() - ctx.t0

        steps = 0
        tracer = ctx.tracer() if ctx.trace else None
        if tracer:
            tracer.start()
        with tr.span(tr.WINDOW, ctx.trace):
            t0 = time.perf_counter()
            host_load = hostload.Window()
            if clock:
                clock.start()
            while True:
                with tr.span("train.feed", ctx.trace):
                    batch = next(feed)
                with tr.span("train.step", ctx.trace), \
                        dropout_generator(gen):
                    step(batch, 0.0)
                steps += 1
                host_load.mark(bs)
                if time.perf_counter() - t0 >= ctx.seconds:
                    break
                # a lap reads its record inside the window; none starts
                # once the window's time is up
                if clock:
                    clock.tick()
            ctx.sync()
            wall = time.perf_counter() - t0
            host_load = host_load.close()
        if clock:
            clock.stop()
            host_load["device_ops_per_step"] = clock.ops / steps
            host_load["clock_laps"] = clock.laps
        host_load["samples_per_s"] = bs * steps / wall
        if tracer:
            tracer.stop()
        trace = tracer.trace() if tracer else None
    finally:
        feed.close()
    peak = ctx.memory_peak()
    del model, opt, step, leaves, start
    ctx.free()

    host = [b for b, _ in zip(ref.batches(windows, bs, ctx.seed),
                              range(CHECKED_STEPS))]
    xs = [torch.from_numpy(b).to(dev) for b in host]
    weights = wts.make(spec, ctx.seed, dev)
    readings = ref.judge(got, ref.reference(cfg, weights, xs, gen_state,
                                                names, dev))
    control = ref.judge(ref.control(cfg, weights, xs, gen_state, names, dev),
                        ref.reference(cfg, weights, xs, gen_state, names,
                                      dev)) if ctx.control else None
    H, T = cfg["hidden_size"], cfg["n_poses"]
    record = {"trace": trace, "host": host_load, "steps": steps,
              "samples_per_s": bs * steps / wall,
              "model_flops": work.train_b_flops(cfg, steps),
              # 2 layers x 2 directions a step, forward and backward
              "gru_fwd_work": [work.gru_gates_work(T, bs, H)]
              * (2 * cfg["n_layers"] * steps),
              "gru_bwd_work": [work.gru_backward_work(T, bs, H)]
              * (2 * cfg["n_layers"] * steps)}
    return {"attempted": steps, "failed": 0,
            "end_to_end": {"train_device_ms_per_step":
                           1e3 * clock.busy_s / steps if clock else None,
                           "setup_s": setup_s},
            "readings": readings, "control_readings": control,
            "record": record, "memory_peak_bytes": peak}
