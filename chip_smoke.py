#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, each printing one JSON line:
  device   the card's name and power limit (nvidia-smi);
  build    nvcc builds every kernel from the sources in the checkout,
           with the ptxas register / shared-memory / spill lines;
  kernel   each kernel against its plain PyTorch version on the card,
           at the main path's shapes, with times from CUDA events;
  main     decode-mode generation at the bench widths (hidden 200,
           2 layers, 512 codes, DAE latent 40, pose 135, 20-frame
           chunks, 120-frame windows, 48 words, 5000-word table of
           300-dim embeddings), weights random from a seed and carried
           in through the JAX-layout weight bridge; three requests
           (6 s, 60 s and 1800 s transcripts) with every kernel launch
           counter set to 0 just before and read just after;
  check    the frames' shape and finiteness, the fused path against the
           module rollout on the card, and the card against the CPU
           path on the 6 s request;
  timing   frames/s of the 1800 s request and its stages;
then the kernels line, the nvidia-smi line, and as the last line
{"ok": true, "device": {...}}. Any failed phase exits non-zero; without
a CUDA device, or without the package beside it, it exits non-zero
before printing any result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
import traceback

import numpy as np

# kernel vs plain and fused vs module rollout: fp32 sums in another
# order, carried through 20 recurrent steps
TOL = 1e-4
HID, L, K, REP, DIM = 200, 2, 512, 40, 135
N_FRAMES, SENT_LEN, FPS, N_WORDS, MAXW, WORDEMBED = 20, 120, 20, 5000, 48, 300
VOCAB_WORDS = 300
REQUESTS_S = (6.0, 60.0, 1800.0)
KERNEL_BATCHES = (6, 96, 293, 1824)   # 6 s, 60 s, ragged, 1800 s
# published H100 SXM peaks: fp32 outside the tensor cores, HBM3
PEAK_FP32_FLOPS, PEAK_BYTES_S = 67e12, 3.35e12


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def words(duration_s: float, seed: int = 0):
    """Synthetic transcript at ~150 words/min (the bench workload)."""
    rng = np.random.default_rng(seed)
    n = int(2.5 * duration_s)
    starts = np.linspace(0.1, duration_s - 0.5, n)
    return [[f"word{rng.integers(200)}", float(s), float(s + 0.3)]
            for s in starts]


def jax_layout_trees(rng: np.random.Generator):
    """Random bench-width variables in the JAX package's layout (numpy),
    so the weight bridge runs here too."""
    def u(shape, fan_in):
        b = 1.0 / np.sqrt(fan_in)
        return rng.uniform(-b, b, size=shape).astype(np.float32)

    def dense(i, o):
        return {"kernel": u((i, o), i), "bias": u((o,), i)}

    def gru(in_dim):
        out = {}
        for layer in range(L):
            d = in_dim if layer == 0 else HID
            out.update({f"l{layer}_w_ih": u((3 * HID, d), HID),
                        f"l{layer}_w_hh": u((3 * HID, HID), HID),
                        f"l{layer}_b_ih": u((3 * HID,), HID),
                        f"l{layer}_b_hh": u((3 * HID,), HID)})
        return out

    def bn():
        p = {"scale": (1 + 0.1 * rng.normal(size=HID)).astype(np.float32),
             "bias": (0.1 * rng.normal(size=HID)).astype(np.float32)}
        s = {"mean": (0.1 * rng.normal(size=HID)).astype(np.float32),
             "var": rng.uniform(0.5, 1.5, size=HID).astype(np.float32)}
        return p, s

    def conv(i, o):
        return {"Conv_0": {"kernel": rng.normal(0, 0.01, size=(2, i, o))
                           .astype(np.float32), "bias": u((o,), i)},
                "wn": {"Conv_0/kernel/scale":
                       (1 + 0.1 * rng.normal(size=o)).astype(np.float32)}}

    tcn = {}
    for b in range(L):
        i = WORDEMBED if b == 0 else HID
        tcn[f"block{b}"] = {"conv1": conv(i, HID), "conv2": conv(HID, HID)}
        if i != HID:
            tcn[f"block{b}"]["downsample"] = {
                "kernel": rng.normal(0, 0.01, size=(1, i, HID))
                .astype(np.float32), "bias": u((HID,), i)}
    t2t_bn, t2t_stats = bn()
    t2t = {"params": {
        "encoder": {"embedding_table": rng.normal(
            size=(N_WORDS, WORDEMBED)).astype(np.float32),
            "tcn": tcn, "decoder": dense(HID, HID),
            "hidden_proj": dense(HID, L * HID)},
        "decoder_step": {
            "token_embedding": {"embedding": rng.normal(
                size=(K, HID)).astype(np.float32)},
            "attn": {"attn": dense(2 * HID, HID), "v": u((HID,), HID)},
            "pre_linear": dense(2 * HID, HID), "pre_bn": t2t_bn,
            "gru": gru(HID), "out_layer": dense(HID, K)}},
        "batch_stats": {"decoder_step": {"pre_bn": t2t_stats}}}
    seq_bn, seq_stats = bn()
    seq = {"params": {
        "vq_layer": {"codebook": (0.5 * rng.normal(size=(K, L * HID)))
                     .astype(np.float32)},
        "decoder_step": {"pre_linear": dense(REP, HID), "pre_bn": seq_bn,
                         "gru": gru(HID), "out_layer": dense(HID, REP)}},
        "batch_stats": {"decoder_step": {"pre_bn": seq_stats}}}
    dae = {"params": {"encoder": dense(DIM, REP), "decoder": dense(REP, DIM)}}
    return t2t, seq, dae


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_busy(fn, wall_s: float) -> dict:
    """Kernel time on the card during one call of fn (torch.profiler),
    against the unprofiled wall time of the same call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    busy_us = sum(getattr(e, "self_device_time_total", 0.0)
                  for e in prof.key_averages())
    kernels = sum(e.count for e in prof.key_averages()
                  if getattr(e, "self_device_time_total", 0.0) > 0)
    return {"busy_s": busy_us / 1e6, "device_ops": kernels,
            "idle_share": 1.0 - busy_us / 1e6 / wall_s}


def chunk_decoder_bound_ms(B: int, D: int, H: int, T: int) -> dict:
    """Least time for the rollout: its operations at the fp32 peak vs its
    bytes (inputs and weights read once, outputs written once) at the
    memory rate."""
    flops = 2.0 * B * T * (D * H + 2 * 2 * H * 3 * H + H * D)
    weights = D * H + 2 * H + 2 * (2 * H * 3 * H + 2 * 3 * H) + H * D + D
    nbytes = 4.0 * (B * D + 2 * B * H + weights + T * B * D)
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_S
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops, "bytes": nbytes}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on "
              "the card", file=sys.stderr)
        return 1
    from gesture2vec_tpu_torch.compat.from_jax import generator_from_jax
    from gesture2vec_tpu_torch.ops import build
    from gesture2vec_tpu_torch.ops import decoder_kernel as dk
    from gesture2vec_tpu_torch.text.vocab import Vocab

    # -- device -------------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    emit({"phase": "device", "kind": kind, "nvidia_smi": smi,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    # -- build --------------------------------------------------------
    t0 = time.perf_counter()
    built = build.build_all()
    secs = time.perf_counter() - t0
    for name, (lib, log) in built.items():
        ptxas = [ln.strip() for ln in log.splitlines()
                 if any(w in ln for w in ("registers", "spill", "smem",
                                          "Compiling entry"))]
        emit({"phase": "build", "kernel": name, "library": lib.name,
              "seconds": secs, "ptxas": ptxas})

    # -- the bench-width generator (weights through the bridge) ---------
    vocab = Vocab("bench")
    for i in range(VOCAB_WORDS):
        vocab.index_word(f"word{i}")
    trees = jax_layout_trees(np.random.default_rng(0))
    pose_mean = np.zeros(DIM, np.float32)
    pose_std = np.ones(DIM, np.float32)

    def make(device, fused):
        return generator_from_jax(
            *trees, vocab, pose_mean, pose_std, n_frames=N_FRAMES,
            sentence_frame_length=SENT_LEN, fps=FPS, max_words=MAXW,
            device=device, use_fused_decoder=fused)

    gen = make("cuda", True)
    folded = gen._folded

    # -- kernel vs plain ----------------------------------------------
    g = torch.Generator(device="cuda").manual_seed(0)
    kernel_rows = {}
    for B in KERNEL_BATCHES:
        x0 = torch.randn(B, REP, device="cuda", generator=g)
        h0 = torch.randn(2, B, HID, device="cuda", generator=g)
        ys = dk.fused_chunk_decode(x0, h0, folded, N_FRAMES)
        ref = dk.fused_chunk_decode_plain(x0, h0, folded, N_FRAMES)
        torch.cuda.synchronize()
        err = (ys - ref).abs().max().item()
        ms = cuda_ms(lambda: dk.fused_chunk_decode(x0, h0, folded,
                                                   N_FRAMES), 20)
        plain_ms = cuda_ms(lambda: dk.fused_chunk_decode_plain(
            x0, h0, folded, N_FRAMES), 10)
        row = {"phase": "kernel", "kernel": "chunk_decoder", "B": B,
               "H": HID, "D": REP, "n_steps": N_FRAMES,
               "max_abs_err": err, "tol": TOL, "ms": ms,
               "plain_ms": plain_ms,
               **chunk_decoder_bound_ms(B, REP, HID, N_FRAMES)}
        emit(row)
        kernel_rows[B] = row
        if not np.isfinite(err) or err > TOL:
            raise AssertionError(f"chunk_decoder B={B}: max abs error "
                                 f"{err} > {TOL}")

    # -- main path ----------------------------------------------------
    dk.fused_chunk_decode.launches = 0
    outs, per_request = {}, []
    for d in REQUESTS_S:
        outs[d] = gen.generate(words(d), d)
        per_request.append(dk.fused_chunk_decode.launches)
    launches = dk.fused_chunk_decode.launches
    emit({"phase": "main", "requests_s": list(REQUESTS_S),
          "launches": {"chunk_decoder": launches},
          "launches_after_each_request": per_request})
    if per_request != list(range(1, len(REQUESTS_S) + 1)):
        raise AssertionError(f"chunk_decoder launches after each request: "
                             f"{per_request}, want one per request")

    # -- check --------------------------------------------------------
    unit = SENT_LEN / FPS
    plain_gen = make("cuda", False)
    worst = 0.0
    for d, (frames, toks) in outs.items():
        n_windows = int(np.ceil(d / unit))
        if frames.shape != (n_windows * SENT_LEN, DIM):
            raise AssertionError(f"{d} s: frames {frames.shape}")
        if not np.isfinite(frames).all():
            raise AssertionError(f"{d} s: non-finite frames")
        frames_p, toks_p = plain_gen.generate(words(d), d)
        if not np.array_equal(toks, toks_p):
            raise AssertionError(f"{d} s: tokens differ from the rollout")
        err = float(np.abs(frames - frames_p).max())
        worst = max(worst, err)
        if err > TOL:
            raise AssertionError(f"{d} s: frames differ from the module "
                                 f"rollout by {err}")
    cpu_frames, cpu_toks = make("cpu", True).generate(words(6.0), 6.0)
    cpu_err = float(np.abs(outs[6.0][0] - cpu_frames).max())
    if not np.array_equal(outs[6.0][1], cpu_toks) or cpu_err > TOL:
        raise AssertionError(f"6 s: card vs CPU path: tokens equal "
                             f"{np.array_equal(outs[6.0][1], cpu_toks)}, "
                             f"frames {cpu_err}")
    emit({"phase": "check", "fused_vs_rollout_max_abs_err": worst,
          "card_vs_cpu_6s_max_abs_err": cpu_err, "tol": TOL,
          "tokens_identical": True,
          "distinct_tokens_1800s": int(len(np.unique(outs[1800.0][1])))})

    # -- timing -------------------------------------------------------
    def best_s(fn, reps=3):
        best = float("inf")
        for _ in range(reps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t)
        return best

    for d in REQUESTS_S:
        w = words(d)
        n_frames = outs[d][0].shape[0]
        fused_s = best_s(lambda: gen.generate(w, d))
        plain_s = best_s(lambda: plain_gen.generate(w, d))
        # stages of the fused path, host clock around synchronised work
        ids, lens, _ = gen.window_inputs(w, d)
        win_s = best_s(lambda: gen.window_inputs(w, d))
        with torch.inference_mode():
            tok_s = best_s(lambda: gen._predict_tokens(ids, lens))
            toks = gen._predict_tokens(ids, lens)
            chunk_s = best_s(lambda: gen._decode_tokens(toks))
            lat = gen._decode_tokens(toks)
            dae_s = best_s(lambda: gen.dae_model.decode(lat))
        emit({"phase": "timing", "request_s": d, "frames": n_frames,
              "fused_s": fused_s, "fused_frames_per_s": n_frames / fused_s,
              "rollout_s": plain_s,
              "rollout_frames_per_s": n_frames / plain_s,
              "stages_s": {"windows": win_s, "tokens": tok_s,
                           "chunk_decode": chunk_s, "dae_decode": dae_s},
              "device_busy": device_busy(lambda: gen.generate(w, d),
                                         fused_s),
              "card": smi})

    k = kernel_rows[KERNEL_BATCHES[-1]]
    emit({"kernels": [{
        "name": "chunk_decoder", "route": "cuda",
        "source": "gesture2vec_tpu_torch/csrc/chunk_decoder.cu",
        "replaces": "gesture2vec_tpu/ops/decoder_pallas.py:144",
        "launches": launches, "max_abs_err": max(
            r["max_abs_err"] for r in kernel_rows.values()),
        "ms": k["ms"], "plain_ms": k["plain_ms"],
        "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
        "library_ms": None, "B": k["B"]}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception:  # any failed phase: report and exit non-zero
        traceback.print_exc()
        code = 1
    sys.exit(code)
