"""Small export utilities.

  unityfy           <- scripts/utils/Unityfier.py: transcripts -> Unity-
                       readable "start,end,word" text files.
  human-study       <- scripts/creat_human-study.py: cut word-aligned
                       clip windows out of generated/ground-truth motion
                       for side-by-side human evaluation.
  c2g-samples       <- scripts/inference_cluster2gesture.py: motion per
                       cluster id through the c2g decoder.
  import-checkpoint    a reference PyTorch checkpoint -> a checkpoint file
                       of the JAX package's format (compat/torch_import).
  baseline-infer    <- scripts/inference.py: the continuous text->pose
                       baseline with seed-pose carry + overlap blending.

The port's copy of the JAX package's `cli/tools.py`, with the same
subcommands, arguments and defaults; `--device` (default cuda) takes the
place of `--platform` on the two that run a model, and JAX's
`--jax-cache` has no counterpart:

    python -m gesture2vec_tpu_torch.cli.tools import-checkpoint ref.pt \\
        out.bin --kind DAE|autoencoder|autoencoder_vq|text2embedding
    python -m gesture2vec_tpu_torch.cli.tools c2g-samples c2g.bin dae.bin \\
        --store STORE --pipeline data_pipe.json --clusters N [--device cpu]
    python -m gesture2vec_tpu_torch.cli.tools baseline-infer base.bin \\
        transcript.json --store STORE --pipeline data_pipe.json [--device cpu]

It reads and writes the files either package reads and writes.
"""
from __future__ import annotations

import argparse
import glob
import logging
import os
from typing import Optional, Sequence, Union

import numpy as np
import torch


def unityfy(jsons_path: str, out_dir: Optional[str] = None) -> list:
    from gesture2vec_tpu_torch.io.subtitles import read_subtitles

    out_dir = out_dir or os.path.join(jsons_path, "Unity")
    os.makedirs(out_dir, exist_ok=True)
    written = []
    for jfile in sorted(glob.glob(os.path.join(jsons_path, "*.json")) +
                        glob.glob(os.path.join(jsons_path, "*.tsv"))):
        name = os.path.splitext(os.path.basename(jfile))[0]
        words = read_subtitles(jfile)
        lines = [f"{s},{e},{w}" for w, s, e in words]
        out = os.path.join(out_dir, name + ".txt")
        with open(out, "w") as f:
            f.write("\n".join(lines))
        written.append(out)
    return written


def human_study_clips(bvh_path: str, transcript_path: str, out_dir: str,
                      clip_seconds: float = 6.0) -> list:
    """Cut a BVH file into word-aligned windows for human study
    (ref: scripts/creat_human-study.py)."""
    from gesture2vec_tpu_torch.io.bvh import parse_bvh, write_bvh
    from gesture2vec_tpu_torch.io.subtitles import read_subtitles

    os.makedirs(out_dir, exist_ok=True)
    data = parse_bvh(bvh_path)
    words = read_subtitles(transcript_path)
    fps = data.framerate
    clip_frames = int(round(clip_seconds * fps))
    written = []
    k = 0
    t = 0.0
    duration = data.n_frames / fps
    while t + clip_seconds <= duration:
        f0 = int(t * fps)
        piece = data.clone()
        piece.values = data.values[f0:f0 + clip_frames]
        name = f"clip_{k:03d}"
        out = os.path.join(out_dir, name + ".bvh")
        write_bvh(piece, out)
        inside = [w for w in words if t <= (w[1] + w[2]) / 2 < t +
                  clip_seconds]
        with open(os.path.join(out_dir, name + ".txt"), "w") as f:
            f.write(" ".join(w[0] for w in inside))
        written.append(out)
        k += 1
        t += clip_seconds
    return written


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    sub = parser.add_subparsers(dest="cmd", required=True)
    u = sub.add_parser("unityfy")
    u.add_argument("jsons_path")
    u.add_argument("--out", default=None)
    h = sub.add_parser("human-study")
    h.add_argument("bvh")
    h.add_argument("transcript")
    h.add_argument("--out", default="human_study")
    h.add_argument("--seconds", type=float, default=6.0)
    device_help = ("torch device (cuda raises without a card; cpu runs "
                   "the plain PyTorch path)")
    c = sub.add_parser("c2g-samples")
    c.add_argument("c2g_checkpoint")
    c.add_argument("rep_checkpoint")
    c.add_argument("--store", required=True)
    c.add_argument("--pipeline", required=True)
    c.add_argument("--out", default="c2g_samples")
    c.add_argument("--clusters", type=int, required=True)
    c.add_argument("--per-cluster", type=int, default=3)
    c.add_argument("--device", default="cuda", help=device_help)
    i = sub.add_parser("import-checkpoint")
    i.add_argument("torch_path")
    i.add_argument("out_path")
    i.add_argument("--kind", required=True,
                   choices=["DAE", "autoencoder", "autoencoder_vq",
                            "text2embedding"])
    b = sub.add_parser("baseline-infer")
    b.add_argument("baseline_checkpoint")
    b.add_argument("transcript")
    b.add_argument("--store", required=True)
    b.add_argument("--pipeline", required=True)
    b.add_argument("--out", default="baseline.bvh")
    b.add_argument("--duration", type=float, default=None)
    b.add_argument("--device", default="cuda", help=device_help)
    return parser


def main(argv: Optional[Sequence[str]] = None):
    """Runs one subcommand; returns the written paths (unityfy,
    human-study), the sample count (c2g-samples), the motion
    (baseline-infer) or None (import-checkpoint)."""
    logging.basicConfig(level=logging.INFO)
    args = build_parser().parse_args(argv)
    if args.cmd == "baseline-infer":
        return baseline_infer(args.baseline_checkpoint, args.transcript,
                              args.store, args.pipeline, args.out,
                              args.duration, device=args.device)
    if args.cmd == "unityfy":
        written = unityfy(args.jsons_path, args.out)
    elif args.cmd == "human-study":
        written = human_study_clips(args.bvh, args.transcript, args.out,
                                    args.seconds)
    elif args.cmd == "c2g-samples":
        n = c2g_samples(args.c2g_checkpoint, args.rep_checkpoint,
                        args.store, args.pipeline, args.out,
                        args.clusters, args.per_cluster, device=args.device)
        print(f"wrote {n} samples")
        return n
    else:
        return import_reference_checkpoint(args.torch_path, args.out_path,
                                           args.kind)
    for p in written:
        print(p)
    return written


@torch.inference_mode()
def c2g_samples(c2g_checkpoint: str, rep_checkpoint: str, store_dir: str,
                pipeline_path: str, out_dir: str, n_clusters: int,
                samples_per_cluster: int = 3,
                device: Optional[Union[str, torch.device]] = None) -> int:
    """Synthesize motion per cluster id through the c2g decoder
    (ref: scripts/inference_cluster2gesture.py:61-96): one c2g rollout
    over every (cluster, sample) id (on the card one chunk-decoder
    launch), one batched DAE decode, then a BVH file per sample. Runs on
    CUDA unless device says otherwise."""
    from gesture2vec_tpu_torch.compat.checkpoint import \
        load_checkpoint_and_model
    from gesture2vec_tpu_torch.data.datasets import unnormalize
    from gesture2vec_tpu_torch.data.store import ClipStore
    from gesture2vec_tpu_torch.device import resolve_device
    from gesture2vec_tpu_torch.infer.exporter import frames_to_bvh
    from gesture2vec_tpu_torch.mocap.features import FeatureExtractor

    dev = resolve_device(device)
    c2g_model, _ = load_checkpoint_and_model(c2g_checkpoint, "c2g", dev)
    dae_model, _ = load_checkpoint_and_model(rep_checkpoint, "DAE", dev)
    store = ClipStore(store_dir)
    fe = FeatureExtractor.load(pipeline_path)
    os.makedirs(out_dir, exist_ok=True)

    all_ids = torch.as_tensor(np.repeat(np.arange(n_clusters),
                                        samples_per_cluster), device=dev)
    latents = c2g_model(all_ids)
    decoded = dae_model.decode(latents.reshape(-1, latents.shape[-1]))
    decoded = decoded.reshape(latents.shape[0], latents.shape[1],
                              -1).cpu().numpy()

    count = 0
    for idx in range(decoded.shape[0]):
        cid, k = divmod(idx, samples_per_cluster)
        frames = unnormalize(decoded[idx], store.pose_mean,
                             store.pose_std)
        d = os.path.join(out_dir, str(cid))
        os.makedirs(d, exist_ok=True)
        frames_to_bvh(frames, fe, path=os.path.join(d, f"sample_{k}.bvh"))
        count += 1
    return count


def baseline_infer(ckpt: str, transcript: str, store_dir: str,
                   pipeline_path: str, out: str,
                   duration: Optional[float] = None,
                   device: Optional[Union[str, torch.device]] = None
                   ) -> np.ndarray:
    """Baseline Seq2SeqNet text->pose inference to BVH
    (ref: scripts/inference.py:53-96); returns the motion. Runs on CUDA
    unless device says otherwise."""
    from gesture2vec_tpu_torch.compat.checkpoint import \
        load_checkpoint_and_model
    from gesture2vec_tpu_torch.data.store import ClipStore
    from gesture2vec_tpu_torch.infer.baseline_infer import generate_baseline
    from gesture2vec_tpu_torch.infer.exporter import frames_to_bvh
    from gesture2vec_tpu_torch.io.subtitles import read_subtitles
    from gesture2vec_tpu_torch.mocap.features import FeatureExtractor
    from gesture2vec_tpu_torch.text.vocab import build_vocab
    from gesture2vec_tpu_torch.train.config import load_config

    model, payload = load_checkpoint_and_model(ckpt, "baseline", device)
    cfg = load_config(payload["config"])
    store = ClipStore(store_dir)
    # the baseline trainer builds its vocab from the train store; the
    # same deterministic build reproduces the training-time word ids
    vocab = build_vocab("corpus", [[w[0] for w in c["words"]]
                                   for c in store.clips])
    words = read_subtitles(transcript)
    dur = duration or (words[-1][2] if words else 6.0)
    frames = generate_baseline(model, vocab, words, dur,
                               pose_mean=store.pose_mean,
                               pose_std=store.pose_std,
                               fps=cfg.motion_resampling_framerate,
                               device=device)
    fe = FeatureExtractor.load(pipeline_path)
    frames_to_bvh(frames, fe, path=out)
    print(f"wrote {out}")
    return frames


def import_reference_checkpoint(torch_path: str, out_path: str,
                                kind: str) -> None:
    """Convert a reference PyTorch checkpoint into a checkpoint file of
    the JAX package's format (compat/torch_import + train/checkpoints),
    which both packages load."""
    from gesture2vec_tpu_torch.compat.torch_import import (
        convert_dae_state, convert_seq_ae_state, convert_text2token_state,
        load_reference_checkpoint)
    from gesture2vec_tpu_torch.train import checkpoints
    from gesture2vec_tpu_torch.train.config import load_config

    payload = load_reference_checkpoint(torch_path)
    args = payload.get("args")
    cfg = load_config(vars(args) if args is not None and
                      not isinstance(args, dict) else (args or {}))
    sd = payload["state_dict"]
    extra = {}
    if kind == "DAE":
        params = convert_dae_state(sd)
    elif kind in ("autoencoder", "autoencoder_vq"):
        params, batch_stats = convert_seq_ae_state(sd, cfg.n_layers)
        extra["batch_stats"] = batch_stats
    elif kind == "text2embedding":
        params, batch_stats = convert_text2token_state(sd, cfg.n_layers)
        extra["batch_stats"] = batch_stats
        extra["n_words"] = sd["encoder.embedding.weight"].shape[0]
    else:
        raise ValueError(f"unsupported kind {kind!r}")
    checkpoints.save_checkpoint(out_path, config=cfg,
                                epoch=int(payload["epoch"]),
                                params=params,
                                pose_dim=int(payload["pose_dim"]),
                                extra=extra, kind=kind)
    print(f"converted {torch_path} ({kind}) -> {out_path}")


if __name__ == "__main__":
    main()
