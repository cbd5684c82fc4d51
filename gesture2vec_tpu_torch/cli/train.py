"""g2v-train for the port: train Part a, b, d or audio from a YAML config.

    python -m gesture2vec_tpu_torch.cli.train -c configs/DAE.yml --part a
    python -m gesture2vec_tpu_torch.cli.train -c configs/VQ-VAE.yml \\
        --part b --rep-checkpoint out/dae/Frame_Level_H40_checkpoint_020.bin
    python -m gesture2vec_tpu_torch.cli.train -c configs/seq2seqtxt.yml \\
        --part d --rep-checkpoint ... --autoencoder-checkpoint ...
    python -m gesture2vec_tpu_torch.cli.train -c configs/audio.yml \\
        --part audio --rep-checkpoint ... --autoencoder-checkpoint ...

The recommended recipe is `configs/VQ-VAE_rvq.yml` for part b (the
4-stage residual VQ), then `configs/seq2seqtxt_recommended.yml` for part
d (the transformer, 4 chained stages) over that tokenizer.

The port of the JAX package's `cli/train.py` for parts a, b, d and audio,
with every model their configs select (Part a's DAE, VQ and VAE frame
models;
Part b's GS-Soft, residual-VQ, VAE, plain and similarity-supervised
tokenizers; `vq_tricks` only through `train/dae_trainer.train_dae`, as
in JAX, whose command has no such flag): Part b trains on the frozen
Part-a model's latents of the pose windows, Part d
on the sentence windows tokenized by the frozen Part-a and Part-b
models, and the audio Part d on the same windows' audio (one-second mel
chunks, or with `audio_fusion: both` the word ids and one-second raw
chunks); the checkpoints are the JAX package's files, which either
package loads. `--device` (default cuda; cpu on a machine without a
card) takes the place of `--platform`. The loss history goes to
`loss_history.json` in the save dir, and, where matplotlib imports, the
JAX package's `loss_curves.png` beside it (`mocap/viz.plot_loss_curves`;
one logged line says when it is left out). `--plot-every N` (part b,
needs matplotlib and scikit-learn) writes the codebook's t-SNE every N
epochs, as JAX does. Refused, each naming the queue item that ports it:
the parts baseline, c2g and gan (6) and `--mesh` (5).
"""
from __future__ import annotations

import argparse
import json
import logging
import os
from typing import Any, List, Optional, Tuple

_PARTS = ("a", "b", "d", "audio", "baseline", "c2g", "gan")
_LATER = "{} is not ported yet (ROADMAP.md queue A item {})"


def _history(history: dict, save_dir: str, title: str) -> None:
    """loss_history.json, and loss_curves.png where matplotlib imports."""
    from gesture2vec_tpu_torch.cluster.plots import have_matplotlib

    os.makedirs(save_dir, exist_ok=True)
    path = os.path.join(save_dir, "loss_history.json")
    with open(path, "w") as f:
        json.dump(history, f, indent=1)
    logging.info("loss history -> %s", path)
    if not have_matplotlib():
        logging.info("loss_curves.png left out: matplotlib is not "
                     "installed")
        return
    from gesture2vec_tpu_torch.mocap.viz import plot_loss_curves
    path = os.path.join(save_dir, "loss_curves.png")
    plot_loss_curves(history, path, title=title)
    logging.info("loss curves -> %s", path)


def main(argv: Optional[List[str]] = None) -> Tuple[Any, dict]:
    """Train one part; returns (the trained model, its history)."""
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--config", "-c", required=True)
    parser.add_argument("--part", choices=_PARTS, required=True)
    parser.add_argument("--rep-checkpoint", default=None,
                        help="frozen Part-a checkpoint (parts b, d)")
    parser.add_argument("--autoencoder-checkpoint", default=None,
                        help="frozen Part-b checkpoint (part d)")
    parser.add_argument("--save-dir", default=None)
    parser.add_argument("--resume", default=None, metavar="CKPT",
                        help="checkpoint to resume from (the port's or the "
                             "JAX package's)")
    parser.add_argument("--mesh", default=None)
    parser.add_argument("--plot-every", type=int, default=0,
                        help="part b: write a codebook t-SNE every N "
                             "epochs (needs matplotlib)")
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    later = {"baseline": "6", "c2g": "6", "gan": "6"}
    if args.part in later:
        raise NotImplementedError(_LATER.format(f"--part {args.part}",
                                                later[args.part]))
    if args.mesh:
        raise NotImplementedError(_LATER.format("--mesh", "5, scale-out"))
    from gesture2vec_tpu_torch.cluster.plots import have_matplotlib
    if args.plot_every and not have_matplotlib():
        parser.error("--plot-every needs matplotlib")

    from gesture2vec_tpu_torch.device import resolve_device
    from gesture2vec_tpu_torch.train.config import load_config
    from gesture2vec_tpu_torch.utils.meters import set_logger

    dev = resolve_device(args.device)
    cfg = load_config(args.config)
    if args.rep_checkpoint:
        cfg = cfg.replace(rep_learning_checkpoint=args.rep_checkpoint)
    if args.autoencoder_checkpoint:
        cfg = cfg.replace(autoencoder_checkpoint=args.autoencoder_checkpoint)
    save_dir = args.save_dir or cfg.model_save_path
    set_logger(save_dir)
    logging.info("part %s, config %s -> %s on %s", args.part, args.config,
                 save_dir, dev)
    cfg, (train, val), kw = build_arrays(cfg, args.part, dev)
    if args.part == "b":
        kw["plot_every"] = args.plot_every
    if args.part == "a":
        from gesture2vec_tpu_torch.train.dae_trainer import train_dae as fit
    elif args.part == "b":
        from gesture2vec_tpu_torch.train.seq_ae_trainer import \
            train_seq_ae as fit
    elif args.part == "audio":
        from gesture2vec_tpu_torch.train.audio2token_trainer import \
            train_audio2token as fit
    else:
        from gesture2vec_tpu_torch.train.text2token_trainer import \
            train_text2token as fit
    model, hist = fit(cfg, train, val, save_dir=save_dir,
                      resume_from=args.resume, device=dev, **kw)
    _history(hist, save_dir, cfg.name)
    return model, hist


def build_arrays(cfg, part: str, dev) -> Tuple[Any, tuple, dict]:
    """A part's data from the config's stores, as its trainer takes it:
    (the config, for parts b and d with rep_learning_dim read from the
    Part-a checkpoint where it is unset, (train, val), the trainer's
    other keyword arguments). Part a: every pose frame; Part b: the
    frozen DAE's latents of the pose windows; Part d: the sentence
    windows with the frozen Part-a and Part-b models' tokens; audio: the
    same with each window's mel chunks, or with audio_fusion "both" its
    raw chunks (and the vocabulary's size and state)."""
    from gesture2vec_tpu_torch.compat.checkpoint import \
        load_checkpoint_and_model
    from gesture2vec_tpu_torch.data.datasets import (all_frames,
                                                     pose_windows)
    from gesture2vec_tpu_torch.data.store import ClipStore
    from gesture2vec_tpu_torch.data.teacher import encode_windows_with_dae

    train_store = ClipStore(cfg.train_data_path)
    val_store = ClipStore(cfg.val_data_path)
    mean, std = train_store.pose_mean, train_store.pose_std
    if part == "a":
        return cfg, (all_frames(train_store),
                     all_frames(val_store, mean, std)), {}

    if not cfg.rep_learning_checkpoint:
        raise ValueError("--rep-checkpoint required (parts b, d, audio)")
    dae, dae_payload = load_checkpoint_and_model(
        cfg.rep_learning_checkpoint, "DAE", dev)
    if cfg.rep_learning_dim <= 0:
        cfg = cfg.replace(
            rep_learning_dim=int(dae_payload["config"]["hidden_size"]))
    if part == "b":
        def latents(store):
            return encode_windows_with_dae(dae, pose_windows(
                store, cfg.n_poses, cfg.subdivision_stride, mean, std))
        return cfg, (latents(train_store), latents(val_store)), {}

    from gesture2vec_tpu_torch.data.sentence import build_sentence_dataset
    from gesture2vec_tpu_torch.text.vocab import build_vocab

    if not cfg.autoencoder_checkpoint:
        raise ValueError("--autoencoder-checkpoint required (parts d, "
                         "audio)")
    vocab = build_vocab("corpus", [[w[0] for w in c["words"]]
                                   for c in train_store.clips])
    vocab.load_word_vectors(cfg.wordembed_path, cfg.wordembed_dim)
    seq, _ = load_checkpoint_and_model(cfg.autoencoder_checkpoint,
                                       "autoencoder_vq", dev)
    kw = dict(dae_model=dae, seq_model=seq,
              sentence_frame_length=cfg.sentence_frame_length,
              stride=cfg.subdivision_stride_sentence, n_frames=cfg.n_poses,
              fps=cfg.motion_resampling_framerate, mean=mean, std=std,
              emit_stage_tokens=cfg.token_stages > 1,
              text_context_s=cfg.text_context_s)
    both = part == "audio" and cfg.audio_fusion == "both"
    if part == "audio":
        kw.update(include_audio=not both, include_raw_audio=both)
    arrays = (build_sentence_dataset(train_store, vocab, **kw),
              build_sentence_dataset(val_store, vocab, **kw))
    if part == "audio":
        return cfg, arrays, dict(
            n_words=vocab.n_words if both else 0,
            lang_model_state=vocab.state_dict() if both else None)
    return cfg, arrays, dict(
        n_words=vocab.n_words,
        embedding_weights=vocab.word_embedding_weights,
        lang_model_state=vocab.state_dict())


if __name__ == "__main__":
    main()
