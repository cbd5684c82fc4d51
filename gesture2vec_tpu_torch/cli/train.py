"""g2v-train for the port: train Part a, b, d or audio, the baseline,
c2g or the GAN from a YAML config.

    python -m gesture2vec_tpu_torch.cli.train -c configs/DAE.yml --part a
    python -m gesture2vec_tpu_torch.cli.train -c configs/VQ-VAE.yml \\
        --part b --rep-checkpoint out/dae/Frame_Level_H40_checkpoint_020.bin
    python -m gesture2vec_tpu_torch.cli.train -c configs/seq2seqtxt.yml \\
        --part d --rep-checkpoint ... --autoencoder-checkpoint ...
    python -m gesture2vec_tpu_torch.cli.train -c configs/audio.yml \\
        --part audio --rep-checkpoint ... --autoencoder-checkpoint ...
    python -m gesture2vec_tpu_torch.cli.train -c configs/seq2seq.yml \
        --part baseline
    python -m gesture2vec_tpu_torch.cli.train -c configs/gan.yml --part gan
    python -m gesture2vec_tpu_torch.cli.train -c configs/c2g.yml \
        --part c2g --rep-checkpoint ... --autoencoder-checkpoint ...

The recommended recipe is `configs/VQ-VAE_rvq.yml` for part b (the
4-stage residual VQ), then `configs/seq2seqtxt_recommended.yml` for part
d (the transformer, 4 chained stages) over that tokenizer.

The port of the JAX package's `cli/train.py`, every part, with every
model their configs select (Part a's DAE, VQ and VAE frame
models;
Part b's GS-Soft, residual-VQ, VAE, plain and similarity-supervised
tokenizers; `vq_tricks` only through `train/dae_trainer.train_dae`, as
in JAX, whose command has no such flag): Part b trains on the frozen
Part-a model's latents of the pose windows, Part d
on the sentence windows tokenized by the frozen Part-a and Part-b
models, and the audio Part d on the same windows' audio (one-second mel
chunks, or with `audio_fusion: both` the word ids and one-second raw
chunks); the baseline and the GAN on the sentence windows (one
stride-long window each, at least one word, 32 word slots) with their
normalised poses, c2g on the frozen Part-a model's latents of the pose
windows with the frozen Part-b model's tokens as cluster ids (both
checkpoints required); the checkpoints are the JAX package's files,
which either package loads. As in JAX, `--resume` is honored for parts
a, b, d and audio only (a line says it is ignored for the others).
`--device` (default cuda; cpu on a machine without a card) takes the
place of `--platform`. The loss history goes to
`loss_history.json` in the save dir, and, where matplotlib imports, the
JAX package's `loss_curves.png` beside it (`mocap/viz.plot_loss_curves`;
one logged line says when it is left out). `--plot-every N` (part b,
needs matplotlib and scikit-learn) writes the codebook's t-SNE every N
epochs, as JAX does. `--mesh dp=2` (or a config's `mesh_shape: {dp:
2}`) shards the teacher sweeps' rows over the mesh and trains over it
(`parallel/mesh`): in a plain process the trainer starts the mesh's
ranks itself (gloo on the CPU, NCCL one card a rank), under `torchrun
--nproc-per-node N -m gesture2vec_tpu_torch.cli.train --mesh dp=N` every
rank joins the process group torchrun describes (`parallel/launch.
torchrun_group`), runs the command in place and rank 0 writes the files.
"""
from __future__ import annotations

import argparse
import json
import logging
import os
from typing import Any, List, Optional, Tuple

import numpy as np

_PARTS = ("a", "b", "d", "audio", "baseline", "c2g", "gan")
_MISC_PARTS = ("baseline", "c2g", "gan")


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
                        help="frozen Part-a checkpoint (parts b, c2g, d, "
                             "audio)")
    parser.add_argument("--autoencoder-checkpoint", default=None,
                        help="frozen Part-b checkpoint (parts c2g, d, "
                             "audio)")
    parser.add_argument("--save-dir", default=None)
    parser.add_argument("--resume", default=None, metavar="CKPT",
                        help="checkpoint to resume from (the port's or the "
                             "JAX package's)")
    parser.add_argument("--mesh", default=None,
                        help="device mesh, e.g. 'dp=4,tp=2' (overrides "
                             "the config's mesh_shape)")
    parser.add_argument("--plot-every", type=int, default=0,
                        help="part b: write a codebook t-SNE every N "
                             "epochs (needs matplotlib)")
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    from gesture2vec_tpu_torch.cluster.plots import have_matplotlib
    if args.plot_every and not have_matplotlib():
        parser.error("--plot-every needs matplotlib")

    from gesture2vec_tpu_torch.device import resolve_device
    from gesture2vec_tpu_torch.parallel.launch import torchrun_group

    dev = resolve_device(args.device)
    with torchrun_group(dev):
        return _train(args, dev)


def _train(args, dev) -> Tuple[Any, dict]:
    """main's command once the process has its device (and, under
    torchrun, its process group)."""
    from gesture2vec_tpu_torch.cli._common import parse_mesh_shape
    from gesture2vec_tpu_torch.parallel.mesh import is_main, make_mesh
    from gesture2vec_tpu_torch.train.config import load_config
    from gesture2vec_tpu_torch.utils.meters import set_logger

    cfg = load_config(args.config)
    if args.mesh:
        cfg = cfg.replace(mesh_shape=parse_mesh_shape(args.mesh))
    # the teacher sweeps shard their rows over the trainer's mesh; too
    # few cards raise here, before any data is read
    mesh = make_mesh(cfg.mesh_shape, dev)
    if mesh is not None and mesh.distributed:
        dev = mesh.device
    if args.rep_checkpoint:
        cfg = cfg.replace(rep_learning_checkpoint=args.rep_checkpoint)
    if args.autoencoder_checkpoint:
        cfg = cfg.replace(autoencoder_checkpoint=args.autoencoder_checkpoint)
    save_dir = args.save_dir or cfg.model_save_path
    if is_main(mesh):
        set_logger(save_dir)
    logging.info("part %s, config %s -> %s on %s%s", args.part, args.config,
                 save_dir, dev, f" over mesh {cfg.mesh_shape}" if mesh
                 else "")
    cfg, (train, val), kw = build_arrays(cfg, args.part, dev, mesh)
    if args.part in _MISC_PARTS:
        if args.resume:
            logging.info("--resume is ignored for part %s (as in the JAX "
                         "package: parts a, b, d and audio only)",
                         args.part)
        model, hist = _fit_misc(cfg, args.part, train, val, save_dir, dev,
                                kw)
        if is_main(mesh):
            _history(hist, save_dir, cfg.name)
        return model, hist
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
    if is_main(mesh):
        _history(hist, save_dir, cfg.name)
    return model, hist


def _fit_misc(cfg, part: str, train, val, save_dir: str, dev,
              kw: dict) -> Tuple[Any, dict]:
    """The baseline's, c2g's or the GAN's trainer over build_arrays'
    data. Their models train in fp32 whatever compute_dtype says, as the
    JAX trainers build them."""
    if cfg.compute_dtype != "float32":
        logging.info("compute_dtype %s is ignored for part %s: it trains "
                     "in float32, as in the JAX package", cfg.compute_dtype,
                     part)
    if part == "baseline":
        from gesture2vec_tpu_torch.train.misc_trainers import train_baseline
        return train_baseline(cfg, train, val, save_dir=save_dir,
                              device=dev, **kw)
    if part == "gan":
        from gesture2vec_tpu_torch.train.gan_trainer import train_gan
        return train_gan(cfg, train, save_dir=save_dir, device=dev, **kw)
    from gesture2vec_tpu_torch.train.misc_trainers import train_c2g
    return train_c2g(cfg, *train, *val, save_dir=save_dir, device=dev)


def text_pose_windows(cfg, store, vocab, mean, std) -> dict:
    """The baseline's and the GAN's data (the JAX command's): one
    n_poses window every subdivision_stride frames with at least one
    word, its word ids (with SOS / EOS, at most 32; length at least 1)
    and its poses normalised by mean / std: {word_ids (N, 32), lengths
    (N,), poses (N, n_poses, D)}."""
    from gesture2vec_tpu_torch.data.datasets import (normalize,
                                                     sentence_windows)

    wins = sentence_windows(store, cfg.n_poses, cfg.subdivision_stride,
                            cfg.motion_resampling_framerate, min_words=1)
    clips = {i: store[i] for i in sorted({w["clip"] for w in wins})}
    poses = np.stack([normalize(clips[w["clip"]]["poses"][
        w["frame0"]:w["frame0"] + cfg.n_poses], mean, std)
        for w in wins]).astype(np.float32)
    word_ids = np.zeros((len(wins), 32), np.int32)
    lengths = np.zeros((len(wins),), np.int32)
    for i, w in enumerate(wins):
        ids = vocab.words_to_ids([t[0] for t in w["words"]])[:32]
        word_ids[i, :len(ids)] = ids
        lengths[i] = max(len(ids), 1)
    return {"word_ids": word_ids, "lengths": lengths, "poses": poses}


def build_arrays(cfg, part: str, dev, mesh=None
                 ) -> Tuple[Any, tuple, dict]:
    """A part's data from the config's stores, as its trainer takes it:
    (the config, for parts b and d with rep_learning_dim read from the
    Part-a checkpoint where it is unset, (train, val), the trainer's
    other keyword arguments). Part a: every pose frame; Part b: the
    frozen DAE's latents of the pose windows; Part d: the sentence
    windows with the frozen Part-a and Part-b models' tokens; audio: the
    same with each window's mel chunks, or with audio_fusion "both" its
    raw chunks (and the vocabulary's size and state); baseline and gan:
    `text_pose_windows` (and the vocabulary's size and vectors); c2g:
    ((train tokens, train latents), (val tokens, val latents)), the
    frozen Part-b model's tokens of the frozen DAE's latent windows. The
    teacher sweeps shard their rows over mesh where one is given."""
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
    if part in ("baseline", "gan"):
        from gesture2vec_tpu_torch.text.vocab import build_vocab

        vocab = build_vocab("corpus", [[w[0] for w in c["words"]]
                                       for c in train_store.clips])
        vocab.load_word_vectors(cfg.wordembed_path, cfg.wordembed_dim)
        data = [text_pose_windows(cfg, s, vocab, mean, std)
                for s in (train_store, val_store)]
        return cfg, (data[0], data[1] if part == "baseline" else None), dict(
            n_words=vocab.n_words,
            embedding_weights=vocab.word_embedding_weights)

    if not cfg.rep_learning_checkpoint:
        raise ValueError("--rep-checkpoint required (parts b, c2g, d, "
                         "audio)")
    dae, dae_payload = load_checkpoint_and_model(
        cfg.rep_learning_checkpoint, "DAE", dev)
    if cfg.rep_learning_dim <= 0:
        cfg = cfg.replace(
            rep_learning_dim=int(dae_payload["config"]["hidden_size"]))
    def latents(store):
        return encode_windows_with_dae(dae, pose_windows(
            store, cfg.n_poses, cfg.subdivision_stride, mean, std),
            mesh=mesh)

    if part == "b":
        return cfg, (latents(train_store), latents(val_store)), {}
    if not cfg.autoencoder_checkpoint:
        raise ValueError("--autoencoder-checkpoint required (parts c2g, d, "
                         "audio)")
    seq, _ = load_checkpoint_and_model(cfg.autoencoder_checkpoint,
                                       "autoencoder_vq", dev)
    if part == "c2g":
        from gesture2vec_tpu_torch.data.teacher import tokenize_windows

        arrays = []
        for store in (train_store, val_store):
            lat = latents(store)
            arrays.append((tokenize_windows(seq, lat, mesh=mesh)[0], lat))
        return cfg, tuple(arrays), {}

    from gesture2vec_tpu_torch.data.sentence import build_sentence_dataset
    from gesture2vec_tpu_torch.text.vocab import build_vocab

    vocab = build_vocab("corpus", [[w[0] for w in c["words"]]
                                   for c in train_store.clips])
    vocab.load_word_vectors(cfg.wordembed_path, cfg.wordembed_dim)
    kw = dict(dae_model=dae, seq_model=seq,
              sentence_frame_length=cfg.sentence_frame_length,
              stride=cfg.subdivision_stride_sentence, n_frames=cfg.n_poses,
              fps=cfg.motion_resampling_framerate, mean=mean, std=std,
              emit_stage_tokens=cfg.token_stages > 1,
              text_context_s=cfg.text_context_s, mesh=mesh)
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
