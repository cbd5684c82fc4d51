"""Corpus ingest: BVH + transcripts + audio -> train/val ClipStores.

The port's copy of the JAX package's `data/ingest.py`, writing the
port's `ClipStoreWriter` (stores that either package reads).

Rebuild of the reference's LMDB dataset builders
(ref: scripts/trinity_data_to_lmdb.py:61-153,
scripts/twh_dataset_to_lmdb.py:151-279). Same split rule for Trinity
(first file -> validation, ref: trinity_data_to_lmdb.py:101-104), same
fp16 pose storage, same corpus mean/std computation: over the
f16-quantized, non-mirrored tracks (ref :118,138-150).
"""
from __future__ import annotations

import glob
import logging
import os
from typing import Optional, Tuple

import numpy as np

from gesture2vec_tpu_torch.data.store import ClipStoreWriter
from gesture2vec_tpu_torch.io.audio import load_wav
from gesture2vec_tpu_torch.io.bvh import parse_bvh
from gesture2vec_tpu_torch.io.subtitles import read_subtitles
from gesture2vec_tpu_torch.mocap.features import (FeatureExtractor,
                                                  TWHFeatureExtractor)


def ingest_trinity(base_path: str, out_path: Optional[str] = None,
                   tgt_fps: int = 20,
                   with_audio: bool = True) -> Tuple[str, str]:
    """Build <out>/train and <out>/val ClipStores from a Trinity-layout
    directory (Motion/*.bvh, Transcripts/*.json, Audio/*.wav).

    Returns (train_store_path, val_store_path). The fitted motion
    pipeline is saved next to the stores as data_pipe.json (replacing
    ../resource/data_pipe.sav, ref: trinity_data_to_lmdb.py:47).
    """
    out_path = out_path or os.path.join(base_path, "store")
    train_dir = os.path.join(out_path, "train")
    val_dir = os.path.join(out_path, "val")
    writers = [ClipStoreWriter(train_dir), ClipStoreWriter(val_dir)]

    bvh_files = sorted(glob.glob(os.path.join(base_path, "Motion",
                                              "*.bvh")))
    if not bvh_files:
        raise FileNotFoundError(f"no BVH files under {base_path}/Motion")

    from gesture2vec_tpu_torch.mocap.features import trinity_pipeline
    fe = FeatureExtractor(trinity_pipeline(tgt_fps=tgt_fps))
    all_poses = []
    for v_i, bvh_file in enumerate(bvh_files):
        name = os.path.splitext(os.path.basename(bvh_file))[0]
        logging.info("ingesting %s", name)
        poses, poses_mirror = fe.process(parse_bvh(bvh_file))

        words = []
        tpath = os.path.join(base_path, "Transcripts", name + ".json")
        if not os.path.exists(tpath):
            tpath = os.path.join(base_path, "Transcripts", name + ".tsv")
        if os.path.exists(tpath):
            words = read_subtitles(tpath)

        audio = None
        apath = os.path.join(base_path, "Audio", name + ".wav")
        if with_audio and os.path.exists(apath):
            audio = load_wav(apath)

        # first video is validation (ref: trinity_data_to_lmdb.py:101-104)
        w = writers[1] if v_i == 0 else writers[0]
        kw = {} if audio is None else {"audio": audio}
        w.add_clip(name, poses, words=words, **kw)
        w.add_clip(name + "_mirror", poses_mirror, words=words, **kw)
        # stats over the f16-quantized values, like the reference
        # (trinity_data_to_lmdb.py:118,138: all_poses holds the cast
        # array the store persists)
        all_poses.append(np.asarray(poses, np.float16)
                         .astype(np.float32))

    stacked = np.vstack(all_poses)
    mean, std = stacked.mean(axis=0), stacked.std(axis=0)
    for w in writers:
        w.set_stats(mean, std)
        w.set_meta(fps=tgt_fps, feature_dim=int(stacked.shape[1]))
        w.finish()
    fe.save(os.path.join(out_path, "data_pipe.json"))
    logging.info("data mean/std computed over %d frames", stacked.shape[0])
    return train_dir, val_dir


def ingest_twh(base_path: str, out_path: Optional[str] = None,
               variant: str = "test1", max_files: int = 50,
               with_audio: bool = True) -> Tuple[str, str]:
    """TWH/GENEA-layout ingest (ref: scripts/twh_dataset_to_lmdb.py:151-279).

    Layout: <base>/bvh/*.bvh, <base>/tsv/*.tsv, <base>/wav/*.wav.
    Reference split rules kept: every 100th file -> validation
    (ref :209), file count capped (ref :176 caps at 50).
    """
    out_path = out_path or os.path.join(base_path, "store")
    train_dir = os.path.join(out_path, "train")
    val_dir = os.path.join(out_path, "val")
    writers = [ClipStoreWriter(train_dir), ClipStoreWriter(val_dir)]

    bvh_files = sorted(glob.glob(os.path.join(base_path, "bvh", "*.bvh")))
    if not bvh_files:
        raise FileNotFoundError(f"no BVH files under {base_path}/bvh")
    bvh_files = bvh_files[:max_files]

    fe = TWHFeatureExtractor(variant)
    all_poses = []
    for v_i, bvh_file in enumerate(bvh_files):
        name = os.path.splitext(os.path.basename(bvh_file))[0]
        logging.info("ingesting %s", name)
        poses = fe.process(parse_bvh(bvh_file))

        words = []
        tpath = os.path.join(base_path, "tsv", name + ".tsv")
        if os.path.exists(tpath):
            words = read_subtitles(tpath)

        audio = None
        apath = os.path.join(base_path, "wav", name + ".wav")
        if with_audio and os.path.exists(apath):
            audio = load_wav(apath)

        # every 100th file -> validation, starting with file 0
        # (ref: twh_dataset_to_lmdb.py:209 `if save_idx % 100 == 0`)
        w = writers[1] if v_i % 100 == 0 else writers[0]
        kw = {} if audio is None else {"audio": audio}
        w.add_clip(name, poses, words=words, **kw)
        all_poses.append(np.asarray(poses, np.float16)
                         .astype(np.float32))  # f16 stats, see above

    stacked = np.vstack(all_poses)
    mean, std = stacked.mean(axis=0), stacked.std(axis=0)
    fps = 30 if variant in ("posrot", "rot") else 10
    for w in writers:
        w.set_stats(mean, std)
        w.set_meta(fps=fps, feature_dim=int(stacked.shape[1]),
                   variant=variant)
        w.finish()
    fe.save(os.path.join(out_path, "data_pipe.json"))
    return train_dir, val_dir
