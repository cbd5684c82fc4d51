"""The Part-d sentence dataset (the port's copy of the JAX package's
`data/sentence.py`): windows of sentence_frame_length frames with at
least 4 words, their word ids (SOS ... EOS, zero-padded to max_words)
and the gesture tokens of each n_frames chunk, from one offline sweep of
the frozen Part-a DAE and Part-b tokenizer (`data/teacher.py`); for the
audio Part d also each window's audio, at the sample its first frame's
position in the clip gives (zeros where a clip has none, zero-padded
past its end): one-second mel chunks (`include_audio`) or one-second raw
chunks (`include_raw_audio`); and each window's sentence embedding
from a `text/sentence_embedding` provider (`sentence_embedding`).
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np

from gesture2vec_tpu_torch.data.datasets import normalize, sentence_windows
from gesture2vec_tpu_torch.data.teacher import (encode_windows_with_dae,
                                                tokenize_windows)
from gesture2vec_tpu_torch.io.audio import mel_chunks_per_second


def build_sentence_dataset(store, vocab, *, dae_model, seq_model,
                           sentence_frame_length: int = 120,
                           stride: int = 20, n_frames: int = 20,
                           fps: int = 20, max_words: int = 48,
                           mean: Optional[np.ndarray] = None,
                           std: Optional[np.ndarray] = None,
                           include_audio: bool = False,
                           include_raw_audio: bool = False,
                           audio_sr: int = 16000,
                           sentence_embedding=None,
                           mesh=None, emit_stage_tokens: bool = False,
                           text_context_s: float = 0.0
                           ) -> Dict[str, np.ndarray]:
    """Returns {"word_ids" (N, max_words) int32, "lengths" (N,) int32,
    "tokens" (N, n_steps) int32 with n_steps = sentence_frame_length //
    n_frames, "poses" (N, sentence_frame_length, D) float32 normalized},
    "stage_tokens" (N, n_steps, S) when emit_stage_tokens (a
    residual-VQ tokenizer; "tokens" is its column 0), "mel" (N, seconds,
    128, frames) when include_audio and "wav" (N, seconds, audio_sr) when
    include_raw_audio, seconds = sentence_frame_length // fps, and
    "sentence_emb" (N, dim) float32 when a sentence_embedding provider is
    given (the reference's GPT3_Embedding batch slot): the provider's
    `embed_batch` of each window's words joined by spaces."""
    mean = store.pose_mean if mean is None else mean
    std = store.pose_std if std is None else std
    wins = sentence_windows(store, sentence_frame_length, stride, fps,
                            context_s=text_context_s)
    if not wins:
        raise ValueError("no sentence windows (too few words or frames)")
    clips = {i: store[i] for i in sorted({w["clip"] for w in wins})}
    poses = np.stack([
        normalize(clips[w["clip"]]["poses"][
            w["frame0"]:w["frame0"] + sentence_frame_length], mean, std)
        for w in wins]).astype(np.float32)

    N = len(wins)
    word_ids = np.zeros((N, max_words), np.int32)
    lengths = np.zeros((N,), np.int32)
    for i, w in enumerate(wins):
        ids = vocab.words_to_ids([t[0] for t in w["words"]])[:max_words]
        word_ids[i, :len(ids)] = ids
        lengths[i] = len(ids)

    n_steps = sentence_frame_length // n_frames
    latents = encode_windows_with_dae(dae_model, poses, mesh=mesh)
    chunks = latents.reshape(N * n_steps, n_frames, -1)
    tokens, _ = tokenize_windows(seq_model, chunks, mesh=mesh,
                                 all_stages=emit_stage_tokens)
    out = {"word_ids": word_ids, "lengths": lengths, "poses": poses}
    if emit_stage_tokens:
        out["stage_tokens"] = tokens.reshape(N, n_steps, -1).astype(np.int32)
        out["tokens"] = out["stage_tokens"][:, :, 0]
    else:
        out["tokens"] = tokens.reshape(N, n_steps).astype(np.int32)
    if sentence_embedding is not None:
        sentences = [" ".join(t[0] for t in w["words"]) for w in wins]
        out["sentence_emb"] = sentence_embedding.embed_batch(
            sentences).astype(np.float32)
    if include_audio or include_raw_audio:
        need = sentence_frame_length // fps * audio_sr
        segs = []
        for w in wins:
            clip = clips[w["clip"]]
            audio = clip.get("audio")
            seg = np.zeros((need,), np.float32)
            if audio is not None:
                # frames -> samples by their position in the clip
                a0 = math.floor(w["frame0"] / clip["poses"].shape[0]
                                * len(audio))
                got = audio[a0:a0 + need]
                seg[:len(got)] = got
            segs.append(seg)
        if include_audio:
            out["mel"] = np.stack([mel_chunks_per_second(a, audio_sr)
                                   for a in segs]).astype(np.float32)
        if include_raw_audio:
            out["wav"] = np.stack(segs).reshape(N, -1, audio_sr)
    return out
