"""End-to-end inference: transcript -> gesture tokens -> motion frames.

Port of the JAX package's `infer/text2gesture.py` GestureGenerator in
decode mode with greedy tokens. Per sentence window (sentence_frame_length
/ fps seconds) the words inside it become ids, the Text2Token model
emits n_steps gesture tokens, each token's codebook row becomes the
decoder's initial hidden, the Part-b decoder rolls every chunk out from
a zero seed frame, and the DAE decodes the latents to poses.

  window_carry=True   windows decode one after another; each window's
                      teacher prefix is the previous window's last
                      n_pre_poses tokens, and its attention mask is its
                      own length.
  window_carry=False  all windows decode in one batch from zero seeds,
                      with the batch-max attention mask.
  use_fused_decoder   the chunk rollout runs in ops/decoder_kernel (the
                      Hopper kernel on CUDA, its plain version on the
                      CPU); False takes SeqDecoder.rollout.

Not ported yet: exemplar mode, chunk_continuity, decode_overlap,
soft_decode, sampled and beam decodes (models/text2token), multi-stage
tokens and generate_batch.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from gesture2vec_tpu_torch.data.datasets import unnormalize
from gesture2vec_tpu_torch.device import resolve_device
from gesture2vec_tpu_torch.models.dae import DAE
from gesture2vec_tpu_torch.models.seq_ae import SeqDecoder
from gesture2vec_tpu_torch.models.text2token import Text2Token
from gesture2vec_tpu_torch.ops.decoder_kernel import (fold_decoder_step,
                                                      fused_chunk_decode,
                                                      supported)
from gesture2vec_tpu_torch.text.vocab import Vocab

# the later slice that ports each option (ROADMAP.md queue A)
_POLICIES = "the decode-policies slice"
_LATER = "not ported yet ({} of the PyTorch port)"


def bucket_windows(n_windows: int) -> int:
    """Padded window count: powers of two up to 16, then multiples of 16
    (the JAX package's bucketing, kept so both decode the same chunk
    batch)."""
    if n_windows <= 16:
        return 1 << (n_windows - 1).bit_length()
    return (n_windows + 15) // 16 * 16


@dataclasses.dataclass
class GestureGenerator:
    t2t_model: Text2Token
    seq_decoder: SeqDecoder
    dae_model: DAE
    vocab: Vocab
    pose_mean: np.ndarray
    pose_std: np.ndarray
    n_frames: int = 20
    sentence_frame_length: int = 120
    fps: int = 20
    max_words: int = 48
    mode: str = "decode"
    window_carry: bool = True
    use_fused_decoder: bool = True
    # extend each window's word lookup backwards by this many seconds;
    # must match what the Part-d model was trained with
    text_context_s: float = 0.0
    chunk_continuity: bool = False
    decode_overlap: int = 0
    soft_decode: float = 0.0
    device: Optional[Union[str, torch.device]] = None

    def __post_init__(self):
        unported = {"mode='exemplar'": (self.mode != "decode",
                                        "the exemplar-mode slice"),
                    "chunk_continuity": (self.chunk_continuity, _POLICIES),
                    "decode_overlap": (self.decode_overlap, _POLICIES),
                    "soft_decode": (self.soft_decode, _POLICIES)}
        for name, (on, where) in unported.items():
            if on:
                raise NotImplementedError(
                    f"{name} is {_LATER.format(where)}")
        self.device = resolve_device(self.device)
        self.n_steps = self.sentence_frame_length // self.n_frames
        if self.t2t_model.n_steps != self.n_steps:
            raise ValueError(f"Text2Token decodes {self.t2t_model.n_steps} "
                             f"steps, windows hold {self.n_steps} chunks")
        if self.seq_decoder.n_frames != self.n_frames:
            raise ValueError(f"SeqDecoder rolls {self.seq_decoder.n_frames}"
                             f" frames, chunks hold {self.n_frames}")
        for m in (self.t2t_model, self.seq_decoder, self.dae_model):
            m.to(self.device).eval()
        if self.use_fused_decoder:
            reason = supported(self.seq_decoder.decoder_step)
            if not reason and self.seq_decoder.n_pre_poses != 1:
                reason = "the kernel starts from one seed frame " \
                         "(n_pre_poses=1)"
            if reason:
                raise ValueError(f"use_fused_decoder: {reason}")
            self._folded = fold_decoder_step(self.seq_decoder.decoder_step)

    # ------------------------------------------------------------------
    def _window_word_ids(self, words: List[List], t0: float, t1: float
                         ) -> Tuple[np.ndarray, int]:
        """Ids of the words overlapping [t0 - text_context_s, t1), SOS/EOS
        added, cut to max_words and zero-padded; the length is >= 1."""
        t0 = t0 - float(self.text_context_s)
        inside = [w[0] for w in words if w[2] > t0 and w[1] < t1]
        ids = self.vocab.words_to_ids(inside)[: self.max_words]
        arr = np.zeros((self.max_words,), np.int64)
        arr[: len(ids)] = ids
        return arr, max(len(ids), 1)

    def _predict_tokens(self, word_ids: torch.Tensor, lengths: torch.Tensor
                        ) -> torch.Tensor:
        """word_ids (W, S), lengths (W,) -> tokens (W * n_steps,)."""
        t2t, n_steps = self.t2t_model, self.n_steps
        W, S = word_ids.shape
        if not self.window_carry:
            targets = torch.zeros((W, n_steps), dtype=torch.long,
                                  device=self.device)
            return t2t(word_ids, lengths, targets)["tokens"].reshape(-1)

        enc_outs, dec_hidden = t2t.encode_text(word_ids, lengths)
        positions = torch.arange(S, device=self.device)
        n_pre = t2t.n_pre_poses
        seed = torch.zeros((1, n_steps), dtype=torch.long, device=self.device)
        toks = []
        for w in range(W):
            res = t2t.decode_tokens(enc_outs[:, w:w + 1],
                                    dec_hidden[:, w:w + 1], seed,
                                    enc_mask=positions < lengths[w])
            toks.append(res["tokens"])
            seed = torch.zeros_like(seed)
            if n_pre:
                seed[:, :n_pre] = res["tokens"][:, -n_pre:]
        return torch.cat(toks, dim=1).reshape(-1)

    def _decode_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (N,) -> latents (N * n_frames, rep_dim): every chunk
        rolls out as one batch from a zero seed frame."""
        seq = self.seq_decoder
        hidden = seq.token_hidden(tokens).contiguous()
        seed = torch.zeros((tokens.shape[0], seq.rep_dim),
                           dtype=torch.float32, device=self.device)
        if self.use_fused_decoder:
            ys = fused_chunk_decode(seed, hidden, self._folded,
                                    n_steps=seq.n_frames)
            return ys.transpose(0, 1).reshape(-1, seq.rep_dim)
        return seq.rollout(hidden, seed).reshape(-1, seq.rep_dim)

    def window_inputs(self, words: List[List], duration_s: float
                      ) -> Tuple[torch.Tensor, torch.Tensor, int]:
        """(word_ids (W, max_words), lengths (W,)) on the device for the
        bucketed window count W, and the real window count. Padded
        windows hold no words and generate throwaway frames."""
        unit = self.sentence_frame_length / self.fps
        n_windows = max(int(np.ceil(duration_s / unit)), 1)
        n_padded = bucket_windows(n_windows)
        word_ids = np.zeros((n_padded, self.max_words), np.int64)
        lengths = np.ones((n_padded,), np.int64)
        for w in range(n_windows):
            word_ids[w], lengths[w] = self._window_word_ids(
                words, w * unit, (w + 1) * unit)
        return (torch.from_numpy(word_ids).to(self.device),
                torch.from_numpy(lengths).to(self.device), n_windows)

    @torch.inference_mode()
    def generate(self, words: List[List], duration_s: float
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """words: [[word, start_s, end_s], ...]. Returns (motion
        (n_windows * sentence_frame_length, pose_dim) unnormalized,
        tokens (n_windows * n_steps,) int32)."""
        word_ids, lengths, n_windows = self.window_inputs(words, duration_s)
        tokens = self._predict_tokens(word_ids, lengths)
        frames = self.dae_model.decode(self._decode_tokens(tokens))
        n_tokens_real = n_windows * self.n_steps
        frames = frames[: n_tokens_real * self.n_frames].cpu().numpy()
        frames = unnormalize(frames, self.pose_mean, self.pose_std)
        return frames, tokens[:n_tokens_real].to(torch.int32).cpu().numpy()

    def generate_batch(self, transcripts, durations_s, mesh=None):
        raise NotImplementedError(
            f"generate_batch is {_LATER.format(_POLICIES)}")
