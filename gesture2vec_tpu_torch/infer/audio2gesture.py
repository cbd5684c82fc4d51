"""End-to-end audio-context inference: speech -> gesture tokens -> motion.

Port of the JAX package's `infer/audio2gesture.py` AudioGestureGenerator.
A request's audio (mono at audio_sr) is cut into windows of
sentence_frame_length / fps seconds, zero-padded to whole windows; each
window becomes its one-second mel chunks (`io/audio.mel_chunks_per_second`,
on the host), or with fusion "both" its one-second raw chunks and the ids
of the transcript words that overlap it. Then:

  encode   every window in one batch (`Audio2Token.encode_audio`: on the
           card the BiGRU's 4 `gru_sequence` launches, at T = seconds a
           window and B = windows);
  tokens   window after window, each window's teacher prefix the previous
           window's last n_pre_poses tokens (`ChunkSynthesis.
           _decode_carried`), under the policy: greedy, sampled
           (temperature, top_k: the request's Gumbel noise drawn on the
           host from a torch.Generator seeded by one draw of the numpy
           stream, as GestureGenerator draws it) or beam_width > 1;
  motion   decode mode: every chunk of the request in one
           `fused_chunk_decode` launch (soft_decode, decode_overlap and the
           residual stages' sums as GestureGenerator has them), then the
           DAE; exemplar mode: the latent bank's picks (with or without
           exemplar_continuity) and the DAE.
The windows are not bucketed (as in JAX): a request of W windows decodes
6 * W chunks at the shipped widths.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from gesture2vec_tpu_torch.infer.text2gesture import ChunkSynthesis
from gesture2vec_tpu_torch.io.audio import mel_chunks_per_second
from gesture2vec_tpu_torch.models.audio2token import (Audio2Token,
                                                      EncoderInputs)
from gesture2vec_tpu_torch.models.dae import DAE, VAEFrame, VQFrame
from gesture2vec_tpu_torch.models.seq_ae import SeqDecoder
from gesture2vec_tpu_torch.text.vocab import Vocab


@dataclasses.dataclass
class AudioGestureGenerator(ChunkSynthesis):
    """With an Audio2Token of fusion "both", `generate` also needs the
    transcript words and `vocab`."""

    a2t_model: Audio2Token
    seq_decoder: SeqDecoder
    dae_model: Union[DAE, VAEFrame, VQFrame]
    pose_mean: np.ndarray
    pose_std: np.ndarray
    n_frames: int = 20
    sentence_frame_length: int = 120
    fps: int = 20
    audio_sr: int = 16000
    mode: str = "decode"              # "decode" | "exemplar"
    latent_bank: Optional[Dict[str, np.ndarray]] = None
    seed: int = 0
    vocab: Optional[Vocab] = None
    max_words: int = 48
    temperature: float = 0.0
    top_k: int = 0
    beam_width: int = 0
    exemplar_continuity: bool = False
    decode_overlap: int = 0
    soft_decode: float = 0.0
    use_fused_decoder: bool = True
    device: Optional[Union[str, torch.device]] = None

    def __post_init__(self):
        self._setup_synthesis()
        self.fusion = self.a2t_model.fusion

    @property
    def token_model(self) -> Audio2Token:
        return self.a2t_model

    @property
    def window_seconds(self) -> int:
        return self.sentence_frame_length // self.fps

    # ------------------------------------------------------------------
    def _padded(self, audio: np.ndarray, n_windows: int) -> np.ndarray:
        need = n_windows * self.window_seconds * self.audio_sr
        audio = np.asarray(audio, np.float32)
        if len(audio) < need:
            audio = np.pad(audio, (0, need - len(audio)))
        return audio[:need]

    def mel_windows(self, audio: np.ndarray, n_windows: int) -> np.ndarray:
        """(W, seconds, 128, frames) float32: each window's one-second
        mel chunks."""
        seg = self._padded(audio, n_windows).reshape(n_windows, -1)
        return np.stack([mel_chunks_per_second(w, self.audio_sr)
                         for w in seg]).astype(np.float32)

    def wav_windows(self, audio: np.ndarray, n_windows: int) -> np.ndarray:
        """(W, seconds, audio_sr) float32: each window's one-second raw
        chunks (the fusion encoder's WavEncoderTri takes 1 s at 16 kHz)."""
        return self._padded(audio, n_windows).reshape(
            n_windows, self.window_seconds, self.audio_sr)

    def window_word_ids(self, words: List[List], n_windows: int
                        ) -> np.ndarray:
        """(W, max_words) int64: the ids of the words overlapping each
        window's time range, zero-padded."""
        unit = self.sentence_frame_length / self.fps
        out = np.zeros((n_windows, self.max_words), np.int64)
        for w in range(n_windows):
            t0, t1 = w * unit, (w + 1) * unit
            inside = [t[0] for t in words if t[2] > t0 and t[1] < t1]
            ids = self.vocab.words_to_ids(inside)[: self.max_words]
            out[w, :len(ids)] = ids
        return out

    def encoder_inputs(self, audio: np.ndarray, n_windows: int,
                       words: Optional[List[List]] = None
                       ) -> EncoderInputs:
        """The encoder's inputs for the request's windows, on the device:
        mel chunks, or with fusion "both" (word ids, raw chunks)."""
        if self.fusion == "both":
            if words is None or self.vocab is None:
                raise ValueError("audio_fusion='both' generation needs "
                                 "the transcript words and a vocab")
            ids = self.window_word_ids(words, n_windows)
            return (torch.from_numpy(ids).to(self.device),
                    torch.from_numpy(self.wav_windows(audio, n_windows))
                    .to(self.device))
        return torch.from_numpy(self.mel_windows(audio, n_windows)).to(
            self.device)

    def _predict(self, enc_in: EncoderInputs,
                 gumbel: Optional[torch.Tensor] = None,
                 seed: Optional[torch.Tensor] = None
                 ) -> Dict[str, torch.Tensor]:
        """The windows' encoder inputs (W leading) -> the token outputs
        of one row of W windows (`_token_outputs`, B = 1) and its
        "next_seed" (1, n_steps); seed (1, n_steps) the first window's
        teacher seed, gumbel (1, W, ...)."""
        enc_outs, dec_hidden = self.a2t_model.encode_audio(enc_in)
        res, next_seed = self._decode_carried(
            enc_outs[:, None], dec_hidden[:, None], seed, None, gumbel)
        return {**self._token_outputs(res), "next_seed": next_seed}

    def _motion(self, pred: Dict[str, torch.Tensor]) -> np.ndarray:
        """One row's token outputs -> its unnormalised frames."""
        if self.mode == "exemplar":
            tokens = pred["tokens"][0].to(torch.int32).cpu().numpy()
            return self._frames(self._exemplar_decode(self._picks([tokens])))
        return self._frames(self.dae_model.decode(
            self._decode_chunks(pred)[0]))

    @torch.inference_mode()
    def generate(self, audio: np.ndarray,
                 duration_s: Optional[float] = None,
                 words: Optional[List[List]] = None
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """audio: mono float at audio_sr; duration_s defaults to its
        length; words [[word, start_s, end_s], ...] for fusion "both".
        Returns (motion (n_windows * sentence_frame_length, pose_dim)
        unnormalised, tokens (n_windows * n_steps,) int32)."""
        if duration_s is None:
            duration_s = len(audio) / self.audio_sr
        unit = self.sentence_frame_length / self.fps
        n_windows = max(int(np.ceil(duration_s / unit)), 1)
        enc_in = self.encoder_inputs(audio, n_windows, words)
        pred = self._predict(enc_in, self._noise(self._next_generator(),
                                                 (1, n_windows)))
        tokens = pred["tokens"][0].to(torch.int32).cpu().numpy()
        return self._motion(pred), tokens
