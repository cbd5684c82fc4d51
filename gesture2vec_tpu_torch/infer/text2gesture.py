"""End-to-end inference: transcript -> gesture tokens -> motion frames.

Port of the JAX package's `infer/text2gesture.py` GestureGenerator. Per
sentence window (sentence_frame_length / fps seconds) the words inside it
become ids and the Part-d model (`models/text2token.Text2Token` or
`models/transformer.TransformerText2Token`) emits n_steps gesture tokens.
Then one of two synthesis modes:

  mode="exemplar"  (the default, as in the JAX package) each token
                   retrieves a corpus window of its cluster from the
                   latent bank (infer/exemplar.py) and the DAE decodes the
                   window's stored latents;
  mode="decode"    each token's codebook row (plus the residual stages'
                   rows for a token_stages > 1 model) becomes the decoder's
                   initial hidden, the Part-b decoder rolls every chunk out
                   from a zero seed frame, and the DAE decodes the latents.

Token decode:
  window_carry=True   windows decode one after another; each window's
                      teacher prefix is the previous window's last n_pre
                      tokens (the model's n_pre: n_pre_poses, clamped to
                      >= 1 by the transformer), and its attention mask is
                      its own length. On the card a window's decode is
                      captured once as a CUDA graph and replayed window
                      after window (`_decode_carried`).
  window_carry=False  all windows decode in one batch from zero seeds,
                      with the batch-max attention mask, or each window's
                      own for a model with per_sentence_mask (the
                      transformer: its pad positions carry content).
  temperature, top_k, stage0_temperature   sampled decode
                      (models/text2token.sample_logits). A request draws
                      one integer from the generator's numpy stream (seeded
                      by `seed`, shared with the exemplar picks and drawn
                      before them), seeds a CPU torch.Generator with it and
                      draws the request's Gumbel noise on the host; greedy
                      requests draw nothing.
  beam_width > 1      beam search (Text2Token.beam_decode).
Chunk decode (decode mode):
  use_fused_decoder   the rollout runs in ops/decoder_kernel (the Hopper
                      kernel on CUDA, its plain version on the CPU): one
                      launch a request; False takes SeqDecoder.rollout.
                      A tokenizer the kernel cannot run (kernel_reason:
                      a parity checkpoint's eval step dropout, among
                      others) is refused unless this is False; the
                      rollout then applies that dropout from a generator
                      seeded 0 each call, as the JAX generator feeds it
                      PRNGKey(0).
  soft_decode > 0     each chunk's hidden is softmax(logits / soft_decode)
                      @ codebook (and the stage mixtures), seed steps the
                      hard rows.
  decode_overlap = b  every chunk rolls b frames past its length and the
                      next chunk's first b frames crossfade with them,
                      weights (1 .. b) / (b + 1); the kernel takes the
                      longer rollout (one launch).
  chunk_continuity    chunks roll out one after another, each seeded with
                      the previous chunk's last frame: one launch a chunk.
`generate_batch` runs many transcripts as one batch, split over a mesh's
dp ranks where one is given.
`ChunkSynthesis` holds what the generator shares with the audio one
(`infer/audio2gesture.AudioGestureGenerator`).
Each stage of a call is a span, g2v.gen.*, and the rollout counts its
chunks, gen.chunks_rolled and gen.chunks_real, the copy to the host its
frames and the call those it returns, gen.frames_copied and
gen.frames_returned, the carried decode its
windows, gen.token_windows, gen.token_graph_replays and
gen.token_graph_captures, and every token decode the decoder positions
it computes and reads, gen.token_positions_computed and
gen.token_positions_read (`utils/profiling`).
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from gesture2vec_tpu_torch.data.datasets import STD_CLIP
from gesture2vec_tpu_torch.device import resolve_device
from gesture2vec_tpu_torch.infer.exemplar import ExemplarBank
from gesture2vec_tpu_torch.models.dae import DAE, VAEFrame, VQFrame
from gesture2vec_tpu_torch.models.seq_ae import SeqDecoder
from gesture2vec_tpu_torch.models.text2token import Text2Token, gumbel_noise
from gesture2vec_tpu_torch.models.transformer import TransformerText2Token
from gesture2vec_tpu_torch.ops.decoder_kernel import (fold_decoder_step,
                                                      fused_chunk_decode)
from gesture2vec_tpu_torch.text.vocab import Vocab
from gesture2vec_tpu_torch.utils.profiling import annotate, count


# the decode outputs a request reads, each (windows, ...)
_PER_WINDOW = ("tokens", "logits", "stage_tokens", "stage_logits")
# CUDA graphs of a carried window a generator keeps, one a row count (its
# shape and policy are otherwise fixed): a server's fused batches pad to
# powers of two up to its max_batch, 32 by default, and single requests run
# at one row, six row counts in all (`serve/server.BatchingWorker._bucket`)
_TOKEN_GRAPHS = 8


def bucket_windows(n_windows: int) -> int:
    """Padded window count: powers of two up to 16, then multiples of 16
    (the JAX package's bucketing, kept so both decode the same chunk
    batch)."""
    if n_windows <= 16:
        return 1 << (n_windows - 1).bit_length()
    return (n_windows + 15) // 16 * 16


class ChunkSynthesis:
    """What a text and an audio generator share (the JAX package's two
    generators hold copies of it): option checks and device set-up, the
    request's sampling noise, the per-window token decode under the
    policy, the decode outputs as chunk inputs, the chunk rollout
    (kernel or module), the exemplar picks and the unnormalised frames.
    A generator provides `token_model` (Text2Token, the transformer or
    Audio2Token), seq_decoder, dae_model, device, mode, seed, the decode
    options and the frame layout."""

    chunk_continuity = False
    stage0_temperature = -1.0

    def _setup_synthesis(self) -> None:
        """Checks the options, moves the models to the device in eval
        mode, folds the chunk decoder's weights for the kernel and builds
        the exemplar bank (the JAX generators' __post_init__)."""
        if self.mode not in ("decode", "exemplar"):
            raise ValueError(f"unknown mode {self.mode!r}")
        self.device = resolve_device(self.device)
        self.n_steps = self.sentence_frame_length // self.n_frames
        self._rng = np.random.default_rng(self.seed)
        t2t, seq = self.token_model, self.seq_decoder
        if t2t.n_steps != self.n_steps:
            raise ValueError(f"the token model decodes {t2t.n_steps} "
                             f"steps, windows hold {self.n_steps} chunks")
        if seq.n_frames != self.n_frames:
            raise ValueError(f"SeqDecoder rolls {seq.n_frames}"
                             f" frames, chunks hold {self.n_frames}")
        self._sampling = self.temperature > 0.0 or \
            self.stage0_temperature > 0.0
        self._beam = int(self.beam_width) if self.beam_width > 1 else 0
        self._token_graphs = collections.OrderedDict()
        soft = float(self.soft_decode)
        if self._beam and self._sampling:
            raise ValueError("beam_width>1 and temperature>0 are "
                             "mutually exclusive decode policies")
        if soft and self.mode != "decode":
            raise ValueError("soft_decode only applies to decode mode "
                             "(exemplar retrieval is indexed by hard "
                             "tokens)")
        if soft and self._beam:
            raise ValueError("soft_decode needs the per-step predictive "
                             "distribution, which beam search does not "
                             "produce; use greedy or sampled decode")
        if self.decode_overlap and self.chunk_continuity:
            raise ValueError("decode_overlap and chunk_continuity are "
                             "mutually exclusive chunk-transition "
                             "mechanisms")
        if t2t.token_stages > seq.stages:
            raise ValueError(f"Part d predicts {t2t.token_stages} stages "
                             f"but the tokenizer has {seq.stages}")
        for m in (t2t, seq, self.dae_model):
            m.to(self.device).eval()
        # `data/datasets.unnormalize`'s statistics on the device, each in
        # its own dtype so that the frames promote as numpy promotes them
        self._pose_scale = torch.tensor(
            np.atleast_1d(np.clip(self.pose_std, a_min=STD_CLIP, a_max=None)),
            device=self.device)
        self._pose_shift = torch.tensor(np.atleast_1d(self.pose_mean),
                                        device=self.device)
        if self.use_fused_decoder:
            reason = seq.kernel_reason()
            if reason:
                raise ValueError(f"use_fused_decoder: {reason}")
            self._folded = fold_decoder_step(seq.decoder_step)
        if self.mode == "exemplar":
            if self.latent_bank is None:
                raise ValueError("exemplar mode needs a latent bank "
                                 "(cluster/latent_dataset)")
            self._exemplars = ExemplarBank(
                self.latent_bank, t2t.n_tokens,
                seq.codebook.detach().cpu().numpy(), self._rng)
            self._exemplar_decode = self._exemplars.make_decode_fn(
                self.dae_model, self.device)

    def _next_generator(self) -> Optional[torch.Generator]:
        """The request's noise generator, seeded by one draw from the
        numpy stream, as the JAX generator draws its request key; None
        (and no draw) when the decode is greedy."""
        if not self._sampling:
            return None
        return torch.Generator().manual_seed(
            int(self._rng.integers(2 ** 31 - 1)))

    def _noise(self, generator: Optional[torch.Generator],
               windows: Tuple[int, int]) -> Optional[torch.Tensor]:
        """Gumbel noise (B, W, n_steps - 1, token_stages, K) drawn on the
        host, then moved to the device (span gen.noise)."""
        if generator is None:
            return None
        t2t = self.token_model
        shape = (*windows, self.n_steps - 1, t2t.token_stages, t2t.n_tokens)
        with annotate("gen.noise"):
            return gumbel_noise(shape, generator).to(self.device)

    def _count_positions(self, rows: int) -> None:
        """Counts the decoder positions of `rows` window rows' token
        decode (the token model's `decode_positions` a row, times the beam
        width): gen.token_positions_computed, those the decoder computes,
        and gen.token_positions_read, those the choices read."""
        computed, read = self.token_model.decode_positions
        rows *= max(self._beam, 1)
        count("gen.token_positions_computed", computed * rows)
        count("gen.token_positions_read", read * rows)

    def _decode_windows(self, enc_outs, dec_hidden, seed, mask, gumbel):
        if self._beam:
            return self.token_model.beam_decode(enc_outs, dec_hidden, seed,
                                                self._beam, mask)
        return self.token_model.decode_tokens(
            enc_outs, dec_hidden, seed, mask, temperature=self.temperature,
            top_k=self.top_k, stage0_temperature=self.stage0_temperature,
            gumbel=gumbel)

    def _token_window(self, bufs: Dict[str, torch.Tensor]) -> None:
        """One window of the carried decode on its staged buffers: reads
        "enc_outs" (S, B, H), "dec_hidden" (L, B, H), "seed" (B,
        n_steps), and "mask" (B, S) and "gumbel" (B, ...) where present;
        puts the decode outputs of `_PER_WINDOW` in bufs under their
        names and writes the next window's seed, the last n_pre tokens,
        over "seed" in place. It runs eagerly, or is what a token graph
        captured (`_token_graph`)."""
        res = self._decode_windows(bufs["enc_outs"], bufs["dec_hidden"],
                                   bufs["seed"], bufs.get("mask"),
                                   bufs.get("gumbel"))
        bufs.update((k, v) for k, v in res.items() if k in _PER_WINDOW)
        n_pre = self.token_model.n_pre
        seed = bufs["seed"]
        seed.zero_()
        if n_pre:
            seed[:, :n_pre] = res["tokens"][:, -n_pre:]

    def _token_graph_ok(self, enc_outs: torch.Tensor, W: int) -> bool:
        """Whether the carried decode replays a CUDA graph of its window:
        on the card, a model in eval mode without autograd, greedy or
        sampled from given noise (not beam search), and two windows or
        more, so that the capture pays back."""
        return (enc_outs.is_cuda and W >= 2 and not self._beam
                and not self.token_model.training
                and not torch.is_grad_enabled())

    def _token_graph(self, first: Dict[str, torch.Tensor],
                     seed: torch.Tensor
                     ) -> Tuple[torch.cuda.CUDAGraph, Dict[str, torch.Tensor]]:
        """The CUDA graph of `_token_window` and its static buffers for
        the shapes and the policy of `first` (a first window's inputs)
        and `seed`: from the generator's cache (at most `_TOKEN_GRAPHS`,
        the least recently used dropped first), else warmed up on a side
        stream over the first window and captured, on the card of the
        inputs, which is the current one (`_decode_carried`)."""
        # buffers made under inference mode cannot be written outside it
        key = (torch.is_inference_mode_enabled(), float(self.temperature),
               int(self.top_k), float(self.stage0_temperature),
               tuple(seed.shape), seed.device) + tuple(
                   (k, tuple(v.shape), v.dtype) for k, v in sorted(
                       first.items()))
        graphs = self._token_graphs
        if key in graphs:
            graphs.move_to_end(key)
            return graphs[key]
        bufs = {k: v.clone() for k, v in first.items()}
        bufs["seed"] = seed.clone()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            self._token_window(dict(bufs))
        torch.cuda.current_stream().wait_stream(side)
        bufs["seed"].copy_(seed)                 # the warm-up carried it
        graph = torch.cuda.CUDAGraph()
        # the side stream, not torch.cuda.graph's own, which stays on the
        # card it was first made on
        with torch.cuda.graph(graph, stream=side,
                              capture_error_mode="thread_local"):
            self._token_window(bufs)
        count("gen.token_graph_captures")
        if len(graphs) >= _TOKEN_GRAPHS:
            # no replay of the graph dropped may still be running
            torch.cuda.current_stream().synchronize()
            graphs.popitem(last=False)
        graphs[key] = graph, bufs
        return graph, bufs

    def _decode_carried(self, enc_outs: torch.Tensor,
                        dec_hidden: torch.Tensor,
                        seed: Optional[torch.Tensor],
                        masks: Optional[torch.Tensor],
                        gumbel: Optional[torch.Tensor]
                        ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """B rows of W windows decoded window after window, each window
        of all rows as one batch: enc_outs (S, B, W, H), dec_hidden (L,
        B, W, H), seed (B, n_steps) the first window's teacher seed (zeros
        when None), masks (B, W, S) each window's attention mask (None:
        every position), gumbel (B, W, ...) or None. Each window's seed is
        the last n_pre tokens of the one before. Every window is staged
        into one set of buffers and runs `_token_window` on them: where
        `_token_graph_ok` holds, as the replay of its CUDA graph, else
        eagerly. Returns (the decode outputs stacked (B, W, ...), copied
        out of the buffers, and the seed of a next window)."""
        B, W = enc_outs.shape[1:3]
        if seed is None:
            seed = torch.zeros((B, self.n_steps), dtype=torch.long,
                               device=self.device)
        # each input with its windows leading
        per = {"enc_outs": enc_outs.movedim(2, 0),
               "dec_hidden": dec_hidden.movedim(2, 0),
               "mask": None if masks is None else masks.movedim(1, 0),
               "gumbel": None if gumbel is None else gumbel.movedim(1, 0)}
        per = {k: v for k, v in per.items() if v is not None}
        graph = None
        # the capture and the replays run on the inputs' card, which need
        # not be the current one
        with (torch.cuda.device(enc_outs.device) if enc_outs.is_cuda
              else contextlib.nullcontext()):
            if self._token_graph_ok(enc_outs, W):
                graph, bufs = self._token_graph({k: v[0] for k, v in
                                                 per.items()}, seed)
                bufs["seed"].copy_(seed)
            else:
                bufs = {k: torch.empty_like(v[0]) for k, v in per.items()}
                bufs["seed"] = seed.clone()
            count("gen.token_windows", W)
            self._count_positions(B * W)
            outs = None
            for w in range(W):
                with annotate("gen.token_window"):
                    for k, v in per.items():
                        bufs[k].copy_(v[w])
                    if graph is None:
                        self._token_window(bufs)
                    else:
                        graph.replay()
                    if outs is None:
                        outs = {k: bufs[k].new_empty((B, W,
                                                      *bufs[k].shape[1:]))
                                for k in _PER_WINDOW if k in bufs}
                    for k, o in outs.items():
                        o[:, w].copy_(bufs[k])
            if graph is not None:
                count("gen.token_graph_replays", W)
            return outs, bufs["seed"].clone()

    def _token_outputs(self, res: Dict[str, torch.Tensor]
                       ) -> Dict[str, torch.Tensor]:
        """The decode outputs of B rows of W windows (each (B, W, ...))
        -> "tokens" (B, W * n_steps); with residual stages "stage" (B,
        W * n_steps, S-1), -1 at each window's seed step; with
        soft_decode the mixtures "probs" (B, W * n_steps, K) and
        "stage_probs" (B, W * n_steps, S-1, K), each window's seed step
        the hard one-hot (and no stage mixture)."""
        B, W = res["tokens"].shape[:2]
        n_steps = self.n_steps
        out = {"tokens": res["tokens"].reshape(B, -1)}
        soft = float(self.soft_decode)
        if soft:
            p = torch.softmax(res["logits"] / soft, dim=-1)
            p[:, :, 0] = F.one_hot(res["tokens"][:, :, 0],
                                   p.shape[-1]).to(p.dtype)
            out["probs"] = p.reshape(B, W * n_steps, -1)
        if self.token_model.token_stages > 1:
            st = res["stage_tokens"]                     # (B, W, T-1, S-1)
            pad = torch.full_like(st[:, :, :1], -1)
            out["stage"] = torch.cat([pad, st], dim=2).reshape(
                B, W * n_steps, -1)
            if soft:
                sp = torch.softmax(res["stage_logits"] / soft, dim=-1)
                sp = torch.cat([torch.zeros_like(sp[:, :, :1]), sp], dim=2)
                out["stage_probs"] = sp.reshape(B, W * n_steps,
                                                *sp.shape[3:])
        return out

    def _rollout(self, seed: torch.Tensor, hidden: torch.Tensor,
                 n_steps: int) -> torch.Tensor:
        """seed (N, D), hidden (L, N, H) -> (N, n_steps, D), through the
        kernel or the module rollout."""
        if self.use_fused_decoder:
            return fused_chunk_decode(seed.contiguous(), hidden.contiguous(),
                                      self._folded,
                                      n_steps=n_steps).transpose(0, 1)
        return self.seq_decoder.rollout(hidden, seed, n_steps=n_steps)

    def _decode_chunks(self, pred: Dict[str, torch.Tensor],
                       prev: Optional[torch.Tensor] = None,
                       overlap: Optional[int] = None) -> torch.Tensor:
        """The token prediction of B transcripts of N chunks -> latents
        (B, N * n_frames, rep_dim). With chunk_continuity, prev (B, rep_dim)
        seeds each row's first chunk (zeros when None), and the carry for
        a next call is the last latent frame, latents[:, -1]. overlap
        (default decode_overlap) is the crossfade's frames."""
        with annotate("gen.rollout"):
            seq, Fr = self.seq_decoder, self.n_frames
            B, N = pred["tokens"].shape
            count("gen.chunks_rolled", B * N)

            def flat(key):
                return None if key not in pred else pred[key].flatten(0, 1)

            hidden = seq.token_hidden(flat("tokens"), flat("stage"),
                                      flat("probs"), flat("stage_probs"))
            D = seq.rep_dim
            if self.chunk_continuity:
                hidden = hidden.reshape(hidden.shape[0], B, N, -1)
                if prev is None:
                    prev = torch.zeros((B, D), dtype=torch.float32,
                                       device=self.device)
                chunks = []
                for i in range(N):
                    out = self._rollout(prev, hidden[:, :, i], Fr)
                    prev = out[:, -1]
                    chunks.append(out)
                return torch.stack(chunks, dim=1).reshape(B, N * Fr, D)
            b = int(self.decode_overlap if overlap is None else overlap)
            seed = torch.zeros((B * N, D), dtype=torch.float32,
                               device=self.device)
            out = self._rollout(seed, hidden, Fr + b)
            if not b:
                return out.reshape(B, N * Fr, D)
            out = out.reshape(B, N, Fr + b, D)
            main = out[:, :, :Fr].clone()
            w = ((torch.arange(b, dtype=torch.float32, device=self.device)
                  + 1.0) / (b + 1.0))[:, None]
            main[:, 1:, :b] = ((1 - w) * out[:, :-1, Fr:]
                               + w * out[:, 1:, :b])
            return main.reshape(B, N * Fr, D)

    def _frames(self, frames: torch.Tensor,
                rows: Optional[Sequence[int]] = None) -> np.ndarray:
        """Frames (..., pose_dim) on the device -> unnormalised on the
        host, bitwise `unnormalize(frames.cpu().numpy(), pose_mean,
        pose_std)`. rows, a real frame count for each row of frames
        (B, T, pose_dim), keeps the first rows[b] frames of row b alone:
        (sum(rows), pose_dim), row after row. From a card the frames land
        in pinned memory, a block of the caching host allocator's each
        call, so the arrays a caller keeps are never written again."""
        with annotate("gen.unnormalize"):
            if rows is not None:
                frames = torch.cat([f[:n] for f, n in zip(frames, rows)])
            # a product, then a sum, rounded each as numpy rounds them
            frames = frames * self._pose_scale + self._pose_shift
        with annotate("gen.frames_to_host"):
            if frames.is_cuda:
                frames = torch.empty(frames.shape, dtype=frames.dtype,
                                     pin_memory=True).copy_(frames)
            count("gen.frames_copied", frames.numel() // frames.shape[-1])
            return frames.numpy()

    def _picks(self, tokens: Sequence[np.ndarray]) -> np.ndarray:
        """Exemplar picks for each transcript's tokens: one vectorised
        pick over all of them, or one continuity chain per transcript."""
        if self.exemplar_continuity:
            return np.concatenate(
                [self._exemplars.pick_indices_continuity(t) for t in tokens])
        return self._exemplars.pick_indices(np.concatenate(tokens))


@dataclasses.dataclass
class GestureGenerator(ChunkSynthesis):
    t2t_model: Union[Text2Token, TransformerText2Token]
    seq_decoder: SeqDecoder
    dae_model: Union[DAE, VAEFrame, VQFrame]
    vocab: Vocab
    pose_mean: np.ndarray
    pose_std: np.ndarray
    n_frames: int = 20
    sentence_frame_length: int = 120
    fps: int = 20
    max_words: int = 48
    mode: str = "exemplar"          # "exemplar" | "decode"
    latent_bank: Optional[Dict[str, np.ndarray]] = None
    seed: int = 0
    window_carry: bool = True
    use_fused_decoder: bool = True
    # extend each window's word lookup backwards by this many seconds;
    # must match what the Part-d model was trained with
    text_context_s: float = 0.0
    chunk_continuity: bool = False
    decode_overlap: int = 0
    soft_decode: float = 0.0
    temperature: float = 0.0
    top_k: int = 0
    stage0_temperature: float = -1.0
    beam_width: int = 0
    exemplar_continuity: bool = False
    device: Optional[Union[str, torch.device]] = None

    def __post_init__(self):
        self._setup_synthesis()

    @property
    def token_model(self) -> Union[Text2Token, TransformerText2Token]:
        return self.t2t_model

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

    def _predict_windows(self, word_ids: torch.Tensor, lengths: torch.Tensor,
                         gumbel: Optional[torch.Tensor] = None,
                         seed: Optional[torch.Tensor] = None
                         ) -> Dict[str, torch.Tensor]:
        """word_ids (B, W, S), lengths (B, W) for B transcripts of W
        windows -> "tokens" (B, W * n_steps); with residual stages
        "stage" (B, W * n_steps, S-1), -1 at each window's seed step; with
        soft_decode the mixtures "probs" (B, W * n_steps, K) and
        "stage_probs" (B, W * n_steps, S-1, K). Every window of every
        transcript is encoded in one batch. window_carry decodes window w
        of all transcripts as one batch, each row with its own mask and
        carried seed, and gives each row's seed for a next window as
        "next_seed" (B, n_steps); otherwise all windows decode at once,
        each with its transcript's batch-max mask or (per_sentence_mask)
        its own. seed (B, n_steps), the teacher seed of each row's first
        window (zeros when None), takes the carried decode whatever
        window_carry says: a streamed window continues its transcript."""
        t2t, n_steps = self.t2t_model, self.n_steps
        B, W, S = word_ids.shape
        with annotate("gen.encode"):
            enc_outs, dec_hidden = t2t.encode_text(
                word_ids.reshape(B * W, S), lengths.reshape(B * W))
        positions = torch.arange(S, device=self.device)
        next_seed = None
        with annotate("gen.token_loop"):
            if not self.window_carry and seed is None:
                longest = (lengths if t2t.per_sentence_mask else
                           lengths.max(dim=1, keepdim=True).values
                           .expand(B, W))
                mask = positions[None, :] < longest.reshape(B * W, 1)
                seed = torch.zeros((B * W, n_steps), dtype=torch.long,
                                   device=self.device)
                self._count_positions(B * W)
                res = self._decode_windows(
                    enc_outs, dec_hidden, seed, mask,
                    None if gumbel is None else gumbel.flatten(0, 1))
                res = {k: v.reshape(B, W, *v.shape[1:])
                       for k, v in res.items() if k in _PER_WINDOW}
            else:
                res, next_seed = self._decode_carried(
                    enc_outs.reshape(S, B, W, -1),
                    dec_hidden.reshape(dec_hidden.shape[0], B, W, -1), seed,
                    positions < lengths[:, :, None], gumbel)
        out = self._token_outputs(res)
        if next_seed is not None:
            out["next_seed"] = next_seed
        return out

    def _windows(self, transcripts: Sequence[List[List]],
                 durations_s: Sequence[float]
                 ) -> Tuple[torch.Tensor, torch.Tensor, List[int]]:
        """(word_ids (B, W, max_words), lengths (B, W)) on the device for
        the bucketed window count W of the longest transcript, and each
        transcript's real window count. Padded windows hold no words and
        generate throwaway frames."""
        with annotate("gen.windows"):
            unit = self.sentence_frame_length / self.fps
            wins = [max(int(np.ceil(d / unit)), 1) for d in durations_s]
            n_padded = bucket_windows(max(wins))
            word_ids = np.zeros((len(wins), n_padded, self.max_words),
                                np.int64)
            lengths = np.ones((len(wins), n_padded), np.int64)
            for b, words in enumerate(transcripts):
                for w in range(wins[b]):
                    word_ids[b, w], lengths[b, w] = self._window_word_ids(
                        words, w * unit, (w + 1) * unit)
            return (torch.from_numpy(word_ids).to(self.device),
                    torch.from_numpy(lengths).to(self.device), wins)

    def window_inputs(self, words: List[List], duration_s: float
                      ) -> Tuple[torch.Tensor, torch.Tensor, int]:
        """(word_ids (W, max_words), lengths (W,)) on the device for the
        bucketed window count W, and the real window count."""
        word_ids, lengths, wins = self._windows([words], [duration_s])
        return word_ids[0], lengths[0], wins[0]

    @torch.inference_mode()
    def generate(self, words: List[List], duration_s: float
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """words: [[word, start_s, end_s], ...]. Returns (motion
        (n_windows * sentence_frame_length, pose_dim) unnormalized,
        tokens (n_windows * n_steps,) int32)."""
        with annotate("gen.call"):
            word_ids, lengths, n_windows = self.window_inputs(words,
                                                              duration_s)
            generator = self._next_generator()
            pred = self._predict_windows(
                word_ids[None], lengths[None],
                self._noise(generator, (1, word_ids.shape[0])))
            n_tok = n_windows * self.n_steps
            with annotate("gen.tokens_to_host"):
                tokens = pred["tokens"][0, :n_tok].to(
                    torch.int32).cpu().numpy()
            if self.mode == "exemplar":
                frames = self._exemplar_decode(self._picks([tokens]))
            else:
                if self.chunk_continuity:
                    # a chunk depends only on the chunks before it: roll
                    # out the real ones alone
                    pred = {k: v[:, :n_tok] for k, v in pred.items()}
                latents = self._decode_chunks(pred)[0, : n_tok * self.n_frames]
                with annotate("gen.dae"):
                    frames = self.dae_model.decode(latents)
                count("gen.chunks_real", n_tok)
            motion = self._frames(frames)
            count("gen.frames_returned", len(motion))
            return motion, tokens

    @torch.inference_mode()
    def generate_batch(self, transcripts: List[List[List]], durations_s,
                       mesh=None) -> List[Tuple[np.ndarray, np.ndarray]]:
        """Many transcripts as one batch: transcripts pad to a common
        window bucket; durations_s is one float or one per transcript.
        Returns one (motion, tokens) per transcript, as generate gives.
        mesh (`parallel/mesh.make_mesh` with a "dp" axis) splits the
        transcripts over dp, the batch padded to a multiple of it with
        empty transcripts (as the JAX package pads), over the mesh's
        ranks (a plain process runs them whole: `parallel/mesh`). The
        transcripts are independent, so each row's answer is the
        unsharded call's."""
        with annotate("gen.call"):
            B = len(transcripts)
            if not isinstance(durations_s, (list, tuple, np.ndarray)):
                durations_s = [durations_s] * B
            if len(durations_s) != B:
                raise ValueError(f"{len(durations_s)} durations for {B} "
                                 f"transcripts")
            word_ids, lengths, wins = self._windows(transcripts, durations_s)
            generator = self._next_generator()
            noise = self._noise(generator, tuple(word_ids.shape[:2]))
            rows = [word_ids, lengths] + ([] if noise is None else [noise])

            def run(word_ids, lengths, noise=None):
                pred = self._predict_windows(word_ids, lengths, noise)
                if self.mode == "exemplar":
                    return (pred["tokens"],)
                latents = self._decode_chunks(pred)
                with annotate("gen.dae"):
                    frames = self.dae_model.decode(latents.flatten(0, 1))
                return pred["tokens"], frames.reshape(*latents.shape[:2], -1)

            if mesh is None:
                out = run(*rows)
            else:
                pad = (-B) % mesh.row_split("dp")
                rows = [torch.cat([r, torch.full((pad,) + r.shape[1:],
                                                 int(i == 1), dtype=r.dtype,
                                                 device=r.device)])
                        for i, r in enumerate(rows)]   # lengths pad with 1
                out = [o[:B] for o in mesh.map_rows(run, rows, "dp")]
            with annotate("gen.tokens_to_host"):
                tokens_all = out[0].to(torch.int32).cpu().numpy()
            per = [tokens_all[b, : wins[b] * self.n_steps] for b in range(B)]
            lens = [len(t) * self.n_frames for t in per]
            if self.mode == "exemplar":
                frames = self._frames(self._exemplar_decode(self._picks(per)))
            else:
                count("gen.chunks_real", sum(len(t) for t in per))
                frames = self._frames(out[1], lens)
            count("gen.frames_returned", len(frames))
            bounds = np.cumsum([0] + lens)
            return [(frames[bounds[b]: bounds[b + 1]], per[b])
                    for b in range(B)]
