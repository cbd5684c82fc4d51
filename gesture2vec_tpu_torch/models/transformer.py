"""Part d, transformer variant - text to gesture-token translation.

Port of the JAX package's `models/transformer.py`: a pre-LN transformer
encoder over the words (`_TextEncoder`: embedding table -> embed_proj ->
sinusoidal positions -> blocks -> final_ln -> masked mean-pool) and a
causal decoder over the gesture tokens with cross-attention to the words
(`_TokenDecoder`), behind the `Text2Token` API the generator calls
(`TransformerText2Token`: encode_text, decode_tokens, beam_decode,
forward).

At inference the decoder re-runs over the whole (B, n_steps - 1) token
buffer for each token it emits and reads position t - 1, as the JAX
package does (no KV cache at n_steps = 6). Position j of the buffer holds
the teacher token while j < n_pre = max(1, min(n_pre_poses, n_steps)),
so the seed is always in it, and the token chosen at step j after. The
choices (greedy, sampled on given Gumbel noise, the residual-stage heads
and their chain) are `models/text2token.choose_step`'s, on the decoder
output at position t - 1; beam search keeps K buffers on the batch axis.

Training mode (`.train()`) is the JAX package's train=True: the decoder
runs once over the teacher tokens in parallel (position j reads
target_tokens[:, j] and predicts step j + 1; with stage_conditional the
stage chain reads the teacher codes stage_targets[:, 1:]), and dropout
(masks drawn inside `models/layers.dropout_generator`) acts where JAX
puts it: after the word embeddings + positions, after the token
embeddings + positions, and on the three residual branches of each
block. The eval-mode rollout stays differentiable, so the
feedback-matched finetune trains through it.

Kept from flax: LayerNorm epsilon 1e-6, the tanh approximation of GELU,
and masked attention scores set to -1e30 (a fully masked row attends
uniformly instead of giving NaN). Scores and softmax are fp32 matmuls, as
the JAX einsums are.

compute_dtype=torch.bfloat16 (the JAX package's compute_dtype: bfloat16)
puts every Dense, LayerNorm (fp32 statistics), the token embeddings and
the residual stream in bf16, as flax's modules with dtype=bfloat16 do;
the attention scores and softmax stay fp32 (the weights cast to bf16
before they weigh v), and the encoder's output, the logits and the
attention maps come out in fp32.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gesture2vec_tpu_torch.models.layers import (Dense, Dtype, Embedding,
                                                 LayerNorm, dropout)
from gesture2vec_tpu_torch.models.text2token import (check_noise, choose_step,
                                                     stage_chain,
                                                     stage_logits)

# flax's LayerNorm epsilon (torch's default is 1e-5)
LN_EPS = 1e-6
# the JAX package's fill for masked scores
MASKED = -1e30


def sinusoidal_positions(length: int, dim: int) -> np.ndarray:
    """Standard fixed sinusoidal position table (length, dim), fp32."""
    pos = np.arange(length, dtype=np.float32)[:, None]
    i = np.arange(dim, dtype=np.float32)[None, :]
    angle = pos / np.power(10000.0, (2.0 * (i // 2)) / dim)
    table = np.where(i % 2 == 0, np.sin(angle), np.cos(angle))
    return table.astype(np.float32)


@functools.lru_cache(maxsize=None)
def position_table(length: int, dim: int,
                   device: torch.device) -> torch.Tensor:
    """The position table on the device, made once per shape (a normal
    tensor even when first asked for under inference_mode)."""
    with torch.inference_mode(False):
        return torch.from_numpy(sinusoidal_positions(length, dim)).to(device)


@functools.lru_cache(maxsize=None)
def _causal(length: int, device: torch.device) -> torch.Tensor:
    """(1, 1, T, T) lower-triangular attend mask."""
    with torch.inference_mode(False):
        return torch.ones((length, length), dtype=torch.bool,
                          device=device).tril()[None, None]


class MHA(nn.Module):
    """Multi-head attention that also returns its head-averaged weights
    (fp32)."""

    def __init__(self, hidden_size: int, n_heads: int, dtype: Dtype = None):
        super().__init__()
        if hidden_size % n_heads:
            raise ValueError(f"{n_heads} heads do not divide hidden size "
                             f"{hidden_size}")
        self.n_heads = n_heads
        self.q = Dense(hidden_size, hidden_size, compute_dtype=dtype)
        self.k = Dense(hidden_size, hidden_size, compute_dtype=dtype)
        self.v = Dense(hidden_size, hidden_size, compute_dtype=dtype)
        self.o = Dense(hidden_size, hidden_size, compute_dtype=dtype)

    def forward(self, q_in: torch.Tensor, kv_in: torch.Tensor,
                mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """q_in (B, Tq, H), kv_in (B, Tk, H), mask broadcastable to
        (B, 1, Tq, Tk) (True = attend) -> (out (B, Tq, H), weights
        (B, Tq, Tk))."""
        B, Tq, H = q_in.shape
        hd = H // self.n_heads

        def split(x):  # (B, T, H) -> (B, nh, T, hd)
            return x.reshape(x.shape[0], x.shape[1], self.n_heads,
                             hd).transpose(1, 2)

        q, k, v = split(self.q(q_in)), split(self.k(kv_in)), \
            split(self.v(kv_in))
        # fp32 scores (JAX: preferred_element_type=float32)
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) \
            / math.sqrt(hd)
        if mask is not None:
            scores = scores.masked_fill(~mask, MASKED)
        w = torch.softmax(scores, dim=-1)
        out = torch.matmul(w.to(v.dtype), v).transpose(1, 2).reshape(B, Tq,
                                                                     H)
        return self.o(out), w.mean(dim=1)


class Block(nn.Module):
    """Pre-LN transformer block; cross-attention optional; in training,
    dropout on each residual branch."""

    def __init__(self, hidden_size: int, n_heads: int, cross: bool = False,
                 dropout_rate: float = 0.0, dtype: Dtype = None):
        super().__init__()
        self.dropout_rate = dropout_rate

        def ln():
            return LayerNorm(hidden_size, eps=LN_EPS, compute_dtype=dtype)

        self.ln_self = ln()
        self.self_attn = MHA(hidden_size, n_heads, dtype)
        self.cross = cross
        if cross:
            self.ln_cross = ln()
            self.cross_attn = MHA(hidden_size, n_heads, dtype)
        self.ln_mlp = ln()
        self.mlp_in = Dense(hidden_size, 4 * hidden_size, compute_dtype=dtype)
        self.mlp_out = Dense(4 * hidden_size, hidden_size,
                             compute_dtype=dtype)

    def forward(self, x: torch.Tensor, self_mask: Optional[torch.Tensor],
                enc: Optional[torch.Tensor] = None,
                enc_mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """x (B, T, H) -> (x (B, T, H), cross-attention weights (B, T, S)
        or None)."""
        def drop(y):
            return dropout(y, self.dropout_rate, self.training)

        h = self.ln_self(x)
        x = x + drop(self.self_attn(h, h, self_mask)[0])
        cross_w = None
        if self.cross:
            a, cross_w = self.cross_attn(self.ln_cross(x), enc, enc_mask)
            x = x + drop(a)
        h = F.gelu(self.mlp_in(self.ln_mlp(x)), approximate="tanh")
        return x + drop(self.mlp_out(h)), cross_w


def add_blocks(module: nn.Module, n_layers: int, *args, **kw) -> None:
    """`layer_{i}` blocks, the JAX package's names."""
    for i in range(n_layers):
        setattr(module, f"layer_{i}", Block(*args, **kw))


class _TextEncoder(nn.Module):
    """Word ids -> contextual embeddings + masked mean-pool."""

    def __init__(self, n_words: int, word_embed_size: int, hidden_size: int,
                 n_layers: int, n_heads: int, dropout_rate: float = 0.0,
                 dtype: Dtype = None):
        super().__init__()
        self.n_layers = n_layers
        self.dropout_rate = dropout_rate
        self.embedding_table = Embedding(n_words, word_embed_size)
        self.embed_proj = Dense(word_embed_size, hidden_size,
                                compute_dtype=dtype)
        add_blocks(self, n_layers, hidden_size, n_heads,
                   dropout_rate=dropout_rate, dtype=dtype)
        self.final_ln = LayerNorm(hidden_size, eps=LN_EPS,
                                  compute_dtype=dtype)

    def forward(self, tokens: torch.Tensor, lengths: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, S) ids, (B,) lengths -> (enc (B, S, H), pooled (B, H)),
        fp32."""
        S = tokens.shape[1]
        x = self.embed_proj(self.embedding_table(tokens))
        x = dropout(x + position_table(S, x.shape[-1], x.device).to(x.dtype),
                    self.dropout_rate, self.training)
        valid = torch.arange(S, device=tokens.device)[None, :] \
            < lengths[:, None]                                 # (B, S)
        mask = valid[:, None, None, :]
        for i in range(self.n_layers):
            x, _ = getattr(self, f"layer_{i}")(x, mask)
        x = self.final_ln(x).float()
        denom = lengths[:, None].to(x.dtype).clamp_min(1.0)
        return x, (x * valid[:, :, None]).sum(dim=1) / denom


class _TokenDecoder(nn.Module):
    """Causal token decoder with cross-attention, parallel form, and the
    residual-stage heads (`out_layer_r{s}`; with stage_conditional the
    chain's `stage_embed_{s}` tables too)."""

    def __init__(self, n_tokens: int, hidden_size: int, n_layers: int,
                 n_heads: int, n_stage_heads: int = 0,
                 stage_conditional: bool = False, dropout_rate: float = 0.0,
                 dtype: Dtype = None):
        super().__init__()
        self.n_layers = n_layers
        self.dropout_rate = dropout_rate
        self.n_stage_heads = n_stage_heads
        self.stage_conditional = stage_conditional and n_stage_heads > 0
        self.token_embedding = Embedding(n_tokens, hidden_size,
                                         compute_dtype=dtype)
        add_blocks(self, n_layers, hidden_size, n_heads, cross=True,
                   dropout_rate=dropout_rate, dtype=dtype)
        self.final_ln = LayerNorm(hidden_size, eps=LN_EPS,
                                  compute_dtype=dtype)
        self.out_layer = Dense(hidden_size, n_tokens, compute_dtype=dtype)
        for s in range(n_stage_heads):
            setattr(self, f"out_layer_r{s + 1}",
                    Dense(hidden_size, n_tokens, compute_dtype=dtype))
            if self.stage_conditional:
                setattr(self, f"stage_embed_{s}",
                        Embedding(n_tokens, hidden_size, compute_dtype=dtype))

    def forward(self, buf: torch.Tensor, enc: torch.Tensor,
                enc_mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """buf (B, T) token ids, enc (B, S, H), enc_mask (S,) or (B, S) ->
        (logits (B, T, K) where position j predicts step j + 1, the last
        layer's cross-attention weights (B, T, S), the decoder output
        (B, T, H) that the stage heads read); logits and weights fp32."""
        T = buf.shape[1]
        emb = self.token_embedding(buf)
        x = dropout(emb + position_table(T, emb.shape[-1],
                                         buf.device).to(emb.dtype),
                    self.dropout_rate, self.training)
        causal = _causal(T, x.device)
        em = None
        if enc_mask is not None:
            em = enc_mask.reshape(-1, enc.shape[1])[:, None, None, :]
        cross_w = None
        for i in range(self.n_layers):
            x, cross_w = getattr(self, f"layer_{i}")(x, causal, enc, em)
        x = self.final_ln(x)
        return self.out_layer(x).float(), cross_w, x


class TransformerText2Token(nn.Module):
    """Sentence -> n_steps gesture tokens (and residual-stage codes),
    transformer encoder-decoder, with Text2Token's API; dropout_rate is
    the config's dropout_prob (training only)."""

    # cross-attention is structural (the field gates attention plots)
    use_attention = True
    # pad positions carry content through self-attention, so batched
    # windows each attend over their own sentence (a batch-max mask would
    # make a window's decode depend on its batch)
    per_sentence_mask = True

    def __init__(self, n_words: int, n_tokens: int, hidden_size: int,
                 n_layers: int, n_steps: int, n_pre_poses: int = 2,
                 word_embed_size: int = 300, n_heads: int = 4,
                 token_stages: int = 1, stage_conditional: bool = False,
                 dropout_rate: float = 0.2, compute_dtype: Dtype = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.n_tokens = n_tokens
        self.n_layers = n_layers
        self.n_steps = n_steps
        self.n_pre_poses = n_pre_poses
        self.n_heads = n_heads
        self.token_stages = token_stages
        self.stage_conditional = stage_conditional and token_stages > 1
        self.encoder = _TextEncoder(n_words, word_embed_size, hidden_size,
                                    n_layers, n_heads, dropout_rate,
                                    compute_dtype)
        self.decoder = _TokenDecoder(n_tokens, hidden_size, n_layers,
                                     n_heads, n_stage_heads=token_stages - 1,
                                     stage_conditional=stage_conditional,
                                     dropout_rate=dropout_rate,
                                     dtype=compute_dtype)

    @property
    def n_pre(self) -> int:
        """Teacher steps, clamped to >= 1 so that the seed token is always
        in the buffer (and <= n_steps); the last n_pre tokens of a window
        seed the next one (window_carry)."""
        return max(1, min(self.n_pre_poses, self.n_steps))

    @property
    def decode_positions(self) -> Tuple[int, int]:
        """(positions the decoder computes, positions the choices read) in
        one row of a window's eval decode: each of the n_steps - 1 steps
        re-runs the whole (n_steps - 1)-slot buffer and reads one slot."""
        steps = self.n_steps - 1
        return steps * steps, steps

    def set_use_kernels(self, on: bool) -> "TransformerText2Token":
        """No kernel runs on this model's path: nothing to route."""
        return self

    def encode_text(self, tokens: torch.Tensor, lengths: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, S) word ids -> (encoder outputs (S, B, H), the masked
        mean-pool tiled over the layers (L, B, H)). The decoder reads only
        the outputs; the pool keeps the GRU model's slot."""
        enc, pooled = self.encoder(tokens, lengths)
        return enc.transpose(0, 1), pooled[None].repeat(self.n_layers, 1, 1)

    def _buffer(self, target_tokens: torch.Tensor) -> torch.Tensor:
        """The (B, n_steps - 1) input buffer: teacher tokens at positions
        < n_pre, zeros after."""
        buf = torch.zeros_like(target_tokens[:, :self.n_steps - 1])
        n = min(self.n_pre, self.n_steps - 1)
        buf[:, :n] = target_tokens[:, :n]
        return buf

    def decode_tokens(self, enc_outs: torch.Tensor, dec_hidden: torch.Tensor,
                      target_tokens: torch.Tensor,
                      enc_mask: Optional[torch.Tensor] = None,
                      temperature: float = 0.0, top_k: int = 0,
                      stage0_temperature: float = -1.0,
                      gumbel: Optional[torch.Tensor] = None,
                      stage_targets: Optional[torch.Tensor] = None
                      ) -> Dict[str, torch.Tensor]:
        """The decode given a text encoding (dec_hidden is accepted for
        the API and unused): in eval mode the autoregressive rollout, in
        training mode the teacher-forced parallel pass (`_teacher_forced`).
        target_tokens (B, n_steps) is the teacher signal (column 0 the
        seed); enc_mask (S,) or (B, S); gumbel (B, n_steps - 1,
        token_stages, K) a sampled rollout's noise; stage_targets (B,
        n_steps, token_stages) the teacher codes a stage_conditional model
        trains on. Returns "logits" (B, n_steps, K), "tokens" (B,
        n_steps), "attentions" (n_steps - 1, B, S), and with residual
        stages "stage_logits" (B, n_steps - 1, S-1, K) and "stage_tokens"
        (B, n_steps - 1, S-1)."""
        if self.training:
            return self._teacher_forced(enc_outs, target_tokens, enc_mask,
                                        stage_targets)
        check_noise(self.token_stages, temperature, stage0_temperature,
                    gumbel)
        enc = enc_outs.transpose(0, 1)                         # (B, S, H)
        T, n_pre = self.n_steps, self.n_pre
        multi = self.token_stages > 1
        seed = target_tokens[:, 0]
        buf = self._buffer(target_tokens)
        logits = [F.one_hot(seed, self.n_tokens).to(enc.dtype)]
        tokens, attns, slgs, stoks = [seed], [], [], []
        for t in range(1, T):
            lg_all, cross_w, out = self.decoder(buf, enc, enc_mask)
            lg = lg_all[:, t - 1]
            best, slg, stok = choose_step(
                self.decoder, lg, out[:, t - 1], temperature, top_k,
                stage0_temperature,
                None if gumbel is None else gumbel[:, t - 1])
            if n_pre <= t < T - 1:
                # a new buffer, not a write in place: under autograd (the
                # feedback finetune) each embedding keeps its ids for the
                # backward
                buf = buf.clone()
                buf[:, t] = best
            logits.append(lg)
            tokens.append(best)
            attns.append(cross_w[:, t - 1])
            if multi:
                slgs.append(slg)
                stoks.append(stok)
        res = {"logits": torch.stack(logits, dim=1),
               "tokens": torch.stack(tokens, dim=1),
               "attentions": torch.stack(attns)}
        if multi:
            res["stage_logits"] = torch.stack(slgs, dim=1)
            res["stage_tokens"] = torch.stack(stoks, dim=1)
        return res

    def _teacher_forced(self, enc_outs: torch.Tensor,
                        target_tokens: torch.Tensor,
                        enc_mask: Optional[torch.Tensor],
                        stage_targets: Optional[torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
        """The training pass (the JAX decode_tokens with train=True): one
        decoder pass over target_tokens[:, :n_steps - 1], position j
        predicting step j + 1, its logits after the seed's one-hot; the
        stage chain reads the teacher codes of steps 1.. . Tokens and
        stage tokens are the argmaxes."""
        if self.stage_conditional and stage_targets is None:
            raise ValueError("stage_conditional training needs stage_targets "
                             "(B, n_steps, token_stages)")
        seed = target_tokens[:, 0]
        lg_all, cross_w, out = self.decoder(
            target_tokens[:, :self.n_steps - 1], enc_outs.transpose(0, 1),
            enc_mask)
        res = {"logits": torch.cat([F.one_hot(seed, self.n_tokens).to(
                   lg_all.dtype)[:, None], lg_all], dim=1),
               "tokens": torch.cat([seed[:, None], lg_all.argmax(dim=-1)],
                                   dim=1),
               "attentions": cross_w.transpose(0, 1)}
        if self.token_stages > 1:
            if self.stage_conditional:
                st = stage_targets[:, 1:]
                slg, _ = stage_chain(self.decoder, out, st[..., 0],
                                     lambda _, s: st[..., s + 1])
            else:
                slg = stage_logits(self.decoder, out)
            res["stage_logits"] = slg
            res["stage_tokens"] = slg.argmax(dim=-1)
        return res

    def beam_decode(self, enc_outs: torch.Tensor, dec_hidden: torch.Tensor,
                    target_tokens: torch.Tensor, beam_width: int = 4,
                    enc_mask: Optional[torch.Tensor] = None
                    ) -> Dict[str, torch.Tensor]:
        """Beam search, as Text2Token.beam_decode (the same contract,
        outputs and lower-index tie order), with each hypothesis's token
        buffer in place of a recurrent hidden: the K buffers of a row ride
        the batch axis and are re-decoded in parallel each step."""
        K, V, T = int(beam_width), self.n_tokens, self.n_steps
        B = target_tokens.shape[0]
        S1, n_pre = self.token_stages - 1, self.n_pre
        enc = enc_outs.transpose(0, 1)
        dev = enc.device
        rows = torch.arange(B, device=dev)[:, None]
        encK = enc.repeat_interleave(K, dim=0)                 # (B*K, S, H)
        maskK = None
        if enc_mask is not None:
            maskK = enc_mask.reshape(-1, enc.shape[1]).expand(
                B, -1).repeat_interleave(K, dim=0)
        seed = target_tokens[:, 0]
        bufK = self._buffer(target_tokens).repeat_interleave(K, dim=0)
        logprob = torch.full((B, K), float("-inf"), device=dev)
        logprob[:, 0] = 0.0
        seqs = torch.zeros((B, K, T), dtype=seed.dtype, device=dev)
        seqs[:, :, 0] = seed[:, None]
        stages = torch.zeros((B, K, T, max(S1, 1)), dtype=seed.dtype,
                             device=dev)
        step_scores = []
        for t in range(1, T):
            lg_all, _, out = self.decoder(bufK, encK, maskK)
            logits = lg_all[:, t - 1]
            logp = torch.log_softmax(logits, dim=-1).reshape(B, K, V)
            scores = (logprob[:, :, None] + logp).reshape(B, K * V)
            order = torch.sort(scores, dim=-1, descending=True, stable=True)
            logprob, top_idx = order.values[:, :K], order.indices[:, :K]
            step_scores.append(order.values[:, :K + 1])
            parent, new_tok = top_idx // V, top_idx % V
            buf = bufK.reshape(B, K, T - 1)[rows, parent]
            if n_pre <= t < T - 1:
                buf[:, :, t] = new_tok
            bufK = buf.reshape(B * K, T - 1)
            seqs = seqs[rows, parent]
            seqs[:, :, t] = new_tok
            if S1:
                _, _, st = choose_step(self.decoder, logits, out[:, t - 1],
                                       0.0, 0, -1.0, None)
                stages = stages[rows, parent]
                stages[:, :, t] = st.reshape(B, K, S1)[rows, parent]
        best = torch.argmax(logprob, dim=1)
        b = torch.arange(B, device=dev)
        res = {"tokens": seqs[b, best], "logprob": logprob[b, best],
               "step_scores": torch.stack(step_scores, dim=1)}
        if S1:
            res["stage_tokens"] = stages[b, best][:, 1:, :]
        return res

    def forward(self, tokens: torch.Tensor, lengths: torch.Tensor,
                target_tokens: torch.Tensor, **decode_kw
                ) -> Dict[str, torch.Tensor]:
        """Encode + decode, each sentence attending over its own words.
        decode_kw as in decode_tokens."""
        enc_outs, dec_hidden = self.encode_text(tokens, lengths)
        enc_mask = (torch.arange(tokens.shape[1], device=tokens.device)[
            None, :] < lengths[:, None])
        return self.decode_tokens(enc_outs, dec_hidden, target_tokens,
                                  enc_mask=enc_mask, **decode_kw)
