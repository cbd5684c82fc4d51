"""Part d - text to gesture-token translation.

Port of the JAX package's `models/text2token.py`: a text encoder (the
TCN, or the masked biGRU with its two directions summed), then an
autoregressive decoder step (token embedding -> Bahdanau attention ->
pre_linear -> BatchNorm -> ReLU -> GRU stack -> logits, plus one logit
head per residual stage when token_stages > 1) for n_steps - 1 steps.

Step 0 is the seed: its logits are the seed's one-hot and its token is
the seed. The input at step t is the teacher token while
t - 1 < n_pre_poses, else the previous step's choice. A choice is
  greedy   the argmax (ties go to the first index, as in jnp.argmax);
  sampled  `sample_logits`: logits / temperature, every logit below the
           top_k-th set to -inf, then the categorical as Gumbel-max,
           argmax(logits + g) - what jax.random.categorical computes. The
           noise g is an input (B, n_steps - 1, token_stages, K): [..., 0,
           :] for the primary token, [..., s, :] for stage s. The generator
           draws it on the host from a seeded torch.Generator, so the card
           and the CPU sample alike, and a test can feed both packages the
           same draws;
  beam     `Text2Token.beam_decode`: K hypotheses on the batch axis.
stage0_temperature >= 0 overrides the primary token's temperature only.
Residual-stage heads (`out_layer_r{s}`) read the decoder output; with
stage_conditional they form the JAX package's `stage_chain`: head s also
reads embeddings (`stage_embed_{s}`) of the codes chosen before it.

Training mode (`.train()`, masks drawn inside
`models/layers.dropout_generator`) is the JAX package's train=True: the
TCN's dropouts (0.1 on the embeddings, 0.3 in each block) or dropout
between the GRU encoder's layers, the decoder's dropout 0.5 on the token
embedding and between its GRU layers, and BatchNorm on batch statistics
(`models/layers.BatchNorm`). The decode is the same loop (teacher tokens
while t - 1 < n_pre_poses, then the argmax); with stage_conditional the
chain reads the step's teacher codes (`stage_targets`).

compute_dtype=torch.bfloat16 mirrors the JAX package's bf16 mode at its
cast sites: the TCN (`models/tcn`) or the masked BiGRU (the bf16 GRU
kernel) in bf16, their outputs and hidden cast back to fp32; the decoder
step's pre_linear, BatchNorm (fp32 statistics), GRU cells, out_layer and
stage heads in bf16, the logits cast to fp32; the token embedding and the
attention fp32; the decoder's hidden cast to bf16 before the decode and
carried in bf16.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from gesture2vec_tpu_torch.models.gru import GRUCellStack, MaskedBiGRU
from gesture2vec_tpu_torch.models.layers import (BatchNorm, Dense, Dtype,
                                                 Embedding, batch_max,
                                                 dropout)
from gesture2vec_tpu_torch.models.seq_ae import Attn
from gesture2vec_tpu_torch.models.tcn import TextEncoderTCN


def decision_scores(logits: torch.Tensor, temperature: float, top_k: int,
                    gumbel: Optional[torch.Tensor]) -> torch.Tensor:
    """The scores whose argmax is the choice: the logits themselves at
    temperature 0 (greedy), else logits / temperature with every logit
    below the top_k-th largest set to -inf (those equal to it stay, as
    with lax.top_k and `<`), plus the Gumbel noise."""
    if temperature <= 0.0:
        return logits
    lg = logits / temperature
    if top_k and top_k < lg.shape[-1]:
        kth = torch.topk(lg, top_k, dim=-1).values[..., -1:]
        lg = lg.masked_fill(lg < kth, float("-inf"))
    return lg + gumbel


def sample_logits(logits: torch.Tensor, temperature: float, top_k: int,
                  gumbel: torch.Tensor) -> torch.Tensor:
    """A categorical draw from softmax(logits / temperature), truncated to
    the top_k logits first (0 keeps them all; 1 is the argmax)."""
    return torch.argmax(decision_scores(logits, temperature, top_k, gumbel),
                        dim=-1)


def gumbel_noise(shape, generator: torch.Generator) -> torch.Tensor:
    """Standard Gumbel draws on the generator's device, -log(-log(u)) with
    u uniform in [tiny, 1), as jax.random.gumbel draws them."""
    u = torch.rand(shape, generator=generator, dtype=torch.float32,
                   device=generator.device)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def stage_logits(heads: nn.Module, out: torch.Tensor) -> torch.Tensor:
    """Independent residual-stage heads `out_layer_r{s}` of `heads` (a
    module with `n_stage_heads` of them): (..., H) -> (..., S-1, K), fp32
    whatever the compute dtype."""
    return torch.stack([getattr(heads, f"out_layer_r{s + 1}")(out).float()
                        for s in range(heads.n_stage_heads)], dim=-2)


def stage_chain(heads: nn.Module, out: torch.Tensor, first: torch.Tensor,
                choose: Callable[[torch.Tensor, int], torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Conditional heads (the JAX package's `stage_chain`), over any
    leading shape: h_0 = out, h_{s+1} = h_s + E_s(c_s), logits of stage
    s+1 = W_{s+1} h_{s+1}; c_0 = first (the primary choice), c_{s+1} =
    choose(logits, s). `heads` holds `stage_embed_{s}` and
    `out_layer_r{s+1}`. Returns (stage logits (..., S-1, K), stage
    choices (..., S-1))."""
    h, prev = out, first
    logits, chosen = [], []
    for s in range(heads.n_stage_heads):
        h = h + getattr(heads, f"stage_embed_{s}")(prev)
        lg = getattr(heads, f"out_layer_r{s + 1}")(h).float()
        prev = choose(lg, s)
        logits.append(lg)
        chosen.append(prev)
    return torch.stack(logits, dim=-2), torch.stack(chosen, dim=-1)


def choose_step(heads: nn.Module, logits: torch.Tensor, out: torch.Tensor,
                temperature: float, top_k: int, stage0_temperature: float,
                gumbel: Optional[torch.Tensor]
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                           Optional[torch.Tensor]]:
    """One decode step's choices from its logits (..., K) and the decoder
    output (..., H) the stage heads of `heads` read: (primary choice,
    stage logits (..., S-1, K), stage choices (..., S-1)), the stage
    entries None without residual stages. gumbel (..., token_stages, K)
    is the step's noise ([..., 0, :] the primary token's)."""
    t0 = temperature if stage0_temperature < 0.0 else stage0_temperature

    def noise(s):
        return None if gumbel is None else gumbel[..., s, :]

    best = sample_logits(logits, t0, top_k, noise(0))
    if not heads.n_stage_heads:
        return best, None, None
    if heads.stage_conditional:
        slg, stok = stage_chain(heads, out, best, lambda lg, s: sample_logits(
            lg, temperature, top_k, noise(1 + s)))
    else:
        slg = stage_logits(heads, out)
        stok = sample_logits(slg, temperature, top_k, noise(slice(1, None)))
    return best, slg, stok


def check_noise(token_stages: int, temperature: float,
                stage0_temperature: float,
                gumbel: Optional[torch.Tensor]) -> None:
    """A sampled decode (a positive primary or, with residual stages,
    stage temperature) must be given its noise."""
    t0 = temperature if stage0_temperature < 0.0 else stage0_temperature
    sampled = t0 > 0.0 or (token_stages > 1 and temperature > 0.0)
    if sampled and gumbel is None:
        raise ValueError("a sampled decode needs its Gumbel noise "
                         "(B, n_steps - 1, token_stages, K)")


class TextEncoderRNN(nn.Module):
    """Embedding -> masked biGRU, directions summed. Outputs (S, B, H);
    the hidden is (2 * layers, B, H) ordered [l0_fwd, l0_bwd, l1_fwd, ...],
    so the decoder-initial hidden (its first n_layers entries) is
    [l0_fwd, l0_bwd] at 2 layers: the reference's quirk, kept."""

    def __init__(self, n_words: int, embed_size: int, hidden_size: int,
                 n_layers: int, dropout_rate: float = 0.0,
                 dtype: Dtype = None):
        super().__init__()
        self.hidden_size = hidden_size
        self.embedding_table = Embedding(n_words, embed_size)
        self.gru = MaskedBiGRU(embed_size, hidden_size, n_layers,
                               dropout_rate, dtype=dtype)

    def forward(self, tokens: torch.Tensor, lengths: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(outputs (S, B, H), hidden (2L, B, H)), fp32."""
        emb = self.embedding_table(tokens).transpose(0, 1)   # (S, B, E)
        outs, hidden = self.gru(emb, lengths)
        H = self.hidden_size
        return (outs[..., :H] + outs[..., H:]).float(), hidden.float()


class TokenDecoderStep(nn.Module):
    """One decoder step over gesture tokens."""

    # the reference's dropout on the token embedding (training only)
    embedding_dropout = 0.5

    def __init__(self, hidden_size: int, n_tokens: int, n_layers: int,
                 use_attention: bool = True, n_stage_heads: int = 0,
                 stage_conditional: bool = False, dropout_rate: float = 0.0,
                 dtype: Dtype = None):
        super().__init__()
        self.dtype = dtype
        self.use_attention = use_attention
        self.n_stage_heads = n_stage_heads
        self.stage_conditional = stage_conditional and n_stage_heads > 0
        self.token_embedding = nn.Embedding(n_tokens, hidden_size)
        in_dim = 2 * hidden_size if use_attention else hidden_size
        self.attn = Attn(hidden_size) if use_attention else None
        self.pre_linear = Dense(in_dim, hidden_size, compute_dtype=dtype)
        self.pre_bn = BatchNorm(hidden_size, compute_dtype=dtype)
        self.gru = GRUCellStack(hidden_size, hidden_size, n_layers,
                                dropout_rate, dtype=dtype)
        self.out_layer = Dense(hidden_size, n_tokens, compute_dtype=dtype)
        for s in range(n_stage_heads):
            setattr(self, f"out_layer_r{s + 1}",
                    Dense(hidden_size, n_tokens, compute_dtype=dtype))
            if self.stage_conditional:
                setattr(self, f"stage_embed_{s}",
                        Embedding(n_tokens, hidden_size, compute_dtype=dtype))

    def step(self, token: torch.Tensor, hidden: torch.Tensor,
             encoder_outputs: torch.Tensor,
             enc_mask: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                        Optional[torch.Tensor]]:
        """(logits (B, K) fp32, new hidden (L, B, H), the GRU output
        (B, H) that the stage heads read, the attention weights (B, S),
        None without attention)."""
        x = dropout(self.token_embedding(token), self.embedding_dropout,
                    self.training)                             # (B, H)
        w = None
        if self.use_attention:
            # fp32 attention (the hidden may be carried in bf16)
            w = self.attn(hidden[-1].to(encoder_outputs.dtype),
                          encoder_outputs, mask=enc_mask)
            context = torch.einsum("bt,tbh->bh", w, encoder_outputs)
            x = torch.cat([x, context], dim=-1)
        h = torch.relu(self.pre_bn(self.pre_linear(x)))
        out, new_hidden = self.gru(h, hidden)
        return self.out_layer(out).float(), new_hidden, out, w

    def forward(self, token: torch.Tensor, hidden: torch.Tensor,
                encoder_outputs: torch.Tensor,
                enc_mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(logits (B, K) fp32, new hidden (L, B, H))."""
        logits, new_hidden, _, _ = self.step(token, hidden,
                                             encoder_outputs, enc_mask)
        return logits, new_hidden


def decode_tokens_impl(model: nn.Module, enc_outs: torch.Tensor,
                       dec_hidden: torch.Tensor, target_tokens: torch.Tensor,
                       enc_mask: Optional[torch.Tensor] = None,
                       temperature: float = 0.0, top_k: int = 0,
                       stage0_temperature: float = -1.0,
                       gumbel: Optional[torch.Tensor] = None,
                       stage_targets: Optional[torch.Tensor] = None
                       ) -> Dict[str, torch.Tensor]:
    """The autoregressive decode of a token model (Text2Token, or
    models/audio2token.Audio2Token: its n_tokens, n_steps, n_pre_poses,
    token_stages, stage_conditional and decoder_step) given its encoding.
    target_tokens (B, n_steps) is the teacher signal (column 0 the seed);
    enc_mask (S,) or (B, S), None attends to every position. Returns "logits" (B, n_steps, K), "tokens"
    (B, n_steps), with attention "attentions" (n_steps - 1, B, S), and
    with residual stages "stage_logits" (B, n_steps - 1, S-1, K) and
    "stage_tokens" (B, n_steps - 1, S-1).
    stage_targets (B, n_steps, token_stages), column 0 the primary
    code, drives the stage chain of a stage_conditional model in
    training (its teacher codes); training such a model needs it."""
    check_noise(model.token_stages, temperature, stage0_temperature,
                gumbel)
    if model.stage_conditional and model.training \
            and stage_targets is None:
        raise ValueError("stage_conditional training needs "
                         "stage_targets (B, n_steps, token_stages)")
    teach = model.stage_conditional and stage_targets is not None
    multi = model.token_stages > 1
    step = model.decoder_step
    seed = target_tokens[:, 0]
    logits = [F.one_hot(seed, model.n_tokens).to(enc_outs.dtype)]
    tokens, stage_logits, stage_tokens, attns = [seed], [], [], []
    if step.dtype is not None:
        # the hidden carried in the compute dtype, as JAX's scan carries it
        dec_hidden = dec_hidden.to(step.dtype)
    prev, hidden = seed, dec_hidden
    for t in range(1, model.n_steps):
        token_in = (target_tokens[:, t - 1] if t - 1 < model.n_pre_poses
                    else prev)
        lg, hidden, out, w = step.step(token_in, hidden, enc_outs,
                                       enc_mask)
        if w is not None:
            attns.append(w)
        if teach:
            # the chain reads the teacher codes; the tokens reported
            # are the argmaxes, as in JAX
            st = stage_targets[:, t]
            prev = torch.argmax(lg, dim=-1)
            slg, _ = stage_chain(step, out, st[:, 0],
                                 lambda _, s: st[:, s + 1])
            stok = torch.argmax(slg, dim=-1)
        else:
            prev, slg, stok = choose_step(
                step, lg, out, temperature, top_k, stage0_temperature,
                None if gumbel is None else gumbel[:, t - 1])
        logits.append(lg)
        tokens.append(prev)
        if multi:
            stage_logits.append(slg)
            stage_tokens.append(stok)
    res = {"logits": torch.stack(logits, dim=1),
           "tokens": torch.stack(tokens, dim=1)}
    if attns:
        res["attentions"] = torch.stack(attns)
    if multi:
        res["stage_logits"] = torch.stack(stage_logits, dim=1)
        res["stage_tokens"] = torch.stack(stage_tokens, dim=1)
    return res


def beam_decode_impl(model: nn.Module, enc_outs: torch.Tensor,
                     dec_hidden: torch.Tensor, target_tokens: torch.Tensor,
                     beam_width: int = 4,
                     enc_mask: Optional[torch.Tensor] = None
                     ) -> Dict[str, torch.Tensor]:
    """Beam search over the decode of a token model (as in
    `decode_tokens_impl`; the JAX package's beam_decode_impl). The K hypotheses of a row ride the batch axis
    (row b's at b*K .. b*K + K-1); only hypothesis 0 is live at the
    start, so the first expansion picks the K best distinct
    continuations; the recombination keeps the K best of K*V scores,
    ties to the lower index as lax.top_k breaks them (a stable sort).
    Inputs at steps t - 1 < n_pre_poses are the teacher tokens. Stage
    ids are each hypothesis's own argmax choices (through the chain
    with stage_conditional, conditioned on its argmax primary); they
    never enter the score. Returns "tokens" (B, n_steps), "logprob"
    (B,), "step_scores" (B, n_steps - 1, K + 1), each step's K + 1
    best scores in descending order (the last step's first K are the
    final hypotheses' log-probabilities), and with residual stages
    "stage_tokens" (B, n_steps - 1, S-1)."""
    K = int(beam_width)
    V, L, T = model.n_tokens, model.n_layers, model.n_steps
    B = target_tokens.shape[0]
    S1 = model.token_stages - 1
    step = model.decoder_step
    dev = enc_outs.device
    rows = torch.arange(B, device=dev)[:, None]

    seed = target_tokens[:, 0]
    eo = enc_outs.repeat_interleave(K, dim=1)           # (S, B*K, H)
    hidden = dec_hidden.repeat_interleave(K, dim=1)     # (L, B*K, H)
    mask = (enc_mask.repeat_interleave(K, dim=0)
            if enc_mask is not None and enc_mask.dim() == 2
            else enc_mask)
    tokens = seed.repeat_interleave(K)
    logprob = torch.full((B, K), float("-inf"), device=dev)
    logprob[:, 0] = 0.0
    seqs = torch.zeros((B, K, T), dtype=seed.dtype, device=dev)
    seqs[:, :, 0] = seed[:, None]
    stages = torch.zeros((B, K, T, max(S1, 1)), dtype=seed.dtype,
                         device=dev)
    step_scores = []
    for t in range(1, T):
        token_in = (target_tokens[:, t - 1].repeat_interleave(K)
                    if t - 1 < model.n_pre_poses else tokens)
        logits, new_hidden, out, _ = step.step(token_in, hidden, eo, mask)
        logp = torch.log_softmax(logits, dim=-1).reshape(B, K, V)
        scores = (logprob[:, :, None] + logp).reshape(B, K * V)
        order = torch.sort(scores, dim=-1, descending=True, stable=True)
        logprob, top_idx = order.values[:, :K], order.indices[:, :K]
        step_scores.append(order.values[:, :K + 1])
        parent, new_tok = top_idx // V, top_idx % V
        hidden = new_hidden.reshape(L, B, K, -1)[:, rows, parent] \
            .reshape(L, B * K, -1)
        seqs = seqs[rows, parent]
        seqs[:, :, t] = new_tok
        if S1:
            _, _, st = choose_step(step, logits, out, 0.0, 0, -1.0, None)
            stages = stages[rows, parent]
            stages[:, :, t] = st.reshape(B, K, S1)[rows, parent]
        tokens = new_tok.reshape(-1)
    best = torch.argmax(logprob, dim=1)
    b = torch.arange(B, device=dev)
    res = {"tokens": seqs[b, best], "logprob": logprob[b, best],
           "step_scores": torch.stack(step_scores, dim=1)}
    if S1:
        res["stage_tokens"] = stages[b, best][:, 1:, :]
    return res


class Text2Token(nn.Module):
    """Sentence -> n_steps gesture tokens (and residual-stage codes)."""

    # batched windows attend up to the batch's longest sentence, as the
    # reference's packed sequences do (the JAX package's batch-max mask)
    per_sentence_mask = False

    def __init__(self, n_words: int, n_tokens: int, hidden_size: int,
                 n_layers: int, n_steps: int, n_pre_poses: int = 2,
                 word_embed_size: int = 300, encoder_type: str = "tcn",
                 use_attention: bool = True, token_stages: int = 1,
                 kernel_size: int = 2, stage_conditional: bool = False,
                 dropout_rate: float = 0.2, compute_dtype: Dtype = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.n_tokens = n_tokens
        self.n_layers = n_layers
        self.n_steps = n_steps
        self.n_pre_poses = n_pre_poses
        self.encoder_type = encoder_type
        self.token_stages = token_stages
        self.stage_conditional = stage_conditional and token_stages > 1
        if encoder_type == "tcn":
            # the JAX package builds its TCN with these rates, whatever
            # the config's dropout
            self.encoder = TextEncoderTCN(n_words, word_embed_size,
                                          hidden_size, n_layers, kernel_size,
                                          dropout_rate=0.3, emb_dropout=0.1,
                                          dtype=compute_dtype)
        elif encoder_type == "gru":
            self.encoder = TextEncoderRNN(n_words, word_embed_size,
                                          hidden_size, n_layers,
                                          dropout_rate, compute_dtype)
        else:
            raise ValueError(f"unknown encoder_type {encoder_type!r}")
        self.decoder_step = TokenDecoderStep(
            hidden_size, n_tokens, n_layers, use_attention,
            n_stage_heads=token_stages - 1,
            stage_conditional=stage_conditional, dropout_rate=dropout_rate,
            dtype=compute_dtype)

    @property
    def n_pre(self) -> int:
        """Teacher steps a window takes from its seed: the last n_pre
        tokens of a window seed the next one (window_carry)."""
        return self.n_pre_poses

    @property
    def use_attention(self) -> bool:
        return self.decoder_step.use_attention

    @property
    def decode_positions(self) -> Tuple[int, int]:
        """(positions the decoder computes, positions the choices read) in
        one row of a window's eval decode: one GRU step a token, each
        read."""
        return self.n_steps - 1, self.n_steps - 1

    def set_use_kernels(self, on: bool) -> "Text2Token":
        """Route the GRU text encoder's recurrences through the Hopper
        kernel (True, the default) or its plain version."""
        if self.encoder_type == "gru":
            self.encoder.gru.use_kernel = on
        return self

    def encode_text(self, tokens: torch.Tensor, lengths: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, S) word ids -> (encoder outputs (S, B, H), decoder-initial
        hidden (L, B, H))."""
        enc_outs, hidden = self.encoder(tokens, lengths)
        return enc_outs, hidden[: self.n_layers]

    def decode_tokens(self, enc_outs: torch.Tensor, dec_hidden: torch.Tensor,
                      target_tokens: torch.Tensor,
                      enc_mask: Optional[torch.Tensor] = None,
                      **decode_kw) -> Dict[str, torch.Tensor]:
        """The autoregressive decode given a text encoding
        (`decode_tokens_impl`); enc_mask (S,) or (B, S)."""
        return decode_tokens_impl(self, enc_outs, dec_hidden, target_tokens,
                                  enc_mask, **decode_kw)

    def beam_decode(self, enc_outs: torch.Tensor, dec_hidden: torch.Tensor,
                    target_tokens: torch.Tensor, beam_width: int = 4,
                    enc_mask: Optional[torch.Tensor] = None
                    ) -> Dict[str, torch.Tensor]:
        """Beam search over the decode (`beam_decode_impl`)."""
        return beam_decode_impl(self, enc_outs, dec_hidden, target_tokens,
                                beam_width, enc_mask)

    def forward(self, tokens: torch.Tensor, lengths: torch.Tensor,
                target_tokens: torch.Tensor, **decode_kw
                ) -> Dict[str, torch.Tensor]:
        """Encode + decode with the batch-max mask: attention only over
        positions < max(lengths), like the reference's packed-sequence
        trimming. decode_kw as in decode_tokens."""
        enc_outs, dec_hidden = self.encode_text(tokens, lengths)
        enc_mask = (torch.arange(tokens.shape[1], device=tokens.device)
                    < batch_max(lengths))
        return self.decode_tokens(enc_outs, dec_hidden, target_tokens,
                                  enc_mask=enc_mask, **decode_kw)
