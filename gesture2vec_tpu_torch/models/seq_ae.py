"""Part b - the sequence VQ autoencoder (the gesture tokenizer).

Port of the JAX package's `models/seq_ae.py`: Bahdanau attention
(shared with the text->token decoder), one decoder step (pre_linear ->
BatchNorm -> ReLU -> GRU stack -> out_layer), the generative rollout,
the teacher-forced `decode` and the token codebook (`SeqDecoder`); the
encoder (in_layer -> bidirectional GRU, directions summed) and the
quantizer (`SeqVQAutoencoder.encode` / `quantize` / `tokens_from_hidden`
/ `stage_tokens`), with `_flatten_hidden` in both `vq_flatten` modes.
With encoder_arch="transformer" (the JAX package's `seq_arch:
transformer`) the encoder is `models/seq_encoder.TransformerSeqEncoder`;
decoder and quantizer are the same, and it trains as the BiGRU does.
use_vq=False is the plain sequence autoencoder (no quantizer, no
tokens); use_vae adds the VAE heads (vae_mean, vae_std, vae_dec) over
the flattened (B, L*H) hidden after the quantizer, their sample the
decoder's initial hidden. Generation and the teacher sweeps read tokens
and hiddens from the codebook and the encoder, never through the VAE
heads, as in JAX.

The decoder-initial hidden is the encoder hidden sliced to its first
n_layers entries, which for the bidirectional GRU is [l0_fwd, l0_bwd]
at 2 layers: a reference quirk the JAX package keeps.

With use_attention (the JAX package's `autoencoder_att`) every decoder
step attends over the encoder outputs (T, B, H) from its last layer's
hidden and concatenates the context to its input, so pre_linear takes
D + H; such a decoder decodes only with the encoder outputs (`decode`,
`warmup_hidden`), never in the generative `rollout`, as in JAX.

Eval mode (`.eval()`) is the JAX package's eval: BatchNorm reads its
running statistics and no dropout is applied, except with
eval_step_dropout (a parity checkpoint's quirk, the JAX package's
`eval_step_dropout`): then the reference's 0.95 step dropout acts in the
eval `decode`, `rollout` and `warmup_hidden` too, its masks from the
caller's torch.Generator, by default one seeded 0 a call (the JAX
package feeds it PRNGKey(0); the masks are not its bits). Neither the
attention nor the eval dropout is in the chunk-decoder kernel
(`SeqDecoder.kernel_reason`). Training mode (`.train()`, masks drawn inside
`models/layers.dropout_generator`) is its train=True: dropout on the
encoder's input (either encoder), between the BiGRU's layers or at the
transformer encoder's sites, the reference's 0.95
dropout on the decoder's input at every step, dropout between the
decoder's GRU layers, and BatchNorm on batch statistics, updated once a
step (`models/layers.BatchNorm`).

compute_dtype=torch.bfloat16 is the JAX package's compute_dtype:
bfloat16, module by module at its cast sites: the BiGRU encoder (in_layer
and the recurrences in bf16, the summed outputs and the hidden bf16) or
the transformer encoder (its own sites; its hidden fp32); the quantizer
in fp32 on the fp32 hidden (token identity); the decoder step's
pre_linear, BatchNorm (fp32 statistics), GRU cells and out_layer in bf16,
its output cast to fp32; the decoder's hidden cast to bf16 before the
rollout and carried in bf16. The eval decode then runs the chunk-decoder
kernel's bf16 instantiation over weights folded in bf16. The VAE heads
and the attention stay fp32, as in JAX.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from gesture2vec_tpu_torch.models.gru import BiGRU, GRUCellStack
from gesture2vec_tpu_torch.models.layers import (BatchNorm, Dense, Dtype,
                                                 as_fp32, dropout,
                                                 dropout_generator,
                                                 reparameterize)
from gesture2vec_tpu_torch.models.vq import VQGSSoft, VQOutput, VQResidual


class Attn(nn.Module):
    """Bahdanau additive attention: hidden (B, H), encoder_outputs
    (T, B, H) -> weights (B, T). mask (T,) for every row, or (B, T) one
    per row, bool, marks VALID positions; the rest are -inf'd out of the
    softmax."""

    def __init__(self, hidden_size: int):
        super().__init__()
        self.attn = nn.Linear(2 * hidden_size, hidden_size)
        self.v = nn.Parameter(torch.zeros(hidden_size))

    def forward(self, hidden: torch.Tensor, encoder_outputs: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        T = encoder_outputs.shape[0]
        h = hidden.unsqueeze(0).expand(T, -1, -1)              # (T, B, H)
        energy = torch.tanh(self.attn(torch.cat([h, encoder_outputs],
                                                dim=-1)))
        scores = (energy @ self.v).t()                         # (B, T)
        if mask is not None:
            scores = scores.masked_fill(~(mask if mask.dim() == 2
                                          else mask[None, :]), float("-inf"))
        return torch.softmax(scores, dim=-1)


class DecoderStep(nn.Module):
    """One Part-b decoder timestep: [attention ->] pre_linear -> BatchNorm
    -> ReLU -> GRU stack -> out_layer. With use_attention the context of
    the encoder outputs, attended from the last layer's hidden, is
    concatenated to the input. conditioned=False zeroes that input, as the
    JAX module does; in training (or in eval with eval_step_dropout) it
    then takes the reference's step dropout, at step_dropout (0.95, the
    reference's; the baseline, c2g and GAN decoders pass 0). With a compute
    dtype every module but the attention (fp32, as in JAX) computes in it
    and the output comes back in fp32."""

    def __init__(self, input_size: int, hidden_size: int, n_layers: int,
                 conditioned: bool = True, dropout_rate: float = 0.0,
                 dtype: Dtype = None, use_attention: bool = False,
                 eval_step_dropout: bool = False,
                 step_dropout: float = 0.95):
        super().__init__()
        self.step_dropout = step_dropout
        self.conditioned = conditioned
        self.dtype = dtype
        self.use_attention = use_attention
        self.eval_step_dropout = eval_step_dropout
        self.attn = Attn(hidden_size) if use_attention else None
        self.pre_linear = Dense(
            input_size + (hidden_size if use_attention else 0), hidden_size,
            compute_dtype=dtype)
        self.pre_bn = BatchNorm(hidden_size, compute_dtype=dtype)
        self.gru = GRUCellStack(hidden_size, hidden_size, n_layers,
                                dropout_rate, dtype=dtype)
        self.out_layer = Dense(hidden_size, input_size, compute_dtype=dtype)

    def forward(self, x: torch.Tensor, hidden: torch.Tensor,
                encoder_outputs: Optional[torch.Tensor] = None,
                enc_mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """enc_mask (T,) bool marks the encoder positions the attention
        may read (`Attn`)."""
        if self.use_attention:
            if encoder_outputs is None:
                raise ValueError("the attention decoder step reads the "
                                 "encoder outputs (autoencoder_att)")
            enc = as_fp32(encoder_outputs)
            w = self.attn(as_fp32(hidden[-1]), enc, enc_mask)  # (B, T)
            x = torch.cat([x, torch.einsum("bt,tbh->bh", w, enc)], dim=-1)
        if not self.conditioned:
            x = torch.zeros_like(x)
        x = dropout(x, self.step_dropout,
                    self.training or self.eval_step_dropout)
        h = torch.relu(self.pre_bn(self.pre_linear(x)))
        out, new_hidden = self.gru(h, hidden)
        # losses and the fed-back frame read fp32 whatever the dtype
        return self.out_layer(out).float(), new_hidden


class SeqDecoder(nn.Module):
    """The token -> latent-chunk half of the gesture tokenizer: the
    codebook (n_codes, n_layers * H), for a residual-VQ tokenizer the
    later stages' codebooks `codebook_r{s}` (s = 1 .. stages - 1), and the
    decoder step (with attention over the encoder outputs under
    use_attention, and the step dropout in eval under
    eval_step_dropout)."""

    def __init__(self, rep_dim: int, hidden_size: int, n_layers: int,
                 n_frames: int, n_codes: int, n_pre_poses: int = 1,
                 conditioned: bool = True, stages: int = 1,
                 dropout_rate: float = 0.0, dtype: Dtype = None,
                 use_attention: bool = False,
                 eval_step_dropout: bool = False):
        super().__init__()
        self.use_kernel = True
        self.dtype = dtype
        self.rep_dim = rep_dim
        self.hidden_size = hidden_size
        self.n_layers = n_layers
        self.n_frames = n_frames
        self.n_pre_poses = n_pre_poses
        self.conditioned = conditioned
        self.stages = stages
        for s in range(stages):
            self.register_parameter(
                "codebook" if s == 0 else f"codebook_r{s}",
                nn.Parameter(torch.zeros(n_codes, n_layers * hidden_size)))
        self.decoder_step = DecoderStep(rep_dim, hidden_size, n_layers,
                                        conditioned, dropout_rate, dtype,
                                        use_attention, eval_step_dropout)

    @property
    def use_attention(self) -> bool:
        return self.decoder_step.use_attention

    @property
    def eval_step_dropout(self) -> bool:
        return self.decoder_step.eval_step_dropout

    def step_dropout_stream(self, generator: Optional[torch.Generator],
                            device: torch.device):
        """The context an eval decode runs in: under eval_step_dropout the
        step dropout's masks come from generator, by default a new one
        seeded 0 (the JAX package's PRNGKey(0) a call); otherwise, and in
        training (the trainer's generator), nothing changes."""
        if self.training or not self.eval_step_dropout:
            return contextlib.nullcontext()
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        return dropout_generator(generator)

    def token_hidden(self, tokens: torch.Tensor,
                     stage_tokens: Optional[torch.Tensor] = None,
                     probs: Optional[torch.Tensor] = None,
                     stage_probs: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
        """(N,) token ids -> (n_layers, N, H) decoder-initial hidden from
        the codebook rows (the JAX generator's `_token_hidden`).
        stage_tokens (N, S') adds the rows of stages 1 .. S' (-1: no
        contribution). Soft decode: probs (N, K) replaces the stage-0 row
        by probs @ codebook, and stage_probs (N, S', K) the stage rows by
        their mixtures (all-zero rows contribute nothing)."""
        flat = probs @ self.codebook if probs is not None \
            else self.codebook[tokens]
        n_stages = 0 if stage_tokens is None else stage_tokens.shape[-1]
        if n_stages >= self.stages:
            raise ValueError(f"{n_stages} residual stages given, the "
                             f"tokenizer has {self.stages - 1}")
        for s in range(n_stages):
            cb = getattr(self, f"codebook_r{s + 1}")
            if stage_probs is not None:
                flat = flat + stage_probs[:, s] @ cb
                continue
            st = stage_tokens[:, s]
            flat = flat + torch.where((st >= 0)[:, None],
                                      cb[st.clamp(min=0)],
                                      flat.new_zeros(()))
        return flat.reshape(-1, self.n_layers,
                            self.hidden_size).transpose(0, 1)

    def rollout(self, dec_hidden: torch.Tensor, seed_frame: torch.Tensor,
                n_steps: Optional[int] = None,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """Generative rollout: the seed frame (B, D) is the first input
        and is never emitted; each output feeds back as the next input.
        dec_hidden (L, B, H) -> (B, n_steps or n_frames, D). generator:
        the eval step dropout's stream (`step_dropout_stream`). A decoder
        with attention has no encoder outputs here and is refused (the JAX
        rollout passes none either)."""
        if self.use_attention:
            raise ValueError("the generative rollout has no encoder "
                             "outputs for the decoder attention "
                             "(autoencoder_att): decode from an encoding")
        x, hidden = seed_frame, self._carry(dec_hidden)
        outs = []
        with self.step_dropout_stream(generator, seed_frame.device):
            for _ in range(n_steps or self.n_frames):
                x, hidden = self.decoder_step(x, hidden)
                outs.append(x)
        return torch.stack(outs, dim=1)

    def warmup_hidden(self, dec_hidden: torch.Tensor, seed: torch.Tensor,
                      encoder_outputs: Optional[torch.Tensor] = None,
                      steps: int = 5,
                      generator: Optional[torch.Generator] = None
                      ) -> torch.Tensor:
        """The reference's decoder warm-up: the decoder step fed the seed
        frame (B, D) `steps` times from dec_hidden (L, B, H), its outputs
        dropped; returns the hidden after them (the JAX package's
        `SeqVQAutoencoder.warmup_hidden`). Plain PyTorch steps."""
        hidden = dec_hidden
        with self.step_dropout_stream(generator, seed.device):
            for _ in range(steps):
                _, hidden = self.decoder_step(seed, hidden, encoder_outputs)
        return hidden

    def _carry(self, dec_hidden: torch.Tensor) -> torch.Tensor:
        """The hidden in the compute dtype (JAX casts it before its scan,
        whose carry stays there)."""
        return dec_hidden if self.dtype is None else dec_hidden.to(self.dtype)

    def kernel_reason(self) -> str:
        """'' when the eval decode can run the chunk-decoder kernel (its
        instantiation for the compute dtype), else why not."""
        from gesture2vec_tpu_torch.ops import decoder_kernel as dk

        # neither is in the JAX package's TPU kernel either
        if self.use_attention:
            return ("the kernel has no attention over the encoder outputs "
                    "(autoencoder_att)")
        if self.eval_step_dropout:
            return ("the kernel applies no eval step dropout (a parity "
                    "checkpoint's eval_step_dropout)")
        if self.n_pre_poses != 1:
            return "the kernel starts from one seed frame (n_pre_poses=1)"
        return dk.supported(self.decoder_step, self.dtype or torch.float32)

    def decode(self, dec_hidden: torch.Tensor, out_poses: torch.Tensor,
               encoder_outputs: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None
               ) -> torch.Tensor:
        """The teacher-forced rollout of training and validation (the JAX
        package's `SeqVQAutoencoder.decode`): out_poses (B, T, D) gives
        the seed, outputs[:, 0], and the inputs of the steps t with
        t - 1 < n_pre_poses; every later step reads the previous output.
        dec_hidden (L, B, H) -> (B, n_frames, D); encoder_outputs (T, B,
        H) feed the decoder attention (ignored without it); generator is
        the eval step dropout's stream (`step_dropout_stream`). In eval
        mode with a 1-frame teacher prefix this is the seed plus the
        rollout from it,
        which `ops/decoder_kernel.fused_chunk_decode` runs in one launch
        (`use_kernel`, the default; with a compute dtype its instantiation
        for that dtype, over weights folded in it). On a CUDA tensor a
        decoder the kernel cannot run raises (`kernel_reason`); on the CPU
        it takes the plain loop."""
        from gesture2vec_tpu_torch.ops import decoder_kernel as dk

        seed = out_poses[:, 0]
        kernel = not self.training and self.use_kernel
        if kernel:
            reason = self.kernel_reason()
            if reason and seed.is_cuda:
                raise ValueError(f"eval decode on the card: {reason} "
                                 f"(set_use_kernels(False) runs the plain "
                                 f"rollout)")
            kernel = not reason
        if kernel:
            dt = self.dtype or torch.float32
            ys = dk.fused_chunk_decode(
                seed.to(dt).contiguous(), dec_hidden.to(dt).contiguous(),
                dk.fold_decoder_step(self.decoder_step, dt),
                self.n_frames - 1)
            return torch.cat([out_poses[:, :1], ys.transpose(0, 1).float()],
                             dim=1)
        prev, hidden, outs = seed, self._carry(dec_hidden), [seed]
        with self.step_dropout_stream(generator, seed.device):
            for t in range(1, self.n_frames):
                x = out_poses[:, t - 1] if t - 1 < self.n_pre_poses \
                    else prev
                prev, hidden = self.decoder_step(x, hidden, encoder_outputs)
                outs.append(prev)
        return torch.stack(outs, dim=1)


class SeqEncoder(nn.Module):
    """Linear-in + bidirectional GRU, directions summed; with a compute
    dtype both run in it and outputs and hidden come out in it."""

    def __init__(self, input_size: int, hidden_size: int, n_layers: int,
                 dropout_rate: float = 0.0, dtype: Dtype = None):
        super().__init__()
        self.hidden_size = hidden_size
        self.in_layer = Dense(input_size, hidden_size, compute_dtype=dtype)
        self.gru = BiGRU(hidden_size, hidden_size, n_layers, dropout_rate,
                         dtype=dtype)

    def forward(self, xs: torch.Tensor, n_run: Optional[int] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """xs (T, B, D) -> (outputs (T, B, H), hidden (2 * n_run, B, H));
        n_run (default all) is the number of GRU layers run."""
        outs, hidden = self.gru(self.in_layer(xs), n_run=n_run)
        H = self.hidden_size
        return outs[..., :H] + outs[..., H:], hidden


def _flatten_hidden(hidden: torch.Tensor, mode: str) -> torch.Tensor:
    """(L, B, H) -> (N, L*H) rows for the VQ layer. per_sample: one row
    per window; torch_view: the reference's (L, B, H).view(-1, L*H),
    which interleaves pairs of windows."""
    L, B, H = hidden.shape
    if mode == "per_sample":
        return hidden.transpose(0, 1).reshape(B, L * H)
    if mode == "torch_view":
        return hidden.contiguous().reshape(-1, L * H)
    raise ValueError(f"unknown vq_flatten mode {mode!r}")


def _unflatten_hidden(flat: torch.Tensor, shape: Tuple[int, int, int],
                      mode: str) -> torch.Tensor:
    L, B, H = shape
    if mode == "per_sample":
        return flat.reshape(B, L, H).transpose(0, 1)
    return flat.reshape(L, B, H)


class SeqVQAutoencoder(nn.Module):
    """The gesture tokenizer: encoder, quantizer and the token decoder
    (`SeqDecoder`, whose codebook is the quantizer's stage-0 codebook).
    vq_variant "gssoft" (the reference's) or "rvq"; use_vq False has no
    quantizer (and the decoder no codebook), use_vae the VAE heads. The
    decoder's stage-0 codebook is the quantizer's own parameter (and for
    "rvq" every stage's), so training moves one tensor for both.
    compute_dtype (None, or torch.bfloat16), use_attention and
    eval_step_dropout as in the module note."""

    def __init__(self, rep_dim: int, hidden_size: int, n_layers: int,
                 n_frames: int, vq_components: int = 512,
                 n_pre_poses: int = 1, vq_variant: str = "gssoft",
                 rvq_stages: int = 2, commitment_cost: float = 0.25,
                 conditioned: bool = True, vq_flatten: str = "per_sample",
                 encoder_arch: str = "bigru", use_vae: bool = False,
                 dropout_rate: float = 0.2, use_vq: bool = True,
                 compute_dtype: Dtype = None, use_attention: bool = False,
                 eval_step_dropout: bool = False):
        super().__init__()
        self.compute_dtype = compute_dtype
        if encoder_arch not in ("bigru", "transformer"):
            raise ValueError(f"unknown encoder_arch {encoder_arch!r}")
        if vq_flatten not in ("per_sample", "torch_view"):
            raise ValueError(f"unknown vq_flatten mode {vq_flatten!r}")
        self.rep_dim = rep_dim
        self.hidden_size = hidden_size
        self.n_layers = n_layers
        self.n_frames = n_frames
        self.vq_flatten = vq_flatten
        self.vq_variant = vq_variant
        self.encoder_arch = encoder_arch
        self.dropout_rate = dropout_rate
        self.use_vq, self.use_vae = use_vq, use_vae
        if encoder_arch == "transformer":
            # imported here: models/transformer imports this module
            from gesture2vec_tpu_torch.models.seq_encoder import \
                TransformerSeqEncoder
            self.encoder = TransformerSeqEncoder(
                rep_dim, hidden_size, n_layers, dropout_rate=dropout_rate,
                dtype=compute_dtype)
        else:
            self.encoder = SeqEncoder(rep_dim, hidden_size, n_layers,
                                      dropout_rate, compute_dtype)
        d = hidden_size * n_layers
        if vq_variant not in ("rvq", "gssoft"):
            raise ValueError(f"unknown vq_variant {vq_variant!r}")
        self.vq_layer = None
        if use_vq and vq_variant == "rvq":
            self.vq_layer = VQResidual(vq_components, d, rvq_stages,
                                       commitment_cost)
        elif use_vq:
            self.vq_layer = VQGSSoft(vq_components, d, commitment_cost)
        if use_vae:
            # over the (B, L*H) hidden, after the quantizer
            self.vae_mean = Dense(d, d)
            self.vae_std = Dense(d, d)
            self.vae_dec = Dense(d, d)
        self.decoder = SeqDecoder(
            rep_dim, hidden_size, n_layers, n_frames, vq_components,
            n_pre_poses, conditioned,
            stages=rvq_stages if use_vq and vq_variant == "rvq" else 1,
            dropout_rate=dropout_rate, dtype=compute_dtype,
            use_attention=use_attention,
            eval_step_dropout=eval_step_dropout)
        # one tensor for each codebook: the quantizer's (none without one)
        cbs = ([] if not use_vq else self.vq_layer.codebooks()
               if vq_variant == "rvq" else [self.vq_layer.codebook])
        for s, cb in enumerate(cbs):
            setattr(self.decoder, "codebook" if s == 0
                    else f"codebook_r{s}", cb)
        if not use_vq:
            self.decoder.codebook = None

    def set_use_kernels(self, on: bool) -> "SeqVQAutoencoder":
        """Route the BiGRU encoder's recurrences, the residual argmins and
        the eval-mode teacher-forced decode through the Hopper kernels
        (True, the default) or their plain versions (the transformer
        encoder runs no kernel)."""
        if self.encoder_arch == "bigru":
            self.encoder.gru.use_kernel = on
        if isinstance(self.vq_layer, VQResidual):
            self.vq_layer.use_kernel = on
        self.decoder.use_kernel = on
        return self

    def encode(self, in_poses: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """in_poses (B, T, D) -> (encoder outputs (T, B, H),
        decoder-initial hidden (L, B, H)); runs every encoder layer. In
        training the input takes dropout first."""
        xs = dropout(in_poses.transpose(0, 1), self.dropout_rate,
                     self.training, batch_dim=1)
        enc_outs, enc_hidden = self.encoder(xs)
        return enc_outs, enc_hidden[: self.n_layers]

    def forward(self, in_poses: torch.Tensor, out_poses: torch.Tensor
                ) -> Dict[str, object]:
        """The JAX package's `SeqVQAutoencoder.__call__`: encode,
        quantize (use_vq), the VAE heads (use_vae), teacher-forced decode.
        Returns {"outputs" (B, n_frames, D), "first_hidden" (L, B, H) the
        decoder-initial hidden after the quantizer and the VAE heads,
        "vq" the quantizer's VQOutput (None without one), "mean" and
        "logvar" (B, L*H) of the VAE heads (None without them)}. The
        decoder attention reads the encoder outputs."""
        enc_outs, dec_hidden = self.encode(in_poses)
        vq_out = mean = logvar = None
        if self.use_vq:
            vq_out, dec_hidden = self.quantize(dec_hidden)
        if self.use_vae:
            L, B, H = dec_hidden.shape
            flat = dec_hidden.transpose(0, 1).reshape(B, L * H)
            mean, logvar = self.vae_mean(flat), self.vae_std(flat)
            flat = self.vae_dec(reparameterize(mean, logvar, self.training))
            dec_hidden = flat.reshape(B, L, H).transpose(0, 1)
        return {"outputs": self.decoder.decode(dec_hidden, out_poses,
                                               enc_outs),
                "first_hidden": dec_hidden, "vq": vq_out, "mean": mean,
                "logvar": logvar}

    def encode_hidden(self, in_poses: torch.Tensor) -> torch.Tensor:
        """The decoder-initial hidden of `encode` alone. The BiGRU runs
        only the ceil(n_layers / 2) GRU layers whose states it holds
        (layer 0 at 2 layers): the same values, half the recurrences. The
        transformer's hidden is its pooled projection: every layer runs."""
        if self.encoder_arch == "transformer":
            return self.encode(in_poses)[1]
        n_run = (self.n_layers + 1) // 2
        _, enc_hidden = self.encoder(in_poses.transpose(0, 1), n_run=n_run)
        return enc_hidden[: self.n_layers]

    def _need_vq(self) -> None:
        if self.vq_layer is None:
            raise ValueError("the tokenizer has no quantizer "
                             "(autoencoder_vq is false): it gives no tokens")

    def quantize(self, dec_hidden: torch.Tensor
                 ) -> Tuple[VQOutput, torch.Tensor]:
        self._need_vq()
        flat = _flatten_hidden(dec_hidden.float(), self.vq_flatten)
        vq_out = self.vq_layer(flat)
        return vq_out, _unflatten_hidden(vq_out.quantized, dec_hidden.shape,
                                         self.vq_flatten)

    def tokens_from_hidden(self, dec_hidden: torch.Tensor) -> torch.Tensor:
        """(L, B, H) -> (B,) gesture-token ids (the quantizer's; the VAE
        heads play no part, as in JAX)."""
        vq_out, _ = self.quantize(dec_hidden)
        return self.vq_layer.tokens(vq_out.encodings)

    def stage_tokens(self, dec_hidden: torch.Tensor) -> torch.Tensor:
        """(L, B, H) -> (B, S) per-stage code ids (residual VQ only)."""
        if not isinstance(self.vq_layer, VQResidual):
            raise ValueError("stage tokens need vq_variant='rvq'")
        flat = _flatten_hidden(dec_hidden.float(), self.vq_flatten)
        return self.vq_layer.stage_tokens(flat)
