"""The cluster-id -> gesture decoder.

Port of the JAX package's `models/c2g.py`: a cluster-id embedding, a
unidirectional GRU over that one step (`models/gru.GRU`, its layers on
`gru_sequence`) whose hidden seeds an autoregressive decoder step
(pre_linear -> BatchNorm -> ReLU -> GRU stack -> out_layer: the JAX
package's `_C2GStep`, built as `models/seq_ae.DecoderStep` without
attention or step dropout, same parameter names) emitting DAE-latent
frames. Frame 0 of the output is zeros, and the decoder's first input
too.

parity_frozen_hidden is the reference's quirk (its decoder writes the
new hidden to a misspelled variable): every step re-reads the encoder
hidden, so the recurrence never advances.

The eval rollout is the Part-b decoder's rollout from a zero seed, so
in eval, without the quirk, and where `ops/decoder_kernel.supported`
admits the step (2 layers, H <= 204 at D = 40: configs/c2g.yml's hidden
200 over the DAE's 40-wide latent) it runs as one `fused_chunk_decode`
(the Hopper kernel on CUDA, its plain version on the CPU). Training
(batch-statistics BatchNorm, dropout), the quirk and every step the
kernel refuses run the plain loop: the module chooses it from the reason
(`kernel_reason`) and logs it once.
"""
from __future__ import annotations

import logging

import torch
from torch import nn

from gesture2vec_tpu_torch.models.gru import GRU
from gesture2vec_tpu_torch.models.seq_ae import DecoderStep


class Cluster2Gesture(nn.Module):
    """cluster_ids (B,) -> (B, n_frames, output_size). Parameter names are
    the JAX module's (`embedding`, `pre_gru`, `step`). use_kernel False
    runs the eval rollout as the plain loop too."""

    def __init__(self, n_clusters: int, output_size: int, hidden_size: int,
                 n_frames: int, n_layers: int = 1, dropout_rate: float = 0.5,
                 parity_frozen_hidden: bool = False):
        super().__init__()
        self.output_size = output_size
        self.n_frames = n_frames
        self.parity_frozen_hidden = parity_frozen_hidden
        self.use_kernel = True
        self._logged = False
        self.embedding = nn.Embedding(n_clusters, hidden_size)
        self.pre_gru = GRU(hidden_size, hidden_size, n_layers, dropout_rate)
        self.step = DecoderStep(output_size, hidden_size, n_layers,
                                conditioned=True, dropout_rate=dropout_rate,
                                step_dropout=0.0)

    def kernel_reason(self) -> str:
        """'' when the eval rollout can run the chunk-decoder kernel, else
        why not."""
        from gesture2vec_tpu_torch.ops import decoder_kernel as dk

        if self.parity_frozen_hidden:
            return ("the kernel carries the hidden from step to step "
                    "(parity_frozen_hidden re-reads the encoder hidden)")
        return dk.supported(self.step)

    def forward(self, cluster_ids: torch.Tensor) -> torch.Tensor:
        from gesture2vec_tpu_torch.ops import decoder_kernel as dk

        emb = self.embedding(cluster_ids)[None]              # (1, B, H)
        _, enc_hidden = self.pre_gru(emb)                   # (L, B, H)
        x = enc_hidden.new_zeros((cluster_ids.shape[0], self.output_size))
        zeros = x[:, None]
        if not self.training and self.use_kernel:
            reason = self.kernel_reason()
            if not reason:
                ys = dk.fused_chunk_decode(
                    x, enc_hidden.contiguous(),
                    dk.fold_decoder_step(self.step), self.n_frames - 1)
                return torch.cat([zeros, ys.transpose(0, 1)], dim=1)
            if not self._logged:
                logging.info("c2g's eval rollout runs in plain PyTorch: %s",
                             reason)
                self._logged = True
        hidden, outs = enc_hidden, [zeros]
        for _ in range(self.n_frames - 1):
            x, new_hidden = self.step(x, hidden)
            hidden = enc_hidden if self.parity_frozen_hidden else new_hidden
            outs.append(x[:, None])
        return torch.cat(outs, dim=1)
