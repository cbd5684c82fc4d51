"""PyTorch/CUDA port of gesture2vec_tpu for one NVIDIA H100.

The JAX package (`gesture2vec_tpu`) is the reference; this package
imports none of it and keeps its own copies of the framework-neutral
pieces it needs. Covered so far:
  - text -> gesture generation (`infer.text2gesture.GestureGenerator`,
    built from the JAX package's checkpoint files by
    `cli._common.build_generator`): decode mode, whose chunk rollouts
    run in `ops.decoder_kernel` (`csrc/chunk_decoder.cu`), and exemplar
    mode (`infer.exemplar`); greedy, sampled and beam token decodes,
    residual-stage tokens, soft decode, overlapped or continuous chunks,
    `generate_batch`; the TCN or the GRU text encoder, whose recurrences
    run in `ops.gru_kernel` (`csrc/gru_sequence.cu`);
  - the Part-c path (`cli.cluster`): clip-store windows, the frozen DAE
    and tokenizer sweep (`data.teacher`), K-Means and metrics
    (`cluster`), reading the JAX package's stores and checkpoint files
    (`data.store`, `compat.checkpoint`, `utils.mpack`); its BiGRU runs in
    `ops.gru_kernel` (`csrc/gru_sequence.cu`), its K-Means assignments
    and residual-VQ tokens in `ops.vq_kernel` (`csrc/vq_argmin.cu`).

Entry points run on the card unless the caller passes device="cpu";
on the CPU every kernel wrapper takes its plain PyTorch version.
"""
