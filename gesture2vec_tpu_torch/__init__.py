"""PyTorch/CUDA port of gesture2vec_tpu for one NVIDIA H100.

The JAX package (`gesture2vec_tpu`) is the reference; this package
imports none of it and keeps its own copies of the framework-neutral
pieces it needs. Covered so far:
  - decode-mode greedy text -> gesture generation
    (`infer.text2gesture.GestureGenerator`), whose chunk rollout runs in
    `ops.decoder_kernel` (`csrc/chunk_decoder.cu`);
  - the Part-c path (`cli.cluster`): clip-store windows, the frozen DAE
    and tokenizer sweep (`data.teacher`), K-Means and metrics
    (`cluster`), reading the JAX package's stores and checkpoint files
    (`data.store`, `compat.checkpoint`, `utils.mpack`); its BiGRU runs in
    `ops.gru_kernel` (`csrc/gru_sequence.cu`), its K-Means assignments
    and residual-VQ tokens in `ops.vq_kernel` (`csrc/vq_argmin.cu`).

Entry points run on the card unless the caller passes device="cpu";
on the CPU every kernel wrapper takes its plain PyTorch version.
"""
