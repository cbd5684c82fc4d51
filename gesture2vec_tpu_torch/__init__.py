"""PyTorch/CUDA port of gesture2vec_tpu for one NVIDIA H100.

The JAX package (`gesture2vec_tpu`) is the reference; this package
imports none of it and keeps its own copies of the framework-neutral
pieces it needs. Covered so far: decode-mode greedy text -> gesture
generation (`infer.text2gesture.GestureGenerator`), whose chunk rollout
runs in a hand-written Hopper kernel (`ops.decoder_kernel`,
`csrc/chunk_decoder.cu`).

Entry points run on the card unless the caller passes device="cpu";
on the CPU every kernel wrapper takes its plain PyTorch version.
"""
