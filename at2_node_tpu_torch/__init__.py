"""at2_node_tpu_torch: the PyTorch/CUDA port of the at2_node_tpu package.

A second package beside the JAX one. It imports torch and never jax, and
nothing of ``at2_node_tpu``: it keeps its own copy of every module it needs.
Its device work, batched ed25519 verification, runs on an NVIDIA GPU
through a hand-written CUDA kernel (``ops/cuda_verify.py``); entry points
use the first CUDA device unless the caller passes ``device="cpu"``, which
runs the plain PyTorch version.
"""
