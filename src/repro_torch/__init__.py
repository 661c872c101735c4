"""PyTorch + CUDA port of the KF-reconfigured chiplet NoC simulator, the
fleet KF bank and the KF-arbitrated serving engine.

The package mirrors `repro`'s layout module for module.  It imports torch
and numpy only: never jax, and nothing of the JAX package.  Entry points
run on the CUDA device unless the caller passes ``device="cpu"``; the
hand-written Hopper kernels live in `repro_torch.kernels`.
"""
