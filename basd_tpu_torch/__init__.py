"""BASD (Bias-Aligned Spectral Distillation) ported to PyTorch and CUDA.

The JAX package ``basd_tpu`` is the reference; each module here mirrors its
counterpart there. This package imports ``torch`` and never ``jax``.
"""
