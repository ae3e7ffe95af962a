"""PyTorch and CUDA port of MVSTER-TPU (multi-view stereo with epipolar
transformers). The JAX package ``deep_reconstruction_with_epipolar_lines_mvster_tpu``
stays the reference; this package imports nothing of it, nor JAX.
"""
