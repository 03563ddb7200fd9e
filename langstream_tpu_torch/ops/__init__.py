"""Tensor ops and the hand-written CUDA kernels (``csrc/``) behind them."""
