"""Decode ops, their plain versions and oracles, and the hand-written
CUDA kernels (``csrc/``) behind them."""
