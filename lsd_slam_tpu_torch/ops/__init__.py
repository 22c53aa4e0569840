"""Shared device ops: interpolation and the hand-written CUDA kernels."""
