"""Spline math and the hand-written CUDA kernels of the port."""
