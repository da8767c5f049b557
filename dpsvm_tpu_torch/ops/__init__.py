"""Kernel primitives and the hand-written Hopper kernels."""
