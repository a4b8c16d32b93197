"""Binning, packing and the hand-written Hopper kernels (with their plain
PyTorch versions)."""
