"""Kernels of the port and their plain PyTorch versions."""
