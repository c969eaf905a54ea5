"""Kernels of the port and their plain PyTorch versions: the exact
threshold-mask top-k (kernel C on the card).  Importing it builds and
loads no CUDA library."""

from .topk import topk_mask_dense, topk_threshold

__all__ = ["topk_mask_dense", "topk_threshold"]
