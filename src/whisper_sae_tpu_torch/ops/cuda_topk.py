"""Kernel C, ``topk_mask_fwd``: the standalone exact top-k mask.

Replaces ``whisper_sae_tpu/ops/pallas_topk.py:topk_mask_pallas``
(``_mask_kernel``, ``pallas_call`` at :51): hidden = relu(pre) where pre
is among the row's k largest, else 0, over a precomputed f32 ``[B, H]``
pre-activation.  The kernel (``csrc/sae_kernels.cu:topk_mask_kernel``)
gives each row to one warp, which holds it in registers for the 32
bisection passes, so ``pre`` is read from device memory once.  Bound on
the H100: bytes, 8*B*H (one f32 read, one f32 write).

The backward is ``g * [hidden > 0]`` (``pallas_topk.py:81-83``).
"""

from __future__ import annotations

import torch

from . import _build
from .topk import topk_mask_plain


def _check_rows_width(h: int, k: int) -> None:
    if not 1 <= k <= h:
        raise ValueError(f"need 1 <= k <= H (got k={k}, H={h})")
    width = _build.load_library().wst_max_row_width()
    if h > width:
        raise ValueError(f"topk_mask_fwd holds a row in one warp's registers: H <= {width} (got {h})")


def topk_mask_fwd(pre: torch.Tensor, k: int) -> torch.Tensor:
    """Forward only: kernel C for a CUDA tensor, the plain version for a
    CPU tensor.  Counts its launches in ``topk_mask_fwd.launches``."""
    if pre.device.type == "cpu":
        return topk_mask_plain(pre, k)
    if pre.device.type != "cuda":
        raise ValueError(f"topk_mask_fwd: unsupported device {pre.device}")
    if pre.dtype != torch.float32 or pre.dim() != 2 or not pre.is_contiguous():
        raise ValueError("topk_mask_fwd takes a contiguous 2-D float32 tensor")
    rows, h = pre.shape
    _check_rows_width(h, k)
    out = torch.empty_like(pre)
    if rows:
        lib = _build.load_library()
        err = lib.wst_topk_mask_fwd(
            pre.data_ptr(), out.data_ptr(), rows, h, k,
            torch.cuda.current_stream(pre.device).cuda_stream,
        )
        _build.check(err, "topk_mask_fwd")
        topk_mask_fwd.launches += 1
    return out


topk_mask_fwd.launches = 0


class TopKMask(torch.autograd.Function):
    """Exact dense top-k mask with the gradient routed to the selected
    positive entries only (torch's topk -> relu backward)."""

    @staticmethod
    def forward(ctx, pre: torch.Tensor, k: int) -> torch.Tensor:
        hidden = topk_mask_fwd(pre, k)
        ctx.save_for_backward(hidden)
        return hidden

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        (hidden,) = ctx.saved_tensors
        return torch.where(hidden > 0, g, torch.zeros((), dtype=g.dtype, device=g.device)), None


def topk_mask(pre: torch.Tensor, k: int) -> torch.Tensor:
    return TopKMask.apply(pre, k)
