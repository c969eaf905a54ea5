"""Kernel C, ``topk_mask_fwd``: the standalone exact top-k mask.

Replaces ``whisper_sae_tpu/ops/pallas_topk.py:topk_mask_pallas``
(``_mask_kernel``, ``pallas_call`` at :51): hidden = relu(pre) where pre
is among the row's k largest, else 0, over a precomputed f32 ``[B, H]``
pre-activation.  The kernel (``csrc/sae_kernels.cu:topk_mask_kernel<float>``;
with a bf16 latent it is also kernel B's select) gives each row to one
warp, which holds it in registers for the 32 bisection passes, so
``pre`` is read from device memory once.  Rows
wider than a warp's registers (H > 3072; the TPU kernel takes H up to
262,144, ``pallas_topk.py:89-103``: 8 rows of f32 and int32 within 16
MiB) go to its wide form, ``wst_topk_mask_wide_fwd``.  Up to H = 40960
one CTA of 512 threads holds a row in registers
(``topk_mask_wide_kernel``), the same passes with the counts summed
across the CTA in int32, stopping at the first count of exactly k.  Past
it the entry launches the top-k encode's cluster form
(``csrc/blocked_encode.cu: cluster_select_kernel``), up to H = 262,144:
a thread-block cluster of 2, 4 or 8 CTAs holds a row
(``_build.cluster_ctas``: 2 at 49152 and 81920, 8 at 262,144), each CTA
a slice in registers and shared memory, read from device memory once;
the passes' warp counts go to every CTA over distributed shared memory,
and once at most 8192 values lie between the bounds the CTAs compact
them into one list in each CTA and finish the passes on it.  Every form
keeps the CTA select's midpoints and totals, so the mask is bit-identical
to the plain version.  Bound on the H100: bytes, 8*B*H (one f32 read,
one f32 write).

The backward is ``g * [hidden > 0]`` (``pallas_topk.py:81-83``).
"""

from __future__ import annotations

import torch

from . import _build
from .topk import plain_calls, topk_mask_plain


def topk_mask_fwd(pre: torch.Tensor, k: int) -> torch.Tensor:
    """Forward only: kernel C for a CUDA tensor (the warp form up to H =
    3072, the wide form above, up to ``_build.MAX_MASK_ROW``), the plain
    version for a CPU tensor.  Counts launches in ``topk_mask_fwd.launches``
    (warp form) and ``topk_mask_fwd.wide_launches``, those past H = 40960
    (the cluster form) also in ``topk_mask_fwd.cluster_launches``."""
    wide = pre.dim() == 2 and pre.shape[1] > _build.MAX_ROW
    if pre.device.type == "cpu":
        plain_calls["topk_mask_wide" if wide else "topk_mask"] += 1
        return topk_mask_plain(pre, k)
    if pre.device.type != "cuda":
        raise ValueError(f"topk_mask_fwd: unsupported device {pre.device}")
    if pre.dtype != torch.float32 or pre.dim() != 2 or not pre.is_contiguous():
        raise ValueError("topk_mask_fwd takes a contiguous 2-D float32 tensor")
    rows, h = pre.shape
    if not 1 <= k <= h:
        raise ValueError(f"need 1 <= k <= H (got k={k}, H={h})")
    lib = _build.load_library()
    if h > lib.wst_max_mask_row_width():
        raise ValueError(f"topk_mask_fwd takes H <= {lib.wst_max_mask_row_width()} (got {h})")
    out = torch.empty_like(pre)
    if rows:
        launch = lib.wst_topk_mask_wide_fwd if wide else lib.wst_topk_mask_fwd
        err = launch(pre.data_ptr(), out.data_ptr(), rows, h, k,
                     torch.cuda.current_stream(pre.device).cuda_stream)
        _build.check(err, "topk_mask_wide_fwd" if wide else "topk_mask_fwd")
        if wide:
            topk_mask_fwd.wide_launches += 1
            topk_mask_fwd.cluster_launches += int(h > _build.MAX_WIDE_ROW)
        else:
            topk_mask_fwd.launches += 1
    return out


topk_mask_fwd.launches = 0
topk_mask_fwd.wide_launches = 0
topk_mask_fwd.cluster_launches = 0


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
