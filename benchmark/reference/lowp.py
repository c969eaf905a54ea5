"""Operand precision of the references' products.

Both configurations state bf16 compute with f32 accumulation (the
port's AMP and its bf16 extraction): every product's operands are
rounded to bf16 and multiplied in true f32 (TF32 off), as
``preferred_element_type=f32`` does.  The control computes the same
with each operand rounded to fp8 e4m3 under a per-tensor scale (its
largest magnitude at 448), the next precision down.
"""

from __future__ import annotations

import contextlib

import torch

FP8_MAX = 448.0


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def _fp8(t: torch.Tensor) -> torch.Tensor:
    t = t.float()
    amax = t.abs().amax()
    scale = torch.where(amax > 0, amax / FP8_MAX, torch.ones_like(amax))
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


ROUNDERS = {"bf16": _bf16, "fp8": _fp8}


@contextlib.contextmanager
def true_f32():
    """TF32 off for matmuls and convolutions inside the block."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
