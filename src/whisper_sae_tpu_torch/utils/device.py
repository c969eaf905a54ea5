"""Device choice and matmul precision.

Entry points run on the card unless the caller asks for the CPU; with no
GPU and no explicit request they raise rather than carry on quietly on
the CPU.  f32 products are true f32: TF32 on the card keeps about three
decimal digits, the H100 form of the TPU's bf16-in-f32-dots trap.
"""

from __future__ import annotations

import contextlib
import os

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means the card -- this process's own, ``cuda:LOCAL_RANK``,
    under ``torchrun``; a CUDA request without a card raises."""
    if device is None:
        local = os.environ.get("LOCAL_RANK")
        device = "cuda" if local is None else f"cuda:{int(local)}"
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (or --device cpu) "
            "to run on the CPU"
        )
    return dev


@contextlib.contextmanager
def f32_matmuls():
    """TF32 off for matmuls and cuDNN inside the block, restored after.

    The flags are process-wide in PyTorch, so they are set around the work
    that needs them (a trainer's step, an f32 product) instead of once for
    the whole process."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as an f32 product of the operands as given (bf16 operands
    are widened exactly), TF32 off: the counterpart of JAX's
    ``preferred_element_type=f32`` on bf16 operands, where
    ``torch.matmul(bf16, bf16)`` would round the result to bf16."""
    with f32_matmuls():
        return torch.matmul(a.float(), b.float())
