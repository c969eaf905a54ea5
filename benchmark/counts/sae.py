"""The TopK SAE's work: ``b`` rows of width ``d``, ``h`` features, ``k``
selected a row.

The forward's required work (``forward_*``): the dense encode
``2·b·d·h`` and the decode from the k selected features ``2·b·k·d``, as
tensor-core FLOPs; the select, one compare a pre-activation (``b·h``),
as ALU operations; the bytes of each input read once in its stored
dtype (the rows, W_enc, b_enc, b_pre, W_dec, b_dec) and of what the
forward must leave for the backward: the k selected values (bf16) and
their indices (int32) a row, and the f32 residual.

A training step's model FLOPs (``step_model_flops``): the encode, then
the decode, dW_enc and dW_dec over the k selected latents a row only
(``6·b·k·d``): the top-k backward needs nothing of the other features.
A recomputation or a dense backward over zeros is not counted.
"""

from __future__ import annotations

from . import peaks


def forward_flops(b: int, d: int, h: int, k: int) -> int:
    return 2 * b * d * h + 2 * b * k * d


def forward_alu_ops(b: int, h: int) -> int:
    return b * h


def forward_bytes(b: int, d: int, h: int, k: int, row_bytes: int = 4, param_bytes: int = 4) -> int:
    reads = b * d * row_bytes + (2 * d * h + h + 2 * d) * param_bytes
    writes = b * k * (2 + 4) + b * d * 4
    return reads + writes


def forward_least_s(b: int, d: int, h: int, k: int, row_bytes: int = 4) -> float:
    return peaks.least_s(forward_flops(b, d, h, k), forward_alu_ops(b, h),
                         forward_bytes(b, d, h, k, row_bytes))


def step_model_flops(b: int, d: int, h: int, k: int) -> int:
    return 2 * b * d * h + 6 * b * k * d
