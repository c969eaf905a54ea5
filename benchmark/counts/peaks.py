"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit)."""

BF16_FLOPS = 989e12  # tensor-core bf16, f32 accumulation
ALU_OPS = 67e12  # f32 operations outside the tensor cores
HBM_BYTES = 3.35e12  # bytes a second


def least_s(tensor_flops: float, alu_ops: float, nbytes: float) -> float:
    """The least time the chip could take: the longest of the tensor-core
    FLOPs at the bf16 peak, the ALU operations at the f32 peak (the two
    units run side by side) and the bytes at the memory bandwidth."""
    return max(tensor_flops / BF16_FLOPS, alu_ops / ALU_OPS, nbytes / HBM_BYTES)
