"""Published peaks of one NVIDIA H100 SXM (data sheet, dense, at its
700 W limit): tensor-core bf16/fp16 and float32 outside the tensor
cores, and HBM3 bandwidth."""

FLOPS = {"bf16": 989e12, "fp32": 67e12}
HBM_BYTES_PER_S = 3.35e12
DTYPE_BYTES = {"bf16": 2, "fp32": 4}


def bound_seconds(flops: float, nbytes: float, dtype: str = "bf16") -> float:
    """The least time the card could take: the larger of the operations
    over the peak rate and the bytes over the bandwidth."""
    return max(flops / FLOPS[dtype], nbytes / HBM_BYTES_PER_S)
