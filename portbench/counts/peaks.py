"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the full 700 W power limit)."""

BF16_FLOPS_PER_S = 989e12
F32_OPS_PER_S = 67e12  # outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
