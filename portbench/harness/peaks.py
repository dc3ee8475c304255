"""Published peaks of one NVIDIA H100 SXM (data sheet, dense, no sparsity;
at the full 700 W power limit)."""

BF16_FLOPS = 989e12  # FLOP/s, bf16 and fp16 tensor cores
HBM_BYTES = 3.35e12  # bytes/s
