"""Published peaks of one NVIDIA H100 SXM5 80GB (NVIDIA H100 Tensor Core
GPU data sheet; dense rates, without sparsity, at the full 700 W power
limit). A card set below 700 W reaches less."""

BF16_FLOPS = 989e12      # bf16 / fp16 dense tensor-core FLOP/s
F32_FLOPS = 67e12        # float32 outside the tensor cores
F64_FLOPS = 34e12        # float64 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
