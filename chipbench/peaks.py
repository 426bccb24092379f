"""Published peaks of one NVIDIA H100 SXM (80 GB HBM3), dense rates without
sparsity, at the full 700 W power limit (NVIDIA's data sheet)."""

BF16_OPS_PER_S = 989e12  # tensor cores, bf16 and fp16
TF32_OPS_PER_S = 495e12  # tensor cores, TF32: bounds f32-exact work done as 3xTF32 too
FP32_OPS_PER_S = 67e12  # outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
MEMORY_BYTES = 80e9
