"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit; a card set below it
runs slower under load, so a run prints its power limit beside every
share of a peak)."""

TF32_FLOPS = 495e12          # tensor cores, TF32 dense
FP32_FLOPS = 67e12           # FP32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12    # HBM3
