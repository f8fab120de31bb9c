"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at its 700 W power limit). The GCN paths run in fp32 with TF32 off,
so the FLOP rate is the fp32 rate outside the tensor cores."""

FP32_FLOP_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12
CARD = "NVIDIA H100 SXM, 700 W"
