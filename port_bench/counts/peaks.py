"""Published peaks of one NVIDIA H100 SXM at its 700 W limit (NVIDIA's data
sheet, dense rates): the table every share of a peak or roofline is taken
against. The configurations fix float32 with TF32 off, so the flop peak is
the CUDA cores' float32 rate."""
F32_FLOP_S = 67e12
HBM_BYTES_S = 3.35e12
