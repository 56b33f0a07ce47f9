"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at its full power limit of 700 W)."""

# The dense TF32 tensor-core rate: the highest rate at which any product
# with float32 inputs can run on the card, so an honest float32 run can
# never read above it.
TF32_FLOPS = 495e12
# HBM3 bandwidth.
HBM_BYTES_PER_S = 3.35e12
