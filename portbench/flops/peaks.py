"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
without sparsity, at the full 700 W power limit).  Every share of a peak or
of a roofline that the benchmark reports is taken against these numbers; the
card's power limit is printed beside them."""

PEAK_FP32_FLOPS = 67e12  # float32 outside the tensor cores
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12  # bytes/s
