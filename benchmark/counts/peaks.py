"""Published dense peaks of one NVIDIA H100 SXM at its full 700 W power
limit (NVIDIA's data sheet). A card set below 700 W runs slower under
load, so every share is printed with the card's power limit beside it."""

HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12     # FP32 outside the tensor cores
TF32_FLOP_PER_S = 495e12    # TF32 tensor cores
BF16_FLOP_PER_S = 989e12    # bf16 tensor cores


def flop_peak(precision: str) -> float:
    """The peak a share is held against. A float32 configuration is held
    to the TF32 tensor cores' rate: float32-exact products can run there
    (split TF32 products), so a share against the FP32 units' 67 TFLOP/s
    could pass 100%."""
    if precision in ("float32", "tf32"):
        return TF32_FLOP_PER_S
    if precision == "bfloat16":
        return BF16_FLOP_PER_S
    raise ValueError(f"no peak for precision {precision!r}")


def bound_s(flops: float, nbytes: float, precision: str) -> float:
    """The least time the card could take: the larger of the operations
    over the FLOP peak and the bytes over the HBM rate."""
    return max(flops / flop_peak(precision), nbytes / HBM_BYTES_PER_S)
