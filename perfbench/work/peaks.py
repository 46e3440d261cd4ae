"""The chip's published peaks: one NVIDIA H100 SXM (data sheet, dense, at
the full 700 W power limit). float32 outside the tensor cores, since the
configurations compute in float32 with TF32 off."""

HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12


def bound_s(flops: float, nbytes: float) -> tuple[float, str]:
    """The least time the chip could take for this work, and which of the
    two peaks sets it."""
    t_ops = flops / FP32_FLOP_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (t_ops, "flops") if t_ops >= t_bytes else (t_bytes, "bytes")
