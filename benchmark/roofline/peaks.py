"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at the full
700 W power limit): the card's power limit is printed beside every share."""

HBM_BYTES_PER_S = 3.35e12   # HBM3
FP32_FLOPS = 67e12          # float32 outside the tensor cores


def least_seconds(nbytes: float, flops: float) -> float:
    """The larger of the memory time and the compute time."""
    return max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS)
