"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the 700 W power limit), the yardstick of every roofline and MFU share:
HBM3 bytes/s and dense bf16 tensor-core FLOP/s.  A share above
RATE_LIMIT of a peak is a fault of the count or of the timing, and the run
that reads one fails."""

PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
RATE_LIMIT = 1.05


def bound_s(nbytes: float, flops: float, peak_flops: float = PEAK_BF16_FLOPS) -> float:
    """The least time a call could take: the larger of its bytes over the
    memory rate and its operations over the compute rate."""
    return max(nbytes / PEAK_BYTES_PER_S, flops / peak_flops)
