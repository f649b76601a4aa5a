"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the card's full 700 W) and the roofline bound they give."""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
# float32 outside the tensor cores (the port runs f32 with TF32 off); bf16 in them.
PEAK_FLOPS = {'float32': 67e12, 'bfloat16': 989e12}


def bound_ms(n_bytes: float, flops: float, dtype: str) -> float:
    """Least time in ms: the larger of the bytes over the memory rate and
    the FLOPs over the dtype's peak."""
    return 1e3 * max(n_bytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype])
