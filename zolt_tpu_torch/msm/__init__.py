"""G1 multi-scalar multiplication.

`msm(points, scalars, device="cuda")` runs the device Pippenger
(pippenger.py, kernels C, D and E) on `device` at every size: on the card
unless asked otherwise, raising where there is no CUDA device, and work
asked of a device never moves to the host. With device=None it stays on
the host tiers (double-and-add, then the native C MSM), as Dory's callers
call it. `rows_device` is the device row-MSM tier
of the Dory commitments (kernel B). The result is the same affine point
on every tier.
"""

from .pippenger import msm, msm_oracle

__all__ = ["msm", "msm_oracle"]
