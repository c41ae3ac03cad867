"""G1 multi-scalar multiplication on the host C tier.

The JAX package's `msm` (zolt_tpu/msm/pippenger.py) sends large MSMs to a
device Pippenger; that path is not ported yet (ROADMAP Queue 1 item 9), so
every MSM here is `curve.host.msm`: the native C runtime, or the pure-Python
double-and-add where the native tier is absent. The result is the same
affine point either way.
"""

from ..curve.host import msm

__all__ = ["msm"]
