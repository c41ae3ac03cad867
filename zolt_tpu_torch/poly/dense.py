"""Dense multilinear polynomials as torch tensors of Fr Montgomery words.

The port of zolt_tpu/poly/dense.py. A dense MLE over n variables is an
(2^n, 8) int32 tensor (field/limb.py). Conventions follow the reference
(src/poly/mod.zig:23-330):

- `evaluate(evals, point)`: little-endian, point[0] pairs with the LSB of
  the evaluation index: a chain of `bind_low`.
- `bind_low(evals, r)`: new[i] = e[2i] + r·(e[2i+1] − e[2i]), Jolt's
  bound_poly_var_bot. This is kernel 1's function (field/fold.py,
  csrc/fold.cu): on a CUDA tensor it launches the fold, on a CPU tensor it
  runs the fold's plain version.
- `bind_first(evals, r)`: new[i] = e[i] + r·(e[i+half] − e[i]), the
  big-end variable; `eq_evals(r)`: the big-endian doubling, r[0] the MSB
  of the index. Only tests and examples call these two; they are plain
  torch on the tensor's device.
- `sum_mod`: the field sum the plain versions of the kernels use.
"""

from __future__ import annotations

import torch

from ..field import limb
from ..field.fold import fold
from ..field.limb import FR_C, FieldConst


def sum_mod(x: torch.Tensor, f: FieldConst = FR_C) -> torch.Tensor:
    """Field sum over axis 0 of (n, ..., 8) words: the 16-bit limbs summed
    column by column on x's device (exact in int64 for n < 2^47), then each
    sum's integer reduced mod p on the host (one copy of 16 columns a sum;
    the plain versions that call this are references, not the path)."""
    if x.shape[0] == 0:
        return torch.zeros(x.shape[1:], dtype=torch.int32, device=x.device)
    cols = limb.to_limbs16(x).sum(dim=0).to("cpu").reshape(-1, 16).tolist()
    p = f.params.p
    vals = [sum(v << (16 * j) for j, v in enumerate(row)) % p for row in cols]
    return limb.ints_to_words(vals).reshape(x.shape[1:]).to(x.device)


def bind_low(evals: torch.Tensor, r: int) -> torch.Tensor:
    """Bind the lowest-index variable of an Fr table by the canonical int r:
    out[i] = e[2i] + r·(e[2i+1] − e[2i]), one fold (kernel 1)."""
    n = evals.shape[0]
    return fold(evals.contiguous()[None], r, n // 2)[0]


def bind_first(evals: torch.Tensor, r: int,
               f: FieldConst = FR_C) -> torch.Tensor:
    """Bind the highest-index variable: out[i] = e[i] + r·(e[i+half] −
    e[i])."""
    half = evals.shape[0] // 2
    lo, hi = evals[:half], evals[half:]
    rw = limb.encode(r % f.params.p, f, device=evals.device)
    return limb.add(lo, limb.mont_mul(rw, limb.sub(hi, lo, f), f), f)


def evaluate(evals: torch.Tensor, point_ints) -> int:
    """MLE of an Fr table at a host point (canonical ints), little-endian:
    bind_low over point[0], point[1], ..."""
    x = evals
    for p in point_ints:
        x = bind_low(x, p)
    return limb.decode(x[0])


def eq_evals(r_ints, f: FieldConst = FR_C, scale: int = 1,
             device="cuda") -> torch.Tensor:
    """scale·eq(r, x) for all x in {0,1}^n on `device`, big-endian (r[0] =
    MSB of the index): Jolt's EqPolynomial::evals by doubling (reference
    poly/mod.zig:252-290)."""
    out = limb.encode([scale], f, device=device)
    for rj in reversed(list(r_ints)):
        y = limb.mont_mul(out, limb.encode(rj % f.params.p, f, device=device),
                          f)
        out = torch.cat([limb.sub(out, y, f), y])
    return out


def eq_mle(r_ints, x_ints, p: int) -> int:
    """Host-side eq(r, x) = prod(r_i x_i + (1-r_i)(1-x_i)) mod p."""
    acc = 1
    for r, x in zip(r_ints, x_ints):
        acc = acc * ((r * x + (1 - r) * (1 - x)) % p) % p
    return acc
