"""Dense field-vector helpers on torch tensors (the port of the parts of
zolt_tpu/poly/dense.py that the device engines use)."""

from __future__ import annotations

import torch

from ..field import limb
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
