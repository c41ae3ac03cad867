"""Dense field-vector helpers on torch tensors (the port of the parts of
zolt_tpu/poly/dense.py that the device engines use)."""

from __future__ import annotations

import torch

from ..field import limb
from ..field.limb import FR_C, FieldConst


def sum_mod(x: torch.Tensor, f: FieldConst = FR_C) -> torch.Tensor:
    """Field sum over axis 0 of (n, ..., 8) words, by pairwise halving."""
    if x.shape[0] == 0:
        return torch.zeros(x.shape[1:], dtype=torch.int32, device=x.device)
    while x.shape[0] > 1:
        if x.shape[0] % 2:
            x = torch.cat([x, torch.zeros_like(x[:1])])
        h = x.shape[0] // 2
        x = limb.add(x[:h], x[h:], f)
    return x[0]
