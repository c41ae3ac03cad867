"""Kernel 1: the challenge fold of a stack of fixed-size tables.

    out[j][i] = t[j][2i] + r·(t[j][2i+1] − t[j][2i])   i < live_pairs
    out[j][i] = 0                                       live_pairs <= i < n

`fold` is the wrapper: on a CUDA tensor it launches csrc/fold.cu (which
replaces zolt_tpu/field/pallas_redc.py fold_tail, fold_tail_stack,
fold_rows_stack and fold_shared) or raises; on a CPU tensor it runs
`fold_plain`, the torch version of the same function. `fold.launches`
counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from . import limb
from .params import FR


def _check(tabs: torch.Tensor, live_pairs: int) -> None:
    if tabs.dtype != torch.int32 or tabs.dim() != 3 or tabs.shape[2] != 8:
        raise ValueError(f"fold takes (k, n, 8) int32 tables, got "
                         f"{tuple(tabs.shape)} {tabs.dtype}")
    if not tabs.is_contiguous():
        raise ValueError("fold takes contiguous tables")
    n = tabs.shape[1]
    if n % 2 or not 0 <= live_pairs <= n // 2:
        raise ValueError(f"live_pairs {live_pairs} out of range for n = {n}")


def fold_plain(tabs: torch.Tensor, r: int, live_pairs: int) -> torch.Tensor:
    """The torch version of kernel 1 (any device)."""
    k = tabs.shape[0]
    out = torch.zeros_like(tabs)
    if live_pairs:
        pairs = tabs[:, : 2 * live_pairs].reshape(k, live_pairs, 2, 8)
        lo, hi = pairs[:, :, 0], pairs[:, :, 1]
        rw = limb.encode(r % FR.p, device=tabs.device)
        out[:, :live_pairs] = limb.add(lo, limb.mont_mul(limb.sub(hi, lo), rw))
    return out


def fold(tabs: torch.Tensor, r: int, live_pairs: int) -> torch.Tensor:
    """Fold every table of `tabs` (k, n, 8) by the challenge r (a canonical
    int); returns a new (k, n, 8) tensor (the fold is out of place)."""
    _check(tabs, live_pairs)
    if tabs.device.type == "cpu":
        return fold_plain(tabs, r, live_pairs)
    if tabs.device.type != "cuda":
        raise ValueError(f"fold has no kernel for device {tabs.device}")
    if tabs.data_ptr() % 16:
        raise ValueError("fold needs 16-byte aligned tables")
    k, n = tabs.shape[0], tabs.shape[1]
    out = torch.empty_like(tabs)
    m = FR.mont(r % FR.p)
    rw = (ctypes.c_uint32 * 8)(*[(m >> (32 * i)) & 0xFFFFFFFF
                                 for i in range(8)])
    with torch.cuda.device(tabs.device):
        rc = _build.kernels().lib.zfr_fold(
            tabs.data_ptr(), out.data_ptr(), ctypes.cast(rw, ctypes.c_void_p),
            k, n, live_pairs, torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "fold")
    fold.launches += 1
    return out


fold.launches = 0
