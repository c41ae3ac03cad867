"""Kernel 1: the challenge fold of the live prefix of table stacks.

    out[j][i] = t[j][2i] + r·(t[j][2i+1] − t[j][2i])   i < live_pairs

The output holds the new live prefix only, (k, live_pairs, 8). `fold_many`
is the wrapper: it folds several stacks ("groups"), each by its own r, in
one launch of csrc/fold.cu per 16 groups (which replaces zolt_tpu/field/pallas_redc.py
fold_tail, fold_tail_stack, fold_rows_stack and fold_shared) on CUDA
tensors, or raises; on CPU tensors it runs `fold_many_plain`, the torch
version of the same function. `fold` is one group. The counters, plain
integers in `fold_many.counts`: "launches", "groups", and the "bytes" and
"imads" the launched groups need (`work`).
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from . import limb
from .params import FR

MAX_GROUPS = 16                 # csrc/fold.cu MAX_GROUPS


class _Group(ctypes.Structure):
    """csrc/fold.cu ZfrFoldGroup."""
    _fields_ = [("src", ctypes.c_void_p), ("dst", ctypes.c_void_p),
                ("src_n", ctypes.c_longlong),
                ("live_pairs", ctypes.c_longlong),
                ("r", ctypes.c_uint32 * 8), ("k", ctypes.c_int)]


def _check(tabs: torch.Tensor, live_pairs: int) -> None:
    if tabs.dtype != torch.int32 or tabs.dim() != 3 or tabs.shape[2] != 8:
        raise ValueError(f"fold takes (k, n, 8) int32 tables, got "
                         f"{tuple(tabs.shape)} {tabs.dtype}")
    if not tabs.is_contiguous():
        raise ValueError("fold takes contiguous tables")
    if not 0 <= live_pairs <= tabs.shape[1] // 2:
        raise ValueError(f"live_pairs {live_pairs} out of range for "
                         f"n = {tabs.shape[1]}")


def _group(tabs: torch.Tensor, r, live_pairs) -> tuple:
    _check(tabs, int(live_pairs))
    return tabs, int(r), int(live_pairs)


def work(k: int, live_pairs: int) -> tuple[int, int]:
    """Bytes and IMADs a fold of k tables needs: each live pair's two
    entries read once and its new entry written once, one Montgomery
    product a pair."""
    return k * live_pairs * 96, k * live_pairs * limb.MONT_IMADS


def fold_plain(tabs: torch.Tensor, r: int, live_pairs: int) -> torch.Tensor:
    """The torch version of kernel 1 (any device)."""
    k = tabs.shape[0]
    pairs = tabs[:, : 2 * live_pairs].reshape(k, live_pairs, 2, 8)
    lo, hi = pairs[:, :, 0], pairs[:, :, 1]
    rw = limb.encode(r % FR.p, device=tabs.device)
    return limb.add(lo, limb.mont_mul(limb.sub(hi, lo), rw))


def fold_many_plain(groups) -> list[torch.Tensor]:
    return [fold_plain(*g) for g in groups]


def _launch(groups) -> list[torch.Tensor]:
    dev = groups[0][0].device
    if dev.type != "cuda":
        raise ValueError(f"fold has no kernel for device {dev}")
    total = sum(tabs.shape[0] * live for tabs, _, live in groups)
    buf = torch.empty((total, 8), dtype=torch.int32, device=dev)
    descs = (_Group * len(groups))()
    outs, row = [], 0
    for desc, (tabs, r, live) in zip(descs, groups):
        if tabs.device != dev:
            raise ValueError(f"fold groups on {tabs.device} and {dev}")
        if tabs.data_ptr() % 16:
            raise ValueError("fold needs 16-byte aligned tables")
        k = tabs.shape[0]
        out = buf[row: row + k * live].view(k, live, 8)
        m = FR.mont(r % FR.p)
        desc.src, desc.dst = tabs.data_ptr(), out.data_ptr()
        desc.src_n, desc.live_pairs, desc.k = tabs.shape[1], live, k
        desc.r[:] = [(m >> (32 * i)) & 0xFFFFFFFF for i in range(8)]
        outs.append(out)
        row += k * live
    if total:
        with torch.cuda.device(dev):
            rc = _build.kernels().lib.zfr_fold(
                ctypes.addressof(descs), len(groups),
                torch.cuda.current_stream().cuda_stream)
        _build.check(rc, f"fold ({len(groups)} groups)")
        c = fold_many.counts
        c["launches"] += 1
        for tabs, _, live in groups:
            if live:
                nbytes, imads = work(tabs.shape[0], live)
                c["groups"] += 1
                c["bytes"] += nbytes
                c["imads"] += imads
    return outs


def fold_many(groups, done=None) -> list[torch.Tensor]:
    """Fold each group (tabs (k, n, 8), r, live_pairs) by its challenge r (a
    canonical int) into a new (k, live_pairs, 8) tensor (the fold is out of
    place); up to MAX_GROUPS groups a launch, groups with no live pair
    take none. `done(i, out)`, where given, gets each group's output as
    soon as its launch is made, and fold_many drops its own hold on that
    launch's inputs first: a caller that lets go of its tables there keeps
    the out-of-place copies one launch wide."""
    groups = [_group(*g) for g in groups]
    on_cpu = all(g[0].device.type == "cpu" for g in groups)
    step = max(len(groups), 1) if on_cpu else MAX_GROUPS
    outs = []
    for i in range(0, len(groups), step):
        chunk = groups[i: i + step]
        groups[i: i + step] = [None] * len(chunk)
        outs += fold_many_plain(chunk) if on_cpu else _launch(chunk)
        del chunk
        if done is not None:
            for j in range(i, len(outs)):
                done(j, outs[j])
    return outs


fold_many.counts = dict.fromkeys(("launches", "groups", "bytes", "imads"), 0)


def fold(tabs: torch.Tensor, r: int, live_pairs: int) -> torch.Tensor:
    """One group of fold_many."""
    return fold_many([(tabs, r, live_pairs)])[0]
