"""Kernels 2 and 3: round evaluations of k-factor product sumchecks.

    evals[t] = Σ_{i < live_pairs} Π_j (lo_j[i] + t·(hi_j[i] − lo_j[i]))
    t = 0..degree,  lo_j[i] = tabs[j][2i],  hi_j[i] = tabs[j][2i+1]

returned as (degree+1, 8) Montgomery words. `product_evals` is the wrapper
of csrc/product_evals.cu (which replaces zolt_tpu/field/pallas_redc.py
eval_rows_k2 and eval_rows_k3 with their host decodes). It takes a list of
groups (tabs, live_pairs, degree), k = 2 or 3 each, and evaluates them all
in one launch: on CUDA tensors it launches the kernel or raises, on CPU
tensors it runs `product_evals_plain` group by group. Its counters, plain
integers in `product_evals.counts`: "launches", "launches_k2"/"launches_k3"
(launches that carried a group of that k), "groups_k2"/"groups_k3", and
the "bytes" and "imads" the launched groups need (`work`), in all and by
k ("bytes_k2", "imads_k3", ...).
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..poly.dense import sum_mod
from . import limb

MAX_DEGREE = 3
MAX_GROUPS = 16                 # csrc/product_evals.cu MAX_GROUPS
_THREADS = 128                  # csrc/product_evals.cu THREADS
_LANES = 4                      # csrc/product_evals.cu LANES
# Groups of at most this many live pairs take four threads a pair (one a
# point), larger ones a thread a pair: the crossover on an H100
# (chip_smoke.py times both schedules at each live count; PERF.md).
SPLIT_MAX_PAIRS = 1 << 13
_MAX_BLOCKS = 1024              # per group; threads walk further pairs
_SLOT_WORDS = (MAX_DEGREE + 1) * 17 + 1  # a group's column sums, a ticket


class _Group(ctypes.Structure):
    """csrc/product_evals.cu ZfrEvalGroup."""
    _fields_ = [("tabs", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("n", ctypes.c_longlong), ("live_pairs", ctypes.c_longlong),
                ("k", ctypes.c_int), ("degree", ctypes.c_int),
                ("lanes", ctypes.c_int), ("nblocks", ctypes.c_int)]


def _check(tabs: torch.Tensor, live_pairs: int, degree: int) -> None:
    if tabs.dtype != torch.int32 or tabs.dim() != 3 or tabs.shape[2] != 8:
        raise ValueError(f"product evals take (k, n, 8) int32 tables, got "
                         f"{tuple(tabs.shape)} {tabs.dtype}")
    if tabs.shape[0] not in (2, 3):
        raise ValueError(f"product evals have kernels for k = 2, 3, not "
                         f"{tabs.shape[0]}")
    if not tabs.is_contiguous():
        raise ValueError("product evals take contiguous tables")
    n = tabs.shape[1]
    if n % 2 or not 0 <= live_pairs <= n // 2:
        raise ValueError(f"live_pairs {live_pairs} out of range for n = {n}")
    if not 0 <= degree <= MAX_DEGREE:
        raise ValueError(f"degree {degree} > {MAX_DEGREE}")


def work(groups) -> tuple[int, int]:
    """Bytes and IMADs the product evals need for these groups (tabs,
    live_pairs, degree): each live pair's K entries of 64 bytes read once,
    the evals written once; K = 2 sums min(degree, 2) + 1 products a pair,
    K = 3 forms that many reduced products and sums degree + 1."""
    nbytes = imads = 0
    for tabs, live, deg in groups:
        k = tabs.shape[0]
        nbytes += k * live * 64 + (deg + 1) * 32
        pts = min(deg, 2) + 1
        imads += live * (pts * limb.WIDE_IMADS if k == 2 else
                         pts * limb.MONT_IMADS + (deg + 1) * limb.WIDE_IMADS)
    return nbytes, imads


def product_evals_plain(tabs: torch.Tensor, live_pairs: int,
                        degree: int) -> torch.Tensor:
    """The torch version of kernels 2-3 (any k, any device)."""
    k = tabs.shape[0]
    if live_pairs == 0:
        return torch.zeros((degree + 1, 8), dtype=torch.int32,
                           device=tabs.device)
    pairs = tabs[:, : 2 * live_pairs].reshape(k, live_pairs, 2, 8)
    v, d = pairs[:, :, 0], limb.sub(pairs[:, :, 1], pairs[:, :, 0])
    outs = []
    for t in range(degree + 1):
        if t:
            v = limb.add(v, d)
        prod = v[0]
        for j in range(1, k):
            prod = limb.mont_mul(prod, v[j])
        outs.append(sum_mod(prod))
    return torch.stack(outs)


_SCRATCH: dict[torch.device, torch.Tensor] = {}


def _scratch(device: torch.device) -> torch.Tensor:
    """The kernel's per-group column sums and ticket counters on `device`
    (csrc/product_evals.cu SLOT words a group): zeroed once, and left at
    zero by every launch. Launches on one device take them in stream order,
    so the port launches on the current stream only."""
    if device not in _SCRATCH:
        _SCRATCH[device] = torch.zeros((MAX_GROUPS, _SLOT_WORDS),
                                       dtype=torch.int64, device=device)
    return _SCRATCH[device]


def _launch(groups) -> list[torch.Tensor]:
    dev = groups[0][0].device
    if dev.type != "cuda":
        raise ValueError(f"product evals have no kernel for {dev}")
    outs = torch.empty((sum(d + 1 for _, _, d in groups), 8),
                       dtype=torch.int32, device=dev)
    descs = (_Group * len(groups))()
    views, row = [], 0
    for desc, (tabs, live, degree) in zip(descs, groups):
        if tabs.device != dev:
            raise ValueError(f"product evals groups on {tabs.device} and {dev}")
        if tabs.data_ptr() % 16:
            raise ValueError("product evals need 16-byte aligned tables")
        out = outs[row: row + degree + 1]
        lanes = _LANES if live <= SPLIT_MAX_PAIRS else 1
        nblocks = max(1, min(_MAX_BLOCKS, -(-live * lanes // _THREADS)))
        desc.tabs, desc.out = tabs.data_ptr(), out.data_ptr()
        desc.n, desc.live_pairs = tabs.shape[1], live
        desc.k, desc.degree = tabs.shape[0], degree
        desc.lanes, desc.nblocks = lanes, nblocks
        views.append(out)
        row += degree + 1
    with torch.cuda.device(dev):
        rc = _build.kernels().lib.zfr_product_evals(
            ctypes.addressof(descs), len(groups), _scratch(dev).data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _build.check(rc, f"product_evals ({len(groups)} groups)")
    return views


def product_evals(groups) -> list[torch.Tensor]:
    """The (degree+1, 8) round evals of each group (tabs (k, n, 8),
    live_pairs, degree), k = 2 or 3; up to MAX_GROUPS groups a launch."""
    groups = [(tabs, int(live), int(degree)) for tabs, live, degree in groups]
    for g in groups:
        _check(*g)
    if not groups:
        return []
    if all(tabs.device.type == "cpu" for tabs, _, _ in groups):
        return [product_evals_plain(*g) for g in groups]
    outs = []
    for i in range(0, len(groups), MAX_GROUPS):
        chunk = groups[i: i + MAX_GROUPS]
        outs += _launch(chunk)
        c = product_evals.counts
        c["launches"] += 1
        for k in (2, 3):
            of_k = [g for g in chunk if g[0].shape[0] == k]
            nbytes, imads = work(of_k)
            c[f"groups_k{k}"] += len(of_k)
            c[f"launches_k{k}"] += bool(of_k)
            c[f"bytes_k{k}"] += nbytes
            c[f"imads_k{k}"] += imads
            c["bytes"] += nbytes
            c["imads"] += imads
    return outs


product_evals.counts = dict.fromkeys(
    ("launches", "launches_k2", "launches_k3", "groups_k2", "groups_k3",
     "bytes", "imads", "bytes_k2", "bytes_k3", "imads_k2", "imads_k3"), 0)
