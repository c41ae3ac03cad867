"""Kernels 2, 3 and G: round evaluations of k-factor product sumchecks.

    evals[t] = Σ_{i < live_pairs} Π_j (lo_j[i] + t·(hi_j[i] − lo_j[i]))
    t = 0..degree,  lo_j[i] = tabs[j][2i],  hi_j[i] = tabs[j][2i+1]

returned as (degree+1, 8) Montgomery words, for any k >= 1 and degree >= 0.
`product_evals` takes a list of groups (tabs, live_pairs, degree). On CPU
tensors it runs `product_evals_plain` group by group. On CUDA tensors it
launches a kernel or raises: the groups of k = 2 or 3 and degree <= 3 go
to csrc/product_evals.cu (kernels 2-3, which replace
zolt_tpu/field/pallas_redc.py eval_rows_k2 and eval_rows_k3 with their host
decodes), up to MAX_GROUPS a launch; every other group goes to kernel G
(csrc/product_evals_any.cu, which replaces the XLA _evals_fixed of
zolt_tpu/parallel/stage_engine.py), up to MAX_DESCS descriptors a launch.
Kernels 2-3's counters, plain integers in `product_evals.counts`:
"launches", "launches_k2"/"launches_k3" (launches that carried a group of
that k), "groups_k2"/"groups_k3", and the "bytes" and "imads" the launched
groups need (`work`), in all and by k ("bytes_k2", "imads_k3", ...).
Kernel G's, in `counts_g`: "launches", "groups", "descriptors" (a group's
points cut into runs of ANY_POINTS), and the "bytes" and "imads" of
`work_any`.
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
# Kernel G (csrc/product_evals_any.cu): points a descriptor, descriptors a
# launch, threads a block.
ANY_POINTS = 4
MAX_DESCS = 16
_ANY_THREADS = 128


class _Group(ctypes.Structure):
    """csrc/product_evals.cu ZfrEvalGroup."""
    _fields_ = [("tabs", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("n", ctypes.c_longlong), ("live_pairs", ctypes.c_longlong),
                ("k", ctypes.c_int), ("degree", ctypes.c_int),
                ("lanes", ctypes.c_int), ("nblocks", ctypes.c_int)]


class _Desc(ctypes.Structure):
    """csrc/product_evals_any.cu ZfrAnyDesc."""
    _fields_ = [("tabs", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("n", ctypes.c_longlong), ("live_pairs", ctypes.c_longlong),
                ("k", ctypes.c_int), ("t0", ctypes.c_int),
                ("npts", ctypes.c_int), ("nblocks", ctypes.c_int)]


def _check(tabs: torch.Tensor, live_pairs: int, degree: int) -> None:
    if tabs.dtype != torch.int32 or tabs.dim() != 3 or tabs.shape[2] != 8 \
            or tabs.shape[0] < 1:
        raise ValueError(f"product evals take (k, n, 8) int32 tables, "
                         f"k >= 1, got {tuple(tabs.shape)} {tabs.dtype}")
    if not tabs.is_contiguous():
        raise ValueError("product evals take contiguous tables")
    n = tabs.shape[1]
    if n % 2 or not 0 <= live_pairs <= n // 2:
        raise ValueError(f"live_pairs {live_pairs} out of range for n = {n}")
    if degree < 0:
        raise ValueError(f"degree {degree} < 0")


def on_kernels_23(k: int, degree: int) -> bool:
    """Whether a group of k factors and this degree takes kernels 2-3 (on
    a card; every other group takes kernel G)."""
    return k in (2, 3) and degree <= MAX_DEGREE


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


def work_any(groups) -> tuple[int, int]:
    """Bytes and IMADs kernel G's groups (tabs, live_pairs, degree) need:
    each live pair's k entries of 64 bytes read once, the evals written
    once; at each of min(degree, k) + 1 points a pair (Σ Π is of degree k
    in t, so those determine the rest), k − 2 Montgomery products and one
    wide product (k = 1: none, a sum). Kernel G sums all degree + 1
    points, more than this where degree > k."""
    nbytes = imads = 0
    for tabs, live, deg in groups:
        k = tabs.shape[0]
        nbytes += k * live * 64 + (deg + 1) * 32
        if k > 1:
            imads += live * (min(deg, k) + 1) * (
                (k - 2) * limb.MONT_IMADS + limb.WIDE_IMADS)
    return nbytes, imads


def product_evals_plain(tabs: torch.Tensor, live_pairs: int,
                        degree: int) -> torch.Tensor:
    """The torch version of kernels 2, 3 and G (any k, any device)."""
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
_SCRATCH_G: dict[torch.device, torch.Tensor] = {}


def _scratch(device: torch.device) -> torch.Tensor:
    """Kernels 2-3's per-group column sums and ticket counters on `device`
    (csrc/product_evals.cu: SLOT words a group): zeroed once, and left at
    zero by every launch. Launches on one device take them in stream
    order, so the port launches on the current stream only."""
    if device not in _SCRATCH:
        _SCRATCH[device] = torch.zeros((MAX_GROUPS, _SLOT_WORDS),
                                       dtype=torch.int64, device=device)
    return _SCRATCH[device]


def _scratch_g(device: torch.device) -> torch.Tensor:
    """Kernel G's per-descriptor column sums and tickets on `device`
    (csrc/product_evals_any.cu), kept as `_scratch` keeps kernels 2-3's."""
    if device not in _SCRATCH_G:
        _SCRATCH_G[device] = torch.zeros((MAX_DESCS, ANY_POINTS * 17 + 1),
                                         dtype=torch.int64, device=device)
    return _SCRATCH_G[device]


def _outputs(groups) -> tuple[torch.device, list[torch.Tensor]]:
    """The groups' common CUDA device and a (degree+1, 8) view a group of
    one output tensor there; raises for another device or a table that is
    not 16-byte aligned."""
    dev = groups[0][0].device
    if dev.type != "cuda":
        raise ValueError(f"product evals have no kernel for {dev}")
    outs = torch.empty((sum(d + 1 for _, _, d in groups), 8),
                       dtype=torch.int32, device=dev)
    views, row = [], 0
    for tabs, _, degree in groups:
        if tabs.device != dev:
            raise ValueError(f"product evals groups on {tabs.device} and {dev}")
        if tabs.data_ptr() % 16:
            raise ValueError("product evals need 16-byte aligned tables")
        views.append(outs[row: row + degree + 1])
        row += degree + 1
    return dev, views


def _launch(groups) -> list[torch.Tensor]:
    """One launch of kernels 2-3 over up to MAX_GROUPS groups."""
    dev, views = _outputs(groups)
    descs = (_Group * len(groups))()
    for desc, out, (tabs, live, degree) in zip(descs, views, groups):
        lanes = _LANES if live <= SPLIT_MAX_PAIRS else 1
        nblocks = max(1, min(_MAX_BLOCKS, -(-live * lanes // _THREADS)))
        desc.tabs, desc.out = tabs.data_ptr(), out.data_ptr()
        desc.n, desc.live_pairs = tabs.shape[1], live
        desc.k, desc.degree = tabs.shape[0], degree
        desc.lanes, desc.nblocks = lanes, nblocks
    with torch.cuda.device(dev):
        rc = _build.kernels().lib.zfr_product_evals(
            ctypes.addressof(descs), len(groups), _scratch(dev).data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _build.check(rc, f"product_evals ({len(groups)} groups)")
    return views


def descriptors(degree: int) -> list[tuple[int, int]]:
    """Kernel G's descriptors (t0, npts) of a group of this degree: the
    points 0..degree in runs of ANY_POINTS."""
    return [(t0, min(ANY_POINTS, degree + 1 - t0))
            for t0 in range(0, degree + 1, ANY_POINTS)]


def _launch_any(groups) -> list[torch.Tensor]:
    """Kernel G over the groups, MAX_DESCS descriptors a launch."""
    dev, views = _outputs(groups)
    descs = [(tabs, out, live, *d) for out, (tabs, live, degree)
             in zip(views, groups) for d in descriptors(degree)]
    lib = _build.kernels().lib
    for i in range(0, len(descs), MAX_DESCS):
        chunk = descs[i: i + MAX_DESCS]
        arr = (_Desc * len(chunk))()
        for d, (tabs, out, live, t0, npts) in zip(arr, chunk):
            d.tabs, d.out = tabs.data_ptr(), out.data_ptr()
            d.n, d.live_pairs = tabs.shape[1], live
            d.k, d.t0, d.npts = tabs.shape[0], t0, npts
            d.nblocks = max(1, min(_MAX_BLOCKS, -(-live // _ANY_THREADS)))
        with torch.cuda.device(dev):
            rc = lib.zfr_product_evals_any(
                ctypes.addressof(arr), len(chunk), _scratch_g(dev).data_ptr(),
                torch.cuda.current_stream().cuda_stream)
        _build.check(rc, f"product_evals_any ({len(chunk)} descriptors)")
        counts_g["launches"] += 1
    nbytes, imads = work_any(groups)
    counts_g["groups"] += len(groups)
    counts_g["descriptors"] += len(descs)
    counts_g["bytes"] += nbytes
    counts_g["imads"] += imads
    return views


counts_g = dict.fromkeys(
    ("launches", "groups", "descriptors", "bytes", "imads"), 0)


def product_evals(groups) -> list[torch.Tensor]:
    """The (degree+1, 8) round evals of each group (tabs (k, n, 8),
    live_pairs, degree), any k >= 1 and degree >= 0: on a card, the groups
    of k = 2, 3 and degree <= 3 up to MAX_GROUPS a launch of kernels 2-3,
    the others on kernel G."""
    groups = [(tabs, int(live), int(degree)) for tabs, live, degree in groups]
    for g in groups:
        _check(*g)
    if not groups:
        return []
    if all(tabs.device.type == "cpu" for tabs, _, _ in groups):
        return [product_evals_plain(*g) for g in groups]
    outs = [None] * len(groups)
    on23 = [i for i, (t, _, d) in enumerate(groups)
            if on_kernels_23(t.shape[0], d)]
    for i in range(0, len(on23), MAX_GROUPS):
        idx = on23[i: i + MAX_GROUPS]
        chunk = [groups[j] for j in idx]
        for j, out in zip(idx, _launch(chunk)):
            outs[j] = out
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
    rest = [i for i in range(len(groups)) if outs[i] is None]
    if rest:
        for j, out in zip(rest, _launch_any([groups[j] for j in rest])):
            outs[j] = out
    return outs


product_evals.counts = dict.fromkeys(
    ("launches", "launches_k2", "launches_k3", "groups_k2", "groups_k3",
     "bytes", "imads", "bytes_k2", "bytes_k3", "imads_k2", "imads_k3"), 0)
