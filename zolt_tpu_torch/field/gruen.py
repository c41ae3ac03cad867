"""Kernel 4: the eq-weighted (Gruen) round, with the fold before it.

    fold:  az'[i] = az[2i] + r·(az[2i+1] − az[2i])      i < live_pairs
           (and bz' alike)
    eval:  t0 = Σ_{i < pairs} e_i · az[2i] · bz[2i]
           t∞ = Σ_{i < pairs} e_i · (az[2i+1] − az[2i]) · (bz[2i+1] − bz[2i])
           e_i = E_out[off_out + (i >> h_in)] · E_in[off_in + (i & (2^h_in − 1))]

over the flat prefix-table stacks E_out/E_in, the evals returned as (2, 8)
Montgomery words. `gruen_round` is the wrapper of csrc/gruen_round.cu
(which replaces zolt_tpu/field/pallas_kernels.py product_round and its
production form, zolt_tpu/zkvm/device_outer.py _eval_fixed and
_fold_fixed): given a challenge it folds the stack (2, n, 8) into its new
live prefix and evaluates the next round over the folded tables in the
same pass; given none it evaluates; with eval=False it only folds. On
CUDA tensors it launches the kernel or raises; on CPU tensors it runs
`gruen_round_plain`. `gruen_eval` is the eval-only call. The counters,
plain integers in `gruen_round.counts`: "launches", launches by mode
("eval", "fused", "fold"), and the "bytes" and "imads" the launches need
(`work`).
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..poly.dense import sum_mod
from . import limb
from .fold import fold_plain
from .params import FR

_THREADS = 128                  # csrc/gruen_round.cu THREADS
_LANES = 2                      # csrc/gruen_round.cu LANES
_MAX_BLOCKS = 1024              # past this, threads take further pairs
_COLS = 2 * 26                  # csrc/gruen_round.cu COLS
# Eval-only passes over at most this many pairs take two threads a pair,
# larger ones a thread a pair; passes that fold always take two
# (chip_smoke.py times both schedules of the eval-only pass on both sides;
# PERF.md: on an H100 two threads a pair folded faster at every count
# measured).
SPLIT_MAX_PAIRS = 1 << 14


class _Round(ctypes.Structure):
    """csrc/gruen_round.cu ZfrGruenRound."""
    _fields_ = [("az", ctypes.c_void_p), ("bz", ctypes.c_void_p),
                ("out", ctypes.c_void_p), ("e_out", ctypes.c_void_p),
                ("e_in", ctypes.c_void_p), ("evals", ctypes.c_void_p),
                ("scratch", ctypes.c_void_p),
                ("fold_pairs", ctypes.c_longlong),
                ("pairs", ctypes.c_longlong),
                ("off_out", ctypes.c_longlong),
                ("off_in", ctypes.c_longlong),
                ("r", ctypes.c_uint32 * 8), ("h_in", ctypes.c_int),
                ("lanes", ctypes.c_int), ("steps", ctypes.c_int),
                ("mode", ctypes.c_int)]


def _check_table(name: str, t, device) -> None:
    if t.dtype != torch.int32 or t.dim() != 2 or t.shape[1] != 8:
        raise ValueError(f"the Gruen round takes (n, 8) int32 {name}, got "
                         f"{tuple(t.shape)} {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"the Gruen round takes a contiguous {name}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, az on {device}")


def _check(az, bz, e_out, e_in, off_out: int, off_in: int, h_in: int,
           pairs: int, n_pairs: int) -> None:
    """pairs: the pairs evaluated; n_pairs: how many the tables hold."""
    for name, t in (("az", az), ("bz", bz), ("e_out", e_out), ("e_in", e_in)):
        _check_table(name, t, az.device)
    if az.shape != bz.shape:
        raise ValueError("az and bz must share a length")
    if not 0 <= pairs <= n_pairs:
        raise ValueError(f"live_pairs {pairs} out of range")
    last = pairs - 1
    if pairs and not (
            0 <= h_in < 63
            and 0 <= off_out and off_out + (last >> h_in) < e_out.shape[0]
            and 0 <= off_in
            and off_in + min(last, (1 << h_in) - 1) < e_in.shape[0]):
        raise ValueError("eq level offsets reach past the E_out/E_in stacks")


def work(fold_pairs: int, pairs: int, h_in: int) -> tuple[int, int]:
    """Bytes and IMADs one pass needs. The fold: each of az's and bz's live
    pairs read once and its new entry written once, one Montgomery product
    an entry. The eval: az and bz of each pair read once (in a fused pass
    the fold's outputs, already in registers: no bytes), the eq entries
    it weights them by, two evals written; a pair needs its two reduced
    products (a0·b0 and Δa·Δb) and their two products by E_in, which feed
    a sum and stay wide; each E_out entry weights its block of 2^h_in pairs
    once, a reduction of each of the block's two sums and a product by
    E_out, a Montgomery product's worth."""
    nbytes = 2 * fold_pairs * 96
    imads = 2 * fold_pairs * limb.MONT_IMADS
    if pairs:
        blocks = -(-pairs // (1 << h_in))
        nbytes += (0 if fold_pairs else 2 * pairs * 64) + 2 * 32
        nbytes += (blocks + min(pairs, 1 << h_in)) * 32
        imads += pairs * 2 * (limb.MONT_IMADS + limb.WIDE_IMADS)
        imads += blocks * 2 * limb.MONT_IMADS
    return nbytes, imads


def gruen_eval_plain(az, bz, e_out, e_in, off_out: int, off_in: int,
                     h_in: int, live_pairs: int) -> torch.Tensor:
    """The torch version of kernel 4's eval (any device)."""
    if live_pairs == 0:
        return torch.zeros((2, 8), dtype=torch.int32, device=az.device)
    idx = torch.arange(live_pairs, device=az.device)
    e = limb.mont_mul(e_out[off_out + (idx >> h_in)],
                      e_in[off_in + (idx & ((1 << h_in) - 1))])
    a = az[: 2 * live_pairs].reshape(live_pairs, 2, 8)
    b = bz[: 2 * live_pairs].reshape(live_pairs, 2, 8)
    a0, a1, b0, b1 = a[:, 0], a[:, 1], b[:, 0], b[:, 1]
    t0 = sum_mod(limb.mont_mul(e, limb.mont_mul(a0, b0)))
    tinf = sum_mod(limb.mont_mul(e, limb.mont_mul(limb.sub(a1, a0),
                                                  limb.sub(b1, b0))))
    return torch.stack([t0, tinf])


def gruen_round_plain(tabs, r, e_out, e_in, off_out: int, off_in: int,
                      h_in: int, live_pairs: int, eval: bool = True):
    """The torch version of kernel 4: fold_plain, then gruen_eval_plain."""
    pairs = live_pairs
    if r is not None:
        tabs = fold_plain(tabs, r, live_pairs)
        pairs = live_pairs // 2
    evals = (gruen_eval_plain(tabs[0], tabs[1], e_out, e_in, off_out,
                              off_in, h_in, pairs) if eval else None)
    return tabs, evals


_SCRATCH: dict[torch.device, torch.Tensor] = {}


def _scratch(device: torch.device) -> torch.Tensor:
    """The kernel's column sums and ticket on `device` (csrc/ticket.cuh):
    zeroed once, and left at zero by every launch. Launches on one device
    take them in stream order, so the port launches on the current stream
    only."""
    if device not in _SCRATCH:
        _SCRATCH[device] = torch.zeros(_COLS + 1, dtype=torch.int64,
                                       device=device)
    return _SCRATCH[device]


def schedule(quads: int, h_in: int, folds: bool) -> tuple[int, int]:
    """(lanes, steps) of a launch over `quads` next-round pairs: two
    threads a pair for a pass that folds or up to SPLIT_MAX_PAIRS, else
    one; a thread takes `steps` pairs so the grid stays within
    _MAX_BLOCKS, but a block never spans more than one E_out row when a row
    holds more than a block step (csrc/gruen_round.cu)."""
    lanes = _LANES if folds or quads <= SPLIT_MAX_PAIRS else 1
    step = _THREADS // lanes
    steps = 1
    while steps * step * _MAX_BLOCKS < quads:
        steps *= 2
    if (1 << h_in) > step:
        steps = min(steps, (1 << h_in) // step)
    return lanes, steps


def _launch(az, bz, out, e_out, e_in, r, off_out: int, off_in: int,
            h_in: int, fold_pairs: int, pairs: int, evals) -> None:
    dev = az.device
    for name, t in (("az", az), ("bz", bz), ("e_out", e_out),
                    ("e_in", e_in)):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"the Gruen round needs a 16-byte aligned {name}")
    mode = (1 if r is not None else 0) | (2 if evals is not None else 0)
    quads = (fold_pairs + 1) // 2 if r is not None else pairs
    desc = _Round()
    desc.az, desc.bz = az.data_ptr(), bz.data_ptr()
    desc.out = out.data_ptr() if out is not None else None
    if evals is not None:
        desc.e_out, desc.e_in = e_out.data_ptr(), e_in.data_ptr()
        desc.evals = evals.data_ptr()
        desc.scratch = _scratch(dev).data_ptr()
    desc.fold_pairs, desc.pairs = fold_pairs, pairs
    desc.off_out, desc.off_in, desc.h_in = off_out, off_in, h_in
    if r is not None:
        m = FR.mont(r % FR.p)
        desc.r[:] = [(m >> (32 * i)) & 0xFFFFFFFF for i in range(8)]
    desc.lanes, desc.steps = schedule(
        quads, h_in if evals is not None else 0, r is not None)
    desc.mode = mode
    with torch.cuda.device(dev):
        rc = _build.kernels().lib.zfr_gruen_round(
            ctypes.addressof(desc), torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "gruen_round")
    c = gruen_round.counts
    c["launches"] += 1
    c[{1: "fold", 2: "eval", 3: "fused"}[mode]] += 1
    nbytes, imads = work(fold_pairs, pairs, h_in)
    c["bytes"] += nbytes
    c["imads"] += imads


def gruen_round(tabs, r, e_out, e_in, off_out: int, off_in: int, h_in: int,
                live_pairs: int, eval: bool = True):
    """One pass over the stack tabs = (az, bz), (2, n, 8), with
    `live_pairs` live pairs. With a challenge r (a canonical int) it folds
    them into a new (2, live_pairs, 8) stack and, with eval, evaluates the
    next round over its live_pairs // 2 pairs; with r None it evaluates
    the live_pairs pairs of tabs. Returns (tables, (2, 8) evals or None);
    the tables are tabs itself when nothing folds. e_out/e_in may be None
    when eval is False."""
    if r is None and not eval:
        raise ValueError("gruen_round with neither a fold nor an eval")
    if tabs.dim() != 3 or tabs.shape[0] != 2:
        raise ValueError(f"gruen_round takes a (2, n, 8) stack, got "
                         f"{tuple(tabs.shape)}")
    pairs = (live_pairs // 2 if r is not None else live_pairs) if eval else 0
    if eval:
        _check(tabs[0], tabs[1], e_out, e_in, off_out, off_in, h_in, pairs,
               tabs.shape[1] // 2 if r is None else live_pairs // 2)
    else:
        _check_table("az", tabs[0], tabs.device)
    if r is not None and not 0 <= live_pairs <= tabs.shape[1] // 2:
        raise ValueError(f"live_pairs {live_pairs} out of range")
    if tabs.device.type == "cpu":
        return gruen_round_plain(tabs, r, e_out, e_in, off_out, off_in, h_in,
                                 live_pairs, eval)
    if tabs.device.type != "cuda":
        raise ValueError(f"gruen_round has no kernel for {tabs.device}")
    out = None
    if r is not None:
        out = torch.empty((2, live_pairs, 8), dtype=torch.int32,
                          device=tabs.device)
    evals = (torch.empty((2, 8), dtype=torch.int32, device=tabs.device)
             if eval else None)
    _launch(tabs[0], tabs[1], out, e_out, e_in, r, off_out, off_in, h_in,
            live_pairs if r is not None else 0, pairs, evals)
    return (out if out is not None else tabs), evals


gruen_round.counts = dict.fromkeys(
    ("launches", "eval", "fused", "fold", "bytes", "imads"), 0)


def gruen_eval(az, bz, e_out, e_in, off_out: int, off_in: int, h_in: int,
               live_pairs: int) -> torch.Tensor:
    """The (2, 8) evals of the live_pairs pairs of az, bz: gruen_round's
    eval-only pass on two separate tables."""
    _check(az, bz, e_out, e_in, off_out, off_in, h_in, live_pairs,
           az.shape[0] // 2)
    if az.device.type == "cpu":
        return gruen_eval_plain(az, bz, e_out, e_in, off_out, off_in, h_in,
                                live_pairs)
    if az.device.type != "cuda":
        raise ValueError(f"gruen_eval has no kernel for {az.device}")
    evals = torch.empty((2, 8), dtype=torch.int32, device=az.device)
    _launch(az, bz, None, e_out, e_in, None, off_out, off_in, h_in, 0,
            live_pairs, evals)
    return evals
