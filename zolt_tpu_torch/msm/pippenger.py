"""Pippenger MSM over BN254 G1 on the device, and the MSM router.

Σ s_i · P_i with 8-bit windows (32 windows of a 256-bit scalar):

  1. digits: (n, 32) bytes of the canonical scalars, window 0 the least
     significant: from a tensor of Fr Montgomery words on its device
     (`scalar_digits`: kernel E, csrc/pippenger.cu, one Montgomery
     product a scalar), from host ints on the host (`int_digits`);
  2. each (window, point) pair with a non-zero digit is an entry keyed by
     its bucket window·256 + digit; torch.sort orders the entries by key and
     searchsorted finds each bucket's segment (`bucket_plan`);
  3. each bucket's points are summed (`bucket_sums`: kernel C,
     csrc/pippenger.cu): `bucket_chunks` cuts each bucket's entries into
     chunks of at most CHUNK, a thread sums a chunk by mixed additions,
     and passes of full additions sum each bucket's partials, chunked the
     same way, until one point a bucket is left;
  4. each window's Σ_b b·S_b (`window_sums`: kernel D, a block a window
     and a warp a bit plane: Σ_k 2^k · T_k, T_k the sum of the buckets
     whose index has bit k set, as `window_sums_plain` computes it);
  5. the 32 window totals are combined on the host (tiny, exact).

The JAX package (zolt_tpu/msm/pippenger.py) cuts the digits from host
ints and does steps 3-4 with a Hillis–Steele segmented scan (N log N
adds) and a lax.scan over buckets, in passes of 8 windows to bound the
tiled copies of the points; here an entry names its point (entry mod n)
and nothing is tiled. On CPU tensors the wrappers run their plain torch
versions. Results are compared in affine form: a sum's Jacobian words
depend on its order, its point does not.

`msm(points, scalars, device="cuda")` runs the Pippenger on `device` at
every size: on the card unless asked otherwise (it raises where there is
no CUDA device), and work asked of a device never moves to the host. With
device=None (Dory's callers) it stays on the host tiers: the
double-and-add below HOST_MAX points, else the native C MSM. `srs_msm`
takes a KZG SRS's affine table from a cache instead of building it a
call (HyperKZG). `msm_mesh` shards the points over a mesh
(parallel/mesh.py): each shard's bucket sums by kernel C on its device,
the shards' bucket arrays folded on the mesh's first device by kernel A
(`curve/device.pt_sum`, one launch a pass), then kernel D and the host
combine.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from ..curve import device as dev
from ..curve import host as chost
from ..field import limb
from ..field.limb import FP_C, FR_C
from ..field.params import FP, FR
from ..utils import require_cuda

WINDOW_BITS = 8
N_WINDOWS = 32  # 256 bits / 8
BUCKETS = 1 << WINDOW_BITS
HOST_MAX = 32            # host tiers: below, the double-and-add
# The most entries, or partial sums, kernel C sums in one chunk: a chunk
# costs one full addition more in the next pass (16 products against
# CHUNK · 11), about 9 % at 16.
CHUNK = 16


def _digits(scalars) -> np.ndarray:
    """(n, 32) uint8 window digits of the scalars reduced mod r, window 0
    = least significant byte."""
    buf = b"".join((int(s) % FR.p).to_bytes(32, "little") for s in scalars)
    return np.frombuffer(buf, dtype=np.uint8).reshape(len(scalars),
                                                      N_WINDOWS)


def affine_table(points, device="cpu"):
    """Host affine points (or None) -> (n, 16) int32 Montgomery words, x
    then y, and (n,) uint8 `valid`, 0 for the identity."""
    xs, ys = [], []
    for pt in points:
        x, y = pt if pt is not None else (0, 0)
        xs.append(FP.mont(x))
        ys.append(FP.mont(y))
    words = torch.cat([limb.ints_to_words(xs), limb.ints_to_words(ys)],
                      dim=1)
    valid = torch.tensor([pt is not None for pt in points], dtype=torch.uint8)
    return words.to(device), valid.to(device)


def bucket_plan(digits: torch.Tensor):
    """(n, 32) uint8 digits -> the entries (window·n + point, int32) of
    non-zero digits sorted by bucket (window·256 + digit), and each
    bucket's segment offsets (32·256 + 1, int32)."""
    n, nwin = digits.shape
    d = digits.t().reshape(-1).to(torch.int64)
    ents = torch.nonzero(d).reshape(-1)
    keys = (ents // n) * BUCKETS + d[ents]
    keys, order = torch.sort(keys)
    want = torch.arange(nwin * BUCKETS + 1, device=d.device)
    seg = torch.searchsorted(keys, want)
    return ents[order].to(torch.int32), seg.to(torch.int32)


def _segment_sums(key, x, y, z, nkeys: int):
    """The Jacobian points of each run of equal keys (`key` sorted) summed
    by rounds of pairwise additions of neighbours in a run -> three
    (nkeys, 8) word tensors, the identity where a key has no point."""
    d = key.device
    while key.numel():
        m = key.numel()
        pos = torch.arange(m, device=d)
        head = torch.ones(m, dtype=torch.bool, device=d)
        head[1:] = key[1:] != key[:-1]
        rank = pos - torch.cummax(torch.where(head, pos, 0), 0).values
        nxt = torch.zeros(m, dtype=torch.bool, device=d)
        nxt[:-1] = ~head[1:]
        even = rank % 2 == 0
        pair = even & nxt
        if not bool(pair.any()):
            break
        lo = torch.nonzero(pair).reshape(-1)
        s = dev.pt_add_plain((x[lo], y[lo], z[lo]),
                             (x[lo + 1], y[lo + 1], z[lo + 1]))
        x, y, z = x.clone(), y.clone(), z.clone()
        x[lo], y[lo], z[lo] = s
        ev = torch.nonzero(even).reshape(-1)
        key, x, y, z = key[ev], x[ev], y[ev], z[ev]
    out = [limb.zeros((nkeys,), d) for _ in range(3)]
    for o, c in zip(out, (x, y, z)):
        o[key] = c
    return tuple(out)


def _count(wrapper, nbytes: int, imads: int) -> None:
    """A launch of `wrapper`'s kernel, with the bytes and IMADs its data
    needs (`bucket_work`, `window_work`, `digits_work`)."""
    c = wrapper.counts
    c["launches"] += 1
    c["bytes"] += nbytes
    c["imads"] += imads


def bucket_chunks(seg: torch.Tensor) -> list:
    """Kernel C's plan, on the segments' device: one int32 offsets tensor a
    pass, chunk c of the pass being [off[c], off[c+1]) of its items. Pass
    0's items are the entries, cut at every bucket boundary and every L
    entries within a bucket; pass k+1's are pass k's chunk sums, which
    stay grouped by bucket, cut the same way; the last pass has one chunk
    a bucket (len(seg) offsets, empty for an empty bucket). So no chunk
    holds more than L items, and a bucket of m entries needs ceil(log_L m)
    passes (at least one): the largest sets the count. L is CHUNK."""
    L = CHUNK
    d = seg.device
    nb = seg.numel() - 1
    cnt = (seg[1:] - seg[:-1]).long()
    top = int(cnt.max()) if nb else 0
    levels = 0
    while top > L ** (levels + 1):
        levels += 1
    # each bucket's chunks in pass k: ceil(m / L^(k+1)) of its m entries
    pers = [(cnt + L ** (k + 1) - 1) // L ** (k + 1) for k in range(levels)]
    sizes = torch.stack([p.sum() for p in pers]).tolist() if levels else []
    plan, s = [], seg.long()
    for per, m in zip(pers, sizes):
        first = torch.zeros(nb + 1, dtype=torch.int64, device=d)
        first[1:] = torch.cumsum(per, 0)
        b = torch.repeat_interleave(torch.arange(nb, device=d), per,
                                    output_size=m)
        start = s[b] + (torch.arange(m, device=d) - first[b]) * L
        plan.append(torch.cat([start, s[-1:]]).to(torch.int32))
        s = first
    plan.append(s.to(torch.int32))
    return plan


def _chunk_keys(off: torch.Tensor) -> torch.Tensor:
    """The chunk of each item of a pass, from its offsets."""
    return torch.repeat_interleave(
        torch.arange(off.numel() - 1, device=off.device),
        (off[1:] - off[:-1]).long())


def bucket_sums_plain(ent, seg, pts, valid):
    """The torch version of kernel C (any device), by the kernel's plan
    (`bucket_chunks`): `_segment_sums` keyed by pass 0's chunks over the
    valid entries' points, then keyed by each later pass's chunks over the
    partials. Returns three (nbuckets, 8) Jacobian word tensors."""
    d = pts.device
    n = pts.shape[0]
    plan = bucket_chunks(seg)
    key = _chunk_keys(plan[0])
    idx = ent.long() % n
    keep = valid[idx].bool()
    key, idx = key[keep], idx[keep]
    one = limb.encode(1, FP_C, d)
    x, y, z = _segment_sums(key, pts[idx, :8], pts[idx, 8:],
                            one.expand(len(idx), 8), plan[0].numel() - 1)
    for off in plan[1:]:
        x, y, z = _segment_sums(_chunk_keys(off), x, y, z, off.numel() - 1)
    return x, y, z


def bucket_sums(ent: torch.Tensor, seg: torch.Tensor, pts: torch.Tensor,
                valid: torch.Tensor):
    """Each bucket's sum of points: kernel C on CUDA tensors (one launch a
    pass of `bucket_chunks`' plan; counts["launches"] counts the calls,
    counts["kernels"] the launches), `bucket_sums_plain` on CPU
    tensors."""
    d = pts.device
    if d.type == "cpu":
        return bucket_sums_plain(ent, seg, pts, valid)
    if d.type != "cuda" or any(t.device != d for t in (ent, seg, valid)):
        raise ValueError(f"bucket_sums has no kernel for {d}")
    if ent.dtype != torch.int32 or seg.dtype != torch.int32:
        raise ValueError("bucket_sums takes int32 entries and offsets")
    nb, n = seg.numel() - 1, pts.shape[0]
    plan = bucket_chunks(seg)
    chunks = torch.tensor([p.numel() - 1 for p in plan], dtype=torch.int32)
    rows = max(1, int(chunks[:-1].sum()))
    part = [torch.empty((rows, 8), dtype=torch.int32, device=d)
            for _ in range(3)]
    outs = [torch.empty((nb, 8), dtype=torch.int32, device=d)
            for _ in range(3)]
    bounds = torch.cat(plan)
    with torch.cuda.device(d):
        rc = _build.kernels().lib.zg1_bucket_accumulate(
            ent.data_ptr(), bounds.data_ptr(),
            chunks.data_ptr(), len(plan), pts.contiguous().data_ptr(),
            valid.data_ptr(), n, *[t.data_ptr() for t in part + outs],
            torch.cuda.current_stream().cuda_stream)
    _build.check(rc, f"bucket_accumulate ({nb} buckets, {len(plan)} passes)")
    _count(bucket_sums, *bucket_work(ent, seg, valid, n))
    bucket_sums.counts["kernels"] += int((chunks > 0).sum())
    return tuple(outs)


bucket_sums.counts = {"launches": 0, "kernels": 0, "bytes": 0,
                      "imads": 0}


def window_sums_plain(bx, by, bz):
    """The torch version of kernel D (any device): Σ_b b·S_b per window as
    Σ_k 2^k · T_k, T_k the sum of the non-empty buckets whose index has
    bit k set (`_segment_sums` keyed by window and bit), then Horner over
    the 8 bits. Kernel D sums each T_k by a tree over a warp's lanes:
    the same points in another order."""
    d = bx.device
    nwin = bx.shape[0] // BUCKETS
    src = torch.nonzero(~limb.is_zero(bz)).reshape(-1)
    bit = torch.arange(WINDOW_BITS, device=d)
    row, k = torch.nonzero(((src % BUCKETS).unsqueeze(1) >> bit) & 1,
                           as_tuple=True)
    ent = src[row]
    key, order = torch.sort((ent // BUCKETS) * WINDOW_BITS + k, stable=True)
    ent = ent[order]
    T = [c.reshape(nwin, WINDOW_BITS, 8) for c in
         _segment_sums(key, bx[ent], by[ent], bz[ent], nwin * WINDOW_BITS)]
    acc = tuple(c[:, -1] for c in T)
    for j in range(WINDOW_BITS - 2, -1, -1):
        acc = dev.pt_add_plain(dev.pt_double_plain(acc),
                               tuple(c[:, j] for c in T))
    return acc


def window_sums(bx: torch.Tensor, by: torch.Tensor, bz: torch.Tensor):
    """Each window's Σ_b b·S_b: kernel D on CUDA tensors,
    `window_sums_plain` on CPU tensors."""
    d = bx.device
    if d.type == "cpu":
        return window_sums_plain(bx, by, bz)
    if d.type != "cuda":
        raise ValueError(f"window_sums has no kernel for {d}")
    nwin = bx.shape[0] // BUCKETS
    outs = [torch.empty((nwin, 8), dtype=torch.int32, device=d)
            for _ in range(3)]
    with torch.cuda.device(d):
        rc = _build.kernels().lib.zg1_window_sums(
            *[c.contiguous().data_ptr() for c in (bx, by, bz)], nwin,
            *[o.data_ptr() for o in outs],
            torch.cuda.current_stream().cuda_stream)
    _build.check(rc, f"window_sums ({nwin} windows)")
    _count(window_sums, *window_work(nwin))
    return tuple(outs)


window_sums.counts = {"launches": 0, "bytes": 0, "imads": 0}


def bucket_work(ent: torch.Tensor, seg: torch.Tensor, valid: torch.Tensor,
                n: int) -> tuple[int, int]:
    """Bytes and IMADs kernel C needs: each entry's index read once, each
    added point once (64 bytes, a mixed addition of 11 products; a
    bucket's first point costs none), each bucket written once."""
    nb = seg.numel() - 1
    added = int(valid[ent.long() % n].sum())
    filled = int((seg[1:] > seg[:-1]).sum())
    nbytes = ent.numel() * 4 + added * 64 + (nb + 1) * 4 + nb * 96
    return nbytes, max(0, added - filled) * 11 * limb.MONT_IMADS


def window_work(nwin: int) -> tuple[int, int]:
    """Bytes and IMADs of kernel D: the buckets read once, the totals
    written once, 2·255 additions (16 products) a window."""
    return nwin * BUCKETS * 96 + nwin * 96, nwin * 510 * 16 * limb.MONT_IMADS


def scalar_digits_plain(words: torch.Tensor) -> torch.Tensor:
    """The torch version of kernel E (any device): (n, 8) int32 Fr
    Montgomery words -> (n, 32) uint8 window digits. A Montgomery product
    by the integer 1 gives the canonical scalar, whose little-endian bytes
    are its digits."""
    one = limb.ints_to_words([1]).to(words.device)
    return limb.mont_mul(words, one, FR_C).contiguous().view(torch.uint8)


def scalar_digits(words: torch.Tensor) -> torch.Tensor:
    """(n, 8) int32 Fr Montgomery words -> (n, 32) uint8 window digits on
    their device: kernel E on CUDA tensors, `scalar_digits_plain` on CPU
    tensors."""
    if words.dtype != torch.int32 or words.dim() != 2 or words.shape[1] != 8:
        raise ValueError(f"scalar_digits takes (n, 8) int32 words, got "
                         f"{words.dtype} {tuple(words.shape)}")
    d = words.device
    if d.type == "cpu":
        return scalar_digits_plain(words)
    if d.type != "cuda":
        raise ValueError(f"scalar_digits has no kernel for {d}")
    words = words.contiguous()
    n = words.shape[0]
    out = torch.empty((n, 8), dtype=torch.int32, device=d)
    with torch.cuda.device(d):
        rc = _build.kernels().lib.zg1_scalar_digits(
            words.data_ptr(), n, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _build.check(rc, f"scalar_digits ({n} scalars)")
    _count(scalar_digits, *digits_work(n))
    return out.view(torch.uint8)


scalar_digits.counts = {"launches": 0, "bytes": 0, "imads": 0}


def digits_work(n: int) -> tuple[int, int]:
    """Bytes and IMADs of kernel E: n scalars read and their digits
    written (32 bytes each way), one Montgomery product each."""
    return n * 64, n * limb.MONT_IMADS


def int_digits(scalars, device) -> torch.Tensor:
    """Host ints -> (n, 32) uint8 window digits on `device`."""
    return torch.from_numpy(_digits(scalars).copy()).to(device)


def msm_digits(pts: torch.Tensor, valid: torch.Tensor,
               digits: torch.Tensor):
    """Σ s_i · P_i by the bucket method on the tensors' device -> host
    affine point. pts, valid: an affine table (`affine_table`); digits:
    the scalars' (n, 32) uint8 window digits."""
    if digits.shape != (pts.shape[0], N_WINDOWS):
        raise ValueError(f"{tuple(digits.shape)} digits for {pts.shape[0]} "
                         f"points")
    ent, seg = bucket_plan(digits)
    W = window_sums(*bucket_sums(ent, seg, pts, valid))
    return _combine(dev.to_affine_host(W))


def _combine(window_totals: list):
    """Σ_w 2^(8w)·W_w on the host (tiny, exact) -> affine point or None."""
    total = None
    for w, pt in enumerate(window_totals):
        if pt is not None:
            total = chost.add(total, chost.scalar_mul(pt, 1 << (WINDOW_BITS * w)))
    return total


def msm_mesh(mesh, points: list, scalars: list[int],
             windows_per_pass: int = 8):
    """Σ s_i · P_i with the points sharded over a mesh -> host affine point
    (the port of zolt_tpu/msm/pippenger.py msm_mesh). The points are padded
    with identities to a multiple of n_dev, and shard s takes points
    [s·n/n_dev, (s+1)·n/n_dev) for every window. A pass of
    `windows_per_pass` windows: each shard's bucket plan and bucket sums
    (kernel C) on its device; the shards' (windows·256)-point bucket arrays
    moved to mesh.devices[0], stacked, and folded there left to right by
    one kernel A launch (`pt_sum`: Jacobian addition is not an integer
    sum, so this is the EC counterpart of a psum; the stack's copy of the
    arrays buys the one launch); a one-shard mesh's arrays are its sums
    as they are; kernel D's window sums. Jacobian words depend on the order of the adds, their points do
    not: compare results in affine form."""
    n = len(points)
    if n != len(scalars) or n == 0:
        raise ValueError(f"msm of {n} points and {len(scalars)} scalars")
    pad = (-n) % mesh.size
    pts, valid = affine_table(list(points) + [None] * pad)
    digits = int_digits(list(scalars) + [0] * pad, "cpu")
    loc = (n + pad) // mesh.size
    shards = [(pts[s * loc:(s + 1) * loc].to(d, copy=True),
               valid[s * loc:(s + 1) * loc].to(d, copy=True),
               digits[s * loc:(s + 1) * loc].to(d, copy=True))
              for s, d in enumerate(mesh.devices)]
    dev0 = mesh.devices[0]
    totals: list = []
    for w0 in range(0, N_WINDOWS, windows_per_pass):
        wn = min(windows_per_pass, N_WINDOWS - w0)
        sums = []
        for p_s, v_s, d_s in shards:
            ent, seg = bucket_plan(d_s[:, w0:w0 + wn].contiguous())
            sums.append([c.to(dev0) for c in bucket_sums(ent, seg, p_s, v_s)])
        acc = sums[0] if len(sums) == 1 else \
            dev.pt_sum(tuple(torch.stack(c) for c in zip(*sums)))
        totals.extend(dev.to_affine_host(window_sums(*acc)))
    return _combine(totals)


_TABLES: dict = {}


def srs_table(srs, device):
    """The affine table of srs.powers_g1 on `device`, built at first use;
    an MSM of n points takes its first n rows. The cache holds the srs
    too, so its id is never reused by another."""
    key = (id(srs), str(torch.device(device)))
    if key not in _TABLES:
        _TABLES[key] = (srs, affine_table(srs.powers_g1, device))
    return _TABLES[key][1]


def srs_msm(srs, digits: torch.Tensor):
    """Σ s_i · τ^i·G for the scalars of `digits` ((n, 32) uint8), by the
    Pippenger on the digits' device against the SRS's cached table."""
    n = digits.shape[0]
    if not 0 < n <= len(srs.powers_g1):
        raise ValueError(f"an MSM of {n} points over an SRS of "
                         f"{len(srs.powers_g1)}")
    pts, valid = srs_table(srs, digits.device)
    return msm_digits(pts[:n], valid[:n], digits)


def pippenger(points: list, scalars: list[int], device):
    """Σ s_i · P_i by the bucket method on `device` -> host affine point."""
    return msm_digits(*affine_table(points, device),
                      int_digits(scalars, device))


def msm(points: list, scalars: list[int], device="cuda"):
    """Multi-scalar multiplication Σ s_i · P_i -> host affine point.

    points: host affine points (or None); scalars: ints. With a device
    (the card by default), the Pippenger on it at every size (its plain
    versions on "cpu"); with device=None, the host tiers: the
    double-and-add below HOST_MAX points, else the native C MSM (the
    double-and-add where it is absent)."""
    n = len(points)
    if n != len(scalars) or n == 0:
        raise ValueError(f"msm of {n} points and {len(scalars)} scalars")
    if device is not None:
        require_cuda(device, "msm")
        return pippenger(points, scalars, device)
    if n < HOST_MAX:
        return chost.msm(points, scalars)
    from ..native import g1_msm_native

    out = g1_msm_native(points, scalars)
    if out is not None or all(
            p is None or s % FR.p == 0 for p, s in zip(points, scalars)):
        return out
    return chost.msm(points, scalars)


def msm_oracle(points, scalars):
    return chost.msm(points, scalars)
