"""Dory row commitments of small-scalar polynomials on the device.

The Dory commit is a G1 MSM of each matrix row against the fixed g1_vec
basis. The committed chunk polynomials have tiny scalars: 4-bit
instruction / RAM / bytecode chunk values (compat mode) or 0/1 one-hot
cube indicators (sound mode). So a row MSM is a weighted sum of at most
`nplanes` bit-plane subset sums over the fixed basis:

    rowMSM = Σ_k 2^k · Σ_{c : bit k of scalar_c set} P_c

With a table of all 256 subset sums of every 8-column group (native
bn254_g1_subset_tables_mont, in Montgomery words: the port's own form, so
the upload is a view), one plane of one row is a sum of cols/8 table
points.

`DeviceRowMSM.commit_rows` uploads the u8 scalars and runs kernel B
(csrc/rows_msm.cu) on CUDA, which forms the subset bytes, sums the table
points and applies Horner over the planes inside one launch (`row_sums`),
each row on the lanes its density asks (`lanes_per_row`);
on the CPU `row_sums` runs `row_sums_plain`, JAX's algorithm
(zolt_tpu/msm/rows_device.py: `_plane_indices`, the gather and tree-add of
`_plane_sums` in chunks of SLOT_CAP points, `_horner_planes`) in plain
torch. The host finishes with one batched-affine normalization; the affine
rows equal the host C tier's (`g1_msm_rows_native`).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from ..curve import device as dev
from ..field import limb
from ..field.limb import FP_C
from ..field.params import FP

GROUP = 8          # columns per subset table
# Table points the plain version gathers at a time (JAX's cap, which bounds
# its peak memory; kernel B gathers nothing into device memory).
SLOT_CAP = 1 << 21


def _plane_indices(vals: torch.Tensor, nplanes: int) -> torch.Tensor:
    """vals (rows, cols) uint8 (< 2^nplanes) -> (nplanes, rows, cols/8)
    int64 table indices (group*256 + subset byte; bit j of the byte from
    column 8·group + j)."""
    rows, cols = vals.shape
    nch = cols // GROUP
    weights = (1 << torch.arange(GROUP, device=vals.device)).to(torch.int64)
    base = torch.arange(nch, device=vals.device, dtype=torch.int64) * 256
    v = vals.to(torch.int64).reshape(rows, nch, GROUP)
    return torch.stack([base + (((v >> k) & 1) * weights).sum(-1)
                        for k in range(nplanes)])


def _subset_bytes(vals: torch.Tensor, nplanes: int) -> torch.Tensor:
    """`_plane_indices` without the group offset, as kernel B forms it
    (and in an eighth of the memory): a group's 8 scalars are read as one
    word, byte j at bit 8j, and one multiply gathers bit k of each byte
    into the top byte (bit 8j to bit 56 + j; the product wraps mod 2^64,
    and no two partial products share a bit)."""
    words = vals.contiguous().view(torch.int64)
    return torch.stack([
        (((words >> k) & 0x0101010101010101) * 0x0102040810204080) >> 56
        & 0xFF for k in range(nplanes)])


def _plane_sums_plain(tx, ty, tz, idx):
    """Gather + pairwise tree-add over the last axis of idx (a power of two
    of groups): (..., nch) table indices -> (..., 8) x3 Jacobian sums."""
    gx, gy, gz = tx[idx], ty[idx], tz[idx]
    n = idx.shape[-1]
    while n > 1:
        h = n // 2
        gx, gy, gz = dev.pt_add_plain(
            (gx[..., :h, :], gy[..., :h, :], gz[..., :h, :]),
            (gx[..., h:, :], gy[..., h:, :], gz[..., h:, :]))
        n = h
    return gx[..., 0, :], gy[..., 0, :], gz[..., 0, :]


def _horner_planes(px, py, pz, nplanes: int):
    """(npoly, nplanes, rows, 8) plane sums -> Σ_k 2^k · plane k, by
    Horner with batched doublings."""
    acc = (px[:, -1], py[:, -1], pz[:, -1])
    for k in range(nplanes - 2, -1, -1):
        acc = dev.pt_double_plain(acc)
        acc = dev.pt_add_plain(acc, (px[:, k], py[:, k], pz[:, k]))
    return acc


def row_sums_plain(vals, table, valid, nplanes: int):
    """The torch version of kernel B (any device): vals (npoly, rows, cols)
    uint8, table (ntab, 16) int32 x||y words, valid (ntab,) uint8 ->
    three (npoly, rows, 8) Jacobian word tensors."""
    npoly, rows, cols = vals.shape
    nch = cols // GROUP
    one = limb.encode(1, FP_C, vals.device)
    tx, ty = table[:, :8], table[:, 8:]
    tz = torch.where(valid.bool().unsqueeze(-1), one, torch.zeros_like(one))
    planes = torch.cat([_plane_indices(v, nplanes) for v in vals])
    planes = planes.reshape(-1, nch)          # (npoly·nplanes·rows, nch)
    if nch & (nch - 1):                       # pad to a power of two
        pad = (1 << nch.bit_length()) - nch   # with group 0's identity entry
        planes = torch.cat([planes, planes.new_zeros(planes.shape[0], pad)],
                           dim=1)
    step = max(1, SLOT_CAP // planes.shape[1])
    parts = [_plane_sums_plain(tx, ty, tz, planes[i: i + step])
             for i in range(0, planes.shape[0], step)]
    px, py, pz = (torch.cat([p[c] for p in parts]).reshape(
        npoly, nplanes, rows, 8) for c in range(3))
    return _horner_planes(px, py, pz, nplanes)


def work(nonzero: int, rows: int, cols: int, nplanes: int) -> tuple[int, int]:
    """Bytes and IMADs kernel B needs for `rows` rows with `nonzero` table
    points to add (non-zero subset bytes of valid entries): the scalars
    read once, each added table point once (64 bytes, a mixed addition of
    11 products), the rows written once, and nplanes - 1 doublings a row
    (7 products)."""
    nbytes = rows * cols + nonzero * 64 + rows * 96
    imads = (nonzero * 11 + rows * (nplanes - 1) * 7) * limb.MONT_IMADS
    return nbytes, imads


def count_nonzero(vals, valid, nplanes: int) -> int:
    """The table points kernel B adds for vals (npoly, rows, cols): the
    non-zero subset bytes whose table entry is not the identity."""
    subset = _subset_bytes(vals.reshape(-1, vals.shape[-1]), nplanes)
    base = torch.arange(subset.shape[-1], device=vals.device) * 256
    return int(((subset != 0) & valid.bool()[base + subset]).sum())


# Kernel B's launch shapes: the lanes a row takes. Lane j of a row takes
# the j-th contiguous share of its groups, and the row's lanes meet in
# log2(lanes) levels of full additions. Dense rows spread evenly and spare
# the levels at 4 lanes; sparse ones (the sound prove's one-hot cubes,
# most rows empty and the rest near full) need 8 so that a warp's heavy
# rows spread over more lanes. The threshold is from chip_smoke.py's
# lanes sweeps on one H100.
LANES = (4, 8)


def lanes_per_row(nonzero: int, rows: int, slots: int) -> int:
    """The lanes a row takes in kernel B: 4 where the `nonzero` points
    fill at least a quarter of the rows' `slots` (planes x groups a row),
    else 8."""
    return 4 if 4 * nonzero >= rows * slots else 8


def row_sums(vals: torch.Tensor, table: torch.Tensor, valid: torch.Tensor,
             nplanes: int):
    """Row MSMs of vals (npoly, rows, cols) uint8 against a subset table:
    kernel B on CUDA tensors, `row_sums_plain` on CPU tensors. Returns
    three (npoly, rows, 8) Jacobian word tensors. The kernel takes
    `lanes_per_row` of the points it adds lanes a row. A launch adds the
    work its data needs (`work`, `count_nonzero`) to `row_sums.counts`."""
    if vals.dtype != torch.uint8 or vals.dim() != 3:
        raise ValueError(f"row_sums takes (npoly, rows, cols) uint8, got "
                         f"{vals.dtype} {tuple(vals.shape)}")
    npoly, rows, cols = vals.shape
    if cols % GROUP or table.shape != (cols // GROUP * 256, 16):
        raise ValueError(f"table {tuple(table.shape)} does not fit {cols} "
                         f"columns")
    d = vals.device
    if d.type == "cpu":
        return row_sums_plain(vals, table, valid, nplanes)
    if d.type != "cuda" or table.device != d or valid.device != d:
        raise ValueError(f"row_sums has no kernel for {d} (table on "
                         f"{table.device}, valid on {valid.device})")
    vals = vals.contiguous()
    total = npoly * rows
    nonzero = count_nonzero(vals, valid, nplanes)
    lanes = lanes_per_row(nonzero, total, nplanes * cols // GROUP)
    outs = [torch.empty((total, 8), dtype=torch.int32, device=d)
            for _ in range(3)]
    with torch.cuda.device(d):
        rc = _build.kernels().lib.zg1_row_msm(
            vals.data_ptr(), total, cols, nplanes, lanes, table.data_ptr(),
            valid.data_ptr(), *[o.data_ptr() for o in outs],
            torch.cuda.current_stream().cuda_stream)
    _build.check(rc, f"row_msm ({total} rows of {cols}, {lanes} lanes a "
                     f"row)")
    nbytes, imads = work(nonzero, total, cols, nplanes)
    c = row_sums.counts
    c["launches"] += 1
    c["rows"] += total
    c["bytes"] += nbytes
    c["imads"] += imads
    return tuple(o.view(npoly, rows, 8) for o in outs)


# launches, rows, and the bytes and IMADs of `work` for the launches' data
row_sums.counts = {"launches": 0, "rows": 0, "bytes": 0, "imads": 0}


def _batch_affine(xs, ys, zs):
    """Host batched Jacobian->affine: one modular inversion for the whole
    batch (Montgomery trick). xs/ys/zs: lists of ints; returns list of
    (x, y) affine tuples or None for identity."""
    p = FP.p
    n = len(xs)
    pref = [1] * (n + 1)
    zz = [z if z else 1 for z in zs]
    for i in range(n):
        pref[i + 1] = pref[i] * zz[i] % p
    inv = pow(pref[n], p - 2, p)
    out: list = [None] * n
    for i in range(n - 1, -1, -1):
        zinv = inv * pref[i] % p
        inv = inv * zz[i] % p
        if zs[i] == 0:
            continue
        zi2 = zinv * zinv % p
        out[i] = (xs[i] * zi2 % p, ys[i] * zi2 % p * zinv % p)
    return out


class DeviceRowMSM:
    """Fixed-basis row-MSM engine for one SRS basis prefix on one device.

    Uploads the 8-column subset tables once; `commit_rows` then turns
    stacks of small-scalar (value < 2^nplanes) polynomials into per-row
    affine commitments. Raises where the native table builder is absent:
    a device asked for is never handed back to the host."""

    def __init__(self, g1_vec, num_cols: int, device="cuda"):
        from ..native import g1_subset_tables_mont

        if num_cols % GROUP or not GROUP <= num_cols <= len(g1_vec):
            raise ValueError(f"num_cols {num_cols}: a multiple of {GROUP} "
                             f"up to the basis' {len(g1_vec)} points")
        self.num_cols = num_cols
        self.device = torch.device(device)
        built = g1_subset_tables_mont(list(g1_vec[:num_cols]))
        if built is None:
            raise RuntimeError("the native C tier is unavailable: it builds "
                               "the row MSM's subset tables")
        tabs, valid = built
        # 64 Montgomery bytes x||y an entry: sixteen of the port's words
        self.table = torch.from_numpy(tabs.view("<i4").copy()).to(self.device)
        self.valid = torch.from_numpy(valid.copy()).to(self.device)

    def commit_rows(self, polys: list[np.ndarray], nplanes: int = 4):
        """polys: list of 1-D uint8 arrays (values < 2^nplanes), each any
        length; returns per poly a list of its used rows (at least one)
        as affine points (None = identity), equal to the host MSM's."""
        from ..utils.log import metrics

        cols = self.num_cols
        used = [max(1, -(-len(v) // cols)) for v in polys]
        rows_max = max(used)
        with metrics.stage("row_msm_upload"):
            pad = np.zeros((len(polys), rows_max * cols), np.uint8)
            for i, v in enumerate(polys):
                pad[i, :len(v)] = v
            vals = torch.from_numpy(pad).to(self.device).view(
                len(polys), rows_max, cols)
        # one download (it waits for the kernel), then the host
        # batched-affine normalization
        with metrics.stage("row_msm_kernel_download"):
            rx, ry, rz = row_sums(vals, self.table, self.valid, nplanes)
            xs, ys, zs = (limb.decode(c.reshape(-1, 8), FP_C)
                          for c in (rx, ry, rz))
        with metrics.stage("row_msm_affine"):
            aff = _batch_affine(xs, ys, zs)
        return [aff[i * rows_max: i * rows_max + u]
                for i, u in enumerate(used)]


_ENGINES: dict = {}


def get_engine(srs, num_cols: int, device) -> DeviceRowMSM:
    """The DeviceRowMSM of (srs, num_cols, device), built at first use. The
    cache holds the srs too, so its id is never reused by another."""
    key = (id(srs), num_cols, str(torch.device(device)))
    if key not in _ENGINES:
        _ENGINES[key] = (srs, DeviceRowMSM(srs.g1_vec, num_cols, device))
    return _ENGINES[key][1]
