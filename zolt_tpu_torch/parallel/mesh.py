"""Sharding the prover's wide rounds over a list of devices.

The port of zolt_tpu/parallel/mesh.py. The scaling axis is the table's
entry axis (the cycle axis): a table of n entries splits into n_dev
contiguous shards, shard s holding entries [s·n/n_dev, (s+1)·n/n_dev).
Pairs (2i, 2i+1) are adjacent and every shard holds an even count, so a
fold new[i] = lo + r·(hi − lo) never leaves its shard; each round's
partial evals are summed across shards (`_psum_field`).

The mesh is single-controller, as JAX's is: one process holds every shard
and the one Fiat-Shamir transcript, and launches each shard's kernels on
that shard's device. A `Mesh` is a tuple of torch devices, the counterpart
of jax.sharding.Mesh over jax.devices(). A list may repeat a device (four
shards on cuda:0 run every cross-shard step on one card) or name "cpu"
shards, which run the kernels' plain versions: the counterpart of XLA's
virtual CPU devices (--xla_force_host_platform_device_count). The same
code puts one shard on each of cuda:0..7.

Launches group by device: `evals_by_device` and `folds_by_device` hand
the groups of each device to one call of the grouped product-evals or fold
wrapper (up to 16 groups a launch), so shards that share a card share
launches.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..field import limb
from ..field.evals import product_evals
from ..field.fold import fold_many
from ..field.params import FR

AXIS = "shard"


def resolve_device(device) -> torch.device:
    """torch.device with the CUDA index filled in ("cuda" -> "cuda:0"), so
    it compares equal to a tensor's device. The device is never guessed:
    None raises."""
    if device is None:
        raise ValueError("the device engines need an explicit device=")
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: shard s lives on devices[s] (devices may repeat)."""
    devices: tuple

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(devices=None) -> Mesh:
    """A mesh over `devices`, or, with None, over every CUDA device
    (cuda:0..count-1): there is no CPU fallback, so with no CUDA device it
    raises. An explicit list may name "cpu" entries (the plain versions;
    the counterpart of XLA's virtual CPU devices) or repeat a device."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh() takes every CUDA device and "
                               "there is none; pass devices=[...] (e.g. "
                               "['cpu'] * 8) for a mesh on the CPU")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devs = tuple(resolve_device(d) for d in devices)
    if not devs:
        raise ValueError("a mesh needs at least one device")
    return Mesh(devs)


def shard_table(mesh: Mesh, table: torch.Tensor) -> list[torch.Tensor]:
    """An (n, 8) word table, or a (k, n, 8) stack, as n_dev contiguous
    shards along its entry axis, shard s a tensor of its own on
    mesh.devices[s] (a copy even where the device repeats: no shard
    aliases another's storage)."""
    n = table.shape[-2]
    if n % mesh.size:
        raise ValueError(f"{n} entries do not split over {mesh.size} shards")
    loc = n // mesh.size
    return [table.narrow(-2, s * loc, loc).to(d, copy=True).contiguous()
            for s, d in enumerate(mesh.devices)]


def gather_shards(shards, device) -> torch.Tensor:
    """The shards' entries in shard order, as one tensor on `device`."""
    return torch.cat([t.to(device) for t in shards], dim=-2)


def _psum_field(parts) -> torch.Tensor:
    """The field sum of the shards' (m, 8) partial evals, on the first
    part's device (mesh.devices[0]): canonical mod p, as JAX's
    carry-and-fold of its psum'd u16 limbs is."""
    acc = parts[0]
    for p in parts[1:]:
        acc = limb.add(acc, p.to(acc.device))
    return acc


def _by_device(groups) -> dict:
    """Indices of the groups by the device of their first tensor, in
    order."""
    out: dict = {}
    for i, g in enumerate(groups):
        out.setdefault(g[0].device, []).append(i)
    return out


def evals_by_device(groups) -> list[torch.Tensor]:
    """product_evals of groups (tabs, live_pairs, degree) that may lie on
    several devices: one grouped call a device; each group's evals on its
    own device."""
    out = [None] * len(groups)
    for idx in _by_device(groups).values():
        for i, e in zip(idx, product_evals([groups[i] for i in idx])):
            out[i] = e
    return out


def folds_by_device(groups, done=None) -> list[torch.Tensor]:
    """fold_many of groups (tabs, r, live_pairs) that may lie on several
    devices: one grouped call a device, `done(i, out)` as fold_many gives
    it, with i the group's index here. Holds no group past its handover
    to fold_many, which keeps the out-of-place copies one launch wide."""
    groups = list(groups)
    out = [None] * len(groups)
    for idx in _by_device(groups).values():
        sub = [groups[i] for i in idx]
        for i in idx:
            groups[i] = None

        def mark(j, t, idx=idx):
            out[idx[j]] = t
            if done is not None:
                done(idx[j], t)

        fold_many((sub.pop(0) for _ in idx), mark)
    return out


def make_sharded_eval_fold(mesh: Mesh, n_factors: int):
    """One sumcheck round's two sharded steps over shards (k, n_loc, 8), as
    shard_table gives them: `evals(shards)` -> the (k+1, 8) round evals at
    t = 0..k on mesh.devices[0] (each shard's on the product-evals kernel,
    then `_psum_field`), `fold(shards, r)` -> the shards folded by the
    canonical int r (the fold kernel, shard-local). They are separate
    because the challenge exists only after the evals are absorbed. The
    sharded rounds run over Fr only: the kernels are the Fr ones."""

    def evals(shards):
        parts = evals_by_device([(s[:n_factors], s.shape[1] // 2, n_factors)
                                 for s in shards])
        return _psum_field(parts)

    def fold(shards, r):
        return folds_by_device([(s, r % FR.p, s.shape[1] // 2)
                                for s in shards])

    return evals, fold


def make_sharded_product_round(mesh: Mesh, n_factors: int):
    """One sharded round: step(shards, r) -> (the (k+1, 8) round evals on
    mesh.devices[0], the shards folded by r)."""
    evals, fold = make_sharded_eval_fold(mesh, n_factors)

    def step(shards, r):
        return evals(shards), fold(shards, r)

    return step


def sharded_sumcheck_prove(mesh: Mesh, factor_tables, transcript):
    """The full sharded sumcheck prove of claim = Σ_x Π_k factor_k(x): the
    tables in a DeviceProductTables over `mesh`, each round's evals
    absorbed into the host transcript, whose challenge binds every shard.
    The engine's host tail takes the rounds where a shard holds fewer than
    2 live entries (and those at or below tail_n()).

    factor_tables: k lists of ints, each of one power-of-two length.
    Returns (round_evals, challenges, final_values)."""
    from .stage_engine import DeviceProductTables

    k = len(factor_tables)
    n = len(factor_tables[0])
    eng = DeviceProductTables(
        [limb.encode([v % FR.p for v in t], device=mesh.devices[0])
         for t in factor_tables], degree=k, mesh=mesh)
    round_evals, challenges = [], []
    while n > 1:
        evals = eng.round_evals()
        for e in evals:
            transcript.append_scalar(e)
        r = transcript.challenge_scalar()
        eng.bind(r)
        round_evals.append(evals)
        challenges.append(r)
        n //= 2
    return round_evals, challenges, eng.finals()
