"""Device and mesh engine for dense product-sumcheck instances (torch).

Most of the Jolt schedule's instances reduce per round to the same two
primitives over k dense tables (ValEvaluation: inc·wa·lt deg-3; ValFinal:
inc·wa deg-2 or 3; InstructionLookupsClaimReduction: eq·comb deg-2; the
Gruen instances factor their eq weight separately — see zkvm/device_outer):

    evals[t] = Σ_i Π_k (lo_k[i] + t·(hi_k[i] − lo_k[i]))   t = 0..degree
    fold:      tab_k[i] ← lo_k[i] + r·(hi_k[i] − lo_k[i])

The port of zolt_tpu/parallel/stage_engine.py. An engine's tables are one
(k, live, 8) int32 stack of Montgomery words holding the live prefix only:
each fold writes a new stack of half the length (the JAX engine's fixed
size behind a zero tail is XLA's static shapes). On a mesh
(parallel/mesh.py) the stack is n_dev contiguous shards, each on its own
device and holding its part of the live prefix; a shard is a group of the
grouped launches below, the shards' evals are summed across the mesh, and
the rounds move to the host once a shard holds fewer than 2 live entries.
Binds
are deferred: bind(r) launches nothing and records r; the pending fold
runs when the engine's evals are next asked for, all of a round's engines
in one grouped launch of kernel 1 (field/fold.py) per 16 shards on each
device, followed by one grouped launch of kernels 2-3 (field/evals.py)
per 16 for their evals (round_evals_many). Whatever reads the tables
(finals, the host handoff) flushes a pending fold first; flush_many
flushes several engines the same way. Once the live prefix is at most `tail_n()` entries
the remaining rounds move to the host FrVec tier.

"Passenger" tables ride along in the fold (no eval contribution) so that
instances can expose final openings of constituent polynomials (e.g. the
instruction instance proves with comb = lo + γ·left + γ²·right but must open
lo/left/right individually).

FrVec <-> device moves are byte copies: both sides hold the same 32-byte
Montgomery words.
"""

from __future__ import annotations

import os

import torch

from ..field import limb
from ..field.params import FR
from .mesh import (_psum_field, evals_by_device, folds_by_device,
                   gather_shards, resolve_device, shard_table)


P = FR.p


def tail_n() -> int:
    """Narrow-tail threshold: once the live prefix is at most this many
    entries the remaining rounds move to the host FrVec tier. The default
    (8192) was tuned for a TPU reached over a ~30 ms network round trip and
    is kept until the crossover is measured on the GPU. Read per call so
    tests and the chip smoke can pin it (0 keeps every round on the
    device)."""
    return int(os.environ.get("ZOLT_TPU_DEVICE_TAIL", "8192"))


def drain_futures(futures: list) -> list:
    """Download several instances' pending round evals in ONE device→host
    copy (one synchronisation per round per stage). Each entry is an (m, 8)
    word tensor, as round_evals_many returns it, or None, which stays None;
    each tensor decodes to m canonical ints: every kernel returns finished
    Montgomery words, so no entry needs a decode of its own."""
    live = [a for a in futures if a is not None]
    if not live:
        return [None] * len(futures)
    big = torch.cat([a.reshape(-1, 8).to(live[0].device)
                     for a in live]).to("cpu")
    out, off = [], 0
    for a in futures:
        if a is None:
            out.append(None)
            continue
        m = a.numel() // 8
        out.append(limb.decode(big[off: off + m]))
        off += m
    return out


def flush_many(engines) -> None:
    """Run the pending folds of these DeviceProductTables (None entries
    skipped) in grouped launches of kernel 1, a shard a group, 16 groups a
    launch on each device; each launch's engines drop their old shards
    before the next launch allocates, so the fold's out-of-place copies
    stay one launch wide."""
    pend = [e for e in engines if e is not None and e._pending is not None]
    slots = [(e, s) for e in pend for s in range(e.n_dev)]
    groups = [(e.shards[s], e._pending, e.live // e.n_dev) for e, s in slots]
    for e in pend:
        e._pending = None

    def done(i, tab):
        e, s = slots[i]
        e.shards[s] = tab

    folds_by_device(groups, done)


def round_evals_many(engines) -> list:
    """The (degree+1, 8) device evals of several DeviceProductTables'
    current round: their pending folds in grouped launches of kernel 1,
    then their evals in grouped launches of kernels 2-3, a shard a group
    and 16 groups a launch on each device (no host sync); a mesh engine's
    shard evals summed on its first device (mesh._psum_field).
    A None entry, or an engine whose narrow tail has moved to the host,
    gets None: callers take its round_evals. Download the futures with
    drain_futures."""
    flush_many(engines)
    on_dev = []
    for e in engines:
        if e is None:
            continue
        if e._needs_tail():
            e._to_host()
        if e._host is None:
            on_dev.append(e)
    parts = iter(evals_by_device([(t[: e.k], e.live // e.n_dev // 2,
                                   e.degree)
                                  for e in on_dev for t in e.shards]))
    evs = iter([_psum_field([next(parts) for _ in e.shards])
                for e in on_dev])
    return [next(evs) if e is not None and e._host is None else None
            for e in engines]


def as_words(v, device: torch.device) -> torch.Tensor:
    """(n, 8) words on `device` from an FrVec (copied up) or a tensor that
    must already lie there."""
    if isinstance(v, torch.Tensor):
        if v.device != device:
            raise ValueError(f"table on {v.device}, engine on {device}")
        return v
    return limb.frvec_to_words(v).to(device)


class DeviceProductTables:
    """k product tables + passengers on one device or a mesh; see module
    doc.

    n_factors tables contribute to the evals; the rest only fold. The live
    prefix is tracked host-side: `live` counts the entries after every
    bind, a pending one included. `shards` holds the stack: on one device
    one (k, live, 8) tensor; on a mesh of n_dev shards, shard s the live
    entries [s·live/n_dev, (s+1)·live/n_dev) on mesh.devices[s]."""

    def __init__(self, factor_vecs, passenger_vecs=(), degree=None,
                 device=None, mesh=None):
        self.k = len(factor_vecs)
        self.degree = degree if degree is not None else self.k
        all_vecs = list(factor_vecs) + list(passenger_vecs)

        def _n(v):
            return v.n if hasattr(v, "n") else int(v.shape[0])

        self.n = _n(all_vecs[0])
        assert all(_n(v) == self.n for v in all_vecs)
        if mesh is not None:
            # the mesh's devices replace `device`. A table that cannot give
            # every shard an even pair count (e.g. ValFinal at small trace
            # lengths) runs unsharded on the mesh's first device.
            device = mesh.devices[0]
            if self.n % (2 * mesh.size):
                mesh = None
        self.mesh = mesh
        self.n_dev = mesh.size if mesh is not None else 1
        self.device = resolve_device(device)
        self.live = self.n
        # torch.stack copies: the engine never aliases an FrVec buffer
        stack = torch.stack([as_words(v, self.device) for v in all_vecs])
        self.shards = shard_table(mesh, stack) if mesh is not None \
            else [stack]
        self._pending: int | None = None     # a bound r not yet folded
        self._host: list | None = None

    @property
    def tables(self) -> torch.Tensor | None:
        """The (k, live, 8) stack of the live entries (with a bind pending,
        the stack before its fold); on a mesh the shards' entries in
        order, gathered on its first device. None once on the host."""
        if self.shards is None:
            return None
        if self.n_dev == 1:
            return self.shards[0]
        return gather_shards(self.shards, self.device)

    # -- host tail ----------------------------------------------------------
    def _needs_tail(self) -> bool:
        if self._host is not None:
            return False
        if self.live <= tail_n():
            return True
        return self.mesh is not None and self.live // self.n_dev < 2

    def _to_host(self) -> None:
        """Move the live prefixes to host FrVecs for the narrow-tail rounds
        (only the live prefix crosses to the host): a pending fold runs
        first, on every shard, then the shards' entries are gathered in
        shard order."""
        if self._host is not None:
            return
        flush_many([self])
        arr = gather_shards(self.shards, "cpu")
        self._host = [limb.words_to_frvec(arr[j]) for j in range(arr.shape[0])]
        self.shards = None

    # -- protocol ------------------------------------------------------------
    def round_evals_device(self):
        """The (degree+1, 8) evals as a device tensor (no host sync), or None
        once the narrow tail has moved to host (callers then use
        round_evals): round_evals_many over this engine alone."""
        return round_evals_many([self])[0]

    def _tail_round_evals(self) -> list[int]:
        from ..native.frvec import FrVec

        if self.live // 2 == 0:
            return [0] * (self.degree + 1)
        return FrVec.prod_evals_adj(self._host[: self.k], self.degree)

    def round_evals(self) -> list[int]:
        dev = self.round_evals_device()
        if dev is None:
            return self._tail_round_evals()
        return drain_futures([dev])[0]

    def bind(self, r: int) -> None:
        """Fold every table by r: on the device, deferred to the next
        evals or read (one pending fold at most; a second bind flushes
        the first)."""
        if self._needs_tail():
            self._to_host()
        if self.live // 2 == 0:
            return
        if self._host is not None:
            self._host = [v.fold_adj(r) for v in self._host]
        else:
            flush_many([self])
            self._pending = r % P
        self.live //= 2

    def finals(self) -> list[int]:
        """First element of every table (factors then passengers)."""
        if self._host is not None:
            return [v.first() for v in self._host]
        flush_many([self])
        return limb.decode(self.shards[0][:, 0])
