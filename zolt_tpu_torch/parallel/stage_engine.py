"""Single-device engine for dense product-sumcheck instances (torch).

Most of the Jolt schedule's instances reduce per round to the same two
primitives over k dense tables (ValEvaluation: inc·wa·lt deg-3; ValFinal:
inc·wa deg-2 or 3; InstructionLookupsClaimReduction: eq·comb deg-2; the
Gruen instances factor their eq weight separately — see zkvm/device_outer):

    evals[t] = Σ_i Π_k (lo_k[i] + t·(hi_k[i] − lo_k[i]))   t = 0..degree
    fold:      tab_k[i] ← lo_k[i] + r·(hi_k[i] − lo_k[i])

The port of zolt_tpu/parallel/stage_engine.py for one device. An engine's
tables are one (k, live, 8) int32 stack of Montgomery words holding the
live prefix only: each fold writes a new stack of half the length (the
JAX engine's fixed size behind a zero tail is XLA's static shapes). Binds
are deferred: bind(r) launches nothing and records r; the pending fold
runs when the engine's evals are next asked for, all of a round's engines
in one grouped launch of kernel 1 (field/fold.py) per 16 engines,
followed by one grouped launch of kernels 2-3 (field/evals.py) per 16 for
their evals (round_evals_many). Whatever reads the tables (finals, the
host handoff) flushes a pending fold first; flush_many flushes several
engines the same way. Once the live prefix is at most `tail_n()` entries
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
from ..field.evals import product_evals
from ..field.fold import fold_many
from ..field.params import FR


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
    big = torch.cat([a.reshape(-1, 8) for a in live]).to("cpu")
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
    skipped) in grouped launches of kernel 1, 16 engines a launch; each
    launch's engines drop their old stacks before the next launch
    allocates, so the fold's out-of-place copies stay one launch wide."""
    pend = [e for e in engines if e is not None and e._pending is not None]

    def done(i, tabs):
        pend[i].tables, pend[i]._pending = tabs, None

    fold_many(((e.tables, e._pending, e.live) for e in pend), done)


def round_evals_many(engines) -> list:
    """The (degree+1, 8) device evals of several DeviceProductTables'
    current round: their pending folds in grouped launches of kernel 1,
    then their evals in grouped launches of kernels 2-3, 16 engines a
    launch (no host sync).
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
    evs = iter(product_evals([(e.tables[: e.k], e.live // 2, e.degree)
                              for e in on_dev]))
    return [next(evs) if e is not None and e._host is None else None
            for e in engines]


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


def as_words(v, device: torch.device) -> torch.Tensor:
    """(n, 8) words on `device` from an FrVec (copied up) or a tensor that
    must already lie there."""
    if isinstance(v, torch.Tensor):
        if v.device != device:
            raise ValueError(f"table on {v.device}, engine on {device}")
        return v
    return limb.frvec_to_words(v).to(device)


class DeviceProductTables:
    """k product tables + passengers on one device; see module doc.

    n_factors tables contribute to the evals; the rest only fold. The live
    prefix is tracked host-side: `live` counts the entries after every
    bind, a pending one included."""

    def __init__(self, factor_vecs, passenger_vecs=(), degree=None,
                 device=None):
        self.k = len(factor_vecs)
        self.degree = degree if degree is not None else self.k
        all_vecs = list(factor_vecs) + list(passenger_vecs)

        def _n(v):
            return v.n if hasattr(v, "n") else int(v.shape[0])

        self.n = _n(all_vecs[0])
        assert all(_n(v) == self.n for v in all_vecs)
        self.device = resolve_device(device)
        self.live = self.n
        # torch.stack copies: the engine never aliases an FrVec buffer
        self.tables = torch.stack([as_words(v, self.device)
                                   for v in all_vecs])
        self._pending: int | None = None     # a bound r not yet folded
        self._host: list | None = None

    # -- host tail ----------------------------------------------------------
    def _needs_tail(self) -> bool:
        return self._host is None and self.live <= tail_n()

    def _to_host(self) -> None:
        """Move the live prefixes to host FrVecs for the narrow-tail rounds
        (only the live prefix crosses to the host)."""
        if self._host is not None:
            return
        flush_many([self])
        arr = self.tables.to("cpu")               # the live prefix
        self._host = [limb.words_to_frvec(arr[j]) for j in range(arr.shape[0])]
        self.tables = None

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
        return limb.decode(self.tables[:, 0])
