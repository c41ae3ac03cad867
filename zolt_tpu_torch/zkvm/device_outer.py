"""Single-device backend for the stage-1 streaming-outer remaining rounds
(and stage 2's ProductVirtualRemainder, which has the same shape).

The host prover (streaming_outer.StreamingOuterProver) drives the Gruen cubic
rounds with two O(n) inner loops per round: the (t0, t∞) evaluation sums and
the az/bz fold:

  t0 = Σ_i e_i·az0_i·bz0_i      t∞ = Σ_i e_i·(az1_i−az0_i)(bz1_i−bz0_i)
  e_i = E_out[i >> h_in] · E_in[i & (2^h_in − 1)]   (Gruen prefix tables)
  fold: az'[i] = az[2i] + r·(az[2i+1] − az[2i])      (and likewise bz)

matching the reference's hot-loop structure
(src/zkvm/spartan/streaming_outer.zig:1577-1679, fold :1681-1722).

The port of zolt_tpu/zkvm/device_outer.py DeviceOuterRounds. az/bz are
one (2, live, 8) word stack holding the live prefix only; the Gruen eq
prefix-table stacks go to the device once per prover as flat buffers and
each round passes only level offsets. Kernel 4 (field/gruen.py) runs one
pass a round: the challenge exists only after a round's evals are
absorbed, so bind(r) launches nothing and records r, and the next round's
pass folds by it and evaluates the folded tables (the first round only
evaluates). Reading the tables (final_values, the host handoff) flushes a
pending fold by a fold-only pass. Rounds whose live prefix is at most
`tail_n()` finish on the host FrVec tier.

With mesh=, DeviceOuterRounds shards az/bz over a mesh (parallel/mesh.py) in contiguous
blocks: shard s holds the live entries [s·live/n_dev, (s+1)·live/n_dev)
and runs kernel 4 on its device, at the level offsets of its first global
pair g = s·q (q the local pairs of the round): off_out + (g >> h_in),
off_in + (g & (2^h_in − 1)). That is exact both when q ≥ 2^h_in (g & mask
= 0, and local pair i's E_out row is (g >> h_in) + (i >> h_in)) and when
q < 2^h_in (g >> h_in is the shard's one E_out row and g & mask + i stays
below 2^h_in), so the kernel is the single-device one. The shards' (t0,
t∞) are summed across the mesh; once a shard holds less than one live
pair the rounds move to the host, as in JAX.
"""

from __future__ import annotations

import torch

from ..field import limb
from ..field.gruen import gruen_round
from ..field.params import FR
from ..parallel.mesh import _psum_field, gather_shards, shard_table
from ..parallel.stage_engine import as_words, resolve_device, tail_n

P = FR.p


def _flat_stack(levels: list[list[int]], device) -> torch.Tensor:
    """Flatten a doubling eq-table stack (level k has 2^k entries, offset
    2^k − 1) into one (2^{K+1}−1, 8) Montgomery word buffer on the device,
    so per-round traffic is a handful of scalars."""
    flat: list[int] = []
    for lvl in levels:
        flat.extend(v % P for v in lvl)
    return limb.encode(flat, device=device)


def _gruen_level_args(se) -> tuple[int, int, int, int]:
    """Per-round (off_out, off_in, h_in, head_out) level offsets into the
    flat stacks, mirroring the host window selection
    (getWindowEqTables(·, 1), reference src/poly/split_eq.zig:311-351)."""
    head = se.current_index - 1
    head_out = min(head, se.m)
    head_in = head - head_out
    lvl_out = min(head_out, len(se.E_out_vec) - 1)
    lvl_in = min(head_in, len(se.E_in_vec) - 1)
    return (1 << lvl_out) - 1, (1 << lvl_in) - 1, head_in, head_out


def _gruen_tail_evals(se, az_fr, bz_fr, live: int) -> tuple[int, int]:
    """Host-tier (t0, t∞) via the native FrVec kernel — the narrow-tail
    rounds where a device launch would be pure latency."""
    from ..native.frvec import FrVec

    n2 = live // 2
    if n2 == 0:
        return 0, 0
    head = se.current_index - 1
    head_out = min(head, se.m)
    h_in = head - head_out
    e_out = se.E_out_vec[min(head_out, len(se.E_out_vec) - 1)]
    e_in = se.E_in_vec[min(h_in, len(se.E_in_vec) - 1)]
    n_out = max(1, n2 >> h_in)
    n_in = min(1 << h_in, n2)
    return FrVec.gruen_quad(FrVec.from_ints(e_out[:n_out]),
                            FrVec.from_ints(e_in[:n_in]), h_in,
                            az_fr, bz_fr, n2)


class DeviceOuterRounds:
    """The device backend, on one device or, with mesh=, sharded over a
    mesh (see module doc; JAX's MeshOuterRounds). az/bz
    live on the device as Montgomery words; the host keeps only the
    split-eq scalars (cubic-poly bookkeeping). Attach the prover's
    GruenSplitEq once — its prefix-table stacks become device-resident
    and every round passes only level offsets."""

    def __init__(self, az, bz, se=None, device=None, mesh=None):
        n = az.n if hasattr(az, "n") else len(az)
        self.n = n                       # initial size
        self.live = n                    # live prefix after every bind
        if mesh is not None:
            device = mesh.devices[0]
            if n % (2 * mesh.size):
                raise ValueError(f"{n} entries do not give each of "
                                 f"{mesh.size} shards an even pair count")
        self.mesh = mesh
        self.n_dev = mesh.size if mesh is not None else 1
        self.device = resolve_device(device)
        stack = torch.stack([as_words(az, self.device),
                             as_words(bz, self.device)])
        self.shards = shard_table(mesh, stack) if mesh is not None \
            else [stack]
        self._pending = None             # a bound r not yet folded
        self.se = None
        self._fr = None                  # (az, bz) FrVecs once on the tail
        if se is not None:
            self.attach_eq(se)

    @property
    def tabs(self):
        """The (2, live, 8) az/bz stack (with a bind pending, the stack
        before its fold); on a mesh the shards' entries in order, gathered
        on its first device. None once on the host."""
        if self.shards is None:
            return None
        if self.n_dev == 1:
            return self.shards[0]
        return gather_shards(self.shards, self.device)

    def attach_eq(self, se) -> None:
        """The eq prefix-table stacks, one copy on each device of the
        shards."""
        self.se = se
        self._eq = {}
        for t in self.shards:
            if t.device not in self._eq:
                self._eq[t.device] = (_flat_stack(se.E_out_vec, t.device),
                                      _flat_stack(se.E_in_vec, t.device))

    def num_pairs(self) -> int:
        return self.live // 2

    def _flush(self) -> None:
        """Run a pending fold alone (a fold-only pass on every shard)."""
        if self._pending is not None:
            loc = self.live // self.n_dev
            self.shards = [gruen_round(t, self._pending, None, None, 0, 0, 0,
                                       loc, eval=False)[0]
                           for t in self.shards]
            self._pending = None

    def _maybe_tail(self) -> None:
        if self._fr is not None:
            return
        if self.live > tail_n() and (self.mesh is None
                                     or self.live // (2 * self.n_dev) >= 1):
            return
        self._to_host()

    def _to_host(self) -> None:
        """The live entries to host FrVecs: a pending fold first, then the
        shards gathered in shard order."""
        self._flush()
        arr = gather_shards(self.shards, "cpu")
        self._fr = (limb.words_to_frvec(arr[0]), limb.words_to_frvec(arr[1]))
        self.shards = None

    def round_evals_device(self):
        """(2, 8) device tensor [t0, t∞] — no host sync — or None once on
        the host tail; callers batch the download across instances (one
        transfer per round per stage)."""
        self._maybe_tail()
        if self._fr is not None:
            return None
        off_out, off_in, h_in, _ = _gruen_level_args(self.se)
        # with a pending r: fold the live pairs by it, then evaluate the
        # folded tables' pairs in the same pass
        r, self._pending = self._pending, None
        loc = self.live // self.n_dev
        q = loc // 2                     # each shard's pairs this round
        mask = (1 << h_in) - 1
        parts = []
        for s, t in enumerate(self.shards):
            g = s * q                    # the shard's first global pair
            e_out, e_in = self._eq[t.device]
            self.shards[s], ev = gruen_round(
                t, r, e_out, e_in, off_out + (g >> h_in), off_in + (g & mask),
                h_in, loc if r is not None else q)
            parts.append(ev)
        return _psum_field(parts)

    def round_evals(self) -> tuple[int, int]:
        dev = self.round_evals_device()
        if dev is None:
            return _gruen_tail_evals(self.se, self._fr[0], self._fr[1],
                                     self.live)
        t0, tinf = limb.decode(dev)
        return t0, tinf

    def bind(self, r: int) -> None:
        """Fold az/bz by r: on the device, deferred to the next round's
        pass or read (one pending fold at most; a second bind flushes the
        first)."""
        self._maybe_tail()
        if self.live <= 1:
            return
        if self._fr is not None:
            self._fr = (self._fr[0].fold_adj(r), self._fr[1].fold_adj(r))
        else:
            self._flush()
            self._pending = r % P
        self.live //= 2

    def final_values(self) -> tuple[int, int]:
        if self._fr is None and self.n_dev > 1:
            self._to_host()
        if self._fr is not None:
            return self._fr[0].first(), self._fr[1].first()
        self._flush()
        a, b = limb.decode(self.shards[0][:, 0])
        return a, b

