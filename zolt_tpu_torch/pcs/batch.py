"""Batch opening accumulator: reduce many committed-polynomial opening
claims to ONE Dory opening, then verify it algebraically.

This is the PCS-binding layer the Jolt-format verifier uses in sound mode:
every committed-poly evaluation consumed by the stage output checks is
re-proven against the absorbed GT commitments, closing the
"prover-supplied claim map" channel (reference's accumulator surface:
src/poly/commitment/batch.zig:72-218 — a KZG-style γ-RLC batcher; here the
claims sit at DIFFERENT points, so we first run the standard Jolt
opening-proof-reduction sumcheck, then γ-RLC at the single reduced point).

Protocol (prover and verifier share the live Fiat-Shamir transcript):
  claims: {(C_i, q_i, v_i)} with q_i a big-endian MLE point (q[0] ↔ MSB of
  the table index) over n_i ≤ N variables, v_i = f_i(q_i).
  1. ρ ← transcript. Sumcheck over g(x) = Σ_i ρ^i·eq(q_i,x)·f_i(x), claim
     Σ_i ρ^i·v_i, N rounds (big-endian: round j binds the MSB), degree 2.
  2. Prover sends finals f_i(r*); verifier checks
     Σ_i ρ^i·eq(q_i,r*)·f_i(r*) == final sumcheck claim.
  3. γ ← transcript. Joint poly F = Σ_i γ^i·f_i (zero-padded to 2^N), joint
     value v* = Σ_i γ^i·f_i(r*), joint commitment C* = Π_i C_i^{γ^i}
     (Dory GT commitments are additively homomorphic in the exponent —
     REQUIRES all polys committed with the same column width 2^{N/2}).
  4. One real Dory open/verify of (C*, r*, v*).

All claims use the big-endian convention; `to_dory_point` converts to the
Dory matrix layout (see `dory._split_point`): for an even-N point q, the
Dory point is q[ν:] + q[:ν].
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field as dfield

import torch

from ..field import limb
from ..field import tower as tw
from ..field.params import FR
from ..native.frvec import FrVec
from ..parallel import stage_engine
from . import dory

P = FR.p


# ---------------------------------------------------------------------------
# MLE helpers (big-endian: point[0] binds the MSB of the table index)
# ---------------------------------------------------------------------------

def mle_eval_be(evals: list[int], point: list[int]) -> int:
    t = [v % P for v in evals]
    n = 1 << len(point)
    if len(t) < n:
        t = t + [0] * (n - len(t))
    for p_i in point:
        h = len(t) // 2
        t = [(t[i] + p_i * (t[i + h] - t[i])) % P for i in range(h)]
    return t[0]


def eq_table_be(point: list[int]) -> list[int]:
    """eq(point, j) for all j, big-endian (point[0] ↔ MSB of j).

    Each doubling step places the new variable at the HIGH bit, so the
    last-processed coordinate owns the MSB — iterate reversed(point)."""
    out = [1]
    for p_i in reversed(point):
        p_i %= P
        nxt = [0] * (2 * len(out))
        for i, v in enumerate(out):
            y = v * p_i % P
            nxt[i + len(out)] = y
            nxt[i] = (v - y) % P
        out = nxt
    return out


def eq_eval_be(q: list[int], r: list[int]) -> int:
    out = 1
    for a, b in zip(q, r):
        out = out * ((a * b + (1 - a) * (1 - b)) % P) % P
    return out


def to_dory_point(q_be: list[int]) -> list[int]:
    """Big-endian MLE point → Dory matrix point (inverse of the split in
    `dory._split_point`: dory binds cols with point[:σ], rows with
    point[σ:], both big-endian; rows are the high index bits)."""
    n = len(q_be)
    sigma = (n + 1) // 2
    nu = n - sigma
    return q_be[nu:] + q_be[:nu]


# ---------------------------------------------------------------------------
# Claims
# ---------------------------------------------------------------------------

@dataclass
class BatchClaim:
    """One committed-poly opening claim.

    commitment: 384-byte GT bytes (as absorbed into the transcript).
    point_be:   big-endian evaluation point, len ≤ N.
    value:      claimed evaluation.
    evals:      prover side only — the committed table (len ≤ 2^N).
    """

    commitment: bytes
    point_be: list[int]
    value: int
    evals: list[int] | None = None


@dataclass
class BatchOpeningProof:
    round_polys: list[list[int]] = dfield(default_factory=list)  # 3 evals each
    finals: list[int] = dfield(default_factory=list)
    dory_proof: dory.DoryProof | None = None


def _pad_point(q: list[int], n: int) -> list[int]:
    return [0] * (n - len(q)) + [c % P for c in q]


def _absorb_round(transcript, evals3: list[int]) -> int:
    transcript.append_message(b"BatchOpen_round")
    for e in evals3:
        transcript.append_scalar(e % P)
    return transcript.challenge_scalar()


# ---------------------------------------------------------------------------
# Prover
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _bitrev_index(nv: int, device: torch.device) -> torch.Tensor:
    """The permutation j -> bit-reverse_nv(j) as an int64 index on
    `device`."""
    idx = torch.arange(1 << nv, dtype=torch.int64)
    rev = torch.zeros_like(idx)
    for b in range(nv):
        rev |= ((idx >> b) & 1) << (nv - 1 - b)
    return rev.to(device)


def _bitrev_words(v: FrVec, nv: int, device) -> torch.Tensor:
    """v's 2^nv Montgomery words on `device` in bit-reversed index order: a
    byte copy up, then one row gather there."""
    assert v.n == 1 << nv
    dev = stage_engine.resolve_device(device)
    return limb.frvec_to_words(v).to(dev).index_select(
        0, _bitrev_index(nv, dev))


def prove_batch_opening(transcript, claims: list[BatchClaim], srs: dory.DorySRS,
                        num_vars: int, backend: str | None = None,
                        device=None, mesh=None) -> BatchOpeningProof:
    """Run the reduction + joint Dory opening. `num_vars` must be even and
    ≥ every claim's point length; srs must cover num_vars.

    Factored-eq fast path (byte-identical to the dense O(claims·N·2^N)
    schedule): a claim with n_i point variables is, after zero-padding to N
    variables, eq(0,x_hi)·eq(q_i,x_lo)·f_i(x_lo). While round k binds a
    padded variable (k < N−n_i) both the eq table's x_k=1 half and the f
    table's hi half are zero, so the round contributions collapse to
    a0 = a2 = Π_{j<k}(1−r_j)²·v_i with no table work at all, and the fold
    just multiplies both tables by (1−r). Only when its own variables start
    binding does the claim materialize size-2^{n_i} tables — total work
    O(Σ_i 2^{n_i}) instead of O(claims·N·2^N). Table work runs on the native
    Fr runtime (FrVec) when available.

    backend="device" runs each active group's wide rounds on `device`
    through the shared product engine (parallel/stage_engine): a group is
    a 2-factor degree-2 instance over its f-table and merged-eq table. The
    engine folds ADJACENT pairs (LSB binding) while this protocol binds the
    MSB first, so device tables upload in BIT-REVERSED index order — f via
    one row gather on the device, the merged eq for free as
    eq_table_be(reversed(q)) — making the two schedules element-for-element
    identical; round sums are the same terms in a different order, so the
    transcript (and proof bytes) are unchanged. Every round evaluates all
    active device groups together (round_evals_many: one grouped fold
    launch and one grouped product-evals launch per 16 groups) with one
    download. Narrow tails hand back to the host FrVec tier inside the
    engine. Groups at or below the tail threshold stay on the host from
    the start. backend="mesh" shards each device group's tables over
    `mesh` (its first device is `device`'s place); a group too small to
    give every shard an even pair count runs unsharded there."""
    assert num_vars % 2 == 0, "pad to an even num_vars (square Dory layout)"
    n_tab = 1 << num_vars
    proof = BatchOpeningProof()

    transcript.append_scalar(len(claims))
    rho = transcript.challenge_scalar()

    # Per-claim state: dormant until round N−n_i, then live tables.
    n_claims = len(claims)
    n_is = []            # point lengths
    fs = []              # raw (unpadded) eval tables, reduced mod P
    vals = []            # claimed values mod P
    coeffs = []
    c_pow = 1
    claim_sum = 0
    for cl in claims:
        n_i = len(cl.point_be)
        assert n_i <= num_vars
        f = cl.evals if isinstance(cl.evals, FrVec) \
            else [v % P for v in cl.evals]
        assert len(f) <= (1 << n_i)
        n_is.append(n_i)
        fs.append(f)
        vals.append(cl.value % P)
        coeffs.append(c_pow)
        claim_sum = (claim_sum + c_pow * cl.value) % P
        c_pow = c_pow * rho % P

    # Dedupe: claims over the SAME eval table with the same point length
    # share one f-table (the fold challenges are shared, so their folded
    # tables stay identical forever), and their eq tables merge by linearity
    # into Σ_i c_i·eq(q_i,·) — the round polys are byte-identical to the
    # per-claim schedule, with ~half the table memory and fold work.
    gkey: dict = {}
    group_of: list[int] = []
    g_members: list[list[int]] = []
    for i, cl in enumerate(claims):
        key = (id(cl.evals), n_is[i])
        g = gkey.get(key)
        if g is None:
            g = gkey[key] = len(g_members)
            g_members.append([])
        group_of.append(g)
        g_members[g].append(i)
    n_groups = len(g_members)
    g_n = [n_is[m[0]] for m in g_members]
    g_sf = [1] * n_groups   # Π(1−r) accumulated while dormant (f scalar)
    g_se = [1] * n_groups   # same for the merged eq table
    g_f: list[FrVec | None] = [None] * n_groups
    g_e: list[FrVec | None] = [None] * n_groups
    g_cow = [False] * n_groups  # f-table shared with the caller: first fold
                                #   must write a fresh buffer
    use_dev = backend in ("device", "mesh")
    if backend == "mesh":
        device = mesh.devices[0]
    else:
        mesh = None
    g_eng: dict[int, object] = {}   # group -> DeviceProductTables
    g_fin: dict[int, int] = {}      # device groups' fully-bound f(r*)

    def _dev_min() -> int:
        # groups at or below the narrow-tail threshold would go straight to
        # the engine's host tail — keep them on the direct host path
        return stage_engine.tail_n()

    # Many claims open at the SAME point (e.g. all stage-1 openings at
    # r_outer): build each distinct point's eq table once and reuse it as
    # the read side of the per-claim merges.
    _eq_cache: dict = {}

    def _eq_of(q: list[int]) -> FrVec:
        key = tuple(q)
        et = _eq_cache.get(key)
        if et is None:
            et = _eq_cache[key] = FrVec.eq_table_be(q)
        return et

    def _activate(g: int) -> None:
        members = g_members[g]
        f = fs[members[0]]
        n_i = g_n[g]
        if isinstance(f, FrVec):
            if f.n == (1 << n_i):
                fv = f               # copy-on-write (see g_cow)
                g_cow[g] = True
            else:
                fv = f.zero_padded_copy(1 << n_i)
        else:
            fv = FrVec.from_ints(f + [0] * ((1 << n_i) - len(f)))
        et = None
        for i in members:
            q = [c % P for c in claims[i].point_be]
            if i == 0:
                # Prover-side bookkeeping check (the verifier enforces the
                # real binding): the FIRST claim is checked so a caller
                # wiring inconsistent claims fails here with a pinpointed
                # assert instead of only at verification.
                assert fv.mle_eval_be(q) == vals[i], (
                    f"claim {i} value != f(q) — inconsistent opening claim")
            dev = use_dev and (1 << n_i) > max(_dev_min(), 4)
            qk = tuple(reversed(q)) if dev else tuple(q)
            if et is None:
                et = _eq_of(qk).scale(coeffs[i])
            else:
                et.axpy_(_eq_of(qk), coeffs[i])
        if use_dev and (1 << n_i) > max(_dev_min(), 4):
            # device group: bit-reversed f (one row gather on the device);
            # the merged eq was built from REVERSED points, which IS the
            # bit-reversed eq table (eq factors per bit commute)
            g_eng[g] = stage_engine.DeviceProductTables(
                [_bitrev_words(fv, n_i, device), et], degree=2, device=device,
                mesh=mesh)
            g_f[g] = fv      # "active" marker; the engine owns the state
            g_e[g] = None
            return
        g_f[g] = fv
        g_e[g] = et

    for g in range(n_groups):
        if g_n[g] == num_vars:
            _activate(g)

    # sumcheck: N rounds, degree 2, bind MSB first
    r_star: list[int] = []
    cur = claim_sum
    for k in range(num_vars):
        # device groups: every engine's pending fold and round evals in
        # grouped launches, then ONE download (an engine whose narrow tail
        # has moved to the host gets None, and its host round_evals)
        dev_vals: dict[int, list[int]] = {}
        if g_eng:
            gs = list(g_eng)
            futs = stage_engine.round_evals_many([g_eng[g] for g in gs])
            for g, vals_g in zip(gs, stage_engine.drain_futures(futs)):
                dev_vals[g] = (vals_g if vals_g is not None
                               else g_eng[g].round_evals())
        e0 = e2 = 0
        for g in range(n_groups):
            f, e = g_f[g], g_e[g]
            if f is None:  # dormant: closed-form contribution per claim
                s = g_sf[g] * g_se[g] % P
                for i in g_members[g]:
                    a = s * vals[i] % P * coeffs[i] % P
                    e0 = (e0 + a) % P
                    e2 = (e2 + a) % P
                continue
            if g in g_eng:
                a0, _, a2 = dev_vals[g]
            else:
                a0, a2 = FrVec.quad_sums_half(f, e)
            scale = g_sf[g] * g_se[g] % P
            e0 = (e0 + scale * a0) % P
            e2 = (e2 + scale * a2) % P
        e1 = (cur - e0) % P
        proof.round_polys.append([e0, e1, e2])
        r = _absorb_round(transcript, [e0, e1, e2])
        r_star.append(r)
        # p(r) via degree-2 Lagrange on {0,1,2}
        cur = _deg2_eval([e0, e1, e2], r)
        one_minus_r = (1 - r) % P
        for g in range(n_groups):
            f = g_f[g]
            if f is None:
                g_sf[g] = g_sf[g] * one_minus_r % P
                g_se[g] = g_se[g] * one_minus_r % P
                if num_vars - (k + 1) == g_n[g]:
                    _activate(g)
                continue
            if g in g_eng:
                g_eng[g].bind(r)
                continue
            if g_cow[g]:
                g_f[g] = f.fold_half_fresh(r)
                g_cow[g] = False
            else:
                g_f[g] = f.fold_half(r)
            g_e[g] = g_e[g].fold_half(r)

    # the last round's folds, one launch per 16 groups
    stage_engine.flush_many(g_eng.values())
    for g, eng in g_eng.items():
        g_fin[g] = eng.finals()[0]

    # per-claim finals (fold scalars back in; claims sharing a table share
    # the fully-bound value f(r*))
    proof.finals = [(g_fin[group_of[i]] if group_of[i] in g_eng
                     else g_f[group_of[i]].first())
                    * g_sf[group_of[i]] % P
                    for i in range(n_claims)]
    for v in proof.finals:
        transcript.append_scalar(v)

    gamma = transcript.challenge_scalar()
    # joint F = Σ γ^i·f_i; claims sharing an eval table merge their γ powers
    jv = FrVec.zeros(n_tab)
    jcoef: dict[int, int] = {}
    jorder: list[int] = []
    g_pow = 1
    for i in range(n_claims):
        key = id(fs[i])
        if key not in jcoef:
            jcoef[key] = 0
            jorder.append(i)
        jcoef[key] = (jcoef[key] + g_pow) % P
        g_pow = g_pow * gamma % P
    for i in jorder:
        f = fs[i]
        if isinstance(f, FrVec):
            fv = f if f.n == n_tab else f.zero_padded_copy(n_tab)
        else:
            fv = FrVec.from_ints(f + [0] * (n_tab - len(f)))
        jv.axpy_(fv, jcoef[id(f)])

    pt = to_dory_point(r_star)
    proof.dory_proof = dory.open_with_transcript(srs, jv, pt, transcript)
    return proof


def _deg2_eval(evals3: list[int], r: int) -> int:
    e0, e1, e2 = [v % P for v in evals3]
    # Lagrange over {0,1,2}: p(r) = e0·(r-1)(r-2)/2 − e1·r(r-2) + e2·r(r-1)/2
    inv2 = pow(2, -1, P)
    t0 = e0 * ((r - 1) * (r - 2) % P) % P * inv2 % P
    t1 = (-e1 * (r * (r - 2) % P)) % P
    t2 = e2 * (r * (r - 1) % P) % P * inv2 % P
    return (t0 + t1 + t2) % P


# ---------------------------------------------------------------------------
# Verifier
# ---------------------------------------------------------------------------

def verify_batch_opening(transcript, claims: list[BatchClaim],
                         proof: BatchOpeningProof, srs: dory.DorySRS,
                         num_vars: int) -> bool:
    """Verify the reduction sumcheck + joint Dory opening against the GT
    commitment bytes in `claims` (points re-derived by the caller from its
    own challenge bookkeeping, NOT prover data)."""
    if num_vars % 2 != 0 or len(proof.round_polys) != num_vars:
        return False
    if len(proof.finals) != len(claims):
        return False

    transcript.append_scalar(len(claims))
    rho = transcript.challenge_scalar()
    coeffs = []
    c_pow = 1
    cur = 0
    for cl in claims:
        coeffs.append(c_pow)
        cur = (cur + c_pow * cl.value) % P
        c_pow = c_pow * rho % P

    r_star: list[int] = []
    for evals3 in proof.round_polys:
        e0, e1 = evals3[0] % P, evals3[1] % P
        if (e0 + e1) % P != cur:
            return False
        r = _absorb_round(transcript, evals3)
        r_star.append(r)
        cur = _deg2_eval(evals3, r)

    for v in proof.finals:
        transcript.append_scalar(v % P)

    # reduction consistency: Σ ρ^i·eq(q_i, r*)·f_i(r*) == final claim
    acc = 0
    for c_i, cl, fin in zip(coeffs, claims, proof.finals):
        q = _pad_point(cl.point_be, num_vars)
        acc = (acc + c_i * (eq_eval_be(q, r_star) * (fin % P) % P)) % P
    if acc != cur:
        return False

    gamma = transcript.challenge_scalar()
    v_star = 0
    g_pow = 1
    c_star = tw.FP12_ONE
    for cl, fin in zip(claims, proof.finals):
        v_star = (v_star + g_pow * (fin % P)) % P
        c_star = tw.fp12_mul(c_star, tw.fp12_pow(tw.fp12_from_bytes(cl.commitment), g_pow))
        g_pow = g_pow * gamma % P

    pt = to_dory_point(r_star)
    return dory.verify_with_transcript(srs, c_star, pt, v_star,
                                       proof.dory_proof, transcript)


# ---------------------------------------------------------------------------
# Serialization (ZOLT-native container section)
# ---------------------------------------------------------------------------

def serialize_batch_opening(proof: BatchOpeningProof) -> bytes:
    import struct

    out = [struct.pack("<II", len(proof.round_polys), len(proof.finals))]
    for rp in proof.round_polys:
        for v in rp:
            out.append((v % P).to_bytes(32, "little"))
    for v in proof.finals:
        out.append((v % P).to_bytes(32, "little"))
    dp = dory.serialize_dory_proof(proof.dory_proof)
    out.append(struct.pack("<I", len(dp)))
    out.append(dp)
    return b"".join(out)


def deserialize_batch_opening(data: bytes) -> tuple[BatchOpeningProof, int]:
    import struct

    n_rounds, n_finals = struct.unpack_from("<II", data, 0)
    off = 8
    proof = BatchOpeningProof()
    for _ in range(n_rounds):
        rp = []
        for _ in range(3):
            rp.append(int.from_bytes(data[off:off + 32], "little"))
            off += 32
        proof.round_polys.append(rp)
    for _ in range(n_finals):
        proof.finals.append(int.from_bytes(data[off:off + 32], "little"))
        off += 32
    (dp_len,) = struct.unpack_from("<I", data, off)
    off += 4
    proof.dory_proof = dory.deserialize_dory_proof(data[off:off + dp_len])
    off += dp_len
    return proof, off
