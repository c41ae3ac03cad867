"""Reference-parity internal prover (the non-Jolt "ZOLT" proof format).

Mirrors src/zkvm/mod.zig:366-440 (prove) + src/zkvm/prover.zig:241-1160
(MultiStageProver) byte-for-byte:

  Keccak transcript "Jolt" → absorb inputs → HyperKZG-commit bytecode /
  memory-values / rd-values polys (deterministic τ=0x12345678 SRS) → absorb
  the five 64-byte commitment blobs → six stages:

  S1 JoltR1CS Spartan (eq·Az·Bz, identically zero for a valid witness;
     13 zero round polys absorbed as round_poly_0/1/2) — prover.zig:350-452
  S2 RAM RAF (ra empty above RAM_START for pure-register programs) — :468-564
  S3 Lasso (eq-weighted index-bit sumcheck over the lookup indices) — :579-700
  S4 RAM ValEvaluation (inc·wa·lt) — :713-817
  S5 register-eq sumcheck over rd one-hot — :830-962
  S6 booleanity (violations ≡ 0) — :991-1111

Only stage 1 absorbs round polys; stages 2-6 only squeeze labeled challenges.
Serialization is the "ZOLT" v1 container (serialization.zig:283-447).

The port of zolt_tpu/zkvm/internal.py. `prove_internal(..., device)`
computes the JAX package's values with the device doing three parts of
the work (the GPU by default; device="cpu" runs the kernels' plain torch
versions):
the three commitments by the device Pippenger (msm/pippenger.py: the
digits by kernel E, the sums by C and D), stage 1's Az/Bz openings by
folds (kernel 1), and stage 4's ValEvaluation engine (kernels 1-3);
with_openings=True also opens on the device (pcs/hyperkzg.batch_open).
The rest is host Python, as in JAX.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field as dfield
from functools import lru_cache

from ..field import limb
from ..field.params import FR
from ..msm import pippenger
from ..pcs import srs as srs_mod
from ..poly import dense
from ..r1cs import constraints as rc
from ..r1cs import inputs as ri
from ..transcript import KeccakTranscript
from ..utils.log import metrics
from ..vm.layout import RAM_START_ADDRESS
from .commitments import jolt_lookup_index
from .prover import require_device

P = FR.p

LOG_REGS = 5  # log2(32)


def _next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def _ceil_log2(n: int) -> int:
    return 0 if n <= 1 else (n - 1).bit_length()


def _eq_le(r: list[int], idx: int) -> int:
    out = 1
    for i, ri in enumerate(r):
        out = out * (ri if (idx >> i) & 1 else (1 - ri)) % P
    return out


@dataclass
class StageProof:
    round_polys: list[list[int]] = dfield(default_factory=list)
    challenges: list[int] = dfield(default_factory=list)
    final_claims: list[int] = dfield(default_factory=list)


@dataclass
class InternalProof:
    bc_commitment: tuple | None = None
    mem_commitment: tuple | None = None
    reg_commitment: tuple | None = None
    log_t: int = 0
    log_k: int = 0
    stage_proofs: list[StageProof] = dfield(default_factory=list)
    # optional sound extension (prove_internal(with_openings=True)): a
    # HyperKZG γ-RLC batch opening of the three committed polys; NOT part
    # of the serialized ZOLT v1 container (byte format unchanged)
    kzg_batch_opening: object = None
    kzg_batch_point: list[int] | None = None

    def serialize(self) -> bytes:
        """ZOLT v1 container (serialization.zig:283-330)."""
        out = [b"ZOLT", struct.pack("<I", 1)]
        zero64 = b"\x00" * 64

        def commit_bytes(c):
            if c is None:
                return zero64
            return c[0].to_bytes(32, "big") + c[1].to_bytes(32, "big")

        out += [commit_bytes(self.bc_commitment), zero64, zero64, b"\x00" * 32]
        out += [commit_bytes(self.mem_commitment), zero64, zero64, zero64]
        out += [commit_bytes(self.reg_commitment), zero64, zero64, zero64]
        # R1CSProof placeholder (spartan/mod.zig:71-94)
        out += [struct.pack("<Q", 1), b"\x00" * 32,         # tau
                b"\x00" * 96,                                # eval_claims
                struct.pack("<Q", 1), b"\x00" * 32,          # eval_point
                b"\x00" * 64,                                # claim + final_eval
                struct.pack("<QQ", 0, 0)]                    # rounds, final_point
        out.append(b"\x01")
        out.append(struct.pack("<QQ", self.log_t, self.log_k))
        for sp in self.stage_proofs:
            out.append(struct.pack("<Q", len(sp.round_polys)))
            for poly in sp.round_polys:
                out.append(struct.pack("<Q", len(poly)))
                out += [(v % P).to_bytes(32, "little") for v in poly]
            out.append(struct.pack("<Q", len(sp.challenges)))
            out += [(v % P).to_bytes(32, "little") for v in sp.challenges]
            out.append(struct.pack("<Q", len(sp.final_claims)))
            out += [(v % P).to_bytes(32, "little") for v in sp.final_claims]
        return b"".join(out)


def _kzg_commit(srs, poly, device="cuda"):
    """Σ_i poly[i]·τ^i·G over the first min(len(poly), srs_degree)
    coefficients (a poly longer than the SRS is cut to its first
    srs_degree, as the reference's zip does); None, the identity, where
    every coefficient, or every committed one, is zero. On a device: the
    coefficients' Fr words go up, kernel E cuts their digits and the
    Pippenger (C, D) sums the SRS's cached table there."""
    vals = [v % P for v in poly][: len(srs.powers_g1)]
    if not any(vals):
        return None
    return pippenger.srs_msm(srs, pippenger.scalar_digits(
        limb.encode(vals, device=device)))


def _commit_bytes_for_transcript(c) -> bytes:
    if c is None:
        return b"\x00" * 64
    return c[0].to_bytes(32, "big") + c[1].to_bytes(32, "big")


# ---------------------------------------------------------------------------
# Stage provers
# ---------------------------------------------------------------------------

def _stage1(padded_steps, witness_rows, transcript,
            device="cuda") -> StageProof:
    sp = StageProof()
    n_cycles = len(padded_steps)
    total = n_cycles * rc.NUM_CONSTRAINTS
    padded_c = _next_pow2(total)
    log_n = padded_c.bit_length() - 1
    tau = [transcript.challenge_scalar(b"spartan_tau") for _ in range(log_n)]

    az = [0] * padded_c
    bz = [0] * padded_c
    for cycle, row in enumerate(witness_rows):
        for i, (cond, left, right) in enumerate(rc.CONSTRAINTS):
            idx = cycle * rc.NUM_CONSTRAINTS + i
            az[idx] = rc.lc_eval(cond, row)
            bz[idx] = (rc.lc_eval(left, row) - rc.lc_eval(right, row)) % P

    # eq table over tau, big-endian (EqPolynomial.evals)
    eq = [1]
    for t in tau:
        nxt = []
        for v in eq:
            nxt.append(v * (1 - t) % P)
            nxt.append(v * t % P)
        eq = nxt
    combined = [eq[i] * az[i] % P * bz[i] % P for i in range(padded_c)]

    sp.final_claims.append(sum(combined) % P)
    cur = combined
    cur_len = padded_c
    for _ in range(log_n):
        if cur_len <= 1:
            p0 = cur[0] if cur_len == 1 else 0
            poly = [p0, 0, 0]
        else:
            half = cur_len // 2
            p0 = sum(cur[2 * i] for i in range(half)) % P
            p1 = sum(cur[2 * i + 1] for i in range(half)) % P
            poly = [p0, p1, (2 * p1 - p0) % P]
        sp.round_polys.append(poly)
        transcript.append_scalar(b"round_poly_0", poly[0])
        transcript.append_scalar(b"round_poly_1", poly[1])
        transcript.append_scalar(b"round_poly_2", poly[2])
        r = transcript.challenge_scalar(b"spartan_round")
        sp.challenges.append(r)
        if cur_len > 1:
            half = cur_len // 2
            cur = [((1 - r) * cur[2 * i] + r * cur[2 * i + 1]) % P
                   for i in range(half)]
            cur_len = half

    sp.final_claims.append(cur[0] if cur else 0)

    def mle(evals, point):
        """The little-endian MLE at `point`, by folds on `device`."""
        return dense.evaluate(limb.encode(evals, device=device), point)

    sp.final_claims.append(mle(az, sp.challenges))
    sp.final_claims.append(mle(bz, sp.challenges))
    sp.final_claims.append(0)  # Cz ≡ 0
    return sp


def _stage2(accesses, transcript, log_t: int, log_k: int,
            start_address: int) -> StageProof:
    sp = StageProof()
    r_cycle = [transcript.challenge_scalar(b"r_cycle") for _ in range(log_t)]

    # ra[k] = Σ_j eq_le(r_cycle, j) over accesses at remapped address k
    # (raf_checking.zig RaPolynomial.fromTrace; eq over ceil_log2(len) vars)
    n_acc = len(accesses)
    log_acc = _ceil_log2(max(n_acc, 1)) if n_acc else 0
    k_size = 1 << log_k
    ra = [0] * k_size
    for j, a in enumerate(accesses):
        if a.address >= start_address:
            k = (a.address - start_address) // 8
            if k < k_size:
                ra[k] = (ra[k] + _eq_le(r_cycle[:log_acc], j)) % P

    claim = 0
    for k in range(k_size):
        if ra[k]:
            claim = (claim + ra[k] * (start_address + 8 * k)) % P
    sp.final_claims.append(claim)

    bound: list[int] = []
    num_vars = log_k
    for rnd in range(log_k):
        active = 1 << num_vars
        half = active // 2
        base = start_address % P
        power = 8
        for v in bound:
            base = (base + v * power) % P
            power *= 2
        s0 = s2 = 0
        for i in range(half):
            lo, hi = ra[2 * i], ra[2 * i + 1]
            at2 = (2 * hi - lo) % P
            rem = 0
            rp = power * 2
            idx = i
            for _ in range(log_k - rnd - 1):
                if idx & 1:
                    rem += rp
                idx >>= 1
                rp *= 2
            s0 = (s0 + lo * ((base + rem) % P)) % P
            s2 = (s2 + at2 * ((base + power * 2 + rem) % P)) % P
        sp.round_polys.append([s0, s2])  # stores [s(0), s(2)]
        r = transcript.challenge_scalar(b"raf_round")
        sp.challenges.append(r)
        for i in range(half):
            ra[i] = ((1 - r) * ra[2 * i] + r * ra[2 * i + 1]) % P
        num_vars -= 1
        bound.append(r)
    sp.final_claims.append(ra[0])
    return sp


def _stage3(steps, transcript, log_t: int) -> StageProof:
    sp = StageProof()
    gamma = transcript.challenge_scalar(b"lasso_gamma")
    del gamma  # sampled but unused by the round computation (prover.zig:585)
    indices = []
    for s in steps:
        if getattr(s, "is_noop", False):
            continue
        idx = jolt_lookup_index(s)
        if idx is not None:
            indices.append(idx)
    if not indices:
        return sp
    r_reduction = [transcript.challenge_scalar(b"r_reduction") for _ in range(log_t)]
    log_K = 16

    # eq(r_reduction, j): outer = log_t/2 HIGH bits, inner = rest LOW bits,
    # little-endian within each part (lasso/split_eq.zig:118-167)
    n_out = log_t // 2
    n_in = log_t - n_out

    def build(ws):
        out = [1]
        for w in ws:
            nxt = [0] * (2 * len(out))
            for j, v in enumerate(out):
                nxt[j] = v * (1 - w) % P
                nxt[j + len(out)] = v * w % P
            out = nxt
        return out

    E_out = build(r_reduction[:n_out])
    E_in = build(r_reduction[n_out:])
    padded = 1 << log_t
    eq = [0] * padded
    for j in range(padded):
        if j < len(indices):
            eq[j] = E_out[j >> n_in] * E_in[j & ((1 << n_in) - 1)] % P
    sp.final_claims.append(sum(eq) % P)

    addr_challenges = []
    eq_len = padded
    for rnd in range(log_K + log_t):
        if rnd < log_K:  # address phase: split by index bit `rnd`
            s0 = s1 = 0
            for j, idx in enumerate(indices):
                if (idx >> rnd) & 1:
                    s1 = (s1 + eq[j]) % P
                else:
                    s0 = (s0 + eq[j]) % P
            coeffs = [s0, (s1 - s0) % P, 0]
        else:  # cycle phase: fold high half
            if eq_len <= 1:
                coeffs = [eq[0] if eq_len else 0, 0, 0]
            else:
                half = eq_len // 2
                s0 = sum(eq[:half]) % P
                s1 = sum(eq[half:eq_len]) % P
                coeffs = [s0, (s1 - s0) % P, 0]
        sp.round_polys.append(coeffs)
        r = transcript.challenge_scalar(b"lasso_round")
        sp.challenges.append(r)
        if rnd < log_K:
            addr_challenges.append(r)
            for j, idx in enumerate(indices):
                eq[j] = eq[j] * (r if (idx >> rnd) & 1 else (1 - r)) % P
        else:
            if eq_len > 1:
                half = eq_len // 2
                for j in range(half):
                    eq[j] = ((1 - r) * eq[j] + r * eq[j + half]) % P
                eq_len = half
    # final eval = ExpandingTable values[0] = Π (1 - c) over address rounds
    fe = 1
    for c in addr_challenges:
        fe = fe * (1 - c) % P
    sp.final_claims.append(fe)
    return sp


def _stage4(accesses, transcript, trace_len: int, log_t: int, log_k: int,
            start_address: int, device="cuda") -> StageProof:
    from .stage4 import ValEvaluationProver

    sp = StageProof()
    r_address = [transcript.challenge_scalar(b"r_address") for _ in range(log_k)]
    r_cycle = [transcript.challenge_scalar(b"r_cycle_val") for _ in range(log_t)]
    if trace_len == 0:
        return sp
    prover = ValEvaluationProver(
        accesses, {}, trace_len, 1 << log_k, r_address, r_cycle,
        start_address, backend="device", device=device)
    sp.final_claims.append(prover.current_claim)
    for _ in range(prover.num_rounds()):
        evals = prover.round_evals()
        sp.round_polys.append(list(evals))
        r = transcript.challenge_scalar(b"val_eval_round")
        sp.challenges.append(r)
        prover.bind_with_poly(r, evals)
    f = prover.final_openings()
    sp.final_claims.append(f["inc"] * f["wa"] % P * f["lt"] % P)
    return sp


def _stage5(padded_steps, transcript, log_t: int) -> StageProof:
    sp = StageProof()
    r_register = [transcript.challenge_scalar(b"r_register") for _ in range(LOG_REGS)]
    r_cycle = [transcript.challenge_scalar(b"r_cycle_reg") for _ in range(log_t)]
    del r_cycle  # sampled but unused (prover.zig:846-856)
    n = _next_pow2(len(padded_steps))
    evals = [0] * n
    for j, s in enumerate(padded_steps):
        rd = (s.instruction >> 7) & 0x1F
        evals[j] = _eq_le(r_register, rd)
    sp.final_claims.append(sum(evals) % P)
    cur_len = n
    for _ in range(_ceil_log2(len(padded_steps))):
        half = cur_len // 2
        s0 = sum(evals[:half]) % P
        s1 = sum(evals[half:cur_len]) % P
        sp.round_polys.append([s0, (2 * s1 - s0) % P])  # [p(0), p(2)]
        r = transcript.challenge_scalar(b"reg_eval_round")
        sp.challenges.append(r)
        for j in range(half):
            evals[j] = ((1 - r) * evals[j] + r * evals[j + half]) % P
        cur_len = half
    sp.final_claims.append(evals[0] if cur_len else 0)
    return sp


def _stage6(padded_steps, transcript, log_t: int) -> StageProof:
    sp = StageProof()
    transcript.challenge_scalar(b"booleanity")
    if not padded_steps:
        return sp
    sp.final_claims.append(0)
    for _ in range(_ceil_log2(len(padded_steps))):
        sp.round_polys.append([0, 0])
        r = transcript.challenge_scalar(b"bool_round")
        sp.challenges.append(r)
    sp.final_claims.append(0)
    return sp


# ---------------------------------------------------------------------------
# Orchestration
# ---------------------------------------------------------------------------

@lru_cache(maxsize=2)
def _cached_setup(degree: int):
    return srs_mod.insecure_setup(degree)


def prove_internal(emulator, padded_steps, bytecode: bytes,
                   log_k: int = 16, srs_degree: int = 1280,
                   inputs: bytes = b"",
                   with_openings: bool = False,
                   device="cuda", srs=None) -> InternalProof:
    """The reference's JoltProver.prove flow (mod.zig:366-440), its device
    work on `device` (the GPU by default; "cpu" runs the kernels' plain
    torch versions). The seconds of its phases go to utils.log.metrics
    ("commitments", "stage1" .. "stage6", "batch_opening").

    `srs` is the powers-of-τ SRS to commit and open with: srs_degree
    powers at insecure_setup's τ, for instance the first srs_degree
    powers of a larger one. None builds insecure_setup(srs_degree) and
    caches it.

    with_openings=True additionally emits a HyperKZG γ-RLC batch opening
    (pcs/hyperkzg.batch_open; ref mod.zig:558-792) of the three committed
    polys at a transcript-derived point, binding the commitments to the
    data the stages argue over — the reference never opens them. Stored on
    `kzg_batch_opening` (and checked by verify_internal when present);
    the serialized byte format is unchanged."""
    require_device(device, "the internal prover")
    if srs is not None and len(srs.powers_g1) != srs_degree:
        raise ValueError(f"srs holds {len(srs.powers_g1)} powers, not "
                         f"srs_degree = {srs_degree}")
    proof = InternalProof()
    t = KeccakTranscript(b"Jolt")
    if inputs:
        t.append_bytes(bytes(inputs))

    with metrics.stage("commitments"):
        s = srs if srs is not None else _cached_setup(srs_degree)
        powers = s.powers_g1

        bc_poly = list(bytecode) + [0] * (_next_pow2(max(len(bytecode), 2))
                                          - len(bytecode))
        proof.bc_commitment = _kzg_commit(s, bc_poly, device)
        accesses = list(emulator.ram.trace)
        mem_poly = [a.post_value for a in accesses]
        mem_poly += [0] * (_next_pow2(max(len(mem_poly), 2)) - len(mem_poly))
        proof.mem_commitment = _kzg_commit(s, mem_poly, device)
        reg_poly = [s_.rd_value for s_ in padded_steps]
        reg_poly += [0] * (_next_pow2(max(len(reg_poly), 2)) - len(reg_poly))
        proof.reg_commitment = _kzg_commit(s, reg_poly, device)

    t.append_bytes(_commit_bytes_for_transcript(proof.bc_commitment))
    t.append_bytes(_commit_bytes_for_transcript(proof.mem_commitment))
    t.append_bytes(b"\x00" * 64)  # memory final-state commitment (zero)
    t.append_bytes(_commit_bytes_for_transcript(proof.reg_commitment))
    t.append_bytes(b"\x00" * 64)  # register final-state commitment (zero)

    log_t = _ceil_log2(len(padded_steps))
    proof.log_t, proof.log_k = log_t, log_k
    witness_rows = ri.witness_matrix(padded_steps)

    with metrics.stage("stage1"):
        proof.stage_proofs.append(_stage1(padded_steps, witness_rows, t,
                                          device))
    with metrics.stage("stage2"):
        proof.stage_proofs.append(_stage2(accesses, t, log_t, log_k,
                                          RAM_START_ADDRESS))
    with metrics.stage("stage3"):
        proof.stage_proofs.append(_stage3(padded_steps, t, log_t))
    with metrics.stage("stage4"):
        proof.stage_proofs.append(_stage4(accesses, t, len(padded_steps),
                                          log_t, log_k, RAM_START_ADDRESS,
                                          device))
    with metrics.stage("stage5"):
        proof.stage_proofs.append(_stage5(padded_steps, t, log_t))
    with metrics.stage("stage6"):
        proof.stage_proofs.append(_stage6(padded_steps, t, log_t))

    if with_openings:
        from ..pcs import hyperkzg

        with metrics.stage("batch_opening"):
            polys = [bc_poly, mem_poly, reg_poly]
            size = max(_next_pow2(max(len(p), 2)) for p in polys)
            assert size <= len(powers), "srs_degree too small for batch opening"
            padded = [list(p) + [0] * (size - len(p)) for p in polys]
            nv = size.bit_length() - 1
            point = [t.challenge_scalar(b"kzg_open_point") for _ in range(nv)]
            proof.kzg_batch_opening = hyperkzg.batch_open(
                s, padded, point, _KeccakPCSAdapter(t), device)
            proof.kzg_batch_point = point
    return proof


class _KeccakPCSAdapter:
    """Blake2b-style transcript surface (append_scalars/append_point/
    challenge_scalar_full) over the internal KeccakTranscript, so the
    HyperKZG batch protocol runs inside the internal Fiat-Shamir stream."""

    def __init__(self, t):
        self.t = t

    def append_scalars(self, xs) -> None:
        self.t.append_scalars(b"kzg_scalars", xs)

    def append_point(self, x, y=None) -> None:
        if x is None:
            self.t.append_message(b"kzg_point", b"\x00" * 64)
        else:
            self.t.append_message(
                b"kzg_point",
                int(x).to_bytes(32, "little") + int(y).to_bytes(32, "little"))

    def challenge_scalar_full(self) -> int:
        return self.t.challenge_scalar(b"kzg_challenge")


# ---------------------------------------------------------------------------
# Deserialization + verification (reference serialization.zig:327-447,
# verifier.zig:47-776, mod.zig:1846-2040)
# ---------------------------------------------------------------------------

def deserialize_internal(data: bytes) -> InternalProof:
    pos = 0

    def take(n):
        nonlocal pos
        v = data[pos : pos + n]
        assert len(v) == n, "unexpected EOF"
        pos += n
        return v

    def u64():
        return int.from_bytes(take(8), "little")

    assert take(4) == b"ZOLT", "bad magic"
    assert int.from_bytes(take(4), "little") == 1, "bad version"
    proof = InternalProof()

    def commit():
        raw = take(64)
        x = int.from_bytes(raw[:32], "big")
        y = int.from_bytes(raw[32:], "big")
        return None if x == 0 and y == 0 else (x, y)

    proof.bc_commitment = commit()
    take(64 * 2 + 32)
    proof.mem_commitment = commit()
    take(64 * 3)
    proof.reg_commitment = commit()
    take(64 * 3)
    tl = u64(); take(32 * tl)
    take(96)
    el = u64(); take(32 * el)
    take(64)
    u64()
    fl = u64(); take(32 * fl)
    has = take(1)[0]
    if not has:
        return proof
    proof.log_t, proof.log_k = u64(), u64()
    for _ in range(6):
        sp = StageProof()
        for _ in range(u64()):
            m = u64()
            sp.round_polys.append([int.from_bytes(take(32), "little") for _ in range(m)])
        for _ in range(u64()):
            sp.challenges.append(int.from_bytes(take(32), "little"))
        for _ in range(u64()):
            sp.final_claims.append(int.from_bytes(take(32), "little"))
        proof.stage_proofs.append(sp)
    assert pos == len(data), f"trailing bytes: {len(data) - pos}"
    return proof


def _eval_at(evals: list[int], r: int) -> int:
    """Lagrange evaluation through evals at 0,1,2,... (verifier.zig:850-900)."""
    n = len(evals)
    if n == 0:
        return 0
    if n == 1:
        return evals[0]
    if n == 2:
        return ((1 - r) * evals[0] + r * evals[1]) % P
    inv2 = pow(2, -1, P)
    if n == 3:
        l0 = (r - 1) * (r - 2) % P * inv2 % P
        l1 = (-r * (r - 2)) % P
        l2 = r * (r - 1) % P * inv2 % P
        return (evals[0] * l0 + evals[1] * l1 + evals[2] * l2) % P
    inv6 = pow(6, -1, P)
    l0 = (r - 1) * (r - 2) % P * (r - 3) % P * (-inv6) % P
    l1 = r * (r - 2) % P * (r - 3) % P * inv2 % P
    l2 = r * (r - 1) % P * (r - 3) % P * (-inv2) % P
    l3 = r * (r - 1) % P * (r - 2) % P * inv6 % P
    return (evals[0] * l0 + evals[1] * l1 + evals[2] * l2 + evals[3] * l3) % P


class InternalVerificationError(AssertionError):
    pass


def verify_internal(proof: InternalProof, inputs: bytes = b"",
                    strict: bool = True) -> bool:
    """JoltVerifier.verify + MultiStageVerifier (transcript resync +
    p(0)+p(1)=claim per round)."""
    t = KeccakTranscript(b"Jolt")
    if inputs:
        t.append_bytes(bytes(inputs))
    t.append_bytes(_commit_bytes_for_transcript(proof.bc_commitment))
    t.append_bytes(_commit_bytes_for_transcript(proof.mem_commitment))
    t.append_bytes(b"\x00" * 64)
    t.append_bytes(_commit_bytes_for_transcript(proof.reg_commitment))
    t.append_bytes(b"\x00" * 64)
    log_t, log_k = proof.log_t, proof.log_k
    sps = proof.stage_proofs

    def check(ok, msg):
        if strict and not ok:
            raise InternalVerificationError(msg)

    # stage 1: evals [p0,p1,p2], round polys absorbed
    sp = sps[0]
    if sp.round_polys:
        for _ in range(len(sp.round_polys)):
            t.challenge_scalar(b"spartan_tau")
        claim = sp.final_claims[0] if sp.final_claims else 0
        for i, poly in enumerate(sp.round_polys):
            check((poly[0] + poly[1]) % P == claim % P, f"stage1 round {i}")
            t.append_scalar(b"round_poly_0", poly[0])
            t.append_scalar(b"round_poly_1", poly[1])
            if len(poly) > 2:
                t.append_scalar(b"round_poly_2", poly[2])
            r = t.challenge_scalar(b"spartan_round")
            claim = _eval_at(poly, r)

    # stage 2: [p(0), p(2)], p(1) from claim
    sp = sps[1]
    if sp.round_polys:
        for _ in range(log_t):
            t.challenge_scalar(b"r_cycle")
        claim = sp.final_claims[0] if sp.final_claims else 0
        for poly in sp.round_polys:
            p0, p2 = poly[0], poly[1]
            p1 = (claim - p0) % P
            r = t.challenge_scalar(b"raf_round")
            claim = _eval_at([p0, p1, p2], r)

    # stage 3: COEFFICIENTS [c0, c1, c2]
    sp = sps[2]
    if sp.round_polys:
        t.challenge_scalar(b"lasso_gamma")
        for _ in range(log_t):
            t.challenge_scalar(b"r_reduction")
        claim = sp.final_claims[0] if sp.final_claims else 0
        for i, poly in enumerate(sp.round_polys):
            c0, c1 = poly[0], poly[1]
            c2 = poly[2] if len(poly) > 2 else 0
            check((2 * c0 + c1 + c2) % P == claim % P, f"stage3 round {i}")
            r = t.challenge_scalar(b"lasso_round")
            claim = (c0 + c1 * r + c2 * r * r) % P

    # stage 4: 4 evals, degree 3
    sp = sps[3]
    if sp.round_polys:
        for _ in range(16):
            t.challenge_scalar(b"r_address")
        for _ in range(log_t):
            t.challenge_scalar(b"r_cycle_val")
        claim = sp.final_claims[0] if sp.final_claims else 0
        for i, poly in enumerate(sp.round_polys):
            check((poly[0] + poly[1]) % P == claim % P, f"stage4 round {i}")
            r = t.challenge_scalar(b"val_eval_round")
            claim = _eval_at(poly, r)

    # stage 5: [p(0), p(2)]
    sp = sps[4]
    if sp.round_polys:
        for _ in range(LOG_REGS):
            t.challenge_scalar(b"r_register")
        for _ in range(log_t):
            t.challenge_scalar(b"r_cycle_reg")
        claim = sp.final_claims[0] if sp.final_claims else 0
        for poly in sp.round_polys:
            p0, p2 = poly[0], poly[1]
            p1 = (claim - p0) % P
            r = t.challenge_scalar(b"reg_eval_round")
            claim = _eval_at([p0, p1, p2], r)

    # stage 6: booleanity, claim must stay 0
    sp = sps[5]
    t.challenge_scalar(b"booleanity")
    claim = sp.final_claims[0] if sp.final_claims else 0
    check(claim == 0, "stage6 nonzero initial claim")
    for i, poly in enumerate(sp.round_polys):
        p0, p2 = poly[0], poly[1]
        p1 = (claim - p0) % P
        r = t.challenge_scalar(b"bool_round")
        claim = _eval_at([p0, p1, p2], r)

    # optional sound extension: HyperKZG γ-RLC batch opening of the three
    # committed polys (prove_internal(with_openings=True)) — replays the
    # same transcript stream, then verifies the single pairing check
    if proof.kzg_batch_opening is not None:
        from ..pcs import hyperkzg

        bp = proof.kzg_batch_opening
        nv = len(proof.kzg_batch_point or [])
        point = [t.challenge_scalar(b"kzg_open_point") for _ in range(nv)]
        check(point == list(proof.kzg_batch_point or []),
              "kzg batch opening point mismatch")
        cs = [proof.bc_commitment, proof.mem_commitment,
              proof.reg_commitment]
        # verification only touches srs.g1/g2/tau_g2 — deterministic τ, so
        # any insecure_setup degree matches the prover's SRS
        s = _cached_setup(2)
        ok = hyperkzg.verify_batch_opening(s, cs, point, bp,
                                           _KeccakPCSAdapter(t))
        check(ok, "kzg batch opening pairing check failed")
        if not ok:
            return False
    return True
