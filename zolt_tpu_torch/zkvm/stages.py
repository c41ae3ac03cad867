"""Internal multi-stage prover stages (Keccak-transcript path).

Mirrors the reference's MultiStageProver protocol content
(src/zkvm/prover.zig:241-1111) with the same stage schedule, round counts,
degrees and transcript labels:

  S1 outer Spartan:  Σ_i eq(τ,i)·Az(i)·Bz(i) = 0 over i = cycle·19+constraint
  S2 RAM RAF:        Σ_k ra(k)·unmap(k) = raf_claim          (deg 2, log K rounds)
  S3 Lasso lookups:  (separate module, zkvm/lasso.py)
  S4 RAM ValEval:    Σ_j inc(j)·wa(j)·lt(j) = val(r)−val₀   (deg 3, log T rounds)
  S5 registers:      Σ_j eq(r,j)·rd_inc(j) = reg_val claim   (deg 2, log T rounds)
  S6 booleanity:     Σ_i eq(r,i)·(f(i)²−f(i)) = 0            (deg 3)

One deliberate deviation, documented: the reference's internal path samples
stage-2..6 challenges without absorbing the round polynomials
(prover.zig:530-547); here every round polynomial is absorbed before its
challenge — strictly stronger Fiat-Shamir, still prover/verifier-consistent.

The port of zolt_tpu/zkvm/stages.py. Tables live on the device as Fr
Montgomery words (DeviceMleSumcheck); each round's evaluations come to the
host for the transcript, the fold stays on the device (the host↔device
structure of SURVEY §5.7). The stage provers and verifiers and their table
builders are host Python, as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dfield

from ..field import limb
from ..field.params import FR
from ..parallel.stage_engine import DeviceProductTables
from ..r1cs import constraints as rc
from ..r1cs import inputs as ri

P = FR.p


@dataclass
class StageProof:
    round_polys: list[list[int]] = dfield(default_factory=list)
    challenges: list[int] = dfield(default_factory=list)
    final_claims: list[int] = dfield(default_factory=list)


def _ceil_log2(n: int) -> int:
    return 0 if n <= 1 else (n - 1).bit_length()


def _pad_pow2(vals: list[int]) -> list[int]:
    n = 1 << _ceil_log2(len(vals))
    return vals + [0] * (n - len(vals))


def eq_evals_le(r: list[int], size: int) -> list[int]:
    """eq(r, j) for j in [0, size), little-endian (bit b of j ↔ r[b])."""
    out = [1]
    for rb in r:
        nxt = []
        for v in out:
            nxt.append(v * (1 - rb) % P)
        for v in out:
            nxt.append(v * rb % P)
        out = nxt
    return out[:size]


class DeviceMleSumcheck:
    """Sumcheck over a product of k MLE tables, low-to-high binding.

    degree == number of factor tables; round evals [p(0)..p(d)] as host
    ints. On a device the tables are one DeviceProductTables stack
    (parallel/stage_engine.py): each round is one grouped product-evals
    launch (kernels 2-3, k = 2 or 3) and one fold (kernel 1), with the
    engine's narrow host tail (tail_n()) once the live prefix is small;
    the evals come back in one transfer, the Fiat-Shamir sync point.
    On device="cpu" the engine runs the kernels' plain torch versions.
    """

    def __init__(self, tables, degree: int | None = None, device="cuda"):
        vals = [_pad_pow2([v % P for v in t]) for t in tables]
        self.num_rounds = _ceil_log2(len(vals[0]))
        self.degree = degree if degree is not None else len(vals)
        self.engine = DeviceProductTables(
            [limb.encode(v, device=device) for v in vals],
            degree=self.degree, device=device)

    def round_evals(self) -> list[int]:
        return self.engine.round_evals()

    def bind(self, r: int) -> None:
        self.engine.bind(r)

    def final_evals(self) -> list[int]:
        return self.engine.finals()

    def initial_claim(self) -> int:
        """Σ_i Π_k t_k(i): p(0) + p(1) of the first round's evals (the
        product itself for tables of one entry)."""
        if self.num_rounds == 0:
            out = 1
            for v in self.final_evals():
                out = out * v % P
            return out
        ev = self.round_evals()
        return (ev[0] + ev[1]) % P


def run_stage_sumcheck(inst: DeviceMleSumcheck, transcript, label: bytes,
                       claim: int) -> StageProof:
    """Drive one stage: absorb evals, challenge, bind; claim via interpolation."""
    from ..poly import unipoly

    proof = StageProof()
    proof.final_claims.append(claim)
    for _ in range(inst.num_rounds):
        evals = inst.round_evals()
        transcript.append_scalars(b"round_poly", evals)
        r = transcript.challenge_scalar(label)
        proof.round_polys.append(evals)
        proof.challenges.append(r)
        inst.bind(r)
        coeffs = unipoly.interpolate(evals)
        claim = unipoly.horner_eval(coeffs, r)
    proof.final_claims.append(claim)
    return proof


def verify_stage_sumcheck(proof: StageProof, transcript, label: bytes,
                          degree: int) -> tuple[int, list[int]]:
    """Check p(0)+p(1) == claim each round, reproduce challenges; returns
    (final_claim, challenges)."""
    from ..poly import unipoly

    claim = proof.final_claims[0]
    challenges = []
    for evals in proof.round_polys:
        assert len(evals) == degree + 1, "wrong round poly size"
        assert (evals[0] + evals[1]) % P == claim % P, "round sum mismatch"
        transcript.append_scalars(b"round_poly", evals)
        r = transcript.challenge_scalar(label)
        challenges.append(r)
        claim = unipoly.horner_eval(unipoly.interpolate(evals), r)
    assert claim % P == proof.final_claims[1] % P, "final claim mismatch"
    return claim, challenges


# ---------------------------------------------------------------------------
# Stage 1: outer Spartan
# ---------------------------------------------------------------------------

def build_az_bz(padded_steps) -> tuple[list[int], list[int]]:
    """Az/Bz over constraint-major index i = cycle*19 + c, zero-padded pow2."""
    rows = ri.witness_matrix(padded_steps)
    az, bz = [], []
    for w in rows:
        for cond, left, right in rc.CONSTRAINTS:
            az.append(rc.lc_eval(cond, w))
            bz.append((rc.lc_eval(left, w) - rc.lc_eval(right, w)) % P)
    n = 1 << _ceil_log2(len(az))
    az += [0] * (n - len(az))
    bz += [0] * (n - len(bz))
    return az, bz


def prove_stage1(padded_steps, transcript,
                 device="cuda") -> tuple[StageProof, dict]:
    """True degree-3 product sumcheck Σ eq(τ,i)·Az(i)·Bz(i) = 0 — unlike the
    reference's internal path (which sumchecks the pre-multiplied table and
    verifies structurally, prover.zig:350-452), the product form lets the
    verifier check the final claim against eq(τ,r) and the Az/Bz openings."""
    az, bz = build_az_bz(padded_steps)
    num_rounds = _ceil_log2(len(az))
    tau = [transcript.challenge_scalar(b"spartan_tau") for _ in range(num_rounds)]
    eq = eq_evals_le(tau, len(az))

    inst = DeviceMleSumcheck([eq, az, bz], device=device)
    proof = run_stage_sumcheck(inst, transcript, b"spartan_round", 0)
    proof.final_claims.extend(inst.final_evals()[1:])  # Az(r), Bz(r)
    return proof, {"tau": tau, "az": az, "bz": bz}


def verify_stage1(proof: StageProof, transcript, num_rounds: int) -> list[int]:
    tau = [transcript.challenge_scalar(b"spartan_tau") for _ in range(num_rounds)]
    assert proof.final_claims[0] == 0, "stage1 initial claim must be 0"
    final_claim, r = verify_stage_sumcheck(proof, transcript, b"spartan_round", 3)
    # final_claim must equal eq(tau, r)·Az(r)·Bz(r), with eq public
    eq_r = 1
    for t_i, r_i in zip(tau, r):
        eq_r = eq_r * ((t_i * r_i + (1 - t_i) * (1 - r_i)) % P) % P
    az_r, bz_r = proof.final_claims[2], proof.final_claims[3]
    assert final_claim == eq_r * az_r % P * bz_r % P, "stage1 opening mismatch"
    return r


def _mle_eval_le(evals: list[int], point: list[int]) -> int:
    cur = [v % P for v in evals]
    for r in point:
        half = len(cur) // 2
        cur = [(cur[2 * i] + r * (cur[2 * i + 1] - cur[2 * i])) % P for i in range(half)]
    return cur[0]


# ---------------------------------------------------------------------------
# Stage 2: RAM RAF evaluation
# ---------------------------------------------------------------------------

def build_raf_tables(memory_trace, r_cycle: list[int], start_address: int,
                     log_k: int) -> tuple[list[int], list[int]]:
    """ra(k) = Σ_j eq(r_cycle, j)·1[slot(access_j)=k]; unmap(k) = start + 8k
    (reference ram/raf_checking.zig:75-230)."""
    k_size = 1 << log_k
    n_acc = len(memory_trace)
    eq = eq_evals_le(r_cycle, 1 << _ceil_log2(max(1, n_acc)))
    ra = [0] * k_size
    for j, acc in enumerate(memory_trace):
        if acc.address >= start_address:
            k = (acc.address - start_address) // 8
            if k < k_size:
                ra[k] = (ra[k] + eq[j]) % P
    unmap = [(start_address + 8 * k) % P for k in range(k_size)]
    return ra, unmap


def prove_stage2(memory_trace, transcript, log_t: int, log_k: int,
                 start_address: int, device="cuda") -> StageProof:
    r_cycle = [transcript.challenge_scalar(b"r_cycle") for _ in range(log_t)]
    ra, unmap = build_raf_tables(memory_trace, r_cycle, start_address, log_k)
    inst = DeviceMleSumcheck([ra, unmap], device=device)
    claim = sum(a * u for a, u in zip(ra, unmap)) % P
    proof = run_stage_sumcheck(inst, transcript, b"raf_round", claim)
    proof.final_claims.extend(inst.final_evals())
    return proof


def verify_stage2(proof: StageProof, transcript, log_t: int, log_k: int,
                  start_address: int) -> list[int]:
    [transcript.challenge_scalar(b"r_cycle") for _ in range(log_t)]
    final_claim, r = verify_stage_sumcheck(proof, transcript, b"raf_round", 2)
    ra_r, unmap_r = proof.final_claims[2], proof.final_claims[3]
    assert final_claim == ra_r * unmap_r % P, "stage2 opening mismatch"
    # unmap is a public linear polynomial: recompute its MLE at r directly
    k_size = 1 << log_k
    expect_unmap = _mle_eval_le([(start_address + 8 * k) % P for k in range(k_size)], r)
    assert unmap_r == expect_unmap, "stage2 unmap mismatch"
    return r


# ---------------------------------------------------------------------------
# Stage 4: RAM value evaluation  (deg-3: inc · wa · lt over cycles)
# ---------------------------------------------------------------------------

def build_val_tables(memory_trace, r_address: list[int], r_cycle: list[int],
                     start_address: int, log_k: int, log_t: int):
    """inc(j), wa(j)=eq(r_address, slot_j), lt(j)=LT-MLE(j, r_cycle) over write
    accesses j (reference ram/val_evaluation.zig semantics)."""
    t_size = 1 << log_t
    eq_addr = eq_evals_le(r_address, 1 << log_k)
    inc = [0] * t_size
    wa = [0] * t_size
    writes = [a for a in memory_trace if a.op == "write"]
    for j, acc in enumerate(writes[:t_size]):
        if acc.address >= start_address:
            k = (acc.address - start_address) // 8
            if k < (1 << log_k):
                inc[j] = (acc.post_value - acc.pre_value) % P
                wa[j] = eq_addr[k]
    # lt(j) = MLE of 1[j < c] evaluated at c = r_cycle: standard product form
    lt = [_lt_mle(j, r_cycle, log_t) for j in range(t_size)]
    return inc, wa, lt, writes


def _lt_mle(j: int, r: list[int], nbits: int) -> int:
    """LT(j, r) = Σ_{b} (1-j_b)·r_b · Π_{b'>b} eq(j_{b'}, r_{b'}) — MLE of
    [j < c] with little-endian bit order (bit 0 = LSB)."""
    acc = 0
    suffix = 1
    for b in range(nbits - 1, -1, -1):
        jb = (j >> b) & 1
        rb = r[b]
        if jb == 0:
            acc = (acc + rb * suffix) % P
        eqb = (jb * rb + (1 - jb) * (1 - rb)) % P
        suffix = suffix * eqb % P
    return acc


def prove_stage4(memory_trace, transcript, log_t: int, log_k: int,
                 start_address: int, device="cuda") -> StageProof:
    r_address = [transcript.challenge_scalar(b"r_address") for _ in range(log_k)]
    r_cycle = [transcript.challenge_scalar(b"r_cycle_val") for _ in range(log_t)]
    inc, wa, lt, _ = build_val_tables(memory_trace, r_address, r_cycle,
                                      start_address, log_k, log_t)
    inst = DeviceMleSumcheck([inc, wa, lt], device=device)
    claim = sum(i * w % P * l for i, w, l in zip(inc, wa, lt)) % P
    proof = run_stage_sumcheck(inst, transcript, b"val_eval_round", claim)
    proof.final_claims.extend(inst.final_evals())
    return proof


def verify_stage4(proof: StageProof, transcript, log_t: int, log_k: int) -> list[int]:
    [transcript.challenge_scalar(b"r_address") for _ in range(log_k)]
    r_cycle = [transcript.challenge_scalar(b"r_cycle_val") for _ in range(log_t)]
    final_claim, r = verify_stage_sumcheck(proof, transcript, b"val_eval_round", 3)
    inc_r, wa_r, lt_r = proof.final_claims[2:5]
    assert final_claim == inc_r * wa_r % P * lt_r % P, "stage4 opening mismatch"
    # lt is a public polynomial of (j, r_cycle): recompute its MLE at r
    expect_lt = _mle_eval_le([_lt_mle(j, r_cycle, log_t) for j in range(1 << log_t)], r)
    assert lt_r == expect_lt, "stage4 lt mismatch"
    return r


# ---------------------------------------------------------------------------
# Stage 5: register value evaluation (deg-2: eq(r_cycle) · rd_inc)
# ---------------------------------------------------------------------------

def build_register_tables(padded_steps, r_cycle: list[int]):
    """eq(r_cycle, j) and rd increment (post − pre) per cycle."""
    t_size = len(padded_steps)
    eq = eq_evals_le(r_cycle, t_size)
    inc = []
    for s in padded_steps:
        if s.is_noop:
            inc.append(0)
        else:
            rd = (s.instruction >> 7) & 0x1F
            opcode = s.instruction & 0x7F
            writes = rd != 0 and opcode not in (0x23, 0x63)
            inc.append((s.rd_value - s.rd_pre_value) % P if writes else 0)
    return eq, inc


def prove_stage5(padded_steps, transcript, log_t: int,
                 device="cuda") -> StageProof:
    r_cycle = [transcript.challenge_scalar(b"r_cycle_reg") for _ in range(log_t)]
    eq, inc = build_register_tables(padded_steps, r_cycle)
    inst = DeviceMleSumcheck([eq, inc], device=device)
    claim = sum(e * i for e, i in zip(eq, inc)) % P
    proof = run_stage_sumcheck(inst, transcript, b"reg_round", claim)
    proof.final_claims.extend(inst.final_evals())
    return proof


def verify_stage5(proof: StageProof, transcript, log_t: int) -> list[int]:
    r_cycle = [transcript.challenge_scalar(b"r_cycle_reg") for _ in range(log_t)]
    final_claim, r = verify_stage_sumcheck(proof, transcript, b"reg_round", 2)
    eq_r, inc_r = proof.final_claims[2], proof.final_claims[3]
    assert final_claim == eq_r * inc_r % P, "stage5 opening mismatch"
    # eq is public: recompute eq(r_cycle, ·) MLE at r
    expect_eq = 1
    for t_i, r_i in zip(r_cycle, r):
        expect_eq = expect_eq * ((t_i * r_i + (1 - t_i) * (1 - r_i)) % P) % P
    assert eq_r == expect_eq, "stage5 eq mismatch"
    return r


# ---------------------------------------------------------------------------
# Stage 6: booleanity — all circuit flags are 0/1
# ---------------------------------------------------------------------------

FLAG_INPUTS = [ri.Inp.FlagAddOperands, ri.Inp.FlagSubtractOperands,
               ri.Inp.FlagMultiplyOperands, ri.Inp.FlagLoad, ri.Inp.FlagStore,
               ri.Inp.FlagJump, ri.Inp.FlagWriteLookupOutputToRD,
               ri.Inp.FlagVirtualInstruction, ri.Inp.FlagAssert,
               ri.Inp.FlagDoNotUpdateUnexpandedPC, ri.Inp.FlagAdvice,
               ri.Inp.FlagIsCompressed, ri.Inp.FlagIsFirstInSequence]


def build_flag_table(padded_steps, gamma: int) -> list[int]:
    """f(j) = Σ_k γ^k · flag_k(j): booleanity of each flag is RLC-combined;
    the sumcheck proves Σ eq·(f_k²−f_k)=0 per flag via the combined table of
    violations v(j) = Σ γ^k (flag_k²−flag_k) ≡ 0 for boolean flags."""
    rows = ri.witness_matrix(padded_steps)
    out = []
    for w in rows:
        acc, g = 0, 1
        for k in FLAG_INPUTS:
            fv = w[k]
            acc = (acc + g * ((fv * fv - fv) % P)) % P
            g = g * gamma % P
        out.append(acc)
    return out


def prove_stage6(padded_steps, transcript, log_t: int,
                 device="cuda") -> StageProof:
    gamma = transcript.challenge_scalar(b"bool_gamma")
    r_cycle = [transcript.challenge_scalar(b"r_cycle_bool") for _ in range(log_t)]
    eq = eq_evals_le(r_cycle, len(padded_steps))
    viol = build_flag_table(padded_steps, gamma)
    inst = DeviceMleSumcheck([eq, viol], device=device)
    proof = run_stage_sumcheck(inst, transcript, b"bool_round", 0)
    proof.final_claims.extend(inst.final_evals())
    return proof


def verify_stage6(proof: StageProof, transcript, log_t: int) -> None:
    transcript.challenge_scalar(b"bool_gamma")
    r_cycle = [transcript.challenge_scalar(b"r_cycle_bool") for _ in range(log_t)]
    assert proof.final_claims[0] == 0, "booleanity claim must be 0"
    final_claim, r = verify_stage_sumcheck(proof, transcript, b"bool_round", 2)
    eq_r, viol_r = proof.final_claims[2], proof.final_claims[3]
    assert final_claim == eq_r * viol_r % P, "stage6 opening mismatch"
    expect_eq = 1
    for t_i, r_i in zip(r_cycle, r):
        expect_eq = expect_eq * ((t_i * r_i + (1 - t_i) * (1 - r_i)) % P) % P
    assert eq_r == expect_eq, "stage6 eq mismatch"
