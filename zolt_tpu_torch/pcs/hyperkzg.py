"""HyperKZG multilinear polynomial commitment (real protocol, sound verify).

Commitment: C = Σ_i evals[i]·τ^i·G — the evaluation vector treated as
univariate coefficients. Every MSM runs on the device Pippenger
(msm/pippenger.py `srs_msm`, kernels C and D, the SRS's points from a
cache) on the device a caller names, at every size: `commit` takes the
device of its tensor and makes the digits there (kernel E on the card);
`commit_ints`, `open_at` and `batch_*` take `device`, the card by default
(they raise where there is no CUDA device). With device=None they commit
on the host tiers (`msm.msm`), as the JAX package does on its host.

Opening at multilinear point x (little-endian, x[0] binds the low variable,
matching dense.bind_low) uses the Gemini reduction exactly as Jolt/Nova's
HyperKZG (the reference's open() keeps the quotient-commitment shape but its
pairing verify is a stub — src/poly/commitment/mod.zig:338-508; here the full
sound protocol is implemented):

  1. fold P_0 = evals with x_0..x_{n-1} via even/odd (bind_low) splits, commit
     each intermediate P_1..P_{n-1};
  2. challenge r; evaluate every P_i as a univariate at {r, −r, r²};
  3. challenge q; batch B(X) = Σ q^i P_i(X); one KZG witness per point u_j;
  4. challenge d; the verifier checks the even/odd consistency
     P_{i+1}(r²) = (1−x_i)(P_i(r)+P_i(−r))/2 + x_i(P_i(r)−P_i(−r))/(2r)
     and the batched pairing equation
     e(Σ_j d^j (C_B − v_j G + u_j W_j), G2) = e(Σ_j d^j W_j, τG2).

Transcript discipline uses the Blake2b transcript; all host scalars are
canonical ints.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..curve import host as G1
from ..curve.pairing import pairing_check
from ..field.params import FR
from ..msm import msm, pippenger
from ..utils import require_cuda

P = FR.p


@dataclass
class HyperKZGProof:
    com: list            # commitments to P_1 .. P_{n-1} (host affine points)
    v: list[list[int]]   # 3 x n evaluation matrix: v[j][i] = P_i(u_j)
    w: list              # 3 KZG witnesses (host affine points)


def commit(srs, evals) -> tuple:
    """Commit of an (N, 8) int32 tensor of Fr Montgomery words by the
    Pippenger on the tensor's device, its digits made there."""
    return pippenger.srs_msm(srs, pippenger.scalar_digits(evals.reshape(-1, 8)))


def commit_ints(srs, coeffs: list[int], device="cuda") -> tuple:
    """Commit of host ints by the Pippenger on `device` (the card by
    default), or on the host tiers with device=None."""
    scalars = [c % P for c in coeffs]
    if device is None:
        return msm(srs.powers_g1[: len(scalars)], scalars, device=None)
    require_cuda(device, "commit_ints")
    return pippenger.srs_msm(srs, pippenger.int_digits(scalars, device))


def _uni_eval(coeffs: list[int], x: int) -> int:
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % P
    return acc


def _kzg_witness(srs, coeffs: list[int], u: int, device):
    """Commit((B(X) − B(u)) / (X − u)) by synthetic division."""
    n = len(coeffs)
    q = [0] * (n - 1)
    s = 0  # suffix Horner: s_k = Σ_{j>=k} b_j u^{j-k}
    for k in range(n - 1, 0, -1):
        s = (coeffs[k] + u * s) % P
        q[k - 1] = s
    return commit_ints(srs, q, device)


def open_at(srs, evals: list[int], x: list[int], transcript,
            device="cuda") -> HyperKZGProof:
    """Prove evals(x) where evals is the MLE table (len 2^n), x little-endian.
    The commitments' MSMs run on `device`, the card by default (the host
    tiers with device=None)."""
    if device is not None:
        require_cuda(device, "open_at")
    n = len(x)
    assert len(evals) == 1 << n

    polys = [list(evals)]
    for xi in x[:-1]:
        prev = polys[-1]
        half = len(prev) // 2
        nxt = [(prev[2 * j] + xi * (prev[2 * j + 1] - prev[2 * j])) % P for j in range(half)]
        polys.append(nxt)

    com = [commit_ints(srs, pi, device) for pi in polys[1:]]
    for c in com:
        transcript.append_point(*(c if c is not None else (None,)))
    r = transcript.challenge_scalar_full()
    u = [r, (-r) % P, r * r % P]

    v = [[_uni_eval(pi, uj) for pi in polys] for uj in u]
    for vj in v:
        transcript.append_scalars(vj)
    q = transcript.challenge_scalar_full()

    batched = [0] * len(polys[0])
    qp = 1
    for pi in polys:
        for k, c in enumerate(pi):
            batched[k] = (batched[k] + qp * c) % P
        qp = qp * q % P

    w = [_kzg_witness(srs, batched, uj, device) for uj in u]
    for wj in w:
        transcript.append_point(*(wj if wj is not None else (None,)))
    return HyperKZGProof(com=com, v=v, w=w)


def verify(srs, commitment, x: list[int], value: int, proof: HyperKZGProof,
           transcript) -> bool:
    n = len(x)
    if len(proof.com) != n - 1 or len(proof.v) != 3:
        return False

    for c in proof.com:
        transcript.append_point(*(c if c is not None else (None,)))
    r = transcript.challenge_scalar_full()
    if r == 0:
        return False
    u = [r, (-r) % P, r * r % P]

    for vj in proof.v:
        transcript.append_scalars(vj)
    q = transcript.challenge_scalar_full()

    # Gemini fold consistency at every level, and final value check
    vr, vnr, vr2 = proof.v
    inv2 = pow(2, -1, P)
    inv2r = pow(2 * r, -1, P)
    for i in range(n):
        even = (vr[i] + vnr[i]) * inv2 % P
        odd = (vr[i] - vnr[i]) * inv2r % P
        folded = ((1 - x[i]) * even + x[i] * odd) % P
        if i + 1 < n:
            if folded != vr2[i + 1]:
                return False
        else:
            if folded != value % P:
                return False

    for wj in proof.w:
        transcript.append_point(*(wj if wj is not None else (None,)))
    d = transcript.challenge_scalar_full()

    # batched commitment C_B = Σ q^i C_i  (C_0 = commitment)
    cs = [commitment] + list(proof.com)
    qp = 1
    CB = None
    for c in cs:
        CB = G1.add(CB, G1.scalar_mul(c, qp)) if c is not None else CB
        qp = qp * q % P

    # batched evals B(u_j) = Σ_i q^i v[j][i]
    bu = []
    for j in range(3):
        acc, qp = 0, 1
        for i in range(n):
            acc = (acc + qp * proof.v[j][i]) % P
            qp = qp * q % P
        bu.append(acc)

    # L = Σ_j d^j (C_B − B(u_j)·G + u_j·W_j),  R = Σ_j d^j W_j
    L = None
    Rw = None
    dp = 1
    for j in range(3):
        term = G1.add(CB, G1.neg(G1.scalar_mul(srs.g1, bu[j])))
        term = G1.add(term, G1.scalar_mul(proof.w[j], u[j]))
        L = G1.add(L, G1.scalar_mul(term, dp))
        Rw = G1.add(Rw, G1.scalar_mul(proof.w[j], dp))
        dp = dp * d % P

    # e(L, G2) == e(R, τG2)  ⇔  e(L, G2)·e(−R, τG2) == 1
    return pairing_check([(L, srs.g2), (G1.neg(Rw), srs.tau_g2)])


# ---------------------------------------------------------------------------
# Batch commit / open / verify (γ-powers RLC)
#
# Reference surface: src/poly/commitment/mod.zig:558-607 (batchCommit /
# batchOpen) and :738-792 (verifyBatchOpening) — many polynomials opened at
# ONE point collapse to a single opening of the γ-RLC combination, with the
# commitment combined homomorphically on the verifier side. The reference
# derives γ deterministically from the point ("should be Fiat-Shamir",
# mod.zig:602); here γ IS Fiat-Shamir: the per-poly claims are appended to
# the transcript first, so γ binds every claimed evaluation.
# ---------------------------------------------------------------------------


@dataclass
class HyperKZGBatchProof:
    evaluations: list[int]   # v_i = p_i(x), claimed per-poly values
    proof: HyperKZGProof     # opening of Σ γ^i·p_i at x


def _mle_eval(evals: list[int], x: list[int]) -> int:
    cur = list(evals)
    for xi in x:
        half = len(cur) // 2
        cur = [(cur[2 * j] + xi * (cur[2 * j + 1] - cur[2 * j])) % P
               for j in range(half)]
    return cur[0] % P


def batch_commit(srs, polys: list[list[int]], device="cuda") -> list:
    """One commitment per polynomial (mod.zig:558-570), on `device` (the
    card by default; the host tiers with device=None)."""
    return [commit_ints(srs, p, device) for p in polys]


def batch_open(srs, polys: list[list[int]], x: list[int],
               transcript, device="cuda") -> HyperKZGBatchProof:
    """Single opening for many polys at one point: append every claim,
    draw γ, open the γ-RLC combination with the standard protocol. Its
    MSMs run on `device` (the card by default; the host tiers with
    device=None)."""
    if device is not None:
        require_cuda(device, "batch_open")
    assert polys and all(len(p) == 1 << len(x) for p in polys)
    evals = [_mle_eval(p, x) for p in polys]
    transcript.append_scalars(evals)
    gamma = transcript.challenge_scalar_full()
    rlc = [0] * len(polys[0])
    gp = 1
    for p in polys:
        for k, c in enumerate(p):
            rlc[k] = (rlc[k] + gp * c) % P
        gp = gp * gamma % P
    return HyperKZGBatchProof(evaluations=evals,
                              proof=open_at(srs, rlc, x, transcript, device))


def verify_batch_opening(srs, commitments: list, x: list[int],
                         proof: HyperKZGBatchProof, transcript) -> bool:
    """Homomorphic check: C* = Σ γ^i·C_i must open to v* = Σ γ^i·v_i."""
    if len(commitments) != len(proof.evaluations):
        return False
    transcript.append_scalars(proof.evaluations)
    gamma = transcript.challenge_scalar_full()
    c_star = None
    v_star, gp = 0, 1
    for c, v in zip(commitments, proof.evaluations):
        if c is not None:
            c_star = G1.add(c_star, G1.scalar_mul(c, gp))
        v_star = (v_star + gp * v) % P
        gp = gp * gamma % P
    return verify(srs, c_star, x, v_star, proof.proof, transcript)
