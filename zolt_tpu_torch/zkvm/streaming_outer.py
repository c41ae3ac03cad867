"""Jolt-compatible Stage 1: UniSkip + streaming outer Spartan sumcheck.

Byte-exact re-implementation of the reference's stage-1 prover flow
(src/zkvm/spartan/streaming_outer.zig, src/zkvm/proof_converter.zig:380-540):

  round 0 (UniSkip): s1(Y) = L(τ_high, Y)·t1(Y) with t1's 9 extension-target
    evaluations computed from per-cycle Az/Bz Lagrange extrapolation over the
    (x_out, x_in) eq factorization; absorbed as
    "UncompressedUniPoly_begin" + 28 scalars + "UncompressedUniPoly_end";
    r0 = 125-bit challenge.

  remaining rounds (1 streaming + num_cycle_vars): Gruen cubic rounds over the
    materialized Az/Bz tables (group bit = LSB), split-eq with scaling
    K(r0, τ_high); claims batched by a challengeScalarFull coefficient;
    compressed [c0, c2, c3] absorbed as "UniPoly_begin"/.../"UniPoly_end".

Structure notes mirrored from the reference: τ has num_cycle_vars+2 entries;
split-eq drops w_last = τ[-1] (bound in the first remaining round, which is
the constraint-group variable); az/bz tables have 2^(len(τ)) entries with
time_step = idx>>1 and zero padding beyond the real trace.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dfield

from ..field.params import FR
from ..poly import unipoly
from ..poly.special import GruenSplitEq
from ..r1cs import constraints as rc
from ..r1cs import inputs as ri
from ..r1cs import uniskip as us

P = FR.p

FIRST_GROUP_SIZE = 10
SECOND_GROUP_SIZE = 9


def _witness_az_bz(w: list[int], group: int) -> tuple[list[int], list[int]]:
    """Per-constraint (condition, left-right) for a group, in group order."""
    indices = rc.FIRST_GROUP_INDICES if group == 0 else rc.SECOND_GROUP_INDICES
    az, bz = [], []
    for ci in indices:
        cond, left, right = rc.CONSTRAINTS[ci]
        az.append(rc.lc_eval(cond, w))
        bz.append((rc.lc_eval(left, w) - rc.lc_eval(right, w)) % P)
    return az, bz


def _constraint_columns_from_wcols(wcols):
    """Az/Bz constraint COLUMNS from the 43 witness columns (the transposed
    view of the reference's per-cycle evaluators, r1cs/evaluators.zig:36-150):
    az_cols[g][i][c] = cond_i(w_c), bz_cols[g][i][c] = (left−right)_i(w_c)."""
    from ..native.frvec import FrVec

    T = wcols[0].n
    ones = FrVec.filled(T, 1)

    def lc_col(lc):
        c, terms = lc
        v = FrVec.zeros(T)
        if c % P:
            v.axpy_(ones, c)
        for idx, coeff in terms:
            v.axpy_(wcols[idx], coeff)
        return v

    az_cols: dict[int, list] = {0: [], 1: []}
    bz_cols: dict[int, list] = {0: [], 1: []}
    for g, indices in ((0, rc.FIRST_GROUP_INDICES), (1, rc.SECOND_GROUP_INDICES)):
        for ci in indices:
            cond, left, right = rc.CONSTRAINTS[ci]
            az_cols[g].append(lc_col(cond))
            bz_cols[g].append(lc_col(left).sub(lc_col(right)))
    return az_cols, bz_cols


def _constraint_columns(witnesses):
    """Row-matrix variant (internal path / tests): transpose to FrVec columns
    first, then build the constraint columns."""
    from ..native.frvec import FrVec

    wcols = [FrVec.from_ints(list(col)) for col in zip(*witnesses)]
    az_cols, bz_cols = _constraint_columns_from_wcols(wcols)
    return az_cols, bz_cols, wcols


def window_round_evals_multiquadratic(az: list[int], bz: list[int],
                                      E_out: list[int], E_in: list[int],
                                      head_in: int) -> tuple[int, int]:
    """One remaining-round (t'(0), t'(∞)) via per-cell {0,1,∞} windows
    (reference streaming_outer.zig:1577 computeRemainingRoundPolyMultiquadratic
    with window_size 1): each pair (az[2g], az[2g+1]) × (bz ditto) expands to
    a 1-variable multiquadratic product grid whose projection against the
    E_out×E_in weights gives the Gruen cubic inputs. Algebraically identical
    to the fused gruen_quad kernel — this is the explicit window form the
    streaming schedule generalizes (kept as the spec/oracle; the production
    path runs the fused kernel)."""
    from ..poly.multiquadratic import MultiquadraticPolynomial

    t0 = tinf = 0
    n2 = len(az) // 2
    for g in range(n2):
        e = E_out[g >> head_in] * E_in[g & ((1 << head_in) - 1)] % P
        ga = MultiquadraticPolynomial.from_linear(1, [az[2 * g], az[2 * g + 1]])
        gb = MultiquadraticPolynomial.from_linear(1, [bz[2 * g], bz[2 * g + 1]])
        prod = MultiquadraticPolynomial(
            1, [x * y % P for x, y in zip(ga.evaluations, gb.evaluations)])
        pz, pi = prod.project_to_first_variable([1])
        t0 = (t0 + e * pz) % P
        tinf = (tinf + e * pi) % P
    return t0, tinf


def _combine_cols(cols, coeffs):
    """Σ_i coeffs[i]·cols[i] as an FrVec (one fused native pass)."""
    from ..native.frvec import FrVec

    return FrVec.lincomb(cols, list(coeffs[:len(cols)]))


def _eq_table_be(taus: list[int]) -> list[int]:
    """Big-endian prefix eq table (τ[0] = MSB): each step doubles the table,
    appending the new variable's bit as the index LSB."""
    out = [1]
    for t in taus:
        nxt = []
        for v in out:
            nxt.append(v * (1 - t) % P)
            nxt.append(v * t % P)
        out = nxt
    return out


class StreamingOuterProver:
    def __init__(self, cycle_witnesses, tau: list[int],
                 lagrange_tau_r0: int | None = None, backend: str = "host",
                 device=None, witness_cols=None, mesh=None):
        """`cycle_witnesses`: per-cycle rows (row path) or None when
        `witness_cols` (the 43 FrVec columns, r1cs.inputs.witness_columns)
        is given — the columnar path never materializes rows."""
        self.witnesses = cycle_witnesses
        self._wcols_in = witness_cols
        self.full_tau = list(tau)
        self.tau_high = tau[-1]
        # split_eq is over tau_low = tau[:-1]; tau_high only enters via the
        # UniSkip Lagrange kernel scaling (reference proof_converter.zig:414)
        self.split_eq = GruenSplitEq(tau[:-1], scaling_factor=(lagrange_tau_r0 or 1))
        self.current_round = 0
        self.current_claim = 0
        self.lagrange_evals_r0: list[int] = []
        self.az: list[int] | None = None
        self.bz: list[int] | None = None
        self.r_stream: int | None = None
        # backend: "host" (FrVec tier), "device" (word tensors on
        # `device`) or "mesh" (az/bz sharded over `mesh`) — bit-identical
        # results; the split-eq bookkeeping and cubic-poly algebra always
        # stay host (O(1) per round, the Fiat-Shamir boundary)
        self.backend_kind = backend
        self.device = device
        self.mesh = mesh
        self._dev = None

    def _cols(self):
        if getattr(self, "_az_cols", None) is None:
            if self._wcols_in is not None:
                self._wcols = self._wcols_in
                self._az_cols, self._bz_cols = \
                    _constraint_columns_from_wcols(self._wcols)
            else:
                self._az_cols, self._bz_cols, self._wcols = \
                    _constraint_columns(self.witnesses)
        return self._az_cols, self._bz_cols

    def _num_cycles(self) -> int:
        if self._wcols_in is not None:
            return self._wcols_in[0].n
        return len(self.witnesses)

    # -- round 0: UniSkip ---------------------------------------------------
    def compute_first_round_poly(self) -> list[int]:
        """Column-vector form of the per-cycle Lagrange extrapolation: the
        flat (x_out ‖ x_in) eq table equals the big-endian table over
        tau[:wprime], whose LSB coordinate tau[wprime−1] is the constraint
        group, so E(cycle, g) = eq_table_be(tau[:wprime−1])[cycle]·eq1(tau_g, g)
        and each extension target reduces to two eq·AzY·BzY inner products."""
        from ..native.frvec import FrVec

        tau = self.full_tau
        wprime = len(tau) - 1
        T = 1 << (wprime - 1)
        assert self._num_cycles() == T, "trace must be pow2-padded"

        e_half = FrVec.eq_table_be([t % P for t in tau[: wprime - 1]])
        tau_g = tau[wprime - 1] % P
        e_even = e_half.scale((1 - tau_g) % P)
        e_odd = e_half.scale(tau_g)

        az_cols, bz_cols = self._cols()
        if T >= (1 << 12):
            # quadratic-form path: extended[j] = Σ_g w_jᵀ·M_g·w_j with the
            # per-group moment matrix M_g[a,b] = Σ_i e_g[i]·Az_a[i]·Bz_b[i]
            # computed ONCE — every column is read once instead of once per
            # target (~2x fewer multiplications; bit-identical sums mod p)
            moments = []
            sizes = []
            for g, e_g in ((0, e_even), (1, e_odd)):
                gsize = FIRST_GROUP_SIZE if g == 0 else SECOND_GROUP_SIZE
                ca = az_cols[g][:gsize]
                cb = bz_cols[g][:gsize]
                moments.append(FrVec.moment(e_g, ca, cb))
                sizes.append(gsize)
            extended = []
            for j, _target in enumerate(us.OUTER_TARGETS):
                coeffs = us.OUTER_COEFFS_PER_J[j]
                total = 0
                for g in (0, 1):
                    gsize = sizes[g]
                    M = moments[g]
                    w = [c % P for c in coeffs[:gsize]]
                    for a in range(gsize):
                        v = 0
                        for b in range(gsize):
                            v += w[b] * M[a * gsize + b]
                        total = (total + w[a] * (v % P)) % P
                extended.append(total)
        else:
            extended = []
            for j, _target in enumerate(us.OUTER_TARGETS):
                coeffs = us.OUTER_COEFFS_PER_J[j]
                total = 0
                for g, e_g in ((0, e_even), (1, e_odd)):
                    gsize = FIRST_GROUP_SIZE if g == 0 else SECOND_GROUP_SIZE
                    az_y = _combine_cols(az_cols[g], coeffs[:gsize])
                    bz_y = _combine_cols(bz_cols[g], coeffs[:gsize])
                    total = (total + FrVec.triple_inner(e_g, az_y, bz_y)) % P
                extended.append(total)

        return us.build_uniskip_first_round_poly(
            us.OUTER_DOMAIN, us.OUTER_DEGREE, extended, self.tau_high)

    def bind_first_round(self, r0: int, uni_skip_claim: int) -> None:
        self.current_round = 1
        self.current_claim = uni_skip_claim % P
        self.lagrange_evals_r0 = us.lagrange_evals(us.OUTER_DOMAIN, r0)
        self._materialize()

    # -- linear phase -------------------------------------------------------
    def _materialize(self) -> None:
        """az/bz tables over (x_out ‖ x_in ‖ group) with time_step = idx>>1
        (reference materializeLinearPhasePolynomials): the group-g lane is the
        Lagrange-at-r0 combination of the group's constraint columns."""
        from ..native.frvec import FrVec

        lam = self.lagrange_evals_r0
        az_cols, bz_cols = self._cols()
        az0 = _combine_cols(az_cols[0], lam[:FIRST_GROUP_SIZE])
        az1 = _combine_cols(az_cols[1], lam[:SECOND_GROUP_SIZE])
        bz0 = _combine_cols(bz_cols[0], lam[:FIRST_GROUP_SIZE])
        bz1 = _combine_cols(bz_cols[1], lam[:SECOND_GROUP_SIZE])
        self.az = FrVec.interleave(az0, az1)
        self.bz = FrVec.interleave(bz0, bz1)
        if self.backend_kind in ("device", "mesh"):
            from .device_outer import DeviceOuterRounds

            self._dev = DeviceOuterRounds(self.az, self.bz, se=self.split_eq,
                                          device=self.device, mesh=self.mesh)
            self.az = self.bz = None

    def num_remaining_rounds(self) -> int:
        # 1 streaming + num_cycle_vars (reference: numRounds)
        return len(self.full_tau) - 1

    def compute_remaining_round_poly(self) -> list[int]:
        """Gruen cubic evals [s(0), s(1), s(2), s(3)]."""
        if self._dev is not None:
            t0, tinf = self._dev.round_evals()
            return self._cubic_round_poly(t0, tinf, self.current_claim)

        se = self.split_eq
        # eq weights over pair index i: E_out[head_out] x E_in[head_in]
        head = se.current_index - 1
        head_out = min(head, se.m)
        head_in = head - head_out
        E_out = se.E_out_vec[min(head_out, len(se.E_out_vec) - 1)]
        E_in = se.E_in_vec[min(head_in, len(se.E_in_vec) - 1)]

        from ..native.frvec import FrVec

        n2 = self.az.n // 2
        n_out = max(1, n2 >> head_in)
        n_in = min(1 << head_in, n2)
        t0, tinf = FrVec.gruen_quad(FrVec.from_ints(E_out[:n_out]),
                                    FrVec.from_ints(E_in[:n_in]), head_in,
                                    self.az, self.bz, n2)
        return self._cubic_round_poly(t0, tinf, self.current_claim)

    def _cubic_round_poly(self, q0: int, qinf: int, claim: int) -> list[int]:
        """split_eq.computeCubicRoundPoly (split_eq.zig:353-441)."""
        se = self.split_eq
        if se.current_index == 0:
            return [claim, 0, 0, 0]
        tau_c = se.tau[se.current_index - 1]
        eq0 = se.current_scalar * (1 - tau_c) % P
        eq1 = se.current_scalar * tau_c % P
        slope = (eq1 - eq0) % P
        l0, l1 = eq0, eq1
        l2 = (eq0 + 2 * slope) % P
        l3 = (eq0 + 3 * slope) % P
        c = q0 % P
        e = qinf % P
        q1 = 0 if l1 == 0 else (claim - l0 * c) % P * pow(l1, -1, P) % P
        q2 = (2 * q1 - c + 2 * e) % P
        q3 = (q2 + q1 - c + 4 * e) % P
        return [l0 * c % P, l1 * q1 % P, l2 * q2 % P, l3 * q3 % P]

    def bind_remaining_round(self, r: int) -> None:
        if self.current_round == 1:
            self.r_stream = r
        self.split_eq.bind(r)
        if self._dev is not None:
            self._dev.bind(r)
            self.current_round += 1
            return
        self.az = self.az.fold_adj(r)
        self.bz = self.bz.fold_adj(r)
        self.current_round += 1

    def update_claim(self, evals4: list[int], r: int) -> None:
        coeffs = unipoly.interpolate_degree3(evals4)
        self.current_claim = unipoly.horner_eval(coeffs, r)


@dataclass
class Stage1Proof:
    uni_skip_coeffs: list[int] = dfield(default_factory=list)
    compressed_polys: list[list[int]] = dfield(default_factory=list)
    challenges: list[int] = dfield(default_factory=list)
    r0: int = 0
    uni_skip_claim: int = 0
    wcols: list | None = None  # FrVec witness columns (stage-3/claims reuse)


def prove_stage1_jolt(padded_steps, tau: list[int], transcript,
                      witness_rows=None, backend: str = "host",
                      device=None, witness_cols=None,
                      mesh=None) -> Stage1Proof:
    """Full stage-1 flow with exact transcript discipline
    (proof_converter.zig:380-540). `tau` must already have been sampled from
    the same transcript (num_cycle_vars + 2 values). Pass witness_rows (row
    matrix) or witness_cols (43 FrVec columns — the production columnar
    path) to prove over a caller-built witness.

    backend selects where the remaining-round hot loops run ("host",
    "device" on `device`, or "mesh" on `mesh` — see device_outer); the
    proof bytes are identical."""
    witnesses = None
    if witness_cols is None:
        witnesses = witness_rows if witness_rows is not None \
            else ri.witness_matrix(padded_steps)
    proof = Stage1Proof()

    prover = StreamingOuterProver(witnesses, tau, witness_cols=witness_cols)
    s1 = prover.compute_first_round_poly()
    proof.uni_skip_coeffs = s1

    transcript.append_message(b"UncompressedUniPoly_begin")
    for c in s1:
        transcript.append_scalar(c)
    transcript.append_message(b"UncompressedUniPoly_end")
    r0 = transcript.challenge_scalar()
    proof.r0 = r0

    lagrange_tau_r0 = us.lagrange_kernel(us.OUTER_DOMAIN, r0, tau[-1])
    cols = prover._cols()
    wcols = prover._wcols
    prover = StreamingOuterProver(witnesses, tau, lagrange_tau_r0,
                                  backend=backend, device=device,
                                  witness_cols=witness_cols, mesh=mesh)
    prover._az_cols, prover._bz_cols = cols
    prover._wcols = wcols
    proof.wcols = wcols  # witness columns, reused by later stages
    uni_skip_claim = unipoly.horner_eval(s1, r0)
    proof.uni_skip_claim = uni_skip_claim
    prover.bind_first_round(r0, uni_skip_claim)

    transcript.append_scalar(uni_skip_claim)  # cache_openings
    transcript.append_scalar(uni_skip_claim)  # batched input claim
    batching_coeff = transcript.challenge_scalar_full()
    prover.current_claim = uni_skip_claim

    for _ in range(prover.num_remaining_rounds()):
        raw = prover.compute_remaining_round_poly()
        scaled = [v * batching_coeff % P for v in raw]
        compressed = unipoly.evals_to_compressed(scaled)
        proof.compressed_polys.append(compressed)

        transcript.append_message(b"UniPoly_begin")
        for c in compressed:
            transcript.append_scalar(c)
        transcript.append_message(b"UniPoly_end")
        r = transcript.challenge_scalar()
        proof.challenges.append(r)
        prover.bind_remaining_round(r)
        prover.update_claim(raw, r)

    return proof
