"""Stage 3 batched sumcheck: Shift + InstructionInput + RegistersClaimReduction.

Byte-exact re-implementation of the reference's Stage3Prover protocol content
(src/zkvm/spartan/stage3_prover.zig). The reference computes Shift/Registers
rounds via an eq+1 prefix-suffix decomposition; here the same instances are
evaluated densely — both produce the true round polynomials of the instance,
so the compressed coefficients are identical:

  Shift (deg 2):  Σ_j eq+1(r_outer, j)·(upc+γpc+γ²virt+γ³first)(j)
                   + γ⁴·eq+1(r_product, j)·(1−noop(j))
  InstrInput (deg 3): Σ_j (eq(r_outer,j)+γ²eq(r_product,j))·(right+γ·left)(j)
      with left = l_rs1·rs1 + l_pc·upc, right = r_rs2·rs2 + r_imm·imm bound
      component-wise (the products make it cubic per round).
  Registers (deg 2): Σ_j eq(r_outer, j)·(rd + γrs1 + γ²rs2)(j)

All tables are big-endian in their r vectors and bound low-to-high; the batch
pads degree-2 instances to cubic via quadratic extrapolation; compressed
[c0,c2,c3] rounds with the 125-bit challenge; 16 final witness claims absorbed
in the reference order.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dfield

from ..field.params import FR
from ..poly import unipoly
from ..r1cs import inputs as ri
from .stage2_batch import _eq_table_be, _lagrange_eval_0123

P = FR.p


def _eq_plus_one_table(r: list[int], size: int) -> list[int]:
    """Dense eq+1 table built through the 4-table prefix–suffix
    decomposition (reference src/poly/mod.zig:464-581 /
    src/zkvm/spartan/prefix_suffix.zig): component tables are O(2^{n/2})."""
    from ..poly.special import EqPlusOnePrefixSuffix, eq_plus_one_evals

    if len(r) < 2:
        return eq_plus_one_evals(r)[:size]
    return EqPlusOnePrefixSuffix(r).dense_table(size)


@dataclass
class Stage3Result:
    compressed_polys: list[list[int]] = dfield(default_factory=list)
    challenges: list[int] = dfield(default_factory=list)
    gamma_shift_powers: list[int] = dfield(default_factory=list)
    gamma_instr: int = 0
    gamma_reg: int = 0
    batching_coeffs: list[int] = dfield(default_factory=list)
    input_claims: list[int] = dfield(default_factory=list)
    shift_claims: dict = dfield(default_factory=dict)
    instr_claims: dict = dfield(default_factory=dict)
    reg_claims: dict = dfield(default_factory=dict)
    final_claim: int = 0


def prove_stage3(transcript, witness_rows, n_cycle_vars: int,
                 r_outer: list[int], r_product: list[int],
                 opening_claims, wcols=None,
                 backend: str | None = None, device=None, mesh=None,
                 dev_store=None) -> Stage3Result:
    """opening_claims: callable (poly_name, sumcheck_name, index) -> int.

    backend "device" runs the wide rounds' product sums and folds on
    `device` ("mesh": sharded over `mesh`; parallel/stage_engine): 7
    dense product instances — the two Shift terms, the four
    InstructionInput 3-factor sums (their shared weight eq_outer +
    γ²·eq_prod precombined once; folding is linear so binding the combined
    table is identical to recombining each round), and the Registers
    instance — with per-round evals drained in ONE download.
    Proof bytes are identical to the host path."""
    res = Stage3Result()
    T = 1 << n_cycle_vars

    # gammas (challengeScalarFull flavor)
    g_shift = transcript.challenge_scalar_full()
    gp = [1]
    for _ in range(4):
        gp.append(gp[-1] * g_shift % P)
    res.gamma_shift_powers = gp
    g_instr = transcript.challenge_scalar_full()
    g_instr2 = g_instr * g_instr % P
    g_reg = transcript.challenge_scalar_full()
    g_reg2 = g_reg * g_reg % P
    res.gamma_instr, res.gamma_reg = g_instr, g_reg

    oc = opening_claims
    shift_input = (oc("NextUnexpandedPC", "SpartanOuter")
                   + gp[1] * oc("NextPC", "SpartanOuter")
                   + gp[2] * oc("NextIsVirtual", "SpartanOuter")
                   + gp[3] * oc("NextIsFirstInSequence", "SpartanOuter")
                   + gp[4] * (1 - oc("NextIsNoop", "SpartanProductVirtualization"))) % P
    instr_input = ((oc("RightInstructionInput", "SpartanOuter")
                    + g_instr * oc("LeftInstructionInput", "SpartanOuter"))
                   + g_instr2 * (oc("RightInstructionInput", "SpartanProductVirtualization")
                                 + g_instr * oc("LeftInstructionInput", "SpartanProductVirtualization"))) % P
    reg_input = (oc("RdWriteValue", "SpartanOuter")
                 + g_reg * oc("Rs1Value", "SpartanOuter")
                 + g_reg2 * oc("Rs2Value", "SpartanOuter")) % P
    res.input_claims = [shift_input, instr_input, reg_input]

    transcript.append_scalar(shift_input)
    transcript.append_scalar(instr_input)
    transcript.append_scalar(reg_input)
    alphas = [transcript.challenge_scalar_full() for _ in range(3)]
    res.batching_coeffs = alphas

    from ..native.frvec import FrVec

    use_dev_tables = (backend in ("device", "mesh") and T >= 4
                      and dev_store is not None)

    # dense tables
    eqp1_outer = FrVec.from_ints(_eq_plus_one_table(r_outer, T))
    eqp1_prod = FrVec.from_ints(_eq_plus_one_table(r_product, T))
    def _eq_vec(point):
        v = FrVec.eq_table_be([c % P for c in point])
        if v.n > T:
            v = FrVec(T, mont=v._mont) if v._mont is not None \
                else FrVec(T, ints=v._ints[:T])
        return v

    if not use_dev_tables:
        eq_outer = _eq_vec(r_outer)
        eq_prod = _eq_vec(r_product)

        def col(idx):
            if wcols is not None and wcols[0].n == T:
                return wcols[idx].copy()  # stage-1's cached column
            return FrVec.from_ints(
                [w[idx] % P for w in witness_rows[:T]]
                + [0] * (T - len(witness_rows)))

        upc = col(ri.Inp.UnexpandedPC)
        pc = col(ri.Inp.PC)
        virt = col(ri.Inp.FlagVirtualInstruction)
        first = col(ri.Inp.FlagIsFirstInSequence)
        noop = col(ri.Inp.FlagIsNoop)
        combo = upc.copy().axpy_(pc, gp[1]).axpy_(virt, gp[2]).axpy_(first, gp[3])
        one_minus_noop = FrVec.filled(T, 1).sub(noop)

        l_rs1 = col(ri.Inp.FlagLeftOperandIsRs1)
        rs1 = col(ri.Inp.Rs1Value)
        l_pc = col(ri.Inp.FlagLeftOperandIsPC)
        i_upc = col(ri.Inp.UnexpandedPC)
        r_rs2 = col(ri.Inp.FlagRightOperandIsRs2)
        rs2 = col(ri.Inp.Rs2Value)
        r_imm = col(ri.Inp.FlagRightOperandIsImm)
        imm = col(ri.Inp.Imm)

        rd = col(ri.Inp.RdWriteValue)
        r_rs1v = col(ri.Inp.Rs1Value)
        r_rs2v = col(ri.Inp.Rs2Value)
        reg_combo = rd.copy().axpy_(r_rs1v, g_reg).axpy_(r_rs2v, g_reg2)

    shift_claim, instr_claim, reg_claim = shift_input, instr_input, reg_input
    combined_claim = (shift_input * alphas[0] + instr_input * alphas[1]
                      + reg_input * alphas[2]) % P

    instr_arrays = ([l_rs1, rs1, l_pc, i_upc, r_rs2, rs2, r_imm, imm]
                    if not use_dev_tables else None)

    engines = None
    if backend in ("device", "mesh") and T >= 4:
        from ..parallel.stage_engine import (DeviceProductTables,
                                             drain_futures, flush_many,
                                             round_evals_many)

        on = dict(device=device, mesh=mesh)
        if dev_store is not None:
            # Raw-upload tier (parallel/device_cols): every engine table is
            # device-resident — witness columns raw-uploaded + encoded on
            # chip, eq tables derived from the challenge scalars, combos as
            # device axpy — instead of shipping 32-byte Montgomery residues
            # per element. Only the two EqPlusOne tables upload as residues.
            from ..parallel import device_cols as dc

            I = ri.Inp
            eq_outer_d = dc.eq_slice([c % P for c in r_outer], T, device)
            eq_prod_d = dc.eq_slice([c % P for c in r_product], T, device)
            eqw0_d = dc.axpy_dev(eq_outer_d, eq_prod_d, g_instr2)
            combo_d = dev_store.combo(
                [I.UnexpandedPC, I.PC, I.FlagVirtualInstruction,
                 I.FlagIsFirstInSequence], [1, gp[1], gp[2], gp[3]])
            reg_combo_d = dev_store.combo(
                [I.RdWriteValue, I.Rs1Value, I.Rs2Value], [1, g_reg, g_reg2])
            g = dev_store.get
            engines = [
                DeviceProductTables([eqp1_outer, combo_d],
                                    [g(I.UnexpandedPC), g(I.PC),
                                     g(I.FlagVirtualInstruction),
                                     g(I.FlagIsFirstInSequence),
                                     g(I.FlagIsNoop)],
                                    degree=2, **on),
                DeviceProductTables([eqp1_prod,
                                     dev_store.flags_not(I.FlagIsNoop)],
                                    degree=2, **on),
                DeviceProductTables([eqw0_d, g(I.FlagRightOperandIsRs2),
                                     g(I.Rs2Value)], degree=3, **on),
                DeviceProductTables([eqw0_d, g(I.FlagRightOperandIsImm),
                                     g(I.Imm)], degree=3, **on),
                DeviceProductTables([eqw0_d, g(I.FlagLeftOperandIsRs1),
                                     g(I.Rs1Value)], degree=3, **on),
                DeviceProductTables([eqw0_d, g(I.FlagLeftOperandIsPC),
                                     g(I.UnexpandedPC)], degree=3, **on),
                DeviceProductTables([eq_outer_d, reg_combo_d],
                                    [g(I.RdWriteValue), g(I.Rs1Value),
                                     g(I.Rs2Value)], degree=2, **on),
            ]
        else:
            eqw0 = eq_outer.copy().axpy_(eq_prod, g_instr2)
            engines = [
                DeviceProductTables([eqp1_outer, combo],
                                    [upc, pc, virt, first, noop],
                                    degree=2, **on),
                DeviceProductTables([eqp1_prod, one_minus_noop], degree=2,
                                    **on),
                DeviceProductTables([eqw0, r_rs2, rs2], degree=3, **on),
                DeviceProductTables([eqw0, r_imm, imm], degree=3, **on),
                DeviceProductTables([eqw0, l_rs1, rs1], degree=3, **on),
                DeviceProductTables([eqw0, l_pc, i_upc], degree=3, **on),
                DeviceProductTables([eq_outer, reg_combo],
                                    [rd, r_rs1v, r_rs2v], degree=2, **on),
            ]

    for rnd in range(n_cycle_vars):
        if engines is not None:
            # the seven instances in one grouped launch, one download
            evs = [e.round_evals() if v is None else v for e, v in
                   zip(engines, drain_futures(round_evals_many(engines)))]
            ab, cd = evs[0], evs[1]
            rr_r2, ri_im, lr_r1, lp_up = evs[2], evs[3], evs[4], evs[5]
            gg = evs[6]
        else:
            # Shift (deg 2): evals at 0, 2 (p1 from claim)
            ab = FrVec.prod_evals_adj([eqp1_outer, combo], 2)
            cd = FrVec.prod_evals_adj([eqp1_prod, one_minus_noop], 2)

            # InstrInput (deg 3): evals at 0, 2, 3 (p1 from claim); the weight
            # eq_outer + γ²·eq_prod folds linearly, so it is kept combined and
            # the product splits into four 3-factor sums
            eqw = eq_outer.copy().axpy_(eq_prod, g_instr2)
            rr_r2 = FrVec.prod_evals_adj([eqw, r_rs2, rs2], 3)
            ri_im = FrVec.prod_evals_adj([eqw, r_imm, imm], 3)
            lr_r1 = FrVec.prod_evals_adj([eqw, l_rs1, rs1], 3)
            lp_up = FrVec.prod_evals_adj([eqw, l_pc, i_upc], 3)

            # Registers (deg 2)
            gg = FrVec.prod_evals_adj([eq_outer, reg_combo], 2)

        s0 = (ab[0] + gp[4] * cd[0]) % P
        s2 = (ab[2] + gp[4] * cd[2]) % P
        shift_evals = [s0, (shift_claim - s0) % P, s2]

        iev = [(rr_r2[t] + ri_im[t] + g_instr * (lr_r1[t] + lp_up[t])) % P
               for t in range(4)]
        instr_evals = [iev[0], (instr_claim - iev[0]) % P, iev[2], iev[3]]

        g0, g2 = gg[0], gg[2]
        reg_evals = [g0, (reg_claim - g0) % P, g2]

        # combine (pad deg-2 to cubic: p3 = 3p2 - 3p1 + p0)
        shift_p3 = (3 * shift_evals[2] - 3 * shift_evals[1] + shift_evals[0]) % P
        reg_p3 = (3 * reg_evals[2] - 3 * reg_evals[1] + reg_evals[0]) % P
        combined = []
        for t in range(4):
            sv = shift_evals[t] if t < 3 else shift_p3
            iv = instr_evals[t]
            gv = reg_evals[t] if t < 3 else reg_p3
            combined.append((sv * alphas[0] + iv * alphas[1] + gv * alphas[2]) % P)

        coeffs = unipoly.interpolate(combined)
        compressed = unipoly.compress(coeffs)
        res.compressed_polys.append(compressed)
        transcript.append_message(b"UniPoly_begin")
        for c in compressed:
            transcript.append_scalar(c)
        transcript.append_message(b"UniPoly_end")
        r = transcript.challenge_scalar()
        res.challenges.append(r)

        combined_claim = unipoly.horner_eval(coeffs, r)
        shift_claim = unipoly.horner_eval(
            unipoly.interpolate(shift_evals), r)
        instr_claim = _lagrange_eval_0123(instr_evals, r)
        reg_claim = unipoly.horner_eval(unipoly.interpolate(reg_evals), r)

        # bind everything low-to-high
        if engines is not None:
            for e in engines:
                e.bind(r)
        else:
            eqp1_outer = eqp1_outer.fold_adj(r)
            eqp1_prod = eqp1_prod.fold_adj(r)
            combo = combo.fold_adj(r)
            one_minus_noop = one_minus_noop.fold_adj(r)
            upc, pc, virt, first, noop = (a.fold_adj(r)
                                          for a in (upc, pc, virt, first, noop))
            for k in range(len(instr_arrays)):
                instr_arrays[k] = instr_arrays[k].fold_adj(r)
            (l_rs1, rs1, l_pc, i_upc, r_rs2, rs2, r_imm, imm) = instr_arrays
            eq_outer = eq_outer.fold_adj(r)
            eq_prod = eq_prod.fold_adj(r)
            reg_combo = reg_combo.fold_adj(r)
            rd, r_rs1v, r_rs2v = (a.fold_adj(r) for a in (rd, r_rs1v, r_rs2v))

    res.final_claim = combined_claim
    res.instance_final_claims = [shift_claim, instr_claim, reg_claim]
    if engines is not None:
        flush_many(engines)          # the last binds' folds, one launch
        fa = engines[0].finals()     # eqp1_outer, combo, upc..noop
        f_rr = engines[2].finals()   # eqw, r_rs2, rs2
        f_ri = engines[3].finals()   # eqw, r_imm, imm
        f_lr = engines[4].finals()   # eqw, l_rs1, rs1
        f_lp = engines[5].finals()   # eqw, l_pc, i_upc
        fd = engines[6].finals()     # eq_outer, reg_combo, rd, rs1v, rs2v
        res.shift_claims = {"unexpanded_pc": fa[2], "pc": fa[3],
                            "is_virtual": fa[4],
                            "is_first_in_sequence": fa[5], "is_noop": fa[6]}
        res.instr_claims = {"left_is_rs1": f_lr[1], "rs1_value": f_lr[2],
                            "left_is_pc": f_lp[1], "unexpanded_pc": f_lp[2],
                            "right_is_rs2": f_rr[1], "rs2_value": f_rr[2],
                            "right_is_imm": f_ri[1], "imm": f_ri[2]}
        res.reg_claims = {"rd_write_value": fd[2], "rs1_value": fd[3],
                          "rs2_value": fd[4]}
    else:
        res.shift_claims = {"unexpanded_pc": upc.first(), "pc": pc.first(),
                            "is_virtual": virt.first(),
                            "is_first_in_sequence": first.first(),
                            "is_noop": noop.first()}
        res.instr_claims = {"left_is_rs1": l_rs1.first(), "rs1_value": rs1.first(),
                            "left_is_pc": l_pc.first(), "unexpanded_pc": i_upc.first(),
                            "right_is_rs2": r_rs2.first(), "rs2_value": rs2.first(),
                            "right_is_imm": r_imm.first(), "imm": imm.first()}
        res.reg_claims = {"rd_write_value": rd.first(), "rs1_value": r_rs1v.first(),
                          "rs2_value": r_rs2v.first()}

    # cache_openings absorption (stage3_prover.zig:703-726)
    for v in (res.shift_claims["unexpanded_pc"], res.shift_claims["pc"],
              res.shift_claims["is_virtual"], res.shift_claims["is_first_in_sequence"],
              res.shift_claims["is_noop"],
              res.instr_claims["left_is_rs1"], res.instr_claims["rs1_value"],
              res.instr_claims["left_is_pc"], res.instr_claims["unexpanded_pc"],
              res.instr_claims["right_is_rs2"], res.instr_claims["rs2_value"],
              res.instr_claims["right_is_imm"], res.instr_claims["imm"],
              res.reg_claims["rd_write_value"], res.reg_claims["rs1_value"],
              res.reg_claims["rs2_value"]):
        transcript.append_scalar(v)
    return res
