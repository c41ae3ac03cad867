"""Jolt-compatible 7-stage proof converter (orchestration).

Mirrors the reference's ProofConverter.convertWithTranscript flow
(src/zkvm/proof_converter.zig:967-2700). Round-1 build status:

  stage 1: BIT-EXACT (streaming_outer.py, verified vs logs/zolt.log)
  stage 1→2 bridge: 36 R1CS input opening claims at r_cycle, absorbed in
    Jolt's ALL_R1CS_INPUTS order (proof_converter.zig:690-770) — BIT-EXACT
  stage 2: product-virtual UniSkip (deg-12, 13 coeffs) — BIT-EXACT
  stages 2 batch / 3..7: follow-on rounds.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dfield

from ..field.params import FR
from ..poly import unipoly
from ..r1cs import inputs as ri
from ..r1cs import uniskip as us
from .jolt_types import JoltProof, OpeningClaims, OpeningId, SumcheckId, UniSkipFirstRoundProof, VirtualPolynomial
from .streaming_outer import Stage1Proof, prove_stage1_jolt

P = FR.p

# Jolt's ALL_R1CS_INPUTS order -> our witness indices (identical layout,
# OpFlags 0..12 are FlagAddOperands..FlagIsFirstInSequence)
R1CS_VIRTUAL_POLYS: list[VirtualPolynomial] = (
    [VirtualPolynomial.named(n) for n in (
        "LeftInstructionInput", "RightInstructionInput", "Product",
        "WriteLookupOutputToRD", "WritePCtoRD", "ShouldBranch", "PC",
        "UnexpandedPC", "Imm", "RamAddress", "Rs1Value", "Rs2Value",
        "RdWriteValue", "RamReadValue", "RamWriteValue", "LeftLookupOperand",
        "RightLookupOperand", "NextUnexpandedPC", "NextPC", "NextIsVirtual",
        "NextIsFirstInSequence", "LookupOutput", "ShouldJump")]
    + [VirtualPolynomial.named("OpFlags", i) for i in range(13)]
)


def eq_evals_be(r: list[int], size: int) -> list[int]:
    """Big-endian eq table (r[0] = MSB) of `size` entries."""
    out = [1]
    for t in r:
        nxt = []
        for v in out:
            nxt.append(v * (1 - t) % P)
            nxt.append(v * t % P)
        out = nxt
    return out[:size]


def compute_claimed_inputs(witness_rows: list[list[int]], r_cycle_be: list[int],
                           wcols=None) -> list[int]:
    """MLE evals of all 43 witness columns at r_cycle (big-endian). With the
    stage-1 prover's cached FrVec columns, each eval is one native inner
    product against the eq table instead of an O(T·43) Python sweep."""
    if wcols is not None and wcols[0].n == (1 << len(r_cycle_be)):
        from ..native.frvec import FrVec

        eqv = FrVec.eq_table_be([c % P for c in r_cycle_be])
        return [wcols[i].inner(eqv) for i in range(ri.NUM_INPUTS)]
    eq = eq_evals_be(r_cycle_be, len(witness_rows))
    out = [0] * ri.NUM_INPUTS
    for t, w in enumerate(witness_rows):
        e = eq[t]
        if e == 0:
            continue
        for i in range(ri.NUM_INPUTS):
            if w[i]:
                out[i] = (out[i] + e * w[i]) % P
    return out


def add_spartan_outer_claims(claims: OpeningClaims, witness_rows, r_cycle_be,
                             uni_skip_claim: int, transcript,
                             wcols=None) -> list[int]:
    """Insert + absorb the 36 input claims (Jolt order) and the UniSkip claim."""
    input_evals = compute_claimed_inputs(witness_rows, r_cycle_be, wcols=wcols)
    for jolt_idx, poly in enumerate(R1CS_VIRTUAL_POLYS):
        claim = input_evals[jolt_idx]  # our layout matches Jolt's first 36
        claims.insert(OpeningId.virtual(poly, SumcheckId.SpartanOuter), claim)
        transcript.append_scalar(claim)
    claims.insert(
        OpeningId.virtual(VirtualPolynomial.named("UnivariateSkip"), SumcheckId.SpartanOuter),
        uni_skip_claim)
    return input_evals


# ---------------------------------------------------------------------------
# Stage 2: product-virtual UniSkip
# ---------------------------------------------------------------------------

PRODUCT_VIRTUAL_NAMES = ["Product", "WriteLookupOutputToRD", "WritePCtoRD",
                         "ShouldBranch", "ShouldJump"]


def extract_product_factors(wcols) -> list:
    """The 8 product-factor COLUMNS over all cycles (proof_converter.zig
    extractProductFactors, transposed to FrVec columns so the fused
    left/right combinations are native lincombs instead of per-row Python):
    [Left, Right, IsRdNotZero, WriteLookupOutputToRD, Jump, LookupOutput,
    Branch, NextIsNoop]. `wcols` are the 43 witness columns (stage 1's
    cache); NextIsNoop is IsNoop shifted to the next cycle with fill 1."""
    return [
        wcols[ri.Inp.LeftInstructionInput],
        wcols[ri.Inp.RightInstructionInput],
        wcols[ri.Inp.FlagIsRdNotZero],
        wcols[ri.Inp.FlagWriteLookupOutputToRD],
        wcols[ri.Inp.FlagJump],
        wcols[ri.Inp.LookupOutput],
        wcols[ri.Inp.FlagBranch],
        wcols[ri.Inp.FlagIsNoop].shifted_left(fill=1),
    ]


def fused_factor_columns(factors, coeffs):
    """(fused_left, fused_right) columns for one coefficient row:
    left = c0·F0 + (c1+c2)·F2 + c3·F5 + c4·F4,
    right = c0·F1 + c1·F3 + c2·F4 + c3·F6 + c4·(1 − F7)."""
    from ..native.frvec import FrVec

    one_minus_f7 = FrVec.filled(factors[7].n, 1).sub(factors[7])
    left = FrVec.lincomb([factors[0], factors[2], factors[5], factors[4]],
                         [coeffs[0], (coeffs[1] + coeffs[2]) % P,
                          coeffs[3], coeffs[4]])
    right = FrVec.lincomb([factors[1], factors[3], factors[4], factors[6],
                           one_minus_f7],
                          [coeffs[0], coeffs[1], coeffs[2], coeffs[3],
                           coeffs[4]])
    return left, right


def product_virtual_extended_evals(factors, tau: list[int]) -> list[int]:
    """Extended evals at {-3, 3, -4, 4} of the fused product polynomial
    (univariate_skip.zig computeProductVirtualExtendedEvals). The eq table
    uses only the first log2(padded_len) entries of tau — tau_high is
    excluded. Fully columnar: one eq table + per-target lincombs and a
    triple inner product, all in the native tier."""
    from ..native.frvec import FrVec

    padded = factors[0].n
    log_n = padded.bit_length() - 1
    eq = FrVec.eq_table_be([t % P for t in tau[:log_n]])
    out = []
    for j in range(us.PV_DEGREE):
        left, right = fused_factor_columns(factors, us.PV_COEFFS_PER_J[j])
        out.append(FrVec.triple_inner(eq, left, right))
    return out


@dataclass
class Stage2UniSkip:
    tau_high: int = 0
    base_evals: list[int] = dfield(default_factory=list)
    extended_evals: list[int] = dfield(default_factory=list)
    coeffs: list[int] = dfield(default_factory=list)
    r0: int = 0
    uni_skip_claim: int = 0


def prove_stage2_uniskip(stage1: Stage1Proof, input_evals: list[int],
                         transcript) -> Stage2UniSkip:
    """Sample τ_high, build the deg-12 product-virtual UniSkip poly, absorb,
    derive r0 and the claim (proof_converter.zig:1080-1200)."""
    out = Stage2UniSkip()
    out.tau_high = transcript.challenge_scalar()

    # base evals: the 5 product claims from stage 1 (our input layout indices)
    idx = {"Product": ri.Inp.Product, "WriteLookupOutputToRD": ri.Inp.WriteLookupOutputToRD,
           "WritePCtoRD": ri.Inp.WritePCtoRD, "ShouldBranch": ri.Inp.ShouldBranch,
           "ShouldJump": ri.Inp.ShouldJump}
    out.base_evals = [input_evals[idx[n]] for n in PRODUCT_VIRTUAL_NAMES]

    # tau_stage2 = [r_cycle_be ..., tau_high]
    r_cycle_be = list(reversed(stage1.challenges[1:]))
    tau2 = r_cycle_be + [out.tau_high]

    factors = extract_product_factors(stage1.wcols)
    out.extended_evals = product_virtual_extended_evals(factors, tau2)

    out.coeffs = us.build_uniskip_first_round_poly(
        us.PV_DOMAIN, us.PV_DEGREE, out.extended_evals, out.tau_high,
        base_evals=out.base_evals)

    transcript.append_message(b"UncompressedUniPoly_begin")
    for c in out.coeffs:
        transcript.append_scalar(c)
    transcript.append_message(b"UncompressedUniPoly_end")
    out.r0 = transcript.challenge_scalar()
    out.uni_skip_claim = unipoly.horner_eval(out.coeffs, out.r0)
    transcript.append_scalar(out.uni_skip_claim)
    return out


@dataclass
class JoltConversion:
    proof: JoltProof = dfield(default_factory=JoltProof)
    stage1: Stage1Proof | None = None
    stage2_uniskip: Stage2UniSkip | None = None
    stage2_batch: object = None
    stage3: object = None
    stage4: object = None
    stage5: object = None
    stage6: object = None
    stage7: object = None
    sound_lookups: object = None  # SoundLookupsProof (stages 8-12)
    input_evals: list[int] = dfield(default_factory=list)


def convert_with_transcript(padded_steps, tau: list[int], transcript,
                            emulator=None, log_ram_k: int = 16,
                            stages: int = 7, sound: bool = False,
                            stage1_backend: str | None = None,
                            device=None, mesh=None, bc_index=None,
                            backend: str | None = None) -> JoltConversion:
    """Drive the Jolt proof stages implemented so far. Pass the finished
    emulator to enable the stage-2 batched sumcheck (needs RAM traces).

    sound=True departs from reference byte-compatibility to make the
    stage-2 RAF/RWC instances publicly checkable: the synthetic
    termination access (which has no witness row) is excluded — the guest
    must write the termination word itself (guest halt convention) — and
    RAF aggregates with the BE-by-cycle eq table so its input claim equals
    the true sum; stages 5-12 run their real protocols.

    backend (None: the host tier) and stage1_backend (None: as backend)
    name where the wide rounds run: "device" on `device`, "mesh" on
    `mesh`, whose first device also holds the witness columns."""
    from ..utils.log import metrics, zlog

    s1_backend = stage1_backend or backend or "host"
    s1_mesh = mesh if s1_backend == "mesh" else None
    # stages 2-4 (and the device witness columns): on `device`, or on the
    # mesh with its first device for the unsharded tables
    s_dev, mesh = ((mesh.devices[0], mesh) if backend == "mesh"
                   else (device, None))

    conv = JoltConversion()
    with metrics.stage("witness_gen"):
        # expanded bytecode (virtual sequences) switches the PC column to
        # slot indexing — constraint #17 chains PC by +1 through sequences
        slots = (bc_index.slots_per_cycle(padded_steps)
                 if bc_index is not None and getattr(bc_index, "expanded", False)
                 else None)
        raw_cols: dict | None = {} if backend in ("device", "mesh") else None
        wcols = ri.witness_columns(padded_steps, sound=sound, slots=slots,
                                   raw_out=raw_cols)
    dev_store = None
    if raw_cols:
        # device column store: raw-uploaded, Montgomery-encoded on chip —
        # the stage engines' tables never ship as 32-byte residues
        from ..parallel.device_cols import WitnessStore

        dev_store = WitnessStore(raw_cols, len(padded_steps), device=s_dev)

    with metrics.stage("stage1"):
        conv.stage1 = prove_stage1_jolt(padded_steps, tau, transcript,
                                        witness_cols=wcols,
                                        backend=s1_backend, device=device,
                                        mesh=s1_mesh)
    zlog("STAGE1", f"uni_skip_claim={conv.stage1.uni_skip_claim} "
                   f"rounds={len(conv.stage1.compressed_polys)}")
    conv.proof.stage1_uni_skip = UniSkipFirstRoundProof(conv.stage1.uni_skip_coeffs)
    from .jolt_types import SumcheckInstanceProof

    conv.proof.stage1_sumcheck = SumcheckInstanceProof(conv.stage1.compressed_polys)

    r_cycle_be = list(reversed(conv.stage1.challenges[1:]))
    conv.input_evals = add_spartan_outer_claims(
        conv.proof.opening_claims, None, r_cycle_be,
        conv.stage1.uni_skip_claim, transcript, wcols=conv.stage1.wcols)

    conv.stage2_uniskip = prove_stage2_uniskip(
        conv.stage1, conv.input_evals, transcript)
    conv.proof.stage2_uni_skip = UniSkipFirstRoundProof(conv.stage2_uniskip.coeffs)
    conv.proof.opening_claims.insert(
        OpeningId.virtual(VirtualPolynomial.named("UnivariateSkip"),
                          SumcheckId.SpartanProductVirtualization),
        conv.stage2_uniskip.uni_skip_claim)

    if emulator is not None:
        from .jolt_types import SumcheckInstanceProof as SIP
        from .stage2_batch import prove_stage2_batch

        n_cycle_vars = len(tau) - 2
        s2u = conv.stage2_uniskip
        r_spartan = list(reversed(conv.stage1.challenges[1:]))
        tau2 = r_spartan + [s2u.tau_high]
        final_ram = dict(emulator.ram.memory)
        accesses = emulator.ram.trace
        if sound:
            accesses = _witness_accesses(padded_steps)
        with metrics.stage("stage2"):
            conv.stage2_batch = prove_stage2_batch(
                transcript,
                r0_stage2=s2u.r0,
                uni_skip_claim_stage2=s2u.uni_skip_claim,
                tau=tau2,
                r_spartan=r_spartan,
                wcols=conv.stage1.wcols,
                factors=extract_product_factors(conv.stage1.wcols),
                input_evals=conv.input_evals,
                n_cycle_vars=n_cycle_vars,
                log_ram_k=log_ram_k,
                accesses=accesses,
                sound=sound,
                initial_ram=getattr(emulator, "initial_memory", {}),
                final_ram=final_ram,
                layout=emulator.device.layout,
                program_inputs=bytes(emulator.device.inputs),
                program_outputs=bytes(emulator.device.outputs),
                is_panicking=emulator.device.panic,
                backend=backend, device=s_dev, mesh=mesh,
                dev_store=dev_store,
            )
        conv.proof.stage2_sumcheck = SIP(conv.stage2_batch.compressed_polys)
        zlog("STAGE2", f"rounds={len(conv.stage2_batch.compressed_polys)} "
                       f"final_claim={conv.stage2_batch.final_claim}")

        if stages < 3:
            return conv

        # Stage 3: Shift + InstructionInput + RegistersClaimReduction
        from .stage3 import prove_stage3

        b = conv.stage2_batch
        r_product = list(reversed(b.challenges[-n_cycle_vars:]))
        name_to_idx = {
            "NextUnexpandedPC": ri.Inp.NextUnexpandedPC,
            "NextPC": ri.Inp.NextPC,
            "NextIsVirtual": ri.Inp.NextIsVirtual,
            "NextIsFirstInSequence": ri.Inp.NextIsFirstInSequence,
            "RightInstructionInput": ri.Inp.RightInstructionInput,
            "LeftInstructionInput": ri.Inp.LeftInstructionInput,
            "RdWriteValue": ri.Inp.RdWriteValue,
            "Rs1Value": ri.Inp.Rs1Value,
            "Rs2Value": ri.Inp.Rs2Value,
        }

        def oc(name, sumcheck, index=0):
            if sumcheck == "SpartanOuter":
                return conv.input_evals[name_to_idx[name]]
            # SpartanProductVirtualization claims come from the stage-2 factors
            pv = {"NextIsNoop": 7, "LeftInstructionInput": 0,
                  "RightInstructionInput": 1}
            return b.factor_evals[pv[name]]

        _insert_stage2_claims(conv.proof.opening_claims, conv.stage2_batch)

        with metrics.stage("stage3"):
            conv.stage3 = prove_stage3(transcript, None, n_cycle_vars,
                                       r_spartan, r_product, oc,
                                       wcols=conv.stage1.wcols,
                                       backend=backend, device=s_dev,
                                       mesh=mesh,
                                       dev_store=dev_store)
        conv.proof.stage3_sumcheck = SIP(conv.stage3.compressed_polys)
        _insert_stage3_claims(conv.proof.opening_claims, conv.stage3)

        if stages < 4:
            return conv

        # Stage 4: registers RWC + RamValEvaluation + RamValFinal
        from .stage4 import prove_stage4

        with metrics.stage("stage4"):
            conv.stage4 = prove_stage4(
                transcript, padded_steps, accesses,
                getattr(emulator, "initial_memory", {}),
                emulator.device.layout.lowest_address(),
                conv.stage2_batch, conv.stage3,
                n_cycle_vars, log_ram_k, sound=sound,
                backend=backend, device=s_dev, mesh=mesh)
        conv.proof.stage4_sumcheck = SIP(conv.stage4.compressed_polys)
        _insert_stage4_claims(conv.proof.opening_claims, conv.stage4)

        if sound and stages >= 5:
            # Sound mode: the REAL stage 5-7 protocols behind the
            # reference's zero-proof placeholders
            # (proof_converter.zig:2628-2683): RegistersValEvaluation,
            # RamRa one-hot virtualization + Hamming booleanity, per-chunk
            # Booleanity + Hamming-weight linkage.
            from .stage5 import prove_stage5
            from .stage67 import prove_stage6, prove_stage7

            start_address = emulator.device.layout.lowest_address()
            with metrics.stage("stage5"):
                conv.stage5 = prove_stage5(transcript, padded_steps,
                                           conv.stage4, n_cycle_vars)
            conv.proof.stage5_sumcheck = SIP(conv.stage5.compressed_polys)
            with metrics.stage("stage6"):
                # the stage-2 cycle point is r_spartan (reversed stage-1
                # challenges), the BE eq weights both RWC and RAF use
                conv.stage6 = prove_stage6(
                    transcript, padded_steps, conv.stage2_batch.challenges,
                    r_spartan, n_cycle_vars, log_ram_k,
                    conv.stage2_batch.rwc_ra_claim,
                    conv.stage2_batch.raf_final_claim, start_address)
            conv.proof.stage6_sumcheck = SIP(conv.stage6.compressed_polys)
            with metrics.stage("stage7"):
                conv.stage7 = prove_stage7(
                    transcript, padded_steps, conv.stage6.challenges,
                    n_cycle_vars, log_ram_k, conv.stage6.hw_claim,
                    start_address)
            conv.proof.stage7_sumcheck = SIP(conv.stage7.compressed_polys)
            _insert_sound_stage567_claims(conv.proof.opening_claims, conv)
            if bc_index is not None:
                # Stages 8-12: the sound lookups + bytecode read arguments
                # (zkvm/sound_lookups.py) — real protocols behind the
                # reference's LookupsRAF/BytecodeRAF zero placeholders.
                from .sound_lookups import (prove_sound_lookups,
                                            serialize_sound_lookups)

                rc1_le = list(conv.stage1.challenges[1:])
                with metrics.stage("stages8_12"):
                    conv.sound_lookups = prove_sound_lookups(
                        transcript, padded_steps, bc_index,
                        conv.input_evals, rc1_le, n_cycle_vars)
                conv.proof.lookups_ext = serialize_sound_lookups(
                    conv.sound_lookups)
        else:
            # Compat: the reference emits zero sumcheck proofs + zero claims
            # (proof_converter.zig:2628-2683); no transcript absorption.
            _add_zero_stages(conv.proof, n_cycle_vars, log_k_chunk=4,
                             sound=sound)
    return conv


from collections import namedtuple

_WitnessAccess = namedtuple("_WitnessAccess", "op address pre_value post_value timestamp")


def _witness_accesses(padded_steps) -> list:
    """Sound-mode access list: derived directly from the trace steps so every
    access has a witness row (RamAddress/RamReadValue/RamWriteValue columns),
    making the RAF/RWC input claims equal their true sums. This includes
    I/O-region stores (e.g. the guest's termination write), which the
    emulator routes to the JoltDevice rather than the RAM trace.

    Sound mode models RAM as aligned 8-byte word slots (the Jolt doubleword
    RAM model — reference src/zkvm/ram/mod.zig word addressing), so every
    traced RAM op must be an aligned ld/sd. Sub-word ops (lw/lb/sh/...)
    would need virtual-sequence expansion (LD + shift/mask) to be provable;
    we reject them loudly at prove time instead of emitting a proof whose
    stage-2 output check cannot verify."""
    out = []
    for t, s in enumerate(padded_steps):
        if s.is_noop or s.memory_addr is None:
            continue
        f3 = (s.instruction >> 12) & 0x7
        if (f3 & 0x3) != 0x3 or s.memory_addr % 8:
            raise ValueError(
                f"sound mode requires aligned 8-byte RAM accesses (ld/sd): "
                f"cycle {t} pc=0x{s.pc:x} uses width {1 << (f3 & 0x3)} at "
                f"addr 0x{s.memory_addr:x}; rebuild the guest with "
                f"doubleword loads/stores (sub-word virtual sequences are "
                f"not implemented)")
        out.append(_WitnessAccess(
            "write" if s.is_memory_write else "read",
            s.memory_addr, s.memory_pre_value or 0, s.memory_value or 0, t))
    return out


def _insert_stage2_claims(claims: OpeningClaims, b) -> None:
    """Post-stage-2 opening claims (proof_converter.zig:1290-1400)."""
    from .jolt_types import CommittedPolynomial as CP

    V, S = VirtualPolynomial.named, SumcheckId
    VP = VirtualPolynomial
    OF, IF = VP.NAMES["OpFlags"], VP.NAMES["InstructionFlags"]
    claims.insert(OpeningId.virtual(V("RamRa"), S.RamRafEvaluation), b.raf_final_claim)
    claims.insert(OpeningId.virtual(V("RamVal"), S.RamReadWriteChecking), b.rwc_val_claim)
    claims.insert(OpeningId.virtual(V("RamRa"), S.RamReadWriteChecking), b.rwc_ra_claim)
    claims.insert(OpeningId.committed(CP(CP.RAM_INC), S.RamReadWriteChecking), b.rwc_inc_claim)
    pv = S.SpartanProductVirtualization
    factor_ids = [V("LeftInstructionInput"), V("RightInstructionInput"),
                  VP(IF, 6), VP(OF, 6), VP(OF, 5), V("LookupOutput"),
                  VP(IF, 4), V("NextIsNoop")]
    for oid, val in zip(factor_ids, b.factor_evals):
        claims.insert(OpeningId.virtual(oid, pv), val)
    claims.insert(OpeningId.virtual(V("RamValFinal"), S.RamOutputCheck), b.output_val_final_claim)
    claims.insert(OpeningId.virtual(V("RamValInit"), S.RamOutputCheck), b.output_val_init_claim)
    claims.insert(OpeningId.virtual(V("LookupOutput"), S.InstructionClaimReduction), b.instr_lookup_output_claim)
    claims.insert(OpeningId.virtual(V("LeftLookupOperand"), S.InstructionClaimReduction), b.instr_left_operand_claim)
    claims.insert(OpeningId.virtual(V("RightLookupOperand"), S.InstructionClaimReduction), b.instr_right_operand_claim)


def _insert_stage3_claims(claims: OpeningClaims, s3) -> None:
    """Post-stage-3 opening claims (proof_converter.zig:1513-1600).
    CircuitFlags: VirtualInstruction=7, IsFirstInSequence=12; InstructionFlags:
    LeftOperandIsPC=0, RightOperandIsImm=1, LeftOperandIsRs1Value=2,
    RightOperandIsRs2Value=3, IsNoop=5 (instruction/mod.zig:56-106)."""
    V, S = VirtualPolynomial.named, SumcheckId
    VP = VirtualPolynomial
    OF, IF = VP.NAMES["OpFlags"], VP.NAMES["InstructionFlags"]
    sh, ins, reg = s3.shift_claims, s3.instr_claims, s3.reg_claims
    claims.insert(OpeningId.virtual(V("UnexpandedPC"), S.SpartanShift), sh["unexpanded_pc"])
    claims.insert(OpeningId.virtual(V("PC"), S.SpartanShift), sh["pc"])
    claims.insert(OpeningId.virtual(VP(OF, 7), S.SpartanShift), sh["is_virtual"])
    claims.insert(OpeningId.virtual(VP(OF, 12), S.SpartanShift), sh["is_first_in_sequence"])
    claims.insert(OpeningId.virtual(VP(IF, 5), S.SpartanShift), sh["is_noop"])
    iv = S.InstructionInputVirtualization
    claims.insert(OpeningId.virtual(VP(IF, 2), iv), ins["left_is_rs1"])
    claims.insert(OpeningId.virtual(V("Rs1Value"), iv), ins["rs1_value"])
    claims.insert(OpeningId.virtual(VP(IF, 0), iv), ins["left_is_pc"])
    claims.insert(OpeningId.virtual(V("UnexpandedPC"), iv), ins["unexpanded_pc"])
    claims.insert(OpeningId.virtual(VP(IF, 3), iv), ins["right_is_rs2"])
    claims.insert(OpeningId.virtual(V("Rs2Value"), iv), ins["rs2_value"])
    claims.insert(OpeningId.virtual(VP(IF, 1), iv), ins["right_is_imm"])
    claims.insert(OpeningId.virtual(V("Imm"), iv), ins["imm"])
    claims.insert(OpeningId.virtual(V("RdWriteValue"), S.RegistersClaimReduction), reg["rd_write_value"])
    claims.insert(OpeningId.virtual(V("Rs1Value"), S.RegistersClaimReduction), reg["rs1_value"])
    claims.insert(OpeningId.virtual(V("Rs2Value"), S.RegistersClaimReduction), reg["rs2_value"])
    claims.insert(OpeningId.virtual(V("InstructionRafFlag"), S.BytecodeReadRaf), 0)
    claims.insert(OpeningId.virtual(VP(VP.NAMES["InstructionRa"], 0), S.BytecodeReadRaf), 0)
    claims.insert(OpeningId.virtual(V("RamRa"), S.IncClaimReduction), 0)


def _insert_stage4_claims(claims: OpeningClaims, s4) -> None:
    """The 9 stage-4 opening claims (proof_converter.zig:2550-2600)."""
    from .jolt_types import CommittedPolynomial as CP

    rc = s4.regs_claims
    V, C, S = VirtualPolynomial.named, CP, SumcheckId
    claims.insert(OpeningId.virtual(V("RegistersVal"), S.RegistersReadWriteChecking), rc["val"])
    claims.insert(OpeningId.virtual(V("Rs1Ra"), S.RegistersReadWriteChecking), rc["rs1_ra"])
    claims.insert(OpeningId.virtual(V("Rs2Ra"), S.RegistersReadWriteChecking), rc["rs2_ra"])
    claims.insert(OpeningId.virtual(V("RdWa"), S.RegistersReadWriteChecking), rc["rd_wa"])
    claims.insert(OpeningId.committed(C(C.RD_INC), S.RegistersReadWriteChecking), rc["inc"])
    claims.insert(OpeningId.virtual(V("RamRa"), S.RamValEvaluation), s4.val_eval_openings["wa"])
    claims.insert(OpeningId.committed(C(C.RAM_INC), S.RamValEvaluation), s4.val_eval_openings["inc"])
    claims.insert(OpeningId.committed(C(C.RAM_INC), S.RamValFinalEvaluation), s4.val_final_openings["inc"])
    claims.insert(OpeningId.virtual(V("RamRa"), S.RamValFinalEvaluation), s4.val_final_openings["wa"])


def _insert_sound_stage567_claims(claims: OpeningClaims, conv) -> None:
    """Sound-mode stage 5-7 opening claims. The committed ids (RdInc at the
    stage-5 point, one-hot RamRa chunks at the stage-6/7 points) feed the
    PCS batch opening; the virtual ids (RdWa, RamHammingWeight) are the
    protocol's terminal virtual claims."""
    from .jolt_types import CommittedPolynomial as CP

    V, S = VirtualPolynomial.named, SumcheckId
    s5, s6, s7 = conv.stage5, conv.stage6, conv.stage7
    claims.insert(OpeningId.virtual(V("RdWa"), S.RegistersValEvaluation), s5.wa_claim)
    claims.insert(OpeningId.committed(CP(CP.RD_INC), S.RegistersValEvaluation), s5.inc_claim)
    for d, v in enumerate(s6.oh_rwc_claims):
        claims.insert(OpeningId.committed(CP(CP.RAM_RA, d), S.RamReadWriteChecking), v)
    for d, v in enumerate(s6.oh_raf_claims):
        claims.insert(OpeningId.committed(CP(CP.RAM_RA, d), S.RamRafEvaluation), v)
    claims.insert(OpeningId.virtual(V("RamHammingWeight"), S.RamHammingBooleanity), s6.hw_claim)
    for d, v in enumerate(s7.oh_claims):
        claims.insert(OpeningId.committed(CP(CP.RAM_RA, d), S.Booleanity), v)


def _add_zero_stages(proof: JoltProof, n_cycle_vars: int, log_k_chunk: int,
                     sound: bool = False) -> None:
    from .jolt_types import CommittedPolynomial as CP

    V, C, S = VirtualPolynomial.named, CP, SumcheckId
    claims = proof.opening_claims

    def zero_proof(sc, rounds):
        sc.compressed_polys = [[0, 0, 0] for _ in range(rounds)]

    zero_proof(proof.stage5_sumcheck, n_cycle_vars)
    claims.insert(OpeningId.virtual(V("RdWa"), S.RegistersValEvaluation), 0)
    claims.insert(OpeningId.committed(C(C.RD_INC), S.RegistersValEvaluation), 0)
    claims.insert(OpeningId.virtual(V("RamRa"), S.RamRaClaimReduction), 0)
    if not sound:
        # The reference's stage-5 schedule overwrites the stage-2 RAF claim
        # with 0 (proof_converter.zig:2649-2651) — the absorbed value becomes
        # unrecoverable from the serialized proof, which breaks full
        # transcript replay (the root cause of the reference's unfinished
        # cross-verification). Sound mode keeps the real claim so the
        # verifier can replay end-to-end.
        claims.insert(OpeningId.virtual(V("RamRa"), S.RamRafEvaluation), 0)
    zero_proof(proof.stage6_sumcheck, n_cycle_vars)
    claims.insert(OpeningId.virtual(V("RamHammingWeight"), S.Booleanity), 0)
    claims.insert(OpeningId.virtual(V("RamHammingWeight"), S.RamHammingBooleanity), 0)
    claims.insert(OpeningId.committed(C(C.RD_INC), S.IncClaimReduction), 0)
    claims.insert(OpeningId.committed(C(C.RAM_INC), S.IncClaimReduction), 0)
    zero_proof(proof.stage7_sumcheck, log_k_chunk)
    claims.insert(OpeningId.virtual(V("RamHammingWeight"), S.HammingWeightClaimReduction), 0)
