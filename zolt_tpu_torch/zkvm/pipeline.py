"""End-to-end Jolt-format prove pipeline.

Mirrors the reference's proveJoltFormat flow (src/zkvm/mod.zig:780-1010):
run the ELF, Fiat-Shamir preamble, Dory-commit the witness polynomials,
absorb the GT commitments, derive τ, then drive the 7 proof stages and
assemble the serializable JoltProof.

The reference run loads Jolt's URS from a file when present and otherwise
falls back to the deterministic SHA3-seeded setup; we implement the
deterministic setup (bit-identical to the reference's own `DoryScheme.setup`)
and also accept pre-computed commitments (e.g. parsed from a golden proof)
for differential testing.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..transcript import Blake2bTranscript
from ..vm import pad_with_noop, run_elf
from .commitments import CommitmentPhase, commit_and_absorb, derive_tau
from .jolt_types import OneHotConfig, ReadWriteConfig
from .preamble import fiat_shamir_preamble
from .proof_converter import JoltConversion, convert_with_transcript

LOG_RAM_K = 16
BYTECODE_K = 1 << 16


@dataclass
class JoltPipelineResult:
    conv: JoltConversion
    commitments: CommitmentPhase | None
    tau: list[int]
    emulator: object
    padded_steps: list


def prove_jolt(elf_path: str, *, memory_size: int = 32768,
               srs=None, golden_commitments: list[bytes] | None = None,
               stages: int = 7, with_joint_proof: bool = False,
               sound: bool = False, stage1_backend: str | None = None,
               mesh=None, device="cuda",
               backend: str = "device") -> JoltPipelineResult:
    """Full Jolt-format proof for an ELF. `golden_commitments` replaces the
    commitment phase with externally-provided GT bytes (for differential
    testing against a proof produced with a different SRS).

    backend="device" (the default) runs the wide sumcheck rounds of stages
    1-4 and the row MSMs of the small-scalar committed polys as torch
    tensors on `device`: "cuda" (the default) launches the hand-written
    kernels of zolt_tpu_torch/csrc and raises where there is no CUDA
    device, "cpu" runs their plain torch versions. backend="mesh" shards
    those rounds over `mesh` (parallel/mesh.py; None: make_mesh(), every
    CUDA device), `device` ignored: the engines' tables split into one
    contiguous shard a mesh device, and the commitments, whose JAX
    counterpart takes no mesh, run as on backend="device" on the mesh's
    first device. backend="host" keeps every round and commitment on the
    host C tier. All give the same bytes.

    stage1_backend (None: as `backend`) runs stage 1's remaining rounds
    on "device" (on `device`, as the JAX package's stage1_backend="device"
    does), "mesh" (on `mesh`) or "host", whatever the other stages use.

    sound=True proves the real stages 5-12 in place of the reference's
    zero stages and binds every committed claim with one PCS batch opening
    (pcs/batch.py), whose reduction sumcheck runs on the stages' device or
    mesh too."""
    tiers = ("device", "host", "mesh")
    if backend not in tiers:
        raise ValueError(f"backend {backend!r}: 'device', 'host' or 'mesh'")
    if stage1_backend not in (None,) + tiers:
        raise ValueError(f"stage1_backend {stage1_backend!r}: 'device', "
                         f"'host', 'mesh' or None")
    stage1_backend = stage1_backend or backend
    if "device" in (backend, stage1_backend):
        if device is None:
            raise ValueError("backend='device' and stage1_backend='device' "
                             "need an explicit device")
        if torch.device(device).type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("prove_jolt runs on the GPU by default and "
                               "there is no CUDA device; pass device='cpu' "
                               "or backend='host'")
    else:
        device = None
    if "mesh" in (backend, stage1_backend):
        if mesh is None:
            from ..parallel.mesh import make_mesh

            mesh = make_mesh()
    else:
        mesh = None
    # the commitments and the batch opening run on the stages' device: the
    # mesh's first one on backend="mesh"
    stage_device = {"device": device,
                    "mesh": mesh.devices[0] if mesh is not None else None,
                    "host": None}[backend]
    if backend == "host":
        backend = None                  # the stages' spelling of the host tier
    # sound mode traces div-family instructions as virtual sequences
    # (vm/virtual.py) so every lookup is index-bound; reference-compat
    # traces keep the reference's direct div/rem rows
    emu = run_elf(elf_path, expand_virtual=sound)
    padded = pad_with_noop(list(emu.trace))
    if sound:
        # The sound val-final/output identities require every final-image
        # byte to be backed by a witness access. The guest must store the
        # termination word itself (Jolt guest-halt convention; the
        # emulator's synthetic ram.trace termination write has no witness
        # row). Fail fast instead of emitting an unverifiable proof.
        term = emu.device.layout.termination
        if not any((not s.is_noop) and s.is_memory_write
                   and s.memory_addr == term for s in padded):
            raise ValueError(
                "sound mode requires the guest to write the termination "
                "word itself (guest halt convention, e.g. "
                "Asm.halt(layout, provable=True)); this program terminates "
                "without a traced termination store")
    trace_length = len(padded)
    n_cycle_vars = trace_length.bit_length() - 1

    transcript = Blake2bTranscript(b"Jolt")
    fiat_shamir_preamble(
        transcript,
        max_input_size=emu.device.layout.max_input_size,
        max_output_size=emu.device.layout.max_output_size,
        memory_size=memory_size,
        inputs=bytes(emu.device.inputs),
        outputs=bytes(emu.device.outputs),
        panic=emu.device.panic,
        ram_k=1 << LOG_RAM_K,
        trace_length=trace_length,
    )

    from ..utils.log import metrics

    bytecode_len = len(getattr(emu, "program_bytecode", b"")) or _bytecode_len(elf_path)
    bc_index = None
    if sound:
        from .bytecode_tables import BytecodeIndex

        bc_index = BytecodeIndex.from_elf(elf_path)
    phase = None
    if golden_commitments is not None:
        for c in golden_commitments:
            transcript.append_gt(c)
        commitment_bytes = list(golden_commitments)
    else:
        with metrics.stage("commitments"):
            phase = commit_and_absorb(transcript, padded, bytecode_len,
                                      len(emu.ram.trace), srs=srs, sound=sound,
                                      log_ram_k=LOG_RAM_K,
                                      start_address=emu.device.layout.lowest_address(),
                                      bc_index=bc_index, device=stage_device)
        commitment_bytes = list(phase.commitments)

    tau = derive_tau(transcript, n_cycle_vars)
    conv = convert_with_transcript(padded, tau, transcript, emulator=emu,
                                   log_ram_k=LOG_RAM_K, stages=stages, sound=sound,
                                   stage1_backend=stage1_backend,
                                   device=device, mesh=mesh,
                                   bc_index=bc_index, backend=backend)

    proof = conv.proof
    proof.commitments = commitment_bytes
    proof.trace_length = trace_length
    proof.ram_k = 1 << LOG_RAM_K
    proof.bytecode_k = BYTECODE_K
    if sound:
        # address-first RAM RWC schedule (phase1 == 0): the honest prover's
        # binding order, consumed by the verifier's point bookkeeping
        proof.rw_config = ReadWriteConfig(0, LOG_RAM_K, n_cycle_vars // 2,
                                          ReadWriteConfig.LOG_REGISTER_COUNT)
    else:
        proof.rw_config = ReadWriteConfig.default(n_cycle_vars, LOG_RAM_K)
    proof.one_hot_config = OneHotConfig()
    proof.dory_layout = 0
    if sound and phase is not None and stages >= 4:
        # PCS binding: reduce the committed-poly opening claims to ONE Dory
        # opening on the live transcript (pcs/batch.py; verified by
        # verify_jolt against the absorbed GT commitments).
        from ..pcs import batch
        from .opening_binding import committed_claim_specs, sound_claim_specs

        values = [conv.stage4.regs_claims["inc"],
                  conv.stage2_batch.rwc_inc_claim,
                  conv.stage4.val_eval_openings["inc"],
                  conv.stage4.val_final_openings["inc"]]
        if stages >= 5 and conv.stage5 is not None:
            specs = sound_claim_specs(conv.stage2_batch.challenges,
                                      conv.stage4.challenges,
                                      conv.stage5.challenges,
                                      conv.stage6.challenges,
                                      conv.stage7.challenges, tau,
                                      n_cycle_vars, LOG_RAM_K,
                                      phase.instruction_d)
            values += ([conv.stage5.inc_claim]
                       + conv.stage6.oh_rwc_claims + conv.stage6.oh_raf_claims
                       + conv.stage7.oh_claims)
            if conv.sound_lookups is not None:
                from .bytecode_raf import bc_chunk_count, bc_chunk_points
                from .lookups_raf import chunk_points
                from .opening_binding import lookups_oh_specs

                slp = conv.sound_lookups
                bc_d = bc_chunk_count(bc_index.log_k)
                specs += lookups_oh_specs(
                    chunk_points(slp.s8.r_addr), slp.s9.challenges,
                    slp.s10.challenges,
                    bc_chunk_points(slp.s11.r_addr, bc_d),
                    slp.s12.challenges,
                    phase.instruction_d, phase.ram_d)
                values += (slp.s9.oh_claims + slp.s10.io_oh_claims
                           + slp.s10.bc_oh_claims + slp.s12.oh_claims)
        else:
            specs = committed_claim_specs(conv.stage2_batch.challenges,
                                          conv.stage4.challenges,
                                          n_cycle_vars, LOG_RAM_K)
        claims = [batch.BatchClaim(b"", pt, v, evals=phase.polys[ci])
                  for (_, ci, pt), v in zip(specs, values)]
        with metrics.stage("batch_opening"):
            bproof = batch.prove_batch_opening(transcript, claims, phase.srs,
                                               phase.global_num_vars,
                                               backend=backend,
                                               device=stage_device,
                                               mesh=mesh)
        proof.batch_opening = batch.serialize_batch_opening(bproof)
    if with_joint_proof:
        proof.joint_opening_proof = build_joint_opening_proof(
            elf_path, len(emu.ram.trace), trace_length)
    return JoltPipelineResult(conv=conv, commitments=phase, tau=tau,
                              emulator=emu, padded_steps=padded)


def build_joint_opening_proof(elf_path: str, memory_trace_len: int,
                              trace_length: int) -> bytes:
    """The proof-file's joint Dory opening (src/zkvm/mod.zig:1428-1450):
    bytecode evals opened at the fixed point (i+1)·12345 with the
    deterministic SRS sized to the largest committed polynomial."""
    from ..pcs import dory
    from ..vm import elf as elf_mod

    _, image = elf_mod.load_file(elf_path).flat_image()
    bytecode_size = max(2, 1 << (len(image) - 1).bit_length()) if image else 2
    memory_size_p = max(2, 1 << (max(memory_trace_len, 1) - 1).bit_length())
    max_size = max(bytecode_size, memory_size_p, trace_length)
    log_size = max(1, max_size.bit_length())
    evals = list(image) + [0] * (bytecode_size - len(image))
    point = [(i + 1) * 12345 for i in range(log_size)]
    srs = dory.setup(log_size)
    return dory.serialize_dory_proof(dory.open_fixed(srs, evals, point))


def _bytecode_len(elf_path: str) -> int:
    from ..vm import elf as elf_mod

    _, image = elf_mod.load_file(elf_path).flat_image()
    return len(image)
