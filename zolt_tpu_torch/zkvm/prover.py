"""Internal multi-stage prover/verifier orchestration (Keccak transcript).

The reference's MultiStageProver/MultiStageVerifier equivalent
(src/zkvm/prover.zig:241-1111, src/zkvm/verifier.zig:47-776): six stages over
one transcript, log_t/log_k recorded for verifier resync. Stage 3 (Lasso
instruction lookups) plugs in via zkvm/lasso.py. This is the legacy
("device-accelerated") container: every stage's sumcheck runs in
DeviceMleSumcheck on `device` (the GPU by default; "cpu" runs the
kernels' plain torch versions). The port of zolt_tpu/zkvm/prover.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dfield

from ..transcript import KeccakTranscript
from ..utils import require_cuda
from ..utils.log import metrics
from ..vm.layout import RAM_START_ADDRESS
from . import lasso, stages
from .stages import StageProof


@dataclass
class MultiStageProof:
    log_t: int = 0
    log_k: int = 0
    stage_proofs: list[StageProof] = dfield(default_factory=list)


def require_device(device, who: str) -> None:
    """Raise where `device` is None, or CUDA and there is none: the
    device is never guessed and nothing falls back to the CPU."""
    if device is None:
        raise ValueError(f"{who} needs an explicit device=")
    require_cuda(device, who)


def prove(padded_steps, memory_trace, lookup_entries=None, log_k: int = 16,
          start_address: int = RAM_START_ADDRESS,
          transcript: KeccakTranscript | None = None,
          device="cuda") -> MultiStageProof:
    """Prove all six stages over a padded trace + memory trace, each
    stage's sumcheck on `device`; the seconds of each stage go to
    utils.log.metrics ("stage1" .. "stage6")."""
    require_device(device, "the legacy prover")
    t = transcript or KeccakTranscript(b"Jolt")
    log_t = stages._ceil_log2(len(padded_steps))
    proof = MultiStageProof(log_t=log_t, log_k=log_k)

    with metrics.stage("stage1"):
        s1, _ = stages.prove_stage1(padded_steps, t, device)
    proof.stage_proofs.append(s1)
    with metrics.stage("stage2"):
        proof.stage_proofs.append(stages.prove_stage2(
            memory_trace, t, log_t, log_k, start_address, device))
    # Stage 3: Lasso instruction lookups
    with metrics.stage("stage3"):
        proof.stage_proofs.append(lasso.prove_stage3(
            lookup_entries or [], t, log_t, device=device))
    with metrics.stage("stage4"):
        proof.stage_proofs.append(stages.prove_stage4(
            memory_trace, t, log_t, log_k, start_address, device))
    with metrics.stage("stage5"):
        proof.stage_proofs.append(stages.prove_stage5(padded_steps, t, log_t,
                                                      device))
    with metrics.stage("stage6"):
        proof.stage_proofs.append(stages.prove_stage6(padded_steps, t, log_t,
                                                      device))
    return proof


def verify(proof: MultiStageProof, num_constraint_vars: int,
           start_address: int = RAM_START_ADDRESS,
           transcript: KeccakTranscript | None = None) -> bool:
    """Verify all stages; raises AssertionError with stage context on failure."""
    t = transcript or KeccakTranscript(b"Jolt")
    log_t, log_k = proof.log_t, proof.log_k

    stages.verify_stage1(proof.stage_proofs[0], t, num_constraint_vars)
    stages.verify_stage2(proof.stage_proofs[1], t, log_t, log_k, start_address)
    lasso.verify_stage3(proof.stage_proofs[2], t, log_t)
    stages.verify_stage4(proof.stage_proofs[3], t, log_t, log_k)
    stages.verify_stage5(proof.stage_proofs[4], t, log_t)
    stages.verify_stage6(proof.stage_proofs[5], t, log_t)
    return True


def prove_program(emulator, log_k: int = 16, min_pad: int = 256,
                  device="cuda") -> tuple[MultiStageProof, list]:
    """Convenience: pad the trace and prove from a finished emulator."""
    from ..vm import pad_with_noop

    padded = pad_with_noop(list(emulator.trace), min_pad=min_pad)
    proof = prove(padded, emulator.ram.trace, emulator.lookup_entries,
                  log_k=log_k, device=device)
    return proof, padded
