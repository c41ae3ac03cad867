"""End-to-end Jolt-format pipeline with the port (zolt_tpu_torch): emulate,
commit, derive tau, run all 7 stages, serialize the arkworks proof — the
port of examples/full_pipeline.py.

    python examples/torch_full_pipeline.py ELF [--device cuda|cpu]

The prove runs on --device (the GPU by default; "cpu" runs the kernels'
plain torch versions).
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from zolt_tpu_torch.utils import require_cuda
from zolt_tpu_torch.zkvm.pipeline import prove_jolt


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("elf", help="the RISC-V guest to prove")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    require_cuda(args.device, "torch_full_pipeline")
    res = prove_jolt(args.elf, with_joint_proof=True, device=args.device)
    proof = res.conv.proof
    blob = proof.serialize_with_dory()
    print(f"trace: {res.emulator.cycle} cycles (padded {len(res.padded_steps)})")
    print(f"commitments: {len(proof.commitments)} GT elements")
    print(f"opening claims: {len(proof.opening_claims)}")
    print(f"stage rounds: "
          f"{[len(getattr(proof, f'stage{i}_sumcheck').compressed_polys) for i in range(1, 8)]}")
    print(f"serialized proof: {len(blob)} bytes")


if __name__ == "__main__":
    main()
