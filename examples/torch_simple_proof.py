"""Prove + verify a small program with the port's reference-parity internal
prover (zolt_tpu_torch) — the port of examples/simple_proof.py.

    python examples/torch_simple_proof.py [--device cuda|cpu]

The commitments, stage 1's openings and stage 4 run on --device (the GPU
by default; "cpu" runs the kernels' plain torch versions).
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from zolt_tpu_torch.vm import Emulator, MemoryConfig, pad_with_noop
from zolt_tpu_torch.zkvm.internal import prove_internal, verify_internal


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    code = b"".join(w.to_bytes(4, "little")
                    for w in (0x00500093, 0x02A00113, 0x002081B3, 0x0000006F))
    emu = Emulator(MemoryConfig(program_size=256))
    emu.load_program(code)
    emu.run()
    padded = pad_with_noop(list(emu.trace))
    proof = prove_internal(emu, padded, code, device=args.device)
    blob = proof.serialize()
    print(f"proof: {len(blob)} bytes, stages: "
          f"{[len(sp.round_polys) for sp in proof.stage_proofs]}")
    assert verify_internal(proof)
    print("verified ✔")


if __name__ == "__main__":
    main()
