"""RV64IMC emulation with the port (zolt_tpu_torch): run a small
hand-assembled program and inspect the trace — the port of
examples/risc_v_emulation.py.

    python examples/torch_risc_v_emulation.py [--device cuda|cpu]

The emulator runs on the host, as the JAX package's does; --device (the
GPU by default) holds the trace's program counters as a tensor there and
sums them, the first step of every witness column the provers build.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import torch

from zolt_tpu_torch.utils import require_cuda
from zolt_tpu_torch.vm import Emulator, MemoryConfig


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    require_cuda(args.device, "torch_risc_v_emulation")
    # addi x1,x0,5; addi x2,x0,0; add x2,x2,x1; addi x1,x1,-1; bne x1,x0,-8; j 0
    words = [0x00500093, 0x00000113, 0x00110133, 0xFFF08093, 0xFE101CE3, 0x0000006F]
    emu = Emulator(MemoryConfig(program_size=256))
    emu.load_program(b"".join(w.to_bytes(4, "little") for w in words))
    emu.run()
    pcs = torch.tensor([s.pc for s in emu.trace], dtype=torch.int64,
                       device=args.device)
    assert int(pcs.sum()) == sum(s.pc for s in emu.trace)
    print(f"terminated after {emu.cycle} cycles")
    print(f"x2 (sum 5+4+3+2+1) = {emu.registers.read(2)}")
    assert emu.registers.read(2) == 15
    for step in emu.trace[:5]:
        print(f"  cycle {step.cycle}: pc={step.pc:#x} instr={step.instruction:#010x}")


if __name__ == "__main__":
    main()
