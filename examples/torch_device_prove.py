"""Device-tier proving with the port (zolt_tpu_torch): the same
Jolt-format proof, with the wide sumcheck instances (stage-1 az/bz
rounds, stage-2 product/instruction, stage-4 RAM val-evaluation/val-final)
and the row MSMs on the card, byte-identical to the host prover — the
port of examples/device_prove.py.

    python examples/torch_device_prove.py [--device cuda|cpu]

backend="host" is the host C tier; backend="device" runs on --device (the
GPU by default; "cpu" runs the kernels' plain torch versions). To shard
the same instances over every CUDA device of a host:

    from zolt_tpu_torch.parallel import make_mesh
    prove_jolt(elf, backend="mesh", mesh=make_mesh())
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from zolt_tpu_torch.utils import require_cuda
from zolt_tpu_torch.vm import elf as elf_mod
from zolt_tpu_torch.vm.guest import Asm
from zolt_tpu_torch.vm.layout import MemoryConfig, MemoryLayout
from zolt_tpu_torch.zkvm.pipeline import prove_jolt


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    require_cuda(args.device, "torch_device_prove")
    lay = MemoryLayout.create(MemoryConfig(program_size=1024))
    a = Asm()
    a.addi(1, 0, 30)            # sum 1..30
    a.label("loop")
    a.add(2, 2, 1)
    a.addi(1, 1, -1)
    a.bne(1, 0, "loop")
    a.halt(lay, provable=True)

    with tempfile.NamedTemporaryFile(suffix=".elf") as f:
        f.write(elf_mod.write_minimal_elf(a.bytes()))
        f.flush()

        host = prove_jolt(f.name, backend="host").conv.proof \
            .serialize_with_dory()
        dev = prove_jolt(f.name, backend="device", device=args.device) \
            .conv.proof.serialize_with_dory()

    print(f"host proof:   {len(host)} bytes")
    print(f"device proof: {len(dev)} bytes")
    print(f"byte-identical: {dev == host}")
    assert dev == host


if __name__ == "__main__":
    main()
