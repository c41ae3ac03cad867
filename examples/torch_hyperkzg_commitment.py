"""HyperKZG commit/open/verify with the port (zolt_tpu_torch) — the port
of examples/hyperkzg_commitment.py.

    python examples/torch_hyperkzg_commitment.py [--device cuda|cpu]

The commitments' MSMs run the Pippenger (kernels C, D and E) on --device
(the GPU by default; "cpu" runs their plain torch versions); the pairing
check of verify runs on the host.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from zolt_tpu_torch.field import limb
from zolt_tpu_torch.field.params import FR
from zolt_tpu_torch.pcs import hyperkzg, srs
from zolt_tpu_torch.poly import dense
from zolt_tpu_torch.transcript import Blake2bTranscript
from zolt_tpu_torch.utils import require_cuda


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    require_cuda(args.device, "torch_hyperkzg_commitment")
    poly = [(i * 31 + 5) % FR.p for i in range(16)]  # 4-variable multilinear
    setup = srs.insecure_setup(64)
    commitment = hyperkzg.commit_ints(setup, poly, device=args.device)
    print(f"commitment: ({commitment[0]:#x}, {commitment[1]:#x})")

    point = [3, 5, 7, 11]
    value = dense.evaluate(limb.encode(poly, device=args.device), point)
    proof = hyperkzg.open_at(setup, poly, point, Blake2bTranscript(b"hkzg"),
                             device=args.device)
    ok = hyperkzg.verify(setup, commitment, point, value, proof,
                         Blake2bTranscript(b"hkzg"))
    print(f"opening value: {value:#x}, verified: {ok}")
    assert ok


if __name__ == "__main__":
    main()
