"""Interactive sumcheck over a product of multilinear polynomials with the
port's generic engine (zolt_tpu_torch.sumcheck) — the port of
examples/sumcheck_protocol.py.

    python examples/torch_sumcheck_protocol.py [--device cuda|cpu]

Each round's evals are one launch of the product-evals kernel and each
bind one fold on --device (the GPU by default; "cpu" runs their plain
torch versions).
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from zolt_tpu_torch.field import limb
from zolt_tpu_torch.field.params import FR
from zolt_tpu_torch.poly import dense
from zolt_tpu_torch.sumcheck.driver import (ProductSumcheck, run_sumcheck,
                                            verify_sumcheck)
from zolt_tpu_torch.transcript import Blake2bTranscript


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    n = 16
    a = [(i * 7 + 3) % FR.p for i in range(n)]
    b = [(i * i + 1) % FR.p for i in range(n)]
    claim = sum(x * y for x, y in zip(a, b)) % FR.p
    print(f"claim: sum_i a_i * b_i = {claim:#x}")

    polys = [limb.encode(a, device=args.device),
             limb.encode(b, device=args.device)]
    inst = ProductSumcheck(polys)
    proof = run_sumcheck(inst, Blake2bTranscript(b"example"), claim)

    final_claim, challenges = verify_sumcheck(
        proof, Blake2bTranscript(b"example"), claim,
        num_rounds=inst.num_rounds, degree=inst.degree)
    # final check: claim == A(r)·B(r)
    av = dense.evaluate(polys[0], challenges)
    bv = dense.evaluate(polys[1], challenges)
    ok = final_claim == av * bv % FR.p
    print(f"rounds: {len(proof.compressed_polys)}, verified: {ok}")
    assert ok


if __name__ == "__main__":
    main()
