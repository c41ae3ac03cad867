"""BN254 field arithmetic on the card with the port (zolt_tpu_torch): a
batch of Montgomery products, sums and a batch inversion, cross-checked
against the host bigint oracle — the port of examples/field_arithmetic.py.

    python examples/torch_field_arithmetic.py [--device cuda|cpu]

The batch inversion is kernel F (csrc/field_inv.cu) on --device (the GPU
by default; "cpu" runs the plain torch versions).
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from zolt_tpu_torch.field import FR, limb
from zolt_tpu_torch.field.limb import FR_C
from zolt_tpu_torch.utils import require_cuda


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    require_cuda(args.device, "torch_field_arithmetic")
    rng = np.random.default_rng(42)
    xs = [int.from_bytes(rng.bytes(40), "little") % FR.p for _ in range(8)]
    ys = [int.from_bytes(rng.bytes(40), "little") % FR.p for _ in range(8)]

    X = limb.encode(xs, FR_C, args.device)
    Y = limb.encode(ys, FR_C, args.device)
    prod = limb.decode(limb.mont_mul(X, Y, FR_C), FR_C)
    sum_ = limb.decode(limb.add(X, Y, FR_C), FR_C)
    inv = limb.decode(limb.batch_inverse(X, FR_C), FR_C)

    print("BN254 scalar field (Fr)")
    print(f"  p = {FR.p:#x}")
    for i in range(3):
        print(f"  x[{i}]*y[{i}] mod p = {int(prod[i]):#x}")
        assert int(prod[i]) == xs[i] * ys[i] % FR.p
        assert int(sum_[i]) == (xs[i] + ys[i]) % FR.p
        assert int(inv[i]) * xs[i] % FR.p == 1
    print("device results match the host oracle ✔")


if __name__ == "__main__":
    main()
