"""The control of the comparison that decides `correct`, at a cell's own
size: the program with one guarantee that the configuration states broken
(its Blake2b transcript absorbs no GT commitment, so the challenges no longer
bind what was committed), its proofs judged by the reference exactly as a
run judges the window's. Every line it prints must read as not correct; with
--unbroken the same proves, the program as it is, must read as correct.

    python3 zkbench/control.py --workload <cell> --seeds 1,2,3 --proofs 4

It runs the program on the cell's device (cuda:0, or --device cpu), one
JSON line a seed.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
from contextlib import contextmanager, nullcontext

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from zkbench import guest, harness  # noqa: E402
from zkbench.reference import judge  # noqa: E402


@contextmanager
def commitments_unabsorbed():
    """The program's transcript with its GT absorb made a no-op."""
    from zolt_tpu_torch.transcript import blake2b

    cls = blake2b.Blake2bTranscript
    orig = cls.append_gt
    cls.append_gt = lambda self, gt_bytes: None
    try:
        yield
    finally:
        cls.append_gt = orig


def judge_control(cell_name: str, seed: int, proofs: int, *,
                  config: dict | None = None, broken: bool = True,
                  device: str = "cuda:0") -> dict:
    """The checks of `proofs` guests of the cell proved by the control (or,
    unbroken, by the program)."""
    from zolt_tpu_torch.utils.log import metrics
    from zolt_tpu_torch.zkvm.pipeline import prove_jolt

    bench = harness.load_bench()
    cell = next(w for w in bench["workloads"] if w["name"] == cell_name)
    config = config or harness.load_json("configs", f"{cell['config']}.json")
    mix = guest.load_mix(cell["traffic"], harness.ZKBENCH)
    tmp = tempfile.mkdtemp(prefix="zkbench-control-")
    try:
        path_of = guest.elf_writer(mix, config["log_t"], seed, tmp)
        with commitments_unabsorbed() if broken else nullcontext():
            recs = [harness.prove_one(prove_jolt, metrics, path_of(i), i,
                                      config, device, lambda: None)
                    for i in range(proofs)]
        checks, _, _ = judge.judge(recs, path_of, config, seed)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--proofs", type=int, default=4)
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--unbroken", action="store_true")
    args = ap.parse_args(argv)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        checks = judge_control(args.workload, seed, args.proofs,
                               broken=not args.unbroken, device=args.device)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": not args.unbroken,
                          "correct": judge.is_correct(checks),
                          "checks": checks,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
