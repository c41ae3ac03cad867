#!/usr/bin/env python3
"""Kernels A, B, C and D of two or more checkouts of the repository, on one
GPU, in turns.

    python3 experiments/g1_kernels/compare_g1.py [--c-only | --a-only] \
        ROOT ROOT [ROOT ...]

runs the measurements below once for each root in the order given, then
in the reverse order (two roots: parent, change, change, parent), each in
a process of its own (each root builds its own kernels), and prints one
JSON line a run, then the card's name and power limit. --c-only measures
kernel C alone, --a-only kernel A alone:

- kernel A (--a-only), on inputs this checkout makes once and hands to
  every run: the batch add at chip_smoke.py's 2^16 pairs, half of them
  edge cases, and at 2^16 generic pairs, the doubling of 2^16 points
  (device ms a call by torch.profiler, kernel names "g1_add_kernel" and
  "g1_double_kernel", 20 calls, and by CUDA events around each launch);
  and msm_mesh's fold at 2^16 points on four shards, its four passes'
  stacks of 4 x 2048 bucket points (captured from this checkout's
  msm_mesh on make_mesh(["cuda:0"] * 4)), folded by the root's
  `pt_sum` where it has one (one launch a pass), else by the ladder of
  `pt_add` that msm_mesh ran before it (three launches a pass): the
  launches and their ms by CUDA events around each launch, summed over
  the four passes, 20 times, and the device ms by torch.profiler; the
  registers of A's kernels; a sha256 of every result's words, which must
  agree across runs;

- kernel B (the row MSMs) at chip_smoke.py's sound shape (40 one-hot
  cubes of 2^20 in 2^10 x 2^10, one plane) and compat shape (32 polys of
  2^16 values below 16, 2^8 x 2^8, four planes), same seeds in both
  roots: device ms a call by torch.profiler (kernel name
  "row_msm_kernel", 20 calls) and by CUDA events around each launch;
- kernel C (the bucket sums) on the inputs this checkout makes once and
  hands to every run: chip_smoke.py's 2^16-point Pippenger (random
  scalars), and the internal prover's RAM post-values (2^17) and rd
  values (2^16) of the sum-loop guest at T = 2^16 over the first KZG SRS
  powers: device ms a call by torch.profiler (kernel names holding
  "bucket_kernel", 20 calls, also by kernel name: one a pass) and by CUDA
  events around each call, and a sha256 of the buckets in affine form,
  which must agree across runs;
- kernel D (the window sums) on the buckets of the 2^16-point Pippenger
  of chip_smoke.py: device ms a call, the same two ways;
- the T = 2^16 commitment phase alone (commit_and_absorb on "cuda"), in
  compat and sound mode, three times each under torch.profiler: each
  kernel B launch's ms by CUDA events beside the launches the profiler
  recorded and their device µs.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
import subprocess
import sys
import tempfile
import time

# the checkout this script belongs to
HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


C_SHAPES = ("random_2^16", "ram_2^17", "rd_2^16")


def c_inputs(where: str) -> None:
    """Kernel C's inputs, made with this checkout's code and saved to
    `where` as {shape}.pt (CPU tensors: the affine table, valid, digits)."""
    sys.path.insert(0, HERE)
    import torch

    import chip_smoke
    from zolt_tpu_torch.msm import pippenger
    from zolt_tpu_torch.pcs import srs as srs_mod

    kzg = srs_mod.insecure_setup(1 << 17)
    pts, sc = chip_smoke.msm_inputs(kzg, 1 << 16, 16)
    polys = chip_smoke.internal_polys(*chip_smoke.opening_inputs(16))
    for name, (p, v) in zip(C_SHAPES, ((pts, sc),
                                       (kzg.powers_g1[:len(polys[1])],
                                        polys[1]),
                                       (kzg.powers_g1[:len(polys[2])],
                                        polys[2]))):
        ptab, valid = pippenger.affine_table(p)
        torch.save(dict(ptab=ptab, valid=valid,
                        digits=pippenger.int_digits(v, "cpu")),
                   os.path.join(where, f"{name}.pt"))


A_SHAPES = ("edge_2^16", "generic_2^16")


def a_inputs(where: str) -> None:
    """Kernel A's inputs, made with this checkout's code and saved to
    `where/a.pt` (CPU tensors): the batch pairs of A_SHAPES and msm_mesh's
    fold stacks at 2^16 points on four shards of cuda:0."""
    sys.path.insert(0, HERE)
    import torch

    import chip_smoke
    from zolt_tpu_torch.curve import device as dev
    from zolt_tpu_torch.msm import pippenger
    from zolt_tpu_torch.parallel import make_mesh
    from zolt_tpu_torch.pcs import srs as srs_mod

    out = {"edge_2^16": chip_smoke.g1_edge_pairs(1 << 16, 7),
           "generic_2^16": chip_smoke.g1_edge_pairs(1 << 16, 8,
                                                    generic=True)}
    kzg = srs_mod.insecure_setup(1 << 16)
    pts, sc = chip_smoke.msm_inputs(kzg, 1 << 16, 16)
    stacks, fold = [], dev.pt_sum

    def spy(stack):
        stacks.append(tuple(c.cpu() for c in stack))
        return fold(stack)

    spy.counts = fold.counts
    dev.pt_sum = spy
    try:
        pippenger.msm_mesh(make_mesh(["cuda:0"] * chip_smoke.MESH_SHARDS),
                           pts, sc)
    finally:
        dev.pt_sum = fold
    out["ladder"] = stacks
    torch.save(out, os.path.join(where, "a.pt"))


def run_a(inputs: str, smoke_here, device) -> dict:
    """Kernel A of the root on sys.path on a_inputs' tensors (see the
    docstring)."""
    import hashlib

    import torch

    from zolt_tpu_torch import _build
    from zolt_tpu_torch.curve import device as dev

    def digest(*tensors) -> str:
        h = hashlib.sha256()
        for t in tensors:
            h.update(t.cpu().numpy().tobytes())
        return h.hexdigest()

    t = torch.load(os.path.join(inputs, "a.pt"))
    out = {"ptxas_A": {k: v for k, v in smoke_here.ptxas_summary(
        _build.kernels().ptxas_log).items() if "g1_" in k}}
    for name in A_SHAPES:
        pa, pb = (tuple(c.cuda() for c in pt) for pt in t[name])
        out[f"A_add_{name}"] = dict(
            device(lambda: dev.pt_add(pa, pb), "g1_add_kernel", "zg1_add"),
            words_sha256=digest(*dev.pt_add(pa, pb)))
    pa = tuple(c.cuda() for c in t["edge_2^16"][0])
    out["A_double_2^16"] = dict(
        device(lambda: dev.pt_double(pa), "g1_double_kernel", "zg1_double"),
        words_sha256=digest(*dev.pt_double(pa)))

    stacks = [tuple(c.cuda() for c in st) for st in t["ladder"]]
    fused = hasattr(dev, "pt_sum")

    def fold(stack):
        if fused:
            return dev.pt_sum(stack)
        acc = tuple(c[0] for c in stack)
        for j in range(1, stack[0].shape[0]):
            acc = dev.pt_add(acc, tuple(c[j] for c in stack))
        return acc

    def msm_folds():
        return [fold(st) for st in stacks]

    entry = "zg1_sum" if fused else "zg1_add"
    kernel = "g1_sum_kernel" if fused else "g1_add_kernel"
    msm_folds()
    torch.cuda.synchronize()
    per_msm = []
    for _ in range(20):
        with smoke_here.launch_events(torch, entry) as ev:
            msm_folds()
        per_msm.append(ev)
    dev_ms = device(msm_folds, kernel, entry)
    out["A_ladder"] = {
        "entry": entry, "shape": list(stacks[0][0].shape),
        "passes": len(stacks), "launches": len(per_msm[0]),
        "events_ms_each_launch": per_msm[0],
        "events_ms_a_msm_min": round(min(sum(e) for e in per_msm), 4),
        "events_ms_a_msm_mean": round(sum(sum(e) for e in per_msm)
                                      / len(per_msm), 4),
        "profiler_ms_a_msm": dev_ms["profiler_ms"],
        "words_sha256": digest(*[c for r in msm_folds() for c in r])}
    return out


def run(root: str, inputs: str, c_only: bool, a_only: bool = False) -> dict:
    sys.path.insert(0, root)
    import hashlib

    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from zolt_tpu_torch import _build
    from zolt_tpu_torch.msm import pippenger, rows_device
    from zolt_tpu_torch.pcs import dory
    from zolt_tpu_torch.pcs import srs as srs_mod
    from zolt_tpu_torch.transcript import Blake2bTranscript
    from zolt_tpu_torch.zkvm.commitments import commit_and_absorb

    out = {"root": root}
    out["build_s"] = round(_build.kernels().build_s, 2)

    # CUDA events around each launch: this checkout's chip_smoke.py, which
    # times the kernel library of the root on sys.path
    here = importlib.util.spec_from_file_location(
        "chip_smoke_here", os.path.join(HERE, "chip_smoke.py"))
    smoke_here = importlib.util.module_from_spec(here)
    here.loader.exec_module(smoke_here)

    def events(entry: str):
        return smoke_here.launch_events(torch, entry)

    def device(fn, name: str, entry: str, iters: int = 20) -> dict:
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as p:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in p.key_averages() if name in e.key]
        with events(entry) as ev:
            for _ in range(iters):
                fn()
        return {"profiler_ms": round(sum(e.self_device_time_total
                                         for e in rows) / 1e3 / iters, 4),
                "by_kernel_ms": {re.search(name + r"(<\w+>)?", e.key)[0]:
                                 round(e.self_device_time_total / 1e3
                                       / iters, 4) for e in rows},
                "events_ms": round(sum(ev) / len(ev), 4)}

    if a_only:
        out.update(run_a(inputs, smoke_here, device))
        return out
    out["ptxas_C"] = {k: v for k, v in smoke_here.ptxas_summary(
        _build.kernels().ptxas_log).items() if "bucket" in k}
    for name in C_SHAPES:
        t = torch.load(os.path.join(inputs, f"{name}.pt"))
        ptab, valid = t["ptab"].cuda(), t["valid"].cuda()
        ent, seg = pippenger.bucket_plan(t["digits"].cuda())
        got = smoke_here.affine_of(pippenger.bucket_sums(ent, seg, ptab,
                                                         valid))
        out[f"C_{name}"] = dict(device(
            lambda: pippenger.bucket_sums(ent, seg, ptab, valid),
            "bucket_kernel", "zg1_bucket_accumulate"),
            affine_sha256=hashlib.sha256(repr(got).encode()).hexdigest())
    if c_only:
        return out

    gen = torch.Generator(device="cuda")
    gen.manual_seed(20261017)
    srs = dory.setup(20)
    for name, (npoly, rows, cols, nplanes) in (
            ("sound", chip_smoke.SOUND_ROWS), ("compat", chip_smoke.COMPAT_ROWS)):
        eng = rows_device.get_engine(srs, cols, "cuda")
        if nplanes == 1:
            cyc = rows * cols // 16
            k = torch.randint(0, 16, (npoly, cyc), device="cuda",
                              generator=gen)
            pos = k * cyc + torch.arange(cyc, device="cuda")
            keep = torch.rand((npoly, cyc), device="cuda", generator=gen)
            pos = torch.where(keep < 0.9, pos, 0)
            vals = torch.zeros((npoly, rows * cols), dtype=torch.uint8,
                               device="cuda")
            vals.scatter_(1, pos, 1)
            vals[:, 0] = 0
            vals[-1] = 0
        else:
            vals = torch.randint(0, 16, (npoly, rows * cols), device="cuda",
                                 generator=gen).to(torch.uint8)
            vals[-1] = 0
        vals = vals.view(npoly, rows, cols)
        out[f"B_{name}"] = device(
            lambda: rows_device.row_sums(vals, eng.table, eng.valid, nplanes),
            "row_msm_kernel", "zg1_row_msm")

    kzg = srs_mod.insecure_setup(1 << 16)
    pts, sc = chip_smoke.msm_inputs(kzg, 1 << 16, 16)
    ptab, valid = pippenger.affine_table(pts, "cuda")
    ent, seg = pippenger.bucket_plan(pippenger.int_digits(sc, "cuda"))
    buckets = pippenger.bucket_sums(ent, seg, ptab, valid)
    out["D_32_windows"] = device(lambda: pippenger.window_sums(*buckets),
                                 "window_kernel", "zg1_window_sums")

    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "sum_loop.elf")
        with open(path, "wb") as f:
            f.write(chip_smoke.sum_loop_elf(16))
        for mode, sound in (("compat", False), ("sound", True)):
            kw = chip_smoke.commit_inputs(path, sound)
            runs = []
            for _ in range(3):
                with events("zg1_row_msm") as ev, \
                        profile(activities=[ProfilerActivity.CUDA]) as p:
                    commit_and_absorb(Blake2bTranscript(b"Jolt"),
                                      device="cuda", **kw)
                    torch.cuda.synchronize()
                seen = [round(e.time_range.elapsed_us(), 1)
                        for e in p.events() if "row_msm_kernel" in e.name]
                runs.append({"events_ms": ev, "profiler_us": seen})
            out[f"commit_{mode}"] = runs
    return out


def main() -> int:
    args = sys.argv[1:]
    c_only, a_only = "--c-only" in args, "--a-only" in args
    flags = [a for a in args if a in ("--c-only", "--a-only")]
    args = [a for a in args if a not in flags]
    if len(args) == 3 and args[0] == "--one":
        print(json.dumps(run(os.path.abspath(args[1]), args[2], c_only,
                             a_only)), flush=True)
        return 0
    if len(args) < 2 or (c_only and a_only):
        print(__doc__, file=sys.stderr)
        return 2
    digests = set()
    with tempfile.TemporaryDirectory() as inputs:
        t0 = time.perf_counter()
        (a_inputs if a_only else c_inputs)(inputs)
        print(f"kernel {'A' if a_only else 'C'}'s inputs made in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        for root in args + args[::-1]:
            t0 = time.perf_counter()
            done = subprocess.run([sys.executable, os.path.abspath(__file__),
                                   "--one", root, inputs] + flags,
                                  capture_output=True, text=True)
            lines = done.stdout.strip().splitlines()
            if done.returncode or not lines:
                print(done.stdout + done.stderr[-4000:], file=sys.stderr)
                return 1
            got = json.loads(lines[-1])
            digests.add(tuple(v["words_sha256"] for v in got.values()
                              if isinstance(v, dict) and "words_sha256" in v)
                        if a_only else
                        tuple(got[f"C_{c}"]["affine_sha256"]
                              for c in C_SHAPES))
            print(json.dumps({**got, "seconds": round(
                time.perf_counter() - t0, 1)}), flush=True)
    if len(digests) != 1:
        print(f"kernel {'A' if a_only else 'C'}'s results differ between "
              f"the runs", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
