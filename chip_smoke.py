#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (zolt_tpu_torch) on one GPU.

Run from the repository root on a machine with an NVIDIA Hopper GPU and the
CUDA toolkit (nvcc):

    python3 chip_smoke.py [--log-t 16] [--profile PATH]

Phases, one status line each; the first failure ends the run non-zero:

1. device: CUDA must be present (there is no CPU fallback); prints the
   card's name and power limit from nvidia-smi.
2. build: nvcc builds the kernels of zolt_tpu_torch/csrc for sm_90a (one
   nvcc per source, in parallel; the ptxas register and spill lines are
   printed), and the native C tier (zolt_tpu_torch/native/*.c) must load.
3. kernels: each kernel against its plain torch version on the same CUDA
   tensors and against the host C tier (FrVec.fold_adj, prod_evals_adj,
   gruen_quad), at the shapes of the main path (stage-1 az/bz n = 2^17,
   engines n = 2^16, k = 2 and 3, degree 2 and 3, the live prefix halving
   down to 1 pair). The grouped fold also takes stage 3's seven engines
   (26 tables) in one launch. The grouped product-evals kernel also takes
   mixed groups (k, n, degree 0-3, live counts down to 0) in one launch,
   three launches back to back (its ticket counters must reset), and 2^21
   entries. The Gruen round runs its three modes (eval, fold then eval,
   fold) down the path's rounds, at the level offsets the split eq gives
   (h_in = 8 early, 0 late). Both schedules of the product evals (a thread
   a pair, four threads a pair) at each live count of the path's rounds,
   and of the Gruen round's eval-only pass (a thread a pair, two threads a
   pair) on both sides of their crossover. The fold and the k = 2,
   degree-2 product evals also at the sound batch opening's shapes: 16
   groups of (2, 2^20) in one launch, and groups of 2^20 and 2^16 entries
   mixed in one launch (about 1 GiB of inputs). Exact: every value is a
   canonical field element, so the tolerance is 0. Times each kernel per
   call (CUDA events) and on the device alone
   (torch.profiler), beside its bound (bytes at the HBM rate or IMADs at
   the integer peak; the wrappers' `work` counts) and its plain version
   per call.
4. slice: the sum-loop guest (the repo bench's guest) at T = 2^log_t.
   prove_jolt with its defaults (backend="device", device="cuda") with the
   host tail pinned to 0, so every sumcheck round of stages 1-4 runs on the
   GPU, with its peak device memory, under torch.profiler, which counts
   the kernels on the device: its counts must equal the wrappers' (no
   zfr_reduce_partials may run, and the fold may take no group beyond
   the product engines' evaluated groups: the outer-round engines fold in
   the Gruen round's pass; with --profile also under cProfile); then the
   device prove at the default tail, whose proof must equal it. At
   T = 2^16 their sha256 must equal the digest the JAX package (zolt_tpu)
   computes for the same guest on the CPU. Every kernel of PROVE_PATH
   (the Fr kernels and the row MSM, which commits the small-scalar polys)
   must have launched during the tail-0 device prove. Each Fr kernel's
   path bound is the bound of the bytes and IMADs its wrapper counted
   over that prove. Then the host tier (backend="host") at T = 2^12
   beside the tail-0 device prove of that size: equal bytes, and no
   kernel launched on the host tier.
5. sound: the same guest with sound=True (stages 1-12 and the PCS batch
   opening): prove_jolt's defaults with the tail at 0, timed, with its
   peak device memory, its per-stage seconds (stage5, stage6, stage7,
   stages8_12, batch_opening beside the others) and the wrappers' launch
   and group counts for the whole prove and for its batch opening alone;
   at T = 2^16 its sha256 must equal the JAX package's sound digest.
   Every kernel of PROVE_PATH must have launched in it, and the fold and
   the k = 2 product evals in its batch opening, at no more than 16
   groups a launch. Then the host tier at T = 2^12 with the joint proof,
   as the CLI proves: its sha256 must equal JAX_CLI_SOUND_DIGEST_T12,
   and it may launch no kernel. With --profile, one more
   tail-0 sound prove under torch.profiler (device busy, and the batch
   opening's device ms by its record_function range) and cProfile, written
   to PROFILE_sound.txt.

After phase 3, field: kernel F (csrc/field_inv.cu) against its plain
versions and Python's pow over Fr and Fp: batch_inverse at 2^16 entries
(a tenth zero), at n = 1 and at an odd n, pow_fixed with a short exponent
and with no bits; batch_inverse at 2^16 and 2^18 and inverse (pow_fixed
over p - 2) at 2^16 timed as in phase 3, batch_inverse beside its device
ms before the divstep redesign (recorded figures); batch_inverse swept
over the threads a launch aims for (which set the chunk) at 2^12, 2^16
and 2^18, exact against its plain version in every cell, with the device
ms of each, beside the product-tree design's recorded figures. Then the
bench's field section
(benchmarks.run_benchmarks, quick) with the counts at 0: F must launch
there (its path launches); then the bench's chipcheck, every
hand-written kernel against its plain version at a small size. The
phase's seconds are printed.

After field, any: kernel G (csrc/product_evals_any.cu, the product evals
of any k and degree) against its plain version at (k, 2^16, 8), every
pair live and 8193 live pairs, at (k, degree) = (4, 4), (5, 5), (1, 1),
(2, 5) and (8, 8), timed as in phase 3; then its path at 2^16 entries,
tail 0, the counts at 0 before each run: on cuda:0, run_sumcheck of
ProductSumcheck (with initial_claim_product) at k = 4 and 5 and of
DeviceProductTables at (k, degree) = (1, 1) and (2, 5); on a mesh of two
shards of cuda:0, DeviceProductTables at all four. Kernel G must launch
in each run, and every claim, proof and final must equal the same run on
the CPU (the plain versions). G's launches there are timed by CUDA events
beside the bound of the work its wrapper counted.

Between phases 3 and 4, g1: the G1 kernels (csrc/g1.cu, rows_msm.cu,
pippenger.cu) against their plain versions on the same CUDA tensors and
the host C tier, timed as in phase 3: A (pt_add, pt_double) on 2^16
pairs, half of them edge cases (a synthetic mix that reaches every
branch), and pt_add on 2^16 generic pairs (what real bucket and point
sums give), words equal; A's fold (pt_sum) at msm_mesh's shape, 4 x 2048
points meeting every case mid-fold, words equal to pt_sum_plain, and at 4
and 8 lanes a pair on that stack tiled to 2^11-2^13 points (a sweep of
device ms); B
(the row MSMs) at the sound shape (40 one-hot cubes of 2^20 in the
2^10 x 2^10 layout, one plane) and the compat shape (32 polys of 2^16
values below 16, 2^8 x 2^8, four planes), affine rows equal to the plain version's and to
`dory.row_commitments`, at the lanes a row its wrapper picks and, in a
sweep of device ms, at every other; C and D (the Pippenger's bucket and
window sums) in the Pippenger at n = 2^16 and 2^18 against the native C
MSM, D against its plain version at both and C at 2^16, with the host
steps of a call timed; C also on the scalars the internal prover commits
with its opening (the RAM post-values at 2^17, whose largest bucket holds
a third of the points, and the rd values at 2^16), affine equal to its
plain version and timed, each shape's bucket plan printed (entries,
largest bucket, chunks a pass); E (the scalars' digits from Fr
Montgomery words) at 2^18 against its plain version and the host's
digits, bytes equal.
Kernel B's path bound is that of the work its wrapper counted in each
prove, and its path device ms the sum of CUDA events around each of its
launches there (the profiled prove's torch.profiler figure beside it).
B's, C's and D's device ms before their redesign, recorded figures, are
printed beside this run's on lines of their own.
After phase 5:
6. verify: the port's verifier (zkvm/jolt_verifier.py, host Python over
   ints; no JAX on the card's machine) on the port's own proofs of phases 4
   and 5, their canonical bytes through zkvm/jolt_deserialize.py: the
   tail-0 sound proof must verify under the strict default, the compat
   proof under allow_reference_compat, each timed warm (the Dory SRS the
   prove cached) and cold (the SRS cache emptied, then restored); the sound
   proof with a stage-1 round poly +1 must raise VerifyError.
7. cli: `python -m zolt_tpu_torch prove <elf> --jolt-format --sound -o
   <file>`, through the CLI's main() in this process with its default
   backend (the GPU; the host tail pinned to 0 as in phases 4-5), on the
   sum-loop guest at T = 2^12: every kernel of PROVE_PATH must launch, and
   the file's sha256 must equal JAX_CLI_SOUND_DIGEST_T12 (the JAX
   package's CLI on the host tier). Then, each in a process of its own
   (all of them side by side, after the in-process proves),
   `python3 -m zolt_tpu_torch verify <file> --elf <elf>` must exit 0 with
   PASSED, a copy with one byte flipped must exit 1 with FAILED, and
   `python3 -m zolt_tpu_torch info` must name the card. The internal and
   legacy containers the same way: `prove <elf>` (the internal ZOLT v1
   prover), `prove --legacy --json` and `prove --legacy --gzip` in this
   process on the card (tail 0), each file's sha256 equal to the JAX
   CLI's (CLI_CONTAINERS), the internal prove launching every kernel of
   INTERNAL_PATH and the legacy ones every kernel of LEGACY_PATH; then
   the CLI's `verify` and `stats` of each file, both in one subprocess
   (PASSED, and the stats lines), and the internal file with a byte of a
   stage-1 round poly flipped must exit 1 with FAILED.
8. commit: the commitment phase alone (`commit_and_absorb`) in each mode
   on the device tier and the host C tier in one pair, its
   seconds split into the row MSMs and the pairings, the commitments
   equal; a first device commit gives kernel B's work in the phase alone
   and each of its launches' ms by CUDA events beside the launches
   torch.profiler recorded, and its inputs (the path's own density) hold
   kernel B to its plain version at every lanes-a-row, with a sweep of
   device ms.
9. kzg: HyperKZG at 2^18 on the card: commit (of a tensor on the card),
   open and verify, the commitment equal to the native C MSM; kernels C,
   D and E must launch (each also timed by CUDA events there).
10. legacy: the legacy prover, prove_program(emu, log_k=LEGACY_LOG_K,
   device="cuda") of the sum-loop guest at T = 2^log_t with the host
   tail at 0 (every round of its six k = 2 and k = 3 product sumchecks on
   the card; stage 1's three tables hold 2^21 entries at T = 2^16),
   under torch.profiler: its seconds by stage, peak device memory, and
   each kernel's launches, path bound and device ms; stage 1's product
   evals timed apart. Its serialize() sha256 must equal
   JAX_LEGACY_DIGEST_T16, every kernel of LEGACY_PATH must launch, the
   verifier must accept and reject a copy with a stage-1 round poly +1.
11. internal: the internal ZOLT v1 prover at the CLI's defaults (log_k
   16, srs_degree 1280) on the card, tail 0, timed by stage under
   torch.profiler (C, D and E also by CUDA events): its sha256 must equal
   JAX_INTERNAL_DIGEST_T16, verify_internal must accept, every kernel of
   INTERNAL_PATH must launch. Then with_openings=True at srs_degree
   OPENING_SRS (the HyperKZG batch opening on the card; its SRS the
   first 2^17 powers of the g1 phase's, the same τ): the three
   commitments equal to the native C MSM's, verify_internal accepting, a
   copy with the first opened evaluation + 1 failing the pairing check.
   Each prove prints each kernel C launch's ms (CUDA events) beside its
   largest bucket and its entries.
12. mesh: the mesh backend (zolt_tpu_torch/parallel/mesh.py) on
   make_mesh(["cuda:0"] * MESH_SHARDS), four shards of the one card, so
   every shard's kernels, the cross-shard sums, the gather of the shards'
   prefixes and kernel A's fold run on it (the same code puts a shard on
   each of cuda:0..7). sharded_sumcheck_prove at 2^16, k = 3, tail 0: its
   round evals, challenges, finals and transcript equal to the
   single-device engine's on the same tables. prove_jolt(elf,
   backend="mesh") of the sum-loop guest at T = 2^12, tail 0: compat, its
   bytes equal to the device and host tiers' of phase 4, and sound with
   the joint proof, its sha256 equal to JAX_CLI_SOUND_DIGEST_T12; each
   timed beside the device prove of that size (phase 4's, and the CLI's
   of phase 7), with its peak device memory and each kernel's launches,
   path bound and device ms by CUDA events; every kernel of MESH_PATH
   must launch (kernel B in the sound prove only: the compat prove's
   polys at T = 2^12 are below DEVICE_COMMIT_MIN and commit on the host
   tier). msm_mesh at 2^16:
   affine equal to the native C MSM, C, D and A's fold launched (one fold
   of the shards' bucket arrays a pass, 4 launches; its batch add none),
   A's launches timed by CUDA events beside their bound, each launch's
   words equal to pt_sum_plain's. The
   CLI's `prove --jolt-format --sound --backend mesh` and `--backend host
   --stage1-backend mesh` at T = 2^12 on make_mesh() (every CUDA device),
   tail 0: both files' sha256 equal to JAX_CLI_SOUND_DIGEST_T12.

The seconds of each phase are printed before the last lines. The time
limit of a run is 1200 s: the T = 2^16 proves are the compat prove at
tail 0 and at the default tail, the sound prove, and those of the
legacy and internal provers; the host tier and the mesh prove at
T = 2^12.

The last three lines are the kernels' JSON (every kernel, with each
path's launches and figures; F's path is the bench's field section, G's
its path on cuda:0), the
nvidia-smi card line and the result JSON.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

# sha256 of zolt_tpu's host-tier prove_jolt(...).conv.proof
# .serialize_with_dory() for the sum-loop guest at T = 2^16 (computed on
# the CPU with the JAX package; tests/test_torch_slice.py recomputes it).
JAX_DIGEST_T16 = (
    "3f55108bedaa1c9c70df9394b406a84fc7093048e519041957bf9b38c916ed62")
# The same for the sound prove, prove_jolt(..., sound=True)
# (tests/test_torch_slice.py recomputes it too).
JAX_SOUND_DIGEST_T16 = (
    "643d621c3ef83736f83ce17bfb510b76579101b0d4cbc259ce2e54072682bcd8")
# sha256 of the file `python -m zolt_tpu prove <elf> --jolt-format --sound
# --backend host -o <file>` writes for the sum-loop guest at T = 2^12 (the
# JAX package's CLI on the CPU; tests/test_torch_cli.py recomputes it).
JAX_CLI_SOUND_DIGEST_T12 = (
    "3597b4fc5f27c4a01bad819961260912312b4024f9badee8420fb6782329f8c1")
# sha256 of zolt_tpu's serialization.serialize(prove_program(emu,
# log_k=LEGACY_LOG_K)) for the sum-loop guest at T = 2^16, on the CPU,
# the legacy prover's two jitted helpers computed by the JAX package's
# host tier (XLA compiles them a round shape, minutes and tens of GiB
# each at this size; tests/test_torch_legacy.py recomputes it). log_k is
# the CLI's --log-k default: above 10 both packages raise IndexError in
# stage 2 on this guest, whose RAM accesses outnumber the 2^16 entries of
# stage 2's eq table.
LEGACY_LOG_K = 10
JAX_LEGACY_DIGEST_T16 = (
    "92cb233e35f2ca15b19e8f7f7409422880e06df5aeaf84c238e6c4071e4b47fb")
# The CLI's internal and legacy containers at T = 2^CLI_LOG_T: {name:
# (the prove flags, the sha256 of the file `python -m zolt_tpu prove <elf>
# <flags> -o <file>` writes)}, JAX's CLI on the CPU (its legacy prover's
# jitted helpers on its host tier; tests/test_torch_cli.py recomputes
# them).
CLI_CONTAINERS = {
    "internal": ([], "fecfd6ca3b94c591c8a45c6807d16d02"
                     "a4a0c0b80957945059cc981b01e4506f"),
    "legacy_json": (["--legacy", "--json"],
                    "742fbd7e49a6614b3880ee33bdc73710"
                    "2d17c28c068bb608f79db291f3e5cd3f"),
    "legacy_gzip": (["--legacy", "--gzip"],
                    "c8544369c783a6ac1486244d5caa416f"
                    "1190e57572278aa06885acc95333dfa9"),
}
# sha256 of zolt_tpu's prove_internal(emu, padded, image).serialize() (the
# CLI's defaults: log_k 16, srs_degree 1280) for the same guest
# (tests/test_torch_internal.py recomputes it).
JAX_INTERNAL_DIGEST_T16 = (
    "0b97f20f52182b74bae5a95cb3aa90d908744b3df789c4393c9d6063089a28cb")

# (name, source, the pallas_call sites it replaces).
KERNELS = [
    ("fold", "zolt_tpu_torch/csrc/fold.cu",
     "zolt_tpu/field/pallas_redc.py:424,516,589,689"),
    ("product_evals_k2", "zolt_tpu_torch/csrc/product_evals.cu",
     "zolt_tpu/field/pallas_redc.py:754"),
    ("product_evals_k3", "zolt_tpu_torch/csrc/product_evals.cu",
     "zolt_tpu/field/pallas_redc.py:878"),
    ("gruen_round", "zolt_tpu_torch/csrc/gruen_round.cu",
     "zolt_tpu/field/pallas_kernels.py:191"),
]


# The G1 kernels: (name, source, the JAX device functions they replace).
G1_KERNELS = [
    ("g1_add_double", "zolt_tpu_torch/csrc/g1.cu",
     "zolt_tpu/curve/device.py:58,74 (pt_double, pt_add)"),
    ("g1_sum", "zolt_tpu_torch/csrc/g1.cu",
     "zolt_tpu/msm/pippenger.py:230-237 (msm_mesh's fori_loop of "
     "zolt_tpu/curve/device.py:74 pt_add)"),
    ("row_plane_sums", "zolt_tpu_torch/csrc/rows_msm.cu",
     "zolt_tpu/msm/rows_device.py:50,69 (_plane_sums, _horner_planes)"),
    ("bucket_accumulate", "zolt_tpu_torch/csrc/pippenger.cu",
     "zolt_tpu/msm/pippenger.py:55 (_bucket_totals)"),
    ("window_sums", "zolt_tpu_torch/csrc/pippenger.cu",
     "zolt_tpu/msm/pippenger.py:95 (_window_sums)"),
    ("scalar_digits", "zolt_tpu_torch/csrc/pippenger.cu",
     "zolt_tpu/pcs/hyperkzg.py:50 and zolt_tpu/msm/pippenger.py:45 "
     "(decode and _digits, on the host)"),
]
# Kernel G: (name, source, the JAX code it replaces: XLA, not Pallas).
ANY_KERNELS = [
    ("product_evals_any", "zolt_tpu_torch/csrc/product_evals_any.cu",
     "zolt_tpu/parallel/stage_engine.py:173 (_evals_fixed) and "
     "zolt_tpu/sumcheck/driver.py:92 (ProductSumcheck.round_evals)"),
]
# Kernel F: (name, source, the JAX code it replaces: XLA, not Pallas).
F_KERNELS = [
    ("field_inv", "zolt_tpu_torch/csrc/field_inv.cu",
     "zolt_tpu/field/limb.py:291,311,317 (mont_pow_fixed, inverse, "
     "batch_inverse)"),
]
# The kernels a prove must launch on its device path.
PROVE_PATH = ("fold", "product_evals_k2", "product_evals_k3", "gruen_round",
              "row_plane_sums")
# The kernels the HyperKZG commit and open must launch.
KZG_PATH = ("bucket_accumulate", "window_sums", "scalar_digits")
# The kernels the legacy prove (prove_program: every round of its six
# stages a product sumcheck, k = 2 or 3) must launch.
LEGACY_PATH = ("fold", "product_evals_k2", "product_evals_k3")
# The kernels the internal prove (prove_internal) must launch: stage 4's
# ValEvaluation engine and stage 1's openings (fold, k = 3 evals) and the
# three commitments (E, then C and D).
INTERNAL_PATH = ("fold", "product_evals_k3") + KZG_PATH


def ptxas_summary(log: str) -> dict:
    """Registers and spill bytes (stores/loads) of each kernel from nvcc's
    -Xptxas -v lines: {"name[<template args>]": "R regs, S/L spill"}."""
    import re

    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name = mangled = m.group(1)
            # a mangled name segment is its length, then its characters
            # (the length may follow other digits)
            for d in re.finditer(r"\d+", mangled):
                for i in range(d.start(), d.end()):
                    seg = mangled[d.end():d.end() + int(mangled[i:d.end()])]
                    if seg.endswith("_kernel"):
                        t = re.match(r"ILi(\d+)E",
                                     mangled[d.end() + len(seg):])
                        name = seg + (f"<{t.group(1)}>" if t else "")
                        break
                if name != mangled:
                    break
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and name:
            out[name] = f"{m.group(1)}/{m.group(2)} spill"
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            out[name] = f"{m.group(1)} regs, " + out.get(name, "")
            name = None
    return out


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, iters: int) -> float:
    """Mean milliseconds per call over `iters` calls, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_us(rows) -> float:
    """Total device microseconds in a torch.profiler key_averages()."""
    return sum(e.self_device_time_total for e in rows)


def device_ms(torch, fn, iters: int, name: str | None = None) -> float:
    """Mean device milliseconds per call over `iters` calls: the kernels'
    own time by torch.profiler, without the wrapper's host work; with
    `name`, only the kernels whose name holds it (a G1 wrapper also runs
    torch kernels that count its work)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as p:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in p.key_averages() if name is None or name in e.key]
    return device_us(rows) / 1e3 / iters


def bound(nbytes: int, imads: int) -> tuple[float, str]:
    """The least time (ms) the card could take: the bytes moved once at the
    HBM rate or the IMADs at the integer peak, whichever is longer
    (zolt_tpu_torch/benchmarks.py bound_s: H100 SXM, 700 W, 3.35 TB/s and
    132 SMs x 64 IMAD/clk x 1.98 GHz). The wrappers count both (`work` in
    field/fold.py, evals.py, gruen.py; a 32x32-bit word product is two
    IMADs)."""
    from zolt_tpu_torch.benchmarks import bound_s

    sec, by = bound_s(nbytes, imads)
    return sec * 1e3, by


def timings(torch, stats: dict, name: str, kernel, plain, nbytes: int,
            imads: int, shape: str, err: int, plain_iters: int = 3,
            phase: str = "kernels", device_name: str | None = None) -> None:
    """Record and print one kernel's call time (CUDA events), device time
    (profiler; of the kernels named `device_name` where given), bound, and
    its plain version's call time, on the same inputs."""
    b_ms, b_by = bound(nbytes, imads)
    st = stats[name] = dict(max_abs_err=err, shape=shape,
                            ms=cuda_ms(torch, kernel, 50),
                            device_ms=device_ms(torch, kernel, 50,
                                                device_name),
                            plain_ms=cuda_ms(torch, plain, plain_iters),
                            bound_ms=b_ms, bound_by=b_by, library_ms=None)
    dev = (f"{st['device_ms']:.4f} ms on the device "
           f"({nbytes / st['device_ms'] / 1e6:.1f} GB/s of {nbytes} bytes, "
           f"bound {b_ms:.4f} ms by {b_by}, "
           f"{b_ms / st['device_ms'] * 100:.1f} % of it)"
           if st["device_ms"] else "device time not measured (the "
           "profiler saw no device events)")
    say(phase, f"{name} exact vs plain and the host tier at {shape}: "
               f"{st['ms']:.4f} ms per call, {dev}; plain "
               f"{st['plain_ms']:.3f} ms")


def rand_tables(torch, gen, k: int, n: int, live: int):
    """(k, n, 8) random canonical Montgomery words on the GPU (top 3 bits
    clear: < 2^253 < p), zero behind the first `live` entries."""
    w = torch.randint(-2 ** 31, 2 ** 31, (k, n, 8), dtype=torch.int64,
                      device="cuda", generator=gen).to(torch.int32)
    w[..., 7] &= 0x1FFFFFFF
    w[:, live:] = 0
    return w.contiguous()


def max_abs(torch, a, b) -> int:
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())


def check_kernels(torch, stats: dict) -> None:
    gen = torch.Generator(device="cuda")
    gen.manual_seed(20261016)
    check_fold(torch, gen, stats)
    check_product_evals(torch, gen, stats)
    check_gruen(torch, gen, stats)
    check_batch_opening_shapes(torch, gen, stats)


# The sound prove's batch opening at T = 2^16: 39 claim groups of 2 x 2^20
# entries (f and the merged eq table; five groups of 2^16 wake at round 4),
# degree 2; its engines go 16 groups a launch.
BO_LOG_N = 20


def check_batch_opening_shapes(torch, gen, stats: dict) -> None:
    """Kernels 1 and 5 at the batch opening's shapes, against fold_plain and
    product_evals_plain (max_abs_err 0): one launch of 16 groups of (2,
    2^20, 8), each its own r, with every pair live (its first round); and a
    mixed launch of groups at 2^20 and 2^16 entries and live counts down to
    one pair (its later rounds, and the groups that wake late). Times the
    16-group launch of each."""
    from zolt_tpu_torch.field import evals, fold

    n = 1 << BO_LOG_N
    r = 0x2A5C_1234_5678_9ABC_DEF0_1122_3344_5566
    big = [rand_tables(torch, gen, 2, n, n) for _ in range(16)]
    fg = [(t, r + 7919 * i, n // 2) for i, t in enumerate(big)]
    eg = [(t, n // 2, 2) for t in big]
    mixed = [(rand_tables(torch, gen, 2, m, 2 * live), live)
             for m, live in ((n, n // 2), (1 << 16, 1 << 15), (n, 1 << 10),
                             (1 << 16, 1 << 12), (n, 3), (1 << 16, 1))]
    err = {"fold": 0, "evals": 0}
    for groups in (fg, [(t, r + i, live) for i, (t, live) in enumerate(mixed)]):
        before = fold.fold_many.counts["launches"]
        got = fold.fold_many(groups)
        if fold.fold_many.counts["launches"] != before + 1:
            raise AssertionError("the batch opening's folds took more than "
                                 "one launch for 16 groups")
        for out, g in zip(got, groups):
            err["fold"] = max(err["fold"],
                              max_abs(torch, out, fold.fold_plain(*g)))
    for groups in (eg, [(t, live, 2) for t, live in mixed]):
        before = evals.product_evals.counts["launches"]
        got = evals.product_evals(groups)
        if evals.product_evals.counts["launches"] != before + 1:
            raise AssertionError("the batch opening's product evals took "
                                 "more than one launch for 16 groups")
        for out, g in zip(got, groups):
            err["evals"] = max(err["evals"], max_abs(
                torch, out, evals.product_evals_plain(*g)))
    if any(err.values()):
        raise AssertionError(f"the batch opening's shapes differ from the "
                             f"plain versions: {err}")
    say("kernels", "fold and product_evals (k = 2, degree 2) exact (max_abs_err "
                   "0) vs plain at the batch opening's shapes: 16 x (2, 2^20) "
                   "in one launch, and 2^20 / 2^16 groups mixed")
    w = [sum(x) for x in zip(*(fold.work(2, live) for _, _, live in fg))]
    timings(torch, stats, "fold_batch_opening", lambda: fold.fold_many(fg),
            lambda: fold.fold_many_plain(fg), *w,
            "batch opening round 0: 16 groups of (2, 2^20, 8), 2^19 live "
            "pairs, one launch", err["fold"])
    timings(torch, stats, "product_evals_k2_batch_opening",
            lambda: evals.product_evals(eg),
            lambda: [evals.product_evals_plain(*g) for g in eg],
            *evals.work(eg), "batch opening round 0: 16 groups of (2, 2^20, "
            "8), degree 2, 2^19 live pairs, one launch", err["evals"])
    del big, fg, eg, mixed
    torch.cuda.empty_cache()


# Stage 3's seven engines, tables each (factors and passengers), n = 2^16:
# their folds run in one launch every round.
STAGE3_TABLES = (7, 2, 3, 3, 3, 3, 5)


def check_fold(torch, gen, stats: dict) -> None:
    """Kernel 1, one grouped kernel, against fold_plain and FrVec.fold_adj
    (max_abs_err 0): stage-1 az/bz (2, 2^17) and a k = 3 engine stack (3,
    2^16) as the live prefix halves to 1 pair; stage 3's seven engines at
    round 0 in one launch, each its own r. Times one group at (2, 2^17)
    with 2^16 live pairs, and stage 3's round 0."""
    from zolt_tpu_torch.field import fold, limb

    r = 0x1234567890ABCDEF1234567890ABCDEF % (1 << 250)
    err = 0
    for k, log_n in ((2, 17), (3, 16)):
        n = 1 << log_n
        live = n // 2
        while live >= 1:
            tabs = rand_tables(torch, gen, k, 2 * live, 2 * live)
            got = fold.fold(tabs, r, live)
            err = max(err, max_abs(torch, got, fold.fold_plain(tabs, r, live)))
            host = limb.words_to_frvec(tabs[k - 1]).fold_adj(r)
            if got.shape != (k, live, 8) or not torch.equal(
                    got[k - 1].cpu(), limb.frvec_to_words(host)):
                raise AssertionError(f"fold != FrVec.fold_adj at n={n} "
                                     f"live={live}")
            live //= 4 if live > 64 else 2
    n = 1 << 16
    g7 = [(rand_tables(torch, gen, k, n, n), r + 7919 * i, n // 2)
          for i, k in enumerate(STAGE3_TABLES)]
    before = fold.fold_many.counts["launches"]
    for out, want in zip(fold.fold_many(g7), fold.fold_many_plain(g7)):
        err = max(err, max_abs(torch, out, want))
    if fold.fold_many.counts["launches"] != before + 1:
        raise AssertionError("stage 3's folds took more than one launch")
    if err:
        raise AssertionError(f"fold differs from its plain version: {err}")
    tabs = rand_tables(torch, gen, 2, 1 << 17, 1 << 17)
    timings(torch, stats, "fold", lambda: fold.fold(tabs, r, 1 << 16),
            lambda: fold.fold_plain(tabs, r, 1 << 16), *fold.work(2, 1 << 16),
            "(2, 2^17, 8), live 2^16", err)
    w7 = [sum(x) for x in zip(*(fold.work(t.shape[0], live)
                                for t, _, live in g7))]
    timings(torch, stats, "fold_stage3_round0", lambda: fold.fold_many(g7),
            lambda: fold.fold_many_plain(g7), *w7,
            "stage 3 round 0: 7 groups, 26 x (2^16, 8), 2^15 live pairs, "
            "one launch", err)


# The split eq of stage 1's remaining rounds (17 variables): E_out and
# E_in stacks of 9 levels; a round of 2^lg pairs takes h_in = lg − 8 while
# that is positive (E_out at level 8), then h_in = 0.
EQ_LEVELS = 9


def level_args(lg: int) -> tuple[int, int, int, int]:
    """(off_out, off_in, h_in, lvl_out) of a round of 2^lg pairs."""
    h_in = max(0, lg - (EQ_LEVELS - 1))
    lvl_out = lg - h_in
    return (1 << lvl_out) - 1, (1 << h_in) - 1, h_in, lvl_out


def check_gruen(torch, gen, stats: dict) -> None:
    """Kernel 4 in its three modes down the path's rounds: eval (pairs from
    2^16), fold then eval (folds from 2^16 pairs), fold (a flush), against
    gruen_round_plain and the host tier (FrVec.fold_adj, gruen_quad),
    max_abs_err 0. Then both schedules at each live count, and the times:
    each mode at (2, 2^17) with h_in = 8 (the fused pass evaluates 2^15
    pairs at h_in = 7), and the fused pass of a late round, h_in = 0."""
    from zolt_tpu_torch.field import gruen, limb
    from zolt_tpu_torch.native.frvec import FrVec

    flat = (1 << EQ_LEVELS) - 1
    e_out = rand_tables(torch, gen, 1, flat, flat)[0]
    e_in = rand_tables(torch, gen, 1, flat, flat)[0]
    r = 0x0FEDCBA987654321 << 120
    err = 0

    def args_of(mode: str, live: int):
        pairs = live // 2 if mode == "fused" else live
        off_out, off_in, h_in, _ = level_args(max(pairs, 1).bit_length() - 1)
        ab = rand_tables(torch, gen, 2, 2 * live, 2 * live)
        return (ab, None if mode == "eval" else r, e_out, e_in, off_out,
                off_in, h_in, live, mode != "fold"), pairs

    for mode in ("eval", "fused", "fold"):
        live = 1 << 16
        while live >= 1:
            args, pairs = args_of(mode, live)
            tabs, ev = gruen.gruen_round(*args)
            want_tabs, want_ev = gruen.gruen_round_plain(*args)
            err = max(err, max_abs(torch, tabs, want_tabs))
            if ev is not None:
                err = max(err, max_abs(torch, ev, want_ev))
            ab, off_out, off_in, h_in = args[0], args[4], args[5], args[6]
            host = [limb.words_to_frvec(ab[j]) for j in (0, 1)]
            if mode != "eval":
                host = [v.fold_adj(r) for v in host]
                if not all(torch.equal(tabs[j].cpu(),
                                       limb.frvec_to_words(host[j]))
                           for j in (0, 1)):
                    raise AssertionError(f"gruen_round ({mode}) fold != "
                                         f"FrVec.fold_adj at live {live}")
            if ev is not None and pairs:
                lvl_out = (pairs.bit_length() - 1) - h_in
                want = FrVec.gruen_quad(
                    limb.words_to_frvec(e_out[off_out: off_out
                                              + (1 << lvl_out)]),
                    limb.words_to_frvec(e_in[off_in: off_in + (1 << h_in)]),
                    h_in, host[0], host[1], pairs)
                if tuple(limb.decode(ev)) != tuple(want):
                    raise AssertionError(f"gruen_round ({mode}) != "
                                         f"FrVec.gruen_quad at live {live}")
            live //= 4 if live > 64 else 2
    if err:
        raise AssertionError(f"gruen_round differs from its plain version: "
                             f"{err}")
    if gruen._scratch(e_out.device).any():
        raise AssertionError("gruen_round left its scratch non-zero")
    say("kernels", "gruen_round exact (max_abs_err 0) vs plain and FrVec in "
                   "its three modes down the path's rounds")
    gruen_sweep(torch, gen, stats)
    shapes = (("gruen_round", "eval", 1 << 16,
               "eval: az, bz (2^17, 8), 2^16 pairs, h_in 8"),
              ("gruen_round_fused", "fused", 1 << 16,
               "fold 2^16 pairs of (2, 2^17, 8), eval 2^15 pairs, h_in 7"),
              ("gruen_round_fold", "fold", 1 << 16,
               "fold: (2, 2^17, 8), 2^16 live pairs"),
              ("gruen_round_late", "fused", 1 << 8,
               "fold 2^8 pairs, eval 2^7 pairs, h_in 0"))
    for name, mode, live, shape in shapes:
        args, pairs = args_of(mode, live)
        e = max_abs(torch, gruen.gruen_round(*args)[0],
                    gruen.gruen_round_plain(*args)[0])
        timings(torch, stats, name, lambda: gruen.gruen_round(*args),
                lambda: gruen.gruen_round_plain(*args),
                *gruen.work(live if mode != "eval" else 0,
                            pairs if mode != "fold" else 0, args[6]),
                shape, max(e, err))


def gruen_sweep(torch, gen, stats: dict) -> None:
    """The Gruen round's schedules down the path's live counts. An
    eval-only pass (each engine's first round) forced in turn to a thread
    a pair and to two threads a pair, on both sides of
    gruen.SPLIT_MAX_PAIRS, where the wrapper changes from two to one; a
    fused pass (folds of 2^lg pairs, evals of half as many; 2^16 folded
    pairs is stage 1's widest, and two counts beyond it) in its one
    schedule, two threads a pair. Each exact against the plain version,
    at the split eq's level offsets, with its device time."""
    from zolt_tpu_torch.field import gruen

    chosen = gruen.SPLIT_MAX_PAIRS
    rows = stats["gruen_round_schedules"] = []
    flat = (1 << (EQ_LEVELS + 2)) - 1        # h_in up to 10
    e_out = rand_tables(torch, gen, 1, flat, flat)[0]
    e_in = rand_tables(torch, gen, 1, flat, flat)[0]
    ab = rand_tables(torch, gen, 2, 1 << 19, 1 << 19)
    # (mode, log2 of the pairs the pass takes, schedules to force)
    both = (("pair", -1), ("split", 1 << 62))
    points = ([("eval", lg, both) for lg in range(17, 12, -1)]
              + [("fused", lg, both[1:]) for lg in range(18, 0, -1)])
    try:
        for mode, lg, forced in points:
            quads = 1 << (lg - 1 if mode == "fused" else lg)
            off_out, off_in, h_in, _ = level_args(quads.bit_length() - 1)
            args = (ab, 12345 if mode == "fused" else None, e_out, e_in,
                    off_out, off_in, h_in, 1 << lg)
            want = gruen.gruen_round_plain(*args)
            ms = {}
            for name, cut in forced:
                gruen.SPLIT_MAX_PAIRS = cut
                got = gruen.gruen_round(*args)
                if max_abs(torch, got[0], want[0]) or max_abs(
                        torch, got[1], want[1]):
                    raise AssertionError(f"gruen_round ({name}) differs from "
                                         f"its plain version at {mode} 2^{lg}")
                ms[name] = device_ms(torch, lambda: gruen.gruen_round(*args),
                                     50)
            takes = ("split" if mode == "fused" or quads <= chosen
                     else "pair")
            rows.append(dict(mode=mode, log2=lg, h_in=h_in, **ms,
                             takes=takes))
            times = ", ".join(
                f"{'a thread' if k == 'pair' else 'two threads'} a pair "
                f"{v:.4f} ms" for k, v in ms.items())
            say("kernels", f"gruen_round {mode} at 2^{lg} pairs (h_in "
                           f"{h_in}), exact: {times} on the device; the "
                           f"wrapper takes "
                           f"{'two' if takes == 'split' else 'one'}")
    finally:
        gruen.SPLIT_MAX_PAIRS = chosen


# Mixed groups for one launch, (k, n, live_pairs, degree): k = 2 and 3,
# degrees 0-3, live counts down to 1 and 0, odd counts, different n, and
# both schedules (live counts on each side of evals.SPLIT_MAX_PAIRS).
MIXED_GROUPS = [(2, 1 << 16, 1 << 15, 2), (3, 1 << 16, 1 << 15, 3),
                (2, 4096, 2048, 3), (3, 4096, 1999, 2), (2, 256, 77, 1),
                (3, 64, 1, 0), (2, 2, 1, 3), (3, 2, 0, 3),
                (2, 1 << 12, 129, 0), (3, 1 << 14, 8191, 1),
                (2, 1 << 15, 8193, 3), (3, 1 << 15, 8192, 2)]


def check_product_evals(torch, gen, stats: dict) -> None:
    """Kernels 2-3, one grouped kernel, against product_evals_plain and
    FrVec.prod_evals_adj (max_abs_err 0): the path's engines at n = 2^16
    (k = 2 and 3, degrees 2 and 3, one launch per round as the live prefix
    halves to 1 pair), mixed groups in one launch three times back to back
    (the tickets must reset), and one group of 2^21 entries per k. Then
    both schedules at each live count of the path's rounds, and the times
    at (2, 2^16) degree 2, (3, 2^16) degree 3, a shape on the other side of
    the schedules' threshold, and stage 3's round 0."""
    from zolt_tpu_torch.field import evals, limb
    from zolt_tpu_torch.native.frvec import FrVec

    err = {2: 0, 3: 0}

    def check(groups):
        got = evals.product_evals(groups)
        for out, (tabs, live, deg) in zip(got, groups):
            k = tabs.shape[0]
            err[k] = max(err[k], max_abs(
                torch, out, evals.product_evals_plain(tabs, live, deg)))
            host = (FrVec.prod_evals_adj(
                [limb.words_to_frvec(tabs[j, : 2 * live]) for j in range(k)],
                deg) if live else [0] * (deg + 1))
            if limb.decode(out) != host:
                raise AssertionError(f"product_evals != FrVec.prod_evals_adj "
                                     f"at k {k} n {tabs.shape[1]} live "
                                     f"{live} degree {deg}")

    n = 1 << 16
    for degree in (2, 3):
        live = n // 2
        while live >= 1:
            check([(rand_tables(torch, gen, k, n, 2 * live), live, degree)
                   for k in (2, 3)])
            live //= 4 if live > 64 else 2
    mixed = [(rand_tables(torch, gen, k, m, 2 * live), live, deg)
             for k, m, live, deg in MIXED_GROUPS]
    for _ in range(3):
        check(mixed)
    if evals._scratch(mixed[0][0].device).any():
        raise AssertionError("product_evals left its scratch (column sums, "
                             "tickets) non-zero")
    for k in (2, 3):
        check([(rand_tables(torch, gen, k, 1 << 21, 1 << 21), 1 << 20, 3)])
    if any(err.values()):
        raise AssertionError(f"product_evals differs from its plain version: "
                             f"{err}")
    say("kernels", "product_evals exact (max_abs_err 0) vs plain and FrVec: "
                   "n = 2^16 schedules, mixed groups x3 (tickets reset), "
                   "2^21 entries")

    schedule_sweep(torch, gen, stats)
    split = evals.SPLIT_MAX_PAIRS
    for k, deg in ((2, 2), (3, 3)):
        tabs = rand_tables(torch, gen, k, n, n)
        g = [(tabs, n // 2, deg)]
        timings(torch, stats, f"product_evals_k{k}",
                lambda: evals.product_evals(g),
                lambda: evals.product_evals_plain(*g[0]), *evals.work(g),
                f"({k}, 2^16, 8), degree {deg}", err[k])
        # the other side of the threshold: four threads a pair
        g2 = [(tabs, split, deg)]
        e2 = max_abs(torch, evals.product_evals(g2)[0],
                     evals.product_evals_plain(*g2[0]))
        if e2:
            raise AssertionError(f"product_evals differs from its plain "
                                 f"version at {split} live pairs: {e2}")
        timings(torch, stats, f"product_evals_k{k}_split",
                lambda: evals.product_evals(g2),
                lambda: evals.product_evals_plain(*g2[0]), *evals.work(g2),
                f"({k}, 2^16, 8), {split} live pairs, degree {deg}", e2)
    # stage 3, round 0: 3 x (k = 2, degree 2) + 4 x (k = 3, degree 3)
    g7 = ([(rand_tables(torch, gen, 2, n, n), n // 2, 2) for _ in range(3)]
          + [(rand_tables(torch, gen, 3, n, n), n // 2, 3) for _ in range(4)])
    timings(torch, stats, "product_evals_stage3_round0",
            lambda: evals.product_evals(g7),
            lambda: [evals.product_evals_plain(*g) for g in g7],
            *evals.work(g7), "stage 3 round 0: 3 x (2, 2^16, 8) degree 2 + "
            "4 x (3, 2^16, 8) degree 3, one launch", max(err.values()))


def schedule_sweep(torch, gen, stats: dict) -> None:
    """The product-evals kernel's two schedules, a thread a pair and four
    threads a pair, forced in turn at each live count of the path's rounds
    (k = 2 degree 2, k = 3 degree 3, n = 2^16): exact against the plain
    version, and the device time of each. The wrapper takes four threads
    at up to evals.SPLIT_MAX_PAIRS live pairs; the sweep shows whether that
    is the crossover on this card."""
    from zolt_tpu_torch.field import evals

    chosen = evals.SPLIT_MAX_PAIRS
    rows = stats["product_evals_schedules"] = []
    try:
        for k, deg in ((2, 2), (3, 3)):
            tabs = rand_tables(torch, gen, k, 1 << 16, 1 << 16)
            for lg in (15, 14, 13, 12, 11, 10, 8, 4, 0):
                g = [(tabs, 1 << lg, deg)]
                want = evals.product_evals_plain(*g[0])
                ms = {}
                for name, cut in (("pair", -1), ("split", 1 << 62)):
                    evals.SPLIT_MAX_PAIRS = cut
                    if max_abs(torch, evals.product_evals(g)[0], want):
                        raise AssertionError(
                            f"product_evals ({name}) differs from its plain "
                            f"version at k {k} live 2^{lg}")
                    ms[name] = device_ms(
                        torch, lambda: evals.product_evals(g), 50)
                takes = "split" if (1 << lg) <= chosen else "pair"
                rows.append(dict(k=k, degree=deg, live_log2=lg, **ms,
                                 takes=takes))
                say("kernels", f"product_evals k{k} degree {deg} at 2^{lg} "
                               f"live pairs, exact in both schedules: a "
                               f"thread a pair {ms['pair']:.4f} ms, four "
                               f"threads a pair {ms['split']:.4f} ms on the "
                               f"device; the wrapper takes "
                               f"{'four' if takes == 'split' else 'one'}")
    finally:
        evals.SPLIT_MAX_PAIRS = chosen


# ---------------------------------------------------------------------------
# Kernel G: product evals of any k and degree
# ---------------------------------------------------------------------------

# Kernel G's path at 2^ANY_LOG_N entries, tail 0: ProductSumcheck at
# k = 4 and 5 and DeviceProductTables at (1, 1) and (2, 5) on cuda:0; the
# engines at (4, 4), (5, 5), (1, 1) and (2, 5) on a mesh of ANY_SHARDS
# shards of cuda:0. Kernel G timed alone at each (k, degree) of ANY_TIMED
# (the first the JSON line's shape), and at 8193 live pairs.
ANY_LOG_N = 16
ANY_SUMCHECKS = (4, 5)
ANY_ENGINES = ((1, 1), (2, 5))
ANY_SHARDS = 2
ANY_TIMED = ((4, 4), (5, 5), (1, 1), (2, 5), (8, 8))


def check_any(torch, gen, stats: dict) -> None:
    """Kernel G against product_evals_plain on the same CUDA tensors
    (max_abs_err 0) at (k, 2^16, 8) for each (k, degree) of ANY_TIMED,
    every pair live and 8193 live pairs, and timed as in phase 3."""
    from zolt_tpu_torch.field import evals

    n = 1 << ANY_LOG_N
    for i, (k, deg) in enumerate(ANY_TIMED):
        tabs = rand_tables(torch, gen, k, n, n)
        err = 0
        for live in (n // 2, 8193):
            g = [(tabs, live, deg)]
            err = max(err, max_abs(torch, evals.product_evals(g)[0],
                                   evals.product_evals_plain(*g[0])))
        if err:
            raise AssertionError(f"kernel G differs from its plain version "
                                 f"at k {k} degree {deg}: {err}")
        g = [(tabs, n // 2, deg)]
        name = "product_evals_any" + ("" if i == 0 else f"_k{k}_d{deg}")
        timings(torch, stats, name, lambda: evals.product_evals(g),
                lambda: evals.product_evals_plain(*g[0]),
                *evals.work_any(g), f"({k}, 2^{ANY_LOG_N}, 8), degree {deg} "
                f"({len(evals.descriptors(deg))} descriptors)", err,
                phase="any", device_name=DEVICE_NAMES["product_evals_any"])


class _EngineRounds:
    """A sumcheck instance over a DeviceProductTables."""

    def __init__(self, eng, rounds: int, degree: int):
        self.eng, self.num_rounds, self.degree = eng, rounds, degree

    def round_evals(self) -> list:
        return self.eng.round_evals()

    def bind(self, r: int) -> None:
        self.eng.bind(r)


def any_proofs(torch, stacks: dict, device=None, mesh=None) -> dict:
    """Each case's sumcheck proof (compressed polys, challenges, final
    claim, finals) over the factor stacks {(k, degree): (k, n, 8)}: with
    `device`, ProductSumcheck (and initial_claim_product) for degree = k
    in ANY_SUMCHECKS and DeviceProductTables for the others; with `mesh`,
    DeviceProductTables on it for every case."""
    from zolt_tpu_torch.parallel.stage_engine import DeviceProductTables
    from zolt_tpu_torch.sumcheck import (ProductSumcheck,
                                         initial_claim_product, run_sumcheck)
    from zolt_tpu_torch.transcript import Blake2bTranscript

    dev = device if mesh is None else mesh.devices[0]
    out = {}
    for (k, deg), st in stacks.items():
        polys = list(st.to(dev))
        rounds = st.shape[1].bit_length() - 1
        claim = initial_claim_product(polys)
        if mesh is None and k == deg and k in ANY_SUMCHECKS:
            inst = ProductSumcheck(polys)
            finals = inst.final_claims
        else:
            eng = DeviceProductTables(
                polys, degree=deg,
                **(dict(mesh=mesh) if mesh else dict(device=device)))
            inst = _EngineRounds(eng, rounds, deg)
            finals = eng.finals
        pf = run_sumcheck(inst, Blake2bTranscript(b"any"), claim)
        out[k, deg] = (claim, pf.compressed_polys, pf.challenges,
                       pf.final_claim, finals())
    return out


def run_any(torch) -> dict:
    """Kernel G: check_any, then its path (ANY_LOG_N, tail 0) on cuda:0
    and on a mesh of ANY_SHARDS shards of cuda:0, the counts at 0 before
    each: kernel G must launch in each, and every proof must equal the
    plain versions' on the CPU. G's launches on cuda:0 are timed by CUDA
    events, beside the bound of the work its wrapper counted."""
    from zolt_tpu_torch.parallel import make_mesh

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(20261019)
    stats: dict = {}
    check_any(torch, gen, stats)
    n = 1 << ANY_LOG_N
    cases = [(k, k) for k in ANY_SUMCHECKS] + list(ANY_ENGINES)
    stacks = {c: rand_tables(torch, gen, c[0], n, n).cpu() for c in cases}
    mesh = make_mesh(["cuda:0"] * ANY_SHARDS)
    runs, secs = {}, {}
    os.environ["ZOLT_TPU_DEVICE_TAIL"] = "0"
    try:
        t1 = time.perf_counter()
        want = any_proofs(torch, stacks, device="cpu")
        cpu_s = time.perf_counter() - t1
        for where, kw in (("cuda:0", dict(device="cuda:0")),
                          (f"mesh of {ANY_SHARDS}", dict(mesh=mesh))):
            reset_launches()
            t1 = time.perf_counter()
            with launch_events(torch, "zfr_product_evals_any") as ev:
                got = any_proofs(torch, stacks, **kw)
            torch.cuda.synchronize()
            secs[where] = round(time.perf_counter() - t1, 3)
            launches, work = read_launches()
            if got != want:
                bad = [c for c in cases if got[c] != want[c]]
                raise AssertionError(f"kernel G's path on {where} differs "
                                     f"from the CPU plain run at {bad}")
            if launches["product_evals_any"] <= 0:
                raise AssertionError(f"kernel G did not launch on {where}")
            figs = path_figures(work, {"product_evals_any": sum(ev)}, "any",
                                f"kernel G's path on {where}",
                                names=("product_evals_any",))
            runs[where] = dict(launches=launches, events_ms=sum(ev),
                               figures=figs["product_evals_any"])
            say("any", f"on {where}: proofs of {cases} equal to the CPU "
                       f"plain run's; launches {launches}; G's launches by "
                       f"CUDA events {sum(ev):.4f} ms in {len(ev)}")
    finally:
        del os.environ["ZOLT_TPU_DEVICE_TAIL"]
    secs.update(cpu_plain=round(cpu_s, 3),
                phase=round(time.perf_counter() - t0, 3))
    say("any", f"seconds {secs}")
    return dict(stats=stats, runs=runs, seconds=secs)


# ---------------------------------------------------------------------------
# G1: kernels A-D, the commitments' two tiers, HyperKZG
# ---------------------------------------------------------------------------

# Kernel F at the bench field section's full size, 2^16 entries.
FIELD_LOG_N = 16
F_POW_BITS = (1, 0, 0, 1, 1, 0, 1)       # a short exponent, 0b1011001
# F's batch_inverse swept over the threads a launch aims for
# (inverse.TARGET_THREADS, which sets the chunk), at each size.
F_SWEEP_LOG_N = (12, 16, 18)
F_SWEEP_THREADS = (132 * 32, 132 * 64, 132 * 128, 132 * 256, 132 * 512)
# F's batch_inverse before its redesign (a Fermat inverse a chunk, 379
# dependent products; NVIDIA H100 80GB HBM3 at 700.00 W: at 2^16 this
# script's field phase, at 2^18 `bench --only roofline`): recorded figures,
# printed on a line of their own and kept out of the kernels line.
PRIOR_F_DEVICE_MS = {16: 0.4034, 18: 0.4709}
# The other design the sweep tried, a product tree a block of 256 chunks
# with one divstep inverse a block, at each size's best target (132 x 32
# at 2^12, 132 x 256 at 2^16, 132 x 512 at 2^18; this script's field
# phase with both designs on an NVIDIA H100 80GB HBM3 at 700.00 W, against
# 0.0357 / 0.0393 / 0.0579 ms for an inverse a chunk in the same run). It
# was slower at every size and taken out: recorded figures, printed on a
# line of their own.
PRIOR_F_TREE_MS = {12: 0.0441, 16: 0.0480, 18: 0.0668}


def field_words(torch, gen, n: int):
    """(n, 8) random canonical words of Fr and of Fp (below 2^253), a tenth
    of them zero (every tenth, from the first)."""
    w = rand_tables(torch, gen, 1, n, n)[0]
    w[::10] = 0
    return w.contiguous()


def inverse_sweep(torch, gen) -> list:
    """F's batch_inverse over Fr at every thread target of F_SWEEP_THREADS
    and each size of F_SWEEP_LOG_N (a tenth zero): exact against the plain
    version, and its device ms (torch.profiler, 20 calls), beside the
    product tree's recorded figure. The wrapper's target is restored
    after."""
    from zolt_tpu_torch.field import inverse, limb

    chosen = inverse.TARGET_THREADS
    rows = []
    try:
        for lg in F_SWEEP_LOG_N:
            a = field_words(torch, gen, 1 << lg)
            want = inverse.batch_inverse_plain(a, limb.FR_C)
            for target in F_SWEEP_THREADS:
                inverse.TARGET_THREADS = target
                if not torch.equal(limb.batch_inverse(a), want):
                    raise AssertionError(
                        f"batch_inverse ({target} threads) differs from its "
                        f"plain version at 2^{lg}")
                ms = device_ms(torch, lambda: limb.batch_inverse(a), 20,
                               "batch_inverse")
                rows.append(dict(log_n=lg, target_threads=target,
                                 chunk=inverse.chunk_of(1 << lg),
                                 device_ms=round(ms, 4)))
            here = [r for r in rows if r["log_n"] == lg]
            best = min(here, key=lambda r: r["device_ms"])
            say("field", f"batch_inverse sweep at 2^{lg}, exact in every "
                         f"cell: "
                         + "; ".join(f"{r['target_threads']} threads (c "
                                     f"{r['chunk']}) {r['device_ms']:.4f}"
                                     for r in here)
                         + f" ms; fastest {best['target_threads']}, the "
                           f"wrapper's {chosen}")
            say("field", f"batch_inverse at 2^{lg} as a product tree a "
                         f"block: {PRIOR_F_TREE_MS[lg]:.4f} ms (recorded, "
                         f"not measured here)")
    finally:
        inverse.TARGET_THREADS = chosen
    return rows


def run_field(torch) -> dict:
    """Kernel F (csrc/field_inv.cu) against its plain versions and Python's
    pow, over Fr and Fp: batch_inverse at 2^16 entries, a tenth zero (each
    product x·y checked to be 1, which pins y to pow(x, p − 2, p); Python's
    pow itself on the first 4099), at n = 1 and at an odd n; pow_fixed
    with a short exponent and with no bits (one). Times batch_inverse at
    2^16 and 2^18 over Fr (CUDA events, the device alone by
    torch.profiler, the bound of the work this input needs, the plain
    version) beside its recorded figures before the divstep redesign,
    sweeps its chunk (inverse_sweep), and times inverse (pow_fixed over
    p - 2) at 2^16. Then the path: the bench's field section (quick, n = 2^12) with the
    counts at 0, whose batch_inverse launches are F's path launches, and
    the bench's chipcheck (every hand-written kernel against its plain
    version at a small size). Returns the figures."""
    from zolt_tpu_torch import benchmarks
    from zolt_tpu_torch.field import inverse, limb

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(20261018)
    n = 1 << FIELD_LOG_N
    err = 0
    for f in (limb.FR_C, limb.FP_C):
        p = f.params.p
        a = field_words(torch, gen, n)
        got = limb.batch_inverse(a, f)
        err = max(err, max_abs(torch, got, inverse.batch_inverse_plain(a, f)))
        vals = limb.decode(a, f)
        # x·y = 1 pins y to pow(x, p - 2, p), the one inverse below p, at a
        # microsecond an entry (a Python pow takes some 100 µs)
        if not all(w == 0 if v == 0 else v * w % p == 1
                   for v, w in zip(vals, limb.decode(got, f))):
            raise AssertionError(f"batch_inverse ({f.name}, 2^{FIELD_LOG_N}) "
                                 f"is not the inverse")
        for m in (1, 4099):
            got = limb.decode(limb.batch_inverse(a[:m], f), f)
            if got != [pow(v, p - 2, p) for v in vals[:m]]:
                raise AssertionError(f"batch_inverse ({f.name}, n = {m}) "
                                     f"differs from Python's pow")
        small = a[:4099]
        for bits in (F_POW_BITS, ()):
            e = sum(b << i for i, b in enumerate(bits))
            got = limb.mont_pow_fixed(small, bits, f)
            err = max(err, max_abs(torch, got,
                                   inverse.pow_fixed_plain(small, bits, f)))
            if limb.decode(got, f) != [pow(v, e, p) for v in vals[:4099]]:
                raise AssertionError(f"pow_fixed ({f.name}, e = {e}) "
                                     f"differs from Python's pow")
    if err:
        raise AssertionError(f"kernel F differs from its plain version: {err}")
    say("field", f"kernel F exact (max_abs_err 0) vs plain: batch_inverse "
                 f"over Fr and Fp at 2^{FIELD_LOG_N} (a tenth zero; x·y = 1 "
                 f"on every entry, Python's pow on the first 4099), n = 1 "
                 f"and 4099; pow_fixed with {len(F_POW_BITS)} bits and with "
                 f"none (Python's pow)")
    stats: dict = {}
    for lg, name in ((FIELD_LOG_N, "field_inv"), (18, "field_inv_2p18")):
        a = field_words(torch, gen, 1 << lg)
        nonzero = int((a != 0).any(dim=1).sum().item())
        timings(torch, stats, name, lambda: limb.batch_inverse(a),
                lambda: inverse.batch_inverse_plain(a, limb.FR_C),
                *inverse.inverse_work(1 << lg, nonzero, limb.FR_C),
                f"batch_inverse, Fr, 2^{lg} entries ({nonzero} non-zero), "
                f"chunks of {inverse.chunk_of(1 << lg)}",
                err, plain_iters=1, phase="field",
                device_name="batch_inverse")
        say("field", f"batch_inverse at 2^{lg}: device "
                     f"{stats[name]['device_ms']:.4f} ms in this run; "
                     f"{PRIOR_F_DEVICE_MS[lg]:.4f} ms before the redesign "
                     f"(a Fermat inverse a chunk; recorded, not measured "
                     f"here)")
    stats["field_inv"]["sweep"] = inverse_sweep(torch, gen)
    a = field_words(torch, gen, n)
    bits = limb.FR_C.p_minus_2_bits
    timings(torch, stats, "field_inv_pow", lambda: limb.inverse(a),
            lambda: inverse.pow_fixed_plain(a, bits, limb.FR_C),
            *inverse.pow_work(n, bits),
            f"inverse (pow_fixed, p - 2), Fr, 2^{FIELD_LOG_N} entries", err,
            plain_iters=1, phase="field", device_name="pow_kernel")
    checked_s = time.perf_counter() - t0

    lines: list[str] = []
    reset_launches()
    t1 = time.perf_counter()
    benchmarks.run_benchmarks(sections=["field"], quick=True,
                              report=lines.append)
    bench_s = time.perf_counter() - t1
    launches, _ = read_launches()
    if launches["field_inv"] <= 0:
        raise AssertionError("the bench's field section did not launch "
                             "kernel F")
    for ln in lines:
        say("field", f"bench: {ln}")
    t2 = time.perf_counter()
    benchmarks.run_benchmarks(sections=["chipcheck"], quick=True,
                              report=lambda ln: say("field", f"bench: {ln}"))
    chipcheck_s = time.perf_counter() - t2
    secs = dict(checks=round(checked_s, 3), bench_field=round(bench_s, 3),
                chipcheck=round(chipcheck_s, 3),
                phase=round(time.perf_counter() - t0, 3))
    say("field", f"kernel F launched {launches['field_inv']} times in the "
                 f"bench's field section; seconds {secs}")
    return dict(stats=stats, launches=launches, seconds=secs)


def jac_words(points, lams):
    """Host affine points (None: the identity, (0, 1, 0)) as a Jacobian
    triple of CPU tensors of Fp Montgomery words with Z = λ."""
    from zolt_tpu_torch.field import limb
    from zolt_tpu_torch.field.params import FP

    p = FP.p
    xs, ys, zs = [], [], []
    for pt, lm in zip(points, lams):
        if pt is None:
            xs.append(0), ys.append(1), zs.append(0)
        else:
            xs.append(pt[0] * lm * lm % p)
            ys.append(pt[1] * pow(lm, 3, p) % p)
            zs.append(lm)
    return tuple(limb.encode(v, limb.FP_C) for v in (xs, ys, zs))


def g1_edge_pairs(n: int, seed: int, generic: bool = False):
    """n pairs of Jacobian points as CPU tensors of Fp Montgomery words,
    each with a random Z, drawn from 256 multiples of the generator: about
    half are edge cases (identity + P, P + identity, identity + identity,
    P + P with another Z and with the same Z, P + (−P)), the rest generic;
    with `generic`, every pair is P + Q with Q ≠ ±P."""
    import numpy as np

    from zolt_tpu_torch.curve import host
    from zolt_tpu_torch.field.params import FP

    rng = np.random.default_rng(seed)
    base = host.random_points(256, seed=seed)
    p = FP.p
    kinds = rng.integers(0, 12, n) if not generic else np.full(n, 11)
    ia = rng.integers(0, 256, n)
    ib = (ia + rng.integers(1, 256, n)) % 256 if generic else \
        rng.integers(0, 256, n)
    lam = [int(x) * int(y) % p or 1 for x, y in zip(
        rng.integers(1, 1 << 62, 2 * n), rng.integers(1, 1 << 62, 2 * n))]
    a, b = [], []
    for t, (k, i, j) in enumerate(zip(kinds, ia, ib)):
        P, Q = base[i], base[j]
        a.append(None if k in (0, 2) else P)
        b.append({0: Q, 1: None, 2: None, 3: P, 4: P,
                  5: host.neg(P)}.get(int(k), Q))
        if k == 4:
            lam[n + t] = lam[t]
    return jac_words(a, lam[:n]), jac_words(b, lam[n:])


def g1_fold_stack(k: int, n: int, seed: int):
    """A stacked Jacobian triple of (k, n, 8) CPU word tensors, each point
    with a random Z, drawn from 16 multiples of the generator, whose left
    fold meets every case of kernel A's add mid-fold. Column i's kind: 0
    random points, a quarter of them empty buckets (the identity); 1 its
    step 1 the running sum's negative (the sum becomes the identity, then
    meets the next point); 2 its last step the running sum itself (a
    doubling); 3 every array empty but one."""
    import numpy as np

    from zolt_tpu_torch.curve import host
    from zolt_tpu_torch.field.params import FP

    rng = np.random.default_rng(seed)
    base = host.random_points(16, seed=seed)
    cols = []
    for i in range(n):
        kind = int(rng.integers(0, 4))
        col = [base[int(j)] if rng.random() > 0.25 else None
               for j in rng.integers(0, len(base), k)]
        if kind == 1 and k > 1:
            col[0] = col[0] or base[0]
            col[1] = host.neg(col[0])
        if kind == 2 and k > 1:
            acc = None
            for pt in col[:-1]:
                acc = host.add(acc, pt)
            col[-1] = acc
        if kind == 3:
            col = [None] * k
            col[int(rng.integers(0, k))] = base[i % len(base)]
        cols.append(col)
    lams = rng.integers(1, 1 << 62, (2, k * n))
    words = jac_words([col[j] for j in range(k) for col in cols],
                      [int(x) * int(y) % FP.p for x, y in zip(*lams)])
    return tuple(c.view(k, n, 8) for c in words)


def affine_of(pt) -> list:
    """Jacobian word tensors (any device) -> host affine points."""
    from zolt_tpu_torch.field import limb
    from zolt_tpu_torch.msm.rows_device import _batch_affine

    return _batch_affine(*(limb.decode(c.reshape(-1, 8), limb.FP_C)
                           for c in pt))


def check_g1(torch, stats: dict, log_t: int):
    """Kernels A-E against their plain versions and the host C tier (C
    also on the internal prover's RAM and rd polys at T = 2^log_t).
    Returns the KZG SRS of 2^18 powers, whose points the Pippenger takes
    (and run_kzg and run_internal reuse)."""
    from zolt_tpu_torch.curve import device as dev
    from zolt_tpu_torch.pcs import srs as srs_mod

    gen = torch.Generator(device="cuda")
    gen.manual_seed(20261017)
    # A: 2^16 pairs, words equal to the plain version's
    n = 1 << 16
    t0 = time.perf_counter()
    pa, pb = (tuple(c.cuda() for c in pt) for pt in g1_edge_pairs(n, 7))
    say("g1", f"2^16 edge-case pairs made in {time.perf_counter() - t0:.2f} s")
    err = max(max_abs(torch, g, w) for g, w in
              zip(dev.pt_add(pa, pb) + dev.pt_double(pa),
                  dev.pt_add_plain(pa, pb) + dev.pt_double_plain(pa)))
    if err:
        raise AssertionError(f"kernel A differs from its plain version: {err}")
    timings(torch, stats, "g1_add_double", lambda: dev.pt_add(pa, pb),
            lambda: dev.pt_add_plain(pa, pb), *dev.add_work(pa, pb),
            "pt_add, 2^16 pairs, half edge cases (synthetic)", err,
            phase="g1",
            device_name="g1_add_kernel")
    timings(torch, stats, "g1_double", lambda: dev.pt_double(pa),
            lambda: dev.pt_double_plain(pa), *dev.double_work(n),
            "pt_double, 2^16 points", err, phase="g1",
            device_name="g1_double_kernel")
    t0 = time.perf_counter()
    ga, gb = (tuple(c.cuda() for c in pt)
              for pt in g1_edge_pairs(n, 8, generic=True))
    err = max(max_abs(torch, g, w) for g, w in
              zip(dev.pt_add(ga, gb), dev.pt_add_plain(ga, gb)))
    if err:
        raise AssertionError(f"kernel A differs from its plain version on "
                             f"generic pairs: {err}")
    timings(torch, stats, "g1_add_generic", lambda: dev.pt_add(ga, gb),
            lambda: dev.pt_add_plain(ga, gb), *dev.add_work(ga, gb),
            "pt_add, 2^16 generic pairs", err, phase="g1",
            device_name="g1_add_kernel")
    check_sum(torch, stats)
    say("g1", f"kernel A's generic pairs, fold and lanes sweep took "
              f"{time.perf_counter() - t0:.1f} s")
    check_rows(torch, gen, stats)
    t0 = time.perf_counter()
    kzg = srs_mod.insecure_setup(1 << KZG_LOG_N)
    say("g1", f"KZG SRS of 2^{KZG_LOG_N} powers in "
              f"{time.perf_counter() - t0:.2f} s (host, native C)")
    check_pippenger(torch, stats, kzg)
    check_bucket_polys(torch, stats, kzg, log_t)
    return kzg


# msm_mesh's fold at 2^16 points on MESH_SHARDS shards: a pass stacks the
# shards' bucket arrays of 8 windows x 256 buckets.
LADDER = (4, 2048)
# The lanes sweep: zg1_sum's lanes a pair, at the fold sizes msm_mesh
# makes (8 to 32 windows a pass; the ladder's stack tiled to n points).
SUM_LANES = (4, 8)
SUM_SWEEP_N = (2048, 4096, 8192)


def check_sum(torch, stats: dict) -> None:
    """Kernel A's fold (pt_sum) at the ladder's shape, its words equal to
    pt_sum_plain's, timed; then the lanes sweep: at each n of SUM_SWEEP_N
    (the ladder's stack tiled) and each lanes a pair of SUM_LANES, the
    words equal to the plain fold's and the device ms (torch.profiler, 20
    calls), from which lanes_per_pair's cut-off was set."""
    from zolt_tpu_torch.curve import device as dev

    k, n = LADDER
    stack = tuple(c.cuda() for c in g1_fold_stack(k, n, 9))
    want = dev.pt_sum_plain(stack)
    err = max(max_abs(torch, g, w) for g, w in zip(dev.pt_sum(stack), want))
    if err:
        raise AssertionError(f"kernel A's fold differs from pt_sum_plain: "
                             f"{err}")
    timings(torch, stats, "g1_sum", lambda: dev.pt_sum(stack),
            lambda: dev.pt_sum_plain(stack), *dev.sum_work(stack),
            f"pt_sum, {k} x {n} points with mid-fold edge cases, "
            f"{dev.lanes_per_pair(n)} lanes a pair", err, phase="g1",
            device_name="g1_sum_kernel")
    sweep, pick = {}, dev.lanes_per_pair
    picks = {m: pick(m) for m in SUM_SWEEP_N}
    try:
        for m in SUM_SWEEP_N:
            big = tuple(c.repeat(1, m // n, 1) for c in stack)
            tiled = tuple(c.repeat(m // n, 1) for c in want)
            for lanes in SUM_LANES:
                dev.lanes_per_pair = lambda _, lanes=lanes: lanes

                def run():
                    return dev.pt_sum(big)
                if any(not torch.equal(g, w) for g, w in zip(run(), tiled)):
                    raise AssertionError(f"kernel A's fold at {lanes} lanes "
                                         f"a pair differs from pt_sum_plain "
                                         f"({k} x {m})")
                sweep[f"{m}x{lanes}"] = round(device_ms(torch, run, 20,
                                                        "g1_sum_kernel"), 4)
    finally:
        dev.lanes_per_pair = pick
    stats["g1_sum"]["lanes_sweep_ms"] = sweep
    say("g1", f"g1_sum at every lanes a pair (its wrapper's choice replaced "
              f"for the sweep), {k} x n points (n x lanes: device ms), "
              f"words equal to pt_sum_plain at each: {sweep}; "
              f"lanes_per_pair picks {picks}")


# The sound prove's one-hot cubes at T = 2^16: about 40 polys of 2^20
# entries, one 1 a cycle among 16 chunk values, in the 2^10 x 2^10 Dory
# layout; compat: 32 chunk polys of 2^16 entries below 16, 2^8 x 2^8.
SOUND_ROWS = (40, 1 << 10, 1 << 10, 1)
COMPAT_ROWS = (32, 1 << 8, 1 << 8, 4)


# Kernels B's, C's and D's device ms before their redesign (B a warp a
# row, D a thread a window, C a warp a bucket; this script on an NVIDIA
# H100 80GB HBM3 at 700.00 W; C's opening figure the internal prove's
# with its opening, 22 launches): recorded figures, printed on a line of
# their own beside this run's and kept out of the kernels line, which
# holds only what this run measured.
PRIOR_DEVICE_MS = {"row_plane_sums": 10.2933, "row_plane_sums_compat": 1.6565,
                   "window_sums": 11.5800, "window_sums_path": 284.0506,
                   "bucket_accumulate": 2.1448,
                   "bucket_accumulate_path": 35.2454,
                   "bucket_accumulate_opening": 36.9482}


def say_prior(phase: str, key: str, what: str, now: float | None) -> None:
    """This run's device ms of kernel B, C or D beside
    PRIOR_DEVICE_MS[key]."""
    name = key.removesuffix("_path").removesuffix("_compat").removesuffix(
        "_opening")
    say(phase, f"{name} {what}: device {ms_text(now)} in this run; "
               f"{PRIOR_DEVICE_MS[key]:.4f} ms before the redesign "
               f"(recorded, not measured here)")


def lanes_sweep(torch, vals, table, valid, nplanes: int, want: list,
                phase: str, what: str) -> dict:
    """Kernel B at every lanes-a-row it takes (its wrapper's choice
    replaced for the sweep), on the same inputs: each launch's affine rows
    must equal `want` (the plain version's); returns the device ms of each
    (torch.profiler, by kernel name, 20 calls)."""
    from zolt_tpu_torch.msm import rows_device

    out = {}
    pick = rows_device.lanes_per_row
    try:
        for lanes in rows_device.LANES:
            rows_device.lanes_per_row = lambda *_, n=lanes: n

            def run():
                return rows_device.row_sums(vals, table, valid, nplanes)
            if affine_of(run()) != want:
                raise AssertionError(f"kernel B at {lanes} lanes a row "
                                     f"differs from its plain version "
                                     f"({what})")
            out[lanes] = round(device_ms(torch, run, 20,
                                         DEVICE_NAMES["row_plane_sums"]), 4)
    finally:
        rows_device.lanes_per_row = pick
    say(phase, f"row_plane_sums at every lanes-a-row ({what}): affine equal "
               f"to the plain version at each; device ms {out}")
    return out


def check_rows(torch, gen, stats: dict) -> None:
    """Kernel B at the sound and compat shapes: affine rows equal to the
    host C tier's row MSMs (`dory.row_commitments`, as the host commit
    computes them), and to the plain version's, at the lanes a row its
    wrapper picks and at every other."""
    import numpy as np

    from zolt_tpu_torch.msm import rows_device
    from zolt_tpu_torch.native.frvec import FrVec
    from zolt_tpu_torch.pcs import dory

    srs = dory.setup(20)
    for name, (npoly, rows, cols, nplanes) in (("sound", SOUND_ROWS),
                                                ("compat", COMPAT_ROWS)):
        t0 = time.perf_counter()
        eng = rows_device.get_engine(srs, cols, "cuda")
        built = time.perf_counter() - t0
        if nplanes == 1:
            cyc = rows * cols // 16
            k = torch.randint(0, 16, (npoly, cyc), device="cuda",
                              generator=gen)
            pos = k * cyc + torch.arange(cyc, device="cuda")
            keep = torch.rand((npoly, cyc), device="cuda", generator=gen)
            pos = torch.where(keep < 0.9, pos, 0)     # cycles with no 1
            vals = torch.zeros((npoly, rows * cols), dtype=torch.uint8,
                               device="cuda")
            vals.scatter_(1, pos, 1)
            vals[:, 0] = 0
            vals[-1] = 0                               # an all-zero cube
        else:
            vals = torch.randint(0, 16, (npoly, rows * cols), device="cuda",
                                 generator=gen).to(torch.uint8)
            vals[-1] = 0
        vals = vals.view(npoly, rows, cols)
        got = rows_device.row_sums(vals, eng.table, eng.valid, nplanes)
        plain = rows_device.row_sums_plain(vals, eng.table, eng.valid, nplanes)
        aff = affine_of(got)
        if aff != affine_of(plain):
            raise AssertionError(f"kernel B differs from its plain version "
                                 f"at the {name} shape")
        t0 = time.perf_counter()
        host_rows = []
        for v in vals.reshape(npoly, -1).cpu().numpy():
            if nplanes == 1:
                ev = FrVec.indicator(v.size, np.nonzero(v)[0])
                host_rows += dory.row_commitments(srs, ev, num_vars=20)
            else:
                ev = FrVec.from_u64_array(v.astype(np.uint64))
                host_rows += dory.row_commitments(srs, ev)
        host_s = time.perf_counter() - t0
        if aff != host_rows:
            raise AssertionError(f"kernel B differs from the host C tier's "
                                 f"row MSMs at the {name} shape")
        nz = rows_device.count_nonzero(vals, eng.valid, nplanes)
        work = rows_device.work(nz, npoly * rows, cols, nplanes)
        lanes = rows_device.lanes_per_row(nz, npoly * rows,
                                          nplanes * cols // 8)
        say("g1", f"row_plane_sums at the {name} shape ({npoly} polys x "
                  f"{rows} rows x {cols} cols, {nplanes} planes; {nz} table "
                  f"points added, {lanes} lanes a row): affine equal to the "
                  f"plain version and to the host C tier's row MSMs "
                  f"({host_s:.3f} s on the host); engine built and uploaded "
                  f"in {built:.3f} s")
        key = "row_plane_sums" + ("" if nplanes == 1 else "_compat")
        timings(torch, stats, key,
                lambda: rows_device.row_sums(vals, eng.table, eng.valid,
                                             nplanes),
                lambda: rows_device.row_sums_plain(vals, eng.table, eng.valid,
                                                   nplanes),
                *work, f"{name}: {npoly} x {rows} x {cols}, {nplanes} planes, "
                f"{nz} points, {lanes} lanes a row",
                0, plain_iters=1, phase="g1",
                device_name=DEVICE_NAMES["row_plane_sums"])
        say_prior("g1", key, f"at the {name} shape",
                  stats[key]["device_ms"])
        stats[key].update(host_s=host_s, lanes=lanes,
                          lanes_ms=lanes_sweep(torch, vals, eng.table,
                                               eng.valid, nplanes, aff, "g1",
                                               f"the {name} shape"))


KZG_LOG_N = 18
# The Pippenger's sizes; kernels C and D are held to their plain versions
# at the first.
MSM_LOG_NS = (16, KZG_LOG_N)


def msm_inputs(kzg, n: int, seed: int):
    """The first n SRS powers with duplicates, a negation and the identity,
    and random scalars with zeros and repeats."""
    import numpy as np

    from zolt_tpu_torch.curve import host
    from zolt_tpu_torch.field.params import FR

    rng = np.random.default_rng(seed)
    pts = list(kzg.powers_g1[:n])
    pts[1], pts[2], pts[5] = pts[0], host.neg(pts[3]), None
    sc = [int.from_bytes(rng.bytes(32), "little") % FR.p for _ in range(n)]
    sc[1], sc[2], sc[4], sc[6] = sc[0], sc[3], 0, 1
    return pts, sc


def skewed_inputs(base: list, n: int, seed: int):
    """n points and scalars whose digits fill the buckets as the internal
    prover's RAM post-values do: the points repeat the
    16 of `base` and their negations, every 37th the identity, so that
    any bucket meets P + P and P + (−P) inside its chunks and across
    them; the scalars are 32-bit words, 35 % of them one address, 15 %
    another, 30 % counters below 2^16, 10 % zero, 10 % random."""
    import numpy as np

    from zolt_tpu_torch.curve import host

    rng = np.random.default_rng(seed)
    pts = [None if i % 37 == 5 else
           host.neg(base[i % 16]) if (i // 16) % 2 else base[i % 16]
           for i in range(n)]
    u = rng.random(n)
    counters = rng.integers(1, 1 << 16, n)
    words = rng.integers(0, 1 << 32, n)
    sc = [0x80000010 if v < 0.35 else 0x7FFFEF00 + int(c) % 256
          if v < 0.5 else int(c) if v < 0.8 else 0 if v < 0.9 else int(w)
          for v, c, w in zip(u, counters, words)]
    return pts, sc


def check_pippenger(torch, stats: dict, kzg) -> None:
    """Kernels C and D: the Pippenger at n = 2^16 and 2^18 equal to the
    native C MSM; at 2^16 each kernel's buckets and window totals affine
    equal to its plain version's. Times the host stages of a call. Kernel
    E at 2^18: digits equal to its plain version's and the host's."""
    from zolt_tpu_torch.field import limb
    from zolt_tpu_torch.msm import pippenger
    from zolt_tpu_torch.native import g1_msm_native

    for log_n in MSM_LOG_NS:
        n = 1 << log_n
        pts, sc = msm_inputs(kzg, n, log_n)
        t0 = time.perf_counter()
        want = g1_msm_native(pts, sc)
        native_s = time.perf_counter() - t0
        t = [time.perf_counter()]
        ptab, valid = pippenger.affine_table(pts, "cuda")
        t.append(time.perf_counter())
        digits = pippenger.int_digits(sc, "cuda")
        t.append(time.perf_counter())
        ent, seg = pippenger.bucket_plan(digits)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        B = pippenger.bucket_sums(ent, seg, ptab, valid)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        W = pippenger.window_sums(*B)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        t0 = time.perf_counter()
        got = pippenger.pippenger(pts, sc, "cuda")
        call_s = time.perf_counter() - t0
        if got != want:
            raise AssertionError(f"the Pippenger differs from the native "
                                 f"MSM at n = 2^{log_n}")
        steps = dict(zip(("affine_table", "digits", "sort_plan",
                          "bucket_accumulate", "window_sums"),
                         (round(b - a, 4) for a, b in zip(t, t[1:]))))
        say("g1", f"Pippenger at n = 2^{log_n} equal to the native C MSM "
                  f"({native_s:.3f} s on the host): one call {call_s:.3f} "
                  f"s; its steps (s, host clock) {steps}")
        stats[f"pippenger_2^{log_n}"] = dict(call_s=call_s, native_s=native_s,
                                             steps=steps)
        if log_n == KZG_LOG_N:
            words = limb.encode(sc, device="cuda")
            got = pippenger.scalar_digits(words)
            err = max_abs(torch, got, pippenger.scalar_digits_plain(words))
            if err or not torch.equal(got, digits):
                raise AssertionError("kernel E's digits differ from its plain "
                                     "version's or the host's")
            timings(torch, stats, "scalar_digits",
                    lambda: pippenger.scalar_digits(words),
                    lambda: pippenger.scalar_digits_plain(words),
                    *pippenger.digits_work(n), f"n = 2^{log_n} scalars", err,
                    phase="g1", device_name=DEVICE_NAMES["scalar_digits"])
        if affine_of(W) != affine_of(pippenger.window_sums_plain(*B)):
            raise AssertionError(f"kernel D differs from its plain version "
                                 f"at n = 2^{log_n}")
        say("g1", f"window_sums at n = 2^{log_n}: affine equal to the plain "
                  f"version")
        if log_n != MSM_LOG_NS[0]:
            continue
        if affine_of(B) != affine_of(
                pippenger.bucket_sums_plain(ent, seg, ptab, valid)):
            raise AssertionError("kernel C differs from its plain version")
        timings(torch, stats, "bucket_accumulate",
                lambda: pippenger.bucket_sums(ent, seg, ptab, valid),
                lambda: pippenger.bucket_sums_plain(ent, seg, ptab, valid),
                *pippenger.bucket_work(ent, seg, valid, n),
                f"n = 2^{log_n} random scalars: {plan_text(seg)}", 0,
                plain_iters=1, phase="g1",
                device_name=DEVICE_NAMES["bucket_accumulate"])
        say_prior("g1", "bucket_accumulate", f"at n = 2^{log_n}",
                  stats["bucket_accumulate"]["device_ms"])
        timings(torch, stats, "window_sums",
                lambda: pippenger.window_sums(*B),
                lambda: pippenger.window_sums_plain(*B),
                *pippenger.window_work(32), "32 windows x 255 buckets", 0,
                plain_iters=1, phase="g1",
                device_name=DEVICE_NAMES["window_sums"])
        say_prior("g1", "window_sums", "at 32 windows",
                  stats["window_sums"]["device_ms"])


def plan_text(seg) -> str:
    """A bucket plan's entries, largest bucket and kernel C's chunks a
    pass."""
    from zolt_tpu_torch.msm import pippenger

    top = int((seg[1:] - seg[:-1]).max())
    chunks = [p.numel() - 1 for p in pippenger.bucket_chunks(seg)]
    return (f"{int(seg[-1])} entries, largest bucket {top}, chunks a pass "
            f"{chunks}")


def check_bucket_polys(torch, stats: dict, kzg, log_t: int) -> None:
    """Kernel C on the scalars the internal prover commits with its
    opening (internal_polys at T = 2^log_t: the RAM post-values, whose
    largest bucket holds a third of the points, and the rd values), over
    the SRS's first points: buckets affine equal to the plain version's,
    timed as in timings()."""
    from zolt_tpu_torch.msm import pippenger

    polys = internal_polys(*opening_inputs(log_t))
    table, valid_all = pippenger.srs_table(kzg, "cuda")
    for name, poly in (("ram", polys[1]), ("rd", polys[2])):
        n = len(poly)
        ptab, valid = table[:n], valid_all[:n]
        ent, seg = pippenger.bucket_plan(pippenger.int_digits(poly, "cuda"))
        B = pippenger.bucket_sums(ent, seg, ptab, valid)
        if affine_of(B) != affine_of(
                pippenger.bucket_sums_plain(ent, seg, ptab, valid)):
            raise AssertionError(f"kernel C differs from its plain version "
                                 f"on the {name} poly")
        timings(torch, stats, f"bucket_accumulate_{name}",
                lambda: pippenger.bucket_sums(ent, seg, ptab, valid),
                lambda: pippenger.bucket_sums_plain(ent, seg, ptab, valid),
                *pippenger.bucket_work(ent, seg, valid, n),
                f"the internal prover's {name} poly, n = 2^"
                f"{n.bit_length() - 1}: {plan_text(seg)}", 0, plain_iters=1,
                phase="g1",
                device_name=DEVICE_NAMES["bucket_accumulate"])


def run_kzg(torch, kzg) -> dict:
    """The HyperKZG path on the card at 2^18: commit (a tensor of Fr
    Montgomery words on the card: kernel E, then C and D), open (the fold
    commitments of 2^17..2^1 points and the three witnesses, each a
    Pippenger on the card) under torch.profiler, and verify; the
    commitment equals the native C MSM's. Returns the launches of the
    run, each kernel's path figures (the bound of the work its wrapper
    counted, its device ms) and the seconds."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from zolt_tpu_torch.field import limb
    from zolt_tpu_torch.field.params import FR
    from zolt_tpu_torch.native import g1_msm_native
    from zolt_tpu_torch.pcs import hyperkzg
    from zolt_tpu_torch.transcript import Blake2bTranscript

    rng = np.random.default_rng(18)
    n = 1 << KZG_LOG_N
    evals = [int.from_bytes(rng.bytes(32), "little") % FR.p for _ in range(n)]
    x = [int.from_bytes(rng.bytes(32), "little") % FR.p
         for _ in range(KZG_LOG_N)]
    words = limb.encode(evals, device="cuda")
    reset_launches()
    with g1_events(torch) as events, \
            profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        com = hyperkzg.commit(kzg, words)
        t1 = time.perf_counter()
        proof = hyperkzg.open_at(kzg, evals, x, Blake2bTranscript(b"kzg"),
                                 device="cuda")
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    launches, counts = read_launches()
    ok = hyperkzg.verify(kzg, com, x, hyperkzg._mle_eval(evals, x), proof,
                         Blake2bTranscript(b"kzg"))
    t3 = time.perf_counter()
    if not ok:
        raise AssertionError("the HyperKZG proof at 2^18 does not verify")
    if com != g1_msm_native(kzg.powers_g1, evals):
        raise AssertionError("the HyperKZG commitment differs from the "
                             "native C MSM")
    idle = [k for k in KZG_PATH if launches[k] <= 0]
    if idle:
        raise AssertionError(f"kernels not launched on the HyperKZG path: "
                             f"{idle}")
    figures = g1_path_figures(prof, counts, events, "kzg",
                              "the HyperKZG path")
    say_prior("kzg", "window_sums_path", "on the HyperKZG path",
              figures["window_sums"]["device_ms"])
    say_prior("kzg", "bucket_accumulate_path", "on the HyperKZG path",
              figures["bucket_accumulate"]["device_ms"])
    secs = dict(commit=t1 - t0, open=t2 - t1, verify=t3 - t2)
    say("kzg", f"HyperKZG at 2^{KZG_LOG_N} on the card: commit, open and "
               f"verify pass, the commitment equals the native C MSM; "
               f"seconds (commit and open under torch.profiler; the first "
               f"commit builds the SRS's table) {secs}; launches {launches}")
    return dict(launches=launches, seconds=secs, figures=figures)


def g1_path_figures(prof, counts: dict, events: dict, phase: str,
                    what: str) -> dict:
    """Per G1 kernel of KZG_PATH: the bound of the work its wrapper counted
    (`counts`, as read_launches gives them), its device ms by
    torch.profiler (`prof`; None where the profiler lost a launch) and
    by CUDA events (`events`, as launch_events yields them). Printed one
    line a kernel."""
    dev_ms = recorded_ms(prof, counts, KZG_PATH, phase)
    figures = {}
    for k in KZG_PATH:
        c = counts[k]
        b_ms, b_by = bound(c["bytes"], c["imads"])
        figures[k] = dict(launches=c["launches"], bound_ms=b_ms,
                          bound_by=b_by, device_ms=dev_ms[k],
                          device_ms_events=round(sum(events[k]), 4))
        if "kernels" in c:
            figures[k]["kernel_launches"] = c["kernels"]
        passes = (f" ({c['kernels']} kernel launches)" if "kernels" in c
                  else "")
        say(phase, f"{k} on {what}: {c['launches']} launches{passes}, "
                   f"{c['bytes']} bytes, {c['imads']} IMADs, bound "
                   f"{b_ms:.4f} ms by {b_by}, device {ms_text(dev_ms[k])}; "
                   f"by CUDA events {figures[k]['device_ms_events']:.4f} ms "
                   f"over {len(events[k])} launches")
    return figures


@contextlib.contextmanager
def g1_events(torch):
    """launch_events around kernels C, D and E at once: yields {kernel:
    the device ms of each of its launches}."""
    with launch_events(torch, "zg1_window_sums") as d_ev, \
            launch_events(torch, "zg1_bucket_accumulate") as c_ev, \
            launch_events(torch, "zg1_scalar_digits") as e_ev:
        yield {"window_sums": d_ev, "bucket_accumulate": c_ev,
               "scalar_digits": e_ev}


def commit_inputs(path: str, sound: bool) -> dict:
    """The commitment phase's inputs, as prove_jolt makes them."""
    from zolt_tpu_torch.vm import pad_with_noop, run_elf
    from zolt_tpu_torch.zkvm import pipeline
    from zolt_tpu_torch.zkvm.bytecode_tables import BytecodeIndex

    emu = run_elf(path, expand_virtual=sound)
    return dict(steps=pad_with_noop(list(emu.trace)),
                bytecode_len=pipeline._bytecode_len(path),
                memory_trace_len=len(emu.ram.trace), sound=sound,
                log_ram_k=pipeline.LOG_RAM_K,
                start_address=emu.device.layout.lowest_address(),
                bc_index=BytecodeIndex.from_elf(path) if sound else None)


def path_density(torch, caught: list, mode: str) -> list:
    """Kernel B on the inputs the commitment phase gave it (the path's own
    density), at the lanes its wrapper picks and at every other: affine
    equal to the plain version's at each (the phase's commitments are
    already held to the host C tier's)."""
    from zolt_tpu_torch.msm import rows_device

    out = []
    for vals, table, valid, nplanes in caught:
        npoly, rows, cols = vals.shape
        nz = rows_device.count_nonzero(vals, valid, nplanes)
        lanes = rows_device.lanes_per_row(nz, npoly * rows,
                                          nplanes * cols // 8)
        want = affine_of(rows_device.row_sums_plain(vals, table, valid,
                                                    nplanes))
        what = (f"{mode} path: {npoly} x {rows} x {cols}, {nplanes} planes, "
                f"{nz} points, {nz / (npoly * rows):.1f} a row, the "
                f"wrapper's {lanes} lanes")
        out.append(dict(shape=what, lanes=lanes, lanes_ms=lanes_sweep(
            torch, vals, table, valid, nplanes, want, "commit", what)))
    return out


def commit_pairs(torch, log_t: int) -> dict:
    """The commitment phase alone, on the device tier (kernel B) and then
    on the host C tier, in both modes, with its seconds split
    into the row MSMs and the pairings; the commitments must be equal. A
    first device commit of each mode builds the engine and gives kernel
    B's work in the phase (its wrapper's counters) and its device ms
    (torch.profiler); it is not timed beside them."""
    from torch.profiler import ProfilerActivity, profile

    from zolt_tpu_torch.transcript import Blake2bTranscript
    from zolt_tpu_torch.utils.log import metrics
    from zolt_tpu_torch.zkvm.commitments import commit_and_absorb

    out = {}
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "sum_loop.elf")
        with open(path, "wb") as f:
            f.write(sum_loop_elf(log_t))
        for mode, sound in (("compat", False), ("sound", True)):
            kw = commit_inputs(path, sound)

            def commit(device):
                metrics.reset()
                t0 = time.perf_counter()
                phase = commit_and_absorb(Blake2bTranscript(b"Jolt"),
                                          device=device, **kw)
                torch.cuda.synchronize()
                m = metrics.timings
                return phase.commitments, dict(
                    seconds=time.perf_counter() - t0,
                    rows=m.get("commit_rows", 0.0),
                    pairings=m.get("commit_pairings", 0.0),
                    **{k: v for k, v in m.items() if k.startswith("row_msm")})

            reset_launches()
            with captured_rows() as caught, \
                    launch_events(torch, "zg1_row_msm") as ev, \
                    profile(activities=[ProfilerActivity.CUDA]) as prof:
                first, first_t = commit("cuda")
            _, counts = read_launches()
            work = counts["row_plane_sums"]
            dev_ms = recorded_ms(prof, counts, ("row_plane_sums",),
                                 "commit")
            seen = kernel_events(prof, DEVICE_NAMES["row_plane_sums"])
            say("commit", f"{mode}: kernel B's {len(ev)} launches in the "
                          f"phase by CUDA events {ev} ms (sum "
                          f"{sum(ev):.4f}); torch.profiler recorded "
                          f"{len(seen)} (start µs, device µs) {seen}")
            runs = []
            for tier in ("cuda", None):
                coms, t = commit(tier)
                if coms != first:
                    raise AssertionError(f"{mode} commitments differ "
                                         f"between the tiers")
                runs.append(dict(tier="device" if tier else "host", **t))
            b_ms, b_by = bound(work["bytes"], work["imads"])
            out[mode] = dict(first_device=first_t, pairs=runs, work=work,
                             bound_ms=b_ms, bound_by=b_by,
                             device_ms=dev_ms["row_plane_sums"],
                             device_ms_events=round(sum(ev), 4),
                             launch_ms_events=ev, profiler_events=seen,
                             path_inputs=path_density(torch, caught, mode))
            say("commit", f"{mode} commitments at T = 2^{log_t}: equal on "
                          f"both tiers; first device commit (engine built) "
                          f"{first_t}; kernel B in the phase: {work}, bound "
                          f"{b_ms:.4f} ms by {b_by}, device "
                          f"{ms_text(dev_ms['row_plane_sums'])}")
            for r in runs:
                steps = {k: round(v, 4) for k, v in r.items()
                         if k.startswith("row_msm")}
                say("commit", f"{mode} {r['tier']}: {r['seconds']:.4f} s "
                              f"(row MSMs {r['rows']:.4f} s, pairings "
                              f"{r['pairings']:.4f} s)"
                              + (f"; the device row MSMs' steps {steps}"
                                 if steps else ""))
    return out


def sum_loop_elf(log_t: int) -> bytes:
    """The bench's sum-loop guest (bench.py _sum_loop_trace) at T = 2^log_t."""
    from zolt_tpu_torch.vm import elf as elf_mod
    from zolt_tpu_torch.vm.guest import Asm
    from zolt_tpu_torch.vm.layout import MemoryConfig, MemoryLayout

    lay = MemoryLayout.create(MemoryConfig(program_size=1024))
    a = Asm()
    iters = (1 << log_t) // 4 - 64
    a.li_addr(5, 0x80002000)
    a.addi(1, 0, 0)
    a.li_addr(2, iters)
    a.label("w")
    a.sd(5, 1, 0)
    a.add(1, 1, 2)
    a.addi(2, 2, -1)
    a.bne(2, 0, "w")
    a.halt(lay, provable=True)
    return elf_mod.write_minimal_elf(a.bytes())


def timed_prove(torch, path: str, **kw):
    """prove_jolt(path, **kw), timed: the proof's with-Dory bytes (the
    digests' layout), its seconds, its per-stage seconds and its canonical
    bytes (the layout the verify phase parses)."""
    from zolt_tpu_torch.utils.log import metrics
    from zolt_tpu_torch.zkvm.pipeline import prove_jolt

    metrics.reset()
    t0 = time.perf_counter()
    res = prove_jolt(path, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    proof = res.conv.proof
    return (proof.serialize_with_dory(), wall,
            {k: round(v, 4) for k, v in metrics.timings.items()},
            proof.serialize())


def profiled_prove(torch, path: str, out: str | None):
    """timed_prove(path) under torch.profiler (device time by kernel), and
    under cProfile (host time by function) when `out` is given, which then
    writes out.txt. Returns timed_prove's four values, then the kernels'
    launches and device ms seen on the device by name."""
    import cProfile
    import io
    import pstats

    from torch.profiler import ProfilerActivity, profile

    cp = cProfile.Profile()
    with profile(activities=[ProfilerActivity.CUDA]) as p:
        if out:
            cp.enable()
        blob, wall, stages, canonical = timed_prove(torch, path)
        if out:
            cp.disable()
    rows = p.key_averages()
    busy_us = device_us(rows)
    say("slice", f"the device prove under torch.profiler"
                 f"{' and cProfile' if out else ''}: device busy "
                 f"{busy_us / 1e3:.3f} ms")
    if out:
        host = io.StringIO()
        pstats.Stats(cp, stream=host).sort_stats("cumulative").print_stats(60)
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        with open(out + ".txt", "w") as f:
            f.write(f"profiled device prove (tail 0): {wall:.3f} s {stages}\n"
                    f"device busy {busy_us / 1e3:.3f} ms\n\n")
            f.write(rows.table(sort_by="cuda_time_total", row_limit=25))
            f.write("\n\n" + host.getvalue())
        say("slice", f"profile written to {out}.txt")
    on_dev, dev_ms = device_kernel_counts(rows)
    say("slice", f"the kernels in the profiled prove: launches {on_dev}, "
                 f"device ms {dev_ms}")
    return blob, wall, stages, canonical, on_dev, dev_ms


def counters() -> dict:
    """The wrappers' counter dicts by kernel."""
    from zolt_tpu_torch.curve import device as dev
    from zolt_tpu_torch.field import evals, fold, gruen, inverse
    from zolt_tpu_torch.msm import pippenger, rows_device

    return {"fold": fold.fold_many.counts,
            "product_evals": evals.product_evals.counts,
            "product_evals_any": evals.counts_g,
            "gruen_round": gruen.gruen_round.counts,
            "g1_add": dev.pt_add.counts, "g1_double": dev.pt_double.counts,
            "g1_sum": dev.pt_sum.counts,
            "row_plane_sums": rows_device.row_sums.counts,
            "bucket_accumulate": pippenger.bucket_sums.counts,
            "window_sums": pippenger.window_sums.counts,
            "scalar_digits": pippenger.scalar_digits.counts,
            "pow_fixed": inverse.pow_fixed.counts,
            "batch_inverse": inverse.batch_inverse.counts}


def reset_launches() -> None:
    for c in counters().values():
        c.update(dict.fromkeys(c, 0))


def entry_launches(c: dict) -> dict:
    """Launch counts per kernel entry of the JSON line from a copy of the
    wrappers' counters (a grouped product-evals launch counts for each k it
    carried)."""
    pe = c["product_evals"]
    return {"fold": c["fold"]["launches"],
            "product_evals_k2": pe["launches_k2"],
            "product_evals_k3": pe["launches_k3"],
            "product_evals_any": c["product_evals_any"]["launches"],
            "gruen_round": c["gruen_round"]["launches"],
            "g1_add_double": (c["g1_add"]["launches"]
                              + c["g1_double"]["launches"]),
            "g1_sum": c["g1_sum"]["launches"],
            **{k: c[k]["launches"] for k in ("row_plane_sums",
                                             "bucket_accumulate",
                                             "window_sums", "scalar_digits")},
            "field_inv": (c["pow_fixed"]["launches"]
                          + c["batch_inverse"]["launches"])}


def read_launches() -> tuple[dict, dict]:
    """The wrappers' launch counts per kernel entry of the JSON line, and a
    copy of every wrapper's counters (launches, groups, bytes and IMADs)."""
    c = {k: dict(v) for k, v in counters().items()}
    return entry_launches(c), c


# kernel -> the name torch.profiler shows for it on the device
DEVICE_NAMES = {"fold": "fold_kernel", "product_evals": "product_evals_kernel",
                "product_evals_any": "product_evals_any_kernel",
                "gruen_round": "gruen_round_kernel",
                "reduce_partials": "zfr_reduce_partials",
                "row_plane_sums": "row_msm_kernel",
                "bucket_accumulate": "bucket_kernel",
                "window_sums": "window_kernel",
                "scalar_digits": "digits_kernel"}


def recorded_ms(prof, counts: dict, names, phase: str) -> dict:
    """Device ms by kernel from a profile, for each kernel whose launches
    there the profiler recorded as many times as its wrapper counted them
    (`counts`, as read_launches gives them; kernel C's a launch a pass,
    its "kernels"); None, and a line saying so,
    where it recorded another number: torch.profiler now and then loses
    the first kernel of a profile when it comes from the kernel library
    (PERF.md, "The measurement gap"), so the G1 phases also time each
    launch by CUDA events (launch_events)."""
    on_dev, dev_ms = device_kernel_counts(prof.key_averages())
    out = {}
    for k in names:
        want = counts[k].get("kernels", counts[k]["launches"])
        out[k] = dev_ms[k] if on_dev[k] == want else None
        if out[k] is None:
            say(phase, f"{k}: torch.profiler recorded {on_dev[k]} launches "
                       f"of the {want} its wrapper made: device ms not "
                       f"measured")
    return out


def ms_text(ms: float | None) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def device_kernel_counts(rows) -> tuple[dict, dict]:
    """Launches seen on the device by torch.profiler, and their device
    milliseconds, by kernel name."""
    counts = {k: sum(e.count for e in rows if v in e.key)
              for k, v in DEVICE_NAMES.items()}
    ms = {k: round(device_us([e for e in rows if v in e.key]) / 1e3, 4)
          for k, v in DEVICE_NAMES.items()}
    return counts, ms


@contextlib.contextmanager
def launch_events(torch, entry: str):
    """While open, each call of the kernel library's entry point `entry`
    (a wrapper's one launch) is bracketed by CUDA events on the current
    stream, the stream it launches on. Yields a list that gets each
    launch's device ms, in launch order, when the block ends (after a
    device sync): the kernels' times without torch.profiler."""
    from zolt_tpu_torch import _build

    lib = _build.kernels().lib
    orig = getattr(lib, entry)
    pairs, out = [], []

    def timed(*args):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        rc = orig(*args)
        end.record()
        pairs.append((start, end))
        return rc

    setattr(lib, entry, timed)
    try:
        yield out
    finally:
        setattr(lib, entry, orig)
        torch.cuda.synchronize()
        out.extend(round(a.elapsed_time(b), 4) for a, b in pairs)


@contextlib.contextmanager
def captured_rows():
    """While open, each call of rows_device.row_sums (which DeviceRowMSM
    looks up at call time) appends its inputs (vals, table, valid,
    nplanes) to the list this yields. The wrapper's counters stay the
    ones counters() reads."""
    from zolt_tpu_torch.msm import rows_device

    orig = rows_device.row_sums
    got = []

    def spy(vals, table, valid, nplanes, **kw):
        got.append((vals, table, valid, nplanes))
        return orig(vals, table, valid, nplanes, **kw)

    spy.counts = orig.counts
    rows_device.row_sums = spy
    try:
        yield got
    finally:
        rows_device.row_sums = orig


def kernel_events(prof, name: str) -> list:
    """(start µs after the first, device µs) of each device event of a
    profile whose name holds `name`."""
    from torch.autograd import DeviceType

    evs = sorted((e.time_range.start, e.time_range.elapsed_us())
                 for e in prof.events()
                 if e.device_type == DeviceType.CUDA and name in e.name)
    return [(round(a - evs[0][0], 1), round(d, 1)) for a, d in evs]


# The host-clock stages of the sound prove that the compat prove lacks.
SOUND_STAGES = ("stage5", "stage6", "stage7", "stages8_12", "batch_opening")
BO_RANGE = "zolt_batch_opening"


@contextlib.contextmanager
def batch_opening_counts(torch, ranged: bool = False):
    """While open, zolt_tpu_torch.pcs.batch.prove_batch_opening (which the
    pipeline looks up at call time) adds the wrappers' counter increments
    of each of its calls into the dict this yields: the batch opening
    alone. With `ranged` each call runs inside a torch.profiler
    record_function range BO_RANGE that ends after a device sync."""
    from torch.profiler import record_function

    from zolt_tpu_torch.pcs import batch

    orig = batch.prove_batch_opening
    total = {k: dict.fromkeys(c, 0) for k, c in counters().items()}

    def counted(*a, **kw):
        before = {k: dict(c) for k, c in counters().items()}
        with record_function(BO_RANGE) if ranged else contextlib.nullcontext():
            out = orig(*a, **kw)
            torch.cuda.synchronize()
        for k, c in counters().items():
            for key, v in c.items():
                total[k][key] += v - before[k][key]
        return out

    batch.prove_batch_opening = counted
    try:
        yield total
    finally:
        batch.prove_batch_opening = orig


def device_event_ms(prof, span: str | None = None) -> dict | None:
    """Device ms of a profile's device events (kernels and copies), by
    kernel and in all ("all"); with `span`, only those that started inside
    the host interval of the record_function range of that name (which
    ends after a device sync). The profiler also puts the range itself on
    the device's timeline: it is not work, and is left out. None when
    there are no such events."""
    from torch.autograd import DeviceType

    evs = prof.events()
    dev = [e for e in evs
           if e.device_type == DeviceType.CUDA and e.name != BO_RANGE]
    if span is not None:
        spans = [(e.time_range.start, e.time_range.end) for e in evs
                 if e.name == span]
        dev = [e for e in dev
               if any(a <= e.time_range.start <= b for a, b in spans)]
    if not dev:
        return None
    out = {k: round(sum(e.time_range.elapsed_us() for e in dev
                        if v in e.name) / 1e3, 4)
           for k, v in DEVICE_NAMES.items()}
    out["all"] = round(sum(e.time_range.elapsed_us() for e in dev) / 1e3, 4)
    return out


def path_figures(work: dict, dev_ms: dict | None, phase: str,
                 what: str, names=PROVE_PATH) -> dict:
    """Per kernel entry of the JSON line on a prove's path (the Fr kernels
    and kernel B): launches, groups, bytes, IMADs and the bound of that
    work (the wrappers' counters over a run), beside
    the device ms the profiler saw (None: not measured, or no launch). One
    grouped launch can carry k = 2 and k = 3 groups, so the product evals'
    device ms is that of both k's launches, "device_ms_k2_k3", on each k's
    entry that launched. Printed one line an entry."""
    out = {}
    for name in names:
        kern, _, k = name.partition("_k")
        w = work[kern]
        s = f"_k{k}" if k else ""
        c = dict(launches=w["launches" + s], groups=w.get("groups" + s),
                 bytes=w["bytes" + s], imads=w["imads" + s])
        b_ms, b_by = bound(c["bytes"], c["imads"])
        d = dev_ms.get(kern) if dev_ms and c["launches"] else None
        out[name] = dict(c, bound_ms=b_ms, bound_by=b_by,
                         **{"device_ms" + ("_k2_k3" if k else ""): d})
        # the device ms is this entry's alone unless the other k launched
        alone = not (k and w["launches_k" + ("3" if k == "2" else "2")])
        dtxt = ("not measured" if d is None else f"{d:.4f} ms" if alone
                else f"{d:.4f} ms (k = 2 and 3)")
        share = f", share {b_ms / d * 100:.1f} %" if d and alone else ""
        gtxt = f"{c['groups']} groups, " if c["groups"] is not None else ""
        say(phase, f"{name} in {what}: {c['launches']} launches, {gtxt}"
                     f"{c['bytes']} bytes, {c['imads']} IMADs, bound "
                     f"{b_ms:.4f} ms by {b_by}, device {dtxt}{share}")
    return out


def run_sound(torch, log_t: int,
              profile: str | None) -> tuple[dict, dict, bytes]:
    """The sound prove of the sum-loop guest at T = 2^log_t: with
    prove_jolt's defaults at tail 0 (every round of stages 1-4 and of the
    batch opening on the GPU), timed, with its peak device memory and the
    wrappers' counts for the whole prove and for the batch opening alone;
    at T = 2^16 its bytes must equal the JAX sound digest. Every kernel
    must have launched in it, and the fold and the k = 2 product evals in
    its batch opening, at no more than 16 groups a launch. The host tier
    proves the guest at T = 2^CLI_LOG_T with the joint proof, as the CLI
    does: its bytes must equal the JAX CLI's digest, and it may launch no
    kernel. With --profile, one more tail-0 sound prove under
    torch.profiler and cProfile. Returns the launches per JSON entry, the
    path figures and the tail-0 proof's canonical bytes."""
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "sum_loop.elf")
        with open(path, "wb") as f:
            f.write(sum_loop_elf(log_t))
        os.environ["ZOLT_TPU_DEVICE_TAIL"] = "0"
        try:
            reset_launches()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            with batch_opening_counts(torch) as bo, \
                    launch_events(torch, "zg1_row_msm") as b_ev:
                dev, dev_s, stages, canonical = timed_prove(torch, path,
                                                            sound=True)
            peak = torch.cuda.max_memory_allocated()
            launches, work = read_launches()
            say("sound", f"kernel B in the sound prove by CUDA events: "
                         f"{b_ev} ms, sum {sum(b_ev):.4f}")
            say("sound", f"sound device prove (defaults: backend 'device', "
                         f"'cuda'), tail 0: {dev_s:.3f} s {stages}; peak "
                         f"device memory {peak} bytes "
                         f"({peak / 2 ** 20:.1f} MiB)")
            say("sound", "the sound stages: " + ", ".join(
                f"{k} {stages.get(k, 0):.4f} s" for k in SOUND_STAGES))
            say("sound", f"launches in the sound prove: {launches}; "
                         f"counters: {work}; in its batch opening: {bo}")
            prof = None
            if profile:
                prof = profiled_sound_prove(torch, path, profile + "_sound")
        finally:
            del os.environ["ZOLT_TPU_DEVICE_TAIL"]
        # the host tier at the CLI's size and flags (the joint proof), so
        # that its bytes meet the JAX CLI's digest
        small = os.path.join(td, f"sum_loop_t{CLI_LOG_T}.elf")
        with open(small, "wb") as f:
            f.write(sum_loop_elf(CLI_LOG_T))
        reset_launches()
        host, host_s, host_stages, _ = timed_prove(
            torch, small, sound=True, with_joint_proof=True, backend="host")
        host_launches, _ = read_launches()
        host_digest = hashlib.sha256(host).hexdigest()
        say("sound", f"sound host-tier prove at T = 2^{CLI_LOG_T} (with the "
                     f"joint proof, as the CLI): {host_s:.3f} s "
                     f"{host_stages}; launches {host_launches}")

    idle = [k for k in PROVE_PATH if launches[k] <= 0]
    if idle:
        raise AssertionError(f"kernels not launched in the sound prove: {idle}")
    if any(host_launches.values()):
        raise AssertionError(f"the host-tier sound prove launched kernels: "
                             f"{host_launches}")
    fb, pb = bo["fold"], bo["product_evals"]
    if not (fb["launches"] and pb["launches_k2"]):
        raise AssertionError(f"the batch opening launched no fold or no k = 2 "
                             f"product evals: {bo}")
    if (fb["groups"] > 16 * fb["launches"]
            or pb["groups_k2"] + pb["groups_k3"] > 16 * pb["launches"]):
        raise AssertionError(f"more than 16 groups a launch: {bo}")
    figures = {"prove": path_figures(work, prof and prof["dev_ms"], "sound",
                                     "the sound prove"),
               "batch_opening": path_figures(bo, prof and prof["bo_ms"],
                                             "sound", "its batch opening")}
    figures["prove"]["row_plane_sums"]["device_ms_events"] = round(sum(b_ev),
                                                                   4)
    figures.update(seconds=dev_s, host_seconds=host_s, stages=stages,
                   peak_bytes=peak, busy_ms=prof and prof["busy_ms"],
                   bo_launches=entry_launches(bo))
    if host_digest != JAX_CLI_SOUND_DIGEST_T12:
        raise AssertionError(f"the host tier's sound proof sha256 "
                             f"{host_digest} != {JAX_CLI_SOUND_DIGEST_T12}")
    digest = hashlib.sha256(dev).hexdigest()
    if log_t == 16:
        if digest != JAX_SOUND_DIGEST_T16:
            raise AssertionError(f"sound proof sha256 {digest} != JAX sound "
                                 f"digest {JAX_SOUND_DIGEST_T16}")
        say("sound", f"{len(dev)} sound proof bytes; sha256 {digest} equals "
                     f"the JAX sound digest; the host tier's at "
                     f"T = 2^{CLI_LOG_T} equal the JAX CLI's")
    else:
        say("sound", f"{len(dev)} sound proof bytes; sha256 {digest} (no JAX "
                     f"digest for T = 2^{log_t}); the host tier's at "
                     f"T = 2^{CLI_LOG_T} equal the JAX CLI's")
    return launches, figures, canonical


def profiled_sound_prove(torch, path: str, out: str) -> dict:
    """One more tail-0 sound prove under torch.profiler and cProfile, its
    batch opening inside a record_function range; writes out.txt. Returns
    the device busy ms, the device ms by kernel, and those of the batch
    opening alone (None where the profiler could not attribute them)."""
    import cProfile
    import io
    import pstats

    from torch.profiler import ProfilerActivity, profile

    cp = cProfile.Profile()
    with batch_opening_counts(torch, ranged=True):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as p:
            cp.enable()
            _, wall, stages, _ = timed_prove(torch, path, sound=True)
            cp.disable()
    rows = p.key_averages()
    try:
        dev_ms = device_event_ms(p) or {}
        bo_ms = device_event_ms(p, BO_RANGE)
    except Exception as e:          # a measurement, not a check
        say("sound", f"device times not measured: {e!r}")
        dev_ms, bo_ms = {}, None
    busy = dev_ms.get("all")
    share = (f"{busy:.3f} ms ({busy / 1e3 / wall * 100:.3f} % of the wall "
             f"clock)" if busy else "not measured")
    say("sound", f"profiled sound prove (tail 0, under torch.profiler and "
                 f"cProfile): {wall:.3f} s, device busy {share}; device ms "
                 f"by kernel {dev_ms}; the batch opening's "
                 f"{bo_ms if bo_ms else 'not measured'}")
    host = io.StringIO()
    pstats.Stats(cp, stream=host).sort_stats("cumulative").print_stats(60)
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out + ".txt", "w") as f:
        f.write(f"profiled sound prove (tail 0): {wall:.3f} s {stages}\n"
                f"device busy {share}\n\n")
        f.write(rows.table(sort_by="cuda_time_total", row_limit=25))
        f.write("\n\n" + host.getvalue())
    say("sound", f"profile written to {out}.txt")
    return {"busy_ms": busy, "dev_ms": dev_ms, "bo_ms": bo_ms}


def run_slice(torch, log_t: int,
              profile: str | None) -> tuple[dict, dict, bytes]:
    """The tail-0 device prove under torch.profiler, the device prove at
    the default tail, and the host tier's pair at T = 2^CLI_LOG_T; returns
    the launches per JSON entry, the path figures per kernel (launches,
    bound over the counted work, device ms, and the small pair's seconds
    and canonical bytes under "small") and the tail-0 proof's canonical
    bytes."""
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "sum_loop.elf")
        with open(path, "wb") as f:
            f.write(sum_loop_elf(log_t))

        os.environ["ZOLT_TPU_DEVICE_TAIL"] = "0"
        reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with launch_events(torch, "zg1_row_msm") as b_ev:
            dev, dev_s, dev_stages, canonical, on_dev, dev_ms = \
                profiled_prove(torch, path, profile)
        peak = torch.cuda.max_memory_allocated()
        launches, work = read_launches()
        say("slice", f"kernel B in the device prove by CUDA events: {b_ev} "
                     f"ms, sum {sum(b_ev):.4f}")
        say("slice", f"device prove (defaults: backend 'device', 'cuda'), "
                     f"tail 0, under torch.profiler: {dev_s:.3f} s "
                     f"{dev_stages}; peak device memory {peak} bytes "
                     f"({peak / 2 ** 20:.1f} MiB)")
        say("slice", f"launches on the main path: {launches}; counters: "
                     f"{work}")
        if on_dev["reduce_partials"]:
            raise AssertionError("a zfr_reduce_partials pass ran on the path")
        for k in ("fold", "product_evals", "product_evals_any",
                  "gruen_round", "row_plane_sums"):
            if on_dev[k] != work[k]["launches"]:
                raise AssertionError(
                    f"{k} launches: the profiler saw {on_dev[k]}, the "
                    f"wrapper counted {work[k]['launches']}")
        # every product engine folds each group it evaluated once (its
        # last bind flushed before its finals); a fold from an outer-round
        # engine would add groups
        pe = work["product_evals"]
        if work["fold"]["groups"] != pe["groups_k2"] + pe["groups_k3"]:
            raise AssertionError(
                f"the fold took {work['fold']['groups']} groups, the product "
                f"engines evaluated {pe['groups_k2'] + pe['groups_k3']}")
        # at T = 2^16: fold 3 x 15 rounds + flushes (<= 52), Gruen 17 + 16
        if log_t >= 4 and (launches["fold"] > 3 * log_t + 4
                           or launches["gruen_round"] > 2 * log_t + 3):
            raise AssertionError(f"more launches than one a round: "
                                 f"{launches}")
        path_stats = path_figures(work, dev_ms, "slice", "the path")
        path_stats["peak_bytes"] = peak
        path_stats["seconds"] = dev_s
        path_stats["row_plane_sums"]["device_ms_events"] = round(sum(b_ev), 4)
        del os.environ["ZOLT_TPU_DEVICE_TAIL"]
        dflt, dflt_s, dflt_stages, _ = timed_prove(torch, path)
        say("slice", f"device prove, default tail (8192): {dflt_s:.3f} s "
                     f"{dflt_stages}")
    path_stats["small"] = host_pair(torch)

    digest = hashlib.sha256(dev).hexdigest()
    if dflt != dev:
        raise AssertionError("default-tail device proof differs from tail 0's")
    if log_t == 16:
        if digest != JAX_DIGEST_T16:
            raise AssertionError(f"proof sha256 {digest} != JAX digest "
                                 f"{JAX_DIGEST_T16}")
        say("slice", f"{len(dev)} proof bytes equal at both tails; sha256 "
                     f"{digest} equals the JAX digest")
    else:
        say("slice", f"{len(dev)} proof bytes equal at both tails; sha256 "
                     f"{digest} (no JAX digest for T = 2^{log_t})")
    idle = [k for k in PROVE_PATH if launches[k] <= 0]
    if idle:
        raise AssertionError(f"kernels not launched on the main path: {idle}")
    return launches, path_stats, canonical


def host_pair(torch) -> dict:
    """The host tier (backend="host") at T = 2^CLI_LOG_T beside the device
    prove at tail 0, compat: equal bytes, and no kernel launched on the
    host tier. Returns both proves' seconds and the canonical bytes."""
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, f"sum_loop_t{CLI_LOG_T}.elf")
        with open(path, "wb") as f:
            f.write(sum_loop_elf(CLI_LOG_T))
        os.environ["ZOLT_TPU_DEVICE_TAIL"] = "0"
        try:
            dev, dev_s, _, canonical = timed_prove(torch, path)
        finally:
            del os.environ["ZOLT_TPU_DEVICE_TAIL"]
        reset_launches()
        host, host_s, host_stages, _ = timed_prove(torch, path,
                                                   backend="host")
        host_launches, _ = read_launches()
    if any(host_launches.values()):
        raise AssertionError(f"the host-tier prove launched kernels: "
                             f"{host_launches}")
    if dev != host:
        raise AssertionError(f"the device proof at T = 2^{CLI_LOG_T} differs "
                             f"from the host tier's")
    say("slice", f"host-tier prove at T = 2^{CLI_LOG_T}: {host_s:.3f} s "
                 f"{host_stages}, no launch; {len(host)} bytes equal to the "
                 f"tail-0 device prove's ({dev_s:.3f} s)")
    return {"seconds": dev_s, "host_seconds": host_s, "canonical": canonical}


def run_verify(log_t: int, compat: bytes, sound: bytes) -> dict:
    """The port's verifier on the port's own T = 2^log_t proofs (their
    canonical bytes through deserialize_jolt_proof): the tail-0 sound proof
    under the strict default and the compat proof under
    allow_reference_compat, each warm (the Dory SRS the prove cached) and
    cold (the SRS cache emptied, so the sound verify derives its SRS on the
    host; the cache is restored afterwards), and the sound proof with a
    stage-1 round poly +1, which must raise VerifyError. Returns the
    seconds of each."""
    from zolt_tpu_torch.pcs import dory
    from zolt_tpu_torch.zkvm.jolt_deserialize import deserialize_jolt_proof
    from zolt_tpu_torch.zkvm.jolt_verifier import VerifyError, verify_jolt

    secs = {}
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "sum_loop.elf")
        with open(path, "wb") as f:
            f.write(sum_loop_elf(log_t))

        def verify(name: str, blob: bytes, **kw) -> None:
            report = {}
            t0 = time.perf_counter()
            ok = verify_jolt(deserialize_jolt_proof(blob), path,
                             report=report, **kw)
            secs[name] = round(time.perf_counter() - t0, 4)
            if ok is not True:
                raise AssertionError(f"verify_jolt returned {ok!r}")
            say("verify", f"{name}: {len(blob)} canonical bytes accepted in "
                          f"{secs[name]} s; report {report}")

        verify("sound_warm", sound)
        verify("compat_warm", compat, allow_reference_compat=True)
        cached = dict(dory._SETUP_CACHE)
        try:
            for name, blob, kw in (("sound_cold", sound, {}),
                                   ("compat_cold", compat,
                                    {"allow_reference_compat": True})):
                dory._SETUP_CACHE.clear()
                verify(name, blob, **kw)
        finally:
            dory._SETUP_CACHE.clear()
            dory._SETUP_CACHE.update(cached)

        tampered = deserialize_jolt_proof(sound)
        tampered.stage1_sumcheck.compressed_polys[3][0] += 1
        t0 = time.perf_counter()
        try:
            verify_jolt(tampered, path)
        except VerifyError as e:
            secs["tampered"] = round(time.perf_counter() - t0, 4)
            say("verify", f"sound proof with a stage-1 round poly +1: "
                          f"VerifyError in {secs['tampered']} s: {e}")
        else:
            raise AssertionError("the verifier accepted a sound proof with a "
                                 "stage-1 round poly +1")
    return secs


CLI_LOG_T = 12
# A byte of the first value of stage 1's first round poly in the ZOLT v1
# container: past the magic, version, 11 commitment blocks and the R1CS
# placeholder (1000 bytes), has-stages, log_t, log_k, stage 1's round
# count and that poly's length
CLI_STAGE1_BYTE = 1033


def run_cli(torch, root: str) -> dict:
    """`zolt_tpu_torch.__main__.main(["prove", elf, "--jolt-format",
    "--sound", "-o", file])` in this process with the default backend (the
    GPU) and the host tail at 0, on the sum-loop guest at T = 2^CLI_LOG_T:
    every kernel of PROVE_PATH must launch, and the file's sha256 must equal
    the JAX CLI's digest. Then, each in a process of its own,
    `python3 -m zolt_tpu_torch verify file --elf elf` must exit 0 with
    PASSED, the same with one byte flipped must exit 1 with FAILED, and
    `python3 -m zolt_tpu_torch info` must name the card. The same for the
    internal and legacy containers (CLI_CONTAINERS; see the module
    docstring, phase 7). Returns the launches per JSON entry, those of
    each container's prove, and the seconds of each command."""
    from zolt_tpu_torch.__main__ import main as cli_main

    secs = {}
    with tempfile.TemporaryDirectory() as td:
        elf = os.path.join(td, f"sum_loop_t{CLI_LOG_T}.elf")
        with open(elf, "wb") as f:
            f.write(sum_loop_elf(CLI_LOG_T))
        out = os.path.join(td, "proof.bin")
        os.environ["ZOLT_TPU_DEVICE_TAIL"] = "0"
        try:
            reset_launches()
            t0 = time.perf_counter()
            rc = cli_main(["prove", elf, "--jolt-format", "--sound", "-o",
                           out])
            torch.cuda.synchronize()
            secs["prove"] = round(time.perf_counter() - t0, 4)
            launches, _ = read_launches()
        finally:
            del os.environ["ZOLT_TPU_DEVICE_TAIL"]
        if rc != 0:
            raise AssertionError(f"the CLI's prove exited {rc}")
        say("cli", f"prove --jolt-format --sound (default backend), "
                   f"T = 2^{CLI_LOG_T}, tail 0: {secs['prove']} s; launches "
                   f"{launches}")
        idle = [k for k in PROVE_PATH if launches[k] <= 0]
        if idle:
            raise AssertionError(f"kernels not launched by the CLI's prove: "
                                 f"{idle}")
        with open(out, "rb") as f:
            blob = f.read()
        digest = hashlib.sha256(blob).hexdigest()
        if digest != JAX_CLI_SOUND_DIGEST_T12:
            raise AssertionError(f"the CLI's proof sha256 {digest} != "
                                 f"{JAX_CLI_SOUND_DIGEST_T12}")
        say("cli", f"{len(blob)} bytes; sha256 equals the JAX CLI's digest")
        bad = os.path.join(td, "flipped.bin")
        with open(bad, "wb") as f:
            f.write(blob[:24] + bytes([blob[24] ^ 1]) + blob[25:])

        jobs = []

        def cli(name: str, *argv: str, rc: int, want: str,
                then: tuple = (), then_want: str = "") -> None:
            """`python3 -m zolt_tpu_torch *argv` in a subprocess; with
            `then`, that command's main(argv) and then main(then) in one
            subprocess (one interpreter and torch import for both). Queued
            here; finish_cli() runs them all side by side, after the
            in-process proves, and checks each."""
            cmd = [sys.executable, "-m", "zolt_tpu_torch", *argv]
            if then:
                cmd = [sys.executable, "-c",
                       "import sys\n"
                       "from zolt_tpu_torch.__main__ import main\n"
                       f"sys.exit(main({list(argv)!r}) or "
                       f"main({list(then)!r}))\n"]
            jobs.append((name, cmd, rc, want, then_want))

        def finish_cli() -> None:
            from concurrent.futures import ThreadPoolExecutor

            procs = []

            def run(cmd: list) -> tuple:
                t0 = time.perf_counter()
                proc = subprocess.Popen(cmd, cwd=root, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True)
                procs.append(proc)
                stdout, stderr = proc.communicate(timeout=600)
                return proc.returncode, stdout, stderr, time.perf_counter() - t0

            try:
                with ThreadPoolExecutor(len(jobs)) as pool:
                    done = list(pool.map(run, [job[1] for job in jobs]))
            finally:
                for proc in procs:
                    if proc.poll() is None:
                        proc.kill()
                        proc.wait()
            for (name, _, rc, want, then_want), (got, stdout, stderr, t) in \
                    zip(jobs, done):
                secs[name] = round(t, 4)
                said = stdout.strip()
                if got != rc or want not in said or then_want not in said:
                    raise AssertionError(
                        f"python3 -m zolt_tpu_torch {name}: exit {got}, "
                        f"stdout {said!r}, stderr {stderr[-2000:]!r}")
                say("cli", f"python3 -m zolt_tpu_torch {name}: exit {got} in "
                           f"{secs[name]} s (side by side with the others): "
                           f"{said}")

        cli("verify", "verify", out, "--elf", elf, rc=0, want="PASSED")
        cli("verify_flipped", "verify", bad, "--elf", elf, rc=1,
            want="FAILED")
        cli("info", "info", rc=0, want=torch.cuda.get_device_name(0))

        # the internal and legacy containers: in-process proves on the card
        # (tail 0), each file's sha256 pinned; verify and then stats of each
        # in one subprocess, and the internal file with a stage-1 byte
        # flipped in another
        container_launches = {}
        for name, (flags, want) in CLI_CONTAINERS.items():
            f_out = os.path.join(td, f"{name}.bin")
            os.environ["ZOLT_TPU_DEVICE_TAIL"] = "0"
            try:
                reset_launches()
                t0 = time.perf_counter()
                rc = cli_main(["prove", elf, *flags, "-o", f_out])
                torch.cuda.synchronize()
                secs[f"prove_{name}"] = round(time.perf_counter() - t0, 4)
                container_launches[name], _ = read_launches()
            finally:
                del os.environ["ZOLT_TPU_DEVICE_TAIL"]
            with open(f_out, "rb") as f:
                digest = hashlib.sha256(f.read()).hexdigest()
            if rc != 0 or digest != want:
                raise AssertionError(f"the CLI's prove {flags}: exit {rc}, "
                                     f"sha256 {digest} != {want}")
            say("cli", f"prove {' '.join(flags) or '(internal)'} (default "
                       f"backend), T = 2^{CLI_LOG_T}, tail 0: "
                       f"{secs[f'prove_{name}']} s, sha256 equals the JAX "
                       f"CLI's; launches {container_launches[name]}")
            ran = [k for k, v in container_launches[name].items() if v]
            want_path = INTERNAL_PATH if name == "internal" else LEGACY_PATH
            if not set(want_path) <= set(ran):
                raise AssertionError(f"the CLI's prove {flags} launched "
                                     f"{ran}, not all of {want_path}")
            cli(f"verify_stats_{name}", "verify", f_out, rc=0,
                want="PASSED", then=("stats", f_out), then_want="format: ")
        with open(os.path.join(td, "internal.bin"), "rb") as f:
            blob = f.read()
        bad = os.path.join(td, "internal_flipped.bin")
        with open(bad, "wb") as f:       # the first stage-1 round poly
            f.write(blob[:CLI_STAGE1_BYTE] + bytes([blob[CLI_STAGE1_BYTE] ^ 1])
                    + blob[CLI_STAGE1_BYTE + 1:])
        cli("verify_internal_flipped", "verify", bad, rc=1, want="FAILED")
        finish_cli()
    return {"launches": launches, "seconds": secs,
            "containers": container_launches}


def run_legacy(torch, log_t: int) -> dict:
    """The legacy prover: prove_program(emu, log_k=LEGACY_LOG_K) of the
    sum-loop guest at T = 2^log_t on the card (device="cuda") with the
    host tail at 0, so every round of its six stages runs there; timed,
    by stage, with its peak device memory, under torch.profiler (device
    ms by kernel). Its serialize() sha256 must equal JAX_LEGACY_DIGEST_T16
    at T = 2^16, every kernel of LEGACY_PATH must launch, verify must pass
    and a copy with a stage-1 round poly +1 fail. Returns the launches,
    the path figures and the seconds."""
    from torch.profiler import ProfilerActivity, profile

    from zolt_tpu_torch import serialization
    from zolt_tpu_torch.r1cs import constraints as rc
    from zolt_tpu_torch.utils.log import metrics
    from zolt_tpu_torch.vm import run_elf
    from zolt_tpu_torch.zkvm import prove_program, verify
    from zolt_tpu_torch.zkvm.stages import _ceil_log2

    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "sum_loop.elf")
        with open(path, "wb") as f:
            f.write(sum_loop_elf(log_t))
        emu = run_elf(path)
    os.environ["ZOLT_TPU_DEVICE_TAIL"] = "0"
    try:
        reset_launches()
        metrics.reset()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            proof, padded = prove_program(emu, log_k=LEGACY_LOG_K,
                                          device="cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        del os.environ["ZOLT_TPU_DEVICE_TAIL"]
    peak = torch.cuda.max_memory_allocated()
    stages = {k: round(v, 4) for k, v in metrics.timings.items()}
    launches, work = read_launches()
    blob = serialization.serialize(proof)
    digest = hashlib.sha256(blob).hexdigest()
    say("legacy", f"prove_program (log_k {LEGACY_LOG_K}, 'cuda', tail 0, "
                  f"under torch.profiler) at T = 2^{log_t}: {wall:.3f} s "
                  f"{stages}; peak device memory {peak} bytes "
                  f"({peak / 2 ** 20:.1f} MiB); launches {launches}")
    idle = [k for k in LEGACY_PATH if launches[k] <= 0]
    if idle:
        raise AssertionError(f"kernels not launched by the legacy prove: "
                             f"{idle}")
    dev_ms = recorded_ms(prof, work, ("fold", "product_evals"), "legacy")
    figures = path_figures(work, dev_ms, "legacy", "the legacy prove",
                           LEGACY_PATH)
    # stage 1's product evals: its first launch (3 x 2^21 entries) and its
    # 21 rounds, the first product-evals launches of the prove
    ev = kernel_events(prof, DEVICE_NAMES["product_evals"])
    s1 = _ceil_log2(len(padded) * rc.NUM_CONSTRAINTS)
    if len(ev) >= s1:
        first, stage1 = ev[0][1] / 1e3, sum(d for _, d in ev[:s1]) / 1e3
        say("legacy", f"stage 1's product evals (k = 3, degree 3): the first "
                      f"launch, 3 x 2^{s1} entries, {first:.4f} ms; its "
                      f"{s1} rounds {stage1:.4f} ms on the device")
        figures["stage1_product_evals_ms"] = dict(first=first, rounds=stage1)
    if log_t == 16:
        if digest != JAX_LEGACY_DIGEST_T16:
            raise AssertionError(f"legacy proof sha256 {digest} != "
                                 f"{JAX_LEGACY_DIGEST_T16}")
        say("legacy", f"{len(blob)} bytes; sha256 equals the JAX legacy "
                      f"digest")
    else:
        say("legacy", f"{len(blob)} bytes; sha256 {digest} (no JAX digest "
                      f"for T = 2^{log_t})")
    ncv = _ceil_log2(len(padded) * rc.NUM_CONSTRAINTS)
    t0 = time.perf_counter()
    if verify(proof, ncv) is not True:
        raise AssertionError("the legacy verifier did not accept")
    secs = dict(prove=wall, verify=time.perf_counter() - t0)
    proof.stage_proofs[0].round_polys[3][0] += 1   # test_multistage.py:82
    try:
        verify(proof, ncv)
    except AssertionError as e:
        say("legacy", f"verify passed in {secs['verify']:.3f} s; a stage-1 "
                      f"round poly +1 fails: {e}")
    else:
        raise AssertionError("the legacy verifier accepted a stage-1 round "
                             "poly +1")
    return dict(launches=launches, figures=figures, seconds=secs,
                stages=stages, peak_bytes=peak)


# The opening's SRS: the largest padded poly of the T = 2^16 guest is its
# memory poly, 130561 RAM post-values padded to 2^17 (the rd values: 2^16)
OPENING_SRS = 1 << 17


_OPENING_INPUTS: dict = {}


def opening_inputs(log_t: int):
    """(emu, padded trace, image) of the sum-loop guest at T = 2^log_t, as
    prove_internal takes them; made once a run (the g1 phase's kernel C
    checks and the internal phase share them)."""
    from zolt_tpu_torch.vm import elf as elf_mod
    from zolt_tpu_torch.vm import pad_with_noop, run_elf

    if log_t not in _OPENING_INPUTS:
        with tempfile.TemporaryDirectory() as td:
            path = os.path.join(td, "sum_loop.elf")
            with open(path, "wb") as f:
                f.write(sum_loop_elf(log_t))
            image = bytes(elf_mod.load_file(path).flat_image()[1])
            emu = run_elf(path)
        _OPENING_INPUTS[log_t] = (emu, pad_with_noop(list(emu.trace)), image)
    return _OPENING_INPUTS[log_t]


@contextlib.contextmanager
def captured_segs():
    """While open, each call of pippenger.bucket_sums (which msm_digits
    looks up at call time) appends its bucket offsets to the list this
    yields. The wrapper's counters stay the ones counters() reads."""
    from zolt_tpu_torch.msm import pippenger

    orig = pippenger.bucket_sums
    got = []

    def spy(ent, seg, pts, valid):
        got.append(seg)
        return orig(ent, seg, pts, valid)

    spy.counts = orig.counts
    pippenger.bucket_sums = spy
    try:
        yield got
    finally:
        pippenger.bucket_sums = orig


def internal_polys(emu, padded, image: bytes) -> list:
    """The three committed polys as prove_internal makes them (bytecode,
    RAM post-values, rd values), zero-padded to powers of two."""
    from zolt_tpu_torch.zkvm.internal import _next_pow2

    def pad(vals):
        return list(vals) + [0] * (_next_pow2(max(len(vals), 2)) - len(vals))

    return [pad(list(image)), pad([a.post_value for a in emu.ram.trace]),
            pad([s.rd_value for s in padded])]


def run_internal(torch, log_t: int, kzg) -> dict:
    """The internal (ZOLT v1) prover on the card at T = 2^log_t, the host
    tail at 0: prove_internal with the CLI's defaults (log_k 16,
    srs_degree 1280), its sha256 equal to JAX_INTERNAL_DIGEST_T16 at
    T = 2^16, verify_internal passing, every kernel of INTERNAL_PATH
    launched; then with_openings=True at srs_degree OPENING_SRS: the three
    commitments equal to the native C MSM's, verify_internal passing, and
    a copy whose first opened evaluation is one higher failing with the
    pairing check. Each prove timed by stage, under torch.profiler, with
    C, D and E also timed by CUDA events. The opening's SRS, passed as
    prove_internal(srs=), is the first OPENING_SRS powers of `kzg`, the g1
    phase's 2^18 (the same τ: what insecure_setup(OPENING_SRS) gives,
    without its 5-36 s on the host; its last power is checked against
    τ^(OPENING_SRS-1)·G). Returns, for "prove" and "opening", the
    launches, the path figures and the seconds."""
    from torch.profiler import ProfilerActivity, profile

    from zolt_tpu_torch.curve import host as G1
    from zolt_tpu_torch.field.params import FR
    from zolt_tpu_torch.native import g1_msm_native
    from zolt_tpu_torch.pcs.hyperkzg import HyperKZGBatchProof
    from zolt_tpu_torch.pcs.srs import INSECURE_TAU, KZGSRS, insecure_setup
    from zolt_tpu_torch.utils.log import metrics
    from zolt_tpu_torch.zkvm import internal

    emu, padded, image = opening_inputs(log_t)
    opening_srs = KZGSRS(powers_g1=kzg.powers_g1[:OPENING_SRS],
                         tau_g2=kzg.tau_g2, g1=kzg.g1, g2=kzg.g2)
    last = G1.scalar_mul(G1.G1_GEN, pow(INSECURE_TAU, OPENING_SRS - 1,
                                           FR.p))
    if opening_srs.powers_g1[-1] != last:
        raise AssertionError("the g1 phase's SRS is not insecure_setup's")
    out = {}
    for name, srs_degree in (("prove", 1280), ("opening", OPENING_SRS)):
        t0 = time.perf_counter()
        srs = (insecure_setup(srs_degree) if name == "prove"
               else opening_srs)
        setup_s = time.perf_counter() - t0
        os.environ["ZOLT_TPU_DEVICE_TAIL"] = "0"
        try:
            reset_launches()
            metrics.reset()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            with g1_events(torch) as events, captured_segs() as segs, \
                    profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                proof = internal.prove_internal(
                    emu, padded, image, log_k=16, srs_degree=srs_degree,
                    with_openings=name == "opening", device="cuda", srs=srs)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        finally:
            del os.environ["ZOLT_TPU_DEVICE_TAIL"]
        peak = torch.cuda.max_memory_allocated()
        stages = {k: round(v, 4) for k, v in metrics.timings.items()}
        launches, work = read_launches()
        made = (f"its SRS made in {setup_s:.3f} s before" if name == "prove"
                else f"its SRS the g1 phase's first {srs_degree} powers")
        say("internal", f"prove_internal ({name}: srs_degree {srs_degree}, "
                        f"{made}; 'cuda', "
                        f"tail 0, under torch.profiler) at T = 2^{log_t}: "
                        f"{wall:.3f} s {stages}; peak device memory {peak} "
                        f"bytes ({peak / 2 ** 20:.1f} MiB); launches "
                        f"{launches}")
        want = INTERNAL_PATH if name == "prove" else KZG_PATH
        idle = [k for k in want if launches[k] <= 0]
        if idle:
            raise AssertionError(f"kernels not launched by the internal "
                                 f"prove ({name}): {idle}")
        dev_ms = recorded_ms(prof, work, ("fold", "product_evals"),
                             "internal")
        figures = path_figures(work, dev_ms, "internal",
                               f"the internal prove ({name})",
                               ("fold", "product_evals_k3"))
        figures.update(g1_path_figures(prof, work, events, "internal",
                                       f"the internal prove ({name})"))
        c_launches = [dict(ms=ms, largest_bucket=int((g[1:] - g[:-1]).max()),
                           entries=int(g[-1]))
                      for ms, g in zip(events["bucket_accumulate"], segs)]
        figures["bucket_accumulate"]["each_launch"] = c_launches
        say("internal", f"bucket_accumulate in the internal prove ({name}), "
                        f"each launch by CUDA events beside its largest "
                        f"bucket and entries: "
                        f"{[tuple(c.values()) for c in c_launches]}")
        if name == "opening":
            say_prior("internal", "bucket_accumulate_opening",
                      "on the internal prove with its opening",
                      figures["bucket_accumulate"]["device_ms"])
        blob = proof.serialize()
        digest = hashlib.sha256(blob).hexdigest()
        if name == "prove":
            if log_t == 16 and digest != JAX_INTERNAL_DIGEST_T16:
                raise AssertionError(f"internal proof sha256 {digest} != "
                                     f"{JAX_INTERNAL_DIGEST_T16}")
            say("internal", f"{len(blob)} bytes; sha256 {digest}"
                            + (" equals the JAX internal digest"
                               if log_t == 16 else ""))
        else:
            polys = internal_polys(emu, padded, image)
            powers = opening_srs.powers_g1
            native = [None if not any(p) else
                      g1_msm_native(powers[: len(p)], p) for p in polys]
            got = [proof.bc_commitment, proof.mem_commitment,
                   proof.reg_commitment]
            if got != native:
                raise AssertionError("the internal prove's commitments "
                                     "differ from the native C MSM's")
            say("internal", "the opening prove's three commitments equal "
                            "the native C MSM's")
        t0 = time.perf_counter()
        if internal.verify_internal(proof) is not True:
            raise AssertionError(f"verify_internal did not accept ({name})")
        secs = dict(prove=wall, verify=time.perf_counter() - t0,
                    setup=setup_s)
        say("internal", f"verify_internal ({name}) passed in "
                        f"{secs['verify']:.3f} s")
        if name == "opening":
            bo = proof.kzg_batch_opening
            proof.kzg_batch_opening = HyperKZGBatchProof(
                evaluations=[(bo.evaluations[0] + 1)] + bo.evaluations[1:],
                proof=bo.proof)
            try:
                internal.verify_internal(proof)
            except internal.InternalVerificationError as e:
                if "kzg batch opening pairing check failed" not in str(e):
                    raise
                say("internal", f"the opening with evaluations[0] + 1 "
                                f"fails: {e}")
            else:
                raise AssertionError("verify_internal accepted a tampered "
                                     "batch opening")
        out[name] = dict(launches=launches, figures=figures, seconds=secs,
                         stages=stages, peak_bytes=peak)
    return out


# The mesh phase: MESH_SHARDS shards on cuda:0, so the shards' kernels, the
# cross-shard sums, the gather of their prefixes and kernel A's fold all
# run on the one card; the same code puts a shard on each of cuda:0..7.
MESH_SHARDS = 4
# The kernels each mesh prove must launch: the engines' and the outer
# rounds' kernels on the shards, kernel B (the commitments, as on the
# device path) on the mesh's first device.
MESH_PATH = PROVE_PATH
# The sharded sumcheck's size and factor count.
MESH_SUMCHECK = (16, 3)
# Each Fr and row-MSM kernel's library entry, timed by CUDA events on the
# mesh proves.
MESH_ENTRIES = {"fold": "zfr_fold", "product_evals": "zfr_product_evals",
                "gruen_round": "zfr_gruen_round",
                "row_plane_sums": "zg1_row_msm"}


def mesh_sumcheck(torch, mesh) -> dict:
    """sharded_sumcheck_prove of Σ_x Π_k f_k(x) over 2^16 entries, k = 3,
    at tail 0 (the shards' rounds until each holds fewer than 2 entries),
    against the single-device engine on the same tables and transcript:
    round evals, challenges, finals and the transcript state equal."""
    import numpy as np

    from zolt_tpu_torch.field import limb
    from zolt_tpu_torch.field.params import FR
    from zolt_tpu_torch.parallel import sharded_sumcheck_prove
    from zolt_tpu_torch.parallel.stage_engine import DeviceProductTables
    from zolt_tpu_torch.transcript import Blake2bTranscript

    log_n, k = MESH_SUMCHECK
    rng = np.random.default_rng(log_n)
    tables = [[int.from_bytes(rng.bytes(32), "little") % FR.p
               for _ in range(1 << log_n)] for _ in range(k)]
    tm = Blake2bTranscript(b"mesh")
    ts = Blake2bTranscript(b"mesh")
    os.environ["ZOLT_TPU_DEVICE_TAIL"] = "0"
    try:
        reset_launches()
        t0 = time.perf_counter()
        got = sharded_sumcheck_prove(mesh, tables, tm)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches, _ = read_launches()
        t0 = time.perf_counter()
        eng = DeviceProductTables([limb.encode(t, device="cuda")
                                   for t in tables], degree=k, device="cuda")
        evs, rs = [], []
        for _ in range(log_n):
            e = eng.round_evals()
            for v in e:
                ts.append_scalar(v)
            rs.append(ts.challenge_scalar())
            eng.bind(rs[-1])
            evs.append(e)
        ref = (evs, rs, eng.finals())
        single_s = time.perf_counter() - t0
    finally:
        del os.environ["ZOLT_TPU_DEVICE_TAIL"]
    if got != ref or tm.state != ts.state:
        raise AssertionError("the sharded sumcheck differs from the "
                             "single-device engine")
    if not (launches["fold"] and launches[f"product_evals_k{k}"]):
        raise AssertionError(f"the sharded sumcheck launched {launches}")
    say("mesh", f"sharded_sumcheck_prove at 2^{log_n}, k = {k}: "
                f"{secs:.3f} s (the single-device engine {single_s:.3f} s); "
                f"round evals, challenges, finals and transcript equal to "
                f"the single-device engine's; launches {launches}")
    return {"seconds": secs, "single_seconds": single_s,
            "launches": launches}


def mesh_proves(torch, mesh, device_s: dict, canonical: bytes) -> dict:
    """prove_jolt(elf, backend="mesh", mesh=mesh) of the sum-loop guest at
    T = 2^CLI_LOG_T, tail 0: compat, its canonical bytes equal to the
    device and host tiers' (`canonical`, the slice phase's pair), and
    sound with the joint proof, as the CLI proves, its sha256 equal to
    the JAX CLI's digest; each timed beside the device prove of the same
    size and flags (`device_s`), with its peak device memory, each
    kernel's launches, path bound and device ms by CUDA events around each
    launch. Every kernel of MESH_PATH must launch, but kernel B in the
    compat prove, whose polys at this size commit on the host tier."""
    from zolt_tpu_torch.zkvm.commitments import DEVICE_COMMIT_MIN

    out = {}
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, f"sum_loop_t{CLI_LOG_T}.elf")
        with open(path, "wb") as f:
            f.write(sum_loop_elf(CLI_LOG_T))
        os.environ["ZOLT_TPU_DEVICE_TAIL"] = "0"
        try:
            for mode, sound in (("compat", False), ("sound", True)):
                reset_launches()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                with contextlib.ExitStack() as st:
                    ev = {k: st.enter_context(launch_events(torch, e))
                          for k, e in MESH_ENTRIES.items()}
                    blob, secs, stages, canon = timed_prove(
                        torch, path, sound=sound, with_joint_proof=sound,
                        backend="mesh", mesh=mesh)
                peak = torch.cuda.max_memory_allocated()
                launches, work = read_launches()
                digest = hashlib.sha256(blob).hexdigest()
                if not sound and canon != canonical:
                    raise AssertionError("the mesh compat proof differs from "
                                         "the device prove's")
                if sound and digest != JAX_CLI_SOUND_DIGEST_T12:
                    raise AssertionError(f"the mesh sound proof sha256 "
                                         f"{digest} != "
                                         f"{JAX_CLI_SOUND_DIGEST_T12}")
                # at T = 2^12 the compat prove's committed polys are below
                # DEVICE_COMMIT_MIN and commit on the host tier: no kernel B
                need = [k for k in MESH_PATH
                        if sound or (1 << CLI_LOG_T) >= DEVICE_COMMIT_MIN
                        or k != "row_plane_sums"]
                idle = [k for k in need if launches[k] <= 0]
                if idle:
                    raise AssertionError(f"kernels not launched in the mesh "
                                         f"{mode} prove: {idle}")
                say("mesh", f"{mode} prove on the mesh at T = 2^{CLI_LOG_T}, "
                            f"tail 0: {secs:.3f} s (the device prove of this "
                            f"call {device_s[mode]:.3f} s) {stages}; peak "
                            f"device memory {peak} bytes "
                            f"({peak / 2 ** 20:.1f} MiB); "
                            + ("sha256 equal to the JAX CLI's" if sound else
                               "bytes equal to the device prove's"))
                say("mesh", f"launches in the mesh {mode} prove: {launches}")
                figs = path_figures(work, None, "mesh",
                                    f"the mesh {mode} prove (device ms "
                                    f"below, by CUDA events)")
                # the product evals' CUDA events time both k's launches
                # together, as path_figures' "device_ms_k2_k3" does
                for name, fig in figs.items():
                    kern, _, k = name.partition("_k")
                    fig["device_ms_events" + ("_k2_k3" if k else "")] = (
                        round(sum(ev[kern]), 4) if fig["launches"] else None)
                say("mesh", f"device ms by CUDA events in the mesh {mode} "
                            f"prove: " + ", ".join(
                                f"{k} {round(sum(v), 4)} ({len(v)} launches)"
                                for k, v in ev.items()))
                out[mode] = {"seconds": secs, "device_seconds": device_s[mode],
                             "stages": stages, "peak_bytes": peak,
                             "launches": launches, "figures": figs}
        finally:
            del os.environ["ZOLT_TPU_DEVICE_TAIL"]
    return out


def mesh_msm(torch, mesh, kzg) -> dict:
    """msm_mesh at 2^16 points on the mesh, affine equal to the native C
    MSM; kernels C, D and A launch. A's launches (one fold of the shards'
    bucket arrays a pass, pt_sum) timed by CUDA events beside their bound
    (the work sum_work counts on the folds' own inputs), each launch's
    words equal to pt_sum_plain's; C and D by CUDA events too."""
    from zolt_tpu_torch.curve import device as dev
    from zolt_tpu_torch.msm import pippenger
    from zolt_tpu_torch.native import g1_msm_native

    n = 1 << 16
    pts, sc = msm_inputs(kzg, n, 16)
    want = g1_msm_native(pts, sc)
    caught = []
    orig = dev.pt_sum

    def spy(stack):
        caught.append((stack, orig(stack)))
        return caught[-1][1]

    spy.counts = orig.counts
    reset_launches()
    dev.pt_sum = spy
    try:
        with launch_events(torch, "zg1_sum") as a_ev, \
                launch_events(torch, "zg1_bucket_accumulate") as c_ev, \
                launch_events(torch, "zg1_window_sums") as d_ev:
            t0 = time.perf_counter()
            got = pippenger.msm_mesh(mesh, pts, sc)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
    finally:
        dev.pt_sum = orig
    launches, _ = read_launches()
    if got != want:
        raise AssertionError("msm_mesh differs from the native C MSM")
    idle = [k for k in ("g1_sum", "bucket_accumulate", "window_sums")
            if launches[k] <= 0]
    if idle:
        raise AssertionError(f"kernels not launched by msm_mesh: {idle}")
    if launches["g1_add_double"]:
        raise AssertionError("msm_mesh launched kernel A's batch add")
    t0 = time.perf_counter()
    err = max(max_abs(torch, a, b) for stack, out in caught
              for a, b in zip(out, dev.pt_sum_plain(stack)))
    if err:
        raise AssertionError("kernel A's fold in msm_mesh differs from "
                             "pt_sum_plain")
    nbytes = imads = 0
    for stack, _ in caught:
        w = dev.sum_work(stack)
        nbytes, imads = nbytes + w[0], imads + w[1]
    b_ms, b_by = bound(nbytes, imads)
    check_s = time.perf_counter() - t0
    a_ms = round(sum(a_ev), 4)
    shape = tuple(caught[0][0][0].shape)
    say("mesh", f"msm_mesh at 2^16 on {mesh.size} shards: {secs:.3f} s, "
                f"affine equal to the native C MSM; launches {launches}; "
                f"kernel A's {len(a_ev)} folds of {shape} words "
                f"({dev.lanes_per_pair(shape[1])} lanes a pair) {a_ev} ms "
                f"by CUDA events, sum {a_ms} against its bound {b_ms:.4f} ms "
                f"by {b_by} ({nbytes} bytes, {imads} IMADs; share "
                f"{b_ms / a_ms * 100:.1f} %), each launch's words equal to "
                f"pt_sum_plain's (the check and the bound {check_s:.1f} s); "
                f"C {round(sum(c_ev), 4)} ms in "
                f"{len(c_ev)} launches, D {round(sum(d_ev), 4)} ms in "
                f"{len(d_ev)}")
    return {"seconds": secs, "launches": launches, "a_ms": a_ms,
            "a_each_ms": a_ev, "a_bound_ms": b_ms, "a_bound_by": b_by,
            "a_max_abs_err": err, "c_ms": round(sum(c_ev), 4),
            "d_ms": round(sum(d_ev), 4)}


def mesh_cli(torch) -> dict:
    """The CLI's `prove --jolt-format --sound --backend mesh` and `--backend
    host --stage1-backend mesh` at T = 2^CLI_LOG_T, tail 0, on make_mesh()
    (every CUDA device: here a mesh of one card): each file's sha256 equal
    to JAX_CLI_SOUND_DIGEST_T12; the first launches every kernel of
    MESH_PATH, the second the Gruen round and no other."""
    from zolt_tpu_torch.__main__ import main as cli_main

    out = {}
    with tempfile.TemporaryDirectory() as td:
        elf = os.path.join(td, f"sum_loop_t{CLI_LOG_T}.elf")
        with open(elf, "wb") as f:
            f.write(sum_loop_elf(CLI_LOG_T))
        for name, flags in (("backend_mesh", ["--backend", "mesh"]),
                            ("stage1_backend_mesh",
                             ["--backend", "host", "--stage1-backend",
                              "mesh"])):
            f_out = os.path.join(td, f"{name}.bin")
            os.environ["ZOLT_TPU_DEVICE_TAIL"] = "0"
            try:
                reset_launches()
                t0 = time.perf_counter()
                rc = cli_main(["prove", elf, "--jolt-format", "--sound",
                               *flags, "-o", f_out])
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
                launches, _ = read_launches()
            finally:
                del os.environ["ZOLT_TPU_DEVICE_TAIL"]
            with open(f_out, "rb") as f:
                digest = hashlib.sha256(f.read()).hexdigest()
            if rc != 0 or digest != JAX_CLI_SOUND_DIGEST_T12:
                raise AssertionError(f"the CLI's prove {flags}: exit {rc}, "
                                     f"sha256 {digest} != "
                                     f"{JAX_CLI_SOUND_DIGEST_T12}")
            ran = {k for k, v in launches.items() if v}
            want = (set(MESH_PATH) if name == "backend_mesh"
                    else {"gruen_round"})
            if not (want <= ran if name == "backend_mesh" else ran == want):
                raise AssertionError(f"the CLI's prove {flags} launched "
                                     f"{sorted(ran)}, not {sorted(want)}")
            say("mesh", f"prove --jolt-format --sound {' '.join(flags)} on "
                        f"make_mesh() (every CUDA device: "
                        f"{torch.cuda.device_count()}), T = 2^{CLI_LOG_T}, "
                        f"tail 0: {secs:.3f} s, sha256 equals the JAX CLI's; "
                        f"launches {launches}")
            out[name] = {"seconds": secs, "launches": launches}
    return out


def run_mesh(torch, device_s: dict, canonical: bytes, kzg) -> dict:
    """Phase 12, mesh (see the module docstring)."""
    from zolt_tpu_torch.parallel import make_mesh

    mesh = make_mesh(["cuda:0"] * MESH_SHARDS)
    say("mesh", f"make_mesh(['cuda:0'] * {MESH_SHARDS}): {mesh.size} shards "
                f"on {[str(d) for d in mesh.devices]}; "
                f"torch.cuda.device_count() {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    out = {"sumcheck": mesh_sumcheck(torch, mesh),
           **mesh_proves(torch, mesh, device_s, canonical),
           "msm": mesh_msm(torch, mesh, kzg), "cli": mesh_cli(torch)}
    out["seconds"] = time.perf_counter() - t0
    say("mesh", f"the mesh phase took {out['seconds']:.1f} s")
    return out


def kernels_json(stats: dict, launches: dict, path: dict,
                 sound_launches: dict, sound: dict, cli: dict, commits: dict,
                 kzg: dict, legacy: dict, internal: dict, mesh: dict,
                 field: dict, anyk: dict) -> list:
    """The kernels' entries of the JSON line. `launches` is the compat
    prove's (the main path; kernel A's: msm_mesh's, its one path; kernel
    F's: the bench's field section, which no prove reaches; kernel G's:
    its path on cuda:0, which no Jolt prove reaches, beside it under
    shards2_ the same path on two shards of cuda:0); each
    other path's launches and figures sit beside it under its own prefix:
    sound_, cli_, batch_opening_, legacy_, internal_, opening_ (the
    internal prove with its batch opening) and mesh_ (the mesh phase's
    proves, mesh_sound_, its sharded sumcheck, msm_mesh and CLI proves)."""

    def other_paths(name: str) -> dict:
        out = {}
        figs = [("legacy", legacy["figures"]),
                ("internal", internal["prove"]["figures"]),
                ("opening", internal["opening"]["figures"])]
        for pre, f in figs:
            if name in f:
                out.update({f"{pre}_path_{k}": v for k, v in f[name].items()
                            if k.startswith(("bound_ms", "device_ms"))})
        if name == "product_evals_k3" and \
                "stage1_product_evals_ms" in legacy["figures"]:
            out["legacy_stage1_device_ms"] = \
                legacy["figures"]["stage1_product_evals_ms"]
        out.update(legacy_launches=legacy["launches"][name],
                   internal_launches=internal["prove"]["launches"][name],
                   opening_launches=internal["opening"]["launches"][name],
                   cli_container_launches={
                       c: v[name] for c, v in cli["containers"].items()})
        for mode in ("compat", "sound"):
            pre = "mesh" if mode == "compat" else "mesh_sound"
            out[f"{pre}_launches"] = mesh[mode]["launches"][name]
            out.update({f"{pre}_path_{k}": v for k, v in
                        mesh[mode]["figures"].get(name, {}).items()
                        if k.startswith(("bound_ms", "device_ms"))})
        out.update(mesh_sumcheck_launches=mesh["sumcheck"]["launches"][name],
                   mesh_msm_launches=mesh["msm"]["launches"][name],
                   mesh_cli_launches={c: v["launches"][name]
                                      for c, v in mesh["cli"].items()})
        return out

    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "device_ms")
    kernels = []
    for name, src, rep in KERNELS:
        entry = dict(name=name, route="cuda", source=src, replaces=rep,
                     launches=launches[name],
                     **{k: stats[name][k] for k in keys},
                     sound_launches=sound_launches[name],
                     cli_launches=cli["launches"][name],
                     batch_opening_launches=sound["bo_launches"][name])
        for pre, figs in (("path", path), ("sound_path", sound["prove"]),
                          ("batch_opening", sound["batch_opening"])):
            entry.update({f"{pre}_{k}": v for k, v in figs[name].items()
                          if k.startswith(("bound_ms", "device_ms"))})
        if name + "_batch_opening" in stats:
            bs = stats[name + "_batch_opening"]
            entry["batch_opening_shape"] = {k: bs[k] for k in keys + ("shape",)}
        entry.update(other_paths(name))
        kernels.append(entry)
    for name, src, rep in G1_KERNELS:
        on_prove = name in PROVE_PATH
        entry = dict(name=name, route="cuda", source=src, replaces=rep,
                     launches=(launches[name] if on_prove else
                               kzg["launches"][name] if name in KZG_PATH
                               else mesh["msm"]["launches"][name]),
                     path=("prove_jolt (compat, tail 0)" if on_prove else
                           "HyperKZG commit and open at 2^18"
                           if name in KZG_PATH else
                           f"msm_mesh at 2^16 on {MESH_SHARDS} shards of "
                           f"cuda:0: one fold of the shards' bucket arrays "
                           f"a pass" if name == "g1_sum" else
                           "none (msm_mesh folds with g1_sum); timed at its "
                           "batch shapes"),
                     **{k: stats[name][k] for k in keys},
                     shape=stats[name]["shape"])
        if name in KZG_PATH:
            entry.update({f"path_{k}": v for k, v in
                          kzg["figures"][name].items()
                          if k.startswith(("bound_ms", "device_ms",
                                           "kernel_launches"))})
        if name == "g1_add_double":
            entry.update(generic_shape={k: stats["g1_add_generic"][k]
                                        for k in keys + ("shape",)},
                         double_shape={k: stats["g1_double"][k]
                                       for k in keys + ("shape",)})
        if name == "g1_sum":
            m = mesh["msm"]
            entry.update(path_device_ms_events=m["a_ms"],
                         path_each_launch_ms=m["a_each_ms"],
                         path_bound_ms=m["a_bound_ms"],
                         path_bound_by=m["a_bound_by"],
                         path_max_abs_err=m["a_max_abs_err"],
                         lanes_sweep_ms=stats[name]["lanes_sweep_ms"])
        if name == "bucket_accumulate":
            entry.update({f"{p}_shape": {k: stats[f"{name}_{p}"][k] for k in
                                         keys + ("shape",)}
                          for p in ("ram", "rd")})
            entry["opening_each_launch"] = (
                internal["opening"]["figures"][name]["each_launch"])
        if on_prove:
            lanes = ("lanes", "lanes_ms")
            entry.update(sound_launches=sound_launches[name],
                         cli_launches=cli["launches"][name],
                         lanes=stats[name]["lanes"],
                         lanes_ms=stats[name]["lanes_ms"],
                         compat_shape={k: stats[name + "_compat"][k]
                                       for k in keys + ("shape",) + lanes},
                         commit_phase={m: {k: c[k] for k in (
                             "bound_ms", "device_ms", "device_ms_events",
                             "path_inputs")}
                             for m, c in commits.items()})
            for pre, figs in (("path", path), ("sound_path", sound["prove"])):
                entry.update({f"{pre}_{k}": v for k, v in figs[name].items()
                              if k.startswith(("bound_ms", "device_ms"))})
        entry.update(other_paths(name))
        kernels.append(entry)
    for name, src, rep in ANY_KERNELS:
        dev_run, mesh_run = (anyk["runs"][w] for w in anyk["runs"])
        entry = dict(name=name, route="cuda", source=src, replaces=rep,
                     launches=dev_run["launches"][name],
                     path=f"run_sumcheck of ProductSumcheck at k = "
                          f"{ANY_SUMCHECKS} and DeviceProductTables at "
                          f"{ANY_ENGINES}, 2^{ANY_LOG_N} entries, tail 0, "
                          f"on cuda:0",
                     **{k: stats[name][k] for k in keys},
                     shape=stats[name]["shape"],
                     path_device_ms_events=dev_run["events_ms"],
                     path_bound_ms=dev_run["figures"]["bound_ms"],
                     path_bound_by=dev_run["figures"]["bound_by"],
                     shards2_launches=mesh_run["launches"][name],
                     shards2_path_device_ms_events=mesh_run["events_ms"],
                     shards2_path_bound_ms=mesh_run["figures"]["bound_ms"],
                     other_shapes={k2: {k: stats[k2][k]
                                        for k in keys + ("shape",)}
                                   for k2 in stats
                                   if k2.startswith(name + "_k")},
                     phase_seconds=anyk["seconds"])
        entry.update(other_paths(name))
        kernels.append(entry)
    for name, src, rep in F_KERNELS:
        entry = dict(name=name, route="cuda", source=src, replaces=rep,
                     launches=field["launches"][name],
                     path="the bench's field section (quick: batch_inverse "
                          "at 2^12, Fr)",
                     **{k: stats[name][k] for k in keys},
                     shape=stats[name]["shape"],
                     pow_shape={k: stats[name + "_pow"][k]
                                for k in keys + ("shape",)},
                     shape_2p18={k: stats[name + "_2p18"][k]
                                 for k in keys + ("shape",)},
                     sweep=stats[name]["sweep"],
                     phase_seconds=field["seconds"])
        entry.update(other_paths(name))
        kernels.append(entry)
    return kernels


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--log-t", type=int, default=16,
                    help="log2 of the guest's trace length (default 16)")
    ap.add_argument("--profile", default=None,
                    help="also run the tail-0 device prove under cProfile "
                         "and write both profiles to PROFILE.txt, and a "
                         "profiled sound prove to PROFILE_sound.txt")
    args = ap.parse_args()
    t_start = time.perf_counter()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's device path needs one",
              file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "zolt_tpu_torch", "csrc")):
        print("chip_smoke: zolt_tpu_torch/ is missing; run it from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, root)
    card = card_line()
    say("device", f"{torch.cuda.get_device_name(0)}; nvidia-smi: {card}; "
                  f"torch {torch.__version__} cuda {torch.version.cuda}")

    from zolt_tpu_torch import _build
    from zolt_tpu_torch.native import get_lib, get_trace_lib

    kl = _build.kernels()
    say("build", f"nvcc sm_90a kernels built in {kl.build_s:.2f} s "
                 f"({os.path.basename(kl.path)}); ptxas, by kernel: "
                 f"{ptxas_summary(kl.ptxas_log)}")
    lib = get_lib()
    if lib is None or not getattr(lib, "_frv_ready", False):
        raise AssertionError("the native C tier did not load")
    say("build", f"native C tier loaded; trace materializer "
                 f"{'loaded' if get_trace_lib() is not None else 'absent'}")

    phase_s: dict = {}
    t_phase = [time.perf_counter()]

    def done(name: str) -> None:
        now = time.perf_counter()
        phase_s[name] = round(now - t_phase[0], 1)
        t_phase[0] = now

    done("device_build")
    stats: dict = {}
    check_kernels(torch, stats)
    done("kernels")
    field = run_field(torch)
    stats.update(field["stats"])
    done("field")
    anyk = run_any(torch)
    stats.update(anyk["stats"])
    done("any")
    kzg_srs = check_g1(torch, stats, args.log_t)
    done("g1")
    launches, path, compat_proof = run_slice(torch, args.log_t, args.profile)
    done("slice")
    sound_launches, sound, sound_proof = run_sound(torch, args.log_t,
                                                   args.profile)
    done("sound")
    verify_s = run_verify(args.log_t, compat_proof, sound_proof)
    done("verify")
    cli = run_cli(torch, root)
    done("cli")
    say("verify", f"seconds: verify {verify_s}; cli {cli['seconds']}")
    commits = commit_pairs(torch, args.log_t)
    done("commit")
    kzg = run_kzg(torch, kzg_srs)
    done("kzg")
    legacy = run_legacy(torch, args.log_t)
    done("legacy")
    internal = run_internal(torch, args.log_t, kzg_srs)
    done("internal")
    mesh = run_mesh(torch, {"compat": path["small"]["seconds"],
                            "sound": cli["seconds"]["prove"]},
                    path["small"]["canonical"], kzg_srs)
    done("mesh")
    say("done", f"seconds by phase: {phase_s}")

    kernels = kernels_json(stats, launches, path, sound_launches, sound, cli,
                           commits, kzg, legacy, internal, mesh, field,
                           anyk)
    say("done", f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
