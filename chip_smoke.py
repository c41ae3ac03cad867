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
   down to 1 pair). The grouped product-evals kernel also takes mixed
   groups (k, n, degree 0-3, live counts down to 0) in one launch, three
   launches back to back (its ticket counters must reset), and 2^21
   entries; both of its schedules (a thread a pair, four threads a pair)
   at each live count of the path's rounds. Exact: every value is a
   canonical field element, so the tolerance is 0. Times each kernel per
   call (CUDA events) and on the device alone (torch.profiler), beside its
   bound (bytes at the HBM rate or IMADs at the integer peak) and its
   plain version per call; the product evals on each side of the
   schedules' threshold and at stage 3's round 0 (seven groups, one
   launch).
4. slice: the sum-loop guest (the repo bench's guest) at T = 2^log_t.
   prove_jolt with its defaults (backend="device", device="cuda") with the
   host tail pinned to 0, so every sumcheck round of stages 1-4 runs on the
   GPU; the same prove again under torch.profiler, which counts the
   kernels on the device (no product-evals reduce pass may run; with
   --profile also under cProfile); the host-tier prove (backend="host");
   the device prove at the default tail. The three unprofiled proofs must
   be equal, and at T = 2^16 their sha256 must equal the digest the JAX
   package (zolt_tpu) computes for the same guest on the CPU. Every kernel
   must have launched during the tail-0 device prove.

The last three lines are the kernels' JSON, the nvidia-smi card line and
the result JSON.
"""

from __future__ import annotations

import argparse
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

# (name, source, the pallas_call it replaces). The fold also replaces
# fold_tail_stack (:589), fold_rows_stack (:689) and fold_shared (:424);
# gruen_eval replaces the eval half of product_round.
KERNELS = [
    ("fold", "zolt_tpu_torch/csrc/fold.cu",
     "zolt_tpu/field/pallas_redc.py:516"),
    ("product_evals_k2", "zolt_tpu_torch/csrc/product_evals.cu",
     "zolt_tpu/field/pallas_redc.py:754"),
    ("product_evals_k3", "zolt_tpu_torch/csrc/product_evals.cu",
     "zolt_tpu/field/pallas_redc.py:878"),
    ("gruen_eval", "zolt_tpu_torch/csrc/gruen_eval.cu",
     "zolt_tpu/field/pallas_kernels.py:191"),
]


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


def device_ms(torch, fn, iters: int) -> float:
    """Mean device milliseconds per call over `iters` calls: the kernels'
    own time by torch.profiler, without the wrapper's host work."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as p:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return device_us(p.key_averages()) / 1e3 / iters


# The card's peaks for the bounds (H100 SXM, 700 W): HBM3 3.35 TB/s (the
# data sheet); int32 multiply-adds at 132 SMs x 64 IMAD/clk (CUDA's
# throughput table for compute capability 9.0) x 1.98 GHz.
HBM_BYTES_PER_S = 3.35e12
IMAD_PER_S = 132 * 64 * 1.98e9
# IMADs, counting lo and hi of a 32x32-bit word product as two: a 256x256
# bit product, and a Montgomery product with its REDC.
WIDE_IMADS = 128
MONT_IMADS = 272


def bound(nbytes: int, imads: int) -> tuple[float, str]:
    """The least time (ms) the card could take: the bytes moved once at the
    HBM rate or the IMADs at the integer peak, whichever is longer."""
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    o_ms = imads / IMAD_PER_S * 1e3
    return (b_ms, "bytes") if b_ms >= o_ms else (o_ms, "operations")


def eval_work(groups) -> tuple[int, int]:
    """Bytes and IMADs the product evals need for these groups: each live
    pair's K entries of 64 bytes read once, the evals written once; K = 2
    sums min(degree, 2) + 1 products a pair, K = 3 forms that many reduced
    products and sums degree + 1."""
    nbytes = imads = 0
    for tabs, live, deg in groups:
        k = tabs.shape[0]
        nbytes += k * live * 64 + (deg + 1) * 32
        pts = min(deg, 2) + 1
        imads += live * (pts * WIDE_IMADS if k == 2 else
                         pts * MONT_IMADS + (deg + 1) * WIDE_IMADS)
    return nbytes, imads


def gruen_work(live: int, h_in: int) -> tuple[int, int]:
    """Bytes and IMADs the Gruen round needs: az and bz of each live pair
    read once, the eq entries it weights them by, two evals written. A pair
    needs its two reduced products (a0·b0 and Δa·Δb) and their two products
    by E_in, which feed a sum and stay wide; each E_out entry weights its
    block of 2^h_in pairs once: a reduction of each of the block's two sums
    and a product by E_out, a Montgomery product's worth."""
    blocks = -(-live // (1 << h_in))
    nbytes = 2 * live * 64 + (blocks + min(live, 1 << h_in)) * 32 + 2 * 32
    imads = live * 2 * (MONT_IMADS + WIDE_IMADS) + blocks * 2 * MONT_IMADS
    return nbytes, imads


def timings(torch, stats: dict, name: str, kernel, plain, nbytes: int,
            imads: int, shape: str, err: int) -> None:
    """Record and print one kernel's call time (CUDA events), device time
    (profiler), bound, and its plain version's call time, on the same
    inputs."""
    b_ms, b_by = bound(nbytes, imads)
    st = stats[name] = dict(max_abs_err=err, shape=shape,
                            ms=cuda_ms(torch, kernel, 50),
                            device_ms=device_ms(torch, kernel, 50),
                            plain_ms=cuda_ms(torch, plain, 3),
                            bound_ms=b_ms, bound_by=b_by, library_ms=None)
    dev = (f"{st['device_ms']:.4f} ms on the device "
           f"({nbytes / st['device_ms'] / 1e6:.1f} GB/s of {nbytes} bytes, "
           f"bound {b_ms:.4f} ms by {b_by}, "
           f"{b_ms / st['device_ms'] * 100:.1f} % of it)"
           if st["device_ms"] else "device time not measured (the "
           "profiler saw no device events)")
    say("kernels", f"{name} exact vs plain and the host tier at {shape}: "
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
    from zolt_tpu_torch.field import evals, fold, gruen, limb
    from zolt_tpu_torch.native.frvec import FrVec

    gen = torch.Generator(device="cuda")
    gen.manual_seed(20261016)
    r = 0x1234567890ABCDEF1234567890ABCDEF % (1 << 250)

    # kernel 1: stage-1 az/bz (2, 2^17) and a k=3 engine stack (3, 2^16)
    err = 0
    for k, log_n in ((2, 17), (3, 16)):
        n = 1 << log_n
        live = n // 2
        while live >= 1:
            tabs = rand_tables(torch, gen, k, n, 2 * live)
            got = fold.fold(tabs, r, live)
            plain = fold.fold_plain(tabs, r, live)
            err = max(err, max_abs(torch, got, plain))
            if got[:, live:].any():
                raise AssertionError("fold left a non-zero tail")
            host = limb.words_to_frvec(tabs[k - 1, : 2 * live]).fold_adj(r)
            if not torch.equal(got[k - 1, :live].cpu(),
                               limb.frvec_to_words(host)):
                raise AssertionError(f"fold != FrVec.fold_adj at n={n} "
                                     f"live={live}")
            live //= 4 if live > 64 else 2
    if err:
        raise AssertionError(f"fold differs from its plain version: {err}")
    tabs = rand_tables(torch, gen, 2, 1 << 17, 1 << 17)
    # reads 2 x 2^16 live pairs, writes 2 x 2^17 slots; a product a pair
    timings(torch, stats, "fold", lambda: fold.fold(tabs, r, 1 << 16),
            lambda: fold.fold_plain(tabs, r, 1 << 16),
            2 * (1 << 16) * 64 + 2 * (1 << 17) * 32,
            2 * (1 << 16) * MONT_IMADS, "(2, 2^17, 8), live 2^16", err)

    check_product_evals(torch, gen, stats)

    # kernel 4: stage-1 az/bz n = 2^17 with 9-level E_out/E_in stacks
    n = 1 << 17
    levels = 9
    flat = (1 << levels) - 1
    e_out = rand_tables(torch, gen, 1, flat, flat)[0]
    e_in = rand_tables(torch, gen, 1, flat, flat)[0]
    err = 0
    live = n // 2
    while live >= 1:
        lg = live.bit_length() - 1
        h_in = min(levels - 1, lg)
        lvl_out = lg - h_in
        off_out, off_in = (1 << lvl_out) - 1, (1 << h_in) - 1
        ab = rand_tables(torch, gen, 2, n, 2 * live)
        args = (ab[0], ab[1], e_out, e_in, off_out, off_in, h_in, live)
        got = gruen.gruen_eval(*args)
        plain = gruen.gruen_eval_plain(*args)
        err = max(err, max_abs(torch, got, plain))
        host = FrVec.gruen_quad(
            limb.words_to_frvec(e_out[off_out: off_out + (1 << lvl_out)]),
            limb.words_to_frvec(e_in[off_in: off_in + (1 << h_in)]), h_in,
            limb.words_to_frvec(ab[0, : 2 * live]),
            limb.words_to_frvec(ab[1, : 2 * live]), live)
        if tuple(limb.decode(got)) != tuple(host):
            raise AssertionError(f"gruen_eval != FrVec.gruen_quad at "
                                 f"live {live}")
        live //= 4 if live > 64 else 2
    if err:
        raise AssertionError("gruen_eval differs from its plain version")
    ab = rand_tables(torch, gen, 2, n, n)
    args = (ab[0], ab[1], e_out, e_in, (1 << 8) - 1, (1 << 8) - 1, 8, n // 2)
    timings(torch, stats, "gruen_eval", lambda: gruen.gruen_eval(*args),
            lambda: gruen.gruen_eval_plain(*args), *gruen_work(n // 2, 8),
            "az, bz (2^17, 8), h_in 8", err)


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
                lambda: evals.product_evals_plain(*g[0]), *eval_work(g),
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
                lambda: evals.product_evals_plain(*g2[0]), *eval_work(g2),
                f"({k}, 2^16, 8), {split} live pairs, degree {deg}", e2)
    # stage 3, round 0: 3 x (k = 2, degree 2) + 4 x (k = 3, degree 3)
    g7 = ([(rand_tables(torch, gen, 2, n, n), n // 2, 2) for _ in range(3)]
          + [(rand_tables(torch, gen, 3, n, n), n // 2, 3) for _ in range(4)])
    timings(torch, stats, "product_evals_stage3_round0",
            lambda: evals.product_evals(g7),
            lambda: [evals.product_evals_plain(*g) for g in g7],
            *eval_work(g7), "stage 3 round 0: 3 x (2, 2^16, 8) degree 2 + "
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
    from zolt_tpu_torch.utils.log import metrics
    from zolt_tpu_torch.zkvm.pipeline import prove_jolt

    metrics.reset()
    t0 = time.perf_counter()
    res = prove_jolt(path, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    blob = res.conv.proof.serialize_with_dory()
    return blob, wall, {k: round(v, 4) for k, v in metrics.timings.items()}


def profiled_prove(torch, path: str, out: str | None) -> tuple[dict, dict]:
    """One more tail-0 device prove under torch.profiler (device time by
    kernel), and under cProfile (host time by function) when `out` is
    given, which then writes out.txt. Returns the kernels' launches seen on
    the device by name, and the product evals' wrapper counts in this
    prove."""
    import cProfile
    import io
    import pstats

    from torch.profiler import ProfilerActivity, profile

    cp = cProfile.Profile()
    reset_launches()
    with profile(activities=[ProfilerActivity.CUDA]) as p:
        if out:
            cp.enable()
        _, wall, stages = timed_prove(torch, path)
        if out:
            cp.disable()
    _, counts = read_launches()
    rows = p.key_averages()
    busy_us = device_us(rows)
    say("slice", f"profiled device prove (tail 0, under torch.profiler"
                 f"{' and cProfile' if out else ''}): {wall:.3f} s, device "
                 f"busy {busy_us / 1e3:.3f} ms")
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
    return on_dev, counts


def reset_launches() -> None:
    from zolt_tpu_torch.field import evals, fold, gruen

    fold.fold.launches = 0
    counts = evals.product_evals.counts
    counts.update(dict.fromkeys(counts, 0))
    gruen.gruen_eval.launches = 0


def read_launches() -> tuple[dict, dict]:
    """The wrappers' launch counts per kernel entry of the JSON line (a
    grouped product-evals launch counts for each k it carried), and the
    product evals' own counters."""
    from zolt_tpu_torch.field import evals, fold, gruen

    c = dict(evals.product_evals.counts)
    return {"fold": fold.fold.launches,
            "product_evals_k2": c["launches_k2"],
            "product_evals_k3": c["launches_k3"],
            "gruen_eval": gruen.gruen_eval.launches}, c


def device_kernel_counts(rows) -> tuple[dict, dict]:
    """Launches seen on the device by torch.profiler, and their device
    milliseconds, by kernel name."""
    names = {"fold": "fold_kernel", "product_evals": "product_evals_kernel",
             "gruen_eval": "gruen_eval_kernel",
             "reduce_partials<2>": "zfr_reduce_partials<2>",
             "reduce_partials<4>": "zfr_reduce_partials<4>"}
    counts = {k: sum(e.count for e in rows if v in e.key)
              for k, v in names.items()}
    ms = {k: round(device_us([e for e in rows if v in e.key]) / 1e3, 4)
          for k, v in names.items()}
    return counts, ms


def run_slice(torch, log_t: int, profile: str | None) -> dict:
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "sum_loop.elf")
        with open(path, "wb") as f:
            f.write(sum_loop_elf(log_t))

        os.environ["ZOLT_TPU_DEVICE_TAIL"] = "0"
        reset_launches()
        dev, dev_s, dev_stages = timed_prove(torch, path)
        launches, ev = read_launches()
        say("slice", f"device prove (defaults: backend 'device', 'cuda'), "
                     f"tail 0: {dev_s:.3f} s {dev_stages}")
        say("slice", f"launches on the main path: {launches}; product "
                     f"evals: {ev}")
        on_dev, prof_ev = profiled_prove(torch, path, profile)
        if on_dev["reduce_partials<4>"]:
            raise AssertionError("a product-evals reduce pass ran on the path")
        if not on_dev["product_evals"] == prof_ev["launches"] == ev["launches"]:
            raise AssertionError(f"product-evals launches: the profiler saw "
                                 f"{on_dev['product_evals']}, the wrapper "
                                 f"counted {prof_ev['launches']} there and "
                                 f"{ev['launches']} in the timed prove")

        host, host_s, host_stages = timed_prove(torch, path, backend="host")
        say("slice", f"host-tier prove: {host_s:.3f} s {host_stages}")
        del os.environ["ZOLT_TPU_DEVICE_TAIL"]
        dflt, dflt_s, dflt_stages = timed_prove(torch, path)
        say("slice", f"device prove, default tail (8192): {dflt_s:.3f} s "
                     f"{dflt_stages}")

    digest = hashlib.sha256(dev).hexdigest()
    if dev != host:
        raise AssertionError("device proof bytes differ from the host tier's")
    if dflt != host:
        raise AssertionError("default-tail device proof differs from host")
    if log_t == 16:
        if digest != JAX_DIGEST_T16:
            raise AssertionError(f"proof sha256 {digest} != JAX digest "
                                 f"{JAX_DIGEST_T16}")
        say("slice", f"{len(dev)} proof bytes equal across the three "
                     f"proves; sha256 {digest} equals the JAX digest")
    else:
        say("slice", f"{len(dev)} proof bytes equal across the three "
                     f"proves; sha256 {digest} (no JAX digest for "
                     f"T = 2^{log_t})")
    idle = [k for k, v in launches.items() if v <= 0]
    if idle:
        raise AssertionError(f"kernels not launched on the main path: {idle}")
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--log-t", type=int, default=16,
                    help="log2 of the guest's trace length (default 16)")
    ap.add_argument("--profile", default=None,
                    help="also run the profiled tail-0 device prove under "
                         "cProfile and write both profiles to PROFILE.txt")
    args = ap.parse_args()

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
    regs = [ln.strip() for ln in kl.ptxas_log.splitlines()
            if "registers" in ln or "spill" in ln]
    say("build", f"nvcc sm_90a kernels built in {kl.build_s:.2f} s "
                 f"({os.path.basename(kl.path)}); ptxas: {regs}")
    lib = get_lib()
    if lib is None or not getattr(lib, "_frv_ready", False):
        raise AssertionError("the native C tier did not load")
    say("build", f"native C tier loaded; trace materializer "
                 f"{'loaded' if get_trace_lib() is not None else 'absent'}")

    stats: dict = {}
    check_kernels(torch, stats)
    launches = run_slice(torch, args.log_t, args.profile)

    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "device_ms")
    kernels = [dict(name=name, route="cuda", source=src, replaces=rep,
                    launches=launches[name],
                    **{k: stats[name][k] for k in keys})
               for name, src, rep in KERNELS]
    print(json.dumps({"kernels": kernels}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
