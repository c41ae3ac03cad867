#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (zolt_tpu_torch) on one GPU.

Run from the repository root on a machine with an NVIDIA Hopper GPU and the
CUDA toolkit (nvcc):

    python3 chip_smoke.py [--log-t 16] [--profile PATH]

Phases, one status line each; the first failure ends the run non-zero:

1. device: CUDA must be present (there is no CPU fallback); prints the
   card's name and power limit from nvidia-smi.
2. build: nvcc builds the four kernels of zolt_tpu_torch/csrc for sm_90a,
   and the native C tier (zolt_tpu_torch/native/*.c) must load.
3. kernels: each kernel against its plain torch version on the same CUDA
   tensors and against the host C tier (FrVec.fold_adj, prod_evals_adj,
   gruen_quad), at the shapes of the main path (stage-1 az/bz n = 2^17,
   engines n = 2^16, k = 2 and 3, degree 2 and 3, the live prefix halving
   down to 1 pair). Exact: every value is a canonical field element, so
   the tolerance is 0. Times each kernel per call (CUDA events) and on
   the device alone (torch.profiler), and its plain version per call.
4. slice: the sum-loop guest (the repo bench's guest) at T = 2^log_t.
   prove_jolt(backend="device", device="cuda") with the host tail pinned
   to 0, so every sumcheck round of stages 1-4 runs on the GPU; the
   host-tier prove (backend=None); the device prove at the default tail.
   All three serialized proofs must be equal, and at T = 2^16 their
   sha256 must equal the digest the JAX package (zolt_tpu) computes for
   the same guest on the CPU. Every kernel must have launched during the
   tail-0 device prove.

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


def timings(torch, stats: dict, name: str, kernel, plain, nbytes: int,
            shape: str, err: int) -> None:
    """Record and print one kernel's call time (CUDA events), device time
    (profiler) and its plain version's call time, on the same inputs."""
    st = stats[name] = dict(max_abs_err=err, shape=shape,
                            ms=cuda_ms(torch, kernel, 50),
                            device_ms=device_ms(torch, kernel, 50),
                            plain_ms=cuda_ms(torch, plain, 3))
    dev = (f"{st['device_ms']:.4f} ms on the device "
           f"({nbytes / st['device_ms'] / 1e6:.1f} GB/s of {nbytes} bytes)"
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
    # reads 2^16 live pairs per table, writes every slot
    timings(torch, stats, "fold", lambda: fold.fold(tabs, r, 1 << 16),
            lambda: fold.fold_plain(tabs, r, 1 << 16), 2 * 2 * (1 << 17) * 32,
            "(2, 2^17, 8), live 2^16", err)

    # kernels 2-3: engines at n = 2^16, degree 2 and 3
    n = 1 << 16
    for k, name in ((2, "product_evals_k2"), (3, "product_evals_k3")):
        err = 0
        for degree in (2, 3):
            live = n // 2
            while live >= 1:
                tabs = rand_tables(torch, gen, k, n, 2 * live)
                got = evals.product_evals(tabs, live, degree)
                plain = evals.product_evals_plain(tabs, live, degree)
                err = max(err, max_abs(torch, got, plain))
                host = FrVec.prod_evals_adj(
                    [limb.words_to_frvec(tabs[j, : 2 * live])
                     for j in range(k)], degree)
                if limb.decode(got) != host:
                    raise AssertionError(f"{name} != FrVec.prod_evals_adj "
                                         f"at degree {degree} live {live}")
                live //= 4 if live > 64 else 2
        if err:
            raise AssertionError(f"{name} differs from its plain version")
        tabs = rand_tables(torch, gen, k, n, n)
        deg = 3 if k == 3 else 2
        timings(torch, stats, name,
                lambda: evals.product_evals(tabs, n // 2, deg),
                lambda: evals.product_evals_plain(tabs, n // 2, deg),
                k * n * 32, f"({k}, 2^16, 8), degree {deg}", err)

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
            lambda: gruen.gruen_eval_plain(*args), 2 * n * 32,
            "az, bz (2^17, 8), h_in 8", err)


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


def profile_prove(torch, path: str, out: str) -> None:
    """One more tail-0 device prove under cProfile (host time by function)
    and torch.profiler (device time by kernel); writes out.txt."""
    import cProfile
    import io
    import pstats

    from torch.profiler import ProfilerActivity, profile

    cp = cProfile.Profile()
    with profile(activities=[ProfilerActivity.CUDA]) as p:
        cp.enable()
        _, wall, stages = timed_prove(torch, path, backend="device",
                                      device="cuda")
        cp.disable()
    rows = p.key_averages()
    busy_us = device_us(rows)
    host = io.StringIO()
    pstats.Stats(cp, stream=host).sort_stats("cumulative").print_stats(60)
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out + ".txt", "w") as f:
        f.write(f"profiled device prove (tail 0): {wall:.3f} s {stages}\n"
                f"device busy {busy_us / 1e3:.3f} ms\n\n")
        f.write(rows.table(sort_by="cuda_time_total", row_limit=25))
        f.write("\n\n" + host.getvalue())
    say("slice", f"profiled prove {wall:.3f} s, device busy "
                 f"{busy_us / 1e3:.3f} ms; written to {out}.txt")


def reset_launches() -> None:
    from zolt_tpu_torch.field import evals, fold, gruen

    fold.fold.launches = 0
    evals.product_evals.launches.update({2: 0, 3: 0})
    gruen.gruen_eval.launches = 0


def read_launches() -> dict:
    from zolt_tpu_torch.field import evals, fold, gruen

    return {"fold": fold.fold.launches,
            "product_evals_k2": evals.product_evals.launches[2],
            "product_evals_k3": evals.product_evals.launches[3],
            "gruen_eval": gruen.gruen_eval.launches}


def run_slice(torch, log_t: int, profile: str | None) -> dict:
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "sum_loop.elf")
        with open(path, "wb") as f:
            f.write(sum_loop_elf(log_t))

        os.environ["ZOLT_TPU_DEVICE_TAIL"] = "0"
        reset_launches()
        dev, dev_s, dev_stages = timed_prove(torch, path, backend="device",
                                             device="cuda")
        launches = read_launches()
        say("slice", f"device prove, tail 0: {dev_s:.3f} s {dev_stages}")
        say("slice", f"launches on the main path: {launches}")
        if profile:
            profile_prove(torch, path, profile)

        host, host_s, host_stages = timed_prove(torch, path)
        say("slice", f"host-tier prove: {host_s:.3f} s {host_stages}")
        del os.environ["ZOLT_TPU_DEVICE_TAIL"]
        dflt, dflt_s, dflt_stages = timed_prove(torch, path, backend="device",
                                                device="cuda")
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
                    help="also profile one tail-0 device prove (cProfile "
                         "and torch.profiler) into PROFILE.txt")
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

    kernels = [dict(name=name, route="cuda", source=src, replaces=rep,
                    launches=launches[name],
                    max_abs_err=stats[name]["max_abs_err"],
                    ms=stats[name]["ms"], plain_ms=stats[name]["plain_ms"],
                    device_ms=stats[name]["device_ms"])
               for name, src, rep in KERNELS]
    print(json.dumps({"kernels": kernels}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
