"""One run of one cell: set-up, the timed window, the reference's judgement,
and the result line.

Everything a cell needs is found by name: its entry in BENCHMARK.json, its
configuration (configs/<config>.json), its traffic mix (traffic/<mix>.json,
read by the one generator in guest.py) and its metrics (metrics/<metric>.py,
each a `read(run)` that returns a number or None).
"""

from __future__ import annotations

import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time
import traceback
from contextlib import contextmanager, nullcontext

from . import guest, trace
from .reference import judge

ZKBENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(ZKBENCH)
FORBIDDEN = ("jax", "jaxlib", "flax", "zolt_tpu")
# A traced run's window is at most this long: the profiler's processing takes
# 9-17 s a prove (some 25k device operations each) on the chip's host after
# the window, and a 51 s traced window would take a run past its 360 s.
TRACE_WINDOW_S = 15.0
# environment variables that would change what the program does
PROGRAM_ENV = ("ZOLT_TPU_DEVICE_TAIL", "ZOLT_TPU_LOG", "ZOLT_TPU_NO_NATIVE")


def load_bench(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def load_json(*parts) -> dict:
    with open(os.path.join(ZKBENCH, *parts)) as f:
        return json.load(f)


def cell_metrics(bench: dict, cell: str, kind: str) -> list[dict]:
    """The cell's metrics of one kind ("end_to_end" or "per_layer"): those
    that list it, and those that list no cells."""
    return [m for m in bench[kind] if cell in m.get("workloads", [cell])]


def read_metric(name: str, run) -> float | None:
    path = os.path.join(ZKBENCH, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"zkbench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(run)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


class Run:
    """What the metric readers read."""

    def __init__(self, cell):
        self.cell = cell
        self.setup_s = self.window_s = 0.0
        self.proves: list[dict] = []
        self.cycles_correct = 0
        self.trace = None
        self.peak_bytes = 0
        self.kernels: set[str] = set()

    def mean_span_s(self, names) -> float | None:
        done = [p for p in self.proves if p["blob"] is not None]
        seen = [sum(p["timings"].get(n, 0.0) for n in names) for p in done
                if any(n in p["timings"] for n in names)]
        return sum(seen) / len(seen) if seen else None


@contextmanager
def marked_spans(metrics):
    """Mark each of the program's metrics.stage spans in the profiler's
    trace, on the span registry the program already has."""
    import torch

    orig = metrics.stage

    @contextmanager
    def stage(name):
        with torch.profiler.record_function(trace.SPAN + name), orig(name):
            yield

    metrics.stage = stage
    try:
        yield
    finally:
        del metrics.stage


def prove_one(prove_jolt, metrics, path: str, index: int, config: dict,
              device, sync) -> dict:
    """One prove of the window: its serialized bytes and public I/O, or the
    error it raised."""
    metrics.reset()
    rec = {"index": index, "blob": None}
    t0 = time.perf_counter()
    try:
        res = prove_jolt(path, sound=config["sound"],
                         memory_size=config["memory_size"],
                         backend=config["backend"], device=device)
        proof = res.conv.proof
        rec.update(blob=proof.serialize(), trace_length=proof.trace_length,
                   outputs=bytes(res.emulator.device.outputs),
                   panic=bool(res.emulator.device.panic))
        del res, proof
        sync()
    except Exception:               # a failed prove is counted, not fatal
        rec["error"] = traceback.format_exc(limit=4)[-600:]
        print(f"prove {index} raised:\n{rec['error']}", file=sys.stderr)
    rec["seconds"] = time.perf_counter() - t0
    rec["timings"] = dict(metrics.timings)
    return rec


def run_cell(cell_name: str, seed: int, seconds: float, traced: bool, *,
             device: str = "cuda:0", t_start: float | None = None,
             bench: dict | None = None, config: dict | None = None,
             mix: dict | None = None, prove_jolt=None) -> dict:
    """Run the cell once and return its result line (a dict). `config`,
    `mix` and `prove_jolt` replace the cell's own where given (the tests
    run it small on the CPU, or with the timed path broken)."""
    t_start = time.perf_counter() if t_start is None else t_start
    bench = bench or load_bench()
    cell = next(w for w in bench["workloads"] if w["name"] == cell_name)
    config = config or load_json("configs", f"{cell['config']}.json")
    mix = mix or guest.load_mix(cell["traffic"], ZKBENCH)
    for k in PROGRAM_ENV:
        os.environ.pop(k, None)

    import torch

    from zolt_tpu_torch.utils.log import metrics
    from zolt_tpu_torch.zkvm import pipeline

    if pipeline.LOG_RAM_K != config["log_ram_k"]:
        raise RuntimeError(f"the program's RAM K is 2^{pipeline.LOG_RAM_K}, "
                           f"the configuration's 2^{config['log_ram_k']}")
    prove_jolt = prove_jolt or pipeline.prove_jolt
    on_cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_cuda else (lambda: None)
    run = Run(cell)
    run.kernels = trace.kernel_names(os.path.join(
        os.path.dirname(pipeline.__file__), "..", "csrc"))

    tmp = tempfile.mkdtemp(prefix="zkbench-")
    try:
        path_of = guest.elf_writer(mix, config["log_t"], seed, tmp)
        warm = prove_one(prove_jolt, metrics, path_of(-1), -1, config,
                         device, sync)
        if warm["blob"] is None:
            raise RuntimeError("the warm-up prove raised")
        run.setup_s = time.perf_counter() - t_start

        prof = None
        if traced:
            from torch.profiler import ProfilerActivity, profile

            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
        mark = (lambda n: torch.profiler.record_function(n)) if traced \
            else (lambda n: nullcontext())
        with prof if prof is not None else nullcontext(), \
                marked_spans(metrics) if traced else nullcontext(), \
                mark(trace.WINDOW):
            t0 = time.perf_counter()
            i = 0
            window = min(seconds, TRACE_WINDOW_S) if traced else seconds
            while True:
                with mark(trace.PROVE):
                    run.proves.append(prove_one(prove_jolt, metrics,
                                                path_of(i), i, config,
                                                device, sync))
                i += 1
                t1 = time.perf_counter()
                if t1 - t0 >= window:
                    break
        run.window_s = t1 - t0
        t_read = time.perf_counter()
        if on_cuda:
            run.peak_bytes = torch.cuda.max_memory_allocated(device)
            torch.cuda.empty_cache()
        if prof is not None:
            run.trace = trace.from_profiler(prof)
            del prof
        t_judge = time.perf_counter()
        checks, notes, bad = judge.judge(run.proves, path_of, config, seed)
        t_end = time.perf_counter()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    run.cycles_correct = sum(p["trace_length"] for p in run.proves
                             if p["blob"] is not None and p["index"] not in bad)
    failed = sum(1 for p in run.proves
                 if p["blob"] is None or p["index"] in bad)

    kind = "per_layer" if traced else "end_to_end"
    out = {}
    for m in cell_metrics(bench, cell_name, kind):
        v = read_metric(m["name"], run)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if on_cuda else "cpu",
           "count": cell["chips"], "memory_peak_bytes": run.peak_bytes}
    result = {"correct": judge.is_correct(checks),
              "attempted": len(run.proves), "failed": failed,
              "metrics": out, "device": dev}
    if run.trace is not None:
        dev["busy_s"] = trace.busy_s(run.trace)
        dev["window_s"] = run.trace.window_s
        result["breakdown"] = {
            "device_ops": [[n, s] for n, s in trace.device_ops(run.trace)[:10]],
            "idle_gaps": [[n, s] for n, s in trace.idle_gaps(run.trace)[:10]]}
    for n in notes[:20]:
        print(n, file=sys.stderr)
    secs = sorted(p["seconds"] for p in run.proves)
    print(f"setup {run.setup_s:.1f} s, window {run.window_s:.1f} s, "
          f"{len(run.proves)} proves of {secs[0]:.2f}-{secs[-1]:.2f} s "
          f"(median {secs[len(secs) // 2]:.2f}), "
          f"profiler stop {t_read - t1:.1f} s, trace read "
          f"{t_judge - t_read:.1f} s "
          f"({len(run.trace.device) if run.trace else 0} device ops), "
          f"judged in {t_end - t_judge:.1f} s", file=sys.stderr)
    result["checks"] = checks
    return result

