"""Build and load the port's native code.

Two libraries are built on first use into `zolt_tpu_torch/_build/` (listed
in .gitignore), never next to the sources:

- the host C tier (native/*.c, built by native/__init__.py with `cc`);
- the Hopper kernels (csrc/*.cu: the Fr sumcheck kernels, the G1
  kernels and the field inversion), built here with nvcc for sm_90a into one
  shared library with a plain C interface and bound with ctypes. Its file
  name carries a hash of the sources, so an edited kernel is never served
  from a stale build.

Nothing here runs at import time: the CPU tests import every module on
machines that have no nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
KERNEL_SOURCES = ("fold.cu", "product_evals.cu", "product_evals_any.cu",
                  "gruen_round.cu", "g1.cu", "rows_msm.cu", "pippenger.cu",
                  "field_inv.cu")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def build_dir() -> str:
    """The package's build directory, created on demand."""
    d = os.path.join(_PKG, "_build")
    os.makedirs(d, exist_ok=True)
    return d


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


class KernelLib:
    """The loaded kernel library plus what its build reported."""

    def __init__(self, lib: ctypes.CDLL, path: str, build_s: float,
                 ptxas_log: str):
        self.lib = lib
        self.path = path
        self.build_s = build_s          # 0.0 when an existing build loaded
        self.ptxas_log = ptxas_log


_KERNELS: KernelLib | None = None


def _sources_digest() -> str:
    h = hashlib.sha256()
    for name in sorted(os.listdir(CSRC)):
        if name.endswith((".cu", ".cuh")):
            with open(os.path.join(CSRC, name), "rb") as f:
                h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def kernels() -> KernelLib:
    """Build (first use) and load csrc/*.cu; raises if nvcc fails."""
    global _KERNELS
    if _KERNELS is not None:
        return _KERNELS
    so = os.path.join(build_dir(), f"libzolt_kernels.{_sources_digest()}.so")
    log_path = so + ".log"
    build_s = 0.0
    if not os.path.exists(so):
        tmp = f"{so}.{os.getpid()}.tmp"       # concurrent builders never share it
        nvcc = _nvcc()
        t0 = time.perf_counter()
        # one nvcc per source, all at once, then one link
        objs = [f"{tmp}.{s}.o" for s in KERNEL_SOURCES]
        procs = [subprocess.Popen(
            [nvcc] + NVCC_FLAGS + ["-c", "-o", o, os.path.join(CSRC, s)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for s, o in zip(KERNEL_SOURCES, objs)]
        logs = [p.communicate()[0] for p in procs]
        log = "".join(logs)
        if any(p.returncode for p in procs):
            raise RuntimeError(f"nvcc failed:\n{log[-4000:]}")
        link = subprocess.run([nvcc, "-shared", "-o", tmp] + objs,
                              capture_output=True, text=True)
        build_s = time.perf_counter() - t0
        for o in objs:
            os.remove(o)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{link.stderr[-4000:]}")
        with open(log_path, "w") as f:
            f.write(log + link.stdout + link.stderr)
        os.replace(tmp, so)
    ptxas_log = ""
    if os.path.exists(log_path):
        with open(log_path) as f:
            ptxas_log = f.read()
    lib = ctypes.CDLL(so)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.zfr_fold.argtypes = [P, I, P]
    lib.zfr_fold.restype = I
    lib.zfr_product_evals.argtypes = [P, I, P, P]
    lib.zfr_product_evals.restype = I
    lib.zfr_product_evals_any.argtypes = [P, I, P, P]
    lib.zfr_product_evals_any.restype = I
    lib.zfr_gruen_round.argtypes = [P, P]
    lib.zfr_gruen_round.restype = I
    L = ctypes.c_longlong
    lib.zg1_add.argtypes = [P] * 9 + [L, P]
    lib.zg1_add.restype = I
    lib.zg1_double.argtypes = [P] * 6 + [L, P]
    lib.zg1_double.restype = I
    lib.zg1_sum.argtypes = [P] * 6 + [L, I, I, P]
    lib.zg1_sum.restype = I
    lib.zg1_row_msm.argtypes = [P, L, I, I, I, P, P, P, P, P, P]
    lib.zg1_row_msm.restype = I
    lib.zg1_bucket_accumulate.argtypes = [P, P, P, I, P, P, I] + [P] * 7
    lib.zg1_bucket_accumulate.restype = I
    lib.zg1_window_sums.argtypes = [P, P, P, I, P, P, P, P]
    lib.zg1_window_sums.restype = I
    lib.zg1_scalar_digits.argtypes = [P, L, P, P]
    lib.zg1_scalar_digits.restype = I
    lib.zfr_pow_fixed.argtypes = [P, P, L, P, I, I, P]
    lib.zfr_pow_fixed.restype = I
    lib.zfr_batch_inverse.argtypes = [P, P, L, I, I, P]
    lib.zfr_batch_inverse.restype = I
    _KERNELS = KernelLib(lib, so, build_s, ptxas_log)
    return _KERNELS


def check(rc: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a kernel entry point."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")
