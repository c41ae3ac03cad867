"""Kernels 2 and 3: round evaluations of a k-factor product sumcheck.

    evals[t] = Σ_{i < live_pairs} Π_j (lo_j[i] + t·(hi_j[i] − lo_j[i]))
    t = 0..degree,  lo_j[i] = tabs[j][2i],  hi_j[i] = tabs[j][2i+1]

returned as (degree+1, 8) Montgomery words. `product_evals` is the wrapper
of the k = 2 and k = 3 instantiations of csrc/product_evals.cu (which
replace zolt_tpu/field/pallas_redc.py eval_rows_k2 and eval_rows_k3 with
their host decodes): on a CUDA tensor it launches the kernel or raises, on
a CPU tensor it runs `product_evals_plain`. `product_evals.launches[k]`
counts the launches of each instantiation.
"""

from __future__ import annotations

import torch

from .. import _build
from ..poly.dense import sum_mod
from . import limb

MAX_DEGREE = 3
_THREADS = 128
_MAX_BLOCKS = 1024


def _check(tabs: torch.Tensor, live_pairs: int, degree: int) -> None:
    if tabs.dtype != torch.int32 or tabs.dim() != 3 or tabs.shape[2] != 8:
        raise ValueError(f"product evals take (k, n, 8) int32 tables, got "
                         f"{tuple(tabs.shape)} {tabs.dtype}")
    if not tabs.is_contiguous():
        raise ValueError("product evals take contiguous tables")
    n = tabs.shape[1]
    if n % 2 or not 0 <= live_pairs <= n // 2:
        raise ValueError(f"live_pairs {live_pairs} out of range for n = {n}")
    if not 0 <= degree <= MAX_DEGREE:
        raise ValueError(f"degree {degree} > {MAX_DEGREE}")


def product_evals_plain(tabs: torch.Tensor, live_pairs: int,
                        degree: int) -> torch.Tensor:
    """The torch version of kernels 2-3 (any k, any device)."""
    k = tabs.shape[0]
    if live_pairs == 0:
        return torch.zeros((degree + 1, 8), dtype=torch.int32,
                           device=tabs.device)
    pairs = tabs[:, : 2 * live_pairs].reshape(k, live_pairs, 2, 8)
    v, d = pairs[:, :, 0], limb.sub(pairs[:, :, 1], pairs[:, :, 0])
    outs = []
    for t in range(degree + 1):
        if t:
            v = limb.add(v, d)
        prod = v[0]
        for j in range(1, k):
            prod = limb.mont_mul(prod, v[j])
        outs.append(sum_mod(prod))
    return torch.stack(outs)


def _launch(tabs: torch.Tensor, live_pairs: int, degree: int) -> torch.Tensor:
    if tabs.device.type != "cuda":
        raise ValueError(f"product evals have no kernel for {tabs.device}")
    if tabs.data_ptr() % 16:
        raise ValueError("product evals need 16-byte aligned tables")
    k, n = tabs.shape[0], tabs.shape[1]
    nblocks = max(1, min(_MAX_BLOCKS, -(-live_pairs // _THREADS)))
    partials = torch.empty((nblocks * (MAX_DEGREE + 1), 8),
                           dtype=torch.int32, device=tabs.device)
    out = torch.empty((degree + 1, 8), dtype=torch.int32, device=tabs.device)
    with torch.cuda.device(tabs.device):
        rc = _build.kernels().lib.zfr_product_evals(
            tabs.data_ptr(), k, n, live_pairs, degree, partials.data_ptr(),
            nblocks, out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _build.check(rc, f"product_evals k={k}")
    return out


def product_evals(tabs: torch.Tensor, live_pairs: int,
                  degree: int) -> torch.Tensor:
    """(degree+1, 8) round evals of the k tables in `tabs` (k, n, 8)."""
    _check(tabs, live_pairs, degree)
    k = tabs.shape[0]
    if k not in product_evals.launches:
        raise ValueError(f"product evals have kernels for k = 2, 3, not {k}")
    if tabs.device.type == "cpu":
        return product_evals_plain(tabs, live_pairs, degree)
    out = _launch(tabs, live_pairs, degree)
    product_evals.launches[k] += 1
    return out


product_evals.launches = {2: 0, 3: 0}
