"""Kernel 4: the eq-weighted (Gruen) round evals [t0, t∞].

    t0 = Σ_{i < live_pairs} e_i · az[2i] · bz[2i]
    t∞ = Σ_{i < live_pairs} e_i · (az[2i+1] − az[2i]) · (bz[2i+1] − bz[2i])
    e_i = E_out[off_out + (i >> h_in)] · E_in[off_in + (i & (2^h_in − 1))]

over the flat prefix-table stacks E_out/E_in, returned as (2, 8) Montgomery
words. `gruen_eval` is the wrapper: on CUDA tensors it launches
csrc/gruen_eval.cu (which replaces the eval half of
zolt_tpu/field/pallas_kernels.py product_round and its production form,
zolt_tpu/zkvm/device_outer.py _eval_fixed) or raises; on CPU tensors it
runs `gruen_eval_plain`. `gruen_eval.launches` counts kernel launches.
"""

from __future__ import annotations

import torch

from .. import _build
from ..poly.dense import sum_mod
from . import limb

_THREADS = 128
_MAX_BLOCKS = 1024


def _check(az, bz, e_out, e_in, off_out: int, off_in: int, h_in: int,
           live_pairs: int) -> None:
    for name, t in (("az", az), ("bz", bz), ("e_out", e_out), ("e_in", e_in)):
        if t.dtype != torch.int32 or t.dim() != 2 or t.shape[1] != 8:
            raise ValueError(f"gruen_eval takes (n, 8) int32 {name}, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"gruen_eval takes a contiguous {name}")
        if t.device != az.device:
            raise ValueError(f"{name} is on {t.device}, az on {az.device}")
    if az.shape != bz.shape or az.shape[0] % 2:
        raise ValueError("az and bz must share an even length")
    if not 0 <= live_pairs <= az.shape[0] // 2:
        raise ValueError(f"live_pairs {live_pairs} out of range")
    last = live_pairs - 1
    if live_pairs and not (
            0 <= h_in < 63
            and 0 <= off_out and off_out + (last >> h_in) < e_out.shape[0]
            and 0 <= off_in
            and off_in + min(last, (1 << h_in) - 1) < e_in.shape[0]):
        raise ValueError("eq level offsets reach past the E_out/E_in stacks")


def gruen_eval_plain(az, bz, e_out, e_in, off_out: int, off_in: int,
                     h_in: int, live_pairs: int) -> torch.Tensor:
    """The torch version of kernel 4 (any device)."""
    if live_pairs == 0:
        return torch.zeros((2, 8), dtype=torch.int32, device=az.device)
    idx = torch.arange(live_pairs, device=az.device)
    e = limb.mont_mul(e_out[off_out + (idx >> h_in)],
                      e_in[off_in + (idx & ((1 << h_in) - 1))])
    a = az[: 2 * live_pairs].reshape(live_pairs, 2, 8)
    b = bz[: 2 * live_pairs].reshape(live_pairs, 2, 8)
    a0, a1, b0, b1 = a[:, 0], a[:, 1], b[:, 0], b[:, 1]
    t0 = sum_mod(limb.mont_mul(e, limb.mont_mul(a0, b0)))
    tinf = sum_mod(limb.mont_mul(e, limb.mont_mul(limb.sub(a1, a0),
                                                  limb.sub(b1, b0))))
    return torch.stack([t0, tinf])


def gruen_eval(az, bz, e_out, e_in, off_out: int, off_in: int, h_in: int,
               live_pairs: int) -> torch.Tensor:
    _check(az, bz, e_out, e_in, off_out, off_in, h_in, live_pairs)
    if az.device.type == "cpu":
        return gruen_eval_plain(az, bz, e_out, e_in, off_out, off_in, h_in,
                                live_pairs)
    if az.device.type != "cuda":
        raise ValueError(f"gruen_eval has no kernel for {az.device}")
    if any(t.data_ptr() % 16 for t in (az, bz, e_out, e_in)):
        raise ValueError("gruen_eval needs 16-byte aligned tensors")
    nblocks = max(1, min(_MAX_BLOCKS, -(-live_pairs // _THREADS)))
    partials = torch.empty((2 * nblocks, 8), dtype=torch.int32,
                           device=az.device)
    out = torch.empty((2, 8), dtype=torch.int32, device=az.device)
    with torch.cuda.device(az.device):
        rc = _build.kernels().lib.zfr_gruen_eval(
            az.data_ptr(), bz.data_ptr(), e_out.data_ptr(), e_in.data_ptr(),
            off_out, off_in, h_in, live_pairs, partials.data_ptr(), nblocks,
            out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "gruen_eval")
    gruen_eval.launches += 1
    return out


gruen_eval.launches = 0
