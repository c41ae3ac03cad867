"""Device-resident witness columns: raw upload, Montgomery-encode on device.

The port of zolt_tpu/parallel/device_cols.py. Witness value columns are
canonical u64s (8 B/elem), flag columns single bits, eq tables derive from a
handful of challenge scalars, and the stage combos (t = a + γ·b + γ²·c) are
linear in already-resident columns. So the raw forms go to the device once
per prove and every 32-byte Montgomery table is built there, in plain torch
field ops (field/limb.py): the JAX package runs these as XLA code, not as
Pallas kernels.

Bit-exactness: the device encode is mont_mul(x, R²) — the same REDC the
host C tier applies (fr_vec.c frv_from_u64/frv_to_mont), so every derived
table equals its FrVec counterpart byte for byte.
"""

from __future__ import annotations

import numpy as np
import torch

from ..field import limb
from ..field.params import FR
from .stage_engine import resolve_device

P = FR.p


def _consts(device) -> tuple[torch.Tensor, torch.Tensor]:
    """(R² raw words, 1 in Montgomery form) on `device`."""
    r2 = limb.ints_to_words([(1 << 512) % P])[0].to(device)
    return r2, limb.encode(1, device=device)


def _u64_words(x: np.ndarray) -> torch.Tensor:
    """(n,) uint64 -> (n, 8) raw words (zero-extended), CPU."""
    w = np.zeros((x.shape[0], 8), dtype=np.int32)
    w[:, :2] = np.ascontiguousarray(x, dtype=np.uint64).view(np.int32) \
        .reshape(-1, 2)
    return torch.from_numpy(w)


def _enc_u64(x: np.ndarray, device) -> torch.Tensor:
    """u64 values -> (n, 8) canonical Montgomery words: REDC-multiply the
    zero-extended raw words by R²."""
    r2, _one = _consts(device)
    return limb.mont_mul(_u64_words(x).to(device), r2)


def _enc_i128(lo: np.ndarray, hi: np.ndarray, device) -> torch.Tensor:
    """Signed values hi·2^64 + lo: encode the 128-bit magnitude by REDC with
    R² (exact for |v| < 2^128), then negate in the field where v < 0."""
    neg = hi < 0
    mag_lo = np.where(neg, np.uint64(0) - lo, lo)
    mag_hi = np.where(neg, (~hi.view(np.uint64)) + (lo == 0).astype(np.uint64),
                      hi.view(np.uint64))
    w = np.zeros((lo.shape[0], 8), dtype=np.int32)
    w[:, :2] = mag_lo.astype(np.uint64).view(np.int32).reshape(-1, 2)
    w[:, 2:4] = mag_hi.astype(np.uint64).view(np.int32).reshape(-1, 2)
    r2, _one = _consts(device)
    enc = limb.mont_mul(torch.from_numpy(w).to(device), r2)
    return limb.select(torch.from_numpy(neg).to(device), limb.neg(enc), enc)


def _enc_flags(bits: np.ndarray, device) -> torch.Tensor:
    """(n,) 0/1 -> (n, 8) Montgomery words (select of the 1R pattern)."""
    _r2, one = _consts(device)
    b = torch.from_numpy(np.ascontiguousarray(bits, dtype=np.uint8) != 0)
    return torch.where(b.to(device).unsqueeze(-1), one,
                       torch.zeros_like(one))


def eq_table_dev(point_be: list[int], device) -> torch.Tensor:
    """(2^nv, 8) eq table from BE challenge scalars, built by doubling on
    the device (variables consumed last to first; level = [e·(1−p) ‖ e·p]);
    bit-identical to FrVec.eq_table_be."""
    device = resolve_device(device)
    e = limb.encode([1], device=device)
    pts = limb.encode([c % P for c in point_be], device=device)
    for v in range(len(point_be) - 1, -1, -1):
        hi = limb.mont_mul(e, pts[v])
        e = torch.cat([limb.sub(e, hi), hi])
    return e


def eq_slice(point_be: list[int], n: int, device) -> torch.Tensor:
    """Device eq table truncated to the first n rows (stage provers clip
    eq tables to the padded trace length)."""
    e = eq_table_dev(point_be, device)
    return e if e.shape[0] == n else e[:n].contiguous()


def axpy_dev(a: torch.Tensor, b: torch.Tensor, coeff: int) -> torch.Tensor:
    """a + coeff·b over device word tensors (coeff a host int)."""
    g = limb.encode(coeff % P, device=a.device)
    return limb.add(a, limb.mont_mul(b, g))


def lincomb_dev(arrs: list, coeffs: list[int]) -> torch.Tensor:
    """Σ_k coeffs[k]·arrs[k] over device word tensors (host int coeffs)."""
    out = None
    for a, c in zip(arrs, coeffs):
        term = limb.mont_mul(a, limb.encode(c % P, device=a.device))
        out = term if out is None else limb.add(out, term)
    return out


class DeviceColumnStore:
    """Per-prove cache of device-resident Montgomery columns.

    put_* register raw host data; get() encodes on first use and caches the
    (n, 8) word tensor. combo() builds Σ γ^k·col_k on the device from
    resident columns and challenge scalars."""

    def __init__(self, device):
        self.device = resolve_device(device)
        self._raw: dict = {}
        self._dev: dict = {}

    def put_u64(self, key, arr: np.ndarray) -> None:
        self._raw[key] = ("u64", np.ascontiguousarray(arr, dtype=np.uint64))

    def put_i128(self, key, lo: np.ndarray, hi: np.ndarray) -> None:
        self._raw[key] = ("i128",
                          np.ascontiguousarray(lo, dtype=np.uint64),
                          np.ascontiguousarray(hi, dtype=np.int64))

    def put_flags(self, key, bits: np.ndarray) -> None:
        self._raw[key] = ("flag", np.ascontiguousarray(bits, dtype=np.uint8))

    def has(self, key) -> bool:
        return key in self._raw or key in self._dev

    def get(self, key) -> torch.Tensor:
        dev = self._dev.get(key)
        if dev is not None:
            return dev
        raw = self._raw[key]
        if raw[0] == "u64":
            dev = _enc_u64(raw[1], self.device)
        elif raw[0] == "i128":
            dev = _enc_i128(raw[1], raw[2], self.device)
        else:
            dev = _enc_flags(raw[1], self.device)
        self._dev[key] = dev
        return dev

    def combo(self, keys: list, coeffs: list[int]) -> torch.Tensor:
        """Σ_k coeffs[k]·col(keys[k]) on the device; coeffs[0] must be 1."""
        assert coeffs[0] % P == 1
        t = self.get(keys[0])
        for key, c in zip(keys[1:], coeffs[1:]):
            t = axpy_dev(t, self.get(key), c)
        return t


class WitnessStore(DeviceColumnStore):
    """DeviceColumnStore over r1cs.inputs.witness_columns' raw specs
    (witness_columns(raw_out=...)): u64/i128/flag columns plus the two
    derived specs — ("prod", a, b) = field product of two resident columns,
    ("splice", base, prod_key, mask) = where(mask, prod, base) (the MUL
    RightLookupOperand splice), and ("zeros",)."""

    def __init__(self, raw: dict, n: int, device):
        super().__init__(device)
        self._specs = raw
        self._n = n

    def get(self, key) -> torch.Tensor:
        dev = self._dev.get(key)
        if dev is not None:
            return dev
        if key not in self._raw and key in self._specs:
            spec = self._specs[key]
            kind = spec[0]
            if kind == "u64":
                self.put_u64(key, spec[1])
            elif kind == "i128":
                self.put_i128(key, spec[1], spec[2])
            elif kind == "flag":
                self.put_flags(key, spec[1])
            elif kind == "zeros":
                dev = torch.zeros((self._n, 8), dtype=torch.int32,
                                  device=self.device)
                self._dev[key] = dev
                return dev
            elif kind == "prod":
                dev = limb.mont_mul(self.get(spec[1]), self.get(spec[2]))
                self._dev[key] = dev
                return dev
            elif kind == "splice":
                base_key = (key, "base")
                self._specs[base_key] = spec[1]
                mask_key = (key, "mask")
                self._specs[mask_key] = spec[3]
                base = self.get(base_key)
                mask = torch.from_numpy(
                    np.asarray(self._specs[mask_key][1]) != 0).to(self.device)
                dev = limb.select(mask, self.get(spec[2]), base)
                self._dev[key] = dev
                return dev
            else:
                raise KeyError(f"unknown raw spec {kind}")
        return super().get(key)

    def _flag_bits(self, key) -> np.ndarray:
        spec = self._specs[key]
        assert spec[0] == "flag"
        return spec[1]

    def shifted_flag(self, key, fill: int = 1) -> torch.Tensor:
        """Montgomery column of flag(key) shifted one cycle left (value at
        cycle i becomes flag[i+1]; last entry = fill) — FrVec.shifted_left
        for flag raw specs (the NextIsNoop factor)."""
        ckey = (key, "shl", fill)
        dev = self._dev.get(ckey)
        if dev is None:
            bits = self._flag_bits(key)
            bits = np.concatenate([bits[1:], np.asarray([fill], np.uint8)])
            dev = self._dev[ckey] = _enc_flags(bits, self.device)
        return dev

    def shifted_flag_not(self, key, fill: int = 1) -> torch.Tensor:
        """Montgomery column of 1 − shifted_flag(key, fill) — the
        (1 − NextIsNoop) factor of the fused right column, encoded in one
        pass from the complement bits."""
        ckey = (key, "shl_not", fill)
        dev = self._dev.get(ckey)
        if dev is None:
            bits = self._flag_bits(key)
            bits = np.concatenate([bits[1:], np.asarray([fill], np.uint8)])
            dev = self._dev[ckey] = _enc_flags(
                (bits == 0).astype(np.uint8), self.device)
        return dev

    def flags_not(self, key) -> torch.Tensor:
        """Montgomery column of 1 − flag(key) (flag raw specs only)."""
        ckey = (key, "not")
        dev = self._dev.get(ckey)
        if dev is None:
            dev = self._dev[ckey] = _enc_flags(
                (self._flag_bits(key) == 0).astype(np.uint8), self.device)
        return dev
