"""Small host-side utilities (reference src/utils/mod.zig).

The reference's ThreadPool/parallelFor have no analog here — parallelism is
XLA's job (vmap/jit on device, shard_map across the mesh). What carries over
is the bit-slicing helper used by lookup-table indexing (`LookupBits`,
utils/mod.zig:16-135), the phase timer (`Timer`, :195-218), and integer
helpers (:159-186).
"""

from __future__ import annotations

import time


class LookupBits:
    """Fixed-width bit-string view over an integer with MSB-first slicing
    (reference utils/mod.zig:16): pop from the top, split prefix/suffix,
    interleave/uninterleave operand pairs."""

    __slots__ = ("value", "width")

    def __init__(self, value: int, width: int):
        self.width = width
        self.value = value & ((1 << width) - 1) if width else 0

    def __len__(self) -> int:
        return self.width

    def __int__(self) -> int:
        return self.value

    def pop_msb(self) -> int:
        assert self.width > 0
        self.width -= 1
        bit = (self.value >> self.width) & 1
        self.value &= (1 << self.width) - 1
        return bit

    def split(self, suffix_len: int) -> tuple["LookupBits", "LookupBits"]:
        """(prefix, suffix) with `suffix_len` low bits in the suffix."""
        assert 0 <= suffix_len <= self.width
        suffix = LookupBits(self.value, suffix_len)
        prefix = LookupBits(self.value >> suffix_len, self.width - suffix_len)
        return prefix, suffix

    def uninterleave(self) -> tuple["LookupBits", "LookupBits"]:
        """Even bits (from MSB side) -> x, odd bits -> y."""
        assert self.width % 2 == 0
        half = self.width // 2
        x = y = 0
        for i in range(half):
            x |= ((self.value >> (2 * i + 1)) & 1) << i
            y |= ((self.value >> (2 * i)) & 1) << i
        return LookupBits(x, half), LookupBits(y, half)

    @staticmethod
    def interleave(x: int, y: int, half_width: int) -> "LookupBits":
        v = 0
        for i in range(half_width):
            v |= ((x >> i) & 1) << (2 * i + 1)
            v |= ((y >> i) & 1) << (2 * i)
        return LookupBits(v, 2 * half_width)


class Timer:
    """Monotonic phase timer (reference utils/mod.zig:195)."""

    def __init__(self):
        self.t0 = time.perf_counter()

    def elapsed_s(self) -> float:
        return time.perf_counter() - self.t0

    def elapsed_ms(self) -> float:
        return self.elapsed_s() * 1e3

    def lap(self, label: str = "") -> float:
        dt = self.elapsed_s()
        self.t0 = time.perf_counter()
        return dt


def next_power_of_two(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def ceil_log2(n: int) -> int:
    return 0 if n <= 1 else (n - 1).bit_length()


def require_cuda(device, who: str) -> None:
    """Raise where `device` names CUDA and there is none: work that runs
    on the card by default never falls back to the CPU."""
    import torch

    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who} runs on the GPU by default and there is "
                           f"no CUDA device; pass device='cpu' for the "
                           f"kernels' plain torch versions")
