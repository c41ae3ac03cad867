"""FrVec: batch Fr vectors over the native runtime (fr_vec.c), with a pure-
Python fallback.

The host prover tier's hot loops — eq-table construction, challenge folds,
per-round product-evaluation sums (SURVEY §5.7's structures) — all operate on
Fr arrays. FrVec keeps those arrays as native Montgomery byte buffers across
rounds so only per-round scalars (challenges in, round-poly evaluations out)
cross the Python boundary. Every op has a list-of-ints fallback (set
ZOLT_TPU_NO_NATIVE=1) and tests/test_native.py differentially checks the two.

Results are exact mod p either way, so proofs remain byte-identical.

Buffer discipline: this environment's allocator makes large bytes copies
pathologically slow (~5 MB/s for b"".join / bytes(bytearray)), so every
native call passes the backing bytearray zero-copy via ctypes.from_buffer,
folds shrink in place, and int<->bytes conversion happens element-wise
through a memoryview only at construction/extraction.
"""

from __future__ import annotations

import ctypes

from ..field.params import FR


def _tune_malloc() -> None:
    """Keep large FrVec buffers on the glibc heap instead of per-allocation
    mmaps. Every fresh mmap'd buffer (a 2^22 column is 134 MB) pays a page
    fault per 4 KiB on first touch, and on this Firecracker box a fault
    costs ~20 us — 0.7 s per column allocation, superlinear witness-gen
    growth (BENCH.md round 4). Raising M_MMAP_THRESHOLD/M_TRIM_THRESHOLD
    makes glibc serve and REUSE those chunks from the heap free list, so
    pages fault once per process instead of once per op. Measured: 42 s ->
    ~15 s witness build at T=2^22."""
    import ctypes as _ct

    try:
        libc = _ct.CDLL("libc.so.6", use_errno=True)
        libc.mallopt(-3, 1 << 30)   # M_MMAP_THRESHOLD
        libc.mallopt(-1, 1 << 30)   # M_TRIM_THRESHOLD
    except Exception:
        pass


_tune_malloc()

P = FR.p


def _get_lib():
    from . import get_lib

    lib = get_lib()
    return lib if lib is not None and getattr(lib, "_frv_ready", False) else None


_ARRT: dict[int, type] = {}


def _buf(b: bytearray):
    """Zero-copy pointer to a bytearray's storage. c_char_p.from_param
    accepts a c_char array directly, so with a cached array type per length
    this skips both the per-call type creation and the ctypes.cast (~5x
    cheaper; _buf runs thousands of times per prove)."""
    n = len(b)
    t = _ARRT.get(n)
    if t is None:
        t = _ARRT[n] = ctypes.c_char * n
    return t.from_buffer(b)


def _bufp(b: bytearray) -> ctypes.c_char_p:
    """As _buf but a real c_char_p, for (c_char_p * k) pointer arrays whose
    element assignment bypasses from_param."""
    return ctypes.cast(_buf(b), ctypes.c_char_p)


def _pack(vals: list[int]) -> bytearray:
    out = bytearray(32 * len(vals))
    mv = memoryview(out)
    for i, v in enumerate(vals):
        mv[i * 32:(i + 1) * 32] = (v % P).to_bytes(32, "little")
    return out


def _unpack(buf: bytearray, n: int) -> list[int]:
    return [int.from_bytes(buf[i * 32:(i + 1) * 32], "little") for i in range(n)]


class FrVec:
    """A length-n Fr vector. Native: Montgomery 32-byte LE limbs in a
    bytearray (owned; ops may mutate/shrink it in place). Fallback:
    canonical ints in a list."""

    __slots__ = ("n", "_mont", "_ints")

    def __init__(self, n: int, mont: bytearray | None = None,
                 ints: list[int] | None = None):
        self.n = n
        self._mont = mont
        self._ints = ints

    # -- construction -------------------------------------------------
    @classmethod
    def from_ints(cls, vals: list[int]) -> "FrVec":
        lib = _get_lib()
        n = len(vals)
        if lib is None:
            return cls(n, ints=[v % P for v in vals])
        try:
            # u64 fast path (RAM words, masks, lookup operands): one
            # struct.pack instead of n int.to_bytes calls
            import struct

            raw = struct.pack("<%dQ" % n, *vals)
            out = bytearray(32 * n)
            lib.frv_from_u64(raw, n, _buf(out))
            return cls(n, mont=out)
        except struct.error:
            pass
        buf = _pack(vals)
        p = _buf(buf)
        lib.frv_to_mont(p, n, p)  # elementwise: in-place alias is safe
        return cls(n, mont=buf)

    @classmethod
    def from_u64_array(cls, arr) -> "FrVec":
        """From a numpy uint64 array (zero-copy ingest via frv_from_u64).
        0/1 flag columns (roughly half the witness columns) skip the
        per-element Montgomery multiply: a masked row write of the constant
        one-in-Montgomery pattern is bit-identical and memcpy-fast."""
        import ctypes

        import numpy as np

        lib = _get_lib()
        n = len(arr)
        if lib is None:
            return cls(n, ints=[int(v) for v in arr])
        arr = np.ascontiguousarray(arr, dtype=np.uint64)
        if n and int(arr.max()) <= 1:
            out = bytearray(32 * n)
            pos = np.flatnonzero(arr)
            if pos.size:
                one = bytes(_mont_scalars([1]))
                view = np.frombuffer(out, dtype=np.uint8).reshape(n, 32)
                view[pos] = np.frombuffer(one, dtype=np.uint8)
            return cls(n, mont=out)
        out = bytearray(32 * n)
        # pass the numpy buffer directly: .tobytes() is a Python-level
        # copy (~5 MB/s on this box) that dominated witness ingest
        lib.frv_from_u64(ctypes.cast(arr.ctypes.data, ctypes.c_char_p),
                         n, _buf(out))
        return cls(n, mont=out)

    @classmethod
    def from_i128_arrays(cls, lo, hi) -> "FrVec":
        """From value[i] = hi[i]·2^64 + lo[i] (numpy uint64 lo, int64 hi;
        negatives wrap mod p). The columnar witness builder's ingest for
        columns that are not u64-safe (immediates, fused lookup operands)."""
        import ctypes

        import numpy as np

        lib = _get_lib()
        lo = np.ascontiguousarray(lo, dtype=np.uint64)
        hi = np.ascontiguousarray(hi, dtype=np.int64)
        n = len(lo)
        if lib is None:
            return cls(n, ints=[(int(h) * (1 << 64) + int(v)) % P
                                for v, h in zip(lo.tolist(), hi.tolist())])
        out = bytearray(32 * n)
        lib.frv_from_i128(lo.ctypes.data_as(ctypes.c_void_p),
                          hi.ctypes.data_as(ctypes.c_void_p), n, _buf(out))
        return cls(n, mont=out)

    @classmethod
    def zeros(cls, n: int) -> "FrVec":
        lib = _get_lib()
        if lib is None:
            return cls(n, ints=[0] * n)
        return cls(n, mont=bytearray(32 * n))  # 0 is 0 in Montgomery form

    @classmethod
    def filled(cls, n: int, value: int) -> "FrVec":
        lib = _get_lib()
        if lib is None:
            return cls(n, ints=[value % P] * n)
        return cls(n, mont=bytearray(bytes(_mont_scalars([value])) * n))

    @staticmethod
    def interleave(a: "FrVec", b: "FrVec") -> "FrVec":
        """[a0, b0, a1, b1, ...]"""
        lib = _get_lib()
        if lib is None or a._mont is None or b._mont is None:
            ai = a._ints if a._ints is not None else a.to_ints()
            bi = b._ints if b._ints is not None else b.to_ints()
            out = [0] * (2 * a.n)
            out[0::2] = ai
            out[1::2] = bi
            return FrVec(2 * a.n, ints=out)
        out = bytearray(64 * a.n)
        lib.frv_interleave(_buf(a._mont), _buf(b._mont), a.n, _buf(out))
        return FrVec(2 * a.n, mont=out)

    @staticmethod
    def triple_inner(e: "FrVec", a: "FrVec", b: "FrVec") -> int:
        """Σ_i e[i]·a[i]·b[i]"""
        lib = _get_lib()
        if lib is None or e._mont is None or a._mont is None or b._mont is None:
            ei = e._ints if e._ints is not None else e.to_ints()
            ai = a._ints if a._ints is not None else a.to_ints()
            bi = b._ints if b._ints is not None else b.to_ints()
            return sum(x * y % P * z for x, y, z in zip(ei, ai, bi)) % P
        out = bytearray(32)
        lib.frv_triple_inner(_buf(e._mont), _buf(a._mont), _buf(b._mont), e.n,
                             _buf(out))
        return _from_mont_list(out, 1)[0]

    @classmethod
    def indicator(cls, n: int, positions) -> "FrVec":
        """0/1 vector with 1 at the given positions (sparse one-hot build)."""
        lib = _get_lib()
        if lib is None:
            out = [0] * n
            for p in positions:
                out[p] = 1
            return cls(n, ints=out)
        import numpy as np

        one = _mont_scalars([1])
        buf = bytearray(32 * n)
        pos = np.fromiter(positions, dtype=np.int64)
        if pos.size:
            view = np.frombuffer(buf, dtype=np.uint8).reshape(n, 32)
            view[pos] = np.frombuffer(bytes(one), dtype=np.uint8)
        return cls(n, mont=buf)

    @classmethod
    def eq_table_be(cls, point: list[int]) -> "FrVec":
        """eq(point, j) for all j; point[0] owns the MSB of j."""
        lib = _get_lib()
        nv = len(point)
        if lib is None:
            out = [1]
            for t in reversed(point):
                t %= P
                nxt = [0] * (2 * len(out))
                for i, v in enumerate(out):
                    hi = v * t % P
                    nxt[i + len(out)] = hi
                    nxt[i] = (v - hi) % P
                out = nxt
            return cls(1 << nv, ints=out)
        pm = _mont_scalars(point)
        out = bytearray(32 << nv)
        lib.frv_eq_table_be(_buf(pm), nv, _buf(out))
        return cls(1 << nv, mont=out)

    def shifted_left(self, fill: int = 0) -> "FrVec":
        """[a1, ..., a_{n-1}, fill] — the next-cycle view of a column."""
        if self._mont is not None:
            out = bytearray(32 * self.n)
            out[: 32 * (self.n - 1)] = memoryview(self._mont)[32: 32 * self.n]
            if fill % P:
                out[32 * (self.n - 1):] = bytes(_mont_scalars([fill]))
            return FrVec(self.n, mont=out)
        return FrVec(self.n, ints=self._ints[1:] + [fill % P])

    def copy(self) -> "FrVec":
        if self._mont is not None:
            # memoryview slice -> single copy (bytearray(slice) would copy twice)
            return FrVec(self.n,
                         mont=bytearray(memoryview(self._mont)[: 32 * self.n]))
        return FrVec(self.n, ints=list(self._ints))

    # -- boundary -----------------------------------------------------
    def to_ints(self) -> list[int]:
        if self._mont is None:
            return list(self._ints)
        lib = _get_lib()
        out = bytearray(32 * self.n)
        lib.frv_from_mont(_buf(self._mont), self.n, _buf(out))
        return _unpack(out, self.n)

    def to_canonical_bytes(self) -> bytearray:
        """Canonical 32-byte LE scalars, one native from_mont pass (no
        per-element Python int round-trip — the commit/open fast path)."""
        out = bytearray(32 * self.n)
        if self._mont is None:
            mv = memoryview(out)
            for i, v in enumerate(self._ints):
                mv[i * 32:(i + 1) * 32] = (v % P).to_bytes(32, "little")
            return out
        lib = _get_lib()
        lib.frv_from_mont(_buf(self._mont), self.n, _buf(out))
        return out

    def zero_padded_copy(self, n: int) -> "FrVec":
        """Fresh length-n copy with a zero tail (Montgomery zero is the zero
        byte string, so padding is a prefix memcpy)."""
        assert n >= self.n
        if self._mont is not None:
            buf = bytearray(32 * n)
            buf[: 32 * self.n] = self._mont[: 32 * self.n]
            return FrVec(n, mont=buf)
        return FrVec(n, ints=self._ints + [0] * (n - self.n))

    def __len__(self) -> int:
        return self.n

    def get(self, i: int) -> int:
        """Canonical value of element i (sparse random access; ~1 µs/read —
        fine for entry-sparse provers, not for dense scans)."""
        if self._mont is None:
            return self._ints[i]
        lib = _get_lib()
        out = bytearray(32)
        lib.frv_from_mont(_buf(self._mont[i * 32:(i + 1) * 32]), 1, _buf(out))
        return int.from_bytes(out, "little")

    def first(self) -> int:
        """Canonical value of element 0 (sumcheck finals)."""
        if self._mont is None:
            return self._ints[0]
        lib = _get_lib()
        out = bytearray(32)
        lib.frv_from_mont(_buf(self._mont), 1, _buf(out))
        return int.from_bytes(out, "little")

    # -- folds (consume self: the backing buffer may be reused) ---------
    def fold_adj(self, r: int) -> "FrVec":
        """new[i] = a[2i] + r·(a[2i+1] − a[2i]); halves the length.

        Output goes to a fresh buffer: the adjacent-pair access pattern makes
        an in-place parallel fold race across OpenMP chunks (chunk k's writes
        at i overlap chunk k−1's reads at 2i). fold_half IS alias-safe."""
        if self._mont is None:
            a = self._ints
            return FrVec(self.n // 2,
                         ints=[(a[2 * i] + r * (a[2 * i + 1] - a[2 * i])) % P
                               for i in range(self.n // 2)])
        lib = _get_lib()
        out = bytearray(32 * (self.n // 2))
        lib.frv_fold_adj(_buf(self._mont), self.n, _buf(_mont_scalars([r])),
                         _buf(out))
        return FrVec(self.n // 2, mont=out)

    @staticmethod
    def fold_adj_rows_(rows: list["FrVec"], live_n: int, r: int) -> None:
        """In-place adjacent fold of the first live_n elements of MANY rows
        in one native call, parallelized across rows with zero allocation
        (tails go stale; callers track the live prefix). The per-round
        multi-table bind primitive for wide provers (stage-4 registers)."""
        lib = _get_lib()
        if lib is None or any(v._mont is None for v in rows):
            for v in rows:
                v.fold_adj_prefix_(r, live_n)
            return
        arr = (ctypes.c_char_p * len(rows))()
        for i, v in enumerate(rows):
            arr[i] = _bufp(v._mont)
        lib.frv_fold_adj_rows(arr, len(rows), live_n, _buf(_mont_scalars([r])))

    def fold_adj_prefix_(self, r: int, active_n: int) -> None:
        """In-place: fold the first active_n elements' adjacent pairs into
        the prefix, leaving the tail STALE and the length unchanged (the
        byte-exact RWC prover's in-place fold semantics read past the fold
        frontier)."""
        if self._mont is None:
            a = self._ints
            half = active_n // 2
            for i in range(half):
                a[i] = (a[2 * i] + r * (a[2 * i + 1] - a[2 * i])) % P
            return
        lib = _get_lib()
        lib.frv_fold_adj_prefix(_buf(self._mont), active_n,
                                _buf(_mont_scalars([r])))

    def fold_half(self, r: int) -> "FrVec":
        """new[i] = a[i] + r·(a[i+h] − a[i]), h = n/2; halves the length."""
        if self._mont is None:
            a, h = self._ints, self.n // 2
            return FrVec(h, ints=[(a[i] + r * (a[i + h] - a[i])) % P
                                  for i in range(h)])
        lib = _get_lib()
        p = _buf(self._mont)
        lib.frv_fold_half(p, self.n, _buf(_mont_scalars([r])), p)
        return FrVec(self.n // 2, mont=self._mont)

    def fold_half_fresh(self, r: int) -> "FrVec":
        """fold_half into a NEW half-size buffer, leaving self untouched
        (copy-on-write first fold for tables shared between claims)."""
        if self._mont is None:
            a, h = self._ints, self.n // 2
            return FrVec(h, ints=[(a[i] + r * (a[i + h] - a[i])) % P
                                  for i in range(h)])
        lib = _get_lib()
        out = bytearray(32 * (self.n // 2))
        lib.frv_fold_half(_buf(self._mont), self.n, _buf(_mont_scalars([r])),
                          _buf(out))
        return FrVec(self.n // 2, mont=out)

    # -- round sums -----------------------------------------------------
    @staticmethod
    def prod_evals_adj(vecs: list["FrVec"], degree: int) -> list[int]:
        """[Σ_i Π_k (lo_k + t·(hi_k−lo_k)) for t in 0..degree], adjacent
        pairs. All vecs must share a length."""
        k, n = len(vecs), vecs[0].n
        lib = _get_lib()
        if lib is None or k > 40 or degree > 40 \
                or any(v._mont is None for v in vecs):
            tabs = [v._ints if v._ints is not None else v.to_ints() for v in vecs]
            out = []
            for t in range(degree + 1):
                s = 0
                for i in range(n // 2):
                    prod = 1
                    for tab in tabs:
                        lo, hi = tab[2 * i], tab[2 * i + 1]
                        prod = prod * ((lo + t * (hi - lo)) % P) % P
                    s = (s + prod) % P
                out.append(s)
            return out
        ptrs = (ctypes.c_char_p * k)(*[_bufp(v._mont) for v in vecs])
        outb = bytearray(32 * (degree + 1))
        lib.frv_prod_evals_adj(ptrs, k, n, degree, _buf(outb))
        return _from_mont_list(outb, degree + 1)

    @staticmethod
    def prod_evals_half(vecs: list["FrVec"], degree: int) -> list[int]:
        k, n = len(vecs), vecs[0].n
        lib = _get_lib()
        if lib is None or any(v._mont is None for v in vecs):
            tabs = [v._ints if v._ints is not None else v.to_ints() for v in vecs]
            h = n // 2
            out = []
            for t in range(degree + 1):
                s = 0
                for i in range(h):
                    prod = 1
                    for tab in tabs:
                        lo, hi = tab[i], tab[i + h]
                        prod = prod * ((lo + t * (hi - lo)) % P) % P
                    s = (s + prod) % P
                out.append(s)
            return out
        ptrs = (ctypes.c_char_p * k)(*[_bufp(v._mont) for v in vecs])
        outb = bytearray(32 * (degree + 1))
        lib.frv_prod_evals_half(ptrs, k, n, degree, _buf(outb))
        return _from_mont_list(outb, degree + 1)

    @staticmethod
    def quad_sums_half(f: "FrVec", e: "FrVec") -> tuple[int, int]:
        """(Σ e[j]f[j], Σ (2f[j+h]−f[j])(2e[j+h]−e[j])), h = n/2."""
        lib = _get_lib()
        if lib is None or f._mont is None or e._mont is None:
            ft = f._ints if f._ints is not None else f.to_ints()
            et = e._ints if e._ints is not None else e.to_ints()
            h = f.n // 2
            a0 = a2 = 0
            for j in range(h):
                a0 += et[j] * ft[j]
                a2 += (2 * ft[j + h] - ft[j]) * (2 * et[j + h] - et[j])
            return a0 % P, a2 % P
        outb = bytearray(64)
        lib.frv_quad_sums_half(_buf(f._mont), _buf(e._mont), f.n, _buf(outb))
        vals = _from_mont_list(outb, 2)
        return vals[0], vals[1]

    # -- elementwise ------------------------------------------------------
    def _bin(self, other: "FrVec", cfn: str, pyfn) -> "FrVec":
        lib = _get_lib()
        if lib is None or self._mont is None or other._mont is None:
            a = self._ints if self._ints is not None else self.to_ints()
            b = other._ints if other._ints is not None else other.to_ints()
            return FrVec(self.n, ints=[pyfn(x, y) for x, y in zip(a, b)])
        out = bytearray(32 * self.n)
        getattr(lib, cfn)(_buf(self._mont), _buf(other._mont), self.n, _buf(out))
        return FrVec(self.n, mont=out)

    def add(self, other: "FrVec") -> "FrVec":
        return self._bin(other, "frv_vec_add", lambda x, y: (x + y) % P)

    def sub(self, other: "FrVec") -> "FrVec":
        return self._bin(other, "frv_vec_sub", lambda x, y: (x - y) % P)

    def mul(self, other: "FrVec") -> "FrVec":
        return self._bin(other, "frv_vec_mul", lambda x, y: x * y % P)

    @staticmethod
    def lincomb(cols: list["FrVec"], coeffs: list[int]) -> "FrVec":
        """Σ_i coeffs[i]·cols[i] in one fused pass."""
        lib = _get_lib()
        k = len(cols)
        assert len(coeffs) == k and k > 0
        n = cols[0].n
        if lib is None or any(c._mont is None for c in cols):
            out = FrVec.zeros(n)
            for c, col in zip(coeffs, cols):
                if c % P:
                    out.axpy_(col, c)
            return out
        ptrs = (ctypes.c_char_p * k)(*[_bufp(c._mont) for c in cols])
        cm = _mont_scalars(coeffs)
        out = bytearray(32 * n)
        lib.frv_lincomb(ptrs, _buf(cm), k, n, _buf(out))
        return FrVec(n, mont=out)

    def axpy_(self, x: "FrVec", c: int) -> "FrVec":
        """self += c·x, in place."""
        lib = _get_lib()
        if lib is None or self._mont is None or x._mont is None:
            a = self._ints if self._ints is not None else self.to_ints()
            b = x._ints if x._ints is not None else x.to_ints()
            self._ints = [(u + c * v) % P for u, v in zip(a, b)]
            self._mont = None
            return self
        lib.frv_axpy(_buf(self._mont), _buf(x._mont), _buf(_mont_scalars([c])),
                     min(self.n, x.n))
        return self

    def scale(self, c: int) -> "FrVec":
        lib = _get_lib()
        if lib is None or self._mont is None:
            return FrVec(self.n, ints=[v * c % P for v in self._ints])
        out = bytearray(32 * self.n)
        lib.frv_scale(_buf(self._mont), _buf(_mont_scalars([c])), self.n, _buf(out))
        return FrVec(self.n, mont=out)

    def inner(self, other: "FrVec") -> int:
        lib = _get_lib()
        if lib is None or self._mont is None or other._mont is None:
            a = self._ints if self._ints is not None else self.to_ints()
            b = other._ints if other._ints is not None else other.to_ints()
            return sum(x * y for x, y in zip(a, b)) % P
        out = bytearray(32)
        lib.frv_inner(_buf(self._mont), _buf(other._mont), self.n, _buf(out))
        return _from_mont_list(out, 1)[0]

    def sum(self) -> int:
        lib = _get_lib()
        if lib is None or self._mont is None:
            return sum(self._ints) % P
        out = bytearray(32)
        lib.frv_sum(_buf(self._mont), self.n, _buf(out))
        return _from_mont_list(out, 1)[0]

    @staticmethod
    def bool_round(eq_b: "FrVec", eq_hw: "FrVec", oh: "FrVec") -> tuple[list[int], list[int]]:
        """([Σ e_b(t)·x(t)·(1−x(t)) for t in 0..3],
            [Σ e_hw(t)·x(t) for t in 0..3]) over adjacent pairs."""
        lib = _get_lib()
        if lib is None or eq_b._mont is None or eq_hw._mont is None or oh._mont is None:
            eb = eq_b._ints if eq_b._ints is not None else eq_b.to_ints()
            eh = eq_hw._ints if eq_hw._ints is not None else eq_hw.to_ints()
            x = oh._ints if oh._ints is not None else oh.to_ints()
            A = [0] * 4
            B = [0] * 4
            for i in range(eq_b.n // 2):
                for t in range(4):
                    ebv = (eb[2 * i] + t * (eb[2 * i + 1] - eb[2 * i])) % P
                    ehv = (eh[2 * i] + t * (eh[2 * i + 1] - eh[2 * i])) % P
                    xv = (x[2 * i] + t * (x[2 * i + 1] - x[2 * i])) % P
                    A[t] = (A[t] + ebv * xv % P * ((1 - xv) % P)) % P
                    B[t] = (B[t] + ehv * xv) % P
            return A, B
        out = bytearray(256)
        lib.frv_bool_round(_buf(eq_b._mont), _buf(eq_hw._mont), _buf(oh._mont),
                           eq_b.n, _buf(out))
        v = _from_mont_list(out, 8)
        return v[:4], v[4:]

    @staticmethod
    def s4_phase1(e_out: "FrVec", e_in: "FrVec", head_in: int, ra_rows, wa_rows,
                  val_rows, inc: "FrVec", T: int) -> tuple[int, int]:
        """Stage-4 registers phase-1 (q0, qX2)."""
        lib = _get_lib()
        if lib is None:
            eo, ei = e_out.to_ints(), e_in.to_ints()
            incl = inc.to_ints()
            rai = [r.to_ints() for r in ra_rows]
            wai = [w.to_ints() for w in wa_rows]
            vali = [v.to_ints() for v in val_rows]
            mask = (1 << head_in) - 1
            q0 = qX2 = 0
            for i in range(T // 2):
                E = eo[i >> head_in] * ei[i & mask] % P
                inc0 = incl[2 * i]
                incs = incl[2 * i + 1] - inc0
                c0 = cX = 0
                for k in range(len(ra_rows)):
                    ra_e, ra_o = rai[k][2 * i], rai[k][2 * i + 1]
                    wa_e, wa_o = wai[k][2 * i], wai[k][2 * i + 1]
                    v_e, v_o = vali[k][2 * i], vali[k][2 * i + 1]
                    c0 += ra_e * v_e + wa_e * (v_e + inc0)
                    cX += ((ra_o - ra_e) * (v_o - v_e)
                           + (wa_o - wa_e) * (v_o - v_e + incs))
                q0 = (q0 + E * c0) % P
                qX2 = (qX2 + E * cX) % P
            return q0, qX2
        ptr = lambda rows: (ctypes.c_char_p * len(rows))(*[_bufp(r._mont) for r in rows])
        out = bytearray(64)
        lib.frv_s4_phase1(_buf(e_out._mont), _buf(e_in._mont), head_in,
                          ptr(ra_rows), ptr(wa_rows), ptr(val_rows),
                          _buf(inc._mont), len(ra_rows), T, _buf(out))
        v = _from_mont_list(out, 2)
        return v[0], v[1]

    @staticmethod
    def s4_phase2(eq: "FrVec", inc: "FrVec", ra_rows, wa_rows, val_rows,
                  pairs: int, T: int) -> tuple[int, int]:
        lib = _get_lib()
        if lib is None:
            eqi, incl = eq.to_ints(), inc.to_ints()
            rai = [r.to_ints() for r in ra_rows]
            wai = [w.to_ints() for w in wa_rows]
            vali = [v.to_ints() for v in val_rows]
            e0 = e2 = 0
            for i in range(pairs):
                ke, ko = 2 * i, 2 * i + 1
                for j in range(T):
                    c0 = rai[ke][j] * vali[ke][j] + wai[ke][j] * (vali[ke][j] + incl[j])
                    e0 = (e0 + eqi[j] * c0) % P
                    ra2 = 2 * rai[ko][j] - rai[ke][j]
                    wa2 = 2 * wai[ko][j] - wai[ke][j]
                    v2 = 2 * vali[ko][j] - vali[ke][j]
                    e2 = (e2 + eqi[j] * (ra2 * v2 + wa2 * (v2 + incl[j]))) % P
            return e0, e2
        ptr = lambda rows: (ctypes.c_char_p * len(rows))(*[_bufp(r._mont) for r in rows])
        out = bytearray(64)
        lib.frv_s4_phase2(_buf(eq._mont), _buf(inc._mont), ptr(ra_rows),
                          ptr(wa_rows), ptr(val_rows), pairs, T, _buf(out))
        v = _from_mont_list(out, 2)
        return v[0], v[1]

    @staticmethod
    def s4_phase3(eq: "FrVec", inc: "FrVec", ra_rows, wa_rows, val_rows,
                  T: int) -> tuple[int, int, int]:
        lib = _get_lib()
        if lib is None:
            eqi, incl = eq.to_ints(), inc.to_ints()
            rai = [r.to_ints() for r in ra_rows]
            wai = [w.to_ints() for w in wa_rows]
            vali = [v.to_ints() for v in val_rows]
            out3 = [0, 0, 0]
            for j in range(T // 2):
                inc0 = incl[2 * j]
                incs = incl[2 * j + 1] - inc0
                eq0 = eqi[2 * j]
                eqs = eqi[2 * j + 1] - eq0
                for ti, t in enumerate((0, 2, 3)):
                    s = 0
                    for k in range(len(ra_rows)):
                        ra_t = rai[k][2 * j] + t * (rai[k][2 * j + 1] - rai[k][2 * j])
                        wa_t = wai[k][2 * j] + t * (wai[k][2 * j + 1] - wai[k][2 * j])
                        v_t = vali[k][2 * j] + t * (vali[k][2 * j + 1] - vali[k][2 * j])
                        s += ra_t * v_t + wa_t * (v_t + inc0 + t * incs)
                    out3[ti] = (out3[ti] + (eq0 + t * eqs) * s) % P
            return out3[0], out3[1], out3[2]
        ptr = lambda rows: (ctypes.c_char_p * len(rows))(*[_bufp(r._mont) for r in rows])
        out = bytearray(96)
        lib.frv_s4_phase3(_buf(eq._mont), _buf(inc._mont), ptr(ra_rows),
                          ptr(wa_rows), ptr(val_rows), len(ra_rows), T, _buf(out))
        v = _from_mont_list(out, 3)
        return v[0], v[1], v[2]

    @staticmethod
    def raf_sums(ra: "FrVec") -> tuple[int, int, int, int]:
        """(Σ ra[2i], Σ ra[2i]·i, Σ (2ra[2i+1]−ra[2i]), Σ (2ra[2i+1]−ra[2i])·i)
        over adjacent pairs, all mod p (stage-2 RamRafEvaluation rounds)."""
        lib = _get_lib()
        if lib is None or ra._mont is None:
            t = ra._ints if ra._ints is not None else ra.to_ints()
            s_lo = s_lo_i = s_2 = s_2_i = 0
            for i in range(ra.n // 2):
                lo, hi = t[2 * i], t[2 * i + 1]
                ra2 = 2 * hi - lo
                s_lo += lo
                s_lo_i += lo * i
                s_2 += ra2
                s_2_i += ra2 * i
            return s_lo % P, s_lo_i % P, s_2 % P, s_2_i % P
        out = bytearray(128)
        lib.frv_raf_sums(_buf(ra._mont), ra.n, _buf(out))
        v = _from_mont_list(out, 4)
        return v[0], v[1], v[2], v[3]

    @staticmethod
    def gruen_quad(e_out: "FrVec", e_in: "FrVec", head_in: int,
                   left: "FrVec", right: "FrVec", num_groups: int) -> tuple[int, int]:
        """Windowed Gruen quadratic sums (t0, tinf): pairs indexed
        g = (x_out << head_in) | x_in, skipping g ≥ num_groups."""
        lib = _get_lib()
        if (lib is None or e_out._mont is None or e_in._mont is None
                or left._mont is None or right._mont is None):
            eo = e_out._ints if e_out._ints is not None else e_out.to_ints()
            ei = e_in._ints if e_in._ints is not None else e_in.to_ints()
            lt = left._ints if left._ints is not None else left.to_ints()
            rt = right._ints if right._ints is not None else right.to_ints()
            t0 = tinf = 0
            for xo, vo in enumerate(eo):
                inner0 = innerI = 0
                for xi, vi in enumerate(ei):
                    g = (xo << head_in) | xi
                    if g >= num_groups:
                        continue
                    inner0 = (inner0 + lt[2 * g] * rt[2 * g] % P * vi) % P
                    innerI = (innerI + (lt[2 * g + 1] - lt[2 * g])
                              * (rt[2 * g + 1] - rt[2 * g]) % P * vi) % P
                t0 = (t0 + inner0 * vo) % P
                tinf = (tinf + innerI * vo) % P
            return t0, tinf
        out = bytearray(64)
        lib.frv_gruen_quad(_buf(e_out._mont), e_out.n, _buf(e_in._mont), e_in.n,
                           head_in, _buf(left._mont), _buf(right._mont),
                           num_groups, _buf(out))
        v = _from_mont_list(out, 2)
        return v[0], v[1]

    def mle_eval_be(self, point: list[int]) -> int:
        """Evaluate as an MLE at a big-endian point (len(point) vars);
        shorter tables are zero-padded to 2^len(point)."""
        lib = _get_lib()
        if lib is None or self._mont is None:
            t = self._ints if self._ints is not None else self.to_ints()
            t = list(t)
            nv = len(point)
            if len(t) < (1 << nv):
                t += [0] * ((1 << nv) - len(t))
            for p_i in point:
                h = len(t) // 2
                t = [(t[i] + p_i * (t[i + h] - t[i])) % P for i in range(h)]
            return t[0]
        nv = len(point)
        scratch = bytearray(32 << nv)
        scratch[: 32 * self.n] = self._mont[: 32 * self.n]
        out = bytearray(32)
        pm = _mont_scalars(point)
        lib.frv_mle_eval_be(_buf(scratch), 1 << nv, _buf(pm), nv, _buf(out))
        return _from_mont_list(out, 1)[0]

    @staticmethod
    def moment(e: "FrVec", cols_a: list, cols_b: list) -> list[int]:
        """M[a][b] = Σ_i e[i]·A_a[i]·B_b[i], returned flat (ka·kb ints) —
        the UniSkip first round's quadratic-form kernel."""
        lib = _get_lib()
        ka, kb = len(cols_a), len(cols_b)
        n = e.n
        if lib is None or e._mont is None or any(
                c._mont is None for c in cols_a + cols_b):
            ei = e._ints if e._ints is not None else e.to_ints()
            ai = [c._ints if c._ints is not None else c.to_ints()
                  for c in cols_a]
            bi = [c._ints if c._ints is not None else c.to_ints()
                  for c in cols_b]
            out = [0] * (ka * kb)
            for i in range(n):
                ev = ei[i]
                for a in range(ka):
                    ea = ev * ai[a][i] % P
                    for b in range(kb):
                        out[a * kb + b] = (out[a * kb + b]
                                           + ea * bi[b][i]) % P
            return out
        pa = (ctypes.c_char_p * ka)(*[_bufp(c._mont) for c in cols_a])
        pb = (ctypes.c_char_p * kb)(*[_bufp(c._mont) for c in cols_b])
        out = bytearray(32 * ka * kb)
        lib.frv_moment(_buf(e._mont), pa, pb, ka, kb, n, _buf(out))
        return _from_mont_list(out, ka * kb)

    # -- stage-8 category primitives (zkvm/lookups_raf.py phase A) ---------

    @staticmethod
    def cat_wsum(wt: "FrVec", x, cat, ncat: int) -> list[int]:
        """Per-category weighted sums: out[c] = Σ_{i: cat[i]==c} wt[i]·x[i].
        `x` is an FrVec, a numpy uint64 array (canonical values), or None
        (plain Σ wt per category). `cat` is a numpy uint16 array."""
        import ctypes as _ct

        import numpy as _np

        cat = _np.ascontiguousarray(cat, dtype=_np.uint16)
        lib = _get_lib()
        if lib is None or wt._mont is None or (
                isinstance(x, FrVec) and x._mont is None):
            w = wt._ints if wt._ints is not None else wt.to_ints()
            if isinstance(x, FrVec):
                xv = x._ints if x._ints is not None else x.to_ints()
            elif x is None:
                xv = None
            else:
                xv = [int(v) for v in x]
            out = [0] * ncat
            for i in range(wt.n):
                v = w[i] if xv is None else w[i] * xv[i] % P
                out[cat[i]] = (out[cat[i]] + v) % P
            return out
        out = bytearray(32 * ncat)
        x_fr = None
        x_u64 = None
        if isinstance(x, FrVec):
            x_fr = _buf(x._mont)
        elif x is not None:
            xa = _np.ascontiguousarray(x, dtype=_np.uint64)
            x_u64 = xa.ctypes.data_as(_ct.c_void_p)
        lib.frv_cat_wsum(_buf(wt._mont), x_fr, x_u64,
                         ctypes.cast(cat.ctypes.data, ctypes.c_char_p), wt.n, ncat, _buf(out))
        return _from_mont_list(out, ncat)

    def scale_by_cat_(self, cat, consts: list[int]) -> "FrVec":
        """self[i] *= consts[cat[i]], in place."""
        import numpy as _np

        cat = _np.ascontiguousarray(cat, dtype=_np.uint16)
        lib = _get_lib()
        if lib is None or self._mont is None:
            a = self._ints if self._ints is not None else self.to_ints()
            self._ints = [a[i] * consts[cat[i]] % P for i in range(self.n)]
            self._mont = None
            return self
        lib.frv_scale_by_cat(_buf(self._mont),
                             ctypes.cast(cat.ctypes.data, ctypes.c_char_p), self.n,
                             _buf(_mont_scalars([c % P for c in consts])))
        return self

    def add_by_cat_(self, cat, consts: list[int]) -> "FrVec":
        """self[i] += consts[cat[i]], in place."""
        import numpy as _np

        cat = _np.ascontiguousarray(cat, dtype=_np.uint16)
        lib = _get_lib()
        if lib is None or self._mont is None:
            a = self._ints if self._ints is not None else self.to_ints()
            self._ints = [(a[i] + consts[cat[i]]) % P for i in range(self.n)]
            self._mont = None
            return self
        lib.frv_add_by_cat(_buf(self._mont),
                           ctypes.cast(cat.ctypes.data, ctypes.c_char_p), self.n,
                           _buf(_mont_scalars([c % P for c in consts])))
        return self


_SCALAR_MEMO: dict[int, bytearray] = {}


def _mont_scalars(vals: list[int]) -> bytearray:
    lib = _get_lib()
    if len(vals) == 1:
        # per-round fold challenges convert once, not once per table
        v = vals[0] % P
        hit = _SCALAR_MEMO.get(v)
        if hit is not None:
            return hit
    out = _pack(vals)
    p = _buf(out)
    lib.frv_to_mont(p, len(vals), p)
    if len(vals) == 1:
        if len(_SCALAR_MEMO) > 64:
            _SCALAR_MEMO.clear()
        _SCALAR_MEMO[vals[0] % P] = out
    return out


def _from_mont_list(buf: bytearray, n: int) -> list[int]:
    lib = _get_lib()
    out = bytearray(32 * n)
    lib.frv_from_mont(_buf(buf), n, _buf(out))
    return _unpack(out, n)
