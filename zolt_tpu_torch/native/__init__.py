"""Native BN254 runtime loader.

Compiles `bn254.c` with the system C compiler on first use (cached in the
package's build directory, `zolt_tpu_torch/_build/`), loads it via ctypes,
and injects the tower constants from the Python implementation so the two
cannot drift. Every entry point has a pure-Python fallback; set ZOLT_TPU_NO_NATIVE=1 to force it (CI determinism or an
environment without a toolchain).

The Python tower/pairing code remains the oracle — tests/test_native.py
differentially checks every native op against it on random inputs, and the
golden-proof byte-exactness tests gate the integration end to end.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

_LIB = None
_TRIED = False


def _constants_blob() -> bytes:
    from ..curve import pairing as pr
    from ..field import tower as tw
    from ..field.params import FP

    P = FP.p
    R2 = (1 << 512) % P
    ninv = (-pow(P, -1, 1 << 64)) % (1 << 64)

    def fp_b(x: int) -> bytes:
        return (x % P).to_bytes(32, "little")

    def fp2_b(x) -> bytes:
        return fp_b(x[0]) + fp_b(x[1])

    return (P.to_bytes(32, "little") + fp_b(R2) + ninv.to_bytes(8, "little")
            + fp_b(pow(2, -1, P))
            + fp2_b(tw._G6_1) + fp2_b(tw._G6_2) + fp2_b(tw._GW)
            + fp2_b(pr._GAMMA12) + fp2_b(pr._GAMMA13) + fp2_b(pr._TWIST_B))


def _fr_constants_blob() -> bytes:
    from ..field.params import FR

    p = FR.p
    r2 = (1 << 512) % p
    ninv = (-pow(p, -1, 1 << 64)) % (1 << 64)
    return (p.to_bytes(32, "little") + r2.to_bytes(32, "little")
            + ninv.to_bytes(8, "little"))


def _build_and_load():
    from .._build import build_dir

    src_dir = os.path.dirname(os.path.abspath(__file__))
    srcs = [os.path.join(src_dir, "bn254.c"), os.path.join(src_dir, "fr_vec.c"),
            os.path.join(src_dir, "rv64.c")]
    so = os.path.join(build_dir(), "libbn254.so")
    if (not os.path.exists(so)
            or any(os.path.getmtime(so) < os.path.getmtime(s) for s in srcs)):
        cc = os.environ.get("CC", "cc")
        # a per-process temporary: test workers may build at the same time
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [cc, "-O3", "-fomit-frame-pointer", "-shared", "-fPIC",
               "-o", tmp] + srcs
        try:
            subprocess.run(cmd + ["-fopenmp"], check=True, capture_output=True)
        except subprocess.CalledProcessError:
            subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, so)
    lib = ctypes.CDLL(so)
    lib.bn254_init.argtypes = [ctypes.c_char_p]
    lib.bn254_multi_pairing.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                        ctypes.c_char_p, ctypes.c_int,
                                        ctypes.c_char_p]
    lib.bn254_fp12_pow.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p]
    lib.bn254_g1_msm.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                 ctypes.c_int, ctypes.c_char_p]
    lib.bn254_g2_msm.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                 ctypes.c_int, ctypes.c_char_p]
    lib.bn254_g2_batch_mul.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                       ctypes.c_int, ctypes.c_char_p]
    lib.bn254_g1_fold.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                  ctypes.c_char_p, ctypes.c_long, ctypes.c_char_p]
    lib.bn254_g2_fold.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                  ctypes.c_char_p, ctypes.c_long, ctypes.c_char_p]
    lib.bn254_g2_precompute.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                        ctypes.c_char_p]
    lib.bn254_g2_precompute.restype = ctypes.c_int
    lib.bn254_multi_pairing_pre.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                            ctypes.c_char_p, ctypes.c_int,
                                            ctypes.c_char_p]
    lib.bn254_g1_msm_rows.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                      ctypes.c_int, ctypes.c_int, ctypes.c_char_p]
    lib.bn254_g1_msm_rows_u64.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                          ctypes.c_int, ctypes.c_int,
                                          ctypes.c_char_p]
    lib.bn254_g1_subset_tables_mont.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                                ctypes.c_char_p, ctypes.c_char_p]
    lib.bn254_init(_constants_blob())
    C, L, I = ctypes.c_char_p, ctypes.c_long, ctypes.c_int
    lib.frv_init.argtypes = [C]
    lib.frv_from_u64.argtypes = [C, L, C]
    lib.frv_from_i128.argtypes = [ctypes.c_void_p, ctypes.c_void_p, L, C]
    lib.frv_to_mont.argtypes = [C, L, C]
    lib.frv_from_mont.argtypes = [C, L, C]
    lib.frv_eq_table_be.argtypes = [C, I, C]
    lib.frv_fold_adj.argtypes = [C, L, C, C]
    lib.frv_fold_adj_prefix.argtypes = [C, L, C]
    lib.frv_fold_adj_rows.argtypes = [ctypes.POINTER(ctypes.c_char_p),
                                      ctypes.c_int, L, C]
    lib.frv_fold_half.argtypes = [C, L, C, C]
    lib.frv_quad_sums_half.argtypes = [C, C, L, C]
    PP = ctypes.POINTER(ctypes.c_char_p)
    lib.frv_prod_evals_adj.argtypes = [PP, I, L, I, C]
    lib.frv_prod_evals_half.argtypes = [PP, I, L, I, C]
    lib.frv_vec_add.argtypes = [C, C, L, C]
    lib.frv_vec_sub.argtypes = [C, C, L, C]
    lib.frv_vec_mul.argtypes = [C, C, L, C]
    lib.frv_axpy.argtypes = [C, C, C, L]
    lib.frv_lincomb.argtypes = [PP, C, I, L, C]
    lib.frv_scale.argtypes = [C, C, L, C]
    lib.frv_inner.argtypes = [C, C, L, C]
    lib.frv_sum.argtypes = [C, L, C]
    lib.frv_mle_eval_be.argtypes = [C, L, C, I, C]
    lib.frv_raf_sums.argtypes = [C, L, C]
    lib.frv_gruen_quad.argtypes = [C, L, C, L, I, C, C, L, C]
    lib.frv_bool_round.argtypes = [C, C, C, L, C]
    lib.frv_interleave.argtypes = [C, C, L, C]
    lib.frv_s4_phase1.argtypes = [C, C, I, PP, PP, PP, C, I, L, C]
    lib.frv_s4_phase2.argtypes = [C, C, PP, PP, PP, L, L, C]
    lib.frv_s4_phase3.argtypes = [C, C, PP, PP, PP, I, L, C]
    lib.frv_triple_inner.argtypes = [C, C, C, L, C]
    lib.frv_cat_wsum.argtypes = [C, C, ctypes.c_void_p, C, L, I, C]
    lib.frv_moment.argtypes = [C, PP, PP, I, I, L, C]
    lib.frv_scale_by_cat.argtypes = [C, C, L, C]
    lib.frv_add_by_cat.argtypes = [C, C, L, C]
    lib.frv_init(_fr_constants_blob())
    lib._frv_ready = True
    return lib


_TRACE_LIB = None
_TRACE_TRIED = False


def get_trace_lib():
    """The trace-materializer extension (trace_mat.c), or None. Built
    separately from libbn254.so because it needs the CPython headers and must
    be loaded with PyDLL (its entry points run under the GIL)."""
    global _TRACE_LIB, _TRACE_TRIED
    if _TRACE_TRIED:
        return _TRACE_LIB
    _TRACE_TRIED = True
    if os.environ.get("ZOLT_TPU_NO_NATIVE"):
        return None
    try:
        import sys
        import sysconfig

        from .._build import build_dir

        src_dir = os.path.dirname(os.path.abspath(__file__))
        src = os.path.join(src_dir, "trace_mat.c")
        # The ABI tag in the filename guarantees a prebuilt .so from a
        # different CPython (this library pokes PyTupleObject internals)
        # is never loaded — the mtime check alone can't catch a fresh
        # checkout where src and a stale binary share a timestamp.
        so = os.path.join(
            build_dir(), f"libtrace_mat.{sys.implementation.cache_tag}.so")
        if (not os.path.exists(so)
                or os.path.getmtime(so) < os.path.getmtime(src)):
            cc = os.environ.get("CC", "cc")
            inc = sysconfig.get_paths()["include"]
            tmp = f"{so}.{os.getpid()}.tmp"
            subprocess.run([cc, "-O2", "-shared", "-fPIC", f"-I{inc}",
                            "-o", tmp, src],
                           check=True, capture_output=True)
            os.replace(tmp, so)
        lib = ctypes.PyDLL(so)
        lib.trace_materialize.restype = ctypes.py_object
        lib.trace_materialize.argtypes = [ctypes.py_object, ctypes.c_void_p,
                                          ctypes.c_ssize_t]
        lib.mem_materialize.restype = ctypes.py_object
        lib.mem_materialize.argtypes = [ctypes.py_object, ctypes.c_void_p,
                                        ctypes.c_ssize_t]
        _TRACE_LIB = lib
    except Exception as e:
        import sys

        print(f"[zolt-tpu] trace materializer unavailable ({e!r}); using the "
              f"Python fallback", file=sys.stderr)
        _TRACE_LIB = None
    return _TRACE_LIB


def get_lib():
    """The loaded native library, or None if unavailable/disabled."""
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    if os.environ.get("ZOLT_TPU_NO_NATIVE"):
        return None
    try:
        _LIB = _build_and_load()
    except Exception as e:  # degrade to pure Python, but never silently
        import sys

        detail = ""
        if isinstance(e, subprocess.CalledProcessError):
            detail = (e.stderr or b"").decode(errors="replace")[-400:]
        print(f"[zolt-tpu] native runtime unavailable ({e!r}); falling back "
              f"to pure Python (10-100x slower). {detail}", file=sys.stderr)
        _LIB = None
    return _LIB


# ---------------------------------------------------------------------------
# High-level wrappers (same conventions as the Python code: points are
# (x, y) int tuples or None; GT elements are the tower's nested tuples)
# ---------------------------------------------------------------------------

def multi_pairing_native(pairs):
    """Π e(Pᵢ, Qᵢ) with one final exponentiation; None on fallback needed."""
    lib = get_lib()
    if lib is None:
        return None
    from ..field import tower as tw

    g1b, g2b, mask = bytearray(), bytearray(), bytearray()
    n = 0
    for p, q in pairs:
        if p is None or q is None:
            continue
        g1b += int(p[0]).to_bytes(32, "little") + int(p[1]).to_bytes(32, "little")
        (x0, x1), (y0, y1) = q
        g2b += (int(x0).to_bytes(32, "little") + int(x1).to_bytes(32, "little")
                + int(y0).to_bytes(32, "little") + int(y1).to_bytes(32, "little"))
        mask.append(1)
        n += 1
    out = ctypes.create_string_buffer(384)
    lib.bn254_multi_pairing(bytes(g1b), bytes(g2b), bytes(mask), n, out)
    return _gt_from_coeff_bytes(out.raw)


def _gt_from_coeff_bytes(b: bytes):
    cs = [int.from_bytes(b[i * 32:(i + 1) * 32], "little") for i in range(12)]
    return (((cs[0], cs[1]), (cs[2], cs[3]), (cs[4], cs[5])),
            ((cs[6], cs[7]), (cs[8], cs[9]), (cs[10], cs[11])))


def _gt_to_coeff_bytes(gt) -> bytes:
    out = b""
    for fp6c in gt:
        for fp2c in fp6c:
            out += int(fp2c[0]).to_bytes(32, "little") + int(fp2c[1]).to_bytes(32, "little")
    return out


def fp12_pow_native(gt, e: int):
    lib = get_lib()
    if lib is None or e < 0 or e >= 1 << 256:
        return None
    out = ctypes.create_string_buffer(384)
    lib.bn254_fp12_pow(_gt_to_coeff_bytes(gt), int(e).to_bytes(32, "little"), out)
    return _gt_from_coeff_bytes(out.raw)


def g1_msm_native(points, scalars):
    """Σ sᵢ·Pᵢ over G1 (affine int-tuple points, canonical int scalars)."""
    lib = get_lib()
    if lib is None:
        return None
    from ..field.params import FR

    pb, sb = bytearray(), bytearray()
    n = 0
    for p, s in zip(points, scalars):
        s = s % FR.p
        if p is None or s == 0:
            continue
        pb += int(p[0]).to_bytes(32, "little") + int(p[1]).to_bytes(32, "little")
        sb += s.to_bytes(32, "little")
        n += 1
    if n == 0:
        return None
    out = ctypes.create_string_buffer(65)
    lib.bn254_g1_msm(bytes(pb), bytes(sb), n, out)
    if out.raw[0] == 0:
        return None
    return (int.from_bytes(out.raw[1:33], "little"),
            int.from_bytes(out.raw[33:65], "little"))


def _g1_from_out(raw: bytes):
    if raw[0] == 0:
        return None
    return (int.from_bytes(raw[1:33], "little"),
            int.from_bytes(raw[33:65], "little"))


def _g2_from_out(raw: bytes):
    if raw[0] == 0:
        return None
    return ((int.from_bytes(raw[1:33], "little"),
             int.from_bytes(raw[33:65], "little")),
            (int.from_bytes(raw[65:97], "little"),
             int.from_bytes(raw[97:129], "little")))


# Precomputed Miller-line cache for FIXED G2 vectors (Dory SRS): the ate
# schedule is point-independent, so each SRS point's line coefficients are
# computed once and every subsequent pairing against it skips all G2 point
# arithmetic; the multi-pairing also shares one accumulator across pairs.
_G2_LINE_CACHE: dict = {}
_LINE_REC = 192  # 3 fp2 of raw Montgomery limbs per line record


def _g2_pack(points) -> bytes:
    out = bytearray(128 * len(points))
    mv = memoryview(out)
    for i, q in enumerate(points):
        if q is None:
            continue
        (x0, x1), (y0, y1) = q
        mv[i * 128:i * 128 + 32] = int(x0).to_bytes(32, "little")
        mv[i * 128 + 32:i * 128 + 64] = int(x1).to_bytes(32, "little")
        mv[i * 128 + 64:i * 128 + 96] = int(y0).to_bytes(32, "little")
        mv[i * 128 + 96:i * 128 + 128] = int(y1).to_bytes(32, "little")
    return bytes(out)


def multi_pairing_fixed_native(g1_points, g2_vec, n: int):
    """Π_{i<n} e(g1_points[i], g2_vec[i]) using cached precomputed lines for
    g2_vec (keyed by object identity, fingerprint-validated). Returns the GT
    tower tuple, or None on fallback."""
    lib = get_lib()
    if lib is None:
        return None
    key = id(g2_vec)
    fp_first = g2_vec[0] if g2_vec else None
    ent = _G2_LINE_CACHE.get(key)
    if ent is None or ent[0] is not g2_vec or ent[1] < n:
        m = len(g2_vec)
        packed = _g2_pack(g2_vec)
        # probe line count with a zero-size call contract: lines is fixed
        lines = lib.bn254_g2_precompute(b"\x00" * 128, 0, b"")
        buf = ctypes.create_string_buffer(m * lines * _LINE_REC)
        lib.bn254_g2_precompute(packed, m, buf)
        ent = (g2_vec, m, lines, buf)
        _G2_LINE_CACHE[key] = ent
        if len(_G2_LINE_CACHE) > 8:
            for k in list(_G2_LINE_CACHE):
                if k != key:
                    del _G2_LINE_CACHE[k]
    _, m, lines, buf = ent
    n = min(n, m, len(g1_points))
    g1b = bytearray(64 * n)
    mask = bytearray(n)
    mv = memoryview(g1b)
    for i in range(n):
        p = g1_points[i]
        if p is None:
            continue
        mv[i * 64:i * 64 + 32] = int(p[0]).to_bytes(32, "little")
        mv[i * 64 + 32:(i + 1) * 64] = int(p[1]).to_bytes(32, "little")
        mask[i] = 1
    out = ctypes.create_string_buffer(384)
    lib.bn254_multi_pairing_pre(bytes(g1b), buf, bytes(mask), n, out)
    return _gt_from_coeff_bytes(out.raw)


def _g1_pack(points) -> bytes:
    out = bytearray(64 * len(points))
    mv = memoryview(out)
    for i, p in enumerate(points):
        if p is None:
            continue
        mv[i * 64:i * 64 + 32] = int(p[0]).to_bytes(32, "little")
        mv[i * 64 + 32:(i + 1) * 64] = int(p[1]).to_bytes(32, "little")
    return bytes(out)


def g1_fold_native(xs, ys, s: int):
    """[s·xs[i] + ys[i]] with one shared scalar, batch-normalized affine.
    None entries are the identity. Returns None on fallback."""
    lib = get_lib()
    if lib is None:
        return None
    from ..field.params import FR

    n = len(xs)
    assert len(ys) == n
    sb = (s % FR.p).to_bytes(32, "little")
    out = bytearray(65 * n)
    lib.bn254_g1_fold(_g1_pack(xs), _g1_pack(ys), sb, n,
                      ctypes.cast((ctypes.c_char * len(out)).from_buffer(out),
                                  ctypes.c_char_p))
    return [_g1_from_out(bytes(out[i * 65:(i + 1) * 65])) for i in range(n)]


def g2_fold_native(xs, ys, s: int):
    lib = get_lib()
    if lib is None:
        return None
    from ..field.params import FR

    n = len(xs)
    assert len(ys) == n
    sb = (s % FR.p).to_bytes(32, "little")
    out = bytearray(129 * n)
    lib.bn254_g2_fold(_g2_pack(xs), _g2_pack(ys), sb, n,
                      ctypes.cast((ctypes.c_char * len(out)).from_buffer(out),
                                  ctypes.c_char_p))
    return [_g2_from_out(bytes(out[i * 129:(i + 1) * 129])) for i in range(n)]


def g2_batch_mul_native(point, scalars):
    """[s·point for s in scalars] via a shared fixed-base window table.
    Returns None if the native lib is unavailable or point is None."""
    lib = get_lib()
    if lib is None or point is None:
        return None
    from ..field.params import FR

    (x0, x1), (y0, y1) = point
    pb = (int(x0).to_bytes(32, "little") + int(x1).to_bytes(32, "little")
          + int(y0).to_bytes(32, "little") + int(y1).to_bytes(32, "little"))
    n = len(scalars)
    sb = bytearray(32 * n)
    mv = memoryview(sb)
    for i, s in enumerate(scalars):
        mv[i * 32:(i + 1) * 32] = (s % FR.p).to_bytes(32, "little")
    out = bytearray(129 * n)
    lib.bn254_g2_batch_mul(pb, bytes(sb), n,
                           ctypes.cast((ctypes.c_char * len(out)).from_buffer(out),
                                       ctypes.c_char_p))
    return [_g2_from_out(bytes(out[i * 129:(i + 1) * 129])) for i in range(n)]


def g1_msm_rows_canon_native(points, scalar_bytes, rows):
    """[MSM(points, scalar_bytes[r*n*32:(r+1)*n*32]) for r in range(rows)]:
    shared bases, canonical 32-byte LE scalars already packed (e.g. straight
    out of FrVec.to_canonical_bytes) — zero per-element Python work.
    Returns None on fallback."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(points)
    assert len(scalar_bytes) >= 32 * n * rows
    pb = bytearray(64 * n)
    pmv = memoryview(pb)
    for i, p in enumerate(points):
        if p is None:
            continue
        pmv[i * 64:i * 64 + 32] = int(p[0]).to_bytes(32, "little")
        pmv[i * 64 + 32:(i + 1) * 64] = int(p[1]).to_bytes(32, "little")
    out = bytearray(65 * rows)
    lib.bn254_g1_msm_rows(
        ctypes.cast((ctypes.c_char * len(pb)).from_buffer(pb), ctypes.c_char_p),
        ctypes.cast((ctypes.c_char * len(scalar_bytes)).from_buffer(scalar_bytes),
                    ctypes.c_char_p),
        n, rows,
        ctypes.cast((ctypes.c_char * len(out)).from_buffer(out), ctypes.c_char_p))
    return [_g1_from_out(bytes(out[r * 65:(r + 1) * 65])) for r in range(rows)]


def g1_msm_rows_native(points, scalar_rows):
    """[MSM(points, row) for row in scalar_rows] with bases parsed once.
    scalar_rows: list of equal-length lists of canonical ints (len(points)).
    None entries in points are skipped. Returns None on fallback.

    Fast path: rows whose values all fit u64 (one-hot indicators, machine
    words — most committed polys) pack with one struct.pack per row instead
    of a Python loop of int.to_bytes."""
    lib = get_lib()
    if lib is None:
        return None
    import struct

    from ..field.params import FR

    n = len(points)
    pb = bytearray(64 * n)
    pmv = memoryview(pb)
    for i, p in enumerate(points):
        if p is None:
            continue
        pmv[i * 64:i * 64 + 32] = int(p[0]).to_bytes(32, "little")
        pmv[i * 64 + 32:(i + 1) * 64] = int(p[1]).to_bytes(32, "little")
    rows = len(scalar_rows)
    pbuf = ctypes.cast((ctypes.c_char * len(pb)).from_buffer(pb), ctypes.c_char_p)

    try:
        fmt = "<%dQ" % n
        sb64 = bytearray(8 * n * rows)
        off = 0
        for row in scalar_rows:
            assert len(row) == n
            sb64[off:off + 8 * n] = struct.pack(fmt, *row)
            off += 8 * n
        out = bytearray(65 * rows)
        lib.bn254_g1_msm_rows_u64(
            pbuf,
            ctypes.cast((ctypes.c_char * len(sb64)).from_buffer(sb64), ctypes.c_char_p),
            n, rows,
            ctypes.cast((ctypes.c_char * len(out)).from_buffer(out), ctypes.c_char_p))
        return [_g1_from_out(bytes(out[r * 65:(r + 1) * 65])) for r in range(rows)]
    except struct.error:
        pass

    sb = bytearray(32 * n * rows)
    smv = memoryview(sb)
    off = 0
    for row in scalar_rows:
        assert len(row) == n
        for s in row:
            s %= FR.p
            if s:
                smv[off:off + 32] = s.to_bytes(32, "little")
            off += 32
    out = bytearray(65 * rows)
    lib.bn254_g1_msm_rows(
        pbuf,
        ctypes.cast((ctypes.c_char * len(sb)).from_buffer(sb), ctypes.c_char_p),
        n, rows,
        ctypes.cast((ctypes.c_char * len(out)).from_buffer(out), ctypes.c_char_p))
    return [_g1_from_out(bytes(out[r * 65:(r + 1) * 65])) for r in range(rows)]


def g2_msm_native(points, scalars):
    lib = get_lib()
    if lib is None:
        return None
    from ..field.params import FR

    pb, sb = bytearray(), bytearray()
    n = 0
    for p, s in zip(points, scalars):
        s = s % FR.p
        if p is None or s == 0:
            continue
        (x0, x1), (y0, y1) = p
        pb += (int(x0).to_bytes(32, "little") + int(x1).to_bytes(32, "little")
               + int(y0).to_bytes(32, "little") + int(y1).to_bytes(32, "little"))
        sb += s.to_bytes(32, "little")
        n += 1
    if n == 0:
        return None
    out = ctypes.create_string_buffer(129)
    lib.bn254_g2_msm(bytes(pb), bytes(sb), n, out)
    if out.raw[0] == 0:
        return None
    return ((int.from_bytes(out.raw[1:33], "little"),
             int.from_bytes(out.raw[33:65], "little")),
            (int.from_bytes(out.raw[65:97], "little"),
             int.from_bytes(out.raw[97:129], "little")))


def g1_subset_tables_mont(points):
    """All-256 subset sums for each group of 8 consecutive affine points,
    for the device row-MSM tier (msm/rows_device.py). Returns
    (tables, valid) where tables is a (n/8*256, 64)-byte numpy u8 array of
    Montgomery-residue x||y (u64[4] LE — byte-identical to the device's
    16x16-bit limb Montgomery form) and valid is (n/8*256,) u8 with 0 for
    identity entries; or None on fallback. len(points) % 8 == 0; None
    entries are the identity."""
    lib = get_lib()
    if lib is None:
        return None
    import numpy as np

    n = len(points)
    assert n % 8 == 0 and n > 0
    pb = bytearray(64 * n)
    pmv = memoryview(pb)
    for i, p in enumerate(points):
        if p is None:
            continue
        pmv[i * 64:i * 64 + 32] = int(p[0]).to_bytes(32, "little")
        pmv[i * 64 + 32:(i + 1) * 64] = int(p[1]).to_bytes(32, "little")
    ntab = (n // 8) * 256
    out = bytearray(64 * ntab)
    valid = bytearray(ntab)
    lib.bn254_g1_subset_tables_mont(
        ctypes.cast((ctypes.c_char * len(pb)).from_buffer(pb), ctypes.c_char_p),
        n,
        ctypes.cast((ctypes.c_char * len(out)).from_buffer(out), ctypes.c_char_p),
        ctypes.cast((ctypes.c_char * len(valid)).from_buffer(valid),
                    ctypes.c_char_p))
    return (np.frombuffer(bytes(out), dtype=np.uint8).reshape(ntab, 64),
            np.frombuffer(bytes(valid), dtype=np.uint8))
