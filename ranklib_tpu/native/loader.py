"""ctypes bridge to the native LETOR parser (letor_parser.cpp).

Compiles the shared library on first use (g++ -O3 -shared -fPIC) into the
package directory and memoizes the handle. All failures — no compiler,
gzip input, malformed file — surface as ``None`` / ``NativeParseError`` so
``ranklib_tpu.data.letor.read_letor`` can fall back to the Python parser
(which also produces the precise error messages).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "letor_parser.cpp")
_LIB = os.path.join(_DIR, "_letor_parser.so")

_lock = threading.Lock()
_lib = None
_lib_failed = False

QID_STRIDE = 64
DESC_STRIDE = 160


class NativeParseError(Exception):
    pass


def gunzip_to_temp(path: str) -> str:
    """Stream-decompress a .gz file to a temp path (caller unlinks).
    Raises RankLibError with the exact gzip error on bad archives."""
    import gzip
    import shutil
    import tempfile
    import zlib

    from ranklib_tpu.utils.errors import RankLibError

    with tempfile.NamedTemporaryFile(suffix=".letor", delete=False) as tmp:
        tmp_path = tmp.name
    try:
        with gzip.open(path, "rb") as src, open(tmp_path, "wb") as dst:
            shutil.copyfileobj(src, dst, length=1 << 20)
    except (OSError, EOFError, zlib.error) as e:
        try:
            os.unlink(tmp_path)
        except OSError:
            pass
        raise RankLibError(f"cannot decompress {path}: {e}") from None
    return tmp_path


_COMMON_H = os.path.join(_DIR, "common.h")


def _compile_and_load(src: str, lib_path: str, extra_flags=()):
    """Compile-on-first-use, shared by every native library here:
    rebuild when the .so is missing or older than its source OR the
    shared header (common.h holds the parity-defining primitives both
    .cpp files include — a header edit must rebuild both), then CDLL.
    Returns None on any compiler/loader failure (callers memoize)."""
    try:
        src_mtime = os.path.getmtime(src)
        if os.path.exists(_COMMON_H):
            src_mtime = max(src_mtime, os.path.getmtime(_COMMON_H))
        if (not os.path.exists(lib_path)
                or os.path.getmtime(lib_path) < src_mtime):
            subprocess.run(
                ["g++", "-O3", "-march=native", "-shared", "-fPIC",
                 *extra_flags, "-o", lib_path, src],
                check=True, capture_output=True, timeout=120)
        return ctypes.CDLL(lib_path)
    except (OSError, subprocess.SubprocessError):
        return None


def _get_lib():
    global _lib, _lib_failed
    with _lock:
        if _lib is not None or _lib_failed:
            return _lib
        lib = _compile_and_load(_SRC, _LIB)
        if lib is None:
            _lib_failed = True
            return None
        i64 = ctypes.c_int64
        p_i64 = ctypes.POINTER(i64)
        p_f32 = ctypes.POINTER(ctypes.c_float)
        lib.letor_stat.argtypes = [ctypes.c_char_p, p_i64, p_i64, p_i64]
        lib.letor_stat.restype = ctypes.c_int
        lib.letor_fill.argtypes = [
            ctypes.c_char_p, p_f32, p_f32, i64, i64, p_i64, i64,
            ctypes.c_char_p, i64, ctypes.c_char_p, i64,
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.letor_fill.restype = ctypes.c_int
        if hasattr(lib, "letor_value_stats"):
            lib.letor_value_stats.argtypes = [
                ctypes.c_char_p, i64, i64, p_f32, p_i64, p_f32,
            ]
            lib.letor_value_stats.restype = ctypes.c_int
            lib.letor_fill_binned.argtypes = [
                ctypes.c_char_p, p_f32, i64, p_f32,
                ctypes.POINTER(ctypes.c_int16), i64, i64, p_i64, i64,
                ctypes.c_char_p, i64, ctypes.POINTER(ctypes.c_int32),
            ]
            lib.letor_fill_binned.restype = ctypes.c_int
        if hasattr(lib, "letor_descs"):
            lib.letor_descs.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                        i64, i64]
            lib.letor_descs.restype = ctypes.c_int
        if hasattr(lib, "letor_nnz"):
            lib.letor_nnz.argtypes = [ctypes.c_char_p, p_i64]
            lib.letor_nnz.restype = ctypes.c_int
            lib.letor_fill_csr.argtypes = [
                ctypes.c_char_p, p_f32, i64, p_i64, i64,
                ctypes.c_char_p, i64, ctypes.POINTER(ctypes.c_int32),
                p_f32, i64, ctypes.POINTER(ctypes.c_int32),
            ]
            lib.letor_fill_csr.restype = ctypes.c_int
        _lib = lib
        return _lib


def native_available() -> bool:
    return _get_lib() is not None


def native_parse_letor(path: str, want_descs: bool = True,
                       min_features: int = 0):
    """Parse a LETOR file natively.

    Returns (labels[N] f32, feats[N, F] f32, qptr[Q+1] i64, qids list[str],
    descs list[str] | None, counts[N] i32, max_fid int) — ``counts`` is the
    per-line number of fid:val pairs and ``max_fid`` the file's own max fid
    (before ``min_features`` widening), both for the strict missing-feature
    check (ref: learning/DataPoint.java:~120 missingZero) — or None when
    the native path is unavailable (no compiler / undecodable gzip). Raises
    NativeParseError on malformed input so the caller can re-parse in
    Python for a precise error message.
    """
    if path.endswith(".gz"):
        # keep the native path for gzip: decompress once to a temp file
        # (gunzip_to_temp, streamed; ~100 MB/s) — still ~5× the Python
        # parse of the same stream. Bad archives fall back to Python for
        # the exact error message.
        from ranklib_tpu.utils.errors import RankLibError

        if _get_lib() is None:
            return None
        try:
            tmp_path = gunzip_to_temp(path)
        except RankLibError:
            return None
        try:
            return native_parse_letor(tmp_path, want_descs=want_descs,
                                      min_features=min_features)
        finally:
            try:
                os.unlink(tmp_path)
            except OSError:
                pass
    lib = _get_lib()
    if lib is None:
        return None
    i64 = ctypes.c_int64
    n_docs = i64(0)
    n_queries = i64(0)
    max_fid = i64(0)
    rc = lib.letor_stat(path.encode(), ctypes.byref(n_docs),
                        ctypes.byref(n_queries), ctypes.byref(max_fid))
    if rc == -1:
        return None                       # io error → let Python report it
    if rc == -4:
        # a qid/description exceeds the fixed native buffers — the Python
        # parser handles arbitrary lengths exactly
        raise NativeParseError(f"oversized token in {path}")
    if rc != 0:
        raise NativeParseError(f"malformed LETOR file: {path}")
    N, Q = n_docs.value, n_queries.value
    F = max(max_fid.value, int(min_features))
    if N == 0 or Q == 0:
        raise NativeParseError(f"no data lines in {path}")

    labels = np.zeros(N, np.float32)
    feats = np.zeros((N, F), np.float32)
    qptr = np.zeros(Q + 1, np.int64)
    counts = np.zeros(N, np.int32)
    qidbuf = ctypes.create_string_buffer(Q * QID_STRIDE)
    descbuf = ctypes.create_string_buffer(N * DESC_STRIDE) if want_descs else None

    rc = lib.letor_fill(
        path.encode(),
        labels.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        feats.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        i64(N), i64(F),
        qptr.ctypes.data_as(ctypes.POINTER(i64)), i64(Q),
        qidbuf, i64(QID_STRIDE),
        descbuf, i64(DESC_STRIDE),
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    if rc != 0:
        raise NativeParseError(f"native parse failed (rc={rc}): {path}")

    qraw = qidbuf.raw                 # .raw copies the buffer — take it ONCE
    qids = [qraw[i * QID_STRIDE:(i + 1) * QID_STRIDE]
            .split(b"\0", 1)[0].decode() for i in range(Q)]
    descs = None
    if want_descs:
        draw = descbuf.raw
        descs = [draw[i * DESC_STRIDE:(i + 1) * DESC_STRIDE]
                 .split(b"\0", 1)[0].decode(errors="replace")
                 for i in range(N)]
    return labels, feats, qptr, qids, descs, counts, max_fid.value


# ---- native feature binner (binner.cpp) -------------------------------------

_BIN_SRC = os.path.join(_DIR, "binner.cpp")
_BIN_LIB = os.path.join(_DIR, "_binner.so")
_bin_lib = None
_bin_failed = False


def _get_bin_lib():
    global _bin_lib, _bin_failed
    with _lock:
        if _bin_lib is not None or _bin_failed:
            return _bin_lib
        lib = _compile_and_load(_BIN_SRC, _BIN_LIB, extra_flags=("-pthread",))
        if lib is None:
            _bin_failed = True
            return None
        i64 = ctypes.c_int64
        p_f32 = ctypes.POINTER(ctypes.c_float)
        lib.bin_features_i32.argtypes = [
            p_f32, p_f32, ctypes.POINTER(ctypes.c_int32),
            i64, i64, i64, i64,
        ]
        lib.bin_features_i32.restype = ctypes.c_int
        lib.feature_uniques.argtypes = [
            p_f32, i64, i64, i64, p_f32, ctypes.POINTER(i64), p_f32,
        ]
        lib.feature_uniques.restype = ctypes.c_int
        _bin_lib = lib
        return _bin_lib


def native_bin_features(feats: np.ndarray, thresholds: np.ndarray):
    """searchsorted(thresholds[f], feats[:, f], 'left') for every feature,
    multithreaded in C++. Returns [N, F] int32, or None when the native
    path is unavailable (caller falls back to numpy)."""
    lib = _get_bin_lib()
    if lib is None:
        return None
    feats = np.ascontiguousarray(feats, dtype=np.float32)
    thr = np.ascontiguousarray(thresholds, dtype=np.float32)
    N, F = feats.shape
    if thr.shape[0] != F:
        return None
    out = np.empty((N, F), np.int32)
    rc = lib.bin_features_i32(
        feats.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        thr.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int64(N), ctypes.c_int64(F), ctypes.c_int64(thr.shape[1]),
        ctypes.c_int64(0),
    )
    if rc != 0:
        return None
    return out


def native_feature_uniques(feats: np.ndarray, cap: int):
    """One-pass capped unique collection per feature (binner.cpp).

    Returns (vals [F, cap] f32 — first counts[f] entries valid, unsorted;
    counts [F] i64 — cap+1 means 'more than cap uniques'; minmax [F, 2]),
    or None when unavailable (caller falls back to np.unique)."""
    if cap <= 0 or cap > 400:
        return None
    lib = _get_bin_lib()
    if lib is None or not hasattr(lib, "feature_uniques"):
        return None
    feats = np.ascontiguousarray(feats, dtype=np.float32)
    N, F = feats.shape
    if N == 0:
        return None
    vals = np.empty((F, cap), np.float32)
    counts = np.empty((F,), np.int64)
    minmax = np.empty((F, 2), np.float32)
    i64 = ctypes.c_int64
    rc = lib.feature_uniques(
        feats.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        i64(N), i64(F), i64(cap),
        vals.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        counts.ctypes.data_as(ctypes.POINTER(i64)),
        minmax.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    if rc != 0:
        return None
    return vals, counts, minmax


# ---- streaming parse→bin (letor_parser.cpp letor_value_stats/fill_binned) ---

def native_letor_stat(path: str):
    """Cheap first pass: (n_docs, n_queries, max_fid) or None."""
    lib = _get_lib()
    if lib is None:
        return None
    i64 = ctypes.c_int64
    n_docs, n_queries, max_fid = i64(0), i64(0), i64(0)
    rc = lib.letor_stat(path.encode(), ctypes.byref(n_docs),
                        ctypes.byref(n_queries), ctypes.byref(max_fid))
    if rc == -1:
        return None
    if rc != 0:
        raise NativeParseError(f"malformed LETOR file: {path} (rc={rc})")
    return n_docs.value, n_queries.value, max_fid.value


def native_letor_value_stats(path: str, n_feat: int, cap: int):
    """Streaming per-feature capped uniques + min/max (implicit zeros of
    unspecified fids folded in — bit-identical decisions to running the
    dense capped-hash pass). Returns (vals [F, cap] f32, counts [F] i64
    with cap+1 = over, minmax [F, 2] f32) or None when unavailable."""
    lib = _get_lib()
    if lib is None or not hasattr(lib, "letor_value_stats"):
        return None
    if cap <= 0 or cap > 400:
        return None
    vals = np.empty((n_feat, cap), np.float32)
    counts = np.empty((n_feat,), np.int64)
    minmax = np.empty((n_feat, 2), np.float32)
    i64 = ctypes.c_int64
    rc = lib.letor_value_stats(
        path.encode(), i64(n_feat), i64(cap),
        vals.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        counts.ctypes.data_as(ctypes.POINTER(i64)),
        minmax.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    if rc == -1:
        return None
    if rc != 0:
        raise NativeParseError(f"streaming stats failed (rc={rc}): {path}")
    return vals, counts, minmax


def native_parse_letor_binned(path: str, thresholds, n_docs: int,
                              n_queries: int):
    """Second stream: parse + bin in one pass without a dense [N, F] f32.

    Returns (labels [N] f32, bins [N, F] int16, qptr [Q+1] i64,
    qids list[str], counts [N] i32) or None when unavailable."""
    lib = _get_lib()
    if lib is None or not hasattr(lib, "letor_fill_binned"):
        return None
    thr = np.ascontiguousarray(thresholds, dtype=np.float32)
    F, B = thr.shape
    labels = np.zeros(n_docs, np.float32)
    bins = np.empty((n_docs, F), np.int16)
    qptr = np.zeros(n_queries + 1, np.int64)
    counts = np.zeros(n_docs, np.int32)
    qidbuf = ctypes.create_string_buffer(n_queries * QID_STRIDE)
    i64 = ctypes.c_int64
    rc = lib.letor_fill_binned(
        path.encode(),
        thr.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), i64(B),
        labels.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        bins.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        i64(n_docs), i64(F),
        qptr.ctypes.data_as(ctypes.POINTER(i64)), i64(n_queries),
        qidbuf, i64(QID_STRIDE),
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    if rc != 0:
        raise NativeParseError(f"streaming bin failed (rc={rc}): {path}")
    qraw = qidbuf.raw
    qids = [qraw[i * QID_STRIDE:(i + 1) * QID_STRIDE]
            .split(b"\0", 1)[0].decode() for i in range(n_queries)]
    return labels, bins, qptr, qids, counts


def native_letor_descs(path: str, n_docs: int):
    """Per-data-line '#' descriptions ('' when absent) — the side-array
    the sparse loaders attach for -qrel/-indri parity with the dense
    pipeline. Returns list[str] of length n_docs, or None when the
    native path is unavailable. Raises NativeParseError on oversized
    tokens so the caller can fall back to a Python desc pass."""
    lib = _get_lib()
    if lib is None or not hasattr(lib, "letor_descs"):
        return None
    descbuf = ctypes.create_string_buffer(n_docs * DESC_STRIDE)
    rc = lib.letor_descs(path.encode(), descbuf,
                         ctypes.c_int64(DESC_STRIDE), ctypes.c_int64(n_docs))
    if rc == -1:
        return None
    if rc != 0:
        raise NativeParseError(f"desc pass failed (rc={rc}): {path}")
    draw = descbuf.raw
    return [draw[i * DESC_STRIDE:(i + 1) * DESC_STRIDE]
            .split(b"\0", 1)[0].decode(errors="replace")
            for i in range(n_docs)]


def native_parse_letor_csr(path: str):
    """Parse a LETOR file straight into host CSR.

    Returns (labels[N] f32, qptr[Q+1] i64, qids list[str],
    indptr[N+1] i64, fids[nnz] i32 0-based, vals[nnz] f32,
    counts[N] i32, max_fid int) — memory ~ nnz, never [N, F] — or None
    when the native path is unavailable. Raises NativeParseError on
    malformed/oversized input so the caller can fall back to the Python
    parser for the exact error message.
    """
    lib = _get_lib()
    if lib is None or not hasattr(lib, "letor_nnz"):
        return None
    i64 = ctypes.c_int64
    stat = native_letor_stat(path)
    if stat is None:
        return None
    N, Q, max_fid = stat
    if N == 0 or Q == 0:
        raise NativeParseError(f"no data lines in {path}")
    nnz = i64(0)
    rc = lib.letor_nnz(path.encode(), ctypes.byref(nnz))
    if rc == -1:
        return None
    if rc == -4:
        raise NativeParseError(f"oversized token in {path}")
    if rc != 0:
        raise NativeParseError(f"malformed LETOR file: {path}")
    nnz = nnz.value

    labels = np.zeros(N, np.float32)
    qptr = np.zeros(Q + 1, np.int64)
    counts = np.zeros(N, np.int32)
    fids = np.zeros(nnz, np.int32)
    vals = np.zeros(nnz, np.float32)
    qidbuf = ctypes.create_string_buffer(Q * QID_STRIDE)
    rc = lib.letor_fill_csr(
        path.encode(),
        labels.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        i64(N),
        qptr.ctypes.data_as(ctypes.POINTER(i64)), i64(Q),
        qidbuf, i64(QID_STRIDE),
        fids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        vals.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        i64(nnz),
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    if rc == -4:
        raise NativeParseError(f"oversized token in {path}")
    if rc != 0:
        raise NativeParseError(f"native CSR parse failed (rc={rc}): {path}")
    qraw = qidbuf.raw
    qids = [qraw[i * QID_STRIDE:(i + 1) * QID_STRIDE]
            .split(b"\0", 1)[0].decode() for i in range(Q)]
    indptr = np.zeros(N + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    return labels, qptr, qids, indptr, fids, vals, counts, max_fid
