"""ctypes binding to the native host library (libstrawberry_host.so).

Provides load_bam_native() with the identical contract as
strawberry_tpu.io.bamreader.load_bam (the Python oracle); the test-suite
asserts array-for-array equality between the two.
"""
from __future__ import annotations

import ctypes as C
import os
import subprocess
from typing import Dict, Optional

import numpy as np

from ..config import Config
from .bamreader import HitTable

_LIB_PATH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native", "libstrawberry_host.so")
_lib = None
_lib_lock = __import__("threading").Lock()


def _build():
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    subprocess.run([os.path.join(root, "tools", "build_native.sh")],
                   check=True, capture_output=True)


def _stale() -> bool:
    """The library is missing or older than one of its tracked sources
    (a checkout on another machine rebuilds for its own CPU)."""
    if not os.path.exists(_LIB_PATH):
        return True
    src = os.path.dirname(_LIB_PATH)
    built = os.path.getmtime(_LIB_PATH)
    return any(os.path.getmtime(os.path.join(src, f)) > built
               for f in os.listdir(src) if f.endswith((".cc", ".h")))


def get_lib():
    # Thread-safe singleton: the GTF side thread and the stream open race
    # here at startup. Two CDLL instances would each carry their OWN
    # function-pointer caches, while the module-level "_bound" flags of
    # the per-area binders (sbam, cluster, …) are process-global — the
    # loser's instance would be consulted with DEFAULT (32-bit int)
    # restypes, truncating returned handles (observed: rare segfault in
    # strawb_sbam_set_max_retained on a truncated strawb_sbam_open
    # result).
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        return _load_lib_locked()


def _load_lib_locked():
    global _lib
    if _stale():
        _build()
    lib = C.CDLL(_LIB_PATH)
    lib.strawb_bam_load.restype = C.c_void_p
    lib.strawb_bam_load.argtypes = [C.c_char_p] + [C.c_int32] * 8
    lib.strawb_bam_error.restype = C.c_char_p
    lib.strawb_bam_error.argtypes = [C.c_void_p]
    for name, restype in [
        ("num_hits", C.c_int64), ("num_feats", C.c_int64),
        ("paired", C.c_int32), ("num_refs", C.c_int32),
        ("hist_size", C.c_int32), ("diag_n", C.c_int64),
    ]:
        fn = getattr(lib, f"strawb_bam_{name}")
        fn.restype = restype
        fn.argtypes = [C.c_void_p]
    lib.strawb_bam_ref_names.restype = C.c_char_p
    lib.strawb_bam_ref_names.argtypes = [C.c_void_p]
    lib.strawb_bam_diag_names.restype = C.c_char_p
    lib.strawb_bam_diag_names.argtypes = [C.c_void_p]
    for name, ct in [
        ("ref_lens", C.c_int32), ("hist_len", C.c_int32),
        ("hist_count", C.c_int32), ("ref_id", C.c_int32),
        ("diag_kinds", C.c_int8), ("diag_rows", C.c_int64),
        ("left", C.c_int64), ("right", C.c_int64), ("strand", C.c_int8),
        ("flag", C.c_uint16), ("mate_ref", C.c_int32),
        ("mate_pos", C.c_int64), ("nh", C.c_int32),
        ("read_id", C.c_uint64), ("cigar_hash", C.c_uint64),
        ("feat_off", C.c_int64), ("feat_code", C.c_int8),
        ("feat_left", C.c_int64), ("feat_len", C.c_int32),
    ]:
        fn = getattr(lib, f"strawb_bam_{name}")
        fn.restype = C.POINTER(ct)
        fn.argtypes = [C.c_void_p]
    lib.strawb_bam_free.restype = None
    lib.strawb_bam_free.argtypes = [C.c_void_p]
    _lib = lib
    return lib


class _Owner:
    """Keeps a native handle alive for the lifetime of the numpy views
    wrapping its buffers (zero-copy marshaling)."""

    __slots__ = ("_free", "_h")

    def __init__(self, free_fn, handle):
        self._free = free_fn
        self._h = handle

    def __del__(self):
        if self._h:
            self._free(self._h)
            self._h = None


class _OwnedArray(np.ndarray):
    """ndarray subclass that can carry the native-handle owner; slices keep
    it alive through their .base chain."""


def _view(ptr, n, dtype, owner):
    """Zero-copy numpy view over a native buffer; `owner` keeps the
    backing allocation alive via the returned array's .base chain."""
    if n == 0:
        return np.zeros(0, dtype)
    a = np.ctypeslib.as_array(ptr, shape=(int(n),))
    assert a.dtype == np.dtype(dtype)
    v = a.view(_OwnedArray)
    v._owner = owner
    return v


def _arr(ptr, n, dtype):
    if n == 0:
        return np.zeros(0, dtype)
    return np.ctypeslib.as_array(ptr, shape=(n,)).astype(dtype, copy=True)


_span_bound = False


def _bind_span(lib):
    global _span_bound
    if _span_bound:
        return lib
    lib.strawb_span_open.restype = C.c_void_p
    lib.strawb_span_open.argtypes = [C.c_char_p] + [C.c_int32] * 10
    lib.strawb_span_error.restype = C.c_char_p
    lib.strawb_span_error.argtypes = [C.c_void_p]
    lib.strawb_span_end.restype = C.c_int64
    lib.strawb_span_end.argtypes = [C.c_void_p, C.c_int64]
    lib.strawb_span_parse.restype = C.c_int32
    lib.strawb_span_parse.argtypes = [C.c_void_p, C.c_int64, C.c_int64]
    for name, rt in [("header_end", C.c_int64),
                     ("owned_end_ucomp", C.c_int64),
                     ("total_ucomp", C.c_int64), ("comp_bytes", C.c_int64),
                     ("num_refs", C.c_int32), ("num_hits", C.c_int64),
                     ("num_feats", C.c_int64), ("paired", C.c_int32),
                     ("num_seqlens", C.c_int32)]:
        fn = getattr(lib, f"strawb_span_{name}")
        fn.restype = rt
        fn.argtypes = [C.c_void_p]
    lib.strawb_span_ref_names.restype = C.c_char_p
    lib.strawb_span_ref_names.argtypes = [C.c_void_p]
    for name, ct in [
        ("ref_lens", C.c_int32), ("seqlens", C.c_int32),
        ("ref_id", C.c_int32), ("left", C.c_int64), ("right", C.c_int64),
        ("strand", C.c_int8), ("flag", C.c_uint16), ("mate_ref", C.c_int32),
        ("mate_pos", C.c_int64), ("nh", C.c_int32), ("read_id", C.c_uint64),
        ("cigar_hash", C.c_uint64), ("feat_off", C.c_int64),
        ("feat_code", C.c_int8), ("feat_left", C.c_int64),
        ("feat_len", C.c_int32),
    ]:
        fn = getattr(lib, f"strawb_span_{name}")
        fn.restype = C.POINTER(ct)
        fn.argtypes = [C.c_void_p]
    lib.strawb_span_free.restype = None
    lib.strawb_span_free.argtypes = [C.c_void_p]
    _span_bound = True
    return lib


class SpanDecoder:
    """Per-process ranged BAM ingest: index the BGZF blocks, inflate only
    this process's ~1/N compressed-byte span, and parse the records that
    START inside it (the exact start offset comes from the previous span's
    relay — parallel/distributed.py drives the collective rounds).
    Replaces the every-process-decodes-everything distributed ingest (ref
    design anchor: bgzf_seek ranged access, src/read.cpp:428-478)."""

    def __init__(self, path: str, pid: int, nproc: int,
                 config: Optional[Config] = None, n_threads: int = 0):
        cfg = config or Config()
        self._lib = _bind_span(get_lib())
        if n_threads <= 0:
            n_threads = min(8, os.cpu_count() or 1)
        self._h = self._lib.strawb_span_open(
            path.encode(), pid, nproc, cfg.max_intron_length,
            cfg.min_intron_length, 1 if cfg.use_only_unique_hits else 0,
            1 if cfg.fr_strand else 0, 1 if cfg.rf_strand else 0,
            cfg.max_read_num_4_rl, cfg.min_map_qual, n_threads)
        if not self._h:
            raise IOError(f"cannot open BAM: {path}")
        err = self._lib.strawb_span_error(self._h)
        if err:
            msg = err.decode()
            self._lib.strawb_span_free(self._h)
            self._h = None
            raise IOError(f"{path}: {msg}")
        h = self._h
        self.header_end = self._lib.strawb_span_header_end(h)
        self.owned_end = self._lib.strawb_span_owned_end_ucomp(h)
        self.total_ucomp = self._lib.strawb_span_total_ucomp(h)
        names = self._lib.strawb_span_ref_names(h).decode().split("\n")[:-1]
        self.ref_real_names = names
        self.ref_names = [x.lower() for x in names]
        nref = self._lib.strawb_span_num_refs(h)
        self.ref_lens = _arr(self._lib.strawb_span_ref_lens(h), nref,
                             np.int32).tolist()

    @property
    def comp_bytes(self) -> int:
        if self._h:
            return self._lib.strawb_span_comp_bytes(self._h)
        return getattr(self, "_comp_bytes_final", 0)

    def end_from(self, start: int) -> int:
        end = self._lib.strawb_span_end(self._h, start)
        if end < 0:
            err = self._lib.strawb_span_error(self._h)
            raise IOError(err.decode() if err else "span_end failed")
        return int(end)

    def parse(self, start: int, end: int):
        """Returns (arrays dict, ordered seq_lens, paired_end)."""
        lib, h = self._lib, self._h
        if not lib.strawb_span_parse(h, start, end):
            err = lib.strawb_span_error(h)
            raise IOError(err.decode() if err else "span_parse failed")
        n = lib.strawb_span_num_hits(h)
        nf = lib.strawb_span_num_feats(h)
        o = _Owner(lib.strawb_span_free, h)
        self._h = None  # ownership transferred to the views
        arrs = dict(
            ref_id=_view(lib.strawb_span_ref_id(h), n, np.int32, o),
            left=_view(lib.strawb_span_left(h), n, np.int64, o),
            right=_view(lib.strawb_span_right(h), n, np.int64, o),
            strand=_view(lib.strawb_span_strand(h), n, np.int8, o),
            flag=_view(lib.strawb_span_flag(h), n, np.uint16, o),
            mate_ref=_view(lib.strawb_span_mate_ref(h), n, np.int32, o),
            mate_pos=_view(lib.strawb_span_mate_pos(h), n, np.int64, o),
            nh=_view(lib.strawb_span_nh(h), n, np.int32, o),
            read_id=_view(lib.strawb_span_read_id(h), n, np.uint64, o),
            cigar_hash=_view(lib.strawb_span_cigar_hash(h), n, np.uint64,
                             o),
            feat_off=_view(lib.strawb_span_feat_off(h), n + 1, np.int64, o),
            feat_code=_view(lib.strawb_span_feat_code(h), nf, np.int8, o),
            feat_left=_view(lib.strawb_span_feat_left(h), nf, np.int64, o),
            feat_len=_view(lib.strawb_span_feat_len(h), nf, np.int32, o))
        nsl = lib.strawb_span_num_seqlens(h)
        seq_lens = _arr(lib.strawb_span_seqlens(h), nsl, np.int32)
        self._comp_bytes_final = lib.strawb_span_comp_bytes(h)
        return arrs, seq_lens, bool(lib.strawb_span_paired(h))

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.strawb_span_free(self._h)
            self._h = None


def load_bam_native(path: str, config: Optional[Config] = None,
                    n_threads: int = 0) -> HitTable:
    cfg = config or Config()
    lib = get_lib()
    if n_threads <= 0:
        n_threads = min(8, os.cpu_count() or 1)
    h = lib.strawb_bam_load(
        path.encode(), cfg.max_intron_length, cfg.min_intron_length,
        1 if cfg.use_only_unique_hits else 0,
        1 if cfg.fr_strand else 0, 1 if cfg.rf_strand else 0,
        cfg.max_read_num_4_rl, cfg.min_map_qual, n_threads)
    if not h:
        raise IOError(f"cannot open BAM: {path}")
    try:
        err = lib.strawb_bam_error(h)
        if err:
            raise IOError(f"{path}: {err.decode()}")
    except Exception:
        lib.strawb_bam_free(h)
        raise
    owner = _Owner(lib.strawb_bam_free, h)
    n = lib.strawb_bam_num_hits(h)
    nf = lib.strawb_bam_num_feats(h)
    names = lib.strawb_bam_ref_names(h).decode().split("\n")[:-1]
    nref = lib.strawb_bam_num_refs(h)
    hist_n = lib.strawb_bam_hist_size(h)
    hist = dict(zip(
        _arr(lib.strawb_bam_hist_len(h), hist_n, np.int32).tolist(),
        _arr(lib.strawb_bam_hist_count(h), hist_n, np.int32).tolist()))
    return HitTable(
        ref_id=_view(lib.strawb_bam_ref_id(h), n, np.int32, owner),
        left=_view(lib.strawb_bam_left(h), n, np.int64, owner),
        right=_view(lib.strawb_bam_right(h), n, np.int64, owner),
        strand=_view(lib.strawb_bam_strand(h), n, np.int8, owner),
        flag=_view(lib.strawb_bam_flag(h), n, np.uint16, owner),
        mate_ref=_view(lib.strawb_bam_mate_ref(h), n, np.int32, owner),
        mate_pos=_view(lib.strawb_bam_mate_pos(h), n, np.int64, owner),
        nh=_view(lib.strawb_bam_nh(h), n, np.int32, owner),
        read_id=_view(lib.strawb_bam_read_id(h), n, np.uint64, owner),
        cigar_hash=_view(lib.strawb_bam_cigar_hash(h), n, np.uint64, owner),
        feat_off=_view(lib.strawb_bam_feat_off(h), n + 1, np.int64, owner),
        feat_code=_view(lib.strawb_bam_feat_code(h), nf, np.int8, owner),
        feat_left=_view(lib.strawb_bam_feat_left(h), nf, np.int64, owner),
        feat_len=_view(lib.strawb_bam_feat_len(h), nf, np.int32, owner),
        ref_names=[x.lower() for x in names],
        ref_real_names=names,
        ref_lens=_arr(lib.strawb_bam_ref_lens(h), nref,
                      np.int32).tolist(),
        read_len_hist=hist,
        paired_end=bool(lib.strawb_bam_paired(h)),
        diag_events=_fetch_diag(
            lib.strawb_bam_diag_n(h), lib.strawb_bam_diag_kinds(h),
            lib.strawb_bam_diag_rows(h), lib.strawb_bam_diag_names(h)),
    )


def _fetch_diag(n, kinds_p, rows_p, names_p):
    """Decode the native -v per-read diagnostic arrays into the
    HitTable.diag_events [(row, kind, name), ...] form (file order)."""
    n = int(n)
    if n == 0:
        return None
    kinds = _arr(kinds_p, n, np.int8).tolist()
    rows = _arr(rows_p, n, np.int64).tolist()
    names = names_p.decode(errors="replace").split("\n")[:n]
    return list(zip(rows, kinds, names))
