"""Device pass-2 quantification prep: the reads x isoforms kernels.

The LocusContext observation model (ref: src/estimate.cpp:135-198,
src/contig.cpp:547-599) splits into an INTEGER half — read-vs-isoform
compatibility and exon-segment overlap rows — and a FLOAT64 half (counts,
theoretical bin weights, EM). Integer arithmetic is exact on any device,
so the integer half runs as one batched jitted kernel over padded tensors
and stays byte-identical; the f64 half stays on host (the golden path
keeps every float on the host, where the reference's sums are
reproduced bit for bit).

Compatibility is re-derived in closed form from the reference's walk
(contig.cpp:547-599): exons of an isoform are disjoint and sorted, so each
MATCH feature has a unique candidate containing exon (the first exon whose
right end >= the feature's left), and the walk accepts iff
  * every MATCH feature is contained in its candidate exon, and
  * every INTRON feature positionally equals the isoform intron that
    follows the exon containing the closest preceding MATCH (the walk's
    `it` cursor), GAP features skipped.
Both reduce to vectorized searchsorted + gather + compare over padded
(pairs, features, exons) tensors — wide elementwise integer work, no
matrix products.

Host residue per locus (strawb_quant_finish_batch): bin grouping in
first-encounter order, FNV fragment-set dedupe, f64 counts and the
fragment-length weight integral — unchanged, bit-identical C++.
"""
from __future__ import annotations

import ctypes as C
import os
from typing import List, Optional

import numpy as np

from ..utils import jaxsetup  # noqa: F401
import jax
import jax.numpy as jnp

F_MAX = 16    # features per hit contig (bigger hits route to host)
E_MAX = 64    # exons per isoform
S_MAX = 128   # disjoint segs per locus -> 16 packed row bytes
L_MAX = 512   # loci per chunk (bigger chunks split)
ROW_BYTES = S_MAX // 8

_H_TIERS = (4096, 16384, 65536, 262144)
_NF_TIERS = (16384, 65536, 262144, 1048576)
_P_TIERS = (8192, 65536, 262144, 1048576, 4194304)

_I32MAX = np.int32(2**31 - 1)


def _tier(x: int, tiers) -> Optional[int]:
    for t in tiers:
        if x <= t:
            return t
    return None


def _make_kernel(Ppad: int):
    """Build the jitted kernel for a fixed padded pair count (shapes of all
    other inputs are already static per call)."""

    @jax.jit
    def kern(gcode, gleft, glen, goff, nf,
             exl, exr, nex, inl, inn,
             pair_base, hit_off, iso_off, iso_idx, ni,
             segl, segr):
        H = goff.shape[0]
        NF = gcode.shape[0]

        fidx = goff[:, None] + jnp.arange(F_MAX, dtype=jnp.int32)[None, :]
        fmask = jnp.arange(F_MAX, dtype=jnp.int32)[None, :] < nf[:, None]
        fcl = jnp.clip(fidx, 0, NF - 1)
        hc = jnp.where(fmask, gcode[fcl].astype(jnp.int32), -1)   # [H,F]
        hl = jnp.where(fmask, gleft[fcl], _I32MAX)
        hn = jnp.where(fmask, glen[fcl], 0)
        hr = hl + hn - 1

        # ---- pair decode --------------------------------------------------
        p = jnp.arange(Ppad, dtype=jnp.int32)
        L = jnp.clip(jnp.searchsorted(pair_base, p, side="right")
                     .astype(jnp.int32) - 1, 0, ni.shape[0] - 1)
        off = p - pair_base[L]
        nL = jnp.maximum(ni[L], 1)
        ph = jnp.clip(hit_off[L] + off // nL, 0, H - 1)           # [P]
        pt = iso_idx[jnp.clip(iso_off[L] + off % nL, 0,
                              iso_idx.shape[0] - 1)]              # [P]

        code = hc[ph]                                             # [P,F]
        left = hl[ph]
        right = hr[ph]
        length = hn[ph]
        Exl = exl[pt]                                             # [P,E]
        Exr = exr[pt]
        Inl = inl[pt]
        Inn = inn[pt]
        nEx = nex[pt]                                             # [P]

        # candidate exon per feature: first exon with right >= feature left
        eidx = jnp.sum(Exr[:, None, :] < left[:, :, None], axis=2,
                       dtype=jnp.int32)                           # [P,F]
        ecl = jnp.clip(eidx, 0, E_MAX - 1)
        exl_g = jnp.take_along_axis(Exl, ecl, axis=1)
        exr_g = jnp.take_along_axis(Exr, ecl, axis=1)
        contained = (eidx < nEx[:, None]) & (exl_g <= left) & (exr_g >= right)

        # walk cursor before each feature: exon of the last preceding MATCH
        # (seeded with the first feature's candidate, like `it = lo`)
        is_match = code == 0
        seeded = jnp.where(is_match, eidx, -1)
        seeded = seeded.at[:, 0].set(eidx[:, 0])
        mm = jax.lax.cummax(seeded, axis=1)
        m_before = jnp.concatenate([eidx[:, :1], mm[:, :-1]], axis=1)
        mcl = jnp.clip(m_before, 0, E_MAX - 1)
        inl_g = jnp.take_along_axis(Inl, mcl, axis=1)
        inn_g = jnp.take_along_axis(Inn, mcl, axis=1)
        ok_intron = (m_before < nEx[:, None] - 1) & (inl_g == left) \
            & (inn_g == length)

        okf = jnp.where(code == 1, ok_intron,
                        jnp.where(is_match, contained, True))
        okf = okf.at[:, 0].set(contained[:, 0])
        compat = jnp.all(okf, axis=1)                             # [P]

        # ---- seg-overlap rows --------------------------------------------
        hloc = jnp.clip(jnp.searchsorted(
            hit_off, jnp.arange(H, dtype=jnp.int32), side="right")
            .astype(jnp.int32) - 1, 0, ni.shape[0] - 1)
        Sl = segl[hloc]                                           # [H,S]
        Sr = segr[hloc]
        m = (hc == 0)
        ov = jnp.any(m[:, :, None] & (hl[:, :, None] <= Sr[:, None, :])
                     & (Sl[:, None, :] <= hr[:, :, None]), axis=1)  # [H,S]
        powers = (1 << jnp.arange(8, dtype=jnp.int32))
        bits = jnp.sum(ov.reshape(H, S_MAX // 8, 8).astype(jnp.int32)
                       * powers[None, None, :], axis=2).astype(jnp.uint8)
        return compat.astype(jnp.uint8), bits

    return kern


_KERNELS = {}


def _kernel_for(Ppad: int):
    k = _KERNELS.get(Ppad)
    if k is None:
        k = _KERNELS[Ppad] = _make_kernel(Ppad)
    return k


# ---------------------------------------------------------------------------
_bound = False


def _bind(lib):
    global _bound
    if _bound:
        return lib
    from .fastlocus import _bind_quant
    _bind_quant(lib)  # strawb_quant_{binoff,counts,...} accessors
    P64 = C.POINTER(C.c_int64)
    P8 = C.POINTER(C.c_int8)
    P32 = C.POINTER(C.c_int32)
    PD = C.POINTER(C.c_double)
    PU8 = C.POINTER(C.c_uint8)
    lib.strawb_quant_segs_batch.restype = C.c_void_p
    lib.strawb_quant_segs_batch.argtypes = [
        C.c_int64, P64, P64, P64, P8, P64, P32]
    for name, rt in [("n", C.c_int64), ("off", P64), ("l", P64), ("r", P64)]:
        fn = getattr(lib, f"strawb_segs_{name}")
        fn.restype = rt
        fn.argtypes = [C.c_void_p]
    lib.strawb_segs_free.restype = None
    lib.strawb_segs_free.argtypes = [C.c_void_p]
    lib.strawb_quant_finish_batch.restype = C.c_void_p
    lib.strawb_quant_finish_batch.argtypes = [
        C.c_int64, P64, P64, P64,
        P64, P8, P64, P32, PD,
        P64, P8, P64, P32, P64,
        PU8, PU8, C.c_int64,
        PD, C.c_int64, C.c_int64, C.c_int64, C.c_int32]
    _bound = True
    return lib


class PrepState:
    """Per-run device-prep state: global isoform tensors (device-resident)
    + the global reference flat arrays for the host finish calls."""

    def __init__(self, ref_flat, rexlen: np.ndarray, pdf: np.ndarray,
                 base_lmin: int, read_len: int, long_read: bool):
        off, code, left, lens = ref_flat
        self.ref_flat = (np.ascontiguousarray(off, np.int64),
                         np.ascontiguousarray(code, np.int8),
                         np.ascontiguousarray(left, np.int64),
                         np.ascontiguousarray(lens, np.int32))
        self.rexlen = np.ascontiguousarray(rexlen, np.int64)
        self.pdf = np.ascontiguousarray(pdf, np.float64)
        self.base_lmin = int(base_lmin)
        self.read_len = int(read_len)
        self.long_read = bool(long_read)

        T = len(off) - 1
        nfeat = (off[1:] - off[:-1]).astype(np.int64)
        nex = ((nfeat + 1) // 2).astype(np.int32)
        # transcripts must strictly alternate exon/intron for the packed
        # [T, E] layout; anything else (or too many exons) routes to host
        ok = (nfeat > 0) & (nfeat % 2 == 1) & (nex <= E_MAX)
        # verify alternation cheaply: exon features sit at even offsets
        pos = np.arange(len(code), dtype=np.int64)
        start = np.repeat(off[:-1], nfeat)
        is_even = ((pos - start) % 2) == 0
        bad = np.zeros(T, bool)
        mism = (code == 0) != is_even
        if mism.any():
            tid = np.repeat(np.arange(T), nfeat)
            np.logical_or.at(bad, tid[mism], True)
        ok &= ~bad
        self.iso_ok = ok

        exl = np.zeros((T, E_MAX), np.int32)
        exr = np.full((T, E_MAX), _I32MAX, np.int32)
        inl = np.zeros((T, E_MAX), np.int32)
        inn = np.zeros((T, E_MAX), np.int32)
        eidx = np.arange(E_MAX, dtype=np.int64)
        fo = off[:-1, None] + 2 * eidx[None, :]
        emask = eidx[None, :] < nex[:, None]
        focl = np.clip(fo, 0, max(len(code) - 1, 0))
        exl[emask] = left[focl[emask]].astype(np.int32)
        exr[emask] = (left[focl[emask]] + lens[focl[emask]] - 1).astype(
            np.int32)
        imask = eidx[None, :] < (nex[:, None] - 1)
        ficl = np.clip(fo + 1, 0, max(len(code) - 1, 0))
        inl[imask] = left[ficl[imask]].astype(np.int32)
        inn[imask] = lens[ficl[imask]].astype(np.int32)
        # exr pad stays INT32_MAX so padded exons never advance eidx

        self.d_exl = jax.device_put(exl)
        self.d_exr = jax.device_put(exr)
        self.d_nex = jax.device_put(nex)
        self.d_inl = jax.device_put(inl)
        self.d_inn = jax.device_put(inn)
        self.stats = {"device_loci": 0, "host_loci": 0}
        # None = offload every eligible locus ("all" mode); an int makes
        # the pipeline self-pace: one granule of this many (hit x isoform)
        # pairs is in flight on the chip at a time (pipeline._flush)
        self.budget_pairs = None


def _native_segs(lib, iso_loc_off: np.ndarray, iso_idx: np.ndarray,
                 ref_flat):
    off, code, left, lens = ref_flat
    P64 = C.POINTER(C.c_int64)
    P8 = C.POINTER(C.c_int8)
    P32 = C.POINTER(C.c_int32)
    h = lib.strawb_quant_segs_batch(
        len(iso_loc_off) - 1,
        iso_loc_off.ctypes.data_as(P64), iso_idx.ctypes.data_as(P64),
        off.ctypes.data_as(P64), code.ctypes.data_as(P8),
        left.ctypes.data_as(P64), lens.ctypes.data_as(P32))
    try:
        nseg = lib.strawb_segs_n(h)
        nloc = len(iso_loc_off) - 1

        def arr(ptr, n):
            if n == 0:
                return np.zeros(0, np.int64)
            return np.ctypeslib.as_array(ptr, shape=(int(n),)).copy()

        seg_off = arr(lib.strawb_segs_off(h), nloc + 1)
        seg_l = arr(lib.strawb_segs_l(h), nseg)
        seg_r = arr(lib.strawb_segs_r(h), nseg)
    finally:
        lib.strawb_segs_free(h)
    return seg_off, seg_l, seg_r


def build_batch_device(cfg, read_len, insert_dist, specs, state: PrepState,
                       long_read_sample: bool = False):
    """Device-kernel equivalent of fastlocus.build_batch_native.

    specs: list of (hit_flat, hit_masses, transcripts, iso_flat, ref_ids)
    per locus (ref_ids = GLOBAL annotation indices). Loci that exceed the
    padding caps route to the host batch; everything else runs the integer
    compat/rows kernel on the device and the f64 finish on host.
    Bit-identical to the all-host path (tests/test_device_prep.py)."""
    from ..io.native import get_lib
    from .fastlocus import build_batch_native, _concat_flats
    lib = _bind(get_lib())

    nloc = len(specs)
    if nloc > L_MAX:
        out = []
        for i in range(0, nloc, L_MAX):
            out.extend(build_batch_device(cfg, read_len, insert_dist,
                                          specs[i:i + L_MAX], state,
                                          long_read_sample))
        return out

    iso_loc_off = np.zeros(nloc + 1, np.int64)
    for i, s in enumerate(specs):
        iso_loc_off[i + 1] = iso_loc_off[i] + (
            len(s[4]) if s[4] is not None else 0)
    iso_idx = np.ascontiguousarray(np.concatenate(
        [np.asarray(s[4], np.int64) for s in specs if s[4] is not None]
        + [np.zeros(0, np.int64)]), np.int64)
    seg_off, seg_l, seg_r = _native_segs(lib, iso_loc_off, iso_idx,
                                         state.ref_flat)

    nh = np.array([len(s[0][0]) - 1 for s in specs], np.int64)
    ni = iso_loc_off[1:] - iso_loc_off[:-1]
    ns = seg_off[1:] - seg_off[:-1]
    maxf = np.array([int(np.max(s[0][0][1:] - s[0][0][:-1]))
                     if len(s[0][0]) > 1 else 0 for s in specs], np.int64)
    iso_elig = np.array([s[4] is not None and len(s[4]) > 0
                         and bool(state.iso_ok[s[4]].all())
                         for s in specs], bool)
    elig = iso_elig & (ns <= S_MAX) & (maxf <= F_MAX)

    nfeat_per = np.array([int(s[0][0][-1]) for s in specs], np.int64)
    H_total = int(nh[elig].sum())
    P_total = int((nh[elig] * ni[elig]).sum())
    NF_total = int(nfeat_per[elig].sum())
    if (_tier(max(H_total, 1), _H_TIERS) is None
            or _tier(max(P_total, 1), _P_TIERS) is None
            or _tier(max(NF_total, 1), _NF_TIERS) is None):
        if nloc > 1:  # split until tiers fit
            mid = nloc // 2
            return (build_batch_device(cfg, read_len, insert_dist,
                                       specs[:mid], state, long_read_sample)
                    + build_batch_device(cfg, read_len, insert_dist,
                                         specs[mid:], state,
                                         long_read_sample))
        elig[:] = False

    dev_ids = np.nonzero(elig)[0]
    host_ids = np.nonzero(~elig)[0]
    results: List = [None] * nloc
    state.stats["device_loci"] += len(dev_ids)
    state.stats["host_loci"] += len(host_ids)

    fetch = _dispatch_device(cfg, read_len, insert_dist, specs, dev_ids,
                             seg_off, seg_l, seg_r, state, lib,
                             long_read_sample) if len(dev_ids) else None

    if len(host_ids):
        host_out = build_batch_native(
            cfg, read_len, insert_dist,
            [specs[i][:4] for i in host_ids],
            long_read_sample=long_read_sample)
        for i, est in zip(host_ids, host_out):
            results[i] = est

    if fetch is not None:
        for i, est in fetch():
            results[i] = est
    return results


def _dispatch_device(cfg, read_len, insert_dist, specs, dev_ids,
                     seg_off, seg_l, seg_r, state, lib, long_read_sample):
    """Marshal + launch the device kernel for the chosen loci; returns a
    closure that fetches the (async) result and runs the host f64 finish.
    The caller runs the host batch between dispatch and fetch so the chip
    and the host cores work concurrently."""
    from .fastlocus import _concat_flats
    if True:
        dspecs = [specs[i] for i in dev_ids]
        hit_loc, h_off, h_code, h_left, h_len = _concat_flats(
            [s[0] for s in dspecs])
        h_mass = np.ascontiguousarray(
            np.concatenate([np.asarray(s[1], np.float64) for s in dspecs])
            if dspecs else np.zeros(0), np.float64)
        d_iso_off = np.zeros(len(dspecs) + 1, np.int64)
        for i, s in enumerate(dspecs):
            d_iso_off[i + 1] = d_iso_off[i] + len(s[4])
        d_iso_idx = np.ascontiguousarray(np.concatenate(
            [np.asarray(s[4], np.int64) for s in dspecs]), np.int64)

        Hn = int(hit_loc[-1])
        NFn = int(h_off[-1])
        d_ni = (d_iso_off[1:] - d_iso_off[:-1]).astype(np.int64)
        pair_base = np.zeros(len(dspecs) + 1, np.int64)
        np.cumsum((hit_loc[1:] - hit_loc[:-1]) * d_ni, out=pair_base[1:])
        Pn = int(pair_base[-1])

        Ht = _tier(max(Hn, 1), _H_TIERS)
        NFt = _tier(max(NFn, 1), _NF_TIERS)
        Pt = _tier(max(Pn, 1), _P_TIERS)

        # padded arrays (device-side gathers handle the CSR expansion)
        def pad(a, n, dt, fill=0):
            out = np.full(n, fill, dt)
            out[:len(a)] = a
            return out

        # per-hit feature starts/counts
        goff = pad(h_off[:-1].astype(np.int32), Ht, np.int32)
        nf = pad((h_off[1:] - h_off[:-1]).astype(np.int32), Ht, np.int32)
        gc = pad(h_code, NFt, np.int8)
        gl = pad(h_left.astype(np.int32), NFt, np.int32, fill=_I32MAX)
        gn = pad(h_len.astype(np.int32), NFt, np.int32)
        pb = pad(pair_base.astype(np.int32), L_MAX + 1, np.int32,
                 fill=np.int32(Pn))
        ho = pad(hit_loc.astype(np.int32), L_MAX + 1, np.int32,
                 fill=np.int32(Hn))
        io = pad(d_iso_off.astype(np.int32), L_MAX + 1, np.int32,
                 fill=np.int32(len(d_iso_idx)))
        ii = pad(d_iso_idx.astype(np.int32), max(len(d_iso_idx), 8),
                 np.int32)
        nn = pad(d_ni.astype(np.int32), L_MAX, np.int32, fill=1)
        # seg tensors for the device loci
        d_segl = np.full((L_MAX, S_MAX), _I32MAX, np.int32)
        d_segr = np.full((L_MAX, S_MAX), -1, np.int32)
        for row, i in enumerate(dev_ids):
            a, b = int(seg_off[i]), int(seg_off[i + 1])
            d_segl[row, :b - a] = seg_l[a:b].astype(np.int32)
            d_segr[row, :b - a] = seg_r[a:b].astype(np.int32)

        kern = _kernel_for(Pt)
        compat_d, rows_d = kern(
            jnp.asarray(gc), jnp.asarray(gl), jnp.asarray(gn),
            jnp.asarray(goff), jnp.asarray(nf),
            state.d_exl, state.d_exr, state.d_nex, state.d_inl, state.d_inn,
            jnp.asarray(pb), jnp.asarray(ho), jnp.asarray(io),
            jnp.asarray(ii), jnp.asarray(nn),
            jnp.asarray(d_segl), jnp.asarray(d_segr))

    def fetch():
        compat = np.ascontiguousarray(np.asarray(compat_d)[:Pn])
        rows = np.ascontiguousarray(np.asarray(rows_d)[:Hn])

        P64 = C.POINTER(C.c_int64)
        P8 = C.POINTER(C.c_int8)
        P32 = C.POINTER(C.c_int32)
        PD = C.POINTER(C.c_double)
        PU8 = C.POINTER(C.c_uint8)
        off, code, left, lens = state.ref_flat
        q = lib.strawb_quant_finish_batch(
            len(dspecs),
            hit_loc.ctypes.data_as(P64), d_iso_off.ctypes.data_as(P64),
            d_iso_idx.ctypes.data_as(P64),
            h_off.ctypes.data_as(P64), h_code.ctypes.data_as(P8),
            h_left.ctypes.data_as(P64), h_len.ctypes.data_as(P32),
            h_mass.ctypes.data_as(PD),
            off.ctypes.data_as(P64), code.ctypes.data_as(P8),
            left.ctypes.data_as(P64), lens.ctypes.data_as(P32),
            state.rexlen.ctypes.data_as(P64),
            compat.ctypes.data_as(PU8), rows.ctypes.data_as(PU8), ROW_BYTES,
            state.pdf.ctypes.data_as(PD), len(state.pdf),
            state.read_len, state.base_lmin,
            1 if (long_read_sample or state.long_read) else 0)
        try:
            from .fastlocus import build_prebuilt_locus
            total_b = lib.strawb_quant_total_bins(q)
            total_a = lib.strawb_quant_total_alpha(q)

            def arr(ptr, n):
                if n == 0:
                    return np.zeros(0, np.float64)
                return np.ctypeslib.as_array(
                    ptr, shape=(int(n),)).astype(np.float64, copy=True)

            def arr64(ptr, n):
                return np.ctypeslib.as_array(ptr, shape=(int(n),)).copy()

            bin_off = arr64(lib.strawb_quant_binoff(q), len(dspecs) + 1)
            alpha_off = arr64(lib.strawb_quant_alphaoff(q), len(dspecs) + 1)
            counts = arr(lib.strawb_quant_counts(q), total_b)
            alpha = arr(lib.strawb_quant_alpha(q), total_a)
        finally:
            lib.strawb_quant_free(q)

        out = []
        for k, i in enumerate(dev_ids):
            s = specs[i]
            exlens = [int(state.rexlen[g]) for g in s[4]]
            b0, b1 = int(bin_off[k]), int(bin_off[k + 1])
            out.append((i, build_prebuilt_locus(
                cfg, read_len, insert_dist, s[2], exlens,
                counts[b0:b1],
                alpha[int(alpha_off[k]):int(alpha_off[k + 1])])))
        return out

    return fetch
