"""Batched EM over padded (loci, bins, isoforms) tensors.

The reference runs one Eigen EM per locus inside a thread pool
(src/estimate.cpp:411-488). Here loci are bucketed by padded shape and the
whole bucket iterates as one jitted `lax.while_loop` whose E/M steps are
batched contractions; per-locus convergence is tracked with masks.

Semantics match quant/em.py (the host oracle) exactly, using an algebraic
simplification of the reference's per-iteration F column renormalization:
renormalizing column-stochastic F is the identity, so iteration 1 uses the
raw weights and every later iteration uses the once-normalized F (the
`newF==0` quirk keeps all-zero columns zero). Convergence keeps the
PREVIOUS theta (the reference breaks before assigning), and a zero E-step
denominator on a live row aborts the locus back to theta0.
"""
from __future__ import annotations

import math
import os
from dataclasses import dataclass
from functools import partial
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..utils import jaxsetup  # noqa: F401  (enables x64)
import jax
import jax.numpy as jnp

MAX_ITER = 1000
THETA_CHANGE_LIMIT = 1e-2


def _round_up(x: int, choices: Sequence[int]) -> int:
    for c in choices:
        if x <= c:
            return c
    return choices[-1]


# Fixed tier menu: every locus EM pads into one of FOUR (rows, cols, batch)
# shapes, so the whole program compiles exactly four device kernels per
# dtype, all kept by the persistent compile cache.
_TIERS = (
    (32, 4, 128),      # typical short-read locus (median 8 rows x 1 iso)
    (128, 8, 64),
    (512, 32, 16),
    (2048, 128, 8),    # anything larger routes to the host solver
)


@partial(jax.jit, static_argnames=("max_iter",))
def _em_bucket(F_raw, u, theta0, valid_row, active, max_iter=MAX_ITER):
    """Run EM for a bucket.

    F_raw:     (B, R, C) raw bin weights (padded rows/cols zero)
    u:         (B, R)    truncated bin counts
    theta0:    (B, C)    total_count/num_iso start (padded cols zero)
    valid_row: (B, R)    rows that survived the >1e-5 filter
    active:    (B,)      real (non-padding, EM-initialized) loci
    Returns (theta_final, failed)
    """
    dt = F_raw.dtype
    colsum = jnp.sum(F_raw, axis=1, keepdims=True)            # (B,1,C)
    F_norm = jnp.where(colsum != 0, F_raw / jnp.where(colsum == 0, 1, colsum),
                       jnp.zeros_like(F_raw))

    def step_once(F, theta, theta_ref, done, failed):
        denom = jnp.einsum("brc,bc->br", F, theta,
                           preferred_element_type=dt)          # (B,R)
        row_fail = (denom == 0.0) & valid_row
        newly_failed = jnp.any(row_fail, axis=1) & ~done
        safe_denom = jnp.where(denom == 0.0, 1.0, denom)
        U = (u[:, :, None] * F * theta[:, None, :]) / safe_denom[:, :, None]
        U = jnp.where(valid_row[:, :, None], U, 0.0)
        next_theta = jnp.sum(U, axis=1)                        # (B,C)
        dist = jnp.sqrt(jnp.sum((next_theta - theta) ** 2, axis=1))
        converged = dist < THETA_CHANGE_LIMIT
        # on convergence keep the PREVIOUS theta; on failure reset to theta0
        # (EmSolver::run writes _theta only on clean exit; a zero-denominator
        # abort leaves the init value, estimate.cpp:449-452,484-487)
        step = ~done & ~converged & ~newly_failed
        theta = jnp.where(step[:, None], next_theta, theta)
        theta = jnp.where(newly_failed[:, None], theta_ref, theta)
        done = done | converged | newly_failed
        failed = failed | newly_failed
        return theta, done, failed

    def body(state):
        it, theta, done, failed = state
        theta, done, failed = step_once(F_norm, theta, theta0, done, failed)
        return it + 1, theta, done, failed

    def cond(state):
        it, _theta, done, _failed = state
        return (it < max_iter) & ~jnp.all(done)

    B = F_raw.shape[0]
    done0 = ~active
    failed0 = jnp.zeros((B,), bool)
    # iteration 1 uses the raw weights (peeled out of the loop); every later
    # iteration uses the once-normalized F
    theta1, done1, failed1 = step_once(F_raw, theta0, theta0, done0, failed0)
    init = (jnp.asarray(1, jnp.int32), theta1, done1, failed1)
    _, theta, _, failed = jax.lax.while_loop(cond, body, init)
    return theta, failed


@dataclass
class LocusProblem:
    """One locus' EM inputs, produced on host from a LocusContext."""
    counts: np.ndarray          # (r,) int truncated bin counts (all rows)
    weights: np.ndarray         # (r, c) raw bin weights (all rows)

    def filtered(self):
        keep = (self.weights > 1e-5).any(axis=1)
        return self.counts[keep], self.weights[keep]


class EmDispatcher:
    """Incremental device EM dispatch over the fixed tier menu.

    `add()` routes each locus problem into the smallest tier that fits it
    and launches a device batch the moment a tier's fixed-size batch
    fills. Padding, host->device transfer and kernel launch run on a
    dedicated worker thread, so the device solves EM batches while the
    host keeps streaming clusters and building the next loci.
    `finish()` flushes partial batches, joins the worker, fetches every
    launched batch, and returns per-problem theta (None = EM init
    failure: no surviving rows, matching EmSolver::init returning false,
    estimate.cpp:374-391).

    Routing: the golden f64 EM runs on the host. `fast_em` sends every
    problem that fits the menu to the device in f32; STRAWB_DEVICE_EM=1
    sends them in f64. STRAWB_FORCE_HOST keeps everything on the host.
    n_device / n_host count the routing for the profile and the bench."""

    def __init__(self, n_problems: int = 0, fast_em: bool = False):
        # grows on demand in add(); pass n_problems when known upfront
        self.results: List[Optional[np.ndarray]] = [None] * n_problems
        self.fast_em = fast_em
        self.force_host = bool(os.environ.get("STRAWB_FORCE_HOST")) or (
            not fast_em and not os.environ.get("STRAWB_DEVICE_EM"))
        # per-tier fill state: list of (idx, u, F, total, niso)
        self._fills: List[List[tuple]] = [[] for _ in _TIERS]
        self._host_items: List[tuple] = []
        self._launched: List[tuple] = []  # (device theta, items) to fetch
        self._futures: List = []
        self._pool = None
        self.n_device = 0
        self.n_host = 0

    def _submit(self, fn, *args):
        if self._pool is None:
            from concurrent.futures import ThreadPoolExecutor
            self._pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="em-dispatch")
        self._futures.append(self._pool.submit(fn, *args))

    def add(self, idx: int, p: "LocusProblem"):
        if idx >= len(self.results):
            self.results.extend([None] * (idx + 1 - len(self.results)))
        total = float(p.counts.sum())
        niso = p.weights.shape[1]
        u, F = p.filtered()
        if u.size == 0:
            return  # init failure -> results[idx] stays None
        item = (idx, u, F, total, niso)
        if not self.force_host:
            for t, (rb, cb, bb) in enumerate(_TIERS):
                if F.shape[0] <= rb and niso <= cb:
                    self._fills[t].append(item)
                    self.n_device += 1
                    if len(self._fills[t]) == bb:
                        self._launch(t)
                    return
        self._host_items.append(item)
        self.n_host += 1

    def _launch(self, tier: int):
        items, self._fills[tier] = self._fills[tier], []
        self._submit(self._run_batch, tier, items)

    def _run_batch(self, tier: int, items: List[tuple]):
        """Worker-thread body: pad, transfer, launch — without fetching.
        JAX dispatch is async, so the worker returns at once and the
        device queues batch after batch; finish() fetches them all."""
        rb, cb, bb = _TIERS[tier]
        F = np.zeros((bb, rb, cb), dtype=np.float64)
        u = np.zeros((bb, rb), dtype=np.float64)
        theta0 = np.zeros((bb, cb), dtype=np.float64)
        valid = np.zeros((bb, rb), dtype=bool)
        active = np.zeros((bb,), dtype=bool)
        for b, (idx, uu, FF, total, niso) in enumerate(items):
            r = FF.shape[0]
            F[b, :r, :niso] = FF
            u[b, :r] = uu
            theta0[b, :niso] = total / niso
            valid[b, :r] = True
            active[b] = True
        if self.fast_em:
            theta = fast_em_bucket(F, u, theta0, valid, active)
        else:
            theta, _failed = _em_bucket(jnp.asarray(F), jnp.asarray(u),
                                        jnp.asarray(theta0),
                                        jnp.asarray(valid),
                                        jnp.asarray(active))
        # single worker thread => no concurrent writers; finish() joins
        # the worker before fetching
        self._launched.append((theta, items))

    def finish(self) -> List[Optional[np.ndarray]]:
        from ..utils.profiling import GLOBAL as PROF
        for t in range(len(_TIERS)):
            if self._fills[t]:
                self._launch(t)
        if self._host_items:
            with PROF.phase("host_em", items=self.n_host):
                _host_em_batch(self._host_items, self.results)
        with PROF.phase("device_em_fetch", items=self.n_device):
            for f in self._futures:
                f.result()   # propagate worker exceptions
            for theta_d, _items in self._launched:
                theta_d.copy_to_host_async()  # overlap the transfers
            for theta_d, items in self._launched:
                theta = np.asarray(theta_d, np.float64)
                for b, (idx, _uu, _FF, _total, niso) in enumerate(items):
                    self.results[idx] = theta[b, :niso]
            self._launched = []
        if self._pool is not None:
            self._pool.shutdown(wait=True)
        return self.results


def fast_em_bucket(F_raw, u, theta0, valid_row, active):
    """The --fast-em kernel: f32 theta (B, C) for one padded bucket, from
    the single-launch Triton EM (quant/em_triton.py), compiled for the
    GPU: without one it fails rather than fall back to a slow path."""
    from .em_triton import em_bucket_triton
    args = [jnp.asarray(np.asarray(a, np.float32)) for a in (F_raw, u, theta0)]
    args += [jnp.asarray(valid_row), jnp.asarray(active)]
    return em_bucket_triton(*args)


def batched_em(problems: List[LocusProblem],
               fast_em: bool = False,
               ) -> List[Optional[np.ndarray]]:
    """Solve many per-locus EMs with fixed-tier batching, routed as
    EmDispatcher routes them.

    Returns per-problem theta (or None when EM init fails — no surviving
    rows — matching EmSolver::init returning false)."""
    d = EmDispatcher(len(problems), fast_em=fast_em)
    for idx, p in enumerate(problems):
        d.add(idx, p)
    return d.finish()


_native_em = None


def _get_native_em():
    global _native_em
    if _native_em is None:
        try:
            import ctypes as C
            from ..io.native import get_lib
            lib = get_lib()
            P64 = C.POINTER(C.c_int64)
            PD = C.POINTER(C.c_double)
            lib.strawb_em_batch.restype = None
            lib.strawb_em_batch.argtypes = [
                C.c_int64, P64, P64, P64, PD, PD, PD, P64, PD, C.c_int64]
            _native_em = lib.strawb_em_batch
        except Exception:
            _native_em = False
    return _native_em


_native_em_raw = None


def _get_native_em_raw():
    global _native_em_raw
    if _native_em_raw is None:
        try:
            import ctypes as C
            from ..io.native import get_lib
            lib = get_lib()
            P64 = C.POINTER(C.c_int64)
            PD = C.POINTER(C.c_double)
            PU8 = C.POINTER(C.c_uint8)
            lib.strawb_em_batch_raw.restype = None
            lib.strawb_em_batch_raw.argtypes = [
                C.c_int64, P64, P64, PD, PD, P64, P64, PD, PU8, C.c_int64]
            _native_em_raw = lib.strawb_em_batch_raw
        except Exception:
            _native_em_raw = False
    return _native_em_raw


def host_em_raw_available() -> bool:
    return bool(_get_native_em_raw())


def host_em_batch_raw(counts_list, alpha_list, niso_list):
    """Solve raw quant-prep locus slices in one native call (em.cc
    strawb_em_batch_raw): trunc + pairwise total + row filter + theta0 +
    EM, per locus. Returns (theta_flat, th_off, status) — status 0 =
    init failure (results None upstream)."""
    import ctypes as C
    import os
    fn = _get_native_em_raw()
    n = len(counts_list)
    nb = np.fromiter((len(c) for c in counts_list), np.int64, n)
    niso = np.fromiter(niso_list, np.int64, n)
    bin_off = np.zeros(n + 1, np.int64)
    np.cumsum(nb, out=bin_off[1:])
    alpha_off = np.zeros(n + 1, np.int64)
    np.cumsum(nb * niso, out=alpha_off[1:])
    th_off = np.zeros(n + 1, np.int64)
    np.cumsum(niso, out=th_off[1:])
    counts_flat = np.ascontiguousarray(
        np.concatenate(counts_list) if n else np.zeros(0))
    alpha_flat = np.ascontiguousarray(
        np.concatenate(alpha_list) if n else np.zeros(0))
    theta = np.zeros(max(int(th_off[-1]), 1), np.float64)
    status = np.zeros(max(n, 1), np.uint8)

    def p(a, ct):
        return a.ctypes.data_as(C.POINTER(ct))

    fn(n, p(bin_off, C.c_int64), p(niso, C.c_int64),
       p(counts_flat, C.c_double), p(alpha_flat, C.c_double),
       p(alpha_off, C.c_int64), p(th_off, C.c_int64),
       p(theta, C.c_double), p(status, C.c_uint8),
       min(4, os.cpu_count() or 1))
    return theta, th_off, status


def _host_em_batch(items, results):
    """Solve host-routed EM problems in one native batch call (em.cc);
    per-problem numpy oracle fallback."""
    import ctypes as C
    fn = _get_native_em()
    if not fn:
        from .em import em_run
        for (idx, uu, FF, total, niso) in items:
            # rows here are already >1e-5-filtered; theta0 uses the
            # unfiltered count total, as EmSolver::init does
            theta0 = np.full(niso, total / niso, dtype=np.float64)
            theta = em_run(uu.astype(np.float64), FF, theta0)
            if theta is None:
                theta = theta0
            results[idx] = theta
        return
    n = len(items)
    u_off = np.zeros(n + 1, np.int64)
    F_off = np.zeros(n + 1, np.int64)
    th_off = np.zeros(n + 1, np.int64)
    ncol = np.zeros(n, np.int64)
    theta0 = np.zeros(n, np.float64)
    for k, (idx, uu, FF, total, niso) in enumerate(items):
        u_off[k + 1] = u_off[k] + len(uu)
        F_off[k + 1] = F_off[k] + FF.size
        th_off[k + 1] = th_off[k] + niso
        ncol[k] = niso
        theta0[k] = total / niso
    u_flat = np.ascontiguousarray(
        np.concatenate([np.asarray(it[1], np.float64) for it in items]))
    F_flat = np.ascontiguousarray(
        np.concatenate([np.asarray(it[2], np.float64).ravel()
                        for it in items]))
    out = np.zeros(int(th_off[-1]), np.float64)
    P64 = C.POINTER(C.c_int64)
    PD = C.POINTER(C.c_double)
    fn(n, u_off.ctypes.data_as(P64), F_off.ctypes.data_as(P64),
       ncol.ctypes.data_as(P64), theta0.ctypes.data_as(PD),
       u_flat.ctypes.data_as(PD), F_flat.ctypes.data_as(PD),
       th_off.ctypes.data_as(P64), out.ctypes.data_as(PD),
       min(2, os.cpu_count() or 1))
    for k, (idx, _uu, _FF, _total, niso) in enumerate(items):
        results[idx] = out[int(th_off[k]):int(th_off[k + 1])]
