"""Batched assembly kernel on the JAX device.

`batched_mcf`: the constrained-minimum-path-cover flow solve as a batched
DP — synchronous Bellman-Ford relaxations are masked min-plus reductions
over padded (B, M, M) residual matrices, iterated under a
`lax.while_loop` of successive-shortest-path augmentations. Exactly the
integer algorithm of assembly/mincostflow.py (the numpy spec), so results
are bit-identical; loci are bucketed by padded node count.
"""
from __future__ import annotations

from functools import partial
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..utils import jaxsetup  # noqa: F401
import jax
import jax.numpy as jnp

INF = np.int64(1) << 50


@partial(jax.jit, static_argnames=("max_aug",))
def _mcf_bucket(cost, has_arc, lower, active, max_aug=4096):
    """cost/lower: (B,M,M) int64; has_arc: (B,M,M) bool; active: (B,).
    Returns (flow (B,M,M) int64, infeasible (B,) bool)."""
    B, M, _ = cost.shape
    flow0 = lower
    idx = jnp.arange(M, dtype=jnp.int64)

    def excess_of(flow):
        return flow.sum(axis=1) - flow.sum(axis=2)   # in - out per node

    def body(state):
        it, flow, done, infeasible = state
        excess = excess_of(flow)
        pos = excess > 0
        neg = excess < 0
        work = ~done & pos.any(axis=1)

        bwd_cap = jnp.swapaxes(flow - lower, 1, 2)
        has_bwd = jnp.swapaxes(has_arc, 1, 2) & (bwd_cap > 0)
        rc_fwd = jnp.where(has_arc, cost, INF)
        rc_bwd = jnp.where(has_bwd, -jnp.swapaxes(cost, 1, 2), INF)
        rc = jnp.minimum(rc_fwd, rc_bwd)
        use_bwd = rc_bwd < rc_fwd

        dist0 = jnp.where(pos, jnp.int64(0), INF)
        pred0 = jnp.full((B, M), -1, dtype=jnp.int64)

        def relax(_, dp):
            dist, pred = dp
            cand = dist[:, :, None] + rc             # (B,u,v)
            cand = jnp.where(rc >= INF, INF, cand)
            best = cand.min(axis=1)
            bu = cand.argmin(axis=1).astype(jnp.int64)
            improved = best < dist
            return (jnp.where(improved, best, dist),
                    jnp.where(improved, bu, pred))

        dist, pred = jax.lax.fori_loop(0, M, relax, (dist0, pred0))

        tdist = jnp.where(neg, dist, INF)
        t = tdist.argmin(axis=1).astype(jnp.int64)   # (B,)
        t_unreach = jnp.take_along_axis(tdist, t[:, None], 1)[:, 0] >= INF
        newly_infeasible = work & t_unreach

        # mark path edges by walking pred from t (at most M steps)
        def walk(_, st):
            v, onpath, bott, src = st
            u = jnp.take_along_axis(pred, v[:, None], 1)[:, 0]
            stop = u < 0
            uu = jnp.where(stop, v, u)
            edge = (~stop)[:, None, None] & \
                (idx[None, :, None] == uu[:, None, None]) & \
                (idx[None, None, :] == v[:, None, None])
            onpath = onpath | edge
            cap = jnp.where(use_bwd, bwd_cap, INF)
            ecap = jnp.where(edge, cap, INF).min(axis=(1, 2))
            bott = jnp.minimum(bott, ecap)
            src = jnp.where(stop, v, src)
            return (uu, onpath, bott, src)

        onpath0 = jnp.zeros((B, M, M), dtype=bool)
        bott0 = jnp.full((B,), INF, dtype=jnp.int64)
        src0 = t
        v_fin, onpath, bott, src = jax.lax.fori_loop(
            0, M, walk, (t, onpath0, bott0, src0))

        exc_s = jnp.take_along_axis(excess_of(flow), src[:, None], 1)[:, 0]
        exc_t = -jnp.take_along_axis(excess_of(flow), t[:, None], 1)[:, 0]
        b = jnp.minimum(jnp.minimum(bott, exc_s), exc_t)
        do = (work & ~newly_infeasible)
        b = jnp.where(do, b, 0)

        delta = jnp.where(onpath & use_bwd, -b[:, None, None], 0)
        delta_T = jnp.swapaxes(delta, 1, 2)          # cancellation on v->u
        add = jnp.where(onpath & ~use_bwd, b[:, None, None], 0)
        flow = flow + add + delta_T

        infeasible = infeasible | newly_infeasible
        has_excess = (excess_of(flow) > 0).any(axis=1)
        done = ~has_excess | infeasible
        return it + 1, flow, done, infeasible

    def cond(state):
        it, _flow, done, _inf = state
        return (it < max_aug) & ~jnp.all(done)

    done0 = ~active | ~(excess_of(flow0) > 0).any(axis=1)
    init = (jnp.asarray(0, jnp.int64), flow0, done0,
            jnp.zeros((B,), bool))
    _, flow, _, infeasible = jax.lax.while_loop(cond, body, init)
    return flow, infeasible


# device dispatches use FIXED (nodes, batch) shapes so the whole program
# compiles at most three flow kernels, all kept by the persistent cache
_DEVICE_SHAPES = {64: 16, 128: 8, 256: 4}


def batched_mcf(problems: List[Tuple[np.ndarray, np.ndarray, np.ndarray]],
                device_min_nodes: int = 128,
                stats: Optional[Dict[str, int]] = None
                ) -> List[Optional[np.ndarray]]:
    """Solve many dense MCF problems, bucketed by node count.

    problems: [(cost, has_arc, lower)] with (M,M) matrices.
    Graphs below device_min_nodes (or above the largest device shape)
    solve on host with the native SSP; the rest batch on the device,
    where the dense min-plus relaxations run as one masked reduction per
    step. Both paths are the identical integer algorithm, so flows are
    bit-equal. Where the crossover lies on a given card is measured, not
    assumed. Returns per-problem flow matrix or None (infeasible)."""
    import os
    if os.environ.get("STRAWB_FORCE_HOST"):
        device_min_nodes = 1 << 30
    from .mincostflow import solve_dense
    results: List[Optional[np.ndarray]] = [None] * len(problems)
    buckets: Dict[int, List[int]] = {}
    n_dev = 0
    for i, (c, _h, _l) in enumerate(problems):
        m = c.shape[0]
        mb = next((b for b in _DEVICE_SHAPES if m <= b), None)
        if m < device_min_nodes or mb is None:
            results[i] = solve_dense(*[x.copy() for x in problems[i]])
            continue
        buckets.setdefault(mb, []).append(i)
        n_dev += 1
    if stats is not None:
        stats["device"] = stats.get("device", 0) + n_dev
        stats["host"] = stats.get("host", 0) + len(problems) - n_dev

    for mb, idxs in sorted(buckets.items()):
        B = _DEVICE_SHAPES[mb]
        for lo in range(0, len(idxs), B):
            chunk = idxs[lo:lo + B]
            cost = np.zeros((B, mb, mb), np.int64)
            has = np.zeros((B, mb, mb), bool)
            low = np.zeros((B, mb, mb), np.int64)
            act = np.zeros((B,), bool)
            for b, i in enumerate(chunk):
                c, h, l = problems[i]
                m = c.shape[0]
                cost[b, :m, :m] = c
                has[b, :m, :m] = h
                low[b, :m, :m] = l
                act[b] = True
            flow, infeasible = _mcf_bucket(
                jnp.asarray(cost), jnp.asarray(has), jnp.asarray(low),
                jnp.asarray(act))
            flow, infeasible = np.asarray(flow), np.asarray(infeasible)
            for b, i in enumerate(chunk):
                m = problems[i][0].shape[0]
                results[i] = None if infeasible[b] else flow[b, :m, :m]
    return results
