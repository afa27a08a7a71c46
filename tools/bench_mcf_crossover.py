#!/usr/bin/env python
"""Device-vs-host crossover benchmark for the flow solve.

Generates splice-graph-shaped min-cost-flow instances (layered DAG of exon
segments, K covering paths providing feasible lower bounds, costs =
max_weight - support as in assembly/flow.py) at node counts 16..256 and
times, steady-state:

  host   — native SSP (mincostflow.solve_dense / native/mcf.cc), per
           problem in a loop (how the pipeline actually runs them)
  device — the batched `_mcf_bucket` while_loop dispatch on the default
           JAX device, per bucket (compile excluded by a warm-up)

and cross-checks that both produce identical flows. Prints one JSON
summary naming the card (nvidia-smi name and power limit) and the JAX
device.

Run: python tools/bench_mcf_crossover.py            (default JAX device)
     JAX_PLATFORMS=cpu python tools/...             (CPU backend)
"""
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def make_problem(rng, M: int, n_paths: int):
    """Feasible dense-MCF instance shaped like a constrained path cover:
    nodes sorted genomically, source=0 / sink=M-1, forward arcs only,
    lower bound 1 on every covering-path arc (the reference's constraint
    arcs, src/assembly.cpp:735-763), cost = max_weight - support."""
    cost = np.zeros((M, M), np.int64)
    has = np.zeros((M, M), bool)
    lower = np.zeros((M, M), np.int64)
    support = np.zeros((M, M), np.int64)
    for _ in range(n_paths):
        k = rng.integers(2, max(3, M // 2))
        inner = rng.choice(np.arange(1, M - 1), size=min(k, M - 2),
                           replace=False)
        path = np.concatenate([[0], np.sort(inner), [M - 1]])
        for u, v in zip(path[:-1], path[1:]):
            has[u, v] = True
            support[u, v] += rng.integers(1, 50)
    # adjacency arcs between consecutive segments (weak support)
    for u in range(1, M - 2):
        has[u, u + 1] = True
        support[u, u + 1] += 1
    maxw = support.max() + 1
    cost[has] = maxw - support[has]
    # constraint arcs: lower bound 1 on the best-supported interior arcs
    interior = has.copy()
    interior[0, :] = False
    interior[:, M - 1] = False
    cand = np.argwhere(interior)
    if len(cand):
        take = cand[rng.permutation(len(cand))[:max(1, len(cand) // 4)]]
        lower[take[:, 0], take[:, 1]] = 1
    # circulation arc sink->source keeps the cover feasible
    has[M - 1, 0] = True
    cost[M - 1, 0] = 0
    return cost, has, lower


def main():
    from strawberry_tpu.assembly.mincostflow import solve_dense
    from strawberry_tpu.assembly import device as dev
    from strawberry_tpu.utils.jaxsetup import card, device_info
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(7)
    rows = []
    for M, B in [(16, 64), (32, 32), (64, 16), (128, 8), (256, 4)]:
        probs = [make_problem(rng, M, n_paths=max(3, M // 8))
                 for _ in range(B)]

        # ---- host: native SSP per problem ----
        t_host = 1e18
        for _ in range(3):
            t0 = time.perf_counter()
            host_flows = [solve_dense(c.copy(), h.copy(), l.copy())
                          for c, h, l in probs]
            t_host = min(t_host, time.perf_counter() - t0)

        # ---- device: one padded bucket dispatch ----
        cost = np.zeros((B, M, M), np.int64)
        has = np.zeros((B, M, M), bool)
        low = np.zeros((B, M, M), np.int64)
        act = np.ones((B,), bool)
        for b, (c, h, l) in enumerate(probs):
            cost[b], has[b], low[b] = c, h, l
        args = (jnp.asarray(cost), jnp.asarray(has), jnp.asarray(low),
                jnp.asarray(act))
        jax.block_until_ready(dev._mcf_bucket(*args))   # compile warm-up
        t_dev = 1e18
        for _ in range(3):
            t0 = time.perf_counter()
            flow, infeasible = jax.block_until_ready(dev._mcf_bucket(*args))
            t_dev = min(t_dev, time.perf_counter() - t0)

        # ---- cross-check identical flows ----
        flow = np.asarray(flow)
        infeasible = np.asarray(infeasible)
        mismatch = 0
        for b in range(B):
            hf = host_flows[b]
            if hf is None:
                mismatch += 0 if infeasible[b] else 1
            else:
                mismatch += 0 if (not infeasible[b]
                                  and np.array_equal(hf, flow[b])) else 1
        rows.append(dict(
            nodes=M, batch=B,
            host_us_per_problem=round(t_host / B * 1e6, 1),
            device_us_per_problem=round(t_dev / B * 1e6, 1),
            device_speedup=round(t_host / t_dev, 3),
            mismatches=mismatch))
        print(rows[-1])

    print(json.dumps(dict(
        card=card(), device=device_info(), rows=rows,
        note="host = native SSP loop; device = batched _mcf_bucket "
             "dispatch, steady-state (compile excluded)")))


if __name__ == "__main__":
    main()
