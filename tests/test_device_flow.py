"""Batched device min-cost-flow vs the numpy spec, on random DAG-with-
circulation problems shaped like real CMPC graphs."""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from strawberry_tpu.assembly.device import batched_mcf
from strawberry_tpu.assembly.mincostflow import solve_dense


def random_cmpc_problem(rng, n_exons):
    """Random DAG over exon nodes + source/sink + circulation arc, with
    lower bounds on a subset of arcs — the CMPC flow shape."""
    M = n_exons + 2
    src, snk = n_exons, n_exons + 1
    has = np.zeros((M, M), bool)
    cost = np.zeros((M, M), np.int64)
    lower = np.zeros((M, M), np.int64)
    for u in range(n_exons):
        for v in range(u + 1, n_exons):
            if rng.random() < (0.6 if v == u + 1 else 0.15):
                has[u, v] = True
                cost[u, v] = rng.integers(0, 50)
                lower[u, v] = 1 if rng.random() < 0.7 else 0
    for v in range(n_exons):
        if not has[:n_exons, v].any():
            has[src, v] = True
        if not has[v, :n_exons].any():
            has[v, snk] = True
    has[snk, src] = True
    return cost, has, lower


def test_device_mcf_matches_numpy_spec():
    rng = np.random.default_rng(1)
    problems = [random_cmpc_problem(rng, int(rng.integers(2, 24)))
                for _ in range(40)]
    dev = batched_mcf(problems, device_min_nodes=0)
    for i, p in enumerate(problems):
        host = solve_dense(*[x.copy() for x in p])
        if host is None:
            assert dev[i] is None, i
        else:
            assert dev[i] is not None, i
            np.testing.assert_array_equal(dev[i], host, err_msg=f"prob {i}")


def test_device_mcf_infeasible():
    # lower bound on an arc into a node with no outgoing path to recirculate
    M = 3
    has = np.zeros((M, M), bool)
    cost = np.zeros((M, M), np.int64)
    lower = np.zeros((M, M), np.int64)
    has[0, 1] = True
    lower[0, 1] = 1   # no way back to node 0: infeasible circulation
    assert solve_dense(cost.copy(), has.copy(), lower.copy()) is None
    assert batched_mcf([(cost, has, lower)],
                       device_min_nodes=0)[0] is None


def test_batched_mcf_device_path_has_no_fallback(monkeypatch):
    """Every problem routed to the device is solved there — no watchdog
    hands a slow dispatch to the host — and the flows equal the spec."""
    import strawberry_tpu.assembly.device as dev
    assert not hasattr(dev, "_device_disabled")
    assert not hasattr(dev, "_device_solve_with_timeout")
    monkeypatch.delenv("STRAWB_FORCE_HOST", raising=False)
    calls = []
    orig = dev._mcf_bucket

    def counting(*args, **kw):
        calls.append(args[0].shape)
        return orig(*args, **kw)

    monkeypatch.setattr(dev, "_mcf_bucket", counting)
    rng = np.random.default_rng(3)
    problems = [random_cmpc_problem(rng, int(rng.integers(30, 60)))
                for _ in range(20)]
    stats = {}
    out = batched_mcf(problems, device_min_nodes=0, stats=stats)
    assert stats == {"device": 20, "host": 0}
    assert calls and all(s == (16, 64, 64) for s in calls)
    for i, p in enumerate(problems):
        host = solve_dense(*[x.copy() for x in p])
        assert (host is None) == (out[i] is None), i
        if host is not None:
            np.testing.assert_array_equal(out[i], host, err_msg=f"prob {i}")
