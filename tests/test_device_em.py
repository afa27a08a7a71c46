"""Device batched EM vs the host oracle (quant/em.py)."""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from strawberry_tpu.quant.device import LocusProblem, batched_em
from strawberry_tpu.quant.em import em_init, em_run


def random_problems(rng, n, max_rows=40, max_cols=6):
    problems = []
    for _ in range(n):
        r = rng.integers(1, max_rows)
        c = rng.integers(1, max_cols)
        W = rng.random((r, c)) * rng.random((r, c))
        # sprinkle zeros and tiny values (sub-1e-5 rows get dropped)
        W[rng.random((r, c)) < 0.4] = 0.0
        W[rng.random((r, c)) < 0.1] = 1e-6
        counts = rng.integers(0, 500, size=r).astype(np.float64)
        problems.append(LocusProblem(counts=counts, weights=W))
    return problems


def host_solve(p: LocusProblem):
    init = em_init(p.weights.shape[1], p.counts, p.weights)
    if init is None:
        return None
    theta = em_run(*init)
    if theta is None:
        theta = init[2]
    return theta


@pytest.mark.parametrize("force_host", [False, True])
def test_batched_em_matches_host_oracle(force_host, monkeypatch):
    # STRAWB_DEVICE_EM=1 routes every problem to the f64 device tier
    # kernels; STRAWB_FORCE_HOST routes everything to the host solver
    monkeypatch.setenv("STRAWB_DEVICE_EM", "1")
    if force_host:
        monkeypatch.setenv("STRAWB_FORCE_HOST", "1")
    rng = np.random.default_rng(0)
    problems = random_problems(rng, 60)
    dev = batched_em(problems)
    for i, p in enumerate(problems):
        host = host_solve(p)
        if host is None:
            assert dev[i] is None
        else:
            assert dev[i] is not None
            np.testing.assert_allclose(dev[i], host, rtol=1e-9, atol=1e-9,
                                       err_msg=f"problem {i}")


def test_batched_em_zero_denominator_failure():
    # a valid row (weight > 1e-5) whose denominator can be zero only if
    # theta has zeros — engineer: two isoforms, one bin each, disjoint
    W = np.array([[0.5, 0.0], [0.0, 0.4]])
    counts = np.array([10.0, 0.0])
    p = LocusProblem(counts=counts, weights=W)
    host = host_solve(p)
    dev = batched_em([p])[0]
    np.testing.assert_allclose(dev, host, rtol=1e-9)


def test_batched_em_all_rows_dropped():
    p = LocusProblem(counts=np.array([3.0]), weights=np.array([[1e-6]]))
    assert host_solve(p) is None
    assert batched_em([p])[0] is None


def test_em_dispatcher_routing_counts(monkeypatch):
    """The golden f64 path solves on host; with STRAWB_DEVICE_EM=1 every
    fitting problem dispatches to the device tiers."""
    from strawberry_tpu.quant.device import EmDispatcher, _TIERS
    rng = np.random.default_rng(1)
    problems = random_problems(rng, 40)
    n_fit = sum(1 for p in problems if p.filtered()[0].size > 0)

    # default golden mode: host carries the f64 EM
    d0 = EmDispatcher()
    for i, p in enumerate(problems):
        d0.add(i, p)
    r0 = d0.finish()
    assert d0.n_host == n_fit and d0.n_device == 0

    # forced device mode: everything that fits the menu goes on-chip
    monkeypatch.setenv("STRAWB_DEVICE_EM", "1")
    d = EmDispatcher()
    for i, p in enumerate(problems):
        d.add(i, p)
    res = d.finish()
    assert d.n_device == n_fit and d.n_host == 0
    for a, b in zip(r0, res):  # same numerics either way (device f64 vs
        assert (a is None) == (b is None)  # host: 1e-9, like the oracle
        if a is not None:                  # parity tests above)
            np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-9)
    # oversized problems fall back to the host solver
    big_r = _TIERS[-1][0] + 1
    big = LocusProblem(counts=np.ones(big_r),
                       weights=np.full((big_r, 2), 0.5))
    d2 = EmDispatcher()
    d2.add(0, big)
    r2 = d2.finish()
    assert d2.n_host == 1 and d2.n_device == 0 and r2[0] is not None


def test_fast_em_routes_every_fitting_problem_to_device(monkeypatch):
    """--fast-em sends every problem that fits the tier menu to the device,
    from the first one on (no host-first threshold)."""
    import jax.numpy as jnp
    from strawberry_tpu.quant import device as qdev
    from strawberry_tpu.quant.device import EmDispatcher
    from strawberry_tpu.quant.em_triton import em_bucket_triton
    monkeypatch.delenv("STRAWB_DEVICE_EM", raising=False)
    # the Triton kernel compiles only for a GPU: run it in the interpreter
    monkeypatch.setattr(qdev, "fast_em_bucket", lambda F, u, t0, v, a:
                        em_bucket_triton(jnp.asarray(F, jnp.float32),
                                         jnp.asarray(u, jnp.float32),
                                         jnp.asarray(t0, jnp.float32),
                                         jnp.asarray(v), jnp.asarray(a),
                                         interpret=True))
    rng = np.random.default_rng(2)
    problems = random_problems(rng, 30)
    n_fit = sum(1 for p in problems if p.filtered()[0].size > 0)
    d = EmDispatcher(fast_em=True)
    for i, p in enumerate(problems):
        d.add(i, p)
        assert d.n_host == 0
    res = d.finish()
    assert d.n_device == n_fit and d.n_host == 0
    for i, p in enumerate(problems):
        host = host_solve(p)
        assert (host is None) == (res[i] is None)
        if host is not None:
            err = np.abs(res[i] - host) / max(1.0, host.sum())
            assert err.max() < 1e-3, (i, err.max())


def tier_bucket(rng, R, C, B, n_active):
    """A full (B, R, C) tier bucket with n_active random loci, and the f64
    host oracle's theta (quant/em.py) for each active one."""
    F = np.zeros((B, R, C))
    u = np.zeros((B, R))
    theta0 = np.zeros((B, C))
    valid = np.zeros((B, R), bool)
    active = np.zeros((B,), bool)
    oracle = np.zeros((B, C))
    for b in range(n_active):
        r = int(rng.integers(max(1, R // 4), R // 2 + 1))
        c = int(rng.integers(1, C + 1))
        W = rng.random((r, c)) * rng.random((r, c))
        W[rng.random((r, c)) < 0.4] = 0.0
        W[np.arange(r), rng.integers(0, c, r)] += 0.01  # every row survives
        cnt = rng.integers(0, 300, r).astype(np.float64)
        F[b, :r, :c] = W
        u[b, :r] = cnt
        theta0[b, :c] = cnt.sum() / c
        valid[b, :r] = True
        active[b] = True
        th = em_run(cnt, W, theta0[b, :c])
        oracle[b, :c] = theta0[b, :c] if th is None else th
    return (F, u, theta0, valid, active), oracle


def _check_f32(theta, oracle, theta0, active):
    theta = np.asarray(theta, np.float64)
    # error over the locus' total: a locus that stops one iteration earlier
    # or later in f32 moves theta by less than the 1e-2 convergence step
    err = np.abs(theta - oracle)[active] / np.maximum(
        1.0, oracle[active].sum(axis=1, keepdims=True))
    assert np.quantile(err, 0.99) <= 1e-4, np.quantile(err, 0.99)
    np.testing.assert_array_equal(theta[~active],
                                  theta0[~active].astype(np.float32))


def test_fast_em_bucket_needs_a_gpu():
    """--fast-em compiles its kernel for the GPU and has no CPU fallback:
    on the CPU backend the dispatch fails instead of running slowly."""
    import jax
    if jax.default_backend() != "cpu":
        pytest.skip("a GPU compiles the kernel; the CPU-only failure is "
                    "what this test checks")
    from strawberry_tpu.quant.device import _TIERS, fast_em_bucket
    R, C, B = _TIERS[0]
    with pytest.raises(ValueError, match="interpret mode"):
        jax.block_until_ready(fast_em_bucket(
            np.ones((B, R, C)), np.ones((B, R)), np.ones((B, C)),
            np.ones((B, R), bool), np.ones((B,), bool)))


@pytest.mark.parametrize("tier", range(4))
def test_em_triton_interpret_matches_f64_oracle(tier):
    """The single-launch Triton EM kernel, run by the Pallas interpreter,
    against the f64 host oracle at the tier's full bucket shape."""
    import jax.numpy as jnp
    from strawberry_tpu.quant.device import _TIERS
    from strawberry_tpu.quant.em_triton import em_bucket_triton, tile_shape
    R, C, B = _TIERS[tier]
    tb, rb = tile_shape(B, R, C)
    assert B % tb == 0 and R % rb == 0
    rng = np.random.default_rng(20 + tier)
    (F, u, t0, valid, active), oracle = tier_bucket(
        rng, R, C, B, n_active=min(B - 1, 16 if tier < 3 else 2))
    theta = em_bucket_triton(jnp.asarray(F), jnp.asarray(u),
                             jnp.asarray(t0), jnp.asarray(valid),
                             jnp.asarray(active), interpret=True)
    assert theta.shape == (B, C) and theta.dtype == jnp.float32
    _check_f32(theta, oracle, t0, active)
