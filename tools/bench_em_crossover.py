#!/usr/bin/env python
"""Device-vs-host EM crossover on REAL locus problems.

Captures every locus EM problem (u, F, total, niso) from a full pipeline
run on the 10M-read dataset (or the BENCH_BAM / BENCH_GTF pair) by
shimming EmDispatcher.add, then times three solvers over the identical
problem set:

  host        — the native C++ EM batch (quant/em.cc via _host_em_batch),
                threaded, exactly as the pipeline's host path runs it
  device_f64  — the fixed-tier jit _em_bucket dispatches (golden numerics)
  device_f32  — the --fast-em kernel over the same tiers

Steady-state timing (warm-up dispatch per tier first; every timing blocks
until the results are on the host). Prints one JSON line naming the card
and the JAX device.
"""
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def capture_problems(bam, gtf):
    os.environ["STRAWB_FORCE_HOST"] = "1"   # keep the device out of capture
    import io as _io
    from strawberry_tpu.config import Config
    from strawberry_tpu.pipeline import run_driver
    from strawberry_tpu.quant import device as qdev

    captured = []
    orig_add = qdev.EmDispatcher.add

    def shim(self, idx, p):
        total = float(np.sum(p.counts))
        niso = p.weights.shape[1]
        u, F = p.filtered()
        if u.size:
            captured.append((u.copy(), F.copy(), total, niso))
        return orig_add(self, idx, p)

    qdev.EmDispatcher.add = shim
    try:
        cfg = Config(ref_gtf_filename=gtf, utilize_ref_models=True,
                     rf_strand=("bench10m" in bam))

        class Sink:
            def write(self, *_a):
                pass

        run_driver(bam, cfg, _io.StringIO(), Sink())
    finally:
        qdev.EmDispatcher.add = orig_add
        del os.environ["STRAWB_FORCE_HOST"]
    return captured


def time_host(problems, reps=3):
    from strawberry_tpu.quant.device import _host_em_batch
    best = 1e18
    for _ in range(reps):
        results = [None] * len(problems)
        items = [(i, u, F, total, niso)
                 for i, (u, F, total, niso) in enumerate(problems)]
        t0 = time.perf_counter()
        _host_em_batch(items, results)
        best = min(best, time.perf_counter() - t0)
    return best


def time_device(problems, fast_em: bool, reps=2):
    import jax.numpy as jnp
    from strawberry_tpu.quant.device import _TIERS, _em_bucket, fast_em_bucket

    # pre-sort problems into tier batches exactly like the dispatcher
    batches = []
    fills = [[] for _ in _TIERS]
    n_unrouted = 0
    for (u, F, total, niso) in problems:
        for t, (rb, cb, bb) in enumerate(_TIERS):
            if F.shape[0] <= rb and niso <= cb:
                fills[t].append((u, F, total, niso))
                if len(fills[t]) == bb:
                    batches.append((t, fills[t]))
                    fills[t] = []
                break
        else:
            n_unrouted += 1
    for t, f in enumerate(fills):
        if f:
            batches.append((t, f))

    def pad(t, items):
        rb, cb, bb = _TIERS[t]
        F = np.zeros((bb, rb, cb))
        u = np.zeros((bb, rb))
        th0 = np.zeros((bb, cb))
        valid = np.zeros((bb, rb), bool)
        act = np.zeros((bb,), bool)
        for b, (uu, FF, total, niso) in enumerate(items):
            r = FF.shape[0]
            F[b, :r, :niso] = FF
            u[b, :r] = uu
            th0[b, :niso] = total / niso
            valid[b, :r] = True
            act[b] = True
        return F, u, th0, valid, act

    padded = [(t, pad(t, items)) for t, items in batches]
    # warm-up: one dispatch per distinct tier (compile)
    seen = set()
    for t, (F, u, th0, valid, act) in padded:
        if t in seen:
            continue
        seen.add(t)
        if fast_em:
            fast_em_bucket(F, u, th0, valid, act).block_until_ready()
        else:
            _em_bucket(jnp.asarray(F), jnp.asarray(u), jnp.asarray(th0),
                       jnp.asarray(valid), jnp.asarray(act)
                       )[0].block_until_ready()
    best = 1e18
    for _ in range(reps):
        t0 = time.perf_counter()
        outs = []
        for t, (F, u, th0, valid, act) in padded:
            if fast_em:
                outs.append(fast_em_bucket(F, u, th0, valid, act))
            else:
                outs.append(_em_bucket(
                    jnp.asarray(F), jnp.asarray(u), jnp.asarray(th0),
                    jnp.asarray(valid), jnp.asarray(act))[0])
        for o in outs:
            np.asarray(o)   # the pipeline pays the fetch too
        best = min(best, time.perf_counter() - t0)
    return best, len(batches), n_unrouted


def main():
    from strawberry_tpu.utils.jaxsetup import card, device_info
    bam = os.path.join(ROOT, ".bench_data", "10m", "sample_01.sorted.bam")
    gtf = os.path.join(ROOT, ".bench_data", "10m", "annotation.gtf")
    if not os.path.exists(bam):
        bam = os.environ.get("BENCH_BAM", "")
        gtf = os.environ.get("BENCH_GTF", "")
    problems = capture_problems(bam, gtf)
    rows = sorted(p[1].shape[0] for p in problems)
    isos = sorted(p[3] for p in problems)
    print(f"{len(problems)} problems; rows p50/p95/max = "
          f"{rows[len(rows)//2]}/{rows[int(len(rows)*.95)]}/{rows[-1]}; "
          f"isos p50/max = {isos[len(isos)//2]}/{isos[-1]}")

    t_host = time_host(problems)
    t_f64, nb, _ = time_device(problems, fast_em=False)
    t_f32, _, n_unrouted = time_device(problems, fast_em=True)
    out = dict(
        card=card(), device=device_info(),
        n_problems=len(problems), n_tier_batches=nb,
        n_unrouted_to_host=n_unrouted,
        rows_p50=rows[len(rows) // 2], rows_max=rows[-1],
        isos_p50=isos[len(isos) // 2], isos_max=isos[-1],
        host_s=round(t_host, 3),
        device_f64_s=round(t_f64, 3),
        device_f32_s=round(t_f32, 3),
        note="identical real locus problems from a full 10M-read run; "
             "host = native C++ EM batch (the golden path)")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
