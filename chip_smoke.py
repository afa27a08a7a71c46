#!/usr/bin/env python
"""GPU smoke run of the main path: assembly + quantification through the
CLI on the realistic dataset, every device layer against its reference.

    python chip_smoke.py               # one card: phases 1-5 below
    python chip_smoke.py --four-gpus   # four cards: the jax.distributed
                                       # CLI against the one-card run

Set-up: the native host library is rebuilt from the tracked sources for
this machine's CPU, and the dataset (bench.py's realistic set: 5M fr
fragments = ~9.8M reads, ~20k genes, ~117k transcripts) is simulated from
its seed in a subprocess while phase 5 runs.

Phases (one card, one process, one after another — phase 5 first, while
the dataset is simulated; every CLI phase writes a fresh -o file):
  1 host       the default CLI run: the golden output
  2 prep       STRAWB_DEVICE_PREP=all: GTF byte-identical to phase 1
  3 em-f64     STRAWB_DEVICE_EM=1: same transcript structures, TPM p99
               relative error <= 1e-6
  4 fast-em    --fast-em (f32): same transcripts except isoforms whose
               Frac lies within 1e-4 of the -m cutoff, TPM p99 <= 1e-4
  5 kernels    _mcf_bucket at its three device shapes (flows integer-equal
               to mincostflow.solve_dense), and the f64 XLA _em_bucket and
               the f32 Triton em_bucket_triton at the four tiers against
               quant/em.py (p99 error <= 1e-9 in f64,
               <= 1e-4 in f32, each |theta - oracle| over the locus'
               total max(1, sum(oracle)): a locus that stops one EM
               iteration earlier or later moves theta by < 1e-2)

Every result line names the card and its power limit. Any failed check
exits non-zero before the last line, which is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""
import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
DATASET = dict(seed=303, n_frags=5_000_000, n_chroms=24,
               chrom_len=16_000_000, max_isoforms=20, exon_range=(2, 9),
               abundance="lognormal", protocol="fr", indel_rate=0.02,
               clip_rate=0.03)
MIN_ISOFORM_FRAC = 0.01   # the CLI's -m default
# every device-routing switch; each phase sets its own and nothing leaks
ROUTING_ENV = ("STRAWB_DEVICE_PREP", "STRAWB_DEVICE_EM", "STRAWB_DEVICE_MCF",
               "STRAWB_FORCE_HOST")

CARD = "?"


class PhaseFailed(Exception):
    pass


class CompileMeter:
    """Seconds JAX spent tracing, lowering and compiling executables (a
    compile served from the persistent cache counts its load time), and
    the persistent cache's hits and misses, summed from JAX's monitoring
    events; read() returns the totals since the last read."""

    def __init__(self):
        import jax
        self._reset()
        jax.monitoring.register_event_duration_secs_listener(self._duration)
        jax.monitoring.register_event_listener(self._event)

    def _reset(self):
        self.secs, self.n, self.hits, self.misses = 0.0, 0, 0, 0

    def _duration(self, event, secs, **_kw):
        if event.startswith("/jax/core/compile/"):
            self.secs += secs
            self.n += event.endswith("/backend_compile_duration")

    def _event(self, event, **_kw):
        self.hits += event == "/jax/compilation_cache/cache_hits"
        self.misses += event == "/jax/compilation_cache/cache_misses"

    def read(self) -> str:
        s = (f"compile {self.secs:.3f}s for {self.n} executables "
             f"(persistent cache: {self.hits} hits, {self.misses} misses)")
        self._reset()
        return s


METER = None


def say(msg: str):
    print(f"{msg}  [card: {CARD}]", flush=True)


def check(cond: bool, msg: str):
    if not cond:
        raise PhaseFailed(msg)


def check_repo():
    for rel in ("strawberry_tpu/cli.py", "tools/build_native.sh",
                "tools/bench_mcf_crossover.py"):
        if not os.path.exists(os.path.join(ROOT, rel)):
            sys.exit(f"chip_smoke: {rel} not found; run chip_smoke.py from "
                     "the root of a checkout of the repository")
    sys.path.insert(0, ROOT)
    for k in ROUTING_ENV:
        os.environ.pop(k, None)


def query_card() -> str:
    """nvidia-smi's name and power limit of the first card; exits when
    there is no NVIDIA GPU."""
    from strawberry_tpu.utils.jaxsetup import card
    name = card()
    if name == "no NVIDIA GPU":
        sys.exit("chip_smoke: no GPU found (nvidia-smi finds no NVIDIA GPU)")
    return name


def build_native():
    t0 = time.perf_counter()
    r = subprocess.run([os.path.join(ROOT, "tools", "build_native.sh")],
                       capture_output=True, text=True, cwd=ROOT)
    if r.returncode != 0:
        sys.exit("chip_smoke: native build failed:\n" + r.stderr[-3000:])
    print(f"native: {r.stdout.strip()} in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)


def start_dataset(workdir: str, params: dict) -> subprocess.Popen:
    """Simulate the dataset in a child process that never imports JAX."""
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from strawberry_tpu.sim import make_dataset\n"
            "make_dataset(%r, **%r)\n" % (ROOT, workdir, params))
    return subprocess.Popen([sys.executable, "-c", code], cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def finish_dataset(proc: subprocess.Popen, workdir: str, t0: float):
    _out, err = proc.communicate()
    if proc.returncode != 0:
        raise PhaseFailed("dataset simulation failed:\n" + err[-3000:])
    bam = os.path.join(workdir, "sample_01.sorted.bam")
    gtf = os.path.join(workdir, "annotation.gtf")
    print(f"dataset: {os.path.getsize(bam) / 1e6:.1f} MB BAM ready "
          f"{time.perf_counter() - t0:.1f}s after start", flush=True)
    return bam, gtf


# ---------------------------------------------------------------------------
# GTF comparison


def read_gtf(path: str):
    """(body lines, {structure: [(TPM, Frac), ...]}); a structure is
    (chrom, strand, exons)."""
    body = [l for l in open(path) if not l.startswith("#")]
    txs = {}
    for line in body:
        f = line.rstrip("\n").split("\t")
        if f[2] not in ("transcript", "exon"):
            continue
        attrs = f[8]
        tid = attrs.split('transcript_id "', 1)[1].split('"', 1)[0]
        if f[2] == "transcript":
            tpm = float(attrs.split('TPM "', 1)[1].split('"', 1)[0])
            frac = float(attrs.split('Frac "', 1)[1].split('"', 1)[0])
            txs[tid] = (f[0], f[6], [], tpm, frac)
        else:
            txs[tid][2].append((int(f[3]), int(f[4])))
    by_struct = {}
    for chrom, strand, exons, tpm, frac in txs.values():
        by_struct.setdefault((chrom, strand, tuple(exons)), []).append(
            (tpm, frac))
    for v in by_struct.values():
        v.sort()
    return body, by_struct


def compare_gtf(gold, test):
    """Structures only in one side, and per-transcript TPM relative
    errors over the structures both sides hold equally often."""
    gbody, g = gold
    tbody, t = test
    only = []
    errs = []
    for k in set(g) | set(t):
        a, b = g.get(k, []), t.get(k, [])
        if len(a) != len(b):
            only.append((k, a or b))
            continue
        errs += [abs(y[0] - x[0]) / max(abs(x[0]), 1e-9)
                 for x, y in zip(a, b)]
    errs.sort()
    p99 = errs[int(len(errs) * 0.99)] if errs else 0.0
    mx = errs[-1] if errs else 0.0
    diff_lines = sum(x != y for x, y in zip(gbody, tbody)) \
        + abs(len(gbody) - len(tbody))
    return dict(only=only, p99=p99, max=mx, diff_lines=diff_lines,
                n_tx=len(errs))


# ---------------------------------------------------------------------------
# CLI phases


def cli_phase(name, workdir, bam, gtf, env=None, extra=()):
    from strawberry_tpu import cli
    out = os.path.join(workdir, f"{name}.gtf")
    argv = ["-g", gtf, "--fr", *extra, "-o", out,
            "-T", os.path.join(workdir, f"{name}.log"), bam]
    os.environ.update(env or {})
    METER.read()
    try:
        t0 = time.perf_counter()
        rc, sample = cli.run(argv)
        wall = time.perf_counter() - t0
    finally:
        for k in env or {}:
            os.environ.pop(k, None)
    check(rc == 0 and sample is not None, f"{name}: CLI exit code {rc}")
    routing = sample.routing()
    n_reads = len(sample.table)
    say(f"phase {name}: wall {wall:.3f}s, {n_reads} reads "
        f"({n_reads / wall:,.0f} reads/s); em {routing['em']}, "
        f"prep {routing['prep']}, flow {routing['flow']}, "
        f"device {routing['device']}; {METER.read()}")
    return read_gtf(out), routing, wall


def run_cli_phases(workdir, bam, gtf):
    gold, r1, _ = cli_phase("1-host", workdir, bam, gtf)
    check(r1["device"] is None, "host phase dispatched to the device")

    prep, r2, _ = cli_phase("2-prep", workdir, bam, gtf,
                            {"STRAWB_DEVICE_PREP": "all"})
    check(r2["prep"].get("device_loci", 0) > 0, "prep: no device loci")
    check(prep[0] == gold[0], "prep: GTF body differs from the host run "
          f"({compare_gtf(gold, prep)['diff_lines']} lines)")
    say("phase 2-prep: GTF body byte-identical to phase 1")

    em64, r3, _ = cli_phase("3-em-f64", workdir, bam, gtf,
                            {"STRAWB_DEVICE_EM": "1"})
    check(r3["em"].get("device", 0) > 0, "em-f64: no device EM")
    c = compare_gtf(gold, em64)
    say(f"phase 3-em-f64: {len(c['only'])} structures differ, TPM rel err "
        f"p99 {c['p99']:.3e} max {c['max']:.3e} over {c['n_tx']} "
        f"transcripts, {c['diff_lines']} GTF lines not byte-identical")
    check(not c["only"], f"em-f64: transcript structures differ: "
          f"{c['only'][:3]}")
    check(c["p99"] <= 1e-6, f"em-f64: TPM p99 {c['p99']:.3e} > 1e-6")

    fast, r4, _ = cli_phase("4-fast-em", workdir, bam, gtf,
                            extra=("--fast-em",))
    check(r4["em"].get("device", 0) > 0, "fast-em: no device EM")
    c = compare_gtf(gold, fast)
    near = [k for k, v in c["only"]
            if all(abs(fr - MIN_ISOFORM_FRAC) <= 1e-4 for _, fr in v)]
    say(f"phase 4-fast-em: {len(c['only'])} structures differ "
        f"({len(near)} within 1e-4 of the -m cutoff), TPM rel err p99 "
        f"{c['p99']:.3e} max {c['max']:.3e} over {c['n_tx']} transcripts")
    check(len(near) == len(c["only"]),
          "fast-em: structures differ away from the -m cutoff")
    check(c["p99"] <= 1e-4, f"fast-em: TPM p99 {c['p99']:.3e} > 1e-4")


# ---------------------------------------------------------------------------
# phase 5: kernels at real shapes


def _memory(compiled) -> str:
    ma = compiled.memory_analysis()
    if ma is None:
        return "memory_analysis n/a"
    return (f"args {ma.argument_size_in_bytes} B, out "
            f"{ma.output_size_in_bytes} B, temp {ma.temp_size_in_bytes} B")


def _time(fn, reps=5):
    """Median wall of fn() (which blocks on its result) over reps."""
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return sorted(ts)[len(ts) // 2]


def phase_mcf(rng):
    import numpy as np
    import jax
    import jax.numpy as jnp
    from strawberry_tpu.assembly.device import _DEVICE_SHAPES, _mcf_bucket
    from strawberry_tpu.assembly.mincostflow import solve_dense
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from bench_mcf_crossover import make_problem
    for M, B in _DEVICE_SHAPES.items():
        probs = [make_problem(rng, M, n_paths=max(3, M // 8))
                 for _ in range(B)]
        args = [jnp.asarray(np.stack([p[i] for p in probs]))
                for i in range(3)] + [jnp.ones((B,), bool)]
        compiled = _mcf_bucket.lower(*args).compile()
        flow, infeasible = jax.block_until_ready(compiled(*args))
        t_dev = _time(lambda: jax.block_until_ready(compiled(*args)))
        t0 = time.perf_counter()
        host = [solve_dense(*[x.copy() for x in p]) for p in probs]
        t_host = time.perf_counter() - t0
        flow, infeasible = np.asarray(flow), np.asarray(infeasible)
        bad = sum(1 for b, h in enumerate(host)
                  if (h is None) != bool(infeasible[b])
                  or (h is not None and not np.array_equal(h, flow[b])))
        say(f"phase 5 _mcf_bucket M={M} B={B}: {bad} of {B} flows differ "
            f"from solve_dense; device {t_dev * 1e3:.3f} ms/bucket, host "
            f"solve_dense {t_host * 1e3:.3f} ms; {_memory(compiled)}")
        check(bad == 0, f"_mcf_bucket M={M}: {bad} flows differ")


def em_problems(rng, R, C, B):
    """A full tier bucket of random loci (rows in [R/2, R], isoforms in
    [C/2, C]) and the host oracle's theta for each."""
    import numpy as np
    from strawberry_tpu.quant.em import em_run
    F = np.zeros((B, R, C))
    u = np.zeros((B, R))
    theta0 = np.zeros((B, C))
    valid = np.zeros((B, R), bool)
    oracle = np.zeros((B, C))
    for b in range(B):
        r = int(rng.integers(max(1, R // 2), R + 1))
        c = int(rng.integers(max(1, C // 2), C + 1))
        W = rng.random((r, c)) * rng.random((r, c))
        W[rng.random((r, c)) < 0.5] = 0.0
        W[np.arange(r), rng.integers(0, c, r)] += 0.01  # no all-small row
        cnt = rng.integers(0, 300, r).astype(np.float64)
        F[b, :r, :c] = W
        u[b, :r] = cnt
        theta0[b, :c] = cnt.sum() / c
        valid[b, :r] = True
        th = em_run(cnt, W, theta0[b, :c])
        oracle[b, :c] = theta0[b, :c] if th is None else th
    return (F, u, theta0, valid, np.ones((B,), bool)), oracle


def phase_em(rng):
    import numpy as np
    import jax
    import jax.numpy as jnp
    from strawberry_tpu.quant.device import _TIERS, _em_bucket
    from strawberry_tpu.quant.em_triton import em_bucket_triton
    f32 = jnp.float32
    for (R, C, B) in _TIERS:
        (F, u, th0, valid, act), oracle = em_problems(rng, R, C, B)
        runs = {
            "xla-f64": (lambda *a: _em_bucket(*a)[0],
                        [jnp.asarray(F), jnp.asarray(u), jnp.asarray(th0),
                         jnp.asarray(valid), jnp.asarray(act)], 1e-9),
            "triton-f32": (em_bucket_triton,
                           [jnp.asarray(F, f32), jnp.asarray(u, f32),
                            jnp.asarray(th0, f32), jnp.asarray(valid),
                            jnp.asarray(act)], 1e-4),
        }
        for name, (fn, args, tol) in runs.items():
            compiled = jax.jit(fn).lower(*args).compile()
            theta = np.asarray(jax.block_until_ready(compiled(*args)),
                               np.float64)
            t = _time(lambda: jax.block_until_ready(compiled(*args)))
            rel = np.abs(theta - oracle) / np.maximum(
                1.0, oracle.sum(axis=1, keepdims=True))
            p99 = float(np.quantile(rel, 0.99))
            say(f"phase 5 EM {name} tier R={R} C={C} B={B}: err p99 "
                f"{p99:.3e} max {rel.max():.3e} ({int((rel > tol).sum())} "
                f"of {rel.size} above {tol:g}); {t * 1e3:.3f} ms/bucket; "
                f"{_memory(compiled)}")
            check(p99 <= tol, f"EM {name} R={R}: p99 {p99:.3e} > {tol:g}")


def phase_kernels():
    import numpy as np
    import jax
    rng = np.random.default_rng(5)
    METER.read()
    t0 = time.perf_counter()
    phase_mcf(rng)
    phase_em(rng)
    peak = jax.devices()[0].memory_stats().get("peak_bytes_in_use")
    say(f"phase 5 kernels: wall {time.perf_counter() - t0:.3f}s, "
        f"peak_bytes_in_use {peak}; {METER.read()}")


# ---------------------------------------------------------------------------


def one_card(workdir: str):
    global METER
    from strawberry_tpu.utils.jaxsetup import device_info
    dev = device_info()
    print(f"jax devices: {dev}", flush=True)
    if dev["platform"] != "gpu":
        sys.exit(f"chip_smoke: no GPU found (JAX platform {dev['platform']})")
    METER = CompileMeter()
    t0 = time.perf_counter()
    sim = start_dataset(workdir, DATASET)
    try:
        build_native()
        phase_kernels()
        bam, gtf = finish_dataset(sim, workdir, t0)
        run_cli_phases(workdir, bam, gtf)
    finally:
        if sim.poll() is None:
            sim.kill()
            sim.wait()
    return dev


def four_gpus(workdir: str):
    """Four CLI processes joined by jax.distributed, one per card, against
    the one-card run; the parent never starts a JAX backend."""
    probe = subprocess.run(
        [sys.executable, "-c", "import jax, json; d = jax.devices(); "
         "print(json.dumps({'platform': d[0].platform, 'kind': "
         "d[0].device_kind, 'count': len(d)}))"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    if probe.returncode != 0:
        sys.exit("chip_smoke: JAX probe failed:\n" + probe.stderr[-2000:])
    dev = json.loads(probe.stdout.strip().splitlines()[-1])
    print(f"jax devices: {dev}", flush=True)
    if dev["platform"] != "gpu" or dev["count"] < 4:
        sys.exit(f"chip_smoke: --four-gpus needs four GPUs, JAX sees {dev}")
    dev["count"] = 4
    t0 = time.perf_counter()
    sim = start_dataset(workdir, DATASET)
    try:
        build_native()
        bam, gtf = finish_dataset(sim, workdir, t0)
    finally:
        if sim.poll() is None:
            sim.kill()
            sim.wait()

    # each child is the CLI's main(); a distributed one then reports the
    # devices its process holds (it must bind exactly one card)
    child = ("import json, os, sys\n"
             "from strawberry_tpu import cli\n"
             "rc = cli.main(sys.argv[1:])\n"
             "if os.environ.get('STRAWB_DIST_NPROCS'):\n"
             "    import jax\n"
             "    print('LOCAL', json.dumps([[d.platform, d.id]\n"
             "                               for d in jax.local_devices()]))\n"
             "sys.exit(rc)\n")

    def cli(tag, env):
        return subprocess.Popen(
            [sys.executable, "-c", child, "-g", gtf, "--fr",
             "-o", os.path.join(workdir, f"{tag}.gtf"),
             "-T", os.path.join(workdir, f"{tag}.log"), bam],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)

    base = {k: v for k, v in os.environ.items()
            if not k.startswith("STRAWB_DIST")}
    t1 = time.perf_counter()
    p = cli("single", dict(base, CUDA_VISIBLE_DEVICES="0"))
    _, err = p.communicate(timeout=1800)
    check(p.returncode == 0, "one-card run failed:\n" + err[-2000:])
    t_single = time.perf_counter() - t1
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        coord = f"localhost:{s.getsockname()[1]}"
    t1 = time.perf_counter()
    procs = [cli(f"dist{k}", dict(base, STRAWB_DIST_COORD=coord,
                                  STRAWB_DIST_NPROCS="4",
                                  STRAWB_DIST_PROCID=str(k)))
             for k in range(4)]
    held = []
    try:
        for k, p in enumerate(procs):
            out, err = p.communicate(timeout=1800)
            check(p.returncode == 0,
                  f"process {k} failed:\n" + err[-2000:])
            held += [json.loads(l.split(" ", 1)[1])
                     for l in out.splitlines() if l.startswith("LOCAL ")]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    t_dist = time.perf_counter() - t1
    single = read_gtf(os.path.join(workdir, "single.gtf"))[0]
    dist = read_gtf(os.path.join(workdir, "dist0.gtf"))[0]
    say(f"four-gpus: local devices per process {held}")
    check(len(held) == 4 and all(len(h) == 1 and h[0][0] == "gpu"
                                 for h in held)
          and len({h[0][1] for h in held}) == 4,
          "four-gpus: each process must hold exactly one distinct GPU")
    say(f"four-gpus: one-card CLI {t_single:.3f}s, 4-process "
        f"jax.distributed CLI {t_dist:.3f}s; host 0 GTF "
        f"{len(dist)} lines, {compare_gtf((single, {}), (dist, {}))['diff_lines']}"
        " differ from the one-card run")
    check(bool(single) and dist == single,
          "four-gpus: gathered GTF differs from the one-card run")
    return dev


def main(argv=None) -> int:
    global CARD
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-gpus", action="store_true",
                    help="run only the 4-process jax.distributed CLI on "
                         "four cards and the one-card run it must match")
    args = ap.parse_args(argv)
    check_repo()
    CARD = query_card()
    print(f"card: {CARD}", flush=True)
    base = os.path.join(ROOT, ".smoke")
    os.makedirs(base, exist_ok=True)
    workdir = tempfile.mkdtemp(dir=base)
    try:
        dev = four_gpus(workdir) if args.four_gpus else one_card(workdir)
    except PhaseFailed as e:
        print(f"FAIL: {e}", file=sys.stderr, flush=True)
        return 1
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print(f"card: {CARD}")
    print(json.dumps({"ok": True, "device": dev}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
