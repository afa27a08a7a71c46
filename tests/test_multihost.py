"""Real multi-host execution: N separate processes connected through
jax.distributed over a local coordinator, each running exactly its genome
shard (jax.process_index()), with the frag-length histogram / total-reads
psum'd over the global mesh and the isoform records gathered to host 0 —
whose GTF must be byte-identical to the single-process run.

(SURVEY §5 "Distributed communication backend".)
"""
import os
import socket
import subprocess
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from strawberry_tpu.sim import make_dataset

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_single(tmp_path, bam, gtf_args):
    out = str(tmp_path / "single.gtf")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("STRAWB_DIST_NPROCS", None)
    r = subprocess.run(
        [sys.executable, "-m", "strawberry_tpu.cli", *gtf_args,
         "-o", out, "-T", str(tmp_path / "single.log"), bam],
        capture_output=True, text=True, timeout=600, cwd=ROOT, env=env)
    assert r.returncode == 0, r.stderr[-2000:]
    return [l for l in open(out) if not l.startswith("#")]


def _run_dist(tmp_path, bam, gtf_args, nprocs):
    coord = f"127.0.0.1:{_free_port()}"
    procs = []
    for pid in range(nprocs):
        out = str(tmp_path / f"dist{pid}.gtf")
        env = dict(os.environ,
                   JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=2",
                   STRAWB_DIST_COORD=coord,
                   STRAWB_DIST_NPROCS=str(nprocs),
                   STRAWB_DIST_PROCID=str(pid))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "strawberry_tpu.cli", *gtf_args,
             "-o", out, "-T", str(tmp_path / f"dist{pid}.log"), bam],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=ROOT, env=env))
    for pid, p in enumerate(procs):
        try:
            _, err = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, (pid, err[-2000:])
    return [l for l in open(tmp_path / "dist0.gtf")
            if not l.startswith("#")]


@pytest.mark.parametrize("nprocs,mode", [
    (2, "full"), (2, "quant"), (3, "full"), (4, "full"), (8, "full"),
])
def test_multihost_matches_single_process(tmp_path, nprocs, mode):
    bam, gtf, _ = make_dataset(str(tmp_path), seed=61, n_frags=4000,
                               n_chroms=max(3, nprocs),
                               chrom_len=400_000)
    gtf_args = ["-g", gtf] + (["-r"] if mode == "quant" else [])
    single = _run_single(tmp_path, bam, gtf_args)
    dist = _run_dist(tmp_path, bam, gtf_args, nprocs)
    assert single, "single-process produced no transcripts"
    assert dist == single
    # ranged ingest: each process must have inflated only ~1/N of the
    # compressed stream (anchor src/read.cpp:428-478)
    import re
    shares = []
    for pid in range(nprocs):
        txt = open(tmp_path / f"dist{pid}.log").read()
        m = re.search(r"ranged ingest: inflated (\d+) of (\d+)", txt)
        assert m, f"no ranged-ingest record in dist{pid}.log"
        shares.append(int(m.group(1)) / int(m.group(2)))
    assert sum(shares) < 1.5, shares       # overlap blocks only
    for sh in shares:
        assert sh < 1.6 / nprocs + 0.1, shares


@pytest.mark.parametrize("nprocs", [2, 4, 8])
def test_multihost_ab_initio(tmp_path, nprocs):
    bam, _gtf, _ = make_dataset(str(tmp_path), seed=62, n_frags=3000,
                                n_chroms=max(2, nprocs),
                                chrom_len=400_000)
    single = _run_single(tmp_path, bam, [])
    dist = _run_dist(tmp_path, bam, [], nprocs)
    assert single
    assert dist == single


@pytest.mark.parametrize("nprocs", [2, 4, 8])
def test_multihost_bias_frag_context(tmp_path, nprocs):
    """-b (GC/bias features) + -f (fragment-context TSV) across real
    jax.distributed processes: host 0's GTF and the shard-concatenated
    frag context must match the single-process run (the distribution
    claim must cover the full feature matrix)."""
    from strawberry_tpu.sim import write_genome_fasta
    from strawberry_tpu.io.fasta import build_fai
    n_chroms = max(2, nprocs // 2)
    bam, gtf, _ = make_dataset(str(tmp_path), seed=63, n_frags=3000,
                               n_chroms=n_chroms, chrom_len=400_000)
    fa = str(tmp_path / "genome.fa")
    write_genome_fasta(fa, {f"chr{i+1}": 400_000 for i in range(n_chroms)},
                       seed=7)
    recs = build_fai(fa)
    with open(fa + ".fai", "w") as fh:
        for n, r in recs.items():
            fh.write(f"{n}\t{r.seq_len}\t{r.fpos}\t{r.line_len}"
                     f"\t{r.line_blen}\n")
    args = ["-g", gtf, "-r", "-b", fa,
            "-f", str(tmp_path / "single_frag.tsv")]
    single = _run_single(tmp_path, bam, args)
    # per-process -f paths (a shared path would clobber)
    dist_args = ["-g", gtf, "-r", "-b", fa]
    coord_args = [dist_args + ["-f", str(tmp_path / f"frag{pid}.tsv")]
                  for pid in range(nprocs)]
    dist = _run_dist_per_proc_args(tmp_path, bam, coord_args)
    assert single
    assert dist == single
    single_rows = open(tmp_path / "single_frag.tsv").read().splitlines()
    header, single_body = single_rows[0], single_rows[1:]
    dist_body = []
    for pid in range(nprocs):
        rows = open(tmp_path / f"frag{pid}.tsv").read().splitlines()
        assert rows[0] == header
        dist_body.extend(rows[1:])
    assert dist_body == single_body
    assert "path_gc_content" in header


def _run_dist_per_proc_args(tmp_path, bam, per_proc_args):
    nprocs = len(per_proc_args)
    coord = f"127.0.0.1:{_free_port()}"
    procs = []
    for pid, extra in enumerate(per_proc_args):
        out = str(tmp_path / f"dist{pid}.gtf")
        env = dict(os.environ,
                   JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=2",
                   STRAWB_DIST_COORD=coord,
                   STRAWB_DIST_NPROCS=str(nprocs),
                   STRAWB_DIST_PROCID=str(pid))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "strawberry_tpu.cli", *extra,
             "-o", out, "-T", str(tmp_path / f"dist{pid}.log"), bam],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=ROOT, env=env))
    for pid, p in enumerate(procs):
        try:
            _, err = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, (pid, err[-2000:])
    return [l for l in open(tmp_path / "dist0.gtf")
            if not l.startswith("#")]
