"""Edge-case behavior: empty inputs, reads outside annotation, single-read
loci, annotation with no matching chromosomes."""
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from strawberry_tpu.io.bamwriter import BamRecord, BamWriter
from strawberry_tpu.sim import make_dataset, write_gtf, SimTranscript


def run_ours(args, tmp_path, expect_rc=0):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-m", "strawberry_tpu.cli", *args],
                       capture_output=True, text=True, timeout=600,
                       cwd=ROOT, env=env)
    assert r.returncode == expect_rc, r.stderr[-1500:]
    return r


def test_empty_bam(tmp_path):
    path = str(tmp_path / "empty.bam")
    with BamWriter(path, ["chr1"], [100000]):
        pass
    out = str(tmp_path / "o.gtf")
    run_ours([path, "-o", out, "-T", str(tmp_path / "l.log")], tmp_path)
    body = [l for l in open(out) if not l.startswith("#")]
    assert body == []


def test_reads_outside_annotation(tmp_path, reference_binary):
    bam, gtf, txs = make_dataset(str(tmp_path), seed=5, n_frags=1500)
    # annotation for a different region: shift all transcripts far away
    shifted = [SimTranscript(t.chrom, t.gene_id, t.tx_id, t.strand,
                             [(l + 10_000_000, r + 10_000_000)
                              for (l, r) in t.exons]) for t in txs]
    gtf2 = str(tmp_path / "shifted.gtf")
    write_gtf(gtf2, shifted)
    outs = {}
    for tag, cmd in [("ref", [reference_binary]),
                     ("ours", [sys.executable, "-m", "strawberry_tpu.cli"])]:
        out = str(tmp_path / f"{tag}.gtf")
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        r = subprocess.run(cmd + ["-g", gtf2, "-r", "-o", out,
                                  "-T", str(tmp_path / f"{tag}.log"), bam],
                           capture_output=True, text=True, timeout=600,
                           cwd=ROOT, env=env)
        assert r.returncode == 0, (tag, r.stderr[-1000:])
        outs[tag] = [l for l in open(out) if not l.startswith("#")]
    assert outs["ours"] == outs["ref"]


def test_sharded_cli_flag(tmp_path):
    bam, gtf, txs = make_dataset(str(tmp_path), seed=52, n_frags=2000,
                                 n_chroms=3)
    single = str(tmp_path / "s.gtf")
    sharded = str(tmp_path / "m.gtf")
    run_ours(["-g", gtf, "-o", single, "-T", str(tmp_path / "s.log"), bam],
             tmp_path)
    run_ours(["-g", gtf, "--shards", "3", "-o", sharded,
              "-T", str(tmp_path / "m.log"), bam], tmp_path)
    a = [l for l in open(single) if not l.startswith("#")]
    b = [l for l in open(sharded) if not l.startswith("#")]
    assert a == b and a


def test_low_mapq_warning_parity(tmp_path, reference_binary):
    """-q prints a per-read stderr warning but drops nothing
    (src/read.cpp:525-527). The reference decodes each record up to 3+
    times (read-length inspection, two passes, bgzf_seek rewinds) and
    warns on every decode; we decode once. Compare the UNIQUE warning
    line sets, and the GTF must stay byte-identical."""
    bam, gtf, txs = make_dataset(str(tmp_path), seed=61, n_frags=400)
    outs, warns = {}, {}
    for tag, cmd in [("ref", [reference_binary]),
                     ("ours", [sys.executable, "-m", "strawberry_tpu.cli"])]:
        out = str(tmp_path / f"{tag}.gtf")
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        r = subprocess.run(cmd + ["-g", gtf, "-r", "-q", "60", "-o", out,
                                  "-T", str(tmp_path / f"{tag}.log"), bam],
                           capture_output=True, text=True, timeout=600,
                           cwd=ROOT, env=env)
        assert r.returncode == 0, (tag, r.stderr[-1500:])
        outs[tag] = [l for l in open(out) if not l.startswith("#")]
        warns[tag] = sorted({l for l in r.stderr.splitlines()
                             if "has not reached min mapq" in l})
    assert warns["ref"], "reference emitted no low-mapq warnings"
    assert warns["ours"] == warns["ref"]
    assert outs["ours"] == outs["ref"]
