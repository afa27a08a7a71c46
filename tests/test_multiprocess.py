"""-p multiprocess pipeline vs single-process: byte-identical GTF."""
import io
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from strawberry_tpu.sim import make_dataset


def test_multiprocess_frag_context_bias(tmp_path):
    """-p N with -f (+-b): the shard workers write fragment-context
    sidecars and the parent merges them in shard order — byte-identical
    GTF and frag TSV vs the single-process run."""
    from strawberry_tpu.sim import make_dataset, write_genome_fasta
    from strawberry_tpu.io.fasta import build_fai
    bam, gtf, _ = make_dataset(str(tmp_path), seed=53, n_frags=5000,
                               max_isoforms=3, n_chroms=4)
    fa = str(tmp_path / "genome.fa")
    write_genome_fasta(fa, {f"chr{i+1}": 300_000 for i in range(4)}, seed=7)
    recs = build_fai(fa)
    with open(fa + ".fai", "w") as fh:
        for n, r in recs.items():
            fh.write(f"{n}\t{r.seq_len}\t{r.fpos}\t{r.line_len}"
                     f"\t{r.line_blen}\n")
    outs, frags = {}, {}
    for tag, extra in [("single", []), ("mp", ["-p", "3"])]:
        out = str(tmp_path / f"{tag}.gtf")
        frag = str(tmp_path / f"{tag}_frag.tsv")
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        r = subprocess.run(
            [sys.executable, "-m", "strawberry_tpu.cli", "-g", gtf, "-r",
             "-b", fa, "-f", frag, *extra, "-o", out,
             "-T", str(tmp_path / f"{tag}.log"), bam],
            capture_output=True, text=True, timeout=600, cwd=ROOT,
            env=env)
        assert r.returncode == 0, (tag, r.stderr[-2000:])
        outs[tag] = [l for l in open(out) if not l.startswith("#")]
        frags[tag] = open(frag).read()
    assert outs["mp"] == outs["single"]
    assert frags["mp"] == frags["single"]
    assert "path_gc_content" in frags["single"].splitlines()[0]
    assert len(frags["single"].splitlines()) > 1


@pytest.mark.parametrize("mode", [[], ["-r"]])
def test_multiprocess_matches_single(tmp_path, mode):
    bam, gtf, txs = make_dataset(str(tmp_path), seed=52, n_frags=5000,
                                 max_isoforms=3, n_chroms=4)
    outs = {}
    for tag, extra in [("single", []), ("mp", ["-p", "4"])]:
        out = str(tmp_path / f"{tag}.gtf")
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        r = subprocess.run(
            [sys.executable, "-m", "strawberry_tpu.cli", "-g", gtf, *mode,
             *extra, "-o", out, "-T", str(tmp_path / f"{tag}.log"), bam],
            capture_output=True, text=True, timeout=600, cwd=ROOT,
            env=env)
        assert r.returncode == 0, (tag, r.stderr[-2000:])
        outs[tag] = [l for l in open(out) if not l.startswith("#")]
    assert outs["mp"] == outs["single"]
    assert outs["single"]
