"""Golden tests: auxiliary features vs the reference binary —
fragment-context export (-f), bias features (-b), long reads, GFF3 input
(BASELINE.json configs 4-5)."""
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from strawberry_tpu.sim import make_dataset, write_genome_fasta
from strawberry_tpu.io.fasta import build_fai


def run_both(tmp_path, reference_binary, extra=(), ours_extra=(),
             annotation=True, **kw):
    bam, gtf, txs = make_dataset(str(tmp_path), **kw)
    outs = {}
    for tag, cmd in [
        ("ref", [reference_binary]),
        ("ours", [sys.executable, "-m", "strawberry_tpu.cli"]),
    ]:
        out = str(tmp_path / f"{tag}.gtf")
        args = list(cmd)
        if annotation:
            args += ["-g", gtf]
        args += [a.format(tmp=str(tmp_path), tag=tag) for a in extra]
        args += ["-o", out, "-T", str(tmp_path / f"{tag}.log"), bam]
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        r = subprocess.run(args, capture_output=True, text=True, timeout=600,
                           cwd=ROOT, env=env)
        assert r.returncode == 0, (tag, r.stderr[-2000:])
        outs[tag] = [l for l in open(out) if not l.startswith("#")]
    return outs


def make_fai(fa):
    recs = build_fai(fa)
    with open(fa + ".fai", "w") as fh:
        for n, r in recs.items():
            fh.write(f"{n}\t{r.seq_len}\t{r.fpos}\t{r.line_len}"
                     f"\t{r.line_blen}\n")


def test_frag_context_with_bias_golden(tmp_path, reference_binary):
    fa = str(tmp_path / "genome.fa")
    write_genome_fasta(fa, {"chr1": 300_000}, seed=7)
    make_fai(fa)
    outs = run_both(
        tmp_path, reference_binary,
        extra=["-r", "-b", fa, "-f", "{tmp}/{tag}_frag.tsv"],
        seed=9, n_frags=3000, max_isoforms=3)
    assert outs["ours"] == outs["ref"]
    ref_frag = open(tmp_path / "ref_frag.tsv").read()
    ours_frag = open(tmp_path / "ours_frag.tsv").read()
    assert ref_frag == ours_frag
    assert "path_gc_content" in ref_frag.splitlines()[0]


def test_frag_context_no_bias_golden(tmp_path, reference_binary):
    outs = run_both(tmp_path, reference_binary,
                    extra=["-r", "-f", "{tmp}/{tag}_frag.tsv"],
                    seed=5, n_frags=2000)
    assert outs["ours"] == outs["ref"]
    assert open(tmp_path / "ref_frag.tsv").read() == \
        open(tmp_path / "ours_frag.tsv").read()


def test_long_read_golden(tmp_path, reference_binary):
    # >10 distinct read lengths above 1kb triggers the PacBio CCS workflow:
    # no insert-size model, bin weight = 1/L (Strawberry.cpp:294-303,336)
    outs = run_both(tmp_path, reference_binary, extra=["-r"],
                    seed=17, n_frags=2500, paired=False,
                    read_len_range=(1001, 1400), chrom_len=600_000)
    assert outs["ref"]
    assert outs["ours"] == outs["ref"]


def test_gff3_annotation_golden(tmp_path, reference_binary):
    outs = run_both(tmp_path, reference_binary, extra=["-r"],
                    seed=9, n_frags=3000, max_isoforms=3,
                    annotation_format="gff3", annotation=True)
    assert outs["ref"]
    assert outs["ours"] == outs["ref"]


def test_expression_filter_and_insert_size_flags_golden(tmp_path,
                                                        reference_binary):
    """-e (min isoform frac) and -i mean/sd (user insert-size override)."""
    outs = run_both(tmp_path, reference_binary,
                    extra=["-e", "0.2", "-i", "300/60"],
                    seed=88, n_frags=3000, max_isoforms=4)
    assert outs["ref"] == outs["ours"]
