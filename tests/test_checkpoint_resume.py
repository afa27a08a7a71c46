"""Checkpoint/resume (SURVEY §5): --no-quant checkpoints assembly to GTF;
--no-assembly -g <that gtf> resumes quantification from it. Golden-compare
both stages against the reference binary doing the same two steps."""
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from strawberry_tpu.sim import make_dataset


def run(cmd, args, tmp_path, tag):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run(cmd + args, capture_output=True, text=True,
                       timeout=600, cwd=ROOT, env=env)
    assert r.returncode == 0, (tag, r.stderr[-1500:])


def test_checkpoint_then_resume_golden(tmp_path, reference_binary):
    bam, gtf, txs = make_dataset(str(tmp_path), seed=21, n_frags=4000,
                                 max_isoforms=2)
    outs = {}
    for tag, cmd in [
        ("ref", [reference_binary]),
        ("ours", [sys.executable, "-m", "strawberry_tpu.cli"]),
    ]:
        ckpt = str(tmp_path / f"{tag}_ckpt.gtf")
        run(cmd, ["--no-quant", "-o", ckpt,
                  "-T", str(tmp_path / f"{tag}1.log"), bam], tmp_path, tag)
        # Quirk: the GTF writer emits score 1000 but the GFF parser DROPS
        # numeric-score lines (gff.cpp:143-148) — the reference aborts on
        # its own checkpoint. Normalize the score column ('.') for resume,
        # identically for both binaries.
        fixed = str(tmp_path / f"{tag}_ckpt_fixed.gtf")
        with open(ckpt) as src, open(fixed, "w") as dst:
            for line in src:
                t = line.split("\t")
                if len(t) > 5:
                    t[5] = "."
                dst.write("\t".join(t))
        ckpt = fixed
        final = str(tmp_path / f"{tag}_final.gtf")
        run(cmd, ["-g", ckpt, "-r", "-o", final,
                  "-T", str(tmp_path / f"{tag}2.log"), bam], tmp_path, tag)
        outs[tag] = {
            "ckpt": [l for l in open(ckpt) if not l.startswith("#")],
            "final": [l for l in open(final) if not l.startswith("#")],
        }
    assert outs["ref"]["ckpt"], "no assembly checkpoint produced"
    assert outs["ours"]["ckpt"] == outs["ref"]["ckpt"]
    assert outs["ours"]["final"] == outs["ref"]["final"]
    assert outs["ref"]["final"]


def test_lowmem_subchromosome_splits_byte_identical(tmp_path, monkeypatch):
    """Forced sub-chromosome block splitting (--low-mem) must not change a
    single output byte on a deep single-chromosome dataset — splits land
    only on provably cluster-safe boundaries (gap > max_olap_dist past the
    running right/mate max, outside padded annotation gene spans)."""
    import io
    from strawberry_tpu.sim import make_dataset
    from strawberry_tpu.config import Config
    from strawberry_tpu.pipeline import run_driver
    monkeypatch.setenv("STRAWB_SPLIT_MB", "1")
    monkeypatch.setenv("STRAWB_STREAM_CAP_MB", "8")
    d = str(tmp_path / "ds")
    make_dataset(d, seed=71, n_frags=30_000, n_chroms=1,
                 chrom_len=1_500_000, n_genes_hint=30, max_isoforms=4)
    bam, gtf = f"{d}/sample_01.sorted.bam", f"{d}/annotation.gtf"
    for kw in (dict(ref_gtf_filename=gtf, utilize_ref_models=True,
                    no_assembly=True),
               dict(ref_gtf_filename=gtf, utilize_ref_models=True),
               dict()):
        o1 = io.StringIO()
        run_driver(bam, Config(low_mem=True, **kw), o1)
        o2 = io.StringIO()
        run_driver(bam, Config(**kw), o2)
        assert o1.getvalue() == o2.getvalue()
        assert o1.getvalue()
