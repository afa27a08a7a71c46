#!/usr/bin/env python
"""Realistic-scale scoreboard run.

Dataset: ~20k genes over 24 chromosomes x 16Mb, up to 20 isoforms per gene
(2-9 exons), lognormal (sigma 1.5) expression for uneven coverage, 5M
fr-stranded paired fragments (10M reads) with 2% indels / 3% soft clips —
the shape of a real transcriptome rather than the easy 461/1797-locus
sets, so tier/bucketing choices stop overfitting.

Prints one JSON line naming the card; each run is a fresh child process
(the only one holding the card; this parent never starts a JAX backend).
With --golden also runs the reference binary (.refbuild/strawberry) on the
same dataset and records whether the GTF bodies are byte-identical.
"""
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, ".bench_data", "realistic")

_CHILD = """
import resource, sys, time, io
sys.path.insert(0, "@ROOT@")
from strawberry_tpu.config import Config
from strawberry_tpu.pipeline import run_driver
class Sink:
    is_null = True  # match bench.py scoreboard sink
    def write(self, *_a): pass
cfg = Config(ref_gtf_filename="@GTF@", utilize_ref_models=True,
             fr_strand=True)
t0 = time.perf_counter()
sample = run_driver("@BAM@", cfg, open("@OUT@", "w"), Sink())
dt = time.perf_counter() - t0
n = len(sample.table)
rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0
print("RESULT", dt, n, rss)
"""


def ensure_dataset():
    bam = os.path.join(DATA, "sample_01.sorted.bam")
    gtf = os.path.join(DATA, "annotation.gtf")
    if not (os.path.exists(bam) and os.path.exists(gtf)):
        sys.path.insert(0, ROOT)
        from strawberry_tpu.sim import make_dataset
        t0 = time.time()
        make_dataset(DATA, seed=303, n_frags=5_000_000, n_chroms=24,
                     chrom_len=16_000_000, max_isoforms=20,
                     exon_range=(2, 9), abundance="lognormal",
                     protocol="fr", indel_rate=0.02, clip_rate=0.03)
        print(f"dataset generated in {time.time()-t0:.0f}s", file=sys.stderr)
    return bam, gtf


def main():
    sys.path.insert(0, ROOT)
    from strawberry_tpu.utils.jaxsetup import card
    bam, gtf = ensure_dataset()
    golden = "--golden" in sys.argv
    out = {}
    best = None
    for rep in range(2):
        ours_gtf = os.path.join(DATA, f"ours_{rep}.gtf")
        if os.path.exists(ours_gtf):
            os.unlink(ours_gtf)
        script = (_CHILD.replace("@ROOT@", ROOT).replace("@BAM@", bam)
                  .replace("@GTF@", gtf).replace("@OUT@", ours_gtf))
        r = subprocess.run([sys.executable, "-c", script],
                           capture_output=True, text=True, timeout=3600,
                           cwd=ROOT)
        assert r.returncode == 0, r.stderr[-3000:]
        line = [l for l in r.stdout.splitlines()
                if l.startswith("RESULT")][0]
        _, dt, n, rss = line.split()
        row = dict(wall_s=round(float(dt), 2), reads=int(n),
                   reads_per_sec=round(int(n) / float(dt)),
                   peak_rss_mb=round(float(rss)))
        if best is None or row["wall_s"] < best["wall_s"]:
            best = row
    # dataset shape diagnostics
    n_genes = n_tx = 0
    iso_per = {}
    for l in open(gtf):
        if "\ttranscript\t" in l:
            n_tx += 1
            g = l.split('gene_id "')[1].split('"')[0]
            iso_per[g] = iso_per.get(g, 0) + 1
    n_genes = len(iso_per)
    best["vs_baseline"] = round(best["reads_per_sec"] / 83000.0, 2)
    out = dict(
        card=card(),
        dataset=dict(frags=5_000_000, n_chroms=24, chrom_len=16_000_000,
                     max_isoforms=20, exon_range=[2, 9],
                     abundance="lognormal_sigma1.5", protocol="fr",
                     indel_rate=0.02, clip_rate=0.03,
                     genes=n_genes, transcripts=n_tx,
                     max_iso_observed=max(iso_per.values()),
                     bam_mb=round(os.path.getsize(bam) / 1e6)),
        default=best,
        baseline_reads_per_sec=83000,
    )
    if golden:
        ref_bin = os.path.join(ROOT, ".refbuild", "strawberry")
        ref_gtf = os.path.join(DATA, "ref.gtf")
        if os.path.exists(ref_gtf):
            os.unlink(ref_gtf)
        t0 = time.time()
        r = subprocess.run(
            [ref_bin, "-g", gtf, "--fr", "-o", ref_gtf,
             "-T", os.path.join(DATA, "ref.log"), bam],
            capture_output=True, text=True, timeout=7200)
        assert r.returncode == 0, r.stderr[-2000:]
        ref_wall = time.time() - t0
        ours = [l for l in open(os.path.join(DATA, "ours_0.gtf"))
                if not l.startswith("#")]
        ref = [l for l in open(ref_gtf) if not l.startswith("#")]
        out["golden"] = dict(byte_identical=(ours == ref),
                             ref_wall_s=round(ref_wall, 1),
                             ref_reads_per_sec=round(best["reads"]
                                                     / ref_wall),
                             speedup_vs_ref_same_host=round(
                                 ref_wall / best["wall_s"], 2))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
