#!/usr/bin/env python
"""--low-mem RSS scaling curve.

Runs the full pipeline under --low-mem on the SAME annotation at 5M, 10M,
20M and 40M reads and records each run's peak RSS: the streaming decode
(O(window) block cap), the per-partition cluster pools, and the phase-
boundary malloc_trim should keep the peak ~flat while the BAM quadruples.
Prints one JSON line. Wall times here are secondary (the runs may share
the host with other work); RSS is the record. The runs are host-only.
"""
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = """
import resource, sys, time, io
sys.path.insert(0, "@ROOT@")
from strawberry_tpu.config import Config
from strawberry_tpu.pipeline import run_driver
class Sink:
    def write(self, *_a): pass
cfg = Config(ref_gtf_filename="@GTF@", utilize_ref_models=True,
             rf_strand=True, low_mem=True)
t0 = time.perf_counter()
sample = run_driver("@BAM@", cfg, io.StringIO(), Sink())
dt = time.perf_counter() - t0
rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0
print("RESULT", dt, len(sample.table), rss)
"""


def dataset(n_frags):
    d = os.path.join(ROOT, ".bench_data", f"lowmem_{n_frags}")
    bam = os.path.join(d, "sample_01.sorted.bam")
    gtf = os.path.join(d, "annotation.gtf")
    if not (os.path.exists(bam) and os.path.exists(gtf)):
        sys.path.insert(0, ROOT)
        from strawberry_tpu.sim import make_dataset
        make_dataset(d, seed=101, n_frags=n_frags, n_chroms=16,
                     chrom_len=2_000_000, max_isoforms=8, protocol="rf",
                     with_xs=False, indel_rate=0.02, clip_rate=0.03)
    return bam, gtf


def dataset_deep(n_frags):
    """Adversarial case: ALL reads on ONE chromosome (a real
    amplicon/targeted run) — whole-chromosome blocks would make low-mem
    O(file); sub-chromosome splitting must keep it O(window)."""
    d = os.path.join(ROOT, ".bench_data", f"lowmem_deep_{n_frags}")
    bam = os.path.join(d, "sample_01.sorted.bam")
    gtf = os.path.join(d, "annotation.gtf")
    if not (os.path.exists(bam) and os.path.exists(gtf)):
        sys.path.insert(0, ROOT)
        from strawberry_tpu.sim import make_dataset
        make_dataset(d, seed=111, n_frags=n_frags, n_chroms=1,
                     chrom_len=32_000_000, max_isoforms=8, protocol="rf",
                     with_xs=False, indel_rate=0.02, clip_rate=0.03)
    return bam, gtf


def main():
    sys.path.insert(0, ROOT)
    from strawberry_tpu.utils.jaxsetup import card
    rows = []
    for n_frags in (2_500_000, 5_000_000, 10_000_000, 20_000_000):
        bam, gtf = dataset(n_frags)
        script = (_CHILD.replace("@ROOT@", ROOT).replace("@BAM@", bam)
                  .replace("@GTF@", gtf))
        r = subprocess.run([sys.executable, "-c", script],
                           capture_output=True, text=True, timeout=3600,
                           cwd=ROOT)
        assert r.returncode == 0, (r.returncode, r.stderr[-3000:], r.stdout[-500:])
        _, dt, n, rss = [l for l in r.stdout.splitlines()
                         if l.startswith("RESULT")][0].split()
        rows.append(dict(frags=n_frags, reads=int(n),
                         bam_mb=round(os.path.getsize(bam) / 1e6),
                         wall_s=round(float(dt), 2),
                         peak_rss_mb=round(float(rss))))
        print(rows[-1], file=sys.stderr)
    grow = (rows[-1]["peak_rss_mb"] / rows[-2]["peak_rss_mb"] - 1) * 100 \
        if len(rows) > 1 else 0.0
    deep_rows = []
    for n_frags in (5_000_000, 10_000_000):
        bam, gtf = dataset_deep(n_frags)
        script = (_CHILD.replace("@ROOT@", ROOT).replace("@BAM@", bam)
                  .replace("@GTF@", gtf))
        r = subprocess.run([sys.executable, "-c", script],
                           capture_output=True, text=True, timeout=3600,
                           cwd=ROOT)
        assert r.returncode == 0, (r.returncode, r.stderr[-3000:])
        _, dt, n, rss = [l for l in r.stdout.splitlines()
                         if l.startswith("RESULT")][0].split()
        deep_rows.append(dict(frags=n_frags, reads=int(n),
                              bam_mb=round(os.path.getsize(bam) / 1e6),
                              wall_s=round(float(dt), 2),
                              peak_rss_mb=round(float(rss))))
        print(deep_rows[-1], file=sys.stderr)
    out = dict(mode="low_mem", card=card(), rows=rows,
               last_doubling_rss_growth_pct=round(grow, 1),
               deep_single_chromosome_rows=deep_rows,
               note="same 16-chrom annotation, read depth scaled 2x per "
                    "row; deep rows put ALL reads on ONE chromosome "
                    "(sub-chromosome block splitting is what bounds "
                    "them); the rows are the record, judge them not "
                    "this note")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
