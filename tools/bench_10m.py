#!/usr/bin/env python
"""10M-read scoreboard run (BASELINE config-4 scale).

Dataset: 5M rf-stranded XS-less paired fragments (10M reads) over 16
chromosomes (~1.8k genes, up to 8 isoforms, 2% indels / 3% soft clips) —
generated once into <repo>/.bench_data/10m by this script.

Runs the pipeline end-to-end (assembly+quant, --rf) in fresh subprocesses
and records wall time, reads/s, and each run's own peak RSS for the
default, --low-mem and --fast-em modes. One child process at a time holds
the card; this parent never starts a JAX backend. Prints one JSON line
naming the card and the device each mode's kernels ran on.
"""
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, ".bench_data", "10m")

_CHILD = """
import json, resource, sys, time, io
sys.path.insert(0, "@ROOT@")
from strawberry_tpu.config import Config
from strawberry_tpu.pipeline import run_driver
class Sink:
    def write(self, *_a): pass
cfg = Config(ref_gtf_filename="@GTF@", utilize_ref_models=True,
             rf_strand=True, low_mem=@LOWMEM@, fast_em=@FASTEM@)
if @FASTEM@:
    run_driver("@BAM@", cfg, io.StringIO(), Sink())  # compile before timing
t0 = time.perf_counter()
sample = run_driver("@BAM@", cfg, io.StringIO(), Sink())
dt = time.perf_counter() - t0
n = len(sample.table)
rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0
print("RESULT", dt, n, rss)
print("DEVICE", json.dumps(sample.routing()["device"]))
"""


def ensure_dataset():
    bam = os.path.join(DATA, "sample_01.sorted.bam")
    gtf = os.path.join(DATA, "annotation.gtf")
    if not (os.path.exists(bam) and os.path.exists(gtf)):
        sys.path.insert(0, ROOT)
        from strawberry_tpu.sim import make_dataset
        make_dataset(DATA, seed=101, n_frags=5_000_000, n_chroms=16,
                     chrom_len=2_000_000, max_isoforms=8, protocol="rf",
                     with_xs=False, indel_rate=0.02, clip_rate=0.03)
    return bam, gtf


def run_mode(bam, gtf, low_mem: bool, reps: int, fast_em: bool = False):
    script = (_CHILD.replace("@ROOT@", ROOT).replace("@BAM@", bam)
              .replace("@GTF@", gtf)
              .replace("@LOWMEM@", "True" if low_mem else "False")
              .replace("@FASTEM@", "True" if fast_em else "False"))
    best = None
    for _ in range(reps):
        r = subprocess.run([sys.executable, "-c", script],
                           capture_output=True, text=True, timeout=3600,
                           cwd=ROOT)
        assert r.returncode == 0, r.stderr[-3000:]
        lines = r.stdout.splitlines()
        _, dt, n, rss = [l for l in lines if l.startswith("RESULT")][0].split()
        dev = [l for l in lines if l.startswith("DEVICE")][0].split(" ", 1)
        row = dict(wall_s=round(float(dt), 2), reads=int(n),
                   reads_per_sec=round(int(n) / float(dt)),
                   peak_rss_mb=round(float(rss)), device=json.loads(dev[1]))
        if best is None or row["wall_s"] < best["wall_s"]:
            best = row
    return best


def main():
    sys.path.insert(0, ROOT)
    from strawberry_tpu.utils.jaxsetup import card
    bam, gtf = ensure_dataset()
    out = dict(
        card=card(),
        dataset=dict(frags=5_000_000, n_chroms=16, chrom_len=2_000_000,
                     max_isoforms=8, protocol="rf", with_xs=False,
                     indel_rate=0.02, clip_rate=0.03,
                     bam_mb=round(os.path.getsize(bam) / 1e6)),
        default=run_mode(bam, gtf, False, reps=2),
        low_mem=run_mode(bam, gtf, True, reps=1),
        fast_em=run_mode(bam, gtf, False, reps=2, fast_em=True),
        baseline_reads_per_sec=83000,
    )
    out["default"]["vs_baseline"] = round(
        out["default"]["reads_per_sec"] / 83000.0, 2)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
