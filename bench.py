#!/usr/bin/env python
"""Benchmark: aligned reads/sec through the full assembly+quant pipeline.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...},
with the card (nvidia-smi name and power limit) and the JAX device.
Baseline: the reference's published single-thread CPU throughput of
~83,000 aligned reads/s (README.md:62 — 10M simulated reads in ~2 min).

The PRIMARY number is the realistic-shape workload: ~20k genes over 24
chromosomes, up to 20 isoforms per gene, lognormal expression, 10M
fr-stranded reads with indels/clips — the shape a user's real
transcriptome has (the easy 16-chrom/<=8-isoform set the reference's
published figure corresponds to is reported alongside as `easy_10m`).

Also reported: the 1M quick set and `--fast-em` (f32 EM on the device)
with its TPM deviation from the golden run. device_frac counts the
EM + quant-prep loci dispatched to the device (0 on the golden default
path, which is all-host).

Set BENCH_FRAGS to override with the legacy small dataset only.
"""
import io
import json
import os
import resource
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

BASELINE_READS_PER_SEC = 83000.0
DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), ".bench_data")


class Sink:
    is_null = True  # pipeline hot paths skip log formatting for null sinks

    def write(self, *_a):
        pass


def dataset_realistic():
    cache = os.path.join(DATA, "realistic")
    bam = os.path.join(cache, "sample_01.sorted.bam")
    gtf = os.path.join(cache, "annotation.gtf")
    if not (os.path.exists(bam) and os.path.exists(gtf)):
        from strawberry_tpu.sim import make_dataset
        make_dataset(cache, seed=303, n_frags=5_000_000, n_chroms=24,
                     chrom_len=16_000_000, max_isoforms=20,
                     exon_range=(2, 9), abundance="lognormal",
                     protocol="fr", indel_rate=0.02, clip_rate=0.03)
    return bam, gtf, dict(fr_strand=True)


def dataset_10m():
    cache = os.path.join(DATA, "10m")
    bam = os.path.join(cache, "sample_01.sorted.bam")
    gtf = os.path.join(cache, "annotation.gtf")
    if not (os.path.exists(bam) and os.path.exists(gtf)):
        from strawberry_tpu.sim import make_dataset
        make_dataset(cache, seed=101, n_frags=5_000_000, n_chroms=16,
                     chrom_len=2_000_000, max_isoforms=8, protocol="rf",
                     with_xs=False, indel_rate=0.02, clip_rate=0.03)
    return bam, gtf, dict(rf_strand=True)


def dataset_1m(n_frags=500_000):
    cache = os.path.join(DATA, f"frags_{n_frags}")
    bam = os.path.join(cache, "sample_01.sorted.bam")
    gtf = os.path.join(cache, "annotation.gtf")
    if not os.path.exists(bam):
        from strawberry_tpu.sim import make_dataset
        make_dataset(cache, seed=77, n_frags=n_frags, n_chroms=4,
                     chrom_len=2_000_000, max_isoforms=3)
    return bam, gtf, {}


def run_best(bam, cfg, reps, capture_last=False):
    from strawberry_tpu.pipeline import run_driver
    best = float("inf")
    sample = None
    out = None
    for i in range(reps):
        sample = None  # free the previous table before timing the next rep
        t0 = time.perf_counter()
        o = io.StringIO() if capture_last else Sink()
        sample = run_driver(bam, cfg, o, Sink())
        dt = time.perf_counter() - t0
        if dt < best:
            best, out = dt, o
    # stats (table len, em/prep counters) are rep-invariant: report the
    # last run's sample rather than pinning an extra table in memory
    return best, sample, out


def tpms(text):
    out = {}
    for line in text.splitlines():
        if "\ttranscript\t" in line:
            attrs = line.rsplit("\t", 1)[-1]
            tid = attrs.split('transcript_id "')[1].split('"')[0]
            out[tid] = float(attrs.split('TPM "')[1].split('"')[0])
    return out


def main():
    from strawberry_tpu.config import Config
    from strawberry_tpu.pipeline import run_driver

    legacy = os.environ.get("BENCH_FRAGS")
    if legacy:
        bam, gtf, extra = dataset_1m(int(legacy))
    else:
        bam, gtf, extra = dataset_realistic()
    cfg = Config(ref_gtf_filename=gtf, utilize_ref_models=True, **extra)

    # warm-up (JAX init, page cache, block-pool/sidecar warmth;
    # steady-state throughput is the metric)
    run_driver(bam, cfg, Sink(), Sink())
    dt, sample, _ = run_best(bam, cfg, reps=4)
    n_reads = len(sample.table)
    rps = n_reads / dt
    em = getattr(sample, "em_stats", {})
    prep = getattr(sample, "prep_stats", None) or {}
    dev = em.get("device", 0) + prep.get("device_loci", 0)
    host = em.get("host", 0) + prep.get("host_loci", 0)
    device_frac = dev / (dev + host) if (dev + host) else 0.0
    peak_mb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss // 1024
    em = dict(em)
    sample = None  # release the realistic table before the next datasets

    # the easy 16-chrom set (the reference's published workload scale)
    easy = {}
    if not legacy:
        bam10, gtf10, extra10 = dataset_10m()
        cfg10 = Config(ref_gtf_filename=gtf10, utilize_ref_models=True,
                       **extra10)
        run_driver(bam10, cfg10, Sink(), Sink())
        dt10, s10, _ = run_best(bam10, cfg10, reps=3)
        easy = {"reads_per_sec": round(len(s10.table) / dt10, 1),
                "vs_baseline": round(len(s10.table) / dt10
                                     / BASELINE_READS_PER_SEC, 4),
                "wall_s": round(dt10, 3)}
        s10 = None  # release before the 1M runs

    # secondary: the 1M quick set, golden vs --fast-em (f32 device EM)
    # with TPM deviation
    bam1, gtf1, _ = dataset_1m()
    cfg1 = Config(ref_gtf_filename=gtf1, utilize_ref_models=True)
    run_driver(bam1, cfg1, Sink(), Sink())
    dt1, s1, out1 = run_best(bam1, cfg1, reps=3, capture_last=True)
    fcfg = cfg1.replace(fast_em=True)
    run_driver(bam1, fcfg, Sink(), Sink())   # compiles before timing
    fdt, fs, fout = run_best(bam1, fcfg, reps=3, capture_last=True)
    g, f = tpms(out1.getvalue()), tpms(fout.getvalue())
    errs = sorted(abs(f[k] - v) / max(1e-9, abs(v)) for k, v in g.items()
                  if k in f)
    tpm_p99 = errs[int(len(errs) * 0.99)] if errs else float("nan")
    fem = getattr(fs, "em_stats", {})

    from strawberry_tpu.utils.jaxsetup import card, device_info
    dev = device_info()
    rec = {
        "metric": "aligned_reads_per_sec_assembly_quant",
        "value": round(rps, 1),
        "unit": f"reads/s on one {dev['kind']} ({card()}) and its host",
        "device": dev,
        "vs_baseline": round(rps / BASELINE_READS_PER_SEC, 4),
        "dataset": ("realistic transcriptome shape: 20k genes / 24 chroms "
                    "/ <=20 isoforms / lognormal expression / 10M reads"
                    if not legacy else f"legacy BENCH_FRAGS={legacy}"),
        "wall_s": round(dt, 3),
        "peak_rss_mb": int(peak_mb),
        "device_frac": round(device_frac, 4),
        "easy_10m": easy,
        "reads_per_sec_1m": round(len(s1.table) / dt1, 1),
        "fast_em_reads_per_sec_1m": round(len(fs.table) / fdt, 1),
        "fast_em_device_frac": round(fem.get("device", 0) / max(
            1, fem.get("device", 0) + fem.get("host", 0)), 4),
        "fast_em_tpm_p99_rel_err": round(tpm_p99, 8),
    }
    print(json.dumps(rec))
    print(f"# primary (realistic) {n_reads} reads in {dt:.2f}s; EM "
          f"device/host = {em.get('device', 0)}/{em.get('host', 0)}; "
          f"easy 10M {easy.get('wall_s', '-')}s; 1M set {dt1:.2f}s; "
          f"fast-em 1M {fdt:.2f}s device/host = "
          f"{fem.get('device', 0)}/{fem.get('host', 0)}", file=sys.stderr)


if __name__ == "__main__":
    main()
