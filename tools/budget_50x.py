#!/usr/bin/env python
"""The 50x ceiling, measured.

Runs the realistic scoreboard workload once with profiling enabled,
collects wall, per-phase wall, native thread-CPU by hot path, and the
process CPU totals, then prints the budget arithmetic as JSON: on an
H-core host the wall floor is (total_cpu_seconds / H); the >=50x target
(~4.15M reads/s, BASELINE.md) implies a wall of reads / 4.15e6 seconds.
The JSON states how many host cores (or how much work reduction) the
target requires AT THE CURRENT per-read cost, and names the card.
"""
import json
import os
import resource
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

BASELINE = 83000.0
TARGETS = {"20x": 20 * BASELINE, "50x": 50 * BASELINE}


class Sink:
    is_null = True  # match bench.py's scoreboard sink

    def write(self, *_a):
        pass


def main():
    from strawberry_tpu.config import Config
    from strawberry_tpu.pipeline import run_driver
    from strawberry_tpu.utils.profiling import GLOBAL as PROF, native_counters
    from strawberry_tpu.utils.jaxsetup import card

    data = os.path.join(ROOT, ".bench_data", "realistic")
    bam = os.path.join(data, "sample_01.sorted.bam")
    gtf = os.path.join(data, "annotation.gtf")
    if not os.path.exists(bam):
        from strawberry_tpu.sim import make_dataset
        make_dataset(data, seed=303,
                     n_frags=5_000_000, n_chroms=24, chrom_len=16_000_000,
                     max_isoforms=20, exon_range=(2, 9),
                     abundance="lognormal", protocol="fr",
                     indel_rate=0.02, clip_rate=0.03)
    cfg = Config(ref_gtf_filename=gtf, utilize_ref_models=True,
                 fr_strand=True, verbose=True)
    # warm-up: the block-storage pool and the .sbidx annotation sidecar
    # make repeat runs the steady state (bench.py measures the same way);
    # the cold run's extra page-fault/parse cost is one-time
    run_driver(bam, cfg.replace(verbose=False), Sink(), Sink())
    PROF.phases.clear()
    native_counters(reset=True)
    ru0 = resource.getrusage(resource.RUSAGE_SELF)
    t0 = time.perf_counter()
    sample = run_driver(bam, cfg, Sink(), Sink())
    wall = time.perf_counter() - t0
    ru1 = resource.getrusage(resource.RUSAGE_SELF)
    n_reads = len(sample.table)
    cpu_user = ru1.ru_utime - ru0.ru_utime
    cpu_sys = ru1.ru_stime - ru0.ru_stime
    total_cpu = cpu_user + cpu_sys
    ncpu = os.cpu_count() or 1

    phases = {name: round(st.seconds, 3)
              for name, st in PROF.phases.items() if st.seconds >= 0.01}
    # per-phase CPU of the thread that ran the phase (time.thread_time):
    # the Python/numpy work plus any synchronous native calls issued from
    # that thread; pool-worker CPU is in native_thread_cpu_s instead
    phase_cpu = {name: round(st.cpu, 3)
                 for name, st in PROF.phases.items() if st.cpu >= 0.01}
    native = {k: round(v, 3) for k, v in native_counters().items()
              if v >= 0.01}

    out = {
        "dataset": "realistic 20k genes / 10M reads (bench.py)",
        "card": card(),
        "device": sample.routing()["device"],
        "reads": n_reads,
        "host_cores": ncpu,
        "wall_s": round(wall, 2),
        "reads_per_sec": round(n_reads / wall),
        "vs_baseline": round(n_reads / wall / BASELINE, 2),
        "cpu_user_s": round(cpu_user, 2),
        "cpu_sys_s": round(cpu_sys, 2),
        "total_cpu_s": round(total_cpu, 2),
        "cpu_bound_wall_floor_s": round(total_cpu / ncpu, 2),
        "phase_wall_s": phases,
        "phase_thread_cpu_s": phase_cpu,
        "native_thread_cpu_s": native,
        "cpu_accounting": {
            "sum_phase_thread_cpu_s": round(sum(phase_cpu.values()), 2),
            "sum_native_thread_cpu_s": round(sum(native.values()), 2),
            "note": "total_cpu_s ~= phase thread-CPU (Python/numpy + "
                    "synchronous native calls on the phase's thread) + "
                    "native pool-worker CPU + unphased startup "
                    "(imports, malloc tuning). Phases nest on the same "
                    "thread (pass1/pass2 contain the inner phases), so "
                    "outer entries already include inner ones — compare "
                    "the top-level pass entries against the native "
                    "pools, not the raw sum.",
        },
        "targets": {},
        "pass2_rescan_decision": {
            "cost_s": round(native.get("scan_p2", 0)
                            + native.get("collapse_p2", 0)
                            + native.get("emit_p2", 0), 3),
            "note": "pass 2 re-scans hits against the assembled gene "
                    "spans WITH the pass-1 pairing cache reused (the "
                    "expensive half). The remaining scan is the "
                    "membership computation itself (~80ns/hit); the "
                    "collapse CANNOT reuse pass-1 results byte-exactly "
                    "because the reference re-runs std::sort per pass-2 "
                    "cluster and the unstable tie permutation depends on "
                    "the pass-2 formation order, which differs from any "
                    "pass-1 order. Reusing collapsed fragments would "
                    "change output on tie-heavy loci.",
        },
        "verdict": None,
    }
    for name, rps in TARGETS.items():
        need_wall = n_reads / rps
        need_cores = total_cpu / need_wall
        out["targets"][name] = {
            "reads_per_sec": int(rps),
            "required_wall_s": round(need_wall, 2),
            "cores_needed_at_current_per_read_cost": round(need_cores, 1),
            "or_work_reduction_factor_on_this_host":
                round(total_cpu / (need_wall * ncpu), 2),
        }
    t50 = out["targets"]["50x"]
    out["verdict"] = (
        f"{n_reads} reads at >=50x needs wall <= "
        f"{t50['required_wall_s']}s; the pipeline currently costs "
        f"{out['total_cpu_s']}s of CPU, so on this {ncpu}-core host the "
        f"floor is {out['cpu_bound_wall_floor_s']}s even at perfect "
        f"overlap. 50x therefore needs ~"
        f"{t50['cores_needed_at_current_per_read_cost']} cores at the "
        "current per-read cost (the work parallelizes: -p shards and the "
        "per-locus native pools scale with cores), or a "
        f"{t50['or_work_reduction_factor_on_this_host']}x per-read work "
        "reduction, or work moved to the device.")
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
