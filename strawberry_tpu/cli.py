"""Command-line interface, flag-compatible with the reference binary
(ref: src/Strawberry.cpp:32-233)."""
from __future__ import annotations

import argparse
import os
import sys

from .config import Config
from .pipeline import run_driver


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="strawberry",
        description="transcript assembly and quantification with JAX "
                    "device kernels")
    p.add_argument("bam", help="position-sorted input BAM")
    p.add_argument("-o", "--output-gtf", default="./strawberry_assembled.gtf")
    p.add_argument("-T", "--logfile", default="/tmp/strawberry.log")
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("-p", "--num-threads", type=int, default=1)
    p.add_argument("-q", "--min-mapping-qual", type=int, default=0)
    p.add_argument("-J", "--max-junction-splice-size", type=int,
                   default=300000)
    p.add_argument("-j", "--min-junction-splice-size", type=int, default=20)
    p.add_argument("-n", "--num-reads-4-prerun", type=int, default=50000)
    p.add_argument("--allow-multimapped-hits", action="store_true")
    p.add_argument("--fr", action="store_true")
    p.add_argument("--rf", action="store_true")
    p.add_argument("-g", "--GTF", default="")
    p.add_argument("-r", "--no-assembly", action="store_true")
    p.add_argument("--no-quant", action="store_true")
    p.add_argument("-t", "--min-transcript-size", type=int, default=200)
    p.add_argument("-d", "--max-overlap-distance", type=int, default=50)
    p.add_argument("-s", "--small-anchor-size", type=int, default=10)
    p.add_argument("-a", "--small-anchor-alpha", type=float, default=0.0)
    p.add_argument("--min-support-4-intron", type=int, default=2)
    p.add_argument("--min-exon-cov", type=float, default=1.0)
    p.add_argument("--min-depth-4-transcript", type=float, default=1.0)
    p.add_argument("-c", "--combine-short-transfrag", action="store_true")
    p.add_argument("-i", "--insert-size-mean-and-sd", default="")
    p.add_argument("-b", "--bias-correction", default="")
    p.add_argument("-m", "--min-isoform-frac", type=float, default=0.01)
    p.add_argument("-f", "--fragment-context", default="")
    p.add_argument("-e", "--filter-low-expression", type=float, default=None)
    p.add_argument("--low-mem", action="store_true",
                   help="bounded-memory streaming: decoded blocks (split "
                        "below chromosome granularity at cluster-safe "
                        "boundaries, STRAWB_SPLIT_MB) are dropped as "
                        "consumed and pass 2 re-decodes the BAM — peak "
                        "RSS O(decode window), even on deep "
                        "single-chromosome inputs")
    p.add_argument("--no-device", "--no-tpu", dest="no_device",
                   action="store_true",
                   help="run host-only (skip JAX device kernels)")
    p.add_argument("--fast-em", action="store_true",
                   help="solve every locus EM that fits the tier menu on "
                        "the JAX device in float32 (transcript structures "
                        "unchanged, abundances within ~1e-4 of the "
                        "golden f64 host EM)")
    p.add_argument("--shards", type=int, default=0,
                   help="CORRECTNESS SIMULATION of the N-shard distributed "
                        "pipeline: shards run IN SEQUENCE in this process "
                        "to validate pod byte-parity on one host — it is "
                        "slower than a normal run; use -p for actual "
                        "host parallelism (0 = off)")
    return p


def config_from_args(args) -> Config:
    cfg = Config(
        output_gtf=args.output_gtf,
        logfile=args.logfile,
        verbose=args.verbose,
        num_threads=args.num_threads,
        min_map_qual=args.min_mapping_qual,
        max_intron_length=args.max_junction_splice_size,
        min_intron_length=args.min_junction_splice_size,
        max_read_num_4_rl=args.num_reads_4_prerun,
        use_only_unique_hits=not args.allow_multimapped_hits,
        fr_strand=args.fr,
        rf_strand=args.rf,
        ref_gtf_filename=args.GTF,
        utilize_ref_models=bool(args.GTF),
        no_quant=args.no_quant,
        min_trans_len=args.min_transcript_size,
        max_olap_dist=args.max_overlap_distance,
        min_anchor=float(args.small_anchor_size),
        binomial_overhang_alpha=args.small_anchor_alpha,
        min_junc_support=args.min_support_4_intron,
        min_exon_doc=args.min_exon_cov,
        min_depth_4_contig=args.min_depth_4_transcript,
        combine_short_transfrag=args.combine_short_transfrag,
        min_isoform_frac=args.min_isoform_frac,
        bias_correction=bool(args.bias_correction),
        ref_fasta_file=args.bias_correction,
        print_frag_context=bool(args.fragment_context),
        frag_context_out=args.fragment_context or "./frag_context.csv",
        device_batch=not args.no_device,
        fast_em=args.fast_em,
        low_mem=args.low_mem,
    )
    if args.filter_low_expression is not None:
        cfg = cfg.replace(min_isoform_frac=args.filter_low_expression)
    if args.no_assembly:
        cfg = cfg.apply_no_assembly()
    if args.insert_size_mean_and_sd:
        parts = args.insert_size_mean_and_sd.split("/")
        if len(parts) != 2:
            raise SystemExit("wrong -i format; expected mean/sd e.g. 300/25")
        cfg = cfg.replace(insert_size_mean=float(int(parts[0])),
                          insert_size_sd=float(int(parts[1])))
    return cfg


def _maybe_init_distributed() -> int:
    """Multi-process launch (SURVEY §5 distribution): when the launcher
    sets STRAWB_DIST_COORD / STRAWB_DIST_NPROCS / STRAWB_DIST_PROCID
    (and STRAWB_DIST_PROCS_PER_HOST when the processes span several
    hosts), initialize jax.distributed BEFORE any JAX use and return this
    process's id (0 when single-process); each process binds one card of
    its host."""
    nprocs = int(os.environ.get("STRAWB_DIST_NPROCS", "1"))
    if nprocs <= 1:
        return 0
    coord = os.environ.get("STRAWB_DIST_COORD", "127.0.0.1:9731")
    pid = int(os.environ.get("STRAWB_DIST_PROCID", "0"))
    per_host = int(os.environ.get("STRAWB_DIST_PROCS_PER_HOST", "0"))
    from .parallel.collectives import init_distributed
    init_distributed(coord, nprocs, pid, per_host)
    return pid


def main(argv=None) -> int:
    return run(argv)[0]


def run(argv=None):
    """main() that also returns the single-process Sample (None on the
    distributed, sharded and forked -p paths): (exit code, Sample)."""
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    _maybe_init_distributed()
    distributed = int(os.environ.get("STRAWB_DIST_NPROCS", "1")) > 1
    sample = None

    if os.path.exists(cfg.output_gtf):
        print(f"{cfg.output_gtf} exists! Exit.", file=sys.stderr)
        return 1, None
    os.makedirs(os.path.dirname(os.path.abspath(cfg.output_gtf)),
                exist_ok=True)
    os.makedirs(os.path.dirname(os.path.abspath(cfg.logfile)), exist_ok=True)

    cmdline = " ".join(["strawberry"] + (argv or sys.argv[1:]))
    with open(cfg.output_gtf, "w") as out, open(cfg.logfile, "w") as log:
        out.write(f"#{cmdline} \n")
        out.write("#########################################\n")
        fragfh = open(cfg.frag_context_out, "w") \
            if cfg.print_frag_context else None
        try:
            if distributed:
                # each pod host runs exactly its genome shard; host 0 gets
                # the gathered, globally-normalized GTF
                from .parallel.distributed import run_distributed
                run_distributed(args.bam, cfg, out, log, fragfh)
            elif args.shards > 0:
                from .io.bamreader import load_bam
                from .parallel.distributed import run_sharded
                from .parallel.mesh import make_mesh
                if cfg.verbose:
                    os.environ["STRAWB_VERBOSE"] = "1"  # decode diag capture
                try:
                    from .io.native import load_bam_native
                    table = load_bam_native(args.bam, cfg)
                except Exception:
                    table = load_bam(args.bam, cfg)
                if cfg.verbose:
                    # decode-time per-read cerr lines (read.cpp:611-684),
                    # one print per record as the single decode sees them
                    from .pipeline import _emit_read_diags
                    _emit_read_diags(getattr(table, "diag_events", None))
                run_sharded(table, cfg, args.bam, out, log,
                            n_shards=args.shards, mesh=make_mesh(mdl=1))
            else:
                sample = run_driver(args.bam, cfg, out, log, fragfh, cmdline)
        except IOError as e:
            print(f"ERROR: {e}", file=sys.stderr)
            return 1, None
        finally:
            if fragfh:
                fragfh.close()
    print("Program finished")
    return 0, sample


if __name__ == "__main__":
    raise SystemExit(main())
