"""Single-host multiprocess pipeline (-p N): the successor of
the reference's per-locus thread pool (SURVEY §2 component 23,
src/alignments.cpp:19-28,1684-1727).

The genome splits into contiguous chromosome-range shards (same exact
split as parallel/distributed.py); shard pipelines run in forked worker
processes, global statistics reduce between the passes, and cluster
numbering is renumbered post-hoc with an exclusive scan so the merged GTF
is byte-identical to the single-process run (tests assert this).
"""
from __future__ import annotations

import io
import multiprocessing as mp
import re
from typing import Dict, List, Optional, TextIO, Tuple

import numpy as np

from ..config import Config
from ..io.bamreader import HitTable
from ..io.gtfwriter import print2gtf
from ..pipeline import Sample, _NullLog
from ..quant.locus import Isoform, c_str
from .distributed import shard_table, split_by_chrom

_WORK = {}
_PARENT = {}  # set pre-fork; children inherit it copy-on-write (passing the
              # HitTable through initargs would pickle ~100MB per worker)


def _host_only_worker():
    """Forked workers never open the card: one JAX process per card (a
    second one would fail for want of the memory the first reserved), and
    a child must not share the parent's initialized backend. Every device
    layer honors STRAWB_FORCE_HOST; a JAX backend the child does start is
    the CPU's."""
    import os
    import jax
    os.environ["STRAWB_FORCE_HOST"] = "1"
    os.environ["JAX_PLATFORMS"] = "cpu"
    jax.config.update("jax_platforms", "cpu")


def _init_worker():
    _host_only_worker()
    _WORK.update(_PARENT)


def _make_sample(k: int) -> Sample:
    table: HitTable = _WORK["table"]
    cfg: Config = _WORK["cfg"]
    sub = shard_table(table, _WORK["shards"][k])
    s = Sample(sub, cfg, _WORK["bam_path"])
    s.long_read_sample = table.is_long_read_sample(cfg.long_read_len) \
        or cfg.long_read_sample
    refs = _WORK.get("refs")
    if refs is not None:
        # annotation parsed ONCE in the parent pre-fork (copy-on-write);
        # each worker keeps its shard's chromosomes
        ids = set(_WORK["shards"][k])
        s.factory.set_ref_mrnas([r for r in refs if r.ref_id in ids])
    elif cfg.ref_gtf_filename:
        s.load_ref_gtf(cfg.ref_gtf_filename)
        ids = set(_WORK["shards"][k])
        s.factory.set_ref_mrnas(
            [r for r in s.factory.ref_mrnas if r.ref_id in ids])
    return s


def _pass1(k: int):
    cfg: Config = _WORK["cfg"]
    s = _make_sample(k)
    log = io.StringIO()
    if cfg.no_assembly:
        if s.factory.ref_mrnas:
            s.pre_process(log)
    else:
        s.assemble_sample(log)
    return (k, s.assembly, s.frag_dist, s.total_mapped_reads,
            s.num_cluster)


def _pass2(args):
    k, assembly, frag_dist, total_mapped = args
    cfg: Config = _WORK["cfg"]
    s = _make_sample(k)
    s.assembly = assembly
    s.frag_dist = frag_dist
    s.total_mapped_reads = total_mapped
    if cfg.no_assembly and not s.factory.ref_mrnas:
        return (k, [])
    if not cfg.no_assembly and not assembly:
        return (k, [])
    s.select_insert_size()
    iso = s.proc_sample(io.StringIO(), _NullLog())
    return (k, iso)


def run_multiprocess(table: HitTable, cfg: Config, bam_path: str,
                     out: TextIO, log: Optional[TextIO] = None,
                     n_procs: int = 2) -> List[Isoform]:
    shards = split_by_chrom(table, n_procs)
    ctx = mp.get_context("fork")
    refs = None
    if cfg.ref_gtf_filename:
        # one parent-side parse instead of one per worker per pass
        tmp = Sample(table, cfg, bam_path)
        tmp.load_ref_gtf(cfg.ref_gtf_filename)
        refs = tmp.factory.ref_mrnas
    _PARENT.update(table=table, cfg=cfg, bam_path=bam_path, shards=shards,
                   refs=refs)
    with ctx.Pool(n_procs, initializer=_init_worker) as pool:
        p1 = sorted(pool.map(_pass1, range(len(shards))))

        # exclusive scan of per-shard cluster counts -> renumber names so
        # they match the sequential single-process numbering
        bases = np.zeros(len(shards), np.int64)
        for k in range(1, len(shards)):
            bases[k] = bases[k - 1] + p1[k - 1][4]
        for k, assembly, _fd, _tm, _nc in p1:
            b = int(bases[k])
            if b:
                for c in assembly:
                    c.parent_id = _renumber_parent(c.parent_id, b)
                    c.trans_id = _renumber_trans(c.trans_id, b)

        # one int32 array, unsorted: InsertSize is order-free (integer
        # sums + bincount), and a boxed 5M-int Python list would pickle
        # ~40x larger into each pass-2 worker
        total_mapped = 0
        fds = []
        for _k, _a, fd, tm, _nc in p1:
            fds.append(np.asarray(fd, np.int32))
            total_mapped += tm
        global_frag = np.concatenate(fds) if fds else np.zeros(0, np.int32)

        p2 = sorted(pool.map(
            _pass2, [(k, a, global_frag, total_mapped)
                     for k, a, _fd, _tm, _nc in p1]))

    all_isoforms: List[Isoform] = []
    for _k, iso in p2:
        all_isoforms.extend(iso)

    total_fpkm = sum(i.fpkm for i in all_isoforms)
    for i in all_isoforms:
        i.tpm = 1e6 * i.fpkm / total_fpkm if total_fpkm != 0 else float("nan")
        i.tpm_s = c_str(i.tpm)
    for i in all_isoforms:
        ref_name = table.ref_real_names[i.contig.ref_id] \
            if i.contig.ref_id >= 0 else "?"
        print2gtf(out, i.contig, ref_name, i.fpkm_s, i.frac_s, i.tpm_s,
                  i.gene_str, i.isoform_str, i.ref_gene_id, i.ref_gene_name)
    return all_isoforms


def _ranged_worker(k: int, n: int, bam_path: str, cfg: Config, conn,
                   gff_box) -> None:
    """One forked -p shard: ranged BGZF-span decode (only ~1/N of the
    compressed bytes inflated here — io.native.SpanDecoder, the same
    ingest the jax.distributed path uses), canonical-chromosome row
    exchange through the parent, then the two-pass pipeline on the owned
    chromosomes (no serial parent decode, no copy-on-write table)."""
    import os
    import time
    _host_only_worker()
    dbg = os.environ.get("STRAWB_MP_DEBUG")
    t0 = time.perf_counter()

    def mark(what):
        if dbg:
            import sys
            sys.stderr.write(f"[mp{k}] {what} @{time.perf_counter()-t0:.2f}s\n")
            sys.stderr.flush()
    try:
        from ..io.native import SpanDecoder
        # full thread budget per worker: spans inflate/parse at different
        # times, and an undersubscribed span serializes its own decode
        dec = SpanDecoder(bam_path, k, n, cfg,
                          n_threads=max(2, os.cpu_count() or 1))
        # record-boundary relay (sequential, ~ms: length skip-scan over
        # already-inflated bytes)
        mark("span open+inflate")
        start = dec.header_end if k == 0 else conn.recv()
        # the scan result doubles as parse's record index (span_end caches
        # it), so the last shard scans too; its end == total_ucomp
        end = dec.end_from(start)
        conn.send(("end", end))
        arrs, seq_lens, paired = dec.parse(start, end)
        mark("span parsed")

        nref = len(dec.ref_names)
        conn.send(("counts", np.bincount(
            arrs["ref_id"], minlength=nref).astype(np.int64)))
        shards = conn.recv()
        owner_of = np.zeros(nref, np.int32)
        for q, ids in enumerate(shards):
            for rid in ids:
                owner_of[rid] = q

        def subrows(mask):
            idx = np.nonzero(mask)[0]
            if not len(idx):
                return None
            i0, i1 = int(idx[0]), int(idx[-1]) + 1
            f0 = int(arrs["feat_off"][i0])
            f1 = int(arrs["feat_off"][i1])
            return {key: (np.asarray(v[i0:i1 + 1] - f0)
                          if key == "feat_off" else
                          np.asarray(v[f0:f1] if key.startswith("feat_")
                                     else v[i0:i1]))
                    for key, v in arrs.items()}

        row_owner = owner_of[arrs["ref_id"]]
        outbound = [None if q == k else subrows(row_owner == q)
                    for q in range(n)]
        conn.send(("rows", outbound, seq_lens.tolist(), bool(paired)))
        parts_in, hist, any_paired = conn.recv()
        mark("rows exchanged")
        parts = []
        for q in range(n):
            if q == k:
                own = subrows(row_owner == k)
                if own is not None:
                    parts.append(own)
            elif parts_in[q] is not None:
                parts.append(parts_in[q])

        def cat(key):
            if not parts:
                return np.zeros(1 if key == "feat_off" else 0, np.int64)
            if len(parts) == 1:  # all rows local: keep the parse views
                return np.asarray(parts[0][key])
            if key == "feat_off":
                segs = [np.asarray(p[key]) for p in parts]
                o = [segs[0]]
                base = segs[0][-1]
                for s in segs[1:]:
                    o.append(s[1:] + base)
                    base += s[-1]
                return np.concatenate(o)
            return np.concatenate([np.asarray(p[key]) for p in parts])

        table = HitTable(
            ref_id=cat("ref_id"), left=cat("left"), right=cat("right"),
            strand=cat("strand"), flag=cat("flag"),
            mate_ref=cat("mate_ref"), mate_pos=cat("mate_pos"),
            nh=cat("nh"), read_id=cat("read_id"),
            cigar_hash=cat("cigar_hash"), feat_off=cat("feat_off"),
            feat_code=cat("feat_code"), feat_left=cat("feat_left"),
            feat_len=cat("feat_len"), ref_names=dec.ref_names,
            ref_real_names=dec.ref_real_names, ref_lens=dec.ref_lens,
            read_len_hist=hist, paired_end=any_paired)
        del arrs, parts, parts_in, outbound

        mark("table built")
        s = Sample(table, cfg, bam_path)
        s.long_read_sample = table.is_long_read_sample(cfg.long_read_len) \
            or cfg.long_read_sample
        mine = set(shards[k])
        if gff_box is not None and "g" in gff_box:
            from ..io.gff import load_ref_mrnas_native
            name2id = {nm: i for i, nm in enumerate(table.ref_names)}
            refs, flat = load_ref_mrnas_native(
                gff_box["g"], name2id, return_flat=True, only_ids=mine)
            s.factory.set_ref_mrnas(refs, flat=flat)
        elif cfg.ref_gtf_filename:
            s.load_ref_gtf(cfg.ref_gtf_filename)
            s.factory.set_ref_mrnas(
                [r for r in s.factory.ref_mrnas if r.ref_id in mine])
        if cfg.bias_correction and cfg.ref_fasta_file:
            from ..io.fasta import FastaInterface
            s.fasta = FastaInterface(cfg.ref_fasta_file)

        mark("refs loaded")
        # ---- pass 1 ----
        log = _NullLog()
        if cfg.no_assembly:
            if s.factory.ref_mrnas:
                s.pre_process(log)
        else:
            s.assemble_sample(log)
        mark("pass1 done")
        conn.send(("p1", s.num_cluster, len(table),
                   np.asarray(s.frag_dist, np.int32),
                   s.total_mapped_reads))
        base, global_frag, total_mapped = conn.recv()
        if base:
            for c in s.assembly:
                c.parent_id = _renumber_parent(c.parent_id, base)
                c.trans_id = _renumber_trans(c.trans_id, base)
        s.frag_dist = global_frag
        s.total_mapped_reads = total_mapped

        # ---- pass 2: quantify, then render this shard's GTF bytes ----
        # The only cross-shard dependency of the output is the global
        # FPKM total (TPM normalization, alignments.cpp:1821-1829): ship
        # the per-isoform FPKM array (KBs), receive the sequential total,
        # render locally — no Isoform pickling, no parent-side printing.
        iso: List[Isoform] = []
        runnable = (s.factory.ref_mrnas if cfg.no_assembly else s.assembly)
        fragfh = None
        if cfg.print_frag_context:
            # per-shard sidecar; the parent appends them in shard order
            # (= cluster order) after the header it wrote
            fragfh = open(f"{cfg.frag_context_out}.shard{k}", "w")
        if runnable:
            s.select_insert_size()
            iso = s.proc_sample(io.StringIO(), _NullLog(), fragfh,
                                want_isoforms=False, defer_vec_emit=True)
        if fragfh is not None:
            fragfh.close()
        mark("pass2 done")
        if s._vec_emit is not None:
            conn.send(("fpkm", s._vec_emit[1]))
            (total_fpkm,) = conn.recv()
            blob = s.vec_emit_render(total_fpkm)
        else:
            conn.send(("fpkm",
                       np.asarray([i.fpkm for i in iso], np.float64)))
            (total_fpkm,) = conn.recv()
            buf = io.StringIO()
            for i in iso:
                i.tpm = 1e6 * i.fpkm / total_fpkm if total_fpkm != 0 \
                    else float("nan")
                i.tpm_s = c_str(i.tpm)
                ref_name = table.ref_real_names[i.contig.ref_id] \
                    if i.contig.ref_id >= 0 else "?"
                print2gtf(buf, i.contig, ref_name, i.fpkm_s, i.frac_s,
                          i.tpm_s, i.gene_str, i.isoform_str,
                          i.ref_gene_id, i.ref_gene_name)
            blob = buf.getvalue().encode()
        conn.send(("p2", blob))
        mark("p2 sent")
    except BaseException as e:  # surfaced by the parent
        import traceback
        conn.send(("error", f"{e}\n{traceback.format_exc()}"))


def _recv(conn, tag):
    msg = conn.recv()
    if msg[0] == "error":
        raise RuntimeError(f"-p shard failed: {msg[1]}")
    assert msg[0] == tag, (msg[0], tag)
    return msg[1:]


def run_multiprocess_ranged(bam_path: str, cfg: Config, out: TextIO,
                            n_procs: int = 2, fragfile=None) -> int:
    """-p N without a parent-side decode: each forked shard inflates and
    parses only its BGZF block span, runs both passes on its chromosomes,
    and renders its own GTF byte range (and its -f fragment-context rows
    into a sidecar the parent appends in shard order). The parent only
    relays the record boundaries, the canonical chromosome split, the
    exchanged boundary rows, the between-pass global statistics, and the
    global FPKM total. Output is byte-identical to the single-process run
    (tests/test_multiprocess.py). Returns the total decoded hit count."""
    import multiprocessing as mp
    from .distributed import split_counts

    gff_box = None
    if cfg.ref_gtf_filename:
        # parse once pre-fork (COW); workers build only their chroms
        from ..io.gff import parse_native
        try:
            gff_box = {"g": parse_native(cfg.ref_gtf_filename)}
        except OSError:
            gff_box = {}  # workers fall back to load_ref_gtf
    ctx = mp.get_context("fork")
    conns, procs = [], []
    for k in range(n_procs):
        pc, wc = ctx.Pipe()
        p = ctx.Process(target=_ranged_worker,
                        args=(k, n_procs, bam_path, cfg, wc, gff_box),
                        daemon=True)
        p.start()
        wc.close()
        conns.append(pc)
        procs.append(p)
    try:
        # boundary relay: worker k's end is worker k+1's start
        for k in range(n_procs):
            (end,) = _recv(conns[k], "end")
            if k + 1 < n_procs:
                conns[k + 1].send(end)
        # canonical split from the summed per-chromosome counts
        counts = None
        for k in range(n_procs):
            (c,) = _recv(conns[k], "counts")
            counts = c if counts is None else counts + c
        shards = split_counts(counts, n_procs)
        for k in range(n_procs):
            conns[k].send(shards)
        # boundary-row exchange (parent-mediated), read-length histogram
        # from the first max_read_num_4_rl accepted hits in file order
        outs = [_recv(conns[k], "rows") for k in range(n_procs)]
        hist: Dict[int, int] = {}
        n_hist = 0
        any_paired = False
        for _ob, sl, pr in outs:
            any_paired |= pr
            for v in sl:
                if n_hist >= cfg.max_read_num_4_rl:
                    break
                hist[v] = hist.get(v, 0) + 1
                n_hist += 1
        for q in range(n_procs):
            parts_in = [outs[k][0][q] if k != q else None
                        for k in range(n_procs)]
            conns[q].send((parts_in, hist, any_paired))
        del outs
        if cfg.verbose:
            # run-level cerr parity (Strawberry.cpp:305-310) from the
            # parent's global statistics (a shard may own no chromosomes;
            # per-read diagnostics remain single-process scope — the
            # reference's own -p interleaves threads' cerr output
            # nondeterministically)
            import sys
            best_count = mode = 0
            for ln, c in hist.items():
                if c > best_count:
                    best_count, mode = c, ln
            sys.stderr.write("Inspecting sample......\n"
                             f"read len mode: {mode}\n")

        # between-pass reduction: cluster-numbering scan + frag-dist /
        # total-mapped-reads all-reduce (ref: alignments.cpp:1372,1401)
        p1 = [_recv(conns[k], "p1") for k in range(n_procs)]
        total_rows = sum(p[1] for p in p1)
        total_mapped = sum(p[3] for p in p1)
        global_frag = np.concatenate([p[2] for p in p1]) \
            if p1 else np.zeros(0, np.int32)
        if cfg.verbose:
            # Strawberry.cpp:329-356 insert-size selection diagnostics
            import sys
            from ..core.insert_size import InsertSize, NotEnoughReads
            sys.stderr.write("Total number of mapped reads is: "
                             f"{total_mapped}\n")
            mean, sd = cfg.insert_size_mean, cfg.insert_size_sd
            if not any_paired:
                mean, sd = cfg.single_end_default_insert
            n_long = sum(1 for ln in hist if ln > cfg.long_read_len)
            if not (n_long > 10 or cfg.long_read_sample):
                if mean != 0 and sd != 0:
                    from ..pipeline import _g
                    sys.stderr.write(
                        f"Using user specified insert size mean: {_g(mean)}"
                        f" and standard deviation: {_g(sd)}\n")
                else:
                    try:
                        InsertSize(frag_lens=global_frag, verbose=True)
                        sys.stderr.write(
                            "Using empirical insert size distribution \n")
                    except NotEnoughReads:
                        pass  # workers surface the real failure
        base = 0
        for k in range(n_procs):
            conns[k].send((base, global_frag, total_mapped))
            base += p1[k][0]

        # global TPM total: naive sequential FPKM accumulation over the
        # shard-concatenated isoform order (= single-process order)
        fpkms = [_recv(conns[k], "fpkm")[0] for k in range(n_procs)]
        total_fpkm = 0.0
        for arr in fpkms:
            for v in arr.tolist():
                total_fpkm += v
        for k in range(n_procs):
            conns[k].send((total_fpkm,))
        # ordered GTF merge: shard-rendered byte blobs in shard order
        for k in range(n_procs):
            (blob,) = _recv(conns[k], "p2")
            out.write(blob.decode())
        if fragfile is not None:
            import os as _os
            from ..quant.fragcontext import FRAG_HEADER
            fragfile.write("\t".join(FRAG_HEADER) + "\n")
            for k in range(n_procs):
                side = f"{cfg.frag_context_out}.shard{k}"
                if _os.path.exists(side):
                    with open(side) as fh:
                        fragfile.write(fh.read())
                    _os.remove(side)
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.terminate()
    return total_rows


def _renumber_parent(pid: str, base: int) -> str:
    """sample.N -> sample.(N+base)"""
    head, _, num = pid.rpartition(".")
    if head and num.isdigit():
        return f"{head}.{int(num) + base}"
    return pid


def _renumber_trans(tid: str, base: int) -> str:
    """sample.N.M -> sample.(N+base).M"""
    parts = tid.rsplit(".", 2)
    if len(parts) == 3 and parts[1].isdigit() and parts[2].isdigit():
        return f"{parts[0]}.{int(parts[1]) + base}.{parts[2]}"
    return tid
