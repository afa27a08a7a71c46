"""Golden tests for the read paths the base simulator never exercised:
MATCH-sandwiched insertions/deletions and soft clips
(src/read.cpp:592-599 filters), NH>1 multimappers under the default
unique-hits mode and under --allow-multimapped-hits (read.cpp:49-53,
679-684), XS-less --fr/--rf protocol strand inference (read.cpp:639-653),
and mapq variation. Each dataset runs through both binaries end-to-end and
must produce byte-identical GTF bodies."""
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from strawberry_tpu.config import Config
from strawberry_tpu.sim import make_dataset


def run_both(tmp_path, reference_binary, extra_args=(), use_gtf=True,
             **dataset_kw):
    bam, gtf, txs = make_dataset(str(tmp_path), **dataset_kw)
    outs = {}
    for tag, cmd in [
        ("ref", [reference_binary]),
        ("ours", [sys.executable, "-m", "strawberry_tpu.cli"]),
    ]:
        out = str(tmp_path / f"{tag}.gtf")
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        gargs = ["-g", gtf] if use_gtf else []
        r = subprocess.run(
            cmd + [*gargs, *extra_args, "-o", out,
                   "-T", str(tmp_path / f"{tag}.log"), bam],
            capture_output=True, text=True, timeout=600,
            cwd=ROOT, env=env)
        assert r.returncode == 0, (tag, r.stderr[-2000:])
        outs[tag] = [l for l in open(out) if not l.startswith("#")]
    return outs


@pytest.mark.parametrize("kw", [
    dict(seed=31, n_frags=3000, indel_rate=0.15),
    dict(seed=32, n_frags=3000, clip_rate=0.2),
    dict(seed=33, n_frags=4000, indel_rate=0.1, clip_rate=0.15,
         n_chroms=2),
])
def test_indels_and_softclips_golden(tmp_path, reference_binary, kw):
    """I/D/S CIGARs through assembly+quant: the MATCH-sandwich drop rules
    and the D-merge in readhit_2_genomicFeats must agree byte-for-byte."""
    outs = run_both(tmp_path, reference_binary, **kw)
    assert outs["ref"], "reference produced no transcripts"
    assert outs["ours"] == outs["ref"]


@pytest.mark.parametrize("extra", [(), ("--allow-multimapped-hits",)])
def test_multimappers_golden(tmp_path, reference_binary, extra):
    """NH=2 fragments (secondary copies flagged 0x100): dropped under the
    default unique-hits mode; kept with mass 1/NH under
    --allow-multimapped-hits."""
    outs = run_both(tmp_path, reference_binary, extra_args=list(extra),
                    seed=41, n_frags=3500, multimap_frac=0.25)
    assert outs["ref"], "reference produced no transcripts"
    assert outs["ours"] == outs["ref"]


def test_multimap_flag_changes_output(tmp_path, reference_binary):
    """The multimap path is live: allowing multimapped hits must change
    the quantification (otherwise the dataset exercises nothing)."""
    a = run_both(tmp_path / "u", reference_binary, seed=41, n_frags=3500,
                 multimap_frac=0.25)
    b = run_both(tmp_path / "m", reference_binary,
                 extra_args=["--allow-multimapped-hits"], seed=41,
                 n_frags=3500, multimap_frac=0.25)
    assert a["ref"] != b["ref"]


@pytest.mark.parametrize("proto,paired", [
    ("fr", True), ("rf", True), ("rf", False),
])
def test_protocol_strand_golden(tmp_path, reference_binary, proto, paired):
    """XS-less stranded libraries: --fr/--rf infer the strand from the
    flag orientation (BASELINE config 4 names --rf)."""
    outs = run_both(tmp_path, reference_binary, extra_args=[f"--{proto}"],
                    seed=43, n_frags=3000, with_xs=False, paired=paired,
                    protocol=proto)
    assert outs["ref"], "reference produced no transcripts"
    assert outs["ours"] == outs["ref"]


def test_protocol_inference_recovers_strand(tmp_path):
    """The simulator's orientation mapping is live: under --rf the decoder
    must infer both strands (not a constant)."""
    bam, gtf, txs = make_dataset(str(tmp_path), seed=43, n_frags=1500,
                                 with_xs=False, protocol="rf")
    from strawberry_tpu.io.native import load_bam_native
    t = load_bam_native(bam, Config(rf_strand=True))
    assert set(t.strand.tolist()) == {1, 2}
    # and the inferred strand matches the source transcript's strand for
    # every read (reads lie within their gene's span; genes don't overlap)
    by_strand = {}
    for tx in txs:
        key = (tx.chrom.lower(), tx.gene_id)
        l, r = tx.exons[0][0], tx.exons[-1][1]
        by_strand.setdefault(key, [tx.strand, l, r])
        by_strand[key][1] = min(by_strand[key][1], l)
        by_strand[key][2] = max(by_strand[key][2], r)
    names = t.ref_names
    for i in range(len(t)):
        chrom = names[t.ref_id[i]]
        want = None
        for (c, _g), (s, l, r) in by_strand.items():
            if c == chrom and l <= t.left[i] <= r:
                want = 1 if s == "+" else 2
                break
        assert want is not None and t.strand[i] == want


def test_mapq_variation_golden(tmp_path, reference_binary):
    """mapq varies per record (no -q: accepted everywhere, identical)."""
    outs = run_both(tmp_path, reference_binary, seed=47, n_frags=2500,
                    mapq_range=(0, 60))
    assert outs["ours"] == outs["ref"]
