"""BAM writer/reader roundtrip and filter-semantics unit tests."""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from strawberry_tpu.config import Config
from strawberry_tpu.io.bamreader import fnv1_hash, load_bam
from strawberry_tpu.io.bamwriter import BamRecord, BamWriter


def write(tmp_path, records, ref_names=("chr1",), ref_lens=(100000,)):
    path = str(tmp_path / "t.bam")
    with BamWriter(path, list(ref_names), list(ref_lens)) as bw:
        for r in records:
            bw.write(r)
    return path


def test_pack_seq_matches_per_base_encoding():
    """The table-driven pack_seq emits the bytes of the spec's per-base
    4-bit packing: case-insensitive, N (15) for unknown characters, a zero
    low nibble after an odd last base."""
    from strawberry_tpu.io.bamwriter import _NT2CODE, pack_seq

    def per_base(seq):
        out = bytearray()
        for i in range(0, len(seq), 2):
            hi = _NT2CODE.get(seq[i].upper(), 15)
            lo = _NT2CODE.get(seq[i + 1].upper(), 15) \
                if i + 1 < len(seq) else 0
            out.append((hi << 4) | lo)
        return bytes(out)

    rng = np.random.default_rng(0)
    alphabet = list("ACGTNacgtn=RYKMSWBDHVX.*?") + ["é"]
    for n in list(range(6)) + [99, 100, 151]:
        seq = "".join(rng.choice(alphabet, n))
        assert pack_seq(seq) == per_base(seq), seq


def test_roundtrip_basic(tmp_path):
    recs = [
        BamRecord("r1", 0, 0, 99, cigar=[(50, "M")], seq="A" * 50,
                  tags=[("NH", "i", 1), ("XS", "A", "+")]),
        BamRecord("r2", 16, 0, 199, cigar=[(20, "M"), (100, "N"), (30, "M")],
                  seq="A" * 50, tags=[("NH", "i", 1), ("XS", "A", "-")]),
    ]
    t = load_bam(write(tmp_path, recs))
    assert len(t) == 2
    assert t.left.tolist() == [100, 200]
    assert t.right.tolist() == [149, 349]
    assert t.strand.tolist() == [1, 2]
    # spliced read features: M, N, M
    assert t.feat_code[t.feat_off[1]:t.feat_off[2]].tolist() == [0, 1, 0]
    assert t.read_id[0] == np.uint64(fnv1_hash(b"r1"))


def test_filters(tmp_path):
    recs = [
        BamRecord("unmapped", 4, -1, -1),
        BamRecord("ok", 0, 0, 10, cigar=[(50, "M")], seq="A" * 50),
        # intron too short (<20)
        BamRecord("shortN", 0, 0, 20, cigar=[(20, "M"), (5, "N"), (30, "M")],
                  seq="A" * 50),
        # intron too long (>300000)
        BamRecord("longN", 0, 0, 30,
                  cigar=[(20, "M"), (300001, "N"), (30, "M")], seq="A" * 50),
        # multimapped
        BamRecord("multi", 0, 0, 40, cigar=[(50, "M")], seq="A" * 50,
                  tags=[("NH", "i", 3)]),
        # secondary
        BamRecord("sec", 0x100, 0, 50, cigar=[(50, "M")], seq="A" * 50),
        # DEL at cigar index 1 (i-1 <= 0, read.cpp:594): rejected even when
        # MATCH-sandwiched — the reference requires index >= 2
        BamRecord("edgedel", 0, 0, 60,
                  cigar=[(20, "M"), (3, "D"), (27, "M")], seq="A" * 47),
        # DEL at index >= 2, MATCH-sandwiched: kept; D extends the first
        # MATCH and the following M starts a NEW adjacent feature
        # (contig.cpp:12-52 — the reference does not merge them)
        BamRecord("del", 0, 0, 70,
                  cigar=[(3, "S"), (20, "M"), (3, "D"), (27, "M")],
                  seq="A" * 50),
    ]
    t = load_bam(write(tmp_path, recs, ref_lens=(400000,)))
    assert len(t) == 2
    assert t.left.tolist() == [11, 71]
    f0, f1 = t.feat_off[1], t.feat_off[2]
    assert t.feat_code[f0:f1].tolist() == [0, 0]
    assert t.feat_len[f0:f1].tolist() == [23, 27]
    assert t.feat_left[f0:f1].tolist() == [71, 94]


def test_allow_multimapped(tmp_path):
    recs = [BamRecord("m", 0, 0, 10, cigar=[(50, "M")], seq="A" * 50,
                      tags=[("NH", "i", 4)])]
    path = write(tmp_path, recs)
    t = load_bam(path, Config(use_only_unique_hits=False))
    assert len(t) == 1
    assert t.nh[0] == 4
    # mass = 1/NH for singleton
    assert abs(t.mass[0] - 0.25) < 1e-12


def test_fr_rf_strand_inference(tmp_path):
    # first-in-pair, forward: fr -> plus, rf -> minus
    recs = [BamRecord("p", 0x1 | 0x40, 0, 10, cigar=[(50, "M")],
                      seq="A" * 50)]
    path = write(tmp_path, recs)
    assert load_bam(path, Config(fr_strand=True)).strand[0] == 1
    assert load_bam(path, Config(rf_strand=True)).strand[0] == 2


def test_read_len_histogram(tmp_path):
    recs = [BamRecord(f"r{i}", 0, 0, 10 + i,
                      cigar=[(75 if i % 3 else 50, "M")],
                      seq="A" * (75 if i % 3 else 50)) for i in range(30)]
    t = load_bam(write(tmp_path, recs))
    assert t.read_len_mode() == 75
