"""Golden tests: quantification-only mode (-g ... -r) vs the reference
binary, byte-identical GTF bodies (SURVEY.md §4 test strategy, config 3 of
BASELINE.json)."""
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from strawberry_tpu.sim import make_dataset


def run_both(tmp_path, reference_binary, extra_args=(), **dataset_kw):
    bam, gtf, txs = make_dataset(str(tmp_path), **dataset_kw)
    outs = {}
    for tag, cmd in [
        ("ref", [reference_binary]),
        ("ours", [sys.executable, "-m", "strawberry_tpu.cli"]),
    ]:
        out = str(tmp_path / f"{tag}.gtf")
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        r = subprocess.run(
            cmd + ["-g", gtf, *extra_args, "-o", out,
                   "-T", str(tmp_path / f"{tag}.log"), bam],
            capture_output=True, text=True, timeout=600,
            cwd=ROOT, env=env)
        assert r.returncode == 0, (tag, r.stderr[-2000:])
        outs[tag] = [l for l in open(out) if not l.startswith("#")]
    return outs


@pytest.mark.parametrize("seed,kw", [
    (1, dict(n_frags=3000)),
    (9, dict(n_frags=4000, max_isoforms=3)),
    (13, dict(n_frags=3000, paired=False)),
    (13, dict(n_frags=3000, with_xs=False)),
    (27, dict(n_frags=5000, max_isoforms=5, n_chroms=2)),
])
def test_quant_only_golden(tmp_path, reference_binary, seed, kw):
    outs = run_both(tmp_path, reference_binary, extra_args=["-r"],
                    seed=seed, **kw)
    assert outs["ref"], "reference produced no transcripts"
    assert outs["ours"] == outs["ref"]


def test_quant_only_user_insert_size(tmp_path, reference_binary):
    outs = run_both(tmp_path, reference_binary,
                    extra_args=["-r", "-i", "250/40"], seed=5, n_frags=2500)
    assert outs["ours"] == outs["ref"]


def test_vectorized_finalize_matches_scalar(tmp_path):
    """The vectorized pass-2 finalize (null log) must produce the same GTF
    as the scalar per-locus finalize (real log)."""
    import io
    from strawberry_tpu.sim import make_dataset
    from strawberry_tpu.config import Config
    from strawberry_tpu.pipeline import run_driver, _NullLog
    d = str(tmp_path / "ds")
    make_dataset(d, seed=41, n_frags=8000, n_chroms=2, max_isoforms=4)
    cfg = Config(ref_gtf_filename=f"{d}/annotation.gtf",
                 utilize_ref_models=True)
    out_v = io.StringIO()
    run_driver(f"{d}/sample_01.sorted.bam", cfg, out_v, _NullLog())

    class RealLog:
        def __init__(self):
            self.buf = []

        def write(self, s):
            self.buf.append(s)

    out_s = io.StringIO()
    run_driver(f"{d}/sample_01.sorted.bam", cfg, out_s, RealLog())
    assert out_v.getvalue() == out_s.getvalue()


def test_native_gtf_emit_matches_object_path(tmp_path):
    """The native bytes-only emitter (gtfemit.cc, taken when the caller
    doesn't need Isoform objects) must match the Python print2gtf path
    byte-for-byte, in quant-only and assembly modes."""
    import io
    from strawberry_tpu.sim import make_dataset
    import strawberry_tpu.core.fastcluster as fcl
    from strawberry_tpu.config import Config
    from strawberry_tpu.pipeline import run_driver
    d = str(tmp_path / "ds")
    make_dataset(d, seed=23, n_frags=6000, n_chroms=2, max_isoforms=4)
    for cfg in (Config(ref_gtf_filename=f"{d}/annotation.gtf",
                       utilize_ref_models=True),
                Config(ref_gtf_filename=f"{d}/annotation.gtf")):
        out_n = io.StringIO()
        run_driver(f"{d}/sample_01.sorted.bam", cfg, out_n)
        avail = fcl.native_gtf_emit_available
        fcl.native_gtf_emit_available = lambda: False
        try:
            out_p = io.StringIO()
            run_driver(f"{d}/sample_01.sorted.bam", cfg, out_p)
        finally:
            fcl.native_gtf_emit_available = avail
        assert out_n.getvalue() == out_p.getvalue()
        assert out_n.getvalue()
