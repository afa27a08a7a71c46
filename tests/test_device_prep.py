"""Device quant-prep parity: the integer compat/row device kernels
(quant/device_prep.py) must be byte-identical to the all-host native path
— integer arithmetic is exact on any backend, so these run on the CPU
backend and prove the kernel math, while bench.py exercises the same code
on the real chip."""
import io
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from strawberry_tpu.config import Config
from strawberry_tpu.pipeline import run_driver
from strawberry_tpu.sim import make_dataset


class _Sink:
    def write(self, *_a):
        pass


def _run(bam, gtf, device_prep, **cfg_kw):
    cfg = Config(ref_gtf_filename=gtf, utilize_ref_models=True,
                 device_prep=device_prep, **cfg_kw)
    out = io.StringIO()
    sample = run_driver(bam, cfg, out, _Sink())
    return out.getvalue(), sample


@pytest.mark.parametrize("seed,kw", [
    (3, dict(n_frags=4000, max_isoforms=3)),
    (11, dict(n_frags=5000, max_isoforms=5, n_chroms=2)),
    (21, dict(n_frags=3000, paired=False, with_xs=False)),
])
def test_device_prep_matches_host(tmp_path, seed, kw):
    bam, gtf, _ = make_dataset(str(tmp_path), seed=seed, **kw)
    host_out, _ = _run(bam, gtf, device_prep=False)
    dev_out, sample = _run(bam, gtf, device_prep=True)
    assert dev_out == host_out
    stats = getattr(sample, "prep_stats", {})
    assert stats.get("device_loci", 0) > 0, stats


def test_device_prep_budget_mode(tmp_path, monkeypatch):
    """Self-pacing budget mode (the auto default on accelerators) must be
    byte-identical too, with a real device slice."""
    monkeypatch.setenv("STRAWB_DEVICE_PREP", "budget")
    monkeypatch.setenv("STRAWB_PREP_BUDGET", "512")
    bam, gtf, _ = make_dataset(str(tmp_path), seed=5, n_frags=4000,
                               max_isoforms=3)
    dev_out, sample = _run(bam, gtf, device_prep=None)
    monkeypatch.delenv("STRAWB_DEVICE_PREP")
    host_out, _ = _run(bam, gtf, device_prep=False)
    assert dev_out == host_out
    stats = getattr(sample, "prep_stats", {})
    assert stats.get("device_loci", 0) > 0, stats
    assert stats.get("host_loci", 0) > 0, stats


def test_device_prep_quant_only(tmp_path):
    bam, gtf, _ = make_dataset(str(tmp_path), seed=7, n_frags=4000,
                               max_isoforms=4)
    host_out, _ = _run(bam, gtf, device_prep=False, no_assembly=True)
    dev_out, sample = _run(bam, gtf, device_prep=True, no_assembly=True)
    assert dev_out == host_out
    assert getattr(sample, "prep_stats", {}).get("device_loci", 0) > 0


def test_device_prep_golden(tmp_path, reference_binary):
    """End-to-end vs the reference binary with device prep forced on."""
    import subprocess
    bam, gtf, _ = make_dataset(str(tmp_path), seed=17, n_frags=4000,
                               max_isoforms=4)
    ref_out = str(tmp_path / "ref.gtf")
    r = subprocess.run(
        [reference_binary, "-g", gtf, "-o", ref_out,
         "-T", str(tmp_path / "ref.log"), bam],
        capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    dev_out, sample = _run(bam, gtf, device_prep=True)
    ref_lines = [l for l in open(ref_out) if not l.startswith("#")]
    ours = [l for l in dev_out.splitlines(keepends=True)
            if not l.startswith("#")]
    assert ours == ref_lines
    assert getattr(sample, "prep_stats", {}).get("device_loci", 0) > 0
