"""Golden tests: assembly paths (ref-guided, ab initio, --no-quant) vs the
reference binary (BASELINE.json configs 1-2)."""
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

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
        args = cmd + (["-g", gtf] if use_gtf else []) + list(extra_args) + \
            ["-o", out, "-T", str(tmp_path / f"{tag}.log"), bam]
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        r = subprocess.run(args, capture_output=True, text=True, timeout=600,
                           cwd=ROOT, env=env)
        assert r.returncode == 0, (tag, r.stderr[-2000:])
        outs[tag] = [l for l in open(out) if not l.startswith("#")]
    return outs


@pytest.mark.parametrize("seed,kw", [
    (21, dict(n_frags=4000, max_isoforms=2)),
    (33, dict(n_frags=6000, max_isoforms=3)),
    (44, dict(n_frags=2500, paired=False)),
])
def test_refguided_assembly_golden(tmp_path, reference_binary, seed, kw):
    outs = run_both(tmp_path, reference_binary, seed=seed, **kw)
    assert outs["ref"]
    assert outs["ours"] == outs["ref"]


@pytest.mark.parametrize("seed,kw", [
    (21, dict(n_frags=4000, max_isoforms=2)),
    (52, dict(n_frags=5000, max_isoforms=3, n_chroms=2)),
    (63, dict(n_frags=3000, with_xs=False)),   # unstranded: refine_cluster
    (74, dict(n_frags=800)),                   # sparse coverage: gap filters
])
def test_abinitio_assembly_golden(tmp_path, reference_binary, seed, kw):
    outs = run_both(tmp_path, reference_binary, use_gtf=False,
                    seed=seed, **kw)
    assert outs["ref"]
    assert outs["ours"] == outs["ref"]


def test_no_quant_golden(tmp_path, reference_binary):
    outs = run_both(tmp_path, reference_binary, extra_args=["--no-quant"],
                    seed=21, n_frags=4000)
    assert outs["ref"]
    assert outs["ours"] == outs["ref"]
