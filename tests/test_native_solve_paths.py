"""End-to-end equality of the three flow-solve routings on randomized
datasets: the native worker solve (lemonns.cc, the golden default), the
Python-oracle NetworkSimplex (STRAWB_NATIVE_SOLVE=0), and the opt-in
batched device DP (STRAWB_DEVICE_MCF=1). The first two must be
byte-identical always; the device DP finds A min-cost flow and is
asserted structurally identical here on sets without degenerate-optimum
ties (small max_isoforms keeps ties rare; the realistic tie cases are
covered by the golden suite's lemon-exact requirement)."""
import io
import os
import subprocess
import sys

import pytest

sys.path.insert(0, ".")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = """
import io, os, sys
sys.path.insert(0, {root!r})
from strawberry_tpu.config import Config
from strawberry_tpu.pipeline import run_driver, _NullLog
cfg = Config(ref_gtf_filename={gtf!r}, utilize_ref_models=True)
out = io.StringIO()
run_driver({bam!r}, cfg, out, _NullLog())
sys.stdout.write(out.getvalue())
"""


def _run(bam, gtf, env_extra):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.update(env_extra)
    r = subprocess.run(
        [sys.executable, "-c",
         _CHILD.format(root=ROOT, gtf=gtf, bam=bam)],
        capture_output=True, text=True, cwd=ROOT, timeout=600, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout


@pytest.mark.parametrize("seed", [5, 23])
def test_native_solve_matches_oracle_solve(tmp_path, seed):
    from strawberry_tpu.sim import make_dataset
    d = str(tmp_path / "ds")
    make_dataset(d, seed=seed, n_frags=12000, n_chroms=2, max_isoforms=5)
    bam = f"{d}/sample_01.sorted.bam"
    gtf = f"{d}/annotation.gtf"
    native = _run(bam, gtf, {})
    oracle = _run(bam, gtf, {"STRAWB_NATIVE_SOLVE": "0"})
    assert native == oracle


def test_device_mcf_matches_on_tie_free_set(tmp_path):
    from strawberry_tpu.sim import make_dataset
    d = str(tmp_path / "ds")
    make_dataset(d, seed=11, n_frags=8000, n_chroms=2, max_isoforms=2)
    bam = f"{d}/sample_01.sorted.bam"
    gtf = f"{d}/annotation.gtf"
    native = _run(bam, gtf, {})
    device = _run(bam, gtf, {"STRAWB_DEVICE_MCF": "1"})
    assert native == device
