"""Device kernels compiled for the GPU, checked against their references.

The suite itself is pinned to the CPU backend (conftest.py), so the GPU
run happens in a fresh subprocess that leaves JAX_PLATFORMS unset. Marked
`gpu`: skips where no NVIDIA card is present."""
import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SMOKE = """
import sys
sys.path.insert(0, @ROOT@)
import numpy as np
import jax
import jax.numpy as jnp
assert jax.devices()[0].platform == "gpu", jax.devices()
from strawberry_tpu.quant.device import _em_bucket, fast_em_bucket
from strawberry_tpu.assembly.device import batched_mcf
from strawberry_tpu.assembly.mincostflow import solve_dense

rng = np.random.default_rng(4)
B, R, C = 128, 32, 4
F = rng.random((B, R, C))
F[rng.random((B, R, C)) < 0.5] = 0
u = rng.integers(0, 200, (B, R)).astype(np.float64)
t0 = np.full((B, C), 50.0)
valid = (F > 1e-5).any(axis=2)
active = np.ones(B, bool)
th64 = np.asarray(_em_bucket(jnp.asarray(F), jnp.asarray(u),
                             jnp.asarray(t0), jnp.asarray(valid),
                             jnp.asarray(active))[0])
th32 = np.asarray(fast_em_bucket(F, u, t0, valid, active))
rel = np.abs(th32 - th64) / np.maximum(1.0, np.abs(th64))
assert np.quantile(rel, 0.99) < 1e-4, np.quantile(rel, 0.99)

sys.path.insert(0, @TESTS@)
from test_device_flow import random_cmpc_problem
probs = [random_cmpc_problem(rng, int(rng.integers(40, 62)))
         for _ in range(16)]
dev = batched_mcf(probs, device_min_nodes=0)
for p, d in zip(probs, dev):
    h = solve_dense(*[x.copy() for x in p])
    assert (h is None) == (d is None)
    assert h is None or np.array_equal(h, d)
print("GPU_OK", jax.devices()[0].device_kind)
"""


@pytest.mark.gpu
def test_kernels_on_gpu():
    if shutil.which("nvidia-smi") is None:
        pytest.skip("no NVIDIA GPU (nvidia-smi not found)")
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    script = (_SMOKE.replace("@ROOT@", repr(ROOT))
              .replace("@TESTS@", repr(os.path.join(ROOT, "tests"))))
    r = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, timeout=900, env=env, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "GPU_OK" in r.stdout
