"""Device mesh and sharded kernels.

The unit of parallelism is the gene locus (embarrassingly parallel, SURVEY
§2 component 23): loci shard data-parallel over the 'dp' mesh axis. For the
dense per-locus EM tensors the isoform axis can also shard over a 'mdl'
(tensor-parallel) axis — the E-step denominator is a contraction over
isoforms, so XLA inserts the psum across the devices. Cross-locus global
statistics (fragment-length histogram, total mapped reads, the TPM
normalizer) ride psum collectives (see collectives.py).
"""
from __future__ import annotations

from functools import partial
from typing import Optional, Sequence, Tuple

import numpy as np

from ..utils import jaxsetup  # noqa: F401
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..quant.device import _em_bucket


def make_mesh(n_devices: Optional[int] = None,
              axes: Tuple[str, str] = ("dp", "mdl"),
              mdl: int = 1) -> Mesh:
    """Loci over 'dp'; the isoform axis over 'mdl' only when a caller asks
    (every device reaches every other at the same rate, so the mesh
    follows the algorithm: loci are independent)."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    n = len(devs)
    assert n % mdl == 0
    return Mesh(np.array(devs).reshape(n // mdl, mdl), axes)


def em_shardings(mesh: Mesh):
    """Input/output shardings for the batched EM bucket: loci over 'dp',
    the isoform axis over 'mdl'."""
    s = partial(NamedSharding, mesh)
    in_sh = (s(P("dp", None, "mdl")),   # F_raw (B, R, C)
             s(P("dp", None)),          # u (B, R)
             s(P("dp", "mdl")),         # theta0 (B, C)
             s(P("dp", None)),          # valid_row (B, R)
             s(P("dp")))                # active (B,)
    out_sh = (s(P("dp", "mdl")), s(P("dp")))
    return in_sh, out_sh


def sharded_em_bucket(mesh: Mesh):
    """jit the EM bucket with mesh shardings; B must divide dp, C divide
    mdl (callers pad)."""
    in_sh, out_sh = em_shardings(mesh)

    @partial(jax.jit, in_shardings=in_sh, out_shardings=out_sh)
    def run(F_raw, u, theta0, valid_row, active):
        return _em_bucket(F_raw, u, theta0, valid_row, active)

    return run


def pad_for_mesh(B: int, C: int, mesh: Mesh) -> Tuple[int, int]:
    dp = mesh.shape["dp"]
    mdl = mesh.shape["mdl"]
    Bp = -(-B // dp) * dp
    Cp = -(-C // mdl) * mdl
    return Bp, Cp
