"""Cross-host/device reductions for global pipeline statistics.

The reference's only cross-locus state is tiny (SURVEY §2 "Parallelism &
communication accounting"): the fragment-length histogram and total mapped
reads between pass 1 and pass 2 (src/alignments.cpp:1372,1401), and the
global FPKM sum for TPM normalization (alignments.cpp:1821-1829). These are
KB-scale all-reduces; correctness, not bandwidth, is what matters.

Single-process multi-device: plain psum under shard_map. Multi-host:
jax.distributed + the same collectives over the global mesh (each host
contributes its coordinate-range shard of the BAM).
"""
from __future__ import annotations

from functools import partial
from typing import Sequence

import numpy as np

from ..utils import jaxsetup  # noqa: F401
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def allreduce_hist(mesh: Mesh, local_hist: np.ndarray) -> np.ndarray:
    """Sum an identical-shape histogram contribution from every 'dp' shard.

    local_hist: (dp, H) per-shard rows -> returns (H,) total."""
    sharding = NamedSharding(mesh, P("dp", None))

    @partial(jax.jit, in_shardings=sharding,
             out_shardings=NamedSharding(mesh, P(None)))
    def _sum(h):
        return jnp.sum(h, axis=0)

    return np.asarray(_sum(jnp.asarray(local_hist)))


def allreduce_scalar(mesh: Mesh, values: np.ndarray) -> float:
    """Sum one scalar per 'dp' shard (e.g. per-shard total_mapped_reads)."""
    out = allreduce_hist(mesh, np.asarray(values, np.float64)[:, None])
    return float(out[0])


def init_distributed(coordinator: str = "", num_processes: int = 1,
                     process_id: int = 0, procs_per_host: int = 0):
    """Multi-process entry (jax.distributed.initialize); no-op for one
    process. One process per card: hosts run `procs_per_host` processes
    each (default: all on one host), numbered host by host, and process k
    binds local card k % procs_per_host and no other, so processes
    sharing a host never open each other's cards."""
    if num_processes > 1:
        local = process_id % (procs_per_host or num_processes)
        jax.distributed.initialize(coordinator_address=coordinator,
                                   num_processes=num_processes,
                                   process_id=process_id,
                                   local_device_ids=[local])
