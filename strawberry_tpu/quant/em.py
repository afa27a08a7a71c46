"""Latent-class-model EM solver.

Host oracle replicating EmSolver (ref: include/estimate.hpp:230-257,
src/estimate.cpp:366-488) bit-for-bit in float64, including its quirks:
  * rows whose weights are all <= 1e-5 are dropped, but theta0 uses the
    count total over ALL rows (estimate.cpp:374-391)
  * each iteration column-renormalizes F after the M-step; the `newF==0`
    no-op at estimate.cpp:470 means an all-zero column keeps its previous
    newF values (zero after the first pass)
  * on convergence (||theta' - theta|| < 1e-2) the PREVIOUS theta is
    returned — `break` fires before `theta = next_theta` (estimate.cpp:479-481)

The batched device version (quant/device.py) runs the same recurrence over
padded (loci, bins, isoforms) tensors and is validated against this oracle.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

MAX_ITER = 1000
THETA_CHANGE_LIMIT = 1e-2


def em_init(num_iso: int, count: Sequence[float],
            model: np.ndarray) -> Optional[Tuple[np.ndarray, np.ndarray,
                                                 np.ndarray]]:
    """EmSolver::init: drop all-small rows; theta0 = total/num_iso over the
    UNfiltered counts. Returns (u, F, theta0) or None if nothing survives."""
    count = np.asarray(count, dtype=np.float64)
    total_count = float(count.sum())
    keep = (model > 1e-5).any(axis=1)
    u = count[keep]
    F = np.asarray(model, dtype=np.float64)[keep]
    if u.size == 0:
        return None
    theta0 = np.full(num_iso, total_count / num_iso, dtype=np.float64)
    return u, F, theta0


def em_run(u: np.ndarray, F: np.ndarray,
           theta0: np.ndarray) -> Optional[np.ndarray]:
    """EmSolver::run. Returns final theta, or None on a zero E-step
    denominator (the reference aborts the locus)."""
    F = F.copy()
    theta = theta0.copy()
    nrow, ncol = F.shape
    newF = np.zeros_like(F)
    for _ in range(MAX_ITER):
        denom = F @ theta                      # per-row
        if np.any(denom == 0.0):
            return None
        # keep the reference's operand order: (obs * F * theta) / denom
        U = (u[:, None] * F * theta[None, :]) / denom[:, None]
        next_theta = U.sum(axis=0)
        colsum = F.sum(axis=0)
        nz = colsum != 0.0
        # zero columns keep previous newF values (the newF==0 no-op quirk)
        newF[:, nz] = F[:, nz] / colsum[nz]
        F = newF.copy()
        dist = next_theta - theta
        if float(np.sqrt((dist * dist).sum())) < THETA_CHANGE_LIMIT:
            break
        theta = next_theta
    return theta
