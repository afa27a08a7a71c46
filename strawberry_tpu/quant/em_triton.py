"""Single-launch f32 EM for one tier bucket (Pallas, Triton route).

The XLA form of the batched EM (quant/device.py `_em_bucket`) is a
`lax.while_loop` whose data-dependent condition returns to the host on
every iteration. This kernel runs the whole E/M loop inside one launch:
each program owns a block of TB loci, loads its (TB, R, C) weights once
when they fit one chunk and otherwise walks them in row chunks of RB rows
per E-step (the bucket stays resident in L2), and exits as soon as every
locus of its block has converged.

Semantics are those of `_em_bucket` in f32: the first iteration uses the
raw weights and later ones the column-normalized weights (folded here into
a per-column scale of theta), convergence keeps the previous theta, and a
zero E-step denominator on a live row resets the locus to theta0.
"""
from __future__ import annotations

from functools import partial

from ..utils import jaxsetup  # noqa: F401
import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .device import MAX_ITER, THETA_CHANGE_LIMIT

# f32 elements per program (TB loci x R x C) that set how many loci share a
# program, and per E-step chunk (TB x RB x C) that set the rows walked at a
# time. Measured on an H100 at the four tiers: small tiers are fastest with
# a few loci per program (more programs in flight), large ones with big
# chunks (fewer dependent steps per iteration).
_LOCI_TILE = 2048
_CHUNK_TILE = 16384


def tile_shape(B: int, R: int, C: int):
    """(TB, RB): loci per program and rows per E-step chunk, both powers of
    two that divide the (power-of-two) bucket shape."""
    tb = min(B, max(1, _LOCI_TILE // (R * C)))
    rb = min(R, max(1, _CHUNK_TILE // (tb * C)))
    return tb, rb


def _em_kernel(F_ref, u_ref, theta0_ref, valid_ref, active_ref, out_ref, *,
               rb: int):
    tb, R, C = F_ref.shape
    n_chunks = R // rb
    f32 = jnp.float32
    theta0 = theta0_ref[...]
    resident = None
    if n_chunks == 1:
        resident = (F_ref[...], u_ref[...] * valid_ref[...], valid_ref[...])

    def chunk(i):
        if resident is not None:
            return resident
        rows = pl.ds(i * rb, rb)
        valid = valid_ref[:, rows]
        return F_ref[:, rows, :], u_ref[:, rows] * valid, valid

    colsum = jax.lax.fori_loop(
        jnp.int32(0), jnp.int32(n_chunks),
        lambda i, acc: acc + jnp.sum(chunk(i)[0], axis=1),
        jnp.zeros((tb, C), f32))
    scale = jnp.where(colsum != 0.0, 1.0 / jnp.where(colsum == 0.0, 1.0,
                                                    colsum), 0.0)

    def e_step(theta_eff):
        def body(i, carry):
            acc, fail = carry
            F, uv, valid = chunk(i)
            denom = jnp.sum(F * theta_eff[:, None, :], axis=2)     # (TB,RB)
            zero = denom == 0.0
            fail = jnp.maximum(fail, jnp.max(jnp.where(zero, valid, 0.0),
                                             axis=1))
            w = jnp.where(zero, 0.0, uv / jnp.where(zero, 1.0, denom))
            return acc + jnp.sum(F * w[:, :, None], axis=1), fail

        acc, fail = jax.lax.fori_loop(
            jnp.int32(0), jnp.int32(n_chunks), body,
            (jnp.zeros((tb, C), f32), jnp.zeros((tb,), f32)))
        return acc * theta_eff, fail

    lim2 = f32(THETA_CHANGE_LIMIT * THETA_CHANGE_LIMIT)

    def advance(theta, done, theta_eff):
        nxt, fail = e_step(theta_eff)
        d2 = jnp.sum((nxt - theta) ** 2, axis=1)
        newly = fail * (1.0 - done)
        conv = jnp.where(d2 < lim2, 1.0, 0.0)
        step = (1.0 - done) * (1.0 - conv) * (1.0 - newly)
        theta = jnp.where(step[:, None] > 0.0, nxt, theta)
        theta = jnp.where(newly[:, None] > 0.0, theta0, theta)
        return theta, jnp.maximum(done, jnp.maximum(conv, newly))

    # iteration 1 on the raw weights, later ones on the normalized weights
    theta1, done1 = advance(theta0, 1.0 - active_ref[...], theta0)

    def cond(state):
        it, _theta, done = state
        return jnp.logical_and(it < MAX_ITER, jnp.min(done) < 0.5)

    def body(state):
        it, theta, done = state
        theta, done = advance(theta, done, theta * scale)
        return it + 1, theta, done

    _, theta, _ = jax.lax.while_loop(cond, body,
                                     (jnp.int32(1), theta1, done1))
    out_ref[...] = theta


@partial(jax.jit, static_argnames=("interpret",))
def em_bucket_triton(F_raw, u, theta0, valid_row, active, interpret=False):
    """f32 theta (B, C) for one padded bucket; same inputs as
    quant.device._em_bucket (bool masks are taken as 0/1)."""
    B, R, C = F_raw.shape
    tb, rb = tile_shape(B, R, C)
    f32 = jnp.float32
    return pl.pallas_call(
        partial(_em_kernel, rb=rb),
        out_shape=jax.ShapeDtypeStruct((B, C), f32),
        grid=(B // tb,),
        in_specs=[pl.BlockSpec((tb, R, C), lambda b: (b, 0, 0)),
                  pl.BlockSpec((tb, R), lambda b: (b, 0)),
                  pl.BlockSpec((tb, C), lambda b: (b, 0)),
                  pl.BlockSpec((tb, R), lambda b: (b, 0)),
                  pl.BlockSpec((tb,), lambda b: (b,))],
        out_specs=pl.BlockSpec((tb, C), lambda b: (b, 0)),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4),
        interpret=interpret,
        name="em_bucket_triton",
    )(F_raw.astype(f32), u.astype(f32), theta0.astype(f32),
      valid_row.astype(f32), active.astype(f32))
