"""Fused ensemble scoring kernel for the GPU — the ``predict`` hot path.

The plain restart-batched scorer (ops/scoring.py
``ensemble_predict_interaction_batched``) writes and re-reads the outer
products W [S, B, K^2] and the contraction A [S, B, K, R] in device
memory: about 5 KB per row at S=10, K=10, against 12 bytes of input.
This kernel keeps both in registers.  For one tile of ``Bt`` rows it

- loads the tile's three gene-id columns;
- loops over the S restarts inside the block: gathers the three theta
  rows of restart s by index from a [S*G, Kp] stack (no one-hot, so no
  G limit; at G=1000 the stack is 640 KB and stays in L2), forms
  W = th1 (x) th2 as [Bt, Kp^2], contracts it with p_s[:, :, :, r] as
  one ``pl.dot`` of [Bt, Kp^2] x [Kp^2, Kp], then with th3;
- writes the restart mean as [Bt] scores.

Only the interaction rating's slice of p enters, since the user-facing
score is P(r = interact).  K is zero-padded to Kp, a power of two of at
least 16 (Triton's block shapes are powers of two, and its ``dot`` needs
16 along every side); the padded theta columns are zero, so they add
nothing.  The ``pl.dot`` runs in TF32, like the plain fast path.

Written for Pallas's Triton route (``backend="triton"``).  Tests run it
with ``interpret=True`` on the CPU; nothing else does.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

# Register budget: W is [Bt, Kp^2] f32 per block, kept at 16K elements
# (64 KB across the block's 4 warps).
_W_ELEMS = 16384
# Past K=32 the [16, Kp^2] tile alone exceeds that budget.
MAX_KERNEL_K = 32


def _padded_k(k: int) -> int:
    return max(16, pl.next_power_of_2(k))


def tile_rows(k: int) -> int:
    """Rows per block at this K: 64 at K <= 16, 16 at K = 17..32."""
    kp = _padded_k(k)
    return max(16, min(64, _W_ELEMS // (kp * kp)))


def score_kernel_applies(arity: int, n_samples: int, k: int) -> bool:
    """Shapes the kernel serves: trigenic restart ensembles with K <= 32."""
    return arity == 3 and n_samples >= 1 and k <= MAX_KERNEL_K


def _score_kernel(i1_ref, i2_ref, i3_ref, theta_ref, p_ref, out_ref, *,
                  n_samples: int, n_genes: int, kp: int):
    i1, i2, i3 = i1_ref[...], i2_ref[...], i3_ref[...]
    bt = i1.shape[0]

    def restart(s, acc):
        off = s * n_genes
        th1 = theta_ref[i1 + off]                                # [Bt, Kp]
        th2 = theta_ref[i2 + off]
        th3 = theta_ref[i3 + off]
        w = (th1[:, :, None] * th2[:, None, :]).reshape(bt, kp * kp)
        p_s = p_ref[pl.ds(s * kp * kp, kp * kp), :]              # [Kp^2, Kp]
        a = pl.dot(w, p_s, allow_tf32=True)                      # [Bt, Kp]
        return acc + jnp.sum(a * th3, axis=1)

    acc = jax.lax.fori_loop(
        0, n_samples, restart, jnp.zeros((bt,), jnp.float32)
    )
    out_ref[...] = acc / n_samples


@functools.partial(jax.jit, static_argnames=("interact_rating", "interpret"))
def triton_ensemble_predict_interaction(
    states,
    triplets: jax.Array,
    interact_rating: int = 1,
    interpret: bool = False,
) -> jax.Array:
    """Sample-averaged P(interact) for [B, 3] triplets: f32 [B].

    Same semantics as ``ops.scoring.ensemble_predict_interaction``.  Rows
    are padded to the tile internally (gene 0, scores dropped), so any B
    works.  ``interpret=True`` runs the kernel in the Pallas interpreter
    (tests); otherwise it compiles for the GPU through Triton.
    """
    theta, p = states.theta, states.p        # [S, G, K], [S, K, K, K, R]
    S, G, K = theta.shape
    kp = _padded_k(K)
    bt = tile_rows(K)
    theta_st = (
        jnp.zeros((S, G, kp), jnp.float32)
        .at[:, :, :K].set(theta.astype(jnp.float32))
        .reshape(S * G, kp)
    )
    p_st = (
        jnp.zeros((S, kp, kp, kp), jnp.float32)
        .at[:, :K, :K, :K].set(p[..., interact_rating].astype(jnp.float32))
        .reshape(S * kp * kp, kp)
    )
    B = triplets.shape[0]
    Bp = -(-B // bt) * bt
    trips = jnp.zeros((Bp, 3), jnp.int32).at[:B].set(triplets.astype(jnp.int32))
    rows = pl.BlockSpec((bt,), lambda i: (i,))
    out = pl.pallas_call(
        functools.partial(_score_kernel, n_samples=S, n_genes=G, kp=kp),
        grid=(Bp // bt,),
        in_specs=[rows, rows, rows, pl.no_block_spec, pl.no_block_spec],
        out_specs=rows,
        out_shape=jax.ShapeDtypeStruct((Bp,), jnp.float32),
        backend="triton",
        compiler_params=pl_triton.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
        name="triton_ensemble_score",
    )(trips[:, 0], trips[:, 1], trips[:, 2], theta_st, p_st)
    return out[:B]
