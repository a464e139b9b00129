"""Held-out triplet scoring (reference layer L5, SURVEY.md §4.4).

The reference's evaluation pass recomputes, for each held-out triplet, the
full rating distribution P(r | i, j, e) from the converged (theta, p), then
averages the interaction probability across restart samples before ranking.
On device this is the same factorized contraction as the E-step denominator,
evaluated for all R ratings at once.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from trigenicinteractionpredictor_tpu.models.mmsbm import ModelState
from trigenicinteractionpredictor_tpu.ops.em import (
    _barrier,
    _gather_thetas,
    map_restarts,
)


def predict_proba(
    state: ModelState,
    triplets: jax.Array,
    precision=jax.lax.Precision.HIGHEST,
) -> jax.Array:
    """P(r | genes) for every row: f32[B, R].

    Trigenic: score[b, r] = sum_klm theta1[b,k] theta2[b,l] theta3[b,m]
    p[k,l,m,r], computed as W[B,K^2] @ p[K^2, K*R] contracted with theta3 —
    O(B K^2) memory, one matmul.  Digenic rows ([B, 2]) use the pairwise
    family's p[K, K, R] with one fewer contraction.
    """
    theta, p = state.theta, state.p
    K = theta.shape[-1]
    R = p.shape[-1]
    B = triplets.shape[0]
    if triplets.shape[1] == 2:
        th1, th2 = _barrier(_gather_thetas(theta, triplets))
        A2_all = jnp.matmul(th1, p.reshape(K, K * R), precision=precision)
        return jnp.einsum(
            "blr,bl->br", A2_all.reshape(B, K, R), th2, precision=precision
        )
    # _barrier: see ops/em.py — keeps gathers/outer products out of the
    # matmul fusion cluster.
    th1, th2, th3 = _barrier(_gather_thetas(theta, triplets))
    W = _barrier((th1[:, :, None] * th2[:, None, :]).reshape(B, K * K))
    A3_all = jnp.matmul(W, p.reshape(K * K, K * R), precision=precision)
    return jnp.einsum(
        "bmr,bm->br", A3_all.reshape(B, K, R), th3, precision=precision
    )


def predict_interaction(
    state: ModelState,
    triplets: jax.Array,
    interact_rating: int = 1,
) -> jax.Array:
    """P(r = interact | i, j, e): the ranking score for AUC.  f32[B]."""
    return predict_proba(state, triplets)[:, interact_rating]


def ensemble_predict_interaction(
    states: ModelState,
    triplets: jax.Array,
    interact_rating: int = 1,
) -> jax.Array:
    """Average P(interact) over a restart ensemble (leading axis on state).

    Mirrors the reference's sample-averaging protocol (SURVEY.md §1.2):
    probabilities are averaged over S independent restarts before ranking.
    """
    scores = map_restarts(
        lambda st: predict_interaction(st, triplets, interact_rating), states
    )
    return jnp.mean(scores, axis=0)


def ensemble_predict_interaction_batched(
    states: ModelState,
    triplets: jax.Array,
    interact_rating: int = 1,
    precision=None,
) -> jax.Array:
    """Sample-averaged P(interact) with the restart axis BATCHED into one
    dot_general instead of a per-restart loop (the serving fast path).

    The per-restart scoring matmul is [B, K^2] x [K^2, K*R] — contraction
    and output dims of 100 and 20 at the production K=10, far too small
    to fill the device one restart at a time.  Batching the S restarts
    into one [S, B, K^2] x [S, K^2, K*R] dot_general amortizes the launch
    cost.  DEFAULT precision (None) runs TF32 on the GPU, which moves
    P(interact) by well under 2e-3 — irrelevant to ranking (the eval
    paths keep the HIGHEST-precision per-restart scorer for bit-stable
    records).
    """
    theta, p = states.theta, states.p   # [S, G, K], [S, K, K, K, R]
    S, _, K = theta.shape
    R = p.shape[-1]
    B = triplets.shape[0]
    th1 = jnp.take(theta, triplets[:, 0], axis=1)   # [S, B, K]
    th2 = jnp.take(theta, triplets[:, 1], axis=1)
    th3 = jnp.take(theta, triplets[:, 2], axis=1)
    W = (th1[:, :, :, None] * th2[:, :, None, :]).reshape(S, B, K * K)
    A = jax.lax.dot_general(
        W, p.reshape(S, K * K, K * R),
        dimension_numbers=(((2,), (1,)), ((0,), (0,))),
        preferred_element_type=jnp.float32,
        precision=precision,
    ).reshape(S, B, K, R)
    probs = jnp.einsum("sbkr,sbk->sbr", A, th3, precision=precision)
    return jnp.mean(probs[:, :, interact_rating], axis=0)


@functools.partial(
    jax.jit, static_argnames=("interact_rating", "scorer", "interpret")
)
def _score_chunk(theta, p, tb, interact_rating, scorer, interpret):
    """Score [M, block, arity] triplets block by block under lax.map."""
    from trigenicinteractionpredictor_tpu.ops import pallas_score

    st = ModelState(theta=theta, p=p)

    def score_block(tr):
        if scorer == "kernel":
            return pallas_score.triton_ensemble_predict_interaction(
                st, tr, interact_rating, interpret=interpret
            )
        if scorer == "batched":
            return ensemble_predict_interaction_batched(st, tr, interact_rating)
        if scorer == "loop":
            return ensemble_predict_interaction(st, tr, interact_rating)
        return predict_interaction(st, tr, interact_rating)

    return jax.lax.map(score_block, tb)


def serve_predict_interaction(
    states: ModelState,
    triplets,
    interact_rating: int = 1,
    block_rows: int = 131072,
    fast: bool = True,
    blocks_per_dispatch: int = 8,
    interpret: bool = False,
):
    """High-throughput ensemble scoring for large inputs (numpy in/out).

    Scorer choice: with ``fast``, a restart ensemble of a shape the fused
    kernel serves (ops/pallas_score.py ``score_kernel_applies``) is scored
    by that kernel on the GPU (or in the Pallas interpreter with
    ``interpret=True``, for tests); other trigenic ensembles by the
    restart-batched scorer at DEFAULT precision; ``fast=False`` keeps the
    HIGHEST-precision per-restart scorer (bit-stable with the eval path).
    Both fast scorers run TF32 on the GPU: P(interact) moves by at most
    2e-3 against the HIGHEST scorer, immaterial for ranking.

    Input is cut into fixed-shape blocks, and ``blocks_per_dispatch`` of
    them go to the device as ONE transfer and ONE lax.map dispatch; the
    results are fetched only after the whole queue is enqueued.  Tails are
    padded, so one executable per (shape, scorer) serves any input length,
    and repeat calls run warm.
    """
    import numpy as np

    from trigenicinteractionpredictor_tpu.ops import pallas_score

    trips = np.asarray(triplets)
    n = trips.shape[0]
    if n == 0:
        return np.zeros((0,), np.float32)
    block = min(block_rows, max(n, 1))
    arity = trips.shape[1]
    if states.theta.ndim != 3:
        scorer = "single"            # one state, not a restart ensemble
    elif not fast:
        scorer = "loop"
    elif pallas_score.score_kernel_applies(
        arity, states.theta.shape[0], states.theta.shape[-1]
    ) and (interpret or jax.default_backend() == "gpu"):
        scorer = "kernel"
    elif arity == 3:
        scorer = "batched"
    else:
        scorer = "loop"

    # Pad to whole super-chunks so ONE executable serves any length; the
    # waste is at most M-1 block computes on the tail.
    M = max(1, blocks_per_dispatch)
    n_blocks = -(-n // block)
    n_chunks = -(-n_blocks // M)
    padded = np.zeros((n_chunks * M * block, arity), trips.dtype)
    padded[:n] = trips
    chunks = padded.reshape(n_chunks, M, block, arity)

    th = jnp.asarray(states.theta)
    p = jnp.asarray(states.p)
    outs = [
        _score_chunk(th, p, jnp.asarray(c), interact_rating, scorer, interpret)
        for c in chunks
    ]
    # One sync for the whole chain: convert after everything is enqueued.
    flat = np.concatenate([np.asarray(o).reshape(-1) for o in outs])
    return flat[:n]
