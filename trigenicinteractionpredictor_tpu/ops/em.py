"""Factorized EM sweep for the tensorial MMSBM (reference layer L3, the hot
core).

The reference implements one EM sweep as a per-triplet Python triple loop
over (k, l, m) — O(N * K^3 * R) interpreted operations (SURVEY.md §2 L3,
§4.1).  This module is the accelerator replacement: the whole sweep is a
handful of small matmuls plus gathers and a segment-sum, and the
per-triplet K^3 responsibility tensor omega is **never materialized**
(SURVEY.md §8.3).  It is the engine's only EM path; XLA compiles it for
the GPU (and for the CPU in tests).

Math (SURVEY.md §1.2), for one observation t = (i, j, e, r):

    omega_t(k,l,m) = theta[i,k] theta[j,l] theta[e,m] p[k,l,m,r] / D_t
    D_t            = sum_{klm} theta[i,k] theta[j,l] theta[e,m] p[k,l,m,r]

    theta_hat[g,k] propto sum over t containing g of omega_t's marginal at
                   g's position, normalized by the gene degree d(g)
    p_hat[k,l,m,r] propto sum_{t: r_t = r} omega_t(k,l,m), normalized over r
    L              = sum_t log D_t

Factorization used here (all per-batch tensors are O(B * K^2) at most):

    T[b,k,l]   = sum_m  theta3[b,m] p[k,l,m,r_b]      (matmul [B,K]x[K,K^2 R])
    D[b]       = sum_kl theta1[b,k] theta2[b,l] T[b,k,l]
    A1[b,k]    = sum_l  theta2[b,l] T[b,k,l]
    A2[b,l]    = sum_k  theta1[b,k] T[b,k,l]
    A3[b,m]    = sum_kl theta1 theta2 p[k,l,m,r_b]    (matmul [B,K^2]x[K^2,K R])
    s_pos[b,:] = theta_pos * A_pos * w_b / D_b        (position marginals)
    theta_hat  = segment_sum(s_pos streams, gene ids) (scatter-add)
    p_hat      = p * ( (W w/D)^T @ (theta3 x onehot(r)) )  (matmul [K^2,B]x[B,K R])
    L          = sum_b w_b log D_b

Padding rows carry weight 0 and contribute nothing (weights multiply every
per-triplet term).  All matmuls run at HIGHEST precision by default —
true f32 on the GPU (CUDA-core GEMMs rather than TF32 tensor cores), which
keeps the EM likelihood monotone; what a cheaper precision would cost in
monotonicity and buy in time is ROADMAP A4.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from trigenicinteractionpredictor_tpu.models.mmsbm import ModelState

_EPS = 1e-30

# Fusion guard.  optimization_barrier pins the natural schedule —
# materialize the [B, K] operands, then matmul — so that no elementwise
# producer (gather, outer product, one-hot multiply) is fused into a
# matmul operand.  A backend was once seen to miscompile exactly that
# fusion at large batch (statistics ~100x too small).  Whether the guard
# still earns its place on the GPU, and what it costs there, is ROADMAP
# A3; the runtime integrity check (utils/integrity.py) would catch such a
# miscompile either way.
_barrier = jax.lax.optimization_barrier


# Restart-mapping guard.  vmap over restarts at large K makes XLA plan S
# copies of the K^3-scale (or [B, K^2]) intermediates at once, which
# once crashed a compiler at K=50/S=10.  Past this K every restart-mapped
# computation (EM stats, likelihood, scoring) runs as a sequential
# lax.map instead.  Whether vmap is faster on the GPU is ROADMAP A6.
SERIAL_RESTART_K = 32


def map_restarts(f, states):
    """Apply ``f`` over a restart-stacked pytree: vmap, or lax.map at
    large K (see SERIAL_RESTART_K)."""
    theta = states.theta if hasattr(states, "theta") else states[0]
    if theta.shape[-1] >= SERIAL_RESTART_K and theta.shape[0] > 1:
        return jax.lax.map(f, states)
    return jax.vmap(f)(states)


class Batch(NamedTuple):
    """Device-side view of a packed triplet shard (see data/packing.py)."""

    triplets: jax.Array   # int32 [B, arity]
    ratings: jax.Array    # int32 [B]
    weights: jax.Array    # float32 [B]; 0 marks padding


class SweepStats(NamedTuple):
    """Unnormalized sufficient statistics of one EM sweep.

    These are the only cross-shard quantities: under data parallelism each
    shard computes its own SweepStats and a single psum merges them
    (SURVEY.md §3.4).
    """

    theta_hat: jax.Array  # f32 [G, K]
    p_hat: jax.Array      # f32 [K, K, K, R]
    loglik: jax.Array     # f32 scalar — likelihood of the *pre-update* state


def _gather_thetas(theta: jax.Array, triplets: jax.Array):
    """Per-position theta rows: a tuple of [B, K] arrays, one per gene slot."""
    return tuple(
        jnp.take(theta, triplets[:, pos], axis=0)
        for pos in range(triplets.shape[1])
    )


def _scatter_add_rows(
    vals: Tuple[jax.Array, ...],
    triplets: jax.Array,
    n_segments: int,
) -> jax.Array:
    """sum_b vals[pos][b] into rows [G, K] by gene id, over all positions.

    One segment_sum over the concatenated position streams: B * arity * K
    adds, which the GPU performs as atomic adds (so theta_hat's last bits
    may differ from run to run) and the CPU as a native scatter.  No
    [B, G] operand exists at any G.
    """
    seg_ids = triplets.T.reshape(-1)
    seg_vals = jnp.concatenate(vals, axis=0)
    return jax.ops.segment_sum(seg_vals, seg_ids, num_segments=n_segments)


def _chunked_batch(batch: Batch, row_chunk: int) -> Tuple[Batch, int, int]:
    """Reshape a batch into [n, rc, ...] chunks, padding the tail with
    weight-0 rows (inert everywhere) when B is not a chunk multiple.

    Must never silently fall back to one whole-batch chunk — the chunking
    exists to bound the per-chunk [rows, K, K, R] intermediates at large
    K, and evaluation batches have arbitrary (odd) row counts.
    """
    B = batch.triplets.shape[0]
    rc = min(row_chunk, B)
    n = -(-B // rc)
    pad = n * rc - B
    trip, r, w = batch.triplets, batch.ratings, batch.weights
    if pad:
        trip = jnp.concatenate(
            [trip, jnp.zeros((pad, trip.shape[1]), trip.dtype)]
        )
        r = jnp.concatenate([r, jnp.zeros((pad,), r.dtype)])
        w = jnp.concatenate([w, jnp.zeros((pad,), w.dtype)])
    chunks = Batch(
        triplets=trip.reshape(n, rc, trip.shape[1]),
        ratings=r.reshape(n, rc),
        weights=w.reshape(n, rc),
    )
    return chunks, rc, n


def em_sufficient_stats(
    theta: jax.Array,
    p: jax.Array,
    batch: Batch,
    precision=jax.lax.Precision.HIGHEST,
    row_chunk: int = 0,
) -> SweepStats:
    """E-step + M-accumulate fused over one batch (no normalization).

    Replaces the body of the reference's ``make_iteration()`` up to the
    normalize/swap tail (SURVEY.md §4.2).  Dispatches on the static tuple
    width: arity-3 (trigenic, p[K,K,K,R]) below, arity-2 (digenic,
    p[K,K,R] — the original pairwise MMSBM family) in
    :func:`pair_em_sufficient_stats`.

    ``row_chunk`` > 0 processes the batch in row chunks under ``lax.scan``,
    summing the chunk statistics (exact — the stats are linear in rows).
    It bounds the [rows, K, K, R] intermediates at large K, where a whole
    batch of them would not fit device memory; what chunking costs at
    small K on the GPU is part of ROADMAP A3.
    """
    if batch.triplets.shape[1] == 2:
        return pair_em_sufficient_stats(theta, p, batch, precision=precision)
    if row_chunk and batch.triplets.shape[0] > row_chunk:
        chunks, _, _ = _chunked_batch(batch, row_chunk)

        def body(acc, mb):
            s = em_sufficient_stats(theta, p, mb, precision=precision)
            return jax.tree.map(jnp.add, acc, s), None

        init = SweepStats(
            theta_hat=jnp.zeros_like(theta),
            p_hat=jnp.zeros_like(p),
            loglik=jnp.zeros((), theta.dtype),
        )
        acc, _ = jax.lax.scan(body, init, chunks)
        return acc
    G, K = theta.shape
    R = p.shape[-1]
    B = batch.triplets.shape[0]
    r = batch.ratings
    w = batch.weights.astype(theta.dtype)

    th1, th2, th3 = _barrier(_gather_thetas(theta, batch.triplets))

    # T_all[b,k,l,r] = sum_m theta3[b,m] p[k,l,m,r]
    p_m = jnp.transpose(p, (2, 0, 1, 3)).reshape(K, K * K * R)
    T_all = jnp.matmul(th3, p_m, precision=precision).reshape(B, K, K, R)
    T = _barrier(
        jnp.take_along_axis(T_all, r[:, None, None, None], axis=3)[..., 0]
    )

    # Denominator D_b and position-1/2 marginal helpers from T.
    Tth2 = jnp.einsum("bkl,bl->bk", T, th2, precision=precision)   # = A1
    D = jnp.einsum("bk,bk->b", th1, Tth2, precision=precision)
    A1 = Tth2
    A2 = jnp.einsum("bkl,bk->bl", T, th1, precision=precision)

    # Position-3 marginal helper via the W @ p matmul.
    W = (th1[:, :, None] * th2[:, None, :]).reshape(B, K * K)
    A3_all = jnp.matmul(
        W, p.reshape(K * K, K * R), precision=precision
    ).reshape(B, K, R)
    A3 = jnp.take_along_axis(A3_all, r[:, None, None], axis=2)[..., 0]
    A1, A2, A3, D, W = _barrier((A1, A2, A3, D, W))

    scale = w / (D + _EPS)                                         # [B]

    # theta sufficient statistics: three position streams scatter-added by
    # gene id.  Padding rows have scale 0.
    s1 = th1 * A1 * scale[:, None]
    s2 = th2 * A2 * scale[:, None]
    s3 = th3 * A3 * scale[:, None]
    theta_hat = _scatter_add_rows((s1, s2, s3), batch.triplets, G)

    # p sufficient statistics: one [K^2, B] x [B, K*R] matmul.
    V = W * scale[:, None]                                         # [B, K^2]
    onehot_r = jax.nn.one_hot(r, R, dtype=theta.dtype)             # [B, R]
    th3r = (th3[:, :, None] * onehot_r[:, None, :]).reshape(B, K * R)
    V, th3r = _barrier((V, th3r))
    S = jnp.matmul(V.T, th3r, precision=precision)                 # [K^2, K*R]
    p_hat = p * S.reshape(K, K, K, R)

    loglik = jnp.sum(w * jnp.log(D + _EPS))
    return SweepStats(theta_hat=theta_hat, p_hat=p_hat, loglik=loglik)


def pair_em_sufficient_stats(
    theta: jax.Array,
    p: jax.Array,
    batch: Batch,
    precision=jax.lax.Precision.HIGHEST,
) -> SweepStats:
    """Arity-2 EM sweep stats: the digenic / pairwise MMSBM family.

    Same §1.2 equations with one fewer gene position — p is [K, K, R] and
    the responsibility tensor omega_t(k, l) is, as in the 3-way path, never
    materialized:

        A1[b,k] = sum_l theta2[b,l] p[k,l,r_b]     (matmul [B,K]x[K,K R])
        A2[b,l] = sum_k theta1[b,k] p[k,l,r_b]
        D[b]    = sum_k theta1[b,k] A1[b,k]
        p_hat[k,l,r] = p[k,l,r] * sum_{b: r_b=r} theta1 theta2 w/D
                                                   (matmul [K,B]x[B,K R])
    """
    G, K = theta.shape
    R = p.shape[-1]
    B = batch.triplets.shape[0]
    r = batch.ratings
    w = batch.weights.astype(theta.dtype)

    th1, th2 = _barrier(_gather_thetas(theta, batch.triplets))

    # A1_all[b,k,r] = sum_l th2[b,l] p[k,l,r];  A2_all[b,l,r] from th1.
    p_l = jnp.transpose(p, (1, 0, 2)).reshape(K, K * R)
    A1_all = jnp.matmul(th2, p_l, precision=precision).reshape(B, K, R)
    A2_all = jnp.matmul(th1, p.reshape(K, K * R), precision=precision).reshape(
        B, K, R
    )
    A1 = jnp.take_along_axis(A1_all, r[:, None, None], axis=2)[..., 0]
    A2 = jnp.take_along_axis(A2_all, r[:, None, None], axis=2)[..., 0]
    D = jnp.einsum("bk,bk->b", th1, A1, precision=precision)
    A1, A2, D = _barrier((A1, A2, D))

    scale = w / (D + _EPS)                                         # [B]
    s1 = th1 * A1 * scale[:, None]
    s2 = th2 * A2 * scale[:, None]
    theta_hat = _scatter_add_rows((s1, s2), batch.triplets, G)

    # p sufficient statistics: one [K, B] x [B, K*R] matmul.
    onehot_r = jax.nn.one_hot(r, R, dtype=theta.dtype)             # [B, R]
    th2r = (th2[:, :, None] * onehot_r[:, None, :]).reshape(B, K * R)
    th1s = th1 * scale[:, None]
    th1s, th2r = _barrier((th1s, th2r))
    S = jnp.matmul(th1s.T, th2r, precision=precision)              # [K, K*R]
    p_hat = p * S.reshape(K, K, R)

    loglik = jnp.sum(w * jnp.log(D + _EPS))
    return SweepStats(theta_hat=theta_hat, p_hat=p_hat, loglik=loglik)


def normalize_from_stats(
    state: ModelState,
    stats: SweepStats,
    degrees: jax.Array,
    theta_norm: str = "degree",
) -> ModelState:
    """M-step normalization (the tail of the reference's sweep).

    theta rows divide by the gene's *training* degree d(g) — genes absent
    from the training split keep their old row (SURVEY.md §8.4 risk 6).
    p cells normalize over ratings — cells with no mass keep their old value.

    ``theta_norm="rowsum"`` divides each theta row by its own sum instead.
    For exact full-batch statistics the two coincide (each observation
    containing g contributes total responsibility 1 to g's row, so the row
    sums to d(g)); for stepwise EM's exponentially averaged minibatch
    statistics only the row-sum form keeps rows on the simplex.
    """
    deg = degrees.astype(state.theta.dtype)
    if theta_norm == "rowsum":
        denom = jnp.sum(stats.theta_hat, axis=-1)
    else:
        denom = deg
    theta_new = stats.theta_hat / jnp.maximum(denom, _EPS)[:, None]
    theta = jnp.where((denom > 0)[:, None], theta_new, state.theta)

    p_mass = jnp.sum(stats.p_hat, axis=-1, keepdims=True)
    p = jnp.where(p_mass > _EPS, stats.p_hat / (p_mass + _EPS), state.p)
    return ModelState(theta=theta, p=p)


def em_step(
    state: ModelState,
    batch: Batch,
    degrees: jax.Array,
    precision=jax.lax.Precision.HIGHEST,
) -> Tuple[ModelState, jax.Array]:
    """One full EM sweep.  Returns (new_state, loglik of the *old* state).

    Single-device version; the sharded version wraps
    :func:`em_sufficient_stats` in shard_map and psums the SweepStats
    (parallel/sharded_em.py).
    """
    stats = em_sufficient_stats(state.theta, state.p, batch, precision=precision)
    return normalize_from_stats(state, stats, degrees), stats.loglik


def log_likelihood(
    state: ModelState,
    batch: Batch,
    precision=jax.lax.Precision.HIGHEST,
    row_chunk: int = 0,
) -> jax.Array:
    """Weighted sum_b w_b log P(r_b | i, j, e) under the current state.

    The per-triplet probability is exactly the E-step denominator D_b
    (SURVEY.md §8.3), so this shares the T-matmul shape with the sweep.
    Handles both the trigenic (arity-3) and digenic (arity-2) families.
    ``row_chunk``: see :func:`em_sufficient_stats` (the same large-K
    intermediates arise in the per-rating gather here).
    """
    if (
        row_chunk
        and batch.triplets.shape[1] == 3
        and batch.triplets.shape[0] > row_chunk
    ):
        chunks, _, _ = _chunked_batch(batch, row_chunk)

        def body(acc, mb):
            return acc + log_likelihood(state, mb, precision=precision), None

        acc, _ = jax.lax.scan(body, jnp.zeros((), state.theta.dtype), chunks)
        return acc
    theta, p = state.theta, state.p
    G, K = theta.shape
    R = p.shape[-1]
    B = batch.triplets.shape[0]
    w = batch.weights.astype(theta.dtype)
    if batch.triplets.shape[1] == 2:
        th1, th2 = _barrier(_gather_thetas(theta, batch.triplets))
        p_l = jnp.transpose(p, (1, 0, 2)).reshape(K, K * R)
        A1_all = jnp.matmul(th2, p_l, precision=precision).reshape(B, K, R)
        A1 = jnp.take_along_axis(
            A1_all, batch.ratings[:, None, None], axis=2
        )[..., 0]
        D = jnp.einsum("bk,bk->b", th1, A1, precision=precision)
        return jnp.sum(w * jnp.log(D + _EPS))
    th1, th2, th3 = _barrier(_gather_thetas(theta, batch.triplets))
    p_m = jnp.transpose(p, (2, 0, 1, 3)).reshape(K, K * K * R)
    T_all = jnp.matmul(th3, p_m, precision=precision).reshape(B, K, K, R)
    T = _barrier(
        jnp.take_along_axis(T_all, batch.ratings[:, None, None, None], axis=3)[..., 0]
    )
    D = jnp.einsum("bk,bkl,bl->b", th1, T, th2, precision=precision)
    return jnp.sum(w * jnp.log(D + _EPS))
