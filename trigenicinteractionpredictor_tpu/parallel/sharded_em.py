"""Data-parallel EM sweep over a device mesh (SURVEY.md §3.3, §3.4, §4.1).

The reference runs one serial sweep per process; here the triplet shard on
each device computes its local :class:`SweepStats` and a single ``psum``
over the ``data`` axis merges them — the only cross-chip communication in
the whole algorithm (~50 KB at K=10, one round per sweep, an NCCL
all-reduce over NVLink between GPUs).  Restart ensembles ride along as a
vmapped leading axis on the state, sharded over the ``ensemble`` mesh
axis, with zero communication.

Replicated-parameter invariant: every device along ``data`` holds identical
(theta, p) after each step because it normalizes the same psum'd stats —
tested bitwise-ish in tests/test_sharding.py.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from trigenicinteractionpredictor_tpu.models.mmsbm import ModelState
from trigenicinteractionpredictor_tpu.ops.em import (
    Batch,
    SweepStats,
    em_sufficient_stats,
    log_likelihood,
    map_restarts as _map_restarts,
    normalize_from_stats,
)
from trigenicinteractionpredictor_tpu.parallel.mesh import DATA_AXIS, ENSEMBLE_AXIS


def shard_batch(mesh: Mesh, batch: Batch) -> Batch:
    """Place a host batch with rows sharded over the ``data`` axis.

    Rows must already be padded to a multiple of the data-axis size
    (data/packing.py pad_to); padding rows are weight-0 and inert.
    """
    sh = NamedSharding(mesh, P(DATA_AXIS))
    return Batch(
        *(None if x is None else jax.device_put(x, sh) for x in batch)
    )


def replicate(mesh: Mesh, tree):
    """Replicate a pytree across the whole mesh."""
    sh = NamedSharding(mesh, P())
    return jax.tree.map(lambda x: jax.device_put(x, sh), tree)


def shard_ensemble(mesh: Mesh, states: ModelState) -> ModelState:
    """Place a restart-stacked state (leading S axis) over ``ensemble``."""
    sh = NamedSharding(mesh, P(ENSEMBLE_AXIS))
    return jax.tree.map(lambda x: jax.device_put(x, sh), states)


def _per_restart_stats(stats_fn, states: ModelState, batch: Batch, precision):
    """Apply stats_fn per restart: vmap, or lax.map at large K (ops/em.py
    SERIAL_RESTART_K)."""
    return _map_restarts(
        lambda state: stats_fn(state.theta, state.p, batch, precision=precision),
        states,
    )


def make_sharded_train_step(
    mesh: Mesh,
    precision=jax.lax.Precision.HIGHEST,
    stats_fn: Callable = em_sufficient_stats,
) -> Callable[[ModelState, Batch, jax.Array], Tuple[ModelState, jax.Array]]:
    """Build the jitted multi-device EM step.

    Signature of the returned function::

        states, loglik = step(states, batch, degrees)

    - ``states``: ModelState with leading restart axis [S, ...], sharded over
      ``ensemble`` (S must divide the ensemble-axis size).
    - ``batch``: rows sharded over ``data``.
    - ``degrees``: replicated f32/int32 [G].
    - returns per-restart loglik [S] of the pre-update states.

    ``stats_fn`` lets a different statistics function (e.g. the
    row-chunked one) slot in without touching the communication structure.
    """

    def local_step(states: ModelState, batch: Batch, degrees: jax.Array):
        # Per-device: local restarts x local triplet shard, restarts vmapped
        # (or lax.map'd at large K — see _per_restart_stats).
        stats = _per_restart_stats(stats_fn, states, batch, precision)
        # The only cross-chip point: merge shard-local sufficient stats.
        stats = jax.lax.psum(stats, DATA_AXIS)
        new_states = jax.vmap(normalize_from_stats, in_axes=(0, 0, None))(
            states, stats, degrees
        )
        return new_states, stats.loglik

    shmapped = jax.shard_map(
        local_step,
        mesh=mesh,
        in_specs=(P(ENSEMBLE_AXIS), P(DATA_AXIS), P()),
        out_specs=(P(ENSEMBLE_AXIS), P(ENSEMBLE_AXIS)),
        check_vma=False,
    )
    # No buffer donation: the state is KB-MB scale, so aliasing buys
    # nothing here.
    return jax.jit(shmapped)


def make_sharded_multi_step(
    mesh: Mesh,
    n_inner: int,
    precision=jax.lax.Precision.HIGHEST,
    stats_fn: Callable = em_sufficient_stats,
    annealed: bool = False,
) -> Callable[[ModelState, Batch, jax.Array], Tuple[ModelState, jax.Array]]:
    """Like :func:`make_sharded_train_step` but runs ``n_inner`` chained EM
    sweeps per dispatch under ``lax.scan``.

    The reference's driver dispatches one interpreted sweep at a time
    (SURVEY.md §4.1); here the trainer batches the ``likelihood_freq``
    sweeps between convergence checks into one device-side loop, so the
    host dispatches and syncs once per check instead of once per sweep
    (whether that chunking still pays on the GPU is ROADMAP A7).  Returns
    ``(states, ll_hist)`` where
    ``ll_hist[i, s]`` is restart ``s``'s log-likelihood of the state *before*
    inner sweep ``i`` — the same per-sweep trace the single-step path yields.

    ``annealed=True`` adds a fourth argument ``betas`` (f32[n_inner]), the
    deterministic-annealing inverse temperatures (Ueda & Nakano-style DAEM).
    The annealed E-step responsibility omega^beta propto (th1 th2 th3 p)^beta
    factorizes into elementwise powers of the parameters, so each sweep just
    evaluates the unchanged stats_fn on (theta**beta, p**beta) — the stats,
    the psum, and the normalize tail are identical.  beta < 1 smooths the
    responsibilities toward uniform, merging nearby EM basins; the schedule
    ramps beta -> 1, at which point the sweep is exact EM again.  While
    beta < 1 the returned ll_hist rows are the *annealed* objective
    sum_b w_b log D_beta, not the true likelihood — the trainer suspends
    early-stopping until the ramp ends.
    """

    def local_multi(states, batch, degrees, betas):
        def body(carry, beta):
            # Elementwise parameter powers implement the annealed E-step;
            # beta == 1.0 is exact EM (the power is still computed, but the
            # annealed path is only compiled when annealing is requested).
            powered = ModelState(theta=carry.theta**beta, p=carry.p**beta)
            stats = _per_restart_stats(stats_fn, powered, batch, precision)
            stats = jax.lax.psum(stats, DATA_AXIS)
            new = jax.vmap(normalize_from_stats, in_axes=(0, 0, None))(
                carry, stats, degrees
            )
            return new, stats.loglik

        def body_plain(carry, _):
            stats = _per_restart_stats(stats_fn, carry, batch, precision)
            stats = jax.lax.psum(stats, DATA_AXIS)
            new = jax.vmap(normalize_from_stats, in_axes=(0, 0, None))(
                carry, stats, degrees
            )
            return new, stats.loglik

        if annealed:
            states, ll_hist = jax.lax.scan(body, states, betas)
        else:
            states, ll_hist = jax.lax.scan(body_plain, states, length=n_inner)
        return states, ll_hist  # ll_hist: [n_inner, S_local]

    shmapped = jax.shard_map(
        local_multi,
        mesh=mesh,
        in_specs=(P(ENSEMBLE_AXIS), P(DATA_AXIS), P(), P()),
        out_specs=(P(ENSEMBLE_AXIS), P(None, ENSEMBLE_AXIS)),
        check_vma=False,
    )
    jitted = jax.jit(shmapped)
    if annealed:
        return jitted
    # Preserve the historical 3-arg signature for the non-annealed path.
    zeros = None

    def call(states, batch, degrees):
        nonlocal zeros
        if zeros is None:
            zeros = replicate(mesh, jnp.ones((n_inner,), jnp.float32))
        return jitted(states, batch, degrees, zeros)

    return call


def make_sharded_stepwise_epoch(
    mesh: Mesh,
    n_minibatches: int,
    kappa: float = 0.7,
    t0: float = 2.0,
    precision=jax.lax.Precision.HIGHEST,
    stats_fn: Callable = em_sufficient_stats,
):
    """Stepwise (incremental/minibatch) EM: one epoch per dispatch.

    Classic EM recomputes sufficient statistics from the FULL dataset every
    update; stepwise EM (Cappe & Moulines 2009-style running averages, cf.
    the incremental-EM literature in PAPERS.md) updates after every
    minibatch, exponentially averaging full-data-equivalent statistics:

        s_hat_t = (W_total / W_mb) * stats(minibatch_t)     # unbiased scale
        S_t     = (1 - rho_t) S_{t-1} + rho_t * s_hat_t
        params  = normalize(S_t)                            # same M-step
        rho_t   = (t0 + t)^(-kappa),  kappa in (0.5, 1]

    Many parameter updates per data pass -> typically far fewer epochs to a
    given held-out AUC than full-batch EM (docs/DESIGN.md §6).  The
    monotone-likelihood guarantee does NOT hold per update; convergence is
    monitored on the epoch-summed likelihood instead.

    Returned step signature::

        states, ema, ll_sum, t = step(states, ema, t, batches, degrees,
                                      w_total)

    - ``batches``: Batch with a leading [n_minibatches] axis; rows of each
      minibatch sharded over ``data``.
    - ``ema``: SweepStats pytree (full-data scale) carried across epochs;
      initialize with zeros_like and t=0 — the first update uses rho ~ 1.
    - ``t``: f32 scalar update counter (across epochs).
    - ``ll_sum``: sum over the epoch's minibatches of the pre-update
      minibatch log-likelihood, full-data scaled — a monitoring trace.
    - ``w_total``: replicated f32 scalar — the FULL dataset's weight sum,
      passed explicitly (not derived from ``batches``) so the streaming
      loader can dispatch an epoch as several minibatch groups and still
      scale every group's statistics to full-data equivalents.
    """

    def local_epoch(states, ema, t, batches, degrees, w_total):
        def body(carry, mb):
            states, ema, t = carry
            stats = _per_restart_stats(stats_fn, states, mb, precision)
            stats = jax.lax.psum(stats, DATA_AXIS)
            w_mb = jax.lax.psum(jnp.sum(mb.weights), DATA_AXIS)
            scale = w_total / jnp.maximum(w_mb, 1.0)
            rho = (t0 + t) ** (-kappa)
            ema = SweepStats(
                theta_hat=(1 - rho) * ema.theta_hat + rho * scale * stats.theta_hat,
                p_hat=(1 - rho) * ema.p_hat + rho * scale * stats.p_hat,
                loglik=ema.loglik,  # not averaged; monitoring uses ll below
            )
            # Row-sum normalization: averaged minibatch statistics do not
            # satisfy the exact row-sum == degree identity (ops/em.py).
            new_states = jax.vmap(
                partial(normalize_from_stats, theta_norm="rowsum"),
                in_axes=(0, 0, None),
            )(states, ema, degrees)
            return (new_states, ema, t + 1.0), scale * stats.loglik

        (states, ema, t), lls = jax.lax.scan(
            body, (states, ema, t), batches, length=n_minibatches
        )
        return states, ema, lls.mean(axis=0), t

    shmapped = jax.shard_map(
        local_epoch,
        mesh=mesh,
        in_specs=(
            P(ENSEMBLE_AXIS),
            P(ENSEMBLE_AXIS),
            P(),
            P(None, DATA_AXIS),
            P(),
            P(),
        ),
        out_specs=(
            P(ENSEMBLE_AXIS),
            P(ENSEMBLE_AXIS),
            P(ENSEMBLE_AXIS),
            P(),
        ),
        check_vma=False,
    )
    return jax.jit(shmapped)


def zero_stats_like(states: ModelState) -> SweepStats:
    """Initial EMA carry for the stepwise path (restart-stacked)."""
    S = states.theta.shape[0]
    return SweepStats(
        theta_hat=jnp.zeros_like(states.theta),
        p_hat=jnp.zeros_like(states.p),
        loglik=jnp.zeros((S,), states.theta.dtype),
    )


def make_sharded_likelihood(
    mesh: Mesh,
    precision=jax.lax.Precision.HIGHEST,
    row_chunk: int = 0,
) -> Callable[[ModelState, Batch], jax.Array]:
    """Jitted per-restart log-likelihood over the sharded batch: f32[S]."""

    def local_ll(states: ModelState, batch: Batch):
        ll = _map_restarts(
            lambda st: log_likelihood(
                st, batch, precision=precision, row_chunk=row_chunk
            ),
            states,
        )
        return jax.lax.psum(ll, DATA_AXIS)

    shmapped = jax.shard_map(
        local_ll,
        mesh=mesh,
        in_specs=(P(ENSEMBLE_AXIS), P(DATA_AXIS)),
        out_specs=P(ENSEMBLE_AXIS),
        check_vma=False,
    )
    return jax.jit(shmapped)
