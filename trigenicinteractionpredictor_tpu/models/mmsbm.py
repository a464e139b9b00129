"""MMSBM model state as a JAX pytree (reference layer L2).

The reference holds ``theta`` as a dict gene -> list[K] and ``p`` as a
nested K x K x K x R Python list, with shadow accumulators ``ntheta``/``npr``
(SURVEY.md §2 L2).  The device state is two dense arrays in a registered
dataclass pytree — accumulators are not state, they are values flowing
through the pure EM step.

Simplex invariants (tested in tests/test_invariants.py):
- every row ``theta[g, :]`` sums to 1 and is non-negative;
- every cell ``p[k, l, m, :]`` sums to 1 over ratings and is non-negative.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class ModelState:
    """Parameters of the tensorial MMSBM.

    theta: f32[..., G, K]    per-gene mixed membership (rows on the simplex)
    p:     f32[..., K, ..., K, R] group-tuple rating distributions — one K
           axis per gene position: [K, K, K, R] for the trigenic (3-way)
           family, [K, K, R] for the digenic (2-way) family of the original
           pairwise MMSBM recommender (SURVEY.md §0 [method]).

    Leading batch dims (restart ensembles via vmap) are allowed on both.
    """

    theta: jax.Array
    p: jax.Array

    @property
    def n_genes(self) -> int:
        return self.theta.shape[-2]

    @property
    def k(self) -> int:
        return self.theta.shape[-1]

    @property
    def n_ratings(self) -> int:
        return self.p.shape[-1]

    @property
    def arity(self) -> int:
        """Gene positions per observation (number of K axes on p)."""
        n_batch = self.theta.ndim - 2
        return self.p.ndim - n_batch - 1


def init_state(
    key: jax.Array,
    n_genes: int,
    k: int,
    n_ratings: int = 2,
    alpha: float = 1.0,
    dtype=jnp.float32,
    arity: int = 3,
) -> ModelState:
    """Random simplex initialization for one restart.

    The reference seeds ``random`` per sample and fills theta rows / p cells
    with normalized uniforms (SURVEY.md §2 "Random init").  Here each
    restart's state comes from an independent fold of a threefry key, and
    ``alpha`` selects a Dirichlet concentration (alpha=1 == normalized
    exponentials == the uniform simplex distribution).

    vmap this over a batch of keys to build a restart ensemble.
    """
    k_theta, k_p = jax.random.split(key)
    theta = jax.random.dirichlet(
        k_theta, jnp.full((k,), alpha, dtype=jnp.float32), shape=(n_genes,)
    )
    p = jax.random.dirichlet(
        k_p, jnp.full((n_ratings,), alpha, dtype=jnp.float32), shape=(k,) * arity
    )
    return ModelState(theta=theta.astype(dtype), p=p.astype(dtype))
