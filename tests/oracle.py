"""Independent NumPy EM oracle, written directly from the SURVEY.md §1.2
equations (NOT ported from the reference — the reference mount was empty;
this is the test-time source of truth the JAX/Pallas engine must match,
SURVEY.md §5.1).

Deliberately naive and loop-free-ish but float64 and unfactorized: it
materializes the full per-triplet responsibility tensor omega[K,K,K] one
observation at a time, exactly as the math reads.  Slow (O(N K^3)) — use
only on toy shapes.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def init_params(
    n_genes: int, k: int, n_ratings: int, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """Random simplex init (float64)."""
    rng = np.random.default_rng(seed)
    theta = rng.random((n_genes, k))
    theta /= theta.sum(axis=1, keepdims=True)
    p = rng.random((k, k, k, n_ratings))
    p /= p.sum(axis=3, keepdims=True)
    return theta, p


def em_sweep(
    theta: np.ndarray,
    p: np.ndarray,
    triplets: np.ndarray,
    ratings: np.ndarray,
    degrees: np.ndarray = None,
) -> Tuple[np.ndarray, np.ndarray, float]:
    """One EM sweep.  Returns (theta_new, p_new, loglik of the OLD params).

    E-step: omega_t(k,l,m) = theta[i,k] theta[j,l] theta[e,m] p[k,l,m,r_t] / D_t
    M-step: theta_hat[g,k] = sum of omega marginals at g's positions / d(g)
            p_hat propto sum_{t: r_t=r} omega_t, normalized over r
    """
    G, K = theta.shape
    R = p.shape[-1]
    if degrees is None:
        degrees = np.bincount(triplets.reshape(-1), minlength=G)

    ntheta = np.zeros_like(theta)
    npr = np.zeros_like(p)
    loglik = 0.0
    for (i, j, e), r in zip(triplets, ratings):
        # Full K^3 responsibility tensor for this observation.
        prod = (
            theta[i][:, None, None]
            * theta[j][None, :, None]
            * theta[e][None, None, :]
            * p[:, :, :, r]
        )
        D = prod.sum()
        loglik += np.log(D)
        omega = prod / D
        ntheta[i] += omega.sum(axis=(1, 2))
        ntheta[j] += omega.sum(axis=(0, 2))
        ntheta[e] += omega.sum(axis=(0, 1))
        npr[:, :, :, r] += omega

    theta_new = theta.copy()
    mask = degrees > 0
    theta_new[mask] = ntheta[mask] / degrees[mask, None]

    p_new = p.copy()
    mass = npr.sum(axis=3)
    cell_mask = mass > 0
    p_new[cell_mask] = npr[cell_mask] / mass[cell_mask][:, None]
    return theta_new, p_new, float(loglik)


def em_sufficient_stats(
    theta: np.ndarray,
    p: np.ndarray,
    tuples: np.ndarray,
    ratings: np.ndarray,
    weights: np.ndarray = None,
) -> Tuple[np.ndarray, np.ndarray, float]:
    """Unnormalized sweep statistics (theta_hat, p_hat, loglik), float64,
    for arity 3 (p [K,K,K,R]) or arity 2 (p [K,K,R]).

    theta_hat[g] sums w * (responsibility marginal at g's position);
    p_hat sums w * omega into the observed rating's cell; loglik sums
    w * log D.  Weight-0 rows (padding) contribute nothing.
    """
    theta = np.asarray(theta, np.float64)
    p = np.asarray(p, np.float64)
    if weights is None:
        weights = np.ones(len(tuples))
    arity = tuples.shape[1]
    ntheta = np.zeros_like(theta)
    npr = np.zeros_like(p)
    loglik = 0.0
    for row, r, w in zip(tuples, ratings, weights):
        if w == 0:
            continue
        if arity == 3:
            i, j, e = row
            prod = (
                theta[i][:, None, None]
                * theta[j][None, :, None]
                * theta[e][None, None, :]
                * p[:, :, :, r]
            )
            margins = ((1, 2), (0, 2), (0, 1))
        else:
            prod = theta[row[0]][:, None] * theta[row[1]][None, :] * p[:, :, r]
            margins = ((1,), (0,))
        D = prod.sum()
        loglik += w * np.log(D)
        omega = w * prod / D
        for g, axes in zip(row, margins):
            ntheta[g] += omega.sum(axis=axes)
        npr[..., r] += omega
    return ntheta, npr, float(loglik)


def log_likelihood(
    theta: np.ndarray, p: np.ndarray, triplets: np.ndarray, ratings: np.ndarray
) -> float:
    ll = 0.0
    for (i, j, e), r in zip(triplets, ratings):
        D = (
            theta[i][:, None, None]
            * theta[j][None, :, None]
            * theta[e][None, None, :]
            * p[:, :, :, r]
        ).sum()
        ll += np.log(D)
    return float(ll)


def predict_proba(
    theta: np.ndarray, p: np.ndarray, triplets: np.ndarray
) -> np.ndarray:
    """P(r | i,j,e) for each row: float64 [B, R]."""
    out = np.zeros((len(triplets), p.shape[-1]))
    for b, (i, j, e) in enumerate(triplets):
        out[b] = np.einsum(
            "k,l,m,klmr->r", theta[i], theta[j], theta[e], p
        )
    return out


# ----------------------------------------------------------------------
# Pairwise (digenic, arity-2) family: same §1.2 equations with one fewer
# gene position — the original pairwise MMSBM recommender.
# ----------------------------------------------------------------------

def init_params_pair(
    n_genes: int, k: int, n_ratings: int, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    theta = rng.random((n_genes, k))
    theta /= theta.sum(axis=1, keepdims=True)
    p = rng.random((k, k, n_ratings))
    p /= p.sum(axis=2, keepdims=True)
    return theta, p


def em_sweep_pair(
    theta: np.ndarray,
    p: np.ndarray,
    pairs: np.ndarray,
    ratings: np.ndarray,
    degrees: np.ndarray = None,
) -> Tuple[np.ndarray, np.ndarray, float]:
    """One arity-2 EM sweep.  Returns (theta_new, p_new, loglik of OLD)."""
    G, K = theta.shape
    if degrees is None:
        degrees = np.bincount(pairs.reshape(-1), minlength=G)

    ntheta = np.zeros_like(theta)
    npr = np.zeros_like(p)
    loglik = 0.0
    for (i, j), r in zip(pairs, ratings):
        prod = theta[i][:, None] * theta[j][None, :] * p[:, :, r]
        D = prod.sum()
        loglik += np.log(D)
        omega = prod / D
        ntheta[i] += omega.sum(axis=1)
        ntheta[j] += omega.sum(axis=0)
        npr[:, :, r] += omega

    theta_new = theta.copy()
    mask = degrees > 0
    theta_new[mask] = ntheta[mask] / degrees[mask, None]

    p_new = p.copy()
    mass = npr.sum(axis=2)
    cell_mask = mass > 0
    p_new[cell_mask] = npr[cell_mask] / mass[cell_mask][:, None]
    return theta_new, p_new, float(loglik)


def log_likelihood_pair(
    theta: np.ndarray, p: np.ndarray, pairs: np.ndarray, ratings: np.ndarray
) -> float:
    ll = 0.0
    for (i, j), r in zip(pairs, ratings):
        D = (theta[i][:, None] * theta[j][None, :] * p[:, :, r]).sum()
        ll += np.log(D)
    return float(ll)


def predict_proba_pair(
    theta: np.ndarray, p: np.ndarray, pairs: np.ndarray
) -> np.ndarray:
    out = np.zeros((len(pairs), p.shape[-1]))
    for b, (i, j) in enumerate(pairs):
        out[b] = np.einsum("k,l,klr->r", theta[i], theta[j], p)
    return out
