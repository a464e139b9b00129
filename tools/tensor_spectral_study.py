"""Seeding attack on the deep-basin unlock.

The landscape study (docs/DESIGN.md §5b, "EM quality study") proved that
on peaky ground truth (alpha_theta=0.05) the deep basin's attraction
zone is wide — a seed with >= ~60% partition purity lets EM finish the
job — and that nothing PAIRWISE can build such a seed (spectral inits
purity 0.23-0.26; restart co-association correlates 0.046 with truth).
The one untried family: seeds built from the TRIGENIC joint structure
itself.  This tool measures two:

1. ``unfold``  — tensor-unfolding spectral init: the mode-1 unfolding
   M[i, (j,e)] of the centered rating tensor (each gene's profile over
   the PAIRS it was observed with — third-order signal a gene-gene
   co-occurrence matrix marginalizes away).  Top-K left singular space
   of M (via the [G, G] gram), k-means, purity vs the true partition.
2. ``agree``   — aligned-ensemble agreement: fit a wide short ensemble,
   greedily align every restart's theta columns to lane 0 by
   correlation, average the aligned thetas, take argmax labels.

For any method with purity > 0.3 the tool also seeds a full EM from the
partition and reports train L / held-out AUC vs plain EM.  One JSON line
per method.

Usage: python tools/tensor_spectral_study.py --cpu [--seeds 3]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def purity(labels: np.ndarray, truth: np.ndarray, k: int) -> float:
    """Cluster purity: fraction of genes whose predicted cluster's
    majority true label matches theirs."""
    total = 0
    for c in range(k):
        members = truth[labels == c]
        if members.size:
            total += np.bincount(members).max()
    return total / labels.shape[0]


def unfold_labels(ds, g: int, k: int, seed: int) -> np.ndarray:
    """Mode-1 unfolding spectral partition."""
    from trigenicinteractionpredictor_tpu.models.informed_init import _kmeans

    trip = np.asarray(ds.triplets)
    rat = np.asarray(ds.ratings).astype(np.float64)
    w = np.asarray(ds.weights)
    real = w > 0
    trip, rat = trip[real], rat[real]
    centered = rat - rat.mean()

    # pair ids over the (j, e) companion pairs, per position
    M = np.zeros((g, g * g), np.float64)   # dense mode-1 unfolding
    C = np.zeros((g, g * g), np.float64)   # observation counts
    for pos in range(3):
        i = trip[:, pos]
        o1 = trip[:, (pos + 1) % 3]
        o2 = trip[:, (pos + 2) % 3]
        lo, hi = np.minimum(o1, o2), np.maximum(o1, o2)
        pid = lo * g + hi
        np.add.at(M, (i, pid), centered)
        np.add.at(C, (i, pid), 1.0)
    np.divide(M, C, out=M, where=C > 0)   # mean centered rating per cell
    # count-reweighted: frequent pairs carry more evidence
    M *= np.sqrt(C)
    # row-normalize so high-degree genes don't dominate the gram
    norms = np.linalg.norm(M, axis=1, keepdims=True)
    Mn = M / np.maximum(norms, 1e-12)
    gram = Mn @ Mn.T
    np.fill_diagonal(gram, 0.0)
    vals, vecs = np.linalg.eigh(gram)
    X = vecs[:, -k:]
    X /= np.maximum(np.linalg.norm(X, axis=1, keepdims=True), 1e-12)
    centers = _kmeans(X, k, seed)   # informed_init returns centers [k, d]
    d2 = ((X[:, None, :] - centers[None]) ** 2).sum(-1)
    return d2.argmin(axis=1)


def agree_labels(train, g: int, k: int, s: int, sweeps: int, seed: int):
    """Aligned-ensemble agreement partition: greedily match every
    restart's theta columns to the best-likelihood lane's by correlation,
    average the aligned thetas, take argmax labels."""
    from trigenicinteractionpredictor_tpu.config import Config, TrainConfig
    from trigenicinteractionpredictor_tpu.train.trainer import fit

    cfg = Config(train=TrainConfig(k=k, sweeps=sweeps, samples=s,
                                   likelihood_freq=sweeps, seed=seed))
    res = fit(cfg, train)
    thetas = np.asarray(res.states.theta)          # [S, G, K]
    ref = thetas[int(np.argmax(np.asarray(res.final_loglik)))]
    acc = np.zeros_like(ref)
    for t in thetas:
        corr = ref.T @ t                           # [K, K] (ref col, t col)
        to_ref = np.full(k, -1)                    # t col -> ref col
        corr_w = corr.copy()
        for _ in range(k):
            a, b = np.unravel_index(np.argmax(corr_w), corr_w.shape)
            to_ref[b] = a
            corr_w[a, :] = -np.inf
            corr_w[:, b] = -np.inf
        aligned = np.empty_like(t)
        aligned[:, to_ref] = t                     # place t cols at ref slots
        acc += aligned
    return np.argmax(acc, axis=1)


def seeded_fit(train, test, labels, g, k, sweeps, s, seed):
    import jax.numpy as jnp
    import numpy as np

    from trigenicinteractionpredictor_tpu.config import Config, TrainConfig
    from trigenicinteractionpredictor_tpu.models.mmsbm import (
        ModelState, init_state,
    )
    from trigenicinteractionpredictor_tpu.ops.metrics import auc
    from trigenicinteractionpredictor_tpu.ops.scoring import (
        ensemble_predict_interaction,
    )
    from trigenicinteractionpredictor_tpu.train.trainer import fit
    import jax

    keys = jax.random.split(jax.random.key(seed), s)
    base = jax.vmap(lambda kk: init_state(kk, g, k, train.n_ratings))(keys)
    theta_seed = np.full((g, k), 0.25 / (k - 1), np.float32)
    theta_seed[np.arange(g), labels] = 0.75
    thetas = np.asarray(base.theta)
    # seed every lane from the partition, jittered so restarts differ
    rng = np.random.default_rng(seed)
    lanes = []
    for i in range(s):
        jit = rng.dirichlet(np.ones(k) * 50, size=g).astype(np.float32)
        lane = 0.8 * theta_seed + 0.2 * jit
        lanes.append(lane / lane.sum(1, keepdims=True))
    init = ModelState(
        theta=jnp.asarray(np.stack(lanes)), p=base.p
    )
    cfg = Config(train=TrainConfig(k=k, sweeps=sweeps, samples=s,
                                   likelihood_freq=100, seed=seed))
    res = fit(cfg, train, init_states=init)
    st = ModelState(theta=np.asarray(res.states.theta),
                    p=np.asarray(res.states.p))
    labels_te = (np.asarray(test.ratings) == 1).astype(np.int32)
    a = float(auc(ensemble_predict_interaction(st, test.triplets),
                  labels_te, test.weights))
    return float(np.max(res.final_loglik)), a


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("-n", type=int, default=20_000)
    ap.add_argument("-g", "--genes", type=int, default=200)
    ap.add_argument("-k", type=int, default=10)
    ap.add_argument("--alpha-theta", type=float, default=0.05)
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--sweeps", type=int, default=300)
    ap.add_argument("--methods", default="unfold,agree")
    args = ap.parse_args()

    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    from trigenicinteractionpredictor_tpu.data.splits import train_test_split
    from trigenicinteractionpredictor_tpu.data.synthetic import (
        sample_synthetic_dataset,
    )

    N, G, K = args.n, args.genes, args.k
    ds, theta_star, p_star = sample_synthetic_dataset(
        N, G, K, alpha_theta=args.alpha_theta, alpha_p=0.3, seed=11
    )
    truth = np.argmax(theta_star, axis=1)
    train, test = train_test_split(ds, 0.2, 0)

    for method in args.methods.split(","):
        purities = []
        for s_i in range(args.seeds):
            if method == "unfold":
                labels = unfold_labels(train, G, K, seed=s_i)
            elif method == "agree":
                labels = agree_labels(train, G, K, s=16, sweeps=120,
                                      seed=s_i)
            else:
                raise ValueError(method)
            purities.append(purity(labels, truth, K))
        best = int(np.argmax(purities))
        rec = {
            "method": method,
            "purity_mean": round(float(np.mean(purities)), 3),
            "purity_best": round(float(np.max(purities)), 3),
            "seeds": args.seeds,
        }
        if max(purities) > 0.3:
            if method == "unfold":
                labels = unfold_labels(train, G, K, seed=best)
            else:
                labels = agree_labels(train, G, K, 16, 120, best)
            ll, a = seeded_fit(train, test, labels, G, K, args.sweeps,
                               s=8, seed=0)
            rec.update(seeded_train_ll=round(ll, 1),
                       seeded_heldout_auc=round(a, 4))
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
