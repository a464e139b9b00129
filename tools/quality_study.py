"""EM-quality study on peaky ground truth.

An earlier hardness study (docs/DESIGN.md §5b) found that on a peaky synthetic
config (generator Dirichlet alpha_theta = 0.05) every plain-EM chain — 50
restarts x 3000 sweeps, three init concentrations — converges ~10k nats
above the ground-truth likelihood with held-out AUC ~0.55 against a Bayes
rate of 0.81.  Oracle parity means the reference's EM does the same; the
brief is match-or-beat, so this script measures the quality knobs
(deterministic annealing, spectral init, perturb-and-resweep)
against plain EM at comparable compute.

Usage:
    python tools/quality_study.py                 # full scale (GPU)
    python tools/quality_study.py --small --cpu   # fast CPU probe

Prints one JSON line per arm and a summary table; docs/DESIGN.md §5b
keeps the findings.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def bayes_auc(theta, p, test_ds, interact_rating=1):
    """AUC of the generating model's own scores — the quality ceiling."""
    import jax.numpy as jnp

    from trigenicinteractionpredictor_tpu.models.mmsbm import ModelState
    from trigenicinteractionpredictor_tpu.ops.metrics import auc
    from trigenicinteractionpredictor_tpu.ops.scoring import predict_interaction

    st = ModelState(
        theta=jnp.asarray(theta, jnp.float32), p=jnp.asarray(p, jnp.float32)
    )
    scores = predict_interaction(st, jnp.asarray(test_ds.triplets))
    labels = jnp.asarray(
        (test_ds.ratings == interact_rating).astype(np.int32)
    )
    return float(auc(scores, labels))


def ground_truth_ll(theta, p, ds):
    import jax.numpy as jnp

    from trigenicinteractionpredictor_tpu.models.mmsbm import ModelState
    from trigenicinteractionpredictor_tpu.ops.em import Batch, log_likelihood

    st = ModelState(
        theta=jnp.asarray(theta, jnp.float32), p=jnp.asarray(p, jnp.float32)
    )
    batch = Batch(
        triplets=jnp.asarray(ds.triplets),
        ratings=jnp.asarray(ds.ratings),
        weights=jnp.asarray(ds.weights),
    )
    return float(log_likelihood(st, batch, row_chunk=16384))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true", help="fast CPU-scale probe")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("-n", type=int, default=0, help="triplets (0 = scale default)")
    ap.add_argument("-g", "--genes", type=int, default=0)
    ap.add_argument("-k", type=int, default=10)
    ap.add_argument("-s", "--samples", type=int, default=10)
    ap.add_argument("-i", "--sweeps", type=int, default=600)
    ap.add_argument("--alpha-theta", type=float, default=0.05)
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--arms", default="plain,anneal,spectral,refine,combo")
    args = ap.parse_args()

    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    from trigenicinteractionpredictor_tpu.config import Config, TrainConfig
    from trigenicinteractionpredictor_tpu.data.splits import train_test_split
    from trigenicinteractionpredictor_tpu.data.synthetic import (
        sample_synthetic_dataset,
    )
    from trigenicinteractionpredictor_tpu.eval import evaluate
    from trigenicinteractionpredictor_tpu.train.trainer import fit

    if args.small:
        N = args.n or 20_000
        G = args.genes or 200
    else:
        N = args.n or 131_072
        G = args.genes or 1000
    K, S, sweeps = args.k, args.samples, args.sweeps

    ds, theta_star, p_star = sample_synthetic_dataset(
        N, G, K, alpha_theta=args.alpha_theta, alpha_p=0.3, seed=args.seed
    )
    train, test = train_test_split(ds, 0.2, 0)
    ceiling = bayes_auc(theta_star, p_star, test)
    gt_ll = ground_truth_ll(theta_star, p_star, train)
    print(
        json.dumps(
            {
                "config": {
                    "n": N,
                    "g": G,
                    "k": K,
                    "s": S,
                    "sweeps": sweeps,
                    "alpha_theta": args.alpha_theta,
                    "seed": args.seed,
                },
                "bayes_auc": round(ceiling, 4),
                "ground_truth_train_ll": round(gt_ll, 1),
            }
        )
    )

    base_train = TrainConfig(
        k=K, sweeps=sweeps, samples=S, likelihood_freq=50, seed=args.seed
    )
    # Comparable compute: every arm runs the same total sweep budget.  The
    # refine arms split it (main fit + rounds); anneal spends half the
    # budget on the ramp.
    arms = {
        "plain": base_train,
        "anneal": dataclasses.replace(
            base_train, anneal_beta0=0.2, anneal_sweeps=sweeps // 2
        ),
        "spectral": dataclasses.replace(base_train, init_method="spectral"),
        "refine": dataclasses.replace(
            base_train,
            sweeps=sweeps // 2,
            refine_rounds=2,
            refine_sweeps=sweeps // 4,
        ),
        "combo": dataclasses.replace(
            base_train,
            sweeps=sweeps // 2,
            anneal_beta0=0.2,
            anneal_sweeps=sweeps // 4,
            init_method="spectral",
            refine_rounds=2,
            refine_sweeps=sweeps // 4,
        ),
    }
    results = {}
    for name in args.arms.split(","):
        tcfg = arms[name]
        cfg = Config(train=tcfg)
        t0 = time.perf_counter()
        res = fit(cfg, train)
        wall = time.perf_counter() - t0
        rep = evaluate(res.states, test, res.final_loglik).to_dict()
        heldout = rep["auc"]
        results[name] = {
            "auc": round(heldout, 4),
            "train_ll_best": round(float(res.final_loglik.max()), 1),
            "gap_to_gt_ll": round(gt_ll - float(res.final_loglik.max()), 1),
            "sweeps": res.sweeps_run,
            "wall_s": round(wall, 1),
        }
        print(json.dumps({"arm": name, **results[name]}))

    print("\n| arm | held-out AUC | train L best | L gap to truth | sweeps | wall s |")
    print("|---|---|---|---|---|---|")
    for name, r in results.items():
        print(
            f"| {name} | {r['auc']} | {r['train_ll_best']} | "
            f"{r['gap_to_gt_ll']} | {r['sweeps']} | {r['wall_s']} |"
        )
    print(f"\nBayes AUC ceiling: {ceiling:.4f}; ground-truth train L {gt_ll:.1f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
