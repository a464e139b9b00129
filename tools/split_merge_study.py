"""Split-merge EM study on the peaky config.

The EM quality study (docs/DESIGN.md §5b) exhausted the
standard cold-start arsenal — annealing, sharpening, spectral/moment init,
perturb-resweep, progressive splitting, CEM/Gibbs, consensus — and every
arm landed ~1000 nats above the deep basin at held-out AUC ~0.51.  This
harness measures the one listed mitigation that table lacked:
split-merge EM (Ueda et al. 2000; proposal move now shipped as
``TrainConfig.smem_rounds`` via models/proposals.py).  Unlike annealing
(which smooths the landscape) or restarts (which resample the same shallow
basins), split-merge makes *structured* jumps between basins of different
group topology — the known fix for EM's tendency to starve one component
while doubling another.  Measured outcome (docs/DESIGN.md §5b): best
train likelihood of any cold-start method tested, no held-out AUC gain on
the peaky config.

The candidate resweeps ride the restart ensemble
(``fit(init_states=...)``), so one SMEM round costs one ordinary fit call.

Usage:
    python tools/split_merge_study.py --small --cpu   # CPU-scale probe
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from quality_study import bayes_auc, ground_truth_ll  # noqa: E402  (sibling tool)


# The proposal move itself ships in the package (models/proposals.py,
# behind TrainConfig.smem_rounds); this tool is the measurement harness.


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("-n", type=int, default=0)
    ap.add_argument("-g", "--genes", type=int, default=0)
    ap.add_argument("-k", type=int, default=10)
    ap.add_argument("-s", "--samples", type=int, default=10)
    ap.add_argument("-i", "--sweeps", type=int, default=300, help="initial fit")
    ap.add_argument("--rounds", type=int, default=6, help="SMEM rounds")
    ap.add_argument("--cands", type=int, default=10, help="proposals per round")
    ap.add_argument("--resweep", type=int, default=100, help="sweeps per proposal")
    ap.add_argument("--alpha-theta", type=float, default=0.05)
    ap.add_argument("--seed", type=int, default=11)
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
    from trigenicinteractionpredictor_tpu.models.mmsbm import ModelState
    from trigenicinteractionpredictor_tpu.models.proposals import (
        merge_split_candidate,
    )
    from trigenicinteractionpredictor_tpu.train.trainer import fit

    N = args.n or (20_000 if args.small else 131_072)
    G = args.genes or (200 if args.small else 1000)
    K, S = args.k, args.samples

    ds, theta_star, p_star = sample_synthetic_dataset(
        N, G, K, alpha_theta=args.alpha_theta, alpha_p=0.3, seed=args.seed
    )
    train, test = train_test_split(ds, 0.2, 0)
    ceiling = bayes_auc(theta_star, p_star, test)
    gt_ll = ground_truth_ll(theta_star, p_star, train)
    print(
        json.dumps(
            {
                "config": {"n": N, "g": G, "k": K, "s": S, "seed": args.seed},
                "bayes_auc": round(ceiling, 4),
                "ground_truth_train_ll": round(gt_ll, 1),
            }
        )
    )

    rng = np.random.default_rng(args.seed + 1)
    t0 = time.perf_counter()
    cfg0 = Config(
        train=TrainConfig(
            k=K, sweeps=args.sweeps, samples=S, likelihood_freq=50, seed=args.seed
        )
    )
    res = fit(cfg0, train)
    best_ll = float(res.final_loglik.max())
    best = res.best_state()
    theta = np.asarray(best.theta, np.float64)
    p = np.asarray(best.p, np.float64)
    rep = evaluate(res.states, test, res.final_loglik).to_dict()
    print(
        json.dumps(
            {"arm": "plain", "train_ll_best": round(best_ll, 1),
             "auc": round(rep["auc"], 4)}
        )
    )

    total_extra = 0
    cfg_re = Config(
        train=TrainConfig(
            k=K, sweeps=args.resweep, samples=args.cands,
            likelihood_freq=args.resweep, seed=args.seed,
        )
    )
    accepted = 0
    for rnd in range(args.rounds):
        thetas, ps, moves = [], [], []
        for _ in range(args.cands):
            th_c, p_c, mv = merge_split_candidate(theta, p, rng)
            thetas.append(th_c)
            ps.append(p_c)
            moves.append(mv)
        init = ModelState(
            theta=np.stack(thetas).astype(np.float32),
            p=np.stack(ps).astype(np.float32),
        )
        res_c = fit(cfg_re, train, init_states=init)
        total_extra += args.resweep
        i = int(np.argmax(res_c.final_loglik))
        cand_ll = float(res_c.final_loglik[i])
        took = cand_ll > best_ll + 1e-6
        print(
            json.dumps(
                {
                    "round": rnd,
                    "best_move": list(map(int, moves[i])),
                    "cand_ll": round(cand_ll, 1),
                    "cur_ll": round(best_ll, 1),
                    "accepted": took,
                }
            )
        )
        if took:
            accepted += 1
            best_ll = cand_ll
            theta = np.asarray(res_c.states.theta[i], np.float64)
            p = np.asarray(res_c.states.p[i], np.float64)

    final = ModelState(
        theta=np.asarray(theta, np.float32)[None],
        p=np.asarray(p, np.float32)[None],
    )
    rep_sm = evaluate(final, test, np.asarray([best_ll])).to_dict()
    print(
        json.dumps(
            {
                "arm": "split_merge",
                "train_ll_best": round(best_ll, 1),
                "gap_to_gt_ll": round(gt_ll - best_ll, 1),
                "auc": round(rep_sm["auc"], 4),
                "rounds_accepted": accepted,
                "extra_sweeps": total_extra * args.cands,
                "wall_s": round(time.perf_counter() - t0, 1),
            }
        )
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
