"""Time-to-converged-held-out-AUC — the second half of the north-star
metric (BASELINE.json:2: "EM triplets/sec/chip + time-to-converged held-out
AUC on the trigenic test set").

bench.py measures raw sweep throughput; this harness measures how fast the
production path turns that throughput into QUALITY: post-compile wall
seconds of training until the ensemble held-out AUC is within ``tol`` of
its converged value.  A sweep that got faster but (say) broke the restart
batching or the normalize tail would pass the throughput gate and fail
this one.  Runs on the GPU and refuses to run without one.

Workload: synthetic Kuzmin-scale ground truth (N=131072, G=1000, K=10,
S=10 restarts — the reference's default job shape, same as bench.py) with
an 80/20 held-out split; training runs through the SAME production sharded
step ``fit()`` uses.  Timing covers dispatch + device compute + the
likelihood sync; the per-check AUC evaluation runs OUTSIDE the timer (the
reference evaluates in a separate pass too — SURVEY.md §4.4).

Prints ONE JSON line:
    {"metric": "seconds_to_converged_auc", "value": t, "unit": "s", ...}
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

N = 131072
G = 1000
K = 10
R = 2
S = 10
FREQ = 10          # sweeps per check — the trainer's likelihood_freq default
MAX_SWEEPS = 300
TOL = 0.005


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-n", type=int, default=N)
    ap.add_argument("-g", "--genes", type=int, default=G)
    ap.add_argument("-k", type=int, default=K)
    ap.add_argument("-s", "--samples", type=int, default=S)
    ap.add_argument("--max-sweeps", type=int, default=MAX_SWEEPS)
    ap.add_argument("--freq", type=int, default=FREQ)
    ap.add_argument("--tol", type=float, default=TOL)
    ap.add_argument(
        "--seed", type=int, default=0,
        help="restart-init seed (data stays seed=0, so seed sweeps measure "
        "EM plateau noise on a FIXED dataset)",
    )
    ap.add_argument(
        "--alpha", type=float, default=0.2,
        help="generator Dirichlet concentration.  NOTE: every alpha/G "
        "combination at the N=131k production shape sits at or past the "
        "MMSBM detection threshold (Bayes AUC 0.55-0.62, EM plateau "
        "0.50-0.53 for alpha in {0.2, 0.5}, G in {200, 300, 1000}; "
        "docs/DESIGN.md §5b), so auc_final is a parity-tracking number, "
        "not a Bayes-recovery target; the metric gates (a) seconds to "
        "reach the plateau and (b) the plateau value itself.",
    )
    return ap.parse_args(argv)


def main() -> None:
    args = parse_args()
    import jax
    import jax.numpy as jnp

    from trigenicinteractionpredictor_tpu.utils.compile_cache import (
        enable_compile_cache,
    )
    from trigenicinteractionpredictor_tpu.utils.device import (
        gpu_name_and_power_limit,
        require_gpu,
    )

    enable_compile_cache()
    device = require_gpu()
    log(f"device: {device}; card: {gpu_name_and_power_limit()}")

    from trigenicinteractionpredictor_tpu.data.splits import train_test_split
    from trigenicinteractionpredictor_tpu.data.synthetic import (
        sample_synthetic_dataset,
    )
    from trigenicinteractionpredictor_tpu.eval import evaluate
    from trigenicinteractionpredictor_tpu.models.mmsbm import ModelState, init_state
    from trigenicinteractionpredictor_tpu.ops.em import Batch
    from trigenicinteractionpredictor_tpu.ops.metrics import auc
    from trigenicinteractionpredictor_tpu.ops.scoring import (
        ensemble_predict_interaction,
    )
    from trigenicinteractionpredictor_tpu.parallel.mesh import single_device_mesh
    from trigenicinteractionpredictor_tpu.parallel.sharded_em import (
        make_sharded_multi_step,
        replicate,
        shard_batch,
        shard_ensemble,
    )

    n, g, k, s = args.n, args.genes, args.k, args.samples
    ds, theta_star, p_star = sample_synthetic_dataset(
        n, g, k, n_ratings=R, alpha_theta=args.alpha, alpha_p=args.alpha,
        seed=0,
    )
    train, test = train_test_split(ds, 0.2, seed=0)
    mesh = single_device_mesh()

    train = train.pad_to(512)
    raw = Batch(
        triplets=jnp.asarray(train.triplets),
        ratings=jnp.asarray(train.ratings),
        weights=jnp.asarray(train.weights),
    )
    batch = shard_batch(mesh, raw)
    degrees = replicate(mesh, jnp.asarray(train.degrees()))
    step = make_sharded_multi_step(mesh, args.freq)

    keys = jax.random.split(jax.random.key(args.seed), s)
    states0 = shard_ensemble(
        mesh, jax.vmap(lambda kk: init_state(kk, g, k, R))(keys)
    )
    trips_te = jnp.asarray(test.triplets)
    labels_te = jnp.asarray((test.ratings == 1).astype(np.int32))
    w_te = jnp.asarray(test.weights)

    def check_auc(states) -> float:
        st = ModelState(
            theta=jnp.asarray(states.theta), p=jnp.asarray(states.p)
        )
        return float(auc(ensemble_predict_interaction(st, trips_te), labels_te, w_te))

    # Untimed compile pass: one training dispatch + one AUC evaluation.
    t0 = time.perf_counter()
    st_c, ll = step(states0, batch, degrees)
    jax.block_until_ready(ll)
    _ = check_auc(st_c)
    log(f"compile pass: {time.perf_counter() - t0:.1f}s")

    # Bayes ceiling for context (the generating model's own ensemble AUC).
    bayes = float(
        auc(
            ensemble_predict_interaction(
                ModelState(
                    theta=jnp.asarray(theta_star[None]),
                    p=jnp.asarray(p_star[None]),
                ),
                trips_te,
            ),
            labels_te,
            w_te,
        )
    )

    states = states0
    t_train = 0.0
    history = []  # (cumulative train seconds, sweeps, ensemble AUC)
    final_ll = None
    for chk in range(args.max_sweeps // args.freq):
        t0 = time.perf_counter()
        states, ll = step(states, batch, degrees)
        ll_last = np.asarray(ll[-1])       # scalar fetch = the sync point
        t_train += time.perf_counter() - t0
        a = check_auc(states)              # outside the timer
        history.append((t_train, (chk + 1) * args.freq, a))
        final_ll = ll_last
    auc_final = history[-1][2]
    t_conv, sweeps_conv = next(
        (t, sw) for t, sw, a in history if a >= auc_final - args.tol
    )
    for t, sw, a in history:
        log(f"  t={t:7.3f}s sweeps={sw:4d} ensemble_auc={a:.4f}")
    log(
        f"converged AUC {auc_final:.4f} (Bayes {bayes:.4f}); within "
        f"{args.tol} after {sweeps_conv} sweeps / {t_conv:.3f}s post-compile"
    )
    report = evaluate(
        ModelState(
            theta=np.asarray(states.theta), p=np.asarray(states.p)
        ),
        test,
        np.asarray(final_ll, dtype=np.float64),
    )
    log(f"final evaluate(): auc={report.auc:.4f} best={report.best_sample_auc:.4f}")

    print(
        json.dumps(
            {
                "metric": "seconds_to_converged_auc",
                "value": round(t_conv, 3),
                "unit": "s",
                "auc_final": round(auc_final, 4),
                "auc_bayes": round(bayes, 4),
                "sweeps_to_converged": sweeps_conv,
                # Warm seconds per sweep over the whole run (compile
                # excluded).
                "seconds_per_sweep": round(
                    t_train / max(history[-1][1], 1), 5
                ),
                "shape": {"n": n, "g": g, "k": k, "s": s, "alpha": args.alpha,
                          "seed": args.seed},
                "device": device,
            }
        )
    )


if __name__ == "__main__":
    main()
