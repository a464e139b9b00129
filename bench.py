"""Headline benchmark: EM restart-triplet updates/sec/chip at Kuzmin scale.

Runs on the GPU and refuses to run without one.  Prints ONE JSON line:
    {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, "device": {...}}

- Workload: the reference's own default job shape — S=10 random restarts
  over a synthetic triplet list at Kuzmin scale (N=131072 ~ 1e5 usable
  trigenic triplets, G=1000 genes, K=10, R=2 — SURVEY.md §1.3, §4.1
  ``-s 10``), resident in HBM; one full fused ensemble EM sweep per step
  (E + M + normalize + likelihood for all 10 restarts), via the SAME
  production path ``fit()`` uses (the sharded step over ops/em.py).
- Unit: one "triplet" = one (triplet, restart) EM update — the same unit
  of work the pure-Python reference performs once per inner-loop pass of
  its serial ``for sample in range(S)`` driver, so the ratio is
  apples-to-apples.
- vs_baseline: measured against the reference-shaped pure-Python EM
  (baselines/python_reference.py) on this host — the reference publishes no
  numbers, so the stand-in is measured fresh each run.

Extra context (device, card name and power limit, single-restart
throughput, sweep wall time, baseline throughput) goes to stderr so stdout
stays a single JSON line.
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
sys.path.insert(0, os.path.join(REPO, "baselines"))

N = 131072
G = 1000
K = 10
R = 2
S = 10       # restarts — the reference CLI's default ``-s 10`` (SURVEY.md §4.1)
SWEEPS = 120


def parse_args(argv=None) -> argparse.Namespace:
    """Workload knobs (defaults = the headline Kuzmin-scale shape).

    Non-default shapes are experiments: the JSON line marks them with the
    chosen shape so a driver-recorded BENCH file is never silently
    off-workload.
    """
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-n", type=int, default=N, help="triplets")
    ap.add_argument("-g", "--genes", type=int, default=G)
    ap.add_argument("-k", type=int, default=K)
    ap.add_argument("-s", "--samples", type=int, default=S)
    ap.add_argument("--sweeps", type=int, default=SWEEPS)
    ap.add_argument(
        "--warm-only", action="store_true",
        help="compile every step (seeding the persistent cache) and exit "
        "without timing — lets callers split compile latency from the "
        "throughput measurement",
    )
    ap.add_argument(
        "--serve", action="store_true",
        help="measure the SERVING path instead: client-side scored rows/s "
        "through serve_predict_interaction (numpy triplets in, numpy "
        "scores out); prints its own JSON metric line",
    )
    return ap.parse_args(argv)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _setup():
    """Compile cache, then the device: refuses to go on without a GPU."""
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
    return device


def measure_engine(args) -> float:
    N, G, K, S, SWEEPS = args.n, args.genes, args.k, args.samples, args.sweeps
    import jax
    import jax.numpy as jnp

    from trigenicinteractionpredictor_tpu.data.synthetic import (
        sample_synthetic_dataset,
    )
    from trigenicinteractionpredictor_tpu.models.mmsbm import init_state
    from trigenicinteractionpredictor_tpu.ops.em import Batch
    from trigenicinteractionpredictor_tpu.parallel.mesh import single_device_mesh
    from trigenicinteractionpredictor_tpu.parallel.sharded_em import (
        make_sharded_multi_step,
        replicate,
        shard_batch,
        shard_ensemble,
    )

    ds, _, _ = sample_synthetic_dataset(N, G, K, n_ratings=R, seed=0)
    mesh = single_device_mesh()
    batch = shard_batch(
        mesh,
        Batch(
            triplets=jnp.asarray(ds.triplets),
            ratings=jnp.asarray(ds.ratings),
            weights=jnp.asarray(ds.weights),
        ),
    )
    degrees = replicate(mesh, jnp.asarray(ds.degrees()))

    # The production step fit() runs: ensemble-stacked states, psum'd stats,
    # likelihood_freq (=10) sweeps scanned device-side per dispatch.
    chunk = 10
    step = make_sharded_multi_step(mesh, chunk)

    def run(n_samples: int, reps: int = 3) -> float:
        keys = jax.random.split(jax.random.key(0), n_samples)
        states0 = shard_ensemble(
            mesh, jax.vmap(lambda k: init_state(k, G, K, R))(keys)
        )
        t0 = time.perf_counter()
        states, ll_hist = step(states0, batch, degrees)
        jax.block_until_ready(ll_hist)
        log(f"S={n_samples} first step (compile+run): {time.perf_counter() - t0:.1f}s")
        if args.warm_only:
            return 0.0

        # Timed: SWEEPS chained ensemble EM sweeps, best of ``reps``.
        best_dt, ll_best = float("inf"), 0.0
        for _ in range(reps):
            states = states0
            t0 = time.perf_counter()
            for _ in range(SWEEPS // chunk):
                states, ll_hist = step(states, batch, degrees)
            jax.block_until_ready(ll_hist)
            best_dt = min(best_dt, time.perf_counter() - t0)
            ll_best = float(jnp.max(ll_hist[-1]))
        tps = SWEEPS * N * n_samples / best_dt
        log(
            f"engine: {SWEEPS} sweeps x {N} triplets x {n_samples} restarts"
            f" in {best_dt:.3f}s (best of {reps})"
            f" -> {tps:,.0f} restart-triplet updates/s (best L={ll_best:,.0f})"
        )
        return tps

    run(1)        # single-restart datapoint (stderr)
    return run(S)  # headline: the reference's own default job shape


def measure_baseline(args) -> float:
    from python_reference import measure_triplets_per_sec

    # Best of 3: host load varies 3-4x run to run, and an understated
    # baseline would overstate vs_baseline.
    tps = max(
        measure_triplets_per_sec(
            n_triplets=200, n_genes=args.genes, k=args.k, n_ratings=R,
            min_seconds=1.5,
        )
        for _ in range(3)
    )
    log(f"pure-Python reference-shaped EM: {tps:,.0f} triplets/s (1 CPU core, best of 3)")
    return tps


def measure_serving(args, device) -> None:
    """Client-side scored rows/s: numpy triplets in, numpy scores out,
    through ``serve_predict_interaction`` (the ``predict`` path)."""
    import jax

    from trigenicinteractionpredictor_tpu.data.synthetic import (
        sample_synthetic_dataset,
    )
    from trigenicinteractionpredictor_tpu.models.mmsbm import init_state
    from trigenicinteractionpredictor_tpu.ops.scoring import (
        serve_predict_interaction,
    )

    n, g, k, s = args.n, args.genes, args.k, args.samples
    ds, _, _ = sample_synthetic_dataset(n, g, k, n_ratings=R, seed=0)
    keys = jax.random.split(jax.random.key(0), s)
    states = jax.vmap(lambda kk: init_state(kk, g, k, R))(keys)
    trips = ds.triplets
    serve_predict_interaction(states, trips)          # compile + warm
    if args.warm_only:
        print(json.dumps({"metric": "warm_only", "value": 1, "unit": "cache"}))
        return
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        serve_predict_interaction(states, trips)
        times.append(time.perf_counter() - t0)
    med = float(np.median(times))
    rows = n / med
    log(f"serving: {n} rows x {s} restarts in {med*1e3:.2f} ms (median of 5) "
        f"-> {rows:,.0f} rows/s, client-side")
    print(
        json.dumps(
            {
                "metric": "ensemble_serving_rows_per_sec",
                "value": round(rows, 1),
                "unit": "rows/s",
                "shape": {"n": n, "g": g, "k": k, "s": s},
                "device": device,
            }
        )
    )


def main() -> None:
    args = parse_args()
    device = _setup()
    if args.serve:
        measure_serving(args, device)
        return
    engine_tps = measure_engine(args)
    if args.warm_only:
        print(json.dumps({"metric": "warm_only", "value": 1, "unit": "cache"}))
        return
    baseline_tps = measure_baseline(args)
    result = {
        "metric": "em_restart_triplet_updates_per_sec",
        "value": round(engine_tps, 1),
        "unit": "triplets/s",
        "vs_baseline": round(engine_tps / baseline_tps, 1),
        "device": device,
    }
    if (args.n, args.genes, args.k, args.samples) != (N, G, K, S):
        result["shape"] = {
            "n": args.n, "g": args.genes, "k": args.k, "s": args.samples,
        }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
