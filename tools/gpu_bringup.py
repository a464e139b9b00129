"""Bring-up measurements of the EM sweep and the scorer on the GPU.

    python tools/gpu_bringup.py [--out runs/gpu_bringup.json]

Three measurements at the headline shape (N = 131072 triplets, G = 1000,
K = 10, S = 10 restarts, R = 2), one process, one card:

1. sweep:  a ``jax.profiler`` trace of ten sweeps of the production step
   (``make_sharded_multi_step``, the step ``fit()`` runs), reduced to the
   sweep time, the device's busy share of the window, the top device ops
   and their share of busy time, and the bytes the sweep moves per
   restart-row (counted from ops/em.py's materialized arrays,
   ``sweep_bytes_per_restart_row``) as a fraction of the card's 3.35 TB/s.
2. scatter: the theta scatter as ``segment_sum`` (the engine's) against the
   per-position one-hot matmul it replaced, per sweep at G = 1000.
3. race:   client-side scoring of 2^20 numpy triplets through
   ``serve_predict_interaction``, the fused Triton kernel against the
   restart-batched XLA scorer, at G = 1000 and G = 100000; five timed runs
   each after a warm-up, in the order plain, kernel, kernel, plain; median.
   Beside it, the two scorers alone on device-resident triplets (ten
   alternating runs each, median).

Refuses to run without a GPU.  Prints one JSON line per measurement and
writes them all to ``--out``.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import tempfile
import time
from unittest import mock

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

N, G, K, R, S = 131072, 1000, 10, 2, 10
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet


def device_op_times(pd) -> dict:
    """Per-op device time from a trace (a ``jax.profiler.ProfileData``):
    {name: ns}, plus the busy union and the window, over the first GPU
    plane's op events."""
    planes = [p for p in pd.planes if p.name.startswith("/device:GPU")]
    if not planes:
        raise RuntimeError("trace has no GPU plane")
    plane = sorted(planes, key=lambda p: p.name)[0]
    lines = list(plane.lines)
    ops = [ln for ln in lines if ln.name == "XLA Ops"] or [
        ln for ln in lines if ln.name not in ("XLA Modules", "Steps")
    ]
    per_op: dict = {}
    spans = []
    for ln in ops:
        for ev in ln.events:
            per_op[ev.name] = per_op.get(ev.name, 0.0) + ev.duration_ns
            spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    spans.sort()
    busy, end = 0.0, -1.0
    lo = spans[0][0] if spans else 0.0
    hi = max((b for _, b in spans), default=0.0)
    for a, b in spans:
        if b <= end:
            continue
        busy += b - max(a, end)
        end = b
    return {"per_op_ns": per_op, "busy_ns": busy, "window_ns": hi - lo,
            "plane": plane.name, "lines": [ln.name for ln in lines]}


def sweep_bytes_per_restart_row(k: int, r: int) -> int:
    """Device-memory bytes one trigenic restart-row costs in a sweep of
    ops/em.py, counting each array the optimization barriers materialize
    as written once and read as often as the algebra reads it (f32):
    gathered th1..3 (gather read + write + read: 9K), T_all (2K^2 R),
    T (write + 2 reads: 3K^2), A1, A2, A3, D (2(3K+1)), W (2K^2),
    V = W * scale (3K^2), A3_all (2KR), s1..3 (6K), th3r (2KR)."""
    floats = 8 * k * k + 2 * k * k * r + 21 * k + 4 * k * r + 2
    return 4 * floats


def _headline():
    import jax
    import jax.numpy as jnp

    from trigenicinteractionpredictor_tpu.data.synthetic import (
        sample_synthetic_dataset,
    )
    from trigenicinteractionpredictor_tpu.models.mmsbm import init_state
    from trigenicinteractionpredictor_tpu.ops.em import Batch
    from trigenicinteractionpredictor_tpu.parallel.mesh import single_device_mesh
    from trigenicinteractionpredictor_tpu.parallel.sharded_em import (
        replicate,
        shard_batch,
        shard_ensemble,
    )

    ds, _, _ = sample_synthetic_dataset(N, G, K, n_ratings=R, seed=0)
    mesh = single_device_mesh()
    batch = shard_batch(mesh, Batch(jnp.asarray(ds.triplets),
                                    jnp.asarray(ds.ratings),
                                    jnp.asarray(ds.weights)))
    deg = replicate(mesh, jnp.asarray(ds.degrees()))
    states = shard_ensemble(mesh, jax.vmap(lambda k: init_state(k, G, K, R))(
        jax.random.split(jax.random.key(0), S)))
    return mesh, batch, deg, states


def _fit_stats_fn():
    """The statistics function fit() uses: row-chunked at the default."""
    import functools

    from trigenicinteractionpredictor_tpu.config import EngineConfig
    from trigenicinteractionpredictor_tpu.ops.em import em_sufficient_stats

    return functools.partial(
        em_sufficient_stats, row_chunk=EngineConfig().jnp_row_chunk
    )


def _time_steps(step, states, batch, deg, chunks=3, reps=3):
    import jax

    out = step(states, batch, deg)
    jax.block_until_ready(out)
    best = float("inf")
    for _ in range(reps):
        st = states
        t0 = time.perf_counter()
        for _ in range(chunks):
            st, ll = step(st, batch, deg)
        jax.block_until_ready(ll)
        best = min(best, time.perf_counter() - t0)
    return best


def measure_sweep(tmp: str) -> dict:
    import jax
    from jax.profiler import ProfileData

    from trigenicinteractionpredictor_tpu.parallel.sharded_em import (
        make_sharded_multi_step,
    )

    mesh, batch, deg, states = _headline()
    step = make_sharded_multi_step(mesh, 10, stats_fn=_fit_stats_fn())
    sec = _time_steps(step, states, batch, deg) / 30
    trace_dir = os.path.join(tmp, "trace")
    jax.profiler.start_trace(trace_dir)
    st, ll = step(states, batch, deg)
    jax.block_until_ready(ll)
    jax.profiler.stop_trace()
    xp = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"), recursive=True)
    red = device_op_times(ProfileData.from_file(xp[0]))
    top = sorted(red["per_op_ns"].items(), key=lambda kv: -kv[1])[:12]
    per_row = sweep_bytes_per_restart_row(K, R)
    return {
        "what": "sweep",
        "sweep_ms": sec * 1e3,
        "restart_triplet_updates_per_s": N * S / sec,
        "trace_window_ms": red["window_ns"] / 1e6,
        "device_busy_share": red["busy_ns"] / max(red["window_ns"], 1.0),
        "top_ops": [(n, ns / 1e6, ns / max(red["busy_ns"], 1.0)) for n, ns in top],
        "bytes_per_restart_row": per_row,
        "hbm_share_of_3.35TB/s": per_row * N * S / sec / HBM_BYTES_PER_S,
        "trace_lines": red["lines"],
    }


def measure_scatter() -> dict:
    import jax
    import jax.numpy as jnp

    from trigenicinteractionpredictor_tpu.ops import em
    from trigenicinteractionpredictor_tpu.parallel.sharded_em import (
        make_sharded_multi_step,
    )

    def onehot_scatter(vals, triplets, n_segments):
        acc = None
        for pos in range(len(vals)):
            oh = jax.nn.one_hot(triplets[:, pos], n_segments, dtype=vals[pos].dtype)
            term = jnp.matmul(oh.T, vals[pos], precision=jax.lax.Precision.DEFAULT)
            acc = term if acc is None else acc + term
        return acc

    mesh, batch, deg, states = _headline()
    out = {"what": "scatter", "G": G}
    seg = make_sharded_multi_step(mesh, 10, stats_fn=_fit_stats_fn())
    out["segment_sum_sweep_ms"] = _time_steps(seg, states, batch, deg) / 30 * 1e3
    with mock.patch.object(em, "_scatter_add_rows", onehot_scatter):
        oh = make_sharded_multi_step(mesh, 10, stats_fn=_fit_stats_fn())
        out["onehot_sweep_ms"] = _time_steps(oh, states, batch, deg) / 30 * 1e3
    out["segment_sum_sweep_ms_again"] = _time_steps(seg, states, batch, deg) / 30 * 1e3
    return out


def _device_medians(fns: dict, reps: int = 10) -> dict:
    """Median ms per call of device-resident scorers, warm, in turns."""
    import jax

    runs = {name: [] for name in fns}
    for fn in fns.values():
        jax.block_until_ready(fn())
    for _ in range(reps):
        for name, fn in fns.items():
            t0 = time.perf_counter()
            jax.block_until_ready(fn())
            runs[name].append(time.perf_counter() - t0)
    return {name: float(np.median(v)) * 1e3 for name, v in runs.items()}


def measure_race(rows: int = 1 << 20) -> list:
    import jax
    import jax.numpy as jnp

    from trigenicinteractionpredictor_tpu.models.mmsbm import init_state
    from trigenicinteractionpredictor_tpu.ops import pallas_score
    from trigenicinteractionpredictor_tpu.ops.scoring import (
        ensemble_predict_interaction_batched,
        serve_predict_interaction,
    )

    res = []
    for g in (1000, 100_000):
        states = jax.vmap(lambda k: init_state(k, g, K, R))(
            jax.random.split(jax.random.key(0), S))
        trips = np.random.default_rng(0).integers(0, g, size=(rows, 3)).astype(np.int32)

        def plain():
            with mock.patch.object(pallas_score, "score_kernel_applies",
                                   lambda *a: False):
                return serve_predict_interaction(states, trips)

        def kernel():
            return serve_predict_interaction(states, trips)

        runs = {"plain": [], "kernel": []}
        outs = {"plain": plain(), "kernel": kernel()}       # warm-up
        for name in ("plain", "kernel", "kernel", "plain"):
            fn = plain if name == "plain" else kernel
            for _ in range(5):
                t0 = time.perf_counter()
                fn()
                runs[name].append(time.perf_counter() - t0)
        med = {k: float(np.median(v)) for k, v in runs.items()}
        # The scorers alone: triplets already on the card, scores left there.
        trips_dev = jnp.asarray(trips)
        plain_jit = jax.jit(ensemble_predict_interaction_batched)
        dev_ms = _device_medians({
            "plain": lambda: plain_jit(states, trips_dev),
            "kernel": lambda: pallas_score.triton_ensemble_predict_interaction(
                states, trips_dev),
        })
        res.append({
            "what": "scorer_race", "G": g, "S": S, "K": K, "rows": rows,
            "plain_ms_median": med["plain"] * 1e3,
            "kernel_ms_median": med["kernel"] * 1e3,
            "plain_rows_per_s": rows / med["plain"],
            "kernel_rows_per_s": rows / med["kernel"],
            "runs_ms": {k: [x * 1e3 for x in v] for k, v in runs.items()},
            "device_resident_ms_median": dev_ms,
            "max_abs_diff": float(np.abs(outs["plain"] - outs["kernel"]).max()),
        })
    return res


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(REPO, "runs", "gpu_bringup.json"))
    args = ap.parse_args()

    from trigenicinteractionpredictor_tpu.utils.compile_cache import (
        enable_compile_cache,
    )
    from trigenicinteractionpredictor_tpu.utils.device import (
        gpu_name_and_power_limit,
        require_gpu,
    )

    enable_compile_cache()
    device = require_gpu()
    card = gpu_name_and_power_limit()
    records = [{"what": "device", **device, "card": card}]
    print(json.dumps(records[0]), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        for rec in [measure_sweep(tmp), measure_scatter(), *measure_race()]:
            rec["card"] = card
            records.append(rec)
            print(json.dumps(rec), flush=True)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(records, fh, indent=1)


if __name__ == "__main__":
    main()
