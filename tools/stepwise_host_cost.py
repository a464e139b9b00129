"""Measure the stepwise (beyond-HBM) path's per-epoch HOST cost at scale.

The streaming stepwise trainer preps every minibatch on the host each
epoch: the (seed, epoch) permutation and the row gather
(train/stream_prep.py), in-thread or through a spawn-process pool.  This
tool times both pipelines on a synthetic memmapped dataset and prints one
JSON line per pipeline.  The in-thread pipeline needs no device; the pool
pipeline ends in ``device_put`` to the default device.  Compare the host
seconds with the device's epoch time from a trace of the same shape
(not measured here).

Usage: python tools/stepwise_host_cost.py [--n 10000000] [--mb 131072]
       [--workers N]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
import types

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

def _report(tag, N, detail, host_total):
    print(json.dumps({
        "pipeline": tag,
        **detail,
        "host_total_s": round(host_total, 2),
        "host_rows_per_s": round(N / host_total),
    }), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--n", type=int, default=10_000_000)
    ap.add_argument("--genes", type=int, default=2000)
    ap.add_argument("--mb", type=int, default=131072)
    ap.add_argument("--group", type=int, default=8, help="stream_groups")
    ap.add_argument("--ratings", type=int, default=2)
    ap.add_argument("--workers", type=int, default=0,
                    help="pool size for the pooled pipeline (0 = cpu-1)")
    args = ap.parse_args()

    from trigenicinteractionpredictor_tpu.train.stream_prep import (
        StreamPrep,
        _prep_minibatches,
        epoch_perm,
    )

    N, mb, group, R = args.n, args.mb, args.group, args.ratings
    rng = np.random.default_rng(0)
    with tempfile.TemporaryDirectory() as td:
        # Synthetic packed memmap store (the beyond-HBM layout), written
        # as .npy files so pool workers can reopen them by path.
        shape_map = {"triplets": (N, 3), "ratings": (N,), "weights": (N,)}
        paths = {k: os.path.join(td, f"{k}.npy") for k in shape_map}
        # Write .npy headers + data in chunks via open_memmap.
        from numpy.lib.format import open_memmap

        trip_mm = open_memmap(paths["triplets"], mode="w+", dtype=np.int32,
                              shape=(N, 3))
        rat_mm = open_memmap(paths["ratings"], mode="w+", dtype=np.int32,
                             shape=(N,))
        wts_mm = open_memmap(paths["weights"], mode="w+", dtype=np.float32,
                             shape=(N,))
        chunk = 4_000_000
        for lo in range(0, N, chunk):
            hi = min(lo + chunk, N)
            trip_mm[lo:hi] = rng.integers(
                0, args.genes, size=(hi - lo, 3), dtype=np.int32
            )
            rat_mm[lo:hi] = rng.integers(0, R, size=hi - lo, dtype=np.int32)
            wts_mm[lo:hi] = 1.0
        trip_mm.flush(); rat_mm.flush(); wts_mm.flush()
        # Reopen read-only (memmap with .filename, like load_dir(mmap=True))
        trip_mm = np.load(paths["triplets"], mmap_mode="r")
        rat_mm = np.load(paths["ratings"], mmap_mode="r")
        wts_mm = np.load(paths["weights"], mmap_mode="r")

        n_padded = -(-N // mb) * mb
        n_mb = n_padded // mb
        while n_mb % group:       # mirror trainer: largest divisor <= req
            group -= 1
        n_dispatch = n_mb // group
        layout = {
            "seed": 1, "n": N, "n_padded": n_padded, "mb": mb,
            "group": group, "arity": 3,
        }
        detail = {"n": N, "mb": mb, "group": group}

        # --- in-thread pipeline (int32 perm + gather) --------------------
        ds_arrays = (trip_mm, rat_mm, wts_mm)
        t0 = time.perf_counter()
        perm5 = epoch_perm(1, 0, n_padded)
        for d in range(n_dispatch):
            _prep_minibatches(
                ds_arrays, layout,
                perm5[d * group * mb : (d + 1) * group * mb],
            )
        t_inthread = time.perf_counter() - t0
        _report("inthread", N, detail, t_inthread)

        # --- pooled pipeline ---------------------------------------------
        workers = args.workers or max(1, (os.cpu_count() or 2) - 1)
        if workers >= 2:
            ds_obj = types.SimpleNamespace(
                triplets=trip_mm, ratings=rat_mm, weights=wts_mm
            )
            sp = StreamPrep(ds_obj, layout, sharding=None, workers=workers)
            try:
                if sp._pool is None:
                    print(json.dumps({"pipeline": f"pooled-{workers}",
                                      "error": "pool failed to start"}))
                else:
                    sp.prep_group(0, 0)  # warm
                    t0 = time.perf_counter()
                    for d in range(n_dispatch):
                        sp.prep_group(1, d)
                    t_pool = time.perf_counter() - t0
                    _report(f"pooled-{workers}", N, detail, t_pool)
            finally:
                sp.close()


if __name__ == "__main__":
    main()
