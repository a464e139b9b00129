#!/usr/bin/env python3
"""Smoke test of the engine's main path on the GPU, at full width.

    python chip_smoke.py               # one card: every phase below
    python chip_smoke.py --four-cards  # four cards: the multi-card fits only

One card, in one process, through the entry points a user calls
(``cli.main`` and the library):

- device:   JAX's devices and version, the card's name and power limit;
            refuses to go on unless the default device is a GPU.
- fit:      ``fit`` on a Kuzmin-shaped TSV generated from a seed (~163840
            trigenic rows, of which the fit trains on N ~ 131072 and holds
            out the rest; G = 1000, K = 10, S = 10 restarts, R = 2; 40
            sweeps, likelihood every 10).  Checks: every restart's
            likelihood trace is non-decreasing up to 1e-6 |L| per check, the
            held-out AUC in report.json is finite, the checkpoint loads.
- parity:   ``em_sufficient_stats`` on the GPU at G = 1000, K = 10, R = 2 on
            16384 rows against the float64 NumPy oracle and against the same
            call on the host CPU (1e-4 relative to the largest entry: float32
            at HIGHEST precision, summed in another order, theta_hat by
            atomic scatter).
- predict:  ``predict`` from the fit's checkpoint on the held-out rows; the
            scores (fused Triton kernel, TF32 dot) against the
            HIGHEST-precision per-restart scorer within 2e-3 absolute.
- digenic:  ``fit --mutant-type digenic`` on the same file.
- stepwise: ``fit --minibatch 65536`` for three epochs.
- gpu-tests: the pytest tests marked ``gpu`` (tests/test_on_gpu.py).

With ``--four-cards``: the Kuzmin-scale fit on meshes data=4, ensemble=2 x
data=2 and model=2 x data=2, each against the one-card fit from the same
seed (first 20 sweeps' likelihood trace within 1e-5 relative, final theta
within 1e-4 absolute), with every card's peak memory printed.

Any failed phase makes the exit code non-zero and suppresses the result
line.  The last line of standard output is, on success, exactly
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
import traceback
from dataclasses import dataclass

REPO = os.path.dirname(os.path.abspath(__file__))

# Slack on the EM likelihood's monotonicity, relative to |L|, per check:
# float32 sums over ~10^5 rows in run-dependent order move L by ~1e-7 |L|.
MONOTONE_SLACK = 1e-6
# EM statistics on the GPU vs the float64 oracle / the host CPU (relative
# to the largest entry); see the module docstring.
STATS_RTOL = 1e-4
# P(interact) from the TF32 scorers vs the HIGHEST scorer (absolute):
# TF32 keeps 10 mantissa bits, so each product is within ~1e-3 of its f32
# value relative, and P <= 1.
SCORE_ATOL = 2e-3
# Multi-card fits vs the one-card fit: only the psum's summation order
# differs.
TRACE_RTOL = 1e-5
THETA_ATOL = 1e-4


@dataclass(frozen=True)
class Sizes:
    # TSV rows: ~80% trigenic, of which the fit trains on 80% -> N ~ 131072
    rows: int = 204800
    genes: int = 1000
    k: int = 10
    samples: int = 10
    sweeps: int = 40
    freq: int = 10
    parity_rows: int = 16384
    minibatch: int = 65536
    digenic_sweeps: int = 20
    four_card_sweeps: int = 20


FULL = Sizes()


def log(msg: str) -> None:
    print(msg, flush=True)


# ----------------------------------------------------------------------
# phases (each raises on failure; sizes are parameters so the tests can
# run them at a tiny size on the CPU)
# ----------------------------------------------------------------------


def phase_device() -> dict:
    import jax

    from trigenicinteractionpredictor_tpu.utils.device import (
        gpu_name_and_power_limit,
        require_gpu,
    )

    log(f"jax {jax.__version__}; devices: {jax.devices()}")
    log("card (nvidia-smi --query-gpu=name,power.limit):")
    log(gpu_name_and_power_limit())
    return require_gpu()


def write_data(workdir: str, sz: Sizes) -> str:
    from trigenicinteractionpredictor_tpu.data.synthetic import (
        write_kuzmin_like_tsv,
    )
    from trigenicinteractionpredictor_tpu.native import binding

    tsv = os.path.join(workdir, "kuzmin_like.tsv")
    write_kuzmin_like_tsv(tsv, n_rows=sz.rows, n_genes=sz.genes, seed=0)
    log(f"data: {tsv} ({sz.rows} rows); native parser: {binding.available()}")
    return tsv


def _cli(args) -> None:
    from trigenicinteractionpredictor_tpu.cli import main

    rc = main([str(a) for a in args])
    if rc != 0:
        raise RuntimeError(f"cli {args[0]} returned {rc}")


def _check_trace(ll_trace, what: str) -> float:
    """Largest per-check likelihood drop relative to |L|; raises past the
    slack."""
    import numpy as np

    tr = np.atleast_2d(np.asarray(ll_trace, np.float64))
    if tr.shape[0] < 2:
        raise AssertionError(f"{what}: trace has {tr.shape[0]} checks")
    if not np.isfinite(tr).all():
        raise AssertionError(f"{what}: non-finite likelihood in trace")
    drop = np.max((tr[:-1] - tr[1:]) / np.abs(tr[1:]))
    log(f"{what}: {tr.shape[0]} checks x {tr.shape[1]} restarts; "
        f"largest relative drop {drop:.3g} (slack {MONOTONE_SLACK:g})")
    if drop > MONOTONE_SLACK:
        raise AssertionError(f"{what}: likelihood fell by {drop:.3g} |L|")
    return float(drop)


def _read_report(out: str, what: str) -> dict:
    import math

    with open(os.path.join(out, "report.json")) as fh:
        rep = json.load(fh)
    if not math.isfinite(rep["auc"]):
        raise AssertionError(f"{what}: held-out AUC {rep['auc']}")
    return rep


def phase_fit(workdir: str, tsv: str, sz: Sizes, card: str = "") -> dict:
    from trigenicinteractionpredictor_tpu.train.checkpoint import load_checkpoint

    out = os.path.join(workdir, "fit")
    t0 = time.perf_counter()
    _cli(["fit", "-f", tsv, "-k", sz.k, "-s", sz.samples, "-i", sz.sweeps,
          "-n", sz.freq, "-o", out])
    wall = time.perf_counter() - t0
    rep = _read_report(out, "fit")
    ck = load_checkpoint(os.path.join(out, "model.ckpt.npz"))
    S = ck["states"].theta.shape[0]
    if S != sz.samples or ck["sweep"] != sz.sweeps:
        raise AssertionError(f"checkpoint holds S={S}, sweep={ck['sweep']}")
    _check_trace(ck["ll_trace"], "fit likelihood")
    with open(os.path.join(out, "events.jsonl")) as fh:
        done = [e for e in map(json.loads, fh) if e.get("event") == "fit_done"][-1]
    log(f"fit: auc={rep['auc']:.4f}; {done['sweeps']} sweeps in "
        f"{done['wall_s']:.2f}s of training loop, the step's compile "
        f"included ({wall:.1f}s for the whole command) = "
        f"{done['sweeps'] / done['wall_s']:.1f} sweeps/s, "
        f"{done['triplets_per_sec'] * S:,.0f} restart-triplet updates/s "
        f"on {card} (informational)")
    return {"out": out, "checkpoint": os.path.join(out, "model.ckpt.npz"),
            "report": rep}


def phase_parity(tsv: str, checkpoint: str, sz: Sizes) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    sys.path.insert(0, os.path.join(REPO, "tests"))
    import oracle

    from trigenicinteractionpredictor_tpu.config import DataConfig
    from trigenicinteractionpredictor_tpu.data.kuzmin import load_kuzmin_tsv
    from trigenicinteractionpredictor_tpu.ops.em import Batch, em_sufficient_stats
    from trigenicinteractionpredictor_tpu.train.checkpoint import load_checkpoint

    ds = load_kuzmin_tsv(tsv, DataConfig(path=tsv))
    n = min(sz.parity_rows, ds.n_rows)
    trip, rat = ds.triplets[:n], ds.ratings[:n]
    w = np.ones(n, np.float32)
    ck = load_checkpoint(checkpoint)
    theta, p = ck["states"].theta[0], ck["states"].p[0]

    def run(device):
        args = [jax.device_put(jnp.asarray(a), device)
                for a in (theta, p, trip, rat, w)]
        out = jax.jit(
            lambda th, pp, t, r, ww: em_sufficient_stats(th, pp, Batch(t, r, ww))
        )(*args)
        return [np.asarray(x, np.float64) for x in out]

    dev = run(jax.devices()[0])
    cpu = run(jax.devices("cpu")[0])
    ref = oracle.em_sufficient_stats(theta, p, trip, rat, w)
    for name, a, c, o in zip(("theta_hat", "p_hat", "loglik"), dev, cpu, ref):
        o = np.asarray(o, np.float64)
        scale = max(float(np.abs(o).max()), 1e-30)
        e_o = float(np.abs(a - o).max()) / scale
        e_c = float(np.abs(a - c).max()) / max(float(np.abs(c).max()), 1e-30)
        log(f"parity {name}: rel err vs float64 oracle {e_o:.3g}, "
            f"vs host CPU {e_c:.3g} (limit {STATS_RTOL:g}; {n} rows)")
        if e_o > STATS_RTOL or e_c > STATS_RTOL:
            raise AssertionError(f"parity {name}: {e_o:.3g} / {e_c:.3g}")


def phase_predict(workdir: str, tsv: str, checkpoint: str, sz: Sizes) -> None:
    import jax.numpy as jnp
    import numpy as np

    from trigenicinteractionpredictor_tpu.config import DataConfig
    from trigenicinteractionpredictor_tpu.data.kuzmin import load_kuzmin_tsv
    from trigenicinteractionpredictor_tpu.data.splits import train_test_split
    from trigenicinteractionpredictor_tpu.models.mmsbm import ModelState
    from trigenicinteractionpredictor_tpu.ops.scoring import (
        ensemble_predict_interaction,
    )
    from trigenicinteractionpredictor_tpu.train.checkpoint import load_checkpoint

    ds = load_kuzmin_tsv(tsv, DataConfig(path=tsv))
    _, test = train_test_split(ds, 0.2, 0)       # the fit's held-out rows
    npz = test.save_npz(os.path.join(workdir, "heldout.npz"))
    out = os.path.join(workdir, "predictions.tsv")
    _cli(["predict", "-f", npz, "--checkpoint", checkpoint, "-o", out,
          "-k", sz.k])
    got = np.loadtxt(out, delimiter="\t", skiprows=1, usecols=3, ndmin=1)
    ck = load_checkpoint(checkpoint)
    states = ModelState(theta=jnp.asarray(ck["states"].theta),
                        p=jnp.asarray(ck["states"].p))
    want = np.asarray(ensemble_predict_interaction(states, jnp.asarray(test.triplets)))
    if got.shape != want.shape:
        raise AssertionError(f"predict wrote {got.shape} scores, want {want.shape}")
    err = float(np.abs(got - want).max())
    log(f"predict: {got.size} held-out rows; max |score - HIGHEST scorer| "
        f"{err:.3g} (limit {SCORE_ATOL:g})")
    if not np.isfinite(got).all() or err > SCORE_ATOL:
        raise AssertionError(f"predict scores off by {err:.3g}")


def phase_digenic(workdir: str, tsv: str, sz: Sizes) -> None:
    from trigenicinteractionpredictor_tpu.train.checkpoint import load_checkpoint

    out = os.path.join(workdir, "digenic")
    _cli(["fit", "-f", tsv, "--mutant-type", "digenic", "-k", sz.k,
          "-s", sz.samples, "-i", sz.digenic_sweeps, "-n", sz.freq, "-o", out])
    rep = _read_report(out, "digenic")
    _check_trace(load_checkpoint(os.path.join(out, "model.ckpt.npz"))["ll_trace"],
                 "digenic likelihood")
    log(f"digenic: auc={rep['auc']:.4f} over {rep['n_test']} held-out pairs")


def phase_stepwise(workdir: str, tsv: str, sz: Sizes) -> None:
    import numpy as np

    from trigenicinteractionpredictor_tpu.train.checkpoint import load_checkpoint

    out = os.path.join(workdir, "stepwise")
    _cli(["fit", "-f", tsv, "--minibatch", sz.minibatch, "-k", sz.k,
          "-s", sz.samples, "-i", 3, "-n", 1, "-o", out])
    rep = _read_report(out, "stepwise")
    ck = load_checkpoint(os.path.join(out, "model.ckpt.npz"))
    if ck["sweep"] != 3 or not np.isfinite(ck["ll_trace"]).all():
        raise AssertionError(f"stepwise: epoch {ck['sweep']}, trace {ck['ll_trace']}")
    log(f"stepwise: 3 epochs of {sz.minibatch}-row minibatches; "
        f"auc={rep['auc']:.4f}")


def phase_gpu_tests() -> None:
    import pytest

    os.environ["TRIGENIC_TEST_DEVICE"] = "gpu"
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider", "-rs",
                      os.path.join(REPO, "tests", "test_on_gpu.py")])
    if rc != 0:
        raise RuntimeError(f"gpu tests: pytest exit code {rc}")


def phase_four_cards(sz: Sizes, n_cards: int = 4) -> None:
    """Multi-card meshes vs the one-card fit, same data and seed."""
    import dataclasses

    import jax
    import numpy as np

    from trigenicinteractionpredictor_tpu.config import (
        Config,
        MeshConfig,
        TrainConfig,
    )
    from trigenicinteractionpredictor_tpu.data.splits import train_test_split
    from trigenicinteractionpredictor_tpu.data.synthetic import (
        sample_synthetic_dataset,
    )
    from trigenicinteractionpredictor_tpu.parallel.mesh import make_mesh
    from trigenicinteractionpredictor_tpu.train.trainer import fit

    devs = jax.devices()
    if len(devs) < n_cards:
        raise RuntimeError(f"--four-cards needs {n_cards} devices, have {len(devs)}")
    n = int(sz.rows * 0.8)
    ds, _, _ = sample_synthetic_dataset(n, sz.genes, sz.k, seed=0)
    train, _ = train_test_split(ds, 0.2, 0)
    base = Config(train=TrainConfig(k=sz.k, sweeps=sz.four_card_sweeps,
                                    samples=sz.samples, likelihood_freq=1))

    def run(data, ensemble, model):
        mesh = make_mesh(data=data, ensemble=ensemble, model=model)
        cfg = dataclasses.replace(
            base, mesh=MeshConfig(data=data, ensemble=ensemble, model=model)
        )
        t0 = time.perf_counter()
        res = fit(cfg, train, mesh=mesh)
        t = time.perf_counter() - t0
        mem = [(d.memory_stats() or {}).get("peak_bytes_in_use", 0)
               for d in devs[:n_cards]]
        return res, t, mem

    # The multi-card meshes run first, so each card's peak memory after
    # the first of them shows how the rows were spread.
    meshes = ((n_cards, 1, 1), (2, 2, 1), (2, 1, 2))
    multi = [run(*m) for m in meshes]
    one, t_one, _ = run(1, 1, 1)
    log(f"one card: {one.ll_trace.shape[0]} sweeps in {t_one:.1f}s")
    failures = []
    for (data, ens, model), (res, t, mem) in zip(meshes, multi):
        tr_err = float(np.max(np.abs(res.ll_trace - one.ll_trace)
                              / np.abs(one.ll_trace)))
        th_err = float(np.max(np.abs(np.asarray(res.states.theta)
                                     - np.asarray(one.states.theta))))
        ok = tr_err <= TRACE_RTOL and th_err <= THETA_ATOL
        log(f"mesh data={data} ensemble={ens} model={model}: {t:.1f}s; "
            f"trace rel err {tr_err:.3g} (limit {TRACE_RTOL:g}), theta abs err "
            f"{th_err:.3g} (limit {THETA_ATOL:g}); peak bytes per card so far "
            f"{[int(m) for m in mem]} -> {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append((data, ens, model))
    if failures:
        raise AssertionError(f"multi-card fits disagree: {failures}")


# ----------------------------------------------------------------------


def run_phases(phases) -> bool:
    ok = True
    for name, fn in phases:
        t0 = time.perf_counter()
        log(f"=== {name}")
        try:
            fn()
            log(f"=== {name}: ok ({time.perf_counter() - t0:.1f}s)")
        except Exception:
            ok = False
            traceback.print_exc(file=sys.stdout)
            log(f"=== {name}: FAILED ({time.perf_counter() - t0:.1f}s)")
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the multi-card fits (needs 4 GPUs)")
    args = ap.parse_args(argv)

    sys.path.insert(0, REPO)
    try:
        from trigenicinteractionpredictor_tpu.utils.compile_cache import (
            enable_compile_cache,
        )
    except ImportError as e:
        print(f"chip_smoke: the engine is not next to this script: {e}",
              file=sys.stderr)
        return 2
    enable_compile_cache()
    try:
        device = phase_device()
    except Exception as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 3
    log(f"device: {device}")

    if args.four_cards:
        ok = run_phases([("four-cards", lambda: phase_four_cards(FULL))])
    else:
        from trigenicinteractionpredictor_tpu.utils.device import (
            gpu_name_and_power_limit,
        )

        card = gpu_name_and_power_limit()
        sz = FULL
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
            st: dict = {}
            ok = run_phases([
                ("data", lambda: st.update(tsv=write_data(workdir, sz))),
                ("fit", lambda: st.update(fit=phase_fit(workdir, st["tsv"], sz, card))),
                ("parity", lambda: phase_parity(st["tsv"], st["fit"]["checkpoint"], sz)),
                ("predict", lambda: phase_predict(workdir, st["tsv"],
                                                  st["fit"]["checkpoint"], sz)),
                ("digenic", lambda: phase_digenic(workdir, st["tsv"], sz)),
                ("stepwise", lambda: phase_stepwise(workdir, st["tsv"], sz)),
                ("gpu-tests", phase_gpu_tests),
            ])
    if not ok:
        log("chip_smoke: FAILED")
        return 1
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
