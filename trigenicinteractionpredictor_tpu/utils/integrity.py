"""Runtime compute-integrity sentinel (SURVEY.md §6 "Failure detection").

A compiler can miscompile a fused XLA graph in ways that silently corrupt
results: an accelerator backend was once seen returning sufficient
statistics ~100x too small while every op was correct in isolation (see
the fusion guard in ops/em.py).  Because such bugs depend on the fusion
context, the engine verifies itself at runtime: before a training run on
an accelerator, one EM-statistics call on a synthetic probe batch is
checked against the same computation on the host CPU backend.

This is the automated analog of the reference's implicit "likelihood must
increase" eyeball check, run where silent corruption would enter.
"""

from __future__ import annotations

import functools
import json
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np


class ComputeIntegrityError(RuntimeError):
    """The accelerator produced results inconsistent with the host CPU."""


# Relative tolerance for probe agreement (max error over max magnitude).
# Both sides run f32 at HIGHEST precision; they differ only in summation
# order: theta_hat's segment_sum is an atomic scatter on the GPU (each of
# the probe's 512 genes gathers ~190 terms, order-dependent error below
# ~190 * 2^-24 ~ 1e-5 relative), and loglik / p_hat are reductions over
# 32768 rows in another tree shape (error ~1e-6 relative).  The
# miscompile this guards against was ~100% error, so 1e-3 leaves two
# orders of magnitude on both sides.
_TOL = 1e-3


def _code_fingerprint() -> str:
    """Hash of the compute-path source — invalidates cached verdicts."""
    import hashlib

    import trigenicinteractionpredictor_tpu.ops.em as em_mod

    h = hashlib.sha256()
    with open(em_mod.__file__, "rb") as fh:
        h.update(fh.read())
    h.update(jax.__version__.encode())
    return h.hexdigest()[:16]


def _cache_path() -> str:
    import trigenicinteractionpredictor_tpu as pkg

    root = os.path.dirname(os.path.dirname(os.path.abspath(pkg.__file__)))
    return os.path.join(root, ".integrity_cache.json")


def _cached_verdict(key: str):
    try:
        with open(_cache_path()) as fh:
            return json.load(fh).get(key)
    except Exception:
        return None


def _store_verdict(key: str, ok: bool) -> None:
    path = _cache_path()
    try:
        data = {}
        if os.path.exists(path):
            with open(path) as fh:
                data = json.load(fh)
        data[key] = bool(ok)
        tmp = path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(data, fh)
        os.replace(tmp, path)
    except Exception:
        pass  # cache is an optimization only


def _make_probe_case(n: int, g: int, k: int, r: int, arity: int, seed: int):
    """The host-CPU reference stats of a synthetic probe, and the runner
    that computes the same call on another device."""
    from trigenicinteractionpredictor_tpu.models.mmsbm import init_state
    from trigenicinteractionpredictor_tpu.ops.em import Batch, em_sufficient_stats

    rng = np.random.default_rng(seed)
    trip = rng.integers(0, g, size=(n, arity), dtype=np.int32)
    ratings = rng.integers(0, r, size=n, dtype=np.int32)
    weights = np.ones(n, dtype=np.float32)
    state = init_state(jax.random.key(seed), g, k, r, arity=arity)
    theta_np, p_np = np.asarray(state.theta), np.asarray(state.p)

    def run(device, stats_fn):
        args = [
            jax.device_put(jnp.asarray(a), device)
            for a in (theta_np, p_np, trip, ratings, weights)
        ]
        out = jax.jit(
            lambda th, p, t, rr, w: stats_fn(th, p, Batch(t, rr, w))
        )(*args)
        return [np.asarray(x) for x in out]

    cpu = run(jax.devices("cpu")[0], em_sufficient_stats)
    return cpu, run


def _check(tag: str, acc, cpu) -> bool:
    for name, a, c in zip(("theta_hat", "p_hat", "loglik"), acc, cpu):
        scale = max(float(np.abs(c).max()), 1.0)
        if float(np.abs(a - c).max()) > _TOL * scale:
            warnings.warn(
                f"integrity probe mismatch [{tag}] on {name}: "
                f"max|acc-cpu|={np.abs(a - c).max():.4g} vs {scale:.4g}"
            )
            return False
    return True


@functools.lru_cache(maxsize=None)
def _probe_result(
    platform: str, n: int, g: int, k: int, r: int, arity: int = 3
) -> bool:
    """Run the probe once per (platform, shape): the EM statistics on the
    default device against the host-CPU result."""
    from trigenicinteractionpredictor_tpu.ops.em import em_sufficient_stats

    cpu, run = _make_probe_case(n, g, k, r, arity, seed=0)
    return _check(platform, run(jax.devices()[0], em_sufficient_stats), cpu)


def check_em_integrity(
    n: int = 32768,
    n_genes: int = 512,
    k: int = 10,
    n_ratings: int = 2,
    raise_on_failure: bool = True,
    arity: int = 3,
) -> bool:
    """Verify accelerator EM stats against the host CPU. Cheap; cached.

    No-op (returns True) when already running on CPU.
    """
    platform = jax.devices()[0].platform
    if platform == "cpu":
        return True
    # On-disk verdict cache: the probe costs two compiles, so one verdict
    # per (device, code fingerprint, shape) serves every process on the
    # host.
    key = (
        f"{platform}:{jax.devices()[0].device_kind}:{_code_fingerprint()}:"
        f"{n}:{n_genes}:{k}:{n_ratings}:{arity}:{_TOL}"
    )
    cached = _cached_verdict(key)
    if cached is not None:
        ok = cached
        if not ok and raise_on_failure:
            raise ComputeIntegrityError(
                "cached integrity verdict is FAIL for this device/code — "
                "delete .integrity_cache.json to re-probe"
            )
        return ok
    ok = _probe_result(platform, n, n_genes, k, n_ratings, arity)
    _store_verdict(key, ok)
    if not ok and raise_on_failure:
        raise ComputeIntegrityError(
            "accelerator EM sufficient-statistics disagree with host CPU — "
            "refusing to train on silently-corrupt compute (see ops/em.py "
            "fusion notes)"
        )
    return ok
