"""The training loop (reference layer L4, SURVEY.md §4.1).

Reference structure: ``for sample in range(S): init; for it in range(T):
make_iteration(); if it % freq == 0: compute_likelihood()`` — serial
restarts, serial sweeps, interpreted hot loop.

Accelerator structure: all S restarts are a vmapped leading axis inside ONE
jitted sharded step (compiled once); the host loop only dispatches sweeps,
reads the per-restart likelihood every ``freq`` sweeps (the step returns the
pre-update L for free — no extra pass), early-stops on |dL| < tol, and
checkpoints.  The restart axis can additionally shard over the mesh's
``ensemble`` axis; the triplet batch shards over ``data``.
"""

from __future__ import annotations

import functools
import math
import time
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

from trigenicinteractionpredictor_tpu.config import Config
from trigenicinteractionpredictor_tpu.data.packing import TripletDataset
from trigenicinteractionpredictor_tpu.models.mmsbm import ModelState, init_state
from trigenicinteractionpredictor_tpu.ops.em import Batch, em_sufficient_stats
from trigenicinteractionpredictor_tpu.parallel.mesh import make_mesh
from trigenicinteractionpredictor_tpu.parallel.sharded_em import (
    make_sharded_likelihood,
    make_sharded_multi_step,
    replicate,
    shard_batch,
    shard_ensemble,
)
from trigenicinteractionpredictor_tpu.train.checkpoint import (
    load_checkpoint,
    save_checkpoint,
)
from trigenicinteractionpredictor_tpu.utils.logging import JsonlLogger, get_logger


@dataclass
class FitResult:
    """Converged ensemble of one (fold, K) work unit."""

    states: ModelState            # restart-stacked [S, ...]
    final_loglik: np.ndarray      # f64 [S] — L of the final states
    ll_trace: np.ndarray          # f64 [n_checks, S]
    sweeps_run: int
    triplets_per_sec: float
    wall_seconds: float
    # Resolved compute path (EM step family and row chunk) — also
    # serialized into checkpoints as extra_dispatch.
    dispatch: dict = field(default_factory=dict)

    @property
    def best_sample(self) -> int:
        return int(np.argmax(self.final_loglik))

    def best_state(self) -> ModelState:
        i = self.best_sample
        return ModelState(
            theta=np.asarray(self.states.theta)[i],
            p=np.asarray(self.states.p)[i],
        )


def _lcm(a: int, b: int) -> int:
    return a * b // math.gcd(a, b)


def _dispatch_extra(dispatch_info: dict) -> dict:
    """Checkpoint ``extra`` entry carrying the resolved dispatch decision
    (JSON as a uint8 array — npz-safe without pickling)."""
    import json as _json

    return {
        "dispatch_json": np.frombuffer(
            _json.dumps(dispatch_info, sort_keys=True).encode(), dtype=np.uint8
        )
    }


def _anneal_schedule(tcfg) -> Optional[np.ndarray]:
    """Per-sweep DAEM inverse temperatures, or None when annealing is off.

    Geometric ramp beta0 -> 1 over ``anneal_sweeps`` (default: half the
    budget), then exact EM (beta = 1) for the remainder.
    """
    if tcfg.anneal_beta0 >= 1.0:
        return None
    A = tcfg.anneal_sweeps or max(tcfg.sweeps // 2, 1)
    t = np.arange(tcfg.sweeps, dtype=np.float64)
    ramp = tcfg.anneal_beta0 ** np.clip(1.0 - t / A, 0.0, 1.0)
    return np.minimum(ramp, 1.0).astype(np.float32)


def fit(
    cfg: Config,
    train_ds: TripletDataset,
    mesh: Optional[Mesh] = None,
    logger: Optional[JsonlLogger] = None,
    resume: Optional[str] = None,
    checkpoint_path: Optional[str] = None,
    stats_fn=None,
    init_states: Optional[ModelState] = None,
) -> FitResult:
    """Fit cfg.train.samples restarts of the MMSBM on a training split.

    ``resume`` — path to a checkpoint to continue from (same shapes).
    ``stats_fn`` — override the sufficient-stats function (default:
    ops/em.py's ``em_sufficient_stats`` with ``engine.jnp_row_chunk``).
    ``init_states`` — restart-stacked [S, ...] initial states overriding
    the fresh random/spectral init (used by perturb-and-resweep refinement).
    """
    log = logger or get_logger()
    tcfg = cfg.train
    if tcfg.debug_nans:
        jax.config.update("jax_debug_nans", True)
    # Refuse to train on silently-corrupt accelerator compute (utils/integrity).
    from trigenicinteractionpredictor_tpu.utils.integrity import check_em_integrity

    check_em_integrity(arity=train_ds.arity)
    if mesh is None:
        mesh = make_mesh(
            data=cfg.mesh.data,
            ensemble=cfg.mesh.ensemble,
            model=cfg.mesh.model,
        )
    data_size = mesh.shape["data"]
    ens_size = mesh.shape["ensemble"]
    S = tcfg.samples
    if S % ens_size != 0:
        raise ValueError(f"samples={S} must divide by ensemble axis {ens_size}")

    # Tensor parallelism (large-K regime): p's l axis shards over ``model``
    # and the TP step replaces the replicated-parameter step.  TP is a
    # multi-device MEMORY feature (p and its K^3 statistics shard over
    # ``model`` when they outgrow one device), not a speed feature.
    use_tp = "model" in mesh.shape and mesh.shape["model"] > 1
    if use_tp:
        if train_ds.arity != 3:
            raise ValueError("tensor parallelism is trigenic-only (p is K^3)")
        if tcfg.minibatch > 0:
            raise ValueError(
                "stepwise EM does not compose with tensor parallelism; "
                "use mesh.model=1 for minibatch mode"
            )
        if tcfg.k % mesh.shape["model"] != 0:
            raise ValueError(
                f"k={tcfg.k} must divide by the model axis "
                f"{mesh.shape['model']}"
            )
        log.log("backend", kernel="jnp-tp", model_shards=mesh.shape["model"])

    arity = train_ds.arity
    stepwise = tcfg.minibatch > 0
    if use_tp:
        stats_fn = None
    elif stats_fn is None and cfg.engine.jnp_row_chunk > 0:
        # Bound the [rows, K, K, R] intermediates at large K (config.py).
        stats_fn = functools.partial(
            em_sufficient_stats, row_chunk=cfg.engine.jnp_row_chunk
        )

    # The resolved compute path, serialized into the JSONL log, the
    # checkpoint, and FitResult so a run is reproducible from its
    # artifacts alone.
    dispatch_info = {
        "kernel": "jnp-tp" if use_tp else "jnp",
        "row_chunk": int(cfg.engine.jnp_row_chunk),
    }
    log.log("dispatch", **dispatch_info)

    # Pad rows so every data shard is equal-length; weight-0 rows are inert.
    pad = _lcm(max(cfg.engine.batch_pad_multiple, 1), data_size)

    # Restart ensemble init (or resume).  The PRNG key only seeds the init —
    # classic EM is deterministic afterwards, so restoring ``states``
    # restores everything (the key rides in the checkpoint for provenance);
    # the stepwise mode additionally needs its EMA carry + update counter,
    # restored below via the checkpoint's ``extra`` arrays.
    start_sweep = 0
    ll_rows: List[np.ndarray] = []
    resume_extra: dict = {}

    def _fresh_states():
        if tcfg.init_method == "spectral":
            from trigenicinteractionpredictor_tpu.models.informed_init import (
                spectral_init_arrays,
            )

            th, pp = spectral_init_arrays(
                train_ds, tcfg.k, S, seed=tcfg.seed
            )
            log.log("init", method="spectral", samples=S)
            return ModelState(theta=jnp.asarray(th), p=jnp.asarray(pp))
        keys = jax.random.split(jax.random.key(tcfg.seed), S)
        return jax.vmap(
            lambda k: init_state(
                k,
                train_ds.n_genes,
                tcfg.k,
                train_ds.n_ratings,
                alpha=tcfg.init_alpha,
                arity=arity,
            )
        )(keys)

    if init_states is not None:
        states = ModelState(
            theta=jnp.asarray(init_states.theta), p=jnp.asarray(init_states.p)
        )
    elif resume is not None:
        ck = load_checkpoint(resume)
        states = ModelState(
            theta=jnp.asarray(ck["states"].theta), p=jnp.asarray(ck["states"].p)
        )
        start_sweep = ck["sweep"]
        ll_rows = [row for row in np.atleast_2d(ck["ll_trace"])] if ck["ll_trace"].size else []
        resume_extra = ck.get("extra") or {}
        log.log("resume", path=resume, sweep=start_sweep)
    else:
        states = _fresh_states()

    step_kwargs = {} if stats_fn is None else {"stats_fn": stats_fn}

    if stepwise:
        stepwise_carry = None
        if resume is not None:
            if "stepwise_t" in resume_extra:
                from trigenicinteractionpredictor_tpu.ops.em import SweepStats

                stepwise_carry = (
                    SweepStats(
                        theta_hat=jnp.asarray(resume_extra["ema_theta_hat"]),
                        p_hat=jnp.asarray(resume_extra["ema_p_hat"]),
                        loglik=jnp.asarray(resume_extra["ema_loglik"]),
                    ),
                    float(resume_extra["stepwise_t"]),
                )
            else:
                # Legacy checkpoint without the EMA carry: restart from
                # scratch (logged) — raising would permanently wedge the
                # CV/sweep driver's elastic relaunch.
                log.log("stepwise_restart", ignored_resume=resume)
                states = _fresh_states()
                start_sweep = 0
                ll_rows = []
        return _run_stepwise(
            cfg, mesh, train_ds, pad, states, step_kwargs, log, checkpoint_path,
            start_epoch=start_sweep, ll_rows=ll_rows, carry=stepwise_carry,
            dispatch_info=dispatch_info,
        )

    # Classic (full-batch) EM: the whole padded training split is
    # HBM-resident by design — the reference's own regime (SURVEY.md §1.3);
    # beyond-HBM datasets take the stepwise branch above.
    ds = train_ds.pad_to(pad)
    degrees = jnp.asarray(ds.degrees())
    batch = Batch(
        triplets=jnp.asarray(ds.triplets),
        ratings=jnp.asarray(ds.ratings),
        weights=jnp.asarray(ds.weights),
    )

    # Sweeps between likelihood checks run as ONE device-side lax.scan per
    # dispatch (make_sharded_multi_step) — per-dispatch host round-trips cost
    # as much as a sweep at Kuzmin scale.  One compiled executable per
    # distinct chunk length (freq, plus a tail / checkpoint remainder).
    multi_steps: dict = {}
    beta_sched = _anneal_schedule(tcfg)
    anneal_end = (
        0
        if beta_sched is None
        else (tcfg.anneal_sweeps or max(tcfg.sweeps // 2, 1))
    )
    if beta_sched is not None:
        log.log(
            "anneal", beta0=tcfg.anneal_beta0, ramp_sweeps=anneal_end,
        )

    if use_tp:
        from trigenicinteractionpredictor_tpu.parallel.tensor_parallel import (
            make_tp_multi_step,
        )

        def _make_multi(n: int, annealed: bool):
            return make_tp_multi_step(mesh, n, annealed=annealed)
    else:

        def _make_multi(n: int, annealed: bool):
            return make_sharded_multi_step(
                mesh, n, annealed=annealed, **step_kwargs
            )

    def step_chunk(n: int, at_sweep: int, states, batch_sh, deg_sh):
        annealed = beta_sched is not None and at_sweep < anneal_end
        if (n, annealed) not in multi_steps:
            multi_steps[(n, annealed)] = _make_multi(n, annealed)
        step = multi_steps[(n, annealed)]
        if annealed:
            betas = np.ones(n, np.float32)
            lo = min(at_sweep, len(beta_sched))
            hi = min(at_sweep + n, len(beta_sched))
            betas[: hi - lo] = beta_sched[lo:hi]
            return step(states, batch_sh, deg_sh, replicate(mesh, jnp.asarray(betas)))
        return step(states, batch_sh, deg_sh)

    if use_tp:
        from trigenicinteractionpredictor_tpu.parallel.tensor_parallel import (
            make_tp_likelihood,
            shard_tp_state,
        )

        ll_fn = make_tp_likelihood(mesh)
        states = shard_tp_state(mesh, states)
    else:
        ll_fn = make_sharded_likelihood(
            mesh, row_chunk=cfg.engine.jnp_row_chunk
        )
        states = shard_ensemble(mesh, states)
    batch_sh = shard_batch(mesh, batch)
    deg_sh = replicate(mesh, degrees)

    config_json = cfg.to_json()
    # Init-key provenance: classic EM consumes no randomness after init, so
    # the checkpointed states are complete for resume; the key rides along
    # so a checkpoint alone identifies the restart ensemble it came from.
    key_data = np.asarray(jax.random.key_data(jax.random.key(tcfg.seed)))
    freq = max(tcfg.likelihood_freq, 1)
    # The CPU backend's in-process collectives deadlock (rendezvous timeout)
    # when many sharded steps are in flight on virtual devices — throttle
    # dispatch depth there.  GPUs keep async pipelining.
    throttle = jax.devices()[0].platform == "cpu" and mesh.size > 1
    ce = tcfg.checkpoint_every if checkpoint_path else 0

    def next_boundary(s: int) -> int:
        b = min(tcfg.sweeps, (s // freq + 1) * freq)
        if ce > 0:
            b = min(b, (s // ce + 1) * ce)
        return b

    prev_check: Optional[np.ndarray] = None
    t0 = time.perf_counter()
    sweep = start_sweep
    stop = False

    # Likelihood-trace fetches are PIPELINED: each check's ll is converted
    # only after the NEXT chunk has been dispatched, so the host sync
    # overlaps that chunk's compute instead of idling the device.  Early
    # stopping therefore lags one check interval — it runs at most
    # ``freq`` extra sweeps.
    pending: Optional[Tuple[int, jax.Array]] = None

    def flush_pending() -> bool:
        nonlocal prev_check, pending
        if pending is None:
            return False
        at_sweep, ll = pending
        pending = None
        ll_np = np.asarray(ll, dtype=np.float64)  # L of pre-update state
        ll_rows.append(ll_np)
        dt = time.perf_counter() - t0
        log.log(
            "sweep",
            sweep=at_sweep,
            ll_best=float(ll_np.max()),
            ll_mean=float(ll_np.mean()),
            triplets_per_sec=(at_sweep - start_sweep) * ds.n_real / max(dt, 1e-9),
        )
        halt = False
        # While the DAEM ramp runs, ll rows are the annealed objective, not
        # the true likelihood — suspend |dL| early-stopping until both this
        # check and the previous one are past the ramp.
        past_ramp = at_sweep >= anneal_end + 2 * freq
        if tcfg.tol > 0 and prev_check is not None and past_ramp:
            if np.all(np.abs(ll_np - prev_check) < tcfg.tol):
                halt = True
                log.log("early_stop", sweep=at_sweep, tol=tcfg.tol)
        prev_check = ll_np
        return halt

    while sweep < tcfg.sweeps and not stop:
        n_inner = next_boundary(sweep) - sweep
        states, ll_hist = step_chunk(n_inner, sweep, states, batch_sh, deg_sh)
        sweep += n_inner
        if throttle:
            jax.block_until_ready(ll_hist)
        stop = flush_pending()  # previous check syncs while this chunk runs
        if sweep % freq == 0 or sweep == tcfg.sweeps:
            pending = (sweep, ll_hist[-1])
        if ce > 0 and sweep % ce == 0:
            stop = flush_pending() or stop  # keep the trace ordered
            save_checkpoint(
                checkpoint_path,
                ModelState(
                    theta=np.asarray(states.theta), p=np.asarray(states.p)
                ),
                sweep,
                np.stack(ll_rows) if ll_rows else np.zeros((0, S)),
                key=key_data,
                config_json=config_json,
                extra=_dispatch_extra(dispatch_info),
            )
    stop = flush_pending() or stop

    jax.block_until_ready(states.theta)
    wall = time.perf_counter() - t0
    final_ll = np.asarray(ll_fn(states, batch_sh), dtype=np.float64)

    # Quality-knob refinement order: split-merge topology jumps first
    # (escape basins with the wrong group structure), Dirichlet
    # perturb-and-resweep after (polish the winning basin locally).
    if tcfg.smem_rounds > 0:
        states, final_ll, extra = _smem(
            cfg, train_ds, mesh, log, states, final_ll, stats_fn
        )
        sweep += extra["sweeps"]
        wall += extra["wall"]
        ll_rows.extend(extra["ll_rows"])
    if tcfg.refine_rounds > 0:
        states, final_ll, extra = _refine(
            cfg, train_ds, mesh, log, states, final_ll, stats_fn
        )
        sweep += extra["sweeps"]
        wall += extra["wall"]
        ll_rows.extend(extra["ll_rows"])

    n_sweeps = sweep - start_sweep
    tps = n_sweeps * ds.n_real / max(wall, 1e-9)
    log.log(
        "fit_done",
        sweeps=n_sweeps,
        wall_s=wall,
        triplets_per_sec=tps,
        ll_best=float(final_ll.max()),
    )
    if checkpoint_path:
        save_checkpoint(
            checkpoint_path,
            ModelState(theta=np.asarray(states.theta), p=np.asarray(states.p)),
            sweep,
            np.stack(ll_rows) if ll_rows else np.zeros((0, S)),
            key=key_data,
            config_json=config_json,
            extra=_dispatch_extra(dispatch_info),
        )
    return FitResult(
        states=ModelState(
            theta=np.asarray(states.theta), p=np.asarray(states.p)
        ),
        final_loglik=final_ll,
        ll_trace=np.stack(ll_rows) if ll_rows else np.zeros((0, S)),
        sweeps_run=sweep,
        triplets_per_sec=tps,
        wall_seconds=wall,
        dispatch=dispatch_info,
    )


def _patch_worst_lane(cur_theta, cur_p, cur_ll, res, lane=None):
    """Accept a refinement result by replacing ONLY the worst original lane
    with the sub-fit's winning state (``lane``; best lane when omitted).

    Both refinement stages re-seed the whole sub-ensemble from the current
    best state, so the sub-fit's S states are correlated explorations of one
    basin; wholesale replacement collapses the restart diversity the
    reference's sample-averaging protocol relies on (measured ~0.02
    ensemble-AUC loss on the e2e probe).  Patching one lane keeps the
    likelihood guarantee (the max never drops) AND the ensemble spread.
    """
    best = int(np.argmax(res.final_loglik)) if lane is None else int(lane)
    worst = int(np.argmin(cur_ll))
    cur_theta = cur_theta.copy()
    cur_p = cur_p.copy()
    cur_ll = cur_ll.copy()
    cur_theta[worst] = np.asarray(res.states.theta)[best]
    cur_p[worst] = np.asarray(res.states.p)[best]
    cur_ll[worst] = float(res.final_loglik[best])
    return cur_theta, cur_p, cur_ll


def _refine(
    cfg: Config,
    train_ds: TripletDataset,
    mesh: Mesh,
    log,
    states: ModelState,
    final_ll: np.ndarray,
    stats_fn,
):
    """Perturb-and-resweep refinement (TrainConfig.refine_rounds).

    Each round re-seeds the whole restart ensemble from the current best
    state: restart 0 keeps it unperturbed (EM monotonicity then guarantees
    the refined best likelihood never drops), restarts 1..S-1 mix it with
    Dirichlet(1) noise at graded strengths around ``refine_eps`` — local
    exploration of the best basin's neighborhood, where the round-1 hardness
    study showed plain independent restarts never land.  The extra sweeps
    reuse the already-resolved stats function and mesh via a recursive
    :func:`fit` call with ``refine_rounds=0``.
    """
    import dataclasses

    tcfg = cfg.train
    S = tcfg.samples
    r_sweeps = tcfg.refine_sweeps or max(tcfg.sweeps // 4, 1)
    sub_train = dataclasses.replace(
        tcfg,
        sweeps=r_sweeps,
        refine_rounds=0,
        smem_rounds=0,
        anneal_beta0=1.0,
        anneal_sweeps=0,
        checkpoint_every=0,
        init_method="random",
    )
    sub_cfg = cfg.replace(train=sub_train)
    cur_theta = np.asarray(states.theta)
    cur_p = np.asarray(states.p)
    cur_ll = np.asarray(final_ll)
    extra = {"sweeps": 0, "wall": 0.0, "ll_rows": []}
    if S < 2:
        # Perturbed candidates live in lanes 1..S-1; with one lane the loop
        # would only resweep the incumbent — skip instead of burning sweeps.
        log.log("refine_skipped", reason=f"needs samples >= 2, got {S}")
        return ModelState(theta=cur_theta, p=cur_p), cur_ll, extra
    for rnd in range(tcfg.refine_rounds):
        best = int(np.argmax(cur_ll))
        th_b, p_b = cur_theta[best], cur_p[best]
        G, K = th_b.shape
        R = p_b.shape[-1]
        arity = p_b.ndim - 1
        rng = np.random.default_rng(tcfg.seed + 7717 * (rnd + 1))
        thetas = np.repeat(th_b[None], S, axis=0).astype(np.float32)
        ps = np.repeat(p_b[None], S, axis=0).astype(np.float32)
        for s in range(1, S):
            eps = tcfg.refine_eps * (0.5 + s / max(S - 1, 1))
            eps = min(eps, 0.95)
            thetas[s] = (1 - eps) * th_b + eps * rng.dirichlet(
                np.ones(K), size=G
            )
            ps[s] = (1 - eps) * p_b + eps * rng.dirichlet(
                np.ones(R), size=(K,) * arity
            )
        log.log("refine", round=rnd, from_ll=float(cur_ll.max()), sweeps=r_sweeps)
        res = fit(
            sub_cfg,
            train_ds,
            mesh=mesh,
            logger=log,
            stats_fn=stats_fn,
            init_states=ModelState(theta=thetas, p=ps),
        )
        extra["sweeps"] += res.sweeps_run
        extra["wall"] += res.wall_seconds
        extra["ll_rows"].extend(list(res.ll_trace))
        # Strict improvement by a PERTURBED lane: lane 0 is the unperturbed
        # best state resweeped, so by EM monotonicity it matches or beats
        # cur_ll.max() essentially always — accepting on it would patch a
        # best-basin clone over an original restart every round, eroding the
        # ensemble diversity _patch_worst_lane exists to preserve.  A
        # proposal must beat BOTH the incumbent and the trivial resweep
        # before it replaces anything.
        lane_ll = np.asarray(res.final_loglik, dtype=np.float64)
        bar = max(float(cur_ll.max()), float(lane_ll[0])) + 1e-6
        win = 1 + int(np.argmax(lane_ll[1:]))
        if float(lane_ll[win]) > bar:
            # Patch ONLY the worst original lane with the improved state:
            # replacing the whole ensemble with correlated perturbations of
            # one basin was measured to cost ~0.02 ensemble AUC on the e2e
            # probe (the sample-averaged score loses restart diversity).
            cur_theta, cur_p, cur_ll = _patch_worst_lane(
                cur_theta, cur_p, cur_ll, res, lane=win
            )
        log.log("refine_done", round=rnd, to_ll=float(cur_ll.max()))
    return (
        ModelState(theta=cur_theta, p=cur_p),
        cur_ll,
        extra,
    )


def _smem(
    cfg: Config,
    train_ds: TripletDataset,
    mesh: Mesh,
    log,
    states: ModelState,
    final_ll: np.ndarray,
    stats_fn,
):
    """Split-merge EM rounds (TrainConfig.smem_rounds).

    Each round re-seeds the restart ensemble from the current best state:
    restart 0 keeps it unperturbed (EM monotonicity then guarantees the
    accepted likelihood never drops), restarts 1..S-1 each get an
    independent merge+split topology jump (models/proposals.py).  The
    candidate resweeps ride the lane-stacked ensemble via a recursive
    :func:`fit` call, same as perturb-and-resweep refinement.
    """
    import dataclasses

    from trigenicinteractionpredictor_tpu.models.proposals import (
        merge_split_candidate,
    )

    tcfg = cfg.train
    S = tcfg.samples
    r_sweeps = tcfg.smem_sweeps or max(tcfg.sweeps // 4, 1)
    sub_train = dataclasses.replace(
        tcfg,
        sweeps=r_sweeps,
        smem_rounds=0,
        refine_rounds=0,
        anneal_beta0=1.0,
        anneal_sweeps=0,
        checkpoint_every=0,
        init_method="random",
    )
    sub_cfg = cfg.replace(train=sub_train)
    cur_theta = np.asarray(states.theta)
    cur_p = np.asarray(states.p)
    cur_ll = np.asarray(final_ll)
    extra = {"sweeps": 0, "wall": 0.0, "ll_rows": []}
    K = cur_theta.shape[-1]
    if K < 3:
        log.log("smem_skipped", reason=f"needs K >= 3, got {K}")
        return ModelState(theta=cur_theta, p=cur_p), cur_ll, extra
    if S < 2:
        # Merge-split candidates live in lanes 1..S-1; with one lane each
        # round would silently resweep the incumbent with no proposal at all
        # — skip, same as the K < 3 degenerate case.
        log.log("smem_skipped", reason=f"needs samples >= 2, got {S}")
        return ModelState(theta=cur_theta, p=cur_p), cur_ll, extra
    for rnd in range(tcfg.smem_rounds):
        best = int(np.argmax(cur_ll))
        th_b, p_b = cur_theta[best], cur_p[best]
        rng = np.random.default_rng(tcfg.seed + 9091 * (rnd + 1))
        thetas = np.repeat(th_b[None], S, axis=0).astype(np.float32)
        ps = np.repeat(p_b[None], S, axis=0).astype(np.float32)
        moves = [None]
        for s in range(1, S):
            thetas[s], ps[s], mv = merge_split_candidate(th_b, p_b, rng)
            moves.append(mv)
        log.log("smem", round=rnd, from_ll=float(cur_ll.max()), sweeps=r_sweeps)
        res = fit(
            sub_cfg,
            train_ds,
            mesh=mesh,
            logger=log,
            stats_fn=stats_fn,
            init_states=ModelState(theta=thetas, p=ps),
        )
        extra["sweeps"] += res.sweeps_run
        extra["wall"] += res.wall_seconds
        extra["ll_rows"].extend(list(res.ll_trace))
        # Strict improvement by a PROPOSAL lane (same rule as _refine, and
        # the rule the split-merge study used — tools/split_merge_study.py):
        # lane 0 is the unperturbed resweep, which EM monotonicity lets tie
        # or beat cur_ll.max() every round, so `>=` against it would accept
        # (and log a move for) rounds where every merge-split actually lost.
        lane_ll = np.asarray(res.final_loglik, dtype=np.float64)
        bar = max(float(cur_ll.max()), float(lane_ll[0])) + 1e-6
        win = 1 + int(np.argmax(lane_ll[1:]))
        accepted = bool(float(lane_ll[win]) > bar)
        if accepted:
            # Same diversity-preserving acceptance as _refine: only the
            # worst original lane is replaced by the improved state.
            cur_theta, cur_p, cur_ll = _patch_worst_lane(
                cur_theta, cur_p, cur_ll, res, lane=win
            )
        log.log(
            "smem_done",
            round=rnd,
            to_ll=float(cur_ll.max()),
            accepted_move=(
                list(map(int, moves[win])) if accepted and moves[win] else None
            ),
        )
    return (
        ModelState(theta=cur_theta, p=cur_p),
        cur_ll,
        extra,
    )


def _run_stepwise(
    cfg: Config,
    mesh: Mesh,
    train_ds: TripletDataset,
    pad: int,
    states: ModelState,
    step_kwargs: dict,
    log,
    checkpoint_path: Optional[str],
    start_epoch: int = 0,
    ll_rows: Optional[List[np.ndarray]] = None,
    carry=None,
    dispatch_info: Optional[dict] = None,
) -> FitResult:
    """Stepwise (incremental/minibatch) EM epochs (TrainConfig.minibatch).

    One dispatch per epoch: the epoch's shuffled minibatches run as a
    device-side lax.scan, each updating the parameters from exponentially
    averaged full-data-scale sufficient statistics (see
    parallel/sharded_em.py::make_sharded_stepwise_epoch for the update).
    ``cfg.train.sweeps`` counts epochs here; the likelihood trace rows are
    epoch means of the pre-update minibatch log-likelihoods.

    Resume: ``carry`` is ``(ema SweepStats, t)`` restored from a checkpoint
    (with ``start_epoch``/``ll_rows``).  The epoch shuffle is derived from
    (seed, epoch) — not a sequential host RNG stream — so a resumed run
    replays the exact permutation sequence fit-from-scratch would have used
    (tested in tests/test_trainer.py resume-equivalence).
    """
    from trigenicinteractionpredictor_tpu.parallel.sharded_em import (
        make_sharded_stepwise_epoch,
        zero_stats_like,
    )

    tcfg = cfg.train
    # Round the requested minibatch UP to a pad multiple (lcm would inflate
    # e.g. minibatch=1000 with pad=512 to 64000 rows).
    mb = -(-tcfg.minibatch // pad) * pad
    # The dataset is NEVER padded or materialized here: rows are gathered
    # per dispatch group below, and indices past ``n`` denote synthetic
    # weight-0 padding rows built on the fly — bit-identical to what
    # pad_to(mb) would append, without the whole-dataset host copy it
    # costs.  Host passes (degrees, weight totals) stream in chunks
    # through the possibly-memmapped arrays (data/packing.py).
    ds = train_ds
    n = ds.n_rows
    arity = ds.arity
    n_padded = -(-max(n, 1) // mb) * mb
    n_mb = n_padded // mb
    if n_mb < 2:
        raise ValueError(
            f"minibatch={tcfg.minibatch} (padded to {mb}) leaves {n_mb} "
            f"minibatches of {n_padded} rows — use classic EM instead"
        )

    # Beyond-HBM streaming: dispatch the epoch as groups of
    # ``stream_groups`` minibatches, so the device holds one group's rows
    # (group * mb) instead of the full dataset.  The EMA update sequence is
    # IDENTICAL to the monolithic epoch because rho_t depends only on the
    # carried counter t and the statistics scale on the explicit full-data
    # w_total (tested in tests/test_streaming.py).  The host side reads
    # through TripletDataset.load_dir(mmap=True), so the dataset need not
    # fit host RAM either.
    group = tcfg.stream_groups if tcfg.stream_groups > 0 else n_mb
    while n_mb % group:
        group -= 1  # largest divisor <= requested: keeps epochs uniform
    n_dispatch = n_mb // group

    log.log("stepwise", minibatch=mb, n_minibatches=n_mb,
            kappa=tcfg.stepwise_kappa, t0=tcfg.stepwise_t0,
            stream_groups=group if n_dispatch > 1 else 0)
    degrees = jnp.asarray(ds.degrees())
    n_real = ds.n_real
    w_total_np = np.float32(ds.weight_total())

    epoch_step = make_sharded_stepwise_epoch(
        mesh, group, kappa=tcfg.stepwise_kappa, t0=tcfg.stepwise_t0,
        **step_kwargs,
    )
    ll_fn = make_sharded_likelihood(mesh, row_chunk=cfg.engine.jnp_row_chunk)

    states = shard_ensemble(mesh, states)
    if carry is not None:
        ema = shard_ensemble(mesh, carry[0])
        t = replicate(mesh, jnp.asarray(carry[1], jnp.float32))
        log.log("stepwise_resume", epoch=start_epoch, t=float(carry[1]))
    else:
        ema = shard_ensemble(mesh, zero_stats_like(states))
        t = replicate(mesh, jnp.zeros((), jnp.float32))
    deg_sh = replicate(mesh, degrees)

    from jax.sharding import NamedSharding, PartitionSpec as P

    from trigenicinteractionpredictor_tpu.parallel.mesh import DATA_AXIS

    mb_sharding = NamedSharding(mesh, P(None, DATA_AXIS))
    config_json = cfg.to_json()
    S = states.theta.shape[0]
    ce = tcfg.checkpoint_every if checkpoint_path else 0
    freq = max(tcfg.likelihood_freq, 1)
    ll_rows = list(ll_rows or [])
    prev_check: Optional[np.ndarray] = None
    t0_wall = time.perf_counter()
    epoch = start_epoch
    stop = False
    w_total_sh = replicate(mesh, jnp.asarray(w_total_np))

    # --- host-side prep, one dispatch group at a time -----------------
    # train/stream_prep.py owns the prep stage: the (seed, epoch)-derived
    # shuffle (replayable across resume, drawn int32, with the NEXT
    # epoch's O(N) permutation precomputed while pool workers crunch the
    # last group) and an optional spawn-process pool fanning the gather
    # across cores into double-buffered shared memory.  The
    # one-group-lookahead prefetch thread (below) overlaps whatever host
    # time remains with device execution.
    from trigenicinteractionpredictor_tpu.train.stream_prep import StreamPrep

    stream_prep = StreamPrep(
        ds,
        layout={
            "seed": tcfg.seed,
            "n": n,
            "n_padded": n_padded,
            "mb": mb,
            "group": group,
            "arity": arity,
        },
        sharding=mb_sharding,
        workers=tcfg.stream_prep_workers,
    )

    def _prep_group(ep: int, d: int) -> Batch:
        """Prep + device_put one dispatch group (runs on the single
        prefetch thread; StreamPrep may fan the host work across a
        process pool)."""
        out = stream_prep.prep_group(ep, d)
        return Batch(
            triplets=out["trip"], ratings=out["rat"], weights=out["wts"]
        )

    from concurrent.futures import ThreadPoolExecutor

    # NOTE on device residency: with the lookahead ON, the next group is
    # device_put while the current one is still resident, so HBM holds up
    # to TWO stream groups at once.  TrainConfig.stream_groups
    # documents this; stream_prefetch=False restores strict one-group
    # residency for HBM-tight configs at the cost of serializing host
    # prep with device compute.
    prep_pool = ThreadPoolExecutor(max_workers=1)
    prep_future = None
    prefetch = tcfg.stream_prefetch
    try:
        while epoch < tcfg.sweeps and not stop:
            ll_groups = []
            for d in range(n_dispatch):
                if prep_future is None:
                    prep_future = prep_pool.submit(_prep_group, epoch, d)
                batches = prep_future.result()
                prep_future = None
                # Schedule the NEXT group's prep before dispatching this
                # one: epoch_step returns as soon as the work is enqueued
                # (async dispatch), so the prefetch thread gathers
                # while the device crunches.
                if prefetch:
                    if d + 1 < n_dispatch:
                        prep_future = prep_pool.submit(
                            _prep_group, epoch, d + 1
                        )
                    elif epoch + 1 < tcfg.sweeps:
                        prep_future = prep_pool.submit(
                            _prep_group, epoch + 1, 0
                        )
                states, ema, ll_g, t = epoch_step(
                    states, ema, t, batches, deg_sh, w_total_sh
                )
                ll_groups.append(ll_g)
            ll = jnp.mean(jnp.stack(ll_groups), axis=0)
            epoch += 1

            def _stepwise_extra():
                # The EMA statistics carry + update counter — everything beyond
                # (theta, p) a stepwise unit needs to resume exactly.
                return {
                    "ema_theta_hat": np.asarray(ema.theta_hat),
                    "ema_p_hat": np.asarray(ema.p_hat),
                    "ema_loglik": np.asarray(ema.loglik),
                    "stepwise_t": np.asarray(t, dtype=np.float32),
                }
            if epoch % freq == 0 or epoch == tcfg.sweeps:
                ll_np = np.asarray(ll, dtype=np.float64)
                ll_rows.append(ll_np)
                dt = time.perf_counter() - t0_wall
                log.log(
                    "epoch",
                    epoch=epoch,
                    ll_best=float(ll_np.max()),
                    ll_mean=float(ll_np.mean()),
                    triplets_per_sec=epoch * n_real / max(dt, 1e-9),
                )
                if tcfg.tol > 0 and prev_check is not None:
                    if np.all(np.abs(ll_np - prev_check) < tcfg.tol):
                        stop = True
                        log.log("early_stop", epoch=epoch, tol=tcfg.tol)
                prev_check = ll_np
            if ce > 0 and epoch % ce == 0:
                save_checkpoint(
                    checkpoint_path,
                    ModelState(theta=np.asarray(states.theta), p=np.asarray(states.p)),
                    epoch,
                    np.stack(ll_rows) if ll_rows else np.zeros((0, S)),
                    config_json=config_json,
                    extra={**_stepwise_extra(),
                           **_dispatch_extra(dispatch_info or {})},
                )
    finally:
        prep_pool.shutdown(wait=False)
        stream_prep.close()

    jax.block_until_ready(states.theta)
    wall = time.perf_counter() - t0_wall
    # Final full-data likelihood, streamed through the same group-sized
    # window the epochs used: the log-likelihood is additive over disjoint
    # row slices, so peak device residency stays O(group*mb) instead of
    # O(N).  Rows are read as CONTIGUOUS slices (no
    # shuffle needed), so a memmapped store streams sequentially; the tail
    # slice is zero-padded to keep ll_fn at one compiled shape.
    L = group * mb
    final_ll = np.zeros(S, dtype=np.float64)
    for d in range(n_dispatch):
        lo = d * L
        hi = min(lo + L, n)
        trip = np.zeros((L, arity), np.int32)
        rat = np.zeros(L, np.int32)
        wts = np.zeros(L, np.float32)
        if hi > lo:
            trip[: hi - lo] = ds.triplets[lo:hi]
            rat[: hi - lo] = ds.ratings[lo:hi]
            wts[: hi - lo] = ds.weights[lo:hi]
        gb = shard_batch(
            mesh, Batch(triplets=trip, ratings=rat, weights=wts)
        )
        final_ll += np.asarray(ll_fn(states, gb), dtype=np.float64)
    tps = (epoch - start_epoch) * n_real / max(wall, 1e-9)
    log.log(
        "fit_done", sweeps=epoch, wall_s=wall, triplets_per_sec=tps,
        ll_best=float(final_ll.max()), mode="stepwise",
    )
    if checkpoint_path and epoch > start_epoch:
        save_checkpoint(
            checkpoint_path,
            ModelState(theta=np.asarray(states.theta), p=np.asarray(states.p)),
            epoch,
            np.stack(ll_rows) if ll_rows else np.zeros((0, S)),
            config_json=config_json,
            extra={**_stepwise_extra(),
                   **_dispatch_extra(dispatch_info or {})},
        )
    return FitResult(
        states=ModelState(
            theta=np.asarray(states.theta), p=np.asarray(states.p)
        ),
        final_loglik=final_ll,
        ll_trace=np.stack(ll_rows) if ll_rows else np.zeros((0, S)),
        sweeps_run=epoch,
        triplets_per_sec=tps,
        wall_seconds=wall,
        dispatch=dispatch_info or {},
    )
