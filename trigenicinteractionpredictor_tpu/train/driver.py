"""Experiment driver: fold x K x restart fan-out (SURVEY.md §4.5, §6).

The reference runs folds, K values and samples as nested serial loops in one
process.  Here each (fold, K) pair is an idempotent *work unit*:

- restarts within a unit are a vmapped axis inside one jit (free on-chip);
- units fan out across processes/hosts by round-robin on
  ``jax.process_index()`` (embarrassingly parallel — no communication until
  the final report merge, SURVEY.md §3.4);
- each finished unit writes ``<out>/units/<unit>.json`` — the DONE marker —
  and a re-launched driver skips finished units and resumes interrupted
  ones from their checkpoint (elastic recovery, SURVEY.md §6 "Failure
  detection").

The merged JSONL report is the deliverable of BASELINE configs 3-5.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
from dataclasses import dataclass
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np

from trigenicinteractionpredictor_tpu.config import Config
from trigenicinteractionpredictor_tpu.data.packing import TripletDataset
from trigenicinteractionpredictor_tpu.data.splits import kfold_splits, train_test_split
from trigenicinteractionpredictor_tpu.eval import evaluate
from trigenicinteractionpredictor_tpu.train.trainer import fit
from trigenicinteractionpredictor_tpu.utils.logging import JsonlLogger


@dataclass
class WorkUnit:
    fold: int
    k: int
    train_ds: TripletDataset
    test_ds: TripletDataset

    @property
    def name(self) -> str:
        return f"fold{self.fold}_k{self.k}"


def make_work_units(cfg: Config, ds: TripletDataset, k_grid: Sequence[int]) -> List[WorkUnit]:
    units: List[WorkUnit] = []
    if cfg.split.n_folds <= 1:
        tr, te = train_test_split(ds, cfg.split.test_fraction, cfg.split.seed)
        folds: Iterable[Tuple[int, TripletDataset, TripletDataset]] = [(0, tr, te)]
    else:
        folds = kfold_splits(ds, cfg.split.n_folds, cfg.split.seed)
    for fold, tr, te in folds:
        for k in k_grid:
            units.append(WorkUnit(fold=fold, k=k, train_ds=tr, test_ds=te))
    return units


def run_units(
    cfg: Config,
    ds: TripletDataset,
    k_grid: Optional[Sequence[int]] = None,
    process_index: Optional[int] = None,
    process_count: Optional[int] = None,
    mesh=None,
    stats_fn=None,
) -> List[dict]:
    """Run this process's share of the fold x K grid; return its records.

    ``process_index``/``process_count`` default to jax.process_* so a
    multi-host launch partitions units automatically; tests inject shims
    (SURVEY.md §5.4).
    """
    import jax

    pi = jax.process_index() if process_index is None else process_index
    pc = jax.process_count() if process_count is None else process_count
    k_grid = list(k_grid or [cfg.train.k])

    # Units are embarrassingly parallel ACROSS processes: each unit's fit
    # must therefore run on this process's local devices only.  A global
    # mesh here would issue cross-process collectives while different
    # processes run different units — a deadlock.  (Callers that want one
    # unit spread across all hosts pass an explicit mesh instead.)  The
    # local mesh honors cfg.mesh's ensemble/model axes — a user's
    # --mesh-ensemble/--mesh-model must not be silently dropped in exactly
    # the grid runs the flags were built for — with
    # the data axis absorbing whatever devices remain.
    if mesh is None and jax.process_count() > 1:
        from trigenicinteractionpredictor_tpu.parallel.mesh import make_mesh

        local = jax.local_devices()
        e = max(cfg.mesh.ensemble, 1)
        m = max(cfg.mesh.model, 1)
        if len(local) % (e * m) != 0:
            raise ValueError(
                f"{len(local)} local devices do not divide by "
                f"mesh.ensemble*mesh.model={e * m}; fix --mesh-ensemble/"
                f"--mesh-model or pass an explicit mesh"
            )
        mesh = make_mesh(
            data=len(local) // (e * m), ensemble=e, model=m, devices=local
        )

    os.makedirs(cfg.out_dir, exist_ok=True)
    units_dir = os.path.join(cfg.out_dir, "units")
    os.makedirs(units_dir, exist_ok=True)
    logger = JsonlLogger(os.path.join(cfg.out_dir, f"events_p{pi}.jsonl"))
    if mesh is not None:
        logger.log("local_mesh", **{k: int(v) for k, v in mesh.shape.items()})

    records: List[dict] = []
    for i, unit in enumerate(make_work_units(cfg, ds, k_grid)):
        if i % pc != pi:
            continue
        done_path = os.path.join(units_dir, f"{unit.name}.json")
        if os.path.exists(done_path):
            with open(done_path) as fh:
                records.append(json.load(fh))
            logger.log("unit_skipped_done", unit=unit.name)
            continue

        ckpt = os.path.join(units_dir, f"{unit.name}.ckpt.npz")
        resume = ckpt if os.path.exists(ckpt) else None
        ucfg = cfg.replace(train=dataclasses.replace(cfg.train, k=unit.k))
        logger.log("unit_start", unit=unit.name, resume=bool(resume))
        result = fit(
            ucfg,
            unit.train_ds,
            mesh=mesh,
            logger=logger,
            resume=resume,
            checkpoint_path=ckpt,
            stats_fn=stats_fn,
        )
        report = evaluate(result.states, unit.test_ds, result.final_loglik)
        rec = {
            "unit": unit.name,
            "fold": unit.fold,
            "k": unit.k,
            "process": pi,
            "sweeps": result.sweeps_run,
            "triplets_per_sec": result.triplets_per_sec,
            "ll_best": float(result.final_loglik.max()),
            "ll_per_sample": [float(x) for x in result.final_loglik],
            **report.to_dict(),
        }
        with open(done_path + ".tmp", "w") as fh:
            json.dump(rec, fh, indent=2)
        os.replace(done_path + ".tmp", done_path)  # DONE marker, atomic
        logger.log("unit_done", unit=unit.name, auc=report.auc)
        records.append(rec)
    logger.close()
    return records


def merge_report(out_dir: str) -> dict:
    """Merge all finished units into the final AUC/PR report (host 0 only
    in a multi-host launch).  Selects the best K per fold by HELD-OUT
    likelihood of the best sample (BASELINE config 4) — training likelihood
    grows nearly monotonically with K (measured: K=50 reaches train L -34k
    vs K=25's -65k while its held-out L is far worse; docs/DESIGN.md §6), so
    selecting on it would always pick the largest, most overfit K."""
    recs = []
    for path in sorted(glob.glob(os.path.join(out_dir, "units", "*.json"))):
        with open(path) as fh:
            recs.append(json.load(fh))
    if not recs:
        return {"units": [], "summary": {}}
    by_fold: dict = {}
    for r in recs:
        by_fold.setdefault(r["fold"], []).append(r)
    # Unit JSONs from pre-heldout-selection runs lack "heldout_loglik"; a
    # resumed/mixed out_dir is a supported elastic-recovery flow, so fall
    # back to the training likelihood rather than KeyError.
    best_per_fold = {
        f: max(rs, key=lambda r: r.get("heldout_loglik", r["ll_best"]))
        for f, rs in by_fold.items()
    }
    selected = list(best_per_fold.values())
    summary = {
        # Headline quality: mean over the SELECTED model per fold.  The
        # all-units mean below deliberately mixes every K in the grid
        # (including overfit ones) — keep it for debugging, not headlines.
        "mean_auc_selected": float(np.mean([r["auc"] for r in selected])),
        "mean_ap_selected": float(
            np.mean([r["average_precision"] for r in selected])
        ),
        "mean_auc": float(np.mean([r["auc"] for r in recs])),
        "mean_ap": float(np.mean([r["average_precision"] for r in recs])),
        "best_k_per_fold": {str(f): r["k"] for f, r in best_per_fold.items()},
        "best_auc_per_fold": {str(f): r["auc"] for f, r in best_per_fold.items()},
        "n_units": len(recs),
    }
    report = {"units": recs, "summary": summary}
    with open(os.path.join(out_dir, "report.json"), "w") as fh:
        json.dump(report, fh, indent=2)
    return report
