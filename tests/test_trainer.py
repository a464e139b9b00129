"""Trainer, checkpoint/resume, and experiment-driver tests (SURVEY.md §5.5,
§6)."""

import json
import os

import numpy as np
import pytest

from trigenicinteractionpredictor_tpu.config import (
    Config,
    MeshConfig,
    SplitConfig,
    TrainConfig,
)
from trigenicinteractionpredictor_tpu.data.splits import train_test_split
from trigenicinteractionpredictor_tpu.data.synthetic import sample_synthetic_dataset
from trigenicinteractionpredictor_tpu.eval import evaluate
from trigenicinteractionpredictor_tpu.models.mmsbm import ModelState
from trigenicinteractionpredictor_tpu.train.checkpoint import (
    load_checkpoint,
    save_checkpoint,
    write_text_dump,
)
from trigenicinteractionpredictor_tpu.train.driver import merge_report, run_units
from trigenicinteractionpredictor_tpu.train.trainer import fit


def _cfg(tmp_path, **train_kw):
    base = dict(k=3, sweeps=60, samples=4, likelihood_freq=10, seed=0)
    base.update(train_kw)
    return Config(
        train=TrainConfig(**base),
        mesh=MeshConfig(data=2, ensemble=2),
        out_dir=str(tmp_path / "run"),
    )


@pytest.fixture(scope="module")
def dataset():
    ds, theta_star, p_star = sample_synthetic_dataset(
        3000, n_genes=40, k=3, n_ratings=2, alpha_theta=0.3, alpha_p=0.3, seed=0
    )
    return ds, theta_star, p_star


def test_fit_trains_and_reports(tmp_path, dataset):
    ds, _, _ = dataset
    train, test = train_test_split(ds, 0.2, seed=0)
    cfg = _cfg(tmp_path)
    result = fit(cfg, train)
    assert result.sweeps_run == 60
    assert result.final_loglik.shape == (4,)
    # trace is monotone per restart (EM guarantee)
    assert (np.diff(result.ll_trace, axis=0) >= -1e-2).all()
    report = evaluate(result.states, test, result.final_loglik)
    assert 0.5 < report.auc <= 1.0
    assert report.n_test == test.n_rows


def test_checkpoint_roundtrip_and_resume(tmp_path, dataset):
    ds, _, _ = dataset
    train, _ = train_test_split(ds, 0.2, seed=0)
    ckpt = str(tmp_path / "ck.npz")

    cfg_full = _cfg(tmp_path, sweeps=40)
    full = fit(cfg_full, train)

    cfg_half = _cfg(tmp_path, sweeps=20)
    half = fit(cfg_half, train, checkpoint_path=ckpt)
    loaded = load_checkpoint(ckpt)
    assert loaded["sweep"] == 20
    assert loaded["config_json"]

    resumed = fit(cfg_full, train, resume=ckpt)
    assert resumed.sweeps_run == 40
    np.testing.assert_allclose(
        resumed.final_loglik, full.final_loglik, rtol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(resumed.states.theta), np.asarray(full.states.theta), atol=1e-4
    )


def test_text_dump_format(tmp_path):
    states = ModelState(
        theta=np.full((2, 5, 3), 1 / 3, dtype=np.float32),
        p=np.full((2, 3, 3, 3, 2), 0.5, dtype=np.float32),
    )
    out = str(tmp_path / "dump")
    write_text_dump(out, states, np.zeros((4, 2)), gene_names=list("ABCDE"))
    assert sorted(os.listdir(out)) == [
        "likelihood.txt",
        "p_s0.txt",
        "p_s1.txt",
        "theta_s0.txt",
        "theta_s1.txt",
    ]
    lines = open(os.path.join(out, "theta_s0.txt")).read().splitlines()
    assert len(lines) == 5 and lines[0].startswith("A\t")
    plines = open(os.path.join(out, "p_s1.txt")).read().splitlines()
    assert len(plines) == 27


def test_driver_fan_out_and_resume(tmp_path, dataset):
    ds, _, _ = dataset
    cfg = Config(
        train=TrainConfig(k=2, sweeps=20, samples=2, likelihood_freq=10),
        split=SplitConfig(n_folds=2, seed=0),
        mesh=MeshConfig(data=4, ensemble=1),
        out_dir=str(tmp_path / "cv"),
    )
    # Two simulated processes partition 2 folds x 2 K values = 4 units.
    recs0 = run_units(cfg, ds, k_grid=[2, 3], process_index=0, process_count=2)
    recs1 = run_units(cfg, ds, k_grid=[2, 3], process_index=1, process_count=2)
    assert len(recs0) == 2 and len(recs1) == 2
    report = merge_report(cfg.out_dir)
    assert report["summary"]["n_units"] == 4
    assert set(report["summary"]["best_k_per_fold"]) == {"0", "1"}

    # Re-run: all units are DONE -> skipped, identical report.
    recs0_again = run_units(cfg, ds, k_grid=[2, 3], process_index=0, process_count=2)
    assert [r["unit"] for r in recs0_again] == [r["unit"] for r in recs0]
    assert all(
        os.path.exists(os.path.join(cfg.out_dir, "units", f"{r['unit']}.json"))
        for r in recs0 + recs1
    )


def test_early_stop(tmp_path, dataset):
    ds, _, _ = dataset
    train, _ = train_test_split(ds, 0.2, seed=0)
    # One chain rides a slow likelihood ridge for hundreds of sweeps (real EM
    # behavior), so the all-chains criterion needs a loose tol here.
    cfg = _cfg(tmp_path, sweeps=500, tol=1.0, likelihood_freq=5)
    result = fit(cfg, train)
    assert result.sweeps_run < 500  # converged well before the cap


def test_merge_report_selects_best_k_by_heldout_likelihood(tmp_path):
    """Training likelihood grows ~monotonically with K (overfitting), so
    best-K-per-fold must come from the HELD-OUT likelihood column."""
    import json

    units = str(tmp_path / "units")
    os.makedirs(units)
    recs = [
        # K=50 "wins" on training ll but is worst held-out (overfit).
        {"unit": "fold0_k10", "fold": 0, "k": 10, "auc": 0.71,
         "average_precision": 0.3, "ll_best": -70000.0, "heldout_loglik": -19000.0},
        {"unit": "fold0_k50", "fold": 0, "k": 50, "auc": 0.55,
         "average_precision": 0.2, "ll_best": -34000.0, "heldout_loglik": -31000.0},
    ]
    for r in recs:
        with open(os.path.join(units, r["unit"] + ".json"), "w") as fh:
            json.dump(r, fh)
    report = merge_report(str(tmp_path))
    assert report["summary"]["best_k_per_fold"] == {"0": 10}


def test_evaluate_multiclass_labels():
    """n_ratings=3: AUC labels must be rating == interact class, not the
    raw rating index (which double-counts class 2 and breaks the metric)."""
    import jax

    from trigenicinteractionpredictor_tpu.data.synthetic import (
        sample_synthetic_dataset,
    )
    from trigenicinteractionpredictor_tpu.eval import evaluate
    from trigenicinteractionpredictor_tpu.models.mmsbm import ModelState, init_state

    ds, _, _ = sample_synthetic_dataset(400, 15, 3, n_ratings=3, seed=4)
    st = init_state(jax.random.key(0), ds.n_genes, 3, 3)
    states = ModelState(theta=st.theta[None], p=st.p[None])
    rep = evaluate(states, ds, interact_rating=1)
    assert 0.0 <= rep.auc <= 1.0
    assert rep.n_pos == int((ds.ratings == 1).sum())


def test_merge_report_handles_legacy_units_and_selected_mean(tmp_path):
    """Mixed-version unit dirs (records without heldout_loglik) must merge,
    and the summary reports the selected-model mean separately from the
    all-units mean."""
    units = os.path.join(tmp_path, "units")
    os.makedirs(units)
    recs = [
        {"unit": "fold0_k5", "fold": 0, "k": 5, "auc": 0.8,
         "average_precision": 0.7, "ll_best": -100.0,
         "heldout_loglik": -50.0},
        # Legacy record: no heldout_loglik key.
        {"unit": "fold0_k50", "fold": 0, "k": 50, "auc": 0.6,
         "average_precision": 0.5, "ll_best": -80.0},
    ]
    for r in recs:
        with open(os.path.join(units, r["unit"] + ".json"), "w") as fh:
            json.dump(r, fh)
    report = merge_report(str(tmp_path))
    s = report["summary"]
    # Legacy fallback is ll_best: -50 (k=5) > -80 (k=50) -> k=5 selected.
    assert s["best_k_per_fold"] == {"0": 5}
    assert abs(s["mean_auc_selected"] - 0.8) < 1e-9
    assert abs(s["mean_auc"] - 0.7) < 1e-9
