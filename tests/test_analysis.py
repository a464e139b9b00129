"""Cross-restart analysis module (reference's results-analysis helpers)."""

import json
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp

from trigenicinteractionpredictor_tpu.analysis import (
    align_groups,
    analyze_checkpoint,
    group_stability,
    restart_score_agreement,
)
from trigenicinteractionpredictor_tpu.data.synthetic import sample_synthetic_dataset
from trigenicinteractionpredictor_tpu.models.mmsbm import ModelState, init_state
from trigenicinteractionpredictor_tpu.train.checkpoint import save_checkpoint


def _ensemble(S=3, g=12, k=3, r=2, seed=0):
    keys = jax.random.split(jax.random.key(seed), S)
    return jax.vmap(lambda kk: init_state(kk, g, k, r))(keys)


def test_identical_restarts_agree_perfectly():
    st = init_state(jax.random.key(1), 10, 3, 2)
    states = ModelState(
        theta=jnp.stack([st.theta, st.theta]), p=jnp.stack([st.p, st.p])
    )
    tuples = jnp.asarray(
        np.random.default_rng(0).integers(0, 10, size=(50, 3), dtype=np.int32)
    )
    rep = restart_score_agreement(states, tuples)
    assert rep["mean_pairwise_corr"] > 0.999
    stab = group_stability(states)
    assert stab["min_alignment"] > 0.999


def test_align_groups_recovers_permutation():
    rng = np.random.default_rng(3)
    theta = rng.dirichlet(np.ones(4), size=30)
    perm = np.array([2, 0, 3, 1])
    rep = align_groups(theta, theta[:, perm])
    # column i of A matches column perm^-1... verify round trip instead:
    assert rep["mean_matched_cosine"] > 0.999
    # applying the reported permutation to B's columns recovers A
    recovered = theta[:, perm][:, rep["permutation"]]
    np.testing.assert_allclose(recovered, theta, atol=1e-12)


def test_analyze_checkpoint_full_report(tmp_path):
    ds, _, _ = sample_synthetic_dataset(300, 15, 3, seed=5)
    states = _ensemble(S=3, g=15, k=3)
    ck = str(tmp_path / "model.ckpt.npz")
    ll_trace = np.array([[-50.0, -60.0, -55.0], [-40.0, -45.0, -44.0]])
    save_checkpoint(
        ck,
        ModelState(theta=np.asarray(states.theta), p=np.asarray(states.p)),
        sweep=20,
        ll_trace=ll_trace,
    )
    rep = analyze_checkpoint(ck, tuples=ds.triplets, labels=ds.ratings)
    assert rep["n_samples"] == 3
    assert rep["best_sample"] == 0  # ll_trace final row argmax
    assert len(rep["per_sample_auc"]) == 3
    assert all(np.isfinite(a) for a in rep["per_sample_auc"])
    corr = np.asarray(rep["score_agreement"]["corr_matrix"])
    assert corr.shape == (3, 3)
    np.testing.assert_allclose(np.diag(corr), 1.0, atol=1e-9)


def test_cli_analyze(tmp_path):
    # tiny fit run then analyze its checkpoint
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ds, _, _ = sample_synthetic_dataset(400, 20, 3, seed=1)
    npz = str(tmp_path / "data.npz")
    ds.save_npz(npz)
    out = str(tmp_path / "run")
    fit = subprocess.run(
        [
            sys.executable, "-m", "trigenicinteractionpredictor_tpu", "fit",
            "-f", npz, "-k", "3", "-i", "20", "-s", "2", "-n", "10", "-o", out,
        ],
        capture_output=True, text=True, env=env, cwd=repo,
    )
    assert fit.returncode == 0, fit.stderr[-2000:]
    analysis_out = str(tmp_path / "analysis.json")
    an = subprocess.run(
        [
            sys.executable, "-m", "trigenicinteractionpredictor_tpu", "analyze",
            "--checkpoint", os.path.join(out, "model.ckpt.npz"),
            "-f", npz, "-o", analysis_out,
        ],
        capture_output=True, text=True, env=env, cwd=repo,
    )
    assert an.returncode == 0, an.stderr[-2000:]
    rep = json.load(open(analysis_out))
    assert rep["n_samples"] == 2
    assert "score_agreement" in rep and "group_stability" in rep


def test_analyze_binarizes_multiclass_labels(tmp_path):
    """Raw rating classes (0..R-1) must be binarized against the
    interaction class before per-sample AUC — at R=3 raw labels would
    corrupt the metric (round-1 advisor finding)."""
    from trigenicinteractionpredictor_tpu.analysis import analyze_checkpoint
    from trigenicinteractionpredictor_tpu.ops.metrics import auc
    from trigenicinteractionpredictor_tpu.ops.scoring import predict_interaction

    R = 3
    ds, theta, p = sample_synthetic_dataset(300, 20, 2, n_ratings=R, seed=3)
    keys = jax.random.split(jax.random.key(0), 2)
    states = jax.vmap(lambda k: init_state(k, ds.n_genes, 2, R))(keys)
    path = os.path.join(tmp_path, "ck.npz")
    save_checkpoint(
        path,
        ModelState(theta=np.asarray(states.theta), p=np.asarray(states.p)),
        5,
        np.zeros((1, 2)),
    )
    rep = analyze_checkpoint(path, tuples=ds.triplets, labels=ds.ratings)
    # Manual binarized AUC for sample 0 must match the report.
    scores0 = predict_interaction(
        ModelState(theta=states.theta[0], p=states.p[0]),
        jnp.asarray(ds.triplets),
        1,
    )
    labels_bin = jnp.asarray((ds.ratings == 1).astype(np.int32))
    expected = float(auc(scores0, labels_bin))
    assert abs(rep["per_sample_auc"][0] - expected) < 1e-6
