"""CLI tests: fit / cv / sweep / synth / predict flows on tiny configs."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, cwd):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["PYTHONPATH"] = REPO
    res = subprocess.run(
        [sys.executable, "-m", "trigenicinteractionpredictor_tpu"] + args,
        cwd=cwd,
        env=env,
        capture_output=True,
        text=True,
        timeout=600,
    )
    assert res.returncode == 0, res.stderr[-3000:]
    return res


@pytest.fixture(scope="module")
def synth_npz(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    path = str(d / "synth.npz")
    _run(["synth", "-o", path, "-n", "2000", "-g", "30", "-k", "3"], cwd=str(d))
    return path


def test_synth_writes_npz(synth_npz):
    from trigenicinteractionpredictor_tpu.data.packing import TripletDataset

    ds = TripletDataset.load_npz(synth_npz)
    assert ds.n_rows == 2000 and ds.n_genes == 30


def test_fit_flow(tmp_path, synth_npz):
    out = str(tmp_path / "fitrun")
    res = _run(
        ["fit", "-f", synth_npz, "-k", "3", "-i", "40", "-s", "2",
         "-o", out, "--mesh-data", "2", "--mesh-ensemble", "2"],
        cwd=str(tmp_path),
    )
    rep = json.loads(res.stdout.strip().splitlines()[-1])
    assert 0.0 <= rep["auc"] <= 1.0 and rep["sweeps"] == 40
    assert os.path.exists(os.path.join(out, "model.ckpt.npz"))
    assert os.path.exists(os.path.join(out, "config.json"))
    assert os.path.exists(os.path.join(out, "params", "theta_s0.txt"))
    assert os.path.exists(os.path.join(out, "events.jsonl"))


def test_cv_flow(tmp_path, synth_npz):
    out = str(tmp_path / "cvrun")
    res = _run(
        ["cv", "-f", synth_npz, "-k", "2", "-i", "20", "--folds", "3",
         "-o", out, "--mesh-data", "4"],
        cwd=str(tmp_path),
    )
    summary = json.loads(res.stdout.strip().splitlines()[-1])
    assert summary["n_units"] == 3
    report = json.load(open(os.path.join(out, "report.json")))
    assert len(report["units"]) == 3


def test_sweep_and_predict_flow(tmp_path, synth_npz):
    out = str(tmp_path / "swrun")
    res = _run(
        ["sweep", "-f", synth_npz, "--k-grid", "2,3", "-i", "20",
         "-o", out, "--mesh-data", "4"],
        cwd=str(tmp_path),
    )
    summary = json.loads(res.stdout.strip().splitlines()[-1])
    assert summary["n_units"] == 2
    assert summary["best_k_per_fold"]["0"] in (2, 3)

    # predict from the fold0_k2 unit checkpoint
    ckpt = os.path.join(out, "units", "fold0_k2.ckpt.npz")
    assert os.path.exists(ckpt)
    pred_out = str(tmp_path / "preds.tsv")
    res = _run(
        ["predict", "-f", synth_npz, "--checkpoint", ckpt, "-o", pred_out],
        cwd=str(tmp_path),
    )
    lines = open(pred_out).read().splitlines()
    assert len(lines) == 2001  # header + rows
    vals = np.array([float(l.split("\t")[-1]) for l in lines[1:]])
    assert ((vals >= 0) & (vals <= 1)).all()
