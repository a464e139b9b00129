"""CI coverage for the parity-readiness gate (docs/PARITY.md).

Runs the full verify-parity flow on the checked-in example dataset so the
gate is known-working before the real reference/Data S1 ever appears."""

import json
import os

import numpy as np

from trigenicinteractionpredictor_tpu.config import Config, SplitConfig, TrainConfig
from trigenicinteractionpredictor_tpu.parity import (
    loader_fingerprint,
    reference_mount_status,
    run_verify_parity,
)

EXAMPLE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "datasets",
    "example_trigenic.tsv",
)


def test_reference_mount_status_shape():
    st = reference_mount_status()
    assert {"path", "present", "n_files", "files"} <= set(st)
    # Whatever the mount holds, the gate must report it without crashing;
    # nonzero means SURVEY.md [recall] claims need re-verification.
    assert st["n_files"] >= 0


def test_loader_fingerprint_counts():
    fp = loader_fingerprint(EXAMPLE)
    assert fp["n_raw_rows"] > 0
    assert sum(fp["rows_by_mutant_type"].values()) == fp["n_raw_rows"]
    tri = fp["modes"]["trigenic/abs"]
    assert tri["rows"] > 0 and tri["genes"] > 2
    assert 0 <= tri["positives"] <= tri["rows"]
    # negative-tau mode can only shrink the positive set
    assert fp["modes"]["trigenic/negative"]["positives"] <= tri["positives"]
    assert tri["dedup_delta"] >= 0
    # digenic mode extracts pair rows from the same file
    assert fp["modes"]["digenic/abs"]["rows"] > 0


def test_full_gate_end_to_end(tmp_path):
    cfg = Config(
        train=TrainConfig(k=3, sweeps=30, samples=2, likelihood_freq=10),
        split=SplitConfig(test_fraction=0.25, seed=0),
    )
    report = run_verify_parity(EXAMPLE, cfg, str(tmp_path), do_fit=True)
    art = report["artifact"]
    assert np.isfinite(art["converged"]["train_loglik_best"])
    assert 0.0 <= art["converged"]["auc"] <= 1.0
    assert len(art["predictions_head"]) > 0
    # artifacts on disk: JSON + text dumps + scores TSV
    assert (tmp_path / "verify_parity.json").exists()
    assert (tmp_path / "test_scores.tsv").exists()
    with open(tmp_path / "verify_parity.json") as fh:
        loaded = json.load(fh)
    assert loaded["loader_fingerprint"]["modes"]["trigenic/abs"]["rows"] > 0
