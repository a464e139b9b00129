"""chip_smoke.py: it refuses a machine without a GPU and a directory
without the engine, and each phase runs end to end at a tiny size on the
CPU (the same code the card runs at full width)."""

import importlib.util
import json
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(rows=2000, genes=40, k=4, samples=2, sweeps=20, freq=5,
            parity_rows=512, minibatch=512, digenic_sweeps=10,
            four_card_sweeps=5)


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py")
    )
    mod = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = mod          # dataclasses look the module up
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def fitted(smoke, tmp_path_factory):
    """One tiny fit shared by the phases that read its checkpoint."""
    work = str(tmp_path_factory.mktemp("smoke"))
    sz = smoke.Sizes(**TINY)
    tsv = smoke.write_data(work, sz)
    fit = smoke.phase_fit(work, tsv, sz, card="cpu")
    return work, tsv, sz, fit


def _run_script(cwd, env_extra=None):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    env.update(env_extra or {})
    return subprocess.run(
        [sys.executable, os.path.join(cwd, "chip_smoke.py")],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300,
    )


def _printed_result(stdout):
    for line in stdout.splitlines():
        try:
            if "ok" in json.loads(line):
                return True
        except (ValueError, TypeError):
            pass
    return False


def test_refuses_cpu_only_machine():
    res = _run_script(REPO)
    assert res.returncode != 0
    assert not _printed_result(res.stdout)
    assert "no GPU" in res.stderr


def test_refuses_directory_without_the_engine(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path / "chip_smoke.py")
    res = _run_script(str(tmp_path))
    assert res.returncode != 0
    assert not _printed_result(res.stdout)


def test_phase_device_refuses_cpu(smoke):
    from trigenicinteractionpredictor_tpu.utils.device import NoGPUError

    with pytest.raises(NoGPUError):
        smoke.phase_device()


def test_phase_fit(fitted):
    _, _, sz, fit = fitted
    assert os.path.exists(fit["checkpoint"])
    assert fit["report"]["sweeps"] == sz.sweeps


def test_phase_parity(smoke, fitted):
    _, tsv, sz, fit = fitted
    smoke.phase_parity(tsv, fit["checkpoint"], sz)


def test_phase_predict(smoke, fitted):
    work, tsv, sz, fit = fitted
    smoke.phase_predict(work, tsv, fit["checkpoint"], sz)


def test_phase_digenic(smoke, fitted):
    work, tsv, sz, _ = fitted
    smoke.phase_digenic(work, tsv, sz)


def test_phase_stepwise(smoke, fitted):
    work, tsv, sz, _ = fitted
    smoke.phase_stepwise(work, tsv, sz)


def test_phase_four_cards_on_virtual_devices(smoke):
    """The multi-card meshes on four of the CPU's virtual devices."""
    smoke.phase_four_cards(smoke.Sizes(**TINY), n_cards=4)


def test_check_trace_flags_a_drop(smoke):
    smoke._check_trace([[-100.0, -50.0], [-99.0, -49.0]], "ok")
    with pytest.raises(AssertionError):
        smoke._check_trace([[-100.0], [-101.0]], "drop")
