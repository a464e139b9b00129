"""tools/gpu_bringup.py: the trace-to-metrics reduction on a small
recorded trace, the analytic byte count, and refusal without a GPU."""

import os
import subprocess
import sys

import pytest
from jax.profiler import ProfileData

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
import gpu_bringup  # noqa: E402

TRACE = """
planes {
  id: 1
  name: "/host:CPU"
  lines { id: 1 name: "python" timestamp_ns: 0
          events { metadata_id: 1 offset_ps: 0 duration_ps: 99000000 } }
  event_metadata { key: 1 value { id: 1 name: "host work" } }
}
planes {
  id: 2
  name: "/device:GPU:0"
  lines {
    id: 1
    name: "XLA Ops"
    timestamp_ns: 1000
    events { metadata_id: 1 offset_ps: 0 duration_ps: 4000000 }
    events { metadata_id: 2 offset_ps: 2000000 duration_ps: 4000000 }
    events { metadata_id: 1 offset_ps: 10000000 duration_ps: 2000000 }
  }
  lines { id: 2 name: "XLA Modules" timestamp_ns: 0
          events { metadata_id: 3 offset_ps: 0 duration_ps: 50000000 } }
  event_metadata { key: 1 value { id: 1 name: "gemm" } }
  event_metadata { key: 2 value { id: 2 name: "scatter" } }
  event_metadata { key: 3 value { id: 3 name: "module" } }
}
"""


def test_device_op_times_reduces_a_recorded_trace():
    red = gpu_bringup.device_op_times(ProfileData.from_text_proto(TRACE))
    assert red["plane"] == "/device:GPU:0"
    assert red["per_op_ns"] == {"gemm": 6000.0, "scatter": 4000.0}
    # busy = union of [1000, 7000] and [11000, 13000]; window 1000..13000
    assert red["busy_ns"] == 8000.0
    assert red["window_ns"] == 12000.0


def test_device_op_times_needs_a_gpu_plane():
    host_only = TRACE.split("planes {\n  id: 2")[0]
    with pytest.raises(RuntimeError, match="GPU plane"):
        gpu_bringup.device_op_times(ProfileData.from_text_proto(host_only))


@pytest.mark.parametrize("k,r,nbytes", [(10, 2, 5968), (2, 2, 4 * 108), (4, 3, 4 * 358)])
def test_sweep_bytes_per_restart_row(k, r, nbytes):
    assert gpu_bringup.sweep_bytes_per_restart_row(k, r) == nbytes


def test_refuses_without_gpu(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    res = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "gpu_bringup.py"),
         "--out", str(tmp_path / "b.json")],
        env=env, capture_output=True, text=True, timeout=120,
    )
    assert res.returncode != 0 and "no GPU" in res.stderr
    assert not (tmp_path / "b.json").exists()
