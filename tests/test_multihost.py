"""Real 2-process multi-host validation (SURVEY.md §3.4, §5.4).

Everything else in the suite simulates hosts with shims; this test actually
spawns two OS processes, wires them with ``jax.distributed`` over localhost
(the CPU backend's cross-process collectives), and runs one sharded EM
sweep with the triplet batch split between the processes.  Each process
asserts the psum'd result equals the full-data single-process reference.

Also guards the ``maybe_initialize`` regression where probing
``jax.process_count()`` initialized the XLA backend before
``jax.distributed.initialize`` could run.
"""

import os
import socket
import subprocess
import sys

import pytest

_WORKER = r"""
import os, sys
pid = int(sys.argv[1]); nproc = int(sys.argv[2]); port = sys.argv[3]
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax
from trigenicinteractionpredictor_tpu.parallel.distributed import maybe_initialize

topo = maybe_initialize(
    coordinator_address=f"127.0.0.1:{port}", num_processes=nproc, process_id=pid
)
assert topo.process_count == nproc, topo
assert topo.global_devices == 2 * nproc, topo

import numpy as np
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from trigenicinteractionpredictor_tpu.data.synthetic import sample_synthetic_dataset
from trigenicinteractionpredictor_tpu.models.mmsbm import init_state
from trigenicinteractionpredictor_tpu.ops.em import Batch, em_step
from trigenicinteractionpredictor_tpu.parallel.mesh import DATA_AXIS, ENSEMBLE_AXIS
from trigenicinteractionpredictor_tpu.parallel.sharded_em import make_sharded_train_step

# Full dataset is derivable on every process (same seed); each process owns
# a contiguous row shard.
ds, _, _ = sample_synthetic_dataset(256, 16, 3, seed=0)
deg = jnp.asarray(ds.degrees())
n_dev = 2 * nproc
mesh = Mesh(np.asarray(jax.devices()).reshape(1, n_dev), (ENSEMBLE_AXIS, DATA_AXIS))

rows_per_proc = ds.n_rows // nproc
lo = pid * rows_per_proc
hi = lo + rows_per_proc
row_sh = NamedSharding(mesh, P(DATA_AXIS))
batch = Batch(
    triplets=jax.make_array_from_process_local_data(row_sh, ds.triplets[lo:hi]),
    ratings=jax.make_array_from_process_local_data(row_sh, ds.ratings[lo:hi]),
    weights=jax.make_array_from_process_local_data(row_sh, ds.weights[lo:hi]),
)
rep = NamedSharding(mesh, P())
S = 1
states = jax.vmap(lambda k: init_state(k, ds.n_genes, 3, 2))(
    jax.random.split(jax.random.key(7), S)
)
states = jax.tree.map(lambda x: jax.device_put(x, NamedSharding(mesh, P(ENSEMBLE_AXIS))), states)
deg_sh = jax.device_put(deg, rep)

step = make_sharded_train_step(mesh)
new_states, ll = step(states, batch, deg_sh)

# Single-process reference on the full data.
ref_states0 = jax.vmap(lambda k: init_state(k, ds.n_genes, 3, 2))(
    jax.random.split(jax.random.key(7), S)
)
full_batch = Batch(
    triplets=jnp.asarray(ds.triplets),
    ratings=jnp.asarray(ds.ratings),
    weights=jnp.asarray(ds.weights),
)
ref_states, ref_ll = jax.vmap(em_step, in_axes=(0, None, None))(
    ref_states0, full_batch, deg
)

# Multihost outputs: fetch the replicated/addressable values.
theta = np.asarray(jax.device_get(new_states.theta))
ll_np = np.asarray(jax.device_get(ll))
np.testing.assert_allclose(theta, np.asarray(ref_states.theta), atol=1e-5)
np.testing.assert_allclose(ll_np, np.asarray(ref_ll), rtol=1e-5)
print(f"MH-OK pid={pid}", flush=True)
"""


def _spawn_workers(tmp_path, script_text, n_procs, extra_args=(), timeout=420):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    worker = tmp_path / "mh_worker.py"
    worker.write_text(script_text)
    env = dict(os.environ)
    env["PYTHONPATH"] = repo
    procs = [
        subprocess.Popen(
            [
                sys.executable, str(worker), str(pid), str(n_procs), str(port),
                *[str(a) for a in extra_args],
            ],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        )
        for pid in range(n_procs)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append((p.returncode, out))
    return outs


@pytest.mark.slow
def test_two_process_sharded_em(tmp_path):
    for rc, out in _spawn_workers(tmp_path, _WORKER, 2, timeout=240):
        assert rc == 0, out[-3000:]
        assert "MH-OK" in out, out[-3000:]


_DRIVER_WORKER = r"""
import os, sys
pid = int(sys.argv[1]); nproc = int(sys.argv[2]); port = sys.argv[3]
out_dir = sys.argv[4]
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
import jax
from trigenicinteractionpredictor_tpu.parallel.distributed import maybe_initialize

topo = maybe_initialize(
    coordinator_address=f"127.0.0.1:{port}", num_processes=nproc, process_id=pid
)
assert topo.process_count == nproc, topo

import json
from trigenicinteractionpredictor_tpu.config import Config, MeshConfig, SplitConfig, TrainConfig
from trigenicinteractionpredictor_tpu.data.synthetic import sample_synthetic_dataset
from trigenicinteractionpredictor_tpu.train.driver import merge_report, run_units

# Every process derives the same dataset and the same unit grid; units
# round-robin over process_index with NO communication until the merge.
ds, _, _ = sample_synthetic_dataset(600, 20, 3, seed=1)
cfg = Config(
    train=TrainConfig(k=3, sweeps=20, samples=2, likelihood_freq=10, seed=0),
    split=SplitConfig(n_folds=2, seed=0),
    mesh=MeshConfig(data=1, ensemble=1),
    out_dir=out_dir,
)
records = run_units(cfg, ds, k_grid=[2, 3])   # 2 folds x 2 K = 4 units
assert len(records) == 4 // nproc, (pid, len(records))
for r in records:
    assert r["process"] == pid

from jax.experimental import multihost_utils
multihost_utils.sync_global_devices("units_done")

if pid == 0:
    report = merge_report(out_dir)
    s = report["summary"]
    assert s["n_units"] == 4, s
    assert set(report["summary"]["best_k_per_fold"]) == {"0", "1"}, s
    assert 0.0 <= s["mean_auc_selected"] <= 1.0
    procs_seen = {r["process"] for r in report["units"]}
    assert procs_seen == set(range(nproc)), procs_seen
    print("MERGE-OK", json.dumps(s), flush=True)
print(f"MH-OK pid={pid}", flush=True)
"""


_ENSEMBLE_MESH_WORKER = r"""
import os, sys
pid = int(sys.argv[1]); nproc = int(sys.argv[2]); port = sys.argv[3]
out_dir = sys.argv[4]
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax
from trigenicinteractionpredictor_tpu.parallel.distributed import maybe_initialize

topo = maybe_initialize(
    coordinator_address=f"127.0.0.1:{port}", num_processes=nproc, process_id=pid
)
assert topo.process_count == nproc, topo

import json
from trigenicinteractionpredictor_tpu.config import Config, MeshConfig, SplitConfig, TrainConfig
from trigenicinteractionpredictor_tpu.data.synthetic import sample_synthetic_dataset
from trigenicinteractionpredictor_tpu.train.driver import merge_report, run_units

# cfg.mesh.ensemble=2 must be honored on each process's LOCAL 2-device
# mesh (run_units used to hardcode a data-only mesh and silently drop
# --mesh-ensemble in multi-process grid runs).
ds, _, _ = sample_synthetic_dataset(600, 20, 3, seed=1)
cfg = Config(
    train=TrainConfig(k=3, sweeps=20, samples=2, likelihood_freq=10, seed=0),
    split=SplitConfig(n_folds=2, seed=0),
    mesh=MeshConfig(data=1, ensemble=2),
    out_dir=out_dir,
)
records = run_units(cfg, ds, k_grid=[3])   # 2 folds x 1 K = 2 units
assert len(records) == 2 // nproc, (pid, len(records))

with open(os.path.join(out_dir, f"events_p{pid}.jsonl")) as fh:
    events = [json.loads(line) for line in fh]
mesh_ev = [e for e in events if e.get("event") == "local_mesh"]
assert mesh_ev and mesh_ev[0]["ensemble"] == 2 and mesh_ev[0]["data"] == 1, mesh_ev

from jax.experimental import multihost_utils
multihost_utils.sync_global_devices("units_done")
if pid == 0:
    report = merge_report(out_dir)
    assert report["summary"]["n_units"] == 2, report["summary"]
print(f"MH-OK pid={pid}", flush=True)
"""


@pytest.mark.slow
def test_two_process_driver_honors_ensemble_mesh(tmp_path):
    """A --mesh-ensemble 2 grid run builds local (ensemble=2, data=1)
    meshes instead of silently dropping the configured axes."""
    out_dir = str(tmp_path / "egrid")
    outs = _spawn_workers(
        tmp_path, _ENSEMBLE_MESH_WORKER, 2, extra_args=[out_dir], timeout=420
    )
    for rc, out in outs:
        assert rc == 0, out[-3000:]
        assert "MH-OK" in out, out[-3000:]


@pytest.mark.slow
def test_four_process_driver_partition_and_merge(tmp_path):
    """4 real processes partition the fold x K grid via run_units and host 0
    merges a complete report after the barrier (SURVEY.md §5.4)."""
    out_dir = str(tmp_path / "grid")
    outs = _spawn_workers(
        tmp_path, _DRIVER_WORKER, 4, extra_args=[out_dir], timeout=420
    )
    for rc, out in outs:
        assert rc == 0, out[-3000:]
        assert "MH-OK" in out, out[-3000:]
    assert any("MERGE-OK" in out for _, out in outs)
