"""Aux-subsystem tests: profiling helpers, distributed topology, integrity
sentinel, JSONL logger (SURVEY.md §6)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np

from trigenicinteractionpredictor_tpu.parallel.distributed import (
    maybe_initialize,
    topology,
)
from trigenicinteractionpredictor_tpu.utils.integrity import check_em_integrity
from trigenicinteractionpredictor_tpu.utils.logging import JsonlLogger
from trigenicinteractionpredictor_tpu.utils.profiling import SweepTimer, timed


def test_topology_single_process():
    topo = topology()
    assert topo.process_count == 1 and topo.is_coordinator
    assert topo.local_devices == 8  # virtual CPU mesh from conftest


def test_maybe_initialize_noop_on_single_host():
    topo = maybe_initialize()
    assert topo.process_count == 1


def test_timed_and_sync():
    f = jax.jit(lambda x: x * 2 + 1)
    x = jnp.ones((128, 128))
    dt, out = timed(f, x, iters=3)
    assert dt >= 0
    np.testing.assert_allclose(np.asarray(out)[0, 0], 3.0)
    assert out.is_ready()


def test_sweep_timer():
    t = SweepTimer(n_triplets=1000)
    t.tick(5)
    assert t.sweeps == 5 and t.triplets_per_sec > 0


def test_integrity_check_noop_on_cpu():
    # Tests run on CPU: the probe short-circuits to True.
    assert check_em_integrity() is True


def test_jsonl_logger_writes_records(tmp_path):
    path = str(tmp_path / "ev.jsonl")
    with JsonlLogger(path, echo=False) as log:
        log.log("sweep", sweep=1, ll=-12.5)
        log.log("done", n=np.int64(3))
    recs = [json.loads(l) for l in open(path)]
    assert recs[0]["event"] == "sweep" and recs[0]["ll"] == -12.5
    assert recs[1]["n"] == 3  # numpy scalar serialized


def test_profiler_trace_writes_files(tmp_path):
    from trigenicinteractionpredictor_tpu.utils.profiling import trace

    d = str(tmp_path / "prof")
    with trace(d):
        jax.jit(lambda x: x + 1)(jnp.ones(8)).block_until_ready()
    # jax.profiler writes a plugins/profile/<ts>/ tree
    found = []
    for root, _, files in os.walk(d):
        found.extend(files)
    assert found, "no trace files written"
