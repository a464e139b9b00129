"""Tests for train/stream_prep.py (the streaming host pipeline).

The streaming trainer's host prep must be bit-equivalent between the
in-thread and the spawn-pool paths, preserve the (seed, epoch) shuffle
derivation (resume replay), keep padding inert, and leave the parent's
environment and /dev/shm as it found them.
"""

import numpy as np
import pytest

from trigenicinteractionpredictor_tpu.train.stream_prep import (
    StreamPrep,
    epoch_perm,
)


def test_epoch_perm_matches_round4_derivation():
    """Resume-replay contract: the shuffle is the same function of
    (seed, epoch) older trainers used — checkpoints that replay epochs get
    the identical minibatch sequence."""
    seed, ep, n = 3, 5, 1000
    ref = np.random.default_rng((seed ^ 0x5EED) + 7919 * (ep + 1)).permutation(n)
    got = epoch_perm(seed, ep, n)
    assert np.array_equal(got, ref)
    assert got.dtype == np.int32  # half the index memory below 2^31


def test_epoch_perm_varies_and_is_deterministic():
    n = 2048
    a = epoch_perm(0, 0, n)
    assert not np.array_equal(a, epoch_perm(0, 1, n))
    assert not np.array_equal(a, epoch_perm(1, 0, n))
    assert np.array_equal(a, epoch_perm(0, 0, n))
    assert np.array_equal(np.sort(a), np.arange(n))


def _mk_layout(n, mb, group):
    return {
        "seed": 11,
        "n": n,
        "n_padded": -(-n // mb) * mb,
        "mb": mb,
        "group": group,
        "arity": 3,
    }


@pytest.mark.parametrize("group", [1, 2])
def test_stream_prep_inthread(group):
    from trigenicinteractionpredictor_tpu.data.packing import TripletDataset

    rng = np.random.default_rng(0)
    n, mb = 500, 64
    ds = TripletDataset(
        triplets=rng.integers(0, 20, size=(n, 3), dtype=np.int32),
        ratings=rng.integers(0, 2, size=n, dtype=np.int32),
        weights=np.ones(n, np.float32),
        n_genes=20,
        n_ratings=2,
    )
    lay = _mk_layout(n, mb, group)
    sp = StreamPrep(ds, lay, workers=1)
    try:
        out = sp.prep_group(0, 0)
        assert np.asarray(out["trip"]).shape == (group, mb, 3)
        # padding rows are weight-0; real weights sum preserved across an
        # epoch's groups
        n_dispatch = lay["n_padded"] // (group * mb)
        total = sum(
            float(np.asarray(sp.prep_group(0, d)["wts"]).sum())
            for d in range(n_dispatch)
        )
        assert total == pytest.approx(float(ds.weights.sum()))
    finally:
        sp.close()


def test_stream_prep_matches_legacy_trainer_prep():
    """The in-thread StreamPrep output must equal the inline prep older
    trainers did for the same (seed, epoch, group): same permutation,
    same gather, padding rows past n as weight-0 zeros."""
    from trigenicinteractionpredictor_tpu.data.packing import TripletDataset

    rng = np.random.default_rng(2)
    n, mb, group = 700, 128, 2
    ds = TripletDataset(
        triplets=rng.integers(0, 30, size=(n, 3), dtype=np.int32),
        ratings=rng.integers(0, 2, size=n, dtype=np.int32),
        weights=rng.random(n).astype(np.float32),
        n_genes=30,
        n_ratings=2,
    )
    lay = _mk_layout(n, mb, group)
    sp = StreamPrep(ds, lay, workers=1)
    try:
        out = sp.prep_group(3, 1)
        perm = np.random.default_rng((11 ^ 0x5EED) + 7919 * 4).permutation(
            lay["n_padded"]
        )
        gp = perm[1 * group * mb : 2 * group * mb]
        mask = gp < n
        trip = np.zeros((gp.size, 3), np.int32)
        rat = np.zeros(gp.size, np.int32)
        wts = np.zeros(gp.size, np.float32)
        trip[mask] = ds.triplets[gp[mask]]
        rat[mask] = ds.ratings[gp[mask]]
        wts[mask] = ds.weights[gp[mask]]
        assert np.array_equal(np.asarray(out["trip"]), trip.reshape(group, mb, 3))
        assert np.array_equal(np.asarray(out["rat"]), rat.reshape(group, mb))
        assert np.array_equal(np.asarray(out["wts"]), wts.reshape(group, mb))
    finally:
        sp.close()


@pytest.mark.parametrize("before", [None, "cpu,gpu"])
def test_pool_start_restores_jax_platforms(monkeypatch, before):
    """Pool workers start with JAX_PLATFORMS=cpu; afterwards the parent's
    own setting is back exactly as it was (unset stays unset)."""
    import trigenicinteractionpredictor_tpu.train.stream_prep as sp_mod

    if before is None:
        monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    else:
        monkeypatch.setenv("JAX_PLATFORMS", before)
    seen = {}

    class FakePool:
        def __init__(self, **kw):
            import os

            seen["during"] = os.environ.get("JAX_PLATFORMS")

        def map(self, fn, it, chunksize=1):
            return [fn(x) for x in it]

        def shutdown(self, wait=True):
            pass

    import concurrent.futures

    monkeypatch.setattr(concurrent.futures, "ProcessPoolExecutor", FakePool)
    obj = sp_mod.StreamPrep.__new__(sp_mod.StreamPrep)
    obj._workers = 2
    obj._ds_arrays = (np.zeros((4, 3), np.int32),) * 3
    obj._layout = {}
    obj._start_pool()
    import os

    assert seen["during"] == "cpu"
    assert os.environ.get("JAX_PLATFORMS") == before


def test_close_unlinks_shm_even_when_close_raises():
    """A slot whose close() raises (a view still exported) must still have
    its /dev/shm name unlinked."""
    from multiprocessing import shared_memory

    calls = []

    class Shm:
        def close(self):
            calls.append("close")
            raise BufferError("view still exported")

        def unlink(self):
            calls.append("unlink")

    obj = StreamPrep.__new__(StreamPrep)
    obj._pool = None
    obj._slots = [{"trip": (Shm(), None), "rat": (Shm(), None)}]
    obj.close()
    assert calls == ["close", "unlink", "close", "unlink"]
    assert obj._slots == []

    # And a real segment is gone after close().
    rng = np.random.default_rng(0)
    from trigenicinteractionpredictor_tpu.data.packing import TripletDataset

    n = 256
    ds = TripletDataset(
        triplets=rng.integers(0, 10, size=(n, 3), dtype=np.int32),
        ratings=rng.integers(0, 2, size=n, dtype=np.int32),
        weights=np.ones(n, np.float32),
        n_genes=10,
        n_ratings=2,
    )
    sp = StreamPrep(ds, _mk_layout(n, 64, 2), workers=1)
    slot = sp._slot(0)
    name = slot["trip"][0].name
    sp.close()
    with pytest.raises(FileNotFoundError):
        shared_memory.SharedMemory(name=name)


@pytest.mark.slow
def test_stream_prep_pool_matches_inthread(tmp_path):
    """Spawn-pool prep must produce byte-identical batches to in-thread
    prep, reading the dataset back through its memmap files."""
    from trigenicinteractionpredictor_tpu.data.packing import TripletDataset

    rng = np.random.default_rng(1)
    n, mb, group = 1000, 128, 4
    ds = TripletDataset(
        triplets=rng.integers(0, 30, size=(n, 3), dtype=np.int32),
        ratings=rng.integers(0, 2, size=n, dtype=np.int32),
        weights=rng.random(n).astype(np.float32),
        n_genes=30,
        n_ratings=2,
    )
    ds.save_dir(str(tmp_path / "ds"))
    ds_mm = TripletDataset.load_dir(str(tmp_path / "ds"), mmap=True)

    lay = _mk_layout(n, mb, group)
    ref = StreamPrep(ds, lay, workers=1)
    pool = StreamPrep(ds_mm, lay, workers=2)
    try:
        assert pool._pool is not None, "spawn pool failed to start"
        for ep, d in [(0, 0), (0, 1), (1, 0)]:
            a = ref.prep_group(ep, d)
            b = pool.prep_group(ep, d)
            for key in a:
                assert np.array_equal(
                    np.asarray(a[key]), np.asarray(b[key])
                ), f"{key} mismatch at ep={ep} d={d}"
    finally:
        ref.close()
        pool.close()
