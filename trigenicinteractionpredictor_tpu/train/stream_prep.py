"""Host-side minibatch preparation for stepwise/streaming EM.

The beyond-HBM streaming path (train/trainer.py::_run_stepwise) can be
HOST-bound: at 10^7 memmapped rows one Python thread spends most of an
epoch on epoch-permutation generation and row gather
(tools/stepwise_host_cost.py).  A sliced Feistel permutation
(slice-computable, O(1) memory) was measured out: its numpy uint chains
lose to the native ``rng.permutation`` shuffle by 7-14x.

What ships instead:

1. The epoch permutation keeps the (seed, epoch) RNG derivation
   (replayable across resume, bit-compatible with older checkpoints) but
   is drawn as int32 (half the memory) and computed on the PREFETCH
   thread — and, in pool mode, precomputed for epoch e+1 while the last
   group of epoch e is being prepped by workers, taking its O(N) cost off
   the critical path entirely.

2. **Process-pool fan-out** (:class:`StreamPrep`): the gather scales
   across cores.  Spawn-based workers run with ``JAX_PLATFORMS=cpu`` in
   their environment (they are numpy-only and must never open the
   accelerator, which the parent process holds) and write prepared
   minibatches straight into double-buffered shared-memory slots; the
   parent ships each task only its permutation slice and device_puts the
   results.  Memmap-backed datasets are reopened by path in each worker
   (independent page-cache reads); in-memory datasets ship once at pool
   startup.  With a single spare core or tiny groups the pool is skipped
   automatically — prep then runs on the prefetch thread.

This module is imported by spawn workers, so it must NOT import jax (or
anything that does) at module scope.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

# ----------------------------------------------------------------------
# Epoch permutation — (seed, epoch) derivation, int32, cached per epoch
# ----------------------------------------------------------------------


def epoch_perm(seed: int, epoch: int, n_padded: int) -> np.ndarray:
    """(seed, epoch)-derived shuffle of the padded index space —
    replayable across resume."""
    rng = np.random.default_rng((seed ^ 0x5EED) + 7919 * (epoch + 1))
    if n_padded < 2**31:
        return rng.permutation(np.arange(n_padded, dtype=np.int32))
    return rng.permutation(n_padded)


# ----------------------------------------------------------------------
# Per-range prep (gather); pure numpy
# ----------------------------------------------------------------------


def _gather_rows(ds_arrays, n: int, idx: np.ndarray):
    """Rows for padded-index-space ``idx``; indices >= n are inert padding
    (gene 0, rating 0, weight 0 — bit-identical to pad_to())."""
    triplets, ratings, weights = ds_arrays
    arity = triplets.shape[1]
    mask = idx < n
    src = idx[mask]
    trip = np.zeros((idx.size, arity), np.int32)
    rat = np.zeros(idx.size, np.int32)
    wts = np.zeros(idx.size, np.float32)
    trip[mask] = triplets[src]
    rat[mask] = ratings[src]
    wts[mask] = weights[src]
    return trip, rat, wts


def _prep_minibatches(ds_arrays, layout: Dict, gperm: np.ndarray):
    """Gather the minibatches covered by ``gperm`` (a contiguous slice of
    the epoch permutation, a multiple of ``mb`` rows) as [g, mb, ...]
    arrays.  Runs on the prefetch thread or inside a pool worker."""
    mb = layout["mb"]
    trip, rat, wts = _gather_rows(ds_arrays, layout["n"], gperm)
    g = gperm.size // mb
    return (
        trip.reshape(g, mb, trip.shape[-1]),
        rat.reshape(g, mb),
        wts.reshape(g, mb),
    )


# --- pool worker side --------------------------------------------------

_W_DS = None       # (triplets, ratings, weights) arrays in this worker
_W_LAYOUT = None
_W_SHM: Dict[str, object] = {}


def _worker_init(ds_ref, layout):
    """Pool initializer: open the dataset (by memmap path or shipped
    arrays) once per worker."""
    global _W_DS, _W_LAYOUT
    kind, payload = ds_ref
    if kind == "mmap":
        _W_DS = tuple(np.load(p, mmap_mode="r") for p in payload)
    else:
        _W_DS = payload
    _W_LAYOUT = layout


def _attach_shm(name: str):
    from multiprocessing import shared_memory

    shm = _W_SHM.get(name)
    if shm is None:
        shm = shared_memory.SharedMemory(name=name)
        _W_SHM[name] = shm
    return shm


def _worker_task(slot_spec, gperm: np.ndarray, m_lo: int, m_hi: int):
    """Prep the minibatch range [m_lo, m_hi) from its permutation slice
    and write it into the shared-memory slot.

    ``slot_spec``: {array_name: (shm_name, shape, dtype_str)} for the
    whole group; this task writes rows [m_lo:m_hi) of the leading axis.
    """
    out = _prep_minibatches(_W_DS, _W_LAYOUT, gperm)
    for name, arr in zip(("trip", "rat", "wts"), out):
        shm_name, shape, dtype = slot_spec[name]
        dst = np.ndarray(shape, dtype=dtype, buffer=_attach_shm(shm_name).buf)
        dst[m_lo:m_hi] = arr
    return None


# --- parent side -------------------------------------------------------


class StreamPrep:
    """Prepares one dispatch group of minibatches per call, returning
    device arrays (a Batch is assembled by the trainer).

    Modes:
    - in-thread: gather on the calling (prefetch) thread;
    - pool: ``workers`` spawn processes write into one of two
      shared-memory slots (double-buffered for the one-group lookahead);
      the parent ships each task its permutation slice, precomputes the
      NEXT epoch's permutation while the last group's tasks run, and
      device_puts straight from the slot views (blocking on the slot's
      previous transfer before reuse).

    ``workers=0`` auto-selects: a pool only helps when there are spare
    cores beyond the parent/prefetch threads and enough rows per group to
    amortize task dispatch.
    """

    def __init__(
        self,
        ds,                      # TripletDataset (possibly memmap-backed)
        layout: Dict,            # see _run_stepwise for keys
        sharding=None,           # jax sharding for device_put (or None)
        workers: int = 0,
    ):
        self._ds_arrays = (ds.triplets, ds.ratings, ds.weights)
        self._layout = dict(layout)
        self._sharding = sharding
        self._pool = None
        self._slots = []         # [{name: (shm, np view)}] x 2
        self._slot_busy: list = [None, None]  # previous device arrays
        self._toggle = 0
        self._perm_cache: Dict = {}
        lay = self._layout
        self._n_dispatch = max(
            lay["n_padded"] // (lay["group"] * lay["mb"]), 1
        )
        if workers == 0:
            cpus = os.cpu_count() or 1
            rows_per_group = lay["group"] * lay["mb"]
            workers = (
                min(4, cpus - 1)
                if cpus >= 3 and rows_per_group >= 1 << 19
                else 1
            )
        self._workers = max(1, workers)
        if self._workers > 1:
            self._start_pool()

    # -- epoch permutation ----------------------------------------------

    def _perm(self, ep: int) -> np.ndarray:
        if self._perm_cache.get("ep") != ep:
            self._perm_cache = {
                "ep": ep,
                "perm": epoch_perm(
                    self._layout["seed"], ep, self._layout["n_padded"]
                ),
            }
        return self._perm_cache["perm"]

    # -- pool management ------------------------------------------------

    def _ds_ref(self):
        arrs = self._ds_arrays
        if all(isinstance(a, np.memmap) for a in arrs) and all(
            getattr(a, "filename", None) for a in arrs
        ):
            return ("mmap", [a.filename for a in arrs])
        return ("arrays", arrs)  # shipped once per worker at spawn

    def _start_pool(self):
        from concurrent.futures import ProcessPoolExecutor
        from multiprocessing import get_context

        # Spawn children inherit this environment: keep them off the
        # accelerator (workers are numpy-only), then restore the parent's
        # own JAX_PLATFORMS, whatever it was.
        saved = os.environ.get("JAX_PLATFORMS")
        os.environ["JAX_PLATFORMS"] = "cpu"
        try:
            self._pool = ProcessPoolExecutor(
                max_workers=self._workers,
                mp_context=get_context("spawn"),
                initializer=_worker_init,
                initargs=(self._ds_ref(), self._layout),
            )
            # Force worker startup now (surfaces spawn failures here, and
            # pays the import cost before the first epoch's clock starts).
            list(self._pool.map(_noop, range(self._workers), chunksize=1))
        except Exception:
            if self._pool is not None:
                self._pool.shutdown(wait=False)
            self._pool = None
            self._workers = 1
        finally:
            if saved is None:
                os.environ.pop("JAX_PLATFORMS", None)
            else:
                os.environ["JAX_PLATFORMS"] = saved

    def _slot(self, i: int):
        """Lazily create shared-memory slot i sized for one group."""
        from multiprocessing import shared_memory

        while len(self._slots) <= i:
            lay = self._layout
            g, mb, arity = lay["group"], lay["mb"], lay["arity"]
            spec = {
                "trip": ((g, mb, arity), np.int32),
                "rat": ((g, mb), np.int32),
                "wts": ((g, mb), np.float32),
            }
            slot = {}
            for name, (shape, dtype) in spec.items():
                nbytes = int(np.prod(shape)) * np.dtype(dtype).itemsize
                shm = shared_memory.SharedMemory(create=True, size=nbytes)
                slot[name] = (
                    shm, np.ndarray(shape, dtype=dtype, buffer=shm.buf)
                )
            self._slots.append(slot)
        return self._slots[i]

    # -- the public call ------------------------------------------------

    def prep_group(self, ep: int, d: int):
        """Return {trip, rat, wts} as DEVICE arrays for one dispatch
        group."""
        import jax

        lay = self._layout
        mb, g = lay["mb"], lay["group"]
        gperm = self._perm(ep)[d * g * mb : (d + 1) * g * mb]
        if self._pool is None:
            trip, rat, wts = _prep_minibatches(
                self._ds_arrays, lay, gperm
            )
        else:
            slot_i = self._toggle
            self._toggle ^= 1
            slot = self._slot(slot_i)
            if self._slot_busy[slot_i] is not None:
                # The slot's previous group may still be in host->device
                # transfer; device_put sources must not be overwritten
                # until the device buffers exist.
                jax.block_until_ready(self._slot_busy[slot_i])
                self._slot_busy[slot_i] = None
            spec = {
                name: (shm.name, view.shape, view.dtype.str)
                for name, (shm, view) in slot.items()
            }
            per = -(-g // self._workers)
            futs = [
                self._pool.submit(
                    _worker_task, spec,
                    gperm[m * mb : min(m + per, g) * mb],
                    m, min(m + per, g),
                )
                for m in range(0, g, per)
            ]
            if d == self._n_dispatch - 1:
                # Workers are crunching the epoch's last group: take the
                # NEXT epoch's O(N) permutation off the critical path.
                self._perm(ep + 1)
            for f in futs:
                f.result()  # propagate worker exceptions
            trip = slot["trip"][1]
            rat = slot["rat"][1]
            wts = slot["wts"][1]
        put = (
            (lambda a: jax.device_put(a, self._sharding))
            if self._sharding is not None
            else jax.device_put
        )
        out = {"trip": put(trip), "rat": put(rat), "wts": put(wts)}
        if self._pool is not None:
            self._slot_busy[self._toggle ^ 1] = list(out.values())
        return out

    def close(self):
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None
        for slot in self._slots:
            for shm, _ in slot.values():
                # unlink even when close() raises (e.g. BufferError while a
                # view is still referenced): the /dev/shm name must go.
                try:
                    shm.close()
                except Exception:
                    pass
                try:
                    shm.unlink()
                except Exception:
                    pass
        self._slots = []


def _noop(_):
    return None
