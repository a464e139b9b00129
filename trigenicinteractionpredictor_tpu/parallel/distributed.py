"""Multi-host bootstrap and process topology (SURVEY.md §3.4, §6).

The reference is a single CPython process with no communication backend.
Here multi-host runs use JAX's native distributed runtime: one process per
host, ``jax.distributed.initialize()`` wiring the PJRT processes together,
XLA collectives (the per-sweep stats psum) riding NCCL over NVLink within
a host and the network across hosts.  The ensemble tier (folds x K x
restarts) needs no communication at all until the final report merge —
work units partition by ``process_index`` (train/driver.py).

On a single machine nothing needs initializing; every helper degrades to
the 1-process case.  Tests exercise multi-process partitioning through the
``process_index``/``process_count`` shims on run_units (SURVEY.md §5.4).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import jax


@dataclass(frozen=True)
class ProcessTopology:
    process_index: int
    process_count: int
    local_devices: int
    global_devices: int

    @property
    def is_coordinator(self) -> bool:
        return self.process_index == 0


def maybe_initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> ProcessTopology:
    """Initialize jax.distributed when a multi-host launch is configured.

    Explicit arguments win; otherwise standard env vars
    (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID) are
    honored here.  A plain single-host run skips initialization entirely.
    """
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS"
    )
    want_multihost = coordinator_address is not None or (
        os.environ.get("JAX_NUM_PROCESSES") not in (None, "", "1")
    )
    # CRITICAL: decide via jax.distributed's own state, NOT jax.process_count()
    # — the latter initializes the XLA backend, after which
    # jax.distributed.initialize() refuses to run (it must precede any
    # backend-touching call).
    already = jax.distributed.is_initialized()
    if want_multihost and not already:
        kwargs = {}
        if coordinator_address:
            kwargs["coordinator_address"] = coordinator_address
        if num_processes is not None:
            kwargs["num_processes"] = num_processes
        elif os.environ.get("JAX_NUM_PROCESSES"):
            kwargs["num_processes"] = int(os.environ["JAX_NUM_PROCESSES"])
        if process_id is not None:
            kwargs["process_id"] = process_id
        elif os.environ.get("JAX_PROCESS_ID"):
            kwargs["process_id"] = int(os.environ["JAX_PROCESS_ID"])
        jax.distributed.initialize(**kwargs)
    return topology()


def topology() -> ProcessTopology:
    return ProcessTopology(
        process_index=jax.process_index(),
        process_count=jax.process_count(),
        local_devices=len(jax.local_devices()),
        global_devices=len(jax.devices()),
    )
