"""Multi-host mesh construction.

Single-host multi-device runs use the meshes in parallel/mesh.py; to span
hosts, every process runs this same program and calls
:func:`init_distributed` first (standard JAX multi-controller SPMD).  The
mesh layout puts the frame axis ("dp") across hosts — independent frames
need no cross-host traffic — and the time axis ("t") within a host so the
halo `ppermute` of parallel/sharded.py stays on one host's links, per the
sharding design
of SURVEY.md §2.8/BASELINE.json.

On a single process this degrades gracefully (no-op init, local devices).
"""

from __future__ import annotations

import os

import numpy as np

import jax
from jax.sharding import Mesh


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> None:
    """jax.distributed.initialize with env-var fallbacks
    (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID)."""
    coordinator = coordinator or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if coordinator is None:
        return  # single-process run
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=int(num_processes or os.environ["JAX_NUM_PROCESSES"]),
        process_id=int(process_id or os.environ["JAX_PROCESS_ID"]))


def multihost_mesh(axis_names=("dp", "t")) -> Mesh:
    """dp = hosts, t = devices within a host."""
    devs = jax.devices()
    n_hosts = jax.process_count()
    per_host = len(devs) // n_hosts
    arr = np.asarray(devs).reshape(n_hosts, per_host)
    return Mesh(arr, axis_names)
