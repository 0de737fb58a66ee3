"""Device-mesh construction helpers.

The reference's concurrency substrate is GNU Radio's thread-per-block ring
buffers (SURVEY.md §2.8 X1/X2); the equivalent built here is a
jax.sharding.Mesh with named axes:

  "dp" — data parallel over independent frames (the analog of running many
          flowgraphs at once)
  "t"  — time/sequence parallel within one frame's sample stream (the analog
          of the streaming scheduler's overlapped work calls, X3), with
          halo exchange between neighbouring devices via lax.ppermute

The mesh is a plain reshape of ``jax.devices()``: the cards of one host are
joined all to all, so the layout follows the algorithm alone.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh


def make_mesh(n_devices: int | None = None, dp: int | None = None,
              axis_names=("dp", "t")) -> Mesh:
    """Build a (dp, t) mesh over the first n_devices jax devices.

    dp defaults to 1 (all devices on the time axis).  The time axis
    carries the halo exchange; dp (independent frames) needs no traffic
    between its groups.
    """
    devs = jax.devices()
    n = n_devices if n_devices is not None else len(devs)
    if dp is None:
        dp = 1
    assert n % dp == 0, (n, dp)
    arr = np.asarray(devs[:n]).reshape(dp, n // dp)
    return Mesh(arr, axis_names)


def time_mesh(n_devices: int | None = None) -> Mesh:
    """1-D mesh with all devices on the time axis."""
    devs = jax.devices()
    n = n_devices if n_devices is not None else len(devs)
    return Mesh(np.asarray(devs[:n]), ("t",))
