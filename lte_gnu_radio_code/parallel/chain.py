"""Multi-chip full loopback chain: dp (frames) x t (time within frame).

The dp axis carries independent frames — the analog of running many GNU Radio
flowgraphs concurrently; the t axis shards each frame's sample stream with
halo exchange (see parallel/sharded.py).  Both are expressed as one
shard_map'ed SPMD program over a 2-D Mesh, the collectives (ppermute halo,
pmin lock merge, psum phasor scatter) riding the links between devices.

This is the program the driver dry-runs over an N-virtual-device mesh.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..models import txofdm
from ..ops import channel as chan_ops
from ..utils.params import OFDMConfig
from . import sharded


def _frame_fn(cfg: OFDMConfig, h: jnp.ndarray, n: int, n_pad: int,
              num_patterns: int, t_shards: int, bits: jnp.ndarray,
              seed: jnp.ndarray):
    """One frame end-to-end; TX replicated within the t group, RX t-sharded."""
    key = jax.random.fold_in(jax.random.PRNGKey(0), seed)
    tx = txofdm.tx_frame(cfg, bits)
    rx_clean = chan_ops.apply_channel(tx, h, max_impulse=cfg.nfft)
    sig_pow = jnp.mean(jnp.abs(tx - jnp.mean(tx)) ** 2)
    rx = chan_ops.awgn(cfg, rx_clean, key, sig_pow)
    rx = jnp.pad(rx, (0, n_pad - rx.shape[0]))

    i_t = lax.axis_index("t")
    local = n_pad // t_shards
    x_local = lax.dynamic_slice(rx, (i_t * local,), (local,))
    r = sharded._local_rx(cfg, x_local, axis="t", n_shards=t_shards,
                          n_global=n, num_patterns=num_patterns)
    nb = min(r.hard_bits.shape[0], bits.shape[0])
    ber = jnp.mean((r.hard_bits[:nb] != bits[:nb]).astype(jnp.float32))
    return ber, r.found, r.lock_ptr


def make_sharded_chain(cfg: OFDMConfig, mesh: Mesh):
    """Jitted (bits [B, num_bits], seeds [B] int32) -> (ber, found, lock) [B].

    B must be divisible by mesh.shape['dp']; frames are sharded over dp and
    each frame's RX is time-sharded over t.
    """
    from ..models.rxofdm import plan_rx

    n = cfg.frame_len + cfg.nfft - 1
    t_shards = mesh.shape["t"]
    n_pad = sharded.padded_len(cfg, n, t_shards)
    _, num_patterns = plan_rx(cfg, n)
    # NumPy constant, traced into the program
    h = chan_ops.channel_taps(
        cfg.channel if cfg.channel != "AWGN" else "Ideal")

    frame = functools.partial(_frame_fn, cfg, h, n, n_pad, num_patterns,
                              t_shards)

    def body(bits_local, seeds_local):
        bers, founds, locks = jax.vmap(frame)(bits_local, seeds_local)
        return bers, founds, locks

    fn = shard_map(
        body, mesh=mesh,
        in_specs=(P("dp", None), P("dp")),
        out_specs=(P("dp"), P("dp"), P("dp")),
        check_vma=False)
    return jax.jit(fn)
