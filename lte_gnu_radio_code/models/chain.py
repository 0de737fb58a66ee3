"""Full loopback chain — the JAX replacement for ofdm_chain.py (D1) and
SDRScript.py (D2): bits -> TX -> multipath channel -> AWGN -> RX -> bits,
as ONE jitted function.

Each stage runs under a ``jax.named_scope`` (tx, channel, awgn here; sync,
lock_chanest, demod, llr in models/rxofdm.py) so a profiler trace
attributes device time per stage.

Reference: GNU-Radio-Repositories/ofdm_chain.py:81-91 (loopback flowgraph),
txrx_mod/SDRScript.py:43-161 (offline simulation driver).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np

import jax
import jax.numpy as jnp

from ..ops import channel as chan_ops
from ..utils.params import OFDMConfig
from . import rxofdm, txofdm


class ChainResult(NamedTuple):
    hard_bits: jnp.ndarray
    ber: jnp.ndarray
    phasors: jnp.ndarray
    lock_ptr: jnp.ndarray
    delay_idx: jnp.ndarray
    found: jnp.ndarray


def chain_step(cfg: OFDMConfig, bits: jnp.ndarray, key: jax.Array,
               h: jnp.ndarray, n_trials: int, num_patterns: int,
               tx_path: str | None = None, **rx_kwargs) -> ChainResult:
    with jax.named_scope("tx"):
        tx = txofdm.tx_frame(cfg, bits, tx_path)
    with jax.named_scope("channel"):
        rx_clean = chan_ops.apply_channel(tx, h, max_impulse=cfg.nfft)
    with jax.named_scope("awgn"):
        sig_pow = jnp.mean(jnp.abs(tx - jnp.mean(tx)) ** 2)  # np.var of TX
        rx = chan_ops.awgn(cfg, rx_clean, key, sig_pow)
    r = rxofdm.rx_frame(cfg, rx, n_trials, num_patterns, **rx_kwargs)
    nb = min(r.hard_bits.shape[0], bits.shape[0])
    ber = jnp.mean((r.hard_bits[:nb] != bits[:nb]).astype(jnp.float32))
    return ChainResult(r.hard_bits, ber, r.phasors, r.lock_ptr, r.delay_idx,
                       r.found)


def chain_fn(cfg: OFDMConfig, tx_path: str | None = None, **rx_kwargs):
    """The un-jitted per-frame loopback (bits, key) -> ChainResult for the
    config's canonical frame length; vmap it for a batch of frames.

    tx_path selects the TX modulator (txofdm.tx_frame).  rx_kwargs forward
    to rx_frame (fast=, genie_h=, perfect_chan_est= — the genie isolation
    mode of TEST synch_and_chan_est.py:213-215).  When ``perfect_chan_est``
    is requested without an explicit ``genie_h``, the chain's own channel
    taps are used."""
    n_samples = cfg.frame_len + cfg.nfft - 1                # + channel tail
    n_trials, num_patterns = rxofdm.plan_rx(cfg, n_samples)
    # NumPy constant, baked into the jitted program at trace time
    h = chan_ops.channel_taps(
        cfg.channel if cfg.channel != "AWGN" else "Ideal")
    if rx_kwargs.get("perfect_chan_est") and "genie_h" not in rx_kwargs:
        rx_kwargs["genie_h"] = np.concatenate(
            [h, np.zeros(cfg.nfft - len(h), h.dtype)])
    return functools.partial(
        chain_step, cfg, h=h, n_trials=n_trials, num_patterns=num_patterns,
        tx_path=tx_path, **rx_kwargs)


def make_chain(cfg: OFDMConfig, **kwargs):
    """Jitted full loopback for one frame; kwargs as for chain_fn."""
    return jax.jit(chain_fn(cfg, **kwargs))


def ber_sweep(cfg: OFDMConfig, snr_dbs, seeds=range(4)):
    """BER vs SNR sweep (BASELINE.json config 4).  Returns {snr_db: ber}."""
    out = {}
    for snr in snr_dbs:
        c = functools.partial(
            OFDMConfig, **{**cfg.__dict__, "snr_db": float(snr)})().validate()
        f = make_chain(c)
        bers = []
        for s in seeds:
            key = jax.random.PRNGKey(s)
            bits = jnp.asarray(
                np.random.default_rng(s).integers(0, 2, c.num_bits),
                dtype=jnp.int32)
            bers.append(float(f(bits, key).ber))
        out[float(snr)] = float(np.mean(bers))
    return out
