"""Legacy RX family as batched JAX models: multi-detection sync with CFO
hypothesis search (SynchEstAndFO, R4) and DSSS despreading
(SynchEstFOAndDSSS, R5).

The whole (trial, fo, delay) search cube is evaluated in one batched
FFT + matmul pass; detections are selected by an associative refractory scan;
channel estimation and the one-data-symbol-per-detection demod are vmapped
over the (fixed-size) detection table — no host sync anywhere.

Reference: LEGACY/gr-ofdm-rx/python/SynchEstAndFO.py:233-363,
SynchEstFOAndDSSS.py:269-412.  Deviation (documented, SURVEY.md §7.3): the
data path uses the per-detection winning CFO rather than the reference's
last-trial CFO (a latent bug there, invisible for its shipped fo_range=[0]).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np

import jax
import jax.numpy as jnp

from ..ops import cfo as cfo_ops
from ..ops import sync
from ..utils.params import OFDMConfig, used_bins


class LegacyRxResult(NamedTuple):
    ptrs: jnp.ndarray          # [max_det] detection frame pointers
    delays: jnp.ndarray        # [max_det] winning delay hypotheses
    peaks: jnp.ndarray         # [max_det] correlation peaks
    fo_idx: jnp.ndarray        # [max_det] winning CFO candidate index
    count: jnp.ndarray         # number of detections
    chan_freq: jnp.ndarray     # [max_det, nfft] channel estimates
    phasors: jnp.ndarray       # [max_det, num_data_bins] equalised data
    despread: jnp.ndarray      # [max_det, num_data_bins/dsss]


def rx_frame_cfo(cfg: OFDMConfig, x: jnp.ndarray, n_trials: int,
                 fo_range=(0.0,), dsss: int = 1,
                 max_det: int = 100) -> LegacyRxResult:
    """Multi-detection CFO-search RX over a sample buffer (static shapes).

    The fo axis is scanned with a running max (ops/cfo.py:cfo_search_scan) —
    peak memory is one candidate's slab, not the [p, F, m, nfft] cube — and
    the winning spectra are re-derived only at the detections for the channel
    estimate."""
    bank = cfo_ops.cfo_bank(cfg, fo_range)
    dmax_val, delay_win, fo_win = cfo_ops.cfo_search_scan(
        cfg, x, n_trials, bank)

    ptrs, (delays, fo_sel, peaks), count = sync.refractory_detect(
        cfg, dmax_val, (delay_win, fo_win, dmax_val), max_det)
    fo_sel = fo_sel.astype(jnp.int32)
    valid = jnp.arange(max_det) < count

    # channel estimate per detection (vmapped over the table)
    det_spec = cfo_ops.spectra_at_detections(
        cfg, x, jnp.where(valid, ptrs, 0), fo_sel, bank)    # [max_det, L]
    _, chan_full, _ = jax.vmap(
        lambda s, d: sync.estimate_channel(cfg, s, d))(det_spec, delays)
    chan_full = chan_full * valid[:, None]

    # one data symbol per detection (SynchEstAndFO.py:323-356)
    _, data_bins = used_bins(cfg.nfft, cfg.num_data_bins)
    data_bins = np.asarray(data_bins)
    start = ptrs + cfg.m_synch * cfg.rx_b_len
    ok = valid & (start + cfg.nfft - 1 < x.shape[0])
    start = jnp.where(ok, start, 0)
    win = cfo_ops.windows_at(x, start, np.arange(cfg.nfft)) * \
        cfo_ops.bank_select(bank, fo_sel.astype(jnp.int32))
    f = jnp.fft.fft(win, cfg.nfft, axis=-1)
    fd = f[:, data_bins]
    power = jnp.sum(jnp.abs(fd) ** 2, axis=-1, keepdims=True)
    fd = fd * jnp.sqrt(fd.shape[-1] / jnp.maximum(power, 1e-30))
    rot = jnp.exp((1j * 2.0 * jnp.pi / cfg.nfft) *
                  delays[:, None].astype(jnp.float32) *
                  jnp.asarray(data_bins, jnp.float32)[None, :])
    chan_d = chan_full[:, data_bins]
    eq = sync.mmse_gain(chan_d, cfg.snr_linear)
    phasors = fd * rot * eq * ok[:, None]

    despread = cfo_ops.dsss_despread(phasors, dsss)
    return LegacyRxResult(ptrs, delays, peaks, fo_sel, count, chan_full,
                          phasors, despread)


def make_legacy_rx(cfg: OFDMConfig, n_samples: int, fo_range=(0.0,),
                   dsss: int = 1, max_det: int = 100):
    """Jitted SynchEstAndFO / SynchEstFOAndDSSS equivalent."""
    n_trials = sync.n_trials_for(cfg, n_samples)
    return jax.jit(functools.partial(
        rx_frame_cfo, cfg, n_trials=n_trials, fo_range=tuple(fo_range),
        dsss=dsss, max_det=max_det))
