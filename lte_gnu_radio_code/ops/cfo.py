"""Carrier-frequency-offset hypothesis search and DSSS despreading ops.

The reference's CFO loop (LEGACY/gr-ofdm-rx/python/SynchEstAndFO.py:250-278)
multiplies each trial window by every CFO mixer candidate before the FFT and
keeps the (fo, delay) pair with max correlation.  Here the fo axis is just one
more batch dimension of the same batched-FFT + matmul search — the whole
(trial, fo, delay) space is evaluated in one batched, fused pass.

DSSS (SynchEstFOAndDSSS.py:253-262,392-398): ZC spreading code of length
``dsss``; despread = mean over chip groups of chips * conj(code).
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp
from jax import lax, vmap

from ..utils.params import OFDMConfig, used_bins
from .sync import sync_correlate_ifft
from .zadoff_chu import zadoff_chu


def cfo_bank(cfg: OFDMConfig, fo_range) -> np.ndarray:
    """[F, nfft] mixer bank exp(+j*2*pi*fo/fs*n) (SynchEstAndFO.py:196)."""
    return np.exp(1j * 2 * np.pi * (1.0 / cfg.fs) *
                  np.outer(np.asarray(fo_range, np.float64),
                           np.arange(cfg.nfft))).astype(np.complex64)


def dsss_code(dsss: int, prime: int = 37) -> np.ndarray:
    """ZC spreading code (SynchEstFOAndDSSS.py:253-262)."""
    return zadoff_chu(dsss, prime, parity_even=(dsss % 2 == 0))


def cfo_search_scan(cfg: OFDMConfig, x: jnp.ndarray, n_trials: int,
                    bank: np.ndarray):
    """Running-max CFO hypothesis search — lax.scan over the fo axis.

    Evaluates the same (trial, fo, delay) cube as
    sync_spectra_cfo+sync_correlate_cfo but holds only ONE fo candidate's
    spectra at a time (peak memory [p, m, nfft] + [p, L] instead of
    F x that), so a realistic sweep (the reference's +/-fo ranges,
    SynchEstAndFO.py:196) at NFFT 256..2048 stays inside device memory.

    Tie-breaking matches the flat argmax over the fo-major cube (first fo,
    then first delay), so results are identical to the materialised search.

    Returns (dmax_val [p] f32, delay_win [p] i32, fo_win [p] i32).
    """
    _, synch_bins = used_bins(cfg.nfft, cfg.num_synch_bins)
    synch_bins = np.asarray(synch_bins)
    starts = cfg.cp_len + cfg.stride * np.arange(n_trials)
    offs = (np.arange(cfg.m_synch) * cfg.rx_b_len)[:, None] + \
        np.arange(cfg.nfft)[None, :]
    idx = starts[:, None, None] + offs[None, :, :]
    win = x[idx]                                            # [p, m, nfft]

    def body(carry, fo_row):
        best_val, best_delay, best_fo, k = carry
        mixed = win * fo_row[None, None, :]
        f = jnp.fft.fft(mixed, cfg.nfft, axis=-1)
        s = f[..., synch_bins].reshape(n_trials, -1)        # [p, L]
        power = jnp.sum(jnp.abs(s) ** 2, axis=-1, keepdims=True)
        s = s * jnp.sqrt(s.shape[-1] / jnp.maximum(power, 1e-30))
        # delay axis via one inverse FFT per trial (sync_correlate_ifft
        # derivation) — ~10x fewer FLOPs than the [L]x[L,D] einsum per fo
        corr = jnp.abs(sync_correlate_ifft(cfg, s))
        val = jnp.max(corr, axis=-1)
        dly = jnp.argmax(corr, axis=-1).astype(jnp.int32)
        upd = val > best_val                                # first fo wins ties
        return (jnp.where(upd, val, best_val),
                jnp.where(upd, dly, best_delay),
                jnp.where(upd, k, best_fo), k + 1), None

    init = (jnp.full(n_trials, -jnp.inf, jnp.float32),
            jnp.zeros(n_trials, jnp.int32),
            jnp.zeros(n_trials, jnp.int32), jnp.int32(0))
    (best_val, best_delay, best_fo, _), _ = lax.scan(
        body, init, jnp.asarray(bank))
    return best_val, best_delay, best_fo


def bank_select(bank, fo_sel: jnp.ndarray) -> jnp.ndarray:
    """bank[fo_sel] without a data-dependent gather: exact one-hot select
    over the tiny candidate axis (1.0*v plus zeros is value-preserving)."""
    b = jnp.asarray(bank)
    oh = fo_sel[:, None] == jnp.arange(b.shape[0])[None, :]
    return jnp.sum(jnp.where(oh[:, :, None], b[None, :, :], 0.0), axis=1)


def windows_at(x: jnp.ndarray, ptrs: jnp.ndarray, offs) -> jnp.ndarray:
    """x[ptrs[:, None, ...] + offs] via one contiguous dynamic slice per
    pointer + static window indices (gather-free; edge padding replicates
    the gather's per-element index clamp for windows running PAST the end).

    Precondition: ptrs >= 0.  A negative pointer is start-clamped to 0 by
    dynamic_slice (the whole window shifts), which does NOT match a gather's
    per-element clamp (only the negative indices clamp to 0) — all current
    callers mask/clamp pointers to >= 0 before calling (advisor r4)."""
    offs = np.asarray(offs)
    span = int(offs.max()) + 1
    xp = jnp.pad(x, (0, span), mode="edge")
    segs = vmap(
        lambda p: lax.dynamic_slice_in_dim(xp, p, span, axis=0))(ptrs)
    return segs[:, jnp.asarray(offs)]


def spectra_at_detections(cfg: OFDMConfig, x: jnp.ndarray, ptrs: jnp.ndarray,
                          fo_sel: jnp.ndarray, bank: np.ndarray) -> jnp.ndarray:
    """Re-derive the power-normalised synch spectra ONLY at the detections,
    each mixed with its winning CFO candidate — [max_det, m*L].  Used for the
    per-detection channel estimate after the scan search."""
    _, synch_bins = used_bins(cfg.nfft, cfg.num_synch_bins)
    offs = (np.arange(cfg.m_synch) * cfg.rx_b_len)[:, None] + \
        np.arange(cfg.nfft)[None, :]
    win = windows_at(x, ptrs, offs) * bank_select(bank, fo_sel)[:, None, :]
    f = jnp.fft.fft(win, cfg.nfft, axis=-1)
    s = f[..., np.asarray(synch_bins)].reshape(ptrs.shape[0], -1)
    power = jnp.sum(jnp.abs(s) ** 2, axis=-1, keepdims=True)
    return s * jnp.sqrt(s.shape[-1] / jnp.maximum(power, 1e-30))


def sync_spectra_cfo(cfg: OFDMConfig, x: jnp.ndarray, n_trials: int,
                     bank: np.ndarray) -> jnp.ndarray:
    """Power-normalised synch-bin spectra for every (trial, fo) pair.

    Returns S [n_trials, F, m_synch*num_synch_bins].  Same window gather as
    sync_spectra, with the CFO mixer applied in time before the FFT
    (SynchEstAndFO.py:253-261).
    """
    _, synch_bins = used_bins(cfg.nfft, cfg.num_synch_bins)
    starts = cfg.cp_len + cfg.stride * np.arange(n_trials)
    offs = (np.arange(cfg.m_synch) * cfg.rx_b_len)[:, None] + \
        np.arange(cfg.nfft)[None, :]
    idx = starts[:, None, None] + offs[None, :, :]          # [p, m, nfft]
    win = x[idx]                                            # [p, m, nfft]
    mixed = win[:, None, :, :] * jnp.asarray(bank)[None, :, None, :]
    f = jnp.fft.fft(mixed, cfg.nfft, axis=-1)               # [p, F, m, nfft]
    s = f[..., np.asarray(synch_bins)]
    s = s.reshape(n_trials, bank.shape[0], -1)              # [p, F, m*L]
    power = jnp.sum(jnp.abs(s) ** 2, axis=-1, keepdims=True)
    return s * jnp.sqrt(s.shape[-1] / power)


def sync_correlate_cfo(cfg: OFDMConfig, spectra: jnp.ndarray) -> jnp.ndarray:
    """del_mat over the full (trial, fo, delay) search cube.

    spectra [p, F, L] -> corr [p, F, cp+1]; the delay axis collapses to one
    inverse FFT per (trial, fo) pair (see sync.sync_correlate_ifft).
    """
    p, f, _ = spectra.shape
    flat = sync_correlate_ifft(cfg, spectra.reshape(p * f, -1))
    return flat.reshape(p, f, -1)


def dsss_despread(phasors: jnp.ndarray, dsss: int) -> jnp.ndarray:
    """[..., B] equalised chips -> [..., B/dsss] despread symbols."""
    if dsss == 1:
        return phasors
    sc = jnp.asarray(dsss_code(dsss))
    shape = phasors.shape[:-1] + (phasors.shape[-1] // dsss, dsss)
    chips = phasors.reshape(shape)
    return jnp.mean(chips * jnp.conj(sc), axis=-1)
