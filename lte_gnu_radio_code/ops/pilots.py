"""Scattered-pilot (reference-signal) ops: pilot symbol generation, LS
channel estimation at pilot bins, frequency interpolation, and the
pilot-equalised data demod path.

The reference derives pilot bins (SDRScript.py:63-67) but ships with
``ref_sigs = 0.0`` (SystemModel.py:30) so no pilot is ever transmitted and no
pilot-based estimator exists.  BASELINE.json configs 2-3 require an LTE-like
pilot grid with pilot channel estimation, so this module completes the
machinery as batched JAX ops:

  * pilots are known seeded QPSK values on the pilot bins of every data
    symbol (same constellation convention as the data,
    MultiAntennaSystem.py:159-165; same seeded-reference idea as the PLS
    reference signals, pls_aio.py:309-325);
  * the RX estimates H per pilot bin by least squares, averages across the
    frame's data symbols, and linearly interpolates real/imag across the
    signed-bin axis to the data-only bins — one fused, fully batched graph
    (no per-bin loops).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from ..utils.params import OFDMConfig, pilot_bin_plan, used_bins
from .modulation import QPSK_POINTS
from .sync import mmse_gain


def pilot_values(cfg: OFDMConfig) -> np.ndarray:
    """Known unit-modulus QPSK pilot values, one per pilot bin (NumPy const).

    Seeded by ``cfg.pilot_seed`` so TX and RX derive the identical sequence
    without any side channel — the analog of the PLS chain's seeded
    reference-signal generation (pls_aio.py:309-325).
    """
    n = cfg.num_pilot_bins
    rng = np.random.RandomState(cfg.pilot_seed + 1)
    return QPSK_POINTS[rng.randint(0, 4, size=n)].astype(np.complex64)


def _cir_interp_matrix(cfg: OFDMConfig) -> np.ndarray:
    """Precomputed [num_data_only_bins, num_pilot_bins] interpolation matrix.

    Transform-domain interpolation: the channel has at most cp_len time taps
    (the CP guarantees it — same structural fact the synch estimator's IFFT
    truncation view exploits, synch_and_chan_est.py:204), so H on the pilot
    bins determines the CIR by least squares and the CIR evaluates H on the
    data bins.  M = B @ pinv(A) with A/B the DFT submatrices at pilot/data
    bins; applied as ONE small complex matmul on device (NumPy constant baked
    at trace time).
    """
    p_signed, _, d_signed, _ = pilot_bin_plan(cfg)
    # Subspace dimension: at most one tap per pilot observation (else the LS
    # problem is underdetermined and pinv returns a minimum-norm CIR that
    # does NOT match the true channel).
    n_taps = min(cfg.cp_len, len(p_signed))
    # Anti-causal guard: the sync delay search leaves a residual timing
    # error of a few samples in EITHER direction, so the effective CIR seen
    # after derotation can start slightly before tap 0.  Span taps
    # [-n/4, 3n/4) instead of [0, n) — same subspace dimension, robust to
    # the residual (measured at -1 sample on the canonical Fading config).
    guard = n_taps // 4
    n = np.arange(-guard, n_taps - guard)
    a = np.exp(-2j * np.pi * np.asarray(p_signed)[:, None] * n[None, :]
               / cfg.nfft)
    b = np.exp(-2j * np.pi * np.asarray(d_signed)[:, None] * n[None, :]
               / cfg.nfft)
    return (b @ np.linalg.pinv(a)).astype(np.complex64)


def _cir_condition(cfg: OFDMConfig) -> float:
    """Condition number of the pilot-bin DFT submatrix (NumPy, trace time)."""
    p_signed, _, _, _ = pilot_bin_plan(cfg)
    n_taps = min(cfg.cp_len, len(p_signed))
    guard = n_taps // 4
    n = np.arange(-guard, n_taps - guard)
    a = np.exp(-2j * np.pi * np.asarray(p_signed)[:, None] * n[None, :]
               / cfg.nfft)
    return float(np.linalg.cond(a))


def estimate_channel_from_pilots(cfg: OFDMConfig, fd_pilots: jnp.ndarray,
                                 interp: str = "auto") -> jnp.ndarray:
    """LS estimate at pilot bins -> interpolated H at data-only bins.

    fd_pilots: [..., num_data_symb, num_pilot_bins] received pilot-bin values
    (power-normalised, timing-derotated).  Returns H at the data-only bins
    [..., num_data_only_bins] (complex), averaged over the symbol axis.

    Estimator: H_p = Y_p * conj(X_p) / (|X_p|^2 + 1/SNR) per bin — the same
    regularised-correlation form the synch-based estimator uses
    (synch_and_chan_est.py:184-185) — then interpolation to the data bins:

      interp="cir"    transform-domain LS through a min(cp_len, n_pilots)-tap
                      CIR subspace with an anti-causal guard — exact for any
                      channel + residual timing shift inside the subspace
                      (one matmul); noise amplification grows with the
                      conditioning of the pilot-bin DFT submatrix
      interp="linear" piecewise-linear re/im across the signed-bin axis
                      (the textbook scheme; edges anchored in "lte" mode)
      interp="auto"   (default) "cir" unless the pilot layout is too
                      ill-conditioned (cond > 1e4), then "linear"
    """
    p_signed, _, d_signed, _ = pilot_bin_plan(cfg)
    if interp == "auto":
        interp = ("cir" if len(p_signed) >= 2 and _cir_condition(cfg) < 1e4
                  else "linear")
    pv = jnp.asarray(pilot_values(cfg))

    snr_lin = cfg.snr_linear
    h_p = fd_pilots * jnp.conj(pv) / (jnp.abs(pv) ** 2 + 1.0 / snr_lin)
    h_p = jnp.mean(h_p, axis=-2)                            # avg over symbols
    if interp == "cir":
        m = jnp.asarray(_cir_interp_matrix(cfg))
        return jnp.einsum("dp,...p->...d", m, h_p,
                          precision=jax.lax.Precision.HIGHEST
                          ).astype(jnp.complex64)
    xp = jnp.asarray(np.asarray(p_signed, np.float32))
    xq = jnp.asarray(np.asarray(d_signed, np.float32))
    h_re = jnp.interp(xq, xp, h_p.real)
    h_im = jnp.interp(xq, xp, h_p.imag)
    return (h_re + 1j * h_im).astype(jnp.complex64)


def equalize_data_symbols_pilot(cfg: OFDMConfig, x: jnp.ndarray, lock_ptr,
                                delay_idx, num_patterns: int,
                                return_chan: bool = False):
    """Pilot-based stage B: FFT + norm + derotate + pilot chan-est + MMSE EQ.

    Mirrors ops/sync.py:equalize_data_symbols (the reference stage-B loop,
    TEST/GNU_RADIO_OFFLINE/synch_and_chan_est.py:258-284) but estimates the
    channel from the scattered pilots embedded in the data symbols instead of
    from the synch symbol.  Returns phasors
    [num_patterns * n_data, num_data_only_bins] (and, with ``return_chan``,
    the interpolated H at the data-only bins).
    """
    _, all_wrapped = used_bins(cfg.nfft, cfg.num_data_bins)
    p_signed, p_wrapped, d_signed, d_wrapped = pilot_bin_plan(cfg)
    assert len(p_signed) >= 2, "pilot equalisation needs >= 2 pilot bins"
    all_bins = np.asarray(all_wrapped)
    m0, nd = cfg.m_synch, cfg.synch_dat[1]
    block = cfg.pattern_len * cfg.rx_b_len

    k = jnp.arange(num_patterns)[:, None]
    j = jnp.arange(nd)[None, :]
    start = lock_ptr + k * block + (m0 + j) * cfg.rx_b_len
    idx = start[..., None] + jnp.arange(cfg.nfft)[None, None, :]
    f = jnp.fft.fft(x[idx], cfg.nfft, axis=-1)              # [k, j, nfft]
    fu = f[..., all_bins]                                   # pilots + data
    power = jnp.sum(jnp.abs(fu) ** 2, axis=-1, keepdims=True)
    fu = fu * jnp.sqrt(fu.shape[-1] / power)

    rot = jnp.exp((1j * 2.0 * jnp.pi / cfg.nfft) * delay_idx *
                  jnp.asarray(all_bins, jnp.float32)).astype(jnp.complex64)
    fu = fu * rot[None, None, :]

    # split the union gather into pilot / data-only columns
    pos = {b: i for i, b in enumerate(all_wrapped)}
    p_cols = np.asarray([pos[b] for b in p_wrapped])
    d_cols = np.asarray([pos[b] for b in d_wrapped])
    fp = fu[..., p_cols].reshape(num_patterns * nd, len(p_cols))
    fd = fu[..., d_cols].reshape(num_patterns * nd, len(d_cols))

    h_d = estimate_channel_from_pilots(cfg, fp)             # [B_data]
    eq = mmse_gain(h_d, cfg.snr_linear)
    out = fd * eq[None, :]
    if return_chan:
        return out, h_d
    return out
