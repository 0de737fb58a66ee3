"""Speed-of-light sync search: the delay-search correlation as a bank of
real convolutions + sliding-window Parseval normalisation.

Derivation.  The reference computes, per trial p and delay d
(gr-RXOFDM/python/synch_and_chan_est.py:148-165):

    corr[p, d] = sum_{l,k} e^{+j 2pi d b_k / N} * S_pl[k] * conj(ZC[lL+k])
    S_pl[k]    = sum_n x[cp + p*stride + l*(N+cp) + n] * e^{-j 2pi b_k n / N}

Substituting, corr[p, d] = sum_m x[cp + p*stride + m] * K_d[m] with the
*fixed* kernel  K_d[l*(N+cp) + n] = sum_k e^{-j 2pi b_k (n - d) / N} conj(ZC[lL+k]).
The whole (trial, delay) search is therefore a cross-correlation of x with
cp_len+1 length-((m0-1)*(N+cp)+N) kernels — no per-trial FFTs, no window
materialisation.  Complex arithmetic is decomposed into ONE real
`lax.conv_general_dilated` with 2 input channels (I/Q) and 2*(cp+1) output
channels, which XLA lowers to a single convolution.

The per-trial power normalisation sqrt(L / ||S_p||^2) uses Parseval: when
the synch bins are all bins except DC and Nyquist (every shipped config),
||S_p||^2 = sum_l ( N*E_l - |DC_l|^2 - |NY_l|^2 ) where E/DC/NY are
length-N box sums of |x|^2, x, (-1)^n x — three more sliding correlations.

Bit-compatibility: |corr| matches the FFT path to float32 tolerance; the
lock decision and all downstream estimates are identical (tested).
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from ..utils.params import OFDMConfig, used_bins
from .zadoff_chu import zc_for_config


@functools.lru_cache(maxsize=32)
def _kernels(cfg: OFDMConfig) -> np.ndarray:
    """[cp+1, klen] complex64 correlation kernels K_d."""
    nfft, cp, m0 = cfg.nfft, cfg.cp_len, cfg.m_synch
    signed, bins_p = used_bins(nfft, cfg.num_synch_bins)
    zc = zc_for_config(cfg).astype(np.complex128)
    L = cfg.num_synch_bins
    klen = (m0 - 1) * cfg.rx_b_len + nfft
    out = np.zeros((cp + 1, klen), dtype=np.complex128)
    n = np.arange(nfft)
    for d in range(cp + 1):
        # basis[n, k] = e^{-j 2pi b_k (n - d) / N}
        basis = np.exp(-1j * 2 * np.pi *
                       np.outer(n - d, np.asarray(bins_p)) / nfft)
        for l in range(m0):
            coeff = np.conj(zc[l * L:(l + 1) * L])
            out[d, l * cfg.rx_b_len: l * cfg.rx_b_len + nfft] += basis @ coeff
    return out.astype(np.complex64)


def _conv_bank(x: jnp.ndarray, kernels: np.ndarray,
               stride: int = 1) -> jnp.ndarray:
    """Cross-correlate [B, n] complex x with [D, klen] complex kernels via
    one real conv.  Returns complex [B, D, (n - klen)//stride + 1]; output
    position p is the window starting at x[p*stride]."""
    b, n = x.shape
    d, klen = kernels.shape
    xr = jnp.stack([x.real, x.imag], axis=1)            # [B, 2, n]
    kr, ki = kernels.real, kernels.imag
    # output channels: [d_re x D, d_im x D]
    k = np.zeros((2 * d, 2, klen), dtype=np.float32)
    k[:d, 0], k[:d, 1] = kr, -ki                        # re = xr*kr - xi*ki
    k[d:, 0], k[d:, 1] = ki, kr                         # im = xr*ki + xi*kr
    y = lax.conv_general_dilated(
        xr.astype(jnp.float32), jnp.asarray(k), (stride,), "VALID",
        dimension_numbers=("NCH", "OIH", "NCH"),
        precision=lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32)
    return (y[:, :d] + 1j * y[:, d:]).astype(jnp.complex64)


def _box_feats(x: jnp.ndarray) -> jnp.ndarray:
    """[B, 5, n] features whose length-nfft box sums give |S|^2 via Parseval:
    |x|^2, re/im of x, re/im of (-1)^n x (sign anchored to the full buffer —
    |NY|^2 is sign-invariant, so window-relative re-anchoring cancels)."""
    b, n = x.shape
    sgn = jnp.asarray((-1.0) ** np.arange(n), jnp.float32)
    return jnp.stack([
        (x.real ** 2 + x.imag ** 2),
        x.real, x.imag,
        x.real * sgn, x.imag * sgn,
    ], axis=1)


def _box_conv(feats: jnp.ndarray, nfft: int, stride: int = 1) -> tuple:
    """Box sums of the 5 features -> (e, dc2, ny2), each
    [B, (n - nfft)//stride + 1]; position p = window start feats[..., p*stride]."""
    ones = np.zeros((5, 5, nfft), dtype=np.float32)
    for i in range(5):
        ones[i, i] = 1.0
    s = lax.conv_general_dilated(
        feats, jnp.asarray(ones), (stride,), "VALID",
        dimension_numbers=("NCH", "OIH", "NCH"),
        precision=lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32)
    e = s[:, 0]
    dc2 = s[:, 1] ** 2 + s[:, 2] ** 2
    ny2 = s[:, 3] ** 2 + s[:, 4] ** 2
    return e, dc2, ny2


def _box_sums(x: jnp.ndarray, nfft: int) -> tuple:
    """Length-nfft sliding sums of |x|^2, x and (-1)^n x over [B, n]."""
    return _box_conv(_box_feats(x), nfft)


def sync_corr_abs_fast(cfg: OFDMConfig, x: jnp.ndarray,
                       n_trials: int) -> jnp.ndarray:
    """|corr| [B, n_trials, cp+1] — drop-in for
    |sync_correlate(sync_spectra(...))| (requires num_synch_bins == nfft-2).

    x: [B, n] or [n] complex.
    """
    assert cfg.num_synch_bins == cfg.nfft - 2, \
        "Parseval normalisation requires the canonical all-but-DC/Nyquist bins"
    squeeze = x.ndim == 1
    if squeeze:
        x = x[None]
    kernels = _kernels(cfg)
    klen = kernels.shape[1]
    starts = cfg.cp_len + cfg.stride * np.arange(n_trials)
    L = cfg.m_synch * cfg.num_synch_bins

    if cfg.stride == 1:
        # dense conv + slice (byte-identical to the original program, keeping
        # compiled-cache validity for the stride-1 configs)
        corr = _conv_bank(x, kernels)                   # [B, D, n-klen+1]
        corr = corr[:, :, starts]                       # [B, D, p]
        e, dc2, ny2 = _box_sums(x, cfg.nfft)
        win_pow = cfg.nfft * e - dc2 - ny2              # per window start
        # sum over the m0 CP-skipped windows of each trial
        offs = (np.arange(cfg.m_synch) * cfg.rx_b_len)[None, :] + \
            starts[:, None]
        s_pow = jnp.sum(win_pow[:, offs], axis=-1)      # [B, p]
    else:
        # strided conv: compute ONLY the trial offsets.  At the flagship's
        # own grid (stride = cp-1, synch_and_chan_est.py:81) the dense form
        # does stride x the needed work unless XLA happens to fold the
        # slice into the conv — make the stride explicit instead.
        corr = _conv_bank(x[:, cfg.cp_len:], kernels,
                          stride=cfg.stride)[:, :, :n_trials]
        feats = _box_feats(x)
        s_pow = 0.0
        for l in range(cfg.m_synch):                    # tiny (m_synch <= 5)
            off = cfg.cp_len + l * cfg.rx_b_len
            e, dc2, ny2 = _box_conv(feats[:, :, off:], cfg.nfft,
                                    stride=cfg.stride)
            s_pow = s_pow + (cfg.nfft * e - dc2 - ny2)[:, :n_trials]
    corr = jnp.swapaxes(corr, 1, 2)                     # [B, p, D]
    scale = jnp.sqrt(L / jnp.maximum(s_pow, 1e-30))
    out = jnp.abs(corr) * scale[..., None]
    return out[0] if squeeze else out
