"""OFDM modulation ops: subcarrier resource mapping, batched IFFT + CP with
the reference's two-stage per-symbol power normalisation, and symbol FFT.

Shape discipline: everything is batched over the symbol axis
([num_symb, nfft]) so XLA lowers the FFTs as one batched kernel and fuses the
elementwise normalisation around them — the reference's per-symbol Python
loops (MultiAntennaSystem.py:189-218) become a single fused graph.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

from ..utils.params import OFDMConfig, used_bins
from .zadoff_chu import zc_for_config


def resource_grid(cfg: OFDMConfig, data_symbols: jnp.ndarray) -> jnp.ndarray:
    """Scatter data symbols + ZC synch onto the [num_ofdm_symb, nfft] grid.

    ``data_symbols``: [num_data_symb, num_data_bins] complex.
    Synch symbols carry consecutive num_synch_bins-slices of the MM-long ZC
    (SynchSignal.py:34-38, MultiAntennaSystem.py:136-147).
    """
    _, synch_bins = used_bins(cfg.nfft, cfg.num_synch_bins)
    _, data_bins = used_bins(cfg.nfft, cfg.num_data_bins)
    pattern = np.asarray(cfg.symbol_pattern())
    data_rows = np.where(pattern == 1)[0]
    synch_rows = np.where(pattern == 0)[0]

    zc = zc_for_config(cfg)
    seg = cfg.num_synch_bins
    # synch symbol i within its pattern takes ZC slice (i mod m_synch)
    slice_idx = np.arange(len(synch_rows)) % cfg.m_synch
    zc_rows = zc.reshape(cfg.m_synch, seg)[slice_idx]       # [n_synch_rows, seg]

    if cfg.pilot_grid == "none":
        # Concat-based grid assembly (no scatter): used_bins places the
        # first half of each value vector on the NEGATIVE (tail) bins and
        # the second half on bins 1..h, so each row is
        #   [0 | second half | zero gap | first half]
        # and the full grid is a static row-permutation of the stacked
        # synch/data rows.  Identical values to the scatter form; avoids
        # the per-element scatter op on the TX hot path.
        def rows_from_vals(vals, nb):
            h = nb // 2
            s = vals.shape[0]
            zero1 = jnp.zeros((s, 1), jnp.complex64)
            gap = jnp.zeros((s, cfg.nfft - 2 * h - 1), jnp.complex64)
            v = vals.astype(jnp.complex64)
            return jnp.concatenate([zero1, v[:, h:], gap, v[:, :h]], axis=-1)

        srows = rows_from_vals(jnp.asarray(zc_rows), cfg.num_synch_bins)
        drows = rows_from_vals(data_symbols, cfg.num_data_bins)
        order = np.empty(cfg.num_ofdm_symb, np.int64)
        order[synch_rows] = np.arange(len(synch_rows))
        order[data_rows] = len(synch_rows) + np.arange(len(data_rows))
        return jnp.concatenate([srows, drows], axis=0)[order]

    grid = jnp.zeros((cfg.num_ofdm_symb, cfg.nfft), dtype=jnp.complex64)
    grid = grid.at[np.ix_(synch_rows, np.asarray(synch_bins))].set(jnp.asarray(zc_rows))
    if cfg.pilot_grid != "none":
        # scattered pilots carved out of the used bins (SDRScript.py:63-67
        # completed per BASELINE configs 2-3) — known QPSK values on the
        # pilot bins of every data symbol, data on the remaining bins
        from ..utils.params import pilot_bin_plan
        from .pilots import pilot_values
        _, p_wrapped, _, d_wrapped = pilot_bin_plan(cfg)
        grid = grid.at[np.ix_(data_rows, np.asarray(p_wrapped))].set(
            jnp.asarray(pilot_values(cfg))[None, :])
        data_bins = d_wrapped
    grid = grid.at[np.ix_(data_rows, np.asarray(data_bins))].set(
        data_symbols.astype(jnp.complex64))
    return grid


def cp_and_normalise(cfg: OFDMConfig, x: jnp.ndarray) -> jnp.ndarray:
    """CP prepend + the reference's two-stage per-symbol power
    normalisation (MultiAntennaSystem.multi_ant_symb_gen:189-218): scale
    each CP-extended symbol to unit mean energy, then divide by
    sqrt(np.var) (complex variance *with* mean subtraction, as np.var
    does).  x: [S, nfft] time symbols -> [S*(nfft+cp)] flat frame."""
    t = jnp.concatenate([x[:, -cfg.cp_len:], x], axis=-1)    # [S, nfft+cp]
    n = t.shape[-1]
    energy = jnp.sum(jnp.abs(t) ** 2, axis=-1, keepdims=True)
    scale = jnp.where(energy > 1e-30, jnp.sqrt(n / energy), 1.0)
    t = t * scale
    mean = jnp.mean(t, axis=-1, keepdims=True)
    p = jnp.mean(jnp.abs(t - mean) ** 2, axis=-1, keepdims=True)
    t = t / jnp.sqrt(p)
    return t.reshape(-1).astype(jnp.complex64)


def modulate(cfg: OFDMConfig, grid: jnp.ndarray) -> jnp.ndarray:
    """Batched IFFT + CP prepend + per-symbol power normalisation.

    Returns the time-domain frame [num_ofdm_symb * (nfft+cp)] complex64.
    """
    x = jnp.fft.ifft(grid, cfg.nfft, axis=-1)
    return cp_and_normalise(cfg, x)


@functools.lru_cache(maxsize=16)
def _fourstep_mats(nfft: int):
    """Cooley-Tukey N = N1*N2 factor matrices for the IDFT-as-two-matmul
    form (numpy constants, closed over at trace time).

    With k = k1*N2 + k2 and n = n1 + N1*n2:
      x[n1 + N1 n2] = (1/N) sum_k2 W2[n2,k2] * T[n1,k2]
                              * sum_k1 Xm[k1,k2] W1[n1,k1]
    where W1[n1,k1] = e^{+2pi i n1 k1/N1}, W2[n2,k2] = e^{+2pi i n2 k2/N2},
    T[n1,k2] = e^{+2pi i n1 k2/N} (twiddles).  Both contraction rounds are
    [*,N1]x[N1,N1] and [*,N2]x[N2,N2] matmuls — N*(N1+N2) FLOPs per
    symbol instead of the full DFT's N^2 (21x fewer at NFFT 2048 = 64*32),
    with no FFT op.
    """
    n1 = 1 << (int(np.log2(nfft)) + 1) // 2     # ~sqrt split, n1 >= n2
    n2 = nfft // n1
    w1 = np.exp(2j * np.pi * np.outer(np.arange(n1), np.arange(n1)) / n1)
    w2 = np.exp(2j * np.pi * np.outer(np.arange(n2), np.arange(n2)) / n2)
    tw = np.exp(2j * np.pi * np.outer(np.arange(n1), np.arange(n2)) / nfft)
    return (n1, n2, w1.astype(np.complex64), w2.astype(np.complex64),
            (tw / nfft).astype(np.complex64))


def idft_fourstep(nfft: int, grid: jnp.ndarray) -> jnp.ndarray:
    """[..., nfft] IDFT via two matmul rounds + twiddles.

    Matches jnp.fft.ifft to float32 rounding (tests)."""
    n1, n2, w1, w2, tw = _fourstep_mats(nfft)
    lead = grid.shape[:-1]
    xm = grid.reshape(*lead, n1, n2)                      # [., k1, k2]
    hp = jax.lax.Precision.HIGHEST
    # round 1: contract k1 -> A[., n1, k2], then twiddle
    a = jnp.einsum("...kj,nk->...nj", xm, jnp.asarray(w1), precision=hp)
    a = a * jnp.asarray(tw)                               # includes the 1/N
    # round 2: contract k2 -> B[., n1, n2]
    b = jnp.einsum("...nj,mj->...nm", a, jnp.asarray(w2), precision=hp)
    # n = n1 + N1*n2 -> output index order [n2, n1]
    return jnp.swapaxes(b, -1, -2).reshape(*lead, nfft)


def modulate_fourstep(cfg: OFDMConfig, grid: jnp.ndarray) -> jnp.ndarray:
    """modulate() with the IDFT as two matmul rounds (no FFT op)."""
    return cp_and_normalise(cfg, idft_fourstep(cfg.nfft, grid))


def symbol_fft(cfg: OFDMConfig, windows: jnp.ndarray) -> jnp.ndarray:
    """Batched FFT of CP-stripped symbol windows [..., nfft]."""
    return jnp.fft.fft(windows, cfg.nfft, axis=-1)
