"""2x2 MIMO spatial multiplexing — completing the reference's unimplemented
path.

The reference *declares* 2x2 'SpMult' (SDR profile 'WIFIMIMOSM-A',
SDRScript.py:28-41, MIMO channel tables MultiAntennaSystem.py:69-74) but
both its TX mapping and RX demod bail out:
  MultiAntennaSystem.multi_ant_binary_map:184-186  -> "not implemented yet"
  RxBasebandSystem.rx_data_demod:313-318           -> "not supported"
(The only working MIMO in the reference is the PLS suite.)

This module finishes the design as batched JAX ops:

  TX  — synch_dat = (2, nd): the two synch symbols of each pattern carry the
        ZC on antenna 0 and antenna 1 respectively (time-orthogonal pilots,
        the same trick the PLS mask uses, pls_aio.py:184-190), so the RX can
        estimate the full 2x2 channel matrix per subcarrier.  Data symbols
        carry two independent streams on the same bins.
  RX  — sync on the antenna-0 pilot (SISO search unchanged); per-bin 2x2
        LMMSE detector W = (H^H H + I/SNR)^-1 H^H via a closed-form batched
        2x2 complex inverse; per-stream LLR demap.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np

import jax
import jax.numpy as jnp

from ..ops import channel as chan_ops
from ..ops import modulation, ofdm, sync
from ..ops.zadoff_chu import zc_for_config
from ..utils.params import OFDMConfig, used_bins

# the lock search and the 2x2 LMMSE detector feed bit decisions: keep their
# float32 contractions at full precision (no reduced-precision matmul)
_HP = jax.lax.Precision.HIGHEST


class MimoRxResult(NamedTuple):
    phasors: jnp.ndarray      # [2, num_data_symb, num_data_bins]
    hard_bits: jnp.ndarray    # [2, bits_per_stream]
    lock_ptr: jnp.ndarray
    delay_idx: jnp.ndarray
    found: jnp.ndarray
    chan_freq: jnp.ndarray    # [2, 2, nfft]


def _check(cfg: OFDMConfig):
    assert cfg.num_ant_txrx == 2 and cfg.m_synch == 2, \
        "MIMO SpMult needs num_ant_txrx=2 and synch_dat=(2, nd)"


def tx_frame_mimo(cfg: OFDMConfig, bits: jnp.ndarray) -> jnp.ndarray:
    """[2, num_bits_per_stream] -> [2, frame_len] time signals.

    Pattern: [synch@ant0, synch@ant1, data x nd].  Each antenna's grid is
    modulated with the standard per-symbol normalisation; symbols where an
    antenna is silent stay zero (their rows bypass normalisation).
    """
    _check(cfg)
    _, synch_bins = used_bins(cfg.nfft, cfg.num_synch_bins)
    _, data_bins = used_bins(cfg.nfft, cfg.num_data_bins)
    zc = zc_for_config(cfg)
    pattern = np.asarray(cfg.symbol_pattern())
    synch_rows = np.where(pattern == 0)[0]
    data_rows = np.where(pattern == 1)[0]
    # ZC slices: symbol l of the pattern's 2 synch symbols carries slice l
    seg = cfg.num_synch_bins

    outs = []
    for ant in range(2):
        grid = jnp.zeros((cfg.num_ofdm_symb, cfg.nfft), jnp.complex64)
        my_rows = synch_rows[ant::2]            # antenna-alternating pilots
        zc_slice = zc[ant * seg:(ant + 1) * seg]
        grid = grid.at[np.ix_(my_rows, np.asarray(synch_bins))].set(
            jnp.asarray(zc_slice)[None, :])
        pts = modulation.bits_to_symbols(bits[ant], cfg.modulation)
        grid = grid.at[np.ix_(data_rows, np.asarray(data_bins))].set(
            pts.reshape(cfg.num_data_symb, cfg.num_data_bins))
        t = jnp.fft.ifft(grid, cfg.nfft, axis=-1)
        t = jnp.concatenate([t[:, -cfg.cp_len:], t], axis=-1)
        energy = jnp.sum(jnp.abs(t) ** 2, axis=-1, keepdims=True)
        t = t * jnp.where(energy > 1e-20,
                          jnp.sqrt(t.shape[-1] / jnp.maximum(energy, 1e-20)),
                          0.0)
        outs.append(t.reshape(-1))
    return jnp.stack(outs).astype(jnp.complex64)


def _inv2x2(h):
    """Batched closed-form inverse of [..., 2, 2] complex matrices."""
    a, b = h[..., 0, 0], h[..., 0, 1]
    c, d = h[..., 1, 0], h[..., 1, 1]
    det = a * d - b * c
    inv_det = 1.0 / det
    row0 = jnp.stack([d, -b], -1)
    row1 = jnp.stack([-c, a], -1)
    return jnp.stack([row0, row1], -2) * inv_det[..., None, None]


def rx_frame_mimo(cfg: OFDMConfig, y: jnp.ndarray, n_trials: int,
                  num_patterns: int) -> MimoRxResult:
    """[2, n] received -> two demodulated streams."""
    _check(cfg)
    _, synch_bins = used_bins(cfg.nfft, cfg.num_synch_bins)
    _, data_bins = used_bins(cfg.nfft, cfg.num_data_bins)
    synch_bins = np.asarray(synch_bins)
    data_bins = np.asarray(data_bins)
    zc = jnp.asarray(zc_for_config(cfg))
    seg = cfg.num_synch_bins
    nd = cfg.synch_dat[1]
    snr = cfg.snr_linear

    # --- sync on rx antenna 0 against the antenna-0 pilot (slice 0) -------
    # single-symbol search: reuse the SISO machinery with m_synch=1 view
    cfg1 = OFDMConfig(**{**cfg.__dict__, "synch_dat": (1, cfg.synch_dat[1]),
                         "num_ant_txrx": 1}).validate()
    spectra = sync.sync_spectra(cfg1, y[0], n_trials)       # [p, seg]
    zc0 = zc[:seg]
    dse = jnp.asarray(
        __import__("lte_gnu_radio_code.ops.zadoff_chu",
                   fromlist=["delay_search_matrix"]).delay_search_matrix(cfg1))
    prod = spectra * jnp.conj(zc0)[None, :]
    corr = jnp.abs(jnp.einsum("pl,dl->pd", prod, dse, precision=_HP))
    ptr, delay_idx, peak, found, first = sync.first_lock(cfg1, corr)

    # --- 2x2 channel estimate from the two time-orthogonal pilots ---------
    # pilot symbol l (l = 0: ant0, 1: ant1) of the locked pattern
    rot = jnp.exp((1j * 2.0 * jnp.pi / cfg.nfft) *
                  delay_idx.astype(jnp.float32) *
                  jnp.asarray(synch_bins, jnp.float32)).astype(jnp.complex64)
    # NOTE: no per-pilot power normalisation — pilot t is SILENT on the
    # other antenna, and normalising a near-zero window would blow noise up
    # to unit power and corrupt the matrix estimate.  Raw LS per bin keeps
    # the relative row/column structure; any common scalar cancels in the
    # per-stream output normalisation below.
    h = []
    for r in range(2):
        row = []
        for t in range(2):
            start = ptr + t * cfg.rx_b_len
            win = jax.lax.dynamic_slice(y[r], (start,), (cfg.nfft,))
            f = jnp.fft.fft(win, cfg.nfft)
            s = f[synch_bins]
            zc_t = zc[t * seg:(t + 1) * seg]
            est = (s * rot) * jnp.conj(zc_t)
            row.append(est)
        h.append(row)
    h_bins = jnp.stack([jnp.stack(r) for r in h])           # [2rx, 2tx, seg]
    # one common scale so 1/snr regularisation is meaningful
    h_bins = h_bins * jnp.sqrt(
        4 * seg / jnp.maximum(jnp.sum(jnp.abs(h_bins) ** 2), 1e-30))
    chan_freq = jnp.zeros((2, 2, cfg.nfft), jnp.complex64).at[
        :, :, synch_bins].set(h_bins)

    # --- per-bin LMMSE detection of every data symbol ---------------------
    m0 = cfg.m_synch
    block = cfg.pattern_len * cfg.rx_b_len
    kk = jnp.arange(num_patterns)[:, None]
    jj = jnp.arange(nd)[None, :]
    start = ptr + kk * block + (m0 + jj) * cfg.rx_b_len
    idx = start[..., None] + jnp.arange(cfg.nfft)[None, None, :]
    f = jnp.fft.fft(y[:, idx], cfg.nfft, axis=-1)           # [2, K, nd, nfft]
    fd = f[..., data_bins]                                  # [2, K, nd, B]
    rot_d = jnp.exp((1j * 2.0 * jnp.pi / cfg.nfft) *
                    delay_idx.astype(jnp.float32) *
                    jnp.asarray(data_bins, jnp.float32)).astype(jnp.complex64)
    fd = fd * rot_d
    yv = jnp.moveaxis(fd, 0, -1)[..., None]                 # [K, nd, B, 2, 1]

    hd = chan_freq[:, :, data_bins]                         # [2, 2, B]
    hd = jnp.moveaxis(hd, -1, 0)                            # [B, 2, 2]
    hh = jnp.conj(jnp.swapaxes(hd, -1, -2))
    gram = jnp.matmul(hh, hd, precision=_HP) + (1.0 / snr) * jnp.eye(
        2, dtype=hd.dtype)
    w = jnp.matmul(_inv2x2(gram), hh, precision=_HP)        # [B, 2, 2]
    xhat = jnp.matmul(w, yv, precision=_HP)[..., 0]         # [K, nd, B, 2]
    phasors = jnp.moveaxis(xhat, -1, 0).reshape(
        2, num_patterns * nd, cfg.num_data_bins)
    # per-stream unit average power (common-scalar ambiguity between the
    # pilot and data TX normalisations cancels here)
    p_s = jnp.mean(jnp.abs(phasors) ** 2, axis=(1, 2), keepdims=True)
    phasors = phasors * jax.lax.rsqrt(jnp.maximum(p_s, 1e-30))

    hards = []
    for ant in range(2):
        if cfg.modulation == "QPSK":
            hh_, _, _ = modulation.qpsk_llr(phasors[ant])
        else:
            hh_, _ = modulation.maxlog_llr(phasors[ant], cfg.modulation,
                                           1.0 / snr)
        hards.append(hh_)
    return MimoRxResult(phasors, jnp.stack(hards), ptr, delay_idx, found,
                        chan_freq)


# ---------------------------------------------------------------------------
# STCode — Alamouti 2x2 space-time block code
# ---------------------------------------------------------------------------
#
# The reference declares MIMO_method in {'SpMult', 'STCode'}
# (RxBasebandSystem.rx_data_demod:313-318, profile SDRScript.py:28-41) but
# implements neither; SpMult is completed above, STCode here.  Code matrix
# (Alamouti): per subcarrier and per pair of consecutive data symbols,
#   slot t  : ant0 -> s0,          ant1 -> s1
#   slot t+1: ant0 -> -conj(s1),   ant1 -> conj(s0)
# RX combining over both rx antennas with the 2x2 pilot channel estimate:
#   s0_hat = sum_r conj(h_r0) y_r(t) + h_r1 conj(y_r(t+1))
#   s1_hat = sum_r conj(h_r1) y_r(t) - h_r0 conj(y_r(t+1))
# normalised by sum |h|^2 + 2/SNR.  Rate 1 (SISO throughput, cfg.num_bits
# bits/frame) with full 4-branch diversity — vs SpMult's rate 2.


class StcRxResult(NamedTuple):
    phasors: jnp.ndarray      # [num_data_symb, num_data_bins]
    hard_bits: jnp.ndarray    # [num_bits]
    lock_ptr: jnp.ndarray
    delay_idx: jnp.ndarray
    found: jnp.ndarray
    chan_freq: jnp.ndarray    # [2, 2, nfft]


def _check_stc(cfg: OFDMConfig):
    _check(cfg)
    assert cfg.synch_dat[1] % 2 == 0, \
        "STCode pairs consecutive data symbols; synch_dat[1] must be even"


def tx_frame_stcode(cfg: OFDMConfig, bits: jnp.ndarray) -> jnp.ndarray:
    """bits [cfg.num_bits] -> [2, frame_len] Alamouti-encoded time signals.

    Same time-orthogonal ZC pilot scheme as tx_frame_mimo (the RX needs the
    full 2x2 matrix).  Paired data symbols share one normalisation factor so
    the conjugate code structure survives the TX power normalisation exactly
    (for equal-energy constellations the per-symbol and per-pair factors
    coincide; for QAM they would not)."""
    _check_stc(cfg)
    _, synch_bins = used_bins(cfg.nfft, cfg.num_synch_bins)
    _, data_bins = used_bins(cfg.nfft, cfg.num_data_bins)
    zc = zc_for_config(cfg)
    pattern = np.asarray(cfg.symbol_pattern())
    synch_rows = np.where(pattern == 0)[0]
    data_rows = np.where(pattern == 1)[0]
    seg = cfg.num_synch_bins

    pts = modulation.bits_to_symbols(bits, cfg.modulation).reshape(
        cfg.num_data_symb // 2, 2, cfg.num_data_bins)
    s0, s1 = pts[:, 0], pts[:, 1]                         # [pairs, B]
    ant_rows = {
        0: jnp.stack([s0, -jnp.conj(s1)], 1).reshape(-1, cfg.num_data_bins),
        1: jnp.stack([s1, jnp.conj(s0)], 1).reshape(-1, cfg.num_data_bins),
    }

    outs = []
    for ant in range(2):
        grid = jnp.zeros((cfg.num_ofdm_symb, cfg.nfft), jnp.complex64)
        my_rows = synch_rows[ant::2]
        zc_slice = zc[ant * seg:(ant + 1) * seg]
        grid = grid.at[np.ix_(my_rows, np.asarray(synch_bins))].set(
            jnp.asarray(zc_slice)[None, :])
        grid = grid.at[np.ix_(data_rows, np.asarray(data_bins))].set(
            ant_rows[ant])
        t = jnp.fft.ifft(grid, cfg.nfft, axis=-1)
        t = jnp.concatenate([t[:, -cfg.cp_len:], t], axis=-1)
        energy = jnp.sum(jnp.abs(t) ** 2, axis=-1)
        # shared normalisation per data pair (pilot rows keep their own)
        is_data = jnp.asarray(pattern == 1)
        pair_id = jnp.cumsum(is_data.astype(jnp.int32)) - 1    # 0,1,2,...
        pair_id = jnp.where(is_data, pair_id // 2, -1)
        pair_energy = jnp.zeros(cfg.num_data_symb // 2 + 1,
                                jnp.float32).at[pair_id].add(
            jnp.where(is_data, energy, 0.0), mode="drop")
        e_eff = jnp.where(is_data, pair_energy[pair_id] / 2.0, energy)
        t = t * jnp.where(e_eff > 1e-20,
                          jnp.sqrt(t.shape[-1] / jnp.maximum(e_eff, 1e-20)),
                          0.0)[:, None]
        outs.append(t.reshape(-1))
    return jnp.stack(outs).astype(jnp.complex64)


def rx_frame_stcode(cfg: OFDMConfig, y: jnp.ndarray, n_trials: int,
                    num_patterns: int) -> StcRxResult:
    """[2, n] received -> one Alamouti-combined stream."""
    _check_stc(cfg)
    _, synch_bins = used_bins(cfg.nfft, cfg.num_synch_bins)
    _, data_bins = used_bins(cfg.nfft, cfg.num_data_bins)
    synch_bins = np.asarray(synch_bins)
    data_bins = np.asarray(data_bins)
    zc = jnp.asarray(zc_for_config(cfg))
    seg = cfg.num_synch_bins
    nd = cfg.synch_dat[1]
    snr = cfg.snr_linear

    # --- sync + 2x2 channel estimate: identical to SpMult -----------------
    from ..ops.zadoff_chu import delay_search_matrix

    cfg1 = OFDMConfig(**{**cfg.__dict__, "synch_dat": (1, cfg.synch_dat[1]),
                         "num_ant_txrx": 1}).validate()
    spectra = sync.sync_spectra(cfg1, y[0], n_trials)
    dse = jnp.asarray(delay_search_matrix(cfg1))
    prod = spectra * jnp.conj(zc[:seg])[None, :]
    corr = jnp.abs(jnp.einsum("pl,dl->pd", prod, dse, precision=_HP))
    ptr, delay_idx, peak, found, first = sync.first_lock(cfg1, corr)

    rot = jnp.exp((1j * 2.0 * jnp.pi / cfg.nfft) *
                  delay_idx.astype(jnp.float32) *
                  jnp.asarray(synch_bins, jnp.float32)).astype(jnp.complex64)
    h = []
    for r in range(2):
        row = []
        for t in range(2):
            start = ptr + t * cfg.rx_b_len
            win = jax.lax.dynamic_slice(y[r], (start,), (cfg.nfft,))
            f = jnp.fft.fft(win, cfg.nfft)
            row.append((f[synch_bins] * rot) * jnp.conj(zc[t * seg:(t + 1) * seg]))
        h.append(row)
    h_bins = jnp.stack([jnp.stack(r) for r in h])           # [2rx, 2tx, seg]
    h_bins = h_bins * jnp.sqrt(
        4 * seg / jnp.maximum(jnp.sum(jnp.abs(h_bins) ** 2), 1e-30))
    chan_freq = jnp.zeros((2, 2, cfg.nfft), jnp.complex64).at[
        :, :, synch_bins].set(h_bins)

    # --- gather data symbols, derotate -------------------------------------
    m0 = cfg.m_synch
    block = cfg.pattern_len * cfg.rx_b_len
    kk = jnp.arange(num_patterns)[:, None]
    jj = jnp.arange(nd)[None, :]
    start = ptr + kk * block + (m0 + jj) * cfg.rx_b_len
    idx = start[..., None] + jnp.arange(cfg.nfft)[None, None, :]
    f = jnp.fft.fft(y[:, idx], cfg.nfft, axis=-1)           # [2, K, nd, nfft]
    fd = f[..., data_bins]
    rot_d = jnp.exp((1j * 2.0 * jnp.pi / cfg.nfft) *
                    delay_idx.astype(jnp.float32) *
                    jnp.asarray(data_bins, jnp.float32)).astype(jnp.complex64)
    fd = fd * rot_d                                         # [2, K, nd, B]

    # --- Alamouti combining per bin per pair --------------------------------
    pairs = fd.reshape(2, num_patterns, nd // 2, 2, cfg.num_data_bins)
    y_t, y_t1 = pairs[:, :, :, 0], pairs[:, :, :, 1]        # [2rx, K, P, B]
    hd = chan_freq[:, :, data_bins]                         # [2rx, 2tx, B]
    h0 = hd[:, 0][:, None, None, :]                         # [2rx, 1, 1, B]
    h1 = hd[:, 1][:, None, None, :]
    s0 = jnp.sum(jnp.conj(h0) * y_t + h1 * jnp.conj(y_t1), axis=0)
    s1 = jnp.sum(jnp.conj(h1) * y_t - h0 * jnp.conj(y_t1), axis=0)
    norm = jnp.sum(jnp.abs(hd) ** 2, axis=(0, 1))[None, None, :] + 2.0 / snr
    shat = jnp.stack([s0 / norm, s1 / norm], axis=2)        # [K, P, 2, B]
    phasors = shat.reshape(num_patterns * nd, cfg.num_data_bins)
    p_s = jnp.mean(jnp.abs(phasors) ** 2)
    phasors = phasors * jax.lax.rsqrt(jnp.maximum(p_s, 1e-30))

    if cfg.modulation == "QPSK":
        hard, _, _ = modulation.qpsk_llr(phasors)
    else:
        hard, _ = modulation.maxlog_llr(phasors, cfg.modulation, 1.0 / snr)
        hard = hard.reshape(-1)
    return StcRxResult(phasors, hard, ptr, delay_idx, found, chan_freq)


def make_stcode_chain(cfg: OFDMConfig, channel: str = "Fading"):
    """bits [cfg.num_bits], seed -> (ber, found, lock_ptr) 2x2 STC loopback."""
    _check_stc(cfg)
    n = cfg.frame_len + cfg.nfft - 1
    cfg1 = OFDMConfig(**{**cfg.__dict__, "synch_dat": (1, cfg.synch_dat[1]),
                         "num_ant_txrx": 1}).validate()
    n_trials = sync.n_trials_for(cfg1, n)
    block = cfg.pattern_len * cfg.rx_b_len
    avail = n - cfg.cp_len - (cfg.pattern_len - 1) * cfg.rx_b_len - cfg.nfft
    num_patterns = max(0, min(cfg.num_patterns, avail // block + 1))
    h = chan_ops.mimo2_taps(channel)

    def step(bits, seed):
        key = jax.random.fold_in(jax.random.PRNGKey(0), seed)
        tx = tx_frame_stcode(cfg, bits)
        rx = chan_ops.apply_channel_mimo(tx, h)[:, :n]
        sig_pow = jnp.mean(jnp.abs(tx) ** 2)
        nv = chan_ops.noise_variance(cfg, sig_pow)
        kr, ki = jax.random.split(key)
        noise = (jax.random.normal(kr, rx.shape) +
                 1j * jax.random.normal(ki, rx.shape))
        rx = rx + jnp.sqrt(nv / 2.0).astype(jnp.float32) * noise.astype(
            jnp.complex64)
        r = rx_frame_stcode(cfg, rx, n_trials, num_patterns)
        nb = min(r.hard_bits.shape[0], bits.shape[0])
        ber = jnp.mean((r.hard_bits[:nb] != bits[:nb]).astype(jnp.float32))
        return ber, r.found, r.lock_ptr

    return jax.jit(step)


def make_mimo_chain(cfg: OFDMConfig, channel: str = "Fading"):
    """bits [2, bits/stream], seed -> (ber [2], found) full 2x2 loopback."""
    _check(cfg)
    n = cfg.frame_len + cfg.nfft - 1
    cfg1 = OFDMConfig(**{**cfg.__dict__, "synch_dat": (1, cfg.synch_dat[1]),
                         "num_ant_txrx": 1}).validate()
    n_trials = sync.n_trials_for(cfg1, n)
    block = cfg.pattern_len * cfg.rx_b_len
    avail = n - cfg.cp_len - (cfg.pattern_len - 1) * cfg.rx_b_len - cfg.nfft
    num_patterns = max(0, min(cfg.num_patterns, avail // block + 1))
    h = chan_ops.mimo2_taps(channel)

    def step(bits, seed):
        key = jax.random.fold_in(jax.random.PRNGKey(0), seed)
        tx = tx_frame_mimo(cfg, bits)
        rx = chan_ops.apply_channel_mimo(tx, h)[:, :n]
        sig_pow = jnp.mean(jnp.abs(tx) ** 2)
        nv = chan_ops.noise_variance(cfg, sig_pow)
        kr, ki = jax.random.split(key)
        noise = (jax.random.normal(kr, rx.shape) +
                 1j * jax.random.normal(ki, rx.shape))
        rx = rx + jnp.sqrt(nv / 2.0).astype(jnp.float32) * noise.astype(
            jnp.complex64)
        r = rx_frame_mimo(cfg, rx, n_trials, num_patterns)
        nb = min(r.hard_bits.shape[1], bits.shape[1])
        ber = jnp.mean((r.hard_bits[:, :nb] != bits[:, :nb])
                       .astype(jnp.float32), axis=1)
        return ber, r.found, r.lock_ptr

    return jax.jit(step)
