"""Multi-detection RX — the flagship gr-RXOFDM continuous semantics, batched.

The single-lock path (models/rxofdm.py) replicates the offline R10 block
(lock once, demodulate everything with one channel estimate).  The block the
D1 loopback app actually runs is different: its work() keeps a 100-row
`time_synch_ref` table and, for EVERY un-refractory gate crossing, refreshes
the channel estimate and demodulates that detection's data with its own
estimate (gr-RXOFDM/python/synch_and_chan_est.py:167-179 detection table,
:181-221 per-detection channel estimate, :224-250 per-detection demod).
That is what makes the receiver track timing drift and channel changes over
a continuously replayed stream.

Batched formulation: the delay-search correlation is one batched IFFT,
conv bank or matmul (ops/sync, ops/fast_sync); the sequential refractory
rule is a tiny lax.scan over per-trial peaks (ops/sync.refractory_detect);
the per-detection channel estimates and data demods are a single vmapped
gather+FFT batch over the fixed [max_det] detection table.  No host sync
anywhere.

Oracle: reference_cpu/golden.py:rx_stream (tests/test_stream_rx.py asserts
bit-exact hard bits and detection tables against it, including under
injected timing drift and a mid-stream channel change).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np

import jax
import jax.numpy as jnp

from ..ops import modulation, sync
from ..utils.params import OFDMConfig, used_bins


class DetectionsOut(NamedTuple):
    ptrs: jnp.ndarray      # [max_det] i32 global sample pointer per detection
    delays: jnp.ndarray    # [max_det] i32 winning delay hypothesis
    peaks: jnp.ndarray     # [max_det] f32 correlation peak
    count: jnp.ndarray     # scalar i32 — number of valid detections
    valid: jnp.ndarray     # [max_det] bool — slot holds a detection
    demod_ok: jnp.ndarray  # [max_det] bool — data window fit inside buffer
    chans: jnp.ndarray     # [max_det, nfft] c64 per-detection channel estimate
    phasors: jnp.ndarray   # [max_det, nd, num_data_bins] equalised IQ
    hard_bits: jnp.ndarray  # [max_det, nd*num_data_bins*bits_per_bin] i32


_SQRT2 = 1.414213562373095
_HALF_SQRT2 = 0.7071067811865476


def hard_decide(cfg: OFDMConfig, phasors: jnp.ndarray) -> jnp.ndarray:
    """Reference hard bits per rail, shape-preserving and sigma-free.

    The sign test of the LLR demap (BitRecovery.py:155-157) reduces to a
    comparison of `er` against K/2 per rail (the noise scale dfact cancels),
    which makes hard bits independent of the batch they were demapped in —
    so chunked and whole-buffer runs are bit-identical by construction.

    Note the reference quirk this preserves: because the far hypothesis is
    scored as -(K - er) (BitRecovery.py:105-125), a component that OVERSHOOTS
    its constellation point by more than K/2 (i.e. |comp| > sqrt(2)) flips
    the decided bit.  rail layout: even index = real rail, odd = imag.
    """
    if cfg.modulation == "QPSK":
        def rail(comp):
            er = jnp.abs(jnp.abs(comp) - _HALF_SQRT2)
            pos = comp >= 0
            return jnp.where(pos, er > _HALF_SQRT2,
                             er < _HALF_SQRT2).astype(jnp.int32)
        b0 = rail(phasors.real)
        b1 = rail(phasors.imag)
        return jnp.stack([b0, b1], axis=-1).reshape(*phasors.shape[:-1], -1)
    hard, _ = modulation.maxlog_llr(phasors, cfg.modulation, 1.0)
    return hard.reshape(*phasors.shape[:-1], -1)


def detect_trials(cfg: OFDMConfig, x: jnp.ndarray, n_trials: int,
                  fast: bool | str | None = None):
    """Per-trial (peak, delay) over the dense sync search.  Returns
    (dmax_val [p] f32, dmax_ind [p] i32).  fast: see rx_frame — None
    defaults to the "ifft" correlate (one inverse FFT per trial)."""
    if fast is None:
        fast = "ifft"
    if fast in ("ifft", "exact", False):
        spectra = sync.sync_spectra(cfg, x, n_trials)
        corr = sync.corr_abs_from_spectra(cfg, spectra, fast)
    elif fast in (True, "conv"):
        from ..ops import fast_sync
        corr = fast_sync.sync_corr_abs_fast(cfg, x, n_trials)
    else:
        raise ValueError(f"detect_trials: unknown sync path fast={fast!r}")
    return jnp.max(corr, axis=-1), jnp.argmax(corr, axis=-1).astype(jnp.int32)


@functools.lru_cache(maxsize=32)
def _dft_bins(nfft: int, num_bins: int):
    """[nfft, B] DFT basis restricted to the used bins (numpy constant)."""
    _, bins = used_bins(nfft, num_bins)
    n = np.arange(nfft)
    return np.exp(-2j * np.pi * np.outer(n, np.asarray(bins)) / nfft
                  ).astype(np.complex64)


def demod_detections(cfg: OFDMConfig, ext: jnp.ndarray, ptrs_rel: jnp.ndarray,
                     delays: jnp.ndarray, valid: jnp.ndarray,
                     n_readable: int | jnp.ndarray,
                     demod_path: str | None = None):
    """Per-detection channel estimate + pattern-block demod, fully batched.

    ext:       [n] sample buffer (chunk history + chunk for streaming).
    ptrs_rel:  [max_det] detection pointers RELATIVE to ext[0].
    delays:    [max_det] winning delay hypotheses.
    valid:     [max_det] slot-occupied mask.
    n_readable: samples of ext that are real (stage-B fit bound,
               TEST synch_and_chan_est.py:271 / rx_stream demod_ok).
    demod_path: None (default) computes the per-window spectra with the
               FFT op — bit-exact with the NumPy oracle (tests).
               "dft" computes them as bin-restricted DFT matmuls instead
               (at HIGHEST precision).  Same math to float32 rounding;
               decisions agree (tests pin it).

    Returns (chans [max_det, nfft], phasors [max_det, nd, B], demod_ok).
    """
    nfft = cfg.nfft
    m0, nd = cfg.m_synch, cfg.synch_dat[1]
    _, data_bins = used_bins(nfft, cfg.num_data_bins)
    data_bins = np.asarray(data_bins)
    max_det = ptrs_rel.shape[0]

    safe_ptr = jnp.where(valid, ptrs_rel, 0)

    # ONE contiguous dynamic slice per detection, then static windows into
    # it, instead of ext[ptr + static_offsets] gathers with data-dependent
    # indices; edge padding replicates that gather's per-element index
    # clamp exactly (fully- and partially-out-of-range windows read
    # ext[-1]).
    seg_len = (m0 + nd - 1) * cfg.rx_b_len + nfft
    xp = jnp.pad(ext, (0, seg_len), mode="edge")
    segs = jax.vmap(
        lambda p: jax.lax.dynamic_slice_in_dim(xp, p, seg_len, axis=0)
    )(safe_ptr)                                             # [d, seg_len]

    # -- channel estimate at each detection's own synch spectrum -----------
    offs = (np.arange(m0) * cfg.rx_b_len)[:, None] + np.arange(nfft)[None, :]
    swin = segs[:, jnp.asarray(offs)]                       # [d, m0, nfft]
    _, synch_bins = used_bins(nfft, cfg.num_synch_bins)
    if demod_path == "dft":
        s = jnp.matmul(swin, jnp.asarray(_dft_bins(nfft, cfg.num_synch_bins)),
                       precision=jax.lax.Precision.HIGHEST)
        s = s.reshape(max_det, -1)
    else:
        sf = jnp.fft.fft(swin, nfft, axis=-1)
        s = sf[..., np.asarray(synch_bins)].reshape(max_det, -1)
    sp = jnp.sum(jnp.abs(s) ** 2, axis=-1, keepdims=True)
    s = s * jnp.sqrt(s.shape[-1] / jnp.maximum(sp, 1e-30))
    _, chans, _ = jax.vmap(functools.partial(sync.estimate_channel, cfg))(
        s, delays)
    chans = chans * valid[:, None]

    # -- demod the nd data symbols of each detection's pattern block -------
    doffs = ((m0 + np.arange(nd))[:, None] * cfg.rx_b_len +
             np.arange(nfft)[None, :])                      # static [nd, nfft]
    dwin = segs[:, jnp.asarray(doffs)]                      # [d, nd, nfft]
    if demod_path == "dft":
        fd = jnp.matmul(dwin, jnp.asarray(_dft_bins(nfft, cfg.num_data_bins)),
                        precision=jax.lax.Precision.HIGHEST)
    else:
        f = jnp.fft.fft(dwin, nfft, axis=-1)
        fd = f[..., data_bins]                              # [d, nd, B]
    power = jnp.sum(jnp.abs(fd) ** 2, axis=-1, keepdims=True)
    fd = fd * jnp.sqrt(fd.shape[-1] / jnp.maximum(power, 1e-30))
    rot = jnp.exp((1j * 2.0 * jnp.pi / nfft) *
                  delays.astype(jnp.float32)[:, None] *
                  jnp.asarray(data_bins, jnp.float32)[None, :])
    eq = sync.mmse_gain(chans[:, data_bins], cfg.snr_linear)
    demod_ok = valid & (safe_ptr + (m0 + nd - 1) * cfg.rx_b_len + nfft
                        <= n_readable)
    phasors = fd * rot[:, None, :] * eq[:, None, :] * demod_ok[:, None, None]
    if cfg.modulation != "QPSK":
        # MMSE amplitude unbias before QAM grid decisions (models/rxofdm.py)
        phasors = phasors * sync.demap_unbias_gain(
            chans[:, data_bins], cfg.snr_linear)[:, None, :]
    return chans, phasors, demod_ok


def rx_detections(cfg: OFDMConfig, x: jnp.ndarray, n_trials: int,
                  max_det: int = 100,
                  fast: bool | str | None = None,
                  demod_path: str | None = None) -> DetectionsOut:
    """Whole-buffer multi-detection RX (the batched flagship semantics).

    n_trials/max_det are static.  max_det mirrors the reference's
    max_num_corr=100 table size (synch_and_chan_est.py:86-88).
    """
    dmax_val, dmax_ind = detect_trials(cfg, x, n_trials, fast)
    trial_idx = jnp.arange(n_trials, dtype=jnp.int32)
    ptrs, (delays, peaks, _), count = sync.refractory_detect(
        cfg, dmax_val, (dmax_ind, dmax_val, trial_idx), max_det)
    valid = jnp.arange(max_det) < count
    chans, phasors, demod_ok = demod_detections(
        cfg, x, ptrs, delays, valid, x.shape[0], demod_path=demod_path)
    hard = hard_decide(cfg, phasors)
    return DetectionsOut(ptrs=ptrs, delays=delays, peaks=peaks, count=count,
                         valid=valid, demod_ok=demod_ok, chans=chans,
                         phasors=phasors, hard_bits=hard)


def make_rx_detections(cfg: OFDMConfig, n_samples: int, max_det: int = 100,
                       **kwargs):
    """Jitted multi-detection RX for a fixed buffer length."""
    n_trials = sync.n_trials_for(cfg, n_samples)
    return jax.jit(functools.partial(
        rx_detections, cfg, n_trials=n_trials, max_det=max_det, **kwargs))
