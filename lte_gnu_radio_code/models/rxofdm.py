"""RX model — the flagship synch_and_chan_est + bit recovery as one jitted,
fully batched function (the gr-RXOFDM / gr-utsa_ofdm / offline-R10 family).

Stages (all device-resident, no host sync):
  sync_spectra -> sync_correlate_ifft -> first_lock ->
  estimate_channel -> equalize_data_symbols -> qpsk_llr

Reference: gr-RXOFDM/python/synch_and_chan_est.py:140-266,
TEST/GNU_RADIO_OFFLINE/synch_and_chan_est.py:164-293,
LEGACY/gr-ofdm-rx/python/BitRecovery.py:66-157.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np

import jax
import jax.numpy as jnp

from ..ops import modulation, sync
from ..utils.params import OFDMConfig, used_bins


class RxResult(NamedTuple):
    phasors: jnp.ndarray        # [num_data_symb, num_data_bins] equalised IQ
    hard_bits: jnp.ndarray      # [num_bits]
    llr0: jnp.ndarray
    llr1: jnp.ndarray
    lock_ptr: jnp.ndarray       # scalar int — frame pointer of the sync lock
    delay_idx: jnp.ndarray      # scalar int — winning delay hypothesis
    peak: jnp.ndarray           # correlation peak value
    found: jnp.ndarray          # bool — gate crossed anywhere
    chan_est_time: jnp.ndarray  # [nfft] estimated CIR


def rx_frame(cfg: OFDMConfig, x: jnp.ndarray, n_trials: int,
             num_patterns: int, fast: bool | str | None = None,
             genie_h=None, perfect_chan_est: bool = False) -> RxResult:
    """Demodulate a buffer of samples.  n_trials/num_patterns are static.

    ``fast`` selects the sync-search delay-correlation implementation:
      * None (default) -> "ifft": batched trial FFTs + ONE inverse FFT per
        trial covering all cp+1 delay hypotheses (sync_correlate_ifft — the
        fewest FLOPs at every scale, ~35x fewer than the dense forms at LTE
        numerology; works for any bin plan).
      * True / "conv" -> the conv-bank formulation (ops/fast_sync.py): the
        whole search as one strided real convolution (requires the
        canonical all-but-DC/Nyquist bin plan).
      * False / "exact" -> the dense [p, L] x [L, cp+1] einsum (the literal
        del_mat shape of synch_and_chan_est.py:164-165).
    The channel-estimation spectrum is always the exact power-normalised
    lock-trial spectrum (reused for ifft/exact, recomputed for conv).

    ``perfect_chan_est`` substitutes the true channel's frequency response
    (``genie_h`` CIR) on the synch bins for the estimate — the genie/oracle
    isolation mode of TEST/GNU_RADIO_OFFLINE/synch_and_chan_est.py:213-215.

    Each stage runs under a ``jax.named_scope`` (sync, lock_chanest, demod,
    llr) so a profiler trace attributes device time per stage.
    """
    if fast is None:
        fast = "ifft"
    if fast in ("ifft", "exact", False):
        with jax.named_scope("sync"):
            spectra = sync.sync_spectra(cfg, x, n_trials)
            corr = sync.corr_abs_from_spectra(cfg, spectra, fast)
        with jax.named_scope("lock_chanest"):
            ptr, delay_idx, peak, found, first = sync.first_lock(cfg, corr)
            _, chan_full, cir = sync.estimate_channel(cfg, spectra[first],
                                                      delay_idx)
    elif fast in (True, "conv"):
        with jax.named_scope("sync"):
            from ..ops import fast_sync
            corr = fast_sync.sync_corr_abs_fast(cfg, x, n_trials)
        with jax.named_scope("lock_chanest"):
            ptr, delay_idx, peak, found, first = sync.first_lock(cfg, corr)
            # the conv search forms no trial spectra: compute the lock
            # trial's spectrum for the channel estimate
            spec1 = sync.sync_spectrum_at(cfg, x, first)
            _, chan_full, cir = sync.estimate_channel(cfg, spec1, delay_idx)
    else:
        raise ValueError(f"rx_frame: unknown sync path fast={fast!r}; "
                         "expected None, 'ifft', 'conv'/True or "
                         "'exact'/False")
    if perfect_chan_est and genie_h is not None:
        _, _bins = used_bins(cfg.nfft, cfg.num_synch_bins)
        hf = jnp.fft.fft(jnp.asarray(genie_h, jnp.complex64), cfg.nfft)
        # substitute the true channel IN THE ESTIMATOR'S TIMING FRAME: the
        # estimated channel absorbs the winning delay derotation
        # (synch_and_chan_est.py:181-182), so the genie must be rotated the
        # same way or every equalised bin carries e^{+j2pi k d/N}.  (The
        # reference's own substitution at TEST synch_and_chan_est.py:213-215
        # omits this and is only residual-free for delay_idx == 0.)
        rot = jnp.exp((1j * 2.0 * jnp.pi / cfg.nfft) *
                      delay_idx.astype(jnp.float32) *
                      jnp.arange(cfg.nfft, dtype=jnp.float32))
        chan_full = jnp.zeros(cfg.nfft, jnp.complex64).at[
            np.asarray(_bins)].set((hf * rot)[np.asarray(_bins)])
        cir = jnp.fft.ifft(chan_full, cfg.nfft)
    with jax.named_scope("demod"):
        if cfg.pilot_grid != "none":
            # pilot-based channel estimation + EQ (BASELINE configs 2-3): the
            # synch lock still supplies timing; H comes from the scattered
            # pilots inside the data symbols (ops/pilots.py)
            from ..ops import pilots
            phasors, h_data = pilots.equalize_data_symbols_pilot(
                cfg, x, ptr, delay_idx, num_patterns, return_chan=True)
        else:
            phasors = sync.equalize_data_symbols(
                cfg, x, ptr, delay_idx, chan_full, num_patterns)
            h_data = chan_full[np.asarray(
                used_bins(cfg.nfft, cfg.num_data_bins)[1])]
    with jax.named_scope("llr"):
        if cfg.modulation == "QPSK":
            hard, llr0, llr1 = modulation.qpsk_llr(phasors)
        else:
            # remove the MMSE amplitude bias before the grid decision (QAM
            # only; the QPSK path keeps the reference's exact biased output)
            phasors = phasors * sync.demap_unbias_gain(h_data,
                                                       cfg.snr_linear)
            hard, llr = modulation.maxlog_llr(phasors, cfg.modulation,
                                              1.0 / cfg.snr_linear)
            llr0, llr1 = -llr, llr
    return RxResult(phasors, hard, llr0, llr1, ptr, delay_idx, peak, found, cir)


def plan_rx(cfg: OFDMConfig, n_samples: int) -> tuple[int, int]:
    """Static (n_trials, num_patterns) for a given buffer length.

    num_patterns matches the reference's bound check: block k's last data
    symbol must fit below n_samples assuming the nominal lock at cp_len
    (the reference uses the actual lock; at most one tail block differs —
    it would demodulate garbage there anyway, exactly like the reference's
    zero rows).
    """
    n_trials = sync.n_trials_for(cfg, n_samples)
    block = cfg.pattern_len * cfg.rx_b_len
    # lock + k*block + (pattern_len-1)*rx_b_len + nfft <= n_samples
    avail = n_samples - cfg.cp_len - (cfg.pattern_len - 1) * cfg.rx_b_len - cfg.nfft
    num_patterns = max(0, min(cfg.num_patterns, avail // block + 1))
    return n_trials, num_patterns


def make_rx(cfg: OFDMConfig, n_samples: int, **kwargs):
    """Jitted RX for fixed buffer length.  kwargs forward to rx_frame
    (fast=, genie_h=, perfect_chan_est=)."""
    n_trials, num_patterns = plan_rx(cfg, n_samples)
    return jax.jit(functools.partial(
        rx_frame, cfg, n_trials=n_trials, num_patterns=num_patterns,
        **kwargs))
