"""Synchronisation, channel estimation and MMSE equalisation.

The reference's hottest loop (gr-RXOFDM/python/synch_and_chan_est.py:140-221)
slides a window sample-by-sample and, per trial, materialises O(L^2) `np.diag`
matmuls.  Here the whole search is re-expressed as three batched primitives:

  1. `sync_spectra`   — gather ALL trial windows at once -> one batched FFT
  2. `sync_correlate` — one [n_trials, L] x [L, cp+1] complex matmul
  3. `first_lock` / `refractory_detect` — vectorised gate + refractory selection

This is mathematically identical to the reference (each diag-matmul is an
elementwise product) but runs as batched device ops instead of a Python
interpreter loop.  Complexity per frame: one FFT batch of n_trials*m_synch
64..2048-pt FFTs plus one dense matmul (or one inverse FFT per trial,
`sync_correlate_ifft`).
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from ..utils.params import OFDMConfig, used_bins
from .zadoff_chu import delay_search_matrix, zc_for_config

Precision = lax.Precision


def n_trials_for(cfg: OFDMConfig, n_samples: int) -> int:
    """Number of stride-spaced sync trials that fit in an n_samples buffer.

    Mirrors the work() window-fit check (synch_and_chan_est.py:144-147):
    window needs m0*(nfft+cp) + nfft + start_samp samples beyond the trial
    offset.
    """
    need = cfg.m_synch * cfg.rx_b_len + cfg.nfft + cfg.cp_len
    return max(0, (n_samples - need - 1) // cfg.stride + 1)


def sync_spectra(cfg: OFDMConfig, x: jnp.ndarray, n_trials: int) -> jnp.ndarray:
    """Power-normalised synch-bin spectra for every trial offset.

    x: [n_samples] complex. Returns S [n_trials, m_synch*num_synch_bins].
    Trial p reads m_synch CP-skipped windows starting at
    cp_len + p*stride + l*(nfft+cp) (synch_and_chan_est.py:148-151), FFTs each
    and gathers the synch bins, then normalises the concatenated vector to
    unit average power (:159-163).
    """
    _, synch_bins = used_bins(cfg.nfft, cfg.num_synch_bins)
    starts = cfg.cp_len + cfg.stride * np.arange(n_trials)
    offs = (np.arange(cfg.m_synch) * cfg.rx_b_len)[:, None] + np.arange(cfg.nfft)[None, :]
    idx = starts[:, None, None] + offs[None, :, :]          # [p, m, nfft]
    win = x[idx]                                            # gather
    f = jnp.fft.fft(win, cfg.nfft, axis=-1)                 # batched FFT
    s = f[..., np.asarray(synch_bins)]                      # [p, m, L]
    s = s.reshape(n_trials, -1)
    power = jnp.sum(jnp.abs(s) ** 2, axis=-1, keepdims=True)
    return s * jnp.sqrt(s.shape[-1] / power)


def sync_spectrum_at(cfg: OFDMConfig, x: jnp.ndarray, trial) -> jnp.ndarray:
    """Power-normalised synch-bin spectrum of ONE trial (dynamic index).

    Used by the conv-bank sync path to compute the exact channel-estimation
    spectrum only at the lock trial."""
    _, synch_bins = used_bins(cfg.nfft, cfg.num_synch_bins)
    start = cfg.cp_len + cfg.stride * trial
    offs = (np.arange(cfg.m_synch) * cfg.rx_b_len)[:, None] + \
        np.arange(cfg.nfft)[None, :]
    # dynamic slice + static windows (not a data-dependent gather)
    span = (cfg.m_synch - 1) * cfg.rx_b_len + cfg.nfft
    xp = jnp.pad(x, (0, span), mode="edge")
    seg = lax.dynamic_slice_in_dim(xp, start, span, axis=0)
    win = seg[jnp.asarray(offs - offs.min())]
    f = jnp.fft.fft(win, cfg.nfft, axis=-1)
    s = f[..., np.asarray(synch_bins)].reshape(-1)
    power = jnp.sum(jnp.abs(s) ** 2)
    return s * jnp.sqrt(s.shape[-1] / jnp.maximum(power, 1e-30))


def sync_correlate(cfg: OFDMConfig, spectra: jnp.ndarray) -> jnp.ndarray:
    """Delay-hypothesis correlation |del_mat| for all trials at once.

    corr[p, d] = sum_k exp(+j2pi d b_k/N) * S[p,k] * conj(ZC[k])
    (synch_and_chan_est.py:164-165, the del_mat product).  One complex matmul.
    """
    zc = jnp.asarray(zc_for_config(cfg))
    dse = jnp.asarray(delay_search_matrix(cfg))             # [cp+1, L]
    prod = spectra * jnp.conj(zc)[None, :]                  # [p, L]
    corr = jnp.einsum("pl,dl->pd", prod, dse,
                      precision=Precision.HIGHEST)
    return corr


def sync_correlate_ifft(cfg: OFDMConfig, spectra: jnp.ndarray) -> jnp.ndarray:
    """The delay-hypothesis correlation via ONE inverse FFT per trial.

    Algebraic restructuring of sync_correlate (the del_mat product,
    synch_and_chan_est.py:164-165): with q[p, j] = sum_l S[p, l, j]*conj(ZC[l, j]),

        corr[p, d] = sum_j e^{+j 2pi d b_j / N} q[p, j]
                   = N * IFFT_N(scatter(q onto bins b_j))[d]

    because the delay hypotheses d = 0..cp are INTEGER shifts — the whole
    [L] x [L, cp+1] delay matmul collapses to a length-N inverse FFT whose
    first cp+1 taps are the cp+1 hypotheses.  FLOPs per trial fall from
    8*L*(cp+1) (2.1 MFLOP at NFFT 1024) to one N-point IFFT (~0.05 MFLOP) —
    a ~35x cut at LTE scale.  The reference never exploits this structure
    (it materialises the del_mat_exp matrix, synch_and_chan_est.py:78-79).

    Identical math to sync_correlate to float32 tolerance (tested); works
    for ANY bin plan (no Parseval condition — unlike the conv-bank path).
    """
    _, synch_bins = used_bins(cfg.nfft, cfg.num_synch_bins)
    zc = jnp.asarray(zc_for_config(cfg))
    prod = (spectra * jnp.conj(zc)[None, :]).reshape(
        spectra.shape[0], cfg.m_synch, cfg.num_synch_bins)
    q = jnp.sum(prod, axis=1)                               # [p, L]
    y = jnp.zeros((spectra.shape[0], cfg.nfft), jnp.complex64
                  ).at[:, np.asarray(synch_bins)].set(q)
    return cfg.nfft * jnp.fft.ifft(y, axis=-1)[:, : cfg.cp_len + 1]


def corr_abs_from_spectra(cfg: OFDMConfig, spectra: jnp.ndarray,
                          method) -> jnp.ndarray:
    """|corr| [p, cp+1] from trial spectra: 'ifft' (default) or the dense
    einsum ('exact'/False).  The conv-bank selector ('conv'/True) does not
    go through spectra and must be rejected here, not silently mapped to the
    dense form."""
    if method == "ifft":
        return jnp.abs(sync_correlate_ifft(cfg, spectra))
    if method not in ("exact", False):
        raise ValueError(
            f"corr_abs_from_spectra: unknown method {method!r}; expected "
            "'ifft', 'exact' or False (the conv path does not use trial "
            "spectra)")
    return jnp.abs(sync_correlate(cfg, spectra))


def first_lock(cfg: OFDMConfig, corr_abs: jnp.ndarray):
    """First trial whose correlation peak crosses the gate (single lock).

    Replicates the offline/utsa single-lock semantics
    (TEST/GNU_RADIO_OFFLINE/synch_and_chan_est.py:195-253 with `break`).
    Returns (ptr, delay_idx, peak, found) — all scalars, fully on-device.
    """
    dmax_val = jnp.max(corr_abs, axis=-1)                   # [p]
    dmax_ind = jnp.argmax(corr_abs, axis=-1)                # [p]
    gate = cfg.detection_gate * cfg.m_synch * cfg.num_synch_bins
    mask = dmax_val > gate
    found = jnp.any(mask)
    first = jnp.argmax(mask)                                # first True (0 if none)
    ptr = cfg.cp_len + cfg.stride * first
    return ptr, dmax_ind[first], dmax_val[first], found, first


def refractory_scan(cfg: OFDMConfig, crossing: jnp.ndarray,
                    ptrs: jnp.ndarray, last_ptr=None, any_yet=None):
    """The sequential detection rule of gr-RXOFDM as a lax.scan, with an
    explicit initial carry so chunked streams continue it across chunk
    boundaries (synch_and_chan_est.py:170-173): accept a crossing iff
    ptr - last_accepted_ptr > 2*cp + nfft, or no detection has occurred yet.

    Returns (accepted [p] bool, (last_ptr, any_yet) final carry).
    """
    refractory = 2 * cfg.cp_len + cfg.nfft
    if last_ptr is None:
        last_ptr = jnp.int32(0)
    if any_yet is None:
        any_yet = jnp.bool_(False)

    def body(carry, inp):
        lp, ay = carry
        cross, ptr = inp
        ok = cross & ((ptr - lp > refractory) | ~ay)
        return (jnp.where(ok, ptr, lp), ay | ok), ok

    carry, accepted = lax.scan(
        body, (jnp.asarray(last_ptr, jnp.int32), jnp.asarray(any_yet)),
        (crossing, ptrs.astype(jnp.int32)))
    return accepted, carry


def emit_slots(accepted: jnp.ndarray, sources: tuple, max_det: int):
    """Scatter accepted trials into a fixed [max_det] detection table.

    sources: tuple of [p]-shaped arrays.  Returns (outs tuple of [max_det],
    count) — overflow detections beyond max_det are dropped (the reference's
    table is likewise fixed at max_num_corr rows)."""
    slot = jnp.cumsum(accepted.astype(jnp.int32)) - 1
    count = jnp.minimum(jnp.sum(accepted.astype(jnp.int32)), max_det)
    valid = accepted & (slot < max_det)
    tgt = jnp.where(valid, slot, max_det)

    def emit(src):
        out = jnp.zeros(max_det, src.dtype)
        return out.at[tgt].set(src, mode="drop")

    return tuple(emit(s) for s in sources), count


def refractory_select_idx(cfg: OFDMConfig, crossing: jnp.ndarray,
                          max_det: int, idx_start):
    """EXACT fast form of the sequential refractory acceptance.

    The greedy rule (accept the first crossing, then the first crossing
    more than `refractory` samples later, ...) is uniquely determined, so
    it can be computed as: a vectorised suffix-min "next crossing at or
    after i" table (one associative cummin over the trials), then a scan
    of only ``max_det`` JUMPS (each acceptance advances the cursor by the
    whole refractory window) instead of a scalar lax.scan over EVERY
    trial: a sequential step per trial is one small dependent device step
    each, while this form runs the same selection in
    max_det ~ trials/(2cp+nfft) steps.

    Requires trial pointers affine in the trial index (ptr = base +
    stride*i — true for every caller).  idx_start encodes the carried
    (last_det_ptr, any_det) continuation: the first acceptance must have
    i >= idx_start.

    Returns (idxs [max_det] i32 — accepted trial indices in order,
    oks [max_det] bool — slot valid).
    """
    p = crossing.shape[0]
    stride = max(1, cfg.stride)
    jump = (2 * cfg.cp_len + cfg.nfft) // stride + 1
    inf = jnp.int32(p)
    cand = jnp.where(crossing, jnp.arange(p, dtype=jnp.int32), inf)
    nxt = lax.cummin(cand, axis=0, reverse=True)            # [p]
    nxt_pad = jnp.concatenate([nxt, inf.reshape(1)])

    def body(cur, _):
        a = nxt_pad[jnp.minimum(cur, p)]
        ok = a < p
        return jnp.where(ok, a + jump, cur), (a, ok)

    _, (idxs, oks) = lax.scan(
        body, jnp.clip(jnp.asarray(idx_start, jnp.int32), 0, p), None,
        length=max_det)
    return jnp.where(oks, idxs, 0), oks


def refractory_table(cfg: OFDMConfig, crossing: jnp.ndarray, extras: tuple,
                     max_det: int, base_ptr, last_ptr=None, any_yet=None):
    """Fast drop-in for refractory_scan + emit_slots over affine trial
    pointers (ptr_i = base_ptr + stride*i).

    Returns (ptrs [max_det] i32, extras_out tuple, count,
    (last_ptr, any_yet) final carry) — identical acceptances to the
    sequential rule (tests pin stream==batch==oracle equality).

    Carry caveat (advisor r4): when a chunk holds MORE than max_det
    acceptances, the jump-scan stops at the max_det-th, so the returned
    last_ptr is the max_det-th acceptance's pointer — whereas the
    sequential refractory_scan carried the pointer of the true last
    acceptance (its table likewise dropped the overflow rows, but its
    carry kept advancing).  Streaming callers that CONTINUE the carry must
    therefore size max_det >= trial_span // refractory + 1 (what
    reacq_det_max computes), which makes overflow impossible; that sizing
    is asserted below whenever an explicit carry is passed in.  Carry-less
    batch callers (refractory_detect) keep the reference's drop-overflow
    table semantics unchanged.
    """
    stride = max(1, cfg.stride)
    refractory = 2 * cfg.cp_len + cfg.nfft
    if last_ptr is not None or any_yet is not None:
        # continuation caller: overflow would desynchronise the carry
        span = crossing.shape[0] * stride
        assert max_det >= span // refractory + 1, (
            f"refractory_table: max_det={max_det} can overflow "
            f"({span} trial-span samples / refractory {refractory}); size "
            "det_max via runtime.stream.reacq_det_max")
    if last_ptr is None:
        last_ptr = jnp.int32(0)
    if any_yet is None:
        any_yet = jnp.bool_(False)
    base_ptr = jnp.asarray(base_ptr, jnp.int32)
    idx_start = jnp.where(
        jnp.asarray(any_yet),
        (jnp.asarray(last_ptr, jnp.int32) + refractory - base_ptr)
        // stride + 1,
        0)
    idxs, oks = refractory_select_idx(cfg, crossing, max_det, idx_start)
    ptrs = jnp.where(oks, base_ptr + stride * idxs, -1)
    outs = tuple(jnp.where(oks, e[idxs], jnp.zeros((), e.dtype))
                 for e in extras)
    count = jnp.sum(oks.astype(jnp.int32))
    last_idx = jnp.max(jnp.where(oks, idxs, -1))
    new_last = jnp.where(count > 0, base_ptr + stride * last_idx,
                         jnp.asarray(last_ptr, jnp.int32))
    new_any = jnp.asarray(any_yet) | (count > 0)
    return ptrs, outs, count, (new_last, new_any)


def refractory_detect(cfg: OFDMConfig, dmax_val: jnp.ndarray,
                      extras: tuple, max_det: int):
    """Gate + refractory selection over per-trial peaks, generic payload.

    dmax_val: [p] peak magnitude per trial (already maxed over delay/fo/...).
    extras: tuple of [p]-shaped arrays to emit alongside each detection.
    Implements the multi-detection rule of gr-RXOFDM
    (synch_and_chan_est.py:167-179).

    Returns (ptrs [max_det] i32, extras_out tuple of [max_det], count).
    """
    gate = cfg.detection_gate * cfg.m_synch * cfg.num_synch_bins
    crossing = dmax_val > gate
    ptrs, outs, count, _ = refractory_table(cfg, crossing, tuple(extras),
                                            max_det, cfg.cp_len)
    # preserve the historical zero fill of empty slots (emit_slots)
    return jnp.where(ptrs >= 0, ptrs, 0), outs, count


def estimate_channel(cfg: OFDMConfig, spectrum: jnp.ndarray, delay_idx):
    """ZC-correlation channel estimate from one locked synch spectrum.

    spectrum: [m_synch*L] power-normalised synch bins at the lock trial.
    Returns (chan_est_bins [L], chan_est_full [nfft], chan_est_time [nfft]).
    (synch_and_chan_est.py:181-204.)
    """
    _, synch_bins = used_bins(cfg.nfft, cfg.num_synch_bins)
    zc = jnp.asarray(zc_for_config(cfg))
    dse = jnp.asarray(delay_search_matrix(cfg))
    snr_lin = cfg.snr_linear

    # winning delay row via a contiguous dynamic slice, not a dse[delay_idx]
    # gather with a data-dependent index
    dse_row = lax.dynamic_slice_in_dim(
        dse, jnp.asarray(delay_idx, jnp.int32), 1, axis=0)[0]
    data_recov = dse_row * spectrum                         # de-rotate winning delay
    tmp = (data_recov * jnp.conj(zc)) / (1.0 / snr_lin + 1.0)
    chan_est = jnp.mean(tmp.reshape(cfg.m_synch, cfg.num_synch_bins), axis=0)
    full = jnp.zeros(cfg.nfft, jnp.complex64).at[np.asarray(synch_bins)].set(chan_est)
    cir = jnp.fft.ifft(full, cfg.nfft)
    return chan_est, full, cir


def mmse_gain(chan: jnp.ndarray, snr_lin: float) -> jnp.ndarray:
    """One-tap MMSE gain conj(H)/(|H|^2 + 1/SNR) (synch_and_chan_est.py:216-219)."""
    return jnp.conj(chan) / (1.0 / snr_lin + jnp.abs(chan) ** 2)


def demap_unbias_gain(chan: jnp.ndarray, snr_lin: float) -> jnp.ndarray:
    """Per-bin real gain removing the MMSE amplitude bias before a QAM demap.

    The reference's MMSE equaliser shrinks each bin by |H|^2/(|H|^2 + 1/SNR)
    — harmless for the phase-decided QPSK demap it was built for, but fatal
    for amplitude-decided QAM grids (the BASELINE.json configs 2-4
    extension).  Multiplying by the inverse bias makes the equalised output
    an unbiased estimate of the constellation point (equivalently: ZF
    amplitude with MMSE bookkeeping).  Deterministic given the channel
    estimate, so chunked and batched demods stay bit-identical.
    """
    h2 = jnp.abs(chan) ** 2
    return (h2 + 1.0 / snr_lin) / jnp.maximum(h2, 1e-30)


def equalize_data_symbols(cfg: OFDMConfig, x: jnp.ndarray, lock_ptr,
                          delay_idx, chan_full: jnp.ndarray,
                          num_patterns: int) -> jnp.ndarray:
    """FFT + power-norm + timing derotation + MMSE EQ for every data symbol.

    Batched replacement for the stage-B loop
    (TEST/GNU_RADIO_OFFLINE/synch_and_chan_est.py:258-284): pattern block k
    holds data symbols at lock + (m_synch + j)*(nfft+cp) + k*pattern*(nfft+cp).
    Returns phasors [num_patterns*n_data, num_data_bins].
    """
    _, data_bins = used_bins(cfg.nfft, cfg.num_data_bins)
    data_bins = np.asarray(data_bins)
    m0, nd = cfg.m_synch, cfg.synch_dat[1]
    block = cfg.pattern_len * cfg.rx_b_len

    # ONE contiguous dynamic slice at the (traced) lock pointer, then
    # static-index windows into it, instead of an x[lock + static_offsets]
    # gather with data-dependent indices.  Edge-padding replicates that
    # gather's index-clamp semantics for the (reference-matching) garbage
    # tail block, bit-exactly.
    span = ((num_patterns - 1) * block + (m0 + nd - 1) * cfg.rx_b_len +
            cfg.nfft)
    xp = jnp.pad(x, (0, span), mode="edge")
    seg = lax.dynamic_slice_in_dim(xp, lock_ptr, span, axis=0)
    rel = (np.arange(num_patterns)[:, None, None] * block +
           (m0 + np.arange(nd))[None, :, None] * cfg.rx_b_len +
           np.arange(cfg.nfft)[None, None, :])              # static [k, j, nfft]
    win = seg[jnp.asarray(rel)]                             # [k, j, nfft]
    f = jnp.fft.fft(win, cfg.nfft, axis=-1)
    fd = f[..., data_bins]                                  # [k, j, B]
    power = jnp.sum(jnp.abs(fd) ** 2, axis=-1, keepdims=True)
    fd = fd * jnp.sqrt(fd.shape[-1] / power)

    rot = jnp.exp((1j * 2.0 * jnp.pi / cfg.nfft) * delay_idx *
                  jnp.asarray(data_bins, jnp.float32)).astype(jnp.complex64)
    chan_d = chan_full[data_bins]
    eq = mmse_gain(chan_d, cfg.snr_linear)
    out = fd * rot[None, None, :] * eq[None, None, :]
    return out.reshape(num_patterns * nd, cfg.num_data_bins)
