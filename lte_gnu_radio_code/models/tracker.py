"""Tracking synchronizer (R6/R11) as a jittable lax.scan state machine.

The reference tracker (txrx_mod/RxBasebandSystem.param_est_synch:91-274,
GR port LEGACY/gr-ofdm-rx/python/SynchronizeAndEstimate.py:226-350) is
inherently sequential — the frame pointer for step t depends on the lock
history — so it maps to a ``lax.scan`` whose carry is the tracker state:

  (corr_obs, ptr_frame, ptr_adj, sym_count, last_ptr, hist_x[5], hist_y[5], b[2])

Each scan step does one window gather + FFT + ZC correlation (uniform
compute, so XLA compiles one fused step body).  The 5-tap least-squares
drift predictor is a masked closed-form 2x2 normal-equation solve.

State machine (reference :114-119):
  corr_obs == -1 : search — ptr = loop*stride + (cp-5) + ptr_adj
  corr_obs <  5  : nominal advance by pattern*(nfft+cp)
  corr_obs >= 5  : ptr = ceil(b0 + b1*(sym_count*pattern) - cp/4)

Quirks replicated: delay = argmax-1 (:157-158), +cp/2 pointer re-adjustment
without re-reading (:163-200), refractory vs time_synch_ref[max(corr_obs,1)]
(:202), (1 + 1/SNR) channel-estimate regulariser (:236), lstsq history using
min(corr_obs, 5) entries (:230-237).  Adjudicated fix (SURVEY.md §7.3): data
derotation uses delay+1 = argmax so it matches the channel-estimate timing
hypothesis (see reference_cpu/tracker.py for the residual analysis).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from ..ops import modulation, sync
from ..ops.zadoff_chu import zc_for_config
from ..utils.params import OFDMConfig, used_bins


class TrackResult(NamedTuple):
    ptrs: jnp.ndarray        # [max_det]
    delays: jnp.ndarray      # [max_det]
    peaks: jnp.ndarray       # [max_det]
    count: jnp.ndarray
    chan_freq: jnp.ndarray   # [max_det, nfft]
    phasors: jnp.ndarray     # [max_det * n_data_per_pattern, num_data_bins]
    hard_bits: jnp.ndarray


def _masked_lstsq(hx, hy, n_eff):
    """Weighted closed-form b = argmin sum_i w_i (b0 + b1 x_i - y_i)^2."""
    w = (jnp.arange(hx.shape[0]) < n_eff).astype(jnp.float32)
    s0 = jnp.sum(w)
    s1 = jnp.sum(w * hx)
    s2 = jnp.sum(w * hx * hx)
    sy = jnp.sum(w * hy)
    sxy = jnp.sum(w * hx * hy)
    det = s0 * s2 - s1 * s1
    safe = jnp.abs(det) > 1e-9
    b1 = jnp.where(safe, (s0 * sxy - s1 * sy) / jnp.where(safe, det, 1.0), 0.0)
    b0 = jnp.where(s0 > 0, (sy - b1 * s1) / jnp.maximum(s0, 1.0), 0.0)
    return jnp.stack([b0, b1])


def tracker_stride(cfg: OFDMConfig) -> int:
    return int(np.ceil(cfg.cp_len / 2))


def tracker_init_carry():
    """(loop_count, corr_obs, ptr_frame, ptr_adj, sym_count, last_ptr,
    hx[5], hy[5], b[2]) — the reference's cross-work-call tracker state."""
    return (jnp.int32(0), jnp.int32(-1), jnp.int32(0), jnp.int32(0),
            jnp.int32(0), jnp.int32(0), jnp.zeros(5, jnp.float32),
            jnp.zeros(5, jnp.float32), jnp.zeros(2, jnp.float32))


def make_tracker_step(cfg: OFDMConfig, x: jnp.ndarray, x_start,
                      fire_limit):
    """Build the tracker scan step over buffer ``x`` whose first sample has
    global index ``x_start``.

    Fire-or-stall semantics: a step FIRES (evaluates its window, possibly
    accepting a detection, and consumes a loop count) only when the pointer's
    sync window ends before ``fire_limit`` (global); otherwise the carry
    passes through unchanged so a chunked stream retries the same pointer
    when more samples arrive.  Inside a buffer this is identical to the
    reference's while-loop; at a buffer end it differs only in never-accepted
    trailing iterations (the reference keeps advancing ptr_frame past the
    end, accepting nothing).
    """
    nfft, cp = cfg.nfft, cfg.cp_len
    m0 = cfg.m_synch
    rx_b_len = cfg.rx_b_len
    pattern = cfg.pattern_len
    _, synch_bins = used_bins(nfft, cfg.num_synch_bins)
    synch_bins = np.asarray(synch_bins)
    zc = jnp.asarray(zc_for_config(cfg))
    snr = cfg.snr_linear
    L = m0 * cfg.num_synch_bins
    stride = tracker_stride(cfg)
    start_samp = cp - 5
    # [L, cp+1] +j-signed delay matrix (RxBasebandSystem.py:146-152)
    p_mat_j = jnp.asarray(np.tile(np.exp(1j * 2 * (np.pi / nfft) *
                                         np.outer(synch_bins,
                                                  np.arange(cp + 1))),
                                  (m0, 1)).astype(np.complex64))
    win_offs = ((np.arange(m0) * rx_b_len)[:, None] +
                np.arange(nfft)[None, :])

    def correlate(ptr_local):
        idx = ptr_local + jnp.asarray(win_offs)
        w = x[idx]                                     # [m0, nfft]
        f = jnp.fft.fft(w, nfft, axis=-1)
        sd0 = f[:, synch_bins].reshape(-1)             # [L]
        pow_est = jnp.sum(jnp.abs(sd0) ** 2).real / L
        sd = sd0 / jnp.sqrt(jnp.maximum(pow_est, 1e-30))
        dd = jnp.abs(jnp.matmul(jnp.conj(zc), sd[:, None] * p_mat_j,
                                precision=jax.lax.Precision.HIGHEST))
        return sd, jnp.max(dd), jnp.argmax(dd).astype(jnp.int32) - 1

    def step(carry, _):
        (loop_count, corr_obs, ptr_frame, ptr_adj, sym_count, last_ptr,
         hx, hy, b) = carry

        ptr_pred = jnp.ceil(b[0] + b[1] * (sym_count * pattern).astype(jnp.float32)
                            - cp / 4.0).astype(jnp.int32)
        ptr = jnp.where(
            corr_obs == -1, loop_count * stride + start_samp + ptr_adj,
            jnp.where(corr_obs < 5, ptr_frame + pattern * rx_b_len, ptr_pred))

        fire = ((m0 - 1) * rx_b_len + nfft + ptr < fire_limit) & \
            (ptr >= x_start)
        ptr_local = jnp.where(fire, ptr - x_start, 0)
        sd, dmax, dmax_ind = correlate(ptr_local)

        enter = fire & ((dmax > 0.5 * L) | (corr_obs > -1))
        # +cp/2 re-adjustment, same window kept (:163-200)
        need_adj = enter & (dmax_ind > np.ceil(0.75 * cp))
        adj = jnp.int32(np.ceil(0.5 * cp))
        ptr_adj1 = jnp.where(need_adj & (corr_obs == 0), ptr_adj + adj,
                             ptr_adj)
        ptr = jnp.where(
            need_adj & (corr_obs == 0),
            loop_count * stride + start_samp + ptr_adj1,
            jnp.where(need_adj & (corr_obs > 0) & (corr_obs < 5),
                      ptr + adj, ptr))

        refr_ref = jnp.where(corr_obs == 0, 0, last_ptr)
        accept = enter & ((ptr - refr_ref > 2 * cp + nfft) | (corr_obs == -1))

        corr_obs1 = jnp.where(accept, corr_obs + 1, corr_obs)
        slot = sym_count % 5
        hx1 = jnp.where(accept, hx.at[slot].set(
            (sym_count * pattern).astype(jnp.float32)), hx)
        hy1 = jnp.where(accept, hy.at[slot].set(
            (ptr + dmax_ind).astype(jnp.float32)), hy)
        sym_count1 = jnp.where(accept, sym_count + 1, sym_count)
        n_eff = jnp.minimum(corr_obs1, 5)
        b1 = jnp.where(accept & (corr_obs1 > 3),
                       _masked_lstsq(hx1, hy1, n_eff), b)

        # channel estimate on accept (:229-241)
        data_recov0 = sd * p_mat_j[:, jnp.clip(dmax_ind + 1, 0, cp)]
        tmp = (data_recov0 * jnp.conj(zc)) / (1.0 + 1.0 / snr)
        h_est = jnp.mean(tmp.reshape(m0, -1), axis=0)
        h_row = jnp.zeros(nfft, jnp.complex64).at[synch_bins].set(h_est)
        h_row = jnp.where(accept, h_row, jnp.zeros_like(h_row))

        carry1 = (jnp.where(fire, loop_count + 1, loop_count), corr_obs1,
                  jnp.where(fire, ptr, ptr_frame), ptr_adj1, sym_count1,
                  jnp.where(accept, ptr, last_ptr), hx1, hy1, b1)
        ys = (accept, ptr, dmax_ind, dmax, h_row)
        return carry1, ys

    return step


def demod_track_table(cfg: OFDMConfig, x: jnp.ndarray, ptrs_local, delays,
                      det_valid, readable_local):
    """Data demod vmapped over a tracker detection table
    (RxBasebandSystem.rx_data_demod :276-309) — shared by the batch and
    streaming paths.  ptrs_local are relative to x[0]."""
    nfft = cfg.nfft
    rx_b_len = cfg.rx_b_len
    nd = cfg.synch_dat[1]
    _, data_bins = used_bins(nfft, cfg.num_data_bins)
    data_bins = np.asarray(data_bins)
    max_det = ptrs_local.shape[0]

    starts = ptrs_local[:, None] + (jnp.arange(nd)[None, :] + 1) * rx_b_len
    ok = det_valid[:, None] & (starts + nfft <= readable_local)
    idx = jnp.where(ok, starts, 0)[..., None] + jnp.arange(nfft)[None, None, :]
    f = jnp.fft.fft(x[idx], nfft, axis=-1)
    fd = f[..., data_bins]                              # [max_det, nd, B]
    p_est = jnp.mean(jnp.abs(fd) ** 2, axis=-1, keepdims=True)
    fd = fd / jnp.sqrt(jnp.maximum(p_est, 1e-30))
    # adjudicated fix: derotate by delay+1 = argmax (matches channel est)
    rot = jnp.exp((1j * 2.0 * jnp.pi / nfft) *
                  (delays[:, None, None] + 1).astype(jnp.float32) *
                  jnp.asarray(data_bins, jnp.float32)[None, None, :])
    return fd, rot, ok


def track_frame(cfg: OFDMConfig, x: jnp.ndarray, total_loops: int,
                max_det: int) -> TrackResult:
    nfft = cfg.nfft
    nd = cfg.synch_dat[1]
    n = x.shape[0]
    snr = cfg.snr_linear
    _, data_bins = used_bins(nfft, cfg.num_data_bins)
    data_bins = np.asarray(data_bins)

    step = make_tracker_step(cfg, x, 0, n)
    _, (acc, ptrs_all, dels_all, peaks_all, h_all) = \
        lax.scan(step, tracker_init_carry(), None, length=total_loops)

    # compact accepted steps into the fixed detection table
    (ptrs, delays, peaks), count = sync.emit_slots(
        acc, (ptrs_all, dels_all, peaks_all.astype(jnp.float32)), max_det)
    slot = jnp.cumsum(acc.astype(jnp.int32)) - 1
    valid = acc & (slot < max_det)
    tgt = jnp.where(valid, slot, max_det)
    chan = jnp.zeros((max_det, nfft), jnp.complex64).at[tgt].set(
        h_all, mode="drop")

    # ---- data demod, vmapped over the detection table (:276-309) ----------
    det_valid = jnp.arange(max_det) < count
    fd, rot, ok = demod_track_table(cfg, x, ptrs, delays, det_valid, n)
    h_d = chan[:, data_bins][:, None, :]
    eq = (fd * rot * jnp.conj(h_d)) / (jnp.abs(h_d) ** 2 + 1.0 / snr)
    p1 = jnp.mean(jnp.abs(eq) ** 2, axis=-1, keepdims=True)
    eq = eq / jnp.sqrt(jnp.maximum(p1, 1e-30)) * ok[..., None]
    phasors = eq.reshape(max_det * nd, cfg.num_data_bins)

    hard, _, _ = modulation.qpsk_llr(phasors)
    return TrackResult(ptrs, delays, peaks, count, chan, phasors, hard)


def make_tracker(cfg: OFDMConfig, n_samples: int, max_det: int | None = None):
    stride = int(np.ceil(cfg.cp_len / 2))
    total_loops = int(np.ceil(n_samples / stride)) + 1
    if max_det is None:
        max_det = cfg.num_patterns
    return jax.jit(functools.partial(track_frame, cfg,
                                     total_loops=total_loops,
                                     max_det=max_det))
