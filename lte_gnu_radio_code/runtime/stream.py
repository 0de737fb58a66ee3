"""Streaming runtime — the JAX replacement for GNU Radio's
thread-per-block scheduler and ring buffers (SURVEY.md §2.8 X1-X3).

Where GNU Radio calls ``work(input_items)`` with whatever samples are
available and blocks carry sync state across calls (`time_synch_ref`,
`cor_obs`, channel estimates — synch_and_chan_est.py:76-103), here a chunked
sample stream drives ONE jitted step function with an explicit carry:

  state_{t+1}, out_t = step(state_t, chunk_t)

The carry holds the overlap-save history tail (the `M[0]*(NFFT+CP)+NFFT`
boundary samples of SURVEY.md §5), the cross-chunk refractory pointer, the
single-lock flag + channel estimate, and the next pattern-block index.  The
chunked outputs concatenate to exactly the batch RX's output (tested in
tests/test_runtime.py) — streaming is a re-batching of the same math, not a
different algorithm.

All shapes are static: every chunk processes chunk_len/stride trials and at
most chunk_len/block+2 pattern blocks.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from ..ops import modulation, sync
from ..utils.params import OFDMConfig, used_bins


class StreamState(NamedTuple):
    hist: jnp.ndarray        # [hist_len] trailing samples of previous chunks
    base: jnp.ndarray        # global sample index of the next chunk's start
    locked: jnp.ndarray      # bool — single-lock flag (R2/R10 semantics)
    lock_ptr: jnp.ndarray    # global lock pointer
    delay_idx: jnp.ndarray
    chan_full: jnp.ndarray   # [nfft] locked channel estimate
    next_k: jnp.ndarray      # next pattern-block index to demodulate
    last_det_ptr: jnp.ndarray  # refractory reference across chunks


class ChunkOut(NamedTuple):
    phasors: jnp.ndarray     # [kmax, nd, num_data_bins]
    block_ids: jnp.ndarray   # [kmax] global pattern-block index (or -1)
    valid: jnp.ndarray       # [kmax] bool
    found: jnp.ndarray       # bool — locked as of end of this chunk
    lock_ptr: jnp.ndarray


def hist_len_for(cfg: OFDMConfig) -> int:
    """Max window reach beyond a trial/block start — the halo rule."""
    sync_reach = cfg.cp_len + cfg.m_synch * cfg.rx_b_len + cfg.nfft
    data_reach = cfg.pattern_len * cfg.rx_b_len + cfg.nfft
    return max(sync_reach, data_reach)


def init_state(cfg: OFDMConfig, chunk_len: int) -> StreamState:
    h = hist_len_for(cfg)
    return StreamState(
        hist=jnp.zeros(h, jnp.complex64),
        base=jnp.int32(0),
        locked=jnp.bool_(False),
        lock_ptr=jnp.int32(0),
        delay_idx=jnp.int32(0),
        chan_full=jnp.zeros(cfg.nfft, jnp.complex64),
        next_k=jnp.int32(0),
        last_det_ptr=jnp.int32(0),
    )


def stream_step(cfg: OFDMConfig, state: StreamState, chunk: jnp.ndarray,
                num_patterns_total: int) -> tuple[StreamState, ChunkOut]:
    chunk_len = chunk.shape[0]
    hist_len = hist_len_for(cfg)
    assert chunk_len % max(1, cfg.stride) == 0, "chunk must be stride-aligned"
    ext = jnp.concatenate([state.hist, chunk])     # covers [base-hist, base+chunk)
    ext_start = state.base - hist_len              # global coord of ext[0]

    # -- sync search over the trials that became fully readable this chunk --
    # trial start offsets (global) s in [base - hist_len + cp, ...): each
    # chunk advances by chunk_len, so process chunk_len/stride trials whose
    # windows end inside ext.
    t_per = chunk_len // max(1, cfg.stride)
    spectra = sync.sync_spectra(cfg, ext, t_per)   # local offsets cp + j*stride
    corr = jnp.abs(sync.sync_correlate(cfg, spectra))
    dmax_val = jnp.max(corr, axis=-1)
    dmax_ind = jnp.argmax(corr, axis=-1)
    gate = cfg.detection_gate * cfg.m_synch * cfg.num_synch_bins
    local_ptrs = cfg.cp_len + cfg.stride * jnp.arange(t_per)
    global_ptrs = (ext_start + local_ptrs).astype(jnp.int32)
    # batch RX never evaluates trials before cp (sync.sync_spectra's first
    # window); mask them so the stream locks identically
    crossing = (dmax_val > gate) & (global_ptrs >= cfg.cp_len)

    # first un-refractory crossing while not locked (single-lock semantics)
    refractory = 2 * cfg.cp_len + cfg.nfft
    ok = crossing & ((global_ptrs - state.last_det_ptr > refractory) |
                     (state.last_det_ptr == 0))
    any_new = jnp.any(ok) & ~state.locked
    first_j = jnp.argmax(ok)
    new_lock_ptr = global_ptrs[first_j]
    new_delay = dmax_ind[first_j]
    _, new_chan, _ = sync.estimate_channel(cfg, spectra[first_j], new_delay)

    locked = state.locked | any_new
    lock_ptr = jnp.where(any_new, new_lock_ptr, state.lock_ptr)
    delay_idx = jnp.where(any_new, new_delay, state.delay_idx)
    chan_full = jnp.where(any_new, new_chan, state.chan_full)
    last_det = jnp.where(any_new, new_lock_ptr, state.last_det_ptr)

    # -- data demod: pattern blocks whose full window is inside ext ---------
    _, data_bins = used_bins(cfg.nfft, cfg.num_data_bins)
    data_bins = np.asarray(data_bins)
    m0, nd = cfg.m_synch, cfg.synch_dat[1]
    block = cfg.pattern_len * cfg.rx_b_len
    kmax = chunk_len // block + 2

    k = jnp.where(locked, jnp.where(any_new, 0, state.next_k), 0) \
        + jnp.arange(kmax)
    b_k = lock_ptr + k * block
    # readable iff the last sample needed is below base+chunk_len and the
    # first is at/after ext_start
    last_need = b_k + (m0 + nd - 1) * cfg.rx_b_len + cfg.nfft
    readable = (last_need <= state.base + chunk_len) & (b_k >= ext_start)
    valid = locked & readable & (k < num_patterns_total)

    rel = jnp.where(valid, b_k - ext_start, 0)
    from ..ops import cfo as _cfo_ops
    doffs = ((m0 + np.arange(nd))[:, None] * cfg.rx_b_len +
             np.arange(cfg.nfft)[None, :])
    f = jnp.fft.fft(_cfo_ops.windows_at(ext, rel, doffs), cfg.nfft, axis=-1)
    fd = f[..., data_bins]
    power = jnp.sum(jnp.abs(fd) ** 2, axis=-1, keepdims=True)
    fd = fd * jnp.sqrt(fd.shape[-1] / jnp.maximum(power, 1e-30))
    rot = jnp.exp((1j * 2.0 * jnp.pi / cfg.nfft) *
                  delay_idx.astype(jnp.float32) *
                  jnp.asarray(data_bins, jnp.float32))
    eq = sync.mmse_gain(chan_full[data_bins], cfg.snr_linear)
    phasors = fd * rot[None, None, :] * eq[None, None, :] * valid[:, None, None]

    n_done = jnp.sum(valid.astype(jnp.int32))
    next_k = jnp.where(locked, jnp.where(any_new, 0, state.next_k) + n_done,
                       0)

    new_state = StreamState(
        hist=ext[-hist_len:],
        base=state.base + chunk_len,
        locked=locked, lock_ptr=lock_ptr, delay_idx=delay_idx,
        chan_full=chan_full, next_k=next_k, last_det_ptr=last_det)
    out = ChunkOut(phasors=phasors,
                   block_ids=jnp.where(valid, k, -1),
                   valid=valid, found=locked, lock_ptr=lock_ptr)
    return new_state, out


# ---------------------------------------------------------------------------
# Continuous multi-detection streaming (flagship gr-RXOFDM R1 semantics)
# ---------------------------------------------------------------------------
#
# The single-lock stream above replicates the offline R10 block.  The block
# the D1 loopback app runs forever is different: per work() call it keeps a
# multi-detection `time_synch_ref` table, REFRESHES the channel estimate per
# detection, and demodulates each detection's data with its own estimate
# (gr-RXOFDM/python/synch_and_chan_est.py:167-179, :181-221, :224-250) — so
# it re-acquires after timing drift and channel changes.  Here that becomes a
# jitted chunk step with a tiny carry:
#
#   hist      — the trailing `lag` samples (overlap-save halo), sized so that
#               every trial processed in a chunk has its FULL reach — sync
#               windows AND its pattern block's data symbols — inside
#               [hist, chunk].  Trials are therefore processed `lag` samples
#               behind the newest input (fixed latency), and every detection
#               is emitted exactly once with its demod complete.
#   last_det_ptr/any_det — the refractory rule's carry, so detections are
#               accepted identically to one global scan over the whole stream.
#
# Chunked output == rx_detections on the concatenated stream, bit-for-bit
# (tests/test_stream_rx.py).


def reacq_lag(cfg: OFDMConfig) -> int:
    """History length: cp + the max reach of a trial (its last data symbol),
    rounded up to a stride multiple so chunk trial grids stay aligned."""
    reach = (cfg.pattern_len - 1) * cfg.rx_b_len + cfg.nfft
    need = cfg.cp_len + reach
    s = max(1, cfg.stride)
    return -(-need // s) * s


def reacq_det_max(cfg: OFDMConfig, chunk_len: int) -> int:
    """Upper bound on detections per chunk under the refractory rule."""
    return chunk_len // (2 * cfg.cp_len + cfg.nfft) + 1


class ReacqState(NamedTuple):
    hist: jnp.ndarray        # [lag] trailing samples
    base: jnp.ndarray        # global sample index of the next chunk's start
    real_end: jnp.ndarray    # global count of real (non-flush) samples
    last_det_ptr: jnp.ndarray
    any_det: jnp.ndarray


class ReacqChunkOut(NamedTuple):
    ptrs: jnp.ndarray        # [det_max] global detection pointers
    delays: jnp.ndarray      # [det_max]
    peaks: jnp.ndarray       # [det_max]
    valid: jnp.ndarray       # [det_max] bool
    demod_ok: jnp.ndarray    # [det_max] bool — data window inside real samples
    chans: jnp.ndarray       # [det_max, nfft] per-detection channel estimate
    phasors: jnp.ndarray     # [det_max, nd, num_data_bins]
    hard_bits: jnp.ndarray   # [det_max, nd*num_data_bins*bits_per_bin]


def reacq_init(cfg: OFDMConfig) -> ReacqState:
    return ReacqState(
        hist=jnp.zeros(reacq_lag(cfg), jnp.complex64),
        base=jnp.int32(0),
        real_end=jnp.int32(0),
        last_det_ptr=jnp.int32(0),
        any_det=jnp.bool_(False))


def reacq_step(cfg: OFDMConfig, state: ReacqState, chunk: jnp.ndarray,
               n_real, det_max: int, fast=None, demod_path=None
               ) -> tuple[ReacqState, ReacqChunkOut]:
    """One chunk of the continuous multi-detection receiver.

    Processes the `chunk_len // stride` trials whose pointers fall in
    [base - lag + cp, base - lag + cp + chunk_len) — i.e. `lag` samples
    behind the input — so each trial's whole pattern reach is readable in
    ext = [hist, chunk].  The refractory rule continues across chunks via
    the carried (last_det_ptr, any_det).

    demod_path="dft" switches the per-detection spectra from the FFT op to
    bin-restricted DFT matmuls (stream_rx.demod_detections); None keeps the
    oracle-bit-exact FFT form the tests pin.
    """
    from ..models import stream_rx

    chunk_len = chunk.shape[0]
    lag = reacq_lag(cfg)
    stride = max(1, cfg.stride)
    assert chunk_len % stride == 0, "chunk must be stride-aligned"
    ext = jnp.concatenate([state.hist, chunk])
    ext_start = state.base - lag                 # global coord of ext[0]

    t_per = chunk_len // stride
    dmax_val, dmax_ind = stream_rx.detect_trials(cfg, ext, t_per, fast)
    local_ptrs = (cfg.cp_len + stride * jnp.arange(t_per)).astype(jnp.int32)
    global_ptrs = ext_start + local_ptrs
    gate = cfg.detection_gate * cfg.m_synch * cfg.num_synch_bins
    # trials before the stream head (chunk 0's warm-up region) don't exist
    crossing = (dmax_val > gate) & (global_ptrs >= cfg.cp_len)

    g_ptrs, (l_ptrs, delays, peaks), count, (last_ptr, any_det) = \
        sync.refractory_table(
            cfg, crossing,
            (local_ptrs, dmax_ind, dmax_val.astype(jnp.float32)),
            det_max, ext_start + cfg.cp_len,
            state.last_det_ptr, state.any_det)
    valid = jnp.arange(det_max) < count

    real_end = state.real_end + n_real
    chans, phasors, demod_ok = stream_rx.demod_detections(
        cfg, ext, l_ptrs, delays, valid, real_end - ext_start,
        demod_path=demod_path)
    hard = stream_rx.hard_decide(cfg, phasors)

    new_state = ReacqState(hist=ext[-lag:], base=state.base + chunk_len,
                           real_end=real_end, last_det_ptr=last_ptr,
                           any_det=any_det)
    out = ReacqChunkOut(ptrs=jnp.where(valid, g_ptrs, -1), delays=delays,
                        peaks=peaks, valid=valid, demod_ok=demod_ok,
                        chans=chans, phasors=phasors, hard_bits=hard)
    return new_state, out


def _push_many(rx, chunks, with_n_real=True):
    """Shared push_many body for all streaming receivers: K work() calls
    in ONE dispatch via lax.scan over rx._fn, bit-identical to K sequential
    push() calls (outputs gain a leading K axis).  Amortises the per-push
    host dispatch over K chunks.  Full chunks only; partial and
    flush chunks still go through push()/finish()."""
    chunks = jnp.asarray(chunks, jnp.complex64)
    assert chunks.ndim == 2 and chunks.shape[1] == rx.chunk_len
    k = chunks.shape[0]
    if k not in rx._many:
        fn, n = rx._fn, rx.chunk_len
        body = (lambda st, c: fn(st, c, jnp.int32(n))) if with_n_real else fn
        rx._many[k] = jax.jit(lambda st, ch: jax.lax.scan(body, st, ch))
    rx.state, outs = rx._many[k](rx.state, chunks)
    return outs


class ReacqStreamingRx:
    """Host-side driver for the continuous multi-detection receiver.

    The GNU Radio analog: the D1 loopback's RX thread calling
    synch_and_chan_est.work() forever — push(chunk) is one work() call,
    finish() flushes the lag so trailing detections resolve.
    """

    def __init__(self, cfg: OFDMConfig, chunk_len: int, fast=None,
                 demod_path=None):
        stride = max(1, cfg.stride)
        assert chunk_len % stride == 0
        self.cfg = cfg
        self.chunk_len = chunk_len
        self.det_max = reacq_det_max(cfg, chunk_len)
        self.state = reacq_init(cfg)
        self._fn = functools.partial(
            reacq_step, cfg, det_max=self.det_max, fast=fast,
            demod_path=demod_path)
        self._step = jax.jit(self._fn)
        self._many = {}

    def push(self, chunk, n_real: int | None = None) -> ReacqChunkOut:
        chunk = jnp.asarray(chunk, jnp.complex64)
        assert chunk.shape[0] == self.chunk_len
        if n_real is None:
            n_real = self.chunk_len
        self.state, out = self._step(self.state, chunk, jnp.int32(n_real))
        return out

    def push_many(self, chunks) -> ReacqChunkOut:
        """K work() calls in ONE dispatch (lax.scan) — see _push_many."""
        return _push_many(self, chunks)

    def finish(self) -> list[ReacqChunkOut]:
        """Flush the lag with zero chunks so trailing trials resolve."""
        outs = []
        flushed = 0
        while flushed < reacq_lag(self.cfg):
            outs.append(self.push(
                jnp.zeros(self.chunk_len, jnp.complex64), n_real=0))
            flushed += self.chunk_len
        return outs

    # -- checkpoint/resume (same npz convention as StreamingRx) ------------
    def save_state(self, path) -> None:
        s = self.state
        np.savez_compressed(
            path,
            hist_re=np.asarray(s.hist.real), hist_im=np.asarray(s.hist.imag),
            base=np.asarray(s.base), real_end=np.asarray(s.real_end),
            last_det_ptr=np.asarray(s.last_det_ptr),
            any_det=np.asarray(s.any_det))

    def load_state(self, path) -> None:
        with np.load(path) as z:
            self.state = ReacqState(
                hist=jnp.asarray(z["hist_re"] + 1j * z["hist_im"],
                                 jnp.complex64),
                base=jnp.int32(z["base"]),
                real_end=jnp.int32(z["real_end"]),
                last_det_ptr=jnp.int32(z["last_det_ptr"]),
                any_det=jnp.bool_(z["any_det"]))


class BatchReacqStreamingRx:
    """B independent continuous streams on one chip, one dispatch per step:
    the chunk step vmapped over a leading stream axis.

    This is the production serving shape — many carriers / antennas / users
    per device — and the way streaming fills the device: a single stream's
    chunk step is small, B of them batch the same FFTs and matmuls (the GR
    analog is B independent flowgraphs, each with its own
    RX thread).  Each stream has fully independent carry (lock table,
    refractory pointer, history).

    push(chunks):       [B, chunk_len]     -> ReacqChunkOut with leading B
    push_many(chunks):  [K, B, chunk_len]  -> leading (K, B); K sequential
                        steps of all B streams in ONE dispatch (lax.scan of
                        the vmapped step — composes both amortisations).
    """

    def __init__(self, cfg: OFDMConfig, chunk_len: int, batch: int,
                 fast=None, demod_path=None):
        stride = max(1, cfg.stride)
        assert chunk_len % stride == 0
        self.cfg = cfg
        self.chunk_len = chunk_len
        self.batch = batch
        self.det_max = reacq_det_max(cfg, chunk_len)
        base = functools.partial(
            reacq_step, cfg, det_max=self.det_max, fast=fast,
            demod_path=demod_path)
        # n_real broadcast: one scalar for all streams (sources advance in
        # lockstep; per-stream flush lengths aren't needed — finish() pads
        # every stream with the same zero chunks)
        self._fn = jax.vmap(base, in_axes=(0, 0, None))
        self._step = jax.jit(self._fn)
        self._many = {}
        one = reacq_init(cfg)
        self.state = jax.tree.map(
            lambda x: jnp.broadcast_to(x, (batch,) + x.shape), one)

    def push(self, chunks, n_real: int | None = None) -> ReacqChunkOut:
        chunks = jnp.asarray(chunks, jnp.complex64)
        assert chunks.shape == (self.batch, self.chunk_len)
        if n_real is None:
            n_real = self.chunk_len
        self.state, out = self._step(self.state, chunks, jnp.int32(n_real))
        return out

    def push_many(self, chunks) -> ReacqChunkOut:
        chunks = jnp.asarray(chunks, jnp.complex64)
        assert chunks.ndim == 3 and \
            chunks.shape[1:] == (self.batch, self.chunk_len)
        k = chunks.shape[0]
        if k not in self._many:
            fn, n = self._fn, self.chunk_len
            body = lambda st, c: fn(st, c, jnp.int32(n))
            self._many[k] = jax.jit(
                lambda st, ch: jax.lax.scan(body, st, ch))
        self.state, outs = self._many[k](self.state, chunks)
        return outs

    def finish(self) -> list[ReacqChunkOut]:
        """Flush the lag with zero chunks so trailing trials resolve."""
        outs = []
        flushed = 0
        while flushed < reacq_lag(self.cfg):
            outs.append(self.push(
                jnp.zeros((self.batch, self.chunk_len), jnp.complex64),
                n_real=0))
            flushed += self.chunk_len
        return outs


# ---------------------------------------------------------------------------
# Streaming tracker (R6 SynchronizeAndEstimate work() semantics)
# ---------------------------------------------------------------------------
#
# The GR tracker block (LEGACY/gr-ofdm-rx/python/SynchronizeAndEstimate.py)
# carries its pointer state machine across work() calls: search by stride,
# five nominal advances, then least-squares drift prediction.  Here the same
# scan step as the batch tracker (models/tracker.py:make_tracker_step) runs
# over chunks with the carry held in the stream state; fire-or-stall
# semantics make the chunked run accept exactly the batch run's detections.


def tracker_lag(cfg: OFDMConfig) -> int:
    """History: the pattern reach plus pointer-regression slack (the lstsq
    prediction can step back by ~cp/4; give it 2*cp)."""
    return cfg.pattern_len * cfg.rx_b_len + cfg.nfft + 2 * cfg.cp_len


class TrackStreamState(NamedTuple):
    hist: jnp.ndarray
    base: jnp.ndarray
    real_end: jnp.ndarray
    carry: tuple                 # the tracker scan carry (9 leaves)


class TrackChunkOut(NamedTuple):
    ptrs: jnp.ndarray            # [det_max] global detection pointers (-1 pad)
    delays: jnp.ndarray
    peaks: jnp.ndarray
    valid: jnp.ndarray
    chans: jnp.ndarray           # [det_max, nfft]
    phasors: jnp.ndarray         # [det_max, nd, num_data_bins]
    hard_bits: jnp.ndarray       # [det_max, nd*num_data_bins*bits_per_bin]


def track_stream_init(cfg: OFDMConfig) -> TrackStreamState:
    from ..models import tracker as trk

    return TrackStreamState(
        hist=jnp.zeros(tracker_lag(cfg), jnp.complex64),
        base=jnp.int32(0),
        real_end=jnp.int32(0),
        carry=trk.tracker_init_carry())


def track_stream_step(cfg: OFDMConfig, state: TrackStreamState,
                      chunk: jnp.ndarray, n_real, slots: int, det_max: int
                      ) -> tuple[TrackStreamState, TrackChunkOut]:
    from ..models import stream_rx
    from ..models import tracker as trk

    chunk_len = chunk.shape[0]
    lag = tracker_lag(cfg)
    ext = jnp.concatenate([state.hist, chunk])
    ext_start = state.base - lag
    ext_end = state.base + chunk_len
    real_end = state.real_end + n_real
    m0, nd = cfg.m_synch, cfg.synch_dat[1]
    # fire when the sync window fits the REAL stream (matching the batch
    # fits-check) and the pattern's data span is readable in ext
    fire_limit = jnp.minimum(
        real_end, ext_end - (nd - m0 + 1) * cfg.rx_b_len + 1)

    step = trk.make_tracker_step(cfg, ext, ext_start, fire_limit)
    carry, (acc, ptrs_all, dels_all, peaks_all, h_all) = lax.scan(
        step, state.carry, None, length=slots)

    (g_ptrs, delays, peaks), count = sync.emit_slots(
        acc, (ptrs_all, dels_all, peaks_all.astype(jnp.float32)), det_max)
    slot = jnp.cumsum(acc.astype(jnp.int32)) - 1
    ok_slot = acc & (slot < det_max)
    tgt = jnp.where(ok_slot, slot, det_max)
    chans = jnp.zeros((det_max, cfg.nfft), jnp.complex64).at[tgt].set(
        h_all, mode="drop")
    valid = jnp.arange(det_max) < count

    ptrs_local = jnp.where(valid, g_ptrs - ext_start, 0)
    fd, rot, ok = trk.demod_track_table(cfg, ext, ptrs_local, delays, valid,
                                        real_end - ext_start)
    h_d = chans[:, np.asarray(used_bins(cfg.nfft, cfg.num_data_bins)[1])]
    h_d = h_d[:, None, :]
    eq = (fd * rot * jnp.conj(h_d)) / (jnp.abs(h_d) ** 2 +
                                       1.0 / cfg.snr_linear)
    p1 = jnp.mean(jnp.abs(eq) ** 2, axis=-1, keepdims=True)
    phasors = eq / jnp.sqrt(jnp.maximum(p1, 1e-30)) * ok[..., None]
    hard = stream_rx.hard_decide(cfg, phasors)

    new_state = TrackStreamState(hist=ext[-lag:], base=state.base + chunk_len,
                                 real_end=real_end, carry=carry)
    out = TrackChunkOut(ptrs=jnp.where(valid, g_ptrs, -1), delays=delays,
                        peaks=peaks, valid=valid, chans=chans,
                        phasors=phasors, hard_bits=hard)
    return new_state, out


class TrackerStreamingRx:
    """Host-side driver for the streaming tracker (R6 semantics)."""

    def __init__(self, cfg: OFDMConfig, chunk_len: int):
        from ..models import tracker as trk

        self.cfg = cfg
        self.chunk_len = chunk_len
        self.slots = chunk_len // trk.tracker_stride(cfg) + 4
        self.det_max = chunk_len // (2 * cfg.cp_len + cfg.nfft) + 2
        self.state = track_stream_init(cfg)
        self._fn = functools.partial(
            track_stream_step, cfg, slots=self.slots, det_max=self.det_max)
        self._step = jax.jit(self._fn)
        self._many = {}

    def push(self, chunk, n_real: int | None = None) -> TrackChunkOut:
        chunk = jnp.asarray(chunk, jnp.complex64)
        assert chunk.shape[0] == self.chunk_len
        if n_real is None:
            n_real = self.chunk_len
        self.state, out = self._step(self.state, chunk, jnp.int32(n_real))
        return out

    def push_many(self, chunks) -> TrackChunkOut:
        """K work() calls in ONE dispatch (lax.scan) — see _push_many."""
        return _push_many(self, chunks)

    def finish(self) -> list[TrackChunkOut]:
        outs = []
        flushed = 0
        while flushed < tracker_lag(self.cfg) + self.chunk_len:
            outs.append(self.push(
                jnp.zeros(self.chunk_len, jnp.complex64), n_real=0))
            flushed += self.chunk_len
        return outs


class StreamingRx:
    """Host-side driver holding the jitted step + device-resident state.

    The GNU Radio analog: one sync_block whose work() is `step`, with the
    scheduler loop replaced by `push(chunk)` calls.
    """

    def __init__(self, cfg: OFDMConfig, chunk_len: int,
                 num_patterns_total: int | None = None):
        if num_patterns_total is None:
            num_patterns_total = cfg.num_patterns
        self.cfg = cfg
        self.chunk_len = chunk_len
        self.state = init_state(cfg, chunk_len)
        self._fn = functools.partial(
            stream_step, cfg, num_patterns_total=num_patterns_total)
        self._step = jax.jit(self._fn)
        self._many = {}

    def push(self, chunk) -> ChunkOut:
        chunk = jnp.asarray(chunk, jnp.complex64)
        assert chunk.shape[0] == self.chunk_len
        self.state, out = self._step(self.state, chunk)
        return out

    def push_many(self, chunks) -> ChunkOut:
        """K work() calls in ONE dispatch (lax.scan) — see _push_many."""
        return _push_many(self, chunks, with_n_real=False)

    def finish(self) -> ChunkOut:
        """Flush: push zeros so trailing blocks inside the history resolve."""
        return self.push(jnp.zeros(self.chunk_len, jnp.complex64))

    # -- checkpoint/resume (SURVEY.md §5: pickle persistence, done as npz) --
    def save_state(self, path) -> None:
        """Persist the carry so a stream can resume in a new process.
        Complex fields stored planar (re/im) — transfer-safe everywhere."""
        s = self.state
        np.savez_compressed(
            path,
            hist_re=np.asarray(s.hist.real), hist_im=np.asarray(s.hist.imag),
            base=np.asarray(s.base), locked=np.asarray(s.locked),
            lock_ptr=np.asarray(s.lock_ptr),
            delay_idx=np.asarray(s.delay_idx),
            chan_re=np.asarray(s.chan_full.real),
            chan_im=np.asarray(s.chan_full.imag),
            next_k=np.asarray(s.next_k),
            last_det_ptr=np.asarray(s.last_det_ptr))

    def load_state(self, path) -> None:
        with np.load(path) as z:
            self.state = StreamState(
                hist=jnp.asarray(z["hist_re"] + 1j * z["hist_im"],
                                 jnp.complex64),
                base=jnp.int32(z["base"]),
                locked=jnp.bool_(z["locked"]),
                lock_ptr=jnp.int32(z["lock_ptr"]),
                delay_idx=jnp.int32(z["delay_idx"]),
                chan_full=jnp.asarray(z["chan_re"] + 1j * z["chan_im"],
                                      jnp.complex64),
                next_k=jnp.int32(z["next_k"]),
                last_det_ptr=jnp.int32(z["last_det_ptr"]))


# ---------------------------------------------------------------------------
# Streaming legacy CFO/DSSS receiver (R4/R5 work() semantics)
# ---------------------------------------------------------------------------
#
# The legacy GR blocks (LEGACY/gr-ofdm-rx/python/SynchEstAndFO.py:233-363,
# SynchEstFOAndDSSS.py:269-412) run forever as streaming blocks: every work()
# call slides the CFO x delay search over the new samples, the detection
# table grows across calls, and each detection demodulates ONE following data
# symbol (re-mixed by its winning CFO candidate) which is then optionally
# DSSS-despread.  models/legacy_rx.py gives the batched whole-buffer form;
# here the same math runs chunk-by-chunk with the refractory rule carried
# across chunk edges, so the chunked outputs equal the batch run bit-for-bit
# (tests/test_stream_rx.py::TestLegacyStreaming).


def legacy_lag(cfg: OFDMConfig) -> int:
    """History length for the legacy stream: a trial at local pointer cp
    must read its synch pattern AND its one data symbol
    (SynchEstAndFO.py:323-331: data starts m_synch blocks after the lock),
    rounded up to a stride multiple so chunk trial grids stay aligned."""
    need = cfg.cp_len + cfg.m_synch * cfg.rx_b_len + cfg.nfft
    s = max(1, cfg.stride)
    return -(-need // s) * s


class LegacyStreamState(NamedTuple):
    hist: jnp.ndarray        # [lag] trailing samples
    base: jnp.ndarray        # global sample index of the next chunk's start
    real_end: jnp.ndarray    # global count of real (non-flush) samples
    last_det_ptr: jnp.ndarray
    any_det: jnp.ndarray


class LegacyChunkOut(NamedTuple):
    ptrs: jnp.ndarray        # [det_max] global detection pointers (-1 unused)
    delays: jnp.ndarray     # [det_max] winning delay hypotheses
    peaks: jnp.ndarray      # [det_max] correlation peaks
    fo_idx: jnp.ndarray     # [det_max] winning CFO candidate index
    valid: jnp.ndarray      # [det_max] bool
    demod_ok: jnp.ndarray   # [det_max] bool — data window inside real samples
    chans: jnp.ndarray      # [det_max, nfft] per-detection channel estimates
    phasors: jnp.ndarray    # [det_max, num_data_bins] equalised data
    despread: jnp.ndarray   # [det_max, num_data_bins/dsss]


def legacy_init(cfg: OFDMConfig) -> LegacyStreamState:
    return LegacyStreamState(
        hist=jnp.zeros(legacy_lag(cfg), jnp.complex64),
        base=jnp.int32(0),
        real_end=jnp.int32(0),
        last_det_ptr=jnp.int32(0),
        any_det=jnp.bool_(False))


def legacy_stream_step(cfg: OFDMConfig, state: LegacyStreamState,
                       chunk: jnp.ndarray, n_real, det_max: int,
                       bank: np.ndarray, dsss: int = 1
                       ) -> tuple[LegacyStreamState, LegacyChunkOut]:
    """One chunk of the continuous CFO-search receiver.

    Identical trial grid to reacq_step (trials lag `legacy_lag` behind the
    input so every trial's full reach is readable in ext = [hist, chunk]);
    the search itself is the fo-axis lax.scan of ops/cfo.py, holding one CFO
    candidate's spectra at a time.
    """
    from ..models import stream_rx
    from ..ops import cfo as cfo_ops

    chunk_len = chunk.shape[0]
    lag = legacy_lag(cfg)
    stride = max(1, cfg.stride)
    assert chunk_len % stride == 0, "chunk must be stride-aligned"
    ext = jnp.concatenate([state.hist, chunk])
    ext_start = state.base - lag                 # global coord of ext[0]

    t_per = chunk_len // stride
    dmax_val, delay_win, fo_win = cfo_ops.cfo_search_scan(cfg, ext, t_per,
                                                          bank)
    local_ptrs = (cfg.cp_len + stride * jnp.arange(t_per)).astype(jnp.int32)
    global_ptrs = ext_start + local_ptrs
    gate = cfg.detection_gate * cfg.m_synch * cfg.num_synch_bins
    crossing = (dmax_val > gate) & (global_ptrs >= cfg.cp_len)

    g_ptrs, (l_ptrs, delays, fo_sel, peaks), count, (last_ptr, any_det) = \
        sync.refractory_table(
            cfg, crossing,
            (local_ptrs, delay_win, fo_win, dmax_val.astype(jnp.float32)),
            det_max, ext_start + cfg.cp_len,
            state.last_det_ptr, state.any_det)
    valid = jnp.arange(det_max) < count
    fo_sel = fo_sel.astype(jnp.int32)

    # channel estimate per detection (SynchEstAndFO.py:285-321)
    det_spec = cfo_ops.spectra_at_detections(
        cfg, ext, jnp.where(valid, l_ptrs, 0), fo_sel, bank)
    _, chans, _ = jax.vmap(
        lambda s, d: sync.estimate_channel(cfg, s, d))(det_spec, delays)
    chans = chans * valid[:, None]

    # one data symbol per detection (SynchEstAndFO.py:323-356), re-mixed by
    # the winning CFO candidate; gated on the window lying in real samples
    real_end = state.real_end + n_real
    _, data_bins = used_bins(cfg.nfft, cfg.num_data_bins)
    data_bins = np.asarray(data_bins)
    start = l_ptrs + cfg.m_synch * cfg.rx_b_len
    demod_ok = valid & (g_ptrs + cfg.m_synch * cfg.rx_b_len + cfg.nfft
                        <= real_end)
    start = jnp.where(demod_ok, start, 0)
    win = cfo_ops.windows_at(ext, start, np.arange(cfg.nfft)) * \
        cfo_ops.bank_select(bank, fo_sel)
    f = jnp.fft.fft(win, cfg.nfft, axis=-1)
    fd = f[:, data_bins]
    power = jnp.sum(jnp.abs(fd) ** 2, axis=-1, keepdims=True)
    fd = fd * jnp.sqrt(fd.shape[-1] / jnp.maximum(power, 1e-30))
    rot = jnp.exp((1j * 2.0 * jnp.pi / cfg.nfft) *
                  delays[:, None].astype(jnp.float32) *
                  jnp.asarray(data_bins, jnp.float32)[None, :])
    chan_d = chans[:, data_bins]
    eq = sync.mmse_gain(chan_d, cfg.snr_linear)
    phasors = fd * rot * eq * demod_ok[:, None]
    despread = cfo_ops.dsss_despread(phasors, dsss)

    new_state = LegacyStreamState(
        hist=ext[-lag:], base=state.base + chunk_len, real_end=real_end,
        last_det_ptr=last_ptr, any_det=any_det)
    out = LegacyChunkOut(
        ptrs=jnp.where(valid, g_ptrs, -1), delays=delays, peaks=peaks,
        fo_idx=fo_sel, valid=valid, demod_ok=demod_ok, chans=chans,
        phasors=phasors, despread=despread)
    return new_state, out


class LegacyStreamingRx:
    """Host-side driver for the continuous CFO/DSSS receiver.

    The GNU Radio analog: the D4/D6 apps' RX thread calling
    SynchEstAndFO.work() / SynchEstFOAndDSSS.work() forever — push(chunk) is
    one work() call, finish() flushes the lag so trailing detections (and
    their data symbols) resolve.
    """

    def __init__(self, cfg: OFDMConfig, chunk_len: int, fo_range=(0.0,),
                 dsss: int = 1):
        from ..ops import cfo as cfo_ops

        stride = max(1, cfg.stride)
        assert chunk_len % stride == 0
        self.cfg = cfg
        self.chunk_len = chunk_len
        self.det_max = reacq_det_max(cfg, chunk_len)
        self.state = legacy_init(cfg)
        self._fn = functools.partial(
            legacy_stream_step, cfg, det_max=self.det_max,
            bank=cfo_ops.cfo_bank(cfg, fo_range), dsss=dsss)
        self._step = jax.jit(self._fn)
        self._many = {}

    def push(self, chunk, n_real: int | None = None) -> LegacyChunkOut:
        chunk = jnp.asarray(chunk, jnp.complex64)
        assert chunk.shape[0] == self.chunk_len
        if n_real is None:
            n_real = self.chunk_len
        self.state, out = self._step(self.state, chunk, jnp.int32(n_real))
        return out

    def push_many(self, chunks) -> LegacyChunkOut:
        """K work() calls in ONE dispatch (lax.scan) — see _push_many."""
        return _push_many(self, chunks)

    def finish(self) -> list[LegacyChunkOut]:
        """Flush the lag with zero chunks so trailing trials resolve."""
        outs = []
        flushed = 0
        while flushed < legacy_lag(self.cfg):
            outs.append(self.push(
                jnp.zeros(self.chunk_len, jnp.complex64), n_real=0))
            flushed += self.chunk_len
        return outs

    # -- checkpoint/resume (same npz convention as StreamingRx) ------------
    def save_state(self, path) -> None:
        s = self.state
        np.savez_compressed(
            path,
            hist_re=np.asarray(s.hist.real), hist_im=np.asarray(s.hist.imag),
            base=np.asarray(s.base), real_end=np.asarray(s.real_end),
            last_det_ptr=np.asarray(s.last_det_ptr),
            any_det=np.asarray(s.any_det))

    def load_state(self, path) -> None:
        with np.load(path) as z:
            self.state = LegacyStreamState(
                hist=jnp.asarray(z["hist_re"] + 1j * z["hist_im"],
                                 jnp.complex64),
                base=jnp.int32(z["base"]),
                real_end=jnp.int32(z["real_end"]),
                last_det_ptr=jnp.int32(z["last_det_ptr"]),
                any_det=jnp.bool_(z["any_det"]))
