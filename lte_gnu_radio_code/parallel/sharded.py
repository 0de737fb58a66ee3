"""Time-axis sharded RX — the JAX replacement for the reference's
streaming scheduler (SURVEY.md §2.8 X1-X3).

The sample stream is sharded into contiguous chunks across the "t" mesh axis.
Each device:

  1. receives its right neighbour's leading ``halo`` samples via
     ``lax.ppermute`` (the overlap-save boundary exchange — every sync trial
     and every data symbol that straddles a shard edge is resolved locally),
  2. runs the dense delay-search correlation on its own trial offsets,
  3. participates in a global first-lock merge (``pmin`` over the earliest
     gate crossing — identical to the unsharded first-crossing rule),
  4. demodulates exactly the pattern blocks whose base pointer falls inside
     its chunk and scatters them into the global phasor array via ``psum``.

The result is bit-identical to the single-device RX for any shard count
(tested in tests/test_sharding.py).

Halo size: a sync trial starting at relative offset cp + j*stride reads at
most (m_synch-1)*(nfft+cp) + nfft further; a data block based at the chunk
edge reads at most (pattern_len-1)*(nfft+cp) + nfft further.  The halo is
the max of the two — the `M[0]*(NFFT+CP)+NFFT` boundary-sample rule of
SURVEY.md §5.

Reference semantics replicated: gr-RXOFDM/python/synch_and_chan_est.py:140-266
(search + single-lock + MMSE), TEST/GNU_RADIO_OFFLINE/synch_and_chan_est.py.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..ops import modulation, sync
from ..ops.zadoff_chu import delay_search_matrix, zc_for_config
from ..utils.params import OFDMConfig, used_bins
from ..models.rxofdm import RxResult

INT_MAX = np.iinfo(np.int32).max


def sync_halo(cfg: OFDMConfig) -> int:
    return cfg.cp_len + (cfg.m_synch - 1) * cfg.rx_b_len + cfg.nfft


def data_halo(cfg: OFDMConfig) -> int:
    return (cfg.pattern_len - 1) * cfg.rx_b_len + cfg.nfft


def halo_size(cfg: OFDMConfig) -> int:
    return max(sync_halo(cfg), data_halo(cfg))


def padded_len(cfg: OFDMConfig, n: int, n_shards: int) -> int:
    """Global buffer length padded so each shard is a stride multiple."""
    quantum = n_shards * max(1, cfg.stride)
    return int(-(-n // quantum) * quantum)


def _local_rx(cfg: OFDMConfig, x_local: jnp.ndarray, *, axis: str,
              n_shards: int, n_global: int, num_patterns: int) -> RxResult:
    """Per-device body (runs inside shard_map over mesh axis ``axis``)."""
    local = x_local.shape[0]
    halo = halo_size(cfg)
    assert halo <= local, (
        f"shard chunk ({local}) smaller than halo ({halo}); use fewer shards")
    i = lax.axis_index(axis)
    a0 = i * local                                    # my chunk's global start

    # -- 1. halo exchange: receive right neighbour's first `halo` samples ----
    perm = [(s, (s - 1) % n_shards) for s in range(n_shards)]
    nbr = lax.ppermute(x_local, axis, perm)
    ext = jnp.concatenate([x_local, nbr[:halo]])

    # -- 2. local sync search ------------------------------------------------
    t_per = local // max(1, cfg.stride)               # trials per shard
    n_trials_global = sync.n_trials_for(cfg, n_global)
    spectra = sync.sync_spectra(cfg, ext, t_per)      # local trial j == global i*t_per+j
    corr = jnp.abs(sync.sync_correlate(cfg, spectra))

    dmax_val = jnp.max(corr, axis=-1)
    dmax_ind = jnp.argmax(corr, axis=-1)
    gate = cfg.detection_gate * cfg.m_synch * cfg.num_synch_bins
    p_global = i * t_per + jnp.arange(t_per)
    crossing = (dmax_val > gate) & (p_global < n_trials_global)

    # -- 3. global first-lock merge -----------------------------------------
    found_local = jnp.any(crossing)
    first_j = jnp.argmax(crossing)
    key = jnp.where(found_local, p_global[first_j], INT_MAX).astype(jnp.int32)
    gmin = lax.pmin(key, axis)
    found = gmin < INT_MAX
    is_winner = found_local & (key == gmin)
    w = is_winner.astype(jnp.float32)

    lock_ptr = cfg.cp_len + cfg.stride * gmin
    delay_idx = lax.psum(jnp.where(is_winner, dmax_ind[first_j], 0), axis)
    peak = lax.psum(w * dmax_val[first_j], axis)

    _, chan_full_l, cir_l = sync.estimate_channel(cfg, spectra[first_j],
                                                  dmax_ind[first_j])
    chan_full = lax.psum(chan_full_l * w, axis)
    cir = lax.psum(cir_l * w, axis)

    # -- 4. data demod: blocks based inside my chunk ------------------------
    _, data_bins = used_bins(cfg.nfft, cfg.num_data_bins)
    data_bins = np.asarray(data_bins)
    m0, nd = cfg.m_synch, cfg.synch_dat[1]
    block = cfg.pattern_len * cfg.rx_b_len
    k_slots = local // block + 2

    k0 = jnp.maximum(0, -((lock_ptr - a0) // block))
    k = k0 + jnp.arange(k_slots)                      # candidate global blocks
    b_k = lock_ptr + k * block                        # block base pointers
    own = (b_k >= a0) & (b_k < a0 + local) & (k < num_patterns) & found

    rel = jnp.where(own, b_k - a0, 0)
    start = rel[:, None] + (m0 + jnp.arange(nd))[None, :] * cfg.rx_b_len
    idx = start[..., None] + jnp.arange(cfg.nfft)[None, None, :]
    win = ext[idx]                                    # [k_slots, nd, nfft]
    f = jnp.fft.fft(win, cfg.nfft, axis=-1)
    fd = f[..., data_bins]
    power = jnp.sum(jnp.abs(fd) ** 2, axis=-1, keepdims=True)
    fd = fd * jnp.sqrt(fd.shape[-1] / jnp.maximum(power, 1e-30))

    rot = jnp.exp((1j * 2.0 * jnp.pi / cfg.nfft) * delay_idx *
                  jnp.asarray(data_bins, jnp.float32)).astype(jnp.complex64)
    eq = sync.mmse_gain(chan_full[data_bins], cfg.snr_linear)
    vals = fd * rot[None, None, :] * eq[None, None, :]
    vals = vals * own[:, None, None]

    tgt = jnp.where(own, k, num_patterns)             # drop rows we don't own
    ph_local = jnp.zeros((num_patterns, nd, cfg.num_data_bins), jnp.complex64)
    ph_local = ph_local.at[tgt].set(vals, mode="drop")
    phasors = lax.psum(ph_local, axis).reshape(num_patterns * nd,
                                               cfg.num_data_bins)

    if cfg.modulation == "QPSK":
        hard, llr0, llr1 = modulation.qpsk_llr(phasors)
    else:
        # MMSE amplitude unbias before the QAM grid decision — identical to
        # models/rxofdm.py so sharded == single-device stays bit-exact
        phasors = phasors * sync.demap_unbias_gain(chan_full[data_bins],
                                                   cfg.snr_linear)[None, :]
        hard, llr = modulation.maxlog_llr(phasors, cfg.modulation,
                                          1.0 / cfg.snr_linear)
        llr0, llr1 = -llr, llr
    return RxResult(phasors, hard, llr0, llr1, lock_ptr, delay_idx, peak,
                    found, cir)


def sharded_rx_frame(cfg: OFDMConfig, x: jnp.ndarray, mesh: Mesh,
                     axis: str = "t", num_patterns: int | None = None
                     ) -> RxResult:
    """Demodulate a sample buffer sharded over mesh axis ``axis``.

    ``x`` is the full [n] buffer; it is zero-padded to a shard multiple and
    processed under shard_map.  Output is fully replicated.
    """
    from ..models.rxofdm import plan_rx

    n = int(x.shape[0])
    n_shards = mesh.shape[axis]
    n_pad = padded_len(cfg, n, n_shards)
    if num_patterns is None:
        _, num_patterns = plan_rx(cfg, n)
    x = jnp.pad(x, (0, n_pad - n)).astype(jnp.complex64)

    body = functools.partial(_local_rx, cfg, axis=axis, n_shards=n_shards,
                             n_global=n, num_patterns=num_patterns)
    in_spec = P(axis)
    out_spec = jax.tree.map(lambda _: P(), RxResult(*[0] * 9))
    fn = shard_map(body, mesh=mesh, in_specs=(in_spec,),
                   out_specs=out_spec, check_vma=False)
    return fn(x)


def make_sharded_rx(cfg: OFDMConfig, n_samples: int, mesh: Mesh,
                    axis: str = "t"):
    """Jitted sharded RX for a fixed buffer length."""
    from ..models.rxofdm import plan_rx

    _, num_patterns = plan_rx(cfg, n_samples)

    @jax.jit
    def run(x):
        return sharded_rx_frame(cfg, x, mesh, axis, num_patterns)

    return run
