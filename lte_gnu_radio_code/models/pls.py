"""PLS MIMO key-exchange protocol (P1) as jitted JAX steps.

Three-state Alice/Bob machine (pls_aio.py:107-141) with the state hops kept
on the host (the reference's GNU Radio message-port analog, SURVEY.md §2.8
X4) and every per-state signal path jitted:

  alice0:  random unitary precoders -> precoded references     -> TX buffer
  bob:     estimate+SVD -> rotate key-bit DFT precoders by U_B -> TX buffer
  alice2:  estimate+SVD -> PMI min-distance -> recovered key bits

The 2x2 MIMO multipath channel + AWGN loopback replicates topblock.py:21-95.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

from ..ops import pls as pls_ops
from ..reference_cpu.pls import ref_signal as ref_signal_np
from ..utils.params import PLSConfig


def make_pls(cfg: PLSConfig):
    """Returns (alice0, bob, alice2) jitted closures sharing the seeded
    reference signals (np.random.seed(250) draw, pls_aio.py:309-325)."""
    ref = ref_signal_np(cfg)

    @jax.jit
    def alice0(key):
        u_a = pls_ops.random_unitary(
            key, (cfg.num_data_symb, cfg.num_subbands), cfg.num_ant)
        return pls_ops.transmit(cfg, u_a, ref)

    @jax.jit
    def bob(rx_time, key_bits):
        lsv_b, _, _, _ = pls_ops.receive(cfg, rx_time, ref)
        f = pls_ops.bits_to_precoders(cfg, key_bits)
        prec = pls_ops.rotated_precoder(lsv_b, f)
        return pls_ops.transmit(cfg, prec, ref)

    @jax.jit
    def alice2(rx_time):
        _, _, _, bits = pls_ops.receive(cfg, rx_time, ref)
        return bits

    return alice0, bob, alice2


def mimo_channel(cfg: PLSConfig, tx: jnp.ndarray, h: np.ndarray,
                 key: jax.Array | None = None,
                 snr_db: float | None = None,
                 out_len: int | None = None) -> jnp.ndarray:
    """[n_tx, T] through per-pair normalised CIRs + optional AWGN
    (topblock.py:21-78); output truncated to ``out_len`` (default: the
    frame length, as the reference's perfect-timing loopback does; the
    sync-locked exchange keeps the delay tail instead)."""
    n = cfg.num_ant
    taps = h.shape[-1]
    hn = h / np.linalg.norm(h, axis=-1, keepdims=True)
    n_out = tx.shape[-1] + taps - 1
    if out_len is None:
        out_len = cfg.frame_len
    nfft = int(2 ** np.ceil(np.log2(max(n_out, out_len, 2))))
    s = jnp.fft.fft(tx, nfft, axis=-1)
    hh = jnp.fft.fft(jnp.asarray(hn.astype(np.complex64)), nfft, axis=-1)
    y = jnp.fft.ifft(jnp.einsum("tf,rtf->rf", s, hh,
                                precision=jax.lax.Precision.HIGHEST),
                     nfft, axis=-1)
    y = y[:, :out_len]
    if snr_db is not None and key is not None:
        sig_pow = jnp.mean(jnp.abs(tx) ** 2)
        nv = sig_pow * 10 ** (-snr_db / 10)
        kr, ki = jax.random.split(key)
        noise = (jax.random.normal(kr, y.shape) +
                 1j * jax.random.normal(ki, y.shape)).astype(jnp.complex64)
        y = y + jnp.sqrt(nv / 2.0).astype(jnp.float32) * noise
    return y.astype(jnp.complex64)


def key_exchange(cfg: PLSConfig, key_bits: jnp.ndarray, key: jax.Array,
                 h: np.ndarray | None = None,
                 snr_db: float | None = None):
    """Full 3-state exchange; returns (recovered_bits, n_bit_errors)."""
    if h is None:
        h = np.ones((cfg.num_ant, cfg.num_ant, 1), dtype=np.complex128)
    alice0, bob, alice2 = make_pls(cfg)
    k0, k1, k2 = jax.random.split(key, 3)
    tx_a = alice0(k0)
    rx_b = mimo_channel(cfg, tx_a, h, k1, snr_db)
    tx_b = bob(rx_b, key_bits)
    h_back = np.swapaxes(h, 0, 1)         # physical reciprocity
    rx_a = mimo_channel(cfg, tx_b, h_back, k2, snr_db)
    bits = alice2(rx_a)
    err = jnp.sum(jnp.bitwise_xor(bits, key_bits.reshape(-1)))
    return bits, err


def make_pls_synced(cfg: PLSConfig, max_delay: int):
    """make_pls with the RX states behind a REAL timing lock
    (ops/pls.receive_synced): Bob and Alice each delay-search the frame's ZC
    synch before CP-stripping, instead of the reference's perfect-timing
    slice (pls_aio.py:427-457).  RX buffers carry frame_len + max_delay
    samples so the delayed frame is fully visible."""
    ref = ref_signal_np(cfg)

    @jax.jit
    def alice0(key):
        u_a = pls_ops.random_unitary(
            key, (cfg.num_data_symb, cfg.num_subbands), cfg.num_ant)
        return pls_ops.transmit(cfg, u_a, ref)

    @jax.jit
    def bob(rx_time, key_bits):
        lsv_b, _, _, _, ptr_b = pls_ops.receive_synced(cfg, rx_time, ref,
                                                       max_delay)
        f = pls_ops.bits_to_precoders(cfg, key_bits)
        prec = pls_ops.rotated_precoder(lsv_b, f)
        return pls_ops.transmit(cfg, prec, ref), ptr_b

    @jax.jit
    def alice2(rx_time):
        _, _, _, bits, ptr_a = pls_ops.receive_synced(cfg, rx_time, ref,
                                                      max_delay)
        return bits, ptr_a

    return alice0, bob, alice2


def key_exchange_synced(cfg: PLSConfig, key_bits: jnp.ndarray,
                        key: jax.Array, h: np.ndarray,
                        snr_db: float | None = None, max_delay: int = 16):
    """Full 3-state exchange over a channel WITH propagation delay, timing
    recovered by the ZC delay search at both ends (round-4 completion; the
    reference's PLS cannot run this scenario at all).

    Returns (recovered_bits, n_bit_errors, (bob_lock, alice_lock))."""
    alice0, bob, alice2 = make_pls_synced(cfg, max_delay)
    k0, k1, k2 = jax.random.split(key, 3)
    ext = cfg.frame_len + max_delay
    tx_a = alice0(k0)
    rx_b = mimo_channel(cfg, tx_a, h, k1, snr_db, out_len=ext)
    tx_b, ptr_b = bob(rx_b, key_bits)
    h_back = np.swapaxes(h, 0, 1)         # physical reciprocity
    rx_a = mimo_channel(cfg, tx_b, h_back, k2, snr_db, out_len=ext)
    bits, ptr_a = alice2(rx_a)
    err = jnp.sum(jnp.bitwise_xor(bits, key_bits.reshape(-1)))
    return bits, err, (ptr_b, ptr_a)
