"""PLS (physical-layer-security) ops: DFT codebook, random unitaries,
closed-form batched 2x2 complex SVD, PMI estimation, precoded OFDM TX/RX.

Batched-JAX choices vs the reference (TEST/GNU_RADIO_OFFLINE/pls_aio.py):

* object-arrays of 2x2 matrices -> dense [symb, subband, n, n] tensors
* per-subband numpy SVD loop -> one vmapped closed-form Hermitian-eigen
  2x2 SVD (SURVEY.md §7.3: deterministic and orders of magnitude cheaper
  than a general LAPACK SVD per tiny matrix)
* per-bin Python loops -> batched FFTs and einsums
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from ..utils.params import PLSConfig
from ..reference_cpu.pls import codebook as codebook_np
from ..reference_cpu.pls import synch_mask as synch_mask_np
from ..reference_cpu.pls import ref_signal as ref_signal_np

# the SVD/PMI key decisions and the timing lock depend on these
# contractions: keep them at full float32 precision
_HP = jax.lax.Precision.HIGHEST


def random_unitary(key: jax.Array, shape, n: int) -> jnp.ndarray:
    """[*shape, n, n] Haar-ish unitaries: QR of uniform(0,1)+j*uniform(0,1)
    with R-diagonal phase fix — the reference's construction
    (pls_aio.py:236-249), batched."""
    k1, k2 = jax.random.split(key)
    m = (jax.random.uniform(k1, (*shape, n, n)) +
         1j * jax.random.uniform(k2, (*shape, n, n))).astype(jnp.complex64)
    q, r = jnp.linalg.qr(m)
    d = jnp.diagonal(r, axis1=-2, axis2=-1)
    ph = d / jnp.abs(d)
    return q * ph[..., None, :]


def svd2x2(a: jnp.ndarray):
    """Closed-form SVD of batched 2x2 complex matrices [..., 2, 2].

    Returns (u, s, v) with a = u @ diag(s) @ v^H, s descending, and the
    reference's first-row phase normalisation applied to u and v columns
    (pls_aio.py:536-543).  Built from the Hermitian eigenproblem of a^H a.
    """
    ah = jnp.conj(jnp.swapaxes(a, -1, -2))
    b = jnp.matmul(ah, a, precision=_HP)
    alpha = b[..., 0, 0].real
    gamma = b[..., 1, 1].real
    beta = b[..., 0, 1]
    tr = alpha + gamma
    dif = alpha - gamma
    rad = jnp.sqrt(dif * dif + 4.0 * jnp.abs(beta) ** 2)
    l1 = (tr + rad) / 2.0
    l2 = jnp.maximum((tr - rad) / 2.0, 0.0)
    s1 = jnp.sqrt(jnp.maximum(l1, 0.0))
    s2 = jnp.sqrt(l2)

    # eigenvector of B for l1; fall back to axis vectors when B is diagonal
    off = jnp.abs(beta) > 1e-12 * jnp.maximum(tr, 1e-30)
    v11 = jnp.where(off, beta, jnp.where(dif >= 0, 1.0 + 0j, 0.0 + 0j))
    v21 = jnp.where(off, (l1 - alpha).astype(beta.dtype),
                    jnp.where(dif >= 0, 0.0 + 0j, 1.0 + 0j))
    nrm = jnp.sqrt(jnp.abs(v11) ** 2 + jnp.abs(v21) ** 2)
    v11, v21 = v11 / nrm, v21 / nrm
    # orthogonal complement
    v12 = -jnp.conj(v21)
    v22 = jnp.conj(v11)
    v = jnp.stack([jnp.stack([v11, v12], -1), jnp.stack([v21, v22], -1)], -2)

    u1 = jnp.matmul(a, v[..., :, 0:1], precision=_HP)[..., 0]
    u1n = jnp.sqrt(jnp.sum(jnp.abs(u1) ** 2, -1, keepdims=True))
    u1 = u1 / jnp.maximum(u1n, 1e-30)
    u2_raw = jnp.matmul(a, v[..., :, 1:2], precision=_HP)[..., 0]
    u2n = jnp.sqrt(jnp.sum(jnp.abs(u2_raw) ** 2, -1, keepdims=True))
    # when sigma2 ~ 0, use the orthogonal complement of u1 instead
    u2_ortho = jnp.stack([-jnp.conj(u1[..., 1]), jnp.conj(u1[..., 0])], -1)
    tiny = (u2n[..., 0] < 1e-6 * jnp.maximum(s1, 1e-30))[..., None]
    u2 = jnp.where(tiny, u2_ortho, u2_raw / jnp.maximum(u2n, 1e-30))
    u = jnp.stack([u1, u2], -1)

    # first-row phase normalisation (pls_aio.py:536-543)
    def phase_norm(m):
        ph = jnp.exp(-1j * jnp.angle(m[..., 0:1, :]))
        return m * ph

    s = jnp.stack([s1, s2], -1)
    return phase_norm(u), s, phase_norm(v)


def pmi_estimate(cfg: PLSConfig, rx_precoder: jnp.ndarray):
    """Min Frobenius distance to the DFT codebook (pls_aio.py:546-577).

    rx_precoder [S, SB, n, n] -> (pmi [S, SB], bits [S*SB*bit_codebook])."""
    cb = jnp.asarray(codebook_np(cfg).astype(np.complex64))
    diff = rx_precoder[:, :, None] - cb[None, None]
    dist = jnp.sum(jnp.abs(diff) ** 2, axis=(-2, -1))
    pmi = jnp.argmin(dist, axis=-1)
    shifts = jnp.arange(cfg.bit_codebook - 1, -1, -1)
    bits = (pmi[..., None] >> shifts) & 1
    return pmi, bits.reshape(-1)


def bits_to_precoders(cfg: PLSConfig, bits: jnp.ndarray) -> jnp.ndarray:
    """key bits -> [S, SB, n, n] codebook precoders (pls_aio.py:251-291)."""
    cb = jnp.asarray(codebook_np(cfg).astype(np.complex64))
    b = bits.reshape(cfg.num_data_symb, cfg.num_subbands, cfg.bit_codebook)
    w = 2 ** jnp.arange(cfg.bit_codebook - 1, -1, -1)
    idx = jnp.sum(b * w, axis=-1)
    return cb[idx]


def rotated_precoder(rotation: jnp.ndarray, dft: jnp.ndarray) -> jnp.ndarray:
    """conj(U) @ conj(F)^T (pls_aio.py:293-307)."""
    return jnp.einsum("xyab,xycb->xyac", jnp.conj(rotation), jnp.conj(dft),
                      precision=_HP)


def transmit(cfg: PLSConfig, precoders: jnp.ndarray,
             ref_sig: np.ndarray) -> jnp.ndarray:
    """Precoders + refs -> [n_ant, frame_len] time buffer.

    Batched equivalent of apply_precoders + ofdm_modulate + synch_data_mux
    (pls_aio.py:327-400,591-622) with the adjudicated symmetric per-antenna
    scale (see reference_cpu/pls.py:ofdm_modulate)."""
    S, B = cfg.num_data_symb, cfg.num_data_bins
    n, sbs = cfg.num_ant, cfg.subband_size
    bins = np.asarray(cfg.used_data_bins())

    # [S, n_ant, B]: subband sb's precoder columns are bins sb*sbs..(sb+1)*sbs
    fbin = jnp.swapaxes(precoders, 2, 3).reshape(S, cfg.num_subbands * sbs, n)
    fbin = jnp.swapaxes(fbin, 1, 2)                    # [S, n, B]
    fbin = fbin * jnp.asarray(ref_sig.astype(np.complex64))[:, None, :]

    grid = jnp.zeros((S, n, cfg.nfft), jnp.complex64).at[:, :, bins].set(fbin)
    t = jnp.fft.ifft(grid, cfg.nfft, axis=-1)
    t = jnp.concatenate([t[..., -cfg.cp_len:], t], axis=-1)  # [S, n, symb_len]
    # joint per-symbol scalar only: a per-antenna energy scale would inject a
    # diag distortion into the effective precoder and break SVD reciprocity
    # (see reference_cpu/pls.py:ofdm_modulate for the analysis)
    mean = jnp.mean(t, axis=-1, keepdims=True)
    p = jnp.sum(jnp.mean(jnp.abs(t - mean) ** 2, axis=-1), axis=1)  # [S]
    t = t / jnp.sqrt(p)[:, None, None]

    mask = jnp.asarray(synch_mask_np(cfg).astype(np.complex64))
    buf = mask.reshape(n, cfg.total_num_symb, cfg.symb_len)
    data_rows = np.where(np.asarray(cfg.symbol_pattern()) == 1)[0]
    buf = buf.at[:, data_rows, :].set(jnp.swapaxes(t, 0, 1))
    return buf.reshape(n, cfg.frame_len)


def receive(cfg: PLSConfig, rx_time: jnp.ndarray, ref_sig: np.ndarray):
    """[n_ant, frame_len] -> (lsv, sval, rsv, bits) per subband.

    Batched synchronize + channel_estimate + bins2subbands + sv_decomp
    (pls_aio.py:427-544)."""
    n = cfg.num_ant
    bins = np.asarray(cfg.used_data_bins())
    data_rows = np.where(np.asarray(cfg.symbol_pattern()) == 1)[0]
    sym = rx_time.reshape(n, cfg.total_num_symb, cfg.symb_len)
    data = sym[:, data_rows, cfg.cp_len:]              # [n, S, nfft]
    f = jnp.fft.fft(data, cfg.nfft, axis=-1)
    est = f[..., bins] * jnp.conj(jnp.asarray(ref_sig.astype(np.complex64)))[None]
    # [n, S, B] -> [S, SB, n_rx, sbs]
    est = jnp.swapaxes(est, 0, 1).reshape(
        cfg.num_data_symb, n, cfg.num_subbands, cfg.subband_size)
    h_sb = jnp.swapaxes(est, 1, 2)
    lsv, sval, rsv = svd2x2(h_sb)
    pmi, bits = pmi_estimate(cfg, rsv)
    return lsv, sval, rsv, bits


# ---------------------------------------------------------------------------
# Timing synchronisation over the PLS frame (round-4 completion)
# ---------------------------------------------------------------------------
#
# The reference's PLS "synchronize" is perfect-timing CP-stripping — it
# slices the frame assuming it starts at sample 0 (pls_aio.py:427-457); the
# key exchange therefore cannot survive a channel with propagation delay.
# The framework's ZC delay-search machinery (ops/sync.py) completes this:
# the PLS frame's own synch symbols (per-antenna ZC alternation, primes
# [23, 41] — pls_aio.py:161-194) are correlated against their known
# frequency content under max_delay+1 integer-offset hypotheses, and the
# lock pointer feeds a dynamic slice before the standard receive.  This
# EXCEEDS the reference (same spirit as the completed MIMO modes and split
# PLS nodes).


def _synch_freq(cfg: PLSConfig):
    """(synch rows, owning antenna per row, [S0, nfft] known freq content).

    Host-side constants derived from the same synch mask the TX inserts
    (reference_cpu/pls.py:synch_mask)."""
    mask = synch_mask_np(cfg)
    sym = mask.reshape(cfg.num_ant, cfg.total_num_symb, cfg.symb_len)
    synch_rows = np.where(np.asarray(cfg.symbol_pattern()) == 0)[0]
    win = sym[:, synch_rows, cfg.cp_len:]              # [n_ant, S0, nfft]
    f = np.fft.fft(win, cfg.nfft, axis=-1)
    own = np.argmax(np.sum(np.abs(f), axis=-1), axis=0)
    freq = f[own, np.arange(len(synch_rows))]          # [S0, nfft]
    return synch_rows, own, freq.astype(np.complex64)


def sync_lock(cfg: PLSConfig, rx_time: jnp.ndarray, max_delay: int):
    """Integer-delay timing search on the frame's ZC synch symbols.

    rx_time: [n_ant, >= frame_len + max_delay].  For each candidate offset
    d in 0..max_delay, CP-strip every synch symbol at its nominal start + d,
    FFT, and correlate coherently across the used synch bins with the known
    per-symbol ZC content; the metric sums |corr| over synch symbols and RX
    antennas (each TX antenna's ZC arrives on every RX antenna through the
    channel, so all contribute).  Returns the argmax offset (traced int32).
    """
    synch_rows, _, freq = _synch_freq(cfg)
    bins = np.asarray(cfg.used_synch_bins())
    starts = synch_rows * cfg.symb_len + cfg.cp_len
    cand = np.arange(max_delay + 1)
    idx = (starts[None, :, None] + cand[:, None, None] +
           np.arange(cfg.nfft)[None, None, :])         # [D, S0, nfft]
    win = rx_time[:, jnp.asarray(idx)]                 # [n_ant, D, S0, nfft]
    f = jnp.fft.fft(win, cfg.nfft, axis=-1)[..., bins]
    corr = jnp.einsum("rdsb,sb->rds", f,
                      jnp.conj(jnp.asarray(freq[:, bins])), precision=_HP)
    metric = jnp.sum(jnp.abs(corr), axis=(0, 2))       # [D]
    return jnp.argmax(metric).astype(jnp.int32)


def receive_synced(cfg: PLSConfig, rx_time: jnp.ndarray, ref_sig: np.ndarray,
                   max_delay: int):
    """receive() behind a real timing lock: delay-search the ZC synch,
    dynamic-slice the frame at the lock, then the standard estimate/SVD/PMI
    path.  Returns (lsv, sval, rsv, bits, lock_ptr)."""
    ptr = sync_lock(cfg, rx_time, max_delay)
    x = jax.lax.dynamic_slice_in_dim(rx_time, ptr, cfg.frame_len, axis=1)
    lsv, sval, rsv, bits = receive(cfg, x, ref_sig)
    return lsv, sval, rsv, bits, ptr
