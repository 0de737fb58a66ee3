"""Bit <-> symbol mapping and soft demapping, jittable and batched.

QPSK uses the reference's pi/8-offset constellation exp(j*2*pi/8*{1,-1,3,5})
with MSB-first bit pairs (MultiAntennaSystem.py:159-178) and the quadrant-wise
LLR demap of BitRecovery.py:66-157.  16/64-QAM are the Gray-mapped square
constellations required by BASELINE.json configs 2-4 (the reference itself is
BPSK/QPSK-only); LLRs are max-log.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

QPSK_POINTS = np.exp(1j * 2.0 * np.pi / 8.0 *
                     np.array([1.0, -1.0, 3.0, 5.0])).astype(np.complex64)

_SQRT2 = 1.414213562373095


def _gray_qam_constellation(bits_per_axis: int) -> np.ndarray:
    """Gray-mapped PAM levels per axis, unit average power per complex symbol."""
    m = 1 << bits_per_axis
    # Gray code ordering of levels: level index g for bit pattern b
    levels = np.arange(m)
    gray = levels ^ (levels >> 1)
    # position of each gray codeword on the amplitude axis
    pos = np.empty(m, dtype=np.int64)
    pos[gray] = levels
    amp = 2 * pos - (m - 1)
    scale = np.sqrt(2.0 * (m * m - 1) / 3.0)
    return (amp / scale).astype(np.float32)


QAM16_PAM = _gray_qam_constellation(2)   # indexed by 2-bit pattern
QAM64_PAM = _gray_qam_constellation(3)   # indexed by 3-bit pattern

BITS_PER_SYMBOL = {"BPSK": 1, "QPSK": 2, "QAM16": 4, "QAM64": 6}


def bits_to_symbols(bits: jnp.ndarray, modulation: str) -> jnp.ndarray:
    """[n*bits_per_symbol] bits -> [n] complex64 constellation points."""
    if modulation == "BPSK":
        return (2.0 * bits - 1.0).astype(jnp.complex64)
    if modulation == "QPSK":
        # arithmetic form of QPSK_POINTS[2*b0+b1]: the pi/8-offset
        # constellation is (+-K, +-K) with K = cos(pi/4), re sign from the
        # MSB, im sign from the LSB — bit-exact vs the float32 table (all
        # four |components| round to the same float32), and free of the
        # data-dependent gather a table lookup needs.
        b = bits.reshape(-1, 2).astype(jnp.float32)
        k = jnp.float32(0.7071067811865476)
        return jax.lax.complex((1.0 - 2.0 * b[:, 0]) * k,
                               (1.0 - 2.0 * b[:, 1]) * k
                               ).astype(jnp.complex64)
    if modulation in ("QAM16", "QAM64"):
        k = BITS_PER_SYMBOL[modulation] // 2
        pam = jnp.asarray(QAM16_PAM if modulation == "QAM16" else QAM64_PAM)
        b = bits.reshape(-1, 2 * k)
        w = 2 ** jnp.arange(k - 1, -1, -1)
        i_idx = (b[:, :k] * w).sum(-1)
        q_idx = (b[:, k:] * w).sum(-1)
        # one-hot select instead of a dynamic gather (exact: 1.0*v + 0.0s)
        m = pam.shape[0]
        sel = jnp.arange(m)

        def pick(idx):
            return jnp.sum(jnp.where(idx[:, None] == sel[None, :],
                                     pam[None, :], 0.0), axis=1)

        return (pick(i_idx) + 1j * pick(q_idx)).astype(jnp.complex64)
    raise ValueError(modulation)


# ---------------------------------------------------------------------------
# QPSK reference-style LLR demap (BitRecovery.py)
# ---------------------------------------------------------------------------


def qpsk_llr(phasors: jnp.ndarray):
    """Reference LLR demap.  Returns (hard_bits [2n], llr0, llr1).

    Index 2k is the real-rail (MSB) bit of symbol k, 2k+1 the imag rail,
    exactly as BitRecovery.py:105-157 lays them out.
    """
    d = phasors.reshape(-1)
    # nearest constellation point by quadrant — the arithmetic form of
    # argmin |d - QPSK_POINTS| (the points are (+-K, +-K), so the nearest
    # one has each component's sign; sign(0) -> + matches argmin's
    # first-index tie-break over the table order).  Removes the
    # data-dependent pts[dmin_ind] gather.
    k = jnp.float32(0.7071067811865476)
    dz = jax.lax.complex(jnp.where(d.real >= 0, k, -k),
                         jnp.where(d.imag >= 0, k, -k))
    ez = d - dz
    dmin = jnp.abs(ez)

    sigma = 0.7071067811865476 * jnp.mean(dmin)
    dfact = 1.0 / (sigma * sigma)
    er, ei = jnp.abs(ez.real), jnp.abs(ez.imag)
    near_r, far_r = -0.5 * dfact * er, -0.5 * dfact * (_SQRT2 - er)
    near_i, far_i = -0.5 * dfact * ei, -0.5 * dfact * (_SQRT2 - ei)
    re_pos, im_pos = d.real >= 0, d.imag >= 0

    llr0 = jnp.stack([jnp.where(re_pos, near_r, far_r),
                      jnp.where(im_pos, near_i, far_i)], axis=1).reshape(-1)
    llr1 = jnp.stack([jnp.where(re_pos, far_r, near_r),
                      jnp.where(im_pos, far_i, near_i)], axis=1).reshape(-1)
    hard = (0.5 * (jnp.sign(llr1 - llr0) + 1.0)).astype(jnp.int32)
    return hard, llr0, llr1


def qpsk_llr_pairswap(phasors: jnp.ndarray):
    """The per-stream Bit_Recovery variant's demap
    (LEGACY/gr-ofdm-rx/python/Bit_Recovery.py:95-150): rail near/far picked
    by the OTHER axis's sign, soft bits pair-swapped into the output, ceil
    tie-break.  See reference_cpu/golden.py:bit_recovery_pairswap for the
    quirk analysis; hard bits coincide with qpsk_llr for in-range symbols.

    Returns (hard_bits [2n] i32, llr0 [2n], llr1 [2n]).
    """
    d = phasors.reshape(-1)
    # quadrant form of the nearest-point search (see qpsk_llr)
    k = jnp.float32(0.7071067811865476)
    dz = jax.lax.complex(jnp.where(d.real >= 0, k, -k),
                         jnp.where(d.imag >= 0, k, -k))
    ez = d - dz
    dmin = jnp.abs(ez)

    sigma0 = jnp.sqrt(0.5) * jnp.mean(dmin)
    dfact = 1.0 / (sigma0 * sigma0)
    er, ei = jnp.abs(ez.real), jnp.abs(ez.imag)
    near_r, far_r = -0.5 * er, -0.5 * (_SQRT2 - er)
    near_i, far_i = -0.5 * ei, -0.5 * (_SQRT2 - ei)
    im_pos, re_pos = dz.imag >= 0, dz.real >= 0

    rail_r0 = jnp.where(im_pos, near_r, far_r) * dfact
    rail_r1 = jnp.where(im_pos, far_r, near_r) * dfact
    rail_i0 = jnp.where(re_pos, near_i, far_i) * dfact
    rail_i1 = jnp.where(re_pos, far_i, near_i) * dfact

    # pair swap (:143-147): even outputs <- imag rail, odd <- real rail
    llr0 = jnp.stack([rail_i0, rail_r0], axis=1).reshape(-1)
    llr1 = jnp.stack([rail_i1, rail_r1], axis=1).reshape(-1)
    hard = jnp.ceil(0.5 * (jnp.sign(llr1 - llr0) + 1.0)).astype(jnp.int32)
    return hard, llr0, llr1


# ---------------------------------------------------------------------------
# Generic max-log demap (QAM16/64 + hard decisions for all modulations)
# ---------------------------------------------------------------------------


def _constellation_table(modulation: str) -> tuple[np.ndarray, np.ndarray]:
    """(points [M], bit table [M, bps]) for a modulation."""
    bps = BITS_PER_SYMBOL[modulation]
    m = 1 << bps
    idx = np.arange(m)
    bit_tbl = ((idx[:, None] >> np.arange(bps - 1, -1, -1)) & 1).astype(np.int32)
    pts = np.zeros(m, dtype=np.complex64)
    for i in range(m):
        # route through bits_to_symbols for a single symbol (numpy-side)
        b = bit_tbl[i].astype(np.float32)
        if modulation == "BPSK":
            pts[i] = 2 * b[0] - 1
        elif modulation == "QPSK":
            pts[i] = QPSK_POINTS[int(2 * b[0] + b[1])]
        else:
            k = bps // 2
            pam = QAM16_PAM if modulation == "QAM16" else QAM64_PAM
            w = 2 ** np.arange(k - 1, -1, -1)
            pts[i] = pam[int((b[:k] * w).sum())] + 1j * pam[int((b[k:] * w).sum())]
    return pts, bit_tbl


def maxlog_llr(phasors: jnp.ndarray, modulation: str, noise_var: float | jnp.ndarray):
    """Max-log LLRs for any supported modulation.

    Returns (hard_bits [n*bps], llr [n*bps]) with llr>0 meaning bit=1 —
    the modern convention; `qpsk_llr` keeps the reference's split llr0/llr1.
    """
    pts_np, bit_np = _constellation_table(modulation)
    pts = jnp.asarray(pts_np)
    bit_tbl = jnp.asarray(bit_np)
    bps = bit_np.shape[1]

    d = phasors.reshape(-1)
    dist = jnp.abs(d[:, None] - pts[None, :]) ** 2        # [n, M]
    big = jnp.asarray(1e30, dist.dtype)
    llrs = []
    for b in range(bps):
        is1 = bit_tbl[:, b] == 1
        d1 = jnp.min(jnp.where(is1[None, :], dist, big), axis=1)
        d0 = jnp.min(jnp.where(is1[None, :], big, dist), axis=1)
        llrs.append((d0 - d1) / noise_var)
    llr = jnp.stack(llrs, axis=1).reshape(-1)
    hard = (llr > 0).astype(jnp.int32)
    return hard, llr
