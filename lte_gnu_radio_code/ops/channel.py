"""Channel simulation ops: multipath convolution and AWGN, jittable.

The channel models are the reference's hard-coded normalised CIRs
(MultiAntennaSystem.py:60-96, TEST/GNU_RADIO_OFFLINE/synch_and_chan_est.py:126-158)
and its Digital/Analog SNR noise conventions (MultiAntennaSystem.py:235-260).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from ..utils.params import OFDMConfig

CHANNELS_SISO = {
    "Ideal": np.array([1.0 + 0j]),
    "IMT1": np.array([0.0, 1.0 + 0j]),
    "IMT16": np.array([0.0] * 15 + [1.0 + 0j]),
    "Fading": np.array([0.3977, 0.7954 - 0.3977j, -0.1988, 0.0994, -0.0398]),
    "AWGN": np.array([0.0, 1.0 + 0j]),
}

def channel_taps(name: str, dtype=np.complex64) -> np.ndarray:
    h = CHANNELS_SISO[name]
    return (h / np.linalg.norm(h)).astype(dtype)


def mimo2_taps(name: str = "Fading", dtype=np.complex64) -> np.ndarray:
    """[2, 2, 5] unit-normalised 2x2 MIMO CIRs (MultiAntennaSystem.py:69-74)."""
    h = np.zeros((2, 2, 5), dtype=np.complex128)
    h[0, 0, :] = [0.3977, 0.7954 - 0.3977j, -0.1988, 0.0994, -0.0398]
    h[0, 1, :2] = [0.8423j, 0.5391]
    h[1, 0, :3] = [0.1631, -0.0815 + 0.9784j, 0.0978]
    h[1, 1, :4] = [0.0572j, 0.3659j, 0.5717 - 0.5717j, 0.4574]
    if name == "Ideal":
        h[:] = 0
        h[:, :, 0] = 1
    for r in range(2):
        for t in range(2):
            h[r, t] /= np.linalg.norm(h[r, t])
    return h.astype(dtype)


def _direct_conv_full(sig: jnp.ndarray, h: jnp.ndarray) -> jnp.ndarray:
    """Full linear convolution sig * h as ONE real conv (complex arithmetic
    decomposed into 2 in / 2 out channels).  For the tap counts the
    reference's CIR tables actually use (5..63) this is both far fewer FLOPs
    than the FFT-overlap form and a much smaller program to compile."""
    th = h.shape[-1]
    x = jnp.stack([jnp.real(sig), jnp.imag(sig)])[None]     # [1, 2, n]
    hf = h[::-1]                                            # corr -> conv
    k = jnp.stack([jnp.stack([jnp.real(hf), -jnp.imag(hf)]),
                   jnp.stack([jnp.imag(hf), jnp.real(hf)])])  # [2, 2, th]
    y = lax.conv_general_dilated(
        x.astype(jnp.float32), k.astype(jnp.float32), (1,),
        [(th - 1, th - 1)], dimension_numbers=("NCH", "OIH", "NCH"),
        precision=lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32)
    return (y[0, 0] + 1j * y[0, 1]).astype(jnp.complex64)


def apply_channel(sig: jnp.ndarray, h: jnp.ndarray,
                  max_impulse: int | None = None) -> jnp.ndarray:
    """Full linear convolution sig * h (one batched device pass).

    Matches np.convolve(sig, h_padded_to_max_impulse) as the reference does
    in MultiAntennaSystem.rx_signal_gen:221-231: the output is
    len(sig) + max_impulse - 1 samples, with the tail beyond the true taps
    zero.  Short responses (every shipped CIR table) convolve directly;
    long ones fall back to the FFT-overlap form.
    """
    taps = h.shape[-1] if max_impulse is None else max(max_impulse,
                                                       h.shape[-1])
    n_out = sig.shape[-1] + taps - 1
    if isinstance(h, np.ndarray) and h.shape[-1] <= 16:
        # very short concrete CIR (every shipped SISO table): the full
        # convolution is th static shifted-adds, which XLA fuses into one
        # elementwise loop with no contraction.  Tap order ascending matches np.convolve's accumulation order at each
        # output sample where all taps overlap; the complex64 accumulation
        # still rounds differently from _direct_conv_full's conv op, so the
        # two paths agree to float32 tolerance, not bit-exactly (tests pin
        # tolerance-level agreement and identical decisions).
        th = h.shape[-1]
        y = jnp.zeros(sig.shape[-1] + th - 1, jnp.complex64)
        for k in range(th):
            y = y + np.complex64(h[k]) * jnp.pad(sig, (k, th - 1 - k))
        return jnp.pad(y, (0, n_out - y.shape[-1])).astype(jnp.complex64)
    if h.shape[-1] <= 256:
        y = _direct_conv_full(sig, h)                   # [n + th - 1]
        return jnp.pad(y, (0, n_out - y.shape[-1]))
    nfft = int(2 ** np.ceil(np.log2(max(n_out, 2))))
    s = jnp.fft.fft(sig, nfft)
    hh = jnp.fft.fft(h, nfft)
    y = jnp.fft.ifft(s * hh, nfft)[: n_out]
    return y.astype(jnp.complex64)


def apply_channel_mimo(sig: jnp.ndarray, h: jnp.ndarray,
                       max_impulse: int | None = None) -> jnp.ndarray:
    """[n_tx, T] x [n_rx, n_tx, taps] -> [n_rx, T+taps-1] summed over TX.

    Short responses convolve directly (one real conv whose input channels
    are the TX antennas' I/Q rails and whose output channels are the RX
    antennas'); long ones use the FFT-overlap form.
    """
    taps = h.shape[-1] if max_impulse is None else max(max_impulse,
                                                       h.shape[-1])
    n_out = sig.shape[-1] + taps - 1
    if h.shape[-1] <= 256:
        th = h.shape[-1]
        n_rx, n_tx = h.shape[0], h.shape[1]
        x = jnp.concatenate([jnp.real(sig), jnp.imag(sig)])[None]  # [1, 2T, n]
        hf = h[..., ::-1]
        # out channel o = rx r rail (re/im); in channel i = tx t rail
        k = jnp.concatenate([
            jnp.concatenate([jnp.real(hf), -jnp.imag(hf)], axis=1),
            jnp.concatenate([jnp.imag(hf), jnp.real(hf)], axis=1),
        ], axis=0)                                  # [2R, 2T, th]
        y = lax.conv_general_dilated(
            x.astype(jnp.float32), k.astype(jnp.float32), (1,),
            [(th - 1, th - 1)], dimension_numbers=("NCH", "OIH", "NCH"),
            precision=lax.Precision.HIGHEST,
            preferred_element_type=jnp.float32)[0]
        out = (y[:n_rx] + 1j * y[n_rx:]).astype(jnp.complex64)
        return jnp.pad(out, ((0, 0), (0, n_out - out.shape[-1])))
    nfft = int(2 ** np.ceil(np.log2(max(n_out, 2))))
    s = jnp.fft.fft(sig, nfft, axis=-1)                      # [n_tx, F]
    hh = jnp.fft.fft(h, nfft, axis=-1)                       # [n_rx, n_tx, F]
    y = jnp.fft.ifft(jnp.einsum("tf,rtf->rf", s, hh,
                                precision=lax.Precision.HIGHEST),
                     nfft, axis=-1)
    return y[:, :n_out].astype(jnp.complex64)


def noise_variance(cfg: OFDMConfig, sig_pow) -> jnp.ndarray:
    """Digital/Analog SNR -> complex noise variance (MultiAntennaSystem.py:243-246)."""
    if cfg.snr_type == "Digital":
        bits_per_symb = cfg.num_data_bins * cfg.bits_per_bin
        return (1.0 / bits_per_symb) * cfg.rx_b_len * sig_pow * 10 ** (-cfg.snr_db / 10)
    return sig_pow * 10 ** (-cfg.snr_db / 10)


def awgn(cfg: OFDMConfig, rx: jnp.ndarray, key: jax.Array,
         sig_pow) -> jnp.ndarray:
    nv = noise_variance(cfg, sig_pow)
    kr, ki = jax.random.split(key)
    n = (jax.random.normal(kr, rx.shape) + 1j * jax.random.normal(ki, rx.shape))
    return rx + jnp.sqrt(nv / 2.0).astype(jnp.float32) * n.astype(jnp.complex64)
