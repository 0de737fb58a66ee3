"""The four-step (two matmul rounds + twiddles) IDFT and the TX path built on
it must match the FFT-op modulator."""

import numpy as np
import jax.numpy as jnp
import pytest

from lte_gnu_radio_code.models import txofdm
from lte_gnu_radio_code.ops import ofdm
from lte_gnu_radio_code.utils.params import GOLDEN64


@pytest.mark.parametrize("nfft", [64, 256, 1024, 2048])
def test_idft_fourstep_matches_ifft(nfft):
    """Two-matmul-round Cooley-Tukey IDFT == jnp.fft.ifft (f32 tolerance)."""
    rng = np.random.default_rng(nfft)
    x = (rng.standard_normal((6, nfft)) + 1j * rng.standard_normal((6, nfft))
         ).astype(np.complex64)
    ref = np.asarray(jnp.fft.ifft(jnp.asarray(x), nfft, axis=-1))
    out = np.asarray(ofdm.idft_fourstep(nfft, jnp.asarray(x)))
    np.testing.assert_allclose(out, ref, atol=5e-6)


def test_tx_fourstep_path_matches_xla():
    cfg = GOLDEN64
    rng = np.random.default_rng(4)
    bits = jnp.asarray(rng.integers(0, 2, (2, cfg.num_bits), dtype=np.int32))
    ref = np.asarray(txofdm.tx_frames(cfg, bits, path=None))
    out = np.asarray(txofdm.tx_frames(cfg, bits, path="fourstep"))
    np.testing.assert_allclose(out, ref, atol=3e-5)
