"""JAX-pipeline correctness vs the CPU oracle (reference_cpu/golden.py).

The acceptance criterion is the reference's own (SURVEY.md §6): demodulated
*bits* exact at working SNR; IQ within an EVM bound, not float-exact.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from lte_gnu_radio_code.reference_cpu import golden as G
from lte_gnu_radio_code.utils.params import GOLDEN64, OFDMConfig
from lte_gnu_radio_code.models import chain, rxofdm, txofdm


def _oracle_rx_buffer(cfg, bits, seed=1):
    """TX + channel + AWGN via the oracle — a fixed received buffer."""
    tx = G.tx_frame(cfg, bits)
    name = cfg.channel if cfg.channel != "AWGN" else "Ideal"
    rx = G.apply_channel(tx, G.channel_taps(name), max_impulse=cfg.nfft)
    return G.awgn(cfg, rx, np.random.default_rng(seed), np.var(tx))


def test_tx_matches_oracle_within_float32():
    cfg = GOLDEN64
    bits = np.random.default_rng(0).integers(0, 2, cfg.num_bits)
    tx_j = np.asarray(txofdm.make_tx(cfg)(jnp.asarray(bits, jnp.int32)))
    tx_o = G.tx_frame(cfg, bits)
    assert np.abs(tx_j - tx_o).max() < 1e-5


def test_rx_bit_exact_vs_oracle_on_fading_channel():
    cfg = GOLDEN64
    bits = np.random.default_rng(0).integers(0, 2, cfg.num_bits)
    rx = _oracle_rx_buffer(cfg, bits)
    ph_o, tsr, _ = G.rx_frame(cfg, rx)
    hard_o, _, _ = G.bit_recovery(ph_o)

    r = rxofdm.make_rx(cfg, len(rx))(jnp.asarray(rx, jnp.complex64))
    assert bool(r.found)
    assert int(r.lock_ptr) == int(tsr[0])
    assert int(r.delay_idx) == int(tsr[1])
    hard_j = np.asarray(r.hard_bits)
    m = min(len(hard_j), len(hard_o))
    np.testing.assert_array_equal(hard_j[:m], hard_o[:m])
    assert np.mean(hard_j[: len(bits)] != bits) == 0.0


def test_rx_on_shipped_golden_vector(ref_vectors):
    cfg = GOLDEN64
    rx = ref_vectors["tx_offline"]
    r = rxofdm.make_rx(cfg, len(rx))(jnp.asarray(rx, jnp.complex64))
    assert bool(r.found) and int(r.lock_ptr) == 16
    hard = np.asarray(r.hard_bits)
    assert np.mean(hard[: len(ref_vectors["bits"])] != ref_vectors["bits"]) == 0.0


@pytest.mark.parametrize("channel", ["Ideal", "IMT1", "Fading"])
def test_full_chain_zero_ber_high_snr(channel):
    cfg = OFDMConfig(channel=channel, num_ofdm_symb=48).validate()
    bits = jnp.asarray(
        np.random.default_rng(2).integers(0, 2, cfg.num_bits), jnp.int32)
    out = chain.make_chain(cfg)(bits, jax.random.PRNGKey(0))
    assert bool(out.found)
    assert float(out.ber) == 0.0


@pytest.mark.parametrize("mod", ["BPSK", "QAM16", "QAM64"])
def test_chain_other_modulations(mod):
    # QAM16/64 are the BASELINE.json extension beyond the reference
    cfg = OFDMConfig(modulation=mod, channel="Ideal", num_ofdm_symb=48,
                     snr_db=60.0).validate()
    bits = jnp.asarray(
        np.random.default_rng(3).integers(0, 2, cfg.num_bits), jnp.int32)
    out = chain.make_chain(cfg)(bits, jax.random.PRNGKey(1))
    assert float(out.ber) == 0.0


def test_chain_moderate_snr_qpsk_fading_low_ber():
    cfg = OFDMConfig(snr_db=20.0, num_ofdm_symb=48).validate()
    bits = jnp.asarray(
        np.random.default_rng(4).integers(0, 2, cfg.num_bits), jnp.int32)
    out = chain.make_chain(cfg)(bits, jax.random.PRNGKey(2))
    assert bool(out.found)
    assert float(out.ber) < 0.05


def test_rx_no_false_lock_on_noise():
    cfg = GOLDEN64
    n = cfg.frame_len + cfg.nfft - 1
    noise = 0.1 * (np.random.default_rng(5).standard_normal(n)
                   + 1j * np.random.default_rng(6).standard_normal(n))
    r = rxofdm.make_rx(cfg, n)(jnp.asarray(noise, jnp.complex64))
    assert not bool(r.found)


def test_batched_apply_channel_matches_np_convolve():
    """vmap(apply_channel) over a batch of frames (the chain's batched
    channel stage: static shifted adds for the 5-tap Fading CIR) equals
    np.convolve per frame, including the NFFT-1 zero tail."""
    from lte_gnu_radio_code.ops import channel as chan_ops
    rng = np.random.default_rng(9)
    x = (rng.standard_normal((3, 2000)) + 1j * rng.standard_normal((3, 2000))
         ).astype(np.complex64)
    h = chan_ops.channel_taps("Fading")
    out = np.asarray(jax.vmap(lambda s: chan_ops.apply_channel(
        s, h, max_impulse=64))(jnp.asarray(x)))
    hp = np.concatenate([h, np.zeros(64 - len(h), h.dtype)])
    ref = np.stack([np.convolve(x[i].astype(np.complex128), hp)
                    for i in range(3)])
    assert out.shape == ref.shape == (3, 2000 + 63)
    np.testing.assert_allclose(out, ref, atol=1e-5)
