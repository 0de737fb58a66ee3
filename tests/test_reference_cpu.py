"""Golden-vector regression for the CPU oracle (reference_cpu/golden.py).

These tests pin the oracle to the *shipped* reference pickles, making it a
trustworthy spec for everything else in the framework."""

import numpy as np

from lte_gnu_radio_code.reference_cpu import golden as G
from lte_gnu_radio_code.utils.params import GOLDEN64, OFDMConfig


def test_tx_matches_shipped_pre_channel_vector(ref_vectors):
    tx = G.tx_frame(GOLDEN64, ref_vectors["bits"])
    np.testing.assert_allclose(tx, ref_vectors["tx_online"], atol=1e-12)


def test_channel_matches_shipped_post_channel_vector(ref_vectors):
    tx = G.tx_frame(GOLDEN64, ref_vectors["bits"])
    rx = G.apply_channel(tx, G.channel_taps("Fading"), max_impulse=64)
    # shipped vector includes an AWGN realisation at SNR 100 dB
    assert np.abs(rx - ref_vectors["tx_offline"]).max() < 1e-4


def test_rx_zero_ber_on_shipped_vector(ref_vectors):
    phasors, tsr, _ = G.rx_frame(GOLDEN64, ref_vectors["tx_offline"])
    hard, _, _ = G.bit_recovery(phasors)
    assert tsr[0] == 16  # locks on the first aligned trial
    assert np.mean(hard != ref_vectors["bits"]) == 0.0


def test_ideal_channel_reproduces_shipped_channel_estimate(ref_vectors):
    tx = G.tx_frame(GOLDEN64, ref_vectors["bits"])
    rx = G.apply_channel(tx, G.channel_taps("Ideal"), max_impulse=64)
    _, _, cest = G.rx_frame(GOLDEN64, rx)
    np.testing.assert_allclose(cest, ref_vectors["golden_out"], atol=5e-5)


def test_end_to_end_chain_zero_ber_high_snr():
    out = G.run_chain(GOLDEN64, seed=3)
    assert out["ber"] == 0.0


def test_end_to_end_awgn_channel():
    cfg = OFDMConfig(channel="Ideal", num_ofdm_symb=48, snr_db=40).validate()
    out = G.run_chain(cfg, seed=5)
    assert out["ber"] == 0.0


def test_qpsk_roundtrip():
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, 1000 * 2)
    # small perturbation: the reference demapper estimates sigma from the
    # residuals and would divide by zero on exact constellation points
    pts = G.qpsk_map(bits) + 1e-3 * (rng.standard_normal(1000) +
                                     1j * rng.standard_normal(1000))
    hard, _, _ = G.bit_recovery(pts)
    np.testing.assert_array_equal(hard, bits)


def test_zc_even_odd_forms():
    z = G.zadoff_chu(62, 23)
    assert z.shape == (62,)
    np.testing.assert_allclose(np.abs(z), 1.0)
    zo = G.zadoff_chu(63, 23)
    np.testing.assert_allclose(np.abs(zo), 1.0)
