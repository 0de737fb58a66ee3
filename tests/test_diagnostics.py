"""Genie modes, split RX stages, diagnostics dumps."""

import numpy as np
import jax.numpy as jnp

from lte_gnu_radio_code.models import rxofdm, split
from lte_gnu_radio_code.reference_cpu import golden as G
from lte_gnu_radio_code.utils import diagnostics as D
from lte_gnu_radio_code.utils.params import GOLDEN64


def _buf(cfg, seed=0, snr_db=100.0):
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, cfg.num_bits)
    tx = G.tx_frame(cfg, bits)
    rx = G.apply_channel(tx, G.channel_taps("Fading"), max_impulse=cfg.nfft)
    nv = np.var(tx) * 10 ** (-snr_db / 10)
    rx = rx + np.sqrt(nv / 2) * (rng.standard_normal(len(rx)) +
                                 1j * rng.standard_normal(len(rx)))
    return bits, rx


def test_perfect_chan_est_genie_mode():
    cfg = GOLDEN64
    bits, rx = _buf(cfg, snr_db=15.0)
    h = G.channel_taps("Fading")
    r_est = rxofdm.make_rx(cfg, len(rx))(jnp.asarray(rx, jnp.complex64))
    r_genie = rxofdm.make_rx(cfg, len(rx), genie_h=h, perfect_chan_est=True)(
        jnp.asarray(rx, jnp.complex64))
    ber_est = np.mean(np.asarray(r_est.hard_bits)[:len(bits)] != bits)
    ber_genie = np.mean(np.asarray(r_genie.hard_bits)[:len(bits)] != bits)
    # the genie channel can only help
    assert ber_genie <= ber_est + 1e-9


def test_genie_channel_compare_low_error_at_high_snr():
    cfg = GOLDEN64
    bits, rx = _buf(cfg)
    h = G.channel_taps("Fading")
    r = rxofdm.make_rx(cfg, len(rx))(jnp.asarray(rx, jnp.complex64))
    cmp = D.genie_channel_compare(cfg.nfft, np.asarray(r.chan_est_time), h,
                                  delay_idx=int(r.delay_idx))
    assert cmp["nmse_used_db"] < -35.0  # estimate matches truth on used bins


def test_split_rx_stages_match_monolithic():
    cfg = GOLDEN64
    bits, rx = _buf(cfg)
    x = jnp.asarray(rx, jnp.complex64)
    mono = rxofdm.make_rx(cfg, len(rx))(x)
    f1, f2 = split.make_split_rx(cfg, len(rx))
    s1 = f1(x)
    assert int(s1.count) >= 1
    assert int(s1.ptrs[0]) == int(mono.lock_ptr)
    assert int(s1.delays[0]) == int(mono.delay_idx)
    s2 = f2(s1.passthrough, s1.ptrs[0], s1.delays[0])
    np.testing.assert_array_equal(np.asarray(s2.hard_bits),
                                  np.asarray(mono.hard_bits))


def test_dump_files(tmp_path):
    cfg = GOLDEN64
    bits, rx = _buf(cfg)
    r = rxofdm.make_rx(cfg, len(rx))(jnp.asarray(rx, jnp.complex64))
    p1 = D.dump_channel_estimate(tmp_path, "cest_", r.chan_est_time)
    p2 = D.dump_soft_bits(tmp_path, "soft_", r.llr0, r.llr1)
    p3 = D.dump_hard_bits_csv(tmp_path, "hard_", r.hard_bits)
    assert p1.exists() and p2.exists() and p3.exists()
    re_, im_ = D.iq_scatter(r.phasors, save_to=tmp_path / "iq.png")
    assert re_.shape == im_.shape
    ev = D.evm_db(r.phasors, G.qpsk_map(bits))
    assert ev < -30.0


def test_bit_recovery_pairswap_variant():
    """Pin the Bit_Recovery.py per-stream variant (the :143-147 bit-pair
    swap): JAX op == literal oracle exactly; hard bits equal the plain
    BitRecovery demap for in-range symbols; LLR magnitudes cross-assigned."""
    import numpy as np
    import jax.numpy as jnp

    from lte_gnu_radio_code.ops import modulation
    from lte_gnu_radio_code.reference_cpu import golden as G

    rng = np.random.default_rng(11)
    pts = G.qpsk_map(rng.integers(0, 2, 2 * 600))
    noisy = pts + 0.15 * (rng.standard_normal(600) +
                          1j * rng.standard_normal(600))

    oh, o0, o1 = G.bit_recovery_pairswap(noisy)
    th, t0, t1 = modulation.qpsk_llr_pairswap(jnp.asarray(noisy, jnp.complex64))
    np.testing.assert_array_equal(np.asarray(th), oh)
    np.testing.assert_allclose(np.asarray(t0), o0, atol=1e-4)
    np.testing.assert_allclose(np.asarray(t1), o1, atol=1e-4)

    # hard-bit coincidence with the BitRecovery demap for in-range symbols
    bh, b0, b1 = G.bit_recovery(noisy)
    np.testing.assert_array_equal(oh, bh)
    # ...and the pair swap really crosses the rails: the {llr0, llr1} value
    # pair at even positions equals BitRecovery's odd-position pair (up to
    # the variant's quadrant-dependent near/far flip between llr0 and llr1)
    def pairs(a, b):
        return np.sort(np.stack([a, b]), axis=0)

    np.testing.assert_allclose(pairs(o0[0::2], o1[0::2]),
                               pairs(b0[1::2], b1[1::2]), atol=1e-9)
    np.testing.assert_allclose(pairs(o0[1::2], o1[1::2]),
                               pairs(b0[0::2], b1[0::2]), atol=1e-9)
