"""2x2 MIMO spatial multiplexing — the path the reference leaves
unimplemented (multi_ant_binary_map:184-186, rx_data_demod:313-318)."""

import numpy as np
import jax.numpy as jnp
import pytest

from lte_gnu_radio_code.models import mimo
from lte_gnu_radio_code.utils.params import OFDMConfig


def _cfg(**kw):
    base = dict(synch_dat=(2, 2), num_ofdm_symb=48, num_ant_txrx=2,
                snr_db=100.0)
    base.update(kw)
    return OFDMConfig(**base).validate()


def test_mimo_spmult_zero_ber_fading():
    cfg = _cfg()
    step = mimo.make_mimo_chain(cfg, channel="Fading")
    bits = jnp.asarray(np.random.default_rng(0).integers(
        0, 2, (2, cfg.num_bits), dtype=np.int32))
    ber, found, lock = step(bits, jnp.int32(0))
    assert bool(found) and int(lock) == cfg.cp_len
    assert float(np.asarray(ber).max()) == 0.0


def test_mimo_spmult_moderate_snr():
    cfg = _cfg(snr_db=30.0)
    step = mimo.make_mimo_chain(cfg, channel="Fading")
    bits = jnp.asarray(np.random.default_rng(1).integers(
        0, 2, (2, cfg.num_bits), dtype=np.int32))
    ber, found, _ = step(bits, jnp.int32(1))
    assert bool(found)
    assert float(np.asarray(ber).max()) < 0.02


def test_mimo_rank1_channel_fails_as_physics_dictates():
    """The reference's MIMO 'Ideal' table is the all-ones (rank-1) matrix —
    two streams cannot be separated through it.  Document, don't 'fix'."""
    cfg = _cfg()
    step = mimo.make_mimo_chain(cfg, channel="Ideal")
    bits = jnp.asarray(np.random.default_rng(2).integers(
        0, 2, (2, cfg.num_bits), dtype=np.int32))
    ber, found, _ = step(bits, jnp.int32(2))
    assert float(np.asarray(ber).max()) > 0.05


def test_mimo_channel_estimate_matches_truth():
    from lte_gnu_radio_code.ops import channel as chan_ops
    from lte_gnu_radio_code.ops import sync
    cfg = _cfg()
    bits = jnp.asarray(np.random.default_rng(3).integers(
        0, 2, (2, cfg.num_bits), dtype=np.int32))
    tx = mimo.tx_frame_mimo(cfg, bits)
    h = chan_ops.mimo2_taps("Fading")
    n = cfg.frame_len + cfg.nfft - 1
    rx = chan_ops.apply_channel_mimo(tx, h)[:, :n]
    cfg1 = OFDMConfig(**{**cfg.__dict__, "synch_dat": (1, 2),
                         "num_ant_txrx": 1}).validate()
    n_trials = sync.n_trials_for(cfg1, n)
    r = mimo.rx_frame_mimo(cfg, rx, n_trials, cfg.num_patterns - 1)
    hf_true = np.fft.fft(np.asarray(h), cfg.nfft, axis=-1)
    hf_est = np.asarray(r.chan_freq)
    # compare at a mid bin up to one common complex scalar
    b = 5
    ratio = hf_est[:, :, b] / hf_true[:, :, b]
    ratio = ratio / ratio[0, 0]
    np.testing.assert_allclose(ratio, np.ones((2, 2)), atol=2e-2)


# ---------------------------------------------------------------------------
# STCode (Alamouti) — the other declared MIMO_method (RxBasebandSystem:313-318)
# ---------------------------------------------------------------------------


def test_stcode_zero_ber_fading():
    cfg = _cfg()
    step = mimo.make_stcode_chain(cfg, channel="Fading")
    bits = jnp.asarray(np.random.default_rng(3).integers(
        0, 2, cfg.num_bits, dtype=np.int32))
    ber, found, lock = step(bits, jnp.int32(3))
    assert bool(found) and int(lock) == cfg.cp_len
    assert float(ber) == 0.0


def test_stcode_works_on_rank1_channel():
    """Alamouti needs no spatial separability — it decodes through the
    rank-1 'Ideal' matrix where SpMult provably cannot."""
    cfg = _cfg()
    step = mimo.make_stcode_chain(cfg, channel="Ideal")
    bits = jnp.asarray(np.random.default_rng(4).integers(
        0, 2, cfg.num_bits, dtype=np.int32))
    ber, found, _ = step(bits, jnp.int32(4))
    assert bool(found)
    assert float(ber) == 0.0


def test_stcode_beats_spmult_at_matched_rate():
    """Matched spectral efficiency (STC QAM16 == SpMult QPSK, 4 bits per bin
    per symbol): the diversity-combined STC link sustains a noise level where
    rank-deficient-ish stream separation already errors."""
    snr = 18.0
    cfg_stc = _cfg(snr_db=snr, modulation="QAM16")
    cfg_sp = _cfg(snr_db=snr, modulation="QPSK")
    stc = mimo.make_stcode_chain(cfg_stc, channel="Fading")
    sp = mimo.make_mimo_chain(cfg_sp, channel="Fading")
    rng = np.random.default_rng(5)
    b_stc = jnp.asarray(rng.integers(0, 2, cfg_stc.num_bits, dtype=np.int32))
    b_sp = jnp.asarray(rng.integers(0, 2, (2, cfg_sp.num_bits),
                                    dtype=np.int32))
    ber_stc = np.mean([float(stc(b_stc, jnp.int32(s))[0]) for s in range(6)])
    ber_sp = np.mean([float(np.asarray(sp(b_sp, jnp.int32(s))[0]).mean())
                      for s in range(6)])
    assert ber_stc < ber_sp
