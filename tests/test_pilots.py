"""Scattered-pilot grid + pilot-based channel estimation (BASELINE configs
2-3; completes the reference's dormant ref_sigs machinery, SDRScript.py:63-67
with ref_sigs=0.0 at SystemModel.py:30)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from lte_gnu_radio_code.models import chain, rxofdm, txofdm
from lte_gnu_radio_code.ops import channel as chan_ops
from lte_gnu_radio_code.ops import pilots
from lte_gnu_radio_code.utils.params import (OFDMConfig, pilot_bin_plan,
                                                 used_bins)


def _cfg(**kw):
    base = dict(pilot_grid="lte", num_ofdm_symb=48, channel="Fading")
    base.update(kw)
    return OFDMConfig(**base).validate()


def test_lte_plan_partitions_used_bins_and_anchors_edges():
    cfg = _cfg()
    p_s, p_w, d_s, d_w = pilot_bin_plan(cfg)
    signed, wrapped = used_bins(cfg.nfft, cfg.num_data_bins)
    assert sorted(p_s + d_s) == sorted(signed)          # exact partition
    assert set(p_s).isdisjoint(d_s)
    assert p_s[0] == signed[0] and p_s[-1] == signed[-1]  # both band edges
    assert cfg.num_pilot_bins == len(p_s)
    assert cfg.num_data_only_bins == len(d_s)
    assert all(p_s[i] < p_s[i + 1] for i in range(len(p_s) - 1))


def test_random_plan_replicates_reference_draw():
    """pilot_grid="random" must reproduce SDRScript.py:63-67 exactly."""
    cfg = _cfg(pilot_grid="random", ref_sigs=0.2, pilot_seed=3)
    p_s, _, d_s, _ = pilot_bin_plan(cfg)
    rng = np.random.RandomState(3)
    num_bins1 = cfg.num_data_bins
    ref_bins0 = rng.randint(1, num_bins1 // 2 + 1,
                            size=int(np.floor(num_bins1 * 0.2 / 2)))
    ref = np.unique(ref_bins0)
    ref_only = np.sort(np.concatenate((-ref, ref)))
    all_bins = np.array(list(range(-num_bins1 // 2, 0)) +
                        list(range(1, num_bins1 // 2 + 1)))
    np.testing.assert_array_equal(np.asarray(p_s), ref_only)
    np.testing.assert_array_equal(np.asarray(d_s),
                                  np.setdiff1d(all_bins, ref_only))


def test_ref_sigs_zero_means_no_pilots():
    cfg = OFDMConfig(pilot_grid="random", ref_sigs=0.0).validate()
    assert cfg.num_pilot_bins == 0
    assert cfg.num_data_only_bins == cfg.num_data_bins


def test_pilot_values_deterministic_and_unit_modulus():
    cfg = _cfg()
    v1, v2 = pilots.pilot_values(cfg), pilots.pilot_values(cfg)
    np.testing.assert_array_equal(v1, v2)
    np.testing.assert_allclose(np.abs(v1), 1.0, rtol=1e-6)


@pytest.mark.parametrize("mod", ["QPSK", "QAM16", "QAM64"])
def test_pilot_chain_zero_ber_fading(mod):
    """Full chain over the Fading channel with pilot-based chan-est only."""
    cfg = _cfg(modulation=mod, snr_db=100.0)
    bits = jnp.asarray(
        np.random.default_rng(5).integers(0, 2, cfg.num_bits), jnp.int32)
    out = chain.make_chain(cfg)(bits, jax.random.PRNGKey(2))
    assert bool(out.found)
    assert float(out.ber) == 0.0
    assert out.phasors.shape == (cfg.num_data_symb, cfg.num_data_only_bins)


@pytest.mark.parametrize("mod", ["QPSK", "QAM64"])
def test_pilot_chain_random_grid_zero_ber(mod):
    """The reference's own (sparse, random) pilot layout still demodulates
    QAM64 cleanly thanks to the reduced-tap CIR-subspace interpolation."""
    cfg = _cfg(pilot_grid="random", ref_sigs=0.25, snr_db=100.0,
               modulation=mod)
    assert cfg.num_pilot_bins >= 2
    bits = jnp.asarray(
        np.random.default_rng(6).integers(0, 2, cfg.num_bits), jnp.int32)
    out = chain.make_chain(cfg)(bits, jax.random.PRNGKey(3))
    assert float(out.ber) == 0.0


@pytest.mark.parametrize("spacing,tol", [(4, 2e-3), (6, 2e-3)])
def test_pilot_estimate_tracks_true_channel(spacing, tol):
    """Genie isolation: after pilot-based equalisation the phasors must sit
    on the TX constellation up to one common complex scalar (TX/RX
    normalisations) — the reference's genie-compare idea
    (gr-utsa_ofdm/SynchAndChanEst.py:190-200).

    Both spacings use the CIR-subspace interpolation (spacing 4 spans the
    full CP; spacing 6 the reduced-tap subspace, still covering the Fading
    CIR + residual shift) — exact up to float32."""
    cfg = _cfg(snr_db=100.0, pilot_spacing=spacing)
    h = chan_ops.channel_taps("Fading")
    bits = np.random.default_rng(7).integers(0, 2, cfg.num_bits)
    tx = txofdm.tx_frame(cfg, jnp.asarray(bits, jnp.int32))
    rx = chan_ops.apply_channel(tx, h, max_impulse=cfg.nfft)
    n_trials, num_patterns = rxofdm.plan_rx(cfg, rx.shape[0])
    r = rxofdm.rx_frame(cfg, rx, n_trials, num_patterns)
    assert bool(r.found)

    from lte_gnu_radio_code.ops.modulation import bits_to_symbols
    want = np.asarray(bits_to_symbols(jnp.asarray(bits, jnp.int32),
                                      cfg.modulation)).reshape(
        cfg.num_data_symb, cfg.num_data_only_bins)
    got = np.asarray(r.phasors)[: cfg.num_data_symb]
    s = np.vdot(got.ravel(), want.ravel()) / np.vdot(got.ravel(), got.ravel())
    evm = np.abs(s * got - want).max()
    assert evm < tol, evm


def test_pilot_num_bits_accounting():
    cfg = _cfg()
    assert cfg.num_bits == cfg.num_data_symb * cfg.num_data_only_bins * 2
    # TX consumes exactly num_bits and produces the canonical frame length
    bits = jnp.zeros(cfg.num_bits, jnp.int32)
    assert txofdm.tx_frame(cfg, bits).shape == (cfg.frame_len,)
