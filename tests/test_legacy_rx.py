"""CFO-search + DSSS RX (R4/R5) — JAX model vs literal CPU oracle."""

import numpy as np
import jax.numpy as jnp
import pytest

from lte_gnu_radio_code.models import legacy_rx
from lte_gnu_radio_code.reference_cpu import golden as G
from lte_gnu_radio_code.reference_cpu import legacy as L
from lte_gnu_radio_code.utils.params import (
    CFO_CASES, DSSS_CASES, config_from_case)


def _make_buffer(cfg, seed=0, cfo_hz=0.0, snr_db=60.0):
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, cfg.num_bits)
    tx = G.tx_frame(cfg, bits)
    rx = G.apply_channel(tx, G.channel_taps("Fading"), max_impulse=cfg.nfft)
    if cfo_hz:
        rx = rx * np.exp(1j * 2 * np.pi * cfo_hz / cfg.fs * np.arange(len(rx)))
    nv = np.var(tx) * 10 ** (-snr_db / 10)
    rx = rx + np.sqrt(nv / 2) * (rng.standard_normal(len(rx)) +
                                 1j * rng.standard_normal(len(rx)))
    return bits, rx


@pytest.mark.parametrize("case", [0, 3, 6])
def test_cfo_rx_matches_oracle(case):
    cfg = config_from_case(CFO_CASES, case, snr_db=1e8)
    bits, rx = _make_buffer(cfg)
    fo_range = (0.0, 3000.0, -3000.0)

    o = L.rx_frame_cfo(cfg, rx, fo_range=fo_range, max_det=24)
    r = legacy_rx.make_legacy_rx(cfg, len(rx), fo_range=fo_range,
                                 max_det=24)(jnp.asarray(rx, jnp.complex64))

    n = int(o["n_det"])
    assert n > 0
    assert int(r.count) == n
    np.testing.assert_array_equal(np.asarray(r.ptrs[:n]),
                                  o["time_synch_ref"][:n, 0].astype(int))
    np.testing.assert_array_equal(np.asarray(r.delays[:n]),
                                  o["time_synch_ref"][:n, 1].astype(int))
    np.testing.assert_array_equal(np.asarray(r.fo_idx[:n]),
                                  o["time_synch_ref"][:n, 3].astype(int))
    np.testing.assert_allclose(np.asarray(r.phasors[:n]),
                               o["est_data_freq"][:n], atol=2e-3)


def test_cfo_search_finds_injected_offset():
    cfg = config_from_case(CFO_CASES, 0, snr_db=1e8)
    # inject a +1500 Hz CFO; candidates include its negation
    bits, rx = _make_buffer(cfg, cfo_hz=1500.0)
    fo_range = (0.0, -1500.0, 1500.0)
    o = L.rx_frame_cfo(cfg, rx, fo_range=fo_range, max_det=24)
    r = legacy_rx.make_legacy_rx(cfg, len(rx), fo_range=fo_range,
                                 max_det=24)(jnp.asarray(rx, jnp.complex64))
    n = int(o["n_det"])
    assert n > 0 and int(r.count) == n
    # the -1500 Hz corrector (index 1) must win on every detection
    assert np.all(np.asarray(r.fo_idx[:n]) == 1)
    np.testing.assert_array_equal(np.asarray(r.fo_idx[:n]),
                                  o["time_synch_ref"][:n, 3].astype(int))


@pytest.mark.parametrize("case", [1, 4, 9])
def test_dsss_rx_matches_oracle(case):
    cfg = config_from_case(DSSS_CASES, case, snr_db=1e8)
    dsss = DSSS_CASES[case]["dsss"]
    bits, rx = _make_buffer(cfg, seed=1)
    o = L.rx_frame_cfo(cfg, rx, dsss=dsss, max_det=24)
    r = legacy_rx.make_legacy_rx(cfg, len(rx), dsss=dsss,
                                 max_det=24)(jnp.asarray(rx, jnp.complex64))
    n = int(o["n_det"])
    assert n > 0 and int(r.count) == n
    np.testing.assert_allclose(np.asarray(r.despread[:n]),
                               o["despread"][:n], atol=2e-3)


def test_dsss_spread_symbols_roundtrip():
    """TX chips = symbol * SC; RX despread recovers the symbol."""
    dsss = 4
    sc = L.dsss_code(dsss)
    syms = (np.array([1 + 1j, -1 + 1j, -1 - 1j, 1 - 1j]) / np.sqrt(2))
    chips = np.kron(syms, np.ones(dsss)) * np.tile(sc, len(syms))
    from lte_gnu_radio_code.ops.cfo import dsss_despread
    rec = np.asarray(dsss_despread(jnp.asarray(chips, jnp.complex64), dsss))
    np.testing.assert_allclose(rec, syms, atol=1e-6)


@pytest.mark.parametrize("case", sorted(CFO_CASES))
def test_cfo_recovery_full_case_table(case):
    """Every hard-coded SynchEstAndFO case (all 10, NFFT 64/128/256), with an
    injected CFO and a realistic 11-candidate sweep (the fo axis is
    lax.scan-ed, so NFFT-256 x 11 candidates stays at single-candidate
    memory).  The strongest detection must recover the injection to within
    one candidate step (sub-bin residuals at gate-crossing trials logically
    tie adjacent candidates — reference behaviour)."""
    cfg = config_from_case(CFO_CASES, case, snr_db=1e8)
    inject = 1500.0
    bits, rx = _make_buffer(cfg, seed=case, cfo_hz=inject)
    fo_range = np.linspace(-7500, 7500, 11)               # step 1500 Hz
    r = legacy_rx.make_legacy_rx(cfg, len(rx),
                                 fo_range=tuple(float(f) for f in fo_range),
                                 max_det=24)(jnp.asarray(rx, jnp.complex64))
    n = int(r.count)
    assert n >= cfg.num_patterns, (case, n, cfg.num_patterns)
    best = int(np.argmax(np.asarray(r.peaks[:n])))
    picked = fo_range[int(np.asarray(r.fo_idx[best]))]
    assert abs(picked + inject) <= 1500.0, (case, picked)
