"""Parity across the three sync delay-search implementations.

The |corr| surface drives the lock decision (gr-RXOFDM
synch_and_chan_est.py:164-173), so every implementation must agree on it:
  * exact  — the dense [p, L] x [L, cp+1] einsum (the literal del_mat shape)
  * ifft   — one inverse FFT per trial (sync_correlate_ifft, the default)
  * conv   — the strided conv-bank (ops/fast_sync.py)
"""

import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp

from lte_gnu_radio_code.models import rxofdm
from lte_gnu_radio_code.ops import fast_sync, sync
from lte_gnu_radio_code.utils.params import (GOLDEN64, LTE1024, LTE2048,
                                             OFDMConfig)


def _buf(cfg, seed=0, frames=1):
    """A frame of TX through the Fading channel (real lock present)."""
    from lte_gnu_radio_code.reference_cpu import golden as G
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, cfg.num_bits)
    tx = G.tx_frame(cfg, bits)
    rx = G.apply_channel(tx, G.channel_taps("Fading"), max_impulse=cfg.nfft)
    return jnp.asarray(rx, jnp.complex64)


@pytest.mark.parametrize("cfg", [
    GOLDEN64,
    dataclasses.replace(LTE1024, num_ofdm_symb=8).validate(),
    # non-Parseval bin plan: ifft must still equal exact (conv can't run)
    OFDMConfig(num_synch_bins=48, num_ofdm_symb=8).validate(),
])
def test_ifft_matches_exact(cfg):
    x = _buf(cfg)
    n_trials = sync.n_trials_for(cfg, x.shape[0])
    spectra = sync.sync_spectra(cfg, x, n_trials)
    exact = np.asarray(jnp.abs(sync.sync_correlate(cfg, spectra)))
    via_ifft = np.asarray(sync.corr_abs_from_spectra(cfg, spectra, "ifft"))
    scale = max(exact.max(), 1.0)
    np.testing.assert_allclose(via_ifft, exact, atol=2e-4 * scale)


@pytest.mark.parametrize("cfg", [
    GOLDEN64,
    dataclasses.replace(LTE1024, num_ofdm_symb=8).validate(),
])
def test_ifft_matches_conv_bank(cfg):
    x = _buf(cfg, seed=3)
    n_trials = sync.n_trials_for(cfg, x.shape[0])
    conv = np.asarray(fast_sync.sync_corr_abs_fast(cfg, x, n_trials))
    spectra = sync.sync_spectra(cfg, x, n_trials)
    via_ifft = np.asarray(sync.corr_abs_from_spectra(cfg, spectra, "ifft"))
    scale = max(conv.max(), 1.0)
    np.testing.assert_allclose(via_ifft, conv, atol=2e-4 * scale)


def test_cfo_scan_matches_materialised_cube():
    """The memory-bounded fo-axis scan (cfo_search_scan) must pick the same
    (peak, delay, fo) winners as the materialised (trial, fo, delay) cube
    (sync_spectra_cfo + sync_correlate_cfo) — both now on the IFFT delay
    axis.  Covers SynchEstAndFO.py:250-278 semantics."""
    from lte_gnu_radio_code.ops import cfo as C
    from lte_gnu_radio_code.utils.params import CFO_CASES, config_from_case

    cfg = config_from_case(CFO_CASES, 1)
    x = _buf(cfg, seed=5)
    n_trials = sync.n_trials_for(cfg, x.shape[0])
    bank = C.cfo_bank(cfg, (-200.0, 0.0, 200.0))
    val_s, dly_s, fo_s = C.cfo_search_scan(cfg, x, n_trials, bank)
    cube = np.abs(np.asarray(C.sync_correlate_cfo(
        cfg, C.sync_spectra_cfo(cfg, x, n_trials, bank))))   # [p, F, D]
    flat = cube.reshape(cube.shape[0], -1)
    np.testing.assert_allclose(np.asarray(val_s), flat.max(-1), rtol=2e-5)
    win = flat.argmax(-1)
    np.testing.assert_array_equal(np.asarray(fo_s), win // cube.shape[2])
    np.testing.assert_array_equal(np.asarray(dly_s), win % cube.shape[2])


@pytest.mark.parametrize("fast", ["ifft", "conv", False])
def test_rx_frame_identical_decisions_across_paths(fast):
    """All paths must produce the same lock, delay and hard bits end-to-end
    (float noise in |corr| is far below the detection margins)."""
    cfg = GOLDEN64
    x = _buf(cfg, seed=7)
    n_trials, num_patterns = rxofdm.plan_rx(cfg, x.shape[0])
    want = rxofdm.rx_frame(cfg, x, n_trials, num_patterns, fast="ifft")
    got = rxofdm.rx_frame(
        cfg, x, n_trials, num_patterns, fast=True if fast == "conv" else fast)
    assert int(want.lock_ptr) == int(got.lock_ptr)
    assert int(want.delay_idx) == int(got.delay_idx)
    np.testing.assert_array_equal(np.asarray(want.hard_bits),
                                  np.asarray(got.hard_bits))


@pytest.mark.parametrize("base,dense", [(LTE1024, True), (LTE1024, False),
                                        (LTE2048, False)],
                         ids=["lte1024-dense", "lte1024-strided",
                              "lte2048-strided"])
def test_lte_scale_sync_decisions_identical_across_paths(base, dense):
    """At LTE numerology — the flagship's strided grid (stride cp-1) and the
    dense stride-1 utsa grid — the ifft, conv and exact searches lock on the
    same trial and delay, and give the same hard bits, on a noisy Fading
    buffer."""
    from lte_gnu_radio_code.reference_cpu import golden as G
    cfg = dataclasses.replace(base, num_ofdm_symb=8,
                              stride=1 if dense else base.stride).validate()
    rng = np.random.default_rng(5)
    tx = G.tx_frame(cfg, rng.integers(0, 2, cfg.num_bits))
    rx = G.apply_channel(tx, G.channel_taps("Fading"), max_impulse=cfg.nfft)
    x = jnp.asarray(G.awgn(cfg, rx, rng, np.var(tx)), jnp.complex64)
    n_trials, num_patterns = rxofdm.plan_rx(cfg, x.shape[0])
    got = {fast: rxofdm.rx_frame(cfg, x, n_trials, num_patterns, fast=fast)
           for fast in ("ifft", "conv", "exact")}
    want = got["ifft"]
    assert bool(want.found)
    for fast, r in got.items():
        assert int(r.lock_ptr) == int(want.lock_ptr), fast
        assert int(r.delay_idx) == int(want.delay_idx), fast
        np.testing.assert_array_equal(np.asarray(r.hard_bits),
                                      np.asarray(want.hard_bits))


@pytest.mark.parametrize("base", [LTE1024, LTE2048], ids=["1024", "2048"])
def test_equalize_data_symbols_matches_oracle_phasors(base):
    """sync.equalize_data_symbols (FFT, power norm, delay derotation, MMSE)
    at the oracle's lock, delay and channel estimate reproduces the oracle's
    equalised phasors at LTE numerology."""
    from lte_gnu_radio_code.reference_cpu import golden as G
    cfg = dataclasses.replace(base, num_ofdm_symb=8).validate()
    rng = np.random.default_rng(11)
    tx = G.tx_frame(cfg, rng.integers(0, 2, cfg.num_bits))
    rx = G.apply_channel(tx, G.channel_taps("Fading"), max_impulse=cfg.nfft)
    rx = G.awgn(cfg, rx, rng, np.var(tx))
    ph_o, tsr, cir_o = G.rx_frame(cfg, rx)
    _, num_patterns = rxofdm.plan_rx(cfg, len(rx))
    chan_full = np.fft.fft(cir_o, cfg.nfft).astype(np.complex64)
    ph = np.asarray(sync.equalize_data_symbols(
        cfg, jnp.asarray(rx, jnp.complex64), int(tsr[0]), int(tsr[1]),
        jnp.asarray(chan_full), num_patterns))
    rows = min(len(ph), len(ph_o))
    assert rows > 0
    np.testing.assert_allclose(ph[:rows], ph_o[:rows], atol=1e-4)


def test_windows_at_matches_gather_including_clamp():
    """The gather-free window extraction (round-4 de-gather) must equal the
    advanced-indexing gather bit-for-bit, including the index-clamp
    semantics for windows that run past the buffer end."""
    import numpy as np
    import jax.numpy as jnp
    from lte_gnu_radio_code.ops import cfo as cfo_ops

    rng = np.random.default_rng(0)
    x = (rng.standard_normal(500) + 1j * rng.standard_normal(500)
         ).astype(np.complex64)
    offs = (np.arange(3) * 40)[:, None] + np.arange(32)[None, :]
    # in-range, partially out-of-range, and fully out-of-range pointers
    ptrs = jnp.asarray([0, 100, 420, 499], jnp.int32)
    ref = jnp.asarray(x)[jnp.clip(
        ptrs[:, None, None] + jnp.asarray(offs)[None], 0, len(x) - 1)]
    out = cfo_ops.windows_at(jnp.asarray(x), ptrs, offs)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(ref))


def test_bank_select_matches_gather():
    import numpy as np
    import jax.numpy as jnp
    from lte_gnu_radio_code.ops import cfo as cfo_ops

    rng = np.random.default_rng(1)
    bank = (rng.standard_normal((7, 64)) + 1j * rng.standard_normal((7, 64))
            ).astype(np.complex64)
    sel = jnp.asarray([0, 6, 3, 3, 1], jnp.int32)
    np.testing.assert_array_equal(
        np.asarray(cfo_ops.bank_select(bank, sel)), bank[np.asarray(sel)])
