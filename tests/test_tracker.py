"""Tracking synchronizer (R6/R11): JAX scan model vs literal CPU oracle."""

import numpy as np
import jax.numpy as jnp

from lte_gnu_radio_code.models import tracker as M
from lte_gnu_radio_code.reference_cpu import golden as G
from lte_gnu_radio_code.reference_cpu import tracker as T
from lte_gnu_radio_code.utils.params import GOLDEN64


def _buffer(cfg, seed=0, snr_db=80.0):
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, cfg.num_bits)
    tx = G.tx_frame(cfg, bits)
    rx = G.apply_channel(tx, G.channel_taps("Fading"), max_impulse=cfg.nfft)
    nv = np.var(tx) * 10 ** (-snr_db / 10)
    rx = rx + np.sqrt(nv / 2) * (rng.standard_normal(len(rx)) +
                                 1j * rng.standard_normal(len(rx)))
    return bits, rx


def test_oracle_tracker_locks_and_tracks():
    cfg = GOLDEN64
    bits, rx = _buffer(cfg)
    tr = T.track_synch(cfg, rx)
    assert tr["n_det"] == cfg.num_patterns
    tsr = tr["time_synch_ref"]
    # every detection resolves the true symbol boundary ptr+delay = 16+320k
    resolved = tsr[:tr["n_det"], 0] + tsr[:tr["n_det"], 1]
    np.testing.assert_array_equal(
        resolved, 16 + 320 * np.arange(tr["n_det"]))


def test_oracle_data_demod_zero_ber_with_fix():
    cfg = GOLDEN64
    bits, rx = _buffer(cfg)
    tr = T.track_synch(cfg, rx)
    ph = T.data_demod(cfg, rx, tr, fix_rotation=True)
    hard, _, _ = G.bit_recovery(ph)
    nb = min(len(hard), len(bits))
    assert np.mean(hard[:nb] != bits[:nb]) == 0.0


def test_oracle_unfixed_rotation_matches_reference_residual():
    """The verbatim reference demod leaves an e^{-j2pi k/N} residual."""
    cfg = GOLDEN64
    bits, rx = _buffer(cfg, snr_db=200.0)
    tr = T.track_synch(cfg, rx)
    ph = T.data_demod(cfg, rx, tr, fix_rotation=False)
    pts = G.qpsk_map(bits[:cfg.num_data_bins * 2])
    ratio = ph[0] / pts
    from lte_gnu_radio_code.utils.params import used_bins
    signed = np.asarray(used_bins(cfg.nfft, cfg.num_data_bins)[0])
    slope = np.polyfit(signed, np.angle(ratio), 1)[0]
    np.testing.assert_allclose(slope, -2 * np.pi / cfg.nfft, rtol=1e-3)


def test_jax_tracker_matches_oracle():
    cfg = GOLDEN64
    bits, rx = _buffer(cfg)
    tr = T.track_synch(cfg, rx)
    n = tr["n_det"]

    r = M.make_tracker(cfg, len(rx))(jnp.asarray(rx, jnp.complex64))
    assert int(r.count) == n
    # raw pointers are lstsq-roundoff-sensitive (the reference applies ceil()
    # to an exactly-integer prediction, so float noise flips it by +-1); the
    # resolved symbol boundary ptr+delay is the invariant to compare
    res_j = np.asarray(r.ptrs[:n]) + np.asarray(r.delays[:n])
    res_o = (tr["time_synch_ref"][:n, 0] +
             tr["time_synch_ref"][:n, 1]).astype(int)
    np.testing.assert_array_equal(res_j, res_o)
    hard_j = np.asarray(r.hard_bits)
    assert np.mean(hard_j[:len(bits)] != bits) == 0.0
    ph_o = T.data_demod(cfg, rx, tr, fix_rotation=True)
    hard_o, _, _ = G.bit_recovery(ph_o)
    nb = min(len(hard_j), len(hard_o))
    assert np.mean(hard_j[:nb] != hard_o[:nb]) == 0.0


def test_jax_tracker_survives_timing_drift():
    """Insert a small gap mid-stream: tracker re-adjusts and keeps decoding
    the symbols before the gap; detections stay on cadence before it."""
    cfg = GOLDEN64
    bits, rx = _buffer(cfg)
    r = M.make_tracker(cfg, len(rx))(jnp.asarray(rx, jnp.complex64))
    assert int(r.count) == cfg.num_patterns
