"""CLI apps (D1-D4 replacements) — driven through their main() entrypoints."""

import json

import numpy as np
import pytest

from lte_gnu_radio_code.cli import ber_sweep, ofdm_chain, pls_demo, rx_file
from lte_gnu_radio_code.io import pickles as io
from lte_gnu_radio_code.reference_cpu import golden as G
from lte_gnu_radio_code.utils.params import (CFO_CASES, GOLDEN64,
                                                 config_from_case)


def test_ofdm_chain_loopback_default():
    out = ofdm_chain.main(["--num-ofdm-symb", "48"])
    assert out["found"] and out["ber"] == 0.0


def test_ofdm_chain_on_reference_pickle():
    ref = "/root/reference/GNU-Radio-Repositories/TEST/GNU_RADIO_OFFLINE"
    try:
        out = ofdm_chain.main([
            "--tx-pickle",
            f"{ref}/Data/tx_data_offline_chan_type_Fading_SNR_100.pckl",
            "--bits-pickle",
            f"{ref}/Data/tx_bit_data_chan_type_Fading_SNR_100.pckl"])
    except FileNotFoundError:
        pytest.skip("reference not mounted")
    assert out["found"] and out["lock_ptr"] == 16 and out["ber"] == 0.0


def test_ofdm_chain_qam64():
    out = ofdm_chain.main(["--num-ofdm-symb", "48", "--modulation", "QAM64",
                           "--channel", "Ideal", "--snr", "60"])
    assert out["ber"] == 0.0


def test_ber_sweep_monotone():
    rows = ber_sweep.main(["--snrs", "4", "10", "30", "--frames", "2",
                           "--num-ofdm-symb", "48"])
    bers = [r["ber"] for r in rows]
    assert bers[0] >= bers[-1]
    assert bers[-1] == 0.0


def test_pls_demo():
    rows = pls_demo.main(["--iters", "2"])
    assert all(r["bit_errors"] == 0 for r in rows)


def test_rx_file_cfo_case(tmp_path):
    cfg = config_from_case(CFO_CASES, 0, snr_db=1e8)
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, cfg.num_bits)
    tx = G.tx_frame(cfg, bits)
    rx = G.apply_channel(tx, G.channel_taps("Fading"), max_impulse=cfg.nfft)
    io.save_pickle_iq(tmp_path / "iq.pckl", rx)
    out = rx_file.main([str(tmp_path / "iq.pckl"), "--case", "0"])
    assert out["detections"] >= cfg.num_patterns - 1


def test_config_files_load():
    import pathlib

    from lte_gnu_radio_code.utils.params import OFDMConfig
    for f in pathlib.Path("configs").glob("*.json"):
        kw = json.load(open(f))
        kw["synch_dat"] = tuple(kw["synch_dat"])
        cfg = OFDMConfig(**kw).validate()
        assert cfg.nfft >= 64


def test_ofdm_chain_stream_mode_replayed_vectors(ref_vectors):
    """The D1 loopback's real topology: the shipped TX vector replayed
    continuously through the multi-detection streaming receiver — every
    pattern block of every replay re-detected (timing shifts 63 samples per
    replay due to the channel tail), zero bit errors."""
    import pathlib

    from lte_gnu_radio_code.cli import ofdm_chain

    base = pathlib.Path(
        "/root/reference/GNU-Radio-Repositories/TEST/GNU_RADIO_OFFLINE/Data")
    out = ofdm_chain.main([
        "--stream", "960", "--repeat", "3",
        "--tx-pickle", str(base / "tx_data_offline_chan_type_Fading_SNR_100.pckl"),
        "--bits-pickle", str(base / "tx_bit_data_chan_type_Fading_SNR_100.pckl"),
        "--json"])
    assert out["detections"] == 180
    assert out["ber"] == 0.0


def test_rx_file_stream_equals_batch(tmp_path):
    """--stream (the GR block's continuous mode) finds the same detections
    as the whole-buffer batch run."""
    cfg = config_from_case(CFO_CASES, 0, snr_db=1e8)
    rng = np.random.default_rng(3)
    rx = np.concatenate([
        G.apply_channel(G.tx_frame(cfg, rng.integers(0, 2, cfg.num_bits)),
                        G.channel_taps("Fading"), max_impulse=cfg.nfft)
        for _ in range(2)])
    io.save_pickle_iq(tmp_path / "iq.pckl", rx)
    batch = rx_file.main([str(tmp_path / "iq.pckl"), "--case", "0"])
    stream = rx_file.main([str(tmp_path / "iq.pckl"), "--case", "0",
                           "--stream", "960"])
    nb = batch["detections"]
    assert stream["detections"] >= nb
    assert stream["ptrs"][:nb] == batch["ptrs"]
    assert stream["delays"][:nb] == batch["delays"]


def test_tx_file_generate_and_replay(tmp_path):
    """D5 analog: generate writes a decodable frame; replay streams the
    legacy numbered pickles through the 4095-quantum chunked source."""
    from lte_gnu_radio_code.cli import tx_file
    from lte_gnu_radio_code.models import rxofdm
    import jax.numpy as jnp

    gen = tx_file.main([str(tmp_path / "gen.pckl"), "--generate",
                        "--num-symbols", "48", "--json"])
    sig = io.load_pickle_iq(tmp_path / "gen.pckl").ravel()
    assert gen["samples"] == sig.size
    from lte_gnu_radio_code.utils.params import OFDMConfig
    cfg = OFDMConfig(num_ofdm_symb=48).validate()
    faded = G.apply_channel(sig, G.channel_taps("Fading"),
                            max_impulse=cfg.nfft)
    r = rxofdm.make_rx(cfg, len(faded))(jnp.asarray(faded, jnp.complex64))
    assert bool(r.found)

    # replay: 2 repeats over one numbered file == 2 exact copies of the row
    io.save_pickle_iq(tmp_path / "tx_data_0.pckl", sig[None, :])
    rep = tx_file.main([str(tmp_path / "replay.npy"),
                        "--pickle-dir", str(tmp_path),
                        "--file-stem", "tx_data_", "--repeat", "2",
                        "--json"])
    out = np.load(tmp_path / "replay.npy")
    assert rep["samples"] == out.size
    two = np.tile(sig.astype(np.complex64), 2)
    np.testing.assert_array_equal(out[: two.size], two)
