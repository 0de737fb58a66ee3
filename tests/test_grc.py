"""GRC flowgraph importer — the reference's own .grc files map onto this
framework's configs and run (SURVEY.md L4/F4, drivers D1/D5/D6)."""

import os
import pickle

import numpy as np
import pytest

from lte_gnu_radio_code.io.grc import interpret_grc, load_grc, _eval
from lte_gnu_radio_code.utils.params import CFO_CASES, config_from_case

REF = "/root/reference/GNU-Radio-Repositories"
D1_GRC = f"{REF}/ofdm_chain.grc"
D6_GRC = f"{REF}/LEGACY/gr-ofdm-rx/examples/RxReceiver_Diag.grc"
D5_GRC = f"{REF}/LEGACY/gr-ofdm-tx/grc/RXtransmit_6.grc"

needs_ref = pytest.mark.skipif(not os.path.exists(D1_GRC),
                               reason="reference .grc files not mounted")


@needs_ref
def test_load_yaml_graph():
    g = load_grc(D1_GRC)
    assert g.fmt == "yaml"
    keys = {b.key for b in g.enabled_blocks()}
    assert {"RXOFDM_synch_and_chan_est", "TXOFDM_tx_signal_transmitter",
            "blocks_null_sink"} <= keys
    # the TX -> RX wire (ofdm_chain.grc connections)
    assert any(c[0].startswith("TXOFDM") and c[2].startswith("RXOFDM")
               for c in g.connections)


@needs_ref
def test_load_xml_graph_filters_disabled():
    g = load_grc(D6_GRC)
    assert g.fmt == "xml"
    enabled = {b.key for b in g.enabled_blocks()}
    assert "OFDMReceiver_SynchEstAndFO" in enabled
    # qtgui_time_sink and wxgui_fftsink are _enabled=0 in the file
    assert "wxgui_fftsink2" not in enabled


@needs_ref
def test_import_d1_matches_canonical_loopback():
    plan = interpret_grc(load_grc(D1_GRC))
    assert plan.kind == "flagship_loopback"
    c = plan.config
    # ofdm_chain.grc block params: nfft 64, cp 16, synch_dat [1,3], 60 data
    # bins, snr 50 — with the RXOFDM-generation conventions
    assert (c.nfft, c.cp_len, c.num_data_bins) == (64, 16, 60)
    assert tuple(c.synch_dat) == (1, 3)
    assert c.num_synch_bins == 62            # 64 clamped (SystemModel.py:36)
    assert any("clamped" in n for n in plan.notes)
    assert c.zc_prime == 37                  # synch_and_chan_est.py:53
    assert c.snr_convention == "linear"      # ctor snr used raw (:102)
    assert c.detection_gate == 0.4           # :170
    assert c.stride == c.cp_len - 1          # :81
    assert plan.source["file"] == "tx_data_offline.pckl"


@needs_ref
def test_import_d6_legacy_rx():
    plan = interpret_grc(load_grc(D6_GRC))
    assert plan.kind == "legacy_rx"
    assert plan.rx["case"] == 7              # top_block.py:129
    assert plan.rx["fo_range"] == [0]
    assert plan.rx["bit_recovery"]["modulation"] == "QPSK"
    expect = config_from_case(CFO_CASES, 7)
    assert plan.config.nfft == expect.nfft == 128
    assert plan.config.synch_dat == expect.synch_dat
    # the radio source must be flagged as substituted
    assert plan.source["kind"] == "iq_file"
    assert any("uhd_usrp_source" in n for n in plan.notes)


@needs_ref
def test_import_d5_legacy_tx():
    plan = interpret_grc(load_grc(D5_GRC))
    # only OFDMTxWithTimer (case 9) and the usrp sink are enabled
    assert plan.source == {"kind": "timed_pickle", "case": 9}
    assert "iq_file" in plan.sinks


def test_eval_grc_expressions():
    env = {"fft1": 256, "samp_rate": 10e6}
    assert _eval("'QPSK'") == "QPSK"
    assert _eval("[1, 3]") == [1, 3]
    assert _eval("list([0])") == [0]
    assert _eval("fft1/4", env) == 64
    assert _eval("fft1-2", env) == 254
    with pytest.raises(ValueError):
        _eval("undefined_var + 1", env)


@needs_ref
def test_run_imported_d1_loopback():
    from lte_gnu_radio_code.cli import grc_import

    out = grc_import.main([D1_GRC, "--run", "--json"])
    assert out["run"]["found"] is True
    assert out["run"]["ber"] == 0.0
    assert out["run"]["lock_ptr"] == 16      # CP length — canonical lock


@needs_ref
def test_run_imported_d6_on_synthetic_capture(tmp_path):
    """The D6 RX graph runs on a case-7 capture and recovers the bits."""
    from lte_gnu_radio_code.cli import grc_import
    from lte_gnu_radio_code.reference_cpu import golden as G

    cfg = config_from_case(CFO_CASES, 7, snr_db=1e8)
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, cfg.num_bits)
    rx = G.apply_channel(G.tx_frame(cfg, bits), G.channel_taps("Fading"),
                         max_impulse=cfg.nfft)
    cap = tmp_path / "capture.pckl"
    with open(cap, "wb") as f:
        pickle.dump(rx[None, :], f, protocol=2)

    out = grc_import.main([D6_GRC, "--run", "--tx-pickle", str(cap),
                           "--json"])
    assert out["run"]["detections"] > 0
    assert out["run"]["hard_bits"] > 0


@needs_ref
def test_out_config_roundtrips_through_json(tmp_path):
    from lte_gnu_radio_code.cli import grc_import

    out_json = tmp_path / "imported.json"
    grc_import.main([D1_GRC, "-o", str(out_json), "--json"])
    import json

    cfgd = json.loads(out_json.read_text())
    from lte_gnu_radio_code.utils.params import OFDMConfig

    c = OFDMConfig(**{**cfgd, "synch_dat": tuple(cfgd["synch_dat"])})
    assert c.validate().nfft == 64
