"""LTE-scale configs (BASELINE.json config 5): NFFT 1024/2048 end-to-end and
time-sharded on the virtual 8-device mesh."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from lte_gnu_radio_code.models import chain, rxofdm
from lte_gnu_radio_code.parallel import mesh as meshmod, sharded
from lte_gnu_radio_code.reference_cpu import golden as G
from lte_gnu_radio_code.utils.params import LTE1024, LTE2048, OFDMConfig


@pytest.mark.parametrize("cfg", [LTE1024, LTE2048], ids=["1024", "2048"])
def test_lte_chain_zero_ber(cfg):
    # shrink the frame for test speed; numerology unchanged
    cfg = OFDMConfig(**{**cfg.__dict__, "num_ofdm_symb": 16}).validate()
    bits = jnp.asarray(np.random.default_rng(0).integers(
        0, 2, cfg.num_bits, dtype=np.int32))
    out = chain.make_chain(cfg)(bits, jax.random.PRNGKey(0))
    assert bool(out.found) and int(out.lock_ptr) == cfg.cp_len
    assert float(out.ber) == 0.0


def test_lte1024_sharded_rx_matches_single_device():
    cfg = OFDMConfig(**{**LTE1024.__dict__, "num_ofdm_symb": 16}).validate()
    bits = np.random.default_rng(1).integers(0, 2, cfg.num_bits)
    tx = G.tx_frame(cfg, bits)
    rx = G.apply_channel(tx, G.channel_taps("Fading"), max_impulse=cfg.nfft)
    x = jnp.asarray(rx, jnp.complex64)
    r1 = rxofdm.make_rx(cfg, len(rx))(x)
    mesh = meshmod.time_mesh(4)
    rs = sharded.make_sharded_rx(cfg, len(rx), mesh)(x)
    assert bool(rs.found)
    assert int(rs.lock_ptr) == int(r1.lock_ptr)
    np.testing.assert_array_equal(np.asarray(rs.hard_bits),
                                  np.asarray(r1.hard_bits))


def test_lte_qam64_moderate_snr():
    cfg = OFDMConfig(**{**LTE1024.__dict__, "num_ofdm_symb": 16,
                        "modulation": "QAM64", "snr_db": 40.0,
                        "channel": "Ideal"}).validate()
    bits = jnp.asarray(np.random.default_rng(2).integers(
        0, 2, cfg.num_bits, dtype=np.int32))
    out = chain.make_chain(cfg)(bits, jax.random.PRNGKey(1))
    assert float(out.ber) == 0.0


def test_lte1024_streaming_reacq_equals_batch():
    """Continuous multi-detection streaming at LTE scale (NFFT 1024,
    stride = cp-1): chunked == whole-buffer batch.  Exercises the strided
    conv-bank search inside the stream step."""
    from lte_gnu_radio_code.models import stream_rx
    from lte_gnu_radio_code.runtime import stream as stream_rt

    cfg = OFDMConfig(**{**LTE1024.__dict__, "num_ofdm_symb": 16}).validate()
    rng = np.random.default_rng(3)
    sig = np.concatenate([
        G.apply_channel(G.tx_frame(cfg, rng.integers(0, 2, cfg.num_bits)),
                        G.channel_taps("Fading"), max_impulse=cfg.nfft)
        for _ in range(2)])

    batch = stream_rx.make_rx_detections(cfg, len(sig))(
        jnp.asarray(sig, jnp.complex64))
    nb = int(batch.count)
    assert nb > 0

    chunk = cfg.stride * 48                       # 12240 samples
    srx = stream_rt.ReacqStreamingRx(cfg, chunk)
    buf = np.zeros(-(-len(sig) // chunk) * chunk, np.complex64)
    buf[: len(sig)] = sig
    outs = [srx.push(buf[i: i + chunk],
                     n_real=max(0, min(chunk, len(sig) - i)))
            for i in range(0, len(buf), chunk)]
    outs.extend(srx.finish())
    valid = [np.asarray(o.valid) for o in outs]
    ptrs = np.concatenate([np.asarray(o.ptrs)[v] for o, v in zip(outs, valid)])
    hard = np.concatenate([np.asarray(o.hard_bits)[v]
                           for o, v in zip(outs, valid)])
    keep = ptrs <= int(np.asarray(batch.ptrs[:nb]).max())
    np.testing.assert_array_equal(ptrs[keep], np.asarray(batch.ptrs[:nb]))
    np.testing.assert_array_equal(hard[keep], np.asarray(batch.hard_bits[:nb]))
