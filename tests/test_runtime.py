"""Streaming runtime: chunked RX == batch RX; io sources; flowgraph."""

import numpy as np
import jax.numpy as jnp
import pytest

from lte_gnu_radio_code.io import pickles as io
from lte_gnu_radio_code.models import rxofdm
from lte_gnu_radio_code.reference_cpu import golden as G
from lte_gnu_radio_code.runtime.flowgraph import (CollectSink, Flowgraph,
                                                      NullSink)
from lte_gnu_radio_code.runtime.stream import StreamingRx
from lte_gnu_radio_code.utils.params import GOLDEN64


@pytest.fixture(scope="module")
def buffer64():
    cfg = GOLDEN64
    bits = np.random.default_rng(0).integers(0, 2, cfg.num_bits)
    tx = G.tx_frame(cfg, bits)
    rx = G.apply_channel(tx, G.channel_taps("Fading"), max_impulse=64)
    rx = G.awgn(cfg, rx, np.random.default_rng(1), np.var(tx))
    return bits, rx


@pytest.mark.parametrize("chunk_len", [320, 640, 1600])
def test_streaming_rx_equals_batch_rx(buffer64, chunk_len):
    cfg = GOLDEN64
    bits, rx = buffer64
    batch = rxofdm.make_rx(cfg, len(rx))(jnp.asarray(rx, jnp.complex64))
    ph_batch = np.asarray(batch.phasors).reshape(
        cfg.num_patterns, cfg.synch_dat[1], cfg.num_data_bins)

    srx = StreamingRx(cfg, chunk_len)
    n_chunks = int(np.ceil(len(rx) / chunk_len))
    padded = np.zeros(n_chunks * chunk_len, dtype=np.complex64)
    padded[:len(rx)] = rx
    got = {}
    for c in range(n_chunks):
        out = srx.push(padded[c * chunk_len:(c + 1) * chunk_len])
        ids = np.asarray(out.block_ids)
        ph = np.asarray(out.phasors)
        for i, k in enumerate(ids):
            if k >= 0:
                got[int(k)] = ph[i]
    out = srx.finish()
    for i, k in enumerate(np.asarray(out.block_ids)):
        if k >= 0:
            got[int(k)] = np.asarray(out.phasors)[i]

    assert bool(out.found)
    assert int(out.lock_ptr) == int(batch.lock_ptr)
    assert sorted(got) == list(range(cfg.num_patterns))
    streamed = np.stack([got[k] for k in range(cfg.num_patterns)])
    np.testing.assert_allclose(streamed, ph_batch, atol=2e-5)


def test_streaming_rx_no_lock_on_noise():
    cfg = GOLDEN64
    srx = StreamingRx(cfg, 640)
    rng = np.random.default_rng(9)
    for _ in range(6):
        out = srx.push(0.05 * (rng.standard_normal(640) +
                               1j * rng.standard_normal(640)))
    assert not bool(out.found)


def test_flowgraph_loopback(buffer64, tmp_path):
    """ofdm_chain.py D1 equivalent: pickle source -> streaming RX -> sink."""
    cfg = GOLDEN64
    bits, rx = buffer64
    io.save_pickle_iq(tmp_path / "tx_data_offline.pckl", rx[None, :])

    src = io.TxPickleSource(tmp_path, "tx_data_offline.pckl")
    srx = StreamingRx(cfg, 640)
    sink = CollectSink()
    fg = Flowgraph(chunk_len=640).connect(src, srx.push, sink)
    fg.run(n_chunks=len(rx) // 640)
    phs = [np.asarray(o.phasors)[np.asarray(o.valid)] for o in sink.items]
    total = sum(p.shape[0] for p in phs)
    assert total > 0
    hard, _, _ = G.bit_recovery(np.concatenate([p.reshape(-1) for p in phs]))
    nb = min(len(hard), len(bits))
    assert np.mean(hard[:nb] != bits[:nb]) == 0.0


def test_pickle_roundtrip_and_check(tmp_path):
    data = np.arange(10, dtype=np.complex128) * (1 + 2j)
    io.save_pickle_iq(tmp_path / "x.pckl", data)
    back = io.load_pickle_iq(tmp_path / "x.pckl")
    np.testing.assert_array_equal(back, data)
    info = io.pickle_check(tmp_path / "x.pckl")
    assert info["shape"] == (10,)


def test_reference_vector_loader():
    try:
        v = io.load_reference_vectors()
    except FileNotFoundError:
        pytest.skip("reference not mounted")
    assert v["bits"].shape == (21600,)
    assert v["tx_online"].shape == (19200,)
    assert v["tx_offline"].shape == (19263,)


def test_chunked_source_leftover_carry(tmp_path):
    row = np.arange(100, dtype=np.complex128)
    io.save_pickle_iq(tmp_path / "tx_data_0.pckl", row[None, :])
    src = io.ChunkedPickleSource(tmp_path, "tx_data_", num_files=1,
                                 num_repeat=2, max_chunk=30)
    out = src(250)
    # 30-sample work quanta with leftover carry must still reproduce the
    # stream: positions 0..99 = row, 100..199 = row again (repeat), ...
    np.testing.assert_array_equal(out[:100].real, np.arange(100))
    np.testing.assert_array_equal(out[100:200].real, np.arange(100))


def test_timed_source_row_advance(tmp_path):
    data = np.stack([np.full(8, i, dtype=np.complex128) for i in range(3)])
    io.save_pickle_iq(tmp_path / "m.pckl", data)
    src = io.TimedPickleSource(tmp_path, "m.pckl", calls_per_row=2)
    rows = [int(src(8)[0].real) for _ in range(6)]
    assert rows == [0, 0, 1, 1, 2, 2]


def test_golden_npz_roundtrip(tmp_path):
    io.save_golden_npz(tmp_path / "g.npz", a=np.ones(3), b=np.zeros((2, 2)))
    back = io.load_golden_npz(tmp_path / "g.npz")
    assert set(back) == {"a", "b"}
