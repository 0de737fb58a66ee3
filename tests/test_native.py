"""Native ring buffer + chunker: correctness, wraparound, threading, and the
end-to-end native-staging -> streaming-RX path."""

import threading

import numpy as np
import pytest

from lte_gnu_radio_code.runtime import native


@pytest.fixture(scope="module")
def lib():
    try:
        return native.load_library()
    except Exception as e:  # toolchain missing — skip, don't fail
        pytest.skip(f"native build unavailable: {e}")


def test_ring_roundtrip(lib):
    r = native.NativeRing(1024)
    x = (np.arange(100) + 1j * np.arange(100)).astype(np.complex64)
    assert r.write(x) == 100
    assert r.available == 100
    back = r.read(100)
    np.testing.assert_array_equal(back, x)
    assert r.available == 0


def test_ring_wraparound(lib):
    r = native.NativeRing(128)
    total_in, total_out = [], []
    rng = np.random.default_rng(0)
    for i in range(50):
        x = (rng.standard_normal(37) + 1j * rng.standard_normal(37)
             ).astype(np.complex64)
        w = r.write(x)
        total_in.append(x[:w])
        total_out.append(r.read(23))
    total_out.append(r.read(10000))
    a = np.concatenate(total_in)
    b = np.concatenate(total_out)
    np.testing.assert_array_equal(b, a[:len(b)])


def test_ring_backpressure(lib):
    r = native.NativeRing(64)  # rounds to 64
    x = np.ones(100, dtype=np.complex64)
    assert r.write(x) == 64    # full
    assert r.space == 0
    assert r.write(x) == 0


def test_ring_peek(lib):
    r = native.NativeRing(64)
    x = np.arange(10).astype(np.complex64)
    r.write(x)
    np.testing.assert_array_equal(r.peek(5), x[:5])
    assert r.available == 10   # peek does not consume
    np.testing.assert_array_equal(r.read(10), x)


def test_chunker_carry(lib):
    r = native.NativeRing(4096)
    c = native.NativeChunker(r, chunk=100, max_quantum=7)
    x = np.arange(250).astype(np.complex64)
    r.write(x)
    chunks = []
    while (out := c.pump()) is not None:
        chunks.append(out)
    assert len(chunks) == 2
    np.testing.assert_array_equal(np.concatenate(chunks), x[:200])
    assert c.staged == 50       # leftover carried for the next pump


def test_spsc_threaded(lib):
    """Producer/consumer threads — GNU Radio's scheduler topology."""
    r = native.NativeRing(1 << 12)
    n = 200_000
    src = (np.random.default_rng(1).standard_normal(n)
           .astype(np.float32)).astype(np.complex64)
    out = np.empty(n, dtype=np.complex64)

    def produce():
        sent = 0
        while sent < n:
            sent += r.write(src[sent:sent + 1024])

    got = [0]

    def consume():
        while got[0] < n:
            chunk = r.read(min(777, n - got[0]))
            out[got[0]:got[0] + len(chunk)] = chunk
            got[0] += len(chunk)

    tp = threading.Thread(target=produce)
    tc = threading.Thread(target=consume)
    tp.start(); tc.start(); tp.join(); tc.join()
    np.testing.assert_array_equal(out, src)


def test_native_staging_feeds_streaming_rx(lib):
    """Full host path: pickle replay -> native ring -> chunker -> jitted
    streaming RX; zero BER on the canonical frame."""
    import jax.numpy as jnp

    from lte_gnu_radio_code.reference_cpu import golden as G
    from lte_gnu_radio_code.runtime.stream import StreamingRx
    from lte_gnu_radio_code.utils.params import GOLDEN64

    cfg = GOLDEN64
    bits = np.random.default_rng(0).integers(0, 2, cfg.num_bits)
    tx = G.tx_frame(cfg, bits)
    rx = G.apply_channel(tx, G.channel_taps("Fading"), max_impulse=64)

    ring = native.NativeRing(1 << 16)
    chunker = native.NativeChunker(ring, chunk=640)
    srx = StreamingRx(cfg, 640)

    pos, got = 0, {}
    while pos < len(rx) or chunker.staged or ring.available:
        if pos < len(rx):
            pos += ring.write(rx[pos:pos + 4095])
        while (chunk := chunker.pump()) is not None:
            out = srx.push(chunk)
            for i, k in enumerate(np.asarray(out.block_ids)):
                if k >= 0:
                    got[int(k)] = np.asarray(out.phasors)[i]
        if pos >= len(rx):
            break
    out = srx.finish()
    for i, k in enumerate(np.asarray(out.block_ids)):
        if k >= 0:
            got[int(k)] = np.asarray(out.phasors)[i]

    ph = np.stack([got[k] for k in sorted(got)]).reshape(-1)
    hard, _, _ = G.bit_recovery(ph)
    nb = min(len(hard), len(bits))
    assert np.mean(hard[:nb] != bits[:nb]) == 0.0
