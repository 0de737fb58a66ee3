"""Continuous multi-detection RX (flagship gr-RXOFDM R1 streaming semantics):
batch vs NumPy oracle, chunked vs batch bit-exactness, re-acquisition under
injected timing drift + a mid-stream channel change, checkpoint/resume."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from lte_gnu_radio_code.models import stream_rx
from lte_gnu_radio_code.reference_cpu import golden
from lte_gnu_radio_code.runtime import stream as stream_rt
from lte_gnu_radio_code.utils.params import GOLDEN64, OFDMConfig

CFG = GOLDEN64


def _tx(cfg, seed):
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, cfg.num_bits)
    return bits, golden.tx_frame(cfg, bits)


@pytest.fixture(scope="module")
def faded():
    bits, tx = _tx(CFG, 0)
    rx = golden.apply_channel(tx, golden.channel_taps("Fading"))
    return bits, rx


def test_rx_detections_matches_oracle(faded):
    bits, rx = faded
    o = golden.rx_stream(CFG, rx)
    r = stream_rx.make_rx_detections(CFG, len(rx))(jnp.asarray(rx, jnp.complex64))
    n = int(r.count)
    assert n == len(o["ptrs"]) == CFG.num_patterns == 60
    np.testing.assert_array_equal(np.asarray(r.ptrs[:n]), o["ptrs"])
    np.testing.assert_array_equal(np.asarray(r.delays[:n]), o["delays"])
    assert bool(np.asarray(r.demod_ok[:n]).all())
    np.testing.assert_allclose(np.asarray(r.phasors[:n]), o["phasors"],
                               atol=2e-4)
    # hard bits: JAX == oracle == transmitted
    oh, _, _ = golden.bit_recovery(o["phasors"].reshape(-1, CFG.num_data_bins))
    th = np.asarray(r.hard_bits[:n]).ravel()
    np.testing.assert_array_equal(th, oh)
    np.testing.assert_array_equal(th, bits[: th.size])


@pytest.mark.parametrize("chunk_len", [960, 1504, 4800])
def test_reacq_stream_equals_batch(faded, chunk_len):
    """Chunked streaming == whole-buffer batch, bit-for-bit, any chunking."""
    bits, rx = faded
    batch = stream_rx.make_rx_detections(CFG, len(rx))(
        jnp.asarray(rx, jnp.complex64))
    nb = int(batch.count)

    srx = stream_rt.ReacqStreamingRx(CFG, chunk_len)
    buf = np.zeros(-(-len(rx) // chunk_len) * chunk_len, np.complex64)
    buf[: len(rx)] = rx
    outs = []
    for i in range(0, len(buf), chunk_len):
        outs.append(srx.push(buf[i : i + chunk_len],
                             n_real=max(0, min(chunk_len, len(rx) - i))))
    outs.extend(srx.finish())

    ptrs = np.concatenate([np.asarray(o.ptrs)[np.asarray(o.valid)] for o in outs])
    delays = np.concatenate([np.asarray(o.delays)[np.asarray(o.valid)] for o in outs])
    hard = np.concatenate([np.asarray(o.hard_bits)[np.asarray(o.valid)] for o in outs])
    ph = np.concatenate([np.asarray(o.phasors)[np.asarray(o.valid)] for o in outs])
    ok = np.concatenate([np.asarray(o.demod_ok)[np.asarray(o.valid)] for o in outs])

    # compare on the batch's evaluated trial range (the stream also probes
    # flush-region trials the batch never evaluates)
    keep = ptrs <= int(np.asarray(batch.ptrs[:nb]).max())
    np.testing.assert_array_equal(ptrs[keep], np.asarray(batch.ptrs[:nb]))
    np.testing.assert_array_equal(delays[keep], np.asarray(batch.delays[:nb]))
    assert ok[keep].all()
    np.testing.assert_array_equal(hard[keep], np.asarray(batch.hard_bits[:nb]))
    np.testing.assert_allclose(ph[keep], np.asarray(batch.phasors[:nb]),
                               atol=2e-5)


def test_reacq_drift_and_channel_change():
    """30 frames over Fading + timing drift + 30 frames over a different
    channel: every frame re-detected, channel refreshed, zero bit errors —
    and bit-for-bit equal to the oracle run on the same stream."""
    half = OFDMConfig(num_ofdm_symb=120).validate()   # 30 pattern blocks
    bits1, tx1 = _tx(half, 1)
    bits2, tx2 = _tx(half, 2)
    h1 = golden.channel_taps("Fading")
    h2 = np.array([0.9, 0.2 - 0.1j, 0.05j])
    h2 = h2 / np.linalg.norm(h2)
    drift = 37                                         # injected timing slip
    sig = np.concatenate([
        golden.apply_channel(tx1, h1),
        np.zeros(drift, complex),
        golden.apply_channel(tx2, h2)])

    o = golden.rx_stream(half, sig, max_det=100)
    assert len(o["ptrs"]) == 60

    srx = stream_rt.ReacqStreamingRx(half, 960)
    buf = np.zeros(-(-len(sig) // 960) * 960, np.complex64)
    buf[: len(sig)] = sig
    outs = [srx.push(buf[i : i + 960],
                     n_real=max(0, min(960, len(sig) - i)))
            for i in range(0, len(buf), 960)]
    outs.extend(srx.finish())
    valid = [np.asarray(o_.valid) for o_ in outs]
    ptrs = np.concatenate([np.asarray(o_.ptrs)[v] for o_, v in zip(outs, valid)])
    hard = np.concatenate([np.asarray(o_.hard_bits)[v] for o_, v in zip(outs, valid)])

    np.testing.assert_array_equal(ptrs, o["ptrs"])
    oh, _, _ = golden.bit_recovery(o["phasors"].reshape(-1, half.num_data_bins))
    np.testing.assert_array_equal(hard.ravel(), oh)

    # zero errors against BOTH halves' transmitted bits despite the slip and
    # the channel change — the single-lock receiver cannot do this
    sent = np.concatenate([bits1, bits2])
    np.testing.assert_array_equal(hard.ravel(), sent)


def test_reacq_notchy_channel_matches_oracle_bitforbit():
    """Even when the reference algorithm itself mis-decodes (early gate
    crossing + CP-head ISI on a notchy channel), the JAX stream reproduces
    the oracle's detections and bits exactly."""
    half = OFDMConfig(num_ofdm_symb=120).validate()
    bits1, tx1 = _tx(half, 1)
    bits2, tx2 = _tx(half, 2)
    h2 = np.array([0.8, 0.1 - 0.5j, 0.0, -0.2j])
    h2 = h2 / np.linalg.norm(h2)
    sig = np.concatenate([
        golden.apply_channel(tx1, golden.channel_taps("Fading")),
        np.zeros(37, complex),
        golden.apply_channel(tx2, h2)])
    o = golden.rx_stream(half, sig, max_det=100)
    oh, _, _ = golden.bit_recovery(o["phasors"].reshape(-1, half.num_data_bins))
    sent = np.concatenate([bits1, bits2])
    assert 0 < int((oh != sent).sum()) < 100   # the scenario really is hard

    srx = stream_rt.ReacqStreamingRx(half, 960)
    buf = np.zeros(-(-len(sig) // 960) * 960, np.complex64)
    buf[: len(sig)] = sig
    outs = [srx.push(buf[i : i + 960],
                     n_real=max(0, min(960, len(sig) - i)))
            for i in range(0, len(buf), 960)]
    outs.extend(srx.finish())
    valid = [np.asarray(o_.valid) for o_ in outs]
    ptrs = np.concatenate([np.asarray(o_.ptrs)[v] for o_, v in zip(outs, valid)])
    hard = np.concatenate([np.asarray(o_.hard_bits)[v] for o_, v in zip(outs, valid)])
    np.testing.assert_array_equal(ptrs, o["ptrs"])
    np.testing.assert_array_equal(hard.ravel(), oh)


def test_tracker_stream_equals_batch(faded):
    """Streaming tracker (R6 work() semantics, carry across chunks) accepts
    exactly the batch tracker's detections, with matching channel estimates,
    phasors and hard bits."""
    from lte_gnu_radio_code.models import tracker as trk

    bits, rx = faded
    batch = trk.make_tracker(CFG, len(rx))(jnp.asarray(rx, jnp.complex64))
    nb = int(batch.count)
    assert nb > 20

    srx = stream_rt.TrackerStreamingRx(CFG, 960)
    buf = np.zeros(-(-len(rx) // 960) * 960, np.complex64)
    buf[: len(rx)] = rx
    outs = [srx.push(buf[i : i + 960],
                     n_real=max(0, min(960, len(rx) - i)))
            for i in range(0, len(buf), 960)]
    outs.extend(srx.finish())
    valid = [np.asarray(o.valid) for o in outs]
    ptrs = np.concatenate([np.asarray(o.ptrs)[v] for o, v in zip(outs, valid)])
    delays = np.concatenate([np.asarray(o.delays)[v] for o, v in zip(outs, valid)])
    chans = np.concatenate([np.asarray(o.chans)[v] for o, v in zip(outs, valid)])
    ph = np.concatenate([np.asarray(o.phasors)[v] for o, v in zip(outs, valid)])
    hard = np.concatenate([np.asarray(o.hard_bits)[v] for o, v in zip(outs, valid)])

    assert len(ptrs) == nb
    np.testing.assert_array_equal(ptrs, np.asarray(batch.ptrs[:nb]))
    np.testing.assert_array_equal(delays, np.asarray(batch.delays[:nb]))
    np.testing.assert_allclose(chans, np.asarray(batch.chan_freq[:nb]),
                               atol=1e-5)
    bph = np.asarray(batch.phasors).reshape(-1, CFG.synch_dat[1],
                                            CFG.num_data_bins)[:nb]
    np.testing.assert_allclose(ph, bph, atol=2e-4)
    bhard = np.asarray(batch.hard_bits).reshape(
        -1, CFG.synch_dat[1] * CFG.num_data_bins * 2)[:nb]
    np.testing.assert_array_equal(hard.reshape(nb, -1), bhard)


@pytest.mark.parametrize("n_shards,chunk_len", [(2, 1920), (4, 1920),
                                                (8, 4800)])
def test_sharded_streaming_equals_batch(faded, n_shards, chunk_len):
    """Chunked AND time-sharded == single-device batch, bit-for-bit: the §5
    sequence-scaling composition (detections deduped across both chunk and
    shard edges)."""
    from lte_gnu_radio_code.parallel import mesh as meshmod
    from lte_gnu_radio_code.parallel import streaming as pstream

    bits, rx = faded
    batch = stream_rx.make_rx_detections(CFG, len(rx))(
        jnp.asarray(rx, jnp.complex64))
    nb = int(batch.count)

    mesh = meshmod.time_mesh(n_shards)
    srx = pstream.ShardedReacqStreamingRx(CFG, chunk_len, mesh)
    buf = np.zeros(-(-len(rx) // chunk_len) * chunk_len, np.complex64)
    buf[: len(rx)] = rx
    outs = [srx.push(buf[i : i + chunk_len],
                     n_real=max(0, min(chunk_len, len(rx) - i)))
            for i in range(0, len(buf), chunk_len)]
    outs.extend(srx.finish())

    valid = [np.asarray(o.valid) for o in outs]
    ptrs = np.concatenate([np.asarray(o.ptrs)[v] for o, v in zip(outs, valid)])
    delays = np.concatenate([np.asarray(o.delays)[v] for o, v in zip(outs, valid)])
    hard = np.concatenate([np.asarray(o.hard_bits)[v] for o, v in zip(outs, valid)])
    ph = np.concatenate([np.asarray(o.phasors)[v] for o, v in zip(outs, valid)])

    keep = ptrs <= int(np.asarray(batch.ptrs[:nb]).max())
    np.testing.assert_array_equal(ptrs[keep], np.asarray(batch.ptrs[:nb]))
    np.testing.assert_array_equal(delays[keep], np.asarray(batch.delays[:nb]))
    np.testing.assert_array_equal(hard[keep], np.asarray(batch.hard_bits[:nb]))
    np.testing.assert_allclose(ph[keep], np.asarray(batch.phasors[:nb]),
                               atol=2e-5)


def test_reacq_checkpoint_resume(tmp_path, faded):
    bits, rx = faded
    chunk = 960
    buf = np.zeros(-(-len(rx) // chunk) * chunk, np.complex64)
    buf[: len(rx)] = rx
    chunks = [buf[i : i + chunk] for i in range(0, len(buf), chunk)]
    n_reals = [max(0, min(chunk, len(rx) - i))
               for i in range(0, len(buf), chunk)]

    a = stream_rt.ReacqStreamingRx(CFG, chunk)
    full = [a.push(c, n) for c, n in zip(chunks, n_reals)] + a.finish()

    b = stream_rt.ReacqStreamingRx(CFG, chunk)
    for c, n in zip(chunks[:7], n_reals[:7]):
        b.push(c, n)
    b.save_state(tmp_path / "st.npz")
    c2 = stream_rt.ReacqStreamingRx(CFG, chunk)
    c2.load_state(tmp_path / "st.npz")
    resumed = [c2.push(c, n) for c, n in zip(chunks[7:], n_reals[7:])] + c2.finish()

    f_hard = np.concatenate([np.asarray(o.hard_bits)[np.asarray(o.valid)]
                             for o in full[7:]])
    r_hard = np.concatenate([np.asarray(o.hard_bits)[np.asarray(o.valid)]
                             for o in resumed])
    np.testing.assert_array_equal(f_hard, r_hard)


def test_push_many_bit_identical_to_sequential(faded):
    """push_many (K chunk-steps per dispatch via lax.scan) must equal K
    sequential push() calls bit-for-bit — outputs AND carry state."""
    bits, rx = faded
    chunk = 960
    n = (len(rx) // chunk) * chunk
    chunks = np.asarray(rx[:n], np.complex64).reshape(-1, chunk)

    a = stream_rt.ReacqStreamingRx(CFG, chunk)
    b = stream_rt.ReacqStreamingRx(CFG, chunk)
    outs_a = [a.push(c) for c in chunks]
    outs_b = []
    k = 4
    for i in range(0, len(chunks) - len(chunks) % k, k):
        outs_b.append(b.push_many(chunks[i: i + k]))
    for c in chunks[len(chunks) - len(chunks) % k:]:
        outs_b.append(jax.tree.map(lambda x: x[None], b.push(c)))

    for field in ["ptrs", "delays", "valid", "phasors", "hard_bits"]:
        va = np.concatenate([np.asarray(getattr(o, field))[None]
                             for o in outs_a])
        vb = np.concatenate([np.asarray(getattr(o, field)) for o in outs_b])
        np.testing.assert_array_equal(va, vb, err_msg=field)
    np.testing.assert_array_equal(np.asarray(a.state.hist),
                                  np.asarray(b.state.hist))
    assert int(a.state.base) == int(b.state.base)
    assert int(a.state.last_det_ptr) == int(b.state.last_det_ptr)


def test_push_many_legacy_bit_identical(faded):
    bits, rx = faded
    from lte_gnu_radio_code.utils.params import CFO_CASES, config_from_case
    cfg = config_from_case(CFO_CASES, 0, snr_db=1e8)
    bits0, tx = _tx(cfg, 3)
    sig = golden.apply_channel(tx, golden.channel_taps("Fading"),
                               max_impulse=cfg.nfft)
    chunk = 510                       # multiple of the case-0 stride (15)
    n = (len(sig) // chunk) * chunk
    chunks = np.asarray(sig[:n], np.complex64).reshape(-1, chunk)
    a = stream_rt.LegacyStreamingRx(cfg, chunk, fo_range=(0.0, 1500.0))
    b = stream_rt.LegacyStreamingRx(cfg, chunk, fo_range=(0.0, 1500.0))
    outs_a = [a.push(c) for c in chunks]
    outs_b = [b.push_many(chunks[i: i + 3]) for i in range(0, len(chunks) - len(chunks) % 3, 3)]
    outs_b += [jax.tree.map(lambda x: x[None], b.push(c))
               for c in chunks[len(chunks) - len(chunks) % 3:]]
    for field in ["ptrs", "delays", "fo_idx", "valid", "phasors", "despread"]:
        va = np.concatenate([np.asarray(getattr(o, field))[None]
                             for o in outs_a])
        vb = np.concatenate([np.asarray(getattr(o, field)) for o in outs_b])
        np.testing.assert_array_equal(va, vb, err_msg=field)
    assert int(a.state.base) == int(b.state.base)


def test_push_many_tracker_and_single_lock(faded):
    """push_many parity for the remaining two receivers (TrackerStreamingRx,
    single-lock StreamingRx)."""
    bits, rx = faded
    chunk = 960
    n = (len(rx) // chunk) * chunk
    chunks = np.asarray(rx[:n], np.complex64).reshape(-1, chunk)

    a = stream_rt.TrackerStreamingRx(CFG, chunk)
    b = stream_rt.TrackerStreamingRx(CFG, chunk)
    outs_a = [a.push(c) for c in chunks[:9]]
    outs_b = [b.push_many(chunks[:9][i: i + 3]) for i in range(0, 9, 3)]
    for field in ["ptrs", "valid", "phasors", "hard_bits"]:
        va = np.stack([np.asarray(getattr(o, field)) for o in outs_a])
        vb = np.concatenate([np.asarray(getattr(o, field)) for o in outs_b])
        np.testing.assert_array_equal(va, vb, err_msg=field)
    assert int(a.state.base) == int(b.state.base)

    a = stream_rt.StreamingRx(CFG, chunk)
    b = stream_rt.StreamingRx(CFG, chunk)
    outs_a = [a.push(c) for c in chunks[:8]]
    outs_b = [b.push_many(chunks[:8][i: i + 4]) for i in range(0, 8, 4)]
    for field in ["phasors", "block_ids", "valid"]:
        va = np.stack([np.asarray(getattr(o, field)) for o in outs_a])
        vb = np.concatenate([np.asarray(getattr(o, field)) for o in outs_b])
        np.testing.assert_array_equal(va, vb, err_msg=field)
    assert int(a.state.base) == int(b.state.base)


def test_sharded_push_many_bit_identical(faded):
    """Sharded push_many (scan over the shard_map'd chunk step) == K
    sequential sharded push() calls, bit-for-bit."""
    from lte_gnu_radio_code.parallel import mesh as meshmod
    from lte_gnu_radio_code.parallel import streaming as pstream

    bits, rx = faded
    chunk = 1920
    mesh = meshmod.time_mesh(4)
    n = (len(rx) // chunk) * chunk
    chunks = np.asarray(rx[:n], np.complex64).reshape(-1, chunk)

    a = pstream.ShardedReacqStreamingRx(CFG, chunk, mesh)
    b = pstream.ShardedReacqStreamingRx(CFG, chunk, mesh)
    outs_a = [a.push(c) for c in chunks[:8]]
    outs_b = [b.push_many(chunks[:8][i: i + 4]) for i in range(0, 8, 4)]
    for field in ["ptrs", "delays", "valid", "phasors", "hard_bits"]:
        va = np.stack([np.asarray(getattr(o, field)) for o in outs_a])
        vb = np.concatenate([np.asarray(getattr(o, field)) for o in outs_b])
        np.testing.assert_array_equal(va, vb, err_msg=field)
    assert int(a.state.base) == int(b.state.base)


def test_batch_streaming_equals_independent_streams():
    """BatchReacqStreamingRx (B vmapped streams, one dispatch) must equal B
    independent ReacqStreamingRx runs bit-for-bit — including push_many's
    [K, B] composition."""
    cfg = CFG
    chunk = 960
    sigs = []
    for seed in range(3):
        bits, tx = _tx(cfg, seed + 10)
        sigs.append(golden.apply_channel(tx, golden.channel_taps("Fading")))
    n = min(len(s) for s in sigs)
    n = (n // chunk) * chunk
    streams = np.stack([np.asarray(s[:n], np.complex64) for s in sigs])
    chunks = streams.reshape(3, -1, chunk).transpose(1, 0, 2)  # [K, B, chunk]

    brx = stream_rt.BatchReacqStreamingRx(cfg, chunk, batch=3)
    outs_b = []
    outs_b.append(brx.push_many(chunks[:8]))          # [8, B, ...]
    for kc in chunks[8:]:
        outs_b.append(jax.tree.map(lambda x: x[None], brx.push(kc)))
    vb = {f: np.concatenate([np.asarray(getattr(o, f)) for o in outs_b])
          for f in ["ptrs", "delays", "valid", "phasors", "hard_bits"]}

    for b in range(3):
        rx1 = stream_rt.ReacqStreamingRx(cfg, chunk)
        outs_a = [rx1.push(c) for c in chunks[:, b]]
        for f, arr in vb.items():
            va = np.stack([np.asarray(getattr(o, f)) for o in outs_a])
            np.testing.assert_array_equal(va, arr[:, b], err_msg=f"{f}[{b}]")


def test_dft_demod_path_decisions_match_fft():
    """demod_path='dft' (bin-restricted DFT matmuls) keeps detection tables
    identical and hard bits
    bit-identical to the FFT form on the canonical noisy Fading buffer."""
    import jax.numpy as jnp
    import numpy as np

    from lte_gnu_radio_code.models import stream_rx
    from lte_gnu_radio_code.reference_cpu import golden as G
    from lte_gnu_radio_code.utils.params import GOLDEN64

    cfg = GOLDEN64
    rng = np.random.default_rng(11)
    bits = rng.integers(0, 2, cfg.num_bits)
    tx = G.tx_frame(cfg, bits)
    rx = G.apply_channel(tx, G.channel_taps("Fading"), max_impulse=cfg.nfft)
    rx = G.awgn(cfg, rx, rng, np.var(tx)).astype(np.complex64)
    r1 = stream_rx.make_rx_detections(cfg, len(rx))(jnp.asarray(rx))
    r2 = stream_rx.make_rx_detections(cfg, len(rx), demod_path="dft")(
        jnp.asarray(rx))
    assert int(r1.count) == int(r2.count) > 0
    v = np.asarray(r1.valid)
    np.testing.assert_array_equal(np.asarray(r1.ptrs)[v],
                                  np.asarray(r2.ptrs)[v])
    np.testing.assert_array_equal(np.asarray(r1.hard_bits)[v],
                                  np.asarray(r2.hard_bits)[v])
    np.testing.assert_allclose(np.asarray(r2.phasors)[v],
                               np.asarray(r1.phasors)[v], atol=1e-4)
