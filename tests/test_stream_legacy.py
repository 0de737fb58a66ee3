"""Streaming legacy CFO/DSSS receiver (R4/R5 continuous work() semantics):
chunked stream == whole-buffer batch bit-for-bit, CFO recovery mid-stream,
DSSS despread in streaming mode, checkpoint/resume."""

import numpy as np
import pytest

import jax.numpy as jnp

from lte_gnu_radio_code.models import legacy_rx
from lte_gnu_radio_code.reference_cpu import golden as G
from lte_gnu_radio_code.runtime import stream as stream_rt
from lte_gnu_radio_code.utils.params import (
    CFO_CASES, DSSS_CASES, config_from_case)


def _capture(cfg, seed=0, cfo_hz=0.0, n_frames=1):
    """n_frames replayed TX frames through the Fading channel (+ optional
    CFO), the D4/D6 continuous-stream pattern."""
    rng = np.random.default_rng(seed)
    frames = []
    for _ in range(n_frames):
        bits = rng.integers(0, 2, cfg.num_bits)
        frames.append(G.apply_channel(G.tx_frame(cfg, bits),
                                      G.channel_taps("Fading"),
                                      max_impulse=cfg.nfft))
    sig = np.concatenate(frames)
    if cfo_hz:
        sig = sig * np.exp(1j * 2 * np.pi * cfo_hz / cfg.fs *
                           np.arange(len(sig)))
    return sig


def _drain(srx, sig, chunk):
    buf = np.zeros(-(-len(sig) // chunk) * chunk, np.complex64)
    buf[: len(sig)] = sig
    outs = [srx.push(buf[i: i + chunk],
                     n_real=max(0, min(chunk, len(sig) - i)))
            for i in range(0, len(buf), chunk)]
    outs.extend(srx.finish())
    valid = [np.asarray(o.valid) for o in outs]
    cat = lambda f: np.concatenate(
        [np.asarray(f(o))[v] for o, v in zip(outs, valid)])
    return (cat(lambda o: o.ptrs), cat(lambda o: o.delays),
            cat(lambda o: o.fo_idx), cat(lambda o: o.phasors),
            cat(lambda o: o.despread), cat(lambda o: o.demod_ok))


@pytest.mark.parametrize("chunks_of_stride", [40, 96])
def test_legacy_stream_equals_batch_cfo(chunks_of_stride):
    """Chunked CFO-search stream == batch rx_frame_cfo on the same capture,
    detection-for-detection (ptr, delay, fo index, phasors)."""
    cfg = config_from_case(CFO_CASES, 0, snr_db=1e8)
    sig = _capture(cfg, seed=0, cfo_hz=1500.0, n_frames=2)
    fo_range = (0.0, -1500.0, 1500.0)

    batch = legacy_rx.make_legacy_rx(cfg, len(sig), fo_range=fo_range,
                                     max_det=48)(jnp.asarray(sig,
                                                             jnp.complex64))
    nb = int(batch.count)
    assert nb > 0

    chunk = max(1, cfg.stride) * chunks_of_stride
    srx = stream_rt.LegacyStreamingRx(cfg, chunk, fo_range=fo_range)
    ptrs, delays, fo_idx, ph, _, ok = _drain(srx, sig, chunk)

    # compare on the batch's evaluated trial range (the stream also probes
    # flush-region trials the batch never evaluates)
    keep = ptrs <= int(np.asarray(batch.ptrs[:nb]).max())
    np.testing.assert_array_equal(ptrs[keep], np.asarray(batch.ptrs[:nb]))
    np.testing.assert_array_equal(delays[keep], np.asarray(batch.delays[:nb]))
    np.testing.assert_array_equal(fo_idx[keep], np.asarray(batch.fo_idx[:nb]))
    assert ok[keep].all()
    np.testing.assert_allclose(ph[keep], np.asarray(batch.phasors[:nb]),
                               atol=2e-5)
    # the -1500 Hz corrector (index 1) must win on every real detection
    assert np.all(fo_idx[keep] == 1)


def test_legacy_stream_dsss_equals_batch():
    cfg = config_from_case(DSSS_CASES, 4, snr_db=1e8)
    dsss = DSSS_CASES[4]["dsss"]
    sig = _capture(cfg, seed=1, n_frames=2)

    batch = legacy_rx.make_legacy_rx(cfg, len(sig), dsss=dsss, max_det=48)(
        jnp.asarray(sig, jnp.complex64))
    nb = int(batch.count)
    assert nb > 0

    chunk = max(1, cfg.stride) * 64
    srx = stream_rt.LegacyStreamingRx(cfg, chunk, dsss=dsss)
    ptrs, _, _, _, despread, ok = _drain(srx, sig, chunk)
    keep = ptrs <= int(np.asarray(batch.ptrs[:nb]).max())
    np.testing.assert_array_equal(ptrs[keep], np.asarray(batch.ptrs[:nb]))
    assert ok[keep].all()
    np.testing.assert_allclose(despread[keep],
                               np.asarray(batch.despread[:nb]), atol=2e-5)


def test_legacy_stream_checkpoint_resume(tmp_path):
    cfg = config_from_case(CFO_CASES, 0, snr_db=1e8)
    sig = _capture(cfg, seed=2, n_frames=2)
    chunk = max(1, cfg.stride) * 40
    buf = np.zeros(-(-len(sig) // chunk) * chunk, np.complex64)
    buf[: len(sig)] = sig
    chunks = [buf[i: i + chunk] for i in range(0, len(buf), chunk)]
    n_reals = [max(0, min(chunk, len(sig) - i))
               for i in range(0, len(buf), chunk)]

    a = stream_rt.LegacyStreamingRx(cfg, chunk)
    full = [a.push(c, n) for c, n in zip(chunks, n_reals)] + a.finish()

    b = stream_rt.LegacyStreamingRx(cfg, chunk)
    for c, n in zip(chunks[:5], n_reals[:5]):
        b.push(c, n)
    b.save_state(tmp_path / "st.npz")
    c2 = stream_rt.LegacyStreamingRx(cfg, chunk)
    c2.load_state(tmp_path / "st.npz")
    resumed = [c2.push(c, n)
               for c, n in zip(chunks[5:], n_reals[5:])] + c2.finish()

    f_ph = np.concatenate([np.asarray(o.phasors)[np.asarray(o.valid)]
                           for o in full[5:]])
    r_ph = np.concatenate([np.asarray(o.phasors)[np.asarray(o.valid)]
                           for o in resumed])
    np.testing.assert_array_equal(f_ph, r_ph)


@pytest.mark.parametrize("n_shards", [2, 4])
def test_sharded_legacy_streaming_equals_batch(n_shards):
    """Chunked AND time-sharded CFO-search stream == single-device batch,
    detection-for-detection — the sequence-scaling composition extended to
    the legacy receiver family."""
    from lte_gnu_radio_code.parallel import mesh as meshmod
    from lte_gnu_radio_code.parallel.streaming import (
        ShardedLegacyStreamingRx)

    cfg = config_from_case(CFO_CASES, 0, snr_db=1e8)
    sig = _capture(cfg, seed=0, cfo_hz=1500.0, n_frames=2)
    fo_range = (0.0, -1500.0, 1500.0)
    batch = legacy_rx.make_legacy_rx(cfg, len(sig), fo_range=fo_range,
                                     max_det=48)(jnp.asarray(sig,
                                                             jnp.complex64))
    nb = int(batch.count)

    stride = max(1, cfg.stride)
    chunk = n_shards * stride * 24
    mesh = meshmod.time_mesh(n_shards)
    srx = ShardedLegacyStreamingRx(cfg, chunk, mesh, fo_range=fo_range)
    ptrs, delays, fo_idx, ph, _, ok = _drain(srx, sig, chunk)

    keep = ptrs <= int(np.asarray(batch.ptrs[:nb]).max())
    np.testing.assert_array_equal(ptrs[keep], np.asarray(batch.ptrs[:nb]))
    np.testing.assert_array_equal(delays[keep], np.asarray(batch.delays[:nb]))
    np.testing.assert_array_equal(fo_idx[keep], np.asarray(batch.fo_idx[:nb]))
    assert ok[keep].all()
    np.testing.assert_allclose(ph[keep], np.asarray(batch.phasors[:nb]),
                               atol=2e-5)
