#!/usr/bin/env python
"""Smoke test of the device path on one GPU — or, with --four-cards, of the
time-sharded path on four.

    python chip_smoke.py [--seed N]
    python chip_smoke.py --four-cards [--seed N]

Runs named phases in order; the first that fails ends the script with a
nonzero exit (nothing is caught).  Every buffer is made here from --seed, by
the NumPy oracle (reference_cpu/) or by the chain's own PRNG.

One card, the default:
  device        JAX's backend must be the GPU; prints the device kind and
                the card's name and power limit (nvidia-smi).
  chain         bits -> TX -> Fading -> AWGN -> sync search -> lock and
                channel estimate -> MMSE EQ -> LLR/hard bits through
                models/chain.py at LTE2048, LTE1024 and GOLDEN64, batch 32:
                summed BER 0 and every frame locked; compile time and one
                steady-state Msamples/s.
  rx_vs_oracle  the GPU RX on oracle-made TX + Fading + AWGN buffers against
                golden.rx_frame/bit_recovery: lock pointer, delay hypothesis
                and hard bits identical; phasors and the GPU TX frame within
                the tolerances stated below.
  stream        chunked continuous re-acquisition (runtime/stream) over a
                few dozen chunks of a multi-frame capture == whole-buffer
                stream_rx.make_rx_detections: pointers, delays, hard bits.
  generations   CFO search, DSSS, lstsq tracker, PLS key exchange and 2x2
                MIMO, each once at the shape its test uses, against its
                oracle with identical decisions.

--four-cards runs only: the sharded chain (parallel/chain.py) on (dp, t)
meshes (1, 4), (2, 2), (4, 1) at LTE2048; sharded RX == single-device RX at
all three numerologies; sharded streaming == single-device batch detections.

The last line printed is {"ok": true, "device": {"platform", "kind",
"count"}}; everything else goes on earlier lines.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax
import jax.numpy as jnp

from lte_gnu_radio_code.models import chain, rxofdm, stream_rx, txofdm
from lte_gnu_radio_code.reference_cpu import golden as G
from lte_gnu_radio_code.runtime import stream as stream_rt
from lte_gnu_radio_code.utils.device import (card_info, require_gpu,
                                             use_compile_cache)
from lte_gnu_radio_code.utils.params import (GOLDEN64, LTE1024, LTE2048,
                                             OFDMConfig)

CHAIN_CONFIGS = {"LTE2048": LTE2048, "LTE1024": LTE1024, "GOLDEN64": GOLDEN64}
CHAIN_BATCH = 32

# Tolerances of the JAX path (float32, complex64) against the float64 NumPy
# oracle.  The FFTs run in float32; every float32 contraction on the RX/TX
# path is at Precision.HIGHEST (sync_correlate's einsum, the conv-bank and
# channel convolutions, the DFT matmuls), so no TF32 rounding enters.
#   TX frame: unit-power samples through one float32 IFFT and normalisation
#   per symbol — per-sample error ~1e-6, held to TX_ATOL.
#   Equalised phasors: float32 FFT + power normalisation + MMSE gain on
#   unit-magnitude points — error ~1e-6, held to PHASOR_ATOL; hard bits and
#   lock decisions must be identical.
#   DSSS despread symbols: the legacy receiver's tolerance from its test.
TX_ATOL = 2e-5
PHASOR_ATOL = 1e-4
DSSS_ATOL = 2e-3


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def phase(name: str, fn, *args, **kwargs):
    print(f"[{name}] start", flush=True)
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    print(f"[{name}] ok ({time.perf_counter() - t0:.1f} s)", flush=True)
    return out


def oracle_buffer(cfg: OFDMConfig, rng: np.random.Generator,
                  n_frames: int = 1):
    """(bits [n_frames, num_bits], tx frames, rx capture): oracle TX of
    n_frames frames back to back, through Fading and AWGN at cfg.snr_db."""
    bits = rng.integers(0, 2, (n_frames, cfg.num_bits))
    tx = np.concatenate([G.tx_frame(cfg, b) for b in bits])
    rx = G.apply_channel(tx, G.channel_taps("Fading"), max_impulse=cfg.nfft)
    rx = G.awgn(cfg, rx, rng, np.var(tx))
    return bits, tx, rx


# ---------------------------------------------------------------------------
# one card
# ---------------------------------------------------------------------------


def phase_device(min_count: int = 1) -> tuple[dict, list[str]]:
    """(device as JAX reports it, nvidia-smi's name/power-limit lines)."""
    device = require_gpu()
    check(device["count"] >= min_count,
          f"{device['count']} GPUs visible, need {min_count}")
    print(f"device: platform={device['platform']} kind={device['kind']} "
          f"count={device['count']}")
    cards = card_info()
    for line in cards:
        print(line)
    return device, cards


def phase_chain(cfg: OFDMConfig, batch: int = CHAIN_BATCH, reps: int = 5,
                seed: int = 0, card: str = "") -> dict:
    """The batched verified chain: BER 0 and every frame locked."""
    frame = chain.chain_fn(cfg)

    @jax.jit
    def run(bits, seeds):
        keys = jax.vmap(jax.random.fold_in, (None, 0))(
            jax.random.PRNGKey(seed), seeds)
        r = jax.vmap(frame)(bits, keys)
        return jnp.sum(r.ber), jnp.sum(r.found.astype(jnp.int32))

    bits = jnp.asarray(np.random.default_rng(seed).integers(
        0, 2, (batch, cfg.num_bits), dtype=np.int32))
    seeds = jnp.arange(batch, dtype=jnp.int32)
    t0 = time.perf_counter()
    compiled = run.lower(bits, seeds).compile()
    compile_s = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        ber_sum, locks = (v.item() for v in compiled(bits, seeds))
        times.append(time.perf_counter() - t0)
        check(locks == batch, f"chain: {locks}/{batch} frames locked")
        check(ber_sum == 0.0, f"chain: summed BER {ber_sum} != 0")
    n_samples = cfg.frame_len + cfg.nfft - 1
    msps = batch * n_samples / float(np.median(times)) / 1e6
    print(f"chain nfft={cfg.nfft} symbols={cfg.num_ofdm_symb} batch={batch}: "
          f"BER 0, {locks}/{batch} locked, compile {compile_s:.2f} s, "
          f"steady state {msps:.1f} Msamples/s [{card}]", flush=True)
    return {"compile_s": compile_s, "msps": msps, "locks": locks,
            "ber_sum": ber_sum}


def phase_rx_vs_oracle(cfg: OFDMConfig, seed: int = 0) -> dict:
    """GPU TX and RX against the NumPy oracle on one oracle-made buffer."""
    rng = np.random.default_rng(seed)
    bits, tx_o, rx = oracle_buffer(cfg, rng)
    bits = bits[0]

    tx_j = np.asarray(txofdm.make_tx(cfg)(jnp.asarray(bits, jnp.int32)))
    tx_err = float(np.abs(tx_j - tx_o).max())
    check(tx_err <= TX_ATOL, f"TX frame off the oracle by {tx_err}")

    r = rxofdm.make_rx(cfg, len(rx))(jnp.asarray(rx, jnp.complex64))
    ph_o, tsr, _ = G.rx_frame(cfg, rx)
    hard_o, _, _ = G.bit_recovery(ph_o)
    check(bool(r.found), "RX found no lock")
    check(int(r.lock_ptr) == int(tsr[0]),
          f"lock_ptr {int(r.lock_ptr)} != oracle {int(tsr[0])}")
    check(int(r.delay_idx) == int(tsr[1]),
          f"delay_idx {int(r.delay_idx)} != oracle {int(tsr[1])}")
    hard_j = np.asarray(r.hard_bits)
    m = min(len(hard_j), len(hard_o))
    n_diff = int((hard_j[:m] != hard_o[:m]).sum())
    check(n_diff == 0, f"{n_diff} of {m} hard bits differ from the oracle")
    ph_j = np.asarray(r.phasors)
    rows = min(len(ph_j), len(ph_o))
    ph_err = float(np.abs(ph_j[:rows] - ph_o[:rows]).max())
    check(ph_err <= PHASOR_ATOL, f"phasors off the oracle by {ph_err}")
    print(f"rx_vs_oracle nfft={cfg.nfft} symbols={cfg.num_ofdm_symb}: "
          f"lock {int(r.lock_ptr)}, delay {int(r.delay_idx)}, {m} hard bits "
          f"identical; max |phasor err| {ph_err:.2e} (<= {PHASOR_ATOL}), "
          f"max |TX err| {tx_err:.2e} (<= {TX_ATOL})", flush=True)
    return {"tx_err": tx_err, "phasor_err": ph_err, "bits": m}


def _collect(outs):
    valid = [np.asarray(o.valid) for o in outs]
    return tuple(np.concatenate([np.asarray(getattr(o, f))[v]
                                 for o, v in zip(outs, valid)])
                 for f in ("ptrs", "delays", "hard_bits"))


def _stream_vs_batch(cfg, rx, batch, srx, chunk_len, label):
    """Push rx chunk by chunk through srx and require its detections to
    equal the whole-buffer batch detections exactly."""
    nb = int(batch.count)
    check(nb > 0, f"{label}: no detections in the batch reference")
    buf = np.zeros(-(-len(rx) // chunk_len) * chunk_len, np.complex64)
    buf[: len(rx)] = rx
    outs = [srx.push(buf[i: i + chunk_len],
                     n_real=max(0, min(chunk_len, len(rx) - i)))
            for i in range(0, len(buf), chunk_len)]
    outs.extend(srx.finish())
    ptrs, delays, hard = _collect(outs)
    b_ptrs = np.asarray(batch.ptrs[:nb])
    keep = ptrs <= int(b_ptrs.max())
    check(np.array_equal(ptrs[keep], b_ptrs),
          f"{label}: detection pointers differ")
    check(np.array_equal(delays[keep], np.asarray(batch.delays[:nb])),
          f"{label}: delays differ")
    check(np.array_equal(hard[keep], np.asarray(batch.hard_bits[:nb])),
          f"{label}: hard bits differ")
    print(f"{label}: {len(outs)} chunks of {chunk_len}, {nb} detections, "
          f"{hard[keep].size} hard bits: exact", flush=True)
    return nb


def phase_stream(cfg: OFDMConfig, n_frames: int = 3, n_chunks: int = 30,
                 seed: int = 0) -> int:
    """Chunked re-acquisition == whole-buffer detections on one capture."""
    _, _, rx = oracle_buffer(cfg, np.random.default_rng(seed), n_frames)
    rx = rx.astype(np.complex64)
    stride = max(1, cfg.stride)
    chunk_len = -(-len(rx) // (n_chunks * stride)) * stride
    max_det = n_frames * cfg.num_patterns + 4
    batch = stream_rx.make_rx_detections(cfg, len(rx), max_det=max_det)(
        jnp.asarray(rx))
    srx = stream_rt.ReacqStreamingRx(cfg, chunk_len)
    return _stream_vs_batch(cfg, rx, batch, srx, chunk_len,
                            f"stream nfft={cfg.nfft} frames={n_frames}")


# ---- legacy generations, each at its test's shape -------------------------


def _legacy_buffer(cfg, seed=0, cfo_hz=0.0, snr_db=60.0):
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


def gen_cfo(seed: int = 0) -> str:
    """CFO search (SynchEstAndFO) with an injected +1500 Hz offset."""
    from lte_gnu_radio_code.models import legacy_rx
    from lte_gnu_radio_code.reference_cpu import legacy as L
    from lte_gnu_radio_code.utils.params import CFO_CASES, config_from_case
    cfg = config_from_case(CFO_CASES, 0, snr_db=1e8)
    _, rx = _legacy_buffer(cfg, seed=seed, cfo_hz=1500.0)
    fo_range = (0.0, -1500.0, 1500.0)
    o = L.rx_frame_cfo(cfg, rx, fo_range=fo_range, max_det=24)
    r = legacy_rx.make_legacy_rx(cfg, len(rx), fo_range=fo_range,
                                 max_det=24)(jnp.asarray(rx, jnp.complex64))
    n = int(o["n_det"])
    check(n > 0 and int(r.count) == n, f"cfo: {int(r.count)} detections, "
          f"oracle {n}")
    tsr = o["time_synch_ref"][:n]
    for name, got, col in (("ptrs", r.ptrs, 0), ("delays", r.delays, 1),
                           ("fo_idx", r.fo_idx, 3)):
        check(np.array_equal(np.asarray(got[:n]), tsr[:, col].astype(int)),
              f"cfo: {name} differ from the oracle")
    check(bool(np.all(np.asarray(r.fo_idx[:n]) == 1)),
          "cfo: the -1500 Hz corrector did not win every detection")
    return f"cfo: {n} detections, pointers/delays/fo winners identical"


def gen_dsss(seed: int = 1) -> str:
    """DSSS despreading (SynchEstFOAndDSSS), case 4."""
    from lte_gnu_radio_code.models import legacy_rx
    from lte_gnu_radio_code.reference_cpu import legacy as L
    from lte_gnu_radio_code.utils.params import DSSS_CASES, config_from_case
    cfg = config_from_case(DSSS_CASES, 4, snr_db=1e8)
    dsss = DSSS_CASES[4]["dsss"]
    _, rx = _legacy_buffer(cfg, seed=seed)
    o = L.rx_frame_cfo(cfg, rx, dsss=dsss, max_det=24)
    r = legacy_rx.make_legacy_rx(cfg, len(rx), dsss=dsss, max_det=24)(
        jnp.asarray(rx, jnp.complex64))
    n = int(o["n_det"])
    check(n > 0 and int(r.count) == n, f"dsss: {int(r.count)} detections, "
          f"oracle {n}")
    d_j, d_o = np.asarray(r.despread[:n]), o["despread"][:n]
    check(np.array_equal(d_j.real > 0, d_o.real > 0) and
          np.array_equal(d_j.imag > 0, d_o.imag > 0),
          "dsss: despread decisions differ from the oracle")
    err = float(np.abs(d_j - d_o).max())
    check(err <= DSSS_ATOL, f"dsss: despread off the oracle by {err}")
    return f"dsss: {n} detections, {d_j.size} despread decisions identical"


def gen_tracker(seed: int = 0) -> str:
    """The lstsq tracking synchroniser against its oracle."""
    from lte_gnu_radio_code.models import tracker as M
    from lte_gnu_radio_code.reference_cpu import tracker as T
    cfg = GOLDEN64
    bits, rx = _legacy_buffer(cfg, seed=seed, snr_db=80.0)
    tr = T.track_synch(cfg, rx)
    n = tr["n_det"]
    r = M.make_tracker(cfg, len(rx))(jnp.asarray(rx, jnp.complex64))
    check(int(r.count) == n, f"tracker: {int(r.count)} detections, "
          f"oracle {n}")
    res_j = np.asarray(r.ptrs[:n]) + np.asarray(r.delays[:n])
    res_o = (tr["time_synch_ref"][:n, 0] +
             tr["time_synch_ref"][:n, 1]).astype(int)
    check(np.array_equal(res_j, res_o), "tracker: symbol boundaries differ")
    hard_j = np.asarray(r.hard_bits)
    hard_o, _, _ = G.bit_recovery(T.data_demod(cfg, rx, tr,
                                               fix_rotation=True))
    m = min(len(hard_j), len(hard_o))
    check(np.array_equal(hard_j[:m], hard_o[:m]),
          "tracker: hard bits differ from the oracle")
    check(not np.any(hard_j[:len(bits)] != bits),
          "tracker: nonzero BER against the transmitted bits")
    return f"tracker: {n} detections, boundaries and {m} hard bits identical"


def gen_pls(seed: int = 9) -> str:
    """PLS key exchange against the oracle protocol, and through a real
    timing lock at a delay beyond the CP."""
    from lte_gnu_radio_code.models import pls as M
    from lte_gnu_radio_code.reference_cpu import pls as P
    from lte_gnu_radio_code.utils.params import PLSConfig
    cfg = PLSConfig()
    key = np.array([0, 0, 0, 1, 1, 0, 1, 1])
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((2, 2, 1)) + 1j * rng.standard_normal((2, 2, 1))
    h[1, 0] = h[0, 1]
    bits_o, err_o = P.key_exchange(cfg, key, np.random.default_rng(4), h=h)
    bits_j, err_j = M.key_exchange(cfg, jnp.asarray(key),
                                   jax.random.PRNGKey(2), h=h)
    check(err_o == 0 and int(err_j) == 0,
          f"pls: key errors oracle {err_o}, device {int(err_j)}")
    check(np.array_equal(np.asarray(bits_j), bits_o),
          "pls: recovered key differs from the oracle's")
    nbits = cfg.num_data_symb * cfg.num_subbands * cfg.bit_codebook
    key_bits = jnp.asarray(np.random.default_rng(0).integers(0, 2, nbits),
                           jnp.int32)
    d = 40                                  # > cp_len (16)
    hd = np.zeros((2, 2, d + 1), complex)
    hd[:, :, d] = np.array([[1.0 + 0.2j, 0.45j], [0.3 - 0.1j, 0.9 + 0.3j]])
    _, err, (pb, pa) = M.key_exchange_synced(
        cfg, key_bits, jax.random.PRNGKey(1), hd, max_delay=64)
    check(int(err) == 0 and int(pb) == d and int(pa) == d,
          f"pls synced: {int(err)} key errors, locks {int(pb)}/{int(pa)} "
          f"(want {d})")
    return (f"pls: key identical to the oracle's; synced exchange locked at "
            f"delay {d} on both ends, 0 of {nbits} key bits wrong")


def gen_mimo(seed: int = 0) -> str:
    """2x2 spatial multiplexing.  The reference never implemented it, so the
    transmitted bits are its oracle."""
    from lte_gnu_radio_code.models import mimo
    cfg = OFDMConfig(synch_dat=(2, 2), num_ofdm_symb=48, num_ant_txrx=2,
                     snr_db=100.0).validate()
    bits = jnp.asarray(np.random.default_rng(seed).integers(
        0, 2, (2, cfg.num_bits), dtype=np.int32))
    ber, found, lock = mimo.make_mimo_chain(cfg, channel="Fading")(
        bits, jnp.int32(0))
    check(bool(found) and int(lock) == cfg.cp_len,
          f"mimo: lock {int(lock)} (want {cfg.cp_len}), found {bool(found)}")
    check(float(np.asarray(ber).max()) == 0.0,
          f"mimo: BER {np.asarray(ber).tolist()}")
    return f"mimo: 2 streams x {cfg.num_bits} bits, BER 0, lock {int(lock)}"


GENERATIONS = {"cfo": gen_cfo, "dsss": gen_dsss, "tracker": gen_tracker,
               "pls": gen_pls, "mimo": gen_mimo}


def phase_generations() -> None:
    for fn in GENERATIONS.values():
        print(fn(), flush=True)


# ---------------------------------------------------------------------------
# four cards
# ---------------------------------------------------------------------------


def _sharding(name, a) -> None:
    devs = sorted(d.id for d in a.sharding.device_set)
    print(f"  {name}: shape {tuple(a.shape)} sharding {a.sharding} "
          f"on devices {devs}", flush=True)


def sharded_chain(cfg: OFDMConfig, dp: int, t: int, batch: int,
                  seed: int = 0) -> None:
    """parallel/chain.make_sharded_chain on a (dp, t) mesh: BER 0, every
    frame locked."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from lte_gnu_radio_code.parallel import chain as pchain
    from lte_gnu_radio_code.parallel import mesh as meshmod
    mesh = meshmod.make_mesh(dp * t, dp=dp, axis_names=("dp", "t"))
    step = pchain.make_sharded_chain(cfg, mesh)
    bits = jax.device_put(
        jnp.asarray(np.random.default_rng(seed).integers(
            0, 2, (batch, cfg.num_bits)), jnp.int32),
        NamedSharding(mesh, P("dp", None)))
    seeds = jax.device_put(jnp.arange(batch, dtype=jnp.int32),
                           NamedSharding(mesh, P("dp")))
    ber, found, lock = jax.block_until_ready(step(bits, seeds))
    print(f"sharded chain mesh (dp={dp}, t={t}), nfft={cfg.nfft}, "
          f"{cfg.frame_len // t} samples per time shard, batch {batch}:",
          flush=True)
    for name, a in (("bits", bits), ("ber", ber), ("found", found),
                    ("lock", lock)):
        _sharding(name, a)
    check(bool(np.asarray(found).all()), f"(dp={dp}, t={t}): lock failed")
    check(float(np.asarray(ber).max()) == 0.0,
          f"(dp={dp}, t={t}): BER {np.asarray(ber).tolist()}")
    print(f"  BER 0 on all {batch} frames, all locked", flush=True)


def sharded_rx_vs_single(cfg: OFDMConfig, t: int, seed: int = 0) -> None:
    """sharded.make_sharded_rx == single-device make_rx, bit for bit."""
    from lte_gnu_radio_code.parallel import mesh as meshmod
    from lte_gnu_radio_code.parallel import sharded
    _, _, rx = oracle_buffer(cfg, np.random.default_rng(seed))
    x = jnp.asarray(rx, jnp.complex64)
    r1 = rxofdm.make_rx(cfg, len(rx))(x)
    mesh = meshmod.time_mesh(t)
    rs = sharded.make_sharded_rx(cfg, len(rx), mesh)(x)
    n_pad = sharded.padded_len(cfg, len(rx), t)
    print(f"sharded RX nfft={cfg.nfft}, t={t}: {n_pad // t} samples per "
          f"time shard (halo {sharded.halo_size(cfg)})", flush=True)
    _sharding("phasors", rs.phasors)
    _sharding("hard_bits", rs.hard_bits)
    check(bool(r1.found) and bool(rs.found), "lock failed")
    check(int(rs.lock_ptr) == int(r1.lock_ptr),
          f"lock {int(rs.lock_ptr)} != single {int(r1.lock_ptr)}")
    check(int(rs.delay_idx) == int(r1.delay_idx),
          f"delay {int(rs.delay_idx)} != single {int(r1.delay_idx)}")
    h1, hs = np.asarray(r1.hard_bits), np.asarray(rs.hard_bits)
    check(h1.shape == hs.shape and np.array_equal(h1, hs),
          "sharded hard bits differ from single-device")
    print(f"  == single device: lock {int(r1.lock_ptr)}, delay "
          f"{int(r1.delay_idx)}, {h1.size} hard bits identical", flush=True)


def sharded_stream_vs_batch(cfg: OFDMConfig, t: int, n_frames: int = 2,
                            seed: int = 5) -> None:
    """parallel/streaming.ShardedReacqStreamingRx == single-device batch
    detections on one capture."""
    from lte_gnu_radio_code.parallel import mesh as meshmod
    from lte_gnu_radio_code.parallel import streaming as pstream
    _, _, rx = oracle_buffer(cfg, np.random.default_rng(seed), n_frames)
    rx = rx.astype(np.complex64)
    batch = stream_rx.make_rx_detections(
        cfg, len(rx), max_det=n_frames * cfg.num_patterns + 4)(
        jnp.asarray(rx))
    unit = t * max(1, cfg.stride)
    chunk_len = -(-max(stream_rt.reacq_lag(cfg) * t, 2048) // unit) * unit
    srx = pstream.ShardedReacqStreamingRx(cfg, chunk_len, meshmod.time_mesh(t))
    _stream_vs_batch(cfg, rx, batch, srx, chunk_len,
                     f"sharded stream nfft={cfg.nfft} t={t}")
    print(f"  chunk step state sharding: {srx.state.hist.sharding}",
          flush=True)


def four_cards(n: int = 4, seed: int = 0) -> None:
    for dp, t in ((1, n), (2, n // 2), (n, 1)):
        phase(f"sharded_chain_{dp}x{t}", sharded_chain, LTE2048, dp, t,
              batch=2 * n, seed=seed)
    for name, cfg in (("GOLDEN64", GOLDEN64), ("LTE1024", LTE1024),
                      ("LTE2048", LTE2048)):
        phase(f"sharded_rx_{name}", sharded_rx_vs_single, cfg, n, seed=seed)
    for name, cfg in (("GOLDEN64", GOLDEN64), ("LTE1024", LTE1024)):
        phase(f"sharded_stream_{name}", sharded_stream_vs_batch, cfg, n,
              seed=seed + 5)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the time-sharded checks on four GPUs")
    args = ap.parse_args(argv)

    n_cards = 4 if args.four_cards else 1
    cache_dir = use_compile_cache()
    device, cards = phase("device", phase_device, n_cards)
    print(f"compile cache: {cache_dir}", flush=True)
    card = "; ".join(cards)

    if args.four_cards:
        four_cards(n_cards, seed=args.seed)
    else:
        for name, cfg in CHAIN_CONFIGS.items():
            phase(f"chain_{name}", phase_chain, cfg, seed=args.seed,
                  card=card)
        for name, cfg in CHAIN_CONFIGS.items():
            phase(f"rx_vs_oracle_{name}", phase_rx_vs_oracle, cfg,
                  seed=args.seed)
        for name, cfg in (("GOLDEN64", GOLDEN64), ("LTE1024", LTE1024),
                          ("LTE2048", LTE2048)):
            phase(f"stream_{name}", phase_stream, cfg, seed=args.seed)
        phase("generations", phase_generations)

    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
