#!/usr/bin/env python
"""Verified throughput rows for the non-flagship receiver generations on one
GPU: legacy CFO search (R4, hardware case 7), DSSS despread
(R5), the MATLAB-heritage tracker (R6), and the PLS key exchange (P1).

Method: identical to bench.py — R iterations of the full receiver fold into
ONE dispatch (lax.scan with a data-dependent
accumulator), and the dispatch's only outputs are small real scalars whose
device->host fetch is both the completion barrier and the correctness
verification:

  cfo     — every detection's winning CFO index must be the injected
            offset's corrector, count must equal the host oracle's
            (reference_cpu/legacy.py) detection count.
  dsss    — detection count must match the oracle AND the despread symbol
            hard decisions must equal the oracle's (compared on device
            against the embedded oracle signs).
  tracker — detection count must equal num_patterns (the tracker locked
            and tracked every frame block) and the demodulated hard bits
            must equal the transmitted bits (BER 0 on device).
  pls     — every exchange's recovered key must equal the sent key (0 bit
            errors) and both ends' ZC timing locks must recover the exact
            propagation delay (> CP — the scenario the reference's
            perfect-timing PLS cannot run at all).

Usage:
  bench_generations.py driver [R]      # all four, one subprocess each
  bench_generations.py <gen> [R]       # one generation, one process
Generations: cfo dsss tracker pls

Each row names the card; a generation run exits nonzero unless JAX's
backend is the GPU.  The parent process of the all-generations run never
touches the device.

Reference anchors: SynchEstAndFO.py:247-278 (CFO search),
SynchEstFOAndDSSS.py:392-398 (despread), SynchronizeAndEstimate.py:230-237
(lstsq tracker), pls_aio.py:107-141 (3-state exchange).
"""

import functools
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax
import jax.numpy as jnp
from jax import lax

GENERATIONS = ["cfo", "dsss", "tracker", "pls"]
DEFAULT_R = {"cfo": 64, "dsss": 64, "tracker": 64, "pls": 256}


def _noisy_buffer(cfg, seed=0, cfo_hz=0.0, snr_db=60.0):
    from lte_gnu_radio_code.reference_cpu import golden as G
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, cfg.num_bits)
    tx = G.tx_frame(cfg, bits)
    rx = G.apply_channel(tx, G.channel_taps("Fading"), max_impulse=cfg.nfft)
    if cfo_hz:
        rx = rx * np.exp(1j * 2 * np.pi * cfo_hz / cfg.fs *
                         np.arange(len(rx)))
    nv = np.var(tx) * 10 ** (-snr_db / 10)
    rx = rx + np.sqrt(nv / 2) * (rng.standard_normal(len(rx)) +
                                 1j * rng.standard_normal(len(rx)))
    return bits, rx.astype(np.complex64)


def build(gen, r_iters):
    """Returns (jittable fn() -> [k] f32, expected [k] f32,
    samples_per_dispatch, unit, label).

    Shape mirrors bench.py's verified mode: a lax.scan of R iterations,
    each a vmapped batch of BATCH independent receivers — the scan gives
    the completion chain, the batch the parallelism (a single sequential
    receiver per iteration would measure per-op latency, not device
    throughput — the serving shape is many carriers per card)."""
    batch = int(os.environ.get("BENCH_GEN_BATCH", "8"))
    from lte_gnu_radio_code.models import legacy_rx, tracker
    from lte_gnu_radio_code.reference_cpu import legacy as L
    from lte_gnu_radio_code.utils.params import (CFO_CASES, DSSS_CASES,
                                                     GOLDEN64,
                                                     config_from_case)

    if gen == "cfo":
        # the D4 hardware-RX case (examples/top_block.py:129 runs case 7)
        cfg = config_from_case(CFO_CASES, 7, snr_db=1e8)
        fo_range = (0.0, -1500.0, 1500.0)
        _, rx = _noisy_buffer(cfg, cfo_hz=1500.0)
        o = L.rx_frame_cfo(cfg, rx, fo_range=fo_range, max_det=24)
        n_exp = int(o["n_det"])
        assert n_exp > 0
        n_trials = len(rx)  # sized by make; use sync.n_trials_for via make
        from lte_gnu_radio_code.ops import sync
        n_trials = sync.n_trials_for(cfg, len(rx))
        step = functools.partial(legacy_rx.rx_frame_cfo, cfg,
                                 n_trials=n_trials, fo_range=fo_range,
                                 max_det=24)

        rx_b = np.stack([rx] * batch)

        def fn():
            def body(acc, i):
                r = jax.vmap(step)(jnp.asarray(rx_b) * (1.0 + 0.0 * i))
                fo_ok = jnp.sum(jnp.where(
                    jnp.arange(24)[None] < r.count[:, None],
                    (r.fo_idx == 1).astype(jnp.int32), 0))
                return (acc[0] + jnp.sum(r.count), acc[1] + fo_ok), ()
            acc, _ = lax.scan(body, (jnp.int32(0), jnp.int32(0)),
                              jnp.arange(r_iters, dtype=jnp.int32))
            return jnp.stack(acc).astype(jnp.float32).reshape(2)

        expected = np.array([r_iters * batch * n_exp] * 2, np.float32)
        return fn, expected, r_iters * batch * len(rx), "Msamples/s/card", (
            f"legacy CFO-search RX (R4 case 7, NFFT {cfg.nfft}, "
            f"3-candidate fo search, injected +1500 Hz, batch {batch}; "
            f"{n_exp} detections/frame, winning corrector verified)")

    if gen == "dsss":
        case = 4
        cfg = config_from_case(DSSS_CASES, case, snr_db=1e8)
        dsss = DSSS_CASES[case]["dsss"]
        _, rx = _noisy_buffer(cfg, seed=1)
        o = L.rx_frame_cfo(cfg, rx, dsss=dsss, max_det=24)
        n_exp = int(o["n_det"])
        assert n_exp > 0
        # oracle despread hard decisions, embedded as the on-device target
        d_or = o["despread"][:n_exp]
        sign_r = (d_or.real > 0).astype(np.int32)
        sign_i = (d_or.imag > 0).astype(np.int32)
        from lte_gnu_radio_code.ops import sync
        n_trials = sync.n_trials_for(cfg, len(rx))
        step = functools.partial(legacy_rx.rx_frame_cfo, cfg,
                                 n_trials=n_trials, dsss=dsss, max_det=24)

        rx_b = np.stack([rx] * batch)

        def fn():
            def body(acc, i):
                r = jax.vmap(step)(jnp.asarray(rx_b) * (1.0 + 0.0 * i))
                d = r.despread[:, :n_exp]
                mism = (jnp.sum(((d.real > 0).astype(jnp.int32) !=
                                 sign_r[None]).astype(jnp.int32)) +
                        jnp.sum(((d.imag > 0).astype(jnp.int32) !=
                                 sign_i[None]).astype(jnp.int32)))
                return (acc[0] + jnp.sum(r.count), acc[1] + mism), ()
            acc, _ = lax.scan(body, (jnp.int32(0), jnp.int32(0)),
                              jnp.arange(r_iters, dtype=jnp.int32))
            return jnp.stack(acc).astype(jnp.float32).reshape(2)

        expected = np.array([r_iters * batch * n_exp, 0], np.float32)
        return fn, expected, r_iters * batch * len(rx), "Msamples/s/card", (
            f"legacy DSSS RX (R5 case {case}, NFFT {cfg.nfft}, spreading "
            f"{dsss}, batch {batch}; {n_exp} detections/frame, despread "
            "decisions verified vs oracle)")

    if gen == "tracker":
        cfg = GOLDEN64
        bits, rx = _noisy_buffer(cfg, snr_db=80.0)
        track = tracker.make_tracker(cfg, len(rx))
        # resolve the jitted partial's statics for in-scan use
        stride = int(np.ceil(cfg.cp_len / 2))
        total_loops = int(np.ceil(len(rx) / stride)) + 1
        max_det = cfg.num_patterns
        step = functools.partial(tracker.track_frame, cfg,
                                 total_loops=total_loops, max_det=max_det)
        bits_j = jnp.asarray(bits.astype(np.int32))

        rx_b = np.stack([rx] * batch)

        def fn():
            def body(acc, i):
                r = jax.vmap(step)(jnp.asarray(rx_b) * (1.0 + 0.0 * i))
                nb = min(r.hard_bits.shape[1], bits_j.shape[0])
                errs = jnp.sum((r.hard_bits[:, :nb] != bits_j[None, :nb])
                               .astype(jnp.int32))
                return (acc[0] + jnp.sum(r.count), acc[1] + errs), ()
            acc, _ = lax.scan(body, (jnp.int32(0), jnp.int32(0)),
                              jnp.arange(r_iters, dtype=jnp.int32))
            return jnp.stack(acc).astype(jnp.float32).reshape(2)

        expected = np.array([r_iters * batch * cfg.num_patterns, 0],
                            np.float32)
        return fn, expected, r_iters * batch * len(rx), "Msamples/s/card", (
            f"lstsq-tracking RX (R6, NFFT {cfg.nfft}, {cfg.num_patterns} "
            f"tracked blocks/frame, batch {batch}; BER 0 vs transmitted "
            "bits verified)")

    if gen == "pls":
        from lte_gnu_radio_code.models import pls as mpls
        from lte_gnu_radio_code.utils.params import PLSConfig
        cfg = PLSConfig()
        nbits = cfg.num_data_symb * cfg.num_subbands * cfg.bit_codebook
        key_bits = jnp.asarray(
            np.random.default_rng(0).integers(0, 2, nbits), jnp.int32)
        d = 40                              # delay > CP (16)
        g = np.array([[1.0 + 0.2j, 0.45j], [0.3 - 0.1j, 0.9 + 0.3j]])
        h = np.zeros((2, 2, d + 1), complex)
        h[:, :, d] = g
        max_delay = 64

        def one(key):
            _, err, (pb, pa) = mpls.key_exchange_synced(
                cfg, key_bits, key, h, max_delay=max_delay)
            return err, ((pb == d) & (pa == d)).astype(jnp.int32)

        def fn():
            def body(acc, i):
                keys = jax.vmap(jax.random.fold_in, (None, 0))(
                    jax.random.PRNGKey(1),
                    i * batch + jnp.arange(batch, dtype=jnp.int32))
                err, locks_ok = jax.vmap(one)(keys)
                return (acc[0] + jnp.sum(err),
                        acc[1] + jnp.sum(locks_ok)), ()
            acc, _ = lax.scan(body, (jnp.int32(0), jnp.int32(0)),
                              jnp.arange(r_iters, dtype=jnp.int32))
            return jnp.stack(acc).astype(jnp.float32).reshape(2)

        expected = np.array([0, r_iters * batch], np.float32)
        # "samples" = exchanges; the emit path converts to exchanges/s
        return fn, expected, r_iters * batch, "exchanges/s/card", (
            f"PLS 2x2 key exchange (P1, {nbits}-bit key, through a real ZC "
            f"timing lock at delay {d} > CP, batch {batch}; 0 key-bit "
            "errors + exact timing verified)")

    raise SystemExit(f"unknown generation {gen}")


def run_gen(gen, r_iters):
    from lte_gnu_radio_code.utils.device import (card_info, require_gpu,
                                                 use_compile_cache)
    device = require_gpu()
    card = card_info()[0]
    use_compile_cache()
    fn, expected, n_per_dispatch, unit, label = build(gen, r_iters)
    jfn = jax.jit(fn)

    t0 = time.perf_counter()
    first = np.asarray(jfn())
    first_call_s = time.perf_counter() - t0
    np.testing.assert_array_equal(first, expected)

    reps = []
    for _ in range(5):
        t0 = time.perf_counter()
        v = np.asarray(jfn())
        reps.append(time.perf_counter() - t0)
        np.testing.assert_array_equal(v, expected)
    scale = 1e6 if unit.startswith("Msamples") else 1.0
    rates = [n_per_dispatch / t / scale for t in reps]
    med = float(np.median(rates))
    print(json.dumps({
        "metric": f"verified {label}",
        "value": med,
        "unit": unit,
        "card": card,
        "device": device,
        "R": r_iters,
        "reps": len(rates),
        "spread_pct": 100 * (max(rates) - min(rates)) / med,
        "rep_rates": rates,
        "first_call_s": first_call_s,
        "verify": "ok: expected detection/lock counts and zero errors "
                  "fetched from the device every rep",
    }), flush=True)


def main():
    if len(sys.argv) < 2:
        raise SystemExit(__doc__)
    what = sys.argv[1]
    r_iters = int(sys.argv[2]) if len(sys.argv) > 2 else None
    if what == "driver":
        failed = []
        for gen in GENERATIONS:
            r = subprocess.run(
                [sys.executable, os.path.abspath(__file__), gen,
                 str(r_iters or DEFAULT_R[gen])],
                capture_output=True, text=True, timeout=3600,
                env=dict(os.environ))
            for line in r.stdout.splitlines():
                if line.startswith("{"):
                    print(line, flush=True)
            if r.returncode:
                failed.append(gen)
                print(json.dumps({"gen": gen,
                                  "error": r.stderr.strip()[-400:]}),
                      flush=True)
        if failed:
            raise SystemExit(f"generations failed: {failed}")
        return
    run_gen(what, r_iters or DEFAULT_R[what])


if __name__ == "__main__":
    main()
