#!/usr/bin/env python
"""Verified continuous-streaming throughput on one GPU.

One jitted executable — a lax.scan of K chunk steps of the continuous
re-acquisition receiver (runtime/stream.reacq_step), vmapped over B
independent streams — whose fetched output (stream base + total detections)
is both the completion barrier and the check that detections happened.  The
IQ stream is generated on the host by the NumPy oracle and staged on the
device before the timed loop.

Usage: python bench_streaming_verified.py [config] [chunk] [K] [B]
  K = chunks per dispatch (lax.scan), B = independent streams (vmap).
Sync path via BENCH_SYNC_PATH (ifft | conv | exact, default ifft); demod
spectra via BENCH_DEMOD_PATH (fft | dft, default fft).

Prints ONE JSON line naming the card; exits nonzero unless JAX's backend is
the GPU.
"""

import functools
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax
import jax.numpy as jnp
from jax import lax

from lte_gnu_radio_code.reference_cpu import golden as G
from lte_gnu_radio_code.runtime.stream import (reacq_det_max, reacq_init,
                                               reacq_step)
from lte_gnu_radio_code.utils.device import (card_info, require_gpu,
                                             use_compile_cache)
from lte_gnu_radio_code.utils.params import GOLDEN64, LTE1024, LTE2048


def main():
    which = sys.argv[1] if len(sys.argv) > 1 else "lte1024"
    cfg = {"loopback64": GOLDEN64, "lte1024": LTE1024,
           "lte2048": LTE2048}[which]
    chunk_len = int(sys.argv[2]) if len(sys.argv) > 2 else \
        16 * cfg.rx_b_len // max(1, cfg.stride) * max(1, cfg.stride)
    k_chunks = int(sys.argv[3]) if len(sys.argv) > 3 else 16
    b_streams = int(sys.argv[4]) if len(sys.argv) > 4 else 1
    sync_path = os.environ.get("BENCH_SYNC_PATH", "ifft")
    demod_env = os.environ.get("BENCH_DEMOD_PATH", "fft")
    if sync_path not in ("ifft", "conv", "exact") or \
            demod_env not in ("fft", "dft"):
        raise SystemExit(f"BENCH_SYNC_PATH={sync_path!r} must be ifft, conv "
                         f"or exact; BENCH_DEMOD_PATH={demod_env!r} fft or dft")
    demod_path = None if demod_env == "fft" else demod_env
    det_max = reacq_det_max(cfg, chunk_len)

    device = require_gpu()
    card = card_info()[0]
    use_compile_cache()

    # ---- host-side stream: a few oracle TX frames through Fading + AWGN
    rng = np.random.default_rng(0)
    n_frames = max(2, (2 * k_chunks * chunk_len) // cfg.frame_len + 1)
    tx = np.concatenate([G.tx_frame(cfg, rng.integers(0, 2, cfg.num_bits))
                         for _ in range(n_frames)])
    sig = G.apply_channel(tx, G.channel_taps("Fading"), max_impulse=cfg.nfft)
    sig = G.awgn(cfg, sig, rng, np.var(tx)).astype(np.complex64)
    n_chunks = len(sig) // chunk_len
    if n_chunks < k_chunks:
        raise SystemExit(f"stream holds {n_chunks} chunks < K={k_chunks}")
    chunks_np = sig[: n_chunks * chunk_len].reshape(n_chunks, chunk_len)
    n_groups = max(2, n_chunks // k_chunks)
    dev_groups = [jax.device_put(np.stack(
        [chunks_np[(g * k_chunks + j) % n_chunks] for j in range(k_chunks)]))
        for g in range(n_groups)]

    step = functools.partial(reacq_step, cfg, det_max=det_max,
                             fast=sync_path, demod_path=demod_path)

    # Each dispatch re-enters from the initial state and scans K chunks, so
    # the steady-state per-chunk cost is what is measured.
    def one_stream(chunks):
        def body(carry, c):
            st, ndet = carry
            s2, out = step(st, c, jnp.int32(chunk_len))
            return (s2, ndet + jnp.sum(out.valid.astype(jnp.int32))), ()
        (st, ndet), _ = lax.scan(body, (reacq_init(cfg), jnp.int32(0)),
                                 chunks)
        return st.base, ndet

    @jax.jit
    def seg(chunks):
        bases, ndets = jax.vmap(one_stream)(
            jnp.broadcast_to(chunks, (b_streams,) + chunks.shape))
        return bases[0], jnp.sum(ndets)

    t0 = time.perf_counter()
    jax.block_until_ready(seg(dev_groups[0]))
    first_call_s = time.perf_counter() - t0
    samples_per_dispatch = k_chunks * chunk_len * b_streams

    rep_msps = []
    for i in range(5):
        t0 = time.perf_counter()
        base, ndet = (int(v) for v in seg(dev_groups[(i + 1) % n_groups]))
        dt = time.perf_counter() - t0
        rep_msps.append(samples_per_dispatch / dt / 1e6)
        if ndet <= 0 or base != k_chunks * chunk_len:
            raise SystemExit(f"verify failed: {ndet} detections, stream "
                             f"base {base} != {k_chunks * chunk_len}")

    msps = float(np.median(rep_msps))
    print(json.dumps({
        "metric": f"verified streaming RX throughput ({which}, chunk "
                  f"{chunk_len}, K={k_chunks} chunks/dispatch, "
                  f"B={b_streams} streams)",
        "value": msps,
        "unit": "Msamples/s/card",
        "card": card,
        "device": device,
        "sync_path": sync_path,
        "demod_path": demod_env,
        "reps": len(rep_msps),
        "spread_pct": 100.0 * (max(rep_msps) - min(rep_msps)) / msps,
        "rep_msps": rep_msps,
        "first_call_s": first_call_s,
        "detections_per_dispatch": ndet,
        "verify": "ok: detections present, stream state advancing "
                  "(fetched from the device every rep)",
    }), flush=True)


if __name__ == "__main__":
    main()
