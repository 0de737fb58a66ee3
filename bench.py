#!/usr/bin/env python
"""Benchmark: full TX -> multipath channel -> AWGN -> RX chain throughput on
one GPU, verified on the device.

Usage: python bench.py [batch] [config] [R]
  config: loopback64 | lte1024 | lte2048 (default loopback64)

R chain iterations of `batch` frames each (distinct AWGN keys) fold into ONE
jitted lax.scan whose only outputs are two scalars, the summed BER and the
lock count.  Fetching them is both the completion barrier and the check of
all R*batch frames: every frame locked, total BER 0.  The transmitted bits
flip between iterations (bits ^ (i & 1)), so TX and channel stay
loop-variant and XLA cannot hoist them out of the timed scan; the BER
compares against the flipped bits.

Path selectors (env), all plain XLA:
  BENCH_SYNC_PATH  ifft (default) | conv | exact   (rxofdm.rx_frame fast=)
  BENCH_TX_PATH    xla (default) | fourstep        (txofdm.tx_frame path=)

Prints ONE JSON line with the device as JAX reports it and the card's name
and power limit as nvidia-smi reports them.  Exits nonzero unless JAX's
backend is the GPU.
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax
import jax.numpy as jnp
from jax import lax

from lte_gnu_radio_code.models import chain
from lte_gnu_radio_code.utils.device import (card_info, require_gpu,
                                             use_compile_cache)
from lte_gnu_radio_code.utils.params import GOLDEN64, LTE1024, LTE2048

CONFIGS = {"loopback64": (GOLDEN64,
                          "ofdm_chain loopback config, NFFT 64, QPSK"),
           "lte1024": (LTE1024, "LTE-scale NFFT 1024, QPSK"),
           "lte2048": (LTE2048, "LTE-scale NFFT 2048, QPSK")}

# Untuned starting points: chain iterations per dispatch and frames per
# iteration.  Where this card's rate stops rising with either has not been
# measured yet.
DEFAULT_R = {"loopback64": 128, "lte1024": 128, "lte2048": 64}
DEFAULT_BATCH = {"loopback64": 128, "lte1024": 32, "lte2048": 32}

SYNC_PATHS = ("ifft", "conv", "exact")
TX_PATHS = ("xla", "fourstep")


def make_many(cfg, batch, r_iters, fast, tx_path):
    """Jitted bits [batch, num_bits] -> (ber_sum, lock_count) over r_iters
    scan iterations of the batched chain."""
    frame = chain.chain_fn(cfg, tx_path=tx_path, fast=fast)

    def step(bits, seeds):
        keys = jax.vmap(jax.random.fold_in, (None, 0))(
            jax.random.PRNGKey(0), seeds)
        r = jax.vmap(frame)(bits, keys)
        return r.ber, r.found.astype(jnp.int32)

    @jax.jit
    def many(bits):
        def body(acc, i):
            bits_i = jnp.bitwise_xor(bits, i & 1)
            ber, found = step(bits_i,
                              i * batch + jnp.arange(batch, dtype=jnp.int32))
            return (acc[0] + jnp.sum(ber), acc[1] + jnp.sum(found)), ()
        (ber_sum, found_sum), _ = lax.scan(
            body, (jnp.float32(0.0), jnp.int32(0)),
            jnp.arange(r_iters, dtype=jnp.int32))
        return ber_sum, found_sum

    return many


def main():
    which = sys.argv[2] if len(sys.argv) > 2 else "loopback64"
    batch = int(sys.argv[1]) if len(sys.argv) > 1 and sys.argv[1] else \
        DEFAULT_BATCH[which]
    r_iters = int(sys.argv[3]) if len(sys.argv) > 3 else DEFAULT_R[which]
    cfg, label = CONFIGS[which]
    sync_path = os.environ.get("BENCH_SYNC_PATH", "ifft")
    tx_path = os.environ.get("BENCH_TX_PATH", "xla")
    if sync_path not in SYNC_PATHS or tx_path not in TX_PATHS:
        raise SystemExit(f"BENCH_SYNC_PATH={sync_path!r} must be one of "
                         f"{SYNC_PATHS}, BENCH_TX_PATH={tx_path!r} one of "
                         f"{TX_PATHS}")

    device = require_gpu()
    card = card_info()[0]
    use_compile_cache()

    n_samples = cfg.frame_len + cfg.nfft - 1
    many = make_many(cfg, batch, r_iters, sync_path, tx_path)
    bits = jnp.asarray(np.random.default_rng(0).integers(
        0, 2, (batch, cfg.num_bits), dtype=np.int32))

    t0 = time.perf_counter()
    jax.block_until_ready(many(bits))
    first_call_s = time.perf_counter() - t0
    samples_per_dispatch = r_iters * batch * n_samples

    rep_msps = []
    for _ in range(5):
        t0 = time.perf_counter()
        out = many(bits)
        ber_sum, found_sum = float(out[0]), int(out[1])   # fetch == barrier
        dt = time.perf_counter() - t0
        rep_msps.append(samples_per_dispatch / dt / 1e6)
        if found_sum != r_iters * batch or ber_sum != 0.0:
            raise SystemExit(
                f"verify failed: locks {found_sum}/{r_iters * batch}, "
                f"BER sum {ber_sum}")
    msps = float(np.median(rep_msps))
    print(json.dumps({
        "metric": f"verified full TX->fading->AWGN->RX chain throughput "
                  f"({label})",
        "value": msps,
        "unit": "Msamples/s/card",
        "card": card,
        "device": device,
        "R": r_iters, "batch": batch,
        "sync_path": sync_path, "tx_path": tx_path,
        "frames_verified_per_rep": r_iters * batch,
        "reps": len(rep_msps),
        "spread_pct": 100.0 * (max(rep_msps) - min(rep_msps)) / msps,
        "rep_msps": rep_msps,
        "first_call_s": first_call_s,
        "verify": "ok: every frame locked, total BER 0 (fetched from the "
                  "device every rep)",
    }), flush=True)


if __name__ == "__main__":
    main()
