#!/usr/bin/env python
"""CPU-oracle throughput per config.

Times reference_cpu.golden.run_chain — the literal NumPy replication of the
reference signal chain (gr-RXOFDM/python/synch_and_chan_est.py work() math) —
for each benchmark config: the rate of the reference's own CPU semantics, on
this machine's CPU, beside which a device rate can be read.

Pure NumPy; the JAX platform is pinned to the CPU in case any import ever
pulls in jax.  Prints one JSON line per config:
{"config":..., "oracle_msps":..., "reps":...}.
"""

import json
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from lte_gnu_radio_code.reference_cpu import golden
from lte_gnu_radio_code.utils.params import GOLDEN64, LTE1024, LTE2048


def main():
    which = sys.argv[1:] or ["loopback64", "lte1024", "lte2048"]
    cfgs = {"loopback64": GOLDEN64, "lte1024": LTE1024, "lte2048": LTE2048}
    for name in which:
        cfg = cfgs[name]
        n_samples = cfg.frame_len + cfg.nfft - 1
        rng = np.random.default_rng(0)
        bits = rng.integers(0, 2, cfg.num_bits)
        golden.run_chain(cfg, bits)          # warm (allocators, caches)
        times = []
        reps = 0
        t_start = time.perf_counter()
        while reps < 3 or (time.perf_counter() - t_start < 60 and reps < 9):
            t0 = time.perf_counter()
            r = golden.run_chain(cfg, bits)
            times.append(time.perf_counter() - t0)
            reps += 1
        assert r["ber"] == 0.0, f"oracle BER nonzero for {name}"
        med = float(np.median(times))
        oracle_msps = round(n_samples / med / 1e6, 4)
        print(json.dumps({
            "config": name, "oracle_msps": oracle_msps,
            "n_samples": n_samples, "reps": reps,
            "median_s": round(med, 4),
            "spread_pct": round(100 * (max(times) - min(times)) / med, 1),
        }), flush=True)


if __name__ == "__main__":
    main()
