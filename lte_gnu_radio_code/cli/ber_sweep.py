"""BER-vs-SNR sweep — BASELINE.json config 4 (full TX -> multipath fading ->
RX chain, one-tap MMSE EQ, swept SNR, any modulation).  The JAX curve is
optionally cross-checked against the CPU reference oracle at each point."""

from __future__ import annotations

import argparse
import json

import numpy as np

import jax
import jax.numpy as jnp


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--snrs", type=float, nargs="*",
                   default=[6, 8, 10, 12, 14, 16, 20, 24])
    p.add_argument("--config", help="JSON config file (e.g. "
                                    "configs/qam64_sweep.json); its "
                                    "modulation/channel/shape override the "
                                    "flags below")
    p.add_argument("--modulation", default="QPSK",
                   choices=["BPSK", "QPSK", "QAM16", "QAM64"])
    p.add_argument("--channel", default="Fading")
    p.add_argument("--num-ofdm-symb", type=int, default=240)
    p.add_argument("--frames", type=int, default=4, help="frames per point")
    p.add_argument("--check-oracle", action="store_true",
                   help="also run the CPU reference oracle per point")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--json", action="store_true")
    args = p.parse_args(argv)

    from ..models import chain
    from ..utils.params import OFDMConfig

    base = {}
    if args.config:
        base = json.loads(open(args.config).read())
        if "synch_dat" in base:
            base["synch_dat"] = tuple(base["synch_dat"])
        args.modulation = base.get("modulation", args.modulation)

    results = []
    for snr in args.snrs:
        kw = dict(modulation=args.modulation, channel=args.channel,
                  num_ofdm_symb=args.num_ofdm_symb)
        kw.update(base)
        kw["snr_db"] = float(snr)
        cfg = OFDMConfig(**kw).validate()
        f = chain.make_chain(cfg)
        bers = []
        for s in range(args.frames):
            rng = np.random.default_rng(1000 * args.seed + s)
            bits = jnp.asarray(rng.integers(0, 2, cfg.num_bits,
                                            dtype=np.int32))
            out = f(bits, jax.random.PRNGKey(1000 * args.seed + s))
            bers.append(float(out.ber))
        row = {"snr_db": float(snr), "ber": float(np.mean(bers))}
        if args.check_oracle and args.modulation in ("BPSK", "QPSK"):
            from ..reference_cpu import golden as G
            obers = [G.run_chain(cfg, seed=1000 * args.seed + s)["ber"]
                     for s in range(args.frames)]
            row["oracle_ber"] = float(np.mean(obers))
        results.append(row)
        if not args.json:
            line = f"SNR {row['snr_db']:6.1f} dB   BER {row['ber']:.6f}"
            if "oracle_ber" in row:
                line += f"   oracle {row['oracle_ber']:.6f}"
            print(line)
    if args.json:
        print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
