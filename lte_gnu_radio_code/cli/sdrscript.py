"""Offline TX/RX simulation driver — replaces txrx_mod/SDRScript.py (D2).

Loops over SDR profiles and an Eb/N0 list, generates random bits, builds the
TX frame, pickles the TX time signal (the hand-off artifact the GNU Radio
TX blocks stream — SDRScript.py:136-139), runs channel + AWGN + RX, and
reports BER per point.
"""

from __future__ import annotations

import argparse
import json
import pathlib

import numpy as np

import jax
import jax.numpy as jnp


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--case", type=int, default=0, choices=[0, 1],
                   help="SDR profile (0: 4G5GSISO-TU, 1: WIFIMIMOSM-A)")
    p.add_argument("--ebno-db", type=float, nargs="*", default=None,
                   help="override the profile's Eb/N0 sweep list")
    p.add_argument("--num-symbols", type=int, default=None)
    p.add_argument("--out-dir", default=".",
                   help="where to write the TX pickle hand-off")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--json", action="store_true")
    args = p.parse_args(argv)

    from ..io.pickles import save_pickle_iq
    from ..models import chain, txofdm
    from ..utils.params import SDR_PROFILES, config_from_profile

    profile = SDR_PROFILES[args.case]
    ebnos = args.ebno_db if args.ebno_db is not None else profile["ebno_db"]
    results = []
    for i, ebno in enumerate(ebnos):
        cfg = config_from_profile(profile, num_symbols=args.num_symbols,
                                  snr_db=float(ebno))
        rng = np.random.default_rng(args.seed + i)
        bits = jnp.asarray(rng.integers(0, 2, cfg.num_bits, dtype=np.int32))
        tx = txofdm.make_tx(cfg)(bits)
        if i == 0:
            # the 4g5g_input_data.pckl hand-off (SDRScript.py:136-139)
            path = pathlib.Path(args.out_dir) / "4g5g_input_data.pckl"
            tx_np = np.asarray(tx)
            save_pickle_iq(path, tx_np[None, :])
        out = chain.make_chain(cfg)(bits, jax.random.PRNGKey(args.seed + i))
        results.append({"ebno_db": float(ebno), "ber": float(out.ber),
                        "found": bool(out.found)})

    if args.json:
        print(json.dumps(results))
    else:
        for r in results:
            print(f"Eb/N0 {r['ebno_db']:6.1f} dB   BER {r['ber']:.6f}   "
                  f"lock={'yes' if r['found'] else 'NO'}")
    return results


if __name__ == "__main__":
    main()
