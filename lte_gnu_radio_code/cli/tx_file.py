"""TX waveform app — replaces the legacy USRP TX graph (D5:
LEGACY/gr-ofdm-tx/grc/RXtransmit_6.grc: OFDMTransmitter -> uhd_usrp_sink).

Radio hardware is out of scope here (SURVEY.md §2.8 X6); the UHD sink is
replaced by an IQ file sink.  Two modes:

* ``--generate``: build the TX frame on-device from a profile + seed and
  write it (the SDRScript.py:136-139 hand-off, as a standalone app).
* default (replay): stream an existing TX pickle through the T2 chunked
  source — <=4095-sample work quanta with leftover carry, ``--repeat``
  passes per data set, rotation over ``--num-files`` numbered pickles
  (OFDMTransmitter.py:30-122) — through the flowgraph runtime into the sink.
"""

from __future__ import annotations

import argparse
import json
import pathlib

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("out_file", help="output IQ file (.npy or .pckl)")
    p.add_argument("--generate", action="store_true",
                   help="synthesise the TX frame instead of replaying")
    p.add_argument("--case", type=int, default=0, choices=[0, 1],
                   help="SDR profile for --generate")
    p.add_argument("--num-symbols", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--pickle-dir", default=".",
                   help="replay: directory of numbered TX pickles")
    p.add_argument("--file-stem", default="tx_data_",
                   help="replay: stem of <stem><k>.pckl files "
                        "(OFDMTransmitter.py:44)")
    p.add_argument("--num-files", type=int, default=1)
    p.add_argument("--repeat", type=int, default=20,
                   help="num_repeat_per_data_set (OFDMTransmitter.py:41)")
    p.add_argument("--chunk", type=int, default=4095,
                   help="work-call quantum (OFDMTransmitter.py:52)")
    p.add_argument("--n-chunks", type=int, default=0,
                   help="replay: number of work calls to drive (default: "
                        "one full pass over every file x repeat)")
    p.add_argument("--json", action="store_true")
    args = p.parse_args(argv)

    out_path = pathlib.Path(args.out_file)

    if args.generate:
        import jax.numpy as jnp

        from ..models import txofdm
        from ..utils.params import SDR_PROFILES, config_from_profile

        cfg = config_from_profile(SDR_PROFILES[args.case],
                                  num_symbols=args.num_symbols)
        rng = np.random.default_rng(args.seed)
        bits = jnp.asarray(rng.integers(0, 2, cfg.num_bits, dtype=np.int32))
        tx = txofdm.make_tx(cfg)(bits)
        sig = np.asarray(tx)
        n_calls = 0
    else:
        from ..io.pickles import ChunkedPickleSource
        from ..runtime.flowgraph import CollectSink, Flowgraph

        src = ChunkedPickleSource(args.pickle_dir, args.file_stem,
                                  num_files=args.num_files,
                                  num_repeat=args.repeat,
                                  max_chunk=args.chunk)
        if args.n_chunks:
            n_calls = args.n_chunks
        else:
            # One full pass = every file's ACTUAL length x repeat; numbered
            # pickles may have unequal row sizes, so sum them rather than
            # multiplying the first file's size by num_files.
            from ..io.pickles import load_pickle_iq
            total = sum(
                np.atleast_2d(load_pickle_iq(
                    pathlib.Path(args.pickle_dir)
                    / f"{args.file_stem}{k}.pckl"))[0].size
                for k in range(args.num_files)) * args.repeat
            n_calls = -(-total // args.chunk)
        sink = CollectSink()
        Flowgraph(args.chunk).connect(src, sink).run(n_calls)
        sig = np.concatenate(sink.items)

    if out_path.suffix == ".npy":
        np.save(out_path, sig.astype(np.complex64))
    else:
        from ..io.pickles import save_pickle_iq
        save_pickle_iq(out_path, sig[None, :])

    out = {"samples": int(sig.size), "file": str(out_path),
           "work_calls": int(n_calls),
           "mode": "generate" if args.generate else "replay"}
    print(json.dumps(out) if args.json else
          f"wrote {out['samples']} samples to {out['file']} "
          f"({out['mode']}, {out['work_calls']} work calls)")
    return out


if __name__ == "__main__":
    main()
