"""Recorded-IQ receiver — replaces LEGACY/gr-ofdm-rx/examples/top_block.py
(D4: USRP source -> SynchEstAndFO -> BitRecovery -> Qt sinks).

Radio hardware is out of scope here (SURVEY.md §2.8 X6); the UHD source is
replaced by an IQ file/pickle source.  The RX is the legacy multi-detection
CFO-search family (SynchEstAndFO / SynchEstFOAndDSSS) driven by the same
hard-coded `case` tables (SynchEstAndFO.py:36-137)."""

from __future__ import annotations

import argparse
import json

import numpy as np

import jax.numpy as jnp


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("iq_file", help="pickle (or .npy) of complex IQ samples")
    p.add_argument("--case", type=int, default=7,
                   help="legacy case table index (top_block.py:129 uses 7)")
    p.add_argument("--fo-range", type=float, nargs="*", default=[0.0],
                   help="CFO candidates in Hz (top_block.py: [0])")
    p.add_argument("--dsss", type=int, default=0,
                   help="use the DSSS case table + despreading")
    p.add_argument("--max-det", type=int, default=100)
    p.add_argument("--stream", type=int, default=0, metavar="CHUNK_LEN",
                   help="run continuously in CHUNK_LEN-sample work calls "
                        "(the GR block's streaming semantics) instead of one "
                        "whole-buffer batch; output is identical")
    p.add_argument("--diag-dir")
    p.add_argument("--json", action="store_true")
    args = p.parse_args(argv)

    from ..io.pickles import load_pickle_iq
    from ..models import legacy_rx
    from ..utils.params import CFO_CASES, DSSS_CASES, config_from_case

    if str(args.iq_file).endswith(".npy"):
        rx = np.load(args.iq_file).ravel()
    else:
        rx = load_pickle_iq(args.iq_file).ravel()

    if args.dsss:
        cfg = config_from_case(DSSS_CASES, args.case)
        dsss = DSSS_CASES[args.case]["dsss"]
    else:
        cfg = config_from_case(CFO_CASES, args.case)
        dsss = 1

    if args.stream:
        from ..runtime.stream import LegacyStreamingRx

        stride = max(1, cfg.stride)
        chunk = -(-args.stream // stride) * stride
        import jax

        srx = LegacyStreamingRx(cfg, chunk, fo_range=tuple(args.fo_range),
                                dsss=dsss)
        buf = np.zeros(-(-len(rx) // chunk) * chunk, np.complex64)
        buf[: len(rx)] = rx
        # full chunks ride push_many (K work() calls per device dispatch);
        # only a trailing partial chunk needs per-push n_real
        n_full = len(rx) // chunk
        outs = []
        if n_full:
            many = srx.push_many(buf[: n_full * chunk].reshape(n_full, chunk))
            outs.extend(jax.tree.map(lambda x, j=j: x[j], many)
                        for j in range(n_full))
        for i in range(n_full * chunk, len(buf), chunk):
            outs.append(srx.push(buf[i: i + chunk],
                                 n_real=max(0, len(rx) - i)))
        outs.extend(srx.finish())
        valid = [np.asarray(o.valid) for o in outs]
        cat = lambda f_: np.concatenate(
            [np.asarray(f_(o))[v] for o, v in zip(outs, valid)])
        ptrs, delays = cat(lambda o: o.ptrs), cat(lambda o: o.delays)
        fo_idx, phasors = cat(lambda o: o.fo_idx), cat(lambda o: o.phasors)
        despread = cat(lambda o: o.despread)
        # --max-det applies in both modes: the batch path allocates exactly
        # max_det slots, so cap the concatenated stream detections the same
        # way (the legacy block's max_num_corr=100 table semantics).
        ptrs, delays = ptrs[: args.max_det], delays[: args.max_det]
        fo_idx, phasors = fo_idx[: args.max_det], phasors[: args.max_det]
        despread = despread[: args.max_det]
        n = len(ptrs)
    else:
        f = legacy_rx.make_legacy_rx(cfg, len(rx),
                                     fo_range=tuple(args.fo_range),
                                     dsss=dsss, max_det=args.max_det)
        r = f(jnp.asarray(rx, jnp.complex64))
        n = int(r.count)
        ptrs, delays = np.asarray(r.ptrs[:n]), np.asarray(r.delays[:n])
        fo_idx = np.asarray(r.fo_idx[:n])
        phasors, despread = np.asarray(r.phasors[:n]), np.asarray(r.despread[:n])
    out = {
        "detections": n,
        "ptrs": ptrs.tolist(),
        "delays": delays.tolist(),
        "fo_idx": fo_idx.tolist(),
    }
    if args.diag_dir:
        from ..utils import diagnostics as diag
        diag.iq_scatter(despread if dsss > 1 else phasors,
                        save_to=f"{args.diag_dir}/iq_scatter.png")
    if args.json:
        print(json.dumps(out))
    else:
        print(f"{n} detections")
        for i in range(n):
            print(f"  ptr {out['ptrs'][i]:7d}  delay {out['delays'][i]:3d}  "
                  f"fo {args.fo_range[out['fo_idx'][i]]:+.0f} Hz")
    return out


if __name__ == "__main__":
    main()
