"""Import a GNU Radio Companion flowgraph from the reference and run it.

Replaces the GRC integration tier of the reference (SURVEY.md §1 L4, §2.6
F4): users of the reference bring their ``.grc`` files — the current-gen
YAML ``ofdm_chain.grc`` or the GR 3.7 XML graphs
(``RxReceiver_Diag.grc``, ``RXtransmit_6.grc``) — and this tool maps them
onto this framework's configs and pipelines.

Examples::

  # inspect + emit the equivalent configs/*.json
  python -m lte_gnu_radio_code.cli.grc_import ofdm_chain.grc -o cfg.json

  # import AND run: synthetic loopback with the graph's numerology
  python -m lte_gnu_radio_code.cli.grc_import ofdm_chain.grc --run

  # import the diagnostic RX graph and run it on a recorded capture
  python -m lte_gnu_radio_code.cli.grc_import RxReceiver_Diag.grc \\
      --run --tx-pickle capture.pckl
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("grc", help=".grc flowgraph file (GR 3.7 XML or 3.8+ YAML)")
    p.add_argument("-o", "--out-config", help="write the equivalent JSON "
                   "config (configs/*.json schema) here")
    p.add_argument("--run", action="store_true",
                   help="execute the imported graph")
    p.add_argument("--tx-pickle", help="IQ capture for graphs whose source "
                   "is a radio or an absent pickle file")
    p.add_argument("--bits-pickle", help="ground-truth bits for BER")
    p.add_argument("--json", action="store_true")
    args = p.parse_args(argv)

    from ..io.grc import interpret_grc, load_grc

    graph = load_grc(args.grc)
    plan = interpret_grc(graph)

    out = {"format": graph.fmt, "kind": plan.kind,
           "blocks": [b.key for b in graph.enabled_blocks()],
           "source": plan.source, "rx": plan.rx, "sinks": plan.sinks,
           "notes": plan.notes, "config": plan.config_json()}

    if args.out_config and plan.config is not None:
        with open(args.out_config, "w") as f:
            json.dump(plan.config_json(), f, indent=2)
        out["config_written"] = args.out_config

    if args.run:
        out["run"] = _run(plan, args)

    if args.json:
        print(json.dumps(out))
    else:
        for k, v in out.items():
            print(f"{k}: {v}")
    return out


def _iq_input(plan, args):
    """Resolve the graph's source to an IQ buffer, if one is available."""
    from ..io.pickles import load_pickle_iq

    if args.tx_pickle:
        return load_pickle_iq(args.tx_pickle).ravel()
    src = plan.source
    if src.get("kind") in ("pickle", "chunked_pickle", "timed_pickle"):
        path = str(src.get("directory", "")) + str(src.get("file", ""))
        if path:
            try:
                return load_pickle_iq(path).ravel()
            except OSError:
                pass
    return None


def _run(plan, args):
    import jax.numpy as jnp

    cfg = plan.config
    if cfg is None:
        return {"error": "no runnable RX/TX block found in the graph"}

    rx_sig = _iq_input(plan, args)

    if plan.kind == "legacy_rx":
        from ..models import legacy_rx

        if rx_sig is None:
            return {"error": "legacy RX graph needs an IQ capture "
                             "(--tx-pickle); its source was a radio"}
        dsss = int(plan.rx.get("dsss", 1))
        f = legacy_rx.make_legacy_rx(
            cfg, len(rx_sig), fo_range=tuple(plan.rx.get("fo_range", [0.0])),
            dsss=dsss)
        r = f(jnp.asarray(rx_sig, jnp.complex64))
        n_det = int(np.asarray(r.count))
        res = {"detections": n_det,
               "ptrs": np.asarray(r.ptrs)[:n_det][:5].tolist()}
        if plan.rx.get("bit_recovery"):                     # D6: BitRecovery
            from ..ops import modulation

            phas = (r.despread if dsss > 1 else r.phasors)[:n_det]
            if plan.rx["bit_recovery"]["variant"] == "pairswap":
                hard, _, _ = modulation.qpsk_llr_pairswap(phas.ravel())
            else:
                hard, _, _ = modulation.qpsk_llr(phas.ravel())
            res["hard_bits"] = int(hard.size)
            if args.bits_pickle:
                from ..io.pickles import load_pickle_iq as lp
                gt = lp(args.bits_pickle).ravel()
                hb = np.asarray(hard).ravel()[: len(gt)]
                res["ber"] = float(np.mean(hb != gt[: len(hb)]))
        return res

    # flagship: RX an IQ buffer if we have one, else synthetic loopback
    from ..models import chain, rxofdm

    if rx_sig is not None:
        r = rxofdm.make_rx(cfg, len(rx_sig))(jnp.asarray(rx_sig,
                                                         jnp.complex64))
        res = {"mode": "rx_pickle", "found": bool(np.asarray(r.found)),
               "lock_ptr": int(np.asarray(r.lock_ptr))}
        if args.bits_pickle:
            from ..io.pickles import load_pickle_iq as lp
            gt = lp(args.bits_pickle).ravel()
            hb = np.asarray(r.hard_bits).ravel()[: len(gt)]
            res["ber"] = float(np.mean(hb != gt[: len(hb)]))
        return res

    import jax

    rng = np.random.default_rng(0)
    bits = jnp.asarray(rng.integers(0, 2, cfg.num_bits, dtype=np.int32))
    step = chain.make_chain(cfg)
    r = step(bits, jax.random.PRNGKey(0))
    return {"mode": "loopback", "found": bool(np.asarray(r.found)),
            "lock_ptr": int(np.asarray(r.lock_ptr)),
            "ber": float(np.asarray(r.ber))}


if __name__ == "__main__":
    main()
