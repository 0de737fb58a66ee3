"""Aux subsystems: stream checkpoint/resume, profiling utils, multihost mesh
(single-process degradation)."""

import numpy as np
import jax
import jax.numpy as jnp

from lte_gnu_radio_code.parallel import multihost
from lte_gnu_radio_code.reference_cpu import golden as G
from lte_gnu_radio_code.runtime.stream import StreamingRx
from lte_gnu_radio_code.utils import profiling
from lte_gnu_radio_code.utils.params import GOLDEN64


def test_stream_checkpoint_resume(tmp_path):
    """Kill a stream mid-frame, resume in a fresh object: outputs identical
    to an uninterrupted run."""
    cfg = GOLDEN64
    bits = np.random.default_rng(0).integers(0, 2, cfg.num_bits)
    tx = G.tx_frame(cfg, bits)
    rx = G.apply_channel(tx, G.channel_taps("Fading"), max_impulse=64)
    chunk = 640
    n_chunks = len(rx) // chunk
    cut = n_chunks // 2

    def collect(out, got):
        for i, k in enumerate(np.asarray(out.block_ids)):
            if k >= 0:
                got[int(k)] = np.asarray(out.phasors)[i]

    ref = {}
    s0 = StreamingRx(cfg, chunk)
    for c in range(n_chunks):
        collect(s0.push(rx[c * chunk:(c + 1) * chunk]), ref)

    got = {}
    s1 = StreamingRx(cfg, chunk)
    for c in range(cut):
        collect(s1.push(rx[c * chunk:(c + 1) * chunk]), got)
    s1.save_state(tmp_path / "ckpt.npz")

    s2 = StreamingRx(cfg, chunk)          # fresh process analogue
    s2.load_state(tmp_path / "ckpt.npz")
    for c in range(cut, n_chunks):
        collect(s2.push(rx[c * chunk:(c + 1) * chunk]), got)

    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], atol=1e-6)


def test_simple_timeit():
    f = jax.jit(lambda x: x * 2 + 1)
    dt, iters = profiling.simple_timeit(f, jnp.ones(16), min_seconds=0.1)
    assert dt > 0 and iters >= 3


def test_multihost_single_process_degrades():
    multihost.init_distributed()          # no coordinator -> no-op
    mesh = multihost.multihost_mesh()
    assert mesh.shape["dp"] == 1
    assert mesh.shape["t"] == len(jax.devices())
