"""Shard-count invariance: the time-sharded RX must produce outputs
identical to the single-device RX for any shard count (SURVEY.md §7.2 step 5),
and the dp x t sharded chain must reach zero BER at high SNR.

Runs on the 8-virtual-device CPU mesh from conftest."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from lte_gnu_radio_code.models import rxofdm
from lte_gnu_radio_code.parallel import chain as pchain
from lte_gnu_radio_code.parallel import mesh as meshmod
from lte_gnu_radio_code.parallel import sharded
from lte_gnu_radio_code.reference_cpu import golden as G
from lte_gnu_radio_code.utils.params import GOLDEN64, OFDMConfig


@pytest.fixture(scope="module")
def rx_buffer():
    cfg = GOLDEN64
    bits = np.random.default_rng(0).integers(0, 2, cfg.num_bits)
    tx = G.tx_frame(cfg, bits)
    rx = G.apply_channel(tx, G.channel_taps("Fading"), max_impulse=64)
    rx = G.awgn(cfg, rx, np.random.default_rng(1), np.var(tx))
    return bits, jnp.asarray(rx, jnp.complex64)


@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_sharded_rx_matches_single_device(rx_buffer, n_shards):
    cfg = GOLDEN64
    bits, rx = rx_buffer
    r1 = rxofdm.make_rx(cfg, rx.shape[0])(rx)
    mesh = meshmod.time_mesh(n_shards)
    rs = sharded.make_sharded_rx(cfg, rx.shape[0], mesh)(rx)
    assert bool(rs.found)
    assert int(rs.lock_ptr) == int(r1.lock_ptr)
    assert int(rs.delay_idx) == int(r1.delay_idx)
    np.testing.assert_array_equal(np.asarray(rs.hard_bits),
                                  np.asarray(r1.hard_bits))
    np.testing.assert_allclose(np.asarray(rs.phasors),
                               np.asarray(r1.phasors), atol=1e-5)


def test_sharded_rx_no_false_lock_on_noise():
    cfg = GOLDEN64
    n = cfg.frame_len + cfg.nfft - 1
    noise = 0.05 * (np.random.default_rng(3).standard_normal(n)
                    + 1j * np.random.default_rng(4).standard_normal(n))
    mesh = meshmod.time_mesh(4)
    r = sharded.make_sharded_rx(cfg, n, mesh)(jnp.asarray(noise, jnp.complex64))
    assert not bool(r.found)


def test_dp_t_sharded_chain_zero_ber():
    cfg = OFDMConfig(num_ofdm_symb=48).validate()
    mesh = meshmod.make_mesh(8, dp=2, axis_names=("dp", "t"))
    step = pchain.make_sharded_chain(cfg, mesh)
    B = 4
    bits = np.stack([np.random.default_rng(s).integers(0, 2, cfg.num_bits)
                     for s in range(B)])
    ber, found, lock = step(jnp.asarray(bits, jnp.int32),
                            jnp.arange(B, dtype=jnp.int32))
    assert bool(np.asarray(found).all())
    assert float(np.asarray(ber).max()) == 0.0


def test_graft_entry_and_dryrun():
    import __graft_entry__ as ge
    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    assert float(out[0]) == 0.0 and bool(out[1])
    ge.dryrun_multichip(8)
