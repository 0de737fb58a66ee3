"""Worker for the 2-process test (spawned by tests/test_multihost.py).

Each process runs this same SPMD program — the JAX multi-controller model —
exercising parallel/multihost.py's init + mesh with the dp-across-hosts
chain (frames across processes, time-sharding within a host).  The reference analog
is the two-process TX->pickle->GR hand-off (SDRScript.py:136-139) and the
two-radio split (LEGACY/gr-ofdm-rx/examples/top_block.py:71-87).

Usage: multihost_worker.py <process_id> <num_processes> <coordinator>
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
# force exactly 2 local devices, replacing any inherited count (pytest's
# conftest exports 8 for the in-process virtual mesh)
_flags = [f for f in os.environ.get("XLA_FLAGS", "").split()
          if "host_platform_device_count" not in f]
os.environ["XLA_FLAGS"] = " ".join(
    _flags + ["--xla_force_host_platform_device_count=2"])

import jax

jax.config.update("jax_platforms", "cpu")

import pathlib

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P


def main():
    pid, nproc, coord = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    os.environ["JAX_COORDINATOR_ADDRESS"] = coord
    os.environ["JAX_NUM_PROCESSES"] = str(nproc)
    os.environ["JAX_PROCESS_ID"] = str(pid)

    from lte_gnu_radio_code.parallel import chain as pchain
    from lte_gnu_radio_code.parallel import multihost
    from lte_gnu_radio_code.parallel import sharded
    from lte_gnu_radio_code.utils.params import OFDMConfig

    multihost.init_distributed()
    assert jax.process_count() == nproc, jax.process_count()
    mesh = multihost.multihost_mesh()          # dp = hosts, t = local devices
    t_shards = mesh.shape["t"]

    cfg = OFDMConfig(num_ofdm_symb=48).validate()
    while cfg.frame_len // t_shards < sharded.halo_size(cfg):
        cfg = OFDMConfig(num_ofdm_symb=cfg.num_ofdm_symb * 2).validate()

    step = pchain.make_sharded_chain(cfg, mesh)
    b = 2 * nproc                              # frames, sharded over dp=hosts
    rng = np.random.default_rng(0)             # same seed on every process
    bits_global = rng.integers(0, 2, (b, cfg.num_bits)).astype(np.int32)
    seeds_global = np.arange(b, dtype=np.int32)

    def shard_arr(arr, spec):
        sh = NamedSharding(mesh, spec)
        return jax.make_array_from_callback(
            arr.shape, sh, lambda idx: arr[idx])

    bits = shard_arr(bits_global, P("dp", None))
    seeds = shard_arr(seeds_global, P("dp"))
    ber, found, lock = jax.block_until_ready(step(bits, seeds))

    # every process sees its local dp shard; check it, then barrier
    ber_l = np.asarray(
        [np.asarray(s.data) for s in ber.addressable_shards]).ravel()
    found_l = np.asarray(
        [np.asarray(s.data) for s in found.addressable_shards]).ravel()
    assert found_l.all(), f"proc {pid}: sync lock failed"
    assert (ber_l == 0).all(), f"proc {pid}: nonzero BER {ber_l}"

    from jax.experimental import multihost_utils

    multihost_utils.sync_global_devices("done")
    print(f"MULTIHOST_OK pid={pid} procs={jax.process_count()} "
          f"devices={jax.device_count()} mesh=dp{mesh.shape['dp']}xt{t_shards} "
          f"frames={b}", flush=True)


if __name__ == "__main__":
    main()
