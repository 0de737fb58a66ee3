"""chip_smoke.py's phases on the CPU at reduced symbol counts, its refusal to
run without a GPU, bench.py's likewise, and the compile-cache placement.

The full-size phases run on the card through ``python chip_smoke.py``;
``test_chip_smoke_on_gpu`` (marker ``gpu``) does that where a card exists.
"""

import dataclasses
import json
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

import chip_smoke as cs
from lte_gnu_radio_code.utils.params import GOLDEN64, LTE1024, LTE2048

REPO = pathlib.Path(__file__).resolve().parents[1]
CONFIGS = {"loopback64": GOLDEN64, "lte1024": LTE1024, "lte2048": LTE2048}


def _small(name):
    return dataclasses.replace(CONFIGS[name], num_ofdm_symb=8).validate()


def _cpu_env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_COMPILATION_CACHE_DIR")}
    env.update(JAX_PLATFORMS="cpu", **extra)
    return env


@pytest.mark.parametrize("name", ["loopback64", "lte1024", "lte2048"])
def test_smoke_chain_phase(name):
    out = cs.phase_chain(_small(name), batch=2, reps=1)
    assert out["locks"] == 2 and out["ber_sum"] == 0.0


@pytest.mark.parametrize("name", ["loopback64", "lte1024", "lte2048"])
def test_smoke_rx_vs_oracle_phase(name):
    out = cs.phase_rx_vs_oracle(_small(name), seed=3)
    assert out["bits"] > 0
    assert out["tx_err"] <= cs.TX_ATOL and out["phasor_err"] <= cs.PHASOR_ATOL


@pytest.mark.parametrize("name", ["loopback64", "lte1024"])
def test_smoke_stream_phase(name):
    assert cs.phase_stream(_small(name), seed=1) > 0


@pytest.mark.parametrize("gen", sorted(cs.GENERATIONS))
def test_smoke_generation_phase(gen):
    assert cs.GENERATIONS[gen]().startswith(gen)


def test_chip_smoke_without_gpu_fails():
    r = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                       capture_output=True, text=True, timeout=300,
                       env=_cpu_env(), cwd=REPO)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "no GPU" in r.stderr


def test_bench_without_gpu_fails():
    r = subprocess.run([sys.executable, str(REPO / "bench.py"), "2",
                        "loopback64", "1"],
                       capture_output=True, text=True, timeout=300,
                       env=_cpu_env(), cwd=REPO)
    assert r.returncode != 0
    assert "verify" not in r.stdout
    assert "no GPU" in r.stderr


_CACHE_PROBE = """
import sys
sys.path.insert(0, sys.argv[1])
import jax
from lte_gnu_radio_code.utils.device import use_compile_cache
print(use_compile_cache())
print(jax.config.jax_compilation_cache_dir)
if len(sys.argv) > 2:
    import jax.numpy as jnp
    jax.block_until_ready(jax.jit(lambda x: x * 2 + 1)(jnp.ones(3)))
"""


def test_compile_cache_honours_env_dir(tmp_path):
    cache = tmp_path / "cache"
    r = subprocess.run(
        [sys.executable, "-c", _CACHE_PROBE, str(REPO), "compile"],
        capture_output=True, text=True, timeout=300,
        env=_cpu_env(JAX_COMPILATION_CACHE_DIR=str(cache)))
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == [str(cache), str(cache)]
    assert any(cache.iterdir()), "no compiled entry landed in the env dir"


def test_compile_cache_defaults_to_repo_dir():
    r = subprocess.run([sys.executable, "-c", _CACHE_PROBE, str(REPO)],
                       capture_output=True, text=True, timeout=300,
                       env=_cpu_env())
    assert r.returncode == 0, r.stderr
    want = str(REPO / ".jax_cache")
    assert r.stdout.split() == [want, want]


@pytest.mark.gpu
def test_chip_smoke_on_gpu():
    """The whole smoke on the card (the tests themselves run on the CPU, so
    the script runs in a child process with the platform left to JAX)."""
    if shutil.which("nvidia-smi") is None or subprocess.run(
            ["nvidia-smi", "-L"], capture_output=True).returncode != 0:
        pytest.skip("needs an NVIDIA GPU")
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    r = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                       capture_output=True, text=True, timeout=1200,
                       env=env, cwd=REPO)
    assert r.returncode == 0, r.stderr[-2000:]
    last = json.loads(r.stdout.strip().splitlines()[-1])
    assert last["ok"] is True and last["device"]["platform"] == "gpu"
