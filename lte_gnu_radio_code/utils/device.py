"""Run-environment helpers for the programs that measure or smoke-test the
device path: the persistent compilation cache, the GPU requirement, and the
card's name and power limit that every reported number carries.
"""

from __future__ import annotations

import os
import pathlib
import subprocess

import jax

REPO_CACHE_DIR = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def use_compile_cache() -> str:
    """Enable JAX's persistent compilation cache and return its directory.

    A cache that moves between runs never hits (its path is part of the
    key), so it lives at one fixed place: where ``JAX_COMPILATION_CACHE_DIR``
    says when that is set (JAX reads that variable itself, and this leaves
    it alone), otherwise ``<repo>/.jax_cache`` inside the checkout.  In both
    cases every compiled program is kept, however small or quick to
    compile."""
    cache_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not cache_dir:
        cache_dir = str(REPO_CACHE_DIR)
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
    return cache_dir


def require_gpu() -> dict:
    """The device JAX runs on, as {"platform", "kind", "count"}; raises
    SystemExit unless JAX's backend is the GPU (a measurement that finds no
    card fails — it never falls back to the CPU)."""
    backend = jax.default_backend()
    if backend != "gpu":
        raise SystemExit(f"no GPU: JAX's backend is {backend!r}")
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def card_info() -> list[str]:
    """One line per card, ``name, power limit`` as nvidia-smi reports them
    (the limit bounds the clocks under load, so it goes beside every
    number)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return [ln.strip() for ln in out.splitlines() if ln.strip()]
