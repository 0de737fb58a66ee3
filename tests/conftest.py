"""Test configuration: the tests run on the CPU, which XLA splits into an
8-device virtual mesh so the multi-device sharding tests run on any machine.
Tests that need the GPU carry the ``gpu`` marker and skip here; the GPU path
is driven by ``python chip_smoke.py``.

The platform is fixed both through the environment and through the jax
config flag, before any backend is initialised."""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_platforms", "cpu")

import pathlib
import sys

import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

REF_DATA = pathlib.Path(
    "/root/reference/GNU-Radio-Repositories/TEST/GNU_RADIO_OFFLINE")


@pytest.fixture(scope="session")
def ref_vectors():
    """The shipped golden vectors (skip cleanly if reference not mounted)."""
    import pickle

    if not REF_DATA.exists():
        pytest.skip("reference test vectors not available")

    def load(rel):
        with open(REF_DATA / rel, "rb") as f:
            return np.asarray(pickle.load(f, encoding="latin1")).ravel()

    return {
        "bits": load("Data/tx_bit_data_chan_type_Fading_SNR_100.pckl"),
        "tx_online": load("Data/tx_data_online_chan_type_Fading_SNR_100.pckl"),
        "tx_offline": load("Data/tx_data_offline_chan_type_Fading_SNR_100.pckl"),
        "golden_out": load("Output/_output_data.pckl"),
    }
