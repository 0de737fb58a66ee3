"""TX model — the gr-TXOFDM / txrx_mod transmitter as one jitted function.

bits -> constellation -> resource grid -> batched IFFT+CP+norm -> time frame.
Reference: MultiAntennaSystem.multi_ant_binary_map (:113-187) and
multi_ant_symb_gen (:189-218); streaming sources T1-T4 replay exactly this
frame from pickle files.

``path`` selects the IFFT+CP+norm implementation:
  * None / "xla"  -> ops.ofdm.modulate (the FFT op; the library default).
  * "fourstep"    -> ops.ofdm.modulate_fourstep (the IDFT as two matmul
    rounds + twiddles).
Both paths produce the same frame to float32 tolerance and identical
downstream bit decisions (tests/test_fourstep.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..ops import modulation, ofdm
from ..utils.params import OFDMConfig


def _grid(cfg: OFDMConfig, bits: jnp.ndarray) -> jnp.ndarray:
    pts = modulation.bits_to_symbols(bits, cfg.modulation)
    return ofdm.resource_grid(
        cfg, pts.reshape(cfg.num_data_symb, cfg.num_data_only_bins))


def tx_frame(cfg: OFDMConfig, bits: jnp.ndarray,
             path: str | None = None) -> jnp.ndarray:
    """[cfg.num_bits] bits -> [cfg.frame_len] complex64 time samples."""
    grid = _grid(cfg, bits)
    if path == "fourstep":
        return ofdm.modulate_fourstep(cfg, grid)
    if path not in (None, "xla"):
        raise ValueError(f"tx_frame: unknown path {path!r}; expected None, "
                         "'xla' or 'fourstep'")
    return ofdm.modulate(cfg, grid)


def tx_frames(cfg: OFDMConfig, bits: jnp.ndarray,
              path: str | None = None) -> jnp.ndarray:
    """Batched TX: [B, cfg.num_bits] bits -> [B, cfg.frame_len] frames (a
    vmap of the per-frame modulator; its FFTs batch across the vmap)."""
    return jax.vmap(lambda b: tx_frame(cfg, b, path))(bits)


def make_tx(cfg: OFDMConfig, path: str | None = None):
    """Jitted closure over the static config."""
    return jax.jit(functools.partial(tx_frame, cfg, path=path))
