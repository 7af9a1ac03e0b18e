"""Device mesh construction for GOP/tile sharding.

The reference is single-device (SURVEY.md §2.4); scale-out here is first
class: the temporal GOP axis and the spatial tile axis form a 2D
``jax.sharding.Mesh`` (axes "gop", "tile").  GOPs are embarrassingly parallel
(8-frame chunks with zero inter-block dependence, encoder.c:203-278), tiles
split each frame's block rows, and the only cross-shard coupling is ordered
bitstream concatenation (see sharding.py).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh

GOP_AXIS = "gop"
TILE_AXIS = "tile"


def make_mesh(
    gop: int | None = None,
    tile: int = 1,
    devices: list | None = None,
) -> Mesh:
    """Build a (gop, tile) mesh over the available devices.

    Defaults to all devices on the GOP axis (the embarrassingly parallel
    one, so it scales across hosts; the tile axis should stay within one
    host's cards).
    """
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if gop is None:
        gop = n // tile
    if gop * tile != n:
        raise ValueError(f"mesh {gop}x{tile} != {n} devices")
    arr = np.asarray(devices).reshape(gop, tile)
    return Mesh(arr, (GOP_AXIS, TILE_AXIS))


def single_device_mesh() -> Mesh:
    return make_mesh(gop=1, tile=1, devices=jax.devices()[:1])
