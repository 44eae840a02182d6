"""Device mesh construction.

The reference's parallel axes are OS processes: one process per RX
(MP_SCHEME 3, reference am.py:85-114) and thread pipelines. Here the axes
are a 2-D device mesh:

  'ch'     — channel parallelism: shards of the vmapped receiver bank
             (the arbitrary-N generalization of MAX_RX=6);
  'stream' — time parallelism: contiguous stream segments processed
             concurrently with overlap-discard halos (SURVEY.md §2.10).

Multi-host runs initialize jax.distributed outside and pass the global
device list. On one host every card reaches every other at the same
rate, so the mesh shape follows the algorithm alone.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P  # noqa: F401


def make_mesh(n_stream: int = 1, n_ch: int | None = None, devices=None
              ) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    nd = len(devices)
    if n_ch is None:
        assert nd % n_stream == 0, (nd, n_stream)
        n_ch = nd // n_stream
    assert n_stream * n_ch <= nd, (n_stream, n_ch, nd)
    arr = np.asarray(devices[:n_stream * n_ch]).reshape(n_stream, n_ch)
    return Mesh(arr, ("stream", "ch"))


def single_axis_mesh(axis: str = "ch", devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (axis,))
