"""Device lists for sharded search (counterpart: ``rag_on_edge_tpu/parallel/mesh.py``).

The JAX package shards over a 1-D ``jax.sharding.Mesh`` and runs one
``shard_map`` program on it.  The port keeps its single controller: one
process drives a list of ``torch.device``s, one per logical shard, and
logical shards may share a device.  :func:`make_mesh` gives the first
``n`` devices of a type; every sharded class also takes an explicit list
(for example ``[torch.device("cuda:0")] * 4``, four shards on one card).
"""

from __future__ import annotations

import torch

__all__ = ["make_mesh", "SHARD_AXIS"]

#: The JAX mesh's axis name, kept for readers of both packages; the port's
#: shard axis is the position in the device list.
SHARD_AXIS = "shard"


def make_mesh(n_devices: int | None = None, axis_name: str = SHARD_AXIS,
              device_type: str = "cuda") -> list[torch.device]:
    """The first ``n_devices`` devices of ``device_type`` (default: all of
    them), one shard each.  ``axis_name`` takes the JAX signature's place
    and names nothing: a device list has one axis, its position.  Raises
    past the count, and where there are none: there is no fall-back to
    another device type."""
    if device_type == "cuda":
        count = torch.cuda.device_count()
    elif device_type == "cpu":
        count = 1
    else:
        raise ValueError(f"unknown device_type {device_type!r} ('cuda' | 'cpu')")
    if count == 0:
        raise RuntimeError(f"no {device_type} devices")
    if n_devices is None:
        n_devices = count
    if n_devices > count:
        raise ValueError(f"requested {n_devices} devices, have {count}")
    if device_type == "cpu":
        return [torch.device("cpu")] * n_devices
    return [torch.device(device_type, i) for i in range(n_devices)]
