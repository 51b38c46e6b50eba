"""Load state built by the JAX engine into the port.

The query engine has no weights: a resident tile (or the delta planes it
is decoded from) is its state.  The tests give both engines the same state
through these functions, with the reference's arrays handed over as numpy
(``np.asarray`` of the JAX arrays) so this package never imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.device_rollup import fleet_layout
from .parallel import mesh as meshlib
from .parallel import partition

_PLANE_FIELDS = ("ts_first", "ts_fdelta", "ts_d2", "val_first",
                 "val_fdelta", "val_d2", "scale", "counts")


def _tensor(a, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=dtype, copy=True)).to(device)


def tiles_from_reference(ts, values, counts, device):
    """The reference's resident tile (ts int32 [S, N], values [S, N],
    counts [S]) -> the port's tile tuple (int32, float64, int32) on
    `device`, each a fresh tensor."""
    return (_tensor(ts, np.int32, device), _tensor(values, np.float64, device),
            _tensor(counts, np.int32, device))


def planes_from_reference(planes, device) -> tuple:
    """A DeltaPlanes-like object (the reference's or the port's) -> the
    eight plane tensors on `device`, in ``decode_tiles`` argument order,
    each keeping its array's dtype."""
    arrays = [np.asarray(getattr(planes, f)) for f in _PLANE_FIELDS]
    return tuple(_tensor(a, a.dtype, device) for a in arrays)


def fleet_from_reference(ts, values, counts, gids, v0, aggr, num_groups,
                         device):
    """The reference's fleet bucket arrays (numpy ts int32 [B, S, N],
    values [B, S, N], counts / gids int32 [B, S], v0 [B, S], aggr int32
    [B]) -> the port's bucket tensors on `device`: (ts, values, counts,
    FleetLayout, v0, aggr), each a fresh tensor, values and v0 float64."""
    return (_tensor(ts, np.int32, device), _tensor(values, np.float64, device),
            _tensor(counts, np.int32, device),
            fleet_layout(np.asarray(gids, dtype=np.int32), num_groups, device),
            _tensor(v0, np.float64, device), _tensor(aggr, np.int32, device))


def mesh_from_reference(shape, devices) -> meshlib.Mesh:
    """A reference mesh's layout, its ``mesh.shape`` as a mapping of axis
    name -> size in axis order (``{"series": 8, "time": 1}``, or
    ``{"stream": 8}`` for the fleet's), as the port's Mesh over `devices`
    (one per mesh position; a device may repeat)."""
    names = tuple(shape)
    return meshlib.Mesh(meshlib.device_array(devices).reshape(
        tuple(shape[n] for n in names)), names)


def shards_from_reference(mesh, name: str, a) -> list:
    """One of the reference's row-padded mesh arrays (numpy), named as in
    its partition-rule table, as the port's per-shard tensors: each shard's
    rows on its device (views of one buffer where the shards share a
    device), through the same rule table."""
    return partition.shard_put(mesh, name, np.asarray(a))
