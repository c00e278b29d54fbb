"""The ("data", "tile") device mesh of the sharded layer (port of
fourdgs/parallel/mesh.py).

One process drives one device. The mesh is a
`torch.distributed.device_mesh.DeviceMesh` over the ranks of the default
process group, laid out row-major: rank r sits at ("data" r // T, "tile"
r % T) for a mesh of T "tile" ranks, so the flattened-mesh index of a rank
is its global rank. Axes:

  * "data": splat shards (all_gather path: each "data" row projects its
    shard; the projected records are all-gathered over "data");
  * "tile": image tiles are partitioned over the flattened mesh, every rank
    owning a disjoint window of tiles.

The entry points of parallel/distributed.py take a rank's LOCAL shard of
the splats: `splat_shard` / `splat_shard_flat` cut it from a global array
(the counterparts of the reference's `splat_sharding` /
`splat_sharding_flat` shardings), after `pad_to_multiple` made the length
divide evenly.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh

DATA_AXIS = "data"
TILE_AXIS = "tile"


def balanced_data_parallel(n: int) -> int:
    """The reference's default "data" length for n devices: the largest
    power of two whose square is at most n and that divides n (8 -> 2,
    4 -> 2, 1 -> 1)."""
    dp = 1
    while (dp * 2) ** 2 <= n and n % (dp * 2) == 0:
        dp *= 2
    return dp if n % dp == 0 else 1


def make_mesh(n_devices: Optional[int] = None,
              data_parallel: Optional[int] = None,
              device_type: str = "cuda") -> DeviceMesh:
    """A ("data", "tile") DeviceMesh over the n_devices ranks of the default
    process group (default: all; the group must be initialized, e.g. by
    multihost.initialize, and hold exactly n_devices ranks). data_parallel
    is the "data" length (it must divide n); by default the reference's
    balanced rule: 8 -> (2, 4), 4 -> (2, 2), 1 -> (1, 1). device_type is
    the ranks' device ("cuda" on the card, "cpu" for a gloo group)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(multihost.initialize, or torchrun)")
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if n != world:
        raise ValueError(f"a mesh of {n} devices over a world of {world} "
                         "ranks: one rank drives one device")
    dp = balanced_data_parallel(n) if data_parallel is None else data_parallel
    if dp <= 0 or n % dp:
        raise ValueError(f"data_parallel {dp} does not divide {n}")
    return DeviceMesh(device_type, torch.arange(n).reshape(dp, n // dp),
                      mesh_dim_names=(DATA_AXIS, TILE_AXIS))


def mesh_size(mesh: DeviceMesh) -> int:
    """Ranks of the mesh."""
    return mesh.size(0) * mesh.size(1)


def linear_index(mesh: DeviceMesh) -> int:
    """This rank's index in the flattened mesh (its tile window)."""
    return (mesh.get_local_rank(DATA_AXIS) * mesh.size(1)
            + mesh.get_local_rank(TILE_AXIS))


def pad_to_multiple(x: torch.Tensor, multiple: int, axis: int = 0
                    ) -> torch.Tensor:
    """Zero-pad `axis` to a multiple of `multiple`, so the array divides
    evenly into shards (padded splats are dead)."""
    pad = -x.shape[axis] % multiple
    if pad == 0:
        return x
    widths = [0, 0] * (x.dim() - 1 - axis) + [0, pad]
    return F.pad(x, widths)


def _shard(x: torch.Tensor, n: int, i: int) -> torch.Tensor:
    if x.shape[0] % n:
        raise ValueError(f"axis 0 of length {x.shape[0]} does not divide "
                         f"into {n} shards (pad_to_multiple first)")
    per = x.shape[0] // n
    return x[i * per:(i + 1) * per]


def splat_shard(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """This rank's "data" shard of a global (N, ...) array: sharded along
    axis 0 over "data", replicated over "tile" (the all_gather layout)."""
    return _shard(x, mesh.size(0), mesh.get_local_rank(DATA_AXIS))


def splat_shard_flat(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """This rank's shard of a global (N, ...) array over the FLATTENED mesh
    (every rank a distinct shard: the all_to_all layout)."""
    return _shard(x, mesh_size(mesh), linear_index(mesh))


def replicated(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """A replicated array: every rank holds all of it."""
    del mesh
    return x
