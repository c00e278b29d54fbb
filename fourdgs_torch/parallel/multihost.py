"""Multi-process, multi-node execution (port of fourdgs/parallel/multihost.py).

One process drives one device; processes meet in a `torch.distributed`
process group over TCP. Launch N processes a node with torchrun, the same
program everywhere:

    torchrun --nnodes M --nproc-per-node N --rdzv-endpoint host0:29500 \\
        -m fourdgs_torch.entry
    # in code:
    from fourdgs_torch.parallel import multihost
    multihost.initialize()                 # torchrun's environment
    mesh = multihost.host_mesh()           # "data" over nodes
    step = distributed.make_sharded_train_step(camera, mesh, opt, cfg)

  * initialize(): `init_process_group` from arguments or torchrun's
    environment (MASTER_ADDR / MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK);
    False when there is none (single process);
  * host_mesh(): a ("data", "tile") mesh whose "data" axis spans nodes and
    whose "tile" axis spans a node's local ranks, so the all_to_all pair
    exchange stays within a node where it can;
  * shard_host_data(): each process already holds its own shard: checks it
    and returns it (nothing global is ever assembled on one host);
  * process_local_slice(): the slice of a global array a process owns.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from fourdgs_torch.parallel.mesh import DATA_AXIS, TILE_AXIS


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None) -> bool:
    """Join the process group. coordinator "host:port" (default: torchrun's
    MASTER_ADDR:MASTER_PORT), num_processes (WORLD_SIZE) and process_id
    (RANK) come from the arguments or the environment; with no coordinator
    anywhere this is a single process and nothing happens (False). backend
    defaults to NCCL with a GPU and gloo without; "cpu:gloo,cuda:nccl"
    serves both. With a GPU the process takes card LOCAL_RANK. Returns
    True once the group is up (also when it already was)."""
    if dist.is_initialized():
        return True
    if coordinator is None and "MASTER_ADDR" in os.environ:
        coordinator = (f"{os.environ['MASTER_ADDR']}:"
                       f"{os.environ.get('MASTER_PORT', '29500')}")
    if coordinator is None:
        return False
    world = (num_processes if num_processes is not None
             else int(os.environ.get("WORLD_SIZE", "1")))
    rank = (process_id if process_id is not None
            else int(os.environ.get("RANK", "0")))
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if "nccl" in backend:
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=world, rank=rank)
    return True


def local_world_size() -> int:
    """Processes of this node (torchrun's LOCAL_WORLD_SIZE; default: the
    whole world, one node)."""
    return int(os.environ.get("LOCAL_WORLD_SIZE", dist.get_world_size()))


def host_mesh(device_type: str = "cuda") -> DeviceMesh:
    """("data", "tile") mesh with the "data" axis spanning nodes: row i
    holds node i's local ranks (torchrun numbers a node's ranks
    contiguously), so splat shards of one "data" row live on one node.
    Single node: (1, world)."""
    world = dist.get_world_size()
    per = local_world_size()
    if world % per:
        raise ValueError(f"{world} ranks do not split into nodes of {per}")
    return DeviceMesh(device_type, torch.arange(world).reshape(world // per,
                                                               per),
                      mesh_dim_names=(DATA_AXIS, TILE_AXIS))


def shard_host_data(local: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """This process's shard of a splat array sharded along axis 0 over the
    flattened mesh (the all_to_all layout): every process holds only its
    own, so this checks that every rank's shard has the same length and
    returns it."""
    n = torch.tensor([local.shape[0], -local.shape[0]], dtype=torch.int64,
                     device=_collective_device(mesh))
    dist.all_reduce(n, op=dist.ReduceOp.MAX)
    if int(n[0]) != local.shape[0] or int(-n[1]) != local.shape[0]:
        raise ValueError(f"shards of unequal length across ranks: this "
                         f"rank {local.shape[0]}, largest {int(n[0])}, "
                         f"smallest {int(-n[1])}")
    return local


def process_local_slice(global_n: int) -> slice:
    """Axis-0 slice of a global splat array that this process owns."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    per = global_n // world
    return slice(rank * per, (rank + 1) * per)


def _collective_device(mesh: DeviceMesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)
