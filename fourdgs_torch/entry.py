"""Entry points of the port (counterpart of the reference's
`__graft_entry__.py`).

entry()             -> (fn, example_args): the forward render step of the
                       flagship model (a 4D Gaussian scene through the tiled
                       pipeline) on one device.
dryrun_multichip(n) -> one full sharded training step (render -> L2 ->
                       backward -> Adam) on an n-device ("data", "tile")
                       mesh at tiny shapes, in each of the three modes: the
                       all_gather exchange, the all_to_all exchange and the
                       converged (banded-tail) mode through the all_to_all
                       exchange, at tail_depth_beta = 8.

Run it on every card of a node (one process a card):

    torchrun --nproc-per-node N -m fourdgs_torch.entry

The run uses the world torchrun gives; it raises when the node has fewer
cards than ranks, and it never substitutes the CPU. (The tests run
dryrun_multichip(4, device="cpu") in four gloo processes.)
"""

from __future__ import annotations

import socket

import torch
import torch.distributed as dist


def _tiny_scene(n: int = 512, seed: int = 0, device=None):
    """The reference's tiny scene distributions (`__graft_entry__._tiny_scene`)
    drawn from a torch.Generator seeded with `seed` on the CPU (other
    numbers than jax.random's), then moved to `device` (None: the card)."""
    from fourdgs_torch import resolve_device
    gen = torch.Generator().manual_seed(seed)

    def uniform(shape, lo, hi):
        return torch.rand(shape, generator=gen) * (hi - lo) + lo
    pos4 = torch.cat([uniform((n, 3), -8.0, 8.0), uniform((n, 1), 0.0, 4.0)],
                     dim=-1)
    pos4[:, 2] -= 30.0
    params = dict(
        position4=pos4,
        quat=torch.randn((n, 4), generator=gen),
        scale3=uniform((n, 3), 0.5, 2.0),
        lifetime=torch.full((n,), 2.0),
        fade=torch.full((n,), 0.5),
        velocity=torch.randn((n, 3), generator=gen) * 0.3,
        color=uniform((n, 4), 0.1, 1.0),
    )
    dev = resolve_device(device)
    return {k: v.to(dev) for k, v in params.items()}


def entry(device=None):
    """Forward step on the flagship model: time-sliced 4D Gaussians through
    projection, binning, sort and the tiled ordered composite. Returns
    (forward(params, t) -> (256, 256, 4) image, (params, t))."""
    from fourdgs_torch.core.camera import Camera
    from fourdgs_torch.parallel.distributed import materialize_splats
    from fourdgs_torch.render.pipeline import RenderConfig, render_splats4d

    params = _tiny_scene(n=512, device=device)
    dev = params["position4"].device
    camera = Camera.create(position=(0.0, 0.0, 0.0), width=256, height=256,
                           device=dev)
    cfg = RenderConfig(max_splats_per_tile=512, splat_chunk=64)

    def forward(params, t):
        return render_splats4d(materialize_splats(params), camera, t,
                               cfg=cfg)

    return forward, (params, torch.tensor(1.0, device=dev))


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def dryrun_multichip(n_devices: int, device: str = "cuda") -> dict:
    """One sharded training step in each mode on an n_devices mesh of
    `device` ("cuda": one card a rank, NCCL; "cpu": gloo). Every rank of
    the process group calls it; a single process (n_devices 1) with no
    group makes its own on a free localhost port and ends it after. Raises
    when the world is not n_devices ranks or fewer than that many cards
    exist. Returns {mode: loss}."""
    from fourdgs_torch.core.camera import Camera
    from fourdgs_torch.parallel import distributed as D
    from fourdgs_torch.parallel.mesh import (make_mesh, mesh_size,
                                             pad_to_multiple, splat_shard,
                                             splat_shard_flat)
    from fourdgs_torch.render.pipeline import RenderConfig

    if device not in ("cuda", "cpu"):
        raise ValueError(f"unknown device type {device!r}")
    if device == "cuda" and torch.cuda.device_count() < n_devices:
        raise RuntimeError(f"need {n_devices} cuda devices, have "
                           f"{torch.cuda.device_count()}")
    own_group = False
    if not dist.is_initialized():
        if n_devices != 1:
            raise RuntimeError(f"dryrun_multichip({n_devices}) runs in "
                               f"{n_devices} processes (torchrun)")
        dist.init_process_group("nccl" if device == "cuda" else "gloo",
                                init_method=f"tcp://127.0.0.1:{_free_port()}",
                                world_size=1, rank=0)
        own_group = True
    try:
        if dist.get_world_size() != n_devices:
            raise RuntimeError(f"dryrun_multichip({n_devices}) in a world of "
                               f"{dist.get_world_size()} ranks")
        if device == "cuda":
            dev = torch.device("cuda", torch.cuda.current_device())
        else:
            dev = torch.device("cpu")
        mesh = make_mesh(n_devices, device_type=device)
        rank = dist.get_rank()
        if rank == 0:
            print(f"dryrun_multichip({n_devices}): platform={device} "
                  f"x{n_devices}", flush=True)
        camera = Camera.create(position=(0.0, 0.0, 0.0), width=64, height=32,
                               device=dev)
        cfg = RenderConfig(max_splats_per_tile=128, splat_chunk=32,
                           max_tiles_per_splat=8)
        # The flagship converged mode (banded tail) as a training step,
        # with the within-band depth weight.
        cfg_conv = RenderConfig(tile_h=8, tile_w=128, backend="pallas",
                                max_splats_per_tile=128,
                                max_tiles_per_splat=8, splat_chunk=32,
                                quantized_depth_sort=True,
                                depth_prune_cap=128, depth_prune_safety=1.2,
                                deepening_fraction=1.0, tail_mode="banded",
                                tail_bands=4, tail_block=(4, 16),
                                tail_chunk=256, tail_depth_beta=8.0)
        n = 256 * max(1, n_devices // 2)
        params = {k: pad_to_multiple(v, mesh_size(mesh))
                  for k, v in _tiny_scene(n=n, seed=1, device=dev).items()}
        target = torch.zeros((camera.height, camera.width, 4), device=dev)
        losses = {}
        for label, exchange, shard, c in (
                ("allgather", "allgather", splat_shard, cfg),
                ("alltoall", "alltoall", splat_shard_flat, cfg),
                ("alltoall-converged", "alltoall", splat_shard_flat,
                 cfg_conv)):
            p = {k: shard(v, mesh).clone().requires_grad_(True)
                 for k, v in params.items()}
            step = D.make_sharded_train_step(camera, mesh, D.adam(p, 1e-3),
                                             c, exchange=exchange)
            loss = float(step(p, target, 0.5))
            if not all(bool(torch.isfinite(v).all()) for v in p.values()):
                raise RuntimeError(f"{label}: parameters not finite")
            if not torch.isfinite(torch.tensor(loss)):
                raise RuntimeError(f"{label}: loss {loss}")
            losses[label] = loss
            if rank == 0:
                print(f"dryrun_multichip({n_devices}): mesh="
                      f"{dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))} "
                      f"mode={label} loss={loss:.6f} ok", flush=True)
        return losses
    finally:
        if own_group:
            dist.destroy_process_group()


def main() -> None:
    from fourdgs_torch.parallel import multihost
    if not torch.cuda.is_available():
        raise RuntimeError("fourdgs_torch.entry runs on the card: no CUDA "
                           "device")
    multihost.initialize()
    world = dist.get_world_size() if dist.is_initialized() else 1
    if not dist.is_initialized() or dist.get_rank() == 0:
        fn, args = entry()
        out = fn(*args)
        torch.cuda.synchronize()
        print("entry:", tuple(out.shape), out.dtype, flush=True)
    dryrun_multichip(world)
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
