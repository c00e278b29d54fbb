"""One rank of the port's sharded layer on the CPU, for
tests/test_torch_parallel.py and tests/test_torch_parallel_train.py.

    python tests/_torch_parallel_worker.py SUITE INPUT.npz OUT_DIR

with torchrun's environment (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK,
LOCAL_RANK, LOCAL_WORLD_SIZE) set by the test: the process joins a gloo
group through multihost.initialize(), runs every case of SUITE ("render" or
"train") on the ("data", "tile") mesh and writes its results to
OUT_DIR/rank<RANK>.npz. Imports no JAX."""

import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from _torch_parallel_cases import (FIT_CASE, MULTIHOST_CAMERA, RENDER_CASES,
                                   SELF_TRAIN_CASES, SMALL, TRAIN_CASES)
from fourdgs_torch.core.camera import Camera
from fourdgs_torch.parallel import distributed as D
from fourdgs_torch.parallel import multihost
from fourdgs_torch.parallel.mesh import (make_mesh, mesh_size,
                                         pad_to_multiple, splat_shard,
                                         splat_shard_flat)
from fourdgs_torch.render import pipeline as TP


def _camera(wh):
    return Camera.create(position=(0.0, 0.0, 0.0), width=wh[0],
                         height=wh[1], device="cpu")


def _params(data, prefix):
    return {k[len(prefix):]: torch.from_numpy(data[k])
            for k in data.files if k.startswith(prefix)}


def _shard(params, mesh, exchange):
    """My shard of the padded global dict (over "data" or the flattened
    mesh)."""
    if exchange == "allgather":
        return {k: splat_shard(pad_to_multiple(v, mesh.size(0)), mesh)
                for k, v in params.items()}
    return {k: splat_shard_flat(pad_to_multiple(v, mesh_size(mesh)), mesh)
            for k, v in params.items()}


def render_suite(mesh, data):
    out = {}
    rank = dist.get_rank()
    for name, (exchange, wh, cfg_kw, _, _, t, budget) in \
            RENDER_CASES.items():
        cam = _camera(wh)
        cfg = TP.RenderConfig(**cfg_kw)
        params = _params(data, name + "/")
        splats = D.materialize_splats(_shard(params, mesh, exchange))
        with torch.no_grad():
            if exchange == "allgather":
                img = D.render_splats4d_sharded(splats, cam, t, mesh, cfg=cfg)
                aux = {}
            else:
                img, aux = D.render_splats4d_sharded_alltoall(
                    splats, cam, t, mesh, cfg=cfg, send_budget=budget,
                    return_aux=True)
            out[f"{name}/img"] = img.numpy()
            for k, v in aux.items():
                out[f"{name}/aux/{k}"] = np.asarray(int(v))
            if rank == 0:
                single = TP.render_splats4d(D.materialize_splats(params),
                                            cam, t, cfg=cfg)
                out[f"{name}/single"] = single.numpy()
            if name == "alltoall":
                out[f"{name}/required_budget"] = np.asarray(
                    D.required_send_budget(splats, cam, mesh, cfg, t=t))
    return out


def _grads(params, mesh, exchange, cam, cfg, t, target):
    shard = {k: v.clone().requires_grad_(True)
             for k, v in _shard(params, mesh, exchange).items()}
    loss_fn = D.make_sharded_loss(cam, mesh, cfg, exchange=exchange)
    loss = loss_fn(shard, target, t)
    loss.backward()
    return loss, {k: v.grad for k, v in shard.items()}


def _single_chip_grads(params, cam, cfg, t, target):
    """The single-chip loss and gradients of the same L2 (the reference's
    unsharded comparison in tests/test_parallel.py)."""
    p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    img = TP.render_splats4d(D.materialize_splats(p), cam, t, cfg=cfg)
    loss = ((img[..., :3] - target[..., :3]) ** 2).sum() / (
        cam.height * cam.width * 3)
    loss.backward()
    return loss, {k: v.grad for k, v in p.items()}


def train_suite(mesh, data):
    out = {}
    for name, (exchange, wh, cfg_kw, _, _, t, _) in {
            **TRAIN_CASES, **SELF_TRAIN_CASES}.items():
        cam = _camera(wh)
        cfg = TP.RenderConfig(**cfg_kw)
        target = torch.zeros((cam.height, cam.width, 4))
        params = _params(data, name + "/")
        loss, grads = _grads(params, mesh, exchange, cam, cfg, t, target)
        out[f"{name}/loss"] = np.asarray(float(loss))
        for k, g in grads.items():
            out[f"{name}/grad/{k}"] = g.numpy()
        if name in SELF_TRAIN_CASES and dist.get_rank() == 0:
            loss, grads = _single_chip_grads(params, cam, cfg, t, target)
            out[f"{name}/single_loss"] = np.asarray(float(loss))
            for k, g in grads.items():
                out[f"{name}/single_grad/{k}"] = g.numpy()
    # fit_sharded from a starved send budget.
    wh, cfg_kw, _, _, t, steps, check_every, budget, tval = FIT_CASE
    cam = _camera(wh)
    msgs = []
    _, losses, final = D.fit_sharded(
        _shard(_params(data, "fit/"), mesh, "alltoall"), cam, mesh,
        torch.full((cam.height, cam.width, 4), tval), steps=steps, t=t,
        cfg=TP.RenderConfig(**cfg_kw), send_budget=budget,
        check_every=check_every, log=msgs.append)
    out["fit/losses"] = np.asarray(losses)
    out["fit/budget"] = np.asarray(final)
    out["fit/widened"] = np.asarray(len(msgs))
    # Multi-"node": the host mesh of torchrun's environment, one train step
    # of the all_to_all exchange on the reference's tiny scene.
    hmesh = multihost.host_mesh(device_type="cpu")
    out["mh/mesh_shape"] = np.asarray(tuple(hmesh.mesh.shape))
    cam = _camera(MULTIHOST_CAMERA)
    cfg = TP.RenderConfig(**SMALL)
    local = multihost.shard_host_data(
        _shard(_params(data, "mh/"), hmesh, "alltoall")["position4"], hmesh)
    assert local.shape[0] * mesh_size(hmesh) >= data["mh/position4"].shape[0]
    shard = {k: v.clone().requires_grad_(True)
             for k, v in _shard(_params(data, "mh/"), hmesh,
                                "alltoall").items()}
    step = D.make_sharded_train_step(cam, hmesh, D.adam(shard, 1e-3), cfg,
                                     exchange="alltoall")
    out["mh/loss"] = np.asarray(float(step(
        shard, torch.zeros((cam.height, cam.width, 4)), 0.5)))
    sl = multihost.process_local_slice(64)
    out["mh/slice"] = np.asarray([sl.start, sl.stop])
    # The dry run of the three modes.
    from fourdgs_torch.entry import dryrun_multichip
    dry = dryrun_multichip(dist.get_world_size(), device="cpu")
    for k, v in dry.items():
        out[f"dry/{k}"] = np.asarray(v)
    return out


def main():
    suite, inp, out_dir = sys.argv[1:4]
    torch.set_num_threads(1)
    assert multihost.initialize(backend="gloo")
    mesh = make_mesh(device_type="cpu")
    data = np.load(inp)
    res = {"render": render_suite, "train": train_suite}[suite](mesh, data)
    res["mesh_shape"] = np.asarray(tuple(mesh.mesh.shape))
    np.savez(os.path.join(out_dir, f"rank{dist.get_rank()}.npz"), **res)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
