"""The cases of tests/test_torch_parallel.py and
tests/test_torch_parallel_train.py: plain dicts of camera, config and scene
that both the JAX reference (in the test process) and the port's worker
processes (tests/_torch_parallel_worker.py, which imports no JAX) read, and
the numpy scene both render."""

import numpy as np

# The reference's tests/test_parallel.py configurations.
CFG = dict(max_splats_per_tile=256, splat_chunk=32)
CFGP = dict(tile_h=8, tile_w=128, backend="pallas", max_splats_per_tile=256,
            splat_chunk=128)
CFGQ = dict(CFGP, quantized_depth_sort=True, max_tiles_per_splat=8)
CONV = dict(tile_h=8, tile_w=128, backend="pallas", max_splats_per_tile=128,
            max_tiles_per_splat=8, splat_chunk=64, quantized_depth_sort=True,
            depth_prune_cap=128, depth_prune_safety=1.2,
            deepening_fraction=1.0, tail_mode="banded", tail_bands=4,
            tail_block=(4, 16), tail_chunk=512, tail_depth_beta=8.0)
FIT = dict(tile_h=8, tile_w=128, backend="pallas", max_splats_per_tile=128,
           max_tiles_per_splat=8, splat_chunk=64, quantized_depth_sort=True,
           deepening_fraction=1.0)

# name: (exchange, (width, height), cfg, n, seed, t, send_budget)
RENDER_CASES = {
    "allgather_xla": ("allgather", (96, 64), CFG, 160, 0, 1.5, None),
    "allgather_pallas": ("allgather", (128, 128), CFGP, 160, 7, 1.5, None),
    "alltoall": ("alltoall", (128, 128), CFGQ, 160, 21, 1.5, None),
    "alltoall_budget2": ("alltoall", (128, 128), CFGQ, 256, 24, 1.0, 2),
    "converged": ("alltoall", (256, 128), CONV, 1024, 31, 1.0, None),
}
# The dry run's configurations (__graft_entry__.dryrun_multichip) at its
# 64x32 camera: the reference compiles their sharded gradients in seconds.
SMALL = dict(max_splats_per_tile=128, splat_chunk=32, max_tiles_per_splat=8)
SMALLP = dict(SMALL, tile_h=8, tile_w=128, backend="pallas")
SMALLQ = dict(SMALLP, quantized_depth_sort=True)
DRY_CONV = dict(CONV, tail_chunk=256)
TRAIN_CASES = {
    "allgather_xla": ("allgather", (64, 32), SMALL, 256, 2, 1.0, None),
    "alltoall": ("alltoall", (128, 32), SMALLQ, 256, 23, 1.0, None),
    "converged": ("alltoall", (128, 32), DRY_CONV, 256, 33, 1.0, None),
}
# Held against the port's own single-chip gradients only: the reference's
# gradient of its all_gather pallas path did not compile in ten minutes
# here, even with its kernels' XLA twins in place.
SELF_TRAIN_CASES = {
    "allgather_pallas": ("allgather", (128, 32), SMALLP, 256, 8, 1.0, None),
}
# fit_sharded from a starved budget: (camera, cfg, n, seed, t, steps,
# check_every, send_budget, target value).
FIT_CASE = ((128, 64), FIT, 256, 44, 1.0, 2, 2, 2, 0.02)
MULTIHOST_CAMERA = (64, 32)
N_RANKS = 4


def scene(n, seed):
    """The reference's make_scene4d distributions (tests/test_parallel.py),
    drawn with numpy: the trainer's parameter dict as float32 arrays."""
    rng = np.random.default_rng(seed)
    pos4 = np.concatenate([rng.uniform(-8, 8, (n, 3)),
                           rng.uniform(0.0, 4.0, (n, 1))], -1)
    pos4[:, 2] -= 30.0
    return {k: np.asarray(v, np.float32) for k, v in dict(
        position4=pos4, quat=rng.standard_normal((n, 4)),
        scale3=rng.uniform(0.5, 2.5, (n, 3)), lifetime=np.full((n,), 2.0),
        fade=np.full((n,), 0.5), velocity=rng.standard_normal((n, 3)) * 0.5,
        color=rng.uniform(0.1, 1.0, (n, 4))).items()}


def start_workers(suite, inputs, out_dir, local_world=None):
    """Start the N_RANKS processes of tests/_torch_parallel_worker.py on the
    numpy `inputs` (written to out_dir/inputs.npz) with torchrun's
    environment for a gloo group on a free localhost port; local_world
    splits them into "nodes" of that many ranks. Returns the processes;
    finish_workers waits for them."""
    import os
    import socket
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    np.savez(os.path.join(out_dir, "inputs.npz"), **inputs)
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    base = {k: v for k, v in os.environ.items()
            if not k.startswith(("JAX_", "XLA_"))}
    per = local_world or N_RANKS
    procs = []
    for r in range(N_RANKS):
        env = dict(base, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   WORLD_SIZE=str(N_RANKS), RANK=str(r),
                   LOCAL_RANK=str(r % per), LOCAL_WORLD_SIZE=str(per),
                   OMP_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join([str(root),
                                               str(root / "tests")]))
        procs.append(subprocess.Popen(
            [sys.executable, str(root / "tests" / "_torch_parallel_worker.py"),
             suite, os.path.join(out_dir, "inputs.npz"), out_dir],
            env=env, cwd=root, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    return procs


def finish_workers(procs, out_dir, timeout=300):
    """Wait for the workers; every rank's results as a dict of arrays."""
    import os
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, f"worker failed:\n{out}\n{err}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return [dict(np.load(os.path.join(out_dir, f"rank{r}.npz")))
            for r in range(N_RANKS)]
