"""Hygiene of the `fourdgs_torch` package: it never imports JAX, its kernel
modules import without nvcc or triton, CPU tensors take the plain versions
without launching (or building) anything, and the parameter hand-over
rejects malformed input."""

import ctypes
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from fourdgs_torch.ops import (composite_cuda, lookup_cuda, pack_cuda,
                               sort_cuda, tail_cuda)
from fourdgs_torch.ops._build import CudaKernel
from fourdgs_torch.splats.packed import (PARAM4D_FIELDS, grads4d_to_numpy,
                                         params4d_from_numpy)

REPO = Path(__file__).resolve().parents[1]
KERNELS = (composite_cuda.COMPOSITE, sort_cuda.ROWSORT,
           lookup_cuda.SAMPLE_BLOCKS, pack_cuda.PACK_RECORD_FIELDS,
           pack_cuda.PACK_META_ROWS, tail_cuda.TAIL_PREPASS,
           tail_cuda.TAIL_ACCUMULATE, composite_cuda.COMPOSITE_BWD,
           tail_cuda.TAIL_ACCUMULATE_BWD, lookup_cuda.APPLY_CUTKEYS,
           sort_cuda.MERGE_TREE, sort_cuda.MERGE_CROSS_STAGE,
           sort_cuda.MERGE_FINISH, sort_cuda.MERGE_LEVELS,
           pack_cuda.PACK_ROWS, pack_cuda.UNPACK_ROWS)


def test_package_never_imports_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import fourdgs_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages("
        "fourdgs_torch.__path__, 'fourdgs_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "assert len(mods) >= 35, mods\n"
        "for m in ('ops.sort_checks', 'io.png', 'io.native', 'io.vdata',\n"
        "          'scenes.models', 'scenes.scenes', 'parallel.distributed',\n"
        "          'parallel.mesh', 'parallel.multihost', 'entry',\n"
        "          'tools.parent_parity', 'tools.validate_kernels',\n"
        "          'tools.eigen_condition',\n"
        "          'train.densify', 'train.trainer', 'render.overlay',\n"
        "          'viewer.cli', 'utils.simplex', 'utils.misc',\n"
        "          'examples.fit_motion',\n"
        "          'examples.render_gallery',\n"
        "          'examples.render_cube_sweep'):\n"
        "    assert 'fourdgs_torch.' + m in mods, (m, mods)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'fourdgs', 'triton', 'bench',\n"
        "                              'validate_kernels'))\n"
        "assert not bad, bad\n"
        "print('ok', len(mods))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def test_cpu_tensors_take_the_plain_versions():
    for k in KERNELS:
        k.launches = 0
    key = torch.arange(4096, dtype=torch.int32)
    lookup_cuda.sample_blocks([key], stride_rows=3, take_rows=2)
    sort_cuda.rowsort_compact(key, key, 8, row_len=16,
                              cut=torch.tensor([5 << 20], dtype=torch.int32))
    rec = torch.zeros((2, 16, 128), requires_grad=True)
    counts = torch.tensor([3, 0], dtype=torch.int32)
    kx = torch.zeros((2, 1, 256))
    carry = composite_cuda.identity_carry(2, 256, device="cpu")
    out = composite_cuda.composite_records(rec, counts, kx, kx, carry)
    out = composite_cuda.composite_records_at(rec[:1], counts[:1],
                                              torch.tensor([1]), kx, kx,
                                              out.clone())
    out.sum().backward()                          # K8's plain version
    f = torch.ones(1000, requires_grad=True)
    pack_cuda.pack_record_fields(*([f] * 10), torch.tensor(2.0),
                                 torch.tensor(3.0), 1024).sum().backward()
    i = torch.zeros(1000, dtype=torch.int32)
    meta = tail_cuda.tail_meta(torch.ones(1000, dtype=torch.bool), i, i, i, i,
                               i, 512)
    cuts = torch.zeros(7, dtype=torch.int32)
    band, rect, mask = tail_cuda.tail_prepass(meta, cuts, 512, 4)
    fields = torch.zeros((10, 1024), requires_grad=True)
    tail_cuda.tail_accumulate(fields, meta, band, rect,
                              torch.zeros(4, dtype=torch.int32),
                              torch.ones(8), 8, 2, 2, 512, 4, 1, 8,
                              slot_mask=mask).sum().backward()   # K9's
    lookup_cuda.apply_cutkeys(key, torch.tensor([5 << 20],
                                                dtype=torch.int32))
    rows = torch.sort(key.reshape(8, 512) % 97, dim=1).values
    sort_cuda.merge_sorted_rows(rows, rows)     # K11, K12, K13's
    g = torch.ones(1000, requires_grad=True)
    pack_cuda.pack_rows([g, g], 1024).sum().backward()      # K14's
    assert rec.grad is not None and f.grad is not None \
        and fields.grad is not None and g.grad is not None
    for k in KERNELS:
        assert k.launches == 0, k.symbol
        assert k._fn is None, k.symbol             # nothing was built


def test_wrappers_refuse_other_devices():
    key = torch.zeros(1024, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        lookup_cuda.sample_blocks([key], stride_rows=1, take_rows=1)
    with pytest.raises(ValueError, match="unsupported device"):
        sort_cuda.rowsort_compact(key, key, 8, row_len=16)
    with pytest.raises(ValueError, match="unsupported device"):
        lookup_cuda.apply_cutkeys(key, key[:4])
    with pytest.raises(ValueError, match="unsupported device"):
        sort_cuda.merge_sorted_rows(key.reshape(4, 256), key.reshape(4, 256))
    with pytest.raises(ValueError, match="unsupported device"):
        sort_cuda.merge_cross_stage(key, key, 256, 1024)
    with pytest.raises(ValueError, match="unsupported device"):
        sort_cuda.merge_finish(key, key, 1024, 512)
    with pytest.raises(ValueError, match="unsupported device"):
        pack_cuda.pack_rows([key], 1024)
    with pytest.raises(ValueError, match="unsupported device"):
        pack_cuda.unpack_rows(key.reshape(4, 256), 200)


def test_wrappers_refuse_mixed_devices():
    """A CUDA launch would read a host pointer: mixed devices must raise
    before any launch."""
    key = torch.zeros(1024, dtype=torch.int32)
    meta_cut = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="device"):
        sort_cuda.rowsort_compact(key, key, 8, row_len=16, cut=meta_cut)
    rec = torch.zeros((2, 16, 128))
    kx = torch.zeros((2, 1, 256))
    carry = composite_cuda.identity_carry(2, 256, device="cpu")
    meta_counts = torch.zeros(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="device"):
        composite_cuda.composite_records(rec, meta_counts, kx, kx, carry)
    with pytest.raises(ValueError, match="device"):
        lookup_cuda.apply_cutkeys(key, meta_cut)
    with pytest.raises(ValueError, match="device"):
        sort_cuda.merge_tree(key, key.to("meta"), 256)
    with pytest.raises(ValueError, match="device"):
        pack_cuda.pack_rows([key, key.to("meta")], 1024)


def test_default_device_is_the_card():
    """Entry points that make tensors make them on the card unless the
    caller names a device; held here without touching a device."""
    import inspect

    import fourdgs_torch
    from fourdgs_torch.core.camera import Camera
    from fourdgs_torch.render.tiles import tile_pixel_ndc
    from fourdgs_torch.scenes.cube import build_cube_scene
    from fourdgs_torch.splats.gaussians import (Splats3D, Splats4D,
                                                splats2d_from_numpy,
                                                splats3d_from_numpy,
                                                splats4d_from_numpy)
    from fourdgs_torch.splats.packed import params4d_from_arrays
    from fourdgs_torch.parallel.distributed import splats_to_params
    from fourdgs_torch.train.densify import init_state
    from fourdgs_torch.train.trainer import load_checkpoint
    from fourdgs_torch.entry import dryrun_multichip
    from fourdgs_torch.parallel.mesh import make_mesh
    from fourdgs_torch.parallel.multihost import host_mesh
    assert fourdgs_torch.default_device().type == "cuda"
    assert fourdgs_torch.resolve_device(None) == fourdgs_torch.default_device()
    assert fourdgs_torch.resolve_device("cpu") == torch.device("cpu")
    for fn in (Camera.create, build_cube_scene, params4d_from_numpy,
               tile_pixel_ndc, composite_cuda.identity_carry,
               Splats3D.from_params, Splats4D.from_motion,
               Splats4D.from_isoclinic, params4d_from_arrays,
               splats2d_from_numpy, splats3d_from_numpy,
               splats4d_from_numpy, splats_to_params, init_state,
               load_checkpoint):
        assert inspect.signature(fn).parameters["device"].default is None, fn
    # The sharded layer's meshes and dry run default to the card too.
    for fn in (make_mesh, host_mesh):
        assert inspect.signature(fn).parameters[
            "device_type"].default == "cuda", fn
    assert inspect.signature(dryrun_multichip).parameters[
        "device"].default == "cuda"


def test_identity_carry_goes_to_the_default_device(monkeypatch):
    """Without `device` the first slab's carry is made on default_device()
    (the meta device stands in for the card here); with one, there."""
    import fourdgs_torch
    monkeypatch.setattr(fourdgs_torch, "default_device",
                        lambda: torch.device("meta"))
    carry = composite_cuda.identity_carry(3, 16)
    assert carry.device.type == "meta"
    assert carry.shape == (3, 8, 16) and carry.dtype == torch.float32
    cpu = composite_cuda.identity_carry(3, 16, device="cpu")
    assert cpu.device.type == "cpu"
    assert (cpu[:, 4] == 1).all() and cpu[:, :4].abs().sum() == 0
    assert cpu[:, 5:].abs().sum() == 0


def test_splat_makers_go_to_the_default_device(monkeypatch):
    """The splat makers given numpy arrays, as the reference's scene
    generators hand them, make every tensor (the covariance too) on
    default_device() (the meta device stands in for the card here), in
    float32 as `jnp.asarray` does; given tensors they leave them where they
    are and put the arrays beside them; a named device takes everything."""
    import fourdgs_torch
    from fourdgs_torch.splats.gaussians import Splats3D, Splats4D
    from fourdgs_torch.splats.packed import params4d_from_arrays
    monkeypatch.setattr(fourdgs_torch, "default_device",
                        lambda: torch.device("meta"))
    rng = np.random.default_rng(0)
    n = 5
    pos4 = rng.random((n, 4)).astype(np.float32)
    quat, scale3, vel = rng.random((n, 4)), rng.random((n, 3)), rng.random(
        (n, 3))
    life, fade = np.ones(n), np.full(n, 0.5)
    color = rng.random((n, 4)).astype(np.float32)
    made = {
        "from_params": Splats3D.from_params(pos4[:, :3], quat, scale3, color),
        "from_motion": Splats4D.from_motion(pos4, quat, scale3, life, fade,
                                            vel, color),
        "from_isoclinic": Splats4D.from_isoclinic(pos4, quat, quat[::-1],
                                                  rng.random((n, 4)), color),
    }
    for name, s in made.items():
        for f in ("position", "color", "cov"):
            t = getattr(s, f)
            assert t.device.type == "meta" and t.dtype == torch.float32, (
                name, f)
    packed = params4d_from_arrays(pos4, quat, scale3, 1.0, 0.5, vel, color)
    assert set(packed) == set(PARAM4D_FIELDS)
    assert all(v.device.type == "meta" and v.shape == (n,)
               for v in packed.values())
    beside = Splats4D.from_motion(torch.from_numpy(pos4), quat, scale3, life,
                                  fade, vel, color)
    assert beside.cov.device.type == "cpu"
    named = Splats4D.from_motion(pos4, quat, scale3, life, fade, vel, color,
                                 device="cpu")
    assert named.cov.device.type == "cpu"
    assert named.cov.dtype == torch.float32
    cpu = params4d_from_arrays(pos4, quat, scale3, 1.0, 0.5, vel, color,
                               device="cpu")
    np.testing.assert_array_equal(cpu["pt"].numpy(), pos4[:, 3])
    assert all(v.device.type == "cpu" for v in cpu.values())


def _params(n=7):
    rng = np.random.default_rng(0)
    return {k: rng.random(n).astype(np.float32) for k in PARAM4D_FIELDS}


def test_params4d_from_numpy_round_trip():
    p = _params()
    t = params4d_from_numpy(p, "cpu")
    assert set(t) == set(PARAM4D_FIELDS)
    for k in PARAM4D_FIELDS:
        assert t[k].dtype == torch.float32
        np.testing.assert_array_equal(t[k].numpy(), p[k])


@pytest.mark.parametrize("fault", ["missing", "extra", "dtype", "length",
                                   "ndim"])
def test_params4d_from_numpy_rejects(fault):
    p = _params()
    if fault == "missing":
        del p["fade"]
    elif fault == "extra":
        p["spin"] = p["px"]
    elif fault == "dtype":
        p["qw"] = p["qw"].astype(np.float64)
    elif fault == "length":
        p["cr"] = p["cr"][:-1]
    else:
        p["sx"] = p["sx"][:, None]
    with pytest.raises(ValueError):
        params4d_from_numpy(p, "cpu")


def test_launcher_passes_live_tensors():
    """A pointer taken from a temporary copy that is freed before the launch
    can alias the block of the next argument's copy (ROADMAP Queue C,
    C-P1). The launcher takes the tensors themselves, so at the launch each
    pointer still holds its own tensor's data; None is a null pointer."""
    seen = []

    def entry(a, b, c, n, stream):
        seen.append([ctypes.c_float.from_address(p).value for p in (a, b)]
                    + [c, n, stream])
        return 0
    k = CudaKernel("none.cu", "entry", [ctypes.c_void_p] * 3 + [ctypes.c_int])
    k._fn = entry
    x = torch.ones(64)
    k(x.clone(), (x + 1.0).clone(), None, 5, stream=7)
    assert seen == [[1.0, 2.0, None, 5, 7]] and k.launches == 1
    k._fn = lambda *args: 1                        # a refused launch
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        k(x, x, None, 5, stream=7)
    assert k.launches == 1


class _OnDevice(torch.Tensor):
    """A CPU tensor that reports another device: the launcher's guard is
    held without a card."""
    where = torch.device("cuda", 1)

    @property
    def device(self):
        return self.where


def test_launcher_takes_the_tensors_device(monkeypatch):
    """A kernel launches on its tensors' device, whatever the current one
    is (the entries that size their grid from cudaGetDevice then read that
    card); tensors on two devices raise before anything is launched."""
    from fourdgs_torch.ops import _build
    entered, seen = [], []

    class Ctx:
        def __init__(self, dev):
            self.dev = dev

        def __enter__(self):
            entered.append(self.dev)

        def __exit__(self, *a):
            entered.append("exit")
    monkeypatch.setattr(_build.torch.cuda, "device", Ctx)
    k = CudaKernel("none.cu", "entry", [ctypes.c_void_p] * 2)
    k._fn = lambda *args: seen.append(args) or 0
    x = torch.ones(8)
    a, b = x.as_subclass(_OnDevice), x.clone().as_subclass(_OnDevice)
    k(a, b, stream=3)
    assert entered == [torch.device("cuda", 1), "exit"] and len(seen) == 1
    assert _build.launch_device([a, None, 4]) == torch.device("cuda", 1)
    assert _build.launch_device([None, 4]) is None
    # CPU tensors (the tests' fakes) enter no device context.
    k(x, x, stream=3)
    assert len(entered) == 2 and len(seen) == 2 and k.launches == 2
    with pytest.raises(ValueError, match="span devices"):
        k(a, x, stream=3)
    meta = torch.empty(4, device="meta")
    with pytest.raises(ValueError, match="span devices"):
        k(x, meta, stream=3)
    assert len(seen) == 2 and k.launches == 2      # nothing was launched


def test_grads4d_to_numpy():
    t = {k: v.requires_grad_(True)
         for k, v in params4d_from_numpy(_params(), "cpu").items()}
    sum((i + 1) * v.sum() for i, v in enumerate(t.values())).backward()
    g = grads4d_to_numpy(t)
    assert list(g) == list(PARAM4D_FIELDS)
    for i, k in enumerate(t):
        np.testing.assert_array_equal(g[k], np.full(7, i + 1, np.float32))
    t["px"].grad = None
    with pytest.raises(ValueError, match="px"):
        grads4d_to_numpy(t)


def test_cube_scene_fields_own_their_storage():
    """A scene handed straight to a grad step: were two fields one tensor
    (as pt, vx, vy, vz once were), each would read the sum of their
    gradients. No two fields share storage, and the gradients of a frame
    rendered from the dict itself equal those of cloned leaves."""
    from fourdgs_torch.core.camera import Camera
    from fourdgs_torch.render.autoconfig import auto_render_config
    from fourdgs_torch.render.pipeline import render_params4d_packed
    from fourdgs_torch.scenes.cube import CUBE_CAMERA, build_cube_scene
    n, w, h = 1500, 128, 64
    scene = build_cube_scene(n, seed=2, device="cpu")
    assert set(scene) == set(PARAM4D_FIELDS)
    ptrs = [v.untyped_storage().data_ptr() for v in scene.values()]
    assert len(set(ptrs)) == len(ptrs)
    cam = Camera.create(**CUBE_CAMERA, width=w, height=h, device="cpu")
    cfg = auto_render_config(n, w, h, converged=False)
    wts = torch.linspace(0.5, 1.5, h * w).reshape(h, w, 1)

    def grads(params):
        for v in params.values():
            v.requires_grad_(True)
        img = render_params4d_packed(params, cam, 0.37, cfg=cfg)
        (img[..., :3] * wts).sum().backward()
        return grads4d_to_numpy(params)
    want = grads({k: v.clone() for k, v in scene.items()})
    got = grads(scene)
    for k in PARAM4D_FIELDS:
        np.testing.assert_array_equal(got[k], want[k])
    zero_fields = [got[k] for k in ("pt", "vx", "vy", "vz")]
    assert all(np.abs(g).max() > 0 for g in zero_fields)
    for i in range(4):
        for j in range(i + 1, 4):
            assert not np.array_equal(zero_fields[i], zero_fields[j])
