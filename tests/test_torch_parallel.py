"""The port's sharded renders (fourdgs_torch/parallel/distributed.py) on a
(2, 2) mesh of four gloo processes on the CPU, against the JAX reference's
sharded renders on a (2, 2) mesh of its virtual CPU devices.

One module fixture starts the four ranks (tests/_torch_parallel_worker.py,
"render" suite: every case of tests/_torch_parallel_cases.RENDER_CASES,
scenes made with numpy and handed to both sides) and, while they run,
renders the reference in this process. Held:
  * the all_gather exchange (xla and pallas backends) and the all_to_all
    exchange against the reference's sharded frame under the tie tolerance
    (mean < 1e-4, fewer than 1% of pixels above 1e-3: pairs tied on one
    key blend in arbitrary order in each rank's sort, ROADMAP C-R4);
  * the converged mode at tail_depth_beta = 8 tightly against the
    reference with its f32 tail twin monkeypatched in (the same tie
    tolerance), and loosely against it as is (its tail planes are bf16,
    C-R5: mean < 1e-3);
  * the port's sharded frames against its own single-chip frames with the
    reference's bounds (tests/test_parallel.py: 3e-5 for the exchanges;
    the converged mode's aggregate, p99 and seam bounds);
  * the aux counters equal to the reference's, a starved send budget
    counted (pairs_dropped > 0, the same count), required_send_budget
    equal, and every rank holding the same image.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from _torch_parallel_cases import (RENDER_CASES, finish_workers,  # noqa: E402
                                   scene, start_workers)


def _reference(name, params, tail_twin=False):
    from fourdgs.core.camera import Camera
    from fourdgs.ops import tail_pallas as RT
    from fourdgs.parallel import distributed as D
    from fourdgs.parallel.mesh import make_mesh
    from fourdgs.render.pipeline import RenderConfig
    exchange, (w, h), cfg_kw, _, _, t, budget = RENDER_CASES[name]
    cam = Camera.create(position=(0.0, 0.0, 0.0), width=w, height=h)
    cfg = RenderConfig(**cfg_kw)
    mesh = make_mesh(jax.devices()[:4])
    splats = D.materialize_splats({k: jnp.asarray(v)
                                   for k, v in params.items()})
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        if tail_twin:
            mp.setattr(RT, "tail_accumulate",
                       lambda *a, slot_mask=None, interpret=None, **k:
                       RT.tail_accumulate_xla(*a, **k))
        if exchange == "allgather":
            out["img"] = np.asarray(jax.jit(
                lambda s: D.render_splats4d_sharded(s, cam, t, mesh,
                                                    cfg=cfg))(splats))
        else:
            img, aux = jax.jit(lambda s: D.render_splats4d_sharded_alltoall(
                s, cam, t, mesh, cfg=cfg, send_budget=budget,
                return_aux=True))(splats)
            out["img"] = np.asarray(img)
            out["aux"] = {k: int(v) for k, v in aux.items()}
    if name == "alltoall":
        out["required_budget"] = D.required_send_budget(splats, cam, mesh,
                                                        cfg, t=t)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    inputs, scenes = {}, {}
    for name, (_, _, _, n, seed, _, _) in RENDER_CASES.items():
        scenes[name] = scene(n, seed)
        for k, v in scenes[name].items():
            inputs[f"{name}/{k}"] = v
    out_dir = str(tmp_path_factory.mktemp("parallel_render"))
    procs = start_workers("render", inputs, out_dir)
    ref = {name: _reference(name, p) for name, p in scenes.items()}
    ref["converged_twin"] = _reference("converged", scenes["converged"],
                                       tail_twin=True)
    ranks = finish_workers(procs, out_dir)
    return ranks, ref


def _tie_close(got, want):
    err = np.abs(got - want).max(axis=-1)
    assert float(err.mean()) < 1e-4, float(err.mean())
    assert float((err > 1e-3).mean()) < 0.01, float((err > 1e-3).mean())


def test_every_rank_holds_the_image(runs):
    ranks, _ = runs
    for r in ranks:
        assert tuple(r["mesh_shape"]) == (2, 2)
        for name in RENDER_CASES:
            np.testing.assert_array_equal(r[f"{name}/img"],
                                          ranks[0][f"{name}/img"])


@pytest.mark.parametrize("name", ["allgather_xla", "allgather_pallas",
                                  "alltoall"])
def test_sharded_render_matches_reference(runs, name):
    ranks, ref = runs
    got = ranks[0][f"{name}/img"]
    want = ref[name]["img"]
    assert got.shape == want.shape and np.isfinite(got).all()
    _tie_close(got, want)
    assert float(want[..., :3].max()) > 0.1
    # The port's own single-chip frame, at the reference's bound.
    np.testing.assert_allclose(got, ranks[0][f"{name}/single"], atol=3e-5)


@pytest.mark.parametrize("name", ["alltoall", "alltoall_budget2",
                                  "converged"])
def test_alltoall_counters_match_reference(runs, name):
    ranks, ref = runs
    want = ref[name]["aux"]
    for k, v in want.items():
        for r in ranks:
            assert int(r[f"{name}/aux/{k}"]) == v, (name, k)
    if name == "alltoall_budget2":
        assert want["pairs_dropped"] > 0
    else:
        assert want["pairs_dropped"] == want["overflowed"] == 0


def test_required_send_budget_matches_reference(runs):
    ranks, ref = runs
    for r in ranks:
        assert int(r["alltoall/required_budget"]) == \
            ref["alltoall"]["required_budget"] >= 128


def test_converged_beta8_matches_reference(runs):
    ranks, ref = runs
    got = ranks[0]["converged/img"]
    assert np.isfinite(got).all()
    _tie_close(got, ref["converged_twin"]["img"])
    err = np.abs(got - ref["converged"]["img"]).max(axis=-1)
    assert float(err.mean()) < 1e-3
    # The kernel's bf16 planes really differ from the twin's f32 ones.
    assert float(np.abs(ref["converged"]["img"]
                        - ref["converged_twin"]["img"]).max()) > 0


def test_converged_sharded_tracks_single_chip(runs):
    """The reference's own bounds (tests/test_parallel.py): the sharded and
    single-chip converged routes realize one banded-tail approximation with
    other chunks and band samples."""
    ranks, _ = runs
    img_sh = ranks[0]["converged/img"]
    img_ref = ranks[0]["converged/single"]
    d = np.abs(img_sh[..., :3] - img_ref[..., :3])
    assert abs(img_sh[..., :3].mean() - img_ref[..., :3].mean()) \
        < 0.01 * max(img_ref[..., :3].mean(), 0.01) + 1e-4
    assert float(d.mean()) < 0.01
    dm = d.mean(-1)
    assert float(np.percentile(dm, 99)) < 0.05
    th, tw = RENDER_CASES["converged"][2]["tile_h"], \
        RENDER_CASES["converged"][2]["tile_w"]
    ys, xs = np.mgrid[:dm.shape[0], :dm.shape[1]]
    border = ((ys % th == 0) | (ys % th == th - 1)
              | (xs % tw == 0) | (xs % tw == tw - 1))
    assert dm[border].mean() < 2.0 * dm[~border].mean() + 1e-4
