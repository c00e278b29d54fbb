"""The pieces the sharded layer adds to the single-chip pipeline, on the CPU
against the JAX reference: a rank's window of tiles in the binning
(`bin_splats(tile_range=)`, both branches) and the compositor of the
all_to_all exchange (`_composite_pairrec_progressive`, with and without the
converged mode's head counts and carry).

The scene is the reference's tests/test_parallel.py scene made with numpy
(160 splats at 128x128, one time slice; 1,200 for the compositor, so
deepening has slabs to take), projected by the reference; the
port bins and composites the same projection. Tolerances: the binning's
integers exactly (tile_start, overflowed, the window's pairs as per-tile
multisets: pairs tied on one key order arbitrarily in both sorts); the
composite within 1e-5 (the reference's kernel in interpret mode against
the port's plain version, float32 sums in another order).
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from fourdgs_torch.render import pipeline as TP  # noqa: E402
from fourdgs_torch.render import tiles as TT  # noqa: E402
from fourdgs_torch.render.project import Projected  # noqa: E402

W, H = 128, 128


def scene_arrays(n=160, seed=0):
    """The reference's make_scene4d distributions, drawn with numpy."""
    rng = np.random.default_rng(seed)
    pos4 = np.concatenate([rng.uniform(-8, 8, (n, 3)),
                           rng.uniform(0.0, 4.0, (n, 1))], -1)
    pos4[:, 2] -= 30.0
    return {k: v.astype(np.float32) for k, v in dict(
        position4=pos4, quat=rng.standard_normal((n, 4)),
        scale3=rng.uniform(0.5, 2.5, (n, 3)), lifetime=np.full((n,), 2.0),
        fade=np.full((n,), 0.5), velocity=rng.standard_normal((n, 3)) * 0.5,
        color=rng.uniform(0.1, 1.0, (n, 4))).items()}


def _project_ref(n):
    """The reference's projection of the n-splat scene at t = 1.5, in
    front-to-back order (the exact branch's precondition), with p00 /
    p11."""
    from fourdgs.core.camera import Camera
    from fourdgs.parallel.distributed import materialize_splats
    from fourdgs.render.project import project_splats
    from fourdgs.render.sort import front_to_back_order
    from fourdgs.splats.gaussians import mean_in_time_sortkey
    params = {k: jnp.asarray(v) for k, v in scene_arrays(n).items()}
    splats = materialize_splats(params)
    cam = Camera.create(position=(0.0, 0.0, 0.0), width=W, height=H)
    sliced, top = splats.at_time(1.5, 0.0)
    sm = mean_in_time_sortkey(splats.position, splats.cov, 1.5)
    proj = project_splats(sliced.position, sliced.cov, sliced.color, top,
                          cam, sort_mean3=sm)
    order = front_to_back_order(proj.depth)
    proj = jax.tree_util.tree_map(lambda a: a[order], proj)
    pm = np.asarray(cam.proj_matrix())
    return proj, pm[0, 0], pm[1, 1]


@pytest.fixture(scope="module")
def proj_ref():
    return _project_ref(160)


@pytest.fixture(scope="module")
def proj_dense():
    """1,200 splats: tiles of up to ~300 pairs, so deepening has slabs."""
    return _project_ref(1200)


def _tproj(proj):
    return Projected(**{f.name: torch.from_numpy(np.array(getattr(proj,
                                                                  f.name)))
                        for f in dataclasses.fields(proj)})


def _per_tile_pairs(tile_start, pair_tile, pair_splat):
    out = []
    for a, b in zip(tile_start[:-1], tile_start[1:]):
        out.append((sorted(pair_tile[a:b].tolist()),
                    sorted(pair_splat[a:b].tolist())))
    return out


# (lo, n_local): a window from tile 0, one inside, one that runs past the
# last tile (its bounds clip to num_tiles).
_WINDOWS = [(0, 9), (5, 6), (12, 6)]
_BRANCHES = {
    "exact": dict(tile_h=32, tile_w=32, max_tiles_per_splat=16),
    "quantized": dict(tile_h=8, tile_w=128, max_tiles_per_splat=8,
                      quantized_depth=True, depth_prune_cap=64,
                      head_cap=64),
}


@pytest.mark.parametrize("lo,n_local", _WINDOWS)
@pytest.mark.parametrize("branch", sorted(_BRANCHES))
def test_bin_splats_tile_range_matches_reference(proj_ref, branch, lo,
                                                 n_local):
    from fourdgs.render.tiles import bin_splats
    proj, p00, p11 = proj_ref
    kw = _BRANCHES[branch]
    want = bin_splats(proj, p00, p11, W, H, tile_range=(lo, n_local), **kw)
    got = TT.bin_splats(_tproj(proj), torch.tensor(p00), torch.tensor(p11),
                        W, H, tile_range=(lo, n_local), **kw)
    ts = np.asarray(want.tile_start)
    np.testing.assert_array_equal(got.tile_start.numpy(), ts)
    assert got.tile_start.shape == (n_local + 1,)
    assert int(got.overflowed) == int(want.overflowed)
    assert got.pair_splat.shape == tuple(want.pair_splat.shape)
    assert _per_tile_pairs(ts, got.pair_tile.numpy(),
                           got.pair_splat.numpy()) == _per_tile_pairs(
        ts, np.asarray(want.pair_tile), np.asarray(want.pair_splat))
    live = int(ts[-1] - ts[0])
    assert live > 0 and int(ts[0]) == 0
    # Every live pair lies in the window.
    tiles = got.pair_tile.numpy()[:int(ts[-1])]
    assert ((tiles >= lo) & (tiles < lo + n_local)).all()
    # No depth prune under a window, as in the reference.
    assert got.prune_cut is None and want.prune_cut is None
    assert got.head_counts is None and want.head_counts is None


def test_tile_range_windows_cover_the_whole_binning(proj_ref):
    """The windows of a 4-rank mesh hold exactly the pairs of the unwindowed
    binning, tile by tile."""
    proj, p00, p11 = proj_ref
    kw = dict(tile_h=32, tile_w=32, max_tiles_per_splat=16)
    tp = _tproj(proj)
    full = TT.bin_splats(tp, torch.tensor(p00), torch.tensor(p11), W, H,
                         **kw)
    counts = np.diff(full.tile_start.numpy())
    t_total = counts.shape[0]
    tpd = -(-t_total // 4)
    got = []
    for r in range(4):
        b = TT.bin_splats(tp, torch.tensor(p00), torch.tensor(p11), W, H,
                          tile_range=(r * tpd, tpd), **kw)
        got.append(np.diff(b.tile_start.numpy()))
    np.testing.assert_array_equal(np.concatenate(got)[:t_total], counts)


def _pairrec_inputs(proj_ref, cfg, seed):
    """A tile-major (P, 10) record array and its CSR from the reference's
    quantized binning of the scene, plus the tiles' pixel coordinates."""
    from fourdgs.ops.composite_pallas import record_fields
    from fourdgs.render.tiles import bin_splats, tile_pixel_ndc
    proj, p00, p11 = proj_ref
    b = bin_splats(proj, p00, p11, W, H, tile_h=cfg.tile_h,
                   tile_w=cfg.tile_w, max_tiles_per_splat=8,
                   quantized_depth=True)
    ts = np.asarray(b.tile_start)
    rec = np.asarray(record_fields(proj, p00, p11))[:, np.asarray(
        b.pair_splat)[:int(ts[-1])]].T.copy()
    px, py, _ = tile_pixel_ndc(W, H, cfg.tile_h, cfg.tile_w)
    counts = np.diff(ts)
    rng = np.random.default_rng(seed)
    head = np.minimum(counts, rng.integers(0, counts.max() + 1,
                                           counts.shape)).astype(np.int32)
    return (rec, ts.astype(np.int32), np.array(px), np.array(py),
            np.float32(p00), np.float32(p11), head)


@pytest.mark.parametrize("head,carry,passes", [
    (False, False, 2), (True, False, 1), (True, True, 1), (False, True, 2)])
def test_composite_pairrec_progressive_matches_reference(proj_dense, head,
                                                         carry, passes):
    from fourdgs.render import pipeline as RP
    cfg_r = RP.RenderConfig(tile_h=8, tile_w=128, backend="pallas",
                            max_splats_per_tile=128, splat_chunk=128,
                            quantized_depth_sort=True,
                            deepening_passes=passes, deepening_fraction=0.5)
    rec, ts, px, py, p00, p11, hc = _pairrec_inputs(proj_dense, cfg_r,
                                                    passes)
    assert np.diff(ts).max() > 128 * (passes > 1)      # deepening has work
    bg = np.asarray(cfg_r.background, np.float32)
    want = np.asarray(RP._composite_pairrec_progressive(
        jnp.asarray(rec), jnp.asarray(ts), jnp.asarray(px), jnp.asarray(py),
        p00, p11, jnp.asarray(bg), cfg_r,
        head_counts=jnp.asarray(hc) if head else None, return_carry=carry))
    cfg = TP.RenderConfig(**dataclasses.asdict(cfg_r))
    got = TP._composite_pairrec_progressive(
        torch.from_numpy(rec), torch.from_numpy(ts), torch.from_numpy(px),
        torch.from_numpy(py), torch.tensor(p00), torch.tensor(p11),
        torch.from_numpy(bg), cfg,
        head_counts=torch.from_numpy(hc) if head else None,
        return_carry=carry).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert float(np.abs(got).max()) > 0.1


def test_composite_pairrec_progressive_is_differentiable(proj_dense):
    """Records get a cotangent through K1's plain version (K8 on the card)
    and the deepening pass's in-place update."""
    cfg = TP.RenderConfig(tile_h=8, tile_w=128, backend="pallas",
                          max_splats_per_tile=128, deepening_passes=2,
                          deepening_fraction=1.0)
    rec, ts, px, py, p00, p11, _ = _pairrec_inputs(proj_dense, cfg, 0)
    r = torch.from_numpy(rec).requires_grad_(True)
    tiles = TP._composite_pairrec_progressive(
        r, torch.from_numpy(ts), torch.from_numpy(px), torch.from_numpy(py),
        torch.tensor(p00), torch.tensor(p11),
        torch.tensor(cfg.background), cfg)
    tiles[..., :3].sum().backward()
    g = r.grad.numpy()
    assert np.isfinite(g).all() and np.abs(g[:, 9]).max() > 0
    # Records past the first slab of a deep tile got theirs from pass 2.
    deep = np.flatnonzero(np.diff(ts) > 128)
    assert deep.size and np.abs(g[ts[deep[0]] + 128:ts[deep[0] + 1]]).max() > 0
