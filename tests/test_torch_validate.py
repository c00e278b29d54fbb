"""Parity of the port's certification tool
(`fourdgs_torch/tools/validate_kernels.py`) with the reference's
`validate_kernels.py` on the CPU, where the port runs its kernels' plain
versions; and the footprint eigenvector behind ROADMAP C-R15.

Inputs go from the reference to the port through numpy: the record
fixtures (bit-equal), the float64 ground truth (computed by the reference in
a subprocess with JAX_ENABLE_X64=1, as its `main` does), the pipeline
check's 3,000-splat scene and loss weights, and the tail-parity scene
(`bench.build_cube_scene`). The reference's converged frame runs with
`pack_records(pack8=False)` (C-R1) and, for time, with plain-jnp forms of
its Pallas kernels: the XLA twins of its composite and tail kernels
(`_xla_composite_from_records`, `tail_accumulate_xla`: the functions its
kernels are tested against; the twin's f32 tail planes also avoid C-R5's
bf16 rounding), its XLA prepass and a jnp row sort.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import validate_kernels as RV  # noqa: E402
from fourdgs_torch.ops import sort_cuda  # noqa: E402
from fourdgs_torch.ops import tail_cuda as TL  # noqa: E402
from fourdgs_torch.render.project import eigen2x2_scalar  # noqa: E402
from fourdgs_torch.tools import eigen_condition as ET  # noqa: E402
from fourdgs_torch.tools import validate_kernels as V  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TAIL_20K = dict(n=20_000, width=512, height=256, seed=2,
                deepening_passes=4)


# ---------------------------------------------------------------------------
# records
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("p,seed", RV.FIXTURES)
def test_build_fixture_is_the_reference_bit_for_bit(p, seed):
    want, got = RV.build_fixture(p, seed), V.build_fixture(p, seed)
    assert V.FIXTURES == RV.FIXTURES and set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


_REF_F64 = """
import sys
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
import numpy as np
from fourdgs.ops.composite_pallas import _xla_composite_from_records
from validate_kernels import build_fixture
p, seed, path = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
fx = build_fixture(p, seed)
f64 = lambda x: jnp.asarray(x, jnp.float64)
counts = jnp.asarray(fx["counts"])
kx, ky = f64(fx["kx"]), f64(fx["ky"])
def vjp(r, c, g):
    fwd, pull = jax.vjp(
        lambda r, c: _xla_composite_from_records(r, counts, kx, ky, c), r, c)
    return (fwd,) + pull(g)
fwd, d_rec, d_car = jax.jit(vjp)(f64(fx["rec"]), f64(fx["carry"]),
                                 f64(fx["g"]))
np.savez(path, fwd=np.asarray(fwd), drec=np.asarray(d_rec),
         dcar=np.asarray(d_car))
"""


def test_float64_ground_truth_matches_the_reference(tmp_path):
    """composite_twin in float64 under autograd against the reference's
    `_xla_composite_from_records` + jax.vjp in an x64 process: the forward
    and both cotangents within 1e-10 of their max. The records' cotangent
    holds the a_eff gradient of the records past a tile's count (zeroed
    a_eff, so alpha sits on the clip's bound 0 and takes half the
    gradient), which K8 and its plain version leave at 0: that, not
    float32 rounding, is what the gate's 2e-2 on the records' cotangent
    admits (7.2e-3 and 9.5e-3 here, on the TPU and on the card)."""
    p, seed = RV.FIXTURES[0]
    # The port's first: computed right after a child process exits, the
    # first float64 call of a process was seen to differ from every later
    # one by up to 1e-7.
    fwd, d_rec, d_car = (x.numpy() for x in
                         V.float64_reference(V.build_fixture(p, seed)))
    path = str(tmp_path / "ref64.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu", JAX_ENABLE_X64="1",
               PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _REF_F64, str(p),
                           str(seed), path], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    ref = np.load(path)
    for got, want in ((fwd, ref["fwd"]), (d_rec, ref["drec"]),
                      (d_car, ref["dcar"])):
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1e-10 * np.abs(want).max()
    # The plain backward's records cotangent differs from the twin's only at
    # the a_eff row of the records past each tile's count.
    fx = V.build_fixture(p, seed)
    res = V.check_records(p, seed, "cpu", ref=tuple(
        torch.from_numpy(ref[k]) for k in ("fwd", "drec", "dcar")))
    assert res["twin_drec_vs_f64"] == pytest.approx(7.2148e-3, rel=1e-3)
    past = np.arange(256)[None, :] >= fx["counts"][:, None]
    assert np.abs(ref["drec"][:, 9][past]).max() > 1.0
    assert np.abs(ref["drec"][:, 9][~past]).max() > 1.0


@pytest.mark.parametrize("p,seed", RV.FIXTURES)
def test_check_records_passes_the_gate(p, seed):
    r = V.check_records(p, seed, "cpu")
    assert r["p"] == p
    assert r["pallas_fwd_vs_f64"] < 1e-4
    assert r["pallas_drec_vs_f64"] < 2e-2
    assert r["pallas_dcar_vs_f64"] < 1e-3
    assert r["pallas_fwd_vs_f64"] <= r["twin_fwd_vs_f64"] * 2 + 1e-5


# ---------------------------------------------------------------------------
# pipeline
# ---------------------------------------------------------------------------

# The condition (eigen_condition.eigvec_condition: the rounding errors the
# footprint's float32 eigenvector holds) below which a splat's rotation and
# scale gradients are the reference's own rounding noise: on the 3,000-splat
# scene the reference's jitted and eager frames give those gradients more
# than 1e-4 of the largest field max apart on 15 splats, whose conditions
# reach 25,532 (the 16th splat they disagree on differs in pz, by 1.06e-4,
# at a condition of 1.7e6).
GRAD_CONDITION = 2 ** 15
# The xla configs' slab here: the deepest tile's pairs (149) fit, so the
# frames are those of the reference's slab of 768, in a third of the time
# (the readings agree to every printed digit).
XLA_SLAB = 256


def test_pipeline_matches_the_reference_xla_config(monkeypatch):
    """check_pipeline with deepening on the reference's scene and weights:
    the port's xla-config image within 1e-4 of the reference's xla config,
    and the gradients within 1e-4 of the largest field max (the check's
    own gradient measure): the centers and colors of every splat, the
    rotations and scales of every splat whose eigenvector holds at least
    GRAD_CONDITION rounding errors, those below it under the tie rule (no
    more than 2% of splats above 1e-3 of the field's max, mean below
    3e-4). The readings pass the gate and the deepening finds pairs
    left. The xla configs run at XLA_SLAB, which holds every tile's
    pairs."""
    from bench import build_cube_scene
    from fourdgs.core.camera import Camera
    from fourdgs.render.pipeline import (RenderConfig,
                                         render_params4d_packed)
    params = {k: np.asarray(v) for k, v in
              build_cube_scene(V.PIPELINE_N, seed=V.PIPELINE_SEED).items()}
    wts = np.asarray(jax.random.uniform(
        jax.random.PRNGKey(V.WTS_SEED), (V.PIPELINE_H, V.PIPELINE_W, 3),
        minval=-1.0, maxval=1.0))
    configs = V.pipeline_configs

    def cut(deepening):
        cfg_p, cfg_x, slab = configs(deepening)
        return cfg_p, dataclasses.replace(
            cfg_x, max_splats_per_tile=XLA_SLAB), slab
    monkeypatch.setattr(V, "pipeline_configs", cut)
    _, cfg_x, _ = V.pipeline_configs(True)
    cfg_ref = RenderConfig(**{f: getattr(cfg_x, f) for f in (
        "backend", "tile_h", "tile_w", "max_tiles_per_splat", "splat_chunk",
        "max_splats_per_tile")})
    cam = Camera.create(**V.CUBE_VIEW, width=V.PIPELINE_W,
                        height=V.PIPELINE_H)

    def loss(p):
        img = render_params4d_packed(p, cam, 0.0, cfg=cfg_ref)
        return jnp.sum(img[..., :3] * wts), img

    (_, img_ref), g_ref = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        {k: jnp.asarray(v) for k, v in params.items()})
    img_ref, g_ref = (np.asarray(img_ref),
                      {k: np.asarray(v) for k, v in g_ref.items()})
    out, eig = {}, {}
    with ET.recorded_eigen_inputs(eig):
        res = V.check_pipeline(True, "cpu", params=params, wts=wts,
                               outputs=out)
    np.testing.assert_allclose(out["img_x"].numpy(), img_ref, rtol=0,
                               atol=1e-4)
    named = (ET.eigvec_condition(eig["a"], eig["b"], eig["c"])
             < GRAD_CONDITION).numpy()
    assert 0 < named.mean() < 0.1, named.sum()
    scale = max(float(np.abs(g).max()) for g in g_ref.values())
    for k, want in g_ref.items():
        d = np.abs(out["grad_x"][k].numpy() - want)
        held = d if k[0] in "pc" else d[~named]
        assert held.max() <= 1e-4 * scale, (k, held.max() / scale)
        e = d.reshape(d.shape[0], -1).max(1) / max(
            float(np.abs(want).max()), 1e-30)
        assert (e > 1e-3).mean() < 0.02 and e.mean() < 3e-4, (
            k, (e > 1e-3).mean(), e.mean())
    assert res["deepening_nonvacuous"] and 128 < res["deepest_tile_pairs"] \
        <= XLA_SLAB
    assert res["resid_transmittance"] == 0.0
    assert res["img_maxdiff"] < 5e-2 and res["grad_reldiff"] < 5e-3


# ---------------------------------------------------------------------------
# sort
# ---------------------------------------------------------------------------

SORT_S = 1 << 18


def _sort_case(kind):
    """sort_fixture at SORT_S keys, changed for the case: `dead_rows` makes
    every other strided row of the row sort and every fourth merge row all
    DEAD; `equal_keys` puts every live key of a tile at one depth (runs of
    thousands of equal keys)."""
    fx = V.sort_fixture("cpu", SORT_S)
    key = fx["key"]
    if kind == "dead_rows":
        rows = sort_cuda.rowsort_rows(SORT_S, V.ROWSORT_LEN)
        slot = torch.arange(SORT_S)
        key = torch.where((slot % rows) % 2 == 1, sort_cuda.DEAD, key)
        merge = slot // V.MERGE_COLS
        key = torch.where(merge % 4 == 3, sort_cuda.DEAD, key)
    elif kind == "equal_keys":
        key = torch.where(key == sort_cuda.DEAD, key, (key >> 20) << 20)
    if kind != "default":
        gen = torch.Generator().manual_seed(1)
        r = fx["merge_key"].shape[0]
        k2 = torch.sort(key[:r * V.MERGE_COLS].reshape(r, V.MERGE_COLS),
                        dim=1).values
        k2[1::2] = k2[1::2].flip(1)
        fx = dict(fx, key=key, merge_key=k2, merge_val=torch.randint(
            0, 1 << 30, k2.shape, generator=gen, dtype=torch.int32))
    return fx


@pytest.mark.parametrize("kind", ["default", "dead_rows", "equal_keys"])
def test_check_sort(kind):
    fx = _sort_case(kind)
    res = V.check_sort("cpu", s=SORT_S, fixture=fx)
    assert set(res) == {"cutkeys_match", "rowsort_dropped",
                        "rowsort_monotone", "rowsort_conserves",
                        "merge_monotone", "merge_conserves"}
    assert res.pop("rowsort_dropped") == 0
    assert all(res.values()), res
    if kind == "dead_rows":
        ok, _, _ = sort_cuda.rowsort_compact(fx["key"], fx["val"],
                                             V.ROWSORT_KEEP,
                                             row_len=V.ROWSORT_LEN)
        assert bool((ok[:, 1::2] == sort_cuda.DEAD).all())


def test_check_sort_sees_a_broken_invariant():
    """A lost pair and a swapped pair fail the conservation and order
    checks (the checks can fail)."""
    fx = V.sort_fixture("cpu", SORT_S)
    orig = sort_cuda.merge_sorted_rows

    def broken(k2d, v2d, rows_alternating=False):
        km, vm = orig(k2d, v2d, rows_alternating=rows_alternating)
        km = km.clone()
        first, second = int(km[0]), int(km[1])
        km[0], km[1] = second + 1, first
        return km, vm
    sort_cuda.merge_sorted_rows = broken
    try:
        res = V.check_sort("cpu", s=SORT_S, fixture=fx)
    finally:
        sort_cuda.merge_sorted_rows = orig
    assert not res["merge_monotone"] and not res["merge_conserves"]
    assert res["cutkeys_match"] and res["rowsort_conserves"]


# ---------------------------------------------------------------------------
# tail parity
# ---------------------------------------------------------------------------

def _rowsort_twin(key, val, keep_cols, row_len=8192, alternating=False,
                  cut=None, key_shift=20, interpret=None):
    """The reference's `sort_pallas.rowsort_compact` (ascending rows, the
    form `bin_splats` calls) in plain jnp: the same strided rows, cut and
    keep, a stable sort of each row."""
    from fourdgs.ops import sort_pallas as SP
    assert not alternating
    s = key.shape[0]
    rows = -(-s // row_len)
    rows = -(-rows // SP.ROWSORT_COLS) * SP.ROWSORT_COLS
    pad = rows * row_len - s
    k2 = jnp.concatenate([key, jnp.full((pad,), SP.DEAD, key.dtype)]
                         ).reshape(row_len, rows)
    v2 = jnp.concatenate([val, jnp.zeros((pad,), val.dtype)]
                         ).reshape(row_len, rows)
    if cut is not None:
        tbl = jnp.concatenate([cut.astype(jnp.int32), jnp.full(
            (2048 - cut.shape[0],), SP.DEAD, jnp.int32)])
        k2 = jnp.where(k2 > tbl[jnp.clip(k2 >> key_shift, 0, 2047)],
                       SP.DEAD, k2)
    order = jnp.argsort(k2, axis=0, stable=True)[:keep_cols]
    ks = jnp.take_along_axis(k2, order, 0)
    vs = jnp.where(ks == SP.DEAD, 0, jnp.take_along_axis(v2, order, 0))
    return ks, vs, jnp.sum(k2 != SP.DEAD) - jnp.sum(ks != SP.DEAD)


@pytest.fixture(scope="module")
def ref_tail_parity():
    """The reference's own check_tail_parity at 20K splats, 512x256, with
    pack8 off (C-R1) and, for time, plain-jnp forms of its kernels: the
    composite's and the tail's XLA twins, its own XLA prepass
    (step_bands_rects + step_slot_masks, the same int32 sums) and
    _rowsort_twin."""
    from fourdgs.ops import composite_pallas as CP
    from fourdgs.ops import sort_pallas as SP
    from fourdgs.ops import tail_pallas as RTL
    pack_records = CP.pack_records
    twin = CP._xla_composite_from_records

    def prepass(rows, band_cuts, chunk, budget, budget_lo=0, k_bands=8,
                interpret=None):
        band, rect = RTL.step_bands_rects(rows, chunk, band_cuts, budget_lo,
                                          budget)
        return band, rect, RTL.step_slot_masks(rows, chunk, budget,
                                               budget_lo)
    import bench
    scenes = []

    def build_cube_scene(*args, **kwargs):
        scenes.append(bench_build(*args, **kwargs))
        return scenes[-1]
    bench_build = bench.build_cube_scene
    with pytest.MonkeyPatch.context() as mp:
        # The scene the reference builds is the one handed to the port.
        mp.setattr(bench, "build_cube_scene", build_cube_scene)
        mp.setattr(RTL, "tail_prepass", prepass)
        mp.setattr(SP, "rowsort_compact", _rowsort_twin)
        mp.setattr(CP, "pack_records",
                   lambda *a, pack8=False, **k: pack_records(*a, **k))
        mp.setattr(CP, "composite_records",
                   lambda rec, cnt, kx, ky, carry: twin(rec, cnt, kx, ky,
                                                        carry))
        mp.setattr(CP, "composite_records_at",
                   lambda rec, cnt, sel, kx, ky, out: out.at[sel].set(
                       twin(rec, cnt, kx[sel], ky[sel], out[sel])))
        mp.setattr(RTL, "tail_accumulate",
                   lambda *a, slot_mask=None, interpret=None, **k:
                   RTL.tail_accumulate_xla(*a, **k))
        res = RV.check_tail_parity(**TAIL_20K)
    assert len(scenes) == 1
    return res, {k: np.asarray(v) for k, v in scenes[0].items()}


def test_tail_parity_matches_the_reference(ref_tail_parity):
    """The port's check_tail_parity on the reference's scene (handed over
    through numpy) gives the reference's readings: both residuals 0 or
    below 1e-6 on both sides, the means and the mean |err| within the tie
    tolerance (1e-4, C-R4), the p99 within 1e-2 and the tail's chunks
    all in the last band (C-R8's wrap, 16,384 live entries a chunk)."""
    want, params = ref_tail_parity
    got = V.check_tail_parity("cpu", **TAIL_20K, params=params)
    assert got["n"] == want["n"] == TAIL_20K["n"]
    for k in ("exact_resid", "tail_resid"):
        assert (got[k] == 0) == (want[k] == 0) and got[k] < 1e-6, k
    for k in ("mean_rgb_exact", "mean_rgb_tail", "mean_abs_err"):
        assert abs(got[k] - want[k]) < 1e-4, (k, got[k], want[k])
    assert abs(got["mean_rel_err"] - want["mean_rel_err"]) < 1e-2
    assert abs(got["p99_abs_err"] - want["p99_abs_err"]) < 1e-2
    assert got["bands_main"][-1] == sum(got["bands_main"]) == 2
    # The instrument: the same frame with bands from an int64 depth sum.
    unwrapped = V.check_tail_parity("cpu", **TAIL_20K, params=params,
                                    int64_bands=True)
    assert unwrapped["int64_bands"] and unwrapped["bands_main"] != \
        got["bands_main"]
    assert unwrapped["mean_rgb_exact"] == got["mean_rgb_exact"]


def test_bands_int64_undoes_the_wrap_only():
    """bands_int64 equals the shipped prepass's bands where a chunk's int32
    depth sum cannot wrap, and the bands of the true mean where it wraps."""
    gen = torch.Generator().manual_seed(3)
    chunk, steps = 16384, 3
    n = chunk * steps
    dbits = torch.randint(240_000, 280_000, (n,), generator=gen,
                          dtype=torch.int32)
    span = torch.randint(0, 10, (n,), generator=gen, dtype=torch.int32)
    span[:chunk // 4] = 0                    # a chunk with few live entries
    span[chunk // 4 + 5000:chunk] = 0
    zeros = torch.zeros(n, dtype=torch.int32)
    meta = torch.stack([zeros, zeros, zeros, zeros, dbits, span])
    cuts = -torch.tensor([275_000, 270_000, 265_000, 260_000, 255_000,
                          250_000, 245_000], dtype=torch.int32)
    band, _, _ = TL.tail_prepass(meta, cuts, chunk, 8)
    got = V.bands_int64(meta, cuts, chunk, 8)
    live = (span > 0) & (span <= 8)
    mean = (torch.where(live, dbits, 0).reshape(steps, chunk).sum(
        1, dtype=torch.int64) // live.reshape(steps, chunk).sum(1))
    want = ((-mean)[:, None] >= cuts[None, :].long()).sum(1)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert got[0] == band[0]                 # 5,000 live: no wrap
    assert not torch.equal(got[1:], band[1:])  # the full chunks wrap


# ---------------------------------------------------------------------------
# C-R15: splat 2557 of the 20K cube (seed 1, made on the card), t = 0.37
# ---------------------------------------------------------------------------

# Its footprint's eigen inputs (a, b, c) as the card's and the CPU's
# projections of the whole 20K batch gave them (a 2 ulps apart, c 5 ulps, b
# 2.7% apart but within u (|a| + |c|) of both: the batched products'
# summation order), and the cotangent the card's backward handed l0, l1,
# v0x, v0y (traced once on an H100 80GB HBM3, 700 W; PERF.md holds the
# trace).
CR15_ABC = {
    "card": ("0x1.a570cc0000000p-16", "-0x1.2800000000000p-36",
             "0x1.bb6ef60000000p-16"),
    "cpu": ("0x1.a570d00000000p-16", "-0x1.2000000000000p-36",
            "0x1.bb6f000000000p-16"),
}
CR15_COT = ("0x1.549c9e0000000p-20", "0x1.da01400000000p-23",
            "0x1.7e0f360000000p-29", "-0x1.de5be00000000p-28")


def _eigen_vjp(which, inputs, dtype):
    """(l0, l1, v0x, v0y) and the gradient of (a, b, c) under CR15_COT,
    through the reference's eigen2x2_scalar (jax) or the port's."""
    cot = [float.fromhex(x) for x in CR15_COT]
    if which == "reference":
        from fourdgs.render.project import eigen2x2_scalar as ref_eigen
        jdt = jnp.float32 if dtype == torch.float32 else jnp.float64

        def f(a, b, c):
            lmin, lmax, vx, vy = ref_eigen(a, b, c)
            return jnp.sqrt(lmin), jnp.sqrt(lmax), vx, vy
        with jax.enable_x64(jdt == jnp.float64):
            out, pull = jax.vjp(f, *(jnp.asarray(x, jdt) for x in inputs))
            grad = pull(tuple(jnp.asarray(x, jdt) for x in cot))
            return ([float(x) for x in out], [float(x) for x in grad])
    x = [torch.tensor(v, dtype=dtype, requires_grad=True) for v in inputs]
    lmin, lmax, vx, vy = eigen2x2_scalar(*x)
    out = [torch.sqrt(lmin), torch.sqrt(lmax), vx, vy]
    grad = torch.autograd.grad(out, x, [torch.tensor(c, dtype=dtype)
                                        for c in cot])
    return ([float(o.detach()) for o in out], [float(g) for g in grad])


def test_cr15_the_eigenvector_is_rounding_noise_in_the_reference():
    """At the card's and the CPU's roundings of the splat's covariance
    (CR15_ABC), the reference's float32 eigen2x2_scalar turns the
    eigenvector by ~68 degrees and its gradient in b by a factor of 270,
    and the port's equals it at each; in float64 both inputs give the same
    gradient. The conditioning rule names the splat from either input."""
    inputs = {k: [float.fromhex(x) for x in v] for k, v in CR15_ABC.items()}
    f32 = {}
    for dev, abc in inputs.items():
        ref_out, ref_g = _eigen_vjp("reference", abc, torch.float32)
        port_out, port_g = _eigen_vjp("port", abc, torch.float32)
        np.testing.assert_allclose(port_out, ref_out, rtol=1e-6)
        np.testing.assert_allclose(port_g, ref_g, rtol=1e-5)
        f32[dev] = (ref_out, ref_g)
        t = [torch.tensor([v], dtype=torch.float32) for v in abc]
        assert float(ET.eigvec_condition(*t)[0]) < 1.0
        assert bool(ET.ill_conditioned(*t)[0])
    (out_card, g_card), (out_cpu, g_cpu) = f32["card"], f32["cpu"]
    assert abs(out_card[2]) < 0.4 and out_cpu[2] == -1.0   # v0x
    assert abs(g_card[1]) > 100 * abs(g_cpu[1])              # d/db
    g64 = {dev: _eigen_vjp("reference", abc, torch.float64)[1]
           for dev, abc in inputs.items()}
    np.testing.assert_allclose(g64["card"], g64["cpu"], rtol=1e-3)
    assert abs(g_card[1]) > 500 * abs(g64["card"][1])
    np.testing.assert_allclose(
        _eigen_vjp("port", inputs["card"], torch.float64)[1], g64["card"],
        rtol=1e-9)


def test_eigvec_condition_names_few_splats_of_the_cube():
    """On the 20K cube the rule names a handful of splats (fewer than 64
    rounding errors in the eigenvector), and the footprints it names are
    the nearly round ones with a vanishing off-diagonal."""
    from fourdgs_torch.core.camera import Camera
    from fourdgs_torch.scenes.cube import CUBE_CAMERA
    params = ET.trainer_params(device="cpu")
    cam = Camera.create(**CUBE_CAMERA, width=ET.WIDTH, height=ET.HEIGHT,
                        device="cpu")
    a, b, c = ET.footprint_inputs(params, cam)
    named = ET.ill_conditioned(a, b, c)
    assert 1 <= int(named.sum()) <= 20
    rho = (b.abs() / torch.sqrt(a * c))[named]
    assert float(rho.max()) < 1e-3
