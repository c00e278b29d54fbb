"""On-card kernel certification: the compiled kernels against float64 ground
truth, the pallas backend against the xla backend through a whole frame with
gradients, the sort kernels against their invariants, and the shipped
converged frame against an exhaustively deepened exact composite (port of
the repo's `validate_kernels.py`).

    python3 -m fourdgs_torch.tools.validate_kernels [--json PATH] [--10m]

Checks, each a plain function of tensors on an explicit device:

  * check_records: K1 (composite_records) and K8 (its backward) on the
    record fixtures (build_fixture: 12 tiles of 256 records, a non-trivial
    carry, P = 1024 and 2048) against float64 ground truth, beside the
    float32 plain versions (the "twin"): forward max |d|, the records' and
    the carry's cotangents relative to their max. The ground truth is the
    reference twin's function (`composite_twin`: every record, no early
    exit, alpha clipped with jnp.clip's ties) in float64 under autograd;
  * check_pipeline: the 3,000-splat cube at 512x256 in 8x128 tiles through
    render_params4d_packed under the pallas config (slab 256; or 128 with
    three deepening passes, which must find pairs left) against the xla
    config (slab 768): image max |d| and gradient max |d| over the largest
    field max of a loss sum(rgb * wts);
  * check_sort: 4,194,304 keys over 1,020 tiles with 45% dead: K10
    (apply_cutkeys) equal to its formula; K2 (rowsort_compact, keep 384 of
    rows of 512) dropping nothing, every row ascending, the live (key,
    value) multiset kept; K11-K13 (merge_sorted_rows of 128 alternating
    rows of 2048) ascending with the keys' multiset kept;
  * check_tail_parity: the shipped converged frame
    (auto_render_config(n, w, h)) against the exact composite (no prune, no
    compaction, 80 deepening passes of 512 over every tile) of the
    Morton-ordered cube: both residual transmittances, mean rgb of both,
    the mean's relative error, mean / p99 / max |err| over rgb, and the
    histogram of the tail's chunks over its depth bands (main stream and
    big tier). With int64_bands the bands come from a depth sum in int64
    (the instrument `bands_int64`: ROADMAP C-R8's wrap undone), the
    rest of the frame as shipped.

The gate (`gate`) is the reference's, bound for bound: records forward <
1e-4, records cotangent < 2e-2, carry cotangent < 1e-3, K1's forward no
worse than twice the twin's + 1e-5; pipeline image < 5e-2, gradient <
5e-3, deepening not vacuous; every sort check; the 1M tail parity's exact
residual < 1e-3, tail residual < 1e-6, mean relative error < 0.02, mean
|err| < 0.03. The 10M tail parity (1920x1088, seed 0; `--10m`) is reported,
not gated, as in the reference.

It runs on the card and prints one JSON object: the reference's keys plus
`device` (the card's name and power limit) and, per tail parity, the band
histograms. `--json PATH` also writes it there. Exit code 0 when the gate
passes, 1 when it fails, 2 without a card. Nothing here builds or launches
at import; `device="cpu"` (the tests) runs the plain versions.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys

import numpy as np
import torch

FIXTURES = [(1024, 0), (2048, 1)]
PIPELINE_N, PIPELINE_SEED, PIPELINE_W, PIPELINE_H = 3000, 3, 512, 256
WTS_SEED = 9
SORT_KEYS, SORT_TILES, SORT_SEED, SORT_DEAD = 1 << 22, 1020, 7, 0.45
ROWSORT_LEN, ROWSORT_KEEP = 512, 384
MERGE_ROWS, MERGE_COLS = 128, 2048
CUBE_VIEW = dict(position=(420.0, 300.0, 420.0),
                 orientation=(-1.0, -0.7, -1.0), far=5000.0)
TAIL_1M = dict(n=1_000_000, width=1024, height=512, seed=2,
               deepening_passes=80)
TAIL_10M = dict(n=10_000_000, width=1920, height=1088, seed=0,
                deepening_passes=80)


# ---------------------------------------------------------------------------
# records
# ---------------------------------------------------------------------------

def build_fixture(p, seed=0):
    """Deterministic record/pixel/carry fixture (numpy, f32): the
    reference's, draw for draw."""
    t_tiles, m = 12, 256
    rng = np.random.default_rng(seed)
    rec = np.zeros((t_tiles, 16, m), np.float32)
    rec[:, 0] = rng.normal(0.0, 0.3, (t_tiles, m))        # sx (k units)
    rec[:, 1] = rng.normal(0.0, 0.3, (t_tiles, m))        # sy
    theta = rng.uniform(0, 2 * np.pi, (t_tiles, m))
    rec[:, 2] = np.cos(theta)
    rec[:, 3] = np.sin(theta)
    rec[:, 4] = 1.0 / rng.uniform(0.02, 0.3, (t_tiles, m))  # 1/l0
    rec[:, 5] = 1.0 / rng.uniform(0.02, 0.3, (t_tiles, m))  # 1/l1
    rec[:, 6:9] = rng.uniform(0, 1, (t_tiles, 3, m))
    rec[:, 9] = rng.uniform(0, 0.9, (t_tiles, m))
    counts = rng.integers(0, m + 1, t_tiles, dtype=np.int32)
    kx = rng.normal(0.0, 0.4, (t_tiles, 1, p)).astype(np.float32)
    ky = rng.normal(0.0, 0.4, (t_tiles, 1, p)).astype(np.float32)
    carry = np.zeros((t_tiles, 8, p), np.float32)
    carry[:, 4] = 1.0
    carry[:, 0:4] = rng.uniform(0, 0.3, (t_tiles, 4, p)).astype(np.float32)
    carry[:, 4] *= rng.uniform(0.2, 1.0, (t_tiles, p)).astype(np.float32)
    # counts semantics differ between kernel and twin: zero a_eff past
    # counts so both see the same live set.
    live = (np.arange(m)[None, :] < counts[:, None]).astype(np.float32)
    rec[:, 9, :] *= live
    g = rng.normal(0, 1, (t_tiles, 8, p)).astype(np.float32)
    g[:, 5:8] = 0.0
    return dict(rec=rec, counts=counts, kx=kx, ky=ky, carry=carry, g=g)


def composite_twin(records, kx, ky, carry):
    """The reference twin's function (`_xla_composite_from_records` with a
    carry): every record of every tile, no early exit, the exclusive
    transmittance through log1p / exp-cumsum, alpha clipped with the ties of
    jnp.clip (a gradient of 1/2 where alpha sits on a bound: a covered
    record of a_eff 0). Plain autograd, any float dtype. records (T, 16, M),
    kx / ky (T, 1, P), carry (T, 8, P) -> (T, 8, P)."""
    from fourdgs_torch.ops.composite_cuda import ALPHA_MAX
    sx, sy, v0x, v0y, il0, il1 = (records[:, f, :, None] for f in range(6))
    a_eff = records[:, 9, :, None]
    dx, dy = kx - sx, ky - sy
    n0 = (v0x * dx + v0y * dy) * il0
    n1 = (v0y * dx - v0x * dy) * il1
    w = torch.exp(-0.5 * (64.0 * (n0 * n0 + n1 * n1)))
    cover = (n0.abs() <= 0.5) & (n1.abs() <= 0.5) & (w >= 1e-4)
    lo = records.new_tensor(0.0)
    hi = records.new_tensor(ALPHA_MAX)
    alpha = torch.minimum(torch.maximum(a_eff * w * cover.to(w.dtype), lo),
                          hi)
    log1m = torch.log1p(-alpha)
    wgt = alpha * torch.exp(torch.cumsum(log1m, dim=1) - log1m) \
        * carry[:, 4:5]
    rgb = torch.einsum("tmp,tcm->tcp", wgt, records[:, 6:9])
    a_out = (alpha * wgt).sum(dim=1)
    trans = torch.exp(log1m.sum(dim=1))
    return torch.cat([rgb + carry[:, 0:3], (a_out + carry[:, 3])[:, None],
                      (trans * carry[:, 4])[:, None],
                      torch.zeros_like(carry[:, 5:8])], dim=1)


def float64_reference(fx, device="cpu"):
    """The fixture's ground truth: (forward (T, 8, P), d_records (T, 16, M),
    d_carry (T, 8, P)) of composite_twin in float64 under the fixture's
    cotangent, one tile at a time (a tile's graph is a few (M, P)
    planes)."""
    def f64(x):
        return torch.as_tensor(x, dtype=torch.float64, device=device)
    rec, kx, ky, carry, g = (f64(fx[k]) for k in
                             ("rec", "kx", "ky", "carry", "g"))
    fwd, d_rec, d_car = [], [], []
    for t in range(rec.shape[0]):
        r = rec[t:t + 1].clone().requires_grad_(True)
        c = carry[t:t + 1].clone().requires_grad_(True)
        out = composite_twin(r, kx[t:t + 1], ky[t:t + 1], c)
        dr, dc = torch.autograd.grad(out, (r, c), g[t:t + 1])
        fwd.append(out.detach())
        d_rec.append(dr)
        d_car.append(dc)
    return torch.cat(fwd), torch.cat(d_rec), torch.cat(d_car)


def _maxdiff(a, b):
    return float((a.double() - b.double()).abs().max())


def _relscale(x):
    return max(1e-3, float(x.abs().max()))


def check_records(p, seed, device, fixture=None, ref=None):
    """K1 and K8 (`composite_records` and its autograd backward) and the
    float32 plain versions (the twin) against the float64 ground truth, on
    the fixture (build_fixture(p, seed) unless handed one; `ref` the
    float64 (fwd, d_rec, d_car) unless computed here)."""
    from fourdgs_torch.ops import composite_cuda as C
    fx = build_fixture(p, seed) if fixture is None else fixture
    ref_fwd, ref_drec, ref_dcar = (float64_reference(fx, device)
                                   if ref is None else ref)
    ref_fwd, ref_dcar = ref_fwd[:, 0:5], ref_dcar[:, 0:5]

    def t(x):
        return torch.as_tensor(x, device=device)
    rec, counts, kx, ky, carry, g = (t(fx[k]) for k in
                                     ("rec", "counts", "kx", "ky", "carry",
                                      "g"))

    def kernel(r, c):
        r, c = r.clone().requires_grad_(True), c.clone().requires_grad_(True)
        out = C.composite_records(r, counts, kx, ky, c)
        dr, dc = torch.autograd.grad(out, (r, c), g)
        return out.detach(), dr, dc

    def twin(r, c):
        out = C.composite_plain(r, counts, kx, ky, c)
        return (out, C.composite_bwd_plain(r, counts, kx, ky, c, out, g),
                C.carry_cotangent(c, out, g))

    res = {"p": p}
    for name, run in (("pallas", kernel), ("twin", twin)):
        fwd, drec, dcar = run(rec, carry)
        res[f"{name}_fwd_vs_f64"] = _maxdiff(fwd[:, 0:5], ref_fwd)
        res[f"{name}_drec_vs_f64"] = (_maxdiff(drec, ref_drec)
                                      / _relscale(ref_drec))
        res[f"{name}_dcar_vs_f64"] = (_maxdiff(dcar[:, 0:5], ref_dcar)
                                      / _relscale(ref_dcar))
    return res


# ---------------------------------------------------------------------------
# pipeline
# ---------------------------------------------------------------------------

def cube_camera(width, height, device):
    from fourdgs_torch.core.camera import Camera
    return Camera.create(**CUBE_VIEW, width=width, height=height,
                         device=device)


def as_params(params, device):
    """A packed parameter dict (numpy arrays or tensors) as float32 tensors
    on `device`."""
    return {k: (v if torch.is_tensor(v) else torch.tensor(np.asarray(v)))
            .to(device=device, dtype=torch.float32)
            for k, v in params.items()}


def pipeline_configs(deepening: bool):
    """(pallas config, xla config, pallas slab) of check_pipeline."""
    from fourdgs_torch.render.pipeline import RenderConfig
    kw = dict(tile_h=8, tile_w=128, max_tiles_per_splat=8, splat_chunk=64)
    slab = 128 if deepening else 256
    cfg_p = RenderConfig(backend="pallas", **kw, max_splats_per_tile=slab,
                         deepening_passes=3 if deepening else 1,
                         deepening_fraction=1.0)
    cfg_x = RenderConfig(backend="xla", **kw, max_splats_per_tile=768)
    return cfg_p, cfg_x, slab


def check_pipeline(deepening: bool, device, params=None, wts=None,
                   outputs: dict | None = None):
    """The pallas config against the xla config through the whole frame
    and its gradient (module docstring). `params` (the packed dict) and
    `wts` (H, W, 3) default to the cube of PIPELINE_N splats from seed
    PIPELINE_SEED and uniform [-1, 1) weights from seed WTS_SEED; with
    `outputs`, each config's image and gradients go there."""
    from fourdgs_torch.render.pipeline import render_params4d_packed
    from fourdgs_torch.scenes.cube import build_cube_scene
    if params is None:
        params = build_cube_scene(PIPELINE_N, seed=PIPELINE_SEED,
                                  device=device)
    params = as_params(params, device)
    camera = cube_camera(PIPELINE_W, PIPELINE_H, device)
    if wts is None:
        gen = torch.Generator(device=device).manual_seed(WTS_SEED)
        wts = torch.rand((PIPELINE_H, PIPELINE_W, 3), generator=gen,
                         device=device) * 2.0 - 1.0
    wts = (wts if torch.is_tensor(wts) else torch.tensor(np.asarray(wts))
           ).to(device=device, dtype=torch.float32)
    cfg_p, cfg_x, slab = pipeline_configs(deepening)

    def value_and_grad(cfg):
        p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        img = render_params4d_packed(p, camera, 0.0, cfg=cfg)
        (img[..., :3] * wts).sum().backward()
        return img.detach(), {k: v.grad for k, v in p.items()}

    img_p, gp = value_and_grad(cfg_p)
    img_x, gx = value_and_grad(cfg_x)
    res = dict(deepening=deepening)
    if deepening:
        with torch.no_grad():
            _, aux = render_params4d_packed(params, camera, 0.0, cfg=cfg_p,
                                            return_aux=True)
        res["deepest_tile_pairs"] = int(aux["max_tile_pairs"])
        res["deepening_nonvacuous"] = bool(int(aux["max_tile_pairs"]) > slab)
        res["resid_transmittance"] = float(aux["resid_transmittance"])
    scale = max(_relscale(v) for v in gx.values())
    res.update(img_maxdiff=_maxdiff(img_p, img_x),
               grad_reldiff=max(_maxdiff(gp[k], gx[k]) for k in gx) / scale)
    if outputs is not None:
        outputs.update(img_p=img_p, img_x=img_x, grad_p=gp, grad_x=gx)
    return res


# ---------------------------------------------------------------------------
# sort
# ---------------------------------------------------------------------------

def sort_fixture(device, s=SORT_KEYS, seed=SORT_SEED):
    """The sort checks' inputs, made on `device` from a seeded generator:
    (S,) int32 keys (tile << 20 | 20-bit depth over SORT_TILES tiles, a
    SORT_DEAD share DEAD) and values 0..S-1, the (SORT_TILES,) cut keys,
    and the merge's (R, 2048) rows of the first keys (R = 128, or fewer
    where S is smaller), each sorted, the odd rows descending, with random
    values."""
    from fourdgs_torch.ops.sort_cuda import DEAD
    gen = torch.Generator(device=device).manual_seed(seed)

    def ints(lo, hi, n):
        return torch.randint(lo, hi, (n,), generator=gen, device=device,
                             dtype=torch.int32)
    t = SORT_TILES
    key = (ints(0, t, s) << 20) | ints(0, 1 << 20, s)
    dead = torch.rand(s, generator=gen, device=device) < SORT_DEAD
    key = torch.where(dead, DEAD, key)
    cut = (torch.arange(t, dtype=torch.int32, device=device) << 20) \
        | ints(0, 1 << 20, t)
    r = min(MERGE_ROWS, s // MERGE_COLS)
    k2 = torch.sort(key[:r * MERGE_COLS].reshape(r, MERGE_COLS),
                    dim=1).values
    k2[1::2] = k2[1::2].flip(1)
    v2 = ints(0, 1 << 30, r * MERGE_COLS).reshape(r, MERGE_COLS)
    return dict(key=key, val=torch.arange(s, dtype=torch.int32,
                                          device=device),
                cut=cut, merge_key=k2, merge_val=v2)


def _kv64(k, v):
    """int32 (key, value) pairs as sortable int64 codes."""
    return (k.to(torch.int64) << 32) | (v.to(torch.int64) & 0xFFFFFFFF)


def _same_multiset(a, b):
    return a.shape == b.shape and torch.equal(torch.sort(a).values,
                                              torch.sort(b).values)


def check_sort(device, s=SORT_KEYS, fixture=None):
    """K10, K2 and K11-K13 against their invariants (module docstring), on
    sort_fixture(device, s) unless handed one."""
    from fourdgs_torch.ops import lookup_cuda, sort_cuda
    from fourdgs_torch.ops.sort_cuda import DEAD
    fx = sort_fixture(device, s) if fixture is None else fixture
    key, val, cut = fx["key"], fx["val"], fx["cut"]
    res = {}
    pruned = lookup_cuda.apply_cutkeys(key, cut)
    tid = torch.clamp(key >> 20, 0, cut.shape[0] - 1).long()
    res["cutkeys_match"] = bool(torch.equal(
        pruned, torch.where(key <= cut[tid], key, DEAD)))

    ok, ov, dropped = sort_cuda.rowsort_compact(key, val, ROWSORT_KEEP,
                                                row_len=ROWSORT_LEN)
    dropped = int(dropped)
    res["rowsort_dropped"] = dropped
    res["rowsort_monotone"] = bool((ok[1:].to(torch.int64)
                                    >= ok[:-1].to(torch.int64)).all())
    kept, live = ok != DEAD, key != DEAD
    res["rowsort_conserves"] = bool(dropped == 0 and _same_multiset(
        _kv64(ok[kept], ov[kept]), _kv64(key[live], val[live])))

    k2, v2 = fx["merge_key"], fx["merge_val"]
    km, _ = sort_cuda.merge_sorted_rows(k2, v2, rows_alternating=True)
    res["merge_monotone"] = bool((km[1:].to(torch.int64)
                                  >= km[:-1].to(torch.int64)).all())
    # Rows the merge pads with (sort_cuda.merged_rows) hold DEAD keys.
    pad = km.new_full((km.shape[0] - k2.numel(),), DEAD)
    res["merge_conserves"] = bool(_same_multiset(
        km, torch.cat([k2.reshape(-1), pad])))
    return res


# ---------------------------------------------------------------------------
# tail parity
# ---------------------------------------------------------------------------

def bands_int64(meta, band_cuts, chunk: int, budget: int,
                budget_lo: int = 0):
    """Each chunk's depth band as K6 assigns it, from its live entries'
    mean depth bits summed in int64 (the shipped sum is int32 and wraps
    past ~7,700 live entries of a 16,384 chunk, ROADMAP C-R8)."""
    span, dbits = meta[5].reshape(-1, chunk), meta[4].reshape(-1, chunk)
    live = (span > budget_lo) & (span <= budget)
    d_sum = torch.where(live, dbits, 0).sum(dim=1, dtype=torch.int64)
    d_cnt = torch.clamp(live.sum(dim=1, dtype=torch.int64), min=1)
    d_mean = torch.div(d_sum, d_cnt, rounding_mode="floor")
    return ((-d_mean)[:, None] >= band_cuts[None, :].to(torch.int64)).sum(
        dim=1, dtype=torch.int32)


@contextlib.contextmanager
def tail_prepass_recorded(bands: list, int64: bool = False):
    """Within the block, every tail prepass (K6) of a frame appends the
    bands it hands the tail to `bands` (main stream, then the big tier);
    with `int64`, those bands are bands_int64's in place of K6's (the
    measuring instrument of C-R8's cost: the slab rects and slot masks stay
    K6's)."""
    from fourdgs_torch.ops import tail_cuda as TL
    orig = TL.tail_prepass

    def prepass(meta, band_cuts, chunk, budget, budget_lo=0, k_bands=8):
        band, rect, mask = orig(meta, band_cuts, chunk, budget,
                                budget_lo=budget_lo, k_bands=k_bands)
        if int64:
            band = bands_int64(meta, band_cuts, chunk, budget, budget_lo)
        bands.append(band)
        return band, rect, mask
    TL.tail_prepass = prepass
    try:
        yield bands
    finally:
        TL.tail_prepass = orig


def band_histogram(band, k_bands):
    return [int(x) for x in torch.bincount(band.long().cpu(),
                                           minlength=k_bands)]


def check_tail_parity(device, n=1_000_000, width=1024, height=512, seed=2,
                      deepening_passes=80, params=None, int64_bands=False,
                      outputs: dict | None = None, exact=None):
    """The shipped converged frame against the exact composite of the same
    Morton-ordered cube (module docstring). `params`: the packed cube
    before the Morton order (default build_cube_scene(n, seed)); with
    `outputs`, the exact composite's (image, aux) goes there under
    "exact", and `exact` = such a pair from an earlier call on the same
    scene and arguments stands for the exact composite."""
    from fourdgs_torch.render.autoconfig import auto_render_config
    from fourdgs_torch.render.pipeline import (RenderConfig,
                                               render_params4d_packed)
    from fourdgs_torch.scenes.cube import build_cube_scene
    from fourdgs_torch.splats.packed import morton_order
    if params is None:
        params = build_cube_scene(n, seed=seed, device=device)
    params = morton_order(as_params(params, device))
    n = int(params["px"].shape[0])
    cam = cube_camera(width, height, device)
    kw = dict(tile_h=16, tile_w=128, max_tiles_per_splat=8,
              splat_chunk=128, big_splat_budget=16)
    cfg_exact = RenderConfig(backend="pallas", **kw,
                             max_splats_per_tile=512,
                             quantized_depth_sort=True,
                             deepening_fraction=1.0,
                             deepening_passes=deepening_passes)
    cfg_tail = auto_render_config(n, width, height, converged=True)
    bands = []
    with torch.no_grad():
        img_x, aux_x = exact or render_params4d_packed(
            params, cam, 0.0, cfg=cfg_exact, return_aux=True)
        with tail_prepass_recorded(bands, int64=int64_bands):
            img_t, aux_t = render_params4d_packed(params, cam, 0.0,
                                                  cfg=cfg_tail,
                                                  return_aux=True)
    ix = img_x[..., :3].cpu().numpy()
    it = img_t[..., :3].cpu().numpy()
    d = np.abs(it - ix)
    if outputs is not None:
        outputs["exact"] = (img_x, aux_x)
    k = cfg_tail.tail_bands
    return dict(
        n=n,
        exact_resid=float(aux_x["resid_transmittance"]),
        tail_resid=float(aux_t["resid_transmittance"]),
        mean_rgb_exact=float(ix.mean()),
        mean_rgb_tail=float(it.mean()),
        mean_rel_err=float(abs(it.mean() - ix.mean())
                           / max(ix.mean(), 1e-6)),
        mean_abs_err=float(d.mean()),
        p99_abs_err=float(np.percentile(d, 99)),
        max_abs_err=float(d.max()),
        int64_bands=bool(int64_bands),
        bands_main=band_histogram(bands[0], k),
        bands_big=(band_histogram(bands[1], k) if len(bands) > 1 else None),
    )


# ---------------------------------------------------------------------------
# the gate and the command
# ---------------------------------------------------------------------------

def gate(results) -> bool:
    """The reference's pass gate (validate_kernels.py), bound for bound."""
    ok = True
    for k in ("records_8x128", "records_16x128"):
        r = results[k]
        ok &= r["pallas_fwd_vs_f64"] < 1e-4
        ok &= r["pallas_drec_vs_f64"] < 2e-2
        ok &= r["pallas_dcar_vs_f64"] < 1e-3
        ok &= r["pallas_fwd_vs_f64"] <= r["twin_fwd_vs_f64"] * 2 + 1e-5
    for k in ("pipeline_single", "pipeline_deepening"):
        ok &= results[k]["img_maxdiff"] < 5e-2
        ok &= results[k]["grad_reldiff"] < 5e-3
    ok &= results["pipeline_deepening"]["deepening_nonvacuous"]
    for k, v in results["sort"].items():
        ok &= (v == 0) if k == "rowsort_dropped" else bool(v)
    tp = results["tail_parity_1m"]
    ok &= tp["exact_resid"] < 1e-3
    ok &= tp["tail_resid"] < 1e-6
    ok &= tp["mean_rel_err"] < 0.02
    ok &= tp["mean_abs_err"] < 0.03
    return bool(ok)


def device_info(device) -> dict:
    """The card's name and power limit, as nvidia-smi reads them (or the
    CPU)."""
    device = torch.device(device)
    if device.type != "cuda":
        return {"name": "cpu", "power_limit": None}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", f"--id={device.index or 0}"],
        capture_output=True, text=True, timeout=60, check=True)
    name, limit = [x.strip() for x in smi.stdout.strip().split(",")]
    return {"name": name, "power_limit": limit}


def run_checks(device, with_10m=False) -> dict:
    """Every check on `device`, with the gate's verdict under "pass"."""
    results = {
        "device": device_info(device),
        "records_8x128": check_records(*FIXTURES[0], device),
        "records_16x128": check_records(*FIXTURES[1], device),
        "pipeline_single": check_pipeline(False, device),
        "pipeline_deepening": check_pipeline(True, device),
        "sort": check_sort(device),
        "tail_parity_1m": check_tail_parity(device, **TAIL_1M),
    }
    if with_10m:
        results["tail_parity_10m"] = check_tail_parity(device, **TAIL_10M)
    results["pass"] = gate(results)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--json", default=None, help="also write the result here")
    ap.add_argument("--10m", dest="with_10m", action="store_true",
                    help="add the 10M tail parity (1920x1088), reported")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("validate_kernels: no CUDA device; nothing was run",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    results = run_checks(torch.device("cuda", 0), args.with_10m)
    text = json.dumps(results)
    if args.json:
        with open(args.json, "w") as f:
            f.write(text)
    print(text)
    return 0 if results["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
