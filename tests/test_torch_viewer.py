"""Parity of the port's viewer CLI with the JAX reference on the CPU:
`viewer.cli.main` against the reference's `main` (both with --cpu) on the
scenes `gaussians2d`, `gaussians3d`, `gaussians4d` and `clouds` at 64x64,
for --backend xla, dense and pallas (the reference's kernel in interpret
mode), and for --blend, --set (generator keywords and array edits, all
splats and --splat-index), --grid, --axis, --sweep and --list. The PNGs
must agree within 1/255 a channel.

`gaussians4d` is viewed from off its default camera: from (30, 30, 30)
looking down the diagonal, its one splat's screen covariance is diagonal in
exact arithmetic, so the footprint's eigenvector is decided by the last
bits of an off-diagonal 0 (ROADMAP C-R7) and the two sides draw the
ellipse turned by up to 90 degrees (test_gaussians4d_default_view_is_c_r7
holds what does agree there).
"""

import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from fourdgs.viewer import cli as RV  # noqa: E402
from fourdgs_torch.io.png import read_png  # noqa: E402
from fourdgs_torch.viewer import cli as TV  # noqa: E402

SIZE = ["--width", "64", "--height", "64", "--cpu"]
G4_VIEW = ["--cam-pos", "26,33,29", "--cam-dir=-0.9,-1.1,-1"]
SCENES = {"gaussians2d": [], "gaussians3d": [], "gaussians4d": G4_VIEW,
          "clouds": ["--t", "5"]}
CASES = {f"{s} {b}": ["--scene", s, "--backend", b] + v
         for s, v in SCENES.items() for b in ("xla", "dense", "pallas")}
CASES.update({
    "clouds blend one,one": ["--scene", "clouds", "--blend", "one,one"],
    "gaussians4d blend": ["--scene", "gaussians4d", "--blend",
                          "src_alpha,one_minus_src_alpha"] + G4_VIEW,
    "gaussians2d blend": ["--scene", "gaussians2d", "--blend",
                          "src_color,one"],
    "gaussians3d blend": ["--scene", "gaussians3d", "--blend",
                          "one,one_minus_src_alpha"],
    "gaussians4d set keywords": ["--scene", "gaussians4d", "--set",
                                 "scale=2,5,3", "--set", "color=1,0,0,0.8",
                                 "--set", "lifetime=3"] + G4_VIEW,
    "clouds set one splat": ["--scene", "clouds", "--set",
                             "color=1,0.5,0,0.8", "--splat-index", "3",
                             "--backend", "dense"],
    "gaussians3d set all": ["--scene", "gaussians3d", "--set",
                            "position=1,2,-3", "--splat-index", "0",
                            "--backend", "dense"],
    "clouds grid axis": ["--scene", "clouds", "--grid", "--axis", "--t", "5",
                         "--backend", "dense"],
})


def _run(main, args, out):
    assert main(args + SIZE + ["--out", out]) == 0


@pytest.mark.parametrize("case", list(CASES))
def test_viewer_png_matches_reference(case, tmp_path, capsys):
    args = CASES[case]
    _run(RV.main, args, str(tmp_path / "ref.png"))
    ref_line = capsys.readouterr().out.split()
    _run(TV.main, args, str(tmp_path / "port.png"))
    port_line = capsys.readouterr().out.split()
    want = read_png(str(tmp_path / "ref.png")).astype(int)
    got = read_png(str(tmp_path / "port.png")).astype(int)
    assert got.shape == want.shape == (64, 64, 4)
    assert np.abs(got - want).max() <= 1, case
    assert want[..., :3].max() > 0, case                 # something drawn
    # The printed line: path, t, shape, seconds, mean rgb (4 decimals).
    assert port_line[1:5] == ref_line[1:5] and port_line[-1] == ref_line[-1]


def test_viewer_sweep_matches_reference(tmp_path, capsys):
    args = ["--scene", "gaussians4d", "--backend", "dense",
            "--sweep=-1:1:3"] + G4_VIEW
    _run(RV.main, args, str(tmp_path / "ref"))
    _run(TV.main, args, str(tmp_path / "port"))
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 6
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "ref")) == [
        "frame_0000.png", "frame_0001.png", "frame_0002.png"]
    for name in names:
        got = read_png(str(tmp_path / "port" / name)).astype(int)
        want = read_png(str(tmp_path / "ref" / name)).astype(int)
        assert np.abs(got - want).max() <= 1, name


def test_viewer_list_and_errors(capsys, tmp_path):
    assert TV.main(["--list"]) == 0 == RV.main(["--list"])
    out = capsys.readouterr().out.splitlines()
    assert out[:12] == out[12:] and len(out) == 24 and out[0] == "empty"
    assert TV.main(["--scene", "nope", "--cpu"]) == 2
    assert TV.main(["--scene", "clouds", "--blend", "one", "--cpu",
                    "--out", str(tmp_path / "x.png")]) == 2
    with pytest.raises(SystemExit):
        TV.main(["--scene", "clouds", "--set", "spin=1", "--cpu",
                 "--out", str(tmp_path / "x.png")])
    # Same flags as the reference.
    flags = {a.dest for a in TV.build_argparser()._actions}
    assert flags == {a.dest for a in RV.build_argparser()._actions}


def test_apply_overrides_matches_reference():
    """Array-level --set edits of a dict (the packed form): all rows, and
    one row of a vector field (the reference cannot set one row of a
    per-splat scalar: it broadcasts the value to (1,))."""
    rng = np.random.default_rng(0)
    d = {"position": rng.random((5, 4)).astype(np.float32),
         "lifetime": rng.random(5).astype(np.float32)}
    for index, sets in ((None, ["position=1,2,3,4", "lifetime=7"]),
                        (2, ["position=1,2,3,4", "position=5"])):
        want = RV.apply_overrides({k: jnp.asarray(v) for k, v in d.items()},
                                  sets, index)
        got = TV.apply_overrides({k: torch.from_numpy(v) for k, v in
                                  d.items()}, sets, index)
        for k in d:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    with pytest.raises(SystemExit):
        TV.apply_overrides({"position": torch.zeros(2, 4)},
                           ["position=1,2"], None)


def test_gaussians4d_default_view_is_c_r7():
    """At gaussians4d's own camera the splat's screen covariance has an
    off-diagonal 0 in exact arithmetic: both sides agree on the covariance
    and on the footprint's axis lengths, while the eigenvector, and so the
    drawn ellipse's orientation, follows rounding (ROADMAP C-R7)."""
    from fourdgs.core.camera import Camera as RCamera
    from fourdgs.render.project import project_splats as r_project
    from fourdgs.scenes import scenes as RS
    from fourdgs_torch.core.camera import Camera as TCamera
    from fourdgs_torch.render.project import project_splats as t_project
    from fourdgs_torch.scenes import scenes as TS
    rs, st = RS.gaussians_4d()
    ts, _ = TS.gaussians_4d(device="cpu")
    view = dict(position=st.camera_position,
                orientation=st.camera_orientation, width=64, height=64)
    rsl, rtop = rs.at_time(0.0)
    tsl, ttop = ts.at_time(torch.tensor(0.0))
    want = r_project(rsl.position, rsl.cov, rsl.color, rtop,
                     RCamera.create(**view))
    got = t_project(tsl.position, tsl.cov, tsl.color, ttop,
                    TCamera.create(**view, device="cpu"))
    for f in ("l0", "l1", "depth", "view_z"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=1e-6)
    np.testing.assert_allclose(ts.cov.numpy(), np.asarray(rs.cov),
                               rtol=0, atol=1e-6 * float(np.abs(rs.cov).max()))
    assert abs(float(want.mx[0])) < 1e-6 and abs(float(got.mx[0])) < 1e-6
