"""The conditioning rule for a footprint's float32 eigenvector.

`eigen2x2_scalar` (render/project.py) takes the eigenvector of a splat's
2x2 footprint covariance (a, b; b, c) as normalize((b, lmin - a)). Where
the footprint is nearly round and its off-diagonal b nearly 0, that vector
is of the size of the rounding error float32 arithmetic leaves in it, and
its direction, and every gradient through it (1 / norm), is noise: two
legal roundings of the covariance a few last bits apart turn it anywhere
(ROADMAP C-R7, C-R15). `eigvec_condition` is the exact norm of the vector
over that error; `ill_conditioned` names the splats below
EIGVEC_MIN_CONDITION. `footprint_inputs` gives (a, b, c) for the trainer's
params (the 20,000-splat cube of `trainer_params` by default, at t = 0.37,
512x256: the scene of ROADMAP C-R15).
"""

from __future__ import annotations

import contextlib

import torch

N_SPLATS, SEED, WIDTH, HEIGHT, T = 20_000, 1, 512, 256, 0.37
CLAMP = 1e-24                   # eigen2x2_scalar's discriminant clamp
U32 = 2.0 ** -24                # float32 unit roundoff
# A footprint whose eigenvector holds fewer rounding errors than this is
# named by the rule: its float32 direction is good to no better than about
# 1 / EIGVEC_MIN_CONDITION radians.
EIGVEC_MIN_CONDITION = 64


def trainer_params(n: int = N_SPLATS, seed: int = SEED, device=None):
    """The bench cube of n splats, Morton-ordered, in the trainer's layout
    (parallel.distributed.PARAM_FIELDS) on `device`."""
    from fourdgs_torch.scenes.cube import build_cube_scene
    from fourdgs_torch.splats.packed import morton_order
    p = morton_order(build_cube_scene(n, seed=seed, device=device))

    def cols(*keys):
        return torch.stack([p[k] for k in keys], -1)
    return dict(position4=cols("px", "py", "pz", "pt"),
                quat=cols("qw", "qx", "qy", "qz"),
                scale3=cols("sx", "sy", "sz"),
                lifetime=p["lifetime"].clone(), fade=p["fade"].clone(),
                velocity=cols("vx", "vy", "vz"),
                color=cols("cr", "cg", "cb", "ca"))


def eigvec_condition(a, b, c) -> torch.Tensor:
    """(N,) float64: the norm of eigen2x2_scalar's unnormalized eigenvector
    (b, lmin - a), computed exactly (in float64) from the float32 inputs,
    over the rounding error float32 arithmetic leaves in it: u (|a| + |c|)
    in b (a sum of products of that size) and in lmin - a, and u m^2 / d in
    lmin, where the discriminant, which cancels to d^2, carries a few units
    of m^2 through the square root (u the float32 unit roundoff)."""
    from fourdgs_torch.render.project import LAMBDA_EPS
    a, b, c = (x.double() for x in (a, b, c))
    m = 0.5 * (a + c)
    d = torch.sqrt(torch.clamp(m * m - (a * c - b * b), min=CLAMP))
    lmin = torch.clamp(m - d, min=LAMBDA_EPS)
    return torch.hypot(b, lmin - a) / (U32 * (a.abs() + c.abs() + m * m / d))


def ill_conditioned(a, b, c):
    """(N,) bool: the footprints whose eigenvector holds fewer than
    EIGVEC_MIN_CONDITION rounding errors (eigvec_condition)."""
    return eigvec_condition(a, b, c) < EIGVEC_MIN_CONDITION


@contextlib.contextmanager
def recorded_eigen_inputs(store: dict):
    """Within the block, every eigen2x2_scalar call of the projection puts
    its inputs under store["a"], ["b"], ["c"]."""
    from fourdgs_torch.render import project as PR
    orig = PR.eigen2x2_scalar

    def recorder(a, b, c):
        store.update(a=a, b=b, c=c)
        return orig(a, b, c)
    PR.eigen2x2_scalar = recorder
    try:
        yield store
    finally:
        PR.eigen2x2_scalar = orig


def footprint_inputs(params, camera, t=T):
    """(a, b, c): the (N,) eigen inputs of the splats' footprints, from the
    trainer's params through materialize_splats, the slice at t and the
    projection (no grad)."""
    from fourdgs_torch.parallel.distributed import materialize_splats
    from fourdgs_torch.render.project import project_splats
    store = {}
    with torch.no_grad(), recorded_eigen_inputs(store):
        s3, top = materialize_splats(params).at_time(t)
        project_splats(s3.position, s3.cov, s3.color, top, camera)
    return store["a"], store["b"], store["c"]
