"""Surface models for the demo scenes.

The reference ships .vdata point clouds (teapot 3,644 / Suzanne 507 /
Icosphere 42 splats — Objects/, parsed by VDataParser.h:25-58). We load those
when the reference assets are reachable and otherwise synthesize comparable
surface models (position + outward normal per splat) so every scene runs
self-contained. The `.sd` Mage model is absent upstream
(.MISSING_LARGE_BLOBS); `synthetic_sd_model` produces an equivalent payload
for the ObjectDisplay scene.

A copy of fourdgs/scenes/models.py (numpy only, seeded as the reference;
importing the reference package would import JAX).
"""

from __future__ import annotations

import numpy as np

from fourdgs_torch.io import vdata as vio


def icosphere(subdivisions: int = 1, radius: float = 1.0) -> vio.VModel:
    """Vertices of a subdivided icosahedron with radial normals — the
    synthesized stand-in for Objects/Icosphere.vdata (42 verts at 1 subdiv)."""
    phi = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array([
        [-1, phi, 0], [1, phi, 0], [-1, -phi, 0], [1, -phi, 0],
        [0, -1, phi], [0, 1, phi], [0, -1, -phi], [0, 1, -phi],
        [phi, 0, -1], [phi, 0, 1], [-phi, 0, -1], [-phi, 0, 1],
    ], np.float64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
    ], np.int64)

    for _ in range(subdivisions):
        edge_mid = {}
        vlist = list(verts)

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in edge_mid:
                m = vlist[a] + vlist[b]
                m = m / np.linalg.norm(m)
                edge_mid[key] = len(vlist)
                vlist.append(m)
            return edge_mid[key]

        new_faces = []
        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        verts = np.asarray(vlist)
        faces = np.asarray(new_faces)

    pos = (verts * radius).astype(np.float32)
    return vio.VModel(position=pos, normal=verts.astype(np.float32))


def uv_sphere(n_theta: int = 24, n_phi: int = 48, radius: float = 1.0) -> vio.VModel:
    th = np.linspace(0.15, np.pi - 0.15, n_theta)
    ph = np.linspace(0.0, 2 * np.pi, n_phi, endpoint=False)
    t, p = np.meshgrid(th, ph, indexing="ij")
    n = np.stack([np.sin(t) * np.cos(p), np.cos(t), np.sin(t) * np.sin(p)],
                 axis=-1).reshape(-1, 3)
    return vio.VModel(position=(n * radius).astype(np.float32),
                      normal=n.astype(np.float32))


def torus(n_major: int = 64, n_minor: int = 32, r_major: float = 1.5,
          r_minor: float = 0.6) -> vio.VModel:
    """Torus point cloud — the teapot-scale synthesized workload (~2k splats,
    comparable to the 3,644-splat teapot)."""
    u = np.linspace(0, 2 * np.pi, n_major, endpoint=False)
    v = np.linspace(0, 2 * np.pi, n_minor, endpoint=False)
    uu, vv = np.meshgrid(u, v, indexing="ij")
    cx, sx = np.cos(uu), np.sin(uu)
    cv, sv = np.cos(vv), np.sin(vv)
    pos = np.stack([(r_major + r_minor * cv) * cx,
                    r_minor * sv,
                    (r_major + r_minor * cv) * sx], axis=-1).reshape(-1, 3)
    nrm = np.stack([cv * cx, sv, cv * sx], axis=-1).reshape(-1, 3)
    return vio.VModel(position=pos.astype(np.float32),
                      normal=nrm.astype(np.float32))


def teapot() -> vio.VModel:
    """The reference's flagship model if its Objects/ dir is reachable,
    otherwise a torus of comparable splat count."""
    path = vio.find_reference_object("teapot.vdata")
    if path is not None:
        return vio.load_vdata(path)
    return torus(n_major=76, n_minor=48)


def suzanne() -> vio.VModel:
    path = vio.find_reference_object("Suzanne.vdata")
    if path is not None:
        return vio.load_vdata(path)
    return uv_sphere(16, 32)


def synthetic_sd_model(n: int = 4000, seed: int = 7) -> vio.SplatModel:
    """A precomputed-covariance display model standing in for the missing
    Mage.sd (format per VDataParser.h:60-125): a gaussian-mixture 'statue' —
    a body of stacked spheres with anisotropic covariances."""
    rng = np.random.default_rng(seed)
    parts = []
    centers = [(0.0, 0.6, 0.0, 0.55), (0.0, 1.45, 0.0, 0.4),
               (0.0, 2.1, 0.0, 0.28)]
    for cx, cy, cz, r in centers:
        k = n // len(centers)
        d = rng.normal(size=(k, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        pos = np.array([cx, cy, cz]) + d * r
        tang = np.cross(d, rng.normal(size=(k, 3)))
        tang /= np.maximum(np.linalg.norm(tang, axis=1, keepdims=True), 1e-9)
        bitang = np.cross(d, tang)
        # Surface-aligned pancake covariance: wide tangentially, thin radially.
        s_t, s_b, s_n = 0.06 * r / 0.5, 0.06 * r / 0.5, 0.015
        cov3 = (s_t ** 2 * tang[:, :, None] * tang[:, None, :]
                + s_b ** 2 * bitang[:, :, None] * bitang[:, None, :]
                + s_n ** 2 * d[:, :, None] * d[:, None, :])
        cov4 = np.zeros((k, 4, 4), np.float32)
        cov4[:, :3, :3] = cov3
        cov4[:, 3, 3] = 1.0
        hue = np.clip(0.35 + 0.5 * (pos[:, 1:2] / 2.4), 0, 1)
        col = np.concatenate([hue, 0.4 + 0.3 * rng.random((k, 1)),
                              1.0 - hue * 0.6, np.full((k, 1), 0.9)], axis=1)
        parts.append((pos.astype(np.float32), col.astype(np.float32), cov4))
    pos = np.concatenate([p[0] for p in parts])
    col = np.concatenate([p[1] for p in parts]).astype(np.float32)
    cov = np.concatenate([p[2] for p in parts])
    return vio.SplatModel(position=pos, color=col, cov=cov)
