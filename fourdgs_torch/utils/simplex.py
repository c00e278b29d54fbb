"""1D/2D/3D simplex noise (+ fractal sums), differentiable elementwise PyTorch
(port of fourdgs/utils/simplex.py).

The classic Gustavson construction with the reference's hash-free integer
mix in place of a permutation table. The hash is uint32 arithmetic; here it
runs in int64 with every product and sum reduced mod 2^32, which gives the
reference's values (torch's uint32 lacks the operations). The float
constants are the reference's float32 values.
"""

from __future__ import annotations

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_F2 = float(np.float32(0.5) * (np.sqrt(np.float32(3.0)) - np.float32(1.0)))
_G2 = float((np.float32(3.0) - np.sqrt(np.float32(3.0))) / np.float32(6.0))
_F3 = 1.0 / 3.0
_G3 = 1.0 / 6.0

_GRADS2 = ((1, 1), (-1, 1), (1, -1), (-1, -1),
           (1, 0), (-1, 0), (0, 1), (0, -1))
_GRADS3 = ((1, 1, 0), (-1, 1, 0), (1, -1, 0), (-1, -1, 0),
           (1, 0, 1), (-1, 0, 1), (1, 0, -1), (-1, 0, -1),
           (0, 1, 1), (0, -1, 1), (0, 1, -1), (0, -1, -1))


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32) and a constant c < 2^32,
    in two 16-bit halves of c so that no product leaves int64."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _mix(h: torch.Tensor) -> torch.Tensor:
    """The reference's finalizer: h ^= h >> 13; h *= 1274126177;
    h ^= h >> 16 (uint32)."""
    h = _mul32(h ^ (h >> 13), 1274126177)
    return h ^ (h >> 16)


def _u32(i: torch.Tensor) -> torch.Tensor:
    """An integer lattice coordinate as its uint32 bits, in int64."""
    return i.to(torch.int64) & _M32


def _hash2(ix: torch.Tensor, iy: torch.Tensor) -> torch.Tensor:
    """Integer mix hash -> [0, 8) gradient index."""
    h = (_mul32(_u32(ix), 374761393) + _mul32(_u32(iy), 668265263)) & _M32
    return _mix(h) % 8


def _hash3(ix, iy, iz):
    h = (_mul32(_u32(ix), 374761393) + _mul32(_u32(iy), 668265263)
         + _mul32(_u32(iz), 2246822519)) & _M32
    return _mix(h) % 12


def _table(rows, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(rows, dtype=like.dtype, device=like.device)


def snoise2(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """2D simplex noise in ~[-1, 1]; broadcasts over any shape."""
    s = (x + y) * _F2
    i = torch.floor(x + s)
    j = torch.floor(y + s)
    t = (i + j) * _G2
    x0 = x - (i - t)
    y0 = y - (j - t)
    i1 = (x0 > y0).to(x0.dtype)
    j1 = 1.0 - i1
    x1 = x0 - i1 + _G2
    y1 = y0 - j1 + _G2
    g2x2 = float(np.float32(2.0) * np.float32(_G2))
    x2 = x0 - 1.0 + g2x2
    y2 = y0 - 1.0 + g2x2
    ii = i.to(torch.int64)
    jj = j.to(torch.int64)
    grads = _table(_GRADS2, x0)

    def corner(cx, cy, gi):
        t = torch.clamp(0.5 - cx * cx - cy * cy, min=0.0)
        g = grads[gi]
        return (t * t) * (t * t) * (g[..., 0] * cx + g[..., 1] * cy)

    n0 = corner(x0, y0, _hash2(ii, jj))
    n1 = corner(x1, y1, _hash2(ii + i1.to(torch.int64),
                               jj + j1.to(torch.int64)))
    n2 = corner(x2, y2, _hash2(ii + 1, jj + 1))
    return 70.0 * (n0 + n1 + n2)


def snoise1(x: torch.Tensor) -> torch.Tensor:
    """1D simplex noise in ~[-1, 1] (SimplexNoise::noise(float) analog): two
    integer corners with quartic falloff and hashed gradient magnitudes."""
    i0 = torch.floor(x)
    i1 = i0 + 1.0
    x0 = x - i0
    x1 = x0 - 1.0

    def grad1(ih):
        # hash -> gradient in {-8..-1, 1..8} (classic grad1 table semantics)
        h = _mix(_mul32(_u32(ih), 374761393)) & 15
        mag = 1.0 + (h & 7).to(x.dtype)
        return torch.where((h & 8) > 0, -mag, mag)

    def corner(cx, ih):
        t = torch.clamp(1.0 - cx * cx, min=0.0)
        return (t * t) * (t * t) * grad1(ih) * cx

    n = corner(x0, i0.to(torch.int64)) + corner(x1, i1.to(torch.int64))
    # 0.395 scales the two-corner sum into ~[-1, 1] (Gustavson's constant).
    return 0.395 * n


def snoise3(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor
            ) -> torch.Tensor:
    """3D simplex noise in ~[-1, 1]: the skewed-tetrahedron traversal,
    branch-free (the six-way rank comparison as boolean arithmetic)."""
    s = (x + y + z) * _F3
    i = torch.floor(x + s)
    j = torch.floor(y + s)
    k = torch.floor(z + s)
    t = (i + j + k) * _G3
    x0 = x - (i - t)
    y0 = y - (j - t)
    z0 = z - (k - t)

    # Simplex corner ordering by coordinate ranking.
    gx = (x0 >= y0) & (x0 >= z0)
    gy = (~gx) & (y0 >= z0)
    gz = ~(gx | gy)
    i1, j1, k1 = (g.to(x0.dtype) for g in (gx, gy, gz))
    # Second-largest coordinate: not the smallest.
    sx = (x0 >= y0) | (x0 >= z0)
    sy = (y0 > x0) | (y0 >= z0)
    sz = (z0 > x0) | (z0 > y0)
    i2, j2, k2 = (g.to(x0.dtype) for g in (sx, sy, sz))

    x1 = x0 - i1 + _G3
    y1 = y0 - j1 + _G3
    z1 = z0 - k1 + _G3
    x2 = x0 - i2 + 2.0 * _G3
    y2 = y0 - j2 + 2.0 * _G3
    z2 = z0 - k2 + 2.0 * _G3
    x3 = x0 - 1.0 + 3.0 * _G3
    y3 = y0 - 1.0 + 3.0 * _G3
    z3 = z0 - 1.0 + 3.0 * _G3

    ii, jj, kk = (v.to(torch.int64) for v in (i, j, k))
    grads = _table(_GRADS3, x0)

    def corner(cx, cy, cz, gi):
        t = torch.clamp(0.6 - cx * cx - cy * cy - cz * cz, min=0.0)
        g = grads[gi]
        return (t * t) * (t * t) * (g[..., 0] * cx + g[..., 1] * cy
                                    + g[..., 2] * cz)

    def step(a, b):
        return a + b.to(torch.int64)

    n0 = corner(x0, y0, z0, _hash3(ii, jj, kk))
    n1 = corner(x1, y1, z1, _hash3(step(ii, i1), step(jj, j1), step(kk, k1)))
    n2 = corner(x2, y2, z2, _hash3(step(ii, i2), step(jj, j2), step(kk, k2)))
    n3 = corner(x3, y3, z3, _hash3(ii + 1, jj + 1, kk + 1))
    return 32.0 * (n0 + n1 + n2 + n3)


def _fractal(noise_fn, coords, octaves, lacunarity, gain):
    total = torch.zeros_like(coords[0], dtype=torch.float32)
    amp = 1.0
    freq = 1.0
    norm = 0.0
    for _ in range(octaves):
        total = total + amp * noise_fn(*(c * freq for c in coords))
        norm += amp
        freq *= lacunarity
        amp *= gain
    return total / norm


def fractal1(x: torch.Tensor, octaves: int = 4, lacunarity: float = 2.0,
             gain: float = 0.5) -> torch.Tensor:
    """Fractal (fBm) sum of snoise1 (SimplexNoise::fractal(o, x) analog)."""
    return _fractal(snoise1, (x,), octaves, lacunarity, gain)


def fractal2(x: torch.Tensor, y: torch.Tensor, octaves: int = 4,
             lacunarity: float = 2.0, gain: float = 0.5) -> torch.Tensor:
    """Fractal (fBm) sum of snoise2 (SimplexNoise::fractal analog)."""
    return _fractal(snoise2, (x, y), octaves, lacunarity, gain)


def fractal3(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor,
             octaves: int = 4, lacunarity: float = 2.0,
             gain: float = 0.5) -> torch.Tensor:
    """Fractal (fBm) sum of snoise3 (SimplexNoise::fractal(o, x, y, z))."""
    return _fractal(snoise3, (x, y, z), octaves, lacunarity, gain)
