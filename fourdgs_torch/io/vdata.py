"""Asset IO: the reference's .vdata and .sd splat-model formats.

Formats defined by their parsers in the reference (`VDataParser.h`):

* `.vdata` (VDataParser.h:25-58): whitespace-separated floats, 6 per record —
  position (3) + normal (3). Used for surface models (teapot/Suzanne/
  Icosphere under Objects/).
* `.sd` (VDataParser.h:60-125): whitespace-separated floats, 23 per record —
  position (3) + rgba color (4) + a full 4x4 covariance (16, column-major in
  GLM, symmetric so the distinction is moot). Used by the ObjectDisplay
  scene (Mage.sd).

Parsing happens on host (numpy); a C++ fast path for large files lives in
io/native.py with this module as the pure-Python fallback. Writers are
provided so scenes/tools can round-trip models. A copy of
fourdgs/io/vdata.py (numpy only; importing the reference package would
import JAX).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np

from fourdgs_torch.io import native as _native


@dataclasses.dataclass(frozen=True)
class VModel:
    """A surface model: per-splat position + normal (the .vdata payload)."""
    position: np.ndarray  # (N, 3) float32
    normal: np.ndarray    # (N, 3) float32

    @property
    def count(self) -> int:
        return self.position.shape[0]

    def extrema(self):
        """(minpos, maxpos) — Scenes.h:75-91 GetModelExtrema."""
        return self.position.min(axis=0), self.position.max(axis=0)


@dataclasses.dataclass(frozen=True)
class SplatModel:
    """A precomputed-covariance model: the .sd payload (VSplatData)."""
    position: np.ndarray  # (N, 3) float32
    color: np.ndarray     # (N, 4) float32
    cov: np.ndarray       # (N, 4, 4) float32

    @property
    def count(self) -> int:
        return self.position.shape[0]


def _read_floats(path: str) -> np.ndarray:
    """Whitespace-split float stream, matching the reference's line/word
    tokenizer (VDataParser.h:30-44). Uses the native C++ reader when built."""
    data = _native.read_floats(path)
    if data is not None:
        return data
    with open(path, "r") as f:
        return np.array(f.read().split(), dtype=np.float32)


def load_vdata(path: str) -> VModel:
    """Parse a .vdata file — VData::parse (VDataParser.h:25-58).

    Trailing partial records are dropped, matching the reference's stride-6
    loop bound behavior.
    """
    floats = _read_floats(path)
    n = floats.shape[0] // 6
    rec = floats[: n * 6].reshape(n, 6)
    return VModel(position=rec[:, 0:3].copy(), normal=rec[:, 3:6].copy())


def load_sd(path: str) -> SplatModel:
    """Parse a .sd file — VData::parse_splat_data (VDataParser.h:60-125)."""
    floats = _read_floats(path)
    n = floats.shape[0] // 23
    rec = floats[: n * 23].reshape(n, 23)
    # The 16 covariance floats fill a GLM mat4 column-major; covariances are
    # symmetric so transposition is a no-op, but we mirror the layout anyway.
    cov = rec[:, 7:23].reshape(n, 4, 4).transpose(0, 2, 1)
    return SplatModel(position=rec[:, 0:3].copy(), color=rec[:, 3:7].copy(),
                      cov=np.ascontiguousarray(cov))


def save_vdata(path: str, model: VModel) -> None:
    rec = np.concatenate([model.position, model.normal], axis=1)
    np.savetxt(path, rec, fmt="%.8g")


def save_sd(path: str, model: SplatModel) -> None:
    cov_cols = model.cov.transpose(0, 2, 1).reshape(model.count, 16)
    rec = np.concatenate([model.position, model.color, cov_cols], axis=1)
    np.savetxt(path, rec, fmt="%.8g")


def find_reference_object(name: str) -> Optional[str]:
    """Locate one of the reference's Objects/ assets if the reference tree is
    mounted (used by demo scripts; tests use synthesized models instead)."""
    for root in (os.environ.get("FOURDGS_OBJECTS_DIR"),
                 "/root/reference/Objects"):
        if root:
            p = os.path.join(root, name)
            if os.path.exists(p):
                return p
    return None
