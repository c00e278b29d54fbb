"""Automatic pipeline configuration from scene and image size (port of
fourdgs/render/autoconfig.py, same knob values; the reference module gives
the rationale of each). Both branches render: converged (the default, an
exact head plus the banded-OIT tail; scenes should be Morton-ordered once,
splats/packed.morton_order) and non-converged (progressive deepening).
"""

from __future__ import annotations

import math

from fourdgs_torch.render.pipeline import RenderConfig


def auto_render_config(n_splats: int, width: int, height: int,
                       converged: bool = True, **overrides) -> RenderConfig:
    """Loss-free production RenderConfig for the kernel pipeline; any
    RenderConfig field can be forced via **overrides (overrides win)."""
    res_scale = max(width / 1920.0, height / 1088.0, 1.0)
    budget = math.ceil(4 * res_scale)
    if n_splats >= 2_000_000:
        compact = 32 if converged else 48
    else:
        compact = 192
    cfg = dict(
        tile_h=16, tile_w=128, backend="pallas",
        max_splats_per_tile=384,
        max_tiles_per_splat=budget,
        splat_chunk=128,
        quantized_depth_sort=True,
        sort_compact_keep_cols=compact,
        big_splat_budget=16,
        big_splat_keep_cols=128,
        deepening_passes=6,
        deepening_fraction=0.34,
        sort_backend="xla",
        compact_backend="pallas",
        compact_row_len=512,
        depth_prune_cap=384,
    )
    if converged:
        cfg.update(
            max_splats_per_tile=256,
            depth_prune_cap=256,
            depth_prune_safety=1.2,
            tail_mode="banded",
            tail_bands=8,
            tail_block=(16, 16),
            tail_chunk=16384,
            tail_exact_clip=True,
        )
    else:
        cfg.update(depth_prune_safety=2.0)
    cfg.update(overrides)
    return RenderConfig(**cfg)
