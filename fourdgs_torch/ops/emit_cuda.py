"""The quantized binning's pair-slot emission: the tile bbox, the band clip,
both tiers, the depth bits and the slot-major keys of
render.tiles.quantized_pair_keys in one pass over the splats.

Kernel K16 (`csrc/emit.cu`), launched once a tier: `emit_pair_keys` over
every splat (the main tier), then `emit_big_pair_keys` over the big tier's
ids, into the same arrays. Its plain version is
render.tiles.quantized_pair_keys_plain, the composition the reference
leaves to XLA's fusion; quantized_pair_keys takes it for CPU tensors and
these wrappers for any other. On CUDA tensors the kernel equals the plain
version bit for bit; on any other device the wrappers raise.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from fourdgs_torch.ops._build import CudaKernel
from fourdgs_torch.render.project import Projected

# The float32 fields K16 reads, in its argument order; then `valid`.
FIELDS = ("mx", "my", "depth", "v0x", "v0y", "l0", "l1")

EMIT = CudaKernel(
    "emit.cu", "fourdgs_emit_pair_keys",
    [ctypes.c_void_p] * 11 + [ctypes.c_float] * 2 + [ctypes.c_int] * 13
    + [ctypes.c_void_p] * 4, extra_flags=("-fmad=false",))


def _scalar(p, dev: torch.device, name: str):
    """(pointer tensor, value) of p00 or p11: a one-element float32 tensor
    on the fields' card is read by the kernel; a number or a CPU tensor is
    read here, with no wait for the card."""
    if not isinstance(p, torch.Tensor):
        return None, float(p)
    if p.numel() != 1:
        raise ValueError(f"{name} has shape {tuple(p.shape)}, want one "
                         f"element")
    if p.device.type == "cpu":
        return None, float(p)
    if p.device != dev:
        raise ValueError(f"{name} is on {p.device}, the fields on {dev}")
    if p.dtype != torch.float32:
        raise ValueError(f"{name} has dtype {p.dtype}, want torch.float32")
    return p, 0.0


def _check(proj: Projected, p00, p11) -> Tuple:
    """What K16 takes of the splats: the FIELDS float32, contiguous and
    (N,) like `mx`, `valid` a contiguous (N,) bool, all on one device.
    Returns the fields, the device and (pointer, value) of p00 and p11;
    raises ValueError otherwise."""
    fields = [getattr(proj, k) for k in FIELDS]
    n = fields[0].shape[0] if fields[0].dim() == 1 else None
    for k, x in zip(FIELDS + ("valid",), fields + [proj.valid]):
        if x.dim() != 1 or x.shape[0] != n:
            raise ValueError(f"field {k!r} has shape {tuple(x.shape)}, want "
                             f"({n},) like 'mx'")
    for k, x in zip(FIELDS, fields):
        if x.dtype != torch.float32:
            raise ValueError(f"field {k!r} has dtype {x.dtype}, want "
                             f"torch.float32")
        if not x.is_contiguous():
            raise ValueError(f"field {k!r} is not contiguous")
    if proj.valid.dtype != torch.bool or not proj.valid.is_contiguous():
        raise ValueError(f"valid has dtype {proj.valid.dtype}, want a "
                         f"contiguous torch.bool")
    devices = {x.device for x in fields + [proj.valid]}
    if len(devices) > 1:
        raise ValueError(f"the fields span devices "
                         f"{sorted(str(d) for d in devices)}")
    dev = devices.pop()
    return fields, dev, _scalar(p00, dev, "p00"), _scalar(p11, dev, "p11")


def _require_card(dev: torch.device):
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}: K16 runs on CUDA "
                         f"tensors, the plain version on CPU tensors")


def _geometry(width: int, height: int, tile_h: int, tile_w: int,
              tile_row_band: Optional[Tuple[int, int]],
              tile_range: Optional[Tuple[int, int]]):
    """The launch's grid arguments: the image and tile, the image's tile
    grid, the band (the whole grid without one) and the window of band tile
    ids (every tile of the band without one: no live slot lies outside)."""
    ny, nx = -(-height // tile_h), -(-width // tile_w)
    ty_base, rows = tile_row_band if tile_row_band is not None else (0, ny)
    lo, n_local = tile_range if tile_range is not None else (0, rows * nx)
    return (width, height, tile_h, tile_w, nx, ny, ty_base, rows, lo,
            n_local)


def emit_pair_keys(proj: Projected, p00, p11, width: int, height: int,
                   tile_h: int, tile_w: int, budget: int, big_budget: int = 0,
                   big_slots: int = 0,
                   tile_row_band: Optional[Tuple[int, int]] = None,
                   tile_range: Optional[Tuple[int, int]] = None):
    """K16's main launch over the N projected splats: (key, splat_idx,
    overflowed, is_big). key and splat_idx are int32 of budget * N +
    big_budget * big_slots, the main tier's `budget` slots a splat written
    slot-major and the big tier's room after them left for
    emit_big_pair_keys. With big_budget, is_big is the (N,) bool flag of
    the splats whose span passes `budget`, which leave the main tier, and
    overflowed is None (no main-tier splat overflows); without it, is_big
    is None and overflowed the int32 count of live splats whose span passes
    the budget. p00 and p11 are numbers or one-element float32 tensors;
    tile_row_band and tile_range are quantized_pair_keys'."""
    fields, dev, (p00_t, p00_v), (p11_t, p11_v) = _check(proj, p00, p11)
    _require_card(dev)
    n = fields[0].shape[0]
    slots = budget * n + big_budget * big_slots
    key = torch.empty((slots,), dtype=torch.int32, device=dev)
    splat_idx = torch.empty((slots,), dtype=torch.int32, device=dev)
    is_big = overflowed = None
    if big_budget:
        is_big = torch.empty((n,), dtype=torch.bool, device=dev)
    else:
        overflowed = torch.zeros((), dtype=torch.int32, device=dev)
    EMIT(*fields, proj.valid, None, p00_t, p11_t, p00_v, p11_v,
         *_geometry(width, height, tile_h, tile_w, tile_row_band,
                    tile_range), budget, n, n, key, splat_idx, is_big,
         overflowed, stream=torch.cuda.current_stream(dev).cuda_stream)
    return key, splat_idx, overflowed, is_big


def emit_big_pair_keys(proj: Projected, p00, p11, width: int, height: int,
                       tile_h: int, tile_w: int, big_budget: int,
                       ids: torch.Tensor, key: torch.Tensor,
                       splat_idx: torch.Tensor, overflowed: torch.Tensor,
                       tile_row_band: Optional[Tuple[int, int]] = None,
                       tile_range: Optional[Tuple[int, int]] = None):
    """K16's big-tier launch over the M kept big-tier ids (DEAD for an empty
    capacity slot): each id's `big_budget` slots, slot-major, into the last
    big_budget * M entries of emit_pair_keys' key and splat_idx (a DEAD
    entry's slots dead, its splat index N - 1). The kept ids whose span
    passes big_budget are added to `overflowed` (a 0-d int32 tensor, in
    place), which is returned."""
    fields, dev, (p00_t, p00_v), (p11_t, p11_v) = _check(proj, p00, p11)
    n, m = fields[0].shape[0], ids.shape[0]
    if (ids.dim() != 1 or ids.dtype != torch.int32 or ids.device != dev
            or not ids.is_contiguous()):
        raise ValueError(f"ids: want a contiguous (M,) int32 tensor on {dev}")
    for name, x in (("key", key), ("splat_idx", splat_idx)):
        if (x.shape != (key.shape[0],) or x.dtype != torch.int32
                or x.device != dev or not x.is_contiguous()
                or x.shape[0] < big_budget * m):
            raise ValueError(f"{name}: want a contiguous int32 tensor on "
                             f"{dev} like key, with room for "
                             f"{big_budget * m} slots")
    if (overflowed.shape != () or overflowed.dtype != torch.int32
            or overflowed.device != dev):
        raise ValueError(f"overflowed: want a 0-d int32 tensor on {dev}")
    _require_card(dev)
    first = key.shape[0] - big_budget * m
    EMIT(*fields, None, ids, p00_t, p11_t, p00_v, p11_v,
         *_geometry(width, height, tile_h, tile_w, tile_row_band,
                    tile_range), big_budget, n, m, key[first:],
         splat_idx[first:], None, overflowed,
         stream=torch.cuda.current_stream(dev).cuda_stream)
    return overflowed
