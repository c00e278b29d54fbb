"""Per-tile ordered alpha compositing over packed splat records (port of
fourdgs/ops/composite_pallas.py: `record_fields` (with `pad_to`, through the
pack kernel K4), `pack_records` without pack8, `identity_carry`,
`composite_records`, `composite_records_at`).

Kernel K1 (`csrc/composite.cu`) plus its plain PyTorch version. A CPU tensor
runs the plain version; a CUDA tensor launches the kernel.

Layouts are the reference's: records (T, F=16, M) with the 10 field rows
first; pixel coordinates kx, ky (T, 1, P) in k units; carry and output
(T, 8, P) with rows r, g, b, a (sum alpha^2 T), transmittance, 0, 0, 0.
"""

from __future__ import annotations

import ctypes

import torch

from fourdgs_torch.ops import pack_cuda
from fourdgs_torch.ops._build import CudaKernel

CHUNK = 128      # records per early-exit step
_F = 16          # record rows (10 fields + zero padding)
N_FIELDS = 10
_C_SX, _C_SY, _C_V0X, _C_V0Y = 0, 1, 2, 3
_C_IL0, _C_IL1 = 4, 5
_C_R, _C_G, _C_B, _C_AEFF = 6, 7, 8, 9

ALPHA_MAX = 1.0 - 1e-6

COMPOSITE = CudaKernel(
    "composite.cu", "fourdgs_composite",
    [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4,
    # Every multiply and add rounds on its own, as in the plain version: a
    # contracted multiply-add can flip the coverage tests at their edges.
    extra_flags=("-fmad=false",))


def record_fields(proj, p00, p11, pad_to: int | None = None) -> torch.Tensor:
    """(10, N) record field matrix for every projected splat. a_eff
    premultiplies color alpha, temporal opacity and the cull flag; centers
    are in k units (NDC offset over the projection diagonal).

    With pad_to, the matrix is (10, pad_to) with zero columns past N, built
    by the pack kernel K4 (ops/pack_cuda.py) exactly as the reference's
    pack kernel builds it: centers times 1/p00 and 1/p11, and l == 0 maps
    to il == 0."""
    a_eff = proj.opacity * proj.a * proj.valid.to(proj.mx.dtype)
    if pad_to is not None:
        return pack_cuda.pack_record_fields(
            proj.mx, proj.my, proj.v0x, proj.v0y, proj.l0, proj.l1, proj.r,
            proj.g, proj.b, a_eff, p00, p11, pad_to)
    return torch.stack([
        proj.mx / p00,
        proj.my / p11,
        proj.v0x, proj.v0y,
        1.0 / proj.l0, 1.0 / proj.l1,
        proj.r, proj.g, proj.b,
        a_eff,
    ], dim=0)


def pack_records(proj, tile_splat: torch.Tensor, tile_live: torch.Tensor,
                 p00, p11, rec: torch.Tensor | None = None) -> torch.Tensor:
    """Gather per-tile splat records into the kernel layout (T, 16, M);
    tile_live zeroes a_eff of dead list entries."""
    if rec is None:
        rec = record_fields(proj, p00, p11)
    t, m = tile_splat.shape
    out = rec.new_zeros((t, _F, m))
    out[:, :N_FIELDS] = rec[:, tile_splat].permute(1, 0, 2)
    out[:, _C_AEFF] *= tile_live.to(rec.dtype)
    return out


def identity_carry(t_tiles: int, p: int, device="cpu",
                   dtype=torch.float32) -> torch.Tensor:
    """(T, 8, P) carry for the first depth slab: empty accumulators, full
    transmittance."""
    c = torch.zeros((t_tiles, 8, p), dtype=dtype, device=device)
    c[:, 4] = 1.0
    return c


def composite_plain(records, counts, kx, ky, carry) -> torch.Tensor:
    """The kernel's function on tile-aligned inputs: records (T, F, M),
    counts (T,), kx/ky (T, 1, P), carry (T, 8, P) -> new (T, 8, P).

    Chunk c of tile t runs only if c < ceil(counts[t] / 128) and the tile's
    max transmittance is above 1e-6 (the tile-wide early exit); within a
    chunk the exclusive transmittance is a sequential product."""
    t_tiles, _, m = records.shape
    acc = carry[:, 0:5].clone()                      # (T, 5, P)
    n_chunks = (counts.to(torch.int64) + CHUNK - 1) // CHUNK
    for c in range(m // CHUNK):
        go = (c < n_chunks) & (acc[:, 4].amax(dim=1) > 1e-6)
        idx = go.nonzero().squeeze(1)
        if idx.numel() == 0:
            break       # T only falls, so no tile reopens in later chunks
        rec = records[idx, :, c * CHUNK:(c + 1) * CHUNK]   # (A, F, C)

        def field(f):
            return rec[:, f, :, None]                      # (A, C, 1)

        dx = kx[idx] - field(_C_SX)                        # (A, C, P)
        dy = ky[idx] - field(_C_SY)
        v0x, v0y = field(_C_V0X), field(_C_V0Y)
        n0 = (v0x * dx + v0y * dy) * field(_C_IL0)
        n1 = (v0y * dx - v0x * dy) * field(_C_IL1)
        q = 64.0 * (n0 * n0 + n1 * n1)
        w = torch.exp(-0.5 * q)
        cover = (torch.abs(n0) <= 0.5) & (torch.abs(n1) <= 0.5) & (w >= 1e-4)
        alpha = torch.where(cover, field(_C_AEFF) * w, 0.0)
        alpha = torch.clamp(alpha, max=ALPHA_MAX)
        cp = torch.cumprod(1.0 - alpha, dim=1)
        excl = torch.cat([torch.ones_like(cp[:, :1]), cp[:, :-1]], dim=1)
        a = acc[idx]
        trans = a[:, 4:5]                                  # (A, 1, P)
        wgt = alpha * (trans * excl)
        a[:, 0] += (wgt * field(_C_R)).sum(dim=1)
        a[:, 1] += (wgt * field(_C_G)).sum(dim=1)
        a[:, 2] += (wgt * field(_C_B)).sum(dim=1)
        a[:, 3] += (alpha * wgt).sum(dim=1)
        a[:, 4] = trans[:, 0] * cp[:, -1]
        acc[idx] = a
    out = torch.zeros_like(carry)
    out[:, 0:5] = acc
    return out


def _check(records, counts, kx, ky, carry, n_sel=None):
    t, f, m = records.shape
    if f != _F or m % CHUNK:
        raise ValueError(f"records must be (T, {_F}, M), M % {CHUNK} == 0; "
                         f"got {tuple(records.shape)}")
    tiles, _, p = carry.shape
    if carry.shape != (tiles, 8, p) or kx.shape != (tiles, 1, p) \
            or ky.shape != (tiles, 1, p):
        raise ValueError("carry must be (T, 8, P) and kx, ky (T, 1, P)")
    if counts.shape != (t,) or (n_sel is None and t != tiles):
        raise ValueError("counts must be (T,) and match the records")
    for x in (records, kx, ky, carry):
        if x.dtype != torch.float32:
            raise ValueError("records, kx, ky and carry must be float32")
    for x in (counts, kx, ky, carry):
        if x.device != records.device:
            raise ValueError("all composite inputs must share a device")


def _launch(records, counts, sel, kx, ky, carry, out):
    records = records.contiguous()
    counts = counts.to(torch.int32).contiguous()
    kx, ky = kx.contiguous(), ky.contiguous()
    p = carry.shape[-1]
    COMPOSITE(records.data_ptr(), counts.data_ptr(),
              None if sel is None else sel.data_ptr(), kx.data_ptr(),
              ky.data_ptr(), carry.data_ptr(), out.data_ptr(),
              records.shape[0], _F, records.shape[2], p,
              stream=torch.cuda.current_stream(records.device).cuda_stream)


def composite_records(records: torch.Tensor, counts: torch.Tensor,
                      kx: torch.Tensor, ky: torch.Tensor,
                      carry: torch.Tensor) -> torch.Tensor:
    """(T, 16, M) records + (T, 8, P) carry -> new (T, 8, P): rows r, g, b,
    a, transmittance. carry holds the accumulators of an earlier (nearer)
    depth slab; use identity_carry() for the first slab."""
    _check(records, counts, kx, ky, carry)
    if records.device.type == "cpu":
        return composite_plain(records, counts, kx, ky, carry)
    if records.device.type != "cuda":
        raise ValueError(f"unsupported device {records.device}")
    carry = carry.contiguous()
    out = torch.empty_like(carry)
    _launch(records, counts, None, kx, ky, carry, out)
    return out


def composite_records_at(records_sel: torch.Tensor, counts_sel: torch.Tensor,
                         sel: torch.Tensor, kx_full: torch.Tensor,
                         ky_full: torch.Tensor,
                         carry_full: torch.Tensor) -> torch.Tensor:
    """One deepening pass: composite records_sel[i] into carry tile sel[i].

    Unlike the reference, which returns a new array, this updates
    `carry_full` IN PLACE (saving a (T, 8, P) copy per pass) and returns
    it. `sel` entries must be distinct; fillers with count 0 leave their
    tile unchanged."""
    _check(records_sel, counts_sel, kx_full, ky_full, carry_full,
           n_sel=sel.shape[0])
    if sel.shape != counts_sel.shape or sel.device != records_sel.device:
        raise ValueError("sel must match counts_sel in shape and device")
    if not carry_full.is_contiguous():
        raise ValueError("carry_full must be contiguous (updated in place)")
    if records_sel.device.type == "cpu":
        sel = sel.long()
        carry_full[sel] = composite_plain(records_sel, counts_sel,
                                          kx_full[sel], ky_full[sel],
                                          carry_full[sel])
        return carry_full
    if records_sel.device.type != "cuda":
        raise ValueError(f"unsupported device {records_sel.device}")
    _launch(records_sel, counts_sel, sel.to(torch.int32).contiguous(),
            kx_full, ky_full, carry_full, carry_full)
    return carry_full
