"""Evenly spaced contiguous-block subsample and the standalone depth-prune
cut (port of fourdgs/ops/lookup_pallas.py `sample_blocks` and
`apply_cutkeys`).

Kernels K3 (`csrc/sample_blocks.cu`) and K10 (`csrc/cutkeys.cu`) plus their
plain PyTorch versions. A CPU tensor runs the plain version; a CUDA tensor
launches the kernel. `sample_plan` writes K3's partition (one thread a
16-byte vector of the output) out in plain PyTorch for the CPU tests.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence

import torch

from fourdgs_torch.ops._build import CudaKernel
from fourdgs_torch.ops.sort_cuda import CUT_TABLE, DEAD

CUT_SHIFT = 20              # a key's tile id sits above its 20 depth bits
# Sample blocks start on 8-row granules (the reference's TPU tile height).
GRANULE_ROWS = 8
# K3: threads a block, and how a thread moves its vector of the output.
SAMPLE_THREADS = 256
SAMPLE_VECTOR, SAMPLE_SCALAR = 0, 1

SAMPLE_BLOCKS = CudaKernel(
    "sample_blocks.cu", "fourdgs_sample_blocks",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
     ctypes.c_int])
APPLY_CUTKEYS = CudaKernel(
    "cutkeys.cu", "fourdgs_apply_cutkeys",
    [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int,
     ctypes.c_void_p])


def num_sample_blocks(n: int, stride_rows: int) -> int:
    rows = n // 128
    return max(1, (rows - GRANULE_ROWS) // stride_rows + 1)


def sample_blocks_plain(x: torch.Tensor, stride_rows: int,
                        take_rows: int) -> torch.Tensor:
    """Block g contributes rows [s_g, s_g + take_rows) of the (N/128, 128)
    view, s_g = (g * stride_rows // 8) * 8."""
    nblocks = num_sample_blocks(x.shape[0], stride_rows)
    g = torch.arange(nblocks, device=x.device, dtype=torch.int64)
    start = (g * stride_rows // GRANULE_ROWS) * GRANULE_ROWS * 128
    idx = start[:, None] + torch.arange(take_rows * 128, device=x.device)
    return x[idx.reshape(-1)]


def sample_plan(n: int, stride_rows: int, take_rows: int,
                base_offset: int = 0):
    """K3's partition (`csrc/sample_blocks.cu`) of one (n,) array whose
    first word lies `base_offset` words past a 16-byte boundary, written out
    in plain PyTorch: every output word with the word of the array it is
    read from, the thread (one a 16-byte vector of the output, over all
    sample blocks) and block that move it, and how: SAMPLE_VECTOR (one
    16-byte load and store) when the base is 16-byte aligned, else
    SAMPLE_SCALAR (four word loads, then four word stores). A dict of
    (words,) int64 tensors in the kernel's order (thread, word)."""
    nblocks = num_sample_blocks(n, stride_rows)
    per_block = take_rows * 32                     # vectors a sample block
    thread = torch.arange(nblocks * per_block)
    g, w = thread // per_block, 4 * (thread % per_block)
    row = (g * stride_rows // GRANULE_ROWS) * GRANULE_ROWS
    word = torch.arange(4)
    src = (row * 128 + w)[:, None] + word
    dst = (g * per_block * 4 + w)[:, None] + word
    path = SAMPLE_VECTOR if base_offset % 4 == 0 else SAMPLE_SCALAR
    thread = thread[:, None].expand(src.shape)
    return dict(dst=dst.reshape(-1), src=src.reshape(-1),
                thread=thread.reshape(-1),
                block=(thread // SAMPLE_THREADS).reshape(-1),
                path=torch.full((src.numel(),), path))


def sample_blocks(arrs: Sequence[torch.Tensor], stride_rows: int,
                  take_rows: int = 2) -> List[torch.Tensor]:
    """Every stride_rows-th 128-word row window of each (N,) int32/float32
    array contributes its first take_rows rows. Returns one
    (nblocks * take_rows * 128,) sample per input, at shared positions."""
    n = arrs[0].shape[0]
    if n % 128 or n < GRANULE_ROWS * 128:
        raise ValueError(f"sample_blocks needs N % 128 == 0 and N >= 1024, "
                         f"got {n}")
    if not 1 <= take_rows <= GRANULE_ROWS:
        raise ValueError(f"take_rows must be in [1, 8], got {take_rows}")
    for a in arrs:
        if a.shape != (n,) or a.dtype not in (torch.int32, torch.float32):
            raise ValueError(f"want (N,) int32/float32 arrays, got "
                             f"{tuple(a.shape)} {a.dtype}")
    outs = []
    nblocks = num_sample_blocks(n, stride_rows)
    stream_dev = stream = None        # taken once for the arrays' card
    for a in arrs:
        dev = a.device
        if dev.type == "cpu":
            outs.append(sample_blocks_plain(a, stride_rows, take_rows))
            continue
        if dev.type != "cuda":
            raise ValueError(f"unsupported device {dev}")
        if stream is None or dev != stream_dev:
            stream_dev = dev
            stream = torch.cuda.current_stream(dev).cuda_stream
        out = torch.empty(nblocks * take_rows * 128, dtype=a.dtype,
                          device=dev)
        SAMPLE_BLOCKS(a if a.is_contiguous() else a.contiguous(), out,
                      nblocks, stride_rows, take_rows, stream=stream)
        outs.append(out)
    return outs


def apply_cutkeys_plain(key: torch.Tensor, cut: torch.Tensor) -> torch.Tensor:
    tbl = torch.cat([cut.to(torch.int32),
                     cut.new_full((CUT_TABLE - cut.shape[0],), DEAD,
                                  dtype=torch.int32)])
    tid = torch.clamp(key >> CUT_SHIFT, 0, CUT_TABLE - 1)
    return torch.where(key <= tbl[tid.long()], key, DEAD)


def apply_cutkeys(key: torch.Tensor, cut: torch.Tensor) -> torch.Tensor:
    """key (S,) int32 pair keys, cut (T <= 2048,) int32 per-tile cut keys ->
    the pruned keys (S,): DEAD wherever key > cut[key >> 20]. The table is
    padded with DEAD, so DEAD keys (tile bits 2047) stay DEAD."""
    if key.dtype != torch.int32 or key.dim() != 1:
        raise ValueError(f"key must be (S,) int32, got {tuple(key.shape)} "
                         f"{key.dtype}")
    if cut.dtype != torch.int32 or cut.dim() != 1 \
            or cut.shape[0] > CUT_TABLE or cut.device != key.device:
        raise ValueError(f"cut must be (T <= {CUT_TABLE},) int32 on the "
                         f"keys' device, got {tuple(cut.shape)} {cut.dtype} "
                         f"on {cut.device}")
    if key.device.type == "cpu":
        return apply_cutkeys_plain(key, cut)
    if key.device.type != "cuda":
        raise ValueError(f"unsupported device {key.device}")
    key, cut = key.contiguous(), cut.contiguous()
    out = torch.empty_like(key)
    if key.shape[0]:
        APPLY_CUTKEYS(key, key.shape[0], cut, cut.shape[0], out,
                      stream=torch.cuda.current_stream(key.device).cuda_stream)
    return out
