"""Evenly spaced contiguous-block subsample (port of
fourdgs/ops/lookup_pallas.py `sample_blocks`).

Kernel K3 (`csrc/sample_blocks.cu`) plus its plain PyTorch version. A CPU
tensor runs the plain version; a CUDA tensor launches the kernel.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence

import torch

from fourdgs_torch.ops._build import CudaKernel

# Sample blocks start on 8-row granules (the reference's TPU tile height).
GRANULE_ROWS = 8

SAMPLE_BLOCKS = CudaKernel(
    "sample_blocks.cu", "fourdgs_sample_blocks",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
     ctypes.c_int])


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
    for a in arrs:
        if a.device.type == "cpu":
            outs.append(sample_blocks_plain(a, stride_rows, take_rows))
            continue
        if a.device.type != "cuda":
            raise ValueError(f"unsupported device {a.device}")
        a = a.contiguous()
        nblocks = num_sample_blocks(n, stride_rows)
        out = torch.empty(nblocks * take_rows * 128, dtype=a.dtype,
                          device=a.device)
        SAMPLE_BLOCKS(a, out, nblocks, stride_rows,
                      take_rows,
                      stream=torch.cuda.current_stream(a.device).cuda_stream)
        outs.append(out)
    return outs
