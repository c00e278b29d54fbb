"""Build, load and launch the hand-written CUDA kernels of `ops/csrc/`.

Each `.cu` file exposes plain C entry points (no PyTorch headers), so one
`nvcc` call builds it in seconds:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o <build>/<name>-<hash>.so csrc/<name>.cu

The library is built at first use into `ops/_build/` (listed in
`.gitignore`), named by a hash of its source, the headers (`*.cuh`) beside it
and in `csrc/`, and the flags so an edited source is never served a stale
library, and loaded
with `ctypes`. Pointers and the
stream travel as `c_void_p`; every entry returns `cudaGetLastError()` after
its launch and the launcher raises when it is not 0. The launcher takes
tensors and passes their data pointers.

Nothing here runs at import: a module holding a `CudaKernel` imports on a
machine without `nvcc` or a card.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LIBS: dict = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").is_file():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (CUDA_HOME, /usr/local/cuda, "
                           "PATH): the CUDA kernels cannot be built")
    return found


def load_library(source: str, extra_flags=()) -> ctypes.CDLL:
    """Build `csrc/<source>` (once per process and per source hash) and
    return the loaded library."""
    key = (source, tuple(extra_flags))
    if key in _LIBS:
        return _LIBS[key]
    src = CSRC / source
    flags = NVCC_FLAGS + tuple(extra_flags)
    headers = b"".join(h.read_bytes() for h in sorted(
        set(src.parent.glob("*.cuh")) | set(CSRC.glob("*.cuh"))))
    digest = hashlib.sha256(src.read_bytes() + headers
                            + " ".join(flags).encode()).hexdigest()[:16]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = BUILD_DIR / f"{src.stem}-{digest}.so"
    if not lib_path.exists():
        # Build to a private name, then rename: concurrent processes (test
        # workers) never load a half-written library.
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *flags, "-o", tmp, str(src)]
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=600)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed for {source}:\n{proc.stderr}")
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    _LIBS[key] = lib
    return lib


def launch_device(args, symbol: str = "kernel"):
    """The one device of the tensors among `args` (None without tensors);
    tensors on two devices or more raise ValueError."""
    devices = {a.device for a in args if isinstance(a, torch.Tensor)}
    if len(devices) > 1:
        raise ValueError(f"{symbol}: tensor arguments span devices "
                         f"{sorted(str(d) for d in devices)}")
    return devices.pop() if devices else None


class CudaKernel:
    """One C entry point of a `csrc/` source, with its launch count.

    `argtypes` are ctypes types for the entry's arguments except the
    trailing stream, which the launcher appends. `launches` counts the
    successful launches (a plain int; tests and chip_smoke.py reset it)."""

    def __init__(self, source: str, symbol: str, argtypes, extra_flags=()):
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes) + [ctypes.c_void_p]
        self.extra_flags = tuple(extra_flags)
        self.launches = 0
        self._fn = None

    def build(self):
        if self._fn is None:
            fn = getattr(load_library(self.source, self.extra_flags),
                         self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def __call__(self, *args, stream: int):
        """Launch on `stream` with the entry's arguments in order: a tensor
        travels as its data pointer and None as a null pointer. The tensors
        (often temporary copies made by the caller) stay referenced until
        the launch is queued; a pointer taken from a temporary that is freed
        before the launch can alias the next temporary's block.

        The launch runs on the device of the tensor arguments, whatever the
        thread's current device is (an entry that sizes its grid from
        cudaGetDevice then reads that device); tensors on different devices
        raise ValueError before anything is launched. `stream` must belong
        to that device (the wrappers take the current stream of their
        tensors' device)."""
        dev = launch_device(args, self.symbol)
        ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a
                for a in args]
        ctx = (torch.cuda.device(dev) if dev is not None
               and dev.type == "cuda" else contextlib.nullcontext())
        with ctx:
            err = self.build()(*ptrs, stream)
        if err != 0:
            raise RuntimeError(f"{self.symbol} launch failed: CUDA error "
                               f"{err}")
        self.launches += 1
