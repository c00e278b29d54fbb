"""fourdgs_torch — the PyTorch/CUDA port of `fourdgs`.

The JAX package `fourdgs/` is the reference; this package mirrors its layout
(`core/`, `splats/`, `render/`, `ops/`) and names. Plain tensor code is
PyTorch; every kernel the reference wrote in Pallas for the TPU is a CUDA C++
kernel for Hopper (`ops/csrc/`), built with `nvcc` at first use. Each kernel
has a plain PyTorch version in the same module: a wrapper given a CPU tensor
runs that version, a wrapper given a CUDA tensor launches the kernel.

This package never imports JAX.
"""
