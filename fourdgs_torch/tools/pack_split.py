"""Where the row pack's time goes, on one card.

    python3 -m fourdgs_torch.tools.pack_split [--passes P] [--json PATH]
                                              [--sass PATH]

At `chip_smoke.py` phase (q)'s shapes (ten float32 rows of the converged
scene's padded length, 10,010,624 words, packed with pad_to = n, and the
(10, n) cotangent of the backward), it times

  * K5's general form (`fourdgs_pack_rows`) and K14 (`fourdgs_unpack_rows`)
    in their earlier form (`tools/csrc/pack_rows_scalar.cu`, a measuring
    instrument: one thread per column) as they were and in the variants
    that source names: K5 reading through `const int* __restrict__`, K5
    issuing a thread's R loads before its first store, both, and K14 with
    16-byte accesses;
  * the port's kernels (`ops/csrc/pack.cu`, the row copy of
    `ops/csrc/row_copy.cuh`) and the trial forms of that copy
    (`tools/csrc/pack_rows_trials.cu`: plain or streaming loads and stores,
    2, 4 or 8 vectors a thread, 128 or 512 threads a block, persistent
    blocks, the rows interleaved, Hopper's bulk asynchronous copy);
  * the library calls they are held to: `torch.stack` of the rows, one copy
    of the cotangent (`cot[:, :n].clone()`);

each through its C entry on preallocated outputs, and the port's kernels
also through their wrappers (`pack_cuda.pack_rows`, `unpack_rows`: argument
checks, the autograd Function, the outputs' allocation), in P passes (3
unless told otherwise) whose order alternates, with the median of each;
then the host's time per wrapper call, so that host cost cannot hide in a
device time.

Every form's output is held against the plain versions bit for bit first.
Where the toolkit has `cuobjdump`, it counts the global loads that each K5
build issues before its first global store in the compiled code (SASS), and
with --sass writes that SASS to a file; it prints what `nvcc -Xptxas -v`
reports for every kernel either way.

Times are CUDA events around back-to-back launches after a warm-up.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

from fourdgs_torch.tools.sort_split import cuda_ms, ptxas_report

ROWS = 10
REPS = 50
PASSES = 3
HBM_BYTES_PER_S = 3.35e12
CSRC = Path(__file__).resolve().parent / "csrc"
SCALAR_SOURCE = str(CSRC / "pack_rows_scalar.cu")
PACK_VARIANTS = {
    "as it was": (),
    "const __restrict__ rows": ("-DPACK_RESTRICT",),
    "loads first": ("-DPACK_LOADS_FIRST",),
    "const __restrict__ rows + loads first": ("-DPACK_RESTRICT",
                                              "-DPACK_LOADS_FIRST"),
}
UNPACK_VARIANTS = {
    "as it was": (),
    "16-byte accesses": ("-DUNPACK_VEC4",),
}
TRIAL_SOURCE = str(CSRC / "pack_rows_trials.cu")
TRIALS = {                     # variant -> name (pack_rows_trials.cu)
    0: "2D grid, 4 vectors a thread, plain loads and stores",
    1: "2D grid, 4 vectors a thread, streaming hints",
    2: "2D grid, 2 vectors a thread, streaming hints",
    3: "2D grid, 8 vectors a thread, streaming hints",
    4: "persistent blocks, 4 vectors a thread, streaming hints",
    5: "bulk asynchronous copy through shared memory",
    6: "2D grid, 8 vectors a thread, plain loads and stores",
    7: "2D grid, 8 vectors a thread, 128 threads, streaming hints",
    8: "2D grid, 4 vectors a thread, 512 threads, streaming hints",
    9: "2D grid, 2 vectors a thread, plain loads and stores",
    10: "rows interleaved, 2 vectors a thread, streaming hints",
    11: "rows interleaved, 2 vectors a thread, plain loads and stores",
}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--json", default=None,
                    help="also write the results to this file")
    ap.add_argument("--passes", type=int, default=PASSES,
                    help="timing passes over every form, in alternating "
                         "order")
    ap.add_argument("--sass", default=None,
                    help="also write the SASS of every K5 build's kernel "
                         "to this file")
    return ap.parse_args(argv)


def host_ms(fn, reps=REPS):
    """Host milliseconds to enqueue one call of `fn` (no synchronize inside
    the loop; the queue does not fill at these counts)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / reps


def scalar_kernels(flags=()):
    """K5's general form and K14 in their earlier form, built with the
    variant's `flags`: (pack, unpack) CudaKernels."""
    from fourdgs_torch.ops import pack_cuda as PK
    from fourdgs_torch.ops._build import CudaKernel
    pack = CudaKernel(
        SCALAR_SOURCE, "fourdgs_pack_rows_scalar",
        [ctypes.c_void_p] * PK.MAX_ROWS + [ctypes.c_int, ctypes.c_void_p,
                                           ctypes.c_int, ctypes.c_int],
        extra_flags=tuple(flags))
    unpack = CudaKernel(
        SCALAR_SOURCE, "fourdgs_unpack_rows_scalar",
        [ctypes.c_void_p] + [ctypes.c_int] * 3
        + [ctypes.c_void_p] * PK.MAX_ROWS, extra_flags=tuple(flags))
    return pack, unpack


def launch_pack(kernel, pre, rows, out, n, pad_to):
    """One launch of a pack entry with the arguments `pre` and then
    `pack_cuda.PACK_ROWS`'s, on preallocated `out`."""
    from fourdgs_torch.ops import pack_cuda as PK
    kernel(*pre, *rows, *([None] * (PK.MAX_ROWS - len(rows))), len(rows),
           out, n, pad_to,
           stream=torch.cuda.current_stream(out.device).cuda_stream)
    return out


def launch_unpack(kernel, pre, d_out, n, outs):
    """One launch of an unpack entry with the arguments `pre` and then
    `pack_cuda.UNPACK_ROWS`'s, on preallocated `outs`."""
    from fourdgs_torch.ops import pack_cuda as PK
    r, pad_to = d_out.shape
    kernel(*pre, d_out, r, n, pad_to, *outs, *([None] * (PK.MAX_ROWS - r)),
           stream=torch.cuda.current_stream(d_out.device).cuda_stream)
    return outs


def earlier_pack_rows(kernel, rows, pad_to):
    """`pack_cuda.pack_rows` (forward) through the earlier form's K5."""
    rows = [x.contiguous() for x in rows]
    out = torch.empty((len(rows), pad_to), dtype=rows[0].dtype,
                      device=rows[0].device)
    return launch_pack(kernel, (), rows, out, rows[0].shape[0], pad_to)


def earlier_unpack_rows(kernel, d_out, n):
    """`pack_cuda.unpack_rows` through the earlier form's K14."""
    d_out = d_out.contiguous()
    outs = [torch.empty(n, dtype=d_out.dtype, device=d_out.device)
            for _ in range(d_out.shape[0])]
    return tuple(launch_unpack(kernel, (), d_out, n, outs))


def sass_loads_before_store(so_path: str, kernel: str, text: list):
    """Global loads (LDG) in `kernel`'s SASS before its first global store
    (STG), and its LDG and STG in all; None without cuobjdump. The
    kernel's SASS is appended to `text`."""
    tool = None
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "cuobjdump").is_file():
            tool = str(Path(cand) / "bin" / "cuobjdump")
            break
    tool = tool or shutil.which("cuobjdump")
    if tool is None:
        return None
    sass = subprocess.run([tool, "-sass", so_path], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    body, inside = [], False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = kernel in line
            continue
        if inside:
            body.append(line)
    text += [f"// {kernel} in {so_path}", *body]
    ldg = [i for i, s in enumerate(body) if re.search(r"\bLDG\b", s)]
    stg = [i for i, s in enumerate(body) if re.search(r"\bSTG\b", s)]
    first_store = stg[0] if stg else len(body)
    return dict(loads_before_first_store=sum(i < first_store for i in ldg),
                loads=len(ldg), stores=len(stg))


def trial_kernels():
    """The trial forms of the row copy (`tools/csrc/pack_rows_trials.cu`):
    (pack, unpack) CudaKernels taking a variant before the port's
    arguments."""
    from fourdgs_torch.ops import pack_cuda as PK
    from fourdgs_torch.ops._build import CudaKernel
    pack = CudaKernel(
        TRIAL_SOURCE, "fourdgs_pack_rows_trial",
        [ctypes.c_int] + [ctypes.c_void_p] * PK.MAX_ROWS
        + [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int],
        extra_flags=("-fmad=false",))
    unpack = CudaKernel(
        TRIAL_SOURCE, "fourdgs_unpack_rows_trial",
        [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 3
        + [ctypes.c_void_p] * PK.MAX_ROWS, extra_flags=("-fmad=false",))
    return pack, unpack


def split(opts, dev):
    from fourdgs_torch.ops import pack_cuda as PK
    from fourdgs_torch.ops._build import CSRC as OPS_CSRC
    from fourdgs_torch.ops._build import load_library
    from fourdgs_torch.scenes.cube import CONVERGED_PAD
    r, n = ROWS, -(-10_000_000 // CONVERGED_PAD) * CONVERGED_PAD
    gen = torch.Generator(device=dev).manual_seed(4)
    rows = [torch.randn(n, device=dev, generator=gen) for _ in range(r)]
    cot = torch.randn((r, n), device=dev, generator=gen)
    want = PK.pack_rows_plain(rows, n)
    want_bwd = PK.unpack_rows_plain(cot, n)
    moved = 2 * cot.numel() * cot.element_size()
    bound = moved / HBM_BYTES_PER_S * 1e3
    out = torch.empty_like(want)
    outs = [torch.empty(n, device=dev) for _ in range(r)]
    print(f"{r} x {n:,} float32 rows, pad_to {n:,}; bound of each "
          f"direction {bound:.4f} ms ({moved / 1e6:.1f} MB at 3.35 TB/s)")

    # Each form: (K5 on preallocated `out`, K14 on preallocated `outs`).
    forms = {}
    for name, flags in PACK_VARIANTS.items():
        k5 = scalar_kernels(flags)[0]
        forms[f"earlier, {name}"] = (
            lambda k5=k5: launch_pack(k5, (), rows, out, n, n), None)
    for name, flags in UNPACK_VARIANTS.items():
        k14 = scalar_kernels(flags)[1]
        forms[f"earlier K14, {name}"] = (
            None, lambda k14=k14: launch_unpack(k14, (), cot, n, outs))
    forms["port"] = (
        lambda: launch_pack(PK.PACK_ROWS, (), rows, out, n, n),
        lambda: launch_unpack(PK.UNPACK_ROWS, (), cot, n, outs))
    t5, t14 = trial_kernels()
    for v, name in TRIALS.items():
        forms[f"trial, {name}"] = (
            lambda v=v: launch_pack(t5, (v,), rows, out, n, n),
            lambda v=v: launch_unpack(t14, (v,), cot, n, outs))
    for name, (k5, k14) in forms.items():
        if k5 is not None:
            got = k5()
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise RuntimeError(f"K5 {name} differs from plain")
        if k14 is not None:
            got = k14()
            torch.cuda.synchronize()
            if not all(torch.equal(g, w) for g, w in zip(got, want_bwd)):
                raise RuntimeError(f"K14 {name} differs from plain")

    report = dict(rows=r, n=n, bound_ms=bound, forms={}, sass={}, ptxas=[])
    forms["library: torch.stack, one copy of the cotangent"] = (
        lambda: torch.stack(rows), lambda: cot[:, :n].clone())
    forms["port through its wrappers"] = (
        lambda: PK.pack_rows(rows, n), lambda: PK.unpack_rows(cot, n))
    names = list(forms)
    for p in range(opts.passes):
        # Alternate the order from pass to pass, so that no form is always
        # timed first or last.
        print(f"pass {p + 1} of {opts.passes}:")
        for name in names if p % 2 == 0 else names[::-1]:
            t = report["forms"].setdefault(name, {})
            for kernel, fn in zip(("K5", "K14"), forms[name]):
                if fn is not None:
                    ms = cuda_ms(fn, REPS, warmup=3)
                    t.setdefault(kernel, []).append(ms)
                    print(f"  {kernel} {name}: {ms:.4f} ms "
                          f"({bound / ms:.0%} of the bound)")
    print("medians over the passes:")
    for name, t in report["forms"].items():
        print(f"  {name}: " + "; ".join(
            f"{kernel} {statistics.median(ms):.4f} ms"
            for kernel, ms in t.items()))
    w = report["wrapper_host_ms"] = dict(
        pack_rows=host_ms(lambda: PK.pack_rows(rows, n)),
        unpack_rows=host_ms(lambda: PK.unpack_rows(cot, n)))
    print(f"  host time a wrapper call: pack_rows {w['pack_rows']:.4f} ms, "
          f"unpack_rows {w['unpack_rows']:.4f} ms")

    sass_text = []
    builds = [(f"earlier, {name}", SCALAR_SOURCE, flags, "pack_rows_kernel")
              for name, flags in PACK_VARIANTS.items()]
    builds.append(("port", PK.PACK_ROWS.source, PK.PACK_ROWS.extra_flags,
                   "copy_rows_kernel"))
    for name, source, flags, kernel in builds:
        so = load_library(source, flags)._name
        counts = sass_loads_before_store(so, kernel, sass_text)
        report["sass"][name] = counts
        print(f"  SASS of K5 {name}: " + (
            "no cuobjdump in this toolkit" if counts is None else
            f"{counts['loads_before_first_store']} global loads before "
            f"the first global store ({counts['loads']} loads, "
            f"{counts['stores']} stores in all)"))
    if opts.sass and sass_text:
        Path(opts.sass).write_text("\n".join(sass_text))
    for flags in PACK_VARIANTS.values():
        report["ptxas"] += ptxas_report([SCALAR_SOURCE], flags)
    report["ptxas"] += ptxas_report([SCALAR_SOURCE], UNPACK_VARIANTS[
        "16-byte accesses"])
    report["ptxas"] += ptxas_report([OPS_CSRC / "pack.cu", TRIAL_SOURCE],
                                    ("-fmad=false",))
    for e in report["ptxas"]:
        print("  ptxas: " + json.dumps(e))
    return report


def main(argv=None) -> int:
    opts = parse_args(argv)
    if not torch.cuda.is_available():
        print("pack_split: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi)
    report = split(opts, dev)
    report["device"] = smi
    if opts.json:
        with open(opts.json, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
