"""K7 and K9 without the tail's weighting knobs, and K2 in ascending rows,
against the same kernels built from a checkout of the commit before those
knobs and K2's alternating rows were added, on one card.

    mkdir -p _scratch/parent
    git archive f72c293 fourdgs_torch/ops/csrc | tar -x -C _scratch/parent
    python3 -m fourdgs_torch.tools.parent_parity --parent _scratch/parent \
        [--json PATH]

Builds `ops/csrc/tail.cu` (K7), `tail_bwd.cu` (K9) and `rowsort.cu` (K2)
of the other checkout beside this tree's (each library named by a hash of
its own sources) and launches them through that checkout's argument lists,
fixed below. Renders one converged frame of the headline scene (the
10M-splat cube, Morton-ordered and dead-padded, 1920x1088,
`auto_render_config`) and one grad step, records what they hand
`tail_accumulate`, `tail_accumulate_bwd` and `rowsort_compact`, and on those
inputs checks that

  * K9 (`wd_ab` None, `alpha_pow` 0) equals the other build's bit for bit
    (it sums a splat's terms in a fixed order), at each stream;
  * K7 (the same knobs) is within K7's tolerance of the other build's (its
    atomics add in no fixed order; this tree's K7 against itself is
    reported beside it), at each stream;
  * K2 (`alternating=False`) equals the other build's bit for bit: keys,
    values, live counts and dropped, with the frame's cut and without;
  * every unweighted instance of K7 and K9 takes the other build's
    registers a thread (`cuobjdump --dump-resource-usage`; the weighted
    instances, which the other build lacks, are listed apart); K2's are
    reported.

Exit code 0 when all hold, 1 when one does not, 2 without a card. Nothing
here builds or launches at import.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

N_SPLATS, WIDTH, HEIGHT = 10_000_000, 1920, 1088
T_GRAD = 0.37
K7_RTOL, K7_ATOL = 1e-4, 1e-5
_TAIL_FLAGS = ("-fmad=false",)


def parent_kernels(parent: Path):
    """(K7, K9, K2) built from the other checkout's sources, with its
    argument lists."""
    from fourdgs_torch.ops._build import CudaKernel
    csrc = Path(parent).resolve() / "fourdgs_torch" / "ops" / "csrc"
    return (CudaKernel(str(csrc / "tail.cu"), "fourdgs_tail_accumulate",
                       [ctypes.c_void_p] * 7 + [ctypes.c_int] * 14,
                       extra_flags=_TAIL_FLAGS),
            CudaKernel(str(csrc / "tail_bwd.cu"),
                       "fourdgs_tail_accumulate_bwd",
                       [ctypes.c_void_p] * 8 + [ctypes.c_int] * 14,
                       extra_flags=_TAIL_FLAGS),
            CudaKernel(
                str(csrc / "rowsort.cu"), "fourdgs_rowsort_compact",
                [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                 ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                 ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                 ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]))


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _tail_args(band, slot_mask):
    from fourdgs_torch.ops import tail_cuda as TL
    band, band_stride = TL._strided_arg(band)
    mask, mask_stride = TL._strided_arg(slot_mask)
    return band, band_stride, mask, mask_stride


def tail_accumulate(kernel, fields, meta, band, cut, params_row, slot_mask,
                    *, k_bands, nx, ny, chunk, budget, s_cy, s_cx,
                    budget_lo=0, exact_clip=False):
    """The other build's K7 on the wrapper's arguments."""
    from fourdgs_torch.ops import tail_cuda as TL
    npts = meta.shape[1]
    ny_pad = TL.ny_padded(ny)
    n_samp = s_cy * s_cx
    acc = torch.zeros((k_bands * nx * ny_pad, TL.N_PLANES * n_samp),
                      dtype=torch.float32, device=meta.device)
    band, band_stride, mask, mask_stride = _tail_args(band, slot_mask)
    if fields.shape[1] != npts:
        fields = torch.nn.functional.pad(fields, (0, npts - fields.shape[1]))
    kernel(fields.contiguous(), meta.contiguous(), band, mask,
           cut.to(torch.int32).contiguous(),
           params_row.to(torch.float32).contiguous(), acc, npts,
           npts // chunk, chunk, budget, budget_lo, nx, ny_pad, s_cx, n_samp,
           k_bands, int(exact_clip), band_stride, mask_stride, cut.shape[0],
           stream=_stream(meta))
    return acc


def tail_accumulate_bwd(kernel, fields, meta, band, cut, params_row, d_acc,
                        slot_mask, *, k_bands, nx, ny, chunk, budget, s_cy,
                        s_cx, budget_lo=0, exact_clip=False):
    """The other build's K9 on the wrapper's arguments."""
    from fourdgs_torch.ops import tail_cuda as TL
    npts = meta.shape[1]
    d_fields = torch.empty((10, npts), dtype=torch.float32,
                           device=meta.device)
    band, band_stride, mask, mask_stride = _tail_args(band, slot_mask)
    kernel(fields.contiguous(), meta.contiguous(), band, mask,
           cut.to(torch.int32).contiguous(),
           params_row.to(torch.float32).contiguous(),
           d_acc.to(torch.float32).contiguous(), d_fields, npts,
           npts // chunk, chunk, budget, budget_lo, nx, TL.ny_padded(ny),
           s_cx, s_cy * s_cx, k_bands, int(exact_clip), band_stride,
           mask_stride, cut.shape[0], stream=_stream(meta))
    return d_fields


def rowsort_compact(kernel, key, val, keep_cols, row_len, cut, key_shift):
    """The other build's K2: ((keep, rows) key, (keep, rows) val, (rows,)
    live, dropped)."""
    from fourdgs_torch.ops import sort_cuda as S
    s = key.shape[0]
    rows = S.rowsort_rows(s, row_len)
    key, val = key.contiguous(), val.contiguous()
    ok = torch.empty((keep_cols, rows), dtype=torch.int32, device=key.device)
    ov = torch.empty_like(ok)
    live = torch.empty(rows, dtype=torch.int32, device=key.device)
    dropped = torch.zeros((), dtype=torch.int32, device=key.device)
    cut_c = None if cut is None else cut.to(torch.int32).contiguous()
    kernel(key, val, s, rows, row_len, keep_cols, cut_c,
           0 if cut_c is None else cut_c.shape[0], key_shift, ok, ov, live,
           dropped, stream=_stream(key))
    return ok, ov, live, dropped


def resource_usage(kernel) -> dict:
    """{demangled kernel name: registers a thread} of the library that holds
    `kernel` (a CudaKernel), from cuobjdump; {} where the toolkit has
    none."""
    from fourdgs_torch.ops._build import _nvcc, load_library
    lib = load_library(kernel.source, kernel.extra_flags)
    tool = Path(_nvcc()).parent / "cuobjdump"
    if not tool.is_file():
        found = shutil.which("cuobjdump")
        if found is None:
            return {}
        tool = Path(found)
    out = subprocess.run([str(tool), "--dump-resource-usage", lib._name],
                         capture_output=True, text=True, timeout=120).stdout
    regs, name = {}, None
    for line in out.splitlines():
        m = re.search(r"Function (\S+):", line)
        if m:
            name = m.group(1)
        m = re.search(r"REG:(\d+)", line)
        if m and name:
            regs[_demangle(name)] = int(m.group(1))
            name = None
    return regs


def _demangle(name: str) -> str:
    tool = shutil.which("c++filt")
    if tool is None:
        return name
    return subprocess.run([tool, name], capture_output=True, text=True,
                          timeout=30).stdout.strip() or name


def compare_registers(mine, theirs):
    """(pairs, mine only): {kernel: (this build's registers, the other's)}
    over the kernels both hold, named without their parameter lists (which
    the knobs lengthen) and without this build's last template argument
    (`false`: the instance without the knobs); and this build's weighted
    instances (`true`), which the other lacks."""
    def key(name):
        name = name.replace("(anonymous namespace)::", "")
        return name.split("(", 1)[0].replace(" ", "")
    theirs = {key(k): v for k, v in resource_usage(theirs).items()}
    pairs, only = {}, {}
    for name, regs in resource_usage(mine).items():
        k = key(name)
        if ",true>" in k:
            only[k] = regs
            continue
        k = k.replace(",false>", ">")
        pairs[k] = (regs, theirs.get(k))
    return pairs, only


def capture(frame, targets):
    """{"name": [(args, kwargs), ...]} of every call of the wrappers
    `targets` ((module, name) pairs) while `frame()` runs, arguments
    cloned."""
    seen, originals = {}, {}

    def clone(v):
        return v.detach().clone() if isinstance(v, torch.Tensor) else v
    for owner, name in targets:
        fn = getattr(owner, name)
        originals[(owner, name)] = fn

        def recorder(*args, _fn=fn, _name=name, **kwargs):
            seen.setdefault(_name, []).append(
                ([clone(a) for a in args],
                 {k: clone(v) for k, v in kwargs.items()}))
            return _fn(*args, **kwargs)
        setattr(owner, name, recorder)
    try:
        frame()
    finally:
        for (owner, name), fn in originals.items():
            setattr(owner, name, fn)
    torch.cuda.synchronize()
    return seen


def _tail_static(kw, names):
    st = {k: kw[k] for k in names}
    st["budget_lo"] = kw.get("budget_lo", 0)
    return st


def main(argv=None) -> int:
    from fourdgs_torch.core.camera import Camera
    from fourdgs_torch.ops import sort_cuda as S
    from fourdgs_torch.ops import tail_cuda as TL
    from fourdgs_torch.render import pipeline as TP
    from fourdgs_torch.render import tiles as TT
    from fourdgs_torch.render.autoconfig import auto_render_config
    from fourdgs_torch.scenes.cube import (CUBE_CAMERA, build_cube_scene,
                                           converged_cube_scene)

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True,
                    help="root of the other checkout")
    ap.add_argument("--json", default=None,
                    help="also write the results to this file")
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("parent_parity: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi)
    p7, p9, p2 = parent_kernels(Path(opts.parent))
    report = dict(device=smi, parent=str(opts.parent), failures=[])

    def hold(ok, what):
        print(f"  {'ok' if ok else 'FAILED'}: {what}")
        if not ok:
            report["failures"].append(what)

    report["registers"] = {}
    for name, mine, theirs in (("K7", TL.TAIL_ACCUMULATE, p7),
                               ("K9", TL.TAIL_ACCUMULATE_BWD, p9),
                               ("K2", S.ROWSORT, p2)):
        pairs, only = compare_registers(mine, theirs)
        report["registers"][name] = dict(
            pairs={k: list(v) for k, v in pairs.items()}, weighted=only)
        what = (f"{name} registers a thread (this build, the other): "
                f"{json.dumps(pairs)}; weighted instances {json.dumps(only)}")
        if name == "K2":
            print(f"  reported: {what}")
        else:
            hold(bool(pairs) and all(a == b for a, b in pairs.values()),
                 what)

    params = converged_cube_scene(build_cube_scene(N_SPLATS, seed=0,
                                                   device=dev))
    camera = Camera.create(**CUBE_CAMERA, width=WIDTH, height=HEIGHT,
                           device=dev)
    cfg = auto_render_config(N_SPLATS, WIDTH, HEIGHT)
    fwd = capture(lambda: TP.render_params4d_packed(params, camera, 0.0,
                                                    cfg=cfg),
                  [(TL, "tail_accumulate"), (TT, "rowsort_compact")])

    def step():
        p = {k: v.detach().clone().requires_grad_(True)
             for k, v in params.items()}
        img = TP.render_params4d_packed(p, camera, T_GRAD, cfg=cfg)
        (img[..., :3] ** 2).mean().backward()
    bwd = capture(step, [(TL, "tail_accumulate_bwd")])
    del params
    torch.cuda.empty_cache()

    report["K7"] = []
    for args, kw in fwd["tail_accumulate"]:
        fields, meta, band, rect, cut, params_row = args
        hold(kw.get("wd_ab") is None and not kw.get("alpha_pow"),
             "K7 called without the weighting knobs")
        st = _tail_static(kw, ("k_bands", "nx", "ny", "chunk", "budget",
                               "s_cy", "s_cx", "exact_clip"))
        got, again = TL.tail_accumulate(*args, **kw), \
            TL.tail_accumulate(*args, **kw)
        theirs = tail_accumulate(p7, fields, meta, band, cut, params_row,
                                 kw.get("slot_mask"), **st)
        torch.cuda.synchronize()
        d = (got - theirs).abs()
        bad = int((d > K7_ATOL + K7_RTOL * theirs.abs()).sum())
        entry = dict(splats=meta.shape[1], chunk=st["chunk"],
                     max_abs_diff=float(d.max()),
                     entries_differing=int((got != theirs).sum()),
                     entries=got.numel(),
                     self_max_abs_diff=float((got - again).abs().max()),
                     self_entries_differing=int((got != again).sum()),
                     acc_max=float(theirs.abs().max()))
        report["K7"].append(entry)
        hold(bad == 0, f"K7 at {meta.shape[1]:,} splats, chunk "
             f"{st['chunk']}: {bad} entries outside {K7_RTOL:g} rel + "
             f"{K7_ATOL:g} of the other build; {json.dumps(entry)}")

    report["K9"] = []
    for args, kw in bwd["tail_accumulate_bwd"]:
        fields, meta, band, cut, params_row, d_acc, mask = args
        st = _tail_static(kw, ("k_bands", "nx", "ny", "chunk", "budget",
                               "s_cy", "s_cx", "exact_clip"))
        got = TL.tail_accumulate_bwd(*args, **kw)
        theirs = tail_accumulate_bwd(p9, fields, meta, band, cut,
                                     params_row, d_acc, mask, **st)
        torch.cuda.synchronize()
        entry = dict(splats=meta.shape[1], chunk=st["chunk"],
                     budget_lo=st["budget_lo"],
                     entries_differing=int((got != theirs).sum()),
                     entries=got.numel(),
                     d_max=float(theirs.abs().max()))
        report["K9"].append(entry)
        hold(torch.equal(got, theirs), f"K9 bit-equal to the other build: "
             f"{json.dumps(entry)}")

    report["K2"] = []
    (key, val, keep), kw = fwd["rowsort_compact"][0]
    for cut in (kw["cut"], None):
        got = S._rowsort_compact_live(key, val, keep, kw["row_len"], cut,
                                      kw["key_shift"])
        theirs = rowsort_compact(p2, key, val, keep, kw["row_len"], cut,
                                 kw["key_shift"])
        torch.cuda.synchronize()
        same = [bool(torch.equal(a, b)) for a, b in zip(got, theirs)]
        entry = dict(slots=key.shape[0], keep=keep, row_len=kw["row_len"],
                     cut=cut is not None, equal=same,
                     dropped=int(got[3]))
        report["K2"].append(entry)
        hold(all(same), f"K2 ascending bit-equal to the other build "
             f"(keys, values, live, dropped): {json.dumps(entry)}")

    if opts.json:
        with open(opts.json, "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps(dict(ok=not report["failures"],
                          failures=report["failures"])))
    return 1 if report["failures"] else 0


if __name__ == "__main__":
    sys.exit(main())
