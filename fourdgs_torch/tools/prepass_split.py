"""Where the tail's setup kernels' time goes, on one card: K6 (the tail
prepass) and K3 (the block sampler).

    python3 -m fourdgs_torch.tools.prepass_split [--width W --height H]
                                                 [--passes P] [--json PATH]
                                                 [--sass PATH]
                                                 [--earlier-only]

Renders one converged frame of the headline scene (the 10M-splat cube,
Morton-ordered and dead-padded, `auto_render_config`; 1920x1088 unless told,
3840x2160 renders in two bands) and records what the frame hands K6
(`tail_cuda.tail_prepass`: the main and the big-tier stream of each band) and
K3 (`sample_blocks`: the depth prune's sample and the band-cut sample of each
band). Then, at every call site:

  * K6: the chunks, the chunk size, the live share of the entries in the
    stream's span window, the share of chunks with a live entry, whether a
    slot-mask bit can be set at all (nsub <= 30), and the bytes the function
    must read (the span row and the 32-byte sectors of the other rows that
    hold a live entry), which the bound counts; then the earlier form
    (`tools/csrc/tail_prepass_block_chunk.cu`, one block a chunk, a
    measuring instrument) as it was and in the variants its source names
    (all six loads before the live test, no sub-block maxima when nsub > 30,
    1,024 threads), the port's kernel, the trial forms of the port's kernel
    (`tools/csrc/tail_prepass_trials.cu`: block widths, vectors a thread,
    load hints, the span loaded before the other five rows and those only
    where it is live, all six loads first) in thread-block clusters of every
    size the chunk allows (1 = one block a chunk, as the port runs it), and
    the port through its wrapper; each form's
    output held against the plain version bit for bit first. Times: CUDA
    events around back-to-back launches after a warm-up, in P passes (3
    unless told) of alternating order, medians.
  * K3, three times, so that host cost cannot pass for device time:
    (a) the wrapper (`lookup_cuda.sample_blocks`) back to back, as
        chip_smoke.py times it; (b) the kernel alone: REPS launches captured
        in one CUDA graph and replayed between two events (and, for the
        earlier form, enqueued by one C loop of the instrument's library);
        (c) the kernel alone with the L2 flushed before each launch (a 512 MB
        write), each launch between its own two events, which is how a frame
        finds the keys. The earlier form (`tools/csrc/sample_blocks_word.cu`,
        one block a sample block, one word a thread), its variant with one
        thread a 16-byte vector, the port's kernel, and an empty kernel
        launched the same ways (the floor any launch has on this card). Then
        the host's time a wrapper call.

It prints what `nvcc -Xptxas -v` reports for every instance, and where the
toolkit has `cuobjdump` the global loads of each K6 build (all, 16-byte,
and before the first conditional branch); --sass writes their SASS to a
file. With --earlier-only it builds, checks and times only the earlier
forms, their variants and the empty kernel, and K3's wrapper time (a) is
that of the earlier form behind the steps its wrapper took (the split
before the port's kernels are redesigned).
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
from pathlib import Path

import torch

from fourdgs_torch.tools.pack_split import host_ms
from fourdgs_torch.tools.sort_split import cuda_ms, ptxas_report

N_SPLATS, WIDTH, HEIGHT = 10_000_000, 1920, 1088
REPS = 20
K3_REPS = 200
PASSES = 3
FLUSH_BYTES = 512 << 20          # ten times the H100's 50 MB L2, and long
#                                  enough that the host stays ahead of it
HBM_BYTES_PER_S = 3.35e12
CSRC = Path(__file__).resolve().parent / "csrc"
BLOCK_CHUNK_SOURCE = str(CSRC / "tail_prepass_block_chunk.cu")
K6_VARIANTS = {
    "as it was": (),
    "six loads before the live test": ("-DPREPASS_UNCONDITIONAL",),
    "no sub-block maxima when nsub > 30": ("-DPREPASS_SKIP_SUBMAX",),
    "1,024 threads": ("-DPREPASS_THREADS=1024",),
}
TRIAL_SOURCE = str(CSRC / "tail_prepass_trials.cu")
K6_TRIALS = {                  # variant -> name (tail_prepass_trials.cu)
    0: "256 threads, 2 vectors a row, streaming, span first (the port's)",
    1: "256 threads, 2 vectors a row, streaming, all six loads first",
    2: "256 threads, 2 vectors a row, plain loads, span first",
    3: "256 threads, 2 vectors a row, plain loads, all six loads first",
    4: "256 threads, 1 vector a row, streaming, span first",
    5: "256 threads, 4 vectors a row, streaming, span first",
    6: "128 threads, 2 vectors a row, streaming, span first",
    7: "512 threads, 2 vectors a row, streaming, span first",
    8: "128 threads, 2 vectors a row, streaming, all six loads first",
}
WORD_SOURCE = str(CSRC / "sample_blocks_word.cu")
K3_VARIANTS = {
    "as it was": (),
    "one thread a 16-byte vector": ("-DSAMPLE_VEC4",),
}
K6_FLAGS = ("-fmad=false",)    # K6 shares the tail's flags (tail_cuda.py)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--width", type=int, default=WIDTH)
    ap.add_argument("--height", type=int, default=HEIGHT)
    ap.add_argument("--passes", type=int, default=PASSES,
                    help="timing passes over every form, in alternating "
                         "order")
    ap.add_argument("--json", default=None,
                    help="also write the results to this file")
    ap.add_argument("--sass", default=None,
                    help="also write the SASS of every K6 build to this file")
    ap.add_argument("--earlier-only", action="store_true",
                    help="only the earlier forms, their variants and the "
                         "empty kernel")
    return ap.parse_args(argv)


# ---------------------------------------------------------------------------
# the instruments
# ---------------------------------------------------------------------------

def block_chunk_kernel(flags=()):
    """K6 in its earlier form, built with the variant's `flags`."""
    from fourdgs_torch.ops._build import CudaKernel
    return CudaKernel(BLOCK_CHUNK_SOURCE, "fourdgs_tail_prepass_block_chunk",
                      [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6,
                      extra_flags=K6_FLAGS + tuple(flags))


def trial_kernel():
    """The trial forms of the port's K6, taking a variant first and the
    cluster size last."""
    from fourdgs_torch.ops._build import CudaKernel
    return CudaKernel(TRIAL_SOURCE, "fourdgs_tail_prepass_trial",
                      [ctypes.c_int] + [ctypes.c_void_p] * 3
                      + [ctypes.c_int] * 7, extra_flags=K6_FLAGS)


def word_kernels(flags=()):
    """K3 in its earlier form (with the variant's `flags`): (one launch, a C
    loop of launches, the empty kernel's C loop) CudaKernels."""
    from fourdgs_torch.ops._build import CudaKernel
    one = CudaKernel(WORD_SOURCE, "fourdgs_sample_blocks_word",
                     [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3,
                     extra_flags=tuple(flags))
    loop = CudaKernel(WORD_SOURCE, "fourdgs_sample_blocks_word_loop",
                      [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4,
                      extra_flags=tuple(flags))
    empty = CudaKernel(WORD_SOURCE, "fourdgs_empty_launch",
                       [ctypes.c_int] * 3, extra_flags=tuple(flags))
    return one, loop, empty


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def earlier_tail_prepass(kernel, meta, band_cuts, chunk, budget,
                         budget_lo=0, k_bands=8, out=None):
    """`tail_cuda.tail_prepass` through the earlier form's K6 `kernel`: on
    `out` when given, returning the (S, 6) rows; else behind the steps the
    wrapper took before the kernel was redesigned (its checks, the copies,
    the output's allocation, the stream), returning (band, rect, mask)."""
    npts = meta.shape[1]
    steps = npts // chunk
    if out is not None:
        kernel(meta, band_cuts, out, npts, chunk, budget, budget_lo,
               k_bands - 1, steps, stream=_stream(meta))
        return out
    if meta.dtype != torch.int32 or meta.shape[0] != 6 or npts % chunk:
        raise ValueError(f"meta must be (6, Np) int32 with Np % {chunk} == 0,"
                         f" got {tuple(meta.shape)} {meta.dtype}")
    if band_cuts.shape != (k_bands - 1,) or band_cuts.device != meta.device:
        raise ValueError(f"band_cuts must be ({k_bands - 1},) on the meta's "
                         "device")
    meta = meta.contiguous()
    cuts = band_cuts.to(torch.int32).contiguous()
    out = torch.empty((steps, 6), dtype=torch.int32, device=meta.device)
    kernel(meta, cuts, out, npts, chunk, budget, budget_lo, k_bands - 1,
           steps, stream=_stream(meta))
    return out[:, 0], out[:, 1:5], out[:, 5]


def earlier_sample_blocks(kernel, x, stride_rows, take_rows, out=None):
    """`lookup_cuda.sample_blocks` of one array through the earlier form's
    K3 `kernel`: on `out` when given; else behind the steps the wrapper
    took before the kernel was redesigned (its checks, a contiguous copy,
    the output's allocation, the stream)."""
    from fourdgs_torch.ops import lookup_cuda as L
    n = x.shape[0]
    if out is not None:
        kernel(x, out, L.num_sample_blocks(n, stride_rows), stride_rows,
               take_rows, stream=_stream(x))
        return out
    if n % 128 or n < L.GRANULE_ROWS * 128:
        raise ValueError(f"sample_blocks needs N % 128 == 0 and N >= 1024, "
                         f"got {n}")
    if not 1 <= take_rows <= L.GRANULE_ROWS:
        raise ValueError(f"take_rows must be in [1, 8], got {take_rows}")
    if x.shape != (n,) or x.dtype not in (torch.int32, torch.float32):
        raise ValueError(f"want (N,) int32/float32 arrays, got "
                         f"{tuple(x.shape)} {x.dtype}")
    x = x.contiguous()
    nblocks = L.num_sample_blocks(n, stride_rows)
    out = torch.empty(nblocks * take_rows * 128, dtype=x.dtype,
                      device=x.device)
    kernel(x, out, nblocks, stride_rows, take_rows,
           stream=torch.cuda.current_stream(x.device).cuda_stream)
    return out


def build_all(earlier_only=False):
    """Every library this split runs, one nvcc each, all started together."""
    from concurrent.futures import ThreadPoolExecutor

    from fourdgs_torch.ops import lookup_cuda as L
    from fourdgs_torch.ops import tail_cuda as TL
    kernels = [] if earlier_only else [TL.TAIL_PREPASS, L.SAMPLE_BLOCKS,
                                       trial_kernel()]
    kernels += [block_chunk_kernel(f) for f in K6_VARIANTS.values()]
    for flags in K3_VARIANTS.values():
        kernels += list(word_kernels(flags))
    from fourdgs_torch.ops._build import load_library
    libs = {(k.source, k.extra_flags) for k in kernels}
    with ThreadPoolExecutor(len(libs)) as ex:
        list(ex.map(lambda sf: load_library(*sf), libs))
    for k in kernels:
        k.build()


# ---------------------------------------------------------------------------
# inputs and timing
# ---------------------------------------------------------------------------

def capture(params, camera, cfg):
    """The cloned arguments of every K6 and K3 wrapper call of one frame:
    (name, args, kwargs) in call order."""
    from fourdgs_torch.ops import tail_cuda as TL
    from fourdgs_torch.render import pipeline as TP
    from fourdgs_torch.render import tiles as TT
    calls, originals = [], {}

    def wrap(owner, name, label):
        fn = getattr(owner, name)
        originals[(owner, name)] = fn

        def recorder(*args, **kwargs):
            def clone(a):
                if isinstance(a, (list, tuple)):
                    return type(a)(clone(x) for x in a)
                return a.clone() if hasattr(a, "clone") else a
            calls.append((label, clone(list(args)),
                          {k: clone(v) for k, v in kwargs.items()}))
            return fn(*args, **kwargs)
        setattr(owner, name, recorder)
    wrap(TL, "tail_prepass", "K6")
    wrap(TT, "sample_blocks", "K3 prune sample")
    wrap(TP, "sample_blocks", "K3 band-cut sample")
    try:
        TP.render_params4d_packed(params, camera, 0.0, cfg=cfg)
    finally:
        for (owner, name), fn in originals.items():
            setattr(owner, name, fn)
    torch.cuda.synchronize()
    return calls


def turns(forms, passes, reps):
    """Median ms a call of each form (name -> callable) over `passes`
    passes of back-to-back launches, the order alternating."""
    names = list(forms)
    times = {name: [] for name in names}
    for p in range(passes):
        for name in names if p % 2 == 0 else names[::-1]:
            times[name].append(cuda_ms(forms[name], reps, warmup=3))
    return {name: dict(median=statistics.median(t), turns_ms=t)
            for name, t in times.items()}


def graph_ms(launch, reps=K3_REPS, replays=5):
    """Device ms a launch: `reps` launches captured in one CUDA graph, the
    graph replayed `replays` times between two events."""
    launch()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            launch()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def loop_ms(launch_reps, reps=K3_REPS, replays=5):
    """Device ms a launch when `launch_reps(n)` enqueues n launches from one
    C loop."""
    launch_reps(reps)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        launch_reps(reps)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def cold_ms(launch, flush, reps=50):
    """Mean ms of one launch between its own two events, each after a write
    of `flush` (larger than the L2) has evicted what the last launch read."""
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for _ in range(2):
        flush.zero_()
        launch()
    for start, end in events:
        flush.zero_()
        start.record()
        launch()
        end.record()
    torch.cuda.synchronize()
    return statistics.mean(s.elapsed_time(e) for s, e in events)


# ---------------------------------------------------------------------------
# the two kernels
# ---------------------------------------------------------------------------

def prepass_bytes(meta, budget_lo, budget):
    """Bytes K6 must read of a meta matrix: the span row, and the 32-byte
    sectors (8 entries) of the other five rows that hold an entry in the
    span window (budget_lo, budget]."""
    span = meta[5]
    live = ((span > budget_lo) & (span <= budget)).nonzero().squeeze(1)
    sectors = (live // 8).unique_consecutive().numel()
    return span.numel() * 4 + 5 * 32 * sectors


def k6_stats(meta, chunk, budget, budget_lo):
    """What the split needs to know of one K6 input; `bound_ms` counts the
    bytes prepass_bytes says the function must read."""
    from fourdgs_torch.ops import tail_cuda as TL
    span = meta[5].reshape(-1, chunk)
    live = (span > budget_lo) & (span <= budget)
    nsub = max(1, chunk // TL.SUB)
    needed = prepass_bytes(meta, budget_lo, budget)
    return dict(chunks=span.shape[0], chunk=chunk,
                budget=[budget_lo, budget],
                live_share=float(live.double().mean()),
                chunks_with_live=float(live.any(dim=1).double().mean()),
                mask_bits_possible=nsub <= TL.MASK_BITS,
                mb=meta.numel() * 4 / 1e6, needed_mb=needed / 1e6,
                all_bytes_bound_ms=meta.numel() * 4 / HBM_BYTES_PER_S * 1e3,
                bound_ms=needed / HBM_BYTES_PER_S * 1e3)


def k6_site(label, args, kw, passes, earlier_only=False):
    from fourdgs_torch.ops import tail_cuda as TL
    meta, cuts, chunk, budget = args
    budget_lo, k_bands = kw.get("budget_lo", 0), kw.get("k_bands", 8)
    steps, npts = meta.shape[1] // chunk, meta.shape[1]
    st = k6_stats(meta, chunk, budget, budget_lo)
    band, rect, mask = TL.step_bands_rects(meta, chunk, cuts, budget_lo,
                                           budget) + (
        TL.step_slot_masks(meta, chunk, budget, budget_lo),)
    want = torch.cat([band[:, None], rect, mask[:, None]], dim=1)
    out = torch.empty_like(want)
    cuts32 = cuts.to(torch.int32).contiguous()
    forms = {}
    for name, flags in K6_VARIANTS.items():
        k = block_chunk_kernel(flags)
        forms[f"earlier, {name}"] = (
            lambda k=k: earlier_tail_prepass(k, meta, cuts32, chunk, budget,
                                             budget_lo, k_bands, out))

    def launch(kernel, pre=(), post=()):
        kernel(*pre, meta, cuts32, out, npts, chunk, budget, budget_lo,
               k_bands - 1, steps, *post, stream=_stream(meta))
        return out
    pieces_ok = [c for c in (1, 2, 4, 8) if chunk % c == 0 and (
        chunk <= TL.SUB or (chunk // c) % TL.SUB == 0)]
    if not earlier_only:
        forms["port"] = lambda: launch(TL.TAIL_PREPASS)
        trial = trial_kernel()
        for v, name in K6_TRIALS.items():
            for c in pieces_ok:
                forms[f"trial, {name}, cluster of {c}"] = (
                    lambda v=v, c=c: launch(trial, (v,), (c,)))
    for name, fn in forms.items():
        got = fn()
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise RuntimeError(f"K6 {label} {name} differs from plain")
    if not earlier_only:
        forms["port through its wrapper"] = (
            lambda: TL.tail_prepass(meta, cuts, chunk, budget, budget_lo,
                                    k_bands))
    ms = turns(forms, passes, REPS)
    # The device's time alone: launches replayed from a CUDA graph.
    alone = {name: graph_ms(forms[name], reps=REPS)
             for name in ("earlier, as it was", "port") if name in forms}
    print(f"K6 {label}: " + json.dumps(st))
    for name, t in ms.items():
        print(f"  {name}: {t['median']:.4f} ms "
              f"({st['bound_ms'] / t['median']:.0%} of the bound)")
    print("  the kernel alone, one CUDA graph: " + "; ".join(
        f"{name} {t:.4f} ms" for name, t in alone.items()))
    return dict(site=label, stats=st, ms=ms, graph_ms=alone)


def k3_site(label, args, kw, flush, passes, earlier_only=False):
    from fourdgs_torch.ops import lookup_cuda as L
    (key,), stride, take = args[0], kw["stride_rows"], kw["take_rows"]
    nblocks = L.num_sample_blocks(key.shape[0], stride)
    want = L.sample_blocks_plain(key, stride, take)
    out = torch.empty_like(want)
    st = dict(words=key.shape[0], stride_rows=stride, take_rows=take,
              sample_blocks=nblocks, sample_words=want.shape[0],
              port_threads=nblocks * take * 32,
              port_blocks=-(-nblocks * take * 32 // L.SAMPLE_THREADS),
              bound_ms=2 * want.numel() * 4 / HBM_BYTES_PER_S * 1e3)

    def port():
        L.SAMPLE_BLOCKS(key, out, nblocks, stride, take, stream=_stream(key))
        return out
    alone = {} if earlier_only else {"port": port}
    loops = {}
    for name, flags in K3_VARIANTS.items():
        one, loop, empty = word_kernels(flags)
        alone[f"earlier, {name}"] = (
            lambda one=one: earlier_sample_blocks(one, key, stride, take,
                                                  out))
        loops[f"earlier, {name}"] = (
            lambda n, loop=loop: loop(key, out, nblocks, stride, take, n,
                                      stream=_stream(key)))
    empty = word_kernels()[2]
    for name, fn in alone.items():
        got = fn()
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise RuntimeError(f"K3 {label} {name} differs from plain")
    alone["empty kernel, one block of 32 threads"] = (
        lambda: empty(1, 32, 1, stream=_stream(key)))
    loops["empty kernel, one block of 32 threads"] = (
        lambda n: empty(1, 32, n, stream=_stream(key)))
    if earlier_only:
        one = word_kernels()[0]
        wrapper = {"earlier, behind its wrapper's steps (a)":
                   lambda: earlier_sample_blocks(one, key, stride, take)}
    else:
        wrapper = {"port through its wrapper (a)":
                   lambda: L.sample_blocks([key], stride, take)}
    res = dict(site=label, stats=st,
               a_back_to_back=turns({**wrapper, **alone}, passes, K3_REPS),
               b_graph={}, b_c_loop={}, c_cold_l2={})
    for p in range(passes):
        names = list(alone) if p % 2 == 0 else list(alone)[::-1]
        for name in names:
            res["b_graph"].setdefault(name, []).append(graph_ms(alone[name]))
            res["c_cold_l2"].setdefault(name, []).append(
                cold_ms(alone[name], flush))
            if name in loops:
                res["b_c_loop"].setdefault(name, []).append(
                    loop_ms(loops[name]))
    for kind in ("b_graph", "b_c_loop", "c_cold_l2"):
        res[kind] = {name: dict(median=statistics.median(t), turns_ms=t)
                     for name, t in res[kind].items()}
    res["wrapper_host_ms"] = host_ms(list(wrapper.values())[0], reps=K3_REPS)
    if not earlier_only:
        one = word_kernels()[0]
        res["earlier_wrapper_host_ms"] = host_ms(
            lambda: earlier_sample_blocks(one, key, stride, take),
            reps=K3_REPS)
    print(f"K3 {label}: " + json.dumps(st))
    for kind, what in (("a_back_to_back", "(a) back to back"),
                       ("b_graph", "(b) kernel alone, one CUDA graph"),
                       ("b_c_loop", "(b) kernel alone, one C loop"),
                       ("c_cold_l2", "(c) kernel alone, L2 flushed")):
        print(f"  {what}: " + "; ".join(
            f"{name} {t['median']:.4f} ms" for name, t in res[kind].items()))
    print(f"  host time a wrapper call: {res['wrapper_host_ms']:.4f} ms"
          + ("" if earlier_only else f" (the earlier form behind its "
             f"wrapper's steps {res['earlier_wrapper_host_ms']:.4f} ms)"))
    return res


# ---------------------------------------------------------------------------
# the compiled code
# ---------------------------------------------------------------------------

def _cuobjdump():
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "cuobjdump").is_file():
            return str(Path(cand) / "bin" / "cuobjdump")
    return shutil.which("cuobjdump")


def sass_loads(so_path: str, kernel: str, text: list):
    """Global loads of every function of `so_path` whose name holds
    `kernel`: all, 16-byte, and before the first conditional branch; None
    without cuobjdump. The SASS is appended to `text`."""
    tool = _cuobjdump()
    if tool is None:
        return None
    sass = subprocess.run([tool, "-sass", so_path], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    funcs, body = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            body = funcs.setdefault(m.group(1), []) if kernel in m.group(1) \
                else None
            continue
        if body is not None:
            body.append(line)
    out = {}
    for name, lines in funcs.items():
        text += [f"// {name} in {so_path}", *lines]
        ldg = [i for i, s in enumerate(lines) if re.search(r"\bLDG\b", s)]
        branch = [i for i, s in enumerate(lines)
                  if re.search(r"@!?U?P\d+\s+BRA\b", s)]
        first = branch[0] if branch else len(lines)
        out[name] = dict(
            loads=len(ldg),
            loads_16_byte=sum(".128" in lines[i] for i in ldg),
            loads_before_first_branch=sum(i < first for i in ldg))
    return out


def compiled(report, sass_path, earlier_only=False):
    from fourdgs_torch.ops import tail_cuda as TL
    from fourdgs_torch.ops._build import CSRC as OPS_CSRC
    from fourdgs_torch.ops._build import load_library
    ptx = []
    for flags in K6_VARIANTS.values():
        ptx += ptxas_report([BLOCK_CHUNK_SOURCE], K6_FLAGS + flags)
    if not earlier_only:
        ptx += ptxas_report([OPS_CSRC / "tail_prepass.cu", TRIAL_SOURCE],
                            K6_FLAGS)
    for flags in K3_VARIANTS.values():
        ptx += ptxas_report([WORD_SOURCE], flags)
    if not earlier_only:
        ptx += ptxas_report([OPS_CSRC / "sample_blocks.cu"])
    report["ptxas"] = ptx
    for e in ptx:
        print("ptxas: " + json.dumps(e))
    text, report["sass"] = [], {}
    builds = [(f"earlier, {name}", BLOCK_CHUNK_SOURCE, K6_FLAGS + flags,
               "block_chunk_kernel") for name, flags in K6_VARIANTS.items()]
    if not earlier_only:
        builds.append(("port", TL.TAIL_PREPASS.source,
                       TL.TAIL_PREPASS.extra_flags, "tail_prepass_kernel"))
    for name, source, flags, kernel in builds:
        so = load_library(source, flags)._name
        counts = sass_loads(so, kernel, text)
        report["sass"][name] = counts
        print(f"SASS of K6 {name}: " + (
            "no cuobjdump in this toolkit" if counts is None
            else json.dumps(counts)))
    if sass_path and text:
        Path(sass_path).write_text("\n".join(text))


def main(argv=None) -> int:
    opts = parse_args(argv)
    if not torch.cuda.is_available():
        print("prepass_split: no CUDA device", file=sys.stderr)
        return 2
    from fourdgs_torch.core.camera import Camera
    from fourdgs_torch.render.autoconfig import auto_render_config
    from fourdgs_torch.scenes.cube import (CUBE_CAMERA, build_cube_scene,
                                           converged_cube_scene)
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi)
    build_all(opts.earlier_only)
    report = dict(device=smi, width=opts.width, height=opts.height, k6=[],
                  k3=[], earlier_only=opts.earlier_only)
    compiled(report, opts.sass, opts.earlier_only)
    params = converged_cube_scene(build_cube_scene(N_SPLATS, seed=0,
                                                   device=dev))
    camera = Camera.create(**CUBE_CAMERA, width=opts.width,
                           height=opts.height, device=dev)
    cfg = auto_render_config(N_SPLATS, opts.width, opts.height)
    calls = capture(params, camera, cfg)
    del params
    torch.cuda.empty_cache()
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.int32, device=dev)
    n6 = n3 = 0
    for name, args, kw in calls:
        if name == "K6":
            stream = "main" if n6 % 2 == 0 else "big tier"
            label = f"{stream} stream, band {n6 // 2}"
            n6 += 1
            report["k6"].append(k6_site(label, args, kw, opts.passes,
                                        opts.earlier_only))
        else:
            label = f"{name[3:]}, band {n3 // 2}"
            n3 += 1
            report["k3"].append(k3_site(label, args, kw, flush,
                                        opts.passes, opts.earlier_only))
    if opts.json:
        with open(opts.json, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
