"""Time variants of the port's int8 cascade kernels on a CUDA card.

    python tools/cuda_kernel_sweep.py [name ...]   (from the repository root)

Each variant is ``sptag_tpu_torch/csrc/walk_dots.cu``, ``int8_dots.cu`` or
``block_dots.cu`` built by ``nvcc`` with the port's flags and one or more of
the sources' tuning macros set (``-D``), and loaded in place of the
package's library; with names, only those variants run.  Every variant is
held bit for bit to the repository's kernel (the int8 walk also to
``walk_score_f32`` over the dequantized rows, the gather to its plain
version, the float32 x int8 block dots to the float32 block kernel on
``blocks.float()``) and timed at the cascade's main-path shapes on
synthetic data made from a seed: ``walk_score_i8`` at 1,024 queries x
2,048 slots (83.4% live) over 200,000 int8 rows of 128,
``int8_gather_dots`` at 1,024 x 8,192 distinct rows each, and the dense
cascade's ``probe_block_dots`` (1,024 queries x 8 probes, each query's
distinct) and ``group_block_dots`` (32 groups of 32 queries x 32 distinct
union blocks) over 894 int8 blocks of 256 x 128.

Times: ``ms``, two runs of the mean per call of 50 calls queued between CUDA
events (host time included when the host is the slower); for the block
dots also ``graph_ms``, the same calls replayed from one CUDA graph (the
card's elapsed time, launch gaps and the prep included), and
``device_ms_by_kernel`` from ``torch.profiler`` (each kernel's own time;
with programmatic dependent launch the scoring kernel's includes its wait
for the prep).  The ``block_f32_control`` rows time the float32 kernel on
the widened blocks and the ``block_library`` rows one einsum over the
pre-gathered widened blocks, at the same shapes.  It prints the card's name
and power limit, each kernel's registers and spills from ptxas, and one JSON
line per row.  It needs a card, and imports neither JAX nor the JAX
package.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

from sptag_tpu_torch import _build  # noqa: E402
from sptag_tpu_torch.ops import block_dots  # noqa: E402
from sptag_tpu_torch.ops import cascade as tc  # noqa: E402
from sptag_tpu_torch.ops import int8_dots  # noqa: E402
from sptag_tpu_torch.ops import walk_dots as wd  # noqa: E402

CSRC = os.path.join(REPO, "sptag_tpu_torch", "csrc")
# name -> (source, the macros it is built with); the sources' defaults:
# SPTAG_WALK_I8_MIN_BLOCKS 3, SPTAG_I8_MIN_BLOCKS 4, SPTAG_I8_PASSES 4,
# SPTAG_I8_ROW_HINT kKeep; SPTAG_F32I8_K 64, _STAGES 2, _ROWS 2,
# _ENTRIES 16, _MIN_BLOCKS 2, _UNROLL_W 4, _PDL 1, _COMPUTE_REPS 1
VARIANTS = {
    "walk_i8_repo": ("walk_dots", {}),
    "walk_i8_min_blocks_2": ("walk_dots", {"SPTAG_WALK_I8_MIN_BLOCKS": 2}),
    "walk_i8_min_blocks_4": ("walk_dots", {"SPTAG_WALK_I8_MIN_BLOCKS": 4}),
    "gather_repo": ("int8_dots", {}),
    "gather_min_blocks_2": ("int8_dots", {"SPTAG_I8_MIN_BLOCKS": 2}),
    "gather_passes_1": ("int8_dots", {"SPTAG_I8_PASSES": 1}),
    "gather_passes_16": ("int8_dots", {"SPTAG_I8_PASSES": 16}),
    "gather_no_evict_last": ("int8_dots", {"SPTAG_I8_ROW_HINT": "kPlain"}),
    "f32i8_repo": ("block_dots", {}),
    "f32i8_no_pdl": ("block_dots", {"SPTAG_F32I8_PDL": 0}),
    "f32i8_stages_3": ("block_dots", {"SPTAG_F32I8_STAGES": 3}),
    "f32i8_k32_stages_4": ("block_dots", {"SPTAG_F32I8_K": 32,
                                          "SPTAG_F32I8_STAGES": 4}),
    "f32i8_unroll_w_1": ("block_dots", {"SPTAG_F32I8_UNROLL_W": 1}),
    # rows x entries a thread; the 128-thread tiles at 4 CTAs an SM
    "f32i8_2x32": ("block_dots", {"SPTAG_F32I8_ENTRIES": 32,
                                  "SPTAG_F32I8_MIN_BLOCKS": 4}),
    "f32i8_4x16": ("block_dots", {"SPTAG_F32I8_ROWS": 4,
                                  "SPTAG_F32I8_MIN_BLOCKS": 4}),
    "f32i8_8x8": ("block_dots", {"SPTAG_F32I8_ROWS": 8,
                                 "SPTAG_F32I8_ENTRIES": 8,
                                 "SPTAG_F32I8_MIN_BLOCKS": 4}),
    "f32i8_4x8": ("block_dots", {"SPTAG_F32I8_ROWS": 4,
                                 "SPTAG_F32I8_ENTRIES": 8}),
    "f32i8_1x32": ("block_dots", {"SPTAG_F32I8_ROWS": 1,
                                  "SPTAG_F32I8_ENTRIES": 32}),
    "f32i8_1x16": ("block_dots", {"SPTAG_F32I8_ROWS": 1}),
    "f32i8_min_blocks_3": ("block_dots", {"SPTAG_F32I8_MIN_BLOCKS": 3}),
    # measuring variants (their dots are wrong by design): the FFMAs
    # skipped, or run twice
    "f32i8_compute_0": ("block_dots", {"SPTAG_F32I8_COMPUTE_REPS": 0}),
    "f32i8_compute_2": ("block_dots", {"SPTAG_F32I8_COMPUTE_REPS": 2}),
}
# the kernels whose ptxas lines a variant reports
_KERNELS = {"walk_dots": ("i8_kernel",),
            "int8_dots": ("int8_gather_kernel",),
            "block_dots": ("f32i8_kernel", "prep_kernel")}
_MODULES = {"walk_dots": wd, "int8_dots": int8_dots,
            "block_dots": block_dots}
REPS = 50
GRAPH_CALLS = 20


def build(name, workdir):
    """Compiles and loads variant `name`; returns (library, ptxas lines)."""
    source, macros = VARIANTS[name]
    so = os.path.join(workdir, f"lib{name}.so")
    res = subprocess.run(
        [_build.nvcc_path(), *_build.NVCC_FLAGS,
         *[f"-D{k}={v}" for k, v in macros.items()], "-o", so,
         os.path.join(CSRC, source + ".cu")], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc {name}:\n{res.stdout}{res.stderr}")
    log = (res.stdout + res.stderr).splitlines()
    regs = [ln.strip() for i, ln in enumerate(log)
            if ("registers" in ln or "spill" in ln)
            and any(k in " ".join(log[max(0, i - 2):i + 1])
                    for k in _KERNELS[source])]
    lib = ctypes.CDLL(so)
    for fn, (restype, argtypes) in _MODULES[source]._SIGNATURES.items():
        getattr(lib, fn).restype = restype
        getattr(lib, fn).argtypes = list(argtypes)
    return lib, sorted(set(regs))


def event_ms(fn) -> float:
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(REPS):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / REPS


def graph_ms(fn) -> float:
    """Per call, GRAPH_CALLS calls captured in one CUDA graph and replayed
    between CUDA events (median of 10 replays)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(GRAPH_CALLS):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    ts = []
    for _ in range(10):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b) / GRAPH_CALLS)
    del graph
    return sorted(ts)[len(ts) // 2]


def profiled(fn, calls: int = 10) -> dict:
    """Each CUDA kernel's own time per call (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key[:60]: e.self_device_time_total / 1e3 / calls
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}


def block_times(fn) -> dict:
    row = {"ms": [event_ms(fn), event_ms(fn)]}
    try:
        row["graph_ms"] = [graph_ms(fn), graph_ms(fn)]
    except RuntimeError as exc:          # recorded, not hidden
        row["graph_error"] = str(exc)[:200]
    row["device_ms_by_kernel"] = profiled(fn)
    return row


def block_inputs(gen, dev):
    """The dense cascade's shapes: 894 int8 blocks of 256 x 128, float32
    queries; per-query probes and per-group unions of distinct blocks."""
    C, P, D = 894, 256, 128
    blocks = torch.randint(-127, 128, (C, P, D), generator=gen).to(
        torch.int8).to(dev)
    q = torch.randn((1024, D), generator=gen).to(dev)
    topc = torch.stack([torch.randperm(C, generator=gen)[:8]
                        for _ in range(1024)]).to(torch.int32).to(dev)
    union = torch.stack([torch.randperm(C, generator=gen)[:32]
                         for _ in range(32)]).to(torch.int32).to(dev)
    return blocks, q, topc, union


def main(argv=None) -> None:
    if not torch.cuda.is_available():
        sys.exit("tools/cuda_kernel_sweep.py: needs a CUDA card")
    # kept alive between torch.profiler sessions, CUPTI loses the kernels
    # of later sessions (sptag_tpu_torch/utils/trace.py)
    os.environ.setdefault("TEARDOWN_CUPTI", "1")
    names = list(argv if argv is not None else sys.argv[1:]) or list(VARIANTS)
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        sys.exit(f"tools/cuda_kernel_sweep.py: unknown variants {unknown}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as work:
        with ThreadPoolExecutor(len(names)) as ex:
            libs = dict(zip(names, ex.map(lambda n: build(n, work), names)))
        gen = torch.Generator().manual_seed(3)
        sources = {VARIANTS[n][0] for n in names}
        if sources & {"walk_dots", "int8_dots"}:
            N, D, scale = 200_000, 128, 0.0213
            x8 = torch.randint(-127, 128, (N, D), generator=gen).to(
                torch.int8).to(dev)
            # the int8 walk's in-loop scoring
            Q, C = 1024, 2048
            q = torch.randn((Q, D), generator=gen).to(dev)
            idx = torch.randint(0, N, (Q, C), generator=gen)
            idx[torch.rand((Q, C), generator=gen) < 0.166] = -1
            idx = idx.to(dev)
            xf = wd.dequantize(x8, scale).contiguous()
            sq = wd.row_sqnorms(xf)
            want_walk = wd.walk_score(q, xf, idx, sq, wd.L2, wd.GATHER, C)
            # the int8 tier over a sketch shortlist
            Qg, Cg = 1024, 8192
            qg = torch.randn((Qg, D), generator=gen).to(dev)
            qq, qs = tc.quantize_queries(qg)
            qn = (qg * qg).sum(1)
            ids = torch.stack([torch.randperm(N, generator=gen)[:Cg]
                               for _ in range(Qg)]).to(torch.int32).to(dev)
            inv = torch.zeros(N, dtype=torch.bool, device=dev)
            want_gather = int8_dots.int8_gather_dots_reference(
                qq, qs, qn, x8, ids, inv, scale, 0, 1)
        if "block_dots" in sources:
            blocks, qb, topc, union = block_inputs(gen, dev)
            wide = blocks.float()
            calls = {"probe": (block_dots.probe_block_dots, topc),
                     "group": (block_dots.group_block_dots, union)}
            want_block = {k: fn(wide, qb, ids_)
                          for k, (fn, ids_) in calls.items()}
            for kind, (fn, ids_) in calls.items():
                print(json.dumps({"variant": "block_f32_control",
                                  "kind": kind, **block_times(
                                      lambda: fn(wide, qb, ids_))}),
                      flush=True)
                eq = "qd,qjpd->qjp" if kind == "probe" else "gqd,gupd->guqp"
                a = qb if kind == "probe" else qb.reshape(32, 32, -1)
                g = wide[ids_.long()]
                print(json.dumps({"variant": "block_library", "kind": kind,
                                  **block_times(
                                      lambda: torch.einsum(eq, a, g))}),
                      flush=True)
                del g
        saved = (wd.library, int8_dots.library, block_dots.library)
        try:
            for name, (lib, regs) in libs.items():
                row = {"variant": name, "ptxas": regs}
                source = VARIANTS[name][0]
                if source == "walk_dots":
                    wd.library = lambda _lib=lib: _lib
                    fn = lambda: wd.walk_score(  # noqa: E731
                        q, x8, idx, sq, wd.L2, wd.GATHER, C, scale)
                    row["bit_equal"] = bool(torch.equal(fn(), want_walk))
                    row["ms"] = [event_ms(fn), event_ms(fn)]
                elif source == "int8_dots":
                    int8_dots.library = lambda _lib=lib: _lib
                    fn = lambda: int8_dots.int8_gather_dots(  # noqa: E731
                        qq, qs, qn, x8, ids, inv, scale, 0, 1)
                    row["bit_equal"] = bool(torch.equal(fn(), want_gather))
                    row["ms"] = [event_ms(fn), event_ms(fn)]
                else:
                    block_dots.library = lambda _lib=lib: _lib
                    for kind, (fn, ids_) in calls.items():
                        call = (lambda _fn=fn, _ids=ids_:  # noqa: E731
                                _fn(blocks, qb, _ids))
                        print(json.dumps({
                            **row, "kind": kind, "bit_equal": bool(
                                torch.equal(call(), want_block[kind])),
                            **block_times(call)}), flush=True)
                    continue
                print(json.dumps(row), flush=True)
        finally:
            wd.library, int8_dots.library, block_dots.library = saved


if __name__ == "__main__":
    main()
