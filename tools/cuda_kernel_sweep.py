"""Time variants of the port's int8 cascade kernels on a CUDA card.

    python tools/cuda_kernel_sweep.py          (from the repository root)

Each variant is ``sptag_tpu_torch/csrc/walk_dots.cu`` or ``int8_dots.cu``
built by ``nvcc`` with the port's flags and one of the sources' tuning
macros set (``-D``), and loaded in place of the package's library.  Every
variant is held bit for bit to the repository's kernel (the int8 walk also
to ``walk_score_f32`` over the dequantized rows, the gather to its plain
version) and timed between CUDA events at the cascade's main-path shapes on
synthetic data made from a seed: ``walk_score_i8`` at 1,024 queries x 2,048
slots (83.4% live) over 200,000 int8 rows of 128, ``int8_gather_dots`` at
1,024 x 8,192 distinct rows each.  It prints the card's name and power
limit, each kernel's registers and spills from ptxas, and one JSON line per
variant.  It needs a card, and imports neither JAX nor the JAX package.
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
from sptag_tpu_torch.ops import cascade as tc  # noqa: E402
from sptag_tpu_torch.ops import int8_dots  # noqa: E402
from sptag_tpu_torch.ops import walk_dots as wd  # noqa: E402

CSRC = os.path.join(REPO, "sptag_tpu_torch", "csrc")
# name -> (source, the macros it is built with); the sources' defaults:
# SPTAG_WALK_I8_MIN_BLOCKS 3, SPTAG_I8_MIN_BLOCKS 4, SPTAG_I8_PASSES 4,
# SPTAG_I8_ROW_HINT kKeep
VARIANTS = {
    "walk_i8_repo": ("walk_dots", {}),
    "walk_i8_min_blocks_2": ("walk_dots", {"SPTAG_WALK_I8_MIN_BLOCKS": 2}),
    "walk_i8_min_blocks_4": ("walk_dots", {"SPTAG_WALK_I8_MIN_BLOCKS": 4}),
    "gather_repo": ("int8_dots", {}),
    "gather_min_blocks_2": ("int8_dots", {"SPTAG_I8_MIN_BLOCKS": 2}),
    "gather_passes_1": ("int8_dots", {"SPTAG_I8_PASSES": 1}),
    "gather_passes_16": ("int8_dots", {"SPTAG_I8_PASSES": 16}),
    "gather_no_evict_last": ("int8_dots", {"SPTAG_I8_ROW_HINT": "kPlain"}),
}
REPS = 50


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
                    for k in ("i8_kernel", "int8_gather_kernel"))]
    module = wd if source == "walk_dots" else int8_dots
    lib = ctypes.CDLL(so)
    for fn, (restype, argtypes) in module._SIGNATURES.items():
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


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("tools/cuda_kernel_sweep.py: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as work:
        with ThreadPoolExecutor(len(VARIANTS)) as ex:
            libs = dict(zip(VARIANTS, ex.map(lambda n: build(n, work),
                                             VARIANTS)))
        gen = torch.Generator().manual_seed(3)
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
        saved = (wd.library, int8_dots.library)
        try:
            for name, (lib, regs) in libs.items():
                row = {"variant": name, "ptxas": regs}
                if VARIANTS[name][0] == "walk_dots":
                    wd.library = lambda _lib=lib: _lib
                    fn = lambda: wd.walk_score(  # noqa: E731
                        q, x8, idx, sq, wd.L2, wd.GATHER, C, scale)
                    row["bit_equal"] = bool(torch.equal(fn(), want_walk))
                    row["ms"] = [event_ms(fn), event_ms(fn)]
                else:
                    int8_dots.library = lambda _lib=lib: _lib
                    fn = lambda: int8_dots.int8_gather_dots(  # noqa: E731
                        qq, qs, qn, x8, ids, inv, scale, 0, 1)
                    row["bit_equal"] = bool(torch.equal(fn(), want_gather))
                    row["ms"] = [event_ms(fn), event_ms(fn)]
                print(json.dumps(row), flush=True)
        finally:
            wd.library, int8_dots.library = saved


if __name__ == "__main__":
    main()
