"""Device capability registry and roofline arithmetic (port of
``sptag_tpu/utils/roofline.py``).

`capability()` answers "what are THIS card's peak FLOP/s and memory
bandwidth", so every achieved rate the cost ledger (utils/costmodel.py)
yields can be stated as a fraction of peak.

Two sources, in order:

* **Static table** of NVIDIA cards, matched on
  ``torch.cuda.get_device_name()`` substrings, first match wins (so "NVL"
  and "PCIe" come before the plain "H100").  The numbers are the data
  sheets' dense peaks (no sparsity): memory bandwidth, float32 (non-tensor
  FFMA), bf16 and int8 tensor-core rates.  The port never runs on a TPU,
  so the table holds no TPU row.
* **Measured micro-probe** for cards the table lacks (and the CPU): an
  f32 ``torch.matmul`` with TF32 off and a 32 MB copy, timed between CUDA
  events on a card (``perf_counter`` on the CPU), disk-cached keyed on
  (device name, torch version) with an age gate, so a process pays the
  ~1 s probe once per machine.  Strictly opt-in (the ``RooflineProbe``
  parameter / ``probe=True``): importing this module or resolving a table
  capability runs no device work.

A capability with ``None`` peaks is a legal answer (unknown device, probe
off): consumers publish achieved GFLOP/s and GB/s unconditionally and the
%-of-peak gauges only where a peak exists.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os
import threading
import time
from typing import Optional

log = logging.getLogger(__name__)

#: probe-cache age limit (seconds); 0 disables the disk cache
PROBE_CACHE_S = float(os.environ.get("SPTAG_TPU_ROOFLINE_CACHE_S",
                                     7 * 24 * 3600.0))


@dataclasses.dataclass(frozen=True)
class Capability:
    """Per-device peaks.  ``None`` = unknown on that axis."""

    device_kind: str
    platform: str
    peak_flops_f32: Optional[float]      # FLOP/s
    peak_flops_bf16: Optional[float]     # FLOP/s (tensor-core bf16)
    hbm_gbps: Optional[float]            # bytes/s / 1e9
    source: str                          # "table" | "probe" | "none"
    #: int8 tensor-core OP/s; None falls back to the bf16 peak
    peak_flops_int8: Optional[float] = None

    def peak_flops(self, dtype: str = "f32") -> Optional[float]:
        if dtype == "int8":
            return self.peak_flops_int8 or self.peak_flops_bf16
        if dtype == "bf16":
            return self.peak_flops_bf16
        return self.peak_flops_f32

    def pct_of_peak(self, achieved_flops_s: float, achieved_bytes_s: float,
                    dtype: str = "f32") -> Optional[float]:
        """Roofline utilization: the achieved fraction of whichever
        resource the kernel uses harder (max of compute and bandwidth
        fractions), in percent.  None when no peak is known."""
        fracs = []
        pf = self.peak_flops(dtype)
        if pf:
            fracs.append(achieved_flops_s / pf)
        if self.hbm_gbps:
            fracs.append(achieved_bytes_s / (self.hbm_gbps * 1e9))
        return 100.0 * max(fracs) if fracs else None


# (name substring, HBM GB/s, f32 TFLOP/s, bf16 TFLOP/s, int8 TOP/s): the
# H100 data sheets' dense peaks.  Substring match against the lower-cased
# device name, FIRST match wins — "nvl" and "pcie" before the plain "h100"
# (the SXM part reports itself as "NVIDIA H100 80GB HBM3").
_GPU_TABLE = (
    ("h100 nvl", 3900.0, 60e12, 835e12, 1671e12),
    ("h100 pcie", 2000.0, 51e12, 756e12, 1513e12),
    ("h100", 3350.0, 67e12, 989e12, 1979e12),
)


def _table_lookup(device_kind: str, platform: str) -> Optional[Capability]:
    if platform != "gpu":
        return None
    kind = device_kind.lower()
    for sub, gbps, f32, bf16, i8 in _GPU_TABLE:
        if sub in kind:
            return Capability(device_kind, platform, f32, bf16, gbps,
                              "table", peak_flops_int8=i8)
    return None


# ---------------------------------------------------------------------------
# measured micro-probe
# ---------------------------------------------------------------------------

def _cache_path() -> str:
    import tempfile

    return os.environ.get("SPTAG_TPU_ROOFLINE_CACHE",
                          os.path.join(tempfile.gettempdir(),
                                       "sptag_tpu_roofline"))


def _cache_key(device_kind: str) -> str:
    import torch

    return hashlib.sha256(
        f"torch|{device_kind}|{torch.__version__}".encode()).hexdigest()[:16]


def _load_probe_cache(device_kind: str) -> Optional[dict]:
    if PROBE_CACHE_S <= 0:
        return None
    path = os.path.join(_cache_path(), f"probe-{_cache_key(device_kind)}.json")
    try:
        if time.time() - os.path.getmtime(path) > PROBE_CACHE_S:
            return None
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _save_probe_cache(device_kind: str, outcome: dict) -> None:
    if PROBE_CACHE_S <= 0:
        return
    d = _cache_path()
    try:
        os.makedirs(d, exist_ok=True)
        tmp = os.path.join(d, f".tmp-{os.getpid()}")
        with open(tmp, "w") as f:
            json.dump(outcome, f)
        os.replace(tmp,
                   os.path.join(d, f"probe-{_cache_key(device_kind)}.json"))
    except OSError:
        pass                     # the cache is an optimization, never a fault


def run_probe(device=None) -> dict:
    """About a second of device work: the best of three f32 matmuls (TF32
    off) and of three 32 MB copies (read + write), timed between CUDA
    events on a card.  Returns ``{"peak_flops_f32", "hbm_gbps"}``."""
    import torch

    dev = torch.device(device) if device is not None else (
        torch.device("cuda") if torch.cuda.is_available()
        else torch.device("cpu"))
    cuda = dev.type == "cuda"
    n = 4096 if cuda else 512
    a = torch.ones((n, n), dtype=torch.float32, device=dev)
    big = torch.ones((32 << 20) // 4, dtype=torch.float32, device=dev)
    out = torch.empty_like(big)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False

    def timed(fn) -> float:
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0

    try:
        torch.matmul(a, a)                                # warm-up
        out.copy_(big)
        best = max(2.0 * n ** 3 / max(timed(lambda: torch.matmul(a, a)),
                                      1e-12) for _ in range(3))
        bw = max(2.0 * big.nbytes / max(timed(lambda: out.copy_(big)),
                                        1e-12) for _ in range(3))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return {"peak_flops_f32": best, "hbm_gbps": bw / 1e9}


def _probe(device_kind: str, platform: str) -> Optional[Capability]:
    cached = _load_probe_cache(device_kind)
    if cached is None:
        try:
            cached = run_probe()
        except Exception as e:                            # noqa: BLE001
            log.warning("roofline micro-probe failed: %r", e)
            return None
        _save_probe_cache(device_kind, cached)
    return Capability(device_kind, platform,
                      cached.get("peak_flops_f32"),
                      cached.get("peak_flops_f32"),   # no native bf16 peak
                      cached.get("hbm_gbps"), "probe")


# ---------------------------------------------------------------------------
# public surface
# ---------------------------------------------------------------------------

_lock = threading.Lock()
_cached_cap: Optional[Capability] = None
_cached_probe_flag: Optional[bool] = None


def _device_kind():
    """(name, platform) of the default device, read from torch: the first
    CUDA card, else the CPU."""
    import torch

    if torch.cuda.is_available():
        return torch.cuda.get_device_name(0), "gpu"
    return "cpu", "cpu"


def capability(probe: bool = False) -> Capability:
    """The default device's capability.  `probe=True` permits the
    disk-cached measured fallback when the table has no entry (the
    `RooflineProbe` parameter); with `probe=False` an unknown device gets
    a ``source="none"`` capability with None peaks.  Cached per process."""
    global _cached_cap, _cached_probe_flag
    with _lock:
        # a table capability is probe-independent; a probed one is valid
        # only for probe=True (RooflineProbe=0 must turn %-of-peak off)
        if _cached_cap is not None and (
                _cached_probe_flag == probe
                or _cached_cap.source == "table"):
            return _cached_cap
    kind, platform = _device_kind()
    cap = _table_lookup(kind, platform)
    if cap is None and probe:
        cap = _probe(kind, platform)
    if cap is None:
        cap = Capability(kind, platform, None, None, None, "none")
    with _lock:
        _cached_cap, _cached_probe_flag = cap, probe
    return cap


def probe_capability() -> Optional[Capability]:
    """The measured capability of the default device, from the disk cache
    or a fresh probe, whatever the table says: the probe's check against
    the table (chip_smoke.py phase 15a).  None when the probe fails."""
    kind, platform = _device_kind()
    return _probe(kind, platform)


def reset() -> None:
    """Drop the per-process capability cache (test isolation)."""
    global _cached_cap, _cached_probe_flag
    with _lock:
        _cached_cap = None
        _cached_probe_flag = None


def roofline_row(family: str, per_query_flops: float,
                 per_query_bytes: float, qps: float,
                 cap: Optional[Capability] = None,
                 dtype: str = "f32") -> dict:
    """One report roofline row: achieved rates from a measured QPS and the
    ledger's per-query work, peak fractions when peaks exist."""
    achieved_f = qps * per_query_flops
    achieved_b = qps * per_query_bytes
    row = {
        "family": family,
        "flops_per_query": int(per_query_flops),
        "hbm_bytes_per_query": int(per_query_bytes),
        "achieved_gflops": round(achieved_f / 1e9, 3),
        "achieved_gbps": round(achieved_b / 1e9, 3),
    }
    if cap is not None:
        pf = cap.peak_flops(dtype)
        if pf:
            row["pct_peak_flops"] = round(100.0 * achieved_f / pf, 4)
        if cap.hbm_gbps:
            row["pct_peak_hbm"] = round(
                100.0 * achieved_b / (cap.hbm_gbps * 1e9), 4)
        fpcts = [row.get("pct_peak_flops"), row.get("pct_peak_hbm")]
        fpcts = [p for p in fpcts if p is not None]
        if fpcts:
            row["pct_peak"] = max(fpcts)
            row["bound"] = ("compute"
                            if row.get("pct_peak_flops", -1.0)
                            >= row.get("pct_peak_hbm", -1.0)
                            else "bandwidth")
    return row
