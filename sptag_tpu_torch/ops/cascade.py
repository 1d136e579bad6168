"""Tiered corpus cascade: sketch Hamming scan -> int8 re-rank -> fp exact
(port of ``sptag_tpu/ops/cascade.py``).

Tier contract (the JAX package's):

* **sketch tier** — XOR + popcount Hamming scan over packed 1-bit sign
  sketches (1/32 of the float32 corpus bytes); keeps the best
  ``TierBudgetSketch`` rows per query.  A budget covering the corpus
  composes the tier out (the int8 tier then scans everything).
* **int8 tier** — exact s8 x s8 -> s32 dots of per-query quantized queries
  against the symmetric per-corpus int8 quantization of the shortlist rows
  (1/4 of the float32 bytes); keeps ``TierBudgetInt8`` rows.  Its
  distances only order candidates.
* **fp tier** — exact float32 re-rank of the surviving shortlist; returned
  distances are always exact.

``CorpusTier`` decides residency: ``device`` keeps all three tiers on the
card; ``host`` keeps the sketches and the int8 rows there and the float32
corpus in host memory, fetching only the shortlist rows for the re-rank;
``host_all`` keeps the int8 rows in host memory too (the sketches are the
only per-corpus device bytes).  The host pipeline enqueues every chunk's
shortlist before it waits on the first chunk's ids, so the card scans
ahead while the host gathers rows.

Kernels (hand-written for Hopper, each with its plain version for CPU
tensors): the Hamming scan is ``ops/sketch_dots.py``, the int8 tier over a
shortlist ``ops/int8_dots.py`` (the gather fused), and the fp re-rank
``ops/walk_dots.py``'s fixed-order ``walk_score`` — GATHER mode over the
resident corpus, ROWS mode over rows fetched from the host — so a
host-fetched re-rank is bit-identical to the device-resident one, as the
JAX contract asks of its one traced ``rerank_gathered``.  The int8 tier
over the whole corpus (sketch tier composed out) is one matrix product
(``ops/distance.py`` ``int_contract``, exact in float32 for D < 1,024), as
the JAX package leaves it to one XLA dot.  Every top-k keeps
``lax.top_k``'s lowest-index-first tie rule (``ops/distance.py``
``smallest_k``): Hamming distances take at most 32 W + 1 values, so almost
every shortlist boundary is a tie.

Each stage registers the JAX package's cost-ledger family
(utils/costmodel.py) at the end of this module.
All knobs default off: with ``CascadeSearch=0`` nothing here is built.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from sptag_tpu_torch.core.types import DistCalcMethod
from sptag_tpu_torch.device import DeviceLike, resolve_device
from sptag_tpu_torch.ops import distance as dist_ops
from sptag_tpu_torch.ops import int8_dots
from sptag_tpu_torch.ops import sketch_dots
from sptag_tpu_torch.ops import walk_dots as walk_ops
from sptag_tpu_torch.ops.topk_bins import pow2ceil
from sptag_tpu_torch.utils import costmodel, devmem, locksan, metrics

MAX_DIST = float(np.float32(3.4e38))

#: corpus rows are padded to a multiple of this (FLAT's snapshot rule)
ROW_PAD = 128
#: queries per shortlist dispatch of the host pipeline
HOST_CHUNK = 256
#: rows per block of the streamed host exact scan
HOST_SCAN_BLOCK = 65536
#: queries per chunk of the device tier (the (Q, N) Hamming matrix)
DEVICE_CHUNK = 1024
#: rows per chunk when the sketches are packed at build
PACK_CHUNK = 65536

CORPUS_TIERS = ("device", "host", "host_all")


def normalize_tier(tier: str) -> str:
    """Validate a CorpusTier value."""
    t = str(tier or "device").strip().lower()
    if t not in CORPUS_TIERS:
        raise ValueError(
            f"CorpusTier must be one of {CORPUS_TIERS}, got {tier!r}")
    return t


def resolve_budgets(b1: int, b2: int, k: int, n: int) -> Tuple[int, int]:
    """(sketch shortlist, int8 shortlist) for a corpus of `n` padded rows:
    0 = auto, negative is an error, both quantized UP to powers of two,
    k <= b2 <= b1 <= n.  A budget reaching n composes its tier out."""
    b1, b2, k, n = int(b1), int(b2), int(k), int(n)
    if b1 < 0 or b2 < 0:
        raise ValueError(
            f"tier budgets must be >= 0 (0 = auto): "
            f"TierBudgetSketch={b1} TierBudgetInt8={b2}")
    if b1 == 0:
        b1 = min(max(128, 16 * k, n // 16), 8192)
    if b2 == 0:
        b2 = min(max(4 * k, 64), 1024)
    b1 = min(max(pow2ceil(max(b1, k)), 1), n)
    b2 = min(max(pow2ceil(max(b2, k)), 1), b1, n)
    return b1, b2


def quantize_int8(data: np.ndarray) -> Tuple[np.ndarray, float]:
    """Symmetric per-corpus int8 quantization of a float corpus:
    ``x ~= scale * q``, q in [-127, 127], one global scale."""
    data = np.asarray(data)
    if not np.issubdtype(data.dtype, np.floating):
        raise ValueError(
            "the int8 cascade tier quantizes FLOAT corpora; value type "
            f"{data.dtype} is already integer — the cascade would be an "
            "identity there (serve it directly)")
    m = float(np.max(np.abs(data))) if data.size else 0.0
    scale = (m / 127.0) if m > 0 else 1.0
    q = np.clip(np.rint(data / scale), -127, 127).astype(np.int8)
    return q, scale


def f32(v: float) -> float:
    """`v` rounded to float32, as a Python float."""
    return float(np.float32(v))


def pack_sign_bits(centered: torch.Tensor) -> torch.Tensor:
    """(R, D) centered values -> (R, W) int32 packed sign bits, W =
    ceil(D / 32): bit i of word w is x[32 w + i] > 0; D is zero-padded.
    Bit 31 carries -2^31, as the JAX package's int32 sum wraps it."""
    r, d = centered.shape
    w = (d + 31) // 32
    bits = centered > 0
    if w * 32 != d:
        bits = torch.cat([bits, bits.new_zeros((r, w * 32 - d))], dim=1)
    shifts = torch.arange(32, dtype=torch.int64, device=centered.device)
    words = (bits.view(r, w, 32).to(torch.int64) << shifts).sum(-1)
    return torch.where(words >= 1 << 31, words - (1 << 32),
                       words).to(torch.int32)


# ---------------------------------------------------------------------------
# tier stages
# ---------------------------------------------------------------------------

def quantize_queries(queries: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-query symmetric int8 quantization: (Q, D) -> ((Q, D) int8, (Q,)
    float32 scales); a zero row gets the 1e-30 floor, never a NaN."""
    qf = queries.to(torch.float32)
    qmax = qf.abs().amax(dim=-1, keepdim=True)
    qs = torch.clamp_min(qmax / 127.0, f32(1e-30))
    qq = torch.clamp(torch.round(qf / qs), -127, 127).to(torch.int8)
    return qq, qs[:, 0].contiguous()


def _qnorm(queries: torch.Tensor) -> torch.Tensor:
    qf = queries.to(torch.float32)
    return (qf * qf).sum(-1)


def int8_row_norms(int8_data: torch.Tensor, scale: float) -> torch.Tensor:
    """(N,) dequantized squared norms of int8 rows: the exact integer sum,
    rounded to float32, times scale^2 in float32."""
    xi = int8_data.to(torch.int32)
    return (xi * xi).sum(-1).to(torch.float32) * f32(
        np.float32(scale) * np.float32(scale))


def hamming_scores(sketches, mean, invalid, queries) -> torch.Tensor:
    """(Q, N) int32 Hamming distances of the queries' sign sketches."""
    qbits = pack_sign_bits(queries.to(torch.float32) - mean[None, :])
    return sketch_dots.hamming(qbits.contiguous(), sketches, invalid)


def int8_full_scores(queries, int8_data, x2, scale: float, metric: int,
                     base: int) -> torch.Tensor:
    """(Q, D) queries vs the whole (N, D) int8 corpus -> (Q, N) estimates
    through one exact contraction (`x2`: ``int8_row_norms``)."""
    qq, qs = quantize_queries(queries)
    idot = dist_ops.int_contract("qd,nd->qn", qq, int8_data)
    dot = (qs[:, None] * f32(scale)) * idot.to(torch.float32)
    if int(metric) == int(DistCalcMethod.Cosine):
        return float(base) * float(base) - dot
    return torch.clamp_min(_qnorm(queries)[:, None] + x2[None, :]
                           - 2.0 * dot, 0.0)


def int8_gathered_scores(queries, source, ids, invalid, scale: float,
                         metric: int, base: int,
                         mode: int = int8_dots.GATHER) -> torch.Tensor:
    """(Q, C) estimates against the int8 rows that `ids` names (GATHER) or
    that lie in output order (ROWS); -1 ids and invalid rows MAX_DIST."""
    qq, qs = quantize_queries(queries)
    return int8_dots.int8_gather_dots(
        qq.contiguous(), qs, _qnorm(queries).contiguous(), source,
        ids.to(torch.int32).contiguous(), invalid, scale, metric, base, mode)


def shortlist_sketch(sketches, mean, invalid, queries, b1: int
                     ) -> torch.Tensor:
    """Sketch tier: (Q, b1) int32 ids, invalid rows -> -1."""
    ham = hamming_scores(sketches, mean, invalid, queries)
    hv, short1 = dist_ops.smallest_k(ham, b1)
    return torch.where(hv >= sketch_dots.INVALID, -1,
                       short1).to(torch.int32)


def _keep(d8: torch.Tensor, short: torch.Tensor, b2: int) -> torch.Tensor:
    vals, pos = dist_ops.smallest_k(d8, b2)
    return torch.where(vals >= MAX_DIST, -1,
                       torch.gather(short, 1, pos)).to(torch.int32)


def shortlist_int8_from(queries, int8_data, scale: float, invalid, short1,
                        b2: int, metric: int, base: int) -> torch.Tensor:
    """int8 tier over a prior shortlist: score + keep b2 (-1 stays -1)."""
    d8 = int8_gathered_scores(queries, int8_data, short1, invalid, scale,
                              metric, base)
    return _keep(d8, short1, b2)


def shortlist_int8_full(queries, int8_data, x2, scale: float, invalid,
                        b2: int, metric: int, base: int) -> torch.Tensor:
    """int8 tier over the whole corpus (sketch tier composed out)."""
    d8 = int8_full_scores(queries, int8_data, x2, scale, metric, base)
    d8 = torch.where(invalid[None, :], MAX_DIST, d8)
    vals, short2 = dist_ops.smallest_k(d8, b2)
    return torch.where(vals >= MAX_DIST, -1, short2).to(torch.int32)


def rerank_gathered(queries, x, ids, k: int, metric: int, base: int,
                    mode: int, x_sqnorm=None):
    """THE fp tier: exact float32 re-rank of each query's shortlist rows,
    read by id from the resident corpus (GATHER, `x_sqnorm` its norm table
    on the card) or laid out in output order (ROWS: rows fetched from the
    host, norms computed from them) by the same fixed-order kernel, so the
    two give the same bits.  -1 ids carry MAX_DIST and return -1."""
    d = walk_ops.walk_distance(queries.to(torch.float32).contiguous(), x,
                               metric, base, mode,
                               idx=ids.to(torch.int64).contiguous(),
                               x_sqnorm=x_sqnorm)
    dists, pos = dist_ops.smallest_k(d, k)
    out = torch.gather(ids.to(torch.int64), 1, pos)
    out = torch.where(dists >= MAX_DIST, -1, out)
    return dists, out.to(torch.int32)


def exact_masked_scan(fp, fp_sq, invalid, queries, k: int, metric: int,
                      base: int):
    """Both tiers composed out: the exact masked scan, one (Q, N) score
    matrix."""
    qf = queries.to(torch.float32)
    if int(metric) == int(DistCalcMethod.L2):
        d = dist_ops.pairwise_l2(qf, fp, fp_sq)
    else:
        d = dist_ops.pairwise_cosine(qf, fp, base)
    d = torch.where(invalid[None, :], MAX_DIST, d)
    dists, idx = dist_ops.smallest_k(d, k)
    return dists, torch.where(dists >= MAX_DIST, -1, idx).to(torch.int32)


# ---------------------------------------------------------------------------
# cost-ledger formulas (utils/costmodel.py; the JAX package's, fitted
# there against its compiler's cost analysis at D >= 64)
# ---------------------------------------------------------------------------

#: per-(Q·N·W) flops of one Hamming word pass plus the per-(Q·N) sort
#: ensemble of the sketch shortlist; per-(Q·N) word traffic of both
SKETCH_WORD_FLOPS = 5.0
SKETCH_SELECT_FLOPS = 12.75
SKETCH_TRAFFIC = 18.0
#: per-element flops / bytes of the gathered int8 re-rank (cast copies
#: included) and of the gathered exact fp re-rank
INT8_RERANK_FLOPS = 6.25
INT8_RERANK_TRAFFIC = 18.5
FP_RERANK_FLOPS = 4.2
FP_RERANK_TRAFFIC = 20.7


def _sketch_stage_cost(Q, N, W, b1):
    flops = Q * N * (SKETCH_WORD_FLOPS * W + SKETCH_SELECT_FLOPS)
    nbytes = SKETCH_TRAFFIC * Q * N + N * W * 4 + Q * b1 * 4
    return flops, nbytes


def _int8_gather_stage_cost(Q, D, b1, b2):
    flops = INT8_RERANK_FLOPS * Q * b1 * D
    nbytes = INT8_RERANK_TRAFFIC * Q * b1 * D + Q * b2 * 4
    return flops, nbytes


def _int8_full_stage_cost(Q, N, D, b2):
    flops = costmodel.matmul_flops(Q, N, D) + 16.0 * Q * N
    nbytes = 13.0 * Q * N + 19.0 * N * D + Q * b2 * 4
    return flops, nbytes


def _fp_stage_cost(Q, D, b2, k):
    flops = FP_RERANK_FLOPS * Q * b2 * D
    nbytes = FP_RERANK_TRAFFIC * Q * b2 * D + Q * k * 8
    return flops, nbytes


def _cascade_search_cost(Q, N, W, D, b1, b2, k, use_sketch=True,
                         use_int8=True, **_):
    """The device tier's whole search: the composed stages plus the int8
    and fp corpora the gathers read."""
    flops = nbytes = 0.0
    if use_sketch:
        f, b = _sketch_stage_cost(Q, N, W, b1)
        flops, nbytes = flops + f, nbytes + b
        if use_int8:
            f, b = _int8_gather_stage_cost(Q, D, b1, b2)
            flops, nbytes = flops + f, nbytes + b + N * D
    elif use_int8:
        f, b = _int8_full_stage_cost(Q, N, D, b2)
        flops, nbytes = flops + f, nbytes + b
    else:
        f, b = _host_scan_block_cost(Q, N, D, k)
        return f, b + 3.0 * N * D
    r = b2 if use_int8 else b1
    f, b = _fp_stage_cost(Q, D, r, k)
    return flops + f, nbytes + b + 4.0 * N * D


def _cascade_shortlist_cost(Q, N, W, D, b1, b2, use_sketch=True, **_):
    if use_sketch:
        f1, n1 = _sketch_stage_cost(Q, N, W, b1)
        f2, n2 = _int8_gather_stage_cost(Q, D, b1, b2)
        return f1 + f2, n1 + n2 + N * D
    return _int8_full_stage_cost(Q, N, D, b2)


def _sketch_shortlist_cost(Q, N, W, b1, **_):
    return _sketch_stage_cost(Q, N, W, b1)


def _int8_rerank_cost(Q, D, b1, b2, **_):
    return _int8_gather_stage_cost(Q, D, b1, b2)


def _fp_rerank_cost(Q, D, b2, k, **_):
    return _fp_stage_cost(Q, D, b2, k)


def _fp_rerank_resident_cost(Q, N, D, b2, k, **_):
    f, b = _fp_stage_cost(Q, D, b2, k)
    return f, b + 4.0 * N * D + 4.0 * Q * b2 * D


def _cascade_tiers_cost(Q, N, W, D, b1, b2, use_sketch=True,
                        use_int8=True, **_):
    return _cascade_shortlist_cost(Q, N, W, D, b1, b2,
                                   use_sketch=use_sketch)


def _host_scan_block_cost(Q, R, D, k, **_):
    flops = costmodel.matmul_flops(Q, R, D) + 10.0 * Q * R
    nbytes = 16.0 * Q * R + 19.0 * R * D + Q * k * 8
    return flops, nbytes


def _pack_sketches_cost(N, D, **_):
    return 5.0 * N * D, N * D + N * ((D + 31) // 32) * 4 + D * 4


# ---------------------------------------------------------------------------
# host rows
# ---------------------------------------------------------------------------

def check_host_ids(n_rows: int, ids: np.ndarray):
    """Out-of-range accounting of a host fetch: ids beyond the host array
    (impossible within one snapshot; defence against a misuse mid-swap)
    are dropped to -1 and counted (``cascade.host_fetch_dropped``), never
    clamped silently onto row 0.  Returns (ids, drops)."""
    bad = ids >= n_rows
    drops = int(bad.sum())
    if drops:
        metrics.inc("cascade.host_fetch_dropped", drops)
        ids = np.where(bad, -1, ids)
    return ids, drops


def fetch_rows(host: np.ndarray, ids: np.ndarray,
               device: torch.device) -> torch.Tensor:
    """The rows of `host` that `ids` name (-1: row 0), flattened to
    (ids.size, D), on `device`.  On the card one multi-threaded
    ``index_select`` writes them into a pinned buffer and an asynchronous
    copy takes them over (the caller's later reads order it)."""
    idx = torch.from_numpy(np.clip(ids, 0, host.shape[0] - 1)
                           .reshape(-1).astype(np.int64))
    src = torch.from_numpy(host)
    if device.type != "cuda":
        return src[idx]
    buf = torch.empty((idx.numel(), host.shape[1]), dtype=src.dtype,
                      pin_memory=True)
    torch.index_select(src, 0, idx, out=buf)
    return buf.to(device, non_blocking=True)


# ---------------------------------------------------------------------------
# corpus state
# ---------------------------------------------------------------------------

class CascadeState:
    """Immutable tiered snapshot of one corpus: packed sketches and their
    mean, the int8 quantization and its scale, the tombstone mask, and the
    fp corpus — on the device or in host memory per the tier.  Owners
    (FlatIndex) build a fresh state on mutation; searches pin one."""

    def __init__(self, data: np.ndarray, deleted: Optional[np.ndarray],
                 tier: str, metric: int, base: int,
                 fp_dev: Optional[torch.Tensor] = None,
                 device: DeviceLike = None):
        """`fp_dev` (device tier): an already-resident padded (n_pad, D)
        float32 snapshot to share as the fp tier; its owner accounts for
        it."""
        self.device = resolve_device(device)
        self.tier = normalize_tier(tier)
        self.metric = int(metric)
        self.base = int(base)
        n, dim = data.shape
        self.n, self.dim = n, dim
        n_pad = max(ROW_PAD, ((n + ROW_PAD - 1) // ROW_PAD) * ROW_PAD)
        self.n_pad = n_pad
        fp = np.zeros((n_pad, dim), np.float32)
        fp[:n] = data
        invalid = np.ones(n_pad, bool)
        invalid[:n] = (deleted[:n] if deleted is not None
                       else np.zeros(n, bool))
        int8_host, self.scale = quantize_int8(fp)
        live = ~invalid
        denom = max(int(live.sum()), 1)
        mean = (fp[:n][live[:n]].sum(axis=0) / denom
                if n else np.zeros(dim, np.float32))
        dev = self.device

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        self.mean_d = put(mean.astype(np.float32))
        #: host mirror of the tombstone / pad mask (the streamed oracle)
        self.invalid_host = invalid
        self.invalid_d = put(invalid)
        # sketches of the DEQUANTIZED rows, so a row's sketch never
        # disagrees with what the int8 tier scores; packed in row chunks
        # (the fp corpus is never uploaded for it)
        w = (dim + 31) // 32
        self.sketches_d = torch.empty((n_pad, w), dtype=torch.int32,
                                      device=dev)
        sc = f32(self.scale)
        for lo in range(0, n_pad, PACK_CHUNK):
            rows = put(int8_host[lo:lo + PACK_CHUNK]).to(torch.float32)
            self.sketches_d[lo:lo + PACK_CHUNK] = pack_sign_bits(
                rows * sc - self.mean_d[None, :])
        if self.tier == "host_all":
            self.int8_d = None
            self.int8_host = np.ascontiguousarray(int8_host)
        else:
            self.int8_d = put(int8_host)
            self.int8_host = None
        self._x2 = None                   # int8 norms, full int8 tier only
        self._fp_dev_shared = False
        self.fp_sq = None
        self._fp_rowsq = None
        if self.tier == "device":
            if (fp_dev is not None and tuple(fp_dev.shape) == fp.shape
                    and fp_dev.dtype == torch.float32
                    and fp_dev.device.type == dev.type):
                self.fp_d = fp_dev
                self._fp_dev_shared = True
            else:
                self.fp_d = put(fp)
            self.fp_host = None
            if dev.type == "cuda":
                # the re-rank kernel's norm table: the bits its ROWS mode
                # computes from fetched rows
                self.fp_sq = walk_ops.row_sqnorms(self.fp_d)
        else:
            self.fp_d = None
            self.fp_host = np.ascontiguousarray(fp)
        self.host_fetch_drops = 0
        self._lock = locksan.make_lock("CascadeState._lock")

    # ---- residency accounting --------------------------------------------

    def _sketch_bytes(self) -> int:
        return (self.sketches_d.nbytes + self.mean_d.nbytes
                + self.invalid_d.nbytes)

    def device_bytes(self) -> int:
        total = self._sketch_bytes()
        if self.int8_d is not None:
            total += self.int8_d.nbytes
        if self.fp_d is not None:
            total += self.fp_d.nbytes
        if self.fp_sq is not None:
            total += self.fp_sq.nbytes
        return int(total)

    def host_bytes(self) -> int:
        total = 0
        if self.fp_host is not None:
            total += self.fp_host.nbytes
        if self.int8_host is not None:
            total += self.int8_host.nbytes
        return int(total)

    def register_devmem(self) -> None:
        """Component-split ledger entries owned by this state; host-resident
        bytes are ``host=True`` (excluded from the device total)."""
        devmem.track("sketch", self, self._sketch_bytes())
        if self.int8_d is not None:
            devmem.track("int8_blocks", self, self.int8_d.nbytes)
        if self.fp_d is not None:
            # a shared fp snapshot is its owner's entry
            fp_bytes = 0 if self._fp_dev_shared else self.fp_d.nbytes
            if self.fp_sq is not None:
                fp_bytes += self.fp_sq.nbytes
            if fp_bytes:
                devmem.track("corpus", self, fp_bytes)
        if self.host_bytes():
            devmem.track("host_corpus", self, self.host_bytes(), host=True)

    # ---- search ----------------------------------------------------------

    def _budget_flags(self, k: int, b1: int, b2: int):
        b1, b2 = resolve_budgets(b1, b2, k, self.n_pad)
        use_sketch = b1 < self.n_pad
        use_int8 = b2 < (b1 if use_sketch else self.n_pad)
        return b1, b2, use_sketch, use_int8

    def _int8_norms(self) -> torch.Tensor:
        if self._x2 is None:
            self._x2 = int8_row_norms(self.int8_d, self.scale)
        return self._x2

    def _device_search(self, q, k, b1, b2, use_sketch, use_int8):
        """Device tier, one chunk: the composed tiers."""
        m, base = self.metric, self.base
        if use_sketch:
            short = shortlist_sketch(self.sketches_d, self.mean_d,
                                     self.invalid_d, q, b1)
            if use_int8:
                short = shortlist_int8_from(q, self.int8_d, self.scale,
                                            self.invalid_d, short, b2, m,
                                            base)
        elif use_int8:
            short = shortlist_int8_full(q, self.int8_d, self._int8_norms(),
                                        self.scale, self.invalid_d, b2, m,
                                        base)
        else:
            if self._fp_rowsq is None:
                self._fp_rowsq = dist_ops.row_sqnorms(self.fp_d)
            return exact_masked_scan(self.fp_d, self._fp_rowsq,
                                     self.invalid_d, q, k, m, base)
        return rerank_gathered(q, self.fp_d, short, k, m, base,
                               walk_ops.GATHER, self.fp_sq)

    def search(self, queries: np.ndarray, k: int, b1: int, b2: int
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Batched cascade search: ((Q, k) ascending float32 dists, (Q, k)
        int32 ids), MAX_DIST / -1 padded."""
        k = min(int(k), self.n_pad)
        b1, b2, use_sketch, use_int8 = self._budget_flags(k, b1, b2)
        queries = np.ascontiguousarray(queries, np.float32)
        if self.tier != "device":
            return self._search_host(queries, k, b1, b2, use_sketch,
                                     use_int8)
        out_d, out_i = [], []
        for lo in range(0, queries.shape[0], DEVICE_CHUNK):
            q = torch.from_numpy(queries[lo:lo + DEVICE_CHUNK]).to(
                self.device)
            d, ids = self._device_search(q, k, b1, b2, use_sketch, use_int8)
            out_d.append(d)
            out_i.append(ids)
        if not out_d:
            return (np.zeros((0, k), np.float32), np.zeros((0, k), np.int32))
        return (torch.cat(out_d).cpu().numpy(),
                torch.cat(out_i).cpu().numpy())

    def _fetch_fp(self, ids: np.ndarray
                  ) -> Tuple[torch.Tensor, np.ndarray]:
        """The shortlist's fp rows on the device, with the accounted id
        check (drops also land in this state's triage counter)."""
        ids, drops = check_host_ids(self.fp_host.shape[0], ids)
        if drops:
            with self._lock:
                self.host_fetch_drops += drops
        return fetch_rows(self.fp_host, ids, self.device), ids

    def _search_host(self, queries: np.ndarray, k: int, b1: int, b2: int,
                     use_sketch: bool, use_int8: bool
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """Host tiers, pipelined: every chunk's device shortlist (and the
        copy of its ids to the host) is enqueued first; then chunk by chunk
        the host waits for that chunk's ids only, gathers its rows and
        enqueues their re-rank, while the card scans the later chunks."""
        if not use_sketch and not use_int8:
            return host_exact_scan(self.fp_host, self.invalid_host, queries,
                                   k, self.metric, self.base,
                                   device=self.device)
        if self.tier == "host_all" and not use_sketch:
            raise ValueError(
                "CorpusTier=host_all needs an active sketch tier "
                "(TierBudgetSketch below the corpus size): with it "
                "composed out, the int8 tier would host-fetch the whole "
                "corpus per query")
        dev = self.device
        m, base = self.metric, self.base
        nq = queries.shape[0]
        chunks = []
        for start in range(0, nq, HOST_CHUNK):
            q = torch.from_numpy(queries[start:start + HOST_CHUNK]).to(dev)
            if self.tier == "host_all":
                short = shortlist_sketch(self.sketches_d, self.mean_d,
                                         self.invalid_d, q, b1)
            elif use_sketch:
                short = shortlist_int8_from(
                    q, self.int8_d, self.scale, self.invalid_d,
                    shortlist_sketch(self.sketches_d, self.mean_d,
                                     self.invalid_d, q, b1), b2, m, base)
            else:
                short = shortlist_int8_full(q, self.int8_d,
                                            self._int8_norms(), self.scale,
                                            self.invalid_d, b2, m, base)
            chunks.append((start, q, _to_host(short)))

        results = []
        for start, q, (ids_h, ready) in chunks:
            ready()                                  # this chunk's ids only
            ids = ids_h.numpy()
            if self.tier == "host_all" and use_int8:
                ids_d = torch.from_numpy(ids).to(dev)
                d8 = int8_gathered_scores(
                    q, fetch_rows(self.int8_host, ids, dev), ids_d, None,
                    self.scale, m, base, int8_dots.ROWS)
                ids = _keep(d8, ids_d, b2).cpu().numpy()
            rows, ids = self._fetch_fp(ids)
            d, out = rerank_gathered(q, rows, torch.from_numpy(ids).to(dev),
                                     k, m, base, walk_ops.ROWS)
            results.append((d, out))
        if not results:
            return (np.zeros((0, k), np.float32), np.zeros((0, k), np.int32))
        return (torch.cat([d for d, _ in results]).cpu().numpy(),
                torch.cat([i for _, i in results]).cpu().numpy())

    # ---- triage ----------------------------------------------------------

    def tier_membership(self, query: np.ndarray, truth_ids, k: int,
                        b1: int, b2: int) -> dict:
        """Which tier dropped each true neighbour of ONE query (the quality
        monitor's sampled triage, never the serve path)."""
        k = min(int(k), self.n_pad)
        b1, b2, use_sketch, use_int8 = self._budget_flags(k, b1, b2)
        q = torch.from_numpy(
            np.asarray(query, np.float32).reshape(1, -1)).to(self.device)
        int8_ref = (self.int8_d if self.int8_d is not None
                    else torch.from_numpy(self.int8_host).to(self.device))
        m, base = self.metric, self.base
        if use_sketch:
            s1 = shortlist_sketch(self.sketches_d, self.mean_d,
                                  self.invalid_d, q, b1)
        else:
            s1 = torch.arange(self.n_pad, dtype=torch.int32,
                              device=self.device)[None, :]
            s1 = torch.where(self.invalid_d[None, :], -1, s1)
        if use_int8:
            if use_sketch:
                s2 = shortlist_int8_from(q, int8_ref, self.scale,
                                         self.invalid_d, s1, b2, m, base)
            else:
                s2 = shortlist_int8_full(
                    q, int8_ref, int8_row_norms(int8_ref, self.scale),
                    self.scale, self.invalid_d, b2, m, base)
        else:
            s2 = s1
        s1 = s1.cpu().numpy()[0]
        s2 = s2.cpu().numpy()[0]
        truth = np.asarray([t for t in np.asarray(truth_ids).ravel()
                            if t >= 0], np.int32)
        in1 = np.isin(truth, s1)
        in2 = np.isin(truth, s2)
        with self._lock:
            drops = self.host_fetch_drops
        return {
            "sketch_dropped": int((~in1).sum()) if use_sketch else 0,
            "int8_dropped": int((in1 & ~in2).sum()) if use_int8 else 0,
            "host_dropped": int(drops),
        }


def _to_host(t: torch.Tensor):
    """(host tensor, wait) for a device tensor: on the card an asynchronous
    copy into pinned memory and an event that `wait` synchronises on (the
    copy and everything before it on the stream, nothing after)."""
    if t.device.type != "cuda":
        return t, lambda: None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(t.device))     # the tensor's card
    return host, ev.synchronize


# ---------------------------------------------------------------------------
# streamed host exact scan (the host tiers' oracle)
# ---------------------------------------------------------------------------

def host_exact_scan(fp_host: np.ndarray, deleted: Optional[np.ndarray],
                    queries: np.ndarray, k: int, metric: int, base: int,
                    block_rows: int = HOST_SCAN_BLOCK,
                    device: DeviceLike = None
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Exact masked top-k over a HOST-resident fp corpus, streamed through
    the device one (block_rows, D) block at a time; the running top-k is
    merged on the host (stable, lower id first among ties)."""
    dev = resolve_device(device)
    queries = np.asarray(queries, np.float32)
    nq = queries.shape[0]
    n = fp_host.shape[0]
    k_eff = min(int(k), n)
    block_rows = max(int(block_rows), k_eff)
    q_dev = torch.from_numpy(np.ascontiguousarray(queries)).to(dev)
    best_d = np.full((nq, k_eff), MAX_DIST, np.float32)
    best_i = np.full((nq, k_eff), -1, np.int64)
    for start in range(0, n, block_rows):
        stop = min(start + block_rows, n)
        rows = torch.from_numpy(
            np.ascontiguousarray(fp_host[start:stop])).to(dev)
        dead = torch.from_numpy(np.ascontiguousarray(
            deleted[start:stop] if deleted is not None
            else np.zeros(stop - start, bool))).to(dev)
        dv, idx = exact_masked_scan(rows, None, dead, q_dev,
                                    min(k_eff, stop - start), metric, base)
        dv = dv.cpu().numpy()
        idx = idx.cpu().numpy().astype(np.int64)
        gids = np.where(idx >= 0, idx + start, -1)
        cat_d = np.concatenate([best_d, dv], axis=1)
        cat_i = np.concatenate([best_i, gids], axis=1)
        order = np.argsort(cat_d, axis=1, kind="stable")[:, :k_eff]
        best_d = np.take_along_axis(cat_d, order, axis=1)
        best_i = np.take_along_axis(cat_i, order, axis=1)
    return best_d, best_i.astype(np.int32)


# ---------------------------------------------------------------------------
# graph-engine tier rule (algo/engine.py)
# ---------------------------------------------------------------------------

def walk_score_scale(cascade_on: bool, data_dtype, scale: float) -> float:
    """Dequantization scale of the walk's in-loop int8 scoring: 0.0 (off)
    unless the cascade is on AND the scoring corpus is the int8
    quantization of a float corpus."""
    if not cascade_on:
        return 0.0
    if np.dtype(data_dtype) != np.dtype(np.int8):
        return 0.0
    return float(scale)


# ---------------------------------------------------------------------------
# cost-ledger entries: each JAX program's family, bound to the port
# function doing its work.  The port has one re-rank function for the
# host-fetched (``cascade.rerank``) and the resident (``cascade.rerank_
# resident``) forms, one sketch pack for the build, and the int8 shortlist
# of ``cascade.shortlist`` is `shortlist_int8_from` after a sketch tier and
# `shortlist_int8_full` without one.
# ---------------------------------------------------------------------------

costmodel.register("cascade.search", CascadeState._device_search,
                   _cascade_search_cost)
costmodel.register("cascade.shortlist", shortlist_int8_from,
                   _cascade_shortlist_cost)
costmodel.register("cascade.sketch_shortlist", shortlist_sketch,
                   _sketch_shortlist_cost)
costmodel.register("cascade.int8_rerank", int8_gathered_scores,
                   _int8_rerank_cost)
costmodel.register("cascade.rerank", rerank_gathered, _fp_rerank_cost)
costmodel.register("cascade.rerank_resident", rerank_gathered,
                   _fp_rerank_resident_cost)
costmodel.register("cascade.tiers", CascadeState.tier_membership,
                   _cascade_tiers_cost)
costmodel.register("cascade.host_scan", exact_masked_scan,
                   _host_scan_block_cost)
costmodel.register("cascade.pack_sketches", pack_sign_bits,
                   _pack_sketches_cost)
