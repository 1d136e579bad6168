"""Per-kernel cost ledger (port of ``sptag_tpu/utils/costmodel.py``).

Every device kernel family registers an analytic cost formula keyed by its
static shape configuration: ``formula(**shape) -> (flops, bytes)``.  The
families and the formulas are the JAX package's, term for term: they
describe the work of the algorithm (the contraction, the corpus bytes, the
sort ensembles), not of one implementation, so the achieved rates and the
%-of-peak gauges (utils/roofline.py) read the same in both packages.

* `register(family, fn, formula)` binds a dotted family name to the port
  function that does that work.  Where one port function stands for
  several of the JAX package's compiled entry points (the whole-walk CUDA
  graph for ``beam.walk_chunked``), the registration says so.
* ``flops`` counts the arithmetic of one call; for a walk the formula is
  ONE iteration of the body (the JAX package's count-body-once rule) and
  callers scale by their iteration counts.
* ``bytes`` follows the "bytes accessed" convention: operand + result
  bytes of the unfused ops, an upper bound on the card's true traffic that
  counts materialised intermediates (a (Q, N) score matrix is written and
  re-read).  It therefore answers a different question than the "each
  input read once" bound chip_smoke.py puts beside each kernel.

The cross-check.  PyTorch has no ``Compiled.cost_analysis()``; the port's
`crosscheck(family, counted, tol, **shape)` compares the ledger with a
count the caller supplies and bumps the ``costmodel.xla_mismatch`` counter
(the JAX package's name) when it drifts by more than `tol`.  `count_flops`
supplies that count with ``torch.utils.flop_counter.FlopCounterMode`` run
over the plain PyTorch version of the work.  FlopCounterMode counts the
contractions (mm, bmm, einsum, addmm) and nothing else, so it can stand
for the ledger only where the contraction dominates the formula at the
shape tested: ``flat.scan`` (2QND against 2D(Q+N) + 2QN of norms and
masking), ``pallas.probe_block_dots`` / ``pallas.group_block_dots`` (the
formula IS the contraction) and ``beam.seed`` at D >= 256 (2QPD against
32QP of sort ensemble).  ``cascade.rerank`` is not among them: its fitted
``FP_RERANK_FLOPS`` = 4.2 per element counts the cast and norm copies the
JAX compiler materialises around a 2-per-element contraction, so a
contraction count sits about half below it at every shape
(tests/test_torch_costmodel.py holds that too).  The other families carry
sort, scan and gather terms no counter of contractions sees; their
formulas are held equal to the JAX package's on the CPU instead.

Import-light: no torch work at import, so the serving tiers read the
registry without touching a device.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
from typing import Callable, Dict, Optional, Tuple, Union

from sptag_tpu_torch.utils import metrics

log = logging.getLogger(__name__)

#: relative tolerance of the ledger-vs-count cross-check
DEFAULT_TOLERANCE = 0.15


@dataclasses.dataclass(frozen=True)
class CostEntry:
    """One registered kernel family."""

    family: str
    kernel_name: str                       # the port function's name
    formula: Callable[..., Tuple[float, float]]


@dataclasses.dataclass(frozen=True)
class CostEstimate:
    family: str
    flops: float
    hbm_bytes: float

    @property
    def intensity(self) -> float:
        """Arithmetic intensity (FLOPs per byte): the roofline x-axis."""
        return self.flops / self.hbm_bytes if self.hbm_bytes else 0.0


_lock = threading.Lock()
_entries: Dict[str, CostEntry] = {}


def register(family: str, kernel, formula) -> None:
    """Bind `family` to the port function `kernel` (its ``__name__`` is
    recorded) and a ``formula(**shape) -> (flops, bytes)``.
    Re-registration replaces (module reload under tests)."""
    name = getattr(kernel, "__wrapped__", kernel)
    name = getattr(name, "__qualname__", getattr(name, "__name__",
                                                 str(kernel)))
    with _lock:
        _entries[family] = CostEntry(family, name, formula)


def families() -> Tuple[str, ...]:
    with _lock:
        return tuple(sorted(_entries))


def entry(family: str) -> Optional[CostEntry]:
    with _lock:
        return _entries.get(family)


def registered_kernel_names() -> Tuple[str, ...]:
    """Function names with a ledger entry."""
    with _lock:
        return tuple(sorted({e.kernel_name for e in _entries.values()}))


def estimate(family: str, **shape) -> CostEstimate:
    """Evaluate the registered formula at a static shape configuration."""
    e = entry(family)
    if e is None:
        raise KeyError(f"no cost-ledger entry for kernel family {family!r}"
                       " (register one in the kernel's module)")
    flops, nbytes = e.formula(**shape)
    return CostEstimate(family, float(flops), float(nbytes))


# ---------------------------------------------------------------------------
# the cross-check
# ---------------------------------------------------------------------------

def count_flops(fn, *args, **kwargs) -> Tuple[float, object]:
    """(contraction FLOPs, result) of one call of `fn` under
    ``torch.utils.flop_counter.FlopCounterMode`` — the count `crosscheck`
    compares with.  Run it over the plain PyTorch version of the work."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        out = fn(*args, **kwargs)
    return float(counter.get_total_flops()), out


def crosscheck(family: str,
               counted: Union[float, Tuple[float, Optional[float]]],
               tol: float = DEFAULT_TOLERANCE, **shape) -> Dict[str, float]:
    """Compare the ledger's estimate at `shape` with `counted`: the flops
    of one call (``count_flops``), or (flops, bytes) where the caller also
    counted bytes.  Returns the signed relative deltas ``{"flops_rel",
    "bytes_rel"}`` (ledger vs count; 0.0 for an axis not counted).  A delta
    beyond `tol` bumps ``costmodel.xla_mismatch`` and logs the numbers:
    the formula has drifted from the work it describes."""
    if isinstance(counted, (tuple, list)):
        cf, cb = counted
    else:
        cf, cb = counted, None
    est = estimate(family, **shape)
    rel = {
        "flops_rel": (est.flops - cf) / cf if cf else 0.0,
        "bytes_rel": (est.hbm_bytes - cb) / cb if cb else 0.0,
    }
    if abs(rel["flops_rel"]) > tol or abs(rel["bytes_rel"]) > tol:
        metrics.inc("costmodel.xla_mismatch")
        log.warning(
            "cost-ledger mismatch for %s at %r: ledger flops=%.3g "
            "counted=%.3g (%+.1f%%), ledger bytes=%.3g counted=%s",
            family, shape, est.flops, cf, 100.0 * rel["flops_rel"],
            est.hbm_bytes, "-" if cb is None else f"{cb:.3g}")
    return rel


# ---------------------------------------------------------------------------
# shared formula building blocks (the JAX package's fitted constants)
# ---------------------------------------------------------------------------

#: traversals of a materialised (Q, N) score matrix in a scan kernel (mask
#: write+read, negation, top-k read)
SCAN_MATRIX_TRAFFIC = 3.2

#: per-element flops of the sort/scan/top-k ensemble of one beam-walk
#: iteration (argsort + segmented scans + merges)
WALK_SORT_FLOPS = 290.0

#: per-element word traffic of the same ensemble, in 4-byte words
WALK_SORT_TRAFFIC = 130.0

#: per-merged-row-element flops of the BINNED walk body's selection
#: ensemble (bin reductions + shortlist top-L + the rank-select pop)
WALK_BINNED_FLOPS = 33.0

#: per-merged-row-element word traffic of the same binned ensemble
WALK_BINNED_TRAFFIC = 19.0


def matmul_flops(m: float, n: float, k: float) -> float:
    """Dense (m, k) x (k, n) contraction: 2·m·n·k."""
    return 2.0 * m * n * k


def topk_flops(rows: float, width: float) -> float:
    """top-k over (rows, width): ~2 compare-ops per element."""
    return 2.0 * rows * width
