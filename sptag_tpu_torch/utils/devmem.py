"""Device-memory ledger: who is holding the card's memory (port of
``sptag_tpu/utils/devmem.py``).

Every long-lived device allocation the index stack makes (corpus
snapshots, graphs, pivot/tree arrays, dense block layouts in float32 or
int8, scheduler slot pools, the delta shard) registers its resident bytes
under a COMPONENT name, so ``/debug/memory`` and the
``memory.device_bytes{component=...}`` gauges answer "what would I free by
dropping X" without a heap dump.  The component names and the payload's
keys are the JAX package's.

Lifecycle is **ownership by weakref**: `track(component, owner, nbytes)`
keys the entry to `owner` (the object whose death releases the tensors:
an engine snapshot, a DenseTreeSearcher, a slot pool) and a
``weakref.finalize`` retires the bytes when the owner is collected, so a
snapshot swap never double-counts.  `untrack(owner)` exists for owners
that outlive their tensors (a compacted slot pool re-tracks at its new
size; a stopped scheduler drops its pools eagerly).

The ledger is cross-checkable against the allocator:
`live_arrays_bytes()` reads ``torch.cuda.memory_allocated`` and
``torch.cuda.memory_stats``.  The DEVICE-side tracked total
(`device_bytes()`; entries marked ``host=True`` are excluded) must be <=
it.  That number counts more than ``jax.live_arrays()`` did in the JAX
package: every live block of PyTorch's caching allocator (transient batch
tensors and workspaces included) and the private memory pools of the CUDA
graphs the port captures (the walk's graph cache of up to 32 plans, the
slot scheduler's segment graphs), which no component owns.  The gap is
reported as ``untracked_bytes``.

An entry may name the cards its bytes live on (``cards``: card name ->
bytes; a mesh places one shard a card, parallel/sharded.py):
`card_bytes()` and the snapshot's ``cards`` read the ledger card by card,
each beside that card's allocator.

`configure(enabled=False)` (the ``DeviceBytesLedger=0`` parameter) turns
`track` into a no-op; the serve wire bytes are identical either way (the
ledger never touches the request path).
"""

from __future__ import annotations

import threading
import weakref
from typing import Dict, Optional

from sptag_tpu_torch.utils import metrics

# RLock, not Lock: weakref.finalize callbacks (_drop_key) can fire from
# an implicit GC pass triggered INSIDE track()/untrack()/reset() while
# this same thread already holds the lock — a non-reentrant lock would
# self-deadlock the thread building a new snapshot
_lock = threading.RLock()
_enabled = True
#: (component, id(owner)) -> (nbytes, host_resident, cards); the paired
#: finalizer removes the key
_entries: Dict[tuple, tuple] = {}
_finalizers: Dict[tuple, object] = {}


def configure(enabled: Optional[bool] = None) -> None:
    """Process-wide ledger flag.  DISABLING also drops every live entry:
    a frozen gauge publishing pre-disable sizes forever would be worse
    than no gauge (the `DeviceBytesLedger=0` contract is "all tracking
    off", not "last values pinned")."""
    global _enabled
    with _lock:
        if enabled is not None:
            _enabled = bool(enabled)
            if not _enabled:
                for fin in _finalizers.values():
                    fin.detach()
                _finalizers.clear()
                _entries.clear()


def enabled() -> bool:
    return _enabled


def track(component: str, owner, nbytes: int, host: bool = False,
          cards: Optional[Dict[str, int]] = None) -> None:
    """Register `nbytes` of residency under `component`, owned by
    `owner`.  Re-tracking the same (component, owner) replaces the size
    (a pool growing/compacting).  `host=True` marks buffers that live in
    HOST memory between device round trips (scheduler slot pools) —
    they appear in the component gauges but are excluded from the
    device-total that cross-checks against the allocator.
    `cards` splits the bytes by card (``str(device)`` -> bytes).
    Component names must be string literals at the call site (the GL6xx
    cardinality rule: the ledger never expires a component name, only
    its entries)."""
    if not _enabled:
        return
    key = (component, id(owner))
    try:
        ref = weakref.finalize(owner, _drop_key, key)
    except TypeError:
        # an un-weakref-able owner (plain tuple) still gets accounted;
        # the caller must untrack() or re-track to release it
        ref = None
    with _lock:
        old = _finalizers.pop(key, None)
        if old is not None:
            old.detach()
        _entries[key] = (int(nbytes), bool(host),
                         {str(c): int(b) for c, b in (cards or {}).items()})
        if ref is not None:
            _finalizers[key] = ref


def _drop_key(key: tuple) -> None:
    with _lock:
        _entries.pop(key, None)
        _finalizers.pop(key, None)


def untrack(owner, component: Optional[str] = None) -> None:
    """Drop every entry owned by `owner` (or only its `component` one)."""
    with _lock:
        keys = [k for k in _entries
                if k[1] == id(owner)
                and (component is None or k[0] == component)]
        for k in keys:
            _entries.pop(k, None)
            fin = _finalizers.pop(k, None)
            if fin is not None:
                fin.detach()


def component_bytes() -> Dict[str, int]:
    """Live per-component totals, component-sorted."""
    with _lock:
        out: Dict[str, int] = {}
        for (component, _), (nbytes, _host, _cards) in _entries.items():
            out[component] = out.get(component, 0) + nbytes
    return dict(sorted(out.items()))


def total_bytes() -> int:
    with _lock:
        return sum(entry[0] for entry in _entries.values())


def device_bytes() -> int:
    """Total of device-resident entries only: the number that must be
    bounded by the allocator's ``memory_allocated``."""
    with _lock:
        return sum(nbytes for nbytes, host, _cards in _entries.values()
                   if not host)


def card_bytes() -> Dict[str, int]:
    """Device-resident bytes of the entries that name their cards, by
    card."""
    with _lock:
        out: Dict[str, int] = {}
        for nbytes, host, cards in _entries.values():
            if host:
                continue
            for card, b in cards.items():
                out[card] = out.get(card, 0) + b
    return dict(sorted(out.items()))


def live_arrays_bytes(device=None) -> Dict[str, float]:
    """Ground truth from the allocator of the CUDA `device` (default: the
    current one): ``bytes`` is ``torch.cuda.memory_allocated`` (every live
    block of the caching allocator, CUDA graphs' private pools included)
    and ``count`` the allocator's live allocations
    (``allocation.all.current`` of ``torch.cuda.memory_stats``).  Raises
    when no CUDA device is initialized, which `snapshot` reports as "no
    cross-check"."""
    import torch

    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        raise RuntimeError("no initialized CUDA device")
    stats = torch.cuda.memory_stats(device)
    return {"bytes": float(torch.cuda.memory_allocated(device)),
            "count": float(stats.get("allocation.all.current", 0))}


def snapshot(with_live_arrays: bool = True) -> dict:
    """The /debug/memory payload: per-component bytes, ledger total, and
    (optionally) the allocator cross-check with the untracked delta."""
    comp = component_bytes()
    dev = device_bytes()
    out = {"enabled": _enabled, "components": comp,
           "ledger_total_bytes": sum(comp.values()),
           "ledger_device_bytes": dev}
    if with_live_arrays:
        try:
            live = live_arrays_bytes()
        except Exception:                                 # noqa: BLE001
            live = None                  # no CUDA device initialized
        if live is not None:
            out["live_arrays_bytes"] = int(live["bytes"])
            out["live_arrays_count"] = int(live["count"])
            # the device ledger is a SUBSET of the allocator's live
            # blocks; the delta is what no component owns (transient
            # batches, workspaces, CUDA graphs' private pools)
            out["untracked_bytes"] = int(live["bytes"]) - dev
            # card by card: the ledger's entries that name their card
            # beside that card's allocator
            cards = {card: {"ledger_bytes": nbytes,
                            "live_arrays_bytes": int(
                                live_arrays_bytes(card)["bytes"])}
                     for card, nbytes in card_bytes().items()
                     if card.startswith("cuda")}
            if cards:
                out["cards"] = cards
    return out


def families() -> list:
    """The ledger as labeled metric families (utils/metrics.py Family)
    — THE one surface both the /metrics exposition and the timeline
    sampler consume.  The `_ledger` total is DEVICE bytes
    only, so it agrees with /debug/memory's ledger_device_bytes (and
    may be compared against the card's capacity); host-resident entries get
    their own total."""
    comp = component_bytes()
    dev = device_bytes()
    fam = metrics.Family(
        "memory.device_bytes",
        help="per-component resident bytes; host-side components "
             "(slot_pool) are included here but excluded from the "
             "_ledger total")
    for component, nbytes in comp.items():
        fam.add(nbytes, {"component": component})
    # the totals render unconditionally (0 with nothing tracked) — the
    # historical exposition always carried them, and dashboards keyed
    # on the gauge's presence must not see it vanish on an idle process
    return [fam,
            metrics.Family("memory.device_bytes_ledger").add(dev),
            metrics.Family("memory.device_bytes_host")
            .add(sum(comp.values()) - dev)]


def render_prometheus(prefix: str = "sptag_tpu") -> str:
    """``memory.device_bytes{component=…}`` gauge lines in Prometheus
    text format — the families above through the shared formatter."""
    return metrics.render_families(families(), prefix)


metrics.register_family_provider("devmem", families)


def reset() -> None:
    """Drop every entry and restore defaults (test isolation)."""
    global _enabled
    with _lock:
        _enabled = True
        for fin in _finalizers.values():
            fin.detach()
        _finalizers.clear()
        _entries.clear()
