"""The comparison that decides `correct`, and the recall.

Every answer the window produced is judged, once the window has closed,
against the reference (`reference.py`):

* `dist_gap`: the widest gap between a returned distance and the float64
  distance of its (query, row) pair, as a share of that pair's scale
  (`reference.pair_distances`).  A float32 computation reads a few 1e-7;
  one whose products run in TF32 reads some 1e-4.
* `bad_answers`: returned entries that no exact search could give: an id
  outside the corpus (padding included), an id twice in one row, a
  distance that is not finite, or a row whose distances are not
  ascending.  Exact: the limit is 0.
* `recall_miss`: 1 - `recall`, the share of the exact top-k the answers
  left out.  Exact distances of far rows pass the checks above; a walk or
  a scan cut short, or seeds returned unwalked, read here.
* `unanswered`: queries whose call raised.  Exact: the limit is 0.

`recall` is the mean over all answered queries of |ids ∩ exact top-k|/k,
with the exact top-k from the reference; it is also an end-to-end metric.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np
import torch

from annbench import reference

# the numbers `correct` compares, each with a limit in the cell's file
CHECKS = ("dist_gap", "recall_miss", "bad_answers", "unanswered")
# rows judged at once on the device (bounds the float64 gather)
_CHUNK_ROWS = 65536


@dataclasses.dataclass
class Answers:
    """What the window returned: per call, the position of its first query
    in the query set, and the (B, k) distances and ids."""

    starts: List[int] = dataclasses.field(default_factory=list)
    dists: List[np.ndarray] = dataclasses.field(default_factory=list)
    ids: List[np.ndarray] = dataclasses.field(default_factory=list)

    def add(self, start: int, dists: np.ndarray, ids: np.ndarray) -> None:
        self.starts.append(start)
        self.dists.append(dists)
        self.ids.append(ids)

    @property
    def rows(self) -> int:
        return sum(len(i) for i in self.ids)


@dataclasses.dataclass
class Verdict:
    dist_gap: float
    bad_answers: int
    unanswered: int
    recall: float
    judged_rows: int

    @property
    def recall_miss(self) -> float:
        return 1.0 - self.recall

    def checks(self, limits: Dict[str, float]) -> Dict[str, dict]:
        """{name: {"value", "limit"}} for every number compared."""
        return {name: {"value": getattr(self, name), "limit": limits[name]}
                for name in CHECKS}

    def correct(self, limits: Dict[str, float]) -> bool:
        return self.judged_rows > 0 and all(
            c["value"] <= c["limit"]
            for c in self.checks(limits).values())


def _chunks(answers: Answers, nq: int):
    """(query positions, dists, ids) of about _CHUNK_ROWS rows each."""
    pos, dd, ii, n = [], [], [], 0
    for start, d, i in zip(answers.starts, answers.dists, answers.ids):
        pos.append((start + np.arange(len(i))) % nq)
        dd.append(d)
        ii.append(i)
        n += len(i)
        if n >= _CHUNK_ROWS:
            yield np.concatenate(pos), np.concatenate(dd), np.concatenate(ii)
            pos, dd, ii, n = [], [], [], 0
    if n:
        yield np.concatenate(pos), np.concatenate(dd), np.concatenate(ii)


def bad_entries(dists: np.ndarray, ids: np.ndarray, rows: int) -> np.ndarray:
    """(R,) count per answer row of entries no exact search could give."""
    out_of_range = (ids < 0) | (ids >= rows)
    srt = np.sort(ids, axis=1)
    twice = np.zeros_like(out_of_range)
    twice[:, 1:] = srt[:, 1:] == srt[:, :-1]
    not_finite = ~np.isfinite(dists)
    unordered = np.zeros_like(out_of_range)
    with np.errstate(invalid="ignore"):
        unordered[:, 1:] = dists[:, 1:] < dists[:, :-1]
    return (out_of_range | twice | not_finite | unordered).sum(1)


def judge(answers: Answers, unanswered: int, corpus: np.ndarray,
          queries: np.ndarray, metric: str, k: int,
          device: torch.device) -> Verdict:
    """Judge every answer of the window against the reference."""
    x = reference.prepare(corpus, metric, device)
    q = reference.prepare(queries, metric, device)
    _, truth = reference.exact_topk(x, q, k, metric)
    rows, nq = x.shape[0], q.shape[0]
    gap, bad, hits, judged = 0.0, 0, 0, 0
    for pos, d, ids in _chunks(answers, nq):
        bad += int(bad_entries(d, ids, rows).sum())
        pos_t = torch.from_numpy(pos).to(device)
        ids_t = torch.from_numpy(ids.astype(np.int64)).to(device)
        ok = (ids_t >= 0) & (ids_t < rows)
        safe = torch.where(ok, ids_t, torch.zeros_like(ids_t))
        exact, scale = reference.pair_distances(q[pos_t], x[safe], metric)
        got = torch.from_numpy(d).to(device).double()
        rel = ((got - exact).abs() / scale).masked_fill(~ok, 0.0)
        rel = torch.nan_to_num(rel, nan=float("inf"))
        gap = max(gap, float(rel.max()))
        want = truth[pos_t]
        hit = ((ids_t[:, :, None] == want[:, None, :]) & ok[:, :, None])
        hits += int(hit.any(-1).sum())
        judged += len(pos)
    recall = hits / (judged * k) if judged else 0.0
    return Verdict(dist_gap=gap, bad_answers=bad, unanswered=unanswered,
                   recall=recall, judged_rows=judged)


def limits_line(checks: Dict[str, dict]) -> Sequence[str]:
    """One plain line per number compared, with its limit."""
    return [f"check {name}: {c['value']!r} (limit {c['limit']!r})"
            for name, c in checks.items()]
