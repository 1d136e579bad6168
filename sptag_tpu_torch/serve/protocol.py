"""Query text protocol — parser parity with the reference server.

Parity: the QueryParser state machine (AnnService/src/Server/
QueryParser.cpp:28-181) and SearchExecutionContext option extraction
(src/Server/SearchExecutionContext.cpp:66-155):

* ``$option:value`` (or ``$option=value``) tokens set options; names are
  case-insensitive (lowercased while scanning);
* ``#<base64>`` supplies the query vector as base64 of the raw value-type
  bytes;
* any other token is the vector in text form: elements separated by the
  configured separator (default ``|``);
* recognized options: ``indexname`` (comma-separated list), ``datatype``
  (Int8/UInt8/Int16/Float), ``extractmetadata`` (true/false), ``resultnum``.

Framework extensions beyond the reference's four options: ``maxcheck``
overrides the index's MaxCheck search budget per request (the reference can
only change MaxCheck index-wide via SetParameter; per-request budget is the
knob its IndexSearcher sweeps offline, src/IndexSearcher/main.cpp:66-228),
and ``searchmode`` (``beam``/``dense``) picks the search engine per request
— one served index can answer beam and dense traffic
concurrently (the reference has a single search path, so no analog).
``requestid`` carries a trace id in the TEXT protocol — the channel for
reference C++ clients that cannot set the versioned wire-body field
(serve/wire.py); servers prefer the wire field and fall back to this.
"""

from __future__ import annotations

import base64
import dataclasses
from typing import Dict, List, Optional

import numpy as np

from sptag_tpu_torch.core.types import (VectorValueType, dtype_of,
                                        enum_from_string)

DEFAULT_SEPARATOR = "|"


@dataclasses.dataclass
class ParsedQuery:
    options: Dict[str, str]
    vector_text: Optional[str] = None        # raw element string
    vector_base64: Optional[str] = None

    # ---- option accessors (SearchExecutionContext.cpp:66-109) -------------

    @property
    def index_names(self) -> List[str]:
        raw = self.options.get("indexname", "")
        return [s for s in (t.strip() for t in raw.split(",")) if s]

    @property
    def data_type(self) -> Optional[VectorValueType]:
        raw = self.options.get("datatype")
        if raw is None:
            return None
        try:
            return enum_from_string(VectorValueType, raw)
        except ValueError:
            return None

    @property
    def extract_metadata(self) -> bool:
        return self.options.get("extractmetadata", "").lower() in (
            "true", "1", "yes")

    @property
    def result_num(self) -> Optional[int]:
        raw = self.options.get("resultnum")
        try:
            return int(raw) if raw is not None else None
        except ValueError:
            return None

    @property
    def max_check(self) -> Optional[int]:
        """Per-request search budget override (framework extension; see
        module docstring).  None = use the index's MaxCheck parameter."""
        raw = self.options.get("maxcheck")
        try:
            v = int(raw) if raw is not None else None
        except ValueError:
            return None
        return v if v is not None and v > 0 else None

    @property
    def request_id(self) -> Optional[str]:
        """The `$requestid` trace id, capped at 64 chars (it rides into
        log records and slow-query lines; a hostile mile-long token must
        not).  None when absent/empty/oversized."""
        raw = (self.options.get("requestid") or "").strip()
        return raw if 0 < len(raw) <= 64 else None

    @property
    def deadline_ms(self) -> Optional[float]:
        """The `$deadlinems` budget option — milliseconds the client is
        still willing to wait, counted from the receiver's arrival (the
        TEXT channel twin of the wire body's minor-2 deadline trailer,
        for reference clients that cannot set body fields).  None when
        absent/unparsable/non-positive."""
        raw = self.options.get("deadlinems")
        if raw is None:
            return None
        try:
            v = float(raw)
        except ValueError:
            return None
        return v if v > 0 else None

    @property
    def search_mode(self) -> Optional[str]:
        """Per-request engine pick, "beam", "dense", or "auto" (framework
        extension; see module docstring).  "auto" resolves per request by
        budget: beam below the index's AutoModeThreshold, dense at or
        above it.  None = the index's SearchMode parameter; unknown
        values also map to None so a typo degrades to the configured
        default rather than failing the query."""
        raw = (self.options.get("searchmode") or "").lower()
        return raw if raw in ("beam", "dense", "auto") else None

    def extract_vector(self, value_type: VectorValueType,
                       separator: str = DEFAULT_SEPARATOR
                       ) -> Optional[np.ndarray]:
        """SearchExecutionContext::ExtractVector (:112-155): text elements
        or base64 of the raw value-type buffer."""
        dt = dtype_of(value_type)
        if self.vector_base64 is not None:
            try:
                raw = base64.b64decode(self.vector_base64, validate=False)
            except Exception:
                return None
            if len(raw) == 0 or len(raw) % dt.itemsize:
                return None
            return np.frombuffer(raw, dtype=dt)
        if self.vector_text is not None:
            parts = [p for p in self.vector_text.split(separator) if p != ""]
            if not parts:
                return None
            try:
                vals = [float(p) for p in parts]
            except ValueError:
                return None
            return np.asarray(vals).astype(dt)
        return None


def request_id_of(text: str) -> Optional[str]:
    """The `$requestid` option of a query line, or None — a cheap
    substring pre-check keeps the common no-id path at one scan."""
    if "$requestid" not in text.lower():
        return None
    return parse_query(text).request_id


def deadline_of(text: str) -> Optional[float]:
    """The `$deadlinems` option of a query line, or None — same cheap
    substring pre-check as `request_id_of` (the no-deadline fast path
    is every request when the feature is off)."""
    if "$deadlinems" not in text.lower():
        return None
    return parse_query(text).deadline_ms


def parse_query(text: str) -> ParsedQuery:
    """Tokenize one query line (QueryParser.cpp:28-181): whitespace-
    separated tokens; `$name:value` options, `#b64` vector, else text
    vector.  The last vector token wins, matching the reference's single
    vectorStrBegin/vectorBase64 slots."""
    options: Dict[str, str] = {}
    vector_text: Optional[str] = None
    vector_b64: Optional[str] = None
    for token in text.split():
        if token.startswith("$"):
            body = token[1:]
            for sep in (":", "="):
                if sep in body:
                    name, value = body.split(sep, 1)
                    options[name.lower()] = value
                    break
            else:
                options[body.lower()] = ""
        elif token.startswith("#"):
            vector_b64 = token[1:]
        else:
            vector_text = token
    return ParsedQuery(options, vector_text, vector_b64)
