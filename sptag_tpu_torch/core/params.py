"""Typed parameter registry with string get/set parity.

A copy of ``sptag_tpu/core/params.py``'s registries: the same names, types,
defaults and ORDER, so an ``indexloader.ini`` written by the port is
byte-identical to the JAX package's for the same settings and either
package loads the other's folders.  Parameters of features outside the
port's current slice are registered all the same (a folder that sets them
must still load); the index raises ``NotImplementedError`` where one would
change what runs.  The semantics of each knob are documented beside the
JAX package's spec of the same name.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

from sptag_tpu_torch.core.types import (
    DistCalcMethod,
    convert_string_to,
    convert_to_string,
)


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    attr: str           # python attribute name
    py_type: type       # int / float / str / enum
    default: Any
    name: str           # external name (case-insensitive)


class ParamSet:
    """A bag of typed parameters addressable by external string name."""

    SPECS: List[ParamSpec] = []

    def __init__(self):
        self._by_name: Dict[str, ParamSpec] = {
            s.name.lower(): s for s in self.SPECS
        }
        for spec in self.SPECS:
            setattr(self, spec.attr, spec.default)

    def set_param(self, name: str, value: str) -> bool:
        """String-typed set; False for unknown names."""
        spec = self._by_name.get(name.lower())
        if spec is None:
            return False
        setattr(self, spec.attr, convert_string_to(str(value), spec.py_type))
        return True

    def get_param(self, name: str) -> Optional[str]:
        spec = self._by_name.get(name.lower())
        if spec is None:
            return None
        return convert_to_string(getattr(self, spec.attr))

    def items(self):
        for spec in self.SPECS:
            yield spec.name, convert_to_string(getattr(self, spec.attr))

    def save_config(self) -> str:
        """One `Name=Value` line per registered param, in registry order."""
        return "".join(f"{k}={v}\n" for k, v in self.items())

    def load_config(self, section: Dict[str, str]) -> None:
        for key, value in section.items():
            self.set_param(key, value)


def _spec(attr, py_type, default, name):
    return ParamSpec(attr, py_type, default, name)


_GRAPH_SPECS = [
    _spec("tpt_number", int, 32, "TPTNumber"),
    _spec("tpt_leaf_size", int, 2000, "TPTLeafSize"),
    _spec("neighborhood_size", int, 32, "NeighborhoodSize"),
    _spec("neighborhood_scale", int, 2, "GraphNeighborhoodScale"),
    _spec("cef_scale", int, 2, "GraphCEFScale"),
    _spec("refine_iterations", int, 2, "RefineIterations"),
    _spec("cef", int, 1000, "CEF"),
    _spec("add_cef", int, 500, "AddCEF"),
    _spec("max_check_for_refine_graph", int, 8192, "MaxCheckForRefineGraph"),
    _spec("refine_accuracy_guard", int, 1, "RefineAccuracyGuard"),
    _spec("refine_accuracy_floor", float, 0.35, "RefineAccuracyFloor"),
    _spec("seed_pivot_auto_scale", int, 24, "SeedPivotAutoScale"),
]

_COMMON_TAIL_SPECS = [
    _spec("number_of_threads", int, 1, "NumberOfThreads"),
    _spec("dist_calc_method", DistCalcMethod, DistCalcMethod.Cosine,
          "DistCalcMethod"),
    _spec("delete_percentage_for_refine", float, 0.4,
          "DeletePercentageForRefine"),
    _spec("add_count_for_rebuild", int, 1000, "AddCountForRebuild"),
    _spec("max_check", int, 8192, "MaxCheck"),
    _spec("no_better_propagation_limit", int, 3,
          "ThresholdOfNumberOfContinuousNoBetterPropagation"),
    _spec("initial_dynamic_pivots", int, 50, "NumberOfInitialDynamicPivots"),
    _spec("other_dynamic_pivots", int, 4, "NumberOfOtherDynamicPivots"),
    _spec("beam_width", int, 16, "BeamWidth"),
    _spec("beam_score_dtype", str, "auto", "BeamScoreDtype"),
    _spec("beam_segment_iters", int, 0, "BeamSegmentIters"),
    _spec("continuous_batching", int, 0, "ContinuousBatching"),
    _spec("beam_slots", int, 1024, "BeamSlots"),
    _spec("flight_recorder", int, 0, "FlightRecorder"),
    _spec("flight_recorder_events", int, 0, "FlightRecorderEvents"),
    _spec("flight_device_sample_rate", float, 0.0, "FlightDeviceSampleRate"),
    _spec("flight_dump_on_slow_query", str, "", "FlightDumpOnSlowQuery"),
    _spec("roofline_probe", int, 0, "RooflineProbe"),
    _spec("device_bytes_ledger", int, 1, "DeviceBytesLedger"),
    _spec("quality_sample_rate", float, 0.0, "QualitySampleRate"),
    _spec("quality_recall_floor", float, 0.0, "QualityRecallFloor"),
    _spec("quality_shadow_budget", float, 0.0, "QualityShadowBudget"),
    _spec("quality_window", int, 0, "QualityWindow"),
    _spec("timeline_interval_ms", float, 0.0, "TimelineIntervalMs"),
    _spec("timeline_events", int, 0, "TimelineEvents"),
    _spec("mesh_serve", int, 0, "MeshServe"),
    _spec("mesh_shard_axis", int, 0, "MeshShardAxis"),
    _spec("mesh_k_local", int, 0, "MeshKLocal"),
    _spec("binned_topk", str, "off", "BinnedTopK"),
    _spec("approx_recall_target", float, 0.99, "ApproxRecallTarget"),
    _spec("cascade_search", int, 0, "CascadeSearch"),
    _spec("tier_budget_sketch", int, 0, "TierBudgetSketch"),
    _spec("tier_budget_int8", int, 0, "TierBudgetInt8"),
    _spec("corpus_tier", str, "device", "CorpusTier"),
    _spec("wal_enabled", int, 0, "WalEnabled"),
    _spec("wal_fsync", int, 1, "WalFsync"),
    _spec("delta_shard_capacity", int, 0, "DeltaShardCapacity"),
    _spec("auto_refine_threshold", int, 0, "AutoRefineThreshold"),
]

_FILE_SPECS = [
    _spec("tree_file", str, "tree.bin", "TreeFilePath"),
    _spec("graph_file", str, "graph.bin", "GraphFilePath"),
    _spec("vector_file", str, "vectors.bin", "VectorFilePath"),
    _spec("delete_file", str, "deletes.bin", "DeleteVectorFilePath"),
]

# dense-search knobs shared (in this order) by the BKT and KDT registries
_DENSE_SPECS = [
    _spec("beam_packed_neighbors", int, 0, "BeamPackedNeighbors"),
    _spec("auto_mode_threshold", int, 1024, "AutoModeThreshold"),
    _spec("dense_cluster_size", int, 256, "DenseClusterSize"),
    # 0 = dense-only build: no RNG graph, the index serves the dense scan
    _spec("build_graph", int, 1, "BuildGraph"),
    _spec("dense_replicas", int, 1, "DenseReplicas"),
    # query-grouped probing (power of two; 0 disables)
    _spec("dense_query_group", int, 0, "DenseQueryGroup"),
    _spec("dense_union_factor", int, 2, "DenseUnionFactor"),
    _spec("refine_search_mode", str, "dense", "RefineSearchMode"),
    _spec("final_refine_search_mode", str, "beam", "FinalRefineSearchMode"),
    _spec("refine_query_group", int, 0, "RefineQueryGroup"),
    _spec("refine_union_factor", int, 4, "RefineUnionFactor"),
]


class BKTParams(ParamSet):
    """Parity: SPTAG inc/Core/BKT/ParameterDefinitionList.h:7-38."""

    SPECS = (
        _FILE_SPECS
        + [
            _spec("tree_number", int, 1, "BKTNumber"),
            _spec("kmeans_k", int, 32, "BKTKmeansK"),
            _spec("leaf_size", int, 8, "BKTLeafSize"),
            _spec("samples", int, 1000, "Samples"),
            # "dense" (tree-partition block scan) or "beam" (graph walk)
            _spec("search_mode", str, "dense", "SearchMode"),
        ]
        + _DENSE_SPECS
        + _GRAPH_SPECS[:2]
        + [_spec("tpt_top_dims", int, 5, "NumTopDimensionTpTreeSplit")]
        + _GRAPH_SPECS[2:]
        + _COMMON_TAIL_SPECS
    )


class KDTParams(ParamSet):
    """Parity: SPTAG inc/Core/KDT/ParameterDefinitionList.h:7-36."""

    SPECS = (
        _FILE_SPECS
        + [
            _spec("tree_number", int, 1, "KDTNumber"),
            _spec("kdt_top_dims", int, 5, "NumTopDimensionKDTSplit"),
            _spec("samples", int, 100, "Samples"),
            _spec("search_mode", str, "beam", "SearchMode"),
        ]
        + _DENSE_SPECS
        + _GRAPH_SPECS[:2]
        + [_spec("tpt_top_dims", int, 5, "NumTopDimensionTPTSplit")]
        + _GRAPH_SPECS[2:]
        + _COMMON_TAIL_SPECS
    )


class FlatParams(ParamSet):
    """Params of the exact FLAT index."""

    SPECS = [
        _spec("vector_file", str, "vectors.bin", "VectorFilePath"),
        _spec("delete_file", str, "deletes.bin", "DeleteVectorFilePath"),
        _spec("dist_calc_method", DistCalcMethod, DistCalcMethod.Cosine,
              "DistCalcMethod"),
        _spec("number_of_threads", int, 1, "NumberOfThreads"),
        _spec("delete_percentage_for_refine", float, 0.4,
              "DeletePercentageForRefine"),
        _spec("max_check", int, 8192, "MaxCheck"),
        _spec("batch_size", int, 256, "BatchSize"),
        _spec("approx_topk", bool, False, "ApproxTopK"),
        _spec("binned_topk", str, "off", "BinnedTopK"),
        _spec("approx_recall_target", float, 0.99, "ApproxRecallTarget"),
        _spec("sketch_prefilter", bool, False, "SketchPrefilter"),
        _spec("sketch_rerank", int, 0, "SketchRerank"),
        _spec("cascade_search", int, 0, "CascadeSearch"),
        _spec("tier_budget_sketch", int, 0, "TierBudgetSketch"),
        _spec("tier_budget_int8", int, 0, "TierBudgetInt8"),
        _spec("corpus_tier", str, "device", "CorpusTier"),
        _spec("roofline_probe", int, 0, "RooflineProbe"),
        _spec("device_bytes_ledger", int, 1, "DeviceBytesLedger"),
        _spec("quality_sample_rate", float, 0.0, "QualitySampleRate"),
        _spec("quality_recall_floor", float, 0.0, "QualityRecallFloor"),
        _spec("quality_shadow_budget", float, 0.0, "QualityShadowBudget"),
        _spec("quality_window", int, 0, "QualityWindow"),
        _spec("timeline_interval_ms", float, 0.0, "TimelineIntervalMs"),
        _spec("timeline_events", int, 0, "TimelineEvents"),
        _spec("wal_enabled", int, 0, "WalEnabled"),
        _spec("wal_fsync", int, 1, "WalFsync"),
        _spec("delta_shard_capacity", int, 0, "DeltaShardCapacity"),
        _spec("auto_refine_threshold", int, 0, "AutoRefineThreshold"),
    ]


# ---------------------------------------------------------------------------
# Live-actuation registry (the JAX package's, knob for knob)
#
# `VectorIndex.set_parameter` will happily store any registered name at any
# value — that is the right contract for an operator at a REPL, but the
# online controller (serve/controller.py) changes knobs with nobody
# watching, so the set it may touch and the range it may use have to be
# declared somewhere AUDITABLE.  This registry is that declaration: every
# knob the control plane may live-apply, with hard bounds, whether the
# value must stay a power of two (budget-shaped walks — a non-pow2
# MaxCheck would capture a fresh CUDA graph per actuation, turning a
# latency page into a capture storm), and whether the knob lives on the index
# (applied through set_parameter) or on the serving tier (applied through
# an owner-provided setter, bounds still enforced here).  Actuating a name
# absent from the registry RAISES instead of silently no-opping: a silent
# no-op would leave the controller believing it relieved pressure while
# the index ignored it.


class UnknownActuationError(KeyError):
    """A live actuation targeted a knob that is not in the registry."""


@dataclasses.dataclass(frozen=True)
class ActuationSpec:
    name: str            # canonical RepresentStr
    lo: float            # inclusive lower bound
    hi: float            # inclusive upper bound
    pow2: bool = False   # quantize to a power of two (static kernel shapes)
    scope: str = "index"  # "index": via set_parameter; "tier": owner setter


LIVE_ACTUATIONS: Dict[str, ActuationSpec] = {
    s.name.lower(): s
    for s in [
        # candidate budget: the primary latency<->recall lever; pow2 so
        # every actuated value hits an existing walk plan
        ActuationSpec("MaxCheck", 64, 1 << 20, pow2=True),
        # cascade per-tier shortlists (0 = auto stays reachable: lo=0,
        # and pow2 quantization only applies above 1)
        ActuationSpec("TierBudgetSketch", 0, 1 << 20, pow2=True),
        ActuationSpec("TierBudgetInt8", 0, 1 << 20, pow2=True),
        # binned-TopK guarantee level — cheaper selection at lower target
        ActuationSpec("ApproxRecallTarget", 0.5, 1.0),
        # tier-scoped: admission's degraded-mode MaxCheck clamp
        ActuationSpec("DegradeMaxCheckFloor", 64, 1 << 20, pow2=True,
                      scope="tier"),
        # tier-scoped: aggregator hedge trigger percentile (lower =
        # hedge sooner = more duplicate work for a shorter tail)
        ActuationSpec("HedgePercentile", 50.0, 99.9, scope="tier"),
    ]
}


def actuation_spec(name: str) -> ActuationSpec:
    spec = LIVE_ACTUATIONS.get(name.lower())
    if spec is None:
        raise UnknownActuationError(name)
    return spec


def clamp_actuation(name: str, value) -> float:
    """Bound `value` to the registry range for `name`, quantizing to a
    power of two (rounding DOWN — never exceed the requested cost) for
    pow2 knobs.  Raises UnknownActuationError for unregistered names."""
    spec = actuation_spec(name)
    v = min(float(value), spec.hi)
    if spec.pow2 and v >= 1.0:
        v = float(1 << (int(v).bit_length() - 1))
    return max(v, spec.lo)


def actuate_index(index, name: str, value) -> float:
    """Live-apply a registered INDEX-scoped knob through the index's
    `set_parameter`, clamped per the registry; returns the value
    actually applied.  Raises UnknownActuationError for unregistered
    names, ValueError for tier-scoped ones, and RuntimeError when the
    index rejects a registered name — all three are control-plane bugs,
    not steady-state conditions, and must surface."""
    spec = actuation_spec(name)
    if spec.scope != "index":
        raise ValueError(
            "knob %s is tier-scoped; apply it through the owning tier's "
            "setter, not index.set_parameter" % spec.name)
    applied = clamp_actuation(name, value)
    out = int(applied) if float(applied).is_integer() else applied
    if not index.set_parameter(spec.name, str(out)):
        raise RuntimeError("index rejected registered live knob %s"
                           % spec.name)
    return float(out)
