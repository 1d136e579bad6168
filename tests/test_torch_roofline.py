"""The port's capability registry and roofline arithmetic
(sptag_tpu_torch/utils/roofline.py) and its perf report
(sptag_tpu_torch/tools/perf_report.py), against the JAX package's.

The table matches NVIDIA device names (first match wins: NVL and PCIe
before the plain H100), the arithmetic equals the JAX functions on the
same inputs, and the measured probe runs only when asked for.
"""

import json
import os

import pytest

from sptag_tpu.tools import perf_report as jreport
from sptag_tpu.utils import roofline as jroof
from sptag_tpu_torch.tools import perf_report as treport
from sptag_tpu_torch.utils import roofline as troof

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _fresh(monkeypatch, tmp_path):
    monkeypatch.setenv("SPTAG_TPU_ROOFLINE_CACHE", str(tmp_path / "cache"))
    troof.reset()
    yield
    troof.reset()


def _as(monkeypatch, name, platform="gpu"):
    monkeypatch.setattr(troof, "_device_kind", lambda: (name, platform))
    troof.reset()


@pytest.mark.parametrize("name,want", [
    ("NVIDIA H100 80GB HBM3", (3350.0, 67e12, 989e12, 1979e12)),
    ("NVIDIA H100 PCIe", (2000.0, 51e12, 756e12, 1513e12)),
    ("NVIDIA H100 NVL", (3900.0, 60e12, 835e12, 1671e12)),
])
def test_table_matches_the_card_names(monkeypatch, name, want):
    _as(monkeypatch, name)
    cap = troof.capability()
    assert (cap.source, cap.platform, cap.device_kind) == ("table", "gpu",
                                                           name)
    assert (cap.hbm_gbps, cap.peak_flops_f32, cap.peak_flops_bf16,
            cap.peak_flops_int8) == want
    assert cap.peak_flops("int8") == want[3]
    assert cap.peak_flops("bf16") == want[2]
    # a table capability does not depend on the probe flag
    assert troof.capability(probe=True) is cap


def test_unknown_card_has_no_peaks_and_no_tpu_rows(monkeypatch):
    _as(monkeypatch, "NVIDIA A100-SXM4-80GB")
    cap = troof.capability()
    assert cap.source == "none" and cap.peak_flops_f32 is None
    assert cap.pct_of_peak(1e12, 1e12) is None
    # the port's table holds NVIDIA rows only
    assert all("h100" in row[0] for row in troof._GPU_TABLE)
    _as(monkeypatch, "TPU v5 lite", platform="tpu")
    assert troof.capability().source == "none"


def test_probe_is_off_unless_asked(monkeypatch):
    calls = []

    def fake_probe(device=None):
        calls.append(device)
        return {"peak_flops_f32": 2e12, "hbm_gbps": 300.0}

    monkeypatch.setattr(troof, "run_probe", fake_probe)
    _as(monkeypatch, "cpu", platform="cpu")
    assert troof.capability().source == "none"
    assert troof.capability(probe=False).source == "none"
    assert calls == []
    cap = troof.capability(probe=True)
    assert (cap.source, cap.peak_flops_f32, cap.hbm_gbps) == \
        ("probe", 2e12, 300.0)
    assert len(calls) == 1
    # cached on disk: a fresh process state re-reads it without probing
    troof.reset()
    assert troof.capability(probe=True).hbm_gbps == 300.0
    assert len(calls) == 1
    # RooflineProbe=0 after a probe turns %-of-peak off again
    assert troof.capability(probe=False).source == "none"


def test_the_probe_measures_this_machine():
    out = troof.run_probe("cpu")
    assert out["peak_flops_f32"] > 0 and out["hbm_gbps"] > 0


CAPS = [dict(peak_flops_f32=67e12, peak_flops_bf16=989e12, hbm_gbps=3350.0,
             peak_flops_int8=1979e12),
        dict(peak_flops_f32=2e12, peak_flops_bf16=2e12, hbm_gbps=40.0),
        dict(peak_flops_f32=None, peak_flops_bf16=None, hbm_gbps=1000.0)]


@pytest.mark.parametrize("caps", CAPS)
@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
def test_arithmetic_equals_the_jax_functions(caps, dtype):
    jc = jroof.Capability("dev", "gpu", source="table", **caps)
    tc = troof.Capability("dev", "gpu", source="table", **caps)
    for f, b in ((1e12, 1e11), (5e13, 2e12), (3e9, 4e12)):
        assert tc.pct_of_peak(f, b, dtype) == jc.pct_of_peak(f, b, dtype)
    for qps in (10.0, 12345.6):
        assert troof.roofline_row("beam.segment", 3.2e7, 1.1e8, qps, tc,
                                  dtype) == \
            jroof.roofline_row("beam.segment", 3.2e7, 1.1e8, qps, jc, dtype)
    assert troof.roofline_row("flat.scan", 1e6, 1e6, 5.0) == \
        jroof.roofline_row("flat.scan", 1e6, 1e6, 5.0)


@pytest.mark.parametrize("name", ["BENCH_r06.json", "BENCH_r07.json"])
def test_perf_report_renders_bench_artifacts_as_the_jax_report(name):
    with open(os.path.join(REPO, name)) as f:
        obj = json.load(f)
    assert treport.report_from_bench(obj) == jreport.report_from_bench(obj)


def test_perf_report_renders_chip_smoke_kernels(tmp_path, capsys):
    cap = troof.Capability("NVIDIA H100 80GB HBM3", "gpu", 67e12, 989e12,
                           3350.0, "table", peak_flops_int8=1979e12)
    kernels = [{"name": "probe_block_dots_f32", "route": "cuda",
                "launches": 3, "ms": 0.5, "bound_ms": 0.25,
                "bound_by": "bytes", "plain_ms": 1.0, "library_ms": None,
                "max_abs_err": 1e-6}]
    text = "\n".join([
        "phase 1 ok",
        json.dumps({"roofline": treport.capability_dict(cap)}),
        json.dumps({"kernels": kernels}),
        json.dumps({"ok": True}),
    ])
    lines = treport.report_from_text(text)
    assert "Device: **NVIDIA H100 80GB HBM3** (capability source: table)" \
        in lines
    row = [ln for ln in lines if ln.startswith("| probe_block_dots_f32")]
    assert row == ["| probe_block_dots_f32 | cuda | 3 | 0.5000 | 0.2500 | "
                   "bytes | 50.0 | 1.0000 | - | 0.000001 |"]
    path = tmp_path / "smoke.out"
    path.write_text(text)
    assert treport.main([str(path)]) == 0
    assert "probe_block_dots_f32" in capsys.readouterr().out
    assert treport.main([str(tmp_path / "missing")]) == 2


def test_perf_report_probe_prints_this_machines_capability(monkeypatch,
                                                           capsys):
    _as(monkeypatch, "NVIDIA H100 PCIe")
    assert treport.main(["--probe"]) == 0
    out = capsys.readouterr().out
    assert "NVIDIA H100 PCIe" in out and "memory 2000.0 GB/s" in out
