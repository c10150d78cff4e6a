"""The port's measuring and diagnostic tools (utils/roofline.py,
utils/profiling.py, utils/doctor.py) against `cpg_tpu`'s, on the CPU.

`roofline()` is held to `cpg_tpu.utils.roofline.roofline` key for key and
value for value on the same step time, cost, spec and measured ceilings;
only the text under `byte_model_suspect` differs (the port's names no
compiler), so both dicts must carry that key together. `cost_of` counts
2*M*N*K per product forward and backward. `doctor` runs here without a
card and must exit 1 naming CUDA.
"""

import json
import os

import numpy as np
import pytest
import torch

from cpg_tpu.utils import roofline as j_roofline
from cpg_tpu_torch import cli
from cpg_tpu_torch.utils import doctor, profiling, roofline

SPECS = [roofline.SPEC, j_roofline.SPEC]


def _probe(tmp_path, trace=None):
    d = {"hbm": {"gbps": 2900.0}, "mxu_bf16": {"tflops": 610.0}}
    if trace:
        d["mxu_bf16_trace"] = {"tflops": trace, "source": "profile.json"}
    p = tmp_path / "probe.json"
    p.write_text(json.dumps(d))
    return str(p)


def _same(got, want):
    assert ("byte_model_suspect" in got) == ("byte_model_suspect" in want)
    got = {k: v for k, v in got.items() if k != "byte_model_suspect"}
    want = {k: v for k, v in want.items() if k != "byte_model_suspect"}
    assert got == want


@pytest.mark.parametrize("spec", SPECS, ids=["h100", "jax_spec"])
@pytest.mark.parametrize("step_ms,cost", [
    (10.0, {"bytes": 2e9, "flops": 4e12}),      # honest, FLOP-bound
    (10.0, {"bytes": 4e10, "flops": 1e12}),     # bytes past the step time
    (0.5, {"bytes": 4e10, "flops": 5e12}),      # both floors past it
    (3.0, {"bytes": None, "flops": 2e12}),      # cost_of's form
    (3.0, {"bytes": 1e9, "flops": None}),
    (3.0, {"bytes": None, "flops": None}),
    (0.0, {"bytes": 1e9, "flops": 1e12}),
    (3.0, None)])
@pytest.mark.parametrize("with_measured", [False, True])
def test_roofline_matches_jax(tmp_path, spec, step_ms, cost, with_measured):
    measured = (roofline.load_measured(_probe(tmp_path)) if with_measured
                else None)
    got = roofline.roofline(step_ms, cost, measured, spec=spec)
    want = j_roofline.roofline(step_ms, cost, measured, spec=spec)
    _same(got, want)
    for k, v in got.items():
        if k.startswith("fraction_of") and not k.endswith("_raw"):
            assert v is None or v <= 1.0


def test_roofline_flags_the_byte_model_and_keeps_the_raw_fraction():
    out = roofline.roofline(10.0, {"bytes": 4e10, "flops": 1e12})
    assert out["fraction_of_spec_floor_raw"] > 1.0
    assert out["fraction_of_spec_floor"] == round(
        1e12 / (989e12 * 1e-3) / 10.0, 3)
    assert "byte_model_suspect" in out
    assert out["spec"]["bound"] == "hbm"


@pytest.mark.parametrize("trace", [None, 700.0, 500.0])
def test_load_measured_matches_jax(tmp_path, trace):
    p = _probe(tmp_path, trace)
    assert roofline.load_measured(p) == j_roofline.load_measured(path=p)
    assert roofline.load_measured(None) is None


def test_spec_is_the_h100_data_sheet():
    """The one home of the figures that chip_smoke.py's bound() and the
    launch planners read."""
    from cpg_tpu_torch.ops import fused_chain, masked_matmul

    assert roofline.SPEC == {"hbm_gbps": 3350.0, "bf16_tflops": 989.0,
                             "int8_tops": 1979.0, "f32_tflops": 67.0}
    assert masked_matmul._HBM_BPS == 3.35e12
    assert fused_chain._HBM_BYTES_PER_US == 3.35e6


def test_cost_of_counts_each_product_forward_and_backward():
    """A conv (2 x 8x8 pixels, Cin 3, Cout 8, 3x3) and a linear layer
    (M 2, K 512, N 10): the forward is 2*M*N*K per product; the backward
    adds the linear layer's dx and dW and the conv's dW (the input takes
    no gradient)."""
    g = torch.Generator().manual_seed(0)
    conv = torch.nn.Conv2d(3, 8, 3, padding=1, bias=False)
    lin = torch.nn.Linear(512, 10)
    x = torch.randn(2, 3, 8, 8, generator=g)
    p_conv = 2 * (2 * 8 * 8) * 8 * (3 * 3 * 3)
    p_lin = 2 * 2 * 512 * 10

    def forward():
        return lin(conv(x).flatten(1)).sum()

    assert roofline.cost_of(forward) == {"bytes": None,
                                         "flops": p_conv + p_lin}
    assert roofline.cost_of(lambda: forward().backward()) == {
        "bytes": None, "flops": 2 * p_conv + 3 * p_lin}
    assert roofline.cost_of(lambda: x + 1) is None  # no product counted


def test_trace_writes_a_trace_file(tmp_path):
    a = torch.randn(64, 64)
    with profiling.trace(str(tmp_path / "tr")) as prof:
        (a @ a).sum()
    path = tmp_path / "tr" / "trace.json"
    assert path.exists()
    events = json.loads(path.read_text())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
    assert any("mm" in e.key for e in prof.key_averages())


def test_step_timer_reads_the_barrier_back():
    t = profiling.StepTimer()
    t.start()
    out = torch.ones(()) * 3
    seconds = t.stop(barrier=out)
    assert seconds == t.seconds >= 0
    assert t.images_per_sec(64) == pytest.approx(64 / max(seconds, 1e-9))
    t.start()
    t.stop(barrier=np.float32(2.0))  # a host scalar works too


@pytest.fixture(scope="module")
def report():
    """One doctor run here: no card."""
    lines = []
    rc = doctor.run_doctor(timeout_s=120, as_json=True, _print=lines.append)
    return rc, json.loads(lines[-1])


def test_doctor_without_a_card_exits_1_and_names_cuda(report):
    rc, rep = report
    assert rc == 1
    assert rep["verdict"].startswith("UNHEALTHY") and "CUDA" in rep["verdict"]
    assert rep["device"]["ok"] is False
    assert rep["device"]["cuda_available"] is False
    assert rep["imports"]["torch"] == torch.__version__
    assert set(rep["toolchains"]) == {"nvcc", "g++"}
    assert rep["build"]["writable"] is True


def test_doctor_cli_text_report(monkeypatch, capsys):
    monkeypatch.setattr(doctor, "PROBE_CODE", "raise SystemExit(3)")
    assert cli.main(["doctor", "--timeout", "60"]) == 1
    out = capsys.readouterr().out
    assert "verdict" in out and "UNHEALTHY" in out and "g++" in out


def test_doctor_cuts_off_a_hung_probe(monkeypatch):
    monkeypatch.setattr(doctor, "PROBE_CODE", "import time; time.sleep(30)")
    lines = []
    rc = doctor.run_doctor(timeout_s=0.5, as_json=True, _print=lines.append)
    rep = json.loads(lines[-1])
    assert rc == 1
    assert rep["device"]["ok"] is False
    assert "hung for 0.5 s" in rep["device"]["error"]
    assert "no usable CUDA card" in rep["verdict"]


def test_doctor_reports_a_card_only_at_capability_9(monkeypatch):
    """A probe that sees a card at capability 8.0 is not healthy."""
    code = ("import json; print(json.dumps({'cuda_available': True, "
            "'torch_cuda': '12.4', 'count': 1, 'name': 'A100', "
            "'capability': [8, 0]}))")
    monkeypatch.setattr(doctor, "PROBE_CODE", code)
    lines = []
    assert doctor.run_doctor(timeout_s=60, as_json=True,
                             _print=lines.append) == 1
    rep = json.loads(lines[-1])
    assert "sm_90a" in rep["device"]["error"]
    assert os.path.isabs(rep["build"]["dir"])
