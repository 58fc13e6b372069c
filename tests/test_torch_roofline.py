"""The port's cost model (``tpu_sdr_torch.bench.roofline``) against the
reference's (``tpu_sdr.bench.roofline``) on the same configurations: every
stage but the FFT counts the same; the FFT is the radix FFT the spectrum
kernels compute; the card is the H100 at its fp32 rate for every tier."""

import math

import pytest

from tpu_sdr.bench import roofline as ref
from tpu_sdr.core.config import PipelineConfig as RefConfig
from tpu_sdr_torch.bench import roofline
from tpu_sdr_torch.core.config import PipelineConfig

CONFIGS = {
    "default": {},
    "hop 8192": {"hop": 8192},
    "fft 1024": {"fft_size": 1024, "fft_n1": 32, "fft_n2": 32},
    "4 sections": {"n_sections": 4},
    "bf16 io": {"dtype": "bf16", "bf16_io": True},
}


@pytest.mark.parametrize("name", CONFIGS)
def test_stages_match_the_reference_but_the_fft(name):
    kw = CONFIGS[name]
    got = {s.name: s for s in roofline.pipeline_cost(PipelineConfig(**kw))}
    want = {s.name: s for s in ref.pipeline_cost(RefConfig(**kw))}
    assert list(got) == list(want)
    for stage in want:
        assert got[stage].hbm_bytes_per_frame == want[stage].hbm_bytes_per_frame
        if stage != "fft_4step":
            assert got[stage].flops_per_frame == want[stage].flops_per_frame, stage
    n = PipelineConfig(**kw).fft_size
    assert got["fft_4step"].flops_per_frame == 2.5 * n * math.log2(n)


def test_fft_count_is_the_radix_fft_behind_the_kernel_bound():
    """At F = 512 the FFT stage is the 0.2936 GFLOP of the row-1 bound
    (0.327 GFLOP with the magnitude's 4 operations a bin)."""
    stages = {s.name: s.flops_per_frame for s in roofline.pipeline_cost(PipelineConfig())}
    assert 512 * (stages["fft_4step"] + stages["magnitude"]) == pytest.approx(0.327e9, rel=2e-3)
    dense = {s.name: s.flops_per_frame for s in ref.pipeline_cost(RefConfig())}["fft_4step"]
    assert stages["fft_4step"] < dense / 40


def test_report_keys_are_a_superset_of_the_reference():
    got = roofline.roofline_report(PipelineConfig(), measured_samples_per_sec=1e9)
    want = ref.roofline_report(RefConfig(), measured_samples_per_sec=1e9)
    assert set(want) <= set(got)
    assert got["chip"] == "h100" and "tier_tflops" in got
    assert set(ref.serial_floor_report(RefConfig(), measured_samples_per_sec=1e9)) <= set(
        roofline.serial_floor_report(PipelineConfig(), measured_samples_per_sec=1e9))


@pytest.mark.parametrize("dtype", ["bf16", "f32", "f32max"])
def test_every_tier_runs_at_the_fp32_rate(dtype):
    rep = roofline.roofline_report(PipelineConfig(dtype=dtype))
    spec = roofline.CHIP_SPECS["h100"]
    assert rep["tier_tflops"] == spec["fp32_tflops"] == 67.0
    # the reference's identity: logical rate = bf16 peak / passes
    assert spec["bf16_tflops"] / rep["mxu_passes"] == pytest.approx(rep["tier_tflops"])
    t_compute = rep["flops_per_frame"] / 67e12
    t_memory = rep["hbm_bytes_per_frame"] / 3.35e12
    assert rep["bound"] == ("compute" if t_compute > t_memory else "memory")
    assert rep["ceiling_samples_per_sec"] == pytest.approx(16384 / max(t_compute, t_memory))
    assert list(roofline.CHIP_SPECS) == ["h100"]


def test_cost_model_sane():
    """The reference's TestRoofline, on the H100: the radix FFT brings the
    count to about 360 operations a sample, most of them the IIR's
    Toeplitz products; a 1 GSPS target fits under the ceiling."""
    rep = roofline.roofline_report(PipelineConfig())
    per_sample = rep["flops_per_frame"] / 16384
    assert 300 < per_sample < 400
    assert rep["stages"]["iir_toeplitz"] / rep["flops_per_frame"] > 0.7
    assert rep["ceiling_samples_per_sec"] > 1e9
    assert {"fft_4step", "iir_toeplitz", "magnitude"} <= set(rep["stages"])


def test_measured_fraction_responds():
    rep = roofline.roofline_report(PipelineConfig(), measured_samples_per_sec=5.2e9)
    assert rep["fraction_of_ceiling"] == pytest.approx(5.2e9 / rep["ceiling_samples_per_sec"])
    twice = roofline.roofline_report(PipelineConfig(), measured_samples_per_sec=10.4e9)
    assert twice["fraction_of_ceiling"] == pytest.approx(2 * rep["fraction_of_ceiling"])
    assert "fraction_of_ceiling" not in roofline.roofline_report(PipelineConfig())


def test_roofline_ceiling_accounts_for_hop():
    full = roofline.roofline_report(PipelineConfig())
    half = roofline.roofline_report(PipelineConfig(hop=8192))
    assert half["ceiling_samples_per_sec"] == pytest.approx(
        full["ceiling_samples_per_sec"] / 2, rel=1e-6)


def test_serial_floor_report_bounds():
    """The serial floor is below the ceiling (it adds the memory time of
    four passes instead of taking the max) and its fraction responds."""
    cfg = PipelineConfig(channels=8)
    rr = roofline.roofline_report(cfg)
    sf = roofline.serial_floor_report(cfg, measured_samples_per_sec=15e9)
    assert sf["serial_floor_samples_per_sec"] < rr["ceiling_samples_per_sec"]
    assert sf["hybrid_hbm_bytes_per_frame"] == 4 * cfg.fft_size * 4
    assert 0 < sf["fraction_of_serial_floor"] < 1
    sf2 = roofline.serial_floor_report(
        cfg, measured_samples_per_sec=2 * sf["serial_floor_samples_per_sec"])
    assert sf2["fraction_of_serial_floor"] == pytest.approx(2.0)
    io = roofline.serial_floor_report(PipelineConfig(dtype="bf16", bf16_io=True))
    assert io["hybrid_hbm_bytes_per_frame"] == 10 * 16384


def test_bound_takes_the_longer_of_bytes_and_operations():
    by_bytes = roofline.bound(3.35e9, 1e9)  # 1 ms of bytes, 0.0149 ms of fp32
    assert by_bytes["bound_ms"] == pytest.approx(1.0) and by_bytes["bound_by"] == "bytes"
    by_ops = roofline.bound(3.35e6, 67e9)  # 0.001 ms of bytes, 1 ms of fp32
    assert by_ops["bound_ms"] == pytest.approx(1.0) and by_ops["bound_by"] == "operations"
    assert by_ops["bytes"] == 3.35e6 and by_ops["flops"] == 67e9 and by_ops["int_ops"] == 0


def test_profiled_writes_a_chrome_trace(tmp_path):
    import json

    import torch

    with roofline.profiled(str(tmp_path / "trace")) as logdir:
        torch.arange(1024.0).sum()
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert logdir == str(tmp_path / "trace") and trace["traceEvents"]
