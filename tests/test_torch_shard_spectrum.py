"""The sharded spectrum engines of the port (``tpu_sdr_torch.shard``) on a
4-rank Gloo group on the CPU: ``ShardedSpectrumPipeline`` on every path,
``SpectrumAnalyzer(mesh=...)``, ``StreamFeeder(sharding=...)``,
``fft_4step_sharded`` and ``LatencyPipeline``.

One group runs every case of ``tests/shard_cases_spectrum.py`` (meshes
(1, 2), (2, 1), (2, 2), (1, 4) and (4, 1); a 2-rank mesh is a sub-mesh of
the group). Each test holds one case's gathered result two ways: against
the port's single-device result on the same seeded input, bit for bit (the
latency engine within 1e-5 relative, as the reference's contract), and
against the JAX package's sharded engine on the conftest's 8 virtual CPU
devices (JAX's kernels in Pallas interpret mode), at the tolerances of the
port's single-device tests of these paths.
"""

import numpy as np
import pytest
import torch

import shard_cases_spectrum as cases
from torch_shard_harness import run_group
from tpu_sdr.control import SpectrumAnalyzer as JSpectrumAnalyzer
from tpu_sdr.core.config import FilterMode as JFilterMode
from tpu_sdr.core.config import PipelineConfig as JPipelineConfig
from tpu_sdr.kernels import fft as jfft
from tpu_sdr.shard import ShardedSpectrumPipeline as JShardedSpectrumPipeline
from tpu_sdr.shard import make_sdr_mesh as jmake_sdr_mesh
from tpu_sdr.shard.latency import LatencyPipeline as JLatencyPipeline
from tpu_sdr_torch import FilterMode, PipelineConfig, SpectrumAnalyzer, SpectrumPipeline
from tpu_sdr_torch import StreamFeeder
from tpu_sdr_torch.kernels import fft

torch.set_num_threads(1)

N = cases.N
# Port vs JAX (the single-device tests' floors): the f32 tier, and bf16.
PARITY_FLOOR_DB = {"f32": 90.0, "bf16": 45.0}
LATENCY_REL = 1e-5  # the reference's latency-engine contract (tests/test_latency.py)


def snr_db(ref, got) -> float:
    ref = np.asarray(ref, np.float64)
    err = np.sum((ref - np.asarray(got, np.float64)) ** 2)
    return np.inf if err == 0 else 10 * np.log10(np.sum(ref**2) / err)


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    return run_group(tmp_path_factory.mktemp("shard_spectrum"), "shard_cases_spectrum", 4)


def result(group, name):
    results, errors = group
    if name not in results:
        pytest.fail(f"case {name} did not finish in the rank group:\n{errors}")
    return results[name]


def single(path: str, outputs: str = "magnitude", mode=None):
    pipe, x, state, m = cases.make_pipe(path, SpectrumPipeline, device="cpu")
    return cases.run_path(pipe, x, state, mode or m, outputs=outputs)


def jax_run(path: str, mesh_shape, outputs: str = "magnitude", mode=None):
    cfg_kw, m, kind = cases.PATHS[path]
    pipe = JShardedSpectrumPipeline(
        JPipelineConfig(channels=cases.C, **cfg_kw), jmake_sdr_mesh(*mesh_shape)
    )
    pipe.upload_sos(cases.HOP_SOS if path == "hop" else cases.SOS)
    if kind == "bank":
        pipe.upload_sos_bank(cases.bank_designs(cases.C))
    x = cases.iq_noise(cases.C, cases.FRAMES, 5) if kind == "iq" else cases.noise(
        cases.C, cases.FRAMES, 3)
    state = pipe.initial_state(batch_shape=(2,) if kind == "iq" else ())
    outs = []
    for part in np.split(x, 2, axis=-1):
        out, state = pipe.process(part, state, JFilterMode[mode or m], outputs)
        outs.append(out)
    res = {k: np.concatenate([np.asarray(o[k], np.float32) for o in outs], axis=-2)
           for k in outs[0]}
    res["sos_state"] = np.asarray(state.sos_state)
    return res


def check(got: dict, ref: dict, jref: dict, floor_db: float):
    """got == the port's single-device ref bit for bit (outputs and state);
    got against JAX's sharded run at ``floor_db`` and the state tolerance."""
    assert set(got) == set(ref)
    for k in ref:
        if ref[k] is None or isinstance(ref[k], int):
            assert got[k] == ref[k], k
        else:
            assert got[k].shape == ref[k].shape, k
            assert np.array_equal(got[k], ref[k]), (k, np.abs(got[k] - ref[k]).max())
    for k in jref:
        if k == "sos_state":
            np.testing.assert_allclose(got[k], jref[k], rtol=1e-4, atol=1e-6)
        elif k != "phase":  # phase is ill-conditioned at tiny |X|
            assert snr_db(jref[k], got[k]) >= floor_db, k


@pytest.mark.parametrize("mesh_shape", cases.MESHES)
def test_sharded_equals_single_device(group, mesh_shape):
    got = result(group, "custom")[mesh_shape]
    check(got, single("custom"), jax_run("custom", mesh_shape), PARITY_FLOOR_DB["f32"])
    assert got["frame_count"] == cases.FRAMES


@pytest.mark.parametrize("mesh_shape", cases.MESHES)
def test_sharded_fused_two_pass_equals_single_device(group, mesh_shape):
    check(result(group, "fused")[mesh_shape], single("fused"), jax_run("fused", mesh_shape),
          PARITY_FLOOR_DB["f32"])


@pytest.mark.parametrize("mesh_shape", cases.MESHES)
def test_hop_time_sharded_equals_single(group, mesh_shape):
    """The (N - hop) halo: spectra, final state and the replicated history
    across a carried-state chunk boundary."""
    got = result(group, "hop")[mesh_shape]
    check(got, single("hop"), jax_run("hop", mesh_shape), PARITY_FLOOR_DB["f32"])
    assert got["history"].shape == (cases.C, N - 8192)


@pytest.mark.parametrize("mesh_shape", cases.MESHES)
def test_banked_time_sharded_equals_single(group, mesh_shape):
    check(result(group, "bank")[mesh_shape], single("bank"), jax_run("bank", mesh_shape),
          PARITY_FLOOR_DB["f32"])


@pytest.mark.parametrize("mesh_shape", cases.MESHES)
def test_sharded_iq_equals_single_device(group, mesh_shape):
    check(result(group, "iq")[mesh_shape], single("iq"), jax_run("iq", mesh_shape),
          PARITY_FLOOR_DB["f32"])


@pytest.mark.parametrize("path", ["fixed", "bypass"])
def test_bypass_mode_sharded(group, path):
    check(result(group, "fixed_bypass")[path][(2, 2)], single(path), jax_run(path, (2, 2)),
          PARITY_FLOOR_DB["f32"])


@pytest.mark.parametrize("mesh_shape", [(2, 2), (1, 4)])
def test_sharded_equals_single_device_bf16_io(group, mesh_shape):
    check(result(group, "bf16_io")[mesh_shape], single("bf16_io"),
          jax_run("bf16_io", mesh_shape), PARITY_FLOOR_DB["bf16"])


@pytest.mark.parametrize("mode", ["BYPASS", "CUSTOM"])
def test_phase_output_sharded(group, mode):
    """Every output of the plain path (magnitude, re, im, phase, power)."""
    got = result(group, "outputs_all")[(2, 2)][mode]
    check(got, single("custom", "all", FilterMode[mode]),
          jax_run("custom", (2, 2), "all", mode), PARITY_FLOOR_DB["f32"])
    assert {"magnitude", "re", "im", "phase", "power"} <= set(got)


def test_sharded_stream_chunks_carry_state(group):
    """(1, 4), one channel: two chunks with the state carried == the port's
    single-device two-chunk run bit for bit, and again (bit-deterministic);
    and == the one-shot dispatch bit for bit (the port's chunking contract;
    the reference allows float tolerance there)."""
    got = result(group, "chunks")[(1, 4)]
    pipe = SpectrumPipeline(PipelineConfig(channels=1), device="cpu")
    pipe.upload_sos(cases.CHUNK_SOS)
    x = cases.noise(1, 8, 4)
    ref = cases.run_path(pipe, x, pipe.initial_state(), FilterMode.CUSTOM, 2)
    for k in ("chunked", "again"):
        assert np.array_equal(got[k]["magnitude"], ref["magnitude"])
        assert np.array_equal(got[k]["sos_state"], ref["sos_state"])
    assert np.array_equal(got["chunked"]["magnitude"], got["whole"]["magnitude"])
    assert np.array_equal(got["chunked"]["sos_state"], got["whole"]["sos_state"])


def test_mesh_validation(group):
    assert "3*3 > 4 ranks" in result(group, "validation")["mesh"]


def test_friendly_channel_divisibility_error(group):
    """Channel and length errors come before any transfer; FastFIR's block
    message names chunk_granularity."""
    res = result(group, "validation")
    assert "channel axis (2)" in res["channels"]
    assert "time_shards*fft_size = 32768" in res["length"]
    assert "channel axis (2)" in res["fir_channels"]
    assert "chunk_granularity=1024" in res["fir_block"]


def test_intra_fft_sharding(group):
    """fft_4step_sharded over 4 ranks == the unsharded four-step (and the
    JAX sharded form) within 1e-5 of the peak, real and complex input."""
    import jax
    from jax.sharding import PartitionSpec as P

    res = result(group, "intra_fft")
    plan = fft.plan_constants(128, 128, device="cpu")
    jplan = jfft.plan_constants(128, 128)
    rng = np.random.default_rng(0)
    xr = rng.standard_normal((128, 128)).astype(np.float32)
    xi = rng.standard_normal((128, 128)).astype(np.float32)
    jmesh = jax.make_mesh((4,), ("fft",))
    for kind, im in (("real", None), ("complex", xi)):
        fr, fi = fft.fft_4step(torch.as_tensor(xr.reshape(-1)),
                               None if im is None else torch.as_tensor(im.reshape(-1)), plan)
        ref = fr.numpy() + 1j * fi.numpy()
        got = res[kind][0] + 1j * res[kind][1]
        assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-5, kind
        args = (xr,) if im is None else (xr, im)
        body = (lambda a: jfft.fft_4step_sharded(a, None, jplan, "fft")) if im is None else (
            lambda a, b: jfft.fft_4step_sharded(a, b, jplan, "fft"))
        jr, ji = jax.jit(jax.shard_map(
            body, mesh=jmesh, in_specs=(P(None, "fft"),) * len(args),
            out_specs=(P("fft"), P("fft")), check_vma=False))(*args)
        jref = np.asarray(jr).reshape(-1) + 1j * np.asarray(ji).reshape(-1)
        assert np.abs(got - jref).max() / np.abs(jref).max() < 1e-5, kind


def test_sosfilt_blocked_timesharded(group):
    """The per-section cascade on 4 time shards (frames of 4 blocks) ==
    the single-device sosfilt_blocked with the same frames, bit for bit,
    and the JAX package's time-sharded form within 1e-5 of the scale (the
    single-device test's bound, tests/test_torch_host_runtime.py)."""
    import jax
    from jax.sharding import PartitionSpec as P

    from tpu_sdr.kernels import biquad as jbiquad
    from tpu_sdr_torch.kernels import biquad

    got = result(group, "blocked_timesharded")
    x, zi = cases.blocked_input()
    op = biquad.precompute(cases.BLOCKED_SOS, 128, device="cpu")
    y, zf = biquad.sosfilt_blocked(op, torch.as_tensor(x), torch.as_tensor(zi), 4)
    assert np.array_equal(got["y"], y.numpy()) and np.array_equal(got["zf"], zf.numpy())
    jop = jbiquad.precompute(cases.BLOCKED_SOS, 128)
    jmesh = jax.sharding.Mesh(np.array(jax.devices()[:4]), ("time",))
    jy, jzf = jax.jit(jax.shard_map(
        lambda xl, z: jbiquad.sosfilt_blocked_timesharded(jop, xl, z, time_axis="time",
                                                           frame_blocks=4),
        mesh=jmesh, in_specs=(P(None, "time"), P()), out_specs=(P(None, "time"), P()),
        check_vma=False))(x, zi)
    scale = np.abs(np.asarray(jy)).max()
    assert np.abs(got["y"] - np.asarray(jy)).max() <= 1e-5 * scale
    assert np.abs(got["zf"] - np.asarray(jzf)).max() <= 1e-5 * np.abs(np.asarray(jzf)).max()


def test_sharded_analyzer_equals_single(group):
    """SpectrumAnalyzer(mesh=(2, 2)) under command bytes == the port's
    single-device analyzer bit for bit (magnitudes, on_spectrum frames, the
    checkpointed state), and the JAX analyzer at the parity floor."""
    got = result(group, "analyzer")
    ref = cases.drive_analyzer(SpectrumAnalyzer(PipelineConfig(channels=2), device="cpu"))
    for k in ("a", "b", "sos_state"):
        assert np.array_equal(got[k], ref[k]), k
    assert got["frames"] == ref["frames"] and got["frame_count"] == ref["frame_count"] == 4
    jref = cases.drive_analyzer(JSpectrumAnalyzer(JPipelineConfig(channels=2),
                                                  mesh=jmake_sdr_mesh(2, 2)))
    for k in ("a", "b"):
        assert snr_db(jref[k], got[k]) >= PARITY_FLOOR_DB["f32"], k


def test_sharded_feeder_equals_single(group):
    """StreamFeeder(sharding=mesh) stages each rank's (1, 16384) block; the
    sharded pipeline on those blocks == the single-device pipeline fed by
    a plain feeder, bit for bit."""
    got = result(group, "feeder")
    pipe = SpectrumPipeline(PipelineConfig(channels=2), device="cpu")
    pipe.upload_sos(cases.SOS)
    ref = cases.drive_feeder(pipe, StreamFeeder, dict(device="cpu"))
    assert got["blocks"] == [(1, N)] * 3 and ref["blocks"] == [(2, 2 * N)] * 3
    assert np.array_equal(got["mag"], ref["mag"])
    assert np.array_equal(got["sos_state"], ref["sos_state"])


def _latency_refs():
    pipe = SpectrumPipeline(PipelineConfig(channels=1), device="cpu")
    x = np.random.default_rng(40).standard_normal(N).astype(np.float32)
    bypass = pipe.process(x, pipe.initial_state(), FilterMode.BYPASS)[0]["magnitude"][0, 0]
    pipe.upload_sos(cases.HOP_SOS)
    xs = np.random.default_rng(41).standard_normal(3 * N).astype(np.float32)
    custom = pipe.process(xs, pipe.initial_state(), FilterMode.CUSTOM)[0]["magnitude"][0]
    return bypass.numpy(), custom.numpy()


@pytest.mark.parametrize("mesh_shape", [(1, 2), (1, 4)])
def test_latency_bypass_matches_throughput(group, mesh_shape):
    got = result(group, "latency")[mesh_shape]["bypass"]
    ref, _ = _latency_refs()
    assert np.abs(got - ref).max() / ref.max() < LATENCY_REL
    lat = JLatencyPipeline(JPipelineConfig(channels=1), jax_latency_mesh(mesh_shape))
    x = np.random.default_rng(40).standard_normal(N).astype(np.float32)
    jmag = np.asarray(lat.process_frame(x, lat.initial_state(), JFilterMode.BYPASS)[0])
    assert np.abs(got - jmag).max() / jmag.max() < LATENCY_REL


def jax_latency_mesh(mesh_shape):
    import jax

    return jax.sharding.Mesh(np.array(jax.devices()[: mesh_shape[1]]), ("fft",))


@pytest.mark.parametrize("mesh_shape", [(1, 2), (1, 4)])
def test_latency_filtered_stream_matches_throughput(group, mesh_shape):
    """Three frames with carried state: the per-rank chain reproduces the
    throughput engine's sample-exact stream within 1e-5 a frame."""
    res = result(group, "latency")[mesh_shape]
    _, ref = _latency_refs()
    for f in range(3):
        rel = np.abs(res["custom"][f] - ref[f]).max() / ref[f].max()
        assert rel < LATENCY_REL, (f, rel)
    lat = JLatencyPipeline(JPipelineConfig(channels=1), jax_latency_mesh(mesh_shape))
    lat.upload_sos(cases.HOP_SOS)
    xs = np.random.default_rng(41).standard_normal(3 * N).astype(np.float32)
    z = lat.initial_state()
    for f in range(3):
        jmag, z = lat.process_frame(xs[f * N : (f + 1) * N], z, JFilterMode.CUSTOM)
        jmag = np.asarray(jmag)
        assert np.abs(res["custom"][f] - jmag).max() / jmag.max() < LATENCY_REL, f
    np.testing.assert_allclose(res["custom_state"], np.asarray(z), rtol=1e-4, atol=1e-6)


def test_latency_fixed_mode_and_validation(group):
    for mesh_shape in ((1, 2), (1, 4)):
        res = result(group, "latency")[mesh_shape]
        assert res["fixed_zero"].shape == (N,) and np.all(res["fixed_zero"] == 0.0)
        assert "single-stream" in res["channels"]


def test_latency_rejects_iir_block_fft_n1_mismatch(group):
    for mesh_shape in ((1, 2), (1, 4)):
        assert "iir_block == fft_n1" in result(group, "latency")[mesh_shape]["iir_block"]


def test_pod_mesh_layout_and_host_warning(group):
    """distributed.pod_mesh: all ranks on time by default; a channel split;
    with two hosts (LOCAL_WORLD_SIZE=2) the channel axis spans them, and a
    channel axis that is no multiple of the hosts warns."""
    res = result(group, "pod_mesh")
    assert res["default"] == {"channel": 1, "time": 4}
    assert res["channel2"] == {"channel": 2, "time": 2}
    assert res["hosts"] == {"channel": 2, "time": 2}
    assert res["warned"] is True
    assert "!= 4 ranks" in res["bad"]
