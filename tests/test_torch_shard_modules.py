"""The port's sharded streaming modules on a 4-rank Gloo group on the CPU:
``ShardedChannelizer`` (with and without the PFB kernel's path),
``ShardedWelchPSD``, ``ShardedFastFIR``, ``ShardedDDC``, ``ShardedDDCBank``
and ``SpectrumScanner(mesh=...)``.

One group runs every case of ``tests/shard_cases_modules.py``. Each result
is held against the port's single-device module on the same seeded input,
bit for bit (the Welch PSD within 1e-6 relative: its mean is a sum across
shards, as in the reference), and against the JAX package's sharded module
on the conftest's 8 virtual CPU devices at the tolerance of the port's
single-device tests of that module.
"""

import numpy as np
import pytest
import torch

import shard_cases_modules as cases
from torch_shard_harness import run_group
from tpu_sdr.kernels.ddc import DDC as JDDC
from tpu_sdr.kernels.ddc import DDCBank as JDDCBank
from tpu_sdr.kernels.fastconv import FastFIR as JFastFIR
from tpu_sdr.kernels.pfb import Channelizer as JChannelizer
from tpu_sdr.runtime.psd import WelchPSD as JWelchPSD
from tpu_sdr.runtime.scanner import SpectrumScanner as JSpectrumScanner
from tpu_sdr.shard import ShardedChannelizer as JShardedChannelizer
from tpu_sdr.shard import ShardedDDC as JShardedDDC
from tpu_sdr.shard import ShardedDDCBank as JShardedDDCBank
from tpu_sdr.shard import ShardedFastFIR as JShardedFastFIR
from tpu_sdr.shard import ShardedWelchPSD as JShardedWelchPSD
from tpu_sdr.shard import make_sdr_mesh as jmesh
from tpu_sdr_torch.runtime.psd import WelchPSD
from tpu_sdr_torch.runtime.scanner import SpectrumScanner

torch.set_num_threads(1)

PFB_REL = 1e-5  # of max |re| (tests/test_torch_pfb.py)
PSD_REL = 1e-5  # of the peak (tests/test_torch_psd.py)
WELCH_SHARDED_REL = 1e-6  # sharded vs single (the reference's, tests/test_psd.py)
FIR_REL = 1e-5  # of max |y| (tests/test_torch_fastconv.py)
DDC_ATOL = 1e-6  # tests/test_torch_ddc.py
DB_ATOL = 0.01  # tests/test_torch_scanner.py


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    return run_group(tmp_path_factory.mktemp("shard_modules"), "shard_cases_modules", 4)


def result(group, name):
    results, errors = group
    if name not in results:
        pytest.fail(f"case {name} did not finish in the rank group:\n{errors}")
    return results[name]


def assert_equal_tree(got, ref):
    """Every leaf of two result trees equal, bit for bit."""
    if isinstance(ref, dict):
        assert set(got) == set(ref)
        for k in ref:
            assert_equal_tree(got[k], ref[k])
    elif isinstance(ref, np.ndarray):
        assert got.shape == ref.shape and np.array_equal(got, ref), np.abs(got - ref).max()
    else:
        assert got == ref


def rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / (np.abs(ref).max() or 1.0))


@pytest.mark.parametrize("mesh_shape", cases.MESHES)
def test_sharded_channelizer_equals_single_bitwise(group, mesh_shape):
    got = result(group, "channelizer_meshes")[mesh_shape]
    assert_equal_tree(got, cases.run_channelizer(cases.channelizer(), mesh_shape[0]))
    sh = JShardedChannelizer(JChannelizer(m=cases.M, taps=cases.P, sample_rate=cases.FS),
                             jmesh(*mesh_shape))
    jref = cases.run_channelizer(sh, mesh_shape[0])
    for kind in ("real", "iq"):
        scale = np.abs(jref[kind]["re"]).max()
        for k in ("re", "im"):
            assert np.abs(got[kind][k] - jref[kind][k]).max() < PFB_REL * scale, (kind, k)


@pytest.mark.parametrize("mesh_shape", [(2, 2), (1, 4)])
def test_sharded_channelizer_kernel_path_equals_single(group, mesh_shape):
    """use_pallas=True in every rank (the pfb_fold_dft kernel's plain
    version here) == the single-device kernel path, bit for bit."""
    got = result(group, "channelizer_pallas")[mesh_shape]
    assert_equal_tree(got, cases.run_channelizer(cases.channelizer(use_pallas=True),
                                                 mesh_shape[0]))


def test_sharded_channelizer_streaming_chunks(group):
    """(1, 4): two carried-state chunks == the single-device one-shot run."""
    got = result(group, "channelizer_chunks_and_validation")["chunks"]
    ch = cases.channelizer()
    x = cases.rand((1, 128 * cases.M), 13)
    one, st = ch.process(x, ch.initial_state((1,)))
    assert np.array_equal(got["re"], one["re"].numpy())
    assert np.array_equal(got["state"], st.numpy())


def test_sharded_channelizer_validation(group):
    res = result(group, "channelizer_chunks_and_validation")
    assert "shorter than the halo" in res["halo"]


@pytest.mark.parametrize("mesh_shape", cases.MESHES)
@pytest.mark.parametrize("noverlap", [0, 256])
def test_sharded_welch_equals_single(group, mesh_shape, noverlap):
    got = result(group, "welch_meshes")[mesh_shape][noverlap]
    ref = cases.run_welch(WelchPSD(fs=1e6, nperseg=512, noverlap=noverlap, device="cpu"),
                          noverlap)
    est = JWelchPSD(fs=1e6, nperseg=512, noverlap=noverlap)
    sh = JShardedWelchPSD(est, jmesh(*mesh_shape))
    x = cases.rand((4, 16 * 512), 21 + noverlap)
    xs = cases.rand((2, 4, 16 * 512), 22 + noverlap)
    jref = {"real": np.asarray(sh.compute(x)), "iq": np.asarray(sh.compute_iq(xs))}
    for kind in ("real", "iq"):
        assert got[kind].shape == ref[kind].shape
        assert rel(got[kind], ref[kind]) < WELCH_SHARDED_REL, kind
        assert rel(got[kind], jref[kind]) < PSD_REL, kind


def test_sharded_welch_validation(group):
    res = result(group, "welch_validation")
    assert "average='mean' only" in res["median"]
    assert "shorter than nperseg" in res["short"]
    assert "must divide over" in res["divide"]


@pytest.mark.parametrize("mesh_shape", cases.MESHES)
def test_sharded_fastfir_equals_single_bitwise(group, mesh_shape):
    got = result(group, "fastfir_meshes")[mesh_shape]
    c, t = mesh_shape
    assert_equal_tree(got, cases.run_fastfir(cases.fastfir("real"), c, t))
    f = JFastFIR(cases.fastfir("real").fir, nfft=1024, block=512)
    jref = cases.run_fastfir(JShardedFastFIR(f, jmesh(*mesh_shape)), c, t)
    assert rel(got["out"], jref["out"]) < FIR_REL


def test_sharded_fastfir_iq_complex_taps_bitwise(group):
    got = result(group, "fastfir_iq_chunks_validation")["iq"]
    assert_equal_tree(got, cases.run_fastfir_iq(cases.fastfir("complex")))
    f = JFastFIR(cases.fastfir("complex").fir, nfft=2048, block=1024)
    jref = cases.run_fastfir_iq(JShardedFastFIR(f, jmesh(2, 2)))
    assert rel(got["out"], jref["out"]) < FIR_REL


def test_sharded_fastfir_streaming_chunks_bitwise(group):
    got = result(group, "fastfir_iq_chunks_validation")["chunks"]
    f = cases.fastfir("chunks")
    gran = 512 * 4
    x = cases.rand((2, 2 * gran), 33)
    one, st = f.process(x, f.initial_state((2,)))
    assert np.array_equal(got["out"], one.numpy())
    assert np.array_equal(got["state"]["tail"], st.tail.numpy())


def test_sharded_fastfir_validation(group):
    res = result(group, "fastfir_iq_chunks_validation")
    assert "divide over" in res["divide"]
    assert "not a multiple" in res["multiple"]


@pytest.mark.parametrize("mesh_shape", cases.MESHES)
def test_sharded_ddc_equals_single_bitwise(group, mesh_shape):
    got = result(group, "ddc_meshes")[mesh_shape]
    assert_equal_tree(got, cases.run_ddc(cases.ddc()))
    jref = cases.run_ddc(JShardedDDC(JDDC(fs=1e6, center_hz=123_456.789, decimation=8),
                                     jmesh(*mesh_shape)))
    for k in ("real", "iq1", "iq2"):
        for p in ("re", "im"):
            np.testing.assert_allclose(got[k][p], jref[k][p], rtol=0, atol=DDC_ATOL)


@pytest.mark.parametrize("mesh_shape", cases.MESHES)
def test_sharded_bank_equals_single_bitwise(group, mesh_shape):
    """Carrier-sharded bank == single-device DDCBank, every mesh shape."""
    got = result(group, "ddc_bank_meshes")[mesh_shape]
    assert_equal_tree(got, cases.run_ddc_bank(cases.ddc_bank()))
    jref = cases.run_ddc_bank(JShardedDDCBank(JDDCBank(fs=1e6, centers_hz=cases.CENTERS,
                                                       decimation=8), jmesh(*mesh_shape)))
    for k in ("real", "iq1", "iq2"):
        for p in ("re", "im"):
            np.testing.assert_allclose(got[k][p], jref[k][p], rtol=0, atol=DDC_ATOL)


def test_sharded_bank_validation(group):
    res = result(group, "ddc_validation")
    assert "carriers must divide" in res["carriers"]
    assert "ONE stream" in res["one_stream"]


def test_sharded_ddc_validation(group):
    res = result(group, "ddc_validation")
    assert "halo" in res["halo"]
    assert "divide" in res["divide"]


@pytest.mark.parametrize("mesh_shape", [(2, 2), (4, 1), (1, 4)])
def test_scanner_sharded_equals_single(group, mesh_shape):
    """SpectrumScanner(mesh=...) == the single-device scan bit for bit (the
    carrier-sharded bank contract), and the JAX sharded scan within the
    single-device test's 0.01 dB."""
    got = result(group, "scanner_meshes")[mesh_shape]
    ref = cases.run_scan(SpectrumScanner(cases.FS, 0.0, 500e3, device="cpu", **cases.SCAN_KW))
    assert np.array_equal(got["power"], ref["power"])
    assert np.array_equal(got["occupied"], ref["occupied"])
    assert got["hits"] == ref["hits"] and got["floor"] == ref["floor"]
    jres = cases.run_scan(JSpectrumScanner(cases.FS, 0.0, 500e3, mesh=jmesh(*mesh_shape),
                                           **cases.SCAN_KW))
    db = lambda p: 10 * np.log10(np.maximum(p, 1e-30))
    np.testing.assert_allclose(db(got["power"]), db(jres["power"]), rtol=0, atol=DB_ATOL)
    assert np.array_equal(got["occupied"], jres["occupied"]) and got["hits"] == jres["hits"]


def test_scanner_mesh_k_validation(group):
    assert "divide over" in result(group, "scanner_meshes")["k"]
