"""The port's sharded receiver chain on a 4-rank Gloo group on the CPU:
every stage (FM, AM and SSB demodulation, AGC, the resampler, the stereo
decoder) and the composition (``ShardedReceiver``, ``ShardedReceiverBank``).

One group runs every case of ``tests/shard_cases_receiver.py``. Each result
is held against the port's single-device stage on the same seeded input,
bit for bit (the sharded FM against the default, non-kernel
``FMDemodulator``, as the reference does), and against the JAX package's
sharded stage on the conftest's 8 virtual CPU devices at the tolerance of
the port's single-device tests of that stage; two receivers where the float
difference is amplified have a stated limit of their own (``AM_REL``,
``EMPTY_STATION_REL``).
"""

import numpy as np
import pytest
import torch

import shard_cases_receiver as cases
from torch_shard_harness import run_group
from tpu_sdr.kernels.demod import AGC as JAGC
from tpu_sdr.kernels.demod import AMDemodulator as JAMDemodulator
from tpu_sdr.kernels.demod import FMDemodulator as JFMDemodulator
from tpu_sdr.kernels.demod import SSBDemodulator as JSSBDemodulator
from tpu_sdr.kernels.resample import Resampler as JResampler
from tpu_sdr.kernels.stereo import StereoDecoder as JStereoDecoder
from tpu_sdr.runtime.receiver import Receiver as JReceiver
from tpu_sdr.runtime.receiver import ReceiverBank as JReceiverBank
from tpu_sdr.shard import ShardedAGC as JShardedAGC
from tpu_sdr.shard import ShardedAMDemodulator as JShardedAMDemodulator
from tpu_sdr.shard import ShardedFMDemodulator as JShardedFMDemodulator
from tpu_sdr.shard import ShardedReceiver as JShardedReceiver
from tpu_sdr.shard import ShardedReceiverBank as JShardedReceiverBank
from tpu_sdr.shard import ShardedResampler as JShardedResampler
from tpu_sdr.shard import ShardedSSBDemodulator as JShardedSSBDemodulator
from tpu_sdr.shard.stereo import ShardedStereoDecoder as JShardedStereoDecoder
from tpu_sdr.shard import make_sdr_mesh as jmesh
from tpu_sdr_torch.kernels.demod import AGC, AMDemodulator, FMDemodulator, SSBDemodulator
from tpu_sdr_torch.kernels.resample import Resampler
from tpu_sdr_torch.kernels.stereo import StereoDecoder

torch.set_num_threads(1)

FS = cases.FS
# Port vs JAX, the single-device tests' bounds.
FM_ATOL = 2e-6  # tests/test_torch_demod.py
STAGE_ATOL = 2e-6  # AM, SSB, AGC (tests/test_torch_demod.py)
RES_ATOL = 1e-6  # tests/test_torch_resample.py
STEREO_ATOL = 1e-5  # tests/test_torch_receiver.py
RX_REL = 1e-5  # of the audio's peak (tests/test_torch_receiver.py)
# Two receivers amplify the packages' fp32 cos/sin difference that RX_REL's
# comment names (ROADMAP C14); one device shows the same distance, sharding
# adds none. Each limit is relative to the peak, above the worst measured on
# these inputs on the CPU:
AM_REL = 2e-5  # an FM carrier through the AM chain; the AGC integrates (1.17e-5)
EMPTY_STATION_REL = 5e-4  # the stereo bank's empty station, an FM
# discriminator of noise, to its own peak (2.88e-4)


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    return run_group(tmp_path_factory.mktemp("shard_receiver"), "shard_cases_receiver", 4)


def result(group, name):
    results, errors = group
    if name not in results:
        pytest.fail(f"case {name} did not finish in the rank group:\n{errors}")
    return results[name]


def assert_equal_tree(got, ref):
    if isinstance(ref, dict):
        assert set(got) == set(ref)
        for k in ref:
            assert_equal_tree(got[k], ref[k])
    elif isinstance(ref, (list, tuple)):
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            assert_equal_tree(g, r)
    elif isinstance(ref, np.ndarray):
        assert got.shape == ref.shape and np.array_equal(got, ref), np.abs(got - ref).max()
    else:
        assert got == ref


def assert_close_list(got, ref, atol):
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, rtol=0, atol=atol)


@pytest.mark.parametrize("mesh_shape", cases.MESHES)
def test_sharded_fm_bitwise(group, mesh_shape):
    got = result(group, "fm")[mesh_shape]
    t = mesh_shape[1] * 512
    fm = FMDemodulator(FS, deviation_hz=5e3, deemphasis_tau=75e-6, device="cpu")
    assert_equal_tree(got, cases.run_demod(fm, 8, t, 71))
    jfm = JFMDemodulator(FS, deviation_hz=5e3, deemphasis_tau=75e-6)
    jref = cases.run_demod(JShardedFMDemodulator(jfm, jmesh(*mesh_shape)), 8, t, 71)
    assert_close_list(got["audio"], jref["audio"], FM_ATOL)
    np.testing.assert_allclose(got["state"]["filt"], jref["state"]["filt"], rtol=0, atol=FM_ATOL)


@pytest.mark.parametrize("mesh_shape", [(2, 2), (1, 4)])
def test_sharded_am_bitwise(group, mesh_shape):
    got = result(group, "am")[mesh_shape]
    t = mesh_shape[1] * 384
    assert_equal_tree(got, cases.run_demod(AMDemodulator(FS, device="cpu"), 4, t, 72, swap=True))
    jref = cases.run_demod(JShardedAMDemodulator(JAMDemodulator(FS), jmesh(*mesh_shape)),
                           4, t, 72, swap=True)
    assert_close_list(got["audio"], jref["audio"], STAGE_ATOL)


@pytest.mark.parametrize("mesh_shape", [(2, 2), (4, 1)])
def test_sharded_ssb_bitwise(group, mesh_shape):
    got = result(group, "ssb")[mesh_shape]
    t = mesh_shape[1] * 256
    assert_equal_tree(got, cases.run_demod(SSBDemodulator(FS, bfo_hz=1500.0, device="cpu"),
                                           4, t, 73))
    jref = cases.run_demod(JShardedSSBDemodulator(JSSBDemodulator(FS, bfo_hz=1500.0),
                                                  jmesh(*mesh_shape)), 4, t, 73)
    assert_close_list(got["audio"], jref["audio"], STAGE_ATOL)


@pytest.mark.parametrize("mesh_shape", [(2, 2), (1, 4)])
def test_sharded_agc_bitwise(group, mesh_shape):
    got = result(group, "agc")[mesh_shape]
    t = mesh_shape[1] * 256
    assert_equal_tree(got, cases.run_agc(AGC(mu=5e-3, ref=1.0, device="cpu"), 4, t))
    jref = cases.run_agc(JShardedAGC(JAGC(mu=5e-3, ref=1.0), jmesh(*mesh_shape)), 4, t)
    for k in ("real", "re", "im"):
        np.testing.assert_allclose(got[k], jref[k], rtol=0, atol=STAGE_ATOL)


@pytest.mark.parametrize("mesh_shape", cases.MESHES)
def test_sharded_resampler_bitwise(group, mesh_shape):
    got = result(group, "resampler")[mesh_shape]
    t = mesh_shape[1] * 64
    assert_equal_tree(got, cases.run_resampler(
        Resampler(up=3, down=2, taps_per_phase=6, device="cpu"), 8, t))
    jref = cases.run_resampler(JShardedResampler(JResampler(up=3, down=2, taps_per_phase=6),
                                                 jmesh(*mesh_shape)), 8, t)
    assert_close_list(got["out"], jref["out"], RES_ATOL)


@pytest.mark.parametrize("mesh_shape", cases.MESHES)
def test_sharded_stereo_decoder_bitwise(group, mesh_shape):
    """On a real MPX (pilot + L/R program) with the state carried."""
    got = result(group, "stereo")[mesh_shape]
    t = mesh_shape[1] * 512
    dec = StereoDecoder(200_000.0, deemphasis_tau=75e-6, leak=0.98, device="cpu")
    assert_equal_tree(got, cases.run_stereo(dec, 8, t))
    jdec = JStereoDecoder(200_000.0, deemphasis_tau=75e-6, leak=0.98)
    jref = cases.run_stereo(JShardedStereoDecoder(jdec, jmesh(*mesh_shape)), 8, t)
    assert_close_list(got["lr"], jref["lr"], STEREO_ATOL)


def _check_rx(got, ref, jref, rel=RX_REL):
    """got == the port's single-device ref bit for bit, and within ``rel``
    of the JAX sharded jref's peak. ``rel`` a sequence: one limit a station
    of a bank, each against that station's own peak."""
    assert_equal_tree(got, ref)
    for g, j in zip(got["audio"], jref["audio"]):
        if np.ndim(rel) == 0:
            assert np.abs(g - j).max() <= rel * np.abs(j).max()
        else:
            for k, lim in enumerate(rel):
                assert np.abs(g[k] - j[k]).max() <= lim * np.abs(j[k]).max(), k


@pytest.mark.parametrize("mode", cases.RX_MODES)
@pytest.mark.parametrize("mesh_shape", [(2, 2), (1, 4)])
def test_sharded_receiver_bitwise(group, mode, mesh_shape):
    got = result(group, "receivers")[mesh_shape][mode]
    rx = cases.receiver(mode, device="cpu")
    t = got.pop("granularity")
    assert t == mesh_shape[1] * rx.chunk_granularity
    jsh = JShardedReceiver(cases.receiver(mode, JReceiver), jmesh(*mesh_shape))
    _check_rx(got, cases.run_receiver(rx, mode, t), cases.run_receiver(jsh, mode, t),
              AM_REL if mode == "am" else RX_REL)


@pytest.mark.parametrize("mesh_shape", [(2, 2), (1, 4)])
def test_sharded_receiver_stereo_bitwise(group, mesh_shape):
    """The stereo WBFM chain (DDC -> FM -> MPX decode -> de-emphasis ->
    resample); the pilot locked and L != R."""
    got = result(group, "receivers")[mesh_shape]["stereo"]
    rx = cases.receiver("stereo", device="cpu")
    t = got.pop("granularity")
    jsh = JShardedReceiver(cases.receiver("stereo", JReceiver), jmesh(*mesh_shape))
    _check_rx(got, cases.run_receiver(rx, "stereo", t), cases.run_receiver(jsh, "stereo", t))
    assert got["audio"][-1].shape[:2] == (2, 2)
    assert np.all(np.sqrt(got["state"]["stereo"]["pilot_pow"]) > 0.02)
    assert not np.array_equal(got["audio"][-1][0, 0], got["audio"][-1][0, 1])


def test_sharded_receiver_with_squelch_bitwise(group):
    got = result(group, "receiver_squelch_validation")["squelch"]
    rx = cases.receiver("squelch", device="cpu")
    t = 2 * rx.chunk_granularity
    jsh = JShardedReceiver(cases.receiver("squelch", JReceiver), jmesh(2, 2))
    _check_rx(got, cases.run_receiver(rx, "squelch", t), cases.run_receiver(jsh, "squelch", t))
    assert np.max(np.abs(got["audio"][-1][1][256:])) == 0.0  # squelched


def test_sharded_receiver_validation(group):
    assert "chunk_granularity" in result(group, "receiver_squelch_validation")["granularity"]


@pytest.mark.parametrize("mode", ["wbfm", "am"])
@pytest.mark.parametrize("mesh_shape", [(2, 2), (4, 1)])
def test_sharded_receiver_bank_bitwise(group, mode, mesh_shape):
    """K = 4 stations from ONE shared stream, carriers over the channel
    axis."""
    got = result(group, "banks")[mesh_shape][mode]
    bank = cases.receiver_bank(mode, device="cpu")
    t = mesh_shape[1] * bank.chunk_granularity
    jsh = JShardedReceiverBank(cases.receiver_bank(mode, JReceiverBank), jmesh(*mesh_shape))
    _check_rx(got, cases.run_bank(bank, mode, t), cases.run_bank(jsh, mode, t))
    assert got["audio"][-1].shape[0] == 4


def test_sharded_receiver_bank_stereo_bitwise(group):
    got = result(group, "banks")["stereo"]
    bank = cases.receiver_bank("stereo", device="cpu")
    t = 2 * bank.chunk_granularity
    jsh = JShardedReceiverBank(cases.receiver_bank("stereo", JReceiverBank), jmesh(2, 2))
    # Station 0 carries the program; station 1 (350 kHz) is empty.
    _check_rx(got, cases.run_bank(bank, "stereo", t), cases.run_bank(jsh, "stereo", t),
              [RX_REL, EMPTY_STATION_REL])
    assert got["audio"][-1].shape[:2] == (2, 2)
    assert np.sqrt(got["state"]["stereo"]["pilot_pow"]).reshape(-1)[0] > 0.02
