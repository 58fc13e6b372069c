"""The check must fail a broken system, and its control.

Each cell runs here on the CPU at a tiny size (``tiny.shrink``) with the
harness's look for a card skipped, once sound and once with the timed path
broken underneath, and ``correct`` has to come out false for each fault
the cell can have:

- a step that returns its state unchanged (the cells with an IIR; in BYPASS
  the state holds only counters, which no output reads);
- half of the batch left out: the spectra of half the channels not
  computed, the mean of the others in their place;
- an answer altered where it is produced: one bin of every frame moved by
  a hundredth of the frame's peak; and, in the cells with an IIR, by a
  hundredth of its own channel's peak only in the channels whose design
  passes little (``mag_err_ch`` has to see it: ``mag_err`` reads it
  against the input's scale).

The exchange between chips does not exist on one card. The control (the
reference in TF32, ``run_cell(control=True)``) has to fail too, and on the
card at the cells' own sizes so do the port's own lower precisions (its
matrix products in TF32, its bf16 tier); their readings are in PERF.md.
"""

import time

import pytest

from sdrbench import run, spec
from sdrbench.tests import tiny

pytest.importorskip("torch")

CELLS = ["bank64.custom.sat", "wideband_iq.bypass.sat", "bank64.custom.rt", "bank64.bypass.sat"]
IIR_CELLS = ["bank64.custom.sat", "bank64.custom.rt"]


def _run(name, seed=11, **kw):
    cell = tiny.shrink(spec.find_cell(tiny.benchmark(), name))
    seconds = 1.0
    result, lines = run.run_cell(cell, seed, seconds, False, device="cpu", t_start=time.time(), **kw)
    assert result["attempted"] >= 1
    assert list(result)[-1] == "checks" and lines[0].startswith("check mag_err")
    return result


def _break(monkeypatch, fault):
    """Patch the port's dispatch (``runtime/stream.py``) with ``fault``."""
    from tpu_sdr_torch.runtime import stream

    for name in ("process_stream", "process_stream_complex"):
        original = getattr(stream, name)
        monkeypatch.setattr(stream, name, (lambda f: lambda *a, **k: fault(f, *a, **k))(original))


def state_unchanged(original, x, state, *a, **k):
    out, _ = original(x, state, *a, **k)
    return out, state


def half_the_batch(original, *a, **k):
    out, state = original(*a, **k)
    mag = out["magnitude"].clone()
    half = mag.shape[0] // 2
    mag[half:] = mag[:half].mean(dim=0)
    return {"magnitude": mag}, state


def answer_altered(original, *a, **k):
    out, state = original(*a, **k)
    mag = out["magnitude"].clone()
    mag[..., 1] += 0.01 * mag.amax(dim=-1)
    return {"magnitude": mag}, state


def quiet_channels_altered(original, *a, **k):
    out, state = original(*a, **k)
    mag = out["magnitude"].clone()
    peak = mag.amax(dim=(-2, -1))
    quiet = peak < 0.01 * peak.max()
    mag[quiet, :, 1] += 0.01 * mag[quiet].amax(dim=-1)
    return {"magnitude": mag}, state


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    result = _run(name)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", [half_the_batch, answer_altered])
def test_a_broken_run_is_not_correct(monkeypatch, name, fault):
    _break(monkeypatch, fault)
    result = _run(name)
    assert not result["correct"], result["checks"]
    assert result["failed"] >= 1


@pytest.mark.parametrize("name", IIR_CELLS)
def test_a_state_left_unchanged_is_not_correct(monkeypatch, name):
    _break(monkeypatch, state_unchanged)
    result = _run(name)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("name", IIR_CELLS)
def test_an_answer_altered_in_the_quiet_channels_is_not_correct(monkeypatch, name):
    _break(monkeypatch, quiet_channels_altered)
    result = _run(name)
    checks = result["checks"]
    assert checks["mag_err_ch"]["value"] > checks["mag_err_ch"]["limit"]
    assert not result["correct"] and result["failed"] >= 1


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    result = _run(name, control=True)
    assert not result["correct"], result["checks"]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_at_the_cells_own_size(card, name):
    """On the card, at the cell's own sizes and load (a 2 s window)."""
    cell = spec.find_cell(tiny.benchmark(), name)
    result, _ = run.run_cell(cell, 2**31 + 77, 2.0, False, control=True, t_start=time.time())
    assert not result["correct"], result["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["program_tf32", "program_bf16"])
@pytest.mark.parametrize("name", IIR_CELLS)
def test_the_ports_own_lower_precisions_fail_at_the_cells_own_size(card, name, kind):
    """The port itself with its matrix products in TF32, and its bf16 tier,
    on the card at the cell's own sizes and load (a 2 s window)."""
    from sdrbench import calibrate

    line = calibrate.one_run(tiny.benchmark(), name, 2**31 + 78, 2.0, kind)
    assert not line["correct"], line["checks"]
