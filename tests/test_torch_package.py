"""The port's package-level names and the CUDA loader under concurrent use.

Each package of ``tpu_sdr_torch`` binds every name that its ``tpu_sdr``
counterpart's ``__init__.py`` binds (read from the reference's source, so a
name added there later shows up here). ``tpu_sdr.shard`` (ROADMAP A13) is
the one package not ported yet, and no package here re-exports it.

The loader tests stand a stub in for nvcc: a script that counts its runs and
writes its output slowly, so that two builds racing into one file would show
as a second run or a torn library.
"""

import ast
import importlib
import stat
import sys
import threading
import tomllib
import types
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PACKAGES = ("", ".kernels", ".runtime", ".core", ".control", ".transport", ".gui", ".bench")
# Names a reference package exports that the port leaves out on purpose, by
# ROADMAP item. None of the packages above has one: the sharded names (A13)
# live in tpu_sdr.shard.
GAPS: dict[str, set] = {}


def reference_exports(package: str) -> set:
    """The names the reference package's __init__.py binds."""
    path = ROOT / "tpu_sdr" / package.strip(".").replace(".", "/") / "__init__.py"
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.ImportFrom):
            names |= {a.asname or a.name for a in node.names}
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
    return names


@pytest.mark.parametrize("package", PACKAGES)
def test_package_exports_the_reference_names(package):
    names = reference_exports(package)
    assert names, package
    port = importlib.import_module("tpu_sdr_torch" + package)
    missing = sorted(n for n in names - GAPS.get(package, set()) if not hasattr(port, n))
    assert not missing, f"tpu_sdr_torch{package} lacks {missing}"


def test_package_level_imports_the_gui_needs():
    from tpu_sdr_torch import __version__
    from tpu_sdr_torch.core import qformat
    from tpu_sdr_torch.kernels import DDC, IQCorrector, RDSDecoder
    from tpu_sdr_torch.runtime import SpectrumScanner

    import tpu_sdr

    assert __version__ == tpu_sdr.__version__
    assert qformat.xfft_wire_scale(16384) == 2.0
    assert DDC.__module__ == "tpu_sdr_torch.kernels.ddc"
    assert SpectrumScanner.__module__ == "tpu_sdr_torch.runtime.scanner"
    assert IQCorrector.__module__ == "tpu_sdr_torch.kernels.iqcorr"
    assert RDSDecoder.__module__ == "tpu_sdr_torch.kernels.rds"


def test_package_data_ships_the_gui_page():
    """The GUI's page ships with the package beside the kernels' sources."""
    data = tomllib.loads((ROOT / "pyproject.toml").read_text())
    globs = data["tool"]["setuptools"]["package-data"]["tpu_sdr_torch"]
    assert "gui/templates/*.html" in globs
    pages = sorted(p.name for p in (ROOT / "tpu_sdr_torch" / "gui" / "templates").glob("*.html"))
    assert pages == ["index.html"]
    assert (ROOT / "tpu_sdr_torch" / "gui" / "templates" / "index.html").read_bytes() == (
        ROOT / "tpu_sdr" / "gui" / "templates" / "index.html").read_bytes()


STUB = """#!{python}
import sys, time
out = sys.argv[sys.argv.index("-o") + 1]
with open({count!r}, "a") as f:
    f.write("run\\n")
if {fail}:
    sys.stderr.write("stub nvcc: error\\n")
    sys.exit(1)
with open(out, "wb") as f:
    for _ in range(20):
        f.write(b"x" * 1000)
        f.flush()
        time.sleep(0.005)
print("stub nvcc: built")
"""


def _stub_nvcc(tmp_path, monkeypatch, fail: bool = False) -> Path:
    from tpu_sdr_torch.kernels.cuda import loader

    count = tmp_path / "runs.txt"
    stub = tmp_path / "nvcc"
    stub.write_text(STUB.format(python=sys.executable, count=str(count), fail=fail))
    stub.chmod(stub.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setattr(loader, "_nvcc", lambda: str(stub))
    monkeypatch.setattr(loader, "BUILD_DIR", tmp_path / "build")
    return count


def _in_threads(fn, n: int = 8) -> list:
    """fn() in n threads started together, a short switch interval; returns
    each thread's result or exception."""
    results = [None] * n
    start = threading.Barrier(n)

    def run(i):
        start.wait(timeout=10)
        try:
            results[i] = fn()
        except Exception as e:  # noqa: BLE001 - the test inspects it
            results[i] = e

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    return results


def test_loader_builds_a_library_once_under_concurrent_first_use(tmp_path, monkeypatch):
    from tpu_sdr_torch.kernels.cuda import loader

    count = _stub_nvcc(tmp_path, monkeypatch)
    results = _in_threads(lambda: loader.build("spectrum_bypass"))
    assert not [r for r in results if isinstance(r, Exception)], results
    assert count.read_text().count("run") == 1
    lib = loader.library_path("spectrum_bypass")
    assert lib.read_bytes() == b"x" * 20_000  # whole, not torn
    assert sorted(p.name for p in lib.parent.iterdir()) == [lib.name]  # no temporary left
    # one thread built it; the other seven found it built
    assert sorted(results) == [""] * 7 + ["stub nvcc: built\n"]


def test_loader_build_failure_raises_in_every_thread(tmp_path, monkeypatch):
    from tpu_sdr_torch.kernels.cuda import loader

    count = _stub_nvcc(tmp_path, monkeypatch, fail=True)
    results = _in_threads(lambda: loader.build("spectrum_bypass"), n=4)
    assert all(isinstance(r, RuntimeError) and "stub nvcc: error" in str(r) for r in results)
    assert count.read_text().count("run") == 4  # each tried under the lock, none fell back
    assert not list((tmp_path / "build").iterdir())  # no library, no temporary


def test_kernel_lib_loads_once_under_concurrent_first_use(monkeypatch):
    from tpu_sdr_torch.kernels.cuda import launch, loader

    loads = []

    def fake_load(name):
        loads.append(name)
        fn = types.SimpleNamespace(argtypes=None, restype=None)
        return types.SimpleNamespace(**{f"tpu_sdr_{name}": fn, "tpu_sdr_cuda_error_string": fn})

    monkeypatch.setattr(loader, "load", fake_load)
    monkeypatch.setattr(launch, "_libs", {})
    results = _in_threads(lambda: launch._kernel_lib("viterbi"))
    assert loads == ["viterbi"]
    assert all(r is results[0] for r in results)
