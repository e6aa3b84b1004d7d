"""No JAX in the benchmark's runs, and nothing of the program in its
reference."""

import ast
import os
import subprocess
import sys
import types

import pytest

from lidarbench import harness
from lidarbench.spec import HERE, ROOT


def _loaded_after(code: str) -> set:
    r = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                        "print(' '.join(sorted(sys.modules)))"],
                       cwd=ROOT, capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, USE_FLAX="0"))
    assert r.returncode == 0, r.stderr
    return set(r.stdout.split())


def test_a_run_loads_no_jax():
    mods = _loaded_after(
        "import lidarbench.run, lidarbench.harness, lidarbench.calibrate\n"
        "from lidar_processing_tpu_torch.runtime.stream import ReplayStream\n"
        "from lidar_processing_tpu_torch.runtime import compiled, pipeline\n"
        "from lidar_processing_tpu_torch.ops import hull_native\n"
        "from lidarbench.spec import Spec\n"
        "spec = Spec()\n"
        "[spec.reader(m['name']) for m in spec.bench['per_layer']]\n"
        "import torch.profiler")
    assert "lidar_processing_tpu_torch" in mods
    assert not {m.split(".")[0] for m in mods} & set(harness.FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    mods = _loaded_after("import lidarbench.check\n"
                         "from lidarbench.reference import gpf, radius_cc, chi_shape,"
                         " geometry")
    tops = {m.split(".")[0] for m in mods}
    assert not tops & {"lidar_processing_tpu_torch", "lidar_processing_tpu",
                       "jax"}


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_source_of_the_benchmark_imports_jax():
    for dirpath, _, files in os.walk(HERE):
        if os.path.basename(dirpath) == "tests":
            continue
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(dirpath, f)
                tops = {m.split(".")[0] for m in _imports(path)}
                assert not tops & set(harness.FORBIDDEN), path
                if ("reference" in dirpath or f == "check.py"):
                    assert "lidar_processing_tpu_torch" not in tops, path


def test_forbidden_names_compare_whole(monkeypatch):
    for name in list(sys.modules):
        if name.split(".")[0] in harness.FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "jaxtyping", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "lidar_processing_tpu_torch_x",
                        types.ModuleType("x"))
    assert harness.forbidden_modules() == []
    harness.assert_no_jax("here")
    monkeypatch.setitem(sys.modules, "lidar_processing_tpu.ops",
                        types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("x"))
    assert harness.forbidden_modules() == ["jax", "lidar_processing_tpu"]
    with pytest.raises(harness.ForbiddenImport):
        harness.assert_no_jax("here")


def test_jax_loaded_by_a_metric_reader_stops_the_result(tmp_path, monkeypatch,
                                                        capsys):
    # a reader runs after the window and the check: the gate before the
    # result line still sees what it loads
    from lidarbench import run
    from lidarbench.spec import Spec
    for name in list(sys.modules):
        if name.split(".")[0] in harness.FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    metrics = tmp_path / "lidarbench" / "metrics"
    metrics.mkdir(parents=True)
    (metrics / "probe.replay.py").write_text(
        "import sys\nimport types\n\n\ndef read(ctx):\n"
        "    sys.modules['jax'] = types.ModuleType('jax')\n    return 1.0\n")
    spec = Spec(ROOT, str(tmp_path / "lidarbench"))
    res = harness.Result({"correct": True}, ["check x 0 limit 0 ok"], {})
    try:
        assert spec.reader("probe.replay")(harness.Context([], None)) == 1.0
        assert run.emit(res) == 3
    finally:
        sys.modules.pop("jax", None)
    out = capsys.readouterr()
    assert out.out == "" and "jax" in out.err
    assert run.emit(res) == 0
    assert capsys.readouterr().out.strip() == '{"correct": true}'
