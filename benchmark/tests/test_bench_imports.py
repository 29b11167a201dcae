"""Nothing the benchmark's reference runs imports the program, JAX or the
JAX package; the run's own check compares top-level names whole."""
import ast
import subprocess
import sys
from pathlib import Path

from benchmark import harness

BENCH = Path(harness.__file__).resolve().parent


def test_bench_forbidden_names_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "tpubwa_torch_like", sys)
    assert "tpubwa" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "tpubwa.pipeline", sys)
    assert "tpubwa" in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib", sys)
    assert {"tpubwa", "jaxlib"} <= set(harness.forbidden_modules())


def _imports(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_bench_reference_sources_import_no_program():
    for f in sorted((BENCH / "refbwa").glob("*.py")):
        assert _imports(f) <= {"__future__", "bisect", "math", "numpy"}, f


def test_bench_reference_process_loads_no_program():
    code = ("import sys; sys.path.insert(0, %r); "
            "import benchmark.check, benchmark.refbwa.pe; "
            "tops = {m.split('.')[0] for m in sys.modules}; "
            "print(sorted(tops & {'tpubwa_torch', 'tpubwa', 'jax', 'torch'}))"
            % str(BENCH.parent))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout.strip()
    assert out == "[]"


def test_bench_harness_sources_import_no_jax():
    for f in sorted(BENCH.rglob("*.py")):
        if "tests" in f.parts:
            continue
        assert not (_imports(f) & {"jax", "jaxlib", "flax", "tpubwa"}), f
