"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level names (the port's name begins with the JAX package's); the
reference imports nothing of the port."""
import ast
import subprocess
import sys
from pathlib import Path

from gbdt_bench.harness import FORBIDDEN, ROOT

BENCH = ROOT / "gbdt_bench"
PORT = "lightgbm_tpu_torch"


def imported(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def sources(folder: Path):
    return [p for p in folder.rglob("*.py") if "tests" not in p.parts]


def test_whole_top_level_names():
    assert "lightgbm_tpu" in FORBIDDEN and PORT not in FORBIDDEN
    assert PORT.split(".")[0] != "lightgbm_tpu"


def test_harness_imports_no_jax():
    for path in sources(BENCH):
        bad = imported(path) & set(FORBIDDEN)
        assert not bad, (path, bad)


def test_reference_imports_nothing_of_the_port():
    for path in sources(BENCH / "reference"):
        names = imported(path)
        assert PORT not in names and not names & set(FORBIDDEN), (path,
                                                                  names)


def test_a_run_loads_no_jax_and_the_reference_no_port():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from gbdt_bench.reference import check, walk, model_text\n"
        "from gbdt_bench.reference.objectives import binary, lambdarank\n"
        "assert not any(m.split('.')[0] == %r for m in sys.modules), 'port'\n"
        "from gbdt_bench.harness import run_cell, forbidden_modules\n"
        "run_cell('higgs.train', 5, 0.2, True, device='cpu', rows=3000)\n"
        "print('FORBIDDEN', forbidden_modules())\n") % (str(ROOT), PORT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FORBIDDEN []" in out.stdout
