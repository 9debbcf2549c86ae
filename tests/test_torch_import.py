"""The port imports neither jax nor the JAX package: every module of
lightgbm_tpu_torch, and chip_smoke.py, import in a process where jax is
blocked, and no lightgbm_tpu module gets loaded."""
import pkgutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

_PROBE = """
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any `import jax` now raises
sys.path.insert(0, {root!r})
import lightgbm_tpu_torch
names = ["lightgbm_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(lightgbm_tpu_torch.__path__,
                                          "lightgbm_tpu_torch.")]
for n in names:
    importlib.import_module(n)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "lightgbm_tpu" or m.startswith("lightgbm_tpu."))
print(len(names), bad)
"""


def test_port_imports_without_jax():
    out = subprocess.run([sys.executable, "-c", _PROBE.format(root=str(ROOT))],
                         capture_output=True, text=True, timeout=120,
                         cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    count, bad = out.stdout.strip().rsplit("\n", 1)[-1].split(" ", 1)
    assert bad == "[]"
    import lightgbm_tpu_torch
    expected = 1 + sum(1 for _ in pkgutil.walk_packages(
        lightgbm_tpu_torch.__path__, "lightgbm_tpu_torch."))
    assert int(count) == expected >= 20


def test_no_jax_in_port_sources():
    """No source line of the port, its tools (``lightgbm_tpu_torch/
    tools/*.py``) included, names jax or the JAX package as a module to
    import."""
    paths = list((ROOT / "lightgbm_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]
    tools = set((ROOT / "lightgbm_tpu_torch" / "tools").glob("*.py"))
    assert len(tools) >= 10 and tools <= set(paths)
    for path in paths:
        for line in path.read_text().splitlines():
            s = line.strip()
            if s.startswith(("import ", "from ")):
                mod = s.split()[1]
                assert not mod.startswith(("jax", "lightgbm_tpu.")) \
                    and mod != "lightgbm_tpu", f"{path}: {s}"


def test_exports_match_the_jax_package():
    """The package exports the JAX package's public names (the v2.3.2
    API, the estimators and the plots), and its obs/ and serve/quality
    modules are part of the walk above."""
    import importlib.util

    import lightgbm_tpu_torch as lt
    names = set(lt.__all__)
    assert {"Dataset", "Booster", "Config", "train", "cv", "LightGBMError",
            "early_stopping", "print_evaluation", "record_evaluation",
            "reset_parameter", "LGBMModel", "LGBMRegressor",
            "LGBMClassifier", "LGBMRanker", "plot_importance",
            "plot_metric", "plot_tree", "create_tree_digraph",
            "plot_split_value_histogram"} <= names
    for mod in ("sklearn", "plotting", "compat", "obs", "obs.core",
                "obs.trace", "obs.spans", "obs.memory", "obs.profile",
                "obs.health", "obs.drift", "serve.quality", "obs.board",
                "obs.ranks", "obs.report", "obs.xprof", "capi",
                "capi_embed"):
        assert importlib.util.find_spec("lightgbm_tpu_torch." + mod), mod


def test_the_parallel_and_store_modules_are_walked():
    """The modules of the parallel learners and the serving store are in
    the no-jax walk above and import no distributed backend at import."""
    import lightgbm_tpu_torch
    names = {m.name for m in pkgutil.walk_packages(
        lightgbm_tpu_torch.__path__, "lightgbm_tpu_torch.")}
    assert {"lightgbm_tpu_torch.parallel",
            "lightgbm_tpu_torch.parallel.distributed",
            "lightgbm_tpu_torch.parallel.mesh",
            "lightgbm_tpu_torch.parallel.rank_shard",
            "lightgbm_tpu_torch.serve.aot",
            "lightgbm_tpu_torch.utils.compile_cache"} <= names
    # the multi-rank worker (a script of tools/, outside the walk) too
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys; sys.modules['jax'] = None; sys.path.insert(0, %r); "
         "import lightgbm_tpu_torch.parallel, lightgbm_tpu_torch.serve.aot;"
         " import lightgbm_tpu_torch.tools.dist_check;"
         " import torch.distributed as d; print(d.is_initialized())"
         % str(ROOT)], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("False")


def test_every_module_of_the_jax_package_has_a_counterpart():
    """The port mirrors the JAX package's module tree: every source file
    there has one at the same path here, but the Pallas kernels'
    ``ops/pallas_hist.py``, answered by the CUDA kernels' wrappers
    ``ops/hist_wave.py`` (K1) and ``ops/hist_channels.py`` (K2)."""
    def sources(pkg):
        root = ROOT / pkg
        return {p.relative_to(root).as_posix() for ext in ("py", "c", "cpp")
                for p in root.rglob(f"*.{ext}")}
    missing = sources("lightgbm_tpu") - sources("lightgbm_tpu_torch")
    assert missing == {"ops/pallas_hist.py"}
    assert {"ops/hist_wave.py", "ops/hist_channels.py", "capi.py",
            "capi_embed.py", "native/capi_abi.c", "obs/board.py",
            "obs/ranks.py", "obs/report.py",
            "obs/xprof.py"} <= sources("lightgbm_tpu_torch")


_TOOLS_PROBE = """
import importlib, sys
from pathlib import Path
sys.modules["jax"] = None          # any `import jax` now raises
sys.path.insert(0, {root!r})
names = sorted(p.stem for p in Path({root!r}, "lightgbm_tpu_torch",
                                    "tools").glob("*.py"))
for n in names:
    importlib.import_module("lightgbm_tpu_torch.tools." + n)
bad = sorted(m for m in sys.modules
             if m == "lightgbm_tpu" or m.startswith("lightgbm_tpu."))
print(len(names), bad)
"""


def test_port_tools_import_without_jax():
    """Every module of ``lightgbm_tpu_torch/tools/`` (outside the package
    walk above) imports where jax is blocked and loads nothing of the JAX
    package."""
    out = subprocess.run(
        [sys.executable, "-c", _TOOLS_PROBE.format(root=str(ROOT))],
        capture_output=True, text=True, timeout=120, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    count, bad = out.stdout.strip().rsplit("\n", 1)[-1].split(" ", 1)
    assert bad == "[]" and int(count) >= 10


def test_every_jax_tool_has_a_twin_or_a_reason():
    """Each ``tools/*.py`` that imports the JAX package has a twin of the
    same file name under ``lightgbm_tpu_torch/tools/``, or a row with a
    reason in ``run_suite.NO_TWIN``; no tool has both, and every row names
    a tool that exists."""
    import ast

    from lightgbm_tpu_torch.tools.run_suite import NO_TWIN

    def imports_jax_package(path):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            if any(m == "lightgbm_tpu" or m.startswith("lightgbm_tpu.")
                   for m in mods):
                return True
        return False

    jax_tools = {p.name for p in (ROOT / "tools").glob("*.py")
                 if imports_jax_package(p)}
    twins = {p.name for p in (ROOT / "lightgbm_tpu_torch" / "tools")
             .glob("*.py")}
    assert jax_tools, "no tool of tools/ imports the JAX package?"
    for name in sorted(jax_tools):
        assert (name in twins) != (name in NO_TWIN), name
    assert set(NO_TWIN) <= {p.name for p in (ROOT / "tools").glob("*.py")}
    assert all(len(why) > 20 for why in NO_TWIN.values())
    assert {"fault_matrix.py", "chaos_serve.py", "online_smoke.py",
            "arena_smoke.py", "drift_report.py", "ingest_bench.py",
            "fleet_smoke.py", "board_smoke.py", "xprof_smoke.py",
            "run_suite.py"} <= twins
