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
    """No source line of the port names jax or the JAX package as a module
    to import."""
    for path in list((ROOT / "lightgbm_tpu_torch").rglob("*.py")) + [
            ROOT / "chip_smoke.py"]:
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
