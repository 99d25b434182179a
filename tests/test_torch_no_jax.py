"""The port imports nothing of the JAX package (tpu_breath) and imports
without jax, flax, optax, orbax, pandas or sklearn: the machine with the GPU
has none of them, and the port keeps its own copies of what it needs."""
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANNED = ("jax", "jaxlib", "flax", "optax", "orbax", "pandas", "sklearn",
          "tpu_breath")

SCRIPT = f"""
import importlib
import pkgutil
import sys
for name in {BANNED!r}:
    sys.modules[name] = None  # any import of these now raises ImportError
import tpu_breath_torch
names = [m.name for m in pkgutil.walk_packages(tpu_breath_torch.__path__,
                                               "tpu_breath_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
loaded = [m for m in sys.modules if m.split('.')[0] in {BANNED!r}
          and sys.modules[m] is not None]
assert not loaded, loaded
print(len(names))
"""

# every module of the port, so a new one cannot slip past the import check
MODULES = {
    "augment", "cli", "config", "device", "ensemble", "features",
    "graphs", "__main__", "baseline", "baseline.dsp_np", "baseline.feature_np",
    "data", "data.dataset",
    "data.wav", "models", "models.ast_base", "models.cnn8", "models.convert",
    "models.layers",
    "models.registry", "models.vgg", "ops", "ops.cepstral", "ops.chroma",
    "ops.cqt", "ops.cuda", "ops.cuda._build", "ops.cuda.cqt_kernel",
    "ops.cuda.epilogue_kernel",
    "ops.cuda.gammatone_kernel", "ops.cuda.lpc_kernel",
    "ops.cuda.peaks_kernel", "ops.cuda.tuning_kernel", "ops.cuda.work",
    "ops.dft", "ops.lpc", "ops.peaks",
    "ops.rhythm", "ops.scalars", "ops.select", "ops.spectral",
    "parallel", "parallel.mesh", "data.loader", "train",
    "train.checkpoint", "train.loop", "train.metrics", "train.schedule",
    "utils", "utils.kernel_times", "utils.parity_sweep", "utils.profiling",
    "utils.feature_roofline", "utils.seed_sweep", "utils.ensemble_val",
    "utils.deviation_sweep", "utils.flip_hunt", "utils.sdpa_times",
}


def test_port_imports_without_jax_or_the_jax_package():
    """Every module of the port (and chip_smoke.py) imports with jax, the
    JAX package and the other banned packages made unimportable."""
    res = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": ROOT},
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) == len(MODULES)


def test_no_banned_import_lines_in_port_sources():
    """No import line of the port or of chip_smoke.py names a banned
    package, the JAX package (`tpu_breath`, bare) included."""
    pat = re.compile(r"^\s*(import|from) (" + "|".join(BANNED) + r")\b")
    bad, found = [], set()
    pkg = os.path.join(ROOT, "tpu_breath_torch")
    for dirpath, dirs, files in os.walk(pkg):
        dirs[:] = [d for d in dirs if d not in ("_build", "__pycache__")]
        for name in files:
            if name.endswith(".py"):
                path = os.path.join(dirpath, name)
                rel = os.path.relpath(path, pkg)[:-3].replace(os.sep, ".")
                found.add(rel[:-len(".__init__")] if rel.endswith(
                    "__init__") else rel)
                with open(path) as f:
                    bad += [f"{path}:{i}" for i, line in enumerate(f, 1)
                            if pat.match(line)]
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        bad += [f"chip_smoke.py:{i}" for i, line in enumerate(f, 1)
                if pat.match(line)]
    assert not bad, bad
    assert found - {""} == MODULES  # "" is the package's own __init__


def test_kernel_modules_import_nothing_gpu_only_at_import_time():
    """Importing the wrappers builds nothing: the nvcc build happens at the
    first launch on a CUDA tensor."""
    script = ("import tpu_breath_torch.ops.cuda._build as b\n"
              "import tpu_breath_torch.ops.cuda.tuning_kernel\n"
              "import tpu_breath_torch.ops.cuda.gammatone_kernel\n"
              "import tpu_breath_torch.ops.cuda.cqt_kernel\n"
              "import tpu_breath_torch.utils.profiling\n"
              "import tpu_breath_torch.features\n"
              "assert b.lib.cache_info().currsize == 0\nprint('ok')\n")
    res = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": ROOT},
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr
