"""The port imports without jax, flax, optax, orbax, pandas or sklearn: the
machine with the GPU has none of them."""
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANNED = ("jax", "jaxlib", "flax", "optax", "orbax", "pandas", "sklearn")

SCRIPT = f"""
import sys
for name in {BANNED!r}:
    sys.modules[name] = None  # any import of these now raises ImportError
import tpu_breath_torch
import tpu_breath_torch.features
import tpu_breath_torch.ensemble
import tpu_breath_torch.cli
import tpu_breath_torch.ops.cuda.tuning_kernel
import tpu_breath_torch.ops.cuda.epilogue_kernel
import tpu_breath_torch.ops.cuda.peaks_kernel
import tpu_breath_torch.models.convert
import tpu_breath_torch.train.checkpoint
loaded = [m for m in sys.modules if m.split('.')[0] in {BANNED!r}
          and sys.modules[m] is not None]
assert not loaded, loaded
print("ok")
"""


def test_port_imports_without_jax():
    res = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": ROOT},
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


def test_no_banned_import_lines_in_port_sources():
    pat = re.compile(r"^\s*(import|from) (" + "|".join(BANNED) + r")\b")
    bad = []
    for dirpath, dirs, files in os.walk(os.path.join(ROOT,
                                                     "tpu_breath_torch")):
        dirs[:] = [d for d in dirs if d != "_build"]  # build outputs
        for name in files:
            if name.endswith(".py"):
                path = os.path.join(dirpath, name)
                with open(path) as f:
                    bad += [f"{path}:{i}" for i, line in enumerate(f, 1)
                            if pat.match(line)]
    # chip_smoke.py imports neither JAX nor the JAX package, only the port
    smoke = re.compile(r"^\s*(import|from) (" + "|".join(BANNED)
                       + r"|tpu_breath)\b(?!_torch)")
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        bad += [f"chip_smoke.py:{i}" for i, line in enumerate(f, 1)
                if smoke.match(line)]
    assert not bad, bad


def test_kernel_modules_import_nothing_gpu_only_at_import_time():
    """Importing the wrappers builds nothing: the nvcc build happens at the
    first launch on a CUDA tensor."""
    script = ("import tpu_breath_torch.ops.cuda._build as b\n"
              "import tpu_breath_torch.ops.cuda.tuning_kernel\n"
              "assert b.lib.cache_info().currsize == 0\nprint('ok')\n")
    res = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": ROOT},
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr
