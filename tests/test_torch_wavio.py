"""The port's threaded C++ wav decoder (csrc/wavio.cpp, built and bound by
tpu_breath_torch/data/wav.py) against the JAX package's native decoder
(native/libwavio.so, built by tests/conftest.py) and against the port's
plain numpy version, on the format cases of chip_smoke.py's decode phase."""
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke
from tpu_breath.data import wav as jx_wav
from tpu_breath_torch.data import wav
from tpu_breath_torch.ops.cuda import _build

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = chip_smoke.DECODE_CASES
# tests/test_wav_edge_cases.py's bound between the JAX package's decoders
RESAMPLED_TOL = 2e-6


@pytest.fixture(scope="module")
def decode_set(tmp_path_factory):
    """({case name: path}, [a file that is not RIFF, a missing path])."""
    return chip_smoke.write_decode_set(str(tmp_path_factory.mktemp("wavs")))


def _jax_native():
    """The JAX package's native decoder; fails where a compiler exists but
    tests/conftest.py did not build it."""
    if jx_wav._native_lib() is None:
        if shutil.which("g++"):
            pytest.fail("the JAX package's native decoder is unavailable "
                        "despite a toolchain")
        pytest.skip("no C++ toolchain: the JAX package decodes in numpy")


@pytest.mark.parametrize("name", list(CASES))
def test_native_equals_jax_native(decode_set, name):
    """One good file of each format: the port's samples are the JAX
    package's native decoder's, bit for bit (same source, same flags)."""
    _jax_native()
    path = decode_set[0][name]
    got = wav.load_wav_batch([path])
    np.testing.assert_array_equal(got, jx_wav.load_wav_batch([path]))
    assert got.shape == (1, 16000) and got.any()


def test_native_equals_plain_version(decode_set):
    """Every good file in one batch against the numpy loop: bit for bit at
    16 kHz, within 2e-6 where the clip is resampled."""
    good = decode_set[0]
    got = wav.load_wav_batch(list(good.values()))
    for (name, case), row in zip(CASES.items(), got):
        want = wav.load_wav(good[name])
        if case.rate == wav.TARGET_SR:
            np.testing.assert_array_equal(row, want, err_msg=name)
        else:
            np.testing.assert_allclose(row, want, rtol=0,
                                       atol=RESAMPLED_TOL, err_msg=name)


def test_failure_rule_equals_jax(decode_set):
    """A resampled good file, a file that is not RIFF and a missing path:
    the array and `errors` are the JAX package's; without `errors` both
    raise the same exception type."""
    good, bad = decode_set
    batch = [good["f32_44k_list"], bad[0], good["pcm16_short"], bad[1]]
    errs, jx_errs = [], []
    got = wav.load_wav_batch(batch, errors=errs)
    np.testing.assert_array_equal(
        got, jx_wav.load_wav_batch(batch, errors=jx_errs))
    assert errs == jx_errs and [p for p, _ in errs] == bad
    assert not got[1].any() and not got[3].any() and got[0].any()
    with pytest.raises(Exception) as jx_raised:
        jx_wav.load_wav_batch(batch)
    with pytest.raises(jx_raised.type):
        wav.load_wav_batch(batch)


def test_threads_give_the_same_samples(decode_set):
    """n_threads 1, 3, 0 (all cores) and 64 (more than the files) give the
    same array; an empty batch has shape (0, 16000)."""
    paths = list(decode_set[0].values())
    ref = wav.load_wav_batch(paths, n_threads=1)
    for n in (3, 0, 64):
        np.testing.assert_array_equal(
            wav.load_wav_batch(paths, n_threads=n), ref)
    assert wav.load_wav_batch([]).shape == (0, 16000)


SUBPROCESS = """
import sys
sys.modules["tpu_breath"] = None  # the JAX package cannot be imported
from tpu_breath_torch.data import wav
x = wav.load_wav_batch([sys.argv[1]])
assert x.shape == (1, 16000) and x.any()
with open("/proc/self/maps") as f:
    maps = f.read()
print("native/libwavio.so" in maps, wav.library_path() in maps)
"""


def test_decoder_is_the_ports_own_library(decode_set, monkeypatch):
    """The loaded library is the port's build under tpu_breath_torch/_build/,
    named by the source's hash; a second build call compiles nothing; a
    process decoding through the port maps no native/libwavio.so; the
    kernels' nvcc build does not take the .cpp."""
    path = wav._native_lib()._name
    assert path == wav.library_path()
    assert os.path.dirname(path) == os.path.join(ROOT, "tpu_breath_torch",
                                                 "_build")
    assert os.path.basename(path).startswith("libtpu_breath_wavio_")

    def no_compile(*args, **kwargs):
        raise AssertionError(f"rebuilt: {args}")

    monkeypatch.setattr(wav.subprocess, "run", no_compile)
    assert wav.build() == {"path": path, "seconds": 0.0}
    assert wav._native_lib() is wav._native_lib()
    monkeypatch.undo()

    res = subprocess.run([sys.executable, "-c", SUBPROCESS,
                          decode_set[0]["pcm16_8k"]], cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": ROOT},
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["False", "True"]
    assert wav.WAVIO_SRC not in _build._sources()


@pytest.fixture
def fresh_build(tmp_path, monkeypatch):
    """The decoder's build directory moved to an empty tmp_path and the
    loaded library forgotten (restored after the test)."""
    monkeypatch.setattr(wav, "BUILD_DIR", str(tmp_path))
    wav._native_lib.cache_clear()
    yield tmp_path
    wav._native_lib.cache_clear()


def test_missing_compiler_raises(fresh_build, decode_set, monkeypatch):
    """No compiler: load_wav_batch raises RuntimeError naming the source;
    nothing decodes in numpy in its place."""
    monkeypatch.setattr(wav, "compiler", lambda: None)
    with pytest.raises(RuntimeError, match="wavio.cpp"):
        wav.load_wav_batch([decode_set[0]["pcm16_short"]])
    assert os.listdir(fresh_build) == []


def test_failed_build_raises(fresh_build, decode_set, monkeypatch):
    """A source that does not compile: RuntimeError with the compiler's
    message, and no library (nor temporary file) left behind."""
    broken = fresh_build / "wavio.cpp"
    broken.write_text("int decode_wav_batch( {\n")
    monkeypatch.setattr(wav, "WAVIO_SRC", str(broken))
    with pytest.raises(RuntimeError, match="failed"):
        wav.load_wav_batch([decode_set[0]["pcm16_short"]])
    assert os.listdir(fresh_build) == ["wavio.cpp"]
