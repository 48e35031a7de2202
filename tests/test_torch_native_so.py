"""``SSN_NATIVE_SO`` in the port's native loader, with the JAX loader's
meaning: set, it names the library to load, and nothing is built or hashed;
a missing file is an error naming the path; unset, the default hashed build
under ``swiftsnails_tpu_torch/build/`` loads again."""

import subprocess

import numpy as np
import pytest

from swiftsnails_tpu_torch.data import native


def _loaded() -> str:
    assert native.available(), native.build_error()
    return native._lib._name


@pytest.fixture
def copy_so(tmp_path):
    """The port's ``libsnails.cpp`` built into ``tmp_path`` (``-O0``, the
    loader's other flags)."""
    out = tmp_path / "libsnails-copy.so"
    flags = [f for f in native.GXX_FLAGS if not f.startswith("-O")]
    subprocess.run(["g++", "-O0", *flags, "-o", str(out), str(native._SRC)],
                   check=True, capture_output=True, timeout=300)
    return out


def test_the_named_build_is_the_one_loaded(monkeypatch, copy_so):
    monkeypatch.delenv(native.ENV_SO, raising=False)
    default = _loaded()
    assert default == str(native.library_path())
    x = np.arange(1, 1000, 7, dtype=np.int64)
    want = native.murmur64(x)

    def no_build(lib):
        raise AssertionError("SSN_NATIVE_SO set: nothing is built")

    monkeypatch.setattr(native, "_build", no_build)
    monkeypatch.setenv(native.ENV_SO, str(copy_so))
    assert _loaded() == str(copy_so)
    with open("/proc/self/maps") as f:
        assert str(copy_so) in f.read()
    np.testing.assert_array_equal(native.murmur64(x), want)
    monkeypatch.undo()  # unset: the default build again
    assert _loaded() == default


def test_a_missing_build_raises_naming_the_path(monkeypatch, tmp_path):
    missing = tmp_path / "no-such-libsnails.so"
    monkeypatch.setenv(native.ENV_SO, str(missing))
    assert not native.available()
    assert native.build_error() == f"SSN_NATIVE_SO not found: {missing}"
    with pytest.raises(RuntimeError, match=f"SSN_NATIVE_SO not found: {missing}"):
        native.require()
    monkeypatch.delenv(native.ENV_SO)
    assert native.available() and native.build_error() is None
