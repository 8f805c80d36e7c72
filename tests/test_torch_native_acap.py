"""The port's host-side deformation-gradient extractor (`edit/native_acap.py`
over `csrc/acap.cpp`) against the port's `deformation_gradients`, a float64
oracle and the JAX package's `NativeACAP`, on the CPU."""

import os
import subprocess

import numpy as np
import pytest
import torch

from gaussianmesh_tpu.edit import native_acap as jnative
from gaussianmesh_tpu_torch.edit import deform, native_acap
from gaussianmesh_tpu_torch.io import mesh as mesh_io
from gaussianmesh_tpu_torch.ops import _cuda
from tests.meshes import icosphere
from tests.test_torch_edit import _oracle_rs, _rot, deformed

torch.set_num_threads(2)

KINDS = ["rigid", "scale", "twist", "noise"]


@pytest.mark.parametrize("level", [1, 2, 3])
@pytest.mark.parametrize("kind", KINDS)
def test_get_rs_matches_deformation_gradients(level, kind):
    """Against the port's float32 path within 1e-4 (levels 1-3: its rounding
    stays far below that) and against the same path in float64 within the
    float32 rounding of the extractor's output."""
    v, f = icosphere(level)
    v_def = deformed(v, kind, seed=level)
    r, s = native_acap.NativeACAP((v, f)).get_rs(v_def, n_threads=2)
    assert r.dtype == s.dtype == np.float32 and r.shape == s.shape == (len(v), 3, 3)
    d = deform.MeshDeformer(v, f, device="cpu")
    r32, s32 = d.get_rs(v_def)
    np.testing.assert_allclose(r, r32.numpy(), atol=1e-4)
    np.testing.assert_allclose(s, s32.numpy(), atol=1e-4)
    r64, s64 = deform.deformation_gradients(d.v_ref.double(),
                                            torch.tensor(v_def).double(),
                                            d.neighbors, d.mask)
    np.testing.assert_allclose(r, r64.numpy(), atol=1e-6)
    np.testing.assert_allclose(s, s64.numpy(), atol=1e-6)


@pytest.mark.parametrize("kind", ["rigid", "scale"])
def test_level6_matches_float64_oracle(kind):
    """At icosphere level 6, where the JAX package's guards return R = S = I
    (fault B4), the normalised rings match a float64 least-squares + SVD
    oracle: R to its rounding, S to the ring's 1e-8 regularisation."""
    v, f = icosphere(6)
    v_def = deformed(v, kind)
    nat = native_acap.NativeACAP((v, f))
    r, s = nat.get_rs(v_def, n_threads=2)
    ro, so = _oracle_rs(v, v_def, nat.neighbors, nat.mask.astype(bool))
    assert np.abs(r - ro).max() <= 1e-5
    assert np.abs(s - so).max() <= 1e-4
    if kind == "rigid":
        q = _rot([0.3, 1.0, 0.2], 0.7)
        assert np.abs(r - q).max() <= 2e-3   # the f32 frame's own rounding
        # the same motion applied in float64: R is Q
        r64, _ = nat.get_rs(v.astype(np.float64) @ q.T + [0.5, -0.2, 0.1], 2)
        assert np.abs(r64 - q).max() <= 1e-6


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    """The JAX package's extractor, its `native/acap.cpp` built here into a
    temporary library (`native/build.sh`'s flags without -march=native), so
    no test races another over `native/lib/`."""
    lib = tmp_path_factory.mktemp("jax_native") / "libgmacap.so"
    src = os.path.join(jnative._NATIVE_DIR, "acap.cpp")
    proc = subprocess.run(["g++", "-O3", "-fopenmp", "-shared", "-fPIC", src, "-o",
                           str(lib)], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    kept = jnative._LIB_PATH, jnative._lib
    jnative._LIB_PATH, jnative._lib = str(lib), None
    yield jnative
    jnative._LIB_PATH, jnative._lib = kept


@pytest.mark.parametrize("kind", KINDS)
def test_level1_matches_jax_native(jax_native, kind):
    """At level 1 the JAX extractor's absolute guards do not trip: both
    extractors agree to rounding."""
    v, f = icosphere(1)
    v_def = deformed(v, kind, seed=1)
    r, s = native_acap.NativeACAP((v, f)).get_rs(v_def, 2)
    jr, js = jax_native.NativeACAP((v, f)).get_rs(v_def, 2)
    np.testing.assert_allclose(r, jr, atol=1e-4)
    np.testing.assert_allclose(s, js, atol=1e-4)


def test_get_rs_reference_signature(tmp_path):
    """GetRS(V_ref, V_def, 1, nthreads) -> (V, 9) twice, equal to get_rs; a
    mesh path constructs as a (vertices, triangles) pair does."""
    v, f = icosphere(2)
    path = str(tmp_path / "ref.obj")
    mesh_io.write_triangle_mesh(path, v, f)
    v_def = deformed(v, "twist")
    nat = native_acap.NativeACAP(path)
    r9, s9 = nat.GetRS(v, v_def, 1, 2)
    assert r9.shape == s9.shape == (len(v), 9)
    r, s = native_acap.NativeACAP((v, f)).get_rs(v_def, 3)
    np.testing.assert_array_equal(r9, r.reshape(-1, 9))
    np.testing.assert_array_equal(s9, s.reshape(-1, 9))
    assert native_acap.native_available()
    with pytest.raises(ValueError, match="vertices"):
        nat.get_rs(v_def[:-1])
    with pytest.raises(FileNotFoundError):
        native_acap.NativeACAP(str(tmp_path / "missing.obj"))


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    """A source g++ cannot compile raises its output; no fallback."""
    (tmp_path / "acap.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(_cuda, "CSRC", tmp_path)
    monkeypatch.setattr(_cuda, "BUILD_DIR", tmp_path / "_build")
    _cuda.host_library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+ failed for acap"):
            _cuda.host_library("acap")
        assert not native_acap.native_available()
        monkeypatch.setattr(_cuda.shutil, "which", lambda _: None)
        with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
            _cuda.host_library("acap")
    finally:
        _cuda.host_library.cache_clear()
