"""Host-side deformation gradients through the port's C++ extractor (port of
`gaussianmesh_tpu/edit/native_acap.py`).

`NativeACAP(mesh_or_path)` keeps the reference's `pyACAP.pyACAP(mesh_path)`
/ `GetRS(V_ref, V_def, 1, nthreads)` contract (edittool/__init__.py:102,
109-113) over `csrc/acap.cpp` (C++ and OpenMP, float64), which
`ops/_cuda.py::host_library` builds with g++ at first use. It serves
host-side pipelines (mesh tooling); playback on the card uses
`edit/deform.py`. Both normalise each ring by its RMS reference edge length
(fault B4's repair, see `edit/deform.py`), so the extractor returns
`deformation_gradients`' results, run in float64, to rounding.

Where the JAX module falls back to its JAX implementation when no compiler
is found, this one raises: a missing g++ or a failed build is an error, with
the compiler's output.
"""

from __future__ import annotations

import numpy as np

from gaussianmesh_tpu_torch.edit.deform import MAX_DEGREE, build_one_ring
from gaussianmesh_tpu_torch.ops import _cuda


def _library():
    return _cuda.host_library("acap")


def native_available() -> bool:
    """True when the extractor builds and loads here (False on a failed
    build; `NativeACAP` raises the build's error instead)."""
    try:
        _library()
    except (RuntimeError, OSError):
        return False
    return True


def _vertices(v, n: int | None = None) -> np.ndarray:
    v = np.ascontiguousarray(np.asarray(v, np.float64))
    if v.ndim != 2 or v.shape[1] != 3 or (n is not None and v.shape[0] != n):
        want = "(V, 3)" if n is None else f"({n}, 3)"
        raise ValueError(f"vertices must be {want}, got {v.shape}")
    return v


class NativeACAP:
    """pyACAP's counterpart: built from the reference mesh (an OBJ / PLY path
    or a (vertices, triangles) pair), then `get_rs` per deformed frame."""

    def __init__(self, mesh_or_path, max_degree: int = MAX_DEGREE):
        if isinstance(mesh_or_path, str):
            from gaussianmesh_tpu_torch.io import mesh as mesh_io
            v, f = mesh_io.read_triangle_mesh(mesh_or_path)
        else:
            v, f = mesh_or_path
        self.v_ref = _vertices(v)
        self.triangles = np.asarray(f, np.int32)
        neighbors, mask = build_one_ring(self.triangles, self.v_ref.shape[0],
                                         max_degree)
        self.neighbors = np.ascontiguousarray(neighbors, np.int32)
        self.mask = np.ascontiguousarray(mask, np.uint8)
        self._lib = _library()

    def get_rs(self, v_def, n_threads: int = 0) -> tuple[np.ndarray, np.ndarray]:
        """Deformed vertices (V, 3) -> (R (V, 3, 3), S (V, 3, 3)) float32.
        `n_threads` <= 0 uses every core."""
        n = self.v_ref.shape[0]
        v_def = _vertices(v_def, n)
        r = np.empty((n, 9), np.float32)
        s = np.empty((n, 9), np.float32)
        self._lib.gm_acap_get_rs(
            self.v_ref.ctypes.data, v_def.ctypes.data, n,
            self.neighbors.ctypes.data, self.mask.ctypes.data,
            self.neighbors.shape[1], r.ctypes.data, s.ctypes.data, int(n_threads))
        return r.reshape(n, 3, 3), s.reshape(n, 3, 3)

    def GetRS(self, v_ref, v_def, _one: int = 1, nthreads: int = 0
              ) -> tuple[np.ndarray, np.ndarray]:
        """The reference's call, GetRS(V_ref, V_def, 1, nthreads) -> (R, S),
        each (V, 9) row-major. The reference mesh is the constructor's
        (`v_ref` is taken for the signature, as pyACAP's callers pass it)."""
        r, s = self.get_rs(v_def, nthreads)
        return r.reshape(-1, 9), s.reshape(-1, 9)
