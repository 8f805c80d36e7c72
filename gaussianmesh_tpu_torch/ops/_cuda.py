"""Builds and loads the port's CUDA kernels at first use.

Each source `csrc/<name>.cu` exports plain C entry points and is compiled by
`nvcc` into its own shared library, loaded with `ctypes` (no PyTorch
headers, so a build takes seconds). Libraries go into `_build/` under the
package (listed in `.gitignore`), named by a hash of their source, the
shared headers `csrc/*.cuh` and the flags, so an edited source is rebuilt
and a stale library never loads.
`build()` starts one `nvcc` per source, all at once.

Host code (`csrc/<name>.cpp`, C++: the deformation-gradient extractor with
OpenMP, the image codecs of the training path, lossy WebP's VP8 codec,
lossless WebP's VP8L codec and the alpha plane, Zstandard)
builds the same way with `g++` (`host_library`). A missing compiler or a
failed build raises with the compiler's output: nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# -fwrapv: signed arithmetic wraps, as numpy's int32 does in the plain versions
HOST_FLAGS = ["-O3", "-std=c++17", "-fopenmp", "-fwrapv", "-shared", "-fPIC"]

_P, _I = ctypes.c_void_p, ctypes.c_int
# library -> {C entry point: argtypes}; every entry point returns a
# cudaError_t as an int. `<library>_occupancy` entry points write threads
# per block, shared memory per block and resident blocks per SM.
_OCC = [_P, _P, _P]
KERNELS = {
    "tile_blend_fwd": {
        # feat, sorted_gid, starts, counts, num_tiles, grid_x, width,
        # height, color, final_t, n_contrib, stream
        "gm_tile_blend_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P],
        "gm_tile_blend_fwd_occupancy": _OCC,
    },
    "tile_blend_bwd": {
        # feat, sorted_gid, starts, final_t, n_contrib, g_color, g_final_t,
        # order, num_tiles, grid_x, width, height, rows, stream
        "gm_tile_blend_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                              _P, _P],
        "gm_tile_blend_bwd_occupancy": _OCC,
    },
    "segment_sum": {
        # rows, grouped_pos, seg_starts, n, out, stream
        "gm_segment_sum": [_P, _P, _P, _I, _P, _P],
        "gm_segment_sum_occupancy": _OCC,
    },
}


# host library -> {C entry point: argtypes}; every entry point returns an
# int status, 0 when it succeeded (its caller names the others)
_L = ctypes.c_int64
HOST_LIBRARIES = {
    "acap": {
        # v_ref, v_def (n, 3) f64, n, neighbors (n, D) i32, mask (n, D) u8,
        # D, r_out, s_out (n, 9) f32, n_threads
        "gm_acap_get_rs": [_P, _P, _I, _P, _P, _I, _P, _P, _I],
    },
    "image": {
        # data, n, n_mcus, interval, per_mcu, comp, dc_tab, ac_tab, tables,
        # vals, vals_stride, n_tables, dest, coef, used, n_found
        "gm_jpeg_scan": [_P, _L, _I, _I, _I, _P, _P, _P, _P, _P, _I, _I, _P, _P,
                         _P, _P],
        # data, n, n_mcus, interval, per_mcu, comp, tab, tables, vals,
        # vals_stride, n_tables, dest, ss, se, ah, al, coef, used, n_found
        "gm_jpeg_scan_progressive": [_P, _L, _I, _I, _I, _P, _P, _P, _P, _I, _I, _P,
                                     _I, _I, _I, _I, _P, _P, _P],
        # coef, n_comp, offset, nby, nbx, rows, cols, ry, rx, q, height,
        # width, color, out
        "gm_jpeg_planes": [_P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
        # rows, h, row_bytes, bpp, out
        "gm_png_unfilter": [_P, _L, _L, _I, _P],
        # src, h, w, c, axis, out_size, xmin, k, ksize, dst
        "gm_resample_pass": [_P, _L, _L, _L, _I, _L, _P, _P, _I, _P],
        # data, n, msb_first, min_bits, early, out, out_size, info
        "gm_lzw_decode": [_P, _L, _I, _I, _I, _P, _L, _P],
        # data, n, msb_first, min_bits, early, clear_at, out, cap, n_out
        "gm_lzw_encode": [_P, _L, _I, _I, _I, _I, _P, _L, _P],
        # data, n, out, out_size, n_out
        "gm_packbits_decode": [_P, _L, _P, _L, _P],
        # data, n, origin, width, height, rle4, out, n_out
        "gm_bmp_rle": [_P, _L, _L, _L, _L, _I, _P, _P],
        # data, n, pixel_bytes, row_bytes, total, out, n_out
        "gm_tga_rle": [_P, _L, _I, _L, _L, _P, _P],
        # data, n, channels, pixels, out
        "gm_qoi_decode": [_P, _L, _I, _L, _P],
        # data, n, starts, lengths, xsize, ysize, zsize, bpc, out
        "gm_sgi_rle": [_P, _L, _P, _P, _L, _L, _I, _I, _P],
        # data, n, row_bytes, rows, out, n_out
        "gm_pcx_rle": [_P, _L, _L, _L, _P, _P],
        # data, n, sizesq, out, info
        "gm_icns_rle": [_P, _L, _L, _P, _P],
        # data, n, total, out, info
        "gm_sun_rle": [_P, _L, _L, _P, _P],
        # data, n, rows, row_bytes, total, out, info
        "gm_msp_rle": [_P, _L, _L, _L, _L, _P, _P],
        # buf, n, width, height, plane, info
        "gm_fli_frame": [_P, _L, _L, _L, _P, _P],
        # data, n, width, height, out, info
        "gm_bc1_decode": [_P, _L, _L, _L, _P, _P],
        # data, n, width, height, kind, flags, out, info
        "gm_bcn_decode": [_P, _L, _L, _L, _I, _I, _P, _P],
        # data, n, mcux, mcuy, rows_per, per_mcu, comp, dy, dx, tab, tables, vals,
        # vals_stride, n_tables, n_comp, hs, vs, planes, stride, predictor, pt, used,
        # n_found
        "gm_jpeg_lossless": [_P, _L, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P,
                             _P, _P, _P, _I, _I, _P, _P],
        # data, n, n_mcus, interval, per_mcu, comp, dc_tab, ac_tab, dest, progressive, ss,
        # se, ah, al, cond, coef, used, n_found
        "gm_jpeg_arith_scan": [_P, _L, _I, _I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P,
                               _P, _P, _P],
        # blocks, n_mcus, per_mcu, comp, dc_tab, ac_tab, progressive, ss, se, ah, al,
        # interval, cond, out, cap, n_out
        "gm_jpeg_arith_encode": [_P, _I, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _L,
                                 _P],
    },
    "vp8": {
        # frame, n, y, u, v, info
        "gm_vp8_decode": [_P, _L, _P, _P, _P, _P],
        # y, u, v, width, height, out
        "gm_vp8_rgb": [_P, _P, _P, _I, _I, _P],
        # y, u, v, width, height, seg_map, params, out, cap, n_out, ry, ru, rv
        "gm_vp8_encode": [_P, _P, _P, _I, _I, _P, _P, _P, _L, _P, _P, _P, _P],
    },
    "vp8l": {
        # stream, n, argb, info
        "gm_vp8l_decode": [_P, _L, _P, _P],
        # payload, n, width, height, alpha, info
        "gm_alpha_decode": [_P, _L, _I, _I, _P, _P],
        # argb, width, height, cache_bits, lz77, meta_bits, groups, flags, out,
        # cap, bitpos, stats
        "gm_vp8l_encode_image": [_P, _I, _I, _I, _I, _I, _P, _I, _P, _L, _P, _P],
    },
    "zstd": {
        # data, n, out, size, info
        "gm_zstd_decode": [_P, _L, _P, _L, _P],
        # data, n, seed, out
        "gm_xxh64": [_P, _L, ctypes.c_uint64, _P],
        # data, n, checksum, out, cap, n_out
        "gm_zstd_encode": [_P, _L, _I, _P, _L, _P],
    },
}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cands = [shutil.which("nvcc")]
    if CUDA_HOME:
        cands.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels")


def _lib_path(name: str) -> Path:
    if name in HOST_LIBRARIES:
        h = hashlib.sha1((CSRC / f"{name}.cpp").read_bytes())
        h.update(" ".join(HOST_FLAGS).encode())
        return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"
    h = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):   # the sources' shared pieces
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=None) -> dict[str, str]:
    """Compile the named kernel libraries (default: all) that are not built
    yet, one `nvcc` process per source, all started together.
    -> {name: nvcc's output (the `-Xptxas -v` register/shared-memory lines)}
    for the libraries built by this call."""
    names = list(KERNELS) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"{name}:\n{logs[name]}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library `name`, built first if needed."""
    build([name])
    lib = ctypes.CDLL(str(_lib_path(name)))
    for fn, argtypes in KERNELS[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def occupancy(name: str) -> dict[str, int]:
    """Launch shape of library `name`'s kernel on the current CUDA device:
    {"threads": per block, "smem_bytes": per block, "blocks_per_sm": how
    many blocks of it an SM holds at once}."""
    vals = [ctypes.c_int() for _ in range(3)]
    err = getattr(library(name), f"gm_{name}_occupancy")(
        *(ctypes.byref(v) for v in vals))
    if err != 0:
        raise RuntimeError(f"{name} occupancy query failed: cudaError {err}")
    return dict(zip(("threads", "smem_bytes", "blocks_per_sm"),
                    (v.value for v in vals)))


def _gxx() -> str:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: a C++ compiler with OpenMP is needed "
                           "to build the port's host libraries")
    return gxx


@functools.cache
def host_library(name: str) -> ctypes.CDLL:
    """The loaded host library `name` (`csrc/<name>.cpp`), built first with
    g++ if needed. Raises with the compiler's output when the build fails."""
    out = _lib_path(name)
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([_gxx(), *HOST_FLAGS, "-o", str(tmp),
                               str(CSRC / f"{name}.cpp")],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed for {name}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    for fn, argtypes in HOST_LIBRARIES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib
