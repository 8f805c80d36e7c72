"""The port stands alone: no module of it imports JAX or the JAX package,
nor an imaging package (PIL, imageio) or a Zstandard one (zstandard): the
machines it runs on have none."""

import ast
import pathlib
import re
import subprocess
import sys

import gaussianmesh_tpu_torch

PKG = pathlib.Path(gaussianmesh_tpu_torch.__file__).parent
ROOT = PKG.parent


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_importing_every_module_leaves_out_jax():
    mods = list(_modules())
    assert "gaussianmesh_tpu_torch.ops.rasterize" in mods
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m in ('jax', 'gaussianmesh_tpu', "
            "'PIL', 'imageio', 'zstandard') or m.startswith(('jax.', 'flax', "
            "'gaussianmesh_tpu.', 'PIL.', 'imageio.', 'zstandard.')))\n"
            "print(bad)\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _imported_names(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_source_names_jax_or_the_jax_package():
    files = list(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py", ROOT / "bench_torch.py"] + [
        ROOT / "tools" / f"{name}.py" for name in (
            "quality_run_torch", "profile_raster_torch", "bench_playback_torch",
            "scenes_torch", "timing_torch", "bench_scaling_torch", "bench_sharded_torch",
            "multicard_torch")] + [ROOT / "tests" / "torch_dist_worker.py"]
    assert all(path.exists() for path in files)
    for path in files:
        for name in _imported_names(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "gaussianmesh_tpu", "PIL",
                               "imageio", "zstandard"), (path, name)


def _loads_webp(path) -> list:
    """Calls in `path` that load a library named for WebP (ctypes.CDLL,
    cdll.LoadLibrary, find_library ...) and string constants other than
    docstrings that name libwebp."""
    tree = ast.parse(path.read_text())
    docs = {id(node.body[0].value) for node in ast.walk(tree)
            if isinstance(node, (ast.Module, ast.FunctionDef, ast.ClassDef))
            and node.body and isinstance(node.body[0], ast.Expr)
            and isinstance(node.body[0].value, ast.Constant)}
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            name = ast.unparse(node.func)
            if re.search(r"CDLL|LoadLibrary|find_library|dlopen", name) and \
                    "webp" in ast.unparse(node).lower():
                found.append(ast.unparse(node))
        elif isinstance(node, ast.Constant) and isinstance(node.value, str) and \
                id(node) not in docs and "libwebp" in node.value.lower():
            found.append(node.value)
    return found


def test_no_module_loads_libwebp():
    """The port decodes WebP with its own C++: no module of it, nor the smoke,
    loads a WebP library through ctypes or names libwebp in code (the
    tests' oracle, PIL's bundled libwebp, stays on the tests' side), and the
    C++ sources open no library."""
    files = list(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py", ROOT / "bench_torch.py"]
    assert PKG / "io" / "webp.py" in files
    for path in files:
        assert not _loads_webp(path), (path, _loads_webp(path))
    for path in PKG.glob("csrc/*.c*"):
        assert "dlopen" not in path.read_text(), path
    assert _loads_webp(ROOT / "tools" / "make_webp_fixtures_torch.py")   # the check bites


def test_quality_tool_leaves_out_jax(tmp_path):
    """`tools/quality_run_torch.py`, loaded by path and run for its dataset
    (16x16, 4 cameras, on the CPU), imports neither JAX nor the JAX package
    nor an imaging package."""
    code = ("import importlib.util, sys\n"
            "spec = importlib.util.spec_from_file_location('q', 'tools/quality_run_torch.py')\n"
            "q = importlib.util.module_from_spec(spec)\n"
            "spec.loader.exec_module(q)\n"
            "q.W = q.H = 16\n"
            "q.N_CAMS = 4\n"
            f"q.make_dataset({str(tmp_path)!r}, 'cpu')\n"
            "bad = sorted(m for m in sys.modules if m in ('jax', 'gaussianmesh_tpu', "
            "'PIL', 'imageio') or m.startswith(('jax.', 'flax', 'gaussianmesh_tpu.', "
            "'PIL.', 'imageio.')))\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert len(list((tmp_path / "train").glob("r_*.png"))) == 8
    assert (tmp_path / "proxy.obj").exists()


def test_measurement_tools_leave_out_jax():
    """`bench_torch.py` run at 32x32 on the CPU, with the profile and playback
    tools and their helpers imported beside it, imports neither JAX nor the
    JAX package nor an imaging package."""
    code = ("import sys\n"
            "sys.path[:0] = ['.', 'tools']\n"
            "import bench_torch, profile_raster_torch, bench_playback_torch\n"
            "import scenes_torch, timing_torch\n"
            "bench_torch.main(['--device', 'cpu', '--width', '32', '--height', '32', "
            "'--n_gauss', '100', '--steps', '1', '--warm', '0'])\n"
            "bad = sorted(m for m in sys.modules if m in ('jax', 'gaussianmesh_tpu', "
            "'PIL', 'imageio') or m.startswith(('jax.', 'flax', 'gaussianmesh_tpu.', "
            "'PIL.', 'imageio.')))\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert '"rasterize_fwd_bwd_mpix_per_s"' in proc.stdout


def test_scaling_tools_leave_out_jax():
    """`bench_torch.py --sharded` (the scaling tool) and the sharded-step tool
    run at 32x32 on the CPU, D = 1 and 2, import neither JAX nor the JAX
    package nor an imaging package, and leave no process group behind."""
    code = ("import sys, tempfile\n"
            "sys.path[:0] = ['.', 'tools']\n"
            "import torch.distributed as dist\n"
            "import bench_torch, bench_sharded_torch\n"
            "small = ['--device', 'cpu', '--width', '32', '--height', '32', "
            "'--n_gauss', '100', '--steps', '1', '--warm', '0']\n"
            "with tempfile.TemporaryDirectory() as tmp:\n"
            "    bench_torch.main(['--sharded', '--d_list', '1', '2', '--out', "
            "tmp + '/s.json'] + small)\n"
            "    bench_sharded_torch.main(small + ['--out', tmp + '/b.json'])\n"
            "assert not dist.is_initialized()\n"
            "bad = sorted(m for m in sys.modules if m in ('jax', 'gaussianmesh_tpu', "
            "'PIL', 'imageio') or m.startswith(('jax.', 'flax', 'gaussianmesh_tpu.', "
            "'PIL.', 'imageio.')))\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert '"scaling_efficiency_8dev_model"' in proc.stdout


def test_native_sources_and_e2e_script_stand_alone():
    """The port's C++ / CUDA sources include only system headers and their
    own `csrc/` headers (nothing of the JAX tree's `native/`); the
    end-to-end script and the scene generator it imports name only the
    port's modules."""
    import re

    sources = sorted(PKG.glob("csrc/*.c*"))
    assert PKG / "csrc" / "acap.cpp" in sources
    for path in sources:
        for inc in re.findall(r'#include\s+([<"][^>"]+[>"])', path.read_text()):
            if inc.startswith('"'):
                assert (path.parent / inc.strip('"')).exists(), (path, inc)
        assert "native/" not in path.read_text(), path
    script = (ROOT / "examples" / "synthetic_e2e_torch.sh").read_text()
    mods = re.findall(r"-m\s+([\w.]+)", script)
    assert mods and all(m.startswith("gaussianmesh_tpu_torch.cli.") for m in mods), mods
    assert not re.search(r"\bjax\b|gaussianmesh_tpu\.|imageio|PIL", script)
    for name in _imported_names(ROOT / "tests" / "test_torch_e2e.py"):
        assert name.split(".")[0] not in ("jax", "jaxlib", "flax", "gaussianmesh_tpu",
                                          "PIL", "imageio"), name


def test_multicard_tool_leaves_out_jax():
    """`tools/multicard_torch.py` with what its ranks and its entry-point part
    import (`chip_smoke.py`, the dataset of `tests/test_torch_e2e.py`, the
    measurement tools) names neither JAX nor the JAX package nor an imaging
    package."""
    code = ("import sys\n"
            "sys.path[:0] = ['.', 'tools', 'tests']\n"
            "import multicard_torch, chip_smoke, test_torch_e2e\n"
            "import bench_torch, bench_sharded_torch, bench_scaling_torch\n"
            "chip_smoke.load_port()\n"
            "multicard_torch.parser().parse_args(['--device', 'cpu'])\n"
            "bad = sorted(m for m in sys.modules if m in ('jax', 'gaussianmesh_tpu', "
            "'PIL', 'imageio') or m.startswith(('jax.', 'flax', 'gaussianmesh_tpu.', "
            "'PIL.', 'imageio.')))\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
