"""The port covers every public name of the JAX package. Every
`gaussianmesh_tpu/**/*.py` is parsed with `ast` (neither package is
imported): its top-level public functions and classes and the
public methods of its public classes must each be provided by the module
of the same path under `gaussianmesh_tpu_torch/` (defined there, or bound
there by an import), or stand in EXEMPT with the reason. An exemption that
names the port's own function must name one the port defines, and an
exemption that names nothing the JAX package defines, or a name the port
now provides itself, is stale. Every C++ and CUDA source of the port is
built by an entry of `_cuda.KERNELS` or `_cuda.HOST_LIBRARIES` (read from
`ops/_cuda.py` with `ast` too)."""

import ast
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
JAX_PKG, PORT = ROOT / "gaussianmesh_tpu", ROOT / "gaussianmesh_tpu_torch"

TPU = "TPU machinery"       # (TPU, why the port has no counterpart)
PORT_NAME = "port name"     # (PORT_NAME, "module.py::name" the port defines instead)
TORCH = "PyTorch form"      # (TORCH, the tensor operation that does it)

EXEMPT = {
    # the JAX compilation cache and platform pin of the command lines
    "cli/common.py::setup_cache": (TPU, "jax.config's compilation cache and platform"),
    # the edit path's matrices as 9-tuples of (V,) arrays (a 3x3 block pads
    # to (8, 128) TPU registers); the port keeps (..., 3, 3) tensors
    "edit/deform.py::deformation_gradients9": (PORT_NAME, "edit/deform.py::deformation_gradients"),
    "edit/runtime.py::transfer_deformation9": (PORT_NAME, "edit/runtime.py::transfer_deformation"),
    "utils/maths.py::m9_mul": (PORT_NAME, "utils/maths.py::mat_mul"),
    "utils/maths.py::m9_vec": (PORT_NAME, "utils/maths.py::mat_vec"),
    "utils/maths.py::m9_det": (PORT_NAME, "utils/maths.py::det3"),
    "utils/maths.py::m9_inv_det": (PORT_NAME, "utils/maths.py::inv3x3"),
    "utils/maths.py::sym6_to_m9": (PORT_NAME, "utils/maths.py::unstrip_symmetric"),
    "utils/maths.py::m9_sym6": (PORT_NAME, "utils/maths.py::strip_symmetric"),
    "utils/maths.py::m9_t": (TORCH, "Tensor.transpose(-1, -2)"),
    "utils/maths.py::m9_scale": (TORCH, "a product with the scalar"),
    "utils/maths.py::m9_identity": (TORCH, "torch.eye(3).expand(..., 3, 3)"),
    "utils/maths.py::m9_from_dense": (TORCH, "none: matrices stay (..., 3, 3)"),
    "utils/maths.py::m9_to_dense": (TORCH, "none: matrices stay (..., 3, 3)"),
    "utils/maths.py::m9_from_packed": (TORCH, "Tensor.reshape(..., 3, 3)"),
    "utils/maths.py::m9_to_packed": (TORCH, "Tensor.reshape(..., 9)"),
    # the models' pytrees and their getters: an nn.Module with methods
    "models/gaussians.py::GaussianParams": (PORT_NAME, "models/gaussians.py::GaussianModel"),
    "models/gaussians.py::get_scaling": (PORT_NAME, "models/gaussians.py::GaussianModel.get_scaling"),
    "models/gaussians.py::get_opacity": (PORT_NAME, "models/gaussians.py::GaussianModel.get_opacity"),
    "models/gaussians.py::get_rotation": (PORT_NAME, "models/gaussians.py::GaussianModel.get_rotation"),
    "models/gaussians.py::get_features": (PORT_NAME, "models/gaussians.py::GaussianModel.get_features"),
    "models/gaussians.py::get_covariance6": (
        PORT_NAME, "models/gaussians.py::GaussianModel.get_covariance6"),
    "models/gaussians.py::n_alive": (TORCH, "model.alive.sum()"),
    "models/mesh_gaussians.py::MeshGaussianParams": (
        PORT_NAME, "models/mesh_gaussians.py::MeshGaussianModel.params"),
    "models/mesh_gaussians.py::MeshBinding": (
        PORT_NAME, "models/mesh_gaussians.py::MeshGaussianModel.binding"),
    "models/mesh_gaussians.py::get_bc": (PORT_NAME, "models/mesh_gaussians.py::MeshGaussianModel.get_bc"),
    "models/mesh_gaussians.py::get_proj_xyz": (
        PORT_NAME, "models/mesh_gaussians.py::MeshGaussianModel.get_proj_xyz"),
    "models/mesh_gaussians.py::get_xyz": (PORT_NAME, "models/mesh_gaussians.py::MeshGaussianModel.get_xyz"),
    "models/mesh_gaussians.py::get_scaling": (
        PORT_NAME, "models/mesh_gaussians.py::MeshGaussianModel.get_scaling"),
    "models/mesh_gaussians.py::get_opacity": (
        PORT_NAME, "models/mesh_gaussians.py::MeshGaussianModel.get_opacity"),
    "models/mesh_gaussians.py::get_features": (
        PORT_NAME, "models/mesh_gaussians.py::MeshGaussianModel.get_features"),
    "models/mesh_gaussians.py::get_covariance6": (
        PORT_NAME, "models/mesh_gaussians.py::MeshGaussianModel.get_covariance6"),
    # the Pallas blend's chunk-aligned pair domain, its q-table and granule
    # padding; the port's K1 / K2 / K3 read the sorted pairs directly
    "ops/rasterize.py::RasterizerConfig.aligned_pad": (TPU, "the pair buffer's DMA granule padding"),
    "ops/rasterize.py::RasterizerConfig.pair_capacity": (
        TPU, "the pair buffer's size with that padding, in blend chunks"),
    "ops/tile_blend.py::build_qtable": (TPU, "the Pallas kernels' q-table layout"),
    "ops/tile_blend.py::blend_sorted_features": (PORT_NAME, "ops/tile_blend.py::blend"),
    "ops/tile_blend.py::blend_sorted_table": (PORT_NAME, "ops/tile_blend.py::blend"),
    "ops/tile_blend.py::blend_table_fused": (PORT_NAME, "ops/tile_blend.py::BlendFunction"),
    "ops/tile_blend.py::blend_tiles_jnp": (PORT_NAME, "ops/tile_blend.py::blend_tiles"),
    "ops/binning.py::tile_id_lists": (PORT_NAME, "ops/tile_blend.py::tile_id_lists"),
    "ops/segsum.py::gather_rows_counted": (PORT_NAME, "ops/segsum.py::gather_rows"),
    "parallel/train_step.py::BandOut": (PORT_NAME, "ops/rasterize.py::RasterizeOut"),
    # optax's Adam and its learning-rate trees
    "train/optim.py::OptState": (PORT_NAME, "train/optim.py::Adam"),
    "train/optim.py::make_optimizer": (PORT_NAME, "train/optim.py::Adam"),
    "train/optim.py::mesh_lr_tree_fn": (PORT_NAME, "train/optim.py::mesh_lr_fn"),
    "train/optim.py::gaussian_lr_tree_fn": (PORT_NAME, "train/optim.py::gaussian_lr_fn"),
    "train/trainer.py::pad_axis0": (PORT_NAME, "train/densify.py::pad0"),
}


def _public(path: Path) -> set[str]:
    """Top-level public functions and classes, and the public methods of
    public classes ("Class.method")."""
    out = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)) \
                and not node.name.startswith("_"):
            out.add(node.name)
            if isinstance(node, ast.ClassDef):
                out |= {f"{node.name}.{m.name}" for m in node.body
                        if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))
                        and not m.name.startswith("_")}
    return out


def _provided(path: Path) -> set[str]:
    """The names a module provides: its functions and classes (with their
    methods) and the names its top-level imports bind."""
    out = set()
    if not path.exists():
        return out
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out.add(node.name)
            if isinstance(node, ast.ClassDef):
                out |= {f"{node.name}.{m.name}" for m in node.body
                        if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))}
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            out |= {(a.asname or a.name).split(".")[0] for a in node.names}
    return out


def _jax_names() -> dict[str, set[str]]:
    return {str(p.relative_to(JAX_PKG)): _public(p) for p in sorted(JAX_PKG.rglob("*.py"))}


def test_every_public_name_is_ported_or_exempt():
    missing = []
    for rel, names in _jax_names().items():
        have = _provided(PORT / rel)
        missing += [f"{rel}::{n}" for n in sorted(names - have) if f"{rel}::{n}" not in EXEMPT]
    assert not missing, "public names of the JAX package without a counterpart: " + \
        ", ".join(missing)
    for key, (kind, detail) in EXEMPT.items():
        assert kind in (TPU, PORT_NAME, TORCH) and detail, key
        if kind == PORT_NAME:
            rel, name = detail.split("::")
            assert name in _provided(PORT / rel), f"{key}: the port has no {detail}"


def test_no_stale_exemption():
    jax_names = _jax_names()
    for key in EXEMPT:
        rel, name = key.split("::")
        assert name in jax_names.get(rel, set()), \
            f"{key}: the JAX package defines no such name"
        assert name not in _provided(PORT / rel), \
            f"{key}: the port provides it now; drop the exemption"


def _table_keys(path: Path, name: str) -> set[str]:
    """The string keys of the dict literal assigned to `name` in `path`."""
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == name for t in node.targets):
            return {k.value for k in node.value.keys}
    raise AssertionError(f"{path} assigns no {name}")


def test_every_native_source_is_built():
    """csrc/*.cu and csrc/*.cpp each have their `_cuda` entry, and each
    entry its source."""
    csrc, cuda_py = PORT / "csrc", PORT / "ops" / "_cuda.py"
    assert {p.stem for p in csrc.glob("*.cu")} == _table_keys(cuda_py, "KERNELS")
    assert {p.stem for p in csrc.glob("*.cpp")} == _table_keys(cuda_py, "HOST_LIBRARIES")
