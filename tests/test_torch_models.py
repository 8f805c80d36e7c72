"""The port's model layer (utils, models, io) against the JAX package on the
CPU: one numpy state fed to both through `from_numpy`."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianmesh_tpu.io import gaussian_ply as jply
from gaussianmesh_tpu.models import gaussians as jgs
from gaussianmesh_tpu.models import mesh_gaussians as jmgs
from gaussianmesh_tpu.models import render as jrender
from gaussianmesh_tpu.ops.knn import mean_sq_dist3 as jax_mean_sq_dist3
from gaussianmesh_tpu.utils import maths as jmaths
from gaussianmesh_tpu.utils import subdivision as jsub
from gaussianmesh_tpu_torch import resolve_device
from gaussianmesh_tpu_torch.io import gaussian_ply
from gaussianmesh_tpu_torch.models import gaussians, mesh_gaussians, render
from gaussianmesh_tpu_torch.utils import maths, subdivision
from gaussianmesh_tpu_torch.utils.graphics import CameraArrays
from tests.meshes import icosphere
from tests.scenes import look_at_camera

torch.set_num_threads(2)

N = 300


def _t(x):
    return torch.tensor(np.asarray(x))


def _mesh_state(sh_degree, seed=0):
    """A perturbed mesh-bound state as numpy dicts (JAX field names), with
    a few dead capacity rows."""
    rng = np.random.default_rng(seed)
    v, f = icosphere(2)
    n, cap = f.shape[0], f.shape[0] + 16
    k = (sh_degree + 1) ** 2

    def pad(x):
        return np.concatenate([x, np.zeros((cap - n,) + x.shape[1:], x.dtype)])

    params = {
        "bc": pad(rng.normal(0, 0.7, (n, 3))),
        "distance": pad(rng.normal(0, 0.7, (n, 1))),
        "features_dc": pad(rng.normal(0, 0.6, (n, 1, 3))),
        "features_rest": pad(rng.normal(0, 0.2, (n, k - 1, 3))),
        "scaling": pad(rng.normal(-3.5, 0.3, (n, 3))),
        "rotation": pad(rng.normal(size=(n, 4))),
        "opacity": pad(rng.normal(0.5, 1.5, (n, 1))),
    }
    params = {key: x.astype(np.float32) for key, x in params.items()}
    binding = {
        "vertex1": pad(v[f[:, 0]]), "vertex2": pad(v[f[:, 1]]),
        "vertex3": pad(v[f[:, 2]]),
        "vertex_index": pad(f.astype(np.int32)),
        "fid": pad(np.arange(n, dtype=np.int32)[:, None]),
        "normal": pad(rng.normal(size=(n, 3)).astype(np.float32)),
        "r": pad(rng.uniform(0.1, 0.3, (n, 1)).astype(np.float32)),
        "alive": np.arange(cap) < n,
    }
    return params, binding


def _jax_mesh(params, binding):
    return (jmgs.MeshGaussianParams(**{k: jnp.asarray(x) for k, x in params.items()}),
            jmgs.MeshBinding(**{k: jnp.asarray(x) for k, x in binding.items()}))


def _gauss_state(sh_degree, seed=1):
    rng = np.random.default_rng(seed)
    k = (sh_degree + 1) ** 2
    params = {
        "xyz": rng.normal(size=(N, 3)),
        "features_dc": rng.normal(0, 0.6, (N, 1, 3)),
        "features_rest": rng.normal(0, 0.2, (N, k - 1, 3)),
        "scaling": rng.normal(-3.0, 0.5, (N, 3)),
        "rotation": rng.normal(size=(N, 4)),
        "opacity": rng.normal(0, 1.5, (N, 1)),
    }
    return ({key: x.astype(np.float32) for key, x in params.items()},
            np.arange(N) < N - 20)


def _cams():
    cam = look_at_camera(64, 64, distance=3.2)
    return cam, CameraArrays.from_numpy(*[np.asarray(x) for x in cam], device="cpu")


def _assert_arrays_close(at, aj):
    for name in ("xyz", "cov6", "opacity", "rgb"):
        np.testing.assert_allclose(getattr(at, name).detach().numpy(),
                                   np.asarray(getattr(aj, name)),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    np.testing.assert_array_equal(at.active.numpy(), np.asarray(aj.active))


@pytest.mark.parametrize("sh_degree", [0, 1, 2, 3])
def test_mesh_model_arrays_match_jax(sh_degree):
    params, binding = _mesh_state(sh_degree)
    cam, tcam = _cams()
    aj = jrender.mesh_model_arrays(*_jax_mesh(params, binding), cam, sh_degree)
    model = mesh_gaussians.from_numpy(params, binding, device="cpu")
    _assert_arrays_close(render.mesh_model_arrays(model, tcam, sh_degree), aj)


@pytest.mark.parametrize("sh_degree", [0, 1, 2, 3])
def test_gaussian_model_arrays_match_jax(sh_degree):
    params, alive = _gauss_state(sh_degree)
    cam, tcam = _cams()
    jp = jgs.GaussianParams(**{k: jnp.asarray(x) for k, x in params.items()})
    aj = jrender.gaussian_model_arrays(jp, jnp.asarray(alive), cam, sh_degree)
    model = gaussians.from_numpy(params, alive, device="cpu")
    _assert_arrays_close(render.gaussian_model_arrays(model, tcam, sh_degree), aj)


def test_concat_arrays_matches_jax():
    cam, tcam = _cams()
    pm, bm = _mesh_state(1)
    pg, alive = _gauss_state(1)
    jp = jgs.GaussianParams(**{k: jnp.asarray(x) for k, x in pg.items()})
    aj = jrender.concat_arrays(
        jrender.mesh_model_arrays(*_jax_mesh(pm, bm), cam, 1),
        jrender.gaussian_model_arrays(jp, jnp.asarray(alive), cam, 1))
    at = render.concat_arrays(
        render.mesh_model_arrays(mesh_gaussians.from_numpy(pm, bm, "cpu"), tcam, 1),
        render.gaussian_model_arrays(gaussians.from_numpy(pg, alive, "cpu"), tcam, 1))
    _assert_arrays_close(at, aj)


def test_maths_and_subdivision_match_jax():
    rng = np.random.default_rng(2)
    q = rng.normal(size=(64, 4)).astype(np.float32)
    s = rng.uniform(0.01, 0.5, (64, 3)).astype(np.float32)
    np.testing.assert_allclose(maths.quat_to_rotmat(_t(q)).numpy(),
                               np.asarray(jmaths.quat_to_rotmat(jnp.asarray(q))),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        maths.covariance_6(_t(s), maths.normalize(_t(q)), 0.7).numpy(),
        np.asarray(jmaths.covariance_6(jnp.asarray(s), jmaths.normalize(jnp.asarray(q)),
                                       0.7)), rtol=1e-5, atol=1e-7)
    x = rng.uniform(0.01, 0.99, 64).astype(np.float32)
    np.testing.assert_allclose(maths.inverse_sigmoid(_t(x)).numpy(),
                               np.asarray(jmaths.inverse_sigmoid(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)
    v, f = icosphere(1)
    tri = [v[f[:, i]] for i in range(3)]
    tri[2][0] = tri[0][0]  # one degenerate face
    tri[1][0] = tri[0][0]
    for name in ("face_normals", "face_mean_edge_length"):
        np.testing.assert_allclose(
            getattr(subdivision, name)(*(_t(x) for x in tri)).numpy(),
            np.asarray(getattr(jsub, name)(*(jnp.asarray(x) for x in tri))),
            rtol=1e-6, atol=1e-6, err_msg=name)


def test_create_from_mesh():
    v, f = icosphere(2)
    g = torch.Generator().manual_seed(7)
    m = mesh_gaussians.create_from_mesh(v, f, capacity=400, max_sh_degree=2,
                                        device="cpu", generator=g)
    n = f.shape[0]
    assert m.bc.shape == (400, 3) and m.features_rest.shape == (400, 8, 3)
    assert int(m.alive.sum()) == n and not m.alive[n:].any()
    assert isinstance(m.bc, torch.nn.Parameter) and "vertex1" in dict(m.named_buffers())
    np.testing.assert_allclose(m.get_xyz()[:n].detach().numpy(),
                               (v[f[:, 0]] + v[f[:, 1]] + v[f[:, 2]]) / 3, atol=1e-6)
    np.testing.assert_allclose(m.get_opacity()[:n].detach().numpy(), 0.1, rtol=1e-6)
    rgb = (m.features_dc[:n, 0] * 0.28209479177387814 + 0.5).detach().numpy()
    assert rgb.min() >= 0 and rgb.max() <= 1
    centroid = (v[f[:, 0]] + v[f[:, 1]] + v[f[:, 2]]) / 3
    d2 = np.clip(np.asarray(jax_mean_sq_dist3(jnp.asarray(centroid))), 1e-7, None)
    np.testing.assert_allclose(m.scaling[:n, 0].detach().numpy(),
                               np.log(np.sqrt(d2)), rtol=1e-4, atol=1e-5)


def test_resolve_device():
    assert resolve_device("cpu").type == "cpu"
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            resolve_device()
        with pytest.raises(RuntimeError):
            mesh_gaussians.from_numpy(*_mesh_state(0))


def _leaves_equal(a: dict, b: dict):
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_mesh_ply_round_trip(tmp_path, direction):
    params, binding = _mesh_state(3)
    n = int(binding["alive"].sum())
    path = str(tmp_path / "mesh.ply")
    if direction == "jax_to_torch":
        jply.save_mesh_gaussian_ply(path, *_jax_mesh(params, binding))
        model, xyz = gaussian_ply.load_mesh_gaussian_ply(path, device="cpu")
        got_p = {k: getattr(model, k).detach().numpy() for k in params}
        got_b = {k: getattr(model, k).numpy() for k in binding}
    else:
        model = mesh_gaussians.from_numpy(params, binding, device="cpu")
        gaussian_ply.save_mesh_gaussian_ply(path, model)
        jp, jb, xyz = jply.load_mesh_gaussian_ply(path)
        got_p = {k: getattr(jp, k) for k in params}
        got_b = {k: getattr(jb, k) for k in binding}
    _leaves_equal(got_p, {k: x[:n] for k, x in params.items()})
    _leaves_equal(got_b, {k: x[:n] for k, x in binding.items()})
    xyz_ref = np.asarray(jmgs.get_xyz(*_jax_mesh(params, binding)))[:n]
    np.testing.assert_allclose(xyz, xyz_ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_gaussian_ply_round_trip(tmp_path, direction):
    params, alive = _gauss_state(2)
    n = int(alive.sum())
    path = str(tmp_path / "bg.ply")
    if direction == "jax_to_torch":
        jp = jgs.GaussianParams(**{k: jnp.asarray(x) for k, x in params.items()})
        jply.save_gaussian_ply(path, jp, jnp.asarray(alive))
        model = gaussian_ply.load_gaussian_ply(path, capacity=N, device="cpu")
        got = {k: getattr(model, k).detach().numpy()[:n] for k in params}
        assert int(model.alive.sum()) == n and model.alive.shape[0] == N
    else:
        gaussian_ply.save_gaussian_ply(path, gaussians.from_numpy(params, alive, "cpu"))
        jp, jalive = jply.load_gaussian_ply(path)
        got = {k: getattr(jp, k) for k in params}
        assert int(jalive.sum()) == n
    _leaves_equal(got, {k: x[alive] for k, x in params.items()})
