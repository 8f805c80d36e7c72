"""The port's deformation playback (`gaussianmesh_tpu_torch/edit/`, the
composite rasterizer, `cameras.json`, pose paths) against the JAX package on
the CPU. Objects, meshes and backgrounds are written by the JAX package and
read by the port."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianmesh_tpu.data import cameras as jcameras
from gaussianmesh_tpu.edit import deform as jdeform, pose_paths as jpose
from gaussianmesh_tpu.edit import runtime as jruntime
from gaussianmesh_tpu.io import gaussian_ply as jply, mesh as jmesh
from gaussianmesh_tpu.models import gaussians as jgs, mesh_gaussians as jmgs
from gaussianmesh_tpu.models.render import concat_arrays as jconcat
from gaussianmesh_tpu.ops import rasterize as jrast
from gaussianmesh_tpu.utils import maths as jmaths
from gaussianmesh_tpu_torch.data import cameras
from gaussianmesh_tpu_torch.edit import deform, pose_paths, runtime
from gaussianmesh_tpu_torch.ops import rasterize
from gaussianmesh_tpu_torch.utils import maths
from gaussianmesh_tpu_torch.utils.graphics import CameraArrays
from tests.meshes import icosphere
from tests.scenes import look_at_camera

torch.set_num_threads(2)

W = H = 64


def _rot(axis, angle):
    axis = np.asarray(axis, float) / np.linalg.norm(axis)
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(angle) * k + (1 - np.cos(angle)) * k @ k


def twist(v, amp=0.6):
    """A twist about z by amp * z (the playback benchmark's deformation)."""
    ang = amp * v[:, 2]
    c, s = np.cos(ang), np.sin(ang)
    return np.stack([c * v[:, 0] - s * v[:, 1], s * v[:, 0] + c * v[:, 1],
                     v[:, 2]], -1).astype(np.float32)


def deformed(v, kind, seed=0):
    """The deformations the tests play: rigid, a uniform x1.7 scale, a
    twist, and a smooth seeded displacement."""
    q = _rot([0.3, 1.0, 0.2], 0.7)
    if kind == "rigid":
        return (v @ q.T + [0.5, -0.2, 0.1]).astype(np.float32)
    if kind == "scale":
        return (1.7 * v).astype(np.float32)
    if kind == "twist":
        return twist(v)
    rng = np.random.default_rng(seed)
    k, a = rng.normal(size=(3, 3)), rng.normal(0, 0.05, (3, 3))
    return (v + np.sin(v @ k) @ a).astype(np.float32)


def _t(x):
    return torch.tensor(np.asarray(x))


def _cam_t(cam):
    return CameraArrays.from_numpy(*[np.asarray(x) for x in cam], device="cpu")


def jax_object(dirpath, name="obj", level=2, offset=(0.0, 0.0, 0.0), seed=0):
    """A mesh-Gaussian object written by the JAX package: one Gaussian per
    face of an icosphere, moved along and off its face, resized, turned,
    opaque-ish, SH degree 3 -> (PLY path, OBJ path, vertices, faces)."""
    v, f = icosphere(level)
    v = (v + np.asarray(offset, np.float32)).astype(np.float32)
    p, b, _, _ = jmgs.create_from_mesh(jnp.asarray(v), jnp.asarray(f),
                                       capacity=f.shape[0],
                                       vertex_capacity=v.shape[0],
                                       rng=jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)

    def jitter(x, scale, shift=0.0):
        x = np.asarray(x)
        return jnp.asarray((x + shift + rng.normal(0, scale, x.shape)).astype(np.float32))

    p = p.replace(bc=jitter(p.bc, 0.5), distance=jitter(p.distance, 0.5),
                  scaling=jitter(p.scaling, 0.2), rotation=jitter(p.rotation, 0.5),
                  opacity=jitter(p.opacity, 1.0, shift=3.0),
                  features_dc=jitter(p.features_dc, 0.3),
                  features_rest=jitter(p.features_rest, 0.1))
    ply, obj = str(dirpath / f"{name}.ply"), str(dirpath / f"{name}.obj")
    jply.save_mesh_gaussian_ply(ply, p, b)
    jmesh.write_triangle_mesh(obj, v, f)
    return ply, obj, v, f


def jax_background(dirpath, n=300, seed=1):
    """A vanilla (background) model of SH degree 1, written by the JAX package."""
    rng = np.random.default_rng(seed)
    p, state = jgs.create_from_points(
        jnp.asarray(rng.uniform(-2.5, 2.5, (n, 3)).astype(np.float32)),
        jnp.asarray(rng.uniform(0, 1, (n, 3)).astype(np.float32)),
        capacity=n, max_sh_degree=1)
    p = p.replace(scaling=jnp.full((n, 3), np.log(0.12), jnp.float32),
                  opacity=jnp.full((n, 1), 1.0, jnp.float32))
    path = str(dirpath / "bg.ply")
    jply.save_gaussian_ply(path, p, state.alive)
    return path


# ---------------------------------------------------------------- 3x3 maths

def _matrices(kind, n=200, seed=0):
    """Seeded 3x3 matrices U diag(s) V^T, U and V orthogonal: singular
    values in [0.3, 3]; the smallest in [2e-3, 1e-2] (near-singular); one
    column negated (det < 0); "singular": half with a zero column (det
    exactly 0), half scaled by 1e-4 (|det| under the 1e-9 guard)."""
    rng = np.random.default_rng(seed)
    u, _ = np.linalg.qr(rng.normal(size=(n, 3, 3)))
    v, _ = np.linalg.qr(rng.normal(size=(n, 3, 3)))
    s = rng.uniform(0.3, 3.0, (n, 3))
    if kind == "near_singular":
        s[:, 2] = rng.uniform(2e-3, 1e-2, n)
    a = (u * s[:, None, :]) @ np.swapaxes(v, 1, 2)
    if kind == "singular":
        a[: n // 2, :, 2] = 0.0
        a[n // 2:] *= 1e-4
    if kind == "negative_det":
        a[:, :, 0] *= -1
    return a.astype(np.float32)


@pytest.mark.parametrize("kind", ["random", "negative_det", "near_singular",
                                  "singular"])
def test_maths_match_jax(kind):
    """inv3x3, polar_rs9 and congruence_sym6 against the JAX package's
    within 1e-5 of each output's scale; a singular input takes the identity
    fallback (R = S = I) on both sides, exactly."""
    a = _matrices(kind)
    if kind == "negative_det":
        assert (np.linalg.det(a) < 0).all()
    inv, det = maths.inv3x3(_t(a))
    jinv, jdet = jmaths.inv3x3(jnp.asarray(a))
    scale = np.abs(np.asarray(jinv)).max()
    np.testing.assert_allclose(inv.numpy(), np.asarray(jinv), atol=1e-5 * scale)
    np.testing.assert_allclose(det.numpy(), np.asarray(jdet), atol=1e-5)

    r, s = maths.polar_rs9(_t(a.reshape(-1, 9)))
    jr, js = jmaths.polar_rs9(jmaths.m9_from_packed(jnp.asarray(a.reshape(-1, 9))))
    jr, js = np.asarray(jmaths.m9_to_packed(jr)), np.asarray(jmaths.m9_to_packed(js))
    np.testing.assert_allclose(r.numpy(), jr, atol=1e-5)
    np.testing.assert_allclose(s.numpy(), js, atol=1e-5 * np.abs(js).max())
    if kind == "singular":
        eye = np.broadcast_to(np.eye(3, dtype=np.float32).reshape(9), jr.shape)
        assert np.array_equal(r.numpy(), eye) and np.array_equal(jr, eye)
        assert np.array_equal(s.numpy(), eye) and np.array_equal(js, eye)
    else:      # R is a proper rotation
        rr = r.numpy().reshape(-1, 3, 3)
        np.testing.assert_allclose(rr @ np.swapaxes(rr, 1, 2),
                                   np.broadcast_to(np.eye(3), rr.shape), atol=1e-4)
        assert (np.linalg.det(rr) > 0).all()

    c6 = np.random.default_rng(1).normal(size=(a.shape[0], 6)).astype(np.float32)
    got = maths.congruence_sym6(_t(a), _t(c6)).numpy()
    want = np.asarray(jmaths.congruence_sym6(jmaths.m9_from_dense(jnp.asarray(a)),
                                             jnp.asarray(c6)))
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())


# ---------------------------------------------------------------- one-ring

def _fan(spokes):
    """One hub vertex with `spokes` neighbours (a degree over max_degree)."""
    ang = np.linspace(0, 2 * np.pi, spokes, endpoint=False)
    v = np.concatenate([[[0, 0, 0]], np.stack([np.cos(ang), np.sin(ang),
                                               0 * ang], 1)]).astype(np.float32)
    f = np.array([[0, 1 + i, 1 + (i + 1) % spokes] for i in range(spokes)], np.int32)
    return v, f


@pytest.mark.parametrize("mesh,max_degree", [("ico2", 16), ("ico2", 5),
                                             ("fan20", 16)])
def test_build_one_ring_matches_jax(mesh, max_degree):
    v, f = icosphere(2) if mesh == "ico2" else _fan(20)
    got = deform.build_one_ring(f, v.shape[0], max_degree)
    want = jdeform.build_one_ring(f, v.shape[0], max_degree)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert np.array_equal(g, w)
    if mesh == "fan20":
        assert got[1][0].all() and got[1].shape[1] == 16   # the hub is cut


# ---------------------------------------------------------------- gradients

def _jax_rs(v, f, v_def):
    r, s = jdeform.MeshDeformer(v, f).get_rs(v_def)
    return np.asarray(r), np.asarray(s)


@pytest.mark.parametrize("level", [1, 2, 3])
@pytest.mark.parametrize("kind", ["rigid", "scale", "twist", "noise"])
def test_deformation_gradients_match_jax(level, kind):
    """At levels 1-3 the JAX package's guards do not trip, and the ring
    normalisation changes T only by rounding: R and S within 1e-4."""
    v, f = icosphere(level)
    v_def = deformed(v, kind, seed=level)
    d = deform.MeshDeformer(v, f, device="cpu")
    r, s = d.get_rs(v_def)
    r2, s2 = deform.deformation_gradients(d.v_ref, torch.tensor(v_def),
                                          d.neighbors, d.mask)
    assert torch.equal(r, r2) and torch.equal(s, s2)
    jr, js = _jax_rs(v, f, v_def)
    np.testing.assert_allclose(r.numpy(), jr, atol=1e-4)
    np.testing.assert_allclose(s.numpy(), js, atol=1e-4)


@pytest.fixture(scope="module")
def level6():
    v, f = icosphere(6)
    return v, f, deform.build_one_ring(f, v.shape[0])


def _oracle_rs(v, v_def, neighbors, mask):
    """Float64: T by least squares over the ring, polar by SVD."""
    v, v_def = v.astype(np.float64), v_def.astype(np.float64)
    e = np.where(mask[..., None], v[neighbors] - v[:, None], 0.0)
    ed = np.where(mask[..., None], v_def[neighbors] - v_def[:, None], 0.0)
    b = np.einsum("vdi,vdj->vij", e, e)
    a = np.einsum("vdi,vdj->vij", ed, e)
    t = np.swapaxes(np.linalg.solve(b, np.swapaxes(a, 1, 2)), 1, 2)   # A B^-1
    u, sig, vt = np.linalg.svd(t)
    r = u @ vt
    return r, np.swapaxes(vt, 1, 2) * sig[:, None, :] @ vt


@pytest.mark.parametrize("kind,bar", [("rigid", 2e-3), ("scale", 5e-3)])
def test_deformation_gradients_level6_vs_float64_oracle(level6, kind, bar):
    """At icosphere level 6 the JAX package returns R = S = I for every
    vertex (its absolute determinant guards trip on the nearly flat rings);
    the port's normalised rings match a float64 least-squares + SVD oracle."""
    v, f, (neighbors, mask) = level6
    v_def = deformed(v, kind)
    r, s = deform.MeshDeformer(v, f, device="cpu").get_rs(v_def)
    ro, so = _oracle_rs(v, v_def, neighbors, mask)
    assert np.abs(r.numpy() - ro).max() <= 2e-3
    assert np.abs(s.numpy() - so).max() <= bar
    jr, js = _jax_rs(v, f, v_def)
    eye = np.broadcast_to(np.eye(3, dtype=np.float32), jr.shape)
    assert np.array_equal(jr, eye) and np.array_equal(js, eye)


# ---------------------------------------------------------------- objects

def _object_fields(obj):
    return {"pos": np.asarray(obj.pos), "cov6": np.asarray(obj.cov6),
            "rot9": np.asarray(obj.rot9 if hasattr(obj, "rot9")
                               else obj.rot.reshape(-1, 9))}


@pytest.mark.parametrize("kind", ["twist", "noise"])
def test_object_deformer_matches_jax(tmp_path, kind):
    """From a JAX-written PLY + OBJ: pos, cov6, R^ and the SH colours at
    R^^T d within 1e-5 of each field's scale."""
    ply, mesh_path, v, _ = jax_object(tmp_path)
    cam = look_at_camera(W, H, distance=3.5)
    jobj = jruntime.ObjectDeformer(ply, mesh_path)
    obj = runtime.ObjectDeformer(ply, mesh_path, device="cpu")
    v_def = deformed(v, kind)
    jobj.deform(v_def)
    obj.deform(v_def)
    want, got = _object_fields(jobj), _object_fields(obj)
    want["rgb"] = np.asarray(jobj.arrays(cam).rgb)
    got["rgb"] = obj.arrays(_cam_t(cam)).rgb.numpy()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-5 * np.abs(want[k]).max(),
                                   err_msg=k)
    a = runtime.deformed_object_arrays(obj, v_def, _cam_t(cam))
    assert torch.equal(a.xyz, obj.pos) and torch.equal(a.rgb, torch.tensor(got["rgb"]))


def test_object_deformer_rigid_motion(tmp_path):
    """A rigid frame moves each Gaussian by the motion of its on-surface
    projection, pos0 + (proj0 Q^T + t - proj0), and turns its covariance
    to Q cov Q^T."""
    ply, mesh_path, v, _ = jax_object(tmp_path)
    obj = runtime.ObjectDeformer(ply, mesh_path, device="cpu")
    q, t = _rot([0.3, 1.0, 0.2], 0.7), np.array([0.5, -0.2, 0.1])
    obj.deform((v @ q.T + t).astype(np.float32))
    proj0, pos0 = obj.proj0.numpy(), obj.pos0.numpy()
    np.testing.assert_allclose(obj.pos.numpy(), pos0 + proj0 @ q.T + t - proj0,
                               atol=1e-5)
    cov0 = maths.unstrip_symmetric(obj.cov6_0).numpy()
    cov = maths.unstrip_symmetric(obj.cov6).numpy()
    err = np.abs(cov - q @ cov0 @ q.T).max((1, 2)) / np.abs(cov0).max((1, 2))
    assert err.max() <= 1e-4
    obj.reset()
    assert torch.equal(obj.pos, obj.pos0) and torch.equal(obj.cov6, obj.cov6_0)


# ---------------------------------------------------------------- scenes

@pytest.fixture
def scene(tmp_path):
    """Files of a deforming object, a static side object and a background."""
    main = jax_object(tmp_path, "main", seed=0)
    side = jax_object(tmp_path, "side", level=1, offset=(1.3, 0.3, -0.2), seed=2)
    return main, side, jax_background(tmp_path)


def _editors(scene):
    (ply, mesh_path, _, _), (ply2, mesh2, _, _), bg = scene
    jed = jruntime.SceneEditor(bg_ply_path=bg, max_sh_degree=1)
    ed = runtime.SceneEditor(bg_ply_path=bg, max_sh_degree=1, device="cpu")
    for e in (jed, ed):
        e.add_object(ply, mesh_path, name="main")
        e.add_object(ply2, mesh2, name="side")
    return jed, ed


def _jcfg(max_per_tile=1024):
    return jrast.RasterizerConfig(width=W, height=H, max_per_tile=max_per_tile,
                                  use_pallas=False)


def _cfg(max_per_tile=1024, **kw):
    return rasterize.RasterizerConfig(width=W, height=H,
                                      max_per_tile=max_per_tile, **kw)


def test_scene_editor_render_matches_jax(scene):
    """Two objects (one twisted) and a background PLY at 64 px: within 3e-5."""
    jed, ed = _editors(scene)
    v_def = twist(scene[0][2])
    jed.deform_object("main", v_def)
    ed.deform_object("main", v_def)
    cam = look_at_camera(W, H, distance=4.0)
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    want = jed.render(cam, _jcfg(), bg_color=jnp.asarray(bg))
    got = ed.render(_cam_t(cam), _cfg(), bg_color=bg)
    assert (got.final_t.numpy() < 0.5).mean() > 0.1          # the scene is in view
    np.testing.assert_allclose(got.color.numpy(), np.asarray(want.color), atol=3e-5)
    for k in ("num_rendered", "tile_overflow", "rect_overflow"):
        assert int(getattr(got, k)) == int(getattr(want, k)), k


def _jax_static(jed, cam):
    a = jed.objects["side"].arrays(cam)
    return jconcat(a, jed._bg_arrays(cam))


@pytest.mark.parametrize("max_per_tile", [1024, 12])
def test_rasterize_composite_matches_jax(scene, max_per_tile):
    """`rasterize_composite` on the JAX package's arrays: colour within 3e-5
    of the JAX package's, overflow counters equal (a clamped max_per_tile
    drops pairs)."""
    jed, _ = _editors(scene)
    cam = look_at_camera(W, H, distance=4.0)
    jcfg, cfg = _jcfg(max_per_tile), _cfg(max_per_tile)
    st = _jax_static(jed, cam)
    jstatic = jrast.precompute_static_pairs(st.xyz, st.cov6, st.opacity, st.rgb,
                                            cam, jcfg, active_mask=st.active)
    dyn = jruntime.deformed_object_arrays(jed.objects["main"],
                                          jnp.asarray(twist(scene[0][2])), cam)
    bg = jnp.asarray([0.1, 0.2, 0.3])
    want = jrast.rasterize_composite(dyn.xyz, dyn.cov6, dyn.opacity, dyn.rgb, bg,
                                     cam, jcfg, jstatic, active_mask=dyn.active)
    static = rasterize.precompute_static_pairs(
        *(_t(x) for x in (st.xyz, st.cov6, st.opacity, st.rgb)), _cam_t(cam), cfg,
        active_mask=_t(st.active))
    got = rasterize.rasterize_composite(
        *(_t(x) for x in (dyn.xyz, dyn.cov6, dyn.opacity, dyn.rgb, bg)),
        _cam_t(cam), cfg, static, active_mask=_t(dyn.active))
    np.testing.assert_allclose(got.color.numpy(), np.asarray(want.color), atol=3e-5)
    for k in ("num_rendered", "tile_overflow", "rect_overflow"):
        assert int(getattr(got, k)) == int(getattr(want, k)), k
    assert (int(got.tile_overflow) > 0) == (max_per_tile == 12)


@pytest.mark.parametrize("max_per_tile", [1024, 12])
def test_composite_frame_equals_own_render(scene, max_per_tile):
    """The composite frame equals `SceneEditor.render` of the same deformed
    scene exactly (the same emission order, so the same sort), clamped or
    not, and returns the frame's overflow counters."""
    _, ed = _editors(scene)
    cam = _cam_t(look_at_camera(W, H, distance=4.0))
    cfg = _cfg(max_per_tile)
    bg = [0.1, 0.2, 0.3]
    frame_fn = runtime.make_composite_playback_fn(ed, "main", cam, cfg, bg)
    for v_def in (scene[0][2], twist(scene[0][2])):
        got = frame_fn(torch.tensor(v_def))
        ed.deform_object("main", v_def)
        want = ed.render(cam, cfg, bg_color=bg)
        assert torch.equal(got.color, want.color)
        for k in ("num_rendered", "tile_overflow", "rect_overflow"):
            assert torch.equal(getattr(got, k), getattr(want, k)), k
    assert (int(got.tile_overflow) > 0) == (max_per_tile == 12)


def test_composite_frame_counts_static_overflow(scene):
    """A static pair capacity too small for the static set: each frame's
    rect_overflow includes the static precompute's."""
    _, ed = _editors(scene)
    cam = _cam_t(look_at_camera(W, H, distance=4.0))
    cfg = _cfg()
    tight = _cfg(pair_capacity_per_gaussian=1, row_capacity_per_gaussian=1)
    frame = runtime.make_composite_playback_fn(ed, "main", cam, cfg,
                                               static_cfg=tight)(scene[0][2])
    alone = runtime.make_playback_fn(ed.objects["main"], cam, cfg)(scene[0][2])
    concat = runtime.concat_arrays(ed.objects["side"].arrays(cam),
                                   ed._bg_arrays(cam))
    static = rasterize.precompute_static_pairs(
        concat.xyz, concat.cov6, concat.opacity, concat.rgb, cam, tight,
        active_mask=concat.active)
    assert int(static.pairs.rect_overflow) > 0
    assert int(frame.rect_overflow) == (int(static.pairs.rect_overflow)
                                        + int(alone.rect_overflow))
    with pytest.raises(ValueError):
        runtime.make_composite_playback_fn(
            ed, "main", cam, cfg, static_cfg=rasterize.RasterizerConfig(W, 2 * H))


def test_playback_sequence_equals_frames(tmp_path):
    ply, mesh_path, v, _ = jax_object(tmp_path)
    obj = runtime.ObjectDeformer(ply, mesh_path, device="cpu")
    cam = _cam_t(look_at_camera(W, H, distance=3.5))
    cfg = _cfg()
    seq = torch.tensor(np.stack([v, twist(v, 0.3), twist(v, -0.5)]))
    out = runtime.playback_sequence(obj, cam, cfg, seq, bg_color=[1.0, 1.0, 1.0])
    assert out.color.shape == (3, 3, H, W) and out.num_rendered.shape == (3,)
    frame_fn = runtime.make_playback_fn(obj, cam, cfg, [1.0, 1.0, 1.0])
    for i in range(3):
        one = frame_fn(seq[i])
        for k in one._fields:
            assert torch.equal(getattr(out, k)[i], getattr(one, k)), k
    assert not torch.equal(out.color[0], out.color[1])


# ---------------------------------------------------------------- cameras

def test_pose_paths_match_jax():
    center = np.array([0.1, -0.2, 0.3])
    args = [(pose_paths.ellipse_path, jpose.ellipse_path,
             (8, center, (3.0, 2.5), 1.0, 1.0, 0.8, 64, 48)),
            (pose_paths.spiral_path, jpose.spiral_path,
             (5, center, 2.0, (0.5, 1.5), 2.0, 1.0, 1.0, 64, 64)),
            (pose_paths.spherical_sample_path, jpose.spherical_sample_path,
             (5, center, 2.0, 1.0, 1.0, 64, 64))]
    for port_fn, jax_fn, a in args:
        got, want = port_fn(*a), jax_fn(*a)
        got += pose_paths.jitter_poses(got, seed=3)
        want += jpose.jitter_poses(want, seed=3)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert isinstance(g, cameras.Camera)
            for k in ("uid", "fovx", "fovy", "width", "height", "image_name"):
                assert getattr(g, k) == getattr(w, k), k
            assert np.array_equal(g.R, w.R) and np.array_equal(g.T, w.T)
            assert np.array_equal(g.world_view, w.world_view)


def test_cameras_json_round_trip(tmp_path):
    """`camera_from_json` of a JAX-written cameras.json gives the JAX
    package's cameras; the port writes the same entries."""
    cams = jpose.ellipse_path(3, np.zeros(3), (3.0, 3.0), 1.0, 1.1, 0.7, 96, 64)
    path = tmp_path / "cameras.json"
    path.write_text(json.dumps([jcameras.camera_to_json(i, c)
                                for i, c in enumerate(cams)]))
    loaded = runtime.SceneEditor.cameras_from_json(str(tmp_path))
    for i, (g, w) in enumerate(zip(loaded, cams)):
        want = jcameras.camera_from_json(jcameras.camera_to_json(i, w))
        np.testing.assert_allclose(g.world_view, want.world_view, atol=1e-6)
        np.testing.assert_allclose(g.world_view, w.world_view, atol=1e-5)
        assert (g.width, g.height, g.uid) == (w.width, w.height, i)
        assert abs(g.fovx - w.fovx) < 1e-9 and abs(g.fovy - w.fovy) < 1e-9
        mine = cameras.camera_to_json(i, g)
        theirs = jcameras.camera_to_json(i, want)
        assert mine.keys() == theirs.keys()
        np.testing.assert_allclose(mine["rotation"], theirs["rotation"], atol=1e-9)
        np.testing.assert_allclose(mine["position"], theirs["position"], atol=1e-9)


def test_entry_points_raise_without_a_card(tmp_path, monkeypatch):
    """No device given means CUDA: without a card the entry points raise
    rather than fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ply, mesh_path, v, f = jax_object(tmp_path)
    for make in (lambda: runtime.ObjectDeformer(ply, mesh_path),
                 lambda: runtime.SceneEditor(),
                 lambda: deform.MeshDeformer(v, f)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
