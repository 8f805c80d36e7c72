"""The port's (data, tile) regime (`gaussianmesh_tpu_torch/parallel/`) on the
CPU: band rendering against the port's and the JAX package's, the halo
exchange, the sharded step and playback on 4 gloo ranks against the JAX
package's shard_map versions on its 8 virtual devices and against the port's
single process, `MeshTrainer` at data 2 x tile 2, and `cli.train_mesh` on 2
ranks. The ranks are processes of `tests/torch_dist_worker.py`, which
imports no JAX; the JAX side runs in this process."""

import os
import socket
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianmesh_tpu.config import OptimizationParams as JOpt
from gaussianmesh_tpu.edit.runtime import SceneEditor as JSceneEditor
from gaussianmesh_tpu.models import mesh_gaussians as jmgs
from gaussianmesh_tpu.models import render as jrender
from gaussianmesh_tpu.ops.rasterize import RasterizerConfig as JRasterizerConfig
from gaussianmesh_tpu.parallel import sharding as jsharding, train_step as jpts
from gaussianmesh_tpu.parallel.edit_step import make_sharded_playback_fn as jplayback
from gaussianmesh_tpu.train import optim as joptim
from gaussianmesh_tpu_torch.config import OptimizationParams, RuntimeParams
from gaussianmesh_tpu_torch.edit import runtime
from gaussianmesh_tpu_torch.io import gaussian_ply
from gaussianmesh_tpu_torch.models import mesh_gaussians as mgs
from gaussianmesh_tpu_torch.models import render as render_mod
from gaussianmesh_tpu_torch.ops.rasterize import RasterizerConfig
from gaussianmesh_tpu_torch.parallel import multihost, sharding, train_step as pts
from gaussianmesh_tpu_torch.train import densify, loss as loss_mod
from gaussianmesh_tpu_torch.train.optim import Adam, mesh_lr_fn
from gaussianmesh_tpu_torch.train.trainer import DeviceDataset, MeshTrainer
from gaussianmesh_tpu_torch.utils.graphics import CameraArrays
from tests.meshes import icosphere
from tests.scenes import look_at_camera
from test_torch_e2e import make_dataset
from tests.test_torch_train import _dataset
from tests.torch_dist_worker import ROOT, join, launch

torch.set_num_threads(2)

W = H = 64          # 4 x 4 tiles
MAX_PER_TILE = 128
BG = np.array([0.2, 0.4, 0.6], np.float32)


def _fields(x) -> dict:
    return {f: np.asarray(getattr(x, f)) for f in type(x).__dataclass_fields__}


def _t(tree) -> dict:
    return {k: torch.tensor(v) for k, v in tree.items()}


@pytest.fixture(scope="module")
def setup():
    """The JAX test's scene (tests/test_parallel.py): icosphere 1 at capacity
    128, two cameras, seeded ground truths."""
    v, f = icosphere(1)
    p, b, mv, st = jmgs.create_from_mesh(jnp.asarray(v), jnp.asarray(f),
                                         capacity=128, vertex_capacity=512)
    cams = [look_at_camera(W, H, azimuth=a, distance=3.2) for a in (0.3, 2.1)]
    rng = np.random.default_rng(0)
    gts = [rng.uniform(0, 1, (3, H, W)).astype(np.float32) for _ in cams]
    return p, b, mv, st, cams, gts


def _port_model(p, b, mv, st):
    return mgs.from_numpy(_fields(p), _fields(b), device="cpu", mesh_v=_fields(mv),
                          state=_fields(st))


def _port_cam(cam) -> CameraArrays:
    return CameraArrays.from_numpy(*[np.asarray(x) for x in cam], device="cpu")


# ------------------------------------------------------------------- bands

@pytest.mark.parametrize("n_bands", [2, 4])
def test_bands_stitch_into_the_full_render(setup, n_bands):
    """Bands rendered one at a time tile into the port's full render and
    match the JAX package's `rasterize_band` (2e-5, its own bar)."""
    p, b, mv, st, cams, _ = setup
    model = _port_model(p, b, mv, st)
    cfg = RasterizerConfig(W, H, MAX_PER_TILE)
    jcfg = JRasterizerConfig(width=W, height=H, max_per_tile=MAX_PER_TILE,
                             use_pallas=False)
    gy_local = 4 // n_bands
    for cam in cams:
        tc = _port_cam(cam)
        with torch.no_grad():
            a = render_mod.mesh_model_arrays(model, tc, 0)
            full = render_mod.render(a, tc, cfg, torch.tensor(BG))
            bands = [pts.rasterize_band(a, tc, cfg, gy_local, i * gy_local,
                                        torch.tensor(BG)) for i in range(n_bands)]
        stitched = torch.cat([o.color for o in bands], 1)
        np.testing.assert_allclose(stitched.numpy(), full.color.numpy(), atol=2e-5)
        assert all(torch.equal(o.radii, full.radii) for o in bands)
        ja = jrender.mesh_model_arrays(p, b, cam, 0)
        jbands = [jpts.rasterize_band(ja, cam, jcfg, gy_local, jnp.int32(i * gy_local),
                                      jnp.asarray(BG)) for i in range(n_bands)]
        for o, jo in zip(bands, jbands):
            np.testing.assert_allclose(o.color.numpy(), np.asarray(jo.color), atol=2e-5)
            np.testing.assert_array_equal(o.radii.numpy(), np.asarray(jo.radii))


def test_band_with_nothing_visible_is_background(setup):
    """A band no Gaussian reaches renders the background, with the grad path
    intact (a rank with an empty band still runs the backward)."""
    p, b, mv, st, _, _ = setup
    model = _port_model(p, b, mv, st)
    cam = _port_cam(look_at_camera(W, 8 * 16, distance=12.0, elevation=0.0))
    cfg = RasterizerConfig(W, 8 * 16, MAX_PER_TILE)
    a = render_mod.mesh_model_arrays(model, cam, 0)
    out = pts.rasterize_band(a, cam, cfg, 1, 0, torch.tensor(BG))
    assert int(out.num_rendered) == 0
    np.testing.assert_allclose(out.color.detach().numpy(),
                               np.broadcast_to(BG[:, None, None], (3, 16, W)))
    g = torch.autograd.grad(out.color.sum(), model.opacity, allow_unused=True)[0]
    assert g is not None and float(g.abs().sum()) == 0.0


# -------------------------------------------------------------------- halo

def test_halo_exchange_rows_on_4_ranks(tmp_path):
    """Forward: zero-padded slicing of the full image; backward: the
    gradient of the same sum taken through that slicing."""
    rng = np.random.default_rng(1)
    halo, rows = 5, 8
    full = torch.tensor(rng.normal(size=(2, 3, 4 * rows, 7)).astype(np.float32))
    w = torch.tensor(rng.normal(size=(4, 2, 3, rows + 2 * halo, 7)).astype(np.float32))
    torch.save({"full": full, "w": w, "halo": halo, "mesh": (1, 4)},
               str(tmp_path / "halo_in.pt"))
    outs = launch("halo", 4, str(tmp_path))
    ref = full.clone().requires_grad_()
    padded = torch.nn.functional.pad(ref, (0, 0, halo, halo))
    total = 0.0
    for t, o in enumerate(outs):
        want = padded[..., t * rows:t * rows + rows + 2 * halo, :]
        np.testing.assert_array_equal(o["out"].numpy(), want.detach().numpy())
        total = total + (want * w[t]).sum()
    total.backward()
    got = torch.cat([o["grad"] for o in outs], -2)
    np.testing.assert_allclose(got.numpy(), ref.grad.numpy(), atol=1e-6)


# -------------------------------------------------------------------- step

def _single_process_reference(model, cams, gts, bg, opt, w=W, h=H):
    """The port on one process over the same views: the loss as the JAX
    test sets it (mean over views + mesh-restrict), Adam's first update,
    and the per-view densification statistics."""
    lam, mrw = opt.lambda_dssim, opt.alpha_mrloss
    cfg = RasterizerConfig(w, h, MAX_PER_TILE)
    params = model.params()
    total, grad_accum, denom = 0.0, 0.0, 0.0
    for cam, gt in zip(cams, gts):
        off = torch.zeros((model.capacity, 2), requires_grad=True)
        out = render_mod.render(render_mod.mesh_model_arrays(model, cam, 0), cam, cfg,
                                bg, mean2d_offset=off)
        view = ((1 - lam) * loss_mod.l1_loss(out.color, gt)
                + lam * (1 - loss_mod.ssim(out.color, gt)))
        total = total + view / len(cams)
        g_off = torch.autograd.grad(view, off, retain_graph=True)[0]
        st = densify.add_densification_stats(model.state, g_off, out.visibility, w, h)
        grad_accum = grad_accum + st.grad_accum - model.state.grad_accum
        denom = denom + st.denom - model.state.denom
    total = total + loss_mod.mesh_restrict_loss(model.get_scaling(), model.vertex1,
                                                model.vertex2, model.vertex3,
                                                model.alive, mrw)
    grads = torch.autograd.grad(total, list(params.values()), allow_unused=True)
    grads = {k: torch.zeros_like(p) if g is None else g
             for (k, p), g in zip(params.items(), grads)}
    adam = Adam(params, mesh_lr_fn(opt, 1.0))
    new = {k: v.detach().clone() for k, v in params.items()}
    adam.update(new, grads)
    return float(total.detach()), new, grad_accum.detach(), denom


def _assert_params_close(got: dict, want: dict, names=("bc", "distance", "opacity",
                                                        "scaling")):
    for name in names:
        a, r = np.asarray(got[name]), np.asarray(want[name])
        scale = np.abs(r).max() + 1e-8
        np.testing.assert_allclose(a / scale, r / scale, atol=5e-4, err_msg=name)


def test_sharded_step_matches_jax_and_single_process(setup, tmp_path):
    """One 2 x 2 step on 4 gloo ranks against JAX's `make_sharded_train_step`
    on `make_mesh(2, 2)` and the port's single process: loss 1e-4 relative,
    updated parameters 5e-4 of each leaf's largest value, grad_accum 1e-5,
    denom exactly; every rank ends with the same bits."""
    p, b, mv, st, cams, gts = setup
    opt = OptimizationParams()
    jopt = JOpt()
    tx = joptim.make_optimizer(joptim.mesh_lr_tree_fn(jopt, 1.0))
    jcfg = JRasterizerConfig(width=W, height=H, max_per_tile=MAX_PER_TILE,
                             use_pallas=False)
    step = jpts.make_sharded_train_step(jsharding.make_mesh(2, 2), tx, jcfg, 0,
                                        jopt.lambda_dssim, jopt.alpha_mrloss, W, H)
    cam_batch = tuple(jnp.stack([getattr(c, k) for c in cams])
                      for k in type(cams[0])._fields)
    jp2, _, jst2, jm = step(p, tx.init(p), st, b, cam_batch, jnp.stack(gts),
                            jnp.asarray(BG))

    outs = _sharded_step(tmp_path, (p, b, mv, st), cams, gts, (2, 2), W, H)
    for o in outs[1:]:
        for k in o["params"]:
            assert torch.equal(o["params"][k], outs[0]["params"][k]), k
        for k in ("grad_accum", "denom", "max_radii2d"):
            assert torch.equal(o["state"][k], outs[0]["state"][k]), k
    got = outs[0]
    assert int(got["metrics"]["tile_overflow"]) == 0

    assert float(got["metrics"]["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-4)
    _assert_params_close({k: v.numpy() for k, v in got["params"].items()},
                         _fields(jp2))
    np.testing.assert_allclose(got["state"]["grad_accum"].numpy(),
                               np.asarray(jst2.grad_accum), atol=1e-5)
    np.testing.assert_array_equal(got["state"]["denom"].numpy(), np.asarray(jst2.denom))
    np.testing.assert_array_equal(got["state"]["max_radii2d"].numpy(),
                                  np.asarray(jst2.max_radii2d))

    model = _port_model(p, b, mv, st)
    loss, new, grad_accum, denom = _single_process_reference(
        model, [_port_cam(c) for c in cams], [torch.tensor(g) for g in gts],
        torch.tensor(BG), opt)
    assert float(got["metrics"]["loss"]) == pytest.approx(loss, rel=1e-4)
    _assert_params_close({k: v.numpy() for k, v in got["params"].items()},
                         {k: v.numpy() for k, v in new.items()})
    np.testing.assert_allclose(got["state"]["grad_accum"].numpy(), grad_accum.numpy(),
                               atol=1e-5)
    np.testing.assert_array_equal(got["state"]["denom"].numpy(), denom.numpy())


def test_sharded_step_pads_the_grid_not_the_projection(setup, tmp_path):
    """At 64 x 48 (3 tile rows) on 2 bands the grid pads to 4 rows, the
    second band's lower half past the image: the step still matches the
    port's single process (the JAX trainer would render at 64 px high)."""
    p, b, mv, st, _, _ = setup
    h = 48
    cam = look_at_camera(W, h, azimuth=0.3, distance=3.2)
    gt = np.random.default_rng(2).uniform(0, 1, (3, h, W)).astype(np.float32)
    outs = _sharded_step(tmp_path, (p, b, mv, st), [cam], [gt], (1, 2), W, h)
    assert torch.equal(outs[0]["params"]["bc"], outs[1]["params"]["bc"])
    got = outs[0]
    loss, new, grad_accum, denom = _single_process_reference(
        _port_model(p, b, mv, st), [_port_cam(cam)], [torch.tensor(gt)],
        torch.tensor(BG), OptimizationParams(), W, h)
    assert float(got["metrics"]["loss"]) == pytest.approx(loss, rel=1e-4)
    _assert_params_close({k: v.numpy() for k, v in got["params"].items()},
                         {k: v.numpy() for k, v in new.items()})
    np.testing.assert_allclose(got["state"]["grad_accum"].numpy(), grad_accum.numpy(),
                               atol=1e-5)
    np.testing.assert_array_equal(got["state"]["denom"].numpy(), denom.numpy())


def _sharded_step(tmp_path, model, cams, gts, mesh, w, h):
    p, b, mv, st = model
    torch.save({"params": _t(_fields(p)), "binding": _t(_fields(b)),
                "mesh_v": _t(_fields(mv)), "state": _t(_fields(st)),
                "cams": [torch.tensor(np.stack([np.asarray(getattr(c, k)) for c in cams]))
                         for k in type(cams[0])._fields],
                "gts": torch.tensor(np.stack(gts)), "bg": torch.tensor(BG),
                "width": w, "height": h, "max_per_tile": MAX_PER_TILE, "mesh": mesh},
               str(tmp_path / "step_in.pt"))
    return launch("step", mesh[0] * mesh[1], str(tmp_path))


# ---------------------------------------------------------------- playback

def test_sharded_playback_matches_jax(tmp_path):
    """Two frames per call over the data axis, two bands each: the JAX
    package's `make_sharded_playback_fn` and the port's single-process
    `make_playback_fn` frames, to 2e-5."""
    from tests.test_edit import _make_object
    ply, mesh_path, _, _ = _make_object(tmp_path)
    jed = JSceneEditor()
    jed.add_object(ply, mesh_path, name="obj")
    cam = look_at_camera(W, H, distance=3.5)
    jcfg = JRasterizerConfig(width=W, height=H, max_per_tile=MAX_PER_TILE,
                             use_pallas=False)
    v, _ = icosphere(1)
    frames = np.stack([v * (1.0 + 0.2 * np.sin(i)) for i in range(2)]).astype(np.float32)
    want = np.asarray(jplayback(jsharding.make_mesh(2, 2), jed, "obj", cam, jcfg)(
        jnp.asarray(frames)))

    torch.save({"paths": [ply, mesh_path], "cam": list(_port_cam(cam)),
                "frames": torch.tensor(frames), "width": W, "height": H,
                "max_per_tile": MAX_PER_TILE, "mesh": (2, 2)},
               str(tmp_path / "playback_in.pt"))
    outs = launch("playback", 4, str(tmp_path))
    got = outs[0]["frames"].numpy()
    assert got.shape == (2, 3, H, W)
    for o in outs[1:]:
        assert torch.equal(o["frames"], outs[0]["frames"])
    np.testing.assert_allclose(got, want, atol=2e-5)
    obj = runtime.ObjectDeformer(ply, mesh_path, device="cpu")
    frame_fn = runtime.make_playback_fn(obj, _port_cam(cam),
                                        RasterizerConfig(W, H, MAX_PER_TILE))
    for i in range(2):
        np.testing.assert_allclose(got[i], frame_fn(frames[i]).color.numpy(), atol=2e-5)


# ----------------------------------------------------------------- trainer

def test_mesh_trainer_2x2_keeps_ranks_identical(tmp_path):
    """10 iterations at data 2 x tile 2 through a white-background reset (3),
    densify (4 and 8) and an interval reset (6): after every iteration the
    four ranks' parameters, binding, statistics and moments hash alike."""
    stacks, images = _dataset()
    v, f = icosphere(1)
    torch.save({"stacks": [torch.tensor(x.astype(np.float32)) for x in stacks],
                "images": torch.tensor(images), "width": W, "height": H,
                "v": torch.tensor(v), "f": torch.tensor(f), "iterations": 10},
               str(tmp_path / "trainer_in.pt"))
    outs = launch("trainer", 4, str(tmp_path))
    for o in outs[1:]:
        assert o["hashes"] == outs[0]["hashes"]
        assert o["losses"] == outs[0]["losses"]
    got = outs[0]
    kinds = [(it, kind) for it, kind, _ in got["events"]]
    assert kinds == [(3, "opacity_reset"), (4, "densify"), (6, "opacity_reset"),
                     (8, "densify")], kinds
    assert any(info["n_split"] > 0 for _, kind, info in got["events"]
               if kind == "densify")
    assert len(got["hashes"]) == 11 and len(set(got["hashes"])) == 11
    assert np.isfinite(got["losses"]).all()


def test_trainer_regime_needs_a_matching_world(monkeypatch):
    """The (data, tile) regime needs an initialised world of that size, and
    a world of N > 1 processes needs a mesh of N (the default 1 x 1
    included: every rank would otherwise train alone); so does the
    Gaussian-table shard."""
    stacks, images = _dataset()
    ds = DeviceDataset(*(torch.tensor(x.astype(np.float32)) for x in stacks),
                       images=torch.tensor(images), masks=None, width=W, height=H)
    v, f = icosphere(1)
    with pytest.raises(RuntimeError, match="torch.distributed"):
        MeshTrainer(v, f, ds, OptimizationParams(), RuntimeParams(data_axis=2),
                    spatial_lr_scale=3.2, init_target=100)
    with monkeypatch.context() as m:     # a world of 4 processes
        m.setattr(torch.distributed, "is_initialized", lambda: True)
        m.setattr(torch.distributed, "get_world_size", lambda group=None: 4)
        for rt in (RuntimeParams(), RuntimeParams(data_axis=2),
                   RuntimeParams(data_axis=2, tile_axis=3)):
            with pytest.raises(RuntimeError, match="world of"):
                MeshTrainer(v, f, ds, OptimizationParams(), rt,
                            spatial_lr_scale=3.2, init_target=100)
    with pytest.raises(RuntimeError, match="world of 4"):
        MeshTrainer(v, f, ds, OptimizationParams(), RuntimeParams(shard_gaussians=4),
                    spatial_lr_scale=3.2, init_target=100)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_train_mesh_on_two_ranks(tmp_path):
    """`cli.train_mesh --tile_axis 2 --device cpu` on 2 ranks from torchrun's
    variables: rank 0 alone writes the model directory, and its PLY matches
    a single-process run's to 5e-4 of each field's scale."""
    data = str(tmp_path / "data")
    proxy = make_dataset(data, n_cams=6)
    flags = ["-s", data, "--input_mesh", proxy, "--init_target", "300",
             "--sh_degree", "1", "--max_per_tile", str(MAX_PER_TILE), "--iterations", "4",
             "--save_iterations", "4", "--test_iterations", "4", "--device", "cpu"]
    module = [sys.executable, "-m", "gaussianmesh_tpu_torch.cli.train_mesh"]
    env = {**os.environ, "OMP_NUM_THREADS": "1", "GM_DIST_TIMEOUT": "60"}
    single = str(tmp_path / "single")
    join([subprocess.Popen(module + flags + ["-m", single], cwd=ROOT, env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)],
         120, "single process")
    sharded = str(tmp_path / "sharded")
    port = str(_free_port())
    procs = [subprocess.Popen(
        module + flags + ["-m", sharded, "--tile_axis", "2"], cwd=ROOT,
        env={**env, "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": port, "WORLD_SIZE": "2",
             "RANK": str(r), "LOCAL_RANK": str(r), "LOCAL_WORLD_SIZE": "2"},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(2)]
    logs = join(procs, 120, "rank")
    assert "process mesh: data 1 x tile 2" in logs[0] and "[train]" not in logs[1]
    ply = os.path.join("point_cloud", "iteration_4", "point_cloud.ply")
    a, _ = gaussian_ply.load_mesh_gaussian_ply(os.path.join(sharded, ply), device="cpu")
    b, _ = gaussian_ply.load_mesh_gaussian_ply(os.path.join(single, ply), device="cpu")
    assert a.capacity == b.capacity
    for name in mgs.PARAM_FIELDS:
        x, y = getattr(a, name).detach().numpy(), getattr(b, name).detach().numpy()
        scale = np.abs(y).max() + 1e-8
        np.testing.assert_allclose(x / scale, y / scale, atol=5e-4, err_msg=name)
    assert sorted(os.listdir(sharded)) == sorted(os.listdir(single))


# --------------------------------------------------------------- multihost

def test_multihost_helpers_single_process(monkeypatch):
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert multihost.initialize() is False           # no world: nothing to join
    assert multihost.process_camera_slice(10) == (0, 10)
    assert multihost.is_writer()
    multihost.barrier()
    assert sharding.band_rows(8, 4) == 2 and sharding.padded_grid_y(1080, 4) == 68
    with pytest.raises(ValueError):
        sharding.band_rows(6, 4)
    x = torch.arange(12.0).reshape(1, 3, 4)
    np.testing.assert_array_equal(sharding.halo_exchange_rows(x, 2, None).numpy(),
                                  np.pad(x.numpy(), ((0, 0), (2, 2), (0, 0))))
    monkeypatch.setenv("GM_DIST_TIMEOUT", "42")
    assert multihost.group_timeout().total_seconds() == 42


def test_nccl_with_more_ranks_than_cards_raises(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="nccl needs a card per rank"):
        multihost.initialize(backend="nccl")
