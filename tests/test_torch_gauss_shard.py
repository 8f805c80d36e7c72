"""The port's Gaussian-table shard (`gaussianmesh_tpu_torch/parallel/gauss_shard.py`,
the sharded densify, per-rank checkpoints, `MeshTrainer`'s `shard_gaussians`)
on the CPU: the band render and one step on 4 gloo ranks against the JAX
package's `rasterize_band_gauss_sharded` / `make_gauss_sharded_train_step`
on its virtual devices and against the port's single process; exact depth
ties across ranks; a starved send capacity; the one-process emulation; the
owner-side gather's K3 backward; the sharded densify against the JAX
package's contract; fault B9; the trainer with a per-rank checkpoint;
refusals; `cli.train_mesh --shard_gaussians 2`. The ranks are processes of
`tests/torch_dist_worker.py`, which imports no JAX; the JAX side runs in
this process."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from gaussianmesh_tpu.config import OptimizationParams as JOpt
from gaussianmesh_tpu.models import mesh_gaussians as jmgs
from gaussianmesh_tpu.models.render import GaussianArrays as JGaussianArrays
from gaussianmesh_tpu.ops.rasterize import RasterizerConfig as JRasterizerConfig
from gaussianmesh_tpu.parallel import gauss_shard as jgauss_shard
from gaussianmesh_tpu.train import densify as jdensify, optim as joptim
from gaussianmesh_tpu_torch.cli import render as cli_render
from gaussianmesh_tpu_torch.config import OptimizationParams, RuntimeParams
from gaussianmesh_tpu_torch.io import gaussian_ply
from gaussianmesh_tpu_torch.models import mesh_gaussians as mgs
from gaussianmesh_tpu_torch.models.render import GaussianArrays
from gaussianmesh_tpu_torch.ops import segsum
from gaussianmesh_tpu_torch.ops.rasterize import RasterizerConfig, rasterize
from gaussianmesh_tpu_torch.parallel import gauss_shard
from gaussianmesh_tpu_torch.train.trainer import DeviceDataset, MeshTrainer, deal_rows
from gaussianmesh_tpu_torch.utils import checkpoint as ckpt_mod
from tests.meshes import icosphere
from tests.scenes import look_at_camera, random_gaussians
from test_torch_e2e import make_dataset
from tests.test_torch_parallel import (_assert_params_close, _fields, _free_port,
                                       _port_cam, _port_model, _single_process_reference,
                                       _t, setup)  # noqa: F401 (setup: a fixture)
from tests.test_torch_train import _dataset
from tests.torch_dist_worker import ROOT, join, launch

torch.set_num_threads(2)

W = H = 64           # 4 tile rows: one per band on 4 ranks
D = 4
MAX_PER_TILE = 256
BG = np.array([0.1, 0.2, 0.3], np.float32)


def _scene(n, seed):
    return {k: np.asarray(v) for k, v in random_gaussians(n, seed=seed).items()
            if k in ("means3d", "cov6", "opacity", "rgb")}


def _tie_scene():
    """Each Gaussian of ranks 0 and 1 copied, with another color, into ranks
    2 and 3: every copy has its original's depth bits, so the blend order of
    each pair of copies is decided by the global id alone."""
    sc = _scene(100, seed=11)
    sc["opacity"] = np.full_like(sc["opacity"], 0.9)
    rgb = np.random.default_rng(12).uniform(0.05, 0.95, sc["rgb"].shape).astype(np.float32)
    return {k: np.concatenate([v, rgb if k == "rgb" else v]) for k, v in sc.items()}


def _torch_scene(sc):
    return {k: torch.tensor(v) for k, v in sc.items()}


@pytest.fixture(scope="module")
def bands(tmp_path_factory):
    """One launch of 4 ranks: the random scene and the tie scene through
    `rasterize_band_gauss_sharded` (pixels, opacity gradients of the sum of
    squared pixels), and the random scene with send_capacity 8."""
    work = str(tmp_path_factory.mktemp("gband"))
    cam = look_at_camera(W, H, distance=3.5)
    scenes = {"random": _scene(400, seed=7), "ties": _tie_scene()}
    n_local = 400 // D
    torch.save({"scenes": {k: _torch_scene(v) for k, v in scenes.items()},
                "cam": list(_port_cam(cam)), "width": W, "height": H,
                "max_per_tile": MAX_PER_TILE, "send_capacity": 10 * n_local,
                "bg": torch.tensor(BG), "mesh": (1, D)}, os.path.join(work, "gband_in.pt"))
    return cam, scenes, launch("gband", D, work)


def _port_single(sc, cam, band=None):
    """The port's single-process render of a scene, and the opacity gradient
    of the sum of its squared pixels."""
    t = _torch_scene(sc)
    op = t["opacity"].clone().requires_grad_()
    out = rasterize(t["means3d"], t["cov6"], op, t["rgb"], torch.tensor(BG),
                    _port_cam(cam), RasterizerConfig(W, H, MAX_PER_TILE), band=band)
    (out.color * out.color).sum().backward()
    return out.color.detach().numpy(), op.grad.numpy()


def _jax_band_render(sc, cam, send_capacity):
    mesh = Mesh(np.asarray(jax.devices()[:D]), ("shard",))
    cfg = JRasterizerConfig(width=W, height=H, max_per_tile=MAX_PER_TILE,
                            use_pallas=False)

    def body(xyz, cov6, op, rgb):
        arrays = JGaussianArrays(xyz=xyz, cov6=cov6, opacity=op, rgb=rgb,
                                 active=jnp.ones(xyz.shape[0], bool))
        return jgauss_shard.rasterize_band_gauss_sharded(
            arrays, cam, cfg, gy_local=1, axis_name="shard",
            send_capacity=send_capacity, bg=jnp.asarray(BG)).color

    fn = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(P("shard"),) * 4,
                               out_specs=P(None, "shard", None), check_vma=False))
    args = [jnp.asarray(sc[k]) for k in ("means3d", "cov6", "opacity", "rgb")]
    img = fn(*args)
    grad = jax.grad(lambda op: jnp.sum(fn(args[0], args[1], op, args[3]) ** 2))(args[2])
    return np.asarray(img), np.asarray(grad)


# ------------------------------------------------------------------ render

def test_band_render_matches_jax_and_rasterize(bands):
    """4 bands of 64x64 from 4 shards: pixels within 1e-5 of the JAX
    package's sharded render and of the port's `rasterize`, opacity
    gradients within 1e-5 of the largest (tests/test_parallel.py:193-251)."""
    cam, scenes, outs = bands
    img = np.concatenate([o["random"]["color"].numpy() for o in outs], 1)
    grad = np.concatenate([o["random"]["grad"].numpy() for o in outs])
    assert all(o["random"]["send_overflow"] == 0 and o["random"]["tile_overflow"] == 0
               for o in outs)
    assert sum(o["random"]["sent"] for o in outs) == sum(
        o["random"]["num_rendered"] for o in outs) > 0
    ref, ref_grad = _port_single(scenes["random"], cam)
    np.testing.assert_allclose(img, ref, atol=1e-5)
    scale = np.abs(ref_grad).max()
    np.testing.assert_allclose(grad / scale, ref_grad / scale, atol=1e-5)
    jimg, jgrad = _jax_band_render(scenes["random"], cam, 10 * (400 // D))
    np.testing.assert_allclose(img, jimg, atol=1e-5)
    np.testing.assert_allclose(grad / scale, jgrad / scale, atol=1e-5)


def test_exact_depth_ties_across_ranks_keep_the_single_process_order(bands):
    """Copies with their originals' depth bits on other ranks: each band
    equals the port's single-process render of that band bit for bit, and
    the copies' colors show (the tie order matters)."""
    cam, scenes, outs = bands
    for t, o in enumerate(outs):
        want, _ = _port_single(scenes["ties"], cam, band=(t, 1))
        np.testing.assert_array_equal(o["ties"]["color"].numpy(), want)
    swapped = {k: np.concatenate([v[100:], v[:100]]) for k, v in scenes["ties"].items()}
    img = np.concatenate([o["ties"]["color"].numpy() for o in outs], 1)
    assert np.abs(img - _port_single(swapped, cam)[0]).max() > 1e-3


def test_starved_send_capacity_reports_overflow(bands):
    """send_capacity 8 drops pairs, and says so in `send_overflow`."""
    _, _, outs = bands
    assert sum(o["starved_send_overflow"] for o in outs) > 0


def test_emulated_single_shard_equals_rasterize():
    """`emulate_d=1` (one process, the exchange an identity, one band) is
    the plain render: within 3e-5 of `rasterize`."""
    sc = _torch_scene(_scene(300, seed=3))
    cam = _port_cam(look_at_camera(W, 48, distance=3.5))
    cfg = RasterizerConfig(W, 48, MAX_PER_TILE)
    arrays = GaussianArrays(sc["means3d"], sc["cov6"], sc["opacity"], sc["rgb"],
                            torch.ones(300, dtype=torch.bool))
    out = gauss_shard.rasterize_band_gauss_sharded(arrays, cam, cfg, None, 3000,
                                                   torch.tensor(BG), emulate_d=1)
    ref = rasterize(sc["means3d"], sc["cov6"], sc["opacity"], sc["rgb"],
                    torch.tensor(BG), cam, cfg)
    np.testing.assert_allclose(out.color.detach().numpy(), ref.color.numpy(), atol=3e-5)
    assert int(out.send_overflow) == 0 and torch.equal(out.radii, ref.radii)


@pytest.mark.parametrize("capacity", [64, 5])
def test_owner_side_gather_backward_is_a_float64_index_add(capacity):
    """`segsum.gather_rows`: forward the slot rows; backward (K3 over the
    emission order) equals a float64 `index_add_` of the slot cotangents
    onto each pair's Gaussian, dropped pairs (capacity 5) contributing
    nothing."""
    rng = np.random.default_rng(4)
    n, d = 40, 3
    counts = rng.integers(0, 6, n)
    gid = np.repeat(np.arange(n), counts)
    dest = torch.tensor(rng.integers(0, d, gid.shape[0]))
    slot, overflow = gauss_shard.send_slots(dest, d, capacity)
    assert (int(overflow) > 0) == (capacity == 5)
    s = d * capacity
    slot_gid = torch.full((s + 1,), n, dtype=torch.int64)
    slot_gid[slot] = torch.tensor(gid)
    feat = torch.tensor(rng.normal(size=(n + 1, segsum.FEAT)).astype(np.float32))
    feat[n] = 0.0
    feat.requires_grad_()
    send = segsum.gather_rows(feat, slot_gid[:s], slot.to(torch.int32),
                              segsum.segment_starts(torch.tensor(counts, dtype=torch.int32)))
    kept = slot < s
    assert torch.equal(send[slot[kept]], feat.detach()[torch.tensor(gid)[kept]])
    w = torch.tensor(rng.normal(size=(s, segsum.FEAT)).astype(np.float32))
    (send * w).sum().backward()
    want = torch.zeros((n + 1, segsum.FEAT), dtype=torch.float64)
    want.index_add_(0, torch.tensor(gid)[kept], w[slot[kept]].double())
    np.testing.assert_array_equal(feat.grad.numpy(), want.float().numpy())


# -------------------------------------------------------------------- step

def _capture(p, b, mv, st):
    """A JAX state as the JAX trainer's capture() would carry it, as tensors."""
    zeros = {k: torch.zeros_like(torch.tensor(v)) for k, v in _fields(p).items()}
    return {"params": _t(_fields(p)), "binding": _t(_fields(b)), "mesh_v": _t(_fields(mv)),
            "state": _t(_fields(st)), "mu": zeros, "nu": dict(zeros), "step": 0,
            "sh_degree": 0}


def _gstep(tmp_path, model, cam, gt, h, send_capacity):
    torch.save({"capture": _capture(*model), "cam": list(_port_cam(cam)),
                "gt": torch.tensor(gt), "bg": torch.tensor([0.2, 0.4, 0.6]),
                "width": W, "height": h, "max_per_tile": 128,
                "send_capacity": send_capacity, "mesh": (1, D)},
               str(tmp_path / "gstep_in.pt"))
    outs = launch("gstep", D, str(tmp_path))
    params = {k: torch.cat([o["params"][k] for o in outs]) for k in outs[0]["params"]}
    state = {k: torch.cat([o["state"][k] for o in outs]) for k in outs[0]["state"]}
    for o in outs[1:]:
        assert torch.equal(o["metrics"]["loss"], outs[0]["metrics"]["loss"])
    return outs[0]["metrics"], params, state


def test_gauss_sharded_step_matches_jax_and_single_process(setup, tmp_path):
    """One step on 4 gloo ranks from a carried-across JAX state against JAX's
    `make_gauss_sharded_train_step` on 4 virtual devices and the port's
    single process: loss 1e-4 relative, parameters 5e-4 of each leaf's
    largest, grad_accum 1e-5, denom exact."""
    p, b, mv, st, cams, gts = setup
    jopt = JOpt()
    tx = joptim.make_optimizer(joptim.mesh_lr_tree_fn(jopt, 1.0))
    jcfg = JRasterizerConfig(width=W, height=H, max_per_tile=128, use_pallas=False)
    send_cap = jcfg.expand_capacity(b.alive.shape[0] // D)
    step = jgauss_shard.make_gauss_sharded_train_step(
        Mesh(np.asarray(jax.devices()[:D]), ("shard",)), tx, jcfg, sh_degree=0,
        lambda_dssim=jopt.lambda_dssim, mr_weight=jopt.alpha_mrloss, width=W,
        height_valid=H, send_capacity=send_cap)
    bg = jnp.asarray([0.2, 0.4, 0.6])
    jp2, _, jst2, jm = step(p, tx.init(p), st, b, tuple(cams[0]), jnp.asarray(gts[0]), bg)

    metrics, params, state = _gstep(tmp_path, (p, b, mv, st), cams[0], gts[0], H, send_cap)
    assert int(metrics["overflow"]) == int(jm["tile_overflow"]) == 0
    assert float(metrics["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-4)
    _assert_params_close({k: v.numpy() for k, v in params.items()}, _fields(jp2))
    np.testing.assert_allclose(state["grad_accum"].numpy(), np.asarray(jst2.grad_accum),
                               atol=1e-5)
    np.testing.assert_array_equal(state["denom"].numpy(), np.asarray(jst2.denom))

    loss, new, grad_accum, denom = _single_process_reference(
        _port_model(p, b, mv, st), [_port_cam(cams[0])], [torch.tensor(gts[0])],
        torch.tensor([0.2, 0.4, 0.6]), OptimizationParams())
    assert float(metrics["loss"]) == pytest.approx(loss, rel=1e-4)
    _assert_params_close({k: v.numpy() for k, v in params.items()},
                         {k: v.numpy() for k, v in new.items()})
    np.testing.assert_allclose(state["grad_accum"].numpy(), grad_accum.numpy(), atol=1e-5)
    np.testing.assert_array_equal(state["denom"].numpy(), denom.numpy())


def test_gauss_sharded_step_pads_the_grid_not_the_projection(setup, tmp_path):
    """Fault B9 in this regime: at 64 x 48 (3 tile rows) on 4 shards the grid
    pads to 4 rows, the last band wholly past the image; the step matches
    the port's single process at the image's own height."""
    p, b, mv, st, _, _ = setup
    h = 48
    cam = look_at_camera(W, h, azimuth=0.3, distance=3.2)
    gt = np.random.default_rng(2).uniform(0, 1, (3, h, W)).astype(np.float32)
    metrics, params, state = _gstep(tmp_path, (p, b, mv, st), cam, gt, h, 1024)
    loss, new, grad_accum, denom = _single_process_reference(
        _port_model(p, b, mv, st), [_port_cam(cam)], [torch.tensor(gt)],
        torch.tensor([0.2, 0.4, 0.6]), OptimizationParams(), W, h)
    assert float(metrics["loss"]) == pytest.approx(loss, rel=1e-4)
    _assert_params_close({k: v.numpy() for k, v in params.items()},
                         {k: v.numpy() for k, v in new.items()})
    np.testing.assert_allclose(state["grad_accum"].numpy(), grad_accum.numpy(), atol=1e-5)
    np.testing.assert_array_equal(state["denom"].numpy(), denom.numpy())


# ----------------------------------------------------------------- densify

def test_sharded_densify_meets_the_single_table_contract(tmp_path):
    """The JAX package's contract (tests/test_parallel.py:437-523), with its
    single-table `densify_and_split` as the oracle: the same n_split, alive
    count and vertex count, the same multisets of children and of new pool
    entries, moments zeroed at the child slots, `vertex_index` consistent
    with the replicated pool on every rank."""
    v, f = icosphere(1)
    p, b, mv, st = jmgs.create_from_mesh(jnp.asarray(v), jnp.asarray(f), capacity=256,
                                         vertex_capacity=1024)
    tx = joptim.make_optimizer(joptim.mesh_lr_tree_fn(JOpt(), 1.0))
    mu = jax.tree.map(lambda x: x + 0.25, tx.init(p).adam.mu)
    nu = tx.init(p).adam.nu
    state = deal_rows({"params": _t(_fields(p)), "binding": _t(_fields(b)),
                       "state": _t(_fields(st)), "mu": _t(_fields(mu)),
                       "nu": _t(_fields(nu))}, D)
    rng = np.random.default_rng(5)
    alive = state["binding"]["alive"].numpy()
    hot = rng.choice(np.flatnonzero(alive), size=12, replace=False)
    grads = np.zeros(alive.shape[0], np.float32)
    grads[hot] = rng.uniform(1.0, 2.0, 12)
    torch.save({**state, "mesh_v": _t(_fields(mv)), "grads": torch.tensor(grads),
                "mesh": (1, D)}, str(tmp_path / "gdensify_in.pt"))
    outs = launch("gdensify", D, str(tmp_path))

    jp, jb = (type(x)(**{k: jnp.asarray(v.numpy()) for k, v in state[name].items()})
              for x, name in ((p, "params"), (b, "binding")))
    jmu, jnu = (type(mu)(**{k: jnp.asarray(v.numpy()) for k, v in state[name].items()})
                for name in ("mu", "nu"))
    want = jdensify.densify_and_split(jp, jb, mv, jmu, jnu, st, jnp.asarray(grads), 0.5,
                                      5, max_split=64)
    assert int(want.n_split) == 12 and int(want.dropped) == 0
    for o in outs:
        assert (o["n_split"], o["dropped"]) == (12, 0)
        assert o["mesh_v"]["count"] == int(want.mesh_v.count)
        assert torch.equal(o["mesh_v"]["v"], outs[0]["mesh_v"]["v"])
    got = {k: {f: torch.cat([o[k][f] for o in outs]).numpy() for f in outs[0][k]}
           for k in ("params", "binding", "mu")}
    al = got["binding"]["alive"]
    assert al.sum() == int(want.binding.alive.sum())

    def content(params, binding):
        a = np.asarray(binding["alive"])
        m = mgs.from_numpy(params, binding, device="cpu")
        rows = np.concatenate([m.get_xyz().detach().numpy()[a], np.asarray(params["scaling"])[a]]
                              + [np.asarray(binding[k])[a] for k in ("vertex1", "vertex2",
                                                                     "vertex3")], 1)
        return rows[np.lexsort(rows.T[::-1])]

    np.testing.assert_allclose(content(got["params"], got["binding"]),
                               content(_fields(want.params), _fields(want.binding)),
                               atol=1e-6)
    lo, hi = int(mv.count), int(want.mesh_v.count)

    def new_verts(pool):
        arr = np.asarray(pool)[lo:hi]
        return arr[np.lexsort(arr.T[::-1])]

    np.testing.assert_allclose(new_verts(outs[0]["mesh_v"]["v"].numpy()),
                               new_verts(want.mesh_v.v), atol=1e-6)
    children = al & ~alive
    assert children.sum() == 12 * 5 and np.all(got["mu"]["bc"][children] == 0.0)
    pool = outs[0]["mesh_v"]["v"].numpy()
    vi = got["binding"]["vertex_index"]
    for k in range(3):
        np.testing.assert_allclose(pool[vi[al, k]], got["binding"][f"vertex{k + 1}"][al],
                                   atol=1e-6)


# ----------------------------------------------------------------- trainer

def test_mesh_trainer_shard_resumes_bit_for_bit(tmp_path):
    """`MeshTrainer(shard_gaussians=4)`, 30 iterations through resets and
    densifies: ranks agree on the loss; a fresh trainer resumed from the
    per-rank checkpoint at 16 ends with the uninterrupted run's bits; the
    same checkpoint loads into a single-process trainer as the joined
    shards."""
    stacks, images = _dataset()
    v, f = icosphere(1)
    ckpt_dir = tmp_path / "ckpt"
    ckpt_dir.mkdir()
    stacks_t = [torch.tensor(x.astype(np.float32)) for x in stacks]
    torch.save({"stacks": stacks_t, "images": torch.tensor(images), "width": W, "height": H,
                "v": torch.tensor(v), "f": torch.tensor(f), "iterations": 30, "at": 16,
                "dir": str(ckpt_dir)}, str(tmp_path / "gtrainer_in.pt"))
    outs = launch("gtrainer", D, str(tmp_path), timeout=240)
    for o in outs:
        assert o["resumed_hash"] == o["hash"] and o["global_it"] == 30
        assert o["losses"] == outs[0]["losses"] and o["events"] == outs[0]["events"]
    got = outs[0]
    kinds = [(it, kind) for it, kind, _ in got["events"]]
    assert kinds == [(3, "opacity_reset"), (4, "densify"), (8, "densify"),
                     (10, "opacity_reset"), (12, "densify"), (16, "densify"),
                     (20, "densify"), (20, "opacity_reset"), (24, "densify")], kinds
    assert sum(info["n_split"] for _, kind, info in got["events"] if kind == "densify") > 0
    assert got["n_alive"] > 320 and np.isfinite(got["losses"]).all()
    assert got["path"] == str(ckpt_dir / "chkpnt.ckpt.shards")
    assert sorted(os.listdir(got["path"])) == ["index.json", "rank0.pt", "rank1.pt",
                                               "rank2.pt", "rank3.pt", "replicated.pt"]

    ds = DeviceDataset(*stacks_t, images=torch.tensor(images), masks=None, width=W, height=H)
    single = MeshTrainer(v, f, ds, OptimizationParams(), RuntimeParams(max_per_tile=256),
                         spatial_lr_scale=3.2, init_target=300, max_sh_degree=1)
    single.load_ckpt(str(ckpt_dir / "chkpnt.ckpt"))
    joined = ckpt_mod.join_shards([o["capture"] for o in outs])
    cap = single.capture()
    for tree in ckpt_mod.ROW_TREES:
        for k, x in joined[tree].items():
            assert torch.equal(cap[tree][k], x), (tree, k)
    assert cap["global_it"] == 16 and torch.equal(cap["mesh_v"]["v"],
                                                  got["capture"]["mesh_v"]["v"])


def test_shard_regime_refusals(monkeypatch):
    """`shard_gaussians` with data or tile axes raises, and so does a world
    of another size than the shard count."""
    stacks, images = _dataset()
    ds = DeviceDataset(*(torch.tensor(x.astype(np.float32)) for x in stacks),
                       images=torch.tensor(images), masks=None, width=W, height=H)
    v, f = icosphere(1)
    for rt in (RuntimeParams(shard_gaussians=4, data_axis=2),
               RuntimeParams(shard_gaussians=2, tile_axis=2)):
        with pytest.raises(ValueError, match="exclusive"):
            MeshTrainer(v, f, ds, OptimizationParams(), rt, spatial_lr_scale=3.2,
                        init_target=100)
    with monkeypatch.context() as m:     # a world of 4 processes
        m.setattr(torch.distributed, "is_initialized", lambda: True)
        m.setattr(torch.distributed, "get_world_size", lambda group=None: 4)
        with pytest.raises(RuntimeError, match="world of 2"):
            MeshTrainer(v, f, ds, OptimizationParams(), RuntimeParams(shard_gaussians=2),
                        spatial_lr_scale=3.2, init_target=100)


def test_cli_train_mesh_shard_gaussians_on_two_ranks(tmp_path):
    """`cli.train_mesh --shard_gaussians 2 --device cpu` on 2 ranks from
    torchrun's variables, with a per-rank checkpoint: rank 0 writes a model
    directory that `cli.render` reads."""
    data = str(tmp_path / "data")
    proxy = make_dataset(data, n_cams=6)
    out = str(tmp_path / "model")
    flags = ["-s", data, "-m", out, "--input_mesh", proxy, "--init_target", "300",
             "--sh_degree", "1", "--max_per_tile", str(MAX_PER_TILE), "--iterations", "4",
             "--save_iterations", "4", "--test_iterations", "4",
             "--checkpoint_iterations", "2", "--device", "cpu", "--shard_gaussians", "2"]
    env = {**os.environ, "OMP_NUM_THREADS": "1", "GM_DIST_TIMEOUT": "60",
           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(_free_port()),
           "WORLD_SIZE": "2", "LOCAL_WORLD_SIZE": "2"}
    procs = [subprocess.Popen(
        [sys.executable, "-m", "gaussianmesh_tpu_torch.cli.train_mesh"] + flags,
        cwd=ROOT, env={**env, "RANK": str(r), "LOCAL_RANK": str(r)},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(2)]
    logs = join(procs, 120, "rank")
    assert "Gaussian table sharded over 2 ranks" in logs[0] and "[train]" not in logs[1]
    assert sorted(os.listdir(os.path.join(out, "chkpnt2.ckpt.shards"))) == [
        "index.json", "rank0.pt", "rank1.pt", "replicated.pt"]
    model, _ = gaussian_ply.load_mesh_gaussian_ply(
        os.path.join(out, "point_cloud", "iteration_4", "point_cloud.ply"), device="cpu")
    assert model.capacity == 320        # the alive rows of both shards
    cli_render.main(["-m", out, "--skip_test", "--device", "cpu"])
    assert len(os.listdir(os.path.join(out, "train", "ours_4", "renders"))) == 6
