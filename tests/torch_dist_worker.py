"""Rank processes of the port's multi-process tests (`tests/test_torch_parallel.py`,
`tests/test_torch_gauss_shard.py`).

`launch(case, world, workdir)` starts `world` processes of

    python tests/torch_dist_worker.py <case> <rank> <world> <workdir>

each joining a gloo group from a `FileStore` in `workdir` (60 s timeout),
running one case on the CPU and writing `<case>_rank<r>.pt` (with
`GM_TEST_BACKEND=nccl`, an nccl group instead, rank r on card r); the parent
waits 120 s at most, kills what is left and raises on any failed rank.
Inputs come in `<workdir>/<case>_in.pt` (tensors only). This module imports
neither JAX nor the JAX package.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import sys
import time
from datetime import timedelta

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GROUP_TIMEOUT_S = 60
JOIN_TIMEOUT_S = 120


def launch(case: str, world: int, workdir: str, timeout: float = JOIN_TIMEOUT_S,
           extra_env: dict | None = None) -> list:
    """Run `case` on `world` ranks -> each rank's saved result, in rank order."""
    # run by path, the repository first on the path: a `tests` package
    # installed elsewhere would shadow `-m tests.torch_dist_worker`
    env = {**os.environ, "OMP_NUM_THREADS": "1", "GM_DIST_TIMEOUT": str(GROUP_TIMEOUT_S),
           "PYTHONPATH": os.pathsep.join([ROOT] + [p for p in [os.environ.get(
               "PYTHONPATH")] if p]), **(extra_env or {})}
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), case,
                               str(r), str(world), workdir], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(world)]
    join(procs, timeout, f"{case}: rank")
    return [torch.load(os.path.join(workdir, f"{case}_rank{r}.pt"), weights_only=False)
            for r in range(world)]


def join(procs, timeout: float, label: str) -> list[str]:
    """Wait for every process until `timeout` s; kill the rest and raise on
    expiry or on a non-zero exit. -> their outputs."""
    deadline = time.monotonic() + timeout
    outs, failed = [], []
    for r, p in enumerate(procs):
        try:
            out, _ = p.communicate(timeout=max(deadline - time.monotonic(), 0.1))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise RuntimeError(f"{label} {r} still running after {timeout} s: killed")
        outs.append(out)
        if p.returncode != 0:
            failed.append(f"{label} {r} exited {p.returncode}:\n{out[-4000:]}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return outs


def tensor_hash(tree) -> str:
    """sha256 of every tensor's bytes in a {name: tensor} tree, by name."""
    h = hashlib.sha256()
    for k in sorted(tree):
        v = tree[k]
        if torch.is_tensor(v):
            h.update(k.encode())
            h.update(v.detach().cpu().contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def state_hash(trainer) -> str:
    """One hash of a trainer's parameters, binding, state and both moments."""
    m = trainer.model
    parts = [m.params(), m.binding(), m.state._asdict(), trainer.adam.mu,
             trainer.adam.nu, {"v": m.mesh_v.v}]
    return hashlib.sha256("".join(tensor_hash(p) for p in parts).encode()).hexdigest()


# ------------------------------------------------------------------- cases

def case_halo(mesh, inp):
    """Each rank's band of a full image through `halo_exchange_rows`, and
    the gradient of sum(out * w) with w its own weights."""
    from gaussianmesh_tpu_torch.parallel import sharding
    full, w = inp["full"], inp["w"][mesh.rank]
    rows = full.shape[-2] // mesh.n_tile
    x = full[..., mesh.tile_index * rows:(mesh.tile_index + 1) * rows, :].clone()
    x.requires_grad_()
    out = sharding.halo_exchange_rows(x, inp["halo"], mesh)
    (out * w).sum().backward()
    return {"out": out.detach(), "grad": x.grad}


def _model(inp):
    from gaussianmesh_tpu_torch.models import mesh_gaussians as mgs
    return mgs.from_numpy({k: v.numpy() for k, v in inp["params"].items()},
                          {k: v.numpy() for k, v in inp["binding"].items()},
                          device="cpu",
                          mesh_v={k: v.numpy() for k, v in inp["mesh_v"].items()},
                          state={k: v.numpy() for k, v in inp["state"].items()})


def case_step(mesh, inp):
    """One sharded step from the given state: camera data_index, its gt."""
    from gaussianmesh_tpu_torch.config import OptimizationParams
    from gaussianmesh_tpu_torch.ops.rasterize import RasterizerConfig
    from gaussianmesh_tpu_torch.parallel import sharding, train_step as pts
    from gaussianmesh_tpu_torch.train.optim import Adam, mesh_lr_fn
    from gaussianmesh_tpu_torch.utils.graphics import CameraArrays
    model = _model(inp)
    opt = OptimizationParams()
    adam = Adam(model.params(), mesh_lr_fn(opt, 1.0))
    w, h = int(inp["width"]), int(inp["height"])
    cfg = RasterizerConfig(w, h, int(inp["max_per_tile"]))
    step = pts.make_sharded_train_step(mesh, adam, cfg, 0, opt.lambda_dssim,
                                       opt.alpha_mrloss, w, h)
    cam = CameraArrays(*(x[mesh.data_index] for x in inp["cams"]))
    padded = sharding.padded_grid_y(h, mesh.n_tile) * 16
    gt = torch.nn.functional.pad(inp["gts"][mesh.data_index], (0, 0, 0, padded - h))
    metrics = step(model, cam, gt, inp["bg"])
    return {"metrics": metrics, "params": {k: v.detach() for k, v in model.params().items()},
            "state": model.state._asdict()}


def case_playback(mesh, inp):
    from gaussianmesh_tpu_torch.edit.runtime import SceneEditor
    from gaussianmesh_tpu_torch.ops.rasterize import RasterizerConfig
    from gaussianmesh_tpu_torch.parallel.edit_step import make_sharded_playback_fn
    from gaussianmesh_tpu_torch.utils.graphics import CameraArrays
    editor = SceneEditor(device="cpu")
    editor.add_object(inp["paths"][0], inp["paths"][1], name="obj")
    w, h = int(inp["width"]), int(inp["height"])
    fn = make_sharded_playback_fn(mesh, editor, "obj", CameraArrays(*inp["cam"]),
                                  RasterizerConfig(w, h, int(inp["max_per_tile"])))
    return {"frames": fn(inp["frames"])}


def case_trainer(mesh, inp):
    """MeshTrainer at data 2 x tile 2: the state hash after every iteration
    and every event, and the losses."""
    from gaussianmesh_tpu_torch.config import OptimizationParams, RuntimeParams
    from gaussianmesh_tpu_torch.train.trainer import DeviceDataset, MeshTrainer
    ds = DeviceDataset(*inp["stacks"], images=inp["images"], masks=None,
                       width=int(inp["width"]), height=int(inp["height"]))
    opt = OptimizationParams(densify_from_iter=3, densification_interval=4,
                             densify_until_iter=9, opacity_reset_interval=6,
                             densify_grad_threshold=1e-6)
    rt = RuntimeParams(max_per_tile=256, data_axis=2, tile_axis=2)
    tr = MeshTrainer(inp["v"].numpy(), inp["f"].numpy(), ds, opt, rt,
                     spatial_lr_scale=3.2, init_target=300, max_sh_degree=1)
    assert tr.mesh is not None and (tr.mesh.n_data, tr.mesh.n_tile) == (2, 2)
    hashes, losses = [state_hash(tr)], []

    def cb(m):
        losses.append(m["loss"])
        hashes.append(state_hash(tr))

    tr.train(int(inp["iterations"]), log_every=1, callback=cb)
    return {"hashes": hashes, "losses": losses, "events": tr.events,
            "n_alive": int(tr.model.alive.sum())}


# ------------------------------------------------------ the Gaussian-table shard

def _shard_arrays(mesh, sc, requires_grad=False):
    """This rank's contiguous shard of a scene {means3d, cov6, opacity, rgb}."""
    from gaussianmesh_tpu_torch.models.render import GaussianArrays
    n, d, r = sc["means3d"].shape[0], mesh.n_tile, mesh.tile_index
    part = {k: v[r * n // d:(r + 1) * n // d].clone() for k, v in sc.items()}
    part["opacity"].requires_grad_(requires_grad)
    return GaussianArrays(part["means3d"], part["cov6"], part["opacity"], part["rgb"],
                          torch.ones(n // d, dtype=torch.bool)), part["opacity"]


def case_gband(mesh, inp):
    """Each scene's band through `rasterize_band_gauss_sharded`, and the
    gradient of the sum of its squared pixels in this rank's opacities; then
    the first scene with a starved send capacity."""
    from gaussianmesh_tpu_torch.ops.rasterize import RasterizerConfig
    from gaussianmesh_tpu_torch.parallel import gauss_shard
    from gaussianmesh_tpu_torch.utils.graphics import CameraArrays
    cam = CameraArrays(*inp["cam"])
    cfg = RasterizerConfig(int(inp["width"]), int(inp["height"]), int(inp["max_per_tile"]))
    out = {}
    for name, sc in inp["scenes"].items():
        arrays, op = _shard_arrays(mesh, sc, requires_grad=True)
        o = gauss_shard.rasterize_band_gauss_sharded(arrays, cam, cfg, mesh,
                                                     int(inp["send_capacity"]), inp["bg"])
        (o.color * o.color).sum().backward()
        out[name] = {"color": o.color.detach(), "grad": op.grad,
                     **{k: int(getattr(o, k)) for k in ("send_overflow", "tile_overflow",
                                                        "rect_overflow", "num_rendered",
                                                        "sent")}}
    with torch.no_grad():
        arrays, _ = _shard_arrays(mesh, next(iter(inp["scenes"].values())))
        o = gauss_shard.rasterize_band_gauss_sharded(arrays, cam, cfg, mesh, 8, inp["bg"])
    out["starved_send_overflow"] = int(o.send_overflow)
    return out


def case_gstep(mesh, inp):
    """One Gaussian-table-sharded step from this rank's rows of the given
    state (a JAX capture carried across), on one camera and its gt."""
    from gaussianmesh_tpu_torch.config import OptimizationParams
    from gaussianmesh_tpu_torch.models import mesh_gaussians as mgs
    from gaussianmesh_tpu_torch.ops.rasterize import RasterizerConfig
    from gaussianmesh_tpu_torch.parallel import gauss_shard, sharding
    from gaussianmesh_tpu_torch.train.optim import Adam, mesh_lr_fn
    from gaussianmesh_tpu_torch.train.trainer import trainer_state_from_numpy
    from gaussianmesh_tpu_torch.utils.checkpoint import shard_rows
    from gaussianmesh_tpu_torch.utils.graphics import CameraArrays
    state = shard_rows(trainer_state_from_numpy(
        {k: ({f: x.numpy() for f, x in v.items()} if isinstance(v, dict) else v)
         for k, v in inp["capture"].items()}, device="cpu"), mesh.rank, mesh.n_tile)
    model = mgs.MeshGaussianModel(state["params"], state["binding"],
                                  mesh_v=mgs.MeshVertices(**state["mesh_v"]),
                                  state=mgs.MeshGaussianState(**state["state"]))
    opt = OptimizationParams()
    adam = Adam(model.params(), mesh_lr_fn(opt, 1.0))
    w, h = int(inp["width"]), int(inp["height"])
    cfg = RasterizerConfig(w, h, int(inp["max_per_tile"]))
    step = gauss_shard.make_gauss_sharded_train_step(
        mesh, adam, cfg, 0, opt.lambda_dssim, opt.alpha_mrloss, w, h,
        int(inp["send_capacity"]))
    padded = sharding.padded_grid_y(h, mesh.n_tile) * 16
    gt = torch.nn.functional.pad(inp["gt"], (0, 0, 0, padded - h))
    metrics = step(model, CameraArrays(*inp["cam"]), gt, inp["bg"])
    return {"metrics": metrics, "params": {k: v.detach() for k, v in model.params().items()},
            "state": model.state._asdict()}


def case_gdensify(mesh, inp):
    """`densify_and_split_gauss_sharded` of this rank's rows of the given
    (already dealt) state, with its hot rows."""
    from gaussianmesh_tpu_torch.train import densify
    from gaussianmesh_tpu_torch.utils.checkpoint import shard_rows
    tree = shard_rows({"params": inp["params"], "binding": inp["binding"],
                       "state": inp["state"], "mu": inp["mu"], "nu": inp["nu"]},
                      mesh.rank, mesh.n_tile)
    model = _model({**inp, "params": tree["params"], "binding": tree["binding"],
                    "state": tree["state"]})
    res = densify.densify_and_split_gauss_sharded(
        mesh, model, tree["mu"], tree["nu"], inp["grads"].chunk(mesh.n_tile)[mesh.rank],
        0.5, 5, 64)
    m = res.model
    return {"params": {k: v.detach() for k, v in m.params().items()},
            "binding": m.binding(), "mesh_v": m.mesh_v._asdict(), "mu": res.mu,
            "n_split": res.n_split, "dropped": res.dropped}


def case_gtrainer(mesh, inp):
    """`MeshTrainer` with the Gaussian table sharded over the world: train to
    the checkpoint iteration, save a per-rank checkpoint, train on; then a
    fresh trainer resumed from the checkpoint trains as far. -> the state
    hashes of both runs, the events, the losses and this rank's capture at
    the checkpoint."""
    from gaussianmesh_tpu_torch.config import OptimizationParams, RuntimeParams
    from gaussianmesh_tpu_torch.train.trainer import DeviceDataset, MeshTrainer
    ds = DeviceDataset(*inp["stacks"], images=inp["images"], masks=None,
                       width=int(inp["width"]), height=int(inp["height"]))
    opt = OptimizationParams(densify_from_iter=3, densification_interval=4,
                             densify_until_iter=25, opacity_reset_interval=10,
                             densify_grad_threshold=1e-6)
    world = torch.distributed.get_world_size()
    rt = RuntimeParams(max_per_tile=256, shard_gaussians=world)

    def trainer():
        return MeshTrainer(inp["v"].numpy(), inp["f"].numpy(), ds, opt, rt,
                           spatial_lr_scale=3.2, init_target=300, max_sh_degree=1)

    tr = trainer()
    assert tr.n_shards == world and tr.model.capacity * world == 4096
    losses = []
    tr.train(int(inp["at"]), log_every=1, callback=lambda m: losses.append(m["loss"]))
    path = tr.save_ckpt(os.path.join(inp["dir"], "chkpnt.ckpt"))
    at_ckpt = tr.capture()
    tr.train(int(inp["iterations"]) - int(inp["at"]), log_every=1,
             callback=lambda m: losses.append(m["loss"]))
    resumed = trainer()
    resumed.load_ckpt(os.path.join(inp["dir"], "chkpnt.ckpt"))
    resumed.train(int(inp["iterations"]) - int(inp["at"]), log_every=1000)
    return {"hash": state_hash(tr), "resumed_hash": state_hash(resumed), "path": path,
            "events": tr.events, "losses": losses, "n_alive": tr.n_alive(),
            "capture": at_ckpt, "global_it": resumed.global_it}


def case_a2a(mesh, inp):
    """`sharding.all_to_all` of this rank's rows over the tile group, and its
    backward for this rank's cotangent, on the rank's device."""
    from gaussianmesh_tpu_torch.parallel import sharding
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if torch.distributed.get_backend() == "nccl" else torch.device("cpu")
    r = mesh.rank
    x = inp["x"][r].to(dev).requires_grad_(True)
    out = sharding.all_to_all(x, mesh.tile_group)
    out.backward(inp["g"][r].to(dev))
    return {"out": out.detach().cpu(), "grad": x.grad.cpu(), "device": str(out.device)}


def a2a_reference(xs: list) -> list:
    """What an equal-split all_to_all gives each rank: chunk k of rank r's
    result is chunk r of rank k's rows (its own transpose, so also the
    backward's map of the cotangents)."""
    d = len(xs)
    return [torch.cat([xs[k].chunk(d)[r] for k in range(d)]) for r in range(d)]


def a2a_inputs(world: int, rows: int = 6, width: int = 5, seed: int = 0) -> dict:
    """Seeded rows and cotangents for `case_a2a`: (world, world * rows, width)."""
    gen = torch.Generator().manual_seed(seed)
    return {"x": torch.randn(world, world * rows, width, generator=gen),
            "g": torch.randn(world, world * rows, width, generator=gen),
            "mesh": (1, world)}


CASES = {"a2a": case_a2a, "halo": case_halo, "step": case_step, "playback": case_playback,
         "trainer": case_trainer, "gband": case_gband, "gstep": case_gstep,
         "gdensify": case_gdensify, "gtrainer": case_gtrainer}


def main(argv) -> None:
    import torch.distributed as dist
    case, rank, world, workdir = argv[0], int(argv[1]), int(argv[2]), argv[3]
    torch.set_num_threads(1)
    backend = os.environ.get("GM_TEST_BACKEND", "gloo")
    bound = {}
    if backend == "nccl":
        torch.cuda.set_device(rank)
        bound["device_id"] = torch.device("cuda", rank)
    store = dist.FileStore(os.path.join(workdir, f"{case}_store"), world)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world,
                            timeout=timedelta(seconds=GROUP_TIMEOUT_S), **bound)
    try:
        inp = torch.load(os.path.join(workdir, f"{case}_in.pt"), weights_only=False)
        mesh = None          # a trainer makes its own
        if case not in ("trainer", "gtrainer"):
            from gaussianmesh_tpu_torch.parallel import sharding
            mesh = sharding.make_mesh(*(int(x) for x in inp["mesh"]))
        out = CASES[case](mesh, inp)
        torch.save(out, os.path.join(workdir, f"{case}_rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
