"""The port's multi-device regimes on four cards, one card per rank over nccl,
held against one card, and the D = 4 step measured.

    python3 tools/multicard_torch.py [--device cpu] [--out PATH] [--procs P]
        [size flags]

The parent process prepares the inputs and the single-card references (on
card 0), then spawns each world of 4 ranks itself, with torchrun's variables
(`MASTER_ADDR`, a free `MASTER_PORT`, `WORLD_SIZE`, `RANK`, `LOCAL_RANK`,
`LOCAL_WORLD_SIZE`); every rank joins through `parallel.multihost.initialize`
(nccl, card `LOCAL_RANK`; gloo with `--device cpu`). It joins every rank with
a timeout, kills them all on the first failure and raises. With `--device
cuda` (the default) and fewer than 4 cards it raises; `--device cpu` runs the
same checks over gloo at the size flags' sizes (the tests' 64x48).

A. Agreement, config 2 at full width (800x800; the model is built as
   `chip_smoke.py`'s phase 6 builds its student: an icosphere-7 teacher
   perturbed from seed 0 renders 8 orbit views, the student is an icosphere-2
   proxy subdivided past 100,000 faces: 327,680 Gaussians, capacity 655,360,
   SH 3; its max_per_tile and pair capacities sized on the 8 views, then
   doubled, and max_per_tile doubled again for the densifies, as phase 10e;
   then 60 event-free steps on card 0, as phase 10e takes phase 6's trained
   student: on a fresh table step 1 would be Adam's first, lr g / (|g| +
   eps), which turns a gradient near eps, a rounding residue, into a share
   of lr that the order of the gradient's sum decides; `reduction_orders`
   records that on the fresh and on the trained table).
   The bars are the JAX package's (PERF.md section 2, "multi-rank agreement").
   - (data, tile) at (2, 2), (4, 1) and (1, 4): step 1 against the
     single-process step over the same views on card 0 (`chip_smoke.
     reference_step`): loss 1e-4 relative, parameters 5e-4 of each leaf's
     largest, grad_accum 1e-5, denom exact; then 20 steps with a reset at
     2, densifies at 3 and 6 and a reset at 6 (each densify's threshold the
     HOT-th largest grads_avg), the ranks' state hashes equal after each
     event and at the end, K1-K3 once per rank and step.
   - Sharded config-3 playback on the (1, 4) ranks: the teacher on its mesh
     at 1920x1080, 4 twist frames, each within 2e-5 of the single process's.
   - The Gaussian-table shard at D = 4: step 1 against the single-process
     step on the dealt table; 8 steps with the same events, each densify's
     n_split equal to a single-process `densify_and_split` of the gathered
     table; `send_overflow` 0; a per-rank checkpoint, 2 more steps and a
     fresh trainer resumed from it for 2, equal bit for bit; the checkpoint
     loaded by one process on card 0 equal to the gathered table. On the
     rank whose band received the most pairs (a card other than card 0),
     K1, K2 and both K3 calls held against their plain versions
     (`chip_smoke.check_k1` / `check_k2_k3` / `check_k3`): the "4-card band".
B. Timing, `--procs` worlds (3), each a process per rank. The bench's scene
   (`bench_torch.make_workload`: 1080p, 100,000 Gaussians, max_per_tile
   1024): every rank times the plain step on its own card, then the (1, 4)
   tile-axis step at band capacities load-sized as in
   `tools/bench_scaling_torch.py` and the D = 4 Gaussian-table step at the
   design's send capacity. Config 2 (A's student): the single-card training
   step on each rank's card, the (4, 1) data-axis step and the D = 4
   Gaussian-table step. Host ms: the median of synchronized steps (a rank's
   step ends when its collectives do, so every rank reads the slowest
   rank's step). Device busy ms: torch.profiler on each rank after every
   host time, nccl's kernels given apart (they spin while a rank waits for
   the slowest). Each collective in a step: CUDA events around it
   (`Collectives`; waits for the slowest rank included), and alone, after a
   barrier, on buffers of the step's sizes (the transfer). The busy clock
   of a rank's step: its device work without nccl's kernels plus its
   collectives alone. GB/s leaving a card: ring all-reduce 2 (D - 1) / D of
   the buffer, all_to_all (D - 1) / D. Efficiency, on each clock, per world
   and then the median over worlds: tile and Gaussian-table axes plain / (4
   x the critical rank's step), the plain step the median over the ranks'
   cards; data axis single-card step / (4, 1) step.
C. The entry point: `python -m torch.distributed.run --standalone
   --nproc_per_node 4 -m gaussianmesh_tpu_torch.cli.train_mesh` on the
   seeded 64 px scene of `tests/test_torch_e2e.py::make_dataset`, at
   `--data_axis 2 --tile_axis 2` and at `--shard_gaussians 4`, with a
   checkpoint at half the iterations; the same flags in one process; then
   `cli.render` and `cli.metrics` of each model directory in one process on
   one card, and the test PSNRs side by side (no bar: the data axis draws 2
   views a step).

Writes results/multicard_torch.json (or --out) afresh, never merged: the
cards' names, power limits and count, the nccl version, the links
(`nvidia-smi topo -m` and `nvlink -s`, each its refusal where the machine
refuses it, and peer access), A, B, C, and the D = 4 model of
`tools/bench_scaling_torch.py` (`results/scaling_torch.json`) beside the
measured efficiencies. On the CPU every device reading is None.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import socket
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _p in (ROOT, os.path.join(ROOT, "tools")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import numpy as np  # noqa: E402
import torch  # noqa: E402

WORLD = 4
MESHES = ((2, 2), (4, 1), (1, 4))
SIZE = 800                 # config 2's views
VIEWS = 8
TEACHER_SUBDIV = 7         # 327,680 faces
PROXY_SUBDIV = 2           # chip_smoke.PROXY_SUBDIV: 320 faces
INIT_TARGET = 100_000
PRETRAIN = 60              # event-free steps of the student before its state is taken
PLAYBACK_SIZE = (1920, 1080)
PLAYBACK_CALLS = 4
STEPS = 20                 # (data, tile) steps after step 1
GSHARD_STEPS, GSHARD_MORE = 8, 2
HOT = 2000                 # each densify's threshold: the HOT-th largest grads_avg
PROCS = 3                  # timing worlds
TIMED, WARM, PROFILED = 10, 3, 3
COLLECTIVE_REPS = 5
ALONE_CALLS = 5            # calls a timing window of a collective alone
CLI_ITERS = 300
GROUP_TIMEOUT_S = 300
JOIN_S = 1200
SCHEDULE = dict(densify_from_iter=2, densification_interval=3, opacity_reset_interval=6)
EVENTS = [(2, "opacity_reset"), (3, "densify"), (6, "densify"), (6, "opacity_reset")]
# the JAX package's bars (PERF.md section 2)
LOSS_REL, PARAM_REL, ACCUM_ABS, FRAME_ABS = 1e-4, 5e-4, 1e-5, 2e-5
# the scaling tool's D = 4 model (results/scaling_torch.json; NVLink 4 assumed, overlap)
MODEL_FILE = os.path.join(ROOT, "results", "scaling_torch.json")
RING = "2 (D - 1) / D of the buffer"
A2A = "(D - 1) / D of the buffer"


def smoke():
    """`chip_smoke.py` as a module: its checks and helpers, without a run."""
    import chip_smoke
    return chip_smoke


def pick_device(name: str | None) -> torch.device:
    """The parent's device: card 0, or the CPU when asked; fewer than WORLD
    cards raise."""
    from gaussianmesh_tpu_torch import resolve_device

    dev = resolve_device(name)
    if dev.type != "cuda":
        return dev
    if torch.cuda.device_count() < WORLD:
        raise RuntimeError(f"tools/multicard_torch.py needs {WORLD} cards, one per rank; "
                           f"this host has {torch.cuda.device_count()}")
    torch.cuda.set_device(0)
    return torch.device("cuda", 0)


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def expect_launches(dev, got: dict, want: dict) -> None:
    """The kernels' launch counts; on the CPU the wrappers run the plain
    versions, which count nothing."""
    assert got == (want if dev.type == "cuda" else {k: 0 for k in want}), (got, want)


# ------------------------------------------------------------ the machine

def machine(dev) -> dict:
    """Card names and power limits (nvidia-smi), count, nccl version and the
    links: the lines of `nvidia-smi topo -m` and `nvidia-smi nvlink -s`
    (each its error where the machine refuses it) and which cards reach
    which by peer access; None on the CPU."""
    if dev.type != "cuda":
        return dict(device="cpu", cards=None, count=0, nccl=None, topology=None)

    def smi(*args):
        p = subprocess.run(["nvidia-smi", *args], capture_output=True, text=True,
                           timeout=60)
        lines = [ln.rstrip() for ln in (p.stdout + p.stderr).splitlines() if ln.strip()]
        return lines if p.returncode == 0 else {"exit": p.returncode, "output": lines}

    n = torch.cuda.device_count()
    cards = [dict(zip(("name", "power_limit"), (s.strip() for s in line.rsplit(",", 1))))
             for line in smi("--query-gpu=name,power.limit", "--format=csv,noheader")]
    return dict(device="cuda", cards=cards, count=n, torch=torch.__version__,
                cuda=torch.version.cuda,
                nccl=".".join(str(x) for x in np.atleast_1d(torch.cuda.nccl.version())),
                topology={"topo_m": smi("topo", "-m"), "nvlink_status": smi("nvlink", "-s"),
                          "peer_access": [[i == j or torch.cuda.can_device_access_peer(i, j)
                                           for j in range(n)] for i in range(n)]})


# ------------------------------------------------------------ spawning

def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(job: str, work: str, timeout: float) -> list[str]:
    """A world of WORLD ranks of `job` (`rank_main`) with torchrun's
    variables; every rank joined within `timeout` s, all killed on the first
    failure, which raises. -> each rank's output."""
    port = str(free_port())
    procs = []
    for r in range(WORLD):
        env = {**os.environ, "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": port,
               "WORLD_SIZE": str(WORLD), "RANK": str(r), "LOCAL_RANK": str(r),
               "LOCAL_WORLD_SIZE": str(WORLD), "GM_DIST_TIMEOUT": str(GROUP_TIMEOUT_S)}
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--rank", job, work], env=env,
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    t0 = time.perf_counter()
    outs = smoke().join_ranks(procs, timeout)
    print(f"[multicard] {job}: {WORLD} ranks in {time.perf_counter() - t0:.1f} s",
          flush=True)
    return outs


def rank_reports(work: str, job: str) -> list[dict]:
    return [json.load(open(os.path.join(work, f"{job}.rank{r}.json")))
            for r in range(WORLD)]


# ------------------------------------------------------------ A: inputs

def prepare(args, dev, work: str) -> dict:
    """Config 2 as phase 6 builds it: the teacher's PLY and mesh, its views,
    the student's state and config -> inputs.pt in `work`."""
    cs = smoke()
    port = cs.load_port()
    # phase 4's model at the teacher's level, with its mesh beside it
    teacher = cs.make_model(torch, port, work, args.teacher_subdiv, dev)
    port.mesh_io.write_triangle_mesh(os.path.join(work, "teacher.obj"),
                                     *cs.icosphere(args.teacher_subdiv))
    cams = [cs.orbit_camera(port.graphics, 2 * math.pi * i / VIEWS, dev,
                            elevation=0.3 + 0.4 * math.sin(i), width=args.size,
                            height=args.size) for i in range(VIEWS)]
    with torch.no_grad():
        cfg, _ = cs.size_capacities(torch, port, teacher, cams, args.size, args.size,
                                    cs.SH_DEGREE, "multicard")
        bg = torch.ones(3, device=dev)
        images = []
        for cam in cams:
            out = port.render.render(port.render.mesh_model_arrays(
                teacher, cam, cs.SH_DEGREE), cam, cfg, bg)
            images.append((out.color.clamp(0, 1) * 255).round().to(torch.uint8))
        pcam = cs.orbit_camera(port.graphics, 0.0, dev, width=args.playback[0],
                               height=args.playback[1])
        pcfg, _ = cs.size_capacities(torch, port, teacher, [pcam], *args.playback,
                                     cs.SH_DEGREE, "multicard playback")
    ds = port.trainer.DeviceDataset(
        view=torch.stack([c.viewmatrix for c in cams]),
        proj=torch.stack([c.projmatrix for c in cams]),
        campos=torch.stack([c.campos for c in cams]),
        tanfovx=torch.stack([c.tanfovx for c in cams]),
        tanfovy=torch.stack([c.tanfovy for c in cams]),
        images=torch.stack(images), masks=None, width=args.size, height=args.size)
    del teacher
    opt = port.config.OptimizationParams(**SCHEDULE, densify_until_iter=8)
    tr = port.trainer.MeshTrainer(*cs.icosphere(args.proxy_subdiv), ds, opt,
                                  port.config.RuntimeParams(),
                                  spatial_lr_scale=cs.SHARD_LR_SCALE,
                                  init_target=args.init_target, max_sh_degree=cs.SH_DEGREE)
    with torch.no_grad():
        scfg, _ = cs.size_capacities(torch, port, tr.model,
                                     [ds.camera(i) for i in range(VIEWS)],
                                     args.size, args.size, cs.SH_DEGREE, "multicard student")
    # headroom as phase 6 (scales move while training), max_per_tile doubled
    # again as phase 10e (densifies pile pairs into tiles)
    tr.rt = dataclasses.replace(
        tr.rt, max_per_tile=4 * scfg.max_per_tile,
        pair_capacity_per_gaussian=2 * scfg.pair_capacity_per_gaussian,
        row_capacity_per_gaussian=2 * scfg.row_capacity_per_gaussian)
    tr.sh_degree = cs.SH_DEGREE
    # trained a little, as phase 10e takes phase 6's student: on a fresh
    # table step 1 is Adam's first, which moves an entry by lr g / (|g| +
    # eps), so an entry whose gradient is near eps (a rounding residue) moves
    # by a share of lr that the order of the gradient's sum decides
    # (`reduction_orders` measures it before and after)
    orders = dict(fresh=reduction_orders(cs, port, tr))
    opt_kept, tr.opt = tr.opt, port.config.OptimizationParams()
    if args.pretrain:
        tr.train(args.pretrain, log_every=args.pretrain)
    assert not tr.events, tr.events
    tr.opt, tr.global_it = opt_kept, 0
    orders["pretrained"] = reduction_orders(cs, port, tr)
    inputs = dict(
        state=tr.capture(), opt=dataclasses.asdict(opt), rt=dataclasses.asdict(tr.rt),
        data={k: getattr(ds, k).cpu() for k in ("view", "proj", "campos", "tanfovx",
                                                "tanfovy", "images")},
        size=(args.size, args.size), args=vars(args),
        playback_cam=[x.cpu() for x in pcam],
        playback_cfg=dataclasses.asdict(dataclasses.replace(
            pcfg, max_per_tile=2 * pcfg.max_per_tile)),
        paths=[os.path.join(work, "point_cloud.ply"), os.path.join(work, "teacher.obj")])
    torch.save(inputs, os.path.join(work, "inputs.pt"))
    return dict(trainer=tr, inputs=inputs, port=port, model=dict(
        width=args.size, height=args.size, views=VIEWS, pretrain=args.pretrain,
        n_gauss=int(tr.model.alive.sum()),
        capacity=tr.model.capacity, sh_degree=tr.sh_degree, rt=dataclasses.asdict(tr.rt),
        teacher_faces=20 * 4 ** args.teacher_subdiv,
        built_as="chip_smoke.py phase 6's student (teacher views, proxy subdivided)",
        reduction_order=orders))


def reduction_orders(cs, port, tr, n_data: int = WORLD) -> dict:
    """Step 1 of the (n_data, 1) data-axis mesh's views on `tr`'s table, on
    its device, as `step1_check` holds a rank against one card, with the
    all-reduce's sum taken in two orders. Each rank's partial gradient comes
    from the port's own step (`make_sharded_train_step` over a world of one,
    so its all-reduce sums nothing: the rank's view, its loss normalisation,
    its share of the mesh-restrict term); the partials are summed in rank
    order and in reverse, and Adam's update is applied to each sum and to
    the single-card reference's gradient (`chip_smoke.reference_step`'s one
    backward of the views' mean loss plus the mesh-restrict term). Per order
    and leaf, the largest difference of the updated parameters over the
    leaf's largest (the bar's measure); where that passes the bar, the
    entries past it: their count, sign flips, gradients zero in one order
    only, the largest gradient among them beside Adam's eps, and the leaf's
    median nonzero gradient."""
    import bench_sharded_torch

    ds, bg, views = tr.ds, tr.bg_const, mesh_views(n_data)

    class Kept:
        """Stands in for Adam in the step: keeps the summed gradient."""

        def update(self, params, grads):
            self.grads = [grads[k].clone() for k in params]

    def copy():
        t = port.trainer.MeshTrainer(*cs.icosphere(PROXY_SUBDIV), ds, tr.opt, tr.rt,
                                     spatial_lr_scale=cs.SHARD_LR_SCALE, init_target=0,
                                     max_sh_degree=cs.SH_DEGREE)
        t.restore(tr.capture())
        return t

    t = copy()
    m, lam = t.model, tr.opt.lambda_dssim
    params = m.params()
    names, leaves = list(params), list(params.values())
    total = 0.0
    for idx in views:
        cam, gt = ds.camera(idx), ds.target(idx, bg)
        out = port.render.render(port.render.mesh_model_arrays(m, cam, t.sh_degree), cam,
                                 t.raster_cfg(), bg)
        total = total + ((1 - lam) * port.loss.l1_loss(out.color, gt)
                         + lam * (1 - port.loss.ssim(out.color, gt))) / len(views)
    total = total + port.loss.mesh_restrict_loss(m.get_scaling(), m.vertex1, m.vertex2,
                                                 m.vertex3, m.alive, tr.opt.alpha_mrloss)
    grads = {"reference": [torch.zeros_like(p) if g is None else g for p, g in zip(
        leaves, torch.autograd.grad(total, leaves, allow_unused=True))]}
    del t, total, out
    partials, pad = [], port.sharding.padded_grid_y(ds.height, 1) * 16 - ds.height
    with bench_sharded_torch.world_of_one(tr.device) as one:
        for r, idx in enumerate(views):
            t, kept = copy(), Kept()
            step = port.train_step.make_sharded_train_step(
                dataclasses.replace(one, n_data=n_data, rank=r, data_index=r), kept,
                t.raster_cfg(), t.sh_degree, lam, tr.opt.alpha_mrloss, ds.width,
                ds.height)
            step(t.model, ds.camera(idx),
                 torch.nn.functional.pad(ds.target(idx, bg), (0, 0, 0, pad)), bg)
            partials.append(kept.grads)
            del t
    for order, seq in (("ranks", partials), ("ranks_reversed", partials[::-1])):
        acc = list(seq[0])
        for p in seq[1:]:
            acc = [a + x for a, x in zip(acc, p)]
        grads[order] = acc
    del partials
    after = {}
    for order, g in grads.items():
        u = copy()
        p = u.model.params()
        u.adam.update(p, dict(zip(names, g)))
        after[order] = [p[k].detach() for k in names]
        del u
    res = {}
    for order in ("ranks", "ranks_reversed"):
        by_leaf = {}
        for i, k in enumerate(names):
            a, b = after["reference"][i], after[order][i]
            big = a.abs().max().clamp(min=1e-30)
            diff = (a - b).abs()
            leaf = dict(rel=float(diff.max() / big))
            past = diff > PARAM_REL * big
            if past.any():
                ga, gb = grads["reference"][i], grads[order][i]
                nonzero = ga.abs()[ga != 0]
                worst = int(torch.argmax(diff))
                leaf.update(
                    past_bar=int(past.sum()), entries=ga.numel(),
                    sign_flips=int((ga * gb < 0)[past].sum()),
                    zero_in_one_order=int(((ga == 0) != (gb == 0))[past].sum()),
                    g_max_past_bar=float(torch.maximum(ga[past].abs(),
                                                       gb[past].abs()).max()),
                    worst=dict(g_reference=float(ga.reshape(-1)[worst]),
                               g_order=float(gb.reshape(-1)[worst])),
                    g_median_nonzero=float(nonzero.median()) if nonzero.numel() else 0.0)
            by_leaf[k] = leaf
        res[order] = dict(param_rel=max(x["rel"] for x in by_leaf.values()),
                          leaves=by_leaf)
    return dict(mesh=[n_data, 1], views=views, adam_step=int(tr.adam.step),
                eps=tr.adam.eps, bar=PARAM_REL, **res)


def mesh_views(n_data: int) -> list[int]:
    """The views of a (data, tile) step: one per data group, spread."""
    return [i * VIEWS // n_data for i in range(n_data)]


def references(prep: dict, work: str) -> None:
    """The single-card steps every regime's step 1 is held against, on the
    parent's card: each mesh's views, and the dealt table's view 0."""
    cs, port, tr = smoke(), prep["port"], prep["trainer"]
    for n_data, _ in MESHES:
        ref = cs.reference_step(torch, port, tr, mesh_views(n_data), tr.bg_const)
        torch.save(ref, os.path.join(work, f"reference_{n_data}.pt"))
    dealt = port.trainer.deal_rows(tr.capture(), WORLD)
    single = port.trainer.MeshTrainer(*cs.icosphere(PROXY_SUBDIV), tr.ds, tr.opt, tr.rt,
                                      spatial_lr_scale=cs.SHARD_LR_SCALE, init_target=0,
                                      max_sh_degree=cs.SH_DEGREE)
    single.restore(dealt)
    m = single.step(0, tr.bg_const)
    torch.save(dict(loss=float(m["loss"]),
                    params={k: v.detach().cpu() for k, v in single.model.params().items()},
                    grad_accum=single.model.state.grad_accum.cpu(),
                    denom=single.model.state.denom.cpu()),
               os.path.join(work, "reference_gshard.pt"))


# ------------------------------------------------------------ ranks

class Rank:
    """What every rank job starts from: the group joined through the port's
    `multihost.initialize`, this rank's device, the prepared inputs."""

    def __init__(self, work: str):
        import torch.distributed as dist

        from gaussianmesh_tpu_torch.parallel import multihost

        self.work = work
        inp = torch.load(os.path.join(work, "inputs.pt"), weights_only=False)
        self.args = argparse.Namespace(**inp["args"])
        cpu = self.args.device == "cpu"
        if cpu:
            torch.set_num_threads(1)
        multihost.initialize(backend="gloo" if cpu else None)
        self.rank, self.world = dist.get_rank(), dist.get_world_size()
        self.dev = (torch.device("cpu") if cpu
                    else torch.device("cuda", torch.cuda.current_device()))
        self.backend = dist.get_backend()
        self.cs = smoke()
        self.port = self.cs.load_port()
        self.inp = inp
        d = {k: v.to(self.dev) for k, v in inp["data"].items()}
        w, h = inp["size"]
        self.ds = self.port.trainer.DeviceDataset(d["view"], d["proj"], d["campos"],
                                                  d["tanfovx"], d["tanfovy"], d["images"],
                                                  None, w, h)
        self.opt = self.port.config.OptimizationParams(**inp["opt"])

    def trainer(self, **rt):
        """A `MeshTrainer` on this rank's card with the prepared config and
        `rt`'s overrides (its state still to restore)."""
        port, cs = self.port, self.cs
        return port.trainer.MeshTrainer(
            *cs.icosphere(PROXY_SUBDIV), self.ds, self.opt,
            port.config.RuntimeParams(**{**self.inp["rt"], **rt}),
            spatial_lr_scale=cs.SHARD_LR_SCALE, init_target=0, max_sh_degree=cs.SH_DEGREE)

    def gather(self, x):
        import torch.distributed as dist

        out = [None] * self.world
        dist.all_gather_object(out, x)
        return out

    def report(self, job: str, rep: dict) -> None:
        from gaussianmesh_tpu_torch.parallel import multihost

        rep.update(rank=self.rank, backend=self.backend, device=str(self.dev), ok=True)
        with open(os.path.join(self.work, f"{job}.rank{self.rank}.json"), "w") as fh:
            json.dump(rep, fh)
        multihost.barrier()


def step1_check(ref: dict, got_params: dict, state, loss: float, rows=slice(None)) -> dict:
    rel = {k: float((got_params[k].detach().cpu() - ref["params"][k][rows]).abs().max()
                    / ref["params"][k].abs().max().clamp(min=1e-30)) for k in got_params}
    s1 = dict(loss=loss, ref_loss=ref["loss"],
              loss_rel=abs(loss - ref["loss"]) / abs(ref["loss"]),
              param_rel=max(rel.values()), param_rel_by_leaf=rel,
              grad_accum_abs=float((state.grad_accum.cpu()
                                    - ref["grad_accum"][rows]).abs().max()),
              denom_equal=bool(torch.equal(state.denom.cpu(), ref["denom"][rows])))
    assert s1["loss_rel"] <= LOSS_REL and s1["param_rel"] <= PARAM_REL, s1
    assert s1["grad_accum_abs"] <= ACCUM_ABS and s1["denom_equal"], s1
    return s1


def hot_threshold(grads_avg, alive) -> float:
    g = grads_avg[alive]
    return float(torch.topk(g, min(HOT, max(1, g.shape[0] // 8))).values[-1])


def job_mesh(r: Rank, n_data: int, n_tile: int) -> dict:
    """The (data, tile) regime at (n_data, n_tile): step 1 against the
    single-card reference, STEPS steps with the schedule's events, the state
    hashes equal after each; on (1, 4) also the sharded playback."""
    cs, port, dev = r.cs, r.port, r.dev
    tr = r.trainer(data_axis=n_data, tile_axis=n_tile)
    tr.restore(r.inp["state"])
    ref = torch.load(os.path.join(r.work, f"reference_{n_data}.pt"), weights_only=False)
    cams = torch.tensor(mesh_views(n_data))
    cs.reset_launches(port)
    m1 = tr.sharded_step(cams, tr.bg_const)
    sync(dev)
    step1 = step1_check(ref, tr.model.params(), tr.model.state, float(m1["loss"]))
    step1["launches"] = cs.read_launches(port)
    expect_launches(dev, step1["launches"], {"K1": 1, "K2": 1, "K3": 1})

    tr.global_it = 0
    tr.opt = dataclasses.replace(r.opt, densify_until_iter=8)
    densify = tr.densify

    def densify_hot():
        tr.opt = dataclasses.replace(tr.opt, densify_grad_threshold=hot_threshold(
            port.densify.grads_avg(tr.model.state), tr.model.alive))
        return densify()

    tr.densify = densify_hot
    hashes, losses, times, seen = [], [], [], [0]
    clock = [time.perf_counter()]

    def on_step(m):
        sync(dev)
        now = time.perf_counter()
        times.append((now - clock[0]) * 1e3)
        losses.append(m["loss"])
        assert m["tile_overflow"] == 0 and m["rect_overflow"] == 0, m
        if len(tr.events) > seen[0]:
            seen[0] = len(tr.events)
            got = r.gather(cs.state_hash(tr))
            assert len(set(got)) == 1, got
            hashes.append(got[0])
        clock[0] = time.perf_counter()

    cs.reset_launches(port)
    tr.train(STEPS, log_every=1, callback=on_step)
    launches = cs.read_launches(port)
    final = r.gather(cs.state_hash(tr))
    assert len(set(final)) == 1, final
    hashes.append(final[0])
    assert [(it, k) for it, k, _ in tr.events] == EVENTS, tr.events
    expect_launches(dev, launches, {"K1": STEPS, "K2": STEPS, "K3": STEPS})
    assert all(math.isfinite(x) for x in losses), losses
    rep = dict(mesh=[n_data, n_tile], step1=step1, losses=losses, hashes=hashes,
               events=tr.events, launches=launches, step_ms=times,
               n_alive=tr.n_alive())
    if n_data == 1 and n_tile == WORLD:
        rep["playback"] = playback(r, tr.mesh)
    return rep


@torch.no_grad()
def playback(r: Rank, mesh) -> dict:
    """Sharded config-3 playback on the mesh's bands against the single
    process's frames."""
    cs, port, dev = r.cs, r.port, r.dev
    pcfg = port.rasterize.RasterizerConfig(**r.inp["playback_cfg"])
    cam = port.graphics.CameraArrays(*(x.to(dev) for x in r.inp["playback_cam"]))
    editor = port.runtime.SceneEditor(device=dev)
    editor.add_object(*r.inp["paths"], name="main")
    frames = torch.tensor(cs.twist_frames(cs.icosphere(r.args.teacher_subdiv)[0],
                                          cs.PLAYBACK_FRAMES), device=dev)
    fn = port.edit_step.make_sharded_playback_fn(mesh, editor, "main", cam, pcfg,
                                                 bg_color=(1.0, 1.0, 1.0))
    single = port.runtime.make_playback_fn(editor.objects["main"], cam, pcfg,
                                           (1.0, 1.0, 1.0))
    step = cs.PLAYBACK_FRAMES // PLAYBACK_CALLS
    cs.reset_launches(port)
    got, ms = [], []
    for i in range(PLAYBACK_CALLS):
        sync(dev)
        t0 = time.perf_counter()
        got.append(fn(frames[i * step:i * step + mesh.n_data]))
        sync(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
    launches = cs.read_launches(port)
    expect_launches(dev, launches, {"K1": PLAYBACK_CALLS, "K2": 0, "K3": 0})
    errs = []
    for i, frame in enumerate(got):
        want = single(frames[i * step])
        assert int(want.tile_overflow) == 0 and int(want.rect_overflow) == 0
        errs.append((frame[0] - want.color).abs().max().item())
    assert max(errs) <= FRAME_ABS, errs
    return dict(frames=len(errs), max_abs=max(errs), call_ms=ms, launches=launches,
                size=[pcfg.width, pcfg.height], bands=mesh.n_tile)


def job_gshard(r: Rank) -> dict:
    """The Gaussian-table shard at D = 4 (`chip_smoke.gshard_rank`'s checks on
    one card per rank), the per-rank checkpoint, and the kernels on the
    busiest received band's card."""
    import hashlib

    cs, port, dev, rank, world = r.cs, r.port, r.dev, r.rank, r.world
    inp = r.inp
    tr = r.trainer(shard_gaussians=world)
    tr.restore(port.checkpoint.shard_rows(port.trainer.deal_rows(inp["state"], world),
                                          rank, world))
    group, c = tr.mesh.tile_group, tr.model.capacity
    ref = torch.load(os.path.join(r.work, "reference_gshard.pt"), weights_only=False)
    cs.reset_launches(port)
    m1 = tr.step(0, tr.bg_const)
    sync(dev)
    step1 = step1_check(ref, tr.model.params(), tr.model.state, float(m1["loss"]),
                        rows=slice(rank * c, (rank + 1) * c))
    step1.update(launches=cs.read_launches(port), overflow=int(m1["overflow"]),
                 send_overflow=int(m1["send_overflow"]))
    expect_launches(dev, step1["launches"], {"K1": 1, "K2": 1, "K3": 2})
    assert step1["overflow"] == 0 and step1["send_overflow"] == 0, step1
    slots = world * tr.send_capacity()

    tr.global_it = 0
    tr.opt = dataclasses.replace(r.opt, densify_until_iter=GSHARD_STEPS)
    densify, checks, pool_hashes = tr.densify, [], []

    def densify_checked():
        whole = tr.whole_model()
        g = port.densify.grads_avg(whole.state)
        thr = hot_threshold(g, whole.alive)
        tr.opt = dataclasses.replace(tr.opt, densify_grad_threshold=thr)
        mu, nu = ({k: torch.cat(port.sharding.all_gather(v, group)) for k, v in t.items()}
                  for t in (tr.adam.mu, tr.adam.nu))
        max_split = port.densify.round_up(max(256, whole.capacity // 16), 256)
        want = port.densify.densify_and_split(whole, mu, nu, g, thr, 5, max_split)
        del whole, mu, nu
        got = densify()
        checks.append(dict(iteration=tr.global_it, threshold=thr, n_split=got,
                           single_n_split=want.n_split, single_dropped=want.dropped,
                           capacity=tr.model.capacity))
        assert got == want.n_split and want.dropped == 0 and tr.model.capacity == c, checks
        return got

    tr.densify = densify_checked
    losses, times, seen = [], [], [0]
    clock = [time.perf_counter()]

    def on_step(m):
        sync(dev)
        now = time.perf_counter()
        times.append((now - clock[0]) * 1e3)
        losses.append(m["loss"])
        assert m["overflow"] == 0 and m["send_overflow"] == 0, m
        if len(tr.events) > seen[0]:
            seen[0] = len(tr.events)
            pool = tr.model.mesh_v
            got = r.gather(hashlib.sha256(pool.v.cpu().numpy().tobytes()
                                          + str(pool.count).encode()).hexdigest())
            assert len(set(got)) == 1, got
            pool_hashes.append(got[0])
        clock[0] = time.perf_counter()

    cs.reset_launches(port)
    tr.train(GSHARD_STEPS, log_every=1, callback=on_step)
    assert [(it, k) for it, k, _ in tr.events] == EVENTS, tr.events
    assert all(math.isfinite(x) for x in losses), losses

    # a per-rank checkpoint (rank 0 keeps the gathered table beside it for
    # the one-card load), GSHARD_MORE more steps, a fresh trainer resumed
    path = os.path.join(r.work, "ckpt", "chkpnt.ckpt")
    written = tr.save_ckpt(path)
    whole = tr.whole_model()
    gathered = dict(params={k: v.detach().cpu() for k, v in whole.params().items()},
                    binding={k: v.cpu() for k, v in whole.binding().items()},
                    state={k: v.cpu() for k, v in whole.state._asdict().items()},
                    mesh_v={"v": whole.mesh_v.v.cpu(), "count": int(whole.mesh_v.count)},
                    **{name: {k: torch.cat(port.sharding.all_gather(v, group)).cpu()
                              for k, v in t.items()}
                       for name, t in (("mu", tr.adam.mu), ("nu", tr.adam.nu))})
    if rank == 0:
        torch.save(gathered, os.path.join(r.work, "gathered.pt"))
    del whole, gathered
    tr.train(GSHARD_MORE, log_every=1, callback=on_step)
    resumed = r.trainer(shard_gaussians=world)
    resumed.opt = tr.opt
    resumed.load_ckpt(path)
    resumed.train(GSHARD_MORE, log_every=1000)
    launches = cs.read_launches(port)
    n = GSHARD_STEPS + 2 * GSHARD_MORE
    expect_launches(dev, launches, {"K1": n, "K2": n, "K3": 2 * n})
    equal = cs.state_hash(resumed) == cs.state_hash(tr)
    assert all(r.gather(equal)), "a resumed shard differs from the uninterrupted run"
    del resumed
    rep = dict(step1=step1, losses=losses, events=tr.events, densify=checks,
               pool_hashes=pool_hashes, resume_equal=equal,
               checkpoint=sorted(os.listdir(written)), launches=launches, step_ms=times,
               traffic=dict(send_capacity=tr.send_capacity(), slots_per_rank=slots,
                            bytes_sent_per_rank_step=slots * (8 + 64 + 64)))

    # one more step recording the kernels' arguments; the rank whose band
    # received the most pairs holds them against their plain versions
    seen_args = cs.capture_step(torch, port, tr, 0)
    rep["received_live"] = int(seen_args["K1"][1].shape[0])
    received = r.gather(rep["received_live"])
    rep["kernel_rank"] = int(np.argmax(received))
    rep["kernels"] = None
    if rank == rep["kernel_rank"] and dev.type == "cuda":
        assert dev.index != 0, "the kernels' rank is on card 0"
        k1, _, _, blended = cs.check_k1(torch, port.tile_blend, seen_args["K1"],
                                        tr.rt.max_per_tile)
        rows, grouped_pos, seg_starts = seen_args["K3"]
        k2, k3 = cs.check_k2_k3(torch, port, seen_args["K2"], grouped_pos, seg_starts,
                                blended, step_rows=rows)
        k3_owner = cs.check_k3(torch, port.segsum, *seen_args["K3_owner"])
        rep["kernels"] = dict(card=dev.index, K1=k1, K2=k2, K3=k3, K3_owner=k3_owner)
    return rep


def check_one_card_load(prep: dict, work: str, dev) -> dict:
    """The per-rank checkpoint read by one process on one card: every row
    tree, the moments and the vertex pool equal to the gathered table."""
    cs, port, tr0 = smoke(), prep["port"], prep["trainer"]
    single = port.trainer.MeshTrainer(*cs.icosphere(PROXY_SUBDIV), tr0.ds, tr0.opt, tr0.rt,
                                      spatial_lr_scale=cs.SHARD_LR_SCALE, init_target=0,
                                      max_sh_degree=cs.SH_DEGREE)
    single.load_ckpt(os.path.join(work, "ckpt", "chkpnt.ckpt"))
    want = torch.load(os.path.join(work, "gathered.pt"), weights_only=False)
    got = single.capture()
    unequal = [f"{tree}.{k}" for tree in ("params", "binding", "state", "mu", "nu")
               for k in want[tree] if not torch.equal(got[tree][k], want[tree][k])]
    if not torch.equal(got["mesh_v"]["v"], want["mesh_v"]["v"]) \
            or got["mesh_v"]["count"] != want["mesh_v"]["count"]:
        unequal.append("mesh_v")
    assert not unequal, f"the one-card load differs from the gathered table: {unequal}"
    return dict(device=str(dev), capacity=single.model.capacity,
                n_alive=int(single.model.alive.sum()), equal=True)


# ------------------------------------------------------------ B: timing

class Collectives:
    """While active, times every call of the port's collectives
    (`sharding.all_reduce`, `all_gather` and `_exchange`, which both
    directions of `all_to_all` go through) with CUDA events around it, and
    records its group and bytes. `calls`: {kind, group, shape, dtype, bytes,
    ms}; ms None on the CPU."""

    def __init__(self, groups: dict, dev):
        self.groups = {id(g): name for name, g in groups.items()}
        self.dev, self.calls, self.pending = dev, [], []

    def __enter__(self):
        from gaussianmesh_tpu_torch.parallel import sharding

        self._kept = {k: getattr(sharding, k) for k in ("all_reduce", "all_gather",
                                                        "_exchange")}
        for name, fn in self._kept.items():
            setattr(sharding, name, self._timed(name.strip("_").replace(
                "exchange", "all_to_all"), fn))
        return self

    def _timed(self, kind, fn):
        def call(x, group, *a, **k):
            rec = dict(kind=kind, group=self.groups.get(id(group), "other"),
                       shape=list(x.shape), dtype=str(x.dtype).replace("torch.", ""),
                       bytes=x.numel() * x.element_size(), ms=None)
            if self.dev.type == "cuda":
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
                out = fn(x, group, *a, **k)
                ev[1].record()
                self.pending.append((rec, ev))
            else:
                out = fn(x, group, *a, **k)
            self.calls.append(rec)
            return out
        return call

    def __exit__(self, *exc):
        from gaussianmesh_tpu_torch.parallel import sharding

        for name, fn in self._kept.items():
            setattr(sharding, name, fn)
        sync(self.dev)
        for rec, (a, b) in self.pending:
            rec["ms"] = a.elapsed_time(b)
        return False


def per_step(calls: list[dict], n_steps: int) -> list[dict]:
    """Calls of n_steps identical steps -> one step's calls, each with the
    median ms over the steps."""
    k = len(calls) // n_steps
    out = []
    for i in range(k):
        same = calls[i::k]
        ms = [c["ms"] for c in same]
        out.append({**same[0], "ms": None if None in ms else statistics.median(ms),
                    "ms_all": ms})
    return out


def leaving(kind: str, nbytes: int, d: int) -> float:
    """Bytes leaving a card for one call over d ranks (ring all-reduce,
    all_to_all's equal splits, all_gather's own chunk to d - 1 peers)."""
    if kind == "all_reduce":
        return 2 * (d - 1) / d * nbytes
    if kind == "all_to_all":
        return (d - 1) / d * nbytes
    return (d - 1) * nbytes


def call_key(c: dict) -> tuple:
    return c["kind"], c["group"], tuple(c["shape"]), c["dtype"]


def alone(step_calls: list[dict], groups: dict, dev, reps: int) -> list[dict]:
    """Each distinct collective of a step timed alone, on zero buffers of its
    shape: one warm call, then `reps` windows, each a barrier and ALONE_CALLS
    calls back to back between CUDA events (the ranks' skew after the
    barrier spread over them); the median ms a call and the GB/s leaving a
    card. None on the CPU."""
    import torch.distributed as dist

    from gaussianmesh_tpu_torch.parallel import multihost, sharding

    out, done = [], set()
    for c in step_calls:
        key = call_key(c)
        if key in done:
            continue
        done.add(key)
        group = groups[c["group"]]
        d = dist.get_world_size(group)
        x = torch.zeros(c["shape"], dtype=getattr(torch, c["dtype"]), device=dev)
        fn = {"all_reduce": lambda: sharding.all_reduce(x, group),
              "all_gather": lambda: sharding.all_gather(x, group),
              "all_to_all": lambda: sharding._exchange(x, group)}[c["kind"]]
        fn()
        ms = []
        for _ in range(reps):
            multihost.barrier()
            sync(dev)
            if dev.type == "cuda":
                a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                a.record()
                for _ in range(ALONE_CALLS):
                    fn()
                b.record()
                sync(dev)
                ms.append(a.elapsed_time(b) / ALONE_CALLS)
        med = statistics.median(ms) if ms else None
        lb = leaving(c["kind"], c["bytes"], d)
        out.append(dict(kind=c["kind"], group=c["group"], ranks=d, shape=c["shape"],
                        dtype=c["dtype"], bytes=c["bytes"], bytes_leaving=lb,
                        leaving_factor={"all_reduce": RING, "all_to_all": A2A}.get(
                            c["kind"], "(D - 1) x the buffer"),
                        ms=med, gb_s_leaving=None if med is None else lb / med / 1e6))
        del x
    return out


def profile_step(fn, n: int, dev) -> dict:
    """torch.profiler over n calls: device busy ms per call, nccl's share of
    it (a rank's nccl kernels wait for the slowest rank), operations."""
    if dev.type != "cuda":
        return dict(busy_ms=None, nccl_ms=None, compute_busy_ms=None,
                    device_operations=None)
    from torch.profiler import ProfilerActivity, profile

    fn()
    sync(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        sync(dev)
    busy = nccl = ops = 0.0
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA"):
            ms = getattr(e, "self_device_time_total", 0) / 1e3 / n
            busy += ms
            ops += e.count / n
            if "nccl" in e.key.lower():
                nccl += ms
    return dict(busy_ms=busy, nccl_ms=nccl, compute_busy_ms=busy - nccl,
                device_operations=ops)


def timed(fn, dev, groups, steps: int, warm: int) -> dict:
    """Host ms of fn() (median of `steps` synchronized calls after `warm`),
    then its collectives over `steps` more calls (in-step ms) and alone."""
    import timing_torch as timing

    ms = timing.host_times(fn, steps, dev, warm=warm)
    with Collectives(groups, dev) as col:
        for _ in range(steps):
            fn()
    calls = per_step(col.calls, steps)
    return dict(host_ms=statistics.median(ms), host_ms_all=ms, collectives=calls,
                fn=fn)


def bench_band_config(w, d: int):
    """The bench's config at D-band capacities load-sized as
    `tools/bench_scaling_torch.py` sizes them (the JAX tool's capacities
    doubled until no band overflows)."""
    import bench_playback_torch as playback
    import bench_scaling_torch as scaling
    import bench_sharded_torch as sharded

    cfg = w.cfg
    _, gy_local = scaling.band_geometry(cfg.height, d)
    jcap = scaling.jax_capacity(d)
    jcfg = dataclasses.replace(cfg, pair_capacity_per_gaussian=jcap[0],
                               row_capacity_per_gaussian=jcap[1])
    arrays = sharded.arrays_of([x.detach() for x in w.inputs])
    sized = [playback.load_sized(arrays, w.cam, jcfg, band=(k * gy_local, gy_local))[0]
             for k in range(d)]
    return dataclasses.replace(cfg, pair_capacity_per_gaussian=max(
        c.pair_capacity_per_gaussian for c in sized), row_capacity_per_gaussian=max(
        c.row_capacity_per_gaussian for c in sized), max_per_tile=max(
        c.max_per_tile for c in sized))


def job_time(r: Rank) -> dict:
    """B on this rank: the bench scene's plain, (1, 4) and D = 4 steps, then
    config 2's single-card, (4, 1) and D = 4 training steps; every host time
    before every profile."""
    import bench_scaling_torch as scaling
    import bench_sharded_torch as sharded
    import bench_torch

    from gaussianmesh_tpu_torch.parallel import gauss_shard, sharding

    a, dev, d = r.args, r.dev, r.world
    steps, warm = a.timed, a.warm
    rep = {}

    # the bench's scene
    w = bench_torch.make_workload(a.bench_width, a.bench_height, a.bench_n, dev)
    n = w.inputs[0].shape[0]
    mesh = sharding.make_mesh(1, d)
    groups = {"world": mesh.world_group, "tile": mesh.tile_group}
    loss0, _, _ = bench_torch.fwd_bwd(w)
    ref_grads = [x.grad.detach().clone() for x in w.inputs]
    tcfg = bench_band_config(w, d)
    w_tile = w._replace(cfg=tcfg)
    loss, grads, o = sharded.tile_step(w_tile, mesh)
    tile_check = dict(sharded.agreement(loss, grads, loss0, ref_grads),
                      num_rendered=int(o.num_rendered),
                      overflow=int(o.tile_overflow + o.rect_overflow + o.pair_overflow))
    cap = gauss_shard.send_capacity(w.cfg, n // d, d)
    w_g = w._replace(inputs=scaling.shard_inputs(w, d, r.rank))
    loss, _, o = sharded.gauss_step(w_g, mesh, cap)
    gauss_check = dict(loss=float(loss), loss_rel=abs(float(loss) - float(loss0))
                       / abs(float(loss0)), send_capacity=cap,
                       received_live=int(o.num_rendered), sent=int(o.sent),
                       send_overflow=int(o.send_overflow),
                       overflow=int(o.tile_overflow + o.rect_overflow))
    assert tile_check["overflow"] == 0 and gauss_check["send_overflow"] == 0
    assert gauss_check["overflow"] == 0
    assert tile_check["loss_rel"] <= LOSS_REL and gauss_check["loss_rel"] <= LOSS_REL
    items = {
        "bench_plain": timed(lambda: bench_torch.fwd_bwd(w), dev, groups, steps, warm),
        "bench_tile_1x4": timed(sharded.reduced(lambda: sharded.tile_step(w_tile, mesh)),
                                dev, groups, steps, warm),
        "bench_gauss_d4": timed(sharded.reduced(lambda: sharded.gauss_step(w_g, mesh, cap)),
                                dev, groups, steps, warm)}
    rep["bench"] = dict(width=a.bench_width, height=a.bench_height, n_gauss=n,
                        band_capacity=[tcfg.pair_capacity_per_gaussian,
                                       tcfg.row_capacity_per_gaussian],
                        band_max_per_tile=tcfg.max_per_tile, tile_check=tile_check,
                        gauss_check=gauss_check)

    # config 2
    tr = r.trainer(data_axis=d, tile_axis=1)
    tr.restore(r.inp["state"])
    tg = r.trainer(shard_gaussians=d)
    tg.restore(r.port.checkpoint.shard_rows(r.port.trainer.deal_rows(r.inp["state"], d),
                                            r.rank, d))
    cams = torch.tensor(mesh_views(d))
    groups2 = {"world": tr.mesh.world_group, "data": tr.mesh.data_group,
               "tile": tr.mesh.tile_group}
    groups3 = {"world": tg.mesh.world_group, "tile": tg.mesh.tile_group}

    def single():
        # the single-card step on this rank's card: every rank the same view,
        # so the replicated state stays equal for the (4, 1) steps after it
        kept, tr.mesh = tr.mesh, None
        try:
            return tr.step(0, tr.bg_const)
        finally:
            tr.mesh = kept

    items["config2_single"] = timed(single, dev, groups2, steps, warm)
    items["config2_data_4x1"] = timed(lambda: tr.step(cams, tr.bg_const), dev, groups2,
                                      steps, warm)
    items["config2_gauss_d4"] = timed(lambda: tg.step(0, tg.bg_const), dev, groups3,
                                      steps, warm)
    rep["config2"] = dict(send_capacity=tg.send_capacity(),
                          slots_per_rank=d * tg.send_capacity(),
                          sh_degree=tr.sh_degree, n_alive=tr.n_alive())
    # every profile after every host time; then the collectives alone
    all_groups = {"bench": groups, "config2": groups2, "config2_gauss": groups3}
    for key, item in items.items():
        fn = item.pop("fn")
        item.update(profile_step(fn, a.profiled, dev))
        g = all_groups["bench" if key.startswith("bench") else
                       "config2_gauss" if key == "config2_gauss_d4" else "config2"]
        item["alone"] = alone(item["collectives"], g, dev, a.collective_reps)
        # the busy clock: the device's own work (nccl's kernels left out: they
        # spin while this rank waits for the slowest) plus each collective
        # of the step at its time alone
        ms_of = {call_key(c): c["ms"] for c in item["alone"]}
        comm = [ms_of[call_key(c)] for c in item["collectives"]]
        item["comm_alone_ms"] = None if None in comm else sum(comm)
        item["busy_clock_ms"] = (None if None in (item["comm_alone_ms"],
                                                  item["compute_busy_ms"])
                                 else item["compute_busy_ms"] + item["comm_alone_ms"])
    rep["items"] = items
    return rep


def efficiency(num, den, d):
    return None if num is None or den is None else num / (d * den)


def summarize_timing(worlds: list[list[dict]], d: int) -> dict:
    """Per world: each item's host ms and busy-clock ms (`busy_clock_ms`:
    the device's own work plus the step's collectives alone) by rank, the
    critical rank (the most busy), the efficiencies; then the medians over
    worlds."""
    per_world = []
    for reports in worlds:
        items = {}
        for key in reports[0]["items"]:
            rows = [rep["items"][key] for rep in reports]
            host = [x["host_ms"] for x in rows]
            busy = [x["busy_clock_ms"] for x in rows]
            items[key] = dict(
                host_ms_by_rank=host, busy_clock_ms_by_rank=busy,
                busy_ms_by_rank=[x["busy_ms"] for x in rows],
                nccl_ms_by_rank=[x["nccl_ms"] for x in rows],
                comm_alone_ms_by_rank=[x["comm_alone_ms"] for x in rows],
                device_operations_by_rank=[x["device_operations"] for x in rows],
                host_ms_max=max(host), host_ms_median=statistics.median(host),
                critical_rank=int(np.argmax(busy)) if None not in busy
                else int(np.argmax(host)),
                busy_ms_max=None if None in busy else max(busy),
                busy_ms_median=None if None in busy else statistics.median(busy))
        eff = {}
        for clock, med, top in (("host", "host_ms_median", "host_ms_max"),
                                ("busy", "busy_ms_median", "busy_ms_max")):
            eff[clock] = dict(
                tile_axis=efficiency(items["bench_plain"][med], items["bench_tile_1x4"][top], d),
                gauss_shard_axis=efficiency(items["bench_plain"][med],
                                            items["bench_gauss_d4"][top], d),
                data_axis=efficiency(items["config2_single"][med],
                                     items["config2_data_4x1"][top], 1),
                config2_gauss_shard_axis=efficiency(items["config2_single"][med],
                                                    items["config2_gauss_d4"][top], d))
        per_world.append(dict(items=items, efficiency=eff))

    def med(xs):
        xs = [x for x in xs if x is not None]
        return statistics.median(xs) if xs else None

    out = dict(worlds=per_world, medians={})
    for clock in ("host", "busy"):
        out["medians"][clock] = {ax: med([w["efficiency"][clock][ax] for w in per_world])
                                 for ax in per_world[0]["efficiency"][clock]}
    out["medians"]["items"] = {
        key: {k: med([w["items"][key][k] for w in per_world])
              for k in ("host_ms_max", "host_ms_median", "busy_ms_max", "busy_ms_median")}
        for key in per_world[0]["items"]}
    return out


def collectives_summary(worlds: list[list[dict]]) -> dict:
    """Per item: each collective of a step, in-step ms (median over ranks and
    worlds) and alone (the median over worlds of the slowest rank's)."""
    out = {}
    for key in worlds[0][0]["items"]:
        calls = worlds[0][0]["items"][key]["collectives"]
        rows = []
        for i, c in enumerate(calls):
            ms = [rep["items"][key]["collectives"][i]["ms"]
                  for reports in worlds for rep in reports]
            rows.append(dict({k: c[k] for k in ("kind", "group", "shape", "dtype", "bytes")},
                             in_step_ms=None if None in ms else statistics.median(ms)))
        al = []
        for j, c in enumerate(worlds[0][0]["items"][key]["alone"]):
            ms = [max(rep["items"][key]["alone"][j]["ms"] for rep in reports)
                  if c["ms"] is not None else None for reports in worlds]
            m = None if None in ms else statistics.median(ms)
            al.append(dict(c, ms=m, ms_by_world=ms,
                           gb_s_leaving=None if m is None else c["bytes_leaving"] / m / 1e6))
        out[key] = dict(in_step=rows, alone=al, per_step={
            kind: step_traffic(rows, al, kind) for kind in ("all_to_all", "all_reduce", "all")})
    return out


def step_traffic(rows: list[dict], al: list[dict], kind: str) -> dict:
    """One step's calls of `kind` ("all": every call): bytes handed over,
    bytes leaving a card, ms in the step and alone, GB/s leaving alone."""
    by_key = {call_key(c): c for c in al}
    mine = [c for c in rows if kind in ("all", c["kind"])]
    alone_ms = [by_key[call_key(c)]["ms"] for c in mine]
    in_step = [c["in_step_ms"] for c in mine]
    total_alone = None if None in alone_ms else sum(alone_ms)
    leaving_b = sum(by_key[call_key(c)]["bytes_leaving"] for c in mine)
    return dict(calls=len(mine), bytes=sum(c["bytes"] for c in mine), bytes_leaving=leaving_b,
                in_step_ms=None if None in in_step else sum(in_step), alone_ms=total_alone,
                gb_s_leaving=(None if not total_alone else leaving_b / total_alone / 1e6))


# ------------------------------------------------------------ C: the entry point

def entry_point(args, dev, work: str) -> dict:
    """`cli.train_mesh` under torchrun at (2, 2) and at --shard_gaussians 4,
    and in one process; then `cli.render` and `cli.metrics` of each."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from test_torch_e2e import make_dataset

    scene = os.path.join(work, "scene")
    proxy = make_dataset(scene, n_cams=12)
    it = args.cli_iters
    flags = ["-s", scene, "--input_mesh", proxy, "--iterations", str(it),
             "--init_target", "500", "--densify_until_iter", str(it // 2),
             "--test_iterations", str(it), "--save_iterations", str(it),
             "--checkpoint_iterations", str(it // 2), "--sh_degree", "1",
             "--max_per_tile", "256", "--eval", "--device", dev.type]
    env = {**os.environ, "GM_DIST_TIMEOUT": str(GROUP_TIMEOUT_S)}
    if dev.type == "cpu":
        env["OMP_NUM_THREADS"] = "1"
    runs = {"single": [], "data2_tile2": ["--data_axis", "2", "--tile_axis", "2"],
            "shard4": ["--shard_gaussians", str(WORLD)]}
    out = dict(iterations=it, checkpoint=it // 2, scene="tests/test_torch_e2e.py::"
               "make_dataset(n_cams=12), 64x64", runs={})
    for name, extra in runs.items():
        model = os.path.join(work, name)
        cmd = [sys.executable, "-m", "gaussianmesh_tpu_torch.cli.train_mesh"]
        if name != "single":
            cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                   "--nproc_per_node", str(WORLD), "-m",
                   "gaussianmesh_tpu_torch.cli.train_mesh"]
        t0 = time.perf_counter()
        run(cmd + flags + extra + ["-m", model], env, f"train_mesh {name}")
        train_s = time.perf_counter() - t0
        ckpt = os.path.join(model, f"chkpnt{it // 2}.ckpt")
        ckpt += ".shards" if name == "shard4" else ""
        assert os.path.exists(ckpt), ckpt
        for mod, more in (("render", ["--iteration", str(it), "--max_per_tile", "256",
                                      "--skip_train"]), ("metrics", [])):
            run([sys.executable, "-m", f"gaussianmesh_tpu_torch.cli.{mod}", "-m", model,
                 "--device", dev.type, *more], env, f"{mod} {name}")
        res = json.load(open(os.path.join(model, "results.json")))
        psnr = {k: v["PSNR"] for k, v in res.items()}
        out["runs"][name] = dict(flags=extra, train_s=train_s, checkpoint=os.path.basename(
            ckpt), psnr=psnr)
        assert all(math.isfinite(v) for v in psnr.values()), psnr
    return out


def run(cmd, env, label):
    """One command to its end; its output's tail raised on a failure."""
    p = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=JOIN_S)
    if p.returncode:
        raise RuntimeError(f"{label} exited {p.returncode}:\n{(p.stdout + p.stderr)[-6000:]}")
    print(f"[multicard] {label}: ok", flush=True)


# ------------------------------------------------------------ model

def d4_model() -> dict | None:
    """The scaling tool's D = 4 model (results/scaling_torch.json): NVLink 4 assumed,
    overlap bound, on both clocks."""
    if not os.path.exists(MODEL_FILE):
        return None
    m = json.load(open(MODEL_FILE))
    em = m["efficiency_model"]
    out = dict(file="results/scaling_torch.json", card=m["card"],
               power_limit=m["power_limit"], link="nvlink4 (assumed 450 GB/s)",
               bound="overlap")
    for clock in ("host", "busy"):
        out[clock] = {ax: (em[clock][ax].get("4") or {}).get("nvlink4", {}).get(
            "eff_overlap") for ax in ("tile_axis", "gauss_shard_axis", "data_axis")}
        out[clock]["data_axis_no_overlap"] = (em[clock]["data_axis"].get("4") or {}).get(
            "nvlink4", {}).get("eff_no_overlap")
    c = m["comms"].get("4", {})
    out["exchange_design_bytes_leaving"] = c.get("exchange", {}).get("design_bytes_leaving")
    out["exchange_live_bytes_leaving"] = c.get("exchange", {}).get("live_bytes_leaving")
    return out


# ------------------------------------------------------------ main

def parser() -> argparse.ArgumentParser:
    import bench_torch

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--out", default=os.path.join(ROOT, "results", "multicard_torch.json"))
    p.add_argument("--meshes", nargs="+", default=[f"{a}x{b}" for a, b in MESHES],
                   help="the (data, tile) meshes of A, as DxT")
    p.add_argument("--size", type=int, default=SIZE)
    p.add_argument("--teacher_subdiv", type=int, default=TEACHER_SUBDIV)
    p.add_argument("--proxy_subdiv", type=int, default=PROXY_SUBDIV)
    p.add_argument("--init_target", type=int, default=INIT_TARGET)
    p.add_argument("--pretrain", type=int, default=PRETRAIN)
    p.add_argument("--playback", type=int, nargs=2, default=list(PLAYBACK_SIZE))
    p.add_argument("--bench_width", type=int, default=bench_torch.WIDTH)
    p.add_argument("--bench_height", type=int, default=bench_torch.HEIGHT)
    p.add_argument("--bench_n", type=int, default=bench_torch.N_GAUSS)
    p.add_argument("--procs", type=int, default=PROCS)
    p.add_argument("--timed", type=int, default=TIMED)
    p.add_argument("--warm", type=int, default=WARM)
    p.add_argument("--profiled", type=int, default=PROFILED)
    p.add_argument("--collective_reps", type=int, default=COLLECTIVE_REPS)
    p.add_argument("--cli_iters", type=int, default=CLI_ITERS)
    p.add_argument("--join_s", type=float, default=JOIN_S)
    return p


def rank_main(job: str, work: str) -> int:
    import torch.distributed as dist

    r = Rank(work)
    if job.startswith("mesh"):
        n_data, n_tile = (int(x) for x in job[4:].split("x"))
        rep = job_mesh(r, n_data, n_tile)
    elif job == "gshard":
        rep = job_gshard(r)
    else:
        rep = job_time(r)
    r.report(job, rep)
    dist.destroy_process_group()
    return 0


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    dev = pick_device(args.device)
    args.device = dev.type
    out = dict(tool="tools/multicard_torch.py", machine=machine(dev), world=WORLD,
               model_d4=d4_model())
    t_start = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="gm_multicard_") as work:
        t0 = time.perf_counter()
        prep = prepare(args, dev, work)
        out["config2"] = prep["model"]
        out["prepare_s"] = time.perf_counter() - t0
        references(prep, work)
        sync(dev)
        torch.cuda.empty_cache() if dev.type == "cuda" else None
        agree = dict(meshes={})
        for name in args.meshes:
            job = f"mesh{name}"
            spawn(job, work, args.join_s)
            reps = rank_reports(work, job)
            r0 = reps[0]
            for rep in reps:
                assert rep["hashes"] == r0["hashes"] and rep["losses"] == r0["losses"]
            agree["meshes"][name] = dict(
                backend=r0["backend"], devices=[rep["device"] for rep in reps],
                step1=[rep["step1"] for rep in reps], losses=r0["losses"],
                events=r0["events"], hashes_equal=True,
                launches=[rep["launches"] for rep in reps],
                step_ms_median=[statistics.median(rep["step_ms"][8:]) for rep in reps],
                playback=[rep["playback"] for rep in reps] if "playback" in r0 else None)
        spawn("gshard", work, args.join_s)
        reps = rank_reports(work, "gshard")
        r0 = reps[0]
        for rep in reps:
            assert rep["losses"] == r0["losses"] and rep["densify"] == r0["densify"]
            assert rep["pool_hashes"] == r0["pool_hashes"] and rep["resume_equal"]
        kr = r0["kernel_rank"]
        agree["gshard"] = dict(
            backend=r0["backend"], devices=[rep["device"] for rep in reps],
            step1=[rep["step1"] for rep in reps], losses=r0["losses"],
            events=r0["events"], densify=r0["densify"], resume_equal=True,
            checkpoint=r0["checkpoint"], traffic=r0["traffic"],
            received_live=[rep["received_live"] for rep in reps],
            launches=[rep["launches"] for rep in reps],
            step_ms_median=[statistics.median(rep["step_ms"]) for rep in reps],
            one_card_load=check_one_card_load(prep, work, dev),
            kernel_rank=kr, kernels=reps[kr]["kernels"])
        out["agreement"] = agree
        del prep["trainer"]
        sync(dev)
        torch.cuda.empty_cache() if dev.type == "cuda" else None
        worlds = []
        for _ in range(args.procs):
            spawn("time", work, args.join_s)
            worlds.append(rank_reports(work, "time"))
        summary = summarize_timing(worlds, WORLD)
        out["timing"] = dict(
            procs=args.procs, steps=args.timed, warm=args.warm,
            profiled=args.profiled, collective_reps=args.collective_reps,
            bench=worlds[0][0]["bench"], config2=worlds[0][0]["config2"],
            efficiency=dict(measured=summary["medians"], model_d4=out["model_d4"],
                            formula=("tile and Gaussian-table axes: plain / (4 x the "
                                     "critical rank's step); data axis: single-card "
                                     "step / (4, 1) step; the one-card steps the "
                                     "median over the ranks' cards; busy clock: device "
                                     "work without nccl's kernels + the step's "
                                     "collectives alone")),
            collectives=collectives_summary(worlds), per_world=summary["worlds"])
        out["entry_point"] = entry_point(args, dev, work)
    out["seconds"] = time.perf_counter() - t_start
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:              # afresh: never merged
        json.dump(out, fh, indent=1)
    print(json.dumps({"tool": out["tool"], "out": args.out, "seconds": out["seconds"],
                      "machine": {k: out["machine"][k] for k in ("cards", "count", "nccl")},
                      "efficiency": out["timing"]["efficiency"]["measured"]["host"]}),
          flush=True)
    return out


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        sys.exit(rank_main(sys.argv[2], sys.argv[3]))
    main()
