"""Background-model training loop (port of `gaussianmesh_tpu/train/bg_trainer.py`;
the reference train_bg_gaussian.py:43-155).

Phase 2 of the pipeline: with the trained mesh-bound foreground frozen, a
vanilla 3DGS background initialised from the SfM points trains on the
unmasked images. Per iteration: a random view and background color
(`opt.random_background`), the background's arrays and the foreground's
(built under `torch.no_grad()`, so no graph is recorded over the frozen
model) concatenated, background rows first, into one render (K1 forward,
K2 and K3 over the whole table backward), L1 + SSIM, Adam with the
scheduled learning rates, the densification statistics of the background
rows. After each iteration, in this order: background Gaussians within 0.1
of an alive mesh Gaussian retire at `remove_neighbor_iterations`; clone /
split / prune every 500 iterations (fixed, train_bg_gaussian.py:144) inside
(densify_from_iter, densify_until_iter); the opacity reset (opacity's
moments zeroed) every `opacity_reset_interval` iterations and, with a white
background, at densify_from_iter, both only before densify_until_iter. The
SH degree goes up every 1000 iterations.

As in `MeshTrainer`, one `torch.Generator` seeded with `rt.seed` draws the
views, backgrounds and split samples, and `capture()` is a host copy of the
whole state with its generator state.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from gaussianmesh_tpu_torch import resolve_device
from gaussianmesh_tpu_torch.config import OptimizationParams, RuntimeParams
from gaussianmesh_tpu_torch.io import gaussian_ply
from gaussianmesh_tpu_torch.models import gaussians as gs
from gaussianmesh_tpu_torch.models import render as render_mod
from gaussianmesh_tpu_torch.models.mesh_gaussians import MeshGaussianModel
from gaussianmesh_tpu_torch.ops.rasterize import RasterizerConfig
from gaussianmesh_tpu_torch.train import densify as densify_mod
from gaussianmesh_tpu_torch.train import loss as loss_mod
from gaussianmesh_tpu_torch.train.optim import Adam, gaussian_lr_fn
from gaussianmesh_tpu_torch.train.trainer import DeviceDataset, copy_tree
from gaussianmesh_tpu_torch.utils.graphics import CameraArrays

DENSIFY_INTERVAL = 500   # train_bg_gaussian.py:144, not a flag


class BgTrainer:
    """Trains a background `GaussianModel` (`model`) beside the frozen
    mesh-bound `fg` on a `DeviceDataset`. State: `model` (with its alive
    mask and statistics), `adam`, `sh_degree`, `global_it`, `gen`. `events`
    lists (iteration, kind, details) for every neighbour prune, densify and
    opacity reset."""

    def __init__(self, fg: MeshGaussianModel, points: np.ndarray,
                 colors: np.ndarray, dataset: DeviceDataset,
                 opt: OptimizationParams, rt: RuntimeParams,
                 spatial_lr_scale: float, white_background: bool = True,
                 max_sh_degree: int = 3,
                 remove_neighbor_iterations=(1000, 10_000)):
        self.opt, self.rt, self.ds = opt, rt, dataset
        self.device = dataset.images.device
        self.max_sh_degree = max_sh_degree
        self.extent = spatial_lr_scale
        self.white_background = white_background
        self.bg_const = (torch.ones(3, device=self.device) if white_background
                         else torch.zeros(3, device=self.device))
        self.remove_neighbor_iterations = set(remove_neighbor_iterations)
        self.gen = torch.Generator().manual_seed(rt.seed)

        self.fg = fg.requires_grad_(False)
        with torch.no_grad():
            self.fg_xyz = fg.get_xyz()

        cap = rt.capacity or densify_mod.round_up(max(points.shape[0] * 4, 65536), 4096)
        self.model = gs.create_from_points(points, colors, cap,
                                           max_sh_degree=max_sh_degree,
                                           device=self.device)
        self.adam = Adam(self.model.params(), gaussian_lr_fn(opt, spatial_lr_scale))
        self.sh_degree = 0
        self.global_it = 0
        self.metrics_log: list[dict] = []
        self.events: list[tuple[int, str, dict]] = []
        self.logger = None

    def raster_cfg(self) -> RasterizerConfig:
        return RasterizerConfig.from_runtime(self.rt, self.ds.width, self.ds.height)

    def _arrays(self, cam: CameraArrays) -> render_mod.GaussianArrays:
        """Background rows first, then the frozen foreground's."""
        with torch.no_grad():
            fg = render_mod.mesh_model_arrays(self.fg, cam, self.max_sh_degree)
        bg = render_mod.gaussian_model_arrays(self.model, cam, self.sh_degree)
        return render_mod.concat_arrays(bg, render_mod.freeze(fg))

    # --------------------------------------------------------------- step
    def step(self, cam_idx: int, bg: torch.Tensor) -> dict[str, torch.Tensor]:
        """One training step on view `cam_idx` over background `bg` (3,):
        forward, backward, Adam, densification statistics of the background
        rows. -> metrics (device tensors)."""
        m = self.model
        cap = m.capacity
        cam = self.ds.camera(cam_idx)
        gt = self.ds.images[cam_idx].to(torch.float32) / 255.0
        lam = self.opt.lambda_dssim
        params = m.params()
        m2d_off = torch.zeros((cap + self.fg.capacity, 2), device=self.device,
                              requires_grad=True)
        out = render_mod.render(self._arrays(cam), cam, self.raster_cfg(), bg,
                                mean2d_offset=m2d_off)
        l1 = loss_mod.l1_loss(out.color, gt)
        ssim_v = loss_mod.ssim(out.color, gt)
        total = (1.0 - lam) * l1 + lam * (1.0 - ssim_v)
        leaves = list(params.values()) + [m2d_off]
        grads = torch.autograd.grad(total, leaves, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g
                 for x, g in zip(leaves, grads)]

        self.adam.update(params, dict(zip(params, grads[:-1])))
        with torch.no_grad():
            vis = out.visibility[:cap]
            st = densify_mod.add_densification_stats(
                m.state, grads[-1][:cap], vis, self.ds.width, self.ds.height)
            m.state = st._replace(max_radii2d=torch.where(
                vis, torch.maximum(st.max_radii2d, out.radii[:cap].to(torch.float32)),
                st.max_radii2d))
        return {"loss": total.detach(), "l1": l1.detach(), "ssim": ssim_v.detach(),
                "tile_overflow": out.tile_overflow,
                "rect_overflow": out.rect_overflow,
                "num_rendered": out.num_rendered}

    # ------------------------------------------------------------ densify
    def densify(self) -> dict:
        """One clone / split / prune pass; grows the capacity by 3/2 and
        retries (up to 4 times) when the new rows do not fit. -> counts."""
        max_new = densify_mod.round_up(max(256, self.model.capacity // 16), 256)
        eps = torch.randn((2 * max_new, 3), generator=self.gen).to(self.device)
        for _attempt in range(4):
            res = densify_mod.densify_and_prune_bg(
                self.model, self.adam.mu, self.adam.nu,
                densify_mod.grads_avg(self.model.state), eps,
                self.opt.densify_grad_threshold, 0.005, self.extent,
                self.opt.percent_dense, -1.0, max_new)
            if res.dropped == 0:
                self.model = res.model
                self.adam.mu, self.adam.nu = res.mu, res.nu
                return dict(n_cloned=res.n_cloned, n_split=res.n_split,
                            n_pruned=res.n_pruned)
            self._grow(self.model.capacity * 3 // 2)
        raise RuntimeError(f"bg densify could not fit {res.dropped} new Gaussians "
                           f"after 4 capacity grows (cap {self.model.capacity})")

    def _grow(self, new_cap: int):
        new_cap = densify_mod.round_up(new_cap, 4096)
        m = self.model
        self.model = gs.GaussianModel(
            {k: densify_mod.pad0(v.detach(), new_cap) for k, v in m.params().items()},
            densify_mod.pad0(m.alive, new_cap),
            gs.GaussianState(*(densify_mod.pad0(x, new_cap) for x in m.state)))
        self.adam.mu = {k: densify_mod.pad0(v, new_cap) for k, v in self.adam.mu.items()}
        self.adam.nu = {k: densify_mod.pad0(v, new_cap) for k, v in self.adam.nu.items()}

    def prune_near_mesh(self) -> int:
        """Retire the background rows near the mesh model -> how many."""
        before = int(self.model.alive.sum())
        self.model.alive = densify_mod.prune_near_mesh(
            self.model.alive, self.model.xyz.detach(), self.fg_xyz, self.fg.alive)
        return before - int(self.model.alive.sum())

    def reset_opacity(self):
        with torch.no_grad():
            self.model.opacity.copy_(densify_mod.reset_opacity_bg(self.model.opacity))
        self.adam.mu["opacity"] = torch.zeros_like(self.adam.mu["opacity"])
        self.adam.nu["opacity"] = torch.zeros_like(self.adam.nu["opacity"])

    # -------------------------------------------------------------- train
    def _draw(self) -> tuple[int, torch.Tensor]:
        """A random view and background for the next iteration."""
        cam_idx = int(torch.randint(0, self.ds.images.shape[0], (),
                                    generator=self.gen))
        if self.opt.random_background:
            return cam_idx, torch.rand(3, generator=self.gen).to(self.device)
        return cam_idx, self.bg_const

    def train(self, iterations: int | None = None, log_every: int = 50,
              callback=None) -> list[dict]:
        """Run `iterations` iterations (default `opt.iterations`), one step
        each, with the host events after each; the schedules key off the
        global iteration, so train() can be called in segments."""
        opt = self.opt
        iterations = iterations or opt.iterations
        t0 = time.time()
        for done in range(1, iterations + 1):
            it = self.global_it + 1
            if it % 1000 == 0 and self.sh_degree < self.max_sh_degree:
                self.sh_degree += 1
            metrics = self.step(*self._draw())
            self.global_it = it

            if it in self.remove_neighbor_iterations:
                self.events.append((it, "prune_near_mesh",
                                    {"n_retired": self.prune_near_mesh()}))
            in_window = it < opt.densify_until_iter
            if in_window and it > opt.densify_from_iter and it % DENSIFY_INTERVAL == 0:
                before = int(self.model.alive.sum())
                info = self.densify()
                self.events.append((it, "densify", dict(
                    info, n_alive_before=before,
                    n_alive_after=int(self.model.alive.sum()))))
            if in_window and (it % opt.opacity_reset_interval == 0
                              or (self.white_background
                                  and it == opt.densify_from_iter)):
                self.reset_opacity()
                self.events.append((it, "opacity_reset", {}))

            if it % log_every == 0 or done == iterations:
                row = {k: float(v) for k, v in metrics.items()}
                row.update(iter=it, n_alive=int(self.model.alive.sum()),
                           elapsed=time.time() - t0)
                self.metrics_log.append(row)
                if self.logger is not None:
                    self.logger.scalars(it, {f"train_bg/{k}": v for k, v in
                                             row.items() if k != "iter"})
                if callback:
                    callback(row)
        return self.metrics_log

    # ---------------------------------------------------------- artifacts
    @torch.no_grad()
    def render_view(self, cam: CameraArrays, bg: torch.Tensor | None = None):
        return render_mod.render(self._arrays(cam), cam, self.raster_cfg(),
                                 self.bg_const if bg is None else bg)

    def save(self, out_dir: str) -> None:
        os.makedirs(out_dir, exist_ok=True)
        gaussian_ply.save_gaussian_ply(os.path.join(out_dir, "bg_point_cloud.ply"),
                                       self.model)

    def capture(self) -> dict:
        """The whole training state as a host copy: "params", "state", "mu",
        "nu" ({field: CPU tensor}), "alive", "step", "sh_degree",
        "global_it" and "gen" (the generator's state)."""
        m = self.model
        return dict(params=copy_tree(m.params()), alive=m.alive.to("cpu", copy=True),
                    state=copy_tree(m.state._asdict()), mu=copy_tree(self.adam.mu),
                    nu=copy_tree(self.adam.nu), step=int(self.adam.step),
                    sh_degree=int(self.sh_degree), global_it=int(self.global_it),
                    gen=self.gen.get_state())

    def restore(self, state: dict) -> None:
        """Take over a state from `capture()` or `bg_trainer_state_from_numpy`
        (no generator state: the generator stays as it is)."""
        dev = self.device
        self.model = gs.GaussianModel(
            copy_tree(state["params"], dev), state["alive"].to(dev, copy=True),
            gs.GaussianState(**copy_tree(state["state"], dev)))
        self.adam.mu = copy_tree(state["mu"], dev)
        self.adam.nu = copy_tree(state["nu"], dev)
        self.adam.step = int(state["step"])
        self.sh_degree = int(state["sh_degree"])
        self.global_it = int(state.get("global_it", 0))
        if "gen" in state:
            self.gen.set_state(state["gen"])


def bg_trainer_state_from_numpy(capture: dict, device=None) -> dict:
    """The JAX `BgTrainer.capture()` as numpy -> the port's state (for
    `BgTrainer.restore`; no generator state). `capture` maps "params",
    "state", "mu" and "nu" to {field: array} with the JAX dataclasses' field
    names ("state" holds "alive" and the statistics), "step" to the
    optimizer step, "sh_degree" and optionally "global_it" to ints."""
    dev = resolve_device(device)

    def f32(tree, fields):
        return {k: torch.tensor(np.asarray(tree[k], np.float32), device=dev)
                for k in fields}

    st = capture["state"]
    return dict(params=f32(capture["params"], gs.PARAM_FIELDS),
                alive=torch.tensor(np.asarray(st["alive"], bool), device=dev),
                state=f32(st, gs.STATE_FIELDS), mu=f32(capture["mu"], gs.PARAM_FIELDS),
                nu=f32(capture["nu"], gs.PARAM_FIELDS), step=int(capture["step"]),
                sh_degree=int(capture["sh_degree"]),
                global_it=int(capture.get("global_it", 0)))
