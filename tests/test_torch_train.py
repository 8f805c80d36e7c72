"""The port's training slice against the JAX package on the CPU: losses,
Adam with scheduled learning rates, densification, one trainer step from a
carried-across state, the event schedule, and a short synthetic fit."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianmesh_tpu.config import OptimizationParams as JOpt
from gaussianmesh_tpu.config import RuntimeParams as JRt
from gaussianmesh_tpu.data.cameras import Camera as JCamera
from gaussianmesh_tpu.io import mesh as jmesh_io
from gaussianmesh_tpu.models import mesh_gaussians as jmgs
from gaussianmesh_tpu.train import densify as jdensify
from gaussianmesh_tpu.train import loss as jloss
from gaussianmesh_tpu.train import optim as joptim
from gaussianmesh_tpu.train import trainer as jtrainer
from gaussianmesh_tpu.utils.lr import expon_lr as jexpon_lr
from gaussianmesh_tpu_torch.config import OptimizationParams, RuntimeParams
from gaussianmesh_tpu_torch.data.cameras import Camera
from gaussianmesh_tpu_torch.io import mesh as mesh_io
from gaussianmesh_tpu_torch.models import mesh_gaussians as mgs
from gaussianmesh_tpu_torch.models import render as render_mod
from gaussianmesh_tpu_torch.ops.rasterize import RasterizerConfig
from gaussianmesh_tpu_torch.train import densify, loss, optim
from gaussianmesh_tpu_torch.train.trainer import (DeviceDataset, MeshTrainer,
                                                  trainer_state_from_numpy)
from gaussianmesh_tpu_torch.utils import sh as sh_utils
from gaussianmesh_tpu_torch.utils.graphics import CameraArrays
from gaussianmesh_tpu_torch.utils.lr import expon_lr
from tests.meshes import icosphere
from tests.scenes import look_at_camera

torch.set_num_threads(2)

W = H = 64


def _t(x):
    return torch.tensor(np.asarray(x))


def _fields(x) -> dict:
    return {f: np.asarray(getattr(x, f)) for f in type(x).__dataclass_fields__}


# ------------------------------------------------------------------ losses
def test_losses_and_their_gradients_match_jax():
    rng = np.random.default_rng(0)
    a = rng.uniform(0, 1, (3, 32, 40)).astype(np.float32)
    b = np.clip(a + 0.2 * rng.normal(size=a.shape), 0, 1).astype(np.float32)
    for name in ("l1_loss", "ssim"):
        fj, ft = getattr(jloss, name), getattr(loss, name)
        vj, gj = jax.value_and_grad(fj)(jnp.asarray(a), jnp.asarray(b))
        ta = _t(a).requires_grad_()
        vt = ft(ta, _t(b))
        (gt,) = torch.autograd.grad(vt, ta)
        np.testing.assert_allclose(vt.item(), float(vj), rtol=1e-6, err_msg=name)
        np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-5,
                                   atol=1e-5 * np.abs(np.asarray(gj)).max(),
                                   err_msg=name)
    np.testing.assert_allclose(float(loss.psnr(_t(a), _t(b))),
                               float(jloss.psnr(jnp.asarray(a), jnp.asarray(b))),
                               rtol=1e-6)

    n = 200
    scaling = np.exp(rng.normal(-2.0, 1.5, (n, 3))).astype(np.float32)
    v1, v2, v3 = (rng.normal(0, 0.05, (n, 3)).astype(np.float32) for _ in range(3))
    alive = rng.uniform(size=n) < 0.8
    vj, gj = jax.value_and_grad(jloss.mesh_restrict_loss)(
        jnp.asarray(scaling), jnp.asarray(v1), jnp.asarray(v2), jnp.asarray(v3),
        jnp.asarray(alive), 6.0)
    ts = _t(scaling).requires_grad_()
    vt = loss.mesh_restrict_loss(ts, _t(v1), _t(v2), _t(v3), _t(alive), 6.0)
    (gt,) = torch.autograd.grad(vt, ts)
    assert float(vj) > 0
    np.testing.assert_allclose(vt.item(), float(vj), rtol=1e-6)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-5, atol=1e-7)


# ------------------------------------------------------------ Adam and lr
def test_expon_lr_matches_jax():
    """A short schedule, and the config-2 protocol's position schedule
    (`position_lr_max_steps` 30,000) at its start, middle, last step and end."""
    for max_steps, steps in ((100, (-1, 0, 1, 5, 50, 99, 100, 250)),
                             (30_000, (0, 15_000, 29_999, 30_000))):
        for step in steps:
            for kw in (dict(), dict(lr_delay_steps=10, lr_delay_mult=0.01)):
                got = expon_lr(step, 1.6e-4 * 3.2, 1.6e-6 * 3.2,
                               max_steps=max_steps, **kw)
                want = float(jexpon_lr(step, 1.6e-4 * 3.2, 1.6e-6 * 3.2,
                                       max_steps=max_steps, **kw))
                assert got == pytest.approx(want, rel=1e-6, abs=0.0), (
                    max_steps, step, kw)


def test_adam_with_scheduled_lr_matches_optax_over_5_steps():
    v, f = icosphere(0)
    p, b, _, _ = jmgs.create_from_mesh(jnp.asarray(v), jnp.asarray(f), capacity=32,
                                       vertex_capacity=32)
    rng = np.random.default_rng(4)
    pj = jax.tree.map(lambda x: x + jnp.asarray(
        rng.normal(0, 0.1, x.shape).astype(np.float32)), p)
    tp = {k: _t(x).clone() for k, x in _fields(pj).items()}
    opt = OptimizationParams(position_lr_max_steps=3)
    jopt = JOpt(position_lr_max_steps=3)
    tx = joptim.make_optimizer(joptim.mesh_lr_tree_fn(jopt, 2.0))
    sj = tx.init(pj)
    adam = optim.Adam(tp, optim.mesh_lr_fn(opt, 2.0))
    for _ in range(5):
        g = {k: rng.normal(0, 1e-2, x.shape).astype(np.float32)
             for k, x in tp.items()}
        upd, sj = tx.update(type(pj)(**{k: jnp.asarray(x) for k, x in g.items()}),
                            sj, pj)
        pj = jax.tree.map(lambda a, u: a + u, pj, upd)
        adam.update(tp, {k: _t(x) for k, x in g.items()})
    assert adam.step == int(sj.step) == 5
    # 1e-6 relative to each leaf's largest value: an update that rounds
    # one ulp apart moves p + u by an ulp of p, not of the element
    for k, x in _fields(pj).items():
        for got, want in ((tp[k], x), (adam.mu[k], getattr(sj.adam.mu, k)),
                          (adam.nu[k], getattr(sj.adam.nu, k))):
            want = np.asarray(want)
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                       atol=1e-6 * np.abs(want).max(), err_msg=k)


# ----------------------------------------------------------------- densify
def _jax_model(capacity, vertex_capacity, seed=5):
    """icosphere(1) (80 faces, 42 vertices), parameters and moments
    perturbed from a seed so every copied value is distinguishable."""
    v, f = icosphere(1)
    p, b, mv, st = jmgs.create_from_mesh(jnp.asarray(v), jnp.asarray(f),
                                         capacity=capacity,
                                         vertex_capacity=vertex_capacity)
    rng = np.random.default_rng(seed)

    def noise(x):
        return x + jnp.asarray(rng.normal(0, 0.1, x.shape).astype(np.float32))

    p = jax.tree.map(noise, p)
    mu = jax.tree.map(noise, jax.tree.map(jnp.zeros_like, p))
    nu = jax.tree.map(lambda x: jnp.abs(noise(x)), jax.tree.map(jnp.zeros_like, p))
    st = jmgs.MeshGaussianState(*(jnp.asarray(rng.uniform(0, 1, capacity)
                                              .astype(np.float32)) for _ in range(3)))
    return p, b, mv, st, mu, nu


def _port_model(p, b, mv, st):
    return mgs.from_numpy(_fields(p), _fields(b), device="cpu",
                          mesh_v=_fields(mv), state=_fields(st))


def _assert_split_equal(rj, rt):
    assert rt.n_split == int(rj.n_split) and rt.dropped == int(rj.dropped)
    for k, x in _fields(rj.params).items():
        np.testing.assert_allclose(getattr(rt.model, k).detach().numpy(), x,
                                   rtol=1e-6, atol=1e-6, err_msg=k)
    for k, x in _fields(rj.binding).items():
        got = getattr(rt.model, k).numpy()
        if x.dtype.kind in "ib":
            np.testing.assert_array_equal(got, x, err_msg=k)
        else:
            np.testing.assert_allclose(got, x, rtol=1e-6, atol=1e-6, err_msg=k)
    assert rt.model.mesh_v.count == int(rj.mesh_v.count)
    np.testing.assert_allclose(rt.model.mesh_v.v.numpy(), np.asarray(rj.mesh_v.v),
                               rtol=1e-6, atol=1e-6)
    for k in mgs.PARAM_FIELDS:
        np.testing.assert_allclose(rt.mu[k].numpy(), np.asarray(getattr(rj.mu, k)),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(rt.nu[k].numpy(), np.asarray(getattr(rj.nu, k)),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
    for k, x in _fields(rj.state).items():
        np.testing.assert_array_equal(getattr(rt.model.state, k).numpy(), x)


# (capacity, vertex capacity, max_split): room for every split; too few
# free Gaussian slots; too few free vertex slots (42 + 3 * 4)
@pytest.mark.parametrize("capacity,vertex_capacity,max_split", [
    (512, 2048, 64), (128, 2048, 32), (512, 54, 64)])
def test_densify_and_split_matches_jax(capacity, vertex_capacity, max_split):
    p, b, mv, st, mu, nu = _jax_model(capacity, vertex_capacity)
    rng = np.random.default_rng(6)
    # many ties: the order of equal gradients decides who splits
    grads = rng.choice([0.0, 1e-4, 3e-4, 5e-4], capacity).astype(np.float32)
    rj = jdensify.densify_and_split(p, b, mv, mu, nu, st, jnp.asarray(grads),
                                    2e-4, 5, max_split)
    model = _port_model(p, b, mv, st)
    rt = densify.densify_and_split(model, {k: _t(x) for k, x in _fields(mu).items()},
                                   {k: _t(x) for k, x in _fields(nu).items()},
                                   _t(grads), 2e-4, 5, max_split)
    assert rt.n_split > 0
    assert (rt.dropped > 0) == (capacity == 128 or vertex_capacity == 54)
    _assert_split_equal(rj, rt)


def test_split_all_for_init_matches_jax():
    p, b, mv, st, mu, nu = _jax_model(512, 2048)
    rj = jdensify.split_all_for_init(p, b, mv, mu, nu, st, max_split=256)
    rt = densify.split_all_for_init(_port_model(p, b, mv, st),
                                    {k: _t(x) for k, x in _fields(mu).items()},
                                    {k: _t(x) for k, x in _fields(nu).items()}, 256)
    assert rt.n_split == 80 and int(rt.model.alive.sum()) == 320
    _assert_split_equal(rj, rt)


def test_reset_opacity_and_densification_stats_match_jax():
    rng = np.random.default_rng(7)
    p, b, mv, st, _, _ = _jax_model(256, 256)
    got = densify.reset_opacity(_t(p.opacity)).numpy()
    np.testing.assert_allclose(got, np.asarray(jdensify.reset_opacity(p).opacity),
                               rtol=1e-6, atol=1e-6)
    g2d = rng.normal(0, 1e-3, (256, 2)).astype(np.float32)
    vis = rng.uniform(size=256) < 0.7
    sj = jdensify.add_densification_stats(st, jnp.asarray(g2d), jnp.asarray(vis), 64, 48)
    stt = densify.add_densification_stats(
        mgs.MeshGaussianState(*(_t(x) for x in _fields(st).values())), _t(g2d),
        _t(vis), 64, 48)
    for k, x in _fields(sj).items():
        np.testing.assert_allclose(getattr(stt, k).numpy(), x, rtol=1e-6, err_msg=k)
    sj = sj.replace(denom=sj.denom.at[:10].set(0.0))
    stt = stt._replace(denom=stt.denom.clone().index_fill_(0, torch.arange(10), 0.0))
    np.testing.assert_allclose(densify.grads_avg(stt).numpy(),
                               np.asarray(jdensify.grads_avg(sj)), rtol=1e-6)


# ----------------------------------------------------------------- trainer
def _dataset():
    """12 orbit views of a colored near-opaque sphere (icosphere 2),
    rendered by the port: -> (numpy camera stacks, uint8 images)."""
    cams = [look_at_camera(W, H, distance=3.2, azimuth=2 * np.pi * i / 12,
                           elevation=0.4 * np.sin(i)) for i in range(12)]
    v, f = icosphere(2)
    teacher = mgs.create_from_mesh(v, f, device="cpu")
    with torch.no_grad():
        cent = teacher.get_xyz()
        teacher.features_dc.copy_(sh_utils.rgb_to_sh(
            (cent / cent.abs().max() + 1.0) / 2.0)[:, None, :])
        teacher.opacity.fill_(4.0)
        images = []
        for c in cams:
            tc = CameraArrays.from_numpy(*[np.asarray(x) for x in c], device="cpu")
            out = render_mod.render(render_mod.mesh_model_arrays(teacher, tc, 0), tc,
                                    RasterizerConfig(W, H, max_per_tile=256),
                                    torch.ones(3))
            images.append((out.color.clamp(0, 1).numpy() * 255).astype(np.uint8))
    stacks = [np.stack([np.asarray(getattr(c, k)) for c in cams])
              for k in ("viewmatrix", "projmatrix", "campos", "tanfovx", "tanfovy")]
    return stacks, np.stack(images)


@pytest.fixture(scope="module")
def dataset():
    return _dataset()


def _port_dataset(dataset):
    stacks, images = dataset
    return DeviceDataset(*(torch.tensor(x.astype(np.float32)) for x in stacks),
                         images=torch.tensor(images), masks=None, width=W, height=H)


def _jax_dataset(dataset):
    stacks, images = dataset
    return jtrainer.DeviceDataset(*(jnp.asarray(x) for x in stacks),
                                  images=jnp.asarray(images), masks=None,
                                  width=W, height=H)


def _trainers(dataset, opt_kw, max_sh_degree=1):
    v, f = icosphere(1)
    jt = jtrainer.MeshTrainer(v, f, _jax_dataset(dataset), JOpt(**opt_kw),
                              JRt(max_per_tile=256, use_pallas=False),
                              spatial_lr_scale=3.2, init_target=300,
                              max_sh_degree=max_sh_degree)
    jt.steps_per_dispatch = 1
    pt = MeshTrainer(v, f, _port_dataset(dataset), OptimizationParams(**opt_kw),
                     RuntimeParams(max_per_tile=256), spatial_lr_scale=3.2,
                     init_target=300, max_sh_degree=max_sh_degree)
    return jt, pt


def _capture_np(jt) -> dict:
    c = jt.capture()
    return dict(params=_fields(c["params"]), binding=_fields(c["binding"]),
                mesh_v=_fields(c["mesh_v"]), state=_fields(c["state"]),
                mu=_fields(c["opt_state"].adam.mu), nu=_fields(c["opt_state"].adam.nu),
                step=int(c["opt_state"].step), sh_degree=c["sh_degree"],
                global_it=int(c["global_it"]))


def test_trainer_step_matches_jax(dataset):
    jt, pt = _trainers(dataset, {})
    # the init subdivision is the JAX trainer's (colors aside: other RNG)
    cj = _capture_np(jt)
    assert pt.model.capacity == cj["binding"]["alive"].shape[0]
    for k, x in cj["binding"].items():
        np.testing.assert_allclose(getattr(pt.model, k).numpy(), x, rtol=1e-6,
                                   atol=1e-6, err_msg=k)
    assert pt.model.mesh_v.count == int(cj["mesh_v"]["count"])
    np.testing.assert_allclose(pt.model.mesh_v.v.numpy(), cj["mesh_v"]["v"],
                               rtol=1e-6, atol=1e-6)

    # one step from the JAX trainer's state, same view and background;
    # scales made anisotropic and rotations turned so rotation has a gradient
    rng = np.random.default_rng(8)
    for k in ("scaling", "rotation"):
        cj["params"][k] = cj["params"][k] + rng.normal(
            0, 0.3, cj["params"][k].shape).astype(np.float32)
    jt.params = jt.params.replace(scaling=jnp.asarray(cj["params"]["scaling"]),
                                  rotation=jnp.asarray(cj["params"]["rotation"]))
    pt.restore(trainer_state_from_numpy(cj, device="cpu"))
    jt.sh_degree = pt.sh_degree = 1
    cam_idx, bg = 5, np.array([0.3, 0.6, 0.9], np.float32)
    cap = pt.model.capacity
    params, opt_state, state, mj = jt._get_step_fn(1, cap)(
        jt.params, jt.opt_state, jt.state, jt.binding, jnp.int32(cam_idx),
        jnp.asarray(bg))
    mt = pt.step(cam_idx, _t(bg))
    assert float(mt["loss"]) == pytest.approx(float(mj["loss"]), rel=1e-5)
    assert int(mt["num_rendered"]) == int(mj["num_rendered"])

    # the moments started at 0, so mu = (1 - b1) g: the gradients
    for k in mgs.PARAM_FIELDS:
        gj = np.asarray(getattr(opt_state.adam.mu, k)) / 0.1
        gt = pt.adam.mu[k].numpy() / 0.1
        scale = np.abs(gj).max()
        assert scale > 0, k
        np.testing.assert_allclose(gt / scale, gj / scale, atol=2e-4, err_msg=k)
        big = np.abs(gj) > 1e-3 * scale
        np.testing.assert_allclose(getattr(pt.model, k).detach().numpy()[big],
                                   np.asarray(getattr(params, k))[big],
                                   rtol=1e-6, atol=1e-6, err_msg=k)
        # nu = (1 - b2) g^2: twice the gradient's normalized bar
        nuj = np.asarray(getattr(opt_state.adam.nu, k))
        np.testing.assert_allclose(pt.adam.nu[k].numpy() / nuj.max(), nuj / nuj.max(),
                                   atol=4e-4, err_msg=k)
    # densification statistics: |d loss / d mean2d| per visible Gaussian
    for k in ("grad_accum", "denom", "max_radii2d"):
        a, b = np.asarray(getattr(state, k)), getattr(pt.model.state, k).numpy()
        np.testing.assert_allclose(b / a.max(), a / a.max(), atol=2e-4, err_msg=k)
    assert pt.adam.step == int(opt_state.step) == 1


# ------------------------------------------------- the late schedule
LATE_IT = 20_000
# the config-2 protocol's schedule past its densify window (15,000)
LATE_OPT = dict(position_lr_max_steps=30_000, densify_until_iter=15_000)


def _jax_tree(cls, tree: dict):
    return cls(**{k: jnp.asarray(x) for k, x in tree.items()})


@pytest.fixture(scope="module")
def late_state(dataset):
    """A JAX trainer's state moved to the protocol's late schedule, as numpy
    (`_capture_np`'s keys): the global iteration and the Adam step counter
    at 20,000, SH degree 2 (its rest coefficients and the scales and
    rotations perturbed from a seed), mu and nu seeded non-zero from numpy
    at each leaf's gradient scale (the largest |gradient| of one step from
    zero moments)."""
    jt, _ = _trainers(dataset, LATE_OPT, max_sh_degree=2)
    c = _capture_np(jt)
    rng = np.random.default_rng(11)
    for k, sd in (("scaling", 0.3), ("rotation", 0.3), ("features_rest", 0.1)):
        c["params"][k] = c["params"][k] + rng.normal(
            0, sd, c["params"][k].shape).astype(np.float32)
    params = _jax_tree(type(jt.params), c["params"])
    _, probe, _, _ = jt._get_step_fn(2, c["binding"]["alive"].shape[0])(
        params, jt.tx.init(params), jt.state, jt.binding, jnp.int32(5),
        jnp.ones(3, jnp.float32))
    for k in mgs.PARAM_FIELDS:
        scale = float(np.abs(np.asarray(getattr(probe.adam.mu, k))).max()) / 0.1
        assert scale > 0, k
        shape = c["params"][k].shape
        c["mu"][k] = (scale * rng.normal(0, 1, shape)).astype(np.float32)
        c["nu"][k] = (scale * rng.uniform(0.5, 2.0, shape)).astype(np.float32) ** 2
    c.update(step=LATE_IT, global_it=LATE_IT, sh_degree=2)
    return c


def _late_pair(dataset, c):
    """(JAX trainer, port trainer), both holding the late state `c`."""
    import optax

    jt, pt = _trainers(dataset, LATE_OPT, max_sh_degree=2)
    cls = type(jt.params)
    jt.params = _jax_tree(cls, c["params"])
    jt.opt_state = joptim.OptState(
        adam=optax.ScaleByAdamState(count=jnp.int32(LATE_IT),
                                    mu=_jax_tree(cls, c["mu"]),
                                    nu=_jax_tree(cls, c["nu"])),
        step=jnp.int32(LATE_IT))
    jt.sh_degree, jt.global_it = 2, LATE_IT
    pt.restore(trainer_state_from_numpy(c, device="cpu"))
    assert (pt.sh_degree, pt.global_it, pt.adam.step) == (2, LATE_IT, LATE_IT)
    return jt, pt


def test_late_step_matches_jax(dataset, late_state):
    """One step at iteration 20,001 of the protocol's schedule in each
    package, at the step-1 test's bars: the gradients (from mu_new - b1 mu)
    within 2e-4 of each leaf's largest, the parameters within 1e-6 where the
    gradient is large, nu within 4e-4 of its largest, the densification
    statistics within 2e-4."""
    c = late_state
    jt, pt = _late_pair(dataset, c)
    cam_idx, bg = 5, np.ones(3, np.float32)
    cap = pt.model.capacity
    params, opt_state, state, mj = jt._get_step_fn(2, cap)(
        jt.params, jt.opt_state, jt.state, jt.binding, jnp.int32(cam_idx),
        jnp.asarray(bg))
    mt = pt.step(cam_idx, _t(bg))
    assert float(mt["loss"]) == pytest.approx(float(mj["loss"]), rel=1e-5)
    assert int(mt["num_rendered"]) == int(mj["num_rendered"])
    assert pt.adam.step == int(opt_state.step) == int(opt_state.adam.count) == LATE_IT + 1
    for k in mgs.PARAM_FIELDS:
        gj = (np.asarray(getattr(opt_state.adam.mu, k)) - 0.9 * c["mu"][k]) / 0.1
        gt = (pt.adam.mu[k].numpy() - 0.9 * c["mu"][k]) / 0.1
        scale = np.abs(gj).max()
        assert scale > 0, k
        np.testing.assert_allclose(gt / scale, gj / scale, atol=2e-4, err_msg=k)
        big = np.abs(gj) > 1e-3 * scale
        np.testing.assert_allclose(getattr(pt.model, k).detach().numpy()[big],
                                   np.asarray(getattr(params, k))[big],
                                   rtol=1e-6, atol=1e-6, err_msg=k)
        nuj = np.asarray(getattr(opt_state.adam.nu, k))
        np.testing.assert_allclose(pt.adam.nu[k].numpy() / nuj.max(), nuj / nuj.max(),
                                   atol=4e-4, err_msg=k)
    for k in ("grad_accum", "denom", "max_radii2d"):
        a, b = np.asarray(getattr(state, k)), getattr(pt.model.state, k).numpy()
        np.testing.assert_allclose(b / a.max(), a / a.max(), atol=2e-4, err_msg=k)


def test_late_ten_steps_match_jax(dataset, late_state):
    """Ten steps from the late state over ten different views in each
    package (iterations 20,001-20,010, no densify or reset): every
    parameter within 5e-4 of its leaf's largest value, the bar of
    tests/test_parallel.py."""
    jt, pt = _late_pair(dataset, late_state)
    bg = np.ones(3, np.float32)
    cap = pt.model.capacity
    step = jt._get_step_fn(2, cap)
    params, opt_state, state = jt.params, jt.opt_state, jt.state
    for cam_idx in (0, 3, 7, 11, 2, 5, 9, 1, 4, 8):
        params, opt_state, state, mj = step(params, opt_state, state, jt.binding,
                                            jnp.int32(cam_idx), jnp.asarray(bg))
        mt = pt.step(cam_idx, _t(bg))
        assert float(mt["loss"]) == pytest.approx(float(mj["loss"]), rel=1e-4), cam_idx
    assert pt.adam.step == int(opt_state.step) == LATE_IT + 10
    for k in mgs.PARAM_FIELDS:
        want = np.asarray(getattr(params, k))
        np.testing.assert_allclose(getattr(pt.model, k).detach().numpy(), want,
                                   rtol=0, atol=5e-4 * np.abs(want).max(), err_msg=k)


def test_event_iterations_match_jax(dataset, monkeypatch):
    """Densify and opacity resets fire at the JAX trainer's iterations
    (one step per dispatch). The steps are stubbed: only the host loop's
    schedule is under test."""
    opt_kw = dict(densify_from_iter=5, densification_interval=4,
                  densify_until_iter=30, opacity_reset_interval=12)
    jt, pt = _trainers(dataset, opt_kw)
    fired_j = []

    def jstep(params, opt_state, state, binding, cam_idx, bg):
        return params, opt_state, state, {"loss": jnp.float32(0.0)}

    monkeypatch.setattr(jt, "_get_step_fn", lambda *a: jstep)
    jdens = jt.densify
    monkeypatch.setattr(jt, "densify",
                        lambda: (fired_j.append((jt.global_it, "densify")), jdens()))
    jreset = jdensify.reset_opacity
    monkeypatch.setattr(jtrainer.densify_mod, "reset_opacity", lambda p: (
        fired_j.append((jt.global_it, "opacity_reset")), jreset(p))[1])
    jt.train(iterations=36, log_every=1000)

    monkeypatch.setattr(pt, "step", lambda cam_idx, bg: {"loss": torch.tensor(0.0)})
    pt.train(iterations=36, log_every=1000)
    fired_t = [(it, kind) for it, kind, _ in pt.events]
    assert fired_t == fired_j
    assert (5, "opacity_reset") in fired_t and (24, "opacity_reset") in fired_t
    assert [it for it, kind in fired_t if kind == "densify"] == [8, 12, 16, 20, 24, 28]


def test_synthetic_fit_raises_psnr(dataset, tmp_path):
    """Like tests/test_train_e2e.py, on the port alone: 150 iterations
    from an icosphere-1 proxy lift held-in PSNR by more than 3 dB; `save`
    writes the PLY and the split mesh of the alive Gaussians."""
    v, f = icosphere(1)
    opt = OptimizationParams(densify_from_iter=10_000, densify_until_iter=20_000,
                             position_lr_max_steps=400)
    pt = MeshTrainer(v, f, _port_dataset(dataset), opt, RuntimeParams(max_per_tile=256),
                     spatial_lr_scale=3.2, init_target=300, max_sh_degree=1)
    psnr0 = pt.eval_psnr(range(3))
    log = pt.train(iterations=150, log_every=50)
    psnr = pt.eval_psnr(range(3))
    assert all(math.isfinite(m["loss"]) for m in log)
    assert psnr > psnr0 + 3.0, (psnr0, psnr)
    pt.save(str(tmp_path))
    sv, sf = mesh_io.read_triangle_mesh(str(tmp_path / "split_mesh.obj"))
    assert sv.shape == (pt.model.mesh_v.count, 3)
    assert sf.shape == (int(pt.model.alive.sum()), 3) and sf.max() < sv.shape[0]
    assert (tmp_path / "point_cloud.ply").exists()


def test_capacity_grows_when_the_init_split_runs_out_of_room(dataset):
    """capacity 256 holds 44 of the 80 init splits: the trainer grows the
    tables (to 4096 rows) and retries, ending where a trainer that started
    with room ends."""
    v, f = icosphere(1)
    ds = _port_dataset(dataset)
    kw = dict(spatial_lr_scale=3.2, init_target=300, max_sh_degree=1)
    grown = MeshTrainer(v, f, ds, OptimizationParams(),
                        RuntimeParams(max_per_tile=256, capacity=256), **kw)
    roomy = MeshTrainer(v, f, ds, OptimizationParams(),
                        RuntimeParams(max_per_tile=256), **kw)
    assert grown.model.capacity == roomy.model.capacity == 4096
    for name, x in roomy.model.binding().items():
        assert torch.equal(getattr(grown.model, name), x), name
    for name, x in roomy.model.params().items():
        assert torch.equal(getattr(grown.model, name), x), name
    assert grown.model.mesh_v.count == roomy.model.mesh_v.count
    assert torch.equal(grown.model.mesh_v.v[:grown.model.mesh_v.count],
                       roomy.model.mesh_v.v[:roomy.model.mesh_v.count])


@pytest.mark.parametrize("ext", ["obj", "ply"])
def test_mesh_io_round_trip_matches_jax(tmp_path, ext):
    v, f = icosphere(1)
    path = str(tmp_path / f"m.{ext}")
    mesh_io.write_triangle_mesh(path, v, f)
    for got, want in zip(mesh_io.read_triangle_mesh(path),
                         jmesh_io.read_triangle_mesh(path)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(mesh_io.read_triangle_mesh(path)[0], v, rtol=1e-6)


def test_device_dataset_from_cameras_matches_jax():
    """Host cameras -> the stacked on-device dataset, as the JAX package
    builds it (R, T, fov convention; uint8 images)."""
    rng = np.random.default_rng(9)
    kw = []
    for i in range(3):
        q = np.linalg.qr(rng.normal(size=(3, 3)))[0]
        kw.append(dict(uid=i, R=q, T=rng.normal(size=3), fovx=0.9, fovy=0.7,
                       image=rng.uniform(0, 1, (3, 24, 32)).astype(np.float32)))
    dj = jtrainer.DeviceDataset.from_cameras([JCamera(**k) for k in kw])
    dt = DeviceDataset.from_cameras([Camera(**k) for k in kw], device="cpu")
    assert (dt.width, dt.height) == (32, 24) == (dj.width, dj.height)
    for name in ("view", "proj", "campos", "tanfovx", "tanfovy", "images"):
        np.testing.assert_allclose(getattr(dt, name).numpy(),
                                   np.asarray(getattr(dj, name)), rtol=1e-6,
                                   atol=1e-6, err_msg=name)
