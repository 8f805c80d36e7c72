"""The port's background slice against the JAX package on the CPU: SfM
initialisation, clone / split / prune densification on the same split
samples, the neighbour prune, the opacity reset, the learning rates, one
`BgTrainer` step from a carried-across JAX state, and the event
schedule. Floats within 1e-6 of each leaf's scale; integers and masks
exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianmesh_tpu.config import OptimizationParams as JOpt
from gaussianmesh_tpu.config import RuntimeParams as JRt
from gaussianmesh_tpu.models import gaussians as jgs
from gaussianmesh_tpu.models import mesh_gaussians as jmgs
from gaussianmesh_tpu.train import bg_trainer as jbg
from gaussianmesh_tpu.train import densify as jdensify
from gaussianmesh_tpu.train import optim as joptim
from gaussianmesh_tpu.train import trainer as jtrainer
from gaussianmesh_tpu_torch.config import OptimizationParams, RuntimeParams
from gaussianmesh_tpu_torch.models import gaussians as gs
from gaussianmesh_tpu_torch.models import mesh_gaussians as mgs
from gaussianmesh_tpu_torch.train import densify, optim
from gaussianmesh_tpu_torch.train.bg_trainer import BgTrainer, bg_trainer_state_from_numpy
from gaussianmesh_tpu_torch.train.trainer import DeviceDataset
from tests.meshes import icosphere
from tests.scenes import look_at_camera

torch.set_num_threads(2)

W = H = 64


def _t(x):
    return torch.tensor(np.asarray(x))


def _fields(x) -> dict:
    return {f: np.asarray(getattr(x, f)) for f in type(x).__dataclass_fields__}


def _close(got, want, name=""):
    """Within 1e-6 of the leaf's largest magnitude."""
    want = np.asarray(want)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * max(np.abs(want).max(), 1e-30),
                               err_msg=name)


def _points(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 3)).astype(np.float32) * 2,
            rng.uniform(0, 1, (n, 3)).astype(np.float32))


def test_create_from_points_matches_jax():
    """Every leaf within 1e-6 of its scale but the KNN-seeded log-scales:
    both packages take squared distances in the expanded form |a|^2 + |b|^2
    - 2 a.b, where |a|^2 ~ 10 leaves a few ulps (~4e-6) of cancellation in
    each row, and the JAX package's fused evaluation shifts a row by its
    self-distance where the port's does not. Those are held to
    `tests/test_torch_models.py::test_create_from_mesh`'s bar."""
    pts, cols = _points(300, 0)
    pj, sj = jgs.create_from_points(jnp.asarray(pts), jnp.asarray(cols),
                                    capacity=512, max_sh_degree=2)
    m = gs.create_from_points(pts, cols, 512, max_sh_degree=2, device="cpu")
    for k, x in _fields(pj).items():
        assert getattr(m, k).shape == x.shape, k
        if k == "scaling":
            np.testing.assert_allclose(m.scaling.detach().numpy(), x, rtol=1e-4,
                                       atol=1e-5)
        else:
            _close(getattr(m, k), x, k)
    assert np.array_equal(m.alive.numpy(), np.asarray(sj.alive))
    for k in gs.STATE_FIELDS:
        assert np.array_equal(getattr(m.state, k).numpy(), np.asarray(getattr(sj, k)))


def _bg_state(cap, n_alive, seed, n_hot, ties=True):
    """A background model as the JAX package holds one: `n_alive` live rows
    of `cap`, parameters and moments from a seed, half the rows large
    (split) and half small (clone), a tenth nearly transparent (prune);
    gradients with ties among the `n_hot` rows over the threshold."""
    rng = np.random.default_rng(seed)
    pts, cols = _points(n_alive, seed)
    p, st = jgs.create_from_points(jnp.asarray(pts), jnp.asarray(cols), capacity=cap,
                                   max_sh_degree=1)
    alive = np.asarray(st.alive)
    scaling = np.where(rng.uniform(size=(cap, 1)) < 0.5, np.log(0.5), np.log(0.002))
    scaling = scaling + rng.normal(0, 0.1, (cap, 3))
    opacity = np.where(rng.uniform(size=(cap, 1)) < 0.1, -8.0, rng.normal(0, 1, (cap, 1)))
    p = p.replace(scaling=jnp.asarray(scaling, jnp.float32),
                  rotation=jnp.asarray(rng.normal(size=(cap, 4)), jnp.float32),
                  opacity=jnp.asarray(opacity, jnp.float32),
                  features_rest=jnp.asarray(rng.normal(0, 0.1, (cap, 3, 3)), jnp.float32))
    st = st.replace(max_radii2d=jnp.asarray(rng.uniform(0, 20, cap), jnp.float32))
    mu = jax.tree.map(lambda x: jnp.asarray(rng.normal(0, 0.1, x.shape), jnp.float32), p)
    nu = jax.tree.map(lambda x: jnp.asarray(rng.uniform(0, 0.1, x.shape), jnp.float32), p)
    hot = np.flatnonzero(alive)[rng.permutation(n_alive)[:n_hot]]
    grads = np.zeros(cap, np.float32)
    levels = [3e-4, 5e-4] if ties else rng.uniform(3e-4, 1e-3, n_hot)
    grads[hot] = rng.choice(levels, n_hot) if ties else levels
    return p, st, mu, nu, grads


# (capacity, alive, hot rows, max_new, max_screen): ties cut by max_new with
# room for all; too few free rows (dropped > 0); the size prune on
@pytest.mark.parametrize("cap,n_alive,n_hot,max_new,max_screen", [
    (512, 200, 120, 64, -1.0), (256, 236, 60, 64, -1.0), (512, 200, 40, 64, 5.0)])
def test_densify_and_prune_bg_matches_jax(cap, n_alive, n_hot, max_new, max_screen):
    p, st, mu, nu, grads = _bg_state(cap, n_alive, 11, n_hot)
    key = jax.random.PRNGKey(3)
    eps = np.asarray(jax.random.normal(key, (2 * max_new, 3)))
    args = (0.00025, 0.005, 3.0, 0.01, max_screen, max_new)
    rj = jdensify.densify_and_prune_bg(p, st, mu, nu, jnp.asarray(grads), key, *args)
    model = gs.from_numpy(_fields(p), np.asarray(st.alive), device="cpu",
                          state=_fields(st))
    rt = densify.densify_and_prune_bg(model, {k: _t(x) for k, x in _fields(mu).items()},
                                      {k: _t(x) for k, x in _fields(nu).items()},
                                      _t(grads), _t(eps), *args)
    counts = (rt.n_cloned, rt.n_split, rt.n_pruned, rt.dropped)
    assert counts == tuple(int(x) for x in (rj.n_cloned, rj.n_split, rj.n_pruned,
                                             rj.dropped))
    assert rt.n_cloned > 0 and rt.n_split > 0 and rt.n_pruned > 0, counts
    assert (rt.dropped > 0) == (cap == 256), counts
    assert np.array_equal(rt.model.alive.numpy(), np.asarray(rj.state.alive))
    for k, x in _fields(rj.params).items():
        _close(getattr(rt.model, k), x, k)
    for k in gs.PARAM_FIELDS:
        _close(rt.mu[k], getattr(rj.mu, k), k)
        _close(rt.nu[k], getattr(rj.nu, k), k)
    for k in gs.STATE_FIELDS:
        assert not getattr(rt.model.state, k).any()
    # the input model is not modified
    assert torch.equal(model.alive, _t(st.alive))


def test_prune_near_mesh_reset_opacity_and_lr_match_jax():
    rng = np.random.default_rng(5)
    mesh = rng.normal(size=(300, 3)).astype(np.float32)
    mesh_alive = rng.uniform(size=300) < 0.8
    bg = np.concatenate([rng.normal(0, 2, (2000, 3)),
                         mesh[:200] + rng.normal(0, 0.05, (200, 3))]).astype(np.float32)
    alive = rng.uniform(size=2200) < 0.9
    want = np.asarray(jdensify.prune_near_mesh(jnp.asarray(alive), jnp.asarray(bg),
                                               jnp.asarray(mesh), jnp.asarray(mesh_alive)))
    got = densify.prune_near_mesh(_t(alive), _t(bg), _t(mesh), _t(mesh_alive)).numpy()
    assert np.array_equal(got, want)
    assert (alive & ~got).sum() > 20                 # some retired
    op = rng.normal(0, 3, (100, 1)).astype(np.float32)
    p = jgs.GaussianParams(*(jnp.zeros((100, 1)) for _ in range(5)),
                           opacity=jnp.asarray(op))
    _close(densify.reset_opacity_bg(_t(op)), jdensify.reset_opacity_bg(p).opacity)
    opt = OptimizationParams(position_lr_max_steps=50)
    fn, jfn = optim.gaussian_lr_fn(opt, 2.5), joptim.gaussian_lr_tree_fn(
        JOpt(position_lr_max_steps=50), 2.5)
    for step in (0, 1, 10, 49, 50, 80):
        got, want = fn(step), jfn(jnp.int32(step))
        assert set(got) == set(gs.PARAM_FIELDS)
        for k in gs.PARAM_FIELDS:
            assert got[k] == pytest.approx(float(getattr(want, k)), rel=1e-6), (step, k)


# ----------------------------------------------------------------- trainer
def _trainers(opt_kw, n_points=150):
    """The JAX and the port's BgTrainer on the same 64 px views (noise
    images, as tests/test_bg_train.py), frozen icosphere-1 foreground and
    SfM points."""
    cams = [look_at_camera(W, H, azimuth=a, distance=3.5) for a in (0.0, 1.5, 3.0, 4.5)]
    rng = np.random.default_rng(1)
    images = (rng.uniform(0.3, 0.7, (4, 3, H, W)) * 255).astype(np.uint8)
    stacks = [np.stack([np.asarray(getattr(c, k)) for c in cams])
              for k in ("viewmatrix", "projmatrix", "campos", "tanfovx", "tanfovy")]
    v, f = icosphere(1)
    fp, fb, _, _ = jmgs.create_from_mesh(jnp.asarray(v), jnp.asarray(f), capacity=128,
                                         vertex_capacity=512, max_sh_degree=1)
    fp = fp.replace(opacity=jnp.full_like(fp.opacity, 4.0))
    pts = (rng.normal(size=(n_points, 3)) * 2.5).astype(np.float32)
    cols = rng.uniform(0, 1, (n_points, 3)).astype(np.float32)
    kw = dict(spatial_lr_scale=3.0, max_sh_degree=1, remove_neighbor_iterations=(30,))
    jds = jtrainer.DeviceDataset(*(jnp.asarray(x) for x in stacks),
                                 images=jnp.asarray(images), masks=None, width=W, height=H)
    jt = jbg.BgTrainer(fp, fb, pts, cols, jds, JOpt(**opt_kw),
                       JRt(max_per_tile=1024, use_pallas=False, capacity=512), **kw)
    pds = DeviceDataset(*(torch.tensor(x.astype(np.float32)) for x in stacks),
                        images=torch.tensor(images), masks=None, width=W, height=H)
    fg = mgs.from_numpy(_fields(fp), _fields(fb), device="cpu")
    pt = BgTrainer(fg, pts, cols, pds, OptimizationParams(**opt_kw),
                   RuntimeParams(max_per_tile=1024, capacity=512), **kw)
    return jt, pt


def test_bg_trainer_step_matches_jax():
    """One step from the JAX trainer's state (scales made anisotropic and
    rotations turned, so rotation has a gradient), same view and
    background, at the mesh trainer's tolerances
    (tests/test_torch_train.py::test_trainer_step_matches_jax)."""
    jt, pt = _trainers({})
    for k in gs.PARAM_FIELDS:
        _close(getattr(pt.model, k), getattr(jt.params, k), k)
    rng = np.random.default_rng(8)
    params = _fields(jt.params)
    for k in ("scaling", "rotation"):
        params[k] = params[k] + rng.normal(0, 0.3, params[k].shape).astype(np.float32)
    jt.params = jt.params.replace(scaling=jnp.asarray(params["scaling"]),
                                  rotation=jnp.asarray(params["rotation"]))
    cap = dict(params=params, state=_fields(jt.state),
               mu=_fields(jt.opt_state.adam.mu), nu=_fields(jt.opt_state.adam.nu),
               step=int(jt.opt_state.step), sh_degree=1, global_it=0)
    pt.restore(bg_trainer_state_from_numpy(cap, device="cpu"))
    jt.sh_degree = pt.sh_degree = 1
    cam_idx, bg = 2, np.array([0.3, 0.6, 0.9], np.float32)
    pj, oj, sj, mj = jt._get_step_fn(1, 512)(jt.params, jt.opt_state, jt.state,
                                             jnp.int32(cam_idx), jnp.asarray(bg))
    mt = pt.step(cam_idx, _t(bg))
    assert float(mt["loss"]) == pytest.approx(float(mj["loss"]), rel=1e-5)
    assert int(mt["tile_overflow"]) == int(mj["tile_overflow"]) == 0
    for k in gs.PARAM_FIELDS:
        gj = np.asarray(getattr(oj.adam.mu, k)) / 0.1
        gt = pt.adam.mu[k].numpy() / 0.1
        scale = np.abs(gj).max()
        assert scale > 0, k
        np.testing.assert_allclose(gt / scale, gj / scale, atol=2e-4, err_msg=k)
        big = np.abs(gj) > 1e-3 * scale
        np.testing.assert_allclose(getattr(pt.model, k).detach().numpy()[big],
                                   np.asarray(getattr(pj, k))[big],
                                   rtol=1e-6, atol=1e-6, err_msg=k)
        nuj = np.asarray(getattr(oj.adam.nu, k))
        np.testing.assert_allclose(pt.adam.nu[k].numpy() / nuj.max(), nuj / nuj.max(),
                                   atol=4e-4, err_msg=k)
    for k in ("grad_accum", "denom", "max_radii2d"):
        a, b = np.asarray(getattr(sj, k)), getattr(pt.model.state, k).numpy()
        assert a.max() > 0, k
        np.testing.assert_allclose(b / a.max(), a / a.max(), atol=2e-4, err_msg=k)
    assert np.array_equal(pt.model.alive.numpy(), np.asarray(sj.alive))
    assert pt.adam.step == int(oj.step) == 1


def test_bg_event_iterations_match_jax(monkeypatch):
    """Neighbour prunes, densifies (every 500 iterations) and opacity resets
    fire at the JAX trainer's iterations, in its order within an iteration.
    The steps are stubbed: only the host loop's schedule is under test."""
    opt_kw = dict(densify_from_iter=400, densify_until_iter=1050,
                  opacity_reset_interval=300)
    jt, pt = _trainers(opt_kw)
    jt.remove_neighbor_iterations = pt.remove_neighbor_iterations = {30, 1000}
    fired_j = []
    monkeypatch.setattr(jt, "_get_step_fn", lambda *a: (
        lambda params, opt_state, state, cam_idx, bg: (params, opt_state, state,
                                                       {"loss": jnp.float32(0.0)})))
    jdens = jt.densify
    monkeypatch.setattr(jt, "densify", lambda: (
        fired_j.append((jt.global_it, "densify")), jdens()))
    for name, kind in (("prune_near_mesh", "prune_near_mesh"),
                       ("reset_opacity_bg", "opacity_reset")):
        real = getattr(jbg.densify_mod, name)
        monkeypatch.setattr(jbg.densify_mod, name, lambda *a, _r=real, _k=kind: (
            fired_j.append((jt.global_it, _k)), _r(*a))[1])
    jt.train(iterations=1100, log_every=10_000)

    monkeypatch.setattr(pt, "step", lambda cam_idx, bg: {"loss": torch.tensor(0.0)})
    pt.train(iterations=1100, log_every=10_000)
    fired_t = [(it, kind) for it, kind, _ in pt.events]
    assert fired_t == fired_j
    assert fired_t == [(30, "prune_near_mesh"), (300, "opacity_reset"),
                       (400, "opacity_reset"), (500, "densify"), (600, "opacity_reset"),
                       (900, "opacity_reset"), (1000, "prune_near_mesh"),
                       (1000, "densify")]
    assert pt.sh_degree == jt.sh_degree == 1


def test_bg_densify_grows_the_capacity_when_it_runs_out_of_room():
    """A pass with more new rows than free ones grows the tables by 3/2
    (rounded up to 4096 rows) and retries; the moments grow alongside."""
    _, pt = _trainers({}, n_points=150)
    pt.rt = RuntimeParams(max_per_tile=1024)
    m = pt.model
    alive = torch.ones(512, dtype=torch.bool)
    with torch.no_grad():
        m.scaling.fill_(np.log(0.5))
    pt.model = gs.GaussianModel(m.params(), alive, m.state._replace(
        grad_accum=torch.ones(512), denom=torch.ones(512)))
    info = pt.densify()
    assert pt.model.capacity == 4096
    assert info["n_split"] == 256 and info["n_cloned"] == 0      # max_new 256
    assert int(pt.model.alive.sum()) == 512 + 256 - info["n_pruned"]
    assert all(v.shape[0] == 4096 for v in pt.adam.mu.values())
