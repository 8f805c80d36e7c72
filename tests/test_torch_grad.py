"""Gradients of the port's rasterizer (K2 + K3 plain versions, through
`BlendFunction`) and its per-Gaussian reduction against the JAX package on
the CPU, and against float64 scatter-adds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianmesh_tpu.ops import segsum as jsegsum
from gaussianmesh_tpu.ops.rasterize import RasterizerConfig as JaxConfig
from gaussianmesh_tpu.ops.rasterize import rasterize as jax_rasterize
from gaussianmesh_tpu_torch.models import mesh_gaussians as mgs
from gaussianmesh_tpu_torch.models import render as render_mod
from gaussianmesh_tpu_torch.ops import binning, segsum
from gaussianmesh_tpu_torch.ops.rasterize import RasterizerConfig, rasterize
from gaussianmesh_tpu_torch.utils.graphics import CameraArrays
from tests.meshes import icosphere
from tests.scenes import look_at_camera, random_gaussians

torch.set_num_threads(2)

BG = np.array([0.15, 0.25, 0.35], np.float32)
LEAVES = ("means3d", "cov6", "opacity", "rgb", "mean2d_offset")


def _tcam(cam):
    return CameraArrays.from_numpy(*[np.asarray(x) for x in cam], device="cpu")


def _grads_both(width, height, n, max_per_tile, pallas=False):
    """d/d(means3d, cov6, opacity, rgb, mean2d_offset) of
    sum((color - target)^2) + 0.1 sum(final_t), JAX and port."""
    cam = look_at_camera(width, height)
    sc = random_gaussians(n, seed=3)
    target = np.random.default_rng(1).uniform(0, 1, (3, height, width)).astype(np.float32)
    args = [np.asarray(sc[k]) for k in LEAVES[:4]] + [np.zeros((n, 2), np.float32)]
    jcfg = JaxConfig(width=width, height=height, max_per_tile=max_per_tile,
                     use_pallas=pallas, blend_chunk=128)

    def jloss(m, c, o, r, off):
        out = jax_rasterize(m, c, o, r, jnp.asarray(BG), cam, jcfg,
                            mean2d_offset=off)
        return jnp.sum((out.color - target) ** 2) + 0.1 * jnp.sum(out.final_t)

    jgrad = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))
    jargs = [jnp.asarray(a) for a in args]
    if pallas:
        from jax.experimental.pallas import tpu as pltpu
        with jax.disable_jit(), pltpu.force_tpu_interpret_mode():
            gj = jgrad(*jargs)
    else:
        gj = jax.jit(jgrad)(*jargs)

    ta = [torch.tensor(a, requires_grad=True) for a in args]
    out = rasterize(ta[0], ta[1], ta[2], ta[3], torch.tensor(BG), _tcam(cam),
                    RasterizerConfig(width=width, height=height,
                                     max_per_tile=max_per_tile),
                    mean2d_offset=ta[4])
    loss = ((out.color - torch.tensor(target)) ** 2).sum() + 0.1 * out.final_t.sum()
    gt = torch.autograd.grad(loss, ta)
    return [np.asarray(g) for g in gj], [g.numpy() for g in gt], out


def _assert_normalized(gj, gt, atol=2e-4):
    """The JAX package's own bar (tests/test_rasterize.py:96-100): each
    leaf's difference over its largest |gradient|."""
    for name, a, b in zip(LEAVES, gj, gt):
        scale = np.abs(a).max() + 1e-8
        np.testing.assert_allclose(b / scale, a / scale, atol=atol, err_msg=name)


@pytest.mark.parametrize("width,height,n,max_per_tile", [
    (64, 64, 400, 256),      # toy scale
    (256, 256, 5000, 64),    # overflow-clamped: tile_overflow > 0
    (64, 40, 400, 256),      # 40 % 16 != 0: a partial last tile row
])
def test_rasterize_grads_match_jax_jnp_path(width, height, n, max_per_tile):
    gj, gt, out = _grads_both(width, height, n, max_per_tile)
    if max_per_tile == 64:
        assert int(out.tile_overflow) > 0
    _assert_normalized(gj, gt)


def test_rasterize_grads_match_jax_pallas_kernel_interpret():
    """Against the Pallas K2 itself (interpret mode, one 128-pair chunk):
    the only CPU path that reaches it (the JAX trainer takes the jnp path
    off the TPU)."""
    gj, gt, _ = _grads_both(64, 64, 200, 256, pallas=True)
    _assert_normalized(gj, gt)


def test_grads_finite_and_zero_on_dead_capacity_rows():
    """Port twin of tests/test_rasterize.py:136-160: dead rows (zero
    quaternions, culled) backprop exact zeros and nothing is NaN."""
    v, f = icosphere(0)
    model = mgs.create_from_mesh(v, f, capacity=128, vertex_capacity=128,
                                 device="cpu")
    cam = _tcam(look_at_camera(32, 32, distance=3.0))
    cfg = RasterizerConfig(width=32, height=32, max_per_tile=64)
    arrays = render_mod.mesh_model_arrays(model, cam, 3)
    out = render_mod.render(arrays, cam, cfg, torch.zeros(3))
    (out.color ** 2).sum().backward()
    for name, p in model.named_parameters():
        g = p.grad.numpy()
        assert np.isfinite(g).all(), name
        assert np.abs(g[f.shape[0]:]).max() == 0.0, name
    # (rotation has none here: the initial scales are isotropic)
    for name in ("bc", "opacity", "features_dc", "scaling"):
        assert getattr(model, name).grad.abs().max() > 0.0, name


def test_render_without_grad_skips_reduction_map(monkeypatch):
    """A render that will not be differentiated runs the forward alone: the
    same image as the differentiable render, built without `grouped_pos`
    and without the autograd function."""
    cam = _tcam(look_at_camera(64, 64))
    sc = random_gaussians(400, seed=3)
    args = [torch.tensor(np.asarray(sc[k])) for k in LEAVES[:4]]
    cfg = RasterizerConfig(width=64, height=64, max_per_tile=256)
    maps = []
    build = binning.build_tile_lists

    def spy(*a, **k):
        tiles = build(*a, **k)
        maps.append(tiles.grouped_pos)
        return tiles

    monkeypatch.setattr(binning, "build_tile_lists", spy)
    with torch.no_grad():
        fwd = rasterize(*args, torch.tensor(BG), cam, cfg)
    leaves = [a.clone().requires_grad_() for a in args]
    diff = rasterize(*leaves, torch.tensor(BG), cam, cfg)
    assert maps[0] is None and maps[1] is not None
    assert fwd.color.grad_fn is None and diff.color.grad_fn is not None
    for key in ("color", "final_t", "n_contrib"):
        assert torch.equal(getattr(fwd, key), getattr(diff, key).detach()), key


def _segments(rng, n, idx):
    """Port inputs for rows given in an arbitrary order with destinations
    idx: emission order is the stable grouping by destination."""
    perm = np.argsort(idx, kind="stable").astype(np.int32)
    counts = np.bincount(idx, minlength=n)
    return (torch.tensor(perm), segsum.segment_starts(torch.tensor(counts, dtype=torch.int32)),
            counts)


def test_segment_sum_plain_matches_jax_gather_rows_counted():
    """Where the JAX reduction is right (long segments at low ids): the
    port's segment sums == the VJP of `gather_rows_counted`, to 1e-5
    relative (another summation order)."""
    rng = np.random.default_rng(1)
    n, m, f = 60, 3000, 16
    idx = rng.integers(0, n, m)
    idx[:500] = 11                       # a 500-row segment
    idx[500:504] = 0
    w = rng.normal(size=(m, f)).astype(np.float32)
    counts_j = jnp.asarray(np.bincount(idx, minlength=n).astype(np.int32))
    table = jnp.zeros((n, f), jnp.float32)
    gj = jax.grad(lambda t: jnp.sum(jsegsum.gather_rows_counted(
        t, jnp.asarray(idx.astype(np.int32)), counts_j) * w))(table)
    perm, starts, _ = _segments(rng, n, idx)
    out = segsum.segment_sum(torch.tensor(w), perm, starts).numpy()
    assert out.shape == (n + 1, f) and (out[n] == 0).all()
    np.testing.assert_allclose(out[:n], np.asarray(gj), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(gj)).max())


@pytest.mark.parametrize("dest", [0, 299])
def test_segment_sum_long_segment_any_destination(dest):
    """n=300, m=2000 with a 200-row segment at `dest`, against a float64
    scatter-add. At dest 299 the JAX package's capped extra-head scatter
    loses gradient (ROADMAP queue 3, item 1); the port has no cap."""
    rng = np.random.default_rng(0)
    n, m, f = 300, 2000, 16
    idx = rng.integers(0, n, m)
    idx[:200] = dest
    w = rng.normal(size=(m, f)).astype(np.float32)
    ref = np.zeros((n, f))
    np.add.at(ref, idx, w.astype(np.float64))
    perm, starts, _ = _segments(rng, n, idx)
    out = segsum.segment_sum(torch.tensor(w), perm, starts).numpy()
    np.testing.assert_allclose(out[:n], ref, rtol=1e-6, atol=1e-6)
    # the JAX reduction on the same input, for the record of the fault
    counts_j = jnp.asarray(np.bincount(idx, minlength=n).astype(np.int32))
    gj = np.asarray(jax.grad(lambda t: jnp.sum(jsegsum.gather_rows_counted(
        t, jnp.asarray(idx.astype(np.int32)), counts_j) * w))(
            jnp.zeros((n, f), jnp.float32)))
    assert (np.abs(gj - ref).max() > 1.0) == (dest == 299)


def test_segment_sum_matches_pallas_segtree_interpret():
    """Against the Pallas `_segtree_kernel` (interpret mode, m >= 2048): its
    segment heads are the segment sums for segments of <= 128 rows."""
    rng = np.random.default_rng(2)
    lengths = rng.integers(1, 129, 40)
    lengths[:3] = [128, 1, 77]
    n, m, f = lengths.shape[0], int(lengths.sum()), 16
    assert m >= 2048
    idx = np.repeat(np.arange(n), lengths)
    w = rng.normal(size=(m, f)).astype(np.float32)
    starts_np = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    rank = np.arange(m) - np.repeat(starts_np, lengths)
    from jax.experimental.pallas import tpu as pltpu
    with jax.disable_jit(), pltpu.force_tpu_interpret_mode():
        x = np.asarray(jsegsum._tree_passes_tpu(
            jnp.asarray(idx.astype(np.int32)), jnp.asarray(rank.astype(np.int32)),
            jnp.asarray(w)))
    heads = x[starts_np]
    perm, starts, _ = _segments(rng, n, idx)
    out = segsum.segment_sum(torch.tensor(w), perm, starts).numpy()
    np.testing.assert_allclose(out[:n], heads, rtol=1e-5,
                               atol=1e-5 * np.abs(heads).max())
