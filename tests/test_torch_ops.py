"""Port ops (gaussianmesh_tpu_torch.ops) against the JAX package on the CPU:
preprocess, binning, the plain blend, the oracles and KNN. Both packages
get the same numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianmesh_tpu.ops import binning as jbin
from gaussianmesh_tpu.ops import knn as jknn
from gaussianmesh_tpu.ops import oracle as joracle
from gaussianmesh_tpu.ops import preprocess as jprep
from gaussianmesh_tpu.ops import tile_blend as jblend
from gaussianmesh_tpu.ops.rasterize import RasterizerConfig as JaxConfig
from gaussianmesh_tpu_torch.ops import binning, knn, oracle, preprocess, tile_blend
from gaussianmesh_tpu_torch.utils.graphics import CameraArrays
from tests.scenes import look_at_camera, random_gaussians

torch.set_num_threads(2)

BG = np.array([0.15, 0.25, 0.35], np.float32)

# one compile per configuration instead of op-by-op dispatch
_jax_tile_lists = jax.jit(jbin.build_tile_lists, static_argnums=(1, 2, 3, 4, 5, 6),
                          static_argnames=("row_capacity",))
_jax_blend_tiles = jax.jit(jblend.blend_tiles_jnp, static_argnums=(1,))


def _t(x):
    return torch.tensor(np.asarray(x))


def _scene(width, n, seed=3):
    cam = look_at_camera(width, width)
    sc = random_gaussians(n, seed=seed)
    tcam = CameraArrays.from_numpy(*[np.asarray(x) for x in cam], device="cpu")
    return cam, tcam, sc


@pytest.fixture(scope="module")
def small():
    return _scene(64, 400)


@pytest.fixture(scope="module")
def medium():
    return _scene(256, 5000)


@pytest.mark.parametrize("gated", [False, True])
def test_preprocess_matches_jax(medium, gated):
    cam, tcam, sc = medium
    means = np.array(sc["means3d"])
    means[:50] = 1.5 * np.asarray(cam.campos)    # behind the camera
    means[50:100, 0] += 20.0                     # off screen
    op = np.array(sc["opacity"])
    op[100:150] = 0.003                          # below the 1/255 gate
    op = op if gated else None
    pj = jprep.preprocess(jnp.asarray(means), sc["cov6"], cam, 256, 256,
                          opacity=None if op is None else jnp.asarray(op))
    pt = preprocess.preprocess(_t(means), _t(sc["cov6"]), tcam, 256, 256,
                               opacity=None if op is None else _t(op))
    for name in ("valid", "radius", "rect_min", "rect_max", "tiles_touched"):
        np.testing.assert_array_equal(getattr(pt, name).numpy(),
                                      np.asarray(getattr(pj, name)), err_msg=name)
    for name in ("mean2d", "depth", "conic"):
        np.testing.assert_allclose(getattr(pt, name).numpy(),
                                   np.asarray(getattr(pj, name)),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    assert pt.valid.any() and not pt.valid.all()


def _prep_to_torch(pj):
    return preprocess.Preprocessed(*(_t(x) for x in pj))


# (max_per_tile, pair capacity / Gaussian, row capacity / Gaussian): the
# default capacities, a max_per_tile clamp, and both upstream capacities
# clipped (rows and pairs dropped in emission order)
BIN_CONFIGS = [(1024, 10, 4), (64, 10, 4), (1024, 1, 1), (1024, 2, 4)]


@pytest.mark.parametrize("max_per_tile,pair_cap,row_cap", BIN_CONFIGS)
def test_binning_matches_jax(medium, max_per_tile, pair_cap, row_cap):
    """Same preprocessed input into both binnings: equal ranges, counters,
    gid counts and sorted pair order."""
    cam, _, sc = medium
    cfg = JaxConfig(width=256, height=256, max_per_tile=max_per_tile,
                    pair_capacity_per_gaussian=pair_cap,
                    row_capacity_per_gaussian=row_cap)
    n = sc["means3d"].shape[0]
    gx, gy = cfg.grid
    pj = jprep.preprocess(sc["means3d"], sc["cov6"], cam, 256, 256,
                          opacity=sc["opacity"])
    tj = _jax_tile_lists(pj, gx, gy, max_per_tile, cfg.expand_capacity(n),
                               cfg.pair_capacity(n), cfg.blend_chunk,
                               opacity=sc["opacity"],
                               row_capacity=cfg.row_capacity(n))
    tt = binning.build_tile_lists(_prep_to_torch(pj), gx, gy, max_per_tile,
                                  cfg.expand_capacity(n),
                                  opacity=_t(sc["opacity"]),
                                  row_capacity=cfg.row_capacity(n))
    for name in ("num_rendered", "tile_overflow", "rect_overflow",
                 "pair_overflow"):
        assert int(getattr(tt, name)) == int(getattr(tj, name)), name
    np.testing.assert_array_equal(tt.starts.numpy(), np.asarray(tj.starts))
    np.testing.assert_array_equal(tt.counts.numpy(), np.asarray(tj.counts))
    m = int(tt.num_rendered)
    gid_j = np.asarray(tj.sorted_gid)[:m]
    gid_t = tt.sorted_gid.numpy()
    starts = tt.starts.numpy()
    for t in range(gx * gy):  # per-tile gid multisets
        s, e = starts[t], starts[t + 1]
        assert sorted(gid_t[s:e]) == sorted(gid_j[s:e]), t
    # and the same (tile, depth, emission) order
    np.testing.assert_array_equal(gid_t, gid_j)
    np.testing.assert_array_equal(tt.gid_counts.numpy(), np.asarray(tj.gid_counts))
    np.testing.assert_array_equal(tt.gid_counts.numpy(),
                                  np.bincount(gid_t, minlength=n))
    if max_per_tile == 64:
        assert int(tt.tile_overflow) > 0
    if pair_cap < 10:
        assert int(tt.rect_overflow) > 0


def _tile_feats(medium_or_small, width, max_per_tile):
    """The dense per-tile feature lists of the JAX jnp path."""
    cam, _, sc = medium_or_small
    cfg = JaxConfig(width=width, height=width, max_per_tile=max_per_tile)
    n = sc["means3d"].shape[0]
    gx, gy = cfg.grid
    pj = jprep.preprocess(sc["means3d"], sc["cov6"], cam, width, width,
                          opacity=sc["opacity"])
    tj = _jax_tile_lists(pj, gx, gy, max_per_tile, cfg.expand_capacity(n),
                               cfg.pair_capacity(n), cfg.blend_chunk,
                               opacity=sc["opacity"],
                               row_capacity=cfg.row_capacity(n))
    feat = jblend.pack_features(pj.mean2d, pj.conic, sc["opacity"], sc["rgb"],
                                pj.valid)
    lists = jbin.tile_id_lists(tj, cfg.num_tiles, max_per_tile, n)
    return jnp.swapaxes(feat[lists], 1, 2), gx


@pytest.mark.parametrize("width,max_per_tile", [(64, 256), (256, 64)])
def test_blend_tiles_matches_jnp(small, medium, width, max_per_tile):
    feats, gx = _tile_feats(small if width == 64 else medium, width, max_per_tile)
    cj, tj, nj = _jax_blend_tiles(feats, gx)
    ct, tt, nt = tile_blend.blend_tiles(_t(feats), gx)
    # 3e-5: sequential transmittance chain vs the jnp cumprod, f32
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=3e-5)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=3e-5)
    assert (nt.numpy() == np.asarray(nj).astype(np.int32)).mean() > 0.9999


def test_pack_features_matches_jax(small):
    cam, tcam, sc = small
    pj = jprep.preprocess(sc["means3d"], sc["cov6"], cam, 64, 64,
                          opacity=sc["opacity"])
    fj = jblend.pack_features(pj.mean2d, pj.conic, sc["opacity"], sc["rgb"],
                              pj.valid)
    ft = tile_blend.pack_features(_t(pj.mean2d), _t(pj.conic), _t(sc["opacity"]),
                                  _t(sc["rgb"]), _t(pj.valid))
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))


@pytest.mark.parametrize("which", ["render_oracle", "render_sequential"])
def test_oracles_match_jax(small, which):
    cam, tcam, sc = small
    args = (sc["means3d"], sc["cov6"], sc["opacity"], sc["rgb"])
    oj = getattr(joracle, which)(*args, cam, 64, 64, jnp.asarray(BG))
    ot = getattr(oracle, which)(*(_t(a) for a in args), tcam, 64, 64, _t(BG))
    np.testing.assert_allclose(ot.color.numpy(), np.asarray(oj.color), atol=3e-5)
    np.testing.assert_allclose(ot.final_t.numpy(), np.asarray(oj.final_t), atol=3e-5)
    assert (ot.n_contrib.numpy() == np.asarray(oj.n_contrib)).mean() > 0.999


def test_plain_blend_matches_sequential_oracle(small):
    """The plain blend through the port's binning == the literal loop of
    the JAX package's oracle (which enumerates every 3-sigma rect pair)."""
    cam, tcam, sc = small
    gx = 4
    pt = preprocess.preprocess(_t(sc["means3d"]), _t(sc["cov6"]), tcam, 64, 64,
                               opacity=_t(sc["opacity"]))
    tiles = binning.build_tile_lists(pt, gx, gx, 256, 4000, opacity=_t(sc["opacity"]),
                                     row_capacity=1600)
    feat = tile_blend.pack_features(pt.mean2d, pt.conic, _t(sc["opacity"]),
                                    _t(sc["rgb"]), pt.valid)
    color, final_t, n_contrib = tile_blend.blend_forward(
        feat, tiles.sorted_gid, tiles.starts, tiles.counts, gx, 64, 64)
    ref = joracle.render_sequential(sc["means3d"], sc["cov6"], sc["opacity"],
                                    sc["rgb"], cam, 64, 64, jnp.zeros(3))
    np.testing.assert_allclose(color.numpy(), np.asarray(ref.color), atol=3e-5)
    np.testing.assert_allclose(final_t.numpy(), np.asarray(ref.final_t), atol=3e-5)
    # the binning culls pairs the oracle still enumerates: ranks only shrink
    nc, onc = n_contrib.numpy(), np.asarray(ref.n_contrib)
    assert ((nc > 0) == (onc > 0)).all() and (nc <= onc).all()


def test_blend_forward_checks_inputs(small):
    feat = torch.zeros(5, tile_blend.FEAT)
    gid = torch.zeros(0, dtype=torch.int32)
    starts = torch.zeros(17, dtype=torch.int32)
    counts = torch.zeros(16, dtype=torch.int32)
    with pytest.raises(ValueError):
        tile_blend.blend_forward(feat, gid, starts, counts, 3, 64, 64)
    with pytest.raises(ValueError):
        tile_blend.blend_forward(feat, gid, starts.long(), counts, 4, 64, 64)
    with pytest.raises(ValueError):
        tile_blend.blend_forward(feat.double(), gid, starts, counts, 4, 64, 64)
    color, final_t, n_contrib = tile_blend.blend_forward(
        feat, gid, starts, counts, 4, 64, 64)
    assert color.shape == (3, 64, 64) and (final_t == 1).all()
    assert (n_contrib == 0).all() and tile_blend.blend_forward.launches == 0


@pytest.mark.parametrize("kind", ["ties", "random", "empty_tiles", "no_tiles"])
def test_tile_order_is_stable_descending_permutation(kind):
    """K2's block order: a permutation of the tiles, counts descending,
    equal counts in tile order."""
    rng = np.random.default_rng(4)
    counts = {"ties": np.array([3, 7, 3, 7, 0, 7, 1, 3]),
              "random": rng.integers(0, 5000, 2500),
              "empty_tiles": np.where(rng.random(300) < 0.7, 0,
                                      rng.integers(1, 9, 300)),
              "no_tiles": np.zeros(0, np.int64)}[kind].astype(np.int32)
    order = tile_blend.tile_order(torch.tensor(counts))
    assert order.dtype == torch.int32 and order.shape == counts.shape
    o = order.numpy()
    np.testing.assert_array_equal(np.sort(o), np.arange(len(counts)))
    np.testing.assert_array_equal(o, np.argsort(-counts.astype(np.int64),
                                                kind="stable"))


def test_mean_sq_dist3_matches_jax():
    pts = np.random.default_rng(0).normal(size=(1500, 3)).astype(np.float32)
    dj = np.asarray(jknn.mean_sq_dist3(jnp.asarray(pts)))
    dt = knn.mean_sq_dist3(torch.tensor(pts), row_chunk=512).numpy()
    np.testing.assert_allclose(dt, dj, rtol=1e-4, atol=1e-6)
