"""CUDA kernels of the port against their plain PyTorch versions, on the
card. Skipped where no CUDA device is present. This file imports neither
JAX nor the JAX package, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import math

import numpy as np
import pytest
import torch

from gaussianmesh_tpu_torch.edit import runtime
from gaussianmesh_tpu_torch.io import gaussian_ply, mesh as mesh_io
from gaussianmesh_tpu_torch.models import gaussians, mesh_gaussians
from gaussianmesh_tpu_torch.ops import binning, preprocess, segsum, tile_blend
from gaussianmesh_tpu_torch.ops.rasterize import RasterizerConfig, rasterize
from gaussianmesh_tpu_torch.utils import graphics, maths
from gaussianmesh_tpu_torch.utils.graphics import CameraArrays
# pytest puts tests/ on sys.path
from meshes import icosphere
from test_torch_segsum import LAYOUTS, assert_column_close, k3_layout


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the H100 run of the port)")
    return torch.device("cuda")


def _camera(width, height, device, distance=4.0, azimuth=0.3):
    fovx = math.radians(60.0)
    fovy = graphics.focal2fov(graphics.fov2focal(fovx, width), height)
    pos = distance * np.array([math.cos(0.2) * math.sin(azimuth), math.sin(0.2),
                               math.cos(0.2) * math.cos(azimuth)])
    fwd = -pos / np.linalg.norm(pos)
    right = np.cross([0.0, 1.0, 0.0], fwd)
    right /= np.linalg.norm(right)
    R = np.stack([right, np.cross(fwd, right), fwd], axis=1)
    V = graphics.world_to_view(R, -R.T @ pos)
    P = graphics.projection_matrix(0.01, 100.0, fovx, fovy)
    return CameraArrays.from_numpy(V, P @ V, pos, math.tan(fovx / 2),
                                   math.tan(fovy / 2), device=device)


def _scene(n, device, seed=3):
    rng = np.random.default_rng(seed)
    means = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    scales = rng.uniform(0.02, 0.12, (n, 3)).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    t = {k: torch.tensor(x, device=device) for k, x in
         dict(means=means, scales=scales, quats=quats,
              opacity=rng.uniform(0.2, 0.95, n).astype(np.float32),
              rgb=rng.uniform(0.05, 0.95, (n, 3)).astype(np.float32)).items()}
    t["cov6"] = maths.covariance_6(t["scales"], maths.normalize(t["quats"]))
    return t


@pytest.mark.cuda
@pytest.mark.parametrize("max_per_tile", [1024, 64])
def test_k1_matches_plain(cuda, max_per_tile):
    width = height = 256
    sc = _scene(5000, cuda)
    cam = _camera(width, height, cuda)
    gx, gy = preprocess.tile_grid(width, height)
    prep = preprocess.preprocess(sc["means"], sc["cov6"], cam, width, height,
                                 opacity=sc["opacity"])
    tiles = binning.build_tile_lists(prep, gx, gy, max_per_tile, 50000,
                                     opacity=sc["opacity"], row_capacity=20000)
    assert (int(tiles.tile_overflow) > 0) == (max_per_tile == 64)
    feat = tile_blend.pack_features(prep.mean2d, prep.conic, sc["opacity"],
                                    sc["rgb"], prep.valid)
    args = (feat, tiles.sorted_gid, tiles.starts, tiles.counts, gx, width, height)
    before = tile_blend.blend_forward.launches
    color, final_t, n_contrib = tile_blend.blend_forward(*args)
    torch.cuda.synchronize()
    assert tile_blend.blend_forward.launches == before + 1
    pc, pt, pn = tile_blend.blend_forward_plain(*args)
    # same operation order, no FMA contraction, same expf: equal to rounding
    torch.testing.assert_close(color, pc, atol=1e-6, rtol=0)
    torch.testing.assert_close(final_t, pt, atol=1e-6, rtol=0)
    assert (n_contrib == pn).float().mean().item() >= 0.999


@pytest.mark.cuda
def test_rasterize_on_cuda_matches_cpu(cuda):
    """The whole forward on the card against the plain path on the CPU;
    1e-3 covers a pair whose alpha the two devices' exp rounds across the
    1/255 gate."""
    width, height = 256, 200   # 200 % 16 != 0: a partial last tile row
    sc = _scene(5000, cuda, seed=5)
    bg = torch.tensor([0.1, 0.2, 0.3], device=cuda)
    cfg = RasterizerConfig(width=width, height=height, max_per_tile=1024)
    out = rasterize(sc["means"], sc["cov6"], sc["opacity"], sc["rgb"], bg,
                    _camera(width, height, cuda), cfg)
    ref = rasterize(*(sc[k].cpu() for k in ("means", "cov6", "opacity", "rgb")),
                    bg.cpu(), _camera(width, height, "cpu"), cfg)
    d = (out.color.cpu() - ref.color).abs()
    assert d.max().item() <= 1e-3 and d.mean().item() <= 1e-5
    assert int(out.num_rendered) == int(ref.num_rendered)


def _k2_inputs(device, width, height, max_per_tile):
    """A 5000-Gaussian scene binned and blended by K1, with seeded
    cotangents: K2's and K3's inputs."""
    sc = _scene(5000, device)
    cam = _camera(width, height, device)
    gx, gy = preprocess.tile_grid(width, height)
    prep = preprocess.preprocess(sc["means"], sc["cov6"], cam, width, height,
                                 opacity=sc["opacity"])
    tiles = binning.build_tile_lists(prep, gx, gy, max_per_tile, 50000,
                                     opacity=sc["opacity"], row_capacity=20000)
    feat = tile_blend.pack_features(prep.mean2d, prep.conic, sc["opacity"],
                                    sc["rgb"], prep.valid)
    _, final_t, n_contrib = tile_blend.blend_forward(
        feat, tiles.sorted_gid, tiles.starts, tiles.counts, gx, width, height)
    rng = np.random.default_rng(11)
    g_color = torch.tensor(rng.normal(size=(3, height, width)).astype(np.float32),
                           device=device)
    g_final_t = torch.tensor(rng.normal(size=(height, width)).astype(np.float32),
                             device=device)
    return (feat, tiles.sorted_gid, tiles.starts, tiles.counts, final_t,
            n_contrib, g_color, g_final_t), tiles


@pytest.mark.cuda
@pytest.mark.parametrize("height,max_per_tile", [(256, 1024), (256, 64), (200, 1024)])
def test_k2_k3_match_plain(cuda, height, max_per_tile):
    """K2 rows against `blend_backward_plain` (the same chain per pixel,
    only the 256-pixel sum in another order): max-abs over each column's
    largest |row| <= 1e-5, zero rows equal. K3 against a float64
    index_add_ of the same rows, relative 1e-6."""
    args, tiles = _k2_inputs(cuda, 256, height, max_per_tile)
    assert (int(tiles.tile_overflow) > 0) == (max_per_tile == 64)
    before = (tile_blend.blend_backward.launches, segsum.segment_sum.launches)
    rows = tile_blend.blend_backward(*args)
    ref = tile_blend.blend_backward_plain(*args)
    torch.cuda.synchronize()
    scale = ref.abs().amax(0).clamp(min=1e-30)
    assert ((rows - ref).abs() / scale).max().item() <= 1e-5
    assert torch.equal(rows == 0, ref == 0)
    starts = segsum.segment_starts(tiles.gid_counts)
    d_feat = segsum.segment_sum(rows, tiles.grouped_pos, starts)
    ref64 = segsum.segment_sum_plain(rows, tiles.grouped_pos, starts)
    col = ref64.abs().amax(0).clamp(min=1e-30)
    assert ((d_feat - ref64).abs() / col).max().item() <= 1e-6
    assert (tile_blend.blend_backward.launches, segsum.segment_sum.launches) == (
        before[0] + 1, before[1] + 1)


def _edge_tiles(seed=7):
    """A hand-built pair domain on a 64x40 image (4x3 tiles; the last tile
    row is 8 px high) that reaches the kernels' edges:
      tile 0: 3,001 faint wide splats, none ending a pixel, so every pixel
              walks them all (K1's and K2's staging rings wrap many times;
              3,001 is no multiple of a batch or a group);
      tile 1: empty;
      tile 2: 777 faint splats squeezed into its top 4 rows, so the pixels of
              its lower 8 rows blend nothing (n_contrib 0: their warps idle)
              while the upper ones walk far;
      tile 3: 100 listed pairs of which max_per_tile kept 60 (K2 writes
              zero rows for the other 40);
      tiles 4-11: 0 to 300 ordinary splats, one tile of the short last row
              1,500.
    -> feat (N + 1, FEAT), sorted_gid, starts, counts, width, height."""
    rng = np.random.default_rng(seed)
    width, height, gx = 64, 40, 4
    counts = [3001, 0, 777, 60] + list(rng.integers(0, 300, 8))
    counts[9] = 1500
    ranges = list(counts)
    ranges[3] = 100
    rows = []
    for tile, m in enumerate(ranges):
        x0, y0 = (tile % gx) * 16, (tile // gx) * 16
        f = np.zeros((m, tile_blend.FEAT), np.float32)
        f[:, 0] = x0 + rng.uniform(0, 16, m)
        f[:, 1] = y0 + rng.uniform(0, 16, m)
        sx, sy = rng.uniform(1.0, 5.0, m), rng.uniform(1.0, 5.0, m)
        op = rng.uniform(0.05, 0.9, m)
        if tile == 0:
            sx, sy = rng.uniform(8, 20, m), rng.uniform(8, 20, m)
            op = rng.uniform(0.001, 0.006, m)
        elif tile == 2:
            f[:, 1] = y0 + rng.uniform(0, 4, m)
            sx, sy = rng.uniform(4, 10, m), rng.uniform(0.5, 1.0, m)
            op = rng.uniform(0.004, 0.012, m)
        rho = rng.uniform(-0.3, 0.3, m)
        det = (sx * sy) ** 2 * (1 - rho ** 2)
        f[:, 2] = sy ** 2 / det
        f[:, 3] = -rho * sx * sy / det
        f[:, 4] = sx ** 2 / det
        f[:, 5] = op
        f[:, 6:9] = rng.uniform(0.05, 0.95, (m, 3))
        f[:, 9] = 1.0
        rows.append(f)
    table = np.concatenate(rows)
    perm = rng.permutation(len(table))           # scatter the rows
    feat = np.zeros((len(table) + 1, tile_blend.FEAT), np.float32)
    feat[perm] = table
    starts = np.concatenate([[0], np.cumsum(ranges)]).astype(np.int32)
    return (feat, perm.astype(np.int32), starts, np.array(counts, np.int32),
            width, height)


@pytest.mark.cuda
def test_k1_k2_edge_tiles_match_plain(cuda):
    """K1 bit-equal to `blend_forward_plain`, K2 within 1e-5 of each
    column's largest |row| of `blend_backward_plain` with its zero rows
    equal, both bit-identical over two runs, on `_edge_tiles`."""
    feat, gid, starts, counts, width, height = (
        torch.tensor(x, device=cuda) if isinstance(x, np.ndarray) else x
        for x in _edge_tiles())
    gx = -(-width // 16)
    k1_args = (feat, gid, starts, counts, gx, width, height)
    color, final_t, n_contrib = tile_blend.blend_forward(*k1_args)
    again = tile_blend.blend_forward(*k1_args)
    pc, pt, pn = tile_blend.blend_forward_plain(*k1_args)
    torch.cuda.synchronize()
    for a, b, p in zip((color, final_t, n_contrib), again, (pc, pt, pn)):
        assert torch.equal(a, b) and torch.equal(a, p)
    # the data reaches the edges it is built for
    nc = n_contrib.cpu()
    assert int(nc[:16, :16].min()) > 2900                # every pixel walks far
    assert (nc[8:16, 32:48] == 0).all() and int(nc[:4, 32:48].max()) > 500
    assert int(nc[:, 48:64][:16].max()) <= 60

    rng = np.random.default_rng(12)
    g_color = torch.tensor(rng.normal(size=(3, height, width)).astype(np.float32),
                           device=cuda)
    g_final_t = torch.tensor(rng.normal(size=(height, width)).astype(np.float32),
                             device=cuda)
    k2_args = (feat, gid, starts, counts, final_t, n_contrib, g_color, g_final_t)
    rows = tile_blend.blend_backward(*k2_args)
    rows2 = tile_blend.blend_backward(*k2_args)
    ref = tile_blend.blend_backward_plain(*k2_args)
    torch.cuda.synchronize()
    assert torch.equal(rows, rows2)
    scale = ref.abs().amax(0).clamp(min=1e-30)
    assert ((rows - ref).abs() / scale).max().item() <= 1e-5
    assert torch.equal(rows == 0, ref == 0)
    assert (rows[int(starts[3]) + 60:int(starts[4])] == 0).all()
    assert (rows[:int(starts[1])] != 0).any(1).float().mean().item() > 0.3


def _heavy_tile(m=20_000, seed=13):
    """One 16x16 tile of `m` pairs, more than any tile the clamped protocol
    keeps (768) and past the 13,847 of an unclamped PROTOCOL step: small
    faint splats (alpha at most 0.012), a few hundred over each pixel, so
    the pixels stay unsaturated and walk to the list's end, through many
    turns of K1's and K2's staging rings. -> feat (m + 1, FEAT),
    sorted_gid, starts, counts, width, height."""
    rng = np.random.default_rng(seed)
    f = np.zeros((m, tile_blend.FEAT), np.float32)
    f[:, 0:2] = rng.uniform(0, 16, (m, 2))
    sx, sy = rng.uniform(0.5, 1.5, m), rng.uniform(0.5, 1.5, m)
    rho = rng.uniform(-0.3, 0.3, m)
    det = (sx * sy) ** 2 * (1 - rho ** 2)
    f[:, 2] = sy ** 2 / det
    f[:, 3] = -rho * sx * sy / det
    f[:, 4] = sx ** 2 / det
    f[:, 5] = rng.uniform(0.004, 0.012, m)
    f[:, 6:9] = rng.uniform(0.05, 0.95, (m, 3))
    f[:, 9] = 1.0
    perm = rng.permutation(m)
    feat = np.zeros((m + 1, tile_blend.FEAT), np.float32)
    feat[perm] = f
    return (feat, perm.astype(np.int32), np.array([0, m], np.int32),
            np.array([m], np.int32), 16, 16)


@pytest.mark.cuda
def test_k1_k2_tile_of_20000_pairs_match_plain(cuda):
    """K1 bit-equal to `blend_forward_plain`, K2 within 1e-5 of each
    column's largest |row| of `blend_backward_plain` with its zero rows
    equal, both bit-identical over two runs, on `_heavy_tile`: one tile of
    20,000 pairs that every pixel walks past its 19,000th."""
    feat, gid, starts, counts, width, height = (
        torch.tensor(x, device=cuda) if isinstance(x, np.ndarray) else x
        for x in _heavy_tile())
    k1_args = (feat, gid, starts, counts, 1, width, height)
    color, final_t, n_contrib = tile_blend.blend_forward(*k1_args)
    again = tile_blend.blend_forward(*k1_args)
    pc, pt, pn = tile_blend.blend_forward_plain(*k1_args)
    torch.cuda.synchronize()
    for a, b, p in zip((color, final_t, n_contrib), again, (pc, pt, pn)):
        assert torch.equal(a, b) and torch.equal(a, p)
    assert n_contrib.min().item() > 19_000
    assert final_t.min().item() > 1e-3                  # no pixel saturates

    rng = np.random.default_rng(14)
    g_color = torch.tensor(rng.normal(size=(3, height, width)).astype(np.float32),
                           device=cuda)
    g_final_t = torch.tensor(rng.normal(size=(height, width)).astype(np.float32),
                             device=cuda)
    k2_args = (feat, gid, starts, counts, final_t, n_contrib, g_color, g_final_t)
    rows = tile_blend.blend_backward(*k2_args)
    rows2 = tile_blend.blend_backward(*k2_args)
    ref = tile_blend.blend_backward_plain(*k2_args)
    torch.cuda.synchronize()
    assert torch.equal(rows, rows2)
    scale = ref.abs().amax(0).clamp(min=1e-30)
    assert ((rows - ref).abs() / scale).max().item() <= 1e-5
    assert torch.equal(rows == 0, ref == 0)
    assert (rows != 0).any(1).float().mean().item() > 0.9


@pytest.mark.cuda
@pytest.mark.parametrize("name", LAYOUTS)
def test_k3_layouts_match_plain(cuda, name):
    """K3 against `segment_sum_plain` (a float64 index_add_) within 1e-6 of
    each column's largest sum, on layouts that reach its 4-lane groups,
    its block-wide sums of long segments (lengths LONG_SEGMENT + 1, 65,
    8,160, a 40,000-pair run at the highest destination, a block of long
    segments) and the empty cases; bit-identical over two runs; one launch
    counted per call."""
    rows, gp, starts, lengths = (torch.tensor(x, device=cuda)
                                 for x in k3_layout(name))
    before = segsum.segment_sum.launches
    out = segsum.segment_sum(rows, gp, starts)
    again = segsum.segment_sum(rows, gp, starts)
    ref = segsum.segment_sum_plain(rows, gp, starts)
    torch.cuda.synchronize()
    assert segsum.segment_sum.launches == before + 2
    assert out.shape == (lengths.shape[0] + 1, segsum.FEAT)
    assert torch.equal(out, again)
    assert (out[-1] == 0).all()
    assert_column_close(out.cpu().numpy(), ref.cpu().numpy())


@pytest.mark.cuda
def test_k3_adds_no_host_sync(cuda):
    """A K3 call reads no size back from the card: it runs under
    `set_sync_debug_mode("error")`, which raises on a synchronising op."""
    rows, gp, starts, _ = (torch.tensor(x, device=cuda)
                           for x in k3_layout("edges"))
    segsum.segment_sum(rows, gp, starts)            # built and warm
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = segsum.segment_sum(rows, gp, starts)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert_column_close(out.cpu().numpy(),
                        segsum.segment_sum_plain(rows, gp, starts).cpu().numpy())


def _rasterize_grads(device, sc, bg, cfg, width, height):
    leaves = [sc[k].detach().to(device).requires_grad_()
              for k in ("means", "cov6", "opacity", "rgb")]
    out = rasterize(*leaves, bg.to(device), _camera(width, height, device), cfg)
    target = torch.linspace(0, 1, 3 * height * width, device=device).reshape(
        3, height, width)
    loss = ((out.color - target) ** 2).sum() + 0.1 * out.final_t.sum()
    return [g.cpu() for g in torch.autograd.grad(loss, leaves)]


@pytest.mark.cuda
def test_rasterize_backward_on_cuda(cuda):
    """Through BlendFunction (K1, K2, K3): bit-identical over two runs, and
    within the normalized 2e-4 of the plain path on the CPU."""
    width, height = 256, 200
    sc = _scene(5000, cuda, seed=5)
    bg = torch.tensor([0.1, 0.2, 0.3])
    cfg = RasterizerConfig(width=width, height=height, max_per_tile=1024)
    ga = _rasterize_grads(cuda, sc, bg, cfg, width, height)
    gb = _rasterize_grads(cuda, sc, bg, cfg, width, height)
    for a, b in zip(ga, gb):
        assert torch.equal(a, b)
    gc = _rasterize_grads("cpu", {k: v.cpu() for k, v in sc.items()}, bg, cfg,
                          width, height)
    for a, c in zip(ga, gc):
        scale = c.abs().max()
        assert ((a - c).abs() / scale).max().item() <= 2e-4


def _write_object(dirpath, name, subdiv, offset, seed):
    """A mesh-Gaussian object (PLY + OBJ) moved off its faces, SH degree 3."""
    v, f = icosphere(subdiv)
    v = (v + np.asarray(offset, np.float32)).astype(np.float32)
    model = mesh_gaussians.create_from_mesh(v, f, device="cpu")
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for p, scale, shift in ((model.bc, 0.5, 0), (model.distance, 0.5, 0),
                                (model.rotation, 0.5, 0), (model.opacity, 1.0, 3),
                                (model.features_rest, 0.1, 0)):
            p.add_(torch.tensor(rng.normal(shift, scale, p.shape), dtype=torch.float32))
    ply, obj = str(dirpath / f"{name}.ply"), str(dirpath / f"{name}.obj")
    gaussian_ply.save_mesh_gaussian_ply(ply, model)
    mesh_io.write_triangle_mesh(obj, v, f)
    return ply, obj, v


def _composite_editor(tmp_path, device):
    """A twisting icosphere-3 object, a static icosphere-2 one and a
    2,000-Gaussian background (SH degree 1) -> (editor, object vertices)."""
    main = _write_object(tmp_path, "main", 3, (0, 0, 0), 1)
    side = _write_object(tmp_path, "side", 2, (1.4, 0.3, -0.2), 2)
    rng = np.random.default_rng(3)
    n = 2000
    bg = gaussians.from_numpy(dict(
        xyz=rng.uniform(-3, 3, (n, 3)), features_dc=rng.normal(0, 1, (n, 1, 3)),
        features_rest=rng.normal(0, 0.1, (n, 3, 3)),
        scaling=np.full((n, 3), np.log(0.08)), rotation=rng.normal(size=(n, 4)),
        opacity=rng.normal(0, 1, (n, 1))), np.ones(n, bool), device="cpu")
    gaussian_ply.save_gaussian_ply(str(tmp_path / "bg.ply"), bg)
    editor = runtime.SceneEditor(str(tmp_path / "bg.ply"), max_sh_degree=None,
                                 device=device)
    editor.add_object(*main[:2], name="main")
    editor.add_object(*side[:2], name="side")
    return editor, main[2]


def _twist(v, amp=0.6):
    ang = amp * v[:, 2]
    c, s = np.cos(ang), np.sin(ang)
    return np.stack([c * v[:, 0] - s * v[:, 1], s * v[:, 0] + c * v[:, 1],
                     v[:, 2]], -1).astype(np.float32)


@pytest.mark.cuda
def test_composite_frame_k1_and_render_bits(cuda, tmp_path):
    """A composite playback frame on the card: one K1 launch, K1 within 1e-6
    of `blend_forward_plain` on the frame's arguments, and the frame equal
    to `SceneEditor.render` of the same deformed scene bit for bit."""
    import functools

    editor, v = _composite_editor(tmp_path, cuda)
    width, height = 256, 200
    cam = _camera(width, height, cuda)
    # the static set alone needs more rows per Gaussian than the scene's mean
    cfg = RasterizerConfig(width, height, max_per_tile=2048,
                           pair_capacity_per_gaussian=40, row_capacity_per_gaussian=16)
    frame_fn = runtime.make_composite_playback_fn(editor, "main", cam, cfg,
                                                  [0.1, 0.2, 0.3])
    v_def = torch.tensor(_twist(v), device=cuda)
    real, calls = tile_blend.blend_forward, []

    @functools.wraps(real)
    def record(*args):
        calls.append(args)
        return real(*args)

    record.launches = 0
    tile_blend.blend_forward = record
    try:
        out = frame_fn(v_def)
    finally:
        tile_blend.blend_forward = real
    torch.cuda.synchronize()
    assert len(calls) == 1 and record.launches == 1
    assert int(out.tile_overflow) == 0 and int(out.rect_overflow) == 0
    color, final_t, _ = tile_blend.blend_forward(*calls[0])
    pc, pt, _ = tile_blend.blend_forward_plain(*calls[0])
    torch.testing.assert_close(color, pc, atol=1e-6, rtol=0)
    torch.testing.assert_close(final_t, pt, atol=1e-6, rtol=0)
    editor.deform_object("main", v_def)
    want = editor.render(cam, cfg, bg_color=[0.1, 0.2, 0.3])
    assert torch.equal(out.color, want.color)
    assert int(out.num_rendered) == int(want.num_rendered) > 0
    assert (want.final_t < 0.5).float().mean().item() > 0.05


def _bg_trainer(device, state=None):
    """A `BgTrainer` at 64 px (three views of noise images, a frozen
    icosphere-1 foreground, 150 SfM points) on `device`, from `state` (a
    capture) when given; scales anisotropic and rotations turned."""
    from gaussianmesh_tpu_torch.config import OptimizationParams, RuntimeParams
    from gaussianmesh_tpu_torch.train.bg_trainer import BgTrainer
    from gaussianmesh_tpu_torch.train.trainer import DeviceDataset

    rng = np.random.default_rng(11)
    cams = [_camera(64, 64, device, distance=3.5, azimuth=a) for a in (0.0, 1.5, 3.0)]
    images = (rng.uniform(0.3, 0.7, (3, 3, 64, 64)) * 255).astype(np.uint8)
    ds = DeviceDataset(*(torch.stack(x) for x in zip(*cams)),
                       images=torch.tensor(images, device=device), masks=None,
                       width=64, height=64)
    v, f = icosphere(1)
    fg = mesh_gaussians.create_from_mesh(v, f, max_sh_degree=1, device="cpu")
    fg = mesh_gaussians.from_numpy(
        {k: x.detach().numpy() for k, x in fg.params().items()},
        {k: x.numpy() for k, x in fg.binding().items()}, device=device)
    with torch.no_grad():
        fg.opacity.fill_(4.0)
    pts = (rng.normal(size=(150, 3)) * 2.5).astype(np.float32)
    tr = BgTrainer(fg, pts, rng.uniform(0, 1, (150, 3)), ds, OptimizationParams(),
                   RuntimeParams(max_per_tile=1024, capacity=512), spatial_lr_scale=3.0,
                   max_sh_degree=1)
    if state is not None:
        tr.restore(state)
    else:
        with torch.no_grad():
            for k in ("scaling", "rotation"):
                p = getattr(tr.model, k)
                p.add_(torch.tensor(rng.normal(0, 0.3, p.shape), dtype=torch.float32))
    tr.sh_degree = 1
    return tr


@pytest.mark.cuda
def test_bg_trainer_step_on_cuda_matches_cpu(cuda):
    """One background step (K1 forward over the background and the frozen
    foreground, K2 and K3 over the whole table backward) from the same
    state: gradients within the normalized 2e-4 of the CPU step's, loss to
    1e-5, each kernel launched once."""
    cpu = _bg_trainer("cpu")
    gpu = _bg_trainer(cuda, state=cpu.capture())
    bg = torch.tensor([0.3, 0.6, 0.9])
    mc = cpu.step(1, bg)
    for fn in (tile_blend.blend_forward, tile_blend.blend_backward, segsum.segment_sum):
        fn.launches = 0
    mg = gpu.step(1, bg.to(cuda))
    torch.cuda.synchronize()
    assert (tile_blend.blend_forward.launches, tile_blend.blend_backward.launches,
            segsum.segment_sum.launches) == (1, 1, 1)
    assert float(mg["loss"]) == pytest.approx(float(mc["loss"]), rel=1e-5)
    assert int(mg["tile_overflow"]) == int(mc["tile_overflow"]) == 0
    for k, mu in cpu.adam.mu.items():
        scale = mu.abs().max()
        assert scale > 0, k
        assert ((gpu.adam.mu[k].cpu() - mu).abs() / scale).max().item() <= 2e-4, k
    for k in ("grad_accum", "denom"):
        a, b = getattr(cpu.model.state, k), getattr(gpu.model.state, k).cpu()
        assert ((a - b).abs() / a.abs().max()).max().item() <= 2e-4, k


@pytest.mark.cuda
def test_lpips_on_cuda_matches_cpu(cuda):
    """The LPIPS graph with the seed weights on the card (cuDNN, TF32 off)
    against the same graph on the CPU, within 1e-4 relative, at an odd size
    and at 320x180."""
    from gaussianmesh_tpu_torch.eval.lpips import LPIPSNet, random_weights
    net = LPIPSNet(random_weights(0))
    rng = np.random.default_rng(5)
    for h, w in ((35, 33), (180, 320)):
        a = torch.from_numpy(rng.uniform(0, 1, (3, h, w)).astype(np.float32))
        b = (a + torch.from_numpy(rng.normal(0, 0.1, (3, h, w)).astype(np.float32))).clamp(0, 1)
        with torch.no_grad():
            want = float(net(a, b))
            got = float(net.to(cuda)(a.to(cuda), b.to(cuda)))
        net.cpu()
        assert want > 0 and abs(got - want) <= 1e-4 * want, (h, w, got, want)


def _band_grads(device, sc, bg, cfg, n_bands):
    """Each band of a 2-D image rendered by `rasterize_band` (K1, K2, K3 on
    the card), its loss against a ramp, the gradients summed over the
    bands -> (stitched color, gradients)."""
    from gaussianmesh_tpu_torch.models.render import GaussianArrays
    from gaussianmesh_tpu_torch.parallel import sharding, train_step
    leaves = [sc[k].detach().to(device).requires_grad_()
              for k in ("means", "cov6", "opacity", "rgb")]
    arrays = GaussianArrays(*leaves, torch.ones(len(leaves[0]), dtype=torch.bool,
                                                device=device))
    cam = _camera(cfg.width, cfg.height, device)
    gy_local = sharding.band_rows(sharding.padded_grid_y(cfg.height, n_bands), n_bands)
    target = torch.linspace(0, 1, 3 * gy_local * 16 * cfg.width, device=device).reshape(
        3, gy_local * 16, cfg.width)
    colors, grads = [], [torch.zeros_like(x) for x in leaves]
    for i in range(n_bands):
        out = train_step.rasterize_band(arrays, cam, cfg, gy_local, i * gy_local,
                                        bg.to(device))
        loss = ((out.color - target) ** 2).sum() + 0.1 * out.final_t.sum()
        grads = [a + b for a, b in zip(grads, torch.autograd.grad(loss, leaves))]
        colors.append(out.color.detach())
    return torch.cat(colors, 1)[:, :cfg.height].cpu(), [g.cpu() for g in grads]


@pytest.mark.cuda
def test_rasterize_band_on_cuda_matches_cpu(cuda):
    """`rasterize_band` forward and backward on the card (4 bands of a
    256 x 200 image, the last one past the image's 13 tile rows) against
    the plain path on the CPU: forward 1e-3 max-abs / 1e-5 mean (a pair's
    alpha can round across the 1/255 gate), gradients within 2e-4 of each
    leaf's largest; two runs on the card bit-identical."""
    sc = _scene(5000, cuda, seed=5)
    bg = torch.tensor([0.1, 0.2, 0.3])
    cfg = RasterizerConfig(width=256, height=200, max_per_tile=1024)
    ca, ga = _band_grads(cuda, sc, bg, cfg, 4)
    cb, gb = _band_grads(cuda, sc, bg, cfg, 4)
    assert torch.equal(ca, cb) and all(torch.equal(a, b) for a, b in zip(ga, gb))
    cc, gc = _band_grads("cpu", {k: v.cpu() for k, v in sc.items()}, bg, cfg, 4)
    d = (ca - cc).abs()
    assert d.max().item() <= 1e-3 and d.mean().item() <= 1e-5
    for a, c in zip(ga, gc):
        assert ((a - c).abs() / c.abs().max()).max().item() <= 2e-4


@pytest.mark.cuda
def test_native_acap_matches_deformation_gradients_on_cuda(cuda):
    """The host extractor against the port's deformation gradients on the
    card: float64 within 1e-4 at icosphere level 5, float32 within its
    rounding floor there (2e-3)."""
    from gaussianmesh_tpu_torch.edit import deform, native_acap
    v, f = icosphere(5)
    v_def = _twist(v)
    r, s = native_acap.NativeACAP((v, f)).get_rs(v_def)
    d = deform.MeshDeformer(v, f, device=cuda)
    vd = torch.tensor(v_def, device=cuda)
    r64, s64 = deform.deformation_gradients(d.v_ref.double(), vd.double(),
                                            d.neighbors, d.mask)
    assert np.abs(r - r64.cpu().numpy()).max() <= 1e-4
    assert np.abs(s - s64.cpu().numpy()).max() <= 1e-4
    r32, s32 = d.get_rs(vd)
    assert np.abs(r - r32.cpu().numpy()).max() <= 2e-3
    assert np.abs(s - s32.cpu().numpy()).max() <= 2e-3


@pytest.mark.cuda
@pytest.mark.parametrize("capacity", [4096, 300])
def test_owner_side_gather_backward_k3_matches_plain(cuda, capacity):
    """`segsum.gather_rows` on the card: the forward equals the CPU's, the
    backward is K3 over a send buffer (one launch; capacity 300 drops pairs
    past their bucket) within 1e-6 of each column's largest sum against the
    plain version (a float64 `index_add_`)."""
    from gaussianmesh_tpu_torch.parallel import gauss_shard
    rng = np.random.default_rng(8)
    n, d = 3000, 4
    counts = rng.integers(0, 9, n)
    gid = torch.tensor(np.repeat(np.arange(n), counts))
    dest = torch.tensor(rng.integers(0, d, gid.shape[0]))
    slot, overflow = gauss_shard.send_slots(dest, d, capacity)
    assert (int(overflow) > 0) == (capacity == 300)
    slot_gid = torch.full((d * capacity + 1,), n, dtype=torch.int64)
    slot_gid[slot] = gid
    feat = torch.tensor(rng.normal(size=(n + 1, segsum.FEAT)).astype(np.float32))
    feat[n] = 0.0
    w = torch.tensor(rng.normal(size=(d * capacity, segsum.FEAT)).astype(np.float32))
    args = (slot_gid[:-1], slot.to(torch.int32),
            segsum.segment_starts(torch.tensor(counts, dtype=torch.int32)))
    grads = []
    for dev in (cuda, "cpu"):
        f = feat.to(dev).requires_grad_()
        send = segsum.gather_rows(f, *(a.to(dev) for a in args))
        before = segsum.segment_sum.launches
        (send * w.to(dev)).sum().backward()
        assert segsum.segment_sum.launches == before + (dev == cuda)
        grads.append((send.detach().cpu(), f.grad.cpu()))
    assert torch.equal(grads[0][0], grads[1][0])
    scale = grads[1][1].abs().amax(0).clamp(min=1e-30)
    assert ((grads[0][1] - grads[1][1]).abs() / scale).max().item() <= 1e-6


def _emulated_band(device, sc, bg, cfg):
    """One band of a 4-way Gaussian-table shard emulated in one process
    (`emulate_d=4`: this rank's buckets stand in for the received buffer),
    its loss against a ramp -> (color, gradients of the leaves)."""
    from gaussianmesh_tpu_torch.models.render import GaussianArrays
    from gaussianmesh_tpu_torch.parallel import gauss_shard
    leaves = [sc[k].detach().to(device).requires_grad_()
              for k in ("means", "cov6", "opacity", "rgb")]
    arrays = GaussianArrays(*leaves, torch.ones(len(leaves[0]), dtype=torch.bool,
                                                device=device))
    out = gauss_shard.rasterize_band_gauss_sharded(
        arrays, _camera(cfg.width, cfg.height, device), cfg, None, 20000, bg.to(device),
        emulate_d=4)
    target = torch.linspace(0, 1, out.color.numel(), device=device).reshape(out.color.shape)
    loss = ((out.color - target) ** 2).sum() + 0.1 * out.final_t.sum()
    return out.color.detach().cpu(), [g.cpu() for g in torch.autograd.grad(loss, leaves)]


@pytest.mark.cuda
def test_receiver_blend_on_a_received_buffer_matches_cpu(cuda):
    """The receiver's blend of a send buffer standing in for the received
    one (an emulated rank of 4 at 256 x 200): K1 once, K2 once, K3
    twice (the receiver's permutation and the owner's reduction); forward
    1e-3 max-abs / 1e-5 mean against the plain path on the CPU, gradients
    within 2e-4 of each leaf's largest; two runs on the card bit-identical."""
    sc = _scene(5000, cuda, seed=6)
    bg = torch.tensor([0.1, 0.2, 0.3])
    cfg = RasterizerConfig(width=256, height=200, max_per_tile=1024)
    for fn in (tile_blend.blend_forward, tile_blend.blend_backward, segsum.segment_sum):
        fn.launches = 0
    ca, ga = _emulated_band(cuda, sc, bg, cfg)
    torch.cuda.synchronize()
    assert (tile_blend.blend_forward.launches, tile_blend.blend_backward.launches,
            segsum.segment_sum.launches) == (1, 1, 2)
    cb, gb = _emulated_band(cuda, sc, bg, cfg)
    assert torch.equal(ca, cb) and all(torch.equal(a, b) for a, b in zip(ga, gb))
    cc, gc = _emulated_band("cpu", {k: v.cpu() for k, v in sc.items()}, bg, cfg)
    d = (ca - cc).abs()
    assert d.max().item() <= 1e-3 and d.mean().item() <= 1e-5
    for a, c in zip(ga, gc):
        assert ((a - c).abs() / c.abs().max()).max().item() <= 2e-4


@pytest.fixture
def two_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs 2 CUDA devices (the port's multi-card run)")
    return torch.device("cuda", 0), torch.device("cuda", torch.cuda.device_count() - 1)


@pytest.mark.cuda
def test_kernels_on_the_last_card_equal_card_0(two_cards):
    """K1, K2 and K3 on tensors of the last card, launched while card 0 is
    the current device (each wrapper enters its tensors' device and takes
    that device's stream; K2 sets its shared-memory attribute there), give
    the bits they give on card 0 for the same inputs."""
    torch.cuda.set_device(0)
    outs = []
    for dev in two_cards:
        args, tiles = _k2_inputs(dev, 256, 256, 1024)
        gx = preprocess.tile_grid(256, 256)[0]
        k1 = tile_blend.blend_forward(*args[:4], gx, 256, 256)
        rows = tile_blend.blend_backward(*args)
        d_feat = segsum.segment_sum(rows, tiles.grouped_pos,
                                    segsum.segment_starts(tiles.gid_counts))
        torch.cuda.synchronize(dev)
        assert rows.device == dev and d_feat.device == dev
        outs.append([t.cpu() for t in (*k1, rows, d_feat)])
    assert outs[0][3].abs().sum() > 0
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_nccl_all_to_all_on_two_cards(two_cards, tmp_path):
    """`sharding.all_to_all` in a 2-rank nccl group, rank r on card r:
    forward and backward equal the reference permutation."""
    import torch_dist_worker as worker

    inp = worker.a2a_inputs(2)
    torch.save(inp, str(tmp_path / "a2a_in.pt"))
    outs = worker.launch("a2a", 2, str(tmp_path), extra_env={"GM_TEST_BACKEND": "nccl"})
    want_out = worker.a2a_reference(list(inp["x"]))
    want_grad = worker.a2a_reference(list(inp["g"]))
    for r, o in enumerate(outs):
        assert o["device"] == f"cuda:{r}"
        assert torch.equal(o["out"], want_out[r]) and torch.equal(o["grad"], want_grad[r])
