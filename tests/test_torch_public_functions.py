"""The JAX package's last public functions against their PyTorch
counterparts on the CPU, the same seeded numpy inputs through both:
`l2_loss` and `photometric_loss` (1e-6), `rotmat_to_quat` (1e-6),
`transform_points_h` in its 3x4 and 4x4 forms (1e-6), `subdivide` (its
integer outputs exactly, its coordinates 1e-6) and `TrainLogger.image` /
`histogram` (the calls a fake writer records; no-ops without a writer)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianmesh_tpu.train import loss as jloss
from gaussianmesh_tpu.utils import graphics as jgraphics, logging as jlogging
from gaussianmesh_tpu.utils import maths as jmaths, subdivision as jsubdivision
from gaussianmesh_tpu_torch.train import loss
from gaussianmesh_tpu_torch.utils import graphics, logging, maths, subdivision

torch.set_num_threads(2)

TOL = 1e-6


def _close(got: torch.Tensor, want, atol=TOL):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=atol, rtol=0)


@pytest.mark.parametrize("shape", [(3, 16, 20), (2, 3, 24, 12)])
def test_l2_and_photometric_losses(shape):
    rng = np.random.default_rng(len(shape))
    pred, gt = (rng.random(shape, dtype=np.float32) for _ in range(2))
    tp, tg = torch.from_numpy(pred), torch.from_numpy(gt)
    _close(loss.l2_loss(tp, tg), jloss.l2_loss(jnp.asarray(pred), jnp.asarray(gt)))
    for lam in (0.2, 0.0, 1.0):
        _close(loss.photometric_loss(tp, tg, lam),
               jloss.photometric_loss(jnp.asarray(pred), jnp.asarray(gt), lam))


def _rotations(rng, n):
    """Seeded rotations: random ones, the identity, and turns of pi (and
    near it) about each axis, where the w candidate is the weakest."""
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q.T
    r = np.stack([np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
                  np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
                  np.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1)],
                 -2)
    special = [np.eye(3)]
    for axis in range(3):
        for angle in (np.pi, np.pi - 1e-3, np.pi / 2):
            c, s = np.cos(angle), np.sin(angle)
            i, j = [(1, 2), (0, 2), (0, 1)][axis]
            m = np.eye(3)
            m[i, i], m[i, j], m[j, i], m[j, j] = c, -s, s, c
            special.append(m)
    return np.concatenate([r, np.stack(special)]).astype(np.float32)


def test_rotmat_to_quat():
    """(N, 3, 3) and (2, N / 2, 3, 3) batches; the quaternions rebuild
    their rotations."""
    r = _rotations(np.random.default_rng(0), 40)
    got, want = maths.rotmat_to_quat(torch.from_numpy(r)), jmaths.rotmat_to_quat(jnp.asarray(r))
    _close(got, want)
    assert (got[:, 0] >= 0).all()
    _close(maths.quat_to_rotmat(got), r, atol=1e-5)
    r2 = r[:50].reshape(2, 25, 3, 3)
    _close(maths.rotmat_to_quat(torch.from_numpy(r2)), jmaths.rotmat_to_quat(jnp.asarray(r2)))


@pytest.mark.parametrize("rows", [3, 4])
def test_transform_points_h(rows):
    rng = np.random.default_rng(rows)
    pts = rng.normal(size=(37, 3)).astype(np.float32)
    m = rng.normal(size=(rows, 4)).astype(np.float32)
    got = graphics.transform_points_h(torch.from_numpy(pts), torch.from_numpy(m))
    want = jgraphics.transform_points_h(jnp.asarray(pts), jnp.asarray(m))
    _close(got, want)


@pytest.mark.parametrize("n_children", [4, 5])
def test_subdivide(n_children):
    rng = np.random.default_rng(n_children)
    v1, v2, v3 = (rng.normal(size=(23, 3)).astype(np.float32) for _ in range(3))
    vidx = rng.integers(0, 500, (23, 3)).astype(np.int32)
    v_base = 517
    (c1, c2, c3), cidx, new_v = subdivision.subdivide(
        *(torch.from_numpy(a) for a in (v1, v2, v3, vidx)), n_children, v_base)
    (j1, j2, j3), jidx, jnew = jsubdivision.subdivide(
        *(jnp.asarray(a) for a in (v1, v2, v3, vidx)), n_children, v_base)
    assert cidx.dtype == torch.int32
    assert np.array_equal(cidx.numpy(), np.asarray(jidx))
    for got, want in ((c1, j1), (c2, j2), (c3, j3), (new_v, jnew)):
        _close(got, want)
    # child 4 of the 1 -> 5 split is the parent itself
    if n_children == 5:
        assert np.array_equal(cidx[:, 4].numpy(), vidx)


class _Writer:
    def __init__(self):
        self.calls = []

    def add_image(self, tag, img, step):
        self.calls.append(("image", tag, np.asarray(img).copy(), step))

    def add_histogram(self, tag, values, step):
        self.calls.append(("histogram", tag, np.asarray(values).copy(), step))

    def close(self):
        pass


def test_train_logger_image_and_histogram(tmp_path):
    """Both loggers hand a writer the same calls: the image clipped to
    [0, 1] (a tensor on the port's side), the histogram's values; without
    a writer both are no-ops."""
    rng = np.random.default_rng(7)
    chw = rng.normal(0.5, 0.6, (3, 8, 6)).astype(np.float32)
    vals = rng.random(50).astype(np.float32)
    port = logging.TrainLogger(str(tmp_path / "port"))
    jax_side = jlogging.TrainLogger(str(tmp_path / "jax"), enabled=False)
    port.close()
    for lg in (port, jax_side):
        lg.image(3, "renders/x", chw)          # no writer: nothing happens
        lg.histogram(3, "opacity", vals)
        lg.writer = _Writer()
    port.image(5, "renders/x", torch.from_numpy(chw))
    port.histogram(6, "opacity", torch.from_numpy(vals))
    jax_side.image(5, "renders/x", jnp.asarray(chw))
    jax_side.histogram(6, "opacity", jnp.asarray(vals))
    got, want = port.writer.calls, jax_side.writer.calls
    assert [(c[0], c[1], c[3]) for c in got] == [(c[0], c[1], c[3]) for c in want] == [
        ("image", "renders/x", 5), ("histogram", "opacity", 6)]
    for a, b in zip(got, want):
        assert np.array_equal(a[2], b[2])
    assert got[0][2].min() >= 0 and got[0][2].max() <= 1
