"""The port's two scaling tools (`tools/bench_scaling_torch.py`,
`tools/bench_sharded_torch.py`) and `bench_torch.py --sharded` at 64x48 with
500 Gaussians on the CPU, against the JAX package (JAX on the CPU, the data
moved as numpy): the band and bucket histograms of its expansion, its band
render, the one-process steps, the byte counts' closed forms, fresh
artifacts, no process group left behind, and no run without a card."""

import contextlib
import io
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _p in (ROOT, os.path.join(ROOT, "tools")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import bench_scaling_torch  # noqa: E402
import bench_sharded_torch  # noqa: E402
import bench_torch  # noqa: E402

import scenes  # noqa: E402

W, H, N = 64, 48, 500
D_LIST = (1, 2, 4)
SMALL = ["--device", "cpu", "--width", str(W), "--height", str(H), "--n_gauss", str(N),
         "--steps", "1", "--warm", "0"]
JAX_SCENE = dict(seed=0, spread=1.4, scale_range=(0.004, 0.02))


def stale(path):
    with open(path, "w") as fh:
        json.dump({"stale_key": 1}, fh)


@pytest.fixture(scope="module")
def scaling(tmp_path_factory):
    """`bench_torch.py --sharded` at 64x48, D = 1, 2, 4, over a stale
    artifact -> (the artifact returned, the file, the printed last line)."""
    out = tmp_path_factory.mktemp("scaling") / "scaling_torch.json"
    stale(out)
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        art = bench_torch.main(["--sharded"] + SMALL + [
            "--d_list", *map(str, D_LIST), "--out", str(out)])
    assert not dist.is_initialized()
    return art, json.loads(out.read_text()), json.loads(printed.getvalue().splitlines()[-1])


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    out = tmp_path_factory.mktemp("sharded") / "sharded_bench_torch.json"
    stale(out)
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        art = bench_sharded_torch.main(SMALL + ["--out", str(out)])
    assert not dist.is_initialized()
    return art, json.loads(out.read_text()), json.loads(printed.getvalue().splitlines()[-1])


def jax_pairs():
    """The JAX package's live pairs of the scene (`tools/bench_scaling.py:
    186-194`) -> (tile ids, Gaussian ids, grid)."""
    from gaussianmesh_tpu.ops import binning, preprocess as prep_mod
    from gaussianmesh_tpu.ops.rasterize import RasterizerConfig

    sc = scenes.random_gaussians(N, **JAX_SCENE)
    cam = scenes.look_at_camera(W, H, distance=4.0)
    cfg = RasterizerConfig(width=W, height=H, max_per_tile=1024,
                           pair_capacity_per_gaussian=9, row_capacity_per_gaussian=3,
                           use_pallas=False)

    @jax.jit
    def expand(means, cov6, opacity):
        prep = prep_mod.preprocess(means, cov6, cam, W, H, opacity=opacity)
        return binning.expand_pairs(prep, *cfg.grid, cfg.expand_capacity(N),
                                    opacity=opacity, row_capacity=cfg.row_capacity(N))

    exp = expand(sc["means3d"], sc["cov6"], sc["opacity"])
    tiles, gids = np.asarray(exp.pair_tile), np.asarray(exp.gid_slot)
    live = tiles < cfg.num_tiles
    return tiles[live].astype(np.int64), gids[live].astype(np.int64), cfg.grid


def test_histograms_equal_the_jax_expansion(scaling):
    """(a) Each band's pair histogram and the (shard, band) bucket histogram
    equal exactly those of `gaussianmesh_tpu.ops.binning.expand_pairs` by the
    JAX tool's formulas (`tools/bench_scaling.py:196-213, 256-258`); each
    band's render holds its histogram's pairs, each emulated rank sends its
    row of buckets, and nothing overflows at the timed capacities."""
    art = scaling[0]
    tiles, gids, (gx, gy) = jax_pairs()
    assert art["plain_step"]["num_rendered"] == tiles.shape[0] > 0
    for d in D_LIST:
        gy_pad = -(-gy // d) * d
        gy_local = gy_pad // d
        hist = np.bincount(np.minimum(tiles // gx // gy_local, d - 1), minlength=d)
        n_local = N // d
        buckets = np.zeros((d, d), np.int64)
        np.add.at(buckets, (np.minimum(gids // n_local, d - 1),
                            np.minimum(tiles // gx // gy_local, d - 1)), 1)
        band = art["tile_bands"][str(d)]
        assert band["pair_hist"] == art["comms"][str(d)]["pair_hist"] == hist.tolist(), d
        assert [b["num_rendered"] for b in band["bands"]] == hist.tolist(), d
        assert sum(b["num_rendered"] for b in band["bands"]) == tiles.shape[0]
        for b in band["bands"]:
            assert b["tile_overflow"] == b["rect_overflow"] == b["pair_overflow"] == 0, b
        assert band["jax_capacity"] == bench_scaling_torch.jax_capacity(d)
        g = art["gauss_shard_bands"][str(d)]
        assert g["buckets"] == buckets.tolist() and g["bucket_max"] == buckets.max(), d
        assert g["send_capacity"]["jax_live"] == -(-(buckets.max() + 256) // 128) * 128
        for label in ("design", "jax_live"):
            ranks = g[label]["ranks"]
            assert [r["sent"] for r in ranks] == buckets.sum(1).tolist(), (d, label)
            assert all(r["send_overflow"] == 0 for r in ranks), (d, label)
            assert len(g[label]["per_device_ms"]) == d
            assert g[label]["critical_ms"] == max(g[label]["per_device_ms"])
        assert len(band["per_band_ms"]) == d
        assert band["critical_ms"] == max(band["per_band_ms"])


def test_bands_match_the_whole_render_and_jax(scaling):
    """(b) At each D the bands' colors, stacked and cut to H rows, equal the
    port's whole-image render within 3e-5 and the summed band gradients its
    gradients within 2e-4 of each leaf's largest; each band matches the JAX
    package's `train_step.rasterize_band` (`use_pallas=False`) within 3e-5,
    its gradients within 2e-4."""
    from gaussianmesh_tpu.models.render import GaussianArrays as JArrays
    from gaussianmesh_tpu.ops.rasterize import RasterizerConfig as JConfig
    from gaussianmesh_tpu.parallel.train_step import rasterize_band as jax_band

    art = scaling[0]
    w = bench_torch.make_workload(W, H, N, "cpu")
    _, _, whole = bench_torch.fwd_bwd(w)
    whole_grads = [x.grad.clone() for x in w.inputs]
    sc = scenes.random_gaussians(N, **JAX_SCENE)
    jin = tuple(jnp.asarray(sc[k]) for k in ("means3d", "cov6", "opacity", "rgb"))
    cam = scenes.look_at_camera(W, H, distance=4.0)
    for d in D_LIST:
        rec = art["tile_bands"][str(d)]
        gy_local = rec["gy_local"]
        cfg = bench_scaling_torch.band_config(w.cfg, rec)
        jcfg = JConfig(width=W, height=H, max_per_tile=rec["max_per_tile"],
                       pair_capacity_per_gaussian=rec["capacity"][0],
                       row_capacity_per_gaussian=rec["capacity"][1], use_pallas=False)

        @jax.jit
        def jstep(inputs, y0, gy_local=gy_local, jcfg=jcfg):
            def f(inp):
                m, c, o, r = inp
                out = jax_band(JArrays(m, c, o, r, jnp.ones((N,), bool)), cam, jcfg,
                               gy_local, y0, jnp.ones(3))
                rows = y0 * 16 + jnp.arange(gy_local * 16)
                ok = (rows < H).astype(jnp.float32)[None, :, None]
                return jnp.sum((out.color * ok) ** 2), out.color
            return jax.value_and_grad(f, has_aux=True)(inputs)

        colors, summed = [], [torch.zeros_like(g) for g in whole_grads]
        for k in range(d):
            _, grads, out = bench_sharded_torch.band_grads(w, cfg, gy_local, k * gy_local)
            (_, ref_color), ref_grads = jstep(jin, jnp.asarray(k * gy_local, jnp.int32))
            err = np.abs(out.color.detach().numpy() - np.asarray(ref_color)).max()
            assert err <= 3e-5, (d, k, err)
            for g, r in zip(grads, ref_grads):
                r = np.asarray(r).reshape(g.shape)
                assert np.abs(g.numpy() - r).max() <= 2e-4 * max(np.abs(r).max(), 1e-30), (d, k)
            colors.append(out.color.detach())
            summed = [s + g for s, g in zip(summed, grads)]
        stacked = torch.cat(colors, 1)[:, :H]
        assert (stacked - whole.color.detach()).abs().max() <= 3e-5, d
        assert bench_sharded_torch.max_rel(summed, whole_grads) <= 2e-4, d


def test_one_by_one_steps_equal_the_plain_step(sharded, scaling):
    """(c) The (1, 1) (data, tile) step and the world-of-one Gaussian-table
    step against the plain step: losses within 1e-6 relative, gradients
    within 2e-4 of each leaf's largest, here and in the artifact; the (1, 1)
    training step's first loss within 1e-6 of the trainer's, its parameters
    within 5e-4; no process group left behind."""
    from gaussianmesh_tpu_torch.parallel import gauss_shard

    w = bench_torch.make_workload(W, H, N, "cpu")
    loss0, _, out0 = bench_torch.fwd_bwd(w)
    ref = [x.grad.clone() for x in w.inputs]
    with bench_sharded_torch.world_of_one(w.device) as mesh:
        assert dist.get_world_size() == 1 and mesh.n_data == mesh.n_tile == 1
        got = {"tile": bench_sharded_torch.tile_step(w, mesh),
               "gauss": bench_sharded_torch.gauss_step(
                   w, mesh, gauss_shard.send_capacity(w.cfg, N, 1))}
    assert not dist.is_initialized()
    for name, (loss, grads, out) in got.items():
        assert abs(float(loss) - float(loss0)) <= 1e-6 * abs(float(loss0)), name
        assert bench_sharded_torch.max_rel(grads, ref) <= 2e-4, name
        assert int(out.num_rendered) == int(out0.num_rendered), name
    steps = sharded[0]["steps"]
    for name in ("tile", "gauss"):
        a = steps[name]["agreement"]
        assert a["loss_rel"] <= 1e-6 and a["grad_rel"] <= 2e-4, (name, a)
        assert steps[name]["num_rendered"] == steps["plain"]["num_rendered"]
        assert steps[name]["overhead_host"] > 0
    assert steps["gauss"]["send_overflow"] == 0
    first = scaling[0]["sharded_train_step"]["sharded_1x1"]["first_step"]
    assert first["loss_rel"] <= 1e-6 and first["param_rel"] <= 5e-4, first
    assert first["overflow"] == 0


def test_byte_counts_match_their_closed_forms(scaling, sharded):
    """(d) Every byte count against its closed form; the JAX tools' pair
    counts stand beside the design's and the live ones and differ from them
    (fault B12)."""
    from gaussianmesh_tpu_torch.parallel import gauss_shard

    s = sharded[0]
    buf = (N * (3 + 6 + 1 + 3) + 1) * 4
    assert s["traffic"]["bytes_per_slot"] == {"meta": 8, "feature": 64, "cotangent": 64}
    live = s["workload"]["live_pairs"]
    cfg = bench_torch.make_workload(W, H, N, "cpu").cfg
    for d in bench_sharded_torch.MODEL_D:
        c = s["bytes_per_step"]["per_d"][str(d)]
        cap = max(-(-(N // d) * 9 // d) * 4, 1024)
        assert cap == gauss_shard.send_capacity(cfg, N // d, d)
        ex = c["exchange"]
        assert c["grad_all_reduce_buffer"] == buf
        assert c["grad_all_reduce_ring"] == pytest.approx(2 * (d - 1) / d * buf)
        assert c["halo"] == 3 * (d - 1) * 3 * 10 * W * 4
        assert ex["slots"] == d * cap and ex["design_bytes_out"] == d * cap * 72
        assert ex["design_bytes_back"] == d * cap * 64
        assert ex["design_bytes_leaving"] == (d - 1) * cap * 136
        assert ex["live_bytes_leaving"] < ex["design_bytes_leaving"]
        j = c["jax_count"]
        assert j["grad_all_reduce"] == 2 * N * 60 * 4 and j["halo"] == 2 * 5 * W * 3 * 4
        assert j["pair_exchange"] == pytest.approx(live * 76 / d * (d - 1) / d)
        assert j["pair_exchange"] != ex["design_bytes_out"]
    art = scaling[0]
    trainer = art["sharded_train_step"]
    flat = [c for c in trainer["traffic"] if c["group"] == "world"][0]
    assert flat["bytes"] == (trainer["capacity"] * 60 + 1) * 4
    for d in D_LIST:
        c = art["comms"][str(d)]
        hist = np.asarray(c["pair_hist"])
        j = c["jax_count"]
        assert j["a2a_bytes_per_dev"] == d * hist.max() * 76
        assert j["grad_allreduce_bytes"] == int(2 * (d - 1) / d * N * 59 * 4)
        assert c["bench_grad_all_reduce_ring"] == pytest.approx(2 * (d - 1) / d * buf)
        ex = c["exchange"]
        assert ex["send_capacity"] == art["gauss_shard_bands"][str(d)]["send_capacity"]["design"]
        assert j["a2a_bytes_per_dev"] != ex["design_bytes_out"]
    assert art["comms"]["4"]["train_data_axis_ring"] > art["comms"]["2"]["train_data_axis_ring"]


def test_artifacts_are_fresh_and_name_the_device(scaling, sharded):
    """(e), (g) Each artifact is the run's own (a stale key is gone), names
    the device and carries the links as assumptions; the scaling line is
    printed through `bench_torch.py --sharded`."""
    for art, written, _ in (scaling, sharded):
        assert written == json.loads(json.dumps(art)) and "stale_key" not in written
        assert written["card"] == "cpu" and written["power_limit"] is None
    line = scaling[2]
    assert line["metric"] == "scaling_efficiency_8dev_model" and line["unit"] == "fraction"
    assert line["detail"]["d"] == 4 and line["vs_baseline"] == pytest.approx(line["value"] / 0.8)
    assert line["value"] == max(line["detail"]["tile_axis_eff"],
                                line["detail"]["gauss_shard_eff"]) > 0
    assert sharded[2] == sharded[1]
    for link in bench_sharded_torch.LINKS.values():
        assert "not measured" in link["spec"]
    model = scaling[0]["efficiency_model"]
    assert model["busy"]["tile_axis"]["2"] is None        # no device clock here
    assert 0 < model["host"]["data_axis"]["8"]["nvlink4"]["eff_no_overlap"] <= 1


def test_tools_raise_without_a_card(tmp_path, monkeypatch):
    """(h) Without --device cpu and with no card each tool raises and writes
    nothing."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = str(tmp_path / "x.json")
    for run in (lambda: bench_scaling_torch.main(["--out", out]),
                lambda: bench_sharded_torch.main(["--out", out]),
                lambda: bench_torch.main(["--sharded", "--out", out])):
        with pytest.raises(RuntimeError, match="CUDA"):
            run()
    assert not os.path.exists(out) and not dist.is_initialized()


def test_profile_critical_keeps_each_ds_critical_items():
    """`--profile critical` drops the queued profiles of every band and
    emulated rank but each D's largest host ms, and keeps the plain and
    training steps'; `summarize_items` then reads the profiled item's busy
    ms as the D's critical one."""
    def item(ms):
        return {"host_ms": ms, "busy_ms": None}
    tile = {"1": {"bands": [item(5.0)]}, "8": {"bands": [item(1.0), item(3.0), item(2.0)]}}
    gauss = {d: {"design": {"ranks": [item(1.0), item(4.0)]},
                 "jax_live": {"ranks": [item(6.0), item(2.0)]}} for d in ("1", "8")}
    plain, step = item(9.0), item(7.0)
    queued = [(r, None, "host_ms") for r in [plain, step]
              + [b for rec in tile.values() for b in rec["bands"]]
              + [r for rec in gauss.values() for lab in rec.values() for r in lab["ranks"]]]
    kept = [e[0] for e in bench_scaling_torch.critical_only(queued, tile, gauss)]
    assert kept[:2] == [plain, step] and len(kept) == 2 + 2 + 4
    assert tile["8"]["bands"][1] in kept and tile["8"]["bands"][2] not in kept
    for r in kept:
        r["busy_ms"] = r["host_ms"] / 2
    rec = dict(tile["8"])
    bench_scaling_torch.summarize_items(rec, rec["bands"], "per_band_ms")
    assert rec["critical_index"] == 1 and rec["critical_busy_ms"] == 1.5
    assert rec["per_busy_ms"] == [None, 1.5, None]
