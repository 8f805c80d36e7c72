"""The multi-card path of the port on the CPU: `tools/multicard_torch.py`
on 4 gloo ranks at 64x48, its efficiency formulas, `multihost.initialize`'s
card and backend choice, the collectives' device guard, the smoke's rank
plan and an all_to_all against its reference permutation. No JAX: the ranks
and the tool import neither it nor the JAX package."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from gaussianmesh_tpu_torch.parallel import multihost, sharding

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tools")]

import chip_smoke  # noqa: E402
import multicard_torch as mc  # noqa: E402
import torch_dist_worker as worker  # noqa: E402

SMALL = ["--device", "cpu", "--size", "64", "--teacher_subdiv", "3",
         "--proxy_subdiv", "1", "--init_target", "300", "--pretrain", "10",
         "--playback", "64", "48",
         "--bench_width", "64", "--bench_height", "48", "--bench_n", "500",
         "--procs", "1", "--timed", "1", "--warm", "0", "--profiled", "1",
         "--collective_reps", "1", "--cli_iters", "4", "--meshes", "2x2", "1x4",
         "--join_s", "300"]


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    """The tool on 4 gloo ranks at 64x48, A, B and C, over a stale file."""
    out = tmp_path_factory.mktemp("multicard") / "multicard.json"
    out.write_text(json.dumps({"stale": True}))
    proc = subprocess.run([sys.executable, "tools/multicard_torch.py", *SMALL,
                           "--out", str(out)], cwd=ROOT, capture_output=True, text=True,
                          timeout=900, env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, (proc.stdout + proc.stderr)[-6000:]
    return json.loads(out.read_text())


def test_artifact_is_fresh_with_every_field(artifact):
    assert "stale" not in artifact
    for key in ("machine", "world", "model_d4", "config2", "agreement", "timing",
                "entry_point"):
        assert artifact[key] is not None, key
    m = artifact["machine"]
    assert m["device"] == "cpu" and m["count"] == 0
    assert m["cards"] is None and m["nccl"] is None and m["topology"] is None
    model = artifact["model_d4"]
    assert model["file"] == "results/scaling_torch.json"
    assert model["host"]["tile_axis"] == pytest.approx(0.3256, abs=1e-4)
    assert model["host"]["gauss_shard_axis"] == pytest.approx(0.2064, abs=1e-4)
    assert model["exchange_design_bytes_leaving"] == 91_800_000
    assert artifact["config2"]["n_gauss"] == 320 and artifact["config2"]["capacity"] == 4096


def test_reduction_orders_recorded(artifact):
    """Step 1's update from the (4, 1) ranks' partials, summed in rank order
    and in reverse, beside the single-card reference, on the fresh table
    (Adam's first step) and on the pretrained one; at this size every leaf
    holds the step-1 bar in both orders."""
    r = artifact["config2"]["reduction_order"]
    assert r["fresh"]["adam_step"] == 0 and r["pretrained"]["adam_step"] == 10
    for table in r.values():
        assert table["mesh"] == [4, 1] and table["views"] == [0, 2, 4, 6]
        assert table["eps"] == 1e-15 and table["bar"] == 5e-4
        for order in ("ranks", "ranks_reversed"):
            leaves = table[order]["leaves"]
            assert set(leaves) == {"bc", "distance", "features_dc", "features_rest",
                                   "scaling", "rotation", "opacity"}
            assert table[order]["param_rel"] == max(x["rel"] for x in leaves.values())
            assert table[order]["param_rel"] <= 5e-4


@pytest.mark.parametrize("mesh", ["2x2", "1x4"])
def test_mesh_agreement(artifact, mesh):
    """Step 1 against the single process within the JAX bars, the events in
    order, the ranks' hashes equal (the tool asserts them), a world of 4."""
    a = artifact["agreement"]["meshes"][mesh]
    assert a["backend"] == "gloo" and a["devices"] == ["cpu"] * 4
    for s in a["step1"]:
        assert s["loss_rel"] <= 1e-4 and s["param_rel"] <= 5e-4
        assert s["grad_accum_abs"] <= 1e-5 and s["denom_equal"]
    assert [(it, k) for it, k, _ in a["events"]] == mc.EVENTS
    assert a["hashes_equal"] and len(a["losses"]) == mc.STEPS
    assert all(np.isfinite(a["losses"]))
    if mesh == "1x4":
        for p in a["playback"]:
            assert p["bands"] == 4 and p["frames"] == mc.PLAYBACK_CALLS
            assert p["max_abs"] <= 2e-5
    else:
        assert a["playback"] is None


def test_gauss_shard_agreement(artifact):
    """D = 4: step 1, the sharded densify's n_split equal to the single
    process's, the resume bit for bit, the one-card load of the per-rank
    checkpoint equal to the gathered table, no send overflow."""
    g = artifact["agreement"]["gshard"]
    assert g["backend"] == "gloo"
    for s in g["step1"]:
        assert s["loss_rel"] <= 1e-4 and s["param_rel"] <= 5e-4 and s["denom_equal"]
        assert s["send_overflow"] == 0 and s["overflow"] == 0
    assert len(g["densify"]) == 2
    assert all(c["n_split"] == c["single_n_split"] > 0 for c in g["densify"])
    assert g["resume_equal"] and g["one_card_load"]["equal"]
    assert g["checkpoint"] == ["index.json", "rank0.pt", "rank1.pt", "rank2.pt",
                               "rank3.pt", "replicated.pt"]
    assert g["received_live"][g["kernel_rank"]] == max(g["received_live"]) > 0
    assert g["kernels"] is None          # the kernels are checked on a card only


def test_timing_fields(artifact):
    """B at the CPU's size: every item timed on every rank, busy ms None (no
    device clock), the collectives of each distributed step recorded with
    their bytes, the Gaussian-table exchange three all_to_all calls."""
    t = artifact["timing"]
    items = t["per_world"][0]["items"]
    assert set(items) == {"bench_plain", "bench_tile_1x4", "bench_gauss_d4",
                          "config2_single", "config2_data_4x1", "config2_gauss_d4"}
    for item in items.values():
        assert len(item["host_ms_by_rank"]) == 4 and all(x > 0 for x in item["host_ms_by_rank"])
        assert item["busy_ms_by_rank"] == [None] * 4
    col = t["collectives"]
    assert col["bench_plain"]["in_step"] == [] and col["config2_single"]["in_step"] == []
    a2a = [c for c in col["config2_gauss_d4"]["in_step"] if c["kind"] == "all_to_all"]
    assert len(a2a) == 3 and a2a[1]["bytes"] == 16 * 4 * artifact["timing"]["config2"][
        "slots_per_rank"]
    ex = col["config2_gauss_d4"]["per_step"]["all_to_all"]
    slots = artifact["timing"]["config2"]["slots_per_rank"]
    assert ex["calls"] == 3 and ex["bytes"] == slots * (8 + 64 + 64)
    assert ex["bytes_leaving"] == 3 / 4 * ex["bytes"] and ex["alone_ms"] is None
    world = [c for c in col["config2_data_4x1"]["in_step"]
             if c["kind"] == "all_reduce" and c["group"] == "world"]
    assert world and world[0]["bytes"] > 1e5
    assert t["bench"]["tile_check"]["loss_rel"] <= 1e-4
    assert t["bench"]["gauss_check"]["send_overflow"] == 0
    m = t["efficiency"]["measured"]
    assert m["host"]["tile_axis"] > 0 and set(m["busy"].values()) == {None}


def test_entry_point_runs(artifact):
    """C: torchrun at (2, 2) and at --shard_gaussians 4, one process beside
    them; each model directory rendered and scored, a checkpoint at half."""
    c = artifact["entry_point"]
    assert set(c["runs"]) == {"single", "data2_tile2", "shard4"}
    assert c["runs"]["shard4"]["checkpoint"].endswith(".ckpt.shards")
    for run in c["runs"].values():
        (psnr,) = run["psnr"].values()
        assert np.isfinite(psnr) and psnr > 5


def _report(host, busy):
    return {"items": {k: {"host_ms": h, "busy_clock_ms": b, "busy_ms": b + 1,
                          "nccl_ms": 1.0, "comm_alone_ms": 0.5, "device_operations": 1.0}
                      for k, h, b in zip(("bench_plain", "bench_tile_1x4", "bench_gauss_d4",
                                          "config2_single", "config2_data_4x1",
                                          "config2_gauss_d4"), host, busy)}}


def test_efficiency_closed_forms():
    """Tile and Gaussian-table axes: the plain step (median over ranks) over
    4 x the slowest rank's step; data axis: the single-card step over the
    (4, 1) step; the medians over worlds; the bytes leaving a card."""
    ranks = [_report([10, 8, 12, 40, 44, 60], [3, 2, 3, 12, 13, 20]),
             _report([12, 9, 13, 42, 44, 61], [3, 2.5, 3.5, 12, 13, 20]),
             _report([11, 8.5, 14, 44, 46, 62], [3, 2.2, 3, 12, 13.5, 21]),
             _report([13, 8, 12, 46, 45, 60], [3, 2.1, 3, 12, 13, 20])]
    s = mc.summarize_timing([ranks], 4)
    e = s["worlds"][0]["efficiency"]
    plain, tile, gauss = np.median([10, 12, 11, 13]), 9, 14
    assert e["host"]["tile_axis"] == pytest.approx(plain / (4 * tile))
    assert e["host"]["gauss_shard_axis"] == pytest.approx(plain / (4 * gauss))
    assert e["host"]["data_axis"] == pytest.approx(np.median([40, 42, 44, 46]) / 46)
    assert e["host"]["config2_gauss_shard_axis"] == pytest.approx(43 / (4 * 62))
    assert e["busy"]["tile_axis"] == pytest.approx(3 / (4 * 2.5))
    assert e["busy"]["data_axis"] == pytest.approx(12 / 13.5)
    assert s["worlds"][0]["items"]["bench_gauss_d4"]["critical_rank"] == 1
    s3 = mc.summarize_timing([ranks, ranks, [_report([20] * 6, [1] * 6)] * 4], 4)
    assert s3["medians"]["host"]["tile_axis"] == pytest.approx(plain / (4 * tile))
    assert mc.efficiency(None, 1.0, 4) is None
    assert mc.leaving("all_reduce", 1000, 4) == 1500
    assert mc.leaving("all_to_all", 1000, 4) == 750
    assert mc.leaving("all_gather", 1000, 4) == 3000


class _Recorder:
    def __init__(self):
        self.calls = []

    def __call__(self, *a, **k):
        self.calls.append((a, k))


def _fake_host(monkeypatch, cards, world, local_rank, local_world):
    for k, v in (("WORLD_SIZE", world), ("RANK", local_rank), ("LOCAL_RANK", local_rank),
                 ("LOCAL_WORLD_SIZE", local_world)):
        monkeypatch.setenv(k, str(v))
    set_device, init = _Recorder(), _Recorder()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.cuda, "set_device", set_device)
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group", init)
    return set_device, init


def test_initialize_binds_the_local_card_under_nccl(monkeypatch):
    """LOCAL_RANK 3 of 4 on a four-card host takes card 3 and hands it to
    the nccl group as its device_id."""
    set_device, init = _fake_host(monkeypatch, cards=4, world=4, local_rank=3,
                                  local_world=4)
    assert multihost.initialize() is True
    assert set_device.calls == [((torch.device("cuda", 3),), {})]
    ((), kw), = init.calls
    assert kw["backend"] == "nccl" and kw["device_id"] == torch.device("cuda", 3)
    assert kw["rank"] == 3 and kw["world_size"] == 4


def test_initialize_gloo_passes_no_device_id(monkeypatch):
    """gloo on a card host (ranks may share a card) picks the card and binds
    none to the group."""
    set_device, init = _fake_host(monkeypatch, cards=1, world=4, local_rank=2,
                                  local_world=4)
    multihost.initialize(backend="gloo")
    assert set_device.calls == [((torch.device("cuda", 0),), {})]
    ((), kw), = init.calls
    assert kw["backend"] == "gloo" and "device_id" not in kw


def test_initialize_refuses_four_nccl_ranks_on_one_card(monkeypatch):
    _, init = _fake_host(monkeypatch, cards=1, world=4, local_rank=0, local_world=4)
    with pytest.raises(RuntimeError, match="nccl needs a card per rank"):
        multihost.initialize()
    assert init.calls == []


def test_barrier_names_the_card_under_nccl(monkeypatch):
    calls = _Recorder()
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_backend", lambda *a: "nccl")
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 2)
    monkeypatch.setattr(dist, "barrier", calls)
    multihost.barrier()
    monkeypatch.setattr(dist, "get_backend", lambda *a: "gloo")
    multihost.barrier()
    assert calls.calls == [((), {"device_ids": [2]}), ((), {})]


def test_collectives_refuse_an_off_card_tensor_under_nccl(monkeypatch):
    """In a real gloo world of one the collectives take CPU tensors; under
    nccl (the backend read from the group) each raises on a tensor that is
    not on this rank's card, naming itself."""
    import bench_sharded_torch

    x = torch.arange(6.0).reshape(3, 2)
    with bench_sharded_torch.world_of_one(torch.device("cpu")) as mesh:
        assert torch.equal(sharding.all_reduce(x, mesh.world_group), x)
        assert torch.equal(sharding.all_gather(x, mesh.tile_group)[0], x)
        assert torch.equal(sharding.all_to_all(x, mesh.tile_group), x)
        with monkeypatch.context() as m:
            m.setattr(dist, "get_backend", lambda *a: "nccl")
            m.setattr(torch.cuda, "current_device", lambda: 1)
            for name, call in (
                    ("all_reduce", lambda: sharding.all_reduce(x, mesh.world_group)),
                    ("all_gather", lambda: sharding.all_gather(x, mesh.tile_group)),
                    ("all_to_all", lambda: sharding.all_to_all(x, mesh.tile_group))):
                with pytest.raises(RuntimeError) as e:
                    call()
                msg = str(e.value)
                assert msg.startswith(f"sharding.{name}: "), msg
                assert "cuda:1" in msg and "not on cpu" in msg
    assert not dist.is_initialized()


def test_smoke_rank_plan():
    """One card: gloo, card 0 for every rank (the rehearsal); a card per
    rank: nccl, card r for rank r."""
    assert chip_smoke.rank_plan(4, 1) == ("gloo", [0, 0, 0, 0])
    assert chip_smoke.rank_plan(4, 2) == ("gloo", [0, 0, 0, 0])
    assert chip_smoke.rank_plan(4, 4) == ("nccl", [0, 1, 2, 3])
    assert chip_smoke.rank_plan(4, 8) == ("nccl", [0, 1, 2, 3])


def test_all_to_all_on_four_gloo_ranks_is_the_reference_permutation(tmp_path):
    inp = worker.a2a_inputs(4)
    torch.save(inp, str(tmp_path / "a2a_in.pt"))
    outs = worker.launch("a2a", 4, str(tmp_path))
    want_out = worker.a2a_reference(list(inp["x"]))
    want_grad = worker.a2a_reference(list(inp["g"]))
    for r, o in enumerate(outs):
        assert o["device"] == "cpu"
        assert torch.equal(o["out"], want_out[r]) and torch.equal(o["grad"], want_grad[r])


def test_tool_raises_without_four_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="needs 4 cards"):
        mc.pick_device("cuda")
