"""The elastic controller (``runtime/elastic.py``), ``restore_latest``, the
'seq' activation policy and ``launch.train --compress --mesh DxM`` on gloo
ranks.

* ``mesh_shape_for`` and ``ElasticEvent`` as in ``tests/test_elastic.py``.
* ``_choose_chips`` on pools of 8, 64, 128 and 10,000 equals the reference
  controller's, on the reference engine's own fit carried into the port
  (``convert.svr_params_from_reference`` / ``install_fit``), in the TPU
  space and in the CPU space.
* ``CheckpointManager.restore_latest`` round-trips, bf16 included, as
  ``tests/test_substrate.py`` holds the reference's.
* On gloo ranks (``tests/helpers/torch_gloo.py``, a timeout a world):
  gemma3-12b's SMOKE weights re-meshed from (3, 1) onto (1, 3), where the
  full config's 16 heads do not divide the model axis: the 'seq' mode,
  with the hidden states split over the sequence, against the reference's
  single-device loss; ``constrain`` under that policy; the host rehearsal
  of ``chip_smoke.py`` phase 10b; and ``--mesh 2x2`` against the 2-rank
  data-parallel run.
"""

import dataclasses
import os
import types

import numpy as np
import pytest
import torch

from helpers import torch_gloo
from repro.configs.base import SHAPES as J_SHAPES
from repro.core import engine as jeng
from repro.runtime import elastic as r_elastic
from repro_torch import convert
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_arch
from repro_torch.configs.base import SHAPES as T_SHAPES
from repro_torch.core import engine as teng
from repro_torch.core.planner import EnergyOptimalPlanner
from repro_torch.runtime import elastic as t_elastic
from repro_torch.runtime.elastic import ElasticController, ElasticEvent, mesh_shape_for
from test_torch_distributed import LOSS_REL, SPAWN_TIMEOUT_S, stage

ARCH_ID = "elastic-test-arch"


def test_mesh_shape_policy():
    assert mesh_shape_for(256) == (16, 16)
    assert mesh_shape_for(512) == (32, 16)
    assert mesh_shape_for(64) == (4, 16)
    assert mesh_shape_for(16) == (1, 16)
    assert mesh_shape_for(8) == (1, 8)
    assert mesh_shape_for(24) == (3, 8)
    assert mesh_shape_for(8, prefer_model=1) == (8, 1)


def test_event_record():
    e = ElasticEvent(available_chips=128, reason="preemption")
    assert e.available_chips == 128
    assert e.time > 0


def _controller(mod, shapes, planner):
    return mod.ElasticController(types.SimpleNamespace(arch_id=ARCH_ID), None,
                                 shapes["train_4k"], None, None, planner=planner)


@pytest.mark.parametrize("pool", [8, 64, 128, 10_000])
@pytest.mark.parametrize("space", ["tpu", "cpu"])
def test_choose_chips_matches_the_reference(fleet_pm, tmp_path, space, pool):
    """The port's controller plans the reference's slice on the
    reference's fit (the SVR fit itself is the engine tests' business)."""
    spaces = {"tpu": (None, None), "cpu": (jeng.cpu_space(), teng.cpu_space())}[space]
    ref = jeng.PlanningEngine(fleet_pm, space=spaces[0], noise=0.01, seed=0,
                              dryrun_dir=str(tmp_path))
    want = _controller(r_elastic, J_SHAPES, ref)._choose_chips(pool)
    port = teng.PlanningEngine(convert.power_model_from_reference(fleet_pm.coeffs()),
                               space=spaces[1], noise=0.01, seed=0,
                               dryrun_dir=str(tmp_path), device="cpu")
    ctl = _controller(t_elastic, T_SHAPES, port)
    (key_ref, fit), = ref._fits.items()
    fields = {k: (np.asarray(v) if not isinstance(v, (float, bool)) else v)
              for k, v in dataclasses.asdict(fit.model).items()}
    key = teng.Workload(ARCH_ID, T_SHAPES["train_4k"]).key
    port.install_fit(key, convert.svr_params_from_reference(fields, device="cpu"), fit.pae,
                     teng.terms_analytic(ARCH_ID, T_SHAPES["train_4k"]))
    assert ctl._choose_chips(pool) == want <= pool
    assert len(port._fits) == 1  # planned on the carried fit, no fit of its own


def test_choose_chips_accepts_the_planner_shim(fleet_pm, tmp_path):
    shim = EnergyOptimalPlanner(convert.power_model_from_reference(fleet_pm.coeffs()),
                                dryrun_dir=str(tmp_path), device="cpu")
    ctl = _controller(t_elastic, T_SHAPES, shim)
    assert ctl._choose_chips(128) <= 128


def test_choose_chips_without_planner():
    ctl = ElasticController(types.SimpleNamespace(arch_id="x"), None, None, None, None)
    assert ctl._choose_chips(96) == 96


def test_restore_latest_round_trips_bf16(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = {"a": torch.arange(6).reshape(2, 3), "b": {"c": torch.ones(4, dtype=torch.bfloat16)}}
    assert mgr.restore_latest(tree) == (None, None)
    mgr.save(3, tree, {"pipeline": {"step": 3}})
    template = {"a": torch.empty((2, 3), dtype=torch.int64, device="meta"),
                "b": {"c": torch.empty(4, dtype=torch.bfloat16, device="meta")}}
    step, restored = mgr.restore_latest(template)
    assert step == 3
    assert torch.equal(restored["a"], tree["a"]) and restored["a"].device.type == "cpu"
    assert restored["b"]["c"].dtype == torch.bfloat16
    assert torch.equal(restored["b"]["c"], tree["b"]["c"])
    for s in (4, 5):
        mgr.save(s, tree)
    assert mgr.steps() == [4, 5] and mgr.restore_latest(template)[0] == 5


@pytest.fixture(scope="module")
def seq_world(tmp_path_factory):
    """Three gloo ranks: gemma3-12b's SMOKE weights checkpointed on (3, 1)
    and resharded onto (1, 3), then ``constrain`` on (1, 3); with the
    reference's loss on the batch of sequence 48."""
    work = tmp_path_factory.mktemp("seq")
    want = stage(work, "gemma3-12b", [48])[48]
    outs = torch_gloo.spawn(3, work, [("remesh", (["gemma3-12b"], (3, 1), [(1, 3)], 48)),
                                      ("constrain_seq", ((1, 3), 48))], timeout=SPAWN_TIMEOUT_S)
    assert all(out == outs[0] for out in outs)
    return want, outs


def test_remesh_onto_a_seq_mesh_matches_the_single_device_loss(seq_world):
    """(1, 3): 'seq' -- attention weights replicated, hidden states split
    over the sequence at every group's end, each rank's queries against the
    whole sequence's keys."""
    want, outs = seq_world
    (got,) = outs[0][0]["gemma3-12b"]
    assert got["tp_mode"] == "seq" and got["same"] and got["step"] == 5
    assert got["loss"] == pytest.approx(want, rel=LOSS_REL), (got, want)


def test_constrain_under_the_seq_policy_moves_placements_not_values(seq_world):
    """And the FSDP gather of one layer (``constrain_group_params``)."""
    out = seq_world[1][0][1]
    assert out["before"] == ["Replicate()", "Replicate()"]
    assert out["after"] == ["Replicate()", "Shard(dim=1)"]
    assert out["same"] and out["outside"]
    assert out["odd_after"] == ["Replicate()", "Replicate()"]  # 47 does not split 3 ways
    assert out["gathered"] == ["Replicate()", "Shard(dim=1)"] and out["gathered_same"]
    assert out["kept"] == ["Shard(dim=0)", "Shard(dim=1)"] and out["no_policy"]


def _argv(tmp_path, *extra):
    return ["--arch", "mamba2-130m", "--smoke", "--device", "cpu", "--steps", "3",
            "--batch", "4", "--seq", "32", "--compress", "--ckpt-dir", str(tmp_path / "ckpt"),
            *extra]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Two gloo ranks: phase 10b's run at SMOKE width, then the 2-rank
    data-parallel ``launch.train`` run."""
    work = tmp_path_factory.mktemp("two")
    outs = torch_gloo.spawn(2, work, [("elastic", ()), ("train", (_argv(work),))],
                            timeout=SPAWN_TIMEOUT_S)
    return outs


def test_elastic_resume_meets_the_uninterrupted_run(two_ranks):
    """Phase 10b rehearsed on 2 gloo ranks: the controller plans on the
    engine for a pool of 2 (below the TPU grid's floor, so the slice is
    the pool) and builds that slice, the world; the losses after the
    re-mesh are the uninterrupted run's, bit for bit."""
    for out, _ in two_ranks:
        assert out["losses"] == out["uninterrupted"] and len(out["losses"]) == 4
        assert out["mesh"] == "data=2xmodel=1" and out["plan"].startswith("mamba2-130m/train:")
        assert out["losses"] == two_ranks[0][0]["losses"]
        assert out["ckpt_steps"] == ["step_00000002"]


def test_controller_builds_no_mesh_but_the_world():
    """A slice other than the world raises: a mesh spans every rank."""
    from repro_torch.launch import mesh as mesh_mod

    ctl = ElasticController(get_arch("mamba2-130m"), None, None, None, None, device="cpu")
    world = mesh_mod.init_world(torch.device("cpu"))
    with pytest.raises(ValueError, match=f"the world has {world}"):
        ctl.build(world + 1)
    assert mesh_mod.describe(ctl.build(world)) == f"data={world}xmodel=1"


def test_train_mesh_2x2_gives_every_rank_the_2_rank_losses(two_ranks, tmp_path):
    """--mesh 2x2: the batch and the reduction split over the 2 data ranks;
    the 2 model ranks of a data index take the same step."""
    want = two_ranks[0][1]
    assert two_ranks[1][1] == want and want["step"] == 3
    outs = torch_gloo.spawn(4, tmp_path, [("train", (_argv(tmp_path, "--mesh", "2x2"),))],
                            timeout=SPAWN_TIMEOUT_S)
    for (out,) in outs:
        assert out == want
