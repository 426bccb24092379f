"""The port's dry run (``repro_torch.launch.dryrun``) and its roofline
counter (``launch/hlo_analysis.py``) against the reference's records.

* The counter on hand-sized ops in a (2, 4) fake world, against counts
  worked out by hand: a sharded product's local flops, a replicated one
  counted on every rank, a forced all-reduce's and all-gather's bytes, a
  gather's and an in-place update's bytes.
* Parity: all ten archs x {train, prefill, decode} at SMOKE width on
  (2, 4), and three full-width production cells, against the reference's
  records in ``tests/data/torch_port_dryrun_golden.json``
  (``tests/helpers/make_torch_port_dryrun_golden.py``): flops within 5%,
  memory bytes and each collective kind's bytes within a factor of 2, the
  argument bytes equal but for the differences ROADMAP §C records
  (``parity.argument_delta``). Every metric outside its limit is one
  of ``parity.EXCEPTIONS`` (ROADMAP §C), no exception is stale, and each
  equals the port's count recorded for this torch version
  (``parity.drift``).
* The depth extrapolation equals a trace at full depth; the count of the
  two-level recomputation adds what the reference's records add; the
  golden equals a live run of the reference; the intake reads the port's
  records as the reference's; a dry run launches no kernel and leaves no
  process group up.
"""

import json
import os
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist

from helpers import torch_dryrun_parity as parity
from repro_torch.configs import ARCHS, get_arch
from repro_torch.configs.base import ShapeCell
from repro_torch.core import characterize
from repro_torch.kernels import ops
from repro_torch.launch import dryrun, hlo_analysis
from repro_torch.launch import mesh as mesh_mod

GOLDEN = parity.load_golden()
HELPER = os.path.join(os.path.dirname(__file__), "helpers", "make_torch_port_dryrun_golden.py")
KINDS = ("train", "prefill", "decode")
# the production cells run here at full width (about 20 s together)
FULL_CELLS = [("mamba2-130m", "train_4k", "pod"), ("qwen1.5-110b", "train_4k", "pod"),
              ("qwen1.5-110b", "decode_32k", "pod")]


@pytest.fixture
def mesh24():
    with mesh_mod.dryrun_world(8):
        yield mesh_mod.make_dryrun_mesh((2, 4), ("data", "model"), "cpu")
    assert not dist.is_initialized()


def _dt(mesh, local_shape, places, shape, dtype=torch.float32):
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(torch.empty(local_shape, dtype=dtype, device="meta"), mesh,
                              places, run_check=False, shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta").stride())


# ---------------------------------------------------------------------------
# the counter, by hand
# ---------------------------------------------------------------------------


def test_counter_counts_a_sharded_product_at_its_local_shapes(mesh24):
    """x (16, 64) split over data by rows, w (64, 32) over model by
    columns: rank 0 multiplies (8, 64) by (64, 8), 2 * 8 * 64 * 8 flops,
    and nothing moves."""
    from torch.distributed.tensor import Replicate, Shard

    x = _dt(mesh24, (8, 64), [Shard(0), Replicate()], (16, 64))
    w = _dt(mesh24, (64, 8), [Replicate(), Shard(1)], (64, 32))
    with hlo_analysis.RooflineCounter() as c:
        y = x @ w
    assert tuple(y.to_local().shape) == (8, 8)
    assert c.counts.flops == 2 * 8 * 64 * 8
    assert c.counts.collective_bytes == 0 and dict(c.counts.collectives) == {}
    assert c.counts.memory_bytes == 4 * (8 * 64 + 64 * 8 + 8 * 8)


def test_counter_counts_a_replicated_product_on_every_rank(mesh24):
    """w whole on every rank: each rank multiplies its 8 rows by all 32
    columns, four times the split product's flops."""
    from torch.distributed.tensor import Replicate, Shard

    x = _dt(mesh24, (8, 64), [Shard(0), Replicate()], (16, 64))
    w = _dt(mesh24, (64, 32), [Replicate(), Replicate()], (64, 32))
    with hlo_analysis.RooflineCounter() as c:
        x @ w
    assert c.counts.flops == 2 * 8 * 64 * 32
    assert c.counts.collective_bytes == 0


def test_counter_counts_an_all_reduce_and_an_all_gather_by_their_results(mesh24):
    """A partial sum over model reduced to whole: one all-reduce of its
    (8, 32) f32 result; x split over model by columns gathered whole: one
    all-gather of its (8, 64) result."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    p = _dt(mesh24, (8, 32), [Shard(0), Partial()], (16, 32))
    x = _dt(mesh24, (8, 16), [Shard(0), Shard(1)], (16, 64))
    with hlo_analysis.RooflineCounter() as c:
        p.redistribute(mesh24, [Shard(0), Replicate()])
    assert dict(c.counts.collectives) == {"all-reduce": 8 * 32 * 4}
    with hlo_analysis.RooflineCounter() as c:
        x.redistribute(mesh24, [Shard(0), Replicate()])
    assert c.counts.collectives["all-gather"] == 8 * 64 * 4
    assert c.counts.collective_bytes == 8 * 64 * 4


def test_counter_counts_views_gathers_and_updates_as_the_reference(mesh24):
    """A slice is a view (0 bytes); a gather counts twice its result; an
    in-place write of a region twice the update; a fill its result once;
    an elementwise op its operands and result."""
    a = torch.empty((32, 16), device="meta")
    idx = torch.empty((5,), dtype=torch.int64, device="meta")
    upd = torch.empty((4, 16), device="meta")
    with hlo_analysis.RooflineCounter() as c:
        view = a[:4]
    assert c.counts.memory_bytes == 0
    with hlo_analysis.RooflineCounter() as c:
        a[idx]
    assert c.counts.memory_bytes == 2 * 5 * 16 * 4
    with hlo_analysis.RooflineCounter() as c:
        view.copy_(upd)
    assert c.counts.memory_bytes == 2 * 4 * 16 * 4
    with hlo_analysis.RooflineCounter() as c:
        torch.zeros((8, 8), device="meta")
    assert c.counts.memory_bytes == 8 * 8 * 4
    with hlo_analysis.RooflineCounter() as c:
        upd + upd
    assert c.counts.memory_bytes == 3 * 4 * 16 * 4 and c.counts.flops == 0


# ---------------------------------------------------------------------------
# parity with the reference's records
# ---------------------------------------------------------------------------


def check_record(key: str, rec: dict, ref: dict, arch_id: str, cfg):
    assert rec["ok"], rec.get("error")
    assert ref["ok"], key
    assert rec["n_devices"] == ref["n_devices"]
    assert rec["kernels"] == "plain" and rec["compile_s"] == 0.0
    got = rec["memory_analysis"]["argument_size_in_bytes"]
    want = ref["memory_analysis"]["argument_size_in_bytes"]
    assert got - want == parity.argument_delta(key, get_arch(arch_id), cfg), key
    outside = parity.gaps(rec, ref)
    listed = parity.EXCEPTIONS.get(key, {})
    assert sorted(outside) == sorted(listed), (
        f"{key}: outside the limits {sorted(outside)}, listed {sorted(listed)}: "
        + json.dumps({m: outside.get(m) for m in set(outside) ^ set(listed)}))
    # a listed metric is held to the port's recorded count, not to the limits
    assert not parity.drift(key, rec, ref, parity.torch_version()), parity.drift(
        key, rec, ref, parity.torch_version())


@pytest.mark.parametrize("arch_id,kind", [(a, k) for a in ARCHS for k in KINDS])
def test_smoke_cell_against_the_reference(arch_id, kind):
    arch = get_arch(arch_id)
    seq, batch = GOLDEN["smoke_cells"][kind]["seq"], GOLDEN["smoke_cells"][kind]["batch"]
    cell = ShapeCell(f"smoke_{kind}", seq, batch, kind)
    with mesh_mod.dryrun_world(8):
        mesh = mesh_mod.make_dryrun_mesh(tuple(GOLDEN["smoke_mesh"]["shape"]),
                                         tuple(GOLDEN["smoke_mesh"]["axes"]), "cpu")
        counts, memory, seconds = dryrun.count_cell(arch, arch.smoke, cell, mesh,
                                                    accum=dryrun.TRAIN_ACCUM.get(arch_id, 1))
    key = f"{arch_id}__smoke_{kind}__2x4"
    check_record(key, dryrun.record(counts, memory, seconds, 8), GOLDEN["smoke"][key],
                 arch_id, arch.smoke)


@pytest.fixture(scope="module")
def full_records(tmp_path_factory):
    """The port's records of ``FULL_CELLS`` (``run_cell`` at full width on
    the production meshes), with the kernel launches and the process
    group around them."""
    out = tmp_path_factory.mktemp("dryrun")
    ops.reset_launches()
    before = dict(ops.LAUNCHES)
    recs = {}
    for arch_id, shape, mesh in FULL_CELLS:
        recs[(arch_id, shape, mesh)] = dryrun.run_cell(arch_id, shape, mesh, str(out),
                                                       device="cpu")
        assert not dist.is_initialized()
    return out, recs, before, dict(ops.LAUNCHES)


@pytest.mark.parametrize("cell", FULL_CELLS, ids=["__".join(c) for c in FULL_CELLS])
def test_full_width_cell_against_the_reference(full_records, cell):
    _, recs, _, _ = full_records
    key = "__".join(cell)
    check_record(key, recs[cell], GOLDEN["full"][key], cell[0], get_arch(cell[0]).full)


def test_a_dry_run_launches_no_kernel_and_leaves_no_world(full_records):
    _, recs, before, after = full_records
    assert all(r["ok"] for r in recs.values())
    assert after == before and not any(after.values())
    assert not dist.is_initialized()


def test_the_intake_reads_the_port_records_as_the_reference(full_records, tmp_path):
    """``workloads_from_artifacts`` over the port's records and over the
    reference's for the same cells: the same (arch, shape) keys."""
    out, recs, _, _ = full_records
    for arch_id, shape, mesh in recs:
        rec = dict(GOLDEN["full"][f"{arch_id}__{shape}__{mesh}"], arch=arch_id, shape=shape,
                   mesh=mesh)
        with open(tmp_path / f"{arch_id}__{shape}__{mesh}.json", "w") as f:
            json.dump(rec, f)
    port = characterize.workloads_from_artifacts(str(out))
    ref = characterize.workloads_from_artifacts(str(tmp_path))
    assert sorted((w.arch, w.shape_name) for w in port) == sorted(
        (w.arch, w.shape_name) for w in ref) == sorted(
        (a, s) for a, s, m in FULL_CELLS if m == "pod")
    assert all(w.terms.source == "dryrun" for w in port)


@pytest.mark.parametrize("arch_id", ["qwen1.5-110b", "mamba2-130m"])
def test_the_depth_extrapolation_equals_a_trace_at_full_depth(arch_id):
    """A SMOKE config at four layer groups: the counts extrapolated from
    two shallower traces equal a trace at full depth, field for field. The
    traces run in one process, so this also holds a trace's counts free
    of what ran before it (``hlo_analysis._is_step_op``: mamba2-130m's
    first trace in a process counted a decomposition DTensor runs once)."""
    import dataclasses

    arch = get_arch(arch_id)
    cfg = dataclasses.replace(arch.smoke, n_layers=4 * len(arch.smoke.pattern))
    cell = ShapeCell("t", 16, 8, "train")
    with mesh_mod.dryrun_world(8):
        mesh = mesh_mod.make_dryrun_mesh((2, 4), ("data", "model"), "cpu")
        got, got_mem, _ = dryrun.count_cell(arch, cfg, cell, mesh, accum=2)
        want, want_mem, _ = dryrun.trace_cell(arch, cfg, cell, mesh, accum=2)
    assert dryrun.n_groups(cfg) == 4 and not dryrun.nested(cfg)
    for field in ("flops", "memory_bytes", "collective_bytes", "transcendentals"):
        assert getattr(got, field) == getattr(want, field), field
    assert dict(got.collectives) == dict(want.collectives)
    for k in ("argument_size_in_bytes", "output_size_in_bytes", "alias_size_in_bytes"):
        assert got_mem[k] == want_mem[k], k


@pytest.mark.parametrize("arch_id", ["granite-20b"])
def test_the_nested_term_is_the_references(arch_id):
    """The dry run's count of the two-level recomputation against the
    reference's own: the SMOKE train cell at four groups, with
    ``scan_nest`` 2 less with 1, adds exactly the same flops in the port's
    count (G group forwards a microbatch, ``count_cell``) as in the
    reference's records (the golden's ``nested`` section)."""
    import dataclasses

    arch = get_arch(arch_id)
    seq, batch = GOLDEN["smoke_cells"]["train"]["seq"], GOLDEN["smoke_cells"]["train"]["batch"]
    cell = ShapeCell("smoke_train", seq, batch, "train")
    flops = {}
    with mesh_mod.dryrun_world(8):
        mesh = mesh_mod.make_dryrun_mesh((2, 4), ("data", "model"), "cpu")
        for k in (1, 2):
            cfg = dataclasses.replace(arch.smoke, n_layers=4 * len(arch.smoke.pattern),
                                      scan_nest=k)
            assert dryrun.nested(cfg) == (k == 2)
            flops[k] = dryrun.count_cell(arch, cfg, cell, mesh,
                                         accum=dryrun.TRAIN_ACCUM[arch_id])[0].flops
    ref = {k: GOLDEN["nested"][f"{arch_id}__smoke_train_g4_nest{k}__2x4"]["hlo"][
        "flops_per_device"] for k in (1, 2)}
    assert flops[2] - flops[1] == ref[2] - ref[1] > 0


def test_the_golden_equals_a_live_reference_run():
    """The reference's SMOKE gemma3-12b train cell on 8 host devices, live
    in a subprocess (the golden's helper), equals the golden's record."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    r = subprocess.run([sys.executable, HELPER, "--smoke-cell", "gemma3-12b", "train"],
                       env=env, capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stderr[-2000:]
    live = json.loads(r.stdout.strip().splitlines()[-1])
    kept = GOLDEN["smoke"]["gemma3-12b__smoke_train__2x4"]
    for k in ("ok", "n_devices", "memory_analysis", "cost_analysis", "hlo"):
        assert live[k] == kept[k], k


def test_all_cells_are_the_reference_sweep():
    cells = list(dryrun.all_cells())
    assert len(cells) == 66 == len(GOLDEN["full"])
    assert {"__".join(c) for c in cells} == set(GOLDEN["full"])


def tp_prefill_flops(arch, cfg, mesh_shape, batch: int, seq: int, split_kv=None) -> int:
    """The products of a tensor-parallel prefill of a dense attention LM
    (gated or plain MLP) on a (data, model) mesh, rank 0's, counted from
    the config alone: q and o split by heads; k and v split where the
    rules split them (the full config's KV heads divide the model axis;
    ``split_kv`` overrides), else whole on every rank; the MLP split;
    attention over the whole sequence (masked blocks included) for the
    rank's query heads; the last position's logits over the rank's share
    of the vocab."""
    data, model = mesh_shape
    a = cfg.attn
    t = batch // data * seq
    q = a.n_heads * a.d_head // model
    kv = a.n_kv_heads * a.d_head
    if split_kv is None:
        split_kv = arch.full.attn.n_kv_heads % model == 0
    kv_local = kv // model if split_kv else kv
    ff = cfg.d_ff // model * (3 if cfg.mlp_gated else 2)
    heads = max(a.n_heads // model, 1)
    layer = (2 * t * cfg.d_model * (q + 2 * kv_local) + 2 * t * q * cfg.d_model
             + 2 * t * cfg.d_model * ff + 4 * (batch // data) * heads * seq * seq * a.d_head)
    vocab = cfg.vocab // model if cfg.vocab % model == 0 else cfg.vocab
    return cfg.n_layers * layer + 2 * (batch // data) * cfg.d_model * vocab


def test_prefill_flops_equal_the_tensor_parallel_count():
    """The counter leaves no product out: qwen1.5-110b's SMOKE prefill on
    (2, 4) counts exactly the tensor-parallel step's products, worked out
    from the config (``tp_prefill_flops``). At full width (prefill_32k on
    (16, 16)) the formula gives the dry run's 1,407,375,194,980,352, and
    with the 8 KV heads' projections split 16 ways where the rules keep
    them whole, the reference's 1,242,448,450,813,952 exactly: XLA splits
    that work over the model axis (ROADMAP §C, prefill-partition)."""
    arch = get_arch("qwen1.5-110b")
    cell = ShapeCell("p", 64, 8, "prefill")
    with mesh_mod.dryrun_world(8):
        mesh = mesh_mod.make_dryrun_mesh((2, 4), ("data", "model"), "cpu")
        counts = dryrun.count_cell(arch, arch.smoke, cell, mesh)[0]
    assert counts.flops == tp_prefill_flops(arch, arch.smoke, (2, 4), 8, 64)
    full = (arch, arch.full, (16, 16), 32, 32768)
    assert tp_prefill_flops(*full) == 1_407_375_194_980_352
    assert tp_prefill_flops(*full, split_kv=True) == GOLDEN["full"][
        "qwen1.5-110b__prefill_32k__pod"]["hlo"]["flops_per_device"]
