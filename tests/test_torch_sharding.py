"""The port's partition rules (``parallel/sharding.py``) against the JAX
package's, at full width, for every arch on the production meshes (16, 16)
and (2, 16, 16) and the host's (2, 4), (4, 2) and (8, 1).

The reference's side runs on ``FakeMesh`` over ``jax.eval_shape`` trees,
the port's on ``MeshShape`` over meta-device models
(``chip_smoke.sharding_table``, which phase 10a holds the card to). The
reference's specs come in the port's form
(``tests/helpers/make_torch_port_sharding_golden.py``: a layer's spec is the
stacked leaf's without its group axis). The structural properties of
``tests/test_sharding_rules.py`` are restated for the port's specs.
"""

import functools
import importlib.util
import json
import os
import re

import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro.configs import ARCHS as J_ARCHS
from repro_torch.configs import ARCHS, get_arch
from repro_torch.configs.base import SHAPES
from repro_torch.launch import steps
from repro_torch.parallel import sharding as shd
from helpers import make_torch_port_sharding_golden as golden_mod

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
MESHES = golden_mod.MESHES
POD = shd.MeshShape((16, 16), ("data", "model"))
MULTIPOD = shd.MeshShape((2, 16, 16), ("pod", "data", "model"))


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMOKE = _smoke()
reference_specs = functools.lru_cache(maxsize=None)(golden_mod.reference_specs)


@functools.lru_cache(maxsize=None)
def _abstract(arch_id):
    arch = get_arch(arch_id)
    return steps.abstract_train_state(arch, arch.full)


def test_archs_are_the_references():
    assert sorted(ARCHS) == sorted(J_ARCHS)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch_id", sorted(J_ARCHS))
def test_rules_match_the_reference(arch_id, mesh_name):
    """tp_mode; the param, FSDP, opt-state, batch, cache and activation
    specs; param bytes a device (plain and FSDP); equal, leaf for leaf."""
    want = reference_specs(arch_id, mesh_name)
    got = SMOKE.sharding_table(torch, arch_id, *MESHES[mesh_name], want, _abstract(arch_id))
    for key in want:
        if key != "moment_bytes":
            assert got[key] == want[key], key


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch_id", sorted(J_ARCHS))
def test_moment_bytes_a_device_match_the_reference(arch_id, mesh_name):
    """ZeRO-1's optimizer-moment bytes a device, counted in both packages:
    equal, except where ROADMAP §C records the difference
    (``chip_smoke.SHARDING_MOMENT_EXTRA``)."""
    want = reference_specs(arch_id, mesh_name)
    got = SMOKE.sharding_table(torch, arch_id, *MESHES[mesh_name], want, _abstract(arch_id))
    extra = SMOKE.SHARDING_MOMENT_EXTRA.get((arch_id, mesh_name), 0)
    assert got["moment_bytes"] - want["moment_bytes"] == extra
    assert extra < 1e-4 * want["moment_bytes"]


def test_golden_is_the_live_reference():
    with open(SMOKE.SHARDING_GOLDEN) as f:
        assert json.load(f) == json.loads(json.dumps(golden_mod.build()))


# ---------------------------------------------------------------------------
# the structural properties of tests/test_sharding_rules.py, for the port
# ---------------------------------------------------------------------------


def _check_specs(tree, specs, mesh, what):
    for name, leaf in tree.items():
        spec = specs[name]
        assert len(spec) <= len(leaf.shape), (what, name, spec, leaf.shape)
        for dim, entry in enumerate(spec):
            n = shd.axis_len(mesh, entry)
            assert leaf.shape[dim] % n == 0, (what, name, dim, entry)
        shd.placements(spec, mesh)  # one mesh axis a dim, in mesh order


@pytest.mark.parametrize("mesh", [POD, MULTIPOD], ids=["pod", "multipod"])
@pytest.mark.parametrize("arch_id", sorted(ARCHS))
def test_param_and_opt_specs_valid(arch_id, mesh):
    arch = get_arch(arch_id)
    params, opt = steps.abstract_train_state(arch, arch.full)
    specs = shd.param_specs(params, arch, mesh)
    _check_specs(params, specs, mesh, f"{arch_id} params")
    ospecs = shd.opt_state_specs(opt, specs, mesh, arch)
    _check_specs(opt["m"], ospecs["m"], mesh, f"{arch_id} opt.m")
    _check_specs(opt["v"], ospecs["v"], mesh, f"{arch_id} opt.v")


@pytest.mark.parametrize("arch_id", sorted(ARCHS))
def test_cache_specs_valid(arch_id):
    arch = get_arch(arch_id)
    for cell in SHAPES.values():
        if cell.kind != "decode" or (cell.name == "long_500k" and not arch.long_500k_ok):
            continue
        caches = arch.init_caches(arch.full, cell.batch, cell.seq, device="meta")
        flat_l, flat_s = {}, {}
        shd.map_tree(lambda p, leaf: flat_l.__setitem__(p, leaf), caches)
        shd.map_tree(lambda p, s: flat_s.__setitem__(p, s),
                     shd.cache_specs(caches, arch, cell, POD))
        _check_specs({p: t for p, t in flat_l.items() if isinstance(t, torch.Tensor)},
                     flat_s, POD, f"{arch_id}/{cell.name} caches")


_QKV = re.compile(r"(attn|self|cross)\.([qkv])\.[wb]$")


@pytest.mark.parametrize("arch_id", sorted(ARCHS))
def test_no_full_width_spec_cuts_a_head(arch_id):
    """At full width the rules split a q, k or v projection's output, and
    so the activation ``attention._split_heads`` reshapes, into whole
    heads only, on every mesh of the golden, with FSDP's data axis
    gathered per layer: ``attention._whole_heads`` never gathers there."""
    from repro_torch.models import attention

    arch = get_arch(arch_id)
    params, _ = _abstract(arch_id)
    heads = {"q": shd.cfg_heads, "k": shd.cfg_kv_heads, "v": shd.cfg_kv_heads}
    seen = 0
    for shape, names in MESHES.values():
        mesh = shd.MeshShape(tuple(shape), tuple(names))
        data = names.index("data")
        for fsdp in (False, True):
            for name, spec in shd.param_specs(params, arch, mesh, fsdp=fsdp).items():
                m = _QKV.search(name)
                if m is None:
                    continue
                places = list(shd.placements(spec, mesh))
                if fsdp:
                    places[data] = Replicate()  # constrain_group_params
                out_dim = params[name].ndim - 1
                assert not attention.cuts_heads(heads[m.group(2)](arch), places, mesh,
                                                out_dim), (name, names, spec)
                seen += 1
    assert seen > 0 or arch_id == "mamba2-130m"


def test_tp_mode_assignments():
    assert shd.tp_mode(ARCHS["qwen1.5-110b"], POD) == "head"
    assert shd.tp_mode(ARCHS["starcoder2-3b"], POD) == "seq"  # 24H % 16 != 0
    assert shd.tp_mode(ARCHS["mamba2-130m"], POD) == "replicate"
    assert shd.tp_mode(ARCHS["whisper-medium"], POD) == "head"


def test_zero1_shards_large_replicated_moments():
    out = shd.zero1_spec(shd.Spec(), (8192, 1024), POD, group=80)
    assert out == shd.Spec("data", None)
    # small tensors stay replicated, whatever their stack
    assert shd.zero1_spec(shd.Spec(), (16, 64), POD) == shd.Spec()
    assert shd.zero1_spec(shd.Spec(), (16, 64), POD, group=80) == shd.Spec()


def test_placements_order_the_pod_axis_first():
    assert shd.placements(shd.Spec(("pod", "data"), None, "model"), MULTIPOD) == (
        Shard(0), Shard(0), Shard(2))
    assert shd.placements(shd.Spec(), POD) == (Replicate(), Replicate())
    with pytest.raises(ValueError, match="order"):
        shd.placements(shd.Spec(("data", "pod")), MULTIPOD)
    with pytest.raises(ValueError, match="two dims"):
        shd.placements(shd.Spec("data", "data"), POD)


def test_bytes_per_device_counts_the_shards():
    tree = {"a": torch.empty((32, 64), device="meta"), "b": [torch.empty((8,), device="meta")]}
    specs = {"a": shd.Spec("data", "model"), "b": [shd.Spec()]}
    assert shd.bytes_per_device(tree, specs, POD) == 32 * 64 * 4 // 256 + 8 * 4
    assert np.isclose(shd.shard_factor(shd.Spec(("pod", "data")), MULTIPOD), 32)


def test_fsdp_policy_only_where_fsdp_shards():
    """qwen1.5-110b's weights outgrow FSDP_MIN_BYTES on the pod: the
    per-layer gather is installed; without a data axis to shard over,
    nothing is."""
    import contextlib

    qwen = get_arch("qwen1.5-110b")
    params, _ = steps.abstract_train_state(qwen, qwen.full)
    assert not isinstance(steps.fsdp_policy(qwen, qwen.full, POD, params),
                          contextlib.nullcontext)
    model_only = shd.MeshShape((1, 16), ("data", "model"))
    assert isinstance(steps.fsdp_policy(qwen, qwen.full, model_only, params),
                      contextlib.nullcontext)


def test_train_shardings_and_the_activation_policy():
    """``train_shardings`` names the rules' specs on the mesh; the 'seq'
    policy (starcoder2-3b's 24 heads on the pod) is set inside
    ``activation_policy`` and gone after it."""
    from repro_torch.parallel import context as pctx

    arch = get_arch("starcoder2-3b")
    cell = SHAPES["train_4k"]
    params, opt = steps.abstract_train_state(arch, arch.full)
    batch = {k: torch.empty((cell.batch, cell.seq), device="meta") for k in ("tokens", "labels")}
    psh, osh, bsh = steps.train_shardings(arch, arch.full, POD, cell, params, opt, batch)
    assert {k: v.spec for k, v in psh.items()} == shd.param_specs(params, arch, POD)
    assert osh["step"].spec == shd.Spec() and osh["m"].keys() == params.keys()
    assert bsh["tokens"].placements == (Shard(0), Replicate())
    assert pctx.constrain(torch.ones(2, 3, 4)).shape == (2, 3, 4)  # no policy, no DTensor
    with steps.activation_policy(arch, cell, POD):
        sharding = pctx._LOCAL.sharding
        assert sharding.spec == shd.Spec(("data",), "model", None)
        assert sharding.placements == (Shard(0), Shard(1))
    assert pctx._LOCAL.sharding is None
