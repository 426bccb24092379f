"""The elastic re-mesh on 8 gloo ranks, the reference's distributed check 3
(``tests/helpers/distributed_checks.py``: 2x4 -> 4x2 -> 8x1), which cannot
run live on this host's JAX.

gemma3-12b and mamba2-130m at SMOKE width, on weights drawn from a seed
(``convert.seeded_reference_params``) and carried into the port: placed
on a (2, 4) mesh by the partition rules and checkpointed there (every
rank gathers, rank 0 writes), then restored (``restore_latest``) and
resharded onto (4, 2) ('head': attention or Mamba2 heads, and the
vocabulary where it divides, split over the model axis) and, gemma3-12b,
(8, 1) ('replicate'). Every leaf comes back bit
for bit, and the loss under each mesh equals the reference's
single-device ``loss_fn`` on the same weights and batch within
``LOSS_REL``. The 'seq' mode, which no mesh of at most 8 ranks with a
power-of-two model axis reaches, runs on (1, 3) in
``tests/test_torch_elastic.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from helpers import torch_gloo
from repro.configs import get_arch as j_get_arch
from repro_torch import convert
from repro_torch.configs import get_arch

# gemma3-12b: vocabulary, attention heads and MLP split over the model
# axis; mamba2-130m (on (4, 2) alone): the Mamba2 block's heads, its SSD
# scan local to them
ARCHS = ("gemma3-12b", "mamba2-130m")
SEED = 5
# the sharded loss against the reference's on one device, relative: f32
# sums in other orders (gloo's reductions of partial sums; the port's
# plain attention against XLA's), measured at 1.5e-7 on this host
LOSS_REL = 1e-5
SPAWN_TIMEOUT_S = 240


def _flat_shapes(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat_shapes(tree[k], f"{prefix}.{k}" if prefix else str(k)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, t in enumerate(tree):
            out.update(_flat_shapes(t, f"{prefix}.{i}"))
        return out
    return {prefix: list(tree.shape)}


def stage(workdir, arch_id: str, seqs, batch: int = 8, seed: int = SEED) -> dict:
    """Write the port's weights (``weights_<arch>.npz``) and a batch per
    sequence length (``b<seq>_<arch>.npz``) into ``workdir``; the
    reference's loss on each."""
    arch = j_get_arch(arch_id)
    cfg = arch.smoke
    shapes = _flat_shapes(jax.eval_shape(lambda: arch.init(jax.random.PRNGKey(0), cfg)))
    params = convert.seeded_reference_params(shapes, seed)
    model = convert.params_from_reference(params, get_arch(arch_id).smoke, device="cpu")
    np.savez(workdir / f"weights_{arch_id}.npz",
             **{k: v.numpy() for k, v in model.state_dict().items()})
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    rng = np.random.default_rng(seed)
    losses = {}
    for seq in seqs:
        b = {"tokens": rng.integers(0, cfg.vocab, (batch, seq)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (batch, seq)).astype(np.int32)}
        np.savez(workdir / f"b{seq}_{arch_id}.npz", **b)
        losses[seq] = float(jax.jit(lambda p, x: arch.loss_fn(cfg, p, x)[0])(
            jparams, {k: jnp.asarray(v) for k, v in b.items()}))
    return losses


def test_remesh_2x4_to_4x2_to_8x1_matches_the_single_device_loss(tmp_path):
    want = {arch_id: stage(tmp_path, arch_id, [32])[32] for arch_id in ARCHS}
    outs = torch_gloo.spawn(8, tmp_path, [
        ("remesh", (["gemma3-12b"], (2, 4), [(4, 2), (8, 1)], 32)),
        ("remesh", (["mamba2-130m"], (2, 4), [(4, 2)], 32))], timeout=SPAWN_TIMEOUT_S)
    assert all(out == outs[0] for out in outs)  # every rank saw the same
    for arch_id, got in (*outs[0][0].items(), *outs[0][1].items()):
        assert [m["shape"] for m in got] == [[4, 2], [8, 1]][:len(got)]
        assert [m["tp_mode"] for m in got] == ["head", "replicate"][:len(got)]
        assert got[0]["sharded_leaves"] > 0  # (4, 2) splits leaves
        assert all(m["sharded_leaves"] == 0 for m in got[1:])  # (8, 1) replicates them
        for m in got:
            assert m["step"] == 5 and m["same"], (arch_id, m)
            assert m["loss"] == pytest.approx(want[arch_id], rel=LOSS_REL), (arch_id, m)
        # the checkpoint holds whole tensors: rank 0 wrote one step
        assert [p.name for p in (tmp_path / "ckpt" / arch_id).iterdir()] == ["step_00000005"]


def test_shutdown_leaves_no_process_of_the_world(tmp_path):
    """``chip_smoke.py`` must stop every process it starts. Phase 10c's
    world leaves the fork server its ranks were forked from and the
    resource tracker running until ``torch_gloo.shutdown()`` stops them;
    the smoke's last check (``_children``) then finds neither."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(__file__), "..", "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    def helpers_running():
        return [c for c in smoke._children()
                if "multiprocessing.forkserver" in c or "multiprocessing.resource_tracker" in c]

    outs = torch_gloo.spawn(2, tmp_path, [("constrain_seq", ((2, 1), 8))],
                            timeout=SPAWN_TIMEOUT_S)
    assert all(out[0]["same"] for out in outs)
    assert any("multiprocessing.forkserver" in c for c in helpers_running())
    torch_gloo.shutdown()
    assert helpers_running() == []
    torch_gloo.shutdown()  # nothing left to stop


# the tensor-parallel step on a (2, 2) mesh against the same port on one
# process: each arch takes a path of its own through the products run on
# each rank's shards (parallel/context.py): gemma3-12b the vocab-parallel
# embedding and cross-entropy and head-split caches; granite-20b replicated
# K/V and caches split over the sequence (a decode step merged by
# log-sum-exp); granite-moe-1b-a400m the experts' dispatch and combine;
# starcoder2-3b a row-parallel product over heads gathered whole (3 heads,
# 2 ranks); mamba2-130m the SSD scan on its heads
TP_ARCHS = ("gemma3-12b", "granite-20b", "granite-moe-1b-a400m", "starcoder2-3b",
            "mamba2-130m")
# f32 sums in other orders: gloo's reductions of partial sums
TP_REL = 1e-5


def _stage_port(workdir, arch_id: str, seq: int, batch: int = 8, seed: int = SEED) -> None:
    """The port's SMOKE weights drawn from ``seed`` and a batch of
    sequence ``seq``, written as ``stage`` writes them (no reference
    needed: both sides of the comparison are the port)."""
    import torch

    cfg = get_arch(arch_id).smoke
    model = get_arch(arch_id).init(torch.Generator().manual_seed(seed), cfg, device="cpu")
    np.savez(workdir / f"weights_{arch_id}.npz",
             **{k: v.float().numpy() for k, v in model.state_dict().items()})
    rng = np.random.default_rng(seed)
    np.savez(workdir / f"b{seq}_{arch_id}.npz",
             tokens=rng.integers(0, cfg.vocab, (batch, seq)).astype(np.int32),
             labels=rng.integers(0, cfg.vocab, (batch, seq)).astype(np.int32))


def _plain_step(arch_id, workdir, seq, extra):
    import torch

    from repro_torch.launch import steps

    arch = get_arch(arch_id)
    cfg = arch.smoke
    model = torch_gloo._model(arch, cfg, str(workdir))
    batch = torch_gloo._batch(str(workdir), arch_id, seq)
    steps.trainable(model)
    loss, _, grads = steps.loss_and_grads(arch, cfg, model, batch)
    model.requires_grad_(False)
    with torch.no_grad():
        caches, _ = arch.prefill(cfg, model, {"tokens": batch["tokens"]},
                                 max_cache_len=seq + extra)
        token = torch.full((batch["tokens"].shape[0], 1), 3, dtype=torch.long)
        _, logits = arch.decode_step(cfg, model, caches, token)
    return (float(loss), {k: g.numpy() for k, g in grads.items()}, logits.numpy(),
            steps.greedy(logits)[:, 0].tolist())


def test_tensor_parallel_step_matches_one_process(tmp_path):
    for arch_id in TP_ARCHS:
        _stage_port(tmp_path, arch_id, 16)
    outs = torch_gloo.spawn(4, tmp_path, [("tp_step", (a, (2, 2), 16, 4)) for a in TP_ARCHS],
                            timeout=SPAWN_TIMEOUT_S)
    assert all(out == outs[0] for out in outs)
    for arch_id, got in zip(TP_ARCHS, outs[0]):
        loss, grads, logits, tokens = _plain_step(arch_id, tmp_path, 16, 4)
        assert got["loss"] == pytest.approx(loss, rel=TP_REL), arch_id
        assert got["tokens"] == tokens, arch_id  # the vocab-split greedy pick
        with np.load(tmp_path / f"tp_{arch_id}.npz") as z:
            for k, g in grads.items():
                scale = max(float(np.abs(g).max()), 1e-30)
                assert np.abs(z[f"grad.{k}"] - g).max() <= TP_REL * scale, (arch_id, k)
            scale = float(np.abs(logits).max())
            assert np.abs(z["logits"] - logits).max() <= TP_REL * scale, arch_id
    # granite-20b's one KV head leaves its caches split over the sequence
    assert any("Shard(dim=2)" in p for p in outs[0][1]["cache_placements"])
