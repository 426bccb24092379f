"""Port parity, the rest of the model zoo: zamba2's shared attention,
phi-3-vision's image path and whisper's encoder-decoder against the JAX
package, on the CPU.

The reference's weights are carried across (``convert``) and both packages
run the same inputs, made from a numpy seed. Float32 SMOKE widths: logits
within 2e-5 (the tolerance of ``test_torch_zoo.py``), greedy tokens equal;
the loss within 1e-6 relative and every gradient within 1e-5 of its scale,
both packages summing in different orders. whisper's sinusoid differs from
XLA's by at most one float32 ulp of 1 (its sin and cos), inside those
tolerances.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as r_configs
from repro.models import encdec as r_encdec
from repro_torch import configs, convert
from repro_torch.launch import serve, steps, train
from repro_torch.models import common, encdec, lm

CPU = torch.device("cpu")
ARCHS = ("zamba2-7b", "phi-3-vision-4.2b", "whisper-medium")
ATOL = 2e-5
N_FRAMES = 30  # whisper-smoke's encoder frames in these tests


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               rtol=0, atol=atol)


def _setup(arch_id, seed, change=None):
    """(reference arch, port arch, reference cfg, port cfg, reference
    params, port model); ``change`` replaces the SMOKE configs' Mamba2
    fields in both."""
    r_arch, p_arch = r_configs.get_arch(arch_id), configs.get_arch(arch_id)
    r_cfg, p_cfg = r_arch.smoke, p_arch.smoke
    if change:
        r_cfg = dataclasses.replace(r_cfg, mamba_cfg=dataclasses.replace(r_cfg.mamba_cfg,
                                                                         **change))
        p_cfg = dataclasses.replace(p_cfg, mamba_cfg=dataclasses.replace(p_cfg.mamba_cfg,
                                                                         **change))
    params = r_arch.init(jax.random.PRNGKey(seed), r_cfg)
    return r_arch, p_arch, r_cfg, p_cfg, params, convert.params_from_reference(
        _np(params), p_cfg, CPU)


def _batch(arch_id, cfg, seed, s=16, labels=False):
    """numpy inputs: tokens (2, s) [, labels], whisper's frames (2, 30,
    d_model), phi-3-vision's images (2, n_patches, d_vision)."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (2, s)).astype(np.int32)}
    if labels:
        out["labels"] = rng.integers(0, cfg.vocab, (2, s)).astype(np.int32)
    if arch_id == "whisper-medium":
        out["frames"] = rng.normal(size=(2, N_FRAMES, cfg.d_model)).astype(np.float32)
    if arch_id == "phi-3-vision-4.2b":
        out["images"] = rng.normal(size=(2, cfg.vision.n_patches,
                                         cfg.vision.d_vision)).astype(np.float32)
    return out


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return steps.batch_to_torch(batch, CPU)


@pytest.mark.parametrize("arch_id,change", [(a, None) for a in ARCHS]
                         + [("zamba2-7b", dict(n_groups=2))])
def test_forward_matches_reference(arch_id, change):
    """Teacher-forced logits: zamba2 (its shared block before each group;
    also with two B/C groups, as the full config has), phi-3-vision with
    its patches prepended, whisper on its frames."""
    r_arch, p_arch, r_cfg, p_cfg, params, model = _setup(arch_id, 41, change)
    batch = _batch(arch_id, r_cfg, 41)
    r_logits = jax.jit(lambda p, b: r_arch.forward(r_cfg, p, b))(params, _jax(batch))
    with torch.no_grad():
        logits = p_arch.forward(p_cfg, model, _torch(batch))
    extra = r_cfg.vision.n_patches if arch_id == "phi-3-vision-4.2b" else 0
    assert tuple(logits.shape) == (2, 16 + extra, r_cfg.vocab) == r_logits.shape
    _close(logits, r_logits)


@pytest.mark.parametrize("arch_id", ARCHS)
def test_prefill_and_eight_decode_steps_match_reference(arch_id):
    """A 24-token prompt (behind phi-3-vision's 8 patches; whisper's over 30
    encoder frames), then 8 greedy decode steps: each step's logits, and
    the tokens equal. The caches' layout: zamba2's 6 layers then its 2
    groups' shared KV caches; whisper's self and cross caches a layer."""
    r_arch, p_arch, r_cfg, p_cfg, params, model = _setup(arch_id, 42)
    batch = _batch(arch_id, r_cfg, 42, s=24)
    patches = r_cfg.vision.n_patches if arch_id == "phi-3-vision-4.2b" else 0
    max_len = patches + 24 + 8 + 8
    r_prefill = jax.jit(lambda p, b: r_arch.prefill(r_cfg, p, b, max_cache_len=max_len))
    r_decode = jax.jit(lambda p, c, t: r_arch.decode_step(r_cfg, p, c, t))
    r_caches, r_logits = r_prefill(params, _jax(batch))
    with torch.no_grad():
        caches, logits = p_arch.prefill(p_cfg, model, _torch(batch), max_cache_len=max_len)
        _close(logits, r_logits)
        for _ in range(8):
            tok = np.asarray(jnp.argmax(r_logits[:, -1], axis=-1).astype(jnp.int32))[:, None]
            np.testing.assert_array_equal(steps.greedy(logits).numpy(), tok)
            r_caches, r_logits = r_decode(params, r_caches, jnp.asarray(tok))
            caches, logits = p_arch.decode_step(p_cfg, model, caches,
                                                torch.as_tensor(np.array(tok), dtype=torch.long))
            _close(logits, r_logits)
    if arch_id == "zamba2-7b":
        assert len(caches) == p_cfg.n_layers + p_cfg.n_groups
        shared = caches[p_cfg.n_layers:]
        assert [c["idx"] for c in shared] == [32] * p_cfg.n_groups
        assert shared[0]["k"].shape == (2, p_cfg.attn.n_kv_heads, max_len, p_cfg.attn.d_head)
        # one cache a group: the groups' keys differ
        assert not torch.equal(shared[0]["k"], shared[1]["k"])
    elif arch_id == "whisper-medium":
        assert len(caches) == p_cfg.n_dec_layers
        assert {c["self"]["idx"] for c in caches} == {32}
        assert {(c["cross"]["idx"], c["cross"]["k"].shape[2]) for c in caches} == {
            (N_FRAMES, N_FRAMES)}
    else:
        assert {c["idx"] for c in caches} == {patches + 32}


@pytest.mark.parametrize("arch_id", ARCHS)
def test_loss_and_every_gradient_match_reference(arch_id):
    """``loss_fn`` (phi-3-vision's on the text positions only) and its
    gradient for every parameter, against ``jax.value_and_grad``, with each
    layer and each call of the shared block recomputed in the backward."""
    r_arch, p_arch, r_cfg, p_cfg, params, model = _setup(arch_id, 43)
    batch = _batch(arch_id, r_cfg, 43, labels=True)
    (r_loss, _), r_grads = jax.jit(jax.value_and_grad(
        lambda p, b: r_arch.loss_fn(r_cfg, p, b), has_aux=True))(params, _jax(batch))
    steps.trainable(model)
    loss, parts, grads = steps.loss_and_grads(p_arch, p_cfg, model, _torch(batch))
    assert float(loss) == pytest.approx(float(r_loss), rel=1e-6)
    if arch_id != "whisper-medium":
        assert float(parts["ce"]) == float(loss)
    # the reference's gradient tree, carried onto the port's names
    want = convert.params_from_reference(_np(r_grads), p_cfg, CPU).state_dict()
    assert set(grads) == set(want)
    for name, g in grads.items():
        scale = max(float(want[name].abs().max()), 1e-3)
        _close(g, want[name].numpy(), atol=1e-5 * scale)


def test_shared_block_is_one_weight_copy_with_the_summed_gradient(monkeypatch):
    """zamba2's shared block: one module, counted once, and its ``.grad``
    the reference's ``shared`` gradient, which is the sum of the gradients
    of its ``n_groups`` calls (each call given its own copy here, without
    recomputation, and the copies' gradients summed)."""
    r_arch, p_arch, r_cfg, p_cfg, params, model = _setup("zamba2-7b", 44)
    n = common.count_params(model)
    assert n == sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(params))
    shared = dict(model.shared.named_parameters())
    assert n == common.count_params(model.shared) + sum(
        p.numel() for name, p in model.named_parameters() if not name.startswith("shared."))
    batch = _batch("zamba2-7b", r_cfg, 44, labels=True)
    (_, _), r_grads = jax.jit(jax.value_and_grad(
        lambda p, b: r_arch.loss_fn(r_cfg, p, b), has_aux=True))(params, _jax(batch))
    want = convert.flatten_reference(_np(r_grads["shared"]))
    model.requires_grad_(True)
    loss, _ = p_arch.loss_fn(p_cfg, model, _torch(batch))
    loss.backward()
    for name, p in shared.items():
        scale = max(float(np.abs(want[name]).max()), 1e-3)
        _close(p.grad, want[name], atol=1e-5 * scale)

    copies = [copy.deepcopy(model.shared) for _ in range(p_cfg.n_groups)]
    for c in copies:
        c.zero_grad(set_to_none=True)
    calls = iter(copies)
    real = lm._shared_forward
    monkeypatch.setattr(lm, "_shared_forward", lambda p, *a, **k: real(next(calls), *a, **k))
    loss, _ = p_arch.loss_fn(dataclasses.replace(p_cfg, remat=False), model, _torch(batch))
    loss.backward()
    assert next(calls, None) is None
    for name, p in shared.items():
        per_call = [dict(c.named_parameters())[name].grad for c in copies]
        assert all(g is not None and bool(g.any()) for g in per_call)
        scale = max(float(p.grad.abs().max()), 1e-3)
        _close(sum(per_call), p.grad.numpy(), atol=1e-5 * scale)


def test_vlm_prefill_longer_than_its_cache_is_refused():
    """A cache of prompt + 4 slots is shorter than phi-3-vision's 8 patches
    + prompt: prefill raises ``ValueError`` (a global-attention cache would
    otherwise turn into a ring that decode cannot use); text alone fits.
    ``serve.run`` sizes the cache patches + prompt + gen + 8."""
    _, p_arch, _, p_cfg, _, model = _setup("phi-3-vision-4.2b", 45)
    batch = _torch(_batch("phi-3-vision-4.2b", p_cfg, 45, s=12))
    with torch.no_grad():
        with pytest.raises(ValueError, match=r"20 positions \(8 image patches \+ 12 tokens\)"):
            lm.prefill(p_cfg, model, batch["tokens"], images=batch["images"],
                       max_cache_len=12 + 4)
        caches, _ = lm.prefill(p_cfg, model, batch["tokens"], max_cache_len=12 + 4)
        assert caches[0]["k"].shape[2] == 16 and caches[0]["idx"] == 12
        out = serve.run(p_arch, p_cfg, model, batch["tokens"].numpy(), 3,
                        images=batch["images"])
    assert out.tokens.shape == (2, 3)


def test_sinusoid_is_the_reference_within_one_ulp():
    """whisper-medium's 1,500 x 1,024 table: the powers of 10,000 equal
    XLA's bit for bit, so the angles do too; sin and cos within one f32
    ulp of 1."""
    got = encdec._sinusoid(1500, 1024, CPU).numpy()
    want = np.asarray(r_encdec._sinusoid(1500, 1024))
    assert got.dtype == np.float32 and got.shape == want.shape == (1500, 1024)
    np.testing.assert_allclose(got, want, rtol=0, atol=2.0**-24)


def test_serve_main_returns_the_reference_tokens(monkeypatch):
    """``serve.main`` for whisper-smoke on the reference's weights: the
    frames drawn after the prompts from one generator, as the reference's
    ``main`` draws them, give its greedy tokens."""
    from repro.launch import serve as r_serve

    argv = ["--arch", "whisper-medium", "--smoke"]
    r_arch = r_configs.get_arch("whisper-medium")
    params = r_arch.init(jax.random.PRNGKey(0), r_arch.smoke)
    p_arch = configs.get_arch("whisper-medium")

    def build(name, *, smoke=False, seed=0, device=None):
        assert (name, smoke, seed) == ("whisper-medium", True, 0)
        return p_arch, p_arch.smoke, convert.params_from_reference(_np(params), p_arch.smoke,
                                                                   device)

    monkeypatch.setattr(serve, "build", build)
    got = serve.main(argv + ["--device", "cpu"])
    want = r_serve.main(argv)
    assert got.tokens.shape == want.shape == (4, 16)
    np.testing.assert_array_equal(got.tokens.numpy(), want)


@pytest.mark.parametrize("arch_id", ARCHS)
def test_train_main_matches_the_reference_losses(arch_id, monkeypatch, tmp_path):
    """``launch.train.main --smoke --steps 2`` on the reference's weights:
    the pipeline's frames (whisper) and patches (phi-3-vision) reach the
    model, and both steps' losses equal the reference's within 1e-5."""
    from repro.launch import train as r_train

    argv = ["--arch", arch_id, "--smoke", "--steps", "2", "--batch", "2", "--seq", "32"]
    r_arch, p_arch = r_configs.get_arch(arch_id), configs.get_arch(arch_id)
    params = r_arch.init(jax.random.PRNGKey(0), r_arch.smoke)
    monkeypatch.setattr(p_arch, "init", lambda gen, cfg=None, *, device=None:
                        convert.params_from_reference(_np(params), cfg, device))
    got = train.main(argv + ["--device", "cpu", "--ckpt-dir", str(tmp_path / "port")])
    want = r_train.main(argv + ["--ckpt-dir", str(tmp_path / "ref")])
    assert len(got["history"]) == len(want["history"]) == 2
    for g, w in zip(got["history"], want["history"]):
        assert g["loss"] == pytest.approx(w["loss"], rel=1e-5)
