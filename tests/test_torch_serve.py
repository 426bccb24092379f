"""Port parity, serving: ``repro_torch.launch`` (steps, serve) and
``repro_torch.configs`` against the JAX package at SMOKE width, on the CPU.

The reference's weights are carried across (``convert``), prompts come
from the same numpy draws, and both packages' prefill and greedy decode
steps run side by side. Tolerances are stated per test.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as r_configs
from repro.configs import base as r_base
from repro.configs import example_lm as r_example
from repro.launch import steps as r_steps
from repro_torch import configs, convert
from repro_torch.configs import base, example_lm
from repro_torch.launch import serve, steps
from repro_torch.models import attention, lm, mamba2


def _as_reference_fields(cfg):
    """A port config's fields with torch dtypes as their names, nested."""
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if dataclasses.is_dataclass(v):
            v = _as_reference_fields(v)
        elif isinstance(v, torch.dtype):
            v = str(v).replace("torch.", "")
        out[f.name] = v
    return out


def _ref_fields(cfg):
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if dataclasses.is_dataclass(v):
            v = _ref_fields(v)
        elif f.name == "dtype":
            v = jnp.dtype(v).name
        out[f.name] = v
    return out


@pytest.mark.parametrize("arch_id", sorted(configs.ARCHS))
def test_configs_keep_the_reference_numbers(arch_id):
    port, ref = configs.get_arch(arch_id), r_configs.get_arch(arch_id)
    for which in ("full", "smoke"):
        assert _as_reference_fields(getattr(port, which)) == _ref_fields(getattr(ref, which))
    assert (port.family, port.long_500k_ok) == (ref.family, ref.long_500k_ok)
    assert {k: dataclasses.asdict(v) for k, v in base.SHAPES.items()} == \
           {k: dataclasses.asdict(v) for k, v in r_base.SHAPES.items()}


def test_example_configs_keep_the_reference_numbers():
    for key in ("100m", "10m"):
        assert _as_reference_fields(example_lm.EXAMPLES[key]) == \
               _ref_fields(r_example.EXAMPLES[key])


def test_registry_holds_the_ported_archs_and_names_the_rest():
    """Every arch of the reference is ported (none is left to name); an
    unknown id raises ``KeyError``."""
    assert sorted(configs.ARCHS) == sorted(r_configs.ARCHS) == [
        "gemma3-12b", "granite-20b", "granite-moe-1b-a400m", "mamba2-130m",
        "phi-3-vision-4.2b", "phi3.5-moe-42b-a6.6b", "qwen1.5-110b", "starcoder2-3b",
        "whisper-medium", "zamba2-7b"]
    assert configs.NOT_PORTED == {}
    assert [a for a in sorted(configs.ARCHS) if configs.get_arch(a).is_encdec()] == [
        "whisper-medium"]
    with pytest.raises(KeyError):
        configs.get_arch("no-such-arch")


def test_greedy_takes_the_first_index_on_ties():
    logits = torch.tensor([[[0.0, 2.0, 2.0, 1.0]], [[5.0, 5.0, 5.0, 5.0]]])
    assert steps.greedy(logits).tolist() == [[1], [0]]
    want = jnp.argmax(jnp.asarray(logits.numpy())[:, -1], axis=-1)
    assert steps.greedy(logits)[:, 0].tolist() == np.asarray(want).tolist()


def test_prompts_are_the_reference_draws():
    cfg = configs.get_arch("mamba2-130m").smoke
    got = serve.make_prompts(cfg, 3, 11, seed=4)
    rng = np.random.default_rng(4)
    want = np.concatenate([rng.integers(0, cfg.vocab, (1, 11)).astype(np.int32)
                           for _ in range(3)], 0)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("arch_id", sorted(configs.ARCHS))
def test_serve_run_matches_reference_prefill_and_serve_steps(arch_id):
    """``serve.run`` against the reference's ``make_prefill`` /
    ``make_serve_step`` (jitted as its ``serve.main`` does) on the same
    weights and prompts: prefill logits, every step's logits, the greedy
    tokens. Float32 SMOKE width: logits within 2e-5."""
    r_arch = r_configs.get_arch(arch_id)
    p_arch = configs.get_arch(arch_id)
    params = r_arch.init(jax.random.PRNGKey(21), r_arch.smoke)
    model = convert.params_from_reference(jax.tree_util.tree_map(np.asarray, params),
                                          p_arch.smoke, "cpu")
    # whisper's frames come after the prompts, as serve.main draws them
    prompts, frames = serve.make_inputs(p_arch, p_arch.smoke, 2, 24, seed=21)
    gen = 5
    max_len = 24 + gen + 8
    r_prefill = jax.jit(r_steps.make_prefill(r_arch, r_arch.smoke, max_cache_len=max_len))
    r_step = jax.jit(r_steps.make_serve_step(r_arch, r_arch.smoke))
    r_batch = {"tokens": jnp.asarray(prompts)}
    if frames is not None:
        r_batch["frames"] = jnp.asarray(frames, r_arch.smoke.dtype)
    caches, logits = r_prefill(params, r_batch)
    tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)[:, None]
    want_tokens, want_logits = [np.asarray(tok)], [np.asarray(logits)]
    for _ in range(gen - 1):
        caches, tok, logits = r_step(params, caches, tok)
        want_tokens.append(np.asarray(tok))
        want_logits.append(np.asarray(logits))

    got = serve.run(p_arch, p_arch.smoke, model, prompts, gen, frames=frames)
    np.testing.assert_array_equal(got.tokens.numpy(), np.concatenate(want_tokens, 1))
    got_logits = [got.prefill_logits] + got.step_logits
    assert len(got_logits) == gen
    for g, w in zip(got_logits, want_logits):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=2e-5)


def test_teacher_forcing_feeds_the_given_tokens():
    arch, cfg, model = serve.build("mamba2-130m", smoke=True, seed=1, device="cpu")
    prompts = serve.make_prompts(cfg, 2, 20, seed=1)
    free = serve.run(arch, cfg, model, prompts, 4)
    forced = serve.run(arch, cfg, model, prompts, 4, forced=free.tokens)
    assert torch.equal(forced.tokens, free.tokens)
    for a, b in zip(free.step_logits, forced.step_logits):
        assert torch.equal(a, b)
    other = serve.run(arch, cfg, model, prompts, 4, forced=(free.tokens + 1) % cfg.vocab)
    assert torch.equal(other.prefill_logits, free.prefill_logits)
    assert not torch.equal(other.step_logits[0], free.step_logits[0])


def test_serve_sizes_the_cache_prompt_plus_gen_plus_8(monkeypatch):
    seen = {}
    make = steps.make_prefill

    def spy(arch, cfg, *, max_cache_len, impl=None):
        seen["max_cache_len"] = max_cache_len
        return make(arch, cfg, max_cache_len=max_cache_len, impl=impl)

    monkeypatch.setattr(steps, "make_prefill", spy)
    arch, cfg, model = serve.build("starcoder2-3b", smoke=True, device="cpu")
    serve.run(arch, cfg, model, serve.make_prompts(cfg, 1, 9, seed=0), 3)
    assert seen["max_cache_len"] == 9 + 3 + 8


@pytest.mark.parametrize("arch", ["starcoder2-3b", "mamba2-130m", "example-10m", "gemma3-12b",
                                  "granite-moe-1b-a400m", "zamba2-7b", "phi-3-vision-4.2b",
                                  "whisper-medium"])
def test_serve_main_end_to_end_on_the_host(arch, capsys):
    argv = ["--arch", arch, "--device", "cpu", "--batch", "2", "--prompt-len", "20",
            "--gen", "4"]
    if arch != "example-10m":
        argv.append("--smoke")
    out = serve.main(argv)
    _, cfg = serve.resolve_arch(arch, smoke=True)
    assert tuple(out.tokens.shape) == (2, 4)
    assert int(out.tokens.min()) >= 0 and int(out.tokens.max()) < cfg.vocab
    assert all(bool(torch.isfinite(x).all()) for x in [out.prefill_logits, *out.step_logits])
    text = capsys.readouterr().out
    assert "prefill:" in text and "tok/s" in text and "device=cpu" in text


def test_serve_main_needs_a_card_unless_asked_for_the_host():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "mamba2-130m", "--smoke"])


def test_decode_trace_script_dry_run_on_the_host(capsys):
    """``scripts/trace_decode_torch.py`` at SMOKE width on the CPU: one JSON
    line per arch, no device events, the host's ops counted."""
    import importlib.util
    import json
    import os

    path = os.path.join(os.path.dirname(__file__), "..", "scripts", "trace_decode_torch.py")
    spec = importlib.util.spec_from_file_location("trace_decode_torch", path)
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    assert script.main(["--smoke", "--device", "cpu", "--steps", "2"]) == 0
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]
    assert [r["arch"] for r in rows] == ["starcoder2-3b", "mamba2-130m"]
    for r in rows:
        assert r["card_busy_ms"] == 0.0 and r["device_events_per_step"] == 0
        assert r["host_top_level_ops_per_step"] > 0 and r["step_ms_traced"] > 0


def test_attention_and_mamba_state_dtypes_follow_the_reference():
    """bf16 models keep bf16 KV caches and conv state, f32 SSM state."""
    acfg = attention.AttnConfig(d_model=32, n_heads=4, n_kv_heads=2, d_head=8)
    assert attention.make_cache(acfg, 1, 8, torch.bfloat16, "cpu")["k"].dtype == torch.bfloat16
    mcfg = mamba2.Mamba2Config(d_model=32, d_inner=64, d_state=16, head_dim=16)
    st = mamba2.make_state(mcfg, 1, torch.bfloat16, "cpu")
    assert st["conv"].dtype == torch.bfloat16 and st["ssm"].dtype == torch.float32
    caches = lm.init_caches(configs.get_arch("mamba2-130m").full, 1, 8, "meta")
    assert len(caches) == 24 and caches[0]["ssm"].shape == (1, 24, 128, 64)
