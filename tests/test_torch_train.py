"""Port parity, training: ``repro_torch.launch.steps.make_train_step``, the
compressed data-parallel step of ``launch.train``, the data pipeline,
checkpoints, the ``Trainer`` and the CLI, against the JAX package at SMOKE
width on the CPU.

The reference runs live on the weights of
``tests/data/torch_port_serve_golden.npz`` and its own ``SyntheticPipeline``
batches (``tests/helpers/make_torch_port_train_golden.py``); the port gets
the same weights (``convert``) and batches. Tolerances are stated per test.
"""

import functools
import json
import os

import numpy as np
import pytest
import torch

from helpers import make_torch_port_train_golden as tg
from helpers import torch_gloo
from repro.data import pipeline as r_pipeline
from repro_torch import convert
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_arch
from repro_torch.data.pipeline import PipelineConfig, SyntheticPipeline
from repro_torch.launch import mesh, steps, train
from repro_torch.models import common
from repro_torch.optim import adamw, compress
from repro_torch.runtime.trainer import Trainer

CPU = torch.device("cpu")
ARCHS = list(tg.ARCHS)
GOLDEN = os.path.join(os.path.dirname(__file__), "data", "torch_port_train_golden.npz")


def _opt():
    o = tg.OPT
    return adamw.AdamWConfig(peak_lr=o.peak_lr, warmup_steps=o.warmup_steps,
                             total_steps=o.total_steps)


@functools.lru_cache(maxsize=None)
def _reference(arch_id: str, kind: str, accum: int = 1) -> dict:
    if kind == "train":
        return tg.train_run(arch_id, accum)
    return tg.compressed_run(arch_id)


def _port_model(arch_id: str, params=None):
    cfg = get_arch(arch_id).smoke
    return convert.lm_params_from_reference(
        tg.reference_params(arch_id) if params is None else params, cfg, CPU)


def _port_run(arch_id: str, kind: str, accum: int = 1):
    arch = get_arch(arch_id)
    cfg = arch.smoke
    model = _port_model(arch_id)
    params = steps.trainable(model)
    opt = adamw.init(params)
    if kind == "train":
        step = steps.make_train_step(arch, cfg, _opt(), accum=accum)
    else:
        cstep = train.make_compressed_dp_step(arch, cfg, _opt(), mesh.make_data_group(CPU))
        resid = compress.init_residuals(params)

        def step(m, o, b):
            m, o, _, met = cstep(m, o, resid, b)
            return m, o, met

    hist = {}
    for b in tg.batches(cfg):
        model, opt, met = step(model, opt, steps.batch_to_torch(b, CPU))
        for k, v in met.items():
            hist.setdefault(k, []).append(float(v))
    return model, {k: np.asarray(v, np.float32) for k, v in hist.items()}


def _final_params(arch_id: str, run: dict):
    flat = {k[len("param/"):]: v for k, v in run.items() if k.startswith("param/")}
    return _port_model(arch_id, tg.unflatten(flat)).state_dict()


def test_pipeline_batches_equal_the_reference_bit_for_bit():
    for kw in (dict(vocab=256, seq=32, global_batch=4, seed=5),
               dict(vocab=50280, seq=64, global_batch=2, seed=0)):
        port = SyntheticPipeline(PipelineConfig(**kw))
        ref = r_pipeline.SyntheticPipeline(r_pipeline.PipelineConfig(**kw))
        for _ in range(3):
            a, b = port.next(), ref.next()
            assert set(a) == set(b)
            for k in a:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])
        assert port.state_dict() == ref.state_dict() == {"step": 3}


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("arch_id", ARCHS)
def test_train_step_matches_reference(arch_id, accum):
    """Three steps of make_train_step (warm-up ends inside, clipping on).
    f32 throughout: the losses agree within 1e-6 relative (measured ~1e-7),
    the grad norms within 2e-5 (measured ~1.5e-6: the backward sums in
    another order), lr within f32 rounding of the cosine; the parameters
    within 5e-5 (measured 1.5e-5: where a gradient is near zero, Adam's
    m / sqrt(v) turns its last-bit differences into larger steps)."""
    want = _reference(arch_id, "train", accum)
    model, got = _port_run(arch_id, "train", accum)
    for k, rtol in (("loss", 1e-6), ("ce", 1e-6), ("grad_norm", 2e-5), ("lr", 1e-6)):
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=0, err_msg=k)
    np.testing.assert_array_equal(got["lb"], 0.0)
    ref_params = _final_params(arch_id, want)
    for name, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), ref_params[name].numpy(), rtol=0, atol=5e-5,
                                   err_msg=name)


@pytest.mark.parametrize("arch_id", ARCHS)
def test_train_step_in_bf16_matches_reference(arch_id):
    """The full configs' dtype at SMOKE width: bf16 parameters and
    gradients, f32 moments, the clipped gradient kept in f32 as the
    compiled reference keeps it. Each bf16 update rounds the parameters
    (2^-9 relative), so after three steps the losses differ by up to
    1.1e-3 relative and the grad norms by up to 1.1e-2 (measured on this
    host); the tolerances are about three times that."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from repro.configs import get_arch as r_get_arch
    from repro.launch import steps as r_steps
    from repro.optim import adamw as r_adamw

    arch, r_arch = get_arch(arch_id), r_get_arch(arch_id)
    cfg = dataclasses.replace(arch.smoke, dtype=torch.bfloat16)
    r_cfg = dataclasses.replace(r_arch.smoke, dtype=jnp.bfloat16)
    ref_dtypes = r_arch.init(jax.random.PRNGKey(0), r_cfg)  # which leaves are bf16
    r_params = jax.tree_util.tree_map(lambda a, r: jnp.asarray(a).astype(r.dtype),
                                      tg.reference_params(arch_id), ref_dtypes)
    r_state = r_adamw.init(r_params)
    r_step = jax.jit(r_steps.make_train_step(r_arch, r_cfg, tg.OPT))
    model = convert.lm_params_from_reference(tg.reference_params(arch_id), cfg, CPU)
    state = adamw.init(steps.trainable(model))
    step = steps.make_train_step(arch, cfg, _opt())
    for b in tg.batches(cfg):
        r_params, r_state, want = r_step(r_params, r_state, jax.tree_util.tree_map(jnp.asarray, b))
        model, state, got = step(model, state, steps.batch_to_torch(b, CPU))
        np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=5e-3)
        np.testing.assert_allclose(float(got["grad_norm"]), float(want["grad_norm"]), rtol=3e-2)
    assert model.embed.table.dtype == torch.bfloat16


@pytest.mark.parametrize("arch_id", ARCHS)
def test_compressed_step_at_one_rank_matches_reference(arch_id):
    """Three compressed steps over a one-rank gloo group. The codec and the
    reduction are bit for bit the reference's on equal inputs
    (tests/test_torch_optim.py), but the raw gradients differ in their last
    bits, which moves an element to the next int8 level now and then; Adam
    then steps that element by up to lr, and the error feedback carries it
    on. So: losses within 1e-4 relative (measured 1e-5), grad norms within
    5e-3 (measured 8e-4), lr within f32 rounding; every parameter within
    2 x (sum of the steps' lr) of the reference's, and three quarters of
    them within 1e-5 (measured: 98% and 85% of the two archs' elements),
    with a median error within 5e-6 (measured 1.5e-7 and 1.4e-6). A step
    that drops the error-feedback residual fails both: 44% and 40% of its
    elements within 1e-5, medians 1.3e-5 and 1.7e-5; the bound on the
    largest error alone passes any two Adam runs from the same start."""
    want = _reference(arch_id, "compressed")
    model, got = _port_run(arch_id, "compressed")
    for k, rtol in (("loss", 1e-4), ("grad_norm", 5e-3), ("lr", 1e-6)):
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=0, err_msg=k)
    ref_params = _final_params(arch_id, want)
    bound = 2 * float(want["lr"].sum())
    diffs = []
    for name, p in model.state_dict().items():
        diff = (p - ref_params[name]).abs()
        assert float(diff.max()) <= bound, name
        diffs.append(diff.reshape(-1))
    diffs = torch.cat(diffs)
    close = float((diffs <= 1e-5).float().mean())
    assert close >= 0.75, close
    assert float(diffs.median()) <= 5e-6, float(diffs.median())


@pytest.mark.parametrize("arch_id", ARCHS)
def test_golden_is_what_the_live_reference_computes(arch_id):
    """tests/data/torch_port_train_golden.npz (which chip_smoke.py holds the
    card against) is still the reference's output on this host."""
    golden = np.load(GOLDEN)
    assert int(golden["meta/steps"]) == tg.STEPS and int(golden["meta/batch"]) == tg.BATCH
    for kind in ("train", "compressed"):
        live = _reference(arch_id, kind)
        keys = [k for k in golden.files if k.startswith(f"{arch_id}/{kind}/")]
        assert {k.split("/", 2)[2] for k in keys} == set(live)
        for k in keys:
            np.testing.assert_allclose(live[k.split("/", 2)[2]], golden[k], rtol=1e-6,
                                       atol=1e-7, err_msg=k)


def test_cross_entropy_matches_reference_with_and_without_mask():
    import jax.numpy as jnp

    from repro.models import common as r_common

    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 7, 11)).astype(np.float32) * 3
    labels = rng.integers(0, 11, (2, 7)).astype(np.int32)
    mask = (rng.random((2, 7)) < 0.6).astype(np.float32)
    for m in (None, mask):
        want = float(r_common.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                            None if m is None else jnp.asarray(m)))
        got = float(common.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                                         None if m is None else torch.from_numpy(m)))
        np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("arch_id", ARCHS)
def test_recomputation_gives_the_gradients_of_the_plain_backward(arch_id):
    """remat (per-layer torch.utils.checkpoint) changes memory, not values:
    the same gradients bit for bit, and the kernel wrappers' autograd
    functions in the graph."""
    import dataclasses

    arch = get_arch(arch_id)
    batch = steps.batch_to_torch(tg.batches(arch.smoke, 1)[0], CPU)
    out = {}
    for remat in (True, False):
        cfg = dataclasses.replace(arch.smoke, remat=remat)
        model = _port_model(arch_id)
        steps.trainable(model)
        _, _, grads = steps.loss_and_grads(arch, cfg, model, batch)
        out[remat] = grads
    for name in out[True]:
        assert torch.equal(out[True][name], out[False][name]), name


def test_loss_and_grads_raises_when_a_parameter_gets_no_gradient():
    arch = get_arch("starcoder2-3b")
    model = _port_model("starcoder2-3b")
    steps.trainable(model)
    model.register_parameter("orphan", torch.nn.Parameter(torch.zeros(3)))
    batch = steps.batch_to_torch(tg.batches(arch.smoke, 1)[0], CPU)
    with pytest.raises(RuntimeError, match="not have been used"):
        steps.loss_and_grads(arch, arch.smoke, model, batch)


def test_checkpoint_round_trip_atomicity_and_retention(tmp_path):
    rng = np.random.default_rng(0)
    state = {
        "params": {"w": torch.from_numpy(rng.standard_normal((5, 3)).astype(np.float32))
                   .to(torch.bfloat16), "b": torch.arange(4, dtype=torch.float32)},
        "opt_state": {"step": torch.tensor(7, dtype=torch.int64)},
    }
    mgr = CheckpointManager(str(tmp_path), keep=3)
    for step in (1, 2, 3, 4):
        mgr.save_async(step, state, {"pipeline": {"step": step}})
        state["params"]["b"] += 1  # the snapshot was taken before this
    mgr.wait()
    assert mgr.steps() == [2, 3, 4]  # keep=3
    man = mgr.manifest(4)
    assert man["step"] == 4 and man["pipeline"] == {"step": 4}
    assert man["arrays"]["params/w__bf16"] == {"shape": [5, 3], "dtype": "uint16"}
    with np.load(tmp_path / "step_00000004" / "arrays_00000.npz") as z:
        assert z["params/w__bf16"].dtype == np.uint16
    target = {"params": {"w": torch.zeros((5, 3), dtype=torch.bfloat16),
                         "b": torch.zeros(4)},
              "opt_state": {"step": torch.tensor(0, dtype=torch.int64)}}
    mgr.restore(4, target)
    assert torch.equal(target["params"]["w"].view(torch.int16),
                       state["params"]["w"].view(torch.int16))  # bf16 bit for bit
    assert torch.equal(target["params"]["b"], torch.arange(4, dtype=torch.float32) + 3)
    assert int(target["opt_state"]["step"]) == 7
    # a writer killed before its rename leaves step_N.tmp: never restored from
    os.makedirs(tmp_path / "step_00000009.tmp")
    (tmp_path / "step_00000009.tmp" / "manifest.json").write_text(json.dumps({"step": 9}))
    assert mgr.latest_step() == 4
    with pytest.raises(ValueError, match="shape"):
        mgr.restore(4, {"params": {"w": torch.zeros(2), "b": torch.zeros(4)},
                        "opt_state": {"step": torch.tensor(0)}})


def _trainer(arch_id, ckpt_dir, seed):
    arch = get_arch(arch_id)
    cfg = arch.smoke
    model = arch.init(torch.Generator().manual_seed(seed), cfg, device=CPU)
    opt = adamw.init(steps.trainable(model))
    pipe = SyntheticPipeline(PipelineConfig(vocab=cfg.vocab, seq=32, global_batch=2, seed=1))
    base = steps.make_train_step(arch, cfg, adamw.AdamWConfig(peak_lr=1e-2, warmup_steps=2,
                                                              total_steps=6))

    def step(m, o, b):
        return base(m, o, steps.batch_to_torch(b, CPU))

    return Trainer(train_step=step, params=model, opt_state=opt, pipeline=pipe,
                   ckpt_dir=str(ckpt_dir), ckpt_every=2)


def test_trainer_resumes_to_the_uninterrupted_losses_bit_for_bit(tmp_path):
    full = _trainer("mamba2-130m", tmp_path / "full", seed=0).run(6)
    first = _trainer("mamba2-130m", tmp_path / "cut", seed=0).run(4)
    # a new process would start from other weights: the checkpoint replaces them
    resumed = _trainer("mamba2-130m", tmp_path / "cut", seed=99)
    assert resumed.try_restore() and resumed.step == 4
    assert resumed.pipeline.state_dict() == {"step": 4}
    rest = resumed.run(6)
    losses = [h["loss"] for h in first["history"] + rest["history"]]
    assert losses == [h["loss"] for h in full["history"]]
    assert rest["exit"] == "completed" and rest["step"] == 6


@pytest.mark.parametrize("compress_flag", [False, True])
@pytest.mark.parametrize("arch_id", ARCHS)
def test_train_main_on_the_host(arch_id, compress_flag, tmp_path):
    argv = ["--arch", arch_id, "--smoke", "--device", "cpu", "--steps", "3", "--batch", "2",
            "--seq", "32", "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    result = train.main(argv + (["--compress"] if compress_flag else []))
    assert result["exit"] == "completed" and result["step"] == 3
    assert len(result["history"]) == 3
    assert all(np.isfinite(h["loss"]) for h in result["history"])
    assert CheckpointManager(str(tmp_path)).steps() == [2, 3]


def test_train_main_refuses_what_is_not_ported(tmp_path):
    """Without a card, the default device raises. ``--compress --mesh 1x2``
    (the model axis, once refused) runs on 2 gloo ranks, and each rank's
    losses are the 1-rank compressed run's: the two model ranks of the one
    data index take the same step."""
    argv = ["--arch", "mamba2-130m", "--smoke", "--device", "cpu", "--steps", "3",
            "--batch", "4", "--seq", "32", "--compress"]
    want = train.main(argv + ["--ckpt-dir", str(tmp_path / "one")])
    outs = torch_gloo.spawn(
        2, tmp_path, [("train", (argv + ["--mesh", "1x2", "--ckpt-dir", str(tmp_path / "mesh")],))],
        timeout=240)
    for (out,) in outs:
        assert out["losses"] == [h["loss"] for h in want["history"]] and out["step"] == 3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train.main(["--arch", "mamba2-130m", "--smoke", "--steps", "1"])


def test_train_auto_energy_logs_the_reference_plan(tmp_path, capsys):
    """``--auto-energy`` with no dry-run artifact for the arch: the planner
    takes the analytic roofline and logs the plan the reference's
    ``launch.train`` logs, line for line."""
    from repro.launch import train as r_train

    argv = ["--arch", "mamba2-130m", "--smoke", "--steps", "1", "--auto-energy"]
    train.main(argv + ["--device", "cpu", "--ckpt-dir", str(tmp_path / "port")])
    got = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("[auto-energy]")]
    r_train.main(argv + ["--ckpt-dir", str(tmp_path / "ref")])
    want = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("[auto-energy]")]
    assert got == want and len(got) == 1
    assert "perf model: analytic" in got[0]


def test_data_group_backend_follows_the_device():
    group = mesh.make_data_group(CPU)
    assert torch.distributed.get_backend(group) == "gloo"
    assert mesh.make_data_group(CPU) is group
    with pytest.raises(RuntimeError, match="nccl"):
        mesh.make_data_group(torch.device("cuda"))
    assert mesh.parse_mesh("", 1) == (1,) and mesh.parse_mesh("1", 1) == (1,)
    with pytest.raises(ValueError):
        mesh.parse_mesh("2", 1)


def test_trajectory_script_dry_run_on_the_host(capsys):
    """``scripts/train_trajectory_torch.py`` at SMOKE width on the CPU: every
    arm starts from the same weights and batch, so the first losses agree
    (SMOKE is float32, so the f32 arm is the uncompressed one); each arm
    takes its steps with finite losses, and lr/10 runs at a tenth of lr."""
    import importlib.util

    path = os.path.join(os.path.dirname(__file__), "..", "scripts", "train_trajectory_torch.py")
    spec = importlib.util.spec_from_file_location("train_trajectory_torch", path)
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    assert script.main(["--smoke", "--device", "cpu", "--steps", "2", "--seq", "32"]) == 0
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]
    assert len(rows) == 1 and set(rows[0]["arms"]) == set(script.ARMS)
    arms = rows[0]["arms"]
    first = arms["uncompressed"]["loss"][0]
    for name, arm in arms.items():
        assert len(arm["loss"]) == 2 and np.isfinite(arm["loss"]).all(), name
        np.testing.assert_allclose(arm["loss"][0], first, rtol=1e-6, err_msg=name)
    np.testing.assert_allclose(arms["f32"]["loss"], arms["uncompressed"]["loss"], rtol=1e-6)
    np.testing.assert_allclose(arms["lr/10"]["lr"], np.asarray(arms["uncompressed"]["lr"]) / 10,
                               rtol=1e-6)


def test_smoke_phases_script_needs_a_card(capsys):
    """``scripts/smoke_phases_torch.py`` times a checkout's serving and
    training phases on the card; on the host it exits non-zero and runs
    nothing."""
    import importlib.util

    path = os.path.join(os.path.dirname(__file__), "..", "scripts", "smoke_phases_torch.py")
    spec = importlib.util.spec_from_file_location("smoke_phases_torch", path)
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    assert script.main(["change"]) == 2
    assert "no CUDA device" in capsys.readouterr().err
