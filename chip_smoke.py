#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA card.

    python3 chip_smoke.py          # from the root of a checkout, one card

Phases (every failure raises; nothing is caught):

1. device: the card's name and power limit; TF32 off.
2. build: nvcc builds the Hopper kernels from src/repro_torch/kernels/csrc/.
3. kernels: each kernel against its plain PyTorch version on the card, at
   the main paths' shapes (exact for plan_argmin / pareto_mask, within the
   stated tolerances for the others), timed beside its bound: many calls
   captured in one CUDA graph and replayed between CUDA events, so the
   host's dispatch is not in the time (eager back-to-back calls are printed
   beside it). flash_attention at starcoder2-3b's prefill and decode shapes
   (with F.scaled_dot_product_attention timed as the library yardstick; the
   port never calls it), ssd_chunks at mamba2-130m's prefill shape.
4. paper loop: evaluate.compare_governors at full characterization
   (11 f x 32 cores x 5 inputs, 4 apps: a (4, 1760, 1760) Gram), all 20
   plans, governors at the --quick settings; the plans are held against
   tests/data/torch_port_eval_golden.json (written by the JAX package).
5. fleet-scale planning: plan_many / pareto_many over B = 10,000 workloads
   of 20 families; the fused kernel path, its plain version and the exact
   path must agree exactly. The kernel and plain rounds run twice in the
   order kernel, plain, plain, kernel, so that run order shows in their
   times; each round's time is printed with the seconds the garbage
   collector ran inside it.
6. serve: (a) starcoder2-3b and mamba2-130m at SMOKE width on the card,
   with the kernels, on the JAX package's weights and prompts from
   tests/data/torch_port_serve_golden.npz: prefill logits, every decode
   step's logits and the greedy tokens against the JAX package's;
   (b) launch.serve.main at full width for both (batch 8, prompt 1,024,
   gen 32, random weights from a seed), once to warm up and once counted,
   then the plain arm (impl="ref") on the same weights, fed the kernel
   arm's tokens: prefill and step logits must agree within SERVE_FULL_REL
   of their scale.
7. launches: one JSON line with every kernel's launch count on its main
   path (phases 4-5 for the planning kernels, 6b's kernel arms for the
   serving kernels, each counted from 0 just before its path), its error
   against the plain version and its times.
8. the last line: {"ok": true, "device": {...}}.

It exits non-zero without a CUDA device, and when the package is missing.
"""

import gc
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 42
RBF_ATOL = 2e-6  # kernel vs plain rbf_gram: same expression and order
B_FLEET = 10_000
GOLDEN = os.path.join(HERE, "tests", "data", "torch_port_eval_golden.json")
SERVE_GOLDEN = os.path.join(HERE, "tests", "data", "torch_port_serve_golden.npz")
NEAR_TIE_REL = 1e-3
DEVICE = "cuda"
# flash_attention, kernel vs plain, per element |err| <= rtol |want| + atol:
# f32 inputs, f32 sums in another order; bf16, both arms round nearly the
# same f32 value to bf16 once, so they differ by at most one bf16 ulp,
# 2^-7 of |want|, with atol for outputs near 0
FLASH_TOL = {"float32": (0.0, 2e-5), "bfloat16": (2.0 ** -7, 1e-4)}
# ssd_chunks, kernel vs plain: f32 sums of up to T*n terms in another order
# and a cumsum taken as a scan, relative to the output's scale
SSD_REL = 1e-4
# serve at SMOKE width (f32) on the card vs the JAX package on the host
SERVE_GOLDEN_ATOL = 1e-4
# serve at full width (bf16), kernel arm vs plain arm, teacher-forced:
# bf16 activations round at other places once the attention or SSD output
# differs by an ulp (2^-8 relative), and 24-30 layers carry that on, about
# 2^-8 x sqrt(30) ~ 2%; relative to max |logit|
SERVE_FULL_REL = 0.05
SERVE_ARCHS = ("starcoder2-3b", "mamba2-130m")
SERVE_ARGV = ["--batch", "8", "--prompt-len", "1024", "--gen", "32"]

# H100 SXM peaks (NVIDIA data sheet): HBM rate, fp32 outside the tensor
# cores, dense bf16 on the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12


def _stage(name: str, t0: float) -> float:
    now = time.perf_counter()
    print(f"[stage] {name}: {now - t0:.3f} s", flush=True)
    return now


def _eager_ms(torch, fn, reps: int) -> float:
    """Mean ms per call of back-to-back eager calls between CUDA events:
    where a call is short, this is the host's dispatch rate."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _time_ms(torch, fn, reps: int, replays: int = 3) -> float:
    """Mean ms per call on the card: ``reps`` calls captured in one CUDA
    graph, replayed ``replays`` times between CUDA events. The wrappers'
    host work (checks, ctypes, allocation) runs once, at capture."""
    fn()  # loads the kernel module and warms the allocator before capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (replays * reps)
    del graph
    torch.cuda.empty_cache()
    return ms


def _bound_ms(n_bytes: float, n_ops: float, ops_per_s: float = FP32_OPS_PER_S):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    print(f"[device] torch: {kind}, count {torch.cuda.device_count()}, "
          f"torch {torch.__version__}, cuda {torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return kind, smi


def phase_build():
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    path = _build.build()
    _build.library()
    print(f"[build] {path.name} in {time.perf_counter() - t0:.2f} s", flush=True)
    for out in _build.BUILD_LOG:
        for line in out.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"[ptxas] {line.strip()}", flush=True)


def _rbf_inputs(np, rng, b, n, m, d):
    if d == 3:  # the paper's raw (f GHz, cores, input size) features
        def feats(k):
            return np.stack([rng.uniform(1.2, 2.2, (b, k)),
                             rng.integers(1, 33, (b, k)).astype(float),
                             rng.integers(1, 6, (b, k)).astype(float)], -1)
        return feats(n).astype(np.float32), feats(m).astype(np.float32)
    return (rng.standard_normal((b, n, d)).astype(np.float32),
            rng.standard_normal((b, m, d)).astype(np.float32))


def _plan_inputs(np, rng, b, g):
    t = rng.lognormal(3.0, 1.0, (b, g)).astype(np.float32)
    w = rng.uniform(50.0, 600.0, (1, g)).astype(np.float32)
    k = rng.choice([0.0, 1.0, 2.0], b).astype(np.float32)
    mask = rng.random((b, g)) < 0.7
    t[:, 1::8] = t[:, 0::8][:, : t[:, 1::8].shape[1]]  # exact metric ties
    w[:, 1::8] = w[:, 0::8][:, : w[:, 1::8].shape[1]]
    mask[::97] = False  # all-masked rows
    t[5::89, 100] = np.nan  # NaN step times: the first feasible NaN wins
    t[6::89, :] = np.nan
    return t, w, k, mask


def _pareto_inputs(np, rng, b, g):
    t = rng.lognormal(3.0, 1.0, (b, g)).astype(np.float32)
    e = rng.lognormal(8.0, 0.5, (b, g)).astype(np.float32)
    mask = rng.random((b, g)) < 0.8
    t[:, 5::11] = t[:, 4::11][:, : t[:, 5::11].shape[1]]  # exact (t, e) ties
    e[:, 5::11] = e[:, 4::11][:, : e[:, 5::11].shape[1]]
    t[::13, 3] = np.inf
    e[::17, 7] = -np.inf
    t[::19, 9] = -np.inf
    return t, e, mask


def phase_kernels(torch, np, kind):
    from repro_torch.core.engine import TIME_FLOOR
    from repro_torch.kernels import ops

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    results = {}

    # rbf_gram: the fit (4, 1760, 1760, 3), the engine predict (20, 352, 352, 2)
    # and one evaluate plan's predict (352, 1760, 3)
    rbf = []
    for (b, n, m, d) in ((4, 1760, 1760, 3), (20, 352, 352, 2), (1, 352, 1760, 3)):
        xn, yn = _rbf_inputs(np, rng, b, n, m, d)
        x = torch.from_numpy(xn).to(dev)
        y = torch.from_numpy(yn).to(dev)
        if b == 1:
            x, y = x[0], y[0]
        gamma = 0.5
        got = ops.rbf_gram(x, y, gamma)
        want = ops.rbf_gram(x, y, gamma, impl="ref")
        torch.cuda.synchronize()
        if got.shape != want.shape or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"rbf_gram {(b, n, m, d)}: bad output")
        err = float((got - want).abs().max())
        if err > RBF_ATOL:
            raise AssertionError(f"rbf_gram {(b, n, m, d)}: max |err| {err} > {RBF_ATOL}")
        ms = _time_ms(torch, lambda: ops.rbf_gram(x, y, gamma), 50)
        eager = _eager_ms(torch, lambda: ops.rbf_gram(x, y, gamma), 50)
        plain_ms = _time_ms(torch, lambda: ops.rbf_gram(x, y, gamma, impl="ref"), 10)
        bound, by = _bound_ms(4.0 * (b * n * d + b * m * d + b * n * m),
                              b * n * m * (2 * d + 5))
        print(f"[kernel] rbf_gram b={b} n={n} m={m} d={d}: {ms:.4f} ms "
              f"(eager calls {eager:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{bound * 1e3:.2f} us by {by}, max |err| {err:.3g}) on {kind}",
              flush=True)
        rbf.append(dict(shape=(b, n, m, d), ms=ms, plain_ms=plain_ms,
                        bound_ms=bound, bound_by=by, max_abs_err=err))
    # the JSON line carries the fit shape, the largest on the path
    results["rbf_gram"] = dict(rbf[0], max_abs_err=max(r["max_abs_err"] for r in rbf))

    # plan_argmin at B = 10^4, G = 352: identical indices
    b, g = B_FLEET, 352
    tn, wn, kn, mn = _plan_inputs(np, rng, b, g)
    t = torch.from_numpy(tn).to(dev)
    w = torch.from_numpy(wn).to(dev)
    k = torch.from_numpy(kn).to(dev)
    mask = torch.from_numpy(mn).to(dev)
    got = ops.plan_argmin(t, w, k, mask, time_floor=TIME_FLOOR)
    want = ops.plan_argmin(t, w, k, mask, time_floor=TIME_FLOOR, impl="ref")
    mism = int((got != want).sum())
    err = float((got.long() - want.long()).abs().max())
    if mism:
        raise AssertionError(f"plan_argmin: {mism} of {b} rows differ")
    def kernel():
        return ops.plan_argmin(t, w, k, mask, time_floor=TIME_FLOOR)

    ms = _time_ms(torch, kernel, 200)
    eager = _eager_ms(torch, kernel, 200)
    plain_ms = _time_ms(
        torch, lambda: ops.plan_argmin(t, w, k, mask, time_floor=TIME_FLOOR, impl="ref"), 20)
    bound, by = _bound_ms(4.0 * b * g + b * g + 4.0 * g + 4.0 * b + 4.0 * b, 5.0 * b * g)
    print(f"[kernel] plan_argmin B={b} G={g}: {ms:.4f} ms (eager calls {eager:.4f} ms, "
          f"plain {plain_ms:.4f} ms, bound {bound * 1e3:.2f} us by {by}, {mism} rows "
          f"differ, {int(np.isnan(tn).any(1).sum())} rows with NaN) on {kind}", flush=True)
    results["plan_argmin"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                                  bound_by=by, max_abs_err=err)

    # pareto_mask at B = 10^4, G = 352: identical keep-sets
    tn, en, mn = _pareto_inputs(np, rng, b, g)
    t = torch.from_numpy(tn).to(dev)
    e = torch.from_numpy(en).to(dev)
    mask = torch.from_numpy(mn).to(dev)
    got = ops.pareto_mask(t, e, mask)
    want = ops.pareto_mask(t, e, mask, impl="ref")
    mism = int((got != want).sum())
    err = float((got.int() - want.int()).abs().max())
    if mism:
        raise AssertionError(f"pareto_mask: {mism} of {b * g} points differ")
    ms = _time_ms(torch, lambda: ops.pareto_mask(t, e, mask), 50)
    eager = _eager_ms(torch, lambda: ops.pareto_mask(t, e, mask), 50)
    plain_ms = _time_ms(torch, lambda: ops.pareto_mask(t, e, mask, impl="ref"), 2)
    # the least work for this function is a per-row lexsort on (t, e, index)
    # and a running minimum, as engine.pareto_frontier does on the host:
    # about 3 log2(G) comparisons and 2 operations a point, far below the
    # 10 bytes a point (t, e, mask in, keep-set out) it must move
    bound, by = _bound_ms(10.0 * b * g, b * g * (3.0 * math.log2(g) + 2.0))
    print(f"[kernel] pareto_mask B={b} G={g}: {ms:.4f} ms (eager calls {eager:.4f} ms, "
          f"plain {plain_ms:.4f} ms, bound {bound * 1e3:.2f} us by {by}, {mism} "
          f"points differ) on {kind}", flush=True)
    results["pareto_mask"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                                  bound_by=by, max_abs_err=err)
    results["flash_attention"] = _check_flash(torch, np, rng, kind)
    results["ssd_chunks"] = _check_ssd(torch, np, rng, kind)
    return results


def _flash_case(torch, np, rng, kind, b, h, hk, sq, skv, d, dtype, **kw):
    """One flash_attention shape: kernel vs plain, timed beside its bound."""
    from repro_torch.kernels import ops

    dev = torch.device(DEVICE)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev, dtype)
               for shape in ((b, h, sq, d), (b, hk, skv, d), (b, hk, skv, d)))
    got = ops.flash_attention(q, k, v, **kw)
    want = ops.flash_attention(q, k, v, impl="ref", **kw)
    torch.cuda.synchronize()
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"flash_attention {(b, h, hk, sq, skv, d)}: bad output")
    diff = (got.float() - want.float()).abs()
    err = float(diff.max())
    rtol, atol = FLASH_TOL[str(dtype).replace("torch.", "")]
    # the worst element's error as a share of its own tolerance
    worst = float((diff / (rtol * want.float().abs() + atol)).max())
    if worst > 1.0:
        raise AssertionError(f"flash_attention {(b, h, hk, sq, skv, d)}: an error is "
                             f"{worst:.3g} x its tolerance ({rtol:.3g} |want| + {atol:.3g})")
    # the work: the (query, key) pairs each row sees, 4 d flops a pair
    # (QK^T and PV); each input read once, the output written once
    kv_len = kw.get("kv_len") or skv
    q_off = kw.get("q_offset", 0)
    if kw.get("causal", True):
        pairs = sum(min(kv_len, q_off + i + 1) for i in range(sq))
    else:
        pairs = sq * kv_len
    n_ops = 4.0 * b * h * d * pairs
    n_bytes = q.element_size() * (2 * b * h * sq * d + 2 * b * hk * kv_len * d)
    bound, by = _bound_ms(n_bytes, n_ops, BF16_OPS_PER_S)
    fp32_bound, _ = _bound_ms(n_bytes, n_ops)
    reps = 5 if sq > 1 else 200
    ms = _time_ms(torch, lambda: ops.flash_attention(q, k, v, **kw), reps)
    eager = _eager_ms(torch, lambda: ops.flash_attention(q, k, v, **kw), reps)
    plain_ms = _time_ms(torch, lambda: ops.flash_attention(q, k, v, impl="ref", **kw),
                        2 if sq > 1 else 20)
    import torch.nn.functional as F
    ks, vs = k[:, :, :kv_len], v[:, :, :kv_len]
    lib_causal = bool(kw.get("causal", True)) and sq > 1
    library_ms = _time_ms(torch, lambda: F.scaled_dot_product_attention(
        q, ks, vs, is_causal=lib_causal, enable_gqa=True), reps)
    print(f"[kernel] flash_attention b={b} h={h} hk={hk} sq={sq} kv_len={kv_len} d={d} "
          f"{str(dtype).replace('torch.', '')} {kw}: {ms:.4f} ms (eager calls {eager:.4f} ms, "
          f"plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound {bound * 1e3:.2f} us "
          f"by {by} at the bf16 tensor-core rate, {fp32_bound * 1e3:.1f} us at the fp32 "
          f"rate, max |err| {err:.3g} of max |want| {float(want.float().abs().max()):.3g}, "
          f"worst element at {worst:.3g} x its tolerance) on {kind}", flush=True)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by, max_abs_err=err,
                library_ms=library_ms)


def _check_flash(torch, np, rng, kind):
    """starcoder2-3b's attention: prefill (b 8, H 24, Hk 2, S 1024, D 128,
    causal) and a decode step (one row at q_offset 1055 over a 1,064-slot
    cache, kv_len 1,056), bf16."""
    bf16 = torch.bfloat16
    prefill = _flash_case(torch, np, rng, kind, 8, 24, 2, 1024, 1024, 128, bf16,
                          causal=True)
    decode = _flash_case(torch, np, rng, kind, 8, 24, 2, 1, 1064, 128, bf16, causal=False,
                         q_offset=1055, kv_len=1056)
    # the JSON line carries the prefill shape, the larger share of the time,
    # and the decode shape's error under its own key
    return dict(prefill, decode_max_abs_err=decode["max_abs_err"])


def _check_ssd(torch, np, rng, kind):
    """mamba2-130m's SSD chunk block at its prefill shape: b*h 192 (batch 8,
    24 heads), 8 chunks of T 128, head dim 64, state 128, one group."""
    from repro_torch.kernels import ops

    dev = torch.device(DEVICE)
    b, h, g, nc, T, p, n = 8, 24, 1, 8, 128, 64, 128

    def t(a):
        return torch.from_numpy(a.astype(np.float32)).to(dev)

    x = t(rng.standard_normal((b * h, nc, T, p)))
    dt = t(rng.uniform(1e-3, 0.1, (b * h, nc, T)))
    A = t(-rng.uniform(1.0, 16.0, h))
    a = (dt * A.repeat(b)[:, None, None]).contiguous()
    B = t(rng.standard_normal((b, nc * T, g, n)))
    C = t(rng.standard_normal((b, nc * T, g, n)))
    got = ops.ssd_chunks(x, dt, a, B, C, heads=h)
    want = ops.ssd_chunks(x, dt, a, B, C, heads=h, impl="ref")
    torch.cuda.synchronize()
    err = 0.0
    for name, gt, wt in zip(("y_intra", "states", "c_decay", "chunk_decay"), got, want):
        if gt.shape != wt.shape or not bool(torch.isfinite(gt).all()):
            raise AssertionError(f"ssd_chunks {name}: bad output")
        e = float((gt - wt).abs().max())
        scale = float(wt.abs().max())
        if e > SSD_REL * scale:
            raise AssertionError(f"ssd_chunks {name}: max |err| {e} > {SSD_REL} x {scale}")
        err = max(err, e)
    # the least work: C B^T and M x on the causal triangle of each chunk,
    # and the chunk state, in f32 multiply-adds; each input read once and
    # each output written once
    tri = T * (T + 1) // 2
    n_ops = 2.0 * b * h * nc * (tri * n + tri * p + T * n * p)
    n_bytes = 4.0 * (2 * b * h * nc * T * p + 2 * b * h * nc * T + 2 * b * nc * T * g * n
                     + b * h * nc * (n * p + T * n + 1))
    bound, by = _bound_ms(n_bytes, n_ops)
    ms = _time_ms(torch, lambda: ops.ssd_chunks(x, dt, a, B, C, heads=h), 20)
    eager = _eager_ms(torch, lambda: ops.ssd_chunks(x, dt, a, B, C, heads=h), 20)
    plain_ms = _time_ms(torch, lambda: ops.ssd_chunks(x, dt, a, B, C, heads=h, impl="ref"), 3)
    print(f"[kernel] ssd_chunks bh={b * h} nc={nc} T={T} p={p} n={n}: {ms:.4f} ms (eager "
          f"calls {eager:.4f} ms, plain {plain_ms:.4f} ms, bound {bound * 1e3:.2f} us by {by}, "
          f"max |err| {err:.3g}) on {kind}", flush=True)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by, max_abs_err=err,
                library_ms=None)


def _port_energy_grid(np, torch, node_seed, app, n):
    """The port's predicted (F, P, E) grid of one (app, input), rebuilt from
    a fresh node of the same seed (deterministic: the same fit)."""
    from repro_torch.core import energy, power
    from repro_torch.core.characterize import CharacterizationSet
    from repro_torch.core.node_sim import FREQ_GRID, MAX_CORES, Node, PROFILES

    node = Node(seed=node_seed)
    pm = power.fit_power_model(*node.stress_grid())
    models = CharacterizationSet.from_node(node, sorted(PROFILES)).models_by_app(
        device=DEVICE)
    F, P, _, _, E = energy.energy_grid(
        pm, models[app], frequencies=tuple(FREQ_GRID),
        cores=range(1, MAX_CORES + 1), input_size=n)
    return F, P, E


def phase_paper_loop(torch, np):
    from repro_torch import obs
    from repro_torch.core import evaluate, power
    from repro_torch.core.node_sim import Node

    t0 = time.perf_counter()
    node = Node(seed=SEED)
    pm = power.fit_power_model(*node.stress_grid())
    t0 = _stage("paper loop: stress grid + power fit (host)", t0)
    with obs.recording() as rec:
        report = evaluate.compare_governors(
            node, power_model=pm, governor_cores=(1, 8, 32), repeats=1,
            device=DEVICE)
    t0 = _stage("paper loop: compare_governors (characterize, fit, 20 plans, "
                "240 governor runs)", t0)
    for ev in rec.trace.events():
        if ev["name"] == "svr.fit_exact":
            print(f"[stage] paper loop: svr.fit_exact span (Gram on the card + "
                  f"host KKT): {ev['dur'] / 1e6:.3f} s", flush=True)
    print(report.table(), flush=True)

    with open(GOLDEN) as f:
        gold_report = json.load(f)
    golden = gold_report["plans"]
    if len(report.plans) != len(golden) or len(golden) != 20:
        raise AssertionError(f"{len(report.plans)} plans vs {len(golden)} golden")
    near_ties = []
    for p, g in zip(report.plans, golden):
        if (p.app, p.input_size) != (g["app"], g["input_size"]):
            raise AssertionError(f"plan order differs: {p.app} vs {g['app']}")
        if not np.isfinite(p.predicted_energy_j) or p.predicted_energy_j <= 0:
            raise AssertionError(f"bad predicted energy {p}")
        if (p.frequency_ghz, p.cores) == (g["frequency_ghz"], g["cores"]):
            continue
        F, P, E = _port_energy_grid(np, torch, SEED, p.app, p.input_size)
        pick = E[(F == p.frequency_ghz) & (P == p.cores)][0]
        gold = E[(F == g["frequency_ghz"]) & (P == g["cores"])][0]
        rel = abs(gold - pick) / pick
        row = (f"{p.app} N={p.input_size:g}: port ({p.frequency_ghz}, {p.cores}) "
               f"vs golden ({g['frequency_ghz']}, {g['cores']}), port energies "
               f"{pick!r} vs {gold!r}, rel {rel:.3g}")
        if rel > NEAR_TIE_REL:
            raise AssertionError("plan differs from the golden: " + row)
        near_ties.append(row)
        print(f"[near-tie] {row}", flush=True)
    print(f"[paper loop] {20 - len(near_ties)} of 20 plans equal the JAX golden, "
          f"{len(near_ties)} near-ties; worst-case ratio "
          f"{report.worst_case_ratio!r}, best {report.best_case_ratio!r}, mean "
          f"{report.mean_ratio!r}", flush=True)
    if not near_ties:
        # same configs and the same simulator draws: the same measurements
        for key in ("worst_case_ratio", "best_case_ratio", "mean_ratio"):
            if getattr(report, key) != gold_report[key]:
                raise AssertionError(
                    f"{key} {getattr(report, key)!r} != golden {gold_report[key]!r}")
    # one repeat leaves a few % of simulated measurement noise on each run:
    # the tolerance of the reference's own full-grid ordering check
    if not report.plan_beats_all(tol=0.05):
        raise AssertionError(
            f"plan_beats_all(0.05) is False (best ratio {report.best_case_ratio!r})")
    return report


def _fleet_workloads(np):
    from repro_torch.core.engine import Constraints, Workload
    from repro_torch.core.node_sim import INPUT_SIZES, PROFILES
    from repro_torch.fleet.cluster import family_key

    rng = np.random.default_rng(SEED)
    apps = sorted(PROFILES)
    families = [(a, n) for a in apps for n in INPUT_SIZES]  # 20 families
    objectives = ("energy", "edp", "ed2p")
    ws = []
    for i in range(B_FLEET):
        app, n = families[i % len(families)]
        kind = int(rng.integers(5))
        if kind == 0:
            c = None
        elif kind == 1:
            c = Constraints(max_cores=16)
        elif kind == 2:  # deadline
            c = Constraints(max_time_s=float(rng.uniform(20.0, 3000.0)))
        elif kind == 3:
            c = Constraints(max_time_s=float(rng.uniform(50.0, 3000.0)),
                            max_cores=16, max_frequency_ghz=2.0)
        else:  # no grid point meets it: the on_infeasible fallback
            c = Constraints(max_time_s=1e-3, max_cores=16)
        ws.append(Workload(arch=app, terms=family_key(app, n),
                           objective=objectives[int(rng.integers(3))],
                           constraints=c))
    return ws


# the fused rounds' order: kernel, plain, plain, kernel, twice
ABBA = (None, "ref", "ref", None) * 2
ARM = {None: "kernel", "ref": "plain version"}


class _GcClock:
    """Seconds the cyclic garbage collector has run (a gc callback)."""

    def __init__(self):
        self.total_s = 0.0
        self._start_s = 0.0

    def __call__(self, phase, info):
        if phase == "start":
            self._start_s = time.perf_counter()
        else:
            self.total_s += time.perf_counter() - self._start_s


def _timed_round(label: str, fn, gc_clock: _GcClock):
    gc0, t0 = gc_clock.total_s, time.perf_counter()
    out = fn()
    print(f"[stage] {label}: {time.perf_counter() - t0:.3f} s (garbage collector "
          f"{gc_clock.total_s - gc0:.3f} s of it)", flush=True)
    return out


def phase_fleet(torch, np):
    from repro_torch.core import power
    from repro_torch.core.engine import PlanningEngine, cpu_space
    from repro_torch.core.node_sim import Node

    pm = power.fit_power_model(*Node(seed=7).stress_grid())
    eng = PlanningEngine(pm, space=cpu_space(), noise=0.01, seed=0, device=DEVICE)
    ws = _fleet_workloads(np)
    gc_clock = _GcClock()
    gc.callbacks.append(gc_clock)
    try:
        _fleet_rounds(np, eng, ws, gc_clock)
    finally:
        gc.callbacks.remove(gc_clock)


def _fleet_rounds(np, eng, ws, gc_clock):
    b = len(ws)
    fused = _timed_round(f"fleet: plan_many B={b} fused, cold (20 family fits)",
                         lambda: eng.plan_many(ws), gc_clock)
    runs = [_timed_round(f"fleet: plan_many B={b} fused {ARM[impl]}, warm",
                         lambda: eng.plan_many(ws, impl=impl), gc_clock)
            for impl in ABBA]
    exact = _timed_round(f"fleet: plan_many B={b} exact path",
                         lambda: eng.plan_many(ws, fused=False), gc_clock)
    bad = sum(any(r[i] != exact[i] for r in [fused, *runs]) for i in range(len(ws)))
    if bad:
        raise AssertionError(f"plan_many: {bad} of {len(ws)} plans differ across arms")
    if not all(np.isfinite(p.energy_per_step_j) and p.energy_per_step_j > 0
               for p in fused):
        raise AssertionError("plan_many: non-finite or non-positive energy")
    runs = [_timed_round(f"fleet: pareto_many B={b} fused {ARM[impl]}",
                         lambda: eng.pareto_many(ws, impl=impl), gc_clock)
            for impl in ABBA]
    fr = runs[0]
    fr_exact = _timed_round(f"fleet: pareto_many B={b} exact path",
                            lambda: eng.pareto_many(ws, fused=False), gc_clock)
    bad = sum(any(r[i] != fr_exact[i] for r in runs) for i in range(len(ws)))
    if bad:
        raise AssertionError(f"pareto_many: {bad} of {len(ws)} frontiers differ")
    if not all(fr_i for fr_i in fr):
        raise AssertionError("pareto_many: an empty frontier")
    n_pts = sum(len(f) for f in fr)
    print(f"[fleet] {len(ws)} plans and {n_pts} frontier points agree across "
          f"the kernel, plain and exact arms", flush=True)


def _reference_params(golden, arch_id: str) -> dict:
    """The JAX package's parameter pytree of one arch, from the golden's
    flattened ``<arch>/param/<dotted path>`` arrays."""
    prefix = f"{arch_id}/param/"
    tree: dict = {}
    for key in golden.files:
        if not key.startswith(prefix):
            continue
        *path, leaf = key[len(prefix):].split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = golden[key]
    tree["blocks"] = [tree["blocks"][str(i)] for i in range(len(tree["blocks"]))]
    return tree


def _kernel_of(arch_id: str) -> str:
    return "ssd_chunks" if arch_id.startswith("mamba") else "flash_attention"


def phase_serve_golden(torch, np):
    """SMOKE width on the card, with the kernels, on the JAX package's
    weights and prompts: logits and greedy tokens against its own."""
    from repro_torch import convert
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    golden = np.load(SERVE_GOLDEN)
    for arch_id in SERVE_ARCHS:
        arch = get_arch(arch_id)
        cfg = arch.smoke
        model = convert.lm_params_from_reference(_reference_params(golden, arch_id), cfg,
                                                 DEVICE)
        want_tokens = golden[f"{arch_id}/tokens"]
        gen = want_tokens.shape[1]
        gap = float(golden[f"{arch_id}/min_top2_gap"])
        if gap <= 2 * SERVE_GOLDEN_ATOL:
            raise AssertionError(f"{arch_id}: golden top-2 gap {gap} is within tolerance")
        name = _kernel_of(arch_id)
        before = ops.LAUNCHES[name]
        out = serve.run(arch, cfg, model, golden[f"{arch_id}/prompts"], gen)
        launched = ops.LAUNCHES[name] - before
        want_launches = cfg.n_layers * (1 if name == "ssd_chunks" else gen)
        if launched != want_launches:
            raise AssertionError(f"{arch_id}: {name} launched {launched} times, "
                                 f"not {want_launches}")
        err_prefill = float(np.abs(out.prefill_logits.cpu().numpy()
                                   - golden[f"{arch_id}/prefill_logits"]).max())
        step = torch.stack(out.step_logits).cpu().numpy()
        err_steps = float(np.abs(step - golden[f"{arch_id}/step_logits"]).max())
        got_tokens = out.tokens.cpu().numpy()
        print(f"[serve golden] {arch_id} SMOKE on the card: prefill logits max |err| "
              f"{err_prefill:.3g}, {gen - 1} decode steps max |err| {err_steps:.3g} "
              f"(tolerance {SERVE_GOLDEN_ATOL}), tokens equal: "
              f"{bool((got_tokens == want_tokens).all())}, {name} launches {launched}",
              flush=True)
        if max(err_prefill, err_steps) > SERVE_GOLDEN_ATOL:
            raise AssertionError(f"{arch_id}: logits differ from the JAX golden")
        if not (got_tokens == want_tokens).all():
            raise AssertionError(f"{arch_id}: greedy tokens differ from the JAX golden")


def phase_serve_full(torch, np):
    """Full width through launch.serve.main (the kernel arms, counted from
    0), then the plain arms on the same weights, teacher-forced."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    for arch_id in SERVE_ARCHS:
        # the first full-width call pays for cuBLAS's handles and heuristics
        # and the allocator's pools; its times are printed, not kept
        cold = serve.main(["--arch", arch_id, *SERVE_ARGV])
        print(f"[serve] {arch_id} warm-up run: prefill {cold.prefill_s * 1e3:.1f} ms, "
              f"decode {cold.decode_s * 1e3:.1f} ms", flush=True)
        del cold
    ops.reset_launches()  # the serving path's launches are counted from here
    runs = {}
    for arch_id in SERVE_ARCHS:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        runs[arch_id] = serve.main(["--arch", arch_id, *SERVE_ARGV])
        print(f"[serve] {arch_id} kernel arm: serve.main {time.perf_counter() - t0:.3f} s "
              f"(weights included), peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    launches = dict(ops.LAUNCHES)
    print(f"[serve] launches over both kernel arms: {json.dumps(launches)}", flush=True)
    args = dict(zip(SERVE_ARGV[::2], (int(v) for v in SERVE_ARGV[1::2])))
    gen = args["--gen"]
    from repro_torch.configs import get_arch
    want = {"flash_attention": get_arch("starcoder2-3b").full.n_layers * gen,
            "ssd_chunks": get_arch("mamba2-130m").full.n_layers}
    for name, n in want.items():
        if launches[name] != n:
            raise AssertionError(f"{name}: {launches[name]} launches, not {n}")

    for arch_id in SERVE_ARCHS:
        kernel_run = runs[arch_id]
        arch, cfg, model = serve.build(arch_id, seed=0)
        prompts = serve.make_prompts(cfg, args["--batch"], args["--prompt-len"], 0)
        before = dict(ops.LAUNCHES)
        plain = serve.run(arch, cfg, model, prompts, gen, impl="ref",
                          forced=kernel_run.tokens)
        if dict(ops.LAUNCHES) != before:
            raise AssertionError(f"{arch_id}: the plain arm launched a kernel")
        pairs = [(kernel_run.prefill_logits, plain.prefill_logits),
                 *zip(kernel_run.step_logits, plain.step_logits)]
        scale = max(float(k.abs().max()) for k, _ in pairs)
        errs = [float((k - p).abs().max()) for k, p in pairs]
        finite = all(bool(torch.isfinite(k).all()) for k, _ in pairs)
        agree = float((kernel_run.tokens == plain.tokens).float().mean())
        print(f"[serve] {arch_id} plain arm (teacher-forced): prefill {plain.prefill_s * 1e3:.1f}"
              f" ms, decode {plain.decode_s * 1e3:.1f} ms; kernel vs plain logits max |err| "
              f"prefill {errs[0]:.4g}, steps {max(errs[1:]):.4g}, max |logit| {scale:.4g} "
              f"(tolerance {SERVE_FULL_REL} x that); greedy picks equal in "
              f"{agree * 100:.1f}% of positions", flush=True)
        if not finite:
            raise AssertionError(f"{arch_id}: non-finite logits")
        if max(errs) > SERVE_FULL_REL * scale:
            raise AssertionError(f"{arch_id}: kernel and plain arms disagree")
        del model, plain
        torch.cuda.empty_cache()
    return launches


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    src = os.path.join(HERE, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print("chip_smoke: run from a checkout (src/repro_torch is missing)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, src)
    from repro_torch.kernels import ops

    t_start = time.perf_counter()
    kind, smi = phase_device(torch)
    t0 = _stage("device", t_start)
    phase_build()
    t0 = _stage("build", t0)
    results = phase_kernels(torch, np, kind)
    t0 = _stage("kernels against their plain versions", t0)

    ops.reset_launches()  # the main path's launches are counted from here
    phase_paper_loop(torch, np)
    t0 = _stage("paper loop", t0)
    phase_fleet(torch, np)
    t0 = _stage("fleet-scale planning", t0)
    launches = dict(ops.LAUNCHES)
    phase_serve_golden(torch, np)
    t0 = _stage("serve: SMOKE golden on the card", t0)
    serve_launches = phase_serve_full(torch, np)
    t0 = _stage("serve: full width, kernel and plain arms", t0)
    for name in ("flash_attention", "ssd_chunks"):
        launches[name] = serve_launches[name]

    sources = {
        "rbf_gram": ("src/repro_torch/kernels/csrc/rbf_gram.cu",
                     "src/repro/kernels/rbf_gram.py:42"),
        "plan_argmin": ("src/repro_torch/kernels/csrc/plan_grid.cu",
                        "src/repro/kernels/plan_grid.py:49"),
        "pareto_mask": ("src/repro_torch/kernels/csrc/plan_grid.cu",
                        "src/repro/kernels/plan_grid.py:110"),
        "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:121"),
        "ssd_chunks": ("src/repro_torch/kernels/csrc/ssd_scan.cu",
                       "src/repro/kernels/ssd_scan.py:75"),
    }
    line = []
    for name, (source, replaces) in sources.items():
        r = results[name]
        if launches[name] <= 0:
            raise AssertionError(f"{name} never launched on the main path")
        entry = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r.get("library_ms"),
        }
        if "decode_max_abs_err" in r:
            entry["decode_max_abs_err"] = r["decode_max_abs_err"]
        line.append(entry)
    print(f"[total] {time.perf_counter() - t_start:.1f} s on {smi}", flush=True)
    print(json.dumps({"kernels": line}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
