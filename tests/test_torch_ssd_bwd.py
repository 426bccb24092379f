"""The Hopper SSD backward's host side (``kernels/ssd_bwd.py``,
``csrc/ssd_bwd.cu``): its kernels' names, its source note, the launcher
signatures, and the benchmark's reading of its roofline. Its arithmetic is
held against the plain VJP on the card (``tests/test_torch_gpu.py``).
"""

import os
import re

import pytest

from chipbench import flops, peaks, spec
from repro_torch.kernels import _build

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc")
BENCH = spec.Spec(ROOT)
KERNEL_RE = r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\("


def _source(name):
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


def test_every_kernel_of_the_backward_is_named_ssd_bwd():
    """``ssd_chunks_roofline`` sums the kernels whose name holds
    ``ssd_chunk`` and ``ssd_bwd_roofline`` those that hold ``ssd_bwd``: no
    kernel of the backward may fall under the forward's name."""
    names = re.findall(KERNEL_RE, _source("ssd_bwd.cu"))
    assert names == ["ssd_bwd_intra_kernel", "ssd_bwd_state_kernel", "ssd_bwd_finish_kernel"]
    fwd = re.findall(KERNEL_RE, _source("ssd_scan.cu"))
    assert fwd and all("ssd_chunk" in n and "ssd_bwd" not in n for n in fwd)


def test_the_source_carries_its_note():
    """It replaces no TPU kernel (the reference's backward is jnp), and
    says so, with what bounds it and its design; the accurate expf, and no
    float atomics (the gradients repeat bit for bit): the one atomic adds
    to the int counter that hands out the Z rows."""
    text = _source("ssd_bwd.cu")
    head = text[: text.index("#include")]
    assert "Replaces no TPU kernel" in head and "src/repro/kernels/ops.py:_ssd_vjp" in head
    assert "bounds it on an H100" in head and "Design" in head
    assert "__expf" not in text and "ex2.approx" not in text
    code = text[text.index("#include"):]
    assert re.findall(r"atomic\w*\(([^,]*),", code) == ["next_item + hh"]
    assert not re.search(r"\bred\.", code) and "cp.reduce" not in code


def test_the_launchers_take_what_the_sources_declare():
    """ctypes passes each argument as its signature says: as many pointers
    and ints as the C launcher declares, the stream last."""
    text = _source("ssd_bwd.cu")
    for fn in ("ssd_bwd_intra_launch", "ssd_bwd_state_launch"):
        decl = text[text.index(f'extern "C" int {fn}('):]
        params = decl[decl.index("(") + 1: decl.index(")")].split(",")
        kinds = ["p" if "*" in q else "i" for q in params]
        want = ["p" if t is _build._P else "i" for t in _build._SIGNATURES[fn]]
        assert kinds == want, fn


def _record(launches, kernels):
    step = {"profiled": True, "b": 2, "s": 4096, "launches": {"ssd_chunks": 48, **launches}}
    return {"config": BENCH.config("mamba2-130m"), "steps": [step, dict(step)],
            "trace": {"kernels": kernels}}


KERNELS = {
    "(anonymous namespace)::ssd_bwd_intra_kernel((anonymous namespace)::IntraArgs, int, int)": 0.02,
    "(anonymous namespace)::ssd_bwd_state_kernel((anonymous namespace)::StateArgs, int, int)": 0.008,
    "(anonymous namespace)::ssd_bwd_finish_kernel((anonymous namespace)::FinishArgs)": 0.002,
    "(anonymous namespace)::ssd_chunk_kernel((anonymous namespace)::Args, int, int)": 0.03,
}


def test_the_backward_roofline_reads_launches_times_bound_over_busy():
    reader = BENCH.load("metrics", "ssd_bwd_roofline.train")
    cfg = BENCH.config("mamba2-130m")
    ops, n_bytes = reader.work(cfg, 2, 4096)
    fwd_ops, _ = flops.ssd_chunks_launch(cfg, 2, 4096)
    # twice the forward's products: the chunk block's and the read-out's T*n*p a head
    assert ops == 2 * (fwd_ops + 2 * 32 * 24 * (2.0 * 128 * 128 * 64))
    assert ops == pytest.approx(16.40e9, rel=1e-3)
    # x, dY, dx, G, H, Z at 12.6 M elements; B, C, dB, dC; dt and ddt
    assert n_bytes == 4 * (6 * 48 * 32 * 128 * 64 + 4 * 2 * 4096 * 128 + 2 * 48 * 4096)
    bound = flops.bound_s(ops, n_bytes, peaks.TF32_OPS_PER_S)
    assert bound == pytest.approx(9.56e-5, rel=1e-3)  # bytes: 320 MB at 3.35 TB/s
    got = reader.read(_record({"ssd_bwd": 24}, KERNELS))
    assert got == pytest.approx(100.0 * 2 * 24 * bound / 0.03, rel=1e-12)
    # the forward's reading counts the forward's kernel alone
    fwd = BENCH.load("metrics", "ssd_chunks_roofline.train")
    want = 100.0 * 2 * 48 * flops.bound_s(*flops.ssd_chunks_launch(cfg, 2, 4096),
                                          peaks.TF32_OPS_PER_S) / 0.03
    assert fwd.read(_record({"ssd_bwd": 24}, KERNELS)) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("launches", [{}, {"ssd_bwd": 0}])
def test_the_backward_roofline_is_none_without_its_launches(launches):
    """A parent whose backward is the plain VJP counts no launch."""
    reader = BENCH.load("metrics", "ssd_bwd_roofline.train")
    assert reader.read(_record(launches, KERNELS)) is None
    no_kernels = {k: v for k, v in KERNELS.items() if "ssd_bwd" not in k}
    assert reader.read(_record({"ssd_bwd": 24}, no_kernels)) is None


def test_the_benchmark_reads_it_in_the_mamba2_training_cell_only():
    entry = {m["name"]: m for m in BENCH.data["per_layer"]}["ssd_bwd_roofline.train"]
    assert entry["layer"] == "kernels" and entry["moves"] == "train_tokens_per_s"
    assert entry["workloads"] == ["mamba2-130m.train_4k"]
    assert [m["name"] for m in BENCH.per_layer("mamba2-130m.train_4k")].count(
        "ssd_bwd_roofline.train") == 1
    assert all(m["name"] != "ssd_bwd_roofline.train"
               for w in ("starcoder2-3b.train_4k", "zamba2-7b.prefill_mix")
               for m in BENCH.per_layer(w))
