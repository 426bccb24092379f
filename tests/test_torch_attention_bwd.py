"""The Hopper attention backward's host side (``kernels/attention_bwd.py``,
``csrc/attention_bwd.cu``): which calls it takes, what the autograd
wrapper saves for it, its kernels' names, and the benchmark's reading of
its roofline. Its arithmetic is held against the plain backward on the
card (``tests/test_torch_gpu.py``).
"""

import os
import re

import pytest
import torch

from chipbench import flops, peaks, spec
from repro_torch.kernels import attention_bwd, ops

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc")
BENCH = spec.Spec(ROOT)


@pytest.mark.parametrize("d", [16, 32, 64, 96, 112, 128, 256, 48])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_the_kernel_takes_bf16_at_its_head_dims(dtype, d):
    """bf16 at 16 to 128 (96 and 112 padded); f32 keeps the caller's
    precision and d 256 wants tiles of its own: both stay plain."""
    q = torch.zeros((1, 2, 4, d), dtype=dtype)
    want = dtype == torch.bfloat16 and d in (16, 32, 64, 96, 112, 128)
    assert attention_bwd.takes(q) == want


def test_the_wrapper_refuses_host_tensors():
    q = torch.zeros((1, 2, 8, 64), dtype=torch.bfloat16)
    lse = torch.zeros((1, 2, 8))
    with pytest.raises(ValueError, match="CUDA tensor"):
        attention_bwd.attention_bwd_cuda(q, q, q, q, lse, q, causal=True, window=None,
                                         scale=None, q_offset=0, kv_len=None)
    with pytest.raises(ValueError, match="no kernel"):
        attention_bwd.attention_bwd_cuda(q.float(), q, q, q, lse, q, causal=True, window=None,
                                         scale=None, q_offset=0, kv_len=None)


@pytest.mark.parametrize("impl", [None, "ref"])
def test_the_plain_backward_saves_the_inputs_alone(impl):
    """On the host (and for the plain arm) the Function saves (q, k, v) and
    the backward recomputes (out, lse), as the reference's ``_flash_vjp``:
    the dry run counts the reference's algorithm."""
    q, k, v = (torch.randn(s, requires_grad=True)
               for s in ((1, 4, 10, 16), (1, 2, 10, 16), (1, 2, 10, 16)))
    out = ops.flash_attention(q, k, v, impl=impl)
    assert len(out.grad_fn.saved_tensors) == 3
    with torch.no_grad():
        assert ops.flash_attention(q, k, v, impl=impl).grad_fn is None


def test_every_kernel_of_the_backward_is_named_attn_bwd():
    """The benchmark's forward roofline sums the kernels named ``flash_``
    and the backward's sums those named ``attn_bwd``: no kernel of the
    backward may fall under the forward's name, and each must fall under
    its own."""
    with open(os.path.join(CSRC, "attention_bwd.cu")) as f:
        text = f.read()
    names = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(", text)
    assert len(names) == 3
    for name in names:
        assert "attn_bwd" in name and "flash_" not in name, name
    with open(os.path.join(CSRC, "flash_attention.cu")) as f:
        fwd = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(",
                         f.read())
    assert fwd and all("flash_" in n and "attn_bwd" not in n for n in fwd)


def test_the_source_carries_its_note():
    """It replaces no TPU kernel (the reference's backward is jnp), and
    says so, with what bounds it and its design; the accurate exp2f."""
    with open(os.path.join(CSRC, "attention_bwd.cu")) as f:
        text = f.read()
    head = text[: text.index("#include")]
    assert "Replaces no TPU kernel" in head and "src/repro/kernels/ops.py:_flash_vjp" in head
    assert "bounds it on an H100" in head and "Design" in head
    assert "__expf" not in text and "ex2.approx" not in text


def _record(launches, kernels):
    step = {"profiled": True, "b": 2, "s": 4096,
            "launches": {"flash_attention": 60, **launches}}
    return {"config": BENCH.config("starcoder2-3b"), "steps": [step, dict(step)],
            "trace": {"kernels": kernels}}


KERNELS = {
    "void (anonymous namespace)::attn_bwd_kernel<128>((anonymous namespace)::BwdParams)": 0.09,
    "void (anonymous namespace)::attn_bwd_prep_kernel(...)": 0.002,
    "void (anonymous namespace)::attn_bwd_convert_kernel(...)": 0.004,
    "void (anonymous namespace)::flash_mma_tile_kernel<128>(...)": 0.11,
}


def test_the_backward_roofline_reads_launches_times_bound_over_busy():
    reader = BENCH.load("metrics", "attention_bwd_roofline.train")
    cfg = BENCH.config("starcoder2-3b")
    ops_fwd, bytes_fwd = flops.attention_launch(cfg, 2, 4096)
    # the four products over the causal pairs: 8 d flops a (query, key) pair
    assert reader.work(cfg, 2, 4096)[0] == 2 * ops_fwd == 8 * 2 * 24 * 128 * (4096 * 4097 // 2)
    assert reader.work(cfg, 2, 4096)[1] == 2 * bytes_fwd + 4 * 2 * 24 * 4096
    bound = flops.bound_s(*reader.work(cfg, 2, 4096), peaks.BF16_OPS_PER_S)
    assert bound == pytest.approx(4.17e-4, rel=1e-3)  # operations: 412 GFLOP at 989 TFLOP/s
    got = reader.read(_record({"attention_bwd": 30}, KERNELS))
    assert got == pytest.approx(100.0 * 2 * 30 * bound / 0.096, rel=1e-12)
    # the forward's reading counts the forward's kernel alone
    fwd = BENCH.load("metrics", "flash_attention_roofline.train")
    want = 100.0 * 2 * 60 * flops.bound_s(*flops.attention_launch(cfg, 2, 4096),
                                          peaks.BF16_OPS_PER_S) / 0.11
    assert fwd.read(_record({"attention_bwd": 30}, KERNELS)) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("launches", [{}, {"attention_bwd": 0}])
def test_the_backward_roofline_is_none_without_its_launches(launches):
    """A parent whose backward is the plain one counts no launch."""
    reader = BENCH.load("metrics", "attention_bwd_roofline.train")
    assert reader.read(_record(launches, KERNELS)) is None
    no_kernels = {k: v for k, v in KERNELS.items() if "attn_bwd" not in k}
    assert reader.read(_record({"attention_bwd": 30}, no_kernels)) is None
