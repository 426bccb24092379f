"""``flops.py`` against counts made by hand from the published widths."""

import pytest

from chipbench import flops, peaks, spec
from chipbench.tests import smoke

BENCH = spec.Spec(smoke.ROOT)
STARCODER = BENCH.config("starcoder2-3b")
MAMBA = BENCH.config("mamba2-130m")


def test_starcoder2_weights_and_training_step():
    # a layer: q (3072 x 3072), k and v (3072 x 256 each), o (3072 x 3072),
    # up and down (3072 x 12288 each); the tied logits 49152 x 3072
    layer = 3072 * 3072 * 2 + 3072 * 256 * 2 + 3072 * 12288 * 2
    assert layer == 95_944_704
    assert flops.matrix_weights(STARCODER) == 30 * layer + 49152 * 3072 == 3_029_336_064
    # causal attention: QK^T and PV, 2 x 2 x 128 flops a (query, key) pair
    # of the 4096 * 4097 / 2 each of 24 heads of 2 sequences sees, 30 layers
    attention = 4 * 2 * 24 * 128 * (4096 * 4097 // 2) * 30
    step = 3 * (2 * 3_029_336_064 * 2 * 4096 + attention)
    assert flops.train_step(STARCODER, 2, 4096) == pytest.approx(step, rel=1e-12)
    assert step == pytest.approx(1.676e14, rel=1e-3)


def test_mamba2_weights_and_training_step():
    # in_proj 768 x (2*1536 + 2*128 + 24), the conv's 4 taps of 1536 + 256
    # channels, out_proj 1536 x 768; the tied logits 50280 x 768
    layer = 768 * 3352 + 4 * 1792 + 1536 * 768
    assert flops.matrix_weights(MAMBA) == 24 * layer + 50280 * 768 == 128_882_688
    # the SSD a layer: 32 chunks of 128 a sequence; C B^T of the one group on
    # the chunk's causal triangle (8256 pairs, n 128), and a head each:
    # M x on the triangle (p 64), the chunk state and its read-out
    # (2 x 128 x 128 x 64 each), the state passed on (128 x 64)
    chunk = 2 * 8256 * 128 + 24 * (2 * 8256 * 64 + 4 * 128 * 128 * 64 + 2 * 128 * 64)
    ssd = 2 * 32 * chunk * 24
    assert flops.mixer_forward(MAMBA, 2, 4096) == ssd
    assert flops.train_step(MAMBA, 2, 4096) == 3 * (2 * 128_882_688 * 8192 + ssd)


def test_prefill_counts_the_logits_on_the_last_position_only():
    layers = 30 * 95_944_704
    attention = 4 * 16 * 24 * 128 * (1024 * 1025 // 2) * 30
    want = 2 * layers * 16 * 1024 + attention + 2 * 49152 * 3072 * 16
    assert flops.prefill(STARCODER, 16, 1024) == want


def test_kernel_bounds_match_the_ported_kernels_table():
    """The bounds ``chip_smoke.py`` phase 3 prints for these shapes."""
    ops, n_bytes = flops.attention_launch(STARCODER, 2, 4096)
    assert flops.bound_s(ops, n_bytes, peaks.BF16_OPS_PER_S) * 1e3 == pytest.approx(0.2085,
                                                                                     abs=1e-4)
    ops, n_bytes = flops.attention_launch(STARCODER, 8, 1024)
    assert flops.bound_s(ops, n_bytes, peaks.BF16_OPS_PER_S) * 1e3 == pytest.approx(0.0522,
                                                                                     abs=1e-4)
    # ssd_chunks at training: bytes-bound, 262 MB of f32 in and out
    ops, n_bytes = flops.ssd_chunks_launch(MAMBA, 2, 4096)
    assert n_bytes == 4 * (48 * 32 * 128 * 66 + 2 * 2 * 4096 * 128
                           + 48 * 32 * (128 * 64 + 128 * 64 + 128 * 128 + 1))
    assert flops.bound_s(ops, n_bytes, peaks.TF32_OPS_PER_S) * 1e3 == pytest.approx(0.0781,
                                                                                    abs=1e-4)
