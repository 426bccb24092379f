"""The harness on ``zamba2-7b.prefill_mix`` at SMOKE width on the host: the
cell's configuration file cut to tiny widths (``data/smoke-zamba2.json``,
the same layout: two shared blocks in turn at three hybrid layers), the
reference's family ``zamba2`` and the adapter, against the port in
float32; and the family's counts at the published widths."""

import math
import os

import pytest

from chipbench import flops, spec
from chipbench.reference import lm
from chipbench.tests import smoke

CELL = "zamba2-7b.prefill_mix"
BENCH = spec.Spec(smoke.ROOT)


@pytest.fixture
def zamba2(monkeypatch):
    monkeypatch.setitem(smoke.CONFIGS, "zamba2-7b", "smoke-zamba2.json")


def test_prefill_agrees_with_the_reference(zamba2):
    result = smoke.run(CELL)
    gaps = {k: v["value"] for k, v in result["checks"].items()}
    assert gaps["token_gap"] == 0.0 and gaps["kv_gap"] < 1e-5, gaps
    assert result["correct"] and result["attempted"] >= 1 and result["failed"] == 0


def test_traced_run_reads_its_metrics(zamba2):
    """``step_mfu.prefill`` reads the batches' times; the SSD kernel's
    roofline reads launches of the card's kernel, which the host does not
    make: the reader finds nothing and the line leaves it out."""
    result = smoke.run(CELL, trace=True)
    assert result["correct"]
    assert 0 < result["metrics"]["step_mfu.prefill"]["value"] < 100
    assert "ssd_chunks_roofline.prefill" not in result["metrics"]
    assert BENCH.load("metrics", "ssd_chunks_roofline.prefill").read(
        {"steps": [{"b": 4, "s": 16, "profiled": True, "launches": {}}],
         "trace": {"kernels": {}}, "config": smoke.config("zamba2-7b")}) is None


def test_the_published_counts():
    """7,356,749,648 weights (the shared blocks' once); the forward's
    matrices count a shared block once a call; the compared cache is the
    last hybrid layer's."""
    cfg = BENCH.config("zamba2-7b")
    assert sum(math.prod(shape) for _, shape, _ in lm.param_specs(cfg)) == 7_356_749_648
    m = lm.dims(cfg)
    assert flops.matrix_weights(cfg) - m["vocab"] * m["d"] == 10_914_223_104
    assert lm.last_kv_layer(cfg) == 77
    assert (m["h"], m["hk"], m["dh"], m["heads"], m["g"], m["n"], m["p"]) == \
        (32, 32, 224, 112, 2, 64, 64)
    s = 4096
    attention = 4.0 * 32 * 224 * s * (s + 1) // 2
    assert flops.attention_launch(cfg, 1, s)[0] == attention  # at the true d 224
    ssd_ops, _ = flops.ssd_chunks_launch(cfg, 1, s)
    assert flops.mixer_forward(cfg, 1, s) - 13 * attention > 81 * ssd_ops


def test_the_depth_witness_reads_round_off_growing_with_depth():
    """``scripts/zamba2_gap_witness.py depth``, the reading behind the
    cell's wide limits, at 8 and 27 layers: the port's bf16 ``kv_gap``
    against the float32 reference grows with the layers, the port's
    float32 one stays at round-off."""
    import importlib.util

    path = os.path.join(smoke.ROOT, "scripts", "zamba2_gap_witness.py")
    module_spec = importlib.util.spec_from_file_location("zamba2_gap_witness", path)
    witness = importlib.util.module_from_spec(module_spec)
    module_spec.loader.exec_module(witness)
    rows = witness.depth_arm(2718281829, [8, 27])["rows"]
    assert [r["hybrid_layer_ids"] for r in rows] == [[1, 3, 6], [6, 11, 17, 23]]
    assert 1e-3 < rows[0]["bfloat16"]["kv_gap"] < rows[1]["bfloat16"]["kv_gap"]
    assert all(r["float32"]["kv_gap"] < 1e-5 and r["float32"]["token_gap"] == 0 for r in rows)
