#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA card.

    python3 chip_smoke.py          # from the root of a checkout, one card

Phases (every failure raises; nothing is caught):

1. device: the card's name and power limit; TF32 off.
2. build: nvcc builds the Hopper kernels from src/repro_torch/kernels/csrc/.
3. kernels: each kernel against its plain PyTorch version on the card, at
   the main paths' shapes (exact for plan_argmin / pareto_mask and the
   int8 codec, within the stated tolerances for the others), timed beside
   its bound: many calls
   captured in one CUDA graph and replayed between CUDA events, so the
   host's dispatch is not in the time (eager back-to-back calls are printed
   beside it). rbf_gram at the paper loop's, the engine's and Table 1's
   fold shapes;
   plan_argmin at B = 10,000, G = 352; pareto_mask at B = 10,000,
   G = 352 (the per-row sort) and at G = 1,500 (past the sort's 1,024
   slots: all pairs). flash_attention at
   starcoder2-3b's prefill, decode and training shapes, at gemma3-12b's
   local attention (head dim 256, window 1,024: a 4,096 sequence and a
   decode step) and at phase 6b's other serving shapes (gemma3-12b's
   prefill, ring decode step and global decode step at head dim 256,
   granite-20b's MQA decode step of 48 query heads over one KV head,
   granite-moe-1b-a400m's prefill and decode at head dim 64), at the rest
   of the zoo's (whisper-medium's bidirectional encoder over 1,500 frames,
   its cross-attention at prefill and decode and its causal self-attention;
   phi-3-vision-4.2b's prefill of 576 patches + 1,024 tokens and decode at
   head dim 96, zamba2-7b's shared attention at 112, both padded to 128,
   with the padding's own cost a decode step), at Zamba2-7B-Instruct's
   shared blocks (head dim 224 padded to 256, softmax scale 112^-1/2: the
   three prefill batches of chipbench's zamba2-7b.prefill_mix, 16 x 1,024,
   8 x 2,048 and 4 x 4,096, and decode steps over 1,055 and 4,096 keys,
   with the padding's cost), its output and its lse (with
   F.scaled_dot_product_attention, given the window's mask, timed as the
   library yardstick; the port never calls it), ssd_chunks at mamba2-130m's
   prefill and training shapes and zamba2-7b's prefill (two groups of 56
   heads, state 64; at b 8, and at the prefill_mix cell's 16 x 1,024 and
   4 x 4,096), the int8 codec at starcoder2-3b's embedding
   and MLP weights, a ragged size and edge blocks (zero, NaN, inf,
   half-way), the attention backward kernel at starcoder2-3b's
   training shape against the plain backward (SDPA's backward timed as
   its library yardstick), and the SSD backward kernels at mamba2-130m's
   training shape and Zamba2-7B-Instruct's heads (b 16 x 8 chunks)
   against the plain VJP (every gradient, timed beside its bound).
4. paper loop: evaluate.compare_governors at full characterization
   (11 f x 32 cores x 5 inputs, 4 apps: a (4, 1760, 1760) Gram), all 20
   plans, governors at the --quick settings; the plans are held against
   tests/data/torch_port_eval_golden.json (written by the JAX package).
   rbf_gram's launches in phases 4-5 are printed by shape.
4b. table1: the paper's Table 1 (§3.4), Characterization.cross_validate(
   k=10) of the four apps at full characterization (Node(seed=42), 1,760
   samples each: 40 fits at 1,584 samples, 80 predictions of 176) against
   the JAX package's (MAE, PAE) in tests/data/torch_port_table1_golden.json
   within TABLE1_REL; grid_search on the quick blackscholes set (its C and
   gamma); fit_many(iters=50), the ISTA polish, on the four quick sets (its
   predictions over the (f, p) grid within ISTA_PRED_REL). Its launches are
   counted on their own and printed by shape.
5. fleet-scale planning: plan_many / pareto_many over B = 10,000 workloads
   of 20 families; the fused kernel path, its plain version and the exact
   path must agree exactly. The kernel and plain rounds run twice in the
   order kernel, plain, plain, kernel, so that run order shows in their
   times; each round's time is printed with the seconds the garbage
   collector ran inside it.
5b. fleet simulation: python -m repro_torch.fleet on the card (4 nodes;
   the default run of 32 jobs on the paper's grids, --quick, --quick
   --horizon 600 --burst 3, --quick --fallback) against
   tests/data/torch_port_fleet_golden.json (written by the JAX package):
   the engine scenario's completed jobs equal the golden's, or the first
   differing placement is a near-tie within NEAR_TIE_REL on the port's own
   surface and the rest within FLEET_ENERGY_REL of total energy with equal
   misses; the governor scenarios bit for bit. Each job placed as the
   golden placed it predicts its energy within FLEET_PRED_REL of the
   golden's, and a control (the --quick run on a Gram rounded to
   CONTROL_BITS mantissa bits) must be refused. Its launches of rbf_gram,
   plan_argmin and pareto_mask are counted on their own and printed by
   shape; every call is replayed, kernel against plain version, and each
   kernel is timed on the fleet's own inputs at the smallest and the
   largest of those shapes.
5c. fleet service and apps: (1) the default run, --quick --horizon 600
   --burst 3 and --quick --fallback (cheapest-first: plan_many, so
   plan_argmin) through python -m repro_torch.fleet --service --journal
   (under build/chip_smoke_service/), each equal bit for bit to phase 5b's
   lockstep run of the same arguments (and through it held to the JAX
   golden); (2) each killed with --kill-at before an early, a middle and a
   late batch and resumed by --resume in a fresh main: the uninterrupted
   service's schedule bit for bit, in as many batches (a late kill's
   journal holds a belief, which the recovery re-fits on the card); (3)
   the JAX package's killed --quick --service journal
   (tests/data/torch_port_service_journal.json) resumed on the card
   against the reference's uninterrupted schedule
   (tests/data/torch_port_service_golden.json) under the near-tie rule and
   FLEET_PRED_REL. The planning kernels' launches of (1)-(3) are counted
   from 0, printed by shape, every call replayed kernel against plain
   version, and added to the launches line (service_launches). Then (4)
   one fault of each kind on the --quick pool with heartbeats every 150 s
   (node-down, heartbeat-loss, journal-torn and a resume), each landing
   and ending with zero lost jobs and the honest ledger; (5) svr.fit_many
   of three sets alone and in one batch, bit for bit on the card; (6) the
   four PARSEC apps at DEFAULT_N against tests/data/torch_port_apps_golden.npz
   (swaptions within 4 joint standard errors: its draws are the card's),
   then at native sizes (blackscholes 10M options, swaptions 128, raytrace
   1,024 x 1,024, fluidanimate 8,192 particles, three steps) with the
   reference's domain properties. Every run, resume and app prints its
   wall time beside the card's name and power limit.
5d. mixed fleet: python -m repro_torch.fleet --quick --mixed (a mixed CPU
   + TPU pool, the zoo's TPU jobs characterized by the analytic roofline)
   against the fleet golden's "mixed" entry as in 5b; then --service
   --journal (bit for bit against the lockstep run, and against the JAX
   package's service run under the near-tie rule), killed before its
   middle batch at the golden's kill point and resumed (bit for bit); then
   launch.train --arch mamba2-130m --smoke --auto-energy, its logged plan
   against the JAX package's (the golden's "auto_energy" entry). The
   planning kernels' launches are counted from 0, printed by shape and
   every call replayed against the plain version, as in 5b.
6. serve: (a) all ten archs at SMOKE width on the card, with the
   kernels, on the weights, prompts (whisper's frames, phi-3-vision's
   patches) of tests/data/torch_port_serve_golden.npz (the JAX package's
   own weights, or weights drawn from the seed it names): prefill logits,
   every decode step's logits, the greedy tokens against the JAX
   package's and each kernel's launches; (b) full width, batch 8, gen 32,
   random weights from a seed: launch.serve.main (prompt 1,024) for
   starcoder2-3b, mamba2-130m, gemma3-12b, granite-20b,
   granite-moe-1b-a400m and zamba2-7b, serve.run with 576 image patches +
   1,024 tokens for phi-3-vision-4.2b and with 1,500 encoder frames under
   a prompt of 64 for whisper-medium; one model on the card at a time,
   once to warm up and once counted (prefill ms, decode tok/s, peak
   memory, each kernel's launches and flash_attention's by path and head
   dim), then the plain arm (impl="ref") on the same weights and inputs,
   fed the kernel arm's tokens: prefill and step logits must agree within
   SERVE_FULL_REL of their scale; (c) Zamba2-7B-Instruct's layout
   (configs/zamba2_7b): PUBLISHED_SMOKE in f32, kernel arm against plain
   arm through serve.run; then PUBLISHED at full width (7,356,749,648
   weights) at the prefill_mix cell's three batches, launches zeroed just
   before each prefill and each decode step after it: 13 flash_attention
   and 81 ssd_chunks a prefill, 13 flash_attention a step.
7. train golden: starcoder2-3b and mamba2-130m at SMOKE width on the
   card, with the kernels, on the JAX package's weights and its pipeline's
   batches: three steps of launch.steps.make_train_step and three of the
   compressed step of launch.train (int8 error feedback over a one-rank
   NCCL group) against tests/data/torch_port_train_golden.npz.
8. train starcoder2-3b at full width (batch 2 x seq 4,096, random weights
   from a seed) with the compressed step launch.train --compress builds:
   2 warm steps, 3 counted (step time, tokens/s, peak memory, launches a
   step against their expectation), one step taken apart (with the
   attention kernel's forward and (out, lse) recompute, and the plain
   attention backward, timed at one layer's shape); then the kernel arm
   against the plain arm (impl="ref") on one forward and backward without
   an update.
9. train mamba2-130m at full width through launch.train.main --compress
   (batch 2 x seq 4,096, 4 steps, checkpoints every 2 under
   build/chip_smoke_ckpt/), then a second main that resumes from step 4
   and runs to 6; then one step taken apart as phase 8's (loss and
   gradients, of it the ssd_chunks launches x the kernel's ms, the SSD
   scan's forward, the SSD backward kernels and the plain SSD VJP at one
   layer's shape; compression; AdamW).
10. distribution: (a) the partition rules (parallel/sharding.py) of all
   ten archs at full width on the meta device, on (16, 16), (2, 16, 16),
   (2, 4), (4, 2) and (8, 1): param, FSDP, opt-state, batch, cache and
   activation specs and the bytes a device against the JAX package's in
   tests/data/torch_port_sharding_golden.json (the moments' one recorded
   difference, SHARDING_MOMENT_EXTRA, exactly), printing the sharded
   leaves and the param and moment bytes a device; (b) mamba2-130m at
   phase 9's full width, trained by runtime/elastic.py's
   train_compressed over a one-rank NCCL group under its
   ElasticController: after step 2 an ElasticEvent plans the slice on a
   PlanningEngine on the card (its planning's own rbf_gram and plan_argmin
   launches counted apart and required), checkpoints, rebuilds the 1 x 1
   mesh, restores and reshards, and the run resumes to step 4, its losses
   held to an
   uninterrupted run's within ELASTIC_LOSS_REL (the plan, the checkpoint's
   bytes and the seconds of save, restore and reshard printed; the
   checkpoint deleted after); (c) 8 gloo ranks on the host save gemma3-12b
   SMOKE weights on a (2, 4) mesh and take its plain-arm loss there; the
   card restores the checkpoint (restore_latest), reshards it onto its
   1 x 1 mesh, holds the values bit for bit and its kernel-arm loss within
   REMESH_LOSS_REL. The launches of (b) and (c) are counted from 0.
11. dry run: (a) launch.dryrun.run_cell for all 66 production cells (ten
   archs x train_4k, prefill_32k, decode_32k, long_500k for three, on the
   pod and multipod meshes; the mesh's device the card, the shards meta
   tensors) in DRYRUN_WORKERS processes under build/chip_smoke_dryrun/,
   each record against the reference's in
   tests/data/torch_port_dryrun_golden.json: ok, argument bytes equal but
   for the recorded deltas, and outside the limits (flops 5%, memory and
   each collective kind 2x) exactly where
   tests/data/torch_port_dryrun_exceptions.json records, each such
   metric equal to the port's count recorded there for this torch version
   (`[dryrun]` lines: both counts and their ratio); no kernel launched;
   (b) the
   port's records and the reference's planned on the card
   (workloads_from_artifacts -> plan_many: each pod cell's chips and
   frequency under both and the deciding term, `[dryrun-plan]`), then
   python -m repro_torch.fleet --quick --artifacts on each set
   (`[dryrun-fleet]`); the planning kernels' launches counted by shape,
   every call replayed against the plain version, and added to the
   launches line (dryrun_launches); (c) python -m repro_torch.analysis
   over the checkout exits 0 (`[lint]`).
12. launches: one JSON line with every kernel's launch count on its main
   path (phases 4, 5 and 5b for the planning kernels, 5b's, 5c's, 5d's
   and rbf_gram's in phase 4b beside them, 6b's kernel arms and 6c's
   counted full-width runs for the serving kernels, phases 8-9's training
   runs for the codec, phases 10's and 11's runs for all they launch, each
   counted from 0 just before its path), its error against the plain
   version and its times.
13. the last line: {"ok": true, "device": {...}}.

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
PARETO_PAIRS_B, PARETO_PAIRS_G = 200, 1500  # pareto_mask past the sort's 1,024 slots
GOLDEN = os.path.join(HERE, "tests", "data", "torch_port_eval_golden.json")
SERVE_GOLDEN = os.path.join(HERE, "tests", "data", "torch_port_serve_golden.npz")
NEAR_TIE_REL = 1e-3
TABLE1_GOLDEN = os.path.join(HERE, "tests", "data", "torch_port_table1_golden.json")
FLEET_GOLDEN = os.path.join(HERE, "tests", "data", "torch_port_fleet_golden.json")
# after a near-tie the schedules part ways; the rest of an engine scenario
# is held to the golden's total energy within this share (and equal misses)
FLEET_ENERGY_REL = 0.01
# a job placed as the golden placed it predicts its energy (the SVR's step
# time on the port's power fit) within this share of the golden's. On the
# host the port reads 1.34e-4 against the JAX package; a Gram rounded to
# CONTROL_BITS mantissa bits (relative 3e-5) keeps every placement of the
# four runs and reads 2.0e-3 to 4.2e-3 there. See PERF.md for the card's.
FLEET_PRED_REL = 5e-4
CONTROL_BITS = 14
FLEET_KERNELS = ("rbf_gram", "plan_argmin", "pareto_mask")
# Table 1's (MAE, PAE) on the card against the JAX package on the host,
# relative. Read on an H100 by scripts/table1_witness_torch.py: the card's
# Grams (kernel and plain alike, within 6e-8 of the host's) tip one
# training sample of one raytrace fold from free to the box bound, 3.9e-4,
# the largest sound gap (the host fed the card's Grams lands there too);
# the other apps stay under 4e-5. Folds of another seed move the four apps
# by 2.8e-2 to 0.31, a fault this limit fails.
TABLE1_REL = 1e-3
# fit_many(iters=50)'s predictions, relative: the same Gram bits, then the
# float32 polish summed in another order (5e-5 on the host's parity tests)
ISTA_PRED_REL = 1e-3
DEVICE = "cuda"
# phase 5c: the fleet service and the apps
SERVICE_DIR = os.path.join(HERE, "build", "chip_smoke_service")
SERVICE_GOLDEN = os.path.join(HERE, "tests", "data", "torch_port_service_golden.json")
SERVICE_JOURNAL = os.path.join(HERE, "tests", "data", "torch_port_service_journal.json")
# phase 5b's runs that phase 5c drives again through the service: the
# negotiated runs plan with pareto_many, the cheapest-first one with plan_many
SERVICE_RUNS = ([], ["--quick", "--horizon", "600", "--burst", "3"], ["--quick", "--fallback"])
# one seed of each fault kind (tests/helpers/torch_faults.py) on the --quick
# pool, drawn in SERVICE_FAULT_WINDOW_S: each lands (the crash kills an
# in-flight segment, the silent node is declared down, the commit tears)
SERVICE_FAULT_SEEDS = {"node-down": 23, "heartbeat-loss": 6, "journal-torn": 0}
SERVICE_FAULT_WINDOW_S = (100.0, 2500.0)
SERVICE_HEARTBEAT_S = 150.0
APPS_GOLDEN = os.path.join(HERE, "tests", "data", "torch_port_apps_golden.npz")
# the apps against the JAX package, |err| / max |want| per output: the
# tolerances of tests/test_torch_apps.py, which says why each
APPS_SCALE_REL = {"blackscholes": 1e-5, "fluidanimate": 1e-5, "raytrace": 5e-4}
APPS_SE_WIDTH = 4.0
# sizes the card must work for: PARSEC's native blackscholes (10M options)
# and swaptions (128, at the reference's 512 trials); raytrace's image side;
# fluidanimate's particles (its step is all pairs, O(n^2))
APPS_NATIVE_N = {"blackscholes": 10_000_000, "swaptions": 128, "raytrace": 1024,
                 "fluidanimate": 8192}
# flash_attention, kernel vs plain, per element |err| <= rtol |want| + atol:
# f32 inputs, f32 sums in another order; bf16, both arms round nearly the
# same f32 value to bf16 once, so they differ by at most one bf16 ulp,
# 2^-7 of |want|, with atol for outputs near 0
FLASH_TOL = {"float32": (0.0, 2e-5), "bfloat16": (2.0 ** -7, 1e-4)}
# flash_attention's lse against the plain version's, per element |err| <=
# rtol |want| + atol, and -inf exactly where the plain version's is: f32
# sums of the same products in another order (the tensor cores' f32
# accumulation on the bf16 paths), exp2 / log2 with the scale folded in
LSE_TOL = (1e-5, 1e-4)
# ssd_chunks, kernel vs plain: f32 sums of up to T*n terms in another order
# and a cumsum taken as a scan, relative to the output's scale
SSD_REL = 1e-4
# the largest f32 product the plain SSD VJP's einsums may hold at once
# (phase 3 runs it on as many batch rows as fit)
SSD_PLAIN_BYTES = 8e9
# serve at SMOKE width (f32) on the card vs the JAX package on the host
SERVE_GOLDEN_ATOL = 1e-4
# serve at full width (bf16), kernel arm vs plain arm, teacher-forced:
# bf16 activations round at other places once the attention or SSD output
# differs by an ulp (2^-8 relative), and 24-108 layers carry that on, about
# 2^-8 x sqrt(layers): 3% at 52 (gemma3-12b's 48 layers read 3.8% on an
# H100), 4% at zamba2-7b's 81 Mamba2 layers and 27 shared-block calls;
# relative to max |logit|
SERVE_FULL_REL = 0.05
# phase 6a, SMOKE width against the JAX golden: every arch of the port
SERVE_ARCHS = ("starcoder2-3b", "mamba2-130m", "granite-20b", "qwen1.5-110b", "gemma3-12b",
               "granite-moe-1b-a400m", "phi3.5-moe-42b-a6.6b", "zamba2-7b",
               "phi-3-vision-4.2b", "whisper-medium")
# phase 6b, full width, one model on the card at a time (gemma3-12b holds
# 23.5 GB of bf16 weights, granite-20b 40.0 GB, zamba2-7b 13.4 GB);
# qwen1.5-110b (222 GB) and phi3.5-moe (83.7 GB) do not fit one card
SERVE_FULL_ARCHS = ("starcoder2-3b", "mamba2-130m", "gemma3-12b", "granite-20b",
                    "granite-moe-1b-a400m", "zamba2-7b", "phi-3-vision-4.2b",
                    "whisper-medium")
# phase 6b's inputs beside the prompts: phi-3-vision-4.2b's 576 image
# patches (the reference's stub, before the 1,024 tokens) and
# whisper-medium's 1,500 encoder frames (Whisper's 30-second window) under
# a decoder prompt of 64 (64 + 32 positions, under max_target_len 448),
# drawn from this seed; neither goes through serve.main, whose frames are
# prompt-long and which passes no images (as the reference's main)
SERVE_EXTRAS_SEED = 1
WHISPER_FRAMES, WHISPER_PROMPT = 1500, 64
# phase 6c: Zamba2-7B-Instruct's layout (configs/zamba2_7b.PUBLISHED, the
# model of chipbench's zamba2-7b.prefill_mix): its shared blocks' softmax
# scale (224 / 2)^-1/2 and calls a forward (13 hybrid layers); the cell's
# prefill batches of 16,384 tokens; PUBLISHED_SMOKE's (batch, prompt,
# tokens generated)
ZAMBA2_PUB_SCALE = 112**-0.5
ZAMBA2_PUB_CALLS = 13
ZAMBA2_PUB_WEIGHTS = 7_356_749_648
ZAMBA2_PUB_BATCHES = ((16, 1024), (8, 2048), (4, 4096))
ZAMBA2_PUB_SMOKE = (2, 32, 5)
TRAIN_ARCHS = ("starcoder2-3b", "mamba2-130m")
SERVE_ARGV = ["--batch", "8", "--prompt-len", "1024", "--gen", "32"]
TRAIN_GOLDEN = os.path.join(HERE, "tests", "data", "torch_port_train_golden.npz")
# SMOKE training on the card vs the JAX package on the host, f32: phase
# 6a's SMOKE logits agree within 3.6e-7; three steps carry that through the
# backward and AdamW (the host's own parity is 1e-7 on losses, 1.5e-6 on
# grad norms, 1.5e-5 on parameters: Adam turns last-bit differences of a
# near-zero gradient into larger steps)
TRAIN_GOLDEN_RTOL = {"loss": 1e-5, "ce": 1e-5, "grad_norm": 1e-4, "lr": 1e-6}
TRAIN_GOLDEN_PARAM_ATOL = 1e-4
# the compressed step: a last-bit change of a raw gradient moves an element
# to the next int8 level now and then, and Adam steps it by up to lr (the
# host's parity test, tests/test_torch_train.py, states the same rule)
COMPRESSED_GOLDEN_RTOL = {"loss": 1e-4, "grad_norm": 5e-3, "lr": 1e-6}
COMPRESSED_CLOSE_SHARE = 0.75
# the median parameter error: a step that drops the error-feedback residual
# reaches 1.3e-5 and 1.7e-5 on the host, a sound one 1.5e-7 and 1.4e-6
COMPRESSED_MEDIAN_ATOL = 5e-6
# full width, kernel arm vs plain arm on one forward and backward (bf16),
# the loss and the global grad norm, relative: the arms' backwards differ.
# The kernel arm's is the Hopper backward on the forward kernel's saved
# (out, lse), with P and dS rounded to bf16 as its products' operands; the
# plain arm's recomputes (out, lse) with the plain version and runs the
# plain chunked backward in f32 (the forward's one-ulp outputs differ too)
TRAIN_FULL_REL = 1e-3
TRAIN_FULL_ARGV = ["--batch", "2", "--seq", "4096"]  # the reference's train_4k sequence
TRAIN_WARM, TRAIN_COUNTED = 2, 3
# launches a step: starcoder2-3b has 30 layers (the attention forward and
# its per-layer recomputation, which saves (out, lse) for the backward
# kernel, and one backward a layer) and 393 parameter tensors; mamba2-130m
# 24 layers (the SSD forward and its recomputation, which saves the chunks'
# entry states for the backward kernels, and one backward a layer) and 218
# tensors; each tensor quantizes 3 times and dequantizes once
TRAIN_LAUNCHES = {
    "starcoder2-3b": {"flash_attention": 60, "attention_bwd": 30, "int8_quantize": 1179,
                      "int8_dequantize": 393},
    "mamba2-130m": {"ssd_chunks": 48, "ssd_bwd": 24, "int8_quantize": 654,
                    "int8_dequantize": 218},
}
CODEC_SIZES = (150_994_944, 37_748_736, 1_000_003)  # the embedding, an MLP weight, ragged
CKPT_DIR = os.path.join(HERE, "build", "chip_smoke_ckpt")
# phase 10: distribution
SHARDING_GOLDEN = os.path.join(HERE, "tests", "data", "torch_port_sharding_golden.json")
# optimizer-moment bytes a device the port holds beyond the reference's
# (m and v): qwen1.5-110b's 80 head-sharded attention q biases, whose one
# dim "model" takes; the reference's ZeRO-1 shards their group axis over
# "data" instead, which the port's per-layer tensors do not have (ROADMAP §C)
SHARDING_MOMENT_EXTRA = {("qwen1.5-110b", "16x16"): 307_200,
                         ("qwen1.5-110b", "2x16x16"): 307_200,
                         ("qwen1.5-110b", "2x4"): 655_360,
                         ("qwen1.5-110b", "4x2"): 1_966_080}
ELASTIC_DIR = os.path.join(HERE, "build", "chip_smoke_elastic")
# 10b: the re-meshed run against the uninterrupted one, relative
ELASTIC_LOSS_REL = 1e-6
# 10c: the card's loss (kernel arm, f32 SMOKE weights) against the host's
# plain-arm loss on the (2, 4) gloo mesh: the attention kernel and the
# host's chunked plain version sum in other orders (phase 6a's SMOKE
# logits agree within 3.6e-7 of the JAX golden)
REMESH_LOSS_REL = 1e-5
REMESH_SPAWN_TIMEOUT_S = 240
# phase 11: the port's dry run of all 66 production cells, in worker
# processes (each its own fake world), against the reference's records
# (tests/data/torch_port_dryrun_golden.json) under the limits and the
# recorded exceptions of tests/helpers/torch_dryrun_parity.py
DRYRUN_DIR = os.path.join(HERE, "build", "chip_smoke_dryrun")
DRYRUN_WORKERS = 6
DRYRUN_TIMEOUT_S = 400
DRYRUN_WORKER = (
    "import json, sys\n"
    "from repro_torch.kernels import ops\n"
    "from repro_torch.launch import dryrun\n"
    "for cell in sys.argv[3:]:\n"
    "    dryrun.run_cell(*cell.split(':'), sys.argv[1], device=sys.argv[2])\n"
    "print(json.dumps(dict(ops.LAUNCHES)))\n")

# H100 SXM peaks (NVIDIA data sheet): HBM rate, fp32 outside the tensor
# cores, dense bf16 and TF32 on the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12
TF32_OPS_PER_S = 495e12


def _gram_shape(x, y, *_):
    """rbf_gram's call shape (b, n, m, d) for x (b, n, d) and y (b, m, d);
    None for an empty output, which launches nothing."""
    if x.shape[0] * x.shape[1] * y.shape[1]:
        return (x.shape[0], x.shape[1], y.shape[1], x.shape[2])
    return None


def _grid_shape(t, *_):
    """plan_argmin's and pareto_mask's call shape (B, G) for t (B, G)."""
    return tuple(t.shape) if t.numel() else None


def _tally_shapes(module, name: str, shape_of=_gram_shape, calls=None):
    """Count the calls of ``module.name`` (a kernel wrapper) by
    ``shape_of(*args)``, until ``restore()``; the wrapper and its launch
    count run as before. With a list ``calls``, each launching call's
    (shape, args, kwargs) is appended to it, the tensors cloned."""
    import collections

    fn = getattr(module, name)
    tally = collections.Counter()

    def counted(*args, **kw):
        shape = shape_of(*args)
        if shape is not None:
            tally[shape] += 1
            if calls is not None:
                calls.append((shape, [a.clone() if hasattr(a, "clone") else a
                                      for a in args], dict(kw)))
        return fn(*args, **kw)

    setattr(module, name, counted)
    return tally, lambda: setattr(module, name, fn)


def _counted(ops, fn, calls=None):
    """Run ``fn`` with every launch count set to 0 just before; return the
    counts just after and the planning kernels' calls by shape. With a dict
    ``calls``, ``calls[name]`` collects each planning kernel's calls (see
    ``_tally_shapes``)."""
    ops.reset_launches()
    tallies = {name: _tally_shapes(ops, f"{name}_cuda", shape_of,
                                   None if calls is None else calls.setdefault(name, []))
               for name, shape_of in (("rbf_gram", _gram_shape),
                                      ("plan_argmin", _grid_shape),
                                      ("pareto_mask", _grid_shape))}
    try:
        fn()
    finally:
        for _, restore in tallies.values():
            restore()
    return dict(ops.LAUNCHES), {name: tally for name, (tally, _) in tallies.items()}


def _stage(name: str, t0: float) -> float:
    now = time.perf_counter()
    print(f"[stage] {name}: {now - t0:.3f} s", flush=True)
    return now


def _children() -> list:
    """The command lines of the processes this one started that have not
    been reaped (from /proc)."""
    me, kids = os.getpid(), []
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace").strip()
        except (OSError, ValueError, IndexError):
            continue
        if ppid == me:
            kids.append(f"{pid}: {cmd[:200]}")
    return kids


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
    t[5::89, min(100, g - 1)] = np.nan  # NaN step times: the first feasible NaN wins
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
    t[::23, 0], t[::23, 1] = -0.0, 0.0  # -0.0 == +0.0, in t and in e
    e[::29, 0], e[::29, 1] = 0.0, -0.0
    return t, e, mask


def _check_rbf(torch, np, rng, kind, b, n, m, d, inputs=None):
    """One rbf_gram shape: kernel vs plain (within RBF_ATOL), timed beside
    its bound; on inputs of ``rng``, or on ``inputs`` (x, y, gamma), a
    call the fleet runs made."""
    from repro_torch.kernels import ops

    if inputs is None:
        dev = torch.device(DEVICE)
        xn, yn = _rbf_inputs(np, rng, b, n, m, d)
        x = torch.from_numpy(xn).to(dev)
        y = torch.from_numpy(yn).to(dev)
        if b == 1:
            x, y = x[0], y[0]
        gamma = 0.5
    else:
        x, y, gamma = inputs
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
    print(f"[kernel] rbf_gram b={b} n={n} m={m} d={d}{' (a fleet call)' if inputs else ''}: "
          f"{ms:.4f} ms "
          f"(eager calls {eager:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{bound * 1e3:.4f} us by {by}, max |err| {err:.3g}) on {kind}",
          flush=True)
    return dict(shape=(b, n, m, d), ms=ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=by, max_abs_err=err)


def _check_plan_argmin(torch, np, rng, kind, b, g, inputs=None):
    """One plan_argmin shape: kernel vs plain (identical indices), timed
    beside its bound; on inputs of ``rng``, or on ``inputs`` (t, w, k,
    mask, time_floor), a call the fleet runs made."""
    from repro_torch.core.engine import TIME_FLOOR
    from repro_torch.kernels import ops

    if inputs is None:
        dev = torch.device(DEVICE)
        t, w, k, mask = (torch.from_numpy(a).to(dev) for a in _plan_inputs(np, rng, b, g))
        time_floor = TIME_FLOOR
    else:
        t, w, k, mask, time_floor = inputs
    got = ops.plan_argmin(t, w, k, mask, time_floor=time_floor)
    want = ops.plan_argmin(t, w, k, mask, time_floor=time_floor, impl="ref")
    mism = int((got != want).sum())
    err = float((got.long() - want.long()).abs().max())
    if mism:
        raise AssertionError(f"plan_argmin {(b, g)}: {mism} of {b} rows differ")
    def kernel():
        return ops.plan_argmin(t, w, k, mask, time_floor=time_floor)

    ms = _time_ms(torch, kernel, 200)
    eager = _eager_ms(torch, kernel, 200)
    plain_ms = _time_ms(
        torch, lambda: ops.plan_argmin(t, w, k, mask, time_floor=time_floor, impl="ref"), 20)
    bound, by = _bound_ms(4.0 * b * g + b * g + 4.0 * g + 4.0 * b + 4.0 * b, 5.0 * b * g)
    print(f"[kernel] plan_argmin B={b} G={g}{' (a fleet call)' if inputs else ''}: "
          f"{ms:.5f} ms (eager calls {eager:.4f} ms, "
          f"plain {plain_ms:.4f} ms, bound {bound * 1e3:.4f} us by {by}, {mism} rows "
          f"differ, {int(mask.any(1).sum())} rows with a feasible point, "
          f"{int(torch.isnan(t).any(1).sum())} rows with NaN) on {kind}", flush=True)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by, max_abs_err=err)


def phase_kernels(torch, np, kind):
    rng = np.random.default_rng(SEED)
    results = {}

    # rbf_gram: the fit (4, 1760, 1760, 3), the engine predict (20, 352, 352, 2)
    # and one evaluate plan's predict (352, 1760, 3); then phase 4b's fold fit
    # (1584, 1584, 3) and fold predict (176, 1584, 3)
    table1_rng = np.random.default_rng(SEED + 2)  # the other kernels' inputs stay as they were
    rbf = [_check_rbf(torch, np, shape_rng, kind, *shape)
           for shape, shape_rng in (((4, 1760, 1760, 3), rng), ((20, 352, 352, 2), rng),
                                    ((1, 352, 1760, 3), rng), ((1, 1584, 1584, 3), table1_rng),
                                    ((1, 176, 1584, 3), table1_rng))]
    # the JSON line carries the fit shape, the largest on the path
    results["rbf_gram"] = dict(rbf[0], max_abs_err=max(r["max_abs_err"] for r in rbf),
                               table1_fit_ms=rbf[3]["ms"], table1_fit_bound_ms=rbf[3]["bound_ms"],
                               table1_predict_ms=rbf[4]["ms"],
                               table1_predict_bound_ms=rbf[4]["bound_ms"])

    # plan_argmin at B = 10^4, G = 352: identical indices
    b, g = B_FLEET, 352
    results["plan_argmin"] = _check_plan_argmin(torch, np, rng, kind, b, g)

    # pareto_mask at B = 10^4, G = 352 (the sort path) and past the sort's
    # capacity (the all-pairs path): identical keep-sets
    pareto = [_check_pareto(torch, np, rng, kind, bb, gg)
              for bb, gg in ((b, g), (PARETO_PAIRS_B, PARETO_PAIRS_G))]
    results["pareto_mask"] = dict(pareto[0], **{f"pairs_{key}": pareto[1][key] for key in
                                                ("ms", "bound_ms", "max_abs_err")})
    results["flash_attention"] = _check_flash(torch, np, rng, kind)
    results["ssd_chunks"] = _check_ssd(torch, np, rng, kind)
    results.update(_check_codec(torch, np, kind))
    results["attention_bwd"] = _check_attention_bwd(torch, np, kind)
    results["ssd_bwd"] = _check_ssd_bwd(torch, np, kind)
    return results


# the attention backward kernel against the plain backward in f32 on the
# same bf16 inputs: the worst element within ATTN_BWD_TOL of the gradient's
# largest (P and dS rounded to bf16 as operands, the outputs rounded once;
# tests/test_torch_gpu.py holds the same)
ATTN_BWD_TOL = 1e-2


def _check_attention_bwd(torch, np, kind):
    """The attention backward at starcoder2-3b's training shape (b 2, H
    24, Hk 2, S 4,096, D 128, causal, bf16): kernel vs the plain backward,
    timed from CUDA-graph replays beside its bound (the four products dV,
    dP, dQ and dK over the causal pairs at the bf16 tensor-core rate), the
    plain backward (one call between CUDA events), and SDPA's backward as
    the library yardstick (the port never calls it; eager calls between
    CUDA events: its backward runs on autograd's thread, which a graph
    capture refuses)."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.attention_bwd import attention_bwd_cuda
    from repro_torch.kernels.flash_attention import flash_attention_cuda

    b, h, hk, s, d = 2, 24, 2, 4096, 128
    rng = np.random.default_rng(SEED + 4)
    dev = torch.device(DEVICE)
    q, k, v, dout = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
        dev, torch.bfloat16) for shape in ((b, h, s, d), (b, hk, s, d), (b, hk, s, d),
                                           (b, h, s, d)))
    kw = dict(causal=True, window=None, scale=None, q_offset=0, kv_len=None)
    out, lse = flash_attention_cuda(q, k, v, return_lse=True, **kw)
    got = attention_bwd_cuda(q, k, v, out, lse, dout, **kw)
    want = ref.flash_attention_bwd_ref(q.float(), k.float(), v.float(), out.float(), lse,
                                       dout.float(), causal=True)
    torch.cuda.synchronize()
    errs = []
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        scale = float(w.abs().max())
        errs.append(float((g.float() - w).abs().max()) / scale)
        if not bool(torch.isfinite(g).all()) or errs[-1] > ATTN_BWD_TOL:
            raise AssertionError(f"attention_bwd {name}: worst element at {errs[-1]:.3g} of the "
                                 f"gradient's largest (tolerance {ATTN_BWD_TOL})")
    del got, want
    ms = _time_ms(torch, lambda: attention_bwd_cuda(q, k, v, out, lse, dout, **kw), 10)
    eager = _eager_ms(torch, lambda: attention_bwd_cuda(q, k, v, out, lse, dout, **kw), 10)
    plain_ms = _eager_ms(torch, lambda: ref.flash_attention_bwd_ref(q, k, v, out, lse, dout,
                                                                    causal=True), 1)
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    o = F.scaled_dot_product_attention(*leaves, is_causal=True, enable_gqa=True)
    library_ms = _eager_ms(torch, lambda: torch.autograd.grad(o, leaves, dout,
                                                               retain_graph=True), 10)
    del o, leaves
    pairs = s * (s + 1) // 2
    n_ops = 8.0 * b * h * d * pairs
    n_bytes = 2 * (4 * b * h * s * d + 4 * b * hk * s * d) + 4 * b * h * s
    bound, by = _bound_ms(n_bytes, n_ops, BF16_OPS_PER_S)
    print(f"[kernel] attention_bwd b={b} h={h} hk={hk} s={s} d={d} bf16 causal: {ms:.4f} ms = "
          f"{100 * bound / ms:.1f}% of the bound {bound:.4f} ms by {by} at the bf16 tensor-core "
          f"rate, {ms / library_ms:.2f} x sdpa's backward {library_ms:.4f} ms (eager calls "
          f"{eager:.4f} ms, plain {plain_ms:.1f} ms; worst element of dq, dk, dv at "
          f"{', '.join(f'{e:.3g}' for e in errs)} of the largest) on {kind}", flush=True)
    torch.cuda.empty_cache()
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by, max_abs_err=max(errs),
                library_ms=library_ms)


def _check_pareto(torch, np, rng, kind, b, g, inputs=None):
    """One pareto_mask shape: kernel vs plain (identical keep-sets), timed
    beside its bound; on inputs of ``rng``, or on ``inputs`` (t, e, mask),
    a call the fleet runs made."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.plan_grid import pareto_plan

    if inputs is None:
        dev = torch.device(DEVICE)
        t, e, mask = (torch.from_numpy(a).to(dev) for a in _pareto_inputs(np, rng, b, g))
    else:
        t, e, mask = inputs
    got = ops.pareto_mask(t, e, mask)
    want = ops.pareto_mask(t, e, mask, impl="ref")
    mism = int((got != want).sum())
    err = float((got.int() - want.int()).abs().max())
    if mism:
        raise AssertionError(f"pareto_mask {(b, g)}: {mism} of {b * g} points differ")
    ms = _time_ms(torch, lambda: ops.pareto_mask(t, e, mask), 50)
    eager = _eager_ms(torch, lambda: ops.pareto_mask(t, e, mask), 50)
    plain_ms = _time_ms(torch, lambda: ops.pareto_mask(t, e, mask, impl="ref"), 2)
    # the least work for this function is a per-row lexsort on (t, e, index)
    # and a running minimum, as engine.pareto_frontier does on the host:
    # about 3 log2(G) comparisons and 2 operations a point, far below the
    # 10 bytes a point (t, e, mask in, keep-set out) it must move
    bound, by = _bound_ms(10.0 * b * g, b * g * (3.0 * math.log2(g) + 2.0))
    plan = pareto_plan(b, g)
    print(f"[kernel] pareto_mask B={b} G={g}{' (a fleet call)' if inputs else ''} "
          f"({plan.path}, {plan.slots} slots): {ms:.4f} ms "
          f"(eager calls {eager:.4f} ms, plain {plain_ms:.4f} ms, bound {bound * 1e3:.4f} us "
          f"by {by}, {mism} points differ, {int(want.sum())} kept of "
          f"{int((mask & torch.isfinite(t) & torch.isfinite(e)).sum())} feasible) on {kind}",
          flush=True)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by, max_abs_err=err)


def _codec_edges(np):
    """Zero, NaN, +inf, -inf and half-way blocks (0.5, 1.5, 2.5, -2.5 at
    scale 1 round to 0, 2, 2, -2), then a ragged tail."""
    rng = np.random.default_rng(SEED)
    blocks = [np.zeros(256, np.float32)]
    for bad in (np.nan, np.inf, -np.inf):
        b = (rng.standard_normal(256) * 3).astype(np.float32)
        b[int(rng.integers(256))] = bad
        blocks.append(b)
    b = np.zeros(256, np.float32)
    b[0] = 127.0
    b[1:9] = [0.5, 1.5, 2.5, -2.5, -0.5, 126.5, -126.5, 3.5]
    blocks.append(b)
    blocks.append((rng.standard_normal(77) * 1e-3).astype(np.float32))
    return np.concatenate(blocks)


def _check_codec(torch, np, kind):
    """int8_quantize / int8_dequantize at the training path's sizes: bit for
    bit against the plain versions, timed beside their byte bounds."""
    from repro_torch.kernels import ops

    dev = torch.device(DEVICE)
    gen = torch.Generator(dev).manual_seed(SEED)
    edges = torch.from_numpy(_codec_edges(np)).to(dev)
    out = {}
    for n in (*CODEC_SIZES, edges.numel()):
        x = edges if n == edges.numel() else torch.randn(n, generator=gen, device=dev) * 0.01
        q, s = ops.int8_quantize(x)
        back = ops.int8_dequantize(q, s, n=n)
        q_ref, s_ref = ops.int8_quantize(x, impl="ref")
        back_ref = ops.int8_dequantize(q_ref, s_ref, n=n, impl="ref")
        torch.cuda.synchronize()
        same = (torch.equal(q, q_ref) and torch.equal(s.view(torch.int32), s_ref.view(torch.int32))
                and torch.equal(back.view(torch.int32), back_ref.view(torch.int32)))
        if not same:
            raise AssertionError(f"int8 codec n={n}: the kernels differ from the plain versions")
        if x is edges:
            print(f"[kernel] int8 codec edge blocks (zero, NaN, +inf, -inf, half-way; n={n}): "
                  f"bit for bit; scales {s[:5].tolist()}", flush=True)
            continue
        nb = s.numel()
        reps = 20 if n > 10**7 else 100
        for name, fn, plain, n_bytes in (
                ("int8_quantize", lambda: ops.int8_quantize(x),
                 lambda: ops.int8_quantize(x, impl="ref"), 4.0 * n + nb * 256 + 4.0 * nb),
                ("int8_dequantize", lambda: ops.int8_dequantize(q, s, n=n),
                 lambda: ops.int8_dequantize(q, s, n=n, impl="ref"),
                 nb * 256 + 4.0 * nb + 4.0 * n)):
            ms = _time_ms(torch, fn, reps)
            eager = _eager_ms(torch, fn, reps)
            plain_ms = _time_ms(torch, plain, 5)
            # a division, a rounding, a clamp an element (quantize), one
            # product (dequantize): far below the fp32 rate
            bound, by = _bound_ms(n_bytes, 4.0 * n)
            print(f"[kernel] {name} n={n}: {ms:.4f} ms (eager calls {eager:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, bound {bound * 1e3:.2f} us by {by}, "
                  f"{n_bytes / ms / 1e6:.0f} GB/s, bit for bit) on {kind}", flush=True)
            if n == CODEC_SIZES[0]:  # the JSON line carries the largest tensor
                out[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                                 max_abs_err=0.0, library_ms=None)
        del q, s, back, q_ref, s_ref, back_ref
        torch.cuda.empty_cache()
    return out


def _flash_case(torch, np, rng, kind, b, h, hk, sq, skv, d, dtype, **kw):
    """One flash_attention shape: kernel vs plain (the output and its lse),
    timed beside its bound and SDPA."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda, launch_plan

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
    lse_kw = dict(causal=True, window=None, scale=None, q_offset=0, kv_len=None)
    lse_kw.update(kw)
    _, lse = flash_attention_cuda(q, k, v, return_lse=True, **lse_kw)
    _, lse_want = ref.flash_attention_ref(q, k, v, return_lse=True, **lse_kw)
    torch.cuda.synchronize()
    masked = torch.isneginf(lse_want)
    lse_diff = (lse[~masked] - lse_want[~masked]).abs()
    lse_err = float(lse_diff.max()) if lse_diff.numel() else 0.0
    lse_worst = float((lse_diff / (LSE_TOL[0] * lse_want[~masked].abs() + LSE_TOL[1])).max())
    if (not torch.equal(torch.isneginf(lse), masked) or lse_worst > 1.0
            or not bool(torch.isfinite(lse[~masked]).all())):
        raise AssertionError(f"flash_attention {(b, h, hk, sq, skv, d)}: lse differs from the "
                             f"plain version's (max |err| {lse_err:.3g}, worst element at "
                             f"{lse_worst:.3g} x its tolerance)")
    # the work: the (query, key) pairs each row sees, 4 d flops a pair
    # (QK^T and PV); each input read once (the keys some row sees), the
    # output written once
    kv_len = kw.get("kv_len") or skv
    q_off = kw.get("q_offset", 0)
    causal, window = kw.get("causal", True), kw.get("window")
    pairs = 0
    for i in range(sq):
        hi = min(kv_len, q_off + i + 1) if causal else kv_len
        lo = max(0, q_off + i - window + 1) if window else 0
        pairs += max(0, hi - lo)
    seen = kv_len - (max(0, q_off - window + 1) if window else 0)
    n_ops = 4.0 * b * h * d * pairs
    n_bytes = q.element_size() * (2 * b * h * sq * d + 2 * b * hk * seen * d)
    bound, by = _bound_ms(n_bytes, n_ops, BF16_OPS_PER_S)
    reps = 20 if sq > 1 else 200
    ms = _time_ms(torch, lambda: ops.flash_attention(q, k, v, **kw), reps)
    eager = _eager_ms(torch, lambda: ops.flash_attention(q, k, v, **kw), reps)
    plain_ms = _time_ms(torch, lambda: ops.flash_attention(q, k, v, impl="ref", **kw),
                        2 if sq > 1 else 20)
    import torch.nn.functional as F
    ks, vs = k[:, :, :kv_len], v[:, :, :kv_len]
    if window:  # the same function: the window's mask, built outside the timing
        qp = torch.arange(q_off, q_off + sq, device=dev)[:, None]
        kp = torch.arange(kv_len, device=dev)[None, :]
        allowed = (qp - kp < window) & ((qp >= kp) if causal else True)
        library_ms = _time_ms(torch, lambda: F.scaled_dot_product_attention(
            q, ks, vs, attn_mask=allowed, scale=kw.get("scale"), enable_gqa=True), reps)
    else:
        library_ms = _time_ms(torch, lambda: F.scaled_dot_product_attention(
            q, ks, vs, is_causal=causal and sq > 1, scale=kw.get("scale"), enable_gqa=True),
            reps)
    plan = launch_plan(b, h, hk, sq, skv, d, dtype, kv_len)
    print(f"[kernel] flash_attention b={b} h={h} hk={hk} sq={sq} kv_len={kv_len} d={d} "
          f"{str(dtype).replace('torch.', '')} {kw} ({plan.path}, splits {plan.splits}): "
          f"{ms:.4f} ms = {ms / library_ms:.2f} x sdpa {library_ms:.4f} ms and "
          f"{ms / bound:.2f} x the bound {bound * 1e3:.2f} us by {by} at the bf16 tensor-core "
          f"rate (eager calls {eager:.4f} ms, plain {plain_ms:.4f} ms; max |err| {err:.3g} of "
          f"max |want| {float(want.float().abs().max()):.3g}, worst element at {worst:.3g} x "
          f"its tolerance; lse max |err| {lse_err:.3g}, worst at {lse_worst:.3g} x "
          f"{LSE_TOL[0]} |lse| + {LSE_TOL[1]}) on {kind}", flush=True)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by, max_abs_err=err,
                library_ms=library_ms, lse_max_abs_err=lse_err)


def _check_flash(torch, np, rng, kind):
    """starcoder2-3b's attention: prefill (b 8, H 24, Hk 2, S 1024, D 128,
    causal), a decode step (one row at q_offset 1055 over a 1,064-slot
    cache, kv_len 1,056) and training (b 2, S 4,096, causal), bf16;
    gemma3-12b's local attention at head dim 256 (H 16, Hk 8, window
    1,024): a sequence of 4,096 and a decode step over a 4,096-key cache;
    and the other full-width serving shapes of phase 6b (below)."""
    bf16 = torch.bfloat16
    prefill = _flash_case(torch, np, rng, kind, 8, 24, 2, 1024, 1024, 128, bf16,
                          causal=True)
    decode = _flash_case(torch, np, rng, kind, 8, 24, 2, 1, 1064, 128, bf16, causal=False,
                         q_offset=1055, kv_len=1056)
    train = _flash_case(torch, np, rng, kind, 2, 24, 2, 4096, 4096, 128, bf16, causal=True)
    d256 = _flash_case(torch, np, rng, kind, 1, 16, 8, 4096, 4096, 256, bf16, causal=True,
                       window=1024)
    d256_decode = _flash_case(torch, np, rng, kind, 1, 16, 8, 1, 4096, 256, bf16,
                              causal=True, window=1024, q_offset=4095, kv_len=4096)
    # the full-width serving paths of phase 6b (batch 8, prompt 1,024, a
    # 1,064-slot cache): gemma3-12b at head dim 256, its prefill (window
    # 1,024), a local layer's decode step over its 1,024-slot ring (full,
    # so the step wraps it) and a global layer's; granite-20b's MQA decode
    # step (48 query heads packed over one KV head); granite-moe-1b-a400m at
    # head dim 64, prefill and decode
    d256_serve = _flash_case(torch, np, rng, kind, 8, 16, 8, 1024, 1024, 256, bf16,
                             causal=True, window=1024)
    d256_ring = _flash_case(torch, np, rng, kind, 8, 16, 8, 1, 1024, 256, bf16, causal=False,
                            q_offset=0, kv_len=1024)
    d256_global = _flash_case(torch, np, rng, kind, 8, 16, 8, 1, 1064, 256, bf16,
                              causal=False, q_offset=1055, kv_len=1056)
    mqa_decode = _flash_case(torch, np, rng, kind, 8, 48, 1, 1, 1064, 128, bf16, causal=False,
                             q_offset=1055, kv_len=1056)
    d64 = _flash_case(torch, np, rng, kind, 8, 16, 8, 1024, 1024, 64, bf16, causal=True)
    d64_decode = _flash_case(torch, np, rng, kind, 8, 16, 8, 1, 1064, 64, bf16, causal=False,
                             q_offset=1055, kv_len=1056)
    # the rest of the zoo at phase 6b's shapes (batch 8): whisper-medium's
    # encoder (1,500 frames, bidirectional), its cross-attention at prefill
    # (64 decoder rows over the 1,500 frames) and at decode (a full cross
    # cache), its causal self-attention over the 64-token prompt and a
    # decode step over its 104-slot cache; phi-3-vision-4.2b's prefill of
    # 576 patches + 1,024 tokens and a decode step over its 1,640-slot
    # cache (head dim 96, padded to 128); zamba2-7b's shared attention,
    # prefill and a decode step over 1,064 slots (head dim 112, padded);
    # inputs of their own seed, so the shapes above keep theirs
    rng = np.random.default_rng(SEED + 3)
    zoo = {
        "whisper_enc": _flash_case(torch, np, rng, kind, 8, 16, 16, WHISPER_FRAMES,
                                   WHISPER_FRAMES, 64, bf16, causal=False),
        "whisper_cross": _flash_case(torch, np, rng, kind, 8, 16, 16, WHISPER_PROMPT,
                                     WHISPER_FRAMES, 64, bf16, causal=False),
        "whisper_cross_decode": _flash_case(torch, np, rng, kind, 8, 16, 16, 1,
                                            WHISPER_FRAMES, 64, bf16, causal=False,
                                            kv_len=WHISPER_FRAMES),
        "whisper_self": _flash_case(torch, np, rng, kind, 8, 16, 16, WHISPER_PROMPT,
                                    WHISPER_PROMPT, 64, bf16, causal=True),
        "whisper_self_decode": _flash_case(torch, np, rng, kind, 8, 16, 16, 1, 104, 64, bf16,
                                           causal=False, q_offset=94, kv_len=95),
        "phi3v": _flash_case(torch, np, rng, kind, 8, 32, 32, 1600, 1600, 96, bf16,
                             causal=True),
        "phi3v_decode": _flash_case(torch, np, rng, kind, 8, 32, 32, 1, 1640, 96, bf16,
                                    causal=False, q_offset=1630, kv_len=1631),
        "zamba2": _flash_case(torch, np, rng, kind, 8, 32, 32, 1024, 1024, 112, bf16,
                              causal=True),
        "zamba2_decode": _flash_case(torch, np, rng, kind, 8, 32, 32, 1, 1064, 112, bf16,
                                     causal=False, q_offset=1054, kv_len=1055),
    }
    # Zamba2-7B-Instruct's shared blocks (zamba2-7b.prefill_mix): 32 heads
    # of 224, padded to the d 256 instance, softmax scale (224 / 2)^-1/2, at
    # the cell's three prefill batches of 16,384 tokens, and decode steps
    # over a 1,064-slot cache (kv_len 1,055) and a full 4,096-slot one
    rng = np.random.default_rng(SEED + 5)
    pub = dict(causal=True, scale=ZAMBA2_PUB_SCALE)
    step = dict(pub, causal=False)
    published = {
        "zamba2_pub": _flash_case(torch, np, rng, kind, 16, 32, 32, 1024, 1024, 224, bf16,
                                  **pub),
        "zamba2_pub_2048": _flash_case(torch, np, rng, kind, 8, 32, 32, 2048, 2048, 224, bf16,
                                       **pub),
        "zamba2_pub_4096": _flash_case(torch, np, rng, kind, 4, 32, 32, 4096, 4096, 224, bf16,
                                       **pub),
        "zamba2_pub_decode": _flash_case(torch, np, rng, kind, 8, 32, 32, 1, 1064, 224, bf16,
                                         q_offset=1054, kv_len=1055, **step),
        "zamba2_pub_decode_4096": _flash_case(torch, np, rng, kind, 4, 32, 32, 1, 4096, 224,
                                              bf16, q_offset=4095, kv_len=4096, **step),
    }
    # the JSON line carries the prefill shape, the larger share of the
    # serving time, and the other shapes' errors and times under their own
    # keys
    out = dict(prefill)
    for name, r in (("decode", decode), ("train", train), ("d256", d256),
                    ("d256_decode", d256_decode), ("d256_serve", d256_serve),
                    ("d256_ring", d256_ring), ("d256_global", d256_global),
                    ("mqa_decode", mqa_decode), ("d64", d64), ("d64_decode", d64_decode),
                    *zoo.items()):
        for key in ("max_abs_err", "lse_max_abs_err", "ms", "library_ms", "bound_ms"):
            out[f"{name}_{key}"] = r[key]
    for name, r in published.items():
        for key in ("max_abs_err", "lse_max_abs_err", "ms", "plain_ms", "library_ms",
                    "bound_ms", "bound_by"):
            out[f"{name}_{key}"] = r[key]
    # the head-dim padding a decode step pays: every call pads q, k and v,
    # and at decode k and v are the whole cache
    for name, h, slots, d, layers in (("phi3v", 32, 1640, 96, 32),
                                      ("zamba2", 32, 1064, 112, 27),
                                      ("zamba2_pub", 32, 1064, 224, ZAMBA2_PUB_CALLS)):
        out.update({f"{name}_pad_{k}": v for k, v in
                    _pad_cost(torch, name, 8, h, slots, d, layers, kind).items()})
    return out


def _pad_cost(torch, name, b, h, slots, d, layers, kind):
    """The wrapper's zero-padding of q (one row) and a decode step's k and
    v caches from head dim ``d`` to its kernel instance's, alone: ms a call from CUDA-graph
    replays, the bytes it moves (each cache read once, its padded copy
    written once), and both over the step's ``layers`` attention calls."""
    from repro_torch.kernels.flash_attention import PADDED_HEAD_DIMS

    dev = torch.device(DEVICE)
    width = PADDED_HEAD_DIMS[d] - d
    q = torch.zeros((b, h, 1, d), dtype=torch.bfloat16, device=dev)
    k = torch.zeros((b, h, slots, d), dtype=torch.bfloat16, device=dev)
    v = torch.zeros_like(k)
    pad = torch.nn.functional.pad
    ms = _time_ms(torch, lambda: [pad(t, (0, width)) for t in (q, k, v)], 20)
    n_bytes = 2.0 * sum(t.numel() * (1 + PADDED_HEAD_DIMS[d] / d) for t in (q, k, v))
    print(f"[pad] {name} decode step: padding q, k, v from d {d} to {PADDED_HEAD_DIMS[d]} "
          f"over a {slots}-slot cache (b {b}, h {h}) takes {ms:.4f} ms a call and moves "
          f"{n_bytes / 1e6:.1f} MB ({n_bytes / 1e6 / max(ms, 1e-9) / 1e3:.2f} TB/s); "
          f"x {layers} attention calls a step: {ms * layers:.3f} ms, "
          f"{n_bytes * layers / 1e9:.2f} GB a step, on {kind}", flush=True)
    del q, k, v
    torch.cuda.empty_cache()
    return dict(ms=ms, bytes=n_bytes, step_ms=ms * layers, step_bytes=n_bytes * layers)


def _check_ssd(torch, np, rng, kind):
    """mamba2-130m's SSD chunk block (24 heads, chunks of T 128, head dim
    64, state 128, one group) at its prefill shape, batch 8 x 8 chunks
    (b*h 192), and its training shape, batch 2 x 32 chunks (b*h 48)."""
    prefill = _ssd_case(torch, np, rng, kind, 8, 8)
    train = _ssd_case(torch, np, rng, kind, 2, 32)
    # zamba2-7b's prefill: 112 heads in two groups of 56, state 64 (on
    # 132 SMs head_slice picks 28 heads a block, two slices a group)
    zamba2 = _ssd_case(torch, np, np.random.default_rng(SEED + 4), kind, 8, 8, h=112, g=2,
                       n=64)
    # zamba2-7b.prefill_mix's batches: 16 x 1,024 (b*h 1,792, 8 chunks)
    # and 4 x 4,096 (b*h 448, 32 chunks), the same rows a launch
    rng = np.random.default_rng(SEED + 6)
    pub = _ssd_case(torch, np, rng, kind, 16, 8, h=112, g=2, n=64)
    pub_4096 = _ssd_case(torch, np, rng, kind, 4, 32, h=112, g=2, n=64)
    # the JSON line carries the prefill shape (the serving path's), and the
    # other shapes' numbers under their own keys
    keys = ("max_abs_err", "ms", "bound_ms", "fp32_bound_ms", "plain_ms")
    return dict(prefill, **{f"train_{key}": train[key] for key in keys},
                **{f"zamba2_{key}": zamba2[key] for key in keys},
                zamba2_head_slice=zamba2["head_slice"],
                **{f"zamba2_pub_{key}": pub[key] for key in keys},
                zamba2_pub_head_slice=pub["head_slice"],
                **{f"zamba2_pub_4096_{key}": pub_4096[key] for key in keys},
                zamba2_pub_4096_head_slice=pub_4096["head_slice"])


def _ssd_case(torch, np, rng, kind, b, nc, h=24, g=1, n=128):
    """One ssd_chunks shape (h heads in g groups, state n): kernel vs
    plain, timed beside its bound."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ssd_scan import _sm_count, head_slice

    dev = torch.device(DEVICE)
    T, p = 128, 64

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
    err, worst = 0.0, 0.0  # worst: the largest error as a share of its tolerance
    for name, gt, wt in zip(("y_intra", "states", "c_decay", "chunk_decay"), got, want):
        if gt.shape != wt.shape or not bool(torch.isfinite(gt).all()):
            raise AssertionError(f"ssd_chunks {name}: bad output")
        e = float((gt - wt).abs().max())
        scale = float(wt.abs().max())
        if e > SSD_REL * scale:
            raise AssertionError(f"ssd_chunks {name}: max |err| {e} > {SSD_REL} x {scale}")
        err, worst = max(err, e), max(worst, e / (SSD_REL * scale))
    # the least work: C B^T and M x on the causal triangle of each chunk,
    # and the chunk state, in f32 multiply-adds; each input read once and
    # each output written once. Two bounds: those products on the fp32
    # cores, and as the kernel runs them: in 3xTF32 on the tensor cores
    # (three TF32 products for each f32 one), C B^T once a head slice
    tri = T * (T + 1) // 2
    n_ops = 2.0 * b * h * nc * (tri * n + tri * p + T * n * p)
    n_bytes = 4.0 * (2 * b * h * nc * T * p + 2 * b * h * nc * T + 2 * b * nc * T * g * n
                     + b * h * nc * (n * p + T * n + 1))
    fp32_bound, fp32_by = _bound_ms(n_bytes, n_ops)
    heads = head_slice(b * nc * g, h // g, _sm_count(torch.cuda.current_device()))
    tc_ops = 3 * 2.0 * b * h * nc * (tri * n / heads + tri * p + T * n * p)
    bound, by = _bound_ms(n_bytes, tc_ops, TF32_OPS_PER_S)
    ms = _time_ms(torch, lambda: ops.ssd_chunks(x, dt, a, B, C, heads=h), 20)
    eager = _eager_ms(torch, lambda: ops.ssd_chunks(x, dt, a, B, C, heads=h), 20)
    plain_ms = _time_ms(torch, lambda: ops.ssd_chunks(x, dt, a, B, C, heads=h, impl="ref"), 3)
    print(f"[kernel] ssd_chunks bh={b * h} g={g} nc={nc} T={T} p={p} n={n}: {ms:.4f} ms (eager "
          f"calls {eager:.4f} ms, plain {plain_ms:.4f} ms; bound {bound * 1e3:.2f} us by {by} "
          f"in 3xTF32 on the tensor cores, C B^T once for {heads} heads ({n_bytes / 1e6:.1f} "
          f"MB, {tc_ops / 1e9:.2f} GFLOP), {ms / bound:.2f} x it; fp32-core bound "
          f"{fp32_bound * 1e3:.2f} us by "
          f"{fp32_by}, {ms / fp32_bound:.2f} x it; max |err| {err:.3g}, worst output at "
          f"{worst:.3g} x its tolerance, {SSD_REL} of its scale) on {kind}", flush=True)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by, max_abs_err=err,
                library_ms=None, fp32_bound_ms=fp32_bound, head_slice=heads)


def _check_ssd_bwd(torch, np, kind):
    """The SSD backward at mamba2-130m.train_4k's shape (b 2, s 4,096, 24
    heads of 64, one group, state 128) and at Zamba2-7B-Instruct's heads
    (b 16 x 8 chunks, 112 heads in 2 groups, state 64)."""
    train = _ssd_bwd_case(torch, np, kind, 2, 4096, 24, 1, 128)
    zamba2 = _ssd_bwd_case(torch, np, kind, 16, 1024, 112, 2, 64)
    keys = ("max_abs_err", "ms", "bound_ms", "plain_ms", "eager_ms")
    return dict(train, **{f"zamba2_{key}": zamba2[key] for key in keys})


def _ssd_bwd_case(torch, np, kind, b, s, h, g, n, p=64, T=128):
    """One SSD backward shape: every gradient of ``ops.ssd_scan`` through
    the Hopper backward against the plain VJP's (autograd through
    ``ref.ssd_scan_ref``), each within SSD_REL of its largest element
    (tests/test_torch_gpu.py holds the same); the kernel pair with the
    reverse scan between them (``ssd_bwd.ssd_bwd_cuda``) timed from CUDA-graph
    replays beside its bound (chipbench's ssd_bwd_roofline.train: twice the
    forward's products at the TF32 rate, or x, dY, dx, G, H, Z, B, C, dB,
    dC, dt and ddt once each in f32), the plain VJP from one eager call."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ssd_bwd import ssd_bwd_cuda

    rng = np.random.default_rng(SEED + 8)
    dev = torch.device(DEVICE)

    def t(a):
        return torch.from_numpy(a.astype(np.float32)).to(dev)

    x, dt = t(rng.standard_normal((b, s, h, p))), t(rng.uniform(1e-3, 0.1, (b, s, h)))
    A = t(-rng.uniform(1.0, 16.0, h))
    B, C = t(rng.standard_normal((b, s, g, n))), t(rng.standard_normal((b, s, g, n)))
    gy = t(rng.standard_normal((b, s, h, p)))
    nc, tri = -(-s // T), T * (T + 1) // 2
    # the plain VJP on a few batch rows at a time (the scan is independent
    # across rows; dA is the sum of the rows'): its einsums hold (rows, nc,
    # h, T, T, p) f32 products, 28 GiB at Zamba2-7B's 16 rows
    rows = max(1, min(b, int(SSD_PLAIN_BYTES // (4 * nc * h * T * T * p))))

    graph = []  # each slice's output and leaves (the plain arm saves its inputs alone)
    for r0 in range(0, b, rows):
        rs = slice(r0, r0 + rows)
        leaves = [v.clone().requires_grad_(True) for v in (x[rs], dt[rs], A, B[rs], C[rs])]
        graph.append((ops.ssd_scan(*leaves, chunk=T, impl="ref"), leaves, gy[rs]))

    def plain():
        parts = [torch.autograd.grad(y, leaves, g, retain_graph=True) for y, leaves, g in graph]
        return [torch.cat(d) if i != 2 else sum(d) for i, d in enumerate(zip(*parts))]

    leaves = [v.clone().requires_grad_(True) for v in (x, dt, A, B, C)]
    grads = {None: torch.autograd.grad(ops.ssd_scan(*leaves, chunk=T), leaves, gy),
             "ref": plain()}
    torch.cuda.synchronize()
    errs = []
    for name, got, want in zip(("x", "dt", "A", "B", "C"), grads[None], grads["ref"]):
        errs.append(float((got - want).abs().max()) / float(want.abs().max()))
        if not bool(torch.isfinite(got).all()) or errs[-1] > SSD_REL:
            raise AssertionError(f"ssd_bwd d{name}: worst element at {errs[-1]:.3g} of the "
                                 f"gradient's largest (tolerance {SSD_REL})")
    del grads
    xc, dtc, a, Bf, Cf = ops._chunk_layout(x, dt, A, B, C, T)
    H = ops.ssd_scan_chunked(x, dt, A, B, C, chunk=T, entry_states=True)[-1]
    dyc, Ab = ops._per_chunk(gy, T), A.repeat(b).contiguous()

    def kernel():
        return ssd_bwd_cuda(xc, dtc, a, Ab, Bf, Cf, H, dyc, None, heads=h)

    ms = _time_ms(torch, kernel, 5)
    eager = _eager_ms(torch, kernel, 5)
    del xc, dtc, a, Bf, Cf, H, dyc
    torch.cuda.empty_cache()
    plain_ms = _eager_ms(torch, plain, 1)
    del graph
    n_ops = 2.0 * b * nc * (2.0 * g * tri * n + h * (2.0 * tri * p + 4.0 * T * n * p))
    n_bytes = 4.0 * (3 * b * h * nc * T * p + 3 * b * h * nc * n * p + 4 * b * nc * T * g * n
                     + 2 * b * h * nc * T)
    bound, by = _bound_ms(n_bytes, n_ops, TF32_OPS_PER_S)
    print(f"[kernel] ssd_bwd b={b} s={s} h={h} g={g} n={n} p={p} T={T}: {ms:.4f} ms = "
          f"{100 * bound / ms:.1f}% of the bound {bound:.4f} ms by {by} ({n_bytes / 1e6:.1f} MB, "
          f"{n_ops / 1e9:.2f} GFLOP at the TF32 rate), plain VJP {plain_ms:.2f} ms ({rows} of "
          f"{b} batch rows a call; eager calls "
          f"{eager:.4f} ms; worst element of dx, ddt, dA, dB, dC at "
          f"{', '.join(f'{e:.3g}' for e in errs)} of the largest, tolerance {SSD_REL}) on {kind}",
          flush=True)
    torch.cuda.empty_cache()
    return dict(ms=ms, eager_ms=eager, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                max_abs_err=max(errs), library_ms=None)


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


def _quick_characterization(node, app, grid):
    """A characterization on the golden's reduced grid (``quick_grid``:
    ``tests/conftest.py``'s blackscholes_ch, 288 samples)."""
    from repro_torch.core import characterize

    return characterize.characterize(characterize.NodeSampler(node, app), app, **grid)


def phase_table1(torch, np, device=DEVICE):
    """The paper's Table 1 (§3.4): 10-fold cross_validate of the four apps
    at full characterization, held to the JAX package's (MAE, PAE); then
    grid_search on the quick blackscholes set and fit_many(iters=50) on the
    four quick sets, held to its (C, gamma) and its predictions."""
    from repro_torch.core import characterize, svr
    from repro_torch.core.node_sim import FREQ_GRID, MAX_CORES, Node

    with open(TABLE1_GOLDEN) as f:
        golden = json.load(f)
    t0 = time.perf_counter()
    node = Node(seed=golden["seed"])
    worst = 0.0
    for app in golden["apps"]:
        ch = characterize.characterize(characterize.NodeSampler(node, app), app)
        t1 = time.perf_counter()
        mae, pae = ch.cross_validate(k=10, device=device)
        want = golden["table1"][app]
        rel = max(abs(mae - want["mae"]) / want["mae"], abs(pae - want["pae"]) / want["pae"])
        worst = max(worst, rel)
        print(f"[table1] {app}: n {len(ch.times)}, MAE {mae!r} s, PAE {pae!r} (JAX "
              f"{want['mae']!r}, {want['pae']!r}; rel {rel:.3g}); 10 folds "
              f"{time.perf_counter() - t1:.3f} s", flush=True)
        if len(ch.times) != want["n"] or not rel <= TABLE1_REL:
            raise AssertionError(f"table1 {app}: (MAE, PAE) ({mae!r}, {pae!r}) vs the JAX "
                                 f"golden ({want['mae']!r}, {want['pae']!r}): rel {rel:.3g} > "
                                 f"{TABLE1_REL}")
    t0 = _stage(f"table1: cross_validate(k=10), 4 apps x 1,760 samples (worst rel {worst:.3g})",
                t0)

    gold = golden["grid_search"]
    bs = _quick_characterization(Node(seed=gold["seed"]), "blackscholes", golden["quick_grid"])
    gs = svr.grid_search(bs.features, bs.times, device=device)
    print(f"[table1] grid_search on the quick blackscholes set: C {gs['C']!r}, gamma "
          f"{gs['gamma']!r}, CV PAE {gs['pae']!r} (JAX C {gold['C']!r}, gamma "
          f"{gold['gamma']!r}, PAE {gold['pae']!r})", flush=True)
    if (gs["C"], gs["gamma"]) != (gold["C"], gold["gamma"]) or not (
            abs(gs["pae"] - gold["pae"]) <= TABLE1_REL * gold["pae"]):
        raise AssertionError(f"grid_search picked {gs}, the JAX golden {gold}")
    t0 = _stage("table1: grid_search (9 pairs x 5 folds)", t0)

    gold = golden["fit_many_ista"]
    node = Node(seed=golden["seed"])
    quick = [_quick_characterization(node, app, golden["quick_grid"]) for app in golden["apps"]]
    models = svr.fit_many(quick, iters=gold["iters"], device=device)
    F, P = np.meshgrid(FREQ_GRID, np.arange(1, MAX_CORES + 1), indexing="ij")
    grid = np.stack([F.ravel(), P.ravel(), np.full(F.size, gold["input_size"])],
                    1).astype(np.float32)
    preds = svr.predict_many(models, grid)
    for app, m, pred in zip(golden["apps"], models, preds):
        want = np.asarray(gold["models"][app]["pred"])
        got = pred.double().cpu().numpy()
        rel = float(np.max(np.abs(got - want) / np.abs(want)))
        print(f"[table1] fit_many(iters={gold['iters']}) {app}: bias {m.bias!r} (JAX "
              f"{gold['models'][app]['bias']!r}), {got.size} predictions within rel {rel:.3g} "
              f"of JAX's", flush=True)
        if not (np.isfinite(got).all() and rel <= ISTA_PRED_REL):
            raise AssertionError(f"fit_many(iters={gold['iters']}) {app}: predictions rel "
                                 f"{rel:.3g} > {ISTA_PRED_REL}")
    _stage(f"table1: fit_many(iters={gold['iters']}) on 4 quick sets", t0)


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


def _fleet_job_rows(sched):
    """The scheduler's completed jobs as the golden's ``job_fields`` rows."""
    return [
        [c.placement.job.job_id, c.placement.node, c.placement.frequency_ghz,
         c.placement.cores, c.placement.start_s, c.finish_s, c.total_energy_j,
         c.met_deadline, c.migrations, c.placement.pareto_fallback,
         c.placement.negotiated]
        for c in sched.completed
    ]


class _Kept:
    """While open: every ``FleetScheduler`` launch's (engine, SVR model) by
    (scheduler, job), and every ``SchedulerService`` that drains."""

    def __enter__(self):
        from repro_torch.fleet.cluster import family_key
        from repro_torch.fleet.scheduler import FleetScheduler
        from repro_torch.fleet.service import SchedulerService

        self.surfaces, self.services = {}, []
        self._launch, self._drain = FleetScheduler._launch, SchedulerService.drain
        launch, drain, kept = self._launch, self._drain, self

        def launched(sched, placement, **kw):
            job = placement.job
            eng = sched._engine_for(sched._device_of(job))
            key = job.terms if job.terms is not None else family_key(job.app, job.input_size)
            kept.surfaces[(id(sched), job.job_id)] = (eng, eng._fits[key].model)
            return launch(sched, placement, **kw)

        def drained(service, **kw):
            kept.services.append(service)
            return drain(service, **kw)

        FleetScheduler._launch, SchedulerService.drain = launched, drained
        return self

    def __exit__(self, *exc):
        from repro_torch.fleet.scheduler import FleetScheduler
        from repro_torch.fleet.service import SchedulerService

        FleetScheduler._launch, SchedulerService.drain = self._launch, self._drain

    def of(self, sched) -> dict:
        """Job id -> (engine, model) of its last launch under ``sched``."""
        return {jid: v for (sid, jid), v in self.surfaces.items() if sid == id(sched)}


def _fleet_sim_run(argv):
    """``python -m repro_torch.fleet`` with ``argv`` on the card. Returns the
    report, the engine scenario's scheduler, and for each of its jobs the
    (engine, SVR model) its last launch was planned on."""
    from repro_torch.fleet import __main__ as fleet_main

    kept = {}
    names = ("run_fleet_comparison", "run_mixed_fleet_comparison")  # --mixed: the latter
    inner = {name: getattr(fleet_main, name) for name in names}

    def keeping(fn):
        def comparison(*args, **kw):
            report, sched = fn(*args, **kw)
            kept["sched"] = sched
            return report, sched
        return comparison

    for name in names:
        setattr(fleet_main, name, keeping(inner[name]))
    try:
        with _Kept() as launches:
            report = fleet_main.main(list(argv) + ["--device", DEVICE])
    finally:
        for name in names:
            setattr(fleet_main, name, inner[name])
    sched = kept["sched"]
    return report, sched, launches.of(sched)


def _surface_energy(torch, np, sched, surface, node_name, f, cores):
    """Predicted energy (J) of running on ``node_name`` at (f, cores), on the
    port's own surface: the SVR's reference step time (the plain Gram, so
    no launch is counted) projected by the node's spec skews."""
    from repro_torch.core import svr
    from repro_torch.core.engine import TIME_FLOOR

    eng, model = surface
    t = svr.predict(model, np.array([[f, cores]], np.float32), impl="ref")
    t_ref = max(float(torch.as_tensor(t).reshape(-1)[0]), TIME_FLOOR)
    return sched._node_by_name(node_name).spec.expected_energy(eng.power, f, cores, t_ref)


def _fleet_schedule(sched):
    """What "the same schedule, bit for bit" compares: the completed jobs'
    rows and predicted energies, the rounds, refreshes and preemptions,
    total energy, makespan and misses."""
    return {
        "jobs": _fleet_job_rows(sched),
        "predicted_energy_j": [c.placement.predicted_energy_j for c in sched.completed],
        "restarts": [c.restarts for c in sched.completed],
        "rounds": len(sched.rounds),
        "refreshes": list(sched.telemetry.refreshes),
        "preemptions": [(p.job_id, p.time_s, p.burned_j) for p in sched.telemetry.preemptions],
        "energy_j": sched.total_energy_j(),
        "makespan_s": sched.makespan_s,
        "misses": sched.deadline_misses(),
    }


def _launch_order(rows):
    """Completed-job rows in launch order: by start time, then job id."""
    return sorted(rows, key=lambda r: (r[4], r[0]))


def _check_jobs(torch, np, label, sched, surfaces, want, want_pred):
    """``sched``'s completed jobs against the rows ``want`` (the golden's
    ``job_fields``) and their predicted energies ``want_pred``: equal, or
    the first placement (in launch order) that differs is a near-tie
    within NEAR_TIE_REL on the port's surface; every job launched before
    it predicts its energy within FLEET_PRED_REL. Returns the near-tie's
    line or None, the largest predicted-energy gap, and the jobs placed as
    in the golden."""
    rows = _fleet_job_rows(sched)
    mine_l, want_l = _launch_order(rows), _launch_order(want)
    first = next((i for i, (a, b) in enumerate(zip(mine_l, want_l)) if a != b),
                 None if len(rows) == len(want) else min(len(rows), len(want)))
    if first is None and rows != want:
        raise AssertionError(f"{label}: the golden's jobs complete in another order")
    pred = {c.placement.job.job_id: c.placement.predicted_energy_j for c in sched.completed}
    gold_pred = {r[0]: e for r, e in zip(want, want_pred)}
    same = [r[0] for r in want_l[:first]]
    pred_rel = max((abs(pred[j] - gold_pred[j]) / abs(gold_pred[j]) for j in same), default=0.0)
    if not pred_rel <= FLEET_PRED_REL:
        raise AssertionError(f"{label}: the jobs placed as in the golden predict their "
                             f"energy {pred_rel:.3g} off the golden's, over {FLEET_PRED_REL}")
    near_tie = None
    if first is not None:
        mine = {r[0]: r for r in rows}
        theirs = {r[0]: r for r in want}
        jids = [r[0] for r in (want_l[first:first + 1] + mine_l[first:first + 1])]
        moved = [j for j in jids
                 if j not in mine or j not in theirs or mine[j][1:4] != theirs[j][1:4]]
        if not moved or moved[0] not in mine or moved[0] not in theirs:
            raise AssertionError(f"{label}: launch {first} differs from the golden "
                                 f"without a different placement: {mine_l[first:first + 1]} "
                                 f"vs {want_l[first:first + 1]}")
        jid = moved[0]
        (_, node_p, f_p, c_p), (_, node_g, f_g, c_g) = mine[jid][:4], theirs[jid][:4]
        e_p = _surface_energy(torch, np, sched, surfaces[jid], node_p, f_p, c_p)
        e_g = _surface_energy(torch, np, sched, surfaces[jid], node_g, f_g, c_g)
        rel = abs(e_g - e_p) / e_p
        near_tie = (f"{label}: job {jid} port ({node_p}, {f_p}, {c_p}) vs golden "
                    f"({node_g}, {f_g}, {c_g}), port energies {e_p!r} vs {e_g!r}, rel {rel:.3g}")
        if not rel <= NEAR_TIE_REL:
            raise AssertionError("placement differs from the golden: " + near_tie)
        print(f"[near-tie] {near_tie}", flush=True)
    return near_tie, pred_rel, same


def _check_fleet_run(torch, np, gold, report, sched, surfaces):
    """The engine scenario's completed jobs against the golden's: equal, or
    the first placement (in launch order) that differs is a near-tie on the
    port's surface and the rest lies within FLEET_ENERGY_REL of total
    energy with equal misses. Every job launched before that predicts its
    energy within FLEET_PRED_REL of the golden's. The governor scenarios,
    which no SVR steers, equal the golden's bit for bit. Returns the
    near-tie's line or None, and the largest predicted-energy gap."""
    label = " ".join(gold["argv"]) or "(default)"
    rows = _fleet_job_rows(sched)
    near_tie, pred_rel, same = _check_jobs(torch, np, f"fleet {label}", sched, surfaces,
                                           gold["jobs"], gold["predicted_energy_j"])
    for name, g in gold["scenarios"].items():
        s = report.scenarios[name]
        got = {"total_energy_j": s.total_energy_j, "makespan_s": s.makespan_s,
               "deadline_misses": s.deadline_misses}
        if near_tie is None or not name.startswith("engine"):
            if got != g:
                raise AssertionError(f"fleet {label}: scenario {name} {got} != golden {g}")
        elif (abs(got["total_energy_j"] - g["total_energy_j"]) > FLEET_ENERGY_REL
              * g["total_energy_j"] or got["deadline_misses"] != g["deadline_misses"]):
            raise AssertionError(f"fleet {label}: scenario {name} {got} vs golden {g} "
                                 f"after the near-tie")
    counts = (sched.telemetry.n_recharacterizations, sched.migrations())
    if near_tie is None and counts != (gold["refits"], gold["migrations"]):
        raise AssertionError(f"fleet {label}: (refits, migrations) {counts} != golden "
                             f"{(gold['refits'], gold['migrations'])}")
    e = report.engine
    print(f"[fleet] {label}: {len(rows)} jobs "
          f"{'equal to' if near_tie is None else 'after a near-tie against'} the JAX golden; "
          f"predicted energy of the {len(same)} jobs placed as in the golden within "
          f"{pred_rel!r} of the golden's; "
          f"engine {e.total_energy_j!r} J, makespan {e.makespan_s!r} s, "
          f"{e.deadline_misses} misses, refits {counts[0]}, migrations {counts[1]}; "
          f"{len(report.scenarios) - 1} baseline scenarios "
          f"{'bit for bit' if near_tie is None else 'held'}", flush=True)
    return near_tie, pred_rel


def phase_fleet_sim(torch, np, smi):
    """The four golden runs of ``python -m repro_torch.fleet`` on the card.
    Returns each run's engine-scenario schedule (``_fleet_schedule``) by
    its argv."""
    with open(FLEET_GOLDEN) as f:
        golden = json.load(f)
    if len(golden["runs"]) != 4:
        raise AssertionError(f"{len(golden['runs'])} fleet golden runs, not 4")
    print(f"[fleet] {smi}", flush=True)
    near_ties, pred_rel, schedules = [], 0.0, {}
    for gold in golden["runs"]:
        t0 = time.perf_counter()
        report, sched, surfaces = _fleet_sim_run(gold["argv"])
        schedules[tuple(gold["argv"])] = _fleet_schedule(sched)
        _stage(f"fleet simulation: python -m repro_torch.fleet {' '.join(gold['argv'])} "
               f"--device {DEVICE} ({len(sched.rounds)} rounds)", t0)
        tie, rel = _check_fleet_run(torch, np, gold, report, sched, surfaces)
        near_ties.append(tie)
        pred_rel = max(pred_rel, rel)
    print(f"[fleet] {sum(t is None for t in near_ties)} of 4 runs equal the JAX golden, "
          f"{sum(t is not None for t in near_ties)} near-ties; predicted energies within "
          f"{pred_rel!r} of the golden's (limit {FLEET_PRED_REL})", flush=True)
    return schedules


def _round_mantissa(torch, x, bits: int):
    """f32 ``x`` rounded to ``bits`` mantissa bits (half away from zero in
    the magnitude's bits)."""
    drop = 23 - bits
    i = x.contiguous().view(torch.int32)
    return ((i + (1 << (drop - 1))) & ~((1 << drop) - 1)).view(torch.float32)


def phase_fleet_control(torch, np):
    """The --quick run on a Gram (the kernel's) rounded to CONTROL_BITS
    mantissa bits must be refused by ``_check_fleet_run``: the check sees a
    fault that shifts the SVR's predictions, not only one that moves a
    placement."""
    from repro_torch.kernels import ops

    with open(FLEET_GOLDEN) as f:
        gold = next(r for r in json.load(f)["runs"] if r["argv"] == ["--quick"])
    inner = ops.rbf_gram
    ops.rbf_gram = lambda *a, **kw: _round_mantissa(torch, inner(*a, **kw), CONTROL_BITS)
    try:
        report, sched, surfaces = _fleet_sim_run(gold["argv"])
    finally:
        ops.rbf_gram = inner
    try:
        _check_fleet_run(torch, np, gold, report, sched, surfaces)
    except AssertionError as refused:
        print(f"[fleet] control, the Gram rounded to {CONTROL_BITS} mantissa bits: refused "
              f"({refused})", flush=True)
        return
    raise AssertionError(f"fleet: the control (the Gram rounded to {CONTROL_BITS} mantissa "
                         f"bits) passed the golden check")


def _replay_fleet_calls(torch, name: str, calls, label: str = "fleet") -> float:
    """Every call the ``label`` runs made of one planning kernel, again:
    kernel against plain version on the same inputs (rbf_gram within
    RBF_ATOL, the others exactly). Returns the largest error."""
    from repro_torch.kernels import ops

    fn = getattr(ops, name)
    err, rows, feasible = 0.0, 0, 0
    for shape, args, kw in calls:
        got, want = fn(*args, **kw), fn(*args, **kw, impl="ref")
        if name == "rbf_gram":
            e = float((got - want).abs().max())
            bad = not e <= RBF_ATOL
        else:
            e = float((got.long() - want.long()).abs().max())
            bad = bool((got != want).any())
            mask = args[-1]  # (B, G): plan_argmin's and pareto_mask's last input
            rows += mask.shape[0]
            feasible += int(mask.any(1).sum())
        if bad:
            raise AssertionError(f"{name} at the {label} shape {shape}: kernel vs plain, "
                                 f"max |err| {e}")
        err = max(err, e)
    if name != "rbf_gram" and not feasible:
        raise AssertionError(f"{name}: the {label} calls hold no row with a feasible point")
    print(f"[{label}] {name}: the {label} runs' {len(calls)} calls replayed, kernel against "
          f"plain, max |err| {err:.3g}"
          + (f"; {feasible} of {rows} rows with a feasible point" if rows else ""), flush=True)
    return err


def phase_fleet_kernels(torch, np, kind, shapes, calls, label="fleet simulation",
                        prefix="fleet"):
    """Each planning kernel against its plain version on every call the
    ``label`` runs made, and timed on their own inputs at the smallest
    and the largest shape it launched at (the call with the most rows
    holding a feasible point). Returns {name: {<prefix>_* numbers}}."""
    check = {"rbf_gram": _check_rbf, "plan_argmin": _check_plan_argmin,
             "pareto_mask": _check_pareto}
    out = {}
    for name in FLEET_KERNELS:
        tally = shapes[name]
        if not tally:
            raise AssertionError(f"{name} never launched in the {label} runs")
        print(f"[launches] {label}: {name} {sum(tally.values())} launches by shape "
              f"{sorted(tally.items(), key=lambda kv: -kv[1])}", flush=True)
        replay_err = _replay_fleet_calls(torch, name, calls[name], prefix)
        by_size = sorted(tally, key=lambda sh: (math.prod(sh), sh))
        small, large = by_size[0], by_size[-1]

        def inputs(shape):
            at = [(args, kw) for sh, args, kw in calls[name] if sh == shape]
            args, kw = max(at, key=lambda c: 0 if name == "rbf_gram"
                           else int(c[0][-1].any(1).sum()))
            return tuple(args) + tuple(kw.values())

        cases = {shape: check[name](torch, np, None, kind, *shape, inputs=inputs(shape))
                 for shape in dict.fromkeys((small, large))}
        # the JSON line carries the largest shape, and the smallest's times
        out[name] = {f"{prefix}_{key}": val for key, val in cases[large].items()
                     if key != "shape"}
        out[name].update({f"{prefix}_shape": list(large), f"{prefix}_small_shape": list(small),
                          f"{prefix}_max_abs_err": max([replay_err] + [
                              r["max_abs_err"] for r in cases.values()])},
                         **{f"{prefix}_small_{key}": cases[small][key]
                            for key in ("ms", "plain_ms", "bound_ms")})
    return out


def _sync(torch):
    if DEVICE == "cuda":
        torch.cuda.synchronize()


def _service_main(torch, argv):
    """``python -m repro_torch.fleet`` with ``argv`` on the card, through a
    fresh ``main``, its report kept off the console. Returns (main's
    result, the ``_Kept`` record, wall seconds ended by a
    synchronisation)."""
    import contextlib
    import io

    from repro_torch.fleet import __main__ as fleet_main

    t0 = time.perf_counter()
    with _Kept() as kept, contextlib.redirect_stdout(io.StringIO()):
        result = fleet_main.main(list(argv) + ["--device", DEVICE])
    _sync(torch)
    return result, kept, time.perf_counter() - t0


def _first_difference(got: dict, want: dict) -> str:
    key = next(k for k in want if got[k] != want[k])
    return f"{key}: {got[key]!r} vs {want[key]!r}"


def _kill_and_resume(torch, argv, label: str, stem: str, svc, k: int):
    """``argv`` (a ``--service`` run) killed before batch k of the
    uninterrupted service ``svc`` (``--kill-at`` the batch before's sim
    time; -1 before batch 0) into the journal ``<stem>-kill<k>.json``, then
    resumed by ``--resume`` in a fresh ``main``: ``svc``'s schedule bit for
    bit, in as many batches. Returns (the kill's sim time, the beliefs the
    journal held, the kill's and the resume's wall seconds)."""
    n, want = svc.n_batches, _fleet_schedule(svc.scheduler)
    kill_path = f"{stem}-kill{k}.json"
    kill_at = svc.scheduler.rounds[k - 1].now if k else -1.0
    killed, _, kill_wall = _service_main(
        torch, argv + ["--journal", kill_path, "--kill-at", repr(kill_at)])
    with open(kill_path) as f:
        payload = json.load(f)
    if killed is not None or payload["n_batches"] != k:
        raise AssertionError(f"{label}: --kill-at {kill_at!r} committed "
                             f"{payload['n_batches']} batches, not {k}")
    _, kept, resume_wall = _service_main(torch, ["--resume", kill_path])
    resumed = kept.services[-1]
    again = _fleet_schedule(resumed.scheduler)
    if again != want or resumed.n_batches != n:
        raise AssertionError(f"{label} killed before batch {k} and resumed: "
                             + (_first_difference(again, want) if again != want
                                else f"{resumed.n_batches} batches, not {n}"))
    return kill_at, len(payload["ledger"]["beliefs"]), kill_wall, resume_wall


def _service_runs(torch, smi, lockstep) -> dict:
    """Phase 5c parts 1-2: each of SERVICE_RUNS through ``--service
    --journal`` against phase 5b's lockstep run of the same arguments, bit
    for bit; then killed before an early, a middle and a late batch
    (``--kill-at`` the batch before's sim time) and resumed by ``--resume``
    in a fresh ``main``: the uninterrupted service's schedule bit for bit,
    in as many batches. Returns {label: wall seconds}."""
    walls, refits = {}, 0
    for i, argv in enumerate(SERVICE_RUNS):
        label = " ".join(argv) or "(default)"
        path = os.path.join(SERVICE_DIR, f"run{i}.json")
        _, kept, wall = _service_main(torch, argv + ["--service", "--journal", path])
        svc = kept.services[-1]
        sched, n = svc.scheduler, svc.n_batches
        got = _fleet_schedule(sched)
        if got != lockstep[tuple(argv)]:
            raise AssertionError(f"service {label} differs from phase 5b's lockstep run: "
                                 f"{_first_difference(got, lockstep[tuple(argv)])}")
        if len(sched.rounds) != n:
            raise AssertionError(f"service {label}: {len(sched.rounds)} rounds in {n} batches")
        walls[label] = wall
        print(f"[service] python -m repro_torch.fleet {label} --service --journal: "
              f"{len(sched.completed)} jobs in {n} batches, equal bit for bit to phase 5b's "
              f"lockstep run (held there to the JAX golden); {wall:.3f} s on {smi}", flush=True)
        for where, k in (("early", 0), ("middle", n // 2), ("late", n - 1)):
            kill_at, n_beliefs, kill_wall, resume_wall = _kill_and_resume(
                torch, argv + ["--service"], f"service {label}",
                os.path.join(SERVICE_DIR, f"run{i}"), svc, k)
            refits += n_beliefs
            print(f"[service] {label}: killed before batch {k} of {n} ({where}; "
                  f"--kill-at {kill_at:.6g}, {kill_wall:.3f} s), python -m repro_torch.fleet "
                  f"--resume drained it in {resume_wall:.3f} s to the uninterrupted schedule "
                  f"bit for bit, {n} batches, {n_beliefs} beliefs re-fitted "
                  f"at recovery; {smi}", flush=True)
    if not refits:
        raise AssertionError("no killed service journal held a belief: the recovery refit "
                             "never ran on the card")
    return walls


def _service_reference_journal(torch, np, smi) -> float:
    """Phase 5c part 3: the JAX package's killed ``--quick --service``
    journal resumed on the card by ``--resume``, against the reference's
    uninterrupted schedule under the near-tie rule. Returns the largest
    predicted-energy gap."""
    import shutil

    with open(SERVICE_GOLDEN) as f:
        gold = json.load(f)
    path = os.path.join(SERVICE_DIR, "jax_journal.json")
    shutil.copy(SERVICE_JOURNAL, path)
    with open(path) as f:
        payload = json.load(f)
    _, kept, wall = _service_main(torch, ["--resume", path])
    svc = kept.services[-1]
    sched = svc.scheduler
    label = "service --quick from the JAX package's journal"
    near_tie, pred_rel, same = _check_jobs(torch, np, label, sched, kept.of(sched),
                                           gold["jobs"], gold["predicted_energy_j"])
    energy, misses = sched.total_energy_j(), sched.deadline_misses()
    if misses != gold["deadline_misses"]:
        raise AssertionError(f"{label}: {misses} misses, golden {gold['deadline_misses']}")
    if near_tie is None and (energy != gold["total_energy_j"]
                             or svc.n_batches != gold["n_batches"]):
        raise AssertionError(f"{label}: {energy!r} J in {svc.n_batches} batches, golden "
                             f"{gold['total_energy_j']!r} J in {gold['n_batches']}")
    if abs(energy - gold["total_energy_j"]) > FLEET_ENERGY_REL * gold["total_energy_j"]:
        raise AssertionError(f"{label}: {energy!r} J after the near-tie, golden "
                             f"{gold['total_energy_j']!r} J")
    print(f"[service] {label} (killed at sim t={payload['now_s']:.0f} s after "
          f"{payload['n_batches']} of {gold['n_batches']} batches, before its drift refit; "
          f"refits on the card after the resume: {sched.telemetry.n_recharacterizations}): "
          f"{len(sched.completed)} jobs "
          f"{'equal to' if near_tie is None else 'after a near-tie against'} the JAX package's "
          f"uninterrupted run; predicted energy of the {len(same)} jobs placed as in it within "
          f"{pred_rel!r}; {energy!r} J, {svc.n_batches} batches; resumed in {wall:.3f} s on "
          f"{smi}", flush=True)
    return pred_rel


def phase_service(torch, np, smi, lockstep):
    """Phase 5c parts 1-3, the planning kernels' main path of the service
    (its launches are counted around this phase)."""
    import shutil

    shutil.rmtree(SERVICE_DIR, ignore_errors=True)
    os.makedirs(SERVICE_DIR)
    walls = _service_runs(torch, smi, lockstep)
    pred_rel = _service_reference_journal(torch, np, smi)
    return walls, pred_rel


def _mixed_service(torch, np, smi, gold, lockstep) -> float:
    """Phase 5d part 2: ``--quick --mixed --service --journal`` against the
    lockstep run bit for bit and the JAX golden's service run under the
    near-tie rule; then killed before its middle batch (the golden's kill
    point) and resumed by ``--resume``: the uninterrupted schedule bit for
    bit, in as many batches. Returns the largest predicted-energy gap."""
    argv = gold["argv"]
    label = " ".join(argv)
    path = os.path.join(SERVICE_DIR, "mixed.json")
    _, kept, wall = _service_main(torch, argv + ["--journal", path])
    svc = kept.services[-1]
    sched, n = svc.scheduler, svc.n_batches
    got = _fleet_schedule(sched)
    if got != lockstep:
        raise AssertionError(f"{label} differs from the lockstep run: "
                             f"{_first_difference(got, lockstep)}")
    near_tie, pred_rel, same = _check_jobs(torch, np, label, sched, kept.of(sched),
                                           gold["jobs"], gold["predicted_energy_j"])
    if sched.deadline_misses() != gold["deadline_misses"]:
        raise AssertionError(f"{label}: {sched.deadline_misses()} misses, golden "
                             f"{gold['deadline_misses']}")
    if near_tie is None and (sched.total_energy_j() != gold["total_energy_j"]
                             or n != gold["n_batches"]):
        raise AssertionError(f"{label}: {sched.total_energy_j()!r} J in {n} batches, golden "
                             f"{gold['total_energy_j']!r} J in {gold['n_batches']}")
    print(f"[mixed] python -m repro_torch.fleet {label} --journal: {len(sched.completed)} "
          f"jobs in {n} batches, equal bit for bit to the lockstep run and "
          f"{'equal to' if near_tie is None else 'after a near-tie against'} the JAX "
          f"package's service run; {wall:.3f} s on {smi}", flush=True)
    kill, k = gold["kill"], n // 2
    kill_at, _, kill_wall, resume_wall = _kill_and_resume(
        torch, argv, label, os.path.join(SERVICE_DIR, "mixed"), svc, k)
    if near_tie is None and (k, kill_at) != (kill["batch"], kill["at_s"]):
        raise AssertionError(f"{label}: kill point (batch {k}, t {kill_at!r}) is not the "
                             f"golden's {kill}")
    print(f"[mixed] {label}: killed before batch {k} of {n} (--kill-at {kill_at:.6g}, "
          f"the JAX package's kill point; {kill_wall:.3f} s), --resume drained it in "
          f"{resume_wall:.3f} s to the uninterrupted schedule bit for bit; {smi}", flush=True)
    return pred_rel


def phase_auto_energy(torch, np, smi, gold):
    """``launch.train --arch mamba2-130m --smoke --auto-energy`` on the card:
    the plan it logs (the analytic roofline: no dry-run artifact) against
    the JAX package's, its other fields equal and its floats within
    FLEET_PRED_REL."""
    from repro_torch.core import planner
    from repro_torch.launch import train

    kept = []
    inner = planner.EnergyOptimalPlanner.plan_for_workload

    def plan_for_workload(self, *args, **kw):
        kept.append(inner(self, *args, **kw))
        return kept[-1]

    planner.EnergyOptimalPlanner.plan_for_workload = plan_for_workload
    t0 = time.perf_counter()
    try:
        train.main(gold["argv"] + ["--steps", "1", "--device", DEVICE, "--ckpt-dir",
                                   os.path.join(SERVICE_DIR, "auto_energy_ckpt")])
    finally:
        planner.EnergyOptimalPlanner.plan_for_workload = inner
    wall = time.perf_counter() - t0
    (plan,) = kept
    want = gold["plan"]
    rel = max(abs(getattr(plan, k) - v) / max(abs(v), 1e-300) for k, v in want.items()
              if isinstance(v, float))
    exact = {k: getattr(plan, k) for k, v in want.items() if not isinstance(v, float)}
    exact["mesh"] = list(exact["mesh"])
    if exact != {k: v for k, v in want.items() if not isinstance(v, float)}:
        raise AssertionError(f"auto-energy: plan {exact} != the JAX package's {want}")
    if not rel <= FLEET_PRED_REL:
        raise AssertionError(f"auto-energy: {plan.summary()!r} ({rel:.3g} off) against the "
                             f"JAX package's {gold['summary']!r}")
    print(f"[auto-energy] launch.train {' '.join(gold['argv'])}: {plan.summary()}; equal to "
          f"the JAX package's plan ({gold['summary']}), its floats within {rel!r}; "
          f"{wall:.3f} s (one training step included) on {smi}", flush=True)


def phase_mixed(torch, np, smi):
    """Phase 5d: the mixed CPU + TPU fleet (``--quick --mixed``: the zoo's
    TPU jobs on the analytic roofline, lockstep, then as a service with a
    kill and a resume) against the JAX golden, then ``launch.train
    --auto-energy``. Returns the largest predicted-energy gap."""
    with open(FLEET_GOLDEN) as f:
        golden = json.load(f)
    gold = golden["mixed"]
    os.makedirs(SERVICE_DIR, exist_ok=True)
    t0 = time.perf_counter()
    report, sched, surfaces = _fleet_sim_run(gold["lockstep"]["argv"])
    _stage(f"mixed fleet: python -m repro_torch.fleet {' '.join(gold['lockstep']['argv'])} "
           f"--device {DEVICE} ({len(sched.rounds)} rounds)", t0)
    _, rel = _check_fleet_run(torch, np, gold["lockstep"], report, sched, surfaces)
    tpu = sum(c.placement.job.device == "tpu" for c in sched.completed)
    if not tpu:
        raise AssertionError("mixed fleet: no TPU job completed")
    print(f"[mixed] {tpu} of {len(sched.completed)} jobs are the zoo's TPU workloads, "
          f"characterized by the analytic roofline", flush=True)
    rel = max(rel, _mixed_service(torch, np, smi, gold["service"], _fleet_schedule(sched)))
    phase_auto_energy(torch, np, smi, golden["auto_energy"])
    return rel


def _quick_service_trace():
    """The ``--quick`` run's scheduler on the card, its 12 jobs and its
    drift event, as ``python -m repro_torch.fleet --quick --service``
    builds them."""
    from repro_torch.fleet import __main__ as fleet_main

    cfg = dict(quick=True, nodes=4, seed=0, fallback=False, horizon_s=0.0,
               migration_cost_j=2000.0)
    input_sizes = fleet_main._grids(True, 0)[-1]
    jobs = fleet_main.build_jobs(12, seed=0, input_sizes=input_sizes)
    drift = [(jobs[len(jobs) // 3].arrival_s + 1.0, fleet_main.DRIFT_APP,
              fleet_main.DRIFT_FACTOR)]
    return (lambda: fleet_main._build_scheduler_from_config(cfg, DEVICE)), jobs, drift


def phase_service_faults(torch, np, smi):
    """Phase 5c part 4: one fault of each kind on the ``--quick`` pool with
    heartbeats every SERVICE_HEARTBEAT_S (tests/helpers/torch_faults.py,
    the seeds of SERVICE_FAULT_SEEDS): each lands, and the run ends with
    every job done and the honest ledger (a job's joules are its last
    segment's plus its carried priors; the fleet's, their sum)."""
    sys.path.insert(0, os.path.join(HERE, "tests"))
    from helpers import torch_faults
    from repro_torch.fleet.service import JournalTorn, SchedulerService

    build, jobs, drift = _quick_service_trace()
    nodes = [n.name for n in build().pool]
    lo, hi = SERVICE_FAULT_WINDOW_S
    for kind, seed in SERVICE_FAULT_SEEDS.items():
        fault = torch_faults.single_fault_schedule(seed, nodes=nodes, t_lo_s=lo, t_hi_s=hi)
        if fault.kind != kind:
            raise AssertionError(f"fault seed {seed} draws {fault.kind}, not {kind}")
        path = os.path.join(SERVICE_DIR, f"fault-{kind}.json")
        t0 = time.perf_counter()
        sched = build()
        svc = SchedulerService(sched, journal=path, heartbeat_period_s=SERVICE_HEARTBEAT_S)
        torch_faults.inject(svc, fault)
        try:
            svc.run(jobs, drift_events=drift)
            if kind == "node-down":
                landed = any(p.from_node == fault.node for p in sched.telemetry.preemptions)
            else:
                landed = kind == "heartbeat-loss" and not svc.managers[fault.node].available
        except JournalTorn:
            sched = build()
            svc = SchedulerService.resume(path, sched, heartbeat_period_s=SERVICE_HEARTBEAT_S)
            svc.drain()
            landed = True
        _sync(torch)
        wall = time.perf_counter() - t0
        done = sched.completed
        if not landed:
            raise AssertionError(f"fault {fault} did not land")
        if sorted(c.placement.job.job_id for c in done) != sorted(j.job_id for j in jobs):
            raise AssertionError(f"fault {kind}: jobs lost")
        for c in done:
            if not (c.total_energy_j == c.result.energy_j + c.prior_energy_j
                    and c.total_energy_j > 0):
                raise AssertionError(f"fault {kind}: job {c.placement.job.job_id}'s ledger")
        if not math.isclose(sched.total_energy_j(), sum(c.total_energy_j for c in done)):
            raise AssertionError(f"fault {kind}: the fleet total is not the jobs' sum")
        print(f"[service] fault {kind} (seed {seed}, sim t={fault.time_s:.0f} s, node "
              f"{fault.node}): landed; {len(done)} of {len(jobs)} jobs done, "
              f"{sum(c.restarts for c in done)} restarts, carried "
              f"{sum(c.prior_energy_j for c in done):.6g} J, honest ledger; {wall:.3f} s on "
              f"{smi}", flush=True)


def phase_service_batches(torch, np):
    """Phase 5c part 5: ``svr.fit_many`` of three sets alone and in one
    batch predict a grid bit for bit on the card (the recovery refit's
    soundness)."""
    from repro_torch.core import svr
    from repro_torch.core.engine import ENGINE_FIT_KW

    rng = np.random.default_rng(0)
    sets = []
    for i in range(3):
        x = np.asarray(rng.uniform([1.0, 1], [3.5, 32], (12, 2)), np.float32)
        y = np.asarray(10.0 / x[:, 0] + 50.0 / x[:, 1] + i, np.float32)
        sets.append((x, y))
    grid = np.asarray(rng.uniform([1.0, 1], [3.5, 32], (40, 2)), np.float32)
    batched = svr.fit_many(sets, method="auto", device=DEVICE, **ENGINE_FIT_KW)
    for i in range(3):
        alone = svr.fit_many([sets[i]], method="auto", device=DEVICE, **ENGINE_FIT_KW)
        if not torch.equal(svr.predict_each(alone, [grid])[0],
                           svr.predict_each([batched[i]], [grid])[0]):
            raise AssertionError(f"fit_many on the card: set {i} alone and in a batch differ")
    print("[service] fit_many on the card: 3 sets alone and in one batch predict a "
          "40-point grid bit for bit", flush=True)


def _apps_time(torch, fn):
    _sync(torch)
    t0 = time.perf_counter()
    out = fn()
    _sync(torch)
    return out, (time.perf_counter() - t0) * 1e3


def phase_apps(torch, np, smi):
    """Phase 5c part 8: the four PARSEC apps on the card. At DEFAULT_N
    against tests/data/torch_port_apps_golden.npz (the JAX package's):
    within APPS_SCALE_REL of each output's largest magnitude, swaptions
    (its draws are the card's generator's) each price within APPS_SE_WIDTH
    joint standard errors. Then at APPS_NATIVE_N: finite, with the
    reference's domain properties. Each is timed on its second call, host
    clock to a synchronisation."""
    from repro_torch.apps import APPS, blackscholes

    with np.load(APPS_GOLDEN) as f:
        gold = {k: f[k] for k in f.files}
    for name, mod in sorted(APPS.items()):
        inputs = mod.make_inputs(mod.DEFAULT_N, seed=0, device=DEVICE)
        mod.run(inputs, device=DEVICE)  # warm: the first call loads the card's kernels
        out, ms = _apps_time(torch, lambda: mod.run(inputs, device=DEVICE))
        got = {k: v.cpu().numpy() for k, v in out.items()}
        if name == "swaptions":
            want_p, want_se = gold["swaptions/price"], gold["swaptions/stderr"]
            width = APPS_SE_WIDTH * np.sqrt(got["stderr"] ** 2 + want_se ** 2)
            worst = float((np.abs(got["price"] - want_p) / width).max())
            if not worst <= 1.0:
                raise AssertionError(f"swaptions: a price {worst:.3g} of its limit off the JAX "
                                     f"package's")
            note = f"prices within {worst:.3g} of {APPS_SE_WIDTH:g} joint standard errors"
        else:
            errs = {}
            for key, want in ((k[len(name) + 1:], v) for k, v in gold.items()
                              if k.startswith(name + "/")):
                errs[key] = float(np.abs(got[key] - want).max() / np.abs(want).max())
                if not errs[key] <= APPS_SCALE_REL[name]:
                    raise AssertionError(f"{name} {key}: {errs[key]:.3g} of its scale off the "
                                         f"JAX package's, over {APPS_SCALE_REL[name]}")
            note = "max |err| / scale " + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
        print(f"[apps] {name} n={mod.DEFAULT_N} against the JAX golden: {note} (limit "
              f"{APPS_SCALE_REL.get(name, 'statistical')}); {ms:.3f} ms on {smi}", flush=True)

    for name, n in APPS_NATIVE_N.items():
        mod = APPS[name]
        inputs = mod.make_inputs(n, seed=0, device=DEVICE)
        if name == "fluidanimate":  # three steps, as the reference's property test
            def call(state=inputs):
                for _ in range(3):
                    state = {**state, **mod.run({"pos": state["pos"], "vel": state["vel"]},
                                                device=DEVICE)}
                return state
        else:
            def call():
                return mod.run(inputs, device=DEVICE)
        call()  # warm: the allocator's pool at this size
        out, ms = _apps_time(torch, call)
        for key, val in out.items():
            if torch.is_tensor(val) and val.is_floating_point() and not bool(
                    torch.isfinite(val).all()):
                raise AssertionError(f"{name} n={n}: non-finite {key}")
        if name == "blackscholes":
            price = out["price"]
            bound = torch.where(inputs["is_call"], inputs["spot"], inputs["strike"])
            calls = blackscholes.run({**inputs, "is_call": torch.ones_like(inputs["is_call"])},
                                     device=DEVICE)["price"].double()
            puts = blackscholes.run({**inputs, "is_call": torch.zeros_like(inputs["is_call"])},
                                    device=DEVICE)["price"].double()
            s, k, r, t = (inputs[c].double() for c in ("spot", "strike", "rate", "tte"))
            parity = float((calls - puts - (s - k * torch.exp(-r * t))).abs().max())
            ok = bool((price >= -1e-3).all() and (price <= bound + 1e-3).all()) and parity < 2e-2
            note = f"put-call parity within {parity:.3g}, 0 <= price <= bound"
        elif name == "swaptions":
            price, se = out["price"], out["stderr"]
            ok = bool((price >= -1e-6).all() and (se >= 0).all()
                      and (se < torch.clamp_min(price, 1e-4) * 5 + 1e-3).all())
            note = (f"{tuple(price.shape)[0]} prices x {mod.TRIALS} trials, >= 0, stderr "
                    f"max {float(se.max()):.3g}")
        elif name == "raytrace":
            img = out["image"]
            ok = (tuple(img.shape) == (n, n, 3) and bool((img >= 0).all() and (img <= 1).all())
                  and float(img.std()) > 0.01)
            note = f"({n}, {n}, 3) image in [0, 1], std {float(img.std()):.3g}"
        else:
            pos = out["pos"]
            ok = bool((pos >= 0).all() and (pos <= 1.0).all() and (out["density"] > 0).all())
            note = "3 steps, in the box, density > 0"
        if not ok:
            raise AssertionError(f"{name} n={n}: a property failed ({note})")
        print(f"[apps] {name} n={n:,}: {note}; {ms:.3f} ms on {smi}", flush=True)


def _golden_params(golden, prefix: str) -> dict:
    """A reference pytree from a golden's ``<prefix><dotted path>`` arrays."""
    from repro_torch import convert

    return convert.unflatten_reference({key[len(prefix):]: golden[key] for key in golden.files
                                        if key.startswith(prefix)})


def _reference_params(golden, arch_id: str) -> dict:
    """The parameter pytree the JAX package served one arch with: the
    golden's flattened ``<arch>/param/<dotted path>`` arrays, or the
    weights drawn from its ``<arch>/param_seed`` in the shapes of
    ``<arch>/param_shapes``."""
    from repro_torch import convert

    if f"{arch_id}/param_seed" in golden.files:
        return convert.seeded_reference_params(
            json.loads(str(golden[f"{arch_id}/param_shapes"])),
            int(golden[f"{arch_id}/param_seed"]))
    return _golden_params(golden, f"{arch_id}/param/")


def _serve_extras(golden, arch_id: str) -> dict:
    """The golden's whisper frames or phi-3-vision patches, as serve.run's
    keyword arguments."""
    return {key: golden[f"{arch_id}/{key}"] for key in ("frames", "images")
            if f"{arch_id}/{key}" in golden.files}


def _serve_launches(cfg, gen: int) -> dict:
    """The kernel launches of one serve.run of ``gen`` tokens (a prefill
    and gen - 1 decode steps), per kernel: flash_attention once per
    attention call (an encoder-decoder's encoder, decoder self- and
    cross-attention at prefill, then self and cross at each step; an LM's
    attention layers and zamba2's shared-block calls at prefill and at
    each step; Zamba2-7B-Instruct's once per hybrid layer), ssd_chunks
    once per Mamba2 layer at prefill (decode is the plain recurrence)."""
    if hasattr(cfg, "n_dec_layers"):
        at_prefill, a_step, ssd = cfg.n_enc_layers + 2 * cfg.n_dec_layers, 2 * cfg.n_dec_layers, 0
    else:
        kinds = cfg.kinds()
        ssd = kinds.count("mamba")
        shared = (len(cfg.hybrid_layers) or cfg.n_groups) if cfg.shared_attn else 0
        at_prefill = a_step = len(kinds) - ssd + shared
    return {"flash_attention": at_prefill + a_step * (gen - 1), "ssd_chunks": ssd,
            "flash_prefill": at_prefill, "flash_step": a_step}


def phase_serve_golden(torch, np):
    """SMOKE width on the card, with the kernels, on the JAX package's
    weights, prompts (and whisper's frames, phi-3-vision's patches): logits
    and greedy tokens against its own."""
    from repro_torch import convert
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    golden = np.load(SERVE_GOLDEN)
    for arch_id in SERVE_ARCHS:
        arch = get_arch(arch_id)
        cfg = arch.smoke
        model = convert.params_from_reference(_reference_params(golden, arch_id), cfg, DEVICE)
        want_tokens = golden[f"{arch_id}/tokens"]
        gen = want_tokens.shape[1]
        gap = float(golden[f"{arch_id}/min_top2_gap"])
        if gap <= 2 * SERVE_GOLDEN_ATOL:
            raise AssertionError(f"{arch_id}: golden top-2 gap {gap} is within tolerance")
        before = dict(ops.LAUNCHES)
        out = serve.run(arch, cfg, model, golden[f"{arch_id}/prompts"], gen,
                        **_serve_extras(golden, arch_id))
        want = _serve_launches(cfg, gen)
        launched = {name: ops.LAUNCHES[name] - before[name]
                    for name in ("flash_attention", "ssd_chunks")}
        if launched != {name: want[name] for name in launched}:
            raise AssertionError(f"{arch_id}: launches {launched}, not {want}")
        err_prefill = float(np.abs(out.prefill_logits.cpu().numpy()
                                   - golden[f"{arch_id}/prefill_logits"]).max())
        step = torch.stack(out.step_logits).cpu().numpy()
        err_steps = float(np.abs(step - golden[f"{arch_id}/step_logits"]).max())
        got_tokens = out.tokens.cpu().numpy()
        print(f"[serve golden] {arch_id} SMOKE on the card: prefill logits max |err| "
              f"{err_prefill:.3g}, {gen - 1} decode steps max |err| {err_steps:.3g} "
              f"(tolerance {SERVE_GOLDEN_ATOL}), tokens equal: "
              f"{bool((got_tokens == want_tokens).all())}, launches {json.dumps(launched)}",
              flush=True)
        if max(err_prefill, err_steps) > SERVE_GOLDEN_ATOL:
            raise AssertionError(f"{arch_id}: logits differ from the JAX golden")
        if not (got_tokens == want_tokens).all():
            raise AssertionError(f"{arch_id}: greedy tokens differ from the JAX golden")


def _flash_path(q, k, *_):
    """flash_attention's call as (path, head dim): the kernel path its
    launch plan takes (``kernels/flash_attention.py:launch_plan``)."""
    from repro_torch.kernels.flash_attention import launch_plan

    b, h, sq, d = q.shape
    return (launch_plan(b, h, k.shape[1], sq, k.shape[2], d, q.dtype).path, d)


def _free(torch):
    gc.collect()
    torch.cuda.empty_cache()


def _full_extras(np, arch_id: str, cfg, batch: int) -> dict:
    """Phase 6b's whisper frames (batch, 1,500, d_model) or phi-3-vision
    patches (batch, 576, d_vision), N(0, 1) float32 from
    SERVE_EXTRAS_SEED; {} for the other archs."""
    rng = np.random.default_rng(SERVE_EXTRAS_SEED)
    if arch_id == "whisper-medium":
        return {"frames": rng.standard_normal((batch, WHISPER_FRAMES, cfg.d_model),
                                              dtype=np.float32)}
    if getattr(cfg, "vision", None) is not None:
        v = cfg.vision
        return {"images": rng.standard_normal((batch, v.n_patches, v.d_vision),
                                              dtype=np.float32)}
    return {}


def _serve_full_run(np, arch_id: str, args: dict, impl=None, forced=None):
    """One full-width serving run of ``arch_id`` with seed-0 weights: the
    kernel arm of an arch without extras through launch.serve.main (the
    user's entry point), every other run through serve.build + serve.run
    (steps.make_prefill with the frames or patches in the batch, then
    make_serve_step) on the same prompts."""
    from repro_torch.launch import serve

    prompt_len = WHISPER_PROMPT if arch_id == "whisper-medium" else args["--prompt-len"]
    if impl is None and forced is None and arch_id not in ("whisper-medium",
                                                           "phi-3-vision-4.2b"):
        return serve.main(["--arch", arch_id, *SERVE_ARGV]), prompt_len
    arch, cfg, model = serve.build(arch_id, seed=0)
    prompts = serve.make_prompts(cfg, args["--batch"], prompt_len, 0)
    out = serve.run(arch, cfg, model, prompts, args["--gen"], impl=impl, forced=forced,
                    **_full_extras(np, arch_id, cfg, args["--batch"]))
    return out, prompt_len


def phase_serve_full(torch, np, smi: str = ""):
    """Full width (the kernel arms, counted from 0: launch.serve.main, or
    serve.run with whisper's frames or phi-3-vision's patches), then the
    plain arms on the same weights, teacher-forced. One model is on the
    card at a time. Returns the launches over the kernel arms and
    flash_attention's by (path, head dim)."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.models import attention

    args = dict(zip(SERVE_ARGV[::2], (int(v) for v in SERVE_ARGV[1::2])))
    gen = args["--gen"]
    for arch_id in SERVE_FULL_ARCHS:
        # the first full-width call of an arch pays for cuBLAS's heuristics
        # and the allocator's pools; its times are printed, not kept
        cold, _ = _serve_full_run(np, arch_id, args)
        print(f"[serve] {arch_id} warm-up run: prefill {cold.prefill_s * 1e3:.1f} ms, "
              f"decode {cold.decode_s * 1e3:.1f} ms", flush=True)
        del cold
        _free(torch)
    ops.reset_launches()  # the serving path's launches are counted from here
    by_path, restore = _tally_shapes(ops, "flash_attention_cuda", _flash_path)
    runs, want = {}, {"flash_attention": 0, "ssd_chunks": 0}
    try:
        for arch_id in SERVE_FULL_ARCHS:
            cfg = get_arch(arch_id).full
            before, paths_before = dict(ops.LAUNCHES), dict(by_path)
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            run, prompt_len = _serve_full_run(np, arch_id, args)
            runs[arch_id] = run
            wall = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() / 2**30
            _free(torch)
            expect_n = _serve_launches(cfg, gen)
            launched = {name: ops.LAUNCHES[name] - before[name] for name in want}
            for name in want:
                want[name] += expect_n[name]
                if launched[name] != expect_n[name]:
                    raise AssertionError(f"{arch_id}: {name} launched {launched[name]} times, "
                                         f"not {expect_n[name]}")
            paths = {f"{p} d{d}": n - paths_before.get((p, d), 0)
                     for (p, d), n in sorted(by_path.items())
                     if n - paths_before.get((p, d), 0)}
            note = f", launches {json.dumps(launched)}"
            if expect_n["flash_attention"]:
                d = cfg.d_head if hasattr(cfg, "d_head") else cfg.attn.d_head
                expect = {f"mma_tile d{d}": expect_n["flash_prefill"],
                          f"mma_decode d{d}": expect_n["flash_step"] * (gen - 1)}
                if paths != expect:
                    raise AssertionError(f"{arch_id}: flash_attention launches by path "
                                         f"{paths}, not {expect}")
                note += f", flash_attention launches by path and head dim {json.dumps(paths)}"
                if getattr(cfg, "local_window", None):
                    ring = attention.cache_len(cfg.local_attn(), prompt_len + gen + 8)
                    if not ring == cfg.local_window <= prompt_len:
                        raise AssertionError(f"{arch_id}: the local ring of {ring} slots "
                                             f"does not wrap")
                    note += (f"; the {cfg.kinds().count('local')} local layers' ring of {ring}"
                             f" slots is full after the {prompt_len}-token prompt, so decode "
                             f"step 1 writes slot {prompt_len % ring} over position 0")
            shape = f"{args['--batch']}x{prompt_len} tokens"
            if arch_id == "whisper-medium":
                shape += f" over {WHISPER_FRAMES} encoder frames"
            elif getattr(cfg, "vision", None) is not None:
                shape = f"{args['--batch']}x({cfg.vision.n_patches} patches + {prompt_len} tokens)"
            tps = gen * args["--batch"] / run.decode_s
            print(f"[serve] {arch_id} kernel arm: prefill {run.prefill_s * 1e3:.1f} ms for "
                  f"{shape}, decode {tps:.1f} tok/s ({gen} steps in "
                  f"{run.decode_s * 1e3:.1f} ms); run {wall:.3f} s (weights included), peak "
                  f"memory {peak:.2f} GiB{note}" + (f"; {smi}" if smi else ""), flush=True)
    finally:
        restore()
    launches = dict(ops.LAUNCHES)
    print(f"[serve] launches over the kernel arms: {json.dumps(launches)}", flush=True)
    for name, n in want.items():
        if launches[name] != n:
            raise AssertionError(f"{name}: {launches[name]} launches, not {n}")

    for arch_id in SERVE_FULL_ARCHS:
        kernel_run = runs.pop(arch_id)
        before = dict(ops.LAUNCHES)
        plain, _ = _serve_full_run(np, arch_id, args, impl="ref", forced=kernel_run.tokens)
        _free(torch)
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
              f"(tolerance {SERVE_FULL_REL} x that, read {max(errs) / scale:.4f}); greedy "
              f"picks equal in {agree * 100:.1f}% of positions", flush=True)
        if not finite:
            raise AssertionError(f"{arch_id}: non-finite logits")
        if max(errs) > SERVE_FULL_REL * scale:
            raise AssertionError(f"{arch_id}: kernel and plain arms disagree")
        del kernel_run, plain, pairs
        _free(torch)
    return launches, {f"{p} d{d}": n for (p, d), n in sorted(by_path.items())}


def phase_serve_published(torch, np, smi: str = ""):
    """Zamba2-7B-Instruct's layout (configs/zamba2_7b): PUBLISHED_SMOKE in
    f32 through serve.run (steps.make_prefill, then make_serve_step), the
    kernel arm against the plain arm fed its tokens, logits within
    SERVE_GOLDEN_ATOL; then PUBLISHED at full width in bf16 (7,356,749,648
    weights from a seed) at zamba2-7b.prefill_mix's three batches, each
    run once to warm up, then counted from launches zeroed just before it:
    a prefill launches ZAMBA2_PUB_CALLS flash_attention (d 224 padded to
    the d 256 instance) and one ssd_chunks a Mamba2 layer, a decode step
    after it ZAMBA2_PUB_CALLS flash_attention and no ssd_chunks. Returns
    the counted full-width launches."""
    from repro_torch.configs import get_arch, zamba2_7b
    from repro_torch.kernels import ops
    from repro_torch.launch import serve, steps

    arch, dev = get_arch("zamba2-7b"), torch.device(DEVICE)
    cfg = zamba2_7b.PUBLISHED_SMOKE
    batch, prompt_len, gen = ZAMBA2_PUB_SMOKE
    model = arch.init(torch.Generator(device=dev).manual_seed(SEED), cfg, device=dev)
    prompts = serve.make_prompts(cfg, batch, prompt_len, SEED)
    before = dict(ops.LAUNCHES)
    kernel_run = serve.run(arch, cfg, model, prompts, gen)
    launched = {name: ops.LAUNCHES[name] - before[name] for name in ("flash_attention",
                                                                      "ssd_chunks")}
    want = _serve_launches(cfg, gen)
    if launched != {name: want[name] for name in launched}:
        raise AssertionError(f"zamba2-7b PUBLISHED_SMOKE: launches {launched}, not {want}")
    before = dict(ops.LAUNCHES)
    plain = serve.run(arch, cfg, model, prompts, gen, impl="ref", forced=kernel_run.tokens)
    if dict(ops.LAUNCHES) != before:
        raise AssertionError("zamba2-7b PUBLISHED_SMOKE: the plain arm launched a kernel")
    pairs = [(kernel_run.prefill_logits, plain.prefill_logits),
             *zip(kernel_run.step_logits, plain.step_logits)]
    err = max(float((k - p).abs().max()) for k, p in pairs)
    print(f"[serve published] zamba2-7b PUBLISHED_SMOKE (f32, {len(cfg.hybrid_layers)} calls "
          f"of {cfg.n_shared_blocks} shared blocks over {cfg.n_layers} layers) on the card: "
          f"kernel vs plain arm logits max |err| {err:.3g} over the prefill and "
          f"{gen - 1} steps (tolerance {SERVE_GOLDEN_ATOL}), launches "
          f"{json.dumps(launched)}", flush=True)
    if err > SERVE_GOLDEN_ATOL:
        raise AssertionError("zamba2-7b PUBLISHED_SMOKE: kernel and plain arms disagree")
    del model, kernel_run, plain, pairs
    _free(torch)

    cfg = zamba2_7b.PUBLISHED
    if (len(cfg.hybrid_layers), cfg.attn.scale) != (ZAMBA2_PUB_CALLS, ZAMBA2_PUB_SCALE):
        raise AssertionError(f"zamba2-7b PUBLISHED: {len(cfg.hybrid_layers)} calls at scale "
                             f"{cfg.attn.scale}, not {ZAMBA2_PUB_CALLS} at {ZAMBA2_PUB_SCALE}")
    t0 = time.perf_counter()
    model = arch.init(torch.Generator(device=dev).manual_seed(SEED), cfg, device=dev)
    n_weights = sum(p.numel() for p in model.parameters())
    _sync(torch)
    print(f"[serve published] zamba2-7b PUBLISHED: {n_weights:,} weights drawn on the card "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)
    if n_weights != ZAMBA2_PUB_WEIGHTS:
        raise AssertionError(f"zamba2-7b PUBLISHED: {n_weights} weights")
    want_prefill = {"flash_attention": ZAMBA2_PUB_CALLS,
                    "ssd_chunks": cfg.kinds().count("mamba")}
    want_step = {"flash_attention": ZAMBA2_PUB_CALLS, "ssd_chunks": 0}
    total = {name: 0 for name in want_prefill}
    for b, s in ZAMBA2_PUB_BATCHES:
        tokens = torch.as_tensor(serve.make_prompts(cfg, b, s, SEED), dtype=torch.long,
                                 device=dev)
        prefill = steps.make_prefill(arch, cfg, max_cache_len=s + 8)
        step = steps.make_serve_step(arch, cfg)
        with torch.inference_mode():
            caches, logits = prefill(model, {"tokens": tokens})  # warm-up
            del caches, logits
            _free(torch)
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launches()
            t0 = time.perf_counter()
            caches, logits = prefill(model, {"tokens": tokens})
            _sync(torch)
            prefill_s = time.perf_counter() - t0
            at_prefill = {name: ops.LAUNCHES[name] for name in want_prefill}
            ops.reset_launches()
            t0 = time.perf_counter()
            caches, token, step_logits = step(model, caches, steps.greedy(logits))
            _sync(torch)
            step_s = time.perf_counter() - t0
            at_step = {name: ops.LAUNCHES[name] for name in want_prefill}
        peak = torch.cuda.max_memory_allocated() / 2**30
        finite = bool(torch.isfinite(logits).all()) and bool(torch.isfinite(step_logits).all())
        print(f"[serve published] zamba2-7b PUBLISHED {b}x{s} tokens: prefill "
              f"{prefill_s * 1e3:.1f} ms ({b * s / prefill_s:,.0f} tokens/s), launches "
              f"{json.dumps(at_prefill)}; a decode step {step_s * 1e3:.1f} ms, launches "
              f"{json.dumps(at_step)}; {len(caches) - cfg.n_layers} shared-call caches; peak "
              f"memory {peak:.2f} GiB" + (f"; {smi}" if smi else ""), flush=True)
        if at_prefill != want_prefill or at_step != want_step:
            raise AssertionError(f"zamba2-7b PUBLISHED {b}x{s}: launches {at_prefill} at "
                                 f"prefill and {at_step} a step, not {want_prefill} and "
                                 f"{want_step}")
        if not finite or len(caches) != cfg.n_layers + ZAMBA2_PUB_CALLS:
            raise AssertionError(f"zamba2-7b PUBLISHED {b}x{s}: non-finite logits or "
                                 f"{len(caches)} caches")
        for name in total:
            total[name] += at_prefill[name] + at_step[name]
        del caches, logits, step_logits, token, tokens
        _free(torch)
    del model
    _free(torch)
    return total


def _train_opt(golden):
    from repro_torch.optim import adamw

    return adamw.AdamWConfig(peak_lr=float(golden["meta/peak_lr"]),
                             warmup_steps=int(golden["meta/warmup"]),
                             total_steps=int(golden["meta/total_steps"]))


def phase_train_golden(torch, np):
    """SMOKE training on the card, with the kernels, from the JAX package's
    weights and batches: make_train_step and the compressed step (one-rank
    NCCL group) against the JAX package's losses, grad norms, lr and final
    parameters."""
    from repro_torch import convert
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import PipelineConfig, SyntheticPipeline
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh, steps, train
    from repro_torch.optim import adamw, compress

    golden = np.load(TRAIN_GOLDEN)
    serve_golden = np.load(SERVE_GOLDEN)
    dev = torch.device(DEVICE)
    opt_cfg = _train_opt(golden)
    group = mesh.make_data_group(dev)
    if torch.distributed.get_backend(group) != "nccl":
        raise AssertionError("the data group on the card is not NCCL")
    for arch_id in TRAIN_ARCHS:
        arch = get_arch(arch_id)
        cfg = arch.smoke
        pipe = SyntheticPipeline(PipelineConfig(
            vocab=cfg.vocab, seq=int(golden["meta/seq"]), global_batch=int(golden["meta/batch"]),
            seed=int(golden["meta/data_seed"])))
        batches = [steps.batch_to_torch(pipe.batch_at(i), dev)
                   for i in range(int(golden["meta/steps"]))]
        for kind in ("train", "compressed"):
            model = convert.lm_params_from_reference(_reference_params(serve_golden, arch_id),
                                                     cfg, dev)
            params = steps.trainable(model)
            opt = adamw.init(params)
            if kind == "train":
                step = steps.make_train_step(arch, cfg, opt_cfg)
            else:
                cstep = train.make_compressed_dp_step(arch, cfg, opt_cfg, group)
                resid = compress.init_residuals(params)

                def step(m, o, b, cstep=cstep, resid=resid):
                    m, o, _, met = cstep(m, o, resid, b)
                    return m, o, met

            before = dict(ops.LAUNCHES)
            hist: dict = {}
            for b in batches:
                model, opt, met = step(model, opt, b)
                for k, v in met.items():
                    hist.setdefault(k, []).append(float(v))
            launched = {k: v - before[k] for k, v in ops.LAUNCHES.items() if v != before[k]}
            rtols = TRAIN_GOLDEN_RTOL if kind == "train" else COMPRESSED_GOLDEN_RTOL
            rel = {k: float(np.max(np.abs(np.asarray(hist[k]) - golden[f"{arch_id}/{kind}/{k}"])
                                   / np.abs(golden[f"{arch_id}/{kind}/{k}"]))) for k in rtols}
            want = convert.lm_params_from_reference(
                _golden_params(golden, f"{arch_id}/{kind}/param/"), cfg, dev).state_dict()
            diffs = [(p - want[name]).abs() for name, p in model.state_dict().items()]
            worst = max(float(d.max()) for d in diffs)
            close = sum(int((d <= 1e-5).sum()) for d in diffs) / sum(d.numel() for d in diffs)
            median = float(torch.cat([d.reshape(-1) for d in diffs]).median())
            print(f"[train golden] {arch_id} SMOKE {kind} on the card, 3 steps: losses "
                  f"{hist['loss']}; relative error vs the JAX golden "
                  f"{ {k: float(f'{v:.3g}') for k, v in rel.items()} } (tolerances {rtols}); "
                  f"parameters max |err| {worst:.3g}, {close * 100:.1f}% within 1e-5, "
                  f"median {median:.3g}; "
                  f"launches {launched}", flush=True)
            bad = [k for k in rtols if rel[k] > rtols[k]]
            if bad:
                raise AssertionError(f"{arch_id} {kind}: {bad} differ from the JAX golden")
            if kind == "train" and worst > TRAIN_GOLDEN_PARAM_ATOL:
                raise AssertionError(f"{arch_id} train: parameters differ by {worst}")
            if kind == "compressed" and (worst > 2 * sum(hist["lr"])
                                         or close < COMPRESSED_CLOSE_SHARE
                                         or median > COMPRESSED_MEDIAN_ATOL):
                raise AssertionError(f"{arch_id} compressed: parameters differ ({worst}, "
                                     f"{close:.3f} within 1e-5, median {median:.3g})")
            for name in ("flash_attention", "ssd_chunks"):
                if _serve_launches(cfg, 1)[name] and not launched.get(name):
                    raise AssertionError(f"{arch_id} {kind}: {name} never launched")
            if kind == "compressed" and not launched.get("int8_quantize"):
                raise AssertionError(f"{arch_id}: the codec never launched")


def _argv_int(argv, flag: str) -> int:
    return int(argv[argv.index(flag) + 1])


def _sync_time(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_train_starcoder(torch, np):
    """starcoder2-3b at full width: the compressed step of launch.train
    --compress, warm then counted; then kernel arm vs plain arm on one
    forward and backward. Returns the counted steps' launches."""
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import PipelineConfig, SyntheticPipeline
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh, steps, train
    from repro_torch.optim import adamw, compress

    arch_id = "starcoder2-3b"
    dev = torch.device(DEVICE)
    arch = get_arch(arch_id)
    cfg = arch.full
    batch, seq = _argv_int(TRAIN_FULL_ARGV, "--batch"), _argv_int(TRAIN_FULL_ARGV, "--seq")
    n_steps = TRAIN_WARM + TRAIN_COUNTED
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = arch.init(torch.Generator(dev).manual_seed(0), cfg, device=dev)
    params = steps.trainable(model)
    opt = adamw.init(params)
    resid = compress.init_residuals(params)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.values())
    print(f"[train] {arch_id}: {n_params:,} parameters in {len(params)} tensors; weights, "
          f"AdamW state and residuals in {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB", flush=True)
    # launch.train's defaults: peak lr 3e-4, warm-up 20, total = the run's steps
    opt_cfg = adamw.AdamWConfig(peak_lr=3e-4, warmup_steps=20, total_steps=n_steps)
    cstep = train.make_compressed_dp_step(arch, cfg, opt_cfg, mesh.make_data_group(dev))
    pipe = SyntheticPipeline(PipelineConfig(vocab=cfg.vocab, seq=seq, global_batch=batch,
                                            seed=0))
    times, launches = [], {}
    for i in range(n_steps):
        if i == TRAIN_WARM:
            before = dict(ops.LAUNCHES)
        b = steps.batch_to_torch(pipe.next(), dev)
        (model, opt, resid, met), dt = _sync_time(
            torch, lambda: cstep(model, opt, resid, b))
        times.append(dt)
        print(f"[train] {arch_id} step {i + 1} ({'warm' if i < TRAIN_WARM else 'counted'}): "
              f"{dt:.3f} s, loss {float(met['loss']):.4f}, grad norm "
              f"{float(met['grad_norm']):.4f}, lr {float(met['lr']):.3g}", flush=True)
    launches = {k: (v - before[k]) // TRAIN_COUNTED for k, v in ops.LAUNCHES.items()
                if v != before[k]}
    step_s = sum(times[TRAIN_WARM:]) / TRAIN_COUNTED
    peak = torch.cuda.max_memory_allocated()
    print(f"[train] {arch_id} batch {batch} x seq {seq}, compressed over one NCCL rank: "
          f"{step_s:.3f} s a step (mean of {TRAIN_COUNTED}), {batch * seq / step_s:.0f} tokens/s, "
          f"peak memory {peak / 2**30:.2f} GiB; launches a step {json.dumps(launches)}",
          flush=True)
    for k, n in TRAIN_LAUNCHES[arch_id].items():
        if launches.get(k) != n:
            raise AssertionError(f"{arch_id}: {k} launched {launches.get(k)} times a step, "
                                 f"not {n}")
    if not all(np.isfinite(t) for t in times) or not np.isfinite(float(met["loss"])):
        raise AssertionError(f"{arch_id}: non-finite loss")
    _train_breakdown(torch, arch, cfg, model, params, opt, resid, opt_cfg,
                     steps.batch_to_torch(pipe.next(), dev), batch, seq)
    del opt, resid
    torch.cuda.empty_cache()

    # kernel arm vs plain arm: one forward and backward, no update
    b = steps.batch_to_torch(pipe.batch_at(n_steps), dev)
    arms = {}
    for impl in (None, "ref"):
        (loss, _, grads), dt = _sync_time(
            torch, lambda: steps.loss_and_grads(arch, cfg, model, b, impl=impl))
        norm = float(adamw.global_norm(grads))
        empty = [k for k, g in grads.items() if not bool(g.abs().sum() > 0)]
        finite = all(bool(torch.isfinite(g).all()) for g in grads.values())
        arms[impl] = (float(loss), norm)
        print(f"[train] {arch_id} {'kernel' if impl is None else 'plain'} arm, one forward and "
              f"backward: {dt:.3f} s, loss {float(loss):.6f}, grad norm {norm:.6f}, "
              f"{len(grads)} of {len(params)} parameters with a gradient, "
              f"{len(empty)} of them all zero, all finite: {finite}", flush=True)
        if set(grads) != set(params) or empty or not finite:
            raise AssertionError(f"{arch_id}: a parameter got no usable gradient")
        del grads
        torch.cuda.empty_cache()
    rel = [abs(a - b) / abs(b) for a, b in zip(arms[None], arms["ref"])]
    print(f"[train] {arch_id} kernel vs plain arm: loss rel {rel[0]:.3g}, grad norm rel "
          f"{rel[1]:.3g} (tolerance {TRAIN_FULL_REL})", flush=True)
    if max(rel) > TRAIN_FULL_REL:
        raise AssertionError(f"{arch_id}: kernel and plain arms disagree")
    del model, params
    torch.cuda.empty_cache()
    return launches, dict(step_s=step_s, tokens_per_s=batch * seq / step_s, peak_bytes=peak)


def _step_apart(torch, arch, cfg, model, params, opt, resid, opt_cfg, b):
    """One compressed step taken apart, a synchronise between its stages
    (the step's own body): seconds of loss and gradients, compression and
    AdamW."""
    from repro_torch.launch import mesh, steps
    from repro_torch.optim import adamw, compress

    group = mesh.make_data_group(torch.device(DEVICE))
    (_, _, grads), t_fb = _sync_time(torch, lambda: steps.loss_and_grads(arch, cfg, model, b))
    _, t_c = _sync_time(torch, lambda: compress.compressed_grad_tree(grads, resid, group))
    _, t_a = _sync_time(torch, lambda: adamw.update(opt_cfg, params, grads, opt))
    del grads
    return t_fb, t_c, t_a


def _train_breakdown(torch, arch, cfg, model, params, opt, resid, opt_cfg, b, batch, seq):
    """One more step taken apart (``_step_apart``), then, at one layer's
    training shape, the attention kernel's forward with its lse (the
    forward and its recomputation) and the backward kernel."""
    from repro_torch.kernels.attention_bwd import attention_bwd_cuda
    from repro_torch.kernels.flash_attention import flash_attention_cuda

    t_fb, t_c, t_a = _step_apart(torch, arch, cfg, model, params, opt, resid, opt_cfg, b)
    a = cfg.attn
    gen = torch.Generator(DEVICE).manual_seed(SEED)
    q, k, v = (torch.randn(shape, generator=gen, device=DEVICE).to(torch.bfloat16)
               for shape in ((batch, a.n_heads, seq, a.d_head),
                             (batch, a.n_kv_heads, seq, a.d_head),
                             (batch, a.n_kv_heads, seq, a.d_head)))
    kw = dict(causal=True, window=None, scale=None, q_offset=0, kv_len=None)

    def forward():
        return flash_attention_cuda(q, k, v, return_lse=True, **kw)

    fwd_ms = _time_ms(torch, forward, 3)
    out, lse = forward()
    bwd_ms = _time_ms(torch, lambda: attention_bwd_cuda(q, k, v, out, lse, q, **kw), 3)
    n = cfg.n_layers
    kernel_s = (2 * fwd_ms + bwd_ms) * n / 1e3
    print(f"[train] {arch.arch_id} one step taken apart: loss and gradients {t_fb:.3f} s "
          f"(of it the attention kernels {kernel_s:.3f} s: {2 * n} x {fwd_ms:.3f} ms forward "
          f"and recomputation, each with lse, and {n} x {bwd_ms:.3f} ms the backward kernel), "
          f"compression {t_c:.3f} s, AdamW {t_a:.3f} s", flush=True)


def phase_train_mamba_apart(torch, ssd_ms: float):
    """mamba2-130m at full width (batch 2 x seq 4,096, random weights from a
    seed): one warm compressed step, then one taken apart (``_step_apart``);
    of its loss and gradients, the ssd_chunks launches times the kernel's
    ms at the training shape (``ssd_ms``, phase 3), and at one layer's
    shape the SSD scan's forward (the kernel with the torch recurrence
    around it) and the plain SSD VJP (ops._SSDScan.backward)."""
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import PipelineConfig, SyntheticPipeline
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.optim import adamw, compress

    arch = get_arch("mamba2-130m")
    cfg, dev = arch.full, torch.device(DEVICE)
    batch, seq = _argv_int(TRAIN_FULL_ARGV, "--batch"), _argv_int(TRAIN_FULL_ARGV, "--seq")
    torch.cuda.reset_peak_memory_stats()
    model = arch.init(torch.Generator(dev).manual_seed(0), cfg, device=dev)
    params = steps.trainable(model)
    opt, resid = adamw.init(params), compress.init_residuals(params)
    opt_cfg = adamw.AdamWConfig(peak_lr=3e-4, warmup_steps=20, total_steps=2)
    pipe = SyntheticPipeline(PipelineConfig(vocab=cfg.vocab, seq=seq, global_batch=batch,
                                            seed=0))
    args = (torch, arch, cfg, model, params, opt, resid, opt_cfg)
    _step_apart(*args, steps.batch_to_torch(pipe.next(), dev))  # warm
    before = dict(ops.LAUNCHES)
    t_fb, t_c, t_a = _step_apart(*args, steps.batch_to_torch(pipe.next(), dev))
    launches = ops.LAUNCHES["ssd_chunks"] - before["ssd_chunks"]
    bwd_launches = ops.LAUNCHES["ssd_bwd"] - before["ssd_bwd"]
    peak = torch.cuda.max_memory_allocated()
    del model, params, opt, resid
    torch.cuda.empty_cache()
    m = cfg.mamba_cfg
    gen = torch.Generator(DEVICE).manual_seed(SEED)
    x, B, C = (torch.randn(shape, generator=gen, device=DEVICE).to(cfg.dtype)
               for shape in ((batch, seq, m.n_heads, m.head_dim),
                             (batch, seq, m.n_groups, m.d_state),
                             (batch, seq, m.n_groups, m.d_state)))
    dt = torch.rand((batch, seq, m.n_heads), generator=gen, device=DEVICE) * 0.1 + 1e-3
    A = -1.0 - 15.0 * torch.rand((m.n_heads,), generator=gen, device=DEVICE)
    chunk = min(m.chunk, max(16, seq))
    reps = 5
    _, t_fwd = _sync_time(torch, lambda: [ops.ssd_scan(x, dt, A, B, C, chunk=chunk)
                                          for _ in range(reps + 1)])
    _, t_fwd = _sync_time(torch, lambda: [ops.ssd_scan(x, dt, A, B, C, chunk=chunk)
                                          for _ in range(reps)])
    gy = torch.randn(x.shape, generator=gen, device=DEVICE).to(x.dtype)

    def backward_s(impl):
        """Seconds of one backward of the scan at a layer's shape: the
        Hopper backward (impl None) or the plain VJP ("ref")."""
        leaves = [t.detach().requires_grad_(True) for t in (x, dt, A, B, C)]
        y = ops.ssd_scan(*leaves, chunk=chunk, impl=impl)
        torch.autograd.grad(y, leaves, gy, retain_graph=True)  # warm-up
        return _sync_time(torch, lambda: [torch.autograd.grad(y, leaves, gy, retain_graph=True)
                                          for _ in range(reps)])[1] / reps

    t_bwd, t_vjp = backward_s(None), backward_s("ref")
    n = cfg.n_layers
    fwd_ms = 1e3 * t_fwd / reps
    print(f"[train] mamba2-130m one step taken apart (batch {batch} x seq {seq}, compressed "
          f"over one NCCL rank): loss and gradients {t_fb:.3f} s (of it ssd_chunks {launches} "
          f"launches x {ssd_ms:.4f} ms = {launches * ssd_ms / 1e3:.4f} s; the SSD scan's "
          f"forward, kernel and torch recurrence, at a layer's shape {fwd_ms:.3f} ms, "
          f"{launches} a step = {launches * fwd_ms / 1e3:.3f} s; the SSD backward kernels with "
          f"the reverse scan {bwd_launches} x {1e3 * t_bwd:.3f} ms = {bwd_launches * t_bwd:.3f} s"
          f", beside the plain SSD VJP's {n} x {t_vjp:.4f} s = {n * t_vjp:.3f} s), compression "
          f"{t_c:.3f} s, AdamW {t_a:.3f} s; peak memory {peak / 2**30:.2f} GiB", flush=True)
    for name, got in (("ssd_chunks", launches), ("ssd_bwd", bwd_launches)):
        if got != TRAIN_LAUNCHES["mamba2-130m"][name]:
            raise AssertionError(f"mamba2-130m: {name} launched {got} times in a step")


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(r, f)) for r, _, fs in os.walk(path) for f in fs)


def phase_train_mamba(torch, np):
    """mamba2-130m at full width through launch.train.main --compress, with
    checkpoints, then a resume from step 4 to 6. Returns the launches of
    both runs."""
    import shutil

    from repro_torch.kernels import ops
    from repro_torch.launch import train

    arch_id = "mamba2-130m"
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    argv = ["--arch", arch_id, "--compress", *TRAIN_FULL_ARGV, "--ckpt-every", "2",
            "--ckpt-dir", CKPT_DIR, "--log-every", "1"]
    before = dict(ops.LAUNCHES)
    torch.cuda.reset_peak_memory_stats()
    first = train.main(argv + ["--steps", "4"])
    if first["step"] != 4 or first["exit"] != "completed":
        raise AssertionError(f"{arch_id}: the first run ended at {first['step']}")
    resumed = train.main(argv + ["--steps", "6"])
    if resumed["step"] != 6 or [h["step"] for h in resumed["history"]] != [5, 6]:
        raise AssertionError(f"{arch_id}: the resume did not run steps 5 and 6")
    launches = {k: v - before[k] for k, v in ops.LAUNCHES.items() if v != before[k]}
    per_step = {k: v // 6 for k, v in launches.items()}
    hist = first["history"] + resumed["history"]
    batch, seq = _argv_int(TRAIN_FULL_ARGV, "--batch"), _argv_int(TRAIN_FULL_ARGV, "--seq")
    warm = [h["t"] for h in hist[1:]]
    step_s = sum(warm) / len(warm)
    ckpt = os.path.join(CKPT_DIR, "step_00000006")
    print(f"[train] {arch_id} launch.train.main: steps 1-4, then resumed at step "
          f"{resumed['history'][0]['step'] - 1} and ran to {resumed['step']}; losses "
          f"{[round(h['loss'], 4) for h in hist]}; step times {[round(t, 3) for t in [h['t'] for h in hist]]} s"
          f" (mean after the first {step_s:.3f} s, {batch * seq / step_s:.0f} tokens/s); peak "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; checkpoint "
          f"{_dir_bytes(ckpt) / 1e9:.3f} GB, directory {_dir_bytes(CKPT_DIR) / 1e9:.3f} GB "
          f"({sorted(os.listdir(CKPT_DIR))}); launches a step {json.dumps(per_step)}",
          flush=True)
    for k, n in TRAIN_LAUNCHES[arch_id].items():
        if launches.get(k) != 6 * n:
            raise AssertionError(f"{arch_id}: {k} launched {launches.get(k)} times in 6 "
                                 f"steps, not {6 * n}")
    if not all(np.isfinite(h["loss"]) for h in hist):
        raise AssertionError(f"{arch_id}: non-finite loss")
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    return launches, dict(step_s=step_s, tokens_per_s=batch * seq / step_s)


def _spec_form(spec) -> list:
    """A spec in the sharding golden's form: a one-axis tuple as its name,
    trailing Nones dropped."""
    out = [list(e) if isinstance(e, tuple) and len(e) > 1 else
           e[0] if isinstance(e, tuple) and e else e for e in spec]
    while out and out[-1] is None:
        out.pop()
    return out


def sharding_table(torch, arch_id: str, shape, names, golden: dict, state=None) -> dict:
    """The port's specs for ``arch_id`` at full width (meta tensors; the
    (params, AdamW state) of ``steps.abstract_train_state`` when given) on
    a mesh of ``shape``, in the form of tests/data/torch_port_sharding_golden
    .json's entry ``golden`` (whose batch shapes it reads), keyed by the
    reference's paths; every layer behind one path must agree."""
    from repro_torch import convert
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import SHAPES
    from repro_torch.launch import steps
    from repro_torch.parallel import sharding as shd

    arch = get_arch(arch_id)
    mesh = shd.MeshShape(tuple(shape), tuple(names))
    params, opt = state or steps.abstract_train_state(arch, arch.full)

    def collapse(specs, key):
        out = {}
        for name, spec in specs.items():
            path, form = key(name, arch.full), _spec_form(spec)
            if out.setdefault(path, form) != form:
                raise AssertionError(f"{arch_id}: {name} {form} differs from {path}'s "
                                     f"{out[path]}")
        return out

    pspec = shd.param_specs(params, arch, mesh)
    fspec = shd.param_specs(params, arch, mesh, fsdp=True)
    ospec = shd.opt_state_specs(opt, pspec, mesh, arch)
    table = {
        "tp_mode": shd.tp_mode(arch, mesh),
        "params": collapse(pspec, convert.reference_param_path),
        "fsdp": collapse(fspec, convert.reference_param_path),
        "opt": collapse(ospec["m"], convert.reference_param_path),
        "param_bytes": shd.bytes_per_device(params, pspec, mesh),
        "fsdp_param_bytes": shd.bytes_per_device(params, fspec, mesh),
        "moment_bytes": (shd.bytes_per_device(opt["m"], ospec["m"], mesh)
                         + shd.bytes_per_device(opt["v"], ospec["v"], mesh)),
        "batch": {}, "cache": {}, "activation": {},
    }
    for cell_name, leaves in golden["batch"].items():
        cell = SHAPES[cell_name]
        batch = {k: torch.empty(v["shape"], device="meta") for k, v in leaves.items()}
        bspec = shd.batch_specs(batch, cell, mesh)
        table["batch"][cell_name] = {k: {"shape": v["shape"], "spec": _spec_form(bspec[k])}
                                     for k, v in leaves.items()}
        act = shd.activation_spec(arch, cell, mesh)
        table["activation"][cell_name] = None if act is None else _spec_form(act)
        if cell.kind == "decode":
            caches = arch.init_caches(arch.full, cell.batch, cell.seq, device="meta")
            flat = {}
            shd.map_tree(lambda path, spec: flat.__setitem__(path, spec),
                         shd.cache_specs(caches, arch, cell, mesh))
            table["cache"][cell_name] = collapse(flat, convert.reference_cache_path)
    table["sharded_leaves"] = sum(1 for sp in pspec.values() if any(sp))
    return table


def phase_sharding(torch, np):
    """10a: the partition rules of all ten archs at full width on the meta
    device, on the five meshes of the sharding golden, against the JAX
    package's specs; prints the sharded leaves and the bytes a device."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import steps

    with open(SHARDING_GOLDEN) as f:
        golden = json.load(f)
    for arch_id, by_mesh in sorted(golden["archs"].items()):
        arch = get_arch(arch_id)
        state = steps.abstract_train_state(arch, arch.full)
        rows = []
        for mesh_name, want in by_mesh.items():
            shape, names = golden["meshes"][mesh_name]
            got = sharding_table(torch, arch_id, shape, names, want, state)
            extra = SHARDING_MOMENT_EXTRA.get((arch_id, mesh_name), 0)
            if got["moment_bytes"] - want["moment_bytes"] != extra:
                raise AssertionError(f"{arch_id} on {mesh_name}: moments {got['moment_bytes']} "
                                     f"bytes a device, the reference {want['moment_bytes']}")
            for key, value in want.items():
                if key != "moment_bytes" and got[key] != value:
                    raise AssertionError(f"{arch_id} on {mesh_name}: {key} differs from the "
                                         f"golden")
            rows.append(f"{mesh_name} ({got['tp_mode']}): {got['sharded_leaves']} sharded "
                        f"leaves, params {got['param_bytes'] / 2**30:.3f} GiB, moments "
                        f"{got['moment_bytes'] / 2**30:.3f} GiB a device")
        print(f"[sharding] {arch_id}: " + "; ".join(rows), flush=True)


def elastic_run(torch, ops, arch_id: str, cfg, batch: int, seq: int, ckpt_dir: str,
                n_steps: int = 4, event_after: int = 2) -> dict:
    """Train ``arch_id`` (config ``cfg``) on the card with
    ``elastic.train_compressed`` twice from one seed: uninterrupted, and
    under ``ElasticController``, which after step ``event_after`` takes
    ``ElasticEvent(available_chips=1)``, plans the slice on a
    ``PlanningEngine`` on the card, checkpoints, rebuilds the 1 x 1 mesh,
    restores and reshards. Returns the losses of both runs, the
    controller's plan, the kernel launches of its planning, the
    checkpoint's bytes and the seconds of save, restore and reshard."""
    from repro_torch.checkpoint import manager
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeCell
    from repro_torch.core.planner import EnergyOptimalPlanner
    from repro_torch.launch import mesh
    from repro_torch.optim import adamw
    from repro_torch.runtime import elastic

    arch = get_arch(arch_id)
    opt_cfg = adamw.AdamWConfig(peak_lr=3e-4, warmup_steps=2, total_steps=n_steps)
    cell = ShapeCell("train", seq, batch, "train")
    planner = EnergyOptimalPlanner.default(device=torch.device(DEVICE))
    times, plan_launches = {}, {}

    def timed(name, fn):
        def wrapped(*a, **k):
            _sync(torch)
            t0 = time.perf_counter()
            out = fn(*a, **k)
            _sync(torch)
            times[name] = times.get(name, 0.0) + time.perf_counter() - t0
            return out
        return wrapped

    ckpt = manager.CheckpointManager(ckpt_dir)
    ckpt.save = timed("save", ckpt.save)
    ckpt.restore = timed("restore", ckpt.restore)
    ctl = elastic.ElasticController(arch, cfg, cell, opt_cfg, ckpt, planner=planner,
                                    prefer_model=1, device=DEVICE)
    choose = ctl._choose_chips

    def counted_choose(available):
        before = dict(ops.LAUNCHES)
        out = choose(available)
        plan_launches.update({k: ops.LAUNCHES[k] - before.get(k, 0) for k in ops.LAUNCHES})
        return out

    ctl._choose_chips = counted_choose
    real_reshard = elastic.reshard
    elastic.reshard = timed("reshard", real_reshard)
    try:
        resumed = elastic.train_compressed(
            arch, cfg, opt_cfg, cell, n_steps, controller=ctl, device=DEVICE,
            events={event_after: elastic.ElasticEvent(available_chips=1, reason="re-mesh")})
    finally:
        elastic.reshard = real_reshard
    plain = elastic.train_compressed(arch, cfg, opt_cfg, cell, n_steps, device=DEVICE)
    step_dir = os.path.join(ckpt_dir, f"step_{event_after:08d}")
    return {"losses": resumed, "uninterrupted": plain, "mesh": mesh.describe(ctl.mesh),
            "plan": ctl.plan.summary(), "plan_launches": plan_launches,
            "ckpt_bytes": _dir_bytes(step_dir) if os.path.isdir(step_dir) else 0,
            "seconds": times}


def phase_elastic(torch, np, ops, smi):
    """10b: mamba2-130m at full width (phase 9's batch 2 x seq 4,096),
    compressed over a one-rank NCCL group, re-meshed under
    ElasticController after step 2 onto the card's 1 x 1 mesh and resumed
    to step 4, against the uninterrupted 4-step run."""
    import shutil

    from repro_torch.configs import get_arch

    batch, seq = _argv_int(TRAIN_FULL_ARGV, "--batch"), _argv_int(TRAIN_FULL_ARGV, "--seq")
    shutil.rmtree(ELASTIC_DIR, ignore_errors=True)
    try:
        r = elastic_run(torch, ops, "mamba2-130m", get_arch("mamba2-130m").full, batch, seq,
                        ELASTIC_DIR)
    finally:
        shutil.rmtree(ELASTIC_DIR, ignore_errors=True)
    rel = max(abs(a - b) / abs(b) for a, b in zip(r["losses"], r["uninterrupted"]))
    sec = r["seconds"]
    planning = {k: r["plan_launches"][k] for k in ("rbf_gram", "plan_argmin")}
    print(f"[elastic] mamba2-130m (batch {batch} x seq {seq}, compressed): re-meshed after "
          f"step 2 onto {r['mesh']} (a pool of 1; the controller's plan: {r['plan']}; its "
          f"planning launched {json.dumps(planning)}); losses {r['losses']} against the uninterrupted "
          f"{r['uninterrupted']}, largest relative difference {rel:.3e}; checkpoint "
          f"{r['ckpt_bytes'] / 1e9:.3f} GB, save {sec['save']:.3f} s, restore "
          f"{sec['restore']:.3f} s, reshard {sec['reshard']:.3f} s on {smi}", flush=True)
    if not rel <= ELASTIC_LOSS_REL:
        raise AssertionError(f"elastic: the resumed losses are {rel:.3e} from the "
                             f"uninterrupted run's")
    for name, n in planning.items():
        if n <= 0:
            raise AssertionError(f"elastic: the controller's plan never launched {name}")


def phase_remesh_to_card(torch, np, smi):
    """10c: 8 gloo ranks on the host place gemma3-12b's SMOKE weights (drawn
    from a seed) on a (2, 4) mesh, checkpoint them there and take the
    plain-arm loss on that mesh; the card restores the checkpoint
    (restore_latest), reshards it onto its 1 x 1 NCCL mesh, and holds the
    values bit for bit and its loss (kernel arm) within REMESH_LOSS_REL."""
    import shutil

    from repro_torch.checkpoint.manager import CheckpointManager, reshard
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch import mesh, steps
    from repro_torch.parallel import sharding as shd

    sys.path.insert(0, os.path.join(HERE, "tests"))
    from helpers import torch_gloo

    arch = get_arch("gemma3-12b")
    cfg = arch.smoke
    work = os.path.join(HERE, "build", "chip_smoke_remesh")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        model = arch.init(torch.Generator().manual_seed(SEED), cfg, device="cpu")
        weights = {k: v.detach().clone() for k, v in model.state_dict().items()}
        np.savez(os.path.join(work, "weights_gemma3-12b.npz"),
                 **{k: v.numpy() for k, v in weights.items()})
        rng = np.random.default_rng(SEED)
        b = {k: rng.integers(0, cfg.vocab, (8, 32)).astype(np.int64) for k in ("tokens", "labels")}
        np.savez(os.path.join(work, "b32_gemma3-12b.npz"), **b)
        t0 = time.perf_counter()
        outs = torch_gloo.spawn(8, work, [("remesh", (["gemma3-12b"], (2, 4), [(2, 4)], 32))],
                                timeout=REMESH_SPAWN_TIMEOUT_S)
        t_host = time.perf_counter() - t0
        host = outs[0][0]["gemma3-12b"][0]
        if not host["same"] or any(o != outs[0] for o in outs):
            raise AssertionError("remesh: the gloo ranks disagree or changed the weights")
        t0 = time.perf_counter()
        step, restored = CheckpointManager(os.path.join(work, "ckpt", "gemma3-12b")).restore_latest(
            {"params": {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
                        for k, v in weights.items()}})
        card = mesh.make_mesh((1, 1), ("data", "model"), DEVICE)
        placed = reshard(restored["params"], steps.named(
            card, shd.param_specs(restored["params"], arch, card)))
        _sync(torch)
        t_restore = time.perf_counter() - t0
        same = all(torch.equal(placed[k].to_local().cpu(), weights[k]) for k in weights)
        gpu_model = arch.init(torch.Generator(DEVICE).manual_seed(0), cfg, device=DEVICE)
        cell = ShapeCell("t", 32, 8, "train")
        loss = torch_gloo.loss_on(arch, cfg, gpu_model, placed,
                                   {k: torch.from_numpy(v).to(DEVICE) for k, v in b.items()},
                                   card, cell)
    finally:
        torch_gloo.shutdown()
        shutil.rmtree(work, ignore_errors=True)
    rel = abs(loss - host["loss"]) / abs(host["loss"])
    print(f"[remesh] gemma3-12b SMOKE: 8 gloo ranks saved on (2, 4) ({host['sharded_leaves']} "
          f"leaves sharded, {host['tp_mode']}; {t_host:.1f} s with their start), the card "
          f"restored step {step} and resharded onto {mesh.describe(card)} in {t_restore:.3f} s: "
          f"values identical {same}; loss {loss:.7f} on the card (kernels) against "
          f"{host['loss']:.7f} on the host's mesh (plain), relative {rel:.2e} on {smi}",
          flush=True)
    if not same or not rel <= REMESH_LOSS_REL:
        raise AssertionError(f"remesh: values identical {same}, loss relative {rel:.2e}")


def _parity():
    sys.path.insert(0, os.path.join(HERE, "tests"))
    from helpers import torch_dryrun_parity

    return torch_dryrun_parity


def phase_dryrun(smi):
    """11a: ``launch.dryrun.run_cell`` for every production cell, on the
    card's machine (the mesh's device the card), in DRYRUN_WORKERS
    processes; each record against the reference's golden, and each
    recorded gap against the port's count recorded for this torch version.
    Returns the records by key."""
    import shutil

    from repro_torch.configs import get_arch
    from repro_torch.launch.dryrun import all_cells

    parity = _parity()
    golden = parity.load_golden()["full"]
    version = parity.torch_version()
    shutil.rmtree(DRYRUN_DIR, ignore_errors=True)
    os.makedirs(DRYRUN_DIR)
    cells = [":".join(c) for c in all_cells()]
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-c", DRYRUN_WORKER, DRYRUN_DIR, DEVICE,
                               *cells[i::DRYRUN_WORKERS]], env=env, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for i in range(DRYRUN_WORKERS)]
    try:
        outs = [p.communicate(timeout=DRYRUN_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for p, (out, err) in zip(procs, outs):
        if p.returncode:
            raise AssertionError(f"dry-run worker exited {p.returncode}: {err[-3000:]}")
        launched = json.loads(out.strip().splitlines()[-1])
        if any(launched.values()):
            raise AssertionError(f"a dry run launched kernels: {launched}")
    records, bad = {}, []
    for cell in cells:
        arch_id, shape, mesh = cell.split(":")
        key = "__".join((arch_id, shape, mesh))
        with open(os.path.join(DRYRUN_DIR, key + ".json")) as f:
            rec = records[key] = json.load(f)
        ref = golden[key]
        if not rec["ok"]:
            bad.append(f"{key}: {rec['error']}")
            continue
        ph, rh = rec["hlo"], ref["hlo"]
        outside = parity.gaps(rec, ref)
        listed = parity.EXCEPTIONS.get(key, {})
        arch = get_arch(arch_id)
        arg = (rec["memory_analysis"]["argument_size_in_bytes"]
               - ref["memory_analysis"]["argument_size_in_bytes"])
        want_arg = parity.argument_delta(key, arch, arch.full)
        print(f"[dryrun] {key}: flops {ph['flops_per_device']:.4e} / "
              f"{rh['flops_per_device']:.4e} = "
              f"{parity.ratio(ph['flops_per_device'], rh['flops_per_device']):.3f}; memory "
              f"{ph['memory_bytes_per_device']:.4e} / {rh['memory_bytes_per_device']:.4e} = "
              f"{parity.ratio(ph['memory_bytes_per_device'], rh['memory_bytes_per_device']):.3f}"
              f"; collectives {ph['collective_bytes_per_device']:.4e} / "
              f"{rh['collective_bytes_per_device']:.4e} = "
              f"{parity.ratio(ph['collective_bytes_per_device'], rh['collective_bytes_per_device']):.3f}"
              f"; outside the limits {sorted(outside)}", flush=True)
        if sorted(outside) != sorted(listed):
            bad.append(f"{key}: outside {sorted(outside)}, recorded {sorted(listed)}")
        bad.extend(parity.drift(key, rec, ref, version))
        if arg != want_arg:
            bad.append(f"{key}: argument bytes {arg:+d} against the reference, not {want_arg:+d}")
    print(f"[dryrun] {len(cells)} cells in {wall:.1f} s on {DRYRUN_WORKERS} processes on {smi}",
          flush=True)
    if bad:
        raise AssertionError("dry run against the reference's records:\n" + "\n".join(bad))
    return records


def phase_dryrun_plans(torch, smi):
    """11b: the port's records and the reference's planned on the card:
    ``workloads_from_artifacts`` -> ``plan_many`` (each pod cell's chosen
    chips and frequency under both, and the term that decides a plan where
    they differ), then ``python -m repro_torch.fleet --quick --artifacts``
    on both record sets."""
    from repro_torch.core.characterize import workloads_from_artifacts
    from repro_torch.core.engine import PlanningEngine
    from repro_torch.fleet import __main__ as fleet_main

    golden = _parity().load_golden()["full"]
    ref_dir = DRYRUN_DIR + "_reference"
    os.makedirs(ref_dir, exist_ok=True)
    for key, rec in golden.items():
        arch_id, shape, mesh = key.split("__")
        with open(os.path.join(ref_dir, key + ".json"), "w") as f:
            json.dump(dict(rec, arch=arch_id, shape=shape, mesh=mesh), f)
    eng = PlanningEngine.default(device=DEVICE)
    plans = {}
    for label, d in (("port", DRYRUN_DIR), ("reference", ref_dir)):
        ws = workloads_from_artifacts(d)
        plans[label] = {(w.arch, w.shape_name): (w.terms, p)
                        for w, p in zip(ws, eng.plan_many(ws))}
    if sorted(plans["port"]) != sorted(plans["reference"]):
        raise AssertionError(f"the intake read {sorted(plans['port'])} from the port's records "
                             f"and {sorted(plans['reference'])} from the reference's")

    def deciding(terms):
        parts = {"compute": terms.compute_s, "memory": terms.memory_s,
                 "collective": terms.collective_s}
        return max(parts, key=parts.get)

    differ = 0
    for cell in sorted(plans["port"]):
        (pt, pp), (rt, rp) = plans["port"][cell], plans["reference"][cell]
        same = (pp.chips, pp.frequency_ghz) == (rp.chips, rp.frequency_ghz)
        differ += not same
        print(f"[dryrun-plan] {cell[0]} {cell[1]} pod: port {pp.chips} chips at "
              f"{pp.frequency_ghz:g} GHz ({deciding(pt)}-bound: compute {pt.compute_s:.4g} s, "
              f"memory {pt.memory_s:.4g} s, collective {pt.collective_s:.4g} s), reference "
              f"{rp.chips} chips at {rp.frequency_ghz:g} GHz ({deciding(rt)}-bound: compute "
              f"{rt.compute_s:.4g} s, memory {rt.memory_s:.4g} s, collective "
              f"{rt.collective_s:.4g} s){'' if same else ' DIFFER'}", flush=True)
    print(f"[dryrun-plan] {len(plans['port'])} pod cells: {differ} plans differ between the "
          f"port's records and the reference's, on {smi}", flush=True)
    for label, d in (("port", DRYRUN_DIR), ("reference", ref_dir)):
        t0 = time.perf_counter()
        report = fleet_main.main(["--quick", "--artifacts", d, "--device", DEVICE])
        _sync(torch)
        eng_stats = report.scenarios["engine"]
        print(f"[dryrun-fleet] python -m repro_torch.fleet --quick --artifacts ({label}'s "
              f"records): {eng_stats.n_jobs} jobs, {eng_stats.total_energy_j:.6g} J, "
              f"{eng_stats.deadline_misses} misses, {eng_stats.recharacterizations} refits, "
              f"{time.perf_counter() - t0:.2f} s on {smi}", flush=True)


def phase_lint():
    """11c: the port's repro-lint over this checkout, against the port's
    baseline: it must exit 0."""
    r = subprocess.run([sys.executable, "-m", "repro_torch.analysis"], cwd=HERE, text=True,
                       capture_output=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=os.path.join(HERE, "src")))
    print(f"[lint] python -m repro_torch.analysis: {r.stdout.strip().splitlines()[-1]}",
          flush=True)
    if r.returncode:
        raise AssertionError(f"repro-lint exited {r.returncode}:\n{r.stdout[-3000:]}")


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

    # each path's launches are counted from 0 just before it and read just
    # after it; the planning kernels' main path is phases 4 and 5
    loop_launches, loop_shapes = _counted(ops, lambda: phase_paper_loop(torch, np))
    t0 = _stage("paper loop", t0)
    t1_launches, t1_tallies = _counted(ops, lambda: phase_table1(torch, np))
    t0 = _stage("table1: the paper's cross-validation", t0)
    fleet_launches, fleet_shapes = _counted(ops, lambda: phase_fleet(torch, np))
    t0 = _stage("fleet-scale planning", t0)
    launches = {k: loop_launches[k] + fleet_launches[k] for k in ops.LAUNCHES}
    rbf_shapes = loop_shapes["rbf_gram"] + fleet_shapes["rbf_gram"]
    t1_shapes = t1_tallies["rbf_gram"]
    print(f"[launches] rbf_gram in phases 4-5 by shape (b, n, m, d): "
          f"{sorted(rbf_shapes.items(), key=lambda kv: -kv[1])}", flush=True)
    print(f"[launches] table1 phase: {json.dumps(t1_launches)}; rbf_gram by shape: "
          f"{sorted(t1_shapes.items(), key=lambda kv: -kv[1])}", flush=True)
    for name, counts, shapes in (("phases 4-5", launches, rbf_shapes),
                                 ("table1", t1_launches, t1_shapes)):
        if sum(shapes.values()) != counts["rbf_gram"]:
            raise AssertionError(f"rbf_gram in {name}: {counts['rbf_gram']} launches, "
                                 f"{sum(shapes.values())} calls by shape")
    # 4 apps x 10 folds: a fit at 1,584 samples, and its 176 held-out
    # samples predicted twice (MAE and PAE)
    for shape, n in (((1, 1584, 1584, 3), 40), ((1, 176, 1584, 3), 80)):
        if t1_shapes[shape] != n:
            raise AssertionError(f"table1: rbf_gram at {shape} launched {t1_shapes[shape]} "
                                 f"times, not {n}")
    results["rbf_gram"]["table1_launches"] = t1_launches["rbf_gram"]
    sim_calls = {}
    lockstep = {}
    sim_launches, sim_shapes = _counted(
        ops, lambda: lockstep.update(phase_fleet_sim(torch, np, smi)), sim_calls)
    t0 = _stage("fleet simulation: four runs of python -m repro_torch.fleet", t0)
    phase_fleet_control(torch, np)
    t0 = _stage("fleet simulation: the control", t0)
    for name, tally in sim_shapes.items():
        if sum(tally.values()) != sim_launches[name]:
            raise AssertionError(f"{name} in the fleet simulation: {sim_launches[name]} "
                                 f"launches, {sum(tally.values())} calls by shape")
    print(f"[launches] fleet simulation: {json.dumps(sim_launches)}", flush=True)
    for name, numbers in phase_fleet_kernels(torch, np, kind, sim_shapes, sim_calls).items():
        results[name].update(numbers, fleet_launches=sim_launches[name])
        launches[name] += sim_launches[name]
    t0 = _stage("fleet simulation: the planning kernels at its shapes", t0)
    service_calls = {}
    service_launches, service_shapes = _counted(
        ops, lambda: phase_service(torch, np, smi, lockstep), service_calls)
    t0 = _stage("fleet service: service runs, kills and resumes, the JAX journal", t0)
    for name, tally in service_shapes.items():
        if sum(tally.values()) != service_launches[name]:
            raise AssertionError(f"{name} in the fleet service: {service_launches[name]} "
                                 f"launches, {sum(tally.values())} calls by shape")
    print(f"[launches] fleet service: {json.dumps(service_launches)}", flush=True)
    for name, numbers in phase_fleet_kernels(torch, np, kind, service_shapes, service_calls,
                                             label="fleet service", prefix="service").items():
        results[name].update(numbers, service_launches=service_launches[name])
        launches[name] += service_launches[name]
    t0 = _stage("fleet service: the planning kernels at its shapes", t0)
    phase_service_faults(torch, np, smi)
    phase_service_batches(torch, np)
    t0 = _stage("fleet service: faults and fit_many's batches", t0)
    phase_apps(torch, np, smi)
    t0 = _stage("apps: the JAX golden and native sizes", t0)
    mixed_calls = {}
    mixed_launches, mixed_shapes = _counted(ops, lambda: phase_mixed(torch, np, smi),
                                            mixed_calls)
    t0 = _stage("mixed fleet: lockstep, service, kill and resume; launch.train --auto-energy",
                t0)
    for name, tally in mixed_shapes.items():
        if sum(tally.values()) != mixed_launches[name]:
            raise AssertionError(f"{name} in the mixed fleet: {mixed_launches[name]} "
                                 f"launches, {sum(tally.values())} calls by shape")
    print(f"[launches] mixed fleet and auto-energy: {json.dumps(mixed_launches)}", flush=True)
    for name, numbers in phase_fleet_kernels(torch, np, kind, mixed_shapes, mixed_calls,
                                             label="mixed fleet", prefix="mixed").items():
        results[name].update(numbers, mixed_launches=mixed_launches[name])
        launches[name] += mixed_launches[name]
    t0 = _stage("mixed fleet: the planning kernels at its shapes", t0)
    phase_serve_golden(torch, np)
    t0 = _stage("serve: SMOKE golden on the card", t0)
    serve_launches, flash_by_path = phase_serve_full(torch, np, smi)
    t0 = _stage("serve: full width, kernel and plain arms", t0)
    for name in ("flash_attention", "ssd_chunks"):
        launches[name] = serve_launches[name]
    results["flash_attention"]["serve_launches_by_path"] = flash_by_path
    published = phase_serve_published(torch, np, smi)
    t0 = _stage("serve: Zamba2-7B-Instruct's layout, SMOKE then full width", t0)
    for name, n in published.items():
        launches[name] += n
        results[name]["zamba2_pub_launches"] = n
    phase_train_golden(torch, np)
    t0 = _stage("train: SMOKE golden on the card", t0)
    ops.reset_launches()  # the training path's launches are counted from here
    star_launches, _ = phase_train_starcoder(torch, np)
    t0 = _stage("train: starcoder2-3b full width", t0)
    mamba_launches, _ = phase_train_mamba(torch, np)
    t0 = _stage("train: mamba2-130m full width, launch.train.main and resume", t0)
    phase_train_mamba_apart(torch, results["ssd_chunks"]["train_ms"])
    t0 = _stage("train: mamba2-130m full width, a step taken apart", t0)
    train_launches = {k: TRAIN_COUNTED * star_launches.get(k, 0) + mamba_launches.get(k, 0)
                      for k in ops.LAUNCHES}
    for name in ("int8_quantize", "int8_dequantize", "attention_bwd", "ssd_bwd"):
        launches[name] = train_launches[name]

    phase_sharding(torch, np)
    t0 = _stage("distribution: the partition rules of ten archs on five meshes", t0)
    elastic_launches, _ = _counted(ops, lambda: phase_elastic(torch, np, ops, smi))
    t0 = _stage("distribution: mamba2-130m re-meshed under ElasticController", t0)
    print(f"[launches] elastic re-mesh: {json.dumps(elastic_launches)}", flush=True)
    for name in ("rbf_gram", "plan_argmin", "ssd_chunks", "ssd_bwd", "int8_quantize",
                 "int8_dequantize"):
        if elastic_launches[name] <= 0:
            raise AssertionError(f"elastic re-mesh: {name} never launched")
    remesh_launches, _ = _counted(ops, lambda: phase_remesh_to_card(torch, np, smi))
    t0 = _stage("distribution: a (2, 4) gloo checkpoint resharded onto the card", t0)
    print(f"[launches] host-to-card re-mesh: {json.dumps(remesh_launches)}", flush=True)
    if remesh_launches["flash_attention"] <= 0:
        raise AssertionError("host-to-card re-mesh: flash_attention never launched")
    for name in ops.LAUNCHES:
        results[name]["elastic_launches"] = elastic_launches[name]
        results[name]["remesh_launches"] = remesh_launches[name]
        launches[name] += elastic_launches[name] + remesh_launches[name]

    before = dict(ops.LAUNCHES)
    phase_dryrun(smi)
    if dict(ops.LAUNCHES) != before:
        raise AssertionError("the dry run moved the launch counts")
    t0 = _stage("dry run: the port's 66 production cells against the reference's", t0)
    dryrun_calls = {}
    dryrun_launches, dryrun_shapes = _counted(ops, lambda: phase_dryrun_plans(torch, smi),
                                              dryrun_calls)
    t0 = _stage("dry run: the records planned, plan_many and the fleet's --artifacts", t0)
    print(f"[launches] dry-run records planned: {json.dumps(dryrun_launches)}", flush=True)
    for name, numbers in phase_fleet_kernels(torch, np, kind, dryrun_shapes, dryrun_calls,
                                             label="dry-run records planned",
                                             prefix="dryrun").items():
        results[name].update(numbers, dryrun_launches=dryrun_launches[name])
        launches[name] += dryrun_launches[name]
    t0 = _stage("dry run: the planning kernels at its shapes", t0)
    phase_lint()
    t0 = _stage("repro-lint over the checkout", t0)

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
        "int8_quantize": ("src/repro_torch/kernels/csrc/int8_codec.cu",
                          "src/repro/kernels/int8_codec.py:35"),
        "int8_dequantize": ("src/repro_torch/kernels/csrc/int8_codec.cu",
                            "src/repro/kernels/int8_codec.py:63"),
        "attention_bwd": ("src/repro_torch/kernels/csrc/attention_bwd.cu",
                          "none (the reference's backward is jnp: "
                          "src/repro/kernels/ops.py:_flash_vjp)"),
        "ssd_bwd": ("src/repro_torch/kernels/csrc/ssd_bwd.cu",
                    "none (the reference's backward is jnp: "
                    "src/repro/kernels/ops.py:_ssd_vjp)"),
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
        # the other shapes' numbers (flash_attention's decode and training,
        # ssd_chunks' training) and flash_attention's lse error
        entry.update({key: val for key, val in r.items()
                      if key.startswith(("decode_", "train_", "lse_", "fp32_", "d256_",
                                         "mqa_", "d64_", "pairs_", "table1_", "fleet_",
                                         "service_", "mixed_", "serve_", "whisper_",
                                         "phi3v_", "zamba2_", "elastic_", "remesh_",
                                         "dryrun_"))})
        if name in ("flash_attention", "ssd_chunks", "attention_bwd", "ssd_bwd"):
            entry["train_launches"] = train_launches[name]
        line.append(entry)
    left = _children()
    if left:
        raise AssertionError(f"processes this run started are still running: {left}")
    print(f"[total] {time.perf_counter() - t_start:.1f} s on {smi}", flush=True)
    print(json.dumps({"kernels": line}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
