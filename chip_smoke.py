#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit if it fails:

1. Card and build: prints the card's name and power limit, turns TF32 off
   for matmuls and cuDNN, builds every CUDA kernel from the sources in
   this checkout (``nvcc`` for ``sm_90a``, and K1's host binding with the
   host compiler, all at once), and counts the tensor-core
   instructions (``K6_TC_OP``) in K6's built library with ``cuobjdump``.
2. K1 and K2 against their plain PyTorch versions on the card, at the
   FL and LM paths' shapes and three larger ones, with the tolerances stated below,
   K2 also for exact symmetry; K1 (and K3 below) also for its plan (the
   library's ``pairwise_l2_plan`` against the Python mirror), one device
   kernel a call, exact symmetry and the same bits on a second call, and
   K1's range against ``clamp_min(hi - lo, 1e-30)`` bit for bit; the
   profiles -> DPP-kernel pipeline must be two device kernels (a call's
   device work counted in a CUDA graph captured from it).  Prints
   errors, the wrapper's time (K1's and K3's interleaved with their
   library call's), the kernel's device time per call (``device_ms``,
   from torch.profiler, summed over the kernels one call launches) and the
   plain and library times.  Then K5 (flash-decode, with its split of the
   KV axis) the same way, at the serving path's shape, the last decode
   step of qwen2-vl-2b, musicgen-medium and llama4-maverick (16 slots of
   192), three long shapes (one ragged) and
   the JAX test's three fp32 shapes, and K6 (causal flash
   attention) at the LM path's refresh shape, three long bf16 shapes and
   the JAX test's five fp32 shapes, windows included, and K7 (the WKV6
   recurrence) at rwkv6-7b's decode and prefill shapes, two long shapes,
   its admission prefill with decays exactly 0 and at 1 - 1e-7, the JAX
   test's four fp32 shapes and its state hand-off, each with the design
   the shape takes (recurrent, or chunked with its value slices).  K3 (squared
   distances) and K4 (XᵀX) the same way, at the stage-wise path's shapes,
   the JAX sweeps' shapes in both types and four larger ones; K3 is also
   held against an fp64 chain, no further from it than its plain version.
   K1's, K3's, K5's and K7's device times are taken twice: hot, back to
   back, and cold, with ``FLUSH_BYTES`` written before each call (their
   inputs are cold on the serving paths); the cold one is set against the
   bound and fails below it, the hot one (L2-resident) is printed only.  No
   kernel's device time in the ``kernels`` line may be below its bound.
3. The FL main path: five rounds of FL-DP³S at the paper's scale (C=100
   clients, 10 per round, 600 samples each, CNN (16, 32) with Q=128) through
   ``FLTrainer`` on ``cuda`` with the paper's config as it stands; checks
   that K1 and K2 ran on that path, that each cohort is 10 distinct clients and
   that losses, accuracy and GEMD are finite and in range.  Then the
   stage-wise eq.-14 path, ``gram(similarity_matrix(P, use_kernel=True))``
   (K3, then K4), on that run's FC-1 profiles (100 x 128) and on the Fig.-3
   gradient (100 x 4096) and representative-gradient (100 x 1280) profiles,
   each L held against the K1 + K2 kernel of the same profiles and against
   an fp64 chain; and the paper's comparison of selection strategies:
   fedavg, fl-dp3s, fedsae, power-of-choice and cluster, five rounds each
   at the same scale, with every cohort checked (power-of-choice: the top
   losses of its candidates; cluster: one client per fitted cluster).
   Then the federation engine (3d): FL-DP³S through ``FLTrainer.run`` (the
   engine) and ``run_legacy``, 5 rounds each, evaluated every round and
   re-profiled every 2, with the same cohorts and accuracies; ``run_many``
   over the five strategies with each grid point's cohorts held to its own
   ``run_scanned``; and the candidate funnel at C = 4,096 clients of 14
   images (Q = 512, k = 10, scenario flaky, 6 rounds re-profiled every 3):
   K1 and K2 launched exactly twice on the (512, 128) block (init and the
   boundary), the (512, 512) kernel against the plain chain, every pick
   among its candidates and available, K1 and K2 held to their plain
   versions on that block and timed there (cold), and a heavy_tail run
   without the funnel giving the cohorts of a run without a scenario, its
   two inits launching K1 and K2 once each at (4,096, 128).  Then
   robustness and checkpoints (3e) on the paper's cell: each aggregator
   under ``corrupt`` faults beside a plain run (every delivered NaN or
   garbage cohort member flagged, finite params under the robust ones),
   ``lemons`` with no client selected while quarantined, FedProx and
   FedDyn (plain and under ``chaos`` + ``trimmed_mean``: ``h`` moving only
   for the cohort members whose update was kept; FedProx at mu 0 the plain
   run bit for bit), a checkpointed ``chaos`` + ``trimmed_mean`` + FedDyn
   run against 4 rounds, a restore into a fresh state and the rest (every
   state tensor, generator state and output bit for bit), and the LM
   launcher at full width resuming at round 2 from its snapshot.
4. The serving main path: smollm-360m at full width (32 layers, bf16,
   random weights from seed 0) with ``use_flash=True``, in scan mode
   (batch 16, prompt 128, 64 tokens) and through ``ServeEngine`` (16 slots,
   48 requests, budgets in [32, 128]); checks that K5 ran once per layer and
   decode step and never at admission, that every request finishes once
   with its budget, that both engine entry points kept one shape signature,
   that the continuous run's tokens agree with a reference run of the same
   prompts without the engine or K5, that greedy scan tokens without K5
   equal the legacy loop's bit for bit, and holds K5's teacher-forced
   logits against the plain attention's; prints the host cost of the MLP
   activation rounded as JAX's against PyTorch's fused op.
5. The LM client path at full width: ``python -m
   repro_torch.launch.train --mode fl --arch smollm-360m --full-width
   --flash --seq 512`` (10 clients, 4 a round, 3 rounds) and ``--mode
   pretrain`` for a few steps, both through the launcher's ``main``;
   checks that K6 took every layer of every loss-refresh forward and no
   gradient pass, that K1 and K2 built the kernel once and that it agrees
   with the plain chain on the path's profiles, that every round's
   loss and GEMD are finite, and holds the refresh through K6 against the
   same refresh without it (losses, and the final hidden states with a
   control that breaks the bound).
5b. The LM client path and pretrain of the six later archs, each through
   the launcher's ``main`` (``TRAIN_PATHS``), each model freed before the
   next is built: ``--mode fl --flash`` (10 clients, 4 a round, 16 docs of
   128 tokens, 1 round of 2 local steps of 4) and ``--mode pretrain`` (2
   steps of 4 x 128, the arch's optimizer as JAX steps it):
   rwkv6-7b cut to 8 layers (K7 on the refresh), qwen2-vl-2b and
   musicgen-medium whole (K6), recurrentgemma-9b cut to 6 layers and
   mixtral-8x7b to 1 (no kernel: their attention layers have windows),
   llama4-maverick's reduced fp32 config (K6's fp32 kernel).  The checks
   of phase 5: launches exact (K6 once per window-free attention layer and
   K7 once per RWKV layer of each refresh forward, K1 and K2 once, nothing
   in a gradient pass or in pretrain), cohorts, finite losses, GEMDs and
   params, the eq.-14 kernel against the plain chain, and the refresh
   through the kernel against the same refresh without it, with controls
   that must break the bound (K6 through a 64-position window, and for
   musicgen also positions half a sequence deep; K7 without its bonus u,
   bounded by three bf16 witnesses without K7, one of them K7's own
   arithmetic taken in torch, by the plain bf16 path's distance from the
   fp32 model, and on an fp32 copy).  Prints
   each run's seconds, per-round split, peak memory beside its reckoning,
   the peak of one local step with and without remat, and pretrain tok/s.
6. The RWKV-6 serving path: rwkv6-7b at full width (32 layers, d_model
   4096, 64 WKV heads of 64, bf16, random weights from seed 0) with
   ``use_flash=True``, in scan mode and through ``ServeEngine`` as in 4;
   the same checks, with K7 launched once per layer at every prefill and
   every decode step, and its teacher-forced logits against the plain scan
   and an fp32 copy of the model; two witnesses without K7 (the plain scan
   with its sums reordered, and one bf16 step added in layer 0) show how
   far correct bf16 paths part, and K7's bf16 logits are held to them.  The
   continuous tokens are held on an engine over the fp32 copy.
6b. The five archs of the last model slice, served as in 4 through the
   launchers' ``build_model`` at full width (the depth-cut ones with its
   ``layers``), each freed before the next
   loads: qwen2-vl-2b (M-RoPE, all 28 layers) and musicgen-medium
   (sinusoidal positions, all 48) through K5, recurrentgemma-9b (RG-LRU
   and local attention, all 38) through no kernel, mixtral-8x7b (every
   layer SWA + MoE, cut to 8 of 32 layers) through no kernel, and
   llama4-maverick (cut to 2 of 48 layers: one attn+mlp, one attn+moe with
   all 128 experts and the shared expert) through K5.  The same checks,
   with K5 once per layer at every decode step or no kernel at all.  The
   two depth-cut MoE archs run scan mode only (``SERVE_SCAN_ONLY``): their
   continuous runs are left out to keep the run's time down;
   recurrentgemma-9b's continuous run takes 8 requests through 4 slots
   (``SERVE_SHORT``).  A plain run
   held to a kernel run takes its expert choices (top-k routing flips on
   bf16 rounding where router logits nearly tie), and the choices that
   differ are counted; the share of (token, expert) pairs each kind of
   call (prefill, decode step) dropped is printed, since capacity drops
   depend on a call's other tokens.  llama4's fp32 copy does not fit
   beside it, so check (e)'s fp32 leg is skipped for that arch alone
   (``FP32_SKIPPED``) with the byte count that rules it out; for any other
   arch a copy that does not fit fails the run.
6c. Observability (``obs_phase``): FL-DP³S at the paper's cell through
   ``FLTrainer.run`` (4 rounds re-profiled every 2, ``chaos`` with
   ``trimmed_mean``, cuDNN deterministic) with telemetry and a sink and
   without, from trainers built alike: outputs, final state, history and
   generators bit for bit, the events (a manifest naming the card, a
   ``fl_round`` a round, one ``fl_reprofile``) and their fields; then
   smollm-360m at full width with K5 through ``ServeEngine`` (16
   requests, budgets in [8, 32], chunks of 8) with a sink and without:
   the same tokens, one shape signature per entry point, the events, K5
   once per layer and decode step in both; then ``--profile-dir``: the
   serve launcher at full width (``--continuous --flash``, 4 requests of
   16 tokens in 4 slots) and a 2-round CNN run of 20 clients under
   ``tracing.trace``: each Chrome trace parses and holds the engines'
   host spans, and the device kernels it recorded are printed beside the
   launch counters (or that it recorded none).  Phase 5's FL run also
   writes ``--telemetry``: one ``fl_round`` a round equal to its outputs,
   rendered by the report.
7. The dry run against the card (``dryrun_phase``): the dry run's records
   (``repro_torch.launch.dryrun``, fake tensors) of smollm-360m's train_4k
   (Mode A) and decode_32k and llama4-maverick's train_4k (Mode B,
   Adafactor, 8 micro-batches: more than one card), computed in worker
   processes on the host's cores from the end of phase 2 (beside phases
   3-3e); then, in one of those workers during phase 3e (``card_steps``),
   cuBLAS's workspaces and ``_softmax_backward_data``'s own buffers held
   to the dry run's, and smollm-360m's decode step (the batch halved until
   the dry run's peak fits, through K5) and its Mode-A round (``TRAIN_CUT``:
   two clients of one sequence, two local steps) at full width and depth:
   the real FLOPs (``FlopCounterMode``, the plain path) equal to the fake
   count and ``max_memory_allocated`` within ``DRY_MEM_BAND`` of the dry
   run's peak; here, each step's uninstrumented time beside the roofline's
   terms; then one Mode-B step and one FedOpt round of the fp32 model on
   the card held to the same on the CPU (run by a worker from the same
   seeds).
8. The client mesh (``mesh_phase``) on one NCCL rank
   (``launch/mesh.make_client_mesh(1)``): the paper's CNN at C = 100
   through ``FLTrainer(mesh=)``, resident rounds (a) and slot rounds (b,
   ``cohort_cap`` = k), each against the unsharded trainer from the same
   seed (cohorts bit for bit, params within 1e-5, one all-reduce a round by
   the mesh's counter; (b) traced: one ``nccl:all_reduce`` record a
   round, and the NCCL device kernels seen, if any); bounded staleness
   (c, bound 2, heavy_tail, exponential α 0.3: counters <= 2, ``sim_time``
   at most the synchronous barrier on the same latencies, cohorts (a)'s);
   the funnel at C = 4,096, Q = 512 under the mesh (d: each all-reduced
   candidate block equal to ``index_select``'s bit for bit, K1 and K2 at
   init and at the boundary); and the launcher at full width (e:
   smollm-360m ``--shard-clients 1 --cohort-cap 4 --flash``, K6 once a
   layer and refresh; against the same argv unsharded: cohorts bit for
   bit, bf16 params within 2 steps of bf16, losses close).
8b. The production mesh on the card (``prod_mesh_phase``, in a spawned
   worker: the ``fake`` process group is the process's default group):
   rank 0's program of the 16 x 16 mesh (``launch/mesh.
   make_production_mesh``'s layout on ``cuda``) on real CUDA tensors made
   at each device's shapes (``dryrun.materialize``), its collectives
   moving nothing: smollm-360m's Mode-A round cut as phase 7's
   ``TRAIN_CUT`` to one client a device, its decode_32k step (the plain
   attention: the caches' sequence is sharded, K5 launched never), and
   rwkv6-7b's decode_32k step (K7 through ``local_map`` on the device's 8
   rows and 4 of 64 heads, its first call held to the plain scan on the
   same local inputs).  Each step's FLOPs (``analysis/ops.StepCounter``,
   ``FlopCounterMode``'s formulas on the local tensors) equal the sharded
   dry run's per-device count, its ``max_memory_allocated`` lies within
   ``DRY_MEM_BAND`` of the dry run's per-device peak, and its collectives
   match the record's, kind by kind.
9. Prints, for each shape a path gives K1 or K3, each shape the RWKV
   path gave K7, each new arch's decode shape of K5 and each refresh shape
   of K6 in phase 5b and phase 8, its launches there beside that shape's
   cold device time and bound (K1 and K3 also their plan and library
   time); then one JSON line describing every kernel (K1 and K2 also at
   the funnel's shape, on phase 8's mesh and at the unfunnelled init's
   C = 4,096, K5 at the three new decode shapes, K1, K6 and K7 at phase
   5b's shapes and K6 at phase 8's), then the device line
   ``{"ok": true, "device": {...}}`` last.

It needs no network and imports nothing of JAX.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import json
import math
import multiprocessing
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
from repro_torch.analysis.roofline import HW  # noqa: E402

# Peak rates of one H100 SXM (NVIDIA data sheet, dense, at 700 W), the
# port's one definition: fp32 on the CUDA cores, TF32 and bf16 on the
# tensor cores
PEAK_BYTES_PER_S = HW.HBM_BW
PEAK_FLOPS = HW.PEAK_FLOPS
# device_ms's cold mode writes this many bytes before each profiled call:
# five times the 50 MB L2, so a call finds its inputs in device memory
FLUSH_BYTES = 256 << 20

ROUNDS = 5
# K1 at the inits of phase 5b: the profiles' widths (qwen2-vl-2b and
# musicgen-medium, rwkv6-7b, recurrentgemma-9b and mixtral-8x7b, llama4's
# reduced config)
TRAIN_K1_SHAPES = [(10, 1536, "fp32"), (10, 4096, "fp32"), (10, 256, "fp32")]
SHAPES = [  # (C, Q, dtype name): the FL main path's shape first, then the LM path's
    (100, 128, "fp32"),
    (10, 960, "fp32"),
    (1000, 700, "fp32"),
    (4096, 128, "fp32"),
    (513, 257, "bf16"),
] + TRAIN_K1_SHAPES
# K5: (B, S, H, Hk, hd, dtype name, lengths); None = ragged with an empty
# and a full slot; "full" = every slot at S.  The serving path's shape first.
DECODE_SHAPES = [
    (16, 256, 15, 5, 64, "bf16", None),
    (16, 192, 12, 2, 128, "bf16", "full"),  # qwen2-vl-2b's last decode step (G = 6)
    (16, 192, 24, 24, 64, "bf16", "full"),  # musicgen-medium's (MHA, G = 1)
    (16, 192, 40, 8, 128, "bf16", "full"),  # llama4-maverick's (G = 5)
    (16, 4096, 15, 5, 64, "bf16", "full"),
    (16, 4096, 15, 5, 64, "bf16", None),
    (1, 32768, 15, 5, 64, "bf16", "full"),
    (5, 40, 4, 2, 32, "fp32", [0, 1, 7, 33, 40]),  # the JAX test's shapes
    (2, 64, 4, 4, 16, "fp32", [64, 50]),
    (3, 16, 4, 1, 64, "fp32", [16, 3, 9]),
]
# the serving main paths at full width: smollm-360m, qwen2-vl-2b,
# musicgen-medium and llama4-maverick through K5, rwkv6-7b through K7, and
# recurrentgemma-9b and mixtral-8x7b through no kernel (every attention
# layer of theirs has a window); arch -> (kernel or None, label, runs at
# prefill too, d_model, layers on the card, the dtype in which the
# end-to-end bounds (e) and (f) are held).  Depth is cut where the bf16
# model and check (e)'s fp32 copy do not fit the card: mixtral-8x7b (about
# 94 GB in bf16) to 8 of 32 layers, llama4-maverick (400 B parameters) to
# 2 of 48, one attn+mlp and one attn+moe layer with all 128 experts.
# rwkv6-7b's bounds are held on an fp32 copy of the model: at random init
# its layers amplify rounding differences so far that two correct bf16
# paths part by about a third of max|logits| at 32 layers, while in fp32
# they part by a few percent.  The script shows it each run with two witnesses that do
# not involve K7 (``serve_phase``, check (e)), and holds K7's bf16 logits
# to them
SERVE_PATHS = {
    "smollm-360m": ("flash_decode", "K5", False, 960, 32, "bfloat16"),
    "rwkv6-7b": ("wkv6", "K7", True, 4096, 32, "float32"),
    "qwen2-vl-2b": ("flash_decode", "K5", False, 1536, 28, "bfloat16"),
    "musicgen-medium": ("flash_decode", "K5", False, 1536, 48, "bfloat16"),
    "recurrentgemma-9b": (None, "use_flash", False, 4096, 38, "bfloat16"),
    "mixtral-8x7b": (None, "use_flash", False, 4096, 8, "bfloat16"),
    "llama4-maverick-400b-a17b": ("flash_decode", "K5", False, 5120, 2, "bfloat16"),
}
# the archs the last model slice serves, in the order the phase runs them
NEW_SERVE_ARCHS = ("qwen2-vl-2b", "musicgen-medium", "recurrentgemma-9b", "mixtral-8x7b",
                   "llama4-maverick-400b-a17b")
# archs served in scan mode only, without the continuous run and its checks
# (the second half of (a), (b), (c) and (f)): the depth-cut MoE archs, whose
# continuous runs would add ~70 s to a run that passes 600 s without them
SERVE_SCAN_ONLY = ("mixtral-8x7b", "llama4-maverick-400b-a17b")
# archs whose continuous run is shorter than SERVE_REQUESTS requests through
# SERVE_BATCH slots: (requests, slots).  recurrentgemma-9b's admission loops
# on the host over its 128 prompt tokens; 8 of them make room for phase 7
SERVE_SHORT = {"recurrentgemma-9b": (8, 4)}
# the one arch whose fp32 copy (check (e)) cannot fit beside its bf16
# model on an 80 GB card: llama4-maverick's 2 layers hold ~36.6 GB in bf16
FP32_SKIPPED = ("llama4-maverick-400b-a17b",)
# card memory kept free beside the model and its fp32 copy (check (e)):
# caches, activations, logits of the teacher-forced runs
SERVE_HEADROOM = 8 << 30
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 16, 128, 64
SERVE_REQUESTS, SERVE_BUDGETS, SERVE_CHUNK = 48, (32, 128), 8
FL_KERNELS = ("pairwise_dists_stats", "normalized_gram")
# the SASS instruction of K6's bf16 kernel (wgmma on the tensor cores)
K6_TC_OP = "HGMMA"
# K6: (B, S, H, Hk, hd, dtype name, window); the LM path's refresh shape first
ATTN_SHAPES = [
    (16, 512, 15, 5, 64, "bf16", None),
    (4, 2048, 15, 5, 64, "bf16", None),
    (2, 1000, 48, 8, 128, "bf16", None),  # ragged: 1000 = 15 * 64 + 40
    (1, 4096, 16, 16, 256, "bf16", None),
    (2, 64, 4, 2, 32, "fp32", None),  # the JAX test's shapes
    (1, 100, 4, 4, 16, "fp32", None),
    (2, 64, 8, 2, 32, "fp32", 16),
    (1, 128, 4, 1, 64, "fp32", 32),
    (1, 32, 2, 2, 8, "fp32", None),
]
# K6 at the refresh of phase 5b (16 docs of 128 tokens): qwen2-vl-2b and
# musicgen-medium in bf16, llama4-maverick's reduced config in fp32; their
# device time is also taken cold, as the refresh finds its inputs
TRAIN_ATTN_SHAPES = [
    (16, 128, 12, 2, 128, "bf16", None),
    (16, 128, 24, 24, 64, "bf16", None),
    (16, 128, 4, 2, 64, "fp32", None),
]
ATTN_SHAPES += TRAIN_ATTN_SHAPES
# K6 at the refresh of phase 8 (e): smollm-360m's 16 docs of the
# launcher's default 128 tokens
MESH_ATTN_SHAPES = [(16, 128, 15, 5, 64, "bf16", None)]
ATTN_SHAPES += MESH_ATTN_SHAPES
# rwkv6-7b's decode step on the 16 x 16 mesh (phase 8b): one device's K7 call
PROD_MESH_K7 = (8, 1, 4, 64)
# K7: (B, T, H, hd, dtype name, decays); rwkv6-7b's decode step first,
# then its prefill of one admitted request and of the scan batch.  Decays:
# None = the JAX test's (fp32) or the model's law (bf16); "edge" = the
# model's law with a fifth of the channels exactly 0 (its exponent clamped
# at 8) and a fifth at 1 - 1e-7 (its slowest)
WKV_SHAPES = [
    (16, 1, 64, 64, "bf16", None),
    PROD_MESH_K7 + ("bf16", None),  # the decode step's on the 16 x 16 mesh (phase 8b)
    (1, 128, 64, 64, "bf16", None),
    (16, 128, 64, 64, "bf16", None),
    (4, 2048, 64, 64, "bf16", None),
    (1, 4096, 64, 64, "bf16", None),
    (1, 128, 64, 64, "bf16", "edge"),
    (2, 64, 2, 16, "fp32", None),  # the JAX test's shapes
    (1, 100, 3, 32, "fp32", None),
    (2, 33, 1, 64, "fp32", None),
    (1, 16, 2, 8, "fp32", None),
]
# K3: (C, Q, dtype name); the FC-1 path's shape first, then the stage-wise
# route's other two (representative and gradient profiles), the JAX sweep's
# shapes (tests/test_kernels.py::test_pairwise_l2_sweep) in both types, and
# two shapes whose bounds are above 0.05 ms.  K4: (M, N, dtype name); the
# stage-wise path's S (C x C) first, the JAX test's shapes
# (tests/test_gram_kernels.py), and one shape with a bound above 0.05 ms
K3_SHAPES = [(100, 128, "fp32"), (100, 1280, "fp32"), (100, 4096, "fp32")] + [
    (c, q, kind) for c, q in ((4, 3), (10, 7), (100, 128), (130, 257), (64, 512))
    for kind in ("fp32", "bf16") if (c, q, kind) != (100, 128, "fp32")
] + [(4096, 128, "fp32"), (4096, 512, "fp32")]
K4_SHAPES = [
    (100, 100, "fp32"), (5, 4, "fp32"), (64, 64, "fp32"), (130, 70, "fp32"), (33, 257, "fp32"),
    (96, 40, "bf16"), (4096, 1024, "fp32"), (4096, 1024, "bf16"),
]
# the paper's baseline comparison: every strategy on the phase-3 data
BASELINES = ("fedavg", "fl-dp3s", "fedsae", "power-of-choice", "cluster")
# the federation engine's phase: engine and legacy loops, the run_many
# grid, and the funnel (the phase-3 images cut to FUNNEL_N_C a client)
ENGINE_ROUNDS = 5
FUNNEL_C, FUNNEL_N_C, FUNNEL_FRAC, FUNNEL_ROUNDS, SCENARIO_ROUNDS = 4096, 14, 0.125, 6, 2
# the LM client path (smollm-360m at full width)
LM_ROUNDS, LM_CLIENTS, LM_PER_ROUND, LM_SEQ, LM_DOCS = 3, 10, 4, 512, 16
# robustness and checkpoints (phase 3e): rounds per aggregator and
# algorithm, rounds of the lemon run, rounds of the resumed run
ROBUST_ROUNDS, LEMON_ROUNDS, RESUME_ROUNDS = 5, 8, 6
PRETRAIN_STEPS = 6
# bounds on the refresh with K6 against the refresh without it, fixed
# before the first run (PERF.md): per-client losses, and the relative
# Frobenius distance of the final hidden states of one refresh batch
LM_LOSS_BOUND, LM_HIDDEN_BOUND, CONTROL_WINDOW = 2e-3, 0.03, 64
# phase 5b: the LM client path and pretrain of the six archs of the last
# model slice through the launcher, one model at a time; arch -> (the
# launcher's depth flags, the kernel its refresh takes or None).  Depth is
# cut where a round's C_p updated copies do not fit the card (PERF.md §4):
# rwkv6-7b to 8 of 32 layers, recurrentgemma-9b to 6 of 38 (two units of
# its pattern), mixtral-8x7b to 1 of 32; llama4-maverick trains its
# reduced fp32 config, as the JAX launcher does, since one full-width MoE
# layer with its gradients and copies does not fit one card
TRAIN_PATHS = {
    "rwkv6-7b": (["--full-width", "--layers", "8"], "wkv6"),
    "qwen2-vl-2b": (["--full-width"], "flash_attention"),
    "musicgen-medium": (["--full-width"], "flash_attention"),
    "recurrentgemma-9b": (["--full-width", "--layers", "6"], None),
    "mixtral-8x7b": (["--full-width", "--layers", "1"], None),
    "llama4-maverick-400b-a17b": ([], "flash_attention"),
}
# one round and two pretrain steps: the phase took 185.7 s with two rounds
# and three steps on a slow host, past the script's budget of ~800 s
# (PERF.md §6), and rwkv6-7b's plain scan under autograd (2.5 s a local
# step) is most of it
TRAIN_ROUNDS, TRAIN_SEQ, TRAIN_PRETRAIN_STEPS = 1, 128, 2
# phase 6c, observability: the CNN run with and without telemetry (rounds,
# reprofiled every OBS_EVERY); the serving run with and without a sink
# (requests, budgets, decode chunk; SERVE_BATCH slots, SERVE_PROMPT
# tokens); the traced runs, kept small (a trace of full-width rounds holds
# tens of thousands of aten ops a step): the serve launcher's requests,
# tokens and slots, and a CNN run of OBS_TRACE_C clients of the phase-3
# data for 2 rounds
OBS_ROUNDS, OBS_EVERY = 4, 2
# phase 8, the client mesh on one NCCL rank: rounds of the CNN runs (a)
# and (b) and of the stale run (c), and the launcher's run (e) (rounds,
# clients a round and the cohort cap)
MESH_ROUNDS, MESH_STALE_ROUNDS, MESH_LM_ROUNDS, MESH_LM_PER_ROUND = 5, 5, 2, 4
MESH_TRACE_ROUNDS = 2  # (b)'s traced run, apart from its timed one
# (e) against the unsharded launcher: each bf16 param within MESH_LM_ULPS
# steps of bf16 at its magnitude (plus MESH_LM_ATOL near zero); round 1's
# loss within fp32 rounding (1e-5), every loss within MESH_LM_LOSS_RTOL
MESH_LM_ULPS, MESH_LM_ATOL, MESH_LM_LOSS_RTOL = 2, 1e-6, 1e-2
# phase 7: the dry run's full-width records and the CPU halves of its
# parity checks, run in DRY_WORKERS processes on the host's cores from the
# end of phase 2, beside phases 3-3e; smollm-360m's steps on the card in one
# of those processes during phase 3e (``card_steps``): the decode step at
# the largest batch, halved from 128, whose dry-run peak fits DRY_FIT of the
# card, and the Mode-A round (``TRAIN_CUT``) cut for the phase's time, not
# for memory (the full round's peak fits the card), to DRY_CLIENTS clients
# of one sequence and DRY_LOCAL_STEPS local steps, so that the dry run
# replays a gradient across steps and across clients; max_memory_allocated
# held within DRY_MEM_BAND of the dry run's peak; the Mode-B and FedOpt
# parity at DRY_PARITY_SEQ tokens
DRY_CASES = (("smollm-360m", "train_4k"), ("smollm-360m", "decode_32k"), ("llama4-maverick-400b-a17b", "train_4k"))
DRY_WORKERS, DRY_CLIENTS, DRY_LOCAL_STEPS, DRY_FIT, DRY_MEM_BAND, DRY_PARITY_SEQ = 4, 2, 2, 0.85, 0.10, 16
TRAIN_CUT = dict(arch="smollm-360m", shape="train_4k", batch=DRY_CLIENTS, clients=DRY_CLIENTS,
                 local_steps=DRY_LOCAL_STEPS)
# phase 8b: rank 0's program of the 16 x 16 mesh on the card, each case a
# DryRunCase's fields: the Mode-A round cut as TRAIN_CUT to one client of
# one sequence a device (16 clients), and the two decode steps at the
# shape's batch of 128 (8 rows a device; K7's call there: PROD_MESH_K7)
PROD_MESH_CASES = (
    ("smollm-360m Mode-A round", dict(arch="smollm-360m", shape="train_4k", batch=16, local_steps=DRY_LOCAL_STEPS)),
    ("smollm-360m decode_32k", dict(arch="smollm-360m", shape="decode_32k")),
    ("rwkv6-7b decode_32k", dict(arch="rwkv6-7b", shape="decode_32k")),
)
# the order of the runs with telemetry (True) and without, in (a) and (c)
OBS_TURNS = (False, True, True, False)
OBS_REQUESTS, OBS_BUDGETS, OBS_CHUNK = 16, (8, 32), 8
OBS_TRACE_REQUESTS, OBS_TRACE_GEN, OBS_TRACE_BATCH, OBS_TRACE_C = 4, 16, 4, 20
# the device kernels of the traced paths, by a part of their names
OBS_DEVICE_KERNELS = {"K1": "pairwise_kernel", "K2": "gram_syrk_kernel", "K5": "flash_decode"}


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def time_ms(torch, fn, launches: int = 50, repeats: int = 5, warmup: int = 5) -> float:
    """Device time of one call: CUDA events around ``launches`` calls back
    to back, over their count; the median of ``repeats`` such runs, after
    warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        per_call.append(start.elapsed_time(end) / launches)
    return statistics.median(per_call)


def time_pair(torch, fa, fb, repeats: int = 6, **kw):
    """``time_ms`` of two functions with their runs interleaved (a b, b a,
    a b, ...), so that a drift of the host's speed falls on both alike;
    returns the two medians."""
    a, b = [], []
    for r in range(repeats):
        for f, out in ((fa, a), (fb, b)) if r % 2 == 0 else ((fb, b), (fa, a)):
            out.append(time_ms(torch, f, repeats=1, **kw))
    return statistics.median(a), statistics.median(b)


def device_ms(torch, fn, mark: str, calls: int = 20, per_call: int = 1, cold: bool = False):
    """Device time (ms) per call of the kernels whose names hold ``mark``:
    ``calls`` calls under torch.profiler after one warm-up call, the
    ``per_call`` kernels each call launches (K5's split and merge kernels,
    K4's SYRK and its row-slice sum) summed.  ``cold``: before each call
    ``FLUSH_BYTES`` are written (that fill kernel is not counted), so the
    call reads its inputs from device memory and not from the L2, as on
    the serving paths, where all of a model's weights stream through the
    L2 between two calls of one layer's kernel.  The profiler drops a
    session's events now and then, and after a long run of small launches
    (the federation engine's phase) one or two of every session: a
    one-kernel call (``per_call`` 1) takes the mean of the events recorded
    when at least half of them are; otherwise a session that does not
    record exactly ``per_call`` such events per call is repeated once, and
    the result is None when the repeat misses too."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(FLUSH_BYTES // 4, device="cuda") if cold else None
    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                if flush is not None:
                    flush.fill_(1.0)
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        us = [e.time_range.elapsed_us() for e in events if mark in e.name]
        if len(us) == calls * per_call:
            return sum(us) / 1e3 / calls
        names = sorted({e.name[:60] for e in events})
        print(f"  device_ms({mark!r}): a session recorded {len(us)} of {calls * per_call} events "
              f"({len(events)} device events: {names[:6]})"
              + ("; the mean of those" if per_call == 1 and 2 * len(us) >= calls else ""))
        if per_call == 1 and 2 * len(us) >= calls:
            return sum(us) / 1e3 / len(us)
    return None


def device_kernels(torch, fn) -> list:
    """The device work (kernels, copies, fills) that one call of ``fn``
    puts on its stream: one label per node of a CUDA graph captured from
    the call, as the graph's DOT dump gives it (a kernel node's label holds
    the kernel's name).  A capture records every launch, where
    torch.profiler drops a session's device events now and then.  One call
    on the capture stream comes first, so that what a wrapper allocates
    and caches per stream (K1's ticket) exists before the capture."""
    import os
    import tempfile
    import warnings

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    side.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)  # kept for the dump, never run
    graph.enable_debug_mode()
    with torch.cuda.graph(graph, stream=side):
        fn()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "call.dot")
        with warnings.catch_warnings():  # the dump's own notices
            warnings.simplefilter("ignore")
            graph.debug_dump(path)
        dot = Path(path).read_text()
    del graph
    # a node's statement starts with its quoted name and a '[' (an edge's
    # with the name and '->'); its label runs to the next node's statement
    starts = [m.start() for m in re.finditer(r'^"graph_\d+_node_\d+"\s*\[', dot, flags=re.M)]
    return [dot[a:b] for a, b in zip(starts, starts[1:] + [len(dot)])]


def check_pairwise_call(torch, fn, c: int, q: int, what: str) -> str:
    """K1 or K3 (``fn``) at (c, q): the launch takes the plan of the Python
    mirror, is one device kernel, and gives an exactly symmetric result,
    the same bits on a second call; returns the plan as printed."""
    from repro_torch.kernels.pairwise_l2 import ops as pw_ops

    p = pw_ops.cuda_plan(c, q)
    check(p == pw_ops.plan(c, q), f"{what}: plan {p} is not the Python mirror's {pw_ops.plan(c, q)}")
    a, b = fn(), fn()
    torch.cuda.synchronize()
    a, b = (a, b) if isinstance(a, tuple) else ((a,), (b,))
    check(torch.equal(a[0], a[0].T), f"{what}: not exactly symmetric")
    check(all(torch.equal(x, y) for x, y in zip(a, b)), f"{what}: two calls differ")
    nodes = device_kernels(torch, fn)
    check(len(nodes) == 1 and "pairwise" in nodes[0], f"{what}: a call's graph holds {nodes}")
    return f"tile {p.tile}, {p.tiles} tiles x S={p.ranks} = {p.blocks} blocks"


def fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.5f}"


def share(bound_ms: float, dev_ms, what: str) -> str:
    """The bound as a share of a device time measured with the L2 flushed;
    a share above 1 means the timing or the bound is wrong, and fails."""
    if dev_ms is None:
        return ""
    check(bound_ms <= dev_ms, f"{what}: cold device time {dev_ms} below its bound {bound_ms}")
    return f" = {bound_ms / dev_ms:.4f} of the cold device time"


def bound(nbytes: float, flops: float, kind: str):
    """Least time (ms) the card could take: the larger of bytes over the
    memory rate and operations over the peak rate for their type."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def serve_phase(torch, dev, arch: str):
    """The serving main path of ``arch`` at full width through its kernel
    (``SERVE_PATHS``), which runs once per layer without a window at every
    decode step and, for K7, at every prefill; for an arch without a kernel
    no kernel may launch.  Returns the kernel's launches on the path (0
    without one), for K7 its calls there by input shape (B, T), whose sum
    is held to the launch count, and the phase's seconds.  For an arch of
    ``SERVE_SCAN_ONLY`` the continuous run and the checks on it (the second
    half of (a), (b), (c) and (f)) are left out; for one of ``SERVE_SHORT``
    they run with fewer requests and slots."""
    import collections
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.kernels import _build
    from repro_torch.launch import serve as serve_launch
    from repro_torch.models import layers as L
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as T
    from repro_torch.serve import ServeConfig, ServeEngine

    t_phase = time.perf_counter()
    kernel, label, at_prefill, width, depth, strict = SERVE_PATHS[arch]
    published = get_arch(arch).model.num_layers
    cfg, params = serve_launch.build_model(arch, 0, full_width=True, device=dev,
                                           layers=None if depth == published else depth)
    torch.cuda.synchronize()
    check((cfg.num_layers, cfg.d_model, cfg.dtype) == (depth, width, "bfloat16"), f"not full width: {cfg}")
    layers = cfg.num_layers
    mixers = [bt.split("+")[0] for bt in cfg.layer_types()]
    # the layers whose mixer reaches the kernel: K5 takes attention without
    # a window at decode, K7 every RWKV time mix
    per_step = {"flash_decode": mixers.count("attn"), "wkv6": mixers.count("rwkv"), None: 0}[kernel]
    check(kernel is None or per_step == layers, f"{arch}: {per_step} of {layers} layers reach {label}")
    per_prefill = per_step if at_prefill else 0
    others = [n for n in _build.LAUNCHES if n != kernel]
    moe = "moe" in "".join(cfg.block_pattern)
    continuous = arch not in SERVE_SCAN_ONLY
    n_req, slots = SERVE_SHORT.get(arch, (SERVE_REQUESTS, SERVE_BATCH))
    check(not (continuous and moe), f"{arch}: check (f)'s batch-{n_req} reference is another function")
    print(
        f"serving: {arch} at full width, {layers} of {published} layers, "
        f"{T.param_count(params) / 1e6:.1f} M parameters in {cfg.param_dtype}, activations and caches "
        f"in {cfg.dtype}; {cfg.num_heads}/{cfg.num_kv_heads} heads of {cfg.head_dim}, "
        f"pos {cfg.pos_style}, blocks {cfg.block_pattern}; built in {time.perf_counter() - t_phase:.1f} s"
    )
    # MoE instrumentation, for the MoE archs.  A call's capacity counts every
    # token of the call, so the (token, expert) pairs it drops depend on how
    # a run groups tokens into calls: ``moe_drops`` counts each call's
    # dropped and total pairs by the call's (B, S), with the model's own
    # routing and dispatch.  Top-k routing is discontinuous: two correct
    # paths whose hidden states part by bf16 rounding (K5 against plain
    # attention) choose other experts wherever two router logits nearly
    # tie, and such a token's output then parts by a whole expert's.  So a
    # plain run held to a kernel run takes the kernel run's expert choices
    # (``moe_record``, then ``moe_pinned``, which counts the choices that
    # differ from its own), and the bounds hold the rest of the path.
    moe_log = {"shape": None, "drops": None, "record": None, "pin": None, "flips": None}
    if moe:
        real_route, real_moe = moe_mod._route, moe_mod.apply_moe

        def shaped_moe(c, prm, x):
            moe_log["shape"] = f"{x.shape[0]}x{x.shape[1]}"
            return real_moe(c, prm, x)

        def routing(c, logits):
            idx, combine, aux = real_route(c, logits)
            if moe_log["record"] is not None:
                moe_log["record"].append(idx)
            elif moe_log["pin"] is not None:
                check(bool(moe_log["pin"]), "a pinned run made more MoE calls than the run it follows")
                want = moe_log["pin"].popleft()
                check(want.shape == idx.shape, f"a pinned MoE call of {tuple(idx.shape)} against {tuple(want.shape)}")
                moe_log["flips"][0] += (idx != want).any(-1).sum()
                moe_log["flips"][1] += idx.shape[0]
                gate = logits.gather(-1, want)  # the combine weights of the pinned experts, as _route forms them
                combine = (L.sigmoid(gate) if c.router_type == "sigmoid" else torch.softmax(gate, dim=-1)).float()
                idx = want
            if moe_log["drops"] is not None:
                _, _, keep = moe_mod._dispatch(idx, c.num_experts, moe_mod._capacity(c, logits.shape[0]))
                rec = moe_log["drops"].setdefault(moe_log["shape"], [0, 0])
                rec[0] = rec[0] + (~keep).sum()
                rec[1] += keep.numel()
            return idx, combine, aux

        moe_mod._route, moe_mod.apply_moe = routing, shaped_moe

    def moe_record(fn):
        """-> (fn(), the expert ids of every MoE call it made, in order)."""
        moe_log["record"] = []
        try:
            return fn(), moe_log["record"]
        finally:
            moe_log["record"] = None

    def moe_pinned(fn, record):
        """-> (fn() with every MoE call's experts taken from ``record`` in
        order, the token choices that differ from its own, all choices)."""
        if not moe:
            return fn(), 0, 0
        moe_log["pin"], moe_log["flips"] = collections.deque(record), [0, 0]
        try:
            out = fn()
            check(not moe_log["pin"], f"a pinned run left {len(moe_log['pin'])} MoE calls of the run it follows")
            return out, int(moe_log["flips"][0]), moe_log["flips"][1]
        finally:
            moe_log["pin"] = moe_log["flips"] = None

    def moe_drops(fn):
        """-> (fn(), its MoE calls' dropped and total pairs by call shape)."""
        moe_log["drops"] = {}
        try:
            return fn(), moe_log["drops"]
        finally:
            moe_log["drops"] = None

    def drop_shares(what, record):
        return f"{what}: " + ", ".join(
            f"{shape} calls {int(d)} of {n} pairs ({int(d) / n:.4%})" for shape, (d, n) in sorted(record.items()))

    rng = np.random.default_rng(0)
    b, p, g = SERVE_BATCH, SERVE_PROMPT, SERVE_GEN
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(b, p), dtype=np.int32), device=dev)
    # warm-up (cuBLAS handles, allocator pools), outside the counted runs
    serve_launch.run_scan_mode(cfg, params, prompts[:, :8], 4, use_flash=True)

    # K7's calls by input shape over the two counted runs
    shapes = collections.Counter()
    if kernel == "wkv6":
        from repro_torch.kernels.rwkv6_scan import ops as wkv_ops

        real_wkv6 = wkv_ops.wkv6

        def recorded(r, *rest):
            shapes[tuple(r.shape[:2])] += 1
            return real_wkv6(r, *rest)

        wkv_ops.wkv6 = recorded

    # scan mode through the kernel
    _build.reset_launches()
    toks, t = serve_launch.run_scan_mode(cfg, params, prompts, g, use_flash=True)
    scan_launches = dict(_build.LAUNCHES)
    print(
        f"scan B={b} P={p} G={g}: prefill {t['t_prefill'] * 1e3:.3f} ms, decode "
        f"{t['t_decode'] * 1e3:.3f} ms = {b * (g - 1) / t['t_decode']:.1f} tok/s; "
        f"launches {scan_launches}"
    )
    # (a) the kernel once per layer and decode step, and per layer at the
    # prefill for K7 (K5 takes only single-token steps); no other kernel
    if kernel is not None:
        check(scan_launches[kernel] == per_step * (g - 1) + per_prefill, f"{label} launches {scan_launches}")
    check(all(scan_launches[n] == 0 for n in others), f"another kernel ran: {scan_launches}")
    check(toks.shape == (b, g) and bool(((toks >= 0) & (toks < T.vocab_padded(cfg))).all()), "scan tokens")

    # continuous batching through ServeEngine
    class TimedEngine(ServeEngine):
        """Records each request's time to first token: from submission to
        the end of its own admission on the device (prefill and first
        sample), read by a synchronise after each admission.  The next
        admission's slot choice reads the occupancy mask on the host and
        waits for the device anyway, so the synchronise costs next to
        nothing."""

        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.ttft, admit = {}, self._admit.fn

            def timed_admit(params, state, prompt, gen_target, seq_id, generator):
                state = admit(params, state, prompt, gen_target, seq_id, generator)
                torch.cuda.synchronize()
                self.ttft[seq_id] = time.perf_counter() - self.t_submit
                return state

            self._admit.fn = timed_admit

    budgets = rng.integers(SERVE_BUDGETS[0], SERVE_BUDGETS[1] + 1, size=n_req)
    requests = rng.integers(0, cfg.vocab_size, size=(n_req, p), dtype=np.int32)
    gmax = int(budgets.max())
    scfg = ServeConfig(batch=slots, cache_len=p + gmax, max_new=gmax, decode_chunk=SERVE_CHUNK, use_flash=True)
    if not continuous:
        print(f"continuous: not run for {arch} (SERVE_SCAN_ONLY)")
        cont_launches = {n: 0 for n in _build.LAUNCHES}
    else:
        eng = TimedEngine(cfg, scfg, params, prompt_len=p, seed=0)
        _build.reset_launches()
        torch.cuda.synchronize()
        eng.t_submit = t0 = time.perf_counter()
        for i in range(n_req):
            eng.submit(requests[i], int(budgets[i]))
        finished = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        cont_launches = dict(_build.LAUNCHES)
        if kernel == "wkv6":
            wkv_ops.wkv6 = real_wkv6
            check(sum(shapes.values()) == scan_launches[kernel] + cont_launches[kernel],
                  f"{label} calls by shape {dict(shapes)} against its launches")
        steps = eng.state.step
        tokens = sum(len(f.tokens) for f in finished)
        ttft = np.asarray(sorted(eng.ttft.values())) * 1e3
        print(
            f"continuous: {n_req} requests through {slots} slots, budgets in "
            f"[{budgets.min()}, {budgets.max()}], cache_len {scfg.cache_len}: {tokens} tokens in "
            f"{wall:.3f} s = {tokens / wall:.1f} tok/s aggregate over {steps} decode steps; "
            f"TTFT ms p50 {np.percentile(ttft, 50):.2f} p95 {np.percentile(ttft, 95):.2f} "
            f"max {ttft.max():.2f} (first {ttft.min():.2f}); launches {cont_launches}; "
            f"shape signatures {eng.compile_counts()}"
        )
        # (a) again, counted apart: one launch per layer for every decode step
        # and, for K7, every admission's prefill; K5 none at admission
        want = per_step * steps + per_prefill * n_req
        if kernel is not None:
            check(cont_launches[kernel] == want, f"{label} {cont_launches} vs {steps} steps, {n_req} admissions")
        check(all(cont_launches[n] == 0 for n in others), f"another kernel ran: {cont_launches}")
        # (b) every request finishes once, with exactly its budget
        ids = sorted(f.seq_id for f in finished)
        check(ids == list(range(n_req)), f"finished ids {ids}")
        check(all(len(f.tokens) == budgets[f.seq_id] for f in finished), "a request missed its budget")
        check(len(ttft) == n_req, "not one TTFT per request")
        # (c) one shape signature per entry point
        check(eng.compile_counts() == {"decode_chunk": 1, "admit": 1}, f"{eng.compile_counts()}")

    # (f) the engine's tokens against a reference without the engine and
    # without the kernel: all requests prefilled together at the same depth,
    # the plain path, the engine's tokens teacher-forced.  Where the engine's
    # logits lie within d of the reference's, its greedy token t has
    # ref[t] >= max(ref) - 2d; d is check (e)'s bound, 0.05 * max|logits|.
    # A control feeds each request the previous request's prompt (what a
    # scatter into the wrong row would do) and must break the bound.  Held
    # in the ``strict`` dtype only: for rwkv6-7b the same requests go
    # through a second engine over the fp32 copy of the model (K7 on fp32
    # inputs); its bf16 engine is held by (a)-(c) and, through K7's logits,
    # by (e).  Not run for an arch of ``SERVE_SCAN_ONLY``: for an MoE arch a
    # batch-48 reference would be another function (its capacity drops
    # depend on a call's other tokens).
    def engine_vs_reference(c, prm, finished, what):
        out = np.zeros((n_req, gmax), np.int32)
        for f in finished:
            out[f.seq_id, : len(f.tokens)] = f.tokens
        out_d = torch.as_tensor(out, device=dev)
        valid = torch.as_tensor(np.arange(gmax)[None, :] < budgets[:, None], device=dev)

        def reference_gaps(prompts_np, ahead=0):
            """max(ref logits) - ref logit of the engine's token, (n, gmax),
            greedy agreement, and max|ref logits|; ``ahead`` advances every
            slot's position that many steps after the prefill."""
            caches = T.init_caches(c, n_req, scfg.cache_len, per_slot=True, device=dev)
            logits, caches = serve_launch.prefill(c, prm, torch.as_tensor(prompts_np, device=dev), caches)
            if ahead:
                caches = {part: tuple({**leaf, "pos": leaf["pos"] + ahead} for leaf in caches[part])
                          for part in ("unit", "rem")}
            gaps, hits, top = [], [], torch.zeros((), device=dev)
            for j in range(gmax):
                if j:
                    logits, caches = T.decode_step(c, prm, out_d[:, j - 1 : j], caches)
                lj = logits[:, 0].float()
                gaps.append(lj.max(-1).values - lj.gather(-1, out_d[:, j : j + 1].long())[:, 0])
                hits.append(lj.argmax(-1) == out_d[:, j])
                top = torch.maximum(top, lj.abs().max())
            return torch.stack(gaps, 1), torch.stack(hits, 1), float(top)

        gaps, hits, top = reference_gaps(requests)
        worst = float(gaps[valid].max())
        agree_c = float(hits[valid].float().mean())
        cgaps, _, ctop = reference_gaps(np.roll(requests, 1, axis=0))
        flagged = int(((cgaps > 0.1 * ctop) & valid).any(1).sum())
        print(
            f"continuous tokens ({what}) vs a batch-{n_req} reference without the engine or "
            f"{label} over {int(valid.sum())} tokens: worst gap {worst:.4g} (bound 0.1 * max|logits| = "
            f"{0.1 * top:.4g}), greedy agreement {agree_c:.4f}; control with shifted prompts breaks "
            f"the bound in {flagged} of {n_req} requests"
        )
        if c.pos_style == "sinusoidal":
            # sinusoidal positions of amplitude 1 added to token embeddings of
            # std 0.02 (the random init's) leave the logits hardly reading the
            # prompt, so a request given another's prompt is no control here;
            # a slot at the wrong depth is (every slot's position left half a
            # prompt too deep after its prefill), and it is the one held
            ahead = SERVE_PROMPT // 2
            pgaps, _, ptop = reference_gaps(requests, ahead=ahead)
            prompt_flagged = flagged
            flagged = int(((pgaps > 0.1 * ptop) & valid).any(1).sum())
            print(
                f"  control held for {c.pos_style} positions: every slot {ahead} positions too deep breaks the "
                f"bound in {flagged} of {n_req} requests (shifted prompts: {prompt_flagged}, not held)"
            )
        check(worst <= 0.1 * top, f"continuous tokens off the reference: gap {worst} > 0.1 * {top}")
        check(flagged >= n_req // 2, f"the control flagged only {flagged} requests")

    if continuous and strict == cfg.dtype:
        engine_vs_reference(cfg, params, finished, f"{cfg.dtype} engine")
    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    # check (e)'s fp32 copy, beside the bf16 model, for every arch but FP32_SKIPPED's
    bytes32 = 4 * T.param_count(params)
    card = torch.cuda.get_device_properties(dev).total_memory
    room = (f"check (e)'s fp32 copy of {arch}: {bytes32} bytes beside the {torch.cuda.memory_allocated(dev)} "
            f"allocated, with {SERVE_HEADROOM} kept free, against the card's {card}")
    fp32_leg = arch not in FP32_SKIPPED
    if fp32_leg:
        check(torch.cuda.memory_allocated(dev) + bytes32 + SERVE_HEADROOM <= card, room + ": it does not fit")
    else:
        print(room + ": its fp32 leg is skipped for this arch (FP32_SKIPPED)")
    params32 = _to_float(torch, params) if fp32_leg else None
    if continuous and strict == "float32":
        eng32 = ServeEngine(cfg32, scfg, params32, prompt_len=p, seed=0)
        for i in range(n_req):
            eng32.submit(requests[i], int(budgets[i]))
        finished32 = eng32.run()
        check(sorted((f.seq_id, len(f.tokens)) for f in finished32)
              == [(i, int(budgets[i])) for i in range(n_req)], "fp32 engine: a request missed its budget")
        engine_vs_reference(cfg32, params32, finished32, f"fp32 engine through {label}")
        del eng32, finished32

    # (d) greedy scan without the kernel equals the legacy loop bit for bit
    plain, _ = serve_launch.run_scan_mode(cfg, params, prompts, g, use_flash=False)
    legacy, _ = serve_launch.run_legacy(cfg, params, prompts, g)
    check(bool((plain == legacy).all()), "scan tokens != legacy tokens")
    print(f"parity OK: scan tokens without {label} bit-identical to the legacy loop ({b}x{g})")

    # (e) teacher-forced logits over the kernel's scan tokens: the kernel,
    # the plain path, and the plain path in an fp32 copy of the model
    def teacher(c, prm, use_flash):
        caches = T.init_caches(c, b, p + g, per_slot=True, device=dev)
        logits, caches = serve_launch.prefill(c, prm, prompts, caches, use_flash)
        out = [logits.float()]
        toks_d = torch.as_tensor(toks, device=dev)
        for i in range(g - 1):
            logits, caches = T.decode_step(c, prm, toks_d[:, i : i + 1], caches, use_flash=use_flash)
            out.append(logits.float())
        return torch.cat(out, dim=1)

    l_k5, k5_routes = moe_record(lambda: teacher(cfg, params, True))
    (l_plain, scan_drops), flips, choices = moe_pinned(
        lambda: moe_drops(lambda: teacher(cfg, params, False)), k5_routes)
    if moe:
        print(f"  MoE: the plain run took {label}'s expert choices ({flips} of {choices} token choices differ "
              f"from its own); " + drop_shares(f"pairs dropped (all layers), scan mode ({b} x {p} prefill)",
                                              scan_drops))
    scale = float(l_plain.abs().max())
    d = float((l_k5 - l_plain).abs().max())
    agree = float((l_k5.argmax(-1) == l_plain.argmax(-1)).float().mean())
    if fp32_leg:
        l_32, flips32, _ = moe_pinned(lambda: teacher(cfg32, params32, False), k5_routes)
        if moe:
            print(f"  MoE: the fp32 copy took {label}'s expert choices too ({flips32} of {choices} differ)")
        e_k5 = float((l_k5 - l_32).abs().max())
        e_plain = float((l_plain - l_32).abs().max())
        agree32 = float((l_k5.argmax(-1) == l_32.argmax(-1)).float().mean())
        vs32 = (f"vs the fp32 model: {label} {e_k5:.4g}, plain {e_plain:.4g}; greedy tokens "
                f"agree {label}/plain {agree:.4f}, {label}/fp32 {agree32:.4f}")
    else:
        l_32 = None
        vs32 = f"the fp32 model not run (above); greedy tokens agree {label}/plain {agree:.4f}"
    print(
        f"teacher-forced logits over {b}x{g} steps (max|logits| {scale:.4g}): |{label} - plain| "
        f"{d:.4g}; {vs32}"
    )
    check(bool(torch.isfinite(l_k5).all()), f"non-finite logits through {label}")
    # the bf16 bound: K5's plain path rounds scores and probabilities to
    # bf16 in every layer and K5 rounds its output once, so
    # the two bf16 paths part by a few percent of max|logits|; a wrong head
    # mapping, mask or length would part them by the logits' own size.  K7
    # and the plain scan both round y to bf16 once per layer from fp32 sums
    # taken in another order, which the chaotic rwkv6-7b amplifies (below).
    # The kernel must also stay (within a quarter) no further from the fp32
    # model than the plain bf16 path is.
    if fp32_leg:
        check(e_k5 <= 1.25 * e_plain, f"{label} {e_k5} further from fp32 than the plain path {e_plain}")
    if strict == cfg.dtype:
        check(d <= 0.05 * scale, f"{label} logits off the plain path by {d} > 0.05 * {scale}")
    else:
        from repro_torch.kernels.rwkv6_scan import ops as wkv_ops
        from repro_torch.models import rwkv6 as rwkv_mod

        real_ref, real_k7 = rwkv_mod.wkv6_scan_ref, wkv_ops.wkv6

        def patched(c, prm, use_flash, k7=real_k7, ref=real_ref):
            """The teacher-forced logits with K7's wrapper and the model's
            plain scan swapped for ``k7`` and ``ref``."""
            rwkv_mod.wkv6_scan_ref, wkv_ops.wkv6 = ref, k7
            try:
                return teacher(c, prm, use_flash)
            finally:
                rwkv_mod.wkv6_scan_ref, wkv_ops.wkv6 = real_ref, real_k7

        def reordered(r, k, v, w, u, s0):
            """The plain recurrence with its fp32 sums in another order:
            r^T S, plus the bonus taken as (r . (u * k)) v."""
            r, k, v, w = (a.float() for a in (r, k, v, w))
            s, ys = s0.float(), []
            for i in range(r.shape[1]):
                bonus = (r[:, i] * u.float() * k[:, i]).sum(-1, keepdim=True) * v[:, i]
                ys.append(torch.einsum("bhk,bhkv->bhv", r[:, i], s) + bonus)
                s = w[:, i, :, :, None] * s + k[:, i, :, :, None] * v[:, i, :, None, :]
            return torch.stack(ys, dim=1), s

        calls = [0]

        def one_ulp(r, k, v, w, u, s0):
            """The plain scan, with one element of the first call's y (layer
            0 at the prefill) moved by one bf16 step."""
            y, s_new = real_ref(r, k, v, w, u, s0)
            if calls[0] == 0:
                y = y.clone()
                bits = y[:1, :1, :1, :1].to(torch.bfloat16).view(torch.int16) + 1
                y[:1, :1, :1, :1] = bits.view(torch.bfloat16).float()
            calls[0] += 1
            return y, s_new

        def stateless(r, k, v, w, u, s0):
            """The control: K7 handing back s0 as its final state (a kernel
            whose state never advances)."""
            return real_k7(r, k, v, w, u, s0)[0], s0.clone()

        # two witnesses without K7 that the bf16 model is chaotic: the
        # plain bf16 path against itself with the scan's sums in another
        # order, and with one bf16 step added to one element of layer 0's y.
        # K7's bf16 logits must part from the plain path's no further than
        # the farther witness (within a quarter), or 5% of max|logits|
        # where the witnesses part by less; the control must break that
        w_order = float((patched(cfg, params, False, ref=reordered) - l_plain).abs().max())
        w_ulp = float((patched(cfg, params, False, ref=one_ulp) - l_plain).abs().max())
        d_ctrl16 = float((patched(cfg, params, True, k7=stateless) - l_plain).abs().max())
        bound16 = max(0.05 * scale, 1.25 * max(w_order, w_ulp))
        print(
            f"bf16 witnesses without {label} (max|logits| {scale:.4g}): the plain path against itself "
            f"with the scan's sums reordered {w_order:.4g}, with one bf16 step in layer 0's y "
            f"{w_ulp:.4g}; bound on |{label} - plain| {bound16:.4g}; control with the state never "
            f"advanced {d_ctrl16:.4g}"
        )
        check(d <= bound16, f"{label} logits off the plain path by {d} > {bound16}")
        check(d_ctrl16 > bound16, f"the bf16 state control stayed within the bound: {d_ctrl16}")

        # the issue's 5% bound on the fp32 copy: K7 on fp32 inputs against
        # the plain fp32 scan, which part only by the order of fp32 sums;
        # the same control must break it
        l_32k = teacher(cfg32, params32, True)
        d32 = float((l_32k - l_32).abs().max())
        d_ctrl = float((patched(cfg32, params32, True, k7=stateless) - l_32).abs().max())
        scale32 = float(l_32.abs().max())
        agree_32k = float((l_32k.argmax(-1) == l_32.argmax(-1)).float().mean())
        print(
            f"teacher-forced logits of the fp32 copy (max|logits| {scale32:.4g}): |{label} - plain| "
            f"{d32:.4g} (bound 0.05 * max = {0.05 * scale32:.4g}), greedy tokens agree {agree_32k:.4f}; "
            f"control with the state never advanced {d_ctrl:.4g}"
        )
        check(bool(torch.isfinite(l_32k).all()), f"non-finite fp32 logits through {label}")
        check(d32 <= 0.05 * scale32, f"fp32 {label} logits off the plain path by {d32} > 0.05 * {scale32}")
        check(d_ctrl > 0.05 * scale32, f"the state control stayed within the bound: {d_ctrl}")
        del l_32k
    del params32, l_k5, l_plain, l_32

    # where a decode step's time goes: three steps under torch.profiler,
    # after the counted runs (the device's busy share is its kernel time over
    # the scan run's unprofiled wall time per step)
    caches = T.init_caches(cfg, b, p + 4, per_slot=True, device=dev)
    logits, caches = serve_launch.prefill(cfg, params, prompts, caches)
    tok = logits[:, 0].argmax(-1, keepdim=True).to(torch.int32)
    box = [T.decode_step(cfg, params, tok, caches, use_flash=True)[1]]

    def decode():
        box[0] = T.decode_step(cfg, params, tok, box[0], use_flash=True)[1]

    _print_profile(torch, f"{arch} decode step at full width", decode, kernel or "gemm", n=3,
                   wall_ms=t["t_decode"] / (g - 1) * 1e3)
    if kernel == "flash_decode":
        # the dense MLP's activation rounded as JAX's (one launch per
        # operation) against PyTorch's fused op (one rounding), at the
        # decode step's shape; the call is host-bound, so events around
        # back-to-back calls time the host
        import torch.nn.functional as F

        gate = torch.randn(b, 1, cfg.d_ff, device=dev).to(L.torch_dtype(cfg.dtype))
        if cfg.mlp_variant == "swiglu":
            ours, fused = L.silu, F.silu
        else:
            ours, fused = L.gelu_tanh, (lambda v: F.gelu(v, approximate="tanh"))
        t_ours, t_fused = time_ms(torch, lambda: ours(gate)), time_ms(torch, lambda: fused(gate))
        print(
            f"{arch} {cfg.mlp_variant} activation at ({b}, 1, {cfg.d_ff}): rounded as JAX's "
            f"{t_ours * 1e3:.2f} us a call, the fused op {t_fused * 1e3:.2f} us; "
            f"{cfg.num_layers} calls a decode step"
        )
    if moe:
        moe_mod._route, moe_mod.apply_moe = real_route, real_moe
    seconds = time.perf_counter() - t_phase
    print(f"serving phase of {arch}: {seconds:.1f} s")
    if kernel is None:
        return 0, dict(shapes), seconds
    return scan_launches[kernel] + cont_launches[kernel], dict(shapes), seconds


def check_k3(torch, f, what: str):
    """K3 on ``f`` against its plain version with the JAX sweep's bounds,
    its sign and diagonal, and an fp64 chain, from which it may be no
    further than the plain version; returns (err, tol, e64, p64)."""
    from repro_torch.kernels.pairwise_l2 import ops as pw_ops
    from repro_torch.kernels.pairwise_l2 import ref as pw_ref

    got = pw_ops.pairwise_sq_dists(f)
    torch.cuda.synchronize()
    want = pw_ref.pairwise_sq_dists_ref(f)
    fd = f.double()
    sq = torch.sum(fd * fd, dim=-1)
    exact = torch.clamp_min(sq[:, None] + sq[None, :] - 2.0 * (fd @ fd.T), 0.0)
    exact.fill_diagonal_(0.0)
    err = float((got - want).abs().max())
    # the JAX sweep's bounds: 1e-3 (fp32) or 5e-2 (bf16) of max(1, max)
    tol = (5e-2 if f.dtype == torch.bfloat16 else 1e-3) * max(1.0, float(want.max()))
    check(err <= tol, f"K3 off on {what}: {err} > {tol}")
    check(bool((got >= 0).all()) and bool((torch.diagonal(got) == 0).all()), f"K3 sign/diagonal on {what}")
    e64, p64 = float((got.double() - exact).abs().max()), float((want.double() - exact).abs().max())
    check(e64 <= p64, f"K3 {e64} further from fp64 than the plain version {p64} on {what}")
    return err, tol, e64, p64


def k3_k4_rows(torch, dev) -> dict:
    """K3 and K4 against their plain versions at ``K3_SHAPES`` and
    ``K4_SHAPES``, with the JAX tests' tolerances, K3 also against an fp64
    chain; returns each kernel's rows (errors, times, bounds) by shape."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.gram import ops as gram_ops
    from repro_torch.kernels.gram import ref as gram_ref
    from repro_torch.kernels.pairwise_l2 import ops as pw_ops
    from repro_torch.kernels.pairwise_l2 import ref as pw_ref

    dtypes = {"fp32": torch.float32, "bf16": torch.bfloat16}
    rows = {"pairwise_sq_dists": {}, "gram": {}}
    for c, q, kind in K3_SHAPES:
        g = torch.Generator().manual_seed(c * 7919 + q)
        f = torch.randn(c, q, generator=g).to(dtypes[kind]).to(dev)
        err, tol, e64, p64 = check_k3(torch, f, f"{c}x{q} {kind}")
        plan = check_pairwise_call(torch, lambda: pw_ops.pairwise_sq_dists(f), c, q, f"K3 {c}x{q} {kind}")
        hot = device_ms(torch, lambda: pw_ops.pairwise_sq_dists(f), "pairwise")
        dev_ms = device_ms(torch, lambda: pw_ops.pairwise_sq_dists(f), "pairwise", cold=True)
        plain = time_ms(torch, lambda: pw_ref.pairwise_sq_dists_ref(f))
        # torch.cdist's bf16 support varies by version: timed on fp32 only,
        # interleaved with the wrapper (both are host-bound at small C)
        if kind == "fp32":
            ms, lib = time_pair(torch, lambda: pw_ops.pairwise_sq_dists(f), lambda: torch.cdist(f, f).square())
        else:
            ms, lib = time_ms(torch, lambda: pw_ops.pairwise_sq_dists(f)), None
        # least work as K1's: one triangle of dot products plus the c norms
        b = bound(c * q * f.element_size() + c * c * 4, 1.0 * c * (c - 1) * q + 2.0 * c * q, "fp32")
        rows["pairwise_sq_dists"][(c, q, kind)] = dict(
            max_abs_err=err, ms=ms, device_ms=dev_ms, device_ms_hot=hot, plain_ms=plain,
            library_ms=lib, bound_ms=b[0], bound_by=b[1], plan=plan,
        )
        print(
            f"K3 C={c} Q={q} {kind}: {plan}; err={err:.3e} (tol {tol:.3e}) vs fp64 {e64:.3e} "
            f"(plain {p64:.3e}) ms={ms:.5f} device_ms cold={fmt_ms(dev_ms)} hot={fmt_ms(hot)} "
            f"plain={plain:.5f} cdist^2={'n/a' if lib is None else f'{lib:.5f}'} "
            f"bound={b[0]:.6f} ({b[1]}){share(b[0], dev_ms, f'K3 {c}x{q} {kind}')}"
        )
    for m, n, kind in K4_SHAPES:
        g = torch.Generator().manual_seed(m * 7919 + n)
        x = torch.randn(m, n, generator=g).to(dtypes[kind]).to(dev)
        got = gram_ops.gram(x)
        torch.cuda.synchronize()
        want = gram_ref.gram_ref(x)
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        if kind == "bf16" and m <= 130:
            atol, rtol = 2e-2 * scale, 2e-2  # the JAX test's bf16 bound
        elif m <= 130:
            atol, rtol = 1e-5, 1e-5  # the JAX test's fp32 bound
        else:
            # sums of 4096 terms in another order: the error grows with the
            # sum, so the absolute part scales with max|G| (about m); bf16
            # too, since the plain version sums the same exact products
            atol, rtol = 1e-5 * scale, 1e-5

        def within(g):
            return bool(torch.all((g - want).abs() <= atol + rtol * want.abs()))

        check(within(got), f"K4 off at {m}x{n} {kind}: {err}")
        if n > 128:
            # control: the SYRK with one stage of rows dropped (32 fp32, 64
            # bf16) must break the bound
            stage = 64 if kind == "bf16" else 32
            check(not within(got - gram_ref.gram_ref(x[:stage])), f"K4 bound at {m}x{n} {kind} misses a dropped stage")
        check(torch.equal(got, got.T), f"K4 not exactly symmetric at {m}x{n} {kind}")
        if kind == "fp32":
            # the wrapper and x.T @ x interleaved: at the path's shape both
            # are host-bound, and the host's speed drifts
            ms, lib = time_pair(torch, lambda: gram_ops.gram(x), lambda: x.T @ x)
        else:  # x.T @ x of bf16 gives bf16, another function
            ms, lib = time_ms(torch, lambda: gram_ops.gram(x)), None
        # n > 128 with several row slices: the SYRK, then the slices' sum
        kernels = 2 if _build.library("gram").gram_workspace(m, n, int(kind == "bf16")) else 1
        dev_ms = device_ms(torch, lambda: gram_ops.gram(x), "gram", per_call=kernels)
        plain = time_ms(torch, lambda: gram_ref.gram_ref(x))
        # least work: one triangle of the symmetric product (a SYRK), n(n+1)m
        # FLOPs: bf16 products at the tensor cores' bf16 rate; fp32 at the
        # smaller of those FLOPs on the CUDA cores and 3xTF32's three
        # products each at the TF32 rate
        nbytes, flops = m * n * x.element_size() + n * n * 4, 1.0 * n * (n + 1) * m
        if kind == "bf16":
            b, peak = bound(nbytes, flops, "bf16"), "bf16 tensor cores"
        else:
            b = min(bound(nbytes, flops, "fp32"), bound(nbytes, 3 * flops, "tf32"))
            peak = "CUDA-core fp32" if b == bound(nbytes, flops, "fp32") else "3xTF32"
        if b[1] == "bytes":
            peak = "3.35 TB/s"
        rows["gram"][(m, n, kind)] = dict(
            max_abs_err=err, ms=ms, device_ms=dev_ms, plain_ms=plain, library_ms=lib,
            bound_ms=b[0], bound_by=b[1],
        )
        print(
            f"K4 M={m} N={n} {kind}: err={err:.3e} (max|G|={scale:.4g}) ms={ms:.5f} "
            f"device_ms={fmt_ms(dev_ms)} ({kernels} kernel{'s' if kernels > 1 else ''}) plain={plain:.5f} "
            f"x.T@x={'n/a' if lib is None else f'{lib:.5f}'} bound={b[0]:.6f} ({b[1]}, {peak})"
        )
    return rows


def k1_k2_rows(torch, f, s0, lo, rng, compute, kind: str, k2_cold: bool = False):
    """Times of K1 on profiles ``f`` (C, Q) and of K2 on the plain
    version's distances ``s0`` with ``lo`` and ``rng``: each wrapper as a
    path calls it, its plain version, and one PyTorch call computing the
    same function (``cdist``; ``mm`` of S), K1's device time cold and hot,
    K2's hot or, with ``k2_cold``, cold; and each one's bound.  Returns the
    two rows without their errors."""
    from repro_torch.kernels.gram import ops as gram_ops
    from repro_torch.kernels.gram import ref as gram_ref
    from repro_torch.kernels.pairwise_l2 import ops as pw_ops
    from repro_torch.kernels.pairwise_l2 import ref as pw_ref

    c, q = f.shape
    k1_ms, k1_lib = time_pair(torch, lambda: pw_ops.pairwise_dists_stats(f), lambda: torch.cdist(f, f))
    k1_hot = device_ms(torch, lambda: pw_ops.pairwise_dists_stats(f), "pairwise")
    k1_dev = device_ms(torch, lambda: pw_ops.pairwise_dists_stats(f), "pairwise", cold=True)
    k1_plain = time_ms(torch, lambda: pw_ref.pairwise_dists_stats_ref(f))
    k2 = lambda: gram_ops.normalized_gram(s0, lo, rng, c, compute)  # noqa: E731
    k2_ms = time_ms(torch, k2)
    k2_dev = device_ms(torch, k2, "gram", cold=k2_cold)
    k2_plain = time_ms(torch, lambda: gram_ref.normalized_gram_ref(s0, lo, rng, c, compute))
    s = (1.0 - (s0 - lo) / rng).to(compute)
    k2_lib = time_ms(torch, lambda: torch.mm(s.T, s))
    # least work: both outputs are symmetric, so K1 needs one triangle of
    # dot products (c(c-1)/2 of q FMAs, in fp32 whatever F's type) plus
    # the c norms, and K2 one triangle of S^T S (a SYRK, c(c+1)/2 dots
    # of c FMAs) plus three operations to normalise each S0 element
    tiles = math.ceil(c / 64)
    b1 = bound(
        c * q * f.element_size() + c * c * 4 + 2 * tiles * tiles * 4,
        1.0 * c * (c - 1) * q + 2.0 * c * q, "fp32",
    )
    b2 = bound(c * c * 4 + 8 + c * c * 4, 1.0 * c * c * (c + 1) + 3.0 * c * c, kind)
    return (
        dict(ms=k1_ms, device_ms=k1_dev, device_ms_hot=k1_hot, plain_ms=k1_plain,
             library_ms=k1_lib, bound_ms=b1[0], bound_by=b1[1]),
        dict(ms=k2_ms, device_ms=k2_dev, plain_ms=k2_plain, library_ms=k2_lib,
             bound_ms=b2[0], bound_by=b2[1]),
    )


def stage_wise_phase(torch, dev, trainer, exp, params) -> dict:
    """The stage-wise eq.-14 route, ``gram(similarity_matrix(P,
    use_kernel=True))`` (K3, the plain sqrt and min-max, then K4), on the
    trainer's FC-1 profiles and on the Fig.-3 gradient and representative
    profiles of ``params``; each L held against the K1 + K2 kernel of the
    same profiles and against an fp64 chain.  Returns the launches of the
    route, counted from 0."""
    from repro_torch.core import profiles, similarity
    from repro_torch.kernels import _build
    from repro_torch.kernels.gram import ops as gram_ops
    from repro_torch.models import cnn

    c = exp.num_clients
    t0 = time.perf_counter()
    xs, ys = trainer.client_xs, trainer.client_ys
    grad = torch.stack([
        profiles.gradient_profile(cnn.cnn_loss, params, xs[i], ys[i], layout=cnn.params_to_jax)
        for i in range(c)
    ])
    rep = torch.stack([
        profiles.representative_gradient_profile(cnn.cnn_loss, params, xs[i], ys[i], layout=cnn.params_to_jax)
        for i in range(c)
    ])
    torch.cuda.synchronize()
    print(f"Fig.-3 profiles of {c} clients: gradient {tuple(grad.shape)}, representative "
          f"{tuple(rep.shape)} in {time.perf_counter() - t0:.2f} s")
    check(tuple(grad.shape) == (c, 4096) and tuple(rep.shape) == (c, 10 * exp.fc1_dim), "Fig.-3 profile shapes")
    check(bool(torch.isfinite(grad).all()) and bool(torch.isfinite(rep).all()), "non-finite gradient profiles")

    cases = [("FC-1", trainer.round_state.profiles, trainer.round_state.kernel),
             ("gradient", grad, None), ("representative", rep, None)]
    _build.reset_launches()
    torch.cuda.synchronize()
    for name, prof, fused in cases:
        before = _build.LAUNCHES["pairwise_sq_dists"]
        stage = gram_ops.gram(similarity.similarity_matrix(prof, use_kernel=True))
        check(_build.LAUNCHES["pairwise_sq_dists"] == before + 1, f"K3 not once on {name}")
        if fused is None:
            fused = similarity.kernel_from_profiles(prof, use_kernel=True)
        torch.cuda.synchronize()
        plain = similarity.kernel_from_profiles(prof)
        exact = similarity.kernel_from_profiles(prof.double())
        lmax = float(fused.abs().max())
        d = float((stage - fused).abs().max())
        e_stage = float((stage.double() - exact).abs().max())
        e_fused = float((fused.double() - exact).abs().max())
        e_plain = float((plain.double() - exact).abs().max())
        print(
            f"stage-wise L on {name} profiles {tuple(prof.shape)}: |K3+K4 - K1+K2| {d:.3e} "
            f"(max|L| {lmax:.4g}); vs fp64 chain: K3+K4 {e_stage:.3e}, K1+K2 {e_fused:.3e}, plain {e_plain:.3e}"
        )
        check(tuple(stage.shape) == (c, c) and bool(torch.isfinite(stage).all()), f"stage-wise L on {name}")
        check(d <= 1e-4 * lmax, f"stage-wise L off the K1 + K2 kernel on {name}: {d} > 1e-4 * {lmax}")
        check(e_stage <= e_plain, f"stage-wise L {e_stage} further from fp64 than the plain chain {e_plain} on {name}")
    launches = dict(_build.LAUNCHES)
    print(f"launches on the stage-wise path: {launches}")
    check(launches["pairwise_sq_dists"] == 3 and launches["gram"] == 3, f"K3/K4 launches {launches}")
    # K3 itself at the path's shapes (min-max normalisation would hide a
    # uniformly scaled D2 in L); these launches are not the path's
    for name, prof, _ in cases:
        err, tol, e64, p64 = check_k3(torch, prof, f"{name} profiles {tuple(prof.shape)}")
        print(f"K3 on {name} profiles {tuple(prof.shape)}: err={err:.3e} (tol {tol:.3e}) "
              f"vs fp64 {e64:.3e} (plain {p64:.3e})")
    return launches


def baselines_phase(torch, exp, client_xs, client_ys) -> None:
    """The paper's comparison of selection strategies: ``FLTrainer.run`` at
    the paper's scale for each of ``BASELINES``, ``ROUNDS`` rounds, on the
    card; checks every cohort (and what each baseline promises of it) and
    that every number is finite."""
    from repro_torch.configs import paper_cnn
    from repro_torch.core import selection
    from repro_torch.fl.trainer import FLTrainer
    from repro_torch.models import cnn

    cp = exp.clients_per_round
    c = exp.num_clients

    def recording(cls):
        class Recording(cls):
            """The strategy, keeping each draw's state, noise and cohort."""

            def noise(self, generator, state, k, avail=None):
                self.last_noise = super().noise(generator, state, k, avail)
                return self.last_noise

            def draw_fn(self, generator, state, k):
                # the strategy's own draw_fn; noise() above sees its noise
                self.last_noise = None
                sel = super().draw_fn(generator, state, k)
                self.draws.append((state, self.last_noise, sel))
                return sel

        return Recording

    gemds = {}
    for name in BASELINES:
        strategy = recording(type(selection.make_strategy(name)))()
        strategy.draws = []
        params = cnn.init_cnn(
            torch.Generator(device="cuda").manual_seed(0),
            channels=exp.cnn_channels, fc1_dim=exp.fc1_dim,
        )
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer = FLTrainer(
            paper_cnn.fl_config(exp, seed=0), params, cnn.cnn_loss, cnn.apply_with_features,
            client_xs, client_ys, strategy, accuracy_fn=cnn.accuracy,
        )
        torch.cuda.synchronize()
        print(f"[{name}] init on {trainer.device}: {time.perf_counter() - t0:.3f} s")
        check(trainer.device.type == "cuda", f"{name}: the trainer did not run on the card")
        for _ in range(ROUNDS):
            t0 = time.perf_counter()
            hist = trainer.run(rounds=1)
            torch.cuda.synchronize()
            print(
                f"[{name}] round {hist['round'][-1]}: {time.perf_counter() - t0:.3f} s "
                f"cohort={strategy.draws[-1][2].tolist()} loss={hist['loss'][-1]:.4f} "
                f"acc={hist['acc'][-1]:.4f} gemd={hist['gemd'][-1]:.4f}"
            )
        check(len(strategy.draws) == ROUNDS and hist["round"] == list(range(1, ROUNDS + 1)), f"{name} rounds")
        for state, noise, sel in strategy.draws:
            cohort = sel.tolist()
            check(len(set(cohort)) == cp and all(0 <= i < c for i in cohort), f"{name}: bad cohort {cohort}")
            if name == "power-of-choice":
                # the top k losses of its candidates
                cand = noise.tolist()
                rest = [i for i in cand if i not in cohort]
                losses = state.losses
                check(set(cohort) <= set(cand), f"power-of-choice picked outside its candidates {cand}")
                check(float(losses[sel.long()].min()) >= float(losses[rest].max()), "power-of-choice: not the top k")
            if name == "cluster":
                labels = state.cluster_labels
                check(len(set(labels.tolist())) == cp, f"cluster labels {sorted(set(labels.tolist()))}")
                # one client per cluster (every cluster is non-empty)
                check(labels[sel.long()].tolist() == list(range(cp)), f"cluster cohort {cohort}")
        check(all(math.isfinite(v) for v in hist["loss"] + hist["gemd"]), f"{name}: {hist}")
        check(all(0.0 <= v <= 1.0 for v in hist["acc"]), f"{name}: accuracies {hist['acc']}")
        check(bool(torch.isfinite(trainer.losses).all()), f"{name}: non-finite client losses")
        if name == "cluster":
            check(tuple(trainer.round_state.grad_profiles.shape) == (c, 10 * exp.fc1_dim), "cluster fingerprints")
        gemds[name] = statistics.mean(hist["gemd"])
    print("mean GEMD over " + f"{ROUNDS} rounds: " + ", ".join(f"{n} {g:.4f}" for n, g in gemds.items()))


def _recording(cls, draws: list):
    """``cls`` keeping each draw's cohort in ``draws``: the legacy loop
    calls ``draw_fn`` itself, the engine through ``select_global_fn``."""

    class Recording(cls):
        def draw_fn(self, generator, state, k, avail=None):
            sel = super().draw_fn(generator, state, k) if avail is None else super().draw_fn(generator, state, k, avail)
            draws.append(sel.tolist())
            return sel

    return Recording


class _Spy:
    """Wraps ``module.name`` while the ``with`` block runs, appending each
    call's ``(args, kwargs, result)`` to ``calls`` and, given ``sync`` (a
    device synchronise), its seconds from one ``sync`` to another to
    ``seconds``."""

    def __init__(self, module, name: str, sync=None):
        self.module, self.name, self.sync, self.calls, self.seconds = module, name, sync, [], []

    def __enter__(self):
        self.orig = orig = getattr(self.module, self.name)

        def wrapped(*a, **kw):
            if self.sync is not None:
                self.sync()
            t0 = time.perf_counter()
            out = orig(*a, **kw)
            if self.sync is not None:
                self.sync()
                self.seconds.append(time.perf_counter() - t0)
            self.calls.append((a, kw, out))
            return out

        setattr(self.module, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def engine_phase(torch, exp, client_xs, client_ys, ds) -> dict:
    """The federation engine's selection features on the card.

    (a) FL-DP³S at the paper's scale through ``FLTrainer.run`` (the engine)
    and ``run_legacy``, ``ENGINE_ROUNDS`` rounds each, evaluated every round
    and re-profiled every 2: the same cohorts, accuracies within one sample.
    (b) ``run_many`` over ``BASELINES`` (one grid state each, dispatched by
    ``strategy_index``): each grid point's cohorts are its own
    ``run_scanned``'s.  (c) The funnel at ``FUNNEL_C`` clients (the phase-3
    images cut to ``FUNNEL_N_C`` each), Q = ``FUNNEL_C · FUNNEL_FRAC``,
    scenario flaky, ``FUNNEL_ROUNDS`` rounds re-profiled every 3: K1 and K2
    launched once at init and once at the boundary on the (Q, 128) block,
    the (Q, Q) kernel against the plain chain, every cohort among its
    candidates and available; then, without the funnel (whose prefilter
    reads latency, so a latency scenario moves its candidates), a
    heavy_tail run's cohorts against a run without a scenario.  cuDNN is
    deterministic for the phase, so that two loops doing the same work give
    the same bits.  Returns the funnel's K1 and K2 rows, and K1's and K2's
    launches at the unfunnelled inits at C = ``FUNNEL_C``."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import paper_cnn
    from repro_torch.core import profiles, selection
    from repro_torch.data import skewness_partition
    from repro_torch.fl import engine
    from repro_torch.fl.trainer import FLTrainer
    from repro_torch.kernels import _build
    from repro_torch.kernels.gram import ops as gram_ops
    from repro_torch.kernels.gram import ref as gram_ref
    from repro_torch.kernels.pairwise_l2 import ops as pw_ops
    from repro_torch.kernels.pairwise_l2 import ref as pw_ref
    from repro_torch.models import cnn

    cudnn = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    cp = exp.clients_per_round

    def fresh_params():
        return cnn.init_cnn(torch.Generator(device="cuda").manual_seed(0),
                            channels=exp.cnn_channels, fc1_dim=exp.fc1_dim)

    # ------------------------------------ (a) the engine against legacy
    cfg = dataclasses.replace(paper_cnn.fl_config(exp, seed=0), eval_every=1, reprofile_every=2)
    runs = {}
    for loop in ("engine", "legacy"):
        draws = []
        strategy = _recording(selection.DPPSelection, draws)()
        _build.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer = FLTrainer(cfg, fresh_params(), cnn.cnn_loss, cnn.apply_with_features,
                            client_xs, client_ys, strategy, accuracy_fn=cnn.accuracy)
        torch.cuda.synchronize()
        t_init = time.perf_counter() - t0
        t0 = time.perf_counter()
        hist = (trainer.run if loop == "engine" else trainer.run_legacy)(rounds=ENGINE_ROUNDS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {n: _build.LAUNCHES[n] for n in FL_KERNELS}
        print(f"engine (a) {loop}: init {t_init:.3f} s, {ENGINE_ROUNDS} rounds in {wall:.3f} s "
              f"(re-profiled at 2 and 4), launches {launches}, acc {[round(a, 4) for a in hist['acc']]}")
        check(launches == {n: 3 for n in FL_KERNELS}, f"(a) {loop}: K1/K2 not once at init and each reprofile")
        check(hist["round"] == list(range(1, ENGINE_ROUNDS + 1)), f"(a) {loop} rounds {hist['round']}")
        runs[loop] = (draws, hist)
    (d_eng, h_eng), (d_leg, h_leg) = runs["engine"], runs["legacy"]
    check(len(d_eng) == ENGINE_ROUNDS and d_eng == d_leg, f"(a) cohorts differ: {d_eng} vs {d_leg}")
    acc_diff = max(abs(a - b) for a, b in zip(h_eng["acc"], h_leg["acc"]))
    n_samples = client_xs.shape[0] * client_xs.shape[1]
    check(acc_diff <= 1.0 / n_samples, f"(a) accuracies {h_eng['acc']} vs {h_leg['acc']}")
    check(all(0.0 <= a <= 1.0 for a in h_eng["acc"]), f"(a) accuracies {h_eng['acc']}")
    print(f"engine (a): cohorts identical over {ENGINE_ROUNDS} rounds; max |acc engine - legacy| "
          f"{acc_diff:.3e} (tolerance one sample of {n_samples}, {1.0 / n_samples:.3e})")

    # ------------------------------------------------ (b) run_many grid
    params = fresh_params()
    xs = torch.as_tensor(client_xs, device="cuda")
    ys = torch.as_tensor(client_ys, device="cuda")
    prof = profiles.profile_all_clients(cnn.apply_with_features, params, list(xs))
    with torch.no_grad():
        losses = torch.stack([cnn.cnn_loss(params, x, y) for x, y in zip(xs, ys)])
    grid_cfg = dataclasses.replace(paper_cnn.fl_config(exp, seed=0), eval_every=ROUNDS)
    strategies = tuple(selection.make_strategy(n) for n in BASELINES)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    states = [engine.init_server_state(grid_cfg, params, xs, ys, prof, losses, s, loss_fn=cnn.cnn_loss,
                                       strategy_index=i) for i, s in enumerate(strategies)]
    torch.cuda.synchronize()
    print(f"engine (b): {len(states)} grid states in {time.perf_counter() - t0:.3f} s")
    fn = engine.make_round_fn(grid_cfg, cnn.cnn_loss, strategies, accuracy_fn=cnn.accuracy)
    forks = [st.fork() for st in states]
    t0 = time.perf_counter()
    _, outs = engine.run_many(fn, engine.stack_states(states), ROUNDS)
    torch.cuda.synchronize()
    print(f"engine (b): run_many over {len(states)} x {ROUNDS} rounds in {time.perf_counter() - t0:.3f} s")
    check(tuple(outs["selected"].shape) == (len(BASELINES), ROUNDS, cp), f"run_many outputs {outs['selected'].shape}")
    for i, name in enumerate(BASELINES):
        _, alone = engine.run_scanned(fn, forks[i], ROUNDS)
        check(torch.equal(alone["selected"], outs["selected"][i]), f"(b) {name}: run_many cohorts off its own run")
        for sel in outs["selected"][i].tolist():
            check(len(set(sel)) == cp and all(0 <= j < exp.num_clients for j in sel), f"(b) {name} cohort {sel}")
        if name == "cluster":
            labels = states[i].cluster_labels
            check(len(set(labels.tolist())) == cp, "(b) cluster labels")
            for sel in outs["selected"][i]:
                check(sorted(labels[sel.long()].tolist()) == list(range(cp)), "(b) cluster: one per cluster")
    summary = engine.unstack_outputs(outs)
    print("engine (b) run_many, per strategy: " + ", ".join(
        f"{n} mean GEMD {float(np.mean(r['gemd'])):.4f} last acc {float(r['acc'][-1]):.4f}"
        for n, r in zip(BASELINES, summary)))
    check(all(np.isfinite(r["gemd"]).all() and 0.0 <= float(r["acc"][-1]) <= 1.0 for r in summary),
          "(b) GEMD or accuracy off")

    # --------------------------------------------- (c) the funnel at C=4096
    shards = skewness_partition(ds.ys, FUNNEL_C, 0.8, ds.num_classes, samples_per_client=FUNNEL_N_C, seed=0)
    fxs = np.stack([ds.xs[sh] for sh in shards])
    fys = np.stack([ds.ys[sh] for sh in shards])
    fcfg = dataclasses.replace(
        paper_cnn.fl_config(exp, seed=0), num_clients=FUNNEL_C, eval_every=3, reprofile_every=3,
        candidate_frac=FUNNEL_FRAC, scenario="flaky",
    )
    q = fcfg.candidate_count()
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    trainer = FLTrainer(fcfg, fresh_params(), cnn.cnn_loss, cnn.apply_with_features, fxs, fys,
                        selection.DPPSelection(), accuracy_fn=cnn.accuracy)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    with _Spy(engine, "funnel_fields") as funnels, _Spy(engine, "run_scanned") as segments:
        t0 = time.perf_counter()
        hist = trainer.run(rounds=FUNNEL_ROUNDS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    print(f"engine (c) funnel: C={FUNNEL_C} clients x {FUNNEL_N_C} images, Q={q}, k={cp}, scenario flaky: "
          f"trainer init {t_init:.3f} s, {FUNNEL_ROUNDS} rounds in {wall:.3f} s, launches {launches}")
    check(launches["pairwise_dists_stats"] == 2 and launches["normalized_gram"] == 2,
          f"(c) K1/K2 not exactly twice (init and the boundary): {launches}")
    check(len(funnels.calls) == 2 and len(segments.calls) == 2, "(c) not two funnels and two segments")
    seg_rounds = 0
    for (_, _, (cand, kern, _)), (_, _, (_, out)) in zip(funnels.calls, segments.calls):
        check(tuple(cand.shape) == (q,) and tuple(kern.shape) == (q, q), f"(c) funnel shapes {kern.shape}")
        parts = (out["t_select"] + out["t_local"] + out["t_refresh"]).tolist()
        for i, (sel, avail) in enumerate(zip(out["selected"], out["avail"])):
            t = seg_rounds + i + 1
            sel_l = sel.long()
            in_cand = torch.isin(sel_l, cand.long().cpu())
            n_avail = int(avail[cand.long().cpu()].sum())
            check(bool(in_cand.all()), f"(c) round {t}: a pick outside the candidates")
            check(n_avail < cp or bool(avail[sel_l].all()), f"(c) round {t}: an unavailable pick")
            print(f"engine (c) round {t}: {parts[i]:.3f} s (selection {float(out['t_select'][i]):.3f}, "
                  f"local {float(out['t_local'][i]):.3f}, refresh+eval {float(out['t_refresh'][i]):.3f}); "
                  f"{n_avail} of {q} candidates available, sim_time {float(out['sim_time'][i]):.3f}, "
                  f"cohort {sel.tolist()}")
        seg_rounds += out["round"].shape[0]
    check(hist["round"] == [3, 6] and all(0.0 <= a <= 1.0 for a in hist["acc"]), f"(c) history {hist}")
    # the last funnel's kernel against the plain chain on its block
    fargs, _, (cand, kern, _) = funnels.calls[-1]
    fq = fargs[2][cand.long()]  # funnel_fields(cfg, generator, profiles, losses, ...)
    want = gram_ref.kernel_from_profiles_ref(fq)
    kerr, lmax = float((kern - want).abs().max()), float(want.abs().max())
    check(kerr <= 1e-4 * lmax, f"(c) funnel kernel off: {kerr} > 1e-4 * {lmax}")
    print(f"engine (c) funnel kernel {tuple(kern.shape)} vs plain chain: max abs err {kerr:.3e} (max|L| {lmax:.4g})")

    # K1 and K2 at the funnel's shape, on the last block, against their plain versions
    s0, lo, hi = pw_ops.pairwise_dists_stats(fq)
    ws0, wlo, whi = pw_ref.pairwise_dists_stats_ref(fq)
    err1 = float((s0 - ws0).abs().max())
    check(bool(torch.all((s0 - ws0).abs() <= 1e-5 * ws0.abs() + 1e-5 * float(whi))), f"(c) K1 off: {err1}")
    rng = torch.clamp_min(whi - wlo, 1e-30)
    lk = gram_ops.normalized_gram(ws0, wlo, rng, q, torch.float32)
    wl = gram_ref.normalized_gram_ref(ws0, wlo, rng, q, torch.float32)
    err2 = float((lk - wl).abs().max())
    check(err2 <= 1e-5 + 1e-4 * float(wl.abs().max()), f"(c) K2 off: {err2}")
    r1, r2 = k1_k2_rows(torch, fq, ws0, wlo, rng, torch.float32, "fp32", k2_cold=True)
    r1.update(max_abs_err=err1, launches=launches["pairwise_dists_stats"], shape=(q, fq.shape[1]))
    r2.update(max_abs_err=err2, launches=launches["normalized_gram"], shape=(q,))
    for label, r in (("K1", r1), ("K2", r2)):
        print(f"{label} funnel {r['shape']}: launches {r['launches']}, err {r['max_abs_err']:.3e}, ms {r['ms']:.5f}, "
              f"device_ms cold {fmt_ms(r['device_ms'])}, bound {r['bound_ms']:.7f} ({r['bound_by']})"
              f"{share(r['bound_ms'], r['device_ms'], f'{label} funnel')}, plain {r['plain_ms']:.5f}, "
              f"{'cdist' if label == 'K1' else 'mm'} {r['library_ms']:.5f}")

    # a latency-only scenario moves no cohort (without the funnel); each
    # init builds the C x C kernel through K1 and K2 at (FUNNEL_C, 128)
    cohorts = {}
    before = dict(_build.LAUNCHES)
    for scen in (None, "heavy_tail"):
        scfg = dataclasses.replace(fcfg, candidate_frac=None, scenario=scen, reprofile_every=None)
        st = engine.init_server_state(scfg, trainer.params, trainer.client_xs, trainer.client_ys,
                                      trainer.round_state.profiles, trainer.losses, selection.DPPSelection())
        sfn = engine.make_round_fn(scfg, cnn.cnn_loss, (selection.DPPSelection(),))
        t0 = time.perf_counter()
        _, out = engine.run_scanned(sfn, st, SCENARIO_ROUNDS)
        torch.cuda.synchronize()
        cohorts[scen] = out["selected"]
        print(f"engine (c) C={FUNNEL_C} without the funnel, scenario {scen}: {SCENARIO_ROUNDS} rounds in "
              f"{time.perf_counter() - t0:.3f} s, cohorts {out['selected'].tolist()}"
              + (f", sim_time {out['sim_time'].tolist()}" if scen else ""))
    check(torch.equal(cohorts[None], cohorts["heavy_tail"]), "(c) heavy_tail moved the cohorts")
    unfunnelled = {n: _build.LAUNCHES[n] - before[n] for n in FL_KERNELS}
    check(unfunnelled == {n: 2 for n in FL_KERNELS}, f"(c) K1/K2 not once at each unfunnelled init: {unfunnelled}")
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = cudnn
    return {"pairwise_dists_stats": r1, "normalized_gram": r2}, unfunnelled


def _state_tensors(state) -> dict:
    """Every tensor a ServerState holds, by a dotted name, on the CPU, and
    each generator's state: what a bit-for-bit resume must reproduce."""
    import dataclasses

    import torch

    out = {}

    def walk(name, v):
        if isinstance(v, torch.Generator):
            out[name] = v.get_state()
        elif isinstance(v, torch.Tensor):
            out[name] = v.detach().cpu()
        elif isinstance(v, dict):
            for k, x in v.items():
                walk(f"{name}.{k}", x)
        elif isinstance(v, (list, tuple)):
            for i, x in enumerate(v):
                walk(f"{name}.{i}", x)
        elif dataclasses.is_dataclass(v):
            for f in dataclasses.fields(v):
                walk(f"{name}.{f.name}", getattr(v, f.name))
        elif v is not None:
            out[name] = torch.tensor(v)

    for f in dataclasses.fields(state):
        walk(f.name, getattr(state, f.name))
    return out


def _same(torch, a, b) -> bool:
    """Equal bit for bit, NaN where NaN (torch.equal fails NaN == NaN)."""
    return a.shape == b.shape and a.dtype == b.dtype and bool(
        torch.all((a == b) | (torch.isnan(a) & torch.isnan(b)) if a.is_floating_point() else a == b)
    )


def _dir_bytes(path) -> int:
    return sum(p.stat().st_size for p in Path(path).rglob("*") if p.is_file())


def robust_phase(torch, exp, client_xs, client_ys) -> None:
    """Robustness and checkpoints on the paper's CNN cell (FL-DP³S, K1 + K2
    at each init), phase 3e.

    (a) ``faults="corrupt"`` under each aggregator, ``ROBUST_ROUNDS`` rounds,
    beside a plain run of the same cell: per round the guard's outputs,
    loss, accuracy and seconds; both robust aggregators keep the params
    finite and flag every cohort member whose delivered update was NaN or
    garbage (read from the wrapped fault draw, and from the quarantine
    counters, which a flag restarts at ``quarantine_rounds``).  (b)
    ``faults="lemons"`` with ``trimmed_mean``, ``LEMON_ROUNDS`` rounds: no
    client selected while its counter is above 0.  (c) FedProx (mu 0.01) and
    FedDyn (alpha 0.01), plain and under ``chaos`` with ``trimmed_mean``:
    finite params, FedDyn's ``h`` moving each round on exactly the cohort
    members whose update was kept (delivered, unflagged, no identity round:
    every member without faults) and nonzero at the end for exactly the
    clients ever kept, and FedProx at mu 0 the plain run bit for bit.  (d)
    Crash-resume under ``chaos`` with ``trimmed_mean`` and FedDyn:
    ``run_checkpointed`` of ``RESUME_ROUNDS`` rounds every 2 against 4
    rounds, a restore of ``step_00000004`` into a fresh
    ``init_server_state`` and the rest: every state tensor, generator state
    and round output bit for bit.  (e) The LM launcher at full width with
    faults, ``trimmed_mean`` and a snapshot every round, relaunched for one
    more round: it resumes at round 2.  cuDNN is deterministic for the
    phase, as in 3d."""
    import contextlib
    import dataclasses
    import io
    import tempfile

    from repro_torch.configs import paper_cnn
    from repro_torch.core import profiles, selection
    from repro_torch.fl import engine, faults
    from repro_torch.kernels import _build
    from repro_torch.launch import train as train_launch
    from repro_torch.models import cnn
    from repro_torch.tree import tree_leaves

    cudnn = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    cp = exp.clients_per_round
    params = cnn.init_cnn(torch.Generator(device="cuda").manual_seed(0), channels=exp.cnn_channels,
                          fc1_dim=exp.fc1_dim)
    xs = torch.as_tensor(client_xs, device="cuda")
    ys = torch.as_tensor(client_ys, device="cuda")
    prof = profiles.profile_all_clients(cnn.apply_with_features, params, list(xs))
    with torch.no_grad():
        losses0 = torch.stack([cnn.cnn_loss(params, x, y) for x, y in zip(xs, ys)])
    base = dataclasses.replace(paper_cnn.fl_config(exp, seed=0), eval_every=1)
    finite = lambda p: all(bool(torch.isfinite(v).all()) for v in tree_leaves(p))  # noqa: E731

    def init(cfg):
        """A fresh state of ``cfg`` (K1 + K2 and the eigh) -> (state, K1/K2 launches)."""
        _build.reset_launches()
        st = engine.init_server_state(cfg, params, xs, ys, prof, losses0, selection.DPPSelection(),
                                      loss_fn=cnn.cnn_loss)
        torch.cuda.synchronize()
        return st, {n: _build.LAUNCHES[n] for n in FL_KERNELS}

    def rounds_of(cfg, state, n, label, watch=None):
        """``n`` rounds one at a time -> (final state, per-round outputs,
        per-round seconds); ``watch(state_before, out, state_after)`` checks each."""
        fn = engine.make_round_fn(cfg, cnn.cnn_loss, (selection.DPPSelection(),), accuracy_fn=cnn.accuracy)
        outs, secs = [], []
        for _ in range(n):
            before = state
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, out = fn(state)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            outs.append(out)
            if watch is not None:
                watch(before, out, state)
            guard = "" if "survivors" not in out else (
                f"survivors {int(out['survivors'])}, flagged {int(out['flagged'])}, quarantined "
                f"{int(out['quarantined'])}, identity_round {int(out['identity_round'])}, ")
            print(f"robust {label} round {out['round']}: {guard}loss {float(out['loss']):.4f}, acc "
                  f"{float(out['acc']):.4f}, {secs[-1]:.4f} s (selection {out['t_select']:.4f}, local "
                  f"{out['t_local']:.4f}, refresh+eval {out['t_refresh']:.4f})")
        return state, outs, secs

    def steady(secs):
        return statistics.mean(secs[1:])

    # ------------------------------------------ (a) each aggregator, corrupt
    plain_state, launches = init(base)
    plain_final, plain_outs, plain_secs = rounds_of(base, plain_state.fork(), ROBUST_ROUNDS, "plain")
    for agg in ("mean", "clipped_mean", "trimmed_mean"):
        cfg = dataclasses.replace(base, faults="corrupt", aggregator=agg)
        state, launches = init(cfg)
        check(launches == {n: 1 for n in FL_KERNELS}, f"(a) {agg}: K1/K2 not once at the guarded init: {launches}")
        n_bad = []

        def watch(before, out, after, agg=agg, n_bad=n_bad, cfg=cfg):
            d = draws.calls[-1][2]
            sel = out["selected"].long().to(d.delivered.device)
            bad = d.delivered[sel] & (d.nan[sel] | d.garbage[sel])
            flagged = after.quarantine[sel] == cfg.quarantine_rounds
            n_bad.append(int(bad.sum()))
            check(int(flagged.sum()) == int(out["flagged"]), f"(a) {agg}: flags and counters disagree")
            if agg != "mean":
                check(bool((flagged | ~bad).all()), f"(a) {agg} round {out['round']}: a corrupt update not flagged")

        with _Spy(faults, "draw_round_faults") as draws:
            final, outs, secs = rounds_of(cfg, state, ROBUST_ROUNDS, agg, watch)
        ok = finite(final.params)
        if agg != "mean":
            check(ok, f"(a) {agg}: non-finite params")
        print(f"robust (a) {agg}: {sum(n_bad)} delivered NaN/garbage cohort members over {ROBUST_ROUNDS} rounds, "
              f"{sum(int(o['flagged']) for o in outs)} flagged; params finite: {ok}"
              f"{' (mean: poisoned)' if not ok else ''}; rounds 2-{ROBUST_ROUNDS} mean {steady(secs):.4f} s "
              f"(selection {statistics.mean(o['t_select'] for o in outs[1:]):.4f}) against the plain run's "
              f"{steady(plain_secs):.4f} s (selection {statistics.mean(o['t_select'] for o in plain_outs[1:]):.4f})")

    # ------------------------------------------- (b) lemons, trimmed_mean
    cfg = dataclasses.replace(base, faults="lemons", aggregator="trimmed_mean")
    state, _ = init(cfg)
    lemons = torch.nonzero(faults.lemon_mask(faults.get_fault_model("lemons"), exp.num_clients)).ravel().tolist()
    picked = []

    def watch_q(before, out, after):
        sel = out["selected"].long().cpu()
        q = before.quarantine.cpu()
        check(bool((q[sel] <= 0).all()), f"(b) round {out['round']}: a quarantined client selected: "
              f"{[(int(i), int(q[i])) for i in sel if q[i] > 0]}")
        picked.extend(int(i) for i in sel if int(i) in lemons)

    final, outs, _ = rounds_of(cfg, state, LEMON_ROUNDS, "lemons", watch_q)
    print(f"robust (b) lemons {lemons}: selected {len(picked)} times ({sorted(set(picked))}), no client selected "
          f"while quarantined; params finite: {finite(final.params)}")
    check(finite(final.params), "(b) non-finite params")

    # --------------------------------------------- (c) FedProx and FedDyn
    def h_rows(st):
        return torch.cat([v.flatten(1) for v in tree_leaves(st.algo_state)], 1)

    for name, kw in (("fedprox", dict(prox_mu=0.01)), ("feddyn", dict(feddyn_alpha=0.01)),
                     ("feddyn", dict(feddyn_alpha=0.01, faults="chaos", aggregator="trimmed_mean")),
                     ("fedprox", dict(prox_mu=0.0))):
        cfg = dataclasses.replace(base, local_algo=name, **kw)
        state, _ = init(cfg)
        kept_all, dropped = set(), {"undelivered": 0, "flagged": 0, "identity": 0}

        def watch_h(before, out, after, cfg=cfg, kept_all=kept_all, dropped=dropped):
            """FedDyn's h advances exactly on the cohort members whose update
            was kept: delivered, unflagged, in a round above the floor."""
            sel = out["selected"].long()
            kept = torch.ones(sel.shape, dtype=torch.bool, device=sel.device)
            if cfg.guarded():
                d = draws.calls[-1][2]
                delivered = d.delivered[sel]
                flagged = after.quarantine[sel] == cfg.quarantine_rounds
                identity = bool(out["identity_round"])
                kept = torch.zeros_like(delivered) if identity else delivered & ~flagged
                dropped["undelivered"] += int((~delivered).sum())
                dropped["flagged"] += int(flagged.sum())
                dropped["identity"] += int(identity) * len(sel)
            changed = set(torch.nonzero(~(h_rows(before) == h_rows(after)).all(1)).ravel().tolist())
            want = set(sel[kept].tolist())
            check(changed == want, f"(c) {name} {kw} round {out['round']}: h moved for {sorted(changed)}, "
                  f"kept {sorted(want)}")
            kept_all |= want

        with _Spy(faults, "draw_round_faults") as draws:
            final, outs, secs = rounds_of(cfg, state, ROBUST_ROUNDS, f"{name} {kw}",
                                          watch_h if name == "feddyn" else None)
        check(finite(final.params), f"(c) {name}: non-finite params")
        msg = f"robust (c) {name} {kw}: rounds 2-{ROBUST_ROUNDS} mean {steady(secs):.4f} s"
        if name == "feddyn":
            nonzero = set(torch.nonzero(h_rows(final).abs().sum(1)).ravel().tolist())
            trained = set(int(i) for o in outs for i in o["selected"])
            check(nonzero == kept_all, f"(c) feddyn: h nonzero for {sorted(nonzero)}, kept {sorted(kept_all)}")
            msg += (f"; h moved each round on exactly the kept cohort members, and is nonzero for exactly the "
                    f"{len(kept_all)} clients ever kept, of {len(trained)} selected (dropped selections: "
                    f"{dropped})")
        if kw.get("prox_mu") == 0.0:
            same = all(torch.equal(a, b) for a, b in zip(tree_leaves(final.params), tree_leaves(plain_final.params)))
            same &= all(torch.equal(torch.as_tensor(a[k]), torch.as_tensor(b[k])) for a, b in zip(outs, plain_outs)
                        for k in ("selected", "loss", "gemd", "acc"))
            check(same, "(c) fedprox at mu 0 differs from the plain run")
            msg += "; equal to the plain run bit for bit"
        print(msg)

    # ----------------------------------------------------------- (d) resume
    cfg = dataclasses.replace(base, faults="chaos", aggregator="trimmed_mean", local_algo="feddyn",
                              feddyn_alpha=0.01, eval_every=2)
    fn = engine.make_round_fn(cfg, cnn.cnn_loss, (selection.DPPSelection(),), accuracy_fn=cnn.accuracy)
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp, _Spy(engine, "save_server_state", torch.cuda.synchronize) as saves:
        a_dir, b_dir = f"{tmp}/a", f"{tmp}/b"
        state, _ = init(cfg)
        t0 = time.perf_counter()
        full, full_outs = engine.run_checkpointed(fn, state, RESUME_ROUNDS, ckpt_dir=a_dir, ckpt_every=2)
        torch.cuda.synchronize()
        t_full = time.perf_counter() - t0
        state, _ = init(cfg)
        part, part_outs = engine.run_checkpointed(fn, state, 4, ckpt_dir=b_dir, ckpt_every=2)
        fresh, _ = init(cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        restored = engine.restore_server_state(b_dir, fresh, step=4)
        torch.cuda.synchronize()
        t_restore = time.perf_counter() - t0
        resumed, tail_outs = engine.run_scanned(fn, restored, RESUME_ROUNDS - 4)
        torch.cuda.synchronize()
        snap = f"{a_dir}/step_00000004"
        size = _dir_bytes(snap)
        steps = sorted(p.name for p in Path(a_dir).iterdir())
    print(f"robust (d) chaos + trimmed_mean + feddyn: {RESUME_ROUNDS} rounds with a snapshot every 2 in "
          f"{t_full:.3f} s (snapshots {steps}); snapshot {size} bytes ({size / 2**20:.1f} MiB), save "
          f"{[round(x, 4) for x in saves.seconds]} s, restore {t_restore:.4f} s; survivors "
          f"{full_outs['survivors'].tolist()}, flagged {full_outs['flagged'].tolist()}, quarantined "
          f"{full_outs['quarantined'].tolist()}")
    check(steps == ["step_00000002", "step_00000004", "step_00000006"], f"(d) snapshots {steps}")
    want, got = _state_tensors(full), _state_tensors(resumed)
    off = [k for k in want if k not in got or not _same(torch, want[k], got[k])]
    check(set(want) == set(got), f"(d) state fields differ: {sorted(set(want) ^ set(got))}")
    check(not off, f"(d) resumed state differs from the uninterrupted run's in {off}")
    for k in full_outs:
        if not k.startswith("t_"):
            joined = torch.cat([part_outs[k], tail_outs[k]])
            check(_same(torch, full_outs[k], joined), f"(d) output {k} differs after the resume")
    print(f"robust (d): the resumed run equals the uninterrupted one bit for bit ({len(want)} state tensors "
          f"and generator states, {len(full_outs) - 3} outputs over {RESUME_ROUNDS} rounds)")

    # ----------------------------------------------- (e) the LM launcher
    with tempfile.TemporaryDirectory(dir=build) as tmp, _Spy(engine, "save_server_state", torch.cuda.synchronize) as saves:
        argv = ["--mode", "fl", "--arch", "smollm-360m", "--full-width", "--flash", "--seq", str(LM_SEQ),
                "--log-every", "1",
                "--clients", str(LM_CLIENTS), "--per-round", str(LM_PER_ROUND), "--docs-per-client", str(LM_DOCS),
                "--faults", "corrupt", "--aggregator", "trimmed_mean", "--ckpt-every", "1", "--ckpt", tmp]
        logs = []
        for n in (2, 3):
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                state, outs = train_launch.main(argv + ["--rounds", str(n)])
            torch.cuda.synchronize()
            logs.append((buf.getvalue(), time.perf_counter() - t0, outs))
            print(f"robust (e) python -m repro_torch.launch.train {' '.join(argv)} --rounds {n}: "
                  f"{logs[-1][1]:.3f} s")
            print("\n".join("  " + line for line in buf.getvalue().splitlines()))
        size = _dir_bytes(f"{tmp}/step_00000002")
        check(sorted(p.name for p in Path(tmp).iterdir()) == ["step_00000001", "step_00000002", "step_00000003"],
              "(e) snapshots")
    (first, _, outs1), (second, _, outs2) = logs
    check("resumed" not in first and outs1["round"].tolist() == [1, 2], "(e) the first launch")
    check(f"resumed round 2 from {tmp}/step_00000002" in second, "(e) no 'resumed round 2' line")
    check(outs2["round"].tolist() == [3], f"(e) the relaunch ran rounds {outs2['round'].tolist()}")
    check("faults=corrupt aggregator=trimmed_mean" in second and finite(state.params), "(e) the relaunch's run")
    print(f"robust (e): resumed at round 2 and ran round 3; snapshot {size} bytes ({size / 2**20:.1f} MiB), "
          f"saves {[round(x, 4) for x in saves.seconds]} s")
    del state
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = cudnn


def _print_profile(torch, what: str, fn, mark: str, n: int = 1, wall_ms=None) -> None:
    """Runs ``fn`` ``n`` times (after the caller's warm-up) under
    torch.profiler and prints per call: top-level aten ops, device kernels,
    wall time (``wall_ms`` where the caller measured it unprofiled), device
    kernel time and busy share, the share of kernels whose name holds
    ``mark``, and the top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - t0) / n * 1e3
    events = prof.events()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    ops = [e for e in events if e.device_type == DeviceType.CPU and e.cpu_parent is None
           and e.name.startswith("aten::")]
    wall = prof_wall if wall_ms is None else wall_ms
    print(f"{what}: {len(ops) / n:.0f} top-level aten ops and {len(kernels) / n:.0f} device "
          f"kernels per call; wall {wall:.3f} ms per call "
          f"({'under the profiler' if wall_ms is None else 'unprofiled'})")
    if not kernels:
        print("  device kernel time: not measured (the profiler recorded no device events)")
        return
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / n
    dev_ms = sum(by_name.values())
    mine = sum(ms for name, ms in by_name.items() if mark in name)
    print(f"  device kernel time {dev_ms:.3f} ms per call: busy share {dev_ms / wall:.4f}, "
          f"idle share {1 - dev_ms / wall:.4f}; {mark} {mine:.3f} ms ({mine / dev_ms:.4f})")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:5]:
        print(f"  {ms:.4f} ms  {name[:110]}")


def lm_phase(torch, dev) -> int:
    """The LM client path at full width through the launcher's ``main``;
    returns K6's launches on its FL run."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.core import similarity
    from repro_torch.fl import rounds
    from repro_torch.kernels import _build
    from repro_torch.kernels.gram import ref as gram_ref
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch import train as train_launch
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_leaves

    import tempfile

    from repro_torch.analysis import report
    from repro_torch.obs import load_events

    cfg = get_arch("smollm-360m").model
    common = ["--arch", "smollm-360m", "--full-width", "--seq", str(LM_SEQ), "--log-every", "1"]
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        telemetry = f"{tmp}/lm_fl.jsonl"
        fl_argv = ["--mode", "fl", "--flash", "--rounds", str(LM_ROUNDS), "--clients", str(LM_CLIENTS),
                   "--per-round", str(LM_PER_ROUND), "--docs-per-client", str(LM_DOCS),
                   "--telemetry", telemetry] + common
        print(f"LM FL: python -m repro_torch.launch.train {' '.join(fl_argv)}")
        _build.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, outs = train_launch.main(fl_argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        events = load_events(telemetry)
    launches = dict(_build.LAUNCHES)
    # (6c b) the run's telemetry: one fl_round a round, equal to its outputs
    rounds_ev = [e for e in events if e["event"] == "fl_round"]
    check([e["event"] for e in events] == ["manifest"] + ["fl_round"] * LM_ROUNDS,
          f"LM telemetry events {[e['event'] for e in events]}")
    check(events[0]["device_kind"] == torch.cuda.get_device_name(0) and events[0]["arch"] == "smollm-360m",
          f"LM manifest {events[0]}")
    for i, e in enumerate(rounds_ev):
        check(e["round"] == i + 1 and e["loss"] == float(outs["loss"][i]) and e["gemd"] == float(outs["gemd"][i])
              and e["selected"] == outs["selected"][i].tolist(), f"fl_round event {i} off the outputs: {e}")
    text = report.summarize(events)
    check(f"training: {LM_ROUNDS} rounds" in text, f"the report of the LM run: {text}")
    print(f"LM FL telemetry (6c b): {len(events)} events, each fl_round's loss, GEMD and cohort equal to the "
          f"run's outputs; cache_age {[e['cache_age'] for e in rounds_ev]}, spectrum_erank "
          f"{[round(e['spectrum_erank'], 4) for e in rounds_ev]}; the report renders 'training: {LM_ROUNDS} rounds'")
    layers, refreshes = cfg.num_layers, LM_ROUNDS * LM_PER_ROUND
    print(f"LM FL: {LM_ROUNDS} rounds in {wall:.3f} s with set-up (model, data, profiles, "
          f"K1 + K2, eigh); launches {launches}")
    for i in range(LM_ROUNDS):
        parts = [float(outs[n][i]) for n in ("t_select", "t_local", "t_refresh")]
        print(f"  round {int(outs['round'][i])}: {sum(parts):.4f} s = selection {parts[0]:.4f} "
              f"+ local updates {parts[1]:.4f} + refresh {parts[2]:.4f} "
              f"({LM_PER_ROUND} x {LM_DOCS} x {LM_SEQ} tokens through K6)")
    # (g) K6 took every layer of every refresh forward and nothing else: the
    # local updates take gradients, where the wrapper would raise
    check(launches["flash_attention"] == layers * refreshes,
          f"K6 launches {launches['flash_attention']} != {layers} x {refreshes} refresh forwards")
    check(launches["pairwise_dists_stats"] == 1 and launches["normalized_gram"] == 1,
          f"K1/K2 not once on the LM path: {launches}")
    check(launches["flash_decode"] == 0, "K5 ran on the LM path")
    sel = outs["selected"].numpy()
    check(sel.shape == (LM_ROUNDS, LM_PER_ROUND), f"cohorts {sel.shape}")
    check(all(len(set(r)) == LM_PER_ROUND and r.min() >= 0 and r.max() < LM_CLIENTS for r in sel),
          f"bad cohorts {sel.tolist()}")
    check(bool(np.isfinite(outs["loss"].numpy()).all()), f"round losses {outs['loss']}")
    check(bool(((outs["gemd"] >= 0) & (outs["gemd"] <= 2)).all()), f"GEMDs {outs['gemd']}")
    losses = state.losses
    check(bool(torch.isfinite(losses).all()), "non-finite client losses")
    refreshed = sorted(set(sel.ravel().tolist()))
    check(bool((losses[refreshed] != 1.0).all()), "a selected client's loss was not refreshed")
    check(all(bool(torch.isfinite(x).all()) for x in tree_leaves(state.params)), "non-finite params")
    # the eq.-14 kernel that K1 + K2 built on this path, against the plain
    # chain on the same profiles, elementwise at the main-path tolerance
    # (rtol 1e-5 / atol 1e-5) around an fp64 chain, plus the fp32 plain
    # chain's own distance from it: hidden-state means lie close together
    # relative to their norms, where the plain chain's |a|^2 + |b|^2 - 2ab
    # cancels and K1's direct sum of (a - b)^2 does not
    prof, kern = state.profiles, state.kernel
    check(tuple(prof.shape) == (LM_CLIENTS, cfg.d_model) and prof.dtype == torch.float32,
          f"LM profiles {tuple(prof.shape)} {prof.dtype}")
    want = gram_ref.kernel_from_profiles_ref(prof)
    exact = similarity.kernel_from_profiles(prof.double())
    slack = (want.double() - exact).abs()
    kerr, kerr64 = float((kern - want).abs().max()), float((kern.double() - exact).abs().max())
    print(f"LM eq.-14 kernel ({LM_CLIENTS} x {cfg.d_model} fp32 profiles): |K1+K2 - plain| "
          f"{kerr:.3e}; vs an fp64 chain: K1+K2 {kerr64:.3e}, plain {float(slack.max()):.3e}")
    check(bool(torch.all((kern.double() - exact).abs() <= 1e-5 + 1e-5 * exact.abs() + slack)),
          f"the LM path's eq.-14 kernel off the plain chain: {kerr}")

    # (h) the refresh through K6 against the same refresh without it, on the
    # final params: the last cohort's losses, and the final hidden states of
    # one client's batch.  A control routes K6 through a 64-position window
    # (a kernel that drops every key more than one tile back) and must
    # break the hidden-state bound.
    params = state.params
    last = outs["selected"][-1].long().to(dev)
    xs = state.client_xs[last]
    pos = torch.arange(LM_SEQ, dtype=torch.int32, device=dev)[None].expand(LM_DOCS, LM_SEQ)
    real = fa_ops.flash_attention

    def windowed(q, k, v, window=None):
        return real(q, k, v, window=CONTROL_WINDOW)

    with torch.no_grad():
        k6_l = torch.stack([T.lm_loss(cfg, params, x, use_flash=True) for x in xs])
        plain_l = torch.stack([T.lm_loss(cfg, params, x) for x in xs])
        h_k6 = T.forward(cfg, params, xs[0], pos, use_flash=True)[0].float()
        h_plain = T.forward(cfg, params, xs[0], pos)[0].float()
        fa_ops.flash_attention = windowed
        try:
            ctrl_l = torch.stack([T.lm_loss(cfg, params, x, use_flash=True) for x in xs])
            h_ctrl = T.forward(cfg, params, xs[0], pos, use_flash=True)[0].float()
        finally:
            fa_ops.flash_attention = real
        # the same batch through an fp32 copy of the model (plain attention)
        cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
        h_32 = T.forward(cfg32, _to_float(torch, params), xs[0], pos)[0]
    rel = lambda a, b: float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))
    e_k6, e_plain = rel(h_k6, h_32), rel(h_plain, h_32)
    d_path = float((k6_l - losses[last]).abs().max())
    d_loss = float((k6_l - plain_l).abs().max())
    d_ctrl_loss = float((ctrl_l - plain_l).abs().max())
    d_h, d_ctrl = rel(h_k6, h_plain), rel(h_ctrl, h_plain)
    print(
        f"refresh of cohort {sel[-1].tolist()} on the final params: losses through K6 "
        f"{[round(float(x), 6) for x in k6_l]}, without {[round(float(x), 6) for x in plain_l]}: "
        f"max |K6 - plain| {d_loss:.3e} (bound {LM_LOSS_BOUND:g}), |K6 - the path's refresh| "
        f"{d_path:.3e}; control {d_ctrl_loss:.3e}"
    )
    print(
        f"final hidden of {LM_DOCS} x {LM_SEQ} tokens: |K6 - plain| / |plain| = {d_h:.4e} "
        f"(bound {LM_HIDDEN_BOUND:g}); control with a {CONTROL_WINDOW}-position window: {d_ctrl:.4e}; "
        f"vs the fp32 model: K6 {e_k6:.4e}, plain {e_plain:.4e}"
    )
    check(d_path <= LM_LOSS_BOUND, f"the path's refresh {d_path} off a refresh through K6")
    check(d_loss <= LM_LOSS_BOUND, f"refresh losses through K6 off the plain path by {d_loss}")
    check(d_h <= LM_HIDDEN_BOUND, f"hidden through K6 off the plain path by {d_h} > {LM_HIDDEN_BOUND}")
    check(d_ctrl > LM_HIDDEN_BOUND, f"the control stayed within the bound: {d_ctrl}")
    # the plain path rounds scores and probabilities to bf16 in every layer
    # and K6 rounds once, so K6 must stay (within a quarter) no further from
    # the fp32 model than the plain bf16 attention is
    check(e_k6 <= 1.25 * e_plain, f"K6 {e_k6} further from fp32 than the plain path {e_plain}")

    # where a round's time goes, after the counted run: one refresh forward
    # and one local SGD step (forward, backward and update of 4 x 512 tokens)
    with torch.no_grad():
        _print_profile(torch, f"one refresh forward ({LM_DOCS} x {LM_SEQ} tokens)",
                       lambda: T.lm_loss(cfg, params, xs[0], use_flash=True), "flash_attention")
    spec = get_arch("smollm-360m")
    local = rounds.build_local_update(lambda p, b: T.lm_loss(cfg, p, b[0]), spec.fl.lr)
    steps_batch = (xs[0][None, :4], state.client_ys[last[0]][None, :4])
    local(params, steps_batch)
    _print_profile(torch, f"one local SGD step (4 x {LM_SEQ} tokens)",
                   lambda: local(params, steps_batch), "flash_attention")
    del state, params, outs

    # pretrain at full width: Adam, clip 1.0, batch 4 x 512
    pre_argv = ["--mode", "pretrain", "--steps", str(PRETRAIN_STEPS), "--local-batch", "4"] + common
    print(f"LM pretrain: python -m repro_torch.launch.train {' '.join(pre_argv)}")
    _build.reset_launches()
    pre_params, pre_state, hist = train_launch.main(pre_argv)
    pre_launches = dict(_build.LAUNCHES)
    check(all(n == 0 for n in pre_launches.values()), f"kernels ran in pretrain: {pre_launches}")
    check(all(math.isfinite(h["loss"]) for h in hist), f"pretrain losses {hist}")
    first, end = hist[0], hist[-1]
    steady = (end["step"] - first["step"]) * 4 * LM_SEQ / (end["seconds"] - first["seconds"])
    print(f"pretrain: {end['step']} steps, losses {[round(h['loss'], 4) for h in hist]}; "
          f"{steady:.1f} tok/s over steps {first['step'] + 1}-{end['step']} "
          f"(first step {first['seconds']:.3f} s)")
    # one more step of the same construction under the profiler
    opt = train_launch.pretrain_optimizer(cfg, spec.optimizer, 1e-3)
    step = rounds.build_fedsgd_step(lambda p, b: T.lm_loss(cfg, p, b["tokens"]), opt, grad_clip=1.0)
    batch = {"tokens": xs[:, :1].reshape(-1, LM_SEQ)[:4]}
    _print_profile(torch, f"one pretrain step (4 x {LM_SEQ} tokens, Adam)",
                   lambda: step(pre_params, pre_state, batch), "flash_attention")
    return launches["flash_attention"]


def _gib(n: float) -> str:
    return f"{n / 2**30:.2f} GiB"


def train_phase(torch, dev, arch: str) -> dict:
    """Phase 5b for one arch: ``--mode fl --flash`` and ``--mode pretrain``
    through the launcher's ``main`` at the depth of ``TRAIN_PATHS``, with
    the checks of phase 5 (g) and (h); returns the kernels' launches on the
    FL run, the phase's seconds and its profile width."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_arch, model_config
    from repro_torch.core import similarity
    from repro_torch.fl.local_algos import make_grad_fn
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.gram import ref as gram_ref
    from repro_torch.kernels.rwkv6_scan import ops as wkv_ops
    from repro_torch.launch import train as train_launch
    from repro_torch.models import rwkv6 as rwkv_mod
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_leaves, tree_unflatten

    t_phase = time.perf_counter()
    depth, kernel = TRAIN_PATHS[arch]
    common = ["--arch", arch, "--seq", str(TRAIN_SEQ), "--log-every", "1"] + depth
    fl_argv = ["--mode", "fl", "--flash", "--rounds", str(TRAIN_ROUNDS), "--clients", str(LM_CLIENTS),
               "--per-round", str(LM_PER_ROUND), "--docs-per-client", str(LM_DOCS)] + common
    print(f"[5b {arch}] python -m repro_torch.launch.train {' '.join(fl_argv)}")
    _build.reset_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, outs = train_launch.main(fl_argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak_fl = torch.cuda.max_memory_allocated(dev)
    launches = dict(_build.LAUNCHES)
    params = state.params
    spec = get_arch(arch)
    layers = int(depth[depth.index("--layers") + 1]) if "--layers" in depth else None
    cfg = model_config(arch, "--full-width" in depth, layers)
    n_params = T.param_count(params)
    largest = max(x.numel() for x in tree_leaves(params))
    esize = tree_leaves(params)[0].element_size()
    # a round's peak, reckoned: the (C_p, ...) stack, the global params, the
    # training client's params and gradients, and the eq.-6 average's fp32
    # (C_p, leaf) products of the largest leaf
    reckon = (LM_PER_ROUND + 3) * n_params * esize + 32 * largest
    mixers = [bt.split("+")[0] for bt in cfg.layer_types()]
    refreshes = TRAIN_ROUNDS * LM_PER_ROUND
    print(f"[5b {arch}] {cfg.num_layers} layers {cfg.block_pattern}, d_model {cfg.d_model}, {cfg.param_dtype}, "
          f"remat {cfg.remat}: {n_params:,} parameters, largest leaf {largest:,}; {TRAIN_ROUNDS} rounds in "
          f"{wall:.3f} s with set-up; max_memory_allocated {_gib(peak_fl)} against a reckoned "
          f"({LM_PER_ROUND} + 3) * P * {esize} + 32 * L = {_gib(reckon)}; launches {launches}")
    for i in range(TRAIN_ROUNDS):
        parts = [float(outs[n][i]) for n in ("t_select", "t_local", "t_refresh")]
        print(f"  round {int(outs['round'][i])}: {sum(parts):.4f} s = selection {parts[0]:.4f} "
              f"+ local updates {parts[1]:.4f} + refresh {parts[2]:.4f}")
    # (g) the kernels of the refresh: K6 in every window-free attention
    # layer, K7 in every RWKV layer, once per refresh forward (one per cohort
    # client and round), and nothing in a gradient pass (the wrappers raise
    # there); K1 and K2 once at the init; nothing else
    want = {"flash_attention": mixers.count("attn") * refreshes, "wkv6": mixers.count("rwkv") * refreshes,
            "pairwise_dists_stats": 1, "normalized_gram": 1}
    check(all(launches[n] == want.get(n, 0) for n in launches),
          f"{arch}: launches {launches}, want {want} and no other kernel")
    check((kernel is None) == (want["flash_attention"] + want["wkv6"] == 0), f"{arch}: TRAIN_PATHS' kernel")
    sel = outs["selected"].numpy()
    check(sel.shape == (TRAIN_ROUNDS, LM_PER_ROUND), f"{arch}: cohorts {sel.shape}")
    check(all(len(set(r)) == LM_PER_ROUND and r.min() >= 0 and r.max() < LM_CLIENTS for r in sel),
          f"{arch}: bad cohorts {sel.tolist()}")
    check(bool(np.isfinite(outs["loss"].numpy()).all()), f"{arch}: round losses {outs['loss']}")
    check(bool(((outs["gemd"] >= 0) & (outs["gemd"] <= 2)).all()), f"{arch}: GEMDs {outs['gemd']}")
    losses = state.losses
    check(bool(torch.isfinite(losses).all()), f"{arch}: non-finite client losses")
    check(bool((losses[sorted(set(sel.ravel().tolist()))] != 1.0).all()),
          f"{arch}: a selected client's loss was not refreshed")
    check(all(bool(torch.isfinite(x).all()) for x in tree_leaves(params)), f"{arch}: non-finite params")
    # the eq.-14 kernel of K1 + K2 against the plain chain, around an fp64
    # chain with the fp32 chain's own slack (phase 5)
    prof, kern = state.profiles, state.kernel
    check(tuple(prof.shape) == (LM_CLIENTS, cfg.d_model) and prof.dtype == torch.float32,
          f"{arch}: profiles {tuple(prof.shape)} {prof.dtype}")
    plain_k = gram_ref.kernel_from_profiles_ref(prof)
    exact = similarity.kernel_from_profiles(prof.double())
    slack = (plain_k.double() - exact).abs()
    kerr, kerr64 = float((kern - plain_k).abs().max()), float((kern.double() - exact).abs().max())
    print(f"  eq.-14 kernel ({LM_CLIENTS} x {cfg.d_model} profiles): |K1+K2 - plain| {kerr:.3e}; vs an fp64 "
          f"chain: K1+K2 {kerr64:.3e}, plain {float(slack.max()):.3e}")
    check(bool(torch.all((kern.double() - exact).abs() <= 1e-5 + 1e-5 * exact.abs() + slack)),
          f"{arch}: the eq.-14 kernel off the plain chain: {kerr}")

    # (h) the refresh through the kernel against the same refresh without
    # it, on the final params: the last cohort's losses, and the final
    # hidden states of one client's batch
    last = outs["selected"][-1].long().to(dev)
    xs = state.client_xs[last]
    pos = T.mrope_streams(cfg, torch.arange(TRAIN_SEQ, dtype=torch.int32, device=dev)[None].expand(LM_DOCS,
                                                                                                    TRAIN_SEQ))
    rel = lambda a, b: float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))

    @torch.no_grad()
    def hidden(c, prm, use_flash, positions=pos):
        return T.forward(c, prm, xs[0], positions, use_flash=use_flash)[0].float()

    @torch.no_grad()
    def refresh(c, prm, use_flash):
        """The cohort's losses and one client's final hidden states."""
        return torch.stack([T.lm_loss(c, prm, x, use_flash=use_flash) for x in xs]), hidden(c, prm, use_flash)

    real_fa, real_k7, real_ref = fa_ops.flash_attention, wkv_ops.wkv6, rwkv_mod.wkv6_scan_ref

    def patched(fn, fa=real_fa, k7=real_k7, ref=real_ref):
        """``fn()`` with K6's and K7's wrappers and the plain scan swapped."""
        fa_ops.flash_attention, wkv_ops.wkv6, rwkv_mod.wkv6_scan_ref = fa, k7, ref
        try:
            return fn()
        finally:
            fa_ops.flash_attention, wkv_ops.wkv6, rwkv_mod.wkv6_scan_ref = real_fa, real_k7, real_ref

    k_l, k_h = refresh(cfg, params, True)
    p_l, p_h = refresh(cfg, params, False)
    d_path = float((k_l - losses[last]).abs().max())
    d_loss, d_h = float((k_l - p_l).abs().max()), rel(k_h, p_h)
    check(bool(torch.isfinite(k_l).all() and torch.isfinite(k_h).all()), f"{arch}: non-finite refresh")
    check(d_path <= LM_LOSS_BOUND, f"{arch}: the path's refresh {d_path} off a refresh through the kernel")
    label = {"flash_attention": "K6", "wkv6": "K7", None: "use_flash"}[kernel]
    print(f"  refresh of cohort {sel[-1].tolist()} on the final params: losses through {label} "
          f"{[round(float(x), 6) for x in k_l]}: max |{label} - plain| {d_loss:.3e}, |{label} - the path's "
          f"refresh| {d_path:.3e}; final hidden of {LM_DOCS} x {TRAIN_SEQ} tokens |{label} - plain| / |plain| "
          f"{d_h:.4e}")
    bytes32 = 4 * n_params
    fits32 = cfg.dtype != "float32" and torch.cuda.memory_allocated(dev) + bytes32 + (8 << 30) <= \
        torch.cuda.get_device_properties(dev).total_memory
    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    if kernel is None:
        # no kernel on the path: --flash changes nothing but the launch
        # count (none), within the bounds of the runs' own nondeterminism
        check(d_loss <= LM_LOSS_BOUND and d_h <= LM_HIDDEN_BOUND,
              f"{arch}: the refresh with --flash parts from the plain one: {d_loss}, {d_h}")
    elif kernel == "flash_attention":
        # phase 5's bounds and controls: K6 through a 64-position window
        # (a kernel dropping every key more than a tile back), and for
        # musicgen, whose positions swamp its token embeddings at random
        # init, also the refresh read half a sequence too deep
        windowed = lambda q, k, v, window=None: real_fa(q, k, v, window=CONTROL_WINDOW)  # noqa: E731
        ctrl = {f"a {CONTROL_WINDOW}-position window": rel(patched(lambda: hidden(cfg, params, True),
                                                                   fa=windowed), p_h)}
        if cfg.pos_style == "sinusoidal":
            ctrl["positions half a sequence deep"] = rel(hidden(cfg, params, True, pos + TRAIN_SEQ // 2), p_h)
        print("  controls, hidden |control - plain| / |plain|: "
              + "; ".join(f"{n} {v:.4e}" for n, v in ctrl.items()))
        check(d_loss <= LM_LOSS_BOUND, f"{arch}: refresh losses through K6 off the plain path by {d_loss}")
        check(d_h <= LM_HIDDEN_BOUND, f"{arch}: hidden through K6 off the plain path by {d_h}")
        check(all(v > LM_HIDDEN_BOUND for v in ctrl.values()), f"{arch}: a control stayed in the bound: {ctrl}")
        if fits32:
            with torch.no_grad():
                h32 = T.forward(cfg32, _to_float(torch, params), xs[0], pos)[0]
            e_k, e_p = rel(k_h, h32), rel(p_h, h32)
            print(f"  vs the fp32 model: K6 {e_k:.4e}, plain {e_p:.4e}")
            check(e_k <= 1.25 * e_p, f"{arch}: K6 {e_k} further from fp32 than the plain path {e_p}")
            del h32
    else:
        # K7 as phase 6 holds it: three witnesses without K7 show how far
        # correct bf16 paths part from the plain one in this chaotic
        # random-init model: the plain scan with its sums reordered, with
        # one bf16 step added to one element of layer 0's y in every
        # forward, and K7's own arithmetic taken in torch (``k7_arith``:
        # chunks of 16, running decay products, each product as 3xTF32, as
        # csrc/wkv6.cu takes them and tests/test_torch_rwkv.py holds to
        # fp64).  K7's losses and hidden states may part from the plain
        # path's by at most a quarter over the farthest witness; and, as
        # phases 5 and 6 hold their kernels, its bf16 refresh may be no
        # further from the fp32 model than the plain bf16 path (within a
        # quarter).  The control (K7 dropping the bonus u, the current
        # token's own term) must break both.  A refresh keeps no state, so
        # phase 6's control (the state never advanced) would change nothing
        # here.  On the fp32 copy K7 and the plain scan part only by the
        # order of fp32 sums, and are held to phase 5's bounds with the
        # same control.
        def reordered(r, k, v, w, u, s0):
            r, k, v, w = (a.float() for a in (r, k, v, w))
            st, ys = s0.float(), []
            for i in range(r.shape[1]):
                bonus = (r[:, i] * u.float() * k[:, i]).sum(-1, keepdim=True) * v[:, i]
                ys.append(torch.einsum("bhk,bhkv->bhv", r[:, i], st) + bonus)
                st = w[:, i, :, :, None] * st + k[:, i, :, :, None] * v[:, i, :, None, :]
            return torch.stack(ys, dim=1), st

        calls = [0]
        rwkv_layers = mixers.count("rwkv")

        def one_ulp(r, k, v, w, u, s0):
            y, s_new = real_ref(r, k, v, w, u, s0)
            if calls[0] % rwkv_layers == 0:  # layer 0 of each forward
                y = y.clone()
                bits = y[:1, :1, :1, :1].to(torch.bfloat16).view(torch.int16) + 1
                y[:1, :1, :1, :1] = bits.view(torch.bfloat16).float()
            calls[0] += 1
            return y, s_new

        def no_bonus(r, k, v, w, u, s0):
            return real_k7(r, k, v, w, torch.zeros_like(u), s0)

        wit = {}
        for name, ref in (("sums reordered", reordered), ("one bf16 step in layer 0", one_ulp),
                          ("K7's arithmetic in torch", lambda *a: k7_arith(torch, *a))):
            calls[0] = 0
            w_l, w_h = patched(lambda: refresh(cfg, params, False), ref=ref)
            wit[name] = (float((w_l - p_l).abs().max()), rel(w_h, p_h))
        bound_l, bound_h = (1.25 * max(v[i] for v in wit.values()) for i in (0, 1))
        c_h = patched(lambda: hidden(cfg, params, True), k7=no_bonus)
        d_ch = rel(c_h, p_h)
        print("  bf16 witnesses without K7, |witness - plain|: " + "; ".join(
            f"{n}: losses {v[0]:.3e}, hidden {v[1]:.4e}" for n, v in wit.items())
            + f"; |K7 - plain|: losses {d_loss:.3e} (bound {bound_l:.3e}), hidden {d_h:.4e} (bound "
              f"{bound_h:.4e}); control with the bonus u dropped: hidden {d_ch:.4e}")
        check(d_loss <= bound_l and d_h <= bound_h,
              f"{arch}: K7's bf16 refresh off the plain one past its witnesses: {d_loss}, {d_h}")
        check(d_ch > bound_h, f"{arch}: the bonus control stayed within the witnesses' bound: {d_ch}")
        check(fits32, f"{arch}: the fp32 copy does not fit")
        params32 = _to_float(torch, params)
        k32_l, k32_h = refresh(cfg32, params32, True)
        p32_l, p32_h = refresh(cfg32, params32, False)
        dist = lambda a, b: float((a - b).abs().max())  # noqa: E731
        e_l, e_pl, e_h, e_ph = dist(k_l, p32_l), dist(p_l, p32_l), rel(k_h, p32_h), rel(p_h, p32_h)
        e_ch = rel(c_h, p32_h)
        print(f"  bf16 vs the fp32 model: losses K7 {e_l:.3e}, plain {e_pl:.3e}; hidden K7 {e_h:.4e}, plain "
              f"{e_ph:.4e}, control with the bonus u dropped {e_ch:.4e}")
        check(e_l <= 1.25 * e_pl and e_h <= 1.25 * e_ph,
              f"{arch}: K7's bf16 refresh further from fp32 than the plain one: {e_l}, {e_h}")
        check(e_ch > 1.25 * e_ph, f"{arch}: the bonus control stayed within the bound")
        dc32 = rel(patched(lambda: hidden(cfg32, params32, True), k7=no_bonus), p32_h)
        d32_l, d32_h = dist(k32_l, p32_l), rel(k32_h, p32_h)
        print(f"  fp32 copy: |K7 - plain| losses {d32_l:.3e}, hidden {d32_h:.4e} (bounds {LM_LOSS_BOUND:g}, "
              f"{LM_HIDDEN_BOUND:g}); control {dc32:.4e}")
        check(d32_l <= LM_LOSS_BOUND and d32_h <= LM_HIDDEN_BOUND, f"{arch}: fp32 K7 off: {d32_l}, {d32_h}")
        check(dc32 > LM_HIDDEN_BOUND, f"{arch}: the fp32 bonus control stayed within the bound")
        del params32
    if kernel is not None and not fits32:
        print(f"  the fp32 leg: {'the model is fp32 already' if cfg.dtype == 'float32' else 'does not fit'}")
    check(kernel is None or cfg.dtype == "float32" or fits32, f"{arch}: the fp32 copy does not fit")

    # remat: the activations one local step's forward keeps for its
    # backward pass, with and without it; then where a step's time goes
    batch = (xs[0][:4], None)
    held = {}
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        live = [x.detach().requires_grad_(True) for x in tree_leaves(params)]
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        loss = T.lm_loss(c, tree_unflatten(params, live), batch[0])
        held[remat] = torch.cuda.memory_allocated(dev) - base
        del loss, live
    print(f"  one local step (4 x {TRAIN_SEQ} tokens): activations kept for the backward pass, remat off "
          f"{_gib(held[False])}, on {_gib(held[True])}")
    grad_fn = make_grad_fn(lambda p, b: T.lm_loss(cfg, p, b[0]))
    _print_profile(torch, f"[5b {arch}] one local step's gradient (4 x {TRAIN_SEQ} tokens)",
                   lambda: grad_fn(params, batch), "gemm")
    del state, outs, params, xs, k_h, p_h
    gc.collect()
    torch.cuda.empty_cache()

    # pretrain: the arch's optimizer as JAX steps it, clip 1.0
    pre_argv = ["--mode", "pretrain", "--steps", str(TRAIN_PRETRAIN_STEPS), "--local-batch", "4"] + common
    print(f"[5b {arch}] python -m repro_torch.launch.train {' '.join(pre_argv)}")
    _build.reset_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    _, _, hist = train_launch.main(pre_argv)
    peak_pre = torch.cuda.max_memory_allocated(dev)
    pre_launches = dict(_build.LAUNCHES)
    check(all(n == 0 for n in pre_launches.values()), f"{arch}: kernels ran in pretrain: {pre_launches}")
    check(all(math.isfinite(h["loss"]) for h in hist), f"{arch}: pretrain losses {hist}")
    first, end = hist[0], hist[-1]
    steady = (end["step"] - first["step"]) * 4 * TRAIN_SEQ / (end["seconds"] - first["seconds"])
    print(f"  pretrain ({spec.optimizer}): losses {[round(h['loss'], 4) for h in hist]}; {steady:.1f} tok/s over "
          f"steps {first['step'] + 1}-{end['step']} (first step {first['seconds']:.3f} s); max_memory_allocated "
          f"{_gib(peak_pre)}")
    gc.collect()
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    print(f"[5b {arch}] {seconds:.1f} s")
    return {"launches": launches, "seconds": seconds, "d_model": cfg.d_model}


def _trace_of(path) -> dict:
    """The one Chrome trace under ``path``: its host spans and device
    kernels by name, its size in bytes."""
    import collections
    import glob

    files = glob.glob(f"{path}/*.pt.trace.json")
    check(len(files) == 1, f"traces under {path}: {files}")
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    return {
        "spans": collections.Counter(e["name"] for e in events if e.get("cat") == "user_annotation"),
        "kernels": collections.Counter(e["name"] for e in events if e.get("cat") == "kernel"),
        "bytes": Path(files[0]).stat().st_size,
        "events": len(events),
    }


def _device_line(what: str, trace: dict, launched: dict) -> str:
    """The traced device kernels of ``OBS_DEVICE_KERNELS`` beside the launch
    counters' counts of the same run (the profiler has dropped device
    events on this card before; the counters show that a kernel ran)."""
    if not trace["kernels"]:
        return (f"{what}: the profiler recorded no device event; the launch counters show "
                + ", ".join(f"{k} {n}" for k, n in launched.items()))
    counts = {k: sum(n for name, n in trace["kernels"].items() if mark in name)
              for k, mark in OBS_DEVICE_KERNELS.items() if k in launched}
    return (f"{what}: {sum(trace['kernels'].values())} device kernel events of {len(trace['kernels'])} names; "
            + ", ".join(f"{k} {counts[k]} traced / {launched[k]} launched" for k in launched))


def obs_phase(torch, dev, exp, client_xs, client_ys) -> None:
    """Observability on the card, phase 6c.

    (a) FL-DP³S at the paper's cell through ``FLTrainer.run``, ``OBS_ROUNDS``
    rounds re-profiled every ``OBS_EVERY`` under ``chaos`` with
    ``trimmed_mean``, from trainers built alike, with telemetry and a sink
    and without, in turns (``OBS_TURNS``): each segment's outputs (but the
    host timings), the final state (every tensor and generator state), the
    history and the trainer's generators equal bit for bit; the events are
    one manifest (naming this card), a ``fl_round`` a round and one
    ``fl_reprofile``; ``cache_age`` restarts at the boundary, at most k
    survivors, ``spectrum_erank`` in [1, C].  cuDNN deterministic, as in
    3d and 3e.  (c) smollm-360m at full width with K5 through
    ``ServeEngine`` (``OBS_REQUESTS`` requests, budgets in ``OBS_BUDGETS``,
    chunks of ``OBS_CHUNK``) with a sink and without, in turns: the same tokens bit
    for bit, one shape signature per entry point, a submission, admission
    and finish per request with its budget's tokens, K5 once per layer and
    decode step in both runs.  (d) ``--profile-dir``: the serve launcher
    at full width (``--continuous --flash``, small traffic) and a 2-round
    CNN ``FLTrainer.run`` of ``OBS_TRACE_C`` clients under
    ``tracing.trace``, its init included: each Chrome trace parses and
    holds the engines' host spans; the device kernels it recorded are
    printed beside the launch counters.  (b) is in phase 5."""
    import dataclasses
    import tempfile

    import numpy as np

    from repro_torch.configs import paper_cnn
    from repro_torch.core import selection
    from repro_torch.fl import engine
    from repro_torch.fl.trainer import FLTrainer
    from repro_torch.kernels import _build
    from repro_torch.launch import serve as serve_launch
    from repro_torch.models import cnn
    from repro_torch.obs import TelemetrySink, load_events, tracing
    from repro_torch.serve import ServeConfig, ServeEngine

    t_phase = time.perf_counter()
    card = torch.cuda.get_device_name(0)
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    same_hist = lambda a, b: all(  # noqa: E731
        len(a[k]) == len(b[k]) and all(x == y or (math.isnan(x) and math.isnan(y)) for x, y in zip(a[k], b[k]))
        for k in a)

    # ------------------------------------------ (a) the CNN, on and off
    # in turns, off, on, on, off: a run's first call pays warm-up the
    # others do not, and the host's speed drifts within a call
    cudnn = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    runs = []
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        for i, telemetry in enumerate(OBS_TURNS):
            cfg = dataclasses.replace(paper_cnn.fl_config(exp, seed=0), reprofile_every=OBS_EVERY, faults="chaos",
                                      aggregator="trimmed_mean", telemetry=telemetry)
            params = cnn.init_cnn(torch.Generator(device=dev).manual_seed(0), channels=exp.cnn_channels,
                                  fc1_dim=exp.fc1_dim)
            trainer = FLTrainer(cfg, params, cnn.cnn_loss, cnn.apply_with_features, client_xs, client_ys,
                                selection.DPPSelection(), accuracy_fn=cnn.accuracy)
            with contextlib.ExitStack() as stack:
                sink = None
                if telemetry:
                    sink = stack.enter_context(TelemetrySink(f"{tmp}/cnn{i}.jsonl"))
                    sink.write_manifest(config=cfg, extra={"mode": "fl", "arch": "paper-cnn"})
                spy = stack.enter_context(_Spy(engine, "run_scanned"))
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                hist = trainer.run(rounds=OBS_ROUNDS, sink=sink)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            runs.append((telemetry, trainer, hist, [c[2] for c in spy.calls], wall,
                         load_events(f"{tmp}/cnn{i}.jsonl") if telemetry else None))
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = cudnn
    _, t_ref, h_ref, seg_ref, _, _ = runs[0]
    want = _state_tensors(seg_ref[-1][0])
    for telemetry, trainer, hist, segs, _, events in runs[1:]:
        check(len(segs) == len(seg_ref) == OBS_ROUNDS // OBS_EVERY, f"(6c a) segments {len(segs)}")
        for (_, o_ref), (_, o) in zip(seg_ref, segs):
            check(set(o) == set(o_ref) | ({"telemetry"} if telemetry else set()), f"(6c a) outputs {sorted(o)}")
            for k in o_ref:
                if not k.startswith("t_"):
                    check(_same(torch, o_ref[k], o[k]), f"(6c a) output {k} differs (telemetry={telemetry})")
        got = _state_tensors(segs[-1][0])
        off = [k for k in want if k not in got or not _same(torch, want[k], got[k])]
        check(set(want) == set(got) and not off, f"(6c a) final state differs (telemetry={telemetry}) in {off}")
        check(same_hist(h_ref, hist), f"(6c a) histories {h_ref} and {hist}")
        for g in ("generator", "funnel_generator", "fault_generator"):
            check(torch.equal(getattr(t_ref, g).get_state(), getattr(trainer, g).get_state()), f"(6c a) {g} differs")
        if not telemetry:
            continue
        kinds = [e["event"] for e in events]
        want_kinds = ["manifest"] + (["fl_round"] * OBS_EVERY + ["fl_reprofile"]) * (OBS_ROUNDS // OBS_EVERY - 1) \
            + ["fl_round"] * OBS_EVERY
        check(kinds == want_kinds, f"(6c a) events {kinds}")
        check(events[0]["device_kind"] == card and events[0]["backend"] == "cuda", f"(6c a) manifest {events[0]}")
        rounds_ev = [e for e in events if e["event"] == "fl_round"]
        ages = [e["cache_age"] for e in rounds_ev]
        check(ages == [t % OBS_EVERY for t in range(OBS_ROUNDS)], f"(6c a) cache_age {ages}")
        check(all(e["survivors"] <= exp.clients_per_round and 1 <= e["spectrum_erank"] <= exp.num_clients
                  for e in rounds_ev), f"(6c a) survivors or erank off: {rounds_ev}")
        check(all(o["telemetry"].survivors.device.type == "cpu" for _, o in segs),
              "(6c a) stacked telemetry not on the host")
    walls = {t: [r[4] for r in runs if r[0] == t] for t in (False, True)}
    print(f"obs (a) CNN at C={exp.num_clients}, k={exp.clients_per_round}, chaos + trimmed_mean, {OBS_ROUNDS} "
          f"rounds re-profiled every {OBS_EVERY}, in turns {list(OBS_TURNS)}: with telemetry "
          f"{[round(w, 4) for w in walls[True]]} s, without {[round(w, 4) for w in walls[False]]} s (means "
          f"{(statistics.mean(walls[True]) - statistics.mean(walls[False])) / OBS_ROUNDS * 1e3:+.2f} ms a round); "
          f"outputs, final state ({len(want)} tensors and generator states), history and generators of all "
          f"{len(runs)} runs equal bit for bit; events {dict(collections.Counter(kinds))}; cache_age {ages}, "
          f"survivors {[e['survivors'] for e in rounds_ev]}, flagged {[e['flagged'] for e in rounds_ev]}, "
          f"spectrum_erank {[round(e['spectrum_erank'], 4) for e in rounds_ev]}")
    del runs, t_ref, seg_ref, trainer, segs

    # ------------------------------------------- (c) serving, on and off
    cfg, params = serve_launch.build_model("smollm-360m", 0, full_width=True, device=dev)
    layers = cfg.num_layers
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, size=(OBS_REQUESTS, SERVE_PROMPT), dtype=np.int32)
    budgets = rng.integers(OBS_BUDGETS[0], OBS_BUDGETS[1] + 1, size=OBS_REQUESTS)
    scfg = ServeConfig(batch=SERVE_BATCH, cache_len=SERVE_PROMPT + OBS_BUDGETS[1], max_new=OBS_BUDGETS[1],
                       decode_chunk=OBS_CHUNK, use_flash=True)
    served = []
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        for i, on in enumerate(OBS_TURNS):
            with contextlib.ExitStack() as stack:
                sink = stack.enter_context(TelemetrySink(f"{tmp}/serve{i}.jsonl")) if on else None
                eng = ServeEngine(cfg, scfg, params, prompt_len=SERVE_PROMPT, telemetry=sink)
                _build.reset_launches()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for j in range(OBS_REQUESTS):
                    eng.submit(prompts[j], int(budgets[j]))
                fin = eng.run()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            served.append((on, {f.seq_id: f.tokens for f in fin}, eng.compile_counts(), eng.state.step,
                           _build.LAUNCHES["flash_decode"], wall,
                           load_events(f"{tmp}/serve{i}.jsonl") if on else None))
    tok_ref = served[0][1]
    check(set(tok_ref) == set(range(OBS_REQUESTS)), f"(6c c) sequences {sorted(tok_ref)}")
    for on, toks, cc, steps, k5, _, events in served:
        check(set(toks) == set(tok_ref) and all(np.array_equal(toks[i], tok_ref[i]) for i in toks),
              f"(6c c) tokens differ (sink={on})")
        check(cc == {"decode_chunk": 1, "admit": 1}, f"(6c c) shape signatures {cc} (sink={on})")
        check(k5 == layers * steps and steps == served[0][3],
              f"(6c c) K5 launches {k5} for {steps} decode steps of {layers} layers (sink={on})")
        if not on:
            continue
        kinds = collections.Counter(e["event"] for e in events)
        check(kinds["serve_submit"] == kinds["serve_admit"] == kinds["serve_finish"] == OBS_REQUESTS
              and kinds["serve_chunk"] >= 1, f"(6c c) events {dict(kinds)}")
        fin_ev = {e["seq_id"]: e["n_tokens"] for e in events if e["event"] == "serve_finish"}
        check(fin_ev == {i: int(budgets[i]) for i in range(OBS_REQUESTS)}, f"(6c c) n_tokens {fin_ev}")
        ttft = [e["ttft_s"] for e in events if e["event"] == "serve_admit"]
        check(all(t >= 0 for t in ttft), f"(6c c) TTFT {ttft}")
        chunks = [e for e in events if e["event"] == "serve_chunk"]
    walls = {t: [r[5] for r in served if r[0] == t] for t in (False, True)}
    print(f"obs (c) smollm-360m full width, K5, {OBS_REQUESTS} requests of budgets {budgets.tolist()}, chunk "
          f"{OBS_CHUNK}, in turns {list(OBS_TURNS)}: with a sink {[round(w, 4) for w in walls[True]]} s, without "
          f"{[round(w, 4) for w in walls[False]]} s ({len(chunks)} chunks; means "
          f"{(statistics.mean(walls[True]) - statistics.mean(walls[False])) / len(chunks) * 1e3:+.2f} ms a "
          f"chunk); tokens of all {len(served)} runs equal bit for bit, shape signatures {served[0][2]}, K5 "
          f"{served[0][4]} launches = {layers} x {served[0][3]} decode steps in each run; events {dict(kinds)}; "
          f"TTFT s p50 {statistics.median(ttft):.4f} max {max(ttft):.4f}; chunk dt_s "
          f"{[e['dt_s'] for e in chunks]}, tok_s {[e['tok_s'] for e in chunks]}")
    del params, eng
    gc.collect()
    torch.cuda.empty_cache()

    # ---------------------------------------------------- (d) the traces
    real_handler = torch.profiler.tensorboard_trace_handler
    export_s = []

    def timed_handler(*a, **kw):
        handler = real_handler(*a, **kw)

        def on_ready(prof):
            t0 = time.perf_counter()
            handler(prof)
            export_s.append(time.perf_counter() - t0)

        return on_ready

    torch.profiler.tensorboard_trace_handler = timed_handler
    try:
        with tempfile.TemporaryDirectory(dir=build) as tmp:
            argv = ["--arch", "smollm-360m", "--full-width", "--continuous", "--flash", "--requests",
                    str(OBS_TRACE_REQUESTS), "--gen", str(OBS_TRACE_GEN), "--batch", str(OBS_TRACE_BATCH),
                    "--profile-dir", f"{tmp}/serve"]
            print(f"obs (d): python -m repro_torch.launch.serve {' '.join(argv)}")
            _build.reset_launches()
            t0 = time.perf_counter()
            serve_launch.main(argv)
            t_serve = time.perf_counter() - t0
            k5 = _build.LAUNCHES["flash_decode"]
            serve_trace = _trace_of(f"{tmp}/serve")

            cfg = dataclasses.replace(paper_cnn.fl_config(exp, seed=0), num_clients=OBS_TRACE_C,
                                      reprofile_every=2)
            params = cnn.init_cnn(torch.Generator(device=dev).manual_seed(0), channels=exp.cnn_channels,
                                  fc1_dim=exp.fc1_dim)
            _build.reset_launches()
            t0 = time.perf_counter()
            with tracing.trace(f"{tmp}/cnn"):
                trainer = FLTrainer(cfg, params, cnn.cnn_loss, cnn.apply_with_features, client_xs[:OBS_TRACE_C],
                                    client_ys[:OBS_TRACE_C], selection.DPPSelection(), accuracy_fn=cnn.accuracy)
                trainer.run(rounds=2)
                torch.cuda.synchronize()
            t_cnn = time.perf_counter() - t0
            k1, k2 = (_build.LAUNCHES[n] for n in FL_KERNELS)
            cnn_trace = _trace_of(f"{tmp}/cnn")
    finally:
        torch.profiler.tensorboard_trace_handler = real_handler
    check(serve_trace["spans"]["serve.admit"] == OBS_TRACE_REQUESTS and serve_trace["spans"]["serve.decode_chunk"] >= 1,
          f"(6c d) serving spans {dict(serve_trace['spans'])}")
    check(cnn_trace["spans"]["fl.scan_chunk[2]"] == 1 and cnn_trace["spans"]["fl.reprofile"] == 1,
          f"(6c d) CNN spans {dict(cnn_trace['spans'])}")
    check(k5 > 0 and k1 >= 1 and k2 >= 1, f"(6c d) launches K5 {k5}, K1 {k1}, K2 {k2}")
    for what, tr, secs, exp_s in (("serve launcher", serve_trace, t_serve, export_s[0]),
                                  ("CNN FLTrainer", cnn_trace, t_cnn, export_s[1])):
        print(f"obs (d) {what} trace: {tr['events']} events, {tr['bytes'] / 2**20:.2f} MiB, exported in "
              f"{exp_s:.3f} s of the run's {secs:.3f} s; host spans {dict(tr['spans'])}")
    print("obs (d) " + _device_line("serving", serve_trace, {"K5": k5}))
    print("obs (d) " + _device_line("CNN init and rounds", cnn_trace, {"K1": k1, "K2": k2}))
    print(f"phase 6c: {time.perf_counter() - t_phase:.1f} s")


# ------------------------------------------- 7. the dry run against the card


def dry_record(**case) -> dict:
    """A worker's dry-run record of ``DryRunCase(**case)`` (fake tensors,
    one host core)."""
    import torch

    torch.set_num_threads(1)
    from repro_torch.launch import dryrun

    return dryrun.run_case(dryrun.DryRunCase(**case))


def dry_decode_cut(budget: float) -> list:
    """smollm-360m's decode_32k records, the batch halved from the shape's
    until the step's peak fits ``budget`` bytes; the last one is the cut."""
    import torch

    torch.set_num_threads(1)
    from repro_torch.configs.base import INPUT_SHAPES
    from repro_torch.launch import dryrun

    b, recs = INPUT_SHAPES["decode_32k"].global_batch, []
    while True:
        recs.append(dryrun.run_case(dryrun.DryRunCase("smollm-360m", "decode_32k", batch=b)))
        if not recs[-1]["ok"] or recs[-1]["peak_bytes"] <= budget or b == 1:
            return recs
        b //= 2


PARITY = ("Mode-B step (SGD, 2 micro-batches)", "FedOpt round (server SGD 1.0 with momentum 0.9, 2 clients)")


def parity_model():
    """Phase 7 (c)'s model: smollm-360m in fp32 at full width, without
    remat -> (config, params on the CPU from seed 0)."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as T

    cfg32 = dataclasses.replace(get_arch("smollm-360m").model, param_dtype="float32", dtype="float32", remat=False)
    return cfg32, T.init_params(torch.Generator().manual_seed(0), cfg32, "cpu")


def parity_step(which: int, device, model):
    """Phase 7 (c)'s step ``which`` (0: Mode B, 1: FedOpt) of ``model``
    (``parity_model()``) on ``device``, from the same seeds wherever it
    runs -> (params, loss)."""
    import numpy as np
    import torch

    from repro_torch import optim
    from repro_torch.configs import get_arch
    from repro_torch.fl import rounds
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_map

    cfg32, params = model
    lr = get_arch("smollm-360m").fl.lr
    params = tree_map(lambda x: x.to(device), params)
    rng = np.random.default_rng(0)
    toks = torch.as_tensor(rng.integers(0, cfg32.vocab_size, (2, DRY_PARITY_SEQ)).astype(np.int32), device=device)
    client_toks = torch.as_tensor(rng.integers(0, cfg32.vocab_size, (2, 1, 1, DRY_PARITY_SEQ)).astype(np.int32),
                                  device=device)

    def loss_fn(p, b):
        return T.lm_loss(cfg32, p, b[0])

    if which == 0:
        params, _, loss = rounds.build_fedsgd_step(loss_fn, optim.sgd(lr), micro_batches=2)(params, (), (toks,))
    else:
        sopt = optim.sgd(1.0, momentum=0.9)
        fedopt = rounds.build_server_opt_round(loss_fn, lr, 1, sopt)
        params, _, loss = fedopt(params, sopt.init(params), (client_toks,), torch.tensor([3.0, 1.0], device=device))
    return params, float(loss)


def parity_cpu(which: int, path: str) -> tuple:
    """A worker's CPU half of ``parity_step``: the params saved to ``path``
    -> (loss, seconds)."""
    import torch

    t0 = time.perf_counter()
    params, loss = parity_step(which, "cpu", parity_model())
    torch.save(params, path)
    return loss, time.perf_counter() - t0


def card_steps(dec_batch: int) -> dict:
    """Phase 7 (b) on the card, run by a worker with a CUDA context of its
    own, as the dry run reckons a process that runs a step alone:
    cuBLAS's workspaces (after a first matmul, and after its gradient on
    autograd's thread), the buffers ``_softmax_backward_data`` allocates
    for itself at the plain attention's score shape, smollm-360m's decode
    step at ``dec_batch`` through K5 and again on the plain path under
    FlopCounterMode, and the Mode-A round ``TRAIN_CUT`` under
    FlopCounterMode -> their readings; each step's peak is above what was
    allocated before its arguments were made."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.analysis.ops import card_temporaries
    from repro_torch.kernels import _build
    from repro_torch.launch import dryrun
    from repro_torch.models import transformer as T

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    def alloc():
        return torch.cuda.memory_allocated(dev)

    def peak_of(fn, m0=None):
        """fn() -> (its result, the most allocated while it ran above
        ``m0``, by default what was allocated when it began)"""
        torch.cuda.synchronize()
        m0 = alloc() if m0 is None else m0
        torch.cuda.reset_peak_memory_stats(dev)
        out = fn()
        torch.cuda.synchronize()
        return out, torch.cuda.max_memory_allocated(dev) - m0

    a = torch.randn(64, 64, device=dev, dtype=torch.bfloat16, requires_grad=True)
    m0 = alloc()
    y = a @ a
    m1 = alloc()
    (g,) = torch.autograd.grad(y.float().sum(), a)
    torch.cuda.synchronize()
    got = {"card": torch.cuda.get_device_name(0),
           "workspaces": (m1 - m0 - y.untyped_storage().nbytes(), alloc() - m1 - g.untyped_storage().nbytes())}
    del a, y, g

    op, shape = torch.ops.aten._softmax_backward_data.default, (1, 5, 3, 512, 4096)
    probs = torch.softmax(torch.randn(shape, device=dev), -1)
    got["softmax"] = []
    for grad in (torch.randn(shape, device=dev), torch.randn(1, 3, 5, 512, 4096, device=dev).transpose(1, 2)):
        res, peak = peak_of(lambda: op(grad, probs, -1, torch.float32))
        got["softmax"].append((grad.is_contiguous(), peak - res.untyped_storage().nbytes(),
                               card_temporaries(op, (grad, probs, -1, torch.float32))))
        del res
    del probs, grad

    case = dryrun.DryRunCase("smollm-360m", "decode_32k", batch=dec_batch)
    cfg = dryrun.case_config(case)[1]
    m0 = alloc()
    step, args, info = dryrun.build_step(case, dev)
    for c in list(args[2]["unit"]) + list(args[2]["rem"]):
        c["pos"].fill_(info["seq"] - 1)  # every slot decodes against the whole cache, as the dry run counts it
    _build.reset_launches()
    out, peak = peak_of(lambda: step(*args), m0)
    launches = _build.LAUNCHES["flash_decode"]
    del out
    fc = FlopCounterMode(display=False)
    with fc:
        out = T.decode_step(cfg, args[0], args[1], args[2], use_flash=False)  # the plain path
    got["decode"] = dict(peak=peak, launches=launches, flops=fc.get_total_flops(),
                         finite=bool(torch.isfinite(out[0].float()).all()))
    del step, args, out
    torch.cuda.empty_cache()

    m0 = alloc()
    step, args, _ = dryrun.build_step(dryrun.DryRunCase(**TRAIN_CUT), dev)
    fc = FlopCounterMode(display=False)
    t0 = time.perf_counter()
    with fc:
        out, peak = peak_of(lambda: step(*args), m0)
    got["round"] = dict(flops=fc.get_total_flops(), peak=peak, seconds=time.perf_counter() - t0, loss=float(out[1]))
    del step, args, out
    torch.cuda.empty_cache()
    return got


def start_dry_runs(pool, parity_dir) -> dict:
    """Phase 7's jobs on the host's cores, in ``pool``: the dry-run records
    (the decode cut first, which phase 3e's ``card_steps`` reads) and the
    CPU halves of the parity checks, their params saved in ``parity_dir``.
    -> {name: AsyncResult}."""
    jobs = {"decode cut": pool.apply_async(dry_decode_cut, (DRY_FIT * HW.HBM_BYTES,)),
            "train cut": pool.apply_async(dry_record, kwds=TRAIN_CUT)}
    for which in range(len(PARITY)):
        jobs[f"parity {which}"] = pool.apply_async(parity_cpu, (which, str(Path(parity_dir) / f"{which}.pt")))
    for a, s in DRY_CASES:
        jobs[f"{a} {s}"] = pool.apply_async(dry_record, kwds=dict(arch=a, shape=s))
    return jobs


def _print_record(rec: dict) -> None:
    from repro_torch.analysis.ops import op_histogram

    fit = "fits one card" if rec["fits_one_card"] else f"needs {rec['cards_needed']} cards"
    print(f"dry run {rec['arch']} {rec['shape']} batch {rec['batch']} ({rec['fl_mode']}"
          + (f", {rec['optimizer']}" if "optimizer" in rec else "")
          + (f", {rec['micro_batches']} micro-batches" if "micro_batches" in rec else "")
          + f"): params {rec['params']:,}, arguments {_gib(rec['argument_bytes'])}, outputs "
          f"{_gib(rec['output_bytes'])}, peak {_gib(rec['peak_bytes'])} (cuBLAS workspaces "
          f"{_gib(rec['workspace_bytes'])} of it) on the {rec['card']}: {fit}; "
          f"{rec['flops']:.4e} FLOPs ({rec['flops_counted']:.4e} counted, kernels {rec['kernel_flops']}), "
          f"{rec['bytes_moved']:.4e} bytes moved, {rec['n_ops']:,} aten ops "
          f"(top {op_histogram(rec, 6)}), {rec['total_s']:.1f} s on a host core")
    print(json.dumps({k: v for k, v in rec.items() if k not in ("ops", "traceback")}))


def _roofline_line(torch, what: str, rec: dict, seconds: float) -> None:
    from repro_torch.analysis.roofline import peak_flops

    t_c, t_m = rec["flops"] / peak_flops(rec["dtype"]), rec["bytes_moved"] / HW.HBM_BW
    print(f"{what}: {seconds:.4f} s on the card; roofline compute {t_c:.4e} s, memory {t_m:.4e} s: "
          f"the larger is {max(t_c, t_m) / seconds:.4f} of the step (a reading, not a bound)")


def _band(what: str, real: int, rec: dict) -> None:
    """Hold a real peak to the dry run's within DRY_MEM_BAND."""
    ratio = real / rec["peak_bytes"]
    print(f"(b) {what} peak: real {_gib(real)} ({real} bytes), dry run {_gib(rec['peak_bytes'])} "
          f"({rec['peak_bytes']} bytes): {ratio:.4f} (band {1 - DRY_MEM_BAND:.2f}-{1 + DRY_MEM_BAND:.2f})")
    check(abs(ratio - 1) <= DRY_MEM_BAND, f"{what} peak {real} vs the dry run's {rec['peak_bytes']}")


def dryrun_phase(torch, dev, jobs: dict, card: dict, card_wait: float, parity_dir) -> None:
    """(a) the dry run's records at full width; (b) smollm-360m's decode
    and train steps materialised at full width and depth (``card_steps``,
    during phase 3e): FLOPs held equal to the fake count and peak memory
    within DRY_MEM_BAND of it, and each step timed here, uninstrumented,
    beside the roofline's terms; (c) one Mode-B step and one FedOpt round
    on the card held to the CPU."""

    from repro_torch.launch import dryrun
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_leaves, tree_map

    t_phase = time.perf_counter()
    recs = {k: j.get() for k, j in jobs.items()}  # done: the pool was joined after phase 3e

    # (a) the records at full width
    for key in [f"{a} {s}" for a, s in DRY_CASES] + ["train cut"]:
        rec = recs[key]
        check(rec["ok"], f"dry run {key}: {rec.get('error')}")
        _print_record(rec)
    llama = recs["llama4-maverick-400b-a17b train_4k"]
    check(not llama["fits_one_card"] and llama["cards_needed"] > 1 and llama["fl_mode"] == "fedsgd_fsdp",
          f"llama4-maverick's Mode-B step should need more than one card: {llama['cards_needed']}")
    decode_recs = recs["decode cut"]
    for rec in decode_recs:
        check(rec["ok"], f"dry run decode cut: {rec.get('error')}")
    dec = decode_recs[-1]
    check(dec["peak_bytes"] <= DRY_FIT * HW.HBM_BYTES, f"no decode batch fits: {dec['peak_bytes']}")
    print("cut: smollm-360m decode_32k batch " + " -> ".join(
        f"{r['batch']} ({_gib(r['peak_bytes'])})" for r in decode_recs)
        + f", the first whose peak fits {DRY_FIT} of the card")
    full, trc = recs["smollm-360m train_4k"], recs["train cut"]
    print(f"cut: smollm-360m train_4k round of {full['clients']} clients x {full['local_batch']} sequences x "
          f"{full['local_steps']} local steps -> {trc['clients']} x {trc['local_batch']} x {trc['local_steps']}, "
          f"for the phase's time, not for memory (the full round's peak {_gib(full['peak_bytes'])} fits the card; "
          f"it dispatches {full['n_ops']:,} aten ops)")

    # (b) on the card, in a worker of its own during phase 3e
    ws, cfg = card["workspaces"], dryrun.case_config(dryrun.DryRunCase("smollm-360m", "decode_32k"))[1]
    print(f"(b) on the {card['card']}, in a fresh process during phase 3e: cuBLAS's workspaces {ws[0]} bytes "
          f"(the first matmul) and {ws[1]} (its gradient, on autograd's thread); the dry run's "
          f"{HW.CUBLAS_WORKSPACE} each")
    check(list(ws) == [HW.CUBLAS_WORKSPACE] * 2, f"cuBLAS workspaces {ws}")
    for contiguous, held, want in card["softmax"]:
        print(f"(b) _softmax_backward_data at (1, 5, 3, 512, 4096) fp32, grad {'' if contiguous else 'not '}"
              f"contiguous: {held} bytes of its own while it runs; the dry run's {want}")
        check(held == want, f"_softmax_backward_data held {held} bytes, the dry run counts {want}")
    d = card["decode"]
    print(f"(b) decode_32k batch {dec['batch']}: FLOPs real plain {d['flops']:.6e}, fake {dec['flops']:.6e}; "
          f"K5 {d['launches']} launches in the step")
    check(d["finite"], "decode logits not finite")
    check(d["launches"] == cfg.num_layers, f"K5 launches {d['launches']}")
    check(d["flops"] == dec["flops"], f"decode FLOPs {d['flops']} != fake {dec['flops']}")
    _band(f"decode_32k batch {dec['batch']} (+ the first workspace)", d["peak"] + ws[0], dec)
    r = card["round"]
    print(f"(b) train_4k round (Mode A, {trc['clients']} clients x {trc['local_batch']} sequence x "
          f"{trc['local_steps']} local steps, {trc['micro_batches']} micro-batch; the dry run counted "
          f"{trc['grads_counted']} gradient and replayed {trc['grads_replayed']}): loss {r['loss']:.5f}; FLOPs real "
          f"{r['flops']:.6e}, fake {trc['flops']:.6e}; {r['seconds']:.2f} s under FlopCounterMode")
    check(math.isfinite(r["loss"]), f"round loss {r['loss']}")
    check(r["flops"] == trc["flops"], f"train FLOPs {r['flops']} != fake {trc['flops']}")
    _band("train_4k round (+ both workspaces)", r["peak"] + ws[0] + ws[1], trc)

    # (b) the steps timed here, uninstrumented
    case = dryrun.DryRunCase("smollm-360m", "decode_32k", batch=dec["batch"])
    _, args, info = dryrun.build_step(case, dev)
    for c in list(args[2]["unit"]) + list(args[2]["rem"]):
        c["pos"].fill_(info["seq"] - 1)
    times = []
    for _ in range(6):  # the first warms up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        T.decode_step(cfg, args[0], args[1], args[2], use_flash=True)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    del args
    _roofline_line(torch, f"(b) decode_32k step, batch {dec['batch']} (median of 5)", dec,
                   statistics.median(times[1:]))
    gc.collect()
    torch.cuda.empty_cache()
    step, args, _ = dryrun.build_step(dryrun.DryRunCase(**TRAIN_CUT), dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = step(*args)
    torch.cuda.synchronize()
    t_round = time.perf_counter() - t0
    check(math.isfinite(float(out[1])), f"round loss {float(out[1])}")
    del step, args, out
    _roofline_line(torch, f"(b) train_4k round, {trc['clients']} x {trc['local_batch']} x {trc['local_steps']} "
                   "(once, uninstrumented)", trc, t_round)

    # (c) one Mode-B step and one FedOpt round in fp32, the card against the
    # CPU's (run by a worker from the same seeds)
    gc.collect()
    torch.cuda.empty_cache()
    model = parity_model()
    for which, what in enumerate(PARITY):
        t0 = time.perf_counter()
        p_card, l_card = parity_step(which, dev, model)
        p_card = tree_map(lambda x: x.cpu(), p_card)
        t_card = time.perf_counter() - t0
        l_host, t_host = recs[f"parity {which}"]
        p_host = torch.load(Path(parity_dir) / f"{which}.pt", mmap=True)
        check(math.isfinite(l_card), f"{what}: loss {l_card}")
        check(abs(l_card - l_host) <= 1e-5 + 1e-5 * abs(l_host), f"{what}: loss {l_card} on the card, {l_host} on the CPU")
        worst = max(float(((a - b).abs() - 1e-5 * b.abs()).max()) for a, b in zip(tree_leaves(p_card), tree_leaves(p_host)))
        check(worst <= 1e-6, f"{what}: params part from the CPU's by {worst} past rtol 1e-5")
        print(f"(c) {what}: loss card {l_card:.7f}, CPU {l_host:.7f}; params within rtol 1e-5 + atol 1e-6 "
              f"(worst excess {worst:.3e}); card {t_card:.2f} s, CPU {t_host:.2f} s in a worker")
        del p_card, p_host
    own = time.perf_counter() - t_phase
    print(f"phase 7: {own + card_wait:.1f} s ({own:.1f} s here, {card_wait:.1f} s waiting for its steps on the "
          f"card after phase 3e)")


def mesh_phase(torch, dev, exp, client_xs, client_ys, ds) -> dict:
    """Client-sharded cohort execution on one NCCL rank, phase 8.

    (a) The paper's CNN at C = 100 through ``FLTrainer(mesh=)`` (resident
    rounds: every resident trains, weight 0 outside the cohort),
    ``MESH_ROUNDS`` rounds against the unsharded trainer from the same seed:
    cohorts bit for bit, params within 1e-5, the mesh counter one
    all-reduce a round.  (b) The same with ``cohort_cap`` = k (slot
    rounds), then ``MESH_TRACE_ROUNDS`` more traced with torch.profiler:
    one ``nccl:all_reduce`` record a round (and the NCCL device kernels it
    shows, if any).  (c) Staleness
    bound 2 (heavy_tail, exponential, α 0.3), ``MESH_STALE_ROUNDS`` rounds:
    finite losses, counters <= 2, each round's ``sim_time`` at most the
    synchronous barrier on the same latency draws, the cohorts (a)'s.
    (d) The funnel at C = ``FUNNEL_C``, Q = ``FUNNEL_C · FUNNEL_FRAC``
    under the mesh (slots, flaky, re-funnelled at round 2): each all-reduced
    candidate block equal to ``index_select``'s bit for bit, K1 and K2 once
    at init and once at the boundary.  (e) The launcher at full width:
    smollm-360m, ``--shard-clients 1 --cohort-cap`` k ``--flash``,
    ``MESH_LM_ROUNDS`` rounds of the default 10 clients: K6 once a layer
    and refresh, one all-reduce a round; then the same argv without the
    mesh flags from the same seed: its cohorts bit for bit, its bf16 params
    within ``MESH_LM_ULPS`` steps of bf16, round 1's loss within 1e-5 and
    every loss within ``MESH_LM_LOSS_RTOL``.  cuDNN is deterministic for the
    phase.  Returns the launches of (d)'s K1 and K2 and (e)'s K6."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import model_config, paper_cnn
    from repro_torch.core import selection
    from repro_torch.data import skewness_partition
    from repro_torch.fl import engine
    from repro_torch.fl.trainer import FLTrainer
    from repro_torch.kernels import _build
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import train as train_launch
    from repro_torch.models import cnn
    from repro_torch.tree import tree_leaves

    t_phase = time.perf_counter()
    cudnn = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    cp = exp.clients_per_round
    on_card = dev.type == "cuda"
    mesh = mesh_lib.make_client_mesh(1, dev)
    check(mesh.backend == ("nccl" if on_card else "gloo") and mesh.device.type == dev.type,
          f"mesh {mesh.backend} {mesh.device}")
    print(f"mesh: 1 rank over {mesh.backend} on {mesh.device}"
          + (f" ({torch.cuda.get_device_name(0)})" if on_card else ""))

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def fresh_params():
        return cnn.init_cnn(torch.Generator(device=dev).manual_seed(0),
                            channels=exp.cnn_channels, fc1_dim=exp.fc1_dim)

    def run(cfg, rounds, on_mesh, trace=False):
        """``rounds`` rounds through a fresh trainer -> (trainer, outputs,
        all-reduces in the rounds, profiler or None, final state)."""
        trainer = FLTrainer(cfg, fresh_params(), cnn.cnn_loss, cnn.apply_with_features, client_xs, client_ys,
                            selection.DPPSelection(), device=dev, mesh=mesh if on_mesh else None)
        sync()
        mesh.reset_counts()
        prof = None
        with _Spy(engine, "run_scanned") as seg, contextlib.ExitStack() as stack:
            if trace:
                prof = stack.enter_context(torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]))
            trainer.run(rounds=rounds)
            sync()
        check(len(seg.calls) == 1, "not one segment")
        final, outs = seg.calls[0][2]
        return trainer, outs, mesh.all_reduce_calls, prof, final

    def per_round(outs):
        return [round(float(outs["t_select"][i] + outs["t_local"][i] + outs["t_refresh"][i]), 4)
                for i in range(len(outs["round"]))]

    base = paper_cnn.fl_config(exp, seed=0)
    ref_cohorts = None
    for label, cap in (("(a)", None), ("(b)", cp)):
        cfg = dataclasses.replace(base, cohort_cap=cap)
        ref, ref_outs, _, _, _ = run(cfg, MESH_ROUNDS, on_mesh=False)
        tr, outs, calls, _, _ = run(cfg, MESH_ROUNDS, on_mesh=True)
        check(torch.equal(outs["selected"], ref_outs["selected"]), f"mesh {label}: cohorts off the unsharded run")
        perr = max(float((tr.params[n] - ref.params[n]).abs().max()) for n in ref.params)
        check(perr <= 1e-5, f"mesh {label}: params {perr} from the unsharded run")
        check(calls == MESH_ROUNDS, f"mesh {label}: {calls} all-reduces in {MESH_ROUNDS} rounds")
        check(bool(torch.isfinite(outs["loss"]).all()), f"mesh {label}: losses {outs['loss']}")
        lerr = float((tr.losses - ref.losses).abs().max())
        print(f"mesh {label} {'slots (cohort_cap ' + str(cap) + ')' if cap else 'resident'}: cohorts equal to the "
              f"unsharded run's over {MESH_ROUNDS} rounds, max |params - unsharded| {perr:.3e}, losses {lerr:.3e}; "
              f"all-reduces {calls}; seconds a round sharded {per_round(outs)} vs unsharded {per_round(ref_outs)}")
        if cap is None:
            ref_cohorts = outs["selected"]
        else:
            # a traced run of its own: the timed rounds above ran without the
            # profiler's cost
            _, _, _, prof, _ = run(cfg, MESH_TRACE_ROUNDS, on_mesh=True, trace=True)
            record = f"{mesh.backend}:all_reduce"
            events = prof.key_averages()
            host = sum(e.count for e in events if e.key == record)
            dev_k = {e.key: e.count for e in events if "allreduce" in e.key.lower() and e.key != record}
            print(f"mesh (b) trace: {host} {record} records in {MESH_TRACE_ROUNDS} traced rounds; device kernels of "
                  f"the collective {dev_k if dev_k else 'none (an in-place all-reduce at world size 1 launches none)'}")
            check(host == MESH_TRACE_ROUNDS, f"mesh (b): {host} {record} records for {MESH_TRACE_ROUNDS} rounds")

    # (c) bounded staleness on the same seed, latencies recorded
    scfg = dataclasses.replace(base, scenario="heavy_tail", staleness_bound=2, staleness_decay="exponential",
                               staleness_alpha=0.3)
    with _Spy(engine, "draw_environment") as env:
        tr, outs, calls, _, final = run(scfg, MESH_STALE_ROUNDS, on_mesh=True)
    barrier = [float(torch.amax(lat[sel.long().to(lat.device)])) for (_, _, (lat, _)), sel in
               zip(env.calls, outs["selected"])]
    sim = outs["sim_time"].tolist()
    check(calls == MESH_STALE_ROUNDS, f"mesh (c): {calls} all-reduces")
    check(bool(torch.isfinite(outs["loss"]).all()), f"mesh (c): losses {outs['loss']}")
    check(int(final.shard_staleness.max()) <= 2 and float(outs["staleness"].max()) <= 2, "mesh (c): a counter above 2")
    check(all(s <= b + 1e-6 for s, b in zip(sim, barrier)), f"mesh (c): sim_time {sim} above the barrier {barrier}")
    check(torch.equal(outs["selected"], ref_cohorts[:MESH_STALE_ROUNDS]), "mesh (c): staleness moved a cohort")
    print(f"mesh (c) staleness bound 2, heavy_tail, exponential 0.3: {MESH_STALE_ROUNDS} rounds, staleness "
          f"{outs['staleness'].tolist()}, sim_time {[round(s, 3) for s in sim]} vs the synchronous barrier "
          f"{[round(s, 3) for s in barrier]}, cohorts (a)'s; seconds a round {per_round(outs)}")

    # (d) the funnel at C = FUNNEL_C under the mesh
    shards = skewness_partition(ds.ys, FUNNEL_C, 0.8, ds.num_classes, samples_per_client=FUNNEL_N_C, seed=0)
    fxs = np.stack([ds.xs[sh] for sh in shards])
    fys = np.stack([ds.ys[sh] for sh in shards])
    fcfg = dataclasses.replace(base, num_clients=FUNNEL_C, eval_every=3, reprofile_every=2,
                               candidate_frac=FUNNEL_FRAC, scenario="flaky", cohort_cap=cp)
    q = fcfg.candidate_count()
    t0 = time.perf_counter()
    trainer = FLTrainer(fcfg, fresh_params(), cnn.cnn_loss, cnn.apply_with_features, fxs, fys,
                        selection.DPPSelection(), device=dev, mesh=mesh)
    sync()
    t_init = time.perf_counter() - t0
    _build.reset_launches()
    mesh.reset_counts()
    with _Spy(engine, "candidate_profile_block") as blocks:
        t0 = time.perf_counter()
        hist = trainer.run(rounds=3)
        sync()
        wall = time.perf_counter() - t0
    d_launches = {n: _build.LAUNCHES[n] for n in FL_KERNELS}
    check(d_launches == {n: 2 for n in FL_KERNELS}, f"mesh (d): K1/K2 not at init and the boundary: {d_launches}")
    check(len(blocks.calls) == 2, f"mesh (d): {len(blocks.calls)} candidate blocks")
    for (args, _, block) in blocks.calls:
        prof_rows, cand = args[0], args[1]
        check(tuple(block.shape) == (q, prof_rows.shape[1]), f"mesh (d): block {tuple(block.shape)}")
        check(torch.equal(block, torch.index_select(prof_rows, 0, cand.long())),
              "mesh (d): the all-reduced block is not index_select's bit for bit")
    check(mesh.all_reduce_calls == 3 + 2 * 2, f"mesh (d): {mesh.all_reduce_calls} all-reduces")
    check(hist["round"] == [3], f"mesh (d) history {hist}")
    print(f"mesh (d) funnel C={FUNNEL_C} -> Q={q}, slots {cp}, flaky: init {t_init:.3f} s, 3 rounds in {wall:.3f} s; "
          f"2 candidate blocks ({q}, {blocks.calls[0][2].shape[1]}) equal to index_select bit for bit; launches "
          f"{d_launches}; all-reduces {mesh.all_reduce_calls} (3 rounds, and the losses and the block at init "
          f"and at the boundary)")
    mesh.close()
    del trainer, fxs, fys
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    # (e) the launcher at full width on one NCCL rank
    argv = ["--mode", "fl", "--arch", "smollm-360m", "--shard-clients", "1", "--cohort-cap",
            str(MESH_LM_PER_ROUND), "--per-round", str(MESH_LM_PER_ROUND), "--flash", "--rounds",
            str(MESH_LM_ROUNDS), "--log-every", "1"] + (["--full-width"] if on_card else ["--device", "cpu"])
    print(f"mesh (e): python -m repro_torch.launch.train {' '.join(argv)}")
    _build.reset_launches()
    sync()
    t0 = time.perf_counter()
    with _Spy(mesh_lib, "make_client_mesh") as meshes:
        state, outs = train_launch.main(argv)
    sync()
    wall = time.perf_counter() - t0
    e_launches = dict(_build.LAUNCHES)
    layers = model_config("smollm-360m", on_card, None).num_layers
    lm_mesh = meshes.calls[0][2]
    check(len(meshes.calls) == 1 and lm_mesh.backend == mesh.backend, f"mesh (e): meshes {meshes.calls}")
    check(lm_mesh.all_reduce_calls == MESH_LM_ROUNDS, f"mesh (e): {lm_mesh.all_reduce_calls} all-reduces")
    check(e_launches["flash_attention"] == layers * MESH_LM_PER_ROUND * MESH_LM_ROUNDS,
          f"mesh (e): K6 launches {e_launches['flash_attention']}")
    check(e_launches["pairwise_dists_stats"] == 1 and e_launches["normalized_gram"] == 1,
          f"mesh (e): K1/K2 not once: {e_launches}")
    check(bool(torch.isfinite(outs["loss"]).all()) and all(bool(torch.isfinite(x).all())
                                                           for x in tree_leaves(state.params)),
          "mesh (e): non-finite losses or params")
    print(f"mesh (e): {MESH_LM_ROUNDS} rounds in {wall:.3f} s with set-up; launches {e_launches}; all-reduces "
          f"{lm_mesh.all_reduce_calls}; seconds a round {per_round(outs)}")
    # the same argv unsharded, from the same seed: with k = cap the engine
    # trains the same clients on the same batches, and the bf16 params part
    # only where the eq.-(6) sums round otherwise (slots in ascending id
    # order, the engine in cohort order; fp32 sums cast once to bf16)
    mesh_flags = ("--shard-clients", "--cohort-cap")
    ref_argv = [a for i, a in enumerate(argv) if a not in mesh_flags and (i == 0 or argv[i - 1] not in mesh_flags)]
    print(f"mesh (e) reference: python -m repro_torch.launch.train {' '.join(ref_argv)}")
    t0 = time.perf_counter()
    ref_state, ref_outs = train_launch.main(ref_argv)
    sync()
    ref_wall = time.perf_counter() - t0
    check(torch.equal(outs["selected"], ref_outs["selected"]), "mesh (e): cohorts off the unsharded launcher's")
    n_el = n_diff = max_ulps = 0
    max_abs, worst = 0.0, 0.0
    for a, b in zip(tree_leaves(state.params), tree_leaves(ref_state.params)):
        check(a.shape == b.shape and a.dtype == b.dtype, f"mesh (e): leaf {tuple(a.shape)} {a.dtype} vs {b.dtype}")
        af, bf = a.float(), b.float()
        d = (af - bf).abs()
        # MESH_LM_ULPS steps of bf16 at the larger magnitude, and a floor
        # for entries near zero
        lim = MESH_LM_ULPS * 2.0 ** -7 * torch.maximum(af.abs(), bf.abs()) + MESH_LM_ATOL
        n_el += a.numel()
        n_diff += int((a != b).sum())
        max_abs = max(max_abs, float(d.max()))
        worst = max(worst, float((d / lim).max()))
        max_ulps = max(max_ulps, int(_ulps(torch, a, b).max()))
    loss_rel = [float(abs(x - y) / abs(y)) for x, y in zip(outs["loss"].tolist(), ref_outs["loss"].tolist())]
    refresh_rel = float(((state.losses - ref_state.losses).abs() / ref_state.losses.abs()).max())
    print(f"mesh (e) against the unsharded launcher ({MESH_LM_ROUNDS} rounds in {ref_wall:.3f} s with set-up, "
          f"seconds a round {per_round(ref_outs)}): cohorts equal; params: {n_diff} of {n_el} entries differ, at most "
          f"{max_ulps} {a.dtype} steps, max |d| {max_abs:.3e}, {worst:.4f} of the bound (|d| <= {MESH_LM_ULPS} * 2^-7 "
          f"* max(|a|, |b|) + {MESH_LM_ATOL:g}); round losses relative {loss_rel}; refreshed losses relative "
          f"{refresh_rel:.3e}")
    check(worst <= 1.0, f"mesh (e): params {worst} of the bf16 bound off the unsharded launcher's")
    check(loss_rel[0] <= 1e-5, f"mesh (e): round 1's loss {loss_rel[0]} off the unsharded launcher's")
    check(max(loss_rel) <= MESH_LM_LOSS_RTOL and refresh_rel <= MESH_LM_LOSS_RTOL,
          f"mesh (e): losses {loss_rel} {refresh_rel} off the unsharded launcher's")
    del ref_state, ref_outs
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = cudnn
    print(f"phase 8: {time.perf_counter() - t_phase:.1f} s")
    return {"pairwise_dists_stats": d_launches["pairwise_dists_stats"],
            "normalized_gram": d_launches["normalized_gram"], "flash_attention": e_launches["flash_attention"]}


def prod_mesh_steps() -> list:
    """Phase 8b in a spawned worker (the ``fake`` group is the process's
    default group): for each of ``PROD_MESH_CASES`` on the 16 x 16 mesh
    over ``cuda``, the sharded dry run's record (fake tensors, a host
    core), then rank 0's program on real tensors made at its shapes,
    counted (``StepCounter``) and its peak read; K7's calls spied on, the
    first one's local inputs and outputs kept -> one dict a case."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.analysis.ops import StepCounter, collective_bytes
    from repro_torch.kernels import _build
    from repro_torch.kernels.rwkv6_scan import ops as wkv_ops
    from repro_torch.kernels.rwkv6_scan.ref import wkv6_scan_ref
    from repro_torch.launch import dryrun

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    k7_calls = []
    kernel = wkv_ops.wkv6

    def spy(*a):
        y, s_new = kernel(*a)
        if not _build.is_fake(a[0]):  # the real run's calls, not the dry run's
            k7_calls.append((tuple(a[0].shape), [x.clone() for x in a], y.clone(), s_new.clone()) if not k7_calls
                            else (tuple(a[0].shape),))
        return y, s_new

    wkv_ops.wkv6 = spy
    out = []
    for what, kw in PROD_MESH_CASES:
        case = dryrun.DryRunCase(**kw, multi_pod=False, mesh_device="cuda")
        t0 = time.perf_counter()
        rec = dryrun.run_case(case)
        got = dict(what=what, dry_s=time.perf_counter() - t0,
                   rec={k: v for k, v in rec.items() if k not in ("ops", "traceback")})
        out.append(got)
        if not rec["ok"]:
            got["error"] = rec["error"] + "\n" + rec.get("traceback", "")
            continue
        mesh = dryrun.case_mesh(case)
        with FakeTensorMode():
            step, fake_args, _ = dryrun.build_sharded_step(case, mesh, "cuda")
        # cuBLAS's workspaces are made again in the step, as the dry run counts them
        torch._C._cuda_clearCublasWorkspaces()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        m0 = torch.cuda.memory_allocated(dev)
        args = dryrun.materialize(fake_args, dev)
        counter = StepCounter(mesh)
        counter.hold(args)
        _build.reset_launches()
        k7_calls.clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        with counter:
            res = step(*args)
        torch.cuda.synchronize()
        got.update(seconds=time.perf_counter() - t0, peak=torch.cuda.max_memory_allocated(dev) - m0,
                   flops=counter.flops, calls=collective_bytes(counter.collectives)["calls"],
                   launches=dict(_build.LAUNCHES), k7_shapes=sorted({c[0] for c in k7_calls}), k7_n=len(k7_calls))
        if k7_calls:
            _, inputs, y, s_new = k7_calls[0]
            want_y, want_s = wkv6_scan_ref(*inputs)
            want_y = want_y.to(y.dtype).float()
            dy, ds = (y.float() - want_y).abs(), (s_new - want_s).abs()
            # the bf16 criterion of section 2's K7 check
            atol = 2.0**-8 * want_y.abs().amax(dim=-1, keepdim=True)
            got.update(k7_err=float(dy.max()), k7_bad=int((dy > 2.0**-7 * want_y.abs() + atol).sum()),
                       k7_bad_s=int((ds > 1e-5 * want_s.abs().amax(dim=(2, 3), keepdim=True)).sum()),
                       k7_err_s=float(ds.max()))
        del args, res, step, fake_args, k7_calls[:]
        torch.cuda.empty_cache()
    wkv_ops.wkv6 = kernel
    return out


def prod_mesh_phase(smi: str) -> dict:
    """Phase 8b (module docstring): the worker's readings held to the dry
    run's per-device records; one line a case -> K7's launches there."""
    t_phase = time.perf_counter()
    with multiprocessing.get_context("spawn").Pool(1) as pool:
        cases = pool.apply(prod_mesh_steps)
    k7_launches = 0
    for got in cases:
        rec, what = got["rec"], got["what"]
        check(rec["ok"], f"8b {what}: the sharded dry run failed: {got.get('error')}")
        ratio = got["peak"] / rec["peak_bytes"]
        print(f"8b {what} on the 16 x 16 mesh (rank 0, {smi}): {got['seconds']:.2f} s (counted), "
              f"FLOPs {got['flops']:.6e} (dry run {rec['flops_counted']:.6e}), peak {_gib(got['peak'])} "
              f"(dry run {_gib(rec['peak_bytes'])}: {ratio:.4f}, band {1 - DRY_MEM_BAND:.2f}-{1 + DRY_MEM_BAND:.2f}), "
              f"collectives {got['calls']} (dry run {rec['collectives']['calls']}, "
              f"{rec['collectives']['total']:.4e} B by the estimators), roofline compute {rec['t_compute']:.4e} s "
              f"memory {rec['t_memory']:.4e} s collective {rec['t_collective']:.4e} s; launches "
              f"{ {k: v for k, v in got['launches'].items() if v} }, dry run {got['dry_s']:.1f} s")
        check(got["flops"] == rec["flops_counted"], f"8b {what}: FLOPs {got['flops']} vs {rec['flops_counted']}")
        check(abs(ratio - 1) <= DRY_MEM_BAND, f"8b {what}: peak {got['peak']} vs {rec['peak_bytes']}")
        check(got["calls"] == rec["collectives"]["calls"],
              f"8b {what}: collectives {got['calls']} vs {rec['collectives']['calls']}")
        check(got["launches"]["flash_decode"] == 0, f"8b {what}: K5 launched on a sequence-sharded cache")
        if rec["kind"] == "decode" and rec.get("decode_attention") is not None:
            check(rec["decode_attention"] == "plain", f"8b {what}: the dry run took {rec['decode_attention']}")
        if rec["arch"] == "rwkv6-7b":
            n = got["launches"]["wkv6"]
            print(f"8b K7 on the mesh: {n} launches at {got['k7_shapes']} (dry run {rec['kernel_calls']['wkv6']}); "
                  f"first call vs the plain scan on its local inputs: y {got['k7_err']:.3e} ({got['k7_bad']} "
                  f"outside 2^-7*|y| + 2^-8*max|y| of the row), S {got['k7_err_s']:.3e} ({got['k7_bad_s']} "
                  f"outside 1e-5*max|S| of the head)")
            check(n == rec["kernel_calls"]["wkv6"] == got["k7_n"] and n > 0,
                  f"8b K7 launches {n}, spied {got['k7_n']}, dry run {rec['kernel_calls']['wkv6']}")
            check(got["k7_shapes"] == [PROD_MESH_K7], f"8b K7 at {got['k7_shapes']}, not {PROD_MESH_K7}")
            check(got["k7_bad"] == 0 and got["k7_bad_s"] == 0, "8b K7 off its plain version on the mesh")
            k7_launches = n
    print(f"phase 8b: {time.perf_counter() - t_phase:.1f} s")
    return {"wkv6": k7_launches}


def _ulps(torch, a, b):
    """Entrywise distance between ``a`` and ``b`` (one floating dtype) in
    representable steps of that dtype: each value's bits as a signed
    integer, negatives mirrored so that the integers run in the floats'
    order."""
    ints = {2: torch.int16, 4: torch.int32}[a.element_size()]
    top = (1 << (8 * a.element_size() - 1)) - 1

    def key(x):
        i = x.contiguous().view(ints).to(torch.int64)
        mag = i & top
        return torch.where(i < 0, -mag, mag)

    return (key(a) - key(b)).abs()


def _tf32(torch, x):
    """fp32 -> TF32 by clearing the 13 low mantissa bits (toward zero), as
    K7 forms the high part of an operand and as the tensor cores read one."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _mma3(torch, a, b, exact_b: bool):
    """a (.., M, K) @ b (.., K, N) as K7's 3xTF32 products: each k-step of 8
    a fresh fp32 sum lo.hi + hi.lo + hi.hi of the exact splits x = hi + lo
    (no hi.lo where b is exact in TF32, as bf16 v is), added to the total."""
    out = None
    for k0 in range(0, a.shape[-1], 8):
        ak, bk = a[..., k0 : k0 + 8], b[..., k0 : k0 + 8, :]
        ahi, bhi = _tf32(torch, ak), _tf32(torch, bk)
        d = _tf32(torch, ak - ahi) @ bhi
        if not exact_b:
            d = d + ahi @ _tf32(torch, bk - bhi)
        d = d + ahi @ bhi
        out = d if out is None else out + d
    return out


def k7_arith(torch, r, k, v, w, u, s0, chunk: int = 16):
    """The WKV6 recurrence in K7's chunked arithmetic (``csrc/wkv6.cu``),
    in torch without K7: per chunk of ``chunk`` tokens (a last partial one
    padded with r = k = v = 0, w = 1), r~ = r * prod_{m<t} w_m, k~_s = k_s *
    prod_{s<m<chunk} w_m and the chunk's decay D from running products, the
    triangle A_ts = sum_i r_ti k_si prod_{s<m<t} w_mi (A_tt the bonus
    r . (u * k)), then y = R~ S + A V and S <- D S + K~^T V, the products
    as ``_mma3``.  -> (y (B, T, H, hd) fp32, final state fp32), the plain
    scan's outputs."""
    b, t, h, hd = r.shape
    exact_v = v.dtype == torch.bfloat16
    r, k, v, w = (x.float().permute(0, 2, 1, 3) for x in (r, k, v, w))  # (B, H, T, hd)
    s, u = s0.float().clone(), u.float()
    ones = torch.ones(b, h, hd, device=r.device)
    ys = []
    for c0 in range(0, t, chunk):
        tc = min(chunk, t - c0)
        rc, kc, vc, wc = (x[:, :, c0 : c0 + tc] for x in (r, k, v, w))
        if tc < chunk:
            pad = torch.zeros(b, h, chunk - tc, hd, device=r.device)
            rc, kc, vc = (torch.cat([x, pad], 2) for x in (rc, kc, vc))
            wc = torch.cat([wc, torch.ones_like(pad)], 2)
        rt, kt = torch.empty_like(rc), torch.empty_like(kc)
        p = ones
        for i in range(chunk):
            rt[:, :, i] = rc[:, :, i] * p
            p = p * wc[:, :, i]
        dec, p = p, ones
        for i in reversed(range(chunk)):
            kt[:, :, i] = kc[:, :, i] * p
            p = p * wc[:, :, i]
        a = torch.zeros(b, h, chunk, chunk, device=r.device)
        kp = kc.clone()
        for i in range(chunk):
            a[:, :, i, i] = (rc[:, :, i] * u[None] * kc[:, :, i]).sum(-1)
            if i:
                a[:, :, i, :i] = (rc[:, :, i, None, :] * kp[:, :, :i]).sum(-1)
                kp[:, :, :i] = kp[:, :, :i] * wc[:, :, i, None, :]
        y = _mma3(torch, rt, s, False) + _mma3(torch, a, vc, exact_v)
        s = dec[..., None] * s + _mma3(torch, kt.transpose(-1, -2), vc, exact_v)
        ys.append(y[:, :, :tc])
    return torch.cat(ys, 2).permute(0, 2, 1, 3), s


def _to_float(torch, tree):
    if isinstance(tree, torch.Tensor):
        return tree.float()
    if isinstance(tree, dict):
        return {k: _to_float(torch, v) for k, v in tree.items()}
    return [_to_float(torch, v) for v in tree]


def main() -> int:
    with contextlib.ExitStack() as stack:  # phase 7's workers and files, ended also when a phase fails
        return _run(stack)


def _run(stack: contextlib.ExitStack) -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from repro_torch.configs import paper_cnn
    from repro_torch.core import selection, similarity
    from repro_torch.data import make_image_dataset, skewness_partition
    from repro_torch.fl import engine, rounds
    from repro_torch.fl.trainer import FLTrainer
    from repro_torch.kernels import _build
    from repro_torch.kernels.gram import ops as gram_ops
    from repro_torch.kernels.gram import ref as gram_ref
    from repro_torch.kernels.pairwise_l2 import ops as pw_ops
    from repro_torch.kernels.flash_attention import ops as fd_ops
    from repro_torch.kernels.flash_attention import ref as fd_ref
    from repro_torch.kernels.pairwise_l2 import ref as pw_ref
    from repro_torch.kernels.rwkv6_scan import ops as wkv_ops
    from repro_torch.kernels.rwkv6_scan import ref as wkv_ref
    from repro_torch.models import cnn

    t_start = time.perf_counter()
    dev = torch.device("cuda")

    # ---------------------------------------------------- 1. card and build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(
        f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}"
    )
    t0 = time.perf_counter()
    logs = _build.build_all()
    for name in _build.SOURCES:
        _build.library(name)
    for name in _build.BINDINGS:
        _build.binding(name)
    print(f"built {list(_build.SOURCES)} for sm_90a and {list(_build.BINDINGS)} in {time.perf_counter() - t0:.2f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Performance Loss" in line:
                print(f"  {name}: {line.strip()}")
    # K6's bf16 kernel runs on the tensor cores: its SASS holds K6_TC_OP
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(_build._target("flash_attention"))],
                          capture_output=True, text=True, check=True).stdout
    ops = {op: len(re.findall(rf"\b{op}\b", sass)) for op in ("HGMMA", "HMMA")}
    print(f"K6 SASS ({cuobjdump.name} -sass): " + ", ".join(f"{op} {n}" for op, n in ops.items()))
    check(ops[K6_TC_OP] > 0, f"no {K6_TC_OP} in K6's SASS: the bf16 kernel is off the tensor cores")

    # ------------------------------------- 2. kernels against plain versions
    dtypes = {"fp32": torch.float32, "bf16": torch.bfloat16}
    rows = {"pairwise_dists_stats": {}, "normalized_gram": {}}
    for c, q, kind in SHAPES:
        g = torch.Generator().manual_seed(c * 7919 + q)
        f = torch.randn(c, q, generator=g).to(dtypes[kind]).to(dev)
        compute = dtypes[kind]

        # K1 on its own
        s0, lo, hi = pw_ops.pairwise_dists_stats(f)
        torch.cuda.synchronize()
        ws0, wlo, whi = pw_ref.pairwise_dists_stats_ref(f)
        err1 = float((s0 - ws0).abs().max())
        check(float(lo) == 0.0 and float(wlo) == 0.0, f"K1 lo != 0 at {c}x{q}")
        check(abs(float(hi) - float(whi)) <= 1e-5 * float(whi), f"K1 hi off at {c}x{q}")
        # fp32 sums over Q in another order: ~1e-6 relative on the distances
        check(
            bool(torch.all((s0 - ws0).abs() <= 1e-5 * ws0.abs() + 1e-5 * float(whi))),
            f"K1 S0 off at {c}x{q}: {err1}",
        )

        # one launch, symmetric and repeatable; the range K1 writes for K2
        k1_plan = check_pairwise_call(torch, lambda: pw_ops.pairwise_dists_stats(f), c, q, f"K1 {c}x{q} {kind}")
        _, klo, khi, krng = pw_ops.pairwise_dists_range(f)
        check(torch.equal(krng, torch.clamp_min(khi - klo, 1e-30)), f"K1 range at {c}x{q}")

        # K2 on its own, on the same inputs as its plain version
        rng = torch.clamp_min(whi - wlo, 1e-30)
        lk = gram_ops.normalized_gram(ws0, wlo, rng, c, compute)
        torch.cuda.synchronize()
        wl = gram_ref.normalized_gram_ref(ws0, wlo, rng, c, compute)
        err2 = float((lk - wl).abs().max())
        # the same rounded S on both sides; fp32 sums over c terms in another order
        check(err2 <= 1e-5 + 1e-4 * float(wl.abs().max()), f"K2 off at {c}x{q}: {err2}")
        check(torch.equal(lk, lk.T), f"K2 not exactly symmetric at {c}x{q}")

        # the two-launch pipeline against the plain chain
        lp = gram_ops.kernel_from_profiles(f)
        torch.cuda.synchronize()
        wp = gram_ref.kernel_from_profiles_ref(f)
        errp = float((lp - wp).abs().max())
        lmax = float(wp.abs().max())
        if kind == "bf16":
            tol = 3e-2 * lmax  # bf16 products vs the fp32 chain: the JAX test's bound
        elif (c, q, kind) in SHAPES[:2] + TRAIN_K1_SHAPES:
            tol = None  # a main path's shape: rtol 1e-5 / atol 1e-5 elementwise
            check(
                bool(torch.all((lp - wp).abs() <= 1e-5 + 1e-5 * wp.abs())),
                f"L off at {c}x{q}: {errp}",
            )
        else:
            tol = 1e-4 * lmax  # sums over up to 4096 terms in another order
        if tol is not None:
            check(errp <= tol, f"L off at {c}x{q}: {errp} > {tol}")

        pipe_ms = time_ms(torch, lambda: gram_ops.kernel_from_profiles(f))
        pipe = device_kernels(torch, lambda: gram_ops.kernel_from_profiles(f))
        check(len(pipe) == 2, f"kernel_from_profiles at {c}x{q} launched {pipe}")
        r1, r2 = k1_k2_rows(torch, f, ws0, wlo, rng, compute, kind)
        r1.update(max_abs_err=err1, plan=k1_plan)
        r2["max_abs_err"] = err2
        rows["pairwise_dists_stats"][(c, q, kind)] = r1
        rows["normalized_gram"][(c, q, kind)] = r2
        print(
            f"kernels C={c} Q={q} {kind}: "
            f"K1 {k1_plan}; err={err1:.3e} ms={r1['ms']:.5f} device_ms cold={fmt_ms(r1['device_ms'])} "
            f"hot={fmt_ms(r1['device_ms_hot'])} plain={r1['plain_ms']:.5f} cdist={r1['library_ms']:.5f} "
            f"bound={r1['bound_ms']:.6f} ({r1['bound_by']}){share(r1['bound_ms'], r1['device_ms'], f'K1 {c}x{q} {kind}')} | "
            f"K2 err={err2:.3e} ms={r2['ms']:.5f} device_ms={fmt_ms(r2['device_ms'])} plain={r2['plain_ms']:.5f} "
            f"mm={r2['library_ms']:.5f} bound={r2['bound_ms']:.6f} ({r2['bound_by']}) | "
            f"pipeline err={errp:.3e} (max|L|={lmax:.4g}) ms={pipe_ms:.5f} ({len(pipe)} kernels)"
        )

    # K3 and K4 on their own against their plain versions
    rows.update(k3_k4_rows(torch, dev))

    # K5 on its own against its plain version, with SDPA as the yardstick
    import torch.nn.functional as F

    decode_rows = []
    for b, s, h, hk, hd, kind, lengths in DECODE_SHAPES:
        gen = torch.Generator().manual_seed(b * 7919 + s)
        q, k, v = (
            torch.randn(shape, generator=gen).to(dtypes[kind]).to(dev)
            for shape in ((b, 1, h, hd), (b, s, hk, hd), (b, s, hk, hd))
        )
        if lengths is None:
            lengths = [0, s] + torch.randint(1, s, (b - 2,), generator=gen).tolist()
        elif lengths == "full":
            lengths = [s] * b
        ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
        got = fd_ops.flash_decode(q, k, v, ln)
        torch.cuda.synchronize()
        want = fd_ref.decode_attention_ref(q, k, v, ln)
        diff = (got.float() - want.float()).abs()
        err = float(diff.max())
        if kind == "fp32":
            tol = 1e-5  # the JAX flash-decode test's bound
            check(err <= tol, f"K5 off at {(b, s, h, hk, hd, kind)}: {err} > {tol}")
        else:
            # both compute in fp32 from the same bf16 inputs and round once
            # to bf16 at the end, so they part by at most one bf16 step of
            # the output element (<= 2^-7 of |out|) plus the fp32 sums'
            # order, which the absolute term 2^-8 * max|out of the slot|
            # covers near 0 (per slot: a slot of length 1 returns v itself,
            # a long slot outputs far smaller values)
            wf = want.float()
            atol = 2.0**-8 * wf.abs().amax(dim=(1, 2, 3), keepdim=True)
            tol = float(atol.max())
            bad = int((diff > 2.0**-7 * wf.abs() + atol).sum())
            check(bad == 0, f"K5 off at {(b, s, h, hk, hd, kind)}: {bad} elements, max {err}")
        check(bool(torch.all(got[ln == 0] == 0)), f"K5 empty slot not zero at {(b, s)}")
        mask = (torch.arange(s, device=dev)[None, :] < ln[:, None])[:, None, None, :]
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        k5_ms = time_ms(torch, lambda: fd_ops.flash_decode(q, k, v, ln))
        # the KV split and, with more than one split, the merge kernel
        splits, split_len = fd_ops.decode_plan(b, s, h, hk, hd, kind == "bf16")
        kernels = 2 if splits > 1 else 1
        k5_hot = device_ms(torch, lambda: fd_ops.flash_decode(q, k, v, ln), "flash_decode", per_call=kernels)
        k5_dev = device_ms(torch, lambda: fd_ops.flash_decode(q, k, v, ln), "flash_decode", per_call=kernels,
                           cold=True)
        k5_plain = time_ms(torch, lambda: fd_ref.decode_attention_ref(q, k, v, ln))
        k5_lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True))
        # least work: the valid K/V prefix read once, q read and out written
        # once; 4 FLOPs per valid entry, query head and dimension, in fp32
        valid = sum(min(x, s) for x in lengths)
        esize = q.element_size()
        b5 = bound(valid * hk * hd * 2 * esize + 2 * b * h * hd * esize + 4 * b,
                   4.0 * valid * h * hd, "fp32")
        decode_rows.append(dict(
            max_abs_err=err, ms=k5_ms, device_ms=k5_dev, plain_ms=k5_plain,
            library_ms=k5_lib, bound_ms=b5[0], bound_by=b5[1],
        ))
        print(
            f"K5 B={b} S={s} H={h} Hk={hk} hd={hd} {kind} valid={valid}: err={err:.3e} "
            f"(tol {'2^-7*|out| + at most ' if kind == 'bf16' else ''}{tol:.3e}) ms={k5_ms:.5f} "
            f"splits={splits}x{split_len} device_ms cold={fmt_ms(k5_dev)} hot (L2-resident, not held to the bound)={fmt_ms(k5_hot)} "
            f"({kernels} kernel{'s' if kernels > 1 else ''}) plain={k5_plain:.5f} sdpa={k5_lib:.5f} "
            f"bound={b5[0]:.6f} ({b5[1]}){share(b5[0], k5_dev, f"K5 {(b, s, kind)}")}"
        )

    # K6 on its own against its plain version, with SDPA as the yardstick
    attn_rows = {}
    for b, s, h, hk, hd, kind, window in ATTN_SHAPES:
        gen = torch.Generator().manual_seed(b * 7919 + s + hd)
        q, k, v = (
            torch.randn(shape, generator=gen).to(dtypes[kind]).to(dev)
            for shape in ((b, s, h, hd), (b, s, hk, hd), (b, s, hk, hd))
        )
        got = fd_ops.flash_attention(q, k, v, window=window)
        torch.cuda.synchronize()
        want = fd_ref.attention_ref(q, k, v, window=window)
        diff = (got.float() - want.float()).abs()
        err = float(diff.max())
        if kind == "fp32":
            tol = 1e-5  # fp32 sums in another order
            check(err <= tol, f"K6 off at {(b, s, h, hk, hd, kind, window)}: {err} > {tol}")
        else:
            # the kernel takes bf16 products with fp32 sums on the tensor
            # cores and carries the unnormalised probabilities (each <= 1)
            # into the PV product as two bf16 halves, which hold them to
            # 2^-17; the plain version is fp32 throughout.  Both round the
            # output once: one bf16 step of each output element (<= 2^-7 of
            # |out|), plus the sums' order near 0, within 2^-8 of the
            # largest output of the same query row (per row: row 0 returns
            # v[0] itself, a late row of a long sequence outputs far smaller
            # values)
            wf = want.float()
            atol = 2.0**-8 * wf.abs().amax(dim=-1, keepdim=True)
            tol = float(atol.max())
            bad = int((diff > 2.0**-7 * wf.abs() + atol).sum())
            check(bad == 0, f"K6 off at {(b, s, h, hk, hd, kind, window)}: {bad} elements, max {err}")
        pos = torch.arange(s, device=dev)
        mask = pos[None, :] <= pos[:, None]
        if window is not None:
            mask &= pos[None, :] > pos[:, None] - window
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        if window is None:
            sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
        else:
            sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=True)
        big = b * s * s * h * hd > 3e10  # the hd-256 shape: fewer timed calls
        reps = dict(launches=10, repeats=3, warmup=2) if big else {}
        k6_ms = time_ms(torch, lambda: fd_ops.flash_attention(q, k, v, window=window), **reps)
        k6_dev = device_ms(torch, lambda: fd_ops.flash_attention(q, k, v, window=window), "flash_attention",
                           calls=reps.get("launches", 20))
        k6_cold = None
        if (b, s, h, hk, hd, kind, window) in TRAIN_ATTN_SHAPES + MESH_ATTN_SHAPES:
            k6_cold = device_ms(torch, lambda: fd_ops.flash_attention(q, k, v, window=window), "flash_attention",
                                cold=True)
        k6_plain = time_ms(torch, lambda: fd_ref.attention_ref(q, k, v, window=window), **reps)
        k6_lib = time_ms(torch, sdpa, **reps)
        # least work: q, k, v read once and out written once; 4 FLOPs per
        # attended (query, key) pair, head and dimension (QK^T and PV), at
        # the peak of the inputs' type
        pairs = int(mask.sum())
        esize = q.element_size()
        b6 = bound(2 * b * s * (h + hk) * hd * esize, 4.0 * b * h * hd * pairs, kind)
        attn_rows[(b, s, h, hk, hd, kind, window)] = dict(
            max_abs_err=err, ms=k6_ms, device_ms=k6_dev, device_ms_cold=k6_cold, plain_ms=k6_plain,
            library_ms=k6_lib, bound_ms=b6[0], bound_by=b6[1],
        )
        print(
            f"K6 B={b} S={s} H={h} Hk={hk} hd={hd} {kind} window={window}: err={err:.3e} "
            f"(tol {'2^-7*|out| + at most ' if kind == 'bf16' else ''}{tol:.3e}) ms={k6_ms:.5f} "
            f"device_ms={fmt_ms(k6_dev)}{'' if k6_cold is None else f' cold={fmt_ms(k6_cold)}'} "
            f"plain={k6_plain:.5f} sdpa={k6_lib:.5f} bound={b6[0]:.6f} ({b6[1]}) "
            f"= {b6[0] / k6_ms:.4f} of the kernel's time"
            + ("" if k6_cold is None else share(b6[0], k6_cold, f"K6 {(b, s, h, hk, hd, kind)}"))
        )

    # K7 on its own against its plain version; no PyTorch call computes WKV6
    wkv_rows = {}
    for b, t, h, hd, kind, decays in WKV_SHAPES:
        gen = torch.Generator().manual_seed(b * 7919 + t + hd)
        r, k, v = (torch.randn(b, t, h, hd, generator=gen).to(dtypes[kind]).to(dev) for _ in range(3))
        if kind == "fp32":  # the JAX test's decays
            w = 0.4 + 0.59 * torch.rand(b, t, h, hd, generator=gen)
        else:  # the model's law, exp(-exp(z)), from its fastest decays to its slowest
            w = torch.exp(-torch.exp(torch.rand(b, t, h, hd, generator=gen) * 6.0 - 6.0))
        if decays == "edge":
            w[..., 0::5] = torch.exp(-torch.exp(torch.tensor(8.0)))
            w[..., 1::5] = 1.0 - 1e-7
            check(bool((w[..., 0::5] == 0).all()), "the clamped decay is not exactly 0 in fp32")
        u = torch.randn(h, hd, generator=gen)
        s0 = torch.randn(b, h, hd, hd, generator=gen)  # a state carried in from earlier tokens
        w, u, s0 = w.to(dev), u.to(dev), s0.to(dev)
        got_y, got_s = wkv_ops.wkv6(r, k, v, w, u, s0)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got_y.float()).all() and torch.isfinite(got_s).all()),
              f"K7 non-finite at {(b, t, h, hd, kind, decays)}")
        want_y, want_s = wkv_ref.wkv6_scan_ref(r, k, v, w, u, s0)
        want_y = want_y.to(r.dtype)
        dy = (got_y.float() - want_y.float()).abs()
        ds = (got_s - want_s).abs()
        err_y, err_s = float(dy.max()), float(ds.max())
        if kind == "fp32":
            tol = 5e-4  # the JAX sweep's bound
            check(max(err_y, err_s) <= tol, f"K7 off at {(b, t, h, hd, kind)}: y {err_y}, S {err_s}")
        else:
            # y: one bf16 step of each element (<= 2^-7 of |y|), plus the
            # fp32 sums' order near 0 within 2^-8 of the largest |y| of the
            # same (b, t, h) row: both compute in fp32 from the same bf16
            # inputs and round y once.  S: within 1e-5 of its (b, h) head's
            # largest |S|: the two round each step's w S + k v differently
            # (one fma against a product and a sum), about one fp32 step of
            # |S| a step, and the decay forgets old steps' rounding
            wf = want_y.float()
            atol = 2.0**-8 * wf.abs().amax(dim=-1, keepdim=True)
            tol = float(atol.max())
            bad = int((dy > 2.0**-7 * wf.abs() + atol).sum())
            bad_s = int((ds > 1e-5 * want_s.abs().amax(dim=(2, 3), keepdim=True)).sum())
            check(bad == 0 and bad_s == 0,
                  f"K7 off at {(b, t, h, hd, kind)}: {bad} y elements (max {err_y}), {bad_s} S elements (max {err_s})")
        k7_ms = time_ms(torch, lambda: wkv_ops.wkv6(r, k, v, w, u, s0))
        # the chunked design with more than one slice launches two kernels
        # (A of every chunk, then the chunks in order); with one slice, or
        # the recurrent design, one
        slices = wkv_ops.design(b, t, h, hd)
        kernels = 2 if slices > 1 else 1
        k7_hot = device_ms(torch, lambda: wkv_ops.wkv6(r, k, v, w, u, s0), "wkv6", per_call=kernels)
        k7_dev = device_ms(torch, lambda: wkv_ops.wkv6(r, k, v, w, u, s0), "wkv6", per_call=kernels,
                           cold=True)
        # the chunked design's two kernels apart, cold
        split = "" if kernels == 1 else " (triangle {}, chunks {})".format(*(fmt_ms(device_ms(
            torch, lambda: wkv_ops.wkv6(r, k, v, w, u, s0), mark, cold=True))
            for mark in ("wkv6_triangle", "wkv6_chunked")))
        # the plain loop launches ~6 kernels per token: fewer timed calls
        reps = dict(launches=1, repeats=3, warmup=1) if t > 16 else {}
        k7_plain = time_ms(torch, lambda: wkv_ref.wkv6_scan_ref(r, k, v, w, u, s0), **reps)
        # least work: r, k, v and w read once, y written once, the state
        # read and written once, u read once.  Per (b, t, h) the recurrence
        # needs 5 hd^2 fp32 FLOPs, r^T S (2 hd^2) and w_i S_ij + k_i v_j
        # (3 hd^2), and 4 hd for the bonus taken as (r . (u * k)) v.  Where
        # the chunked design runs, its two products (R~ S and K~^T V, 2 hd^2
        # each) on the tensor cores may take less: 3xTF32 for R~ S, and two
        # TF32 products (bf16 v, exact in TF32) or three (fp32 v) for K~^T
        # V, at TF32's peak; the smaller of the two counts
        esize = r.element_size()
        seq = b * t * h * hd
        nbytes = seq * (4 * esize + 4) + 2 * b * h * hd * hd * 4 + h * hd * 4
        b7 = bound(nbytes, (5.0 * hd * hd + 4.0 * hd) * h * b * t, "fp32")
        if slices:
            b7 = min(b7, bound(nbytes, (3 + (2 if kind == "bf16" else 3)) * 2.0 * hd * hd * h * b * t, "tf32"))
        wkv_rows[(b, t, kind, decays)] = dict(
            max_abs_err=err_y, ms=k7_ms, device_ms=k7_dev, plain_ms=k7_plain,
            library_ms=None, bound_ms=b7[0], bound_by=b7[1], design=slices,
        )
        print(
            f"K7 B={b} T={t} H={h} hd={hd} {kind}{' decays ' + decays if decays else ''} "
            f"{f'chunked x{slices} slices' if slices else 'recurrent'}: err y={err_y:.3e} S={err_s:.3e} "
            f"(tol {'2^-7*|y| + at most ' if kind == 'bf16' else ''}{tol:.3e}{'' if kind == 'fp32' else ', S 1e-5*max|S| of the head'}) "
            f"ms={k7_ms:.5f} device_ms cold={fmt_ms(k7_dev)}{split} hot (L2-resident, not held to the bound)={fmt_ms(k7_hot)} plain={k7_plain:.5f} "
            f"library=none bound={b7[0]:.6f} ({b7[1]}){share(b7[0], k7_dev, f"K7 {(b, t, kind, decays)}")}"
        )
    # the state hand-off: two halves == one shot, at the JAX test's bound
    gen = torch.Generator().manual_seed(17)
    r, k, v = (torch.randn(1, 32, 2, 16, generator=gen).to(dev) for _ in range(3))
    w = (0.5 + 0.49 * torch.rand(1, 32, 2, 16, generator=gen)).to(dev)
    u = torch.randn(2, 16, generator=gen).to(dev)
    s0 = torch.zeros(1, 2, 16, 16, device=dev)
    y_full, s_full = wkv_ops.wkv6(r, k, v, w, u, s0)
    y1, s_mid = wkv_ops.wkv6(*(x[:, :16].contiguous() for x in (r, k, v, w)), u, s0)
    y2, s_end = wkv_ops.wkv6(*(x[:, 16:].contiguous() for x in (r, k, v, w)), u, s_mid)
    torch.cuda.synchronize()
    e_hand = max(float((torch.cat([y1, y2], 1) - y_full).abs().max()), float((s_end - s_full).abs().max()))
    print(f"K7 state hand-off (1, 16 + 16, 2, 16) fp32: two halves vs one shot {e_hand:.3e} (bound 1e-4)")
    check(e_hand <= 1e-4, f"K7 state hand-off off by {e_hand}")

    # phase 7's dry runs take the host's cores from here, beside phases 3-3e
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    parity_dir = stack.enter_context(tempfile.TemporaryDirectory(dir=build))
    pool = stack.enter_context(multiprocessing.get_context("spawn").Pool(DRY_WORKERS))
    dry_jobs = start_dry_runs(pool, parity_dir)

    # --------------------------------------------------------- 3. main path
    exp = paper_cnn.paper_scale()
    c, cp = exp.num_clients, exp.clients_per_round
    t0 = time.perf_counter()
    ds = make_image_dataset(n=c * exp.samples_per_client, seed=11, noise=0.5)
    shards = skewness_partition(
        ds.ys, c, 0.8, ds.num_classes, samples_per_client=exp.samples_per_client, seed=0
    )
    client_xs = np.stack([ds.xs[s] for s in shards])
    client_ys = np.stack([ds.ys[s] for s in shards])
    print(f"data: {client_xs.shape} images in {time.perf_counter() - t0:.2f} s")

    class RecordingDPP(selection.DPPSelection):
        """FL-DP³S, keeping each round's cohort for the checks below."""

        def __init__(self):
            super().__init__()
            self.cohorts = []

        def draw_fn(self, generator, state, k):
            sel = super().draw_fn(generator, state, k)
            self.cohorts.append(sel.tolist())
            return sel

    strategy = RecordingDPP()
    cfg = paper_cnn.fl_config(exp, seed=0)
    check(cfg.use_pallas_kernel, "the paper config does not route through K1 + K2")
    params = cnn.init_cnn(
        torch.Generator(device=dev).manual_seed(0),
        channels=exp.cnn_channels, fc1_dim=exp.fc1_dim,
    )

    _build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer = FLTrainer(
        cfg, params, cnn.cnn_loss, cnn.apply_with_features, client_xs, client_ys,
        strategy, accuracy_fn=cnn.accuracy,
    )
    torch.cuda.synchronize()
    init_launches = dict(_build.LAUNCHES)
    print(
        f"init (profiles, kernel, losses) on {trainer.device}: "
        f"{time.perf_counter() - t0:.3f} s, launches {init_launches}"
    )
    for _ in range(ROUNDS):
        t0 = time.perf_counter()
        hist = trainer.run(rounds=1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        print(
            f"round {hist['round'][-1]}: {wall:.3f} s  cohort={strategy.cohorts[-1]} "
            f"loss={hist['loss'][-1]:.4f} acc={hist['acc'][-1]:.4f} gemd={hist['gemd'][-1]:.4f}"
        )
    launches = dict(_build.LAUNCHES)
    print(f"launches on the main path: {launches}")

    check(trainer.device.type == "cuda", "the trainer did not run on the card")
    for name in FL_KERNELS:
        check(init_launches[name] >= 1, f"{name} did not run during _init_profiles")
    check(
        all(launches[n] == 0 for n in ("flash_decode", "wkv6", "pairwise_sq_dists", "gram")),
        f"K3, K4, K5 or K7 ran on the FL path: {launches}",
    )
    check(len(strategy.cohorts) == ROUNDS, "not one cohort per round")
    for cohort in strategy.cohorts:
        check(
            len(cohort) == cp and len(set(cohort)) == cp and all(0 <= i < c for i in cohort),
            f"bad cohort {cohort}",
        )
    check(hist["round"] == list(range(1, ROUNDS + 1)), f"rounds {hist['round']}")
    check(all(math.isfinite(v) for v in hist["loss"]), f"losses {hist['loss']}")
    check(all(0.0 <= v <= 1.0 for v in hist["acc"]), f"accuracies {hist['acc']}")
    check(all(0.0 <= v <= 2.0 for v in hist["gemd"]), f"GEMDs {hist['gemd']}")
    check(bool(torch.all(torch.isfinite(trainer.losses))), "non-finite client losses")
    kern = trainer.round_state.kernel
    prof = trainer.round_state.profiles
    check(tuple(prof.shape) == (c, exp.fc1_dim) and tuple(kern.shape) == (c, c), "shapes")
    want = gram_ref.kernel_from_profiles_ref(prof)
    exact = similarity.kernel_from_profiles(prof.double())  # plain chain in fp64
    kerr = float((kern - want).abs().max())
    lmax = float(want.abs().max())
    kerr64 = float((kern.double() - exact).abs().max())
    perr64 = float((want.double() - exact).abs().max())
    # FC-1 profiles lie close together relative to their norms, so the plain
    # chain's expansion |a|^2 + |b|^2 - 2ab cancels in fp32 and K1's direct
    # sum of (a - b)^2 does not: the two differ by about 1e-5 of max|L|
    # here, and the bound of the larger shapes above applies.  The kernel
    # must be no further from an fp64 chain than the plain chain is.
    check(kerr <= 1e-4 * lmax, f"kernel off: {kerr} > 1e-4 * {lmax}")
    check(kerr64 <= perr64, f"kernel {kerr64} further from fp64 than the plain chain {perr64}")
    print(
        f"main-path kernel vs plain chain: max abs err {kerr:.3e} (max|L|={lmax:.4g}); "
        f"vs fp64 chain: kernel {kerr64:.3e}, plain {perr64:.3e}"
    )

    # where a round's time goes: its three parts once more, each timed on
    # the host clock up to a synchronise, after the run (no kernel launches)
    def host_s(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0, out

    t_sel, sel = host_s(lambda: strategy.draw_fn(trainer.generator, trainer.selection_state(), cp))
    step = rounds.build_client_parallel_round(
        lambda p, batch: cnn.cnn_loss(p, batch[0], batch[1]), cfg.lr, cfg.local_epochs
    )
    batches = engine.make_client_batches(cfg, trainer.generator, trainer.client_xs, trainer.client_ys, sel)
    t_local, _ = host_s(lambda: step(trainer.params, batches, trainer.client_sizes[sel.long()]))
    xs_all = trainer.client_xs.reshape((-1,) + trainer.client_xs.shape[2:])
    t_eval, _ = host_s(lambda: cnn.accuracy(trainer.params, xs_all, trainer.client_ys.reshape(-1)))
    print(
        f"round parts (host clock): k-DPP draw {t_sel:.4f} s, local updates of "
        f"{cp} clients {t_local:.4f} s, accuracy over {xs_all.shape[0]} samples {t_eval:.4f} s"
    )

    # ----------------------------- 3b. the stage-wise eq.-14 path (K3, K4)
    stage_launches = stage_wise_phase(
        torch, dev, trainer, exp,
        cnn.init_cnn(torch.Generator(device=dev).manual_seed(0), channels=exp.cnn_channels, fc1_dim=exp.fc1_dim),
    )

    # ------------------------------------ 3c. the paper's baseline comparison
    baselines_phase(torch, exp, client_xs, client_ys)

    # ------------------------------------------- 3d. the federation engine
    funnel_rows, unfunnelled = engine_phase(torch, exp, client_xs, client_ys, ds)

    # --------------------------------- 3e. robustness and checkpoints
    # a worker runs phase 7's steps on the card meanwhile (3e holds little of
    # the card's memory); the pool is joined, and the worker's CUDA context
    # ended, before phase 4 needs the card's memory
    card_job = pool.apply_async(card_steps, (dry_jobs["decode cut"].get()[-1]["batch"],))
    t0 = time.perf_counter()
    robust_phase(torch, exp, client_xs, client_ys)
    print(f"phase 3e: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    card = card_job.get()
    pool.close()
    pool.join()
    card_wait = time.perf_counter() - t0
    print(f"phase 7's steps on the card ended {card_wait:.1f} s after phase 3e")

    # ------------------------------------------- 4. the serving main path
    serve_launches, _, _ = serve_phase(torch, dev, "smollm-360m")

    # ------------------------------------------------ 5. the LM client path
    lm_launches = lm_phase(torch, dev)

    # ------------- 5b. the LM client path and pretrain of the six later archs
    # each model is freed before the next one is built
    trained = {}
    for arch in TRAIN_PATHS:
        gc.collect()
        torch.cuda.empty_cache()
        trained[arch] = train_phase(torch, dev, arch)
    print("phase 5b (s): " + ", ".join(f"{a} {r['seconds']:.1f}" for a, r in trained.items())
          + f"; {sum(r['seconds'] for r in trained.values()):.1f} in all")

    # ------------------------------------------ 6. the RWKV-6 serving path
    # the earlier phases' models are out of scope: hand their memory back
    # before the RWKV model and its fp32 copy
    gc.collect()
    torch.cuda.empty_cache()
    rwkv_launches, rwkv_shapes, _ = serve_phase(torch, dev, "rwkv6-7b")

    # ---------------------- 6b. serving of the last model slice's five archs
    # each model is freed before the next one loads
    new_serve = {}
    for arch in NEW_SERVE_ARCHS:
        gc.collect()
        torch.cuda.empty_cache()
        new_serve[arch] = serve_phase(torch, dev, arch)
    gc.collect()
    torch.cuda.empty_cache()
    print("serving phases (s): " + ", ".join(f"{a} {new_serve[a][2]:.1f}" for a in NEW_SERVE_ARCHS))

    # ------------------------------------------------- 6c. observability
    obs_phase(torch, dev, exp, client_xs, client_ys)

    # ----------------------------------------- 7. the dry run against the card
    gc.collect()
    torch.cuda.empty_cache()
    dryrun_phase(torch, dev, dry_jobs, card, card_wait, parity_dir)

    # ------------------------------------------------------- 8. the client mesh
    gc.collect()
    torch.cuda.empty_cache()
    mesh_launches = mesh_phase(torch, dev, exp, client_xs, client_ys, ds)

    # ------------------------------------------- 8b. the production mesh
    gc.collect()
    torch.cuda.empty_cache()
    prod_launches = prod_mesh_phase(smi)

    # ---------------------------------------------------------- 9. results
    main_shape = SHAPES[0]
    sources = {
        "pairwise_dists_stats": (
            "src/repro_torch/kernels/csrc/pairwise_l2.cu",
            "src/repro/kernels/pairwise_l2/pairwise_l2.py:127",
            rows["pairwise_dists_stats"][main_shape], launches["pairwise_dists_stats"],
        ),
        "normalized_gram": (
            "src/repro_torch/kernels/csrc/gram.cu",
            "src/repro/kernels/gram/gram.py:104",
            rows["normalized_gram"][main_shape], launches["normalized_gram"],
        ),
        "pairwise_sq_dists": (
            "src/repro_torch/kernels/csrc/pairwise_l2.cu",
            "src/repro/kernels/pairwise_l2/pairwise_l2.py:58",
            rows["pairwise_sq_dists"][K3_SHAPES[0]], stage_launches["pairwise_sq_dists"],
        ),
        "gram": (
            "src/repro_torch/kernels/csrc/gram.cu",
            "src/repro/kernels/gram/gram.py:51",
            rows["gram"][K4_SHAPES[0]], stage_launches["gram"],
        ),
        "flash_decode": (
            "src/repro_torch/kernels/csrc/flash_decode.cu",
            "src/repro/kernels/flash_attention/decode.py:78",
            decode_rows[0],
            serve_launches,
        ),
        "flash_attention": (
            "src/repro_torch/kernels/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention/flash_attention.py:86",
            attn_rows[ATTN_SHAPES[0]],
            lm_launches,
        ),
        "wkv6": (
            "src/repro_torch/kernels/csrc/wkv6.cu",
            "src/repro/kernels/rwkv6_scan/rwkv6_scan.py:63",
            wkv_rows[tuple(WKV_SHAPES[0][i] for i in (0, 1, 4, 5))],
            rwkv_launches,
        ),
    }
    # K5 at the decode shape of each new arch that reaches it: the last
    # step's (B, prompt + generated, H, Hk, hd), its launches on that arch's
    # serving path (scan and continuous)
    from repro_torch.configs import get_arch

    k5_new = {}
    for arch in NEW_SERVE_ARCHS:
        if SERVE_PATHS[arch][0] != "flash_decode":
            continue
        m = get_arch(arch).model
        shape = (SERVE_BATCH, SERVE_PROMPT + SERVE_GEN, m.num_heads, m.num_kv_heads, m.head_dim, "bf16", "full")
        check(shape in DECODE_SHAPES, f"K5 path shape {shape} of {arch} is not among DECODE_SHAPES")
        k5_new[arch] = (shape, decode_rows[DECODE_SHAPES.index(shape)], new_serve[arch][0])
        r = k5_new[arch][1]
        print(
            f"K5 path shape B={shape[0]} S={shape[1]} H={shape[2]} Hk={shape[3]} hd={shape[4]} ({arch}): "
            f"launches {new_serve[arch][0]}, ms {r['ms']:.5f}, device_ms cold {fmt_ms(r['device_ms'])}, "
            f"bound {r['bound_ms']:.6f} ({r['bound_by']}), plain {r['plain_ms']:.5f}, sdpa {r['library_ms']:.5f}"
        )
    # K6 at the refresh shape of each arch of phase 5b that reaches it, and
    # K1 at each of their profile widths: the path's launches beside the
    # shape's cold device time, bound and library call
    from repro_torch.configs import model_config

    k6_train = {}
    for arch, res in trained.items():
        depth, kernel = TRAIN_PATHS[arch]
        if kernel != "flash_attention":
            continue
        layers = int(depth[depth.index("--layers") + 1]) if "--layers" in depth else None
        m = model_config(arch, "--full-width" in depth, layers)
        shape = (LM_DOCS, TRAIN_SEQ, m.num_heads, m.num_kv_heads, m.head_dim,
                 "bf16" if m.dtype == "bfloat16" else "fp32", None)
        check(shape in TRAIN_ATTN_SHAPES, f"K6 path shape {shape} of {arch} is not among TRAIN_ATTN_SHAPES")
        k6_train[arch] = (shape, attn_rows[shape], res["launches"]["flash_attention"])
        r = attn_rows[shape]
        print(f"K6 path shape B={shape[0]} S={shape[1]} H={shape[2]} Hk={shape[3]} hd={shape[4]} {shape[5]} "
              f"({arch} refresh): launches {k6_train[arch][2]}, ms {r['ms']:.5f}, device_ms cold "
              f"{fmt_ms(r['device_ms_cold'])} hot {fmt_ms(r['device_ms'])}, bound {r['bound_ms']:.6f} "
              f"({r['bound_by']}), plain {r['plain_ms']:.5f}, sdpa {r['library_ms']:.5f}")
    k1_train = {shape: sum(1 for r in trained.values() if r["d_model"] == shape[1]) for shape in TRAIN_K1_SHAPES}
    check(sum(k1_train.values()) == len(trained), f"phase 5b's profile widths {k1_train} miss TRAIN_K1_SHAPES")
    k7_train = trained["rwkv6-7b"]["launches"]["wkv6"]
    r = wkv_rows[(LM_DOCS, TRAIN_SEQ, "bf16", None)]
    print(f"K7 path shape B={LM_DOCS} T={TRAIN_SEQ} (rwkv6-7b refresh, phase 5b): launches {k7_train}, "
          f"device_ms cold {fmt_ms(r['device_ms'])}, bound {r['bound_ms']:.6f} ({r['bound_by']}), "
          f"plain {r['plain_ms']:.5f}")
    # K1 and K3 at each shape a path gives them: launches there beside the
    # shape's plan, cold device time, bound and library call (the LM path's
    # one K1 launch and the stage-wise route's one K3 launch a profile set
    # are checked in their phases)
    for label, name, shape, n, path in (
        ("K1", "pairwise_dists_stats", SHAPES[0], launches["pairwise_dists_stats"], "CNN FL"),
        ("K1", "pairwise_dists_stats", SHAPES[1], 1, "LM FL"),
        ("K1", "pairwise_dists_stats", SHAPES[3], unfunnelled["pairwise_dists_stats"], "CNN FL unfunnelled init"),
    ) + tuple(
        ("K1", "pairwise_dists_stats", shape, n, "phase 5b inits") for shape, n in k1_train.items()
    ) + (
        ("K3", "pairwise_sq_dists", K3_SHAPES[0], 1, "stage-wise, FC-1 profiles"),
        ("K3", "pairwise_sq_dists", K3_SHAPES[1], 1, "stage-wise, representative profiles"),
        ("K3", "pairwise_sq_dists", K3_SHAPES[2], 1, "stage-wise, gradient profiles"),
    ):
        r = rows[name][shape]
        print(
            f"{label} path shape C={shape[0]} Q={shape[1]} ({path}): launches {n}, {r['plan']}, "
            f"ms {r['ms']:.5f} (library {r['library_ms']:.5f}, {r['ms'] / r['library_ms']:.3f} of it), "
            f"device_ms cold {fmt_ms(r['device_ms'])} hot {fmt_ms(r['device_ms_hot'])}, "
            f"bound {r['bound_ms']:.7f} ({r['bound_by']}), plain {r['plain_ms']:.5f}"
        )
    r = rows["normalized_gram"][SHAPES[3]]
    print(
        f"K2 path shape C={SHAPES[3][0]} (CNN FL unfunnelled init): launches {unfunnelled['normalized_gram']}, "
        f"ms {r['ms']:.5f} (library {r['library_ms']:.5f}, {r['ms'] / r['library_ms']:.3f} of it), "
        f"device_ms {fmt_ms(r['device_ms'])}, bound {r['bound_ms']:.7f} ({r['bound_by']}), plain {r['plain_ms']:.5f}"
    )
    # K7 at each shape the RWKV serving path gave it: its launches there
    # beside the shape's cold device time and bound (from the rows above)
    for (b, t), n in sorted(rwkv_shapes.items()):
        r = wkv_rows.get((b, t, "bf16", None))
        check(r is not None, f"K7 path shape {(b, t)} is not among WKV_SHAPES")
        print(
            f"K7 path shape B={b} T={t}: launches {n}, "
            f"{f'chunked x{r['design']} slices' if r['design'] else 'recurrent'}, device_ms cold "
            f"{fmt_ms(r['device_ms'])}, bound {r['bound_ms']:.6f} ({r['bound_by']})"
            f"{'' if r['device_ms'] is None else f' = {r['bound_ms'] / r['device_ms']:.4f} of it'}, "
            f"plain {r['plain_ms']:.5f}, lost to the bound "
            f"{'not measured' if r['device_ms'] is None else f'{n * (r['device_ms'] - r['bound_ms']):.3f} ms'}"
        )
    table = []
    for name, (source, replaces, r, n) in sources.items():
        table.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=n, max_abs_err=r["max_abs_err"], ms=r["ms"], device_ms=r["device_ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"],
        ))
        # K5 and K7's device_ms is the cold one (L2 flushed); no row may
        # read a device time below its bound
        check(r["device_ms"] is None or r["bound_ms"] <= r["device_ms"],
              f"{name}: device time {r['device_ms']} below its bound {r['bound_ms']}")
    # K5 at the new archs' decode shapes (phase 6b)
    for arch, (shape, r, n) in k5_new.items():
        table.append(dict(
            name=f"flash_decode {arch} {shape[0]}x{shape[1]}x{shape[2]}/{shape[3]}x{shape[4]}", route="cuda",
            source=sources["flash_decode"][0], replaces=sources["flash_decode"][1], launches=n,
            max_abs_err=r["max_abs_err"], ms=r["ms"], device_ms=r["device_ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=r["library_ms"],
        ))
        check(r["device_ms"] is None or r["bound_ms"] <= r["device_ms"],
              f"K5 {arch}: device time {r['device_ms']} below its bound {r['bound_ms']}")
    # the funnel's K1 and K2 rows (phase 3d): its shape, its launches
    for name, r in funnel_rows.items():
        table.append(dict(
            name=f"{name} funnel {'x'.join(map(str, r['shape']))}", route="cuda", source=sources[name][0],
            replaces=sources[name][1], launches=r["launches"], max_abs_err=r["max_abs_err"], ms=r["ms"],
            device_ms=r["device_ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"],
        ))
        check(r["device_ms"] is None or r["bound_ms"] <= r["device_ms"],
              f"{name} funnel: device time {r['device_ms']} below its bound {r['bound_ms']}")
    # K1 and K2 at the unfunnelled init at C = 4,096 (phase 3d (c)): the
    # shape's rows from section 2, the path's launches
    for name in FL_KERNELS:
        r = rows[name][SHAPES[3]]
        shape = "x".join(map(str, SHAPES[3][:2] if name == "pairwise_dists_stats" else SHAPES[3][:1]))
        table.append(dict(
            name=f"{name} unfunnelled {shape}", route="cuda", source=sources[name][0], replaces=sources[name][1],
            launches=unfunnelled[name], max_abs_err=r["max_abs_err"], ms=r["ms"], device_ms=r["device_ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=r["library_ms"],
        ))
    # phase 5b's shapes: K1 at each profile width, K6 at each refresh shape
    # (its cold device time), K7 at rwkv6-7b's refresh
    for shape, n in k1_train.items():
        r = rows["pairwise_dists_stats"][shape]
        table.append(dict(
            name=f"pairwise_dists_stats train {shape[0]}x{shape[1]}", route="cuda",
            source=sources["pairwise_dists_stats"][0], replaces=sources["pairwise_dists_stats"][1], launches=n,
            max_abs_err=r["max_abs_err"], ms=r["ms"], device_ms=r["device_ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=r["library_ms"],
        ))
    for arch, (shape, r, n) in k6_train.items():
        table.append(dict(
            name=f"flash_attention {arch} {shape[0]}x{shape[1]}x{shape[2]}/{shape[3]}x{shape[4]} {shape[5]}",
            route="cuda", source=sources["flash_attention"][0], replaces=sources["flash_attention"][1],
            launches=n, max_abs_err=r["max_abs_err"], ms=r["ms"], device_ms=r["device_ms_cold"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=r["library_ms"],
        ))
    # phase 8's mesh paths: K1 and K2 on (d)'s all-reduced candidate block
    # (the funnel's shape, its rows from phase 3d), K6 at (e)'s refresh
    for name in FL_KERNELS:
        r = funnel_rows[name]
        table.append(dict(
            name=f"{name} mesh funnel {'x'.join(map(str, r['shape']))}", route="cuda", source=sources[name][0],
            replaces=sources[name][1], launches=mesh_launches[name], max_abs_err=r["max_abs_err"], ms=r["ms"],
            device_ms=r["device_ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"],
        ))
    shape = MESH_ATTN_SHAPES[0]
    r = attn_rows[shape]
    print(f"K6 path shape B={shape[0]} S={shape[1]} H={shape[2]} Hk={shape[3]} hd={shape[4]} {shape[5]} "
          f"(smollm-360m refresh on the mesh, phase 8 (e)): launches {mesh_launches['flash_attention']}, "
          f"ms {r['ms']:.5f}, device_ms cold {fmt_ms(r['device_ms_cold'])} hot {fmt_ms(r['device_ms'])}, "
          f"bound {r['bound_ms']:.6f} ({r['bound_by']}), plain {r['plain_ms']:.5f}, sdpa {r['library_ms']:.5f}")
    table.append(dict(
        name=f"flash_attention mesh smollm-360m {shape[0]}x{shape[1]}x{shape[2]}/{shape[3]}x{shape[4]} {shape[5]}",
        route="cuda", source=sources["flash_attention"][0], replaces=sources["flash_attention"][1],
        launches=mesh_launches["flash_attention"], max_abs_err=r["max_abs_err"], ms=r["ms"],
        device_ms=r["device_ms_cold"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
        library_ms=r["library_ms"],
    ))
    b, t, h, hd = PROD_MESH_K7
    r = wkv_rows[(b, t, "bf16", None)]
    table.append(dict(
        name=f"wkv6 rwkv6-7b decode on the 16x16 mesh {b}x{t}x{h}x{hd}", route="cuda", source=sources["wkv6"][0],
        replaces=sources["wkv6"][1], launches=prod_launches["wkv6"], max_abs_err=r["max_abs_err"], ms=r["ms"],
        device_ms=r["device_ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
        library_ms=r["library_ms"],
    ))
    r = wkv_rows[(LM_DOCS, TRAIN_SEQ, "bf16", None)]
    table.append(dict(
        name=f"wkv6 rwkv6-7b refresh {LM_DOCS}x{TRAIN_SEQ}", route="cuda", source=sources["wkv6"][0],
        replaces=sources["wkv6"][1], launches=k7_train, max_abs_err=r["max_abs_err"], ms=r["ms"],
        device_ms=r["device_ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
        library_ms=r["library_ms"],
    ))
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": table}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
