#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

Thirteen paths, each driven with the launch counts set to 0 just before it
and read just after:

1. The data plane — ``ParallelDataPlane.process`` with the flow cache on —
   through the IPsec Gateway (all four NIC kernels: flow_lookup, dfa_regex,
   keyed_hash, arx_cipher) and the Intrusion Detection app (flow_lookup,
   dfa_regex) at full data size: 8 pipelines, 16,384-packet batches of
   1,500-byte packets over 10,000 flows, 4,096-slot rings per pipeline, the
   2^17-slot flow cache. Every batch's output is held bit for bit against
   the port's ``run_pipeline`` with the plain PyTorch versions
   (``impl="torch"``) on the same card. The plane writes its counters,
   dispatch times and trace events into the port's ``obs.Obs``: the
   flow-cache counters must equal the flow cache's own stats, no compile
   cache may miss after the warm-up, and the dumped artifacts must load
   back into a trace that answers as the live one.
2. LM serving on gemma3-1b at full width (26 layers, d_model 1152, 4 query
   heads over 1 KV head of 256, vocab 262,144; f32 parameters from a seeded
   generator): ``Model.prefill`` of 4 prompts of 1,024 tokens into a
   1,536-deep bf16 cache (flash_attention on every layer, 22 of them with
   the 512-token window) and 32 greedy ``decode_step``s (decode_attention
   on the 4 global layers), held against the same prefill and decode with
   the plain versions; then ``repro_torch.launch.serve`` at its reference
   defaults (16 requests x 16 tokens, 8 slots, max_len 64), held against
   the same engine with the plain versions.
3. The same arch's ``reduced()`` config (head dim 16) on the card against
   the same parameters on the CPU: a prefill and 8 decode steps
   (flash_attention and decode_attention at head dim 16), then
   ``launch.serve --reduced`` against a CPU engine with the same plan.
4. LM serving on mamba2-370m at full width (48 mamba layers, d_model 1024,
   d_inner 2048, state 128, head dim 64, vocab 50,280; f32 parameters from
   a seeded generator): ``Model.prefill`` of 4 prompts of 1,024 tokens
   (ssd_scan on every layer, 8 chunks each) and 32 greedy ``decode_step``s
   (the one-token recurrence in plain PyTorch, as in the reference: no
   kernel), held against the same run with the plain versions (logits and
   every layer's SSM state); then ``launch.serve`` at its reference
   defaults, held against a plain-impl engine on the same plan.

5. Training olmo-1b at full width (16 layers, d_model 2,048, 16 heads of
   128, d_ff 8,192, vocab 50,304; f32 parameters and AdamW state from a
   seeded generator): 4 steps of ``launch.steps.make_train_step`` at batch
   8 x 1,024 (2 microbatches of 4), once with the kernels (B5 forward with
   its log-sum-exp, and B5's backward, on every layer of every
   microbatch) and once with the plain versions, from the same parameters
   and data; then ``launch.train.main`` on the reduced config on the card,
   crashed at step 5 (``--fail-at``) and resumed (``--resume``), against an
   uninterrupted run: the final parameters equal bit for bit. Then
   mamba2-370m at full width (f32, AdamW f32) the same way: 4 steps at
   batch 8 x 1,024 in 2 microbatches, ssd_scan and its backward
   (ssd_scan_bwd) on every layer of every microbatch, against the plain
   versions. Then moonshot-v1-16b-a3b at full width (d_model 2,048, 16
   heads of 128, 64 experts of d_ff 1,408 top-6, vocab 163,840 tied; f32,
   AdamW f32), its depth cut to the dense first layer and 4 MoE layers
   (2.64 B parameters): 4 steps the same way, B5 and its backward on every
   layer, each plain step from the kernel step's state, the routes held
   flip by flip, and the step-1 parameters against a plain step that takes
   the kernel run's routes; a step that drops one expert's gradient must
   fail that gate.

6. MoE serving on moonshot-v1-16b-a3b at full width (48 layers, the first
   dense, d_model 2,048, 16 heads of 128, 64 experts of d_ff 1,408 top-6,
   vocab 163,840; 27.2 B bf16 parameters from a seeded generator): the
   prefill of 4 x 1,024 tokens (B5 on every layer) and 32 decode steps (B6
   on every layer), and the engine at ``launch.serve``'s defaults, each
   with the kernels and with the plain versions; one bf16 rounding can
   change a token's experts and part the two runs, so the gate holds each
   layer to the same input (``bf16_layer_checks``).
7. The reduced phi3.5-moe, moonshot and jamba configs (f32) on the card
   against the CPU: a prefill and 8 decode steps, then ``launch.serve
   --reduced``; jamba's runs B5, B6 and B7 in one model.
8. The encoder-decoder family on seamless-m4t-medium at full width (12
   encoder and 12 decoder layers, d_model 1,024, 16 heads of 64, vocab
   256,206; f32 parameters from a seeded generator): the prefill of 4 x
   (1,024 stub frames + 1,024 tokens) (B5 bidirectional on each encoder
   layer, causal self- and bidirectional cross-attention on each decoder
   layer: 36 launches) and 32 greedy decode steps from ``init_cache(4,
   1,536)`` (B6 on each decoder layer's self cache and 4,096-frame cross
   cache: 24 a step), held against the plain versions.
9. The reduced minicpm-2b, qwen2.5-32b and llava-next-34b (8 stub patches
   ahead of the prompts) on the card against the CPU as in 7, the reduced
   seamless prefill and 8 decode steps, and one ``make_train_step`` step
   each of reduced seamless (B5 forward and backward non-causal), minicpm
   (WSD schedule), phi3.5-moe, moonshot and jamba (B7 and its backward at
   N 16, P 8; bf16 optimizer state) against the CPU.
10. Dense serving on qwen2.5-32b at full width (64 layers, d_model 5,120,
   40 query heads over 8 KV heads of 128 (G 5), QKV bias, d_ff 27,648,
   vocab 152,064, untied head; 32.8 B bf16 parameters, ~61 GiB): the
   prefill of 4 x 1,024 tokens (64 B5) and 32 decode steps (64 B6 a
   step), the engine as ``launch.serve`` builds it, kernels against plain;
   the gate holds each layer to the plain run's input, as for moonshot.
11. The control plane (CP2), after path 1 on its first batch: the six
   apps profiled by ``profiler.measure_app`` on the card (B2 for ISG's
   ``url_check`` and ID's ``dpi_regex``, B4 for ``sha``, B3 for ``aes``,
   each exactly 2 + 5 + 1 launches), with Algorithm 1's R and the
   simulator's throughput at it; ``cost_model_latency`` on ``ddos_check``
   beside its measured time, and its refusal of ``url_check``;
   ``bounded_sync_deltas`` over 8 replicas of the flow cache's 2^17 int64
   slot counters for 16 rounds, each merge equal to the host form on the
   CPU, a faulted sync rejected. After path 2's engine run, Algorithm 2
   places gemma3-1b's measured plan over ``tpu_pod_pool()`` and the pool's
   ledger is clean after ``commit`` and ``release``.
12. The control plane (CP3), after path 11 while the traffic is on the
   card: ``MeiliController`` over ``paper_cluster()`` places the six apps
   from their measured profiles; each deployment's ``ParallelDataPlane``
   (its pipelines, ``_pipeline_capacity``, the controller's ``Obs``) runs
   the 7 batches, equal to the plain ``run_pipeline``, B1 and each kernel
   stage's kernel launched once a batch; then adaptive scale up and down
   (the plane rebuilt and checked), defragmentation, a forced migration
   with a NIC failing mid-way (the failover span inside the migrate span),
   replication and failover with the state restored, and terminate, the
   ledger clean after every step and the pool back at its baseline. Then
   the governor's DWRR tick with ``VectorizedScheduler`` on the card
   against the scalar governor at 200 and 1,024 tenants, every tick within
   the contract (``sched_kernel.contract_errors``) and no new shape key
   after the warm-up, and a tick with one tenant's weight doubled that the
   contract must reject.
13. The service runtime (CP4), after path 12: ``ServiceRuntime`` over
   ``paper_cluster()`` drives every tenant's ``ParallelDataPlane`` on the
   card each tick, with the DWRR tick on tensors on the card
   (``vectorized_sched``). R1: the six-tenant mix (backup NICs) under the
   chaos scenario for 40 ticks at 192 packets of 192 B a tick, a crash of
   the busiest NIC, a gray BF-2 and a crash inside a migration, recovery
   with parking and brownout, the SLO engine, burn-rate alerts and flight
   recorder on; held to its replay on the CPU with ``==`` (tenant and
   cluster ticks, fault records, alert transitions, dispatch attribution),
   and a replay whose scheduler drops t-fw's served bytes at one tick must
   fail that gate. R2: t-isg and t-fw under megaflow traffic (10^5
   concurrent flows, 0.5% churn a tick) at 16,384 packets of 1,500 B a
   tick for 12 ticks. In both, every plane output equals the plain
   ``run_pipeline`` bit for bit, each dispatch launches B1 and each kernel
   stage's kernel once, the DWRR tick reads the host at most twice and
   adds no shape key after the warm-up (R2's planes none either), and the
   ledger is clean at the end.

Each kernel is then checked against its plain version at the shapes its
path gave it and timed.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It builds the kernels from ``src/repro_torch/kernels/csrc`` with nvcc
(into ``build/kernels/``), needs one CUDA device, and exits non-zero on any
failure. The last line of its output is ``{"ok": true, "device": {...}}``;
the line before it lists every kernel (B5's and B7's backwards too) with its
launches on its path, its error against the plain version, and its times
beside its bound (B3 and B4 also beside ``input_read_floor``, a plain
coalesced read of their input timed the same way), and
``launch_floor_ms``: a kernel that does nothing, timed the same way.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import random
import re
import statistics
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import hw  # noqa: E402
from repro_torch.apps import (ALL_APPS, intrusion_detection,  # noqa: E402
                              ipsec_gateway, synth_packets)
from repro_torch.apps.nf import SNORT_RULES  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.core import (profiler, replication,  # noqa: E402
                              sched_kernel, sim, state_engine)
from repro_torch.core.allocation import commit, release  # noqa: E402
from repro_torch.core.controller import MeiliController  # noqa: E402
from repro_torch.core.executor import (ParallelDataPlane,  # noqa: E402
                                       _bucket, _sync)
from repro_torch.core.faults import (ChaosEngine, FaultEvent,  # noqa: E402
                                     FaultPlan, RecoveryConfig)
from repro_torch.core.graph import (bits, compile_cache_stats,  # noqa: E402
                                    run_pipeline, stage_runner, tree_leaves)
from repro_torch.core.orchestrator import flow_ids  # noqa: E402
from repro_torch.core.pool import CPU, paper_cluster, tpu_pod_pool  # noqa: E402
from repro_torch.core.qos import ResourceGovernor, TenantQuota  # noqa: E402
from repro_torch.data import SyntheticLMDataset  # noqa: E402
from repro_torch.kernels import _build, crypto, dfa_regex, ops, ref  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import flow_lookup as fl  # noqa: E402
from repro_torch.kernels import ssd_scan as ss  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.models import lm, moe, ssm  # noqa: E402
from repro_torch.obs import FIRING, PAGE, WARN, Obs, load_trace  # noqa: E402
from repro_torch.optim import make_schedule  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402
from repro_torch.serving.engine import PipelineInstance  # noqa: E402
from repro_torch.serving.planner import plan_serving  # noqa: E402
from repro_torch.service import (RuntimeConfig, ServiceRuntime,  # noqa: E402
                                 TenantRegistry, default_tenant_mix)
from repro_torch.service.tenants import contracts  # noqa: E402
from repro_torch.service.workload import make_scenario  # noqa: E402

BATCH = 16384
FLOWS = 10_000
PKT_BYTES = 1500
PIPELINES = 8
CAPACITY = 4096          # packets per pipeline per round: 2x headroom
RING = 4096
N_BATCHES = 7            # seeds 0..6
WARMUP = 2               # the cold-cache batch and the first warm one
KERNEL_REPS = 20
PLAIN_REPS = 10
FLUSH_BYTES = 64 << 20   # > the 50 MB L2: each timed launch starts cold
SLEEP_CYCLES = 2_000_000  # ~1 ms of device time ahead of each timed call

# LM serving phase (gemma3-1b at full width)
ARCH = "gemma3-1b"
SERVE_BATCH = 4
PROMPT_LEN = 1024         # twice the 512-token window: the band mask bites
CACHE_LEN = 1536          # a multiple of 512, as the reference's decode block
DECODE_STEPS = 32
# Tolerances of the kernel run against the plain run (both f32 math, sums
# in other orders). Attention outputs differ by ~1e-6 relative; through 26
# residual layers (activations of RMS up to ~3) that reaches the O(1)
# logits at ~1e-4, so prefill logits, and the engine's logits (f32 cache),
# are held to PREFILL_TOL = 1e-3. Decode reads a bf16 cache: the two runs'
# f32 keys and values differ by ~1e-6 relative from layer 1 on, so a few in
# 10^4 of them round to the other bf16 neighbour (2**-8 relative); those
# flips move decode logits by up to ~1e-3, held to DECODE_TOL = 2e-3. A
# greedy token must be equal wherever the top-1/top-2 margin exceeds twice
# the tolerance (then no error within the tolerance can reorder the two).
PREFILL_TOL = 1e-3
DECODE_TOL = 2e-3
# A kernel against its plain version on the same inputs: f32 outputs.
ATTN_TOL = dict(atol=1e-5, rtol=1e-5)
# The same arch's reduced() config (head dim 16) on the card and on the CPU
REDUCED_BATCH = 4
REDUCED_PROMPT = 40
REDUCED_STEPS = 8

# LM serving phase (mamba2-370m at full width)
MAMBA_ARCH = "mamba2-370m"
MAMBA_PROMPT_LEN = 1024   # 8 chunks of 128 per layer
# The SSD kernel and its plain version both take each decay as exp of a
# difference of two f32 cumulative sums of log a, summed in other orders;
# at Mamba-2's decays the sums reach ~110 (ulp 7.6e-6), so a decay differs
# by ~1e-5 relative, and y (a sum of such terms) by up to ~1e-5 relative
# to its scale (a chunked f32 scan at the path's widths lies within 5.3e-5
# of an f64 recurrence on |y| up to 15): the kernel is held to its plain
# version at SSD_TOL. Through 48 layers the differences grow: a CPU proxy
# (48 layers at width 256, S 512, the plain scan against one whose cumsum
# follows the kernel's order) moved the logits by 2.3e-4 (prefill and 8
# decode steps) and each layer's state by 6.8e-5 of its largest entry.
# Logits (prefill, decode, engine) are held to MAMBA_LOGIT_TOL, about 9x
# that, and every layer's final state h, after prefill and after decode,
# to MAMBA_STATE_TOL of its largest entry, about 15x. Decode and the
# engine run no kernel; they differ only through the prefilled state.
SSD_TOL = dict(atol=1e-4, rtol=1e-4)
# B7's backward against its plain version (f32): each gradient sums up to
# a chunk's 128 terms weighted by exp of differences of f32 cumulative sums
# (~110 at Mamba-2's decays, ulp 7.6e-6), in another order, and da's terms
# cancel (row sums minus column sums, then a reverse cumulative sum): each
# gradient is held to SSD_BWD_TOL of its largest entry (rtol the same).
SSD_BWD_TOL = 1e-4
MAMBA_LOGIT_TOL = 2e-3
MAMBA_STATE_TOL = 1e-3

# Training phase (olmo-1b at full width)
TRAIN_ARCH = "olmo-1b"
TRAIN_BATCH = 8           # 2 microbatches of 4 (microbatch capped at 2)
TRAIN_SEQ = 1024
TRAIN_STEPS = 4           # numbered 1..4: lr(0) is 0 under the warmup
TRAIN_LR = 3e-3           # the reference CLI's --lr, warmup 20
TRAIN_WARMUP = 20
# Tolerances of the kernel run against the plain run. The two differ only
# in attention: B5's forward and backward agree with their plain versions
# to ~1e-6 relative (3xTF32 against cuBLAS f32, sums in other orders). Through 16 layers that moves a loss of ~10.9 and the gradients
# by ~1e-5 relative at most: the losses are held to TRAIN_LOSS_TOL and the
# grad norms, sums of squares of 1.2e9 gradients, to TRAIN_GNORM_TOL,
# relative. AdamW's first update is lr · g / (|g| + eps): ±lr wherever |g|
# >> eps, whatever the gradient's error, but a function of the gradient's
# low bits where |g| is near eps. So after step 1 every parameter must be
# within 2 lr(1) of the plain run's (the most two such updates can
# differ), and all but a share TRAIN_PARAM_SHARE within 1e-3 lr(1).
TRAIN_LOSS_TOL = 1e-4
TRAIN_GNORM_TOL = 1e-3
TRAIN_PARAM_SHARE = 1e-3
# mamba2-370m's kernel and plain runs part faster than olmo's: B7 and its
# backward agree with their plain versions to ~1e-5 of scale (decays as
# exp of differences of f32 cumulative sums), which 48 layers carry into
# the first layers' gradients, so AdamW's first updates of near-zero
# gradients differ, and the two free runs part further each step. Gated
# from one state, every step holds olmo's gates (the kernel run's step from
# the state after its own previous step, the plain run's step from that
# same state, run in lock step: ``_train_lockstep``); the free plain run is
# reported.
TRAIN_RESYNC = True
# For the same reason more of mamba's parameters part after step 1 than
# olmo's TRAIN_PARAM_SHARE allows: AdamW's first update is ±lr wherever
# |g| >> eps, so an entry parts by 2 lr(1) where its gradient's sign
# differs, and the 48 layers leave many entries' gradients smaller than
# the two runs' difference. How many is a property of the f32 function,
# not of the kernels: the plain version parts from itself as much when
# only the order of its sums changes (``ops.ssd``'s chunk at 64 instead of
# 128: TRAIN_CALIBRATE). The kernel run may part from the plain run in at
# most TRAIN_NOISE_FACTOR times that share.
TRAIN_CALIBRATE = ("ssd", "chunk", 64)
TRAIN_NOISE_FACTOR = 2.0
# Training the MoE family at full width: moonshot-v1-16b-a3b's widths (d_model
# 2,048, 16 heads of 128, 64 experts of d_ff 1,408 top-6, vocab 163,840
# tied), its depth cut to the dense first layer and MOE_TRAIN_LAYERS - 1
# MoE layers: all 48 layers' f32 weights, gradient sum and two AdamW moments
# would take ~435 GB; five take ~42 GB, and one microbatch's per-step
# gradients, activations and (4 x 512 x 163,840) logits most of the rest.
# The kernel and plain runs follow olmo's gates (TRAIN_LOSS_TOL,
# TRAIN_GNORM_TOL; parameters within 2 lr(1) after step 1, all but a share
# within 1e-3 lr(1)). What olmo does not have is routing: a token whose
# router logits nearly tie can take other experts in the two runs. Each
# such flip must be at a near tie (the plain run's k-th and (k+1)-th
# logits within twice the two runs' largest logit difference), and at
# most MOE_FLIP_SHARE of a call's tokens may flip (``_train_route_gate``).
# A flip moves its token's whole output, and through attention the rest
# of its sequence: on an NVIDIA H100 (700 W), 4 flips in 32,768 routes at
# step 1 parted 0.71% of the parameters by more than 1e-3 lr(1), spread
# over every expert, while the plain version in another summation order
# (MOE_TRAIN_CALIBRATE: its attention's key block at 128, not 256) parts
# from itself by 1.2e-6, flipping none. So the parameter gate compares
# the kernel run's step 1 with a plain step 1 that takes the kernel run's
# routes (``_ReplayRoutes``), at olmo's share or TRAIN_NOISE_FACTOR times
# the calibration's, whichever is larger; the freely routed comparison is
# reported. A kernel step 1 whose backward drops expert 0's gradient in
# every MoE layer (``_drop_expert_grad``) parts ~1.3% of the parameters by
# ~lr(1): the phase fails unless the gate rejects it.
# Left to run free, the kernel and plain runs part by step 4 as AdamW parts
# them, and routing amplifies it (hundreds of a call's 4,096 tokens take
# other experts by step 4: line ``moe train plain run left to run free``).
# So each plain step starts from the kernel step's state, as mamba's do
# (TRAIN_RESYNC), and the free plain run is reported, not gated.
MOE_TRAIN_LAYERS = 5
MOE_TRAIN_CALIBRATE = ("attention", "block_k", 128)
# The logits' f32 rounding when recomputed for the route gate: a softmax
# of logits up to |l| rounds each probability by ~|l| 2**-24 relative.
ROUTE_SLACK = 2.0 ** -20
# B5's backward against its plain version (f32): each 3xTF32 product keeps
# ~2**-22 of its operands' precision, each row tile's sum is added to the
# total with an f32 add, and dK and dV sum 1,024 products an entry (dQ
# up to 1,024) in another order than cuBLAS: ~1e-6 of their scale at
# random signs, held to atol = rtol = 1e-4.
BWD_TOL = dict(atol=1e-4, rtol=1e-4)
# MoE serving phase (moonshot-v1-16b-a3b at full width, bf16 parameters)
MOE_ARCH = "moonshot-v1-16b-a3b"
# The routing-aware gate (``bf16_layer_checks``) runs each layer on the
# plain run's input with the kernels and with the plain versions; the two
# differ only in the attention output, which B5 (B6) and its plain version
# compute in f32 and round to bf16: one bf16 ulp apart at most, and an ulp
# is at most 2**-7 of a layer's largest entry. The router input,
# norm2(x + o(attn)), adds three roundings (the projection's, the residual
# add's, the norm's): within 4 ulps, MOE_INPUT_TOL = 2**-5 of its largest
# entry. A layer's output, on the tokens whose experts agree, adds the
# MoE's: the expert products' three, the contribution's, the adds of its
# k = 6 contributions and the residual add: within 16 ulps, MOE_LAYER_TOL
# = 2**-3. A wrong B5 or B6 moves both by O(1). A token may change experts
# only at a near tie of its router logits (the bound in ``_gate_layer``),
# and at most MOE_FLIP_SHARE of a layer's tokens may, a cap on the near
# ties that bf16 router logits leave.
# Two values rounded to bf16 once each, from exact values that differ by
# d, differ by at most d + 2**-7 of the larger (each rounding moves a
# value by at most half an ulp, 2**-8 of it): the rounding term of the
# routing and logit bounds.
BF16_ROUND = 2.0 ** -7
# cuBLAS sums a logit's 2,048 bf16 products (exact in f32) in f32 in its
# own order: each run's sum is off by at most ~2,048 f32 roundings of
# partial sums no larger than the row's largest logit at these scales,
# under 2**-12 of it.
LOGIT_SLACK = 2.0 ** -12
MOE_INPUT_TOL = 2.0 ** -5
MOE_LAYER_TOL = 2.0 ** -3
MOE_FLIP_SHARE = 0.05
# A bf16 kernel output against its plain version: two bf16 ulps.
ATTN_BF16_TOL = dict(atol=2.0 ** -8, rtol=2.0 ** -6)
# The MoE and hybrid families' reduced() configs on the card against the CPU
REDUCED_MOE_ARCHS = ("phi3.5-moe-42b-a6.6b", "moonshot-v1-16b-a3b",
                     "jamba-1.5-large-398b")
# crash and resume, reduced olmo-1b on the card (a full-width checkpoint
# would be ~14 GB on disk)
RESUME_ARGS = ["--arch", TRAIN_ARCH, "--reduced", "--device", "cuda",
               "--steps", "10", "--batch", "4", "--seq", "64",
               "--ckpt-every", "5", "--log-every", "100"]
RESUME_FAIL_AT = 5

# Encoder-decoder phase (seamless-m4t-medium at full width, f32)
ENCDEC_ARCH = "seamless-m4t-medium"
ENCDEC_FRAMES = 1024      # input_specs' even split of seq_len 2,048
ENC_LEN = 4096            # the decode cache's encoder frames (ENC_LEN_DECODE)
# The kernel run against the plain run, derived as gemma's: both f32, the
# attention outputs ~1e-6 relative apart, carried through 24 residual
# layers into O(1) logits at ~1e-4: prefill logits held to 1e-3. Decode
# starts from init_cache (the reference's prefill leaves no cache) and
# writes bf16 self-attention keys and values, a few in 10^4 of which round
# to the other bf16 neighbour between the runs (the cross cache is zeros
# in both). gemma's 2e-3 assumed a 1,056-deep cache, where one flipped
# value weighs ~1/1,056; here step n reads n + 1 keys, so a flipped value
# weighs ~1/(n + 1), on 12 layers. On an NVIDIA H100 (700 W) the sound
# run reads 2.71e-3 at step 2, falling to ~1.6e-3 by step 31, and a B6
# that drops one key (``encdec_decode_fault``, run every time) moves the
# logits by 1.7 to 3.4 at every step from 1 on. Decode logits are held to
# ENCDEC_DECODE_TOL, ~7x the sound reading and ~1/86 of the faulted one;
# the phase fails if the sound run fails it or the faulted run passes it.
ENCDEC_PREFILL_TOL = PREFILL_TOL
ENCDEC_DECODE_TOL = 2e-2
# qwen2.5-32b at full width (bf16 parameters, dense, G 5). Its layer gate
# is the MoE phase's (``bf16_layer_checks``) with a dense layer's own
# bound: the two runs' attention outputs are one bf16 ulp apart, and the
# layer adds eight roundings of its own (the output projection's, the
# residual add's, the norm's, the MLP's gate, up, product and down, and
# the second residual add): within 9 ulps, DENSE_LAYER_TOL = 9 * 2**-7
# of the output's largest entry (moonshot's dense first layer is held to
# it too). A wrong B5 or B6 moves it by O(1). The tight check of B5 and
# B6 at G 5 is their ``qwen`` rows, held to ATTN_BF16_TOL.
DENSE_LAYER_TOL = 9 * 2.0 ** -7
DENSE_BF16_ARCH = "qwen2.5-32b"
LLAVA_ROW = (4, 1600, 56, 8)   # B5 at llava-next-34b's heads (G 7), bf16
# The remaining dense and vlm configs reduced, card against CPU, and one
# train step each of reduced seamless and minicpm (WSD)
REDUCED_A21_ARCHS = ("minicpm-2b", "qwen2.5-32b", "llava-next-34b")
REDUCED_TRAIN_ARCHS = ("seamless-m4t-medium", "minicpm-2b",
                       "phi3.5-moe-42b-a6.6b", "moonshot-v1-16b-a3b",
                       "jamba-1.5-large-398b")
REDUCED_TRAIN_TOL = 1e-4  # f32 through 4 layers, as the CUDA tests hold it
# jamba keeps bf16 optimizer state: its gradients are summed in bf16, each
# entry within two bf16 ulps of the CPU's, so its grad norm is held to
# 2**-7 relative (|‖a‖ − ‖b‖| ≤ ‖a − b‖; tests/test_torch_moe_train.py)
REDUCED_TRAIN_BF16_GNORM_TOL = 2.0 ** -7

# the control plane (CP2): measure_app on the card, the cost model, the
# flow-state sync and Algorithm 2's placement of gemma3-1b's plan
PROFILE_ITERS = 5          # timed calls a stage, after 2 warm-up calls
# each kernel stage launches on the warm-up and timed calls and on the call
# that advances the chain to the next stage
PROFILE_LAUNCHES = 2 + PROFILE_ITERS + 1
KERNEL_OF_STAGE = {"url_check": "dfa_regex", "dpi_regex": "dfa_regex",
                   "sha": "keyed_hash", "aes": "arx_cipher"}
SIM_SEQS = 1000
SYNC_ROUNDS = 16
SYNC_INC_MAX = 64          # packets a slot and replica gains between syncs

# the control plane (CP3): the controller over paper_cluster() with the
# measured profiles, each deployment's data plane on the card, the lifecycle,
# and the governor's DWRR tick on the card
# targets as multiples of each app's measured t_p: 1.5 gives ISG 2 units a
# stage (its sha and aes share the pool's 4 crypto engines), 2.5 FW 3
CTRL_TARGETS = {"ISG": 1.5, "ID": 0.5, "FW": 2.5, "ICG": 0.5, "FM": 0.5,
                "LLB": 0.5}
CTRL_REQUIRED = ("ISG", "ID", "FW")
CTRL_SCALE = ("FW", 3.5, 1.5)   # FW up to 4 pipelines, then down to 2
CTRL_REBUILD_BATCHES = 2        # batches through a plane rebuilt mid-phase
DWRR_TENANTS = (200, 1024)
DWRR_BUDGET = 2e6               # bytes a tick (the reference's smoke)
DWRR_CAP = 5e4
DWRR_TICKS = 30
DWRR_CAPPED_TICKS = 12
SERVICE_TICKS = 40
SERVICE_WARMUP = 2              # ticks before counts of keys and reads
# R1's fault plan (tick, kind, NIC, fraction): the busiest NIC crashes, a
# BF-2 turns gray at a quarter of its capacity, a crash lands inside a
# make-before-break migration
SERVICE_FAULTS = ((10, "crash", None, 1.0), (13, "gray", "bf2-2", 0.25),
                  (21, "mid_migration", None, 1.0))
SERVICE_DROP = ("t-fw", 12)     # the negative control: served bytes dropped
SERVICE_MAX_READS = 2           # host reads a DWRR tick
MEGAFLOW_TENANTS = ("t-isg", "t-fw")
MEGAFLOW_TICKS = 12
MEGAFLOW_PKTS = 16384
MEGAFLOW_PKT_BYTES = 1500

REPLACES = {
    "flow_lookup": "src/repro/kernels/flow_lookup.py:142",
    "dfa_regex": "src/repro/kernels/dfa_regex.py:30",
    "arx_cipher": "src/repro/kernels/crypto.py:25",
    "keyed_hash": "src/repro/kernels/crypto.py:29",
    "flash_attention": "src/repro/kernels/flash_attention.py:33",
    "flash_attention_bwd": "src/repro/kernels/ops.py:125",
    "decode_attention": "src/repro/kernels/decode_attention.py:29",
    "ssd_scan": "src/repro/kernels/ssd_scan.py:27",
    "ssd_scan_bwd": "src/repro/kernels/ops.py:244",
}
SOURCES = {
    "flow_lookup": "src/repro_torch/kernels/csrc/flow_lookup.cu",
    "dfa_regex": "src/repro_torch/kernels/csrc/dfa_regex.cu",
    "arx_cipher": "src/repro_torch/kernels/csrc/crypto.cu",
    "keyed_hash": "src/repro_torch/kernels/csrc/crypto.cu",
    "flash_attention": "src/repro_torch/kernels/csrc/flash_attention.cu",
    "flash_attention_bwd":
        "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
    "decode_attention": "src/repro_torch/kernels/csrc/decode_attention.cu",
    "ssd_scan": "src/repro_torch/kernels/csrc/ssd_scan.cu",
    "ssd_scan_bwd": "src/repro_torch/kernels/csrc/ssd_scan_bwd.cu",
}

# Kernel -> the __global__ functions it launches (as ptxas names them).
FUNCTIONS = {
    "flow_lookup": ("flow_lookup_kernel",),
    "dfa_regex": ("dfa_regex_kernel",),
    "arx_cipher": ("arx_cipher_kernel",),
    "keyed_hash": ("keyed_hash_kernel",),
    "flash_attention": ("flash_fwd_kernel", "flash_fwd_bf16_kernel",
                        "flash_combine_kernel"),
    "flash_attention_bwd": ("flash_bwd_delta_kernel", "flash_bwd_dkdv_tc",
                            "flash_bwd_dq_tc", "flash_bwd_dkdv_kernel",
                            "flash_bwd_dq_kernel"),
    "decode_attention": ("decode_attention_kernel",),
    "ssd_scan": ("ssd_chunk_state", "ssd_state_passing", "ssd_chunk_scan"),
    "ssd_scan_bwd": ("ssd_bwd_dstate", "ssd_bwd_reverse", "ssd_bwd_cols",
                     "ssd_bwd_rows"),
}


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _as_i64(t):
    if t.dtype == torch.uint32:
        return t.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return t.to(torch.int64)


def _max_abs_err(got, want) -> int:
    errs = [int((_as_i64(g) - _as_i64(w)).abs().max()) if g.numel() else 0
            for g, w in zip(got, want)]
    return max(errs)


def _time_ms(fn, reps, flush) -> float:
    """Median of ``reps`` calls, each timed alone with CUDA events after the
    L2 has been flushed. Each call is queued behind a ~1 ms device sleep,
    so the card is busy while the host launches it and the events see device
    time, not the wrapper's host-side launch overhead."""
    fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(SLEEP_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


class _NoFlush:
    """A stand-in for the flush buffer of ``_time_ms`` that flushes
    nothing: what a kernel takes when its inputs are still in L2."""

    def zero_(self):
        pass


def _ptxas(log):
    """``nvcc -Xptxas -v`` output -> {function: {"registers", "spill_stores",
    "spill_loads"}} (bytes of spills), one entry per compiled kernel."""
    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn = m.group(1)
            out[fn] = {}
        elif fn and "spill stores" in line:
            st, ld = re.findall(r"(\d+) bytes spill (?:stores|loads)", line)
            out[fn].update(spill_stores=int(st), spill_loads=int(ld))
        elif fn and "Used" in line:
            out[fn]["registers"] = int(re.search(r"Used (\d+) registers",
                                                 line).group(1))
    return out


def _ptxas_of(report, name):
    """The ptxas entries of kernel ``name``'s functions, by function."""
    return {fn: v for fn, v in report.items()
            if any(f in fn for f in FUNCTIONS[name])}


def _with_bound_share(row):
    """bound_ms / ms on a kernel row and on each of its variants: the share
    of the card's least time that the kernel reaches (<= 1)."""
    row["bound_share"] = row["bound_ms"] / row["ms"]
    for v in row.get("variants", {}).values():
        v["bound_share"] = v["bound_ms"] / v["ms"]
    return row


def _device_kernels(fn):
    """Names of the CUDA kernels one call of ``fn`` ran, from
    ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.name for e in prof.events()
                   if e.device_type == DeviceType.CUDA})


def _assert_batches_equal(got, want, ctx):
    a, b = tree_leaves(got), tree_leaves(want)
    if len(a) != len(b):
        raise AssertionError(f"{ctx}: {len(a)} leaves != {len(b)}")
    for i, (x, y) in enumerate(zip(a, b)):
        if x.dtype != y.dtype or x.shape != y.shape:
            raise AssertionError(f"{ctx}: leaf {i} {x.dtype}{tuple(x.shape)}"
                                 f" != {y.dtype}{tuple(y.shape)}")
        if not torch.equal(bits(x), bits(y)):
            raise AssertionError(f"{ctx}: leaf {i} differs from the plain "
                                 f"run_pipeline")


def drive(name, factory, batches):
    """Main path of one app: counts reset just before, read just after. The
    plane writes its counters, dispatch timings (``profile=True`` times
    each dispatch to completion) and trace events into the port's ``Obs``;
    the per-batch dispatch times are read back from its histogram."""
    o = Obs(seed=0)
    dp = ParallelDataPlane(factory(), num_pipelines=PIPELINES,
                           capacity_per_pipeline=CAPACITY, ring_capacity=RING,
                           metrics=o.metrics, trace=o.trace, profile=True)
    outs, ms, hit_rates, Ms, disp = [], [], [], [], []
    hist = o.metrics.histogram("dataplane_dispatch_us", app=dp.app.name)
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    for i, b in enumerate(batches):
        o.set_tick(i)
        fs0 = dict(dp.to.fast_stats)
        us0 = hist.sum
        t0 = time.perf_counter()
        outs.append(dp.process(b, tenant=name))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        disp.append(hist.sum - us0)
        hp = dp.to.fast_stats["hit_pkts"] - fs0["hit_pkts"]
        mp = dp.to.fast_stats["miss_pkts"] - fs0["miss_pkts"]
        hit_rates.append(hp / max(1, hp + mp))
        Ms.append(_bucket(int(max(p.load for p in dp.to.pipelines))))
        if i == WARMUP - 1:
            warm_compiles = dp.dispatch_stats["compiles"]
            o.snapshot_compile_caches([dp])
            warm_misses = _compile_misses(o)
    launches = _build.launch_counts()
    if dp.dispatch_stats["compiles"] != warm_compiles:
        raise AssertionError(f"{name}: {dp.dispatch_stats['compiles']} "
                             f"dispatch shapes after warm-up, "
                             f"{warm_compiles} at its end")
    plain = factory(impl="torch")
    for i, (b, out) in enumerate(zip(batches, outs)):
        _assert_batches_equal(out, run_pipeline(plain, b), f"{name} batch {i}")
    o.snapshot_compile_caches([dp])
    obs_report = obs_checks(name, o, dp, disp, warm_misses)
    steady = ms[WARMUP:]
    disp = disp[WARMUP:]
    stages = dp.profile_stages(batches[-1], iters=5)
    report = {
        "app": name, "batches": len(batches), "warmup": WARMUP,
        "batch_ms": [round(x, 3) for x in ms],
        "steady_ms_median": statistics.median(steady),
        "pkts_per_s": BATCH / (statistics.median(steady) / 1e3),
        "dispatch_ms_median": statistics.median(disp) / 1e3,
        "host_ms_median": statistics.median(steady)
        - statistics.median(disp) / 1e3,
        "hit_rate_pkts": [round(x, 4) for x in hit_rates],
        "lane_slots_M": Ms,
        "dispatch_compiles": dp.dispatch_stats["compiles"],
        "stage_us": {k: round(v, 1) for k, v in stages.items()},
        "launches": launches,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        "equal_to_plain_run_pipeline": True,
        "obs": obs_report,
    }
    return report, dp


def _compile_misses(o):
    """{cache: misses} from the ``compile_cache_miss`` gauges that
    ``Obs.snapshot_compile_caches`` set."""
    return {dict(g.labels)["cache"]: g.value
            for g in o.metrics.series("compile_cache_miss")}


def obs_checks(name, o, dp, disp, warm_misses):
    """What the data plane wrote into its ``Obs``, held to the plane's own
    state: one dispatch time a batch in the histogram (its reservoir exact,
    so the samples are the times themselves), the flow-cache counters
    equal to the flow cache's stats, no compile-cache miss after the
    warm-up, and the dumped artifacts loading back to a trace that answers
    ``query``, ``why`` and ``spans`` as the live one does."""
    import tempfile
    app = dp.app.name
    hist = o.metrics.get("dataplane_dispatch_us", app=app)
    if hist.count != len(disp) or not hist.reservoir.exact:
        raise AssertionError(f"{name}: {hist.count} dispatch samples for "
                             f"{len(disp)} batches")
    if not np.allclose(hist.reservoir.samples(), sorted(disp), rtol=1e-9):
        raise AssertionError(f"{name}: the histogram's samples are not the "
                             f"dispatch times")
    fc = dp.to.flow_cache.stats
    counters = {k: o.metrics.get(f"flow_cache_{k}_total", app=app)
                for k in ("hits", "misses", "evictions", "invalidations")}
    counters = {k: (0 if c is None else c.value) for k, c in counters.items()}
    for k, v in counters.items():
        if v != fc[k]:
            raise AssertionError(f"{name}: flow_cache_{k}_total {v}, the "
                                 f"flow cache counted {fc[k]}")
    misses = _compile_misses(o)
    steady = {c: misses[c] - warm_misses.get(c, 0) for c in misses}
    if any(steady.values()):
        raise AssertionError(f"{name}: compile-cache misses after warm-up "
                             f"{steady}")
    calls = o.metrics.get("dataplane_dispatch_calls_total", app=app).value
    if calls != len(disp) or o.metrics.get(
            "dataplane_dispatch_calls").value != len(disp):
        raise AssertionError(f"{name}: {calls} dispatch calls counted")
    events = {}
    for e in o.trace.events:
        events[e.name] = events.get(e.name, 0) + 1
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        paths = o.dump(tmp, prefix=name)
        loaded = load_trace(paths["trace"])
        records = [json.loads(line) for line in
                   Path(paths["metrics"]).read_text().splitlines()]
        prom = Path(paths["prom"]).read_text()
    js = lambda evs: [e.to_json() for e in evs]
    queries = [{"name": n} for n in sorted(events)] + [
        {"tenant": name}, {"kind": "decision"}, {"tick": WARMUP},
        {"since": WARMUP, "until": len(disp) - 1}]
    if (js(loaded.events) != js(o.trace.events)
            or any(js(loaded.query(**q)) != js(o.trace.query(**q))
                   for q in queries)
            or any(js(loaded.why(name, t)) != js(o.trace.why(name, t))
                   for t in range(len(disp)))
            or loaded.spans() != o.trace.spans()):
        raise AssertionError(f"{name}: the dumped trace answers otherwise "
                             f"than the live one")
    if records != json.loads(json.dumps(o.metrics.to_records())) or (
            prom != o.metrics.render_prometheus()):
        raise AssertionError(f"{name}: the dumped metrics differ")
    return {
        "dispatch_us_p50": hist.quantile(0.5),
        "dispatch_us_p99": hist.quantile(0.99),
        "dispatch_samples": hist.count,
        "flow_cache_counters": counters,
        "flow_cache_stats_hits": fc["hits"],
        "compile_cache": {
            f"{dict(g.labels)['cache']}.{g.name[len('compile_cache_'):]}":
            g.value for g in o.metrics._metrics.values()
            if g.name.startswith("compile_cache_")},
        "compile_cache_misses_after_warmup": steady,
        "trace_events": events,
        "artifact_round_trip_equal": True,
    }


def print_obs(report):
    """The data plane's ``Obs`` line of one app."""
    r = report["obs"]
    print(f"obs {report['app']}: dataplane_dispatch_us p50 "
          f"{r['dispatch_us_p50']:.1f} p99 {r['dispatch_us_p99']:.1f} "
          f"({r['dispatch_samples']} samples); flow_cache_hits_total "
          f"{r['flow_cache_counters']['hits']} == flow cache stats hits "
          f"{r['flow_cache_stats_hits']}; compile-cache misses after "
          f"warm-up {json.dumps(r['compile_cache_misses_after_warmup'])}; "
          f"compile_cache gauges {json.dumps(r['compile_cache'])}; trace "
          f"events {json.dumps(r['trace_events'])}; artifacts round trip "
          f"equal")


def kernel_checks(dp, last_batch, launches_isg, launches_id):
    """Each kernel at the shapes the main path gave it, against its plain
    version on the same inputs, with its time beside its bound."""

    dev = last_batch.device
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)
    M = _bucket(int(max(p.load for p in dp.to.pipelines)))
    rows = PIPELINES * M                    # the chain runs over N*M lanes
    sel = torch.arange(rows, device=dev) % last_batch.batch
    payload = last_batch.payload[sel].contiguous()
    length = last_batch.length[sel].contiguous()
    # the regex stage's own constants: the rules' table and out_count, and
    # the table as the kernel takes it (packed entries, sync depth), built on
    # the host when the stage was made
    regex = next(fn.ucf.consts for fn in dp.app.stages
                 if fn.resource == "regex")
    consts = regex.on(dev)
    table, out_count, packed = (consts["table"], consts["out_count"],
                                consts["packed"])
    depth = regex.derived["depth"]
    want_table, want_count = ref.build_aho_corasick(SNORT_RULES)
    if not (np.array_equal(table.cpu().numpy(), want_table)
            and np.array_equal(out_count.cpu().numpy(), want_count)):
        raise AssertionError("the regex stage's table is not SNORT_RULES'")
    words = payload.view(torch.uint32)      # (rows, 375)
    key = torch.from_numpy(np.array([1, 2, 3, 4], np.uint32)).to(dev)

    cache = dp.to.flow_cache
    planes = cache._device_planes()
    uniq = np.unique(flow_ids(last_batch))
    F = 1 << (len(uniq) - 1).bit_length()
    lo, hi = fl.split_fids(np.concatenate([uniq, np.zeros(F - len(uniq),
                                                         np.int64)]))
    q_lo, q_hi = torch.from_numpy(lo).to(dev), torch.from_numpy(hi).to(dev)
    ep = cache.epoch

    # data-dependent work of the probe: slots read until the first match
    cap, W = cache.capacity, cache.window
    base = fl.bucket_hash(lo, hi) & np.uint32(cap - 1)
    idx = ((base[:, None] + np.arange(W, dtype=np.uint32))
           & np.uint32(cap - 1)).astype(np.int64)
    match = ((cache.key_lo[idx] == lo[:, None])
             & (cache.key_hi[idx] == hi[:, None]) & (cache.pid[idx] >= 0))
    probes = np.where(match.any(1), match.argmax(1) + 1, W)
    touched = np.unique(np.concatenate(
        [idx[i, :probes[i]] for i in range(F)]))
    steps = int(length.clamp(0, PKT_BYTES).sum())
    S = table.shape[0]
    B, Wd = words.shape

    # C2's path: a 256-state rule set (the reference's own example size),
    # too large to pack, walked in the wide form, over the same rows with
    # its patterns planted in every other row
    rules256 = [f"q{i:03d}zz" for i in range(81)] + ["y"]
    t256, o256 = ref.build_aho_corasick(rules256)
    prep256 = dfa_regex.prepare(t256, o256)
    if t256.shape[0] != 256 or prep256.form != "wide16":
        raise AssertionError(f"the 256-state rule set has {t256.shape[0]} "
                             f"states in the {prep256.form} form")
    pay256 = payload.clone()
    for j, pat in enumerate(rules256[::9]):
        at = 40 + 160 * j
        pay256[::2, at:at + len(pat)] = torch.tensor(list(pat.encode()),
                                                     dtype=torch.uint8,
                                                     device=dev)
    t256_d, o256_d, e256, c256 = (torch.from_numpy(a).to(dev) for a in (
        t256, o256, prep256.packed, prep256.counts))

    specs = {
        "flow_lookup": dict(
            run=lambda: fl.lookup_cuda(*planes, q_lo, q_hi, ep, W),
            plain=lambda: fl.pack(*fl.lookup_torch(*planes, q_lo, q_hi, ep,
                                                   W)),
            shape=f"C={cap} F={F} W={W}, out (3, F) int32",
            nbytes=F * 8 + F * 12 + touched.size * 16,
            ops=F * 12 + int(probes.sum()) * 5),
        "dfa_regex": dict(
            run=lambda: dfa_regex.dfa_regex_cuda(payload, length, packed,
                                                 depth),
            plain=lambda: dfa_regex.dfa_scan_torch(payload, length, table,
                                                   out_count),
            shape=f"B={rows} L={PKT_BYTES} S={S} depth={depth} segments="
                  f"{dfa_regex.plan(rows, PKT_BYTES, S, depth)[0]}",
            nbytes=steps + rows * 8 + S * 256 * 4, ops=steps * 4),
        "dfa_regex/256-state": dict(
            run=lambda: dfa_regex.dfa_regex_cuda(pay256, length, e256,
                                                 prep256.depth, c256),
            plain=lambda: dfa_regex.dfa_scan_torch(pay256, length, t256_d,
                                                   o256_d),
            shape=f"B={rows} L={PKT_BYTES} S=256 (wide16, in shared "
                  f"memory) depth={prep256.depth} segments="
                  f"{dfa_regex.plan(rows, PKT_BYTES, 256, prep256.depth, form='wide16')[0]}",
            nbytes=steps + rows * 8 + dfa_regex.smem_bytes(256, "wide16"),
            ops=steps * 4),
        "keyed_hash": dict(
            run=lambda: crypto.keyed_hash_cuda(words, key),
            plain=lambda: crypto.keyed_hash_torch(words, key),
            shape=f"B={B} W={Wd}", nbytes=B * Wd * 4 + B * 16 + 16,
            ops=B * Wd * 7),
        "arx_cipher": dict(
            run=lambda: crypto.arx_cipher_cuda(words, key),
            plain=lambda: crypto.arx_cipher_torch(words, key),
            shape=f"B={B} W={Wd}", nbytes=2 * B * Wd * 4 + 16,
            ops=B * Wd * 64),
    }
    # a plain coalesced read of B3's and B4's input, timed the same way:
    # the least time any kernel that reads those bytes takes here
    read_floor = {"ms": _time_ms(lambda: _build.read_floor(words),
                                 KERNEL_REPS, flush),
                  "ms_l2_warm": _time_ms(lambda: _build.read_floor(words),
                                         KERNEL_REPS, _NoFlush()),
                  "bytes": words.numel() * 4}
    rows_out = {}
    for spec, s in specs.items():
        name, _, label = spec.partition("/")
        got, want = s["run"](), s["plain"]()
        torch.cuda.synchronize()
        if not isinstance(got, tuple):
            got, want = (got,), (want,)
        err = _max_abs_err(got, want)
        if err != 0:
            raise AssertionError(f"{spec}: kernel differs from its plain "
                                 f"version by {err}")
        if label and int(got[0].max()) < 1:
            raise AssertionError(f"{spec}: no match in the planted rows")
        bound_s, bound_by = hw.bound_seconds(s["nbytes"], s["ops"])
        row = {
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name],
            # a variant is a check beside the path, not on it
            "launches": 0 if label else launches_isg[name],
            "launches_by_path": {"ISG": launches_isg[name],
                                 "ID": launches_id[name]},
            "shape": s["shape"], "max_abs_err": err,
            "ms": _time_ms(s["run"], KERNEL_REPS, flush),
            # the same launches with the inputs left in L2 by the last
            "ms_l2_warm": _time_ms(s["run"], KERNEL_REPS, _NoFlush()),
            "plain_ms": _time_ms(s["plain"], PLAIN_REPS, flush),
            "bound_ms": bound_s * 1e3, "bound_by": bound_by,
            "bytes": int(s["nbytes"]), "ops": int(s["ops"]),
            "library_ms": None,
        }
        if name in ("keyed_hash", "arx_cipher"):
            row["input_read_floor"] = read_floor
        if label:
            row["variant"] = label
            rows_out[name].setdefault("variants", {})[label] = row
        else:
            rows_out[name] = row
    return list(rows_out.values())


# -- the control plane (CP2) ---------------------------------------------------

def profile_apps(batch):
    """``measure_app`` on the card for the six apps over ``batch``: exactly
    PROFILE_LAUNCHES launches of each kernel stage's kernel (counts reset
    just before each app, read just after) and none from any other stage,
    the chain's output after profiling equal to the plain ``run_pipeline``
    bit for bit, and the profile's own sums. Algorithm 1's R and the
    simulator's throughput at that R are reported beside the bound
    min(R_s / l_s), not gated. Returns the report and the profiles."""
    report, profiles = {}, {}
    for key, app in ALL_APPS().items():
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        prof = profiles[key] = profiler.measure_app(app, batch,
                                                    iters=PROFILE_ITERS)
        launches = _build.launch_counts()
        want = {k: 0 for k in launches}
        for stage in prof.stages:
            if stage in KERNEL_OF_STAGE:
                want[KERNEL_OF_STAGE[stage]] += PROFILE_LAUNCHES
        if launches != want:
            raise AssertionError(f"measure_app {key}: launches {launches}, "
                                 f"not {want}")
        cur = batch
        for fn in app.stages:
            cur = stage_runner(fn)(cur)
        _assert_batches_equal(cur, run_pipeline(ALL_APPS(impl="torch")[key],
                                                batch), f"measure_app {key}")
        bits_ = prof.batch_bits()
        if prof.l_p != sum(prof.l_s.values()) or (
                prof.t_p != bits_ / max(prof.l_s.values()) / 1e9):
            raise AssertionError(f"measure_app {key}: l_p or t_p is not the "
                                 f"profile's own sum")
        R = replication.num_replication(prof.stages, prof.l_s)
        res = sim.simulate(prof.stages, prof.l_s, R, SIM_SEQS)
        report[key] = {
            "stages": prof.stages, "l_s": prof.l_s, "t_s": prof.t_s,
            "l_p": prof.l_p, "t_p": prof.t_p, "bits": bits_,
            "launches": {k: n for k, n in launches.items() if n},
            "R": R, "sim_seqs_per_s": res.throughput,
            "bound_seqs_per_s": min(R[s] / prof.l_s[s] for s in prof.stages),
        }
        print(f"measure_app {key} on the card: l_s "
              f"{json.dumps({k: round(v * 1e3, 4) for k, v in prof.l_s.items()})}"
              f" ms, l_p {prof.l_p * 1e3:.4f} ms, t_p {prof.t_p:.3f} Gbps; "
              f"R {json.dumps(R)}; sim {res.throughput:.1f} batches/s "
              f"(bound {report[key]['bound_seqs_per_s']:.1f}); launches "
              f"{json.dumps(report[key]['launches'])}")
    return report, profiles


def cost_model_checks(batch, isg):
    """``cost_model_latency`` on ISG's ``ddos_check`` (plain PyTorch) beside
    its measured time, reported; on ``url_check``, whose B2 launch no aten
    op sees, it must refuse and name the kernel."""
    stages = {fn.name: fn for fn in ALL_APPS()["ISG"].stages}
    ddos = stage_runner(stages["ddos_check"])
    flops, nbytes = profiler.op_cost(ddos, batch)
    est = profiler.cost_model_latency(ddos, batch)
    measured = isg["l_s"]["ddos_check"]
    try:
        profiler.op_cost(stage_runner(stages["url_check"]), batch)
    except RuntimeError as err:
        refusal = str(err)
    else:
        raise AssertionError("cost_model_latency counted url_check, whose "
                             "kernel launch it cannot see")
    if "dfa_regex" not in refusal:
        raise AssertionError(f"url_check refused without naming dfa_regex: "
                             f"{refusal}")
    out = {"stage": "ddos_check", "flops": flops, "bytes": nbytes,
           "estimate_ms": est * 1e3, "measured_ms": measured * 1e3,
           "measured_over_estimate": measured / est,
           "url_check_refused": refusal}
    print(f"cost model ISG ddos_check: {flops} FLOPs, {nbytes} B -> "
          f"estimate {est * 1e3:.4f} ms at {hw.HBM_BW:.3g} B/s; measured "
          f"l_s {measured * 1e3:.4f} ms ({measured / est:.2f}x the "
          f"estimate); url_check refused ({refusal})")
    return out


def _sync_without_replica0(value, snapshot):
    """A faulted sync that leaves replica 0's delta out of the sum."""
    delta = value - snapshot
    total = delta[1:].sum(0, keepdim=True)
    return value + (total - delta)


def sync_checks(slots):
    """``bounded_sync_deltas`` on the card: PIPELINES replicas of per-slot
    int64 counters over the flow cache's slots, SYNC_ROUNDS rounds of seeded
    increments, one sync a round, each equal to the host form on the CPU
    bit for bit; after the last every replica holds the global sum. A sync
    that drops replica 0's delta must fail both gates."""
    rng = np.random.default_rng(0)
    value = torch.zeros(PIPELINES, slots, dtype=torch.int64, device="cuda")
    snap = torch.zeros_like(value)
    host_v, host_s = value.cpu(), snap.cpu()
    total = torch.zeros(slots, dtype=torch.int64)
    for r in range(SYNC_ROUNDS):
        inc = torch.from_numpy(rng.integers(0, SYNC_INC_MAX,
                                            size=(PIPELINES, slots)))
        total += inc.sum(0)
        value, host_v = value + inc.cuda(), host_v + inc
        merged, new_snap = state_engine.bounded_sync_deltas(value, snap)
        want, want_snap = state_engine.bounded_sync(host_v, host_s)
        if not (torch.equal(merged.cpu(), want)
                and torch.equal(new_snap.cpu(), want_snap)):
            raise AssertionError(f"sync round {r}: the card's merge differs "
                                 f"from the host form")
        if r == SYNC_ROUNDS - 1:
            faulted = _sync_without_replica0(value, snap).cpu()
            if torch.equal(faulted, want) or bool((faulted == total).all()):
                raise AssertionError("a sync that drops replica 0's delta "
                                     "passed the gate")
        value, snap, host_v, host_s = merged, new_snap, want, want_snap
    if not bool((value.cpu() == total).all()):
        raise AssertionError("after the last sync a replica does not hold "
                             "the global sum")
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    ms = _time_ms(lambda: state_engine.bounded_sync_deltas(value, snap),
                  KERNEL_REPS, flush)
    out = {"replicas": PIPELINES, "slots": slots, "rounds": SYNC_ROUNDS,
           "bytes": value.numel() * 8, "equal_to_host_form": True,
           "faulted_sync_rejected": True, "sync_ms_median": ms}
    print(f"bounded_sync_deltas on the card: {PIPELINES} replicas x {slots} "
          f"int64 slots, {SYNC_ROUNDS} rounds, each merge equal to the host "
          f"form, every replica at the global sum; a sync that drops replica "
          f"0's delta is rejected; one sync {ms:.4f} ms (median of "
          f"{KERNEL_REPS}, L2 flushed)")
    return out


def placement_check(model, latencies):
    """Algorithm 2 places the measured plan's segments over
    ``tpu_pod_pool()``; ``commit`` then ``release`` leave the pool's ledger
    with no problem."""
    pool = tpu_pod_pool()
    plan = plan_serving(model, latencies, pool=pool)
    alloc = plan.allocation
    need = {s: CPU for s in plan.stages}
    if not alloc.satisfied():
        raise AssertionError(f"placement left {alloc.unmet} unplaced")
    commit(pool, alloc, need)
    held = {n: {CPU: sum(row.values())} for n, row in alloc.A.items()
            if any(row.values())}
    problems = pool.check_ledger([held], [alloc.bw_charge], strict=False)
    release(pool, alloc, need)
    problems += pool.check_ledger(strict=False)
    if problems:
        raise AssertionError(f"pool ledger after commit/release: {problems}")
    print("control plane placement of the measured plan over tpu_pod_pool():")
    print(plan.summary())
    return {"stages": plan.stages, "R": plan.R,
            "nics": {s: alloc.nics_for(s) for s in plan.stages},
            "bw_charge": {n: c for n, c in alloc.bw_charge.items() if c},
            "ledger_problems": problems}


# -- the control plane (CP3) ---------------------------------------------------

def _pool_free(pool):
    return {n: (dict(st.free), st.free_bw_gbps)
            for n, st in pool.nics.items()}


def _ledger(ctrl, step, report):
    """``check_ledger(strict=True)`` after a lifecycle step: it raises on a
    problem, and must return no entries."""
    problems = ctrl.check_ledger(strict=True)
    if problems:
        raise AssertionError(f"ledger after {step}: {problems}")
    report["ledger_checks"].append(step)


def _plane_check(ctrl, key, batches, step, report, launches_total):
    """The deployment's data plane built as the service runtime builds it
    (``ParallelDataPlane`` with its pipelines and ``_pipeline_capacity``,
    writing into the controller's ``Obs``), on the card: every output equal
    to the plain ``run_pipeline`` bit for bit, and B1 plus each kernel
    stage's kernel launched once a batch (counts reset just before, read
    just after), as on the main path."""
    dep = ctrl.deployments[ALL_APPS()[key].name]
    cap = ctrl._pipeline_capacity(dep.profile, dep.num_pipelines)
    dp = ParallelDataPlane(dep.app, num_pipelines=dep.num_pipelines,
                           capacity_per_pipeline=cap,
                           metrics=ctrl.obs.metrics, trace=ctrl.obs.trace)
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    outs = [dp.process(b, tenant=dep.tenant) for b in batches]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / len(batches)
    launches = _build.launch_counts()
    want = {k: 0 for k in launches}
    want["flow_lookup"] = len(batches)
    for stage in dep.profile.stages:
        if stage in KERNEL_OF_STAGE:
            want[KERNEL_OF_STAGE[stage]] = len(batches)
    if launches != want:
        raise AssertionError(f"{key} plane ({step}): launches {launches}, "
                             f"not {want}")
    plain = ALL_APPS(impl="torch")[key]
    for i, (b, out) in enumerate(zip(batches, outs)):
        _assert_batches_equal(out, run_pipeline(plain, b),
                              f"{key} plane ({step}) batch {i}")
    for k, n in launches.items():
        launches_total[k] = launches_total.get(k, 0) + n
    row = {"app": key, "step": step, "pipelines": dep.num_pipelines,
           "capacity_per_pipeline": cap, "batches": len(batches),
           "ms_per_batch": ms, "launches": {k: n for k, n in launches.items()
                                            if n},
           "equal_to_plain_run_pipeline": True}
    report["planes"].append(row)
    print(f"controller plane {key} ({step}): {dep.num_pipelines} pipelines, "
          f"{len(batches)} batches, {ms:.3f} ms a batch, outputs equal to "
          f"the plain run_pipeline; launches {json.dumps(row['launches'])}")


def _print_deployment(key, dep):
    stages = dep.profile.stages
    print(f"controller deploy {key} ({dep.app.name}): target {dep.target_gbps:.1f} "
          f"Gbps, R {json.dumps(dep.R)}, r_s {json.dumps(dep.r_s)}, NICs "
          f"{json.dumps({s: dep.allocation.nics_for(s) for s in stages})}, "
          f"{dep.num_pipelines} pipelines, achievable "
          f"{dep.achievable_gbps:.1f} Gbps")


def _deployment_row(dep):
    stages = dep.profile.stages
    return {"target_gbps": dep.target_gbps, "R": dep.R, "r_s": dep.r_s,
            "nics": {s: dep.allocation.nics_for(s) for s in stages},
            "num_pipelines": dep.num_pipelines,
            "achievable_gbps": dep.achievable_gbps}


def _migration_flow_check(dep, before, ctx):
    """After a migration every flow the deployment's TO had homed keeps its
    identity on an active pipeline, and none waits in the side buffer."""
    active = {p.pid for p in dep.to.pipelines if p.active}
    if set(dep.to.flow_table) != set(before):
        raise AssertionError(f"{ctx}: flows changed identity")
    if not set(dep.to.flow_table.values()) <= active:
        raise AssertionError(f"{ctx}: a flow landed on a halted pipeline")
    if dep.to.halted_flows:
        raise AssertionError(f"{ctx}: {len(dep.to.halted_flows)} flows "
                             f"still halted")


def controller_checks(profiles, batches):
    """The §2.2 workflow on the card: the controller places the six apps
    over ``paper_cluster()`` from their measured profiles, each deployment's
    data plane runs on the card against the plain ``run_pipeline``, then the
    lifecycle (adaptive scale up and down, defragmentation or a migration,
    a forced migration with a NIC failing mid-way, replication and
    failover with the state restored, terminate), the pool's ledger checked
    after every step and at its baseline at the end."""
    steps = itertools.count()
    pool = paper_cluster()
    base = _pool_free(paper_cluster())
    ctrl = MeiliController(pool, clock=lambda: 0.25 * next(steps))
    apps = ALL_APPS()
    name = {key: app.name for key, app in apps.items()}
    report = {"deployments": {}, "planes": [], "ledger_checks": [],
              "lifecycle": {}}
    launches = {}
    for key, mult in CTRL_TARGETS.items():
        prof = profiles[key]
        dep = ctrl.submit(apps[key], mult * prof.t_p, prof,
                          backup_nic="bf1-0" if key == "ID" else None)
        if not dep.allocation.satisfied():
            if key in CTRL_REQUIRED:
                raise AssertionError(f"{key} did not place at "
                                     f"{mult} x t_p: {dep.allocation.unmet}")
            ctrl.terminate(name[key])
            print(f"controller deploy {key}: unplaceable at {mult} x t_p, "
                  f"terminated")
            continue
        _print_deployment(key, dep)
        report["deployments"][key] = _deployment_row(dep)
    _ledger(ctrl, "submit", report)
    crypto = {s: ctrl.deployments[name["ISG"]].r_s[s]
              for s in ("sha", "aes")}
    if max(crypto.values()) > 2:
        raise AssertionError(f"ISG holds {crypto} crypto units a stage")
    if max(d.num_pipelines for d in ctrl.deployments.values()) < 2:
        raise AssertionError("no deployment runs 2 or more pipelines")
    for key in report["deployments"]:
        _plane_check(ctrl, key, batches, "deploy", report, launches)

    # adaptive scale up, then down; the plane rebuilt at each new size
    key, up, down = CTRL_SCALE
    life = report["lifecycle"]
    for step, mult in (("scale_up", up), ("scale_down", down)):
        before = ctrl.deployments[name[key]].num_pipelines
        dep = ctrl.adaptive_scale(name[key], mult * profiles[key].t_p)
        _ledger(ctrl, step, report)
        life[step] = {"app": key, "pipelines": [before, dep.num_pipelines],
                      "r_s": dep.r_s, "achievable_gbps": dep.achievable_gbps}
        print(f"controller {step} {key}: {before} -> {dep.num_pipelines} "
              f"pipelines, r_s {json.dumps(dep.r_s)}, achievable "
              f"{dep.achievable_gbps:.1f} Gbps")
        if dep.num_pipelines == before:
            raise AssertionError(f"{step} left {key} at {before} pipelines")
        _plane_check(ctrl, key, batches[:CTRL_REBUILD_BATCHES], step,
                     report, launches)

    # flows homed in every deployment's TO, then defragment (or migrate)
    for dep in ctrl.deployments.values():
        dep.to.partition_assign(batches[0])
    homes = {k: dict(d.to.flow_table) for k, d in ctrl.deployments.items()}
    moved = ctrl.defragment(max_migrations=2, min_score=1.0)
    how = "defragment"
    if not moved:
        how = "migrate"
        for k in ctrl.deployments:
            ev = ctrl.migrate(k, require_improvement=False)
            if ev is not None:
                moved = [ev]
                break
    if not moved:
        raise AssertionError("neither defragment nor migrate moved a "
                             "deployment")
    _ledger(ctrl, how, report)
    for ev in moved:
        _migration_flow_check(ctrl.deployments[ev["app"]], homes[ev["app"]],
                              f"{how} {ev['app']}")
    life[how] = [{k: ev[k] for k in ("app", "nics_before", "nics_after",
                                     "hop_pairs_before", "hop_pairs_after")}
                 for ev in moved]
    print(f"controller {how}: " + json.dumps(life[how]))

    # a forced migration with a NIC failing mid-way: failover inside migrate.
    # The first deployment with an admissible plan moves (ISG cannot: its
    # sha and aes hold every crypto engine, and a plan takes free units only)
    failed = []

    def on_swap(app_name):
        nic = sorted(ctrl.deployments[app_name].nics_used())[0]
        failed.append(nic)
        ctrl.handle_failure(nic)

    ctrl.mid_migration_hook = on_swap
    for key in ("FW", "ID", "FM", "LLB", "ICG", "ISG"):
        if name[key] not in ctrl.deployments:
            continue
        before = dict(ctrl.deployments[name[key]].to.flow_table)
        pipes = ctrl.deployments[name[key]].num_pipelines
        ev = ctrl.migrate(name[key], forced=True, require_improvement=False)
        if ev is not None:
            break
    ctrl.mid_migration_hook = None
    if ev is None or not failed:
        raise AssertionError("no forced migration committed with its "
                             "mid-migration failure")
    _ledger(ctrl, "migrate_mid_failure", report)
    _migration_flow_check(ctrl.deployments[name[key]], before,
                          "migrate with a mid-migration failure")
    tr = ctrl.obs.trace
    mig = tr.spans(name="migrate")[-1]
    fo = tr.spans(name="failover")[-1]
    if fo.parent_id != mig.span_id or mig.detail.get("outcome") != \
            "committed":
        raise AssertionError("the failover span is not inside the committed "
                             "migrate span")
    life["migrate_mid_failure"] = {"app": key, "failed_nic": failed[0],
                                   "nics_after": ev["nics_after"],
                                   "failover_inside_migrate": True}
    print(f"controller migrate {key} with {failed[0]} failing mid-way: "
          f"committed onto {ev['nics_after']}; failover span inside the "
          f"migrate span")
    if ctrl.deployments[name[key]].num_pipelines != pipes:
        _plane_check(ctrl, key, batches[:CTRL_REBUILD_BATCHES],
                     "migrate_mid_failure", report, launches)

    # replicate ID's state to its backup NIC, fail one of its NICs, restore
    key = "ID"
    dep = ctrl.deployments[name[key]]
    s_name = next(iter(dep.app.state_decls))
    victim = sorted(n for n in dep.nics_used() if pool[n].alive)[0]
    ctrl.state.ne_set(s_name, 0xC0FFEE, local=victim)
    ctrl.replicate_for_failover(name[key])
    if dep.state_snapshot != {s_name: 0xC0FFEE}:
        raise AssertionError(f"replication snapshot {dep.state_snapshot}")
    pipes = dep.num_pipelines
    impacted = ctrl.handle_failure(victim)
    _ledger(ctrl, "failover", report)
    dep = ctrl.deployments[name[key]]
    if name[key] not in impacted or victim in dep.nics_used():
        raise AssertionError(f"failover of {victim} left {key} on it")
    restored = {n: ctrl.state.get(s_name, local=n) for n in pool.names()}
    if any(v != 0xC0FFEE for v in restored.values()):
        raise AssertionError(f"state not restored from the snapshot: "
                             f"{restored}")
    life["failover"] = {"nic": victim, "impacted": impacted,
                        "r_s": dep.r_s, "state_restored_on": len(restored)}
    print(f"controller failover {victim}: impacted {impacted}, {key} r_s "
          f"{json.dumps(dep.r_s)}, {s_name} restored from the snapshot on "
          f"{len(restored)} live NICs")
    if dep.num_pipelines != pipes:
        _plane_check(ctrl, key, batches[:CTRL_REBUILD_BATCHES], "failover",
                     report, launches)

    for app_name in list(ctrl.deployments):
        ctrl.terminate(app_name)
    _ledger(ctrl, "terminate", report)
    end = _pool_free(pool)
    for n, (units, bw) in base.items():
        if end[n][0] != units or abs(end[n][1] - bw) > 1e-6:
            raise AssertionError(f"{n} ends at {end[n]}, not its baseline "
                                 f"{(units, bw)}")
    if pool.usage_snapshot():
        raise AssertionError(f"usage left: {pool.usage_snapshot()}")
    report["pool_at_baseline"] = True
    report["events"] = [e["event"] for e in ctrl.events]
    report["trace_spans"] = len(tr.spans())
    return report, launches


def _dwrr_governors(weights, device):
    scalar, kernel = ResourceGovernor(), ResourceGovernor()
    for t, w in weights.items():
        scalar.register(t, TenantQuota(weight=w))
        kernel.register(t, TenantQuota(weight=w))
    sched = sched_kernel.VectorizedScheduler(device=device)
    kernel.attach_kernel(sched)
    return scalar, kernel, sched


def _deficit_gaps(scalar, sched, budget, weights, served_s):
    """Kernel deficits (one read) against the scalar's, per tenant: the
    errors at the contract's per-tenant tolerance, and the largest gap in
    units of the tenant's quantum * weight."""
    quantum = budget / (8.0 * sum(weights.values()))
    kernel = sched.deficits()
    errs, worst = [], 0.0
    for t, w in weights.items():
        tol = max(sched_kernel.ATOL, 1.05 * quantum * w
                  + sched_kernel.RTOL * served_s[t])
        gap = abs(kernel[t] - scalar._deficit.get(t, 0.0))
        worst = max(worst, gap / (quantum * w))
        if gap > tol:
            errs.append(f"{t}: deficit off by {gap} (tolerance {tol})")
    return errs, worst


def dwrr_checks(device="cuda"):
    """The governor's DWRR tick with ``VectorizedScheduler`` on the card,
    against the scalar governor on the same seeded inputs: the reference's
    200-tenant smoke and the same at 1,024 tenants (a warm-up tick, then
    DWRR_TICKS timed ticks: every tick within the contract, no new shape
    key, rounds and host reads per tick), a DWRR_CAPPED_TICKS run with
    random rate caps and budgets (every tick, and the persistent deficits,
    within the contract), and a faulted tick (one tenant's weight doubled
    in the kernel's copy only) that the contract must reject."""
    rounds = []
    step = sched_kernel.dwrr_step

    def counted_step(*args, **kw):
        out = step(*args, **kw)
        rounds.append(out[3])
        return out

    sched_kernel.dwrr_step = counted_step
    try:
        return _dwrr_cases(device, rounds)
    finally:
        sched_kernel.dwrr_step = step


def _dwrr_cases(device, rounds):
    out = {}
    for n in DWRR_TENANTS:
        weights = {f"m{i:04d}": float(1 + i % 4) for i in range(n)}
        scalar, kernel, sched = _dwrr_governors(weights, device)
        rng = random.Random(0)
        caps = {t: DWRR_CAP for t in weights}
        times, scalar_times, worst = [], [], 0.0
        for tick in range(1 + DWRR_TICKS):
            q = {t: rng.uniform(0.0, 1e5) for t in weights}
            t0 = time.perf_counter()
            o_s, s_s = scalar.dwrr_schedule(dict(q), caps,
                                            capacity_bytes=DWRR_BUDGET)
            scalar_times.append(time.perf_counter() - t0)
            if tick == 1:           # after the warm-up tick
                sched_kernel.reset_trace_counts()
                sched_kernel.reset_host_reads()
                del rounds[:]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            o_k, s_k = kernel.dwrr_schedule(dict(q), caps,
                                            capacity_bytes=DWRR_BUDGET)
            times.append(time.perf_counter() - t0)
            errs = sched_kernel.contract_errors(o_s, s_s, o_k, s_k,
                                                DWRR_BUDGET, weights,
                                                check_order=(tick == 0))
            if errs:
                raise AssertionError(f"DWRR {n} tenants, tick {tick}: "
                                     f"{errs[:3]}")
            quantum = DWRR_BUDGET / (8.0 * sum(weights.values()))
            worst = max(worst, max(abs(s_k[t] - s_s[t]) / (quantum * w)
                                   for t, w in weights.items()))
        keys = sched_kernel.trace_counts()
        if keys:
            raise AssertionError(f"DWRR {n} tenants: new shape keys after "
                                 f"warm-up {keys}")
        reads = sched_kernel.host_reads()
        case = {"tenants": n, "rows": sched._padded, "ticks": DWRR_TICKS,
                "ms_per_tick_median": statistics.median(times[1:]) * 1e3,
                "warmup_ms": times[0] * 1e3,
                "scalar_ms_per_tick_median":
                    statistics.median(scalar_times[1:]) * 1e3,
                "rounds": sorted(set(rounds)),
                "host_reads_per_tick": sum(reads.values()) / DWRR_TICKS,
                "host_reads": reads, "new_shape_keys_after_warmup": 0,
                "max_served_gap_in_quanta": worst,
                "within_contract": True}

        # a capped run: random caps and budgets, deficits persisting
        scalar, kernel, sched = _dwrr_governors(weights, device)
        rng = random.Random(1)
        worst_d = 0.0
        for tick in range(DWRR_CAPPED_TICKS):
            q = {t: rng.uniform(0.0, 1e5) for t in weights}
            caps_t = {t: rng.uniform(1e4, 6e4) for t in weights}
            budget = rng.uniform(0.5, 4.0) * DWRR_BUDGET * n / 200
            o_s, s_s = scalar.dwrr_schedule(dict(q), caps_t,
                                            capacity_bytes=budget)
            o_k, s_k = kernel.dwrr_schedule(dict(q), caps_t,
                                            capacity_bytes=budget)
            errs = sched_kernel.contract_errors(
                o_s, s_s, o_k, s_k, budget, weights, check_order=(tick == 0))
            d_errs, gap = _deficit_gaps(scalar, sched, budget, weights, s_s)
            if errs or d_errs:
                raise AssertionError(f"DWRR capped {n} tenants, tick "
                                     f"{tick}: {(errs + d_errs)[:3]}")
            worst_d = max(worst_d, gap)
        case["capped_ticks"] = DWRR_CAPPED_TICKS
        case["capped_within_contract"] = True
        case["capped_max_deficit_gap_in_quanta"] = worst_d
        out[n] = case
        print(f"DWRR tick on the card, {n} tenants ({sched._padded} rows): "
              f"{case['ms_per_tick_median']:.3f} ms a tick (median of "
              f"{DWRR_TICKS}; the scalar governor on the host "
              f"{case['scalar_ms_per_tick_median']:.3f} ms), rounds "
              f"{case['rounds']}, "
              f"{case['host_reads_per_tick']:.2f} host reads a tick, no new "
              f"shape key after warm-up; every tick within the contract "
              f"(largest served gap {worst:.2e} quanta); {DWRR_CAPPED_TICKS} "
              f"capped ticks within it, deficits within {worst_d:.2e} quanta")

    # the faulted reading: one tenant's weight doubled in the kernel's copy
    n = DWRR_TENANTS[0]
    weights = {f"m{i:04d}": float(1 + i % 4) for i in range(n)}
    scalar, _, sched = _dwrr_governors(weights, device)
    rng = random.Random(0)
    q = {t: rng.uniform(0.0, 1e5) for t in weights}
    caps = {t: DWRR_CAP for t in weights}
    o_s, s_s = scalar.dwrr_schedule(dict(q), caps, capacity_bytes=DWRR_BUDGET)
    victim = max((t for t in weights if min(q[t], caps[t]) > 2 * s_s[t]),
                 key=lambda t: (s_s[t], t))
    bad = dict(weights, **{victim: 2 * weights[victim]})
    o_f, s_f = sched.schedule(dict(q), caps, DWRR_BUDGET, weights=bad)
    errs = sched_kernel.contract_errors(o_s, s_s, o_f, s_f, DWRR_BUDGET,
                                        weights)
    if not any(e.startswith(f"{victim}:") for e in errs):
        raise AssertionError(f"a tick with {victim}'s weight doubled passed "
                             f"the contract")
    out["faulted"] = {"tenant": victim, "weight": weights[victim],
                      "served_scalar": s_s[victim],
                      "served_faulted": s_f[victim], "rejected": True}
    print(f"DWRR faulted tick ({victim}'s weight {weights[victim]} doubled "
          f"in the kernel's copy): served {s_f[victim]:.1f} against the "
          f"scalar's {s_s[victim]:.1f}; rejected by the contract")
    return out


# -- the service runtime (CP4) -------------------------------------------------

def _fixed_clock():
    steps = itertools.count()
    return lambda: 0.25 * next(steps)


class _ServiceTap:
    """Thin wrappers, for one run, around ``ParallelDataPlane.process``
    (each batch, its output, the plane's flow-cache counters and the time
    to completion) and ``VectorizedScheduler.schedule`` (its time and host
    reads a tick). ``drop`` = (tenant, tick): the scheduler's served bytes
    for that tenant at that tick are set to 0 (the negative control)."""

    def __init__(self, keep=True, drop=None):
        self.keep, self.drop = keep, drop
        self.planes = []        # (tenant, batch, output)
        self.plane_ms = {}      # tenant -> ms a batch, each call
        self.fast = []          # (tenant, hit_pkts, miss_pkts, fallbacks)
        self.dwrr_ms, self.dwrr_reads = [], []

    def __enter__(self):
        proc = self._proc = ParallelDataPlane.process
        sched = self._sched = sched_kernel.VectorizedScheduler.schedule
        tap = self

        def process(dp, batch, tenant=None):
            fs0 = dict(dp.to.fast_stats)
            t0 = time.perf_counter()
            out = proc(dp, batch, tenant=tenant)
            _sync(dp.device)
            tap.plane_ms.setdefault(tenant, []).append(
                (time.perf_counter() - t0) * 1e3)
            fs = dp.to.fast_stats
            tap.fast.append((tenant, fs["hit_pkts"] - fs0["hit_pkts"],
                             fs["miss_pkts"] - fs0["miss_pkts"],
                             fs["fallbacks"] - fs0["fallbacks"]))
            if tap.keep:
                tap.planes.append((tenant, batch, out))
            return out

        def schedule(s, *args, **kw):
            r0 = sum(sched_kernel.host_reads().values())
            t0 = time.perf_counter()
            order, served = sched(s, *args, **kw)
            tap.dwrr_ms.append((time.perf_counter() - t0) * 1e3)
            tap.dwrr_reads.append(sum(sched_kernel.host_reads().values())
                                  - r0)
            if tap.drop is not None and len(tap.dwrr_ms) - 1 == tap.drop[1] \
                    and tap.drop[0] in served:
                served = dict(served, **{tap.drop[0]: 0.0})
            return order, served

        ParallelDataPlane.process = process
        sched_kernel.VectorizedScheduler.schedule = schedule
        return self

    def __exit__(self, *exc):
        ParallelDataPlane.process = self._proc
        sched_kernel.VectorizedScheduler.schedule = self._sched


def _service_runtime(device, scenario, tenants=None, chaos=True,
                     flight_dir=None, **cfg):
    """A runtime over ``paper_cluster()`` with every clock fixed, so that a
    replay on another device compares with ``==``."""
    o = Obs(clock=_fixed_clock())
    ctrl = MeiliController(paper_cluster(), clock=_fixed_clock(), obs=o)
    registry = TenantRegistry(ctrl)
    mix = [s for s in default_tenant_mix()
           if tenants is None or s.name in tenants]
    for spec in mix:
        registry.register(spec)
    wl = make_scenario(scenario, contracts(mix), seed=0)
    rcfg = RuntimeConfig(dataplane_every=1, vectorized_sched=True,
                         flight_dir=flight_dir, **cfg)
    rt = ServiceRuntime(ctrl, registry, wl, rcfg, device=device,
                        recovery=RecoveryConfig(park=True, brownout=True)
                        if chaos else None)
    registry.admit_all()
    engine = ChaosEngine(FaultPlan([
        FaultEvent(tick=t, kind=k, nic=n, fraction=f)
        for t, k, n, f in SERVICE_FAULTS])) if chaos else None
    return rt, engine


def _service_record(rt):
    return {"tenant_ticks": [dataclasses.asdict(t)
                             for t in rt.telemetry.tenant_ticks],
            "cluster_ticks": [dataclasses.asdict(c)
                              for c in rt.telemetry.cluster_ticks],
            "faults": [dataclasses.asdict(f)
                       for f in rt.telemetry.fault_events],
            "alerts": [dataclasses.asdict(t)
                       for t in rt.alerts.transitions],
            "dataplane": rt.dataplane_stats()}


def _replay_errors(got, want):
    """Each record that differs: its field, its index and the first key."""
    errs = []
    for field in want:
        a, b = got[field], want[field]
        if a == b:
            continue
        if isinstance(a, list) and len(a) == len(b):
            i = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
            keys = [k for k in a[i] if a[i][k] != b[i][k]]
            errs.append(f"{field}[{i}] {keys}: {a[i]} != {b[i]}")
        else:
            errs.append(f"{field}: {str(a)[:200]} != {str(b)[:200]}")
    return errs


def _service_run(rt, engine, ticks, tap):
    """Run ``ticks`` one at a time; ms a tick, the launch counts (set to 0
    just before, read just after) and the planes' new dispatch shape keys
    after the warm-up ticks (DWRR shape keys and host reads are reset
    there too)."""
    times = []
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    with tap:
        for tick in range(ticks):
            if tick == SERVICE_WARMUP:
                sched_kernel.reset_trace_counts()
                sched_kernel.reset_host_reads()
                warm = compile_cache_stats()["dispatch"]["miss"]
            t0 = time.perf_counter()
            rt.run(1, chaos=engine)
            times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    launches = _build.launch_counts()
    return times, launches, compile_cache_stats()["dispatch"]["miss"] - warm


def _service_gates(name, rt, tap, launches, times):
    """The planes' outputs against the plain ``run_pipeline`` bit for bit,
    each dispatch's launches, the DWRR's host reads and shape keys, and the
    ledger; returns the run's numbers."""
    want = {k: 0 for k in launches}
    plain = {}
    for tenant, batch, out in tap.planes:
        spec = rt.registry.specs[tenant]
        key = tenant[len("t-"):].upper()
        if key not in plain:
            plain[key] = ALL_APPS(impl="torch")[key]
        _assert_batches_equal(out, run_pipeline(plain[key], batch),
                              f"service {name} {tenant}")
        want["flow_lookup"] += 1
        for stage in spec.app.stage_names():
            if stage in KERNEL_OF_STAGE:
                want[KERNEL_OF_STAGE[stage]] += 1
    if launches != want:
        raise AssertionError(f"service {name}: launches {launches}, not "
                             f"{want} for {len(tap.planes)} dispatches")
    steady_reads = tap.dwrr_reads[SERVICE_WARMUP:]
    if max(steady_reads) > SERVICE_MAX_READS:
        raise AssertionError(f"service {name}: {max(steady_reads)} host "
                             f"reads in one DWRR tick")
    keys = sched_kernel.trace_counts()
    if keys:
        raise AssertionError(f"service {name}: DWRR shape keys after the "
                             f"warm-up {keys}")
    problems = rt.ctrl.check_ledger(strict=True)
    if problems:
        raise AssertionError(f"service {name}: ledger {problems}")
    steady = slice(SERVICE_WARMUP, None)
    plane_ms = {t: statistics.median(v[SERVICE_WARMUP:] or v)
                for t, v in sorted(tap.plane_ms.items())}
    return {"ticks": len(times), "tenants": sorted(rt.registry.specs),
            "runtime_ms_per_tick_median": statistics.median(times[steady]),
            "runtime_ms_per_tick_warmup": times[:SERVICE_WARMUP],
            "plane_ms_per_batch_median": plane_ms,
            "dwrr_ms_per_tick_median": statistics.median(
                tap.dwrr_ms[steady]),
            "dwrr_host_reads_per_tick_max": max(steady_reads),
            "dwrr_new_shape_keys_after_warmup": 0,
            "dispatches": len(tap.planes), "launches": {
                k: n for k, n in launches.items() if n},
            "outputs_equal_to_plain_run_pipeline": True,
            "ledger_clean": True}


def service_checks():
    """The service runtime on the card (CP4): R1, the six-tenant mix under
    the chaos scenario and a crash, a gray NIC and a crash inside a
    migration, every tenant's plane, the DWRR tick, the SLO engine, alerts
    and flight recorder on the card path, held to its replay on the CPU;
    a replay whose scheduler drops one tenant's served bytes for one tick
    must fail that gate. R2, megaflow traffic at 16,384 x 1,500 B packets
    a tick over 10^5 flows through t-isg and t-fw."""
    import tempfile
    out = {}
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        rt, engine = _service_runtime(
            "cuda", "chaos", slo_enabled=True, gray_detect=True,
            flight_dir=str(Path(tmp) / "cuda"))
        tap = _ServiceTap()
        times, launches, new_keys = _service_run(rt, engine, SERVICE_TICKS,
                                                 tap)
        r1 = _service_gates("R1", rt, tap, launches, times)
        r1["faults_fired"] = [ev.kind for ev in engine.fired]
        r1["sentinel_checks"] = len(engine.fired)
        r1["dispatch_shape_keys_after_warmup"] = new_keys
        r1["fault_records"] = {}
        for f in rt.telemetry.fault_events:
            r1["fault_records"][f.kind] = r1["fault_records"].get(
                f.kind, 0) + 1
        tr = rt.alerts.transitions
        r1["pages"] = sum(t.severity == PAGE and t.state == FIRING
                          for t in tr)
        r1["warnings"] = sum(t.severity == WARN and t.state == FIRING
                             for t in tr)
        r1["flight_bundles"] = len(rt.flight.dumps)
        r1["events"] = {}
        for e in rt.ctrl.events:
            r1["events"][e["event"]] = r1["events"].get(e["event"], 0) + 1
        got = _service_record(rt)
        del tap

        # the replay on the CPU, then the negative control
        t0 = time.perf_counter()
        replays = {}
        for label, drop in (("replay", None), ("faulted", SERVICE_DROP)):
            rp, ep = _service_runtime(
                "cpu", "chaos", slo_enabled=True, gray_detect=True,
                flight_dir=str(Path(tmp) / label))
            with _ServiceTap(keep=False, drop=drop):
                rp.run(SERVICE_TICKS, chaos=ep)
            replays[label] = _replay_errors(got, _service_record(rp))
        if replays["replay"]:
            raise AssertionError(f"service R1 differs from its CPU replay: "
                                 f"{replays['replay'][:3]}")
        if not replays["faulted"]:
            raise AssertionError(f"a replay with {SERVICE_DROP[0]}'s served "
                                 f"bytes dropped at tick {SERVICE_DROP[1]} "
                                 f"passed the replay gate")
        r1["replay_equal"] = True
        r1["replay_seconds"] = time.perf_counter() - t0
        r1["faulted_replay_rejected"] = {
            "tenant": SERVICE_DROP[0], "tick": SERVICE_DROP[1],
            "first_difference": replays["faulted"][0][:300]}
        out["R1"] = r1
        print(f"service R1 (chaos, {SERVICE_TICKS} ticks, 6 tenants, "
              f"{r1['dispatches']} plane dispatches): "
              f"{r1['runtime_ms_per_tick_median']:.3f} ms a tick, DWRR "
              f"{r1['dwrr_ms_per_tick_median']:.3f} ms a tick (at most "
              f"{r1['dwrr_host_reads_per_tick_max']} host reads), plane ms "
              f"a batch {json.dumps(r1['plane_ms_per_batch_median'])}; "
              f"faults {json.dumps(r1['fault_records'])}, pages "
              f"{r1['pages']}, warnings {r1['warnings']}, flight bundles "
              f"{r1['flight_bundles']}; equal to its CPU replay, the "
              f"faulted replay rejected")

    # R2: megaflow at the main path's size
    rt, _ = _service_runtime("cuda", "megaflow", tenants=MEGAFLOW_TENANTS,
                             chaos=False, max_pkts_per_tick=MEGAFLOW_PKTS,
                             pkt_bytes=MEGAFLOW_PKT_BYTES)
    tap = _ServiceTap()
    times, launches, new_keys = _service_run(rt, None, MEGAFLOW_TICKS, tap)
    r2 = _service_gates("R2", rt, tap, launches, times)
    if new_keys:
        raise AssertionError(f"service R2: {new_keys} new dispatch shape "
                             f"keys after the warm-up")
    r2["dispatch_shape_keys_after_warmup"] = 0
    steady = tap.fast[SERVICE_WARMUP * len(MEGAFLOW_TENANTS):]
    hits = sum(h for _, h, _, _ in steady)
    misses = sum(m for _, _, m, _ in steady)
    r2["flow_cache_hit_rate_pkts"] = hits / max(1, hits + misses)
    r2["flow_cache_hit_rate_pkts_all_ticks"] = (
        sum(h for _, h, _, _ in tap.fast)
        / max(1, sum(h + m for _, h, m, _ in tap.fast)))
    r2["fallbacks"] = sum(f for *_, f in tap.fast)
    r2["packets_per_tick"] = MEGAFLOW_PKTS
    r2["events"] = [e["event"] for e in rt.ctrl.events]
    out["R2"] = r2
    print(f"service R2 (megaflow, {MEGAFLOW_TICKS} ticks, "
          f"{len(MEGAFLOW_TENANTS)} tenants x {MEGAFLOW_PKTS} x "
          f"{MEGAFLOW_PKT_BYTES} B packets): "
          f"{r2['runtime_ms_per_tick_median']:.3f} ms a tick, DWRR "
          f"{r2['dwrr_ms_per_tick_median']:.3f} ms a tick, plane ms a batch "
          f"{json.dumps(r2['plane_ms_per_batch_median'])}; flow-cache hit "
          f"rate {r2['flow_cache_hit_rate_pkts']:.4f} of packets after the "
          f"warm-up ({r2['fallbacks']} fallbacks)")
    del tap
    return out


# -- LM serving ---------------------------------------------------------------

def _check_logits(name, got, want, tol, ref_margin=None, ref_tokens=None):
    """max |got - want| within tol (atol = rtol = tol); where ``ref_margin``
    exceeds 2 tol, argmax(want) must equal ``ref_tokens``. Returns the max
    abs error and the number of greedy tokens checked."""
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, atol=tol, rtol=tol):
        raise AssertionError(f"{name}: logits differ from the plain run by "
                             f"{err} (tolerance {tol})")
    checked = 0
    if ref_margin is not None:
        sure = ref_margin > 2 * tol
        if not torch.equal(want.argmax(-1)[sure], ref_tokens[sure]):
            raise AssertionError(f"{name}: greedy tokens differ where the "
                                 f"margin exceeds {2 * tol}")
        checked = int(sure.sum())
    return err, checked


def _profile(fn):
    """One call of ``fn`` under ``torch.profiler``: its wall ms (profiler
    on), the device ms summed over the kernels and copies it ran, and the
    eight kernels that took most device time, as (name, ms, calls)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ms, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    return {"wall_ms_profiled": wall,
            "device_ms": sum(ms for ms, _ in by_name.values()),
            "device_launches": sum(n for _, n in by_name.values()),
            "top_kernels": [(name[:80], ms, n) for name, (ms, n) in top]}


def _margin(lg):
    top2 = lg.topk(2, dim=-1).values
    return top2[..., 0] - top2[..., 1]


def _states(cache):
    """Copies of every SSM-state leaf (``h``) of a cache: none for
    attention models."""
    return [c["h"].clone() for seg in cache.get("segments", []) for c in seg
            if "h" in c]


def _check_states(name, got, want, tol):
    """Each layer stack's max |got - want| over its largest |want| within
    ``tol``; returns the largest such ratio."""
    worst = 0.0
    for g, w in zip(got, want):
        worst = max(worst, float((g - w).abs().max())
                    / max(float(w.abs().max()), 1e-30))
    if worst > tol:
        raise AssertionError(f"{name}: SSM state differs from the plain run "
                             f"by {worst} of its scale (tolerance {tol})")
    return worst


def prefill_decode(model, params, prompts, cache_len, expect, prefill_tol,
                   decode_tol, state_tol=None, frames=None):
    """The serving path: prefill + DECODE_STEPS greedy decode steps with the
    kernels (counts reset just before, read just after), then the same
    prefill and the same decode inputs with the plain versions. ``expect``
    maps each kernel to its launches (per prefill, per decode step); SSM
    states, where the model has them, are held to ``state_tol``. An
    encoder-decoder takes ``frames`` beside the prompts; its prefill
    returns no cache (as the reference's), so decode starts from
    ``init_cache(batch, cache_len)``."""
    dev = prompts.device
    batch, prompt_len = prompts.shape
    inputs = {"tokens": prompts}
    if frames is not None:
        inputs["frames"] = frames

    def start(cache):
        return model.init_cache(batch, cache_len) if cache is None else cache
    # warm-up at the timed shape: the first call of a shape pays one-time
    # costs (the B5 key-split plan, scratch first taken from the driver,
    # library heuristics) that the timed prefill should not
    model.prefill(params, inputs, max_len=cache_len)
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    lg0, cache = model.prefill(params, inputs, max_len=cache_len)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    after_prefill = _build.launch_counts()
    cache = start(cache)
    states = {"prefill": _states(cache)}
    toks, lgs, step_ms = [lg0.argmax(-1)], [], []
    for _ in range(DECODE_STEPS):
        t0 = time.perf_counter()
        lg, cache = model.decode_step(params, cache, toks[-1])
        toks.append(lg.argmax(-1))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        lgs.append(lg)
    launches = _build.launch_counts()
    states["decode"] = _states(cache)
    decode_launches = {k: launches[k] - after_prefill[k] for k in launches}
    profiles = {
        "prefill": _profile(lambda: model.prefill(
            params, inputs, max_len=cache_len)),
        "decode_step": _profile(lambda: model.decode_step(
            params, cache, toks[-1])),
    }

    t0 = time.perf_counter()
    plg0, pcache = model.prefill(params, inputs, max_len=cache_len,
                                 impl="torch")
    torch.cuda.synchronize()
    plain_prefill_ms = (time.perf_counter() - t0) * 1e3
    pcache = start(pcache)
    p_err, p_checked = _check_logits("prefill", lg0, plg0, prefill_tol,
                                     _margin(lg0), toks[0])
    plain_states = {"prefill": _states(pcache)}
    d_err, d_checked, plain_step_ms = 0.0, 0, []
    for i in range(DECODE_STEPS):          # the kernel run's tokens as input
        t0 = time.perf_counter()
        plg, pcache = model.decode_step(params, pcache, toks[i], impl="torch")
        torch.cuda.synchronize()
        plain_step_ms.append((time.perf_counter() - t0) * 1e3)
        err, n = _check_logits(f"decode step {i}", lgs[i], plg, decode_tol,
                               _margin(lgs[i]), toks[i + 1])
        d_err, d_checked = max(d_err, err), d_checked + n
    plain_states["decode"] = _states(pcache)
    state_err = {k: _check_states(f"{k} state", states[k], plain_states[k],
                                  state_tol)
                 for k in states if states[k]}
    if not all(bool(torch.isfinite(x).all()) for x in [lg0] + lgs):
        raise AssertionError("non-finite logits on the serving path")
    for k, (per_prefill, per_step) in expect.items():
        if after_prefill[k] != per_prefill:
            raise AssertionError(f"prefill launched {k} {after_prefill[k]} "
                                 f"times, not {per_prefill}")
        if decode_launches[k] != per_step * DECODE_STEPS:
            raise AssertionError(f"{DECODE_STEPS} decode steps launched {k} "
                                 f"{decode_launches[k]} times, not "
                                 f"{per_step * DECODE_STEPS}")
    report = {
        "arch": model.cfg.name, "batch": batch, "prompt_len": prompt_len,
        "cache_len": cache_len, "decode_steps": DECODE_STEPS,
        "prefill_ms": prefill_ms, "plain_prefill_ms": plain_prefill_ms,
        "decode_ms_per_step": statistics.median(step_ms[1:]),
        "decode_ms_first_step": step_ms[0],
        "plain_decode_ms_per_step": statistics.median(plain_step_ms[1:]),
        "launches": launches,
        "launches_per_prefill": {k: after_prefill[k] for k in expect},
        "launches_per_decode_step": {k: decode_launches[k] / DECODE_STEPS
                                     for k in expect},
        "prefill_logit_max_abs_err": p_err,
        "decode_logit_max_abs_err": d_err,
        "state_max_rel_err": state_err,
        "greedy_tokens_checked": p_checked + d_checked,
        "greedy_tokens_total": batch * (DECODE_STEPS + 1),
        "profiles": profiles,
    }
    return report, cache


def every_position(model, params, prompts, tol):
    """``model.forward`` over the prompts with the kernels and with the
    plain versions, the logits held to ``tol`` at every position. Prefill
    returns only the last position's logits, and at the reference's init
    decays a chunk's last rows and final state forget what was carried
    into it; the first rows of every chunk after the first read that state
    through exp(cl_t), so a fault in the carry shows here. Launches made
    here compare a kernel with its plain version and are not counted."""
    cfg = model.cfg
    got = lm.logits(cfg, params, model.forward(params, {"tokens": prompts}))
    want = lm.logits(cfg, params, model.forward(params, {"tokens": prompts},
                                                impl="torch"))
    torch.cuda.synchronize()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError("non-finite logits over the prompts")
    err, _ = _check_logits("forward, every position", got, want, tol)
    del got, want
    return err


def print_serving(tag, pd):
    """The serving path's lines: prefill ms, decode ms per step, launch
    counts and the profiles of one prefill and one decode step."""
    print(f"{tag}prefill ms: {pd['prefill_ms']:.3f} (B={pd['batch']} x "
          f"{pd['prompt_len']} tokens; plain versions "
          f"{pd['plain_prefill_ms']:.3f})")
    print(f"{tag}decode ms per step: {pd['decode_ms_per_step']:.3f} "
          f"(B={pd['batch']}, median of steps 2-{DECODE_STEPS}; plain "
          f"versions {pd['plain_decode_ms_per_step']:.3f})")
    print(f"{tag}serving launches: per prefill "
          + json.dumps(pd["launches_per_prefill"]) + ", per decode step "
          + json.dumps(pd["launches_per_decode_step"]))
    for k, prof in pd["profiles"].items():
        busy = prof["device_ms"] / (pd["prefill_ms"] if k == "prefill"
                                    else pd["decode_ms_per_step"])
        print(f"{tag}{k} profile: device {prof['device_ms']:.3f} ms over "
              f"{prof['device_launches']} launches; busy share of the "
              f"unprofiled wall time {busy:.3f}; top "
              + json.dumps(prof["top_kernels"]))
    print(f"{tag}serving path " + json.dumps(pd))


def _requests_agree(got, want, tol):
    """Same requests in the same order; each request's tokens equal up to a
    first difference, where the kernel run's margin must be under 2 tol.
    Returns the number of tokens compared equal."""
    if [r.rid for r in got] != [r.rid for r in want]:
        raise AssertionError("engine runs completed different requests")
    same = 0
    for g, w in zip(got, want):
        for i, (a, b) in enumerate(zip(g.out, w.out)):
            if a != b:
                if g.margins[i] >= 2 * tol:
                    raise AssertionError(
                        f"request {g.rid} token {i}: {a} != {b} at margin "
                        f"{g.margins[i]}")
                break
            same += 1
    return same


def engine_run(arch, tol, launched, not_launched):
    """``repro_torch.launch.serve`` at its reference defaults with the
    kernels (counts reset just before, read just after), then the same
    requests through the same plan with the plain versions. Each kernel of
    ``launched`` must have run, none of ``not_launched``."""
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    rep = serve.run(["--arch", arch])
    launches = _build.launch_counts()
    for k in launched:
        if launches[k] < 1:
            raise AssertionError(f"the {arch} engine never launched {k}")
    for k in not_launched:
        if launches[k] != 0:
            raise AssertionError(f"the {arch} engine launched {k} "
                                 f"{launches[k]} times, not 0")
    if len(rep.done) != rep.requests:
        raise AssertionError(f"{len(rep.done)}/{rep.requests} requests done")
    plain = ServingEngine(rep.model, rep.params,
                          num_pipelines=rep.plan.num_pipelines,
                          slots_per_pipeline=8, max_len=64, impl="torch")
    for req in serve.make_requests(rep.model.cfg, rep.requests, 16):
        plain.submit(req)
    t0 = time.perf_counter()
    done = plain.run(max_steps=64 - 8)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    same = _requests_agree(rep.done, done, tol)
    return rep.engine, {
        "pipelines": rep.plan.num_pipelines, "R": rep.plan.R,
        "latencies_s": rep.plan.latencies, "requests": rep.requests,
        "tokens": rep.tokens, "seconds": rep.seconds,
        "tokens_per_s": rep.tokens_per_s,
        "plain_tokens_per_s": sum(len(r.out) for r in done) / plain_s,
        "tokens_equal_to_plain": same, "launches": launches,
    }


def reduced_serving(arch):
    """``arch``'s ``reduced()`` config (head dim 16) on the card against the
    same parameters on the CPU. Prefill of REDUCED_BATCH prompts of
    REDUCED_PROMPT tokens (a vlm's behind its stub patches; B5 on every
    attention layer, B7 on every mamba layer) and REDUCED_STEPS greedy decode steps (B6 on the global
    attention layers) over an f32 cache, counts reset just before and read
    just after; then ``launch.serve --reduced`` on the card (B6 in the
    engine) against a CPU engine with the card run's plan, parameters and
    requests. Logits are held to PREFILL_TOL (both f32, sums in other
    orders, through 4 to 8 layers; MoE routes agree at f32)."""
    cfg = get_arch(arch).reduced().replace(remat=False)
    card, cpu = build(cfg, "cuda"), build(cfg, "cpu")
    params = cpu.init(torch.Generator().manual_seed(0), torch.float32)
    card_params = cpu.init(torch.Generator().manual_seed(0),
                           torch.float32).to("cuda")
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(
        2, cfg.vocab, size=(REDUCED_BATCH, REDUCED_PROMPT)))
    inputs = {"tokens": toks}
    if cfg.family == "vlm":          # stub patches ahead of the text
        inputs["patches"] = torch.from_numpy(rng.standard_normal(
            (REDUCED_BATCH, cfg.frontend_tokens, cfg.d_model)).astype(
                np.float32))
    max_len = cfg.frontend_tokens + REDUCED_PROMPT + REDUCED_STEPS
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    lg, c = card.prefill(card_params,
                         {k: t.cuda() for k, t in inputs.items()},
                         max_len=max_len, cache_dtype=torch.float32)
    per_prefill = _build.launch_counts()
    lgs, nxt = [lg], [lg.argmax(-1)]
    for _ in range(REDUCED_STEPS):
        lg, c = card.decode_step(card_params, c, nxt[-1])
        lgs.append(lg)
        nxt.append(lg.argmax(-1))
    torch.cuda.synchronize()
    launches = _build.launch_counts()
    plg, pc = cpu.prefill(params, inputs, max_len=max_len,
                          cache_dtype=torch.float32)
    err, _ = _check_logits("reduced prefill", lgs[0].cpu(), plg, PREFILL_TOL)
    for i in range(REDUCED_STEPS):
        plg, pc = cpu.decode_step(params, pc, nxt[i].cpu())
        e, _ = _check_logits(f"reduced decode step {i}", lgs[i + 1].cpu(),
                             plg, PREFILL_TOL)
        err = max(err, e)
    mixers = [layer.spec.mixer for *_, layer in params.all_layers()]
    n_global = mixers.count("attn")
    expect = {"flash_attention": (n_global + mixers.count("attn_local"), 0),
              "decode_attention": (0, REDUCED_STEPS * n_global),
              "ssd_scan": (mixers.count("mamba"), 0)}
    for k, (per, dec) in expect.items():
        got = (per_prefill[k], launches[k] - per_prefill[k])
        if got != (per, dec):
            raise AssertionError(f"reduced {arch}: {k} launched {got[0]} "
                                 f"times in the prefill and {got[1]} in "
                                 f"{REDUCED_STEPS} decode steps, not "
                                 f"{per} and {dec}")
    decode = launches["decode_attention"] - per_prefill["decode_attention"]

    torch.cuda.synchronize()
    _build.reset_launch_counts()
    rep = serve.run(["--arch", arch, "--reduced"])
    eng_launches = _build.launch_counts()
    if eng_launches["decode_attention"] < 1:
        raise AssertionError("the reduced engine never launched "
                             "decode_attention")
    if len(rep.done) != rep.requests:
        raise AssertionError(f"reduced engine: {len(rep.done)}/"
                             f"{rep.requests} requests done")
    on_cpu = ServingEngine(cpu, rep.params.to("cpu"),
                           num_pipelines=rep.plan.num_pipelines,
                           slots_per_pipeline=8, max_len=64)
    for req in serve.make_requests(cfg, rep.requests, 16):
        on_cpu.submit(req)
    done = on_cpu.run(max_steps=64 - 8)
    same = _requests_agree(rep.done, done, PREFILL_TOL)
    margin_err = 0.0            # over each request's tokens up to a change
    for g, w in zip(rep.done, done):
        for a, b, ma, mb in zip(g.out, w.out, g.margins, w.margins):
            margin_err = max(margin_err, abs(ma - mb))
            if a != b:
                break
    if margin_err > 2 * PREFILL_TOL:
        raise AssertionError(f"reduced engine: top-2 margins differ from "
                             f"the CPU run by {margin_err}")
    return {
        "arch": arch, "d_head": cfg.head_dim, "layers": cfg.n_layers,
        "batch": REDUCED_BATCH, "prompt_len": REDUCED_PROMPT,
        "decode_steps": REDUCED_STEPS,
        "logit_max_abs_err_vs_cpu": err,
        "family": cfg.family,
        "launches_per_prefill": {k: per_prefill[k] for k in expect},
        "decode_attention_per_step": decode / REDUCED_STEPS,
        "engine": {"pipelines": rep.plan.num_pipelines,
                   "requests": rep.requests, "tokens": rep.tokens,
                   "tokens_equal_to_cpu": same,
                   "margin_max_abs_err_vs_cpu": margin_err,
                   "launches": eng_launches},
    }, launches, eng_launches


def reduced_attention_rows(arch, launches):
    """B5 and B6 at the reduced config's head dim 16, at the shapes the
    reduced path gave them (B5 windowed and global over the prompts, B6
    over the prefilled f32 cache), against their plain versions, timed
    beside their bounds: rows to attach to B5's and B6's as variants, with
    the reduced path's ``launches``."""
    cfg = get_arch(arch).reduced()
    dev = torch.device("cuda")
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)
    g = torch.Generator(device=dev).manual_seed(2)
    B, S, Hq, Hkv, D = (REDUCED_BATCH, REDUCED_PROMPT, cfg.n_heads,
                        cfg.n_kv_heads, cfg.head_dim)
    Sd = REDUCED_PROMPT + REDUCED_STEPS
    q = torch.randn((B, S, Hq, D), generator=g, device=dev)
    k = torch.randn((B, S, Hkv, D), generator=g, device=dev)
    v = torch.randn((B, S, Hkv, D), generator=g, device=dev)
    dq = torch.randn((B, Hq, D), generator=g, device=dev)
    ck = torch.randn((B, Sd, Hkv, D), generator=g, device=dev)
    cv = torch.randn((B, Sd, Hkv, D), generator=g, device=dev)
    kv_len = torch.full((B,), Sd - 1, dtype=torch.int32, device=dev)
    el = lambda t: t.numel() * t.element_size()
    specs = [("flash_attention", f"reduced-{label}", dict(
        run=lambda w=w: fa.flash_attention_cuda(q, k, v, window=w),
        plain=lambda w=w: fa.flash_attention_torch(q, k, v, window=w),
        shape=f"B={B} Sq=Sk={S} Hq={Hq} Hkv={Hkv} D={D} f32 window={w}",
        nbytes=el(q) * 2 + el(k) + el(v),
        ops=fa.work(q.shape, k.shape, True, w) * 4 * D))
        for w, label in ((cfg.window, "local"), (None, "global"))]
    specs.append(("decode_attention", "reduced", dict(
        run=lambda: da.decode_attention_cuda(dq, ck, cv, kv_len),
        plain=lambda: da.decode_attention_torch(dq, ck, cv, kv_len),
        shape=f"B={B} S={Sd} kv_len={Sd - 1} Hq={Hq} Hkv={Hkv} D={D} f32",
        nbytes=el(dq) * 2 + el(kv_len) + int(kv_len.sum()) * Hkv * D * 2 * 4,
        ops=da.work(kv_len, Sd, Hq) * 4 * D)))
    out = []
    for name, label, s in specs:
        got, want = s["run"](), s["plain"]()
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not torch.allclose(got, want, **ATTN_TOL):
            raise AssertionError(f"{name} ({label}): kernel differs from its "
                                 f"plain version by {err}")
        peak = hw.peak_flops(torch.float32)
        bound_s, bound_by = hw.bound_seconds(s["nbytes"], s["ops"], peak)
        out.append((name, label, {
            "name": name, "variant": label,
            "launches": launches[name],
            "shape": s["shape"], "max_abs_err": err,
            "ms": _time_ms(s["run"], KERNEL_REPS, flush),
            "ms_l2_warm": _time_ms(s["run"], KERNEL_REPS, _NoFlush()),
            "plain_ms": _time_ms(s["plain"], PLAIN_REPS, flush),
            "bound_ms": bound_s * 1e3, "bound_by": bound_by,
            "bytes": int(s["nbytes"]), "ops": int(s["ops"]),
            "peak_flops": peak, "library_ms": None,
        }))
    return out


def attention_checks(model, cache, engine, launches_pd, launches_engine):
    """B5 and B6 at the shapes the serving path gave them, against their
    plain versions, timed beside their bounds and SDPA: B6 both over the
    prefilled bf16 cache and over the engine's f32 cache."""
    cfg = model.cfg
    dev = model.device
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)
    g = torch.Generator(device=dev).manual_seed(1)
    B, S, Hq, Hkv, D = (SERVE_BATCH, PROMPT_LEN, cfg.n_heads, cfg.n_kv_heads,
                        cfg.head_dim)
    q = torch.randn((B, S, Hq, D), generator=g, device=dev)
    k = torch.randn((B, S, Hkv, D), generator=g, device=dev)
    v = torch.randn((B, S, Hkv, D), generator=g, device=dev)
    band = torch.arange(S, device=dev)
    local = ((band[None, :] <= band[:, None])
             & (band[None, :] > band[:, None] - cfg.window))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    kt, vt = (x.expand(B, Hq, S, D) for x in (kt, vt))
    sdpa = torch.nn.functional.scaled_dot_product_attention

    el = lambda t: t.numel() * t.element_size()
    specs = []
    for window, label in ((cfg.window, "local"), (None, "global")):
        specs.append(dict(
            name="flash_attention", label=label,
            run=lambda w=window: fa.flash_attention_cuda(q, k, v, window=w),
            plain=lambda w=window: fa.flash_attention_torch(q, k, v,
                                                            window=w),
            lib=(lambda: sdpa(qt, kt, vt, attn_mask=local)) if window
            else (lambda: sdpa(qt, kt, vt, is_causal=True)),
            lib_out=lambda o: o.transpose(1, 2),
            shape=f"B={B} Sq=Sk={S} Hq={Hq} Hkv={Hkv} D={D} f32 "
                  f"window={window}",
            nbytes=el(q) * 2 + el(k) + el(v),
            ops=fa.work(q.shape, k.shape, True, window) * 4 * D,
            peak=hw.peak_flops(q.dtype, k.dtype)))
    # decode: a query against a global layer's cache, with kv_len as the
    # path left it: the prefilled bf16 cache (PROMPT_LEN + DECODE_STEPS
    # valid rows) and the f32 cache of the engine instance that ran most
    # steps (its shared position)
    bpos = [x.mixer for x in lm.build_schedule(cfg)[0].body].index("attn")
    eng_cache = max((p.cache for p in engine.pipelines),
                    key=lambda c: c["pos"])
    for label, c, n_valid in (
            ("global", cache, PROMPT_LEN + DECODE_STEPS),
            ("engine", eng_cache, eng_cache["pos"])):
        ck = c["segments"][0][bpos]["k"][0]
        cv = c["segments"][0][bpos]["v"][0]
        Bd, Sd = ck.shape[:2]
        dq = torch.randn((Bd, Hq, D), generator=g, device=dev)
        kv_len = torch.full((Bd,), n_valid, dtype=torch.int32, device=dev)
        ckf, cvf = (x.float().transpose(1, 2).expand(Bd, Hq, Sd, D)
                    for x in (ck, cv))
        dmask = (torch.arange(Sd, device=dev)[None, :]
                 < kv_len[:, None])[:, None, None, :]
        valid_rows = int(kv_len.clamp(0, Sd).sum())
        specs.append(dict(
            name="decode_attention", label=label,
            run=lambda a=(dq, ck, cv, kv_len): da.decode_attention_cuda(*a),
            plain=lambda a=(dq, ck, cv, kv_len): da.decode_attention_torch(
                *a),
            lib=lambda a=(dq[:, :, None], ckf, cvf), m=dmask: sdpa(
                *a, attn_mask=m),
            lib_out=lambda o: o[:, :, 0],
            shape=f"B={Bd} S={Sd} kv_len={n_valid} Hq={Hq} Hkv={Hkv} D={D} "
                  f"q f32, cache {str(ck.dtype).split('.')[-1]}",
            nbytes=el(dq) * 2 + el(kv_len)
            + valid_rows * Hkv * D * 2 * ck.element_size(),
            ops=da.work(kv_len, Sd, Hq) * 4 * D,
            peak=hw.peak_flops(dq.dtype, ck.dtype)))

    # the CUDA kernels SDPA ran for B5's two shapes, read once
    sdpa_kernels = _device_kernels(lambda: [
        s["lib"]() for s in specs if s["name"] == "flash_attention"])
    rows = {}
    for s in specs:
        got, want = s["run"](), s["plain"]()
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not torch.allclose(got, want, **ATTN_TOL):
            raise AssertionError(f"{s['name']} ({s['label']}): kernel "
                                 f"differs from its plain version by {err}")
        lib_err = float((s["lib_out"](s["lib"]()) - want).abs().max())
        bound_s, bound_by = hw.bound_seconds(s["nbytes"], s["ops"], s["peak"])
        name = s["name"]
        by_path = ({"prefill": launches_pd[name]} if name == "flash_attention"
                   else {"prefill_decode": launches_pd[name],
                         "engine": launches_engine[name]})
        launches = (launches_engine if s["label"] == "engine"
                    else launches_pd)[name]
        row = {
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches,
            "launches_by_path": by_path, "variant": s["label"],
            "shape": s["shape"], "max_abs_err": err,
            "ms": _time_ms(s["run"], KERNEL_REPS, flush),
            "plain_ms": _time_ms(s["plain"], PLAIN_REPS, flush),
            "bound_ms": bound_s * 1e3, "bound_by": bound_by,
            "bytes": int(s["nbytes"]), "ops": int(s["ops"]),
            "peak_flops": s["peak"],
            "library_ms": _time_ms(s["lib"], KERNEL_REPS, flush),
            "library_call": "torch.nn.functional.scaled_dot_product_attention",
            "library_max_abs_err": lib_err,
        }
        if name == "flash_attention":   # the yardstick's route, on record
            row["library_kernels"] = sdpa_kernels
        else:   # the same launches with the cache left in L2 by the last
            row["ms_l2_warm"] = _time_ms(s["run"], KERNEL_REPS, _NoFlush())
        if name in rows:        # another shape of the same kernel's launches
            rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], err)
            rows[name].setdefault("variants", {})[s["label"]] = row
        else:
            rows[name] = row
    return list(rows.values())


def ssd_checks(model, params, prompts, launches_pd, launches_engine):
    """B7 at the shape the prefill gave it, on the real inputs of the first
    and the last layer, against its plain version, timed beside its
    bound. At the reference's init a 128-step chunk sums -log a to ~105,
    so exp(cl) underflows and no chunk's output or final state depends on
    the state carried into it; a third variant takes layer 0's inputs with
    the decays raised to the power 1/100 (a trained Mamba-2 head's slow
    decay), where the carry across chunks counts."""
    cfg = model.cfg
    dev = model.device
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)
    _, norm_apply = lm.make_norm(cfg)
    layers = [layer for *_, layer in params.all_layers()]
    x = lm.embed(params.embed, prompts)
    inputs = {}
    with torch.no_grad():
        for i, layer in enumerate(layers):
            if i in (0, len(layers) - 1):
                h = norm_apply(layer.norm1, x)
                inputs[f"layer{i}"] = ssm.ssd_inputs(layer.mamba, h, cfg)[3:]
            x, _ = lm._apply_layer(cfg, layer, x, None, None)
    xh, a, b, c = inputs["layer0"]
    inputs["layer0-slow-decay"] = (xh, a ** 0.01, b, c)
    chunk = 128
    row = None
    for label, (xh, a, b, c) in inputs.items():
        run = lambda a_=(xh, a, b, c): ss.ssd_scan_cuda(*a_, chunk)
        plain = lambda a_=(xh, a, b, c): ss.ssd_scan_torch(*a_, chunk)
        (y, h), (py, ph) = run(), plain()
        torch.cuda.synchronize()
        err = max(float((y - py).abs().max()), float((h - ph).abs().max()))
        if not (torch.allclose(y, py, **SSD_TOL)
                and torch.allclose(h, ph, **SSD_TOL)):
            raise AssertionError(f"ssd_scan ({label}): kernel differs from "
                                 f"its plain version by {err}")
        if not bool(torch.isfinite(y).all()):
            raise AssertionError(f"ssd_scan ({label}): non-finite output")
        B, S, H, P = xh.shape
        N = b.shape[-1]
        flops, nbytes = ss.work(xh, b, c)
        peak = hw.peak_flops(xh.dtype, b.dtype, c.dtype)
        bound_s, bound_by = hw.bound_seconds(nbytes, flops, peak)
        r = {
            "name": "ssd_scan", "route": "cuda", "source": SOURCES["ssd_scan"],
            "replaces": REPLACES["ssd_scan"],
            "launches": launches_pd["ssd_scan"],
            "launches_by_path": {"prefill_decode": launches_pd["ssd_scan"],
                                 "engine": launches_engine["ssd_scan"]},
            "variant": label,
            "shape": f"B={B} S={S} H={H} P={P} N={N} chunk={chunk} f32, "
                     f"c broadcast over H (stride {c.stride(2)})",
            "max_abs_err": err,
            "plain_max_abs_y": float(py.abs().max()),
            "plain_max_abs_h": float(ph.abs().max()),
            "ms": _time_ms(run, KERNEL_REPS, flush),
            "plain_ms": _time_ms(plain, PLAIN_REPS, flush),
            "bound_ms": bound_s * 1e3, "bound_by": bound_by,
            "bytes": int(nbytes), "ops": int(flops), "peak_flops": peak,
            "library_ms": None,
        }
        if row is None:
            row = r
        else:
            row["max_abs_err"] = max(row["max_abs_err"], err)
            row.setdefault("variants", {})[label] = r
    return [row]


# -- training -------------------------------------------------------------------

def _snapshot(params, opt):
    """Host copies of the parameters and the AdamW state."""
    host = lambda t: t.detach().to("cpu", copy=True)
    return ({k: host(p) for k, p in params.named_parameters()},
            {k: host(v) for k, v in opt.mu.items()},
            {k: host(v) for k, v in opt.nu.items()}, host(opt.count))


def _restore(params, opt, snap):
    pm, mu, nu, count = snap
    with torch.no_grad():
        for k, p in params.named_parameters():
            p.copy_(pm[k])
        for k in mu:
            opt.mu[k].copy_(mu[k])
            opt.nu[k].copy_(nu[k])
        opt.count.copy_(count)


def _train_setup(model, impls):
    """The seeded f32 parameters (requiring gradients), and for each of
    ``impls`` a ``make_train_step`` step at batch TRAIN_BATCH x TRAIN_SEQ
    in 2 microbatches; then the AdamW state."""
    cfg = model.cfg
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        torch.float32).requires_grad_(True)
    shape = ShapeConfig("train", TRAIN_SEQ, TRAIN_BATCH, "train")
    steps = []
    for impl in impls:
        step_fn, opt_init = make_train_step(model, shape, base_lr=TRAIN_LR,
                                            warmup=TRAIN_WARMUP,
                                            total_steps=TRAIN_STEPS,
                                            impl=impl)
        if step_fn.accum != 2:
            raise AssertionError(f"{cfg.name}: {step_fn.accum} "
                                 f"microbatches, want 2")
        steps.append(step_fn)
    return params, steps, opt_init(params)


def _timed_step(step_fn, params, opt, toks, s, out):
    """Step ``s`` (counts reset before it, read after), recorded in ``out``;
    after step 1 a host copy of the parameters."""
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    params, opt, loss, gn = step_fn(params, opt, {"tokens": toks}, s)
    torch.cuda.synchronize()
    out["ms"].append((time.perf_counter() - t0) * 1e3)
    out["launches"].append(_build.launch_counts())
    out["loss"].append(float(loss))
    out["grad_norm"].append(float(gn))
    if s == 1:
        out["params_step1"] = {k: p.detach().to("cpu", copy=True)
                               for k, p in params.named_parameters()}
    return params, opt


def _new_run():
    return {"loss": [], "grad_norm": [], "ms": [], "launches": []}


def _train_run(model, batches, impl, profile_last=False):
    """``make_train_step`` over ``batches`` (steps numbered 1, 2, ...) from
    the seeded parameters: per-step loss, grad norm, ms and launches, and a
    host copy of the parameters after step 1. With ``profile_last`` the last
    batch is one more step under ``torch.profiler`` (not timed, not
    compared), for the device's busy share."""
    params, (step_fn,), opt = _train_setup(model, (impl,))
    out = _new_run()
    timed = batches[:-1] if profile_last else batches
    for s, toks in enumerate(timed, 1):
        params, opt = _timed_step(step_fn, params, opt, toks, s, out)
    if profile_last:
        n = len(batches)
        out["profile"] = _profile(lambda: step_fn(
            params, opt, {"tokens": batches[-1]}, n))
    out["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    del params, opt
    return out


def _train_lockstep(model, batches, rk, rp):
    """The kernel and plain runs in lock step on one set of parameters:
    before each step its state goes to the host, the plain step runs from
    it (routes into ``rp``), the state is loaded back and the kernel step
    runs (routes into ``rk``), so each plain step starts from the state its
    kernel step starts from, with one host copy of the state at a time.
    The last batch is one more kernel step under ``torch.profiler``.
    Returns (kernel run, plain run) as ``_train_run`` does."""
    params, (kernel_fn, plain_fn), opt = _train_setup(model, (None, "torch"))
    k, p = _new_run(), _new_run()
    for s, toks in enumerate(batches[:-1], 1):
        snap = _snapshot(params, opt)
        with rp:
            params, opt = _timed_step(plain_fn, params, opt, toks, s, p)
        _restore(params, opt, snap)
        del snap
        with rk:
            params, opt = _timed_step(kernel_fn, params, opt, toks, s, k)
    n = len(batches)
    k["profile"] = _profile(lambda: kernel_fn(params, opt,
                                              {"tokens": batches[-1]}, n))
    k["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    del params, opt
    return k, p


def _param_diff(a, b, lr1):
    """Largest |a - b| over two parameter dicts (host copies, compared on
    the card a tensor at a time), and the share of entries apart by more
    than 1e-3 lr1."""
    worst, off, total = 0.0, 0, 0
    for name, x in a.items():
        d = (x.cuda() - b[name].cuda()).abs()
        worst = max(worst, float(d.max()))
        off += int((d > 1e-3 * lr1).sum())
        total += d.numel()
    return worst, off / total


def _with_calibration(calibrate, fn):
    """``fn()`` with ``ops.<name>`` called with ``kw=value`` (``calibrate``
    = (name, kw, value)): the plain version's sums in another order."""
    name, kw, value = calibrate
    real = getattr(ops, name)
    setattr(ops, name, lambda *a, **k: real(*a, **{**k, kw: value}))
    try:
        return fn()
    finally:
        setattr(ops, name, real)


def _drop_expert_grad(fn):
    """``fn()`` with the gradient of expert 0's gate, up and down weights
    dropped in every MoE layer; the forward is unchanged (v * 1 + 0 and
    v * 0 + v are v)."""
    real = moe._expert_matmuls

    def dropped(p, xe):
        keep = torch.ones((p["gate"].shape[0], 1, 1), dtype=p["gate"].dtype,
                          device=xe.device)
        keep[0] = 0
        return real({k: p[k] * keep + (p[k] * (1 - keep)).detach()
                     for k in ("gate", "up", "down")}, xe)
    moe._expert_matmuls = dropped
    try:
        return fn()
    finally:
        moe._expert_matmuls = real


def _train_route_gate(rk, rp, cfg, n_moe):
    """The route flips between the kernel run's recorded routes ``rk`` and
    the plain run's ``rp`` (the same calls: steps x microbatches x MoE
    layers), counted per MoE layer. A token's chosen experts (the top-k of
    its router probabilities, recomputed from the recorded inputs and
    router as ``moe.route`` computes them) may differ only at a near tie:
    if they differ, some expert a chosen by the kernel run and b chosen by
    the plain run have lp_b - lp_a <= (lp_b - lk_b) + (lk_a - lp_a), so the
    plain run's gap between its k-th and (k+1)-th logits is at most twice
    the two runs' largest logit difference d (plus ROUTE_SLACK of the
    largest logit for the recomputation). At most MOE_FLIP_SHARE of a
    call's tokens may flip. Tokens whose chosen experts agree but whose
    kept experts do not were pushed past (or under) a capacity by a flip
    before them; they are counted apart."""
    calls = len(rp.calls)
    if len(rk.calls) < calls or calls % n_moe:
        raise AssertionError(f"{len(rk.calls)} routed calls with the "
                             f"kernels, {calls} plain")
    per_layer = [{"flips": 0, "capacity_only": 0, "near_ties": 0,
                  "tokens": 0} for _ in range(n_moe)]
    worst_share = 0.0
    for j, (ck, cp) in enumerate(zip(rk.calls, rp.calls)):
        lk = (ck["x"] @ ck["router"]).float()
        lp = (cp["x"] @ cp["router"]).float()
        chose = (_top_k_set(torch.softmax(lk, -1), cfg.top_k)
                 == _top_k_set(torch.softmax(lp, -1), cfg.top_k)).all(-1)
        top = torch.sort(lp, dim=-1, descending=True).values
        gap = top[:, cfg.top_k - 1] - top[:, cfg.top_k]
        d = (lk - lp).abs().amax(-1)
        near = gap <= 2 * d + ROUTE_SLACK * lp.abs().amax(-1)
        if bool((~chose & ~near).any()):
            t = int((~chose & ~near).nonzero()[0])
            raise AssertionError(
                f"train routes, call {j}: token {t} changed experts at a "
                f"logit gap {float(gap[t])} over twice the runs' logit "
                f"difference {float(d[t])}")
        same = _route_flips(types.SimpleNamespace(calls=[ck]),
                            types.SimpleNamespace(calls=[cp]))[0]
        flips = int((~chose).sum())
        T = chose.numel()
        layer = per_layer[j % n_moe]
        layer["flips"] += flips
        layer["capacity_only"] += int((chose & same).sum())
        layer["near_ties"] += int(near.sum())
        layer["tokens"] += T
        worst_share = max(worst_share, flips / T)
        if flips > MOE_FLIP_SHARE * T:
            raise AssertionError(f"train routes, call {j}: {flips} of {T} "
                                 f"tokens changed experts")
    return {"per_moe_layer": per_layer, "calls": calls,
            "max_call_flip_share": worst_share}


def training_phase(arch, kernels, resync=False, calibrate=None, layers=None,
                   fault=False):
    """``arch`` at full width: ``TRAIN_STEPS`` steps with the kernels (the
    main path: counts reset before each step, read after), then the same
    steps with the plain versions from the same parameters and data. The
    config's ``microbatch`` (the accumulation count) is capped at 2: 2
    microbatches of 4; ``layers`` cuts its depth. Each of ``kernels`` must
    launch once per layer of each microbatch, and nothing else may launch.

    With ``resync`` each plain step starts from the state the kernel step
    of the same number started from (``_train_lockstep``), so every step's
    loss and grad norm are gated from one state; a third run, the plain
    versions left to run free, is reported beside them, not gated
    (mamba2-370m and moonshot: the two free runs part as AdamW parts them,
    see TRAIN_RESYNC and MOE_TRAIN_LAYERS).

    With ``calibrate`` = (op, keyword, value) one more plain step 1 runs
    with ``ops.<op>`` called with that keyword (the same function, its f32
    sums in another order), and the kernel run's parameters after step 1
    may part from the plain run's in at most TRAIN_NOISE_FACTOR times the
    share that plain run parts from it (TRAIN_PARAM_SHARE at least).

    A model with MoE layers has its routes recorded in both runs and held
    by ``_train_route_gate``; its parameter gate compares the kernel run's
    step 1 with a plain step 1 that takes the kernel run's routes
    (``_ReplayRoutes``): a route flip at a near tie moves its token's whole
    output, and through attention the rest of its sequence, and AdamW's
    first update parts every entry whose gradient that outweighs (the
    plain run that routes freely is reported beside it). With ``fault``
    the kernel run's step 1 runs again with its routes and one expert's
    gradient dropped (``_drop_expert_grad``), and the phase fails unless
    the parameter gate rejects it."""
    cfg = get_arch(arch)
    cfg = cfg.replace(microbatch=min(cfg.microbatch, 2))
    if layers:
        cfg = cfg.replace(n_layers=layers)
    model = build(cfg, "cuda")
    ds = SyntheticLMDataset(vocab=cfg.vocab, seq_len=TRAIN_SEQ + 1)
    batches = [torch.from_numpy(ds.batch(i, TRAIN_BATCH)["tokens"]
                                [:, :TRAIN_SEQ]).long().cuda()
               for i in range(1, TRAIN_STEPS + 2)]
    n_params = model.param_counts()[0]
    n_moe = sum(seg.count for seg in lm.build_schedule(cfg)
                for spec in seg.body if spec.ffn == "moe")
    torch.cuda.reset_peak_memory_stats()
    rk, rp = _Routes(keep_inputs=True), _Routes(keep_inputs=True)
    if resync:
        k, p = _train_lockstep(model, batches, rk, rp)
    else:
        with rk:
            k = _train_run(model, batches, None, profile_last=True)
        torch.cuda.empty_cache()
        with rp:
            p = _train_run(model, batches[:TRAIN_STEPS], "torch")
    routes = _train_route_gate(rk, rp, cfg, n_moe) if n_moe else None
    step1_routes = rk.calls[:2 * n_moe]
    del rp
    free = None
    if resync:
        torch.cuda.empty_cache()
        with _Routes(keep_inputs=True) as rf:
            free = _train_run(model, batches[:TRAIN_STEPS], "torch")
        del free["params_step1"]
        if n_moe:
            routes["free_run_flips_per_call"] = [
                int((_top_k_set(torch.softmax(ck["x"] @ ck["router"], -1),
                                cfg.top_k)
                     != _top_k_set(torch.softmax(cf["x"] @ cf["router"], -1),
                                   cfg.top_k)).any(-1).sum())
                for ck, cf in zip(rk.calls, rf.calls)]
        del rf
    del rk
    lr1 = float(make_schedule(cfg.schedule, TRAIN_LR, TRAIN_WARMUP,
                              TRAIN_STEPS)(1))
    share_cap, floor = TRAIN_PARAM_SHARE, None
    if calibrate:
        torch.cuda.empty_cache()
        cal = _with_calibration(calibrate, lambda: _train_run(
            model, batches[:1], "torch"))
        _, floor = _param_diff(cal["params_step1"], p["params_step1"], lr1)
        share_cap = max(TRAIN_PARAM_SHARE, TRAIN_NOISE_FACTOR * floor)
        del cal
    per_step = {name: 2 * cfg.n_layers for name in kernels}
    for s, counts in enumerate(k["launches"], 1):
        for name, n in counts.items():
            if n != per_step.get(name, 0):
                raise AssertionError(f"train step {s}: {n} launches of "
                                     f"{name}, want {per_step.get(name, 0)}")
    for s, counts in enumerate(p["launches"], 1):
        if any(counts.values()):
            raise AssertionError(f"plain train step {s} launched {counts}")
    for key, tol in (("loss", TRAIN_LOSS_TOL), ("grad_norm", TRAIN_GNORM_TOL)):
        for s, (a, b) in enumerate(zip(k[key], p[key]), 1):
            if not (np.isfinite(a) and abs(a - b) <= tol * abs(b)):
                raise AssertionError(f"train step {s}: {key} {a} with the "
                                     f"kernels, {b} plain (rtol {tol})")
    routed_free = None
    ref = p["params_step1"]
    if n_moe:
        # the kernel run's step-1 routes replayed in a plain step 1, so the
        # gate sees attention's arithmetic apart from the route flips,
        # which _train_route_gate holds
        routed_free = _param_diff(k["params_step1"], ref, lr1)
        p.pop("params_step1")
        torch.cuda.empty_cache()
        with _ReplayRoutes(step1_routes):
            ref = _train_run(model, batches[:1], "torch")["params_step1"]
    worst, share = _param_diff(k["params_step1"], ref, lr1)
    gate = lambda w, sh: w <= 2 * lr1 * 1.001 and sh <= share_cap
    if not gate(worst, share):
        raise AssertionError(f"train step 1: parameters differ by up to "
                             f"{worst} (bound {2 * lr1}), a share {share} "
                             f"by more than {1e-3 * lr1} (at most "
                             f"{share_cap})")
    faulted = None
    if fault:
        # the kernel run's step 1 again, its routes replayed and expert 0's
        # gradient dropped in every MoE layer: the gate must reject it
        torch.cuda.empty_cache()
        with _ReplayRoutes(step1_routes):
            bad = _drop_expert_grad(lambda: _train_run(model, batches[:1],
                                                       None))
        f_worst, f_share = _param_diff(bad["params_step1"], ref, lr1)
        del bad
        if gate(f_worst, f_share):
            raise AssertionError(f"train step 1 with expert 0's gradient "
                                 f"dropped passes the parameter gate (a "
                                 f"share {f_share}, at most {share_cap})")
        faulted = {"max_abs_diff": f_worst, "share_off": f_share,
                   "rejected": True}
    del ref
    step_ms = statistics.median(k["ms"][1:])
    prof = k["profile"]
    report = {
        "arch": arch, "params": n_params, "layers": cfg.n_layers,
        "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "accum": 2,
        "steps": TRAIN_STEPS, "lr_step1": lr1,
        "loss": k["loss"], "plain_loss": p["loss"],
        "grad_norm": k["grad_norm"], "plain_grad_norm": p["grad_norm"],
        "step_ms": k["ms"], "plain_step_ms": p["ms"],
        "step_ms_median_2_4": step_ms,
        "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (step_ms / 1e3),
        "plain_tokens_per_s": TRAIN_BATCH * TRAIN_SEQ
        / (statistics.median(p["ms"][1:]) / 1e3),
        "launches_per_step": k["launches"][0],
        "params_step1_max_abs_diff": worst,
        "params_step1_share_off": share,
        "params_step1_share_cap": share_cap,
        "plain_other_order_share_off": floor,
        "params_step1_routed_freely": (None if routed_free is None else {
            "max_abs_diff": routed_free[0], "share_off": routed_free[1]}),
        "calibrate": calibrate,
        "faulted_step1": faulted,
        "routes": routes,
        "profiled_step": prof,
        "device_busy_share": prof["device_ms"] / prof["wall_ms_profiled"],
        "peak_mem_bytes": k["peak_mem_bytes"],
        "plain_steps_from_kernel_state": resync,
    }
    if free is not None:
        report["free_plain_loss"] = free["loss"]
        report["free_plain_grad_norm"] = free["grad_norm"]
        report["free_grad_norm_rel_diff"] = [
            abs(a - b) / abs(b) for a, b in zip(k["grad_norm"],
                                                free["grad_norm"])]
    launches = {name: sum(c[name] for c in k["launches"])
                for name in k["launches"][0]}
    return report, launches


def train_ssd_rows(model, tokens, launches_train):
    """B7's backward at the training path's shape, on the real inputs of the
    first and the last layer (the seeded parameters' forward over the
    first microbatch: x (4, 1,024, 32, 64), N 128, chunk 128, f32, c
    broadcast over H), dy drawn from a seeded generator and dh_final None
    (the mixer drops h_final in training), from the kernel forward's
    scratch; a third variant takes layer 0's decays to the power 1/100,
    where the state carried between chunks counts. Each against its plain
    version on the same scratch (SSD_BWD_TOL), called twice (bit for bit
    the same), timed beside its bound."""
    cfg = model.cfg
    dev = model.device
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        torch.float32)
    _, norm_apply = lm.make_norm(cfg)
    layers = [layer for *_, layer in params.all_layers()]
    inputs = {}
    with torch.no_grad():
        x = lm.embed(params.embed, tokens)
        for i, layer in enumerate(layers):
            if i in (0, len(layers) - 1):
                h = norm_apply(layer.norm1, x)
                inputs[f"layer{i}"] = ssm.ssd_inputs(layer.mamba, h, cfg)[3:]
            x, _ = lm._apply_layer(cfg, layer, x, None, None)
    del params
    xh, a, b, c = inputs["layer0"]
    inputs["layer0-slow-decay"] = (xh, a ** 0.01, b, c)
    g = torch.Generator(device=dev).manual_seed(5)
    chunk = 128
    row = None
    for label, (xh, a, b, c) in inputs.items():
        _, _, st, cl = ss.ssd_scan_cuda(xh, a, b, c, chunk,
                                        return_scratch=True)
        dy = torch.randn(xh.shape, generator=g, device=dev)
        args = (xh, a, b, c, dy, None, st, cl, chunk)
        run = lambda a_=args: ss.ssd_scan_bwd_cuda(*a_)
        plain = lambda a_=args: ss.ssd_scan_bwd_torch(*a_)
        got, want, again = run(), plain(), run()
        torch.cuda.synchronize()
        err = {}
        for name, u, w in zip(("dx", "da", "db", "dc"), got, want):
            scale = float(w.abs().max())
            err[name] = float((u - w).abs().max())
            if not (bool(torch.isfinite(u).all()) and torch.allclose(
                    u, w, atol=SSD_BWD_TOL * scale, rtol=SSD_BWD_TOL)):
                raise AssertionError(f"ssd_scan_bwd ({label}): {name} "
                                     f"differs from its plain version by "
                                     f"{err[name]} (scale {scale})")
        if not all(torch.equal(u, w) for u, w in zip(got, again)):
            raise AssertionError(f"ssd_scan_bwd ({label}): two calls differ")
        B, S, H, P = xh.shape
        N = b.shape[-1]
        flops, nbytes = ss.work_bwd(xh, b, c, False)
        peak = hw.peak_flops(xh.dtype, b.dtype, c.dtype)
        bound_s, bound_by = hw.bound_seconds(nbytes, flops, peak)
        r = {
            "name": "ssd_scan_bwd", "route": "cuda",
            "source": SOURCES["ssd_scan_bwd"],
            "replaces": REPLACES["ssd_scan_bwd"],
            "launches": launches_train["ssd_scan_bwd"],
            "launches_by_path": {"train": launches_train["ssd_scan_bwd"]},
            "variant": label,
            "shape": f"B={B} S={S} H={H} P={P} N={N} chunk={chunk} f32, "
                     f"c broadcast over H (stride {c.stride(2)}), "
                     f"dh_final None",
            "max_abs_err": max(err.values()), "max_abs_err_by_grad": err,
            "bit_reproducible": True,
            "ms": _time_ms(run, KERNEL_REPS, flush),
            "ms_l2_warm": _time_ms(run, KERNEL_REPS, _NoFlush()),
            "plain_ms": _time_ms(plain, PLAIN_REPS, flush),
            "bound_ms": bound_s * 1e3, "bound_by": bound_by,
            "bytes": int(nbytes), "ops": int(flops), "peak_flops": peak,
            "library_ms": None,
        }
        if row is None:
            row = r
        else:
            row["max_abs_err"] = max(row["max_abs_err"], r["max_abs_err"])
            row.setdefault("variants", {})[label] = r
    return row


def print_training(tag, tr, seconds):
    """A training phase's lines, each prefixed ``tag``."""
    print(f"{tag}train: {tr['arch']} at full width, {tr['layers']} layers, "
          f"{tr['params']} "
          f"parameters (f32, AdamW f32), batch {TRAIN_BATCH} x {TRAIN_SEQ}, "
          f"2 microbatches, {TRAIN_STEPS} steps in {seconds:.2f} s (with the "
          f"plain run)")
    print(f"{tag}train step ms: {tr['step_ms_median_2_4']:.3f} (median of "
          f"steps 2-{TRAIN_STEPS}; plain versions "
          f"{statistics.median(tr['plain_step_ms'][1:]):.3f})")
    print(f"{tag}train tokens/s: {tr['tokens_per_s']:.1f} (plain versions "
          f"{tr['plain_tokens_per_s']:.1f})")
    print(f"{tag}train device busy share: {tr['device_busy_share']:.4f} "
          f"(torch.profiler, one step)")
    print(f"{tag}train peak memory: {tr['peak_mem_bytes']} B")
    print(f"{tag}train step 1: parameters apart by up to "
          f"{tr['params_step1_max_abs_diff']} (bound 2 lr(1) = "
          f"{2 * tr['lr_step1']}), a share {tr['params_step1_share_off']} "
          f"by more than 1e-3 lr(1) (at most {tr['params_step1_share_cap']}"
          f"; the plain version in another summation order "
          f"{tr['calibrate']}: {tr['plain_other_order_share_off']})")
    if tr["params_step1_routed_freely"]:
        f = tr["params_step1_routed_freely"]
        print(f"{tag}train step 1 against the plain step that routes freely "
              f"(reported, not gated): a share {f['share_off']} apart by "
              f"more than 1e-3 lr(1), up to {f['max_abs_diff']}")
    if tr["faulted_step1"]:
        f = tr["faulted_step1"]
        print(f"{tag}train step 1 with expert 0's gradient dropped: a share "
              f"{f['share_off']} apart by more than 1e-3 lr(1), up to "
              f"{f['max_abs_diff']}: rejected by the gate")
    if tr["routes"]:
        r = tr["routes"]
        print(f"{tag}train route flips per MoE layer (kernels against plain,"
              f" {r['calls']} routed calls): "
              f"{[x['flips'] for x in r['per_moe_layer']]}, capacity-only "
              f"changes {[x['capacity_only'] for x in r['per_moe_layer']]}, "
              f"near ties {[x['near_ties'] for x in r['per_moe_layer']]} of "
              f"{r['per_moe_layer'][0]['tokens']} tokens a layer; largest "
              f"share in a call {r['max_call_flip_share']}")
    print(f"{tag}train launches per step: "
          f"{json.dumps(tr['launches_per_step'])}")
    print(f"{tag}train loss {tr['loss']} (plain {tr['plain_loss']}), grad "
          f"norm {tr['grad_norm']} (plain {tr['plain_grad_norm']})")


def crash_resume():
    """``launch.train.main`` on the reduced config on the card: an
    uninterrupted run, and a run crashed at step RESUME_FAIL_AT and
    resumed, must end on the same parameters and AdamW state, bit for
    bit. Checkpoints go to a scratch directory under ``build/``."""
    import tempfile
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        a, b = str(Path(tmp) / "a"), str(Path(tmp) / "b")
        if train.main(RESUME_ARGS + ["--ckpt-dir", a]) != 0:
            raise AssertionError("uninterrupted reduced training failed")
        rc = train.main(RESUME_ARGS + ["--ckpt-dir", b, "--fail-at",
                                       str(RESUME_FAIL_AT)])
        if rc != train.CRASH_EXIT:
            raise AssertionError(f"--fail-at returned {rc}")
        if train.main(RESUME_ARGS + ["--ckpt-dir", b, "--resume"]) != 0:
            raise AssertionError("resumed reduced training failed")
        last = int(RESUME_ARGS[RESUME_ARGS.index("--steps") + 1])
        want, got = (np.load(Path(d) / f"step_{last:08d}" / "shard_0.npz")
                     for d in (a, b))
        if sorted(want.files) != sorted(got.files):
            raise AssertionError("resumed checkpoint has other leaves")
        differ = [n for n in want.files
                  if not np.array_equal(want[n], got[n])]
        if differ:
            raise AssertionError(f"resumed run differs from the "
                                 f"uninterrupted one in {differ[:5]}")
        return {"leaves": len(want.files), "bit_equal": True,
                "crashed_at": RESUME_FAIL_AT, "steps": last}


def train_attention_rows(launches_train):
    """B5's forward with lse, and B5's backward, at the training path's
    shape (one microbatch: q, k, v (4, 1,024, 16, 128) f32, causal),
    against their plain versions, timed beside their bounds and SDPA (the
    backward's yardstick: ``torch.autograd.grad`` through one f32 SDPA
    call, its forward done once outside the timing)."""
    cfg = get_arch(TRAIN_ARCH)
    dev = torch.device("cuda")
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)
    g = torch.Generator(device=dev).manual_seed(3)
    B, S, H, D = TRAIN_BATCH // 2, TRAIN_SEQ, cfg.n_heads, cfg.head_dim
    q, k, v, do = (torch.randn((B, S, H, D), generator=g, device=dev)
                   for _ in range(4))
    el = lambda t: t.numel() * t.element_size()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt, dot_ = (x.transpose(1, 2) for x in (q, k, v, do))
    peak = hw.peak_flops(q.dtype)
    pairs = fa.work(q.shape, k.shape, True, None)

    # forward with lse
    run_f = lambda: fa.flash_attention_cuda(q, k, v, return_lse=True)
    plain_f = lambda: fa.flash_attention_torch(q, k, v, return_lse=True)
    (out, lse), (pout, plse) = run_f(), plain_f()
    torch.cuda.synchronize()
    err_f = max(float((out - pout).abs().max()),
                float((lse - plse).abs().max()))
    if not (torch.allclose(out, pout, **ATTN_TOL)
            and torch.allclose(lse, plse, **ATTN_TOL)):
        raise AssertionError(f"flash_attention (train): kernel differs from "
                             f"its plain version by {err_f}")
    lib_f = lambda: sdpa(qt, kt, vt, is_causal=True)
    nbytes_f = el(q) * 2 + el(k) + el(v) + el(lse)
    bound_s, bound_by = hw.bound_seconds(nbytes_f, pairs * 4 * D, peak)
    fwd = {
        "name": "flash_attention", "variant": "train",
        "launches": launches_train["flash_attention"],
        "shape": f"B={B} Sq=Sk={S} Hq=Hkv={H} D={D} f32 causal, with lse",
        "max_abs_err": err_f,
        "ms": _time_ms(run_f, KERNEL_REPS, flush),
        "ms_l2_warm": _time_ms(run_f, KERNEL_REPS, _NoFlush()),
        "plain_ms": _time_ms(plain_f, PLAIN_REPS, flush),
        "bound_ms": bound_s * 1e3, "bound_by": bound_by,
        "bytes": int(nbytes_f), "ops": int(pairs * 4 * D),
        "peak_flops": peak,
        "library_ms": _time_ms(lib_f, KERNEL_REPS, flush),
        "library_call": "torch.nn.functional.scaled_dot_product_attention",
    }

    # backward, from the kernel forward's out and lse
    run_b = lambda: fa.flash_attention_bwd_cuda(q, k, v, out, lse, do)
    plain_b = lambda: fa.flash_attention_bwd_torch(q, k, v, out, lse, do)
    got, want = run_b(), plain_b()
    again = run_b()
    torch.cuda.synchronize()
    err_b = max(float((a - b).abs().max()) for a, b in zip(got, want))
    if not all(torch.allclose(a, b, **BWD_TOL) for a, b in zip(got, want)):
        raise AssertionError(f"flash_attention_bwd: kernel differs from its "
                             f"plain version by {err_b}")
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError("flash_attention_bwd: two calls differ")
    ql, kl, vl = (x.detach().clone().requires_grad_() for x in (qt, kt, vt))
    lib_out = sdpa(ql, kl, vl, is_causal=True)
    lib_b = lambda: torch.autograd.grad(lib_out, (ql, kl, vl), dot_,
                                        retain_graph=True)
    lib_err = max(float((a.transpose(1, 2) - b).abs().max())
                  for a, b in zip(lib_b(), want))
    f64 = _bwd_f64_errors(dev, g, D)
    nbytes_b = 4 * el(q) + 4 * el(k) + el(lse)
    ops_b = pairs * 5 * 2 * D
    bound_s, bound_by = hw.bound_seconds(nbytes_b, ops_b, peak)
    bwd = {
        "name": "flash_attention_bwd", "route": "cuda",
        "source": SOURCES["flash_attention_bwd"],
        "replaces": REPLACES["flash_attention_bwd"],
        "launches": launches_train["flash_attention_bwd"],
        "launches_by_path": {"train": launches_train["flash_attention_bwd"]},
        "variant": "train",
        "shape": f"B={B} Sq=Sk={S} Hq=Hkv={H} D={D} f32 causal",
        "max_abs_err": err_b, "bit_reproducible": True,
        "ms": _time_ms(run_b, KERNEL_REPS, flush),
        "ms_l2_warm": _time_ms(run_b, KERNEL_REPS, _NoFlush()),
        "plain_ms": _time_ms(plain_b, PLAIN_REPS, flush),
        "bound_ms": bound_s * 1e3, "bound_by": bound_by,
        "bytes": int(nbytes_b), "ops": int(ops_b), "peak_flops": peak,
        "library_ms": _time_ms(lib_b, KERNEL_REPS, flush),
        "library_call": "torch.autograd.grad through one f32 "
                        "torch.nn.functional.scaled_dot_product_attention",
        "library_max_abs_err": lib_err,
        "library_kernels": _device_kernels(lib_b),
        "f64_reference": f64,
    }
    return fwd, bwd


def _bwd_f64_errors(dev, g, D):
    """B5's backward and its plain version in f32 against the plain pair in
    f64, at S 1,024 with 8 query heads over one KV head (8,192 rows sum
    into each key's dK and dV): the max abs error of each gradient, and
    its largest entry. The kernel must be within BWD_TOL of f64."""
    B, S, Hq, Hkv = 1, 1024, 8, 1
    q, do = (torch.randn((B, S, Hq, D), generator=g, device=dev)
             for _ in range(2))
    k, v = (torch.randn((B, S, Hkv, D), generator=g, device=dev)
            for _ in range(2))
    q64, k64, v64, do64 = (x.double() for x in (q, k, v, do))
    out64, lse64 = fa.flash_attention_torch(q64, k64, v64, return_lse=True)
    want = fa.flash_attention_bwd_torch(q64, k64, v64, out64, lse64, do64)
    out, lse = out64.float(), lse64.float()
    got = fa.flash_attention_bwd_cuda(q, k, v, out, lse, do)
    plain = fa.flash_attention_bwd_torch(q, k, v, out, lse, do)
    torch.cuda.synchronize()
    if not all(torch.allclose(a.double(), b, **BWD_TOL)
               for a, b in zip(got, want)):
        raise AssertionError("flash_attention_bwd: kernel differs from the "
                             "f64 plain pair past BWD_TOL")
    err = lambda xs: [float((a.double() - b).abs().max())
                      for a, b in zip(xs, want)]
    return {"shape": f"B={B} Sq=Sk={S} Hq={Hq} Hkv={Hkv} D={D} causal",
            "max_abs_err_dq_dk_dv": err(got),
            "plain_f32_max_abs_err_dq_dk_dv": err(plain),
            "max_abs_dq_dk_dv": [float(b.abs().max()) for b in want]}


# -- bf16 serving: the MoE and dense phases -------------------------------------

class _Routes:
    """While installed, records every MoE layer's routing, in call order:
    from ``moe.route`` the router inputs (with ``keep_inputs``) and the
    chosen expert ids, from ``moe.dispatch`` which choices were kept under
    the capacity; ``ids`` holds each token's kept experts, ascending, with
    -1 for a choice dropped past capacity. Two runs route a token alike
    when these are equal: a route changed in one token can push another,
    later in an expert's order, past its capacity."""

    def __init__(self, keep_inputs=False):
        self.keep_inputs = keep_inputs
        self.calls = []

    def __enter__(self):
        self._route, self._dispatch = moe.route, moe.dispatch

        def route(p, xf, cfg):
            probs, gate_w, ids = self._route(p, xf, cfg)
            self.calls.append({
                "chosen": ids,
                "x": xf.detach() if self.keep_inputs else None,
                "router": (p["router"].detach().clone() if self.keep_inputs
                           else None)})
            return probs, gate_w, ids

        def dispatch(ids, T, E, C):
            dest = self._dispatch(ids, T, E, C)
            kept = torch.where(dest < E * C, ids, -1)
            self.calls[-1]["ids"] = kept.sort(-1).values
            return dest
        moe.route, moe.dispatch = route, dispatch
        return self

    def __exit__(self, *exc):
        moe.route, moe.dispatch = self._route, self._dispatch


class _ReplayRoutes:
    """While installed, ``moe.route`` takes each call's experts from a
    recorded run (``calls``' chosen ids, in call order) and gates them with
    this run's own probabilities, renormalised as ``route`` does: where
    the recorded run chose as this one would, nothing changes (the sort's
    values are the probabilities it gathers), and the gradient reaches the
    router the same way, through the gathered probabilities."""

    def __init__(self, calls):
        self.calls = calls

    def __enter__(self):
        self._route = moe.route
        chosen = iter([c["chosen"] for c in self.calls])

        def route(p, xf, cfg):
            probs, _, _ = self._route(p, xf, cfg)
            ids = next(chosen)
            gate_w = probs.gather(1, ids)
            return probs, gate_w / gate_w.sum(-1, keepdim=True).clamp_min(
                1e-9), ids
        moe.route = route
        return self

    def __exit__(self, *exc):
        moe.route = self._route


def _route_flips(got, want):
    """Per call, the tokens whose chosen experts differ between two
    recorded runs of the same calls."""
    if len(got.calls) != len(want.calls):
        raise AssertionError(f"{len(got.calls)} routed calls against "
                             f"{len(want.calls)}")
    return [(a["ids"] != b["ids"]).any(-1)
            for a, b in zip(got.calls, want.calls)]


def _top_k_set(logits, k):
    """Each row's k largest entries' indices, ascending; ties to the lower
    index, as ``moe.route`` breaks them."""
    top = torch.sort(logits, dim=-1, descending=True, stable=True).indices
    return torch.sort(top[:, :k], dim=-1).values


def _gate_layer(i, rk, rp, out_k, out_p, cfg, worst):
    """One layer of the routing-aware gate (``bf16_layer_checks``): the
    recorded routes of the kernel run ``rk`` and the plain run ``rp`` of
    the same layer on the same input, and their outputs. Returns the
    tokens whose kept experts agree."""
    T = out_p.numel() // out_p.shape[-1]
    same = torch.ones(T, dtype=torch.bool, device=out_p.device)
    if rk.calls:
        (ck,), (cp,) = rk.calls, rp.calls
        xk, xp = ck["x"].float(), cp["x"].float()
        err = float((xk - xp).abs().max()) / float(xp.abs().max())
        worst["router_input_max_rel_err"] = max(
            worst["router_input_max_rel_err"], err)
        if err > MOE_INPUT_TOL:
            raise AssertionError(
                f"layer {i}: router inputs differ by {err} of their largest "
                f"entry (tolerance {MOE_INPUT_TOL})")
        same = (ck["ids"] == cp["ids"]).all(-1)
        lk = (ck["x"] @ cp["router"]).float()
        lp = (cp["x"] @ cp["router"]).float()
        top = torch.sort(lp, dim=-1, descending=True).values
        gap = top[:, cfg.top_k - 1] - top[:, cfg.top_k]
        bound = (((xk - xp) @ cp["router"].float()).abs().amax(-1)
                 + BF16_ROUND * torch.maximum(lk.abs().amax(-1),
                                              lp.abs().amax(-1)))
        near = gap <= 2 * bound
        chose = (_top_k_set(lk, cfg.top_k)
                 == _top_k_set(lp, cfg.top_k)).all(-1)
        if bool((~chose & ~near).any()):
            t = int((~chose & ~near).nonzero()[0])
            raise AssertionError(
                f"layer {i}: token {t} changed experts at a logit gap "
                f"{float(gap[t])} over twice its bound {float(bound[t])}")
        worst["capacity_only_changes"] += int((chose & ~same).sum())
        n_flip = int((~same).sum())
        worst["route_flips"] += n_flip
        worst["routed_tokens"] += T
        worst["max_layer_flip_share"] = max(worst["max_layer_flip_share"],
                                            n_flip / T)
        worst["max_layer_near_tie_share"] = max(
            worst["max_layer_near_tie_share"], float(near.float().mean()))
        if n_flip > MOE_FLIP_SHARE * T:
            raise AssertionError(f"layer {i}: {n_flip} of {T} tokens "
                                 f"changed experts")
    tol = MOE_LAYER_TOL if rk.calls else DENSE_LAYER_TOL
    d = (out_k.float() - out_p.float()).reshape(T, -1).abs()
    err = float((d * same[:, None]).max()) / float(out_p.float().abs().max())
    worst["layer_output_max_rel_err"] = max(
        worst["layer_output_max_rel_err"], err)
    if err > tol:
        raise AssertionError(
            f"layer {i}: outputs differ by {err} of their largest entry on "
            f"tokens whose experts agree (tolerance {tol})")
    return same


def _gate_logits(cfg, params, hk, hp, agree, worst):
    """Logits of the last layer's two outputs, on the tokens whose kept
    experts agreed in every layer, entry by entry: within what the
    difference of the normed hidden states moves them by (its product
    with the head in f32), plus each run's bf16 rounding of its logits
    (BF16_ROUND of the larger for the two) and LOGIT_SLACK of the row's
    largest logit for the two runs' f32 sums in cuBLAS's order."""
    _, norm_apply = lm.make_norm(cfg)
    w = params.embed["table"].T if cfg.tie_embeddings else params.head["w"]
    nk = norm_apply(params.final_norm, hk.reshape(-1, hk.shape[-1])[agree])
    np_ = norm_apply(params.final_norm, hp.reshape(-1, hp.shape[-1])[agree])
    real = slice(0, cfg.vocab)
    for j in range(0, nk.shape[0], 256):
        a, b = nk[j:j + 256], np_[j:j + 256]
        la = lm.logits(cfg, params, a)[:, real]
        lb = lm.logits(cfg, params, b)[:, real]
        d = (la - lb).abs()
        big = torch.maximum(la.abs(), lb.abs())
        bound = (((a.float() - b.float()) @ w.float())[:, real].abs()
                 + BF16_ROUND * big + LOGIT_SLACK * big.amax(-1, True))
        worst["logit_max_abs_err"] = max(worst["logit_max_abs_err"],
                                         float(d.max()))
        worst["logit_max_bound_share"] = max(
            worst["logit_max_bound_share"], float((d / bound).max()))
        if bool((d > bound).any()):
            raise AssertionError(f"logits differ by {float(d.max())}, over "
                                 f"the bound of their hidden states")


def bf16_layer_checks(model, params, prompts, cache):
    """The layer-by-layer gate of a bf16 model, routing-aware where it has
    MoE layers. Every layer of the prefill
    gets the plain run's input and runs with the kernels and with the
    plain versions (``lm._apply_layer``); every layer of one decode step
    (B6 over ``cache``, copied for each run) likewise (``lm.decode_layer``).
    The two runs of a layer differ only in B5's (B6's) output. A dense
    layer's outputs must be within DENSE_LAYER_TOL of their largest
    entry; for each MoE layer:

    * the router inputs (``norm2`` of the residual, bf16) must agree
      within MOE_INPUT_TOL of their largest entry;
    * a token's chosen experts may differ only where the gap between its
      k-th and (k+1)-th router logits is at most 2 L, L = max_e |dx·r_e|
      + BF16_ROUND max |logit|: the input difference moves no logit by
      more than the first term (the product of the two runs' router
      inputs' difference with the router, in f32), and each run rounds
      its logits to bf16 once; so a route that flips is a near tie;
    * a token's kept experts may differ besides only through capacity: a
      changed route earlier in an expert's order pushes it past the
      expert's capacity or back;
    * at most MOE_FLIP_SHARE of a layer's tokens may change experts;
    * the layer outputs of the tokens whose experts agree must be within
      MOE_LAYER_TOL of the output's largest entry.

    After the last layer, the logits of the tokens whose experts agreed in
    every layer are held to ``_gate_logits``' bound. The routing fields
    are reported only for a model with MoE layers."""
    cfg = model.cfg
    B, S = prompts.shape
    n_moe = sum(1 for *_, layer in params.all_layers()
                if layer.spec.ffn == "moe")
    routing = ("router_input_max_rel_err", "route_flips",
               "capacity_only_changes", "routed_tokens",
               "max_layer_flip_share", "max_layer_near_tie_share")
    worst = dict.fromkeys((routing if n_moe else ()) + (
        "layer_output_max_rel_err", "logit_max_abs_err",
        "logit_max_bound_share"), 0)

    def finish(worst, tokens, agree):
        r = dict(worst, tokens=tokens)
        if n_moe:
            r["tokens_agreeing_in_every_layer"] = int(agree.sum())
        return r
    report = {}
    with torch.no_grad():
        x = lm.embed(params.embed, prompts)
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x.device)[None].expand(B, S)
        agree = torch.ones(B * S, dtype=torch.bool, device=x.device)
        for i, (*_, layer) in enumerate(params.all_layers()):
            with _Routes(keep_inputs=True) as rk:
                out_k, _ = lm._apply_layer(cfg, layer, x, positions, None)
            with _Routes(keep_inputs=True) as rp:
                out_p, _ = lm._apply_layer(cfg, layer, x, positions, "torch")
            agree &= _gate_layer(i, rk, rp, out_k, out_p, cfg, worst)
            x = out_p
        _gate_logits(cfg, params, out_k, out_p, agree, worst)
        report["prefill"] = finish(worst, B * S, agree)
        worst = dict.fromkeys(worst, 0)
        pos = int(cache["pos"])
        x = lm.embed(params.embed, torch.arange(B, device=x.device) + 7)
        agree = torch.ones(B, dtype=torch.bool, device=x.device)
        for i, (si, rep, bpos, layer) in enumerate(params.all_layers()):
            c = lm.layer_cache(cache["segments"][si][bpos], rep)
            with _Routes(keep_inputs=True) as rk:
                out_k = lm.decode_layer(cfg, layer, x,
                                        {k: t.clone() for k, t in c.items()},
                                        pos, None)
            with _Routes(keep_inputs=True) as rp:
                out_p = lm.decode_layer(cfg, layer, x,
                                        {k: t.clone() for k, t in c.items()},
                                        pos, "torch")
            agree &= _gate_layer(i, rk, rp, out_k, out_p, cfg, worst)
            x = out_p
        _gate_logits(cfg, params, out_k, out_p, agree, worst)
        report["decode_step"] = finish(worst, B, agree)
    tolerances = {"dense_layer_output": DENSE_LAYER_TOL}
    if n_moe:
        flips = sum(r["route_flips"] for r in report.values())
        routed = sum(r["routed_tokens"] for r in report.values())
        report.update(route_flips=flips, routed_tokens=routed,
                      flip_share=flips / routed)
        tolerances.update(router_input=MOE_INPUT_TOL,
                          moe_layer_output=MOE_LAYER_TOL,
                          flip_share_per_layer=MOE_FLIP_SHARE)
    report["tolerances"] = tolerances
    return report


def bf16_prefill_decode(model, params, prompts, cache_len):
    """A bf16 model's serving path (moonshot's, and qwen2.5-32b's, which
    has no MoE layer to route): prefill + DECODE_STEPS greedy decode steps
    with the kernels (counts reset just before, read just after), then the
    same prefill and the same decode inputs with the plain versions, the
    routes of both recorded. Launch counts must be exact and every logit
    finite. Through 48 or 64 bf16 layers each run's roundings compound,
    and once a token changes experts the two runs compute on different
    activations: the logits' difference (for a MoE model on the sequences
    whose experts agreed so far, with the tokens that changed experts) and
    the share of equal greedy tokens are reported; the gate is
    ``bf16_layer_checks``, which holds every layer to the same input."""
    B, S = prompts.shape
    model.prefill(params, {"tokens": prompts}, max_len=cache_len)  # warm-up
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    with _Routes() as rk:
        t0 = time.perf_counter()
        lg0, cache = model.prefill(params, {"tokens": prompts},
                                   max_len=cache_len)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        after_prefill = _build.launch_counts()
        toks, lgs, step_ms = [lg0.argmax(-1)], [lg0], []
        for _ in range(DECODE_STEPS):
            t0 = time.perf_counter()
            lg, cache = model.decode_step(params, cache, toks[-1])
            toks.append(lg.argmax(-1))
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            lgs.append(lg)
    launches = _build.launch_counts()
    decode_launches = {k: launches[k] - after_prefill[k] for k in launches}
    profiles = {
        "prefill": _profile(lambda: model.prefill(
            params, {"tokens": prompts}, max_len=cache_len)),
        "decode_step": _profile(lambda: model.decode_step(
            params, cache, toks[-1])),
    }
    with _Routes() as rp:
        t0 = time.perf_counter()
        plg, pcache = model.prefill(params, {"tokens": prompts},
                                    max_len=cache_len, impl="torch")
        torch.cuda.synchronize()
        plain_prefill_ms = (time.perf_counter() - t0) * 1e3
        plgs, plain_step_ms = [plg], []
        for i in range(DECODE_STEPS):
            t0 = time.perf_counter()
            plg, pcache = model.decode_step(params, pcache, toks[i],
                                            impl="torch")
            torch.cuda.synchronize()
            plain_step_ms.append((time.perf_counter() - t0) * 1e3)
            plgs.append(plg)
    del pcache
    n_moe = sum(1 for *_, layer in params.all_layers()
                if layer.spec.ffn == "moe")
    flips = _route_flips(rk, rp)        # n_moe prefill calls, then per step
    clean = torch.ones(B, dtype=torch.bool, device=prompts.device)
    err, checked, agree, flipped_prefill = 0.0, 0, 0, 0
    for step in range(DECODE_STEPS + 1):
        calls = (flips[:n_moe] if step == 0 else
                 flips[n_moe * step:n_moe * (step + 1)])
        for f in calls:
            rows = f.reshape(B, -1).any(-1)
            clean &= ~rows
            if step == 0:
                flipped_prefill += int(f.sum())
        got, want = lgs[step], plgs[step]
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"non-finite logits at step {step}")
        if bool(clean.any()):
            err = max(err, float((got[clean] - want[clean]).abs().max()))
            checked += int(clean.sum())
        agree += int((want.argmax(-1) == toks[step]).sum())
    expect = {"flash_attention": (model.cfg.n_layers, 0),
              "decode_attention": (0, model.cfg.n_layers),
              "ssd_scan": (0, 0)}
    for k, (per_prefill, per_step) in expect.items():
        if after_prefill[k] != per_prefill:
            raise AssertionError(f"prefill launched {k} {after_prefill[k]} "
                                 f"times, not {per_prefill}")
        if decode_launches[k] != per_step * DECODE_STEPS:
            raise AssertionError(f"{DECODE_STEPS} decode steps launched {k} "
                                 f"{decode_launches[k]} times, not "
                                 f"{per_step * DECODE_STEPS}")
    report = {
        "arch": model.cfg.name, "batch": B, "prompt_len": S,
        "cache_len": cache_len, "decode_steps": DECODE_STEPS,
        "prefill_ms": prefill_ms, "plain_prefill_ms": plain_prefill_ms,
        "decode_ms_per_step": statistics.median(step_ms[1:]),
        "decode_ms_first_step": step_ms[0],
        "plain_decode_ms_per_step": statistics.median(plain_step_ms[1:]),
        "launches": launches,
        "launches_per_prefill": {k: after_prefill[k] for k in expect},
        "launches_per_decode_step": {k: decode_launches[k] / DECODE_STEPS
                                     for k in expect},
        "logits_checked_rows": checked,
        "greedy_tokens_equal_to_plain": agree,
        "greedy_tokens_total": B * (DECODE_STEPS + 1),
        "profiles": profiles,
    }
    if n_moe:
        report.update({
            "prefill_tokens_with_changed_experts": flipped_prefill,
            "prefill_routed_tokens": n_moe * B * S,
            "sequences_with_agreeing_experts_at_end": int(clean.sum()),
            "logit_max_abs_err_where_experts_agree": err})
    else:
        report["logit_max_abs_err"] = err
    return report, cache


def bf16_engine_run(model, params):
    """The engine at ``launch.serve``'s reference defaults (16 requests x 16
    tokens, 8 slots, max_len 64) on the bf16 model: Algorithm 1 plans from
    the measured segment latencies as ``serve.run`` does, then the engine
    serves with the kernels (counts reset just before, read just after)
    and with the plain versions on the same plan. The routes of both runs
    are recorded with the requests each pipeline step served. Both must
    serve the same schedule, every request to its 16 tokens; the tokens
    equal up to each request's first difference, and for a MoE model the
    requests that changed experts in some layer, are reported."""
    cfg = model.cfg
    lat = serve.measure_segment_latencies(model, params, 8, 64)
    plan = plan_serving(model, lat)
    runs = []
    for impl in (None, "torch"):
        eng = ServingEngine(model, params, num_pipelines=plan.num_pipelines,
                            slots_per_pipeline=8, max_len=64, impl=impl)
        steps = []
        step = PipelineInstance.step

        def traced(self, step=step, steps=steps):
            if self.active:
                steps.append({s: r.rid for s, r in self.active.items()})
            step(self)
        for req in serve.make_requests(cfg, 16, 16):
            eng.submit(req)
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        PipelineInstance.step = traced
        try:
            with _Routes() as routes:
                t0 = time.perf_counter()
                done = eng.run(max_steps=64 - 8)
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
        finally:
            PipelineInstance.step = step
        runs.append((eng, done, steps, routes, seconds,
                     _build.launch_counts()))
    (eng, done, steps, rk, sec, launches), (_, pdone, psteps, rp, psec, _) = \
        runs
    if len(done) != 16 or len(pdone) != 16 or steps != psteps:
        raise AssertionError("the two engines served different schedules")
    if launches["decode_attention"] < 1 or launches["flash_attention"]:
        raise AssertionError(f"moe engine launches {launches}")
    n_moe = sum(1 for *_, layer in params.all_layers()
                if layer.spec.ffn == "moe")
    flips = _route_flips(rk, rp)
    flipped = set()                     # requests that changed experts
    for s, slots in enumerate(steps):
        for f in flips[n_moe * s:n_moe * (s + 1)]:
            flipped.update(slots[slot] for slot in
                           f.nonzero().flatten().tolist() if slot in slots)
    same = 0
    for g, w in zip(done, pdone):
        if g.rid != w.rid:
            raise AssertionError("engine runs completed different requests")
        if len(g.out) != 16 or len(w.out) != 16:
            raise AssertionError(f"request {g.rid}: {len(g.out)} and "
                                 f"{len(w.out)} tokens, want 16")
        for a, b in zip(g.out, w.out):
            if a != b:
                break
            same += 1
    tokens = sum(len(r.out) for r in done)
    report = {
        "pipelines": plan.num_pipelines, "R": plan.R,
        "latencies_s": plan.latencies, "requests": 16, "tokens": tokens,
        "seconds": sec, "tokens_per_s": tokens / sec,
        "plain_tokens_per_s": tokens / psec,
        "tokens_equal_to_plain": same,
        "launches": launches,
    }
    if n_moe:
        report["requests_with_changed_experts"] = len(flipped)
    return eng, report


def _sdpa_kv(x, G):
    """k or v (B, S, Hkv, D) as SDPA takes them next to (B, Hq, S, D)
    queries: each KV head repeated for its G query heads, made once
    outside the timed call."""
    return x.repeat_interleave(G, dim=2).transpose(1, 2)


def _flash_spec(label, q, k, v, causal, launches, dtype_note):
    """A B5 variant spec over q, k, v (B, S, H, D) with SDPA beside it."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = q.transpose(1, 2), _sdpa_kv(k, Hq // Hkv), _sdpa_kv(
        v, Hq // Hkv)
    el = lambda t: t.numel() * t.element_size()
    inst = fa.instance(q, k, v)
    _, parts = fa.split_plan(q, k, v, causal, None)
    return dict(
        name="flash_attention", label=label, launches=launches,
        run=lambda: fa.flash_attention_cuda(q, k, v, causal=causal),
        plain=lambda: fa.flash_attention_torch(q, k, v, causal=causal),
        lib=lambda: sdpa(qt, kt, vt, is_causal=causal),
        shape=f"B={B} Sq={Sq} Sk={Sk} Hq={Hq} Hkv={Hkv} (G {Hq // Hkv}) "
              f"D={D} {dtype_note} {'causal' if causal else 'non-causal'}",
        nbytes=el(q) * 2 + el(k) + el(v),
        ops=fa.work(q.shape, k.shape, causal, None) * 4 * D,
        peak=hw.peak_flops(q.dtype, k.dtype),
        instance=inst, own_bytes=el(q) + (parts * B * Sq * Hq * (D + 2) * 4
                                          if parts > 1 else 0))


def _decode_spec(label, q, ck, cv, n_valid, launches):
    """A B6 variant spec: q (B, Hq, D) over the cache ck, cv (B, S, Hkv,
    D) with ``n_valid`` rows on every row, SDPA beside it (the cache cast
    to q's dtype and its heads repeated beforehand)."""
    B, Hq, D = q.shape
    S, Hkv = ck.shape[1], ck.shape[2]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    kv_len = torch.full((B,), n_valid, dtype=torch.int32, device=q.device)
    kt, vt = (_sdpa_kv(x.to(q.dtype), Hq // Hkv) for x in (ck, cv))
    mask = (torch.arange(S, device=q.device)[None, :]
            < kv_len[:, None])[:, None, None, :]
    el = lambda t: t.numel() * t.element_size()
    return dict(
        name="decode_attention", label=label, launches=launches,
        run=lambda: da.decode_attention_cuda(q, ck, cv, kv_len),
        plain=lambda: da.decode_attention_torch(q, ck, cv, kv_len),
        lib=lambda: sdpa(q[:, :, None], kt, vt, attn_mask=mask),
        shape=f"B={B} S={S} kv_len={n_valid} Hq={Hq} Hkv={Hkv} (G "
              f"{Hq // Hkv}) D={D} q {str(q.dtype).split('.')[-1]}, cache "
              f"{str(ck.dtype).split('.')[-1]}",
        nbytes=el(q) * 2 + el(kv_len) + B * min(n_valid, S) * Hkv * D * 2
        * ck.element_size(),
        ops=da.work(kv_len, S, Hq) * 4 * D,
        peak=hw.peak_flops(q.dtype, ck.dtype))


def moe_attention_rows(model, cache, engine, launches_pd, launches_engine):
    """B5 and B6 at moonshot's shapes, as ``moonshot`` variant rows: B5 over
    bf16 q, k, v (4, 1,024, 16, 128) causal (its bf16 instance, as on the
    path), B6 over the prefilled bf16 cache (4, 1,536, 16,
    128) with a bf16 query (G 1), and over the engine's f32 cache; each
    against its plain version at two bf16 ulps (ATTN_BF16_TOL), timed
    beside its bound and SDPA."""
    cfg = model.cfg
    dev = model.device
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)
    g = torch.Generator(device=dev).manual_seed(4)
    B, S, H, D = SERVE_BATCH, PROMPT_LEN, cfg.n_heads, cfg.head_dim
    q, k, v = (torch.randn((B, S, H, D), generator=g, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    specs = [_flash_spec("moonshot", q, k, v, True,
                         launches_pd["flash_attention"], "bf16")]
    eng_cache = max((p.cache for p in engine.pipelines),
                    key=lambda c: c["pos"])
    for label, c, n_valid, launches in (
            ("moonshot", cache, PROMPT_LEN + DECODE_STEPS, launches_pd),
            ("moonshot-engine", eng_cache, eng_cache["pos"],
             launches_engine)):
        ck = c["segments"][0][0]["k"][0]
        dq = torch.randn((ck.shape[0], H, D), generator=g, device=dev).to(
            torch.bfloat16)
        specs.append(_decode_spec(label, dq, ck, c["segments"][0][0]["v"][0],
                                  n_valid, launches["decode_attention"]))
    return _variant_rows(specs, flush)


def _variant_rows(specs, flush):
    """Each spec's kernel against its plain version on the same inputs
    (f32 outputs at ATTN_TOL, bf16 at two bf16 ulps, ATTN_BF16_TOL; the
    output keeps q's dtype), timed beside its bound and one SDPA call
    (``lib``): (name, label, row) to attach as variants."""
    out = []
    for s in specs:
        got, want = s["run"](), s["plain"]()
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        tol = ATTN_BF16_TOL if want.dtype == torch.bfloat16 else ATTN_TOL
        if got.dtype != want.dtype or not torch.allclose(
                got.float(), want.float(), **tol):
            raise AssertionError(f"{s['name']} ({s['label']}): kernel "
                                 f"differs from its plain version by {err}")
        name = s["name"]
        extra = {}
        if "instance" in s:
            # what one call requests from the allocator: the bf16 instance
            # reads K and V as they are, so no more than its output and
            # the key split's scratch (f32 copies of K and V would add
            # 8 bytes a K/V entry)
            torch.cuda.synchronize()
            stat = "requested_bytes.all.{}"
            base = torch.cuda.memory_stats()[stat.format("current")]
            torch.cuda.reset_peak_memory_stats()
            s["run"]()
            torch.cuda.synchronize()
            grown = torch.cuda.memory_stats()[stat.format("peak")] - base
            if s["instance"] == "bf16" and grown > s["own_bytes"]:
                raise AssertionError(f"{name} ({s['label']}): a call "
                                     f"requests {grown} B, more than its "
                                     f"output and scratch, {s['own_bytes']}")
            extra = {"instance": s["instance"], "alloc_bytes": grown}
        bound_s, bound_by = hw.bound_seconds(s["nbytes"], s["ops"], s["peak"])
        out.append((name, s["label"], {**extra,
            "name": name, "variant": s["label"], "launches": s["launches"],
            "shape": s["shape"], "max_abs_err": err,
            "ms": _time_ms(s["run"], KERNEL_REPS, flush),
            "ms_l2_warm": _time_ms(s["run"], KERNEL_REPS, _NoFlush()),
            "plain_ms": _time_ms(s["plain"], PLAIN_REPS, flush),
            "bound_ms": bound_s * 1e3, "bound_by": bound_by,
            "bytes": int(s["nbytes"]), "ops": int(s["ops"]),
            "peak_flops": s["peak"],
            "library_ms": _time_ms(s["lib"], KERNEL_REPS, flush),
            "library_call":
                "torch.nn.functional.scaled_dot_product_attention",
        }))
    return out


def moe_phase():
    """moonshot-v1-16b-a3b at full width, bf16 parameters from a generator
    seeded 0 (~54 GB on the card): the layer-by-layer routing gate, the
    serving path (prefill 4 x 1,024 into a 1,536-deep bf16 cache, 32
    decode steps) with the kernels and plain, the engine at its defaults,
    and B5/B6 rows at its shapes."""
    t0 = time.perf_counter()
    model = build(get_arch(MOE_ARCH), "cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        torch.bfloat16)
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        2, model.cfg.vocab, size=(SERVE_BATCH, PROMPT_LEN))).cuda()
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    print(f"serving: {MOE_ARCH} at full width, {n_params} parameters (bf16, "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.1f} GiB on the card) "
          f"made in {time.perf_counter() - t0:.2f} s")
    pd, cache = bf16_prefill_decode(model, params, prompts, CACHE_LEN)
    print_serving("moe ", pd)
    print(f"moe greedy tokens equal to the plain run: "
          f"{pd['greedy_tokens_equal_to_plain']}/{pd['greedy_tokens_total']};"
          f" prefill tokens that changed experts in some layer: "
          f"{pd['prefill_tokens_with_changed_experts']} of "
          f"{pd['prefill_routed_tokens']}")
    gate = bf16_layer_checks(model, params, prompts, cache)
    pre = gate["prefill"]
    print(f"moe routing gate, layer by layer: {gate['route_flips']} of "
          f"{gate['routed_tokens']} routed tokens changed experts (share "
          f"{gate['flip_share']:.5f}, at most "
          f"{pre['max_layer_flip_share']:.5f} in a prefill layer, all at "
          f"near ties); prefill router inputs within "
          f"{pre['router_input_max_rel_err']:.4g}, layer outputs within "
          f"{pre['layer_output_max_rel_err']:.4g} of their largest entry")
    print("moe routing gate " + json.dumps(gate))
    torch.cuda.empty_cache()
    engine, eng = bf16_engine_run(model, params)
    print(f"moe engine tokens/s: {eng['tokens_per_s']:.1f} ({eng['tokens']} "
          f"tokens, {eng['requests']} requests over {eng['pipelines']} "
          f"pipelines; plain versions {eng['plain_tokens_per_s']:.1f})")
    print("moe engine launches: " + json.dumps(eng["launches"]))
    print("moe engine " + json.dumps(eng))
    rows = moe_attention_rows(model, cache, engine, pd["launches"],
                              eng["launches"])
    del model, params, cache, engine, prompts
    torch.cuda.empty_cache()
    return rows, pd["launches"], eng["launches"]


def encdec_attention_rows(model, cache, launches):
    """B5 and B6 at seamless's shapes, as variant rows (random inputs from
    a seeded generator): B5 ``seamless encoder`` over f32 q, k, v (4,
    1,024, 16, 64) non-causal and ``seamless cross`` (decoder queries over
    encoder keys, the prefill's 1,024 tokens over its 1,024 frames),
    and B6 ``seamless cross``: an f32 query (4, 16, 64) over a bf16 cross
    cache (4, 4,096, 16, 64), ``kv_len == S`` on every row (the path's
    cross cache is zeros: random values here, for a check that sees the
    weights), and ``seamless self``: an f32 query over layer 0's self
    cache (4, 1,536, 16, 64) bf16 as the decode run left it, at its
    kv_len (the decode steps so far)."""
    cfg = model.cfg
    dev = model.device
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)
    g = torch.Generator(device=dev).manual_seed(6)
    B, S, H, D = SERVE_BATCH, PROMPT_LEN, cfg.n_heads, cfg.head_dim
    rnd = lambda *shape: torch.randn(shape, generator=g, device=dev)
    specs = [
        _flash_spec("seamless encoder", rnd(B, ENCDEC_FRAMES, H, D),
                    rnd(B, ENCDEC_FRAMES, H, D), rnd(B, ENCDEC_FRAMES, H, D),
                    False, launches["flash_attention"], "f32"),
        _flash_spec("seamless cross", rnd(B, S, H, D),
                    rnd(B, ENCDEC_FRAMES, H, D), rnd(B, ENCDEC_FRAMES, H, D),
                    False, launches["flash_attention"], "f32"),
        _decode_spec("seamless cross", rnd(B, H, D),
                     rnd(B, ENC_LEN, H, D).to(torch.bfloat16),
                     rnd(B, ENC_LEN, H, D).to(torch.bfloat16), ENC_LEN,
                     launches["decode_attention"]),
        _decode_spec("seamless self", rnd(B, H, D), cache["self_k"][0],
                     cache["self_v"][0], int(cache["pos"]),
                     launches["decode_attention"]),
    ]
    return _variant_rows(specs, flush)


def encdec_decode_fault(model, params, inputs):
    """The seamless decode gate's reach: DECODE_STEPS greedy decode steps
    from ``init_cache`` on the plain run's tokens with the plain versions,
    with the kernels, and with the kernels while every B6 call drops its
    newest key (``kv_len - 1``, at least 1: one key of the self cache; the
    cross cache is zeros, where a dropped key changes nothing). Returns
    each step's largest logit difference from the plain run, for the
    sound and the faulted run, and the steps at which each fails the gate
    (``_check_logits``' test at ENCDEC_DECODE_TOL); ``encdec_phase``
    requires the sound run to pass every step and the faulted run to fail
    some. Launches made here are not counted."""
    B = inputs["tokens"].shape[0]
    plg, _ = model.prefill(params, inputs, impl="torch")
    toks = [plg.argmax(-1)]
    decode = ops.decode_attention

    def dropped(q, k, v, kv_len, **kw):
        return decode(q, k, v, torch.clamp(kv_len - 1, min=1), **kw)
    lgs = {}
    for run, impl, b6 in (("plain", "torch", decode), ("sound", None, decode),
                          ("faulted", None, dropped)):
        cache = model.init_cache(B, CACHE_LEN)
        ops.decode_attention = b6
        try:
            lgs[run] = []
            for i in range(DECODE_STEPS):
                lg, cache = model.decode_step(params, cache, toks[i],
                                              impl=impl)
                lgs[run].append(lg)
                if run == "plain":
                    toks.append(lg.argmax(-1))
        finally:
            ops.decode_attention = decode
    tol = ENCDEC_DECODE_TOL
    return {run: {
        "max_abs_err_by_step": [float((a - b).abs().max())
                                for a, b in zip(lgs[run], lgs["plain"])],
        "steps_failing_gate": [i for i, (a, b) in enumerate(
            zip(lgs[run], lgs["plain"]))
            if not torch.allclose(a, b, atol=tol, rtol=tol)]}
        for run in ("sound", "faulted")}


def encdec_phase():
    """seamless-m4t-medium at full width, f32 parameters from a generator
    seeded 0 (~0.72 B, ~2.9 GB): the prefill of 4 x (1,024 stub frames +
    1,024 tokens) (B5 on each encoder layer, bidirectional, and on each
    decoder layer's causal self- and bidirectional cross-attention) and
    32 greedy decode steps from ``init_cache(4, 1,536)`` (B6 on each
    decoder layer's self cache and 4,096-frame cross cache), with the
    kernels and with the plain versions; then the decode gate's reach
    (``encdec_decode_fault``) and B5/B6 rows at its shapes."""
    t0 = time.perf_counter()
    model = build(get_arch(ENCDEC_ARCH), "cuda")
    cfg = model.cfg
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        torch.float32)
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        2, cfg.vocab, size=(SERVE_BATCH, PROMPT_LEN))).cuda()
    frames = torch.randn((SERVE_BATCH, ENCDEC_FRAMES, cfg.d_model),
                         generator=torch.Generator(device="cuda")
                         .manual_seed(0), device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    print(f"serving: {ENCDEC_ARCH} at full width ({cfg.enc_layers} encoder "
          f"+ {cfg.dec_layers} decoder layers), {n_params} parameters (f32) "
          f"made on the card in {time.perf_counter() - t0:.2f} s")
    pd, cache = prefill_decode(
        model, params, prompts, CACHE_LEN,
        {"flash_attention": (cfg.enc_layers + 2 * cfg.dec_layers, 0),
         "decode_attention": (0, 2 * cfg.dec_layers), "ssd_scan": (0, 0)},
        ENCDEC_PREFILL_TOL, ENCDEC_DECODE_TOL, frames=frames)
    pd["frames"] = ENCDEC_FRAMES
    print_serving("encdec ", pd)
    fault = encdec_decode_fault(model, params,
                                {"tokens": prompts, "frames": frames})
    print(f"encdec decode gate ({ENCDEC_DECODE_TOL}) against the plain run "
          f"on its tokens: sound kernels max abs err "
          f"{max(fault['sound']['max_abs_err_by_step'])}, B6 dropping one "
          f"key {max(fault['faulted']['max_abs_err_by_step'])} (fails the "
          f"gate at {len(fault['faulted']['steps_failing_gate'])} of "
          f"{DECODE_STEPS} steps)")
    print("encdec decode gate " + json.dumps(fault))
    if fault["sound"]["steps_failing_gate"]:
        raise AssertionError("encdec decode: the kernels fail the gate on "
                             "the plain run's tokens at steps "
                             f"{fault['sound']['steps_failing_gate']}")
    if not fault["faulted"]["steps_failing_gate"]:
        raise AssertionError("encdec decode: the gate passes a B6 that "
                             "drops a key")
    rows = encdec_attention_rows(model, cache, pd["launches"])
    del model, params, prompts, frames, cache
    torch.cuda.empty_cache()
    return rows, pd["launches"]


def reduced_encdec(arch):
    """``arch``'s ``reduced()`` encoder-decoder (2 + 2 layers, head dim 16)
    on the card against the same parameters on the CPU: the prefill of
    REDUCED_BATCH x (REDUCED_PROMPT frames + REDUCED_PROMPT tokens) and
    REDUCED_STEPS greedy decode steps from ``init_cache`` (f32), logits
    at PREFILL_TOL; exactly 3 B5 a decoder layer plus 1 an encoder layer
    per prefill, 2 B6 a decoder layer per step."""
    cfg = get_arch(arch).reduced().replace(remat=False)
    card, cpu = build(cfg, "cuda"), build(cfg, "cpu")
    params = cpu.init(torch.Generator().manual_seed(0), torch.float32)
    card_params = cpu.init(torch.Generator().manual_seed(0),
                           torch.float32).to("cuda")
    rng = np.random.default_rng(0)
    inputs = {"tokens": torch.from_numpy(rng.integers(
                  2, cfg.vocab, size=(REDUCED_BATCH, REDUCED_PROMPT))),
              "frames": torch.from_numpy(rng.standard_normal(
                  (REDUCED_BATCH, REDUCED_PROMPT, cfg.d_model)).astype(
                      np.float32))}
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    lg, _ = card.prefill(card_params, {k: t.cuda() for k, t in
                                       inputs.items()})
    per_prefill = _build.launch_counts()
    c = card.init_cache(REDUCED_BATCH, REDUCED_STEPS, torch.float32)
    lgs, nxt = [lg], [lg.argmax(-1)]
    for _ in range(REDUCED_STEPS):
        lg, c = card.decode_step(card_params, c, nxt[-1])
        lgs.append(lg)
        nxt.append(lg.argmax(-1))
    torch.cuda.synchronize()
    launches = _build.launch_counts()
    plg, _ = cpu.prefill(params, inputs)
    err, _ = _check_logits("reduced encdec prefill", lgs[0].cpu(), plg,
                           PREFILL_TOL)
    pc = cpu.init_cache(REDUCED_BATCH, REDUCED_STEPS, torch.float32)
    for i in range(REDUCED_STEPS):
        plg, pc = cpu.decode_step(params, pc, nxt[i].cpu())
        e, _ = _check_logits(f"reduced encdec decode step {i}",
                             lgs[i + 1].cpu(), plg, PREFILL_TOL)
        err = max(err, e)
    want = {"flash_attention": (cfg.enc_layers + 2 * cfg.dec_layers, 0),
            "decode_attention": (0, REDUCED_STEPS * 2 * cfg.dec_layers)}
    for k, (per, dec) in want.items():
        got = (per_prefill[k], launches[k] - per_prefill[k])
        if got != (per, dec):
            raise AssertionError(f"reduced {arch}: {k} launched {got[0]} "
                                 f"times in the prefill and {got[1]} in "
                                 f"{REDUCED_STEPS} decode steps, not "
                                 f"{per} and {dec}")
    return {"arch": arch, "family": cfg.family, "d_head": cfg.head_dim,
            "layers": [cfg.enc_layers, cfg.dec_layers],
            "batch": REDUCED_BATCH, "frames": REDUCED_PROMPT,
            "prompt_len": REDUCED_PROMPT, "decode_steps": REDUCED_STEPS,
            "logit_max_abs_err_vs_cpu": err,
            "launches_per_prefill": {k: per_prefill[k] for k in want},
            "decode_attention_per_step": want["decode_attention"][1]
            / REDUCED_STEPS}, launches


def reduced_train_step(arch):
    """One ``make_train_step`` step (batch 4 x 32, accumulation 2) of
    ``arch``'s ``reduced()`` config on the card against the same
    parameters and data on the CPU, at step 10 of 10 (minicpm's WSD
    schedule is then in its decay): loss and grad norm within
    REDUCED_TRAIN_TOL (f32 through 4 layers; for seamless the encoder's
    and cross-attention's B5 forward and backward run with
    ``causal=False``; jamba's grad norm, of gradients summed in bf16 for
    its bf16 optimizer state, within REDUCED_TRAIN_BF16_GNORM_TOL). Exactly
    one B5 forward and one backward a microbatch per attention call, and
    one B7 forward and one backward per mamba layer (jamba: N 16, P 8)."""
    cfg = get_arch(arch).reduced().replace(remat=False, microbatch=2)
    shape = ShapeConfig("t", 32, 4, "train")
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(2, cfg.vocab,
                                                     size=(4, 32)))}
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (4, 24, cfg.d_model)).astype(np.float32))
    runs = []
    for dev in ("cpu", "cuda"):
        model = build(cfg, dev)
        params = build(cfg, "cpu").init(torch.Generator().manual_seed(0),
                                        torch.float32).to(dev)
        params.requires_grad_(True)
        step_fn, opt_init = make_train_step(model, shape, base_lr=1e-2,
                                            warmup=1, total_steps=10)
        opt = opt_init(params)
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        _, _, loss, gn = step_fn(params, opt,
                                 {k: t.to(dev) for k, t in batch.items()},
                                 10)
        torch.cuda.synchronize()
        runs.append((float(loss), float(gn), _build.launch_counts(),
                     str(next(iter(opt.mu.values())).dtype)))
    (loss_cpu, gn_cpu, _, _), (loss, gn, launches, state) = runs
    gn_tol = (REDUCED_TRAIN_BF16_GNORM_TOL * abs(gn_cpu)
              if cfg.bf16_optimizer_state
              else REDUCED_TRAIN_TOL * (1 + abs(gn_cpu)))
    if abs(loss - loss_cpu) > REDUCED_TRAIN_TOL * (1 + abs(loss_cpu)) or \
            abs(gn - gn_cpu) > gn_tol:
        raise AssertionError(f"reduced {arch} train step: loss {loss}, grad "
                             f"norm {gn} on the card; {loss_cpu}, {gn_cpu} "
                             f"on the CPU")
    if cfg.family == "encdec":
        attn, mamba = cfg.enc_layers + 2 * cfg.dec_layers, 0
    else:
        mixers = [spec.mixer for seg in lm.build_schedule(cfg)
                  for _ in range(seg.count) for spec in seg.body]
        attn, mamba = len(mixers) - mixers.count("mamba"), \
            mixers.count("mamba")
    want = {"flash_attention": 2 * attn, "flash_attention_bwd": 2 * attn,
            "ssd_scan": 2 * mamba, "ssd_scan_bwd": 2 * mamba}
    for k, n in want.items():
        if launches[k] != n:
            raise AssertionError(f"reduced {arch} train step launched {k} "
                                 f"{launches[k]} times, not {n}")
    return {"arch": arch, "schedule": cfg.schedule, "loss": loss,
            "loss_cpu": loss_cpu, "grad_norm": gn, "grad_norm_cpu": gn_cpu,
            "optimizer_state": state,
            "launches": {k: n for k, n in want.items() if n}}


def moe_backward_repeat():
    """``moe_ffn``'s backward twice on the same inputs at moonshot's expert
    widths (one microbatch: 4,096 tokens of d_model 2,048, 64 experts of
    d_ff 1,408, top-6, f32): whether the two calls' gradients are bit-equal
    (the backward of the slot gathers is an ``index_put`` with
    accumulation, which sorts its indices on the card; reported, not
    gated), and the largest difference."""
    cfg = get_arch(MOE_ARCH)
    g = torch.Generator(device="cuda").manual_seed(9)
    p = {k: v.requires_grad_() for k, v in
         moe.moe_init(g, cfg, torch.float32, "cuda").items()}
    x = torch.randn((4, 1024, cfg.d_model), generator=g,
                    device="cuda").requires_grad_()
    dy = torch.randn(x.shape, generator=g, device="cuda")
    grads = []
    for _ in range(2):
        out = moe.moe_ffn(p, x, cfg)
        grads.append(torch.autograd.grad(out, [x] + list(p.values()), dy))
    torch.cuda.synchronize()
    names = ["x"] + list(p)
    diff = {n: float((a - b).abs().max()) for n, a, b in
            zip(names, *grads)}
    del p, x, dy, grads
    torch.cuda.empty_cache()
    return {"bit_equal": not any(diff.values()), "max_abs_diff": diff}


def dense_bf16_attention_rows(model, cache, launches_pd):
    """B5 and B6 at qwen2.5-32b's shapes, and B5 at llava-next-34b's: B5
    ``qwen`` over bf16 q (4, 1,024, 40, 128) and k, v (4, 1,024, 8, 128)
    causal (G 5: 25 positions in 125 of a block's 128 rows), B5 ``llava``
    over bf16 q (4, 1,600, 56, 128), k, v 8 heads (G 7: 18 positions in
    126 rows; timed only: no path launches this shape, as llava runs
    reduced, so its ``launches`` is null), and B6 ``qwen``: a bf16 query
    (4, 40, 128) over layer 0's prefilled bf16 cache (4, 1,536, 8, 128)
    at the path's kv_len."""
    cfg = model.cfg
    dev = model.device
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)
    g = torch.Generator(device=dev).manual_seed(7)
    B, S, Hq, Hkv, D = (SERVE_BATCH, PROMPT_LEN, cfg.n_heads, cfg.n_kv_heads,
                        cfg.head_dim)
    rnd = lambda *shape: torch.randn(shape, generator=g, device=dev).to(
        torch.bfloat16)
    Bl, Sl, Hl, Hkl = LLAVA_ROW
    specs = [
        _flash_spec("qwen", rnd(B, S, Hq, D), rnd(B, S, Hkv, D),
                    rnd(B, S, Hkv, D), True, launches_pd["flash_attention"],
                    "bf16"),
        _flash_spec("llava", rnd(Bl, Sl, Hl, D), rnd(Bl, Sl, Hkl, D),
                    rnd(Bl, Sl, Hkl, D), True, None, "bf16"),
        _decode_spec("qwen", rnd(B, Hq, D),
                     cache["segments"][0][0]["k"][0],
                     cache["segments"][0][0]["v"][0],
                     PROMPT_LEN + DECODE_STEPS,
                     launches_pd["decode_attention"]),
    ]
    return _variant_rows(specs, flush)


def dense_bf16_phase():
    """qwen2.5-32b at full width, bf16 parameters made on the card from a
    generator seeded 0 (~32.8 B, ~61 GiB: each tensor drawn and cast on
    its own, the model never held in f32): the serving path (prefill 4 x
    1,024 into a 1,536-deep bf16 cache, 32 decode steps) with the kernels
    and plain (``bf16_prefill_decode``: full-run logits and greedy tokens
    reported), the layer-by-layer gate (``bf16_layer_checks``: every layer
    on the plain run's input, outputs within DENSE_LAYER_TOL), the engine as
    ``launch.serve`` builds it (``bf16_engine_run``), and B5/B6 rows."""
    t0 = time.perf_counter()
    model = build(get_arch(DENSE_BF16_ARCH), "cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        torch.bfloat16)
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        2, model.cfg.vocab, size=(SERVE_BATCH, PROMPT_LEN))).cuda()
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    print(f"serving: {DENSE_BF16_ARCH} at full width, {n_params} parameters "
          f"(bf16, {torch.cuda.memory_allocated() / 2 ** 30:.1f} GiB on the "
          f"card) made in {time.perf_counter() - t0:.2f} s")
    pd, cache = bf16_prefill_decode(model, params, prompts, CACHE_LEN)
    print_serving("qwen ", pd)
    print(f"qwen full-run logits: max abs err "
          f"{pd['logit_max_abs_err']} from the plain "
          f"run; greedy tokens equal {pd['greedy_tokens_equal_to_plain']}/"
          f"{pd['greedy_tokens_total']} (reported, not gated: bf16 "
          f"roundings compound through 64 layers)")
    gate = bf16_layer_checks(model, params, prompts, cache)
    print(f"qwen layer gate: every layer on the plain run's input, outputs "
          f"within {gate['prefill']['layer_output_max_rel_err']:.4g} "
          f"(prefill) and {gate['decode_step']['layer_output_max_rel_err']:.4g}"
          f" (decode step) of their largest entry (tolerance "
          f"{DENSE_LAYER_TOL}); final logits within their hidden states' "
          f"bound (share {gate['prefill']['logit_max_bound_share']:.4g})")
    print("qwen layer gate " + json.dumps(gate))
    torch.cuda.empty_cache()
    _, eng = bf16_engine_run(model, params)
    print(f"qwen engine tokens/s: {eng['tokens_per_s']:.1f} ({eng['tokens']}"
          f" tokens, {eng['requests']} requests over {eng['pipelines']} "
          f"pipelines; plain versions {eng['plain_tokens_per_s']:.1f})")
    print("qwen engine " + json.dumps(eng))
    rows = dense_bf16_attention_rows(model, cache, pd["launches"])
    del model, params, cache, prompts
    torch.cuda.empty_cache()
    return rows, pd["launches"], eng["launches"]


def main() -> int:

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on a GPU",
              file=sys.stderr)
        return 2

    smi = _nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    print(smi)
    spec = hw.device_spec(0)
    print(f"torch device: {kind}, {spec.sms} SMs, {spec.mem_bytes} B memory, "
          f"{spec.l2_bytes} B L2; torch {torch.__version__}, "
          f"cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    _build.load()
    print(f"build: {time.perf_counter() - t0:.2f} s "
          f"({len(_build.sources())} sources, sm_90a) -> "
          f"{_build.library_path().relative_to(ROOT)}")
    for line in _build.build_log().splitlines():
        if "Used" in line or "spill" in line or "entry function" in line:
            print("  " + line.strip())
    ptxas = _ptxas(_build.build_log())

    t0 = time.perf_counter()
    batches = [synth_packets(batch=BATCH, num_flows=FLOWS,
                             pkt_bytes=PKT_BYTES, seed=i)
               for i in range(N_BATCHES)]
    torch.cuda.synchronize()
    print(f"traffic: {N_BATCHES} x {BATCH} packets x {PKT_BYTES} B over "
          f"{FLOWS} flows on the card in {time.perf_counter() - t0:.2f} s")

    isg, dp = drive("ISG", ipsec_gateway, batches)
    print_obs(isg)
    print("main path " + json.dumps(isg))
    for k in ("flow_lookup", "dfa_regex", "keyed_hash", "arx_cipher"):
        if isg["launches"][k] < 1:
            raise AssertionError(f"ISG main path never launched {k}")
    ids, _ = drive("ID", intrusion_detection, batches)
    print_obs(ids)
    print("main path " + json.dumps(ids))
    for k in ("flow_lookup", "dfa_regex"):
        if ids["launches"][k] < 1:
            raise AssertionError(f"ID main path never launched {k}")

    kernels = kernel_checks(dp, batches[-1], isg["launches"],
                            ids["launches"])

    # the control plane (CP2), on the first batch (seed 0) while it is on
    # the card
    t0 = time.perf_counter()
    apps_report, profiles = profile_apps(batches[0])
    control = {"apps": apps_report}
    control["cost_model"] = cost_model_checks(batches[0],
                                              control["apps"]["ISG"])
    control["sync"] = sync_checks(dp.to.flow_cache.capacity)
    control["seconds"] = time.perf_counter() - t0
    by_name = {row["name"]: row for row in kernels}
    for key, rep in control["apps"].items():
        for name, n in rep["launches"].items():
            by_name[name]["launches_by_path"][f"measure_app {key}"] = n

    # the control plane (CP3): the controller and its governor, the
    # deployments' data planes on the card while the traffic is there
    t0 = time.perf_counter()
    cp3, launches_cp3 = controller_checks(profiles, batches)
    cp3["dwrr"] = dwrr_checks()
    cp3["seconds"] = time.perf_counter() - t0
    print("controller " + json.dumps(cp3))
    for name in ("flow_lookup", "dfa_regex", "keyed_hash", "arx_cipher"):
        if launches_cp3.get(name, 0) < 1:
            raise AssertionError(f"the controller's planes never launched "
                                 f"{name}")
        by_name[name]["launches_by_path"]["controller"] = launches_cp3[name]
    del dp, batches
    torch.cuda.empty_cache()

    # the service runtime (CP4): R1 under chaos against its CPU replay, R2
    # at megaflow traffic; every tenant's plane and the DWRR tick on the card
    t0 = time.perf_counter()
    cp4 = service_checks()
    cp4["seconds"] = time.perf_counter() - t0
    print("service " + json.dumps(cp4))
    for run in ("R1", "R2"):
        for name, n in cp4[run]["launches"].items():
            by_name[name]["launches_by_path"][f"service {run}"] = n
    for name in ("flow_lookup", "dfa_regex", "keyed_hash", "arx_cipher"):
        if cp4["R1"]["launches"].get(name, 0) < 1:
            raise AssertionError(f"the service's planes never launched "
                                 f"{name}")
    torch.cuda.empty_cache()

    # LM serving: gemma3-1b at full width, f32 parameters
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    model = build(get_arch(ARCH), "cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        torch.float32)
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        2, model.cfg.vocab, size=(SERVE_BATCH, PROMPT_LEN))).cuda()
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    print(f"serving: {ARCH} at full width, {n_params} parameters (f32) made "
          f"on the card in {time.perf_counter() - t0:.2f} s")
    n_global = sum(1 for *_, layer in params.all_layers()
                   if layer.spec.mixer == "attn")
    pd, cache = prefill_decode(
        model, params, prompts, CACHE_LEN,
        {"flash_attention": (model.cfg.n_layers, 0),
         "decode_attention": (0, n_global), "ssd_scan": (0, 0)},
        PREFILL_TOL, DECODE_TOL)
    print_serving("", pd)
    engine, eng = engine_run(ARCH, PREFILL_TOL, ("decode_attention",),
                             ("flash_attention", "ssd_scan"))
    print(f"engine tokens/s: {eng['tokens_per_s']:.1f} ({eng['tokens']} "
          f"tokens, {eng['requests']} requests over {eng['pipelines']} "
          f"pipelines; plain versions {eng['plain_tokens_per_s']:.1f})")
    print("engine launches: " + json.dumps(eng["launches"]))
    print("engine " + json.dumps(eng))
    t0 = time.perf_counter()
    control["placement"] = placement_check(model, eng["latencies_s"])
    control["seconds"] += time.perf_counter() - t0
    print("control plane " + json.dumps(control))
    kernels += attention_checks(model, cache, engine, pd["launches"],
                                eng["launches"])
    del model, params, cache, engine, prompts
    torch.cuda.empty_cache()

    # LM serving: the same arch reduced (head dim 16), card against CPU
    red, red_pd, red_eng = reduced_serving(ARCH)
    print(f"reduced {ARCH} (d_head {red['d_head']}) on the card: logits "
          f"within {red['logit_max_abs_err_vs_cpu']} of the CPU run; engine "
          f"{red['engine']['requests']} requests, "
          f"{red['engine']['tokens_equal_to_cpu']}/{red['engine']['tokens']} "
          f"tokens equal to the CPU engine's")
    print("reduced serving " + json.dumps(red))
    by_name = {row["name"]: row for row in kernels}
    for name, label, row in reduced_attention_rows(ARCH, red_pd):
        by_name[name].setdefault("variants", {})[label] = row
        by_name[name]["launches_by_path"]["reduced"] = red_pd[name]
    by_name["decode_attention"]["launches_by_path"]["reduced_engine"] = (
        red_eng["decode_attention"])

    # LM serving: mamba2-370m at full width, f32 parameters
    t0 = time.perf_counter()
    model = build(get_arch(MAMBA_ARCH), "cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        torch.float32)
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        2, model.cfg.vocab, size=(SERVE_BATCH, MAMBA_PROMPT_LEN))).cuda()
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    print(f"serving: {MAMBA_ARCH} at full width, {n_params} parameters (f32) "
          f"made on the card in {time.perf_counter() - t0:.2f} s")
    mpd, _ = prefill_decode(
        model, params, prompts, MAMBA_PROMPT_LEN + DECODE_STEPS,
        {"ssd_scan": (model.cfg.n_layers, 0), "flash_attention": (0, 0),
         "decode_attention": (0, 0)},
        MAMBA_LOGIT_TOL, MAMBA_LOGIT_TOL, MAMBA_STATE_TOL)
    mpd["forward_logit_max_abs_err"] = every_position(model, params, prompts,
                                                      MAMBA_LOGIT_TOL)
    print_serving("mamba ", mpd)
    print(f"mamba forward logits at every position: max abs err "
          f"{mpd['forward_logit_max_abs_err']} from the plain run "
          f"(tolerance {MAMBA_LOGIT_TOL})")
    _, meng = engine_run(MAMBA_ARCH, MAMBA_LOGIT_TOL, (),
                         ("ssd_scan", "flash_attention", "decode_attention"))
    print(f"mamba engine tokens/s: {meng['tokens_per_s']:.1f} "
          f"({meng['tokens']} tokens, {meng['requests']} requests over "
          f"{meng['pipelines']} pipelines; plain versions "
          f"{meng['plain_tokens_per_s']:.1f})")
    print("mamba engine launches: " + json.dumps(meng["launches"]))
    print("mamba engine " + json.dumps(meng))
    kernels += ssd_checks(model, params, prompts, mpd["launches"],
                          meng["launches"])
    del model, params, prompts
    torch.cuda.empty_cache()

    # training: olmo-1b at full width, kernels against plain
    t0 = time.perf_counter()
    tr, launches_train = training_phase(
        TRAIN_ARCH, ("flash_attention", "flash_attention_bwd"))
    torch.cuda.empty_cache()
    print_training("", tr, time.perf_counter() - t0)
    res = crash_resume()
    tr["crash_resume_reduced"] = res
    print(f"train crash/resume (reduced, on the card): crashed at step "
          f"{res['crashed_at']}, resumed, {res['leaves']} leaves at step "
          f"{res['steps']} bit-equal to the uninterrupted run")
    print("train " + json.dumps(tr))
    fwd_row, bwd_row = train_attention_rows(launches_train)
    by_name = {row["name"]: row for row in kernels}
    by_name["flash_attention"].setdefault("variants", {})["train"] = fwd_row
    by_name["flash_attention"]["launches_by_path"]["train"] = (
        launches_train["flash_attention"])
    kernels.append(bwd_row)
    torch.cuda.empty_cache()

    # training: mamba2-370m at full width, B7 and its backward
    t0 = time.perf_counter()
    mtr, launches_mtrain = training_phase(
        MAMBA_ARCH, ("ssd_scan", "ssd_scan_bwd"), resync=TRAIN_RESYNC,
        calibrate=TRAIN_CALIBRATE)
    torch.cuda.empty_cache()
    print_training("mamba ", mtr, time.perf_counter() - t0)
    if "free_plain_loss" in mtr:
        print(f"mamba train plain run left to run free (not gated): loss "
              f"{mtr['free_plain_loss']}, grad norm "
              f"{mtr['free_plain_grad_norm']}, grad norm off the kernel "
              f"run's by {mtr['free_grad_norm_rel_diff']} (relative)")
    print("mamba train " + json.dumps(mtr))
    model = build(get_arch(MAMBA_ARCH), "cuda")
    toks = torch.from_numpy(SyntheticLMDataset(
        vocab=model.cfg.vocab, seq_len=TRAIN_SEQ + 1).batch(
            1, TRAIN_BATCH)["tokens"][:TRAIN_BATCH // 2, :TRAIN_SEQ]).long()
    kernels.append(train_ssd_rows(model, toks.cuda(), launches_mtrain))
    by_name["ssd_scan"]["launches_by_path"]["train"] = (
        launches_mtrain["ssd_scan"])
    del model, toks
    torch.cuda.empty_cache()

    # training: moonshot-v1-16b-a3b at full width, depth cut
    t0 = time.perf_counter()
    otr, launches_otrain = training_phase(
        MOE_ARCH, ("flash_attention", "flash_attention_bwd"),
        resync=TRAIN_RESYNC, calibrate=MOE_TRAIN_CALIBRATE,
        layers=MOE_TRAIN_LAYERS, fault=True)
    torch.cuda.empty_cache()
    print_training("moe ", otr, time.perf_counter() - t0)
    print(f"moe train plain run left to run free (not gated): loss "
          f"{otr['free_plain_loss']}, grad norm "
          f"{otr['free_plain_grad_norm']}, grad norm off the kernel run's "
          f"by {otr['free_grad_norm_rel_diff']} (relative); tokens routed "
          f"otherwise than in the kernel run, by call "
          f"{otr['routes']['free_run_flips_per_call']}")
    rep = moe_backward_repeat()
    otr["moe_backward_repeat"] = rep
    print(f"moe backward twice on the same inputs (moonshot's experts, one "
          f"microbatch): bit-equal {rep['bit_equal']}, largest difference "
          f"{json.dumps(rep['max_abs_diff'])}")
    print("moe train " + json.dumps(otr))
    by_name = {row["name"]: row for row in kernels}
    for name in ("flash_attention", "flash_attention_bwd"):
        by_name[name]["launches_by_path"]["moonshot_train"] = (
            launches_otrain[name])

    # MoE serving: moonshot-v1-16b-a3b at full width, bf16 parameters
    moe_rows, moe_pd, moe_eng = moe_phase()
    for name, label, row in moe_rows:
        by_name[name].setdefault("variants", {})[label] = row
    by_name["flash_attention"]["launches_by_path"]["moonshot"] = (
        moe_pd["flash_attention"])
    by_name["decode_attention"]["launches_by_path"]["moonshot"] = (
        moe_pd["decode_attention"])
    by_name["decode_attention"]["launches_by_path"]["moonshot_engine"] = (
        moe_eng["decode_attention"])

    # the MoE and hybrid families reduced, card against CPU
    for arch in REDUCED_MOE_ARCHS:
        red, red_pd, red_eng = reduced_serving(arch)
        print(f"reduced {arch} ({red['family']}, d_head {red['d_head']}) on "
              f"the card: logits within {red['logit_max_abs_err_vs_cpu']} of "
              f"the CPU run; launches per prefill "
              f"{json.dumps(red['launches_per_prefill'])}; engine "
              f"{red['engine']['tokens_equal_to_cpu']}/"
              f"{red['engine']['tokens']} tokens equal to the CPU engine's")
        print("reduced serving " + json.dumps(red))
        for name in ("flash_attention", "decode_attention", "ssd_scan"):
            if red_pd[name] or red_eng[name]:
                paths = by_name[name]["launches_by_path"]
                paths[f"reduced {arch}"] = red_pd[name]
                paths[f"reduced {arch} engine"] = red_eng[name]

    # the encoder-decoder family: seamless-m4t-medium at full width, f32
    by_name = {row["name"]: row for row in kernels}
    ed_rows, ed_launches = encdec_phase()
    for name, label, row in ed_rows:
        by_name[name].setdefault("variants", {})[label] = row
    for name in ("flash_attention", "decode_attention"):
        by_name[name]["launches_by_path"]["seamless"] = ed_launches[name]

    # the remaining configs reduced, card against CPU; train steps
    for arch in REDUCED_A21_ARCHS:
        red, red_pd, red_eng = reduced_serving(arch)
        print(f"reduced {arch} ({red['family']}, d_head {red['d_head']}) on "
              f"the card: logits within {red['logit_max_abs_err_vs_cpu']} of "
              f"the CPU run; launches per prefill "
              f"{json.dumps(red['launches_per_prefill'])}; engine "
              f"{red['engine']['tokens_equal_to_cpu']}/"
              f"{red['engine']['tokens']} tokens equal to the CPU engine's")
        print("reduced serving " + json.dumps(red))
        for name in ("flash_attention", "decode_attention"):
            paths = by_name[name]["launches_by_path"]
            paths[f"reduced {arch}"] = red_pd[name]
            paths[f"reduced {arch} engine"] = red_eng[name]
    red, red_l = reduced_encdec(ENCDEC_ARCH)
    print(f"reduced {ENCDEC_ARCH} (encdec, d_head {red['d_head']}) on the "
          f"card: logits within {red['logit_max_abs_err_vs_cpu']} of the CPU "
          f"run; launches per prefill "
          f"{json.dumps(red['launches_per_prefill'])}, B6 per decode step "
          f"{red['decode_attention_per_step']}")
    print("reduced serving " + json.dumps(red))
    for name in ("flash_attention", "decode_attention"):
        by_name[name]["launches_by_path"][f"reduced {ENCDEC_ARCH}"] = (
            red_l[name])
    for arch in REDUCED_TRAIN_ARCHS:
        rt = reduced_train_step(arch)
        print(f"reduced {arch} train step on the card ({rt['schedule']}, "
              f"optimizer state {rt['optimizer_state']}): loss {rt['loss']} "
              f"(CPU {rt['loss_cpu']}), grad norm {rt['grad_norm']} (CPU "
              f"{rt['grad_norm_cpu']}); launches "
              f"{json.dumps(rt['launches'])}")
        print("reduced train " + json.dumps(rt))
        for name, n in rt["launches"].items():
            by_name[name]["launches_by_path"][f"reduced {arch} train"] = n

    # qwen2.5-32b at full width, bf16 parameters (llava's B5 row beside it)
    q_rows, q_pd, q_eng = dense_bf16_phase()
    for name, label, row in q_rows:
        by_name[name].setdefault("variants", {})[label] = row
    for name in ("flash_attention", "decode_attention"):
        by_name[name]["launches_by_path"]["qwen"] = q_pd[name]
    by_name["decode_attention"]["launches_by_path"]["qwen_engine"] = (
        q_eng["decode_attention"])

    for row in kernels:
        row["ptxas"] = _ptxas_of(ptxas, row["name"])
        _with_bound_share(row)
        for r in [row] + list(row.get("variants", {}).values()):
            if r["bound_share"] > 1:
                raise AssertionError(f"{row['name']} ({r.get('variant')}): "
                                     f"{r['ms']} ms is under its bound "
                                     f"{r['bound_ms']} ms")
    for name in ("flash_attention", "flash_attention_bwd", "ssd_scan",
                 "ssd_scan_bwd", "dfa_regex", "decode_attention",
                 "arx_cipher", "keyed_hash", "flow_lookup"):
        spills = {fn: v for fn, v in _ptxas_of(ptxas, name).items()
                  if v.get("spill_stores") or v.get("spill_loads")}
        if spills:
            raise AssertionError(f"{name} spills registers: {spills}")
    # the least time any launch takes, timed as the kernels are
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    floor_ms = _time_ms(lambda: _build.launch_floor(torch.device("cuda")),
                        KERNEL_REPS, flush)
    print(json.dumps({"kernels": kernels, "launch_floor_ms": floor_ms}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
