"""Smoke run of the PyTorch + CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/csrc/`` (nvcc,
sm_90a), holds each against its plain PyTorch version on the card at its
path's shapes, reproduces the committed golden selections on the card, and
drives the port's two paths:

- the synchronous ACSP-FL round (DLD layer sharing, int8 uplink with error
  feedback, masked-partial aggregation) on the UCI-HAR stand-in at the
  paper's full har-mlp width, through ``repro_torch.fl.run_federated``,
  round by round and then in fused chunks of rounds (CUDA-graph replays,
  which must give the same history bit for bit), with a cohort of 10 of the
  30 clients and with evaluation every second round;
- the host-resident population plane and two-level edge aggregation
  (``[population]``): the UCI-HAR int8 path with ``host_population=1``
  bitwise the device-resident run (sync and async), ``edge_groups`` 1 and
  3 through masked_aggregate's edge mode, streamed evaluation; the lazy
  million-client tier's configuration at C = 5,000 and 50,000 (peak device
  memory held to 1.25x); memmap-backed trees bitwise the RAM-backed ones;
- sharded cohort rounds over ``torch.distributed`` (``[shard]``):
  masked_aggregate's partial and combine modes at har-mlp's 8 leaves and
  K = 30 for D = 1, 2, 3 (bitwise their plain versions and the edge mode
  with rank-block ids); the UCI-HAR int8 path with ``cohort_devices=1`` on
  a world-1 NCCL group, bitwise the unsharded run at scan_chunk 1 and 5
  (the all-reduces captured in the CUDA graph), with its collective bytes
  read from a torch.profiler trace; worlds 2 and 3 as gloo processes
  sharing the card, bitwise the unsharded run, the 8-client fixture equal
  to the same worlds on the CPU, every rank's final model bitwise equal,
  round 0's reduction bitwise the edge mode; and the committed goldens at
  world 2;
- run records (``[obs]``): the int8 main path recorded through
  ``run_federated(recorder=RunRecorder(...))`` at scan_chunk 1 and 5 and
  the async scheduler, trace and profile on, each bitwise its unrecorded
  run with the same kernel launches;
- personalized serving (``[classify]``): ``fit_servable`` (none, ft, and
  dld with int8) on the UCI-HAR stand-in, a save/load round trip, the
  engine's per-lane bit identity on the card, the card against the CPU,
  and every test row of the 30 clients served as one request each through
  ``ClassifyProgram`` and ``ContinuousBatcher`` with a ``ServeRecorder``;
- LM serving at full width and full depth, falcon-mamba-7b, granite-3-8b,
  the dense GQA models chatglm3-6b (half RoPE; flash_attention at G = 16),
  stablelm-12b (flash_attention at head dim 160) and qwen2-vl-2b (M-RoPE and
  the vision stub, 1,024 vision and 1,024 text tokens a prompt, served in
  waves; G = 6), and the MoE family: deepseek-moe-16b, deepseek-v2-lite-16b
  (MLA, whose prefill runs flash_attention at q/k head dim 192 and v head
  dim 128) and moonshot-v1-16b-a3b with its depth cut to 4 layers, the
  hybrid jamba-v0.1-52b (Mamba-1 layers, one GQA layer and MoE or dense
  FFNs) with its depth cut to one period of 8 layers, and the
  encoder-decoder whisper-tiny (1,500 audio frames a request, 448 decoder
  tokens; flash_attention non-causal in its encoder and from the decoder's
  queries over the frames, T != S, at every decode step too), served in
  waves (8 requests, batch 4, prompts of 2048 tokens, up to 32 new tokens,
  random weights from seed 0), through ``repro_torch.launch.serve.serve``,
  each run checked to launch exactly its arch's kernels, after the port's reduced
  models on the card are held to the same models on the CPU, and a
  recorded serving session of the reduced granite-3-8b (``serve(...,
  record=dir)``); the MoE layer's time at the prefill shape, split into
  routing, dispatch, experts and combine, and the share of routes dropped
  at prefill and at decode;
- LM training (``[train_kernels]``, ``[train]``): the two backward
  kernels, flash_attention_bwd (bf16 on wgmma: granite-3-8b's layer,
  whisper-tiny's encoder and cross-attention, one launch each at (192,
  128) and (160, 160)) and ssm_scan_bwd (falcon-mamba-7b's layer, whole and ragged
  chunks), each held to its contract against the backward in float64 on
  the forward kernel's own lse or chunk states, with its controls, two
  calls bitwise, timed beside its bound, its float32 plain version and
  (attention) SDPA's fused backward; the ten reduced configs' loss and
  gradients on the card against the CPU; then full-width training through
  ``repro_torch.launch.train.train`` (the CLI's optimizer, a fresh batch a
  step, bf16, batch 4 of 2048 tokens): granite-3-8b and falcon-mamba-7b
  cut to 8 layers, whisper-tiny whole (448 tokens over 1,500 frames), with
  exactly the forward, recompute and backward launches the code implies,
  finite losses, step ms, tok/s and peak memory;
- cross-silo FL of the LMs (``[cross_silo]``, ``repro_torch.fl.cross_silo``):
  4 silos of one 2048-token row each (whisper: 448 tokens over 1,500
  frames), weights [1, 2, 1, 1], 3 rounds of a local AdamW step a silo and
  the weighted mean of the shared prefix (``embed`` and the first 2 layer
  periods; whisper ``embed`` and its encoder) through masked_aggregate,
  after quantize/dequantize on the int wires: granite-3-8b cut to 4 layers
  on the fp32 wire and on int8 with error feedback, falcon-mamba-7b cut to
  4 layers on int8, whisper-tiny whole on fp32, bf16 and int4; shared leaves
  bitwise equal across silos after every round, personal ones apart,
  exactly the launches the code implies, round 1's mean of granite's embed
  rows bitwise masked_aggregate's plain version; round ms split into the
  local steps and the aggregation, tok/s, wire bytes a silo a round by
  format, peak memory; masked_aggregate timed at those embed rows.

- the expert-parallel MoE over a (data, model) mesh of ranks (``[ep]``,
  ``launch/context.mesh_context``, ``layers.moe_apply_ep``): the reduced
  MoE family and jamba under a (1, 1) mesh on the card against the CPU,
  jamba-v0.1-52b at full width and 8 layers in float32 under (1, 1)
  against the same model without a mesh, and on a (1, 2) mesh of two gloo
  processes sharing the card against the (1, 1) run;
- tensor parallelism for serving (``[tp]``, ``launch/tp.py``): the
  reduced bf16 granite-3-8b, falcon-mamba-7b and jamba-v0.1-52b under a
  (1, 1) mesh bitwise the run without one; on a (1, 2) mesh of two gloo
  processes sharing the card, those and granite-3-8b and falcon-mamba-7b
  at full width cut to 4 layers (flash_attention and ssm_scan at the
  ranks' halves of the heads and of d_inner) within 2^-5 of max of the run
  without a mesh, both ranks bitwise equal; the kernels are also held to
  their plain versions at the shapes a rank of four gives them;
- training under that mesh (``[train_mesh]``, ``launch/zero.py``'s 2-D
  blocks, ``launch/tp.py``'s collectives under autograd, ``moe_apply_ep``'s
  backward, ``transformer.lm_objective``, ``whisper.whisper_objective``):
  the reduced float32 granite-3-8b, deepseek-moe-16b and falcon-mamba-7b,
  3 steps under a (1, 1) mesh bitwise the run without one, and on (2, 1)
  and (1, 2) (tensor-parallel; granite there once more under
  ``seq_parallel``), jamba-v0.1-52b and deepseek-v2-lite-16b
  on (1, 2) and whisper-tiny on (2, 1), as two gloo processes sharing the
  card against the rule of JAX's sharded step computed without a mesh;
  the two backward kernels are also held to their plain versions at the
  shapes a tensor-parallel rank gives them;
- the three configurations the port once refused: attention masked by
  M-RoPE's t stream (``[kernels]``: both attention kernels and their
  backwards at qwen2-vl-2b's shape on an image-first stream, 1,024 image
  tokens at t = 0, against their plain versions, ``arange`` positions
  bitwise the index mask, timed beside the index-masked call, the bound
  of the pairs the positions leave and SDPA with the same boolean mask;
  ``[lm]``: the reduced qwen2-vl on such a stream card = CPU; ``[serve]``:
  qwen2-vl-2b served on image streams), a Mamba prefill continuing a
  carried cache (``[kernels]``: ssm_scan from a start state h0 at
  falcon-mamba-7b's d_inner and a rank's; ``[lm]``: the reduced
  falcon-mamba and jamba, two prefills and 2 decode steps, card = CPU;
  ``[serve]``: falcon-mamba-7b's 2 x 1,024 chunked prefill then 32 tokens
  against one 2,048 prefill) and tied embeddings (``[lm]``: the reduced
  granite-3-8b tied, prefill, decode and 2 train steps card = CPU);
- the dry run (``[dryrun]``, ``launch/dryrun.py``, last): traced in a
  process of its own that sees no card, during the build, and read
  before any phase is timed: granite-3-8b's four production shapes on the 16 x 16 mesh
  and on (4, 1), (2, 2) and (1, 4), rank 0, one line each (GiB a rank,
  fits in 80 GB or not, collective MB by kind); then on the card what it
  predicts fits one: granite-3-8b prefill_32k and long_500k (4 decode
  steps on the 8,192-key ring) and falcon-mamba-7b prefill_32k at batch
  1, granite-3-8b train_4k at 8 layers and batch 1, each with its
  predicted peak within 10% of ``torch.cuda.max_memory_allocated`` and
  its predicted launches equal to the counters (prefill_32k at batch 32
  does not fit and is not run); and flash_attention at S = 32,768 held to
  its bf16 contract on one kv head's query heads.

On a machine with several cards, ``torchrun --standalone --nproc-per-node
D chip_smoke.py --nccl-world`` runs only the sharded path over D NCCL
ranks (``nccl_world_main``), and ``torchrun --standalone --nproc-per-node
4 chip_smoke.py --ep-world`` serves jamba-v0.1-52b whole on a (1, 4) mesh,
moonshot-v1-16b-a3b whole on (1, 4) and (2, 2), and granite-3-8b and
falcon-mamba-7b whole on (1, 4), tensor-parallel (``ep_world_main``),
and ``... --train-world`` trains granite-3-8b whole on (4, 1), (2, 2)
and (1, 4) (on (2, 2) and (1, 4) also under ``seq_parallel``, the
sequence-parallel layout, each beside the same mesh without it),
deepseek-moe-16b whole on (2, 2) and falcon-mamba-7b whole on
(2, 2), tensor-parallel where the model axis is over 1, after holding
4-layer float32 versions to the same weights without a mesh, then runs
the cross-silo round over a (4, 1) mesh against the single-process round
(``train_world_main``, ``cross_silo_world``); both print the dry run's
prediction for each case beside its measured peak a rank;
``--shard-worker``, ``--ep-worker``, ``--tp-worker`` and
``--train-mesh-worker`` are one rank of the gloo worlds the single-card run
starts itself.

Every phase prints its lines; the kernel table is one JSON line; the last
line is ``{"ok": true, "device": ...}``. Any failed check exits non-zero
before that line. Needs a CUDA card and the repository's ``src/`` beside
this file; imports neither jax nor the JAX package.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import datetime
import gc
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch import kernels  # noqa: E402
from repro_torch import random as prng  # noqa: E402
from repro_torch.comm import QuantizeCodec  # noqa: E402
from repro_torch.comm import codec as comm_codec  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import (  # noqa: E402
    make_federated_classification,
    make_har_dataset,
    make_sharded_population,
)
from repro_torch.device import full_precision_matmuls  # noqa: E402
from repro_torch.fl import FLConfig, pipeline_from_config, run_federated  # noqa: E402
from repro_torch.fl.faults import compile_fault_plan  # noqa: E402
from repro_torch.fl.population import run_host_sync  # noqa: E402
from repro_torch.fl import api as fl_api  # noqa: E402
from repro_torch.fl import cross_silo  # noqa: E402
from repro_torch.fl.phases import Aggregator, MaskedPartialAggregator  # noqa: E402
from repro_torch.fl.sched import _setup_run, initial_state  # noqa: E402
from repro_torch.fl.shard import shard_collective_bytes  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain  # noqa: E402
from repro_torch.kernels.flash_attention.contract import (  # noqa: E402
    MAX_OVER_SHARE,
    bf16_contract,
)
from repro_torch.kernels.masked_aggregate import (  # noqa: E402
    masked_aggregate,
    masked_aggregate_combine,
    masked_aggregate_combine_plain,
    masked_aggregate_leaves,
    masked_aggregate_leaves_plain,
    masked_aggregate_partial,
    masked_aggregate_partial_plain,
    masked_aggregate_plain,
    partial_layout,
)
from repro_torch.kernels.quantize import (  # noqa: E402
    dequantize,
    dequantize_leaves,
    dequantize_leaves_plain,
    quant_blocks,
    quantize,
    quantize_leaves,
    quantize_leaves_plain,
)
from repro_torch.kernels.ssm_scan import contract as ssm_contract  # noqa: E402
from repro_torch.kernels.ssm_scan import ssm_scan, ssm_scan_plain  # noqa: E402
from repro_torch.launch import context as mesh_ctx  # noqa: E402
from repro_torch.launch.collectives import collective_bytes  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import HW, make_rank_mesh  # noqa: E402
from repro_torch.launch.profile import profile_async_events, profile_train_step  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.launch.ssm_bwd_ab import shapes as ssm_bwd_shapes  # noqa: E402
from repro_torch.models import layers, transformer  # noqa: E402
from repro_torch.models.mlp import mlp_accuracy, mlp_apply, mlp_loss  # noqa: E402
from repro_torch.models.api import get_model, make_batch_specs, make_concrete_batch  # noqa: E402
from repro_torch.obs import RunRecorder, validate_trace_file  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    ClassifyProgram,
    ContinuousBatcher,
    PersonalizedEngine,
    ServeRecorder,
    ServeRequest,
    fit_servable,
    latency_stats,
    load_servable,
    save_servable,
)
from repro_torch.serve.engine import LANES  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
from repro_torch.weights import servable_from_numpy  # noqa: E402

# H100 SXM published peaks (launch.mesh.HW, the NVIDIA data sheet at 700 W):
# HBM3 rate, fp32 (non-tensor-core) rate, and the dense bf16 tensor-core rate
HBM_BYTES_PER_S = HW["hbm_bw"]
FP32_FLOPS = HW["peak_flops_fp32"]
BF16_FLOPS = HW["peak_flops_bf16"]
# its 132 SMs reach the fp32 rate with 128 FMA lanes each at this clock
# (1.98 GHz); the special-function unit (MUFU: ex2) gives 16 results a clock
# an SM, the FP32 pipe 128 instructions
SM_COUNT = 132
SM_CLOCK_HZ = FP32_FLOPS / (2 * 128 * SM_COUNT)
SFU_PER_S = 16 * SM_COUNT * SM_CLOCK_HZ
FP32_INSTR_PER_S = 128 * SM_COUNT * SM_CLOCK_HZ

K = 30                        # UCI-HAR clients: every lane of the dense cohort
HAR_MLP = (561, 256, 256, 256, 6)
# leaves of one har-mlp round in tree order (each layer's 'b' then 'w')
LEAVES = [s for i, o in zip(HAR_MLP[:-1], HAR_MLP[1:]) for s in ((o,), (i, o))]

# tests/test_fl_api.py: the small_ds fixture and the committed goldens
# (drawn from jax's legacy threefry stream)
SMALL_DS = dict(n_clients=8, n_classes=4, n_features=20, samples_per_client_range=(60, 90),
                dirichlet_alpha=50.0, client_shift=0.05, class_sep=5.0, seed=1)
GOLDEN = {
    "acsp-fl+dld+float32": (dict(), "9022033f6842293f97df533f117e613f428a6e3f",
                            ["11111111", "11110100", "10001100", "01000101", "00111100"]),
    "fedavg+none+float32": (dict(strategy="fedavg", personalization="none", fraction=1.0),
                            "9022033ff082713f38cb733f38cb733f38cb733f", ["11111111"] * 5),
    "oort+ft+float32": (dict(strategy="oort", personalization="ft", fraction=0.5),
                        "dab4073f08bf6c3f38cb6d3f38cb753fd264773f",
                        ["11111111", "10010110", "10010101", "01010101", "10010101"]),
    "acsp-fl+dld+int8": (dict(codec="int8"), "9022033f6842293f97df533f117e613f428a6e3f",
                         ["11111111", "11110100", "10001100", "01000101", "00111100"]),
}

FL_KERNELS = ("quantize", "dequantize", "masked_aggregate")
# [loop]: the chunk sizes held to scan_chunk=1 over 5 rounds (3: a chunk of
# 3 and a 2-round tail), and the longer runs that time the rounds
LOOP_CHUNKS = (1, 2, 5, 3)
LOOP_TIMED = dict(rounds=20, chunks=(1, 2, 5))

# [async]: the FedBuff scheduler at the paper's width (M = C = 30 slots)
ASYNC_CFG = dict(codec="int8", epochs=2, scheduler="async", buffer_k=15, max_concurrency=0,
                 heterogeneity=0.5, staleness_fn="polynomial")
ASYNC_EVENTS = 20
# tests/test_sched.py's async fixture: 8 clients, buffer_k 2, 4 slots
SMALL_ASYNC = dict(codec="int8", scheduler="async", buffer_k=2, max_concurrency=4)
# [faults]: every fault kind at once (the deadline cuts the slowed clients
# and the slowest of the 0.03-0.7 s UCI-HAR dispatches)
FAULTS = dict(dropout_rate=0.2, deadline_s=0.4, corrupt_rate=0.2, heterogeneity=0.5)
FAULTS_SLOW = 0.2  # slow_rate (a FaultConfig field with no flat FLConfig kwarg)
# the small fixture's faults without corruption, sized to its dispatch times
# (tests/test_torch_faults.py's deadline cases): the card against the CPU
SMALL_FAULT_MODES = {"sync": dict(strategy="fedavg", personalization="none", fraction=1.0,
                                  codec="int8", heterogeneity=1.0),
                     "async": dict(SMALL_ASYNC, heterogeneity=1.0)}
SMALL_FAULTS = {"sync": dict(dropout_rate=0.2, deadline_s=0.05),
                "async": dict(dropout_rate=0.4, deadline_s=5.0, max_retries=2)}
SMALL_FAULTS_SLOW = 0.3
# ... and with corruption too, under an update-norm ceiling that rejects the
# scaled kind cleanly; a NaN/Inf kind still poisons the merge (NaN * 0, as
# in the reference; ROADMAP queue 3). Async lands 2 of 4 slots an event, so
# it takes a higher rate to corrupt a landing before the poisoning one.
SMALL_CORRUPT = {"sync": FAULTS, "async": dict(FAULTS, corrupt_rate=0.5)}
SMALL_MAX_NORM = 10.0
# the card against the port on the CPU: these records exactly, accuracy
# within 1e-6 (PERF.md section 2)
EXACT_FIELDS = ("selected", "pms", "tx_params", "tx_wire_bytes", "round_time", "sim_clock",
                "staleness_mean", "in_flight", "rejected_updates")

# [kernels]/[merge] edge mode: cohorts of K clients drawn unsorted from a
# population of EDGE_POP_PER_LANE * K, cut into E contiguous edge groups
EDGE_KS = (30, 64)
EDGE_ES = (1, 3, 8)
EDGE_POP_PER_LANE = 3
# [population]: (a) the UCI-HAR main path on the host plane; (b) the
# million-client tier's configuration (the JAX package's
# benchmarks/pop_bench.py: lazy population, 5 classes, 20 features, 24-32
# samples a client), har-mlp at width 256, FedAvg, K = 64, 8 edge groups,
# 1,024-client evaluation windows, evaluated at round 0 only; (c) its
# memmap-backed trees at C = 2,000 under acsp-fl + dld + int8
POP_SIZES = (5_000, 50_000)
POP_DATA = dict(n_classes=5, n_features=20, samples_per_client_range=(24, 32),
                dirichlet_alpha=50.0, seed=0)
POP_RUN = dict(strategy="fedavg", personalization="none", epochs=1, rounds=3, eval_every=3,
               cohort_size=64, edge_groups=8, eval_chunk=1024, seed=0)
POP_PEAK_RATIO = 1.25  # peak device memory at the larger C over the smaller's
MEMMAP_C = 2_000
MEMMAP_RUN = dict(codec="int8", epochs=1, rounds=3, cohort_size=64, host_population=1, seed=0)

# [shard]: the partial and combine modes at these rank counts (K = 30 lanes
# in rank blocks); the [loop] configuration with cohort_devices=1 on a
# world-1 NCCL group, 10 rounds at scan_chunk 1 and 5 (the second chunk of
# 5 a replay); the same configuration, 5 rounds at scan_chunk 1, over gloo
# worlds of 2 and 3 processes sharing the card and on the CPU; the goldens
# at world 2
SHARD_KERNEL_WORLDS = (1, 2, 3)
SHARD_NCCL = dict(codec="int8", rounds=10, epochs=2)
SHARD_NCCL_CHUNKS = (1, 5)
SHARD_GLOO = dict(codec="int8", rounds=5, epochs=2)
SHARD_GLOO_WORLDS = (2, 3)
SHARD_GOLDEN_WORLD = 2
# the card against the CPU where the port holds them equal (the 8-client
# fixture; UCI-HAR's GEMMs already differ in their last bits unsharded):
# K = 6 lanes, so that 2 and 3 ranks divide them
SHARD_SMALL = dict(codec="int8", rounds=5, epochs=1, cohort_size=6)
SHARD_TIMEOUT_S = 420

# --nccl-world (under torchrun --nproc-per-node D, one card a rank): the
# [loop] configuration with a cohort of 28 lanes (a multiple of 2 and 4),
# sharded over the D ranks on NCCL at scan_chunk 1 and 5, against the same
# cohort unsharded on each rank's own card; the goldens at world D
NCCL_WORLD = dict(codec="int8", rounds=10, epochs=2, cohort_size=28)
NCCL_WORLD_CHUNKS = (1, 5)

# [obs]: the int8 main path recorded at these chunk sizes, and async
OBS_ROUNDS = 20
OBS_CHUNKS = (1, 5)
OBS_EVENTS = 20
# [classify]: fit_servable per mode (the codec: dld rides the int8 kernels),
# the batch sizes held to forward_unbatched lane for lane, the batcher's
# batch sizes, and the card against the CPU on the same artifact: logits
# within 1e-5 of max|logit| (the GEMMs sum in another order), predictions
# equal
CLASSIFY_MODES = (("none", "float32"), ("ft", "float32"), ("dld", "int8"))
CLASSIFY_ROUNDS = 5
LANE_BATCHES = (1, 5, 30)
SERVE_BATCHES = (1, 8, 32)
CLASSIFY_REL = 1e-5

# LM serving at full width and depth (expected_launches says which kernels
# each arch's prefill and decode steps run)
SERVE_ARCHS = ("falcon-mamba-7b", "granite-3-8b", "chatglm3-6b", "stablelm-12b", "qwen2-vl-2b",
               "deepseek-moe-16b", "deepseek-v2-lite-16b", "moonshot-v1-16b-a3b",
               "jamba-v0.1-52b", "whisper-tiny")
# depth cuts of the serving run: moonshot at full width with 4 of its 48
# layers (1 dense + 3 MoE); at full depth it is 28.4 B parameters (~57 GB
# in bf16) plus ~8 GB of prefill logits at its vocabulary of 163,840.
# jamba at full width with one period of its 32 layers, 8 (7 Mamba + the
# attention layer at index 4; MoE on the odd ones): 13.3 B parameters, 26.6
# GB in bf16; at full depth it is 51.6 B (~103 GB), over one card's 80 GB
SERVE_LAYERS = {"moonshot-v1-16b-a3b": 4, "jamba-v0.1-52b": 8}
SERVE_RUN = dict(requests=8, batch=4, prompt_len=2048, max_new=32, window=0, temperature=0.0,
                 seed=0)
# flash_attention against its plain version: float32 results within 1e-5 of
# the reference's max magnitude; a bf16 result is held to
# kernels/flash_attention/contract.py (P is rounded to bf16, and the
# kernel's scores, summed in another order than the plain version's matmul,
# round a few P elements the other way). ssm_scan is held to
# kernels/ssm_scan/contract.py: against the plain version in float64.
LM_REL = 1e-5
# the reduced models on the card against the same models on the CPU:
# logits within 1e-5 of max|logits|, 2^-8 after a Mamba scan (one bf16
# rounding flip of a scan input; tests/test_torch_lm.py)
# [train]: full-width training through launch.train (depth cut where
# given; 0 keeps the whole model), the CLI's optimizer
TRAIN_LAYERS = {"granite-3-8b": 8, "falcon-mamba-7b": 8, "whisper-tiny": 0}
TRAIN_RUN = dict(batch=4, seq=2048, steps=4, lr=3e-4, seed=0)
REDUCED_REL = {"granite-3-8b": 1e-5, "falcon-mamba-7b": 2.0 ** -8, "deepseek-moe-16b": 1e-5,
               "moonshot-v1-16b-a3b": 1e-5, "deepseek-v2-lite-16b": 1e-5, "chatglm3-6b": 1e-5,
               "stablelm-12b": 1e-5, "qwen2-vl-2b": 1e-5, "jamba-v0.1-52b": 2.0 ** -8,
               "whisper-tiny": 1e-5}


# [ep] and --ep-world: the expert-parallel MoE over a (data, model) mesh of
# ranks (launch/context.py, models/layers.moe_apply_ep). [ep] on the one
# card: the reduced MoE family and jamba under a (1, 1) mesh, card against
# CPU (REDUCED_REL); jamba at full width and SERVE_LAYERS' depth in float32
# under (1, 1) against the same model without a mesh, and on (1, 2) as two
# gloo processes sharing the card against the (1, 1) run, prefill and
# EP_DECODE_STEPS decode steps, within EP_REL of max (behind its Mamba
# scans). Float32, because in bf16 the two MoE paths differ by design:
# moe_apply_local rounds the gated expert outputs and their sum to bf16
# where moe_apply_ep sums in float32 (JAX's two paths do the same), and at
# decode's capacity of 1 such a rounding flips a near-tie route (a bf16
# run: logits 0.014, 0.186, 0.012 of max apart). --ep-world, one rank of
# four under torchrun with NCCL: first moonshot at EP_CHECK_LAYERS layers in
# float32 on (1, 4) and (2, 2), SERVE_RUN's batch, against the same model
# without a mesh on each rank's data shard (each data shard routes its own
# tokens): the rank's rows of the gathered logits within EP_REL of max,
# every MoE call's routed ids and kept mask equal; then SERVE_RUN (bf16) at
# full depth, jamba on (1, 4) and moonshot on (1, 4) and (2, 2)
EP_REDUCED = ("deepseek-moe-16b", "deepseek-v2-lite-16b", "moonshot-v1-16b-a3b", "jamba-v0.1-52b")
EP_DECODE_STEPS = 2
EP_REL = 2.0 ** -8
EP_GLOO_TIMEOUT_S = 240
EP_WORLD = (("jamba-v0.1-52b", (1, 4)), ("moonshot-v1-16b-a3b", (1, 4)),
            ("moonshot-v1-16b-a3b", (2, 2)), ("granite-3-8b", (1, 4)), ("falcon-mamba-7b", (1, 4)))
EP_CHECK_ARCH, EP_CHECK_LAYERS, EP_CHECK_MESHES = "moonshot-v1-16b-a3b", 4, ((1, 4), (2, 2))
# moonshot's k = 6 outputs of a token are summed in another order under EP
# (each rank its own, then the all-reduce) than without (in k order), so a
# later layer's router may see a last-bit difference and flip a near tie:
# at most this share of the routes may differ (predicted 0)
EP_ROUTE_SHARE = 2.0 ** -10


# [tp] and --ep-world's tensor-parallel checks (launch/tp.py: a served model
# on a model axis over 1 holds its model_block of every leaf, and its layers
# sum their row products' float32 partials over model). [tp] on the one
# card, the layout alone (moe_ep=False: jamba's MoE local; in bf16 the
# expert-parallel MoE sums otherwise, [ep]'s): TP_REDUCED's reduced bf16
# models under a (1, 1) mesh bitwise the run
# without one (nothing split, no row collective); then as two gloo processes
# sharing the card on (1, 2) (``--tp-worker``), those and TP_FULL's models
# at full width cut to a few layers (the kernels at the ranks' shapes: half
# the heads, half of d_inner), prefill and EP_DECODE_STEPS decode steps fed
# the no-mesh run's greedy tokens: each rank's logits within TP_BF16_REL of
# max of the run without a mesh (bf16: the row sums round once in float32
# where the no-mesh GEMM rounds its output), both ranks' bitwise equal, so
# their greedy tokens too. --ep-world: TP_CHECK's models whole on (1, 4)
# against the same weights without a mesh on each rank's card, within
# EP_REL in float32 (bf16 rounding grows with depth: at 40 layers it
# exceeds the few layers' 2^-5, for the no-mesh run against float32 too,
# and is printed), then served whole in bf16 (EP_WORLD)
TP_REDUCED = ("granite-3-8b", "falcon-mamba-7b", "jamba-v0.1-52b")
TP_FULL = (("granite-3-8b", 4), ("falcon-mamba-7b", 4))
TP_BF16_REL = 2.0 ** -5
TP_GLOO_TIMEOUT_S = 300
TP_CHECK = ("granite-3-8b", "falcon-mamba-7b")
# flash_attention and ssm_scan at a tensor-parallel rank's shapes on four
# model ranks (B 4, S 2048, bf16): name -> (H, Hkv, Dqk, Dv) of the rank's
# heads; ssm_scan at falcon-mamba's and jamba's d_inner over four
TP_ATTENTION = {"granite": (8, 2, 128, 128), "moe": (4, 4, 128, 128),
                "stablelm": (8, 2, 160, 160), "chatglm3": (8, 1, 128, 128),
                "qwen2vl": (3, 1, 128, 128), "mla": (4, 4, 192, 128)}
TP_MODEL_RANKS = 4
# a Qwen2-VL prompt that opens with one image: a 32 x 32 raster of patch
# tokens, all at t = 0 of M-RoPE's t stream, then the text from t = 32
QWEN_IMAGE = dict(n_vision=1024, grid=32)
CHUNKED_PREFILL = dict(arch="falcon-mamba-7b", chunks=2, max_new=32)


# [train_mesh] and --train-world: training under a (data, model) mesh of
# ranks (launch/zero.py's 2-D blocks: a decoder's tensor-parallel blocks on
# a model axis over 1, launch/tp.py's collectives under autograd, and of
# those the ZeRO blocks over the data axes; moe_apply_ep's backward;
# transformer.lm_objective's and whisper.whisper_objective's global loss).
# [train_mesh] on the one card: the reduced float32 TRAIN_MESH_ARCHS,
# TRAIN_MESH_RUN's steps on batches whose labels are -1 at the head of row
# r for TRAIN_MASKED[r] places, under a (1, 1) mesh against no mesh
# (bitwise), then TRAIN_MESH_CASES as two gloo processes sharing the card
# against the rule of JAX's sharded step computed without a mesh
# (``rule_train``; the unsharded step where one data rank or no MoE),
# within the training contract of tests/_torch_train.py (REDUCED_REL,
# STEP_ABS, NEAR_ZERO, SCAN_SHARE), every rank's loss equal and, on (1, 2),
# the leaves whole over model bitwise equal on both ranks. --train-world,
# one rank of four under torchrun with NCCL: TRAIN_CHECK's float32 models
# at full width cut to a few layers, on their meshes, against
# ``rule_train`` of the same weights on each rank (``train_world_check``:
# losses, every step's gradients within CHECK_GRAD_REL of max, or
# CHECK_SCAN_REL behind a Mamba scan (tests/_torch_train.py's SCAN_REL: the
# scan's bf16-rounded inputs), the parameters within ``step_bound`` of those
# gradient gaps and, where the model axis is 1, within the contract too,
# the leaves whole over model bitwise equal across the model ranks); then
# TRAIN_WORLD's bf16 models whole, TRAIN_WORLD_RUN. CHECK_GRAD_REL is ten
# times tests/_torch_train.py's F32_REL (full-width sums, split over the
# model ranks) and a twentieth of bf16's rounding (2^-9), so that a
# gradient rounded to bf16 fails. A case's last entry: the mesh context's
# seq_parallel (the sequence-parallel layout, launch/tp.py), whose
# TRAIN_WORLD cases run beside the same mesh's case without it
TRAIN_MESH_ARCHS = ("granite-3-8b", "deepseek-moe-16b", "falcon-mamba-7b")
TRAIN_MESH_RUN = dict(batch=4, seq=64, steps=3, lr=3e-4)
TRAIN_MESH_CASES = (*((arch, shape, False) for shape in ((2, 1), (1, 2))
                      for arch in TRAIN_MESH_ARCHS),
                    ("jamba-v0.1-52b", (1, 2), False), ("deepseek-v2-lite-16b", (1, 2), False),
                    ("whisper-tiny", (2, 1), False), ("granite-3-8b", (1, 2), True))
TRAIN_MASKED = (5, 0, 11, 2, 0, 7, 3, 1)
STEP_ABS, NEAR_ZERO, SCAN_SHARE = 1e-6, 1e-4, 1e-4
TRAIN_MESH_TIMEOUT_S = 240
TRAIN_CHECK = (("granite-3-8b", 4, (4, 1), False), ("deepseek-moe-16b", 4, (2, 2), False),
               ("granite-3-8b", 4, (1, 4), False), ("granite-3-8b", 4, (2, 2), False),
               ("falcon-mamba-7b", 4, (2, 2), False), ("granite-3-8b", 4, (1, 4), True))
TRAIN_CHECK_RUN = dict(batch=8, seq=256, steps=2, lr=3e-4)
CHECK_GRAD_REL, CHECK_SCAN_REL = 1e-4, 2.0 ** -8
ADAM_B2 = 0.95  # make_optimizer's AdamW (optim.adamw's default)
TRAIN_WORLD = (("granite-3-8b", (4, 1), False), ("deepseek-moe-16b", (2, 2), False),
               ("granite-3-8b", (2, 2), False), ("granite-3-8b", (2, 2), True),
               ("granite-3-8b", (1, 4), False), ("granite-3-8b", (1, 4), True),
               ("falcon-mamba-7b", (2, 2), False))
TRAIN_WORLD_RUN = dict(batch=8, seq=2048, steps=4, lr=3e-4, seed=0)


# [cross_silo]: cross-silo FL of the LMs at full width (fl/cross_silo.py):
# (arch, layers (0: whole), wire formats), 4 silos of 1 x 2048 tokens
CROSS_SILO = (("granite-3-8b", 4, ("fp32", "int8+ef")), ("falcon-mamba-7b", 4, ("int8",)),
              ("whisper-tiny", 0, ("fp32", "bf16", "int4")))
CROSS_SILO_RUN = dict(silos=4, batch=1, seq=2048, rounds=3, shared=2, lr=3e-4, seed=0)
CROSS_SILO_WEIGHTS = (1.0, 2.0, 1.0, 1.0)
WIRE_CHECK_COLS = 1 << 24  # columns of a wire row held against the plain pair at a time (512 | it)


# [dryrun]: the dry run (launch/dryrun.py) of granite-3-8b's four shapes on
# the 16 x 16 production mesh (None) and the three four-card meshes, rank 0,
# traced in a process of its own during the build; then the
# runs it predicts on one card, each against its prediction: (label, arch,
# shape, batch, layers (0: whole), steps)
DRYRUN_ARCH = "granite-3-8b"
DRYRUN_MESHES = (None, (4, 1), (2, 2), (1, 4))
DRYRUN_REAL = (("granite-3-8b prefill_32k", "granite-3-8b", "prefill_32k", 1, 0, 1),
               ("granite-3-8b long_500k", "granite-3-8b", "long_500k", 1, 0, 4),
               ("falcon-mamba-7b prefill_32k", "falcon-mamba-7b", "prefill_32k", 1, 0, 1),
               ("granite-3-8b train_4k", "granite-3-8b", "train_4k", 1, 8, 1))
DRYRUN_WHOLE_CARD = ("granite-3-8b prefill_32k B32", "granite-3-8b", "prefill_32k", 32, 0, 1)
DRYRUN_PEAK_REL = 0.10  # the predicted peak against torch.cuda.max_memory_allocated
DRYRUN_TIMEOUT_S = 900
DRYRUN_PROCS = 6  # the traces share out over this many processes, during the build
DRYRUN_TRAIN_COST = 5  # a train step's trace takes about this many of another shape's
# flash_attention at S = 32,768 against its plain version: granite's layer
# (B 1, H 32, Hkv 8, D 128), the plain version on kv head 0's 4 query heads
LONG_ATTENTION = (1, 32_768, 32, 8, 128)
LONG_ATTENTION_HEADS = 4


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bitwise equal, a NaN matching a NaN (a NaN scale and what it decodes to)."""
    return (torch.equal(torch.isnan(a), torch.isnan(b))
            and torch.equal(a.nan_to_num(), b.nan_to_num()))


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median CUDA-event time in ms of ``fn`` run eagerly from the host
    (what a caller pays, launch overhead included), after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, reps: int = 20) -> float:
    """Median CUDA-event time in ms of one replay of ``fn``'s launches
    captured in a CUDA graph: the device's time for the work, without the
    host's launch overhead between the launches."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture, as torch asks
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return cuda_ms(graph.replay, reps=reps)


def bound_ms(n_bytes: float, flops: float, flops_per_s: float = FP32_FLOPS) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / flops_per_s
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def rel_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """max|got - want| over max|want| (float32)."""
    got, want = got.float(), want.float()
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)


def phase_environment() -> str:
    """Prints the versions and the card; returns nvidia-smi's name and power
    limit line."""
    full_precision_matmuls()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()} "
          f"tf32 {torch.backends.cuda.matmul.allow_tf32} "
          f"matmul_precision {torch.get_float32_matmul_precision()}")
    print(smi.splitlines()[0])
    return smi.splitlines()[0]


def phase_build() -> None:
    t0 = time.perf_counter()
    per_kernel = build.build()
    print(f"[build] {time.perf_counter() - t0:.2f} s wall for {sorted(per_kernel) or 'nothing (cached)'}"
          f" {json.dumps({k: round(v, 2) for k, v in per_kernel.items()})}")


def phase_kernels(dev: torch.device) -> dict:
    """Each kernel against its plain version at the main path's shapes; one
    entry per kernel with its times and bound for one round's 8 leaves."""
    gen = torch.Generator(device=dev).manual_seed(0)
    xs = [torch.randn((K, int(np.prod(s))), generator=gen, device=dev) * 0.01 for s in LEAVES]
    us = [torch.rand(x.shape, generator=gen, device=dev) for x in xs]
    elems = sum(x.numel() for x in xs)
    blocks = sum(K * quant_blocks(x.shape[1])[1] for x in xs)

    # quantize: the round's 8 leaves in one launch of the table kernel,
    # bitwise equal to the per-leaf plain versions (int8 and int4, stochastic
    # and nearest; a NaN leaf keeps its NaN scale and zero codes); the
    # one-leaf entry; dequantize: the 8 leaves' codes in one launch, bitwise
    # equal to the per-leaf plain versions (the NaN scale decodes to NaNs)
    nan_xs = [x.clone() for x in xs]
    nan_xs[3][1, 7] = float("nan")
    q_err = d_err = 0.0
    for bits in (8, 4):
        for leaves_in, noises in ((xs, us), (xs, None), (nan_xs, us)):
            kernels.reset_launch_counts()
            got = quantize_leaves(leaves_in, noises, bits=bits)
            check(kernels.launch_counts()["quantize"] == 1,
                  f"quantize_leaves: {kernels.launch_counts()['quantize']} launches for 8 leaves")
            want = quantize_leaves_plain(leaves_in, noises, bits=bits)
            for i, ((q, s), (qp, sp)) in enumerate(zip(got, want)):
                check(torch.equal(q, qp) and same(s, sp),
                      f"quantize_leaves bits={bits} leaf {i} differs from its plain version")
                q_err = max(q_err, float((q.float() - qp.float()).abs().max()),
                            float((s - sp).nan_to_num().abs().max()))
            kernels.reset_launch_counts()
            decoded = dequantize_leaves(got)
            check(kernels.launch_counts()["dequantize"] == 1,
                  f"dequantize_leaves: {kernels.launch_counts()['dequantize']} launches for 8 leaves")
            for i, (d, dp) in enumerate(zip(decoded, dequantize_leaves_plain(want))):
                check(same(d, dp), f"dequantize_leaves bits={bits} leaf {i} differs from its "
                      f"plain version")
                d_err = max(d_err, float((d - dp).nan_to_num().abs().max()))
            check(same(dequantize(*got[1]), decoded[1]),
                  f"dequantize one-leaf bits={bits} differs from its plain version")
            q1, s1 = quantize(leaves_in[1], None if noises is None else noises[1], bits=bits)
            check(torch.equal(q1, want[1][0]) and torch.equal(s1, want[1][1]),
                  f"quantize one-leaf bits={bits} differs from its plain version")
    codes = quantize_leaves(xs, us)

    # masked_aggregate: one call for the round's 8 leaves, f32 (the main path)
    # and bf16, bitwise against the per-leaf plain version: fedavg (R = 1,
    # 0/1 selections times sample counts) and masked-partial (R = 4 layer
    # rows, layer 2 shared by nobody: its leaves get the fallback exactly);
    # then the one-leaf entry, and all-zero weights -> the fallback
    leaves = [x.reshape((K,) + s) for x, s in zip(xs, LEAVES)]
    fallbacks = [torch.randn(s, generator=gen, device=dev) for s in LEAVES]
    sel = torch.rand(K, generator=gen, device=dev) < 0.5
    counts = torch.randint(224, 328, (K,), generator=gen, device=dev).float()
    w = sel.float() * counts
    share = torch.rand((K, len(HAR_MLP) - 1), generator=gen, device=dev) < 0.6
    share[:, 2] = False
    layer_rows = [j for j in range(len(HAR_MLP) - 1) for _ in ("b", "w")]
    agg_err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        xd, fd = [x.to(dtype) for x in leaves], [fb.to(dtype) for fb in fallbacks]
        for name, wm, rows, fbs in (("fedavg", w[None], [0] * len(LEAVES), None),
                                    ("masked-partial", w[None] * share.T.float(), layer_rows, fd)):
            got = masked_aggregate_leaves(xd, wm, rows, fbs)
            want = masked_aggregate_leaves_plain(xd, wm, rows, fbs)
            for i, (g, p) in enumerate(zip(got, want)):
                check(g.dtype == dtype and g.shape == p.shape and torch.equal(g, p),
                      f"masked_aggregate {name} {dtype} leaf {i} differs from its plain version")
                if rows[i] == 2 and fbs is not None:
                    check(torch.equal(g, fd[i]), f"masked_aggregate {name} {dtype} leaf {i}: "
                          f"zero-weight row, fallback not exact")
                if dtype == torch.float32:
                    agg_err = max(agg_err, float((g - p).abs().max()))
        one = masked_aggregate(xd[1], w, fd[1])
        check(torch.equal(one, masked_aggregate_plain(xd[1], w, fd[1])),
              f"masked_aggregate one leaf {dtype} differs from its plain version")
        check(torch.equal(masked_aggregate(xd[1], torch.zeros_like(w), fd[1]), fd[1]),
              f"masked_aggregate {dtype} zero weights: fallback not exact")
    print(f"[kernels] quantize: one launch for the 8 leaves, bitwise equal to the per-leaf plain "
          f"versions (int8, int4, stochastic and nearest, a NaN leaf); one-leaf entry bitwise; "
          f"dequantize: one launch for the 8 leaves, bitwise equal to the per-leaf plain "
          f"versions (int8, int4, the NaN leaf), one-leaf entry bitwise; masked_aggregate, one "
          f"call for the 8 leaves: bitwise equal to "
          f"the per-leaf plain versions in float32 and bfloat16 (fedavg R=1; masked-partial R=4 "
          f"with an all-zero row, fallback exact); one-leaf entry bitwise, zero-weight fallback "
          f"exact")

    # times over one round's 8 leaves (K = 30 client rows each); the JSON
    # line's ms / plain_ms / library_ms are device times (CUDA-graph replays)
    def run_quantize(): return quantize_leaves(xs, us)
    def run_quantize_per_leaf(): return [quantize(x, u) for x, u in zip(xs, us)]
    def run_quantize_plain(): return quantize_leaves_plain(xs, us)
    def run_dequantize(): return dequantize_leaves(codes)
    def run_dequantize_per_leaf(): return [dequantize(q, s) for q, s in codes]
    def run_dequantize_plain(): return dequantize_leaves_plain(codes)
    rows0 = [0] * len(LEAVES)
    def run_agg(): return masked_aggregate_leaves(leaves, w[None], rows0, fallbacks)
    def run_agg_plain(): return masked_aggregate_leaves_plain(leaves, w[None], rows0, fallbacks)
    def run_mv(): return [torch.mv(x.reshape(K, -1).T, w) for x in leaves]

    p_total = sum(fb.numel() for fb in fallbacks)
    q_bound, q_by = bound_ms(elems * (4 + 4 + 1) + blocks * 4, elems * 6)
    d_bound, d_by = bound_ms(elems * (1 + 4) + blocks * 4, elems)
    # x and w read, the mean written; the fallback is read only where the
    # weights sum to 0
    fallback_read = p_total * 4 if float(w.sum()) == 0 else 0
    a_bound, a_by = bound_ms(elems * 4 + K * 4 * len(leaves) + p_total * 4 + fallback_read,
                             2 * elems + p_total)
    eager = {name: cuda_ms(fn) for name, fn in (
        ("quantize", run_quantize), ("dequantize", run_dequantize), ("masked_aggregate", run_agg))}
    print(f"[kernels] one round's 8 leaves launched eagerly from the host (launch overhead "
          f"included; quantize and masked_aggregate one call), ms: {json.dumps(eager)}")
    print(f"[kernels] quantize device ms, the 8 leaves as 8 one-leaf launches (the launch pattern "
          f"before the table) {device_ms(run_quantize_per_leaf)}, as one launch "
          f"{device_ms(run_quantize)}")
    print(f"[kernels] dequantize device ms, the 8 leaves as 8 one-leaf launches "
          f"{device_ms(run_dequantize_per_leaf)}, as one launch {device_ms(run_dequantize)}")
    src = "src/repro_torch/csrc/"
    return {
        "quantize": dict(route="cuda", source=src + "quantize.cu",
                         replaces="src/repro/kernels/quantize/kernel.py:48",
                         max_abs_err=q_err, ms=device_ms(run_quantize),
                         plain_ms=device_ms(run_quantize_plain), bound_ms=q_bound, bound_by=q_by,
                         library_ms=None),
        "dequantize": dict(route="cuda", source=src + "quantize.cu",
                           replaces="src/repro/kernels/quantize/kernel.py:79",
                           max_abs_err=d_err, ms=device_ms(run_dequantize),
                           plain_ms=device_ms(run_dequantize_plain), bound_ms=d_bound,
                           bound_by=d_by, library_ms=None),
        "masked_aggregate": dict(route="cuda", source=src + "masked_aggregate.cu",
                                 replaces="src/repro/kernels/masked_aggregate/kernel.py:37",
                                 max_abs_err=agg_err, ms=device_ms(run_agg),
                                 plain_ms=device_ms(run_agg_plain), bound_ms=a_bound,
                                 bound_by=a_by, library_ms=device_ms(run_mv)),
    }


def edge_cohort(gen: torch.Generator, k: int, n_edges: int, dev: torch.device) -> torch.Tensor:
    """Edge ids (K,) int32 of a cohort of K clients drawn unsorted from a
    population of EDGE_POP_PER_LANE * K cut into E contiguous groups (the
    aggregators' partition, by true client id)."""
    pop = EDGE_POP_PER_LANE * k
    cids = torch.randperm(pop, generator=gen, device=dev)[:k]
    return torch.clamp(cids // -(-pop // n_edges), 0, n_edges - 1).to(torch.int32)


def phase_edge_kernels(dev: torch.device) -> dict:
    """masked_aggregate's edge mode (Eq. 1) at har-mlp's 8 leaves, K = 30
    and 64 lanes, E = 1, 3 and 8 edge groups: unsorted cohort ids, one edge
    with zero weight, and masked-partial rows with an all-zero row (the
    fallback); one launch, bitwise the plain version (E = 1 is the flat
    path, bitwise the call without edges). Device ms beside the bound."""
    gen = torch.Generator(device=dev).manual_seed(3)
    rows = [j for j in range(len(HAR_MLP) - 1) for _ in ("b", "w")]
    fallbacks = [torch.randn(s, generator=gen, device=dev) for s in LEAVES]
    row = {}
    for k in EDGE_KS:
        leaves = [torch.randn((k,) + s, generator=gen, device=dev) * 0.01 for s in LEAVES]
        counts = torch.randint(224, 328, (k,), generator=gen, device=dev).float()
        sel = torch.rand(k, generator=gen, device=dev) < 0.7
        share = torch.rand((k, len(HAR_MLP) - 1), generator=gen, device=dev) < 0.6
        share[:, 2] = False  # layer 2 shared by nobody: its row sums to 0
        for n_edges in EDGE_ES:
            ids = edge_cohort(gen, k, n_edges, dev)
            w = sel.float() * counts
            if n_edges > 1:
                w = w * (ids != 1).float()  # edge 1 carries no weight
            table = (w[None] * share.T.float()).contiguous()
            for name, wt, rs, fbs in (("fedavg", w[None], [0] * len(LEAVES), None),
                                      ("masked-partial", table, rows, fallbacks)):
                kernels.reset_launch_counts()
                got = masked_aggregate_leaves(leaves, wt, rs, fbs, edge_ids=ids, n_edges=n_edges)
                check(kernels.launch_counts()["masked_aggregate"] == 1,
                      f"[kernels] edge mode K={k} E={n_edges} {name}: "
                      f"{kernels.launch_counts()['masked_aggregate']} launches")
                want = masked_aggregate_leaves_plain(leaves, wt, rs, fbs, edge_ids=ids,
                                                     n_edges=n_edges)
                flat = masked_aggregate_leaves(leaves, wt, rs, fbs) if n_edges == 1 else want
                for i, (g, p, f) in enumerate(zip(got, want, flat)):
                    check(torch.equal(g, p), f"[kernels] edge mode K={k} E={n_edges} {name} "
                          f"leaf {i} differs from its plain version")
                    check(torch.equal(g, f), f"[kernels] edge mode K={k} E=1 {name} leaf {i} "
                          f"differs from the flat call")
                    if fbs is not None and rs[i] == 2:
                        check(torch.equal(g, fbs[i]), f"[kernels] edge mode K={k} "
                              f"E={n_edges} leaf {i}: zero-weight row, fallback not exact")
        ids = edge_cohort(gen, k, EDGE_ES[-1], dev)
        w = sel.float() * counts

        def run(): return masked_aggregate_leaves(leaves, w[None], [0] * len(LEAVES),
                                                  fallbacks, edge_ids=ids, n_edges=EDGE_ES[-1])

        def run_flat(): return masked_aggregate_leaves(leaves, w[None], [0] * len(LEAVES),
                                                       fallbacks)
        elems = sum(x.numel() for x in leaves)
        p_total = sum(fb.numel() for fb in fallbacks)
        # x, the weights and the order/edge ids read once, the means written
        bound, by = bound_ms(elems * 4 + k * 4 * 3 + p_total * 4, 2 * elems + p_total)
        key = "edge" if k == K else f"edge_k{k}"
        row.update({f"{key}_ms": device_ms(run), f"{key}_flat_ms": device_ms(run_flat),
                    f"{key}_bound_ms": bound, f"{key}_bound_by": by})
    print(f"[kernels] masked_aggregate edge mode, har-mlp's 8 leaves at K={EDGE_KS} lanes, "
          f"E={EDGE_ES} edge groups (unsorted cohort ids, edge 1 weightless, an all-zero "
          f"masked-partial row): one launch, bitwise the plain version, E=1 bitwise the flat "
          f"call, the fallback exact; device ms at E={EDGE_ES[-1]} beside the flat mode and the "
          f"bound: {json.dumps(row)}")
    return row


def visible_pairs(s_len: int, t_len: int, causal: bool, window: int, q_pos=None,
                  k_pos=None) -> int:
    """(query, key) pairs that flash_attention's mask leaves visible: by
    index, or by the position vectors ``q_pos`` (S,) and ``k_pos`` (T,)
    (key t visible to query s iff k_pos[t] >= 0, k_pos[t] <= q_pos[s] when
    causal and k_pos[t] > q_pos[s] - window when window > 0)."""
    if q_pos is not None:
        qp = q_pos.cpu().numpy().astype(np.int64)
        kp = np.sort(k_pos.cpu().numpy().astype(np.int64))
        kp = kp[kp >= 0]
        hi = np.searchsorted(kp, qp, side="right") if causal else np.full(len(qp), len(kp))
        lo = np.searchsorted(kp, qp - window, side="right") if window else 0
        return int(np.maximum(hi - lo, 0).sum())
    total = 0
    for q in range(s_len):
        hi = min(t_len - 1, q) if causal else t_len - 1
        lo = max(0, q - window + 1) if window else 0
        total += max(0, hi - lo + 1)
    return total


def phase_lm_kernels(dev: torch.device) -> dict:
    """ssm_scan and flash_attention against their plain versions at the
    full-width prefill shapes of the serving run (bf16 streams), plus a
    window, a ragged length and float32; times and bounds of one launch."""
    gen = torch.Generator(device=dev).manual_seed(1)
    randn = lambda *shape: torch.randn(shape, generator=gen, device=dev)  # noqa: E731
    b, s = SERVE_RUN["batch"], SERVE_RUN["prompt_len"]
    src = "src/repro_torch/csrc/"
    rows = {}

    # ssm_scan: falcon-mamba-7b's layer, B=4, S=2048, di=8192, ds=16, bf16
    # streams, held to kernels/ssm_scan/contract.py (against the plain
    # version run in float64) with y in float32 and in bf16, at the serving
    # length and a ragged one, with the model's S4D-real A and with a random
    # A (no structure across states or channels); at S=2048 the contract's
    # two controls must fail the same check
    fm = get_config("falcon-mamba-7b")
    di, ds = fm.d_inner, fm.d_state
    a_kinds = {"s4d": -torch.arange(1, ds + 1, dtype=torch.float32, device=dev).expand(di, ds),
               "random": -torch.exp(randn(di, ds))}
    d = torch.ones((di,), device=dev)

    def ssm_inputs(seq):
        dt = torch.nn.functional.softplus(randn(b, seq, di) * 0.5 - 4.6)
        return [t.to(torch.bfloat16) for t in (dt, randn(b, seq, ds), randn(b, seq, ds),
                                                randn(b, seq, di))]

    def brief(r):
        return {k: float(f"{v:.4g}") if isinstance(v, float) else v for k, v in r.items()}

    results = {}
    for seq in (s, s - 49):  # the serving length, and a ragged one
        dt, bm, cm, x = ssm_inputs(seq)
        for a_name, a in a_kinds.items():
            a = a.contiguous()
            plain32, ref64 = ssm_contract.references(dt, a, bm, cm, x, d)
            for y_dtype in (torch.float32, torch.bfloat16):
                y, h = ssm_scan(dt, a, bm, cm, x, d, y_dtype=y_dtype)
                name = f"S={seq} A={a_name} y={str(y_dtype)[6:]}"
                results[name] = r = brief(ssm_contract.check(y, h, plain32, ref64))
                check(r["ok"], f"ssm_scan {name} fails its contract: {r}")
                if seq == s and a_name == "s4d" and y_dtype == torch.float32:
                    ssm_err = float((y.double() - ref64[0]).abs().max())
                    ssm_args = (dt, a, bm, cm, x, d)
            if seq == s:
                for fault, (yc, hc) in ssm_contract.controls(dt, a, bm, cm, x, d).items():
                    for y_c in (yc, yc.to(torch.bfloat16)):
                        name = f"control {fault} A={a_name} y={str(y_c.dtype)[6:]}"
                        results[name] = r = brief(ssm_contract.check(y_c, hc, plain32, ref64))
                        check(not r["ok"], f"ssm_scan's contract accepts {name}: {r}")
            del plain32, ref64
    print(f"[kernels] ssm_scan B={b} di={di} ds={ds} bf16 streams against the plain version in "
          f"float64 (contract, kernels/ssm_scan/contract.py: float32 y and h within "
          f"{ssm_contract.F32_FACTOR:g} x the float32 plain version's gap + "
          f"{ssm_contract.F32_REL:g} of max; bf16 y within 1 ulp + {ssm_contract.BF16_REL:g} of "
          f"max; gaps over max|ref|; the controls must fail it): {json.dumps(results)}")
    # bound: the larger of the bytes, the exps on the SFU (one per state
    # update) and the FP32 pipe's 4 instructions per state update
    updates = b * s * di * ds
    n_bytes = (2 * b * s * di * 2 + 2 * b * s * ds * 2 + di * ds * 4 + di * 4 + b * s * di * 2
               + b * di * ds * 4)
    limits = {"bytes": n_bytes / HBM_BYTES_PER_S, "sfu exp": updates / SFU_PER_S,
              "fp32 instructions": 4 * updates / FP32_INSTR_PER_S}
    ssm_op = max(limits, key=limits.get)
    print(f"[kernels] ssm_scan bound terms, ms: "
          f"{json.dumps({k: 1e3 * v for k, v in limits.items()})}")
    rows["ssm_scan"] = dict(route="cuda", source=src + "ssm_scan.cu",
                            replaces="src/repro/kernels/ssm_scan/kernel.py:62",
                            max_abs_err=ssm_err, ms=device_ms(lambda: ssm_scan(*ssm_args)),
                            plain_ms=device_ms(lambda: ssm_scan_plain(*ssm_args), reps=3),
                            bound_ms=1e3 * limits[ssm_op],
                            bound_by="bytes" if ssm_op == "bytes" else "operations",
                            bound_op=ssm_op, library_ms=None)

    # flash_attention: granite-3-8b's layer, B=4, S=2048, H=32, Hkv=8, D=128
    # (bf16: the wgmma kernel; f32: the CUDA-core kernel), and D=64 in bf16
    gr = get_config("granite-3-8b")
    h, hkv, dh = gr.n_heads, gr.n_kv_heads, gr.head_dim_
    q, k, v = (randn(b, s, n, dh).to(torch.bfloat16) for n in (h, hkv, hkv))
    q64, k64, v64 = (randn(b, s, n, 64).to(torch.bfloat16) for n in (h, hkv, hkv))
    gaps, bf16 = {}, {}
    for name, (qq, kk, vv), window in (("bf16 w0", (q, k, v), 0), ("bf16 w512", (q, k, v), 512),
                                       ("bf16 S=2000", (q[:, :2000], k[:, :2000], v[:, :2000]), 0),
                                       ("bf16 D=64", (q64, k64, v64), 0),
                                       ("f32 w0", (q.float(), k.float(), v.float()), 0)):
        qq, kk, vv = (t.contiguous() for t in (qq, kk, vv))
        got = flash_attention(qq, kk, vv, causal=True, window=window)
        want = flash_attention_plain(qq, kk, vv, causal=True, window=window)
        if qq.dtype == torch.float32:
            gaps[name] = rel_gap(got, want)
            ok = gaps[name] <= LM_REL
        else:
            bf16[name] = bf16_contract(got, want, qq, kk, vv, causal=True, window=window)
            ok = bf16[name]["ok"]
        check(ok, f"flash_attention {name} differs from its plain version {gaps} {bf16}")
        if name == "bf16 w0":
            fa_err = float((got.float() - want.float()).abs().max())
        if name == "bf16 w512":
            # controls: the same check must reject two systematic errors at
            # this shape, P kept in float32 and a window one key short
            controls = {
                "float32 P": flash_attention_plain(qq.float(), kk.float(), vv.float(), causal=True,
                                                   window=window).to(torch.bfloat16),
                "window 511": flash_attention_plain(qq, kk, vv, causal=True, window=window - 1)}
            for fault, bad in controls.items():
                bf16[f"control {fault}"] = r = bf16_contract(bad, want, qq, kk, vv, causal=True,
                                                             window=window)
                check(not r["ok"], f"flash_attention's bf16 check accepts {fault}: {r}")
            del controls, bad
        del got, want
    print(f"[kernels] flash_attention B={b} S={s} H={h} Hkv={hkv} D={dh} causal vs plain; f32 "
          f"(contract: within {LM_REL} of max): {json.dumps(gaps)}; bf16 (contract, "
          f"kernels/flash_attention/contract.py: excess over 1 ulp + {LM_REL} of max + "
          f"p_rounding_slack <= 0, and n_over, the elements over 1 ulp + {LM_REL} of max alone, "
          f"<= {MAX_OVER_SHARE} of n; the controls must fail it): {json.dumps(bf16)}")
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    n_bytes = 2 * (b * s * h * dh * 2) + 2 * (b * s * hkv * dh * 2)
    fa_bound, fa_by = bound_ms(n_bytes, 4 * b * h * dh * visible_pairs(s, s, True, 0), BF16_FLOPS)
    rows["flash_attention"] = dict(
        route="cuda", source=src + "flash_attention_wgmma.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:73", max_abs_err=fa_err,
        ms=device_ms(lambda: flash_attention(q, k, v)),
        plain_ms=device_ms(lambda: flash_attention_plain(q, k, v), reps=3),
        bound_ms=fa_bound, bound_by=fa_by,
        library_ms=device_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qh, kh, vh, is_causal=True, enable_gqa=True)))
    del q, k, v, qh, kh, vh, q64, k64, v64
    rows["flash_attention"].update(zoo_attention_kernels(dev, randn))
    fa_tp, ssm_tp, rows["flash_attention_bwd"], rows["ssm_scan_bwd"] = tp_rank_kernels(randn)
    rows["flash_attention"].update(fa_tp)
    rows["ssm_scan"].update(ssm_tp)
    fa_pos, fa_bwd_pos = position_mask_kernels(randn)
    rows["flash_attention"].update(fa_pos)
    rows["flash_attention_bwd"].update(fa_bwd_pos)
    rows["ssm_scan"].update(start_state_kernels(randn))
    return rows


def image_positions(n_vision: int, s_len: int, grid: int) -> torch.Tensor:
    """(S, 3) int32 M-RoPE streams of a Qwen2-VL prompt that opens with an
    image: its ``n_vision`` tokens a ``grid``-wide raster at t = 0 (h the
    row, w the column), then the text from t = h = w = ``grid``. The t
    stream is what attention masks by: the image's tokens see each other
    whole, later ones included."""
    idx = torch.arange(n_vision)
    text = grid + torch.arange(s_len - n_vision)
    t = torch.cat([torch.zeros(n_vision, dtype=torch.int64), text])
    return torch.stack([t, torch.cat([idx // grid, text]), torch.cat([idx % grid, text])],
                       dim=-1).to(torch.int32)


def position_mask_kernels(randn) -> tuple[dict, dict]:
    """flash_attention and flash_attention_bwd masked by M-RoPE's t stream
    (``q_pos = k_pos``) at qwen2-vl-2b's prefill shape (B 4, S 2048, H 12,
    Hkv 2, D 128, bf16), QWEN_IMAGE's layout (1,024 image tokens at t = 0,
    text from t = 32): the forward against its plain version under the bf16
    contract, causal and with a 512 window; the backward (B 1) under its
    float64 contract, its controls rejected; float32 at a reduced shape;
    positions ``arange(S)`` bitwise the index mask, forward and backward.
    Times (device ms) beside the index-masked call on the same inputs, the
    bound from the pairs the positions leave visible, and SDPA with the
    same boolean mask. Returns (the flash_attention row's ``pos_*`` keys,
    flash_attention_bwd's)."""
    from repro_torch.kernels.flash_attention import contract as fa_contract
    from repro_torch.kernels.flash_attention import flash_attention_backward_plain
    from repro_torch.kernels.flash_attention import flash_attention_bwd
    from repro_torch.kernels.flash_attention.ops import _attention

    b, s = SERVE_RUN["batch"], SERVE_RUN["prompt_len"]
    qw = get_config("qwen2-vl-2b")
    h, hkv, d = qw.n_heads, qw.n_kv_heads, qw.head_dim_
    nv, grid = QWEN_IMAGE["n_vision"], QWEN_IMAGE["grid"]
    q = randn(b, s, h, d).to(torch.bfloat16)
    k, v = (randn(b, s, hkv, d).to(torch.bfloat16) for _ in range(2))
    dev = q.device
    pos = image_positions(nv, s, grid)[:, 0].to(dev)
    mask = dict(q_pos=pos, k_pos=pos)
    report = {}
    for name, window in (("image w0", 0), ("image w512", 512)):
        got = flash_attention(q, k, v, window=window, **mask)
        want = flash_attention_plain(q, k, v, True, window, **mask)
        report[name] = r = bf16_contract(got, want, q, k, v, True, window, **mask)
        check(r["ok"], f"flash_attention position-masked {name} fails the bf16 contract: {r}")
        if window == 0:
            err = float((got.float() - want.float()).abs().max())
        del got, want
    ar = torch.arange(s, dtype=torch.int32, device=dev)
    check(same(flash_attention(q, k, v), flash_attention(q, k, v, q_pos=ar, k_pos=ar)),
          "flash_attention with positions arange(S) differs from the index mask")
    # float32 at a reduced shape (the CUDA-core kernel), image first
    pos32 = image_positions(256, 512, 16)[:, 0].to(dev)
    q32, k32, v32 = (t[:1, :512].float().contiguous() for t in (q, k, v))
    gap32 = rel_gap(flash_attention(q32, k32, v32, q_pos=pos32, k_pos=pos32),
                    flash_attention_plain(q32, k32, v32, q_pos=pos32, k_pos=pos32))
    check(gap32 <= LM_REL, f"flash_attention float32 position-masked: gap {gap32} > {LM_REL}")
    pairs, index_pairs = visible_pairs(s, s, True, 0, pos, pos), visible_pairs(s, s, True, 0)
    n_bytes = 2 * (b * s * h * d * 2) + 2 * (b * s * hkv * d * 2) + 2 * s * 4
    bound, by = bound_ms(n_bytes, 4 * b * h * d * pairs, BF16_FLOPS)
    index_bound, _ = bound_ms(n_bytes, 4 * b * h * d * index_pairs, BF16_FLOPS)
    allowed = pos[None, :] <= pos[:, None]  # the same mask as SDPA's boolean attn_mask
    lib, backend, tried = sdpa_fused_ms(q, k, v, attn_mask=allowed)
    fa = {"pos_shape": [b, s, h, hkv, d, d], "pos_layout": f"{nv} image tokens at t=0, text from "
          f"t={grid}", "pos_visible_pairs": pairs, "pos_index_visible_pairs": index_pairs,
          "pos_max_abs_err": err, "pos_f32_gap": gap32,
          "pos_ms": device_ms(lambda: flash_attention(q, k, v, **mask)),
          "pos_index_ms": device_ms(lambda: flash_attention(q, k, v)),
          "pos_plain_ms": device_ms(lambda: flash_attention_plain(q, k, v, **mask), reps=3),
          "pos_bound_ms": bound, "pos_bound_by": by, "pos_index_bound_ms": index_bound,
          "pos_library_ms": lib, "pos_library_backend": backend}
    report["sdpa with the boolean mask"] = tried
    print(f"[kernels] flash_attention masked by M-RoPE's t stream at qwen2-vl-2b's shape "
          f"(B={b} S={s} H={h} Hkv={hkv} D={d} bf16; {fa['pos_layout']}): bf16 contract "
          f"against the plain version, arange positions bitwise the index mask, float32 (1, 512) "
          f"gap {gap32:.3g} (contract {LM_REL}): {json.dumps(report)} {json.dumps(fa)}")

    # the backward at B 1, on the forward kernel's o and lse
    q1, k1, v1 = (t[:1].contiguous() for t in (q, k, v))
    dout = randn(1, s, h, d).to(torch.bfloat16)
    out, lse = _attention(q1, k1, v1, True, 0, True, pos, pos)
    args = (q1, k1, v1, out, lse, dout, True, 0)
    got = flash_attention_bwd(*args, **mask)
    ref = fa_contract.bwd_references(*args, **mask)
    brief = lambda r: {kk: float(f"{vv:.4g}") if isinstance(vv, float) else vv  # noqa: E731
                       for kk, vv in r.items()}
    bwd_report = {"image": brief(fa_contract.bwd_check(got, ref))}
    check(bwd_report["image"]["ok"],
          f"flash_attention_bwd position-masked fails its contract: {bwd_report['image']}")
    for fault, bad in fa_contract.bwd_controls(*args, **mask).items():
        bwd_report[f"control {fault}"] = r = brief(fa_contract.bwd_check(bad, ref))
        check(not r["ok"], f"flash_attention_bwd's contract accepts {fault} under positions: {r}")
    bwd_err = max(float((g.double() - w).abs().max()) for g, w in zip(got, ref.ref64))
    del ref, bad
    out_i, lse_i = _attention(q1, k1, v1, True, 0, True)
    args_i = (q1, k1, v1, out_i, lse_i, dout, True, 0)
    check(all(same(x, y) for x, y in zip(flash_attention_bwd(*args_i),
                                          flash_attention_bwd(*args_i, q_pos=ar, k_pos=ar))),
          "flash_attention_bwd with positions arange(S) differs from the index mask")
    pairs1 = visible_pairs(s, s, True, 0, pos, pos)
    n_bytes = 2 * (2 * s * h * d + 2 * s * hkv * 2 * d + 2 * s * h * d) + 4 * h * s + 2 * s * 4
    bwd_bound, bwd_by = bound_ms(n_bytes, 2 * (3 * d + 2 * d) * h * pairs1, BF16_FLOPS)
    lib, backend, tried = sdpa_backward_ms(q1, k1, v1, dout, False, attn_mask=allowed)
    bwd = {"pos_shape": [1, s, s, h, hkv, d, d, True], "pos_max_abs_err": bwd_err,
           "pos_ms": cuda_ms(lambda: flash_attention_bwd(*args, **mask), reps=10),
           "pos_index_ms": cuda_ms(lambda: flash_attention_bwd(*args_i), reps=10),
           "pos_plain_ms": cuda_ms(lambda: flash_attention_backward_plain(*args, **mask), reps=2,
                                   warmup=1),
           "pos_bound_ms": bwd_bound, "pos_bound_by": bwd_by,
           "pos_library_ms": lib, "pos_library_backend": backend}
    bwd_report["sdpa backward with the boolean mask"] = tried
    print(f"[kernels] flash_attention_bwd masked by the same t stream (B=1; contract, "
          f"kernels/flash_attention/contract.py; arange positions bitwise the index mask): "
          f"{json.dumps(bwd_report)} {json.dumps(bwd)}")
    del q, k, v, q1, k1, v1, dout, out, lse, out_i, lse_i, got, args, args_i
    gc.collect()
    torch.cuda.empty_cache()
    return fa, bwd


def start_state_kernels(randn) -> dict:
    """ssm_scan from a carried state h0 (a prefill that continues a cache):
    falcon-mamba-7b's layer (B 4, S 2048, d_inner 8,192, ds 16, bf16
    streams) and a tensor-parallel rank's 2,048 channels, from a random h0,
    held to kernels/ssm_scan/contract.py against the float64 scan from h0
    (float32 and bf16 y), the start-state-dropped control rejected; h0 =
    zeros bitwise the scan without one; device ms beside the h = 0 call.
    Returns the ssm_scan row's ``h0_*`` keys."""
    b, s = SERVE_RUN["batch"], SERVE_RUN["prompt_len"]
    fm = get_config("falcon-mamba-7b")
    out, report = {}, {}
    for key, di in (("", fm.d_inner), ("tp_", fm.d_inner // TP_MODEL_RANKS)):
        ds = fm.d_state
        dt = torch.nn.functional.softplus(randn(b, s, di) * 0.5 - 4.6)
        dt, bm, cm, x = (t.to(torch.bfloat16) for t in (dt, randn(b, s, ds), randn(b, s, ds),
                                                          randn(b, s, di)))
        a = -torch.arange(1, ds + 1, dtype=torch.float32, device=dt.device).expand(di, ds)
        a = a.contiguous()
        d = torch.ones((di,), device=dt.device)
        h0 = randn(b, di, ds)
        args = (dt, a, bm, cm, x, d)
        plain32, ref64 = ssm_contract.references(*args, h0=h0)
        for y_dtype in (torch.float32, torch.bfloat16):
            y, h_last = ssm_scan(*args, y_dtype=y_dtype, h0=h0)
            name = f"di={di} y={str(y_dtype)[6:]}"
            report[name] = r = {kk: float(f"{vv:.4g}") if isinstance(vv, float) else vv
                                for kk, vv in ssm_contract.check(y, h_last, plain32,
                                                                 ref64).items()}
            check(r["ok"], f"ssm_scan from h0 at {name} fails its contract: {r}")
            if y_dtype == torch.float32:
                err = float((y.double() - ref64[0]).abs().max())
        bad = ssm_contract.controls(*args, h0=h0)["start state dropped"]
        report[f"di={di} control start state dropped"] = r = {
            kk: float(f"{vv:.4g}") if isinstance(vv, float) else vv
            for kk, vv in ssm_contract.check(*bad, plain32, ref64).items()}
        check(not r["ok"], f"ssm_scan's contract accepts a dropped start state at di={di}: {r}")
        zero = ssm_scan(*args, h0=torch.zeros_like(h0))
        check(all(same(p, z) for p, z in zip(ssm_scan(*args), zero)),
              f"ssm_scan from h0 = 0 differs from the scan without one at di={di}")
        del plain32, ref64, bad, zero
        updates = b * s * di * ds
        n_bytes = (2 * b * s * di * 2 + 2 * b * s * ds * 2 + di * ds * 4 + di * 4 + b * s * di * 2
                   + 2 * b * di * ds * 4)
        limits = {"bytes": n_bytes / HBM_BYTES_PER_S, "sfu exp": updates / SFU_PER_S,
                  "fp32 instructions": 4 * updates / FP32_INSTR_PER_S}
        op = max(limits, key=limits.get)
        out.update({f"h0_{key}shape": [b, s, di, ds], f"h0_{key}max_abs_err": err,
                    f"h0_{key}ms": device_ms(lambda: ssm_scan(*args, h0=h0)),
                    f"h0_{key}zero_state_ms": device_ms(lambda: ssm_scan(*args)),
                    f"h0_{key}bound_ms": 1e3 * limits[op],
                    f"h0_{key}bound_by": "bytes" if op == "bytes" else "operations"})
        del dt, bm, cm, x, h0, args
    print(f"[kernels] ssm_scan from a carried start state h0 (falcon-mamba-7b's d_inner and a "
          f"rank's of {TP_MODEL_RANKS}; B={b} S={s} bf16 streams) against the float64 scan from "
          f"h0 (kernels/ssm_scan/contract.py), h0 = 0 bitwise no h0: {json.dumps(report)} "
          f"{json.dumps(out)}")
    return out


def tp_rank_kernels(randn) -> tuple[dict, dict, dict, dict]:
    """flash_attention and ssm_scan at the shapes a tensor-parallel rank of
    TP_MODEL_RANKS model ranks gives them (B 4, S 2048, bf16): attention
    at each TP_ATTENTION rank's heads (the kv heads its q heads read; G =
    3 and a lone kv head of 8 q heads among them) under the bf16 contract,
    with SDPA's fused backends; the scan at falcon-mamba's and jamba's
    d_inner over the ranks (2,048 channels) under its float64 contract,
    float32 and bf16 y. Times, bounds and plain times of one launch each.
    Then the backwards at the same ranks' shapes (``tp_rank_backward_kernels``).
    Returns (the flash_attention row's ``tp_*`` keys, the ssm_scan row's,
    flash_attention_bwd's, ssm_scan_bwd's)."""
    b, s = SERVE_RUN["batch"], SERVE_RUN["prompt_len"]
    fa, report = {}, {}
    for key, (h, hkv, dq, dv) in TP_ATTENTION.items():
        q = randn(b, s, h, dq).to(torch.bfloat16)
        k = randn(b, s, hkv, dq).to(torch.bfloat16)
        v = randn(b, s, hkv, dv).to(torch.bfloat16)
        got = flash_attention(q, k, v)
        want = flash_attention_plain(q, k, v)
        report[key] = r = bf16_contract(got, want, q, k, v)
        check(got.shape == (b, s, h, dv) and r["ok"],
              f"flash_attention at a tensor-parallel rank's {key} shape (H {h}, Hkv {hkv}, Dqk "
              f"{dq}, Dv {dv}) fails its contract: {r}")
        n_bytes = 2 * b * s * (h * dq + hkv * dq + hkv * dv + h * dv)
        bound, by = bound_ms(n_bytes, 2 * b * h * (dq + dv) * visible_pairs(s, s, True, 0),
                             BF16_FLOPS)
        lib, backend, tried = sdpa_fused_ms(q, k, v)
        fa.update({f"tp_{key}_shape": [b, s, h, hkv, dq, dv],
                   f"tp_{key}_max_abs_err": float((got.float() - want.float()).abs().max()),
                   f"tp_{key}_ms": device_ms(lambda: flash_attention(q, k, v)),
                   f"tp_{key}_plain_ms": device_ms(lambda: flash_attention_plain(q, k, v), reps=3),
                   f"tp_{key}_bound_ms": bound, f"tp_{key}_bound_by": by,
                   f"tp_{key}_library_ms": lib, f"tp_{key}_library_backend": backend})
        report[f"{key} sdpa"] = tried
        del q, k, v, got, want
    print(f"[kernels] flash_attention at a tensor-parallel rank's heads ({TP_MODEL_RANKS} model "
          f"ranks; [B, S, H, Hkv, Dqk, Dv] in the tp_*_shape keys) bf16 causal vs plain "
          f"(contract, kernels/flash_attention/contract.py); SDPA's fused backends: "
          f"{json.dumps(report)} {json.dumps(fa)}")

    fm = get_config("falcon-mamba-7b")
    di, ds = fm.d_inner // TP_MODEL_RANKS, fm.d_state
    dt = torch.nn.functional.softplus(randn(b, s, di) * 0.5 - 4.6)
    dt, bm, cm, x = (t.to(torch.bfloat16) for t in (dt, randn(b, s, ds), randn(b, s, ds),
                                                      randn(b, s, di)))
    a = -torch.arange(1, ds + 1, dtype=torch.float32, device=dt.device).expand(di, ds).contiguous()
    d = torch.ones((di,), device=dt.device)
    args = (dt, a, bm, cm, x, d)
    plain32, ref64 = ssm_contract.references(*args)
    contract = {}
    for y_dtype in (torch.float32, torch.bfloat16):
        y, h_last = ssm_scan(*args, y_dtype=y_dtype)
        contract[str(y_dtype)[6:]] = r = {k: float(f"{v:.4g}") if isinstance(v, float) else v
                                          for k, v in ssm_contract.check(y, h_last, plain32,
                                                                         ref64).items()}
        check(r["ok"], f"ssm_scan at a tensor-parallel rank's d_inner {di} fails its contract: {r}")
        if y_dtype == torch.float32:
            err = float((y.double() - ref64[0]).abs().max())
    del plain32, ref64
    updates = b * s * di * ds
    n_bytes = (2 * b * s * di * 2 + 2 * b * s * ds * 2 + di * ds * 4 + di * 4 + b * s * di * 2
               + b * di * ds * 4)
    limits = {"bytes": n_bytes / HBM_BYTES_PER_S, "sfu exp": updates / SFU_PER_S,
              "fp32 instructions": 4 * updates / FP32_INSTR_PER_S}
    op = max(limits, key=limits.get)
    ssm = {"tp_shape": [b, s, di, ds], "tp_max_abs_err": err, "tp_contract": contract,
           "tp_ms": device_ms(lambda: ssm_scan(*args)),
           "tp_plain_ms": device_ms(lambda: ssm_scan_plain(*args), reps=3),
           "tp_bound_ms": 1e3 * limits[op],
           "tp_bound_by": "bytes" if op == "bytes" else "operations",
           "tp_bound_op": op}
    print(f"[kernels] ssm_scan at a tensor-parallel rank's d_inner (falcon-mamba-7b and "
          f"jamba-v0.1-52b over {TP_MODEL_RANKS} model ranks), B={b} S={s} di={di} ds={ds}, "
          f"against the plain version in float64 (kernels/ssm_scan/contract.py): {json.dumps(ssm)}")
    fa_bwd, ssm_bwd = tp_rank_backward_kernels(randn)
    return fa, ssm, fa_bwd, ssm_bwd


def tp_rank_backward_kernels(randn) -> tuple[dict, dict]:
    """The two backward kernels at a tensor-parallel rank's shapes (B 4, S
    2048, bf16), as training under TP gives them: flash_attention_bwd at
    each TP_ATTENTION rank's heads (the dK/dV pass sums the G q heads of a
    kv head, and a rank keeps the model's G: 4, 8, 3 and 1), against the
    backward in float64 (``attention_bwd_case``, no controls); ssm_scan_bwd
    at falcon-mamba-7b's and jamba-v0.1-52b's d_inner over 2 and 4 model
    ranks (4,096 and 2,048 channels), on the forward kernel's chunk states,
    against the float64 backward (``kernels/ssm_scan/contract.py``), two
    calls bitwise, timed beside its bound (``ssm_bwd_limits``) and the
    float32 plain version. Returns (flash_attention_bwd's ``tp_*`` keys,
    ssm_scan_bwd's)."""
    from repro_torch.kernels.ssm_scan import ssm_scan_backward_plain, ssm_scan_bwd

    b, s = SERVE_RUN["batch"], SERVE_RUN["prompt_len"]
    brief = lambda r: {k: float(f"{v:.4g}") if isinstance(v, float) else v  # noqa: E731
                       for k, v in r.items()}
    fa, report = {}, {}
    for key, (h, hkv, dq, dv) in TP_ATTENTION.items():
        row, rep = attention_bwd_case(f"tp_{key}", (b, s, s, h, hkv, dq, dv, True), randn,
                                      controls=False)
        fa.update({f"tp_{key}_{k}": v for k, v in row.items()})
        report.update(rep)
    print(f"[kernels] flash_attention_bwd bf16 at a tensor-parallel rank's heads "
          f"({TP_MODEL_RANKS} model ranks; [B, S, T, H, Hkv, Dqk, Dv, causal] in the "
          f"tp_*_shape keys) against the backward in float64 (contract, "
          f"kernels/flash_attention/contract.py), two calls bitwise; ms beside the five- and "
          f"seven-product bounds and SDPA's fused backward: {json.dumps(report)} "
          f"{json.dumps(fa)}")
    fm = get_config("falcon-mamba-7b")
    ds = fm.d_state
    ssm, report = {}, {}
    for n in (2, TP_MODEL_RANKS):
        di = fm.d_inner // n
        a = -torch.exp(randn(di, ds))
        d = randn(di)
        streams = [t.to(torch.bfloat16) for t in (
            torch.nn.functional.softplus(randn(b, s, di) * 0.5 - 4.6), randn(b, s, ds),
            randn(b, s, ds), randn(b, s, di))]
        args = (streams[0], a, streams[1], streams[2], streams[3], d)
        _, _, hs = ssm_scan(*args, y_dtype=torch.bfloat16, chunk_states=True)
        gy = randn(b, s, di).to(torch.bfloat16).float()  # a bf16 y's cotangent
        got = ssm_scan_bwd(*args, hs, gy)
        again = ssm_scan_bwd(*args, hs, gy)
        check(all(same(x, y) for x, y in zip(got, again)),
              f"ssm_scan_bwd at a tensor-parallel rank's d_inner {di}: two calls differ")
        plain32, ref64 = ssm_contract.bwd_references(*args, hs, gy)
        report[f"di={di}"] = r = brief(ssm_contract.bwd_check(got, plain32, ref64))
        check(r["ok"], f"ssm_scan_bwd at a tensor-parallel rank's d_inner {di} fails its "
                       f"contract: {r}")
        limits = ssm_bwd_limits(b, s, di, ds, hs.numel())
        op = max(limits, key=limits.get)
        key = f"tp_di{di}"
        ssm.update({
            f"{key}_shape": [b, s, di, ds],
            f"{key}_max_abs_err": max(float((g.double() - w).abs().max())
                                      for g, w in zip(got, ref64)),
            f"{key}_ms": cuda_ms(lambda: ssm_scan_bwd(*args, hs, gy), reps=10),
            f"{key}_plain_ms": cuda_ms(lambda: ssm_scan_backward_plain(*args, hs, gy), reps=1,
                                       warmup=1),
            f"{key}_bound_ms": 1e3 * limits[op],
            f"{key}_bound_by": "bytes" if op == "bytes" else "operations",
            f"{key}_bound_op": op, f"{key}_bound_fp32_ms": 1e3 * limits["fp32 instructions"]})
        del plain32, ref64, got, again, streams, args, hs, gy
        gc.collect()
        torch.cuda.empty_cache()
    print(f"[kernels] ssm_scan_bwd at a tensor-parallel rank's d_inner (falcon-mamba-7b and "
          f"jamba-v0.1-52b over 2 and {TP_MODEL_RANKS} model ranks), B={b} S={s} ds={ds}, bf16 "
          f"streams, against the backward in float64 on the forward kernel's chunk states "
          f"(contract, kernels/ssm_scan/contract.py), two calls bitwise; ms beside the bound "
          f"and the FP32-pipe bound: {json.dumps(report)} {json.dumps(ssm)}")
    return fa, ssm


def sdpa_fused_ms(q, k, v, causal: bool = True, attn_mask=None) -> tuple:
    """``scaled_dot_product_attention`` (causal or not, or with a boolean
    ``attn_mask`` (S, T), True where a key is visible; q (B, S, H, Dqk), k
    and v (B, T, Hkv, D) in the model layout, ``enable_gqa`` where k and v
    have fewer heads) through
    each fused backend that takes the shape: (the fastest one's device ms
    or None, its name, every backend's ms or the first line of its
    refusal)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    gqa = k.shape[2] != q.shape[2]
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    how = ({"is_causal": causal} if attn_mask is None else {"attn_mask": attn_mask})
    tried = {}
    for name in ("FLASH_ATTENTION", "CUDNN_ATTENTION", "EFFICIENT_ATTENTION"):
        backend = getattr(SDPBackend, name, None)
        if backend is None:
            tried[name] = "not in this torch"
            continue
        try:
            with sdpa_kernel([backend]):
                fn = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
                    qh, kh, vh, **how, **({"enable_gqa": True} if gqa else {}))
                fn()
                torch.cuda.synchronize()
                tried[name] = device_ms(fn)
        except RuntimeError as err:
            tried[name] = "refused: " + str(err).strip().splitlines()[0][:160]
    times = {n: t for n, t in tried.items() if isinstance(t, float)}
    best = min(times, key=times.get) if times else None
    return (times[best] if best else None), best, tried


def zoo_attention_kernels(dev: torch.device, randn) -> dict:
    """flash_attention at the other zoo archs' prefill shapes (B=4, S=2048,
    bf16): deepseek-v2-lite's MLA (H = Hkv = 16, Dqk = 192, Dv = 128),
    deepseek-moe's MHA (H = Hkv = 16, D = 128, G = 1), stablelm-12b's
    (H 32, Hkv 8, D = 160: 64-key tiles; also with a window of 512 and at a
    ragged S of 2000), chatglm3-6b's (H 32, Hkv 2, D 128, G = 16) and
    qwen2-vl-2b's (H 12, Hkv 2, D 128, G = 6), each against its plain
    version under the bf16 contract, with its device ms, bound and the
    fused SDPA backends' ms; and the float32 kernel at the reduced MLA dims
    (48, 32) against its plain version. Keys prefixed ``mla_``, ``moe_``,
    ``stablelm_``, ``chatglm3_`` and ``qwen2vl_`` for the flash_attention
    row."""
    b, s = SERVE_RUN["batch"], SERVE_RUN["prompt_len"]
    ds, dm = get_config("deepseek-v2-lite-16b"), get_config("deepseek-moe-16b")
    shapes = {"mla": (ds.n_heads, ds.n_heads, ds.qk_nope_dim + ds.qk_rope_dim, ds.v_head_dim),
              "moe": (dm.n_heads, dm.n_heads, dm.head_dim_, dm.head_dim_)}
    for key, arch in (("stablelm", "stablelm-12b"), ("chatglm3", "chatglm3-6b"),
                      ("qwen2vl", "qwen2-vl-2b")):
        c = get_config(arch)
        shapes[key] = (c.n_heads, c.n_kv_heads, c.head_dim_, c.head_dim_)
    row, report = {}, {}
    for key, (h, hkv, dq, dv) in shapes.items():
        q = randn(b, s, h, dq).to(torch.bfloat16)
        k = randn(b, s, hkv, dq).to(torch.bfloat16)
        v = randn(b, s, hkv, dv).to(torch.bfloat16)
        got = flash_attention(q, k, v)
        want = flash_attention_plain(q, k, v)
        report[key] = r = bf16_contract(got, want, q, k, v)
        check(got.shape == (b, s, h, dv) and r["ok"],
              f"flash_attention at {key}'s shape (Dqk {dq}, Dv {dv}) fails its contract: {r}")
        if key == "stablelm":  # the new head dim windowed and at a ragged length too
            for name, (qq, kk, vv), window in (
                    ("w512", (q, k, v), 512),
                    ("S=2000", (q[:, :2000], k[:, :2000], v[:, :2000]), 0)):
                qq, kk, vv = (t.contiguous() for t in (qq, kk, vv))
                report[f"{key} {name}"] = r = bf16_contract(
                    flash_attention(qq, kk, vv, window=window),
                    flash_attention_plain(qq, kk, vv, window=window), qq, kk, vv, window=window)
                check(r["ok"], f"flash_attention at {key}'s shape, {name}, fails its contract: {r}")
            del qq, kk, vv
        n_bytes = 2 * b * s * (h * dq + hkv * dq + hkv * dv + h * dv)
        bound, by = bound_ms(n_bytes, 2 * b * h * (dq + dv) * visible_pairs(s, s, True, 0),
                             BF16_FLOPS)
        lib, backend, tried = sdpa_fused_ms(q, k, v)
        row.update({f"{key}_shape": [b, s, h, hkv, dq, dv],
                    f"{key}_max_abs_err": float((got.float() - want.float()).abs().max()),
                    f"{key}_ms": device_ms(lambda: flash_attention(q, k, v)),
                    f"{key}_plain_ms": device_ms(lambda: flash_attention_plain(q, k, v), reps=3),
                    f"{key}_bound_ms": bound, f"{key}_bound_by": by,
                    f"{key}_library_ms": lib, f"{key}_library_backend": backend})
        report[f"{key} sdpa"] = tried
        del q, k, v, got, want
    # the float32 kernel at the reduced MLA dims (the reduced configs' path)
    q, k = (randn(2, 512, 4, 48) for _ in range(2))
    v = randn(2, 512, 4, 32)
    row["mla_f32_gap"] = gap = rel_gap(flash_attention(q, k, v), flash_attention_plain(q, k, v))
    check(gap <= LM_REL, f"flash_attention float32 at (48, 32): {gap} of max > {LM_REL}")
    print(f"[kernels] flash_attention B={b} S={s} bf16 causal vs plain (contract, "
          f"kernels/flash_attention/contract.py), [B, S, H, Hkv, Dqk, Dv] in the *_shape keys: "
          f"MLA Dqk=192 Dv=128 and MHA D=128 (G=1), stablelm D=160 (also w512 and S=2000), "
          f"chatglm3 G=16, qwen2-vl G=6; SDPA's fused backends (each alone, or its refusal); "
          f"float32 at (48, 32) within {LM_REL} of max: {json.dumps(report)} {json.dumps(row)}")
    row.update(whisper_attention_kernels(randn))
    return row


def whisper_attention_kernels(randn) -> dict:
    """flash_attention at whisper-tiny's serving shapes (B=4, H = Hkv = 6,
    D = 64): the encoder's bidirectional self-attention (S = T = 1,500),
    the prefill's cross-attention (448 decoder queries over T = 1,500
    frames), a decode step's (one query over 1,500 frames) and the
    decoder's causal self-attention (S = T = 448); 1,500 keys leave a
    ragged last 128-key tile of 92. Each in bf16 against its plain version
    under the bf16 contract, with its device ms, bound and the fused SDPA
    backends' ms, and in float32 (the CUDA-core kernel) within LM_REL of
    max. Keys prefixed ``whisper_enc_``, ``whisper_cross_``,
    ``whisper_cross1_`` and ``whisper_self_``; shape [B, S, T, H, Hkv, D]."""
    cfg = get_config("whisper-tiny")
    b, t_enc, s_dec = SERVE_RUN["batch"], cfg.encoder_seq, cfg.max_decoder_seq
    h, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    cases = {"enc": (t_enc, t_enc, False), "cross": (s_dec, t_enc, False),
             "cross1": (1, t_enc, False), "self": (s_dec, s_dec, True)}
    row, report = {}, {}
    for name, (s, t, causal) in cases.items():
        key = f"whisper_{name}"
        q = randn(b, s, h, d).to(torch.bfloat16)
        k, v = (randn(b, t, hkv, d).to(torch.bfloat16) for _ in range(2))
        got = flash_attention(q, k, v, causal=causal)
        want = flash_attention_plain(q, k, v, causal=causal)
        report[key] = r = bf16_contract(got, want, q, k, v, causal)
        check(got.shape == (b, s, h, d) and r["ok"],
              f"flash_attention at whisper's {name} shape (S {s}, T {t}, causal {causal}) fails "
              f"its contract: {r}")
        qf, kf, vf = (x.float() for x in (q, k, v))
        report[f"{key} f32"] = gap = rel_gap(flash_attention(qf, kf, vf, causal=causal),
                                             flash_attention_plain(qf, kf, vf, causal=causal))
        check(gap <= LM_REL, f"flash_attention float32 at whisper's {name} shape: {gap} of max "
                             f"> {LM_REL}")
        n_bytes = 2 * b * (2 * s * h * d + 2 * t * hkv * d)
        bound, by = bound_ms(n_bytes, 4 * b * h * d * visible_pairs(s, t, causal, 0), BF16_FLOPS)
        lib, backend, tried = sdpa_fused_ms(q, k, v, causal)
        row.update({f"{key}_shape": [b, s, t, h, hkv, d], f"{key}_causal": causal,
                    f"{key}_max_abs_err": float((got.float() - want.float()).abs().max()),
                    f"{key}_ms": device_ms(lambda: flash_attention(q, k, v, causal=causal)),
                    f"{key}_plain_ms": device_ms(
                        lambda: flash_attention_plain(q, k, v, causal=causal), reps=3),
                    f"{key}_bound_ms": bound, f"{key}_bound_by": by,
                    f"{key}_library_ms": lib, f"{key}_library_backend": backend})
        report[f"{key} sdpa"] = tried
        del q, k, v, got, want, qf, kf, vf
    print(f"[kernels] flash_attention at whisper-tiny's shapes, [B, S, T, H, Hkv, D] in the "
          f"*_shape keys: encoder S=T=1500 and cross-attention S=448 and S=1 over T=1500 "
          f"non-causal, decoder self-attention S=T=448 causal; bf16 vs plain (contract, "
          f"kernels/flash_attention/contract.py) and float32 within {LM_REL} of max; SDPA's "
          f"fused backends (each alone, or its refusal): {json.dumps(report)} {json.dumps(row)}")
    return row


def phase_moe_layer(dev: torch.device) -> dict:
    """deepseek-moe-16b's MoE layer at the serving prefill's shape (N = 4 x
    2048 tokens, 64 experts top-6, capacity 960), bf16, random weights and
    unit-normal inputs: eager CUDA-event ms of the routing (router,
    softmax, top-k, queue positions), the dispatch into the (E, cap, D)
    buffer, the experts' batched products, the combine and the shared
    experts, and the share of routes dropped."""
    cfg = get_config("deepseek-moe-16b")
    b, s = SERVE_RUN["batch"], SERVE_RUN["prompt_len"]
    gen = torch.Generator(device=dev).manual_seed(3)
    p = layers.init_moe(gen, cfg)
    x = torch.randn((b * s, cfg.d_model), generator=gen, device=dev).to(torch.bfloat16)
    gate, idx, aux, pos, keep, cap = layers.moe_route(p, x, cfg)
    buf = layers.moe_dispatch(x, idx, pos, keep, cap, cfg.n_experts)
    out = layers.moe_experts(p, buf)
    ms = {"route": cuda_ms(lambda: layers.moe_route(p, x, cfg)),
          "dispatch": cuda_ms(lambda: layers.moe_dispatch(x, idx, pos, keep, cap, cfg.n_experts)),
          "experts": cuda_ms(lambda: layers.moe_experts(p, buf)),
          "combine": cuda_ms(lambda: layers.moe_combine(out, gate, idx, pos, keep, cap)),
          "shared": cuda_ms(lambda: layers.swiglu(p["shared"], x)),
          "layer": cuda_ms(lambda: layers.moe_apply_local(p, x[None], cfg))}
    dff = cfg.d_ff_expert
    expert_flops = 3 * 2 * cfg.n_experts * cap * cfg.d_model * dff
    row = {"tokens": b * s, "cap": cap, "dropped_share": float((~keep).float().mean()),
           "ms": ms, "experts_tflop_s": expert_flops / (ms["experts"] * 1e-3) / 1e12,
           "experts_bound_ms": 1e3 * expert_flops / BF16_FLOPS}
    print(f"[moe] deepseek-moe-16b MoE layer, N={b * s} tokens, E={cfg.n_experts} top-"
          f"{cfg.top_k}, cap {cap}, bf16, eager CUDA-event ms (dispatch = route + dispatch + "
          f"combine): {json.dumps(row)}")
    return row


class MoEDropCounter:
    """Within its ``with``, counts every MoE call's routes and dropped routes,
    prefill calls (more tokens than lanes) and decode steps apart, by
    wrapping ``layers.moe_route``; the dropped counts stay on the device
    until ``shares`` reads them."""

    def __init__(self, dev: torch.device, lanes: int):
        self.lanes = lanes
        self.routes = {"prefill": 0, "decode": 0}
        self.dropped = {k: torch.zeros((), dtype=torch.int64, device=dev) for k in self.routes}

    def __enter__(self):
        self.route = layers.moe_route

        def counted(p, xf, cfg):
            out = self.route(p, xf, cfg)
            kind = "prefill" if xf.shape[0] > self.lanes else "decode"
            self.routes[kind] += out[4].numel()
            self.dropped[kind] += (~out[4]).sum()
            return out

        layers.moe_route = counted
        return self

    def __exit__(self, *exc):
        layers.moe_route = self.route

    def shares(self) -> dict:
        return {k: {"routes": n, "dropped": int(self.dropped[k]),
                    "share": int(self.dropped[k]) / max(n, 1)} for k, n in self.routes.items()}


def expected_launches(cfg, prefills: int, decode_steps: int) -> dict[str, int]:
    """What a run of ``prefills`` prefills and ``decode_steps`` decode steps
    of ``cfg`` must launch of each kernel: a decoder-only prefill runs
    ssm_scan once a Mamba layer and flash_attention once an attention layer
    (jamba: both); whisper's runs flash_attention once an encoder layer and
    twice a decoder layer (self- and cross-attention), and each of its
    decode steps once a decoder layer (the cross-attention); nothing else."""
    counts = dict.fromkeys(kernels.KERNELS, 0)
    if cfg.encoder_decoder:
        counts["flash_attention"] = ((cfg.n_encoder_layers + 2 * cfg.n_layers) * prefills
                                     + cfg.n_layers * decode_steps)
        return counts
    specs = transformer.layer_specs(cfg)
    counts["ssm_scan"] = sum(sp.kind == "mamba" for sp in specs) * prefills
    counts["flash_attention"] = sum(sp.kind == "attn" for sp in specs) * prefills
    return counts


def phase_lm_reference(dev: torch.device) -> None:
    """The reduced float32 models on the card (through the kernels) against
    the same models on the CPU (plain versions): prefill and 4 greedy
    decode steps, on one batch from ``make_concrete_batch`` (qwen2-vl's
    vision embeddings and M-RoPE positions, whisper's frames included),
    with exactly ``expected_launches`` on the card. The MoE family's
    reduced MLA runs the float32 kernel at (Dqk, Dv) = (48, 32); whisper's
    the float32 kernel at (64, 64) non-causal, its decode steps at S = 1."""
    for arch in SERVE_ARCHS:
        cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
        bundle = get_model(cfg)
        cpu_model = bundle.init(torch.Generator().manual_seed(0))
        dev_model = copy.deepcopy(cpu_model).to(dev)
        batch = make_concrete_batch(cfg, "prefill", 2, 64, prng.PRNGKey(1))
        prefill, decode = bundle.make_prefill_step(), bundle.make_decode_step()
        kernels.reset_launch_counts()
        (want, cpu_cache), (got, dev_cache) = (prefill(m, batch) for m in (cpu_model, dev_model))
        gaps = [rel_gap(got.cpu(), want)]
        for _ in range(4):
            tok = torch.argmax(want, dim=-1)[:, None]
            want, cpu_cache = decode(cpu_model, cpu_cache, tok)
            got, dev_cache = decode(dev_model, dev_cache, tok)
            gaps.append(rel_gap(got.cpu(), want))
        counts = kernels.launch_counts()
        check(counts == expected_launches(cfg, 1, 4),
              f"{arch} reduced: launches {counts}, expected {expected_launches(cfg, 1, 4)}")
        check(max(gaps) <= REDUCED_REL[arch],
              f"{arch} reduced: card vs CPU logits {gaps} > {REDUCED_REL[arch]} of max")
        print(f"[lm] {arch} reduced float32 on the card vs the CPU: logits gap / max, prefill "
              f"then 4 decode steps {gaps} (contract {REDUCED_REL[arch]})")
    lm_refused_cases(dev)
    # the serving waves draw qwen2-vl's and whisper's batches on the card:
    # bitwise the host's
    b, s = SERVE_RUN["batch"], SERVE_RUN["prompt_len"]
    bits = lambda t: t.cpu().view(torch.int16) if t.dtype == torch.bfloat16 else t.cpu()  # noqa: E731
    for arch, embeds in (("qwen2-vl-2b", "vision_embeds"), ("whisper-tiny", "frames")):
        cfg = get_config(arch)
        t0 = time.perf_counter()
        host = make_concrete_batch(cfg, "prefill", b, s, prng.PRNGKey(7))
        host_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        card = make_concrete_batch(cfg, "prefill", b, s, prng.PRNGKey(7, device=dev))
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        check(list(card) == list(host)
              and all(card[k].device.type == "cuda" for k in (embeds, "tokens"))
              and ("positions" not in card or card["positions"].device.type == "cpu")
              and all(torch.equal(bits(card[k]), bits(host[k])) for k in host),
              f"{arch} make_concrete_batch on the card differs from the host draw")
        print(f"[lm] {arch} make_concrete_batch ({b}, {s}: {embeds} "
              f"{tuple(host[embeds].shape)} bf16, {', '.join(k for k in host if k != embeds)}) "
              f"drawn on the card bitwise the host draw; wall s host {host_s:.3f}, "
              f"card {card_s:.3f}")


def with_image_t_stream(batch: dict, cfg) -> dict:
    """A qwen2-vl prefill batch whose M-RoPE positions are a real prompt's
    (``image_positions``: the image's tokens at t = 0, the text after from
    t = the raster's width), for every lane."""
    nv = cfg.n_vision_tokens
    grid = math.isqrt(nv)
    pos = image_positions(nv, batch["positions"].shape[1], grid)
    return dict(batch, positions=pos[None].expand_as(batch["positions"]).contiguous())


def lm_refused_cases(dev: torch.device) -> None:
    """What the port refused before this slice, reduced in float32 on the
    card against the same models on the CPU, launches held to
    ``expected_launches``: qwen2-vl on a real image's t stream (prefill + 4
    decode steps; attention masked by position); falcon-mamba and jamba, a
    prefill, a second prefill continuing its cache (the scan from its
    carried state; jamba's attention restarts) and 2 decode steps;
    granite-3-8b with tied embeddings, prefill + 4 decode steps and 2
    train steps (``train_contract`` against the CPU's)."""
    from repro_torch.launch.train import make_optimizer
    from repro_torch.models.api import param_tree

    for arch in ("qwen2-vl-2b", "falcon-mamba-7b", "jamba-v0.1-52b", "granite-3-8b"):
        cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32",
                                  tie_embeddings=arch == "granite-3-8b")
        bundle = get_model(cfg)
        cpu_model = bundle.init(torch.Generator().manual_seed(0))
        dev_model = copy.deepcopy(cpu_model).to(dev)
        batch = make_concrete_batch(cfg, "prefill", 2, 64, prng.PRNGKey(1))
        if cfg.frontend == "vision_stub":
            batch = with_image_t_stream(batch, cfg)
        kernels.reset_launch_counts()
        if cfg.ssm:  # two prefills, the second continuing the first's cache
            runs = []
            for m in (cpu_model, dev_model):
                toks = batch["tokens"].to(m.device)
                _, c, _ = transformer.forward(m, cfg, toks[:, :40], mode="prefill")
                logits, c, _ = transformer.forward(m, cfg, toks[:, 40:], cache=c, mode="prefill")
                runs.append((logits[:, -1], c))
            (want, cpu_cache), (got, dev_cache) = runs
            prefills, steps = 2, 2
        else:
            prefill = bundle.make_prefill_step()
            (want, cpu_cache), (got, dev_cache) = (prefill(m, batch)
                                                   for m in (cpu_model, dev_model))
            prefills, steps = 1, 4
        decode = bundle.make_decode_step()
        gaps = [rel_gap(got.cpu(), want)]
        for _ in range(steps):
            tok = torch.argmax(want, dim=-1)[:, None]
            want, cpu_cache = decode(cpu_model, cpu_cache, tok)
            got, dev_cache = decode(dev_model, dev_cache, tok)
            gaps.append(rel_gap(got.cpu(), want))
        counts = kernels.launch_counts()
        expected = expected_launches(cfg, prefills, steps)
        what = {"qwen2-vl-2b": "an image's t stream", "granite-3-8b": "tied embeddings"}.get(
            arch, "a prefill continuing its cache")
        check(counts == expected, f"{arch} reduced, {what}: launches {counts}, expected {expected}")
        check(max(gaps) <= REDUCED_REL[arch],
              f"{arch} reduced, {what}: card vs CPU logits {gaps} > {REDUCED_REL[arch]} of max")
        line = (f"[lm] {arch} reduced float32, {what}, on the card vs the CPU: logits gap / max, "
                f"{prefills} prefill(s) then {steps} decode steps {gaps} (contract "
                f"{REDUCED_REL[arch]}); launches {json.dumps(counts)}")
        if cfg.tie_embeddings:  # and two train steps
            train_batches = [make_concrete_batch(cfg, "train", 2, 64, prng.PRNGKey(2 + i))
                             for i in range(2)]
            out = []
            for m in (cpu_model, dev_model):
                opt = make_optimizer(TRAIN_RUN["lr"], 2)
                state, losses, step = opt.init(param_tree(m)), [], bundle.make_train_step(opt)
                for tb in train_batches:
                    m, state, loss = step(m, state, {k: v.to(m.device) for k, v in tb.items()})
                    losses.append(float(loss))
                out.append((losses, {k: p.detach().cpu() for k, p in param_tree(m).items()},
                            {k: t.cpu() for k, t in state[1].nu.items()}))
            ok, readings = train_contract(cfg, out[1][:2], out[0], TRAIN_RUN["lr"], LM_REL)
            check(ok, f"{arch} tied, 2 train steps: card vs CPU outside the contract {readings}")
            line += f"; 2 train steps card vs CPU {json.dumps(readings)}"
        print(line)
        del cpu_model, dev_model


@contextlib.contextmanager
def image_t_stream_batches():
    """``launch.serve``'s batch draw with qwen2-vl's positions a real
    prompt's (``with_image_t_stream``), inside the block."""
    import repro_torch.launch.serve as serve_mod

    draw = serve_mod.make_concrete_batch

    def image_draw(cfg, *args, **kw):
        batch = draw(cfg, *args, **kw)
        return with_image_t_stream(batch, cfg) if "positions" in batch else batch

    serve_mod.make_concrete_batch = image_draw
    try:
        yield
    finally:
        serve_mod.make_concrete_batch = draw


def phase_chunked_prefill(dev: torch.device) -> dict[str, int]:
    """falcon-mamba-7b at full width and depth, bf16, B = SERVE_RUN's batch:
    a 2 x 1,024 chunked prefill (the second continuing the first's cache:
    the scan from its carried state) then 32 greedy tokens, against one
    2,048-token prefill and its 32 tokens: the last position's logits gap
    over max and the share of equal tokens. Kernel counts zeroed just
    before, read just after, held to ``expected_launches``. Returns them."""
    cfg = get_config(CHUNKED_PREFILL["arch"])
    b, s, chunks = SERVE_RUN["batch"], SERVE_RUN["prompt_len"], CHUNKED_PREFILL["chunks"]
    max_new = CHUNKED_PREFILL["max_new"]
    gc.collect()
    torch.cuda.empty_cache()
    model = get_model(cfg).init(torch.Generator(device=dev).manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (b, s), generator=torch.Generator().manual_seed(5))
    toks = toks.to(dev)
    decode = transformer.make_decode_step(cfg)
    kernels.reset_launch_counts()
    runs, ms = [], []
    for pieces in (1, chunks):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        cache = None
        for part in toks.chunk(pieces, dim=1):
            logits, cache, _ = transformer.forward(model, cfg, part, cache=cache, mode="prefill")
            last = logits[:, -1].clone()
            del logits
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
        out, tok = [], torch.argmax(last, dim=-1)[:, None]
        for _ in range(max_new):
            out.append(tok)
            step_logits, cache = decode(model, cache, tok)
            tok = torch.argmax(step_logits, dim=-1)[:, None]
        runs.append((last, torch.cat(out, dim=1).cpu()))
        del cache
    counts = kernels.launch_counts()
    expected = expected_launches(cfg, 1 + chunks, 2 * max_new)
    check(counts == expected, f"chunked prefill: launches {counts}, expected {expected}")
    (whole, whole_toks), (chunked, chunked_toks) = runs
    gap = rel_gap(chunked, whole)
    equal = float((whole_toks == chunked_toks).float().mean())
    check(bool(torch.isfinite(chunked).all()) and gap <= 2.0 ** -5,
          f"chunked prefill: last logits gap {gap} over max (bf16's 2^-5)")
    print(f"[serve] {cfg.name} full width bf16, B={b}: one {s}-token prefill {ms[0]:.3f} ms vs "
          f"{chunks} x {s // chunks} chunked (the second continuing the first's cache) "
          f"{ms[1]:.3f} ms; last-position logits gap / max {gap:.4g}; greedy tokens equal "
          f"{equal:.4f} of {b} x {max_new}; launches {json.dumps(counts)}")
    del model, runs
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def phase_serve(dev: torch.device, arch: str, label: str | None = None) -> dict[str, int]:
    """One full-width serving run of ``arch`` (full depth but for
    ``SERVE_LAYERS``) through ``repro_torch.launch.serve.serve``, kernel
    counts zeroed just before and read just after and held to
    ``expected_launches``; an MoE arch's dropped routes counted at prefill
    and decode; the model is freed before the next arch. ``label`` names
    the run in the lines printed (default ``arch``)."""
    cfg, name = get_config(arch), label or arch
    if arch in SERVE_LAYERS:
        cfg = dataclasses.replace(cfg, n_layers=SERVE_LAYERS[arch])
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    drops = MoEDropCounter(dev, SERVE_RUN["batch"])
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with drops:
        stats = serve(cfg, device=dev, **SERVE_RUN)
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    n_req, max_new = SERVE_RUN["requests"], SERVE_RUN["max_new"]
    check(stats["n_requests"] == n_req and stats["logits_finite"], f"{name}: serve stats {stats}")
    check(stats["tokens"] == sum(stats["lens"]) and all(1 <= n <= max_new for n in stats["lens"]),
          f"{name}: token accounting {stats['lens']} {stats['tokens']}")
    check(all(0 <= t < cfg.vocab_padded for out in stats["outputs"] for t in out),
          f"{name}: token ids outside the vocabulary")
    want = expected_launches(cfg, stats["prefill_calls"], len(stats["decode_ms"]))
    check(stats["prefill_calls"] > 0 and counts == want,
          f"{name}: launches {counts} for {stats['prefill_calls']} prefills and "
          f"{len(stats['decode_ms'])} decode steps, expected {want}")
    if cfg.moe:
        shares = drops.shares()
        check(shares["prefill"]["routes"] > 0 and shares["decode"]["routes"] > 0,
              f"{name}: no MoE routes counted {shares}")
        print(f"[serve] {name} MoE routes dropped (capacity over each call's tokens): "
              f"{json.dumps(shares)}")
    depth = f", depth cut to {cfg.n_layers}" if arch in SERVE_LAYERS else ""
    prompt = SERVE_RUN["prompt_len"]
    if cfg.encoder_decoder:
        prompt = (f"{min(prompt, cfg.max_decoder_seq)} decoder tokens over {cfg.encoder_seq} "
                  f"frames, {cfg.n_encoder_layers} encoder layers")
    print(f"[serve] {name} full width{depth} ({cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.param_count() / 1e9:.2f} B params, {cfg.dtype}): {n_req} requests, batch "
          f"{SERVE_RUN['batch']}, prompt {prompt}, max_new {max_new}; "
          f"lens {stats['lens']}, {stats['prefill_calls']} prefills, "
          f"{len(stats['decode_ms'])} decode steps")
    print(f"[serve] {name} prefill ms (CUDA events) median {statistics.median(stats['prefill_ms']):.3f} "
          f"all {[round(t, 3) for t in stats['prefill_ms']]}; decode step ms median "
          f"{statistics.median(stats['decode_ms']):.3f} over {len(stats['decode_ms'])} steps "
          f"(min {min(stats['decode_ms']):.3f}, max {max(stats['decode_ms']):.3f})")
    print(f"[serve] {name} {stats['tok_per_s']:.2f} tok/s, latency p50 {stats['latency_p50_ms']:.1f} "
          f"ms p99 {stats['latency_p99_ms']:.1f} ms, serving span {stats['wall_s']:.2f} s "
          f"(with init {wall:.2f} s), peak memory {peak / 2**30:.2f} GiB, launches {json.dumps(counts)}")
    del stats
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def phase_goldens(dev: torch.device) -> None:
    """The committed golden configurations on the card: the selections must
    be the committed bitstrings; accuracy is printed beside the golden."""
    ds = make_federated_classification(**SMALL_DS)
    gaps = {}
    with prng.threefry_partitionable(False):
        for name, (cfg, acc_hex, want_bits) in sorted(GOLDEN.items()):
            h = run_federated(ds, FLConfig(rounds=5, epochs=1, **cfg), device=dev)
            got_bits = ["".join("1" if b else "0" for b in row) for row in h.selected]
            check(got_bits == want_bits, f"golden {name}: selected {got_bits} != {want_bits}")
            want_acc = np.frombuffer(bytes.fromhex(acc_hex), np.dtype("<f4"))
            gaps[name] = float(np.abs(h.accuracy_mean.astype(np.float32) - want_acc).max())
            print(f"[golden] {name} selected ok; accuracy_mean "
                  f"{np.round(h.accuracy_mean, 6).tolist()} golden {np.round(want_acc, 6).tolist()}")
    print(f"[golden] largest accuracy_mean gap to the committed goldens: {max(gaps.values()):.3g} "
          f"{json.dumps(gaps)}")


def phase_main_path(dev: torch.device) -> dict[str, int]:
    """UCI-HAR at full width: ACSP-FL + DLD + int8 (5 rounds), then
    FedAvg float32 (3 rounds), each with the kernel counts zeroed just
    before and read just after."""
    data = make_har_dataset("uci-har", seed=0)
    runs = [("acsp-fl+dld+int8", FLConfig(codec="int8", rounds=5, epochs=2)),
            ("fedavg+none+float32", FLConfig(strategy="fedavg", personalization="none",
                                             fraction=1.0, rounds=3, epochs=2))]
    main_counts = None
    for name, cfg in runs:
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        h = run_federated(data, cfg, device=dev)
        counts = kernels.launch_counts()
        check(np.isfinite(h.accuracy_mean).all(), f"{name}: non-finite accuracy")
        check(h.accuracy_per_client.shape == (cfg.rounds, data.n_clients), f"{name}: history shape")
        check(h.accuracy_mean[-1] > h.accuracy_mean[0], f"{name}: accuracy did not rise")
        if main_counts is None:
            check(all(counts[k] > 0 for k in FL_KERNELS), f"{name}: a kernel never launched {counts}")
            check(counts["quantize"] == counts["dequantize"] == cfg.rounds,
                  f"{name}: quantize and dequantize must launch once a round {counts}")
            main_counts = counts
        else:
            check(counts["masked_aggregate"] > 0 and counts["quantize"] == 0,
                  f"{name}: float32 rounds must aggregate through the kernel only {counts}")
        check(counts["masked_aggregate"] == cfg.rounds,
              f"{name}: masked_aggregate must launch once a round {counts}")
        print(f"[main] {name} uci-har C={data.n_clients} har-mlp {'-'.join(map(str, HAR_MLP))}: "
              f"accuracy_mean {np.round(h.accuracy_mean, 4).tolist()} "
              f"selected/round {h.selected.sum(axis=1).tolist()} "
              f"round wall median {1e3 * statistics.median(h.wall_time[1:]):.1f} ms "
              f"(first {1e3 * h.wall_time[0]:.1f} ms) "
              f"peak memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB "
              f"launches {json.dumps(counts)}")
    return main_counts


def history_diff(h, ref) -> list[str]:
    """The FLHistory fields where ``h`` differs from ``ref`` (bitwise; the
    measured wall_time aside)."""
    return [f for f in ref._fields if f != "wall_time"
            and not np.array_equal(np.asarray(getattr(h, f)), np.asarray(getattr(ref, f)))]


def phase_loop(dev: torch.device, card: str) -> None:
    """The UCI-HAR main path (ACSP-FL + DLD + int8) in fused chunks of
    rounds: scan_chunk 1, 2, 5 and 3 over 5 rounds must give one history bit
    for bit (every chunk after the first is a CUDA-graph replay), with one
    launch of each FL kernel a round; a cohort of 10 of the 30 clients and
    evaluation every second round must run, stay finite and give the same
    history at scan_chunk 1 and 5; 20-round runs give the round wall time by
    chunk size. Kernel counts are zeroed just before each run and read just
    after."""
    data = make_har_dataset("uci-har", seed=0)

    def run(rounds, chunk, **kw):
        kernels.reset_launch_counts()
        h = run_federated(data, FLConfig(codec="int8", rounds=rounds, epochs=2, scan_chunk=chunk,
                                         **kw), device=dev)
        counts = kernels.launch_counts()
        check(np.isfinite(h.accuracy_mean).all(), f"[loop] scan_chunk={chunk} {kw}: non-finite")
        check(all(counts[k] == rounds for k in FL_KERNELS),
              f"[loop] scan_chunk={chunk} {kw}: each FL kernel must launch once a round {counts}")
        return h, {k: counts[k] / rounds for k in FL_KERNELS}

    ref = None
    for chunk in LOOP_CHUNKS:
        h, per_round = run(5, chunk)
        ref = ref or h
        diff = history_diff(h, ref)
        check(not diff, f"[loop] scan_chunk={chunk}: history differs from scan_chunk=1 in {diff}")
        print(f"[loop] acsp-fl+dld+int8 uci-har 5 rounds scan_chunk={chunk}: history bitwise "
              f"equal to scan_chunk=1 (selected, pms, tx, wire, accuracy: every field); "
              f"accuracy_mean {np.round(h.accuracy_mean, 4).tolist()} launches per round "
              f"{json.dumps(per_round)}")
    for name, kw in (("cohort_size=10", dict(cohort_size=10)), ("eval_every=2", dict(eval_every=2))):
        (h1, _), (h5, per_round) = run(5, 1, **kw), run(5, 5, **kw)
        diff = history_diff(h5, h1)
        check(not diff, f"[loop] {name}: scan_chunk=5 differs from scan_chunk=1 in {diff}")
        acc = h1.accuracy_per_client
        if "cohort_size" in kw:
            check((h1.in_flight == 10).all() and (h1.selected.sum(axis=1) <= 10).all(),
                  f"[loop] {name}: cohort of {h1.in_flight} lanes, {h1.selected.sum(axis=1)} selected")
        else:
            check(np.array_equal(acc[1], acc[0]) and np.array_equal(acc[3], acc[2])
                  and not np.array_equal(acc[2], acc[1]),
                  f"[loop] {name}: the odd rounds must carry the even rounds' accuracy")
        print(f"[loop] {name}: runs, finite, scan_chunk=5 bitwise equal to scan_chunk=1; "
              f"accuracy_mean {np.round(h1.accuracy_mean, 4).tolist()} selected/round "
              f"{h1.selected.sum(axis=1).tolist()} launches per round {json.dumps(per_round)}")
    walls, ref = {}, None
    for chunk in LOOP_TIMED["chunks"]:
        h, per_round = run(LOOP_TIMED["rounds"], chunk)
        ref = ref or h
        diff = history_diff(h, ref)
        check(not diff, f"[loop] 20 rounds scan_chunk={chunk}: differs from scan_chunk=1 in {diff}")
        # the first chunk carries the warm-up and the capture of the graph
        walls[chunk] = dict(median_ms=1e3 * statistics.median(h.wall_time[max(chunk, 1):]),
                            first_chunk_ms=1e3 * float(h.wall_time[:chunk].sum()))
    print(f"[loop] {card}: acsp-fl+dld+int8 uci-har C={data.n_clients} "
          f"{LOOP_TIMED['rounds']} rounds, host wall ms a round past the first chunk (median) "
          f"and of the first chunk, by scan_chunk (histories bitwise equal): {json.dumps(walls)}")


def phase_merge(dev: torch.device) -> dict:
    """The async staleness merge at full width: har-mlp's 8 leaves at M = 30
    slots in one launch of masked_aggregate's kernel (snapshot subtracted in
    the load loop, the global layer as the base), bitwise its plain
    version, with landing lanes, with none, and with a layer nobody shared;
    its device ms beside its bound."""
    gen = torch.Generator(device=dev).manual_seed(2)
    snaps = [torch.randn((K,) + s, generator=gen, device=dev) for s in LEAVES]
    xs = [sn + 0.01 * torch.randn(sn.shape, generator=gen, device=dev) for sn in snaps]
    bases = [torch.randn(s, generator=gen, device=dev) for s in LEAVES]
    land = torch.rand(K, generator=gen, device=dev) < 0.5
    counts = torch.randint(224, 328, (K,), generator=gen, device=dev).float()
    stale = torch.randint(0, 6, (K,), generator=gen, device=dev).float()
    w = land.float() * counts * torch.pow(1.0 + stale, -0.5)
    share = torch.rand((K, len(HAR_MLP) - 1), generator=gen, device=dev) < 0.6
    share[:, 2] = False
    table = (w[None] * share.T.float()).contiguous()
    rows = [j for j in range(len(HAR_MLP) - 1) for _ in ("b", "w")]
    err = 0.0
    for name, wt in (("landing", table), ("no landing", torch.zeros_like(table))):
        kernels.reset_launch_counts()
        got = masked_aggregate_leaves(xs, wt, rows, snapshots=snaps, bases=bases)
        check(kernels.launch_counts()["masked_aggregate"] == 1,
              f"[merge] {name}: {kernels.launch_counts()['masked_aggregate']} launches")
        want = masked_aggregate_leaves_plain(xs, wt, rows, snapshots=snaps, bases=bases)
        unfused = masked_aggregate_leaves([x - sn for x, sn in zip(xs, snaps)], wt, rows,
                                          bases=bases)
        for i, (g, p, u) in enumerate(zip(got, want, unfused)):
            check(torch.equal(g, p), f"[merge] {name} leaf {i} differs from its plain version")
            check(torch.equal(g, u), f"[merge] {name} leaf {i}: the fused snapshot differs from "
                  f"the deltas passed")
            if rows[i] == 2 or name == "no landing":
                check(torch.equal(g, bases[i]), f"[merge] {name} leaf {i}: base not returned "
                      f"exactly")
            err = max(err, float((g - p).abs().max()))

    # the edge mode: E = 3 and 8 groups of unsorted slot clients, edge 1
    # weightless, with and without landings
    for n_edges in EDGE_ES[1:]:
        ids = edge_cohort(gen, K, n_edges, dev)
        for name, wt in (("landing", table * (ids != 1).float()[None]),
                         ("no landing", torch.zeros_like(table))):
            kernels.reset_launch_counts()
            got = masked_aggregate_leaves(xs, wt, rows, snapshots=snaps, bases=bases,
                                          edge_ids=ids, n_edges=n_edges)
            check(kernels.launch_counts()["masked_aggregate"] == 1,
                  f"[merge] edge mode E={n_edges} {name}: "
                  f"{kernels.launch_counts()['masked_aggregate']} launches")
            want = masked_aggregate_leaves_plain(xs, wt, rows, snapshots=snaps, bases=bases,
                                                 edge_ids=ids, n_edges=n_edges)
            for i, (g, p) in enumerate(zip(got, want)):
                check(torch.equal(g, p), f"[merge] edge mode E={n_edges} {name} leaf {i} "
                      f"differs from its plain version")
                if rows[i] == 2 or name == "no landing":
                    check(torch.equal(g, bases[i]), f"[merge] edge mode E={n_edges} {name} leaf "
                          f"{i}: base not returned exactly")

    def run(): return masked_aggregate_leaves(xs, table, rows, snapshots=snaps, bases=bases)
    def run_plain(): return masked_aggregate_leaves_plain(xs, table, rows, snapshots=snaps,
                                                          bases=bases)
    def run_edges(): return masked_aggregate_leaves(xs, table, rows, snapshots=snaps, bases=bases,
                                                    edge_ids=ids, n_edges=EDGE_ES[-1])
    elems = sum(x.numel() for x in xs)
    p_total = sum(b.numel() for b in bases)
    # x and the snapshots read, the weight table read, the base read and the
    # merged leaves written; a subtraction, a product and an add an element
    m_bound, m_by = bound_ms(2 * elems * 4 + table.numel() * 4 + 2 * p_total * 4,
                             3 * elems + 2 * p_total)
    row = dict(merge_ms=device_ms(run), merge_plain_ms=device_ms(run_plain, reps=5),
               merge_bound_ms=m_bound, merge_bound_by=m_by, merge_max_abs_err=err,
               edge_merge_ms=device_ms(run_edges))
    print(f"[merge] staleness merge, har-mlp's 8 leaves at M={K} slots: one launch, bitwise "
          f"equal to the plain version with landing lanes and with none, the fused snapshot "
          f"bitwise the deltas passed, layer 2 (shared by nobody) returns the base exactly; "
          f"device ms {row['merge_ms']:.5f} (bound {m_bound:.5f}, {m_by}; plain "
          f"{row['merge_plain_ms']:.4f}); edge mode E={EDGE_ES[1:]} (unsorted slot clients, "
          f"edge 1 weightless): one launch, bitwise its plain version, the base exact without "
          f"landings; device ms at E={EDGE_ES[-1]} {row['edge_merge_ms']:.5f} (the same bound)")
    return row


def check_same_as_cpu(h, ref, what: str) -> float:
    """The card's run against the port on the CPU: the EXACT_FIELDS equal,
    accuracy within 1e-6; returns the accuracy gap."""
    diff = [f for f in EXACT_FIELDS
            if not np.array_equal(np.asarray(getattr(h, f)), np.asarray(getattr(ref, f)))]
    check(not diff, f"{what}: the card differs from the CPU in {diff}")
    gap = float(np.abs(h.accuracy_per_client - ref.accuracy_per_client).max())
    check(gap <= 1e-6, f"{what}: accuracy {gap} from the CPU's")
    return gap


def phase_async(dev: torch.device, card: str) -> int:
    """The async scheduler's main path: UCI-HAR, har-mlp, ACSP-FL + DLD +
    int8, 30 slots, buffer_k 15, 20 events, the kernel counts zeroed just
    before and read just after; a second run must give the same history
    bit for bit; the small fixture on the card against the CPU. Returns the
    merge launches of the main run."""
    data = make_har_dataset("uci-har", seed=0)
    cfg = FLConfig(rounds=ASYNC_EVENTS, **ASYNC_CFG)
    kernels.reset_launch_counts()
    h = run_federated(data, cfg, device=dev)
    counts = kernels.launch_counts()
    check(len(h.accuracy_mean) == ASYNC_EVENTS and np.isfinite(h.accuracy_per_client).all(),
          f"[async] history of {len(h.accuracy_mean)} events, finite "
          f"{np.isfinite(h.accuracy_per_client).all()}")
    check((h.staleness_mean > 0).any(), f"[async] no stale landing {h.staleness_mean}")
    check((np.diff(h.sim_clock) >= 0).all(), "[async] the simulated clock went back")
    check(all(counts[k] == ASYNC_EVENTS for k in FL_KERNELS),
          f"[async] each FL kernel must launch once an event {counts}")
    h2 = run_federated(data, cfg, device=dev)
    diff = history_diff(h2, h)
    check(not diff, f"[async] a second run differs in {diff}")
    small = make_federated_classification(**SMALL_DS)
    scfg = FLConfig(rounds=5, epochs=1, **SMALL_ASYNC)
    gap = check_same_as_cpu(run_federated(small, scfg, device=dev),
                            run_federated(small, scfg, device="cpu"), "[async] small fixture")
    prof = profile_async_events(data, FLConfig(rounds=6, **ASYNC_CFG), dev)
    print(f"[async] {card}: acsp-fl+dld+int8 uci-har C={data.n_clients} M={data.n_clients} "
          f"buffer_k={ASYNC_CFG['buffer_k']} {ASYNC_EVENTS} events: accuracy_mean "
          f"{np.round(h.accuracy_mean, 4).tolist()} staleness_mean "
          f"{np.round(h.staleness_mean, 3).tolist()} sim_clock end {h.sim_clock[-1]:.3f} s; "
          f"launches {json.dumps(counts)}; a second run bitwise equal; event wall median "
          f"{1e3 * statistics.median(h.wall_time[1:]):.1f} ms (first {1e3 * h.wall_time[0]:.1f} "
          f"ms, second run median {1e3 * statistics.median(h2.wall_time[1:]):.1f} ms); small "
          f"fixture (8 clients, 5 events, buffer_k 2, 4 slots) card vs CPU: exact fields equal, "
          f"accuracy gap {gap:.3g}")
    print(f"[async] device per event (torch.profiler over {prof['events']} events, the first "
          f"included): {json.dumps(prof)}")
    return counts["masked_aggregate"]


class FiniteProbe(Aggregator):
    """Wraps a pipeline's aggregator and keeps, a round or event, whether
    the new global model is finite (a device bool, read after the run; the
    fault paths run their steps eagerly, with no graph capture)."""

    def __init__(self, inner: Aggregator):
        self.inner, self.finite = inner, []

    def aggregate(self, ctx, env):
        ctx = self.inner.aggregate(ctx, env)
        self.finite.append(torch.stack([torch.isfinite(leaf).all()
                                        for leaf in tree_leaves(ctx.new_global)]).all())
        return ctx

    def first_nonfinite(self) -> int | None:
        """The first round whose global model is not finite (None: none)."""
        bad = [i for i, ok in enumerate(torch.stack(self.finite).cpu().tolist()) if not ok]
        return bad[0] if bad else None


def probed_run(data, cfg: FLConfig, device) -> tuple:
    """``run_federated`` with a FiniteProbe around cfg's aggregator."""
    pipe = pipeline_from_config(cfg)
    probe = FiniteProbe(pipe.aggregator)
    h = run_federated(data, cfg, device=device, pipeline=dataclasses.replace(pipe,
                                                                              aggregator=probe))
    return h, probe.first_nonfinite()


def phase_faults(dev: torch.device) -> None:
    """Fault injection under both schedulers on the UCI-HAR main path (5
    rounds or events): finite, corrupted updates rejected, each FL kernel
    once a round. The small fixture on the card against the CPU, twice:
    with crashes, deadlines and slowdowns but no corruption, where the
    global model stays finite and every round compares the fault path's
    aggregation; and with corruption too, where the reference's guard lets
    a NaN/Inf update poison the merge (NaN * 0; ROADMAP queue 3), so both
    must poison the same round and only the rounds before it compare the
    aggregation."""
    data = make_har_dataset("uci-har", seed=0)
    small = make_federated_classification(**SMALL_DS)

    def cfg(mode_kw, faults=FAULTS, slow=FAULTS_SLOW, max_norm=0.0, **kw):
        f = FLConfig(**mode_kw, **kw, **faults)
        return dataclasses.replace(f, faults=dataclasses.replace(
            f.faults, slow_rate=slow, max_update_norm=max_norm))

    for mode, mode_kw in (("sync", {}), ("async", dict(scheduler="async", buffer_k=15))):
        kernels.reset_launch_counts()
        h, bad = probed_run(data, cfg(mode_kw, codec="int8", rounds=5, epochs=2), dev)
        counts = kernels.launch_counts()
        n = len(h.accuracy_mean)
        check(n == 5 and np.isfinite(h.accuracy_per_client).all(), f"[faults] {mode}: {n} rounds")
        check(h.rejected_updates.sum() > 0, f"[faults] {mode}: no update rejected")
        check(counts["masked_aggregate"] == 5, f"[faults] {mode}: launches {counts}")
        plan = compile_fault_plan(cfg(mode_kw).faults, 0, 0, data.n_clients)
        # no corruption: the global model stays finite, every round compares
        ccfg = cfg(SMALL_FAULT_MODES[mode], faults=SMALL_FAULTS[mode], slow=SMALL_FAULTS_SLOW,
                   rounds=5, epochs=1, seed=1)
        (hc, bad_c), (hr, bad_r) = probed_run(small, ccfg, dev), probed_run(small, ccfg, "cpu")
        check(bad_c is None and bad_r is None,
              f"[faults] {mode} small fixture without corruption: non-finite global model at "
              f"round {bad_c} (card) / {bad_r} (CPU)")
        gap_clean = check_same_as_cpu(hc, hr, f"[faults] {mode} small fixture, no corruption")
        if mode == "sync":
            check((hc.selected.sum(axis=1) < small.n_clients).any(),
                  f"[faults] sync small fixture: no client cut {hc.selected.sum(axis=1)}")
        # with corruption: both poison the same round, and a rejection
        # before it compares the guard's path on a finite model
        scfg = cfg(dict(SMALL_ASYNC) if mode == "async" else dict(codec="int8"),
                   faults=SMALL_CORRUPT[mode], max_norm=SMALL_MAX_NORM, rounds=5, epochs=1)
        (hs, bad_s), (hr, bad_r) = probed_run(small, scfg, dev), probed_run(small, scfg, "cpu")
        check(bad_s == bad_r, f"[faults] {mode} small fixture with corruption: the global model "
                              f"turns non-finite at round {bad_s} on the card, {bad_r} on the CPU")
        gap = check_same_as_cpu(hs, hr, f"[faults] {mode} small fixture")
        clean_rounds = 5 if bad_s is None else bad_s
        check(hs.rejected_updates[:clean_rounds].sum() > 0,
              f"[faults] {mode} small fixture: no rejection before round {clean_rounds} "
              f"{hs.rejected_updates}")
        print(f"[faults] {mode} uci-har {json.dumps(FAULTS)} slow_rate {FAULTS_SLOW}: landed or "
              f"selected/round {h.selected.sum(axis=1).tolist()} rejected "
              f"{h.rejected_updates.tolist()} round_time {np.round(h.round_time, 4).tolist()} "
              f"(round 0's plan: {int(plan.crash.sum())} crash, {int((plan.slow > 1).sum())} "
              f"slow, {int((plan.corrupt > 0).sum())} corrupt of {data.n_clients}); global model "
              f"non-finite from round {bad}; launches {json.dumps(counts)}")
        print(f"[faults] {mode} small fixture card vs CPU without corruption "
              f"({json.dumps(SMALL_FAULTS[mode])} slow_rate {SMALL_FAULTS_SLOW}): exact fields "
              f"equal, global model finite every round, selected/round "
              f"{hc.selected.sum(axis=1).tolist()}, accuracy gap {gap_clean:.3g}; with corruption "
              f"({json.dumps(SMALL_CORRUPT[mode])} max_update_norm {SMALL_MAX_NORM}): exact fields "
              f"equal, accuracy gap {gap:.3g}, rejected {hs.rejected_updates.tolist()}, global "
              f"model non-finite from round {bad_s} on both")


def phase_resume(dev: torch.device) -> None:
    """Checkpoint/resume on the card at full width: stopped at round 2,
    resumed to 5, bitwise the uninterrupted run (sync int8 at scan_chunk 1
    and 3, async int8)."""
    data = make_har_dataset("uci-har", seed=0)
    root = Path(__file__).resolve().parent / "build"
    root.mkdir(exist_ok=True)
    cases = (("sync scan_chunk=1", dict(codec="int8", epochs=2, scan_chunk=1)),
             ("sync scan_chunk=3", dict(codec="int8", epochs=2, scan_chunk=3)),
             ("async int8", ASYNC_CFG))
    for name, kw in cases:
        d = tempfile.mkdtemp(prefix="smoke_ckpt_", dir=root)
        try:
            full = run_federated(data, FLConfig(rounds=5, **kw), device=dev)
            run_federated(data, FLConfig(rounds=2, **kw), device=dev, checkpoint_every=2,
                          checkpoint_dir=d)
            res = run_federated(data, FLConfig(rounds=5, **kw), device=dev, resume_from=d)
        finally:
            shutil.rmtree(d, ignore_errors=True)
        diff = history_diff(res, full)
        check(not diff, f"[resume] {name}: the resumed run differs in {diff}")
        print(f"[resume] {name} uci-har: stopped at 2, resumed to 5, bitwise the uninterrupted "
              f"run (every field but wall_time); accuracy_mean "
              f"{np.round(res.accuracy_mean, 4).tolist()}")


def phase_population(dev: torch.device, card: str) -> int:
    """The host-resident population plane and edge aggregation. (a) The
    UCI-HAR int8 main path (5 rounds): host_population=1 bitwise the
    device-resident run; edge_groups=1 the same trajectory with its hop
    accounted; edge_groups=3 bitwise between the two planes, one launch of
    each FL kernel a round; a cohort of 10 with eval_chunk=8 against
    eval_chunk=0 (its gap printed); async (30 slots, buffer_k 15, 20
    events) bitwise the device-resident run. (b) The million-client tier's
    configuration at C = 5,000 and 50,000 (the larger routes to the host
    plane at the threshold): round wall, staging and peak device memory,
    the larger C's peak within POP_PEAK_RATIO of the smaller's. (c) Its
    trees memmap-backed at C = 2,000 (acsp-fl + dld + int8): bitwise the
    RAM-backed run. Kernel counts are zeroed just before each run and read
    just after. Returns the masked_aggregate launches of the E = 3 run."""
    data = make_har_dataset("uci-har", seed=0)

    def run(**kw):
        kernels.reset_launch_counts()
        h = run_federated(data, FLConfig(**{**dict(codec="int8", rounds=5, epochs=2), **kw}),
                          device=dev)
        counts = kernels.launch_counts()
        check(np.isfinite(h.accuracy_per_client).all(), f"[population] {kw}: non-finite")
        n = len(h.accuracy_mean)
        check(all(counts[k] == n for k in FL_KERNELS),
              f"[population] {kw}: each FL kernel must launch once a round {counts}")
        return h, counts

    h_dev, _ = run(host_population=-1)
    h_host, _ = run(host_population=1)
    diff = history_diff(h_host, h_dev)
    check(not diff, f"[population] host_population=1 differs from the device-resident run in "
                    f"{diff}")
    h_e1, _ = run(host_population=1, edge_groups=1)
    diff = [f for f in history_diff(h_e1, h_dev)
            if f not in ("round_time", "sim_clock", "tx_edge_bytes")]
    check(not diff and h_e1.tx_edge_bytes.shape == (5, 1) and (h_e1.tx_edge_bytes > 0).all()
          and (h_e1.round_time >= h_dev.round_time).all(),
          f"[population] edge_groups=1: trajectory differs in {diff} or no hop accounted")
    h_e3, counts_e3 = run(host_population=1, edge_groups=3)
    h_e3_dev, _ = run(host_population=-1, edge_groups=3)
    diff = history_diff(h_e3, h_e3_dev)
    check(not diff and h_e3.tx_edge_bytes.shape == (5, 3),
          f"[population] edge_groups=3: the host plane differs from the device-resident run in "
          f"{diff}")
    (h_c0, _), (h_c8, _) = run(host_population=1, cohort_size=10), run(
        host_population=1, cohort_size=10, eval_chunk=8)
    eval_gap = float(np.abs(h_c8.accuracy_per_client - h_c0.accuracy_per_client).max())
    eval_same = [f for f in ("selected", "pms") if np.array_equal(getattr(h_c8, f),
                                                                  getattr(h_c0, f))]
    acfg = dict(ASYNC_CFG, rounds=ASYNC_EVENTS)
    (a_dev, _), (a_host, a_counts) = run(host_population=-1, **acfg), run(host_population=1,
                                                                          **acfg)
    diff = history_diff(a_host, a_dev)
    check(not diff, f"[population] async host plane differs from the device-resident run in "
                    f"{diff}")
    print(f"[population] {card}: (a) acsp-fl+dld+int8 uci-har C={data.n_clients}: "
          f"host_population=1 bitwise the device-resident run (5 rounds; round wall median "
          f"{1e3 * statistics.median(h_host.wall_time[1:]):.1f} ms, device-resident "
          f"{1e3 * statistics.median(h_dev.wall_time[1:]):.1f} ms); edge_groups=1 the "
          f"same trajectory, hop bytes {h_e1.tx_edge_bytes[:, 0].tolist()}, round_time "
          f"{np.round(h_e1.round_time, 4).tolist()} vs {np.round(h_dev.round_time, 4).tolist()} "
          f"flat; edge_groups=3 host bitwise device-resident, accuracy_mean "
          f"{np.round(h_e3.accuracy_mean, 4).tolist()} (flat "
          f"{np.round(h_dev.accuracy_mean, 4).tolist()}), "
          f"launches {json.dumps(counts_e3)}; cohort 10 eval_chunk=8 vs 0: accuracy gap "
          f"{eval_gap:.3g}, equal {eval_same}; async M={data.n_clients} buffer_k="
          f"{ASYNC_CFG['buffer_k']} {ASYNC_EVENTS} events bitwise the device-resident run, "
          f"launches {json.dumps(a_counts)}, event wall median "
          f"{1e3 * statistics.median(a_host.wall_time[1:]):.1f} ms (device-resident "
          f"{1e3 * statistics.median(a_dev.wall_time[1:]):.1f})")

    # (b) the million-client tier's configuration
    peaks = {}
    for c in POP_SIZES:
        pop = make_sharded_population(c, **POP_DATA)
        auto = c >= 50_000
        cfg = FLConfig(fraction=POP_RUN["cohort_size"] / c, host_population=0 if auto else 1,
                       **POP_RUN)
        check(cfg.execution.resolved_host_population(c),
              f"[population] C={c}: not routed to the host plane")
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        stats: dict = {}
        rec_dir = scratch_dir("smoke_pop_")
        try:
            t0 = time.perf_counter()
            # the profiler splits each round's host time into dispatch
            # (launches) and device_get (waiting on the fetches)
            h = run_host_sync(pop, cfg, dev, stats=stats,
                              recorder=RunRecorder(rec_dir, profile=True, echo=False))
            wall = time.perf_counter() - t0
            with open(os.path.join(rec_dir, "profile.json")) as f:
                prof = json.load(f)
        finally:
            shutil.rmtree(rec_dir, ignore_errors=True)
        peaks[c] = torch.cuda.max_memory_allocated()
        counts = kernels.launch_counts()
        phases = {k: [round(1e3 * ch.get(f"{k}_s", 0.0), 3) for ch in prof["chunks"]]
                  for k in ("dispatch", "device_get", "record")}
        check(np.isfinite(h.accuracy_per_client).all() and h.tx_edge_bytes.shape == (3, 8),
              f"[population] C={c}: non-finite or no edge accounting")
        check(counts["masked_aggregate"] == cfg.rounds,
              f"[population] C={c}: masked_aggregate must launch once a round {counts}")
        print(f"[population] {card}: (b) lazy C={c} ({'auto' if auto else 'host_population=1'}) "
              f"har-mlp {POP_DATA['n_features']}-256-256-256-{POP_DATA['n_classes']} fedavg "
              f"K={POP_RUN['cohort_size']} edge_groups={POP_RUN['edge_groups']} eval_chunk="
              f"{POP_RUN['eval_chunk']} {cfg.rounds} rounds: round wall median past round 0 "
              f"{statistics.median(stats['round_ms'][1:]):.2f} ms (round 0, with the streamed "
              f"evaluation, {stats['round_ms'][0]:.1f} ms), host gather ms "
              f"{np.round(stats['host_gather_ms'], 3).tolist()}, staged bytes a round "
              f"{stats['staged_bytes'][-1]:.0f}, store host bytes {stats['store_bytes']}, peak "
              f"device memory {peaks[c] / 2**20:.2f} MiB, accuracy_mean "
              f"{np.round(h.accuracy_mean, 4).tolist()}, launches {json.dumps(counts)}, run "
              f"{wall:.1f} s; profiler ms a round {json.dumps(phases)}")
    lo, hi = POP_SIZES
    ratio = peaks[hi] / peaks[lo]
    check(ratio <= POP_PEAK_RATIO, f"[population] peak device memory at C={hi} is {ratio:.3f}x "
                                   f"that at C={lo} (limit {POP_PEAK_RATIO})")
    print(f"[population] peak device memory C={hi} / C={lo}: {ratio:.4f} (limit {POP_PEAK_RATIO})")

    # (c) memmap-backed trees against RAM
    pop = make_sharded_population(MEMMAP_C, **POP_DATA)
    cfg = FLConfig(**MEMMAP_RUN)
    ram_stats: dict = {}
    h_ram = run_host_sync(pop, cfg, dev, stats=ram_stats)
    d = scratch_dir("smoke_memmap_")
    try:
        h_mm = run_host_sync(pop, cfg, dev, backing_dir=d)
        files = sorted(os.listdir(d))
    finally:
        shutil.rmtree(d, ignore_errors=True)
    diff = history_diff(h_mm, h_ram)
    check(not diff and any(f.startswith("local_") for f in files)
          and any(f.startswith("residual_") for f in files),
          f"[population] memmap run differs from the RAM run in {diff} (files {files})")
    print(f"[population] (c) lazy C={MEMMAP_C} acsp-fl+dld+int8 K={MEMMAP_RUN['cohort_size']} "
          f"{cfg.rounds} rounds: memmap-backed ({len(files)} files) bitwise the RAM-backed run; "
          f"store host bytes {ram_stats['store_bytes']}, round wall ms "
          f"{np.round(ram_stats['round_ms'], 1).tolist()}, accuracy_mean "
          f"{np.round(h_ram.accuracy_mean, 4).tolist()}")
    return counts_e3["masked_aggregate"]


def scratch_dir(prefix: str) -> str:
    """A fresh temporary directory under the checkout's ``build/``."""
    root = Path(__file__).resolve().parent / "build"
    root.mkdir(exist_ok=True)
    return tempfile.mkdtemp(prefix=prefix, dir=root)


def recorded_run(data, cfg: FLConfig, dev, out: str, **rec_kw) -> tuple:
    """``run_federated`` with a RunRecorder into ``out``; returns the
    history, the kernel launches of the run and the profile."""
    kernels.reset_launch_counts()
    h = run_federated(data, cfg, device=dev,
                      recorder=RunRecorder(out, trace=True, profile=True, echo=False, **rec_kw))
    counts = kernels.launch_counts()
    with open(os.path.join(out, "profile.json")) as f:
        prof = json.load(f)
    return h, counts, prof


def phase_obs(dev: torch.device, card: str) -> None:
    """Run records at full width: the int8 main path (UCI-HAR, har-mlp,
    ACSP-FL + DLD) for 20 rounds at scan_chunk 1 and 5 and the async
    scheduler for 20 events, recorded with trace and profile. Each history
    is bitwise the unrecorded run's with the same kernel launches (counts
    zeroed just before each run and read just after), metrics.jsonl is
    byte-identical across the chunk sizes, the traces validate against the
    30-client population, and the profiles hold their phases (capture at
    chunk 5) and the card's memory watermark. A short run with a
    torch.profiler capture must see the card's kernels."""
    data = make_har_dataset("uci-har", seed=0)
    d = scratch_dir("smoke_obs_")
    try:
        metrics, walls = {}, {}
        runs = [(f"sync scan_chunk={c}", FLConfig(codec="int8", rounds=OBS_ROUNDS, epochs=2,
                                                  scan_chunk=c)) for c in OBS_CHUNKS]
        runs.append(("async", FLConfig(rounds=OBS_EVENTS, **ASYNC_CFG)))
        for name, cfg in runs:
            kernels.reset_launch_counts()
            bare = run_federated(data, cfg, device=dev)
            bare_counts = kernels.launch_counts()
            out = os.path.join(d, name.replace(" ", "_"))
            h, counts, prof = recorded_run(data, cfg, dev, out)
            diff = history_diff(h, bare)
            check(not diff, f"[obs] {name}: the recorded history differs in {diff}")
            check(counts == bare_counts, f"[obs] {name}: launches {counts} recorded, "
                                         f"{bare_counts} without the recorder")
            errs = validate_trace_file(os.path.join(out, "trace.json"), population=data.n_clients)
            check(not errs, f"[obs] {name}: trace invalid {errs[:3]}")
            chunked = name != "async" and cfg.execution.scan_chunk > 1
            phases = ("dispatch", "device_get", "record") + (("capture",) if chunked else ())
            check(all(prof["totals_s"].get(p, 0) > 0 for p in phases),
                  f"[obs] {name}: profile phases {prof['totals_s']}")
            check((prof["peak_live_bytes"] or 0) > 0, f"[obs] {name}: no memory watermark")
            with open(os.path.join(out, "metrics.jsonl"), "rb") as f:
                metrics[name] = f.read()
            check(len(metrics[name].splitlines()) == cfg.rounds, f"[obs] {name}: rows")
            first = cfg.execution.scan_chunk if name.startswith("sync") else 1
            walls[name] = dict(
                bare_ms=1e3 * statistics.median(bare.wall_time[first:]),
                recorded_ms=1e3 * statistics.median(h.wall_time[first:]),
                record_ms_a_round=1e3 * prof["totals_s"]["record"] / cfg.rounds,
                profile_s={k: round(v, 4) for k, v in prof["totals_s"].items()},
                graph_captures=prof["graph_captures"],
                peak_live_mib=round((prof["peak_live_bytes"] or 0) / 2**20, 1))
        sync_names = [n for n, _ in runs if n.startswith("sync")]
        check(len({metrics[n] for n in sync_names}) == 1,
              "[obs] metrics.jsonl differs across scan_chunk sizes")
        # the recorder's cost at the last chunk size, the pair again in the
        # other order (unrecorded, recorded, recorded, unrecorded)
        name, cfg = runs[len(OBS_CHUNKS) - 1]
        h, _, _ = recorded_run(data, cfg, dev, os.path.join(d, "again"))
        bare = run_federated(data, cfg, device=dev)
        first = cfg.execution.scan_chunk
        walls[name].update(recorded_again_ms=1e3 * statistics.median(h.wall_time[first:]),
                           bare_again_ms=1e3 * statistics.median(bare.wall_time[first:]))
        # torch.profiler through torch_trace_dir: the card's kernels in its trace
        tdir = os.path.join(d, "torch")
        h, _, prof = recorded_run(data, FLConfig(codec="int8", rounds=5, epochs=2, scan_chunk=5),
                                  dev, os.path.join(d, "traced"), torch_trace_dir=tdir)
        with open(prof["torch_trace"]) as f:
            events = json.load(f)["traceEvents"]
        n_kernel = sum(1 for e in events if e.get("cat") == "kernel")
        check(n_kernel > 0, "[obs] the torch.profiler trace holds no device kernel")
    finally:
        shutil.rmtree(d, ignore_errors=True)
    print(f"[obs] {card}: acsp-fl+dld+int8 uci-har {OBS_ROUNDS} rounds at scan_chunk "
          f"{OBS_CHUNKS} and async {OBS_EVENTS} events recorded (trace + profile): histories "
          f"bitwise the unrecorded runs, launches equal, metrics.jsonl byte-identical across "
          f"chunk sizes, traces valid for population {data.n_clients}; torch.profiler trace "
          f"of 5 rounds at chunk 5: {n_kernel} device kernel events")
    print(f"[obs] {card}: host wall ms a round (event), median past the first chunk, "
          f"unrecorded vs recorded (at scan_chunk={OBS_CHUNKS[-1]} in the order unrecorded, "
          f"recorded, recorded again, unrecorded again), with the recorded run's profile: "
          f"{json.dumps(walls)}")


def unpadded_lanes(engine: PersonalizedEngine, ids, x) -> tuple[int, float]:
    """The lane form without the engine's padding to blocks of LANES: lane
    k of one (B, 1, F) x (B, F, H) call for the whole batch against a
    (1, 1, F) x (1, F, H) call for its client alone. Returns the lanes that
    differ and the largest gap over max|logit|."""
    x = torch.as_tensor(x, dtype=torch.float32, device=engine.device)
    with torch.no_grad():
        batch = engine.apply_fn(engine.lane_models(ids), x[:, None])[:, 0]
        alone = torch.cat([engine.apply_fn(engine.lane_models([int(c)]), x[k:k + 1, None])[:, 0]
                           for k, c in enumerate(ids)])
    return int((batch != alone).any(1).sum()), rel_gap(batch, alone)


def phase_classify(dev: torch.device, card: str) -> dict[str, int]:
    """Personalized serving at full width (UCI-HAR stand-in, har-mlp):
    fit_servable per mode (dld with int8: its kernel launches counted,
    zeroed just before and read just after), a save/load round trip
    bitwise, per-lane bit identity on the card (B = 1, 5, 30 and a batch
    that mixes the modes), the card against the CPU on the same artifact,
    and every test row of the 30 clients served as one request each at
    batch 1, 8 and 32 with a ServeRecorder. Returns the FL kernels'
    launches of the dld fit."""
    data = make_har_dataset("uci-har", seed=0)
    rng = np.random.default_rng(0)
    d = scratch_dir("smoke_classify_")
    arts, fit_counts, lines = {}, {}, []
    try:
        for mode, codec in CLASSIFY_MODES:
            kernels.reset_launch_counts()
            art, _ = fit_servable(data, FLConfig(personalization=mode, codec=codec,
                                                 rounds=CLASSIFY_ROUNDS, epochs=2), device=dev)
            counts = kernels.launch_counts()
            check(counts["masked_aggregate"] == CLASSIFY_ROUNDS, f"[classify] {mode}: {counts}")
            if codec == "int8":
                check(counts["quantize"] == counts["dequantize"] == CLASSIFY_ROUNDS,
                      f"[classify] {mode} int8: {counts}")
                fit_counts = {k: counts[k] for k in FL_KERNELS}
            # save / load, bitwise
            path = os.path.join(d, mode)
            save_servable(art, path)
            back = load_servable(path, device=dev)
            pairs = list(zip(tree_leaves(art.global_params), tree_leaves(back.global_params)))
            pairs += list(zip(tree_leaves(art.local_params), tree_leaves(back.local_params)))
            check(torch.equal(back.share_mask, art.share_mask) and back.meta == art.meta
                  and all(a.dtype == b.dtype and torch.equal(a, b) for a, b in pairs)
                  and (art.local_params is None) == (back.local_params is None),
                  f"[classify] {mode}: the save/load round trip is not bitwise")
            arts[mode] = back
            # per-lane bit identity on the card
            engine = PersonalizedEngine(back)
            rows = back.share_mask.cpu().numpy()
            kinds = {}
            for i, r in enumerate(rows):
                kinds.setdefault(tuple(r), []).append(i)
            mixed = [g[0] for g in kinds.values()] + [next(iter(kinds.values()))[0]]
            batches = [rng.integers(0, data.n_clients, size=b) for b in LANE_BATCHES] + [
                np.asarray(mixed)]
            plain_gap, unpadded = 0.0, {}
            on_cpu = PersonalizedEngine(servable_from_numpy(back, "cpu"))
            for ids in batches:
                x = data.x_test[ids, rng.integers(0, int(data.m_test.sum(1).min()), len(ids))]
                out = engine.forward(ids, x)
                xd = torch.as_tensor(x, device=dev)
                for k in range(len(ids)):
                    check(torch.equal(out[k], engine.forward_unbatched(int(ids[k]), x[k])),
                          f"[classify] {mode}: lane {k} of a batch of {len(ids)} differs "
                          f"from forward_unbatched")
                    # the plain (1, F) x (F, H) forward of the composed model
                    plain = mlp_apply(engine.client_model(int(ids[k])), xd[k:k + 1])[0]
                    plain_gap = max(plain_gap, rel_gap(out[k], plain))
                    check(int(out[k].argmax()) == int(plain.argmax()),
                          f"[classify] {mode}: lane {k} predicts another class than the plain "
                          f"forward")
                # measured, not checked: what the padding guards against
                unpadded[len(ids)] = dict(card=unpadded_lanes(engine, ids, x),
                                          cpu=unpadded_lanes(on_cpu, ids, x))
            check(plain_gap <= CLASSIFY_REL,
                  f"[classify] {mode}: lanes vs the plain forward gap {plain_gap} of max")
            # the same artifact on the card and on the CPU
            ids = np.repeat(np.arange(data.n_clients), 8)
            x = data.x_test[ids, np.tile(np.arange(8), data.n_clients)]
            got = engine.forward(ids, x).cpu()
            want = on_cpu.forward(ids, x)
            gap = rel_gap(got, want)
            check(gap <= CLASSIFY_REL and torch.equal(got.argmax(1), want.argmax(1)),
                  f"[classify] {mode}: card vs CPU logits gap {gap} of max, predictions equal "
                  f"{torch.equal(got.argmax(1), want.argmax(1))}")
            lines.append(f"{mode}/{codec}: {len(kinds)} compositions over "
                         f"{back.meta['personalized_clients']} personalized clients, lanes bitwise "
                         f"at B={LANE_BATCHES} and mixed {len(mixed)}, lanes vs the plain "
                         f"(1,F)x(F,H) forward gap {plain_gap:.3g} of max, card vs CPU logits gap "
                         f"{gap:.3g} of max, fit launches {json.dumps(counts)}; without padding "
                         f"(lanes differing from a batch of one, gap of max) by B: {unpadded}")
        # serve every test row of the 30 clients, one request each
        art = arts["dld"]
        engine = PersonalizedEngine(art)
        cid, row = np.nonzero(data.m_test)
        reqs = [ServeRequest(rid=i, client_id=int(c), inputs=data.x_test[c, r])
                for i, (c, r) in enumerate(zip(cid, row))]
        want = engine.forward(cid, data.x_test[cid, row]).cpu().numpy()
        served = {}
        for b in SERVE_BATCHES:
            out = os.path.join(d, f"serve_b{b}")
            rec = ServeRecorder(out, trace=True)
            rec.open_session(artifact_meta=art.meta, engine="classify", batch_size=b,
                             device=dev)
            results = ContinuousBatcher(ClassifyProgram(engine, b), b, recorder=rec).run(reqs)
            stats = latency_stats(results)
            rec.close(stats)
            with open(os.path.join(out, "requests.jsonl")) as f:
                n_rows = sum(1 for _ in f)
            check(n_rows == len(reqs) == stats["n_requests"],
                  f"[classify] batch {b}: {n_rows} request rows for {len(reqs)} requests")
            check(not validate_trace_file(os.path.join(out, "trace.json")),
                  f"[classify] batch {b}: serve trace invalid")
            got = np.stack([r.output for r in sorted(results, key=lambda r: r.rid)])
            check(np.array_equal(got, want), f"[classify] batch {b}: served logits differ "
                                             f"from the batched forward")
            served[b] = dict(qps=round(stats["qps"], 1), p50_ms=round(stats["latency_p50_ms"], 3),
                             p99_ms=round(stats["latency_p99_ms"], 3), wall_s=round(stats["wall_s"], 4))
        acc = float((want.argmax(1) == data.y_test[cid, row]).mean())
        ids = torch.as_tensor(rng.integers(0, data.n_clients, size=32), device=dev)
        xb = torch.as_tensor(data.x_test[ids.cpu().numpy(), 0], device=dev)
        fwd_eager = cuda_ms(lambda: engine.forward(ids, xb))
        fwd_device = device_ms(lambda: engine.forward(ids, xb))
        # one request: the padded block against the unpadded lane form
        with torch.no_grad():
            one_padded = device_ms(lambda: engine.forward(ids[:1], xb[:1]))
            one_unpadded = device_ms(
                lambda: engine.apply_fn(engine.lane_models(ids[:1]), xb[:1, None]))
    finally:
        shutil.rmtree(d, ignore_errors=True)
    for line in lines:
        print(f"[classify] uci-har C={data.n_clients} har-mlp {'-'.join(map(str, HAR_MLP))} "
              f"{CLASSIFY_ROUNDS} rounds, {line}")
    print(f"[classify] {card}: served all {len(reqs)} test rows (dld/int8 artifact, prediction "
          f"accuracy {acc:.4f}) one request each through ClassifyProgram + ContinuousBatcher "
          f"with a ServeRecorder (requests.jsonl one row a request, trace valid, outputs bitwise "
          f"the batched forward), by batch: {json.dumps(served)}")
    print(f"[classify] {card}: forward of B=32 lanes (dld), ms: eager from the host "
          f"(CUDA events) {fwd_eager:.4f}, device (one CUDA-graph replay) {fwd_device:.4f}; "
          f"B=1 device: padded to {LANES} lanes {one_padded:.4f}, unpadded {one_unpadded:.4f}")
    return fit_counts


def phase_serve_record(dev: torch.device) -> None:
    """A recorded serving session of the reduced granite-3-8b on the card:
    ``serve(..., record=dir)``; its record validates."""
    d = scratch_dir("smoke_serve_record_")
    try:
        stats = serve(get_config("granite-3-8b").reduced(), requests=4, batch=2, prompt_len=16,
                      max_new=4, device=dev, record=d)
        with open(os.path.join(d, "manifest.json")) as f:
            man = json.load(f)
        with open(os.path.join(d, "requests.jsonl")) as f:
            n_rows = sum(1 for _ in f)
        errs = validate_trace_file(os.path.join(d, "trace.json"))
        check(not errs and n_rows == 4 == man["requests_recorded"]
              and man["environment"]["backend"] == "cuda" and man["environment"]["gpu"],
              f"[serve-record] record invalid: {errs[:3]} rows {n_rows} manifest "
              f"{man.get('requests_recorded')} env {man['environment'].get('gpu')}")
    finally:
        shutil.rmtree(d, ignore_errors=True)
    print(f"[serve-record] granite-3-8b reduced on the card, serve(record=dir): 4 requests, "
          f"{stats['tokens']} tokens, manifest + requests.jsonl (4 rows) + trace valid; "
          f"environment {man['environment']['gpu']}")

# ---------------------------------------------------------------------------
# [shard]: cohort rounds sharded over torch.distributed
# ---------------------------------------------------------------------------


def phase_shard_kernels(dev: torch.device) -> dict:
    """masked_aggregate's partial and combine modes at har-mlp's 8 leaves
    and K = 30 lanes in rank blocks, D = 1, 2, 3 (masked-partial rows,
    layer 2 shared by nobody): each rank's partial launch and the combine
    launch bitwise their plain versions, one launch each, and the combined
    means bitwise the edge mode with rank-block ids (D = 1: the flat mode);
    device ms beside the bytes bound (rank 0's partial, the combine)."""
    gen = torch.Generator(device=dev).manual_seed(5)
    leaves = [torch.randn((K,) + s, generator=gen, device=dev) * 0.01 for s in LEAVES]
    fallbacks = [torch.randn(s, generator=gen, device=dev) for s in LEAVES]
    counts = torch.randint(224, 328, (K,), generator=gen, device=dev).float()
    sel = torch.rand(K, generator=gen, device=dev) < 0.7
    share = torch.rand((K, len(HAR_MLP) - 1), generator=gen, device=dev) < 0.6
    share[:, 2] = False
    rows = [j for j in range(len(HAR_MLP) - 1) for _ in ("b", "w")]
    table = ((sel.float() * counts)[None] * share.T.float()).contiguous()
    sizes = [int(np.prod(s)) for s in LEAVES]
    p_total = sum(sizes)
    fallback_read = sum(n for n, r in zip(sizes, rows) if r == 2)  # where a row sums to 0
    _, _, width = partial_layout(sizes, table.shape[0])
    row, err = {}, 0.0
    for world in SHARD_KERNEL_WORLDS:
        blk = K // world
        parts = []
        for r in range(world):
            xs_r, w_r = [x[r * blk:(r + 1) * blk] for x in leaves], table[:, r * blk:(r + 1) * blk]
            kernels.reset_launch_counts()
            buf = masked_aggregate_partial(xs_r, w_r.contiguous(), rows, slot=r, n_slots=world)
            check(kernels.launch_counts()["masked_aggregate_partial"] == 1,
                  f"[shard] partial D={world} rank {r}: {kernels.launch_counts()} launches")
            check(torch.equal(buf, masked_aggregate_partial_plain(xs_r, w_r.contiguous(), rows,
                                                                  slot=r, n_slots=world)),
                  f"[shard] partial D={world} rank {r} differs from its plain version")
            parts.append(buf)
        total = parts[0]
        for b in parts[1:]:  # the all-reduce of the rank-slotted rows
            total = total + b
        kernels.reset_launch_counts()
        got = masked_aggregate_combine(total, LEAVES, rows, fallbacks)
        check(kernels.launch_counts()["masked_aggregate_combine"] == 1,
              f"[shard] combine D={world}: {kernels.launch_counts()} launches")
        want = masked_aggregate_combine_plain(total, LEAVES, rows, fallbacks)
        ids = (torch.arange(K, device=dev) // blk).to(torch.int32)
        edge = masked_aggregate_leaves(leaves, table, rows, fallbacks, edge_ids=ids,
                                       n_edges=world)
        for i, (g, p, e) in enumerate(zip(got, want, edge)):
            check(torch.equal(g, p), f"[shard] combine D={world} leaf {i} differs from its "
                  f"plain version")
            check(torch.equal(g, e), f"[shard] D={world} leaf {i} differs from the edge mode "
                  f"with rank-block ids")
            if rows[i] == 2:
                check(torch.equal(g, fallbacks[i]), f"[shard] D={world} leaf {i}: the "
                      f"zero-weight row's fallback is not exact")
            err = max(err, float((g - p).abs().max()))
        x0, w0 = [x[:blk] for x in leaves], table[:, :blk].contiguous()

        def run_partial(): return masked_aggregate_partial(x0, w0, rows, slot=0, n_slots=world)

        def run_partial_plain(): return masked_aggregate_partial_plain(x0, w0, rows, slot=0,
                                                                        n_slots=world)

        def run_combine(): return masked_aggregate_combine(total, LEAVES, rows, fallbacks)

        def run_combine_plain(): return masked_aggregate_combine_plain(total, LEAVES, rows,
                                                                        fallbacks)
        # partial: the rank's x and weights read once, the (D, width) buffer
        # written; combine: the D slots read, the fallback where a row sums
        # to 0, the means written
        pb, pby = bound_ms(blk * p_total * 4 + table.shape[0] * blk * 4 + world * width * 4,
                           2 * blk * p_total)
        cb, cby = bound_ms(world * width * 4 + (p_total + fallback_read) * 4,
                           (world + 1) * p_total)
        row.update({f"partial_d{world}_ms": device_ms(run_partial),
                    f"partial_d{world}_plain_ms": device_ms(run_partial_plain),
                    f"partial_d{world}_bound_ms": pb, f"partial_d{world}_bound_by": pby,
                    f"combine_d{world}_ms": device_ms(run_combine),
                    f"combine_d{world}_plain_ms": device_ms(run_combine_plain),
                    f"combine_d{world}_bound_ms": cb, f"combine_d{world}_bound_by": cby})
    row["shard_max_abs_err"] = err
    print(f"[shard] masked_aggregate partial and combine modes, har-mlp's 8 leaves at K={K} "
          f"lanes in rank blocks, D={SHARD_KERNEL_WORLDS} (masked-partial rows, layer 2 shared "
          f"by nobody): one launch each, bitwise their plain versions and the edge mode with "
          f"rank-block ids; device ms (rank 0's partial, the combine) beside the bound: "
          f"{json.dumps(row)}")
    return row


def phase_shard_nccl(dev: torch.device, card: str) -> dict[str, int]:
    """The [loop] configuration (UCI-HAR, har-mlp, ACSP-FL + DLD + int8) with
    cohort_devices=1: a world-1 NCCL group the run opens and closes, bitwise
    the unsharded run at scan_chunk 1 and 5 (the all-reduces captured in the
    chunk's CUDA graph), one partial and one combine launch a round and no
    flat one (counts zeroed just before each sharded run and read just
    after); round walls against the unsharded ones; a profiled eager round's
    collective bytes against ``shard_collective_bytes``. Returns the
    launches of the scan_chunk=1 run."""
    data = make_har_dataset("uci-har", seed=0)
    rounds = SHARD_NCCL["rounds"]
    walls, launches = {}, None
    for chunk in SHARD_NCCL_CHUNKS:
        ref = run_federated(data, FLConfig(scan_chunk=chunk, **SHARD_NCCL), device=dev)
        kernels.reset_launch_counts()
        h = run_federated(data, FLConfig(cohort_devices=1, scan_chunk=chunk, **SHARD_NCCL),
                          device=dev)
        counts = kernels.launch_counts()
        check(counts["masked_aggregate_partial"] == counts["masked_aggregate_combine"] == rounds
              and counts["masked_aggregate"] == 0
              and counts["quantize"] == counts["dequantize"] == rounds,
              f"[shard] NCCL world 1 scan_chunk={chunk}: a partial and a combine launch a "
              f"round expected {counts}")
        diff = history_diff(h, ref)
        check(not diff, f"[shard] NCCL world 1 scan_chunk={chunk}: differs from the unsharded "
              f"run in {diff}")
        check(not dist.is_initialized(), "[shard] the run left its world-1 group open")
        start = max(chunk, 1)
        walls[chunk] = dict(sharded_ms=1e3 * statistics.median(h.wall_time[start:]),
                            unsharded_ms=1e3 * statistics.median(ref.wall_time[start:]))
        launches = launches or counts
    cfg = FLConfig(cohort_devices=1, **SHARD_NCCL)
    su = _setup_run(data, cfg, dev, None, mlp_loss, mlp_accuracy, None, None, None)
    state = initial_state(su, data.n_clients)
    step = fl_api.build_round_step(su.env, su.pipeline, cfg.execution)
    d = scratch_dir("shard_trace_")
    try:
        state, _ = step(state, 0)  # the communicator's first use
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA],
                                    record_shapes=True) as prof:
            step(state, 1)
            torch.cuda.synchronize()
        trace = os.path.join(d, "round.json")
        prof.export_chrome_trace(trace)
        stats = collective_bytes(trace)
        with open(trace) as f:
            names = sorted({str(e.get("name")) for e in json.load(f).get("traceEvents", [])
                            if "nccl" in str(e.get("name", "")).lower()
                            or e.get("name") in ("record_param_comms", "c10d::allreduce_")})
    finally:
        step.mesh.close()
        shutil.rmtree(d, ignore_errors=True)
    want = shard_collective_bytes(su.g0, su.n_layers, 1, data.n_clients, True, True)
    check(stats.get("count") == 2 and stats.get("total") == want,
          f"[shard] NCCL round trace: {stats}, reckoned 2 all-reduces of {want} bytes "
          f"(events {names})")
    print(f"[shard] {card}: acsp-fl+dld+int8 uci-har C={data.n_clients} cohort_devices=1 on "
          f"NCCL: bitwise the unsharded run at scan_chunk {SHARD_NCCL_CHUNKS} ({rounds} rounds; "
          f"chunks captured with their all-reduces); launches {json.dumps(launches)}; host wall "
          f"ms a round past the first chunk (median): {json.dumps(walls)}; one eager round's "
          f"collectives (torch.profiler events {names}): {json.dumps(stats)}, reckoned {want}")
    return launches


@dataclasses.dataclass(frozen=True)
class RankBlockAggregator(MaskedPartialAggregator):
    """The masked-partial aggregator reducing through masked_aggregate's
    edge mode with the lanes' rank blocks as edges (lane // (K/D), D
    edges): the one-process reference of a D-rank sharded reduction."""

    ranks: int = 1

    def _edges(self, ctx, env):
        k = ctx.select.shape[0]
        ids = torch.arange(k, device=ctx.select.device) // (k // self.ranks)
        return ids.to(torch.int32), self.ranks


def acc_ulp(h, ref) -> int:
    """The largest distance in float32 ulp between two runs' accuracy_mean."""
    a = np.asarray(h.accuracy_mean, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - np.asarray(ref.accuracy_mean, np.float32).view(np.int32)).max())


def rank_block_run(data, cfg: FLConfig, ranks: int, device):
    """``cfg`` unsharded, its aggregation the edge mode with rank-block
    ids: what a sharded run over ``ranks`` must give bit for bit."""
    pipe = dataclasses.replace(pipeline_from_config(cfg), aggregator=RankBlockAggregator(
        ranks=ranks))
    return run_federated(data, dataclasses.replace(cfg, execution=dataclasses.replace(
        cfg.execution, cohort_devices=0)), device=device, pipeline=pipe)


@dataclasses.dataclass(frozen=True)
class RecordingAggregator(MaskedPartialAggregator):
    """The masked-partial aggregator keeping its first call's inputs and
    output (this rank's lanes) and its last call's new global model."""

    log: list = dataclasses.field(default_factory=list, compare=False)

    def aggregate(self, ctx, env):
        out = super().aggregate(ctx, env)
        rec = {"new_global": [t.clone() for t in tree_leaves(out.new_global)]}
        if not self.log:
            rec.update(agg_src=[t.clone() for t in tree_leaves(ctx.agg_src)],
                       select=ctx.select.clone(), n=env.n_samples.clone(),
                       share=ctx.share.clone())
            self.log.append(rec)
        else:
            self.log[1:] = [rec]
        return out


def shard_worker(rank: str, world: str, store: str, out: str, device: str, goldens: str) -> int:
    """One rank of a gloo world (``--shard-worker``): the [shard] gloo
    configuration through ``run_federated`` on ``device``, round 0's
    aggregation inputs and output, the final global model, a rank-slotted
    all-reduce that says whether every rank holds the same final model, the
    8-client fixture's K = 6 run, and (``goldens`` "1") the committed
    goldens in the legacy stream."""
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(store, "store"), world),
                            rank=rank, world_size=world)
    try:
        dev = torch.device(device)
        data = make_har_dataset("uci-har", seed=0)
        cfg = FLConfig(cohort_devices=world, **SHARD_GLOO)
        pipe = dataclasses.replace(pipeline_from_config(cfg), aggregator=RecordingAggregator())
        h = run_federated(data, cfg, device=dev, pipeline=pipe)
        res = {f"h/{f}": np.asarray(getattr(h, f)) for f in h._fields
               if getattr(h, f) is not None}
        first, last = pipe.aggregator.log[0], pipe.aggregator.log[-1]
        for key in ("select", "n", "share"):
            res[f"round0/{key}"] = first[key].cpu().numpy()
        for name in ("agg_src", "new_global"):
            for i, leaf in enumerate(first[name]):
                res[f"round0/{name}/{i}"] = leaf.cpu().numpy()
        final = torch.cat([t.reshape(-1) for t in last["new_global"]])
        slots = torch.full((world, final.numel()), -0.0, dtype=torch.float32, device=dev)
        slots[rank].copy_(final)
        dist.all_reduce(slots)
        res["ranks_agree"] = np.asarray(all(torch.equal(slots[r], slots[0])
                                            for r in range(world)))
        res["final"] = final.cpu().numpy()
        small = make_federated_classification(**SMALL_DS)
        hs = run_federated(small, FLConfig(cohort_devices=world, **SHARD_SMALL), device=dev)
        res.update({f"small/{f}": np.asarray(getattr(hs, f)) for f in hs._fields
                    if getattr(hs, f) is not None})
        if goldens == "1":
            with prng.threefry_partitionable(False):
                for name, (gcfg, _, _) in GOLDEN.items():
                    g = run_federated(small, FLConfig(rounds=5, epochs=1, cohort_devices=world,
                                                      **gcfg), device=dev)
                    res[f"golden/{name}/acc"] = g.accuracy_mean.astype(np.float32)
                    res[f"golden/{name}/sel"] = g.selected
        np.savez(os.path.join(out, f"rank{rank}.npz"), **res)
    finally:
        dist.destroy_process_group()
    return 0


def spawn_world(world: int, device: str, base: str, goldens: bool) -> tuple:
    """Start ``world`` ``--shard-worker`` processes; returns them, their
    log files and their output directory."""
    tag = f"w{world}_{device.replace(':', '')}"
    store, out = os.path.join(base, f"store_{tag}"), os.path.join(base, f"out_{tag}")
    os.makedirs(store)
    os.makedirs(out)
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    procs, logs = [], []
    for r in range(world):
        log = open(os.path.join(base, f"{tag}_rank{r}.log"), "w")
        procs.append(subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--shard-worker", str(r), str(world),
             store, out, device, "1" if goldens else "0"], stdout=log, stderr=subprocess.STDOUT,
            env=env))
        logs.append(log)
    return procs, logs, out


def join_world(key, procs, logs, out: str, deadline: float) -> list:
    """Wait for a world's ranks (killing every one at the deadline); returns
    each rank's saved arrays."""
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            with open(log.name) as f:
                tail = f.read()[-3000:]
            raise SmokeFailure(f"{key} rank {r} exited {p.returncode}:\n{tail}")
    return [dict(np.load(os.path.join(out, f"rank{r}.npz"))) for r in range(len(procs))]


def as_history(arrays: dict):
    """An FLHistory from a worker's ``h/`` arrays."""
    from repro_torch.fl.engine import FLHistory

    return FLHistory(**{f: arrays.get(f"h/{f}") for f in FLHistory._fields})


def phase_shard_gloo(dev: torch.device, card: str) -> None:
    """Worlds of 2 and 3 gloo processes sharing the card, and the same
    worlds on the CPU, through ``run_federated(cohort_devices=D)``, all
    started at once. Checked: every rank's history and final global model
    bitwise equal (files and a rank-slotted all-reduce); round 0's new
    global model bitwise the one-process edge mode with rank-block ids on
    the gathered lanes; the 8-client fixture (K = 6) on the card against
    the CPU (the exact fields equal, accuracy within 1e-6); at world 2 the
    committed goldens (accuracy_mean within 1 ulp, the selections exact);
    UCI-HAR's card worlds against the card's unsharded run whose
    aggregation is the edge mode with rank-block ids (the exact fields and
    accuracy equal). Printed beside them: UCI-HAR's card worlds against the
    flat unsharded run and against the CPU's worlds (the card and the CPU
    differ there unsharded too: GEMM last bits move a selection)."""
    data = make_har_dataset("uci-har", seed=0)
    unsharded = run_federated(data, FLConfig(**SHARD_GLOO), device=dev)
    blocks = {world: rank_block_run(data, FLConfig(cohort_devices=world, **SHARD_GLOO), world,
                                    dev) for world in SHARD_GLOO_WORLDS}
    base = scratch_dir("shard_")
    try:
        started = {}
        for world in SHARD_GLOO_WORLDS:
            for device in ("cuda:0", "cpu"):
                started[world, device] = spawn_world(world, device, base,
                                                     goldens=world == SHARD_GOLDEN_WORLD)
        deadline = time.monotonic() + SHARD_TIMEOUT_S
        t0 = time.perf_counter()
        res = {key: join_world(f"[shard] gloo world {key}", *v, deadline)
               for key, v in started.items()}
        wall_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(base, ignore_errors=True)

    def gap(a, b, prefix=""):
        """Accuracy gap and the exact fields that differ, ``a`` against ``b``."""
        diff = [f for f in EXACT_FIELDS
                if not np.array_equal(a[f"{prefix}{f}"], b[f"{prefix}{f}"])]
        acc = float(np.abs(a[f"{prefix}accuracy_per_client"]
                           - b[f"{prefix}accuracy_per_client"]).max())
        return acc, diff

    def arrays(hist):
        return {f"h/{f}": np.asarray(getattr(hist, f)) for f in hist._fields
                if getattr(hist, f) is not None}

    ref = arrays(unsharded)
    report, failures = {}, []
    for world in SHARD_GLOO_WORLDS:
        card_ranks, cpu_ranks = res[world, "cuda:0"], res[world, "cpu"]
        agree = {}
        for where, ranks in (("card", card_ranks), ("CPU", cpu_ranks)):
            bad = sorted({key for arrays in ranks for key, value in arrays.items()
                          if not key.startswith("round0/") and not key.endswith("/wall_time")
                          and not np.array_equal(value, ranks[0][key])})
            agree[where] = (all(bool(a["ranks_agree"]) for a in ranks), bad)
            if bad or not agree[where][0]:
                failures.append(f"world {world} {where}: ranks differ (all-reduce "
                                f"{agree[where][0]}, files {bad})")
        # round 0: the ranks' lanes gathered, reduced in one process
        n_leaves = sum(1 for k in card_ranks[0] if k.startswith("round0/agg_src/"))
        cat = lambda key: torch.from_numpy(  # noqa: E731
            np.concatenate([a[key] for a in card_ranks])).to(dev)
        xs = [cat(f"round0/agg_src/{i}") for i in range(n_leaves)]
        sel, n, share = cat("round0/select"), cat("round0/n"), cat("round0/share")
        weights = ((sel.float() * n)[None, :] * share.T.float()).contiguous()
        ids = (torch.arange(sel.shape[0], device=dev) // (sel.shape[0] // world)).to(torch.int32)
        edge = masked_aggregate_leaves(xs, weights, [i // 2 for i in range(n_leaves)],
                                       edge_ids=ids, n_edges=world)
        round0 = all(np.array_equal(a[f"round0/new_global/{i}"], e.cpu().numpy())
                     for a in card_ranks for i, e in enumerate(edge))
        if not round0:
            failures.append(f"world {world}: round 0 differs from the edge mode with rank-block "
                            f"ids")
        small_acc, small_diff = gap(card_ranks[0], cpu_ranks[0], "small/")
        if small_diff or small_acc > 1e-6:
            failures.append(f"world {world}: the 8-client fixture on the card differs from the "
                            f"CPU in {small_diff}, accuracy {small_acc}")
        h = card_ranks[0]
        if not np.isfinite(h["h/accuracy_per_client"]).all():
            failures.append(f"world {world}: non-finite accuracy")
        vs_unsharded, vs_cpu = gap(h, ref, "h/"), gap(h, cpu_ranks[0], "h/")
        ulp = acc_ulp(as_history(h), unsharded)
        block_acc, block_diff = gap(h, arrays(blocks[world]), "h/")
        if block_diff or block_acc:
            failures.append(f"world {world}: UCI-HAR differs from the card's unsharded run with "
                            f"rank-block edges in {block_diff}, accuracy {block_acc}")
        report[world] = dict(
            accuracy_mean=np.round(h["h/accuracy_mean"], 4).tolist(),
            selected_per_round=h["h/selected"].sum(axis=1).tolist(),
            ranks_bitwise_equal=agree, round0_bitwise_edge_mode=round0,
            uci_har_vs_rank_block_edge_mode=dict(accuracy_gap=block_acc,
                                                 exact_fields_differing=block_diff),
            uci_har_vs_card_unsharded=dict(accuracy_gap=vs_unsharded[0], accuracy_mean_ulp=ulp,
                                           exact_fields_differing=vs_unsharded[1]),
            uci_har_vs_cpu_world=dict(accuracy_gap=vs_cpu[0], exact_fields_differing=vs_cpu[1]),
            small_fixture_card_vs_cpu=dict(accuracy_gap=small_acc,
                                           exact_fields_differing=small_diff),
            round_wall_ms_median=1e3 * statistics.median(h["h/wall_time"][1:]),
            cpu_round_wall_ms_median=1e3 * statistics.median(cpu_ranks[0]["h/wall_time"][1:]))
    goldens = {}
    for where in ("cuda:0", "cpu"):
        got = res[SHARD_GOLDEN_WORLD, where][0]
        for name, (_, acc_hex, want_bits) in sorted(GOLDEN.items()):
            acc = got[f"golden/{name}/acc"]
            want = np.frombuffer(bytes.fromhex(acc_hex), np.dtype("<f4"))
            ulp = int(np.abs(acc.view(np.int32).astype(np.int64)
                             - want.view(np.int32).astype(np.int64)).max())
            bits = ["".join("1" if b else "0" for b in row) for row in got[f"golden/{name}/sel"]]
            goldens[f"{where} {name}"] = dict(ulp=ulp, selections_exact=bits == want_bits)
            if ulp > 1 or bits != want_bits:
                failures.append(f"golden {name} at world {SHARD_GOLDEN_WORLD} on {where}: {ulp} "
                                f"ulp, selected {bits} (want {want_bits})")
    print(f"[shard] {card}: acsp-fl+dld+int8 uci-har, {SHARD_GLOO['rounds']} rounds, gloo worlds "
          f"{SHARD_GLOO_WORLDS} sharing the card and on the CPU ({wall_s:.1f} s for all, started "
          f"at once; unsharded on the card: accuracy_mean "
          f"{np.round(unsharded.accuracy_mean, 4).tolist()}): {json.dumps(report)}; goldens at "
          f"world {SHARD_GOLDEN_WORLD}: {json.dumps(goldens)}")
    check(not failures, f"[shard] gloo worlds: {failures}")


def nccl_world_main(where: str = "cuda") -> int:
    """One rank of ``torchrun --nproc-per-node D chip_smoke.py --nccl-world``
    (the group from torchrun's environment, NCCL, ``cuda:{rank}``; "cpu"
    rehearses it over gloo on the CPU, 6 rounds): the NCCL_WORLD
    configuration sharded over the D ranks, bitwise the same cohort
    unsharded on this rank's card with its aggregation through the edge
    mode with rank-block ids, at scan_chunk 1 and 5 (the all-reduces
    captured in the chunk's graph), one partial and one combine launch a
    round (beside it, the distance to the flat unsharded run); a profiled eager round's collective bytes against the reckoning;
    every rank's final model equal (a rank-slotted all-reduce); the
    committed goldens at world D. Rank 0 prints; every rank exits non-zero
    when any rank found a fault."""
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    cpu = where == "cpu"
    run = dict(NCCL_WORLD, rounds=6) if cpu else NCCL_WORLD
    dist.init_process_group("gloo" if cpu else "nccl")
    failures, report = [], {}
    try:
        if cpu:
            torch.set_num_threads(1)
            dev = torch.device("cpu")
        else:
            dev = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        card = "CPU rehearsal" if cpu else phase_environment() if rank == 0 else ""
        if not cpu and rank == 0:
            phase_build()
        dist.all_reduce(torch.zeros(1, device=dev))  # the others wait for the build
        data = make_har_dataset("uci-har", seed=0)
        for chunk in NCCL_WORLD_CHUNKS:
            cfg = FLConfig(cohort_devices=world, scan_chunk=chunk, **run)
            flat = run_federated(data, FLConfig(scan_chunk=chunk, **run), device=dev)
            ref = rank_block_run(data, cfg, world, dev)
            kernels.reset_launch_counts()
            h = run_federated(data, cfg, device=dev)
            counts = kernels.launch_counts()
            diff = history_diff(h, ref)
            if diff or not cpu and not (counts["masked_aggregate_partial"]
                                        == counts["masked_aggregate_combine"] == run["rounds"]
                                        and counts["masked_aggregate"] == 0):
                failures.append(f"rank {rank} scan_chunk={chunk}: differs from the unsharded "
                                f"run with rank-block edges in {diff}, launches {counts}")
            report[f"scan_chunk={chunk}"] = dict(
                rank_block_edge_mode_fields_differing=diff,
                flat_unsharded=dict(accuracy_mean_ulp=acc_ulp(h, flat),
                                    fields_differing=history_diff(h, flat)),
                sharded_ms=1e3 * statistics.median(h.wall_time[chunk:]),
                unsharded_ms=1e3 * statistics.median(flat.wall_time[chunk:]),
                partial_launches=counts["masked_aggregate_partial"],
                combine_launches=counts["masked_aggregate_combine"])
        cfg = FLConfig(cohort_devices=world, **run)
        su = _setup_run(data, cfg, dev, None, mlp_loss, mlp_accuracy, None, None, None)
        state = initial_state(su, data.n_clients)
        step = fl_api.build_round_step(su.env, su.pipeline, cfg.execution)
        d = scratch_dir(f"nccl_world_r{rank}_")
        try:
            state, _ = step(state, 0)  # the communicator's first use
            activities = [torch.profiler.ProfilerActivity.CPU]
            if not cpu:
                torch.cuda.synchronize()
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            with torch.profiler.profile(activities=activities, record_shapes=True) as prof:
                state, _ = step(state, 1)
                if not cpu:
                    torch.cuda.synchronize()
            prof.export_chrome_trace(os.path.join(d, "round.json"))
            stats = collective_bytes(os.path.join(d, "round.json"))
        finally:
            shutil.rmtree(d, ignore_errors=True)
        want = shard_collective_bytes(su.g0, su.n_layers, world, run["cohort_size"] // world,
                                      True, True)
        if stats.get("count") != 2 or stats.get("total") != want:
            failures.append(f"rank {rank}: collectives {stats}, reckoned 2 of {want} bytes")
        report["collectives"] = dict(stats, reckoned=want)
        final = torch.cat([t.reshape(-1) for t in tree_leaves(state.global_params)])
        slots = torch.full((world, final.numel()), -0.0, dtype=torch.float32, device=dev)
        slots[rank].copy_(final)
        dist.all_reduce(slots)
        if not all(torch.equal(slots[r], slots[0]) for r in range(world)):
            failures.append(f"rank {rank}: the ranks' global models differ after 2 rounds")
        small = make_federated_classification(**SMALL_DS)
        ulps = {}
        with prng.threefry_partitionable(False):
            for name, (gcfg, acc_hex, want_bits) in sorted(GOLDEN.items()):
                g = run_federated(small, FLConfig(rounds=5, epochs=1, cohort_devices=world,
                                                  **gcfg), device=dev)
                want_acc = np.frombuffer(bytes.fromhex(acc_hex), np.dtype("<f4"))
                ulps[name] = int(np.abs(g.accuracy_mean.astype(np.float32).view(np.int32)
                                        .astype(np.int64) - want_acc.view(np.int32)).max())
                bits = ["".join("1" if b else "0" for b in row) for row in g.selected]
                if ulps[name] > 1 or bits != want_bits:
                    failures.append(f"rank {rank} golden {name}: {ulps[name]} ulp, {bits}")
        report["golden_ulp"] = ulps
        n_bad = torch.full((1,), float(len(failures)), device=dev)
        dist.all_reduce(n_bad)
        if rank == 0:
            print(f"[nccl-world] {card}: acsp-fl+dld+int8 uci-har C={data.n_clients} cohort "
                  f"{run['cohort_size']} over {world} ranks on "
                  f"{'gloo' if cpu else 'NCCL'}, {run['rounds']} rounds: {json.dumps(report)}")
        failures += [] if int(n_bad.item()) == len(failures) else ["another rank failed"]
    finally:
        dist.destroy_process_group()
    if failures:
        print(f"[nccl-world] rank {rank}: {failures}", file=sys.stderr)
        return 1
    return 0



# ---------------------------------------------------------------------------
# the expert-parallel MoE over a mesh of ranks ([ep], --ep-worker, --ep-world)
# ---------------------------------------------------------------------------


class EPCallCounter:
    """Within its ``with``, counts the expert-parallel MoE calls (each one
    all-reduce over ``model``) by wrapping ``layers.moe_ep_routes``."""

    def __enter__(self):
        self.calls, self.fn = 0, layers.moe_ep_routes

        def counted(*args):
            self.calls += 1
            return self.fn(*args)

        layers.moe_ep_routes = counted
        return self

    def __exit__(self, *exc):
        layers.moe_ep_routes = self.fn


class RouteRecorder:
    """Within its ``with``, keeps every ``layers.moe_route`` call's routed
    expert ids and kept mask on the host."""

    def __enter__(self):
        self.calls, self.fn = [], layers.moe_route

        def recorded(p, xf, cfg):
            out = self.fn(p, xf, cfg)
            self.calls.append((out[1].cpu(), out[4].cpu()))
            return out

        layers.moe_route = recorded
        return self

    def __exit__(self, *exc):
        layers.moe_route = self.fn


def ep_steps(cfg, model, tokens: torch.Tensor, dec: torch.Tensor | None) -> tuple:
    """Prefill ``tokens`` then one decode step a column of ``dec`` (None:
    the greedy tokens of each step): ((1 + steps, B, V) logits on the host,
    the decode tokens fed, the steps' CUDA-event ms)."""
    prefill, decode = transformer.make_prefill_step(cfg), transformer.make_decode_step(cfg)
    timed = model.device.type == "cuda"
    events = [torch.cuda.Event(enable_timing=True) if timed else None
              for _ in range(2 * (1 + EP_DECODE_STEPS))]

    def mark(i):
        if timed:
            events[i].record()

    mark(0)
    logits, cache = prefill(model, {"tokens": tokens})
    mark(1)
    out, fed = [logits.float().cpu()], []
    for t in range(EP_DECODE_STEPS):
        tok = (torch.argmax(logits, dim=-1)[:, None].to(torch.int32) if dec is None
               else dec[:, t:t + 1])
        fed.append(tok.cpu())
        mark(2 + 2 * t)
        logits, cache = decode(model, cache, tok)
        mark(3 + 2 * t)
        out.append(logits.float().cpu())
    if not timed:
        return torch.stack(out), torch.cat(fed, dim=1), []
    torch.cuda.synchronize()
    ms = [events[i].elapsed_time(events[i + 1]) for i in range(0, len(events), 2)]
    return torch.stack(out), torch.cat(fed, dim=1), ms


def ep_jamba(dev: torch.device):
    """jamba-v0.1-52b at full width in float32, cut to SERVE_LAYERS' depth
    (53.2 GB of parameters), and its prefill batch (SERVE_RUN's batch of
    prompt_len tokens from key 11)."""
    cfg = dataclasses.replace(get_config("jamba-v0.1-52b"), dtype="float32",
                              n_layers=SERVE_LAYERS["jamba-v0.1-52b"])
    toks = make_concrete_batch(cfg, "prefill", SERVE_RUN["batch"], SERVE_RUN["prompt_len"],
                               prng.PRNGKey(11))["tokens"]
    return cfg, toks


def phase_ep(dev: torch.device, card: str) -> dict[str, int]:
    """The expert-parallel MoE on the one card: (a) under a (1, 1) mesh (one
    world-1 group, gloo for CPU tensors and NCCL for the card's), the
    reduced float32 MoE family and jamba, prefill and 4 decode steps, the
    card against the CPU within REDUCED_REL, every MoE call through
    ``moe_apply_ep`` and exactly ``expected_launches``; (b) jamba at full
    width and SERVE_LAYERS' depth, float32, SERVE_RUN's batch, prefill and
    EP_DECODE_STEPS greedy decode steps without a mesh and then under
    (1, 1), within EP_REL of max; (c) the same on (1, 2) as two gloo
    processes sharing the card (``--ep-worker``; NCCL cannot put two ranks
    on one card), fed (b)'s decode tokens, each rank within EP_REL of (b)'s
    (1, 1) logits and both equal. Returns the kernels' launches in (a),
    (b)'s mesh run and (c)'s ranks."""
    t_phase = time.perf_counter()
    launches = dict.fromkeys(kernels.KERNELS, 0)
    mesh = make_rank_mesh((1, 1), device=dev, backend="cpu:gloo,cuda:nccl")
    try:
        with mesh_ctx.mesh_context(mesh):
            for arch in EP_REDUCED:
                cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
                bundle = get_model(cfg)
                cpu_model = bundle.init(torch.Generator().manual_seed(0))
                dev_model = copy.deepcopy(cpu_model).to(dev)
                batch = make_concrete_batch(cfg, "prefill", 4, 64, prng.PRNGKey(1))["tokens"]
                with EPCallCounter() as ep_calls:
                    kernels.reset_launch_counts()
                    got, dec, _ = ep_steps(cfg, dev_model, batch, None)
                    counts = kernels.launch_counts()
                    n_calls = ep_calls.calls
                want, _, _ = ep_steps(cfg, cpu_model, batch, dec)
                gaps = [rel_gap(g, w) for g, w in zip(got, want)]
                n_moe = sum(sp.moe for sp in transformer.layer_specs(cfg))
                check(counts == expected_launches(cfg, 1, EP_DECODE_STEPS),
                      f"[ep] {arch} reduced (1, 1): launches {counts}")
                check(n_calls == n_moe * (1 + EP_DECODE_STEPS),
                      f"[ep] {arch} reduced (1, 1): {n_calls} moe_apply_ep calls on the card")
                check(max(gaps) <= REDUCED_REL[arch],
                      f"[ep] {arch} reduced (1, 1): card vs CPU {gaps} > {REDUCED_REL[arch]}")
                for k, n in counts.items():
                    launches[k] += n
                print(f"[ep] {arch} reduced float32 under a (1, 1) mesh, card vs CPU logits gap / "
                      f"max, prefill then {EP_DECODE_STEPS} decode steps: {gaps} (contract "
                      f"{REDUCED_REL[arch]}); {n_calls} moe_apply_ep calls on the card")
        del cpu_model, dev_model
        gc.collect()
        torch.cuda.empty_cache()
        cfg, toks = ep_jamba(dev)
        model = get_model(cfg).init(torch.Generator(device=dev).manual_seed(0))
        plain, dec, plain_ms = ep_steps(cfg, model, toks, None)
        kernels.reset_launch_counts()
        with mesh_ctx.mesh_context(mesh), EPCallCounter() as ep_calls:
            ep11, _, ep_ms = ep_steps(cfg, model, toks, dec.to(dev))
        counts = kernels.launch_counts()
        del model
    finally:
        mesh.close()
    gc.collect()
    torch.cuda.empty_cache()
    gap11 = [rel_gap(a, b) for a, b in zip(ep11, plain)]
    check(counts == expected_launches(cfg, 1, EP_DECODE_STEPS),
          f"[ep] jamba {cfg.n_layers} layers (1, 1): launches {counts}")
    check(ep_calls.calls == cfg.n_layers // 2 * (1 + EP_DECODE_STEPS),
          f"[ep] jamba (1, 1): {ep_calls.calls} moe_apply_ep calls")
    check(max(gap11) <= EP_REL, f"[ep] jamba (1, 1) vs no mesh: {gap11} > {EP_REL} of max")
    for k, n in counts.items():
        launches[k] += n
    print(f"[ep] {card}: jamba-v0.1-52b full width, {cfg.n_layers} layers, {cfg.dtype}, batch "
          f"{tuple(toks.shape)}: (1, 1) mesh vs no mesh logits gap / max, prefill then "
          f"{EP_DECODE_STEPS} decode steps {gap11} (contract {EP_REL}); step ms (CUDA events) "
          f"no mesh {[round(t, 3) for t in plain_ms]}, (1, 1) {[round(t, 3) for t in ep_ms]}")

    base = scratch_dir("ep_gloo_")
    try:
        np.save(os.path.join(base, "dec.npy"), dec.numpy())
        env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
        procs, logs = [], []
        for r in range(2):
            log = open(os.path.join(base, f"rank{r}.log"), "w")
            procs.append(subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), "--ep-worker", str(r), "2", base,
                 str(dev)],
                stdout=log, stderr=subprocess.STDOUT, env=env))
            logs.append(log)
        ranks = join_world("[ep] gloo world (1, 2)", procs, logs, base,
                           time.monotonic() + EP_GLOO_TIMEOUT_S)
    finally:
        shutil.rmtree(base, ignore_errors=True)
    gap12 = [[rel_gap(torch.from_numpy(a), b) for a, b in zip(rk["logits"], ep11)] for rk in ranks]
    check(max(map(max, gap12)) <= EP_REL, f"[ep] jamba (1, 2) vs (1, 1): {gap12} > {EP_REL}")
    check(np.array_equal(ranks[0]["logits"], ranks[1]["logits"]),
          "[ep] jamba (1, 2): the two ranks' logits differ")
    for rk in ranks:
        check(int(rk["ep_calls"]) == cfg.n_layers // 2 * (1 + EP_DECODE_STEPS),
              f"[ep] jamba (1, 2): {int(rk['ep_calls'])} moe_apply_ep calls")
        for k in kernels.KERNELS:
            launches[k] += int(rk[f"launches/{k}"])
    print(f"[ep] jamba (1, 2) as 2 gloo processes on the card: logits gap / max to the (1, 1) run "
          f"by rank {gap12} (contract {EP_REL}), ranks equal; expert slices "
          f"{[tuple(int(n) for n in rk['wg_shape']) for rk in ranks]}, peak GiB by rank "
          f"{[round(float(rk['peak']) / 2**30, 2) for rk in ranks]}, step ms by rank "
          f"{[[round(float(t), 3) for t in rk['ms']] for rk in ranks]}; [ep] "
          f"{time.perf_counter() - t_phase:.1f} s")
    return launches


def ep_worker(rank: str, world: str, base: str, device: str) -> int:
    """One rank of [ep]'s gloo world (``--ep-worker``), every rank on
    ``device``: jamba at SERVE_LAYERS' depth on a (1, world) mesh, prefill
    and the decode tokens in ``base/dec.npy``; saves its logits, launches,
    expert slice shape and peak memory."""
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(base, "store"), world),
                            rank=rank, world_size=world)
    try:
        dev = torch.device(device)
        if dev.type == "cuda":
            dev = torch.device("cuda", dev.index or 0)
            torch.cuda.set_device(dev)
        full_precision_matmuls()
        mesh = make_rank_mesh((1, world), device=dev)
        dec = torch.from_numpy(np.load(os.path.join(base, "dec.npy"))).to(dev)
        try:
            with mesh_ctx.mesh_context(mesh):
                cfg, toks = ep_jamba(dev)
                model = get_model(cfg).init(torch.Generator(device=dev).manual_seed(0))
                kernels.reset_launch_counts()
                with EPCallCounter() as ep_calls:
                    logits, _, ms = ep_steps(cfg, model, toks, dec)
                counts = kernels.launch_counts()
                wg = next(blk["moe"]["wg"] for blk in model.blocks if "moe" in blk)
        finally:
            mesh.close()
        np.savez(os.path.join(base, f"rank{rank}.npz"), logits=logits.numpy(), ms=np.asarray(ms),
                 ep_calls=ep_calls.calls, wg_shape=np.asarray(wg.shape),
                 peak=torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0,
                 **{f"launches/{k}": n for k, n in counts.items()})
    finally:
        dist.destroy_process_group()
    return 0


def tp_cases() -> list:
    """[tp]'s gloo (1, 2) cases: (name, cfg, prompt tokens): TP_REDUCED's
    reduced bf16 models, then TP_FULL's at full width cut to their layers,
    SERVE_RUN's batch (64 tokens a reduced prompt)."""
    cases = []
    for arch in TP_REDUCED:
        cfg = get_config(arch).reduced()
        cases.append((f"{arch} reduced", cfg, 64))
    for arch, n_layers in TP_FULL:
        cfg = dataclasses.replace(get_config(arch), n_layers=n_layers)
        cases.append((f"{arch} {n_layers} layers", cfg, SERVE_RUN["prompt_len"]))
    return [(name, cfg, make_concrete_batch(cfg, "prefill", SERVE_RUN["batch"], seq,
                                            prng.PRNGKey(1))["tokens"])
            for name, cfg, seq in cases]


def held_block(model) -> list[int]:
    """The shape a rank holds of its first layer's widest mixer leaf
    (``wq`` or Mamba's ``in_proj``)."""
    mixer = model.blocks[0]["mixer"]
    return list(mixer["in_proj" if "in_proj" in mixer else "wq"].shape)


def phase_tp(dev: torch.device, card: str) -> dict[str, int]:
    """Tensor parallelism for serving on the one card, the layout alone
    (``mesh_context(moe_ep=False)``: jamba's MoE runs ``moe_apply_local``
    on every rank; the expert-parallel MoE, which in bf16 sums otherwise
    than the local one, is [ep]'s): (a) under a (1, 1)
    mesh (one world-1 group, gloo for CPU tensors and NCCL for the card's)
    TP_REDUCED's reduced bf16 models, prefill and EP_DECODE_STEPS decode
    steps, bitwise the same weights without a mesh, with exactly
    ``expected_launches``; (b) ``tp_cases()`` without a mesh (greedy
    tokens), then on (1, 2) as two gloo processes sharing the card
    (``--tp-worker``), fed those tokens: each rank within TP_BF16_REL of
    max of the no-mesh logits, both ranks bitwise equal, the launches of
    every case's prefill and decode steps. Returns the kernels' launches in
    (a) and in (b)'s ranks."""
    t_phase = time.perf_counter()
    launches = dict.fromkeys(kernels.KERNELS, 0)
    mesh = make_rank_mesh((1, 1), device=dev, backend="cpu:gloo,cuda:nccl")
    try:
        for arch in TP_REDUCED:
            cfg = get_config(arch).reduced()
            toks = make_concrete_batch(cfg, "prefill", 4, 64, prng.PRNGKey(1))["tokens"]
            plain_model = get_model(cfg).init(torch.Generator(device=dev).manual_seed(0))
            plain, dec, _ = ep_steps(cfg, plain_model, toks, None)
            del plain_model
            kernels.reset_launch_counts()
            with mesh_ctx.mesh_context(mesh, moe_ep=False):
                model = get_model(cfg).init(torch.Generator(device=dev).manual_seed(0))
                got, _, _ = ep_steps(cfg, model, toks, dec.to(dev))
            counts = kernels.launch_counts()
            del model
            check(torch.equal(got, plain), f"[tp] {arch} reduced bf16 (1, 1) differs from no mesh: "
                                           f"{[rel_gap(g, w) for g, w in zip(got, plain)]}")
            check(counts == expected_launches(cfg, 1, EP_DECODE_STEPS),
                  f"[tp] {arch} reduced (1, 1): launches {counts}")
            for k, n in counts.items():
                launches[k] += n
        print(f"[tp] {card}: {', '.join(TP_REDUCED)} reduced bf16 under a (1, 1) mesh, prefill "
              f"then {EP_DECODE_STEPS} decode steps: bitwise the run without a mesh")
    finally:
        mesh.close()
    gc.collect()
    torch.cuda.empty_cache()

    cases = tp_cases()
    base = scratch_dir("tp_gloo_")
    try:
        plain_ms = {}
        for i, (name, cfg, toks) in enumerate(cases):
            model = get_model(cfg).init(torch.Generator(device=dev).manual_seed(0))
            plain, dec, plain_ms[name] = ep_steps(cfg, model, toks, None)
            del model
            np.save(os.path.join(base, f"dec{i}.npy"), dec.numpy())
            np.save(os.path.join(base, f"plain{i}.npy"), plain.numpy())
        gc.collect()
        torch.cuda.empty_cache()
        env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
        procs, logs = [], []
        for r in range(2):
            log = open(os.path.join(base, f"rank{r}.log"), "w")
            procs.append(subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), "--tp-worker", str(r), "2", base,
                 str(dev)],
                stdout=log, stderr=subprocess.STDOUT, env=env))
            logs.append(log)
        ranks = join_world("[tp] gloo world (1, 2)", procs, logs, base,
                           time.monotonic() + TP_GLOO_TIMEOUT_S)
        plains = [torch.from_numpy(np.load(os.path.join(base, f"plain{i}.npy")))
                  for i in range(len(cases))]
    finally:
        shutil.rmtree(base, ignore_errors=True)
    report = {}
    want = dict.fromkeys(kernels.KERNELS, 0)
    for i, (name, cfg, _) in enumerate(cases):
        gaps = [[rel_gap(torch.from_numpy(g), w) for g, w in zip(rk[f"logits{i}"], plains[i])]
                for rk in ranks]
        tokens = [np.argmax(rk[f"logits{i}"], axis=-1) for rk in ranks]
        check(max(map(max, gaps)) <= TP_BF16_REL,
              f"[tp] {name} (1, 2) vs no mesh: logits gap / max {gaps} > {TP_BF16_REL}")
        check(np.array_equal(ranks[0][f"logits{i}"], ranks[1][f"logits{i}"])
              and np.array_equal(tokens[0], tokens[1]), f"[tp] {name} (1, 2): the ranks differ")
        for k, n in expected_launches(cfg, 1, EP_DECODE_STEPS).items():
            want[k] += n
        report[name] = {"gap_by_rank": gaps, "held_block_by_rank": [
            [int(n) for n in rk[f"block{i}"]] for rk in ranks],
            "step_ms_by_rank": [[round(float(t), 3) for t in rk[f"ms{i}"]] for rk in ranks],
            "no_mesh_step_ms": [round(t, 3) for t in plain_ms[name]]}
    for rk in ranks:
        counts = {k: int(rk[f"launches/{k}"]) for k in kernels.KERNELS}
        check(counts == want, f"[tp] (1, 2): launches {counts}, expected {want}")
        for k, n in counts.items():
            launches[k] += n
    print(f"[tp] {card}: (1, 2) as 2 gloo processes on the card, prefill then "
          f"{EP_DECODE_STEPS} decode steps fed the no-mesh greedy tokens, bf16: logits gap / max "
          f"to the run without a mesh by rank (contract {TP_BF16_REL}), ranks bitwise equal, the "
          f"block a rank holds of layer 0's wq / in_proj, step ms (CUDA events; gloo copies "
          f"through the host): {json.dumps(report)}; peak GiB by rank "
          f"{[round(float(rk['peak']) / 2**30, 2) for rk in ranks]}; launches a rank "
          f"{json.dumps(want)}; [tp] {time.perf_counter() - t_phase:.1f} s")
    return launches


def tp_worker(rank: str, world: str, base: str, device: str) -> int:
    """One rank of [tp]'s gloo world (``--tp-worker``), every rank on
    ``device``: each of ``tp_cases()`` on a (1, world) mesh, prefill and
    the decode tokens in ``base/dec{i}.npy``; saves its logits, step ms,
    held block, the launches over all cases and its peak memory."""
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(base, "store"), world),
                            rank=rank, world_size=world)
    try:
        dev = torch.device(device)
        if dev.type == "cuda":
            dev = torch.device("cuda", dev.index or 0)
            torch.cuda.set_device(dev)
        full_precision_matmuls()
        mesh = make_rank_mesh((1, world), device=dev)
        out = {}
        try:
            kernels.reset_launch_counts()
            with mesh_ctx.mesh_context(mesh, moe_ep=False):
                for i, (_, cfg, toks) in enumerate(tp_cases()):
                    dec = torch.from_numpy(np.load(os.path.join(base, f"dec{i}.npy"))).to(dev)
                    model = get_model(cfg).init(torch.Generator(device=dev).manual_seed(0))
                    logits, _, ms = ep_steps(cfg, model, toks, dec)
                    out.update({f"logits{i}": logits.numpy(), f"ms{i}": np.asarray(ms),
                                f"block{i}": np.asarray(held_block(model))})
                    del model
            counts = kernels.launch_counts()
        finally:
            mesh.close()
        np.savez(os.path.join(base, f"rank{rank}.npz"), **out,
                 peak=torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0,
                 **{f"launches/{k}": n for k, n in counts.items()})
    finally:
        dist.destroy_process_group()
    return 0


def ep_world_main(where: str = "cuda") -> int:
    """One rank of ``torchrun --nproc-per-node 4 chip_smoke.py --ep-world``
    (NCCL, ``cuda:{rank}``; "cpu" rehearses it over gloo on the CPU at the
    reduced float32 configs and 64-token prompts): first ``ep_world_check``
    on each EP_CHECK_MESHES mesh and ``tp_world_check`` on (1, 4) for
    each TP_CHECK model whole (float32 within EP_REL; bf16 printed), then
    SERVE_RUN through ``serve`` inside ``mesh_context`` on each EP_WORLD
    mesh, jamba-v0.1-52b and moonshot-v1-16b-a3b (expert- and
    tensor-parallel), granite-3-8b and falcon-mamba-7b (tensor-parallel)
    at full depth. Checked on every rank: the stats,
    the launches ``expected_launches`` gives, every rank's greedy tokens
    equal. Rank 0 prints prefill ms, decode step ms, tok/s, peak
    GiB by rank, the routes dropped at prefill and decode (summed over the
    data shards) and the launches; every rank exits non-zero when any rank
    found a fault."""
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    cpu = where == "cpu"
    dist.init_process_group("gloo" if cpu else "nccl")
    failures = []
    try:
        if cpu:
            torch.set_num_threads(1)
            dev = torch.device("cpu")
        else:
            dev = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        card = "CPU rehearsal" if cpu else phase_environment() if rank == 0 else ""
        run = dict(SERVE_RUN, prompt_len=64) if cpu else SERVE_RUN
        preds = {}
        if rank == 0:  # every serving case's dry run, traced during the build, before any timing
            pending = start_dryruns(ep_world_cases(run, cpu), "ep_world")
            try:
                if not cpu:
                    phase_build()
            finally:
                preds = collect_dryruns(*pending)
        dist.all_reduce(torch.zeros(1, device=dev))  # the others wait for the build
        check_cfg = get_config(EP_CHECK_ARCH)
        check_cfg = dataclasses.replace(check_cfg.reduced() if cpu else check_cfg, dtype="float32",
                                        **({} if cpu else {"n_layers": EP_CHECK_LAYERS}))
        checks = [(ep_world_check, check_cfg, shape) for shape in EP_CHECK_MESHES]
        checks += [(tp_world_check, get_config(arch).reduced() if cpu else get_config(arch),
                    (1, 4)) for arch in TP_CHECK]
        for fn, cfg, shape in checks:
            mesh = make_rank_mesh(shape, device=dev)
            try:
                failures += fn(cfg, mesh, run, card)
            finally:
                mesh.close()
            gc.collect()
            if not cpu:
                torch.cuda.empty_cache()
        for arch, shape in EP_WORLD:
            cfg = get_config(arch)
            if cpu:
                cfg = dataclasses.replace(cfg.reduced(), dtype="float32")
            mesh = make_rank_mesh(shape, device=dev)
            try:
                failures += ep_world_serve(cfg, mesh, run, card, cpu,
                                           [preds[k] for k in (f"{arch} {shape} prefill",
                                                               f"{arch} {shape} decode")
                                            if k in preds])
            finally:
                mesh.close()
            gc.collect()
            if not cpu:
                torch.cuda.empty_cache()
        n_bad = torch.full((1,), float(len(failures)), device=dev)
        dist.all_reduce(n_bad)
        failures += [] if int(n_bad.item()) == len(failures) else ["another rank failed"]
    finally:
        dist.destroy_process_group()
    if failures:
        print(f"[ep-world] rank {rank}: {failures}", file=sys.stderr)
        return 1
    return 0


def ep_world_check(cfg, mesh, run: dict, card: str) -> list:
    """``cfg`` on ``mesh`` against the same model without one, on every
    rank: prefill SERVE_RUN's batch (``run``'s prompt length) and
    EP_DECODE_STEPS greedy decode steps under the mesh; then, without a
    mesh, the same weights on the rows of this rank's data shard fed the
    same decode tokens (a data shard routes its own tokens and counts
    capacity over them, so this is its expectation; the whole batch where
    one data rank). The rank's rows of the gathered logits must lie within
    EP_REL of max of it, every rank's logits must be bitwise equal, and
    every MoE call's routed ids and kept mask (``moe_route``'s, over the
    shard's tokens) equal it but for at most EP_ROUTE_SHARE of them. Rank
    0 prints every rank's readings; returns this rank's failures."""
    dev = mesh.device
    toks = make_concrete_batch(cfg, "prefill", run["batch"], run["prompt_len"],
                               prng.PRNGKey(11))["tokens"]
    with mesh_ctx.mesh_context(mesh):
        rows = mesh_ctx.data_rows(cfg, toks.shape[0]) or slice(0, toks.shape[0])
        model = get_model(cfg).init(torch.Generator(device=dev).manual_seed(0))
        with RouteRecorder() as got_routes:
            got, dec, ms = ep_steps(cfg, model, toks, None)
    del model
    plain = get_model(cfg).init(torch.Generator(device=dev).manual_seed(0))
    with RouteRecorder() as want_routes:
        want, _, _ = ep_steps(cfg, plain, toks[rows], dec[rows].to(dev))
    del plain
    gaps = [rel_gap(g[rows], w) for g, w in zip(got, want)]
    pairs = list(zip(got_routes.calls, want_routes.calls))
    n_routes = sum(w[0].numel() for w in want_routes.calls)
    differ = sum(int((gi != wi).sum() + (gk != wk).sum()) if gi.shape == wi.shape
                 else wi.numel() for (gi, gk), (wi, wk) in pairs)
    same_calls = len(got_routes.calls) == len(want_routes.calls) > 0
    n_dropped = sum(int((~wk).sum()) for _, wk in want_routes.calls)
    mine = torch.tensor([[*gaps, differ, float(same_calls), n_dropped, n_routes, *ms[:1]]],
                        dtype=torch.float64, device=dev)
    every = mesh.all_gather(mine, mesh.axis_names).cpu()
    logits = mesh.all_gather(got.to(dev)[None], mesh.axis_names).cpu()
    ranks_equal = bool((logits == logits[0]).all())
    shape = tuple(mesh.shape.values())
    failures = []
    if not (same_calls and differ <= EP_ROUTE_SHARE * n_routes and max(gaps) <= EP_REL
            and ranks_equal):
        failures.append(f"{cfg.name} {cfg.n_layers} layers on {shape} rank {mesh.rank} vs no "
                        f"mesh on its data shard: logits gap / max {gaps} (contract {EP_REL}), "
                        f"every rank's logits equal {ranks_equal}, "
                        f"{differ} routed ids or kept flags of {n_routes} differ (contract "
                        f"{EP_ROUTE_SHARE} of them) over "
                        f"{len(got_routes.calls)} / {len(want_routes.calls)} MoE calls")
    if mesh.rank == 0:
        n = len(gaps)
        print(f"[ep-world] {card}: {cfg.name} {cfg.n_layers} layers {cfg.dtype} on {shape}, batch "
              f"{tuple(toks.shape)}, prefill then {EP_DECODE_STEPS} decode steps, against the "
              f"model without a mesh on each rank's data shard: logits gap / max by rank "
              f"{every[:, :n].tolist()} (contract {EP_REL}), every rank's logits bitwise equal "
              f"{ranks_equal}; routed ids and kept flags differing "
              f"by rank {every[:, n].long().tolist()} of {every[:, n + 3].long().tolist()} "
              f"routes (contract {EP_ROUTE_SHARE} of them; {len(pairs)} MoE calls a rank; dropped {every[:, n + 2].long().tolist()}); "
              f"prefill ms under the mesh by rank {every[:, n + 4:].flatten().tolist()}")
    return failures


def tp_world_check(cfg, mesh, run: dict, card: str) -> list:
    """``cfg`` whole (a model without experts) on ``mesh``, tensor-parallel,
    against the same weights without a mesh on this rank's card: prefill
    SERVE_RUN's batch (``run``'s prompt length), then EP_DECODE_STEPS
    decode steps fed the float32 mesh run's greedy tokens. In float32 the
    rank's logits must lie within EP_REL of max of the no-mesh run's and
    every rank's must be bitwise equal. In bf16, the served dtype, every
    rank's must be bitwise equal too, and the gap to the no-mesh bf16 run
    is printed beside that run's own gap to the float32 one: both are bf16
    rounding, which grows with depth, and the 2^-5 of a few layers ([tp])
    does not bound it at 40. Rank 0 prints; returns this rank's
    failures."""
    dev = mesh.device
    toks = make_concrete_batch(cfg, "prefill", run["batch"], run["prompt_len"],
                               prng.PRNGKey(11))["tokens"]
    runs, dec = {}, None
    for dtype in ("float32", "bfloat16"):
        c = dataclasses.replace(cfg, dtype=dtype)
        with mesh_ctx.mesh_context(mesh):
            model = get_model(c).init(torch.Generator(device=dev).manual_seed(0))
            got, fed, _ = ep_steps(c, model, toks, dec)
        del model
        dec = fed.to(dev) if dec is None else dec
        plain = get_model(c).init(torch.Generator(device=dev).manual_seed(0))
        want, _, _ = ep_steps(c, plain, toks, dec)
        del plain
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        every = mesh.all_gather(got.to(dev)[None], mesh.axis_names).cpu()
        runs[dtype] = (got, want, bool((every == every[0]).all()))
    (g32, w32, eq32), (g16, w16, eq16) = runs["float32"], runs["bfloat16"]
    gaps = {"float32 mesh vs no mesh": [rel_gap(g, w) for g, w in zip(g32, w32)],
            "bf16 mesh vs no mesh": [rel_gap(g, w) for g, w in zip(g16, w16)],
            "bf16 no mesh vs float32": [rel_gap(g, w) for g, w in zip(w16, w32)],
            "bf16 mesh vs float32": [rel_gap(g, w) for g, w in zip(g16, w32)]}
    shape = tuple(mesh.shape.values())
    failures = []
    if not (max(gaps["float32 mesh vs no mesh"]) <= EP_REL and eq32 and eq16):
        failures.append(f"{cfg.name} {cfg.n_layers} layers on {shape} rank {mesh.rank}, "
                        f"tensor-parallel vs no mesh: logits gap / max {json.dumps(gaps)} "
                        f"(float32 contract {EP_REL}), every rank's logits equal: float32 "
                        f"{eq32}, bf16 {eq16}")
    if mesh.rank == 0:
        print(f"[ep-world] {card}: {cfg.name} {cfg.n_layers} layers on {shape}, tensor-parallel, "
              f"batch {tuple(toks.shape)}, prefill then {EP_DECODE_STEPS} decode steps, against "
              f"the same weights without a mesh on each card, logits gap / max by step, rank 0 "
              f"(float32 contract {EP_REL}; bf16 printed beside bf16's own gap to float32): "
              f"{json.dumps(gaps)}; every rank's logits bitwise equal: float32 {eq32}, bf16 "
              f"{eq16}")
    return failures


def ep_world_serve(cfg, mesh, run: dict, card: str, cpu: bool, preds=()) -> list:
    """One serving run of ``cfg`` on ``mesh`` (every rank); returns this
    rank's failures."""
    dev = mesh.device
    failures = []
    if not cpu:
        torch.cuda.reset_peak_memory_stats(dev)
    drops = MoEDropCounter(dev, run["batch"])
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with mesh_ctx.mesh_context(mesh), drops:
        stats = serve(cfg, **run)
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    shape = tuple(mesh.shape.values())
    what = f"{cfg.name} on {shape} rank {mesh.rank}"
    want = expected_launches(cfg, stats["prefill_calls"], len(stats["decode_ms"]))
    if cpu:
        want = dict.fromkeys(want, 0)  # the plain versions on the CPU
    if not (stats["n_requests"] == run["requests"] and stats["logits_finite"]
            and stats["tokens"] == sum(stats["lens"]) and counts == want):
        failures.append(f"{what}: stats {stats['n_requests']} requests, finite "
                        f"{stats['logits_finite']}, tokens {stats['tokens']} of {stats['lens']}, "
                        f"launches {counts}, expected {want}")
    out = torch.full((run["requests"], run["max_new"]), -1, dtype=torch.int64, device=dev)
    for i, toks in enumerate(stats["outputs"]):
        out[i, :len(toks)] = torch.tensor(toks, dtype=torch.int64)
    every = mesh.all_gather(out, mesh.axis_names).reshape(mesh.world, *out.shape)
    same_tokens = bool((every == every[0]).all())
    if not same_tokens:
        failures.append(f"{what}: the ranks' greedy tokens differ")
    routes = torch.tensor([[drops.routes[k], int(drops.dropped[k])] for k in ("prefill", "decode")],
                          dtype=torch.int64, device=dev)
    mesh.all_reduce(routes, mesh_ctx.dp_axes())  # each data shard routes its own tokens
    if mesh.rank == 0:
        peaks = stats["peak_bytes_by_rank"]
        dropped = {k: {"routes": int(routes[i, 0]), "dropped": int(routes[i, 1]),
                       "share": int(routes[i, 1]) / max(int(routes[i, 0]), 1)}
                   for i, k in enumerate(("prefill", "decode"))}
        print(f"[ep-world] {card}: {cfg.name} ({cfg.n_layers} layers, {cfg.dtype}, "
              f"{cfg.param_count() / 1e9:.2f} B params) on mesh (data, model) = {shape}, "
              f"{mesh.world} ranks ({mesh.backend}): {run['requests']} requests, batch "
              f"{run['batch']}, prompt {run['prompt_len']}, max_new {run['max_new']}; lens "
              f"{stats['lens']}, {stats['prefill_calls']} prefills, {len(stats['decode_ms'])} "
              f"decode steps; every rank's greedy tokens equal: {same_tokens}")
        print(f"[ep-world] {cfg.name} {shape}: prefill ms median "
              f"{statistics.median(stats['prefill_ms']):.3f} all "
              f"{[round(t, 3) for t in stats['prefill_ms']]}; decode step ms median "
              f"{statistics.median(stats['decode_ms']):.3f} (min {min(stats['decode_ms']):.3f}, "
              f"max {max(stats['decode_ms']):.3f}); {stats['tok_per_s']:.2f} tok/s, serving span "
              f"{stats['wall_s']:.2f} s (with init {wall:.2f} s); peak GiB by rank "
              f"{None if peaks is None else [round(b / 2**30, 2) for b in peaks]}; MoE routes "
              f"dropped {json.dumps(dropped)}; rank 0 launches {json.dumps(counts)}")
        for pred in preds:  # the dry run's prefill and decode steps beside the measured peaks
            print(world_prediction_line("ep-world", pred, None if peaks is None else
                                        [round(b / 2**30, 2) for b in peaks]))
    return failures


# ---------------------------------------------------------------------------
# training: the backward kernels and the train steps
# ---------------------------------------------------------------------------


def expected_train_launches(cfg, steps: int) -> dict[str, int]:
    """What ``steps`` train steps of ``cfg`` must launch of each kernel: a
    decoder LM checkpoints every block (remat), so an attention layer runs
    flash_attention twice a step (the forward and its recompute in the
    backward) and flash_attention_bwd once, a Mamba layer ssm_scan twice
    and ssm_scan_bwd once; whisper checkpoints nothing (as in JAX), so each
    of its attentions (encoder self-attention, decoder self- and
    cross-attention) runs the forward and the backward once a step."""
    counts = dict.fromkeys(kernels.KERNELS, 0)
    if cfg.encoder_decoder:
        n = cfg.n_encoder_layers + 2 * cfg.n_layers
        counts.update(flash_attention=n * steps, flash_attention_bwd=n * steps)
        return counts
    specs = transformer.layer_specs(cfg)
    n_attn = sum(sp.kind == "attn" for sp in specs)
    n_mamba = len(specs) - n_attn
    counts.update(flash_attention=2 * n_attn * steps, flash_attention_bwd=n_attn * steps,
                  ssm_scan=2 * n_mamba * steps, ssm_scan_bwd=n_mamba * steps)
    return counts


def sdpa_backward_ms(q, k, v, dout, causal: bool, attn_mask=None) -> tuple:
    """The backward of ``scaled_dot_product_attention`` (autograd, one call
    of ``torch.autograd.grad`` on a retained graph; causal or not, or with
    a boolean ``attn_mask``) through each fused
    backend that takes the shape: (the fastest one's ms or None, its name,
    every backend's ms or the first line of its refusal). CUDA-event ms of
    eager calls."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    gqa = k.shape[2] != q.shape[2]
    leaves = [t.transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v)]
    doh = dout.transpose(1, 2).contiguous()
    how = ({"is_causal": causal} if attn_mask is None else {"attn_mask": attn_mask})
    tried = {}
    for name in ("FLASH_ATTENTION", "CUDNN_ATTENTION", "EFFICIENT_ATTENTION"):
        backend = getattr(SDPBackend, name, None)
        if backend is None:
            tried[name] = "not in this torch"
            continue
        try:
            with sdpa_kernel([backend]):
                out = torch.nn.functional.scaled_dot_product_attention(
                    *leaves, **how, **({"enable_gqa": True} if gqa else {}))
                fn = lambda: torch.autograd.grad(out, leaves, doh, retain_graph=True)  # noqa: E731
                fn()
                torch.cuda.synchronize()
                tried[name] = cuda_ms(fn, reps=10)
            del out
        except RuntimeError as err:
            tried[name] = "refused: " + str(err).strip().splitlines()[0][:160]
    times = {n: t for n, t in tried.items() if isinstance(t, float)}
    best = min(times, key=times.get) if times else None
    return (times[best] if best else None), best, tried


def attention_bwd_bound(b, s, t, h, hkv, dq, dv, causal, products: int = 5) -> tuple[float, str]:
    """The least time of dQ, dK, dV in bf16: ``products`` products over the
    visible pairs at the bf16 tensor-core rate (the five the inputs require:
    S again, dP, dV, dK, dQ; or the seven of the wgmma kernel, which
    computes S and dP in both of its passes), or the bytes (q, k, v, o, dO,
    lse read once, dQ, dK, dV written once)."""
    n_bytes = 2 * (2 * b * s * h * dq + 2 * b * t * hkv * (dq + dv) + 2 * b * s * h * dv) \
        + 4 * b * h * s
    per_pair = {5: 3 * dq + 2 * dv, 7: 4 * dq + 3 * dv}[products]
    return bound_ms(n_bytes, 2 * per_pair * b * h * visible_pairs(s, t, causal, 0), BF16_FLOPS)


def attention_bwd_case(key: str, case: tuple, randn, controls: bool = True) -> tuple:
    """flash_attention_bwd (bf16) at ``case`` = (B, S, T, H, Hkv, Dqk, Dv,
    causal) on the forward kernel's o and lse, held to its float64
    contract (``contract.bwd_check``), its controls rejected where
    ``controls``, two calls bitwise; times of eager calls (CUDA events)
    beside the five- and seven-product bounds, the float32 plain version
    and SDPA's fused backward. Returns (the row's keys, the report)."""
    from repro_torch.kernels.flash_attention import contract as fa_contract
    from repro_torch.kernels.flash_attention import flash_attention_backward_plain
    from repro_torch.kernels.flash_attention import flash_attention_bwd
    from repro_torch.kernels.flash_attention.ops import _attention

    bb, ss, tt, h, hkv, dq, dv, causal = case
    brief = lambda r: {k: float(f"{v:.4g}") if isinstance(v, float) else v  # noqa: E731
                       for k, v in r.items()}
    q = randn(bb, ss, h, dq).to(torch.bfloat16)
    k = randn(bb, tt, hkv, dq).to(torch.bfloat16)
    v = randn(bb, tt, hkv, dv).to(torch.bfloat16)
    dout = randn(bb, ss, h, dv).to(torch.bfloat16)
    out, lse = _attention(q, k, v, causal, 0, with_lse=True)
    args = (q, k, v, out, lse, dout, causal)
    got = flash_attention_bwd(*args)
    again = flash_attention_bwd(*args)
    check(all(same(x, y) for x, y in zip(got, again)),
          f"flash_attention_bwd at {key}: two calls differ")
    ref = fa_contract.bwd_references(*args)
    report = {key: brief(fa_contract.bwd_check(got, ref))}
    check(report[key]["ok"], f"flash_attention_bwd at {key} fails its contract: {report[key]}")
    if controls:
        for fault, bad in fa_contract.bwd_controls(*args).items():
            report[f"{key} control {fault}"] = r = brief(fa_contract.bwd_check(bad, ref))
            check(not r["ok"], f"flash_attention_bwd's contract accepts {fault} at {key}: {r}")
        del bad
    bound, by = attention_bwd_bound(bb, ss, tt, h, hkv, dq, dv, causal)
    bound7, _ = attention_bwd_bound(bb, ss, tt, h, hkv, dq, dv, causal, products=7)
    row = {"shape": [bb, ss, tt, h, hkv, dq, dv, causal],
           "max_abs_err": max(float((g.double() - w).abs().max()) for g, w in zip(got, ref.ref64)),
           "ms": cuda_ms(lambda: flash_attention_bwd(*args), reps=10),
           "bound_ms": bound, "bound_by": by, "bound7_ms": bound7}
    del ref, got, again
    row["plain_ms"] = cuda_ms(lambda: flash_attention_backward_plain(*args), reps=2, warmup=1)
    lib, backend, tried = sdpa_backward_ms(q, k, v, dout, causal)
    row.update({"library_ms": lib, "library_backend": backend})
    report[f"{key} sdpa backward"] = tried
    del q, k, v, dout, out, lse, args
    gc.collect()
    torch.cuda.empty_cache()
    return row, report


def ssm_bwd_limits(b: int, seq: int, di: int, dst: int, n_states: int) -> dict:
    """The least times (s) of ssm_scan_bwd at (B, S, di, ds) with
    ``n_states`` chunk-state elements: its bytes (bf16 streams, float32 gy
    and chunk states read once, the gradients written once) over HBM, its
    exps over the SFU, its FP32-pipe instructions."""
    updates = b * seq * di * dst
    n_bytes = (2 * b * seq * di * 2 + 2 * b * seq * dst * 2 + b * seq * di * 4
               + n_states * 4 + di * dst * 4 + di * 4
               + 2 * b * seq * di * 2 + 2 * b * seq * dst * 2 + di * dst * 4 + di * 4)
    return {"bytes": n_bytes / HBM_BYTES_PER_S, "sfu exp": updates / SFU_PER_S,
            # the reverse step's 7 FP32-pipe instructions an update and the
            # recompute's 4 that give it h_{t-1} (csrc/ssm_scan_bwd.cu's note)
            "fp32 instructions": 11 * updates / FP32_INSTR_PER_S}


def phase_train_kernels(dev: torch.device) -> dict:
    """The two backward kernels against their plain versions at full-width
    shapes, bf16: flash_attention_bwd at granite-3-8b's layer (B 4, S 2048,
    H 32, Hkv 8, D 128, causal), whisper-tiny's encoder (S = T = 1,500) and
    cross-attention (448 queries over 1,500 frames), non-causal, and one
    launch each at deepseek-v2-lite's (192, 128) and stablelm-12b's (160,
    160) (B 1, S 2048); ssm_scan_bwd at falcon-mamba-7b's layer (B 4, S
    2048 and a ragged 1,999, di 8,192, ds 16). Each held to its contract
    (``contract.bwd_check``, against the backward in float64 on the forward
    kernel's o and lse, or chunk states), its controls rejected (attention:
    at every shape; the scan: at the first), two calls bitwise equal; times
    (CUDA events, eager) beside the bound, the float32 plain version and,
    for attention at every shape, SDPA's fused backward. Returns the two
    kernels' rows."""
    from repro_torch.kernels.flash_attention import contract as fa_contract
    from repro_torch.kernels.ssm_scan import ssm_scan_backward_plain, ssm_scan_bwd
    from repro_torch.kernels.ssm_scan.ops import ssm_scan_bwd_occupancy

    gen = torch.Generator(device=dev).manual_seed(23)
    randn = lambda *shape: torch.randn(shape, generator=gen, device=dev)  # noqa: E731
    src = "src/repro_torch/csrc/"
    brief = lambda r: {k: float(f"{v:.4g}") if isinstance(v, float) else v  # noqa: E731
                       for k, v in r.items()}
    gr, wh = get_config("granite-3-8b"), get_config("whisper-tiny")
    ds, sl = get_config("deepseek-v2-lite-16b"), get_config("stablelm-12b")
    b, s = SERVE_RUN["batch"], SERVE_RUN["prompt_len"]
    cases = {  # (b, s, t, h, hkv, dq, dv, causal)
        "granite": (b, s, s, gr.n_heads, gr.n_kv_heads, gr.head_dim_, gr.head_dim_, True),
        "whisper_enc": (b, wh.encoder_seq, wh.encoder_seq, wh.n_heads, wh.n_kv_heads,
                        wh.head_dim_, wh.head_dim_, False),
        "whisper_cross": (b, wh.max_decoder_seq, wh.encoder_seq, wh.n_heads, wh.n_kv_heads,
                          wh.head_dim_, wh.head_dim_, False),
        "mla": (1, s, s, ds.n_heads, ds.n_heads, ds.qk_nope_dim + ds.qk_rope_dim, ds.v_head_dim,
                True),
        "stablelm": (1, s, s, sl.n_heads, sl.n_kv_heads, sl.head_dim_, sl.head_dim_, True),
    }
    fa_row, report = {}, {}
    for key, case in cases.items():
        row, rep = attention_bwd_case(key, case, randn)
        fa_row.update({(k if key == "granite" else f"{key}_{k}"): v for k, v in row.items()})
        report.update(rep)
    print(f"[train_kernels] flash_attention_bwd bf16 (wgmma) vs the backward in float64 on the "
          f"forward kernel's o and lse with the kernel's bf16 rounding points (contract, "
          f"kernels/flash_attention/contract.py: every element within "
          f"{fa_contract.BWD_FACTOR:g} x the float32 arithmetic's gap + {fa_contract.BWD_REL:g} "
          f"of max + 1 bf16 ulp + the slack of P and dS rounding flips; gaps and excesses over "
          f"max|ref|; the three controls must fail it at every shape), two calls bitwise; "
          f"[B, S, T, H, Hkv, Dqk, Dv, causal] in the *shape keys; ms of eager calls (CUDA "
          f"events) beside two bounds at 989 TFLOP/s: bound_ms for the five products the "
          f"inputs require, bound7_ms for the seven the kernel runs; SDPA's fused backward by "
          f"backend: {json.dumps(report)} {json.dumps(fa_row)}")

    # ssm_scan_bwd at falcon-mamba-7b's layer, bf16 streams, the forward
    # kernel's chunk states; whole chunks and a ragged last one (the shapes
    # of launch/ssm_bwd_ab.py, which A/Bs variants of the kernel)
    sh = ssm_bwd_shapes()  # (B, S) of SERVE_RUN, which tests/test_torch_import.py checks
    _, _, di, dst = sh["falcon"]
    a = -torch.exp(randn(di, dst))
    d = randn(di)
    ssm_row, report = {}, {}
    for seq in (s, sh["falcon_ragged"][1]):
        streams = [t.to(torch.bfloat16) for t in (
            torch.nn.functional.softplus(randn(b, seq, di) * 0.5 - 4.6), randn(b, seq, dst),
            randn(b, seq, dst), randn(b, seq, di))]
        args = (streams[0], a, streams[1], streams[2], streams[3], d)
        _, _, hs = ssm_scan(*args, y_dtype=torch.bfloat16, chunk_states=True)
        gy = randn(b, seq, di).to(torch.bfloat16).float()  # a bf16 y's cotangent
        got = ssm_scan_bwd(*args, hs, gy)
        again = ssm_scan_bwd(*args, hs, gy)
        check(all(same(x, y) for x, y in zip(got, again)), f"ssm_scan_bwd at S={seq}: two "
                                                           f"calls differ")
        plain32, ref64 = ssm_contract.bwd_references(*args, hs, gy)
        report[f"S={seq}"] = r = brief(ssm_contract.bwd_check(got, plain32, ref64))
        check(r["ok"], f"ssm_scan_bwd at S={seq} fails its contract: {r}")
        if seq == s:
            for fault, bad in ssm_contract.bwd_controls(*args, hs, gy).items():
                report[f"control {fault}"] = r = brief(ssm_contract.bwd_check(bad, plain32,
                                                                              ref64))
                check(not r["ok"], f"ssm_scan_bwd's contract accepts {fault}: {r}")
            del bad
            limits = ssm_bwd_limits(b, seq, di, dst, hs.numel())
            op = max(limits, key=limits.get)
            ssm_row = dict(
                shape=[b, seq, di, dst], bound_terms_ms={k: 1e3 * t for k, t in limits.items()},
                max_abs_err=max(float((g.double() - w).abs().max()) for g, w in zip(got, ref64)),
                ms=cuda_ms(lambda: ssm_scan_bwd(*args, hs, gy), reps=10),
                plain_ms=cuda_ms(lambda: ssm_scan_backward_plain(*args, hs, gy), reps=1,
                                 warmup=1),
                bound_ms=1e3 * limits[op], bound_by="bytes" if op == "bytes" else "operations",
                bound_op=op, library_ms=None,
                occupancy={f"{'bf16' if t is torch.bfloat16 else 'f32'} ds{n}":
                           ssm_scan_bwd_occupancy(n, t)
                           for t in (torch.float32, torch.bfloat16) for n in (8, 16)})
        del plain32, ref64, got, again, streams, args, hs, gy
        gc.collect()
        torch.cuda.empty_cache()
    print(f"[train_kernels] ssm_scan_bwd B={b} di={di} ds={dst} bf16 streams vs the backward in "
          f"float64 on the forward kernel's chunk states (contract, "
          f"kernels/ssm_scan/contract.py: every element within {ssm_contract.BWD_FACTOR:g} x the "
          f"float32 plain backward's gap + {ssm_contract.BWD_REL:g} of max, + 1 bf16 ulp for a "
          f"bf16 gradient; the controls must fail it), two calls bitwise; ms of eager calls; "
          f"the main grid's registers, spills, shared memory and resident blocks an SM: "
          f"{json.dumps(report)} {json.dumps(ssm_row)}")
    return {
        "flash_attention_bwd": dict(
            route="cuda", source=src + "flash_attention_bwd_wgmma.cu",
            replaces="src/repro/models/layers.py:126", **fa_row),
        "ssm_scan_bwd": dict(route="cuda", source=src + "ssm_scan_bwd.cu",
                             replaces="src/repro/models/ssm_vjp.py:105", **ssm_row),
    }


def phase_train_reference(dev: torch.device) -> None:
    """Each reduced config in float32: the loss and every parameter's
    gradient on the card (forward and backward kernels, exactly
    ``expected_train_launches`` of one step) against the same model on the
    CPU (plain versions): within LM_REL of each leaf's max, or
    REDUCED_REL's 2^-8 where a Mamba scan is in the stack."""
    from repro_torch.models.api import param_tree

    worst = {}
    for arch in SERVE_ARCHS:
        cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
        rel = REDUCED_REL[arch]
        bundle = get_model(cfg)
        cpu_model = bundle.init(torch.Generator().manual_seed(0))
        dev_model = copy.deepcopy(cpu_model).to(dev)
        batch = make_concrete_batch(cfg, "train", 2, 64, prng.PRNGKey(1))
        out = []
        for model in (cpu_model, dev_model):
            tree = param_tree(model)
            for p in tree.values():
                p.requires_grad_(True)
            kernels.reset_launch_counts()
            loss = bundle.loss_fn(model, batch)
            grads = torch.autograd.grad(loss, list(tree.values()), allow_unused=True)
            out.append((float(loss), grads, kernels.launch_counts()))
        (want_loss, want, _), (got_loss, got, counts) = out
        check(counts == expected_train_launches(cfg, 1),
              f"{arch} reduced train: launches {counts}, expected "
              f"{expected_train_launches(cfg, 1)}")
        gaps = [abs(got_loss - want_loss) / abs(want_loss)]
        gaps += [rel_gap(g.cpu(), w) for g, w in zip(got, want) if w is not None]
        check(max(gaps) <= rel and all((g is None) == (w is None) for g, w in zip(got, want)),
              f"{arch} reduced train: card vs CPU loss and gradients {max(gaps)} > {rel} of max")
        worst[arch] = max(gaps)
    print(f"[train] the ten reduced configs in float32, loss and every gradient leaf on the card "
          f"vs the CPU, worst gap / max by arch (contract: {LM_REL}, 2^-8 with a Mamba scan; "
          f"launches as expected): {json.dumps(worst)}")


def phase_train(dev: torch.device, card: str) -> dict[str, dict[str, int]]:
    """Full-width training through ``repro_torch.launch.train.train`` (the
    CLI's optimizer, a fresh batch a step), bf16: granite-3-8b and
    falcon-mamba-7b cut to ``TRAIN_LAYERS`` layers and whisper-tiny whole,
    batch 4, seq 2048 (whisper: 448 tokens over 1,500 frames), kernel counts
    zeroed just before each run and read just after and held to
    ``expected_train_launches``; losses finite; step ms (CUDA events, past
    the first step), tok/s and peak memory. Returns the counts by arch."""
    from repro_torch.launch.train import train

    launches = {}
    for arch, layers in TRAIN_LAYERS.items():
        cfg = get_config(arch)
        if layers:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        gc.collect()
        torch.cuda.empty_cache()
        lines = []
        kernels.reset_launch_counts()
        stats = train(cfg, device=dev, log=lines.append, **TRAIN_RUN)
        counts = kernels.launch_counts()
        want = expected_train_launches(cfg, TRAIN_RUN["steps"])
        check(counts == want, f"{arch} train: launches {counts}, expected {want}")
        check(all(np.isfinite(stats["losses"])), f"{arch} train: losses {stats['losses']}")
        timed = stats["step_ms"][1:]
        tokens = math.prod(make_batch_specs(cfg, "train", TRAIN_RUN["batch"],
                                            TRAIN_RUN["seq"])["tokens"][0])
        depth = f" cut to {layers} layers" if layers else ""
        print(f"[train] {arch} full width{depth} ({cfg.n_layers} layers, d_model {cfg.d_model}, "
              f"{stats['n_params'] / 1e9:.3f} B params, {cfg.dtype}), batch {TRAIN_RUN['batch']}, "
              f"{tokens // TRAIN_RUN['batch']} tokens a row, {TRAIN_RUN['steps']} steps: losses "
              f"{[round(x, 4) for x in stats['losses']]}; step ms (CUDA events) median "
              f"{statistics.median(timed):.2f} of {[round(t, 2) for t in timed]} (first step "
              f"{stats['step_ms'][0]:.2f}); {1e3 * tokens / statistics.median(timed):.0f} tok/s; "
              f"peak memory {stats['peak_bytes'] / 2**30:.2f} GiB; launches {json.dumps(counts)}; "
              f"{card}")
        launches[arch] = counts
        del stats
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# training under a mesh of ranks ([train_mesh], --train-mesh-worker,
# --train-world)
# ---------------------------------------------------------------------------


def mesh_batches(cfg, run: dict, dev: torch.device) -> list:
    """``run``'s global train batches on ``dev`` (``make_concrete_batch``
    from keys 20, 21, ...), the labels of row r -1 at its first
    ``TRAIN_MASKED[r % 8]`` places: unequal counts across the data shards."""
    out = []
    for i in range(run["steps"]):
        batch = make_concrete_batch(cfg, "train", run["batch"], run["seq"],
                                    prng.PRNGKey(20 + i, device=dev))
        labels = batch["labels"].clone()
        for r in range(labels.shape[0]):
            labels[r, :TRAIN_MASKED[r % len(TRAIN_MASKED)]] = -1
        out.append(dict(batch, labels=labels))
    return out


def mesh_train(cfg, mesh, run: dict, batches: list, visit=None, seq_parallel: bool = False
               ) -> tuple:
    """``run``'s steps of ``cfg`` from its init (seed 0) under ``mesh``
    (None: without one; ``seq_parallel`` its context's) on its device:
    (losses, the whole parameters, the whole AdamW nu, the kernel launches
    of the steps, this rank's blocks of the parameters it holds whole over
    ``model``); calls ``visit`` (when given) as ``visiting_grads`` says."""
    from repro_torch.launch import zero
    from repro_torch.launch.train import make_optimizer
    from repro_torch.models.api import param_tree

    dev = batches[0]["tokens"].device
    with (mesh_ctx.mesh_context(mesh, seq_parallel=seq_parallel) if mesh is not None
          else contextlib.nullcontext()):
        model = get_model(cfg).init(torch.Generator(device=dev).manual_seed(0),
                                        zero=mesh is not None)
        opt = make_optimizer(run["lr"], run["steps"])
        if visit is not None:
            opt = visiting_grads(opt, model, mesh, visit)
        state = opt.init(param_tree(model))
        step = get_model(cfg).make_train_step(opt)
        kernels.reset_launch_counts()
        losses = []
        for batch in batches:
            model, state, loss = step(model, state, batch)
            losses.append(loss)
        counts = kernels.launch_counts()
        params = param_tree(model)
        whole = (lambda k, t: t.detach()) if mesh is None else (
            lambda k, t: zero.whole(params[k], mesh, t))
        out = ([float(x) for x in torch.stack(losses).cpu()],
               {k: whole(k, p) for k, p in params.items()},
               {k: whole(k, v) for k, v in state[1].nu.items()}, counts,
               {k: p.detach() for k, p in params.items()
                if mesh is not None and "model" not in zero.split_axes(p)})
    return out


def visiting_grads(opt, model, mesh, visit):
    """``opt`` whose in-place step, after it has updated the parameters,
    calls ``visit(step, name, grad)`` with each gradient as AdamW took it
    (scaled by the clip), whole: gathered from this rank's blocks (every
    rank gathers them)."""
    from repro_torch.launch import zero
    from repro_torch.models.api import param_tree
    from repro_torch.optim import Optimizer

    taken = [0]  # steps taken

    def apply_(grads, state, params):
        state = opt.apply_(grads, state, params)  # the clip scales ``grads`` in place
        tree = param_tree(model)
        for k, g in grads.items():
            visit(taken[0], k, g if mesh is None else zero.whole(tree[k], mesh, g))
        taken[0] += 1
        return state

    return Optimizer(opt.init, opt.update, apply_)


def rule_train(cfg, run: dict, batches: list, n_dp: int, grads_into: list | None = None) -> tuple:
    """The rule of JAX's sharded step on ``n_dp`` data shards, without a
    mesh: each step's gradient is that of sum_i (shard i's masked NLL sum
    over the global batch's count of labels + 0.01 aux_i / n_dp), shard i
    the model on its rows of the batch; the loss the global NLL mean plus
    0.01 times shard 0's aux. For a model without an MoE (or n_dp 1) this is
    the unsharded step. Returns (losses, parameters, AdamW nu); appends to
    ``grads_into`` (when given) each step's gradients as AdamW took them
    (scaled by the clip), on the host."""
    from repro_torch.launch.train import make_optimizer
    from repro_torch.models.api import param_tree

    dev = batches[0]["tokens"].device
    model = get_model(cfg).init(torch.Generator(device=dev).manual_seed(0))
    opt = make_optimizer(run["lr"], run["steps"])
    tree = param_tree(model)
    state = opt.init(tree)
    for p in tree.values():
        p.requires_grad_(True)
    losses = []
    for batch in batches:
        b = batch["tokens"].shape[0]
        count = torch.clamp_min(torch.sum((batch["labels"] >= 0).float()), 1.0)
        nll = aux0 = 0.0
        for i in range(n_dp):  # each shard's gradient accumulates into p.grad
            rows = slice(i * b // n_dp, (i + 1) * b // n_dp)
            logits, _, aux = transformer.forward(model, cfg, batch["tokens"][rows], mode="train")
            total, _ = transformer.nll_terms(logits, batch["labels"][rows])
            (total / count + 0.01 * aux / n_dp).backward()
            nll = nll + total.detach()
            aux0 = aux.detach() if i == 0 else aux0
            del logits, total, aux
        losses.append(nll / count + 0.01 * aux0)
        grads = {k: torch.zeros_like(p) if p.grad is None else p.grad for k, p in tree.items()}
        for p in tree.values():
            p.grad = None
        # in place (one copy of the moments): bitwise update + apply_updates
        state = opt.apply_(grads, state, {k: p.detach() for k, p in tree.items()})
        if grads_into is not None:
            grads_into.append({k: g.to("cpu", copy=True) for k, g in grads.items()})
        del grads
    return ([float(x) for x in torch.stack(losses).cpu()],
            {k: p.detach() for k, p in tree.items()}, dict(state[1].nu))


def train_contract(cfg, got: tuple, want: tuple, lr: float, rel: float) -> tuple[bool, dict]:
    """tests/_torch_train.py's contract of a few steps: every loss within
    ``rel`` of ``want``'s (relative); every parameter within ``lr``, and an
    element beyond STEP_ABS only where its RMS gradient (``want``'s AdamW
    nu) is below NEAR_ZERO of its leaf's largest, or, behind a Mamba scan,
    at most SCAN_SHARE of the elements. Returns (ok, the readings)."""
    (g_losses, g_params), (w_losses, w_params, w_nu) = got, want
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(g_losses, w_losses))
    worst, n_over, n_total, excused = 0.0, 0, 0, True
    for k, w in w_params.items():
        d = (g_params[k].float() - w.float()).abs()
        over = d > STEP_ABS
        worst = max(worst, float(d.max()))
        n_over += int(over.sum())
        n_total += d.numel()
        if not cfg.ssm and bool(over.any()):
            rms = torch.sqrt(w_nu[k].float())
            excused &= bool((rms[over] < NEAR_ZERO * rms.max()).all())
    ok = (loss_gap <= rel and worst <= lr and excused
          and n_over <= (SCAN_SHARE * n_total if cfg.ssm else n_total))
    return ok, {"loss_gap": loss_gap, "worst_over_lr": worst / lr, "over": n_over,
                "of": n_total}


def phase_train_mesh(dev: torch.device, card: str) -> dict[str, int]:
    """Training under a mesh of ranks on the one card, TRAIN_MESH_RUN's
    steps on ``mesh_batches``: (a) TRAIN_MESH_ARCHS reduced in float32
    under a (1, 1) mesh (one world-1 group, gloo for CPU tensors and NCCL
    for the card's) bitwise the run without a mesh, with exactly
    ``expected_train_launches``; (b) TRAIN_MESH_CASES, reduced in float32,
    as two gloo processes sharing the card (``--train-mesh-worker``; on (1,
    2) a decoder is tensor-parallel, and granite once more under
    ``seq_parallel``), each against ``rule_train`` on as
    many data shards (the run without a mesh where it has one data shard
    or no MoE), within ``train_contract``, every rank's loss equal, on (1,
    2) the leaves whole over ``model`` bitwise equal on both ranks, and its
    launches ``expected_train_launches``. Returns the launches of (a)'s
    mesh runs and (b)'s ranks."""
    t_phase = time.perf_counter()
    launches = dict.fromkeys(kernels.KERNELS, 0)
    refs = {}
    base = scratch_dir("train_mesh_")
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    procs, logs = [], []
    for r in range(2):  # (b)'s world runs while (a) does
        log = open(os.path.join(base, f"rank{r}.log"), "w")
        procs.append(subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--train-mesh-worker", str(r), "2",
             base, str(dev)], stdout=log, stderr=subprocess.STDOUT, env=env))
        logs.append(log)
    try:
        mesh = make_rank_mesh((1, 1), device=dev,
                              backend="cpu:gloo,cuda:nccl" if dev.type == "cuda" else "gloo")
        try:
            for arch in TRAIN_MESH_ARCHS:
                cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
                batches = mesh_batches(cfg, TRAIN_MESH_RUN, dev)
                plain = mesh_train(cfg, None, TRAIN_MESH_RUN, batches)
                ours = mesh_train(cfg, mesh, TRAIN_MESH_RUN, batches)
                bitwise = plain[0] == ours[0] and all(torch.equal(ours[1][k], v)
                                                      for k, v in plain[1].items())
                want = expected_train_launches(cfg, TRAIN_MESH_RUN["steps"])
                check(bitwise, f"[train_mesh] {arch} (1, 1) vs no mesh: losses {ours[0]} and "
                               f"{plain[0]}, parameters not bitwise")
                check(ours[3] == want,
                      f"[train_mesh] {arch} (1, 1): launches {ours[3]}, want {want}")
                for k, n in ours[3].items():
                    launches[k] += n
                refs[arch] = {1: plain[:3], 2: rule_train(cfg, TRAIN_MESH_RUN, batches, 2)}
                print(f"[train_mesh] {arch} reduced float32, {TRAIN_MESH_RUN['steps']} steps of "
                      f"batch {TRAIN_MESH_RUN['batch']} x {TRAIN_MESH_RUN['seq']}: (1, 1) mesh "
                      f"bitwise the run without one (losses {ours[0]}); launches "
                      f"{json.dumps(ours[3])}")
        finally:
            mesh.close()
        for arch, shape, _ in TRAIN_MESH_CASES:  # one data shard or no MoE: the unsharded step
            if arch not in refs:
                cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
                plain = mesh_train(cfg, None, TRAIN_MESH_RUN, mesh_batches(cfg, TRAIN_MESH_RUN,
                                                                           dev))[:3]
                refs[arch] = {1: plain, 2: plain}
        ranks = join_world("[train_mesh] gloo world 2", procs, logs, base,
                           time.monotonic() + TRAIN_MESH_TIMEOUT_S)
    finally:
        for p, log in zip(procs, logs):  # after a failed check in (a), stop (b)'s world too
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
        shutil.rmtree(base, ignore_errors=True)
    readings = {}
    for arch, shape, sp in TRAIN_MESH_CASES:
        cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
        key = train_mesh_key(arch, shape, sp)
        losses = [rk[f"{key}/losses"].tolist() for rk in ranks]
        got = (losses[0], {k[len(key) + 3:]: torch.from_numpy(v).to(dev)
                           for k, v in ranks[0].items() if k.startswith(f"{key}/p/")})
        ok, readings[key] = train_contract(cfg, got, refs[arch][shape[0]],
                                           TRAIN_MESH_RUN["lr"], REDUCED_REL[arch])
        check(ok and losses[0] == losses[1],
              f"[train_mesh] {key} against the rule on {shape[0]} data shards: "
              f"{readings[key]}, losses by rank {losses}")
        if shape[1] > 1:
            held = [{k: v for k, v in rk.items() if k.startswith(f"{key}/w/")} for rk in ranks]
            check(held[0].keys() == held[1].keys() and all(
                np.array_equal(v, held[1][k]) for k, v in held[0].items()),
                f"[train_mesh] {key}: the leaves whole over model differ between the ranks")
            readings[key]["whole_over_model_bitwise"] = len(held[0])
        want = expected_train_launches(cfg, TRAIN_MESH_RUN["steps"])
        for rk in ranks:
            counts = {k: int(rk[f"{key}/launches/{k}"]) for k in kernels.KERNELS}
            check(counts == want, f"[train_mesh] {key}: launches {counts}, want {want}")
            for k, n in counts.items():
                launches[k] += n
    print(f"[train_mesh] {[train_mesh_key(*c) for c in TRAIN_MESH_CASES]} as two gloo "
          f"processes on the card (a decoder tensor-parallel on (1, 2); /sp: under "
          f"seq_parallel, the stream between blocks split over model), against the rule of JAX's "
          f"sharded step without a mesh (rule_train; the contract of tests/_torch_train.py, "
          f"1e-5 and 2^-8 behind a scan): {json.dumps(readings)}; every rank's losses equal, "
          f"on (1, 2) the leaves whole over model (whole_over_model_bitwise: their count) "
          f"bitwise equal on both ranks; [train_mesh] {time.perf_counter() - t_phase:.1f} s; "
          f"{card}")
    return launches


def train_mesh_key(arch: str, shape, seq_parallel: bool) -> str:
    """A TRAIN_MESH_CASES case's key in the workers' outputs."""
    return f"{arch}/{shape[0]}x{shape[1]}" + ("/sp" if seq_parallel else "")


def train_mesh_worker(rank: str, world: str, base: str, device: str) -> int:
    """One rank of [train_mesh]'s gloo world (``--train-mesh-worker``), every
    rank on ``device``: TRAIN_MESH_CASES, each mesh once; saves its losses,
    its launches and its blocks of the leaves it holds whole over
    ``model``, and rank 0 the whole parameters."""
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(base, "store"), world),
                            rank=rank, world_size=world)
    try:
        dev = torch.device(device)
        if dev.type == "cuda":
            dev = torch.device("cuda", dev.index or 0)
            torch.cuda.set_device(dev)
        full_precision_matmuls()
        out = {}
        for shape in dict.fromkeys(s for _, s, _ in TRAIN_MESH_CASES):
            mesh = make_rank_mesh(shape, device=dev)
            try:
                for arch, sp in ((a, sp) for a, s, sp in TRAIN_MESH_CASES if s == shape):
                    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
                    key = train_mesh_key(arch, shape, sp)
                    losses, params, _, counts, held = mesh_train(
                        cfg, mesh, TRAIN_MESH_RUN, mesh_batches(cfg, TRAIN_MESH_RUN, dev),
                        seq_parallel=sp)
                    out[f"{key}/losses"] = np.asarray(losses)
                    out.update({f"{key}/launches/{k}": n for k, n in counts.items()})
                    out.update({f"{key}/w/{k}": v.cpu().numpy() for k, v in held.items()})
                    if rank == 0:
                        out.update({f"{key}/p/{k}": v.cpu().numpy() for k, v in params.items()})
            finally:
                mesh.close()
        np.savez(os.path.join(base, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()
    return 0


def train_world_main(where: str = "cuda") -> int:
    """One rank of ``torchrun --nproc-per-node 4 chip_smoke.py --train-world``
    (NCCL, ``cuda:{rank}``; "cpu" rehearses it over gloo on the CPU at the
    reduced configs): ``train_world_check`` on each TRAIN_CHECK model, then
    ``train_world_run`` on each TRAIN_WORLD model, a sequence-parallel case
    printed beside the same mesh's case without it (``sp_pair_line``);
    every rank exits non-zero when any rank found a fault."""
    rank = int(os.environ["RANK"])
    cpu = where == "cpu"
    # a rank that fails (out of memory) leaves the others in a collective:
    # they give up after the timeout instead of holding the cards
    dist.init_process_group("gloo" if cpu else "nccl", timeout=datetime.timedelta(minutes=5))
    failures = []
    try:
        if cpu:
            torch.set_num_threads(1)
            dev = torch.device("cpu")
        else:
            dev = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        card = "CPU rehearsal" if cpu else phase_environment() if rank == 0 else ""
        full_precision_matmuls()
        run = dict(TRAIN_WORLD_RUN, seq=64) if cpu else TRAIN_WORLD_RUN
        preds = {}
        if rank == 0:  # every case's dry run, traced during the build, before any timing
            pending = start_dryruns(train_world_cases(run, cpu), "train_world")
            try:
                if not cpu:
                    phase_build()
            finally:
                preds = collect_dryruns(*pending)
        dist.all_reduce(torch.zeros(1, device=dev))  # the others wait for the build
        for arch, layers, shape, sp in TRAIN_CHECK:
            cfg = get_config(arch)
            cfg = dataclasses.replace(cfg.reduced() if cpu else cfg, dtype="float32",
                                      **({} if cpu else {"n_layers": layers}))
            mesh = make_rank_mesh(shape, device=dev)
            try:
                failures += train_world_check(cfg, mesh, card, sp)
            finally:
                mesh.close()
            gc.collect()
            if not cpu:
                torch.cuda.empty_cache()
        seen = {}  # (arch, shape, sp) -> rank 0's readings
        for arch, shape, sp in TRAIN_WORLD:
            cfg = get_config(arch).reduced() if cpu else get_config(arch)
            mesh = make_rank_mesh(shape, device=dev)
            try:
                key = world_key(arch, shape, sp)
                bad, seen[arch, shape, sp] = train_world_run(cfg, mesh, run, card, cpu,
                                                             preds.get(key), sp)
                failures += bad
                if not cpu and not failures:  # one more step, traced on every rank
                    gc.collect()
                    torch.cuda.empty_cache()
                    traced = profile_train_step(cfg, batch=run["batch"], seq=run["seq"],
                                                mesh=mesh, seq_parallel=sp)["train step"]
                    seen[arch, shape, sp]["traced"] = traced
                    if rank == 0:
                        print(f"[train-world] {key}: one step traced after a warm-up "
                              f"(torch.profiler, rank 0): {json.dumps(traced)}")
                if rank == 0 and sp and seen[arch, shape, sp] and seen.get((arch, shape, False)):
                    print(sp_pair_line(key, seen[arch, shape, False], seen[arch, shape, sp],
                                       card))
            finally:
                mesh.close()
            gc.collect()
            if not cpu:
                torch.cuda.empty_cache()
        if dist.get_world_size() == 4:  # the cross-silo round over (4, 1)
            mesh = make_rank_mesh((4, 1), device=dev)
            try:
                failures += cross_silo_world(dev, mesh, card, cpu, preds.get("cross_silo"))
            finally:
                mesh.close()
        n_bad = torch.full((1,), float(len(failures)), device=dev)
        dist.all_reduce(n_bad)
        failures += [] if int(n_bad.item()) == len(failures) else ["another rank failed"]
    finally:
        dist.destroy_process_group()
    if failures:
        print(f"[train-world] rank {rank}: {failures}", file=sys.stderr)
        return 1
    return 0


def train_world_check(cfg, mesh, card: str, seq_parallel: bool = False) -> list:
    """``cfg`` (float32) trained TRAIN_CHECK_RUN's steps on ``mesh`` (under
    ``seq_parallel``, the sequence-parallel layout) against
    ``rule_train`` of the same weights on as many data shards on this rank
    (the unsharded step where the model has no MoE): the losses within
    LM_REL; the first step's gradients as AdamW took them (gathered)
    within CHECK_GRAD_REL of each leaf's largest (CHECK_SCAN_REL behind a
    Mamba scan); every parameter within ``step_bound`` of both steps'
    gradient gaps so measured, and where the ``model`` axis is 1 (each row's forward is the
    unsharded one's) within ``train_contract`` too; the leaves held whole
    over ``model`` bitwise equal across the model ranks. Rank 0 prints
    every rank's readings and, where ``train_contract`` fails, its leaves'.
    Returns this rank's failures."""
    dev, run = mesh.device, TRAIN_CHECK_RUN
    batches = mesh_batches(cfg, run, dev)
    with mesh_ctx.mesh_context(mesh):
        n_dp = mesh_ctx.n_data() if mesh_ctx.data_rows(cfg, run["batch"]) else 1
    want_grads = []
    want = rule_train(cfg, run, batches, n_dp, want_grads)
    want = tuple({k: v.cpu() for k, v in t.items()} if isinstance(t, dict) else t for t in want)
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()  # the card's room goes to the mesh run
    gaps = {}  # (step, leaf) -> (max |got - want|, max |want|)

    def visit(t, k, g):
        w = want_grads[t][k].to(g.device)
        gaps[t, k] = (float((g - w).abs().max()), float(w.abs().max()))

    losses, params, _, _, held = mesh_train(cfg, mesh, run, batches, visit, seq_parallel)
    params = {k: v.cpu() for k, v in params.items()}
    del want_grads
    whole_equal = True
    if mesh.shape["model"] > 1:  # bitwise: float32 values are exact in double
        flat = torch.cat([held[k].reshape(-1).double() for k in sorted(held)])
        every_model = mesh.all_gather(flat[None], "model").cpu()
        whole_equal = bool((every_model == every_model[0]).all())
        del flat, every_model
    del held
    rel = {key: g / max(m, 1e-30) for key, (g, m) in gaps.items()}
    grad_gap, both_gap = max(r for (t, _), r in rel.items() if t == 0), max(rel.values())
    leaf_gap = {k: max(g for (_, j), (g, _) in gaps.items() if j == k) for _, k in gaps}
    bound_ok, bound_use, leaves = step_bound(params, want[1], want[2], leaf_gap, dev)
    contract_ok, read = train_contract(cfg, (losses, params), want, run["lr"], LM_REL)
    grad_rel = CHECK_SCAN_REL if cfg.ssm else CHECK_GRAD_REL
    ok = (read["loss_gap"] <= LM_REL and grad_gap <= grad_rel and bound_ok and whole_equal
          and (contract_ok or mesh.shape["model"] > 1))
    del params, want
    mine = torch.tensor([[read["loss_gap"], grad_gap, both_gap, read["worst_over_lr"],
                          read["over"], read["of"], float(contract_ok), bound_use,
                          float(whole_equal), float(ok)]], dtype=torch.float64, device=dev)
    every = mesh.all_gather(mine, mesh.axis_names).cpu()
    shape = tuple(mesh.shape.values())
    if mesh.rank == 0:
        print(f"[train-world] {card}: {cfg.name} {cfg.n_layers} layers {cfg.dtype} on {shape}"
              f"{' under seq_parallel' if seq_parallel else ''}, "
              f"{run['steps']} steps of batch {run['batch']} x {run['seq']}, against the same "
              f"weights without a mesh under the rule of JAX's sharded step on {n_dp} data "
              f"shards: by rank [loss gap, gradient gap / max (worst leaf) on the first "
              f"step, on both, worst parameter gap / lr, elements over {STEP_ABS}, of, "
              f"train_contract, largest parameter gap over its step_bound, the leaves whole "
              f"over model bitwise equal across the model ranks, ok] {every.tolist()} (losses "
              f"{LM_REL}, gradients {grad_rel} on the first step, step_bound 1; "
              f"train_contract, tests/_torch_train.py's, held where the model axis is 1)")
        if not contract_ok:
            print(f"[train-world] {cfg.name} on {shape}: the leaves with elements beyond "
                  f"{STEP_ABS}, most first: {json.dumps(leaves)}")
    return [] if ok else [f"{cfg.name} on {shape}{' seq_parallel' if seq_parallel else ''} "
                          f"rank {mesh.rank} against rule_train: {read}, "
                          f"gradient gap {grad_gap}, parameter gap over step_bound {bound_use}, "
                          f"whole-over-model leaves equal across model ranks: {whole_equal}"]


def step_bound(got: dict, want: dict, nu: dict, gap: dict, dev) -> tuple[bool, float, dict]:
    """The parameters after TRAIN_CHECK_RUN's two steps, ``got`` against
    ``want``, held to the bound that the measured gradient gaps give them.
    make_optimizer warms up over 2 steps: the first step's learning rate
    is 0, so both runs take one update from the same weights, lr/2 times
    m/(s + eps), m and s AdamW's bias-corrected first moment and root
    second moment (s from ``want``'s ``nu``). Where every gradient AdamW
    took in a leaf lies within G (``gap``, that leaf's measured largest
    over both steps) of the reference's, m and s each move by at most G,
    and |m| <= 1.0004 s (AdamW's b1 0.9 and b2 0.95 over two steps), so
    the update moves by at most 2.0004 G / (s - G), and by 2.0008 at most.
    Each element must lie within STEP_ABS (float32 rounding) plus lr/2
    times that (2.001). Returns (ok, the largest gap over its bound, by
    leaf with elements beyond STEP_ABS (the 8 with most): their count, the
    leaf's size, G over the leaf's largest s, the largest s among them over
    the leaf's largest, their largest gap / lr, their largest gap over its
    bound)."""
    lr2 = TRAIN_CHECK_RUN["lr"] / 2
    worst, leaves = 0.0, {}
    for k, w in want.items():
        s = torch.sqrt(nu[k].to(dev) / (1 - ADAM_B2 ** 2))
        d = (got[k].to(dev) - w.to(dev)).abs()
        room = torch.where(s > gap[k], gap[k] / (s - gap[k]), torch.ones_like(s)).clamp_max(1.0)
        use = d / (STEP_ABS + lr2 * 2.001 * room)
        worst = max(worst, float(use.max()))
        over = d > STEP_ABS
        if bool(over.any()):
            leaves[k] = {"over": int(over.sum()), "of": d.numel(),
                         "gap_over_s": gap[k] / float(s.max()),
                         "s_over_max": float(s[over].max() / s.max()),
                         "worst_over_lr": float(d.max()) / TRAIN_CHECK_RUN["lr"],
                         "over_bound": float(use[over].max())}
        del s, d, room, use, over
    leaves = dict(sorted(leaves.items(), key=lambda kv: -kv[1]["over"])[:8])
    return worst <= 1.0, worst, leaves


def train_world_run(cfg, mesh, run: dict, card: str, cpu: bool, pred=None,
                    seq_parallel: bool = False) -> tuple[list, dict]:
    """``launch.train.train`` of ``cfg`` on ``mesh`` (every rank; under
    ``seq_parallel``, the sequence-parallel layout), kernel counts zeroed
    just before and read just after: finite losses, equal on every rank,
    the launches ``expected_train_launches`` gives; rank 0 prints step ms,
    tok/s, peak GiB by rank. Returns (this rank's failures, its readings:
    median step ms, tok/s, peak GiB by rank, the predicted peak GiB)."""
    from repro_torch.launch.train import train

    dev = mesh.device
    kernels.reset_launch_counts()
    try:
        stats = train(cfg, mesh=mesh, log=lambda *_: None, seq_parallel=seq_parallel, **run)
    except torch.cuda.OutOfMemoryError as e:
        return [f"{cfg.name} on {tuple(mesh.shape.values())} rank {mesh.rank}: out of memory "
                f"({str(e)[:200]})"], {}
    counts = kernels.launch_counts()
    want = dict.fromkeys(kernels.KERNELS, 0) if cpu else expected_train_launches(cfg, run["steps"])
    mine = torch.tensor([*stats["losses"], stats["peak_bytes"] or 0, *stats["step_ms"]],
                        dtype=torch.float64, device=dev)
    every = mesh.all_gather(mine[None], mesh.axis_names).cpu()
    n = len(stats["losses"])
    shape = tuple(mesh.shape.values())
    failures = []
    if not (all(math.isfinite(x) for x in stats["losses"]) and bool((every[:, :n] == every[0, :n]).all())
            and counts == want):
        failures.append(f"{cfg.name} on {shape} rank {mesh.rank}: losses by rank "
                        f"{every[:, :n].tolist()}, launches {counts}, expected {want}")
    timed = stats["step_ms"][1:]
    tokens = run["batch"] * run["seq"]
    peaks = [round(float(b) / 2**30, 2) for b in every[:, n]]
    readings = {"step_ms": statistics.median(timed), "step_ms_range": [min(timed), max(timed)],
                "tok_s": 1e3 * tokens / statistics.median(timed), "peak_gib": peaks,
                "predicted_gib": None if pred is None else pred["memory"]["peak_bytes"] / 2**30}
    if mesh.rank == 0:
        print(f"[train-world] {card}: {cfg.name} ({cfg.n_layers} layers, {cfg.dtype}, "
              f"{stats['n_params'] / 1e9:.3f} B params) trained on mesh (data, model) = {shape}, "
              f"{mesh.world} ranks ({mesh.backend}), ZeRO over data, TP and experts over model"
              f"{', the stream sequence-parallel over model' if seq_parallel else ''}: "
              f"batch "
              f"{run['batch']} x {run['seq']}, {run['steps']} steps: losses {stats['losses']}; "
              f"step ms (CUDA events, rank 0) median {statistics.median(timed):.1f} (min "
              f"{min(timed):.1f}, max {max(timed):.1f}; first step {stats['step_ms'][0]:.1f}); "
              f"{1e3 * tokens / statistics.median(timed):.0f} tok/s over the global batch; peak "
              f"GiB by rank {peaks}; launches {json.dumps(counts)}")
        if pred is not None:  # the dry run of one step beside the run's peaks (init included)
            print(world_prediction_line("train-world", pred, peaks))
    return failures, readings


def world_key(arch: str, shape, seq_parallel: bool) -> str:
    """A TRAIN_WORLD case's name, and its dry run's key."""
    return f"{arch} {shape}" + (" seq_parallel" if seq_parallel else "")


def sp_pair_line(key: str, plain: dict, sp: dict, card: str) -> str:
    """A sequence-parallel case's readings beside the same mesh's case
    without it, from the same call: step ms, tok/s, peak GiB a rank (the
    largest rank's), the dry run's predicted peak, and the traced step's
    NCCL share and copy kernels' ms (rank 0)."""
    def row(r):
        traced = r.get("traced", {})
        return {"step_ms": round(r["step_ms"], 1), "tok_s": round(r["tok_s"]),
                "peak_gib": max(r["peak_gib"]),
                "predicted_gib": None if r["predicted_gib"] is None else round(
                    r["predicted_gib"], 2),
                "nccl_share": traced.get("nccl_share"), "copy_ms": traced.get("copy_ms")}

    return (f"[train-world] {key} beside the same mesh without it (this call): "
            f"{json.dumps({'seq_parallel': row(sp), 'without': row(plain)})}; {card}")


# ---------------------------------------------------------------------------
# cross-silo FL of LMs
# ---------------------------------------------------------------------------


def expected_cross_silo_launches(cfg, silo, rounds: int, wire: str, shared: int) -> dict[str, int]:
    """What ``rounds`` rounds of the cross-silo step launch: every silo's
    train step (``expected_train_launches``), and a round's silo mean: fp32
    one masked_aggregate launch for up to 64 shared leaves of one dtype
    (``cross_silo.launch_groups``); bf16 none (plain
    PyTorch); int8/int4 and EF one quantize, one dequantize and one
    masked_aggregate launch a wire call (``cross_silo.wire_chunks``: up to 64
    JAX leaves and 2^30 silo-row elements)."""
    counts = expected_train_launches(cfg, silo.n_silos * rounds)
    groups = cross_silo.shared_groups(cfg, silo.params, shared)
    if wire == "fp32":
        counts["masked_aggregate"] += rounds * len(cross_silo.launch_groups(
            [silo.params[n] for g in groups for n in g]))
    elif wire != "bf16":
        sizes = [sum(silo.params[n][0].numel() for n in g) for g in groups]
        calls = len(cross_silo.wire_chunks(groups, sizes, silo.n_silos))
        for name in ("quantize", "dequantize", "masked_aggregate"):
            counts[name] += rounds * calls
    return counts


def wire_bytes(silo, groups) -> dict[str, float]:
    """Bytes one silo puts on the wire a round for the shared JAX leaves
    ``groups``, by format: fp32 4 B a parameter, bf16 2, int8 1 and int4
    half a byte plus a 4-byte scale a 512-block of each leaf's row."""
    sizes = [sum(silo.params[n][0].numel() for n in g) for g in groups]
    return {"fp32": 4.0 * sum(sizes), "bf16": 2.0 * sum(sizes),
            **{f"int{b}": sum(QuantizeCodec(bits=b).wire_bytes(n) for n in sizes) for b in (8, 4)}}


def wire_call_matches_plain(xs, noises, codes, bits: int, block_p: int) -> int:
    """Whether a quantize_leaves call's ``codes`` are bitwise
    ``quantize_leaves_plain`` on the same ``xs``/``noises`` on the card:
    each row compared WIRE_CHECK_COLS columns at a time (a multiple of 512,
    so a slice's blocks are the row's). Returns the elements compared, or
    -1 at a mismatch."""
    noises = [None] * len(xs) if noises is None else noises
    n_elems = 0
    for x, u, (q, scales) in zip(xs, noises, codes):
        n = x.shape[-1]
        bp, _ = quant_blocks(n, block_p)
        for a in range(0, n, WIRE_CHECK_COLS):
            b = min(n, a + WIRE_CHECK_COLS)
            pq, ps = quantize_leaves_plain([x[..., a:b]], None if u is None else [u[..., a:b]],
                                           bits=bits, block_p=block_p)[0]
            if not (same(pq, q[..., a:b]) and same(ps, scales[..., a // bp:-(-b // bp)])):
                return -1
        n_elems += x.numel()
    return n_elems


def dequant_call_matches_plain(codes, out, block_p: int) -> int:
    """Whether a dequantize_leaves call's ``out`` is bitwise
    ``dequantize_leaves_plain`` of its ``codes`` on the card, in slices as
    ``wire_call_matches_plain``. Returns the elements compared, or -1."""
    n_elems = 0
    for (q, scales), got in zip(codes, out):
        n = q.shape[-1]
        bp, _ = quant_blocks(n, block_p)
        for a in range(0, n, WIRE_CHECK_COLS):
            b = min(n, a + WIRE_CHECK_COLS)
            want = dequantize_leaves_plain([(q[..., a:b], scales[..., a // bp:-(-b // bp)])],
                                           block_p=block_p)[0]
            if not same(want, got[..., a:b]):
                return -1
        n_elems += q.numel()
    return n_elems


@contextlib.contextmanager
def first_wire_call_checked(found: dict):
    """Inside: the first quantize_leaves and the first dequantize_leaves
    call of the cross-silo wire (the int wires call them from
    ``fl.cross_silo``, error feedback from ``comm.codec``) held bitwise
    against their plain versions on the card on the same inputs, while
    those are alive; ``found[name]`` gets the elements compared (-1 at a
    mismatch). The kernel wrappers run and count their launches as ever:
    the plain versions launch no kernel of the port."""
    real_q, real_dq = quantize_leaves, dequantize_leaves

    def spy_quantize(xs, noises=None, bits: int = 8, block_p: int = 512):
        codes = real_q(xs, noises, bits=bits, block_p=block_p)
        if "quantize" not in found:
            found["quantize"] = wire_call_matches_plain(xs, noises, codes, bits, block_p)
        return codes

    def spy_dequantize(codes, block_p: int = 512):
        out = real_dq(codes, block_p=block_p)
        if "dequantize" not in found:
            found["dequantize"] = dequant_call_matches_plain(codes, out, block_p)
        return out

    modules = (cross_silo, comm_codec)
    for mod in modules:
        mod.quantize_leaves, mod.dequantize_leaves = spy_quantize, spy_dequantize
    try:
        yield found
    finally:
        for mod in modules:
            mod.quantize_leaves, mod.dequantize_leaves = real_q, real_dq


def cross_silo_run(dev: torch.device, cfg, wire: str, card: str, check_plain: bool) -> tuple:
    """``CROSS_SILO_RUN["rounds"]`` rounds of the port's cross-silo step
    (``make_fl_round_step`` / ``make_quantized_fl_round_step``) at ``cfg``'s
    full width, bf16, from random weights: the kernel counts zeroed just
    before the rounds and read just after, held to
    ``expected_cross_silo_launches``; after every round the shared leaves
    bitwise equal across silos, after round 1 the personal ``head`` of
    silos 0 and 1 apart; with EF the residuals zero on every personal name
    and not on ``embed``; losses finite. ``check_plain``: round 1's mean of
    the (S, V x D) bf16 ``embed`` rows bitwise ``masked_aggregate_leaves_plain``
    on the card, then masked_aggregate timed at those rows. The int and EF
    wires: the first quantize and dequantize call bitwise their plain
    versions on the card (``first_wire_call_checked``). Returns (the
    counts, the embed timing row or {})."""
    run = CROSS_SILO_RUN
    n_silos, rounds, shared = run["silos"], run["rounds"], run["shared"]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    bundle = get_model(cfg)
    base = bundle.init(torch.Generator(device=dev).manual_seed(run["seed"]))
    n_params = sum(p.numel() for p in base.parameters())
    silo = cross_silo.silo_params_from_model(base, n_silos)
    del base
    opt = adamw(run["lr"])
    state = cross_silo.init_silo_opt(opt, silo)
    marks, snap = [], {}

    def timed_train_step(optimizer, window=0):
        """The bundle's train step, marking the end of each round's local
        steps (the last silo's step) and, for ``check_plain``, keeping the
        pre-aggregation embed rows of round 1."""
        inner = bundle.make_train_step(optimizer, window=window)

        def step(model, opt_state, batch):
            out = inner(model, opt_state, batch)
            if model is silo.models[-1]:
                marks.append(torch.cuda.Event(enable_timing=True))
                marks[-1].record()
                if check_plain and len(marks) == 1:
                    snap["embed"] = silo.params["embed"].reshape(n_silos, -1).clone()
            return out

        return step

    tbundle = dataclasses.replace(bundle, make_train_step=timed_train_step)
    ef = wire == "int8+ef"
    if wire in ("int8", "int4", "int8+ef"):
        step = cross_silo.make_quantized_fl_round_step(cfg, tbundle, opt, shared,
                                                       bits=int(wire[3]), error_feedback=ef)
    else:
        step = cross_silo.make_fl_round_step(cfg, tbundle, opt, shared, agg=wire)
    residual = cross_silo.init_ef_residual(silo) if ef else None
    groups = cross_silo.shared_groups(cfg, silo.params, shared)
    shared_names = [n for g in groups for n in g]
    weights = torch.tensor(CROSS_SILO_WEIGHTS, device=dev)
    key = prng.PRNGKey(run["seed"], device=dev)
    spec = make_batch_specs(cfg, "train", n_silos * run["batch"], run["seq"])
    tokens = math.prod(spec["tokens"][0])
    losses, times, wire_checked = [], [], {}
    int_wire = wire in ("int8", "int4", "int8+ef")
    spy = first_wire_call_checked(wire_checked) if int_wire else contextlib.nullcontext()
    kernels.reset_launch_counts()
    with spy:
        for r in range(rounds):
            key, sub = prng.split(key)
            flat = make_concrete_batch(cfg, "train", n_silos * run["batch"], run["seq"], sub)
            batch = {k: v.to(dev).reshape(n_silos, run["batch"], *v.shape[1:]) for k, v in flat.items()}
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            if ef:
                silo, state, residual, loss = step(silo, state, residual, batch, weights)
            else:
                silo, state, loss = step(silo, state, batch, weights)
            end.record()
            times.append((start, marks[-1], end))
            losses.append(loss)
            for n in shared_names:
                p = silo.params[n]
                check(all(torch.equal(p[s], p[0]) for s in range(1, n_silos)),
                      f"[cross_silo] {cfg.name} {wire}: {n} differs across silos after round {r + 1}")
            if r == 0:
                check(not torch.equal(silo.params["head"][0], silo.params["head"][1]),
                      f"[cross_silo] {cfg.name} {wire}: personal head equal across silos")
            if r == 0 and check_plain:
                plain = masked_aggregate_leaves_plain([snap.pop("embed")], weights[None])[0]
                check(same(plain, silo.params["embed"][0].reshape(-1)), f"[cross_silo] {cfg.name}: "
                      f"round 1's embed mean is not bitwise masked_aggregate_leaves_plain")
                del plain
    counts = kernels.launch_counts()
    torch.cuda.synchronize()
    want = expected_cross_silo_launches(cfg, silo, rounds, wire, shared)
    check(counts == want, f"[cross_silo] {cfg.name} {wire}: launches {counts}, expected {want}")
    losses = torch.stack(losses).cpu().tolist()
    check(all(np.isfinite(losses)), f"[cross_silo] {cfg.name} {wire}: losses {losses}")
    if int_wire:
        for name in ("quantize", "dequantize"):
            check(wire_checked.get(name, 0) > 0, f"[cross_silo] {cfg.name} {wire}: the first "
                  f"{name} call is not bitwise its plain version ({wire_checked.get(name)})")
    if ef:
        check(all(not residual[n].any() for n in silo.params if n not in set(shared_names)),
              f"[cross_silo] {cfg.name}: an EF residual is non-zero on a personal name")
        check(bool(residual["embed"].any()), f"[cross_silo] {cfg.name}: embed's EF residual is 0")
    ms = [(a.elapsed_time(c), a.elapsed_time(b), b.elapsed_time(c)) for a, b, c in times]
    med = [statistics.median(x[i] for x in ms[1:]) for i in range(3)]
    n_shared = sum(silo.params[n][0].numel() for n in shared_names)
    depth = f" cut to {cfg.n_layers} layers" if cfg.n_layers < get_config(cfg.name).n_layers else ""
    print(f"[cross_silo] {cfg.name} full width{depth} ({n_params / 1e9:.3f} B params, "
          f"{n_shared / 1e9:.3f} B shared: {len(groups)} JAX leaves), {cfg.dtype}, {n_silos} silos "
          f"x ({run['batch']} x {tokens // (n_silos * run['batch'])} tokens), weights "
          f"{list(CROSS_SILO_WEIGHTS)}, shared_periods {shared}, wire {wire}: losses "
          f"{[round(x, 4) for x in losses]}; round ms (CUDA events) median {med[0]:.2f} of "
          f"{[round(x[0], 2) for x in ms]} = local steps {med[1]:.2f} + aggregation {med[2]:.3f} "
          f"(round 1: {ms[0][1]:.2f} + {ms[0][2]:.3f}); {1e3 * tokens / med[0]:.0f} tok/s; wire "
          f"bytes a silo a round {json.dumps({k: int(v) for k, v in wire_bytes(silo, groups).items()})}"
          f"; peak memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB; "
          + (f"the first wire call bitwise quantize_leaves_plain / dequantize_leaves_plain "
             f"({wire_checked['quantize']:,} / {wire_checked['dequantize']:,} elements); "
             if int_wire else "") + f"launches "
          f"{json.dumps({k: v for k, v in counts.items() if v})}; {card}")
    row = {}
    if check_plain:
        rows = silo.params["embed"].reshape(n_silos, -1)
        w2 = weights[None]
        t = device_ms(lambda: masked_aggregate_leaves([rows], w2))
        t_plain = cuda_ms(lambda: masked_aggregate_leaves_plain([rows], w2), reps=3, warmup=1)
        w_lib = (weights / weights.sum()).to(rows.dtype)
        t_lib = cuda_ms(lambda: torch.mv(rows.t(), w_lib))
        n = rows.shape[1]
        bound, by = bound_ms((n_silos + 1) * n * rows.element_size(), 2 * n_silos * n)
        row = {"cross_silo_embed_ms": t, "cross_silo_embed_plain_ms": t_plain,
               "cross_silo_embed_bound_ms": bound, "cross_silo_embed_bound_by": by,
               "cross_silo_embed_library_ms": t_lib}
        print(f"[cross_silo] masked_aggregate at {cfg.name}'s embed rows ({n_silos}, {n:,}) bf16 "
              f"(graph replay): {t:.4f} ms, bound {bound:.4f} ({by}), plain {t_plain:.3f}, "
              f"torch.mv(x.T, w / sum w) {t_lib:.4f}; bitwise the plain version in round 1; {card}")
    del silo, state, residual
    gc.collect()
    torch.cuda.empty_cache()
    return counts, row


def phase_cross_silo(dev: torch.device, card: str) -> tuple[dict, dict, dict]:
    """Cross-silo FL of the LMs at full width (``CROSS_SILO``), each run
    through ``cross_silo_run``. Returns (the launches by kernel, the
    launches by kernel and arch, masked_aggregate's embed row)."""
    total, by_arch, embed = dict.fromkeys(kernels.KERNELS, 0), {}, {}
    for arch, layers, wires in CROSS_SILO:
        cfg = get_config(arch)
        if layers:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        for wire in wires:
            counts, row = cross_silo_run(dev, cfg, wire, card,
                                         check_plain=(arch, wire) == ("granite-3-8b", "fp32"))
            embed.update(row)
            for name, n in counts.items():
                total[name] += n
                if n:
                    by_arch.setdefault(name, {}).setdefault(arch, 0)
                    by_arch[name][arch] += n
    return total, by_arch, embed


# ---------------------------------------------------------------------------
# [dryrun]: the dry run's predictions and the runs they predict
# ---------------------------------------------------------------------------

DRYRUN_SCRIPT = """
import dataclasses, json, sys
from repro_torch.configs import get_config
from repro_torch.launch.dryrun import run_one
for case in json.loads(sys.argv[1]):
    cfg = get_config(case["arch"])
    if case.get("reduced"):
        cfg = dataclasses.replace(cfg.reduced(), dtype="float32")
    if case.get("layers"):
        cfg = dataclasses.replace(cfg, n_layers=case["layers"])
    r = run_one(case["arch"], case["shape"], mesh=case["mesh"], cfg=cfg, batch=case.get("batch"),
                seq=case.get("seq"), zero=False if case.get("serve") else None,
                fl_shared=case.get("fl_shared"), seq_parallel=case.get("seq_parallel", False),
                verbose=False)
    print("DRYRUN " + json.dumps(dict(r, key=case["key"])), flush=True)
"""


def start_dryruns(cases: list, name: str) -> tuple:
    """The dry runs of ``cases`` (dicts: key, arch, shape, mesh (None: the
    production mesh, []: one card), batch, seq, layers, reduced, serve,
    fl_shared, seq_parallel) in DRYRUN_PROCS processes of their own, a train step
    counted as DRYRUN_TRAIN_COST of the others in sharing them out; each
    sees no card (the dry run needs none: fake tensors over a fake process
    group) and writes to ``build/dryrun_<name>_<i>.log``. Returns (the
    processes and their logs, the start time)."""
    root = Path(__file__).resolve().parent
    (root / "build").mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(root / "src"), CUDA_VISIBLE_DEVICES="",
               OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    shares = [[] for _ in range(min(DRYRUN_PROCS, len(cases)))]
    loads = [0] * len(shares)
    for case in sorted(cases, key=lambda c: c["shape"] != "train_4k"):  # heaviest first
        i = loads.index(min(loads))
        shares[i].append(case)
        loads[i] += DRYRUN_TRAIN_COST if case["shape"] == "train_4k" else 1
    procs = []
    for i, share in enumerate(shares):
        log = root / "build" / f"dryrun_{name}_{i}.log"
        with open(log, "w") as out:
            procs.append((subprocess.Popen(
                [sys.executable, "-c", DRYRUN_SCRIPT, json.dumps(share)], env=env, cwd=str(root),
                stdout=out, stderr=subprocess.STDOUT), log))
    return procs, time.perf_counter()


def collect_dryruns(procs: list, started: float, timeout: float = DRYRUN_TIMEOUT_S) -> dict:
    """The results of ``start_dryruns``' processes by key, once they have
    ended (killed at ``timeout`` from the start); raises if one failed."""
    out = {}
    for proc, log in procs:
        try:
            rc = proc.wait(timeout=max(1.0, started + timeout - time.perf_counter()))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            rc = "timeout"
        text = log.read_text()
        check(rc == 0, f"[dryrun] the dry-run process {log.name} ended with {rc}: "
              f"{text[-3000:]}")
        for line in text.splitlines():
            if line.startswith("DRYRUN "):
                r = json.loads(line[len("DRYRUN "):])
                out[r["key"]] = r
    print(f"[dryrun] {len(out)} traces in {len(procs)} processes: "
          f"{time.perf_counter() - started:.1f} s")
    return out


def dryrun_cases() -> list:
    """[dryrun]'s traces: DRYRUN_ARCH's four shapes on each DRYRUN_MESHES
    mesh, and the one-card predictions of DRYRUN_REAL and the whole-card
    batch of DRYRUN_WHOLE_CARD."""
    cases = [{"key": f"{shape} {mesh}", "arch": DRYRUN_ARCH, "shape": shape,
              "mesh": None if mesh is None else list(mesh)}
             for mesh in DRYRUN_MESHES for shape in ("train_4k", "prefill_32k", "decode_32k",
                                                     "long_500k")]
    cases += [{"key": label, "arch": arch, "shape": shape, "mesh": [], "batch": batch,
               "layers": layers}
              for label, arch, shape, batch, layers, _ in (*DRYRUN_REAL, DRYRUN_WHOLE_CARD)]
    return cases


def dryrun_real_run(dev: torch.device, arch: str, shape_name: str, batch: int, layers: int,
                    steps: int) -> tuple[int, dict]:
    """``steps`` steps of ``arch`` (cut to ``layers``) at ``shape_name``'s
    sequence and ``batch`` on the card, as the dry run traced one: random
    weights from seed 0, a train step's AdamW(3e-4), a decode step's cache
    from ``init_cache`` (long_500k: the 8,192-key ring). Returns (the peak
    bytes the run's tensors held above what the card held before it, the
    kernel launches, counts zeroed just before the steps)."""
    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    shape = dataclasses.replace(dryrun.get_shape(shape_name), global_batch=batch)
    window = dryrun.window_for(cfg, shape)
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev)
    bundle = get_model(cfg)
    model = bundle.init(torch.Generator(device=dev).manual_seed(0))
    key = prng.PRNGKey(0, device=dev)
    if shape.kind == "decode":
        cache = bundle.init_cache(batch, shape.seq_len, window, dev)
        token = prng.randint(key, (batch, 1), 0, cfg.vocab_size)
        step = bundle.make_decode_step(window=window)
        run = lambda: step(model, cache, token)[0]  # noqa: E731
    else:
        data = {k: v.to(dev) for k, v in make_concrete_batch(cfg, shape.kind, batch, shape.seq_len,
                                                             key).items()}
        if shape.kind == "train":
            opt = adamw(3e-4)
            state = opt.init(transformer.param_tree(model))
            step = bundle.make_train_step(opt, window=window)
            run = lambda: step(model, state, data)[2]  # noqa: E731
        else:
            step = bundle.make_prefill_step(window=window)
            run = lambda: step(model, data)[0]  # noqa: E731
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launch_counts()
    for _ in range(steps):
        out = run()
    torch.cuda.synchronize(dev)
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev) - base
    check(bool(torch.isfinite(out).all()), f"[dryrun] {arch} {shape_name}: non-finite output")
    del model, out
    gc.collect()
    torch.cuda.empty_cache()
    return peak, counts


def long_attention_check(dev: torch.device, card: str) -> dict:
    """flash_attention at S = 32,768 (LONG_ATTENTION, granite's layer) held
    to ``bf16_contract`` against its plain version on kv head 0's query
    heads, and timed beside the plain version's time on that slice."""
    b, s, h, hkv, d = LONG_ATTENTION
    g = torch.Generator(device=dev).manual_seed(7)
    q = torch.randn((b, s, h, d), generator=g, device=dev).to(torch.bfloat16)
    k = torch.randn((b, s, hkv, d), generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn((b, s, hkv, d), generator=g, device=dev).to(torch.bfloat16)
    got = flash_attention(q, k, v, causal=True)
    n = LONG_ATTENTION_HEADS
    qs, ks, vs = q[:, :, :n].contiguous(), k[:, :, :1].contiguous(), v[:, :, :1].contiguous()
    t0 = time.perf_counter()
    want = flash_attention_plain(qs, ks, vs, causal=True)
    torch.cuda.synchronize(dev)
    plain_s = time.perf_counter() - t0
    report = bf16_contract(got[:, :, :n], want, qs, ks, vs, causal=True)
    check(report["ok"], f"[dryrun] flash_attention at S = {s} fails its bf16 contract: {report}")
    ms = device_ms(lambda: flash_attention(q, k, v, causal=True), reps=5)
    print(f"[dryrun] flash_attention B={b} S={s} H={h} Hkv={hkv} D={d} causal, bf16: heads "
          f"0..{n - 1}"
          f" against the plain version (kernels/flash_attention/contract.py bf16_contract): "
          f"{json.dumps(report)}; kernel {ms:.3f} ms (CUDA events), the plain version on {n} "
          f"heads {plain_s:.2f} s; {card}")
    del q, k, v, got, want
    gc.collect()
    torch.cuda.empty_cache()
    return {"long_ms": ms, "long_s": s, "long_contract": report["ok"]}


def phase_dryrun(dev: torch.device, card: str, results: dict) -> tuple[dict, dict]:
    """[dryrun]: the traces of ``dryrun_cases`` (``results``, by key), one
    line each (GiB a rank, fits in 80 GB or not, collective MB by kind);
    then each DRYRUN_REAL run on the card where its prediction fits
    (DRYRUN_WHOLE_CARD's does not: not attempted), its predicted peak
    within DRYRUN_PEAK_REL of the measured one and its predicted launches,
    times its steps, equal to the kernels' counters; then
    ``long_attention_check``. Returns (the launches by kernel, the
    flash_attention row's keys)."""
    t0 = time.perf_counter()
    for mesh in DRYRUN_MESHES:
        for shape in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
            print(dryrun.summary_line(results[f"{shape} {mesh}"]))
    launches = dict.fromkeys(kernels.KERNELS, 0)
    for label, arch, shape, batch, layers, steps in (DRYRUN_WHOLE_CARD, *DRYRUN_REAL):
        pred = results[label]
        want_gib = pred["memory"]["peak_bytes"] / 2**30
        if not pred["fits"]:
            print(f"[dryrun] {label} on one card: the dry run predicts {want_gib:.2f} GiB, more "
                  f"than the card's 80 GB: the real run is not attempted")
            continue
        peak, counts = dryrun_real_run(dev, arch, shape, batch, layers, steps)
        want_launches = {k: pred["launches"].get(k, 0) * steps for k in kernels.KERNELS}
        gap = peak / pred["memory"]["peak_bytes"] - 1
        print(f"[dryrun] {label} (batch {batch}{f', {layers} layers' if layers else ''}, {steps} "
              f"step{'s' if steps > 1 else ''}) on the card: predicted peak {want_gib:.3f} GiB "
              f"(launch/dryrun.py), torch.cuda.max_memory_allocated {peak / 2**30:.3f} GiB "
              f"above the card's prior use ({100 * gap:+.2f}%); predicted launches "
              f"{json.dumps({k: v for k, v in want_launches.items() if v})}, counted "
              f"{json.dumps({k: v for k, v in counts.items() if v})}; {card}")
        check(abs(gap) <= DRYRUN_PEAK_REL, f"[dryrun] {label}: measured peak {peak} against the "
              f"predicted {pred['memory']['peak_bytes']} ({100 * gap:+.2f}%)")
        check(counts == want_launches, f"[dryrun] {label}: launches {counts}, predicted "
              f"{want_launches}")
        for k, n in counts.items():
            launches[k] += n
    row = long_attention_check(dev, card)
    print(f"[dryrun] {time.perf_counter() - t0:.1f} s")
    return launches, row


def train_world_cases(run: dict, cpu: bool) -> list:
    """The dry runs of --train-world: one train step of each TRAIN_WORLD
    case at ``run``'s batch and sequence, and one round of the cross-silo
    world case (``cross_silo_world``) on (4, 1)."""
    cases = [{"key": world_key(arch, shape, sp), "arch": arch, "shape": "train_4k",
              "mesh": list(shape), "batch": run["batch"], "seq": run["seq"], "reduced": cpu,
              "seq_parallel": sp}
             for arch, shape, sp in TRAIN_WORLD]
    silo = dict(CROSS_SILO_RUN, seq=64) if cpu else CROSS_SILO_RUN
    cases.append({"key": "cross_silo", "arch": "granite-3-8b", "shape": "train_4k",
                  "mesh": [4, 1], "batch": 4 * silo["batch"], "seq": silo["seq"],
                  "reduced": cpu, "fl_shared": silo["shared"],
                  "layers": 0 if cpu else dict((a, n) for a, n, _ in CROSS_SILO)["granite-3-8b"]})
    return cases


def ep_world_cases(run: dict, cpu: bool) -> list:
    """The dry runs of --ep-world: each EP_WORLD case's prefill of ``run``'s
    batch and prompt and its decode step over the prompt and the new
    tokens, in the port's serving layout (tensor-parallel blocks, no
    ZeRO)."""
    return [{"key": f"{arch} {shape} {kind}", "arch": arch, "shape": f"{kind}_32k",
             "mesh": list(shape), "batch": run["batch"], "serve": True, "reduced": cpu,
             "seq": run["prompt_len"] + (run["max_new"] if kind == "decode" else 0)}
            for arch, shape in EP_WORLD for kind in ("prefill", "decode")]


def world_prediction_line(tag: str, pred: dict, measured_gib) -> str:
    """One line: the dry run's prediction for a four-card case beside its
    measured peak a rank."""
    mem = pred["memory"]
    return (f"[{tag}] dry run (launch/dryrun.py, rank 0 of {pred['n_chips']}, {pred['layout']}) "
            f"of {pred['arch']} {pred['shape']} x {pred['global_batch']} x {pred['seq_len']} on "
            f"{pred['mesh']}: predicted peak {mem['peak_bytes'] / 2**30:.2f} GiB a rank (arguments "
            f"{mem['argument_bytes'] / 2**30:.2f} GiB), collectives "
            f"{pred['collective_bytes_per_device'] / 1e6:.1f} MB "
            f"{json.dumps({k: round(v / 1e6, 1) for k, v in pred['collectives'].items()})}; "
            f"measured peak GiB by rank {measured_gib}")


def cross_silo_world(dev: torch.device, mesh, card: str, cpu: bool, pred: dict | None) -> list:
    """The cross-silo round over a (4, 1) mesh (``make_mesh_fl_round_step``:
    silo i on data rank i, Eq. 1 through masked_aggregate's partial and
    combine modes and one all-reduce): granite-3-8b at [cross_silo]'s depth
    (the reduced float32 config on the CPU), CROSS_SILO_RUN's rounds,
    shared periods, weights and batches (silo i's rows of each), round 1
    traced with torch.profiler; then on rank 0 the single-process round
    (``make_fl_round_step``, the fp32 wire) on the same inputs. Held: every
    parameter of each rank bitwise silo i's of the single-process round
    (SHA-256 of each leaf's bytes), the losses equal, and the traced
    collective bytes equal to the dry run's ``collective_bytes`` of one
    round (``pred``). Returns this rank's failures."""
    import hashlib

    run = dict(CROSS_SILO_RUN, seq=64) if cpu else CROSS_SILO_RUN
    cfg = get_config("granite-3-8b")
    cfg = dataclasses.replace(cfg.reduced(), dtype="float32") if cpu else \
        dataclasses.replace(cfg, n_layers=dict((a, n) for a, n, _ in CROSS_SILO)["granite-3-8b"])
    n_silos, shared, rounds = mesh.shape["data"], run["shared"], run["rounds"]
    bundle, opt = get_model(cfg), adamw(run["lr"])
    weights = torch.tensor(CROSS_SILO_WEIGHTS, device=dev)
    key, batches = prng.PRNGKey(run["seed"], device=dev), []
    for _ in range(rounds):
        key, sub = prng.split(key)
        batches.append({k: v.to(dev) for k, v in make_concrete_batch(
            cfg, "train", n_silos * run["batch"], run["seq"], sub).items()})

    def digests(model) -> dict:
        return {n: hashlib.sha256(p.detach().contiguous().view(torch.uint8).cpu().numpy()
                                  .tobytes()).hexdigest()
                for n, p in transformer.param_tree(model).items()}

    i = mesh.index("data")
    with cross_silo.silo_context(mesh):
        model = bundle.init(torch.Generator(device=dev).manual_seed(run["seed"]))
    state = opt.init(transformer.param_tree(model))
    step = cross_silo.make_mesh_fl_round_step(cfg, bundle, opt, shared, mesh)
    losses, traced = [], None
    rows = slice(i * run["batch"], (i + 1) * run["batch"])
    with tempfile.TemporaryDirectory(dir=Path(__file__).resolve().parent / "build") as tmp:
        for r, batch in enumerate(batches):
            mine = {k: v[rows] for k, v in batch.items()}
            if r == 0:
                with torch.profiler.profile(record_shapes=True) as prof:
                    model, state, loss = step(model, state, mine, weights)
                    if not cpu:
                        torch.cuda.synchronize(dev)
                prof.export_chrome_trace(os.path.join(tmp, "trace.json"))
                traced = collective_bytes(os.path.join(tmp, "trace.json"))
            else:
                model, state, loss = step(model, state, mine, weights)
            losses.append(float(loss))
    mine = digests(model)
    del model, state
    gc.collect()
    if not cpu:
        torch.cuda.empty_cache()
    every = [None] * mesh.world
    dist.all_gather_object(every, (i, mine, losses, traced))
    failures = []
    if mesh.rank == 0:
        base = bundle.init(torch.Generator(device=dev).manual_seed(run["seed"]))
        silo = cross_silo.silo_params_from_model(base, n_silos)
        del base
        states = cross_silo.init_silo_opt(opt, silo)
        single = cross_silo.make_fl_round_step(cfg, bundle, opt, shared, agg="fp32")
        want_losses = []
        for batch in batches:
            stacked = {k: v.reshape(n_silos, run["batch"], *v.shape[1:]) for k, v in batch.items()}
            silo, states, loss = single(silo, states, stacked, weights)
            want_losses.append(float(loss))
        want = [digests(m) for m in silo.models]
        del silo, states
        bad = [(si, n) for si, got, _, _ in every for n in got if got[n] != want[si][n]]
        if bad or any(lo != want_losses for _, _, lo, _ in every):
            failures.append(f"[cross_silo world] leaves that differ from the single-process "
                            f"round (silo, name): {bad[:8]} ({len(bad)}); losses "
                            f"{[lo for _, _, lo, _ in every]} against {want_losses}")
        total = [t.get("total", 0) for _, _, _, t in every]
        if pred is not None and any(t != pred["collective_bytes_per_device"] for t in total):
            failures.append(f"[cross_silo world] traced collective bytes by rank {total}, the dry "
                            f"run's {pred['collective_bytes_per_device']}")
        print(f"[cross_silo world] {cfg.name} ({cfg.n_layers} layers, {cfg.dtype}) on (data, "
              f"model) = {tuple(mesh.shape.values())}, {n_silos} silos (one a data rank) x "
              f"{run['batch']} x {run['seq']} tokens, {rounds} rounds, shared_periods {shared}, "
              f"weights {list(CROSS_SILO_WEIGHTS)}: losses {want_losses}; every rank's "
              f"parameters {'bitwise' if not bad else 'NOT bitwise'} the single-process round's "
              f"silo (SHA-256 of {len(want[0])} leaves each); round 1's collectives traced "
              f"(torch.profiler, {mesh.backend}) by rank {total} B "
              f"{json.dumps(every[0][3])}, the dry run's "
              f"{None if pred is None else pred['collective_bytes_per_device']} B "
              f"{None if pred is None else json.dumps(pred['collectives'])}; {card}")
        gc.collect()
        if not cpu:
            torch.cuda.empty_cache()
    return failures


def main() -> int:
    if sys.argv[1:2] == ["--shard-worker"]:  # one rank of [shard]'s gloo worlds
        return shard_worker(*sys.argv[2:])
    if sys.argv[1:2] == ["--nccl-world"]:  # one rank under torchrun
        return nccl_world_main(*sys.argv[2:])
    if sys.argv[1:2] == ["--ep-worker"]:  # one rank of [ep]'s gloo world
        return ep_worker(*sys.argv[2:])
    if sys.argv[1:2] == ["--ep-world"]:  # one rank under torchrun
        return ep_world_main(*sys.argv[2:])
    if sys.argv[1:2] == ["--tp-worker"]:  # one rank of [tp]'s gloo world
        return tp_worker(*sys.argv[2:])
    if sys.argv[1:2] == ["--train-mesh-worker"]:  # one rank of [train_mesh]'s gloo world
        return train_mesh_worker(*sys.argv[2:])
    if sys.argv[1:2] == ["--train-world"]:  # one rank under torchrun
        return train_world_main(*sys.argv[2:])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    card = phase_environment()
    pending = start_dryruns(dryrun_cases(), "card")  # traced during the build, not the timings
    try:
        phase_build()
    finally:  # the trace processes end before anything else runs
        predictions = collect_dryruns(*pending)
    table = phase_kernels(dev)
    table["masked_aggregate"].update(phase_edge_kernels(dev))
    table.update(phase_lm_kernels(dev))
    for name, row in phase_train_kernels(dev).items():  # beside [kernels]' tp_* keys
        table[name] = {**row, **table[name]}
    phase_goldens(dev)
    launches = {k: v for k, v in phase_main_path(dev).items() if k in FL_KERNELS}
    phase_loop(dev, card)
    table["masked_aggregate"].update(phase_shard_kernels(dev))
    shard_counts = phase_shard_nccl(dev, card)
    for mode in ("partial", "combine"):
        table["masked_aggregate"][f"{mode}_launches"] = shard_counts[f"masked_aggregate_{mode}"]
    phase_shard_gloo(dev, card)
    table["masked_aggregate"].update(phase_merge(dev))
    table["masked_aggregate"]["merge_launches"] = phase_async(dev, card)
    phase_faults(dev)
    phase_resume(dev)
    table["masked_aggregate"]["edge_launches"] = phase_population(dev, card)
    phase_obs(dev, card)
    for name, n in phase_classify(dev, card).items():
        table[name]["classify_launches"] = n
    phase_lm_reference(dev)
    phase_serve_record(dev)
    table["flash_attention"]["moe_layer"] = phase_moe_layer(dev)
    serve_launches = {arch: phase_serve(dev, arch) for arch in SERVE_ARCHS}
    with image_t_stream_batches():
        image = phase_serve(dev, "qwen2-vl-2b", label="qwen2-vl-2b (an image's t stream)")
    chunked = phase_chunked_prefill(dev)
    for name in ("ssm_scan", "flash_attention"):
        by_arch = {a: c[name] for a, c in serve_launches.items() if c[name]}
        table[name]["launches_by_arch"] = by_arch
        table[name]["image_serve_launches"] = image[name]
        table[name]["chunked_prefill_launches"] = chunked[name]
        launches[name] = sum(by_arch.values()) + image[name] + chunked[name]
    ep_launches = phase_ep(dev, card)
    for name in ("ssm_scan", "flash_attention"):
        table[name]["ep_launches"] = ep_launches[name]
        launches[name] += ep_launches[name]
    tp_launches = phase_tp(dev, card)
    for name in ("ssm_scan", "flash_attention"):
        table[name]["tp_launches"] = tp_launches[name]
        launches[name] += tp_launches[name]
    phase_train_reference(dev)
    train_launches = phase_train(dev, card)
    for name in ("ssm_scan", "flash_attention"):  # the forward kernels train too
        by_arch = {a: c[name] for a, c in train_launches.items() if c[name]}
        table[name]["train_launches_by_arch"] = by_arch
        launches[name] += sum(by_arch.values())
    for name in ("ssm_scan_bwd", "flash_attention_bwd"):
        by_arch = {a: c[name] for a, c in train_launches.items() if c[name]}
        table[name]["launches_by_arch"] = by_arch
        launches[name] = sum(by_arch.values())
    mesh_launches = phase_train_mesh(dev, card)
    for name in ("ssm_scan", "flash_attention", "ssm_scan_bwd", "flash_attention_bwd"):
        table[name]["train_mesh_launches"] = mesh_launches[name]
        launches[name] += mesh_launches[name]
    silo_total, silo_by_arch, silo_embed = phase_cross_silo(dev, card)
    table["masked_aggregate"].update(silo_embed)
    for name in FL_KERNELS:
        table[name]["cross_silo_launches"] = silo_total[name]
        launches[name] += silo_total[name]
    for name in ("ssm_scan", "flash_attention", "ssm_scan_bwd", "flash_attention_bwd"):
        table[name]["cross_silo_launches_by_arch"] = silo_by_arch.get(name, {})
        launches[name] += silo_total[name]
    dry_launches, long_row = phase_dryrun(dev, card, predictions)
    table["flash_attention"].update(long_row)
    for name in ("ssm_scan", "flash_attention", "ssm_scan_bwd", "flash_attention_bwd"):
        table[name]["dryrun_launches"] = dry_launches[name]
        launches[name] += dry_launches[name]
    print(json.dumps({"kernels": [{"name": name, "launches": launches[name], **row}
                                  for name, row in table.items()]}))
    print(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
