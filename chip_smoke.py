#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card, end to end.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Phases (any failed check raises and exits non-zero):

  1. device: name, count, versions, ``nvidia-smi`` name and power limit;
  2. build: every kernel in ``src/repro_torch/kernels/csrc`` with nvcc
     (one process per source, all at once), with ptxas's register,
     shared-memory and spill report, and the count of tensor-core
     instructions (``HGMMA``, ``HMMA``) in each library's SASS
     (``cuobjdump -sass``): the matmul and flash libraries (B2's backward
     too) must hold HGMMA, the SSD library HGMMA or HMMA; B2's backward
     wgmma kernels and B3's backward kernels must spill nothing and ptxas
     must serialise none of their libraries' wgmma (``check_bwd_build``);
     then, while the process holds little host memory, deepseek-v3's MoE
     layer trained (``TRAIN_MOE_LAYER``: 2 dense MLA layers, the MoE layer
     and the MTP block at full width, 14.3 B parameters): one step with
     int8 moments and every large leaf in pinned host memory
     (host_offload 0.0, 66 GB pinned), prefetch on and off bit-equal on
     every leaf (``fingerprint``), the reckoned and measured bytes
     printed (its lines read ``[train]``);
  3. kernels against their plain PyTorch versions on the card: the
     reference's kernel test cases (``tests/test_kernels.py``) in float32
     (the FFMA variants) and bf16 (the tensor-core variants), a bf16 shape
     of each that the variant rule sends to the FFMA kernel, then the main
     path's full-width shapes and the matmul's backward (dx, dw) at full
     width, within ``kernels.ref.tolerance_ratio``'s bound (the reference's
     tolerances, and for bf16 a bound scaled to each output row); then a
     planted fault at full width (one tile skipped) that the bound must
     fail;
     the bf16 backward of a product with K = 100 (ROADMAP C5: dx's N is
     100, computed padded to 104); B2 at the models' attention shapes;
     The SSD scan likewise: the reference's cases at 2e-4; at
     mamba2-130m's full shape each of its three kernels (chunk state, state
     passing, chunk output) against its plain stage, then the scan against
     the one-loop oracle; and two planted faults: a plain version that drops
     one chunk's carry update, and the oracle run in single-pass TF32;
     the three kernels and the scan at zamba2-1.2b's shape too;
  4. the streaming executor over 6-stage granite-8b-width matmul and
     attention chains (bf16) — untiered oracle, unpaced probe, balanced
     throttle, best of 3 runs with prefetch on and off, every output
     ``torch.equal`` to the oracle, the kernels' launch counters matching
     the stages run (every bf16 launch through the tensor-core variant),
     the mean stage compute beside the unpaced copy of one stage's bytes,
     then the simulator calibrated and replayed;
  5. the model paths at full width in bf16, through ``get_model``'s entry
     points: mamba2-130m (24 layers), granite-8b (``[dense]``: 6 of its
     36 layers, ``DENSE``, B2 in every layer) and zamba2-1.2b (``[hybrid]``: 18
     of its 38 Mamba2 layers, ``HYBRID``, and the shared attention block
     after every 6, so B3 and B2 in one forward). For each: the weights drawn on the card from a
     seed and kept on the host; ``forward`` over 4 x 2048 tokens with every
     weight on the card (the oracle), then placed by ``host_offload`` at
     local fractions 0.5 and 0.0, prefetch on and off, every logits tensor
     ``torch.equal`` to the oracle, best-of-3 ms, host ms, bytes and peak
     memory per placement; greedy serving of 4 prompts (all local through
     ``ServingEngine.generate``, at 0.5 through the hand loop ``greedy``
     over ``decode_step``; tokens equal); each kernel's
     launches equal to its count a forward times the forwards (granite-8b:
     6 B2; zamba2-1.2b: 3 B2 and 18 B3; mamba2-130m: 24 B3), every B2
     launch through wgmma and each SSD kernel once a scan. Then the path
     check: the same forward with the kernels' plain versions (the plain
     SSD, the models' plain flash), in bf16 printed beside its floor (the
     plain forward with one plain version's output nudged) and held to
     ``PATH_BOUND`` in float32 (granite-8b on its 6 layers); and decode against
     forward in float32 over 512 tokens (granite-8b on 2 layers,
     zamba2-1.2b on 12). On granite-8b's weights, ``[engine]``: the port's
     serving layer at full width (below). Then ``[configs]``: the four
     configurations no other phase runs (``CONFIGS``, each at a cut
     depth: internvl2-1b, the vlm family with its 256 patches before the
     text; glm4-9b, starcoder2-7b and granite-34b) through the same
     ``drive_model`` and ``path_check``, a B2 launch a layer a forward at
     GQA groups of 7, 16, 9 and 48; then ``[moe]`` (below):
     deepseek-v3-671b and mixtral-8x7b; ``[encdec]`` (below):
     seamless-m4t-medium whole; then ``[train]`` (below): granite-8b,
     mamba2-130m, zamba2-1.2b and seamless-m4t-medium trained at full
     width, B2's lse and VJP, the backward kernels of B2 and B3 against
     their plain versions (B2's under mixtral's window beside SDPA's
     backward with the window as a mask; B3's at both widths it is
     instantiated on and at ragged shapes); then ``[mesh]`` (below):
     the sharding layer on a one-rank NCCL mesh; then ``[dryrun]``: the
     trace analysis's predicted peak of ``[train]``'s granite-8b step
     (fake CUDA tensors on a one-rank mesh, untiered and at host_offload
     0.5) held to the real step's within ``DRYRUN_BAND``, and two
     production cells traced over a 256-rank fake process group;
  6. kernel times at the main paths' shapes (CUDA events), per variant
     (the tensor-core kernel on the path and the FFMA kernel on the same
     bf16 inputs), beside the plain version's, one library call's (none for
     the SSD scan), and the card's bound (for the SSD scan at the rate of
     the instruction it uses, 3xTF32); the SSD scan's three kernels alone
     and ``ops.ssd_prep``, the prep in front of it; then B2 and B3 at the
     models' shapes (phase 3 checks them there too): B2 at granite-8b's,
     zamba2-1.2b's and deepseek-v3's MLA attention (D 192, Dv 128; both
     variants, and the backend SDPA picked) and at seamless-m4t-medium's
     three attentions (encoder full, decoder causal, cross with Sq 512 and
     Sk 1024; phase 3 checks them in bf16 and float32) through the models'
     route, B3 and ``ops.ssd_prep`` at zamba2-1.2b's scan;
  7. one JSON line ``{"kernels": [...]}``: the three forward kernels and
     the two backward kernels (``flash_attention_bwd``, ``ssd_scan_bwd``:
     their launches on the train steps, errors and times from
     ``[train]``);
  8. the last line, ``{"ok": true, "device": {...}}``.

``[engine]`` (in phase 5, granite-8b at full width, bf16): two
``ServingEngine.generate`` waves (4 prompts of 64 tokens, 16 new, a
128-slot cache, ``reset`` between) with tokens equal to the hand loop's; an
engine whose HBM budget demotes the K and V caches into a 2-node pool with 2
replicas, tokens equal and each demoted tier's pool payload equal to the
cache's bf16 bytes, ``offload_memory_kind`` ``"pinned_host"``; a
``ContinuousScheduler`` over that engine in lane mode (two tenants, 6
requests joining in pairs, one tenant's lanes offloaded to its pool arena),
every request's tokens equal to it run alone through a fresh lane-mode
engine; the engine's and ``decode_lanes``' step latencies (median, min) and
their device time and kernels a step under ``torch.profiler``; then
``python -m repro_torch.launch.serve --full``'s tokens/s. Decode launches
none of the port's kernels, so this path's launches are 0.

``[moe]`` (after ``[hybrid]``): deepseek-v3-671b and mixtral-8x7b at full
width, their depth cut to what one card holds (``MOE_MODELS``; the script
prints the config's bytes at full depth and the cut): weights drawn on the
card; ``forward`` over 4 x 2048 tokens all local, then at host_offload 0.5
(which must demote the routed experts first), prefetch on and off, logits
``torch.equal``; B2 once a layer a forward, every launch on the tensor
cores (deepseek-v3's MLA at D 192, mixtral's GQA at D 128 with its 4096
window); ``ServingEngine.generate`` of 4 prompts (64 tokens, 16 new)
untiered, then with ``expert_paging`` at 4x oversubscription (resident 64
of 256, 2 of 8): tokens and every cache leaf equal, with the pager's hit
rate, misses, sync fetches, bytes over the copy stream, simulated
degradation, step times and peak memory printed; then in float32, at the
depth float32 weights fit, the forward against the models' plain flash
(B2's FFMA kernel) and decode against forward without drops.

``[encdec]`` (after ``[moe]``): seamless-m4t-medium whole (12 encoder
and 12 decoder layers, d_model 1024, 16 heads of 64, vocab 256206) in
bf16 through ``get_model``'s ``encdec``: ``forward`` over 4 x (1024
frames, 512 tokens) all local and at host_offload 0.5 and 0.0, prefetch
on and off, logits ``torch.equal``, 36 B2 launches a forward all through
wgmma; the path check against the plain flash in float32 at full depth;
``prefill`` and 64 greedy tokens untiered and at host_offload 0.5, tokens
and every cache leaf equal; decode against forward in float32 over 2 x
128 tokens.

``[train]`` (after ``[encdec]``): the training path, granite-8b at full
width with its depth cut to 4 of 36 layers (``TRAIN``; 1.07 B parameters,
bf16, AdamW float32 moments, remat "full"). First B2 with its lse and
its VJP at the train step's attention shape (``TRAIN_FLASH``), in bf16
(wgmma) and float32 (FFMA): o bit-identical to the launch without the
lse, the lse against ``_fwd_all``'s on the same inputs in float32, dq, dk
and dv of the B2 Function against ``blocked_flash``'s autograd (dq's bf16
bound also carries o's rounding through ``delta``,
``kernels.ref.flash_dq_rounding_bound``), and a planted fault (dk without
one 128-key tile) that the bound must fail; the backward kernels
(``csrc/flash_attention_bwd.cu``) against their plain version
``_plain_bwd`` on the same saved o, lse and do, with a planted fault, and
two launches on the same inputs ``torch.equal``; B2's
forward, its backward kernels, the plain backward, SDPA's backward alone
and SDPA's forward and backward timed beside their bounds; the backward
kernels under mixtral-8x7b's sliding window (``TRAIN_FLASH_WINDOW``, which
no train step reaches) against ``_plain_bwd``, twice ``torch.equal``, with
a planted fault, timed beside their bound. Then one train
step from the same
weights and 2 x 2048-token batch (``SyntheticTokenDataset``) under each
of ``TRAIN_PLACEMENTS`` (untiered, prefetch off, host_offload 0.5 with
parameters and moments in the plan, remat "none"): the loss, every
gradient and every updated parameter and moment bit-equal to the
untiered step's (``fingerprint``: integer reductions over each leaf's raw
bits on the card, which any single flipped bit changes; no host copy of
the state), then the best of 3 step ms, host ms, peak memory, bytes
local and remote, and B2 launches a step (8: each layer's forward and its
recompute) and B2's backward kernels one launch a layer, one a call of
the Function's backward (counted in every profiled step and every
``[mesh]`` leg). Then ``adamw.leaf_update`` at int8 moments on one
full-width granite MLP leaf on the card against the CPU's (codes within
1, scales and parameters within 1e-6 of their max); the trainer's moment
ladder (``TRAIN_LADDER``: int8 moments with error-feedback gradient
compression, 2 microbatches and remat "dots"; bf16 moments under
"dots_no_batch"), one step of each untiered and at host_offload 0.5
bit-equal (loss, gradients and the gradients after the error feedback,
parameters, codes, scales, the error-feedback buffer), B2 launches a step
as ``step_launches`` counts them under the policy and the microbatches.
Then 10 steps of ``train.loop.train`` on a repeated
batch must lower the loss. Then B2's VJP and backward kernels at
zamba2-1.2b's D 64 and at seamless-m4t-medium's cross attention; B3's
backward kernels (``ssd_chunk_scan_bwd`` through ``_B3Function``) at
mamba2-130m's and zamba2-1.2b's train scans, the gradients against plain
autograd's through ``ssd_staged_plain`` within the forward's tolerance
scaled to each gradient, a planted fault (the kernels' dx without one
chunk's carry term) rejected, timed beside their bound and the plain VJP;
mamba2-130m, zamba2-1.2b and seamless-m4t-medium at full width and full
depth, the MoE family and ``CONFIGS``' four at their cut depths (B2's VJP
first at each of the four's train shapes, where the backward splits a
group's heads over more dk/dv CTAs wherever its grid is short of the card,
the split timed in turns against one part), one step untiered and at
host_offload 0.5, all ``torch.equal``,
their B2 and B3 launches a step as ``step_launches`` counts them; 10
mamba2-130m steps that must lower the loss; a run of the reduced float32
config killed after its checkpoint must resume with the uninterrupted run's losses (``==``); and
``python -m repro_torch.launch.train --device cuda`` must run 3 steps of
its default, reduced mamba2-130m, then ``LAUNCH_LADDER`` (full-width
mamba2-130m, int8 moments, compressed gradients, 2 microbatches, remat
"dots", host_offload 0.5) with a falling loss.

``[mesh]`` (after ``[train]``): a one-rank NCCL process group (its
``FileStore`` in a temporary directory) and a (1, 1) device mesh over
(data, model) with the default sharding rules; granite-8b at ``[train]``'s
width, depth and batch, one step under each of ``MESH_LEGS`` (without a
mesh; under the mesh with the state laid out by the spec trees; under
``fsdp_stream`` 0.5 with prefetch on and off, which on a data axis of one
split nothing and must post no gather, so they time the plain mesh step;
at host_offload 0.5): the loss, every gradient and every updated parameter
and moment ``torch.equal`` to the step without a mesh, B2's launches a
step 8 in every leg, each launch under the mesh through ``local_map``, the
best of 3 step ms, host ms and peak memory beside NCCL's version; then
``launch.train.main(MESH_LAUNCH)`` (``--mesh 1,1``) on that group, its
loss falling over 3 steps.

Three checks ride along. ``[serving-bench]`` (after ``[hpc]``):
``benchmarks/fig_autoscale.py``'s and ``fig_serving_mt.py``'s loops through
the port, the reduced granite-8b engine in float32 on the card, must give
``BENCH_pr5.json``'s and ``BENCH_pr9.json``'s values exactly (``latency_us``
printed, not compared), with autoscaled tokens equal to untiered ones and
lanes to the sequential oracle. ``[hpc]`` (after the build; both run in a
child process beside the card's phases, their output printed before
``[done]``): DOLMA's runtime and
its eight HPC workloads through the port, on this machine's Python and
numpy: ``benchmarks/run.py --bench-json``'s loop must give
``BENCH_pr3.json``'s simulated microseconds exactly (an InfiniBand-100G
fabric model on a simulated clock, not times taken on the card) and every
tiered checksum the oracle's, and the Fig 7 sweep the reference's average
memory saving at no more than 16 % slowdown. ``[c6]`` (in phase 5, on
granite-8b's weights): a decode step at and past the KV cache's length on
the card raises no device assert, a scalar step writes only the cache's
last slot, and a lane past the cache leaves its rows unchanged.

It imports nothing of JAX or the reference package ``repro``.
"""
from __future__ import annotations

import atexit
import dataclasses
import gc
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

# run-to-run equal cuBLAS results (the train step's contract) need this
# before the first cuBLAS call
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from profile_models import profiled, report  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.configs.granite_8b import CONFIG as GRANITE_8B  # noqa: E402
from repro_torch.configs.mamba2_130m import CONFIG as MAMBA2_130M  # noqa: E402
from repro_torch.configs.seamless_m4t_medium import (  # noqa: E402
    CONFIG as SEAMLESS,
)
from repro_torch.configs.zamba2_1_2b import CONFIG as ZAMBA2_1_2B  # noqa: E402
from repro_torch.core.tiering import (  # noqa: E402
    GATHERS,
    TieringConfig,
    _block_split,
    local_part,
    map_leaves,
    place_params,
    place_state,
    plan_for_params,
)
from repro_torch.core.exec import (  # noqa: E402
    StreamingExecutor,
    attention_chain,
    balanced_throttle,
    matmul_chain,
    untiered_oracle,
)
from repro_torch.core.fabric import FabricResource, SimClock  # noqa: E402
from repro_torch.core.objects import _leaves_with_keys  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402
from repro_torch.kernels import streaming_matmul as sm  # noqa: E402
from repro_torch.kernels import work  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.launch.mesh import (  # noqa: E402
    HBM_BYTES_PER_S,
    PEAK_FLOPS,
    make_smoke_mesh,
)
from repro_torch.kernels.ref import (  # noqa: E402
    NEG_INF,
    flash_dk_rounding_bound,
    flash_dq_rounding_bound,
    flash_ref,
    matmul_ref,
    outside_tolerance,
    reference_attention,
    ssd_grad_ratio,
    tolerance_ratio,
)
from repro_torch.models import get_model, make_batch  # noqa: E402
from repro_torch.models import encdec as ed  # noqa: E402
from repro_torch.models import flash as mflash  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.data.pipeline import (  # noqa: E402
    SyntheticTokenDataset,
    device_put_fn,
    to_device_fn,
)
from repro_torch.models import sharding as shd  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.optim import (  # noqa: E402
    CompressionConfig,
    QTensor,
    adamw,
    init_error_feedback,
)
from repro_torch.optim.compression import error_feedback_leaf  # noqa: E402
from repro_torch.optim.quantized import (  # noqa: E402
    quantizable,
    quantize_blocks,
)
from repro_torch.train import step as step_mod  # noqa: E402
from repro_torch.train.loop import LoopConfig, train  # noqa: E402
from repro_torch.train.step import (  # noqa: E402
    TrainStepConfig,
    make_train_step,
    make_value_and_grad,
)
from repro_torch.serving import (  # noqa: E402
    ContinuousScheduler,
    EngineConfig,
    ExpertPagingConfig,
    Request,
    SchedulerConfig,
    ServingEngine,
)

# the SSD kernels use the tensor cores' TF32 rate in three passes
TF32_PASSES = 3

# the reference's kernel tolerances (tests/test_kernels.py); bf16 is also
# held to a bound scaled to each output row (kernels.ref.tolerance_ratio)
MATMUL_TOL = {torch.float32: 1e-3, torch.bfloat16: 0.5}
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
MATMUL_CASES = [(128, 256, 128), (256, 512, 256), (128, 1024, 384),
                (384, 256, 512)]
FLASH_CASES = [  # B, H, KV, Sq, Sk, D, Dv, causal, window
    (1, 4, 2, 128, 128, 32, 32, True, None),
    (2, 4, 1, 128, 128, 32, 16, True, 64),     # MQA + SWA + MLA-dv
    (1, 2, 2, 128, 256, 32, 32, False, None),  # cross attention
    (1, 8, 4, 256, 256, 64, 64, True, None),
]
# bf16 shapes that the variant rules send to the FFMA kernels: K % 8 != 0
# (matmul), D and Dv not multiples of 16 (flash)
MATMUL_FFMA_BF16 = [(128, 100, 128)]
# a bf16 product whose backward's dx has N = K = 100 (ROADMAP C5)
MATMUL_C5 = (256, 100, 256)
FLASH_FFMA_BF16 = [(1, 2, 2, 128, 128, 40, 40, True, None)]
# the tensor-core instructions counted in each library's SASS, and those
# each library must hold at least one of: HGMMA (wgmma) or HMMA (mma.sync)
SASS_OPS = ("HGMMA", "HMMA")
NEEDS_TENSOR_CORES = {"streaming_matmul": ("HGMMA",),
                      "flash_attention": ("HGMMA",),
                      "flash_attention_bwd": ("HGMMA",),
                      "ssd_scan": ("HGMMA", "HMMA")}
# ptxas's note when it serialises a kernel's wgmma (C7512 to C7518)
WGMMA_SERIALISED = "wgmma.mma_async instructions are serialized"
# the backward kernels of each library, by a pattern of their mangled names,
# and how many ptxas must report: B2's 13 kernels of namespace tcb (12
# wgmma: dk/dv and dq at (D, Dv) padded to (64, 64), (64, 128), (128, 64),
# (128, 128), (192, 64) and (192, 128); and the reduce of a split group's
# parts); B3's
# key and row kernels and its chunk-state kernel's backward instantiation
# (its bool true) at widths 64 and 128, and its state passing
BWD_KERNELS = {"flash_attention_bwd": ("_ZN3tcb", 13),
               "ssd_scan": (r"ssd_bwd_|ssd_chunk_state_kernelILi\d+ELb1E", 7)}
# the reference's SSD tolerance (tests/test_kernels.py::TestSSDKernel);
# L, chunk, G with B 2, H 4, P 32, N 32, then one chunk and L < chunk
SSD_TOL = 2e-4
SSD_CASES = [(64, 32, 1), (64, 32, 2), (128, 32, 1), (128, 32, 2),
             (256, 64, 1), (256, 64, 2), (32, 32, 1), (16, 32, 2)]
# a ragged shape: Q = 48 fills neither a 64-row nor a 32-key tile, and P, N
# not multiples of 4 take the kernels' 4-byte copies
SSD_RAGGED = dict(B=1, H=2, L=96, P=30, N=20, chunk=48, G=1)
# mamba2-130m's chunk scan at the path's batch and prompt length
SSD_FULL = dict(B=4, H=24, L=2048, P=64, N=128, chunk=256, G=1)
# zamba2-1.2b's chunk scan, and B2 at the two models' attention shapes
# (causal, Dv = D), at the same batch and prompt length
SSD_ZAMBA = dict(B=4, H=64, L=2048, P=64, N=64, chunk=256, G=1)
FLASH_MODELS = {"granite-8b": dict(B=4, H=32, KV=8, S=2048, D=128),
                "zamba2-1.2b": dict(B=4, H=32, KV=32, S=2048, D=64),
                # deepseek-v3's MLA prefill: D = 128 nope + 64 rope, Dv 128,
                # v a slice of the (B, S, H, 128 + 128) up-projection
                "deepseek-v3-671b MLA": dict(B=4, H=128, KV=128, S=2048,
                                             D=192, Dv=128),
                # seamless-m4t-medium's three attentions ([encdec]'s forward
                # shapes): full over the 1024 frames, causal over the 512
                # tokens, and full from the tokens to the frames (Sk), each
                # checked in float32 (FFMA) too
                "seamless-m4t-medium encoder": dict(B=4, H=16, KV=16, S=1024,
                                                    D=64, causal=False,
                                                    f32=True),
                "seamless-m4t-medium decoder": dict(B=4, H=16, KV=16, S=512,
                                                    D=64, f32=True),
                "seamless-m4t-medium cross": dict(B=4, H=16, KV=16, S=512,
                                                  Sk=1024, D=64, causal=False,
                                                  f32=True),
                # [configs]' forward shapes: GQA groups of 7, 16, 9 and 48
                # (multi-query attention), internvl2-1b over its 256 patches
                # and 2048 tokens
                "internvl2-1b": dict(B=4, H=14, KV=2, S=2304, D=64),
                "glm4-9b": dict(B=4, H=32, KV=2, S=2048, D=128),
                "starcoder2-7b": dict(B=4, H=36, KV=4, S=2048, D=128),
                "granite-34b": dict(B=4, H=48, KV=1, S=2048, D=128)}
BEST_OF = 3
# the float32 plain-SSD forward's bound, as a share of max(1, max|logits|),
# float32's bound for decode against forward; why the check is held in
# float32 is written where it is used (phase_mamba)
PATH_BOUND = 1e-3
# [dense]: granite-8b at full width, its depth cut to 6 of 36 layers for
# the script's time limit (whole, the phase took 288 s; at 12 layers, with
# [configs] beside it, the script came near its limit)
DENSE = dict(n_layers=6)
# [hybrid] and zamba2-1.2b's train leg: 18 of its 38 layers (the shared
# attention block after layers 6, 12 and 18; remat "full" still nests at 12
# layers and more), cut for the script's time limit
HYBRID = dict(n_layers=18)
# [engine]: granite-8b served through ServingEngine at full width: waves of 4
# prompts of 64 tokens and 16 new ones in a 128-slot cache; a budget of 4
# MiB demotes every parameter and then the K and V caches (6.3 MB each at
# 6 layers)
ENGINE = dict(max_batch=4, max_len=128)
ENGINE_NEW = 16
ENGINE_TIERED = dict(hbm_budget_bytes=4 << 20, pool_nodes=2,
                     pool_replication=2)
# the lanes: two tenants, 6 requests of 16-token prompts and 16 new tokens,
# joining in three pairs while earlier ones decode
LANE_PROMPT, LANE_NEW, LANE_REQUESTS = 16, 16, 6
# steps of a profiled engine wave (8 prompt tokens, 8 new) and of the timed
# and profiled lane steps
PROFILE_STEPS = 16
# [moe]: the two MoE configurations at full width, their depth cut to what
# one card holds (a deepseek-v3 MoE layer alone holds 256 x 3 x 7168 x 2048
# routed parameters, 22.5 GB in bf16; mixtral's 32 layers ~90 GB of
# experts): deepseek-v3's 3 first_k_dense MLA + MLP layers, 1 MoE layer and
# the mtp block, mixtral's first 2 layers (cut for the script's time
# limit). Paging oversubscribes the expert bytes 4x (resident 64 of 256, 2
# of 8). The float32 checks run at the
# depth float32 weights fit (deepseek-v3: 1 dense + 1 MoE layer, 52 GB);
# decode against forward without drops (capacity factor 8, one dispatch
# group; deepseek-v3 on one lane: two lanes would share capacity 1)
MOE_MODELS = {
    "deepseek-v3-671b": dict(n_layers=4, resident=64, depth32=2, dense32=1,
                             lanes32=1, tokens32=64),
    "mixtral-8x7b": dict(n_layers=2, resident=2, depth32=2, dense32=0,
                         lanes32=2, tokens32=128),
}
MOE_PROMPT, MOE_NEW = 64, 16
# [configs]: the four configurations no other phase runs, at full width,
# each at one depth for all its legs here and in [train] (TRAIN_MODELS):
# internvl2-1b (the vlm family: 256 stub patch embeddings before the text)
# at 8 of 24 layers, glm4-9b at 2 of 40, starcoder2-7b at 2 of 32 and
# granite-34b at 2 of 88, cut for the train state (12 bytes a parameter,
# held twice at the functional update's peak) and the script's time limit
# (internvl2-1b whole and the other two at 4 layers took the script past
# 950 s; whole, granite-34b's 47 B parameters fill neither the card nor the
# host). The float32 path check runs at CONFIGS_DEPTH32 layers.
CONFIGS = {"internvl2-1b": dict(n_layers=8), "glm4-9b": dict(n_layers=2),
           "starcoder2-7b": dict(n_layers=2), "granite-34b": dict(n_layers=2)}
CONFIGS_DEPTH32 = 2
# the executor chains' depth at granite-8b's width: 6 of its 36 layers,
# cut for the script's time limit
CHAIN_STAGES = 6
# [train]: granite-8b trained at full width (d_model 4096, 32 heads with 8
# KV heads of 128, d_ff 14336, vocab 49152, tied embedding, bf16), its depth
# cut to 4 of its 36 layers: 1.07 B parameters, 2.1 GB of weights and as
# many of gradients, 8.6 GB of float32 moments; batches of 2 x 2048 tokens
# from SyntheticTokenDataset; remat "full", prefetch on, AdamW float32
# moments. Every placement runs one step from the same state and batch.
TRAIN = dict(n_layers=4, batch=2, seq=2048)
TRAIN_PLACEMENTS = {  # label: (TieringConfig, remat)
    "untiered": (TieringConfig(), "full"),
    "host_offload 0.5": (TieringConfig(mode="host_offload",
                                       local_fraction=0.5), "full"),
    "remat none": (TieringConfig(), "none"),
}
# the same at 12 layers (2.82 B parameters, 28 GB with the moments): the
# depth at which remat "full" nests (min_layers 12: 3 checkpointed blocks of 4
# checkpointed layers) and the dual buffer runs inside each block. At
# local_fraction 0.2 the plan demotes every moment and the MLP weights, so
# the layer loop streams 352 MB a layer (at 0.5 it demotes MLP moments
# alone, and prefetch has nothing to move)
TRAIN_DEEP = dict(n_layers=12)
TRAIN_DEEP_PLACEMENTS = {
    "untiered": (TieringConfig(), "full"),
    "remat full_flat": (TieringConfig(), "full_flat"),
    "host_offload 0.2": (TieringConfig(mode="host_offload",
                                       local_fraction=0.2), "full"),
    "host_offload 0.2 prefetch off": (TieringConfig(
        mode="host_offload", local_fraction=0.2, prefetch=False), "full"),
    "remat none": (TieringConfig(), "none"),
}
# the trainer's storage ladder and the options around it, on granite-8b at
# TRAIN's width, depth and batch: each leg one step untiered and at
# host_offload 0.5 (parameters, moments and the error-feedback buffer in
# the plan) under its remat policy, one warm and one timed step after the
# first
TRAIN_LADDER = {
    "int8 ladder": dict(moment_style="int8", remat="dots", step_kw=dict(
        compression=CompressionConfig(enabled=True), microbatches=2)),
    "bf16 ladder": dict(moment_style="bf16", remat="dots_no_batch",
                        step_kw={}),
}
# deepseek-v3's MoE layer trained on one card: 2 dense MLA layers, 1 MoE
# layer (256 routed experts of 2048 and a shared one, top 8) and the MTP
# block at full width, 14.3 B parameters over 2 x 2048 tokens in bf16,
# remat "full", int8 moments, every parameter and moment beyond the small
# objects in pinned host memory (host_offload 0.0): the MoE layer's 11.3 B
# routed parameters with f32 moments (135 GB with their gradients) fill no
# card, and f32 or bf16 moments (114 or 57 GB) do not fit this host beside
# the parameters. One step with prefetch on and one off from the same
# seed, held bit-equal by fingerprints on the card (no host copy of 86 GB
# of state fits beside the 58 GB placed); lr 1e-2, at which one step moves
# every bf16 leaf, the norms' ones too. No compression: the error-feedback
# buffer would be 57 GB of float32
TRAIN_MOE_LAYER = dict(n_layers=3, first_k_dense=2, batch=2, seq=2048,
                       lr=1e-2)
# the launcher with the ladder's flags: mamba2-130m at full width (its
# 768-wide embedding takes int8 moments), whose loss must fall
LAUNCH_LADDER = ["--arch", "mamba2-130m", "--full", "--moment-style", "int8",
                 "--compress-grads", "--microbatches", "2", "--remat", "dots",
                 "--tiering", "host_offload", "--local-fraction", "0.5",
                 "--device", "cuda", "--steps", "6", "--batch", "4", "--seq",
                 "512", "--lr", "1e-1"]
# the learning check: 10 steps on a repeated batch, lr 1e-3 from step 1
TRAIN_LEARN = dict(steps=10, lr=1e-3)
# B2's lse and VJP at granite-8b's attention shape in the train step
TRAIN_FLASH = dict(B=2, H=32, KV=8, S=2048, D=128)
# the restart check at the reduced float32 size (a full-width checkpoint
# holds 13 GB): 10 steps, a checkpoint every 5, the run killed after step 7
TRAIN_RESTART = dict(steps=10, ckpt_every=5, kill_at=7, batch=4, seq=64)
# B2's backward under a sliding window alone: mixtral-8x7b's attention
# widths and window (4096) over 8192 positions, the shape of its train leg
# (TRAIN_MODELS)
TRAIN_FLASH_WINDOW = dict(B=1, H=32, KV=8, S=8192, D=128, window=4096)
# B2's VJP at the other attention shapes the train steps run: zamba2-1.2b's
# shared block (D 64), seamless-m4t-medium's cross attention (Sq != Sk,
# full) and deepseek-v3's MLA (D 128 nope + 64 rope, Dv 128), at the train
# batch of 2; at MLA's the wgmma backward must take below a quarter of the
# FFMA kernels' time on the same inputs
TRAIN_FLASH_MORE = {
    "zamba2-1.2b shared block": dict(B=2, H=32, KV=32, S=2048, D=64),
    "seamless-m4t-medium cross": dict(B=2, H=16, KV=16, S=512, Sk=1024,
                                      D=64, causal=False),
    "deepseek-v3-671b MLA": dict(B=2, H=128, KV=128, S=2048, D=192, Dv=128,
                                 ffma_below=0.25),
    # [configs]' train shapes; "parts": the split of each group's heads the
    # dk/dv kernel takes there (fa._bwd_parts; 1 where absent), timed in
    # turns against one part on the same inputs
    "internvl2-1b": dict(B=2, H=14, KV=2, S=2304, D=64, parts=4),
    "glm4-9b": dict(B=2, H=32, KV=2, S=2048, D=128, parts=4),
    "starcoder2-7b": dict(B=2, H=36, KV=4, S=2048, D=128),
    "granite-34b": dict(B=2, H=48, KV=1, S=2048, D=128, parts=8)}
# the SSM, hybrid, enc-dec and MoE families trained at full width, one step
# per placement (parameters and moments in the plan at 0.5), remat "full":
# mamba2-130m whole and zamba2-1.2b at HYBRID's depth over 2 x 2048
# tokens, seamless-m4t-medium
# whole over 2 x (1024 frames, 512 tokens); deepseek-v3-671b at its first 2
# of 61 layers, both dense, with the MTP block, over 2 x 2048 tokens: MLA
# through B2 at D 192, Dv 128, 2.79 B parameters, f32 moments (its MoE
# layer trains in TRAIN_MOE_LAYER's leg); mixtral-8x7b at its first of 32
# layers (cut for the script's time limit) over 1 x 8192 tokens, so that
# its window of 4096
# cuts pairs: top-2 MoE dispatch under autograd and B2's windowed
# backward; CONFIGS' four at
# their depths over 2 x 2048 tokens (internvl2-1b 2 x (256 patches + 2048
# tokens)), where B2's backward meets groups of 7 to 48 heads. "batch"
# defaults to TRAIN's; "n_layers" and "first_k_dense" cut the depth
TRAIN_MODELS = {"mamba2-130m": dict(seq=2048),
                "zamba2-1.2b": dict(seq=2048, **HYBRID),
                "seamless-m4t-medium": dict(seq=512),
                "deepseek-v3-671b": dict(seq=2048, n_layers=2,
                                         first_k_dense=2),
                "mixtral-8x7b": dict(seq=8192, batch=1, n_layers=1),
                # CONFIGS' four at their [configs] depths
                **{name: dict(seq=2048, **spec)
                   for name, spec in CONFIGS.items()}}
TRAIN_MODEL_PLACEMENTS = {
    "untiered": (TieringConfig(), "full"),
    "host_offload 0.5": (TieringConfig(mode="host_offload",
                                       local_fraction=0.5), "full"),
}
# B3's backward kernels (through _B3Function) at one layer's scan in those
# train steps (batch 2, 2048 tokens, chunk 256)
B3_VJP = {"mamba2-130m": dict(B=2, H=24, L=2048, P=64, N=128, chunk=256,
                              G=1),
          "zamba2-1.2b": dict(B=2, H=64, L=2048, P=64, N=64, chunk=256, G=1)}
# ... and at ragged shapes, checked, not timed: N 72 runs the kernels at width
# 128 and N 20 at 64, both over zero-filled columns; P 40 and 30 leave zero
# columns of x and dy; Q 200 and 48 end in part tiles; P 30 and N 20 take
# the 4-byte copies
B3_VJP_RAGGED = {"ragged P40 N72 Q200": dict(B=1, H=3, L=400, P=40, N=72,
                                             chunk=200, G=1),
                 "ragged P30 N20 Q48": dict(B=1, H=2, L=96, P=30, N=20,
                                            chunk=48, G=1)}
# [encdec]: seamless-m4t-medium whole (12 encoder and 12 decoder layers,
# d_model 1024, 16 heads of 64, vocab 256206 padded to 258048), bf16: 4
# sources of the config's 1024 frames and 4 targets of 512 tokens (a
# translation's target is shorter than its source); prefill and 64 greedy
# tokens; decode against forward in float32 over 2 x 128 tokens
ENCDEC = dict(batch=4, tokens=512, new=64, lanes32=2, tokens32=128)
# [mesh]: the sharding layer on a one-rank NCCL process group and a (1, 1)
# mesh over (data, model), DEFAULT_RULES: granite-8b at [train]'s width,
# depth (4 of 36 layers) and batch, one step per leg from the same weights,
# every leg torch.equal to the one without a mesh (on one rank every
# redistribute is the identity and the local ops are the unsharded ones)
MESH_LEGS = {  # label: (under the mesh, TieringConfig)
    "no mesh": (False, TieringConfig(mode="none")),
    "mesh": (True, TieringConfig(mode="none")),
    "mesh fsdp_stream 0.5": (True, TieringConfig(mode="fsdp_stream",
                                                 local_fraction=0.5)),
    "mesh fsdp_stream 0.5 prefetch off": (True, TieringConfig(
        mode="fsdp_stream", local_fraction=0.5, prefetch=False)),
    "mesh host_offload 0.5": (True, TieringConfig(mode="host_offload",
                                                  local_fraction=0.5)),
}
# [dryrun]: [train]'s granite-8b step traced on fake CUDA tensors (a
# one-rank mesh) against the real step's peak, untiered and at
# host_offload 0.5; the predicted/measured peak ratio must lie in the band;
# then two production cells over a 256-rank fake group
DRYRUN_LEGS = {"untiered": TieringConfig(mode="none"),
               "host_offload 0.5": TieringConfig(mode="host_offload",
                                                 local_fraction=0.5)}
DRYRUN_BAND = (0.90, 1.10)
DRYRUN_CELLS = [("granite-8b", "train_4k"), ("deepseek-v3-671b", "decode_32k")]
# one cell's record, as a JSON line: run by [dryrun] in a process a cell
DRYRUN_CELL_CODE = """
import json, sys, time
t0 = time.perf_counter()
from repro_torch.launch import dryrun
rec = dryrun.run_cell(sys.argv[1], sys.argv[2], multi_pod=False)
rec["wall_s"] = time.perf_counter() - t0
print(json.dumps(rec, default=str))
"""
# [hpc] and [serving-bench], host work (numpy simulation, a reduced engine
# on the card), run in a process of their own beside the card's phases
HOST_PHASES_CODE = """
import chip_smoke as cs
dev = cs.phase_device()
cs.phase_hpc(dev)
cs.phase_serving_bench(dev)
"""
# the launcher over the one-rank mesh: reduced granite-8b (float32), whose
# loss must fall in 3 steps
MESH_LAUNCH = ["--arch", "granite-8b", "--mesh", "1,1", "--device", "cuda",
               "--steps", "3", "--batch", "4", "--seq", "64", "--lr", "3e-3"]


def zero_counts() -> None:
    """Every kernel's launch counts, variants included, back to 0."""
    sm.reset_launches()
    fa.reset_launches()
    ssd.reset_launches()


def counts() -> dict:
    return {"streaming_matmul": sm.LAUNCHES, "flash_attention": fa.LAUNCHES,
            "ssd_scan": ssd.LAUNCHES, "flash_attention_bwd": fa.BWD_LAUNCHES,
            "ssd_scan_bwd": ssd.BWD_LAUNCHES}


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke FAILED: {msg}")


def rand(rng, shape, dtype) -> torch.Tensor:
    a = rng.standard_normal(shape).astype(np.float32)
    return torch.from_numpy(a).to(dtype).cuda()


def max_err(got: torch.Tensor, want: torch.Tensor, tol: float,
            what: str, extra: torch.Tensor | None = None) -> float:
    """Largest |got - want|; fails unless every element is within
    ``tolerance_ratio``'s bound (plus ``extra``). Prints the worst
    element's share of it."""
    require(bool(torch.isfinite(got.float()).all()), f"{what}: non-finite output")
    ratio = tolerance_ratio(got, want, tol, extra)
    bad = int((~(ratio <= 1.0)).sum())
    worst = ratio.max().item()
    require(bad == 0, f"{what}: {bad} elements beyond the bound (worst "
                      f"{worst:.3g}x it)")
    err = (got.float() - want.float()).abs().max().item()
    print(f"[check] {what}: max|err| {err:.3g}, worst element at "
          f"{worst:.3f} of its bound")
    return err


def time_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back launches."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_name(name: str) -> str:
    """A profiled kernel's name without its namespace and arguments."""
    return name.replace("(anonymous namespace)::", "").split("(")[0]


def launch_times(fn, reps: int = 5,
                 tries: int = 3) -> dict[str, tuple[float, float]]:
    """Each kernel ``fn`` launches, by name: its mean device ms a launch
    and its launches a call of ``fn``, from ``torch.profiler`` over
    ``reps`` calls (a launch the profiler drops lowers the second, not the
    first). The profiler on the card now and then records no device time
    at all: it is asked again, up to ``tries`` times, and an empty result
    is returned as it is."""
    fn()
    for _ in range(tries):
        _, kernels = profiled(lambda: [fn() for _ in range(reps)])
        if kernels:
            break
    return {name: (ms / n, n / reps) for name, (ms, n) in kernels.items()}


def bound(flops: float, nbytes: float, peak: float) -> tuple[float, str]:
    """Least time in ms the card could take at ``peak`` FLOP/s, and what
    bounds it."""
    t_ops = flops / peak
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


# -- 1. device ----------------------------------------------------------------
def phase_device() -> dict:
    require(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"[device] {kind} x{count}; python {sys.version.split()[0]}, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return {"kind": kind, "count": count, "smi": smi}


# -- [hpc]: DOLMA's runtime and the eight HPC workloads ---------------------
def phase_hpc(dev: dict) -> None:
    """``benchmarks/run.py --bench-json``'s loop through the port must give
    ``BENCH_pr3.json``'s four simulated values for every workload (and
    every tiered checksum the oracle's: the loop asserts it), and the Fig 7
    sweep the reference's average saving. Host work, numpy; the numbers
    are simulated microseconds of the InfiniBand-100G fabric model."""
    sys.path.insert(0, str(ROOT / "tests"))
    import _torch_hpc_parity as H

    pkg = H.package("repro_torch")
    t0 = time.perf_counter()
    rows = H.bench_pr3(pkg)
    want = H.committed("BENCH_pr3")["workloads"]
    require(set(rows) == set(want),
            f"[hpc] workloads {sorted(rows)} != {sorted(want)}")
    for name, row in rows.items():
        print(f"[hpc] {name}: simulated oracle {row['oracle_elapsed_us']!r} "
              f"us, legacy {row['legacy_elapsed_us']!r} us, pipeline "
              f"{row['pipeline_elapsed_us']!r} us, speedup "
              f"{row['pipeline_speedup']!r}; checksum {row['checksum']!r} "
              f"(the oracle's on every leg)")
        for key in H.BENCH_KEYS:
            require(row[key] == want[name][key],
                    f"[hpc] {name} {key} {row[key]!r} != BENCH_pr3.json's "
                    f"{want[name][key]!r}")
    bench_s = time.perf_counter() - t0
    fig = H.fig7(pkg)
    avg = fig["avg_saving_at_16pct_slowdown"]
    require(avg == H.FIG7_AVG_SAVING,
            f"[hpc] Fig 7 average saving {avg!r} != {H.FIG7_AVG_SAVING!r}")
    print(f"[hpc] Fig 7: average memory saving at <= 16 % slowdown {avg!r} "
          f"(the reference's); per workload " + ", ".join(
              f"{s['workload']} {s['best_saving_at_16pct']:.4f}"
              for s in fig["summary"]))
    print(f"[hpc] BENCH_pr3.json reproduced exactly for {len(rows)} "
          f"workloads; wall {bench_s:.1f} s for the bench loop, "
          f"{time.perf_counter() - t0:.1f} s with Fig 7 (host, numpy "
          f"{np.__version__}); {dev['smi']}")


# -- 2. build -------------------------------------------------------------------
def ptxas_spills(log: str) -> dict[str, tuple[int, int]]:
    """Spill store and load bytes of each kernel in an ``nvcc -Xptxas -v``
    log (each "Compiling entry function" line is followed by its
    kernel's "spill stores ... spill loads" line)."""
    spills, name = {}, None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '([^']+)'", line)
        if entry:
            name = entry.group(1)
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
        if spill and name:
            spills[name] = (int(spill.group(1)), int(spill.group(2)))
            name = None
    return spills


def check_bwd_build() -> None:
    """The backward kernels (:data:`BWD_KERNELS`: B2's wgmma kernels, B3's
    backward) spill nothing and ptxas serialises none of their library's
    wgmma. A library an earlier run left built is rebuilt here, so that its
    ptxas report is read."""
    for name, (part, count) in BWD_KERNELS.items():
        if name not in _build.BUILD_LOG:
            _build._target(name).unlink()
            _build.build_all((name,))
        log = _build.BUILD_LOG[name][1]
        spills = ptxas_spills(log)
        bwd = {n: sp for n, sp in spills.items() if re.search(part, n)}
        require(len(bwd) >= count and all(sp == (0, 0) for sp in bwd.values()),
                f"{name}: the backward kernels spill, or fewer than {count} "
                f"reported: {bwd}")
        require(WGMMA_SERIALISED not in log,
                f"{name}: ptxas serialised a kernel's wgmma")
        other = {n: sp for n, sp in spills.items() if n not in bwd}
        print(f"[build] {name}: {len(bwd)} backward kernels, 0 spill bytes, "
              f"no wgmma serialised; the other kernels' spill stores and "
              f"loads (bytes): {sorted(other.values())}")


def phase_build() -> None:
    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"[build] {len(built)} kernels built in "
          f"{time.perf_counter() - t0:.1f} s wall "
          f"({', '.join(f'{n} {s:.1f} s' for n, s in built.items())})")
    for name, (_, log) in sorted(_build.BUILD_LOG.items()):
        for line in log.splitlines():
            if re.search(r"registers|spill|bytes stack|wgmma|setmaxnreg|"
                         r"warning", line):
                print(f"[build] {name}: {line.strip()}")
    cuobjdump = Path(_build.nvcc_path()).parent / "cuobjdump"
    for name in sorted(p.stem for p in _build.CSRC.glob("*.cu")):
        sass = subprocess.run(
            [str(cuobjdump), "-sass", str(_build._target(name))],
            capture_output=True, text=True, timeout=120, check=True).stdout
        n = {op: len(re.findall(rf"\b{op}\b", sass)) for op in SASS_OPS}
        print(f"[build] {name}: SASS " + ", ".join(
            f"{op} {k}" for op, k in n.items()))
        ops_needed = NEEDS_TENSOR_CORES.get(name, ())
        require(not ops_needed or sum(n[op] for op in ops_needed) > 0,
                f"{name}: no {' or '.join(ops_needed)} in its SASS")
    check_bwd_build()


# -- 3. kernels against their plain versions --------------------------------
def phase_kernel_checks(mm_data, fa_data) -> dict:
    rng = np.random.default_rng(1)
    for dtype in (torch.float32, torch.bfloat16):
        bf16 = dtype == torch.bfloat16
        tol = MATMUL_TOL[dtype]
        for M, K, N in MATMUL_CASES + (MATMUL_FFMA_BF16 if bf16 else []):
            x, w = rand(rng, (M, K), dtype), rand(rng, (K, N), dtype)
            got = sm.streaming_matmul(x, w, block_m=128, block_n=128,
                                      block_k=128)
            max_err(got, matmul_ref(x, w), tol, f"matmul {M}x{K}x{N} {dtype} "
                    f"{sm._variant(dtype, K, N)}")
        tol = FLASH_TOL[dtype]
        for B, H, KV, Sq, Sk, D, Dv, causal, window in FLASH_CASES + (
                FLASH_FFMA_BF16 if bf16 else []):
            q = rand(rng, (B, H, Sq, D), dtype)
            k = rand(rng, (B, KV, Sk, D), dtype)
            v = rand(rng, (B, KV, Sk, Dv), dtype)
            got = fa.flash_attention_gpu(q, k, v, causal=causal,
                                         window=window, block_q=64,
                                         block_k=64)
            want = flash_ref(q, k, v, causal=causal, window=window)
            case = (f"flash B{B} H{H} KV{KV} Sq{Sq} Sk{Sk} D{D} Dv{Dv} "
                    f"causal={causal} window={window} {dtype} "
                    f"{fa._variant(dtype, D, Dv)}")
            max_err(got, want, tol, case)
    # the main path's full-width shapes, on the chains' own data
    x, w = mm_data
    err_mm = max_err(sm.streaming_matmul(x, w, block_m=128, block_n=128,
                                         block_k=128),
                     matmul_ref(x, w), MATMUL_TOL[x.dtype],
                     f"matmul full width {tuple(x.shape)}@{tuple(w.shape)} "
                     f"{x.dtype} {sm._variant(x.dtype, *w.shape)}")
    # the backward (the reference's custom VJP) at full width: dx = g w^T
    # and dw = x^T g through the same kernel, against the plain version
    xg, wg = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    g = rand(rng, (x.shape[0], w.shape[1]), x.dtype)
    sm.streaming_matmul(xg, wg).backward(g)
    max_err(xg.grad, matmul_ref(g, w.t()), MATMUL_TOL[x.dtype],
            f"matmul backward dx = g @ w^T full width {x.dtype}")
    max_err(wg.grad, matmul_ref(x.t(), g), MATMUL_TOL[x.dtype],
            f"matmul backward dw = x^T @ g full width {x.dtype}")
    del xg, wg, g
    # ROADMAP C5: a bf16 product with K = 100. Its backward's dx = g @ w^T
    # has N = 100, which the kernels compute padded to 104 zero columns
    M, K, N = MATMUL_C5
    x5 = rand(rng, (M, K), torch.bfloat16).requires_grad_(True)
    w5 = rand(rng, (K, N), torch.bfloat16).requires_grad_(True)
    g5 = rand(rng, (M, N), torch.bfloat16)
    sm.streaming_matmul(x5, w5).backward(g5)
    Np = sm.padded_columns(K, torch.bfloat16)
    max_err(x5.grad, matmul_ref(g5, w5.detach().t()), MATMUL_TOL[x5.dtype],
            f"matmul backward dx = g @ w^T, x {M}x{K} w {K}x{N} bf16 (C5: "
            f"N {K} padded to {Np}) {sm._variant(x5.dtype, N, Np)}")
    max_err(w5.grad, matmul_ref(x5.detach().t(), g5), MATMUL_TOL[x5.dtype],
            f"matmul backward dw = x^T @ g, x {M}x{K} w {K}x{N} bf16 "
            f"{sm._variant(x5.dtype, M, N)}")
    del x5, w5, g5
    q, k, v = fa_data
    err_fa = max_err(fa.flash_attention_gpu(q, k, v, causal=True,
                                            block_q=128, block_k=128),
                     flash_ref(q, k, v, causal=True), FLASH_TOL[q.dtype],
                     f"flash full width q{tuple(q.shape)} k{tuple(k.shape)} "
                     f"causal {q.dtype} "
                     f"{fa._variant(q.dtype, q.shape[3], v.shape[3])}")
    torch.cuda.synchronize()
    return {"streaming_matmul": err_mm, "flash_attention": err_fa}


def attention_skipping(q, k, v, tile: slice) -> torch.Tensor:
    """flash_ref's causal attention with the keys in ``tile`` masked out:
    what a kernel that skipped that live KV tile would output."""
    G = q.shape[1] // k.shape[1]
    k, v = (t.repeat_interleave(G, dim=1) for t in (k, v))
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    s = s.to(q.dtype).float() * (1.0 / math.sqrt(q.shape[-1]))
    i = torch.arange(q.shape[2], device=q.device)
    live = i[None, :] <= i[:, None]
    live[:, tile] = False
    p = torch.softmax(s.masked_fill(~live, NEG_INF), dim=-1)
    return torch.einsum("bhqk,bhkv->bhqv", p.to(v.dtype).float(),
                        v.float()).to(v.dtype)


def phase_planted_faults(mm_data, fa_data) -> None:
    """The full-width bound fails a kernel that skips one 128-wide tile:
    the plain version with one K-tile of w (matmul), or one KV tile for the
    rows after it (flash), left out."""
    tile = slice(2048, 2048 + 128)
    x, w = mm_data
    w_skip = w.clone()
    w_skip[tile] = 0
    faults = {
        "matmul skipping K-tile 2048:2176": outside_tolerance(
            matmul_ref(x, w_skip), matmul_ref(x, w), MATMUL_TOL[x.dtype]),
    }
    q, k, v = fa_data
    faults["flash skipping KV tile 2048:2176"] = outside_tolerance(
        attention_skipping(q, k, v, tile), flash_ref(q, k, v, causal=True),
        FLASH_TOL[q.dtype])
    for what, bad in faults.items():
        n = int(bad.sum())
        require(n > 0, f"the bound passes a planted fault: {what}")
        print(f"[fault] {what}: {n} of {bad.numel()} elements beyond the "
              f"bound, rejected")


# -- 4. the main path -------------------------------------------------------
def drive_chain(label: str, stages, x0, kernel_mod) -> dict:
    """The executor's main path over one chain; returns its numbers."""
    n = len(stages)
    zero_counts()
    passes = 0
    oracle = untiered_oracle(stages, x0)
    passes += 1
    probe = StreamingExecutor(stages, throttle=0.0)
    probe.plan_tiers(0.0)
    probe.warmup(x0)
    probe_res = probe.run(x0)
    probe.engine.close()
    passes += 2
    require(torch.equal(probe_res.output, oracle), f"{label}: probe != oracle")
    throttle = balanced_throttle(stages, probe_res.stage_compute_us)
    # which sets the pace: a stage's compute or the real copy of its bytes
    # (the probe is unpaced, so its transfers are the copies alone)
    comp = list(probe_res.stage_compute_us.values())
    copy = [us for kind, _, us in probe.engine.measurements if kind == "read"]
    comp_ms, copy_ms = sum(comp) / len(comp) / 1e3, sum(copy) / len(copy) / 1e3
    print(f"[path] {label} pace (unpaced probe): mean stage compute "
          f"{comp_ms:.4f} ms, mean real copy of one stage's "
          f"{stages[0].nbytes / 2**20:.0f} MiB {copy_ms:.4f} ms over "
          f"{len(copy)} copies; copy / compute {copy_ms / comp_ms:.3f}")

    ex = StreamingExecutor(stages, prefetch=True, throttle=throttle)
    plan = ex.plan_tiers(0.0)
    ex.warmup(x0)
    on = [ex.run(x0) for _ in range(BEST_OF)]
    ex.prefetch = False
    off = [ex.run(x0) for _ in range(BEST_OF)]
    passes += 1 + 2 * BEST_OF
    launches = counts()
    variants = dict(kernel_mod.VARIANT_LAUNCHES)
    for res in on + off:
        require(torch.equal(res.output, oracle),
                f"{label}: prefetch={res.prefetch} output != untiered oracle")
    out = oracle.float()
    require(bool(torch.isfinite(out).all()), f"{label}: non-finite output")
    mine = kernel_mod.__name__.rsplit(".", 1)[-1]
    for name, count in launches.items():
        want = passes * n if name == mine else 0
        require(count == want,
                f"{label}: {name} launched {count} times, expected {want}")
    # the chains are bf16: every launch must have taken the tensor cores
    require(variants == {"wgmma": passes * n, "ffma": 0},
            f"{label}: variants {variants}, expected every one of "
            f"{passes * n} launches through wgmma")
    best_on = min(on, key=lambda r: r.elapsed_us)
    best_off = min(off, key=lambda r: r.elapsed_us)

    # sizes around the stages' own (16 and 32 MiB), so the fit prices the
    # operating point; the runs' paced fetches are samples too
    ex.engine.measure_sweep([1 << 20, 4 << 20, 16 << 20, 64 << 20],
                            repeats=3)
    by_size: dict[tuple[str, int], list[float]] = {}
    for kind, nbytes, us in ex.engine.measurements:
        by_size.setdefault((kind, nbytes), []).append(us)
    print(f"[calib] {label} throttle {throttle:.4g}: " + "; ".join(
        f"{kind} {nbytes >> 10} KiB n={len(v)} min {min(v):.0f} "
        f"median {sorted(v)[len(v) // 2]:.0f} max {max(v):.0f} us"
        for (kind, nbytes), v in sorted(by_size.items())))
    model = FabricResource(SimClock(), ex.engine.prediction_model()).calibrate(
        ex.engine.measurements)
    sim_err = {}
    for leg, res in (("on", best_on), ("off", best_off)):
        rep = ex.simulate(compute_us=res.stage_compute_us, fabric=model,
                          prefetch=res.prefetch)
        sim_err[leg] = rep.error_vs(res.elapsed_us)
        print(f"[path] {label} prefetch {leg:>3}: elapsed "
              f"{res.elapsed_us / 1e3:.3f} ms, stall {res.stall_us / 1e3:.3f} "
              f"ms, compute {res.compute_us / 1e3:.3f} ms; simulator "
              f"{rep.predicted_us / 1e3:.3f} ms, error {sim_err[leg]:.2%}")
    ex.engine.close()
    speedup = best_off.elapsed_us / best_on.elapsed_us
    print(f"[path] {label}: {n} stages, {len(plan.remote_names())} remote "
          f"({plan.remote_bytes / 2**20:.0f} MiB streamed per pass), "
          f"throttle {throttle:.4g}, overlap speedup {speedup:.3f}x, "
          f"launches {launches}, {mine} by variant {variants}, outputs "
          f"torch.equal to the untiered oracle")
    return {"launches": launches[mine], "speedup": speedup,
            "on_ms": best_on.elapsed_us / 1e3,
            "off_ms": best_off.elapsed_us / 1e3, "sim_err": sim_err}


# -- the SSD scan: inputs, checks, planted fault -----------------------------
def ssd_chunks(rng, *, B, H, L, P, N, chunk, G):
    """The reference test's distributions (x ~ N(0,1), B and C ~ N(0,1)/2,
    dt = softplus(N(0,1)), A = -exp(N(0,1)/2)), drawn with numpy and
    chunked on the card as ``ops.ssd`` chunks them: the kernel's five
    float32 inputs."""
    def draw(shape, scale=1.0):
        a = rng.standard_normal(shape).astype(np.float32) * scale
        return torch.from_numpy(a).cuda()

    xh, Bm, Cm = draw((B, L, H, P)), draw((B, L, G, N), 0.5), draw(
        (B, L, G, N), 0.5)
    dt = torch.nn.functional.softplus(draw((B, L, H)))
    A = -torch.exp(draw((H,), 0.5))
    Q = min(chunk, L)

    def chunked(t):
        t = t.reshape(B, L // Q, Q, *t.shape[2:]).movedim(3, 1)
        return t.float().contiguous()

    rep = H // G
    return (chunked(xh), chunked(Bm.repeat_interleave(rep, dim=2)),
            chunked(Cm.repeat_interleave(rep, dim=2)), chunked(dt),
            torch.cumsum(chunked(dt * A), dim=-1))


def phase_ssd_checks(full) -> float:
    """B3 against its plain versions: the reference's cases, then at the
    path's full shape each of the three kernels against its plain stage on
    the same inputs and the scan against the one-loop oracle, all held to
    the reference's tolerance ``2e-4 + 2e-4 * |want|``. Reason for keeping
    it at full width: the kernels sum in float32 on the tensor cores in
    split TF32 (3xTF32, each product to about 2^-22 of its size), at most
    256 + 128 products per output of size O(10), in one fixed order, so
    they differ from the plain versions by a few float32 units (~1e-5 at
    most), an order of magnitude inside it; a dropped carry moves the first
    rows of the next chunk by O(1), and one TF32 pass (2^-11 a product)
    leaves the bound (``phase_ssd_fault``)."""
    rng = np.random.default_rng(2)
    for L, chunk, G in SSD_CASES:
        args = ssd_chunks(rng, B=2, H=4, L=L, P=32, N=32, chunk=chunk, G=G)
        max_err(ssd.ssd_chunk_scan_gpu(*args),
                ssd.ssd_chunk_scan_plain(*args), SSD_TOL,
                f"ssd_scan B2 H4 L{L} chunk{chunk} G{G} P32 N32 float32")
    args = ssd_chunks(rng, **SSD_RAGGED)
    max_err(ssd.ssd_chunk_scan_gpu(*args), ssd.ssd_chunk_scan_plain(*args),
            SSD_TOL, "ssd_scan ragged " + " ".join(
                f"{k}{v}" for k, v in SSD_RAGGED.items()) + " float32")
    return check_ssd_full(full, SSD_FULL)


def check_ssd_full(full, dims: dict) -> float:
    """Each of B3's three kernels against its plain stage on the same
    inputs, then the scan against the one-loop oracle, at a path's full
    shape ``dims``; the scan's max|err|."""
    shape = " ".join(f"{k}{v}" for k, v in dims.items()) + " float32"
    xc, bc, cc, dtc, cum = full
    states = ssd.ssd_chunk_state_gpu(xc, bc, dtc, cum)
    max_err(states, ssd.ssd_chunk_state_plain(xc, bc, dtc, cum), SSD_TOL,
            f"ssd kernel 1 chunk_state full width {shape}")
    entering, final = ssd.ssd_state_passing_gpu(states, cum)
    want_in, want_final = ssd.ssd_state_passing_plain(states, cum)
    max_err(entering, want_in, SSD_TOL,
            f"ssd kernel 2 state_passing (entering states) full width {shape}")
    max_err(final, want_final, SSD_TOL,
            f"ssd kernel 2 state_passing (final state) full width {shape}")
    max_err(ssd.ssd_chunk_output_gpu(xc, bc, cc, dtc, cum, entering),
            ssd.ssd_chunk_output_plain(xc, bc, cc, dtc, cum, entering),
            SSD_TOL, f"ssd kernel 3 chunk_output full width {shape}")
    del states, entering, final, want_in, want_final
    err = max_err(ssd.ssd_chunk_scan_gpu(*full),
                  ssd.ssd_chunk_scan_plain(*full), SSD_TOL,
                  f"ssd_scan (three kernels) against the one-loop oracle, "
                  f"full width {shape}")
    torch.cuda.synchronize()
    return err


def ssd_dropping_carry(xc, bc, cc, dtc, cum, drop: int) -> torch.Tensor:
    """The plain chunk loop with chunk ``drop``'s carry update left out:
    what a kernel that lost one chunk's state write would output."""
    B, H, nc, Q, P = xc.shape
    state = torch.zeros((B, H, P, bc.shape[-1]), device=xc.device)
    causal = torch.ones((Q, Q), dtype=torch.bool, device=xc.device).tril()
    ys = []
    for c in range(nc):
        x, bm, cm, dt, cu = (t[:, :, c] for t in (xc, bc, cc, dtc, cum))
        lmat = torch.where(causal, torch.exp(cu[..., :, None] - cu[..., None, :])
                           * dt[..., None, :], 0.0)
        y = torch.einsum("bhij,bhjp->bhip",
                         torch.einsum("bhin,bhjn->bhij", cm, bm) * lmat, x)
        y = y + torch.einsum("bhin,bhpn->bhip", cm, state) * torch.exp(
            cu)[..., None]
        ys.append(y)
        if c != drop:
            total = cu[..., -1:]
            w = (torch.exp(total - cu) * dt)[..., None] * bm
            state = torch.exp(total)[..., None] * state + torch.einsum(
                "bhjp,bhjn->bhpn", x, w)
    return torch.stack(ys, dim=2)


def phase_ssd_fault(full) -> None:
    """Two planted faults the SSD bound must reject at full width: a lost
    carry update, and the oracle's products in single-pass TF32 (what the
    kernels would give without the split)."""
    want = ssd.ssd_chunk_scan_plain(*full)
    drop = full[0].shape[2] // 2  # a chunk with chunks after it
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        one_pass = ssd.ssd_chunk_scan_plain(*full)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    faults = {
        f"ssd_scan dropping chunk {drop}'s carry update":
            ssd_dropping_carry(*full, drop=drop),
        "ssd_scan one-loop oracle in single-pass TF32": one_pass,
    }
    for what, got in faults.items():
        ratio = tolerance_ratio(got, want, SSD_TOL)
        n = int((~(ratio <= 1.0)).sum())
        require(n > 0, f"the bound passes a planted fault: {what}")
        print(f"[fault] {what}: {n} of {ratio.numel()} elements beyond the "
              f"bound (worst {ratio.max().item():.3g}x it), rejected")


# -- 5. the model paths: mamba2-130m, granite-8b, zamba2-1.2b -----------------
def timed_ms(fn):
    """(result, ms, host ms) of one call that ends with the card idle; the
    host ms is how long ``fn`` took to return, before the synchronise (when
    it is far below ms, the host ran ahead of the card)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3, (t1 - t0) * 1e3


def greedy(params, cfg, prompts, n_new: int, plan=None,
           max_len: int | None = None):
    """The serving loop written by hand: prefill token by token through
    ``decode_step``, then ``n_new`` greedy tokens, in a cache of ``max_len``
    slots (the prompt and the new tokens by default). Returns the new
    tokens and, for each decode step, its ms and its host ms
    (``timed_ms``)."""
    cache = tf.init_decode_cache(cfg, prompts.shape[0],
                                 max_len or prompts.shape[1] + n_new)
    steps, out = [], []
    logits = None
    for t in range(prompts.shape[1]):
        (logits, cache), *ms = timed_ms(lambda: tf.decode_step(
            params, cache, prompts[:, t:t + 1], cfg, plan=plan))
        steps.append(ms)
    for _ in range(n_new):
        cur = logits[:, :, :cfg.vocab_size].argmax(-1).to(torch.int32)
        out.append(cur)
        (logits, cache), *ms = timed_ms(lambda: tf.decode_step(
            params, cache, cur, cfg, plan=plan))
        steps.append(ms)
    return torch.cat(out, dim=1), steps


def forward_with(params, batch, cfg, *, scan=None, flash=None):
    """``forward``'s logits with ``ops.ssd``'s chunk scan replaced by
    ``scan`` and the models' flash route to B2 by ``flash``."""
    kernels = ops.ssd_chunk_scan_gpu, mflash._b2
    ops.ssd_chunk_scan_gpu = scan or kernels[0]
    mflash._b2 = flash or kernels[1]
    try:
        return get_model(cfg).forward(params, batch, cfg)[0]
    finally:
        ops.ssd_chunk_scan_gpu, mflash._b2 = kernels


def logits_diff(got, want, V: int) -> tuple[float, float, float, float]:
    """max|got - want|, max|want|, mean|got - want| over the real vocabulary,
    and the share of positions whose greedy tokens agree."""
    got, want = got[..., :V].float(), want[..., :V].float()
    diff = (got - want).abs()
    agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    return (diff.max().item(), want.abs().max().item(), diff.mean().item(),
            agree)


def widened(params):
    """The parameter tree with every tensor in float32."""
    return map_leaves(lambda _k, t: t.float(), params)


def cut_depth(params, depth: int):
    """The parameter tree with only the first ``depth`` stacked layers."""
    return {**params, "layers": map_leaves(lambda _k, t: t[:depth],
                                           params["layers"])}


def n_bytes(params) -> int:
    return sum(t.numel() * t.element_size()
               for _, t in _leaves_with_keys(params))


# elements a fingerprint reads at once: its int64 temporaries are 128 MiB
FINGERPRINT_CHUNK = 1 << 24
# the integer type of a raw word of each element size
WORDS = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def fingerprint(t: torch.Tensor, device: str = "cuda") -> tuple:
    """``t``'s shape, type and two integer reductions over its raw bits, on
    ``device`` (a host tensor copied there a chunk at a time): each element
    read as a signed word of its size, ``sum(w_i x_i)`` with the odd weight
    ``w_i = 2j + 1`` of its place j in its chunk, the chunks' sums weighted
    likewise by their place, and ``sum(x_i^2)``, both modulo 2^64. One
    flipped bit changes a word by +-2^k and the first sum by 2^k times an
    odd number, which is never 0 modulo 2^64: any single flipped bit, and
    two elements swapped, change it; unequal tensors of equal fingerprints
    need both sums to collide modulo 2^64 at once."""
    flat = t.detach().reshape(-1)
    word = WORDS[flat.element_size()]
    w1 = torch.zeros((), dtype=torch.int64, device=device)
    w2 = torch.zeros((), dtype=torch.int64, device=device)
    place = torch.arange(1, 2 * FINGERPRINT_CHUNK, 2, dtype=torch.int64,
                         device=device)
    for c, i in enumerate(range(0, flat.numel(), FINGERPRINT_CHUNK)):
        x = flat[i:i + FINGERPRINT_CHUNK].to(device).view(word).long()
        w1 += (x * place[:x.numel()]).sum() * (2 * c + 1)
        w2 += (x * x).sum()
    return (tuple(t.shape), str(t.dtype), w1.item(), w2.item())


def fingerprints(tree, device: str = "cuda") -> dict:
    """:func:`fingerprint` of every leaf of ``tree`` by its key (an int8
    moment's codes and scales apart)."""
    return {k: fingerprint(t, device) for k, t in _leaves_with_keys(tree)}


def equal_to_host(got: torch.Tensor, host: torch.Tensor,
                  chunk_bytes: int = 64 << 20) -> bool:
    """``torch.equal(got, host)`` for a tensor on the card and one in
    pinned host memory, compared on the card a chunk at a time: no copy of
    the whole of ``host`` joins the card's peak, and none of ``got`` goes
    through pageable host memory (a 151552-entry vocabulary's logits over 4
    x 2048 tokens are 5 GB)."""
    if got.shape != host.shape or got.dtype != host.dtype:
        return False
    a, b = got.reshape(-1), host.reshape(-1)
    n = max(1, chunk_bytes // a.element_size())
    return all(torch.equal(a[i:i + n], b[i:i + n].to(a.device,
                                                     non_blocking=True))
               for i in range(0, a.numel(), n))


def drive_placements(tag: str, cfg, params, batch,
                     fractions=(1.0, 0.5, 0.0)) -> tuple:
    """The model's ``forward`` (``get_model(cfg)``) with every weight on
    the card (the oracle), then with the weights placed by
    ``host_offload`` at each of ``fractions`` below 1.0, prefetch on and
    off; every logits tensor ``torch.equal`` to the oracle
    (:func:`equal_to_host`). Returns (the oracle in pinned host memory,
    per-placement rows, forwards run)."""
    model = get_model(cfg)
    oracle = None  # on the host, so that no placement's peak includes it
    rows, n_fwd = {}, 0
    for mode, frac in (("none" if f == 1.0 else "host_offload", f)
                       for f in fractions):
        placed, plan = place_params(params, TieringConfig(
            mode=mode, local_fraction=frac))
        for prefetch in ((True,) if mode == "none" else (True, False)):
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            runs = []
            for _ in range(1 + BEST_OF):  # the first is the warm-up
                (logits, _), ms, host_ms = timed_ms(lambda: model.forward(
                    placed, batch, cfg, prefetch=prefetch, plan=plan))
                n_fwd += 1
                runs.append((ms, host_ms))
                if oracle is None:
                    oracle = torch.empty(logits.shape, dtype=logits.dtype,
                                         pin_memory=True).copy_(logits)
                require(equal_to_host(logits, oracle),
                        f"{tag} {mode} {frac} prefetch={prefetch}: logits != "
                        f"the all-local oracle")
                del logits
            label = (mode if mode == "none" else
                     f"{mode} {frac} prefetch {'on' if prefetch else 'off'}")
            local = plan.local_bytes if plan else n_bytes(params)
            remote = plan.remote_bytes if plan else 0
            best, best_host = min(runs[1:])
            rows[label] = {"ms": best, "host_ms": best_host,
                           "local_bytes": local, "remote_bytes": remote,
                           "peak_gib": torch.cuda.max_memory_allocated()
                           / 2**30}
            print(f"[{tag}] forward {label}: best of {BEST_OF} {best:.3f} ms "
                  f"({best_host:.3f} ms on the host before the synchronise; "
                  f"runs {', '.join(f'{m:.3f}' for m, _ in runs)}), local "
                  f"{local / 2**20:.1f} MiB, remote {remote / 2**20:.1f} MiB,"
                  f" peak {rows[label]['peak_gib']:.3f} GiB, logits "
                  f"torch.equal to the oracle")
        del placed
    require(bool(torch.isfinite(oracle).all()), f"{tag}: non-finite logits")
    return oracle, rows, n_fwd


def step_stats(step_us: list[float]) -> str:
    """Median and min of a wave's per-step latencies (µs) in ms."""
    ms = sorted(u / 1e3 for u in step_us)
    return f"median {ms[len(ms) // 2]:.3f} ms, min {ms[0]:.3f} ms"


def engine_wave(eng, prompts: np.ndarray, n_new: int) -> tuple[np.ndarray, str]:
    """One ``generate`` wave; its tokens and a line of its step latencies
    (the engine's own ``wave_step_us``) and wall ms a step."""
    toks, wall_ms, _ = timed_ms(lambda: eng.generate(prompts, n_new))
    n = len(eng.wave_step_us)
    return toks, (f"{n} steps, engine step {step_stats(eng.wave_step_us)}, "
                  f"wall {wall_ms / n:.3f} ms a step")


def serve(tag: str, cfg, params, prompts) -> int:
    """Greedy decode of 4 prompts: all local through the port's serving
    entry point (``ServingEngine.generate``), then at host_offload 0.5
    through the hand loop (``greedy(plan=)``: the engine, like the
    reference's, does not offload parameters); the tokens must agree.
    Returns the decode steps run."""
    n_new = 16
    eng = ServingEngine(cfg, params, EngineConfig(
        max_batch=prompts.shape[0], max_len=prompts.shape[1] + n_new))
    local, line = engine_wave(eng, prompts.cpu().numpy(), n_new)
    n_steps = len(eng.wave_step_us)
    print(f"[serve] {cfg.name} local (ServingEngine.generate): 4 prompts x "
          f"{prompts.shape[1]} tokens prefilled token by token, {n_new} new "
          f"each; {line}; tokens {local[0, :8].tolist()}...")
    del eng
    placed, plan = place_params(params, TieringConfig(
        mode="host_offload", local_fraction=0.5))
    toks, steps = greedy(placed, cfg, prompts, n_new, plan=plan)
    steady = sorted(steps[1:])
    host = sorted(h for _, h in steps[1:])
    print(f"[serve] {cfg.name} host_offload 0.5 (greedy): decode step median "
          f"{steady[len(steady) // 2][0]:.3f} ms (host "
          f"{host[len(host) // 2]:.3f} ms before the synchronise), min "
          f"{steady[0][0]:.3f} ms over {len(steps)} steps")
    del placed
    require(np.array_equal(local, toks.cpu().numpy()),
            f"{tag}: offloaded greedy tokens != the engine's local tokens")
    return n_steps + len(steps)


def drive_model(tag: str, cfg, per_forward: dict[str, int]) -> dict:
    """The port's model path at ``cfg``'s full width: the weights drawn on
    the card from a seed and kept on the host (each placement then holds on
    the card only what it places there), ``forward`` over 4 x 2048 tokens
    per placement, then serving. The kernels' launches over the whole path
    must be ``per_forward`` times the forwards (decode runs no kernel of
    the reference's), every flash launch through the tensor cores, and each
    SSD kernel once a scan. Returns the path's numbers, the weights (now on
    the card), the batch and the oracle's logits."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    params = tf.init_params(gen, cfg, device="cpu")
    batch = make_batch(cfg, gen, 4, 2048)
    prompts = make_batch(cfg, gen, 4, 64)["tokens"]
    n_params = sum(t.numel() for _, t in _leaves_with_keys(params))
    print(f"[{tag}] {cfg.name}: {cfg.n_layers} of "
          f"{get_config(cfg.name).n_layers} layers, d_model {cfg.d_model}, "
          f"{n_params / 1e9:.4f} B parameters ({cfg.dtype}, "
          f"{n_bytes(params) / 1e9:.2f} GB), batch "
          f"{tuple(batch['tokens'].shape)}, made in "
          f"{time.perf_counter() - t0:.1f} s")

    zero_counts()
    oracle, rows, n_fwd = drive_placements(tag, cfg, params, batch)
    params = place_params(params, TieringConfig())[0]
    n_steps = serve(tag, cfg, params, prompts)
    launches = counts()
    variants = dict(fa.VARIANT_LAUNCHES)
    stages = dict(ssd.STAGE_LAUNCHES)
    print(f"[{tag}] launches over {n_fwd} forwards and {n_steps} decode "
          f"steps: {launches}; flash by variant {variants}; SSD kernels "
          f"{stages}")
    want = {name: per_forward.get(name, 0) * n_fwd for name in launches}
    require(launches == want, f"{tag}: launches {launches}, expected {want} "
                              f"({per_forward} a forward)")
    require(variants["ffma"] == 0, f"{tag}: flash launches {variants}, "
                                   f"expected every one through wgmma")
    require(all(k == launches["ssd_scan"] for k in stages.values()),
            f"{tag}: SSD kernel launches {stages}, expected each "
            f"{launches['ssd_scan']}")
    return {"launches": launches, "forwards": n_fwd, "rows": rows,
            "params": params, "batch": batch, "oracle": oracle.cuda(),
            "prompts": prompts}


def path_check(tag: str, cfg, run: dict, plain: dict, nudged: dict,
               what: str, floor_what: str, depth32: int) -> None:
    """The model's kernel forward against the same forward through the
    kernels' plain versions (``plain``: ``forward_with``'s arguments).

    In bf16 the random-weight model is chaotic: an activation that rounds
    one bf16 unit apart is carried on through every layer by the bf16
    residual stream, so any kernel that is not bit-identical to its plain
    version moves the logits by several percent. The bf16 comparison is
    printed beside its floor -- the plain forward against itself with one
    kernel's output nudged (``nudged``) -- and the check is held in float32
    (the same weights widened, cut to ``depth32`` layers where the whole
    stack would not fit the time, the same tokens), where rounding does not
    grow: within ``PATH_BOUND`` of max(1, max|logits|)."""
    V = cfg.vocab_size
    params, batch = run["params"], run["batch"]
    want = forward_with(params, batch, cfg, **plain)
    floor = forward_with(params, batch, cfg, **nudged)
    for label, got, ref in ((f"kernel forward vs {what} forward",
                             run["oracle"], want),
                            (f"floor: {what} forward vs itself with "
                             f"{floor_what}", floor, want)):
        worst, scale, mean, agree = logits_diff(got, ref, V)
        print(f"[{tag}] bf16 {label}: max|diff| {worst:.4g} "
              f"({worst / max(scale, 1.0):.4g} of max|logits| {scale:.4g}), "
              f"mean|diff| {mean:.4g}, greedy tokens agree at {agree:.2%}")
    del want, floor
    depth32 = min(depth32, cfg.n_layers)
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32, n_layers=depth32)
    p32 = widened(params if depth32 == cfg.n_layers
                  else cut_depth(params, depth32))
    worst, scale, mean, agree = logits_diff(
        get_model(cfg).forward(p32, batch, cfg32)[0],
        forward_with(p32, batch, cfg32, **plain), V)
    require(worst <= PATH_BOUND * max(scale, 1.0),
            f"{tag} f32: {what} forward differs by {worst:.4g} > "
            f"{PATH_BOUND} x max(1, {scale:.4g})")
    print(f"[{tag}] float32 kernel forward vs {what} forward, {depth32} of "
          f"{cfg.n_layers} layers: max|diff| {worst:.4g} "
          f"({worst / max(scale, 1.0):.4g} of max|logits| {scale:.4g}; bound "
          f"{PATH_BOUND}), mean|diff| {mean:.4g}, greedy tokens agree at "
          f"{agree:.2%}")


def nudged_kernels(seed: int = 5) -> dict:
    """Plain versions with their output perturbed, for the bf16 floors:
    the SSD scan's float32 y moved by relative noise of 2^-24 (float32's
    own rounding) before the model rounds it to bf16; the flash's bf16
    output moved by 2^-9 (a quarter to a half of a bf16 unit) and rounded
    again, so that some of its elements move by one unit."""
    noise = torch.Generator(device="cuda").manual_seed(seed)

    def scan(*chunks):
        y = ssd.ssd_chunk_scan_plain(*chunks)
        return y + y * (2.0 ** -24 * torch.randn(
            y.shape, generator=noise, device=y.device))

    def flash(q, k, v, **kw):
        o = mflash.blocked_flash(q, k, v, **kw)
        return (o.float() * (1.0 + 2.0 ** -9 * torch.randn(
            o.shape, generator=noise, device=o.device))).to(o.dtype)

    return {"scan": scan, "flash": flash}


def decode_vs_forward(tag: str, cfg, depth: int, n_tok: int = 512, *,
                      params=None, lanes: int = 2,
                      moe_groups: int | None = None) -> None:
    """The reference's decode-matches-forward contract at full width in
    float32, ``depth`` layers (a moe model keeps at least one MoE layer):
    token-by-token decode over ``lanes`` x ``n_tok`` tokens against the
    forward (the enc-dec family's after ``prefill`` of the batch's frames),
    max|diff| < 1e-3 x max(1, max|logits|). ``params`` are float32 weights
    at that depth (drawn here when None); ``moe_groups`` the decode's MoE
    dispatch groups."""
    model = get_model(cfg)
    depth = min(depth, cfg.n_layers)
    cfg32 = dataclasses.replace(
        cfg, dtype=torch.float32, n_layers=depth,
        first_k_dense=min(cfg.first_k_dense, depth - 1))
    gen = torch.Generator(device="cuda").manual_seed(0)
    p32 = params if params is not None else model.init_params(gen, cfg32)
    b = make_batch(cfg32, gen, lanes, n_tok)
    tok, frames = b["tokens"], b.get("frames")
    src = {} if frames is None else {"frames": frames}
    full, _ = model.forward(p32, {"tokens": tok, **src}, cfg32)
    cache = model.init_decode_cache(cfg32, lanes, n_tok)
    if frames is not None:
        cache = model.prefill(p32, cache, frames, cfg32)
    errs = torch.zeros((), device="cuda")
    for t in range(n_tok):
        lg, cache = model.decode_step(p32, cache, tok[:, t:t + 1], cfg32,
                                      moe_groups=moe_groups)
        errs = torch.maximum(errs, (lg[:, 0] - full[:, t]).abs().max())
    scale = full[..., :cfg.vocab_size].abs().max().item()
    err = errs.item()
    require(err < PATH_BOUND * max(scale, 1.0),
            f"{tag} f32: decode drifts from forward by {err:.4g} (scale "
            f"{scale:.4g})")
    print(f"[{tag}] float32 decode vs forward, {depth} of {cfg.n_layers} "
          f"layers, over {lanes} x {n_tok} tokens: max|diff| {err:.4g} < "
          f"1e-3 x max(1, {scale:.4g})")


def decode_past_the_cache(tag: str, cfg, params, S: int = 16) -> None:
    """ROADMAP C6 on the card, at full width: fill a 4-lane cache of ``S``
    slots, then one scalar step at pos ``S`` (it must rewrite only slot
    ``S - 1``) and one per-lane step with lane 0 at ``S + 5`` (its rows
    must stay ``torch.equal`` to what they were, the other lanes write
    their slots). Each step is synchronised at once, so a device-side
    assert fails here."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    tok = make_batch(cfg, gen, 4, S + 2)["tokens"]
    cache = tf.init_decode_cache(cfg, 4, S)
    for t in range(S):
        _, cache = tf.decode_step(params, cache, tok[:, t:t + 1], cfg)
    torch.cuda.synchronize()
    before = {k: cache[k].clone() for k in ("k", "v")}
    logits, cache = tf.decode_step(params, cache, tok[:, S:S + 1], cfg)
    torch.cuda.synchronize()
    require(bool(torch.isfinite(logits).all()), f"{tag}: non-finite logits")
    for k in ("k", "v"):
        require(torch.equal(cache[k][:, :, :S - 1], before[k][:, :, :S - 1]),
                f"{tag}: a scalar step at pos {S} wrote below slot {S - 1}")
        require(not torch.equal(cache[k][:, :, S - 1], before[k][:, :, S - 1]),
                f"{tag}: a scalar step at pos {S} left slot {S - 1} as it was")
    lanes = [S + 5, 3, 7, S - 1]
    cache["pos"] = torch.tensor(lanes, dtype=torch.int32, device="cuda")
    before = {k: cache[k].clone() for k in ("k", "v")}
    logits, cache = tf.decode_step(params, cache, tok[:, S + 1:S + 2], cfg)
    torch.cuda.synchronize()
    require(bool(torch.isfinite(logits).all()), f"{tag}: non-finite logits")
    for k in ("k", "v"):
        require(torch.equal(cache[k][:, 0], before[k][:, 0]),
                f"{tag}: lane 0 at pos {S + 5} changed its cache rows")
        for b, pos in enumerate(lanes[1:], start=1):
            require(not torch.equal(cache[k][:, b, pos], before[k][:, b, pos]),
                    f"{tag}: lane {b} did not write slot {pos}")
    print(f"[{tag}] {cfg.name} decode past a {S}-slot cache on the card: a "
          f"scalar step at pos {S} wrote only slot {S - 1}; a per-lane step "
          f"at {lanes} left lane 0's rows torch.equal and wrote the others; "
          f"no device assert")


def as_bytes(t: torch.Tensor) -> np.ndarray:
    """A bf16 tensor's bytes on the host, as uint16."""
    return t.contiguous().view(torch.int16).cpu().numpy().view(np.uint16)


def device_per_step(label: str, fn, n_steps: int, step_ms: float) -> dict:
    """``fn`` (``n_steps`` decode steps) under ``torch.profiler``: the
    device time summed over kernels and the kernels, per step, beside the
    step's time measured without the profiler (``step_ms``, which the
    profiler would inflate); the host's share is 1 - device / step."""
    wall, kernels = profiled(fn)
    dev_ms = sum(ms for ms, _ in kernels.values()) / n_steps
    launches = sum(n for _, n in kernels.values()) / n_steps
    require(dev_ms > 0, f"[engine] {label}: the profiler recorded no device "
                        f"time")
    print(f"[engine] {label} under the profiler: device {dev_ms:.3f} ms a "
          f"step (sum of kernels), {launches:.1f} kernels a step, profiled "
          f"wall {wall / n_steps:.3f} ms a step; against the unprofiled "
          f"step of {step_ms:.3f} ms the host's share is "
          f"{max(0.0, 1 - dev_ms / step_ms):.2%}")
    return {"device_ms": dev_ms, "kernels": launches}


def phase_engine(cfg, params, prompts, smi: str) -> dict:
    """granite-8b at full width through the port's serving layer: two
    ``generate`` waves with a ``reset`` between, tokens equal to the hand
    loop's; an engine whose budget demotes the caches into a 2-node pool
    with 2 replicas, tokens equal and the pool's bf16 payloads the cache's
    bytes; a ``ContinuousScheduler`` in lane mode over that engine (two
    tenants, requests joining mid-stream), each request's tokens equal to
    it run alone through a fresh lane-mode engine; the steps timed and
    profiled; then ``launch.serve --full``. Returns each kernel's
    launches over the phase (decode runs none of them)."""
    zero_counts()
    P = prompts.shape[1]
    host_prompts = prompts.cpu().numpy()

    def hand_loop(turn: int) -> np.ndarray:
        toks, steps = greedy(params, cfg, prompts, ENGINE_NEW,
                             max_len=ENGINE["max_len"])
        ms = sorted(m for m, _ in steps)
        print(f"[engine] hand loop (greedy, synchronised each step), turn "
              f"{turn}: {len(ms)} steps, median {ms[len(ms) // 2]:.3f} ms, "
              f"min {ms[0]:.3f} ms")
        return toks.cpu().numpy()

    # in turns on one card: hand loop, engine, engine, hand loop
    want = hand_loop(0)
    eng = ServingEngine(cfg, params, EngineConfig(**ENGINE))
    steps_ms = []
    for wave in range(2):
        if wave:
            eng.reset()
        toks, line = engine_wave(eng, host_prompts, ENGINE_NEW)
        require(np.array_equal(toks, want),
                f"[engine] wave {wave}: tokens != the hand loop's")
        steps_ms += [u / 1e3 for u in eng.wave_step_us]
        print(f"[engine] {cfg.name} generate wave {wave} (max_batch "
              f"{ENGINE['max_batch']}, max_len {ENGINE['max_len']}): 4 "
              f"prompts x {P} + {ENGINE_NEW} new: {line}; tokens equal to "
              f"the hand loop's")
    require(np.array_equal(hand_loop(1), want),
            "[engine] the hand loop's tokens moved between turns")
    step_ms = sorted(steps_ms)[len(steps_ms) // 2]
    eng.reset()
    device_per_step(
        f"{cfg.name} generate", lambda: eng.generate(host_prompts[:, :8], 8),
        PROFILE_STEPS, step_ms)

    tiered = ServingEngine(cfg, params, EngineConfig(**ENGINE, **ENGINE_TIERED))
    demoted = tiered._demoted_cache_names()
    require({"cache['k']", "cache['v']"} <= set(demoted),
            f"[engine] the budget demoted {demoted}, not the K and V caches")
    toks, line = engine_wave(tiered, host_prompts, ENGINE_NEW)
    require(np.array_equal(toks, want), "[engine] tiered tokens != untiered")
    for key in ("k", "v"):
        got = tiered.pool.payload(f"cache['{key}']")
        require(got.dtype == np.uint16
                and np.array_equal(got, as_bytes(tiered.cache[key]))
                and bool(got.any()),
                f"[engine] the pool's cache['{key}'] != the cache's bf16 bytes")
    summary = tiered.placement_summary()
    require(summary["offload_memory_kind"] == "pinned_host",
            f"[engine] offload_memory_kind {summary['offload_memory_kind']}")
    pool = tiered.pool.stats()
    print(f"[engine] tiered (budget {ENGINE_TIERED['hbm_budget_bytes']} B, "
          f"pool 2 nodes x 2 replicas): {line}; tokens equal to the "
          f"untiered engine's; pool payloads of {demoted} equal to the bf16 "
          f"cache's bytes ({pool['bytes_written']} B written); "
          f"placement_summary {summary}")

    lanes = phase_lanes(cfg, params, tiered)
    out = launch_serve.main(["--arch", cfg.name, "--full"])
    print(f"[engine] launch.serve --arch {cfg.name} --full: "
          f"{out['tokens']} tokens in {out['seconds']:.3f} s = "
          f"{out['tokens_per_s']:.1f} tokens/s batched; {smi}")
    launches = counts()
    require(all(n == 0 for n in launches.values()),
            f"[engine] launches {launches}: decode runs no kernel of the "
            f"reference's")
    return {"launches": launches, "step_ms": step_ms, **lanes}


def phase_lanes(cfg, params, eng) -> dict:
    """Continuous batching over ``eng`` (switched to lane mode): two
    tenants' requests join in pairs while earlier ones decode; mid-run one
    tenant's lanes are offloaded to its pool arena (bf16 bytes checked).
    Every request's tokens must equal the same request run alone through a
    fresh lane-mode engine with the same ``max_batch``. No admission pass
    runs (``readvise_every=0``): at this width the simulator replays 16 GB
    of objects a pass; ``[serving-bench]`` holds admission on the card."""
    gen = torch.Generator(device="cuda").manual_seed(13)
    prompts = make_batch(cfg, gen, LANE_REQUESTS, LANE_PROMPT)["tokens"]
    reqs = [Request(tenant=("acme", "blue")[i % 2],
                    prompt=prompts[i].cpu().numpy(), max_new=LANE_NEW)
            for i in range(LANE_REQUESTS)]
    sched = ContinuousScheduler(eng, SchedulerConfig(readvise_every=0))
    ids = []
    for pair in range(LANE_REQUESTS // 2):
        ids += [sched.submit(dataclasses.replace(r))
                for r in reqs[2 * pair:2 * pair + 2]]
        for _ in range(5):
            sched.step()
        if pair == 1:
            held = sorted(sched.tenants["acme"].lanes)
            eng.offload_tenant_kv("acme", held)
            for key in ("k", "v"):
                got = eng.pool.payload(f"kv:acme:cache['{key}']")
                require(np.array_equal(
                    got, as_bytes(eng.cache[key][:, held])),
                    f"[engine] acme's pool cache['{key}'] != its lanes' bytes")
    sched.drain(max_steps=1000)
    got = {r["request_id"]: r["tokens"]
           for rs in sched.results().values() for r in rs}
    require(sorted(got) == sorted(ids), f"[engine] completed {sorted(got)}")

    oracle_eng = ServingEngine(cfg, params, EngineConfig(**ENGINE))
    oracle = ContinuousScheduler(oracle_eng, SchedulerConfig(readvise_every=0))
    for rid, req in zip(ids, reqs):
        one = oracle.submit(dataclasses.replace(req))
        oracle.drain(max_steps=1000)
        alone = oracle.tenants[req.tenant].completed[-1]["tokens"]
        require(np.array_equal(got[rid], alone),
                f"[engine] lane tokens of {rid} != the request alone ({one})")
    lat = sched.latency_stats()
    print(f"[engine] lanes: {LANE_REQUESTS} requests of 2 tenants "
          f"({LANE_PROMPT}-token prompts, {LANE_NEW} new) joining in pairs, "
          f"{sched._step_id} shared steps, acme's lanes {held} offloaded to "
          f"its pool arena (bytes equal); every request's tokens equal to "
          f"it alone through a fresh lane-mode engine; decode_lanes step "
          f"p50 " + ", ".join(f"{t} {s['p50_step_us'] / 1e3:.3f} ms"
                               for t, s in lat.items()))

    feed = np.zeros(ENGINE["max_batch"], np.int32)
    step_us = [oracle_eng.decode_lanes(feed)[1] for _ in range(PROFILE_STEPS)]
    step_ms = sorted(step_us)[len(step_us) // 2] / 1e3
    print(f"[engine] decode_lanes alone: {step_stats(step_us)} over "
          f"{PROFILE_STEPS} steps (its step_us ends with the host copy of "
          f"the tokens)")

    def lane_steps():
        for _ in range(PROFILE_STEPS):
            oracle_eng.decode_lanes(feed)

    prof = device_per_step("decode_lanes", lane_steps, PROFILE_STEPS, step_ms)
    return {"lane_step_ms": step_ms, "lane_device_ms": prof["device_ms"]}


def phase_serving_bench(dev: dict) -> None:
    """``benchmarks/fig_autoscale.py``'s and ``fig_serving_mt.py``'s loops
    through the port, the reduced granite-8b engine in float32 on the card:
    ``BENCH_pr5.json``'s and ``BENCH_pr9.json``'s values exactly (their
    wall-clock ``latency_us`` printed, not compared). The loops require
    autoscaled tokens equal to an untiered engine's and every lane's tokens
    equal to the sequential oracle's."""
    sys.path.insert(0, str(ROOT / "tests"))
    import _torch_serving_parity as S

    cfg = reduced_config(get_config("granite-8b"), dtype=torch.float32)
    params = tf.init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    pkg = S.package("repro_torch")
    t0 = time.perf_counter()
    auto = S.fig_autoscale(pkg, cfg, params)["autoscale"]
    bad = S.bench_mismatches(auto, "BENCH_pr5")
    require(not bad, f"[serving-bench] BENCH_pr5.json differs at {bad}: "
                     f"{auto}")
    print(f"[serving-bench] fig_autoscale on the card: BENCH_pr5.json "
          f"exactly: nodes {auto['nodes_trajectory']}, max_degradation "
          f"{auto['max_degradation']!r}, mean_saving {auto['mean_saving']!r},"
          f" {auto['n_readvise']} re-advises, {auto['migrated_extents']} "
          f"migrated extents; tokens autoscaled == untiered; "
          f"{time.perf_counter() - t0:.1f} s")
    t1 = time.perf_counter()
    mt = S.fig_serving_mt(pkg, cfg, params)["serving_mt"]
    bad = S.bench_mismatches(mt, "BENCH_pr9")
    require(not bad, f"[serving-bench] BENCH_pr9.json differs at {bad}: {mt}")
    print(f"[serving-bench] fig_serving_mt on the card: BENCH_pr9.json "
          f"exactly (latency_us aside): nodes {mt['nodes_trajectory']}, shed "
          f"{mt['shed_events']}, completed {mt['completed']}, "
          f"max_admitted_degradation {mt['max_admitted_degradation']!r}, "
          f"{mt['n_readvise']} admission passes, bit_identical "
          f"{mt['bit_identical']}; latency_us (wall clock, not compared) "
          f"{mt['latency_us']}; {time.perf_counter() - t1:.1f} s; "
          f"{dev['smi']}")


def phase_mamba() -> dict:
    """mamba2-130m, all 24 layers: 24 SSD scans a forward; the path checked
    against the plain SSD, and decode against forward at full depth."""
    cfg = MAMBA2_130M
    run = drive_model("mamba", cfg, {"ssd_scan": cfg.n_layers})
    nudged = nudged_kernels()
    path_check("mamba", cfg, run, {"scan": ssd.ssd_chunk_scan_plain},
               {"scan": nudged["scan"]}, "plain-SSD",
               "y nudged by 2^-24", cfg.n_layers)
    del run["params"], run["batch"], run["oracle"]
    decode_vs_forward("mamba", cfg, cfg.n_layers)
    return run


def phase_dense(smi: str) -> dict:
    """granite-8b at full width, ``DENSE``'s depth: a B2 launch a layer a
    forward (B4 H32 KV8 S2048 D128 causal); the path checked against the plain flash in float32 on its 6
    layers, the serving layer driven at full width (``[engine]``), and
    decode against forward on 2 layers."""
    cfg = dataclasses.replace(GRANITE_8B, **DENSE)
    run = drive_model("dense", cfg, {"flash_attention": cfg.n_layers})
    path_check("dense", cfg, run, {"flash": mflash.blocked_flash},
               {"flash": nudged_kernels()["flash"]}, "plain-flash",
               "the attention output nudged by 2^-9", 8)
    decode_past_the_cache("c6", cfg, run["params"])
    run["engine"] = phase_engine(cfg, run["params"], run["prompts"], smi)
    del run["params"], run["batch"], run["oracle"]
    torch.cuda.empty_cache()
    decode_vs_forward("dense", cfg, 2)
    return run


def phase_hybrid() -> dict:
    """zamba2-1.2b at full width, ``HYBRID``'s depth: 18 SSD scans (B4 H64
    L2048 P64 N64) and 3 B2 launches (B4 H32 KV32 S2048 D64 causal) a
    forward; the path checked against the plain flash and SSD in float32
    on all 18 layers, and decode against forward on 12 (two passes through
    the shared block)."""
    cfg = dataclasses.replace(ZAMBA2_1_2B, **HYBRID)
    run = drive_model("hybrid", cfg, {
        "ssd_scan": cfg.n_layers,
        "flash_attention": cfg.n_layers // cfg.hybrid_attn_every})
    nudged = nudged_kernels()
    path_check("hybrid", cfg, run,
               {"scan": ssd.ssd_chunk_scan_plain, "flash": mflash.blocked_flash},
               {"scan": nudged["scan"], "flash": mflash.blocked_flash},
               "plain-flash and plain-SSD", "the SSD's y nudged by 2^-24",
               cfg.n_layers)
    del run["params"], run["batch"], run["oracle"]
    torch.cuda.empty_cache()
    decode_vs_forward("hybrid", cfg, 2 * cfg.hybrid_attn_every)
    return run


def phase_configs(smi: str) -> dict:
    """``[configs]``: ``CONFIGS``' four at full width and their depths,
    each through :func:`drive_model` (forward over 4 x 2048 tokens at every
    placement, ``torch.equal`` to the all-local one, a B2 launch a layer a
    forward, all through wgmma; a served wave of 4 prompts) and
    :func:`path_check` (the plain-flash forward in float32 at
    ``CONFIGS_DEPTH32`` layers within ``PATH_BOUND``): internvl2-1b with its
    4 x 256 patches (B2 at S 2304, H 14 over KV 2), glm4-9b (H 32 over KV
    2), starcoder2-7b (H 36 over KV 4), granite-34b (H 48 over one KV
    head). Returns each configuration's path numbers."""
    t0 = time.perf_counter()
    nudged = nudged_kernels()
    out = {}
    for name, spec in CONFIGS.items():
        t1 = time.perf_counter()
        cfg = dataclasses.replace(get_config(name), **spec)
        run = drive_model("configs", cfg, {"flash_attention": cfg.n_layers})
        path_check("configs", cfg, run, {"flash": mflash.blocked_flash},
                   {"flash": nudged["flash"]}, "plain-flash",
                   "the attention output nudged by 2^-9", CONFIGS_DEPTH32)
        del run["params"], run["batch"], run["oracle"], run["prompts"]
        release_memory()
        print(f"[configs] {name} ({cfg.n_layers} of "
              f"{get_config(name).n_layers} layers) in "
              f"{time.perf_counter() - t1:.1f} s")
        out[name] = run
    print(f"[configs] wall {time.perf_counter() - t0:.1f} s; {smi}")
    return out


# -- [encdec]: seamless-m4t-medium ---------------------------------------------
def encdec_greedy(params, cfg, frames, first, n_new: int, plan=None):
    """``prefill`` of ``frames`` and ``n_new`` greedy tokens after
    ``first`` (B, 1) through ``encdec.decode_step``, a cache of ``n_new``
    slots. Returns the tokens, the cache, the prefill ms and each step's
    (ms, host ms)."""
    cache = ed.init_decode_cache(cfg, frames.shape[0], n_new)
    cache, pre_ms, _ = timed_ms(lambda: ed.prefill(params, cache, frames,
                                                   cfg, plan=plan))
    cur, out, steps = first, [], []
    for _ in range(n_new):
        (logits, cache), *ms = timed_ms(lambda: ed.decode_step(
            params, cache, cur, cfg, plan=plan))
        cur = logits[:, :, :cfg.vocab_size].argmax(-1).to(torch.int32)
        out.append(cur)
        steps.append(ms)
    return torch.cat(out, dim=1), cache, pre_ms, steps


def phase_encdec(smi: str) -> dict:
    """``[encdec]``: seamless-m4t-medium whole at full width in bf16,
    through ``get_model``'s ``encdec``: ``forward`` over 4 x (1024 frames,
    512 tokens) all local and placed by ``host_offload`` at 0.5 and 0.0,
    prefetch on and off (logits ``torch.equal``); 36 B2 launches a forward
    (12 encoder, full; 12 decoder, causal; 12 cross, full with Sq 512 and
    Sk 1024), every one through wgmma; the path check against the plain
    flash in float32 at full depth; ``prefill`` and 64 greedy tokens
    untiered and at host_offload 0.5 (tokens and every cache leaf equal);
    decode against forward in float32."""
    cfg = SEAMLESS
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    params = ed.init_params(gen, cfg, device="cpu")
    batch = make_batch(cfg, gen, ENCDEC["batch"], ENCDEC["tokens"])
    n_params = sum(t.numel() for _, t in _leaves_with_keys(params))
    print(f"[encdec] {cfg.name}: {cfg.n_encoder_layers} encoder + "
          f"{cfg.n_layers} decoder layers, d_model {cfg.d_model}, "
          f"{n_params / 1e9:.4f} B parameters ({cfg.dtype}, "
          f"{n_bytes(params) / 1e9:.2f} GB), frames "
          f"{tuple(batch['frames'].shape)}, tokens "
          f"{tuple(batch['tokens'].shape)}, made in "
          f"{time.perf_counter() - t0:.1f} s")
    per_forward = cfg.n_encoder_layers + 2 * cfg.n_layers
    zero_counts()
    oracle, rows, n_fwd = drive_placements("encdec", cfg, params, batch)
    launches, variants = counts(), dict(fa.VARIANT_LAUNCHES)
    want = {name: per_forward * n_fwd if name == "flash_attention" else 0
            for name in launches}
    print(f"[encdec] launches over {n_fwd} forwards: {launches}; flash by "
          f"variant {variants}")
    require(launches == want, f"[encdec] launches {launches}, expected "
                              f"{want} ({per_forward} B2 a forward)")
    require(variants["ffma"] == 0, f"[encdec] flash launches {variants}, "
                                   f"expected every one through wgmma")
    params = place_params(params, TieringConfig())[0]
    run = {"params": params, "batch": batch, "oracle": oracle.cuda()}
    path_check("encdec", cfg, run, {"flash": mflash.blocked_flash},
               {"flash": nudged_kernels()["flash"]}, "plain-flash",
               "the attention output nudged by 2^-9", cfg.n_layers)
    del run, oracle
    torch.cuda.empty_cache()

    first = batch["tokens"][:, :1]
    toks, cache, pre_ms, steps = encdec_greedy(params, cfg, batch["frames"],
                                               first, ENCDEC["new"])
    placed, plan = place_params(params, TieringConfig(
        mode="host_offload", local_fraction=0.5))
    toks_t, cache_t, pre_t, steps_t = encdec_greedy(
        placed, cfg, batch["frames"], first, ENCDEC["new"], plan=plan)
    require(torch.equal(toks, toks_t),
            "[encdec] host_offload 0.5 greedy tokens != untiered")
    for k in ("k", "v", "ck", "cv", "pos"):
        require(torch.equal(cache[k], cache_t[k]),
                f"[encdec] host_offload 0.5 cache[{k!r}] != untiered")
    for label, pms, st in (("untiered", pre_ms, steps),
                           ("host_offload 0.5", pre_t, steps_t)):
        steady = sorted(st[1:])
        med = steady[len(steady) // 2]
        print(f"[encdec] serve {label}: prefill (encoder + 12 layers' cross "
              f"K/V) {pms:.3f} ms, {len(st)} greedy steps, median "
              f"{med[0]:.3f} ms ({med[1]:.3f} ms on the host before the "
              f"synchronise), min {steady[0][0]:.3f} ms")
    print(f"[encdec] greedy tokens and every cache leaf torch.equal across "
          f"placements; tokens {toks[0, :8].tolist()}...")
    del placed, cache, cache_t
    torch.cuda.empty_cache()
    decode_vs_forward("encdec", cfg, cfg.n_layers, ENCDEC["tokens32"],
                      params=widened(params), lanes=ENCDEC["lanes32"])
    del params, batch
    release_memory()
    print(f"[encdec] {smi}")
    return {"launches": launches, "forwards": n_fwd, "rows": rows}


# -- [moe]: deepseek-v3 and mixtral-8x7b -----------------------------------------
def mem_available_gb() -> float:
    """The host's ``MemAvailable`` (``/proc/meminfo``) in GB."""
    for line in Path("/proc/meminfo").read_text().splitlines():
        if line.startswith("MemAvailable:"):
            return int(line.split()[1]) * 1024 / 1e9
    raise SystemExit("chip_smoke FAILED: no MemAvailable in /proc/meminfo")


def release_memory() -> None:
    """Return freed device blocks and the pinned host blocks that
    PyTorch's host allocator caches (a paged full-width MoE layer pins
    22.5 GB) to the system."""
    gc.collect()
    torch.cuda.empty_cache()
    host_empty_cache = getattr(torch._C, "_host_emptyCache", None)
    if host_empty_cache is not None:
        host_empty_cache()


def is_expert_leaf(name: str) -> bool:
    return "['moe']['w_" in name


def moe_paged_wave(cfg, params, host_prompts, want, want_cache: dict,
                   resident: int, ecfg: dict) -> str:
    """One ``generate`` wave through an engine whose routed experts are
    paged (``resident`` of ``n_experts`` a layer in the assembled view);
    its tokens must equal ``want`` and every leaf of its cache
    ``want_cache``, the untiered engine's (every layer's K/V or latent at
    every position: the whole computation, where random weights may give
    few distinct tokens). Returns the report line."""
    t0 = time.perf_counter()
    eng = ServingEngine(cfg, params, EngineConfig(
        **ecfg, expert_paging=ExpertPagingConfig(resident_max=resident)))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    toks, line = engine_wave(eng, host_prompts, MOE_NEW)
    peak = torch.cuda.max_memory_allocated() / 2**30
    require(np.array_equal(toks, want),
            f"[moe] {cfg.name}: paged tokens != the untiered engine's")
    for key, leaf in want_cache.items():
        require(torch.equal(eng.cache[key], leaf),
                f"[moe] {cfg.name}: the paged engine's cache['{key}'] != "
                f"the untiered engine's")
    store = eng.expert_store
    st = store.stats()
    store.close()
    out = (f"resident {resident} of {cfg.n_experts} a layer "
           f"({cfg.n_experts / resident:.0f}x oversubscribed), "
           f"{st['n_moe_layers'] * cfg.n_experts} slabs of "
           f"{st['slab_bytes'] / 1e6:.1f} MB in a 1-node pool (set-up "
           f"{setup_s:.1f} s: the pinned host copy and the pool's "
           f"registration); {line}; tokens and every cache leaf "
           f"({', '.join(sorted(want_cache))}) equal to the untiered "
           f"engine's; "
           f"hit rate {st['hit_rate']!r} ({st['hits']} hits, {st['misses']} "
           f"misses), {st['sync_fetches']} sync fetches (against "
           f"{st['misses']} misses), {st['prefetch_commits']} prefetch "
           f"commits, {st['bytes_fetched']} B fetched by the ledger and "
           f"{store.copy_bytes} B over the copy stream; simulated stall "
           f"{st['sim_stall_us']!r} us over compute {st['sim_compute_us']!r}"
           f" us = degradation {st['degradation']!r}; peak {peak:.3f} GiB")
    del eng, store
    gc.collect()
    return out


def drive_moe(name: str, spec: dict, smi: str) -> dict:
    """One MoE configuration at full width, depth cut to ``spec``: the
    weights drawn on the card; ``forward`` over 4 x 2048 tokens all local
    and at host_offload 0.5 (the routed experts demoted first), prefetch on
    and off, logits ``torch.equal``; B2 once a layer a forward, all on the
    tensor cores; serving 4 prompts of 64 tokens and 16 new through
    ``ServingEngine.generate`` untiered, then with the experts paged (tokens
    equal); then, in float32 at ``depth32``, the path check against the
    models' plain flash and decode against forward without drops."""
    full = get_config(name)
    cfg = dataclasses.replace(full, n_layers=spec["n_layers"])
    n_moe = cfg.n_layers - cfg.first_k_dense
    expert_1 = full.n_experts * 3 * full.d_model * full.moe_d_ff
    attn = (f"MLA (q_lora {cfg.q_lora_rank}, kv_lora {cfg.kv_lora_rank}, "
            f"head dims {cfg.qk_nope_head_dim} + {cfg.qk_rope_head_dim}, v "
            f"{cfg.v_head_dim})" if cfg.attention == "mla" else
            f"GQA {cfg.n_kv_heads} KV heads, window {cfg.sliding_window}")
    print(f"[moe] {name} at full width: d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads, {attn}, {cfg.n_experts} routed experts "
          f"top-{cfg.top_k} of d_ff {cfg.moe_d_ff} + {cfg.n_shared_experts} "
          f"shared, dense d_ff {cfg.d_ff}, vocab {cfg.vocab_size}. The "
          f"config counts {full.param_count() / 1e9:.1f} B parameters, "
          f"{2 * full.param_count() / 1e9:.0f} GB in bf16, over "
          f"{full.n_layers} layers (one MoE layer's routed experts "
          f"{expert_1 / 1e9:.2f} B, {2 * expert_1 / 1e9:.1f} GB) against the "
          f"card's 80 GB, so the depth is cut to {cfg.n_layers} layers "
          f"({cfg.first_k_dense} dense + {n_moe} MoE"
          f"{' + the mtp block' if cfg.mtp_depth else ''}): "
          f"{cfg.param_count() / 1e9:.2f} B counted, "
          f"{2 * cfg.param_count() / 1e9:.1f} GB; host MemAvailable "
          f"{mem_available_gb():.1f} GB")
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    params = tf.init_params(gen, cfg)
    batch = make_batch(cfg, gen, 4, 2048)
    prompts = make_batch(cfg, gen, 4, MOE_PROMPT)["tokens"]
    torch.cuda.synchronize()
    n_params = sum(t.numel() for _, t in _leaves_with_keys(params))
    print(f"[moe] {name}: drew {n_params / 1e9:.4f} B parameters "
          f"({n_bytes(params) / 1e9:.2f} GB, {cfg.dtype}) on the card in "
          f"{time.perf_counter() - t0:.1f} s; batch "
          f"{tuple(batch['tokens'].shape)}")
    plan = plan_for_params(params, config=TieringConfig(
        mode="host_offload", local_fraction=0.5))
    remote = plan.remote_names()
    require(remote and all(is_expert_leaf(n) for n in remote),
            f"[moe] {name}: host_offload 0.5 demotes {remote}, not the "
            f"routed experts first")
    print(f"[moe] {name}: host_offload 0.5 demotes {remote} "
          f"({plan.remote_bytes / 1e9:.2f} GB), the routed experts first")

    zero_counts()
    _, rows, n_fwd = drive_placements(f"moe {name}", cfg, params, batch,
                                      fractions=(1.0, 0.5))
    host_prompts = prompts.cpu().numpy()
    ecfg = dict(max_batch=4, max_len=MOE_PROMPT + MOE_NEW)
    eng = ServingEngine(cfg, params, EngineConfig(**ecfg))
    torch.cuda.reset_peak_memory_stats()
    want, line = engine_wave(eng, host_prompts, MOE_NEW)
    peak = torch.cuda.max_memory_allocated() / 2**30
    want_cache = eng.cache
    del eng
    print(f"[moe] {name} untiered ServingEngine.generate: 4 prompts x "
          f"{MOE_PROMPT} + {MOE_NEW} new: {line}; peak {peak:.3f} GiB; "
          f"tokens {want[0, :8].tolist()}...")
    print(f"[moe] {name} paged ServingEngine.generate: " + moe_paged_wave(
        cfg, params, host_prompts, want, want_cache, spec["resident"],
        ecfg))
    del want_cache
    launches = counts()
    variants = dict(fa.VARIANT_LAUNCHES)
    print(f"[moe] {name} launches over {n_fwd} forwards and 2 served "
          f"waves: {launches}; flash by variant {variants}")
    want_l = {k: (cfg.n_layers * n_fwd if k == "flash_attention" else 0)
              for k in launches}
    require(launches == want_l, f"[moe] {name}: launches {launches}, "
                                f"expected {want_l} (B2 once a layer)")
    require(variants["ffma"] == 0, f"[moe] {name}: flash launches "
                                   f"{variants}, expected all wgmma")
    del params, batch, prompts
    release_memory()

    cfg32 = dataclasses.replace(cfg, dtype=torch.float32,
                                n_layers=spec["depth32"],
                                first_k_dense=spec["dense32"], mtp_depth=0)
    gen = torch.Generator(device="cuda").manual_seed(1)
    p32 = tf.init_params(gen, cfg32)
    batch32 = make_batch(cfg32, gen, 2, 2048)
    worst, scale, mean, agree = logits_diff(
        tf.forward(p32, batch32, cfg32)[0],
        forward_with(p32, batch32, cfg32, flash=mflash.blocked_flash),
        cfg.vocab_size)
    require(worst <= PATH_BOUND * max(scale, 1.0),
            f"[moe] {name} f32: plain-flash forward differs by {worst:.4g} "
            f"> {PATH_BOUND} x max(1, {scale:.4g})")
    print(f"[moe] {name} float32 kernel forward (B2's FFMA kernel) vs "
          f"plain-flash forward, 2 x 2048 tokens at {cfg32.n_layers} of "
          f"{full.n_layers} layers ({cfg32.first_k_dense} dense + "
          f"{cfg32.n_layers - cfg32.first_k_dense} MoE, "
          f"{n_bytes(p32) / 1e9:.1f} GB of float32 weights, the depth that "
          f"fits the card): max|diff| {worst:.4g} "
          f"({worst / max(scale, 1.0):.4g} of max|logits| {scale:.4g}; bound "
          f"{PATH_BOUND}), mean|diff| {mean:.4g}, greedy tokens agree at "
          f"{agree:.2%}")
    del batch32
    decode_vs_forward(f"moe {name}", dataclasses.replace(
        full, capacity_factor=8.0), spec["depth32"], spec["tokens32"],
        params=p32, lanes=spec["lanes32"], moe_groups=1)
    del p32
    release_memory()
    print(f"[moe] {name}: host MemAvailable {mem_available_gb():.1f} GB "
          f"after the phase")
    return {"launches": launches, "rows": rows, "forwards": n_fwd}


def phase_moe(smi: str) -> dict:
    """``[moe]``: each configuration of ``MOE_MODELS`` through
    :func:`drive_moe`; returns its numbers by name."""
    t0 = time.perf_counter()
    out = {name: drive_moe(name, spec, smi)
           for name, spec in MOE_MODELS.items()}
    print(f"[moe] wall {time.perf_counter() - t0:.1f} s; {smi}")
    return out


# -- [train]: granite-8b trained at full width ----------------------------------
def b2_backward_bound(q, k, v, causal: bool = True) -> tuple[float, str]:
    """The backward's bound over (B, H, Sq, D) q: five products (S and dP
    recomputed, dV, dQ, dK), three over D and two over Dv
    (:func:`repro_torch.kernels.work.flash_bwd_work`); q, k, v, o, do and
    the lse read once, dq, dk, dv written."""
    B, H, S, D = q.shape
    KV, Sk, Dv = k.shape[1], k.shape[2], v.shape[3]
    return bound(*work.flash_bwd_work(B, H, S, Sk, KV, D, Dv, causal=causal,
                                      window=None,
                                      itemsize=q.element_size()),
                 PEAK_FLOPS[q.dtype])


def dq_dropping_tile(dq, qt, kt, vt, o, lse, dot, scale: float,
                     keys: slice) -> torch.Tensor:
    """``dq`` (B,S,H,D) less one key tile's contribution: batch 0, the
    query heads of KV head 0, keys ``keys`` (causal), the tile's dS from
    B2's (B,H,S,·) o and lse in float32."""
    G, S = qt.shape[1] // kt.shape[1], qt.shape[2]
    qf, dof, of = (t[0, :G].float() for t in (qt, dot, o))  # (G,S,·)
    ks, vs = kt[0, 0, keys].float(), vt[0, 0, keys].float()
    cols = torch.arange(keys.start, keys.stop, device=dq.device)
    live = cols[None, :] <= torch.arange(S, device=dq.device)[:, None]
    p = torch.where(live, torch.exp(qf @ ks.T * scale - lse[0, :G, :, None]),
                    0.0)
    ds = p * (dof @ vs.T - (dof * of).sum(-1, keepdim=True)) * scale
    out = dq.clone()
    out[0, :, :G] = (dq[0, :, :G].float()
                     - (ds @ ks).transpose(0, 1)).to(dq.dtype)
    return out


def plain_dq(qt, kt, vt, o, lse, dot, scale: float, exact: bool):
    """The plain backward's dq (B,S,H,D) from a given (B,H,S,·) o and lse,
    its scores rounded to the inputs' type as the reference's are, or with
    ``exact`` in float32 as B2's are."""
    B, H, S, D = qt.shape
    KV = kt.shape[1]
    G = H // KV
    res = (qt.reshape(B, KV, G, S, D), kt, vt, o.reshape(B, KV, G, S, -1),
           lse.reshape(B, KV, G, S))
    dq, _, _ = mflash._flash_bwd(
        mflash.MaskSpec(causal=True), scale, min(mflash.DEFAULT_BLOCK_K, S),
        mflash.DEFAULT_STRIPS, res, dot.reshape(B, KV, G, S, -1),
        exact_scores=exact)
    return dq.reshape(B, H, S, D).transpose(1, 2)


def check_b2_vjp(dtype, sh: dict = TRAIN_FLASH) -> dict:
    """B2 with its lse and its VJP at a train step's attention shape
    ``sh`` (granite-8b's by default; ``TRAIN_FLASH_MORE``'s), in the
    models' (B, S, H, D) layout: o bit-identical to the launch without the
    lse; the lse against ``_fwd_all``'s on the same inputs in float32
    (``FLASH_TOL`` float32: the kernel's scores are float32 products of
    the same values); dq, dk and dv of the B2 Function (``flash_attention``
    on the card) against ``blocked_flash``'s autograd on the card, within
    ``FLASH_TOL`` for ``dtype``. In bf16 dq's bound adds o's rounding
    through delta (:func:`flash_dq_rounding_bound`, from the plain side's
    o); at
    ``TRAIN_FLASH`` the share of dq's gap each rounding leaves is printed,
    and two planted faults, dk and dq each with one 128-key tile's
    contribution dropped, must fail. Then the backward kernels
    (``_launch_bwd``) against their plain version ``_plain_bwd`` on the
    same saved o, lse and do, within ``FLASH_TOL``, with a planted fault
    (dk without keys 128..255 of KV head 0) that must fail; in bf16 the
    kernels are timed beside their bound, the plain version, and SDPA's
    backward alone and with its forward."""
    B, H, KV, S, D = (sh[k] for k in ("B", "H", "KV", "S", "D"))
    Sk, causal, Dv = sh.get("Sk", S), sh.get("causal", True), sh.get("Dv", D)
    rng = np.random.default_rng(12)
    q, k, v, do = (rand(rng, shape, dtype) for shape in (
        (B, S, H, D), (B, Sk, KV, D), (B, Sk, KV, Dv), (B, S, H, Dv)))
    scale = 1.0 / math.sqrt(D)
    qt, kt, vt, dot = (t.transpose(1, 2) for t in (q, k, v, do))
    what = f"B2 {shape_label(q, k, v, causal)} {dtype} " \
           f"{fa._variant(dtype, D, Dv)}"

    def launch(with_lse: bool):
        return fa._launch(qt, kt, vt, causal=causal, window=None,
                          scale=scale, with_lse=with_lse)

    o, lse = launch(True)
    require(torch.equal(o, launch(False)),
            f"{what}: o with the lse differs from o without it")
    spec = mflash.MaskSpec(causal=causal)
    # whole blocks of keys (internvl2-1b's 2304 in blocks of 256)
    block_k = math.gcd(mflash.DEFAULT_BLOCK_K, Sk)
    _, lse32 = mflash._fwd_all(
        qt.float().reshape(B, KV, H // KV, S, D), kt.float(), vt.float(),
        spec, scale, block_k, mflash.DEFAULT_STRIPS)
    out = {"lse": max_err(lse, lse32.reshape(B, H, S),
                          FLASH_TOL[torch.float32],
                          f"{what} lse against _fwd_all's on the inputs in "
                          f"float32")}
    del lse32

    def grads(fn):
        ins = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
        return torch.autograd.grad(fn(*ins), ins, do)

    got = grads(lambda a, b, c: mflash.flash_attention(a, b, c,
                                                       causal=causal))
    want = grads(lambda a, b, c: mflash.blocked_flash(a, b, c, causal=causal))
    dq_extra = dk_extra = None
    if dtype == torch.bfloat16:
        # the plain side's own o and lse, in its (B,H,S,·) layout
        o_p, lse_p = (t.reshape(B, H, S, *t.shape[4:]) for t in
                      mflash._fwd_all(qt.reshape(B, KV, H // KV, S, D), kt,
                                      vt, spec, scale, block_k,
                                      mflash.DEFAULT_STRIPS))
        # dq and dk also carry o's rounding through delta = sum(do * o);
        # dk sums it over the group's rows (C10)
        dq_extra = flash_dq_rounding_bound(q, k, o_p.transpose(1, 2), do,
                                           causal=causal, scale=scale)
        dk_extra = flash_dk_rounding_bound(q, k, o_p.transpose(1, 2), do,
                                           causal=causal, scale=scale)
        bare = tolerance_ratio(got[1], want[1], FLASH_TOL[dtype]).max()
        print(f"[check] {what} VJP dk without o's rounding through delta in "
              f"its bound: worst element at {bare.item():.3f} of it")
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        extra = {"dq": dq_extra, "dk": dk_extra}.get(name)
        out[name] = max_err(g, w, FLASH_TOL[dtype],
                            f"{what} VJP {name}: the B2 Function (its "
                            f"backward kernels from B2's lse) against "
                            f"blocked_flash's autograd"
                            + (", bound + o's rounding through delta"
                               if extra is not None else ""), extra)
    # the backward kernels against their plain version, the same inputs
    kw = dict(causal=causal, window=None, scale=scale)
    bwd_variant = fa._bwd_variant(dtype, D, Dv)
    parts = (fa._bwd_parts(B, KV, Sk, H // KV, fa._sm_count(qt), D)
             if bwd_variant == "wgmma" else 1)
    require(parts == (sh.get("parts", 1) if bwd_variant == "wgmma" else 1),
            f"{what}: the backward splits each group's heads into {parts} "
            f"parts, expected {sh.get('parts', 1)}")
    if parts > 1:
        print(f"[check] {what} backward: each group's {H // KV} heads in "
              f"{parts} parts of "
              f"{[len(r) for r in fa.part_heads(H // KV, parts)]} heads, "
              f"{B * KV * -(-Sk // fa.BWD_KEYS) * parts} dk/dv CTAs on "
              f"{fa._sm_count(qt)} SMs (one part: "
              f"{B * KV * -(-Sk // fa.BWD_KEYS)})")
    kern = fa._launch_bwd(qt, kt, vt, o, lse, dot, **kw)
    again = fa._launch_bwd(qt, kt, vt, o, lse, dot, **kw)
    require(all(torch.equal(a, b) for a, b in zip(kern, again)),
            f"{what}: two launches of the backward kernels on the same "
            f"inputs differ")
    print(f"[check] {what} backward kernels ({bwd_variant})"
          f": two launches on the same inputs torch.equal in dq, dk and dv")
    out["deterministic"] = True
    del again
    plain_bw = fa._plain_bwd(qt, kt, vt, o, lse, dot, **kw)
    # In bf16, dq's bound also carries delta's float32 sums: the two sides
    # sum delta = do . o and dp = do . v in other orders, and a row where
    # they cancel (query 0 of a causal row sees one key: o = v, dq = 0 up
    # to that order) has a zero row scale. The term is o's rounding bound
    # scaled from 2^-8 to 2^-16 of sum|do o| (up to 256 float32 ulps).
    delta_extra = None if dq_extra is None else dq_extra * 2.0 ** -8
    for name, g, w in zip(("dq", "dk", "dv"), kern, plain_bw):
        out[f"kernel_{name}"] = max_err(
            g, w, FLASH_TOL[dtype],
            f"{what} backward kernels ({bwd_variant}) {name} against "
            f"_plain_bwd on the same o, lse and do"
            + (", bound + delta's float32 sums" if name == "dq"
               and delta_extra is not None else ""),
            delta_extra.transpose(1, 2) if name == "dq"
            and delta_extra is not None else None)
    del delta_extra
    faulty = kern[1].clone()
    faulty[0, 0, 128:256] = 0  # batch 0, KV head 0, keys 128..255
    bad = int(outside_tolerance(faulty, plain_bw[1], FLASH_TOL[dtype]).sum())
    require(bad > 0, f"the bound passes a planted fault: the backward "
                     f"kernels' dk without one 128-key tile at {what}")
    print(f"[fault] B2 backward kernels ({bwd_variant}) dk without keys "
          f"128:256 of KV head 0 at {what}: {bad} of {faulty.numel()} "
          f"elements beyond the bound, rejected")
    del kern, plain_bw, faulty
    if dtype == torch.bfloat16 and sh is TRAIN_FLASH:
        # dq's gap taken apart: the plain side's dq with one of the two
        # roundings it differs in made B2's (worst share of the plain bound)
        plain = {
            "blocked_flash": want[0],
            "float32 scores and B2's lse, the plain o": plain_dq(
                qt, kt, vt, o_p, lse, dot, scale, True),
            "B2's o, the plain scores and lse": plain_dq(
                qt, kt, vt, o, lse_p, dot, scale, False),
        }
        share = {label: tolerance_ratio(got[0], w,
                                        FLASH_TOL[dtype]).max().item()
                 for label, w in plain.items()}
        del plain
        print(f"[check] {what} VJP dq's gap without the delta term, worst "
              f"element's share of the bound against the plain side's dq "
              + "; ".join(f"with {k}: {v:.3f}" for k, v in share.items()))
        out["dq_gap"] = share
        tile = slice(128, 256)
        for name, faulty, w, extra in (
                ("dk", got[1].clone(), want[1], dk_extra),
                ("dq", dq_dropping_tile(got[0], qt, kt, vt, o, lse, dot,
                                        scale, tile), want[0], dq_extra)):
            if name == "dk":
                faulty[0, tile, 0] = 0  # KV head 0's keys 128..255, batch 0
            bad = int((~(tolerance_ratio(faulty, w, FLASH_TOL[dtype], extra)
                         <= 1.0)).sum())
            require(bad > 0, f"the bound passes a planted fault: {name} "
                             f"without one 128-key tile")
            print(f"[fault] B2 VJP {name} without keys 128:256 of KV head 0"
                  + (" (bound + o's rounding through delta)" if extra
                     is not None else "")
                  + f": {bad} of {faulty.numel()} elements beyond the "
                  f"bound, rejected")
    if dtype == torch.bfloat16:
        del dq_extra, dk_extra, o_p, lse_p
        fb, fby = flash_bound(qt, kt, vt, causal)
        bb, bby = b2_backward_bound(qt, kt, vt, causal)
        k_rep, v_rep = (t.detach().requires_grad_(True)
                        for t in gqa_repeated(qt, kt, vt))
        q_req = qt.detach().requires_grad_(True)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        # with and without the lse in turns: without, with, with, without
        turns = [time_ms(lambda: launch(w), 10)
                 for w in (False, True, True, False)]
        out["times"] = {
            "ms": (turns[1] + turns[2]) / 2,
            "no_lse_ms": (turns[0] + turns[3]) / 2,
            "bound_ms": fb, "bound_by": fby,
            "backward_ms": time_ms(lambda: fa._launch_bwd(
                qt, kt, vt, o, lse, dot, **kw), 10),
            "backward_variant": bwd_variant,
            "plain_backward_ms": time_ms(lambda: fa._plain_bwd(
                qt, kt, vt, o, lse, dot, **kw), 3),
            "backward_bound_ms": bb, "backward_bound_by": bby,
            "shape": shape_label(q, k, v, causal) + " bf16",
        }
        t = out["times"]
        t["parts"] = parts
        if parts > 1:  # the split against one part, in turns on one input
            part_turns = [(p, time_ms(lambda: fa._launch_bwd(
                qt, kt, vt, o, lse, dot, parts=p, **kw), 10))
                for p in (1, parts, parts, 1, 1, parts, parts, 1)]
            t["one_part_ms"] = float(np.median(
                [ms for p, ms in part_turns if p == 1]))
            t["parts_ms"] = float(np.median(
                [ms for p, ms in part_turns if p > 1]))
            t["launch_ms"], t["one_part_launch_ms"] = (
                {kernel_name(n): ms for n, (ms, _) in launch_times(
                    lambda: fa._launch_bwd(qt, kt, vt, o, lse, dot, parts=p,
                                           **kw)).items()}
                for p in (parts, 1))
            print(f"[time] B2 backward kernels at {what}: {parts} parts "
                  f"{t['parts_ms']:.4f} ms, one part {t['one_part_ms']:.4f} "
                  f"ms (medians of 4 in turns: "
                  + ", ".join(f"P{p} {ms:.4f}" for p, ms in part_turns)
                  + "); a launch's kernels under the profiler, ms: "
                  + "; ".join(f"{n} part(s) " + ", ".join(
                      f"{k} {v:.4f}" for k, v in lt.items())
                      for n, lt in ((parts, t["launch_ms"]),
                                    (1, t["one_part_launch_ms"]))))
        if "ffma_below" in sh:  # the CUDA-core kernels on the same inputs
            t["ffma_backward_ms"] = time_ms(lambda: fa._launch_bwd(
                qt, kt, vt, o, lse, dot, variant="ffma", **kw), 3)
            require(t["backward_ms"] < sh["ffma_below"]
                    * t["ffma_backward_ms"],
                    f"{what}: the backward kernels ({bwd_variant}) take "
                    f"{t['backward_ms']:.4f} ms, not below "
                    f"{sh['ffma_below']} of the FFMA kernels' "
                    f"{t['ffma_backward_ms']:.4f} ms")
            # each of the launch's kernels alone, under the profiler
            t["launch_ms"] = {kernel_name(n): ms for n, (ms, _) in
                              launch_times(lambda: fa._launch_bwd(
                                  qt, kt, vt, o, lse, dot, **kw)).items()}
        o_sdpa = sdpa(q_req, k_rep, v_rep, is_causal=causal)
        t["sdpa_bwd_ms"] = time_ms(lambda: torch.autograd.grad(
            o_sdpa, [q_req, k_rep, v_rep], dot, retain_graph=True), 10)
        t["sdpa_fwd_bwd_ms"] = time_ms(lambda: torch.autograd.grad(
            sdpa(q_req, k_rep, v_rep, is_causal=causal),
            [q_req, k_rep, v_rep], dot), 10)
        t["sdpa_backend"] = sdpa_backend(qt, k_rep, v_rep, causal)
        del o_sdpa
        ffma = (f", the FFMA kernels on the same inputs "
                f"{t['ffma_backward_ms']:.4f} ms (the {bwd_variant} kernels "
                f"at {t['backward_ms'] / t['ffma_backward_ms']:.2%} of it, "
                f"required below {sh['ffma_below']:.0%}; a launch's kernels "
                + ", ".join(f"{k} {v:.4f}" for k, v in t["launch_ms"].items())
                + " ms under the profiler)" if "ffma_backward_ms" in t else "")
        print(f"[time] B2 in the train step ({what}): forward with lse "
              f"{t['ms']:.4f} ms, without {t['no_lse_ms']:.4f} ms (in turns "
              f"{', '.join(f'{x:.4f}' for x in turns)}; bound {fb:.4f}, "
              f"{fby}); backward kernels ({bwd_variant}) "
              f"{t['backward_ms']:.4f} ms (bound {bb:.4f}, {bby}; the plain "
              f"_flash_bwd from the saved lse {t['plain_backward_ms']:.4f} "
              f"ms{ffma}); SDPA backward alone {t['sdpa_bwd_ms']:.4f} ms, "
              f"forward + backward {t['sdpa_fwd_bwd_ms']:.4f} ms "
              f"({t['sdpa_backend']})")
    torch.cuda.synchronize()
    return out


def check_b2_window(sh: dict = TRAIN_FLASH_WINDOW) -> dict:
    """B2's backward kernels alone under a causal sliding window (``sh``,
    bf16: mixtral-8x7b's, whose train leg in :func:`phase_train` runs the
    same shape) against ``_plain_bwd`` on the same o, lse and dO, within
    ``FLASH_TOL`` (dq's bound with delta's float32 sums, as
    :func:`check_b2_vjp`'s); two launches ``torch.equal``; a planted fault
    (dk of KV head 0 without keys 4096..4223, which only queries inside the
    window see) must fail. Timed
    beside its bound, the plain version and SDPA's backward alone with the
    window as an explicit boolean mask (k and v expanded to every head; the
    backend that answered printed)."""
    B, H, KV, S, D, window = (sh[k] for k in ("B", "H", "KV", "S", "D",
                                               "window"))
    rng = np.random.default_rng(13)
    q, k, v, do = (rand(rng, shape, torch.bfloat16) for shape in (
        (B, S, H, D), (B, S, KV, D), (B, S, KV, D), (B, S, H, D)))
    scale = 1.0 / math.sqrt(D)
    qt, kt, vt, dot = (t.transpose(1, 2) for t in (q, k, v, do))
    kw = dict(causal=True, window=window, scale=scale)
    what = (f"B2 backward kernels ({fa._bwd_variant(q.dtype, D, D)}) "
            f"{shape_label(q, k, v, True)} window {window} bf16")
    o, lse = fa._launch(qt, kt, vt, with_lse=True, **kw)
    kern = fa._launch_bwd(qt, kt, vt, o, lse, dot, **kw)
    again = fa._launch_bwd(qt, kt, vt, o, lse, dot, **kw)
    require(all(torch.equal(a, b) for a, b in zip(kern, again)),
            f"{what}: two launches on the same inputs differ")
    del again
    plain_bw = fa._plain_bwd(qt, kt, vt, o, lse, dot, **kw)
    # delta's float32 sums, as check_b2_vjp's bound, one KV group at a time
    # (the dense oracle's scores of all heads at once would take 26 GB)
    G = H // KV
    extra = torch.cat([flash_dq_rounding_bound(
        q[:, :, j * G:(j + 1) * G], k[:, :, j:j + 1],
        o.transpose(1, 2)[:, :, j * G:(j + 1) * G], do[:, :, j * G:(j + 1) * G],
        causal=True, window=window, scale=scale) for j in range(KV)], dim=2)
    extras = ((extra * 2.0 ** -8).transpose(1, 2), None, None)
    del extra
    out = {"deterministic": True}
    for name, g, w, e in zip(("dq", "dk", "dv"), kern, plain_bw, extras):
        out[f"kernel_{name}"] = max_err(
            g, w, FLASH_TOL[torch.bfloat16],
            f"{what} {name} against _plain_bwd on the same o, lse and do"
            + (", bound + delta's float32 sums" if e is not None else ""), e)
    faulty = kern[1].clone()
    faulty[0, 0, 4096:4224] = 0
    bad = int(outside_tolerance(faulty, plain_bw[1],
                                FLASH_TOL[torch.bfloat16]).sum())
    require(bad > 0, f"the bound passes a planted fault: {what} dk without "
                     f"keys 4096:4224 of KV head 0")
    print(f"[fault] {what} dk without keys 4096:4224 of KV head 0: {bad} of "
          f"{faulty.numel()} elements beyond the bound, rejected")
    del kern, plain_bw, faulty, extras
    bb, bby = bound(*work.flash_bwd_work(B, H, S, S, KV, D, D, causal=True,
                                          window=window, itemsize=2),
                    PEAK_FLOPS[torch.bfloat16])
    # query i sees key j for i - window < j <= i
    i = torch.arange(S, device="cuda")
    mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)
    q_req = qt.detach().requires_grad_(True)
    k_rep, v_rep = (t.repeat_interleave(H // KV, dim=1).detach()
                    .requires_grad_(True) for t in (kt, vt))
    o_sdpa = torch.nn.functional.scaled_dot_product_attention(
        q_req, k_rep, v_rep, attn_mask=mask, scale=scale)
    sdpa_o_err = (o_sdpa.float() - o.float()).abs().max().item()
    out["times"] = {
        "backward_ms": time_ms(lambda: fa._launch_bwd(
            qt, kt, vt, o, lse, dot, **kw), 10),
        "plain_backward_ms": time_ms(lambda: fa._plain_bwd(
            qt, kt, vt, o, lse, dot, **kw), 3),
        "backward_bound_ms": bb, "backward_bound_by": bby,
        "sdpa_bwd_ms": time_ms(lambda: torch.autograd.grad(
            o_sdpa, [q_req, k_rep, v_rep], dot, retain_graph=True), 10),
        "sdpa_backend": sdpa_backend(q_req, k_rep, v_rep, False, mask),
        "shape": f"{shape_label(q, k, v, True)} window {window} bf16"}
    del o_sdpa, q_req, k_rep, v_rep, mask
    t = out["times"]
    print(f"[time] {what}: {t['backward_ms']:.4f} ms (bound {bb:.4f}, {bby}; "
          f"the plain _flash_bwd {t['plain_backward_ms']:.4f} ms); SDPA "
          f"backward alone with the window as a boolean mask "
          f"{t['sdpa_bwd_ms']:.4f} ms ({t['sdpa_backend']}; its o within "
          f"{sdpa_o_err:.3g} of B2's)")
    torch.cuda.synchronize()
    return out


class RepeatedBatch:
    """A dataset whose every step is the wrapped dataset's step-0 batch."""

    def __init__(self, dataset):
        self.dataset = dataset

    def batch_at(self, step: int) -> dict:
        return self.dataset.batch_at(0)


def saved_by_forward(fn, model=tf, calls: int = 1):
    """``fn()`` with ``model``'s ``loss_fn`` wrapped so that a hook on the
    loss reads the device memory allocated when the backward starts:
    returns (``fn()``, those bytes at the first of the ``calls``
    backwards, one a microbatch). Less what was allocated before ``fn``,
    that is what the (first microbatch's) forward saved for the
    backward."""
    seen = []
    loss_fn = model.loss_fn

    def hooked(*args, **kw):
        loss, metrics = loss_fn(*args, **kw)
        loss.register_hook(
            lambda g: seen.append(torch.cuda.memory_allocated()))
        return loss, metrics

    model.loss_fn = hooked
    try:
        out = fn()
    finally:
        model.loss_fn = loss_fn
    require(len(seen) == calls, f"[train] the loss hook ran {len(seen)} "
                                f"times, expected {calls}")
    return out, seen[0]


class backward_calls:
    """While open, every call of B2's and B3's autograd Function backward
    (``_B2Function.backward``, ``_B3Function.backward``) is bracketed by
    CUDA events: ``spans["B2"]`` and ``spans["B3"]`` hold one (start, end)
    pair a call. On the way out the backward kernels' launches since the
    opening must equal those calls (``BWD_LAUNCHES`` of each module): every
    backward went through its kernels."""

    funcs = {"B2": fa._B2Function, "B3": ssd._B3Function}

    def __init__(self, what: str):
        self.what = what
        self.spans = {"B2": [], "B3": []}
        # the staticmethod objects themselves, put back as they were
        self.saved = {k: f.__dict__["backward"] for k, f in self.funcs.items()}

    def _timed(self, kernel: str):
        backward = self.saved[kernel].__func__

        def call(ctx, *grads):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = backward(ctx, *grads)
            ev[1].record()
            self.spans[kernel].append(ev)
            return out
        return staticmethod(call)

    def __enter__(self):
        self.before = (fa.BWD_LAUNCHES, ssd.BWD_LAUNCHES)
        for k, f in self.funcs.items():
            f.backward = self._timed(k)
        return self.spans

    def __exit__(self, *exc):
        for k, f in self.funcs.items():
            f.backward = self.saved[k]
        if exc[0] is None:
            launched = (fa.BWD_LAUNCHES - self.before[0],
                        ssd.BWD_LAUNCHES - self.before[1])
            calls = (len(self.spans["B2"]), len(self.spans["B3"]))
            require(launched == calls,
                    f"{self.what}: backward kernel launches (B2, B3) "
                    f"{launched} != the Functions' backward calls {calls}")
        return False


def profile_step(label: str, step, state: list, batch, step_ms: float):
    """One step under ``torch.profiler`` (device time by category, idle
    share against ``step_ms``, the unprofiled step), after one unprofiled
    step in which CUDA events bracket every call of the whole backward of
    B2's and B3's autograd Functions (:class:`backward_calls`: each call
    launches its backward kernels, counted): their time in the step.
    ``state`` is [params, opt], emptied here so that no older state than
    a step's input stays on the card beside its output. Returns the new
    state and the numbers."""
    params, opt = state
    state.clear()
    with backward_calls(f"[train] step {label}") as spans:
        (params, opt, _), ms, _ = timed_ms(lambda: step(params, opt, batch))
    bwd = {k: sum(a.elapsed_time(b) for a, b in v) for k, v in spans.items()}
    box = {}
    wall, kernels = profiled(
        lambda: box.update(out=step(params, opt, batch)))
    report(f"train step {label}", wall, kernels)
    dev_ms = sum(t for t, _ in kernels.values())
    # the forward kernels: not the backward's (B3's first backward launch
    # is the chunk-state kernel's instantiation with its flag true)
    def forward(name: str, part: str) -> bool:
        return part in name and "_bwd" not in name and "true>" not in name

    fwd = {"B2": sum(t for name, (t, _) in kernels.items()
                     if forward(name, "flash")),
           "B3": sum(t for name, (t, _) in kernels.items()
                     if forward(name, "ssd_"))}
    print(f"[train] step {label} taken apart: device {dev_ms:.3f} ms (sum of "
          f"kernels under the profiler) against the unprofiled {step_ms:.3f} "
          f"ms best step, idle share {max(0.0, 1 - dev_ms / step_ms):.2%}; "
          + "; ".join(
              f"{k} forwards {fwd[k]:.3f} ms ({fwd[k] / step_ms:.2%}), {k}'s "
              f"backward {bwd[k]:.3f} ms over {len(spans[k])} calls, each "
              f"one launch of its backward kernels ({bwd[k] / ms:.2%} of "
              f"that step's {ms:.3f} ms)"
              for k in spans if spans[k] or fwd[k])
          + " (CUDA events around each call of the Function's backward)")
    return box["out"], {"device_ms": dev_ms, "idle_share":
                        max(0.0, 1 - dev_ms / step_ms),
                        "b2_forward_ms": fwd["B2"], "b2_backward_ms": bwd["B2"],
                        "b3_forward_ms": fwd["B3"], "b3_backward_ms": bwd["B3"],
                        "b2_backward_calls": len(spans["B2"]),
                        "b3_backward_calls": len(spans["B3"]),
                        "bracketed_step_ms": ms}


def depth_label(cfg) -> str:
    """The layers of ``cfg``: the encoder's and the decoder's for the
    enc-dec family."""
    if cfg.n_encoder_layers:
        return f"{cfg.n_encoder_layers} + {cfg.n_layers}"
    return str(cfg.n_layers)


def train_placement(label: str, cfg, host_params, batch, opt_cfg,
                    tiering: TieringConfig, remat: str, base: dict | None,
                    smi: str, profile: bool = False,
                    step_kw: dict | None = None,
                    timed: int = BEST_OF) -> dict:
    """One train step from ``host_params`` (zero moments) and ``batch``
    under ``tiering`` and ``remat`` (and ``step_kw``, more of
    :class:`TrainStepConfig`: ``microbatches``, ``compression``, whose
    error-feedback buffer of zeros then joins the state and the plan): the
    loss, every gradient (and with compression each after the error
    feedback), every updated parameter, moment (an int8 one's codes and
    scales) and error-feedback leaf bit-equal to ``base``'s (the first
    placement's :func:`fingerprints`, returned when ``base`` is None),
    compared on the card; the bytes the forward saved for the backward;
    then 1 + ``timed`` more steps, the best of the last ``timed`` kept
    (and with ``profile``, :func:`profile_step`)."""
    tag = f"{label} ({cfg.name}, {depth_label(cfg)} layers)"
    params = map_leaves(lambda _k, t: t.to("cuda"), host_params)
    opt = adamw.init(opt_cfg, params)
    step_cfg = TrainStepConfig.from_tiering(tiering, remat=remat,
                                            **(step_kw or {}))
    compressed = step_cfg.compression.enabled
    if compressed:
        opt["ef"] = init_error_feedback(params)
    params, opt, plan = place_state(params, opt, tiering)
    n_q = sum(isinstance(t, QTensor) for mom in ("m", "v")
              for _, t in adamw.leaves(opt[mom]))
    streamed = sorted(n for n in plan.remote_names()
                      if re.match(r"params\['(\w+_)?layers'\]", n)
                      ) if plan else []
    layer_bytes = sum(t[0].nbytes for k, t in _leaves_with_keys(params)
                      if "params" + k in streamed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    (loss, _, grads), at_bwd = saved_by_forward(
        lambda: make_value_and_grad(cfg, step_cfg, plan=plan)(params, batch),
        get_model(cfg), step_cfg.microbatches)
    saved = at_bwd - before
    first = base is None
    if first:
        base = {}

    def hold(part: str, leaves) -> None:
        """``leaves`` (pairs of key and tensor, each fingerprinted as it
        comes) into ``base`` (the first placement) or held bit-equal to
        it."""
        got = {k: fingerprint(t) for k, t in leaves}
        if first:
            base[part] = got
            return
        require(got.keys() == base[part].keys(),
                f"[train] {tag}: the {part}' leaves differ")
        for k, fp in got.items():
            require(fp == base[part][k],
                    f"[train] {tag}: {part}{k} != the first placement's "
                    f"(fingerprints {fp} and {base[part][k]})")

    # the gradients go before the step, out of its peak
    hold("loss", [("", loss)])
    hold("grads", grads.items())
    if compressed:  # the first step's error feedback: a residual of zeros
        hold("grads after error feedback", (
            (k, error_feedback_leaf(g, torch.zeros(g.shape, device="cuda"),
                                    step_cfg.compression.block)[0])
            for k, g in grads.items()))
    del grads
    step = make_train_step(cfg, step_cfg, opt_cfg, plan=plan)
    zero_counts()
    params, opt, metrics = step(params, opt, batch)
    torch.cuda.synchronize()
    launches = {**counts(), "wgmma": fa.VARIANT_LAUNCHES["wgmma"]}
    hold("step_loss", [("", metrics["loss"])])
    hold("params", _leaves_with_keys(params))
    hold("opt", _leaves_with_keys(opt))
    first_peak = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    runs = []
    for _ in range(1 + timed):  # the first is the warm-up
        (params, opt, metrics), ms, host_ms = timed_ms(
            lambda: step(params, opt, batch))
        runs.append((ms, host_ms))
    require(bool(torch.isfinite(metrics["loss"])),
            f"[train] {tag}: non-finite loss")
    best, best_host = min(runs[1:])
    local = plan.local_bytes if plan else n_bytes(params) + n_bytes(opt)
    remote = plan.remote_bytes if plan else 0
    ef_remote = sum(t.nbytes for _, t in _leaves_with_keys(opt["ef"])
                    if t.device.type == "cpu") if compressed else 0
    peak = torch.cuda.max_memory_allocated() / 2**30
    what = "best of {}".format(timed) if timed > 1 else "one step"
    print(f"[train] step {tag}: {what} {best:.3f} ms "
          f"({best_host:.3f} ms on the host before the synchronise; runs "
          f"{', '.join(f'{m:.3f}' for m, _ in runs)}), local "
          f"{local / 2**30:.3f} GiB, remote {remote / 2**30:.3f} GiB"
          + (f" (streamed by the layer loop: {', '.join(streamed)})"
             if streamed else "")
          + (f", {n_q} int8 moment leaves" if n_q else "")
          + (f", error-feedback buffer {ef_remote / 2**30:.3f} GiB remote"
             if compressed else "")
          + f", peak {peak:.3f} GiB ({first_peak:.3f} over the first "
          f"forward, backward and step), saved by the forward "
          f"{saved / 2**30:.3f} GiB, B2 launches a step "
          f"{launches['flash_attention']}, B3 {launches['ssd_scan']}, loss "
          f"{loss.item():.6f}"
          + ("" if first else
             ", loss, grads, params and moments"
             + (", the error-feedback buffer and the gradients after it"
                if compressed else "")
             + " bit-equal to the first placement's (fingerprints)")
          + f"; {smi}")
    prof = None
    if profile:
        state = [params, opt]
        del params, opt
        (params, opt, metrics), prof = profile_step(tag, step, state, batch,
                                                    best)
    del params, opt, metrics
    torch.cuda.empty_cache()
    return {"base": base, "ms": best, "host_ms": best_host,
            "peak_gib": peak, "saved_bytes": saved, "local_bytes": local,
            "remote_bytes": remote, "streamed": streamed,
            "layer_bytes": layer_bytes, "int8_leaves": n_q,
            "launches": launches, "profile": prof}


def train_leg(cfg, placements: dict, batch, opt_cfg, smi: str,
              profile: str | None = None, step_kw: dict | None = None,
              timed: int = BEST_OF) -> dict:
    """:func:`train_placement` for each of ``placements`` from the same
    random parameters (drawn on the card from seed 0, kept on the host),
    all held to the first; ``profile`` names the placement to profile."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    host_params = map_leaves(lambda _k, t: t.cpu(),
                             get_model(cfg).init_params(gen, cfg))
    n_params = sum(t.numel() for _, t in _leaves_with_keys(host_params))
    depth = (depth_label(cfg) if cfg.n_encoder_layers else
             f"{cfg.n_layers} of {get_config(cfg.name).n_layers}")
    frames = (f", frames {tuple(batch['frames'].shape)}" if "frames" in batch
              else "")
    print(f"[train] {cfg.name} at full width, {depth} layers: "
          f"{n_params / 1e9:.3f} B parameters, tokens "
          f"{tuple(batch['tokens'].shape)}{frames}, {cfg.dtype}, AdamW "
          f"{opt_cfg.moment_style} moments"
          + "".join(f", {k} {v}" for k, v in (step_kw or {}).items()))
    rows, base = {}, None
    for label, (tiering, remat) in placements.items():
        rows[label] = train_placement(label, cfg, host_params, batch,
                                      opt_cfg, tiering, remat, base, smi,
                                      profile=label == profile,
                                      step_kw=step_kw, timed=timed)
        base = rows[label].pop("base")
    del base, host_params
    release_memory()
    return rows


def check_nesting(cfg, rows: dict) -> None:
    """What the forward saves at the depth where remat "full" nests: with
    the inner checkpoints freed when their block's forward ends, the flat
    per-layer checkpoints save ``n_layers - n_outer`` more layer carries
    than the blocks; with the dual buffer inside the blocks, host_offload
    saves less than one layer's streamed weights more than untiered (no
    fetched tensor is saved across the forward); the streamed run moved
    layer weights at all."""
    n_outer, n_inner = _block_split(cfg.n_layers)
    carry = TRAIN["batch"] * TRAIN["seq"] * cfg.d_model * 2  # bf16
    flat_more = (rows["remat full_flat"]["saved_bytes"]
                 - rows["untiered"]["saved_bytes"])
    want = (cfg.n_layers - n_outer) * carry
    require(flat_more >= want / 2,
            f"[train] flat checkpoints save {flat_more} B more than "
            f"{n_outer} blocks of {n_inner}, expected {want} B: the inner "
            f"checkpoints keep what they saved")
    print(f"[train] nesting at {cfg.n_layers} layers ({n_outer} blocks of "
          f"{n_inner}): full_flat saves {flat_more / 2**20:.1f} MiB more "
          f"than full, {cfg.n_layers - n_outer} carries of "
          f"{carry / 2**20:.1f} MiB are {want / 2**20:.1f} MiB; remat none "
          f"saves {rows['remat none']['saved_bytes'] / 2**30:.3f} GiB, "
          f"full {rows['untiered']['saved_bytes'] / 2**30:.3f} GiB")
    for label in ("host_offload 0.2", "host_offload 0.2 prefetch off"):
        row = rows[label]
        require(bool(row["streamed"]),
                f"[train] {label}: the plan streams no layer weight")
        more = row["saved_bytes"] - rows["untiered"]["saved_bytes"]
        require(more < row["layer_bytes"],
                f"[train] {label}: the forward saves {more} B more than "
                f"untiered, a layer streams {row['layer_bytes']} B")
        print(f"[train] {label}: the forward saves {more / 2**20:.1f} MiB "
              f"more than untiered; a layer streams "
              f"{row['layer_bytes'] / 2**20:.1f} MiB, "
              f"{cfg.n_layers * row['layer_bytes'] / 2**30:.3f} GiB a pass")


def layers_run_in_a_step(n_layers: int, remat: str = "full") -> list[int]:
    """The layer indices a train step runs, in order: the forward; under a
    checkpoint policy (``full``, ``dots``, ``dots_no_batch``: B2 and B3 are
    no matrix product, so ``dots`` recomputes them as ``full`` does) with
    nested checkpoints (``min_layers`` 12 and above: ``_block_split``'s
    blocks) each block's recompute, which stops before its last layer (a
    recompute stops once it has what the backward needs); and each layer's
    own recompute. 33 at 12 layers, as granite-8b's 12-layer step
    measured; 2 x ``n_layers`` below 12 or with a ``_flat`` policy;
    ``n_layers`` with remat ``none``."""
    if remat == "none":
        return list(range(n_layers))
    n_outer, n_inner = ((n_layers, 1) if n_layers < 12
                        or remat.endswith("_flat")
                        else _block_split(n_layers))
    outer = [b * n_inner + j for b in range(n_outer)
             for j in range(n_inner - 1)]
    return [*range(n_layers), *outer, *range(n_layers)]


def step_launches(cfg, remat: str = "full", microbatches: int = 1) -> dict:
    """B2 and B3 launches a train step of ``cfg`` makes under ``remat``
    over ``microbatches`` (each runs its own forward and backward)
    (:func:`layers_run_in_a_step` over each layer loop: the MoE family's
    dense layers and its MoE layers are two), and B2's backward launches:
    an SSM layer one B3, the hybrid's shared block one B2 after every
    ``hybrid_attn_every`` layers, a dense, MoE or encoder layer one B2, a
    decoder layer two; deepseek-v3's MTP block one B2 (outside the layer
    loops: run once, not recomputed). B2's backward runs once for each B2
    of the forward alone, its recomputes add none."""
    def run(n: int) -> list[int]:
        return layers_run_in_a_step(n, remat)

    def times(counts: dict) -> dict:
        return {k: v * microbatches for k, v in counts.items()}

    if cfg.family == "encdec":
        return times({"flash_attention": len(run(cfg.n_encoder_layers))
                      + 2 * len(run(cfg.n_layers)),
                      "flash_attention_bwd": cfg.n_encoder_layers
                      + 2 * cfg.n_layers, "ssd_scan": 0})
    if cfg.family in ("ssm", "hybrid"):
        every = cfg.hybrid_attn_every

        def shared(layers) -> int:
            return sum(1 for i in layers if every and (i + 1) % every == 0)
        return times({"flash_attention": shared(run(cfg.n_layers)),
                      "flash_attention_bwd": shared(range(cfg.n_layers)),
                      "ssd_scan": len(run(cfg.n_layers))})
    loops = ((cfg.first_k_dense, cfg.n_layers - cfg.first_k_dense)
             if cfg.family == "moe" else (cfg.n_layers,))
    mtp = 1 if cfg.mtp_depth else 0
    return times({"flash_attention": sum(len(run(n)) for n in loops) + mtp,
                  "flash_attention_bwd": cfg.n_layers + mtp, "ssd_scan": 0})


def b3_grad_ratio(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """``|got - want|`` over B3's backward bound, per element:
    ``kernels.ref.ssd_grad_ratio`` at the forward's ``SSD_TOL``."""
    return ssd_grad_ratio(got, want, SSD_TOL)


def check_b3_vjp(label: str, dims: dict, timed: bool = True) -> dict:
    """B3 under autograd at one layer's scan in a train step (``dims``):
    the Function's (``ssd_chunk_scan_gpu`` of grad-requiring inputs: the
    kernels forward and backward) gradients of all five inputs, given a
    fixed dy, against plain autograd's through ``ssd_staged_plain`` (the
    backward kernels' plain version) at the same inputs, each within
    :func:`b3_grad_ratio`'s bound (the worst element's share printed);
    its y within ``SSD_TOL`` of the plain scan's; two launches of the
    backward kernels ``torch.equal``; a planted fault (the kernels' dx
    without one chunk's carry term ``w_j D B_j``) rejected by the same
    check. ``timed``: the backward kernels (``_launch_bwd``) timed beside
    their bound (:func:`repro_torch.kernels.work.ssd_bwd_work` at the
    3xTF32 rate, and at the CUDA cores' float32) and the plain VJP (its
    forward recomputed, as the CPU path runs it), and each of their
    launches under ``torch.profiler``."""
    rng = np.random.default_rng(13)
    chunks = ssd_chunks(rng, **dims)
    dy = torch.randn(chunks[0].shape, generator=torch.Generator(
        device="cuda").manual_seed(14), device="cuda")
    shape = " ".join(f"{k}{v}" for k, v in dims.items()) + " float32"

    def grads(fn):
        ins = [t.detach().clone().requires_grad_(True) for t in chunks]
        y = fn(*ins)
        return y, torch.autograd.grad(y, ins, dy)

    before = ssd.BWD_LAUNCHES
    y, got = grads(ssd.ssd_chunk_scan_gpu)
    require(ssd.BWD_LAUNCHES == before + 1,
            f"B3 VJP at {label}: the Function's backward launched "
            f"{ssd.BWD_LAUNCHES - before} backward kernels, expected 1")
    y_p, want = grads(ssd.ssd_staged_plain)
    err = max_err(y, y_p, SSD_TOL, f"B3 Function forward at {label}'s train "
                                   f"scan {shape} against the plain scan")
    names = ("xc", "bc", "cc", "dtc", "cum")
    share = {}
    for name, g, w in zip(names, got, want):
        require(bool(torch.isfinite(g).all()),
                f"B3 VJP at {label}: d{name} is not finite")
        share[name] = b3_grad_ratio(g, w).max().item()
        require(share[name] <= 1.0,
                f"B3 backward kernels at {label}: d{name} beyond the bound "
                f"(worst element at {share[name]:.3f} of it)")
    first = ssd._launch_bwd(*chunks, dy)
    same = all(torch.equal(a, b) for a, b in zip(first, ssd._launch_bwd(
        *chunks, dy)))
    require(same, f"B3 backward kernels at {label}: two launches on the same "
                  f"inputs differ")
    del first
    grad_err = max((g - w).abs().max().item() for g, w in zip(got, want))
    print(f"[check] B3 backward kernels at {label}'s train scan {shape}: "
          f"the Function's gradients of {', '.join(names)} against plain "
          f"autograd's through ssd_staged_plain, worst element's share of "
          f"the bound " + ", ".join(f"d{k} {v:.3f}" for k, v in share.items())
          + f"; max|g - want| {grad_err:.4g} (max|want| "
          + ", ".join(f"{w.abs().max().item():.4g}" for w in want) + ")")
    # the planted fault: the kernels' dx less chunk `drop`'s carry term
    # (a chunk with a successor: the last chunk's dS_loc is zero)
    xc, bc, cc, dtc, cum = chunks
    require(xc.shape[2] >= 2, f"B3 VJP at {label}: one chunk has no carry "
                              f"to drop")
    drop = min(xc.shape[2] // 2, xc.shape[2] - 2)
    ds_in = torch.einsum("bhcip,bhcin->bhcpn", dy * torch.exp(cum)[..., None],
                         cc)
    ds_loc = ssd.ssd_state_passing_bwd_plain(ds_in, cum)[:, :, drop]
    c_cum = cum[:, :, drop]
    w = torch.exp(c_cum[..., -1:] - c_cum) * dtc[:, :, drop]
    faulty = got[0].clone()
    faulty[:, :, drop] -= w[..., None] * torch.einsum(
        "bhjn,bhpn->bhjp", bc[:, :, drop], ds_loc)
    bad = int((~(b3_grad_ratio(faulty, want[0]) <= 1.0)).sum())
    require(bad > 0, "the bound passes a planted fault: the backward "
                     f"kernels' dx without chunk {drop}'s carry term")
    print(f"[fault] B3 backward kernels' dx without chunk {drop}'s carry term "
          f"at {label}: {bad} of {faulty.numel()} elements beyond the bound, "
          f"rejected")
    del faulty, y, y_p, ds_in, ds_loc
    out = {"max_abs_err": grad_err, "share_of_bound": share,
           "forward_max_abs_err": err, "deterministic": same, "shape": shape}
    if not timed:
        torch.cuda.synchronize()
        return out
    ins = [t.detach().clone().requires_grad_(True) for t in chunks]
    flops, nbytes = work.ssd_bwd_work(*xc.shape, bc.shape[-1])
    b_tf32, by = bound(TF32_PASSES * flops, nbytes, PEAK_FLOPS["tf32"])
    b_f32, _ = bound(flops, nbytes, PEAK_FLOPS[torch.float32])
    ms = time_ms(lambda: ssd._launch_bwd(*chunks, dy), 10)
    plain_ms = time_ms(lambda: torch.autograd.grad(
        ssd.ssd_staged_plain(*ins), ins, dy), 3)
    per = launch_times(lambda: ssd._launch_bwd(*chunks, dy))
    print(f"[time] B3 backward kernels at {label}'s train scan {shape}: "
          f"{ms:.4f} ms; bound {b_tf32:.4f} ms ({by}, at 3xTF32), "
          f"{b_f32:.4f} ms at the CUDA cores' float32; the plain staged VJP "
          f"{plain_ms:.4f} ms; library none")
    print(f"[time] B3 backward kernels at {label}'s train scan, each kernel "
          f"(torch.profiler, ms a launch and launches a call): " + ("; ".join(
              f"{kernel_name(name)} {t:.4f} x{n:g}"
              for name, (t, n) in per.items())
              or "the profiler recorded no device time in 3 tries"))
    torch.cuda.synchronize()
    return {**out, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_tf32,
            "bound_by": by, "bound_f32_ms": b_f32, "library_ms": None,
            "launch_ms": {kernel_name(name): t for name, (t, _) in per.items()}}


def check_learning(cfg, data) -> None:
    """``TRAIN_LEARN``'s steps of ``train.loop.train`` on ``data``'s step-0
    batch repeated: the mean of the last 3 losses below the first 3's."""
    learn = train(cfg, TrainStepConfig(), AdamWConfig(
        lr=TRAIN_LEARN["lr"], warmup_steps=0),
        LoopConfig(steps=TRAIN_LEARN["steps"], batch=data.batch,
                   seq=data.seq, log_every=5), device="cuda",
        dataset=RepeatedBatch(data))
    first, last = np.mean(learn.losses[:3]), np.mean(learn.losses[-3:])
    require(last < first, f"[train] {cfg.name}: no learning: {first} -> "
                          f"{last}")
    print(f"[train] {TRAIN_LEARN['steps']} steps of train.loop.train of "
          f"{cfg.name} ({cfg.n_layers} layers) on a repeated batch: losses "
          f"{[round(x, 4) for x in learn.losses]}; mean of the first 3 "
          f"{first:.4f}, of the last 3 {last:.4f}; step ms median "
          f"{1e3 * float(np.median(learn.step_times)):.1f}")
    torch.cuda.empty_cache()


def train_model(name: str, spec: dict, opt_cfg, smi: str) -> dict:
    """One of ``TRAIN_MODELS`` (``spec``: its depth cut, batch and tokens)
    through :func:`train_leg` under ``TRAIN_MODEL_PLACEMENTS``, the
    untiered step profiled; B2 and B3 launches a step and backward calls as
    :func:`step_launches` counts them; for mamba2-130m also
    :func:`check_learning`. Returns the leg's rows."""
    mcfg = dataclasses.replace(get_config(name), **{
        k: v for k, v in spec.items() if k in ("n_layers", "first_k_dense")})
    mdata = SyntheticTokenDataset(mcfg, spec.get("batch", TRAIN["batch"]),
                                  spec["seq"], seed=0)
    if mcfg.sliding_window:
        require(mcfg.sliding_window < spec["seq"],
                f"[train] {name}: the window cuts no pair")
    mrows = train_leg(mcfg, TRAIN_MODEL_PLACEMENTS, to_device_fn(
        "cuda", mcfg.dtype)(mdata.batch_at(0)), opt_cfg, smi,
        profile="untiered")
    got = mrows["untiered"]["launches"]
    want = step_launches(mcfg)
    require({k: got[k] for k in want} == want,
            f"[train] {name}: launches a step {got}, expected {want}")
    print(f"[train] {name}: launches a step {want} as counted (forward, "
          f"each nested block's recompute up to its last layer, each "
          f"layer's recompute; B2's backward once a B2 of the forward)")
    # one backward call per SSM layer, however often its forward ran; one
    # of B2's per attention of the forward
    prof = mrows["untiered"]["profile"]
    ssm_layers = mcfg.n_layers if want["ssd_scan"] else 0
    require(prof["b3_backward_calls"] == ssm_layers
            and prof["b2_backward_calls"] == want["flash_attention_bwd"],
            f"[train] {name}: B3's and B2's backward ran "
            f"{prof['b3_backward_calls']} and {prof['b2_backward_calls']} "
            f"times in the profiled step, expected {ssm_layers} (one per SSM "
            f"layer) and {want['flash_attention_bwd']}")
    if name == "mamba2-130m":
        check_learning(mcfg, mdata)
    release_memory()
    return mrows


def train_ladder(cfg, batch, f32_rows: dict, smi: str) -> dict:
    """``TRAIN_LADDER``'s legs on granite-8b (``cfg``, ``batch``: the f32
    leg's), each through :func:`train_leg` untiered and at host_offload
    0.5 under its policy, bit-equal; B2 launches a step as
    :func:`step_launches` counts them under that policy and microbatches,
    all through wgmma; the int8 leg holds int8 moment leaves. Each leg's
    step ms and peak printed beside the f32 leg's (``f32_rows``)."""
    out = {}
    for name, spec in TRAIN_LADDER.items():
        opt_cfg = AdamWConfig(lr=TRAIN_LEARN["lr"], warmup_steps=0,
                              moment_style=spec["moment_style"])
        placements = {
            f"{name} untiered": (TieringConfig(), spec["remat"]),
            f"{name} host_offload 0.5": (TieringConfig(
                mode="host_offload", local_fraction=0.5), spec["remat"])}
        rows = train_leg(cfg, placements, batch, opt_cfg, smi,
                         step_kw=spec["step_kw"], timed=1)
        n_mb = spec["step_kw"].get("microbatches", 1)
        want = step_launches(cfg, spec["remat"], n_mb)
        for label, row in rows.items():
            got = row["launches"]
            require({k: got[k] for k in want} == want
                    and got["wgmma"] == want["flash_attention"],
                    f"[train] {label}: launches a step {got}, expected "
                    f"{want}, all B2 through wgmma")
            require(spec["moment_style"] != "int8" or row["int8_leaves"] > 0,
                    f"[train] {label}: no int8 moment leaf")
        base = f32_rows["untiered"]
        print(f"[train] {name} ({spec['moment_style']} moments, remat "
              f"{spec['remat']}"
              + "".join(f", {k} {v}" for k, v in spec["step_kw"].items())
              + f"): step ms untiered {rows[f'{name} untiered']['ms']:.3f}, "
              f"at 0.5 {rows[f'{name} host_offload 0.5']['ms']:.3f} (the "
              f"f32 leg's {base['ms']:.3f} and "
              f"{f32_rows['host_offload 0.5']['ms']:.3f}); peak "
              f"{rows[f'{name} untiered']['peak_gib']:.3f} and "
              f"{rows[f'{name} host_offload 0.5']['peak_gib']:.3f} GiB (f32 "
              f"{base['peak_gib']:.3f} and "
              f"{f32_rows['host_offload 0.5']['peak_gib']:.3f}); local / "
              f"remote "
              + ", ".join(f"{r['local_bytes'] / 2**30:.3f} / "
                          f"{r['remote_bytes'] / 2**30:.3f} GiB"
                          for r in rows.values())
              + f"; launches a step {want} as counted "
              f"({n_mb} microbatch{'es' if n_mb > 1 else ''}, "
              f"{spec['remat']} recomputes the attention as full does); "
              f"{smi}")
        out[name] = rows
    return out


def check_int8_update(cfg, smi: str) -> dict:
    """``adamw.leaf_update`` at int8 moments on one full-width granite MLP
    leaf (one layer's w_up, d_model x d_ff, in float32, the update's math
    type, so that the parameters' bound means float32's precision; a bf16
    gradient; moments as one earlier step's gradient left them, int8
    codes), on the card and on the CPU from the same host inputs and step
    scalars: the codes within 1, the scales and the new parameters within
    1e-6 of each one's max |x|; the count of elements that are not
    bit-equal printed."""
    gen = torch.Generator().manual_seed(21)
    shape = (cfg.d_model, cfg.d_ff)

    def draw(scale: float) -> torch.Tensor:
        return torch.randn(shape, generator=gen) * scale

    opt_cfg = AdamWConfig(lr=TRAIN_LEARN["lr"], warmup_steps=0,
                          moment_style="int8")
    p = draw(0.02)
    g = draw(1e-3).to(cfg.dtype)
    g0 = draw(1e-3)
    m = quantize_blocks((1 - opt_cfg.b1) * g0)
    v = quantize_blocks((1 - opt_cfg.b2) * g0 * g0)
    s = adamw.step_scalars(opt_cfg, torch.tensor(2, dtype=torch.int32),
                           torch.tensor(0.5))

    def to(dev, x):
        if isinstance(x, QTensor):
            return QTensor(x.codes.to(dev), x.scale.to(dev))
        return x.to(dev)

    want = adamw.leaf_update(opt_cfg, p, g, m, v, s)
    got = adamw.leaf_update(opt_cfg, *(to("cuda", x) for x in (p, g, m, v)),
                            {k: x.cuda() for k, x in s.items()})
    out = {}
    for name, w, x in (("p", want[0], got[0]),
                       ("m codes", want[1].codes, got[1].codes),
                       ("m scales", want[1].scale, got[1].scale),
                       ("v codes", want[2].codes, got[2].codes),
                       ("v scales", want[2].scale, got[2].scale)):
        x = x.cpu()
        diff = (x.float() - w.float()).abs().max().item()
        tol = 1.0 if "codes" in name else 1e-6 * w.float().abs().max().item()
        unequal = int((x.view(WORDS[x.element_size()])
                       != w.view(WORDS[w.element_size()])).sum())
        require(diff <= tol, f"[check] int8 AdamW update on the card: {name} "
                             f"max|card - CPU| {diff} above {tol}")
        out[name] = {"max_abs_diff": diff, "bound": tol, "unequal": unequal}
    print(f"[check] int8 AdamW update (adamw.leaf_update) of one granite-8b "
          f"MLP leaf {shape} in float32 ({cfg.dtype} gradient), card against "
          f"CPU from the same host inputs: "
          + "; ".join(f"{k} max|diff| {r['max_abs_diff']:.3g} (bound "
                      f"{r['bound']:.3g}), {r['unequal']} of "
                      f"{math.prod(shape) // (1 if 'scale' not in k else 256)}"
                      f" elements not bit-equal" for k, r in out.items())
          + f"; {smi}")
    return out


def moe_layer_reckoning(cfg, opt_cfg) -> dict:
    """The bytes of :data:`TRAIN_MOE_LAYER`'s state by kind, from the
    parameters' shapes (a fake-tensor init): parameters and gradients (the
    leaf's type: ``RemoteGrads`` keeps it), int8 codes and scales and the
    float32 moments of the leaves too small or narrow for codes (two
    moments each), the MoE layer's weights (fetched whole for its forward
    and again for its recompute); the pinned host bytes of it all, and as
    PyTorch's caching host allocator holds them (each block rounded up to
    a power of two)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        shapes = [(k, tuple(t.shape), t.dtype) for k, t in _leaves_with_keys(
            get_model(cfg).init_params(torch.Generator().manual_seed(0), cfg,
                                       device="cpu"))]
    r = dict.fromkeys(("params", "codes", "scales", "f32_moments",
                       "fetched_layer", "pinned_rounded"), 0)

    def pinned(n: int) -> int:
        return 1 << max(0, n - 1).bit_length()

    for k, shape, dtype in shapes:
        n = math.prod(shape)
        nb = n * torch.empty((), dtype=dtype).element_size()
        r["params"] += nb
        r["pinned_rounded"] += pinned(nb)
        if k.startswith("['layers']"):
            r["fetched_layer"] += nb
        if opt_cfg.moment_style == "int8" and quantizable(shape):
            r["codes"] += 2 * n
            r["scales"] += 2 * 4 * (n // 256)
            r["pinned_rounded"] += 2 * (pinned(n) + pinned(4 * (n // 256)))
        else:
            r["f32_moments"] += 2 * 4 * n
            r["pinned_rounded"] += 2 * pinned(4 * n)
    r["grads"] = r["params"]
    r["pinned"] = r["params"] + r["codes"] + r["scales"] + r["f32_moments"]
    r["device"] = r["grads"] + r["fetched_layer"]
    return r


def host_pinned_bytes() -> dict:
    """What PyTorch's host allocator holds now: ``host_memory_stats``'
    current allocated and reserved bytes, where this torch has them."""
    stats = getattr(torch.cuda, "host_memory_stats", None)
    if stats is None:
        return {}
    return {k: v for k, v in stats().items()
            if k in ("allocated_bytes.current", "reserved_bytes.current")}


class copy_stream_bytes:
    """While open, every ``HostFetchEngine`` the train step makes is
    recorded: ``moved()`` is the bytes they read (host to card) and wrote
    (card to host) on their copy streams."""

    def __enter__(self):
        self.engines = []
        self.saved = step_mod.HostFetchEngine
        engines = self.engines

        class Recorded(self.saved):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                engines.append(self)

        step_mod.HostFetchEngine = Recorded
        return self

    def __exit__(self, *exc):
        step_mod.HostFetchEngine = self.saved
        return False

    def moved(self) -> tuple[int, int]:
        return (sum(e.bytes_read for e in self.engines),
                sum(e.bytes_written for e in self.engines))


def moe_layer_leg(cfg, batch, opt_cfg, prefetch: bool, smi: str,
                  before: dict | None) -> dict:
    """One step of :data:`TRAIN_MOE_LAYER`'s model at host_offload 0.0
    with ``prefetch``: the parameters drawn on the card from seed 0, the
    moments int8 zeros, all placed (the REMOTE leaves into pinned host
    memory). Returns the fingerprints of the state before the step (when
    ``before`` is None, else requires them equal to it), of the loss,
    every gradient (taken inside the step, before the update) and every
    updated parameter, code and scale, with the step's ms, device peak,
    pinned host bytes and copy-stream bytes."""
    label = f"MoE layer prefetch {'on' if prefetch else 'off'}"
    tiering = TieringConfig(mode="host_offload", local_fraction=0.0,
                            prefetch=prefetch)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = get_model(cfg).init_params(gen, cfg)
    opt = adamw.init(opt_cfg, params)
    params, opt, plan = place_state(params, opt, tiering)
    torch.cuda.empty_cache()
    on_host = sum(t.nbytes for _, t in _leaves_with_keys((params, opt))
                  if t.device.type == "cpu")
    n_q = sum(isinstance(t, QTensor) for mom in ("m", "v")
              for _, t in adamw.leaves(opt[mom]))
    require(n_q > 0, f"[train] {label}: no int8 moment leaf")
    start = fingerprints({"params": params, "opt": opt})
    if before is not None:
        require(start == before, f"[train] {label}: the placed state differs "
                                 f"from the first leg's")
    step_cfg = TrainStepConfig.from_tiering(tiering, remat="full")
    seen = {}
    value_and_grad = step_mod.make_value_and_grad

    def fingerprinted(*a, **kw):
        """make_value_and_grad whose gradients are fingerprinted as they
        come (their time kept apart from the step's)."""
        inner = value_and_grad(*a, **kw)

        def run(p, b, engine=None):
            loss, metrics, grads = inner(p, b, engine)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            seen["loss"] = {"": fingerprint(loss)}
            seen["grads"] = {k: fingerprint(g) for k, g in grads.items()}
            seen["fingerprint_s"] = time.perf_counter() - t0
            return loss, metrics, grads
        return run

    step_mod.make_value_and_grad = fingerprinted
    try:
        step = make_train_step(cfg, step_cfg, opt_cfg, plan=plan)
    finally:
        step_mod.make_value_and_grad = value_and_grad
    zero_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with copy_stream_bytes() as moved:
        (params, opt, metrics), ms, host_ms = timed_ms(
            lambda: step(params, opt, batch))
    launches = {**counts(), "wgmma": fa.VARIANT_LAUNCHES["wgmma"]}
    peak = torch.cuda.max_memory_allocated()
    loss = metrics["loss"].item()
    require(math.isfinite(loss), f"[train] {label}: non-finite loss {loss}")
    after = fingerprints({"params": params, "opt": opt})
    same = sorted(k for k, fp in after.items() if fp == start.get(k))
    require(not same, f"[train] {label}: {len(same)} leaves unchanged by the "
                      f"step, e.g. {same[:4]}")
    pinned = host_pinned_bytes()
    read, written = moved.moved()
    step_ms = ms - 1e3 * seen["fingerprint_s"]
    print(f"[train] step {label} ({cfg.name}, {depth_label(cfg)} layers, "
          f"host_offload 0.0, int8 moments, remat full): {step_ms:.3f} ms "
          f"({ms:.3f} with the gradients' fingerprints, "
          f"{1e3 * seen['fingerprint_s']:.3f} ms of it; {host_ms:.3f} ms on "
          f"the host before the synchronise), device peak "
          f"{peak / 2**30:.3f} GiB ({peak / 1e9:.3f} GB), in host memory "
          f"{on_host / 1e9:.3f} GB of leaves (the plan's remote "
          f"{plan.remote_bytes / 1e9:.3f} GB), the host allocator "
          + (", ".join(f"{k} {v / 1e9:.3f} GB" for k, v in pinned.items())
             or "reports no stats here")
          + f"; copy stream {read / 1e9:.3f} GB to the card, "
          f"{written / 1e9:.3f} GB back; {n_q} int8 moment leaves; B2 "
          f"launches {launches['flash_attention']} ({launches['wgmma']} "
          f"wgmma), its backward {launches['flash_attention_bwd']}; loss "
          f"{loss:.6f}; every parameter, moment, code and scale changed; "
          f"host MemAvailable {mem_available_gb():.1f} GB; {smi}")
    del params, opt, metrics
    return {"start": start, "after": after, "seen": seen, "ms": step_ms,
            "peak_bytes": peak, "on_host_bytes": on_host, "pinned": pinned,
            "read_bytes": read, "written_bytes": written,
            "launches": launches, "loss": loss}


def train_moe_layer(smi: str) -> dict:
    """deepseek-v3's MoE layer trained on the card (:data:`TRAIN_MOE_LAYER`):
    the reckoned bytes and the host's MemAvailable first (the phase fails
    if the host cannot hold the pinned state), then :func:`moe_layer_leg`
    with prefetch on and off, every leaf's fingerprint equal between them,
    B2 launches a step as :func:`step_launches` counts them, all wgmma (at
    MLA's D 192)."""
    spec = TRAIN_MOE_LAYER
    cfg = dataclasses.replace(get_config("deepseek-v3-671b"),
                              n_layers=spec["n_layers"],
                              first_k_dense=spec["first_k_dense"])
    opt_cfg = AdamWConfig(lr=spec["lr"], warmup_steps=0, moment_style="int8")
    r = moe_layer_reckoning(cfg, opt_cfg)
    release_memory()
    avail = mem_available_gb()
    print(f"[train] {cfg.name}'s MoE layer at full width ({cfg.n_layers} "
          f"layers: {cfg.first_k_dense} dense MLA, "
          f"{cfg.n_layers - cfg.first_k_dense} MoE of {cfg.n_experts} experts "
          f"top {cfg.top_k}, the MTP block), {r['params'] / 2 / 1e9:.3f} B "
          f"parameters, tokens ({spec['batch']}, {spec['seq']}), int8 "
          f"moments, host_offload 0.0; reckoned: parameters "
          f"{r['params'] / 1e9:.3f} GB, gradients {r['grads'] / 1e9:.3f}, "
          f"codes {r['codes'] / 1e9:.3f}, scales {r['scales'] / 1e9:.3f}, "
          f"float32 moments of the small leaves "
          f"{r['f32_moments'] / 1e9:.3f}, the MoE layer fetched "
          f"{r['fetched_layer'] / 1e9:.3f}; on the card the gradients and "
          f"the fetched layer {r['device'] / 1e9:.3f} GB and a few of "
          f"activations and working set; pinned host memory "
          f"{r['pinned'] / 1e9:.3f} GB, {r['pinned_rounded'] / 1e9:.3f} as "
          f"the caching host allocator rounds its blocks; host MemAvailable "
          f"{avail:.1f} GB")
    require(avail > r["pinned_rounded"] / 1e9 + 8,
            f"[train] {cfg.name}'s MoE layer: the host has {avail:.1f} GB "
            f"available, the state pins {r['pinned_rounded'] / 1e9:.1f} GB")
    data = SyntheticTokenDataset(cfg, spec["batch"], spec["seq"], seed=0)
    batch = to_device_fn("cuda", cfg.dtype)(data.batch_at(0))
    legs = {}
    for prefetch in (True, False):
        legs[prefetch] = moe_layer_leg(
            cfg, batch, opt_cfg, prefetch, smi,
            legs[True]["start"] if legs else None)
    on, off = legs[True], legs[False]
    for part in ("loss", "grads"):
        require(on["seen"][part] == off["seen"][part],
                f"[train] MoE layer: the {part} differ between prefetch on "
                f"and off")
    require(on["after"] == off["after"],
            f"[train] MoE layer: the updated state differs between prefetch "
            f"on and off: "
            f"{[k for k in on['after'] if on['after'][k] != off['after'][k]][:4]}")
    want = step_launches(cfg)
    for leg in (on, off):
        got = leg["launches"]
        require({k: got[k] for k in want} == want
                and got["wgmma"] == want["flash_attention"],
                f"[train] MoE layer: launches a step {got}, expected {want}, "
                f"all B2 through wgmma")
    n_leaves = len(on["seen"]["grads"]) + len(on["after"])
    print(f"[train] {cfg.name}'s MoE layer: prefetch on and off bit-equal "
          f"(fingerprints) on the loss, {len(on['seen']['grads'])} gradients "
          f"and {len(on['after'])} updated leaves ({n_leaves} in all: "
          f"parameters, codes, scales, float32 moments, the step); launches "
          f"a step {want} as counted, B2 at D 192 on wgmma; step ms "
          f"{on['ms']:.3f} on, {off['ms']:.3f} off; {smi}")
    del legs, on, off, batch
    release_memory()
    return {"reckoned": r, "mem_available_gb": avail,
            "launches": want}


def launcher_runs() -> None:
    """``python -m repro_torch.launch.train --device cuda --steps 3`` in a
    process of its own (its default, reduced mamba2-130m), then
    ``launch.train.main(LAUNCH_LADDER)`` in this one, whose loss must
    fall."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t_l = time.perf_counter()
    run = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                          "--device", "cuda", "--steps", "3"], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=600)
    require(run.returncode == 0, f"[train] launch.train failed:\n"
            f"{run.stdout[-2000:]}\n{run.stderr[-2000:]}")
    require("arch=mamba2-130m" in run.stdout,
            f"[train] launch.train did not run its default, mamba2-130m:\n"
            f"{run.stdout[-2000:]}")
    print(f"[train] python -m repro_torch.launch.train --device cuda "
          f"--steps 3: {run.stdout.strip().splitlines()[-1]} "
          f"({time.perf_counter() - t_l:.1f} s with the process start)")
    embed = (MAMBA2_130M.vocab_size, MAMBA2_130M.d_model)
    require(quantizable(embed), f"[train] mamba2-130m's embedding {embed} "
                                f"takes no int8 moments")
    t_l = time.perf_counter()
    res = launch_train.main(LAUNCH_LADDER)
    require(len(res.losses) == int(LAUNCH_LADDER[
        LAUNCH_LADDER.index("--steps") + 1])
            and res.losses[-1] < res.losses[0],
            f"[train] launch.train {' '.join(LAUNCH_LADDER)}: losses "
            f"{res.losses} do not fall")
    print(f"[train] launch.train {' '.join(LAUNCH_LADDER)}: losses "
          f"{[round(x, 4) for x in res.losses]} "
          f"({time.perf_counter() - t_l:.1f} s)")
    release_memory()


def phase_train(smi: str) -> dict:
    """``[train]``: B2's lse and VJP at granite-8b's attention shape (bf16
    and float32) with planted faults, and at ``TRAIN_FLASH_MORE``'s;
    granite-8b at full width one step under each of ``TRAIN_PLACEMENTS``
    (4 layers; the untiered step profiled) and ``TRAIN_DEEP_PLACEMENTS``
    (12 layers, where remat nests: :func:`check_nesting`), each leg all
    bit-equal (:func:`fingerprint`); the int8 update on the card against
    the CPU's (:func:`check_int8_update`) and ``TRAIN_LADDER``'s legs
    (:func:`train_ladder`); B3's backward at ``B3_VJP``'s scans with a planted
    fault, two launches ``torch.equal`` and each launch's time, and at
    ``B3_VJP_RAGGED``'s shapes untimed; ``TRAIN_MODELS`` at full width one
    step under each of ``TRAIN_MODEL_PLACEMENTS``, all bit-equal, B2
    and B3 launches a step and backward calls as :func:`step_launches`
    counts them: mamba2-130m, zamba2-1.2b and seamless-m4t-medium whole,
    deepseek-v3-671b at 2 dense MLA layers and its MTP block (B2's
    backward at D 192 on the tensor cores, also held alone at
    ``TRAIN_FLASH_MORE``'s MLA shape), mixtral-8x7b at its first MoE
    layer over 8192 tokens (top-2 dispatch under autograd, B2's backward
    under its window of 4096); 10 steps of
    ``train.loop.train`` on a repeated batch must lower the loss
    (granite-8b, mamba2-130m); a run killed after its checkpoint resumes
    with equal losses, untiered and at host_offload 0.5 (the reduced
    float32 config); :func:`launcher_runs`. Returns the untiered steps'
    launches and the backward numbers of B2 and B3."""
    t0 = time.perf_counter()
    walls, last = {}, [t0]

    def lap(name: str) -> None:  # wall seconds of the part just ended
        walls[name] = time.perf_counter() - last[0]
        last[0] += walls[name]

    print(f"[train] on the card before the phase: "
          f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated")
    vjp = {dt: check_b2_vjp(dt) for dt in (torch.bfloat16, torch.float32)}
    vjp_window = check_b2_window()
    release_memory()
    lap("B2 VJP at granite-8b's shape and the window")
    cfg = dataclasses.replace(GRANITE_8B, n_layers=TRAIN["n_layers"])
    data = SyntheticTokenDataset(cfg, TRAIN["batch"], TRAIN["seq"], seed=0)
    batch = to_device_fn("cuda", cfg.dtype)(data.batch_at(0))
    opt_cfg = AdamWConfig(lr=TRAIN_LEARN["lr"], warmup_steps=0)
    rows = train_leg(cfg, TRAIN_PLACEMENTS, batch, opt_cfg, smi,
                     profile="untiered")
    require(rows["untiered"]["launches"]["flash_attention"]
            == 2 * cfg.n_layers,
            f"[train] B2 launches a step "
            f"{rows['untiered']['launches']['flash_attention']} != "
            f"{2 * cfg.n_layers} (forward and recompute of each layer)")
    require(rows["untiered"]["launches"]["flash_attention_bwd"]
            == cfg.n_layers,
            f"[train] B2's backward kernels launched "
            f"{rows['untiered']['launches']['flash_attention_bwd']} times a "
            f"step, expected {cfg.n_layers} (one a layer)")
    lap("granite-8b, 4 layers")
    int8_update = check_int8_update(cfg, smi)
    ladder = train_ladder(cfg, batch, rows, smi)
    lap("granite-8b ladder legs")
    deep = dataclasses.replace(GRANITE_8B, n_layers=TRAIN_DEEP["n_layers"])
    deep_rows = train_leg(deep, TRAIN_DEEP_PLACEMENTS, batch, opt_cfg, smi)
    check_nesting(deep, deep_rows)
    lap("granite-8b, 12 layers")
    check_learning(cfg, data)
    del batch
    lap("learning")

    vjp_more = {}
    for label, sh in TRAIN_FLASH_MORE.items():
        vjp_more[label] = {dt: check_b2_vjp(dt, sh)
                           for dt in (torch.bfloat16, torch.float32)}
        lap(f"B2 VJP at {label}'s shape")
    b3_vjp = {label: check_b3_vjp(label, dims)
              for label, dims in B3_VJP.items()}
    b3_vjp.update({label: check_b3_vjp(label, dims, timed=False)
                   for label, dims in B3_VJP_RAGGED.items()})
    release_memory()
    lap("B3 VJP")
    model_rows = {}
    for name, spec in TRAIN_MODELS.items():
        model_rows[name] = train_model(name, spec, opt_cfg, smi)
        lap(name)

    small = reduced_config(GRANITE_8B, dtype=torch.float32)
    rs = TRAIN_RESTART
    opt_small = AdamWConfig(lr=1e-3, warmup_steps=0)

    class Killed(Exception):
        pass

    def kill(step):
        if step == rs["kill_at"]:
            raise Killed()

    common = dict(steps=rs["steps"], batch=rs["batch"], seq=rs["seq"],
                  log_every=100, ckpt_every=rs["ckpt_every"])
    for label, tiering in (("untiered", TieringConfig()),
                           ("host_offload 0.5", TieringConfig(
                               mode="host_offload", local_fraction=0.5))):
        step_cfg = TrainStepConfig.from_tiering(tiering)
        ref = train(small, step_cfg, opt_small, LoopConfig(**common),
                    device="cuda")
        with tempfile.TemporaryDirectory() as tmp:
            try:
                train(small, step_cfg, opt_small,
                      LoopConfig(ckpt_dir=tmp, **common), device="cuda",
                      fault_hook=kill)
                require(False, "[train] the fault hook did not fire")
            except Killed:
                pass
            resumed = train(small, step_cfg, opt_small,
                            LoopConfig(ckpt_dir=tmp, **common),
                            device="cuda")
        require(resumed.restored_from == rs["ckpt_every"],
                f"[train] {label}: resumed from {resumed.restored_from}")
        require(resumed.losses == ref.losses[rs["ckpt_every"]:],
                f"[train] {label}: resumed losses {resumed.losses} != "
                f"{ref.losses[rs['ckpt_every']:]}")
        print(f"[train] restart {label} ({small.name} reduced, float32): "
              f"killed after step {rs['kill_at']}, resumed from the "
              f"step-{rs['ckpt_every']} checkpoint, losses == the "
              f"uninterrupted run's {[round(x, 6) for x in resumed.losses]}")

    launcher_runs()
    lap("restart and launcher")
    print(f"[train] done in {time.perf_counter() - t0:.1f} s ("
          + ", ".join(f"{k} {v:.1f}" for k, v in walls.items())
          + f" s); {smi}")
    return {"launches": rows["untiered"]["launches"], "rows": rows,
            "deep_rows": deep_rows, "vjp": vjp, "vjp_more": vjp_more,
            "vjp_window": vjp_window,
            "b3_vjp": b3_vjp, "model_rows": model_rows,
            "int8_update": int8_update, "ladder": ladder}


# -- [mesh]: the sharding layer on a one-rank NCCL mesh ----------------------
def mesh_leg(label: str, cfg, host_params, host_batch, opt_cfg,
             tiering: TieringConfig, mesh, base: dict | None,
             smi: str) -> tuple[dict, dict]:
    """One train step of ``cfg`` from ``host_params`` (zero moments) and
    ``host_batch``, under ``mesh`` (DTensor state laid out by the spec
    trees, the batch by ``device_put_fn``) or without one, placed by
    ``tiering``: the loss, every gradient, updated parameter and moment
    ``torch.equal`` to ``base`` (the first leg's, returned when ``base``
    is None), B2's launches a step (each through ``local_map`` under the
    mesh), then the best of BEST_OF more steps and the peak memory."""
    tag = f"{label} ({cfg.name}, {cfg.n_layers} layers)"
    step_cfg = TrainStepConfig.from_tiering(tiering, remat="full")
    first = base is None
    base = {} if first else base

    def hold(part: str, leaves: dict) -> None:
        leaves = {k: local_part(t).detach() for k, t in leaves.items()}
        if first:
            base[part] = {k: t.cpu() for k, t in leaves.items()}
            return
        require(leaves.keys() == base[part].keys(),
                f"[mesh] {tag}: the {part}' leaves differ")
        for k, t in leaves.items():
            require(torch.equal(t.to("cuda"), base[part][k].to("cuda")),
                    f"[mesh] {tag}: {part}{k} != the step's without a mesh")

    with shd.use_mesh(mesh):
        params = map_leaves(lambda _k, t: t.to("cuda"), host_params)
        opt = adamw.init(opt_cfg, params)
        if mesh is None:
            batch = to_device_fn("cuda", cfg.dtype)(host_batch)
        else:
            batch = device_put_fn(mesh, lambda b: shd.batch_pspec_tree(
                b, mesh), dtype=cfg.dtype)(host_batch)
            specs = shd.params_pspec_tree(
                params, expert_sharding=cfg.expert_sharding, mesh=mesh)
            params = shd.distribute_tree(params, specs, mesh)
            opt = shd.distribute_tree(
                opt, shd.opt_pspec_tree(opt, specs, mesh), mesh)
        params, opt, plan = place_state(params, opt, tiering)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        loss, _, grads = make_value_and_grad(cfg, step_cfg, plan=plan)(
            params, batch)
        hold("loss", {"": loss})
        hold("grads", grads)
        del grads
        step = make_train_step(cfg, step_cfg, opt_cfg, plan=plan)
        zero_counts()
        shd.LOCAL_MAP_CALLS.clear()
        GATHERS.clear()
        with backward_calls(f"[mesh] {tag}") as spans:
            params, opt, metrics = step(params, opt, batch)
            torch.cuda.synchronize()
        require(len(spans["B2"]) == cfg.n_layers,
                f"[mesh] {tag}: B2's backward ran {len(spans['B2'])} times, "
                f"expected {cfg.n_layers} (one a layer)")
        launches, calls = counts(), dict(shd.LOCAL_MAP_CALLS)
        gathers = dict(GATHERS)
        wgmma = fa.VARIANT_LAUNCHES["wgmma"]
        hold("step_loss", {"": metrics["loss"]})
        hold("params", dict(_leaves_with_keys(params)))
        hold("opt", dict(_leaves_with_keys(opt)))
        runs = []
        for _ in range(1 + BEST_OF):  # the first is the warm-up
            (params, opt, metrics), ms, host_ms = timed_ms(
                lambda: step(params, opt, batch))
            runs.append((ms, host_ms))
        best, best_host = min(runs[1:])
        peak = torch.cuda.max_memory_allocated() / 2**30
    n_b2 = launches["flash_attention"]
    require(wgmma == n_b2, f"[mesh] {tag}: {n_b2 - wgmma} of {n_b2} B2 "
                           f"launches not through wgmma")
    if mesh is not None:
        require(calls.get("flash", 0) == n_b2 > 0,
                f"[mesh] {tag}: {n_b2} B2 launches, {calls.get('flash', 0)} "
                f"through local_map")
    if plan is not None and plan.remote_medium == "peer":
        # fsdp_stream on a data axis of one splits nothing: its REMOTE
        # leaves stay whole on the device, no gather is posted, and the leg
        # times the plain mesh step (the dual buffer over peer HBM runs in
        # the CPU tests' 4-rank world)
        require(not plan.peer_split and not gathers,
                f"[mesh] {tag}: {len(plan.peer_split)} leaves split and "
                f"gathers {gathers} posted on a data axis of one")
        where = ("split over data 0 GiB (an axis of one: no gather posted, "
                 "the plain mesh step)")
    else:
        remote = plan.remote_bytes if plan else 0
        where = f"in host memory {remote / 2**30:.3f} GiB"
    print(f"[mesh] step {tag}: best of {BEST_OF} {best:.3f} ms "
          f"({best_host:.3f} ms on the host before the synchronise; runs "
          f"{', '.join(f'{m:.3f}' for m, _ in runs)}), peak {peak:.3f} GiB, "
          f"{where}"
          + f", B2 launches a step {n_b2} (all wgmma"
          + (f", all through local_map: {calls}" if mesh is not None else "")
          + f"), its backward kernels {launches['flash_attention_bwd']} "
          f"(one a backward call), loss {loss.item():.6f}"
          + ("" if first else ", loss, grads, params and moments "
             "torch.equal to the step without a mesh") + f"; {smi}")
    del params, opt, metrics
    torch.cuda.empty_cache()
    return {"ms": best, "host_ms": best_host, "peak_gib": peak,
            "launches": launches, "local_map": calls}, base


def phase_mesh(smi: str) -> dict:
    """``[mesh]``: a one-rank NCCL process group (its store in a temporary
    directory) and a (1, 1) device mesh over (data, model); granite-8b at
    [train]'s width, depth and batch one step under each of ``MESH_LEGS``,
    all ``torch.equal`` to the step without a mesh, B2's launches a step
    equal (8) and, under the mesh, each through ``local_map``; then
    ``launch.train.main(MESH_LAUNCH)`` on that group, its loss falling.
    Returns the mesh leg's launches."""
    import torch.distributed as dist

    t0 = time.perf_counter()
    torch.cuda.set_device(0)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(
            os.path.join(tmp, "store"), 1), rank=0, world_size=1)
        try:
            mesh = make_smoke_mesh()
            nccl = ".".join(map(str, torch.cuda.nccl.version()))
            print(f"[mesh] one-rank NCCL {nccl} process group, device mesh "
                  f"{dict(zip(mesh.mesh_dim_names, mesh.shape))} on "
                  f"{torch.cuda.get_device_name(0)}, rules "
                  f"{shd.get_rules()}; {smi}")
            cfg = dataclasses.replace(GRANITE_8B, n_layers=TRAIN["n_layers"])
            host_batch = SyntheticTokenDataset(
                cfg, TRAIN["batch"], TRAIN["seq"], seed=0).batch_at(0)
            opt_cfg = AdamWConfig(lr=TRAIN_LEARN["lr"], warmup_steps=0)
            gen = torch.Generator(device="cuda").manual_seed(0)
            host_params = map_leaves(lambda _k, t: t.cpu(),
                                     get_model(cfg).init_params(gen, cfg))
            rows, base = {}, None
            for label, (on, tiering) in MESH_LEGS.items():
                rows[label], base = mesh_leg(
                    label, cfg, host_params, host_batch, opt_cfg, tiering,
                    mesh if on else None, base, smi)
            want = rows["no mesh"]["launches"]["flash_attention"]
            require(want == 2 * cfg.n_layers,
                    f"[mesh] B2 launches a step {want} != {2 * cfg.n_layers}")
            for label, row in rows.items():
                got = row["launches"]["flash_attention"]
                require(got == want, f"[mesh] {label}: B2 launches a step "
                                     f"{got} != {want} without a mesh")
            del base, host_params
            release_memory()
            t_l = time.perf_counter()
            res = launch_train.main(MESH_LAUNCH)
            require(len(res.losses) == 3 and res.losses[-1] < res.losses[0],
                    f"[mesh] launch.train {' '.join(MESH_LAUNCH)}: losses "
                    f"{res.losses} do not fall")
            print(f"[mesh] launch.train {' '.join(MESH_LAUNCH)}: losses "
                  f"{[round(x, 4) for x in res.losses]} "
                  f"({time.perf_counter() - t_l:.1f} s)")
        finally:
            dist.destroy_process_group()
    print(f"[mesh] done in {time.perf_counter() - t0:.1f} s; {smi}")
    return {"launches": rows["mesh"]["launches"], "rows": rows}


# -- [dryrun]: the trace analysis held to the card, and production cells ---------
def traced_step(cfg, host_batch, opt_cfg, tiering: TieringConfig):
    """``[train]``'s step of ``cfg`` under ``tiering`` traced on fake CUDA
    tensors on a one-rank mesh (a fake process group of one): parameters,
    moments and batch laid out by the spec trees and placed by the plan as
    a real step's are, then ``analyze`` of one step."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.hlo_analysis import Tracer, analyze

    step_cfg = TrainStepConfig.from_tiering(tiering, remat="full")
    with dryrun.fake_process_group(1):
        mesh = make_smoke_mesh(device="cuda")
        tr = Tracer()
        with tr:
            params = get_model(cfg).init_params(
                torch.Generator().manual_seed(0), cfg, device="cuda")
            opt = adamw.init(opt_cfg, params)
            batch = {k: torch.empty(v.shape, dtype=torch.int32 if k in (
                "tokens", "labels") else cfg.dtype, device="cuda")
                for k, v in host_batch.items()}
        with shd.use_mesh(mesh):
            specs = shd.params_pspec_tree(
                params, expert_sharding=cfg.expert_sharding, mesh=mesh)
            params = dryrun.laid_out(params, specs, mesh, tr)
            opt = dryrun.laid_out(opt, shd.opt_pspec_tree(opt, specs, mesh),
                                  mesh, tr)
            batch = dryrun.laid_out(batch, shd.batch_pspec_tree(batch, mesh),
                                    mesh, tr)
            with tr:
                params, opt, plan = place_state(params, opt, tiering,
                                                device="cuda")
            step = make_train_step(cfg, step_cfg, opt_cfg, plan=plan)
            return analyze(step, params, opt, batch, device="cuda")


def measured_step(cfg, host_params, host_batch, opt_cfg,
                  tiering: TieringConfig) -> tuple[int, dict]:
    """One real step of the same (without a mesh, as ``[train]`` runs it)
    from fresh state: the device bytes it peaks at above what was
    allocated before its state was made (``max_memory_allocated`` after
    ``reset_peak_memory_stats``, its arguments included), and the
    kernels' launches."""
    release_memory()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    params = map_leaves(lambda _k, t: t.to("cuda"), host_params)
    opt = adamw.init(opt_cfg, params)
    batch = to_device_fn("cuda", cfg.dtype)(host_batch)
    params, opt, plan = place_state(params, opt, tiering)
    step = make_train_step(cfg, TrainStepConfig.from_tiering(
        tiering, remat="full"), opt_cfg, plan=plan)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    out = step(params, opt, batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    launches = counts()
    require(bool(torch.isfinite(out[2]["loss"])), "[dryrun] non-finite loss")
    del params, opt, batch, out
    release_memory()
    return peak, launches


def start_dryrun_cells() -> list:
    """``[dryrun]`` (b)'s cells, each traced in a process of its own, begun
    before ``[mesh]`` so that they trace while ``[mesh]`` and (a) run;
    their output goes to files (a pipe left unread could fill)."""
    cells = []
    for arch, cell in DRYRUN_CELLS:
        out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
        cells.append((subprocess.Popen(
            [sys.executable, "-c", DRYRUN_CELL_CODE, arch, cell],
            stdout=out, stderr=err,
            env=dict(os.environ, PYTHONPATH=str(ROOT / "src")), cwd=ROOT),
            out, err))
    return cells


def stop_dryrun_cells(cells: list) -> None:
    for proc, out, err in cells:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        out.close()
        err.close()


def phase_dryrun(smi: str, cells: list) -> dict:
    """``[dryrun]``: (a) the trace analysis's predicted peak of granite-8b's
    ``[train]`` step (4 layers, 2 x 2048 tokens, bf16, AdamW float32
    moments, remat full) untiered and at host_offload 0.5, traced on fake
    CUDA tensors on a one-rank mesh, against the real step's
    ``max_memory_allocated``: each ratio within ``DRYRUN_BAND``; the
    trace's B2 launches beside the real step's. (b) ``run_cell`` of
    ``DRYRUN_CELLS`` over a 256-rank fake process group on this card's
    host, with the card's memory as the budget: each record's decision
    (the host-offload probe True here, and the decision
    ``decide_tiering`` gives over an abstract mesh with the probe forced
    True, the function the CPU tests hold to the reference's), per-device
    peak, FLOPs and collectives; ``cells`` from
    :func:`start_dryrun_cells`."""
    t0 = time.perf_counter()
    rows = dryrun_legs(smi)
    rows.update(dryrun_cells(cells, smi))
    print(f"[dryrun] done in {time.perf_counter() - t0:.1f} s; {smi}")
    return rows


def dryrun_legs(smi: str) -> dict:
    """``[dryrun]`` (a): the predicted peaks held to the card's."""
    cfg = dataclasses.replace(GRANITE_8B, n_layers=TRAIN["n_layers"])
    opt_cfg = AdamWConfig(lr=TRAIN_LEARN["lr"], warmup_steps=0)
    host_batch = SyntheticTokenDataset(cfg, TRAIN["batch"], TRAIN["seq"],
                                       seed=0).batch_at(0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    host_params = map_leaves(lambda _k, t: t.cpu(),
                             get_model(cfg).init_params(gen, cfg))
    rows = {}
    for label, tiering in DRYRUN_LEGS.items():
        t_leg = time.perf_counter()
        a = traced_step(cfg, host_batch, opt_cfg, tiering)
        t_trace = time.perf_counter() - t_leg
        real, launches = measured_step(cfg, host_params, host_batch, opt_cfg,
                                       tiering)
        mem = a.memory
        ratio = mem["peak_bytes_est"] / real
        b2 = a.launches("repro_torch.b2_flash")
        print(f"[dryrun] {cfg.name} {cfg.n_layers} layers, {label}: "
              f"predicted peak {mem['peak_bytes_est'] / 2**30:.3f} GiB "
              f"(arguments {mem['argument_bytes'] / 2**30:.3f}, outputs "
              f"{mem['output_bytes'] / 2**30:.3f}, host "
              f"{mem['host_argument_bytes'] / 2**30:.3f}; traced in "
              f"{t_trace:.1f} s), measured {real / 2**30:.3f} GiB, ratio "
              f"{ratio:.4f}; B2 launches traced {b2}, real "
              f"{launches['flash_attention']}; per-device FLOPs "
              f"{a.flops:.4e}; {smi}")
        require(DRYRUN_BAND[0] <= ratio <= DRYRUN_BAND[1],
                f"[dryrun] {label}: predicted/measured peak {ratio:.4f} "
                f"outside {DRYRUN_BAND}")
        require(b2 == launches["flash_attention"] == 2 * cfg.n_layers,
                f"[dryrun] {label}: B2 launches traced {b2}, real "
                f"{launches['flash_attention']}, want {2 * cfg.n_layers}")
        rows[label] = {"predicted": mem["peak_bytes_est"], "measured": real,
                       "ratio": ratio, "b2": b2}
    del host_params
    release_memory()
    return rows


def dryrun_cells(cells: list, smi: str) -> dict:
    """``[dryrun]`` (b): each cell's record from its process, its decision
    held to ``decide_tiering``'s with the probe forced True."""
    from repro_torch.configs.base import SHAPE_CELLS
    from repro_torch.launch import dryrun
    from repro_torch.launch.hlo_analysis import Tracer

    rows = {}
    card = torch.cuda.get_device_properties(0).total_memory
    mesh16 = shd.abstract_mesh((16, 16), ("data", "model"))
    real_probe = dryrun.supports_host_offload_spmd
    for (arch, cell), (proc, out, err) in zip(DRYRUN_CELLS, cells):
        proc.wait(timeout=600)
        out.seek(0)
        err.seek(0)
        require(proc.returncode == 0, f"[dryrun] {arch} {cell}: exit "
                                      f"{proc.returncode}\n"
                                      f"{err.read()[-3000:]}")
        rec = json.loads(out.read().strip().splitlines()[-1])
        dryrun.supports_host_offload_spmd = lambda _m: True
        try:
            want = dryrun.decide_tiering(
                get_config(arch), SHAPE_CELLS[cell], mesh16,
                dryrun.abstract_params(get_config(arch), Tracer(), "cpu"),
                hbm_bytes=card)
        finally:
            dryrun.supports_host_offload_spmd = real_probe
        require(rec["tiering"] == want,
                f"[dryrun] {arch} {cell}: decision {rec['tiering']} != "
                f"{want} (the probe forced True)")
        if SHAPE_CELLS[cell].kind == "train":
            require(rec["tiering"]["host_offload_supported"] is True,
                    f"[dryrun] {arch} {cell}: the probe is False on a card")
        mem = rec["memory"]
        print(f"[dryrun] {arch} {cell} on 16x16 over a 256-rank fake group "
              f"(budget {card / 1e9:.2f} GB, this card's): decision "
              f"{json.dumps(rec['tiering'])}; per-device peak "
              f"{mem['peak_bytes_est'] / 2**30:.3f} GiB (arguments "
              f"{mem['argument_bytes'] / 2**30:.3f}, host "
              f"{mem['host_argument_bytes'] / 2**30:.3f}), per-device FLOPs "
              f"{rec['analysis']['flops']:.4e} (global "
              f"{rec['flop_counter']['flops']:.4e}), bytes "
              f"{rec['analysis']['bytes']:.4e}, collectives "
              f"{json.dumps(rec['collectives_by_group'])}, launches "
              f"{rec['launches']}; built in {rec['lower_s']} s, traced in "
              f"{rec['analyze_s']} s, {rec['wall_s']:.1f} s in its process; "
              f"{smi}")
        rows[f"{arch} {cell}"] = rec
    return rows


# -- 6. kernel times ----------------------------------------------------------
def phase_times(mm_data, fa_data, ssd_data) -> dict:
    x, w = mm_data
    M, K = x.shape
    N = w.shape[1]
    mm_bound, mm_by = bound(*work.matmul_work(M, N, K, x.element_size()),
                            PEAK_FLOPS[x.dtype])
    mm = {
        "variant": sm._variant(x.dtype, K, N),
        "ms": time_ms(lambda: sm.streaming_matmul(
            x, w, block_m=128, block_n=128, block_k=128), 20),
        "ffma_ms": time_ms(lambda: sm._launch(x, w, variant="ffma"), 5),
        "plain_ms": time_ms(lambda: matmul_ref(x, w), 20),
        "library_ms": time_ms(lambda: torch.matmul(x, w), 20),
        "bound_ms": mm_bound, "bound_by": mm_by,
    }
    q, k, v = fa_data
    D, Dv = q.shape[3], v.shape[3]
    fa_bound, fa_by = flash_bound(q, k, v)
    k_rep, v_rep = gqa_repeated(q, k, v)  # outside the timed region
    fa_t = {
        "variant": fa._variant(q.dtype, D, Dv),
        "ms": time_ms(lambda: fa.flash_attention_gpu(
            q, k, v, causal=True, block_q=128, block_k=128), 10),
        "ffma_ms": time_ms(lambda: fa._launch(
            q, k, v, causal=True, window=None, scale=1.0 / math.sqrt(D),
            variant="ffma"), 3),
        "plain_ms": time_ms(lambda: flash_ref(q, k, v, causal=True), 3),
        "library_ms": time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k_rep, v_rep, is_causal=True), 10),
        "bound_ms": fa_bound, "bound_by": fa_by,
    }
    xc, bc, cc, dtc, cum = ssd_data
    B, H, nc, Q, P = xc.shape
    N = bc.shape[-1]
    ssd_t = ssd_times(ssd_data)
    ssd_flops, ssd_bytes = ssd_work(ssd_data)
    # the three kernels alone, on preallocated outputs and scratch
    dims = (B * H, nc, Q, P, N)
    states = torch.empty((B, H, nc, P, N), device="cuda")
    y = torch.empty_like(xc)

    def stage(entry, *tensors):
        return lambda: ssd._call(entry, tensors, dims, xc.device)

    stage_ms = {"chunk_state": time_ms(stage(
        "ssd_chunk_state", xc, bc, dtc, cum, states), 10)}
    # in place: each run passes the last one's entering states on again
    stage_ms["state_passing"] = time_ms(stage(
        "ssd_state_passing", states, cum, None), 10)
    stage("ssd_chunk_state", xc, bc, dtc, cum, states)()
    stage("ssd_state_passing", states, cum, None)()
    stage_ms["chunk_output"] = time_ms(stage(
        "ssd_chunk_output", xc, bc, cc, dtc, cum, states, y), 10)
    scratch = states.numel() * 4
    del states, y
    prep_ms = ssd_prep_ms(SSD_FULL)
    out = {"streaming_matmul": mm, "flash_attention": fa_t, "ssd_scan": ssd_t}
    for name, t in out.items():
        lib = "none" if t["library_ms"] is None else f"{t['library_ms']:.4f}"
        other = (f" (ffma on the same inputs {t['ffma_ms']:.4f})"
                 if "ffma_ms" in t else "")
        print(f"[time] {name}: kernel_ms {t['ms']:.4f} {t['variant']}{other}, "
              f"plain_ms {t['plain_ms']:.4f}, library_ms {lib}, "
              f"bound_ms {t['bound_ms']:.4f} ({t['bound_by']}), roofline "
              f"share {t['bound_ms'] / t['ms']:.2%}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"[time] ssd_scan bound: {ssd_flops / 1e9:.2f} GFLOP; at the "
          f"instruction used (TF32 mma.sync, {TF32_PASSES} passes, "
          f"{PEAK_FLOPS['tf32'] / 1e12:.0f} TFLOP/s) "
          f"{TF32_PASSES * ssd_flops / PEAK_FLOPS['tf32'] * 1e3:.4f} ms; on "
          f"the CUDA cores' float32 ({PEAK_FLOPS[torch.float32] / 1e12:.0f} "
          f"TFLOP/s) {ssd_flops / PEAK_FLOPS[torch.float32] * 1e3:.4f} ms; "
          f"{ssd_bytes / 1e6:.1f} MB of inputs and output "
          f"{ssd_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms; beside them the "
          f"scratch state, {scratch / 1e6:.1f} MB written, read and written, "
          f"read ({scratch * (3 + (nc - 1) / nc) / 1e6:.1f} MB, "
          f"{scratch * (3 + (nc - 1) / nc) / HBM_BYTES_PER_S * 1e3:.4f} ms); "
          f"blocks: chunk state {nc * B * H}, state passing "
          f"{-(-P * N // 256) * B * H}, chunk output "
          f"{-(-Q // 64) * nc * B * H}, on {sms} SMs")
    print(f"[time] ssd_scan kernels alone: " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in stage_ms.items())
        + f" (sum {sum(stage_ms.values()):.4f})")
    print(f"[time] ssd prep (ops.ssd_prep, bf16 x/B/C of B{B} L{nc * Q} "
          f"H{H} P{P} G{SSD_FULL['G']} N{N}): {prep_ms:.4f} ms")
    return out


def flash_bound(q, k, v, causal: bool = True) -> tuple[float, str]:
    """B2's bound over (B, H, Sq, D) q and (B, KV, Sk, ·) k, v
    (:func:`repro_torch.kernels.work.flash_work`) at the card's rate for
    q's type."""
    B, H, Sq, D = q.shape
    KV, Sk, Dv = k.shape[1], k.shape[2], v.shape[3]
    return bound(*work.flash_work(B, H, Sq, Sk, KV, D, Dv, causal=causal,
                                  window=None, itemsize=q.element_size()),
                 PEAK_FLOPS[q.dtype])


def gqa_repeated(q, k, v):
    """k and v with each KV head repeated for its query heads, for SDPA."""
    G = q.shape[1] // k.shape[1]
    return k.repeat_interleave(G, dim=1), v.repeat_interleave(G, dim=1)


def ssd_work(ssd_data) -> tuple[float, int]:
    """The SSD scan's operations and bytes over its five inputs
    (:func:`repro_torch.kernels.work.ssd_work`)."""
    xc, bc = ssd_data[0], ssd_data[1]
    return work.ssd_work(*xc.shape, bc.shape[-1])


def ssd_times(ssd_data) -> dict:
    flops, nbytes = ssd_work(ssd_data)
    # at the rate of the instruction the kernels use: mma.sync in TF32,
    # three passes a product (3xTF32)
    ssd_bound, ssd_by = bound(TF32_PASSES * flops, nbytes, PEAK_FLOPS["tf32"])
    return {
        "variant": "mma_tf32x3",  # three kernels, mma.sync in split TF32
        "ms": time_ms(lambda: ssd.ssd_chunk_scan_gpu(*ssd_data), 10),
        "plain_ms": time_ms(lambda: ssd.ssd_chunk_scan_plain(*ssd_data), 3),
        "library_ms": None,  # no single PyTorch call computes the SSD scan
        "bound_ms": ssd_bound, "bound_by": ssd_by,
    }


def ssd_prep_ms(dims: dict) -> float:
    """``ops.ssd_prep``, the prep in front of the kernels, from a layer's
    own tensors at ``dims``: x, B and C in bf16, B and C repeated per head
    (G = 1)."""
    rng = torch.Generator(device="cuda").manual_seed(4)
    B, L, H, P, N, G = (dims[k] for k in ("B", "L", "H", "P", "N", "G"))
    xh = torch.randn((B, L, H, P), generator=rng, device="cuda").bfloat16()
    Bm, Cm = (torch.randn((B, L, G, N), generator=rng, device="cuda")
              .bfloat16() for _ in range(2))
    dt = torch.rand((B, L, H), generator=rng, device="cuda")
    A = -torch.rand((H,), generator=rng, device="cuda") - 0.5
    return time_ms(lambda: ops.ssd_prep(xh, Bm, Cm, dt, A,
                                        chunk=dims["chunk"]), 10)


# -- 6b. the kernels at the models' own shapes ---------------------------------
def model_flash_data(shape: dict) -> tuple:
    """Random bf16 q, k, v in the models' (B, S, H, D) layout, as
    ``gqa_attention`` hands them to ``flash_attention``; with a ``Dv``
    (MLA) v is the second half of a (B, S, KV, D' + Dv) tensor, strided as
    ``mla_attention`` slices it from its up-projection."""
    rng = np.random.default_rng(6)
    B, H, KV, S, D = (shape[k] for k in ("B", "H", "KV", "S", "D"))
    Sk = shape.get("Sk", S)
    q = rand(rng, (B, S, H, D), torch.bfloat16)
    k = rand(rng, (B, Sk, KV, D), torch.bfloat16)
    if "Dv" not in shape:
        return q, k, rand(rng, (B, Sk, KV, D), torch.bfloat16)
    Dv = shape["Dv"]
    return q, k, rand(rng, (B, Sk, KV, 2 * Dv), torch.bfloat16)[..., Dv:]


def oracle_by_lane(q, k, v, causal: bool = True) -> torch.Tensor:
    """``reference_attention`` one batch element at a time: the dense
    oracle's (B, H, S, S) float32 scores at H 128 would take 8.6 GB."""
    return torch.cat([reference_attention(q[b:b + 1], k[b:b + 1],
                                          v[b:b + 1], causal=causal)
                      for b in range(q.shape[0])])


def shape_label(q, k, v, causal: bool) -> str:
    """B, H, KV, S (Sq and Sk where they differ), D, Dv and the mask of
    (B, Sq, H, D) q and (B, Sk, KV, ·) k, v."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    seq = f"S{Sq}" if Sq == Sk else f"Sq{Sq} Sk{Sk}"
    return (f"B{B} H{H} KV{k.shape[2]} {seq} D{D} Dv{v.shape[3]} "
            f"{'causal' if causal else 'full'}")


def phase_model_shape_checks(fa_inputs: dict, ssd_inputs: dict) -> dict:
    """B2 at the models' attention shapes (``FLASH_MODELS``: granite-8b,
    zamba2-1.2b, deepseek-v3's MLA, seamless-m4t-medium's encoder, decoder
    and cross attention), through the models' route (``ops.attention`` on
    the strided (B, S, H, D) tensors), against the dense oracle within
    ``FLASH_TOL``'s bf16 bound (the tensor-core kernel), and at the MLA and
    seamless shapes in float32 too (the FFMA kernel, the float32 path
    check's); B3's three kernels and the scan at zamba2-1.2b's shape within
    ``SSD_TOL``. Returns each kernel's largest max|err|."""
    errs = {"flash_attention": 0.0}
    for label, (q, k, v) in fa_inputs.items():
        spec = FLASH_MODELS[label]
        causal = spec.get("causal", True)
        D, Dv = q.shape[3], v.shape[3]
        dtypes = ((torch.bfloat16, torch.float32)
                  if D != Dv or spec.get("f32") else (torch.bfloat16,))
        for dt in dtypes:
            qd, kd, vd = (t.to(dt) for t in (q, k, v))
            got = ops.attention(qd, kd, vd, causal=causal,
                                block_q=q.shape[1], block_k=k.shape[1])
            want = oracle_by_lane(qd, kd, vd, causal)
            err = max_err(got, want, FLASH_TOL[dt],
                          f"flash at {label}'s shape "
                          f"{shape_label(q, k, v, causal)} {dt} "
                          f"{fa._variant(dt, D, Dv)}, the models' strided "
                          f"layout")
            errs["flash_attention"] = max(errs["flash_attention"], err)
            del got, want, qd, kd, vd
    errs["ssd_scan"] = max(check_ssd_full(full, dims)
                           for full, dims in ssd_inputs.values())
    torch.cuda.synchronize()
    return errs


def sdpa_backend(q, k, v, causal: bool = True, attn_mask=None) -> str:
    """The backend ``scaled_dot_product_attention`` picks for these
    inputs."""
    from torch.nn.attention import SDPBackend

    names = {int(b): n for n, b in SDPBackend.__members__.items()}
    return names.get(int(torch._fused_sdp_choice(
        q, k, v, attn_mask=attn_mask, is_causal=causal)), "unknown")


def phase_model_shape_times(fa_inputs: dict, ssd_inputs: dict) -> dict:
    """``[time]`` lines for B2 and B3 at the models' shapes: the kernel,
    the models' plain version, the library call (SDPA for B2) and the
    bound; for B3 also ``ops.ssd_prep`` at that shape."""
    out = {}
    for label, (q, k, v) in fa_inputs.items():
        causal = FLASH_MODELS[label].get("causal", True)
        Sq, Sk = q.shape[1], k.shape[1]
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        fa_bound, fa_by = flash_bound(qt, kt, vt, causal)
        k_rep, v_rep = gqa_repeated(qt, kt, vt)
        row = {}
        if v.shape[3] != q.shape[3]:  # MLA: the FFMA kernel on the same
            row["ffma_ms"] = time_ms(lambda: fa._launch(  # bf16 inputs too
                qt, kt, vt, causal=True, window=None,
                scale=1.0 / math.sqrt(q.shape[3]), variant="ffma"), 3)
        row["sdpa_backend"] = sdpa_backend(qt, k_rep, v_rep, causal)
        out[f"flash_attention {label}"] = {
            **row,
            "ms": time_ms(lambda: ops.attention(
                q, k, v, causal=causal, block_q=Sq, block_k=Sk), 10),
            "plain_ms": time_ms(lambda: mflash.blocked_flash(
                q, k, v, causal=causal), 3),
            "library_ms": time_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    qt, k_rep, v_rep, is_causal=causal), 10),
            "bound_ms": fa_bound, "bound_by": fa_by,
            "shape": shape_label(q, k, v, causal) + " bf16"}
        del k_rep, v_rep
    for label, (full, dims) in ssd_inputs.items():
        t = ssd_times(full)
        t["prep_ms"] = ssd_prep_ms(dims)
        t["shape"] = " ".join(f"{k}{v}" for k, v in dims.items())
        out[f"ssd_scan {label}"] = t
    for name, t in out.items():
        lib = "none" if t["library_ms"] is None else f"{t['library_ms']:.4f}"
        prep = (f", ops.ssd_prep {t['prep_ms']:.4f} ms" if "prep_ms" in t
                else "")
        ffma = (f" (ffma on the same inputs {t['ffma_ms']:.4f})"
                if "ffma_ms" in t else "")
        sdpa = (f" ({t['sdpa_backend']})" if "sdpa_backend" in t else "")
        print(f"[time] {name} ({t['shape']}): kernel_ms {t['ms']:.4f}"
              f"{ffma}, plain_ms {t['plain_ms']:.4f}, library_ms {lib}{sdpa},"
              f" bound_ms {t['bound_ms']:.4f} ({t['bound_by']}), roofline "
              f"share {t['bound_ms'] / t['ms']:.2%}{prep}")
    return out


def start_host_phases():
    """``HOST_PHASES_CODE`` in a child process (after the build: it loads
    the built libraries), its output to a file."""
    out = tempfile.TemporaryFile("w+")
    proc = subprocess.Popen(
        [sys.executable, "-c", HOST_PHASES_CODE], stdout=out,
        stderr=subprocess.STDOUT, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc, out


def finish_host_phases(proc, out) -> None:
    """Wait for the host phases' process, print what it printed, and fail
    unless it exited 0."""
    try:
        code = proc.wait(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    out.seek(0)
    text = out.read()
    out.close()
    print(text, end="")
    require(code == 0, f"[hpc] / [serving-bench] exited {code}")


def main() -> None:
    dev = phase_device()
    t0 = time.perf_counter()
    walls, last = {}, [t0]

    def lap(name: str) -> None:  # wall seconds of the phase just ended
        walls[name] = time.perf_counter() - last[0]
        last[0] += walls[name]

    phase_build()
    lap("build")
    # first, while the process holds little host memory: the step pins 66
    # GB of it (later phases leave tens of GB that the allocators keep)
    moe_layer = train_moe_layer(dev["smi"])
    lap("deepseek-v3-671b MoE layer trained")
    host = start_host_phases()

    cfg = GRANITE_8B
    L, d, heads, kv, hd = (CHAIN_STAGES, cfg.d_model, cfg.n_heads,
                           cfg.n_kv_heads, cfg.head_dim)
    seq = 4096
    mm_stages, mm_x0 = matmul_chain(L, m=seq, k=d, dtype=cfg.dtype, seed=0)
    at_stages, at_q0 = attention_chain(L, heads=heads, kv_heads=kv,
                                       head_dim=hd, seq=seq, batch=1,
                                       dtype=cfg.dtype, seed=0)
    print(f"[data] {cfg.name}: {L} matmul stages x0{tuple(mm_x0.shape)} "
          f"w{tuple(mm_stages[0].params['w'].shape)}, {L} attention stages "
          f"q{tuple(at_q0.shape)} k/v{tuple(at_stages[0].params['k'].shape)}, "
          f"{cfg.dtype}, drawn in {time.perf_counter() - last[0]:.1f} s")
    lap("chain data")
    mm_data = (mm_x0.cuda(), mm_stages[0].params["w"].cuda())
    fa_data = tuple(t.cuda().transpose(1, 2) for t in
                    (at_q0, at_stages[0].params["k"], at_stages[0].params["v"]))

    errs = phase_kernel_checks(mm_data, fa_data)
    phase_planted_faults(mm_data, fa_data)
    ssd_data = ssd_chunks(np.random.default_rng(3), **SSD_FULL)
    errs["ssd_scan"] = phase_ssd_checks(ssd_data)
    phase_ssd_fault(ssd_data)
    fa_models = {name: model_flash_data(shape)
                 for name, shape in FLASH_MODELS.items()}
    ssd_models = {"zamba2-1.2b": (ssd_chunks(np.random.default_rng(7),
                                             **SSD_ZAMBA), SSD_ZAMBA)}
    for name, err in phase_model_shape_checks(fa_models, ssd_models).items():
        errs[name] = max(errs[name], err)
    lap("checks")

    torch.cuda.reset_peak_memory_stats()
    chains = {
        "streaming_matmul": drive_chain("matmul chain", mm_stages, mm_x0, sm),
        "flash_attention": drive_chain("attention chain", at_stages, at_q0,
                                       fa),
    }
    print(f"[path] max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    del mm_stages, at_stages
    # each kernel's launches on every path: the chains, then the models
    by_path = {name: {} for name in ("streaming_matmul", "flash_attention",
                                     "ssd_scan", "flash_attention_bwd",
                                     "ssd_scan_bwd")}
    for name, chain in chains.items():
        by_path[name][f"{name.split('_')[-1]} chain"] = chain["launches"]
    lap("chains")
    for label, phase in (("mamba2-130m", phase_mamba),
                         ("granite-8b", lambda: phase_dense(dev["smi"])),
                         ("zamba2-1.2b", phase_hybrid)):
        run = phase()
        lap(label)
        for name, n in run["launches"].items():
            if n:
                by_path[name][label] = n
        if "engine" in run:  # the serving layer's path: decode, no kernel
            for name, n in run["engine"]["launches"].items():
                by_path[name][f"{label} engine"] = n
    for label, run in phase_configs(dev["smi"]).items():
        for name, n in run["launches"].items():
            if n:
                by_path[name][label] = n
    lap("configs")
    for label, run in phase_moe(dev["smi"]).items():
        for name, n in run["launches"].items():
            if n:
                by_path[name][label] = n
    lap("moe")
    for name, n in phase_encdec(dev["smi"])["launches"].items():
        if n:
            by_path[name]["seamless-m4t-medium"] = n
    lap("encdec")
    times = phase_times(mm_data, fa_data, ssd_data)
    model_times = phase_model_shape_times(fa_models, ssd_models)
    lap("time")
    # [train]'s 12-layer step peaks near 70 GiB: nothing else stays on the
    # card
    del mm_data, fa_data, ssd_data, fa_models, ssd_models
    release_memory()
    trained = phase_train(dev["smi"])
    lap("train")
    cells = start_dryrun_cells()
    try:
        meshed = phase_mesh(dev["smi"])
        phase_dryrun(dev["smi"], cells)
    finally:
        stop_dryrun_cells(cells)
    lap("mesh, dryrun")
    steps = {"granite-8b": trained["launches"],
             "granite-8b mesh": meshed["launches"], **{
        model: rows["untiered"]["launches"]
        for model, rows in trained["model_rows"].items()}, **{
        f"granite-8b {leg}": rows[f"{leg} untiered"]["launches"]
        for leg, rows in trained["ladder"].items()},
        "deepseek-v3-671b MoE layer": moe_layer["launches"]}
    for model, launches in steps.items():
        for name, n in launches.items():
            if n and name in by_path:
                by_path[name][f"{model} train step"] = n
    for name, paths in by_path.items():
        print(f"[path] {name} launches by path: {paths}")
        require(sum(paths.values()) > 0, f"{name}: launched on no path")
    finish_host_phases(*host)
    lap("host phases' wait")
    print(f"[done] {time.perf_counter() - t0:.1f} s after the device phase ("
          + ", ".join(f"{k} {v:.1f}" for k, v in walls.items())
          + f" s); {dev['smi']}")
    replaces = {
        "streaming_matmul": "src/repro/kernels/streaming_matmul.py:34",
        "flash_attention": "src/repro/kernels/flash_attention.py:36",
        "ssd_scan": "src/repro/kernels/ssd_scan.py:24",
    }
    kernels = [
        {"name": name, "route": "cuda",
         "source": f"src/repro_torch/kernels/csrc/{name}.cu",
         "replaces": replaces[name],
         "launches": sum(by_path[name].values()),
         "launches_by_path": by_path[name],
         "max_abs_err": errs[name],
         **{k: v for k, v in times[name].items() if k != "ffma_ms"},
         "model_shapes": {k.split(" ", 1)[1]: v
                          for k, v in model_times.items()
                          if k.startswith(name)}}
        for name in ("streaming_matmul", "flash_attention", "ssd_scan")
    ]
    # the backward kernels: B2's and B3's autograd Functions' backward on
    # the train steps (the reference's backward is its plain VJP: no TPU
    # kernel; "replaces" names that VJP)
    vjp, b3_vjp = trained["vjp"], trained["b3_vjp"]
    b2_t = vjp[torch.bfloat16]["times"]
    b3_main = b3_vjp["mamba2-130m"]

    def b2_err(r: dict) -> float:
        return max(r[f"kernel_{k}"] for k in ("dq", "dk", "dv"))

    kernels.append({
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/kernels/flash_attention.py:140 (_flash_vjp, "
                    "plain jnp: no TPU kernel)",
        "launches": sum(by_path["flash_attention_bwd"].values()),
        "launches_by_path": by_path["flash_attention_bwd"],
        "max_abs_err": b2_err(vjp[torch.bfloat16]),
        "max_abs_err_by_dtype": {str(dt).removeprefix("torch."): b2_err(r)
                                 for dt, r in vjp.items()},
        "ms": b2_t["backward_ms"], "plain_ms": b2_t["plain_backward_ms"],
        "bound_ms": b2_t["backward_bound_ms"],
        "bound_by": b2_t["backward_bound_by"],
        "library_ms": b2_t["sdpa_bwd_ms"],
        "variant": b2_t["backward_variant"],
        "sdpa_fwd_bwd_ms": b2_t["sdpa_fwd_bwd_ms"],
        "shape": b2_t["shape"],
        "model_shapes": {label: {
            "max_abs_err": {str(dt).removeprefix("torch."): b2_err(r)
                            for dt, r in by_dtype.items()},
            **{k: v for k, v in by_dtype[torch.bfloat16]["times"].items()
               if k in ("backward_ms", "backward_variant", "ffma_backward_ms",
                        "launch_ms", "plain_backward_ms", "backward_bound_ms",
                        "sdpa_bwd_ms", "sdpa_backend", "shape", "parts",
                        "one_part_ms", "parts_ms", "one_part_launch_ms")}}
            for label, by_dtype in trained["vjp_more"].items()},
        "window_case": {"max_abs_err": b2_err(trained["vjp_window"]),
                        **trained["vjp_window"]["times"]},
        "deterministic": all(r["deterministic"] for r in (
            *vjp.values(), trained["vjp_window"],
            *(r for by in trained["vjp_more"].values()
              for r in by.values())))})
    kernels.append({
        "name": "ssd_scan_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "replaces": "src/repro/models/ssm.py:69 (_ssd_scan's VJP, plain "
                    "jnp: no TPU kernel)",
        "launches": sum(by_path["ssd_scan_bwd"].values()),
        "launches_by_path": by_path["ssd_scan_bwd"],
        "max_abs_err": b3_main["max_abs_err"],
        "ms": b3_main["ms"], "plain_ms": b3_main["plain_ms"],
        "bound_ms": b3_main["bound_ms"], "bound_by": b3_main["bound_by"],
        "library_ms": None, "shape": b3_main["shape"],
        "model_shapes": b3_vjp})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev["kind"], "count": dev["count"]}}))


if __name__ == "__main__":
    main()
