#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card and check it.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (each prints its own line; any failure exits non-zero before the
result line):

1. the card (``nvidia-smi`` name and power limit) and the nvcc build of the
   five CUDA kernels from ``src/repro_torch/csrc``;
2. each kernel against its plain PyTorch version on the card at the main
   path's shapes -- the three SNN kernels bit for bit (``spike_matmul`` at
   its four main-path shapes, on a mixed raster, a graded serving tick and
   the 2^27 wraparound, and under the CUDA cores' int32 floor at
   [25600,256]x[256,128], which only its tensor-core route can reach;
   ``sparse_accum`` on binary, graded, over-budget and unsorted lists, timed
   at E = 2048 and 25600 beside the event encoder), ``quant_matmul``
   (int8 and int4) to the bf16 tolerance of ``tests/test_kernels.py``,
   also at the wide route's longest K (jamba's [4096,8192]x[8192,4096] and
   [4096,14336]x[14336,4096]), ``flash_attention`` to one bf16 ulp (and in f32 to 1e-4), with planted
   faults shown to fail that tolerance, the two tensor-core kernels shown to
   give identical bits across launches and ``quant_matmul``'s rows not to
   depend on M -- timed (device time per call, torch.profiler) beside its
   plain version, a PyTorch library call where one computes the same function,
   and its roofline bound, with the achieved rate and share of the bound;
3. ``run_int`` of the 256-128-10 LIF network (w6/u16, T=25, random weights
   from a seeded generator) on a ``mnist_like`` batch of 1024 through the
   ``reference``, ``fused`` and ``event`` (pallas strategy) backends: every
   record field identical, and identical to the CPU on a slice;
4. ``eval_int`` on ``mnist_like(n=4096, T=25)`` at batch 4096 through
   ``fused`` and ``event``: equal accuracy and event statistics, then each
   batch's wall and device-busy time under torch.profiler;
5. ``SNNServeEngine`` (64 lanes, pallas event backend) on 256 ragged
   requests -- sparse, dense and graded -- each bit-exact with a serial
   ``run_int(reference)`` of its own raster;
6. LM decode serving at full width: stablelm-1.6b (24 layers, d_model 2048,
   random weights from a seeded generator, int8 block weights) in
   ``ServeEngine(max_batch=8, max_len=256)`` on 16 requests, two of them with
   one prompt (identical tokens required), then a short int4 pass;
   ``quant_matmul`` launches = 24 x 7 x decode steps; sampled requests'
   logits against a serial decode of their prompt alone;
7. one-pass ``prefill`` of 4096 tokens at full width (int8): 24
   ``flash_attention`` and 168 ``quant_matmul`` launches, and its caches at
   positions [0, 256) against a separate ``prefill`` of the first 256 tokens
   (plain ``attend``), a check that faults planted in the flash kernel's
   arguments (no causal mask, a 2x scale) must fail;
8. the card against the CPU at full width and 2 layers: one ``decode_step``
   of 2 slots and one ``prefill`` of 4096 tokens (the CPU runs the plain
   versions);
9. the Flex-plorer DSE at full width (benchmarks/dse_bench.py's 256-128-10
   LIF network, ATA-F hidden layer, T = 20, 1800 configurations), trained
   on the card as dse_bench trains it (``train_snn``, 6 epochs): a search on
   seeded random weights for comparison, then ``explore_snn`` NSGA-II
   (population 64, 3 generations, perf and bandwidth terms on) on the
   trained weights, its population sweep through ``spike_matmul`` and
   ``lif_scan``; every scored candidate's accuracy and stats equal to
   serial ``eval_int(reference)``; a repeated search and a search killed
   after generation 1 and resumed give the identical result; 4 candidates x
   32 samples card == CPU; the candidate-axis ``lif_scan`` bit-identical to
   its plain version at [64, 20, 231, 10]; the sweep's candidates/s at P =
   64 and 512 with its device-busy share, the profiler's launches by kernel
   equal to the wrappers' counts; then the search with its QAT refine phase
   (``RefineSpec(top_k=4)``): every refined candidate's PTQ and refined
   accuracy equal to serial ``eval_int(reference)``, best >= base, and the
   candidate-axis train step's ``spike_matmul`` launches = T x layers at K
   = 4 and K = 1, each bit-identical to plain;
10. training at full width (examples_torch/quickstart.py's ``main``: 256-128-10
   LIF w6/u8, T = 25, 8 epochs): ``train_snn`` on the card, the trained net deployed
   through ``quantize_params`` -> ``eval_int`` on ``reference``, ``fused``
   and ``event`` (identical accuracies, above a floor, equal to the one the
   example printed), one train step on
   the card against the CPU, and a QAT epoch (``PrecisionConfig(w_bits=3)``)
   whose ``eval_qat`` equals ``eval_int`` of its deployment and whose every
   step launches ``spike_matmul`` T x layers times, each launch bit-identical
   to plain; train-, QAT- and refine-step times with their device-busy share;
11. the serving front end and crash safety on the phases 3-5 net
   (``SNNServeEngine(max_batch=64, backend=EventBackend("pallas"),
   tick_stride=16)``): 256 streaming sessions x 64 steps in 16-step chunks,
   fed in three groups one after the other (96 sparse, 128 dense
   ``mnist_like``, 32 graded) so that sparse, f32_exact and int32 ticks
   all occur, every readout equal to the prefix counts of a serial
   ``run_int(reference)``, with steps/s, chunks/s, chunk p50/p99 and one
   round's device-busy share; the same streams with every session evicted
   to ``build/phase11/`` after each round (identical readouts, evictions =
   restores + 256); phase 5's traffic without and with a ``Journal``
   (results equal to phase 5's); a ``SupervisedEngine`` with a journal and
   a checkpoint store serving 64 requests and 16 streams through a slow
   tick, a tick raise, a poisoned carry and a kill, every result bit-exact
   and the recovery counters equal to what was armed; ``SNNHttpServer``'s
   routes on 127.0.0.1; ``launch/serve_snn.main`` in replay and
   ``--streaming 16`` modes.  Phases 5 and 11 print dispatch against tick
   wall from the engine's own timers;
12. the SNN path across a device mesh (``core/shard.py``): a
   ``DeviceMesh`` of four shards on card 0 (and, on a machine with more
   than one card, the real cards; otherwise a line says that part did not
   run).  ``eval_int`` at batch 4096 through ``fused`` and ``event`` (its
   fixed-capacity surrogate, ``sparse_accum`` on every shard) and a batch
   of 4093 (padding); ``run_int_batched`` over 510 ragged samples; the
   sweep at P = 510 (edge-padded to 512); phase 9's ``explore_snn`` with
   ``EvalSpec(mesh=...)`` (the same ``to_json()``); ``SNNServeEngine(
   max_batch=64, data_parallel=<mesh>)`` on phase 5's traffic (each request
   equal to phase 5's) and 16 streaming sessions (equal to serial
   ``run_int``).  Every sharded result equals its serial counterpart; the
   launches by kernel of the ``eval_int`` batch, the ragged batch and the
   sweep are 4 x the serial run's at the shard's size, the served burst's 4
   x the unsharded engine's on the same ticks; the sharded and serial
   walls of the ``eval_int`` batch, the P = 512 sweep and the served burst
   are printed beside the card's name and power limit;
13. LM training through the production loop: one train step
   (``build_train_step``, launch/train.py's seq 256 x batch 8, the loop's
   AdamW schedule, ``remat="block"``) of full-width stablelm-1.6b and
   granite-moe-1b-a400m, 2 warm-up and 5 timed steps (ms a step, tokens/s,
   model-FLOPs share of the bf16 peak, peak memory, device-busy share and
   top device items beside the card's name and power limit; the loss
   finite and falling; no kernel launched, as JAX trains through none);
   granite's layer-0 routing card == CPU; ``TrainLoop`` at
   examples/lm_train_100m.py's ~100 M config for 60 steps with a
   checkpoint every 20 and a failure injected at 30 (one failure, restored
   at 20, the loss fallen), then a second ``run`` that resumes from LATEST;
   one reduced-config step card vs CPU at f32 compute (stablelm, qwen2-moe)
   stage by stage within 1e-5; ``ServeEngine`` on int8 granite-moe at full
   width (8 requests), every ``quant_matmul`` launch equal to its plain
   version;
14. the SSM, hybrid and VLM LMs at full width (random weights from a
   seeded generator): (a) mamba2-780m, all 48 layers: ``ServeEngine`` int8
   on 16 requests of 4-12 prompt tokens (sampled requests against a
   serial decode of their prompt alone) and int4 on 4, ``quant_matmul``
   launches = 48 x 2 x decode steps, each held to its plain version, then
   the same traffic served again with nothing recorded, which is the pass
   timed; a 512-token f32 prefill (two SSD chunks) against 512 decode
   steps replayed from a CUDA graph (every layer's state and conv state
   and the next logits within 2e-3); a 4096-token int8 prefill, checked,
   then timed warm; (b) its train step as phase 13's; (c) jamba-v0.1-52b at full
   width cut to one pattern group (8 of 32 layers: 1 attention + 7 SSD,
   MoE 16 x top 2 on the even positions), int8 serving of 8 requests (30
   quantized products a step; requests 0 and 5 against serial decodes, as
   in (d)) and a 4096-token int8 prefill with one
   ``flash_attention`` launch, the MoE's transient bytes reckoned first;
   (d) qwen2-vl-2b (28 layers): a 4096-position int8 prefill of 256 patch
   embeddings on a 16 x 16 M-RoPE grid and 3840 text tokens (28
   ``flash_attention``, 196 ``quant_matmul`` launches), the same at 2
   layers card == CPU, int8 serving of 8 requests, and a train step of
   128 patches + 128 text tokens x batch 8; (e) reduced mamba2, jamba
   (its routing card == CPU) and qwen2-vl train steps card vs CPU stage by
   stage within 1e-5 (SSM gradients 1e-4, and each f32 gradient of an SSM
   config against an f64 step on the CPU: the card's within 4x the CPU's
   distance).  Every ``quant_matmul`` launch of phase 14 is held to its
   plain version at QM_TOL, and every ``flash_attention`` launch to its
   plain version at FA_TOL, with planted faults outside it;
15. whisper-medium at full width (24 + 24 layers, random weights from a
   seeded generator, int8 block weights): (a) 4 clips x 4096 frames
   through ``build_prefill_step`` and 32 greedy steps of
   ``build_decode_step``, every ``quant_matmul`` launch at QM_TOL and every
   non-causal ``flash_attention`` launch at FA_TOL with planted faults (a
   causal mask applied among them), then the same traffic timed warm and
   unrecorded with its busy shares, and request 0 alone (B = 1) decoding
   the same tokens; (b) one clip of 32768 frames, each flash launch checked
   on 4 query blocks of 256 rows, 16 decode steps against the 3.2 GB cross
   cache, both timed warm; (c) a train step at 4096 frames + 448 tokens
   (AdamW; ms a step, peak memory, the model-FLOPs share from
   ``structural.model_flops``); (d) the reduced step card vs CPU;
16. stablelm-1.6b at full width over a ("data", "model") mesh of four
   shards of card 0 (``launch/mesh.py``; FSDP on data, TP on model, the
   dense blocks sharded by ``models/sharded.py``): (a) three train steps at
   seq 256 x batch 8 at f32 compute against one device (gradients at the
   initial parameters within 1e-4 of max |g|, each loss and grad norm 1e-5,
   the parameters after the steps 1e-3 of max |w|), then at the config's
   bf16 compute timed against one device (ms a step, model-FLOPs share,
   peak memory, the device split) and a ``bf16_gather`` step; (b) a 2 x 4096
   int8 ``serve_optimized`` prefill, every ``quant_matmul`` and
   ``flash_attention`` launch (local heads) held to plain with planted
   faults, logits and caches against one device; (c) 16 greedy decode
   steps over the batch- and kv-head-sharded caches, fed the one-device
   tokens, every launch held to plain, each step's logits within 1e-2 of
   max and its token equal wherever decided; (d) ``TrainLoop`` at ~100 M on (2, 2) with a failure,
   its checkpoint resumed on (4, 1) within 1e-5 of (2, 2)'s losses; (e)
   ``ring_allgather_matmul`` on four shards against ``x @ w``; (a)-(c) again
   on distinct cards where there are two or four;
17. the MoE, SSM, hybrid and VLM LMs at full width over the (2, 2) mesh of
   four shards of card 0 (``models/sharded_moe.py``, ``sharded_ssm.py``):
   (a) granite-moe-1b-a400m, 24 layers, train steps at seq 256 x batch 8
   under the ``"tp"`` expert layout at f32 against one device (phase 16a's
   limits; parameters where AdamW's update is conditioned), its routing's
   capacity drops and smallest top-k margin against one device's, bf16
   steps timed with their device split, and the ``"fsdp"`` (experts over
   data, tokens by all-to-all) and ``"megatron"`` layouts at f32 cut to 2
   of 24 layers; (b) qwen2-moe-a2.7b, 24 layers, int8 ``serve_optimized``
   (bf16 experts): one device first, then the same tree placed on the mesh,
   a 2 x 4096 prefill and 16 greedy decode steps fed the one-device tokens,
   every ``quant_matmul`` / ``flash_attention`` launch held to plain as it
   is made (planted faults) and the kernels' counts equal to the launches
   checked; (c) jamba-v0.1-52b at full width cut to one 8-layer group, the
   same at f32 and at bf16 compute (the bf16 limits from one device's own
   bf16-vs-f32 distance), with each shard's block of the model-split conv
   cache against the one-device columns after the prefill and after the
   decode; (d) mamba2-780m, 48 layers: an f32 train step against one
   device, a bf16 step timed, a 2 x 512 int8 prefill and 16 decode steps
   at f32 and bf16 compute, as (c); (e) qwen2-vl-2b, 28 layers: an f32 train step with patch
   embeddings and M-RoPE positions against one device, a 2 x 4096 int8
   prefill (256 patches a sequence); again on distinct cards where there
   are two or four;
18. whisper-medium and the sequence-sharded KV decode over the same (2, 2)
   mesh of card 0 (``models/sharded_whisper.py``; ``shard_cache_seq``'s
   two-pass softmax in ``models/sharded.py``): (a) train steps at 2 clips
   x 2048 frames + 448 tokens at f32 against one device (phase 16a's
   limits, parameters where AdamW's update is conditioned), then at bf16
   timed with the mesh step's device split; (b) int8 ``serve_optimized``,
   a 2 x 4096-frame prefill and 16 greedy decode steps at f32 and at bf16
   compute, one device first, then the mesh fed its tokens: every
   ``flash_attention`` launch (local heads) and ``quant_matmul`` launch
   held to plain as it is made, the counts equal to the launches checked,
   each shard's block of every cross and self cache against its slice of
   the one-device cache, the logits within 1e-4 of max at f32 (at bf16
   within 17c's limit from one device's own bf16-vs-f32 distance) with the
   greedy tokens equal where decided; (c) the same at f32 for one
   clip of 32768 frames with the cross cache's sequence over ``data``
   (``whisper_prefill(..., shard_seq=True)``, ``shard_cache_seq``); (d)
   jamba-v0.1-52b cut to one 8-layer group at long_500k's layout (batch 1,
   a 524288-deep cache filled from a seeded generator at lengths 262144
   and 393216, then a real 4096-token prefill grown into a 6144-deep
   buffer) decoded with ``shard_cache_seq`` at f32 compute against one
   device; ms a step on both;
19. the dry run (``launch/dryrun.py``): (a) stablelm-1.6b x decode_32k x
   serve_q8 through ``run_cell`` on the meta (16, 16) mesh at full size,
   its per-device peak, FLOPs, wire bytes, dominant term and ``fits_hbm``
   (predictions from ``HW``); (b) stablelm at full width and 2 layers on
   the (2, 2) mesh of card 0, its serve_q8 prefill of 2 x 4096 tokens and
   bf16 train step run for real under the dry run's counters and as a
   meta pass: FLOPs, collectives by op (backward included), wire bytes and
   the kernels' reports equal, every ``quant_matmul`` / ``flash_attention``
   launch held to plain; (c) on one device, the meta pass's peak against
   ``torch.cuda.max_memory_allocated()`` within DRY_MEM_BAND; (d) (b)'s
   steps timed warm, wall and busy, beside ``roofline_terms`` and the share
   of the bound the card reaches;
20. the examples and the chaos smoke on the card, each through its
   ``main`` at the JAX example's own sizes, with its wall and launches by
   kernel beside the card's name and power limit: (a) examples_torch/
   quickstart.py (run by phase 10, which holds its printed accuracy to
   ``eval_int(reference)`` of its qparams): 64 test samples card == CPU,
   ``sparse_accum`` launched; (b) serve_snn.py: 11 / 11 requests bit-exact with serial
   ``run_int``, ``sparse_accum`` launched; (c) flexplorer_dse.py (train,
   anneal, QAT refine of the top 2) into ``build/phase20/``: the package
   reloads and its sample runs card == CPU, ``spike_matmul`` and
   ``lif_scan`` launched; (d) serve_quantized.py: every ``quant_matmul``
   launch of its int8 / int4 pass at QM_TOL of plain, its structural bytes
   == the CPU's; (e) lm_train_100m.py, 300 steps with the failure at 150:
   one failure recovered, every step reached, the loss finite and falling;
   (f) scripts/chaos_smoke_torch.py's ``smoke`` stage by stage: nothing
   lost or served twice, 12 / 12 bit-exact; every tick of its supervised
   engine takes the f32_exact route and the engine launches no SNN kernel;
   the serial replays that judge it (its oracle) launch ``spike_matmul``;
21. a ``kernels`` JSON line (launches on phases 3-7 and 9-20, times,
   bounds); phases 3-5, 9-12 and 20 also print the SNN kernels' launches by
   size; phase 2 also times non-causal ``flash_attention`` at
   [1,16,4096,64] and [1,16,32768,64] beside SDPA and the bound;
22. the result line.
"""

from __future__ import annotations

import asyncio
import collections
import contextlib
import dataclasses
import io
import itertools
import json
import math
import shutil
import statistics
import sys
import tempfile
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from examples_torch import flexplorer_dse as ex_dse  # noqa: E402
from examples_torch import load_chaos_smoke  # noqa: E402
from examples_torch import lm_train_100m as ex_lm  # noqa: E402
from examples_torch import quickstart as ex_quickstart  # noqa: E402
from examples_torch import serve_quantized as ex_quantized  # noqa: E402
from examples_torch import serve_snn as ex_serve  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch._device import device_label  # noqa: E402
from repro_torch.core import backend as backend_mod  # noqa: E402
from repro_torch.core.backend import (  # noqa: E402
    EventBackend,
    run_int_population,
    stack_population,
)
from repro_torch.core.flexplorer import explorer as explorer_mod  # noqa: E402
from repro_torch.core.flexplorer.cost import CostWeights  # noqa: E402
from repro_torch.core.flexplorer.explorer import (  # noqa: E402
    EvalSpec,
    RefineSpec,
    SearchSpec,
    SNNSearchSpace,
    explore_snn,
)
from repro_torch.core.flexplorer.strategies import NSGAConfig  # noqa: E402
from repro_torch.core.shard import (  # noqa: E402
    DeviceMesh,
    make_mesh,
    run_int_population_sharded,
    run_int_sharded,
)
from repro_torch.core.precision import (  # noqa: E402
    PrecisionPolicy,
    QTensor,
    dequantize_weight,
    quantize_tree,
    quantize_weight,
    tree_map,
)
from repro_torch.core.network import (  # noqa: E402
    NetworkConfig,
    init_float_params,
    int_params_from_numpy,
    quantize_params,
    run_int,
)
from repro_torch.core import snn_layer as snn_layer_mod  # noqa: E402
from repro_torch.core.snn_layer import (  # noqa: E402
    FloatLayerParams,
    IntLayerParams,
    LayerConfig,
    NeuronModel,
    Topology,
)
from repro_torch.data.snn_datasets import SpikeDataset, mnist_like, raster_tensor  # noqa: E402
from repro_torch.data.tokens import SyntheticTokens  # noqa: E402
from repro_torch.distributed import structural  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attend  # noqa: E402
from repro_torch.kernels.flash_attention.ref import NEG_INF, flash_attention_ref  # noqa: E402
from repro_torch.kernels.lif_scan.lif_scan import lif_scan  # noqa: E402
from repro_torch.kernels.lif_scan.ref import lif_scan_ref  # noqa: E402
from repro_torch.kernels.quant_matmul.quant_matmul import quant_matmul  # noqa: E402
from repro_torch.kernels.quant_matmul.ref import quant_matmul_ref  # noqa: E402
from repro_torch.kernels.quant_matmul.spike_matmul import (  # noqa: E402
    plan,
    spike_matmul,
    spike_matmul_plain,
)
from repro_torch.kernels.sparse_accum.ops import fixed_capacity_events  # noqa: E402
from repro_torch.kernels.sparse_accum.ref import sparse_accum_ref  # noqa: E402
from repro_torch.kernels.sparse_accum.sparse_accum import sparse_accum  # noqa: E402
from repro_torch.launch import dryrun, serve_snn  # noqa: E402
from repro_torch.distributed.hlo_analysis import HW, roofline_terms  # noqa: E402
from repro_torch.launch.serve import QUANT_RULES  # noqa: E402
from repro_torch.launch.steps import (  # noqa: E402
    build_decode_step,
    build_prefill_step,
    build_train_step,
    init_opt_state,
    mesh_value_and_grad,
)
from repro_torch.launch.mesh import make_mesh as make_named_mesh  # noqa: E402
from repro_torch.distributed.overlap import ring_allgather_matmul_shardmap  # noqa: E402
from repro_torch.distributed.sharding import NamedSharding  # noqa: E402
from repro_torch.distributed.spmd import Sharded, place, shard, shard_tree  # noqa: E402
from repro_torch.models import attention as attn_mod  # noqa: E402
from repro_torch.models import mlp as mlp_mod  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.attention import AttnMask, attend  # noqa: E402
from repro_torch.models.common import materialize, rms_norm, tree_leaves, tree_unflatten  # noqa: E402
from repro_torch.models.registry import SHAPES, ShapeSpec, get_arch  # noqa: E402
from repro_torch.models.routing_probe import record_routing  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.serve.faults import FaultInjector  # noqa: E402
from repro_torch.serve.http import SNNHttpServer  # noqa: E402
from repro_torch.serve.journal import Journal, read_records, recover  # noqa: E402
from repro_torch.serve.snn_engine import AsyncSNNServer, SNNRequest, SNNServeEngine  # noqa: E402
from repro_torch.serve.streaming import (  # noqa: E402
    AsyncStreamServer,
    StreamConfig,
    StreamSessionManager,
)
from repro_torch.serve.supervisor import SupervisedEngine  # noqa: E402
from repro_torch.snn.qat import (  # noqa: E402
    PrecisionConfig,
    candidate_grid,
    eval_qat,
    refine_step,
    run_qat,
)
from repro_torch.snn.surrogate import fast_sigmoid  # noqa: E402
from repro_torch.snn.train import eval_int, eval_int_population, train_snn  # noqa: E402
from repro_torch.train import optimizer as opt_mod  # noqa: E402
from repro_torch.train.loop import TrainLoop  # noqa: E402
from repro_torch.train.optimizer import adamw, linear_warmup_cosine  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet / Hopper white paper, dense, 700 W).
HBM_BYTES_S = 3.35e12
INT8_TC_OPS_S = 1979e12  # int8 tensor cores
INT32_OPS_S = 33.5e12  # int32 on the CUDA cores
BF16_TC_FLOPS = 989e12  # bf16 tensor cores
L2_BYTES = 50 * 2**20
BINARY_SERVE_BUDGET = 64  # EventBackend().serve_budget(256, 0.10)
DEVICE = "cuda"


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def stream_ms(fn, reps: int = 15, inner: int = 10, warmup: int = 3) -> float:
    """Median milliseconds per call over ``reps`` CUDA-event windows of
    ``inner`` back-to-back calls: device time plus any gap the host leaves
    between launches."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / inner)
    return statistics.median(times)


def time_ms(fn, reps: int = 15, inner: int = 10, warmup: int = 3) -> float:
    """Device milliseconds per call: the time the card spent in ``fn``'s
    kernels and copies (torch.profiler) over ``reps * inner`` calls, divided
    by the calls.  Host time between launches is left out -- at decode shapes
    a kernel runs for less time than its Python wrapper takes to launch it.
    Falls back to :func:`stream_ms` if the profiler sees no device time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps * inner):
            fn()
        torch.cuda.synchronize()
    us = sum(
        e.self_device_time_total for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA
    )
    return us / 1e3 / (reps * inner) if us > 0 else stream_ms(fn, reps, inner, 0)


def bound(n_bytes: float, ops: float, ops_rate: float) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / HBM_BYTES_S, ops / ops_rate
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def bits16(t: torch.Tensor) -> torch.Tensor:
    """A bf16 tensor's bit patterns, so that equality means identical bits."""
    return t.view(torch.int16)


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) if a.numel() else 0


def fits_int8(*ts) -> bool:
    return all(int(t.min()) >= -128 and int(t.max()) <= 127 for t in ts)


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def share(bound_ms: float, ms: float) -> str:
    return f"{bound_ms / ms:.4f}"


# spike_matmul's (M, K, N) on the main path: the reference backend's
# per-step product (B = 1024), the fused window of phases 3-4 (T = 25 x B =
# 1024 and 4096) for each layer (256 -> 128, 128 -> 10)
SPIKE_SHAPES = [(1024, 256, 128), (25600, 256, 128), (102400, 256, 128), (25600, 128, 10)]
# the int32 CUDA cores' floor for [25600,256]x[256,128]: 2 M K N / 33.5 TOP/s
SPIKE_INT32_FLOOR_MS = 2 * 25600 * 256 * 128 / INT32_OPS_S * 1e3


def mixed_raster(gen, M: int, K: int) -> torch.Tensor:
    """Binary spikes (rate 0.12) with a graded value of 128..3999 in 8 of
    the 16-row strips, which sends those strips' chunk to byte planes."""
    s = (torch.rand(M, K, device=DEVICE, generator=gen) < 0.12).to(torch.int32)
    strips = torch.randperm(M // 16, device=DEVICE, generator=gen)[:8]
    for i, strip in enumerate(strips.tolist()):
        s[16 * strip + i % 16, (37 * i) % K] = 128 + 483 * i
    return s


def check_spike_matmul(gen, w_main) -> dict:
    """Bit for bit against plain at every main-path shape (binary x w6, one
    int8 tensor-core pass), on a mixed raster and a graded serving tick (byte
    planes), a ragged graded case with wide weights and the 2^27 wraparound
    (CUDA cores); each main-path shape timed beside ``torch._int_mm`` and its
    bound."""
    dev = DEVICE
    w_of = {w.shape: w for w in w_main}
    main = {
        (M, K, N): (torch.rand(M, K, device=dev, generator=gen) < 0.12).to(torch.int32)
        for M, K, N in SPIKE_SHAPES
    }
    mixed = mixed_raster(gen, 25600, 256)
    cases = [(s, w_of[(K, N)]) for (M, K, N), s in main.items()] + [
        (mixed, w_of[(256, 128)]),
        (
            torch.randint(0, 4, (77, 33), device=dev, generator=gen, dtype=torch.int32),
            torch.randint(-500, 500, (33, 19), device=dev, generator=gen, dtype=torch.int32),
        ),
        (
            torch.full((5, 16), 3, dtype=torch.int32, device=dev),
            torch.full((16, 8), 2**27, dtype=torch.int32, device=dev),
        ),
    ]
    err = 0
    for s, w in cases:
        got, want = spike_matmul(s, w), spike_matmul_plain(s, w)
        torch.cuda.synchronize()
        err = max(err, max_abs_err(got, want))
        check(torch.equal(got, want), f"spike_matmul {tuple(s.shape)}x{tuple(w.shape)} != plain")
    check(int(spike_matmul(*cases[-1])[0, 0]) == -(2**31), "spike_matmul wraparound")
    check(not fits_int8(mixed), "the mixed raster holds values above int8")
    rows = {}
    for (M, K, N), s in main.items():
        w = w_of[(K, N)]
        check(fits_int8(s, w), f"[{M},{K}]x[{K},{N}]: binary x w6 fits int8")
        s8, w8 = s.to(torch.int8), w.to(torch.int8)
        lib = None
        if N % 8 == 0:  # torch._int_mm takes N % 8 == 0 only
            check(torch.equal(torch._int_mm(s8, w8), spike_matmul(s, w)), "_int_mm != kernel")
            lib = time_ms(lambda: torch._int_mm(s8, w8))
        b_ms, b_by = bound(4 * (M * K + K * N + M * N), 2 * M * K * N, INT8_TC_OPS_S)
        r = rows[(M, K, N)] = dict(
            ms=time_ms(lambda: spike_matmul(s, w)), library_ms=lib, bound_ms=b_ms, bound_by=b_by
        )
        print(
            f"kernel spike_matmul [{M},{K}]x[{K},{N}] binary x w6: {r['ms']:.5f} ms, "
            f"{4 * (M * K + K * N + M * N) / r['ms'] / 1e6:.1f} GB/s, "
            f"{share(b_ms, r['ms'])} of the bound {b_ms:.5f} ms ({b_by}); library "
            + (f"{lib:.5f} ms (torch._int_mm, int8)" if lib is not None else "none (N % 8 != 0)")
        )
    w = w_of[(256, 128)]
    mixed_ms = time_ms(lambda: spike_matmul(mixed, w))
    print(
        f"kernel spike_matmul [25600,256]x[256,128] mixed raster (8 strips with graded values in "
        f"byte planes, the rest in one int8 pass): bit-identical to plain, {mixed_ms:.5f} ms"
    )
    # phase 5's int32 serving ticks: 64 lanes of graded values up to 3999,
    # every strip in byte planes
    graded = torch.randint(0, 4000, (64, 256), device=dev, generator=gen, dtype=torch.int32)
    graded *= (torch.rand(64, 256, device=dev, generator=gen) < 0.35).to(torch.int32)
    same = torch.equal(spike_matmul(graded, w), spike_matmul_plain(graded, w))
    check(same, "spike_matmul graded tick != plain")
    print(
        f"kernel spike_matmul [64,256]x[256,128] graded (an int32 serving tick, byte planes): "
        f"bit-identical to plain, {time_ms(lambda: spike_matmul(graded, w)):.5f} ms"
    )
    key = (25600, 256, 128)
    r = rows[key]
    check(
        r["ms"] < SPIKE_INT32_FLOOR_MS,
        f"spike_matmul {key}: {r['ms']:.5f} ms is not under the CUDA cores' int32 floor "
        f"{SPIKE_INT32_FLOOR_MS:.5f} ms, so the tensor-core route was not taken",
    )
    s = main[key]
    return dict(
        name="spike_matmul",
        shape="[25600,256]x[256,128] int32, binary x w6",
        replaces="src/repro/kernels/quant_matmul/spike_matmul.py:47",
        max_abs_err=err,
        ms=r["ms"],
        plain_ms=time_ms(lambda: spike_matmul_plain(s, w), reps=5, inner=2),
        library_ms=r["library_ms"],
        bound_ms=r["bound_ms"],
        bound_by=r["bound_by"],
    )


def check_lif_scan(gen) -> dict:
    err = 0
    shapes = [(25, 1024, 128), (25, 1024, 10)]
    modes = [(243, False), (256, False), (243, True), (256, True)]  # LIF/IF x subtract/zero
    currents = {}
    for T, B, N in shapes:
        cur = torch.randint(-300, 400, (T, B, N), device=DEVICE, generator=gen, dtype=torch.int32)
        currents[N] = cur
        for k, zero in modes:
            s1, u1 = lif_scan(cur, theta_q=496, decay_k=k, u_bits=16, reset_to_zero=zero)
            s2, u2 = lif_scan_ref(cur, 496, k, 16, zero)
            torch.cuda.synchronize()
            err = max(err, max_abs_err(s1, s2), max_abs_err(u1, u2))
            check(torch.equal(s1, s2) and torch.equal(u1, u2), f"lif_scan {T},{B},{N} k={k}")
    cur = currents[128]
    T, B, N = cur.shape
    taps = bin(243).count("1")
    b_ms, b_by = bound(4 * (2 * T * B * N + B * N), T * B * N * (12 + 2 * taps), INT32_OPS_S)
    # the kernel alone: theta and the register already on the card, as the
    # population sweep passes them (a single window is the case P = 1)
    regs = [torch.tensor([v], dtype=torch.int32, device=DEVICE) for v in (496, 243)]
    kw = dict(theta_q=regs[0], decay_k=regs[1], u_bits=16, reset_to_zero=False)
    ms = time_ms(lambda: lif_scan(cur[None], **kw))
    # the scalar call as FusedBackend makes it (theta a device scalar, the
    # register an int): the kernel and the fill of the register
    kw_fused = dict(theta_q=regs[0][0], decay_k=243, u_bits=16, reset_to_zero=False)
    print(
        f"lif_scan [{T},{B},{N}] scalar call (theta a device scalar, register an int): "
        f"{time_ms(lambda: lif_scan(cur, **kw_fused)):.5f} ms device, "
        f"{stream_ms(lambda: lif_scan(cur, **kw_fused)):.5f} ms per call back to back; "
        f"the kernel alone {ms:.5f} ms"
    )
    return dict(
        name="lif_scan",
        shape=f"[{T},{B},{N}] int32, LIF k=243",
        replaces="src/repro/kernels/lif_scan/lif_scan.py:64",
        max_abs_err=err,
        ms=ms,
        plain_ms=time_ms(lambda: lif_scan_ref(cur, 496, 243, 16, False), reps=5, inner=2),
        library_ms=None,
        bound_ms=b_ms,
        bound_by=b_by,
    )


def phase3_events() -> tuple[torch.Tensor, int]:
    """Layer 0's input raster of phase 3 (mnist_like, 1024 samples x T = 25,
    flattened to [25600, 256]) and the event budget the pallas event backend
    measures for it."""
    ds = mnist_like(n=1024, T=25, seed=1)
    flat = raster_tensor(ds.spikes.transpose(1, 0, 2), DEVICE).reshape(-1, ds.spikes.shape[2])
    k_max = int((flat != 0).sum(-1).max())
    return flat, EventBackend(strategy="pallas").static_budget(flat.shape[1], k_max=k_max)


def check_sparse_accum(gen, w0) -> dict:
    """Bit for bit against plain and the dense product on binary, graded,
    over-budget and unsorted event lists at the serving shape (E = 2048);
    timed there and at phase 3's E = 25600 beside ``embedding_bag`` and the
    bound, with the encoder's time beside it at E = 2048."""
    E, n_in = 32 * 64, 256
    budget = BINARY_SERVE_BUDGET
    binary = (torch.rand(E, n_in, device=DEVICE, generator=gen) < 0.10).to(torch.int32)
    levels = torch.randint(1, 40, (E, n_in), device=DEVICE, generator=gen, dtype=torch.int32)
    graded = binary * levels
    over = (torch.rand(E, n_in, device=DEVICE, generator=gen) < 0.40).to(torch.int32)
    err = 0
    for name, raster in (("binary", binary), ("graded", graded), ("over-budget", over)):
        vals, idx = fixed_capacity_events(raster, budget)
        got, want = sparse_accum(vals, idx, w0), sparse_accum_ref(vals, idx, w0)
        torch.cuda.synchronize()
        err = max(err, max_abs_err(got, want))
        check(torch.equal(got, want), f"sparse_accum {name} != plain")
    check(int((binary != 0).sum(-1).max()) <= budget, "binary rows fit the budget")
    # the same events in each row's slots shuffled: zeros between events
    vals, idx = fixed_capacity_events(graded, budget)
    perm = torch.rand(E, budget, device=DEVICE, generator=gen).argsort(dim=1)
    sv, si = vals.gather(1, perm).contiguous(), idx.gather(1, perm).contiguous()
    got = sparse_accum(sv, si, w0)
    check(torch.equal(got, sparse_accum_ref(sv, si, w0)), "sparse_accum unsorted != plain")
    check(torch.equal(got, spike_matmul(graded, w0)), "sparse_accum unsorted != dense")
    vals, idx = fixed_capacity_events(binary, budget)
    check(torch.equal(sparse_accum(vals, idx, w0), spike_matmul(binary, w0)), "sparse != dense")

    flat, budget3 = phase3_events()
    v3, i3 = fixed_capacity_events(flat, budget3)
    check(torch.equal(sparse_accum(v3, i3, w0), spike_matmul(flat, w0)), "phase-3 events != dense")
    N = w0.shape[1]
    rows = {}
    for (vals, idx) in ((vals, idx), (v3, i3)):
        Ex, K = vals.shape
        fw, fv, li = w0.to(torch.float32), vals.to(torch.float32), idx.to(torch.int64)
        lib = lambda: torch.nn.functional.embedding_bag(li, fw, per_sample_weights=fv, mode="sum")
        same = torch.equal(lib().to(torch.int32), sparse_accum(vals, idx, w0))
        check(same, "embedding_bag != kernel")
        nnz = int((vals != 0).sum())
        b_ms, b_by = bound(4 * (2 * Ex * K + n_in * N + Ex * N), 2 * nnz * N, INT32_OPS_S)
        r = rows[Ex] = dict(
            shape=f"E={Ex} K={K} [{n_in},{N}] int32, {nnz} events",
            ms=time_ms(lambda: sparse_accum(vals, idx, w0)),
            library_ms=time_ms(lib),
            bound_ms=b_ms,
            bound_by=b_by,
        )
        print(
            f"kernel sparse_accum {r['shape']}: {r['ms']:.5f} ms, {share(b_ms, r['ms'])} of the "
            f"bound {b_ms:.5f} ms ({b_by}); library {r['library_ms']:.5f} ms (embedding_bag, f32)"
        )
    enc_ms = time_ms(lambda: fixed_capacity_events(binary, budget))
    print(
        f"sparse serving tick at E={E}: encoder fixed_capacity_events {enc_ms:.5f} ms + "
        f"sparse_accum {rows[E]['ms']:.5f} ms of device time"
    )
    vals, idx = fixed_capacity_events(binary, budget)
    return dict(
        name="sparse_accum",
        shape=rows[E]["shape"],
        replaces="src/repro/kernels/sparse_accum/sparse_accum.py:54",
        max_abs_err=err,
        ms=rows[E]["ms"],
        plain_ms=time_ms(lambda: sparse_accum_ref(vals, idx, w0), reps=5, inner=2),
        library_ms=rows[E]["library_ms"],
        bound_ms=rows[E]["bound_ms"],
        bound_by=rows[E]["bound_by"],
    )


# quant_matmul: the bf16 tolerance of tests/test_kernels.py -- the kernel
# accumulates in f32 in another K order than its plain version, and a
# near-tie lands up to 2 bf16 ulps apart after the final cast.
QM_TOL = dict(rtol=2**-7, atol=1e-5)
# flash_attention keeps scores, probabilities and the accumulator in f32 like
# its plain version, so bf16 outputs differ by at most one rounding of the
# final cast: one ulp, <= 2^-7 |want|.  The atol, for values near zero, is
# far below the typical |output| of a 4096-key causal row (~0.02), so
# near-zero or mis-weighted rows fail; each case also shows that planted
# faults fall outside it.  f32: the same math in another order.
FA_TOL = dict(rtol=2**-7, atol=2e-3)
FA_TOL_F32 = dict(rtol=1e-4, atol=1e-4)


def tol_used(got: torch.Tensor, want: torch.Tensor, tol: dict) -> float:
    """max |got - want| / (atol + rtol |want|): at most 1 within the tolerance."""
    got, want = got.float(), want.float()
    return float(((got - want).abs() / (tol["atol"] + tol["rtol"] * want.abs())).max())


def close(got: torch.Tensor, want: torch.Tensor, tol: dict, what: str) -> float:
    err = float((got.float() - want.float()).abs().max()) if got.numel() else 0.0
    used = tol_used(got, want, tol) if got.numel() else 0.0
    ok = used <= 1 and bool(torch.isfinite(got).all())
    check(ok, f"{what}: max_abs_err {err} ({used:.3f} of the tolerance {tol})")
    return err


# (count per layer, K, N) of the LM's quantized matmuls: wq wk wv wo, w_gate
# w_up, w_down of stablelm-1.6b (d_model 2048, d_ff 5632)
LM_QDOTS = [(4, 2048, 2048), (2, 2048, 5632), (1, 5632, 2048)]
QDOTS_PER_LAYER = sum(n for n, _, _ in LM_QDOTS)
# the wide route's longest chains on the main path: jamba's 4096-token
# prefill (out_proj K = 8192, the experts' w_down K = 14336), int8
LONG_K_WIDE = [(4096, 8192, 4096), (4096, 14336, 4096)]


def check_quant_matmul(gen, n_layers: int) -> dict:
    """int8 and int4 at every full-width shape of the LM path -- decode
    (M = max_batch = 8) and prefill (M = 4096) -- and one ragged shape, and
    int8 at the wide route's longest K (``LONG_K_WIDE``); each
    main-path shape timed (decode shapes with weights cold in L2), and the
    kernel time of one decode step and of one prefill derived from those
    times and the launch counts."""
    dev = DEVICE
    shapes = [(M, K, N) for M in (8, 4096) for _, K, N in LM_QDOTS] + [(5, 96, 24)]
    err = 0.0
    cases = {}
    for bits in (8, 4):
        for M, K, N in shapes:
            w = torch.randn(K, N, device=dev, generator=gen) * K**-0.5
            x = torch.randn(M, K, device=dev, generator=gen).to(torch.bfloat16)
            qt = quantize_weight(w, bits)
            got = quant_matmul(x, qt.q, qt.scale, bits=bits)
            want = quant_matmul_ref(x, qt.q, qt.scale, bits, torch.bfloat16)
            torch.cuda.synchronize()
            err = max(err, close(got, want, QM_TOL, f"quant_matmul int{bits} [{M},{K}]x[{K},{N}]"))
            cases[(bits, M, K, N)] = (x, qt)
    long_k = []
    for M, K, N in LONG_K_WIDE:
        w = torch.randn(K, N, device=dev, generator=gen) * K**-0.5
        x = torch.randn(M, K, device=dev, generator=gen).to(torch.bfloat16)
        qt = quantize_weight(w, 8)
        got = quant_matmul(x, qt.q, qt.scale, bits=8)
        want = quant_matmul_ref(x, qt.q, qt.scale, 8, torch.bfloat16)
        torch.cuda.synchronize()
        err = max(err, close(got, want, QM_TOL, f"quant_matmul int8 [{M},{K}]x[{K},{N}]"))
        long_k.append(f"[{M},{K}]x[{K},{N}] {tol_used(got, want, QM_TOL):.4f}")
        cases[(8, M, K, N)] = (x, qt)
    print(f"quant_matmul int8 at the wide route's longest K, share of QM_TOL used: {', '.join(long_k)}")
    # the same call twice gives the same bits (no float atomics, a fixed
    # order of the split-K sum); a wide call's rows do not depend on M
    # (phase 7 needs it of the layer-0 K/V cache)
    for (bits, M, K, N), (x, qt) in cases.items():
        if M < 8:
            continue
        a, b = (quant_matmul(x, qt.q, qt.scale, bits=bits) for _ in range(2))
        shape = f"int{bits} [{M},{K}]x[{K},{N}]"
        check(torch.equal(bits16(a), bits16(b)), f"quant_matmul {shape}: two launches differ")
        if M == 4096:
            part = quant_matmul(x[:256].contiguous(), qt.q, qt.scale, bits=bits)
            same = torch.equal(bits16(part), bits16(a[:256]))
            check(same, f"quant_matmul {shape}: rows of M = 256 differ from M = 4096's")
    torch.cuda.synchronize()
    print(
        "quant_matmul: two launches bit-identical at the 6 main-path shapes, int8 and int4, and "
        "at the 2 long-K shapes; at the 5 prefill shapes the rows of M = 256 equal the first "
        "256 of M = 4096 bit for bit"
    )
    rows = {}
    for M, K, N in shapes[:-1]:
        x, qt = cases[(8, M, K, N)]
        x4, qt4 = cases[(4, M, K, N)]
        wd = dequantize_weight(qt, torch.bfloat16)  # the library call's weight, prepared beforehand
        reps = dict(reps=15, inner=10) if M <= 8 else dict(reps=7, inner=3)
        # a decode step reads each layer's weights once, so they come from
        # device memory, not L2: decode shapes cycle through copies of the
        # weights that together exceed twice the L2 (int4: half the bytes)
        n = 1 if M > 8 else -(-4 * L2_BYTES // (K * N))
        q8 = itertools.cycle([(qt.q.clone(), qt.scale.clone()) for _ in range(n)]).__next__
        q4 = itertools.cycle([(qt4.q.clone(), qt4.scale.clone()) for _ in range(n)]).__next__
        wds = itertools.cycle([wd.clone() for _ in range(n)]).__next__
        ops = 2 * M * K * N
        n_bytes = {b: 2 * M * K + K * N * b // 8 + 4 * N + 2 * M * N for b in (8, 4)}
        b_ms, b_by = bound(n_bytes[8], ops, BF16_TC_FLOPS)
        b4_ms, b4_by = bound(n_bytes[4], ops, BF16_TC_FLOPS)
        r = rows[(M, K, N)] = dict(
            stream_ms=stream_ms(lambda: quant_matmul(x, *q8(), bits=8), **reps),
            ms=time_ms(lambda: quant_matmul(x, *q8(), bits=8), **reps),
            int4_ms=time_ms(lambda: quant_matmul(x4, *q4(), bits=4), **reps),
            plain_ms=time_ms(lambda: quant_matmul_ref(x, *q8(), 8, torch.bfloat16), **reps),
            library_ms=time_ms(lambda: torch.matmul(x, wds()), **reps),
            bound_ms=b_ms,
            bound_by=b_by,
        )
        del q8, q4, wds

        def rate(ms, bits, by, b):
            if by == "bytes":
                got = f"{n_bytes[bits] / ms / 1e6:.1f} GB/s"
            else:
                got = f"{ops / ms / 1e9:.1f} TFLOP/s"
            return f"{got}, {b / ms:.4f} of the bound"

        print(
            f"kernel quant_matmul [{M},{K}]x[{K},{N}] bf16 x int8"
            f"{' (weights cold in L2)' * (n > 1)}: "
            f"{r['ms']:.5f} ms ({rate(r['ms'], 8, b_by, b_ms)}; {r['stream_ms']:.5f} ms a call "
            f"back to back on the stream, host gaps included) "
            f"(int4 {r['int4_ms']:.5f} ms: {rate(r['int4_ms'], 4, b4_by, b4_ms)}, bound "
            f"{b4_ms:.5f} ms), plain {r['plain_ms']:.5f} ms, library "
            f"{r['library_ms']:.5f} ms (bf16 matmul of the dequantized weight), bound "
            f"{r['bound_ms']:.5f} ms ({r['bound_by']})"
        )
    for M, what in ((8, "decode step"), (4096, "4096-token prefill")):
        per = {k: n_layers * sum(n * rows[(M, K, N)][k] for n, K, N in LM_QDOTS)
               for k in ("ms", "int4_ms", "library_ms", "bound_ms")}
        print(
            f"quant_matmul time of one {what} ({n_layers} layers x {QDOTS_PER_LAYER} launches, "
            f"from the times above): "
            f"int8 {per['ms']:.4f} ms, int4 {per['int4_ms']:.4f} ms, library "
            f"{per['library_ms']:.4f} ms, bound {per['bound_ms']:.4f} ms"
        )
    main = rows[(8, 2048, 5632)]  # a decode shape: the main path launches these most
    return dict(
        name="quant_matmul",
        shape="[8,2048]x[2048,5632] bf16 x int8 (decode); int8 and int4 checked at 7 shapes",
        replaces="src/repro/kernels/quant_matmul/quant_matmul.py:74",
        max_abs_err=err,
        **{k: main[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")},
    )


def check_flash_attention(gen, n_layers: int) -> dict:
    """[1, 32, 4096, 64] causal (the full-width prefill) in bf16 and f32, a
    window + softcap case whose scores the cap bends, a ragged Sq = 300 case
    and a GQA case through ``flash_attend``; in each bf16 case the plain
    version with a planted fault must fall outside the tolerance."""
    dev = DEVICE
    mk = lambda *shape: torch.randn(*shape, device=dev, generator=gen).to(torch.bfloat16)
    err = 0.0
    S = 4096
    cases = [
        # scores ~ N(0, 1)
        ((1, 32, S, 64), 1.0, dict(causal=True), dict(
            scale_x2=dict(causal=True, scale=2 / 8),
            keys_past_S_minus_64_dropped=dict(causal=True, window=S - 64),
            zero_output=None,
        )),
        # q x 8: scores ~ N(0, 64), where 30 tanh(s / 30) bends them
        ((1, 8, 1024, 64), 8.0, dict(causal=True, window=64, softcap=30.0), dict(
            no_softcap=dict(causal=True, window=64),
            no_window=dict(causal=True, softcap=30.0),
        )),
        ((2, 4, 300, 64), 1.0, dict(causal=True), dict(not_causal=dict(causal=False))),
    ]
    used = {}
    main = None
    for shape, q_mult, kw, faults in cases:
        q, k, v = (mk(*shape) * q_mult).to(torch.bfloat16), mk(*shape), mk(*shape)
        got = flash_attention(q, k, v, **kw)
        want = flash_attention_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        what = f"flash_attention {shape} {kw}"
        err = max(err, close(got, want, FA_TOL, what))
        used[what] = [tol_used(got, want, FA_TOL)]
        for fault, fkw in faults.items():
            wrong = torch.zeros_like(want) if fkw is None else flash_attention_ref(q, k, v, **fkw)
            used[what].append(tol_used(wrong, want, FA_TOL))
            check(used[what][-1] > 1, f"{what}: planted fault {fault} passes the tolerance")
        main = main or (q, k, v)
    q, k, v = main
    got32 = flash_attention(q.float(), k.float(), v.float(), causal=True)
    want32 = flash_attention_ref(q.float(), k.float(), v.float(), causal=True)
    torch.cuda.synchronize()
    close(got32, want32, FA_TOL_F32, "flash_attention f32 [1,32,4096,64] causal")
    f32_used = tol_used(got32, want32, FA_TOL_F32)
    del got32, want32
    q, k, v = mk(1, 1024, 32, 64), mk(1, 1024, 8, 64), mk(1, 1024, 8, 64)  # [B, S, H, D]
    got = flash_attend(q, k, v, causal=True)
    want = attend(q, k, v, mask=AttnMask(causal=True))
    torch.cuda.synchronize()
    err = max(err, close(got, want, FA_TOL, "flash_attend GQA 32/8 heads"))
    # the classic GQA slip: query head h read from kv head h % 8, not h // 4
    wrong = attend(q, k.repeat(1, 1, 4, 1), v.repeat(1, 1, 4, 1), mask=AttnMask(causal=True))
    gqa = used["flash_attend GQA 32/8 heads"] = [tol_used(x, want, FA_TOL) for x in (got, wrong)]
    check(gqa[-1] > 1, "GQA: planted head map passes the tolerance")
    print(
        f"flash_attention checks, tolerance used by the kernel, then by each planted fault "
        f"(> 1 fails): {json.dumps({w: [round(u, 4) for u in x] for w, x in used.items()})}; "
        f"f32 [1,32,4096,64] causal within {FA_TOL_F32} ({f32_used:.4f} of it)"
    )

    q, k, v = main
    a, b = (flash_attention(q, k, v, causal=True) for _ in range(2))
    check(torch.equal(bits16(a), bits16(b)), "flash_attention [1,32,4096,64]: two launches differ")
    del a, b
    B, H, S, D = q.shape
    ops = 4 * B * H * D * (S * (S + 1) // 2)  # QK^T and PV over the causal pairs only
    b_ms, b_by = bound(4 * q.numel() * 2, ops, BF16_TC_FLOPS)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    row = dict(
        name="flash_attention",
        shape=f"[{B},{H},{S},{D}] bf16 causal",
        replaces="src/repro/kernels/flash_attention/flash_attention.py:77",
        max_abs_err=err,
        ms=time_ms(lambda: flash_attention(q, k, v, causal=True), reps=7, inner=3),
        plain_ms=time_ms(lambda: flash_attention_ref(q, k, v, causal=True), reps=5, inner=2),
        library_ms=time_ms(lambda: sdpa(q, k, v, is_causal=True)),
        bound_ms=b_ms,
        bound_by=b_by,
    )
    print(
        f"flash_attention [1,32,4096,64] bf16 causal: two launches bit-identical; "
        f"{ops / row['ms'] / 1e9:.1f} TFLOP/s, {b_ms / row['ms']:.4f} of the bound; time of one "
        f"4096-token prefill ({n_layers} launches): "
        f"{n_layers * row['ms']:.4f} ms, library {n_layers * row['library_ms']:.4f} ms, "
        f"bound {n_layers * b_ms:.4f} ms"
    )
    # Whisper's encoder: non-causal, 16 heads, D = 64, at 4096 and 32768 frames
    for S, reps in ((4096, dict(reps=7, inner=3)), (32_768, dict(reps=3, inner=1))):
        q, k, v = mk(1, 16, S, 64), mk(1, 16, S, 64), mk(1, 16, S, 64)
        nc_ops = 4 * 16 * S * S * 64
        nc_ms, nc_by = bound(4 * q.numel() * 2, nc_ops, BF16_TC_FLOPS)
        ms = time_ms(lambda: flash_attention(q, k, v, causal=False), **reps)
        lib = time_ms(lambda: sdpa(q, k, v, is_causal=False), **reps)
        # the plain version materialises 16 x S^2 f32 scores: 1.07 GB at 4096, 69 GB at 32768
        plain = (f"{time_ms(lambda: flash_attention_ref(q, k, v, causal=False), reps=3, inner=2):.5f}"
                 if S <= 4096 else "not measured (its 69 GB of scores do not fit)")
        print(
            f"kernel flash_attention [1,16,{S},64] bf16 non-causal: {ms:.5f} ms "
            f"({nc_ops / ms / 1e9:.1f} TFLOP/s, {nc_ms / ms:.4f} of the bound), plain {plain} ms, "
            f"library {lib:.5f} ms (scaled_dot_product_attention, is_causal=False), bound "
            f"{nc_ms:.5f} ms ({nc_by})"
        )
        del q, k, v
    return row


# ---------------------------------------------------------------------------
# Phases 3-5: the main path
# ---------------------------------------------------------------------------

# the sizes each SNN kernel is launched with, as its C entry point takes
# them (positions among its int arguments): spike_matmul (M, K, N, batch,
# s_batched, w_batched), sparse_accum (E, K, n_in, N), lif_scan (P, T, B*N)
TALLY_INTS = {
    "spike_matmul": (0, 1, 2, 6, 7, 8),
    "sparse_accum": (0, 1, 2, 3),
    "lif_scan": (0, 1, 2),
}
_SIZES = {"open": False, "tally": collections.Counter()}


@contextlib.contextmanager
def launch_sizes():
    """Count the SNN kernels' launches by size between :func:`reset_counts`
    and :func:`read_counts`: the wrappers look ``build.entry`` up at every
    call, so wrapping it sees each launch (their own counts are unchanged)."""
    real = build.entry

    def entry(name, symbol, n_pointers, n_ints, n_floats=0):
        fn = real(name, symbol, n_pointers, n_ints, n_floats)
        if name not in TALLY_INTS:
            return fn

        def launch(*args):
            if _SIZES["open"]:
                ints = args[n_pointers:]
                _SIZES["tally"][(name, tuple(ints[i] for i in TALLY_INTS[name]))] += 1
            return fn(*args)

        return launch

    with mock.patch.object(build, "entry", entry):
        yield _SIZES["tally"]
    _SIZES["open"] = False


def reset_counts() -> None:
    """Set every kernel's launch count to 0 and (re)start the size tally."""
    kernels.reset_launch_counts()
    _SIZES["tally"].clear()
    _SIZES["open"] = True


def read_counts() -> dict[str, int]:
    """The wrappers' launch counts; closes the size tally at the same moment,
    so both cover the same launches."""
    _SIZES["open"] = False
    return kernels.launch_counts()


def assert_records_equal(a, b, what: str) -> None:
    """Two records equal field by field, on whichever devices they lie."""
    check(torch.equal(a.spike_counts.cpu(), b.spike_counts.cpu()), f"{what}: spike_counts")
    check(len(a.layer_spikes) == len(b.layer_spikes), f"{what}: layer count")
    for x, y in zip(a.layer_spikes, b.layer_spikes):
        check(torch.equal(x.cpu(), y.cpu()), f"{what}: layer_spikes")
    check(torch.equal(a.input_events.cpu(), b.input_events.cpu()), f"{what}: input_events")


def phase_run_int(net, qparams, qparams_cpu) -> dict:
    ds = mnist_like(n=1024, T=25, seed=1)
    x = raster_tensor(ds.spikes.transpose(1, 0, 2), DEVICE)
    recs = {
        name: run_int(net, qparams, x, backend=b)
        for name, b in [
            ("reference", "reference"),
            ("fused", "fused"),
            ("event-pallas", EventBackend(strategy="pallas")),
        ]
    }
    torch.cuda.synchronize()
    counts = read_counts()
    ref = recs["reference"]
    check(ref.spike_counts.shape == (len(ds.labels), net.n_classes), "spike_counts shape")
    for name in ("fused", "event-pallas"):
        assert_records_equal(recs[name], ref, f"run_int {name} vs reference")
    cpu = run_int(net, qparams_cpu, x[:, :32].cpu(), backend="reference")
    check(torch.equal(cpu.spike_counts, ref.spike_counts[:32].cpu()), "card vs CPU on 32 samples")
    totals = [int(s.sum()) for s in ref.layer_spikes]
    check(totals[0] > 0, "hidden layer is silent")
    print(
        f"run_int: 3 backends bit-identical on {list(x.shape)}; input events "
        f"{int(ref.input_events.sum())}, layer spikes {totals}; card == CPU on 32 samples"
    )
    return counts


def phase_eval_int(net, qparams) -> dict:
    ds = mnist_like(n=4096, T=25, seed=2)
    results = {}
    for name, backend in [("fused", "fused"), ("event-pallas", EventBackend(strategy="pallas"))]:
        t0 = time.perf_counter()
        acc, stats = eval_int(
            net, qparams, ds, batch_size=4096, return_stats=True, backend=backend
        )
        dt = time.perf_counter() - t0
        results[name] = (acc, stats)
        n = len(ds.labels)
        print(f"eval_int[{name}]: acc {acc:.6f}, {n / dt:.1f} samples/s on the card ({dt:.4f} s)")
    counts = read_counts()
    (a0, s0), (a1, s1) = results.values()
    check(a0 == a1, "eval_int accuracy differs across backends")
    check(np.array_equal(s0["input_events_per_step"], s1["input_events_per_step"]), "input stats")
    for x, y in zip(s0["layer_events_per_step"], s1["layer_events_per_step"]):
        check(np.array_equal(x, y), "layer stats")
    mean_events = [float(e.mean()) for e in s0["layer_events_per_step"]]
    print(
        f"eval_int: fused == event-pallas; mean input events/step "
        f"{float(s0['input_events_per_step'].mean()):.4f}, layer events/step {mean_events}"
    )
    # where a 4096-sample batch's time goes (after the counts were read)
    for name, backend in [("fused", "fused"), ("event-pallas", EventBackend(strategy="pallas"))]:
        run = lambda: eval_int(net, qparams, ds, batch_size=4096, backend=backend)
        print(f"eval_int[{name}] batch split: {device_split(run, n=3)}")
    return counts


def serving_traffic(n_in: int) -> list[SNNRequest]:
    """256 ragged requests, admitted in this order: 80 sparse (~3%, the
    event-pallas route: a pool of only these runs sparse ticks), 160 dense
    mnist-like (more active channels a step than the budget: f32_exact
    ticks), 16 dense graded with values above the f32 certificate (int32
    ticks)."""
    rng = np.random.default_rng(7)
    dense_ds = mnist_like(n=160, T=25, seed=3, max_rate=0.6)
    reqs = []
    for _ in range(80):
        T = int(rng.integers(8, 26))
        reqs.append((rng.random((T, n_in)) < 0.03).astype(np.uint8))
    for i in range(160):
        reqs.append(dense_ds.spikes[i, : int(rng.integers(8, 26))])
    for _ in range(16):
        T = int(rng.integers(8, 26))
        on = rng.random((T, n_in)) < 0.35
        reqs.append(np.where(on, rng.integers(1, 4000, (T, n_in)), 0).astype(np.int32))
    return [SNNRequest(uid=i, raster=r) for i, r in enumerate(reqs)]


def dispatch_vs_tick(engine, wall: float) -> str:
    """The engine's own timers: host scheduling (dispatch rounds) against
    the lane-window calls (tick wall, the device->host copy of the outputs
    included), beside the run's wall."""
    m = engine.metrics
    return (
        f"dispatch {m.dispatch_s:.4f} s, tick {m.tick_s:.4f} s over {m.n_ticks} ticks "
        f"({1e3 * m.tick_s / max(1, m.n_ticks):.3f} ms a tick), the rest "
        f"{wall - m.dispatch_s - m.tick_s:.4f} s of {wall:.4f} s wall"
    )


def phase_serve(net, qparams, results: dict) -> dict:
    """Serve :func:`serving_traffic`; ``results`` gets each request's spike
    counts by uid (phase 11 serves the same traffic through a journal)."""
    engine = SNNServeEngine(
        net, qparams, max_batch=64, backend=EventBackend(strategy="pallas"), device=DEVICE
    )
    check(engine._event_budget == BINARY_SERVE_BUDGET, "serving event budget")
    engine.warmup(include_int32=True)
    reqs = serving_traffic(net.n_in)
    reset_counts()
    t0 = time.perf_counter()
    done = engine.run(reqs)
    wall = time.perf_counter() - t0
    counts = read_counts()
    check(len(done) == len(reqs) and all(r.status == "completed" for r in done), "all served")
    results.update((r.uid, r.spike_counts) for r in done)
    hidden_events = sum(float(r.event_stats["layer_events_per_step"][0].sum()) for r in done)
    check(hidden_events > 0, "the hidden layer never fired while serving")
    snap = engine.metrics.snapshot()
    counters = snap["counters"]
    for r in done:
        x = torch.from_numpy(r.raster.astype(np.int32)[:, None, :]).to(DEVICE)
        rec = run_int(net, qparams, x, backend="reference")
        same = np.array_equal(r.spike_counts, rec.spike_counts[0].cpu().numpy())
        for got, want in zip(r.event_stats["layer_events_per_step"], rec.layer_spikes):
            same = same and np.array_equal(got, want[:, 0].cpu().numpy())
        check(same, f"request {r.uid} ({r.route}) differs from serial run_int")
    routes = {k[6:]: v for k, v in counters.items() if k.startswith("route:")}
    ticks = {k[5:]: v for k, v in counters.items() if k.startswith("tick:")}
    for mode in ("sparse", "f32_exact", "int32"):
        check(ticks.get(mode, 0) > 0, f"no {mode} tick was served")
    lat = snap["latency"]["all"]
    print(
        f"serve: {len(done)} requests bit-exact with serial run_int; routes {routes}; "
        f"ticks {ticks}; hidden-layer events {hidden_events:.0f}; "
        f"p50 {lat['p50_ms']:.3f} ms, p99 {lat['p99_ms']:.3f} ms; "
        f"{len(done) / wall:.1f} samples/s ({wall:.3f} s)"
    )
    print(f"serve: {dispatch_vs_tick(engine, wall)}")
    return counts


# ---------------------------------------------------------------------------
# Phases 6-8: LM serving at full width
# ---------------------------------------------------------------------------

LM_ARCH = "stablelm-1.6b"


def lm_policy(bits: int) -> PrecisionPolicy:
    return PrecisionPolicy(rules=((QUANT_RULES[0], bits),))


def lm_requests(n: int, max_new: int, vocab: int, max_prompt: int = 32) -> list[Request]:
    """Prompts of 4-``max_prompt`` tokens over the full vocab; request 9
    repeats request 0's prompt, so with 8 slots the two land in different
    waves."""
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, vocab, int(rng.integers(4, max_prompt + 1))) for _ in range(n)]
    if n > 9:
        prompts[9] = prompts[0].copy()
    return [Request(uid=i, prompt=p, max_new_tokens=max_new) for i, p in enumerate(prompts)]


def profiled(fn, n: int) -> tuple[float, float, list]:
    """``fn`` once, then ``n`` calls under torch.profiler: wall and
    device-busy milliseconds per call, and the device-side entries (kernels,
    copies: no time is counted twice)."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / n
    events = [
        e for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
    ]
    return wall_ms, sum(e.self_device_time_total for e in events) / 1e3 / n, events


def device_split(fn, n: int = 5, top: int = 4, width: int = 40) -> str:
    """Wall vs device-busy time of ``n`` calls of ``fn`` under torch.profiler,
    and the ``top`` kernels that took the most device time (names cut to
    ``width`` characters)."""
    wall_ms, busy_ms, events = profiled(fn, n)
    if not events:
        return f"wall {wall_ms:.3f} ms per call; device time not measured (the profiler saw none)"
    items = sorted(events, key=lambda e: -e.self_device_time_total)[:top]
    names = ", ".join(
        f"{e.key[:width]} {e.self_device_time_total / 1e3 / n:.3f} ms ({e.count / n:g} launches)"
        for e in items
    )
    return (
        f"wall {wall_ms:.3f} ms per call (under the profiler), device busy {busy_ms:.3f} ms "
        f"({100 * (1 - busy_ms / wall_ms):.1f} % idle); top kernels per call: {names}"
    )


# a request's logits, served in a batch, against a serial decode of its
# prompt alone: both run every operation at the same shapes, row for row, so
# the rows should agree to float reordering at most; 1e-3 of max |logit|
# must lie below what another prompt's row differs by (checked and printed)
SERIAL_TOL = 1e-3
SERIAL_UIDS = (0, 5, 9, 13)  # request 9 repeats request 0's prompt


@contextlib.contextmanager
def record_logits(engine: ServeEngine, uids):
    """Wrap ``engine``'s decode step, admission and tick while the block runs
    so that each request in ``uids`` keeps its slot and the logits row that
    chose each of its generated tokens (a device copy per token); yields
    (rows, slot_of)."""
    rows, slot_of, last = {u: [] for u in uids}, {}, {}
    decode, admit, tick = engine._decode, engine.admit, engine.tick

    def _decode(tokens):
        last["logits"] = decode(tokens)
        return last["logits"]

    def _admit(req):
        ok = admit(req)
        if ok and req.uid in rows:
            slot_of[req.uid] = next(i for i, r in enumerate(engine.slots) if r is req)
            rows[req.uid].append(last["logits"][slot_of[req.uid], -1].clone())
        return ok

    def _tick():
        live = [(i, r) for i, r in enumerate(engine.slots) if r is not None and r.uid in rows]
        finished = tick()
        for i, r in live:
            rows[r.uid].append(last["logits"][i, -1].clone())
        return finished

    engine._decode, engine.admit, engine.tick = _decode, _admit, _tick
    try:
        yield rows, slot_of
    finally:
        del engine._decode, engine.admit, engine.tick  # the class's methods again


def serial_decode(engine: ServeEngine, req: Request, slot: int) -> list[torch.Tensor]:
    """Greedy decode of one prompt alone through ``decode_step`` on the
    engine's weights: fresh caches, the prompt in ``slot`` of
    ``engine.max_batch`` (the other slots idle at length 0), so every
    operation runs at the batched run's shapes.  Returns the logits row that
    chose each generated token."""
    B = engine.max_batch
    caches = tfm.cache_init(engine.cfg, B, engine.max_len, DEVICE)
    cur = torch.zeros(B, dtype=torch.int32, device=DEVICE)
    tok = torch.zeros(B, 1, dtype=torch.int64, device=DEVICE)
    feed, rows = [int(t) for t in req.prompt], []
    while len(rows) < req.max_new_tokens:
        for t in feed:
            tok[slot, 0] = t
            logits, caches = tfm.decode_step(engine.cfg, engine.params, caches, tok, cur)
            cur[slot] += 1
        rows.append(logits[slot, -1].clone())
        feed = [int(rows[-1].argmax())]
    return rows


def qdots_per_step(qparams) -> int:
    """``quant_matmul`` launches of one decode step, from the quantized
    tree: each stacked QTensor leaf [groups, K, N] runs once a group."""
    return sum(t.shape[0] for _, t in tree_leaves(qparams) if isinstance(t, QTensor))


def phase_lm_decode(
    arch, params, bits: int, n_requests: int, max_new: int, qdots: int,
    *, check_plain: bool = False, max_prompt: int = 32, smi: str = "",
) -> dict:
    """Serve ``n_requests`` (prompts of 4-``max_prompt`` tokens) through
    ``ServeEngine(max_batch=8, max_len=256)`` on ``arch.config``; ``qdots``
    quantized products a decode step (checked against the quantized tree).
    At int8, sampled requests against a serial decode of their prompt alone.
    ``check_plain``: every ``quant_matmul`` launch of the run against its
    plain version; the recording slows that pass, so the same traffic is
    then served again with nothing recorded, and that pass is the one timed
    (it must take the same steps and serve the same tokens)."""
    full = dataclasses.replace(arch, reduced_config=arch.config)
    engine = ServeEngine(
        full, params, max_batch=8, max_len=256, quant=lm_policy(bits), device=DEVICE
    )
    check(qdots_per_step(engine.params) == qdots, f"int{bits}: {qdots} quantized products a step")
    reqs = lm_requests(n_requests, max_new, arch.config.vocab, max_prompt)
    uids = [u for u in SERIAL_UIDS if u < n_requests] if bits == 8 else []
    with record_logits(engine, uids) as (rows, slot_of), (
        recorded_quant_matmul() if check_plain else contextlib.nullcontext([])
    ) as seen:
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = engine.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
    steps = engine.decode_steps
    check(len(done) == n_requests and all(r.done for r in done), f"int{bits}: all served")
    check(all(len(r.generated) == max_new for r in done), f"int{bits}: token counts")
    vocab = arch.config.vocab
    check(all(0 <= t < vocab for r in done for t in r.generated), f"int{bits}: tokens in vocab")
    check(counts["quant_matmul"] == qdots * steps, f"int{bits}: quant_matmul launches")
    check(counts["flash_attention"] == 0, f"int{bits}: decode launches no flash attention")
    by_uid = {r.uid: r.generated for r in done}
    if n_requests > 9:
        check(by_uid[0] == by_uid[9], "requests 0 and 9 (one prompt, two waves) differ")
    how = ""
    if check_plain:
        again = lm_requests(n_requests, max_new, vocab, max_prompt)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        redo = engine.run(again)
        torch.cuda.synchronize()
        how = f" (the timed pass, nothing recorded; the checked pass {wall:.3f} s)"
        wall = time.perf_counter() - t0
        check(engine.decode_steps == 2 * steps, f"int{bits}: the timed pass took other steps")
        check({r.uid: r.generated for r in redo} == by_uid,
              f"int{bits}: the timed pass served other tokens")
    toks = sum(len(r.generated) for r in done)
    prompt_toks = sum(len(r.prompt) for r in reqs)
    first = {r.uid: r.generated[0] for r in done}
    print(
        f"lm decode int{bits}: {arch.name} full width, {n_requests} requests ({prompt_toks} "
        f"prompt tokens, prefilled token by token), {toks} generated; {steps} decode steps in "
        f"{wall:.3f} s{how} = {1e3 * wall / steps:.3f} ms/step, {toks / wall:.1f} generated "
        f"tok/s, {(toks + prompt_toks) / wall:.1f} tok/s with prefill; req0 {by_uid[0][:6]}...; "
        f"{len(set(first.values()))} distinct first tokens over "
        f"{len({tuple(r.prompt.tolist()) for r in reqs})} distinct prompts"
        f"{f'; on {smi}' if smi else ''}"
    )
    if check_plain:
        check(len(seen) == counts["quant_matmul"], f"int{bits}: recorded launches != counted")
        err = check_recorded_qm(seen, f"{arch.name} int{bits} serving")
        print(
            f"lm decode int{bits}: {arch.name}'s {len(seen)} quant_matmul launches = {qdots} x "
            f"{steps}, each within QM_TOL of plain (max_abs_err {err:.3e})"
        )
        del seen
    if uids:
        check_against_serial(engine, reqs, by_uid, rows, slot_of)
    if bits == 8:  # where one decode step's time goes (after the counts were read)
        split = device_split(lambda: engine._decode(engine.last_token))
        print(f"lm decode step split ({arch.name}): {split}{f'; on {smi}' if smi else ''}")
    return counts


def check_against_serial(engine, reqs, by_uid, rows, slot_of) -> None:
    """Each sampled request's logits and tokens, served in a batch, against a
    serial decode of its prompt alone; request 9 against request 0's serial
    decode.  Distinct prompts' rows must differ by more than the tolerance,
    so a slot mix-up or a lost cache column would fail."""
    serial = {}
    for u in rows:
        src = 0 if u == 9 else u
        if src not in serial:
            serial[src] = serial_decode(engine, reqs[src], slot_of[u])
    errs, spread = {}, {}
    for u, got_rows in rows.items():
        want_rows = serial[0 if u == 9 else u]
        check(len(got_rows) == len(want_rows) == len(by_uid[u]), f"request {u}: logits rows")
        err = 0.0
        for i, (g, w) in enumerate(zip(got_rows, want_rows)):
            scale = float(w.abs().max())
            err = max(err, float((g - w).abs().max()) / scale)
            top2 = w.topk(2).values
            if float(top2[0] - top2[1]) > 2 * SERIAL_TOL * scale:
                same = by_uid[u][i] == int(w.argmax())
                check(same, f"request {u}: token {i} differs from serial")
        errs[u] = err
        check(err <= SERIAL_TOL, f"request {u}: logits differ from a serial decode by {err:.3e}")
    first = {u: r[0] for u, r in serial.items()}
    for a, b in itertools.combinations(first, 2):
        d = float((first[a] - first[b]).abs().max()) / float(first[b].abs().max())
        spread[f"{a}-{b}"] = d
        check(d > SERIAL_TOL, f"requests {a} and {b}: distinct prompts, logits within {d:.3e}")
    print(
        f"lm decode int8 against serial decodes of requests {list(rows)} alone: max |logit| "
        f"error / max |logit| {json.dumps({u: float(f'{e:.3e}') for u, e in errs.items()})} "
        f"(limit {SERIAL_TOL}); first-token logits of distinct prompts differ by "
        f"{json.dumps({k: float(f'{d:.3e}') for k, d in spread.items()})}"
    )


# The 4096-token prefill's caches at positions [0, 256) against a 256-token
# prefill on plain ``attend``: per layer, max |difference| / the layer's max
# |value|.  Layer 0 comes before any attention, so it is bit for bit equal;
# later layers differ by bf16 rounding that compounds through the residual
# stream.  The same prefill is run again with a fault planted in the flash
# kernel's arguments; each must exceed the limit.  On an H100 the sound
# prefill reads 1.147e-2, a missing causal mask 1.753 and a 2x scale
# 2.743e-2 (the residual stream of a random model carries little of the
# attention output), so the limit sits between the sound and the 2x scale.
CACHE_TOL = 0.02
FLASH_FAULTS = {  # fault -> flash_attend's arguments with it
    "no causal mask": lambda q, kw: {**kw, "causal": False},
    "scale x2": lambda q, kw: {**kw, "scale": 2 * (kw["scale"] or q.shape[-1] ** -0.5)},
}


def cache_errs(caches, short, cfg) -> dict[str, list[float]]:
    L = cfg.n_layers
    errs = {}
    for name in ("k", "v"):
        got, want = caches["pos0"][name][:, :, :256].float(), short["pos0"][name].float()
        want_shape = (L, 1, 256, cfg.n_kv_heads, cfg.d_head)
        check(got.shape == want.shape == want_shape, f"prefill {name} cache shape")
        scale = want.abs().amax(dim=(1, 2, 3, 4))
        errs[name] = ((got - want).abs().amax(dim=(1, 2, 3, 4)) / scale).tolist()
    return errs


def phase_lm_prefill(arch, qparams) -> dict:
    prefill = arch.prefill_fn(arch.config)
    tokens = torch.from_numpy(np.random.default_rng(12).integers(0, arch.config.vocab, (1, 4096)))
    tokens = tokens.to(DEVICE)
    prefill(qparams, {"tokens": tokens[:, :8]})  # warm-up (S < 4096: no flash launch)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, caches = prefill(qparams, {"tokens": tokens})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    L = arch.config.n_layers
    check(counts["flash_attention"] == L, f"prefill: {L} flash_attention launches")
    check(counts["quant_matmul"] == QDOTS_PER_LAYER * L, "prefill: 7 quant_matmul launches a layer")
    check(logits.shape == (1, 1, arch.config.vocab), "prefill logits shape")
    check(bool(torch.isfinite(logits).all()), "prefill logits finite")
    _, short = prefill(qparams, {"tokens": tokens[:, :256]})  # plain attend below 4096
    for name in ("k", "v"):
        same = torch.equal(caches["pos0"][name][0, :, :256], short["pos0"][name][0])
        check(same, f"prefill {name} cache: layer 0 not bit-identical")
    errs = cache_errs(caches, short, arch.config)
    worst = max(max(e) for e in errs.values())
    check(worst <= CACHE_TOL, f"prefill caches [0, 256) vs a 256-token prefill: {errs}")
    del caches
    planted = {}
    for fault, fkw in FLASH_FAULTS.items():
        real = attn_mod.flash_attend
        faulty = lambda q, k, v, fkw=fkw, **kw: real(q, k, v, **fkw(q, kw))
        with mock.patch.object(attn_mod, "flash_attend", faulty):
            _, bad = prefill(qparams, {"tokens": tokens})
        planted[fault] = max(max(e) for e in cache_errs(bad, short, arch.config).values())
        del bad
    per_layer = lambda e: ", ".join(f"{x:.2e}" for x in e[:: max(1, L // 6)])
    print(
        f"lm prefill: S=4096 at full width (int8) in {wall:.3f} s "
        f"({4096 / wall:.1f} tok/s); caches [0, 256) match a 256-token prefill: layer 0 "
        f"bit-identical; max err / layer max every {max(1, L // 6)} layers: "
        f"k [{per_layer(errs['k'])}], v [{per_layer(errs['v'])}]; worst {worst:.3e} (limit "
        f"{CACHE_TOL}); with a planted flash fault: "
        f"{json.dumps({f: float(f'{x:.3e}') for f, x in planted.items()})}"
    )
    for fault, reading in planted.items():
        check(reading > CACHE_TOL, f"prefill caches: planted fault {fault} passes")
    split = device_split(lambda: prefill(qparams, {"tokens": tokens}), n=2)
    print(f"lm prefill split: {split}")
    return counts


def card_cpu_agree(got, want, what, tol: float = 0.05) -> tuple[float, int]:
    """Card logits against CPU logits at bf16 compute: the kernels round in
    other places than the plain versions, so within 5 % of max |logit|
    (tests/test_torch_lm_serve.py) and the same greedy token wherever the
    top-2 margin is clear of that.  Returns (error / max |logit|, decided)."""
    got, want = got.float().cpu(), want.float()
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    check(err <= tol * scale, f"{what}: card vs CPU max err {err} > {tol} x {scale}")
    top2 = want.topk(2, dim=-1).values
    decided = (top2[..., 0] - top2[..., 1]) > 2 * tol * scale
    same = got.argmax(-1)[decided] == want.argmax(-1)[decided]
    check(bool(same.all()), f"{what}: greedy token differs where the margin is clear")
    return err / scale, int(decided.sum())


def phase_lm_card_vs_cpu(arch) -> None:
    """Full widths, 2 layers: the card (kernels) against the CPU (plain)."""
    cfg = dataclasses.replace(arch.config, n_layers=2)
    params = arch.init_params(torch.Generator().manual_seed(1), cfg)
    params_cpu = quantize_tree(params, lm_policy(8))
    params_gpu = tree_map(
        lambda _, t: t.to(DEVICE) if isinstance(t, (torch.Tensor, QTensor)) else t, params_cpu
    )
    tok = torch.tensor([[17], [cfg.vocab - 7]])
    cur = torch.zeros(2, dtype=torch.int32)
    caches = tfm.cache_init(cfg, 2, 8, DEVICE)
    lg, _ = tfm.decode_step(cfg, params_gpu, caches, tok.to(DEVICE), cur.to(DEVICE))
    lc, _ = tfm.decode_step(cfg, params_cpu, tfm.cache_init(cfg, 2, 8, device="cpu"), tok, cur)
    d_err, d_n = card_cpu_agree(lg, lc, "decode_step")
    tokens = torch.from_numpy(np.random.default_rng(13).integers(0, cfg.vocab, (1, 4096)))
    kernels.reset_launch_counts()
    pg, _ = tfm.prefill(cfg, params_gpu, tokens.to(DEVICE))
    torch.cuda.synchronize()
    check(kernels.launch_counts()["flash_attention"] == 2, "2-layer prefill launches flash twice")
    check(kernels.launch_counts()["quant_matmul"] == 2 * QDOTS_PER_LAYER, "2-layer prefill qdots")
    pc, _ = tfm.prefill(cfg, params_cpu, tokens)
    p_err, p_n = card_cpu_agree(pg, pc, "prefill")
    print(
        f"lm card vs CPU (full width, 2 layers, int8): decode_step max err {d_err:.3e} of max "
        f"|logit| ({d_n}/2 greedy tokens decided, equal); prefill S=4096 {p_err:.3e} "
        f"({p_n}/1 decided, equal)"
    )


# ---------------------------------------------------------------------------
# Phase 9: the Flex-plorer DSE (population sweep) at full width
# ---------------------------------------------------------------------------

DSE_T = 20
DSE_WEIGHTS = dict(c_hw=0.4, c_acc=0.4, c_perf=0.2, c_lat=0.4, c_energy=0.4, c_bw=0.2)
DSE_CKPT = ROOT / "build" / "dse_checkpoints"  # git-ignored, inside the checkout
# the sweep's CUDA kernels, as torch.profiler names them
SWEEP_KERNELS = {"spike_matmul": "spike_matmul_kernel", "lif_scan": "lif_scan_kernel"}
# The profiler starts recording late after the step into its recorded
# steps: launched at once, the first recorded sweep lost its first device
# events (its layer-0 ``spike_matmul`` in 6 of 300 windows on an H100); after
# a 20 ms wait no window of 300 lost any (scripts/profiler_window_check.py).
PROFILER_SETTLE_S = 0.02


class PlantedKill(Exception):
    """Raised inside a search to stand for the process dying there."""


@contextlib.contextmanager
def recorded_spike_matmul(module):
    """Every ``spike_matmul`` call made through ``module`` while the block
    runs, with its operands and result (each is counted as usual)."""
    seen = []

    def recording(spk, w):
        got = spike_matmul(spk, w)
        seen.append((spk, w, got))
        return got

    with mock.patch.object(module, "spike_matmul", recording):
        yield seen


def check_recorded(seen, what: str) -> None:
    for spk, w, got in seen:
        check(torch.equal(got, spike_matmul_plain(spk, w)),
              f"{what}: spike_matmul {list(spk.shape)} x {list(w.shape)} != plain")


def front_summary(res) -> str:
    accs = [t["accuracy"] for t in res.search.trace]
    explored = res.explored_front()
    return (
        f"front {len(res.search.front)} points, explored (hw, accuracy) front {len(explored)} "
        f"points {[round(p['accuracy'], 4) for p in explored]}, accuracy span "
        f"{min(accs):.6f}..{max(accs):.6f} over {len(res.search.cache)} candidates"
    )


def dse_setup():
    """benchmarks/dse_bench.py's configuration: the 256-128-10 LIF network
    with an ATA-F hidden layer, u16, T = 20, trained on the train split of
    mnist_like(n=1536, T=20, seed=0) as dse_bench trains it (6 epochs, batch
    128, lr 2e-3; here from torch.Generator().manual_seed(0)) and searched on
    its test split; space ff_bits = rec_bits = 2..16, leak_bits = 1..8 (1800
    configurations).  The same search on the untrained (seeded random)
    weights runs first, for comparison."""
    ds = mnist_like(n=1536, T=DSE_T, seed=0)
    train, test = ds.split()
    net = NetworkConfig(
        layers=(
            LayerConfig(n_in=256, n_out=128, neuron=NeuronModel.LIF, topology=Topology.ATA_F,
                        w_bits=6, u_bits=16),
            LayerConfig(n_in=128, n_out=10, neuron=NeuronModel.LIF, w_bits=6, u_bits=16),
        ),
        n_steps=DSE_T,
        name="dse-bench-mnist-256-128-10",
    )
    bits = tuple(range(2, 17))
    space = SNNSearchSpace(ff_bits=bits, rec_bits=bits, leak_bits=tuple(range(1, 9)))
    random = init_float_params(torch.Generator().manual_seed(0), net)
    t0 = time.perf_counter()
    res = train_snn(net, train, epochs=6, batch_size=128, lr=2e-3, init_params=random)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    h = res.history[-1]
    print(
        f"dse: trained {net.name} on the card (6 epochs, {len(train.labels)} samples, T={DSE_T}) "
        f"in {wall:.3f} s: loss {h['loss']:.6f}, train_acc {h['train_acc']:.6f}"
    )
    print(f"dse: random weights: {front_summary(dse_search(net, random, test, space))}")
    return net, res.params, train, test, space


def dse_search(net, params, test, space, checkpoint_dir=None, refine=None, mesh=None):
    return explore_snn(
        net, params, test,
        search=SearchSpec(
            space=space, weights=CostWeights(**DSE_WEIGHTS), strategy="nsga2",
            config=NSGAConfig(population=64, generations=3, seed=0),
            checkpoint_dir=None if checkpoint_dir is None else str(checkpoint_dir),
        ),
        evaluate=EvalSpec(batch=max(64, len(test.labels)), mesh=mesh),
        refine=refine,
    )


def sweep_profile(net, cands, qps, test, n: int = 3, cold_tries: int = 10) -> str:
    """``n`` ``eval_int_population`` calls under torch.profiler, after one
    warm-up sweep inside the profiler's window (its schedule's warm-up step:
    the tracer is running but the sweep is not recorded) and a wait of
    PROFILER_SETTLE_S for the recording to start: wall and device
    busy per call, and the launches of each sweep kernel as the profiler saw
    them, which must equal the wrappers' counts over the same calls.
    First, ``cold_tries`` fresh profilers, each around a single sweep with
    no warm-up (how the sweep was once profiled), are held to the wrappers'
    counts and their misses printed, unchecked."""
    sweep = lambda: eval_int_population(
        net, cands, qps, test, batch_size=len(test.labels), return_stats=True
    )
    cuda = [torch.profiler.ProfilerActivity.CUDA]

    def seen_by(prof) -> tuple[list, dict]:
        events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
        return events, {
            name: sum(e.count for e in events if sym in e.key)
            for name, sym in SWEEP_KERNELS.items()
        }

    cold = []  # (profiler, wrappers) of each fresh profiler around one sweep
    for _ in range(cold_tries):
        before = kernels.launch_counts()
        with torch.profiler.profile(activities=cuda) as fresh:
            sweep()
            torch.cuda.synchronize()
        after = kernels.launch_counts()
        cold.append((seen_by(fresh)[1], {k: after[k] - before[k] for k in SWEEP_KERNELS}))
    missed = [c for c in cold if c[0] != c[1]]

    schedule = torch.profiler.schedule(wait=0, warmup=1, active=n, repeat=1)
    with torch.profiler.profile(activities=cuda, schedule=schedule) as prof:
        sweep()  # the warm-up step
        torch.cuda.synchronize()
        prof.step()
        time.sleep(PROFILER_SETTLE_S)
        before = kernels.launch_counts()
        t0 = time.perf_counter()
        for i in range(n):
            sweep()
            if i == n - 1:
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) / n
            prof.step()
        after = kernels.launch_counts()
    events, seen = seen_by(prof)
    busy = sum(e.self_device_time_total for e in events) / 1e6 / n
    counted = {name: after[name] - before[name] for name in SWEEP_KERNELS}
    check(seen == counted, f"the profiler's sweep launches {seen} != the wrappers' {counted}")
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:5]
    names = ", ".join(
        f"{e.key[:40]} {e.self_device_time_total / 1e3 / n:.3f} ms ({e.count})" for e in top
    )
    return (
        f"wall {wall:.4f} s a sweep under the profiler, device busy {busy:.4f} s "
        f"({100 * busy / wall:.1f} % busy); launches by kernel over {n} sweeps after a warm-up "
        f"sweep: profiler {json.dumps(seen)} == wrappers {json.dumps(counted)}; {len(missed)} of "
        f"{cold_tries} fresh profilers around one sweep missed launches "
        f"{[json.dumps(m[0]) for m in missed[:3]]} of {json.dumps(cold[0][1])}; top device "
        f"items per sweep (launches over {n}): {names}"
    )


def phase_dse(dse, found: dict) -> dict:
    """``explore_snn`` (NSGA-II, population 64, 3 generations, c_perf and c_bw
    > 0) on the card, then: every scored candidate's sweep accuracy and
    stats against serial ``eval_int(reference)``, a repeated search, a
    search killed after generation 1 and resumed, a slice against the CPU,
    the candidate-axis ``lif_scan`` against its plain version, and the
    sweep's candidates/s at P = 64 and 512.  Returns the main path's launch
    counts; ``found["dse_json"]`` gets the search's ``to_json()`` (phase 12
    repeats the search on a mesh)."""
    net, params, _, test, space = dse
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    res = dse_search(net, params, test, space)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    check(counts["spike_matmul"] > 0 and counts["lif_scan"] > 0, "the sweep ran its kernels")
    out = found["dse_json"] = res.to_json()
    cache = res.search.cache
    check(len(cache) > 64 and res.search.front, "the search scored more than one generation")
    print(
        f"dse: explore_snn nsga2 (population 64, 3 generations) over {len(cache)} candidates "
        f"of 1800 in {wall:.3f} s on the card; best {res.search.best_breakdown}; "
        f"front {len(res.search.front)} points; report {res.report()}"
    )
    print(f"dse: trained weights: {front_summary(res)}")

    # every scored candidate: the sweep against serial eval_int(reference)
    cfgs = list(cache)  # (ff_bits, rec_bits, leak_bits)
    cands = [net.replace_precisions(w_bits=a, w_rec_bits=b, leak_bits=c) for a, b, c in cfgs]
    qps = [quantize_params(c, params)[0] for c in cands]
    batch = len(test.labels)
    accs, stats = eval_int_population(net, cands, qps, test, batch_size=batch, return_stats=True)
    t0 = time.perf_counter()
    for i, (c, q) in enumerate(zip(cands, qps)):
        acc, st = eval_int(c, q, test, batch_size=batch, return_stats=True, backend="reference")
        check(acc == accs[i] == cache[cfgs[i]].accuracy, f"candidate {cfgs[i]}: sweep != serial")
        check(np.array_equal(st["input_events_per_step"], stats[i]["input_events_per_step"]),
              f"candidate {cfgs[i]}: input stats")
        for a, b in zip(st["layer_events_per_step"], stats[i]["layer_events_per_step"]):
            check(np.array_equal(a, b), f"candidate {cfgs[i]}: layer stats sweep != serial")
    serial_s = time.perf_counter() - t0
    wide = sum(1 for c in cands if c.layers[0].w_bits > 8)
    print(
        f"dse: all {len(cands)} scored candidates ({wide} with weights beyond int8) equal serial "
        f"eval_int(reference) in accuracy and float32 stats ({serial_s:.3f} s serial); "
        f"accuracies {sorted(set(np.round(accs, 6).tolist()))[:6]}..."
    )

    # the sweep's own spike_matmul launches at the search's width (its first
    # 64 candidates: layer 0 on the shared raster, layer 1 on each
    # candidate's spikes), each held bit for bit to the plain product
    with recorded_spike_matmul(backend_mod) as seen:
        eval_int_population(net, cands[:64], qps[:64], test, batch_size=batch)
    check(len(seen) == len(net.layers), "one spike_matmul launch per layer in a sweep")
    for spk, w, got in seen:
        P, (M, K), N = w.shape[0], spk.shape[-2:], w.shape[-1]
        pl = plan(M, K, N, P)
        check(torch.equal(got, spike_matmul_plain(spk, w)), f"spike_matmul {list(spk.shape)} x "
              f"{list(w.shape)} (the sweep's) != plain")
        wide = int((w.abs().amax(dim=(1, 2)) > 127).sum())
        print(
            f"kernel spike_matmul {list(spk.shape)}x{list(w.shape)} as the sweep launches it "
            f"({pl.kind}, bn {pl.bn}, grid {pl.grid[0]}x{pl.grid[1]}x{P}; {wide} candidates' "
            f"weights beyond int8): bit-identical to plain"
        )

    # repeatable; killed after generation 1 and resumed
    again = dse_search(net, params, test, space)
    check(json.dumps(again.to_json(), sort_keys=True) == json.dumps(out, sort_keys=True),
          "a second identical search differs")
    shutil.rmtree(DSE_CKPT, ignore_errors=True)
    real = explorer_mod.eval_int_population
    calls = {"n": 0}

    def dies_after_generation_1(*args, **kw):
        calls["n"] += 1  # sweep 1: the initial population, 2: generation 1
        if calls["n"] == 3:
            raise PlantedKill("killed after generation 1")
        return real(*args, **kw)

    with mock.patch.object(explorer_mod, "eval_int_population", dies_after_generation_1):
        try:
            dse_search(net, params, test, space, checkpoint_dir=DSE_CKPT)
            check(False, "the planted kill did not fire")
        except PlantedKill:
            pass
    resumed = dse_search(net, params, test, space, checkpoint_dir=DSE_CKPT)
    shutil.rmtree(DSE_CKPT, ignore_errors=True)
    check(resumed.search.front == res.search.front, "resumed front != uninterrupted front")
    check(json.dumps(resumed.to_json(), sort_keys=True) == json.dumps(out, sort_keys=True),
          "resumed search != uninterrupted search")
    print("dse: a second search gives an identical to_json(); killed after generation 1 "
          f"(sweep {calls['n']}) and resumed from its checkpoints: identical front and to_json()")

    # a slice on the card against the CPU: 4 candidates x 32 samples
    x = raster_tensor(test.spikes[:32].transpose(1, 0, 2), DEVICE)
    sl = slice(0, 4)
    stacked, b_regs, a_regs = stack_population(cands[sl], qps[sl])
    c_gpu, e_gpu = run_int_population(net, stacked, b_regs, a_regs, x, return_events=True)
    qps_cpu = [[IntLayerParams(*(t.cpu() for t in p)) for p in q] for q in qps[sl]]
    stacked, b_regs, a_regs = stack_population(cands[sl], qps_cpu)
    c_cpu, e_cpu = run_int_population(net, stacked, b_regs, a_regs, x.cpu(), return_events=True)
    check(torch.equal(c_gpu.cpu(), c_cpu) and torch.equal(e_gpu.cpu(), e_cpu), "sweep card != CPU")
    print(f"dse: 4 candidates x 32 samples: counts and emitted totals card == CPU "
          f"(emitted {int(e_cpu.sum())})")

    # candidate-axis lif_scan at the phase's shape, 64 candidates
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    stacked, b_regs, _ = stack_population(cands[:64], qps[:64])
    theta, regs = stacked[1].theta_q, b_regs[:, 1].contiguous()
    P, T, B, N = 64, DSE_T, batch, net.layers[1].n_out
    cur = torch.randint(-300, 400, (P, T, B, N), device=DEVICE, generator=gen, dtype=torch.int32)
    s1, u1 = lif_scan(cur, theta_q=theta, decay_k=regs, u_bits=16, reset_to_zero=False)
    s2, u2 = lif_scan_ref(cur, theta, regs, 16, False)
    torch.cuda.synchronize()
    check(torch.equal(s1, s2) and torch.equal(u1, u2), "candidate-axis lif_scan != plain")
    taps = max(bin(int(k) & 255).count("1") for k in regs.tolist())
    b_ms, b_by = bound(4 * (2 * P * T * B * N + P * B * N + 2 * P), P * T * B * N * (12 + 2 * taps),
                       INT32_OPS_S)
    kw = dict(theta_q=theta, decay_k=regs, u_bits=16, reset_to_zero=False)
    ms = time_ms(lambda: lif_scan(cur, **kw))
    plain_ms = time_ms(lambda: lif_scan_ref(cur, theta, regs, 16, False), reps=3, inner=2)
    print(
        f"kernel lif_scan [{P},{T},{B},{N}] int32, theta and register per candidate: "
        f"bit-identical to plain; {ms:.5f} ms, plain {plain_ms:.5f} ms, bound {b_ms:.5f} ms "
        f"({b_by}), {share(b_ms, ms)} of the bound"
    )

    # the sweep's throughput at P = 64 and 512
    rng = np.random.default_rng(0)
    all_cfgs = list(itertools.product(space.ff_bits, space.rec_bits, space.leak_bits))
    for P in (64, 512):
        picks = [all_cfgs[i] for i in rng.choice(len(all_cfgs), P, replace=False)]
        cs = [net.replace_precisions(w_bits=a, w_rec_bits=b, leak_bits=c) for a, b, c in picks]
        qs = [quantize_params(c, params)[0] for c in cs]
        eval_int_population(net, cs, qs, test, batch_size=batch)  # warm-up
        torch.cuda.synchronize()
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            eval_int_population(net, cs, qs, test, batch_size=batch, return_stats=True)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        best = min(times)
        print(
            f"dse sweep P={P}: {P / best:.1f} candidates/s ({best:.4f} s per sweep of "
            f"{batch} samples x T={DSE_T}, best of 3: {[round(t, 4) for t in times]})"
        )
        print(f"dse sweep P={P} split: {sweep_profile(net, cs, qs, test)}")
        # layer 0's product [T*B,256]x[P,256,128]: bytes (raster, weights,
        # the int32 currents) and operations, int8 tensor cores for the
        # candidates whose weights fit int8, int32 CUDA cores for the rest;
        # beside it the operations with every wider weight split into byte
        # planes on the int8 tensor cores (one product per plane)
        M, (K, N) = DSE_T * batch, qs[0][0].w_ff.shape
        n8 = sum(fits_int8(q[0].w_ff) for q in qs)
        t_ops = 2 * M * K * N * (n8 / INT8_TC_OPS_S + (P - n8) / INT32_OPS_S)
        planes = sum(-(-(int(q[0].w_ff.abs().max()).bit_length() + 1) // 8) for q in qs)
        t_planes = 2 * M * K * N * planes / INT8_TC_OPS_S
        t_bytes = 4 * (M * K + P * K * N + P * M * N) / HBM_BYTES_S
        print(
            f"dse sweep P={P} layer-0 spike_matmul [{M},{K}]x[{P},{K},{N}] bound: bytes "
            f"{1e3 * t_bytes:.5f} ms ({4 * (M * K + P * K * N + P * M * N) / 1e9:.4f} GB), "
            f"operations {1e3 * t_ops:.5f} ms ({2 * P * M * K * N:.4g} ops, {n8} candidates "
            f"int8): bound {1e3 * max(t_ops, t_bytes):.5f} ms "
            f"({'operations' if t_ops >= t_bytes else 'bytes'}); with weight byte planes "
            f"({planes} int8 products) operations {1e3 * t_planes:.5f} ms: bound "
            f"{1e3 * max(t_planes, t_bytes):.5f} ms "
            f"({'operations' if t_planes >= t_bytes else 'bytes'})"
        )
    print(f"dse: phase 9 took {time.perf_counter() - t_phase:.3f} s")
    return counts


def refine_step_fn(net, params, cands, x, y):
    """One candidate-axis QAT train step of ``cands`` from ``params`` on the
    batch (x, y), as ``refine_candidates`` takes it (a fresh optimizer state
    each call, so every call takes the same step)."""
    K = len(cands)
    grid = candidate_grid(cands, DEVICE)
    stacked = [torch.stack([t] * K) for p in params for t in p]
    opt = adamw(linear_warmup_cosine(5e-4, 11, 11))
    state = opt.init(stacked)
    fn = fast_sigmoid(25.0)
    return lambda: refine_step(net, opt, stacked, state, grid, x, y, fn, 1e-4)


def first_batch(ds: SpikeDataset, n: int = 128) -> tuple[SpikeDataset, torch.Tensor, torch.Tensor]:
    """The first ``n`` samples as a dataset of one batch, and as float32
    spikes [T, n, C] and labels on the card."""
    one = SpikeDataset(ds.spikes[:n], ds.labels[:n], ds.n_classes, ds.name + ":first")
    x = raster_tensor(one.spikes.transpose(1, 0, 2), DEVICE).to(torch.float32)
    return one, x, torch.from_numpy(one.labels.astype(np.int64)).to(DEVICE)


def best_wall_ms(fn, n: int = 3) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return min(times)


def phase_dse_refine(dse) -> dict:
    """The search again with its QAT refine phase (``RefineSpec(top_k=4)``,
    1 epoch on the train split): each refined candidate's PTQ and refined
    accuracy against serial ``eval_int(reference)``, best >= base; then the
    candidate-axis train step at K = 4 and K = 1, its ``spike_matmul``
    launches (T x layers whatever K is, each bit-identical to plain) and
    its time.  Returns the main path's launch counts."""
    net, params, train, test, space = dse
    t0 = time.perf_counter()
    res = dse_search(net, params, test, space, refine=RefineSpec(top_k=4, train_ds=train, epochs=1))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    check(len(res.refined) == 4, "four refined finalists")
    batch = len(test.labels)
    for r in res.refined:
        ptq = quantize_params(r.net, params)[0]
        base = eval_int(r.net, ptq, test, batch_size=batch, backend="reference")
        check(base == r.base_accuracy == res.search.cache[r.cfg].accuracy,
              f"refined {r.cfg}: base accuracy != serial eval_int of its PTQ parameters")
        refined = eval_int(r.net, r.qparams, test, batch_size=batch, backend="reference")
        check(refined == r.accuracy, f"refined {r.cfg}: accuracy != serial eval_int")
        check(r.accuracy >= r.base_accuracy, f"refined {r.cfg}: best < base")
    print(
        f"dse refine: explore_snn + RefineSpec(top_k=4, epochs=1) in {wall:.3f} s on the card; "
        "each refined finalist's base and refined accuracy == serial eval_int(reference): "
        + ", ".join(f"{r.breakdown} {r.base_accuracy:.6f} -> {r.accuracy:.6f}" for r in res.refined)
        + f"; refined front {len(res.refined_front())} points"
    )
    _, x, y = first_batch(train)
    per_step = DSE_T * len(net.layers)
    for K in (4, 1):
        step = refine_step_fn(net, params, [r.net for r in res.refined][:K], x, y)
        with recorded_spike_matmul(snn_layer_mod) as seen:
            step()
        check(len(seen) == per_step, f"refine step K={K}: {len(seen)} spike_matmul launches, "
              f"not T x layers = {per_step}")
        check_recorded(seen, f"refine step K={K}")
        shapes = sorted({f"{list(a.shape)}x{list(b.shape)}" for a, b, _ in seen})
        print(
            f"dse refine step K={K} (batch 128, T={DSE_T}): {len(seen)} spike_matmul launches "
            f"({shapes}), each bit-identical to plain; {best_wall_ms(step):.3f} ms a step"
        )
        if K == 4:
            print(f"dse refine step K=4 split: {device_split(step, n=3)}")
    return counts


# ---------------------------------------------------------------------------
# Phase 10: training at full width (examples_torch/quickstart.py)
# ---------------------------------------------------------------------------

# The deployed accuracy must clear this floor (chance is 0.1): the port's
# CPU run of the same configuration (scripts/torch_train_cpu.py) deploys at
# 0.9903.
QS_ACC_FLOOR = 0.90
CARD_VS_CPU_TOL = 1e-5  # tests/test_torch_cuda.py: loss relative, parameters / max |w|
# An SSD's gradients through exp(cs_i - cs_j) of chunk cumsums differ between
# two f32 orders by more than 1e-5 of max |g| (reduced jamba card vs CPU on an
# H100: 3.9e-5; dense configs ~1e-6), so SSM configs hold gradients to the
# 1e-4 at which tests/test_torch_lm_train.py holds the port to JAX on the CPU.
# The witness: the same step on the CPU in f64.  The CPU's own f32 gradients
# lie 1.5e-5 (mamba2) and 4.1e-5 (jamba) of max |g| from it, so f32 cannot do
# better; the card's must lie no more than SSM_F64_RATIO times as far.
SSM_GRAD_TOL = 1e-4
SSM_F64_RATIO = 4.0


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over max |want| (0 for an empty tensor)."""
    if not want.numel():
        return 0.0
    return float((got.cpu() - want).abs().max()) / max(float(want.abs().max()), 1e-30)


def step_card_vs_cpu(step, params0) -> str:
    """One ``train_snn`` step (``step(params, device)``) on the card and on
    the CPU from the same parameters, held stage by stage to
    CARD_VS_CPU_TOL: the loss (relative), each gradient leaf (of its max
    |grad|, read where ``train_snn`` clips them), and the AdamW update of
    both devices from the CPU's clipped gradients (of each leaf's max |w|).

    The composed step's parameters are printed, not held to that limit:
    AdamW's first update g / (|g| + eps) turns a gradient difference dg at
    an element with |g| near eps = 1e-8 into an update difference of up to
    dg / eps, so float summation noise in such an element's gradient, far
    below the gradient limit, moves that parameter by a visible share of
    the learning rate."""
    seen = []  # (gradients, clipped gradients) of the card's step, then the CPU's
    real = opt_mod.clip_by_global_norm

    def spy(grads, max_norm, batch_dims=0):
        out = real(grads, max_norm, batch_dims)
        seen.append(([g.cpu() for g in grads], [g.cpu() for g in out[0]]))
        return out

    cpu0 = [FloatLayerParams(*(t.cpu() for t in p)) for p in params0]
    with mock.patch.object(opt_mod, "clip_by_global_norm", spy):
        card, cpu = step(params0, DEVICE), step(cpu0, "cpu")
    lc, lg = cpu.history[0]["loss"], card.history[0]["loss"]
    check(abs(lg - lc) <= CARD_VS_CPU_TOL * abs(lc), f"train step loss card {lg} vs CPU {lc}")
    (g_card, _), (g_cpu, clipped) = seen
    g_err = max(rel_err(a, b) for a, b in zip(g_card, g_cpu))
    check(g_err <= CARD_VS_CPU_TOL, f"train step gradients card vs CPU: {g_err:.3e} of max |grad|")
    # the update alone, from the same gradients on both devices (train_snn's
    # schedule for a one-step run: warm-up over that step)
    leaves = [t for p in cpu0 for t in p]
    updated = {}
    for dev in ("cpu", DEVICE):
        opt = adamw(linear_warmup_cosine(2e-3, 1, 1))
        ps = [t.to(dev) for t in leaves]
        upd, _ = opt.update([g.to(dev) for g in clipped], opt.init(ps), ps)
        updated[dev] = [p + u for p, u in zip(ps, upd)]
    u_err = max(rel_err(a, b) for a, b in zip(updated[DEVICE], updated["cpu"]))
    check(u_err <= CARD_VS_CPU_TOL, f"AdamW update card vs CPU: {u_err:.3e} of max |w|")
    worst, beyond_g = 0.0, []
    flat = lambda params: [t for p in params for t in p]
    for g, c, grad in zip(flat(card.params), flat(cpu.params), g_cpu):
        if c.numel():
            worst = max(worst, rel_err(g, c))
            beyond = (g.cpu() - c).abs() > CARD_VS_CPU_TOL * c.abs().max()
            beyond_g += grad[beyond].abs().tolist()
    return (
        f"loss {lg:.8f} vs {lc:.8f}; gradients within {g_err:.3e} of max |grad|, the AdamW "
        f"update from the same gradients within {u_err:.3e} of max |w| (limit {CARD_VS_CPU_TOL}); "
        f"the composed step's parameters within {worst:.3e} of max |w|, {len(beyond_g)} elements "
        f"beyond the limit, their |grad| {[f'{x:.2e}' for x in sorted(beyond_g)[-8:]]} (eps 1e-8)"
    )


def phase_train(examples: dict) -> dict:
    """examples_torch/quickstart.py's ``main`` on the card (``train_snn``, 8
    epochs, batch 128, lr 2e-3; ``quantize_params``; ``eval_int`` on the
    event backend with its statistics; the hardware model), its trained net
    deployed through ``eval_int`` on three backends, then a QAT epoch at
    w_bits = 3; after the counts are read: eval_qat == eval_int of the QAT
    deployment, a QAT forward's launches against plain, one train step card
    against CPU, and the train and QAT steps' time and device-busy share.
    The example's own launches and result go to ``examples`` for phase 20.
    Returns the main path's launch counts."""
    t_phase = time.perf_counter()
    before = kernels.launch_counts()
    t0 = time.perf_counter()
    qs = ex_quickstart.main([])
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    examples["quickstart"] = dict(out=qs, wall=time.perf_counter() - t0,
                                  launches={k: after[k] - before[k] for k in after})
    net, train, test, res = qs["net"], qs["train"], qs["test"], qs["result"]
    wall, epochs = qs["train_s"], len(qs["result"].history)
    params0 = init_float_params(torch.Generator().manual_seed(0), net)  # the example's start
    qparams = qs["qparams"]
    accs = {b: eval_int(net, qparams, test, backend=b) for b in ("reference", "fused", "event")}
    qat = PrecisionConfig(w_bits=3)
    n0 = spike_matmul.launches
    t0 = time.perf_counter()
    qres = train_snn(net, train, epochs=1, lr=5e-4, qat=qat, init_params=res.params)
    torch.cuda.synchronize()
    qat_wall = time.perf_counter() - t0
    qat_launches = spike_matmul.launches - n0
    counts = read_counts()

    steps = -(-len(train.labels) // 128)
    for h in res.history:
        print(
            f"train: epoch {h['epoch']}: loss {h['loss']:.6f}, train_acc {h['train_acc']:.6f}, "
            f"{h['seconds']:.3f} s ({1e3 * h['seconds'] / steps:.2f} ms a step)"
        )
    print(
        f"train: {net.name} (LIF 256-128-10 w6/u8, T={net.n_steps}) {epochs} epochs x "
        f"{steps} steps on the card in {wall:.3f} s: "
        f"{epochs * len(train.labels) / wall:.1f} samples/s, "
        f"{1e3 * wall / (epochs * steps):.2f} ms a step"
    )
    check(len(set(accs.values())) == 1, f"deployed accuracy differs across backends: {accs}")
    acc = accs["reference"]
    check(acc == qs["accuracy"], f"quickstart printed accuracy {qs['accuracy']} != "
          f"eval_int(reference) {acc}")
    check(acc >= QS_ACC_FLOOR, f"deployed accuracy {acc} below the floor {QS_ACC_FLOOR}")
    print(f"train: deployed (quantize_params -> eval_int) accuracy {acc:.6f} on reference, fused "
          f"and event (floor {QS_ACC_FLOOR}), == the quickstart's printed accuracy")

    per_step = net.n_steps * len(net.layers)
    check(qat_launches == steps * per_step,
          f"QAT epoch: {qat_launches} spike_matmul launches, not {steps} steps x {per_step}")
    qq, _ = quantize_params(qres.qat_net, qres.params)
    acc_int, acc_qat = eval_int(qres.qat_net, qq, test), eval_qat(qres.qat_net, qres.params, test)
    check(acc_qat == acc_int, f"eval_qat {acc_qat} != eval_int of the deployment {acc_int}")
    one, x, y = first_batch(train)
    with recorded_spike_matmul(snn_layer_mod) as seen, torch.no_grad():
        run_qat(qres.qat_net, qres.params, x, fast_sigmoid(25.0))
    check(len(seen) == per_step, "a QAT forward launches spike_matmul T x layers times")
    check_recorded(seen, "QAT forward")
    print(
        f"train: QAT epoch (w_bits 3, {steps} steps) in {qat_wall:.3f} s "
        f"({1e3 * qat_wall / steps:.2f} ms a step), loss {qres.history[0]['loss']:.6f}; "
        f"{qat_launches} spike_matmul launches = {steps} steps x T x layers; eval_qat == "
        f"eval_int of the w3 deployment == {acc_int:.6f}; a QAT forward's launches "
        f"{sorted({f'{list(a.shape)}x{list(b.shape)}' for a, b, _ in seen})} bit-identical to plain"
    )

    # one train step from the same parameters on the same batch: card vs CPU
    def step(params, device, **kw):
        return train_snn(
            net, one, epochs=1, batch_size=128, init_params=params, device=device, **kw
        )

    print(f"train: one step card vs CPU: {step_card_vs_cpu(step, params0)}")
    fstep = lambda: step(params0, DEVICE)
    print(f"train step split (train_snn on one batch of 128): {device_split(fstep, n=3)}")
    qstep = lambda: step(res.params, DEVICE, lr=5e-4, qat=qat)
    print(f"QAT step split (train_snn on one batch of 128): {device_split(qstep, n=3)}")
    print(f"train: phase 10 took {time.perf_counter() - t_phase:.3f} s")
    return counts


# ---------------------------------------------------------------------------
# Phase 11: the serving front end and crash safety
# ---------------------------------------------------------------------------

FRONT_DIR = ROOT / "build" / "phase11"  # checkpoints and journals (git-ignored)
STREAM_CFG = dict(window=32, stride=16, idle_budget=None)
STREAM_STEPS, STREAM_CHUNK = 64, 16
CHUNK_UID0 = 1 << 40  # the session manager's chunk uids start here


def fresh_dir(name: str) -> Path:
    d = FRONT_DIR / name
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    return d


def stream_engine(net, qparams, device: str, **kw) -> SNNServeEngine:
    """The phase's engine: 64 lanes, the in-pool sparse route, 16-step ticks."""
    return SNNServeEngine(
        net, qparams, max_batch=64, backend=EventBackend(strategy="pallas"), tick_stride=16,
        device=device, **kw,
    )


def stream_groups(n_in: int) -> list[tuple[str, np.ndarray]]:
    """256 streams of 64 steps in three groups, fed one group after the
    other (a round-robin over mixed groups would make every tick int32):
    96 sparse (Bernoulli 3 %, sparse ticks), 128 dense ``mnist_like``
    (f32_exact ticks), 32 graded (values up to 3999 on 35 % of the
    channels, as in :func:`serving_traffic`: int32 ticks)."""
    rng = np.random.default_rng(11)
    sparse = (rng.random((96, STREAM_STEPS, n_in)) < 0.03).astype(np.uint8)
    dense = mnist_like(n=128, T=STREAM_STEPS, seed=12, max_rate=0.6).spikes
    on = rng.random((32, STREAM_STEPS, n_in)) < 0.35
    graded = np.where(on, rng.integers(1, 4000, on.shape), 0).astype(np.int32)
    return [("sparse", sparse), ("dense", dense), ("graded", graded)]


def prefix_oracle(net, qparams, rasters: np.ndarray, device: str) -> dict[int, np.ndarray]:
    """Serial oracle of a group's streams (``tests/test_streaming_props.py``):
    ``run_int(reference)`` of each stream's first b steps, for every stride
    boundary b, is its cumulative output count -- one batched call per b."""
    out = {0: np.zeros((len(rasters), net.n_classes), np.int64)}
    for b in range(STREAM_CFG["stride"], STREAM_STEPS + 1, STREAM_CFG["stride"]):
        x = raster_tensor(rasters[:, :b].transpose(1, 0, 2), device)
        out[b] = run_int(net, qparams, x, backend="reference").spike_counts.cpu().numpy()
    return out


def check_readouts(readouts: dict, sids: list[str], prefix: dict, what: str) -> None:
    window, stride = STREAM_CFG["window"], STREAM_CFG["stride"]
    ends = list(range(stride, STREAM_STEPS + 1, stride))
    for i, sid in enumerate(sids):
        got = readouts[sid]
        check([r[0] for r in got] == ends, f"{what}: {sid} readout ends {[r[0] for r in got]}")
        for t_end, w, counts, pred in got:
            start = max(0, t_end - window)
            want = prefix[t_end][i] - prefix[start][i]
            check(w == t_end - start and counts == want.tolist() and pred == int(np.argmax(want)),
                  f"{what}: {sid} readout at {t_end} differs from serial run_int")


def drive_streams(engine, groups, ckpt: Path | None = None):
    """Feed every group's streams chunk by chunk (round-robin within the
    group, groups one after the other), polling until each round drains;
    with ``ckpt``, evict every session of the group after each round.
    Returns the readouts by session, the wall, and the chunk latencies."""
    manager = StreamSessionManager(engine, checkpoint_dir=ckpt, config=StreamConfig(**STREAM_CFG))
    latencies = []
    t0 = time.perf_counter()
    for name, rasters in groups:
        sids = [manager.open(f"{name}{i}").sid for i in range(len(rasters))]
        for lo in range(0, STREAM_STEPS, STREAM_CHUNK):
            for sid, r in zip(sids, rasters):
                manager.feed(sid, r[lo : lo + STREAM_CHUNK])
            while not all(manager.sessions[sid].drained for sid in sids):
                latencies += [r.latency_s for r in manager.poll()]
            if ckpt is not None:
                for sid in sids:
                    manager.evict(sid)
    wall = time.perf_counter() - t0
    readouts = {
        sid: [(r.t_end, r.window, r.spike_counts.tolist(), r.prediction)
              for r in manager.drain_readouts(sid)]
        for sid in manager.sessions
    }
    return readouts, wall, latencies, manager


def phase_streams(net, qparams, front: dict, device: str = DEVICE) -> dict:
    """256 sessions of 64 steps in 16-step chunks; every readout against
    the serial oracle; all three tick modes served."""
    groups = stream_groups(net.n_in)
    engine = stream_engine(net, qparams, device)
    engine.warmup(STREAM_CHUNK, include_int32=True)
    reset_counts()
    readouts, wall, lat, manager = drive_streams(engine, groups)
    counts = read_counts()
    front["groups"], front["readouts"] = groups, readouts
    for name, rasters in groups:
        prefix = prefix_oracle(net, qparams, rasters, device)
        check_readouts(readouts, [f"{name}{i}" for i in range(len(rasters))], prefix, "stream")
    ticks = {k[5:]: v for k, v in engine.metrics.counters.items() if k.startswith("tick:")}
    for mode in ("sparse", "f32_exact", "int32"):
        check(ticks.get(mode, 0) > 0, f"streams: no {mode} tick was served")
    n_chunks = engine.metrics.counters["session_chunks"]
    n_steps = sum(len(r) for _, r in groups) * STREAM_STEPS
    check(n_chunks == n_steps // STREAM_CHUNK == len(lat), "streams: one chunk request a feed")
    p50, p99 = (1e3 * float(np.percentile(lat, q)) for q in (50, 99))
    print(
        f"streams: {len(readouts)} sessions x {STREAM_STEPS} steps, "
        f"{sum(map(len, readouts.values()))} readouts equal to serial run_int; ticks {ticks}; "
        f"{n_steps / wall:.1f} steps/s, {n_chunks / wall:.1f} chunks/s ({wall:.3f} s); "
        f"chunk p50 {p50:.3f} ms, p99 {p99:.3f} ms"
    )
    print(f"streams: {dispatch_vs_tick(engine, wall)}")
    if device == "cuda":
        dense = groups[1][1]

        def one_round():
            m = StreamSessionManager(engine, config=StreamConfig(**STREAM_CFG))
            for i, r in enumerate(dense):
                m.feed(m.open(f"r{i}").sid, r[:STREAM_CHUNK])
            m.pump()

        print(f"streams: one round of 128 dense chunks: {device_split(one_round, n=3)}")
    return counts


def phase_stream_churn(net, qparams, front: dict, device: str = DEVICE) -> dict:
    """The same streams with every session evicted to disk after each round
    (fsync + rename per evict) and restored on its next feed."""
    groups = front["groups"]
    engine = stream_engine(net, qparams, device)
    engine.warmup(STREAM_CHUNK, include_int32=True)
    ckpt = fresh_dir("churn")
    reset_counts()
    readouts, wall, _, manager = drive_streams(engine, groups, ckpt=ckpt)
    counts = read_counts()
    check(readouts == front["readouts"], "churn: readouts differ from the never-evicted run")
    c = engine.metrics.counters
    n_sessions = len(readouts)
    check(c["sessions_evicted"] == c["sessions_restored"] + n_sessions
          == n_sessions * STREAM_STEPS // STREAM_CHUNK, "churn: evictions != restores + sessions")
    n_steps = n_sessions * STREAM_STEPS
    print(
        f"churn: readouts identical to the never-evicted run; {c['sessions_evicted']} evictions, "
        f"{c['sessions_restored']} restores; {n_steps / wall:.1f} steps/s ({wall:.3f} s, "
        f"{1e3 * wall / c['sessions_evicted']:.3f} ms per evict + restore)"
    )
    return counts


def phase_journal(net, qparams, serve_results: dict, device: str = DEVICE) -> dict:
    """Phase 5's traffic again, without and with a ``Journal(fsync_every=16)``
    in turns (without, with, with, without): results equal phase 5's, and
    the journal holds a submit and a done for every request."""
    walls = {"without": [], "with": []}
    counts = {}
    for i, mode in enumerate(("without", "with", "with", "without")):
        journal = Journal(fresh_dir(f"wal{i}"), fsync_every=16) if mode == "with" else None
        engine = SNNServeEngine(net, qparams, max_batch=64, backend=EventBackend(strategy="pallas"),
                                device=device, journal=journal)
        engine.warmup(include_int32=True)
        reqs = serving_traffic(net.n_in)
        if i == 1:
            reset_counts()
        t0 = time.perf_counter()
        done = engine.run(reqs)
        walls[mode].append(time.perf_counter() - t0)
        if i == 1:
            counts = read_counts()
        check(len(done) == len(reqs), "journal: all served")
        for r in done:
            check(np.array_equal(r.spike_counts, serve_results[r.uid]),
                  f"journal: request {r.uid} differs from phase 5")
        if journal is not None:
            journal.close()
            kinds = collections.Counter(r.kind for r in read_records(journal.root))
            check(kinds == {"submit": len(reqs), "done": len(reqs)}, f"journal records {kinds}")
            check(recover(journal.root).requests == [], "journal: outstanding after a clean run")
    rate = {k: [f"{len(reqs) / w:.1f}" for w in v] for k, v in walls.items()}
    print(
        f"journal: {len(done)} requests equal to phase 5 with and without the journal; "
        f"samples/s without {rate['without']}, with {rate['with']} (fsync_every=16)"
    )
    return counts


def phase_chaos(net, qparams, device: str = DEVICE) -> dict:
    """A supervised engine with a journal and a checkpoint store serves 64
    requests and 16 streams while faults fire: a slow tick, a tick raise, a
    poisoned carry and a kill mid-service.  Every request and readout equals
    serial run_int, and the recovery counters equal what was armed."""
    root = fresh_dir("chaos")
    ckpt = root / "ckpt"
    # the tick sites count arrivals at the top of a tick (a retry arrives
    # again): round 0's tick stalls, round 1's raises once and its retry
    # serves; the carry site counts served ticks: round 2's first, whose
    # requests stay on their lanes; round 2's second tick is killed, after
    # the streams' checkpoint at step 32 and before any request completes
    inj = (
        FaultInjector()
        .arm("slow_tick", at=0, sleep_s=0.6)
        .arm("tick", at=1)
        .arm("carry", at=2)
        .arm("kill", at=4)
    )
    sup = SupervisedEngine(
        lambda: stream_engine(net, qparams, device),
        journal_dir=root / "wal",
        checkpoint_dir=ckpt,
        manager_factory=lambda eng: StreamSessionManager(
            eng, checkpoint_dir=ckpt, config=StreamConfig(**STREAM_CFG)
        ),
        faults=inj,
        slow_tick_s=0.3,
        journal_fsync_every=16,
    )
    rng = np.random.default_rng(13)
    streams = (rng.random((16, STREAM_STEPS, net.n_in)) < 0.2).astype(np.uint8)
    req_rasters = mnist_like(n=64, T=25, seed=14).spikes
    sids = [sup.manager.open(f"c{i}").sid for i in range(len(streams))]
    completed: dict[int, SNNRequest] = {}
    readouts: dict[str, dict] = {sid: {} for sid in sids}

    def drive():
        while sup.in_flight:
            for req in sup.poll():
                if req.uid < CHUNK_UID0:
                    prev = completed.setdefault(req.uid, req)
                    check(np.array_equal(prev.spike_counts, req.spike_counts),
                          f"chaos: request {req.uid} served twice, differently")
            for sid in sids:
                for r in sup.manager.drain_readouts(sid):
                    prev = readouts[sid].setdefault(r.t_end, r)
                    check(np.array_equal(prev.spike_counts, r.spike_counts),
                          f"chaos: {sid} readout at {r.t_end} re-emitted differently")

    reset_counts()
    for rnd, lo in enumerate(range(0, STREAM_STEPS, STREAM_CHUNK)):
        if rnd == 2:  # requests arrive after the streams' first checkpoint
            for uid, r in enumerate(req_rasters):
                sup.submit(SNNRequest(uid=uid, raster=r))
        for sid, r in zip(sids, streams):
            sup.manager.feed(sid, r[lo : lo + STREAM_CHUNK])
        drive()
        if rnd == 1:
            for sid in sids:
                sup.manager.evict(sid)
    counts = read_counts()
    sup.close()
    c = sup.metrics.counters
    fired = collections.Counter(site for site, _, _ in inj.fired)
    check(fired == {"slow_tick": 1, "tick": 1, "carry": 1, "kill": 1}, f"chaos: fired {fired}")
    got = {k: c[k] for k in ("tick_retries", "recoveries_warm", "recoveries_cold",
                             "quarantined_lanes", "slow_ticks")}
    armed = {"tick_retries": 1, "recoveries_warm": 0, "recoveries_cold": 1,
             "quarantined_lanes": 1, "slow_ticks": 1}
    check(got == armed, f"chaos: counters {got}, armed {armed}")
    last = sup.last_recovery
    check(last["kind"] == "cold" and last["requests_resubmitted"] > 0
          and last["sessions_reopened"] == len(sids), f"chaos: last recovery {last}")
    check(sorted(completed) == list(range(len(req_rasters))), "chaos: a request was lost")
    x = raster_tensor(req_rasters.transpose(1, 0, 2), device)
    want = run_int(net, qparams, x, backend="reference").spike_counts.cpu().numpy()
    for uid, req in completed.items():
        check(req.status == "completed" and np.array_equal(req.spike_counts, want[uid]),
              f"chaos: request {uid} differs from serial run_int")
    prefix = prefix_oracle(net, qparams, streams, device)
    check_readouts(
        {sid: [(t, r.window, r.spike_counts.tolist(), r.prediction)
               for t, r in sorted(readouts[sid].items())] for sid in sids},
        sids, prefix, "chaos",
    )
    print(
        f"chaos: {len(completed)} requests and {len(sids)} streams bit-exact through "
        f"{dict(fired)}; counters {got}; cold restart {last['duration_s']:.4f} s wall "
        f"({last['requests_resubmitted']} requests resubmitted, {last['sessions_reopened']} "
        f"sessions reopened, {last['steps_refed']} steps re-fed, "
        f"{last['records_replayed']} records replayed)"
    )
    return counts


async def http_call(port: int, method: str, path: str, body=None) -> tuple[int, bytes]:
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    payload = b"" if body is None else json.dumps(body).encode()
    head = f"{method} {path} HTTP/1.1\r\nHost: smoke\r\nContent-Length: {len(payload)}\r\n\r\n"
    writer.write(head.encode() + payload)
    await writer.drain()
    data = await reader.read()
    writer.close()
    await writer.wait_closed()
    head, _, rest = data.partition(b"\r\n\r\n")
    return int(head.split()[1]), rest


def phase_http(net, qparams, device: str = DEVICE) -> dict:
    """``SNNHttpServer`` on 127.0.0.1:0: a request through /submit and a
    stream through /session/{open,feed,close}, each against serial run_int;
    /metrics shows the stream series, /healthz answers 200."""
    rng = np.random.default_rng(15)
    raster = mnist_like(n=1, T=25, seed=16).spikes[0]
    stream = (rng.random((STREAM_STEPS, net.n_in)) < 0.2).astype(np.uint8)

    async def session():
        engine = stream_engine(net, qparams, device)
        server = AsyncSNNServer(engine)
        manager = StreamSessionManager(engine, config=StreamConfig(**STREAM_CFG))
        http = SNNHttpServer(server, streaming=AsyncStreamServer(server, manager),
                             stream_tick_s=0)
        await http.start()
        out = {}
        try:
            p = http.port
            out["submit"] = await http_call(p, "POST", "/submit",
                                            {"raster": raster.tolist(), "uid": 1})
            out["open"] = await http_call(p, "POST", "/session/open", {"sid": "h"})
            out["feed"] = [
                await http_call(p, "POST", "/session/feed",
                                {"session": "h", "chunk": stream[lo : lo + 32].tolist()})
                for lo in (0, 32)
            ]
            out["close"] = await http_call(p, "POST", "/session/close", {"session": "h"})
            out["metrics"] = await http_call(p, "GET", "/metrics")
            out["healthz"] = await http_call(p, "GET", "/healthz")
        finally:
            await http.stop()
        return out

    reset_counts()
    out = asyncio.run(session())
    counts = read_counts()
    for key in ("submit", "open", "close", "metrics", "healthz"):
        check(out[key][0] == 200, f"http: {key} answered {out[key][0]}")
    check(all(status == 200 for status, _ in out["feed"]), "http: a feed failed")
    x = raster_tensor(raster[:, None, :], device)
    want = run_int(net, qparams, x, backend="reference").spike_counts[0].cpu().numpy()
    check(json.loads(out["submit"][1])["spike_counts"] == want.tolist(),
          "http: /submit differs from serial run_int")
    got = [r for _, body in out["feed"] for r in json.loads(body)["readouts"]]
    prefix = prefix_oracle(net, qparams, stream[None], device)
    check_readouts({"h": [(r["t_end"], r["window"], r["spike_counts"], r["prediction"])
                          for r in got]}, ["h"], prefix, "http")
    check(json.loads(out["close"][1])["t_total"] == STREAM_STEPS, "http: close summary")
    series = {}
    for line in out["metrics"][1].decode().splitlines():
        if line.startswith("neura_stream_"):
            name, value = line.rsplit(" ", 1)
            series[name] = float(value)
    for event in ("sessions_opened", "sessions_closed", "session_chunks", "session_readouts"):
        check(series.get(f'neura_stream_events_total{{event="{event}"}}', 0) > 0,
              f"http: /metrics shows no {event}")
    check(json.loads(out["healthz"][1])["status"] == "ok", "http: /healthz status")
    nonzero = sum(v > 0 for v in series.values())
    print(
        f"http: /submit and 4 readouts over /session/* equal to serial run_int; /metrics "
        f"{nonzero} of {len(series)} neura_stream_* series nonzero; /healthz 200"
    )
    return counts


def phase_launcher(device: str = DEVICE) -> dict:
    """``repro_torch.launch.serve_snn.main`` in replay mode and in
    ``--streaming 16`` mode, on the card; each must return normally."""
    runs = [
        ["--requests", "64", "--max-batch", "64", "--T", "25",
         "--journal", str(fresh_dir("launcher-wal"))],
        ["--streaming", "16", "--stream-steps", "64", "--stream-chunk", "16",
         "--stream-window", "32", "--stream-stride", "16", "--stream-idle", "2",
         "--stream-ckpt", str(fresh_dir("launcher-ckpt")), "--max-batch", "64", "--no-journal"],
    ]
    reset_counts()
    outs = []
    for argv in runs:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            serve_snn.main([*argv, "--device", device])
        outs.append(buf.getvalue())
    counts = read_counts()
    check("served 64 requests" in outs[0], "launcher: replay report")
    check("streamed 16 sessions x 64 steps" in outs[1], "launcher: streaming report")
    for out in outs:
        for line in out.splitlines():
            if "throughput" in line or line.startswith(("served", "streamed", "  churn")):
                print(f"launcher: {line.strip()}")
    return counts


# ---------------------------------------------------------------------------
# Phase 12: the SNN path across a device mesh (four shards of one card)
# ---------------------------------------------------------------------------

N_SHARDS = 4


def card_mesh(n: int = N_SHARDS) -> DeviceMesh:
    """``n`` shards on card 0: the partition, padding, reassembly and each
    shard's launches of a real mesh, on the one card there is."""
    return make_mesh(n, devices=[torch.device("cuda", 0)] * n)


def launched(fn) -> dict[str, int]:
    """The SNN kernels' launches by the wrappers' counters while ``fn`` runs."""
    before = kernels.launch_counts()
    fn()
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    return {k: after[k] - before[k] for k in ("spike_matmul", "lif_scan", "sparse_accum")}


def check_n_times(sharded: dict, serial: dict, what: str) -> None:
    check(sum(serial.values()) > 0, f"{what}: the serial run launched no kernel")
    check(sharded == {k: N_SHARDS * v for k, v in serial.items()},
          f"{what}: sharded launches {sharded} != {N_SHARDS} x serial {serial}")


def same_stats(a: dict, b: dict) -> bool:
    return np.array_equal(a["input_events_per_step"], b["input_events_per_step"]) and all(
        np.array_equal(x, y) for x, y in zip(a["layer_events_per_step"], b["layer_events_per_step"])
    )


def walls(fn_a, fn_b, n: int = 3) -> tuple[float, float]:
    """Best-of-``n`` walls (ms) of two functions, run in turns a, b, b, a, ..."""
    ta, tb = [], []
    for i in range(n):
        order = [(fn_a, ta), (fn_b, tb)] if i % 2 == 0 else [(fn_b, tb), (fn_a, ta)]
        for fn, out in order:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append(1e3 * (time.perf_counter() - t0))
    return min(ta), min(tb)


def phase_shard_eval_int(net, qparams, smi: str) -> dict:
    """``eval_int`` on phase 4's set at batch 4096 through ``fused`` and
    ``event`` (its fixed-capacity surrogate on every shard), and a batch of
    4093 (padding): accuracy and statistics equal to the serial run;
    launches of the 4096 batch = 4 x the serial run's at 1024 samples."""
    ds = mnist_like(n=4096, T=25, seed=2)
    odd = SpikeDataset(ds.spikes[:4093], ds.labels[:4093], ds.n_classes, ds.name + ":4093")
    mesh = card_mesh()
    runs = {}
    for name in ("fused", "event"):
        runs[name] = eval_int(net, qparams, ds, batch_size=4096, return_stats=True, backend=name,
                              mesh=mesh)
    runs["fused-4093"] = eval_int(net, qparams, odd, batch_size=4096, return_stats=True,
                                  backend="fused", mesh=mesh)
    counts = read_counts()
    for name, data, backend in [("fused", ds, "fused"), ("event", ds, "event"),
                                ("fused-4093", odd, "fused")]:
        acc, st = eval_int(net, qparams, data, batch_size=4096, return_stats=True, backend=backend)
        check(runs[name][0] == acc and same_stats(runs[name][1], st),
              f"sharded eval_int[{name}] != serial")
    x = raster_tensor(ds.spikes.transpose(1, 0, 2), DEVICE)
    per = len(ds.labels) // N_SHARDS
    for name in ("fused", "event"):
        backend = backend_mod.get_backend(name)
        surrogate = backend.jit_surrogate(net, x) or backend  # what every shard runs
        sharded = launched(lambda: run_int_sharded(net, qparams, x, mesh, backend=backend))
        serial = launched(lambda: surrogate.run_int(net, qparams, x[:, :per].contiguous()))
        check_n_times(sharded, serial, f"eval_int[{name}] batch")
        if name == "event":
            check(sharded["sparse_accum"] >= N_SHARDS, "event: sparse_accum not on every shard")
        print(f"shard eval_int[{name}]: 4096-sample batch launches {json.dumps(sharded)} = "
              f"{N_SHARDS} x serial at {per} samples {json.dumps(serial)}")
    ms_serial, ms_sharded = walls(
        lambda: eval_int(net, qparams, ds, batch_size=4096, backend="fused"),
        lambda: eval_int(net, qparams, ds, batch_size=4096, backend="fused", mesh=mesh),
    )
    print(
        f"shard eval_int: fused and event (4096) and fused (4093, padded to 4096) on "
        f"{N_SHARDS} shards of one card equal serial in accuracy ({runs['fused'][0]:.6f}) and "
        f"float32 stats; 4096-sample fused batch wall: serial {ms_serial:.3f} ms, sharded "
        f"{ms_sharded:.3f} ms ({ms_sharded / ms_serial:.3f}x) on {smi}"
    )
    sharded_run = lambda: eval_int(net, qparams, ds, batch_size=4096, backend="fused", mesh=mesh)
    print(f"shard eval_int[fused] batch split: {device_split(sharded_run, n=3)}")
    return counts


def phase_shard_batched(net, qparams) -> dict:
    """``run_int_batched`` over 510 ragged samples (padded to 512 with
    zero-length lanes) on the mesh: equal to the serial record; launches = 4
    x the serial run's at 128 samples."""
    ds = mnist_like(n=510, T=25, seed=13)
    rng = np.random.default_rng(13)
    lengths = rng.integers(1, 26, 510).astype(np.int32)
    x = raster_tensor(ds.spikes.transpose(1, 0, 2), DEVICE)
    mesh = card_mesh()
    rec = backend_mod.run_int_batched(net, qparams, x, lengths, mesh=mesh)
    counts = read_counts()
    assert_records_equal(rec, backend_mod.run_int_batched(net, qparams, x, lengths),
                         "sharded run_int_batched")
    x4, l4 = x[:, :508], lengths[:508]  # a batch that divides: 127 a shard
    sharded = launched(lambda: backend_mod.run_int_batched(net, qparams, x4, l4, mesh=mesh))
    serial = launched(lambda: backend_mod.run_int_batched(net, qparams, x4[:, :127], l4[:127]))
    check_n_times(sharded, serial, "run_int_batched")
    print(f"shard run_int_batched: 510 ragged samples (lengths 1..25) equal serial; launches "
          f"{json.dumps(sharded)} = {N_SHARDS} x serial at 127 samples")
    return counts


def phase_shard_sweep(dse, smi: str) -> dict:
    """``eval_int_population`` at P = 510 (edge-padded to 512) on phase 9's
    DSE net: each candidate's accuracy and stats equal to the serial sweep;
    P = 512 launches = 4 x the serial sweep's at P = 128."""
    net, params, _, test, space = dse
    rng = np.random.default_rng(1)
    all_cfgs = list(itertools.product(space.ff_bits, space.rec_bits, space.leak_bits))
    picks = [all_cfgs[i] for i in rng.choice(len(all_cfgs), 512, replace=False)]
    cs = [net.replace_precisions(w_bits=a, w_rec_bits=b, leak_bits=c) for a, b, c in picks]
    qs = [quantize_params(c, params)[0] for c in cs]
    batch, mesh = len(test.labels), card_mesh()
    accs, stats = eval_int_population(net, cs[:510], qs[:510], test, batch_size=batch,
                                      return_stats=True, mesh=mesh)
    counts = read_counts()
    want, want_stats = eval_int_population(net, cs[:510], qs[:510], test, batch_size=batch,
                                           return_stats=True)
    check(np.array_equal(accs, want), "sharded sweep accuracies != serial")
    check(all(same_stats(a, b) for a, b in zip(stats, want_stats)), "sharded sweep stats != serial")
    x = raster_tensor(test.spikes.transpose(1, 0, 2), DEVICE)
    stacked, b_regs, a_regs = stack_population(cs, qs)
    quarter = [IntLayerParams(*(t[:128] for t in p)) for p in stacked]
    sharded = launched(lambda: run_int_population_sharded(net, stacked, b_regs, a_regs, x, mesh))
    serial = launched(lambda: run_int_population(net, quarter, b_regs[:128], a_regs[:128], x))
    check_n_times(sharded, serial, "sweep P=512")
    ms_serial, ms_sharded = walls(
        lambda: eval_int_population(net, cs, qs, test, batch_size=batch, return_stats=True),
        lambda: eval_int_population(net, cs, qs, test, batch_size=batch, return_stats=True,
                                    mesh=mesh),
    )
    print(
        f"shard sweep: P=510 on {N_SHARDS} shards (edge-padded to 512) equal to the serial sweep "
        f"in every accuracy and float32 stat; P=512 launches {json.dumps(sharded)} = "
        f"{N_SHARDS} x serial at P=128; P=512 sweep wall: serial {ms_serial:.3f} ms, sharded "
        f"{ms_sharded:.3f} ms ({ms_sharded / ms_serial:.3f}x) on {smi}"
    )
    return counts


def phase_shard_dse(dse, found: dict) -> dict:
    """``explore_snn`` on phase 9's search with ``EvalSpec(mesh=...)``: the
    same ``to_json()`` as phase 9's unsharded search on the same weights
    (population 64 divides over 4 shards, so the sweep widths stay)."""
    net, params, _, test, space = dse
    t0 = time.perf_counter()
    res = dse_search(net, params, test, space, mesh=card_mesh())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    check(json.dumps(res.to_json(), sort_keys=True) == json.dumps(found["dse_json"], sort_keys=True),
          "sharded explore_snn != phase 9's search")
    print(f"shard dse: explore_snn nsga2 (64 x 3) with EvalSpec(mesh={N_SHARDS} shards) gives phase "
          f"9's to_json() over {len(res.search.cache)} candidates ({wall:.3f} s)")
    return counts


def phase_shard_serve(net, qparams, serve_results: dict, smi: str) -> dict:
    """``SNNServeEngine(max_batch=64, data_parallel=<4-shard mesh>)``: phase
    5's 256 requests, each equal to phase 5's counts, then 16 streaming
    sessions against serial ``run_int``; the unsharded engine on the same
    traffic runs the same ticks with a quarter of the launches."""
    mk = lambda dp: SNNServeEngine(net, qparams, max_batch=64, data_parallel=dp,
                                   backend=EventBackend(strategy="pallas"), device=DEVICE)
    engine = mk(card_mesh())
    check(engine.data_parallel == N_SHARDS, f"engine data_parallel {engine.data_parallel}")
    engine.warmup(include_int32=True)
    reset_counts()
    done = []
    t0 = time.perf_counter()
    four = launched(lambda: done.extend(engine.run(serving_traffic(net.n_in))))
    wall = time.perf_counter() - t0
    groups = [(name, r[:6]) for name, r in stream_groups(net.n_in)][:2]
    groups.append(("graded", stream_groups(net.n_in)[2][1][:4]))
    readouts, _, _, _ = drive_streams(mk(card_mesh()), groups)
    counts = read_counts()
    check(len(done) == 256 and all(r.status == "completed" for r in done), "sharded: all served")
    for r in done:
        check(np.array_equal(r.spike_counts, serve_results[r.uid]),
              f"sharded engine: request {r.uid} differs from phase 5")
    for name, rasters in groups:
        prefix = prefix_oracle(net, qparams, rasters, DEVICE)
        check_readouts(readouts, [f"{name}{i}" for i in range(len(rasters))], prefix, "sharded stream")
    ticks4 = {k: v for k, v in engine.metrics.counters.items() if k.startswith("tick:")}
    plain = mk(None)
    plain.warmup(include_int32=True)
    t0 = time.perf_counter()
    one = launched(lambda: plain.run(serving_traffic(net.n_in)))
    plain_wall = time.perf_counter() - t0
    ticks1 = {k: v for k, v in plain.metrics.counters.items() if k.startswith("tick:")}
    check(ticks4 == ticks1, f"sharded ticks {ticks4} != unsharded {ticks1}")
    check_n_times(four, one, "served burst")
    print(
        f"shard serve: 64 lanes as {N_SHARDS} pools of 16, data_parallel {engine.data_parallel}; "
        f"256 requests equal to phase 5, {len(readouts)} streams equal to serial run_int; ticks "
        f"{ticks4} as unsharded; launches {json.dumps(four)} = {N_SHARDS} x unsharded "
        f"{json.dumps(one)}; burst wall: unsharded {1e3 * plain_wall:.3f} ms, sharded "
        f"{1e3 * wall:.3f} ms ({wall / plain_wall:.3f}x) on {smi}"
    )
    print(f"shard serve: {dispatch_vs_tick(engine, wall)}")
    return counts


def phase_shard_cards(net, qparams) -> None:
    """The real cards, one shard each, where the machine has more than one."""
    n = torch.cuda.device_count()
    if n < 2:
        print(f"shard cards: not run (this machine has {n} card; the mesh above names card 0 "
              f"{N_SHARDS} times)")
        return
    mesh = make_mesh(n)
    ds = mnist_like(n=4096, T=25, seed=2)
    for name in ("fused", "event"):
        got = eval_int(net, qparams, ds, batch_size=4096, return_stats=True, backend=name, mesh=mesh)
        want = eval_int(net, qparams, ds, batch_size=4096, return_stats=True, backend=name)
        check(got[0] == want[0] and same_stats(got[1], want[1]), f"{n}-card eval_int[{name}]")
    ms_serial, ms_sharded = walls(
        lambda: eval_int(net, qparams, ds, batch_size=4096, backend="fused"),
        lambda: eval_int(net, qparams, ds, batch_size=4096, backend="fused", mesh=mesh),
    )
    print(f"shard cards: eval_int on {n} cards equals serial; fused batch wall serial "
          f"{ms_serial:.3f} ms, {n} cards {ms_sharded:.3f} ms")


# ---------------------------------------------------------------------------
# Phase 13: LM training through the production loop
# ---------------------------------------------------------------------------

TRAIN_ARCHS = ("stablelm-1.6b", "granite-moe-1b-a400m")
TRAIN_SEQ, TRAIN_BATCH = 256, 8  # launch/train.py's defaults
TRAIN_WARMUP, TRAIN_TIMED = 2, 5
LOOP_DIR = ROOT / "build" / "phase13"  # the TrainLoop's checkpoints (git-ignored)
# examples/lm_train_100m.py's ~100 M config of the stablelm family
LM100M = dict(n_layers=12, d_model=512, n_heads=8, n_kv_heads=8, d_head=64, d_ff=1408, vocab=8192)
LOOP_STEPS, LOOP_CKPT, LOOP_FAIL, LOOP_MORE = 60, 20, 30, 10
MOE_QDOTS_PER_LAYER = 4  # wq wk wv wo; granite's experts are 4-D leaves and stay float


def loop_optimizer():
    """TrainLoop's optimizer: AdamW over ``linear_warmup_cosine(3e-4, 20, 10000)``."""
    return adamw(linear_warmup_cosine(3e-4, 20, 10_000))


def matmul_params(arch, cfg) -> float:
    """The parameters one token multiplies by: every 2-D block weight, the
    routed experts' at top_k / n_experts, the head (the tied embedding or
    ``lm_head``); not norms, biases, the SSD's depthwise conv or the input
    embedding's lookup."""
    n = 0.0
    for path, spec in tree_leaves(arch.template(cfg)):
        shape = spec.shape
        if path == "embed":
            n += math.prod(shape) if cfg.tie_embeddings else 0
        elif path == "lm_head":
            n += math.prod(shape)
        elif path.startswith("blocks/") and len(shape) >= 3 and not path.endswith("/conv_w"):
            share = 1.0
            if "/moe/w_" in path:
                share = cfg.moe.top_k / cfg.moe.n_experts
            n += math.prod(shape) * share
    return n


def model_flops_per_token(arch, cfg, seq: int) -> float:
    """Model FLOPs of one token's forward and backward: 6 x ``matmul_params``
    plus attention's scores and values, 12 x attention layers x seq x heads
    x d_head (PaLM's model FLOPs; the causal half not taken off; remat's
    recompute not counted), plus 3 x the SSD's forward products per token
    and SSM layer: 2 (chunk x G x N + chunk x H x P + 2 H x P x N), the
    intra-chunk scores and outputs, the chunk states and the inter-chunk
    outputs (the chunk is min(cfg.ssm.chunk, seq))."""
    pattern = tfm.layer_pattern(cfg)
    groups = tfm.n_groups(cfg)
    n_attn = groups * sum(k.mixer == "attn" for k in pattern)
    flops = 6 * matmul_params(arch, cfg) + 12 * n_attn * seq * cfg.n_heads * cfg.d_head
    if cfg.ssm is not None:
        s = cfg.ssm
        ch = min(s.chunk, seq)
        hp = s.n_heads * s.head_dim
        fwd = 2 * (ch * s.n_groups * s.d_state + ch * hp + 2 * hp * s.d_state)
        flops += 3 * fwd * groups * sum(k.mixer == "ssm" for k in pattern)
    return flops


def route_card_vs_cpu(cfg, params, tokens) -> str:
    """Layer 0's router on one chunk of the step's batch (the embedded tokens
    after ``norm2``, f32 logits computed once on the CPU) routed on the card
    and on the CPU: the same experts for every token whose k-th and
    (k+1)-th probabilities differ by more than 1e-6 relative (float rounding
    decides the rest), and rows of exact ties on the lower experts."""
    moe = cfg.moe
    blk = tree_map(lambda _, t: t[0], params["blocks"])["pos0"]
    x = rms_norm(tfm._embed_tokens(cfg, params, tokens), blk["norm2"]).float().cpu()
    logits = torch.einsum("bcd,de->bce", x, blk["moe"]["router"].float().cpu())
    ties = torch.zeros(2, moe.n_experts)
    ties[1, ::2] = 1.0  # 16 tied for 8 places
    logits = torch.cat([logits.reshape(-1, moe.n_experts), ties])[None]
    g_cpu, a_cpu = mlp_mod._route(moe, logits)
    g_card, a_card = mlp_mod._route(moe, logits.to(DEVICE))
    probs = torch.softmax(logits, dim=-1).sort(dim=-1, descending=True).values
    gap = probs[..., moe.top_k - 1] - probs[..., moe.top_k]
    decided = gap > 1e-6 * probs[..., moe.top_k - 1]
    same = ((g_card.cpu() > 0) == (g_cpu > 0)).all(dim=-1)
    check(bool(same[decided].all()), "MoE routing card vs CPU differs on a decided token")
    picked = [(g_card[0, -i].cpu() > 0).nonzero()[:, 0].tolist() for i in (2, 1)]
    check(picked == [list(range(moe.top_k)), list(range(0, 2 * moe.top_k, 2))],
          f"MoE routing on the card breaks ties as {picked}")
    check(abs(float(a_card) - float(a_cpu)) <= 1e-6 * abs(float(a_cpu)), "MoE aux card vs CPU")
    n = same.numel() - 2
    return (
        f"layer-0 routing of {n} tokens (top {moe.top_k} of {moe.n_experts}) equal card vs CPU "
        f"on {int(same[0, :n][decided[0, :n]].sum())} decided tokens, "
        f"{n - int(decided[0, :n].sum())} within 1e-6 (equal: {int(same[0, :n].sum())} of {n}); "
        f"exact-tie rows on experts 0..{moe.top_k - 1} and the {moe.top_k} lowest even ones"
    )


def fwd_bwd_share(arch, cfg, params, batch, timed: list[float]) -> str:
    """Where a step's wall goes: the loss and its gradients alone (the
    step's ``lm_loss`` and ``torch.autograd.grad``, best of 3), and the rest
    of the step -- clipping and the AdamW update -- by difference."""
    leaves = [t for _, t in tree_leaves(params)]
    loss_fn = arch.loss_fn(cfg)
    secs = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        diff = [t.detach().requires_grad_(True) for t in leaves]
        loss, _ = loss_fn(tree_unflatten(params, diff), batch)
        grads = torch.autograd.grad(loss, diff)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        del diff, loss, grads
    fb, step_s = min(secs), min(timed)
    return (
        f"forward + backward alone {1e3 * fb:.3f} ms (best of 3); the fastest step "
        f"{1e3 * step_s:.3f} ms, so clipping and the AdamW update take about "
        f"{1e3 * (step_s - fb):.3f} ms ({100 * (step_s - fb) / step_s:.1f} % of the step)"
    )


def phase_lm_train_full(name: str, smi: str) -> dict:
    """One full-width train step (``build_train_step``) of ``name`` at
    launch/train.py's defaults: seq 256, batch 8, the loop's AdamW schedule,
    ``remat="block"`` (the config's).  2 warm-up and 5 timed steps on
    ``SyntheticTokens`` batches; the loss finite and falling over the 7."""
    arch = get_arch(name)
    cfg = arch.config
    shape = ShapeSpec("train", TRAIN_SEQ, TRAIN_BATCH, "train")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = arch.init_params(torch.Generator(device=DEVICE).manual_seed(0), cfg)
    n_params = sum(t.numel() for _, t in tree_leaves(params))
    opt = loop_optimizer()
    state = opt.init([t for _, t in tree_leaves(params)])
    step = build_train_step(arch, shape, None, cfg, optimizer=opt).jitted
    data = SyntheticTokens(vocab=cfg.vocab, seq_len=TRAIN_SEQ, batch=TRAIN_BATCH, seed=0)
    batches = [{k: torch.from_numpy(v).to(DEVICE) for k, v in next(data).items()}
               for _ in range(TRAIN_WARMUP + TRAIN_TIMED)]
    if arch.family == "vlm":  # input_template's split: 128 patches (an 8 x 16 grid) + 128 text
        n_vis = min(arch.n_vision_tokens, TRAIN_SEQ // 2)
        gen = torch.Generator(device=DEVICE).manual_seed(1)
        pos3 = vlm_positions3(TRAIN_BATCH, 8, n_vis // 8, TRAIN_SEQ)
        batches = [
            {"tokens": b["tokens"][:, n_vis:], "targets": b["targets"][:, n_vis:],
             "vision_embeds": torch.randn(TRAIN_BATCH, n_vis, cfg.d_model, device=DEVICE,
                                          generator=gen).to(torch.bfloat16),
             "positions3": pos3}
            for b in batches
        ]
        want = {k: s for k, (s, _) in arch.input_template(shape, cfg).items()}
        check({k: tuple(v.shape) for k, v in batches[0].items()} == want, f"{name}: batch shapes")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    reset_counts()
    losses, secs = [], []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, metrics = step(params, state, b)
        losses.append(float(metrics["loss"]))  # the loop's sync
        secs.append(time.perf_counter() - t0)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    check(all(math.isfinite(x) for x in losses), f"{name}: a loss is not finite: {losses}")
    check(losses[-1] < losses[0], f"{name}: the loss did not fall over 7 steps: {losses}")
    check(sum(counts.values()) == 0, f"{name}: the train step launched a kernel: {counts}")
    timed = secs[TRAIN_WARMUP:]
    step_s = statistics.mean(timed)
    tokens = TRAIN_SEQ * TRAIN_BATCH  # positions through the model (patches included)
    flops = model_flops_per_token(arch, cfg, TRAIN_SEQ) * tokens
    print(
        f"lm train {name}: full width ({cfg.n_layers} layers, d_model {cfg.d_model}, vocab "
        f"{cfg.vocab}{f', {cfg.moe.n_experts} experts top {cfg.moe.top_k}' if cfg.moe else ''}), "
        f"{n_params} f32 parameters, remat={cfg.remat}, seq {TRAIN_SEQ} x batch {TRAIN_BATCH}; "
        f"set-up {setup_s:.3f} s; losses {[round(x, 6) for x in losses]}; steps (s) "
        f"{[round(x, 4) for x in secs]}; timed mean {1e3 * step_s:.3f} ms a step (min "
        f"{1e3 * min(timed):.3f}), {tokens / step_s:.1f} tokens/s, model FLOPs "
        f"{flops:.4e} a step ({matmul_params(arch, cfg):.4e} matmul parameters a token, "
        f"attention included) = {flops / step_s / 1e12:.2f} TFLOP/s, "
        f"{flops / step_s / BF16_TC_FLOPS:.4f} of the dense bf16 peak; peak memory "
        f"{peak / 2**30:.3f} GiB (max_memory_allocated); launches {json.dumps(counts)}; on {smi}"
    )
    if cfg.moe is not None:
        route = route_card_vs_cpu(cfg, params, batches[0]["tokens"][:, : cfg.moe.seq_chunk])
        print(f"lm train {name}: {route}")
    print(f"lm train {name}: {fwd_bwd_share(arch, cfg, params, batches[-1], timed)}")
    split = device_split(lambda: step(params, state, batches[-1]), n=2, top=8, width=120)
    print(f"lm train {name} step split: {split}")
    del params, state, step, batches, metrics
    torch.cuda.empty_cache()
    return counts


def phase_lm_train_loop(smi: str) -> dict:
    """``TrainLoop`` at examples/lm_train_100m.py's ~100 M config (12 x 512,
    vocab 8192), seq 256 x batch 8, 60 steps, a checkpoint every 20, a node
    failure injected at step 30: one failure, restored at 20, 60 steps
    reached, the loss fallen, the failure and restored events in
    metrics.jsonl; then a second ``run`` on the same directory resumes from
    LATEST (60) and goes on 10 steps."""
    arch = get_arch("stablelm-1.6b")
    cfg = dataclasses.replace(arch.reduced_config, **LM100M)
    shutil.rmtree(LOOP_DIR, ignore_errors=True)
    run_dir = LOOP_DIR / "lm100m"

    def make() -> TrainLoop:
        loop = TrainLoop("stablelm-1.6b", TRAIN_SEQ, TRAIN_BATCH, None, str(run_dir),
                         ckpt_every=LOOP_CKPT, log_every=10, fail_at_step=LOOP_FAIL, device=DEVICE)
        loop.arch = dataclasses.replace(arch, reduced_config=cfg)
        loop.cfg = cfg
        return loop

    reset_counts()
    t0 = time.perf_counter()
    out = make().run(LOOP_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    t0 = time.perf_counter()
    more = make().run(LOOP_STEPS + LOOP_MORE)
    more_wall = time.perf_counter() - t0
    events = [json.loads(line) for line in open(out["metrics_path"])]
    kinds = [(e["event"], e["step"]) for e in events if e["event"] != "straggler"]
    check(out["failures"] == 1, f"TrainLoop failures {out['failures']}")
    check(out["final_step"] == LOOP_STEPS, f"TrainLoop final step {out['final_step']}")
    check(out["final_loss"] < out["first_loss"],
          f"TrainLoop loss {out['first_loss']} -> {out['final_loss']}")
    check(("failure", LOOP_FAIL) in kinds and ("restored", LOOP_FAIL // LOOP_CKPT * LOOP_CKPT) in kinds,
          f"TrainLoop events {kinds}")
    check(more["final_step"] == LOOP_STEPS + LOOP_MORE and more["failures"] == 0,
          f"TrainLoop second run {more}")
    check(("resume", LOOP_STEPS) in kinds, f"second run did not resume from LATEST: {kinds}")
    n_params = sum(math.prod(s.shape) for _, s in tree_leaves(arch.template(cfg)))
    dts = [e["dt"] for e in events if e["event"] == "step"]
    ran = LOOP_STEPS + (LOOP_FAIL - LOOP_FAIL // LOOP_CKPT * LOOP_CKPT)
    stragglers = sum(e["event"] == "straggler" for e in events)
    print(
        f"lm train loop: TrainLoop at ~100 M ({n_params} parameters, 12 x 512, vocab 8192), "
        f"seq {TRAIN_SEQ} x batch {TRAIN_BATCH}: {LOOP_STEPS} steps with a failure at "
        f"{LOOP_FAIL} restored at {LOOP_FAIL // LOOP_CKPT * LOOP_CKPT} ({ran} steps run) in "
        f"{wall:.3f} s, checkpoints every {LOOP_CKPT}; loss {out['first_loss']:.6f} -> "
        f"{out['final_loss']:.6f}; logged step walls (s) {dts}; {stragglers} straggler events; "
        f"resumed from LATEST at {LOOP_STEPS} and ran {LOOP_MORE} more in {more_wall:.3f} s "
        f"(loss {more['final_loss']:.6f}); on {smi}"
    )
    shutil.rmtree(LOOP_DIR, ignore_errors=True)
    return counts


def f64_step(arch, cfg, shape, params, batch) -> None:
    """The reduced train step on the CPU with every float32 of the program
    run as float64: the parameters and the compute dtype f64 and
    ``torch.float32`` itself patched to ``torch.float64`` for the call, so
    the casts to f32 in the model cast to f64.  The caller's spy on
    ``clip_by_global_norm`` reads its gradients."""
    f64 = torch.float64
    p = tree_map(lambda _, t: t.to(f64, copy=True), params)
    opt = loop_optimizer()
    st = opt.init([t for _, t in tree_leaves(p)])
    c64 = dataclasses.replace(cfg, compute_dtype=f64)
    step = build_train_step(arch, shape, None, c64, optimizer=opt).jitted
    with mock.patch.object(torch, "float32", f64):
        step(p, st, batch)


def f64_witness(params, seen) -> str:
    """The card's (``seen[0]``) and the CPU's (``seen[1]``) f32 gradients
    against the CPU's f64 ones (``seen[2]``), leaf by leaf as max |error| /
    max |g|: the card's worst must be within SSM_F64_RATIO of the CPU's."""
    g_card, g_cpu, g64 = seen
    check(all(g.dtype == torch.float64 for g in g64), "f64 witness: a gradient is not f64")
    names = [n for n, _ in tree_leaves(params)]
    card = sorted(((rel_err(a, w), n) for a, w, n in zip(g_card, g64, names)), reverse=True)
    cpu = sorted(((rel_err(a, w), n) for a, w, n in zip(g_cpu, g64, names)), reverse=True)
    check(card[0][0] <= SSM_F64_RATIO * cpu[0][0],
          f"f64 witness: the card's f32 gradients {card[0][0]:.3e} of max |g| from f64, the "
          f"CPU's {cpu[0][0]:.3e}")
    top = lambda errs: ", ".join(f"{n} {e:.3e}" for e, n in errs[:3])
    return (
        f"gradients against the CPU's f64 step, max |error| / max |g| of the worst leaves: "
        f"card f32 {top(card)}; CPU f32 {top(cpu)} (ratio of the worst "
        f"{card[0][0] / cpu[0][0]:.3f}, limit {SSM_F64_RATIO})"
    )


def phase_lm_train_card_vs_cpu(names=("stablelm-1.6b", "qwen2-moe-a2.7b")) -> None:
    """One reduced-config train step at f32 compute on the card and on the
    CPU from the same parameters and batch (phase 13: stablelm; qwen2-moe
    with shared experts; phase 14: mamba2, jamba, qwen2-vl with patch
    embeddings), held stage by stage to CARD_VS_CPU_TOL (SSM configs'
    gradients to SSM_GRAD_TOL, and both f32 gradients against an f64 step on
    the CPU, :func:`f64_witness`): the loss, each
    gradient leaf (read where the step clips them) and the AdamW update
    from the CPU's clipped gradients on both devices; the composed step's
    parameters printed; a MoE config's layer-0 routing card == CPU.  Phase
    15d: whisper-medium (audio frames in its batch)."""
    real = opt_mod.clip_by_global_norm
    for name in names:
        arch = get_arch(name)
        cfg = dataclasses.replace(arch.reduced_config, compute_dtype=torch.float32)
        shape = ShapeSpec("train", 64, 4, "train")
        params = arch.init_params(torch.Generator().manual_seed(0), cfg)
        batch = arch.input_concrete(torch.Generator().manual_seed(1), shape, cfg)
        seen, out = [], {}

        def spy(grads, max_norm, batch_dims=0):
            seen.append([g.cpu() for g in grads])
            return real(grads, max_norm, batch_dims)

        with mock.patch.object(opt_mod, "clip_by_global_norm", spy):
            for dev in (DEVICE, "cpu"):
                p = tree_map(lambda _, t: t.to(dev, copy=True), params)
                opt = loop_optimizer()
                st = opt.init([t for _, t in tree_leaves(p)])
                step = build_train_step(arch, shape, None, cfg, optimizer=opt).jitted
                p, _, m = step(p, st, {k: v.to(dev) for k, v in batch.items()})
                out[dev] = (float(m["loss"]), [t.cpu() for _, t in tree_leaves(p)])
            if getattr(cfg, "ssm", None) is not None:
                f64_step(arch, cfg, shape, params, batch)
        (lg, pg), (lc, pc) = out[DEVICE], out["cpu"]
        check(abs(lg - lc) <= CARD_VS_CPU_TOL * abs(lc), f"{name}: train loss card {lg} vs CPU {lc}")
        g_err = max(rel_err(a, b) for a, b in zip(seen[0], seen[1]))
        ssm = getattr(cfg, "ssm", None) is not None
        g_tol = SSM_GRAD_TOL if ssm else CARD_VS_CPU_TOL
        check(g_err <= g_tol, f"{name}: gradients card vs CPU {g_err:.3e} of max |g|")
        if ssm:
            print(f"lm train card vs CPU ({name} reduced): {f64_witness(params, seen)}")
        clipped, _ = real(seen[1], 1.0)
        leaves = [t for _, t in tree_leaves(params)]
        updated = {}
        for dev in ("cpu", DEVICE):
            opt = loop_optimizer()
            ps = [t.to(dev) for t in leaves]
            upd, _ = opt.update([g.to(dev) for g in clipped], opt.init(ps), ps)
            updated[dev] = [p + u for p, u in zip(ps, upd)]
        u_err = max(rel_err(a, b) for a, b in zip(updated[DEVICE], updated["cpu"]))
        check(u_err <= CARD_VS_CPU_TOL, f"{name}: AdamW update card vs CPU {u_err:.3e} of max |w|")
        composed = max(rel_err(a, b) for a, b in zip(pg, pc))
        if getattr(cfg, "moe", None) is not None:
            p_card = tree_map(lambda _, t: t.to(DEVICE), params)
            tokens = batch["tokens"][:, : cfg.moe.seq_chunk].to(DEVICE)
            route = route_card_vs_cpu(cfg, p_card, tokens)
            print(f"lm train card vs CPU ({name} reduced): {route}")
        print(
            f"lm train card vs CPU ({name} reduced, f32 compute, seq 64 x batch 4): loss "
            f"{lg:.8f} vs {lc:.8f}; gradients within {g_err:.3e} of max |g| (limit {g_tol}), the "
            f"AdamW update from the same gradients within {u_err:.3e} of max |w| (limit "
            f"{CARD_VS_CPU_TOL}); the "
            f"composed step's parameters within {composed:.3e} of max |w|"
        )


@contextlib.contextmanager
def recorded_quant_matmul():
    """Every ``quant_matmul`` launch made through ``qdot`` while the block
    runs: (x, q, scale, bits, out), for checking against the plain version."""
    from repro_torch.kernels.quant_matmul import quant_matmul as qm_module

    seen, real = [], qm_module.quant_matmul

    def record(x, q, scale, *, bits, **kw):
        out = real(x, q, scale, bits=bits, **kw)
        seen.append((x.clone(), q, scale, bits, out.clone()))
        return out

    # the wrapper counts through its module's name, which names ``record``
    # inside the block: the count moves there and back
    record.launches = real.launches
    with mock.patch.object(qm_module, "quant_matmul", record):
        yield seen
    real.launches = record.launches


def phase_lm_serve_moe(smi: str) -> dict:
    """``ServeEngine`` on int8 granite-moe-1b-a400m at full width (the
    attention projections int8; the experts are 4-D leaves and stay float,
    as in JAX): 8 requests of 4-32 prompt tokens, 4 new tokens each;
    ``quant_matmul`` launches = 4 x 24 x decode steps, each equal to its
    plain version on the card to the bf16 tolerance of phase 2."""
    arch = get_arch("granite-moe-1b-a400m")
    full = dataclasses.replace(arch, reduced_config=arch.config)
    params = arch.init_params(torch.Generator(device=DEVICE).manual_seed(0))
    engine = ServeEngine(full, params, max_batch=8, max_len=64, quant=lm_policy(8), device=DEVICE)
    del params
    reqs = lm_requests(8, 4, arch.config.vocab)
    with recorded_quant_matmul() as seen:
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = engine.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
    steps = engine.decode_steps
    check(len(done) == 8 and all(len(r.generated) == 4 for r in done), "MoE serving: all served")
    check(all(0 <= t < arch.config.vocab for r in done for t in r.generated), "MoE tokens in vocab")
    n_qdots = MOE_QDOTS_PER_LAYER * arch.config.n_layers
    check(counts["quant_matmul"] == n_qdots * steps > 0,
          f"MoE serving: quant_matmul launches {counts['quant_matmul']} != {n_qdots} x {steps}")
    check(len(seen) == counts["quant_matmul"], "MoE serving: recorded launches != counted")
    err = 0.0
    for x, q, scale, bits, out in seen:
        want = quant_matmul_ref(x, q, scale, bits, out.dtype)
        err = max(err, close(out, want, QM_TOL, f"MoE serving quant_matmul {list(x.shape)}"))
    prompt_toks = sum(len(r.prompt) for r in reqs)
    print(
        f"lm serve moe: {arch.name} full width int8 (attention projections), 8 requests "
        f"({prompt_toks} prompt tokens, token by token), 32 generated in {steps} decode steps, "
        f"{wall:.3f} s = {1e3 * wall / steps:.3f} ms/step; {counts['quant_matmul']} quant_matmul "
        f"launches = {n_qdots} x {steps}, each within the bf16 tolerance of plain (max_abs_err "
        f"{err:.3e}); req0 {sorted(done, key=lambda r: r.uid)[0].generated}; on {smi}"
    )
    del engine, seen
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# Phase 14: the SSM, hybrid and VLM LMs at full width
# ---------------------------------------------------------------------------

SSM_ARCH, HYBRID_ARCH, VLM_ARCH = "mamba2-780m", "jamba-v0.1-52b", "qwen2-vl-2b"
# the SSD against the token-by-token recurrence:
# tests/test_models.py::test_ssd_scan_matches_naive_recurrence's limit
SSD_TOL = 2e-3
SSD_PREFILL = 512  # two SSD chunks of 256: the inter-chunk recurrence runs
LONG_PREFILL = 4096
# phase 14's served prompts: 4-12 tokens (admission prefills token by token,
# one decode step a token, so the prompts set most of a run's steps)
SHORT_PROMPT = 12


def check_recorded_qm(seen, what: str) -> float:
    """Each recorded ``quant_matmul`` launch against ``quant_matmul_ref`` at
    QM_TOL.  The launches of one weight are checked in one plain
    call over their rows stacked (the plain version's rows are independent
    of each other); returns the max abs error."""
    groups: dict = {}
    for x, q, scale, bits, out in seen:
        groups.setdefault((q.data_ptr(), tuple(q.shape), bits), []).append((x, q, scale, out))
    err = 0.0
    for (_, _, bits), items in groups.items():
        x = torch.cat([i[0] for i in items])
        out = torch.cat([i[3] for i in items])
        q, scale = items[0][1], items[0][2]
        want = quant_matmul_ref(x, q, scale, bits, out.dtype)
        K, N = q.shape[0], scale.shape[0]
        shape = f"{len(items)} launches, [{x.shape[0]},{K}]x[{K},{N}]"
        err = max(err, close(out, want, QM_TOL, f"{what}: quant_matmul int{bits} {shape}"))
    return err


def vlm_positions3(B: int, rows: int, cols: int, S: int) -> torch.Tensor:
    """Qwen2-VL's M-RoPE positions [3, B, S] of a rows x cols patch grid
    followed by text: patch (r, c) at (t, h, w) = (0, r, c), the text from
    the largest position + 1 on all three components."""
    n_vis = rows * cols
    r, c = torch.arange(n_vis) // cols, torch.arange(n_vis) % cols
    vis = torch.stack([torch.zeros(n_vis, dtype=torch.int64), r, c])
    text = (max(rows, cols) + torch.arange(S - n_vis)).expand(3, -1)
    pos = torch.cat([vis, text], dim=1)[:, None].expand(3, B, S)
    return pos.to(torch.int32).contiguous().to(DEVICE)


@contextlib.contextmanager
def recorded_flash_attention():
    """Every ``flash_attention`` launch made through ``flash_attend`` while
    the block runs: (q, k, v, keyword arguments, out) in [B, H, S, D]."""
    from repro_torch.kernels.flash_attention import ops as fa_ops

    seen, real = [], fa_ops.flash_attention

    def record(q, k, v, **kw):
        out = real(q, k, v, **kw)
        seen.append((q.clone(), k.clone(), v.clone(), kw, out.clone()))
        return out

    with mock.patch.object(fa_ops, "flash_attention", record):
        yield seen


def check_recorded_fa(seen, what: str, used: dict | None = None) -> tuple[float, dict]:
    """Each recorded ``flash_attention`` launch against
    ``flash_attention_ref`` (query head h on kv head h // (Hq / Hk)) to
    FA_TOL.  The first launch of each shape also against planted faults,
    each of which must fall outside: a 2x scale, the causal mask dropped
    (or, on a bidirectional launch, applied), query head h on kv head h %
    Hk (grouped-query launches), a zero output.  Returns the max abs error and
    the tolerance used by the kernel, then by each fault, per shape (into
    ``used`` where given: shapes already there are not faulted again)."""
    err, used = 0.0, {} if used is None else used
    for q, k, v, kw, out in seen:
        rep = q.shape[1] // k.shape[1]
        kr, vr = (t.repeat_interleave(rep, dim=1) for t in (k, v))
        want = flash_attention_ref(q, kr, vr, **kw)
        shape = f"{list(q.shape)} kv heads {k.shape[1]}"
        err = max(err, close(out, want, FA_TOL, f"{what}: flash_attention {shape}"))
        if shape in used:
            continue
        scale = kw.get("scale") or q.shape[-1] ** -0.5
        faults = {"scale x2": flash_attention_ref(q, kr, vr, **{**kw, "scale": 2 * scale})}
        if kw.get("causal", True):
            faults["no causal mask"] = flash_attention_ref(q, kr, vr, **{**kw, "causal": False})
        else:  # a bidirectional launch (Whisper's encoder)
            faults["causal mask applied"] = flash_attention_ref(q, kr, vr, **{**kw, "causal": True})
        if rep > 1 and k.shape[1] > 1:  # with one kv head, h % Hk is h // (Hq / Hk)
            faults["kv head h % Hk"] = flash_attention_ref(
                q, k.repeat(1, rep, 1, 1), v.repeat(1, rep, 1, 1), **kw)
        faults["zero output"] = torch.zeros_like(want)
        used[shape] = {"kernel": tol_used(out, want, FA_TOL)}
        for fault, wrong in faults.items():
            used[shape][fault] = tol_used(wrong, want, FA_TOL)
            check(used[shape][fault] > 1, f"{what}: planted fault {fault} passes the tolerance")
    return err, used


def timed_prefill(arch, cfg, qparams, batch, flash: int, qdots: int, what: str, smi: str) -> dict:
    """One prefill through the registry's ``prefill_fn`` with every kernel
    launch recorded: its launches counted, each ``quant_matmul`` launch held
    to plain at QM_TOL and each ``flash_attention`` launch at
    FA_TOL (:func:`check_recorded_fa`).  Then the same prefill again, warm
    and with nothing recorded, timed; then its device split."""
    prefill = arch.prefill_fn(cfg)
    S = batch["tokens"].shape[1]
    if "vision_embeds" in batch:
        S += batch["vision_embeds"].shape[1]
    with recorded_quant_matmul() as seen_qm, recorded_flash_attention() as seen_fa:
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = prefill(qparams, batch)
        torch.cuda.synchronize()
        checked_s = time.perf_counter() - t0
        counts = read_counts()
    check(counts["flash_attention"] == flash == len(seen_fa),
          f"{what}: {flash} flash_attention launches")
    check(counts["quant_matmul"] == qdots == len(seen_qm), f"{what}: {qdots} quant_matmul launches")
    check(logits.shape == (1, 1, cfg.vocab), f"{what}: logits shape")
    check(bool(torch.isfinite(logits).all()), f"{what}: logits finite")
    for pos, c in caches.items():
        for name, t in c.items():
            check(bool(torch.isfinite(t.float()).all()), f"{what}: cache {pos}/{name} finite")
    del caches
    qm_err = check_recorded_qm(seen_qm, what)
    fa_err, fa_used = check_recorded_fa(seen_fa, what)
    del seen_qm, seen_fa
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prefill(qparams, batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fa = (
        f"{flash} flash_attention launches each within FA_TOL of plain (max_abs_err "
        f"{fa_err:.3e}; tolerance used by the kernel, then by each planted fault (> 1 fails): "
        f"{json.dumps({k: {f: round(u, 4) for f, u in d.items()} for k, d in fa_used.items()})})"
    ) if flash else "no flash_attention"
    print(
        f"{what}: S={S} at full width (int8) in {wall:.3f} s warm with nothing recorded "
        f"({S / wall:.1f} tok/s; the checked pass before it {checked_s:.3f} s, the first call at "
        f"this size, every launch recorded); {qdots} quant_matmul launches each within QM_TOL "
        f"of plain (max_abs_err {qm_err:.3e}), {fa}; on {smi}"
    )
    split = device_split(lambda: prefill(qparams, batch), n=2, top=6, width=60)
    print(f"{what} split: {split}; on {smi}")
    return counts


def phase_ssm_prefill(arch, qparams, smi: str) -> dict:
    """mamba2-780m: one 4096-token int8 prefill (16 SSD chunks), timed;
    2 quant_matmul launches a layer, no attention."""
    cfg = arch.config
    tokens = torch.from_numpy(np.random.default_rng(14).integers(0, cfg.vocab, (1, LONG_PREFILL)))
    return timed_prefill(arch, cfg, qparams, {"tokens": tokens.to(DEVICE)}, 0,
                         2 * cfg.n_layers, "ssm prefill", smi)


def phase_ssm_prefill_vs_decode(arch, params, smi: str) -> None:
    """mamba2-780m at full width and f32 compute (float weights): a
    512-token prefill (two SSD chunks) against 512 token-by-token decode
    steps: every layer's final state and conv state and the next logits
    within SSD_TOL of max |value| (layer by layer).  The decode steps replay
    one CUDA graph of ``decode_step`` (the same kernels; eagerly at batch 1
    a step is host-bound, ~42 ms on an H100 for ~1 ms of device work)."""
    cfg = dataclasses.replace(arch.config, compute_dtype=torch.float32)
    tokens = torch.from_numpy(np.random.default_rng(15).integers(0, cfg.vocab, (1, SSD_PREFILL)))
    tokens = tokens.to(DEVICE)
    t0 = time.perf_counter()
    with torch.no_grad():
        logits, caches = tfm.prefill(cfg, params, tokens)
        torch.cuda.synchronize()
        t_prefill = time.perf_counter() - t0
        dec = tfm.cache_init(cfg, 1, 1, DEVICE)
        tok = torch.zeros_like(tokens[:, :1])
        cur = torch.zeros(1, dtype=torch.int32, device=DEVICE)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):  # one eager step before the capture
            tfm.decode_step(cfg, params, dec, tok, cur)
        torch.cuda.current_stream().wait_stream(side)
        for _, t in tree_leaves(dec):
            t.zero_()  # undo that step (decode writes the caches in place)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            step_logits, _ = tfm.decode_step(cfg, params, dec, tok, cur)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(SSD_PREFILL):
            tok.copy_(tokens[:, i : i + 1])
            graph.replay()
            cur += 1
        torch.cuda.synchronize()
        t_decode = time.perf_counter() - t0
    errs = {}
    for name in ("state", "conv"):
        got, want = dec["pos0"][name], caches["pos0"][name]
        check(got.shape == want.shape, f"ssd {name} shapes {got.shape} vs {want.shape}")
        scale = want.abs().amax(dim=tuple(range(1, want.dim())))
        errs[name] = ((got - want).abs().amax(dim=tuple(range(1, want.dim()))) / scale).tolist()
    errs["logits"] = [float((step_logits - logits).abs().max() / logits.abs().max())]
    worst = {k: max(v) for k, v in errs.items()}
    check(all(w <= SSD_TOL for w in worst.values()), f"ssd prefill vs decode: {worst}")
    check(int(step_logits.argmax()) == int(logits.argmax()), "ssd prefill vs decode: next token")
    print(
        f"ssm prefill vs decode ({arch.name}, {cfg.n_layers} layers, f32): a {SSD_PREFILL}-token "
        f"prefill ({t_prefill:.3f} s) against {SSD_PREFILL} decode steps replayed from a CUDA "
        f"graph ({t_decode:.3f} s, {1e3 * t_decode / SSD_PREFILL:.3f} ms a step): max err / max |value| over the layers "
        f"{json.dumps({k: float(f'{w:.3e}') for k, w in worst.items()})} (limit {SSD_TOL}), the "
        f"same next token; on {smi}"
    )


def moe_prefill_bytes(cfg, S: int) -> dict[str, float]:
    """The MoE's transient device bytes in one block of an S-token prefill
    (B = 1): the experts cast to the compute dtype (what ``_moe_chunk``
    holds per chunk), and per chunk the one-hot dispatch and combine, the
    expert inputs, the two hidden products and their product."""
    m = cfg.moe
    chunk = min(m.seq_chunk, S)
    cap = mlp_mod._capacity(m, chunk)
    b = 2  # bf16
    return {
        "experts_cast": 3 * m.n_experts * m.d_model * m.d_ff_expert * b,
        "dispatch_combine": 2 * chunk * m.n_experts * cap * b,
        "expert_in_out": 2 * m.n_experts * cap * m.d_model * b,
        "hidden": 3 * m.n_experts * cap * m.d_ff_expert * b,
        "chunks": S // chunk,
    }


def phase_hybrid(smi: str) -> dict:
    """jamba-v0.1-52b at full width, depth cut to one pattern group (1
    attention + 7 SSD layers, MoE 16 x top 2 on the even positions): int8
    serving of 8 requests (30 quantized products a step from the tree), a
    4096-token int8 prefill with one flash_attention launch."""
    arch = get_arch(HYBRID_ARCH)
    cfg = dataclasses.replace(arch.config, n_layers=len(tfm.layer_pattern(arch.config)))
    arch = dataclasses.replace(arch, config=cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = arch.init_params(torch.Generator(device=DEVICE).manual_seed(0))
    n_params = sum(t.numel() for _, t in tree_leaves(params))
    n_experts = sum(t.numel() for p, t in tree_leaves(params) if "/moe/w_" in p)
    qparams = quantize_tree(params, lm_policy(8))
    del params
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    moe = moe_prefill_bytes(cfg, LONG_PREFILL)
    transient = sum(v for k, v in moe.items() if k != "chunks")
    free = torch.cuda.mem_get_info()[0]
    print(
        f"hybrid model: {arch.name} at full width, one pattern group ({cfg.n_layers} of "
        f"{get_arch(HYBRID_ARCH).config.n_layers} layers), "
        f"{n_params} f32 parameters ({n_experts} in the experts, 4-D leaves kept float), "
        f"int8 block weights: {held / 2**30:.3f} GiB on the card "
        f"({time.perf_counter() - t0:.2f} s); "
        f"the MoE's transient bytes in one block of a {LONG_PREFILL}-token prefill "
        f"{json.dumps({k: (v if k == 'chunks' else round(v / 2**30, 4)) for k, v in moe.items()})} "
        f"GiB = {transient / 2**30:.3f} GiB per chunk beside {free / 2**30:.3f} GiB free: "
        f"{'fits' if transient < free else 'does not fit'}; on {smi}"
    )
    check(transient < free, "hybrid: the MoE's prefill transients do not fit beside the engine")
    served = phase_lm_decode(arch, qparams, 8, 8, 4, 30, check_plain=True,
                             max_prompt=SHORT_PROMPT, smi=smi)
    counts = collections.Counter(served)
    tokens = torch.from_numpy(np.random.default_rng(16).integers(0, cfg.vocab, (1, LONG_PREFILL)))
    counts.update(timed_prefill(arch, cfg, qparams, {"tokens": tokens.to(DEVICE)}, 1, 30,
                                "hybrid prefill", smi))
    print(f"hybrid: peak memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB "
          f"(max_memory_allocated); on {smi}")
    del qparams
    torch.cuda.empty_cache()
    return dict(counts)


def phase_vlm(smi: str) -> dict:
    """qwen2-vl-2b at full width (28 layers): a 4096-position int8 prefill
    of 256 patch embeddings (a 16 x 16 grid) and 3840 text tokens (28
    flash_attention, 28 x 7 quant_matmul launches); the same prefill at 2
    layers card == CPU; int8 serving of 8 requests."""
    arch = get_arch(VLM_ARCH)
    cfg = arch.config
    params = arch.init_params(torch.Generator(device=DEVICE).manual_seed(0))
    qparams = quantize_tree(params, lm_policy(8))
    n_vis = arch.n_vision_tokens
    gen = torch.Generator(device=DEVICE).manual_seed(2)
    batch = {
        "tokens": torch.from_numpy(
            np.random.default_rng(17).integers(0, cfg.vocab, (1, LONG_PREFILL - n_vis))).to(DEVICE),
        "vision_embeds": torch.randn(1, n_vis, cfg.d_model, device=DEVICE, generator=gen).to(
            torch.bfloat16
        ),
        "positions3": vlm_positions3(1, 16, 16, LONG_PREFILL),
    }
    counts = collections.Counter(timed_prefill(arch, cfg, qparams, batch, cfg.n_layers,
                                               QDOTS_PER_LAYER * cfg.n_layers, "vlm prefill", smi))
    counts.update(phase_lm_decode(arch, qparams, 8, 8, 4, QDOTS_PER_LAYER * cfg.n_layers,
                                  check_plain=True, max_prompt=SHORT_PROMPT, smi=smi))
    del params, qparams
    torch.cuda.empty_cache()
    # 2 layers at full width, card (kernels) against CPU (plain), as phase 8
    cfg2 = dataclasses.replace(cfg, n_layers=2)
    p_cpu = quantize_tree(arch.init_params(torch.Generator().manual_seed(1), cfg2), lm_policy(8))
    p_gpu = tree_map(
        lambda _, t: t.to(DEVICE) if isinstance(t, (torch.Tensor, QTensor)) else t, p_cpu
    )
    kernels.reset_launch_counts()
    lg, _ = tfm.prefill(cfg2, p_gpu, batch["tokens"], vision_embeds=batch["vision_embeds"],
                        pos3=batch["positions3"])
    torch.cuda.synchronize()
    check(kernels.launch_counts()["flash_attention"] == 2, "vlm 2-layer prefill: flash twice")
    cpu = {k: v.cpu() for k, v in batch.items()}
    lc, _ = tfm.prefill(cfg2, p_cpu, cpu["tokens"], vision_embeds=cpu["vision_embeds"],
                        pos3=cpu["positions3"])
    err, n = card_cpu_agree(lg, lc, "vlm prefill")
    print(
        f"vlm card vs CPU (full width, 2 layers, int8): prefill of {n_vis} patches + "
        f"{LONG_PREFILL - n_vis} text tokens {err:.3e} of max |logit| ({n}/1 decided, equal)"
    )
    return dict(counts)


# ---------------------------------------------------------------------------
# Phase 15: whisper-medium at full width
# ---------------------------------------------------------------------------

WHISPER_ARCH = "whisper-medium"
# 15a: the prefill shape at 4096 frames with its batch cut from 32 to 4;
# 15b: decode_32k's encoder context with its batch cut from 128 to 1 (at
# 128 the cross caches alone would be ~412 GB); 15c: train_4k, batch 256 -> 1
WHISPER_B, WHISPER_FRAMES, WHISPER_STEPS = 4, 4096, 32
LONG_FRAMES, LONG_STEPS = 32_768, 16
# a 32k launch's plain check: 4 query blocks of LONG_ROWS rows (the first,
# the last, two between); rows are independent, so each block's plain
# version against all of K and V is exact (the whole would take 69 GB)
LONG_ROWS = 256
# request 0 decoded alone (B = 1) against its row of the batched run
# (scripts/whisper_batch_invariance.py finds where they part): every kernel
# and every norm gives row 0 the same bits at B = 1 and 4, but
# decode_attend's f32 einsums are cuBLAS batched GEMMs whose reduction
# order depends on the batch (scores up to 2.1e-7 of max apart); where the
# bf16 output then rounds otherwise, that one-ulp step compounds through 24
# random layers: 4.5e-3 of max |logit| at step 1, 1.135e-2 at most over 32
# steps.  The limit is under twice that reading and under the batched row's
# smallest top-2 margin (5.3e-2), and every token must be the same.
ALONE_TOL = 0.02


def whisper_qdots(cfg) -> tuple[int, int]:
    """``quant_matmul`` launches of one prefill (the encoder's wq wk wv wo
    w_up w_down, every decoder layer's cross wk wv) and of one decode step
    (a decoder layer's self wq wk wv wo, cross wq wo, w_up w_down)."""
    return 6 * cfg.n_enc_layers + 2 * cfg.n_dec_layers, 8 * cfg.n_dec_layers


def greedy(decode, qparams, caches, B: int, steps: int, rows: list | None = None) -> torch.Tensor:
    """``steps`` greedy decode steps from token 0 (the self caches appended
    in place); returns the tokens [B, steps] on the host, and appends each
    step's logits of request 0 to ``rows``."""
    tok = torch.zeros(B, 1, dtype=torch.int32, device=DEVICE)
    cur = torch.zeros(B, dtype=torch.int32, device=DEVICE)
    out = []
    for _ in range(steps):
        logits, caches = decode(qparams, caches, {"tokens": tok, "cur_len": cur})
        if rows is not None:
            rows.append(logits[0, -1].clone())
        tok, cur = logits.argmax(-1).to(torch.int32), cur + 1
        out.append(tok)
    return torch.cat(out, dim=1).cpu()


def whisper_steps(arch, S: int, B: int):
    """The registry's prefill and decode steps at int8 (``QUANT_RULES``)."""
    cfg, policy = arch.config, lm_policy(8)
    prefill = build_prefill_step(arch, ShapeSpec("prefill", S, B, "prefill"), None, cfg, quant=policy)
    decode = build_decode_step(arch, ShapeSpec("decode", S, B, "decode"), None, cfg, quant=policy)
    return prefill.jitted, decode.jitted


def phase_whisper_serve(arch, qparams, smi: str) -> dict:
    """15a: 4 clips of 4096 frames through ``build_prefill_step`` (the
    encoder's 24 non-causal ``flash_attention`` launches, the cross K/V of
    24 decoder layers) and 32 greedy steps of ``build_decode_step``, every
    launch recorded and held to its plain version (``quant_matmul`` at
    QM_TOL, ``flash_attention`` at FA_TOL with planted faults, among them a
    causal mask applied); then the same traffic timed warm with nothing
    recorded, with its busy shares; then request 0 alone (B = 1) decodes the
    same tokens."""
    cfg = arch.config
    prefill, decode = whisper_steps(arch, WHISPER_FRAMES, WHISPER_B)
    shape = ShapeSpec("prefill", WHISPER_FRAMES, WHISPER_B, "prefill")
    batch = arch.input_concrete(torch.Generator(device=DEVICE).manual_seed(3), shape, cfg)
    per_prefill, per_step = whisper_qdots(cfg)
    rows: list = []
    with recorded_quant_matmul() as seen_qm, recorded_flash_attention() as seen_fa:
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        caches = prefill(qparams, batch)
        tokens = greedy(decode, qparams, caches, WHISPER_B, WHISPER_STEPS, rows)
        checked_s = time.perf_counter() - t0
        counts = read_counts()
    qdots = per_prefill + WHISPER_STEPS * per_step
    check(counts["flash_attention"] == cfg.n_enc_layers == len(seen_fa), "whisper: flash launches")
    check(counts["quant_matmul"] == qdots == len(seen_qm), f"whisper: {qdots} quant_matmul launches")
    for q, _, _, kw, _ in seen_fa:
        check(tuple(q.shape) == (WHISPER_B, cfg.n_heads, WHISPER_FRAMES, cfg.d_head)
              and not kw["causal"] and kw["window"] is None and kw["softcap"] is None,
              f"whisper: flash_attention launch {list(q.shape)} {kw}")
    for part, c in caches.items():
        for name, t in c.items():
            check(bool(torch.isfinite(t.float()).all()), f"whisper: {part} cache {name} finite")
    check(caches["self"]["len"].eq(WHISPER_STEPS).all().item(), "whisper: self cache lengths")
    check(caches["cross"]["len"].eq(WHISPER_FRAMES).all().item(), "whisper: cross cache lengths")
    check(0 <= int(tokens.min()) and int(tokens.max()) < cfg.vocab, "whisper: tokens in vocab")
    del caches
    qm_err = check_recorded_qm(seen_qm, "whisper int8 serving")
    fa_err, fa_used = check_recorded_fa(seen_fa, "whisper prefill")
    del seen_qm, seen_fa
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    caches = prefill(qparams, batch)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    again = greedy(decode, qparams, caches, WHISPER_B, WHISPER_STEPS)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0 - prefill_s
    check(torch.equal(again, tokens), "whisper: the timed pass decoded other tokens")
    last = {"tokens": again[:, -1:].to(device=DEVICE, dtype=torch.int32),
            "cur_len": torch.full((WHISPER_B,), WHISPER_STEPS, dtype=torch.int32, device=DEVICE)}
    split_decode = device_split(lambda: decode(qparams, caches, last), n=4)
    del caches
    split_prefill = device_split(lambda: prefill(qparams, batch), n=1, top=5, width=60)
    # request 0 alone: the same tokens, its logits within ALONE_TOL
    rows1: list = []
    caches1 = prefill(qparams, {"audio_frames": batch["audio_frames"][:1]})
    k4, k1 = prefill(qparams, batch)["cross"]["k"][:, 0].float(), caches1["cross"]["k"][:, 0].float()
    cross_diff = float((k1 - k4).abs().max() / k4.abs().max())
    cross_same = float((k1 == k4).float().mean())
    del k4, k1
    alone = greedy(decode, qparams, caches1, 1, WHISPER_STEPS, rows1)
    check(torch.equal(alone[0], tokens[0]),
          f"whisper: request 0 alone decoded {alone[0].tolist()}, batched {tokens[0].tolist()}")
    err, margin = 0.0, math.inf
    for g, w in zip(rows1, rows):
        scale = float(w.abs().max())
        err = max(err, float((g - w).abs().max()) / scale)
        top2 = w.topk(2).values
        margin = min(margin, float(top2[0] - top2[1]) / scale)
    check(err <= ALONE_TOL, f"whisper: request 0 alone, logits {err:.3e} of max |logit| apart")
    print(
        f"whisper serve (15a): {arch.name} full width int8, {WHISPER_B} clips x {WHISPER_FRAMES} "
        f"frames, {WHISPER_STEPS} greedy steps from token 0: prefill {prefill_s:.3f} s warm with "
        f"nothing recorded, decode {1e3 * decode_s / WHISPER_STEPS:.3f} ms a step (the checked "
        f"pass {checked_s:.3f} s in all); {counts['quant_matmul']} quant_matmul launches = "
        f"{per_prefill} + {WHISPER_STEPS} x {per_step}, each within QM_TOL of plain (max_abs_err "
        f"{qm_err:.3e}); {counts['flash_attention']} non-causal flash_attention launches "
        f"[{WHISPER_B},{cfg.n_heads},{WHISPER_FRAMES},{cfg.d_head}] each within FA_TOL of plain "
        f"(max_abs_err {fa_err:.3e}; tolerance used by the kernel, then by each planted fault (> 1 "
        f"fails): {json.dumps({k: {f: round(u, 4) for f, u in d.items()} for k, d in fa_used.items()})}); "
        f"request 0 alone (B = 1): the same {WHISPER_STEPS} tokens, logits within {err:.3e} of max "
        f"|logit| (limit {ALONE_TOL}; the batched row's smallest top-2 margin {margin:.3e}), its "
        f"cross K (every layer) {cross_diff:.3e} of max |K| "
        f"from the batched run's, {cross_same:.4f} of the values bit-equal; req0 "
        f"{tokens[0, :8].tolist()}...; on {smi}"
    )
    print(f"whisper serve (15a) prefill split: {split_prefill}; on {smi}")
    print(f"whisper serve (15a) decode step split: {split_decode}; on {smi}")
    return counts


def fa_rows_ref(q, k, v, r0: int, n: int, *, causal: bool, scale: float) -> torch.Tensor:
    """``flash_attention_ref``'s query rows [r0, r0 + n), each at its true
    position (the causal fault's mask needs it), against all of K and V."""
    s = torch.einsum("bhqd,bhkd->bhqk", q[:, :, r0 : r0 + n].float(), k.float()) * scale
    if causal:
        qp = torch.arange(r0, r0 + n, device=q.device)[:, None]
        s = torch.where(qp >= torch.arange(k.shape[2], device=q.device)[None], s, NEG_INF)
    return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, dim=-1), v.float()).to(q.dtype)


@contextlib.contextmanager
def checked_launches(what: str, sampled: bool = True):
    """Each ``quant_matmul`` launch made through ``qdot`` held to its plain
    version at QM_TOL as it is made, and each ``flash_attention`` launch at
    FA_TOL: with ``sampled`` (a 32k prefill: non-causal, MHA) on LONG_ROWS-row
    query blocks, the first launch also against planted faults; else whole
    (:func:`check_recorded_fa`, the first launch of each shape against its
    planted faults).  Nothing is kept (a 32k prefill's recorded operands
    would not fit beside it).  ``stats`` counts the launches checked, which
    the caller holds equal to the kernels' own counts: launch counts reset
    inside the block count the checking wrappers."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.quant_matmul import quant_matmul as qm_module

    stats = {"quant_matmul": 0, "qm_err": 0.0, "flash_attention": 0, "fa_err": 0.0, "fa_used": {}}
    real_qm, real_fa = qm_module.quant_matmul, fa_ops.flash_attention

    def qm(x, q, scale, *, bits, **kw):
        out = real_qm(x, q, scale, bits=bits, **kw)
        want = quant_matmul_ref(x, q, scale, bits, out.dtype)
        shape = f"[{x.shape[0]},{x.shape[1]}]x[{q.shape[0]},{scale.shape[0]}] -> {out.dtype}"
        stats["qm_err"] = max(stats["qm_err"], close(out, want, QM_TOL, f"{what}: quant_matmul {shape}"))
        stats["quant_matmul"] += 1
        return out

    def fa_rows(q, k, v, kw, out):
        check(not kw["causal"] and q.shape[1] == k.shape[1], f"{what}: flash_attention {kw}")
        S, scale = q.shape[2], kw.get("scale") or q.shape[-1] ** -0.5
        first = stats["flash_attention"] == 0
        used = stats["fa_used"].setdefault(f"{list(q.shape)} sampled rows", {}) if first else None
        for r0 in sorted({0, S // 3 // LONG_ROWS * LONG_ROWS, 2 * S // 3 // LONG_ROWS * LONG_ROWS,
                          S - LONG_ROWS}):
            got = out[:, :, r0 : r0 + LONG_ROWS]
            want = flash_attention_ref(q[:, :, r0 : r0 + LONG_ROWS], k, v, causal=False, scale=scale)
            rows = f"{list(q.shape)} rows [{r0}, {r0 + LONG_ROWS})"
            stats["fa_err"] = max(stats["fa_err"], close(got, want, FA_TOL, f"{what}: {rows}"))
            if first:  # each fault over the sampled rows, as over a whole output
                faults = {
                    "scale x2": fa_rows_ref(q, k, v, r0, LONG_ROWS, causal=False, scale=2 * scale),
                    "causal mask applied": fa_rows_ref(q, k, v, r0, LONG_ROWS, causal=True, scale=scale),
                    "zero output": torch.zeros_like(want),
                }
                for name, x in [("kernel", got), *faults.items()]:
                    used[name] = max(used.get(name, 0.0), tol_used(x, want, FA_TOL))
        for fault, u in (used or {}).items():
            check(fault == "kernel" or u > 1, f"{what}: planted fault {fault} passes the tolerance")

    def fa(q, k, v, **kw):
        out = real_fa(q, k, v, **kw)
        if sampled:
            fa_rows(q, k, v, kw, out)
        else:
            err, _ = check_recorded_fa([(q, k, v, kw, out)], what, stats["fa_used"])
            stats["fa_err"] = max(stats["fa_err"], err)
        stats["flash_attention"] += 1
        return out

    with mock.patch.object(qm_module, "quant_matmul", qm), mock.patch.object(fa_ops, "flash_attention", fa):
        yield stats


def phase_whisper_long(arch, qparams, smi: str) -> dict:
    """15b: one clip of 32768 frames (decode_32k's encoder context): a
    prefill whose 24 non-causal ``flash_attention`` launches at
    [1,16,32768,64] are checked on sampled query blocks, then 16 decode
    steps against the 3.2 GB cross cache (``decode_attend`` is plain, as in
    JAX), every ``quant_matmul`` launch checked as it is made; then both
    timed warm with nothing checked."""
    cfg = arch.config
    prefill, decode = whisper_steps(arch, LONG_FRAMES, 1)
    shape = ShapeSpec("prefill", LONG_FRAMES, 1, "prefill")
    batch = arch.input_concrete(torch.Generator(device=DEVICE).manual_seed(4), shape, cfg)
    per_prefill, per_step = whisper_qdots(cfg)
    with checked_launches("whisper 32k") as stats:
        reset_counts()  # inside: the wrappers counted are the checking ones
        caches = prefill(qparams, batch)
        tokens = greedy(decode, qparams, caches, 1, LONG_STEPS)
        counts = read_counts()
    check(counts["flash_attention"] == cfg.n_enc_layers == stats["flash_attention"],
          "whisper 32k: flash launches")
    check(counts["quant_matmul"] == per_prefill + LONG_STEPS * per_step == stats["quant_matmul"],
          "whisper 32k: quant_matmul launches")
    cross = sum(t.numel() * t.element_size() for t in caches["cross"].values())
    check(caches["cross"]["k"].shape == (cfg.n_dec_layers, 1, LONG_FRAMES, cfg.n_heads, cfg.d_head),
          "whisper 32k: cross cache shape")
    check(bool(torch.isfinite(caches["cross"]["k"].float()).all()), "whisper 32k: cross cache finite")
    del caches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    caches = prefill(qparams, batch)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    again = greedy(decode, qparams, caches, 1, LONG_STEPS)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0 - prefill_s
    check(torch.equal(again, tokens), "whisper 32k: the timed pass decoded other tokens")
    del caches
    B, H, S, D = 1, cfg.n_heads, LONG_FRAMES, cfg.d_head
    attn_flops = cfg.n_enc_layers * 4 * B * H * S * S * D
    print(
        f"whisper long (15b): 1 clip x {LONG_FRAMES} frames: prefill {prefill_s:.3f} s warm with "
        f"nothing checked ({attn_flops / 1e12:.1f} TFLOP of non-causal attention = "
        f"{attn_flops / prefill_s / 1e12:.1f} TFLOP/s over the whole prefill); {LONG_STEPS} decode "
        f"steps against the {cross / 1e9:.3f} GB cross cache {1e3 * decode_s / LONG_STEPS:.3f} ms a "
        f"step; {counts['flash_attention']} flash_attention launches [1,{H},{S},{D}] each within "
        f"FA_TOL of plain on 4 blocks of {LONG_ROWS} query rows (max_abs_err {stats['fa_err']:.3e}; "
        f"tolerance used by the kernel, then by each planted fault (> 1 fails): "
        f"{json.dumps({k: {f: round(u, 4) for f, u in d.items()} for k, d in stats['fa_used'].items()})}); "
        f"{counts['quant_matmul']} quant_matmul launches each within QM_TOL of plain (max_abs_err "
        f"{stats['qm_err']:.3e}); tokens {tokens[0, :8].tolist()}...; on {smi}"
    )
    return counts


def whisper_train_flops(cfg, S: int, T: int) -> float:
    """The products one whisper train step executes at S frames and T
    decoder tokens, counted from the shapes (backward twice the forward):
    the encoder's projections and attention at S; the decoder's
    projections, self-attention at T, cross K/V at S and cross-attention
    T x S; the logits.  ``structural.model_flops`` (6 N D, D the frames)
    counts the decoder at S and leaves attention out."""
    d, f = cfg.d_model, cfg.d_ff
    enc = S * 2 * (4 * d * d + 2 * d * f) + 4 * S * S * d
    dec = T * 2 * (6 * d * d + 2 * d * f) + S * 2 * 2 * d * d + 4 * T * T * d + 4 * T * S * d
    return 3 * (cfg.n_enc_layers * enc + cfg.n_dec_layers * dec + 2 * T * d * cfg.vocab)


def phase_whisper_train(arch, params, smi: str) -> dict:
    """15c: ``build_train_step`` at train_4k with its batch cut from 256 to 1
    (4096 frames, 448 decoder tokens), AdamW on the f32 parameters, the
    config's bf16 compute; one warm-up step, then 3 timed, on one batch: the
    loss falls; ms a step, peak memory, the model-FLOPs share of the bf16
    peak from ``structural.model_flops`` (JAX's 6 N D estimate, D the
    frames); no kernel launched (JAX trains through none)."""
    cfg = arch.config
    shape = ShapeSpec("train", WHISPER_FRAMES, 1, "train")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    opt = adamw(3e-4)
    state = opt.init([t for _, t in tree_leaves(params)])
    step = build_train_step(arch, shape, None, cfg, optimizer=opt).jitted
    batch = arch.input_concrete(torch.Generator(device=DEVICE).manual_seed(5), shape, cfg)
    want = {k: s for k, (s, _) in arch.input_template(shape, cfg).items()}
    check({k: tuple(v.shape) for k, v in batch.items()} == want, "whisper train: batch shapes")
    reset_counts()
    losses, secs = [], []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, metrics = step(params, state, batch)
        losses.append(float(metrics["loss"]))
        secs.append(time.perf_counter() - t0)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    check(all(math.isfinite(x) for x in losses), f"whisper train: a loss is not finite: {losses}")
    check(losses[-1] < losses[0], f"whisper train: the loss did not fall: {losses}")
    check(sum(counts.values()) == 0, f"whisper train: the step launched a kernel: {counts}")
    step_s = statistics.mean(secs[1:])
    flops = structural.model_flops(arch, shape)
    executed = whisper_train_flops(cfg, WHISPER_FRAMES, want["tokens"][1])
    split = device_split(lambda: step(params, state, batch), n=1, top=6, width=80)
    print(
        f"whisper train (15c): {structural.param_count(arch)} f32 parameters, {WHISPER_FRAMES} "
        f"frames + {want['tokens'][1]} decoder tokens x batch 1, AdamW; losses "
        f"{[round(x, 6) for x in losses]}; steps (s) {[round(x, 4) for x in secs]}; timed mean "
        f"{1e3 * step_s:.3f} ms a step; model FLOPs {flops:.4e} a step (structural.model_flops, "
        f"6 N D over the frames) = {flops / step_s / 1e12:.2f} TFLOP/s, "
        f"{flops / step_s / BF16_TC_FLOPS:.4f} of the dense bf16 peak; FLOPs executed "
        f"{executed:.4e} (counted from the shapes, attention included, the decoder at its "
        f"tokens) = {executed / step_s / BF16_TC_FLOPS:.4f} of that peak; peak memory "
        f"{peak / 2**30:.3f} GiB (max_memory_allocated); on {smi}"
    )
    print(f"whisper train (15c) step split: {split}; on {smi}")
    del state, step, metrics
    return counts


def phase_whisper(smi: str, launches: dict) -> None:
    """Phase 15: whisper-medium at full width (random weights from a seeded
    generator, int8 block weights for serving): 15a-c, each one's launches
    added to ``launches``, then 15d."""
    t0 = time.perf_counter()
    whisper = get_arch(WHISPER_ARCH)
    wh_params = whisper.init_params(torch.Generator(device=DEVICE).manual_seed(0))
    wh_int8 = quantize_tree(wh_params, lm_policy(8))
    torch.cuda.synchronize()
    int8_bytes = sum(
        sum(x.numel() * x.element_size() for x in ((t.q, t.scale) if isinstance(t, QTensor) else (t,)))
        for _, t in tree_leaves(wh_int8)
    )
    wcfg = whisper.config
    print(
        f"whisper model: {whisper.name} at full width ({wcfg.n_enc_layers} + {wcfg.n_dec_layers} "
        f"layers, d_model {wcfg.d_model}, {wcfg.n_heads} heads, d_ff {wcfg.d_ff}, vocab "
        f"{wcfg.vocab}), {structural.param_count(whisper)} f32 parameters "
        f"({structural.param_bytes(whisper) / 1e9:.3f} GB) from torch.Generator('cuda')."
        f"manual_seed(0); int8 block weights + f32 embed / positions / norms "
        f"{int8_bytes / 1e9:.3f} GB ({time.perf_counter() - t0:.2f} s); on {smi}"
    )
    for name, phase in [
        ("whisper_serve", lambda: phase_whisper_serve(whisper, wh_int8, smi)),
        ("whisper_long", lambda: phase_whisper_long(whisper, wh_int8, smi)),
        ("whisper_train", lambda: phase_whisper_train(whisper, wh_params, smi)),
    ]:
        reset_counts()
        t1 = time.perf_counter()
        counts = phase()
        print(f"launches[{name}]: {counts} ({time.perf_counter() - t1:.3f} s)")
        for k, v in counts.items():
            launches[k] += v
    del wh_params, wh_int8
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    phase_lm_train_card_vs_cpu((WHISPER_ARCH,))
    print(f"15d card vs CPU took {time.perf_counter() - t1:.3f} s")
    print(f"phase 15 took {time.perf_counter() - t0:.3f} s; on {smi}")


# ---------------------------------------------------------------------------
# Phase 16: the dense LM over a ("data", "model") mesh
# ---------------------------------------------------------------------------

MESH_SHAPE = (2, 2)
MESH_STEPS = 3  # train steps each side; the last two timed
MESH_PREFILL_B, MESH_PREFILL_S = 2, 4096  # one sequence a data shard
MESH_DECODE = 16
# sharded against one-device bf16 logits (prefill and decode), of max |logit|:
# the two add the row-parallel partials and the per-shard heads in other f32
# orders, and bf16 activations turn a last-bit difference into an ulp
MESH_LOGIT_TOL = 1e-2
MESH_LIMITS = dict(loss=1e-5, grad=1e-4, param=1e-3)  # tests/test_torch_lm_mesh.py's, f32
LOOP16_DIR = ROOT / "build" / "phase16"  # the mesh TrainLoop's checkpoints (git-ignored)
LOOP16_STEPS, LOOP16_CKPT, LOOP16_FAIL, LOOP16_MORE = 20, 10, 15, 5
RING_SHAPE = (2048, 8192, 2048)  # x [M, K] @ w [K, N], f32, K split over four shards


def card_mesh2(shape, devices=None):
    """A (data, model) mesh over ``devices`` (default: card 0 repeated)."""
    n = shape[0] * shape[1]
    return make_named_mesh(shape, devices or [DEVICE] * n)


def leaf_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / max |want|, on ``got``'s device."""
    want = want.to(got.device)
    return float((got.float() - want.float()).abs().max() / want.float().abs().max().clamp_min(1e-30))


def mesh_steps(step, params, state, batches) -> tuple[list, list, list]:
    """Run ``step`` over ``batches``: losses, grad norms and walls (s)."""
    losses, norms, secs = [], [], []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = step(params, state, b)
        losses.append(float(m["loss"]))  # the loop's sync
        secs.append(time.perf_counter() - t0)
        norms.append(float(m["grad_norm"]))
    return losses, norms, secs


def phase_mesh_train(mesh, smi: str) -> dict:
    """16a: full-width stablelm-1.6b train steps (seq 256 x batch 8, the
    loop's AdamW) on ``mesh`` against one device: at f32 compute
    (:func:`mesh_train_f32`, every parameter element held), then timed at
    the config's bf16 (:func:`mesh_train_bf16`); then a ``bf16_gather``
    step's loss against one device's."""
    arch = get_arch(LM_ARCH)
    cfg = arch.config
    shape = ShapeSpec("train", TRAIN_SEQ, TRAIN_BATCH, "train")
    batches = train_batches(arch, cfg, MESH_STEPS)
    f32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
    reset_counts()
    print(f"mesh train (16a) {LM_ARCH} full width on {mesh}, f32 compute: "
          f"{mesh_train_f32(arch, f32, mesh, batches, '16a', hold_all=True)}; on {smi}")
    one, text = mesh_train_bf16(arch, cfg, mesh, batches, "16a", smi)
    print(f"mesh train (16a) {LM_ARCH}: {text}")
    opt = loop_optimizer()
    params = shard_tree(arch.init_params(torch.Generator(device=DEVICE).manual_seed(0), cfg),
                        arch.param_pspecs(mesh, cfg), mesh)
    state = init_opt_state(opt, params)
    step = build_train_step(arch, shape, mesh, cfg, optimizer=opt, bf16_gather=True).jitted
    g16 = mesh_steps(step, params, state, batches[:2])
    del params, state, step
    torch.cuda.empty_cache()
    g16_err = abs(g16[0][0] - one[0]) / one[0]
    check(g16_err <= 0.05, f"16a bf16_gather: loss {g16[0][0]} vs one device {one[0]}")
    counts = read_counts()
    check(sum(counts.values()) == 0, f"16a: a train step launched a kernel: {counts}")
    print(f"mesh train (16a) bf16_gather step loss {g16[0][0]:.6f} ({g16_err:.3e} from one device's "
          f"bf16, limit 0.05), its second step {1e3 * g16[2][1]:.3f} ms; on {smi}")
    return counts


def logits_agree(got, want, what: str, tol: float = MESH_LOGIT_TOL) -> tuple[float, int, int]:
    """``got`` within ``tol`` of max |want|, and its greedy token equal
    wherever want's top-2 margin is wider than twice that.  Returns (error /
    max, decided rows, rows whose tokens are equal)."""
    got, want = got.float(), want.float().to(got.device)
    scale = float(want.abs().max())
    err = float((got - want).abs().max()) / scale
    check(err <= tol, f"{what}: logits {err:.3e} of max apart")
    top2 = want.topk(2, dim=-1).values
    decided = (top2[..., 0] - top2[..., 1]) > 2 * tol * scale
    same = got.argmax(-1) == want.argmax(-1)
    check(bool(same[decided].all()), f"{what}: a decided greedy token differs")
    return err, int(decided.sum()), int(same.sum())


def phase_mesh_serve(mesh, smi: str) -> dict:
    """16b-c: a 4096-token prefill of 2 sequences with serve_optimized int8
    weights, then 16 greedy decode steps over the TP- and batch-sharded
    caches fed the one-device run's tokens (``mesh_serve``: one device
    first, then the same tree on ``mesh``, every launch held to plain,
    logits and caches against one device)."""
    arch = get_arch(LM_ARCH)
    cfg = arch.config
    L, n = cfg.n_layers, mesh.size
    tokens = torch.from_numpy(np.random.default_rng(16).integers(0, cfg.vocab, (MESH_PREFILL_B, MESH_PREFILL_S)))
    qparams = quantize_tree(init_bf16(arch, cfg), lm_policy(8))
    return mesh_serve(arch, [(cfg, MESH_LOGIT_TOL, CACHE_TOL)], mesh, qparams, {"tokens": tokens.to(DEVICE)},
                      L * n, QDOTS_PER_LAYER * L * n, MESH_DECODE, "16b-c", smi)


def phase_mesh_loop(smi: str) -> dict:
    """16d: ``TrainLoop`` at the ~100 M config of phase 13 (f32 compute) on
    a (2, 2) mesh of card 0: a failure injected at step 15, restored from the
    checkpoint of step 10, to step 20; its checkpoint then resumes on (4, 1)
    and, beside it, on (2, 2): the two runs' losses over the next 5 steps
    within 1e-5 relative."""
    arch = get_arch(LM_ARCH)
    cfg = dataclasses.replace(arch.reduced_config, **LM100M, compute_dtype=torch.float32)
    shutil.rmtree(LOOP16_DIR, ignore_errors=True)

    def make(shape, run_dir, **kw) -> TrainLoop:
        loop = TrainLoop(LM_ARCH, TRAIN_SEQ, TRAIN_BATCH, card_mesh2(shape), str(LOOP16_DIR / run_dir),
                         ckpt_every=LOOP16_CKPT, log_every=1, device=DEVICE, **kw)
        loop.arch = dataclasses.replace(arch, reduced_config=cfg)
        loop.cfg = cfg
        return loop

    losses = lambda path: {e["step"]: e["loss"] for e in map(json.loads, open(path)) if e["event"] == "step"}
    reset_counts()
    t0 = time.perf_counter()
    out = make(MESH_SHAPE, "a", fail_at_step=LOOP16_FAIL).run(LOOP16_STEPS)
    wall = time.perf_counter() - t0
    shutil.copytree(LOOP16_DIR / "a" / "ckpt", LOOP16_DIR / "b" / "ckpt")
    events = [json.loads(x) for x in open(out["metrics_path"])]
    kinds = [(e["event"], e["step"]) for e in events if e["event"] != "straggler"]
    restored = LOOP16_FAIL // LOOP16_CKPT * LOOP16_CKPT
    check(out["failures"] == 1 and out["final_step"] == LOOP16_STEPS, f"16d: TrainLoop {out}")
    check(("failure", LOOP16_FAIL) in kinds and ("restored", restored) in kinds, f"16d: events {kinds}")
    end = LOOP16_STEPS + LOOP16_MORE
    t0 = time.perf_counter()
    on22 = make(MESH_SHAPE, "a").run(end)
    on41 = make((4, 1), "b").run(end)
    more_wall = time.perf_counter() - t0
    a, b = losses(LOOP16_DIR / "a" / "metrics.jsonl"), losses(LOOP16_DIR / "b" / "metrics.jsonl")
    errs = [abs(a[s] - b[s]) / abs(a[s]) for s in range(LOOP16_STEPS, end)]
    check(on22["final_step"] == on41["final_step"] == end, "16d: the resumed runs' final steps")
    check(("resume", LOOP16_STEPS) in [(e["event"], e["step"]) for e in map(json.loads, open(on41["metrics_path"]))],
          "16d: the (4, 1) run did not resume from the (2, 2) checkpoint")
    check(max(errs) <= MESH_LIMITS["loss"], f"16d: (4, 1) vs (2, 2) losses {errs}")
    check(out["final_loss"] < out["first_loss"], f"16d: loss {out['first_loss']} -> {out['final_loss']}")
    counts = read_counts()
    print(
        f"mesh loop (16d): TrainLoop at ~100 M (f32 compute) on a (2, 2) mesh of card 0, seq "
        f"{TRAIN_SEQ} x batch {TRAIN_BATCH}: {LOOP16_STEPS} steps with a failure at {LOOP16_FAIL} "
        f"restored at {restored} in {wall:.3f} s (loss {out['first_loss']:.6f} -> "
        f"{out['final_loss']:.6f}); its step-{LOOP16_STEPS} checkpoint resumed on (4, 1) and on "
        f"(2, 2) for {LOOP16_MORE} steps each ({more_wall:.3f} s): losses "
        f"{[round(b[s], 6) for s in range(LOOP16_STEPS, end)]}, at most {max(errs):.3e} relative "
        f"from (2, 2)'s (limit {MESH_LIMITS['loss']}); on {smi}"
    )
    shutil.rmtree(LOOP16_DIR, ignore_errors=True)
    return counts


def phase_mesh_ring(smi: str) -> None:
    """16e: ``ring_allgather_matmul`` over the model axis of a (1, 4) mesh
    of card 0 (W's K split into four shards passed round the ring on a side
    stream) against the gathered f32 ``x @ w`` at rtol 1e-5 of max |y|."""
    M, K, N = RING_SHAPE
    gen = torch.Generator(device=DEVICE).manual_seed(16)
    x = torch.randn(M, K, device=DEVICE, generator=gen)
    w = torch.randn(K, N, device=DEVICE, generator=gen)
    ring = ring_allgather_matmul_shardmap(card_mesh2((1, 4)))
    y, want = ring(x, w), x @ w
    torch.cuda.synchronize()
    err = float((y - want).abs().max() / want.abs().max())
    check(err <= 1e-5, f"16e: ring all-gather matmul {err:.3e} of max from x @ w")
    ring_ms, plain_ms = stream_ms(lambda: ring(x, w), reps=5, inner=2), stream_ms(lambda: x @ w, reps=5, inner=2)
    print(
        f"mesh ring (16e): ring_allgather_matmul [{M},{K}]x[{K},{N}] f32 over 4 shards of card 0 "
        f"{err:.3e} of max from x @ w (limit 1e-5); {ring_ms:.3f} ms (the placement of x and W "
        f"included) vs {plain_ms:.3f} ms for x @ w; on {smi}"
    )


def phase_mesh(smi: str, launches: dict) -> None:
    """Phase 16: the dense LM over a (2, 2) mesh of four shards of card 0
    (16a-e), then 16a-c on distinct cards where the machine has them."""
    t0 = time.perf_counter()
    mesh = card_mesh2(MESH_SHAPE)
    for name, phase in [
        ("mesh_train", lambda: phase_mesh_train(mesh, smi)),
        ("mesh_serve", lambda: phase_mesh_serve(mesh, smi)),
        ("mesh_loop", lambda: phase_mesh_loop(smi)),
    ]:
        t1 = time.perf_counter()
        counts = phase()
        print(f"launches[{name}]: {counts} ({time.perf_counter() - t1:.3f} s)")
        for k, v in counts.items():
            launches[k] += v
    phase_mesh_ring(smi)
    n = torch.cuda.device_count()
    if n < 2:
        print(f"mesh on distinct cards: not run (this machine has {n} card); 16a-c ran on four "
              f"shards of card 0 only")
    for shape in [(1, 2)] + ([(2, 2)] if n >= 4 else []):
        if n < 2:
            break
        cards = card_mesh2(shape, [f"cuda:{i}" for i in range(shape[0] * shape[1])])
        for name, phase in [("cards_train", lambda: phase_mesh_train(cards, smi)),
                            ("cards_serve", lambda: phase_mesh_serve(cards, smi))]:
            counts = phase()
            print(f"launches[{name} {shape}]: {counts}")
            for k, v in counts.items():
                launches[k] += v
    print(f"phase 16 took {time.perf_counter() - t0:.3f} s; on {smi}")


# ---------------------------------------------------------------------------
# Phase 17: the MoE, SSM, hybrid and VLM LMs over a ("data", "model") mesh
# ---------------------------------------------------------------------------

MOE_ARCH, MOE_SERVE_ARCH = "granite-moe-1b-a400m", "qwen2-moe-a2.7b"
MESH17_CUT = 2  # 17a's "fsdp" and "megatron" layouts: 2 of granite's 24 layers
MESH17_SSM_PROMPT = 512  # 17d: two SSD chunks of 256 before the decode steps
MESH17_TIMED_DECODE = 4  # decode steps timed again unrecorded, each side
# AdamW's update g / (sqrt(nu_hat) + eps) turns gradients near eps into
# updates of either sign (ROADMAP Queue 3): the parameters are held where
# sqrt(nu_hat) > 100 eps, or where no gradient ever came (weight decay alone),
# as tests/test_torch_lm_families.py holds them
ADAM_EPS, ADAM_B2 = 1e-8, 0.999
# 17c and 17d serve their int8 / bf16 weights at f32 compute and at the
# config's bf16.  At f32 the limits are tests/test_torch_lm_families.py's f32
# logits, and the caches (an SSD state sums 4096 tokens) at half SSD_TOL.
# At bf16 the random jamba group and mamba2's 48 layers amplify rounding:
# one device's own bf16 logits lie 25 % / 5.0 % of max from its f32 ones
# (H100 80GB HBM3, 700 W, scripts/mesh_bf16_drift.py, which also shows two
# equivalent orders of the SSD's sums on one device as far apart), so the
# bf16 mesh is held to one device's bf16 within max(5 %, twice that
# distance), as tests/test_torch_lm_mesh_families_serve.py holds it
MESH17_F32_LOGIT_TOL, MESH17_F32_CACHE_TOL = 1e-4, 1e-3
MESH17_TWIN_FLOOR = 0.05


def init_bf16(arch, cfg, seed: int = 0):
    """``init_params`` from ``torch.Generator('cuda').manual_seed(seed)``,
    each leaf cast to bf16 as it is drawn (qwen2-moe's whole f32 tree, 57 GB,
    would not fit beside its cast)."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    template = arch.template(cfg)
    leaves = [materialize(gen, {"w": spec})["w"].to(torch.bfloat16) for _, spec in tree_leaves(template)]
    return tree_unflatten(template, leaves)


def train_batches(arch, cfg, n: int, seed: int = 0) -> list[dict]:
    """``n`` SyntheticTokens batches at seq 256 x batch 8 on the card; the
    VLM's as input_template splits them (128 patch embeddings on an 8 x 16
    grid, then 128 text tokens)."""
    data = SyntheticTokens(vocab=cfg.vocab, seq_len=TRAIN_SEQ, batch=TRAIN_BATCH, seed=seed)
    batches = [{k: torch.from_numpy(v).to(DEVICE) for k, v in next(data).items()} for _ in range(n)]
    if arch.family != "vlm":
        return batches
    n_vis = min(arch.n_vision_tokens, TRAIN_SEQ // 2)
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    pos3 = vlm_positions3(TRAIN_BATCH, 8, n_vis // 8, TRAIN_SEQ)
    return [
        {"tokens": b["tokens"][:, n_vis:], "targets": b["targets"][:, n_vis:],
         "vision_embeds": torch.randn(TRAIN_BATCH, n_vis, cfg.d_model, device=DEVICE,
                                      generator=gen).to(torch.bfloat16),
         "positions3": pos3}
        for b in batches
    ]


def routing(fn) -> dict:
    """``fn``'s MoE routing (a forward without gradients): capacity drops,
    assignments and the smallest top-k margin."""
    with record_routing() as rec, torch.no_grad():
        fn()
    torch.cuda.synchronize()
    return rec


def mesh_train_f32(arch, cfg, mesh, batches, what: str, hold_all: bool = False, shape=None) -> str:
    """``cfg`` (f32 compute) one device then ``mesh``, the loop's AdamW over
    ``batches``: gradients at the initial parameters within 1e-4 of each
    leaf's max |g|, each step's loss and grad norm 1e-5 relative, the
    parameters after the steps 1e-3 of max |w| where AdamW's update is
    conditioned (every element with ``hold_all``).  An MoE's mesh replays
    the one-device routes (its forward and remat's recompute alike), and
    each token its own top k would route apart must be within the runs'
    rounding (flip ratio <= 1).  ``shape``: the batches' (default seq
    TRAIN_SEQ x batch TRAIN_BATCH).  Returns the summary."""
    shape = shape or ShapeSpec("train", TRAIN_SEQ, TRAIN_BATCH, "train")
    moe = getattr(cfg, "moe", None)  # Whisper's config has none
    init = lambda: arch.init_params(torch.Generator(device=DEVICE).manual_seed(0), cfg)
    loss_fn = arch.loss_fn(cfg)
    opt = loop_optimizer()
    params = init()
    stats = routing(lambda: loss_fn(params, batches[0])) if moe else None
    with record_routing(keep=True) as kept:
        leaves = [t.detach().requires_grad_(True) for _, t in tree_leaves(params)]
        loss, _ = loss_fn(tree_unflatten(params, leaves), batches[0])
        g_one = list(torch.autograd.grad(loss, leaves))
        del leaves, loss
        state = opt.init([t for _, t in tree_leaves(params)])
        one = mesh_steps(build_train_step(arch, shape, None, cfg, optimizer=opt).jitted, params, state, batches)
    p_one = [t for _, t in tree_leaves(params)]  # kept on the card: the comparisons run there
    bias_c = 1 - ADAM_B2 ** len(batches)
    held = [
        torch.ones_like(nu, dtype=torch.bool) if hold_all else (nu == 0) | ((nu / bias_c).sqrt() > 100 * ADAM_EPS)
        for nu in state.nu
    ]
    del params, state
    torch.cuda.empty_cache()
    params = shard_tree(init(), arch.param_pspecs(mesh, cfg), mesh)
    b_specs = arch.input_pspecs(mesh, shape, cfg)
    placed = {k: place(v, b_specs[k], mesh) for k, v in batches[0].items()}
    with record_routing(replay=kept["routes"]) as route:
        _, _, g_mesh = mesh_value_and_grad(loss_fn, params, placed)
        g_err, g_worst = max((leaf_err(g.full(), w), p) for g, w, (p, _) in zip(g_mesh, g_one, tree_leaves(params)))
        del g_mesh, g_one, placed
        state = init_opt_state(opt, params)
        got = mesh_steps(build_train_step(arch, shape, mesh, cfg, optimizer=opt).jitted, params, state, batches)
    check(route["next"] == len(kept["routes"]), f"{what}: replayed {route['next']} of {len(kept['routes'])} routes")
    (p_err, p_worst), p_all = (0.0, ""), 0.0
    for (path, t), w, h in zip(tree_leaves(params), p_one, held):
        diff = (t.full() - w).abs()
        scale = float(w.abs().max().clamp_min(1e-30))
        p_err, p_worst = max((p_err, p_worst), (float(diff[h].max()) / scale if h.any() else 0.0, path))
        p_all = max(p_all, float(diff.max()) / scale)
    share = sum(int(h.sum()) for h in held) / sum(h.numel() for h in held)
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(got[0], one[0]))
    gn_err = max(abs(a - b) / abs(b) for a, b in zip(got[1], one[1]))
    check(g_err <= MESH_LIMITS["grad"], f"{what}: gradients on the mesh {g_err:.3e} of max |g|")
    check(loss_err <= MESH_LIMITS["loss"], f"{what}: losses {got[0]} vs one device {one[0]}")
    check(gn_err <= MESH_LIMITS["loss"], f"{what}: grad norms {got[1]} vs one device {one[1]}")
    check(p_err <= MESH_LIMITS["param"], f"{what}: parameters after {len(batches)} steps {p_err:.3e} ({p_worst})")
    check(route["flips"] == 0 or route["flip_ratio"] <= 1,
          f"{what}: a token routed apart by its own top k beyond rounding: {route}")
    out = (
        f"gradients at the initial parameters {g_err:.3e} of max |g| ({g_worst}; limit "
        f"{MESH_LIMITS['grad']}), "
        f"{len(batches)} steps' losses {[round(x, 6) for x in got[0]]} vs one device "
        f"{[round(x, 6) for x in one[0]]} ({loss_err:.3e} relative), grad norms {gn_err:.3e}, "
        f"parameters after the steps {p_err:.3e} of max |w| ({p_worst}) over the {100 * share:.4f} % held "
        f"({p_all:.3e} over all); "
        f"f32 steps (s) one device {[round(x, 3) for x in one[2]]}, mesh {[round(x, 3) for x in got[2]]}"
    )
    if moe:
        out += (
            f"; routing at the initial parameters: {stats['drops']} of {stats['assigned']} "
            f"token-expert assignments dropped at capacity, smallest top-k margin "
            f"{stats['margin']:.3e}; the mesh replayed one device's {len(kept['routes'])} chunk "
            f"routes, {route['flips']} token routings its own top k would have sent elsewhere "
            f"(largest margin / twice the probabilities' change {route['flip_ratio']:.3e}, limit 1)"
        )
    del params, state, p_one, held
    torch.cuda.empty_cache()
    return out


def mesh_train_bf16(arch, cfg, mesh, batches, what: str, smi: str, shape=None,
                    flops: float | None = None) -> tuple[list, str]:
    """``cfg`` at bf16 compute, one device then ``mesh``, the steps after the
    first timed: ms a step, model-FLOPs share, peak memory, the losses
    within 5 % of one device's, and the mesh step's device split.
    ``shape`` / ``flops``: the batches' shape and a step's FLOPs (default:
    seq TRAIN_SEQ x batch TRAIN_BATCH, ``model_flops_per_token``).  Returns
    one device's losses and the summary."""
    tokens = None if shape else TRAIN_SEQ * TRAIN_BATCH
    shape = shape or ShapeSpec("train", TRAIN_SEQ, TRAIN_BATCH, "train")
    opt = loop_optimizer()
    walls, losses, peaks = {}, {}, {}
    for where in ("one", "mesh"):
        torch.cuda.reset_peak_memory_stats()
        params = arch.init_params(torch.Generator(device=DEVICE).manual_seed(0), cfg)
        if where == "mesh":
            params = shard_tree(params, arch.param_pspecs(mesh, cfg), mesh)
        state = init_opt_state(opt, params)
        step = build_train_step(arch, shape, mesh if where == "mesh" else None, cfg, optimizer=opt).jitted
        losses[where], _, secs = mesh_steps(step, params, state, batches)
        walls[where] = statistics.mean(secs[1:])
        peaks[where] = torch.cuda.max_memory_allocated()
        if where == "mesh":
            split = device_split(lambda: step(params, state, batches[-1]), n=1, top=8, width=80)
        del params, state, step
        torch.cuda.empty_cache()
    err = max(abs(a - b) / abs(b) for a, b in zip(losses["mesh"], losses["one"]))
    check(err <= 0.05, f"{what} bf16: losses {losses['mesh']} vs one device {losses['one']}")
    if flops is None:
        flops = model_flops_per_token(arch, cfg, TRAIN_SEQ) * tokens
    rate = f"{tokens / walls['mesh']:.1f} tokens/s, " if tokens else ""
    return losses["one"], (
        f"bf16 compute (the config's): {1e3 * walls['mesh']:.3f} ms a step on the mesh vs "
        f"{1e3 * walls['one']:.3f} ms on one device ({walls['mesh'] / walls['one']:.3f}x; mean of "
        f"steps 2-{len(batches)}), {rate}model FLOPs {flops:.4e} a "
        f"step = {flops / walls['mesh'] / BF16_TC_FLOPS:.4f} of the dense bf16 peak on the mesh "
        f"({flops / walls['one'] / BF16_TC_FLOPS:.4f} on one device); peak memory "
        f"{peaks['mesh'] / 2**30:.3f} GiB on the mesh, {peaks['one'] / 2**30:.3f} GiB on one device; "
        f"losses {[round(x, 5) for x in losses['mesh']]} vs {[round(x, 5) for x in losses['one']]} "
        f"({err:.3e} relative, limit 0.05); the mesh step's split: {split}; on {smi}"
    )


def grow_kv(caches, extra: int):
    """Prefill caches with ``extra`` empty positions after their K / V (a
    sharded leaf grown shard by shard); ``len`` and the SSM's conv / state
    copied, so that decoding leaves the prefill's as they were."""

    def grow(name, t):
        if name.rsplit("/", 1)[-1] not in ("k", "v"):
            return t.map(torch.clone) if isinstance(t, Sharded) else t.clone()
        if isinstance(t, Sharded):
            shards = [torch.cat([s, s.new_zeros((*s.shape[:2], extra, *s.shape[3:]))], dim=2)
                      for s in t.shards]
            return Sharded.from_local(shards, t.mesh, t.spec)
        return torch.cat([t, t.new_zeros((*t.shape[:2], extra, *t.shape[3:]))], dim=2)

    return tree_map(grow, caches)


def block_err(t: Sharded, whole: torch.Tensor) -> float:
    """Each shard's block of ``t`` against its slice of ``whole`` (the
    one-device tensor): max error / max."""
    err = 0.0
    for i, block in enumerate(t.shards):
        idx = []
        for n, entry in zip(t.shape, t.spec):
            k = n // t.mesh.axis_size(entry)
            b = t.mesh.block_index(i, entry)
            idx.append(slice(b * k, (b + 1) * k))
        err = max(err, leaf_err(block, whole[tuple(idx)]))
    return err


def conv_blocks_err(caches, caches_one) -> tuple[float, int]:
    """Each shard's block of every SSM conv cache against the one-device
    cache's rows and columns of that block: (max error / max, blocks)."""
    convs = [(c["conv"], caches_one[pos]["conv"]) for pos, c in caches.items() if "conv" in c]
    err = max((block_err(t, w) for t, w in convs), default=0.0)
    return err, sum(len(t.shards) for t, _ in convs)


def dtype_name(cfg) -> str:
    return str(cfg.compute_dtype).removeprefix("torch.")


def timed_s(fn) -> float:
    """Seconds ``fn`` takes, the card synchronised before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def mesh_serve(arch, cfgs: list, mesh, qparams, batch, flash: int, qdots: int, decode: int,
               what: str, smi: str) -> dict:
    """``cfgs``: [(config, logit limit, cache limit)], the same tree served
    at each config's compute dtype.  One device first, each config: a
    warm-up, the prefill of ``batch`` and ``decode`` greedy steps (fed the
    first config's tokens) against its caches grown by ``decode``
    positions, each with its MoE routes kept; the first config's prefill
    and first MESH17_TIMED_DECODE decode steps again, unrecorded and timed.
    Then the tree placed on ``mesh`` (rebound leaf by leaf: the one-device
    copy goes as the sharded one is made), and each config: the prefill and
    the decode steps with the one-device routes replayed (a token routed
    apart by its own top k only where its margin lies within the runs'
    difference) and every launch held to plain as it is made (the kernels'
    counts equal to the launches checked, ``flash`` and ``qdots`` a prefill,
    ``qdots`` a decode step); the logits within the logit limit of max |one
    device's| with the greedy tokens equal where decided, every cache leaf
    within the cache limit of its max (each shard's block of a model-split
    conv cache against the one-device columns).  A later config's None
    limits come from its one-device distance from the first config's, the
    twin: max(MESH17_TWIN_FLOOR, 2 x that distance).  Then the first
    config's prefill and decode steps on the mesh, unrecorded and timed.
    Returns the mesh's launches."""
    B, S = batch["tokens"].shape
    if "vision_embeds" in batch:
        S += batch["vision_embeds"].shape[1]
    T, n_timed = decode, min(decode, MESH17_TIMED_DECODE)
    pshape, dshape = ShapeSpec("prefill", S, B, "prefill"), ShapeSpec("decode", S + T, B, "decode")
    kw = dict(quant=lm_policy(8), serve_optimized=True)
    steps = lambda m, cfg: (build_prefill_step(arch, pshape, m, cfg, **kw).jitted,
                            build_decode_step(arch, dshape, m, cfg, **kw).jitted)
    warm = {"tokens": batch["tokens"][:, :8]}
    cur = torch.full((B,), S, dtype=torch.int32, device=DEVICE)

    def greedy(dec, caches, toks, steps: int = T) -> list:
        outs = []
        for t in range(steps):
            lg, _ = dec(qparams, caches, {"tokens": toks[t], "cur_len": cur + t})
            outs.append(lg)
            if len(toks) == t + 1:  # one device's first config: its own greedy tokens
                toks.append(lg.argmax(-1).to(torch.int32))
        return outs

    ones, toks = [], None
    with torch.no_grad():
        for cfg, _, _ in cfgs:
            pre, dec = steps(None, cfg)
            pre(qparams, warm)
            with record_routing(keep=True) as r_pre:
                logits, caches = pre(qparams, batch)
            toks = toks or [logits.argmax(-1).to(torch.int32)]
            grown = grow_kv(caches, T)
            with record_routing(keep=True) as r_dec:
                outs = greedy(dec, grown, toks)
            ones.append(dict(logits=logits, caches=caches, grown=grown, outs=outs, pre=r_pre, dec=r_dec))
        pre, dec = steps(None, cfgs[0][0])
        one_s = timed_s(lambda: pre(qparams, batch))
        one_ms = 1e3 * timed_s(lambda: greedy(dec, grow_kv(ones[0]["caches"], T), toks, n_timed)) / max(n_timed, 1)
        steps(mesh, cfgs[0][0])[0](qparams, warm)  # places the tree: qparams' leaves are now sharded
        counts = {}
        for (cfg, logit_tol, cache_tol), one in zip(cfgs, ones):
            twin = ""
            if logit_tol is None:
                ref = ones[0]
                d_l = max(leaf_err(a, b) for a, b in zip([one["logits"], *one["outs"]],
                                                          [ref["logits"], *ref["outs"]]))
                d_c = max(leaf_err(one["caches"][p][k], ref["caches"][p][k])
                          for p in ref["caches"] for k in ref["caches"][p] if k != "len")
                logit_tol, cache_tol = max(MESH17_TWIN_FLOOR, 2 * d_l), max(MESH17_TWIN_FLOOR, 2 * d_c)
                twin = (f"; one device's own {dtype_name(cfg)} logits lie {d_l:.3e} of max from its "
                        f"{dtype_name(cfgs[0][0])} ones and its caches {d_c:.3e}, so the limits are "
                        f"max({MESH17_TWIN_FLOOR}, twice those)")
            pre, dec = steps(mesh, cfg)
            with checked_launches(what, sampled=False) as stats, \
                    record_routing(replay=one["pre"]["routes"]) as route:
                reset_counts()
                logits, caches = pre(qparams, batch)
                torch.cuda.synchronize()
                pc = read_counts()
            check(pc["flash_attention"] == flash == stats["flash_attention"],
                  f"{what}: {flash} flash launches, each checked, not {pc} ({stats['flash_attention']} checked)")
            check(pc["quant_matmul"] == qdots == stats["quant_matmul"],
                  f"{what}: {qdots} quant_matmul launches, each checked, not {pc} ({stats['quant_matmul']} checked)")
            check(not isinstance(logits, Sharded) and logits.shape == (B, 1, cfg.vocab), f"{what}: logits")
            p_err, p_dec, p_same = logits_agree(logits, one["logits"], f"{what} prefill", logit_tol)
            c_err = max(
                leaf_err(caches[p][k].full(), one["caches"][p][k])
                for p in one["caches"] for k in one["caches"][p] if k != "len"
            )
            check(c_err <= cache_tol, f"{what}: caches {c_err:.3e} of max apart")
            check(all(torch.equal(c["len"].full(), one["caches"][p]["len"]) for p, c in caches.items() if "len" in c),
                  f"{what}: len")
            conv = conv_blocks_err(caches, one["caches"])
            check(conv[0] <= cache_tol, f"{what}: conv cache blocks {conv[0]:.3e} of max apart")
            grown = grow_kv(caches, T)
            with checked_launches(f"{what} decode", sampled=False) as dstats, \
                    record_routing(replay=one["dec"]["routes"]) as route_d:
                reset_counts()
                outs = greedy(dec, grown, toks)
                torch.cuda.synchronize()
                dc = read_counts()
            check(dc["quant_matmul"] == qdots * T == dstats["quant_matmul"]
                  and dc["flash_attention"] == 0 == dstats["flash_attention"],
                  f"{what} decode: {qdots} x {T} quant_matmul launches, each checked, and no flash, "
                  f"not {dc} ({dstats['quant_matmul']} checked)")
            for r, kept in ((route, one["pre"]), (route_d, one["dec"])):
                check(r["next"] == len(kept["routes"]), f"{what}: replayed {r['next']} of {len(kept['routes'])} routes")
                check(r["flips"] == 0 or r["flip_ratio"] <= 1,
                      f"{what}: a token routed apart by its own top k beyond rounding: {r}")
            d_err, d_dec, d_same = 0.0, 0, 0
            for t, (a, b) in enumerate(zip(outs, one["outs"])):
                e, dd, ss = logits_agree(a, b, f"{what} decode step {t}", logit_tol)
                d_err, d_dec, d_same = max(d_err, e), d_dec + dd, d_same + ss
            conv_d = conv_blocks_err(grown, one["grown"]) if T else (0.0, 0)
            check(conv_d[0] <= cache_tol, f"{what} decode: conv cache blocks {conv_d[0]:.3e} of max apart")
            timing = ""
            if cfg is cfgs[0][0]:
                mesh_s = timed_s(lambda: pre(qparams, batch))
                mesh_ms = 1e3 * timed_s(lambda: greedy(dec, grow_kv(caches, T), toks, n_timed)) / max(n_timed, 1)
                timing = (f"{B} x {S} prefill {mesh_s:.3f} s warm, unrecorded vs {one_s:.3f} s on one device "
                          f"({mesh_s / one_s:.3f}x)"
                          + (f"; the first {n_timed} decode steps unrecorded {mesh_ms:.3f} ms a step vs "
                             f"{one_ms:.3f} ms on one device ({mesh_ms / one_ms:.3f}x)" if T else "") + "; ")
            fa = json.dumps({k: {f: round(u, 4) for f, u in d.items()} for k, d in stats["fa_used"].items()})
            moe = (
                f"; the mesh replayed one device's routes: its own top k would have sent {route['flips']} "
                f"prefill and {route_d['flips']} decode token routings elsewhere (largest margin / twice "
                f"the token's largest probability change {max(route['flip_ratio'], route_d['flip_ratio']):.3e}, "
                f"limit 1; the largest change {max(route['moved'], route_d['moved']):.3e}), smallest top-k "
                f"margin {min(one['pre']['margin'], one['dec']['margin']):.3e}, capacity drops "
                f"{route['drops']} of {route['assigned']} in the prefill (one device {one['pre']['drops']})"
            ) if cfg.moe else ""
            print(
                f"mesh serve ({what}) {arch.name} full width ({cfg.n_layers} layers) int8 serve_optimized, "
                f"{dtype_name(cfg)} compute, on {mesh}: {timing}{pc['quant_matmul']} prefill quant_matmul "
                f"launches and {dc['quant_matmul']} decode ones each within QM_TOL of plain (max_abs_err "
                f"{max(stats['qm_err'], dstats['qm_err']):.3e}), {pc['flash_attention']} flash_attention "
                f"launches within FA_TOL (max_abs_err {stats['fa_err']:.3e}; tolerance used, then by each "
                f"planted fault: {fa}); prefill logits {p_err:.3e} of max from one device (limit "
                f"{logit_tol:.3e}; {p_same}/{B} greedy tokens equal, {p_dec} decided), caches {c_err:.3e} "
                f"(limit {cache_tol:.3e})"
                + (f", the model-split conv cache's {conv[1]} shard blocks {conv[0]:.3e} of the one-device "
                   f"columns' max (after {T} decode steps {conv_d[0]:.3e})" if conv[1] else "")
                + (f"; {T} greedy decode steps fed the one-device tokens: {d_same}/{B * T} tokens equal "
                   f"({d_dec} decided), logits {d_err:.3e} of max apart" if T else "")
                + twin + moe + f"; on {smi}"
            )
            counts = {k: counts.get(k, 0) + pc[k] + dc[k] for k in pc}
    del qparams, caches, grown, outs, ones
    torch.cuda.empty_cache()
    return counts


def phase17_moe_train(mesh, smi: str) -> dict:
    """17a: granite-moe-1b-a400m at full width, train steps at seq 256 x
    batch 8 on ``mesh``: the "tp" expert layout at f32 against one device,
    then bf16 timed; "fsdp" and "megatron" at f32 cut to MESH17_CUT layers."""
    arch = get_arch(MOE_ARCH)
    batches = train_batches(arch, arch.config, MESH_STEPS)
    reset_counts()
    f32 = dataclasses.replace(arch.config, compute_dtype=torch.float32)
    print(f"mesh train (17a) {MOE_ARCH} full width (24 layers, 32 experts top 8) \"tp\" experts "
          f"on {mesh}, f32 compute: {mesh_train_f32(arch, f32, mesh, batches, '17a tp')}; on {smi}")
    print(f"mesh train (17a) {MOE_ARCH} \"tp\": "
          f"{mesh_train_bf16(arch, arch.config, mesh, batches, '17a', smi)[1]}")
    for layout in ("fsdp", "megatron"):
        cut = dataclasses.replace(f32, n_layers=MESH17_CUT,
                                  moe=dataclasses.replace(f32.moe, shard_experts=layout))
        print(f"mesh train (17a) {MOE_ARCH} \"{layout}\" experts, cut to {MESH17_CUT} of "
              f"{f32.n_layers} layers (full width), f32: "
              f"{mesh_train_f32(arch, cut, mesh, batches, f'17a {layout}')}; on {smi}")
    counts = read_counts()
    check(sum(counts.values()) == 0, f"17a: a train step launched a kernel: {counts}")
    return counts


def phase17_moe_serve(mesh, smi: str) -> dict:
    """17b: qwen2-moe-a2.7b, all 24 layers, int8 serve_optimized (bf16
    experts and embeddings): a 2 x 4096 prefill and 16 decode steps."""
    arch = get_arch(MOE_SERVE_ARCH)
    cfg = arch.config
    qparams = quantize_tree(init_bf16(arch, cfg), lm_policy(8))
    tokens = torch.from_numpy(np.random.default_rng(17).integers(0, cfg.vocab, (MESH_PREFILL_B, MESH_PREFILL_S)))
    n, L = mesh.size, cfg.n_layers
    return mesh_serve(arch, [(cfg, MESH_LOGIT_TOL, CACHE_TOL)], mesh, qparams, {"tokens": tokens.to(DEVICE)},
                      L * n, QDOTS_PER_LAYER * L * n, MESH_DECODE, "17b", smi)


def phase17_hybrid_serve(mesh, smi: str) -> dict:
    """17c: jamba-v0.1-52b at full width cut to one pattern group (phase 14's
    cut): int8 serve_optimized weights, a 2 x 4096 prefill and 16 decode
    steps at f32 compute (the f32 limits), then at the config's bf16 (limits
    from one device's bf16-vs-f32 distance); its conv cache split over
    ``model`` (8448 -> 4224 a shard)."""
    arch = get_arch(HYBRID_ARCH)
    cfg = dataclasses.replace(arch.config, n_layers=len(tfm.layer_pattern(arch.config)))
    arch = dataclasses.replace(arch, config=cfg)
    qparams = quantize_tree(init_bf16(arch, cfg), lm_policy(8))
    tokens = torch.from_numpy(np.random.default_rng(18).integers(0, cfg.vocab, (MESH_PREFILL_B, MESH_PREFILL_S)))
    f32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
    cfgs = [(f32, MESH17_F32_LOGIT_TOL, MESH17_F32_CACHE_TOL), (cfg, None, None)]
    return mesh_serve(arch, cfgs, mesh, qparams, {"tokens": tokens.to(DEVICE)}, mesh.size,
                      30 * mesh.size, MESH_DECODE, "17c", smi)


def phase17_ssm(mesh, smi: str) -> dict:
    """17d: mamba2-780m, all 48 layers: an f32 train step against one
    device, a bf16 step timed, a 2 x 512 prefill and 16 decode steps of its
    int8 serve_optimized weights at f32 compute, then at the config's bf16
    (limits from one device's bf16-vs-f32 distance, as 17c)."""
    arch = get_arch(SSM_ARCH)
    batches = train_batches(arch, arch.config, 2)
    reset_counts()
    f32 = dataclasses.replace(arch.config, compute_dtype=torch.float32)
    print(f"mesh train (17d) {SSM_ARCH} full width (48 layers, 48 heads) on {mesh}, f32 compute: "
          f"{mesh_train_f32(arch, f32, mesh, batches[:1], '17d')}; on {smi}")
    print(f"mesh train (17d) {SSM_ARCH}: {mesh_train_bf16(arch, arch.config, mesh, batches, '17d', smi)[1]}")
    counts = read_counts()
    check(sum(counts.values()) == 0, f"17d: a train step launched a kernel: {counts}")
    cfg = arch.config
    qparams = quantize_tree(init_bf16(arch, cfg), lm_policy(8))
    tokens = torch.from_numpy(np.random.default_rng(19).integers(0, cfg.vocab, (MESH_PREFILL_B, MESH17_SSM_PROMPT)))
    cfgs = [(f32, MESH17_F32_LOGIT_TOL, MESH17_F32_CACHE_TOL), (cfg, None, None)]
    return mesh_serve(arch, cfgs, mesh, qparams, {"tokens": tokens.to(DEVICE)}, 0,
                      2 * cfg.n_layers * mesh.size, MESH_DECODE, "17d", smi)


def phase17_vlm(mesh, smi: str) -> dict:
    """17e: qwen2-vl-2b, all 28 layers: an f32 train step with patch
    embeddings and M-RoPE positions against one device; a 2 x 4096 int8
    prefill of 256 patches (a 16 x 16 grid) and 3840 text tokens each."""
    arch = get_arch(VLM_ARCH)
    cfg = arch.config
    reset_counts()
    f32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
    batches = train_batches(arch, cfg, 1)
    print(f"mesh train (17e) {VLM_ARCH} full width (28 layers; 128 patches + 128 text tokens, M-RoPE "
          f"on an 8 x 16 grid) on {mesh}, f32 compute: {mesh_train_f32(arch, f32, mesh, batches, '17e')}; "
          f"on {smi}")
    counts = read_counts()
    check(sum(counts.values()) == 0, f"17e: a train step launched a kernel: {counts}")
    n_vis, B = arch.n_vision_tokens, MESH_PREFILL_B
    gen = torch.Generator(device=DEVICE).manual_seed(2)
    batch = {
        "tokens": torch.from_numpy(np.random.default_rng(20).integers(
            0, cfg.vocab, (B, MESH_PREFILL_S - n_vis))).to(DEVICE),
        "vision_embeds": torch.randn(B, n_vis, cfg.d_model, device=DEVICE, generator=gen).to(torch.bfloat16),
        "positions3": vlm_positions3(B, 16, 16, MESH_PREFILL_S),
    }
    qparams = quantize_tree(init_bf16(arch, cfg), lm_policy(8))
    return mesh_serve(arch, [(cfg, MESH_LOGIT_TOL, CACHE_TOL)], mesh, qparams, batch, cfg.n_layers * mesh.size,
                      QDOTS_PER_LAYER * cfg.n_layers * mesh.size, 0, "17e", smi)


def phase_mesh_families(smi: str, launches: dict) -> None:
    """Phase 17: the MoE, SSM, hybrid and VLM LMs over the (2, 2) mesh of
    four shards of card 0 (17a-e), then on distinct cards where the machine
    has them."""
    t0 = time.perf_counter()
    n = torch.cuda.device_count()
    meshes = [card_mesh2(MESH_SHAPE)]
    if n >= 2:
        shape = (2, 2) if n >= 4 else (1, 2)
        meshes.append(card_mesh2(shape, [f"cuda:{i}" for i in range(shape[0] * shape[1])]))
    else:
        print(f"mesh families on distinct cards: not run (this machine has {n} card); 17a-e ran "
              f"on four shards of card 0 only")
    for mesh in meshes:
        for name, phase in [
            ("mesh_moe_train", lambda: phase17_moe_train(mesh, smi)),
            ("mesh_moe_serve", lambda: phase17_moe_serve(mesh, smi)),
            ("mesh_hybrid_serve", lambda: phase17_hybrid_serve(mesh, smi)),
            ("mesh_ssm", lambda: phase17_ssm(mesh, smi)),
            ("mesh_vlm", lambda: phase17_vlm(mesh, smi)),
        ]:
            t1 = time.perf_counter()
            counts = phase()
            print(f"launches[{name}]: {counts} ({time.perf_counter() - t1:.3f} s)")
            for k, v in counts.items():
                launches[k] += v
    print(f"phase 17 took {time.perf_counter() - t0:.3f} s; on {smi}")


# ---------------------------------------------------------------------------
# Phase 18: Whisper over the mesh, and the sequence-sharded KV decode
# ---------------------------------------------------------------------------

# 18a: train_4k's shape, batch 256 -> 2 (one clip a data shard) and 4096 ->
# 2048 frames (448 decoder tokens): a step keeps its f32 attention
# probabilities for the backward, ~0.5 GB a layer and clip at 2048 frames,
# ~1 GB (the chunked plain code) at 4096, where 15c's one clip took 47.9 GiB
# at bf16: two clips would not fit one card, at bf16 or f32
W18_TRAIN_FRAMES, W18_TRAIN_B, W18_F32_STEPS = 2048, 2, 1
# 18b: prefill_32k's 4096 frames, batch 32 -> 2 (one clip a data shard), at
# f32 and bf16 compute; 18c: decode_32k's 32768 encoder frames, batch 128 ->
# 1, the cross cache's sequence over data (shard_cache_seq) and its heads
# over model, at f32 compute only: f32 attention at 32768 frames takes 9.1 s
# a prefill on one device and 18.7 s on the mesh (my run C, PR 24), and a
# bf16 pass (run C: within its limits) would need an f32 one beside it
# for its limit.  W18_TIMED decode steps timed after the checked ones
W18_SERVE_B, W18_SERVE_S, W18_DECODE, W18_TIMED = 2, 4096, 16, 8
# 18d: long_500k (batch 1, a 524288-deep cache), jamba's one 8-layer group
# (phase 14's cut); decode steps from two seeded caches, then a real prefill
# grown into a buffer whose valid entries span both data blocks
L500_DEPTH, L500_LENS, L500_STEPS = 524_288, (262_144, 393_216), 4
L500_PREFILL, L500_BUFFER = 4096, 6144


def phase18_whisper_train(mesh, smi: str) -> dict:
    """18a: whisper-medium, all 24 + 24 layers, train steps at 2048 frames x
    448 tokens x batch 2 on ``mesh``: at f32 compute against one device
    (phase 16a's limits; parameters where AdamW's update is conditioned),
    then timed at the config's bf16 with the mesh step's device split."""
    arch = get_arch(WHISPER_ARCH)
    cfg = arch.config
    shape = ShapeSpec("train", W18_TRAIN_FRAMES, W18_TRAIN_B, "train")
    batches = [arch.input_concrete(torch.Generator(device=DEVICE).manual_seed(180 + i), shape, cfg)
               for i in range(MESH_STEPS)]
    T = batches[0]["tokens"].shape[1]
    reset_counts()
    f32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
    what = f"{W18_TRAIN_B} clips x {W18_TRAIN_FRAMES} frames + {T} tokens"
    print(f"mesh train (18a) {WHISPER_ARCH} full width (24 + 24 layers), {what}, on {mesh}, f32 "
          f"compute: {mesh_train_f32(arch, f32, mesh, batches[:W18_F32_STEPS], '18a', shape=shape)}; on {smi}")
    flops = W18_TRAIN_B * whisper_train_flops(cfg, W18_TRAIN_FRAMES, T)
    print(f"mesh train (18a) {WHISPER_ARCH} {what} (FLOPs executed, counted from the shapes): "
          f"{mesh_train_bf16(arch, cfg, mesh, batches, '18a', smi, shape=shape, flops=flops)[1]}")
    counts = read_counts()
    check(sum(counts.values()) == 0, f"18a: a train step launched a kernel: {counts}")
    return counts


def whisper_mesh_serve(mesh, B: int, S: int, shard_seq: bool, bf16: bool, what: str, smi: str) -> dict:
    """whisper-medium, int8 ``serve_optimized`` weights (seeded), ``B`` clips
    of ``S`` frames at f32 compute, then (``bf16``) at the config's bf16.
    One device first, each config: the prefill and W18_DECODE greedy steps
    from token 0 (the bf16 pass fed the f32 pass's tokens).  Then the tree
    placed on ``mesh`` and, each config: ``whisper_prefill`` (``shard_seq``:
    the cross cache's sequence over ``data``) and the decode steps fed the
    same tokens, every ``quant_matmul`` launch held to plain at QM_TOL and
    every ``flash_attention`` launch at FA_TOL as it is made (a 32k launch
    on sampled query blocks), the kernels' counts equal to the launches
    checked; each shard's block of every layer's cross K / V, and after the
    steps of the self cache, against its slice of the one-device cache; the
    logits within the config's limit of max |one device's| with the greedy
    token equal wherever decided.  The limits: at f32 17c's (logits 1e-4,
    caches 1e-3); at bf16 max(MESH17_TWIN_FLOOR, twice one device's own
    bf16-vs-f32 distance), 17c's rule, since the random 48 layers compound
    bf16 rounding (my run B, PR 24: the mesh's first decode step 1.710e-02
    of max from one device's at bf16).  Timed, unrecorded, at the last
    config: W18_TIMED decode steps on each side, continuing the checked
    caches (one device's on a copy of its self caches), a mesh decode
    step's device split and, below 32768 frames, the prefill on each side.
    Returns the mesh's launches."""
    from repro_torch.models.whisper import whisper_prefill

    arch = get_arch(WHISPER_ARCH)
    cfg = arch.config
    n, L = mesh.size, cfg.n_enc_layers
    per_prefill, per_step = whisper_qdots(cfg)
    qparams = quantize_tree(init_bf16(arch, cfg), lm_policy(8))
    frames = torch.randn(B, S, cfg.d_model, generator=torch.Generator(device=DEVICE).manual_seed(181),
                         device=DEVICE).to(torch.bfloat16)
    f32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
    cfgs = [(f32, MESH17_F32_LOGIT_TOL, MESH17_F32_CACHE_TOL)] + ([(cfg, None, None)] if bf16 else [])
    kw = dict(quant=lm_policy(8), serve_optimized=True)
    pshape, dshape = ShapeSpec("prefill", S, B, "prefill"), ShapeSpec("decode", S, B, "decode")
    steps = lambda m, c: (build_prefill_step(arch, pshape, m, c, **kw).jitted,
                          build_decode_step(arch, dshape, m, c, shard_cache_seq=shard_seq and m is not None,
                                            **kw).jitted)
    toks = [torch.zeros(B, 1, dtype=torch.int32, device=DEVICE)]
    batch, warm = {"audio_frames": frames}, {"audio_frames": frames[:, :64]}
    timed_prefill = S < LONG_FRAMES  # a 32k prefill's time is phase 15b's

    def decode_all(dec, caches, n_steps: int = W18_DECODE, cur0: int = 0) -> list:
        outs = []
        for t in range(n_steps):
            cur = torch.full((B,), cur0 + t, dtype=torch.int32, device=DEVICE)
            lg, _ = dec(qparams, caches, {"tokens": toks[t], "cur_len": cur})
            outs.append(lg)
            if len(toks) == t + 1:  # one device's f32 pass: its own greedy tokens
                toks.append(lg.argmax(-1).to(torch.int32))
        return outs

    ones, one_s = [], None
    with torch.no_grad():
        for c, _, _ in cfgs:
            pre, dec = steps(None, c)
            pre(qparams, warm)
            caches = pre(qparams, batch)
            ones.append(dict(caches=caches, outs=decode_all(dec, caches)))
        if timed_prefill:
            one_s = timed_s(lambda: pre(qparams, batch))
        copy = {"self": {k: t.clone() for k, t in caches["self"].items()}, "cross": caches["cross"]}
        one_ms = 1e3 * timed_s(lambda: decode_all(dec, copy, W18_TIMED, W18_DECODE)) / W18_TIMED
        del copy
        torch.cuda.empty_cache()
        steps(mesh, cfgs[0][0])[0](qparams, warm)  # places the tree: qparams' leaves are now sharded
        counts = {}
        for (c, logit_tol, cache_tol), one in zip(cfgs, ones):
            twin = ""
            if logit_tol is None:  # bf16: the limits from one device's own bf16-vs-f32 distance
                ref = ones[0]
                d_l = max(leaf_err(a, b) for a, b in zip(one["outs"], ref["outs"]))
                d_c = max(leaf_err(one["caches"]["cross"][k], ref["caches"]["cross"][k]) for k in ("k", "v"))
                logit_tol, cache_tol = max(MESH17_TWIN_FLOOR, 2 * d_l), max(MESH17_TWIN_FLOOR, 2 * d_c)
                twin = (f"; one device's own bf16 logits lie {d_l:.3e} of max from its f32 ones and its "
                        f"cross caches {d_c:.3e}, so the limits are max({MESH17_TWIN_FLOOR}, twice those)")
            _, dec = steps(mesh, c)
            prefill = lambda: whisper_prefill(c, qparams, frames, shard_seq=shard_seq)
            with checked_launches(f"{what} prefill", sampled=S >= LONG_FRAMES) as stats:
                reset_counts()
                caches = prefill()
                torch.cuda.synchronize()
                pc = read_counts()
            check(pc["flash_attention"] == L * n == stats["flash_attention"],
                  f"{what}: {L * n} flash launches, each checked, not {pc} ({stats['flash_attention']} checked)")
            check(pc["quant_matmul"] == per_prefill * n == stats["quant_matmul"],
                  f"{what}: {per_prefill * n} quant_matmul launches, each checked, not {pc}")
            seq = "data" if shard_seq else None
            for part in ("cross", "self"):
                check(caches[part]["k"].spec == (None, None if B == 1 else "data", seq if part == "cross" else None,
                                                 "model", None), f"{what}: {part} cache spec {caches[part]['k'].spec}")
            c_err = max(block_err(caches["cross"][k], one["caches"]["cross"][k]) for k in ("k", "v"))
            check(c_err <= cache_tol, f"{what} {dtype_name(c)}: cross cache blocks {c_err:.3e} of max apart")
            with checked_launches(f"{what} decode", sampled=False) as dstats:
                reset_counts()
                outs = decode_all(dec, caches)
                torch.cuda.synchronize()
                dc = read_counts()
            check(dc["quant_matmul"] == per_step * n * W18_DECODE == dstats["quant_matmul"]
                  and dc["flash_attention"] == 0, f"{what} decode: launches {dc} ({dstats['quant_matmul']} checked)")
            s_err = max(block_err(caches["self"][k], one["caches"]["self"][k]) for k in ("k", "v"))
            check(s_err <= cache_tol, f"{what} {dtype_name(c)}: self cache blocks after the steps {s_err:.3e} of max apart")
            check(all(torch.equal(caches[p]["len"].full(), one["caches"][p]["len"]) for p in ("self", "cross")),
                  f"{what}: cache lengths")
            d_err, d_dec, d_same = 0.0, 0, 0
            for t, (a, b) in enumerate(zip(outs, one["outs"])):
                e, dd, ss = logits_agree(a, b, f"{what} {dtype_name(c)} decode step {t}", logit_tol)
                d_err, d_dec, d_same = max(d_err, e), d_dec + dd, d_same + ss
            timing = ""
            if c is cfgs[-1][0]:
                mesh_ms = 1e3 * timed_s(lambda: decode_all(dec, caches, W18_TIMED, W18_DECODE)) / W18_TIMED
                last = {"tokens": toks[0], "cur_len": torch.full((B,), W18_DECODE + W18_TIMED, dtype=torch.int32,
                                                                 device=DEVICE)}
                split = device_split(lambda: dec(qparams, caches, last), n=2, top=6, width=60)
                if timed_prefill:
                    mesh_s = timed_s(prefill)
                    timing = (f"prefill {mesh_s:.3f} s warm, unrecorded vs {one_s:.3f} s on one device "
                              f"({mesh_s / one_s:.3f}x), ")
                timing += (f"{W18_TIMED} more decode steps unrecorded {mesh_ms:.3f} ms a step vs {one_ms:.3f} ms "
                           f"on one device ({mesh_ms / one_ms:.3f}x); a mesh decode step's split: {split}; ")
            fa = json.dumps({k: {f: round(u, 4) for f, u in d.items()} for k, d in stats["fa_used"].items()})
            print(
                f"mesh serve ({what}) {WHISPER_ARCH} full width int8 serve_optimized, {dtype_name(c)} compute, "
                f"{B} x {S} frames{', shard_cache_seq' if shard_seq else ''}, on {mesh}: {timing}"
                f"{pc['quant_matmul']} prefill quant_matmul launches and {dc['quant_matmul']} decode ones each "
                f"within QM_TOL of plain (max_abs_err {max(stats['qm_err'], dstats['qm_err']):.3e}), "
                f"{pc['flash_attention']} flash_attention launches (local heads) within FA_TOL (max_abs_err "
                f"{stats['fa_err']:.3e}; tolerance used, then by each planted fault: {fa}); each shard's "
                f"block of every layer's cross K / V {c_err:.3e} of max from one device's (limit "
                f"{cache_tol:.3e}), of the self caches after {W18_DECODE} steps {s_err:.3e}; {W18_DECODE} "
                f"greedy decode steps fed the one-device tokens: {d_same}/{B * W18_DECODE} tokens equal "
                f"({d_dec} decided), logits {d_err:.3e} of max apart (limit {logit_tol:.3e}){twin}; tokens "
                f"{torch.cat(toks[1:], dim=1)[0, :8].tolist()}...; on {smi}"
            )
            counts = {k: counts.get(k, 0) + pc[k] + dc[k] for k in pc}
            del caches
    del qparams, ones
    torch.cuda.empty_cache()
    return counts


def phase18_long500k(mesh, smi: str) -> dict:
    """18d: jamba-v0.1-52b at full width cut to one 8-layer group (phase 14's
    cut), int8 ``serve_optimized`` weights at f32 compute, long_500k's
    layout: batch 1 and a L500_DEPTH-deep cache, its attention layer's
    sequence over ``data`` (``shard_cache_seq``) and its kv heads over
    ``model``.  One device first: L500_STEPS greedy decode steps from a
    cache filled from a seeded generator at each of L500_LENS (the SSM
    layers' conv / state drawn too), then a real L500_PREFILL-token prefill
    grown into a L500_BUFFER-deep buffer (its valid entries in both data
    blocks) and W18_DECODE decode steps; each timed.  Then the tree placed
    on ``mesh`` and the same caches (drawn again from the same seeds)
    decoded with the one-device tokens fed, every ``quant_matmul`` launch
    held to plain as it is made: logits within 1e-4 of max with equal
    tokens, each shard's K / V block against its slice of the one-device
    cache; ms a step on the mesh and on one device."""
    arch = get_arch(HYBRID_ARCH)
    cfg = dataclasses.replace(arch.config, n_layers=len(tfm.layer_pattern(arch.config)))
    arch = dataclasses.replace(arch, config=cfg)
    f32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
    qparams = quantize_tree(init_bf16(arch, cfg), lm_policy(8))
    kw = dict(quant=lm_policy(8), serve_optimized=True)
    qdots = 30  # a decode step's quant_matmul launches on one device (phase 17c's)

    def filled(length: int) -> dict:
        caches = tfm.cache_init(f32, 1, L500_DEPTH, device=DEVICE)
        gen = torch.Generator(device=DEVICE).manual_seed(length)
        for c in caches.values():
            for name, t in c.items():
                t.fill_(length) if name == "len" else t.normal_(generator=gen)
        return caches

    def run(dec, caches, cur0: int, toks: list, n_steps: int) -> tuple[list, list]:
        outs, secs = [], []
        for t in range(n_steps):
            cur = torch.full((1,), cur0 + t, dtype=torch.int32, device=DEVICE)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg, _ = dec(qparams, caches, {"tokens": toks[t], "cur_len": cur})
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            outs.append(lg)
            if len(toks) == t + 1:
                toks.append(lg.argmax(-1).to(torch.int32))
        return outs, secs

    long = ShapeSpec("decode", L500_DEPTH, 1, "decode")
    grown_shape = ShapeSpec("decode", L500_BUFFER, 1, "decode")
    start = torch.zeros(1, 1, dtype=torch.int32, device=DEVICE)
    cases = [(f"len {n}", long, n, L500_STEPS) for n in L500_LENS]
    cases.append((f"a {L500_PREFILL}-token prefill in a {L500_BUFFER}-deep buffer", grown_shape, L500_PREFILL,
                  W18_DECODE))
    one = {}
    with torch.no_grad():
        tokens = torch.from_numpy(np.random.default_rng(185).integers(0, cfg.vocab, (1, L500_PREFILL))).to(DEVICE)
        logits, prefilled = build_prefill_step(arch, ShapeSpec("prefill", L500_PREFILL, 1, "prefill"), None, f32,
                                               **kw).jitted(qparams, {"tokens": tokens})
        for name, shape, n, k in cases:
            dec = build_decode_step(arch, shape, None, f32, **kw).jitted
            toks = [logits.argmax(-1).to(torch.int32)] if shape is grown_shape else [start]
            caches = grow_kv(prefilled, L500_BUFFER - L500_PREFILL) if shape is grown_shape else filled(n)
            outs, secs = run(dec, caches, n, toks, k)
            one[name] = dict(outs=outs, secs=secs, toks=toks, caches=caches)
            if shape is long:  # keep the K / V of the attention layer only
                one[name]["caches"] = {p: {x: c[x] for x in ("k", "v")} for p, c in caches.items() if "k" in c}
            del caches
            torch.cuda.empty_cache()
        counts, lines = {}, []
        for name, shape, n, k in cases:
            dec = build_decode_step(arch, shape, mesh, f32, shard_cache_seq=True, **kw).jitted
            caches = grow_kv(prefilled, L500_BUFFER - L500_PREFILL) if shape is grown_shape else filled(n)
            ref = one[name]
            with checked_launches(f"18d {name}", sampled=False) as stats:
                reset_counts()
                outs, secs = run(dec, caches, n, ref["toks"], k)
                dc = read_counts()
            check(dc["quant_matmul"] == qdots * mesh.size * k == stats["quant_matmul"] and dc["flash_attention"] == 0,
                  f"18d {name}: launches {dc} ({stats['quant_matmul']} checked)")
            d_err, d_dec, d_same = 0.0, 0, 0
            for t, (a, b) in enumerate(zip(outs, ref["outs"])):
                e, dd, ss = logits_agree(a, b, f"18d {name} step {t}", MESH17_F32_LOGIT_TOL)
                d_err, d_dec, d_same = max(d_err, e), d_dec + dd, d_same + ss
            kv_err, specs = 0.0, set()
            for p, c in caches.items():
                if "k" in c:
                    specs.add(c["k"].spec)
                    kv_err = max(kv_err, *(block_err(c[x], ref["caches"][p][x]) for x in ("k", "v")))
            check(specs == {(None, None, "data", "model", None)}, f"18d {name}: K / V specs {specs}")
            check(kv_err <= MESH17_F32_CACHE_TOL, f"18d {name}: K / V blocks {kv_err:.3e} of max apart")
            mesh_ms, one_ms = 1e3 * statistics.mean(secs[1:]), 1e3 * statistics.mean(ref["secs"][1:])
            lines.append(
                f"mesh long (18d) {HYBRID_ARCH} one 8-layer group int8 serve_optimized, f32 compute, batch 1, "
                f"{name} ({shape.seq_len}-deep cache, its sequence over data, kv heads over model), on {mesh}: "
                f"{k} decode steps {mesh_ms:.3f} ms a step vs {one_ms:.3f} ms on one device ({mesh_ms / one_ms:.3f}x; "
                f"mean of steps 2-{k}); {d_same}/{k} greedy tokens equal ({d_dec} decided), logits {d_err:.3e} of "
                f"max apart (limit {MESH17_F32_LOGIT_TOL}); each shard's K / V block {kv_err:.3e} of max from its "
                f"slice of one device's; {dc['quant_matmul']} quant_matmul launches within QM_TOL (max_abs_err "
                f"{stats['qm_err']:.3e}); tokens {torch.cat(ref['toks'][1:], dim=1)[0].tolist()}; on {smi}"
            )
            counts = {x: counts.get(x, 0) + dc[x] for x in dc}
            del caches, ref["caches"]
            torch.cuda.empty_cache()
    for line in lines:
        print(line)
    del qparams, prefilled, one
    torch.cuda.empty_cache()
    return counts


def phase_whisper_mesh(smi: str, launches: dict) -> None:
    """Phase 18: whisper-medium over the (2, 2) mesh of four shards of card 0
    (18a-c) and the sequence-sharded decode of long_500k (18d)."""
    t0 = time.perf_counter()
    mesh = card_mesh2(MESH_SHAPE)
    for name, phase in [
        ("mesh_whisper_train", lambda: phase18_whisper_train(mesh, smi)),
        ("mesh_whisper_serve", lambda: whisper_mesh_serve(mesh, W18_SERVE_B, W18_SERVE_S, False, True, "18b", smi)),
        ("mesh_whisper_seq", lambda: whisper_mesh_serve(mesh, 1, LONG_FRAMES, True, False, "18c", smi)),
        ("mesh_long500k", lambda: phase18_long500k(mesh, smi)),
    ]:
        t1 = time.perf_counter()
        counts = phase()
        print(f"launches[{name}]: {counts} ({time.perf_counter() - t1:.3f} s)")
        for k, v in counts.items():
            launches[k] += v
    print(f"phase 18 took {time.perf_counter() - t0:.3f} s; on {smi}")


# ---------------------------------------------------------------------------
# Phase 19: the dry run (launch/dryrun.py) against the card
# ---------------------------------------------------------------------------

DRY_CELL = ("stablelm-1.6b", "decode_32k", "serve_q8")  # 19a: full size, the meta (16, 16) mesh
DRY_OUT = ROOT / "build" / "dryrun_torch"  # its record (git-ignored)
DRY_LAYERS = 2  # 19b-d: stablelm at full width cut to 2 layers
DRY_PREFILL = ShapeSpec("prefill", 4096, 2, "prefill")  # serve_q8: quant_matmul and flash_attention
DRY_TRAIN = ShapeSpec("train", TRAIN_SEQ, TRAIN_BATCH, "train")  # the config's bf16 compute
# 19c: the card's peak allocation over the meta pass's predicted peak, on one
# device.  The caching allocator rounds every block up to 512 B, which the
# meta pass does not: +0.001 MiB of 1827 (prefill) and +0.005 MiB of 13328
# (train) measured on an H100 80GB HBM3 at 700 W; cuBLAS's workspace was
# taken at 19b's first product, before 19c's baseline
DRY_MEM_BAND = (0.999, 1.001)


def dry_step(name: str, mesh_shape, device: str):
    """19b-d's step ``name`` ("prefill" or "train") of stablelm at full width
    and DRY_LAYERS layers on a ``mesh_shape`` mesh of ``device`` repeated."""
    arch = get_arch(LM_ARCH)
    arch = dataclasses.replace(arch, config=dataclasses.replace(arch.config, n_layers=DRY_LAYERS))
    mesh = make_named_mesh(mesh_shape, [device] * (mesh_shape[0] * mesh_shape[1]))
    if name == "prefill":
        return dryrun.build_step(arch, DRY_PREFILL, mesh, variant="serve_q8")
    return dryrun.build_step(arch, DRY_TRAIN, mesh)


def dry_args(name: str, bundle):
    """19b-d's arguments for ``bundle`` (``dry_step``'s): stablelm's init
    from torch.Generator('cuda').manual_seed(19) -- the prefill's bf16 and
    int8 by the serving policy, as phase 16b serves them; the train step's
    f32 with AdamW's state -- and seeded tokens, placed by the bundle's
    specs on its mesh."""
    arch = get_arch(LM_ARCH)
    cfg = dataclasses.replace(arch.config, n_layers=DRY_LAYERS)
    if name == "prefill":
        params = quantize_tree(init_bf16(arch, cfg, seed=19), lm_policy(8))
        gen = torch.Generator(device=DEVICE).manual_seed(19)
        shape = (DRY_PREFILL.global_batch, DRY_PREFILL.seq_len)
        batch = {"tokens": torch.randint(0, cfg.vocab, shape, generator=gen, device=DEVICE, dtype=torch.int32)}
    else:
        params = arch.init_params(torch.Generator(device=DEVICE).manual_seed(19), cfg)
        batch = train_batches(arch, cfg, 1, seed=19)[0]
    if bundle.mesh is not None:
        params = shard_tree(params, bundle.specs[0], bundle.mesh)
        batch = shard_tree(batch, bundle.specs[-1], bundle.mesh)
    if name == "prefill":
        return params, batch
    return params, init_opt_state(adamw(3e-4), params), batch


def phase19_cell(smi: str) -> None:
    """19a: one full-size cell through ``dryrun.run_cell`` on the meta (16,
    16) mesh: the record's per-device peak, FLOPs, wire bytes, dominant
    roofline term and ``fits_hbm`` (predictions from ``HW``)."""
    name, shape, variant = DRY_CELL
    shutil.rmtree(DRY_OUT, ignore_errors=True)
    rec = dryrun.run_cell(name, shape, False, variant=variant, out_dir=DRY_OUT, verbose=False)
    check(rec["status"] == "ok", f"19a: {name} x {shape} x {variant}: {rec.get('error')}")
    check(rec["n_devices"] == 256 and rec["n_groups"] == get_arch(name).config.n_layers, f"19a: {rec['n_devices']}")
    mem, r = rec["memory"], rec["roofline"]
    check(0 < mem["argument_size_in_bytes"] <= mem["peak_memory_in_bytes"] < HW.hbm_bytes, f"19a: memory {mem}")
    check(rec["flops_per_device"] > 0 and rec["wire_bytes_per_device"] > 0, "19a: FLOPs and wire bytes")
    check(rec["kernels"]["quant_matmul"]["calls"] > 0, "19a: no quant_matmul call on the meta pass")
    print(
        f"dry run (19a, a prediction from HW, not a measurement) {name} x {shape} x single "
        f"(16, 16) meta mesh, {variant}: peak {mem['peak_memory_in_bytes'] / 1e9:.3f} GB a device "
        f"(arguments {mem['argument_size_in_bytes'] / 1e9:.3f} GB), fits_hbm {rec['fits_hbm']} "
        f"(structural {rec['capacity_structural']['total'] / 1e9:.3f} GB of {HW.hbm_bytes / 1e9:g}), "
        f"{rec['flops_per_device']:.4e} FLOPs and {rec['wire_bytes_per_device']:.4e} wire bytes a "
        f"device, {rec['kernels']['quant_matmul']['calls']} quant_matmul calls; roofline compute "
        f"{r['compute_s']:.3e} s, memory {r['memory_s']:.3e} s, collective {r['collective_s']:.3e} s, "
        f"dominant {r['dominant']}; the meta pass took {rec['pass_s']} s on the host; on {smi}"
    )


def phase19_counters(smi: str) -> dict:
    """19b and 19d: stablelm at full width and DRY_LAYERS layers on the (2, 2)
    mesh of card 0, the serve_q8 prefill of 2 x 4096 tokens and the bf16
    train step, run for real under the dry run's counters and as a meta
    pass: FLOPs, the collectives by op (counts and wire bytes, backward
    included) and the kernels' reports equal; every ``quant_matmul`` /
    ``flash_attention`` launch held to its plain version at QM_TOL / FA_TOL;
    then each step timed warm beside its ``roofline_terms``."""
    counts_all = collections.Counter()
    for name in ("prefill", "train"):
        card, meta = dry_step(name, MESH_SHAPE, DEVICE), dry_step(name, MESH_SHAPE, "meta")
        args = dry_args(name, card)
        with recorded_quant_matmul() as seen_qm, recorded_flash_attention() as seen_fa:
            reset_counts()
            real = dryrun.run_pass(card, args)
            counts = read_counts()
        del args
        pred = dryrun.run_pass(meta)
        check(real["flops"] == pred["flops"] > 0, f"19b {name}: FLOPs {real['flops']} on the card, {pred['flops']} predicted")
        check(real["collectives"].summary() == pred["collectives"].summary(),
              f"19b {name}: collectives {real['collectives'].summary()} vs {pred['collectives'].summary()}")
        check(real["backward_collectives"] == pred["backward_collectives"], f"19b {name}: backward collectives")
        check(real["kernels"] == pred["kernels"], f"19b {name}: kernels {real['kernels']} vs {pred['kernels']}")
        for k in ("quant_matmul", "flash_attention"):
            check(counts[k] == real["kernels"].get(k, {}).get("calls", 0), f"19b {name}: {k} launches {counts}")
        check(len(seen_qm) == counts["quant_matmul"] and len(seen_fa) == counts["flash_attention"],
              f"19b {name}: recorded launches")
        if name == "prefill":
            check(counts["quant_matmul"] > 0 and counts["flash_attention"] > 0, f"19b prefill: launches {counts}")
        else:
            check(sum(counts.values()) == 0 and real["backward_collectives"]["n_ops"] > 0, f"19b train: {counts}")
        qm_err = check_recorded_qm(seen_qm, f"19b {name}") if seen_qm else 0.0
        fa_err = check_recorded_fa(seen_fa, f"19b {name}")[0] if seen_fa else 0.0
        del seen_qm, seen_fa
        counts_all.update(counts)
        coll = real["collectives"].summary()
        by_op = {op: v["count"] for op, v in coll["by_op"].items()}
        print(
            f"dry run (19b) {LM_ARCH} full width, {DRY_LAYERS} layers, {name} on (2, 2) shards of card 0: "
            f"the card's run == the meta pass: {real['flops']:.6e} FLOPs, collectives {by_op} "
            f"({coll['wire_bytes_per_device']:.6e} wire bytes a device; backward "
            f"{real['backward_collectives']['n_ops']}), kernels "
            f"{ {k: v['calls'] for k, v in real['kernels'].items()} }; launches {dict(counts)} each "
            f"within tolerance of plain (quant_matmul {qm_err:.3e}, flash_attention {fa_err:.3e}); "
            f"on {smi}"
        )
        # 19d: the same step warm, beside its bound from HW (the card runs
        # all four shards, so the totals; its collectives are copies in HBM)
        args = dry_args(name, card)
        if name == "train":
            state = list(args)

            def fn():
                state[0], state[1], _ = card.jitted(*state)
        else:
            def fn():
                card.jitted(*args)
        wall, busy, _ = profiled(fn, 3)
        del args, fn
        torch.cuda.empty_cache()
        wire = real["collectives"].per_device_wire_bytes * real["n_shards"]
        t = roofline_terms(real["flops"], real["bytes"], wire, HW)
        bound_ms = 1e3 * t["roofline_bound_s"]
        print(
            f"dry run (19d) {name}: wall {wall:.3f} ms, device busy {busy:.3f} ms a step (warm); "
            f"roofline from HW over the four shards' totals ({real['flops']:.4e} FLOPs, "
            f"{real['bytes']:.4e} operand + result bytes unfused, {wire:.4e} wire bytes): compute "
            f"{1e3 * t['compute_s']:.3f} ms, memory {1e3 * t['memory_s']:.3f} ms, collective "
            f"{1e3 * t['collective_s']:.3f} ms, dominant {t['dominant']}; the card reaches "
            f"{bound_ms / wall:.4f} of the bound by the wall, {bound_ms / busy:.4f} by the busy "
            f"time; on {smi}"
        )
    return dict(counts_all)


def phase19_memory(smi: str) -> None:
    """19c: on one device, the meta pass's predicted peak against
    ``torch.cuda.max_memory_allocated()`` for 19b's prefill and train step,
    within DRY_MEM_BAND."""
    for name in ("prefill", "train"):
        pred = dryrun.run_pass(dry_step(name, (1, 1), "meta"))["memory"]
        card = dry_step(name, (1, 1), DEVICE)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        m0 = torch.cuda.memory_allocated()
        args = dry_args(name, card)
        torch.cuda.synchronize()
        arg_bytes = torch.cuda.memory_allocated() - m0
        torch.cuda.reset_peak_memory_stats()
        out = card.jitted(*args)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - m0
        del args, out
        torch.cuda.empty_cache()
        ratio = peak / pred["peak_memory_in_bytes"]
        check(DRY_MEM_BAND[0] <= ratio <= DRY_MEM_BAND[1],
              f"19c {name}: the card's peak {peak} B over the predicted {pred['peak_memory_in_bytes']} B "
              f"= {ratio:.4f}, outside {DRY_MEM_BAND}")
        print(
            f"dry run (19c) {name} on one device: predicted peak {pred['peak_memory_in_bytes'] / 2**20:.3f} "
            f"MiB (arguments {pred['argument_size_in_bytes'] / 2**20:.3f}), the card's "
            f"max_memory_allocated {peak / 2**20:.3f} MiB (arguments {arg_bytes / 2**20:.3f}): "
            f"{ratio:.4f} of the prediction (band {DRY_MEM_BAND}); on {smi}"
        )


def phase_dryrun(smi: str, launches: dict) -> None:
    """Phase 19: the dry run's full-size cell (19a), its counters against a
    real run on the (2, 2) mesh of card 0 (19b, with 19d's timing) and its
    memory against the card's allocator on one device (19c)."""
    t0 = time.perf_counter()
    phase19_cell(smi)
    t1 = time.perf_counter()
    counts = phase19_counters(smi)
    print(f"launches[dryrun]: {counts} (19a {t1 - t0:.3f} s, 19b-d {time.perf_counter() - t1:.3f} s)")
    for k, v in counts.items():
        launches[k] += v
    phase19_memory(smi)
    print(f"phase 19 took {time.perf_counter() - t0:.3f} s; on {smi}")


# ---------------------------------------------------------------------------
# Phase 20: the examples and the chaos smoke
# ---------------------------------------------------------------------------

EXAMPLES_DIR = ROOT / "build" / "phase20"  # the DSE package and the LM run (git-ignored)
EX_LM_STEPS = 300  # examples/lm_train_100m.py's default; its failure at half of it
EX_SLICE = 64  # the quickstart's test samples run card vs CPU


def on_cpu(qparams) -> list:
    return [IntLayerParams(*(t.cpu() for t in p)) for p in qparams]


def ex_quickstart_checks(entry: dict) -> str:
    """64 test samples through the event backend on the card == the CPU's
    reference run (phase 10 held the printed accuracy to ``eval_int(
    reference)`` of the same qparams on the card)."""
    out = entry["out"]
    net, qparams, test = out["net"], out["qparams"], out["test"]
    x = test.spikes[:EX_SLICE].transpose(1, 0, 2)
    card = run_int(net, qparams, raster_tensor(x, DEVICE), backend="event")
    assert_records_equal(card, run_int(net, on_cpu(qparams), raster_tensor(x, "cpu")),
                         "quickstart card vs CPU")
    check(entry["launches"]["sparse_accum"] > 0, "quickstart launched no sparse_accum")
    return (f"accuracy {out['accuracy']:.6f} (== eval_int(reference), phase 10); {EX_SLICE} "
            f"samples card (event) == CPU (reference); train {out['train_s']:.3f} s, event "
            f"evaluation {out['eval_s']:.3f} s")


def ex_serve_checks(out: dict, counts: dict) -> str:
    done = out["done"]
    check(len(done) == 11 and not out["mismatches"],
          f"serve_snn: {len(done)} served, mismatches {out['mismatches']}")
    check(counts["sparse_accum"] > 0, "serve_snn launched no sparse_accum")
    routes = collections.Counter(r.route for r in done)
    return f"11 / 11 bit-exact with serial run_int; routes {dict(routes)}"


def ex_dse_checks(found: dict, counts: dict) -> str:
    """The package reloads; ``run_int`` of its weight tables (with the run's
    recurrent registers and thresholds, which the package does not carry) on
    its encoded sample gives the same records on the card and the CPU."""
    out = found["out"]
    design = json.loads((out / "design.json").read_text())
    net, qparams = found["deploy_net"], found["deploy_qparams"]
    check(design == ex_dse.design(net), "flexplorer: design.json differs from the deployed net")
    weights = np.load(out / "weights_q.npz")
    sample = np.load(out / "encoded_sample.npy")
    check(sorted(weights.files) == [f"layer{i}_wff" for i in range(len(qparams))]
          and all(weights[f].dtype == np.int32 for f in weights.files)
          and sample.dtype == np.uint8 and sample.shape[0] == 16,
          f"flexplorer: package arrays {weights.files}, sample {sample.dtype} {sample.shape}")
    arrays = [(weights[f"layer{i}_wff"], q.w_rec.cpu().numpy(), q.theta_q.cpu().numpy())
              for i, q in enumerate(qparams)]
    x = sample.transpose(1, 0, 2)
    card = run_int(net, int_params_from_numpy(net, arrays, DEVICE), raster_tensor(x, DEVICE))
    cpu = run_int(net, int_params_from_numpy(net, arrays, "cpu"), raster_tensor(x, "cpu"))
    assert_records_equal(card, cpu, "flexplorer package card vs CPU")
    for k in ("spike_matmul", "lif_scan"):
        check(counts[k] > 0, f"flexplorer_dse launched no {k}")
    res = found["result"]
    return (f"{len(res.search.cache)} candidates scored, deployed "
            f"{[lc.w_bits for lc in net.layers]} ff bits "
            f"({'refined' if found['deployed_refined'] else 'annealer incumbent'}); package "
            f"reloaded, its sample card == CPU; train {found['train_s']:.3f} s, search and "
            f"refine {found['explore_s']:.3f} s")


def ex_quantized_checks(out: dict, counts: dict, seen: list) -> str:
    check(counts["quant_matmul"] > 0, "serve_quantized launched no quant_matmul")
    err = check_recorded_qm(seen, "serve_quantized")
    arch, shape = get_arch(ex_quantized.ARCH), SHAPES["decode_32k"]
    for label, bits in (("bf16/f32", None), ("int8", 8), ("int4", 4)):
        want = structural.structural_bytes(arch, shape, quant_bits=bits)["total"]
        check(out["traffic"][label]["bytes"] == want,
              f"serve_quantized {label}: structural bytes {out['traffic'][label]} != {want}")
    walls = {k: round(v[1], 3) for k, v in out["results"].items()}
    return (f"{len(seen)} quant_matmul launches within QM_TOL of plain (max abs err {err:.3e}); "
            f"structural bytes == the CPU's; greedy agreement {out['agree']} / 3; walls {walls} s")


def ex_lm_checks(out: dict, steps: int) -> str:
    check(out["failures"] == 1 and out["final_step"] == steps,
          f"lm_train_100m: failures {out['failures']}, final step {out['final_step']}")
    check(math.isfinite(out["final_loss"]) and out["final_loss"] < out["first_loss"],
          f"lm_train_100m: loss {out['first_loss']} -> {out['final_loss']}")
    return (f"{steps} steps (failure injected at {steps // 2}, one recovered), loss "
            f"{out['first_loss']:.6f} -> {out['final_loss']:.6f}, {out['wall_s']:.3f} s")


def ex_chaos(chaos) -> dict:
    """scripts/chaos_smoke_torch.py's ``smoke`` on the card, stage by stage
    with its ``main``'s weights, seed and request count, so that the
    supervised engine's launches are read apart from those of the serial
    replays that judge it (its oracle)."""
    dev = torch.device(DEVICE)
    qparams, rasters = chaos.deployed(0, dev), chaos.request_rasters(0, 12)
    with tempfile.TemporaryDirectory(prefix="neura-chaos-wal-") as wal:
        completed, sup, inj = chaos.serve_through_faults(qparams, rasters, dev, wal)
    torch.cuda.synchronize()
    engine = kernels.launch_counts()
    chaos.check_bit_exact(qparams, rasters, completed, dev)
    ticks = {k: v for k, v in sup.metrics.counters.items() if k.startswith("tick:")}
    return dict(n=len(completed), faults=len(inj.fired), ticks=ticks, engine=engine)


def ex_chaos_checks(out: dict, counts: dict) -> str:
    """Nothing lost or served twice, every request bit-exact with serial
    ``run_int`` (raised by the stages); every tick of the engine on the
    f32_exact route, as JAX's engine takes for these rasters, so the
    engine launches no SNN kernel; the oracle's replays launch
    ``spike_matmul``."""
    engine = out["engine"]
    oracle = {k: counts[k] - engine[k] for k in counts}
    check(out["n"] == 12 and out["faults"] == 3,
          f"chaos smoke: {out['n']} served through {out['faults']} faults")
    check(set(out["ticks"]) == {"tick:f32_exact"},
          f"chaos smoke: the engine's ticks by route {out['ticks']}, not all f32_exact")
    check(not any(engine.values()), f"chaos smoke: the engine launched {engine}")
    check(oracle["spike_matmul"] > 0, "chaos smoke: the serial replays launched no spike_matmul")
    return (f"12 / 12 bit-exact through 3 faults, nothing lost or served twice; the engine's "
            f"ticks by route {out['ticks']}, its launches {engine}; the oracle's (serial "
            f"run_int) launches {oracle}")


def phase_examples(smi: str, launches: dict, examples: dict) -> None:
    """Each ported example's ``main`` on the card at the JAX example's own
    sizes, then the chaos smoke: the launches of each (the quickstart's
    counted in phase 10, which drove it) and its checks."""
    t_phase = time.perf_counter()
    shutil.rmtree(EXAMPLES_DIR, ignore_errors=True)
    qs = examples["quickstart"]
    print(f"examples: quickstart (driven in phase 10) {qs['wall']:.3f} s, launches "
          f"{qs['launches']}: {ex_quickstart_checks(qs)}; on {smi}")
    chaos = load_chaos_smoke()
    seen_qm: list = []

    def quantized():
        with recorded_quant_matmul() as seen:
            out = ex_quantized.main([])
        seen_qm.extend(seen)
        return out

    runs = [
        ("serve_snn", lambda: ex_serve.main([]), lambda out, c: ex_serve_checks(out, c)),
        ("flexplorer_dse",
         lambda: ex_dse.main(["--out", str(EXAMPLES_DIR / "flexplorer_pkg")]),
         lambda out, c: ex_dse_checks(out, c)),
        ("serve_quantized", quantized, lambda out, c: ex_quantized_checks(out, c, seen_qm)),
        ("lm_train_100m",
         lambda: ex_lm.main(["--steps", str(EX_LM_STEPS), "--run-dir",
                             str(EXAMPLES_DIR / "lm100m")]),
         lambda out, c: ex_lm_checks(out, EX_LM_STEPS)),
        ("chaos_smoke", lambda: ex_chaos(chaos), ex_chaos_checks),
    ]
    for name, run, checks in runs:
        reset_counts()
        with launch_sizes() as tally:
            t0 = time.perf_counter()
            out = run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = read_counts()
        for k, v in counts.items():
            launches[k] += v
        by_shape = {f"{k}{list(v)}": n for (k, v), n in sorted(tally.items())}
        said = checks(out, counts)
        print(f"examples: {name} {wall:.3f} s, launches {counts} (by size "
              f"{json.dumps(by_shape)}): {said}; on {smi}")
    shutil.rmtree(EXAMPLES_DIR, ignore_errors=True)
    print(f"phase 20 took {time.perf_counter() - t_phase:.3f} s; on {smi}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one NVIDIA card", file=sys.stderr)
        return 2
    smi = device_label(DEVICE)
    print(smi)
    t_start = time.perf_counter()
    # the certified f32 lowering and the LM's f32 logits head need full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    t0 = time.perf_counter()
    nvcc_s = build.load_all()
    print(
        f"build: {nvcc_s:.2f} s nvcc ({len(build.KERNELS)} sources in parallel), "
        f"{time.perf_counter() - t0:.2f} s to load; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}"
    )

    net = NetworkConfig(
        layers=(
            LayerConfig(n_in=256, n_out=128, neuron=NeuronModel.LIF, w_bits=6, u_bits=16),
            LayerConfig(n_in=128, n_out=10, neuron=NeuronModel.LIF, w_bits=6, u_bits=16),
        ),
        n_steps=25,
        name="mnist-256-128-10",
    )
    params_cpu = init_float_params(torch.Generator().manual_seed(0), net, device="cpu")
    params = init_float_params(torch.Generator().manual_seed(0), net)
    qparams_cpu, _ = quantize_params(net, params_cpu)
    qparams, scales = quantize_params(net, params)
    for a, b in zip(qparams, qparams_cpu):
        check(all(torch.equal(x.cpu(), y) for x, y in zip(a, b)), "quantize_params card vs CPU")
    print(
        f"model: {net.name} LIF w6/u16 T=25, scales {scales}, "
        f"theta_q {[int(p.theta_q) for p in qparams]}"
    )

    arch = get_arch(LM_ARCH)
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    rows = [
        check_spike_matmul(gen, [p.w_ff for p in qparams]),
        check_lif_scan(gen),
        check_sparse_accum(gen, qparams[0].w_ff),
        check_quant_matmul(gen, arch.config.n_layers),
        check_flash_attention(gen, arch.config.n_layers),
    ]
    for r in rows:
        how = "bit-identical to" if r["max_abs_err"] == 0 else "within the bf16 tolerance of"
        print(
            f"kernel {r['name']} {r['shape']}: {how} plain (max_abs_err "
            f"{r['max_abs_err']}); {r['ms']:.5f} ms, plain {r['plain_ms']:.5f} ms, "
            f"library {r['library_ms']}, bound {r['bound_ms']:.5f} ms ({r['bound_by']})"
        )

    t0 = time.perf_counter()
    lm_params = arch.init_params(torch.Generator(device=DEVICE).manual_seed(0))
    lm_int8 = quantize_tree(lm_params, lm_policy(8))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for _, t in tree_leaves(lm_params))
    print(
        f"lm model: {arch.name} at full width ({arch.config.n_layers} layers, d_model "
        f"{arch.config.d_model}, vocab {arch.config.vocab}), {n_params} f32 parameters from "
        f"torch.Generator('cuda').manual_seed(0), int8 block weights; "
        f"{time.perf_counter() - t0:.2f} s"
    )

    launches = dict.fromkeys(build.KERNELS, 0)
    lm_qdots = QDOTS_PER_LAYER * arch.config.n_layers
    serve_results: dict = {}
    for name, phase in [
        ("run_int", lambda: phase_run_int(net, qparams, qparams_cpu)),
        ("eval_int", lambda: phase_eval_int(net, qparams)),
        ("serve", lambda: phase_serve(net, qparams, serve_results)),
        ("lm_decode_int8", lambda: phase_lm_decode(arch, lm_params, 8, 16, 16, lm_qdots)),
        ("lm_decode_int4", lambda: phase_lm_decode(arch, lm_params, 4, 4, 8, lm_qdots)),
        ("lm_prefill", lambda: phase_lm_prefill(arch, lm_int8)),
    ]:
        # each phase reads the counts right after driving the main path,
        # before its own checks launch anything
        reset_counts()
        with launch_sizes() as tally:
            counts = phase()
        print(f"launches[{name}]: {counts}")
        if tally:
            by_shape = {f"{k}{list(v)}": n for (k, v), n in sorted(tally.items())}
            print(f"launches by size[{name}] (the launches counted above): {json.dumps(by_shape)}")
        for k, v in counts.items():
            launches[k] += v
    del lm_params, lm_int8
    torch.cuda.empty_cache()
    phase_lm_card_vs_cpu(arch)

    t0 = time.perf_counter()
    found: dict = {}
    dse = dse_setup()
    examples: dict = {}
    for name, phase in [
        ("dse", lambda: phase_dse(dse, found)),
        ("dse_refine", lambda: phase_dse_refine(dse)),
        ("train", lambda: phase_train(examples)),
    ]:
        reset_counts()
        with launch_sizes() as tally:
            counts = phase()
        print(f"launches[{name}]: {counts}")
        by_shape = {f"{k}{list(v)}": n for (k, v), n in sorted(tally.items())}
        print(f"launches by size[{name}] (the launches counted above): {json.dumps(by_shape)}")
        for k, v in counts.items():
            launches[k] += v
    print(f"phases 9-10 took {time.perf_counter() - t0:.3f} s; the script so far "
          f"{time.perf_counter() - t_start:.3f} s")

    t0 = time.perf_counter()
    front: dict = {}
    for name, phase in [
        ("streams", lambda: phase_streams(net, qparams, front)),
        ("stream_churn", lambda: phase_stream_churn(net, qparams, front)),
        ("journal", lambda: phase_journal(net, qparams, serve_results)),
        ("chaos", lambda: phase_chaos(net, qparams)),
        ("http", lambda: phase_http(net, qparams)),
        ("launcher", lambda: phase_launcher()),
    ]:
        reset_counts()
        with launch_sizes() as tally:
            counts = phase()
        print(f"launches[{name}]: {counts}")
        by_shape = {f"{k}{list(v)}": n for (k, v), n in sorted(tally.items())}
        print(f"launches by size[{name}] (the launches counted above): {json.dumps(by_shape)}")
        if name == "streams":
            for k in ("spike_matmul", "sparse_accum"):
                check(counts[k] > 0, f"phase 11: {k} was not launched by the streams")
        for k, v in counts.items():
            launches[k] += v
    print(f"phase 11 took {time.perf_counter() - t0:.3f} s; the script so far "
          f"{time.perf_counter() - t_start:.3f} s")

    t0 = time.perf_counter()
    for name, phase in [
        ("shard_eval_int", lambda: phase_shard_eval_int(net, qparams, smi)),
        ("shard_batched", lambda: phase_shard_batched(net, qparams)),
        ("shard_sweep", lambda: phase_shard_sweep(dse, smi)),
        ("shard_dse", lambda: phase_shard_dse(dse, found)),
        ("shard_serve", lambda: phase_shard_serve(net, qparams, serve_results, smi)),
    ]:
        reset_counts()
        with launch_sizes() as tally:
            counts = phase()
        print(f"launches[{name}]: {counts}")
        by_shape = {f"{k}{list(v)}": n for (k, v), n in sorted(tally.items())}
        print(f"launches by size[{name}] (the launches counted above): {json.dumps(by_shape)}")
        for k, v in counts.items():
            launches[k] += v
    phase_shard_cards(net, qparams)
    print(f"phase 12 took {time.perf_counter() - t0:.3f} s; the script so far "
          f"{time.perf_counter() - t_start:.3f} s")

    t0 = time.perf_counter()
    for name, phase in [
        ("lm_train_stablelm", lambda: phase_lm_train_full("stablelm-1.6b", smi)),
        ("lm_train_granite", lambda: phase_lm_train_full("granite-moe-1b-a400m", smi)),
        ("lm_train_loop", lambda: phase_lm_train_loop(smi)),
        ("lm_serve_moe", lambda: phase_lm_serve_moe(smi)),
    ]:
        reset_counts()
        counts = phase()
        print(f"launches[{name}]: {counts}")
        for k, v in counts.items():
            launches[k] += v
    phase_lm_train_card_vs_cpu()
    print(f"phase 13 took {time.perf_counter() - t0:.3f} s; the script so far "
          f"{time.perf_counter() - t_start:.3f} s")

    t0 = time.perf_counter()
    ssm = get_arch(SSM_ARCH)
    ssm_params = ssm.init_params(torch.Generator(device=DEVICE).manual_seed(0))
    ssm_int8 = quantize_tree(ssm_params, lm_policy(8))
    ssm_qdots = 2 * ssm.config.n_layers  # in_proj, out_proj
    print(
        f"ssm model: {ssm.name} at full width ({ssm.config.n_layers} layers, d_model "
        f"{ssm.config.d_model}, d_state {ssm.config.ssm.d_state}, {ssm.config.ssm.n_heads} heads), "
        f"{sum(t.numel() for _, t in tree_leaves(ssm_params))} f32 parameters; on {smi}"
    )
    for name, phase in [
        ("ssm_decode_int8", lambda: phase_lm_decode(ssm, ssm_params, 8, 16, 8, ssm_qdots,
                                                    check_plain=True, max_prompt=SHORT_PROMPT,
                                                    smi=smi)),
        ("ssm_decode_int4", lambda: phase_lm_decode(ssm, ssm_params, 4, 4, 8, ssm_qdots,
                                                    check_plain=True, max_prompt=SHORT_PROMPT,
                                                    smi=smi)),
        ("ssm_prefill", lambda: phase_ssm_prefill(ssm, ssm_int8, smi)),
    ]:
        reset_counts()
        t1 = time.perf_counter()
        counts = phase()
        print(f"launches[{name}]: {counts} ({time.perf_counter() - t1:.3f} s)")
        for k, v in counts.items():
            launches[k] += v
    t1 = time.perf_counter()
    phase_ssm_prefill_vs_decode(ssm, ssm_params, smi)
    print(f"ssm prefill vs decode took {time.perf_counter() - t1:.3f} s")
    del ssm_params, ssm_int8
    torch.cuda.empty_cache()
    for name, phase in [
        ("ssm_train", lambda: phase_lm_train_full(SSM_ARCH, smi)),
        ("hybrid", lambda: phase_hybrid(smi)),
        ("vlm", lambda: phase_vlm(smi)),
        ("vlm_train", lambda: phase_lm_train_full(VLM_ARCH, smi)),
    ]:
        reset_counts()
        t1 = time.perf_counter()
        counts = phase()
        print(f"launches[{name}]: {counts} ({time.perf_counter() - t1:.3f} s)")
        for k, v in counts.items():
            launches[k] += v
    t1 = time.perf_counter()
    phase_lm_train_card_vs_cpu((SSM_ARCH, HYBRID_ARCH, VLM_ARCH))
    print(f"14e card vs CPU took {time.perf_counter() - t1:.3f} s")
    print(f"phase 14 took {time.perf_counter() - t0:.3f} s; the script so far "
          f"{time.perf_counter() - t_start:.3f} s")

    phase_whisper(smi, launches)
    print(f"the script so far {time.perf_counter() - t_start:.3f} s")

    phase_mesh(smi, launches)
    print(f"the script so far {time.perf_counter() - t_start:.3f} s")

    phase_mesh_families(smi, launches)
    print(f"the script so far {time.perf_counter() - t_start:.3f} s")

    phase_whisper_mesh(smi, launches)
    print(f"the script so far {time.perf_counter() - t_start:.3f} s")

    phase_dryrun(smi, launches)
    print(f"the script so far {time.perf_counter() - t_start:.3f} s")

    phase_examples(smi, launches, examples)
    print(f"the script so far {time.perf_counter() - t_start:.3f} s")

    for k, v in launches.items():
        check(v > 0, f"kernel {k} was never launched on the main path")

    line = {
        "kernels": [
            {
                "name": r["name"],
                "route": "cuda",
                "source": f"src/repro_torch/csrc/{r['name']}.cu",
                "replaces": r["replaces"],
                "launches": launches[r["name"]],
                "max_abs_err": r["max_abs_err"],
                "ms": r["ms"],
                "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"],
                "library_ms": r["library_ms"],
            }
            for r in rows
        ]
    }
    print(json.dumps(line))
    device = {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
