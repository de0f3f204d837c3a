"""Smoke run of omnia_tpu_torch on one NVIDIA card.

    python3 chip_smoke.py

Phases, each failing loudly (exit code != 0, no result line):

1. Device line: torch / CUDA / nvcc / Triton versions and the card's
   name and power limit. Exits 2 when torch.cuda.is_available() is false.
2. Kernel build: every source under omnia_tpu_torch/csrc, one nvcc each,
   all started together; ptxas's registers, spills and shared memory.
3. Kernel vs plain: the four decode-attention kernels (K1 contiguous, K2
   int8, K3 paged, K4 paged int8) against their plain PyTorch versions
   at the llama3-8b and llama3-1b decode shapes, q in bf16 and f32, and
   at the llama3-70b decode shape (G = 8), q in bf16, and at the shapes
   one rank of a tensor-parallel engine runs (phase 14: llama3-8b at
   tp = 2 and 4, Hkv 4 and 2; llama3-70b at tp = 4, Hkv 2), q in bf16, with
   every cache row past a position, every free page and the trash page
   poisoned (NaN, or 127 in int8 rows); K3 must equal K1 and K4 equal
   K2 bit for bit over the same rows. Kernel, plain and (K1) library-call
   times, in three rounds taken in turns, beside the bandwidth bound and
   the kernel's share of it.
4. Reference: on a small model the card's forward (kernel route) and the
   CPU's (plain route) give the same logits from the same weights, over
   a contiguous cache and over an int8 paged one, and with int8 weights
   in each mode; the W8A8 product (torch._int_mm, exact int32 sums) on
   the card equals its CPU route bit for bit at f32 and bf16 activations
   (1, 8 and 17 rows, llama3-8b and llama3-70b MLP widths), and the W8A16
   one agrees within one rounding of the activation dtype.
5. Engines at full llama3-8b width, cut to its first 16 of 32 layers
   (CUT_LAYERS; bf16, a view of random seeded weights whose whole depth
   phase 12 serves; the cut keeps every check of phases 5, 6, 8 and 9,
   which hold per layer, and makes room for phases 12 and 14 in the
   script's time): the default config (K1) and the slice's
   main path, int8 + paged (K4), serve a 12-request burst through
   submit(); int8 (K2) and paged (K3) serve a shorter one. Every kernel
   launch count is set to 0 just before each run and read just after
   (a wrapper counts its launch; a launch inside a captured graph, whose
   replays run no Python, counts itself on the card: phase 12):
   the run's own kernel must have launched num_layers x decode steps
   times and no other. Paged engines end with every page free. A traced
   window of K1's and K4's engines counts the device kernels of the
   decode-attention body: one launch per layer and decode step, and no
   combine kernel. Then the same greedy requests, stepped inline, give the
   same tokens on the paged engine as on the contiguous one at each KV
   precision.
6. Sessions, on each of the four engines after its burst: 16 sessions on
   8 slots, 3 greedy turns of 16 tokens each, every turn after the first
   the previous prompt, its reply and 40–150 new tokens (one session
   reaches 1002 rows, so that its last extend runs single-token pieces,
   which launch the decode kernel with B = 1 on a one-slot view). Every
   turn must end STOP/LENGTH; sessions must be offloaded to host and
   restored; the reused and prefilled tokens must equal what the script
   implies; the engine's kernel must launch num_layers x (decode steps +
   single-token pieces) times and no other; one session's turn 2, served
   again after export_session -> import_session on the stopped engine,
   must give the tokens of its resident replay; the paged engines'
   session tokens must equal the contiguous ones' at each precision; and
   every page must be free once every session is released. Phase 3 also
   holds each kernel's B = 1 call on one slot of the 8-slot cache against
   its plain version and against row b of the B = 8 call, bit for bit.

7. int8 weights at full width. (a) Each mode's product and the bf16
   torch.matmul timed at 8 and 1024 rows for the llama3-8b and
   llama3-70b projection shapes, beside the int8 weight-byte bound. (b)
   llama3-70b, all 80 layers at full width, with W8A16 weights born
   quantized on the card (the bf16 model would not fit), the default
   contiguous bf16 KV cache (K1), 8 slots, max_seq 1024: its params'
   device bytes against the reckoned count, the first prefill's logits
   finite, the 12-request burst served with exactly 80 K1 launches per
   decode step. (c) llama3-8b with W8A8 weights, the int8 KV cache and
   the paged one (K4) serves the burst with exactly 32 K4 launches per
   decode step, and its greedy tokens equal those of a contiguous int8-KV
   engine (K2) on the same weights. (d) The provider path: a llama3-1b-
   width checkpoint cut to 2 layers, written by the port's save_params,
   built by runtime.providers.build_engine with quant="int8" (quantized
   in the loader, layer by layer), gives the int8 tree and the greedy
   tokens of an engine that quantized the same params in memory.

8. Agent traffic on the llama3-8b bf16 weights of phase 5, full width
   cut to its first 16 layers as there, three engines of 8 slots, max_seq 1024, a shared-prefix
   pool of 4 entries and grammars of up to 512 states: (a) the default
   contiguous bf16 cache (K1), (b) int8 + paged (K4; 140 pages of 64
   rows, the slots' 8 x 1024 rows and the block's 11 pages), (c)
   contiguous int8 (K2). A 650-token system block is registered with register_prefix;
   session 1's first turn prefills it and publishes it, then 16 sessions
   send 3 turns each from their own threads, each turn the block, the
   session's history and 16–48 new tokens. Every second turn is
   constrained by a tool-call JSON schema (enums and booleans, a finite
   language) compiled by the port's compiler over its byte tokenizer;
   even sessions are greedy, odd ones sampled; (c) runs the greedy
   sessions only. Checks: the pool's hit tokens equal 650 per seeded
   first turn; (b) copies shared pages on write; each engine's kernel
   launches num_layers x (decode steps + single-token pieces) times and
   no other; every grammared token is admissible from the FSM's state
   and every grammared turn that stops parses and names an enum member;
   (b)'s greedy tokens equal (c)'s. Prints each engine's prefill tokens
   saved, TTFT and placement of the seeded first turns against session
   1's, and the grammar tables' device bytes, and times one decode window
   (8 greedy requests, no grammar) on (a) and on an engine built without
   grammars, three times each in turns.

9. Stall-free batching and speculative decoding on the same llama3-8b
   bf16 weights, at full width, cut to 16 layers as in phase 5, on the
   contiguous bf16 cache
   (K1) and the int8 + paged one (K4), 8 slots, max_seq 1024: per cache
   three engines, both knobs on (prefill_chunk_tokens=256, spec_decode=4,
   spec_decode_max=8, spec_gate_window=0), the interleave alone, and
   neither, all with grammars of up to 128 states. (a) Arrivals: 6 greedy
   decoders (each turn 2 of a session, so that its rows do not depend on
   the arm) decode 128 tokens; after their first chunk two 900-token
   prompts arrive, once interleaved and once prefill-first: the
   decoders' largest and p99 delivery gap and tokens/s over the arrival
   window, the arrivals' TTFT; interleaved_prefill_tokens must be exactly
   the arrivals' 1,800 and the decoders' tokens equal across arms. (b)
   Repetition: 8 requests whose prompts repeat a span 8 times (6 greedy
   tool calls under phase 8's schema, 2 sampled) with spec on and off:
   proposals, acceptances, verify steps, tokens per verify step, host ms
   per verify step, tokens/s, the verify window's plain attention per
   layer; spec_accepted > 0 and the sampled tokens equal; greedy tokens
   agreeing at bf16 and the admissible top-2 margin where they part. (c)
   Fused: a 900-token arrival during the repetition must ride at least
   one mixed step that carries a verify window. Each kernel must launch
   num_layers x decode steps times over the phase and no other. Then at
   llama3-1b width, 4 layers, f32: interleaved == monolithic placement
   and spec on == spec off greedy tokens on both caches (on the int8 one
   with buckets up to 256, so that every prompt extends on both arms: a
   fresh prefill there attends its float chunk, a piece the quantized
   rows).

10. Mixtral MoE, after phase 7 (every llama weight freed). (a) One MoE
   layer at Mixtral width (D 4096, F 14336, E 8, K 2) on the card
   against the CPU on the same inputs, at 8 rows (all experts) and 1024
   (capacity dispatch) with a skewed router that drops assignments: at
   f32 (TF32 off) equal routing and kept assignments and outputs within
   1e-4 of the largest; at bf16 equal routing where no tie lies within a
   bf16 step, outputs within 2^-6 of the largest. (b) mixtral-8x7b at
   full width cut to 16 of its 32 layers (the bf16 model is 93.41 GB;
   24 layers, 70.19 GB, fit too, and ran until the script's time had to
   make room for phase 15), bf16 random seeded weights drawn on the
   card: params' device bytes equal to the reckoned 46,964,940,800, the
   first prefill's logits
   finite, the 12-request burst on the default engine (K1; then a traced
   decode window) and on the int8 + paged one (K4), each kernel
   launching exactly 16 x decode steps, beside the step's weight-read
   bound. (c) The 8 inline greedy requests give the same tokens on a
   paged bf16 engine (K3, 16 x decode steps launches) as on (b)'s
   contiguous one, and every page ends free. (d) A 1-layer Mixtral-width
   checkpoint written by save_params and built by build_engine gives
   the in-memory tree bit for bit and the same greedy tokens.

11. The operations layer, after phase 10 (every earlier weight freed),
   on llama3-8b at full width cut to its first 8 of 32 layers
   (OPS_LAYERS, to make room for phases 14 and 15) started from a
   checkpoint: random seeded bf16 weights drawn on the card and written
   by save_params (5,591,146,496 bytes; the phase fails unless the disk has
   20 GB free), then read back from the page cache by build_engine with
   flight_events=4096 and watchdog_s=2.0. (a) Two cold starts as the
   runtime's bring-up makes them (a ColdStartTracker, backend_init begun,
   build_engine(coldstart=), warmup(), start(), mark_ready()), with
   warmup_threads 0 and then 2, each building K1's library anew into an
   empty build directory, as a host that never built it does: each
   phase's seconds, submit-to-ready and the kernel build's seconds; the
   weights' bytes loaded, their total and the params' device bytes all
   equal to the reckoned count; every warmup program done; the second
   start finds the first's warmup manifest for every program (bookkeeping
   only: the port keeps no per-shape artifact); at 0 no side thread runs
   and the build runs in warmup, at 2 the param-free side thread runs the
   build and lies inside weights_load (its own start and end stamped);
   the 8 inline greedy requests give the same tokens after either start.
   (b) The 2-thread
   engine (K1) and an int8 + paged one (K4, 129 pages) built the same way
   serve the 12-request burst: submit and terminal events equal
   requests_submitted and requests_finished, every request's queue +
   placement + decode within 5% of its wall, only the closed vocabulary,
   a Chrome export that parses; the TTFT split (queue, placement,
   prefill) at p50 and p99, the recorder's own time as a share of the
   burst's wall (each note_* call timed), and host ms per decode step
   with the recorder on and off, and with the watchdog on and off (K1;
   alternating windows over three engines on the same weights, three
   windows each), beside the host microseconds of one chunk read through
   the watchdog's drainer and through the direct wait.
   (c) On each engine a FaultPlan (a 4 s hang once, two flaky submits)
   under 8 greedy submits: exactly 2 submits raise, one watchdog trip
   between watchdog_s and watchdog_s + 0.5 s after the read began, one
   recovery (its ms printed: K1 reallocates 536,870,912 bytes of KV),
   the requests in flight end ERROR with their streamed token counts, the
   rest are served, health returns, every page is free, and the inline
   greedy requests give the tokens they gave before the fault; and a
   freed pinned buffer is not reused while its non-blocking copy is
   queued (the check fails if the copy had already run). Each kernel launches num_layers x decode steps over every run
   of the phase and no other kernel launches.

12. The decode ring (``decode_ring=2``) on phase 5's llama3-8b bf16
   weights at full depth, after phase 9, on K1 and on K4 (int8 + paged,
   129 pages): each chunk size of the ring decode family is one captured
   CUDA graph whose steps are IF nodes on the slots' active flags. (a)
   Construction captures nothing (the kernel build stays warmup's
   task); warmup's first decode task captures, and its restore captures
   again on the new state: that capture's seconds and the device bytes
   its pools reserved. (b) The 12-request burst served with num_layers
   x the steps that ran launches (decode steps less the early exits);
   the 8 inline greedy requests give the tokens of a ring-off engine on
   the same weights in bf16, and again at llama3-1b width, 4 layers,
   f32. (c) 8 requests of 4 new tokens in a traced window: their last
   chunk of 8 steps exits early (early_exit_steps > 0); the kernel's
   launches counted on the card equal num_layers x the steps the host's
   books say ran, and so do the trace's decode_kernel records wherever
   the profiler tied every kernel record to a launch (elsewhere the
   trace's count is printed beside the share it tied to none). (d) A request whose 0.25 s deadline
   falls mid-decode ends DEADLINE with as many tokens streamed as
   counted. (e) K1: host ms per decode step ring on and off in
   alternating windows (three each), the decode chunks' device time (CUDA
   events around each chunk, no profiler) over each window's wall, and
   the ring's books and self-gate.

13. Training and embedding, after phase 11 (every earlier weight
   freed), with TF32 products off (printed; the phase fails if on). (a)
   One train_step at llama3-1b width cut to 2 layers, f32, on the card
   and on the CPU from the same params and tokens (B = 1, T = 33): the
   loss and every gradient leaf within 1e-4 of the CPU's (of the leaf's
   largest entry), every param after the AdamW update within the bound
   the two gradients imply (train_check). (b) llama3-1b at full width and
   depth (1,498,482,688 params, f32) drawn by init_fn on the card, 10
   train_steps on one seeded batch (B = 4, T = 513): the loss must fall
   and stay finite; the median step of steps 3-10 (CUDA events), tokens/s,
   the share of the 67 TFLOP/s non-tensor f32 peak, the peak memory
   (forward and backward, and AdamW's update, which PyTorch runs as
   foreach) beside the reckoned 23,975,723,008 bytes of params, grads and
   moments and the activations reckoned and saved. (c) The trained params
   (still requiring grad) served by an engine on the card (contiguous
   f32, K1): 4 greedy requests of 8 tokens whose prompts open rows of the
   batch, num_layers x decode steps K1 launches, no autograd graph, the
   tokens of a CPU engine over the same params. (d) forward_embed at
   llama3-8b width cut to 2 layers, card vs CPU at (8, 32) with pad rows:
   bf16 per-row cosine >= 0.999, f32 within 1e-5; then TorchEmbedder on
   full-depth llama3-8b bf16 weights drawn on the card: the nine bucket
   shapes timed, unit rows, no pad leak, 33 texts into 33 rows, texts/s
   and the bf16 peak share at (32, 512).

14. Tensor parallelism, after phase 13 (every earlier weight freed). Each
   rank is a process spawned by torch.multiprocessing, joined to one
   gloo group through the OMNIA_* env contract: the ranks share the one
   card, and NCCL takes one rank per card, so every collective is staged
   through host memory (its times are this route's, not NCCL's). The tp =
   1 side runs on this process from the same seeded weights. (a) llama3-8b
   at full width cut to 4 of its 32 layers, f32 (TF32 off): at tp = 2 and
   4 (one spawn each) the gathered prefill logits of a 32-token prompt
   within 1e-3 of tp = 1's, and through LockstepEngine.submit() on rank 0
   (the others run_follower()) 4 greedy requests of 17–200 tokens, 16 new
   tokens each, on a K1 engine and an int8 + paged K4 one (4 slots,
   max_seq 256) give tp = 1's tokens. (b) Every rank's kernel launches
   num_layers x its decode steps and no other, at H / tp heads over
   Hkv / tp. (c) At tp = 2, llama3-8b cut to TP_BF16_LAYERS (16) of its
   32 layers in bf16 (full depth until phase 15 needed the time): each rank's
   params exactly half the tree less the replicated norms, plus the
   norms; the 12-request burst, then a decode window of 8 greedy
   requests, through the leader: host and collective ms per decode step,
   per-rank peak memory and launches. (d) At tp = 2, mixtral-8x7b at full
   width cut to 2 of 32 layers, f32, router column 0 made positive: layer
   0's MoE MLP at 8 rows (all experts) and 1024 (capacity dispatch, drops)
   with each rank's 4 of 8 experts gives tp = 1's routing, kept set and
   outputs within 1e-4 of the largest, and the engine tp = 1's greedy
   tokens. (e) Session "e" served at tp = 2, exported there (a gather of
   every rank's KV heads) and imported by a tp = 1 engine, continues with
   the tokens of its resident replay.

15. Data and sequence parallelism, after phase 14, the ranks again
   spawned processes of one gloo group sharing the card (every
   collective and ring shift staged through host memory: correctness,
   bytes and staging's cost, no multi-card speed). One spawn of four
   ranks: (a) dp = 2 x tp = 2 over phase 14's f32 weights (llama3-8b
   width, 4 layers): prefill and decode logits within 1e-3 of tp = 1,
   and through LockstepEngine.submit() the 4 greedy prompts on K1 and on
   K4 (a pool of 9 pages per shard) and an 8-turn script of six sessions
   on four slots, in which session a resumes on the other shard, give
   tp = 1's tokens; each rank holds 2 slots and launches num_layers x its
   decode steps. (c) sp = 2 x tp = 2 on the same weights, a 4,000-token
   prompt (bucket 4096 >= long_prefill_threshold 2048, max_seq 8192):
   the ring prefill's logits within 1e-3 of the dense prefill's on the
   same ranks, and its first token and 16 more equal to the sp = 1
   engine's (a dp = 2 x tp = 2 engine on the same four ranks, slot 0's
   shard being an sp = 1, tp = 2 engine), one ring prefill counted; then
   at SP_BF16_LAYERS (16) of the 32 layers in bf16 (full depth until
   phase 17 needed the time) the ring prefill on the four ranks against the
   dense one on ranks 0 and 1 (one sp replica, as the dense engine's
   slot-0 shard runs it), timed, with the ring's shifts' bytes and ms, and the two
   engines' tokens (printed, not required). A spawn of two ranks: (b) dp =
   2, tp = 1, llama3-8b at full depth in bf16, each rank the whole tree and
   4 of the 8 slots, the 12-request burst through the leader: params and
   KV bytes per rank, peak memory, host ms per decode step, the dp token
   gather's calls and ms per step and the prefills' broadcasts apart.

16. Pipeline parallelism and the sharded trainer, after phase 15, one
   spawn of four ranks of one gloo group sharing the card (every
   collective and stage-to-stage send staged through host memory). (a)
   llama3-1b width cut to 4 layers, f32, TF32 off, B = 4, T = 33, the
   tree drawn by init_fn from one seed on every rank: at pp = 2 x tp = 2
   pipeline_forward's logits and gathered KV within 1e-4 of one rank's
   forward_prefill at M = 1, 2 and 4; one train_step at pp = 2 x tp = 2
   and one at dp = 2 x tp = 2 against one rank's from the same tree: the
   loss within 1e-5 relative on every rank, every gathered gradient leaf
   within 1e-4 of its largest entry, every param after the update within
   phase 13 (a)'s bound (rank 0 takes the one-rank step). (b) llama3-1b
   at full width and depth, f32, pp = 2 x tp = 2, M = 2, phase 13 (b)'s
   seed and batch (B = 4, T = 513), three train_steps: each rank's params
   bytes exactly the reckoning (a quarter of every projection, half of
   each layer norm, of embed and of lm_head, the final norm whole), the
   first loss within 1e-5 of phase 13 (b)'s, the loss falling; each
   rank's peak memory, ms per step, and its tp all-reduces' and pp sends'
   calls, bytes and seconds beside the GPipe bubble (S - 1) / (M + S - 1)
   = 1/3. (c) The trained shards gathered into one tree on rank 0 and
   served on K1 there, as phase 13 (c) does: the CPU's greedy tokens,
   num_layers x decode steps launches.

17. The decode ring under sp, after phase 16, one spawn of two ranks of
   one gloo group sharing the card (a decode step at sp = 2 holds no
   collective, so each rank captures and replays its own graphs; the tp
   and dp rings, whose steps hold collectives, run over NCCL with one
   rank per card: ``tests/test_torch_nccl_cuda.py``). (c) On each rank
   a tp = 2 and a dp = 2 engine with ``decode_ring=2`` over gloo on the
   card must raise the ValueError naming NCCL. (a) llama3-8b at full
   width cut to CUT_LAYERS layers, bf16, random seeded weights, per cache
   (K1, K4) a ring engine at sp = 2 (warmed: its graphs captured on both
   ranks, each capture's seconds and pool bytes), a ring-off one at sp =
   2 and on rank 0 a one-rank ring-off one: the 8 inline greedy requests
   give equal tokens on all three and on both ranks, and each rank's
   kernel launches num_layers x the steps that ran, counted on the card.
   (b) K1's host ms per decode step and the chunks' device share, ring on
   and off in alternating windows (three each, both ranks starting each
   window together).

Prints an ``engine <K> sessions`` JSON line per engine, ``agent <K>``
lines for phase 8, ``phase 9`` lines, ``moe check`` and mixtral lines
for phase 10, ``cold start``, ``flight`` and ``faults`` lines for phase
11, ``train`` and ``embed`` lines for phase 13, ``tp`` lines for phase
14, ``dp``, ``sp`` and ``dp bf16`` lines for phase 15, a ``pp`` line for
phase 16, a ``ring mesh`` line for phase 17, each phase's seconds
(``phase N took``) and the whole run's, a
``kernels`` JSON line (launches: each kernel's count over its
engine's burst and session runs, phase 7's bursts for K1 and K4, phase
8's runs for K1, K4 and K2, phase 9's llama3-8b runs for K1 and K4,
phase 10's runs for K1, K3 and K4, phase 11's runs for K1 and K4, and
phase 12's ring runs for K1 and K4, phase 13's and phase 16's trained
weights served on K1, and phases 14's, 15's and 17's runs on every rank
for K1 and K4;
times at the llama3-8b decode shape, and at the llama3-70b one beside
them), then the card's name and power limit, then as its last line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import ctypes
import gc
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import types
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from omnia_tpu_torch import kernels
from omnia_tpu_torch.engine import EngineConfig, FinishReason, InferenceEngine, SamplingParams
from omnia_tpu_torch.engine.coldstart import ColdStartTracker
from omnia_tpu_torch.engine.faults import FaultPlan, WatchdogTimeout
from omnia_tpu_torch.engine.flight import EVENTS, to_chrome_trace
from omnia_tpu_torch.engine.grammar import compile_json_schema
from omnia_tpu_torch.engine.multihost import LockstepEngine
from omnia_tpu_torch.engine.scheduler import _InflightChunk
from omnia_tpu_torch.engine.tokenizer import ByteTokenizer
from omnia_tpu_torch.models import checkpoint as ckpt_io
from omnia_tpu_torch.models import get_config, llama, quant
from omnia_tpu_torch.models.kv_quant import quantize_rows
from omnia_tpu_torch.models.paged_kv import PagedKV
from omnia_tpu_torch.ops import decode_attention as da
from omnia_tpu_torch.memory import TorchEmbedder
from omnia_tpu_torch.parallel.launch import spawn_ranks
from omnia_tpu_torch.parallel.mesh import make_mesh
from omnia_tpu_torch.parallel.pipeline import pipeline_forward
from omnia_tpu_torch.parallel.sharding import P, gather_leaf, tree_map_specs
from omnia_tpu_torch.runtime.providers import ProviderSpec, build_engine
from omnia_tpu_torch.train import make_train_step
from omnia_tpu_torch.train.trainer import leaves

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12, torch.int8: 1979e12}
POSITIONS = [0, 1, 255, 256, 511, 700, 1022, 1023]
TOL = {torch.float32: 1e-4, torch.bfloat16: 1.6e-2}
TIMED_LAUNCHES = 50
SPIN_CYCLES = 1_000_000            # ~0.5 ms of the card's clock
ROUNDS = 3
PAGE_S = 64
SRC = "omnia_tpu/ops/decode_attention.py"
# label → (kernel edition, name, the TPU kernel it replaces)
KERNELS = {
    "K1": ("decode_attention", "decode_gqa_attention", f"{SRC}:35"),
    "K2": ("decode_attention_int8", "decode_gqa_attention[int8]", f"{SRC}:49"),
    "K3": ("decode_attention_paged", "decode_gqa_attention_paged", f"{SRC}:116"),
    "K4": ("decode_attention_paged_int8", "decode_gqa_attention_paged[int8]", f"{SRC}:175"),
}
# Engine runs: label → (EngineConfig fields, requests of the burst). K4 is
# the slice's main path; 129 pages = 128 usable, the contiguous capacity
# of 8 slots x 1024 rows, so no request of the burst can be refused.
PAGED = dict(kv_pages=129, kv_page_tokens=PAGE_S)
ENGINES = {
    "K1": (dict(), 12),
    "K3": (PAGED, 6),
    "K2": (dict(kv_quant="int8"), 6),
    "K4": (dict(kv_quant="int8", **PAGED), 12),
}
# Phase 6: sessions on each engine's 8 slots, turns per session, new tokens per turn.
SESSIONS, TURNS, SESSION_TOKENS = 16, 3, 16
# Phase 7: the projection shapes [K, N] whose int8 products are timed,
# and the requests of the llama3-70b burst.
QDOT_SHAPES = {
    "llama3-8b": [(4096, 4096), (4096, 14336), (14336, 4096), (4096, 128256)],
    "llama3-70b": [(8192, 8192), (8192, 28672), (28672, 8192), (8192, 128256)],
}
BURST_70B = 12
# Phase 8: the agent engines' extra knobs and configurations (label →
# the kernel their decode runs), the system block's length (not a whole
# number of 64-row pages, so a seeded suffix copies the shared boundary
# page), and the tool-call schema of the constrained turns. The paged
# engine gets the block's 11 pages beyond the 8 x 1024 rows of its slots:
# the pinned entry holds them while 8 restored sessions (no pages shared)
# may hold 16 pages each.
AGENT = dict(prefix_cache_slots=4, grammar=True, grammar_max_states=512)
SYSTEM_TOKENS = 650
AGENT_ENGINES = {
    "K1": dict(),
    "K4": dict(kv_quant="int8", kv_pages=129 + -(-SYSTEM_TOKENS // PAGE_S),
               kv_page_tokens=PAGE_S),
    "K2": dict(kv_quant="int8"),
}
TOOL_CALL = {"type": "object",
             "properties": {"tool": {"enum": ["search", "calendar", "weather", "email"]},
                            "args": {"type": "object",
                                     "properties": {"unit": {"enum": ["c", "f"]},
                                                    "urgent": {"type": "boolean"},
                                                    "notify": {"type": "boolean"}},
                                     "required": ["unit", "urgent", "notify"]}},
             "required": ["tool", "args"]}


# Phase 9: stall-free batching and speculative decoding on the phase 5
# weights. Per cache (label → the kernel its decode runs) three engines
# share them: "both" knobs on; "mixed", the interleave alone (the
# repetition's spec-off arm and the arrivals' interleaved arm); "plain",
# neither (the arrivals' prefill-first arm). The arrival arms run without
# speculation, so that their decode steps have the same shapes. Random
# weights do not copy from their context, so the repetition's greedy
# requests are tool calls under phase 8's schema, whose prompts repeat a
# tool call: what the grammar forces (keys, quotes, the rest of an enum
# value) is what prompt lookup proposes.
STALL_SPEC = dict(prefill_chunk_tokens=256, spec_decode=4, spec_decode_max=8,
                  spec_gate_window=0)
STALL_SPEC_ENGINES = {"K1": dict(), "K4": dict(kv_quant="int8", **PAGED)}
STALL_SPEC_ARMS = {"both": STALL_SPEC, "mixed": dict(prefill_chunk_tokens=256),
                   "plain": dict()}
STALL_SPEC_GRAMMAR = dict(grammar=True, grammar_max_states=128)
DECODERS, DECODE_TOKENS, DECODE_PROMPT, ARRIVAL_TOKENS = 6, 128, 100, 900
REPEAT_SPAN, REPEATS, REPEAT_TOKENS = 48, 8, 96
# Phase 10: Mixtral-8x7B at full width cut to 16 of its 32 layers (the
# bf16 model is 93.41 GB; 16 layers hold 46.96 GB of the card's 80), the
# checkpoint of the provider path cut to 1 layer, the rows of the
# card-vs-CPU MoE check (all-expert and dispatch) and the mean of its
# activations' features (with a positive router column 0, most rows rank
# expert 0 first, so it overflows its capacity at 1024 rows).
MOE_LAYERS, MOE_PARAM_BYTES = 16, 46_964_940_800
MOE_CKPT_LAYERS, MOE_CKPT_BYTES = 1, 3_426_836_480
MOE_ROWS = (8, 1024)
MOE_H_MEAN = 0.05
# Phase 11: the operations layer on llama3-8b started from a checkpoint:
# its bf16 bytes, the free disk the write needs, the knobs of every
# engine of the phase, the warmup threads of the two starts, the fault
# plan (a hang twice the watchdog, two flaky submits), the bound on the
# trip's lateness and the K1 engine's KV bytes the recovery reallocates.
OPS_LAYERS, OPS_CKPT_BYTES = 8, 5_591_146_496
OPS_MIN_FREE_DISK = 20e9
OPS = dict(flight_events=4096, watchdog_s=2.0)
OPS_STARTS = (0, 2)
OPS_FAULTS = dict(hang_dispatch_s=4.0, hang_count=1, flaky_submit=2)
OPS_TRIP_LATE_S = 0.5
OPS_KV_BYTES = 268_435_456
# Phases 5-6, 8 and 9 serve the first 16 of llama3-8b's 32 layers (a view
# of the full weights, which phase 12 serves whole): their checks hold per
# layer, and the script's time has to make room for phases 12 and 14.
CUT_LAYERS = 16
# Phase 12: the decode ring (a captured CUDA graph per chunk size) on the
# K1 and K4 engines, the host-ms windows taken in turns with the ring-off
# engine, and the early-out's requests (4 new tokens: the last chunk of 8
# steps runs 3 of them).
RING = dict(decode_ring=2)
RING_ENGINES = {"K1": dict(), "K4": dict(kv_quant="int8", **PAGED)}
RING_WINDOWS = 3
RING_EARLY_TOKENS = 4
RING_DEADLINE_S = 0.25
# Phase 14: tensor parallelism, ranks of one gloo group sharing the card.
# (a), (b), (e): llama3-8b at full width cut to TP_LAYERS layers, f32, on
# K1 and K4 engines of TP_ENGINE's shape at tp = 2 and 4; (c)
# TP_BF16_LAYERS layers, bf16, the 12-request burst at tp = 2; (d) mixtral-8x7b at full width cut
# to TP_MOE_LAYERS layers, f32, at tp = 2.
TP_DEGREES = (2, 4)
TP_MODEL, TP_MOE_MODEL, TP_DEVICE = "llama3-8b", "mixtral-8x7b", "cuda"
TP_LAYERS, TP_MOE_LAYERS = 4, 2
TP_SEED, TP_MOE_SEED, TP_BF16_SEED = 21, 22, 23
TP_BF16_LAYERS = 16
TP_ENGINE = dict(num_slots=4, max_seq=256, prefill_buckets=(32, 64, 128, 256),
                 dtype="float32", max_sessions=4)
TP_EDITIONS = {"K1": dict(), "K4": dict(kv_quant="int8", kv_pages=17, kv_page_tokens=PAGE_S)}
TP_PROMPT_LENGTHS, TP_NEW_TOKENS = (17, 64, 100, 200), 16
TP_LOGIT_ROWS, TP_LOGITS_TOL = 32, 1e-3
# Phase 15: data and sequence parallelism, ranks of one gloo group sharing
# the card. (a) dp = 2 x tp = 2 and (c) sp = 2 x tp = 2 on one spawn of
# four ranks over phase 14's f32 weights (TP_MODEL, TP_LAYERS, TP_SEED);
# (b) dp = 2, tp = 1, bf16 at full depth, on a spawn of two. (c) then
# takes SP_BF16_LAYERS layers in bf16 for the ring's times.
DP_ENGINE = dict(TP_ENGINE, max_sessions=8)
DP_EDITIONS = {"K1": dict(), "K4": dict(kv_quant="int8", kv_pages=18, kv_page_tokens=PAGE_S)}
# Six sessions on four slots: e and f page a and b out, and a's return
# lands on c's slot, on the other dp shard.
DP_TURNS = (("a", 40), ("b", 24), ("c", 33), ("d", 20), ("e", 28), ("f", 36), ("a", 9),
            ("c", 12))
DP_BF16_SEED = 24
SP_PROMPT_TOKENS, SP_NEW_TOKENS = 4000, 16
SP_ENGINE = dict(num_slots=2, max_seq=8192, prefill_buckets=(256, 4096), dtype="float32",
                 long_prefill_threshold=2048, max_sessions=0)
SP_TIMED_ROUNDS = 2
SP_BF16_LAYERS = 16
# Four ranks' bf16 weights on one card: each rank's caching
# allocator grows its segments instead of keeping freed ones apart.
DPSP_ENV = {"PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"}


def lap(label: str, t0: float) -> float:
    """Print the seconds since t0 under label; returns now."""
    now = time.monotonic()
    print(f"{label} took {now - t0:.1f}s", flush=True)
    return now


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def run(cmd: list[str]) -> str:
    try:
        return subprocess.run(cmd, capture_output=True, text=True, timeout=60).stdout
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable ({e})"


# -- phase 1 ---------------------------------------------------------------

def device_line() -> str:
    nvcc = kernels.find_nvcc()
    release = "absent"
    if nvcc:
        m = re.search(r"release ([\d.]+)", run([nvcc, "--version"]))
        release = m.group(1) if m else "unknown"
    try:
        import triton
        triton_v = triton.__version__
    except ImportError:
        triton_v = "absent"
    print(f"torch {torch.__version__} cuda {torch.version.cuda} nvcc {release} "
          f"triton {triton_v} python {sys.version.split()[0]}", flush=True)
    smi = run(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"]).strip()
    return smi.splitlines()[0] if smi else "nvidia-smi: no output"


def ptxas_summary(src: str) -> str:
    """Registers, spills and static shared memory over every kernel in a
    source's ptxas report, and the dynamic shared memory of one block at
    the main path's shape (llama3-8b, bf16), which ptxas does not see."""
    log = kernels.library_path(src).with_suffix(".log").read_text()
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
    spills = sum(int(b) for b in re.findall(r"(\d+) bytes spill stores", log))
    static = [int(b) for b in re.findall(r"(\d+) bytes smem", log)]
    line = (f"{len(regs)} kernels, registers max {max(regs, default=0)}, "
            f"spill stores {spills} bytes in all, static shared memory max "
            f"{max(static, default=0)} bytes")
    if src not in da.EDITIONS:
        return line   # the ring's IF-node helper: no dynamic shared memory
    smem = getattr(kernels.load(src), da.EDITIONS[src] + "_smem_bytes")
    smem.argtypes, smem.restype = [ctypes.c_int] * 3, ctypes.c_int
    cfg = get_config("llama3-8b")
    dynamic = smem(cfg.head_dim, cfg.num_heads // cfg.num_kv_heads, 1)
    return f"{line}; dynamic shared memory per block at llama3-8b bf16: {dynamic} bytes"


# -- phase 3 ---------------------------------------------------------------

def time_ms(fn, flush: torch.Tensor) -> float:
    """Median device time of one call, L2 flushed before each (the decode
    step finds each layer's cache cold). The card spins for SPIN_CYCLES
    after the flush, so the host has enqueued the call before the start
    event runs: the wrapper's Python time is not counted however slow the
    host is."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(TIMED_LAUNCHES):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def paginate(arrs, pos: torch.Tensor, gen: torch.Generator):
    """Contiguous [B, S, ...] arrays → scrambled page pools and a table.
    Pool page 0 is the trash page and pages 1, 2 stay free; table entries
    past each position's page point at trash. Every page no live table
    entry references is poisoned (NaN; 127 in int8 rows)."""
    B, S = arrs[0].shape[:2]
    NP = S // PAGE_S
    ids = (torch.randperm(B * NP, generator=gen, device="cuda") + 3).view(B, NP)
    live = torch.arange(NP, device="cuda")[None, :] <= (pos.long() // PAGE_S)[:, None]
    pools = []
    for a in arrs:
        bad = 127 if a.dtype == torch.int8 else float("nan")
        pool = torch.full((B * NP + 3, PAGE_S) + tuple(a.shape[2:]), bad,
                          dtype=a.dtype, device="cuda")
        pool[ids[live]] = a.reshape((B, NP, PAGE_S) + tuple(a.shape[2:]))[live]
        pools.append(pool)
    table = torch.where(live, ids, 0).to(torch.int32).contiguous()
    return pools, table


def kernel_cases(model: str, dtype: torch.dtype, flush: torch.Tensor, tp: int = 1) -> dict:
    """K1–K4 at one model's decode shape and q dtype: error against the
    plain version on poisoned inputs, times and bounds. With ``tp`` the
    shape one rank of a tp engine runs: H / tp heads over Hkv / tp."""
    cfg = get_config(model)
    B, S, D = len(POSITIONS), 1024, cfg.head_dim
    H, Hkv = cfg.num_heads // tp, cfg.num_kv_heads // tp
    if tp > 1:
        model = f"{model} tp={tp}"
    gen = torch.Generator(device="cuda").manual_seed(1234)
    q = torch.randn((B, H, D), generator=gen, device="cuda", dtype=dtype)
    k = torch.randn((B, S, Hkv, D), generator=gen, device="cuda", dtype=dtype)
    v = torch.randn((B, S, Hkv, D), generator=gen, device="cuda", dtype=dtype)
    pos = torch.tensor(POSITIONS, dtype=torch.int32, device="cuda")
    past = torch.arange(S, device="cuda")[None, :] > pos.long()[:, None]   # [B, S]
    k_nan = k.masked_fill(past[:, :, None, None], float("nan"))
    v_nan = v.masked_fill(past[:, :, None, None], float("nan"))
    qk, qv = quantize_rows(k), quantize_rows(v)
    kq = qk.q.masked_fill(past[:, :, None, None], 127)
    vq = qv.q.masked_fill(past[:, :, None, None], -127)
    ks = qk.s.masked_fill(past[:, :, None], float("nan"))
    vs = qv.s.masked_fill(past[:, :, None], float("nan"))
    (pk, pv), table = paginate([k_nan, v_nan], pos, gen)
    (pkq, pvq, pks, pvs), table8 = paginate([kq, vq, ks, vs], pos, gen)

    # Yardstick only: one library call of K1's function (the port never
    # calls it). NaN rows would poison its pv product: it gets clean rows.
    mask = ~past[:, None, None, :]
    qs, kt, vt = q[:, :, None, :], k.transpose(1, 2), v.transpose(1, 2)

    def library():
        return F.scaled_dot_product_attention(qs, kt, vt, attn_mask=mask, enable_gqa=True)

    try:
        library()
    except TypeError as e:  # a torch without enable_gqa has no one-call form
        print(f"library call unavailable: {e}", flush=True)
        library = None
    calls = {
        "K1": (lambda: da.decode_gqa_attention(q, k_nan, v_nan, pos),
               lambda: da.decode_gqa_attention_ref(q, k_nan, v_nan, pos)),
        "K2": (lambda: da.decode_gqa_attention(q, kq, vq, pos, k_scale=ks, v_scale=vs),
               lambda: da.decode_gqa_attention_quant_ref(q, kq, vq, ks, vs, pos)),
        "K3": (lambda: da.decode_gqa_attention_paged(q, pk, pv, table, pos),
               lambda: da.decode_gqa_attention_paged_ref(q, pk, pv, table, pos)),
        "K4": (lambda: da.decode_gqa_attention_paged(q, pkq, pvq, table8, pos,
                                                     k_scale=pks, v_scale=pvs),
               lambda: da.decode_gqa_attention_paged_ref(q, pkq, pvq, table8, pos,
                                                         k_scale=pks, v_scale=pvs)),
    }
    outs, cases = {}, {}
    rows = sum(p + 1 for p in POSITIONS)
    pages_read = sum(p // PAGE_S + 1 for p in POSITIONS)
    item = q.element_size()
    for label, (kernel, plain) in calls.items():
        out = outs[label] = kernel()
        torch.cuda.synchronize()
        ref = plain()
        if not torch.isfinite(out).all():
            fail(f"{label} {model} {dtype}: non-finite output (a poisoned row or page was read)")
        err = (out.float() - ref.float()).abs().max().item()
        if err > TOL[dtype]:
            fail(f"{label} {model} {dtype}: max abs error {err} > {TOL[dtype]}")
        quant = label in ("K2", "K4")
        row_bytes = (D + 4) if quant else D * item          # one K or V row (+ scale)
        bytes_moved = (2 * q.numel() * item + pos.numel() * 4 + rows * Hkv * row_bytes * 2
                       + (pages_read * 4 if label in ("K3", "K4") else 0))
        ops = rows * H * D * 4          # q.k and p.v, multiply-add each
        bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / PEAK_OPS[dtype] * 1e3
        cases[label] = dict(
            model=model, dtype=str(dtype).removeprefix("torch."),
            shape=dict(B=B, H=H, Hkv=Hkv, D=D, S=S), max_abs_err=err,
            bound_ms=max(bytes_ms, ops_ms),
            bound_by="bytes" if bytes_ms >= ops_ms else "operations")
    # The session path's call: B = 1 on one slot of the same 8-slot cache
    # (a view of it, or a one-row slice of the table), every other slot
    # poisoned by its own rows past position. Each slot's result equals
    # row b of the B = 8 call bit for bit, and the plain version's.
    views = {
        "K1": lambda b: (da.decode_gqa_attention(q[b:b + 1], k_nan[b:b + 1], v_nan[b:b + 1],
                                                 pos[b:b + 1]),
                         da.decode_gqa_attention_ref(q[b:b + 1], k_nan[b:b + 1],
                                                     v_nan[b:b + 1], pos[b:b + 1])),
        "K2": lambda b: (da.decode_gqa_attention(q[b:b + 1], kq[b:b + 1], vq[b:b + 1],
                                                 pos[b:b + 1], k_scale=ks[b:b + 1],
                                                 v_scale=vs[b:b + 1]),
                         da.decode_gqa_attention_quant_ref(q[b:b + 1], kq[b:b + 1], vq[b:b + 1],
                                                           ks[b:b + 1], vs[b:b + 1], pos[b:b + 1])),
        "K3": lambda b: (da.decode_gqa_attention_paged(q[b:b + 1], pk, pv, table[b:b + 1],
                                                       pos[b:b + 1]),
                         da.decode_gqa_attention_paged_ref(q[b:b + 1], pk, pv, table[b:b + 1],
                                                           pos[b:b + 1])),
        "K4": lambda b: (da.decode_gqa_attention_paged(q[b:b + 1], pkq, pvq, table8[b:b + 1],
                                                       pos[b:b + 1], k_scale=pks, v_scale=pvs),
                         da.decode_gqa_attention_paged_ref(q[b:b + 1], pkq, pvq, table8[b:b + 1],
                                                           pos[b:b + 1], k_scale=pks,
                                                           v_scale=pvs)),
    }
    for label, one_slot in views.items():
        for b in range(B):
            out, ref = one_slot(b)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            if not torch.isfinite(out).all() or err > TOL[dtype]:
                fail(f"{label} {model} {dtype} one-slot view b={b}: max abs error {err}")
            if not torch.equal(out[0], outs[label][b]):
                fail(f"{label} {model} {dtype} one-slot view b={b} differs from row b of B={B}")
            cases[label]["max_abs_err"] = max(cases[label]["max_abs_err"], err)
    # The paged editions read the same rows through the table with the
    # same arithmetic: bit-identical to the contiguous ones.
    for paged, contiguous in (("K3", "K1"), ("K4", "K2")):
        if not torch.equal(outs[paged], outs[contiguous]):
            diff = (outs[paged].float() - outs[contiguous].float()).abs().max().item()
            fail(f"{paged} {model} {dtype}: differs from {contiguous} by {diff}")
    # Times in rounds taken in turns, so that a drift of the card's clock
    # or of its neighbours reaches every kernel alike; each round's number
    # is a median of TIMED_LAUNCHES calls, the case's the median of rounds.
    rounds = {(label, what): [] for label in calls for what in ("ms", "plain_ms", "library_ms")}
    for _ in range(ROUNDS):
        for label, (kernel, plain) in calls.items():
            rounds[label, "ms"].append(time_ms(kernel, flush))
            rounds[label, "plain_ms"].append(time_ms(plain, flush))
            if label == "K1" and library is not None:
                rounds[label, "library_ms"].append(time_ms(library, flush))
    for label, case in cases.items():
        for what in ("ms", "plain_ms", "library_ms"):
            got = rounds[label, what]
            case[what] = statistics.median(got) if got else None
        case["ms_rounds"] = rounds[label, "ms"]
        case["bound_share"] = case["bound_ms"] / case["ms"]
        print(f"{label} {model} {dtype}: {case['ms']:.5f} ms (rounds "
              f"{', '.join(f'{t:.5f}' for t in case['ms_rounds'])}), "
              f"{case['bound_share']:.1%} of its bound {case['bound_ms']:.5f} ms; plain "
              f"{case['plain_ms']:.5f} ms; library {case['library_ms']}", flush=True)
        print(f"{label} case " + json.dumps(case), flush=True)
    return cases


# -- phase 4 ---------------------------------------------------------------

def _kv_caches(cfg, B, S, dev, kv_quant, paged):
    if not paged:
        return llama.init_kv_cache(cfg, B, S, dev, dtype=torch.float32, kv_quant=kv_quant)
    # A scrambled page per table position after the trash page.
    table = (torch.randperm(B * S // 16, generator=torch.Generator().manual_seed(3))
             + 1).view(B, S // 16).to(torch.int32).to(dev)
    ck, cv = llama.init_kv_cache(cfg, 1 + B * S // 16, 16, dev, dtype=torch.float32,
                                 kv_quant=kv_quant)
    return PagedKV(ck, table), PagedKV(cv, table)


# Phase 4 configurations: (kv_quant, paged, weight quant) and the logits'
# tolerance against the CPU. f32 summation order only, except W8A8: an
# activation within f32 rounding of a .5 step may round to the other
# int8 value on the two devices, which moves a logit by ~s_in·s (~1e-5 at
# test-tiny widths).
REFERENCE_CASES = (
    (None, False, None, 1e-4),
    ("int8", True, None, 1e-4),
    (None, False, "int8", 1e-4),
    ("int8", True, "int8-dynamic", 1e-3),
)


def reference_check() -> None:
    """Small model, f32: the card's forward (kernels at T == 1) against the
    CPU's (plain path) on identical weights, a prefill then 3 decode
    steps at ragged positions, over a contiguous cache (K1) and an int8
    paged one (K4), dense and with int8 weights in each mode."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("test-tiny")
    cpu_params = llama.init_params(cfg, torch.Generator().manual_seed(7), "cpu",
                                   dtype=torch.float32)
    rng = np.random.default_rng(7)
    B, T, S = 3, 12, 64
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, T)))
    steps = torch.from_numpy(rng.integers(0, cfg.vocab_size, (3, B)))
    starts = torch.tensor([T, T + 5, T + 9], dtype=torch.int32)
    for kv_quant, paged, wquant, tol in REFERENCE_CASES:
        base = cpu_params if wquant is None else quant.quantize_params(cpu_params, cfg, wquant)
        logits = {}
        for dev in ("cpu", "cuda"):
            params = _to(base, dev)
            ck, cv = _kv_caches(cfg, B, S, dev, kv_quant, paged)
            pos = torch.arange(T, dtype=torch.int32).expand(B, T).to(dev)
            lg, ck, cv = llama.forward(params, cfg, prompt.to(dev), pos, ck, cv,
                                       torch.zeros(B, dtype=torch.int32, device=dev))
            out = [lg[:, -1].cpu()]
            for i in range(3):
                p = (starts + i).to(dev)
                lg, ck, cv = llama.forward(params, cfg, steps[i][:, None].to(dev),
                                           p[:, None], ck, cv, p)
                out.append(lg[:, 0].cpu())
            logits[dev] = torch.stack(out)
        err = (logits["cpu"] - logits["cuda"]).abs().max().item()
        what = f"kv_quant={kv_quant} paged={paged} quant={wquant}"
        if not torch.isfinite(logits["cuda"]).all() or err > tol:
            fail(f"card forward ({what}) disagrees with the CPU reference: max abs err {err}")
        print(f"reference check: test-tiny f32 {what} card vs CPU logits max abs err {err} "
              f"(tolerance {tol})", flush=True)


def qdot_check() -> None:
    """The int8 products on the card against their CPU route on the same
    int8 weights: W8A8 bit for bit (exact int32 sums, padded below
    torch._int_mm's 17-row minimum), W8A16 within f32 summation order
    (f32) or one bf16 step (2^-7 of the output's magnitude)."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    for K, N in ((4096, 14336), (8192, 28672)):
        w = torch.randn((K, N), generator=gen, device="cuda").mul_(0.02)
        for mode in quant.QUANT_MODES:
            card_w = quant.quantize_weight(w, mode)
            cpu_w = {k: v.cpu() for k, v in card_w.items()}
            worst = 0.0
            for rows in (1, 8, 17):
                for dtype in (torch.float32, torch.bfloat16):
                    h = torch.randn((rows, K), generator=gen, device="cuda").to(dtype)
                    card = quant.qdot(h, card_w).cpu()
                    cpu = quant.qdot(h.cpu(), cpu_w)
                    torch.cuda.synchronize()
                    what = f"qdot {mode} [{K}, {N}] rows={rows} {dtype}"
                    if mode == "int8-dynamic":
                        if not torch.equal(card, cpu):
                            diff = (card.float() - cpu.float()).abs().max().item()
                            fail(f"{what}: card differs from the CPU route by {diff}")
                        continue
                    rel = ((card.float() - cpu.float()).abs().max()
                           / cpu.float().abs().max()).item()
                    if rel > (1e-5 if dtype == torch.float32 else 2.0 ** -7):
                        fail(f"{what}: card vs CPU max error {rel} of the largest output")
                    worst = max(worst, rel)
            print(f"qdot check {mode} [{K}, {N}]: card vs CPU "
                  + ("bit-identical" if mode == "int8-dynamic"
                     else f"max error {worst:.3g} of the largest output"), flush=True)
        del w


def _to(tree, to):
    """A param tree detached and moved to a device or cast to a dtype."""
    if isinstance(tree, dict):
        return {k: _to(v, to) for k, v in tree.items()}
    return tree.detach().to(to)


# -- phase 5 ---------------------------------------------------------------

def wall_decode_ms(metrics: dict, steps: int) -> float:
    """Host wall per decode step: enqueueing plus waiting on tokens. With
    the device ahead of the host, dispatch dominates; behind, sync does."""
    return (metrics["decode_dispatch_s"] + metrics["decode_sync_s"]) / max(steps, 1) * 1e3


def burst(vocab: int, n: int) -> list:
    """The 12-request burst (its first n requests): prompts of 17–900
    tokens, half greedy, half sampled, 32–64 new tokens each; one greedy
    prompt goes in at the start, mid-run and last."""
    rng = np.random.default_rng(42)
    lengths = [17, 900, 64, 333, 128, 511, 45, 700, 250, 31, 600, 100]
    greedy = SamplingParams(temperature=0.0, max_tokens=48)
    sampled = dict(temperature=0.7, top_p=0.9, top_k=40)
    reqs = []
    for i, n_tok in enumerate(lengths):
        prompt = [int(t) for t in rng.integers(0, vocab, n_tok)]
        max_tokens = 32 + (i * 7) % 33
        sp = (SamplingParams(temperature=0.0, max_tokens=max_tokens) if i % 2 == 0
              else SamplingParams(max_tokens=max_tokens, seed=100 + i, **sampled))
        reqs.append((prompt, sp))
    for i in (0, 5, len(reqs) - 1):
        reqs[i] = (reqs[0][0], greedy)
    if n < len(reqs):
        reqs = reqs[:n - 1] + [reqs[-1]]   # keep the repeat of request 0
    return reqs


def checked_launches(label: str, engine, fn, run: str = ""):
    """``fn()`` with the launch counts set to 0 just before and read just
    after: the engine's kernel (``label``) must have launched num_layers x
    its decode steps and no other. Returns (fn's result, the launches)."""
    run = run or f"{label} {engine.model_cfg.name}"
    da.reset_launches()

    def ran() -> int:
        # A ring chunk skips its steps once every slot is done.
        return engine.metrics["decode_steps"] - engine.metrics["early_exit_steps"]

    steps0 = ran()
    out = fn()
    torch.cuda.synchronize()
    launches = da.launches()
    edition = KERNELS[label][0]
    layers, steps = engine.model_cfg.num_layers, ran() - steps0
    if launches[edition] != layers * steps or steps == 0:
        fail(f"{run} launched {launches[edition]} times, expected {layers} x {steps} decode "
             f"steps that ran = {layers * steps}")
    others = {n: c for n, c in launches.items() if n != edition and c}
    if others:
        fail(f"{run} launched other kernels: {others}")
    return out, launches[edition]


def serve(label: str, engine, card: str, n_requests: int, run: str = "") -> int:
    """The engine serves a burst through submit() from its own thread;
    launch counts are set to 0 just before and read just after. ``label``
    names the engine's kernel, ``run`` the run in what is printed."""
    run = run or label
    cfg = engine.model_cfg
    reqs = burst(cfg.vocab_size, n_requests)
    engine.start()
    steps0 = engine.metrics["decode_steps"]
    torch.cuda.reset_peak_memory_stats()
    results = [None] * len(reqs)

    def consume(i, handle, t_submit):
        toks, times = [], []
        for ev in handle.events(timeout=600):
            if ev.token_id is not None:
                toks.append(ev.token_id)
                times.append(time.monotonic())
            if ev.is_final:
                results[i] = (toks, ev, t_submit, times)

    def run_burst() -> float:
        t_start = time.monotonic()
        threads = []
        for i, (prompt, sp) in enumerate(reqs):
            t_submit = time.monotonic()
            h = engine.submit(prompt, sp)
            th = threading.Thread(target=consume, args=(i, h, t_submit))
            th.start()
            threads.append(th)
        for th in threads:
            th.join(timeout=900)
        wall = time.monotonic() - t_start
        engine.stop()
        return wall

    wall, launches = checked_launches(label, engine, run_burst, run)
    decode_steps = engine.metrics["decode_steps"] - steps0

    for i, r in enumerate(results):
        if r is None:
            fail(f"{run}: request {i} never finished")
        toks, ev, _, _ = r
        if ev.finish_reason not in (FinishReason.LENGTH, FinishReason.STOP) or ev.error:
            fail(f"{run}: request {i} ended {ev.finish_reason} error={ev.error}")
        if ev.num_generated_tokens != len(toks):
            fail(f"{run}: request {i}: {ev.num_generated_tokens} counted, {len(toks)} streamed")
        if not all(0 <= t < cfg.vocab_size for t in toks):
            fail(f"{run}: request {i}: token id out of range")
    if not results[0][0] == results[-1][0]:
        fail(f"{run}: the repeated greedy prompt gave different tokens")
    m = engine.metrics
    if engine.cfg.kv_pages and m["kv_pages_free"] != m["kv_pages_total"]:
        fail(f"{run}: {m['kv_pages_free']} of {m['kv_pages_total']} pages free after the run")

    ttft = [r[3][0] - r[2] for r in results]
    per_req = [(len(r[3]) - 1) / (r[3][-1] - r[3][0]) for r in results if len(r[3]) > 1]
    generated = sum(len(r[0]) for r in results)
    summary = dict(
        card=card, kernel=label, model=cfg.name, quant=engine.cfg.quant,
        kv_quant=engine.cfg.kv_quant,
        kv_pages=engine.cfg.kv_pages, kv_page_tokens=engine.cfg.kv_page_tokens,
        requests=len(results), generated_tokens=generated,
        decode_steps=decode_steps, launches=launches,
        ttft_p50_s=statistics.median(ttft), wall_s=wall,
        tokens_per_s=generated / wall,
        per_request_decode_tokens_per_s_p50=statistics.median(per_req),
        decode_step_ms=wall_decode_ms(m, decode_steps),
        decode_dispatch_s=m["decode_dispatch_s"], decode_sync_s=m["decode_sync_s"],
        prefill_dispatch_s=m["prefill_dispatch_s"],
        kv_quant_device_bytes=m["kv_quant_device_bytes"],
        kv_quant_bytes_per_token=m["kv_quant_bytes_per_token"],
        kv_pages_total=m["kv_pages_total"], kv_pages_free=m["kv_pages_free"],
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
    )
    print(f"engine {run} " + json.dumps(summary), flush=True)
    return launches


def greedy_inline(engine) -> list:
    """Eight greedy requests submitted in one order and stepped inline:
    the tokens each got."""
    rng = np.random.default_rng(5)
    handles = [engine.submit([int(t) for t in rng.integers(0, engine.model_cfg.vocab_size, n)],
                             SamplingParams(temperature=0.0, max_tokens=16))
               for n in (17, 64, 130, 300, 511, 700, 45, 900)]
    while engine.step():
        pass
    return [h.collect_tokens(timeout=60)[0] for h in handles]


def decode_profile(label: str, engine, card: str) -> None:
    """A traced window of synchronous decode (8 greedy requests, stepped
    inline after serving): the device's busy share of the wall and the
    kernels that take its time. Reads "not measured" where the profiler
    records no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(9)
    handles = [engine.submit([int(t) for t in rng.integers(0, engine.model_cfg.vocab_size, 40)],
                             SamplingParams(temperature=0.0, max_tokens=24))
               for _ in range(engine.cfg.num_slots)]
    engine.step()                       # place one request outside the window
    steps0 = engine.metrics["decode_steps"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        while engine.step():
            pass
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    for h in handles:
        h.collect_tokens(timeout=60)
    # Device-side entries only: the host ops that launched them carry the
    # same device time again.
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:8]
    decode_steps = engine.metrics["decode_steps"] - steps0
    # The decode-attention body's kernels by name (decode_*kernel):
    # one launch per layer and decode step, none of them a second pass.
    attention = {}
    for e in kern:
        m = re.search(r"decode_[a-z_]*kernel", e.key)
        if m:
            attention[m.group(0)] = attention.get(m.group(0), 0) + e.count
    expected = engine.model_cfg.num_layers * decode_steps
    if kern and (sum(attention.values()) != expected or set(attention) != {"decode_kernel"}):
        fail(f"{label} profile window: decode-attention kernels {attention}, expected "
             f"decode_kernel x {expected} ({decode_steps} decode steps) and nothing else")
    print(f"decode profile {label} " + json.dumps(dict(
        card=card, wall_ms=wall_ms,
        decode_steps=decode_steps,
        decode_attention_kernels=attention if kern else "not measured",
        device_kernels=sum(e.count for e in kern),
        device_busy_ms=busy_ms if kern else "not measured",
        device_busy_share=busy_ms / wall_ms if kern else "not measured",
        top_kernels=[(e.key[:60], e.count, e.self_device_time_total / 1e3) for e in top],
    )), flush=True)


# -- phase 6 ---------------------------------------------------------------

def session_script(vocab: int) -> tuple[list, list]:
    """16 sessions' turn-1 prompts (200–700 tokens) and the new text of
    each later turn (40–120 tokens), from a fixed seed. The last session
    starts at 700 and adds 120, then 150: its third turn extends from row
    851 to 1002, where a 256-row piece would cross max_seq 1024, so its
    first 23 pieces are single tokens."""
    rng = np.random.default_rng(77)
    firsts = [int(n) for n in np.linspace(200, 700, SESSIONS)]
    prompts = [[int(t) for t in rng.integers(0, vocab, n)] for n in firsts]
    new = [[[int(t) for t in rng.integers(0, vocab, int(rng.integers(40, 121)))]
            for _ in range(TURNS - 1)] for _ in range(SESSIONS)]
    new[-1] = [[int(t) for t in rng.integers(0, vocab, n)] for n in (120, 150)]
    return prompts, new


def host_bytes(sess) -> int:
    return 0 if sess.host_k is None else sess.host_k.nbytes + sess.host_v.nbytes


def timed_calls(engine, log: dict) -> None:
    """Time each offload, restore and placement of the engine alone (the
    card idle before and after it): (ms, host bytes moved) per offload or
    restore, (ms, request id) per placement (a restore, the prefill or
    extend, and the first token)."""
    def wrap(name):
        inner = getattr(engine, name)

        def run(first, *args):
            before = host_bytes(first) if name == "_restore_session" else 0
            torch.cuda.synchronize()
            t0 = time.monotonic()
            inner(first, *args)
            torch.cuda.synchronize()
            ms = (time.monotonic() - t0) * 1e3
            if name == "_place_request":
                log[name].append((ms, args[0].request_id))
            elif before or host_bytes(first):
                log[name].append((ms, before or host_bytes(first)))

        setattr(engine, name, run)

    for name in log:
        wrap(name)


def sessions(label: str, engine, card: str) -> dict:
    """Phase 6 on one engine: 16 clients, one per session, each submit 3
    greedy turns of 16 tokens through the engine thread; every turn after
    the first is the previous prompt, its reply and new text. Launch
    counts are set to 0 just before and read just after. Then, on the
    stopped engine, one session's turn 2 is served again resident and
    again after export → import, and every session is released."""
    cfg = engine.model_cfg
    prompts, new = session_script(cfg.vocab_size)
    sp = SamplingParams(temperature=0.0, max_tokens=SESSION_TOKENS)
    turns = [[] for _ in range(SESSIONS)]
    errors = []
    calls = {"_offload_session": [], "_restore_session": [], "_place_request": []}
    timed_calls(engine, calls)

    def client(i):
        prompt = prompts[i]
        try:
            for t in range(TURNS):
                t0 = time.monotonic()
                h = engine.submit(prompt, sp, session_id=f"s{i}")
                toks, ev = h.collect_tokens(timeout=600)
                turns[i].append((prompt, toks, ev, h.first_token_at - t0, h.request_id))
                if t < TURNS - 1:
                    prompt = prompt + toks + new[i][t]
        except Exception as e:  # a hung or failed turn fails the phase below
            errors.append(f"session {i}: {e!r}")

    m0 = dict(engine.metrics)
    engine.start()
    da.reset_launches()                     # counts start here
    t_start = time.monotonic()
    threads = [threading.Thread(target=client, args=(i,)) for i in range(SESSIONS)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=900)
    wall = time.monotonic() - t_start
    engine.stop()
    torch.cuda.synchronize()
    launches = da.launches()
    m = engine.metrics
    delta = {k: m[k] - m0[k] for k in ("decode_steps", "prefill_tokens", "prefix_reuse_tokens",
                                       "session_offloads", "session_restores", "extend_steps",
                                       "decode_dispatch_s", "decode_sync_s")}
    if errors or any(len(t) != TURNS for t in turns):
        fail(f"{label} sessions: turns missing or failed: {errors}")
    reuse = prefill = singles = 0
    for per in turns:
        for t, (prompt, toks, ev, _, _) in enumerate(per):
            if ev.finish_reason not in (FinishReason.LENGTH, FinishReason.STOP) or ev.error:
                fail(f"{label} sessions: a turn ended {ev.finish_reason} error={ev.error}")
            r = 0
            if t:
                prev_prompt, prev_toks = per[t - 1][0], per[t - 1][1]
                r = len(prev_prompt) + len(prev_toks) - 1
                singles += sum(b == 1 for _, _, b in
                               engine._extend_pieces(r, len(prompt) - r))
            reuse += r
            prefill += len(prompt) - r
    if delta["prefix_reuse_tokens"] != reuse or delta["prefill_tokens"] != prefill:
        fail(f"{label} sessions: reuse {delta['prefix_reuse_tokens']} / prefill "
             f"{delta['prefill_tokens']} tokens, the script implies {reuse} / {prefill}")
    if not (delta["session_offloads"] > 0 and delta["session_restores"] > 0):
        fail(f"{label} sessions: {delta['session_offloads']} offloads, "
             f"{delta['session_restores']} restores")
    edition = KERNELS[label][0]
    expected = cfg.num_layers * (delta["decode_steps"] + singles)
    if launches[edition] != expected or singles == 0:
        fail(f"{label} sessions launched {launches[edition]} times, expected {cfg.num_layers} "
             f"x ({delta['decode_steps']} decode steps + {singles} single-token pieces) "
             f"= {expected}")
    others = {n: c for n, c in launches.items() if n != edition and c}
    if others:
        fail(f"{label} sessions launched other kernels: {others}")

    # Exact restore: turn 2 of session 3 served again (restored first if
    # it was paged out, resident after), then again after export → import
    # on the stopped engine: the restored rows must give the same tokens.
    prompt2 = turns[3][1][0]

    def inline(prompt):
        h = engine.submit(prompt, sp, session_id="s3")
        while engine.step():
            pass
        return h.collect_tokens(timeout=60)[0]

    resident = inline(prompt2)
    payload = engine.export_session("s3")
    if payload is None or payload.restore_rows != engine.cfg.restore_bucket_for(
            len(payload.token_ids)):
        fail(f"{label} sessions: export_session gave {payload}")
    engine.import_session(payload)
    restores = m["session_restores"]
    imported = inline(prompt2)
    if imported != resident or m["session_restores"] != restores + 1:
        fail(f"{label} sessions: turn 2 after export -> import {imported[:8]}... differs from "
             f"the resident replay {resident[:8]}...")
    for i in range(SESSIONS):
        engine.release_session(f"s{i}")
    if engine.cfg.kv_pages and m["kv_pages_free"] != m["kv_pages_total"]:
        fail(f"{label} sessions: {m['kv_pages_free']} of {m['kv_pages_total']} pages free "
             f"after every session was released")
    for name in calls:
        delattr(engine, name)

    ttft1 = [per[0][3] for per in turns]
    ttft23 = [x[3] for per in turns for x in per[1:]]
    placed = dict((rid, ms) for ms, rid in calls["_place_request"])
    moves = {name: calls[name] for name in ("_offload_session", "_restore_session")}
    summary = dict(
        card=card, kernel=label, kv_quant=engine.cfg.kv_quant, kv_pages=engine.cfg.kv_pages,
        sessions=SESSIONS, turns=SESSIONS * TURNS, wall_s=wall,
        ttft_p50_turn1_s=statistics.median(ttft1), ttft_p50_turns23_s=statistics.median(ttft23),
        placement_ms_p50_turn1=statistics.median(placed[per[0][4]] for per in turns),
        placement_ms_p50_turns23=statistics.median(placed[x[4]] for per in turns
                                                   for x in per[1:]),
        prefill_tokens=prefill, prefill_tokens_saved=reuse,
        decode_steps=delta["decode_steps"], single_token_pieces=singles,
        extend_steps=delta["extend_steps"], launches=launches[edition],
        session_offloads=delta["session_offloads"], session_restores=delta["session_restores"],
        offload_ms_p50=statistics.median(t for t, _ in moves["_offload_session"]),
        restore_ms_p50=statistics.median(t for t, _ in moves["_restore_session"]),
        bytes_per_session_p50=statistics.median(b for _, b in moves["_offload_session"]),
        offload_ms_per_mib=sum(t for t, _ in moves["_offload_session"])
        / (sum(b for _, b in moves["_offload_session"]) / 2**20),
        restore_ms_per_mib=sum(t for t, _ in moves["_restore_session"])
        / (sum(b for _, b in moves["_restore_session"]) / 2**20),
        decode_step_ms=wall_decode_ms(delta, delta["decode_steps"]),
        turn2_replay_equals_original=resident == turns[3][1][1],
    )
    print(f"engine {label} sessions " + json.dumps(summary), flush=True)
    return dict(launches=launches[edition], tokens=[[x[1] for x in per] for per in turns])


def first_layers(params: dict, n: int) -> dict:
    """The first n layers of a weight tree: views of the stacked layer
    weights, no copy."""
    def cut(tree):
        return {k: cut(v) for k, v in tree.items()} if isinstance(tree, dict) else tree[:n]

    return dict(params, layers=cut(params["layers"]))


def engines(card: str) -> dict:
    """Phases 5 and 6 on the first CUT_LAYERS layers of the llama3-8b
    weights: the four engine runs, their session runs and the greedy
    equalities; then phases 8 and 9 on the cut weights and phase 12 on
    the whole ones. Returns each kernel's launch
    count from its runs."""
    t = time.monotonic()
    full_cfg = get_config("llama3-8b")
    full = llama.init_params(full_cfg, torch.Generator(device="cuda").manual_seed(0), "cuda",
                             dtype=torch.bfloat16)
    cfg = get_config("llama3-8b", num_layers=CUT_LAYERS)
    params = first_layers(full, CUT_LAYERS)
    launches, greedy, session_tokens = {}, {}, {}
    for label, (fields, n_requests) in ENGINES.items():
        t0 = time.monotonic()
        engine = InferenceEngine(cfg, EngineConfig(**fields), params=params, seed=0,
                                 device="cuda")
        torch.cuda.synchronize()
        init_s = time.monotonic() - t0
        t0 = time.monotonic()
        engine.warmup()
        print(f"engine {label} llama3-8b bf16 L={cfg.num_layers} {fields}: init "
              f"{init_s:.1f}s warmup {time.monotonic() - t0:.1f}s", flush=True)
        launches[label] = serve(label, engine, card, n_requests)
        if label in ("K1", "K4"):
            decode_profile(label, engine, card)
        greedy[label] = greedy_inline(engine)
        run = sessions(label, engine, card)
        launches[label] += run["launches"]
        session_tokens[label] = run["tokens"]
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    for paged, contiguous in (("K3", "K1"), ("K4", "K2")):
        if greedy[paged] != greedy[contiguous]:
            fail(f"greedy tokens of the {paged} (paged) engine differ from the "
                 f"{contiguous} (contiguous) engine's")
        if session_tokens[paged] != session_tokens[contiguous]:
            fail(f"session tokens of the {paged} (paged) engine differ from the "
                 f"{contiguous} (contiguous) engine's")
    print("greedy equality: paged == contiguous at bf16 (K3 vs K1) and int8 (K4 vs K2), "
          f"{sum(map(len, greedy['K1']))} and {sum(map(len, greedy['K2']))} tokens; "
          f"session turns {sum(len(t) for per in session_tokens['K1'] for t in per)} and "
          f"{sum(len(t) for per in session_tokens['K2'] for t in per)} tokens", flush=True)
    t = lap("phases 5-6", t)
    for label, n in agent(card, params, cfg).items():
        launches[label] += n
    t = lap("phase 8", t)
    for label, n in stall_free_spec(card, params, cfg).items():
        launches[label] += n
    t = lap("phase 9", t)
    for label, n in ring(card, full).items():
        launches[label] += n
    lap("phase 12", t)
    return launches


# -- phase 8 ---------------------------------------------------------------

def agent_script(vocab: int) -> tuple[list, list]:
    """The system block and each session's new text per turn (16–48
    tokens), from a fixed seed. Each session's first new token is its
    own, so no two sessions share a row past the block."""
    rng = np.random.default_rng(88)
    block = [int(t) for t in rng.integers(0, vocab, SYSTEM_TOKENS)]
    new = [[[int(t) for t in rng.integers(0, vocab, int(rng.integers(16, 49)))]
            for _ in range(TURNS)] for _ in range(SESSIONS)]
    for i in range(SESSIONS):
        new[i][0][0] = 1000 + i
    return block, new


def agent_turn(i: int, t: int, grammar):
    """Session i's turn t: (SamplingParams, grammar or None). Even
    sessions are greedy, odd ones sampled; every second turn is
    constrained."""
    constrained = (i + t) % 2 == 1
    eos = ByteTokenizer().eos_id
    if i % 2 == 0:
        sp = SamplingParams(temperature=0.0, max_tokens=96 if constrained else SESSION_TOKENS,
                            stop_token_ids=(eos,))
    else:
        sp = SamplingParams(temperature=0.7, top_p=0.9, top_k=40, seed=100 * i + t,
                            max_tokens=96 if constrained else SESSION_TOKENS,
                            stop_token_ids=(eos,))
    return sp, grammar if constrained else None


def agent_run(label: str, engine, grammar, sessions_: list, card: str) -> dict:
    """Phase 8 on one engine: the block registered; session 0's first
    turn alone (it prefills and publishes the block); then the other
    sessions' first turns and every later turn from one thread per
    session. Launch counts are set to 0 just before and read just after.
    Returns the turns and the reckoned counts."""
    cfg = engine.model_cfg
    block, new = agent_script(cfg.vocab_size)
    turns = {i: [] for i in sessions_}
    errors = []
    calls = {"_place_request": []}
    timed_calls(engine, calls)

    def one(i, t, prompt):
        sp, g = agent_turn(i, t, grammar)
        t0 = time.monotonic()
        h = engine.submit(prompt, sp, session_id=f"a{i}", grammar=g)
        toks, ev = h.collect_tokens(timeout=600)
        ttft = None if h.first_token_at is None else h.first_token_at - t0
        turns[i].append((prompt, toks, ev, ttft, h.request_id, g))
        return prompt + toks

    def client(i, first):
        try:
            prompt = block + new[i][0]
            for t in range(TURNS):
                if t or not first:
                    prompt = one(i, t, prompt)
                else:
                    prompt = turns[i][0][0] + turns[i][0][1]
                if t < TURNS - 1:
                    prompt = prompt + new[i][t + 1]
        except Exception as e:  # a hung or failed turn fails the phase below
            errors.append(f"session {i}: {e!r}")

    m0 = dict(engine.metrics)
    engine.register_prefix(block)
    engine.start()
    da.reset_launches()                     # counts start here
    t_start = time.monotonic()
    one(sessions_[0], 0, block + new[sessions_[0]][0])
    threads = [threading.Thread(target=client, args=(i, i == sessions_[0])) for i in sessions_]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=900)
    wall = time.monotonic() - t_start
    engine.stop()
    torch.cuda.synchronize()
    launches = da.launches()
    delattr(engine, "_place_request")
    if errors or any(len(turns[i]) != TURNS for i in sessions_):
        fail(f"agent {label}: turns missing or failed: {errors}")
    m = engine.metrics
    delta = {k: m[k] - m0[k] for k in (
        "decode_steps", "prefill_tokens", "prefix_reuse_tokens", "prefix_cache_hit_tokens",
        "prefix_cache_insertions", "prefix_cache_evictions", "prefix_cache_host_hits",
        "prefix_cache_offload_elisions", "session_offloads", "session_restores",
        "decode_dispatch_s", "decode_sync_s")}
    # Reckoned from the script: every first turn but session 0's seeds
    # the block; every later turn reuses its session's rows (the last
    # emitted token's row excluded) and extends from there.
    reuse = hits = prefill = singles = 0
    for i in sessions_:
        for t, (prompt, toks, ev, _, _, _) in enumerate(turns[i]):
            if ev.finish_reason not in (FinishReason.LENGTH, FinishReason.STOP) or ev.error:
                fail(f"agent {label}: a turn ended {ev.finish_reason} error={ev.error}")
            if t:
                prev_prompt, prev_toks = turns[i][t - 1][0], turns[i][t - 1][1]
                frontier = len(prev_prompt) + len(prev_toks) - 1
                reuse += frontier
            elif i != sessions_[0]:
                frontier = SYSTEM_TOKENS
                hits += frontier
            else:
                frontier = 0
            if frontier:
                singles += sum(b == 1 for _, _, b in
                               engine._extend_pieces(frontier, len(prompt) - frontier))
            prefill += len(prompt) - frontier
    if delta["prefix_cache_offload_elisions"]:
        fail(f"agent {label}: {delta['prefix_cache_offload_elisions']} offloads elided; the "
             f"reckoning assumes every later turn reuses its session's rows")
    if (delta["prefix_cache_hit_tokens"], delta["prefix_reuse_tokens"],
            delta["prefill_tokens"]) != (hits, reuse, prefill):
        fail(f"agent {label}: pool hits / reuse / prefill {delta['prefix_cache_hit_tokens']} / "
             f"{delta['prefix_reuse_tokens']} / {delta['prefill_tokens']} tokens, the script "
             f"implies {hits} / {reuse} / {prefill}")
    if delta["prefix_cache_insertions"] < 1:
        fail(f"agent {label}: the block was never published")
    if engine.cfg.kv_pages and m["kv_page_cow_copies"] <= 0:
        fail(f"agent {label}: no page was copied on write")
    edition = KERNELS[label][0]
    expected = cfg.num_layers * (delta["decode_steps"] + singles)
    if launches[edition] != expected:
        fail(f"agent {label} launched {launches[edition]} times, expected {cfg.num_layers} "
             f"x ({delta['decode_steps']} decode steps + {singles} single-token pieces) "
             f"= {expected}")
    others = {n: c for n, c in launches.items() if n != edition and c}
    if others:
        fail(f"agent {label} launched other kernels: {others}")

    tok = ByteTokenizer()
    enums = set(TOOL_CALL["properties"]["tool"]["enum"])
    stopped = 0
    for i in sessions_:
        for prompt, toks, ev, _, rid, g in turns[i]:
            if g is None:
                continue
            view = g.view(cfg.vocab_size, (tok.eos_id,))
            s = view.start
            for x in toks:
                s = view.advance(s, x)
                if s < 0:
                    fail(f"agent {label}: {rid} emitted token {x}, which its grammar masks")
            if ev.finish_reason == FinishReason.STOP:
                stopped += 1
                try:
                    doc = json.loads(tok.decode(toks))
                except ValueError as e:
                    fail(f"agent {label}: {rid} stopped on {tok.decode(toks)!r}: {e}")
                if doc.get("tool") not in enums:
                    fail(f"agent {label}: {rid} names no tool of the enum: {doc}")
    if not stopped:
        fail(f"agent {label}: no grammared turn stopped")

    placed = {rid: ms for ms, rid in calls["_place_request"]}
    seeded = [turns[i][0] for i in sessions_[1:]]
    first = turns[sessions_[0]][0]
    summary = dict(
        card=card, kernel=label, kv_quant=engine.cfg.kv_quant, kv_pages=engine.cfg.kv_pages,
        sessions=len(sessions_), turns=len(sessions_) * TURNS, wall_s=wall,
        system_tokens=SYSTEM_TOKENS,
        ttft_s_session1_turn1=first[3],
        ttft_p50_s_seeded_turn1=statistics.median(x[3] for x in seeded),
        placement_ms_session1_turn1=placed[first[4]],
        placement_ms_p50_seeded_turn1=statistics.median(placed[x[4]] for x in seeded),
        prefill_tokens=prefill, prefill_tokens_saved=hits + reuse,
        prefix_cache_hit_tokens=hits, prefix_reuse_tokens=reuse,
        prefix_cache_insertions=delta["prefix_cache_insertions"],
        prefix_cache_evictions=delta["prefix_cache_evictions"],
        prefix_cache_host_hits=delta["prefix_cache_host_hits"],
        kv_page_cow_copies=m["kv_page_cow_copies"],
        session_offloads=delta["session_offloads"], session_restores=delta["session_restores"],
        grammared_turns=sum(1 for i in sessions_ for x in turns[i] if x[5] is not None),
        grammared_stops=stopped,
        grammar_rejections_avoided=m["grammar_rejections_avoided"],
        masked_logit_fraction=m["masked_logit_fraction"],
        grammar_table_device_bytes=engine._gtable.nbytes,
        kv_quant_device_bytes=m["kv_quant_device_bytes"],
        decode_steps=delta["decode_steps"], single_token_pieces=singles,
        launches=launches[edition], decode_step_ms=wall_decode_ms(delta, delta["decode_steps"]),
    )
    print(f"agent {label} " + json.dumps(summary), flush=True)
    return dict(launches=launches[edition],
                greedy={i: [x[1] for x in turns[i]] for i in sessions_ if i % 2 == 0})


def decode_window(engine) -> float:
    """Eight greedy requests of 100 prompt tokens, 64 new tokens each,
    stepped inline: host ms per decode step (dispatch + sync)."""
    rng = np.random.default_rng(12)
    m0 = dict(engine.metrics)
    handles = [engine.submit([int(t) for t in rng.integers(0, engine.model_cfg.vocab_size, 100)],
                             SamplingParams(temperature=0.0, max_tokens=64))
               for _ in range(engine.cfg.num_slots)]
    while engine.step():
        pass
    for h in handles:
        h.collect_tokens(timeout=60)
    m = engine.metrics
    delta = {k: m[k] - m0[k] for k in ("decode_steps", "decode_dispatch_s", "decode_sync_s")}
    return wall_decode_ms(delta, delta["decode_steps"])


def agent(card: str, params, cfg) -> dict:
    """Phase 8: the three agent engines on the shared llama3-8b weights
    (phase 5's view of their first CUT_LAYERS layers); returns each
    kernel's launches from its engine's run."""
    grammar = compile_json_schema(TOOL_CALL, ByteTokenizer())
    launches, greedy, step_ms = {}, {}, {"on": [], "off": []}
    for label, fields in AGENT_ENGINES.items():
        t0 = time.monotonic()
        engine = InferenceEngine(cfg, EngineConfig(**AGENT, **fields), params=params, seed=0,
                                 device="cuda")
        engine.warmup()
        print(f"agent {label} llama3-8b bf16 L={cfg.num_layers} {dict(AGENT, **fields)}: init + "
              f"warmup {time.monotonic() - t0:.1f}s; {grammar.num_states} grammar states",
              flush=True)
        sessions_ = list(range(SESSIONS)) if label != "K2" else list(range(0, SESSIONS, 2))
        run = agent_run(label, engine, grammar, sessions_, card)
        launches[label], greedy[label] = run["launches"], run["greedy"]
        if label == "K1":
            # The same window on this engine and on one built without
            # grammars, three times each in turns: the cost of the
            # grammar's decode edition, beside the host's spread.
            for i in sessions_:
                engine.release_session(f"a{i}")
            off = InferenceEngine(cfg, EngineConfig(), params=params, seed=0, device="cuda")
            off.warmup()
            for key in ("on", "off", "off", "on", "on", "off"):
                step_ms[key].append(decode_window(engine if key == "on" else off))
            del off
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    if greedy["K4"] != greedy["K2"]:
        fail("agent: greedy tokens of the K4 (int8 paged) engine differ from the K2 "
             "(contiguous int8) engine's")
    print("agent greedy equality: int8 paged (K4) == contiguous int8 (K2) over "
          f"{len(greedy['K2'])} greedy sessions, "
          f"{sum(len(t) for per in greedy['K2'].values() for t in per)} tokens", flush=True)
    print("agent decode window " + json.dumps(dict(
        card=card, grammar_on_engine_ms_per_step=step_ms["on"],
        grammar_off_engine_ms_per_step=step_ms["off"],
        median_on=statistics.median(step_ms["on"]),
        median_off=statistics.median(step_ms["off"]))), flush=True)
    return launches


# -- phase 9 ---------------------------------------------------------------

def _record_events(handle, rec: dict) -> None:
    """Each delivered token and its host time, then the final event."""
    for ev in handle.events(timeout=600):
        if ev.token_id is not None:
            rec["toks"].append(ev.token_id)
            rec["times"].append(time.monotonic())
        if ev.is_final:
            rec["final"] = ev


def _threaded(engine, reqs: list, recs: list, threads: list, sessions: str = "") -> None:
    """Submit (prompt, params[, grammar]) requests, one consumer thread
    each; with ``sessions``, request i is a turn of session
    ``f"{sessions}{i}"``."""
    for i, (prompt, sp, *g) in enumerate(reqs):
        rec = dict(toks=[], times=[], final=None, t_submit=time.monotonic())
        h = engine.submit(prompt, sp, session_id=f"{sessions}{i}" if sessions else None,
                          grammar=g[0] if g else None)
        th = threading.Thread(target=_record_events, args=(h, rec))
        th.start()
        recs.append(rec)
        threads.append(th)


def _finished(run: str, recs: list) -> None:
    for i, r in enumerate(recs):
        ev = r["final"]
        if ev is None:
            fail(f"{run}: request {i} never finished")
        if ev.finish_reason not in (FinishReason.LENGTH, FinishReason.STOP) or ev.error:
            fail(f"{run}: request {i} ended {ev.finish_reason} error={ev.error}")
        if ev.num_generated_tokens != len(r["toks"]):
            fail(f"{run}: request {i}: {ev.num_generated_tokens} counted, "
                 f"{len(r['toks'])} streamed")


def _delta(engine, m0: dict) -> dict:
    return {k: engine.metrics[k] - m0[k] for k in (
        "decode_steps", "mixed_steps", "interleaved_prefill_tokens", "prefill_tokens",
        "spec_steps", "spec_proposed", "spec_accepted", "tokens_generated",
        "decode_dispatch_s", "decode_sync_s")}


def arrivals(run: str, engine, vocab: int) -> dict:
    """6 greedy requests decode 128 tokens; once each has its first token
    and one chunk, two 900-token prompts arrive. The decoders' delivery
    gaps and rate over the arrival window (arrival → both first tokens),
    and the arrivals' TTFT.

    Each decoder is turn 2 of a session whose turn 1 ran alone: its new
    tokens extend at the same bucket whether they are placed by a chunked
    extend or by a mixed step, so its rows, like its decode steps, do not
    depend on the arm (a fresh prefill and an extend round differently
    in bf16)."""
    rng = np.random.default_rng(91)
    decoders = [[int(t) for t in rng.integers(0, vocab, DECODE_PROMPT)]
                for _ in range(DECODERS)]
    arrivals_ = [[int(t) for t in rng.integers(0, vocab, ARRIVAL_TOKENS)] for _ in range(2)]
    for i, p in enumerate(decoders):
        h = engine.submit(p, SamplingParams(temperature=0.0, max_tokens=1),
                          session_id=f"d{i}")
        while engine.step():
            pass
        decoders[i] = p + h.collect_tokens(timeout=60)[0] + [
            int(t) for t in rng.integers(0, vocab, 20)]
    m0 = dict(engine.metrics)
    recs, threads = [], []
    engine.start()
    _threaded(engine, [(p, SamplingParams(temperature=0.0, max_tokens=DECODE_TOKENS))
                       for p in decoders], recs, threads, sessions="d")
    t0 = time.monotonic()
    while min(len(r["toks"]) for r in recs) < 1 + engine.cfg.decode_chunk:
        if time.monotonic() - t0 > 300:
            fail(f"{run}: the decoders never reached their first chunk")
        time.sleep(0.0005)
    # Every decoder is placed and no piece is in flight: the counters
    # from here on are the arrivals'.
    m_arr = dict(engine.metrics)
    t_arr = time.monotonic()
    _threaded(engine, [(p, SamplingParams(temperature=0.0, max_tokens=16))
                       for p in arrivals_], recs, threads)
    for th in threads:
        th.join(timeout=900)
    engine.stop()
    torch.cuda.synchronize()
    _finished(run, recs)
    for i in range(DECODERS):
        engine.release_session(f"d{i}")
    t_end = max(r["times"][0] for r in recs[DECODERS:])
    gaps, in_window = [], 0
    for r in recs[:DECODERS]:
        ts = r["times"]
        gaps += [b - a for a, b in zip(ts, ts[1:]) if t_arr < b <= t_end]
        in_window += sum(t_arr < t <= t_end for t in ts)
    return dict(delta=_delta(engine, m0), arrival_delta=_delta(engine, m_arr),
                decoder_tokens=[r["toks"] for r in recs[:DECODERS]],
                largest_gap_ms=max(gaps) * 1e3 if gaps else None,
                p99_gap_ms=float(np.percentile(gaps, 99)) * 1e3 if gaps else None,
                window_s=t_end - t_arr,
                decoder_tokens_per_s_in_window=in_window / (t_end - t_arr),
                arrival_ttft_s=[r["times"][0] - r["t_submit"] for r in recs[DECODERS:]])


def tool_call_text(i: int) -> str:
    tools = TOOL_CALL["properties"]["tool"]["enum"]
    return json.dumps({"tool": tools[i % 4], "args": {
        "unit": "cf"[i % 2], "urgent": i % 3 == 0, "notify": i % 2 == 1}})


def repetition_prompts(vocab: int, n: int) -> list:
    """Prompts that repeat a span 8 times: a tool call's bytes for the
    greedy requests 0–5, 48 random tokens for the sampled ones."""
    rng = np.random.default_rng(93)
    return [(list(tool_call_text(i).encode()) if i < 6
             else [int(t) for t in rng.integers(0, vocab, REPEAT_SPAN)]) * REPEATS
            for i in range(n)]


def repetition_requests(vocab: int, n: int, grammar) -> list:
    """(prompt, params, grammar): 0–5 greedy tool calls under the schema,
    6 and 7 sampled and free (a verify step's scan lane)."""
    out = []
    for i, p in enumerate(repetition_prompts(vocab, n)):
        if i < 6:
            out.append((p, SamplingParams(temperature=0.0, max_tokens=REPEAT_TOKENS), grammar))
        else:
            out.append((p, SamplingParams(temperature=0.7, top_p=0.9, top_k=40,
                                          max_tokens=REPEAT_TOKENS, seed=300 + i), None))
    return out


def repetition(run: str, engine, vocab: int, grammar, arrival: bool = False) -> dict:
    """8 requests whose prompts repeat a span 8 times (7 and a 900-token
    arrival once the greedy ones have 32 tokens, with ``arrival``). Times
    each standalone verify step and counts the tokens each verify step
    accepts and emits, and the mixed steps that carry a verify window."""
    stats = dict(verify_ms=[], verify_lane_tokens=0, fused=0)

    def timed(name):
        inner = getattr(engine, name)

        def call(*args):
            t0, n0 = time.monotonic(), engine.metrics["tokens_generated"]
            out = inner(*args)
            if name == "_spec_dispatch":
                stats["verify_ms"].append((time.monotonic() - t0) * 1e3)
            else:
                stats["verify_lane_tokens"] += engine.metrics["tokens_generated"] - n0
            return out

        setattr(engine, name, call)

    saved = [dict(fns) for fns in (engine._mixed_spec_fns, engine._mixed_spec_sample_fns)]
    for fns in (engine._mixed_spec_fns, engine._mixed_spec_sample_fns):
        for b, fn in list(fns.items()):
            def counted(*args, _fn=fn):
                stats["fused"] += 1
                return _fn(*args)
            fns[b] = counted
    if engine.cfg.spec_decode:
        timed("_spec_dispatch")
        timed("_spec_accept")
    m0 = dict(engine.metrics)
    recs, threads = [], []
    engine.start()
    t0 = time.monotonic()
    _threaded(engine, repetition_requests(vocab, 7 if arrival else 8, grammar), recs, threads)
    if arrival:
        while min(len(r["toks"]) for r in recs[:6]) < 32:
            if time.monotonic() - t0 > 300:
                fail(f"{run}: the greedy requests never reached 32 tokens")
            time.sleep(0.0005)
        rng = np.random.default_rng(97)
        _threaded(engine, [([int(t) for t in rng.integers(0, vocab, ARRIVAL_TOKENS)],
                            SamplingParams(temperature=0.0, max_tokens=16))], recs, threads)
    for th in threads:
        th.join(timeout=900)
    wall = time.monotonic() - t0
    engine.stop()
    torch.cuda.synchronize()
    _finished(run, recs)
    for name in ("_spec_dispatch", "_spec_accept"):
        engine.__dict__.pop(name, None)
    engine._mixed_spec_fns.update(saved[0])
    engine._mixed_spec_sample_fns.update(saved[1])
    d = _delta(engine, m0)
    return dict(delta=d, tokens=[r["toks"] for r in recs], wall_s=wall,
                tokens_per_s=d["tokens_generated"] / wall, **stats)


def device_ms(fn, rounds: int = 5) -> float:
    """Device ms of one call of a function of a few dozen kernels, median
    of ``rounds``: the card spins ~20 ms first, so the host has enqueued
    the whole call before the start event runs."""
    times = []
    for _ in range(rounds + 1):
        torch.cuda.synchronize()
        torch.cuda._sleep(40 * SPIN_CYCLES)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times[1:])


def verify_attention_ms(engine) -> float:
    """Device ms of the verify window's plain attention for one layer:
    q [B, W+1, H, D] at positions 400.., over the engine's layer-0 cache
    (a paged cache through its slot-contiguous gather)."""
    from omnia_tpu_torch.ops.attention import gqa_attention
    cfg, B, W = engine.model_cfg, engine.cfg.num_slots, engine.cfg.spec_window()
    q = torch.randn((B, W + 1, cfg.num_heads, cfg.head_dim), dtype=torch.bfloat16,
                    device="cuda")
    pos = (400 + torch.arange(W + 1, dtype=torch.int32)).expand(B, W + 1).contiguous().cuda()
    kc, vc = llama._layer_cache(engine._ck, 0), llama._layer_cache(engine._cv, 0)
    return device_ms(lambda: gqa_attention(q, kc, vc, pos))


def mixed_halves_ms(engine, rounds: int = 5) -> dict:
    """A mixed step's two halves alone on the idle engine: the wall ms of
    a 256-token piece forward (the extend seam) and of one decode step of
    the batch, each from an idle card to its end (median of ``rounds``).
    Each is thousands of launches, more than the launch queue holds, so
    the host's enqueue and the device's work overlap and the wall is
    what a mixed step pays for the half."""
    piece = engine._piece_args(0, [1] * 256, 0, 256, 256)
    out = {}
    for name, fn in (("piece_256", lambda: engine._extend_nosample_fn(*piece)),
                     ("decode_step", lambda: engine._run_decode_step(1))):
        walls = []
        for _ in range(rounds + 1):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            fn()
            torch.cuda.synchronize()
            walls.append((time.monotonic() - t0) * 1e3)
        out[name + "_wall_ms"] = statistics.median(walls[1:])
    return out


def divergence(engine, prompt: list, a: list, b: list, grammar) -> tuple:
    """(leading tokens two greedy tool-call streams share, the top-2 margin
    of the grammar-admissible logits where they part, or None)."""
    n = 0
    while n < min(len(a), len(b)) and a[n] == b[n]:
        n += 1
    if n == min(len(a), len(b)):
        return n, None
    view = grammar.view(engine.model_cfg.vocab_size, ())
    state = view.start
    for t in a[:n]:
        state = view.advance(state, t)
    seq = torch.tensor([prompt + a[:n]], dtype=torch.long, device="cuda")
    pos = torch.arange(seq.shape[1], dtype=torch.int32, device="cuda")[None]
    logits, _, _ = llama.forward_prefill(engine.params, engine.model_cfg, seq, pos)
    allowed = torch.from_numpy(view.allowed(state)).to(logits.device)
    top = torch.topk(torch.where(allowed, logits[0, -1].float(), -float("inf")), 2).values
    return n, (top[0] - top[1]).item()


def stall_free_spec(card: str, params, cfg) -> dict:
    """Phase 9 (a, b) on the llama3-8b bf16 weights (``cfg``'s layers of
    them), then (c); returns each kernel's launches from its engines'
    runs."""
    grammar = compile_json_schema(TOOL_CALL, ByteTokenizer())
    launches = {}
    for label, cache in STALL_SPEC_ENGINES.items():
        t0 = time.monotonic()
        engines_ = {}
        for arm, knobs in STALL_SPEC_ARMS.items():
            engines_[arm] = InferenceEngine(cfg, EngineConfig(**cache, **knobs,
                                                              **STALL_SPEC_GRAMMAR),
                                            params=params, seed=0, device="cuda")
            engines_[arm].warmup()
        print(f"stall-free/spec {label} llama3-8b bf16 L={cfg.num_layers} {cache} arms "
              f"{STALL_SPEC_ARMS}: init + warmup {time.monotonic() - t0:.1f}s", flush=True)
        da.reset_launches()                     # counts start here
        arr = {arm: arrivals(f"{label} arrivals {arm}", engines_[arm], cfg.vocab_size)
               for arm in ("mixed", "plain")}
        rep = {arm: repetition(f"{label} repetition {arm}", engines_[arm], cfg.vocab_size,
                               grammar) for arm in ("both", "mixed")}
        fused = repetition(f"{label} fused", engines_["both"], cfg.vocab_size, grammar,
                           arrival=True)
        torch.cuda.synchronize()
        count = da.launches()
        edition = KERNELS[label][0]
        # Single-token pieces run at the cache end only: no piece of this
        # traffic gets there (every prompt starts at row 0 or, for a
        # decoder's turn 2, at row 101, and ends by row 900).
        singles = 0
        for start, n in ((0, ARRIVAL_TOKENS), (0, REPEAT_SPAN * REPEATS),
                         (DECODE_PROMPT, 21)):
            singles += sum(b == 1 for _o, _t, b in engines_["mixed"]._budget_pieces(start, n))
            singles += sum(b == 1 for _o, _t, b in engines_["plain"]._extend_pieces(start, n))
        if singles:
            fail(f"phase 9 {label}: the traffic would run single-token pieces")
        steps = (sum(r["delta"]["decode_steps"] for r in arr.values())
                 + sum(r["delta"]["decode_steps"] for r in rep.values())
                 + fused["delta"]["decode_steps"])
        pieces = (arr["mixed"]["delta"]["mixed_steps"] + rep["both"]["delta"]["mixed_steps"]
                  + rep["mixed"]["delta"]["mixed_steps"] + fused["delta"]["mixed_steps"])
        expected = cfg.num_layers * steps
        if count[edition] != expected:
            fail(f"phase 9 {label}: {count[edition]} launches, expected {cfg.num_layers} x "
                 f"{steps} decode steps (and no single-token piece) = {expected}")
        others = {n: c for n, c in count.items() if n != edition and c}
        if others:
            fail(f"phase 9 {label} launched other kernels: {others}")
        launches[label] = count[edition]

        if arr["mixed"]["arrival_delta"]["interleaved_prefill_tokens"] != 2 * ARRIVAL_TOKENS:
            fail(f"phase 9 {label}: interleaved_prefill_tokens "
                 f"{arr['mixed']['arrival_delta']['interleaved_prefill_tokens']}, the arrivals' "
                 f"prompts are {2 * ARRIVAL_TOKENS}")
        if arr["plain"]["delta"]["mixed_steps"] != 0:
            fail(f"phase 9 {label}: the prefill-first arm ran mixed steps")
        if arr["mixed"]["decoder_tokens"] != arr["plain"]["decoder_tokens"]:
            fail(f"phase 9 {label}: the decoders' greedy tokens differ between the "
                 f"interleaved and the prefill-first arm")
        on, off = rep["both"], rep["mixed"]
        if on["delta"]["spec_accepted"] <= 0:
            fail(f"phase 9 {label}: no proposal accepted ({on['delta']})")
        if on["tokens"][6:] != off["tokens"][6:]:
            fail(f"phase 9 {label}: the sampled requests' tokens differ with spec on and off")
        if fused["fused"] < 1:
            fail(f"phase 9 {label}: no mixed step carried a verify window")
        for arm, r in arr.items():
            d, a = r.pop("delta"), r.pop("arrival_delta")
            r.pop("decoder_tokens")
            print(f"phase 9 {label} arrivals {arm} " + json.dumps(dict(
                card=card, **r, mixed_steps=a["mixed_steps"],
                interleaved_prefill_tokens=a["interleaved_prefill_tokens"],
                decode_steps_from_arrival=a["decode_steps"],
                decode_step_ms_from_arrival=wall_decode_ms(a, a["decode_steps"]),
                decode_steps=d["decode_steps"])), flush=True)
        agree = [divergence(engines_["both"], p, a, b, grammar) for p, a, b in
                 zip(repetition_prompts(cfg.vocab_size, 6), on["tokens"][:6], off["tokens"][:6])]
        d_on, d_off = on["delta"], off["delta"]
        print(f"phase 9 {label} repetition " + json.dumps(dict(
            card=card, spec_proposed=d_on["spec_proposed"], spec_accepted=d_on["spec_accepted"],
            spec_steps=d_on["spec_steps"], decode_steps_on=d_on["decode_steps"],
            decode_steps_off=d_off["decode_steps"],
            verify_lane_tokens_per_verify_step=on["verify_lane_tokens"] / max(d_on["spec_steps"], 1),
            host_ms_per_standalone_verify_step=statistics.median(on["verify_ms"])
            if on["verify_ms"] else None,
            standalone_verify_steps=len(on["verify_ms"]),
            tokens_per_s_on=on["tokens_per_s"], tokens_per_s_off=off["tokens_per_s"],
            wall_s_on=on["wall_s"], wall_s_off=off["wall_s"],
            greedy_tokens_agreeing_bf16=[n for n, _ in agree],
            greedy_tokens_each=[len(t) for t in on["tokens"][:6]],
            top2_margin_at_first_divergence=[m for _, m in agree],
            verify_attention_device_ms_per_layer=verify_attention_ms(engines_["both"]),
            mixed_step_halves=mixed_halves_ms(engines_["mixed"]),
            fused_mixed_steps=fused["fused"], fused_spec_steps=fused["delta"]["spec_steps"],
            fused_mixed_steps_total=fused["delta"]["mixed_steps"], launches=launches[label],
            decode_steps_phase9=steps, single_token_pieces=singles,
            mixed_pieces=pieces)), flush=True)
        del engines_
        gc.collect()
        torch.cuda.empty_cache()
    f32_identity(card)
    return launches


def f32_identity(card: str) -> None:
    """Phase 9 (c): llama3-1b width cut to 4 layers, f32, on the card:
    interleaved and monolithic placement give the same greedy tokens, and
    so do spec on and off (the repetition's greedy tool calls), on the
    contiguous and the int8 + paged cache."""
    cfg = get_config("llama3-1b", num_layers=4)
    params = llama.init_params(cfg, torch.Generator(device="cuda").manual_seed(9), "cuda",
                               dtype=torch.float32)
    rng = np.random.default_rng(95)
    decoders = [[int(t) for t in rng.integers(0, cfg.vocab_size, 300)] for _ in range(4)]
    late = [[int(t) for t in rng.integers(0, cfg.vocab_size, 600)] for _ in range(2)]
    greedy = SamplingParams(temperature=0.0, max_tokens=48)

    def inline(engine, kind):
        if kind == "arrivals":
            hs = [engine.submit(p, greedy) for p in decoders]
            for _ in range(4):
                engine.step()
            hs += [engine.submit(p, greedy) for p in late]
        else:
            hs = [engine.submit(p, sp, grammar=g)
                  for p, sp, g in repetition_requests(cfg.vocab_size, 6, grammar)]
        while engine.step():
            pass
        return [h.collect_tokens(timeout=60)[0] for h in hs]

    grammar = compile_json_schema(TOOL_CALL, ByteTokenizer())
    out = {}
    for label, cache in STALL_SPEC_ENGINES.items():
        if "kv_quant" in cache:
            # An int8 cache's fresh prefill attends its own float chunk,
            # a piece the quantized rows: with buckets up to 256 every
            # prompt here (300 to 600 tokens) extends in 256-row pieces
            # on both arms.
            cache = dict(cache, prefill_buckets=(32, 64, 128, 256))
        engines_ = {arm: InferenceEngine(cfg, EngineConfig(dtype="float32", **cache, **knobs,
                                                           **STALL_SPEC_GRAMMAR),
                                         params=params, seed=0, device="cuda")
                    for arm, knobs in STALL_SPEC_ARMS.items()}
        got = {arm: inline(engines_[arm], "arrivals") for arm in ("mixed", "plain")}
        if engines_["mixed"].metrics["mixed_steps"] == 0 or got["mixed"] != got["plain"]:
            fail(f"phase 9 (c) {label}: interleaved placement's greedy tokens differ from "
                 f"monolithic placement's in f32")
        spec = {arm: inline(engines_[arm], "repetition") for arm in ("both", "mixed")}
        m = engines_["both"].metrics
        if m["spec_accepted"] == 0 or spec["both"] != spec["mixed"]:
            fail(f"phase 9 (c) {label}: spec-on greedy tokens differ from spec-off in f32 "
                 f"({m['spec_steps']} verify steps, {m['spec_accepted']} accepted)")
        out[label] = dict(arrival_tokens=sum(map(len, got["mixed"])),
                          mixed_steps=engines_["mixed"].metrics["mixed_steps"],
                          repetition_tokens=sum(map(len, spec["both"])),
                          spec_steps=m["spec_steps"], spec_accepted=m["spec_accepted"])
        del engines_
    print("phase 9 (c) f32 identity " + json.dumps(dict(
        card=card, model="llama3-1b width, 4 layers, f32", **out)), flush=True)


# -- phase 12 --------------------------------------------------------------

def first_divergence(a: list, b: list):
    """(request, step) where two lists of token streams first part, or None."""
    for i, (x, y) in enumerate(zip(a, b)):
        n = 0
        while n < min(len(x), len(y)) and x[n] == y[n]:
            n += 1
        if n < max(len(x), len(y)):
            return i, n
    return None


def traced_kernels(fn):
    """``fn()`` under the profiler: (the decode-attention body's kernel
    records by name, the share of the window's kernel records that the
    profiler tied to no launch, i.e. with correlation id 0), or None
    where the profiler records no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.profiler.kineto_results.events()
           if e.device_type() == DeviceType.CUDA
           and not e.name().startswith(("Memcpy", "Memset"))]
    if not dev:
        return None
    attention = {}
    for e in dev:
        m = re.search(r"decode_[a-z_]*kernel", e.name())
        if m:
            attention[m.group(0)] = attention.get(m.group(0), 0) + 1
    return attention, sum(e.correlation_id() == 0 for e in dev) / len(dev)


def early_out(label: str, engine, card: str) -> int:
    """Phase 12 (c): 8 greedy requests of RING_EARLY_TOKENS new tokens
    stepped inline in a traced window; once all are placed the last chunk
    (8 steps, the smallest variant covering the 3 steps left) runs only
    the steps some slot still needs. The kernel's launches, counted on the
    card by the launches themselves, must be num_layers x the steps the
    host's books say ran (dispatched less early exits), and so must the
    trace's decode_kernel records where the profiler tied every kernel
    record of the window to a launch. Returns the launches."""
    rng = np.random.default_rng(13)
    handles = [engine.submit([int(t) for t in rng.integers(0, engine.model_cfg.vocab_size, 40)],
                             SamplingParams(temperature=0.0, max_tokens=RING_EARLY_TOKENS))
               for _ in range(engine.cfg.num_slots)]
    da.reset_launches()
    m0 = dict(engine.metrics)

    def run():
        while engine.step():
            pass

    traced = traced_kernels(run)
    counted = da.launches()
    for h in handles:
        toks, fin = h.collect_tokens(timeout=60)
        if len(toks) != RING_EARLY_TOKENS or fin.finish_reason != FinishReason.LENGTH:
            fail(f"phase 12 (c) {label}: a request ended {fin.finish_reason} after "
                 f"{len(toks)} tokens")
    m = engine.metrics
    d = {k: m[k] - m0[k] for k in ("decode_steps", "early_exit_steps")}
    layers, edition = engine.model_cfg.num_layers, KERNELS[label][0]
    ran = d["decode_steps"] - d["early_exit_steps"]
    if d["early_exit_steps"] <= 0:
        fail(f"phase 12 (c) {label}: no chunk exited early ({d})")
    if counted[edition] != layers * ran or sum(counted.values()) != counted[edition]:
        fail(f"phase 12 (c) {label}: the card counted launches {counted}, the host's books "
             f"give {layers} x {ran} steps that ran ({d})")
    # The profiler's count inside replays is held where it tied every
    # kernel record of the window to a launch. Where it tied some to none
    # (H100, torch 2.11, CUDA 12.8: 15-18% of the records, seen on K4 and
    # on K1 after earlier traced windows in the process), it listed 319,
    # 344 and 358 decode_kernel records for the card's 320: there the
    # trace is printed beside that share, and the card's count is held.
    attention, unlinked = traced if traced is not None else (None, None)
    if traced is not None and unlinked == 0:
        if attention != {"decode_kernel": layers * ran}:
            fail(f"phase 12 (c) {label}: the trace shows decode-attention kernels {attention}, "
                 f"the card counted {counted[edition]} ({ran} of {d['decode_steps']} steps ran)")
    print(f"phase 12 (c) early-out {label} " + json.dumps(dict(
        card=card, decode_steps_dispatched=d["decode_steps"], early_exit_steps=d["early_exit_steps"],
        steps_ran=ran, launches_counted_on_card=counted[edition],
        launches_traced=attention if traced is not None else "not measured",
        trace_records_tied_to_no_launch=unlinked if traced is not None else "not measured",
        launches_if_every_step_ran=layers * d["decode_steps"])), flush=True)
    return counted[edition]


def deadline_check(label: str, engine, card: str) -> None:
    """Phase 12 (d): one greedy request whose deadline falls mid-decode
    ends DEADLINE with as many tokens streamed as counted."""
    rng = np.random.default_rng(14)
    m0 = engine.metrics["deadline_exceeded"]
    h = engine.submit([int(t) for t in rng.integers(0, engine.model_cfg.vocab_size, 64)],
                      SamplingParams(temperature=0.0, max_tokens=900),
                      deadline_s=RING_DEADLINE_S)
    while engine.step():
        pass
    toks, fin = h.collect_tokens(timeout=60)
    if fin.finish_reason != FinishReason.DEADLINE or fin.num_generated_tokens != len(toks):
        fail(f"phase 12 (d) {label}: ended {fin.finish_reason} with {len(toks)} streamed, "
             f"{fin.num_generated_tokens} counted")
    print(f"phase 12 (d) deadline {label} " + json.dumps(dict(
        card=card, deadline_s=RING_DEADLINE_S, streamed=len(toks),
        num_generated_tokens=fin.num_generated_tokens,
        deadline_exceeded=engine.metrics["deadline_exceeded"] - m0,
        step_ema_ms=engine._devloop.step_ema_s * 1e3)), flush=True)


def busy_window(engine) -> dict:
    """decode_window with a CUDA event pair around every decode chunk's
    enqueue and no profiler running: host ms per step, and the chunks'
    device time over the window's wall (for an eager chunk the pair also
    holds whatever the device idled while the host enqueued)."""
    pairs = []
    run_step = engine._run_decode_step

    def timed(chunk, dl_steps=None):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        out = run_step(chunk, dl_steps)
        e1.record()
        pairs.append((e0, e1))
        return out

    engine._run_decode_step = timed
    try:
        t0 = time.monotonic()
        ms = decode_window(engine)
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    finally:
        del engine._run_decode_step
    chunk_ms = sum(a.elapsed_time(b) for a, b in pairs)
    return dict(host_ms_per_step=ms, chunk_device_ms=chunk_ms, wall_ms=wall_ms,
                chunk_device_share=chunk_ms / wall_ms)


def ring_f32_identity(card: str) -> dict:
    """Phase 12 (b) at f32: llama3-1b width cut to 4 layers, the ring's
    greedy tokens equal the ring-off engine's on K1 and K4."""
    cfg = get_config("llama3-1b", num_layers=4)
    params = llama.init_params(cfg, torch.Generator(device="cuda").manual_seed(12), "cuda",
                               dtype=torch.float32)
    out = {}
    for label, cache in RING_ENGINES.items():
        toks = [greedy_inline(InferenceEngine(cfg, EngineConfig(dtype="float32", **cache, **arm),
                                              params=params, seed=0, device="cuda"))
                for arm in (RING, {})]
        if toks[0] != toks[1]:
            fail(f"phase 12 (b) {label}: ring greedy tokens differ from ring-off in f32 at "
                 f"(request, step) {first_divergence(*toks)}")
        out[label] = sum(map(len, toks[0]))
    return out


def ring(card: str, params) -> dict:
    """Phase 12 on the llama3-8b bf16 weights at full depth: per cache (K1,
    K4) a ring engine and a ring-off one. Returns each kernel's launches
    from the ring engines' burst and early-out window."""
    cfg = get_config("llama3-8b")
    launches = {}
    for label, cache in RING_ENGINES.items():
        t0 = time.monotonic()
        eng = InferenceEngine(cfg, EngineConfig(**cache, **RING), params=params, seed=0,
                              device="cuda")
        init_s = time.monotonic() - t0
        if eng._ring_graphs is not None:
            fail(f"phase 12 (a) {label}: the engine captured before warmup built its kernel")
        t0 = time.monotonic()
        eng.warmup()
        warm_s = time.monotonic() - t0
        graphs = eng._ring_graphs
        print(f"phase 12 (a) capture {label} " + json.dumps(dict(
            card=card, fields=dict(cache, **RING), init_s=init_s, warmup_s=warm_s,
            chunk_sizes=sorted(graphs.capture_s), capture_s=graphs.capture_s,
            pool_bytes=graphs.pool_bytes, reserved_bytes=torch.cuda.memory_reserved())),
            flush=True)
        launches[label] = serve(label, eng, card, 12, run=f"{label} ring")
        off = InferenceEngine(cfg, EngineConfig(**cache), params=params, seed=0, device="cuda")
        off.warmup()
        on_toks, off_toks = greedy_inline(eng), greedy_inline(off)
        where = first_divergence(on_toks, off_toks)
        if where is not None:
            fail(f"phase 12 (b) {label}: ring greedy tokens differ from ring-off in bf16 at "
                 f"(request, step) {where}")
        print(f"phase 12 (b) {label} bf16 ring == ring-off greedy tokens "
              f"({sum(map(len, on_toks))} tokens)", flush=True)
        launches[label] += early_out(label, eng, card)
        if label == "K1":
            deadline_check(label, eng, card)
            windows = {"on": [], "off": []}
            for _ in range(RING_WINDOWS):
                windows["on"].append(busy_window(eng))
                windows["off"].append(busy_window(off))
            m, g = eng.metrics, eng._devloop.gate
            for arm, rows in windows.items():
                print(f"phase 12 (e) {label} ring {arm} host ms per decode step "
                      + json.dumps([r["host_ms_per_step"] for r in rows])
                      + " chunk device share " + json.dumps([r["chunk_device_share"] for r in rows])
                      + f" | {card}", flush=True)
            print(f"phase 12 (e) {label} ring books " + json.dumps(dict(
                ring_drains=m["ring_drains"], ring_full_stalls=m["ring_full_stalls"],
                early_exit_steps=m["early_exit_steps"], gate_state=m["decode_ring_gate_state"],
                gate=g.report(), windows=windows)) + f" | {card}", flush=True)
        eng.stop()
        off.stop()
        del eng, off, graphs
        gc.collect()
        torch.cuda.empty_cache()
    print("phase 12 (b) f32 identity ring == ring-off " + json.dumps(dict(
        card=card, model="llama3-1b width, 4 layers, f32",
        greedy_tokens=ring_f32_identity(card))), flush=True)
    return launches


# -- phase 7 ---------------------------------------------------------------

def tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def quantized_param_bytes(cfg) -> int:
    """Device bytes of a tree with int8 matmul weights, reckoned from the
    configuration: int8 projections and lm_head, their f32 scales, bf16
    embedding and norms."""
    L, D, F_, V = cfg.num_layers, cfg.hidden_size, cfg.ffn_hidden_size, cfg.vocab_size
    int8 = L * (2 * D * cfg.q_dim + 2 * D * cfg.kv_dim + 3 * D * F_) + D * V
    scales = 4 * (L * (cfg.q_dim + 2 * cfg.kv_dim + D + 2 * F_ + D) + V)
    bf16 = 2 * (V * D + 2 * L * D + D)
    return int8 + scales + bf16


def qdot_times(card: str) -> list:
    """Each mode's product and the bf16 torch.matmul, bf16 activations, at
    8 (a decode batch) and 1024 rows, for every projection shape of
    llama3-8b and llama3-70b: the median of three rounds taken in turns,
    each the median of TIMED_LAUNCHES calls with the L2 flushed, beside
    the int8 weight-byte bound and the operations bound."""
    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(21)
    rows = []
    for model, shapes in QDOT_SHAPES.items():
        for K, N in shapes:
            w = torch.randn((K, N), generator=gen, device="cuda", dtype=torch.bfloat16).mul_(0.02)
            qw = {mode: quant.quantize_weight(w, mode) for mode in quant.QUANT_MODES}
            for M in (8, 1024):
                h = torch.randn((M, K), generator=gen, device="cuda", dtype=torch.bfloat16)
                calls = {"bf16": lambda: torch.matmul(h, w),
                         "int8": lambda: quant.qdot(h, qw["int8"]),
                         "int8-dynamic": lambda: quant.qdot(h, qw["int8-dynamic"])}
                times = {k: [] for k in calls}
                for _ in range(ROUNDS):
                    for k, fn in calls.items():
                        times[k].append(time_ms(fn, flush))
                ops = 2 * M * K * N
                row = dict(card=card, model=model, K=K, N=N, M=M,
                           **{f"{k}_ms": statistics.median(t) for k, t in times.items()},
                           int8_weight_bound_ms=K * N / HBM_BYTES_PER_S * 1e3,
                           bf16_weight_bound_ms=2 * K * N / HBM_BYTES_PER_S * 1e3,
                           bf16_ops_bound_ms=ops / PEAK_OPS[torch.bfloat16] * 1e3,
                           int8_ops_bound_ms=ops / PEAK_OPS[torch.int8] * 1e3)
                rows.append(row)
                print(f"qdot {model} [{K}, {N}] M={M}: bf16 {row['bf16_ms']:.4f} ms, "
                      f"int8 (W8A16) {row['int8_ms']:.4f} ms, int8-dynamic (W8A8) "
                      f"{row['int8-dynamic_ms']:.4f} ms; int8 weight-byte bound "
                      f"{row['int8_weight_bound_ms']:.4f} ms", flush=True)
            del w, qw
    print("qdot times " + json.dumps(rows), flush=True)
    return rows


def serve_70b(card: str) -> int:
    """llama3-70b at full width and depth with W8A16 weights born quantized
    on the card, the default contiguous bf16 KV cache (K1), 8 slots,
    max_seq 1024: the burst through submit(). Returns K1's launches."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config("llama3-70b")
    t0 = time.monotonic()
    engine = InferenceEngine(cfg, EngineConfig(quant="int8"), seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    got, want = tree_bytes(engine.params), quantized_param_bytes(cfg)
    if abs(got - want) > 0.01 * want:
        fail(f"llama3-70b int8 params hold {got} device bytes, reckoned {want}")
    prompt = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (1, 17)))
    logits, _, _ = llama.forward_prefill(engine.params, cfg, prompt.cuda(),
                                         torch.arange(17, dtype=torch.int32, device="cuda")[None])
    if not torch.isfinite(logits).all():
        fail("llama3-70b int8: the first prefill's logits are not finite")
    del logits
    t0 = time.monotonic()
    engine.warmup()
    setup = dict(card=card, params_device_bytes=got, params_reckoned_bytes=want,
                 kv_device_bytes=engine.metrics["kv_quant_device_bytes"], init_s=init_s,
                 warmup_s=time.monotonic() - t0,
                 peak_mem_gb_after_warmup=torch.cuda.max_memory_allocated() / 1e9,
                 card_mem_gb=torch.cuda.get_device_properties(0).total_memory / 1e9)
    print("engine K1 llama3-70b int8 setup " + json.dumps(setup), flush=True)
    launches = serve("K1", engine, card, BURST_70B, run="K1 llama3-70b int8")
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def serve_w8a8(card: str) -> int:
    """llama3-8b with W8A8 weights, the int8 KV cache and the paged one
    (K4): the burst, then greedy tokens equal to a contiguous int8-KV
    engine's (K2) on the same weights. Returns K4's launches."""
    cfg = get_config("llama3-8b")
    fields = dict(quant="int8-dynamic", kv_quant="int8")
    t0 = time.monotonic()
    engine = InferenceEngine(cfg, EngineConfig(**fields, **PAGED), seed=0, device="cuda")
    engine.warmup()
    print(f"engine K4 llama3-8b int8-dynamic {fields} {PAGED}: init + warmup "
          f"{time.monotonic() - t0:.1f}s", flush=True)
    launches = serve("K4", engine, card, 12, run="K4 llama3-8b int8-dynamic")
    paged = greedy_inline(engine)
    params = engine.params
    del engine
    contiguous = greedy_inline(InferenceEngine(cfg, EngineConfig(**fields), params=params,
                                               device="cuda"))
    if paged != contiguous:
        fail("llama3-8b int8-dynamic: greedy tokens of the K4 (paged) engine differ from "
             "the K2 (contiguous) engine's")
    print(f"greedy equality: int8-dynamic weights, paged (K4) == contiguous (K2), "
          f"{sum(map(len, paged))} tokens", flush=True)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def provider_path(card: str) -> None:
    """A llama3-1b-width checkpoint cut to 2 layers, written by the port's
    save_params in 512 MiB shards, built by build_engine with quant="int8":
    the same int8 tree, and the same greedy tokens, as an engine that
    quantized the same bf16 params in memory."""
    cfg = get_config("llama3-1b", num_layers=2)
    params = llama.init_params(cfg, torch.Generator(device="cuda").manual_seed(5), "cuda")
    tmp = tempfile.mkdtemp(prefix="omnia_ckpt_")
    try:
        t0 = time.monotonic()
        ckpt_io.save_params(params, cfg, tmp, max_shard_bytes=512 * 2**20)
        save_s = time.monotonic() - t0
        files = sorted(f for f in os.listdir(tmp) if f.endswith(".safetensors"))
        disk = sum(os.path.getsize(os.path.join(tmp, f)) for f in files)
        spec = ProviderSpec(name="ckpt", model="llama3-1b-2l",
                            options={"checkpoint_path": tmp, "quant": "int8"})
        t0 = time.monotonic()
        built = build_engine(spec, device="cuda")
        torch.cuda.synchronize()
        build_s = time.monotonic() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    memory = InferenceEngine(built.model_cfg, EngineConfig(quant="int8"), params=params,
                             device="cuda")

    mem = dict(leaves(memory.params))
    for path, t in leaves(built.params):
        if t.dtype != mem[path].dtype or not torch.equal(t, mem[path]):
            fail(f"provider path: {path} of the checkpoint-built tree differs from the "
                 f"in-memory quantized one")
    a, b = greedy_inline(built), greedy_inline(memory)
    if a != b:
        fail("provider path: greedy tokens of the checkpoint-built engine differ from the "
             "in-memory quantized engine's")
    print("provider path " + json.dumps(dict(
        card=card, model=built.model_cfg.name, layers=cfg.num_layers, shards=len(files),
        checkpoint_bytes=disk, save_s=save_s, build_s=build_s,
        params_device_bytes=tree_bytes(built.params), greedy_tokens=sum(map(len, a)),
        trees_equal=True, tokens_equal=True)), flush=True)


# -- phase 10 --------------------------------------------------------------

def kept(top_i: np.ndarray, num_experts: int, capacity: int) -> np.ndarray:
    """Which (row, k) assignments of a capacity dispatch keep their
    expert: stable by row within each expert, the first ``capacity``."""
    flat = top_i.reshape(-1)
    order = np.argsort(flat, kind="stable")
    counts = np.bincount(flat, minlength=num_experts)
    pos = np.empty_like(flat)
    pos[order] = np.arange(flat.size) - (np.cumsum(counts) - counts)[flat[order]]
    return (pos < capacity).reshape(top_i.shape)


def moe_check(card: str) -> None:
    """Phase 10 (a): one MoE layer at Mixtral width (D 4096, F 14336, E 8,
    K 2) on the card against the CPU on the same inputs, at 8 rows (all
    experts) and 1024 (capacity dispatch, drops). f32 with TF32 off:
    top experts and kept assignments equal, outputs within 1e-4 of the
    largest. bf16: routing equal on the rows whose K-th and (K+1)-th
    logits are more than one bf16 step apart, and outputs within 2^-6 of
    the largest on the rows whose experts and kept assignments agree."""
    from omnia_tpu_torch.ops import moe

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("mixtral-8x7b")
    D, F_, E, K = cfg.hidden_size, cfg.ffn_hidden_size, cfg.num_experts, cfg.num_experts_per_tok
    gen = torch.Generator(device="cuda").manual_seed(10)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device="cuda").mul_(0.02)

    layer = {"router": normal(D, E), "wg": normal(E, D, F_), "wu": normal(E, D, F_),
             "wd": normal(E, F_, D)}
    layer["router"][:, 0].abs_()
    rows = []
    for n in MOE_ROWS:
        h = torch.randn((1, n, D), generator=gen, device="cuda").add_(MOE_H_MEAN)
        capacity = max(1, int(-(-n * K * 2.0 // E)))
        for dtype in (torch.float32, torch.bfloat16):
            p = {k: v.to(dtype) for k, v in layer.items()}
            x = h.to(dtype)
            t0 = time.monotonic()
            card_out = moe.moe_mlp(x, p, K).float().cpu()
            card_i = moe.route_sparse(x, p["router"], K)[1].cpu().numpy()[0]
            torch.cuda.synchronize()
            card_s = time.monotonic() - t0
            cpu_p = {k: v.cpu() for k, v in p.items()}
            t0 = time.monotonic()
            cpu_out = moe.moe_mlp(x.cpu(), cpu_p, K).float()
            cpu_s = time.monotonic() - t0
            cpu_i = moe.route_sparse(x.cpu(), cpu_p["router"], K)[1].numpy()[0]
            logits = torch.sort(torch.matmul(x.cpu(), cpu_p["router"]).float()[0], dim=-1,
                                descending=True).values
            what = f"moe {n} rows {dtype}"
            dispatch = n >= moe.DISPATCH_MIN_TOKENS
            cpu_kept = kept(cpu_i, E, capacity) if dispatch else np.ones_like(cpu_i, bool)
            card_kept = kept(card_i, E, capacity) if dispatch else np.ones_like(card_i, bool)
            drops = int((~cpu_kept).sum())
            if dispatch and drops == 0:
                fail(f"{what}: the skewed router dropped no assignment")
            if not dispatch and drops:
                fail(f"{what}: the all-expert path dropped {drops} assignments")
            scale = cpu_out.abs().max().item()
            if dtype == torch.float32:
                clear = np.ones(n, bool)
                if not (np.array_equal(card_i, cpu_i) and np.array_equal(card_kept, cpu_kept)):
                    fail(f"{what}: routing or kept assignments differ between card and CPU")
                same, tol = clear, 1e-4
            else:
                step = 2.0 ** -7 * logits[:, K - 1:K + 1].abs().max(dim=-1).values
                clear = (logits[:, K - 1] - logits[:, K] > step).numpy()
                if not np.array_equal(card_i[clear], cpu_i[clear]):
                    fail(f"{what}: routing differs on rows with no tie within a bf16 step")
                same = (card_i == cpu_i).all(-1) & (card_kept == cpu_kept).all(-1)
                tol = 2.0 ** -6
            sel = torch.from_numpy(same)
            rel = ((card_out[0][sel] - cpu_out[0][sel]).abs().max() / scale).item()
            if not torch.isfinite(card_out).all() or rel > tol:
                fail(f"{what}: card vs CPU max error {rel} of the largest output (tolerance {tol})")
            row = dict(card=card, rows=n, dtype=str(dtype).removeprefix("torch."),
                       path="dispatch" if dispatch else "all-expert", capacity=capacity,
                       dropped_assignments=drops, rows_compared=int(same.sum()),
                       rows_without_tie=int(clear.sum()), max_err_of_largest=rel,
                       tolerance=tol, card_s=card_s, cpu_s=cpu_s)
            rows.append(row)
            print("moe check " + json.dumps(row), flush=True)
    del layer
    gc.collect()
    torch.cuda.empty_cache()


def moe_provider_path(card: str) -> None:
    """Phase 10 (d): a Mixtral-width checkpoint cut to 1 layer, written by
    save_params in 1 GiB shards and built by build_engine, gives the
    in-memory bf16 tree bit for bit and the same greedy tokens."""
    cfg = get_config("mixtral-8x7b", num_layers=MOE_CKPT_LAYERS)
    if ckpt_io.expected_param_bytes(cfg) != MOE_CKPT_BYTES:
        fail(f"mixtral 1 layer: {ckpt_io.expected_param_bytes(cfg)} bytes reckoned, "
             f"expected {MOE_CKPT_BYTES}")
    params = llama.init_params(cfg, torch.Generator(device="cuda").manual_seed(8), "cuda")
    tmp = tempfile.mkdtemp(prefix="omnia_moe_ckpt_")
    try:
        t0 = time.monotonic()
        ckpt_io.save_params(params, cfg, tmp, max_shard_bytes=2**30)
        save_s = time.monotonic() - t0
        files = sorted(f for f in os.listdir(tmp) if f.endswith(".safetensors"))
        disk = sum(os.path.getsize(os.path.join(tmp, f)) for f in files)
        spec = ProviderSpec(name="moe-ckpt", model="mixtral-8x7b-1l",
                            options={"checkpoint_path": tmp})
        t0 = time.monotonic()
        built = build_engine(spec, device="cuda")
        torch.cuda.synchronize()
        build_s = time.monotonic() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    memory = InferenceEngine(built.model_cfg, EngineConfig(), params=params, device="cuda")

    mem = dict(leaves(params))
    got = dict(leaves(built.params))
    if set(got) != set(mem):
        fail(f"moe provider path: leaves {sorted(got)} != {sorted(mem)}")
    for path, t in got.items():
        if t.dtype != mem[path].dtype or not torch.equal(t, mem[path]):
            fail(f"moe provider path: {path} of the checkpoint-built tree differs from the "
                 f"in-memory one")
    a, b = greedy_inline(built), greedy_inline(memory)
    if a != b:
        fail("moe provider path: greedy tokens of the checkpoint-built engine differ from the "
             "in-memory engine's")
    print("moe provider path " + json.dumps(dict(
        card=card, model=built.model_cfg.name, layers=cfg.num_layers, shards=len(files),
        checkpoint_bytes=disk, params_bytes=tree_bytes(built.params),
        params_reckoned_bytes=MOE_CKPT_BYTES, save_s=save_s, build_s=build_s,
        greedy_tokens=sum(map(len, a)), trees_equal=True, tokens_equal=True)), flush=True)
    del built, memory, params
    gc.collect()
    torch.cuda.empty_cache()


def mixtral(card: str) -> dict:
    """Phase 10: the MoE layer on the card against the CPU (a);
    mixtral-8x7b at full width, MOE_LAYERS layers, bf16 random weights drawn on
    the card, serving the burst on the default engine (K1) and the int8 +
    paged one (K4) (b); the paged bf16 engine's (K3) greedy tokens equal
    to the contiguous one's (c); the provider path (d). Returns each
    kernel's launches."""
    moe_check(card)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config("mixtral-8x7b", num_layers=MOE_LAYERS)
    want = ckpt_io.expected_param_bytes(cfg)
    if want != MOE_PARAM_BYTES or cfg.num_params() * 2 != want:
        fail(f"mixtral L={MOE_LAYERS}: reckoned {want} and {cfg.num_params() * 2} bytes, "
             f"expected {MOE_PARAM_BYTES}")
    t0 = time.monotonic()
    engine = InferenceEngine(cfg, EngineConfig(), seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    got = tree_bytes(engine.params)
    if got != want:
        fail(f"mixtral L={MOE_LAYERS} params hold {got} device bytes, reckoned {want}")
    prompt = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (1, 17)))
    logits, _, _ = llama.forward_prefill(engine.params, cfg, prompt.cuda(),
                                         torch.arange(17, dtype=torch.int32, device="cuda")[None])
    if not torch.isfinite(logits).all():
        fail("mixtral: the first prefill's logits are not finite")
    del logits
    t0 = time.monotonic()
    engine.warmup()
    # A decode step reads every weight but the embedding (one row per slot).
    step_bytes = got - engine.params["embed"].numel() * engine.params["embed"].element_size()
    setup = dict(card=card, layers=cfg.num_layers, params_device_bytes=got,
                 params_reckoned_bytes=want, decode_step_weight_bytes=step_bytes,
                 decode_step_weight_bound_ms=step_bytes / HBM_BYTES_PER_S * 1e3,
                 kv_device_bytes=engine.metrics["kv_quant_device_bytes"], init_s=init_s,
                 warmup_s=time.monotonic() - t0,
                 peak_mem_gb_after_warmup=torch.cuda.max_memory_allocated() / 1e9,
                 card_mem_gb=torch.cuda.get_device_properties(0).total_memory / 1e9)
    print("engine K1 mixtral-8x7b setup " + json.dumps(setup), flush=True)
    run = f"mixtral-8x7b L={cfg.num_layers}"
    launches = {"K1": serve("K1", engine, card, 12, run=f"K1 {run}")}
    decode_profile(f"K1 {run}", engine, card)
    contiguous = greedy_inline(engine)
    params = engine.params
    del engine
    gc.collect()
    torch.cuda.empty_cache()

    paged = InferenceEngine(cfg, EngineConfig(**PAGED), params=params, seed=0, device="cuda")
    tokens, launches["K3"] = checked_launches("K3", paged, lambda: greedy_inline(paged))
    m = paged.metrics
    if m["kv_pages_free"] != m["kv_pages_total"]:
        fail(f"K3 {run}: {m['kv_pages_free']} of {m['kv_pages_total']} pages free")
    if tokens != contiguous:
        fail(f"{run}: greedy tokens of the K3 (paged) engine differ from the K1 (contiguous) "
             "engine's")
    print(f"greedy equality: {run} paged (K3) == contiguous (K1), "
          f"{sum(map(len, tokens))} tokens", flush=True)
    del paged
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.monotonic()
    engine = InferenceEngine(cfg, EngineConfig(kv_quant="int8", **PAGED), params=params, seed=0,
                             device="cuda")
    engine.warmup()
    print(f"engine K4 {run} kv_quant=int8 {PAGED}: init + warmup "
          f"{time.monotonic() - t0:.1f}s", flush=True)
    launches["K4"] = serve("K4", engine, card, 12, run=f"K4 {run}")
    del engine, params
    gc.collect()
    torch.cuda.empty_cache()
    moe_provider_path(card)
    return launches


# -- phase 11 --------------------------------------------------------------

def ops_spec(ckpt: str, threads: int, **fields) -> ProviderSpec:
    return ProviderSpec(name="ops", model="llama3-8b",
                        options=dict(checkpoint_path=ckpt, warmup_threads=threads, **OPS,
                                     **fields))


def cold_start(ckpt: str, threads: int, card: str, cold_build: bool = False, **fields):
    """One start through the provider path, as the runtime's bring-up
    does it: the engine and its tracker, its seconds per phase and from
    backend_init to ready. With ``cold_build`` K1's library is built
    anew into an empty build directory during the start. The param-free
    side thread's own start and end, and each kernel build's thread and
    seconds, are stamped. Returns the engine and submit-to-ready."""
    lib = KERNELS["K1"][0]
    stamps, builds = {}, []
    paramfree, build, build_dir = InferenceEngine._warmup_paramfree, kernels.build, \
        kernels.BUILD_DIR

    def stamped(self):
        stamps["start"] = time.monotonic()
        try:
            paramfree(self)
        finally:
            stamps["end"] = time.monotonic()

    def timed_build(name):
        t0 = time.monotonic()
        out = build(name)
        builds.append(dict(name=name, thread=threading.current_thread().name,
                           start=t0, seconds=time.monotonic() - t0))
        return out

    if cold_build:
        kernels.BUILD_DIR = Path(tempfile.mkdtemp(prefix="omnia_ops_build_"))
        kernels._loaded.pop(lib, None)
    built_before = kernels.library_path(lib).is_file()
    InferenceEngine._warmup_paramfree, kernels.build = stamped, timed_build
    tracker = ColdStartTracker()
    try:
        t0 = time.monotonic()
        tracker.begin_phase("backend_init")
        engine = build_engine(ops_spec(ckpt, threads, **fields), device="cuda",
                              coldstart=tracker)
        engine.warmup()
        engine.start()
        tracker.mark_ready()
        ready_s = time.monotonic() - t0
    finally:
        InferenceEngine._warmup_paramfree, kernels.build = paramfree, build
        if cold_build:
            shutil.rmtree(kernels.BUILD_DIR, ignore_errors=True)
            kernels.BUILD_DIR = build_dir
    engine.stop()
    snap = tracker.snapshot()
    m = engine.metrics
    run = f"cold start N={threads}"
    if not m["weights_bytes_loaded"] == m["weights_bytes_total"] == OPS_CKPT_BYTES:
        fail(f"{run}: weights {m['weights_bytes_loaded']} of "
             f"{m['weights_bytes_total']} bytes loaded, expected {OPS_CKPT_BYTES}")
    if m["warmup_programs_done"] != m["warmup_programs_total"] or not m["warmup_programs_total"]:
        fail(f"{run}: {m['warmup_programs_done']} of "
             f"{m['warmup_programs_total']} warmup programs done")
    load = engine._flight.events("weights_load")[-1]
    load_span = (load.mono - load.attrs["seconds"], load.mono)
    side_inside = bool(stamps) and load_span[0] <= stamps["start"] <= stamps["end"] <= load_span[1]
    if bool(stamps) != (threads > 0) or (threads > 0 and not side_inside):
        fail(f"{run}: the param-free side thread ran {stamps or 'not at all'}, "
             f"weights_load {load_span}")
    if cold_build:
        where = "omnia-warmup-overlap" if threads > 0 else "MainThread"
        if built_before or [(b["name"], b["thread"]) for b in builds] != [(lib, where)]:
            fail(f"{run}: K1's library built before the start: {built_before}; "
                 f"builds {builds}, expected one of {lib} on {where}")
    print("cold start " + json.dumps(dict(
        card=card, warmup_threads=threads, fields=fields, phases_s=snap["phases_s"],
        submit_to_ready_s=ready_s, programs=m["warmup_programs_total"],
        manifest_hits=m["warmup_manifest_hits"], manifest_misses=m["warmup_manifest_misses"],
        kernel_library_built_before_start=built_before,
        kernel_builds=[dict(name=b["name"], thread=b["thread"], seconds=b["seconds"],
                            after_weights_load_began_s=b["start"] - load_span[0])
                       for b in builds],
        side_thread_s=stamps["end"] - stamps["start"] if stamps else None,
        side_thread_inside_weights_load=side_inside,
        weights_bytes=m["weights_bytes_loaded"],
        params_device_bytes=tree_bytes(engine.params),
        checkpoint_read_from="the page cache: the file was written just before")), flush=True)
    return engine, ready_s


def flight_checks(run: str, engine, burst_wall_s: float, recorder_s: float,
                  card: str) -> None:
    """Phase 11 (b) on one engine after its burst: the event ledger equals
    the engine's books, every request's stages tile its wall within 5%,
    only the closed vocabulary occurs and the ring's Chrome export parses;
    prints the TTFT split and the recorder's own share of the wall."""
    rec, m = engine._flight, engine.metrics
    evs = rec.events()
    if rec.stats()["dropped"]:
        fail(f"{run}: the flight ring dropped {rec.stats()['dropped']} events")
    kinds = {e.kind for e in evs}
    if not kinds <= EVENTS:
        fail(f"{run}: flight kinds outside the vocabulary: {sorted(kinds - EVENTS)}")
    submits, terms = rec.events("submit"), rec.events("terminal")
    if len(submits) != m["requests_submitted"] or len(terms) != m["requests_finished"]:
        fail(f"{run}: {len(submits)} submit and {len(terms)} terminal events against "
             f"{m['requests_submitted']} submitted and {m['requests_finished']} finished")
    sub_at = {e.request_id: e.mono for e in submits}
    worst = 0.0
    for e in terms:
        bd = e.attrs["breakdown"]
        wall = e.mono - sub_at[e.request_id]
        staged = bd["queue_s"] + bd["placement_s"] + bd["decode_s"]
        worst = max(worst, abs(staged - wall) / wall)
    if worst > 0.05:
        fail(f"{run}: a request's queue + placement + decode is {worst:.1%} off its wall")
    doc = json.loads(json.dumps(to_chrome_trace(evs)))
    if not doc["traceEvents"] or any("ph" not in ev for ev in doc["traceEvents"]):
        fail(f"{run}: the Chrome-trace export is malformed")
    burst = [e.attrs["breakdown"] for e in terms[-12:]]

    def split(key):
        vals = [b[key] * 1e3 for b in burst]
        return {"p50": float(np.percentile(vals, 50)), "p99": float(np.percentile(vals, 99))}

    print(f"flight {run} " + json.dumps(dict(
        card=card, events=len(evs), kinds=sorted(kinds), terminals=len(terms),
        worst_tiling_error=worst, ttft_ms=split("ttft_s"), queue_ms=split("queue_s"),
        placement_ms=split("placement_s"), prefill_ms=split("prefill_s"),
        recorder_s=recorder_s, burst_wall_s=burst_wall_s,
        recorder_share_of_wall=recorder_s / burst_wall_s,
        chrome_trace_events=len(doc["traceEvents"]))), flush=True)


def timed_recorder(rec) -> dict:
    """Wrap every note_* of one recorder with a timer, as the JAX bench
    does: the recorder's own time, summed per call."""
    acc = {"s": 0.0, "calls": 0}
    for name in dir(rec):
        if name.startswith("note_"):
            def wrapped(*a, _orig=getattr(rec, name), **k):
                t0 = time.perf_counter()
                try:
                    return _orig(*a, **k)
                finally:
                    acc["s"] += time.perf_counter() - t0
                    acc["calls"] += 1

            setattr(rec, name, wrapped)
    return acc


def chunk_read_us(engine, reads: int = 2000) -> float:
    """Host microseconds of one decode-chunk read through the engine's
    seam, on a chunk whose copy has already run: the watchdog's drainer
    hand-off with watchdog_s set, the direct wait without it."""
    toks = torch.zeros((engine.cfg.decode_chunk, engine.cfg.num_slots), dtype=torch.int32,
                       device="cuda")
    ch = _InflightChunk(toks, [], 0.0)
    torch.cuda.synchronize()
    engine._sync_chunk_host(ch)           # the drainer thread is up
    t0 = time.perf_counter()
    for _ in range(reads):
        engine._sync_chunk_host(ch)
    return (time.perf_counter() - t0) / reads * 1e6


def pinned_reuse_check() -> None:
    """Fails unless the caching host allocator keeps a freed pinned
    buffer from reuse while a non-blocking copy into it is still queued
    (what makes recovery's drop of in-flight chunks safe), or if the copy
    had already run when the buffer was freed (the check then shows
    nothing)."""
    src = torch.zeros(1 << 20, dtype=torch.int32, device="cuda")
    torch.cuda._sleep(40 * SPIN_CYCLES)
    host = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
    host.copy_(src, non_blocking=True)
    copied = torch.cuda.Event()
    copied.record()
    first = host.data_ptr()
    del host
    again = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
    queued = not copied.query()
    reused_early = again.data_ptr() == first
    torch.cuda.synchronize()
    if not queued:
        fail("pinned-buffer check: the copy had run before the buffer was freed")
    if reused_early:
        fail("a freed pinned buffer was reused while its non-blocking copy was queued")
    print("pinned host buffer kept from reuse while its copy was queued: True", flush=True)


def fault_run(run: str, engine, label: str, want_greedy: list, card: str) -> int:
    """Phase 11 (c): with the fault plan set, 8 greedy submits, of which 2
    raise; the one hang trips the watchdog between watchdog_s and
    watchdog_s + OPS_TRIP_LATE_S after the read began, the requests in
    flight end ERROR with their streamed counts, recovery reallocates
    the KV caches and health returns; then the inline greedy requests
    give the tokens they gave before. Returns the kernel's launches."""
    plan = FaultPlan(**OPS_FAULTS)
    engine._fault_plan = plan
    trips, recover_s = [], []
    sync, recover = engine._sync_chunk_host, engine._recover

    def timed_sync(ch):
        t0 = time.monotonic()
        try:
            return sync(ch)
        except WatchdogTimeout:
            trips.append(time.monotonic() - t0)
            raise

    def timed_recover(msg):
        t0 = time.monotonic()
        recover(msg)
        recover_s.append(time.monotonic() - t0)

    engine._sync_chunk_host, engine._recover = timed_sync, timed_recover
    m0 = dict(engine.metrics)
    rng = np.random.default_rng(13)

    def serve_faulted():
        engine.start()
        raised, handles = 0, []
        for n in (17, 64, 130, 300, 511, 700, 45, 900):
            try:
                handles.append(engine.submit(
                    [int(t) for t in rng.integers(0, engine.model_cfg.vocab_size, n)],
                    SamplingParams(temperature=0.0, max_tokens=48)))
            except RuntimeError:
                raised += 1
        results = [h.collect_tokens(timeout=120) for h in handles]
        deadline = time.monotonic() + 10
        while not engine.healthy() and time.monotonic() < deadline:
            time.sleep(0.01)
        engine.stop()
        return raised, results

    (raised, results), launches = checked_launches(label, engine, serve_faulted, run)
    engine._fault_plan = None
    engine._sync_chunk_host, engine._recover = sync, recover
    m = engine.metrics
    errors = 0
    for toks, fin in results:
        if fin.finish_reason == FinishReason.ERROR:
            errors += 1
            if fin.num_generated_tokens != len(toks):
                fail(f"{run}: an ERROR partial counts {fin.num_generated_tokens} tokens, "
                     f"streamed {len(toks)}")
        elif fin.finish_reason not in (FinishReason.LENGTH, FinishReason.STOP):
            fail(f"{run}: a request ended {fin.finish_reason}")
    trips_n = m["watchdog_trips"] - m0["watchdog_trips"]
    recoveries = m["recoveries"] - m0["recoveries"]
    if raised != OPS_FAULTS["flaky_submit"] or plan.fired["submit_faults"] != raised:
        fail(f"{run}: {raised} submits raised, plan fired {plan.fired}")
    if trips_n != 1 or recoveries != 1 or plan.fired["hangs"] != 1 or errors < 1:
        fail(f"{run}: {trips_n} trips, {recoveries} recoveries, {errors} ERROR requests, "
             f"plan fired {plan.fired}")
    if not engine.healthy():
        fail(f"{run}: the engine is not healthy after the recovery")
    wd = engine.cfg.watchdog_s
    if not (len(trips) == 1 and wd <= trips[0] <= wd + OPS_TRIP_LATE_S):
        fail(f"{run}: the trip came {trips} s after the read began (watchdog_s {wd})")
    if m["requests_finished"] != m["requests_submitted"]:
        fail(f"{run}: {m['requests_finished']} finished of {m['requests_submitted']} submitted")
    if engine.cfg.kv_pages and m["kv_pages_free"] != m["kv_pages_total"]:
        fail(f"{run}: {m['kv_pages_free']} of {m['kv_pages_total']} pages free after recovery")
    greedy, n = checked_launches(label, engine, lambda: greedy_inline(engine), run)
    if greedy != want_greedy:
        fail(f"{run}: greedy tokens after the recovery differ from before the fault")
    print(f"faults {run} " + json.dumps(dict(
        card=card, submits_raised=raised, trips=trips_n, trip_after_s=trips[0],
        watchdog_s=wd, recoveries=recoveries, error_requests=errors,
        served_requests=len(results) - errors, recovery_ms=recover_s[0] * 1e3,
        kv_device_bytes=m["kv_quant_device_bytes"], healthy=engine.healthy(),
        plan_fired=plan.fired, greedy_tokens_equal=True)), flush=True)
    return launches + n


def ops_layer(card: str) -> dict:
    """Phase 11: llama3-8b at full width, its first OPS_LAYERS layers,
    started from a checkpoint through build_engine with the operations layer on. (a)
    Two cold starts, warmup_threads 0 then 2; (b) the flight recorder
    over the burst on K1 and on int8 + paged (K4), the recorder's cost;
    (c) the watchdog and faults on each. Returns each kernel's launches."""
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config("llama3-8b", num_layers=OPS_LAYERS)
    want = ckpt_io.expected_param_bytes(cfg)
    if want != OPS_CKPT_BYTES or cfg.num_params() * 2 != want:
        fail(f"llama3-8b, {OPS_LAYERS} layers: reckoned {want} and {cfg.num_params() * 2} "
             f"bytes, expected {OPS_CKPT_BYTES}")
    tmp = tempfile.mkdtemp(prefix="omnia_ops_ckpt_")
    manifests = tempfile.mkdtemp(prefix="omnia_ops_manifest_")
    os.environ["OMNIA_WARMUP_MANIFEST_DIR"] = manifests
    launches = {"K1": 0, "K4": 0}
    try:
        free = shutil.disk_usage(tmp).free
        if free < OPS_MIN_FREE_DISK:
            fail(f"phase 11 needs {OPS_MIN_FREE_DISK / 1e9:.0f} GB of free disk for the "
                 f"checkpoint, {tmp} has {free / 1e9:.1f} GB")
        params = llama.init_params(cfg, torch.Generator(device="cuda").manual_seed(11), "cuda")
        t0 = time.monotonic()
        ckpt_io.save_params(params, cfg, tmp, max_shard_bytes=4 * 2**30)
        print(f"ops checkpoint llama3-8b bf16, {OPS_LAYERS} layers: {want} bytes saved in "
              f"{time.monotonic() - t0:.1f}s to a disk with {free / 1e9:.1f} GB free",
              flush=True)
        del params
        gc.collect()
        torch.cuda.empty_cache()

        # (a) Two starts, each building K1's library anew: the build in
        # warmup, then on the side thread beside the weights' stream.
        greedy, ready = [], []
        for threads in OPS_STARTS:
            engine, ready_s = cold_start(tmp, threads, card, cold_build=True)
            ready.append(ready_s)
            out, n = checked_launches("K1", engine, lambda: greedy_inline(engine),
                                      f"K1 start N={threads}")
            greedy.append(out)
            launches["K1"] += n
            if threads != OPS_STARTS[-1]:
                del engine
                gc.collect()
                torch.cuda.empty_cache()
        if engine.metrics["warmup_manifest_misses"] or not engine.metrics["warmup_manifest_hits"]:
            fail("the second start did not find the first's warmup manifest: "
                 f"{engine.metrics['warmup_manifest_misses']} misses")
        if greedy[0] != greedy[1]:
            fail("the two starts' inline greedy tokens differ")
        print("cold start overlap " + json.dumps(dict(
            card=card, warmup_threads=OPS_STARTS, submit_to_ready_s=ready,
            saved_s=ready[0] - ready[1])), flush=True)

        # (b) The flight recorder over the burst, and its cost and the
        # watchdog's: decode windows in turns on this engine (recorder
        # and watchdog), one with the watchdog only, and one with neither.
        acc = timed_recorder(engine._flight)
        t0 = time.monotonic()
        launches["K1"] += serve("K1", engine, card, 12, run="K1 llama3-8b ops")
        flight_checks("K1", engine, time.monotonic() - t0, acc["s"], card)
        arms = {"both": engine}
        for key, ecfg in (("watchdog", EngineConfig(watchdog_s=OPS["watchdog_s"])),
                          ("neither", EngineConfig())):
            arms[key] = InferenceEngine(engine.model_cfg, ecfg, params=engine.params, seed=0,
                                        device="cuda")
            arms[key].warmup()
        step_ms = {key: [] for key in arms}
        wd = arms["watchdog"]
        reads, sync = [0], wd._sync_chunk_host

        def counted(ch):
            reads[0] += 1
            return sync(ch)

        wd._sync_chunk_host, steps0 = counted, wd.metrics["decode_steps"]
        for key in ("both", "watchdog", "neither", "neither", "watchdog", "both",
                    "watchdog", "both", "neither"):
            e = arms[key]
            ms, n = checked_launches("K1", e, lambda: decode_window(e), f"K1 window {key}")
            step_ms[key].append(ms)
            launches["K1"] += n
        wd._sync_chunk_host = sync
        reads_per_step = reads[0] / (wd.metrics["decode_steps"] - steps0)
        # The seam alone, in turns: the hand-off against the direct wait.
        read_us = {"watchdog": [], "neither": []}
        for key in ("watchdog", "neither", "neither", "watchdog", "watchdog", "neither"):
            read_us[key].append(chunk_read_us(arms[key]))
        del arms, e, wd
        med = {key: statistics.median(v) for key, v in step_ms.items()}
        handoff_us = statistics.median(read_us["watchdog"]) - statistics.median(read_us["neither"])
        print("flight recorder and watchdog decode windows " + json.dumps(dict(
            card=card, ms_per_step=step_ms, median_ms_per_step=med,
            recorder_ms_per_step=med["both"] - med["watchdog"],
            watchdog_ms_per_step=med["watchdog"] - med["neither"],
            spread_ms={key: max(v) - min(v) for key, v in step_ms.items()},
            chunk_read_us=read_us, watchdog_handoff_us_per_read=handoff_us,
            chunk_reads_per_decode_step=reads_per_step,
            watchdog_handoff_ms_per_step=handoff_us * reads_per_step / 1e3)), flush=True)

        # (c) The watchdog and faults on K1; the pinned-buffer rule.
        pinned_reuse_check()
        launches["K1"] += fault_run("K1 llama3-8b ops", engine, "K1", greedy[0], card)
        if engine.metrics["kv_quant_device_bytes"] != OPS_KV_BYTES:
            fail(f"K1 KV bytes {engine.metrics['kv_quant_device_bytes']}, "
                 f"expected {OPS_KV_BYTES}")
        del engine
        gc.collect()
        torch.cuda.empty_cache()

        # (b) and (c) on int8 + paged (K4), built the same way.
        engine, _ = cold_start(tmp, OPS_STARTS[-1], card, kv_quant="int8", **PAGED)
        acc = timed_recorder(engine._flight)
        t0 = time.monotonic()
        launches["K4"] += serve("K4", engine, card, 12, run="K4 llama3-8b ops")
        flight_checks("K4", engine, time.monotonic() - t0, acc["s"], card)
        before, n = checked_launches("K4", engine, lambda: greedy_inline(engine), "K4 ops")
        launches["K4"] += n
        launches["K4"] += fault_run("K4 llama3-8b ops", engine, "K4", before, card)
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        shutil.rmtree(manifests, ignore_errors=True)
        os.environ.pop("OMNIA_WARMUP_MANIFEST_DIR", None)
    return launches


# -- phase 13 --------------------------------------------------------------

TRAIN_PARAMS = 1_498_482_688               # llama3-1b
TRAIN_STATE_BYTES = 16 * TRAIN_PARAMS      # f32 params, grads, exp_avg, exp_avg_sq
TRAIN_BATCH = (4, 513)                     # B, T: 512 input tokens a row
TRAIN_STEPS = 10
TRAIN_TIMED_FROM = 2                       # steps 3-10
TRAIN_CHECK_BATCH = (1, 33)
TRAIN_RTOL = 1e-4                          # f32, TF32 off: summation order only
TRAIN_SERVE_PROMPT = 24
TRAIN_SERVE_TOKENS = 8
EMBED_CHECK_ROWS = (32, 30, 24, 17, 12, 8, 3, 1)   # real tokens per row at (8, 32)
EMBED_MIN_COS = 0.999
EMBED_F32_ATOL = 1e-5
EMBED_TIMED = 5


def first_step_bound(p, a, b, lr: float, eps: float) -> torch.Tensor:
    """How far apart two params p may lie after AdamW's first step from one
    value, given their gradients a and b. Step 1 moves a param by lr * g /
    (|g| + eps) (the bias corrections cancel), whose slope in g is eps /
    (|g| + eps)^2: two gradients of one sign move it apart by at most lr |a
    - b| eps / (min(|a|, |b|) + eps)^2, of opposite signs by lr |a - b| /
    eps; beside that, 1e-5 lr for the update's own rounding and 4 f32 ulps
    of the param."""
    g_min = torch.where(a.sign() == b.sign(), torch.minimum(a.abs(), b.abs()), 0.0)
    return (lr * ((a - b).abs() * eps / (g_min + eps) ** 2).clamp(max=2.0)
            + 1e-5 * lr + 4 * torch.finfo(torch.float32).eps * p.abs())


def train_check(card: str) -> dict:
    """Phase 13 (a): one train_step at llama3-1b width cut to 2 layers, f32,
    on the card and on the CPU from the same params and tokens (B = 1, T =
    33). The CPU side holds 16 x 646,981,632 = 10,351,706,112 bytes of
    params, grads and AdamW moments on the host: the vocabulary is not
    cut, so the host needs that much free memory.
    Held: the loss and every gradient leaf within TRAIN_RTOL of the CPU's
    (of the leaf's largest entry), and every param after the update within
    what the two gradients imply (``first_step_bound``)."""
    cfg = get_config("llama3-1b", num_layers=2)
    host_bytes = 16 * cfg.num_params()
    card_params = llama.init_params(cfg, torch.Generator(device="cuda").manual_seed(13), "cuda",
                                    dtype=torch.float32)
    cpu_params = _to(card_params, "cpu")
    tokens = torch.from_numpy(np.random.default_rng(13).integers(
        0, cfg.vocab_size, TRAIN_CHECK_BATCH).astype(np.int32))
    states, losses = {}, {}
    for dev, params in (("cuda", card_params), ("cpu", cpu_params)):
        init_fn, train_step = make_train_step(cfg, device=dev)
        t0 = time.monotonic()
        states[dev], loss = train_step(init_fn(params=params), tokens)
        losses[dev] = float(loss)
        print(f"phase 13 (a) {dev} step {time.monotonic() - t0:.2f}s", flush=True)
    opt = states["cuda"].opt_state
    lr, eps = opt.defaults["lr"], opt.defaults["eps"]
    loss_err = abs(losses["cuda"] - losses["cpu"]) / abs(losses["cpu"])
    if not loss_err <= TRAIN_RTOL:
        fail(f"phase 13 (a): loss {losses['cuda']} on the card, {losses['cpu']} on the CPU")
    cpu = dict(leaves(states["cpu"].params))
    grad_err = step_ratio = step_lr = 0.0
    past, total = 0, 0
    with torch.no_grad():
        for path, p in leaves(states["cuda"].params):
            q = cpu[path]
            a, b = p.grad, q.grad.cuda()
            err = ((a - b).abs().max() / b.abs().max()).item()
            if not err <= TRAIN_RTOL:
                fail(f"phase 13 (a) {path}: gradient card vs CPU {err} of its largest entry")
            grad_err = max(grad_err, err)
            bound = first_step_bound(p, a, b, lr, eps)
            dp = (p - q.cuda()).abs()
            ratio = (dp / bound).max().item()
            if not ratio <= 1.0:
                fail(f"phase 13 (a) {path}: param after the update {ratio:.3g} x its bound")
            step_ratio = max(step_ratio, ratio)
            step_lr = max(step_lr, dp.max().item() / lr)
            past += int((dp > 1e-3 * lr).sum())
            total += dp.numel()
    out = dict(model="llama3-1b width, 2 layers, f32", batch=list(TRAIN_CHECK_BATCH),
               host_bytes=host_bytes, loss_card=losses["cuda"], loss_cpu=losses["cpu"],
               loss_rel_err=loss_err, grad_max_err_of_largest=grad_err,
               param_worst_share_of_bound=step_ratio, param_max_diff_lr=step_lr,
               params_past_milli_lr=past, params=total, tolerance=TRAIN_RTOL)
    print("phase 13 (a) train card vs CPU " + json.dumps(out), flush=True)
    return out


def train_activation_bytes(cfg, B: int, T: int) -> int:
    """Bytes of the tensors autograd keeps for the backward of one f32
    loss_fn at [B, T] input tokens, reckoned from the port's ops: per layer
    the residual, normed and scaled inputs of both norms (6 D), q and k
    before and after rotary, v and the attention output (3 q_dim + 3
    kv_dim), the MLP's gate, silu, up and product (4 F), and the masked
    scores, their exp and the probabilities (3 H T^2); then the final
    norm's three (3 D), the logits and their log-softmax (2 V)."""
    D, F_, V = cfg.hidden_size, cfg.ffn_hidden_size, cfg.vocab_size
    layer = B * T * (6 * D + 3 * cfg.q_dim + 3 * cfg.kv_dim + 4 * F_) + 3 * B * cfg.num_heads * T * T
    return 4 * (cfg.num_layers * layer + B * T * (3 * D + 2 * V))


def train_full(card: str):
    """Phase 13 (b): llama3-1b at full width and depth, f32, init_fn on the
    card, TRAIN_STEPS train_steps on one fixed seeded batch. Returns the
    state, the tokens and what was measured."""
    from torch.optim.optimizer import _default_to_fused_or_foreach

    cfg = get_config("llama3-1b")
    if cfg.num_params() != TRAIN_PARAMS:
        fail(f"llama3-1b has {cfg.num_params()} params, expected {TRAIN_PARAMS}")
    init_fn, train_step = make_train_step(cfg, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    state = init_fn(torch.Generator(device="cuda").manual_seed(13))
    params = [p for _, p in leaves(state.params)]
    if sum(p.numel() for p in params) != TRAIN_PARAMS:
        fail("phase 13 (b): the state's params do not add up to llama3-1b's")
    fused, foreach = _default_to_fused_or_foreach(params, differentiable=False, use_fused=False)
    impl = "fused" if fused else "foreach" if foreach else "for-loop"
    # The optimizer's hooks split each step's peak: forward and backward,
    # then the update (foreach: temporaries the size of the param list).
    peaks = {"forward_backward": 0, "optimizer": 0}

    def before_update(*_):
        peaks["forward_backward"] = max(peaks["forward_backward"], torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()

    def after_update(*_):
        peaks["optimizer"] = max(peaks["optimizer"], torch.cuda.max_memory_allocated())

    hooks = [state.opt_state.register_step_pre_hook(before_update),
             state.opt_state.register_step_post_hook(after_update)]
    param_storages = {p.untyped_storage().data_ptr() for p in params}
    saved = {}

    def pack(t):
        st = t.untyped_storage()
        if st.data_ptr() not in param_storages:
            saved[st.data_ptr()] = st.nbytes()
        return t

    B, T = TRAIN_BATCH
    tokens = torch.from_numpy(np.random.default_rng(13).integers(
        0, cfg.vocab_size, TRAIN_BATCH).astype(np.int32)).cuda()
    losses, events = [], []
    for i in range(TRAIN_STEPS):
        torch.cuda.reset_peak_memory_stats()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        if i == 1:
            # Step 2 (untimed) counts the storages autograd keeps.
            with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
                state, loss = train_step(state, tokens)
        else:
            state, loss = train_step(state, tokens)
        end.record()
        losses.append(loss)
        events.append((start, end))
    torch.cuda.synchronize()
    for h in hooks:
        h.remove()
    losses = [float(x) for x in losses]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"phase 13 (b): the loss did not fall over {TRAIN_STEPS} steps: {losses}")
    if state.step != TRAIN_STEPS:
        fail(f"phase 13 (b): the state counts {state.step} steps")
    step_ms = statistics.median(s.elapsed_time(e) for s, e in events[TRAIN_TIMED_FROM:])
    n_tokens = B * (T - 1)
    # The gathered embedding table takes part in no product; the plain
    # attention computes every score of the T x T square.
    mm_params = TRAIN_PARAMS - cfg.vocab_size * cfg.hidden_size
    flops = (6 * mm_params * n_tokens
             + 12 * cfg.num_layers * B * cfg.num_heads * (T - 1) ** 2 * cfg.head_dim)
    out = dict(
        card=card, model="llama3-1b, 16 layers, f32", params=TRAIN_PARAMS, batch=[B, T],
        steps=TRAIN_STEPS, losses=losses, step_ms_median_steps_3_10=step_ms,
        tokens_per_s=n_tokens / (step_ms / 1e3), flops_per_step=flops,
        f32_peak_flops=PEAK_OPS[torch.float32],
        f32_peak_share=flops / (step_ms / 1e3) / PEAK_OPS[torch.float32],
        state_bytes_reckoned=TRAIN_STATE_BYTES,
        activation_bytes_reckoned=train_activation_bytes(cfg, B, T - 1),
        activation_bytes_saved_step_2=sum(saved.values()),
        peak_bytes=max(peaks.values()), peak_bytes_forward_backward=peaks["forward_backward"],
        peak_bytes_optimizer=peaks["optimizer"], optimizer=f"torch.optim.AdamW ({impl})",
        allow_tf32=torch.backends.cuda.matmul.allow_tf32,
    )
    print(f"phase 13 (b) llama3-1b f32 train: losses {losses[0]:.4f} -> {losses[-1]:.4f}, "
          f"median step {step_ms:.1f} ms (steps 3-10), {out['tokens_per_s']:.0f} tokens/s, "
          f"{100 * out['f32_peak_share']:.1f}% of the H100 SXM non-tensor f32 peak (67 TFLOP/s); "
          f"peak {out['peak_bytes']} bytes beside {TRAIN_STATE_BYTES} reckoned for params, "
          f"grads and moments, {out['activation_bytes_reckoned']} reckoned and "
          f"{out['activation_bytes_saved_step_2']} saved for the backward; AdamW {impl}, "
          f"its update's peak {peaks['optimizer']} bytes", flush=True)
    return state, tokens.cpu().numpy(), out


def serve_trained(card: str, state, tokens: np.ndarray, phase: str = "phase 13 (c)"):
    """Phase 13 (c) (and 16 (c)): the trained params (requiring grad)
    served as they are by an engine on the card (contiguous f32 cache, K1)
    and by one on the CPU over detached copies: 4 greedy requests whose
    prompts open rows of the training batch. The card's K1 launches must
    equal num_layers x decode steps, its caches must stay out of autograd,
    and the tokens must equal the CPU's. Returns (K1 launches, what was
    measured)."""
    cfg = get_config("llama3-1b")
    fields = dict(num_slots=4, max_seq=128, prefill_buckets=(32,), dtype="float32",
                  max_sessions=0)
    prompts = [[int(t) for t in tokens[i, :TRAIN_SERVE_PROMPT]] for i in range(4)]
    sp = SamplingParams(temperature=0.0, max_tokens=TRAIN_SERVE_TOKENS)

    def greedy(engine):
        handles = [engine.submit(p, sp) for p in prompts]
        while engine.step():
            pass
        return [h.collect_tokens(timeout=600)[0] for h in handles]

    engine = InferenceEngine(cfg, EngineConfig(**fields), params=state.params, seed=0,
                             device="cuda")
    got, launches = checked_launches("K1", engine, lambda: greedy(engine),
                                     f"{phase} K1 llama3-1b trained f32")
    if engine._ck.requires_grad or engine._ck.grad_fn is not None:
        fail(f"{phase}: serving params that require grad recorded an autograd graph")
    steps = engine.metrics["decode_steps"]
    del engine
    t0 = time.monotonic()
    want = greedy(InferenceEngine(cfg, EngineConfig(**fields),
                                  params=_to(state.params, "cpu"), seed=0,
                                  device="cpu"))
    cpu_s = time.monotonic() - t0
    if got != want:
        fail(f"{phase}: the card's greedy tokens part from the CPU's at "
             f"{first_divergence(got, want)}")
    out = dict(requests=len(prompts), tokens=sum(map(len, got)), decode_steps=steps,
               launches=launches, cpu_engine_s=cpu_s)
    print(f"{phase} trained weights served " + json.dumps(out), flush=True)
    return launches, out


def embed_check(card: str) -> dict:
    """Phase 13 (d): forward_embed at llama3-8b width cut to 2 layers, card
    against CPU at (8, 32) with rows of 32 down to 1 real tokens: bf16 per-
    row cosine >= EMBED_MIN_COS, f32 within EMBED_F32_ATOL. Then
    TorchEmbedder on full-depth llama3-8b bf16 weights drawn on the card:
    each of the nine bucket shapes timed (host clock around embed(), whose
    result comes back to the host: median of EMBED_TIMED calls after one
    warm call), unit rows, a text alone and in a batch of 8 within
    EMBED_MIN_COS, 33 texts into 33 rows."""
    cfg = get_config("llama3-8b", num_layers=2)
    params = llama.init_params(cfg, torch.Generator(device="cuda").manual_seed(14), "cuda",
                               dtype=torch.bfloat16)
    params.pop("lm_head")          # forward_embed reads no logits
    B, T = len(EMBED_CHECK_ROWS), 32
    rng = np.random.default_rng(14)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32))
    mask = (torch.arange(T)[None, :] < torch.tensor(EMBED_CHECK_ROWS)[:, None]).to(torch.int32)
    check = {}
    with torch.no_grad():
        for dtype in (torch.bfloat16, torch.float32):
            p = params if dtype == torch.bfloat16 else _to(params, dtype)
            a = llama.forward_embed(p, cfg, tok.cuda(), mask.cuda()).cpu()
            t0 = time.monotonic()
            b = llama.forward_embed(_to(p, "cpu"), cfg, tok, mask)
            cpu_s = time.monotonic() - t0
            if dtype == torch.bfloat16:
                cos = (a * b).sum(-1)
                if not cos.min().item() >= EMBED_MIN_COS:
                    fail(f"phase 13 (d): bf16 cosine card vs CPU {cos.tolist()}")
                check["bf16_min_cosine"] = cos.min().item()
            else:
                err = (a - b).abs().max().item()
                if not err <= EMBED_F32_ATOL:
                    fail(f"phase 13 (d): f32 vectors card vs CPU differ by {err}")
                check["f32_max_abs_err"] = err
            check[f"cpu_s_{str(dtype).split('.')[-1]}"] = cpu_s
    del params, p
    gc.collect()
    torch.cuda.empty_cache()

    cfg = get_config("llama3-8b")
    params = llama.init_params(cfg, torch.Generator(device="cuda").manual_seed(15), "cuda",
                               dtype=torch.bfloat16)
    params.pop("lm_head")
    emb = TorchEmbedder(params, cfg, ByteTokenizer(), device="cuda")

    def texts(n: int, length: int) -> list:
        # BOS and length - 1 bytes: exactly ``length`` tokens.
        return [bytes(rng.integers(97, 123, length - 1).tolist()).decode() for _ in range(n)]

    times = {}
    for nb in TorchEmbedder.BATCH_BUCKETS:
        for nt in TorchEmbedder.LEN_BUCKETS:
            batch = texts(nb, nt)
            emb.embed(batch)
            ts = []
            for _ in range(EMBED_TIMED):
                t0 = time.perf_counter()
                vecs = emb.embed(batch)
                ts.append(time.perf_counter() - t0)
            norms = np.linalg.norm(vecs, axis=-1)
            if vecs.shape != (nb, cfg.hidden_size) or not np.allclose(norms, 1.0, atol=1e-3):
                fail(f"phase 13 (d): embed at ({nb}, {nt}) gave {vecs.shape}, norms {norms}")
            times[f"{nb}x{nt}"] = statistics.median(ts) * 1e3
    one = texts(1, 20)
    alone = emb.embed(one)[0]
    mixed = emb.embed(one + texts(3, 7) + texts(4, 31))[0]
    leak_cos = float(alone @ mixed)
    if not leak_cos >= EMBED_MIN_COS:
        fail(f"phase 13 (d): a text alone and in a batch of 8 give cosine {leak_cos}")
    if emb.embed(texts(33, 16)).shape != (33, cfg.hidden_size):
        fail("phase 13 (d): 33 texts did not give 33 rows")
    mm_params = cfg.num_params() - 2 * cfg.vocab_size * cfg.hidden_size
    top_s = times["32x512"] / 1e3
    out = dict(card=card, check=dict(model="llama3-8b width, 2 layers", batch=[B, T],
                                     real_tokens=list(EMBED_CHECK_ROWS), **check),
               model="llama3-8b, 32 layers, bf16", ms_median=times, pad_leak_cosine=leak_cos,
               texts_per_s_32x512=32 / top_s,
               bf16_peak_share_32x512=2 * mm_params * 32 * 512 / top_s / PEAK_OPS[torch.bfloat16])
    print(f"phase 13 (d) embed llama3-8b bf16: (32, 512) {times['32x512']:.1f} ms, "
          f"{out['texts_per_s_32x512']:.1f} texts/s, "
          f"{100 * out['bf16_peak_share_32x512']:.1f}% of 989 TFLOP/s bf16 dense "
          f"(2 N tokens, N = {mm_params} params outside the embedding)", flush=True)
    del emb, params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def training(card: str) -> dict:
    """Phase 13: the training step and the embedding forward, after phase
    11 (every earlier weight freed): (a) train card vs CPU, (b) llama3-1b
    trained at full size, (c) its trained weights served, (d) the
    embedding forward and TorchEmbedder at llama3-8b. Returns K1's
    launches and (b)'s first loss (phase 16 (b) holds its own to it)."""
    gc.collect()
    torch.cuda.empty_cache()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    print(f"phase 13: torch.backends.cuda.matmul.allow_tf32={tf32}, "
          f"float32_matmul_precision={torch.get_float32_matmul_precision()}", flush=True)
    if tf32:
        fail("phase 13 trains in f32: TF32 products must stay off")
    check = train_check(card)
    gc.collect()
    torch.cuda.empty_cache()
    state, tokens, train = train_full(card)
    launches, served = serve_trained(card, state, tokens)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    embed = embed_check(card)
    print("train " + json.dumps(dict(train, check=check, served=served)), flush=True)
    print("embed " + json.dumps(embed), flush=True)
    return {"K1": launches}, train["losses"][0]


# -- phase 14 --------------------------------------------------------------

def tp_prompts(vocab: int) -> list:
    rng = np.random.default_rng(14)
    return [[int(t) for t in rng.integers(0, vocab, n)] for n in TP_PROMPT_LENGTHS]


def tp_session(vocab: int) -> tuple:
    """Session "e": its first prompt and its second turn's new tokens."""
    rng = np.random.default_rng(15)
    return ([int(t) for t in rng.integers(0, vocab, 40)],
            [int(t) for t in rng.integers(0, vocab, 24)])


def tp_requests(submit, drive, vocab: int, session: bool) -> dict:
    """(a)'s requests: the greedy prompts together, then (K1) session
    "e"'s first turn. ``submit(prompt, sp, session_id)`` gives a handle;
    ``drive()`` steps an inline engine (a lockstep loop steps itself)."""
    sp = SamplingParams(temperature=0.0, max_tokens=TP_NEW_TOKENS)
    hs = [submit(p, sp, None) for p in tp_prompts(vocab)]
    drive()
    out = {"greedy": [h.collect_tokens(timeout=600)[0] for h in hs]}
    if session:
        h = submit(tp_session(vocab)[0], sp, "e")
        drive()
        out["turn1"] = h.collect_tokens(timeout=600)[0]
    return out


def tp_serve(label: str, engine, fn, warm: bool = True) -> tuple:
    """A lockstep run on every rank (after a warmup unless ``warm`` is
    False): rank 0 calls fn(lock) and stops the loop, the others
    replicate. Returns (rank 0's result, launches, decode steps), counted
    on this rank (``checked_launches``: a failed count exits the rank, and
    spawn_ranks reports it)."""
    lock = LockstepEngine(engine)
    if warm:
        lock.warmup()

    def run():
        if not lock.is_leader:
            lock.run_follower()
            return None
        lock.start()
        try:
            return fn(lock)
        finally:
            lock.stop()

    steps0 = engine.metrics["decode_steps"]
    out, launches = checked_launches(label, engine, run, f"{label} tp={engine.cfg.tp}")
    return out, launches, engine.metrics["decode_steps"] - steps0


def tp_lock_submit(lock):
    return lambda p, sp, sid: lock.submit(p, sp, session_id=sid)


def tp_local_shape(engine) -> dict:
    k = engine._ck.pool if engine.cfg.kv_pages else engine._ck
    k = getattr(k, "q", k)
    wq = engine.params["layers"]["attn"]["wq"]
    return dict(H=wq.shape[-1] // engine.model_cfg.head_dim, Hkv=k.shape[3])


def tp_rank(rank: int, world: int) -> dict:
    """Phase 14 on one rank of a ``world``-rank gloo group (spawned):
    (a)/(b)/(e) at both degrees; (c) and (d) at tp = 2."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.reset_peak_memory_stats()
    mesh = make_mesh(tp=world)
    tp = mesh.comm("tp")
    out = {"rank": rank}
    gen = torch.Generator(device=TP_DEVICE)
    cfg = get_config(TP_MODEL, num_layers=TP_LAYERS)
    params = llama.init_params(cfg, gen.manual_seed(TP_SEED), TP_DEVICE, dtype=torch.float32,
                               mesh=mesh)
    tok = torch.tensor([tp_prompts(cfg.vocab_size)[-1][:TP_LOGIT_ROWS]], device=TP_DEVICE)
    with torch.no_grad():
        lg = llama.forward_prefill(params, cfg, tok, torch.arange(TP_LOGIT_ROWS)[None].to(tok),
                                   tp)[0]
        lg = llama.gather_logits(lg, tp)       # a collective: every rank gathers
    out["logits"] = lg.cpu().numpy() if rank == 0 else None
    for label in TP_EDITIONS:
        eng = InferenceEngine(cfg, EngineConfig(**TP_ENGINE, **TP_EDITIONS[label], tp=world),
                              params=params, device=TP_DEVICE)
        res, launches, steps = tp_serve(label, eng, lambda lock: tp_requests(
            tp_lock_submit(lock), lambda: None, cfg.vocab_size, label == "K1"))
        if label == "K1":
            payload = eng.export_session("e")     # a gather: every rank exports
            out["export"] = payload if rank == 0 else None
        out[label] = dict(res=res, launches=launches, steps=steps, **tp_local_shape(eng))
        del eng
    del params
    gc.collect()
    torch.cuda.empty_cache()
    if world == 2:
        out["bf16"] = tp_bf16(rank, world, mesh)
        out["moe"] = tp_moe(rank, world, mesh)
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    return out


def tp_bf16(rank: int, world: int, mesh) -> dict:
    """(c): llama3-8b, TP_BF16_LAYERS layers, bf16, tp = 2: the 12-request burst
    through the leader; this rank's params bytes, peak memory and the
    leader's host and collective ms per decode step. The collectives of
    decode steps (those inside ``_run_decode_step``, whose time the host
    ms include) are counted apart from the rest (prefill's)."""
    cfg = get_config(TP_MODEL, num_layers=TP_BF16_LAYERS)
    params = llama.init_params(cfg, torch.Generator(device=TP_DEVICE).manual_seed(TP_BF16_SEED),
                               TP_DEVICE, dtype=torch.bfloat16, mesh=mesh)
    eng = InferenceEngine(cfg, EngineConfig(tp=world), params=params, device=TP_DEVICE)
    tp = eng._tp        # the engine's Comm: its stats count the engine's collectives
    norms = 2 * (2 * cfg.num_layers * cfg.hidden_size + cfg.hidden_size)
    dec = {"calls": 0, "seconds": 0.0}
    run_step = eng._run_decode_step

    def decode_step(*args):
        c = dict(tp.stats)
        try:
            return run_step(*args)
        finally:
            for k in dec:
                dec[k] += tp.stats[k] - c[k]

    eng._run_decode_step = decode_step

    def run_burst(lock, reqs):
        m0, c0, d0 = dict(eng.metrics), dict(tp.stats), dict(dec)
        t0 = time.monotonic()
        hs = [lock.submit(p, sp) for p, sp in reqs]
        res = [h.collect_tokens(timeout=900) for h in hs]
        wall = time.monotonic() - t0
        steps = eng.metrics["decode_steps"] - m0["decode_steps"]
        host = {k: eng.metrics[k] - m0[k] for k in ("decode_dispatch_s", "decode_sync_s")}
        bad = [f.finish_reason for _, f in res
               if f.finish_reason not in (FinishReason.LENGTH, FinishReason.STOP)]
        if bad or (reqs[0] == reqs[-1] and res[0][0] != res[-1][0]):
            raise RuntimeError(f"(c) burst ended {bad}, or its repeated greedy prompt "
                               "gave other tokens")
        return dict(requests=len(reqs), generated_tokens=sum(len(t) for t, _ in res),
                    wall_s=wall, decode_steps=steps,
                    host_ms_per_decode_step=wall_decode_ms(host, steps),
                    decode_collective_calls=dec["calls"] - d0["calls"],
                    decode_collective_s=dec["seconds"] - d0["seconds"],
                    collective_ms_per_decode_step=(dec["seconds"] - d0["seconds"])
                    / max(steps, 1) * 1e3,
                    other_collective_calls=tp.stats["calls"] - c0["calls"]
                    - (dec["calls"] - d0["calls"]),
                    other_collective_s=tp.stats["seconds"] - c0["seconds"]
                    - (dec["seconds"] - d0["seconds"]),
                    decode_collective_share_of_host=(dec["seconds"] - d0["seconds"])
                    / max(sum(host.values()), 1e-9))

    res, launches, steps = tp_serve("K1", eng,
                                    lambda lock: run_burst(lock, burst(cfg.vocab_size, 12)))
    out = dict(params_bytes=tree_bytes(eng.params),
               params_bytes_expected=(2 * cfg.num_params() - norms) // world + norms,
               launches=launches, steps=steps, peak_bytes=torch.cuda.max_memory_allocated(),
               res=res, **tp_local_shape(eng))
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def tp_moe_params(cfg, mesh=None) -> dict:
    """Mixtral f32 weights from TP_MOE_SEED, router column 0 made positive
    so that expert 0 overflows its capacity at 1024 rows."""
    params = llama.init_params(cfg, torch.Generator(device=TP_DEVICE).manual_seed(TP_MOE_SEED),
                               TP_DEVICE, dtype=torch.float32, mesh=mesh)
    params["layers"]["mlp"]["router"][..., 0].abs_()
    return params


def tp_moe_layer(params, cfg, tp=None) -> list:
    """Layer 0's MoE MLP at MOE_ROWS rows: (top experts, output)."""
    from omnia_tpu_torch.ops import moe

    p0 = {k: v[0] for k, v in params["layers"]["mlp"].items()}
    gen = torch.Generator(device=TP_DEVICE).manual_seed(17)
    rows = []
    with torch.no_grad():
        for n in MOE_ROWS:
            h = torch.randn((1, n, cfg.hidden_size), generator=gen, device=TP_DEVICE)
            h.add_(MOE_H_MEAN)
            top_i = moe.route_sparse(h, p0["router"], cfg.num_experts_per_tok)[1]
            y = moe.moe_mlp(h, p0, cfg.num_experts_per_tok, comm=tp)
            rows.append((top_i.cpu().numpy()[0], y.cpu().numpy()[0]))
    return rows


def tp_moe(rank: int, world: int, mesh) -> dict:
    """(d): Mixtral at full width, TP_MOE_LAYERS layers, f32, tp = 2: its
    experts split over the ranks, the router whole."""
    cfg = get_config(TP_MOE_MODEL, num_layers=TP_MOE_LAYERS)
    params = tp_moe_params(cfg, mesh)
    rows = tp_moe_layer(params, cfg, mesh.comm("tp"))
    eng = InferenceEngine(cfg, EngineConfig(**TP_ENGINE, tp=world), params=params,
                          device=TP_DEVICE)
    res, launches, steps = tp_serve("K1", eng, lambda lock: tp_requests(
        tp_lock_submit(lock), lambda: None, cfg.vocab_size, False))
    out = dict(rows=rows if rank == 0 else None, res=res, launches=launches, steps=steps,
               experts=params["layers"]["mlp"]["wg"].shape[1])
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def tp_inline(engine):
    """(submit, drive) for an engine stepped inline."""
    def drive():
        while engine.step():
            pass

    return (lambda p, sp, sid: engine.submit(p, sp, session_id=sid)), drive


def tp_references() -> dict:
    """The tp = 1 side of (a), (d) and (e), on this process: the same
    seeded weights whole, the same requests stepped inline."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(TP_MODEL, num_layers=TP_LAYERS)
    params = llama.init_params(cfg, torch.Generator(device=TP_DEVICE).manual_seed(TP_SEED),
                               TP_DEVICE, dtype=torch.float32)
    tok = torch.tensor([tp_prompts(cfg.vocab_size)[-1][:TP_LOGIT_ROWS]], device=TP_DEVICE)
    ref = {"params": params}
    with torch.no_grad():
        ref["logits"] = llama.forward_prefill(
            params, cfg, tok, torch.arange(TP_LOGIT_ROWS)[None].to(tok))[0].cpu().numpy()
    for label in TP_EDITIONS:
        eng = InferenceEngine(cfg, EngineConfig(**TP_ENGINE, **TP_EDITIONS[label]),
                              params=params, device=TP_DEVICE)
        submit, drive = tp_inline(eng)
        ref[label] = tp_requests(submit, drive, cfg.vocab_size, label == "K1")
        if label == "K1":
            first, more = tp_session(cfg.vocab_size)
            h = submit(first + ref[label]["turn1"] + more,
                       SamplingParams(temperature=0.0, max_tokens=TP_NEW_TOKENS), "e")
            drive()
            ref["turn2"] = h.collect_tokens(timeout=600)[0]
        del eng
    mcfg = get_config(TP_MOE_MODEL, num_layers=TP_MOE_LAYERS)
    mparams = tp_moe_params(mcfg)
    ref["moe_rows"] = tp_moe_layer(mparams, mcfg)
    eng = InferenceEngine(mcfg, EngineConfig(**TP_ENGINE), params=mparams, device=TP_DEVICE)
    ref["moe"] = tp_requests(*tp_inline(eng), mcfg.vocab_size, False)
    del eng, mparams
    gc.collect()
    torch.cuda.empty_cache()
    return ref


def tensor_parallel(card: str) -> dict:
    """Phase 14: tensor parallelism at tp = 2 and 4, each rank a spawned
    process of one gloo group on the one card. Returns each kernel's
    launches over every rank's counted runs."""
    print("phase 14: the tp ranks share one card, so their group is gloo (NCCL "
          "takes one rank per card); each collective is staged through host memory "
          "and its times are not a NCCL number", flush=True)
    t0 = time.monotonic()
    ref = tp_references()
    print(f"phase 14 tp=1 references {time.monotonic() - t0:.1f}s", flush=True)
    cfg = get_config(TP_MODEL, num_layers=TP_LAYERS)
    mcfg = get_config(TP_MOE_MODEL, num_layers=TP_MOE_LAYERS)
    launches = {"K1": 0, "K4": 0}
    payload = None
    for world in TP_DEGREES:
        t0 = time.monotonic()
        try:
            ranks = spawn_ranks(tp_rank, world, args=(world,), backend="gloo", timeout_s=900)
        except (RuntimeError, TimeoutError) as e:
            fail(f"phase 14 tp={world}: {e}")
        spawn_s = time.monotonic() - t0
        err = float(np.abs(ranks[0]["logits"] - ref["logits"]).max())
        if not err <= TP_LOGITS_TOL:
            fail(f"phase 14 (a) tp={world}: prefill logits differ from tp=1 by {err}")
        for label in TP_EDITIONS:
            got = ranks[0][label]["res"]
            if got["greedy"] != ref[label]["greedy"]:
                fail(f"phase 14 (a) tp={world} {label}: greedy tokens differ from tp=1: "
                     f"{got['greedy']} vs {ref[label]['greedy']}")
            if label == "K1" and got["turn1"] != ref[label]["turn1"]:
                fail(f"phase 14 (a) tp={world} K1: session turn differs from tp=1")
            for r in ranks:
                launches[label] += r[label]["launches"]
        row = dict(card=card, tp=world, model=f"{TP_MODEL} f32, {TP_LAYERS} layers",
                   spawn_and_run_s=spawn_s, logits_max_abs_err=err,
                   logits_tolerance=TP_LOGITS_TOL,
                   greedy_tokens={k: sum(map(len, ref[k]["greedy"])) for k in TP_EDITIONS},
                   per_rank={label: [dict(launches=r[label]["launches"],
                                          decode_steps=r[label]["steps"],
                                          H=r[label]["H"], Hkv=r[label]["Hkv"])
                                     for r in ranks] for label in TP_EDITIONS},
                   peak_bytes=[r["peak_bytes"] for r in ranks])
        print("tp " + json.dumps(row), flush=True)
        if world == 2:
            payload = ranks[0]["export"]
            c = [r["bf16"] for r in ranks]
            for r in c:
                if r["params_bytes"] != r["params_bytes_expected"]:
                    fail(f"phase 14 (c): a rank holds {r['params_bytes']} params bytes, "
                         f"expected {r['params_bytes_expected']}")
                launches["K1"] += r["launches"]
            print("tp bf16 " + json.dumps(dict(
                card=card, tp=world, model=f"{TP_MODEL} bf16, {TP_BF16_LAYERS} layers",
                params_bytes_per_rank=[r["params_bytes"] for r in c],
                params_bytes_expected=c[0]["params_bytes_expected"],
                peak_bytes_per_rank=[r["peak_bytes"] for r in c],
                launches_per_rank=[r["launches"] for r in c], H=c[0]["H"], Hkv=c[0]["Hkv"],
                burst=c[0]["res"])), flush=True)
            d = [r["moe"] for r in ranks]
            moe_check_tp(card, ref, d, mcfg)
            for r in d:
                launches["K1"] += r["launches"]
    # (e): the session exported at tp = 2 (every head) continues at tp = 1.
    eng = InferenceEngine(cfg, EngineConfig(**TP_ENGINE), params=ref["params"], device=TP_DEVICE)
    if payload is None or payload.host_k.shape[2] != cfg.num_kv_heads:
        fail("phase 14 (e): no full-head payload from tp=2")
    eng.import_session(payload)
    submit, drive = tp_inline(eng)
    first, more = tp_session(cfg.vocab_size)
    h = submit(first + ref["K1"]["turn1"] + more,
               SamplingParams(temperature=0.0, max_tokens=TP_NEW_TOKENS), "e")
    drive()
    turn2 = h.collect_tokens(timeout=600)[0]
    if turn2 != ref["turn2"] or eng.metrics["session_restores"] != 1:
        fail(f"phase 14 (e): imported turn {turn2} vs resident {ref['turn2']}, "
             f"restores {eng.metrics['session_restores']}")
    print(f"phase 14 (e): a session exported at tp=2 ({payload.host_k.shape} rows) "
          f"continued at tp=1 with the resident tokens", flush=True)
    del eng, ref
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# -- phase 15 --------------------------------------------------------------

def dp_turns(vocab: int) -> list:
    """DP_TURNS as (session id, new tokens)."""
    rng = np.random.default_rng(16)
    return [(sid, [int(t) for t in rng.integers(0, vocab, n)]) for sid, n in DP_TURNS]


def dp_script(submit, drive, vocab: int, owner=None) -> dict:
    """(a)'s session script, turn by turn, each turn on its session's
    history; with ``owner(sid)`` also the dp shard each turn sat on."""
    sp = SamplingParams(temperature=0.0, max_tokens=TP_NEW_TOKENS)
    history, replies, shards = {}, [], []
    for sid, new in dp_turns(vocab):
        prompt = history.get(sid, []) + new
        h = submit(prompt, sp, sid)
        drive()
        reply = h.collect_tokens(timeout=600)[0]
        history[sid] = prompt + reply
        replies.append(reply)
        if owner is not None:
            shards.append(owner(sid))
    return dict(replies=replies, shards=shards)


def dp_forward(params, cfg, mesh, tokens: np.ndarray) -> np.ndarray:
    """(a)'s forward: each dp shard's row of ``tokens`` prefilled into a
    cache of its own, then one decode step; [prefill last row, decode]
    logits of every row, gathered over tp and dp."""
    tp, dp = mesh.comm("tp"), mesh.comm("dp")
    row = torch.tensor(tokens[dp.index:dp.index + 1], device=TP_DEVICE)
    T = row.shape[1]
    ck, cv = llama.init_kv_cache(cfg, 1, 2 * T, TP_DEVICE, dtype=torch.float32, tp=tp.size)
    with torch.no_grad():
        lg, _, _ = llama.forward(params, cfg, row, torch.arange(T, device=TP_DEVICE)[None],
                                 ck, cv, torch.zeros(1, dtype=torch.int32, device=TP_DEVICE), tp)
        nxt = row[:, :1]
        lg1, _, _ = llama.forward(params, cfg, nxt, torch.full((1, 1), T, device=TP_DEVICE),
                                  ck, cv, torch.full((1,), T, dtype=torch.int32,
                                                     device=TP_DEVICE), tp)
        both = torch.cat([lg[:, -1:], lg1], dim=1)
        both = dp.all_gather(llama.gather_logits(both, tp), dim=0)
    return both.cpu().numpy()


def dp_rows(vocab: int) -> np.ndarray:
    """Two prompt rows of TP_LOGIT_ROWS tokens, one per dp shard."""
    return np.array([p[:TP_LOGIT_ROWS] for p in tp_prompts(vocab)[-2:]], np.int64)


def sp_prompt(vocab: int) -> list:
    rng = np.random.default_rng(17)
    return [int(t) for t in rng.integers(0, vocab, SP_PROMPT_TOKENS)]


def sp_serve(label: str, engine, prompt: list, count_ring: bool, warm: bool = True) -> tuple:
    """One greedy request of SP_NEW_TOKENS + 1 tokens (the first and 16
    more) through the lockstep leader; returns ((tokens, ring prefills),
    launches, decode steps); the tokens and the count are None on the
    followers."""
    calls = []
    if count_ring:
        ring = engine._prefill_ring_fn

        def counted(*a):
            calls.append(1)
            return ring(*a)

        engine._prefill_ring_fn = counted

    def fn(lock):
        calls.clear()    # warmup's ring task ran before
        h = lock.submit(prompt, SamplingParams(temperature=0.0, max_tokens=SP_NEW_TOKENS + 1))
        return h.collect_tokens(timeout=900)[0], len(calls)

    return tp_serve(label, engine, fn, warm)


def sp_logits_err(params, cfg, mesh, prompt: list) -> float:
    """(c): the ring prefill's logits against the dense prefill's on the
    same ranks, over this sp rank's rows: the largest difference."""
    tp, sp = mesh.comm("tp"), mesh.comm("sp")
    T = 4096
    toks = torch.zeros((1, T), dtype=torch.int64, device=TP_DEVICE)
    toks[0, :len(prompt)] = torch.tensor(prompt, device=TP_DEVICE)
    pos = torch.arange(T, device=TP_DEVICE)[None]
    with torch.no_grad():
        ring, _, _ = llama.forward_prefill_ring(params, cfg, toks, pos, tp, sp)
        lo, hi = llama.sp_rows(T, sp)
        dense = llama.forward_prefill(params, cfg, toks, pos, tp)[0][:, lo:hi]
        err = float((ring - dense).abs().max())
    del ring, dense
    torch.cuda.empty_cache()
    return err


def dpsp_rank(rank: int) -> dict:
    """Phase 15 (a) and (c) on one rank of a four-rank gloo group
    (spawned): dp = 2 x tp = 2, then sp = 2 x tp = 2, over phase 14's f32
    weights cut to TP_LAYERS layers; then (c) at SP_BF16_LAYERS in bf16."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.reset_peak_memory_stats()
    out = {"rank": rank}
    cfg = get_config(TP_MODEL, num_layers=TP_LAYERS)
    mesh = make_mesh(dp=2, tp=2)
    gen = torch.Generator(device=TP_DEVICE)
    params = llama.init_params(cfg, gen.manual_seed(TP_SEED), TP_DEVICE, dtype=torch.float32,
                               mesh=mesh)
    t0 = time.monotonic()

    def note(what: str) -> None:
        if rank == 0:
            print(f"phase 15 rank 0 {what} at {time.monotonic() - t0:.1f}s", flush=True)

    logits = dp_forward(params, cfg, mesh, dp_rows(cfg.vocab_size))
    out["dp_logits"] = logits if rank == 0 else None
    for label in DP_EDITIONS:
        eng = InferenceEngine(cfg, EngineConfig(**DP_ENGINE, **DP_EDITIONS[label], dp=2, tp=2),
                              params=params, device=TP_DEVICE)

        def requests(lock, eng=eng, label=label):
            res = tp_requests(tp_lock_submit(lock), lambda: None, cfg.vocab_size, False)
            if label == "K1":
                res["script"] = dp_script(tp_lock_submit(lock), lambda: None, cfg.vocab_size,
                                          lambda sid: eng._dp.owner(eng._sessions[sid].slot))
            return res

        res, launches, steps = tp_serve(label, eng, lambda lock: requests(lock))
        pages = eng._ck.pool.shape[1] if eng.cfg.kv_pages else None
        out[label] = dict(res=res, launches=launches, steps=steps,
                          local_slots=int(eng._tokens.shape[0]), local_pages=pages)
        del eng
        note(f"(a) {label}")
    # (c): the same ranks as sp = 2 x tp = 2 (this rank's tp slice is the
    # same: tp is the fastest axis of both meshes).
    mesh = make_mesh(sp=2, tp=2)
    prompt = sp_prompt(cfg.vocab_size)
    out["sp_logits_err"] = sp_logits_err(params, cfg, mesh, prompt)
    note("(c) f32 logits")
    sp_runs = {}
    for name, fields, ring in (("ring", dict(sp=2, tp=2), True),
                               ("dense", dict(dp=2, tp=2), False)):
        # "dense": slot 0's dp shard serves the prompt as an sp = 1, tp = 2
        # engine on ranks 0 and 1.
        eng = InferenceEngine(cfg, EngineConfig(**SP_ENGINE, **fields), params=params,
                              device=TP_DEVICE)
        # Unwarmed: (a)'s engines warmed every program family but the ring,
        # which the CPU tests warm.
        res, launches, steps = sp_serve("K1", eng, prompt, ring, warm=False)
        toks, rings = res or (None, None)
        sp_runs[name] = dict(tokens=toks, ring_prefills=rings, launches=launches, steps=steps)
        del eng
        note(f"(c) f32 {name} engine")
    out["sp"] = sp_runs
    del params
    gc.collect()
    torch.cuda.empty_cache()
    out["sp_bf16"] = sp_bf16(rank, mesh, prompt)
    note("(c) bf16")
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    return out


def sp_bf16(rank: int, mesh, prompt: list) -> dict:
    """(c) at SP_BF16_LAYERS layers in bf16: the sp engine's ring prefill (the ring
    forward, the sp gather of its rows, the insert) on the four ranks
    against its dense prefill of the same bucket on ranks 0 and 1 (one sp
    replica), both timed with the card synchronized, SP_TIMED_ROUNDS
    rounds after one untimed; the ring's
    point-to-point shifts' bytes and host seconds; then the greedy tokens
    of the ring engine and of a dense dp = 2 x tp = 2 engine (slot 0's
    shard: sp = 1), compared and printed (bf16 need not agree)."""
    cfg = get_config(TP_MODEL, num_layers=SP_BF16_LAYERS)
    params = llama.init_params(cfg, torch.Generator(device=TP_DEVICE).manual_seed(TP_BF16_SEED),
                               TP_DEVICE, dtype=torch.bfloat16, mesh=mesh)
    # One slot a rank (the dense engine's two over dp = 2): four ranks'
    # weights, caches and 4096-row prefills share the card.
    fields = dict(SP_ENGINE, dtype="bfloat16")
    eng = InferenceEngine(cfg, EngineConfig(**dict(fields, num_slots=1), sp=2, tp=2),
                          params=params, device=TP_DEVICE)
    n, T = len(prompt), 4096
    toks = torch.zeros((1, T), dtype=torch.int32, device=TP_DEVICE)
    toks[0, :n] = torch.tensor(prompt, device=TP_DEVICE)
    pos = torch.arange(T, dtype=torch.int32, device=TP_DEVICE)[None]
    greedy = SamplingParams(temperature=0.0)
    args = eng._sampler_args(0, greedy)

    def ring():
        last, k, v = eng._prefill_ring_fn(eng.params, toks, pos, n - 1)
        return eng._insert_fn(eng._ck, eng._cv, k, v, 0, last, *args)[0]

    def dense():
        return eng._prefill_insert_fn(eng.params, eng._ck, eng._cv, toks, pos, 0, n - 1,
                                      *args)[0]

    shift = eng._sp.op_stats
    times, first = {}, {}
    for name, fn in (("ring", ring), ("dense", dense)):
        torch.cuda.empty_cache()
        if name == "dense" and eng._sp.index != 0:
            # One sp replica's tp pair (ranks 0 and 1) runs the dense
            # prefill, as the dense engine's slot-0 shard does; the other
            # pair waits: four 4,096-row dense prefills at once do not fit
            # the card beside four ranks' weights.
            torch.distributed.barrier()
            continue
        first[name] = int(fn())
        ms = []
        s0 = dict(shift.get("shift", {"calls": 0, "bytes": 0, "seconds": 0.0}))
        for _ in range(SP_TIMED_ROUNDS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        s1 = shift.get("shift", s0)
        # Per prefill: the rounds' shifts over the rounds.
        times[name] = dict(ms=ms, shift_calls=(s1["calls"] - s0["calls"]) // SP_TIMED_ROUNDS,
                           shift_bytes=(s1["bytes"] - s0["bytes"]) // SP_TIMED_ROUNDS,
                           shift_s=(s1["seconds"] - s0["seconds"]) / SP_TIMED_ROUNDS)
        if name == "dense":
            torch.distributed.barrier()
    out = dict(times=times, first_token=first)
    del eng
    torch.cuda.empty_cache()
    for name, extra, count in (("ring", dict(sp=2, tp=2, num_slots=1), True),
                               ("dense", dict(dp=2, tp=2), False)):
        eng = InferenceEngine(cfg, EngineConfig(**dict(fields, **extra)), params=params,
                              device=TP_DEVICE)
        # Unwarmed: the f32 run warmed these shapes' programs already.
        res, launches, steps = sp_serve("K1", eng, prompt, count, warm=False)
        tok, rings = res or (None, None)
        out[name] = dict(tokens=tok, ring_prefills=rings, launches=launches, steps=steps)
        del eng
        torch.cuda.empty_cache()
    out["params_bytes"] = tree_bytes(params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def dp_bf16_rank(rank: int) -> dict:
    """Phase 15 (b) on one rank of a two-rank gloo group (spawned): dp = 2,
    tp = 1, llama3-8b at full depth in bf16, each rank the whole tree and
    half the slots; the 12-request burst through the leader. The dp
    group's collectives inside decode steps (the token gather) are counted
    apart from the rest (the prefills' first-token broadcasts)."""
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(TP_MODEL)
    params = llama.init_params(cfg, torch.Generator(device=TP_DEVICE).manual_seed(DP_BF16_SEED),
                               TP_DEVICE, dtype=torch.bfloat16)
    eng = InferenceEngine(cfg, EngineConfig(dp=2), params=params, device=TP_DEVICE)
    dp = eng._dp.comm
    dec = {"calls": 0, "bytes": 0, "seconds": 0.0}
    run_step = eng._run_decode_step

    def decode_step(*args):
        c = dict(dp.stats)
        try:
            return run_step(*args)
        finally:
            for k in dec:
                dec[k] += dp.stats[k] - c[k]

    eng._run_decode_step = decode_step

    def run_burst(lock):
        reqs = burst(cfg.vocab_size, 12)
        m0, c0 = dict(eng.metrics), {op: dict(st) for op, st in dp.op_stats.items()}
        d0 = dict(dec)
        t0 = time.monotonic()
        res = [h.collect_tokens(timeout=900) for h in [lock.submit(p, sp) for p, sp in reqs]]
        wall = time.monotonic() - t0
        steps = eng.metrics["decode_steps"] - m0["decode_steps"]
        host = {k: eng.metrics[k] - m0[k] for k in ("decode_dispatch_s", "decode_sync_s")}
        bad = [f.finish_reason for _, f in res
               if f.finish_reason not in (FinishReason.LENGTH, FinishReason.STOP)]
        if bad or res[0][0] != res[-1][0]:
            raise RuntimeError(f"(b) burst ended {bad}, or its repeated greedy prompt "
                               "gave other tokens")
        ops = {op: {k: st[k] - c0.get(op, {}).get(k, 0) for k in st}
               for op, st in dp.op_stats.items()}
        gather = {k: dec[k] - d0[k] for k in dec}
        return dict(requests=len(reqs), generated_tokens=sum(len(t) for t, _ in res),
                    wall_s=wall, decode_steps=steps,
                    host_ms_per_decode_step=wall_decode_ms(host, steps),
                    gather_calls=gather["calls"], gather_bytes=gather["bytes"],
                    gather_calls_per_step=gather["calls"] / max(steps, 1),
                    gather_ms_per_step=gather["seconds"] / max(steps, 1) * 1e3,
                    gather_share_of_host=gather["seconds"] / max(sum(host.values()), 1e-9),
                    broadcast=ops.get("broadcast", {}))

    res, launches, steps = tp_serve("K1", eng, lambda lock: run_burst(lock))
    out = dict(rank=rank, params_bytes=tree_bytes(eng.params),
               kv_bytes=eng.metrics["kv_quant_device_bytes"], local_slots=eng._dp.per,
               launches=launches, steps=steps, peak_bytes=torch.cuda.max_memory_allocated(),
               res=res)
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def dp_references() -> dict:
    """The tp = 1 side of (a) on this process: phase 14's f32 weights
    whole, the forward rows, the greedy prompts on K1 and K4, and the
    session script on K1, stepped inline."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(TP_MODEL, num_layers=TP_LAYERS)
    params = llama.init_params(cfg, torch.Generator(device=TP_DEVICE).manual_seed(TP_SEED),
                               TP_DEVICE, dtype=torch.float32)
    rows = torch.tensor(dp_rows(cfg.vocab_size), device=TP_DEVICE)
    T = rows.shape[1]
    ck, cv = llama.init_kv_cache(cfg, 2, 2 * T, TP_DEVICE, dtype=torch.float32)
    with torch.no_grad():
        lg, _, _ = llama.forward(params, cfg, rows, torch.arange(T, device=TP_DEVICE)[None]
                                 .expand(2, T), ck, cv,
                                 torch.zeros(2, dtype=torch.int32, device=TP_DEVICE))
        lg1, _, _ = llama.forward(params, cfg, rows[:, :1],
                                  torch.full((2, 1), T, device=TP_DEVICE), ck, cv,
                                  torch.full((2,), T, dtype=torch.int32, device=TP_DEVICE))
    ref = {"logits": torch.cat([lg[:, -1:], lg1], dim=1).cpu().numpy()}
    for label in DP_EDITIONS:
        eng = InferenceEngine(cfg, EngineConfig(**DP_ENGINE, **DP_EDITIONS[label]),
                              params=params, device=TP_DEVICE)
        submit, drive = tp_inline(eng)
        ref[label] = tp_requests(submit, drive, cfg.vocab_size, False)
        if label == "K1":
            ref["script"] = dp_script(submit, drive, cfg.vocab_size)
        del eng
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return ref


def data_sequence_parallel(card: str) -> dict:
    """Phase 15: dp and sp, each rank a spawned process of one gloo group
    on the one card. Returns each kernel's launches over every rank's
    counted runs."""
    print("phase 15: the dp and sp ranks share one card, so their group is gloo; every "
          "collective and every ring shift is staged through host memory, and the one card "
          "shows correctness, bytes and what staging costs, no multi-card speed", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    print(f"phase 15 card memory before the spawns: {free} of {total} bytes free; this process "
          f"holds {torch.cuda.memory_allocated()} allocated, {torch.cuda.memory_reserved()} "
          "reserved", flush=True)
    t0 = time.monotonic()
    ref = dp_references()
    print(f"phase 15 tp=1 references {time.monotonic() - t0:.1f}s", flush=True)
    cfg = get_config(TP_MODEL, num_layers=TP_LAYERS)
    launches = {"K1": 0, "K4": 0}
    t0 = time.monotonic()
    try:
        ranks = spawn_ranks(dpsp_rank, 4, backend="gloo", env=DPSP_ENV, timeout_s=900)
    except (RuntimeError, TimeoutError) as e:
        fail(f"phase 15 (a)/(c): {e}")
    spawn_s = time.monotonic() - t0
    err = float(np.abs(ranks[0]["dp_logits"] - ref["logits"]).max())
    if not err <= TP_LOGITS_TOL:
        fail(f"phase 15 (a): prefill and decode logits at dp=2 x tp=2 differ from tp=1 by {err}")
    for label in DP_EDITIONS:
        got = ranks[0][label]["res"]
        if got["greedy"] != ref[label]["greedy"]:
            fail(f"phase 15 (a) {label}: greedy tokens differ from tp=1: "
                 f"{got['greedy']} vs {ref[label]['greedy']}")
        for r in ranks:
            if r[label]["local_slots"] != DP_ENGINE["num_slots"] // 2:
                fail(f"phase 15 (a) {label}: a rank holds {r[label]['local_slots']} slots")
            launches[label] += r[label]["launches"]
    script = ranks[0]["K1"]["res"]["script"]
    if script["replies"] != ref["script"]["replies"]:
        fail(f"phase 15 (a): the session script differs from tp=1: {script['replies']} vs "
             f"{ref['script']['replies']}")
    first_a, again_a = 0, [i for i, (sid, _) in enumerate(DP_TURNS) if sid == "a"][1]
    if script["shards"][first_a] == script["shards"][again_a]:
        fail(f"phase 15 (a): session a did not move across shards ({script['shards']})")
    k4_pages = ranks[0]["K4"]["local_pages"]
    if k4_pages != DP_EDITIONS["K4"]["kv_pages"] // 2:
        fail(f"phase 15 (a): a K4 rank's pool holds {k4_pages} pages")
    print("dp " + json.dumps(dict(
        card=card, dp=2, tp=2, model=f"{TP_MODEL} f32, {TP_LAYERS} layers",
        spawn_and_run_s=spawn_s, logits_max_abs_err=err, logits_tolerance=TP_LOGITS_TOL,
        greedy_tokens={k: sum(map(len, ref[k]["greedy"])) for k in DP_EDITIONS},
        session_turn_shards=script["shards"], k4_pages_per_shard=k4_pages,
        per_rank={label: [dict(launches=r[label]["launches"], decode_steps=r[label]["steps"],
                               local_slots=r[label]["local_slots"]) for r in ranks]
                  for label in DP_EDITIONS},
        peak_bytes=[r["peak_bytes"] for r in ranks])), flush=True)
    # (c) f32: the ring against the dense engine on the same ranks.
    sp_err = max(r["sp_logits_err"] for r in ranks)
    if not sp_err <= TP_LOGITS_TOL:
        fail(f"phase 15 (c): ring prefill logits differ from the dense prefill's by {sp_err}")
    runs = ranks[0]["sp"]
    if runs["ring"]["tokens"] != runs["dense"]["tokens"]:
        fail(f"phase 15 (c): the ring engine's tokens {runs['ring']['tokens']} differ from the "
             f"sp=1, tp=2 engine's {runs['dense']['tokens']}")
    if runs["ring"]["ring_prefills"] != 1:
        fail(f"phase 15 (c): {runs['ring']['ring_prefills']} ring prefills for one prompt")
    for r in ranks:
        for name in ("ring", "dense"):
            launches["K1"] += r["sp"][name]["launches"] + r["sp_bf16"][name]["launches"]
    b = [r["sp_bf16"] for r in ranks]
    print("sp " + json.dumps(dict(
        card=card, sp=2, tp=2, prompt_tokens=SP_PROMPT_TOKENS, bucket=4096,
        f32=dict(model=f"{TP_MODEL} f32, {TP_LAYERS} layers", logits_max_abs_err=sp_err,
                 logits_tolerance=TP_LOGITS_TOL, tokens_equal=True,
                 new_tokens=len(runs["ring"]["tokens"])),
        bf16=dict(model=f"{TP_MODEL} bf16, {SP_BF16_LAYERS} layers",
                  params_bytes_per_rank=[x["params_bytes"] for x in b],
                  prefill_ms_per_rank={name: [x["times"][name]["ms"] for x in b
                                              if name in x["times"]]
                                       for name in ("ring", "dense")},
                  ring_shifts_per_prefill=b[0]["times"]["ring"]["shift_calls"],
                  ring_shift_bytes_per_prefill=b[0]["times"]["ring"]["shift_bytes"],
                  ring_shift_ms_per_prefill=[x["times"]["ring"]["shift_s"] * 1e3 for x in b],
                  first_token=b[0]["first_token"],
                  tokens_agree=b[0]["ring"]["tokens"] == b[0]["dense"]["tokens"],
                  ring_tokens=b[0]["ring"]["tokens"], dense_tokens=b[0]["dense"]["tokens"]),
        peak_bytes=[r["peak_bytes"] for r in ranks])), flush=True)
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    # (b): dp = 2 alone, bf16 at full depth.
    t0 = time.monotonic()
    try:
        ranks = spawn_ranks(dp_bf16_rank, 2, backend="gloo", env=DPSP_ENV, timeout_s=900)
    except (RuntimeError, TimeoutError) as e:
        fail(f"phase 15 (b): {e}")
    cfg = get_config(TP_MODEL)
    for r in ranks:
        if r["params_bytes"] != 2 * cfg.num_params():
            fail(f"phase 15 (b): a rank holds {r['params_bytes']} params bytes, not the whole "
                 f"tree's {2 * cfg.num_params()}")
        launches["K1"] += r["launches"]
    print("dp bf16 " + json.dumps(dict(
        card=card, dp=2, tp=1, model=f"{TP_MODEL} bf16, full depth",
        spawn_and_run_s=time.monotonic() - t0,
        params_bytes_per_rank=[r["params_bytes"] for r in ranks],
        kv_bytes_per_rank=[r["kv_bytes"] for r in ranks],
        local_slots=[r["local_slots"] for r in ranks],
        peak_bytes_per_rank=[r["peak_bytes"] for r in ranks],
        launches_per_rank=[r["launches"] for r in ranks],
        burst=ranks[0]["res"])), flush=True)
    return launches


def moe_check_tp(card: str, ref: dict, ranks: list, cfg) -> None:
    """(d): routing, kept assignments and outputs of layer 0 at tp = 2
    equal tp = 1's (f32, TF32 off: within 1e-4 of the largest output), and
    the engine's greedy tokens too."""
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    rows = []
    for n, (t_i, t_y), (r_i, r_y) in zip(MOE_ROWS, ranks[0]["rows"], ref["moe_rows"]):
        capacity = max(1, int(-(-n * K * 2.0 // E)))
        dispatch = n >= 64
        kept_t = kept(t_i, E, capacity) if dispatch else np.ones_like(t_i, bool)
        kept_r = kept(r_i, E, capacity) if dispatch else np.ones_like(r_i, bool)
        rel = float(np.abs(t_y - r_y).max() / np.abs(r_y).max())
        drops = int((~kept_r).sum())
        if not (np.array_equal(t_i, r_i) and np.array_equal(kept_t, kept_r)) or rel > 1e-4:
            fail(f"phase 14 (d) {n} rows: routing, kept set or output (err {rel}) differ")
        if dispatch and drops == 0:
            fail(f"phase 14 (d) {n} rows: the skewed router dropped no assignment")
        rows.append(dict(rows=n, dropped_assignments=drops, max_err_of_largest=rel))
    if ranks[0]["res"]["greedy"] != ref["moe"]["greedy"]:
        fail("phase 14 (d): Mixtral greedy tokens at tp=2 differ from tp=1")
    print("tp moe " + json.dumps(dict(
        card=card, tp=2, model=f"{TP_MOE_MODEL} f32, {TP_MOE_LAYERS} layers",
        experts_per_rank=[r["experts"] for r in ranks], layer0=rows,
        greedy_tokens=sum(map(len, ref["moe"]["greedy"])),
        launches_per_rank=[r["launches"] for r in ranks])), flush=True)


# -- phase 16 --------------------------------------------------------------

# Phase 16: pipeline parallelism and the sharded trainer, ranks of one gloo
# group sharing the card. (a) llama3-1b width cut to PP_LAYERS layers, f32:
# pp = 2 x tp = 2 and dp = 2 x tp = 2 against one rank; (b) llama3-1b whole
# at pp = 2 x tp = 2 (phase 13 (b)'s seed and batch); (c) its weights,
# gathered, served on K1.
PP_MODEL = "llama3-1b"
PP_LAYERS = 4
PP_SEED = 16
PP_CHECK_BATCH = (4, 33)                   # (a): 32 input tokens a row
PP_COUNTS = (1, 2, 4)
PP_MESHES = {"pp2_tp2": dict(pp=2, tp=2), "dp2_tp2": dict(dp=2, tp=2)}
PP_TOL = 1e-4                              # f32, TF32 off: summation order only
PP_LOSS_RTOL = 1e-5
PP_FULL = dict(pp=2, tp=2)
PP_MICROBATCHES = 2
PP_STEPS = 3
PP_KV_SPEC = P("pp", None, None, "tp", None)       # a stage's KV chunk


def pp_rank_bytes(cfg, pp: int, tp: int) -> int:
    """One rank's f32 params under param_specs_pp: its 1 / (pp tp) of every
    projection, 1 / pp of the layer norms, 1 / tp of embed and of lm_head,
    and the final norm whole."""
    L, D, V = cfg.num_layers, cfg.hidden_size, cfg.vocab_size
    projections = 2 * D * cfg.q_dim + 2 * D * cfg.kv_dim + 3 * D * cfg.ffn_hidden_size
    return 4 * (L * projections // (pp * tp) + 2 * L * D // pp + 2 * V * D // tp + D)


def pp_reference(cfg, tok, pos) -> dict:
    """(a)'s one-rank side, on rank 0: the same seeded tree whole, its
    prefill and one train_step (the grads and the updated params kept,
    the moments dropped)."""
    params = llama.init_params(cfg, torch.Generator(device=TP_DEVICE).manual_seed(PP_SEED),
                               TP_DEVICE, dtype=torch.float32)
    with torch.no_grad():
        ref = dict(zip(("logits", "k", "v"),
                       llama.forward_prefill(params, cfg, tok[:, :-1], pos)))
    init_fn, step = make_train_step(cfg, device=TP_DEVICE)
    state, loss = step(init_fn(params=params), tok)
    opt = state.opt_state.defaults
    ref.update(loss=float(loss), lr=opt["lr"], eps=opt["eps"],
               grads={path: p.grad for path, p in leaves(params)},
               params={path: p.detach() for path, p in leaves(params)})
    return ref


def pp_check(rank: int) -> dict:
    """(a) on one of four ranks: per mesh of PP_MESHES, init_fn's slices of
    the seeded tree; under pp, pipeline_forward at each M of PP_COUNTS
    (logits, and the KV chunks gathered); one train_step, its gradient
    and updated params gathered leaf by leaf. Rank 0 holds each against
    the one-rank reference (pp_reference) and returns the errors."""
    cfg = get_config(PP_MODEL, num_layers=PP_LAYERS)
    B, T = PP_CHECK_BATCH
    tok = torch.from_numpy(np.random.default_rng(PP_SEED).integers(
        0, cfg.vocab_size, PP_CHECK_BATCH).astype(np.int32)).to(TP_DEVICE)
    pos = torch.arange(T - 1, dtype=torch.int32, device=TP_DEVICE).expand(B, -1)
    ref = pp_reference(cfg, tok, pos) if rank == 0 else None
    out = {}
    for label, dims in PP_MESHES.items():
        mesh = make_mesh(**dims)
        init_fn, step = make_train_step(cfg, mesh=mesh, device=TP_DEVICE)
        state = init_fn(torch.Generator(device=TP_DEVICE).manual_seed(PP_SEED))
        res = {}
        if "pp" in dims:
            for m in PP_COUNTS:
                with torch.no_grad():
                    got = dict(zip(("logits", "k", "v"), pipeline_forward(
                        state.params, cfg, tok[:, :-1], pos, mesh, m)))
                    got["k"], got["v"] = (gather_leaf(got[n], PP_KV_SPEC, mesh) for n in "kv")
                if ref is not None:
                    res[f"forward_err_M{m}"] = {n: (got[n] - ref[n]).abs().max().item()
                                                for n in got}
                del got
        state, loss = step(state, tok)
        res["loss"] = float(loss)
        grad_err, ratio = {}, 0.0
        specs = dict(leaves(llama.mesh_param_specs(cfg, mesh)))
        for path, p in leaves(state.params):
            g, w = (gather_leaf(x, specs[path], mesh) for x in (p.grad, p.detach()))
            if ref is not None:
                b = ref["grads"][path]
                grad_err[path] = ((g - b).abs().max() / b.abs().max()).item()
                bound = first_step_bound(w, g, b, ref["lr"], ref["eps"])
                ratio = max(ratio, ((w - ref["params"][path]).abs() / bound).max().item())
            del g, w
        if ref is not None:
            res.update(loss_ref=ref["loss"], grad_err_of_largest=grad_err,
                       param_worst_share_of_bound=ratio)
        out[label] = res
        del state, step, init_fn
        gc.collect()
        torch.cuda.empty_cache()
    return out


def pp_full(rank: int, card: str) -> dict:
    """(b) and (c) on one of four ranks: llama3-1b whole at pp = 2 x tp =
    2, drawn by init_fn from phase 13 (b)'s seed, PP_STEPS train_steps on
    phase 13 (b)'s batch with PP_MICROBATCHES microbatches: each step's
    loss and host ms (synchronized), this rank's params bytes, peak memory
    and its tp and pp collectives' calls, bytes and seconds. Then the
    trained tree gathered leaf by leaf onto rank 0, which serves it on K1
    (serve_trained)."""
    cfg = get_config(PP_MODEL)
    mesh = make_mesh(**PP_FULL)
    init_fn, step = make_train_step(cfg, mesh=mesh, num_microbatches=PP_MICROBATCHES,
                                    device=TP_DEVICE)
    torch.cuda.reset_peak_memory_stats()
    state = init_fn(torch.Generator(device=TP_DEVICE).manual_seed(13))
    out = dict(params_bytes=sum(p.numel() * p.element_size() for _, p in leaves(state.params)))
    tokens = np.random.default_rng(13).integers(0, cfg.vocab_size, TRAIN_BATCH).astype(np.int32)
    tok = torch.from_numpy(tokens).to(TP_DEVICE)
    losses, ms = [], []
    for _ in range(PP_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = step(state, tok)
        losses.append(float(loss))
        ms.append((time.perf_counter() - t0) * 1e3)
    # A copy: (c)'s gathers count on the same Comms.
    out.update(losses=losses, step_ms=ms, peak_bytes=torch.cuda.max_memory_allocated(),
               op_stats=json.loads(json.dumps({axis: mesh.comm(axis).op_stats
                                               for axis in ("tp", "pp")})))
    params = _to(state.params, TP_DEVICE)
    del state, step, init_fn                   # the grads and AdamW's moments
    gc.collect()
    torch.cuda.empty_cache()

    def keep(spec, x):
        whole = gather_leaf(x, spec, mesh)     # a collective: every rank gathers
        return whole if rank == 0 else None

    tree = tree_map_specs(keep, llama.param_specs_pp(cfg), params)
    if rank == 0:
        out["launches"], out["served"] = serve_trained(
            card, types.SimpleNamespace(params=tree), tokens, "phase 16 (c)")
    return out


def pp_rank(rank: int, card: str) -> dict:
    """Phase 16 on one rank of four (spawned): (a), then (b) and (c)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"rank": rank, "check": pp_check(rank)}
    out.update(pp_full(rank, card))
    return out


def pipeline_parallel(card: str, first_loss: float) -> dict:
    """Phase 16: pipeline parallelism and the sharded trainer, each rank a
    spawned process of one gloo group on the one card. ``first_loss`` is
    phase 13 (b)'s, on the same seed and batch. Returns K1's launches."""
    print("phase 16: the pp and tp ranks share one card, so their group is gloo; every "
          "collective and every stage-to-stage send is staged through host memory, and the "
          "one card shows correctness, bytes and what staging costs, no multi-card speed",
          flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    try:
        ranks = spawn_ranks(pp_rank, 4, args=(card,), backend="gloo", env=DPSP_ENV,
                            timeout_s=900)
    except (RuntimeError, TimeoutError) as e:
        fail(f"phase 16: {e}")
    spawn_s = time.monotonic() - t0
    check = ranks[0]["check"]
    for label, res in check.items():
        for m in PP_COUNTS if label == "pp2_tp2" else ():
            errs = res[f"forward_err_M{m}"]
            if not max(errs.values()) <= PP_TOL:
                fail(f"phase 16 (a) {label} M={m}: logits and KV differ from one rank's "
                     f"prefill by {errs}")
        for r in ranks:
            loss = r["check"][label]["loss"]
            if not abs(loss - res["loss_ref"]) <= PP_LOSS_RTOL * abs(res["loss_ref"]):
                fail(f"phase 16 (a) {label}: rank {r['rank']}'s loss {loss}, one rank's "
                     f"{res['loss_ref']}")
        worst = max(res["grad_err_of_largest"], key=res["grad_err_of_largest"].get)
        if not res["grad_err_of_largest"][worst] <= PP_TOL:
            fail(f"phase 16 (a) {label} {worst}: gradient {res['grad_err_of_largest'][worst]} "
                 "of its largest entry from one rank's")
        if not res["param_worst_share_of_bound"] <= 1.0:
            fail(f"phase 16 (a) {label}: params after the update "
                 f"{res['param_worst_share_of_bound']:.3g} x their bound")
    cfg = get_config(PP_MODEL)
    want_bytes = pp_rank_bytes(cfg, PP_FULL["pp"], PP_FULL["tp"])
    for r in ranks:
        if r["params_bytes"] != want_bytes:
            fail(f"phase 16 (b): rank {r['rank']} holds {r['params_bytes']} params bytes, "
                 f"reckoned {want_bytes}")
        if not np.allclose(r["losses"], ranks[0]["losses"], rtol=PP_LOSS_RTOL, atol=0):
            fail(f"phase 16 (b): rank {r['rank']}'s losses {r['losses']} differ from rank 0's")
    losses = ranks[0]["losses"]
    if first_loss is not None and not abs(losses[0] - first_loss) <= PP_LOSS_RTOL * abs(first_loss):
        fail(f"phase 16 (b): first loss {losses[0]}, phase 13 (b)'s {first_loss}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"phase 16 (b): the loss did not fall over {PP_STEPS} steps: {losses}")
    S, M = PP_FULL["pp"], PP_MICROBATCHES

    def per_step(axis: str) -> dict:
        return {op: {k: v / PP_STEPS for k, v in st.items()}
                for op, st in ranks[0]["op_stats"][axis].items()}

    print("pp " + json.dumps(dict(
        card=card, spawn_and_run_s=spawn_s,
        check=dict(model=f"{PP_MODEL} width, {PP_LAYERS} layers, f32",
                   batch=list(PP_CHECK_BATCH), tolerance=PP_TOL, loss_rtol=PP_LOSS_RTOL,
                   **{label: dict(res, grad_err_of_largest=max(
                       res["grad_err_of_largest"].values())) for label, res in check.items()}),
        train=dict(model=f"{PP_MODEL}, {cfg.num_layers} layers, f32", mesh=PP_FULL,
                   microbatches=M, batch=list(TRAIN_BATCH), losses=losses,
                   phase13_first_loss=first_loss,
                   step_ms_per_rank=[r["step_ms"] for r in ranks],
                   params_bytes_per_rank=[r["params_bytes"] for r in ranks],
                   params_bytes_reckoned=want_bytes,
                   peak_bytes_per_rank=[r["peak_bytes"] for r in ranks],
                   rank0_tp_per_step=per_step("tp"), rank0_pp_per_step=per_step("pp"),
                   gpipe_bubble=(S - 1) / (M + S - 1)),
        served=ranks[0]["served"])), flush=True)
    return {"K1": ranks[0]["launches"]}


# -- phase 17 --------------------------------------------------------------

RING_SP = dict(sp=2, **RING)
RING_SP_SEED = 25
RING_REFUSED = {"tp2": dict(tp=2), "dp2": dict(dp=2)}


def ring_sp_rank(rank: int) -> dict:
    """Phase 17 on one rank of a two-rank gloo group (spawned) on the one
    card: (c) the refusals, then per cache (K1, K4) a decode ring engine
    at sp = 2 (captured at warmup), a ring-off one at sp = 2 and, on rank
    0, a one-rank ring-off one, over llama3-8b width cut to CUT_LAYERS
    layers in bf16: (a) the greedy requests on each, the ring engine's
    launches counted on the card; (b) K1's host ms windows, ring on and
    off in turns, both ranks starting each window together."""
    import torch.distributed as dist

    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(TP_MODEL, num_layers=CUT_LAYERS)
    params = llama.init_params(cfg, torch.Generator(device=TP_DEVICE).manual_seed(RING_SP_SEED),
                               TP_DEVICE, dtype=torch.bfloat16)
    out = {"rank": rank, "refused": {}}
    for name, dims in RING_REFUSED.items():
        try:
            InferenceEngine(cfg, EngineConfig(**RING, **dims), params=params, device=TP_DEVICE)
            out["refused"][name] = None
        except ValueError as e:
            out["refused"][name] = str(e)
    for label, cache in RING_ENGINES.items():
        on = InferenceEngine(cfg, EngineConfig(**cache, **RING_SP), params=params,
                             device=TP_DEVICE)
        t0 = time.monotonic()
        on.warmup()
        warm_s = time.monotonic() - t0
        graphs = on._ring_graphs
        off = InferenceEngine(cfg, EngineConfig(**cache, sp=2), params=params, device=TP_DEVICE)
        toks, launches = checked_launches(label, on, lambda: greedy_inline(on),
                                          f"phase 17 (a) {label} ring sp=2 rank {rank}")
        res = dict(on=toks, off=greedy_inline(off), launches=launches, warmup_s=warm_s,
                   capture_s=graphs.capture_s, pool_bytes=graphs.pool_bytes,
                   steps_ran=on.metrics["decode_steps"] - on.metrics["early_exit_steps"])
        if rank == 0:
            res["one"] = greedy_inline(InferenceEngine(cfg, EngineConfig(**cache),
                                                       params=params, device=TP_DEVICE))
        if label == "K1":
            windows = {"on": [], "off": []}
            for _ in range(RING_WINDOWS):
                for arm, eng in (("on", on), ("off", off)):
                    dist.barrier()
                    windows[arm].append(busy_window(eng))
            res["windows"] = windows
        out[label] = res
        on.stop()
        off.stop()
        del on, off, graphs
        gc.collect()
        torch.cuda.empty_cache()
    out["params_bytes"] = tree_bytes(params)
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    return out


def ring_mesh(card: str) -> dict:
    """Phase 17: the decode ring under sp = 2, two ranks of one gloo group
    on the one card. Returns each kernel's launches over both ranks'
    counted runs."""
    print("phase 17: the sp ranks share one card over gloo; a decode step at sp = 2 holds no "
          "collective, so each rank replays its own captured graphs; the two processes "
          "contend for the card and the host, so their host ms are this layout's, not one "
          "rank's alone", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    try:
        ranks = spawn_ranks(ring_sp_rank, 2, backend="gloo", env=DPSP_ENV, timeout_s=600)
    except (RuntimeError, TimeoutError) as e:
        fail(f"phase 17: {e}")
    spawn_s = time.monotonic() - t0
    launches = {"K1": 0, "K4": 0}
    for r in ranks:
        for name, msg in r["refused"].items():
            if msg is None or "NCCL, one rank per card" not in msg:
                fail(f"phase 17 (c) {name}: a decode ring over gloo on the card gave {msg!r}, "
                     "not the refusal")
        for label in RING_ENGINES:
            res = r[label]
            if not res["capture_s"]:
                fail(f"phase 17 (a) {label}: rank {r['rank']} captured no graph")
            if res["on"] != res["off"] or res["on"] != ranks[0][label]["on"]:
                fail(f"phase 17 (a) {label}: rank {r['rank']}'s ring tokens differ from ring "
                     f"off at (request, step) {first_divergence(res['on'], res['off'])}, or "
                     "from rank 0's")
            launches[label] += res["launches"]
    for label in RING_ENGINES:
        if ranks[0][label]["on"] != ranks[0][label]["one"]:
            fail(f"phase 17 (a) {label}: sp = 2 ring tokens differ from one rank's at "
                 f"(request, step) {first_divergence(ranks[0][label]['on'], ranks[0][label]['one'])}")
    windows = [r["K1"]["windows"] for r in ranks]
    print("ring mesh " + json.dumps(dict(
        card=card, model=f"{TP_MODEL} bf16, {CUT_LAYERS} layers", mesh=dict(sp=2),
        spawn_and_run_s=spawn_s, refused=ranks[0]["refused"],
        per_rank={label: [dict(launches=r[label]["launches"], steps_ran=r[label]["steps_ran"],
                               warmup_s=r[label]["warmup_s"], capture_s=r[label]["capture_s"],
                               pool_bytes=r[label]["pool_bytes"]) for r in ranks]
                  for label in RING_ENGINES},
        greedy_tokens={label: sum(map(len, ranks[0][label]["on"])) for label in RING_ENGINES},
        host_ms_per_decode_step={arm: [[w["host_ms_per_step"] for w in rw[arm]]
                                       for rw in windows] for arm in ("on", "off")},
        chunk_device_share={arm: [[w["chunk_device_share"] for w in rw[arm]]
                                  for rw in windows] for arm in ("on", "off")},
        params_bytes_per_rank=[r["params_bytes"] for r in ranks],
        peak_bytes_per_rank=[r["peak_bytes"] for r in ranks])), flush=True)
    return launches


def main() -> None:
    t_script = time.monotonic()
    card = device_line()
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false", flush=True)
        sys.exit(2)
    name = torch.cuda.get_device_name(0)
    print(f"device {name} x{torch.cuda.device_count()} | {card}", flush=True)

    t0 = time.monotonic()
    built = kernels.build_all()
    print(f"kernel build {time.monotonic() - t0:.2f}s {json.dumps(built)}", flush=True)
    for src in built:
        print(f"ptxas {src}: {ptxas_summary(src)}", flush=True)

    t = time.monotonic()
    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    cases = [kernel_cases(m, dt, flush) for m in ("llama3-8b", "llama3-1b")
             for dt in (torch.bfloat16, torch.float32)]
    cases.append(kernel_cases("llama3-70b", torch.bfloat16, flush))
    # One rank's shapes under tp (phase 14): llama3-8b Hkv 4 and 2, 70B Hkv 2.
    cases += [kernel_cases(m, torch.bfloat16, flush, tp=n)
              for m, n in (("llama3-8b", 2), ("llama3-8b", 4), ("llama3-70b", 4))]
    del flush
    t = lap("phase 3", t)
    reference_check()
    qdot_check()
    t = lap("phase 4", t)

    launches = engines(card)
    t = time.monotonic()

    qdot_times(card)
    launches["K1"] += serve_70b(card)
    launches["K4"] += serve_w8a8(card)
    provider_path(card)
    t = lap("phase 7", t)
    for label, n in mixtral(card).items():
        launches[label] += n
    t = lap("phase 10", t)
    for label, n in ops_layer(card).items():
        launches[label] += n
    t = lap("phase 11", t)
    trained, first_loss = training(card)
    for label, n in trained.items():
        launches[label] += n
    t = lap("phase 13", t)
    for label, n in tensor_parallel(card).items():
        launches[label] += n
    t = lap("phase 14", t)
    for label, n in data_sequence_parallel(card).items():
        launches[label] += n
    t = lap("phase 15", t)
    for label, n in pipeline_parallel(card, first_loss).items():
        launches[label] += n
    t = lap("phase 16", t)
    for label, n in ring_mesh(card).items():
        launches[label] += n
    lap("phase 17", t)
    lap("phases 1-17", t_script)
    # llama3-8b bf16, the engines' shape; llama3-70b bf16 (G = 8) beside it.
    main_case, case_70b = cases[0], cases[4]
    entries = []
    for label, (edition, kname, replaces) in KERNELS.items():
        c = main_case[label]
        entries.append(dict(
            name=kname, route="cuda", source=f"omnia_tpu_torch/csrc/{edition}.cu",
            replaces=replaces, launches=launches[label],
            max_abs_err=max(cs[label]["max_abs_err"] for cs in cases),
            ms=c["ms"], plain_ms=c["plain_ms"], bound_ms=c["bound_ms"],
            bound_by=c["bound_by"], library_ms=c["library_ms"],
            ms_llama3_70b=case_70b[label]["ms"], plain_ms_llama3_70b=case_70b[label]["plain_ms"],
            bound_ms_llama3_70b=case_70b[label]["bound_ms"],
            library_ms_llama3_70b=case_70b[label]["library_ms"],
        ))
    print(json.dumps({"kernels": entries}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
