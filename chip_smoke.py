#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, one JSON line each; the first failure ends the run with a non-zero
exit code:

1. device  — the card (``nvidia-smi`` name and power limit), torch, CUDA.
2. build   — every CUDA kernel compiled from the repository's sources (one
   ``nvcc`` per source, all started together).
3. kernels — each kernel against its plain PyTorch version on the card, at
   the main paths' full-width shapes and the JAX kernel tests' shapes, with
   those tests' bars; a bf16 attention case is held against the plain
   version run in f32 on the same (bf16) values, the exact answer that the
   kernel's output rounds.  Attention (H=32, KV=4, hd=64, block 16): ragged
   context lengths up to 1024, prompt lengths that are not multiples of 16
   or 128, Sq=1, a window case and a softcap case; at recurrentgemma's
   hd 256 (H=10, KV=1) with window 2048 and window 32; paged 1e-5 (f32),
   flash 2e-5 (f32), both 2e-2 (bf16).  The paged kernel's split over the
   context at both head shapes: contexts 1, 16, 17, 215, 2048 and 4096
   with B 1 and 4, the wrapper's own n_split and forced 3 and 16, and a
   window of 1000 under the longer contexts.  The flash kernel's 64-row
   tiles at both head shapes, in both dtypes (bf16 runs its tensor-core
   body, f32 its CUDA-core body): Sq = Skv of 1, 63, 64, 65, 131, 200,
   1024 and 2048, causal and not, a window of 48 under a 200-row prompt, a
   cached prefill (37 queries, 256 slots of which the last 106 are -1) and
   a softcap; Sq = 1 over a 512-row dense lane with 231 rows resident
   (a dense lane's decode step after a bucketed prefill), at hd 64 and
   256.  Both attention kernels also at paper-mlp's one query head per KV
   head (H = KV = 8, hd 64; and hd 16, its reduced size).  SSD scan: the
   JAX test's four cases and full-width mamba2-370m shapes (nh 32, hd 64,
   ns 128) at S = 17, 131, 200 and 512, at the edges of the tensor-core body's 64-row
   chunks (S = 1, 63, 64, 65, 129) and at S = 2048, a batch of 4 with an
   odd head count at ns 8 (hd 64 and hd 8), and x/B/C one element past an
   aligned address, each with and without an initial state, xs/B/C in f32
   (the CUDA-core body) and bf16 (the tensor-core body); and as chunked
   and bucketed prefill call it at mamba2's widths: 16-row chunks and a
   final 7-row slice from a carried state, a 16-row final chunk whose last
   9 rows have dt = 0, a 256-row bucket holding 131 real rows; 1e-4 on y
   and on the final state.  RG-LRU scan: the JAX test's four cases at
   1e-4, its
   near-one decay case at 1e-3 with finite outputs (also over 2048 rows),
   and full width (B 1, W 2560) at S = 17, 131 and 200, at the edges of the
   wrapper's super-chunks (S = 1, 128, 129, 512, 513), at S = 2048 and
   4096, at W 2500 (not a multiple of the 16-channel block), at B 4, and
   with forced chunk counts 1, 3 and 16, each with and without a random
   initial state, and a 16-row chunk from a carried state, a 16-row final
   chunk whose last 9 rows are the scan's identity (a = 1, bx = 0) and a
   256-row bucket holding 131 real rows; 1e-4 on hs and h_final; each case
   also records whether the kernel equals ``ref.chunked_reference`` bit
   for bit.  Flash at deepseek-v2-lite's MLA prefill shape (H = KV = 16,
   q/k head dim 192, v head dim 128) in both dtypes: causal prompts of 17,
   131, 200 and 2048 rows, Sq = Skv of 1, 63, 64 and 65 without the causal
   mask, and a 131-row prompt one element past an aligned address; and
   the wrapper's refusal of other split pairs on CUDA tensors.  Head dim
   96 (phi-3-vision, MHA: H = KV = 32) in both kernels and dtypes: paged
   at the trace's contexts behind 576 frontend rows (68-block tables),
   ragged contexts, and the split cases above; flash at the tile cases
   above, prompts of 576 + 131 and 576 + 200 rows, a dense lane's Sq = 1
   over 1,088 rows and a misaligned start.  Seamless-m4t-medium (H = KV =
   16, hd 64): paged at its trace, causal flash, and flash as cross
   attention (non-causal) of a 131-row prompt and of 4 decode lanes over
   1,024 encoder frames, also with the last 24 positions -1.  The head
   shapes of the rest of the registry: command-r-35b's GQA 64 / 8 at hd
   128 and gemma2-9b's 16 / 8 at hd 256 through the split and tile cases
   above (names tagged ``_h64kv8``, ``_h16kv8``); paged at the trace's
   lanes for command-r, mixtral-8x7b (32 / 8, hd 128, window 4096),
   minicpm-2b (MHA, 36 heads at hd 64) and gemma2 (softcap 50, window
   4096 and none), and gemma2's long lane (4,132 rows in a 288-block
   table, past the window) and lanes across it; flash at their prompts,
   a dense lane's decode step, and gemma2's 4,100-row prompt with and
   without the window.  Both wrappers refuse head dim 80 on CUDA
   tensors.
4. kernel_timing — both attention kernels in bf16 at TinyLlama's and
   recurrentgemma's head shapes, and the scans at mamba2-370m's and
   recurrentgemma-2b's (the SSD kernel's bf16 body; the RG-LRU kernel with
   the wrapper's chunk count), before any trace: per launch by CUDA
   events around 50 back-to-back calls and on the profiler's device clock
   (the serve trace's clock), beside the plain version, the bound and, for
   flash, one ``scaled_dot_product_attention`` call on both clocks (a
   yardstick; the port never calls it); at the trace's shapes (paged: its
   first four lanes 16 tokens in; flash and the scans: its 131-row prompt)
   and a long one each (paged: one lane 4096 rows in; flash and the scans:
   a 2048-row prompt); flash also at deepseek-v2-lite's MLA shape (q/k
   192, v 128) at both lengths, with the kernels SDPA ran there (its
   backend); and both attention kernels at phi-3-vision's hd 96, its
   lanes' contexts and its prompt behind 576 frontend rows (paged: 68
   blocks a table; flash: 707 rows, and 2048), and command-r-35b's hd 128 (GQA 64
   / 8), gemma2-9b's hd 256 (16 / 8, softcap 50 and window 4096) and
   minicpm-2b's MHA shape the same way.  SDPA has no softcap, so
   gemma2's flash yardstick is one compiled ``flex_attention`` call with
   the softcap as its score modifier (compiled once per shape before it
   is timed), with its Triton kernel's name and its largest difference
   from the kernel's output.
5. serve   — the three main paths, one after the other (each followed by
   its timing, so that one path's weights never count in the other's
   peak memory), each with every launch counter zeroed
   just before it and read just after, every request checked against
   ``Engine(impl="plain")`` at B=1 (identical tokens, or a plain-path
   top-two margin under 1e-3 at the first divergence), a reduced model
   first.  Each full-width engine is sized by the plan that the planner
   (``repro_torch.core.compile_plan``) compiles for its decode shape
   (``ContinuousEngine.decode_shape_for(512, 4)``) on 4 modelled H100 SXM
   cards, through a plan cache in a temporary directory; the engine is
   given ``plan=`` and neither ``kv_len`` nor ``n_slots``.
   TinyLlama-1.1B (random f32 weights from a seeded generator)
   served by ``ContinuousEngine(paged=True, impl="kernel")`` for 8
   staggered requests: n_layers flash launches per prefill and paged
   launches per decode step, no scan launch.  Then mamba2-370m the same
   way, cut to 16 of its 48 layers (``DEPTH``: every path's host time
   scales with its layers): n_layers SSD-scan launches per prefill, no
   attention launch, and no state slot left in use.  Then
   recurrentgemma-2b, cut to 8 of its 26 layers: its reduced model's
   window of 32 is shorter than the prompts, so window rings free blocks;
   at full width 6 RG-LRU-scan and 2 flash launches per prefill, 2 paged
   launches per decode step, no SSD launch, and no block, ring or state
   slot left in use.  After the paper-mlp serve of phase ``adapt``,
   deepseek-v2-lite-16b (cut to 6 of its 27 MLA layers to keep the
   script inside its limit: layer 0 with a dense FFN and 5 with 64 routed
   experts top-6 and 2 shared, every serving forward MoE-lossless) through ``serve``, ``adapt``, ``serve_modes``, run (a) of
   ``prefix_router`` and ``timing``: 6 flash launches per whole prefill
   and no other kernel (MLA decodes and chunks in plain einsums over the
   latents), its init tree's parameter count beside the reference's
   ``param_count()`` of the cut config, and peak memory of the f32 run.  A diverging request of an MoE model also gives the plain
   path's least gap between the k-th and (k+1)-th router probability
   there (``router_gap``).  Its sampling, speculation, lazy pricing and
   router fleets are left to the CPU tests.  Then the modality-frontend
   archs, each through ``serve``, ``adapt``, ``serve_modes`` and
   ``timing`` (their decode policies and fleets are left to the CPU
   tests): phi-3-vision-4.2b cut to 16 of its 32 layers (2,012,187,648
   parameters in the init tree beside ``param_count()``'s 2,009,041,920
   of the cut config; every request with 576 x 1,024 seeded stub image
   embeddings, projected and paged ahead of its prompt: 16 flash launches
   per prefill, 16 paged per decode step), and
   seamless-m4t-medium (982,579,200 beside 977,744,896; 1,024 x 1,024
   stub frame embeddings through the 12-layer encoder at admission, on
   the plain attention; per prefill 12 causal and 12 cross flash
   launches, per decode step 12 paged and 12 flash, the lanes' single
   query rows over their gathered cross block sets in one launch per
   layer).  Request i's embeddings are standard normal from seed 500 + i
   in every engine and oracle that serves it.  Then the rest of the
   registry, each through ``serve``, ``adapt`` and ``timing``, its
   init tree's parameter count beside ``param_count()`` (of the same
   cut): gemma2-9b at full depth in f32 (42 layers, window 4096 on 21 of
   them beside 21 global ones, softcaps 50 and 30; 42 flash launches per
   prefill, 42 paged per decode step), also through ``serve_modes`` and
   ``long_request``: one 4,100-token prompt for 32 tokens alone in
   ``ContinuousEngine(paged=True, kv_len=4608, n_slots=1)``, its prefill
   windowed past the window and its ring freeing blocks in decode, the
   ring's peak at most ``window_cap_blocks`` (257), the global table's
   beside it; minicpm-2b at full depth; command-r-35b's f32 gate at 8 of
   40 layers and mixtral-8x7b's at 8 of 32 (each f32 at full depth would
   not fit the card).  Their decode policies, prefix cache and fleets are
   left to the CPU tests.
   adapt — after each path's ``serve``: the paper's §3 assistants
   (``adapt_plan``) over that plan under the run's
   ``device_interference`` and ``assistant_callback``; every delta
   must validate through ``CompiledPlan.apply`` and the adapted plan must
   be the trace's replay; a second compile must be a plan-cache hit with
   the same key and an equal artifact; the adapted plan's cost summaries
   must re-verify.  The line gives the plan, the compile, cache-hit and
   adaptation host times, the deltas, and the modelled step times and cut
   (cost-model outputs from the H100 SXM datasheet figures, not
   measurements).  After the three paths, phase ``adapt`` serves
   ``paper-mlp`` (the paper's demo config: 8 layers, d_model 512, MHA with
   8 heads of hd 64) once at full size from its plan, under the same
   token gate and launch counting, and runs the same loop.
   sampler — after ``kernel_timing``: the sampler of one batched decode
   step (every lane's key and ``sample_lanes``) at 4 lanes of each served
   vocabulary (32,000, 50,280, 256,000 and 122,753), its kernel launches per step (one profiled call) and its
   time by CUDA events.
6. serve_modes — after each path's ``serve``, the same trace (reduced
   model first) in the engine's two other modes, in f32, each request
   against phase ``serve``'s plain tokens under the same margin rule:
   bucketed paged lanes with 16-row chunked prefill (the README's serving
   example; n_ssd or n_rglru launches per chunk, i.e. 24 or 10 x the sum
   of ceil(len / 16) over the prompts, no flash launch since a chunk's
   attention is the plain gather, paged launches from the decode steps
   only) and bucketed dense lanes (flash per attention layer and prefill
   or lane decode step, no paged launch).
   sample_spec — after each path's ``serve_modes``, the same trace at full
   width in f32 under the decode policies, each kernel-path run with the
   launch counters zeroed just before it and read just after, the counts
   held to formulas (paged: drafted tokens x the attention layers below
   the draft cap, plus attention layers x batched decode steps; flash:
   attention layers x whole prefills; scans: recurrent layers x (prefills
   + verify passes, counted by wrapping the verify step)): (a) greedy
   speculation (``speculate=4``) against phase ``serve``'s plain tokens
   under the margin rule, drafts made and ``rewound == drafted -
   accepted``; (b) sampled paged decoding (temperature 0.8, top-k 40,
   top-p 0.95, seed 1000 + i) against the same engine with
   ``impl="plain"``, identical or, at the first divergence, the plain
   path's top-two gap of the filtered tempered logits plus the request's
   Gumbel noise under 1e-3; (c) (b) with ``speculate=4``, identical; (a)
   and (c) serve the first 4 prompts for 16 tokens each (a speculative
   round drafts and verifies one lane at a time, host-bound, and the full
   trace would take the script past its limit); (d)
   lazy pricing over a 32-block pool (the self-sized one holds 128):
   phase ``serve``'s plain tokens under the margin rule, at least one
   preemption, ``total_preemptions == scheduler.preemptions``, no block,
   ring or state slot leaked (``check_no_leaks``).  Mamba-2 holds no
   blocks, so (d) is skipped for it with that reason.  The phase prints
   its wall time.
   prefix_router — after each path's ``sample_spec``, at full width in
   f32 with phase ``serve``'s weights, each run with the launch counters
   zeroed just before it and read just after, the counts held to formulas
   summed over the replicas' telemetry (paged: attention layers x batched
   decode steps; flash: attention layers x whole prefills; scans:
   recurrent layers x whole prefills or chunks), each request against the
   plain B=1 engine under the margin rule, and after each run every
   allocator audited (``check``) and, after ``drop_cached``, leak-free
   with no resident byte; every replica serves the one weight dict (peak
   memory under 1.5 x the weights).  TinyLlama serves 18 requests 2 steps
   apart, 32 new tokens each: phase ``serve``'s 8 prompts, the same 8
   again, and the first 128 tokens of the 131-token prompt twice (a
   block-aligned whole hit; the second copy arrives at step 125, after
   the first's admission), (a) through ``ContinuousEngine(paged=True,
   prefix_cache=True)`` (prefix hits, at least one copy-on-write fork),
   (b) the same with bucketed 16-row chunks (fewer chunks than the
   prompts' blocks), (c) through ``Router.build(n_replicas=2,
   disaggregate=True, prefill_chunk=16)`` (roles prefill/decode, at least
   one handoff moving a block) and (d) through two co-located replicas
   with the prefix cache (a placement with a hit); the lines give hit
   rate, forks, peak shared bytes, placement and decode starvation.
   Mamba-2 and RecurrentGemma refuse ``prefix_cache=True`` with the
   reference's reason, and ``Router.build(disaggregate=True)`` degrades
   to two co-located replicas that serve phase ``serve``'s 8 prompts.
7. timing  — each trace in bf16: tokens/s, mean decode step and prefill,
   peak memory, the trace once more untraced in the chunked mode (tokens/s,
   mean decode and chunk step), (c) of phase ``sample_spec`` in bf16,
   untraced (tokens/s, acceptance rate, ms per speculative round), for
   TinyLlama runs (b) and (c) of phase ``prefix_router`` in bf16,
   untraced, each beside the same trace without the prefix cache
   (tokens/s, mean prefill and chunk step, hit rate, decode starvation,
   peak memory, the card's name and power limit),
   and a profiled repeat under ``torch.profiler`` (device time by kernel
   name, the device's busy share of that repeat, and each port kernel's
   device time per launch on the path, with the kernel functions it ran:
   mamba2's must be the SSD kernel's tensor-core body only): of the whole
   trace for the paths in ``WHOLE_PROFILE`` (TinyLlama, mamba2,
   recurrentgemma, deepseek), else of its first 4 requests for 8 tokens
   (the line names the trace).  The later paths' bf16 traces run on bf16
   weights made after their f32 weights are freed (from the same seed:
   the f32 draws rounded, as a cast would give), at the f32 gate's depth
   but for command-r (full depth, 60.6 GB) and mixtral (16 of 32
   layers): tokens/s, decode step, prefill, peak memory, launches held to
   the serve formula and the profiled repeat.  Flash must run its
   tensor-core body.

8. train   — single-card training, after the serving paths, with every
   launch counter zeroed before it and required to stay at zero (training
   runs the plain layers under autograd; no kernel has a backward).
   (a) The card against the host CPU: each of the four configs of PR 23
   and mixtral-8x7b, phi-3-vision-4.2b and seamless-m4t-medium cut to one
   cycle repeat (deepseek-v2-lite-16b to 2 layers: its dense first layer
   and one MoE layer) at its published widths, one f32 ``loss_fn`` +
   autograd step at B 2, S 64 (with the frontend archs' stub rows) from
   the same weights (drawn on the card, copied to the host) and batch on
   both; loss and the MoE aux loss within 1e-5 relative, grad norm within
   1e-4 relative, every gradient leaf within 1e-4 of that leaf's max-abs.
   (b) Full width in bf16 through ``repro_torch.launch.train.main``:
   TinyLlama B 8, S 512, 20 steps at ``--lr 3e-3`` cosine (the mean of its
   last 5 losses must be 0.2 under that of its first 5), Mamba-2 B 4, S
   512, RecurrentGemma B 2, S 256 and paper-mlp B 8, S 512, 5 steps each at
   the launcher's defaults, at full depth; then deepseek-v2-lite-16b (cut
   to 6 of 27 layers, ``--layers``), mixtral-8x7b (2 of 32), phi-3-vision
   (full depth, 576 stub image rows ahead of each sequence) and
   seamless-m4t-medium (full depth, 1,024 stub frames), 5 steps each
   (``TRAIN_RUNS``); every loss and grad norm finite and every parameter
   leaf moved; the line gives the median step (``Telemetry``), tokens/s,
   peak device memory, the aux losses, model FLOP/s (6 x parameters x
   tokens per second) as a share of the 989 TFLOP/s bf16 peak, and the
   plan's modelled step time.
   (c) Gradient accumulation: full TinyLlama in f32, B 4, S 256,
   ``grad_accum=2`` against 1, |d loss| < 1e-4 and max |d param| < 5e-3
   (the reference's bars).  (d) Resume: full paper-mlp in f32 through the
   launcher, 6 steps straight against 3 steps, a checkpoint, and 3 more
   with ``--resume``; the losses of steps 4-6 within 1e-5 relative.

9. pipeline — the GPipe pipeline (``repro_torch.train.
   make_pipeline_train_step``), last, with every launch counter zeroed
   before it and required to stay at zero.  Its stages go on distinct
   cards when the machine has more than one, and share the card
   otherwise; each line says which.  (a) Full TinyLlama in f32, 22 layers
   in 2 stages and in 11, M = 4, B 8, S 256: loss within 1e-5 relative
   and every gradient leaf (joined back) within 1e-4 of its max-abs of the
   one-card train step's.  (b) Mixtral-8x7b cut to 2 layers in f32, 2
   stages, M = 2, B 4, S 64: the same on the card and on the host CPU at
   the same weights, at the same bars.  (c) bf16 TinyLlama, B 8, S 512:
   the median of 3 train steps through the pipeline (2 stages) at M = 4
   and M = 8 beside the one-card step at the same batch.  With the stages
   on one card a pipeline step does the one-card step's work in M
   microbatches one after another, so its time over the one-card step's
   is the schedule's host cost, not an overlap across cards.

Then the ``{"kernels": [...]}`` summary line (paged and flash attention at
TinyLlama's hd 64, with recurrentgemma's hd 256, phi-3-vision's hd 96,
command-r-35b's hd 128 and, for flash, deepseek-v2-lite's q/k 192, v 128
beside them; every kernel
with its long shape; launches summed over every full-width run of phases
``serve``, ``serve_modes``, ``sample_spec``, ``prefix_router``,
``long_request`` and ``adapt``, and by run),
the wall time of each phase, the card's ``name, power.limit`` line, and
last ``{"ok": true, "device": ...}``.  The build phase also counts each kernel
function's tensor-core instructions (``cuobjdump -sass``).  Bounds use the
H100 SXM data-sheet peaks: 3.35 TB/s of device memory and 989 TFLOP/s of
dense bf16 tensor-core math (the SSD kernel's bf16 body), both read from
the planner's ``repro_torch.core.H100_SXM``, and 67 TFLOP/s of f32 math
outside the tensor cores (given beside it for the SSD scan).
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
F32_FLOPS_PER_S = 67e12
ARCH = "tinyllama-1.1b"
SSM_ARCH = "mamba2-370m"
RG_ARCH = "recurrentgemma-2b"
MLP_ARCH = "paper-mlp"
DS_ARCH = "deepseek-v2-lite-16b"
# repro.models.config.ModelConfig.param_count() of DS_ARCH's config (the
# port's ModelConfig has no param_count; its init tree is counted here)
VLM_ARCH = "phi-3-vision-4.2b"
ED_ARCH = "seamless-m4t-medium"
GEMMA_ARCH = "gemma2-9b"
CPM_ARCH = "minicpm-2b"
CR_ARCH = "command-r-35b"
MX_ARCH = "mixtral-8x7b"
# the reference configs' param_count() (of the config cut to that many
# layers where a path cuts its depth), beside the port's init tree
REFERENCE_PARAM_COUNT = {DS_ARCH: 15_759_554_560, VLM_ARCH: 3_821_079_552,
                         ED_ARCH: 977_744_896, GEMMA_ARCH: 9_241_404_928,
                         CPM_ARCH: 2_724_880_896,
                         CR_ARCH: 30_283_538_432, MX_ARCH: 46_702_792_704,
                         (DS_ARCH, 6): 3_436_472_320,
                         (VLM_ARCH, 16): 2_009_041_920,
                         (CR_ARCH, 8): 7_734_435_840,
                         (MX_ARCH, 8): 11_872_309_248,
                         (MX_ARCH, 16): 23_482_470_400}
# depth cuts (layers run of the arch's n_layers), made to keep the script
# inside its time limit on a slow host (mamba2, recurrentgemma, phi-3 and
# deepseek: host time that scales with the layers; uncut, they took the
# script past 1,200 s on an H100 host 25-45 % slower than another) or
# one card's 80 GB (the f32 gates of command-r and mixtral; their bf16
# timing: command-r at full depth, mixtral at 16 of 32)
DEPTH = {SSM_ARCH: 16, RG_ARCH: 8, VLM_ARCH: 16, DS_ARCH: 6, CR_ARCH: 8,
         MX_ARCH: 8}
# the bf16 timing's depth where it is not the f32 gate's
BF16_DEPTH = {CR_ARCH: 40, MX_ARCH: 16}
# gemma2's long request: a prompt past its 4,096-row window, served alone
# in one lane of LONG_KV_LEN rows
LONG_PROMPT = 4100
LONG_KV_LEN = 4608
# request i of a trace carries stub frontend embeddings seeded by this + i
FRONTEND_SEED = 500
# the profiled repeat of a path's bf16 trace: the whole trace for these
# paths, else its first 4 requests for 8 tokens (the profiler's processing
# grows with the events: 11-16 s for the 4 x 8 repeat of a 40-layer path)
WHOLE_PROFILE = (ARCH, SSM_ARCH, RG_ARCH, DS_ARCH)
PROFILE_PROMPTS = 4
PROFILE_NEW = 8
PLAN_DEVICES = 4        # modelled H100 SXM cards the serve plans are for
PROMPT_LENS = (17, 200, 45, 131, 77, 163, 29, 111)
MAX_NEW = 32
KV_LEN = 512
N_SLOTS = 4
BLOCK = 16
STAGGER = 2
MARGIN = 1e-3
PAGED = {"paged": True}
# phase sample_spec: per-request sampling (seed SAMPLE_SEED + i), the
# draft depth, and a pool small enough that lazy pricing preempts (the
# self-sized paged pool of TinyLlama and recurrentgemma holds 128 blocks)
SAMPLED = {"temperature": 0.8, "top_k": 40, "top_p": 0.95}
SAMPLE_SEED = 1000
SPECULATE = 4
LAZY_BLOCKS = 32
# the speculative runs serve the first SPEC_PROMPTS prompts for SPEC_NEW
# tokens each: a round drafts and verifies one lane at a time, about four
# forward passes of host launches for one to five tokens, so the whole
# trace would take the script past its time limit
SPEC_PROMPTS = 4
SPEC_NEW = 16
# phase prefix_router: phase serve's prompts, the same again, and the first
# PREFIX_ALIGNED tokens of the 131-token prompt twice (block-aligned: a
# whole hit recomputes its last position inside a shared block, which
# forks copy-on-write), STAGGER steps apart, but the last copy arrives at
# ALIGNED_LATE, one step after run (a) admits the first copy (step 124 in a
# CPU rehearsal of the phase: with no eos_id the schedule depends on the
# trace alone), so that the first has committed when the second matches
PREFIX_ALIGNED = 128
ALIGNED_LATE = 125
PREFIX_CHUNK = 16
# the engine's other modes, run in phase serve_modes: the README's serving
# example (bucketed paged lanes, 16-row chunks) and bucketed dense lanes
SERVE_MODES = {
    "paged_bucket_chunk": {"paged": True, "bucket_prompts": True,
                           "prefill_chunk": 16},
    "dense_bucket": {"paged": False, "bucket_prompts": True},
}
TOL = {("paged", "float32"): 1e-5, ("flash", "float32"): 2e-5,
       ("paged", "bfloat16"): 2e-2, ("flash", "bfloat16"): 2e-2,
       ("ssd", "float32"): 1e-4, ("ssd", "bfloat16"): 1e-4,
       ("rglru", "float32"): 1e-4, ("rglru", "near_one"): 1e-3}
SSD_CHUNK = 32          # the chunk ssd_cost counts C B^T over
# (hd, H, KV, name tag) of the kernels' split and tile cases: TinyLlama's,
# recurrentgemma's, phi-3-vision's, command-r-35b's and gemma2-9b's heads
HEAD_SHAPES = ((64, 32, 4, ""), (256, 10, 1, ""), (96, 32, 32, ""),
               (128, 64, 8, "_h64kv8"), (256, 16, 8, "_h16kv8"))
# phase train (a): (arch, layers: None for one cycle repeat); deepseek's
# first segment is one dense layer, so 2 layers reach an MoE layer
TRAIN_CHECKS = ((ARCH, None), (SSM_ARCH, None), (RG_ARCH, None),
                (MLP_ARCH, None), (DS_ARCH, 2), (MX_ARCH, None),
                (VLM_ARCH, None), (ED_ARCH, None))
# phase train (b): (arch, batch, seq, steps, extra launcher flags); the
# depth cuts keep bf16 parameters, gradients, two f32 moments and the
# activations inside 80 GB (deepseek at 27 layers is 15.7 B parameters,
# mixtral at 32 is 46.7 B: 189 and 560 GB of training state)
TRAIN_RUNS = ((ARCH, 8, 512, 20, ("--lr", "3e-3", "--schedule", "cosine")),
              (SSM_ARCH, 4, 512, 5, ()), (RG_ARCH, 2, 256, 5, ()),
              (MLP_ARCH, 8, 512, 5, ()),
              (DS_ARCH, 4, 512, 5, ("--layers", str(DEPTH[DS_ARCH]))),
              (MX_ARCH, 4, 512, 5, ("--layers", "2")),
              (VLM_ARCH, 2, 512, 5, ()), (ED_ARCH, 4, 512, 5, ()))
# phase pipeline: stage counts of full TinyLlama (22 layers), microbatches
PIPE_STAGES = (2, 11)
PIPE_MICRO = 4
PIPE_TIMED_MICRO = (4, 8)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def mma_counts(name: str):
    """Tensor-core instructions per kernel function in kernel ``name``'s
    library, by ``cuobjdump -sass``: ``{function: {opcode: count}}`` for
    the opcodes that name a matrix product (``HMMA...``, ``HGMMA...``);
    None where the toolkit has no ``cuobjdump``."""
    import re
    import shutil
    from repro_torch.kernels import _build
    tool = Path(_build.nvcc()).parent / "cuobjdump"
    if not tool.exists():
        tool = shutil.which("cuobjdump")
        if tool is None:
            return None
    out = subprocess.run([str(tool), "-sass", str(_build.library_path(name))],
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout
    # "/*0a40*/  @P0 HMMA.16816.F32.BF16 R4, R8, R12, R4 ;": the opcode
    # follows the address and an optional predicate
    opcode = re.compile(r"/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)")
    counts, fn = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            continue
        m = opcode.search(line)
        if fn is not None and m and "MMA" in m.group(1).split(".")[0]:
            per = counts.setdefault(fn, {})
            per[m.group(1)] = per.get(m.group(1), 0) + 1
    return counts


def time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean milliseconds per call, by CUDA events around ``iters`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_us(evt) -> float:
    return float(getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0.0)))


# -- kernel inputs ------------------------------------------------------------

def paged_inputs(gen, dev, dtype, B, H, KV, hd, bs, max_blocks, lens):
    import torch
    n_pages = B * max_blocks + 1
    q = torch.randn((B, H, hd), generator=gen, device=dev).to(dtype)
    kp = torch.randn((n_pages, bs, KV, hd), generator=gen,
                     device=dev).to(dtype)
    vp = torch.randn((n_pages, bs, KV, hd), generator=gen,
                     device=dev).to(dtype)
    perm = torch.randperm(n_pages - 1, generator=gen, device=dev)
    tables = perm[:B * max_blocks].reshape(B, max_blocks).to(torch.int32)
    lens = torch.tensor(lens, dtype=torch.int32, device=dev)
    return q, kp, vp, tables, lens


def flash_inputs(gen, dev, dtype, B, Sq, Skv, H, KV, hd, dv=None):
    """q, k at head dim ``hd`` and v at ``dv`` (default ``hd``)."""
    import torch
    q = torch.randn((B, Sq, H, hd), generator=gen, device=dev).to(dtype)
    k = torch.randn((B, Skv, KV, hd), generator=gen, device=dev).to(dtype)
    v = torch.randn((B, Skv, KV, dv or hd), generator=gen,
                    device=dev).to(dtype)
    return q, k, v


def mla_dims(cfg) -> tuple:
    """(H, KV, q/k head dim, v head dim) of ``cfg``'s prefill attention:
    MLA expands its latents to ``qk_nope + qk_rope`` wide keys and
    ``v_head_dim`` wide values on every head."""
    if cfg.kv_lora_rank:
        return (cfg.n_heads, cfg.n_heads, cfg.qk_nope_dim + cfg.qk_rope_dim,
                cfg.v_head_dim)
    return cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.head_dim


def attention_layers(cfg) -> tuple:
    """(global or sliding-window attention layers, MLA layers) of
    ``cfg``: the first launch the paged kernel per decode step and flash
    per whole prefill (and per dense-lane decode step); MLA launches flash
    per whole prefill only (its decode and chunk rows are plain absorbed
    einsums over the latents)."""
    mixers = [s.mixer for s in cfg.layers()]
    return (sum(1 for m in mixers if m in ("global", "local")),
            mixers.count("mla"))


def ssd_inputs(gen, dev, dtype, B, S, nh, hd, ns):
    """The recipe of the JAX kernel test's ``_inputs``: x ~ N(0, 1), dt =
    softplus(N(0, 1)), A = -exp(0.3 N(0, 1)), B, C ~ N(0, 1/ns), D = 1."""
    import torch
    import torch.nn.functional as F
    xs = torch.randn((B, S, nh, hd), generator=gen, device=dev)
    dt = F.softplus(torch.randn((B, S, nh), generator=gen, device=dev))
    A = -torch.exp(torch.randn((nh,), generator=gen, device=dev) * 0.3)
    Bm = torch.randn((B, S, ns), generator=gen, device=dev) / ns ** 0.5
    Cm = torch.randn((B, S, ns), generator=gen, device=dev) / ns ** 0.5
    D = torch.ones((nh,), device=dev)
    return xs.to(dtype), dt, A, Bm.to(dtype), Cm.to(dtype), D


def rglru_inputs(gen, dev, B, S, W):
    """The recipe of the JAX kernel test: a = sigmoid(N(0, 1)), bx ~
    N(0, 1), float32."""
    import torch
    a = torch.sigmoid(torch.randn((B, S, W), generator=gen, device=dev))
    bx = torch.randn((B, S, W), generator=gen, device=dev)
    return a, bx


def exact_inputs(*ts) -> list:
    """``ts`` with every floating tensor in f32.  A bf16 attention case's
    plain version runs on these: the plain version rounds its
    probabilities to bf16 where the kernel rounds unnormalised ones, and
    both round the output, so two correct bf16 results can sit an ulp
    apart (0.03125 for outputs of 4 and more, past the 2e-2 bar); against
    the f32 answer a correct kernel is off by its own rounding alone."""
    return [t.float() if t.is_floating_point() else t for t in ts]


def misaligned(t):
    """A contiguous copy of ``t`` that starts one element past an aligned
    address (as a view into a larger buffer can)."""
    import torch
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def rglru_bitwise(a, bx, h0, hs, hf, n_chunks) -> bool:
    """Whether the kernel's outputs equal the plain version in the kernel's
    order (``chunked_reference``) bit for bit, at the chunk count the
    kernel ran."""
    import torch
    from repro_torch.kernels.rglru_scan import ops as rglru_ops
    from repro_torch.kernels.rglru_scan import ref as rglru_ref
    B, S, W = a.shape
    if n_chunks is None:
        n_sm = torch.cuda.get_device_properties(a.device).multi_processor_count
        n_chunks = rglru_ops.choose_chunks(B, S, W, n_sm)
    he, hfe = rglru_ref.chunked_reference(a, bx, h0, n_chunks=n_chunks)
    return bool(torch.equal(hs, he) and torch.equal(hf, hfe))


def rglru_cost(B, S, W) -> tuple:
    """(bytes, f32 flops) of one RG-LRU scan with an initial state: a and
    bx read once, hs written once, h0 read and h_final written; one
    multiply and one add per element."""
    return 4 * (3 * B * S * W + 2 * B * W), 2 * B * S * W


def ssd_cost(S, nh, hd, ns, x_bytes, seeded) -> tuple:
    """(bytes, f32 flops) the SSD scan needs for one sequence: every input
    read once (h0 when given), y and the state written once; the products
    C B^T over the kernel's causal chunk pairs, M x, C h^T and the state
    update."""
    pairs = sum(n * (n + 1) // 2 for n in
                [min(SSD_CHUNK, S - c) for c in range(0, S, SSD_CHUNK)])
    nbytes = (S * nh * hd * x_bytes + S * nh * 4 + 2 * nh * 4
              + 2 * S * ns * x_bytes + S * nh * hd * 4
              + nh * hd * ns * 4 * (2 if seeded else 1))
    flops = (2 * ns * pairs + 2 * nh * hd * pairs
             + 4 * S * nh * hd * ns)
    return nbytes, flops


def phase_kernels(dev) -> dict:
    """Each kernel against its plain version; returns the worst error per
    kernel at the main paths' full-width f32 shapes."""
    import torch
    from repro_torch import configs
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.paged_attention import ref as pa_ref
    from repro_torch.kernels.rglru_scan import ops as rglru_ops
    from repro_torch.kernels.rglru_scan import ref as rglru_ref
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan import ref as ssd_ref

    gen = torch.Generator(device=dev).manual_seed(1234)
    rows = []
    main_err = {"paged_attention": 0.0, "flash_attention": 0.0,
                "ssd_scan": 0.0}
    paged_cases = [
        # name, B, H, KV, hd, bs, max_blocks, lens, window, softcap, n_split
        ("main", 4, 32, 4, 64, 16, 64, [1, 17, 500, 1024], 0, 0.0, None),
        ("main_trace", 4, 32, 4, 64, 16, 32, [18, 201, 46, 132], 0, 0.0,
         None),
        ("window", 4, 32, 4, 64, 16, 64, [3, 77, 600, 1024], 100, 0.0, None),
        ("softcap", 4, 32, 4, 64, 16, 64, [9, 260, 511, 1000], 0, 30.0,
         None),
        ("hd16", 3, 4, 2, 16, 16, 8, [1, 50, 128], 0, 0.0, None),
        ("hd128", 2, 8, 1, 128, 16, 16, [33, 256], 0, 0.0, None),
        # recurrentgemma-2b: MQA, hd 256, its window and a short one
        ("rg_main_trace", 4, 10, 1, 256, 16, 32, [18, 201, 46, 132], 2048,
         0.0, None),
        ("rg_window32", 4, 10, 1, 256, 16, 32, [3, 77, 300, 512], 32, 0.0,
         None),
        # paper-mlp: MHA, one query head per KV head (G = 1), at full
        # width (hd 64) and at its reduced size (hd 16)
        ("mlp_main_trace", 4, 8, 8, 64, 16, 32, [18, 201, 46, 132], 0, 0.0,
         None),
        ("mlp_main", 4, 8, 8, 64, 16, 64, [1, 17, 500, 1024], 0, 0.0,
         None),
        ("mlp_split3", 4, 8, 8, 64, 16, 64, [1, 17, 500, 1024], 0, 0.0, 3),
        ("mlp_hd16", 3, 4, 4, 16, 16, 8, [1, 50, 128], 0, 0.0, None),
        # phi-3-vision: MHA at hd 96 (H = KV = 32), the trace's lanes 16
        # tokens in behind 576 frontend rows (68-block tables), ragged
        # contexts, and a forced split
        ("phi3_main_trace", 4, 32, 32, 96, 16, 68, [610, 793, 638, 724], 0,
         0.0, None),
        ("phi3_main", 4, 32, 32, 96, 16, 64, [1, 17, 500, 1024], 0, 0.0,
         None),
        ("phi3_split3", 4, 32, 32, 96, 16, 64, [1, 17, 500, 1024], 0, 0.0,
         3),
        # seamless-m4t-medium's decoder self-attention: MHA, H = KV = 16
        ("ed_main_trace", 4, 16, 16, 64, 16, 32, [18, 201, 46, 132], 0, 0.0,
         None),
        # command-r-35b: GQA 64 / 8 at hd 128; mixtral-8x7b: 32 / 8 at hd
        # 128 with its window of 4096; minicpm-2b: MHA, 36 heads at hd 64
        ("cr_main_trace", 4, 64, 8, 128, 16, 32, [18, 201, 46, 132], 0,
         0.0, None),
        ("cr_main", 4, 64, 8, 128, 16, 64, [1, 17, 500, 1024], 0, 0.0,
         None),
        ("mx_main_trace", 4, 32, 8, 128, 16, 32, [18, 201, 46, 132], 4096,
         0.0, None),
        ("cpm_main_trace", 4, 36, 36, 64, 16, 32, [18, 201, 46, 132], 0,
         0.0, None),
        # gemma2-9b: GQA 16 / 8 at hd 256, softcap 50, window 4096 (its
        # global layers: no window); the long request's lane (kv_len 4608:
        # 288-block tables) past the window, and ragged lanes across it
        ("g2_main_trace", 4, 16, 8, 256, 16, 32, [18, 201, 46, 132], 4096,
         50.0, None),
        ("g2_global_trace", 4, 16, 8, 256, 16, 32, [18, 201, 46, 132], 0,
         50.0, None),
        ("g2_long_window", 1, 16, 8, 256, 16, 288, [4132], 4096, 50.0,
         None),
        ("g2_long_global", 1, 16, 8, 256, 16, 288, [4132], 0, 50.0, None),
        ("g2_window_b4", 4, 16, 8, 256, 16, 288, [100, 4097, 4600, 17],
         4096, 50.0, None),
    ]
    # the split over the context: contexts of 1 row to 4096, one lane and
    # four, the wrapper's own n_split and forced ones (single-row lanes
    # leave most splits empty), and a window shorter than the context
    # (command-r's and gemma2's head shapes carry their heads in the name)
    for hd, H, KV, tag in HEAD_SHAPES:
        for B, lens in ((1, [4096]), (1, [1]), (4, [1, 16, 17, 215]),
                        (4, [2048, 4096, 17, 1])):
            mb = -(-max(lens) // 16)
            for n_split in (None, 3, 16):
                paged_cases.append(
                    (f"split_hd{hd}{tag}_b{B}_ctx{max(lens)}_"
                     f"n{n_split or 'auto'}",
                     B, H, KV, hd, 16, mb, lens, 0, 0.0, n_split))
        for n_split in (None, 5):
            paged_cases.append(
                (f"split_hd{hd}{tag}_window1000_n{n_split or 'auto'}", 4, H,
                 KV, hd, 16, 256, [100, 2048, 4096, 17], 1000, 0.0, n_split))
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for (name, B, H, KV, hd, bs, mb, lens, win, cap,
             n_split) in paged_cases:
            q, kp, vp, tbl, ln = paged_inputs(gen, dev, dtype, B, H, KV,
                                              hd, bs, mb, lens)
            got = pa_ops.paged_attention(q, kp, vp, tbl, ln, window=win,
                                         logit_softcap=cap, n_split=n_split)
            torch.cuda.synchronize()
            exp = pa_ref.reference(*exact_inputs(q[:, None], kp, vp), tbl,
                                   ln, q_positions=(ln - 1)[:, None],
                                   window=win, logit_softcap=cap)[:, 0]
            err = (got.float() - exp.float()).abs().max().item()
            tol = TOL[("paged", dname)]
            rows.append({"kernel": "paged_attention", "case": name,
                         "dtype": dname, "max_abs_err": err, "tol": tol,
                         "ok": err < tol})
            if dname == "float32" and name.startswith(
                    ("main", "rg_", "mlp_main", "phi3_main", "ed_", "cr_",
                     "mx_", "cpm_", "g2_")):
                main_err["paged_attention"] = max(
                    main_err["paged_attention"], err)
    flash_cases = [
        # name, B, Sq, Skv, H, KV, hd, causal, window, softcap, empty_from
        ("prefill_200", 1, 200, 200, 32, 4, 64, True, 0, 0.0, None),
        ("prefill_17", 1, 17, 17, 32, 4, 64, True, 0, 0.0, None),
        ("prefill_131_b2", 2, 131, 131, 32, 4, 64, True, 0, 0.0, None),
        ("decode_sq1", 1, 1, 512, 32, 4, 64, True, 0, 0.0, 300),
        ("window", 1, 200, 200, 32, 4, 64, True, 64, 0.0, None),
        ("softcap", 1, 150, 150, 32, 4, 64, True, 0, 50.0, None),
        ("hd16", 2, 37, 37, 4, 2, 16, True, 0, 0.0, None),
        ("hd128_noncausal", 1, 70, 90, 8, 2, 128, False, 0, 0.0, None),
        ("rg_prefill_131", 1, 131, 131, 10, 1, 256, True, 2048, 0.0, None),
        ("rg_prefill_200_window32", 1, 200, 200, 10, 1, 256, True, 32, 0.0,
         None),
        ("rg_decode_sq1", 1, 1, 512, 10, 1, 256, True, 2048, 0.0, 300),
        # a dense lane's decode step after a bucketed prefill: the longest
        # trace request's 200 + 31 rows resident, the rest empty
        ("dense_lane_sq1", 1, 1, 512, 32, 4, 64, True, 0, 0.0, 231),
        ("rg_dense_lane_sq1", 1, 1, 512, 10, 1, 256, True, 2048, 0.0, 231),
        # paper-mlp: G = 1 at hd 64 (full width) and hd 16 (reduced)
        ("mlp_prefill_131", 1, 131, 131, 8, 8, 64, True, 0, 0.0, None),
        ("mlp_prefill_200", 1, 200, 200, 8, 8, 64, True, 0, 0.0, None),
        ("mlp_decode_sq1", 1, 1, 512, 8, 8, 64, True, 0, 0.0, 300),
        ("mlp_tile_sq65_full", 1, 65, 65, 8, 8, 64, False, 0, 0.0, None),
        ("mlp_cached", 2, 37, 256, 8, 8, 64, True, 0, 0.0, 150),
        ("mlp_hd16", 2, 37, 37, 4, 4, 16, True, 0, 0.0, None),
        # phi-3-vision at hd 96: prefills of the trace's 131- and 200-token
        # prompts behind 576 frontend rows, a dense lane's decode step
        # (1,088 rows, 807 resident), and a misaligned start
        ("phi3_prefill_707", 1, 707, 707, 32, 32, 96, True, 0, 0.0, None),
        ("phi3_prefill_776", 1, 776, 776, 32, 32, 96, True, 0, 0.0, None),
        ("phi3_decode_sq1", 1, 1, 1088, 32, 32, 96, True, 0, 0.0, 807),
        ("phi3_unaligned_131", 1, 131, 131, 32, 32, 96, True, 0, 0.0, None),
        # seamless-m4t-medium: causal self-attention, and cross attention
        # (non-causal) of a 131-row prompt and of 4 decode lanes over the
        # 1,024 encoder frames, and over a gathered set whose last 24 rows
        # are past the frames (position -1)
        ("ed_prefill_131", 1, 131, 131, 16, 16, 64, True, 0, 0.0, None),
        ("ed_cross_sq131", 1, 131, 1024, 16, 16, 64, False, 0, 0.0, None),
        ("ed_cross_sq1_b4", 4, 1, 1024, 16, 16, 64, False, 0, 0.0, None),
        ("ed_cross_tail_sq131", 1, 131, 1024, 16, 16, 64, False, 0, 0.0,
         1000),
        ("ed_cross_tail_sq1_b4", 4, 1, 1024, 16, 16, 64, False, 0, 0.0,
         1000),
        # command-r-35b (hd 128, G 8), mixtral-8x7b (hd 128, G 4, window
        # 4096), minicpm-2b (MHA, 36 heads): the trace's prompts and a
        # dense lane's decode step
        ("cr_prefill_131", 1, 131, 131, 64, 8, 128, True, 0, 0.0, None),
        ("cr_prefill_200", 1, 200, 200, 64, 8, 128, True, 0, 0.0, None),
        ("cr_decode_sq1", 1, 1, 512, 64, 8, 128, True, 0, 0.0, 231),
        ("mx_prefill_131", 1, 131, 131, 32, 8, 128, True, 4096, 0.0, None),
        ("cpm_prefill_131", 1, 131, 131, 36, 36, 64, True, 0, 0.0, None),
        ("cpm_decode_sq1", 1, 1, 512, 36, 36, 64, True, 0, 0.0, 231),
        # gemma2-9b (hd 256, G 2, softcap 50): its window layers' and global
        # layers' prefills, a dense lane's decode step, and the long
        # request's 4,100-row prompt past the 4,096-row window
        ("g2_prefill_131", 1, 131, 131, 16, 8, 256, True, 4096, 50.0, None),
        ("g2_global_200", 1, 200, 200, 16, 8, 256, True, 0, 50.0, None),
        ("g2_decode_sq1", 1, 1, 512, 16, 8, 256, True, 4096, 50.0, 231),
        ("g2_long_4100", 1, 4100, 4100, 16, 8, 256, True, 4096, 50.0,
         None),
        ("g2_long_global_4100", 1, 4100, 4100, 16, 8, 256, True, 0, 50.0,
         None),
    ]
    # the tensor-core tiling: query lengths around and far past the 64-row
    # tile, causal and not, a window that cuts the prompt, a cached prefill
    # (Sq < Skv, -1 slots past the cache's fill) and a softcap
    for hd, H, KV, tag in HEAD_SHAPES:
        for Sq in (1, 63, 64, 65, 131, 200, 1024, 2048):
            for causal in (True, False):
                flash_cases.append(
                    (f"tile_sq{Sq}_hd{hd}{tag}_"
                     f"{'causal' if causal else 'full'}",
                     1, Sq, Sq, H, KV, hd, causal, 0, 0.0, None))
        flash_cases += [
            (f"tile_window48_hd{hd}{tag}", 1, 200, 200, H, KV, hd, True, 48,
             0.0, None),
            (f"tile_cached_hd{hd}{tag}", 2, 37, 256, H, KV, hd, True, 0, 0.0,
             150),
            (f"tile_softcap_hd{hd}{tag}", 1, 131, 131, H, KV, hd, True, 0,
             30.0, None),
        ]
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for (name, B, Sq, Skv, H, KV, hd, causal, win, cap,
             empty_from) in flash_cases:
            q, k, v = flash_inputs(gen, dev, dtype, B, Sq, Skv, H, KV, hd)
            if "unaligned" in name:
                q, k, v = misaligned(q), misaligned(k), misaligned(v)
            kpos = torch.arange(Skv, dtype=torch.int32, device=dev)
            if empty_from is not None:     # dense cache: unwritten slots
                kpos = torch.where(kpos < empty_from, kpos, -1)
                qpos = torch.arange(empty_from - Sq, empty_from,
                                    dtype=torch.int32, device=dev)
            else:
                qpos = torch.arange(Skv - Sq, Skv, dtype=torch.int32,
                                    device=dev)
            got = fa_ops.flash_attention(q, k, v, q_positions=qpos,
                                         k_positions=kpos, causal=causal,
                                         window=win, logit_softcap=cap)
            torch.cuda.synchronize()
            exp = fa_ref.reference(*exact_inputs(q, k, v), q_positions=qpos,
                                   k_positions=kpos, causal=causal,
                                   window=win, logit_softcap=cap)
            err = (got.float() - exp.float()).abs().max().item()
            tol = TOL[("flash", dname)]
            rows.append({"kernel": "flash_attention", "case": name,
                         "dtype": dname, "max_abs_err": err, "tol": tol,
                         "ok": err < tol})
            if dname == "float32" and name.startswith(
                    ("prefill", "decode", "rg_", "mlp_prefill",
                     "mlp_decode", "phi3_prefill", "phi3_decode", "ed_",
                     "cr_", "mx_", "cpm_", "g2_")):
                main_err["flash_attention"] = max(
                    main_err["flash_attention"], err)
    # deepseek-v2-lite's MLA prefill: H = KV = 16, q/k 192 (128 + 64 RoPE
    # columns), v 128; the trace's prompts, the 64-row tile's edges, a long
    # prompt, and inputs one element past an aligned address (the wrapper
    # realigns them for the bf16 body's TMA)
    H, KV, dqk, dv = mla_dims(configs.get(DS_ARCH))
    mla_cases = [(f"mla_prefill_{S}", S, True, False)
                 for S in (17, 131, 200, 2048)]
    mla_cases += [(f"mla_tile_sq{S}_full", S, False, False)
                  for S in (1, 63, 64, 65)]
    mla_cases += [("mla_unaligned_131", 131, True, True)]
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for name, S, causal, unaligned in mla_cases:
            q, k, v = flash_inputs(gen, dev, dtype, 1, S, S, H, KV, dqk, dv)
            if unaligned:
                q, k, v = misaligned(q), misaligned(k), misaligned(v)
            pos = torch.arange(S, dtype=torch.int32, device=dev)
            got = fa_ops.flash_attention(q, k, v, q_positions=pos,
                                         k_positions=pos, causal=causal)
            torch.cuda.synchronize()
            exp = fa_ref.reference(*exact_inputs(q, k, v), q_positions=pos,
                                   k_positions=pos, causal=causal)
            check(got.shape == exp.shape == (1, S, H, dv),
                  f"{name}: output {tuple(got.shape)}")
            err = (got.float() - exp.float()).abs().max().item()
            tol = TOL[("flash", dname)]
            rows.append({"kernel": "flash_attention", "case": name,
                         "dtype": dname, "dqk": dqk, "dv": dv,
                         "max_abs_err": err, "tol": tol, "ok": err < tol})
            if dname == "float32" and name.startswith("mla_prefill"):
                main_err["flash_attention"] = max(
                    main_err["flash_attention"], err)
    # a head dim neither kernel takes is refused on the card too
    q, kp, vp, tbl, ln = paged_inputs(gen, dev, torch.bfloat16, 1, 2, 2,
                                      80, 16, 2, [20])
    fq, fk, fv = flash_inputs(gen, dev, torch.bfloat16, 1, 8, 8, 2, 2, 80)
    pos = torch.arange(8, dtype=torch.int32, device=dev)
    for kernel, call in (
            ("paged_attention",
             lambda: pa_ops.paged_attention(q, kp, vp, tbl, ln)),
            ("flash_attention",
             lambda: fa_ops.flash_attention(fq, fk, fv, q_positions=pos,
                                            k_positions=pos))):
        try:
            call()
            refused = False
        except ValueError:
            refused = True
        rows.append({"kernel": kernel, "case": "refuses_hd80",
                     "dtype": "bfloat16", "refused": refused,
                     "ok": refused})
    # every other split pair is refused on the card too
    for bad_dqk, bad_dv in ((192, 64), (128, 192), (256, 128)):
        q, k, v = flash_inputs(gen, dev, torch.bfloat16, 1, 8, 8, 2, 2,
                               bad_dqk, bad_dv)
        pos = torch.arange(8, dtype=torch.int32, device=dev)
        try:
            fa_ops.flash_attention(q, k, v, q_positions=pos, k_positions=pos)
            refused = False
        except ValueError:
            refused = True
        rows.append({"kernel": "flash_attention",
                     "case": f"refuses_dqk{bad_dqk}_dv{bad_dv}",
                     "dtype": "bfloat16", "refused": refused,
                     "ok": refused})
    ssd_cases = [
        # name, B, S, nh, hd, ns, plain chunk (the JAX test's CASES first)
        ("jax_case0", 2, 128, 4, 16, 32, 32),
        ("jax_case1", 1, 256, 2, 64, 128, 64),
        ("jax_case2", 2, 64, 8, 32, 16, 64),
        ("jax_case3_odd_nh", 1, 96, 3, 8, 8, 32),
        ("main_17", 1, 17, 32, 64, 128, 256),
        ("main_131", 1, 131, 32, 64, 128, 256),
        ("main_200", 1, 200, 32, 64, 128, 256),
        ("main_512", 1, 512, 32, 64, 128, 256),
    ]
    # the tensor-core body's 64-row chunks: one row, the chunk's edges, a
    # long prompt, a batch of 4 with an odd head count at ns 8 (K padded to
    # 16) and at hd 8, and inputs that are not 16-byte aligned
    ssd_cases += [(f"chunk_{S}", 1, S, 32, 64, 128, 256)
                  for S in (1, 63, 64, 65, 129, 2048)]
    ssd_cases += [("b4_nh5_ns8", 4, 131, 5, 64, 8, 256),
                  ("b4_nh3_hd8_ns8", 4, 77, 3, 8, 8, 256),
                  ("unaligned_131", 1, 131, 32, 64, 128, 256)]
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for name, B, S, nh, hd, ns, chunk in ssd_cases:
            for seeded in (False, True):
                args = ssd_inputs(gen, dev, dtype, B, S, nh, hd, ns)
                if name.startswith("unaligned"):
                    # x, B and C one element past an aligned address
                    args = [misaligned(t) if t.dtype == dtype and t.dim() > 1
                            else t for t in args]
                h0 = (torch.randn((B, nh, hd, ns), generator=gen,
                                  device=dev) if seeded else None)
                y, st = ssd_ops.ssd_scan(*args, init_state=h0)
                torch.cuda.synchronize()
                ye, ste = ssd_ref.reference(*args, chunk=chunk,
                                            init_state=h0)
                err = max((y - ye).abs().max().item(),
                          (st - ste).abs().max().item())
                tol = TOL[("ssd", dname)]
                rows.append({"kernel": "ssd_scan", "case": name,
                             "dtype": dname, "init_state": seeded,
                             "max_abs_err": err, "tol": tol,
                             "ok": err < tol})
                if dname == "float32" and name.startswith("main"):
                    main_err["ssd_scan"] = max(main_err["ssd_scan"], err)
        # chunked and bucketed prefill at mamba2's widths: 16-row chunks
        # and a final 7-row slice from a carried state, a final chunk whose
        # rows past the 7th are padding (dt = 0), and a 256-row bucket
        # holding a 131-row prompt
        for name, S, valid, seeded in (("chunk16", 16, 16, True),
                                       ("slice7", 7, 7, True),
                                       ("chunk16_valid7", 16, 7, True),
                                       ("bucket256_valid131", 256, 131,
                                        False)):
            xs, dt, A, Bm, Cm, D = ssd_inputs(gen, dev, dtype, 1, S, 32, 64,
                                              128)
            dt[:, valid:] = 0.0
            h0 = (torch.randn((1, 32, 64, 128), generator=gen, device=dev)
                  if seeded else None)
            y, st = ssd_ops.ssd_scan(xs, dt, A, Bm, Cm, D, init_state=h0)
            torch.cuda.synchronize()
            ye, ste = ssd_ref.reference(xs, dt, A, Bm, Cm, D, chunk=256,
                                        init_state=h0)
            err = max((y - ye).abs().max().item(),
                      (st - ste).abs().max().item())
            tol = TOL[("ssd", dname)]
            rows.append({"kernel": "ssd_scan", "case": name, "dtype": dname,
                         "init_state": seeded, "valid_rows": valid,
                         "max_abs_err": err, "tol": tol, "ok": err < tol})
    rglru_cases = [
        # name, B, S, W, n_chunks (the JAX test's CASES first)
        ("jax_case0", 2, 64, 128, None), ("jax_case1", 1, 128, 256, None),
        ("jax_case2", 2, 96, 64, None), ("jax_case3", 1, 32, 512, None),
        ("main_17", 1, 17, 2560, None), ("main_131", 1, 131, 2560, None),
        ("main_200", 1, 200, 2560, None),
    ]
    # the split over the sequence: one row; the edges of the wrapper's
    # super-chunks at B 1, W 2560 (16 chunks of 8 rows at S 128, 32 of 16
    # at S 512); long prompts; a width that is not a multiple of the 16-channel
    # block; a batch of 4; forced chunk counts of 1, 3 and 16
    rglru_cases += [(f"seq_{S}", 1, S, 2560, None)
                    for S in (1, 128, 129, 512, 513, 2048, 4096)]
    rglru_cases += [("w2500_131", 1, 131, 2500, None),
                    ("w2500_2048", 1, 2048, 2500, None),
                    ("b4_131", 4, 131, 2560, None)]
    rglru_cases += [(f"k{k}_{S}", 1, S, 2500, k)
                    for k in (1, 3, 16) for S in (131, 2048)]
    main_err["rglru_scan"] = 0.0
    for name, B, S, W, n_chunks in rglru_cases:
        for seeded in (False, True):
            a, bx = rglru_inputs(gen, dev, B, S, W)
            h0 = (torch.randn((B, W), generator=gen, device=dev)
                  if seeded else None)
            hs, hf = rglru_ops.rglru_scan(a, bx, h0, n_chunks=n_chunks)
            torch.cuda.synchronize()
            he, hfe = rglru_ref.reference(a, bx, h0)
            err = max((hs - he).abs().max().item(),
                      (hf - hfe).abs().max().item())
            tol = TOL[("rglru", "float32")]
            rows.append({"kernel": "rglru_scan", "case": name,
                         "dtype": "float32", "init_state": seeded,
                         "n_chunks": n_chunks, "max_abs_err": err,
                         "tol": tol, "ok": err < tol,
                         "chunked_bitwise": rglru_bitwise(a, bx, h0, hs, hf,
                                                          n_chunks)})
            if name.startswith("main"):
                main_err["rglru_scan"] = max(main_err["rglru_scan"], err)
    # chunked and bucketed prefill at recurrentgemma's width: a 16-row
    # chunk from a carried state, a final chunk whose rows past the 7th
    # are the scan's identity (a = 1, bx = 0), and a 256-row bucket holding
    # a 131-row prompt
    for name, S, valid, seeded in (("chunk16", 16, 16, True),
                                   ("chunk16_valid7", 16, 7, True),
                                   ("bucket256_valid131", 256, 131, False)):
        a, bx = rglru_inputs(gen, dev, 1, S, 2560)
        a[:, valid:] = 1.0
        bx[:, valid:] = 0.0
        h0 = torch.randn((1, 2560), generator=gen, device=dev) \
            if seeded else None
        hs, hf = rglru_ops.rglru_scan(a, bx, h0)
        torch.cuda.synchronize()
        he, hfe = rglru_ref.reference(a, bx, h0)
        err = max((hs - he).abs().max().item(),
                  (hf - hfe).abs().max().item())
        tol = TOL[("rglru", "float32")]
        rows.append({"kernel": "rglru_scan", "case": name,
                     "dtype": "float32", "init_state": seeded,
                     "valid_rows": valid, "max_abs_err": err, "tol": tol,
                     "ok": err < tol,
                     "chunked_bitwise": rglru_bitwise(a, bx, h0, hs, hf,
                                                      None)})
    # the JAX test's near-one decay: long memory must stay finite; also over
    # 2048 rows, where the chunks' incoming states carry it
    for S in (128, 2048):
        a = torch.full((1, S, 64), 0.9999, device=dev)
        bx = torch.full((1, S, 64), 1e-3, device=dev)
        hs, hf = rglru_ops.rglru_scan(a, bx)
        torch.cuda.synchronize()
        he, _ = rglru_ref.reference(a, bx)
        err = (hs - he).abs().max().item()
        tol = TOL[("rglru", "near_one")]
        finite = bool(torch.isfinite(hs).all() and torch.isfinite(hf).all())
        rows.append({"kernel": "rglru_scan",
                     "case": "near_one_decay" + ("" if S == 128 else f"_{S}"),
                     "dtype": "float32", "init_state": False,
                     "finite": finite, "max_abs_err": err, "tol": tol,
                     "ok": finite and err < tol})
    emit("kernels", cases=rows)
    bad = [r for r in rows if not r["ok"]]
    check(not bad, f"kernels disagree with their plain versions: {bad}")
    return main_err


# -- serving ------------------------------------------------------------------

def cross_layers(cfg) -> int:
    """Decoder layers with cross attention (every one of an enc-dec)."""
    return cfg.n_layers if cfg.n_enc_layers else 0


def frontend_embs(cfg, dev, n: int) -> list:
    """Request i's stub frontend embeddings [frontend_tokens,
    frontend_dim], standard normal from seed FRONTEND_SEED + i, for a
    modality-frontend or enc-dec arch; Nones otherwise.  The same for
    every engine and oracle that serves request i."""
    import torch
    if not (cfg.frontend or cfg.n_enc_layers):
        return [None] * n
    return [torch.randn((cfg.frontend_tokens, cfg.frontend_dim),
                        generator=torch.Generator(device=dev).manual_seed(
                            FRONTEND_SEED + i), device=dev)
            for i in range(n)]


def make_prompts(cfg, dev, seed: int) -> list:
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randint(0, cfg.vocab_size, (n,), generator=gen,
                          device=dev).tolist() for n in PROMPT_LENS]


def serve_trace(cfg, params, prompts, dev, dtype, max_new=MAX_NEW,
                mode=PAGED, plan=None, sampled: bool = False,
                impl: str = "kernel"):
    """Serve ``prompts`` through the engine in ``mode`` (the engine's
    options; the paged mode by default), sized by ``plan`` when given
    (then neither ``kv_len`` nor ``n_slots`` is passed), else at KV_LEN x
    N_SLOTS, request i sampling with SAMPLED and seed SAMPLE_SEED + i when
    ``sampled``.  Returns (engine, results); ``engine.ring_blocks_freed``
    counts the window-ring blocks that fell behind the window during the
    run, and ``engine.verify_passes`` the speculative verify passes (the
    engine keeps no counter of either)."""
    from repro_torch.serve import ContinuousEngine, SamplingParams
    # a modality frontend's rows share the lanes: kv_len + those rows
    # must fill whole blocks (a reduced phi-3's 8 rows: 504 + 8)
    sizing = ({"plan": plan} if plan is not None
              else {"kv_len": KV_LEN - cfg.prepended_rows % BLOCK,
                    "n_slots": N_SLOTS})
    eng = ContinuousEngine(cfg, params, block_size=BLOCK, impl=impl,
                           dtype=dtype, device=dev, **sizing, **mode)
    eng.ring_blocks_freed = 0
    eng.verify_passes = 0
    slide = eng.allocator.extend_window

    def counted_slide(slot, n_tokens_total, **kw):
        fresh, freed = slide(slot, n_tokens_total, **kw)
        eng.ring_blocks_freed += len(freed)
        return fresh, freed

    eng.allocator.extend_window = counted_slide
    fes = frontend_embs(cfg, dev, len(prompts))
    verify = getattr(eng, "_verify_step", None)
    if verify is not None:
        def counted_verify(*args):
            eng.verify_passes += 1
            return verify(*args)

        eng._verify_step = counted_verify
    for i, p in enumerate(prompts):
        sp = (SamplingParams(**SAMPLED, seed=SAMPLE_SEED + i) if sampled
              else None)
        eng.submit(p, max_new, rid=i, arrival=i * STAGGER,
                   frontend_emb=fes[i], sampling=sp)
    try:
        return eng, eng.run()
    finally:
        # the wrappers close over the engine: drop them, so that no
        # reference cycle keeps the engine's weights on the card until the
        # garbage collector runs (they would count in the next path's peak
        # memory)
        del eng.allocator.extend_window
        if verify is not None:
            eng._verify_step = verify


def plain_tokens(cfg, params, prompts, dev, dtype, max_new=MAX_NEW,
                 kv_len=KV_LEN) -> list:
    """Each request's tokens from the plain B=1 engine."""
    import torch
    from repro_torch.serve import Engine
    plain = Engine(cfg, params, kv_len=kv_len, dtype=dtype, impl="plain",
                   device=dev)
    fes = frontend_embs(cfg, dev, len(prompts))
    return [plain.generate(torch.tensor([p], device=dev), max_new,
                           frontend_emb=None if fe is None else fe[None]
                           )[0].tolist() for p, fe in zip(prompts, fes)]


def router_gap(cfg, params, seq, fe=None) -> float:
    """The plain path's least gap, over the MoE layers, between the k-th and
    the (k+1)-th router probability of the last row of ``seq`` (f32,
    lossless, as the engines dispatch): how near that row's expert choice
    was to a tie.  A diverging MoE request prints it beside its margin."""
    from repro_torch.models import blocks, lm
    k = cfg.experts_per_token
    gaps = []
    route = blocks.moe_route

    def recording(cfg_, p, flat, **kw):
        out = route(cfg_, p, flat, **kw)
        top = out[0].reshape(-1, out[0].shape[-1])[-1].topk(k + 1).values
        gaps.append((top[k - 1] - top[k]).item())
        return out

    blocks.moe_route = recording
    try:
        lm.forward(cfg, params, seq, frontend_emb=fe, mode="prefill",
                   impl="plain", moe_lossless=True)
    finally:
        blocks.moe_route = route
    return min(gaps)


def hold_against_plain(cfg, params, prompts, results, refs, dev,
                       max_new=MAX_NEW) -> list:
    """Per request: the kernel engine's tokens against the plain B=1
    engine's (``refs``).  Identical, or at the first divergence the plain
    path's top-two logit margin must be under MARGIN (a near tie that
    rounding may flip either way); an MoE model's row also gives the
    plain path's least router gap there (``router_gap``)."""
    import torch
    from repro_torch.models import lm
    rows = []
    fes = frontend_embs(cfg, dev, len(prompts))
    for rid, (p, ref) in enumerate(zip(prompts, refs)):
        got = results[rid]
        fe = None if fes[rid] is None else fes[rid][None]
        check(len(got) == max_new, f"request {rid}: {len(got)} tokens")
        div = next((i for i, (a, b) in enumerate(zip(got, ref)) if a != b),
                   None)
        row = {"rid": rid, "prompt_len": len(p), "identical": div is None,
               "divergence_index": div, "margin": None}
        if div is not None:
            seq = torch.tensor([p + ref[:div]], device=dev)
            logits, _, _ = lm.forward(cfg, params, seq, frontend_emb=fe,
                                      mode="prefill", impl="plain",
                                      moe_lossless=True)
            top2 = logits[0, -1, :cfg.vocab_size].float().topk(2).values
            row["margin"] = (top2[0] - top2[1]).item()
            row["ok"] = row["margin"] < MARGIN
            if cfg.n_experts:
                row["router_gap"] = router_gap(cfg, params, seq, fe)
        else:
            row["ok"] = True
        rows.append(row)
    return rows


def launch_counters() -> dict:
    """The kernel wrappers, by kernel name; each counts its launches."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.rglru_scan import ops as rglru_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    return {"paged_attention": pa_ops.paged_attention,
            "flash_attention": fa_ops.flash_attention,
            "ssd_scan": ssd_ops.ssd_scan,
            "rglru_scan": rglru_ops.rglru_scan}


def compile_serve_plan(cfg, cache):
    """The plan of the served decode shape (KV_LEN x N_SLOTS) on
    PLAN_DEVICES modelled H100 SXM cards, through the plan cache ``cache``;
    returns (plan, host seconds)."""
    from repro_torch.core import H100_SXM, Topology, compile_plan
    from repro_torch.serve import ContinuousEngine
    t0 = time.perf_counter()
    plan = compile_plan(cfg, ContinuousEngine.decode_shape_for(KV_LEN,
                                                               N_SLOTS),
                        Topology.homogeneous(PLAN_DEVICES, H100_SXM),
                        cache=cache)
    return plan, time.perf_counter() - t0


def expected_paged_launches(cfg, prefills: int, decode_steps: int) -> dict:
    """Each kernel's launches in a paged run of whole prefills: per
    prefill, flash for every attention, MLA and cross-attention layer
    (an enc-dec's cross attention over the encoder's frames) and a scan
    per recurrent layer; per batched decode step, paged for every
    attention layer and flash for every cross-attention layer (all lanes'
    one query row over their gathered cross block sets, one launch)."""
    mixers = [s.mixer for s in cfg.layers()]
    n_attn, n_mla = attention_layers(cfg)
    n_x = cross_layers(cfg)
    return {"paged_attention": n_attn * decode_steps,
            "flash_attention": (n_attn + n_mla + n_x) * prefills
            + n_x * decode_steps,
            "ssd_scan": mixers.count("ssd") * prefills,
            "rglru_scan": mixers.count("rglru") * prefills}


def cut_config(arch: str, layers=None):
    """``arch``'s config at full width, cut to ``layers`` layers when given
    (a cut's line names it: ``layers`` of ``of_layers``)."""
    from repro_torch import configs
    cfg = configs.get(arch)
    return cfg.replace(n_layers=layers) if layers else cfg


def param_counts(arch: str, cfg, params) -> dict:
    """The init tree's parameter count beside the reference config's
    ``param_count()`` (of the same cut), where the script knows it."""
    from repro_torch import configs
    n = sum(t.numel() for t in _leaves(params))
    full = configs.get(arch).n_layers
    key = arch if cfg.n_layers == full else (arch, cfg.n_layers)
    out = {"params": n, "layers": cfg.n_layers, "of_layers": full}
    if key in REFERENCE_PARAM_COUNT:
        out["reference_param_count"] = REFERENCE_PARAM_COUNT[key]
    return out


def phase_serve(dev, arch: str, cache, label: str = "serve") -> dict:
    """One main path: the reduced model first, then ``arch`` at full width
    (at ``DEPTH[arch]`` layers where the path is cut in depth), its engine
    sized by the plan of its decode shape (compiled through the plan cache
    ``cache``), with every launch counter zeroed just before the run and
    read just after it.  ``label`` names the phase in the output."""
    import torch
    from repro_torch import configs
    from repro_torch.models import lm

    small = configs.get(arch).reduced()
    sgen = torch.Generator(device=dev).manual_seed(7)
    sparams = lm.init_params(small, sgen, dev, torch.float32)
    sprompts = make_prompts(small, dev, seed=8)[:4]
    seng, sres = serve_trace(small, sparams, sprompts, dev, torch.float32,
                             12)
    srefs = plain_tokens(small, sparams, sprompts, dev, torch.float32, 12)
    srows = hold_against_plain(small, sparams, sprompts, sres, srefs, dev,
                               12)
    emit(f"{label}_reduced", arch=small.name, requests=srows,
         window=small.window_size, ring_blocks_freed=seng.ring_blocks_freed)
    check(all(r["ok"] for r in srows), f"reduced model diverged: {srows}")
    if small.window_size:
        check(seng.ring_blocks_freed > 0, "no window ring freed a block")
    check_clean(seng)

    cfg = cut_config(arch, DEPTH.get(arch))
    gen = torch.Generator(device=dev).manual_seed(0)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = lm.init_params(cfg, gen, dev, torch.float32)
    torch.cuda.synchronize()
    counts = param_counts(arch, cfg, params)
    init_s = time.perf_counter() - t0
    prompts = make_prompts(cfg, dev, seed=1)
    plan, compile_s = compile_serve_plan(cfg, cache)
    check(not plan.from_cache, "the first compile of the plan was a hit")

    counters = launch_counters()
    for fn in counters.values():
        fn.launches = 0
    eng, results = serve_trace(cfg, params, prompts, dev, torch.float32,
                               plan=plan)
    launches = {name: fn.launches for name, fn in counters.items()}
    check((eng.kv_len, eng.n_slots) == (KV_LEN, N_SLOTS),
          f"the plan sized the engine to {eng.kv_len} x {eng.n_slots}")

    peak = torch.cuda.max_memory_allocated(dev)
    tel = eng.telemetry
    decode_steps = sum(1 for s in tel.steps if s.active_slots)
    prefills = sum(s.prefills for s in tel.steps)
    expect = expected_paged_launches(cfg, prefills, decode_steps)
    refs = plain_tokens(cfg, params, prompts, dev, torch.float32)
    rows = hold_against_plain(cfg, params, prompts, results, refs, dev)
    emit(label, arch=cfg.name, dtype="float32", **counts,
         peak_memory_bytes=peak,
         init_seconds=init_s, plan_key=plan.key,
         sized_by_plan={"kv_len": eng.kv_len, "n_slots": eng.n_slots},
         requests=rows, prefills=prefills,
         decode_steps=decode_steps, launches=launches,
         expected_launches=expect,
         peak_resident_bytes_by_group=tel.peak_resident_bytes_by_group(),
         ring_blocks_freed=eng.ring_blocks_freed,
         state_slots_in_use=eng.allocator.state_slots_in_use())
    check(prefills == len(prompts), f"{prefills} prefills")
    check(launches == expect, f"launches {launches} != expected {expect}")
    check(all(r["ok"] for r in rows), f"tokens diverged: {rows}")
    check_clean(eng)
    return {"params": params, "prompts": prompts, "launches": launches,
            "cfg": cfg, "refs": refs, "small": (small, sparams, sprompts,
                                                srefs),
            "plan": plan, "compile_seconds": compile_s,
            "telemetry": tel}


def phase_adapt(served: dict, cache) -> dict:
    """The §3 loop over the path's plan: ``adapt_plan`` under the run's
    ``device_interference`` and ``assistant_callback``.  Every delta must
    validate through ``CompiledPlan.apply``, the adapted assignment must
    equal the trace's replay, a second compile must be a cache hit with the
    same key and an equal artifact, and the adapted plan's cost summaries
    must re-verify.  The step times and cut are the cost model's, from the
    H100 SXM datasheet figures: modelled, not measured."""
    from repro_torch.core import CompiledPlan, adapt_plan
    plan, tel = served["plan"], served.pop("telemetry")
    t0 = time.perf_counter()
    interference = tel.device_interference(plan.k)
    adapted, trace = adapt_plan(
        plan, interference=interference,
        telemetry=tel.assistant_callback(plan.graph, plan.cost_model))
    adapt_s = time.perf_counter() - t0
    replayed = plan
    for delta in trace.deltas:
        replayed = replayed.apply(delta, check_convex=False)
    check(replayed.assignment == adapted.assignment,
          "the deltas replayed through CompiledPlan.apply disagree")
    check(adapted.assignment == trace.replay(plan.assignment),
          "the adapted plan is not the trace's replay")
    again, hit_s = compile_serve_plan(plan.cfg, cache)
    check(again.from_cache, "the second compile was not a cache hit")
    check(again.key == plan.key and again.to_json() == plan.to_json(),
          "the cached plan differs from the compiled one")
    reloaded = CompiledPlan.from_json(adapted.to_json(), verify=True)
    check(reloaded.assignment == adapted.assignment,
          "the adapted plan did not reload")
    row = {"arch": plan.cfg.name, "plan": plan.describe(),
           "topology": plan.topology.describe(),
           "compile_seconds_host": served["compile_seconds"],
           "cache_hit_seconds_host": hit_s,
           "adapt_seconds_host": adapt_s, "deltas": len(trace.deltas),
           "cycles": len(trace.migrations),
           "interference": interference,
           "modeled (H100_SXM datasheet figures)": {
               "step_time_ms_before": trace.step_times[0] * 1e3,
               "step_time_ms_after": trace.step_times[-1] * 1e3,
               "adapted_cut_bytes": adapted.cut_bytes}}
    emit("adapt", **row)
    return row


def expected_mode_launches(cfg, mode: dict, tel) -> dict:
    """Each kernel's launches in one run of ``mode``, from the trace as the
    telemetry saw it.  Chunked prefill: one SSD or RG-LRU launch per
    recurrent layer and chunk, no flash launch for self-attention (the
    chunk's attention is the plain gather), paged launches from the
    decode steps only.  Dense lanes: flash per attention layer and prefill
    or lane decode step, no paged launch, one scan launch per recurrent
    layer and prefill.  MLA layers launch flash per whole prefill only.
    An enc-dec's cross attention launches flash per layer and chunk,
    prefill, batched decode step or lane decode step."""
    mixers = [s.mixer for s in cfg.layers()]
    n_attn, n_mla = attention_layers(cfg)
    n_x = cross_layers(cfg)
    chunks = sum(s.prefill_chunks for s in tel.steps)
    prefills = sum(s.prefills for s in tel.steps)
    decode_steps = sum(1 for s in tel.steps if s.active_slots)
    lane_steps = sum(len(s.active_slots) for s in tel.steps)
    if mode.get("prefill_chunk"):
        return {"paged_attention": n_attn * decode_steps,
                "flash_attention": n_x * (chunks + decode_steps),
                "ssd_scan": mixers.count("ssd") * chunks,
                "rglru_scan": mixers.count("rglru") * chunks}
    return {"paged_attention": 0,
            "flash_attention": (n_attn + n_x) * (prefills + lane_steps)
            + n_mla * prefills,
            "ssd_scan": mixers.count("ssd") * prefills,
            "rglru_scan": mixers.count("rglru") * prefills}


def phase_serve_modes(dev, served: dict) -> dict:
    """The path's trace in the engine's other modes, in f32: chunked
    prefill of 16-row chunks over bucketed paged lanes (the README's
    serving example) and bucketed dense lanes, each on the reduced model
    first and then at full width with every launch counter zeroed just
    before the run and read just after; each request against the plain
    B=1 engine's tokens of phase ``serve`` under the same margin rule, the
    launch counts against ``expected_mode_launches``.  Returns {mode:
    launches}."""
    import torch
    cfg, params, prompts = served["cfg"], served["params"], served["prompts"]
    # popped: the reduced model's weights must not count in the peak
    # memory of phase timing
    small, sparams, sprompts, srefs = served.pop("small")
    counters = launch_counters()
    out = {}
    for name, mode in SERVE_MODES.items():
        seng, sres = serve_trace(small, sparams, sprompts, dev,
                                 torch.float32, 12, mode)
        srows = hold_against_plain(small, sparams, sprompts, sres, srefs,
                                   dev, 12)
        check(all(r["ok"] for r in srows),
              f"reduced model diverged in {name}: {srows}")
        check_clean(seng)

        for fn in counters.values():
            fn.launches = 0
        eng, results = serve_trace(cfg, params, prompts, dev, torch.float32,
                                   mode=mode)
        launches = {k: fn.launches for k, fn in counters.items()}
        tel = eng.telemetry
        expect = expected_mode_launches(cfg, mode, tel)
        chunks = sum(s.prefill_chunks for s in tel.steps)
        lane_steps = sum(len(s.active_slots) for s in tel.steps)
        rows = hold_against_plain(cfg, params, prompts, results,
                                  served["refs"], dev)
        emit("serve_modes", arch=cfg.name, mode=name, options=mode,
             dtype="float32", reduced_requests=srows, requests=rows,
             prefills=sum(s.prefills for s in tel.steps),
             prefill_chunks=chunks, lane_decode_steps=lane_steps,
             launches=launches, expected_launches=expect,
             ring_blocks_freed=eng.ring_blocks_freed,
             reduced_ring_blocks_freed=seng.ring_blocks_freed)
        if mode.get("prefill_chunk"):
            C = mode["prefill_chunk"]
            F = cfg.prepended_rows       # a VLM's rows ride the chunks
            check(chunks == sum(-(-(F + len(p)) // C) for p in prompts),
                  f"{chunks} chunks")
        else:
            check(lane_steps == len(prompts) * (MAX_NEW - 1),
                  f"{lane_steps} lane decode steps")
        check(launches == expect,
              f"{name}: launches {launches} != expected {expect}")
        check(all(r["ok"] for r in rows), f"{name}: tokens diverged: {rows}")
        check_clean(eng)
        out[name] = launches
    return out


def draft_attention_layers(cfg, draft_layers: int) -> int:
    """Attention layers among those a ``layer_cap=draft_layers`` pass runs
    (whole cycle repeats within a segment, as ``lm.forward`` rounds)."""
    n, remaining = 0, draft_layers
    for seg in cfg.segments():
        run = (min(seg.repeats, -(-remaining // len(seg.cycle)))
               if remaining > 0 else 0)
        remaining -= run * len(seg.cycle)
        n += run * sum(1 for spec in seg.cycle
                       if spec.mixer in ("global", "local"))
    return n


def expected_spec_launches(cfg, eng) -> dict:
    """Each kernel's launches in one run, from the trace: paged attention
    once per attention layer below the draft cap and drafted token, and
    per attention layer and batched decode step; flash per attention
    layer and whole prefill; each scan per recurrent layer and prefill or
    verify pass (the draft's recurrent layers take the one-row step, and
    a verify pass reads the paged tables through the plain gather)."""
    tel = eng.telemetry
    mixers = [s.mixer for s in cfg.layers()]
    n_attn = sum(1 for m in mixers if m in ("global", "local"))
    prefills = sum(s.prefills for s in tel.steps)
    batched = 0 if eng.speculate else \
        sum(1 for s in tel.steps if s.active_slots)
    drafted, passes = tel.total_drafted(), eng.verify_passes
    return {"paged_attention": n_attn * batched + drafted *
            draft_attention_layers(cfg, eng.draft_layers),
            "flash_attention": n_attn * prefills,
            "ssd_scan": mixers.count("ssd") * (prefills + passes),
            "rglru_scan": mixers.count("rglru") * (prefills + passes)}


def sampled_margin(cfg, params, prompt, ref, div, seed, dev) -> float:
    """The plain path's top-two gap of the tempered, filtered logits plus
    the request's Gumbel noise for the token at index ``div`` of ``ref``
    (decided at cache position len(prompt) + div): the margin a rounding
    difference would have to cross to flip that sampled token."""
    import torch
    from repro_torch.models import lm
    from repro_torch.serve import sampling
    seq = torch.tensor([prompt + ref[:div]], device=dev)
    logits, _, _ = lm.forward(cfg, params, seq, mode="prefill", impl="plain",
                              moe_lossless=True)
    row = logits[0, -1, :cfg.vocab_size].float() / SAMPLED["temperature"]
    key = sampling.token_key(sampling.prng_key(seed, dev), len(prompt) + div)
    z = sampling.filter_logits(row, SAMPLED["top_k"], SAMPLED["top_p"]) + \
        sampling.gumbel(key, cfg.vocab_size)
    top2 = z.topk(2).values
    return (top2[0] - top2[1]).item()


def hold_sampled(cfg, params, prompts, got, ref, dev, margin_rule: bool,
                 max_new: int = MAX_NEW) -> list:
    """Per request: the kernel path's sampled tokens against the plain
    path's (``ref``).  Identical, or (``margin_rule``) at the first
    divergence the plain path's sampled margin under MARGIN."""
    rows = []
    for rid, p in enumerate(prompts):
        a, b = got[rid], ref[rid]
        check(len(a) == len(b) == max_new, f"request {rid}: {len(a)} tokens")
        div = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                   None)
        row = {"rid": rid, "identical": div is None,
               "divergence_index": div, "margin": None, "ok": True}
        if div is not None:
            row["margin"] = sampled_margin(cfg, params, p, b, div,
                                           SAMPLE_SEED + rid, dev)
            row["ok"] = margin_rule and row["margin"] < MARGIN
        rows.append(row)
    return rows


def phase_sample_spec(dev, served: dict) -> dict:
    """The path's trace under the decode policies, in f32 at full width,
    every kernel-path run with the launch counters zeroed just before it
    and read just after: (a) greedy speculation (``speculate=4``, paged)
    against the plain B=1 engine's tokens of phase ``serve`` under the
    margin rule, with drafts made and ``rewound == drafted - accepted``;
    (b) sampled paged decoding (SAMPLED, one seed per request) against the
    same engine with ``impl="plain"``, identical or under the sampled
    margin rule; (c) (b) with ``speculate=4``, identical; (d) lazy pricing
    over LAZY_BLOCKS blocks (at least one preemption; ``total_preemptions
    == scheduler.preemptions``, no leak) against phase ``serve``'s plain
    tokens.  (a) and (c) serve the first SPEC_PROMPTS prompts for SPEC_NEW
    tokens.  Launch counts equal ``expected_spec_launches``.  Returns
    {run: launches} of the kernel-path runs."""
    import torch
    cfg, params = served["cfg"], served["params"]
    counters = launch_counters()
    has_blocks = any(s.mixer in ("global", "local") for s in cfg.layers())
    spec = {**PAGED, "speculate": SPECULATE}
    # run -> (engine options, sampled?, prompts, new tokens)
    short = served["prompts"][:SPEC_PROMPTS]
    runs = {"greedy_spec": (spec, False, short, SPEC_NEW),
            "sampled": (PAGED, True, served["prompts"], MAX_NEW),
            "sampled_spec": (spec, True, short, SPEC_NEW)}
    if has_blocks:
        runs["lazy"] = ({**PAGED, "pricing": "lazy",
                         "cache_blocks": LAZY_BLOCKS}, False,
                        served["prompts"], MAX_NEW)
    t0 = time.perf_counter()
    out = {}
    for name, (mode, sampled, prompts, max_new) in runs.items():
        for fn in counters.values():
            fn.launches = 0
        eng, results = serve_trace(cfg, params, prompts, dev, torch.float32,
                                   max_new, mode, sampled=sampled)
        launches = {k: fn.launches for k, fn in counters.items()}
        expect = expected_spec_launches(cfg, eng)
        tel = eng.telemetry
        accepted = sum(s.accepted for s in tel.steps)
        if sampled:
            for fn in counters.values():
                fn.launches = 0
            plain_eng, plain = serve_trace(cfg, params, prompts, dev,
                                           torch.float32, max_new, mode,
                                           sampled=True, impl="plain")
            check(all(fn.launches == 0 for fn in counters.values()),
                  f"{name}: the plain path launched a kernel")
            check_clean(plain_eng)
            rows = hold_sampled(cfg, params, prompts, results, plain, dev,
                                not eng.speculate, max_new)
        else:
            rows = hold_against_plain(cfg, params, prompts, results,
                                      served["refs"], dev, max_new)
        emit("sample_spec", arch=cfg.name, run=name, options=mode,
             sampling=SAMPLED if sampled else None, dtype="float32",
             prompts=len(prompts), max_new=max_new,
             requests=rows, launches=launches, expected_launches=expect,
             verify_passes=eng.verify_passes, drafted=tel.total_drafted(),
             accepted=accepted, accept_rate=tel.accept_rate(),
             rewound=tel.total_rewound_tokens(),
             preemptions=tel.total_preemptions(),
             scheduler_preemptions=eng.scheduler.preemptions,
             n_blocks=eng.allocator.n_blocks)
        check(launches == expect,
              f"{name}: launches {launches} != expected {expect}")
        check(all(r["ok"] for r in rows), f"{name}: tokens diverged: {rows}")
        if eng.speculate:
            check(tel.total_drafted() > 0, f"{name}: nothing drafted")
            check(tel.total_rewound_tokens() ==
                  tel.total_drafted() - accepted,
                  f"{name}: rewound != drafted - accepted")
        if name == "lazy":
            check(tel.total_preemptions() == eng.scheduler.preemptions >= 1,
                  f"lazy: {eng.scheduler.preemptions} preemptions")
        check_clean(eng)
        eng.allocator.check_no_leaks()
        out[name] = launches
    if not has_blocks:
        emit("sample_spec", arch=cfg.name, run="lazy", skipped=True,
             reason="the model holds no blocks (recurrent state slots "
                    "only), so there is no pool to oversubscribe")
    emit("sample_spec", arch=cfg.name, seconds=time.perf_counter() - t0)
    return out


def prefix_trace(prompts) -> tuple:
    """Phase prefix_router's trace: (prompts, arrivals)."""
    aligned = next(p for p in prompts if len(p) == 131)[:PREFIX_ALIGNED]
    trace = list(prompts) * 2 + [aligned, aligned]
    arrivals = [i * STAGGER for i in range(len(trace) - 1)] + [ALIGNED_LATE]
    return trace, arrivals


def serve_requests(target, prompts, arrivals, max_new=MAX_NEW) -> dict:
    """Submit request i (``prompts[i]`` at ``arrivals[i]``) to an engine or
    a router and serve them all."""
    for i, (p, t) in enumerate(zip(prompts, arrivals)):
        target.submit(p, max_new, rid=i, arrival=t)
    return target.run()


def replica_engines(target) -> list:
    """The engines of a router's replicas, or the one engine."""
    return ([r.engine for r in target.replicas]
            if hasattr(target, "replicas") else [target])


def fleet_counts(engines) -> dict:
    """Prefills, chunks and batched decode steps summed over the engines'
    telemetry (the launch counters are module globals, so a fleet's
    formulas sum the replicas' steps)."""
    steps = [s for e in engines for s in e.telemetry.steps]
    return {"prefills": sum(s.prefills for s in steps),
            "chunks": sum(s.prefill_chunks for s in steps),
            "decode_steps": sum(1 for s in steps if s.active_slots)}


def expected_fleet_launches(cfg, counts: dict, chunked: bool) -> dict:
    """Each kernel's launches over a run of one or more paged engines:
    paged attention per attention layer and batched decode step; whole
    prefill: flash per attention layer and prefill, each scan per
    recurrent layer and prefill; chunked prefill: no flash (a chunk's
    attention is the plain gather), each scan per recurrent layer and
    chunk.  MLA layers count as attention layers for flash only."""
    mixers = [s.mixer for s in cfg.layers()]
    n_attn, n_mla = attention_layers(cfg)
    units = counts["chunks"] if chunked else counts["prefills"]
    return {"paged_attention": n_attn * counts["decode_steps"],
            "flash_attention": (0 if chunked else
                                (n_attn + n_mla) * counts["prefills"]),
            "ssd_scan": mixers.count("ssd") * units,
            "rglru_scan": mixers.count("rglru") * units}


def check_drained(engines) -> None:
    """After a run: every allocator passes ``check()``, and after
    ``drop_cached()`` ``check_no_leaks()`` with no resident byte."""
    for eng in engines:
        eng.allocator.check()
        eng.allocator.drop_cached()
        eng.allocator.check_no_leaks()
        check(eng.allocator.resident_bytes() == 0,
              "resident bytes left after drop_cached")


def fleet_row(target, engines) -> dict:
    """The prefix-cache and fleet figures of one run."""
    stats = [e.allocator.prefix_stats() for e in engines]
    tels = [e.telemetry for e in engines]
    hit = sum(st["hit_tokens"] for st in stats)
    looked = sum(st["lookup_tokens"] for st in stats)
    row = {"hit_tokens": hit, "lookup_tokens": looked,
           "hit_rate": hit / looked if looked else 0.0,
           "cow_forks": sum(st["cow_forks"] for st in stats),
           "commits": sum(st["commits"] for st in stats),
           "evictions": sum(st["evictions"] for st in stats),
           "peak_shared_saved_bytes": max(t.peak_shared_saved_bytes()
                                          for t in tels),
           "decode_starvation": sum(t.decode_starvation() for t in tels)}
    if hasattr(target, "replicas"):
        row.update(roles=[r.role for r in target.replicas],
                   placement=target.routed_per_replica,
                   router_stats=dict(target.stats),
                   transfer=dict(target.transfer.stats),
                   decisions_with_hits=sum(1 for d in target.decisions
                                           if d.hit_tokens > 0))
    return row


def phase_prefix_router(dev, served: dict, only=None) -> dict:
    """The prefix cache and the multi-replica router at full width in f32,
    every run with the launch counters zeroed just before it and read just
    after, each request against the plain B=1 engine's tokens under the
    margin rule, the launch counts against ``expected_fleet_launches``,
    and every allocator audited and leak-free after ``drop_cached``.

    An arch whose blocks can be shared (TinyLlama) serves ``prefix_trace``
    (a) through ``ContinuousEngine(prefix_cache=True)`` with whole prefill
    (hits, at least one copy-on-write fork, the two aligned copies
    admitted at different steps), (b) the same with bucketed 16-row
    chunks (fewer chunks than the prompts' blocks), (c) through
    ``Router.build(n_replicas=2, disaggregate=True)`` (a prefill and a
    decode replica, at least one handoff moving at least one block) and
    (d) through two co-located replicas with the prefix cache (at least
    one placement with a hit).  Any other arch must refuse the prefix
    cache with the reference's reason, and a disaggregated router must
    degrade to two co-located replicas that serve phase serve's prompts.
    Every replica serves the one weight dict (peak memory under 1.5 x the
    weights).  ``only`` names the runs to make (default all).  Returns
    {run: launches}."""
    import torch
    from repro_torch.models import lm
    from repro_torch.serve import ContinuousEngine, Router
    cfg, params = served["cfg"], served["params"]
    counters = launch_counters()
    weight_bytes = sum(t.numel() * t.element_size()
                       for t in _leaves(params))
    kw = {"kv_len": KV_LEN, "n_slots": N_SLOTS, "block_size": BLOCK,
          "dtype": torch.float32, "device": dev}
    t_phase = time.perf_counter()
    reason = lm.prefix_sharable_reason(cfg)
    if reason is None:
        trace, arrivals = prefix_trace(served["prompts"])
        refs = served["refs"] * 2 + plain_tokens(
            cfg, params, trace[-1:], dev, torch.float32) * 2
        chunked = {"bucket_prompts": True, "prefill_chunk": PREFIX_CHUNK}
        runs = {
            "whole": lambda: ContinuousEngine(
                cfg, params, paged=True, prefix_cache=True, **kw),
            "bucket_chunk": lambda: ContinuousEngine(
                cfg, params, paged=True, prefix_cache=True, **chunked,
                **kw),
            "disaggregated": lambda: Router.build(
                cfg, params, n_replicas=2, disaggregate=True,
                prefill_chunk=PREFIX_CHUNK, **kw),
            "colocated": lambda: Router.build(
                cfg, params, n_replicas=2, paged=True, prefix_cache=True,
                **kw)}
    else:
        try:
            ContinuousEngine(cfg, params, paged=True, prefix_cache=True,
                             **kw)
            refused = None
        except ValueError as exc:
            refused = str(exc)
        check(refused == f"{cfg.name}: prefix cache unavailable — {reason}",
              f"prefix_cache was not refused with the reason: {refused}")
        emit("prefix_router", arch=cfg.name, run="prefix_cache",
             refused=refused)
        trace, refs = served["prompts"], served["refs"]
        arrivals = [i * STAGGER for i in range(len(trace))]
        runs = {"degraded": lambda: Router.build(
            cfg, params, n_replicas=2, disaggregate=True, paged=True, **kw)}
    if only is not None:
        runs = {name: runs[name] for name in only}
    out = {}
    for name, build in runs.items():
        target = build()
        engines = replica_engines(target)
        check(all(e.params is params for e in engines),
              f"{name}: a replica holds its own weights")
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        results = serve_requests(target, trace, arrivals)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev)
        launches = {k: fn.launches for k, fn in counters.items()}
        counts = fleet_counts(engines)
        is_chunked = bool(engines[0].prefill_chunk)
        expect = expected_fleet_launches(cfg, counts, is_chunked)
        rows = hold_against_plain(cfg, params, trace, results, refs, dev)
        row = fleet_row(target, engines)
        emit("prefix_router", arch=cfg.name, run=name, dtype="float32",
             seconds=seconds, requests=rows,
             **counts, launches=launches, expected_launches=expect, **row,
             disagg_unsupported_reason=getattr(
                 target, "disagg_unsupported_reason", None),
             peak_memory_bytes=peak, weight_bytes=weight_bytes)
        check(launches == expect,
              f"{name}: launches {launches} != expected {expect}")
        check(all(r["ok"] for r in rows), f"{name}: tokens diverged: {rows}")
        check(peak < 1.5 * weight_bytes,
              f"{name}: peak memory {peak} B for {weight_bytes} B of weights")
        if name == "whole":
            check(row["hit_tokens"] > 0 and row["cow_forks"] >= 1,
                  f"whole: {row['hit_tokens']} hit tokens, "
                  f"{row['cow_forks']} forks")
            admitted = {a.request.rid: a.admitted_at
                        for a in target.scheduler.finished}
            n = len(trace)
            check(admitted[n - 2] != admitted[n - 1],
                  "the two aligned copies were admitted in one step")
            check(counts["prefills"] == n, f"{counts['prefills']} prefills")
        elif name == "bucket_chunk":
            blocks = sum(-(-len(p) // PREFIX_CHUNK) for p in trace)
            check(counts["chunks"] < blocks,
                  f"{counts['chunks']} chunks, not fewer than {blocks}")
        elif name == "disaggregated":
            check(row["roles"] == ["prefill", "decode"],
                  f"roles {row['roles']}")
            check(target.stats["handoffs"] >= 1 and
                  target.stats["transferred_blocks"] >= 1,
                  f"handoffs: {target.stats}")
        elif name == "colocated":
            check(row["decisions_with_hits"] >= 1,
                  "no placement found a prefix hit")
        else:
            check(row["roles"] == ["mixed", "mixed"] and
                  target.disagg_unsupported_reason == reason,
                  f"not degraded: {row['roles']}, "
                  f"{target.disagg_unsupported_reason}")
            check(counts["prefills"] == len(trace),
                  f"{counts['prefills']} prefills")
        check_drained(engines)
        out[name] = launches
        del target, engines
    emit("prefix_router", arch=cfg.name,
         seconds=time.perf_counter() - t_phase)
    return out


def time_prefix_router(cfg, params, prompts, dev) -> dict:
    """Runs (b) and (c) of phase ``prefix_router`` in bf16, untraced, each
    beside the same trace without the prefix cache (bucketed chunks on one
    engine; two co-located replicas with 16-row chunks), after a short
    warm-up: tokens/s, mean prefill (all its chunks) and chunk step, hit
    rate, decode starvation and peak memory.  Report only."""
    import torch
    from repro_torch.serve import ContinuousEngine, Router
    kw = {"kv_len": KV_LEN, "n_slots": N_SLOTS, "block_size": BLOCK,
          "dtype": torch.bfloat16, "device": dev}
    chunked = {"paged": True, "bucket_prompts": True,
               "prefill_chunk": PREFIX_CHUNK}
    runs = {
        "bucket_chunk": lambda: ContinuousEngine(
            cfg, params, prefix_cache=True, **chunked, **kw),
        "bucket_chunk_no_prefix_cache": lambda: ContinuousEngine(
            cfg, params, **chunked, **kw),
        "disaggregated": lambda: Router.build(
            cfg, params, n_replicas=2, disaggregate=True,
            prefill_chunk=PREFIX_CHUNK, **kw),
        "colocated_no_prefix_cache": lambda: Router.build(
            cfg, params, n_replicas=2, paged=True, prefix_cache=False,
            prefill_chunk=PREFIX_CHUNK, **kw)}
    trace, arrivals = prefix_trace(prompts)
    out = {"card": nvidia_smi()}
    for name, build in runs.items():
        serve_requests(build(), prompts[:2], [0, 0], 4)       # warm-up
        target = build()
        engines = replica_engines(target)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        results = serve_requests(target, trace, arrivals)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        steps = [s for e in engines for s in e.telemetry.steps]
        prefills = sum(s.prefills for s in steps)
        chunks = sum(s.prefill_chunks for s in steps)
        n_tokens = sum(len(v) for v in results.values())
        row = fleet_row(target, engines)
        out[name] = {
            "tokens": n_tokens, "wall_seconds": wall,
            "tokens_per_s": n_tokens / wall,
            "mean_prefill_ms": sum(s.prefill_seconds for s in steps)
            / prefills * 1e3,
            "mean_chunk_ms": sum(s.chunk_seconds for s in steps)
            / chunks * 1e3 if chunks else 0.0,
            "chunks": chunks, "hit_rate": row["hit_rate"],
            "decode_starvation": row["decode_starvation"],
            "max_memory_allocated_bytes":
                torch.cuda.max_memory_allocated(dev)}
    return out


def time_sample_spec(cfg, params, prompts, dev) -> dict:
    """Run (c) of phase ``sample_spec`` once more in bf16, untraced, after
    a short warm-up: tokens/s, the acceptance rate and the mean ms per
    speculative round (a lane's draft, verify, accept and rewind)."""
    import torch
    mode = {**PAGED, "speculate": SPECULATE}
    serve_trace(cfg, params, prompts[:2], dev, torch.bfloat16, 4, mode,
                sampled=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng, results = serve_trace(cfg, params, prompts[:SPEC_PROMPTS], dev,
                               torch.bfloat16, SPEC_NEW, mode, sampled=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    tel = eng.telemetry
    rounds = sum(len(s.active_slots) for s in tel.steps)
    n_tokens = sum(len(v) for v in results.values())
    return {"options": mode, "sampling": SAMPLED, "tokens": n_tokens,
            "wall_seconds": wall, "tokens_per_s": n_tokens / wall,
            "accept_rate": tel.accept_rate(),
            "drafted": tel.total_drafted(), "rounds": rounds,
            "verify_passes": eng.verify_passes,
            "ms_per_round": sum(s.decode_seconds for s in tel.steps)
            / rounds * 1e3,
            "mean_prefill_ms": tel.mean_prefill_ms()}


def phase_sampler(dev) -> dict:
    """The sampler of one batched decode step (``token_key`` of every
    lane's next position and ``sample_lanes``) at N_SLOTS lanes of each
    served vocabulary: its kernel launches per step (one profiled call)
    and its time per step by CUDA events.  Runs before any serve trace,
    for the profiler's sake (see ``phase_kernel_timing``)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import configs
    from repro_torch.serve import sampling
    out = {}
    for arch in (ARCH, SSM_ARCH, RG_ARCH, GEMMA_ARCH, CPM_ARCH):
        vocab = configs.get(arch).vocab_size
        gen = torch.Generator(device=dev).manual_seed(5)
        row = torch.randn((N_SLOTS, vocab), generator=gen, device=dev)
        keys = torch.stack([sampling.prng_key(SAMPLE_SEED + i, dev)
                            for i in range(N_SLOTS)])
        pos = torch.arange(N_SLOTS, dtype=torch.int32, device=dev) + 100
        temp = torch.full((N_SLOTS,), SAMPLED["temperature"], device=dev)
        topk = torch.full((N_SLOTS,), SAMPLED["top_k"], dtype=torch.int64,
                          device=dev)
        topp = torch.full((N_SLOTS,), SAMPLED["top_p"], device=dev)

        def step():
            return sampling.sample_lanes(
                row, sampling.token_key(keys, pos.long() + 1), temp, topk,
                topp)

        step()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step()
            torch.cuda.synchronize()
        launches = sum(e.count for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA)
        out[arch] = {"vocab": vocab, "lanes": N_SLOTS,
                     "launches_per_step": launches,
                     "ms_per_step_events": time_ms(step, iters=20)}
    emit("sampler", **out)
    return out


def check_clean(eng) -> None:
    """After a run: the allocator's invariants hold and no block, window
    ring or state slot is left in use."""
    eng.allocator.check()
    check(eng.allocator.n_in_use == 0, "blocks leaked after the run")
    check(not eng.allocator.window_tables,
          "window rings left after the run")
    check(eng.allocator.state_slots_in_use() == 0,
          "state slots left in use after the run")


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def profile_serve(cfg, params, prompts, dev, untraced_wall: float,
                  max_new: int = MAX_NEW) -> dict:
    """The same bf16 trace once more under ``torch.profiler``: device time
    by kernel name, the device's busy share of the traced and of the
    untraced wall time, and the tracing overhead.  Only the CUDA activity
    is recorded: nothing here reads the CPU operator events, and they
    multiply the profiler's own processing time (minutes over the three
    paths)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        serve_trace(cfg, params, prompts, dev, torch.bfloat16, max_new)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        t1 = time.perf_counter()

    # kernel events only: the operator events that launched them carry
    # the same device time again
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and device_us(e) > 0]
    processing = time.perf_counter() - t1
    busy_us = sum(device_us(e) for e in events)
    top = sorted(events, key=device_us, reverse=True)[:12]
    # the port's kernels by name: their device time per launch on this
    # path, without the host's cost of enqueueing them that CUDA events
    # around back-to-back calls include
    ours = {}
    for name in launch_counters():
        # flash_attention_{wgmma,f32}_kernel, paged_attention_kernel, ...
        hits = [e for e in events if name in e.key]
        calls = sum(e.count for e in hits)
        if calls:
            ours[name] = {"calls": calls, "device_ms_per_call":
                          sum(device_us(e) for e in hits) / calls / 1e3,
                          "kernels": sorted({e.key[:80] for e in hits})}
    return {
        "traced_wall_seconds": wall,
        "tracing_overhead_seconds": wall - untraced_wall,
        # host time to stop the profiler and aggregate its events
        "profiler_processing_seconds": processing,
        "device_busy_seconds": busy_us / 1e6,
        "device_busy_share_traced": busy_us / 1e6 / wall,
        # the kernels do the same work untraced, so this is the busy share
        # of the run that was timed without the profiler
        "device_busy_share_untraced": busy_us / 1e6 / untraced_wall,
        "top_kernels": [{"name": e.key[:80], "calls": e.count,
                         "device_ms": device_us(e) / 1e3} for e in top],
        "port_kernels": ours,
    }


def to_bf16(tree: dict) -> dict:
    """A parameter tree in bf16, the float32-only leaves kept."""
    import torch
    from repro_torch.convert import F32_LEAVES
    return {k: to_bf16(v) if isinstance(v, dict)
            else v if k in F32_LEAVES else v.to(torch.bfloat16)
            for k, v in tree.items()}


def time_serve(dev, served: dict) -> tuple:
    """The path's trace in bf16 (the f32 weights of phase ``serve`` cast,
    the float32-only SSD leaves kept): tokens/s, mean decode step and
    prefill, peak memory, and the profiled repeat (``profile_trace``).
    Returns (serve metrics, bf16 params)."""
    import torch

    cfg, prompts = served["cfg"], served["prompts"]
    params = to_bf16(served.pop("params"))
    torch.cuda.empty_cache()
    serve_trace(cfg, params, prompts[:2], dev, torch.bfloat16, 4)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    eng, results = serve_trace(cfg, params, prompts, dev, torch.bfloat16)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    tel = eng.telemetry
    n_tokens = sum(len(v) for v in results.values())
    serve = {"tokens": n_tokens, "wall_seconds": wall,
             "tokens_per_s": n_tokens / wall,
             "mean_decode_step_ms": tel.mean_decode_step_ms(),
             "mean_prefill_ms": tel.mean_prefill_ms(),
             "max_memory_allocated_bytes":
                 torch.cuda.max_memory_allocated(dev)}
    serve["paged_bucket_chunk"] = time_mode(
        cfg, params, prompts, dev, SERVE_MODES["paged_bucket_chunk"])
    serve["sampled_spec"] = time_sample_spec(cfg, params, prompts, dev)
    serve["profile"] = profile_trace(cfg, params, prompts, dev, wall)
    return serve, params


def time_mode(cfg, params, prompts, dev, mode: dict) -> dict:
    """The bf16 trace once in ``mode``, untraced, after a short warm-up in
    the same mode: tokens/s, mean decode step, mean chunk step and mean
    prefill per prompt (all its chunks)."""
    import torch
    serve_trace(cfg, params, prompts[:2], dev, torch.bfloat16, 4, mode)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng, results = serve_trace(cfg, params, prompts, dev, torch.bfloat16,
                               mode=mode)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    tel = eng.telemetry
    n_tokens = sum(len(v) for v in results.values())
    return {"options": mode, "tokens": n_tokens, "wall_seconds": wall,
            "tokens_per_s": n_tokens / wall,
            "mean_decode_step_ms": tel.mean_decode_step_ms(),
            "mean_chunk_ms": tel.mean_chunk_ms(),
            "chunks": tel.prefill_chunks(),
            "mean_prefill_ms": tel.mean_prefill_ms()}


def set_bound(row: dict, flops_per_s: float = None) -> dict:
    """Bound ``row`` by the H100 SXM's memory rate and ``flops_per_s``
    (default: its dense bf16 tensor-core peak), both read from the
    planner's device spec, the port's one source of the datasheet
    figures."""
    from repro_torch.core import H100_SXM
    flops_per_s = flops_per_s or H100_SXM.flops_per_s
    t_bytes = row["bytes"] / H100_SXM.hbm_bw * 1e3
    t_ops = row["flops"] / flops_per_s * 1e3
    row["bound_ms"] = max(t_bytes, t_ops)
    row["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    return row


def profiled_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Device time of one call on ``torch.profiler``'s clock (the clock of
    the serve trace's per-kernel device times): for each kernel name that
    ``iters`` calls launch, its mean device time per launch, summed over
    the names.  The profiler may drop some of a session's kernel records,
    so the mean is taken over the records it kept; a session that kept
    none is repeated, up to three times."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.count
                   and device_us(e) > 0]
        if kernels:
            return sum(device_us(e) / e.count for e in kernels) / 1e3
    raise RuntimeError("the profiler recorded no kernel in three sessions")


def profiled_kernels(fn, iters: int = 5) -> list:
    """The names of the device kernels that calls of ``fn`` launch,
    recorded as ``profiled_ms`` records them.  A one-call session listed
    none of a compiled ``flex_attention`` call's kernels, with or without
    the CPU activity, so each session runs ``iters`` calls, and one that
    kept no kernel is repeated, up to three times."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        names = sorted({e.key[:80] for e in prof.key_averages()
                        if e.device_type == DeviceType.CUDA})
        if names:
            return names
    return []


def paged_timing(gen, dev, cfg, lens, max_blocks) -> dict:
    """The paged kernel in bf16 at ``cfg``'s heads, window and logit
    softcap, one decode step of lanes with contexts ``lens``, with the
    wrapper's own split."""
    import torch
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.paged_attention import ref as pa_ref
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    win, cap = cfg.window_size, cfg.attn_logit_softcap
    B = len(lens)
    q, kp, vp, tbl, ln = paged_inputs(gen, dev, torch.bfloat16, B, H, KV,
                                      hd, BLOCK, max_blocks, lens)
    # the rows each lane attends: its last ``window`` ones with a window
    used = [min(n, win) if win else n for n in lens]
    rows_used = sum(used)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    row = {
        "shape": {"B": B, "H": H, "KV": KV, "hd": hd, "bs": BLOCK,
                  "max_blocks": max_blocks, "context_lens": lens,
                  "window": win, "softcap": cap, "dtype": "bfloat16",
                  "n_split": pa_ops.choose_split(B, H, KV, max_blocks,
                                                 BLOCK, win, n_sm)},
        "ms": time_ms(lambda: pa_ops.paged_attention(
            q, kp, vp, tbl, ln, window=win, logit_softcap=cap)),
        "device_ms": profiled_ms(lambda: pa_ops.paged_attention(
            q, kp, vp, tbl, ln, window=win, logit_softcap=cap)),
        "plain_ms": time_ms(lambda: pa_ref.reference(
            q[:, None], kp, vp, tbl, ln, q_positions=(ln - 1)[:, None],
            window=win, logit_softcap=cap)),
        "bytes": (2 * rows_used * KV * hd * 2 + 2 * q.numel() * 2
                  + sum(-(-n // BLOCK) for n in used) * 4 + B * 4),
        "flops": 4 * rows_used * H * hd,
        "library_ms": None, "library_device_ms": None,
    }
    row["shape"]["ctas"] = B * KV * row["shape"]["n_split"]
    return set_bound(row)


def flex_softcap(q, k, v, win: int, cap: float):
    """One compiled ``flex_attention`` call over q, k, v ([B, heads, S,
    hd], GQA): causal, inside ``win`` where one is set, with cap *
    tanh(s / cap) on the scaled logits, the library call for a softcapped
    config (SDPA has no softcap).  It is compiled here, once per shape,
    on one compile thread (no worker processes)."""
    import torch
    import torch._inductor.config as inductor_config
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)
    inductor_config.compile_threads = 1

    def softcap(score, b, h, q_idx, kv_idx):
        return cap * torch.tanh(score / cap)

    def visible(b, h, q_idx, kv_idx):
        ok = q_idx >= kv_idx
        return ok & (q_idx - kv_idx < win) if win else ok

    S = q.shape[2]
    mask = create_block_mask(visible, None, None, S, S, device=q.device)
    fn = torch.compile(flex_attention, dynamic=False)
    return lambda: fn(q, k, v, score_mod=softcap, block_mask=mask,
                      enable_gqa=True)


def flash_timing(gen, dev, cfg, S) -> dict:
    """The flash kernel in bf16 at ``cfg``'s heads, window and logit
    softcap, one causal S-row prompt, beside one PyTorch call of the same
    function, both timed by CUDA events and by the profiler's device time:
    ``scaled_dot_product_attention`` (GQA heads expanded; the window as a
    mask where it cuts the prompt), or for a softcapped config (gemma2),
    which SDPA cannot compute, a compiled ``flex_attention``
    (``flex_softcap``).  ``library_max_abs_err``: the library's output
    against the kernel's."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    H, KV, hd, dv = mla_dims(cfg)
    win, cap = cfg.window_size, cfg.attn_logit_softcap
    q, k, v = flash_inputs(gen, dev, torch.bfloat16, 1, S, S, H, KV, hd, dv)
    pos = torch.arange(S, dtype=torch.int32, device=dev)
    # visible (query, key) pairs only: causal, inside the window
    pairs = sum(min(i + 1, win) if win else i + 1 for i in range(S))
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))

    def kernel():
        return fa_ops.flash_attention(q, k, v, q_positions=pos,
                                      k_positions=pos, window=win,
                                      logit_softcap=cap)

    if cap:
        library = flex_softcap(qt, kt, vt, win, cap)
    else:
        kt, vt = (x.repeat_interleave(H // KV, dim=1) for x in (kt, vt))
        sdpa = {"is_causal": True}
        if win and win < S:
            dist = pos[:, None] - pos[None, :]
            sdpa = {"attn_mask": (dist >= 0) & (dist < win)}

        def library():
            return F.scaled_dot_product_attention(qt, kt, vt, **sdpa)

    out_numel = q.numel() // hd * dv
    row = {
        "shape": {"B": 1, "Sq": S, "Skv": S, "H": H, "KV": KV, "hd": hd,
                  "dv": dv, "causal": True, "window": win, "softcap": cap,
                  "dtype": "bfloat16", "grid": [-(-S // 64), H],
                  "tile": "64 query rows x 64 keys, one warpgroup"},
        "ms": time_ms(kernel),
        "device_ms": profiled_ms(kernel),
        "plain_ms": time_ms(lambda: fa_ref.reference(
            q, k, v, q_positions=pos, k_positions=pos, window=win,
            logit_softcap=cap)),
        "library": "flex_attention" if cap else
        "scaled_dot_product_attention",
        "library_ms": time_ms(library),
        "library_device_ms": profiled_ms(library),
        # the kernels the library ran: SDPA's backend (flash, memory-
        # efficient, cuDNN or math) or flex's Triton kernel, by name
        "library_kernels": profiled_kernels(library),
        "library_max_abs_err": float(
            (library().transpose(1, 2).float() - kernel().float())
            .abs().max()),
        # q, k, v and out once each in bf16, and the two position vectors
        "bytes": 2 * (q.numel() + k.numel() + v.numel() + out_numel)
        + 2 * 4 * S,
        "flops": 2 * pairs * H * (hd + dv),
    }
    return set_bound(row)


def attention_timing(dev, cfg, seed: int) -> dict:
    """Both attention kernels at ``cfg``'s shapes in bf16: paged, one
    decode step of the trace's first four lanes 16 tokens in, and one lane
    4096 rows in; flash, the prefill of the trace's 131-row prompt, and a
    2048-row prompt (past the ~660-row ridge, where the tensor cores bound
    it).  A modality frontend's rows come first in both: its lanes' tables
    span ``KV_LEN`` + those rows, and its prompt holds them."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed)
    F = cfg.prepended_rows
    lens = [F + n + 16 for n in PROMPT_LENS[:N_SLOTS]]
    return {
        "paged_attention": paged_timing(gen, dev, cfg, lens,
                                        (KV_LEN + F) // BLOCK),
        "paged_attention_long": paged_timing(gen, dev, cfg, [4096],
                                             4096 // BLOCK),
        "flash_attention": flash_timing(gen, dev, cfg, F + PROMPT_LENS[3]),
        "flash_attention_long": flash_timing(gen, dev, cfg, 2048),
    }


def ssd_timing(gen, dev, cfg, S) -> dict:
    """The SSD-scan kernel at ``cfg``'s shapes as one prefill of S rows
    calls it (bf16 x/B/C, f32 dt, the fresh cache's zero state), on both
    clocks, beside its plain version.  The bound is at the bf16 tensor-core
    rate of the kernel's bf16 body; ``bound_ms_cuda_cores`` gives the same
    work at the CUDA cores' f32 rate (the f32 body's)."""
    import torch
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan import ref as ssd_ref
    nh, hd, ns = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    args = ssd_inputs(gen, dev, torch.bfloat16, 1, S, nh, hd, ns)
    h0 = torch.zeros((1, nh, hd, ns), device=dev)
    nbytes, flops = ssd_cost(S, nh, hd, ns, 2, seeded=True)

    def kernel():
        return ssd_ops.ssd_scan(*args, init_state=h0)

    row = {"shape": {"B": 1, "S": S, "nh": nh, "hd": hd, "ns": ns,
                     "x_dtype": "bfloat16", "init_state": True,
                     "grid": [hd // 16, nh, 1], "chunk_rows": 64},
           "ms": time_ms(kernel), "device_ms": profiled_ms(kernel),
           "plain_ms": time_ms(lambda: ssd_ref.reference(
               *args, chunk=cfg.ssm_chunk, init_state=h0),
               iters=50 if S < 1024 else 5),
           "bytes": nbytes, "flops": flops,
           "library_ms": None, "library_device_ms": None}
    row["bound_ms_cuda_cores"] = set_bound(dict(row),
                                           F32_FLOPS_PER_S)["bound_ms"]
    return set_bound(row)


def rglru_timing(gen, dev, cfg, S) -> dict:
    """The RG-LRU-scan kernel at ``cfg``'s width as one prefill of S rows
    calls it (B 1, f32 a and bx, the fresh cache's zero state as h0), with
    the wrapper's chunk count, on both clocks, beside its plain version."""
    import torch
    from repro_torch.kernels.rglru_scan import ops as rglru_ops
    from repro_torch.kernels.rglru_scan import ref as rglru_ref
    W = cfg.lru_width
    a, bx = rglru_inputs(gen, dev, 1, S, W)
    h0 = torch.zeros((1, W), device=dev)
    nbytes, flops = rglru_cost(1, S, W)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    k = rglru_ops.choose_chunks(1, S, W, n_sm)

    def kernel():
        return rglru_ops.rglru_scan(a, bx, h0)

    row = {"shape": {"B": 1, "S": S, "W": W, "dtype": "float32",
                     "init_state": True, "n_chunks": k,
                     "chunk_rows": rglru_ref.chunk_rows(S, k),
                     "ctas": -(-W // rglru_ops.CHANNELS),
                     "threads_per_cta": rglru_ops.CHANNELS * k},
           "ms": time_ms(kernel), "device_ms": profiled_ms(kernel),
           "plain_ms": time_ms(lambda: rglru_ref.reference(a, bx, h0),
                               iters=50 if S < 1024 else 5),
           "bytes": nbytes, "flops": flops,
           "library_ms": None, "library_device_ms": None}
    return set_bound(row, F32_FLOPS_PER_S)


def phase_kernel_timing(dev) -> dict:
    """Both attention kernels at TinyLlama's, recurrentgemma's,
    phi-3-vision's (hd 96), command-r-35b's (hd 128, G 8), gemma2-9b's
    (hd 256, G 2, softcap 50, window 4096) and minicpm-2b's (MHA, hd 64)
    shapes (``{arch: rows}``; phi-3's prompt and tables behind its 576
    frontend rows), flash at deepseek-v2-lite's MLA prefill shape, and
    the scans at mamba2-370m's and recurrentgemma-2b's (``{"scans":
    rows}``), each at the trace's 131-row prompt and at a 2048-row one.
    They run before any serve trace: the profiler's short sessions lose
    their kernel records after the long mamba2 trace has been profiled in
    the same process."""
    import torch
    from repro_torch import configs
    timing = {arch: attention_timing(dev, configs.get(arch), seed)
              for arch, seed in ((ARCH, 99), (RG_ARCH, 97), (VLM_ARCH, 95),
                                 (CR_ARCH, 94), (GEMMA_ARCH, 93),
                                 (CPM_ARCH, 92))}
    # MLA's prefill shape (H = KV = 16, q/k 192, v 128): flash only, since
    # no kernel runs MLA's decode
    gen = torch.Generator(device=dev).manual_seed(96)
    ds = configs.get(DS_ARCH)
    timing[DS_ARCH] = {
        "flash_attention": flash_timing(gen, dev, ds, PROMPT_LENS[3]),
        "flash_attention_long": flash_timing(gen, dev, ds, 2048)}
    gen = torch.Generator(device=dev).manual_seed(98)
    ssm, rg = configs.get(SSM_ARCH), configs.get(RG_ARCH)
    timing["scans"] = {
        "ssd_scan": ssd_timing(gen, dev, ssm, PROMPT_LENS[3]),
        "ssd_scan_long": ssd_timing(gen, dev, ssm, 2048),
        "rglru_scan": rglru_timing(gen, dev, rg, PROMPT_LENS[3]),
        "rglru_scan_long": rglru_timing(gen, dev, rg, 2048),
    }
    emit("kernel_timing", dtype="bfloat16", **timing)
    return timing


def phase_timing(dev, served: dict) -> None:
    """TinyLlama's path: the bf16 trace, and phase prefix_router's runs (b)
    and (c) beside the same trace without the prefix cache."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.paged_attention import ops as pa_ops

    cfg, prompts = served["cfg"], served["prompts"]
    serve, params = time_serve(dev, served)
    serve["prefix_router"] = time_prefix_router(cfg, params, prompts, dev)
    del params
    emit("timing", arch=cfg.name, dtype="bfloat16", serve=serve,
         launches_bf16={"paged_attention": pa_ops.paged_attention.launches,
                        "flash_attention": fa_ops.flash_attention.launches})


def phase_timing_ssm(dev, served: dict) -> None:
    """mamba2-370m's path: the bf16 trace, which must launch the SSD
    kernel's tensor-core body and no other."""
    from repro_torch.kernels.ssd_scan import ops as ssd_ops

    cfg = served["cfg"]
    serve, params = time_serve(dev, served)
    del params
    emit("timing", arch=cfg.name, dtype="bfloat16", serve=serve,
         launches_bf16={"ssd_scan": ssd_ops.ssd_scan.launches})
    bodies = serve["profile"]["port_kernels"]["ssd_scan"]["kernels"]
    check(bodies and all("ssd_scan_mma_kernel" in k for k in bodies),
          f"the bf16 trace launched {bodies}, not the tensor-core body only")


def phase_timing_rg(dev, served: dict) -> None:
    """recurrentgemma-2b's path: the bf16 trace."""
    cfg = served["cfg"]
    serve, params = time_serve(dev, served)
    del params
    emit("timing", arch=cfg.name, dtype="bfloat16", serve=serve,
         launches_bf16={name: fn.launches
                        for name, fn in launch_counters().items()})


def time_bf16_trace(cfg, params, prompts, dev) -> dict:
    """The bf16 trace once, untraced, after a short warm-up, with every
    launch counter zeroed just before it: tokens/s, mean decode step and
    prefill, peak memory, weight bytes, and the launches beside
    ``expected_paged_launches``."""
    import torch
    serve_trace(cfg, params, prompts[:2], dev, torch.bfloat16, 4)  # warm-up
    torch.cuda.synchronize()
    counters = launch_counters()
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    eng, results = serve_trace(cfg, params, prompts, dev, torch.bfloat16)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    tel = eng.telemetry
    n_tokens = sum(len(v) for v in results.values())
    return {"tokens": n_tokens, "wall_seconds": wall,
            "tokens_per_s": n_tokens / wall,
            "mean_decode_step_ms": tel.mean_decode_step_ms(),
            "mean_prefill_ms": tel.mean_prefill_ms(),
            "max_memory_allocated_bytes":
                torch.cuda.max_memory_allocated(dev),
            "weight_bytes": sum(t.numel() * t.element_size()
                                for t in _leaves(params)),
            "peak_resident_bytes_by_group":
                tel.peak_resident_bytes_by_group(),
            "launches": {name: fn.launches
                         for name, fn in counters.items()},
            "expected_launches": expected_paged_launches(
                cfg, sum(s.prefills for s in tel.steps),
                sum(1 for s in tel.steps if s.active_slots))}


def profile_trace(cfg, params, prompts, dev, wall: float) -> dict:
    """The profiled repeat of a path's bf16 trace (``profile_serve``),
    whose untraced run took ``wall`` seconds: the whole trace for the
    paths in WHOLE_PROFILE, else the first PROFILE_PROMPTS requests for
    PROFILE_NEW tokens, untraced and once more profiled (the busy share is
    that short trace's).  ``trace`` names the one profiled."""
    import torch
    if cfg.name in WHOLE_PROFILE:
        out = profile_serve(cfg, params, prompts, dev, wall)
        out["trace"] = {"requests": len(prompts), "max_new": MAX_NEW}
        return out
    short = prompts[:PROFILE_PROMPTS]
    t0 = time.perf_counter()
    serve_trace(cfg, params, short, dev, torch.bfloat16, PROFILE_NEW)
    torch.cuda.synchronize()
    out = profile_serve(cfg, params, short, dev, time.perf_counter() - t0,
                        PROFILE_NEW)
    out["trace"] = {"requests": PROFILE_PROMPTS, "max_new": PROFILE_NEW}
    return out


def check_bf16_timing(serve: dict) -> None:
    """The bf16 trace's launches against the serve formula, and flash on
    its tensor-core body in the profiled repeat."""
    check(serve["launches"] == serve["expected_launches"],
          f"bf16 launches {serve['launches']} != expected "
          f"{serve['expected_launches']}")
    bodies = serve["profile"]["port_kernels"].get("flash_attention", {})
    check(bodies and all("wgmma" in k for k in bodies["kernels"]),
          f"the bf16 trace's flash launches ran {bodies}, not the "
          "tensor-core body")


def phase_timing_fresh(dev, served: dict) -> None:
    """The bf16 trace of a path after TinyLlama's three: the f32 weights
    of phase ``serve`` are freed first and bf16 ones made from the same
    seed (the f32 draws rounded, as a cast would give; for some paths the
    two do not fit on the card together), at ``BF16_DEPTH[arch]`` layers,
    else at the f32 gate's depth (command-r: 40 layers, 60.6 GB, beside an
    f32 gate of 8).  ``time_bf16_trace`` and the profiled repeat
    (``profile_trace``); the line gives the bf16 tree's parameter count,
    its init time and the peak memory of the init."""
    import gc

    import torch
    from repro_torch.models import lm

    arch, prompts = served["cfg"].name, served["prompts"]
    del served["params"]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    cfg = cut_config(arch, BF16_DEPTH.get(arch, served["cfg"].n_layers))
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    params = lm.init_params(cfg, gen, dev, torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated(dev)
    serve = time_bf16_trace(cfg, params, prompts, dev)
    serve["profile"] = profile_trace(cfg, params, prompts, dev,
                                     serve["wall_seconds"])
    counts = param_counts(arch, cfg, params)
    del params
    emit("timing", arch=cfg.name, dtype="bfloat16", **counts,
         init_seconds=init_s, init_peak_memory_bytes=init_peak,
         serve=serve)
    check_bf16_timing(serve)


def phase_long_request(dev, served: dict) -> dict:
    """gemma2-9b's long request, f32 at full width: one LONG_PROMPT-token
    prompt (past the 4,096-row window) for MAX_NEW tokens, alone in
    ``ContinuousEngine(paged=True, kv_len=LONG_KV_LEN, n_slots=1)``, the
    launch counters zeroed just before the run and read just after: flash
    per attention layer for the one whole prefill (windowed past the
    window on the sliding-window layers), paged per attention layer and
    decode step.  The ring's peak blocks may not exceed the engine's
    ``window_cap_blocks`` and blocks must fall behind the window during
    decode; the tokens are held against the plain B=1 engine at the same
    ``kv_len`` under the margin rule.  Returns the launches."""
    import torch
    from repro_torch.serve import ContinuousEngine

    cfg, params = served["cfg"], served["params"]
    gen = torch.Generator(device=dev).manual_seed(41)
    prompt = torch.randint(0, cfg.vocab_size, (LONG_PROMPT,), generator=gen,
                           device=dev).tolist()
    torch.cuda.reset_peak_memory_stats(dev)
    eng = ContinuousEngine(cfg, params, kv_len=LONG_KV_LEN, n_slots=1,
                           block_size=BLOCK, dtype=torch.float32,
                           device=dev, paged=True)
    alloc = eng.allocator
    seen = {"ring_peak_blocks": 0, "global_peak_blocks": 0,
            "ring_blocks_freed": 0}
    slide = alloc.extend_window

    def counted_slide(slot, n_tokens_total, **kw):
        fresh, freed = slide(slot, n_tokens_total, **kw)
        seen["ring_blocks_freed"] += len(freed)
        seen["ring_peak_blocks"] = max(seen["ring_peak_blocks"],
                                       len(alloc.window_tables[slot]))
        seen["global_peak_blocks"] = max(seen["global_peak_blocks"],
                                         len(alloc.tables[slot]))
        return fresh, freed

    alloc.extend_window = counted_slide
    counters = launch_counters()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    eng.submit(prompt, MAX_NEW, rid=0)
    try:
        results = eng.run()
    finally:
        del alloc.extend_window
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated(dev)
    tel = eng.telemetry
    decode_steps = sum(1 for s in tel.steps if s.active_slots)
    expect = expected_paged_launches(cfg, 1, decode_steps)
    cap = alloc.layout.window_cap_blocks
    refs = plain_tokens(cfg, params, [prompt], dev, torch.float32,
                        kv_len=LONG_KV_LEN)
    rows = hold_against_plain(cfg, params, [prompt], results, refs, dev)
    emit("long_request", arch=cfg.name, dtype="float32",
         prompt_len=LONG_PROMPT, max_new=MAX_NEW, kv_len=LONG_KV_LEN,
         window=cfg.window_size, window_cap_blocks=cap, **seen,
         requests=rows, decode_steps=decode_steps, launches=launches,
         expected_launches=expect, wall_seconds=wall,
         peak_memory_bytes=peak,
         peak_resident_bytes_by_group=tel.peak_resident_bytes_by_group())
    check(LONG_PROMPT > cfg.window_size,
          "the long prompt does not pass the window")
    check(0 < seen["ring_peak_blocks"] <= cap,
          f"ring peak {seen['ring_peak_blocks']} blocks, cap {cap}")
    check(seen["ring_blocks_freed"] > 0,
          "no ring block fell behind the window")
    check(launches == expect, f"launches {launches} != expected {expect}")
    check(all(r["ok"] for r in rows), f"tokens diverged: {rows}")
    check_clean(eng)
    return launches


def _value_and_grad(loss_fn, params, batch) -> tuple:
    """(loss, metrics, {path: gradient}) of ``loss_fn`` at ``params``."""
    from repro_torch.train import value_and_grad
    from repro_torch.tree import flatten
    loss, metrics, grads = value_and_grad(loss_fn, params, batch)
    return loss, metrics, {path: g for (path, _), g
                           in zip(flatten(params), grads)}


def _device_batch(cfg, seq, batch, seed, dev) -> dict:
    """``SyntheticLM``'s first batch on ``dev``, with stub frontend rows
    for a modality-frontend or enc-dec config."""
    import torch
    from repro_torch.data import DataConfig, SyntheticLM
    data = SyntheticLM(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch,
        seed=seed, frontend_tokens=cfg.frontend_tokens if cfg.frontend else 0,
        frontend_dim=cfg.frontend_dim if cfg.frontend else 0))
    return {k: torch.from_numpy(v).to(dev)
            for k, v in data.batch_at(0).items()}


def _leaf_err(got: dict, exp: dict) -> float:
    """The largest of |got - exp| over |exp|'s max-abs, over the leaves
    of two {path: tensor} maps (moved to ``exp``'s devices)."""
    return max(((got[k].to(e.device) - e).abs().max()
                / e.abs().max().clamp_min(1e-30)).item()
               for k, e in exp.items())


def train_card_vs_host(dev) -> None:
    """(a): one f32 step of each config cut to one cycle repeat, on the
    card and on the host CPU, from the same weights and batch."""
    import torch
    from repro_torch import configs
    from repro_torch.models import lm
    from repro_torch.optim import constant, global_norm
    from repro_torch.train import make_train_step
    from repro_torch.tree import tree_map, unflatten
    for arch, layers in TRAIN_CHECKS:
        full = configs.get(arch)
        cfg = full.replace(n_layers=layers or len(full.layer_cycle))
        _, loss_fn = make_train_step(cfg, constant(0.0))
        # drawn on the card: the host's generator takes seconds a billion
        card = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(11),
                              dev, torch.float32)
        host = tree_map(lambda t: t.cpu(), card)
        out = {}
        for where, params, d in (("host", host, torch.device("cpu")),
                                 ("card", card, dev)):
            t0 = time.perf_counter()
            loss, metrics, grads = _value_and_grad(
                loss_fn, params, _device_batch(cfg, 64, 2, 11, d))
            norm = global_norm(unflatten(grads.items())).item()
            out[where] = (loss.item(), metrics["aux"].item(), norm,
                          {k: g.cpu() for k, g in grads.items()},
                          time.perf_counter() - t0)
        (hl, ha, hn, hg, hs), (cl, ca, cn, cg, cs) = out["host"], out["card"]
        leaf_err = _leaf_err(cg, hg)
        row = {"arch": arch, "n_layers": cfg.n_layers,
               "params": sum(t.numel() for t in _leaves(host)),
               "loss_host": hl, "loss_card": cl,
               "loss_rel_err": abs(cl - hl) / abs(hl),
               "aux_host": ha, "aux_card": ca,
               "aux_rel_err": abs(ca - ha) / abs(ha) if ha else abs(ca),
               "grad_norm_host": hn, "grad_norm_card": cn,
               "grad_norm_rel_err": abs(cn - hn) / hn,
               "max_leaf_err_over_leaf_max": leaf_err,
               "host_seconds": hs, "card_seconds": cs}
        emit("train_card_vs_host", **row)
        check(row["loss_rel_err"] <= 1e-5, f"{arch}: loss {cl} vs {hl}")
        check(row["aux_rel_err"] <= 1e-5, f"{arch}: aux {ca} vs {ha}")
        check((ha > 0) == any(s.ffn == "moe" for s in cfg.layers()),
              f"{arch}: aux {ha} with MoE layers "
              f"{[s.ffn for s in cfg.layers()]}")
        check(row["grad_norm_rel_err"] <= 1e-4,
              f"{arch}: grad norm {cn} vs {hn}")
        check(leaf_err <= 1e-4, f"{arch}: a gradient leaf is {leaf_err} of "
              "its max-abs off the host's")
        del host, card, out, hg, cg


def _launch_train(*argv) -> dict:
    """``repro_torch.launch.train.main``, its printed lines sent to
    stderr so that standard output stays one JSON object per line."""
    import contextlib
    from repro_torch.launch import train as launch_train
    with contextlib.redirect_stdout(sys.stderr):
        return launch_train.main(list(argv))


def train_full_width(dev) -> None:
    """(b): each config at full depth and width in bf16 through the
    launcher."""
    import torch
    from repro_torch import configs
    from repro_torch.core import H100_SXM
    from repro_torch.models import lm
    from repro_torch.tree import flatten
    for arch, batch, seq, steps, extra in TRAIN_RUNS:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = _launch_train("--arch", arch, "--batch", str(batch), "--seq",
                            str(seq), "--steps", str(steps), "--log-every",
                            "5", *extra)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        hist = res["history"]
        start = lm.init_params(res["cfg"],
                               torch.Generator(device=dev).manual_seed(0),
                               dev, res["dtype"])
        still = ["/".join(path) for (path, a), (_, b)
                 in zip(flatten(start), flatten(res["params"]))
                 if torch.equal(a, b)]
        median_s = res["telemetry"].median_ms() / 1e3
        tokens = batch * seq
        losses = [h["loss"] for h in hist]
        row = {"arch": arch, "dtype": "bfloat16", "batch": batch,
               "seq": seq, "frontend_rows": res["cfg"].frontend_tokens
               if res["cfg"].frontend else 0,
               "layers": res["cfg"].n_layers,
               "of_layers": configs.get(arch).n_layers, "steps": steps,
               "params": res["n_params"], "losses": losses,
               "aux_losses": [h["aux"] for h in hist],
               "grad_norms": [h["grad_norm"] for h in hist],
               "lrs": [h["lr"] for h in hist],
               "step_ms": [h["seconds"] * 1e3 for h in hist],
               "median_step_ms": median_s * 1e3,
               "tokens_per_s": tokens / median_s,
               "peak_memory_bytes": peak,
               "model_flops_per_s": 6 * res["n_params"] * tokens / median_s,
               "mfu_of_989_tflops": 6 * res["n_params"] * tokens / median_s
               / H100_SXM.flops_per_s,
               "plan": res["plan"].describe(),
               "modelled_plan_step_ms": res["plan"].step_time * 1e3,
               "stragglers": res["telemetry"].n_stragglers(),
               "leaves_not_moved": still, "wall_seconds": wall}
        emit("train_full_width", **row)
        finite = [float(x) for x in losses + row["grad_norms"]]
        check(all(abs(x) < float("inf") for x in finite),
              f"{arch}: a loss or grad norm is not finite: {finite}")
        check(not still, f"{arch}: leaves did not move: {still}")
        moe = any(s.ffn == "moe" for s in res["cfg"].layers())
        check(all((a > 0) == moe and abs(a) < float("inf")
                  for a in row["aux_losses"]),
              f"{arch}: aux losses {row['aux_losses']} (MoE layers: {moe})")
        if arch == ARCH:
            first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
            check(last < first - 0.2,
                  f"{arch}: mean loss {first} -> {last}, not 0.2 lower")
        del res, start


def train_grad_accum(dev) -> None:
    """(c): full TinyLlama in f32, grad_accum 2 against 1, one step."""
    import torch
    from repro_torch import configs
    from repro_torch.models import lm
    from repro_torch.optim import constant, init_state
    from repro_torch.train import TrainStepConfig, make_train_step
    from repro_torch.tree import flatten, tree_map
    cfg = configs.get(ARCH)
    p0 = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(12),
                        dev, torch.float32)
    batch = _device_batch(cfg, 256, 4, 12, dev)
    out = []
    for n in (1, 2):
        params = tree_map(torch.clone, p0)
        step_fn, _ = make_train_step(cfg, constant(1e-3),
                                     TrainStepConfig(grad_accum=n))
        params, _, m = step_fn(params, init_state(params), batch, 0)
        out.append((params, m["loss"].item()))
    (p1, l1), (p2, l2) = out
    d_param = max((a - b).abs().max().item() for (_, a), (_, b)
                  in zip(flatten(p1), flatten(p2)))
    row = {"arch": ARCH, "dtype": "float32", "batch": 4, "seq": 256,
           "loss_accum1": l1, "loss_accum2": l2, "d_loss": abs(l1 - l2),
           "max_d_param": d_param}
    emit("train_grad_accum", **row)
    check(row["d_loss"] < 1e-4, f"grad_accum: |d loss| {row['d_loss']}")
    check(d_param < 5e-3, f"grad_accum: max |d param| {d_param}")


def train_resume() -> None:
    """(d): full paper-mlp in f32 through the launcher, 6 steps straight
    against 3, a checkpoint, and 3 more resumed."""
    common = ("--arch", MLP_ARCH, "--batch", "8", "--seq", "512",
              "--dtype", "float32", "--log-every", "1")
    with tempfile.TemporaryDirectory(prefix="ckpt-") as ckpt:
        straight = _launch_train(*common, "--steps", "6")
        first = _launch_train(*common, "--steps", "3", "--ckpt-dir", ckpt,
                              "--ckpt-every", "3")
        resumed = _launch_train(*common, "--steps", "6", "--ckpt-dir", ckpt,
                                "--resume")
    got = first["history"] + resumed["history"]
    exp = straight["history"]
    rel = [abs(g["loss"] - e["loss"]) / abs(e["loss"])
           for g, e in zip(got, exp)]
    row = {"arch": MLP_ARCH, "dtype": "float32",
           "steps": [g["step"] for g in got],
           "losses_straight": [e["loss"] for e in exp],
           "losses_resumed": [g["loss"] for g in got], "rel_err": rel,
           "plan_cache_hits": [r["plan"].from_cache
                               for r in (straight, first, resumed)]}
    emit("train_resume", **row)
    check(row["steps"] == list(range(6)),
          f"resume: steps {row['steps']}")
    check([h["step"] for h in resumed["history"]] == [3, 4, 5],
          "resume did not start at step 3")
    check(max(rel[3:]) <= 1e-5, f"resume: steps 4-6 losses off by {rel}")
    check(all(row["plan_cache_hits"][1:]),
          f"plan cache hits {row['plan_cache_hits']}: the same shape was "
          "compiled again")


def stage_devices(n_stages: int) -> list:
    """The pipeline's stage devices: spread over the cards in order when
    the machine has more than one, else all on the one card."""
    import torch
    n = min(torch.cuda.device_count(), n_stages)
    return [torch.device("cuda", s * n // n_stages) for s in range(n_stages)]


def _placement(devices) -> dict:
    distinct = len(set(devices))
    return {"stage_devices": [str(d) for d in devices],
            "placement": ("distinct cards" if distinct == len(devices)
                          else f"{len(devices)} stages on {distinct} "
                          f"card{'s' if distinct > 1 else ''}")}


def _sync(devices) -> None:
    import torch
    for d in set(devices):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def _pipeline_grads(cfg, params, batch, devices, n_micro,
                    join: bool = True) -> tuple:
    """(loss, seconds, {path: gradient}) of the pipeline's loss over
    ``devices``, the gradients joined back to the one-card layout or (not
    ``join``) in the pipeline's."""
    from repro_torch.train import (join_stage_params,
                                   make_pipeline_train_step,
                                   split_stage_params)
    from repro_torch.tree import flatten, unflatten
    split = split_stage_params(cfg, params, devices)
    _, loss_fn = make_pipeline_train_step(cfg, devices,
                                          n_microbatches=n_micro)
    _sync(devices)
    t0 = time.perf_counter()
    loss, _, grads = _value_and_grad(loss_fn, split, batch)
    _sync(devices)
    seconds = time.perf_counter() - t0
    if not join:
        return loss.item(), seconds, grads
    joined = join_stage_params(unflatten(grads.items()))
    return loss.item(), seconds, dict(flatten(joined))


def pipeline_vs_one_card(dev) -> None:
    """(a): full TinyLlama in f32 through the pipeline in 2 and 11 stages
    against the one-card train step."""
    import torch
    from repro_torch import configs
    from repro_torch.models import lm
    from repro_torch.optim import constant
    from repro_torch.train import make_train_step
    cfg = configs.get(ARCH)
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(13),
                            dev, torch.float32)
    batch = _device_batch(cfg, 256, 8, 13, dev)
    _, loss_fn = make_train_step(cfg, constant(0.0))
    t0 = time.perf_counter()
    one_loss, _, one_grads = _value_and_grad(loss_fn, params, batch)
    one_loss = one_loss.item()
    one_s = time.perf_counter() - t0
    for n_stages in PIPE_STAGES:
        devices = stage_devices(n_stages)
        loss, seconds, grads = _pipeline_grads(cfg, params, batch, devices,
                                               PIPE_MICRO)
        err = _leaf_err(grads, one_grads)
        row = {"arch": ARCH, "dtype": "float32", "n_layers": cfg.n_layers,
               "n_stages": n_stages, **_placement(devices),
               "n_microbatches": PIPE_MICRO, "batch": 8, "seq": 256,
               "loss_pipeline": loss, "loss_one_card": one_loss,
               "loss_rel_err": abs(loss - one_loss) / abs(one_loss),
               "max_leaf_err_over_leaf_max": err,
               "pipeline_grad_seconds": seconds,
               "one_card_grad_seconds": one_s}
        emit("pipeline_vs_one_card", **row)
        check(row["loss_rel_err"] <= 1e-5,
              f"pipeline ({n_stages} stages): loss {loss} vs {one_loss}")
        check(err <= 1e-4, f"pipeline ({n_stages} stages): a gradient leaf "
              f"is {err} of its max-abs off the one-card step's")
        del grads


def pipeline_card_vs_host(dev) -> None:
    """(b): mixtral cut to 2 layers in f32, 2 stages, on the card and on
    the host CPU from the same weights and batch."""
    import torch
    from repro_torch import configs
    from repro_torch.models import lm
    from repro_torch.tree import tree_map
    cfg = configs.get(MX_ARCH).replace(n_layers=2)
    card = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(14),
                          dev, torch.float32)
    host = tree_map(lambda t: t.cpu(), card)
    out = {}
    for where, params, devices in (
            ("card", card, stage_devices(2)),
            ("host", host, [torch.device("cpu")] * 2)):
        batch = _device_batch(cfg, 64, 4, 14, devices[0])
        loss, seconds, grads = _pipeline_grads(cfg, params, batch, devices,
                                               2, join=False)
        out[where] = loss, seconds, {k: g.cpu() for k, g in grads.items()}
        del grads
    (cl, cs, cg), (hl, hs, hg) = out["card"], out["host"]
    err = _leaf_err(cg, hg)
    row = {"arch": MX_ARCH, "dtype": "float32", "n_layers": 2,
           "of_layers": configs.get(MX_ARCH).n_layers, "n_stages": 2,
           **_placement(stage_devices(2)), "n_microbatches": 2, "batch": 4,
           "seq": 64, "params": sum(t.numel() for t in _leaves(host)),
           "loss_card": cl, "loss_host": hl,
           "loss_rel_err": abs(cl - hl) / abs(hl),
           "max_leaf_err_over_leaf_max": err, "card_grad_seconds": cs,
           "host_grad_seconds": hs}
    emit("pipeline_card_vs_host", **row)
    check(row["loss_rel_err"] <= 1e-5, f"{MX_ARCH} pipeline: loss {cl} on "
          f"the card vs {hl} on the host")
    check(err <= 1e-4, f"{MX_ARCH} pipeline: a gradient leaf is {err} of "
          "its max-abs off the host's")


def _median_step_ms(step_fn, params, opt, batch, devices, steps=3) -> tuple:
    """(median ms of ``steps`` train steps after one warm-up step, their
    losses); each step ends in a synchronise of every stage device."""
    times, losses = [], []
    for i in range(steps + 1):
        _sync(devices)
        t0 = time.perf_counter()
        params, opt, m = step_fn(params, opt, batch, i)
        loss = m["loss"].item()
        _sync(devices)
        if i:
            times.append((time.perf_counter() - t0) * 1e3)
            losses.append(loss)
    return sorted(times)[len(times) // 2], losses


def pipeline_timing(dev) -> None:
    """(c): bf16 TinyLlama train steps through the pipeline (2 stages) at
    M = 4 and 8 beside the one-card step at the same batch."""
    import torch
    from repro_torch import configs
    from repro_torch.models import lm
    from repro_torch.optim import constant, init_state
    from repro_torch.train import (make_pipeline_train_step, make_train_step,
                                   split_stage_params)
    from repro_torch.tree import tree_map
    cfg = configs.get(ARCH)
    batch_size, seq = 8, 512
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(15),
                            dev, torch.bfloat16)
    batch = _device_batch(cfg, seq, batch_size, 15, dev)
    devices = stage_devices(2)
    # every run steps its own copy, so all three start from these weights
    one = tree_map(torch.clone, params)
    torch.cuda.reset_peak_memory_stats()
    step_fn, _ = make_train_step(cfg, constant(1e-4))
    one_ms, one_losses = _median_step_ms(step_fn, one, init_state(one),
                                         batch, [dev])
    one_peak = torch.cuda.max_memory_allocated()
    del one
    rows = {}
    for micro in PIPE_TIMED_MICRO:
        split = split_stage_params(cfg, params, devices)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        step_fn, _ = make_pipeline_train_step(cfg, devices,
                                              n_microbatches=micro,
                                              lr_fn=constant(1e-4))
        ms, losses = _median_step_ms(step_fn, split, init_state(split),
                                     batch, devices)
        del split
        rows[micro] = {"median_step_ms": ms,
                       "tokens_per_s": batch_size * seq / ms * 1e3,
                       "peak_memory_bytes": torch.cuda.max_memory_allocated(),
                       "losses": losses}
    row = {"arch": ARCH, "dtype": "bfloat16", "batch": batch_size,
           "seq": seq, "n_stages": 2, **_placement(devices),
           "one_card": {"median_step_ms": one_ms,
                        "tokens_per_s": batch_size * seq / one_ms * 1e3,
                        "peak_memory_bytes": one_peak,
                        "losses": one_losses},
           "pipeline": rows,
           "clock": "host, each step ended by a synchronise",
           "note": ("stages on one card run the one-card step's work in M "
                    "microbatches one after another: the step time over "
                    "the one-card step's is the schedule's host cost, not "
                    "an overlap across cards")
           if len(set(devices)) == 1 else "stages on distinct cards"}
    emit("pipeline_timing", **row)
    finite = one_losses + [x for r in rows.values() for x in r["losses"]]
    check(all(abs(x) < float("inf") for x in finite),
          f"pipeline timing: a loss is not finite: {finite}")


def phase_pipeline(dev) -> None:
    """Phase pipeline, checks (a)-(c), with every launch counter zeroed
    before it and read after it."""
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    counters = launch_counters()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    pipeline_vs_one_card(dev)
    gc.collect()
    torch.cuda.empty_cache()
    pipeline_card_vs_host(dev)
    gc.collect()
    torch.cuda.empty_cache()
    pipeline_timing(dev)
    launches = {name: fn.launches for name, fn in counters.items()}
    emit("pipeline", seconds=time.perf_counter() - t0, launches=launches,
         cards=torch.cuda.device_count())
    check(not any(launches.values()),
          f"the pipeline launched kernels: {launches}")


def phase_train(dev) -> None:
    """Phase train, checks (a)-(e), with every launch counter zeroed
    before it and read after it."""
    import gc
    import os
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    counters = launch_counters()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    old = os.environ.get("REPRO_TORCH_PLAN_CACHE")
    with tempfile.TemporaryDirectory(prefix="train-plans-") as plans:
        os.environ["REPRO_TORCH_PLAN_CACHE"] = plans
        try:
            train_card_vs_host(dev)
            train_full_width(dev)
            train_grad_accum(dev)
            train_resume()
        finally:
            if old is None:
                del os.environ["REPRO_TORCH_PLAN_CACHE"]
            else:
                os.environ["REPRO_TORCH_PLAN_CACHE"] = old
    launches = {name: fn.launches for name, fn in counters.items()}
    emit("train", seconds=time.perf_counter() - t0, launches=launches)
    check(not any(launches.values()),
          f"training launched kernels: {launches}")


def main() -> int:
    try:
        import torch
    except ImportError as exc:
        print(f"chip_smoke: torch is not importable ({exc})", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        print(f"chip_smoke: the port is missing under {SRC}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    phase = "device"
    t_start = time.perf_counter()
    seconds: dict = {}

    def done(name: str, since: float) -> float:
        seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - since
        return time.perf_counter()

    try:
        smi = nvidia_smi()
        emit("device", nvidia_smi=smi, name=torch.cuda.get_device_name(0),
             count=torch.cuda.device_count(), torch=torch.__version__,
             cuda=torch.version.cuda, python=sys.version.split()[0])

        phase = "build"
        from repro_torch.kernels import _build
        t0 = time.perf_counter()
        built = _build.build_all()
        # per kernel: its (mangled) name, registers, stack and spills
        keep = ("Compiling entry function", "registers", "spill")
        logs = {name: [ln.strip() for ln in
                       (_build.BUILD_DIR / f"{name}.log").read_text()
                       .splitlines() if any(k in ln for k in keep)]
                for name in built}
        emit("build", seconds=time.perf_counter() - t0, built=built,
             nvcc=_build.nvcc(), ptxas=logs,
             tensor_core_instructions={name: mma_counts(name)
                                       for name in _build.SOURCES})

        t = done("device+build", t_start)
        phase = "kernels"
        errs = phase_kernels(dev)
        t = done("kernels", t)
        phase = "kernel_timing"
        measured = phase_kernel_timing(dev)
        t = done("kernel_timing", t)
        phase = "sampler"
        phase_sampler(dev)
        t = done("sampler", t)
        timing, timing_rg = measured[ARCH], measured[RG_ARCH]
        timing_ds, timing_vlm = measured[DS_ARCH], measured[VLM_ARCH]
        timing_cr = measured[CR_ARCH]
        timing.update(measured["scans"])
        # one path after the other, so that neither path's weights count
        # in the other's peak memory
        by_path = {}
        with tempfile.TemporaryDirectory(prefix="plans-") as plan_dir:
            from repro_torch.core import PlanCache
            cache = PlanCache(plan_dir)
            for arch, timing_phase in ((ARCH, phase_timing),
                                       (SSM_ARCH, phase_timing_ssm),
                                       (RG_ARCH, phase_timing_rg)):
                phase = "serve"
                served = phase_serve(dev, arch, cache)
                by_path[arch] = served["launches"]
                phase = "adapt"
                phase_adapt(served, cache)
                t = done("serve+adapt", t)
                phase = "serve_modes"
                for mode, counts in phase_serve_modes(dev, served).items():
                    by_path[f"{arch}/{mode}"] = counts
                t = done("serve_modes", t)
                phase = "sample_spec"
                for run, counts in phase_sample_spec(dev, served).items():
                    by_path[f"{arch}/{run}"] = counts
                t = done("sample_spec", t)
                phase = "prefix_router"
                for run, counts in phase_prefix_router(dev, served).items():
                    by_path[f"{arch}/prefix_router/{run}"] = counts
                t = done("prefix_router", t)
                phase = "timing"
                timing_phase(dev, served)
                t = done("timing", t)
            # the paper's own demo config, served once at its full size
            # (MHA: one query head per KV head) from its plan
            phase = "adapt"
            t0 = time.perf_counter()
            served = phase_serve(dev, MLP_ARCH, cache, label="adapt_serve")
            by_path[MLP_ARCH] = served["launches"]
            phase_adapt(served, cache)
            del served
            emit("adapt", arch=MLP_ARCH, seconds=time.perf_counter() - t0)
            t = done("serve+adapt", t)
            # deepseek-v2-lite (cut to DEPTH layers): MLA with the MoE FFN,
            # flash at q/k 192 and v 128; no sample_spec, and only run (a)
            # of prefix_router (the CPU tests cover the rest for this arch)
            phase = "serve"
            served = phase_serve(dev, DS_ARCH, cache)
            by_path[DS_ARCH] = served["launches"]
            phase = "adapt"
            phase_adapt(served, cache)
            phase = "serve_modes"
            for mode, counts in phase_serve_modes(dev, served).items():
                by_path[f"{DS_ARCH}/{mode}"] = counts
            phase = "prefix_router"
            for run, counts in phase_prefix_router(
                    dev, served, only=("whole",)).items():
                by_path[f"{DS_ARCH}/prefix_router/{run}"] = counts
            phase = "timing"
            phase_timing_fresh(dev, served)
            del served
            t = done(DS_ARCH, t)
            # the modality-frontend archs: phi-3-vision (576 projected
            # image rows ahead of each prompt, hd 96) and
            # seamless-m4t-medium (encoder, cross attention over static
            # cross block sets); their decode policies and fleets are left
            # to the CPU tests
            for arch in (VLM_ARCH, ED_ARCH):
                phase = "serve"
                served = phase_serve(dev, arch, cache)
                by_path[arch] = served["launches"]
                phase = "adapt"
                phase_adapt(served, cache)
                phase = "serve_modes"
                for mode, counts in phase_serve_modes(dev, served).items():
                    by_path[f"{arch}/{mode}"] = counts
                phase = "timing"
                phase_timing_fresh(dev, served)
                del served
                t = done(arch, t)
            # the rest of the registry: gemma2-9b (window rings beside
            # global tables, both softcaps) with its long request past the
            # window, minicpm-2b, and command-r-35b and mixtral-8x7b (their
            # f32 gates cut to DEPTH layers, their bf16 timing at
            # BF16_DEPTH); serve_modes for gemma2 only, and
            # their decode policies and fleets left to the CPU tests
            for arch in (GEMMA_ARCH, CPM_ARCH, CR_ARCH, MX_ARCH):
                phase = "serve"
                served = phase_serve(dev, arch, cache)
                by_path[arch] = served["launches"]
                phase = "adapt"
                phase_adapt(served, cache)
                if arch == GEMMA_ARCH:
                    phase = "serve_modes"
                    for mode, counts in phase_serve_modes(dev,
                                                          served).items():
                        by_path[f"{arch}/{mode}"] = counts
                    phase = "long_request"
                    by_path[f"{arch}/long_request"] = phase_long_request(
                        dev, served)
                else:
                    served.pop("small")
                phase = "timing"
                phase_timing_fresh(dev, served)
                del served
                t = done(arch, t)
        # each kernel's launches over the paths' runs, and by path
        launches = {name: sum(p[name] for p in by_path.values())
                    for name in launch_counters()}
        t = done("serve+adapt", t)
        phase = "train"
        phase_train(dev)
        t = done("train", t)
        phase = "pipeline"
        phase_pipeline(dev)
        done("pipeline", t)
        emit("wall", seconds=seconds,
             total_seconds=time.perf_counter() - t_start)
    except Exception as exc:  # report which phase failed, then fail
        traceback.print_exc()
        emit(phase, ok=False, error=f"{type(exc).__name__}: {exc}")
        return 1

    src = "src/repro_torch/kernels/{0}/{0}.cu"
    replaces = {
        "paged_attention":
            "src/repro/kernels/paged_attention/paged_attention.py:95",
        "flash_attention":
            "src/repro/kernels/flash_attention/flash_attention.py:90",
        "ssd_scan": "src/repro/kernels/ssd_scan/ssd_scan.py:82",
        "rglru_scan": "src/repro/kernels/rglru_scan/rglru_scan.py:53",
    }
    timed = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    device = ("device_ms", "library_device_ms")
    summary = []
    for name in ("paged_attention", "flash_attention", "ssd_scan",
                 "rglru_scan"):
        row = {"name": name, "route": "cuda", "source": src.format(name),
               "replaces": replaces[name], "launches": launches[name],
               "max_abs_err": errs[name],
               **{k: timing[name][k] for k in timed + device},
               "launches_by_path": {arch: counts[name] for arch, counts
                                    in by_path.items() if counts[name]},
               # the long shapes: context 4096 (paged), prompts of 2048
               "long": {k: timing[name + "_long"][k]
                        for k in timed + device}}
        if name in timing_rg:        # the attention kernels at hd 256
            row["hd256"] = {k: timing_rg[name][k] for k in timed + device}
            row["long_hd256"] = {k: timing_rg[name + "_long"][k]
                                 for k in timed + device}
        if name in timing_cr:        # the attention kernels at hd 128
            row["hd128"] = {k: timing_cr[name][k] for k in timed + device}
            row["long_hd128"] = {k: timing_cr[name + "_long"][k]
                                 for k in timed + device}
        if name in timing_vlm:       # the attention kernels at hd 96
            row["hd96"] = {k: timing_vlm[name][k] for k in timed + device}
            row["long_hd96"] = {k: timing_vlm[name + "_long"][k]
                                for k in timed + device}
        if name in timing_ds:        # flash at MLA's q/k 192, v 128
            row["dqk192_dv128"] = {k: timing_ds[name][k]
                                   for k in timed + device}
            row["long_dqk192_dv128"] = {k: timing_ds[name + "_long"][k]
                                        for k in timed + device}
        if name == "ssd_scan":       # the same work on the CUDA cores
            row["bound_ms_cuda_cores"] = timing[name]["bound_ms_cuda_cores"]
        summary.append(row)
    print(json.dumps({"kernels": summary}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
