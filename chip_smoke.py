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
   those tests' bars.  Attention (H=32, KV=4, hd=64, block 16): ragged
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
   for bit.
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
   a 2048-row prompt).
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
   way: n_layers SSD-scan launches per prefill, no attention launch, and
   no state slot left in use.  Then recurrentgemma-2b: its reduced model's
   window of 32 is shorter than the prompts, so window rings free blocks;
   at full width 18 RG-LRU-scan and 8 flash launches per prefill, 8 paged
   launches per decode step, no SSD launch, and no block, ring or state
   slot left in use.
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
6. serve_modes — after each path's ``serve``, the same trace (reduced
   model first) in the engine's two other modes, in f32, each request
   against phase ``serve``'s plain tokens under the same margin rule:
   bucketed paged lanes with 16-row chunked prefill (the README's serving
   example; n_ssd or n_rglru launches per chunk, i.e. 48 or 18 x the sum
   of ceil(len / 16) over the prompts, no flash launch since a chunk's
   attention is the plain gather, paged launches from the decode steps
   only) and bucketed dense lanes (flash per attention layer and prefill
   or lane decode step, no paged launch).
7. timing  — each trace in bf16: tokens/s, mean decode step and prefill,
   peak memory, the trace once more untraced in the chunked mode (tokens/s,
   mean decode and chunk step), and a repeat under ``torch.profiler``
   (device time by kernel name, the device's busy share, and each port
   kernel's device time per launch on the path, with the kernel functions
   it ran: mamba2's must be the SSD kernel's tensor-core body only).

Then the ``{"kernels": [...]}`` summary line (paged and flash attention at
TinyLlama's hd 64, with recurrentgemma's hd 256 beside them; every kernel
with its long shape; launches summed over every full-width run of phases
``serve``, ``serve_modes`` and ``adapt``, and by run), the card's ``name,
power.limit`` line, and last
``{"ok": true, "device": ...}``.  The build phase also counts each kernel
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
PLAN_DEVICES = 4        # modelled H100 SXM cards the serve plans are for
PROMPT_LENS = (17, 200, 45, 131, 77, 163, 29, 111)
MAX_NEW = 32
KV_LEN = 512
N_SLOTS = 4
BLOCK = 16
STAGGER = 2
MARGIN = 1e-3
PAGED = {"paged": True}
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


def flash_inputs(gen, dev, dtype, B, Sq, Skv, H, KV, hd):
    import torch
    q = torch.randn((B, Sq, H, hd), generator=gen, device=dev).to(dtype)
    k = torch.randn((B, Skv, KV, hd), generator=gen, device=dev).to(dtype)
    v = torch.randn((B, Skv, KV, hd), generator=gen, device=dev).to(dtype)
    return q, k, v


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
    ]
    # the split over the context: contexts of 1 row to 4096, one lane and
    # four, the wrapper's own n_split and forced ones (single-row lanes
    # leave most splits empty), and a window shorter than the context
    for hd, H, KV in ((64, 32, 4), (256, 10, 1)):
        for B, lens in ((1, [4096]), (1, [1]), (4, [1, 16, 17, 215]),
                        (4, [2048, 4096, 17, 1])):
            mb = -(-max(lens) // 16)
            for n_split in (None, 3, 16):
                paged_cases.append(
                    (f"split_hd{hd}_b{B}_ctx{max(lens)}_n{n_split or 'auto'}",
                     B, H, KV, hd, 16, mb, lens, 0, 0.0, n_split))
        for n_split in (None, 5):
            paged_cases.append(
                (f"split_hd{hd}_window1000_n{n_split or 'auto'}", 4, H, KV,
                 hd, 16, 256, [100, 2048, 4096, 17], 1000, 0.0, n_split))
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for (name, B, H, KV, hd, bs, mb, lens, win, cap,
             n_split) in paged_cases:
            q, kp, vp, tbl, ln = paged_inputs(gen, dev, dtype, B, H, KV, hd,
                                              bs, mb, lens)
            got = pa_ops.paged_attention(q, kp, vp, tbl, ln, window=win,
                                         logit_softcap=cap, n_split=n_split)
            torch.cuda.synchronize()
            exp = pa_ref.reference(q[:, None], kp, vp, tbl, ln,
                                   q_positions=(ln - 1)[:, None],
                                   window=win, logit_softcap=cap)[:, 0]
            err = (got.float() - exp.float()).abs().max().item()
            tol = TOL[("paged", dname)]
            rows.append({"kernel": "paged_attention", "case": name,
                         "dtype": dname, "max_abs_err": err, "tol": tol,
                         "ok": err < tol})
            if dname == "float32" and name.startswith(("main", "rg_",
                                                       "mlp_main")):
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
    ]
    # the tensor-core tiling: query lengths around and far past the 64-row
    # tile, causal and not, a window that cuts the prompt, a cached prefill
    # (Sq < Skv, -1 slots past the cache's fill) and a softcap
    for hd, H, KV in ((64, 32, 4), (256, 10, 1)):
        for Sq in (1, 63, 64, 65, 131, 200, 1024, 2048):
            for causal in (True, False):
                flash_cases.append(
                    (f"tile_sq{Sq}_hd{hd}_{'causal' if causal else 'full'}",
                     1, Sq, Sq, H, KV, hd, causal, 0, 0.0, None))
        flash_cases += [
            (f"tile_window48_hd{hd}", 1, 200, 200, H, KV, hd, True, 48, 0.0,
             None),
            (f"tile_cached_hd{hd}", 2, 37, 256, H, KV, hd, True, 0, 0.0,
             150),
            (f"tile_softcap_hd{hd}", 1, 131, 131, H, KV, hd, True, 0, 30.0,
             None),
        ]
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for (name, B, Sq, Skv, H, KV, hd, causal, win, cap,
             empty_from) in flash_cases:
            q, k, v = flash_inputs(gen, dev, dtype, B, Sq, Skv, H, KV, hd)
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
            exp = fa_ref.reference(q, k, v, q_positions=qpos,
                                   k_positions=kpos, causal=causal,
                                   window=win, logit_softcap=cap)
            err = (got.float() - exp.float()).abs().max().item()
            tol = TOL[("flash", dname)]
            rows.append({"kernel": "flash_attention", "case": name,
                         "dtype": dname, "max_abs_err": err, "tol": tol,
                         "ok": err < tol})
            if dname == "float32" and name.startswith(
                    ("prefill", "decode", "rg_", "mlp_prefill",
                     "mlp_decode")):
                main_err["flash_attention"] = max(
                    main_err["flash_attention"], err)
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

def make_prompts(cfg, dev, seed: int) -> list:
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randint(0, cfg.vocab_size, (n,), generator=gen,
                          device=dev).tolist() for n in PROMPT_LENS]


def serve_trace(cfg, params, prompts, dev, dtype, max_new=MAX_NEW,
                mode=PAGED, plan=None):
    """Serve ``prompts`` through the kernel engine in ``mode`` (the
    engine's options; the paged mode by default), sized by ``plan`` when
    given (then neither ``kv_len`` nor ``n_slots`` is passed), else at
    KV_LEN x N_SLOTS.  Returns (engine, results);
    ``engine.ring_blocks_freed`` counts the window-ring blocks that fell
    behind the window during the run."""
    from repro_torch.serve import ContinuousEngine
    sizing = ({"plan": plan} if plan is not None
              else {"kv_len": KV_LEN, "n_slots": N_SLOTS})
    eng = ContinuousEngine(cfg, params, block_size=BLOCK, impl="kernel",
                           dtype=dtype, device=dev, **sizing, **mode)
    eng.ring_blocks_freed = 0
    slide = eng.allocator.extend_window

    def counted_slide(slot, n_tokens_total, **kw):
        fresh, freed = slide(slot, n_tokens_total, **kw)
        eng.ring_blocks_freed += len(freed)
        return fresh, freed

    eng.allocator.extend_window = counted_slide
    for i, p in enumerate(prompts):
        eng.submit(p, max_new, rid=i, arrival=i * STAGGER)
    try:
        return eng, eng.run()
    finally:
        # the wrapper closes over the engine: drop it, so that no
        # reference cycle keeps the engine's weights on the card until the
        # garbage collector runs (they would count in the next path's peak
        # memory)
        del eng.allocator.extend_window


def plain_tokens(cfg, params, prompts, dev, dtype,
                 max_new=MAX_NEW) -> list:
    """Each request's tokens from the plain B=1 engine."""
    import torch
    from repro_torch.serve import Engine
    plain = Engine(cfg, params, kv_len=KV_LEN, dtype=dtype, impl="plain",
                   device=dev)
    return [plain.generate(torch.tensor([p], device=dev),
                           max_new)[0].tolist() for p in prompts]


def hold_against_plain(cfg, params, prompts, results, refs, dev,
                       max_new=MAX_NEW) -> list:
    """Per request: the kernel engine's tokens against the plain B=1
    engine's (``refs``).  Identical, or at the first divergence the plain
    path's top-two logit margin must be under MARGIN (a near tie that
    rounding may flip either way)."""
    import torch
    from repro_torch.models import lm
    rows = []
    for rid, (p, ref) in enumerate(zip(prompts, refs)):
        got = results[rid]
        check(len(got) == max_new, f"request {rid}: {len(got)} tokens")
        div = next((i for i, (a, b) in enumerate(zip(got, ref)) if a != b),
                   None)
        row = {"rid": rid, "prompt_len": len(p), "identical": div is None,
               "divergence_index": div, "margin": None}
        if div is not None:
            seq = torch.tensor([p + ref[:div]], device=dev)
            logits, _ = lm.forward(cfg, params, seq, mode="prefill",
                                   impl="plain")
            top2 = logits[0, -1, :cfg.vocab_size].float().topk(2).values
            row["margin"] = (top2[0] - top2[1]).item()
            row["ok"] = row["margin"] < MARGIN
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


def phase_serve(dev, arch: str, cache, label: str = "serve") -> dict:
    """One main path: the reduced model first, then ``arch`` at full width,
    its engine sized by the plan of its decode shape (compiled through the
    plan cache ``cache``), with every launch counter zeroed just before the
    run and read just after it.  ``label`` names the phase in the output."""
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

    cfg = configs.get(arch)
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    params = lm.init_params(cfg, gen, dev, torch.float32)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
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

    tel = eng.telemetry
    decode_steps = sum(1 for s in tel.steps if s.active_slots)
    prefills = sum(s.prefills for s in tel.steps)
    mixers = [s.mixer for s in cfg.layers()]
    n_attn = sum(1 for m in mixers if m in ("global", "local"))
    expect = {"paged_attention": n_attn * decode_steps,
              "flash_attention": n_attn * prefills,
              "ssd_scan": mixers.count("ssd") * prefills,
              "rglru_scan": mixers.count("rglru") * prefills}
    refs = plain_tokens(cfg, params, prompts, dev, torch.float32)
    rows = hold_against_plain(cfg, params, prompts, results, refs, dev)
    emit(label, arch=cfg.name, dtype="float32", params=n_params,
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
    recurrent layer and chunk, no flash launch (the chunk's attention is
    the plain gather), paged launches from the decode steps only.  Dense
    lanes: flash per attention layer and prefill or lane decode step, no
    paged launch, one scan launch per recurrent layer and prefill."""
    mixers = [s.mixer for s in cfg.layers()]
    n_attn = sum(1 for m in mixers if m in ("global", "local"))
    chunks = sum(s.prefill_chunks for s in tel.steps)
    prefills = sum(s.prefills for s in tel.steps)
    decode_steps = sum(1 for s in tel.steps if s.active_slots)
    lane_steps = sum(len(s.active_slots) for s in tel.steps)
    if mode.get("prefill_chunk"):
        return {"paged_attention": n_attn * decode_steps,
                "flash_attention": 0,
                "ssd_scan": mixers.count("ssd") * chunks,
                "rglru_scan": mixers.count("rglru") * chunks}
    return {"paged_attention": 0,
            "flash_attention": n_attn * (prefills + lane_steps),
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
            check(chunks == sum(-(-len(p) // C) for p in prompts),
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


def profile_serve(cfg, params, prompts, dev, untraced_wall: float) -> dict:
    """The same bf16 trace once more under ``torch.profiler``: device time
    by kernel name, the device's busy share of the traced and of the
    untraced wall time, and the tracing overhead."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        serve_trace(cfg, params, prompts, dev, torch.bfloat16)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    # kernel events only: the operator events that launched them carry
    # the same device time again
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and device_us(e) > 0]
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
        "device_busy_seconds": busy_us / 1e6,
        "device_busy_share_traced": busy_us / 1e6 / wall,
        # the kernels do the same work untraced, so this is the busy share
        # of the run that was timed without the profiler
        "device_busy_share_untraced": busy_us / 1e6 / untraced_wall,
        "top_kernels": [{"name": e.key[:80], "calls": e.count,
                         "device_ms": device_us(e) / 1e3} for e in top],
        "port_kernels": ours,
    }


def time_serve(dev, served: dict) -> tuple:
    """The path's trace in bf16 (the f32 weights of phase ``serve`` cast,
    the float32-only SSD leaves kept): tokens/s, mean decode step and
    prefill, peak memory, and a profiled repeat.  Returns (serve metrics,
    bf16 params)."""
    import torch
    from repro_torch.convert import F32_LEAVES

    cfg, prompts = served["cfg"], served["prompts"]

    def to_bf16(tree):
        return {k: to_bf16(v) if isinstance(v, dict)
                else v if k in F32_LEAVES else v.to(torch.bfloat16)
                for k, v in tree.items()}

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
    serve["profile"] = profile_serve(cfg, params, prompts, dev, wall)
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


def paged_timing(gen, dev, cfg, lens, max_blocks) -> dict:
    """The paged kernel in bf16 at ``cfg``'s heads and window, one decode
    step of lanes with contexts ``lens``, with the wrapper's own split."""
    import torch
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.paged_attention import ref as pa_ref
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    win = cfg.window_size
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
                  "window": win, "dtype": "bfloat16",
                  "n_split": pa_ops.choose_split(B, H, KV, max_blocks,
                                                 BLOCK, win, n_sm)},
        "ms": time_ms(lambda: pa_ops.paged_attention(q, kp, vp, tbl, ln,
                                                     window=win)),
        "device_ms": profiled_ms(lambda: pa_ops.paged_attention(
            q, kp, vp, tbl, ln, window=win)),
        "plain_ms": time_ms(lambda: pa_ref.reference(
            q[:, None], kp, vp, tbl, ln, q_positions=(ln - 1)[:, None],
            window=win)),
        "bytes": (2 * rows_used * KV * hd * 2 + 2 * q.numel() * 2
                  + sum(-(-n // BLOCK) for n in used) * 4 + B * 4),
        "flops": 4 * rows_used * H * hd,
        "library_ms": None, "library_device_ms": None,
    }
    row["shape"]["ctas"] = B * KV * row["shape"]["n_split"]
    return set_bound(row)


def flash_timing(gen, dev, cfg, S) -> dict:
    """The flash kernel in bf16 at ``cfg``'s heads and window, one causal
    S-row prompt, beside one ``scaled_dot_product_attention`` call (GQA
    heads expanded; the window as a mask where it cuts the prompt), both
    timed by CUDA events and by the profiler's device time."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    win = cfg.window_size
    q, k, v = flash_inputs(gen, dev, torch.bfloat16, 1, S, S, H, KV, hd)
    pos = torch.arange(S, dtype=torch.int32, device=dev)
    # visible (query, key) pairs only: causal, inside the window
    pairs = sum(min(i + 1, win) if win else i + 1 for i in range(S))
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    kt, vt = (x.repeat_interleave(H // KV, dim=1) for x in (kt, vt))
    sdpa = {"is_causal": True}
    if win and win < S:
        dist = pos[:, None] - pos[None, :]
        sdpa = {"attn_mask": (dist >= 0) & (dist < win)}

    def kernel():
        return fa_ops.flash_attention(q, k, v, q_positions=pos,
                                      k_positions=pos, window=win)

    def library():
        return F.scaled_dot_product_attention(qt, kt, vt, **sdpa)

    row = {
        "shape": {"B": 1, "Sq": S, "Skv": S, "H": H, "KV": KV, "hd": hd,
                  "causal": True, "window": win, "dtype": "bfloat16",
                  "grid": [-(-S // 64), H], "tile": "64 query rows x 64 keys,"
                  " one warpgroup"},
        "ms": time_ms(kernel),
        "device_ms": profiled_ms(kernel),
        "plain_ms": time_ms(lambda: fa_ref.reference(
            q, k, v, q_positions=pos, k_positions=pos, window=win)),
        "library_ms": time_ms(library),
        "library_device_ms": profiled_ms(library),
        "bytes": 2 * (2 * q.numel() + k.numel() + v.numel()),
        "flops": 4 * pairs * H * hd,
    }
    return set_bound(row)


def attention_timing(dev, cfg, seed: int) -> dict:
    """Both attention kernels at ``cfg``'s shapes in bf16: paged, one
    decode step of the trace's first four lanes 16 tokens in, and one lane
    4096 rows in; flash, the prefill of the trace's 131-row prompt, and a
    2048-row prompt (past the ~660-row ridge, where the tensor cores bound
    it)."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed)
    lens = [n + 16 for n in PROMPT_LENS[:N_SLOTS]]
    return {
        "paged_attention": paged_timing(gen, dev, cfg, lens,
                                        KV_LEN // BLOCK),
        "paged_attention_long": paged_timing(gen, dev, cfg, [4096],
                                             4096 // BLOCK),
        "flash_attention": flash_timing(gen, dev, cfg, PROMPT_LENS[3]),
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
    """Both attention kernels at TinyLlama's and recurrentgemma's shapes
    (``{arch: rows}``), and the scans at mamba2-370m's and
    recurrentgemma-2b's (``{"scans": rows}``), each at the trace's 131-row
    prompt and at a 2048-row one.  They run before any serve trace: the
    profiler's short sessions lose their kernel records after the long
    mamba2 trace has been profiled in the same process."""
    import torch
    from repro_torch import configs
    timing = {arch: attention_timing(dev, configs.get(arch), seed)
              for arch, seed in ((ARCH, 99), (RG_ARCH, 97))}
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
    """TinyLlama's path: the bf16 trace."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.paged_attention import ops as pa_ops

    cfg = served["cfg"]
    serve, params = time_serve(dev, served)
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

        phase = "kernels"
        errs = phase_kernels(dev)
        phase = "kernel_timing"
        measured = phase_kernel_timing(dev)
        timing, timing_rg = measured[ARCH], measured[RG_ARCH]
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
                phase = "serve_modes"
                for mode, counts in phase_serve_modes(dev, served).items():
                    by_path[f"{arch}/{mode}"] = counts
                phase = "timing"
                timing_phase(dev, served)
            # the paper's own demo config, served once at its full size
            # (MHA: one query head per KV head) from its plan
            phase = "adapt"
            t0 = time.perf_counter()
            served = phase_serve(dev, MLP_ARCH, cache, label="adapt_serve")
            by_path[MLP_ARCH] = served["launches"]
            phase_adapt(served, cache)
            del served
            emit("adapt", arch=MLP_ARCH, seconds=time.perf_counter() - t0)
        # each kernel's launches over the paths' runs, and by path
        launches = {name: sum(p[name] for p in by_path.values())
                    for name in launch_counters()}
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
