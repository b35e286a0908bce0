#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero):

1. device — the card's name and power limit (``nvidia-smi``);
2. build — every CUDA kernel of the port, from the sources in this
   checkout, one ``nvcc`` per source, all started together; then
   ``cuobjdump -sass`` counts the tensor-core instructions: HGMMA in every
   flash and LoRA wgmma kernel, HMMA in every bf16 BGMV instance and TF32
   HMMA in every 3xTF32 LoRA and flash instance must be > 0; a probe times
   ``mma.sync`` TF32 products in a register-only loop (the ceiling of the
   3xTF32 route's instruction); the ``-Xptxas -v`` report gives every
   ``dim_agg`` instance's registers, and a spill fails the run; the same
   report gives every 3xTF32 flash instance's registers and spills, and a
   spill at a value width up to 128 fails the run;
3. kernels — each kernel against its plain PyTorch version on the card at
   its path's shapes, with the stated tolerances, and timed with CUDA
   events (kernel, plain version, library yardstick) beside the card's
   bound for the same work: the BGMV kernels at the serving shapes, at
   the families phase's LoRA sites (``FAMILY_BGMV``: Mamba's ``in_proj``
   / ``out_proj``, Jamba's ``wq`` / ``wv``, DeepSeek-V2's ``wuq`` at
   decode and at a prefill chunk, and a rank's shards of ``in_proj``,
   ``out_proj`` and ``wuq`` at tensor-parallel degree 4, held to
   ``_hold``'s limits), and every
   compiled BGMV instance at small ragged shapes, the
   ``dim_agg`` kernels at the round's leaves on fedbench-100m and at the
   JAX package's benchmark shape ``K10_L64_r32_n4096`` in both layouts
   (with whether each ``dim_agg`` output equals its plain version bit for
   bit), the round's whole tree through ``fedilora_aggregate_tree``,
   ``fedbuff_aggregate_tree`` and ``fedilora_trimmed_tree`` (one launch
   each, timed beside one launch per leaf), and every compiled ``dim_agg``
   route at K from 1 to 32 and 40 and each ``dim_agg_trimmed`` instance
   (K = 1 .. 32) at small shapes (both layouts, views at an odd element
   offset, ties, NaN and ±Inf, clients that cover nothing; NaN positions
   equal);
4. ops — the ``repro_torch.kernels.ops`` path: ``fused_lora_matmul`` at
   LoRA sites of qwen2-0.5b and fedbench-100m, the JAX package's benchmark
   shapes and a ragged edge, and ``flash_attention`` at qwen2-0.5b's
   prefill, a gemma3-12b sliding-window layer and a non-causal ragged
   length (each in f32 and bf16), the benchmark shape ``B4_S2048_d64``
   (bf16) and the prefill in bf16 at an odd element offset; each once
   through ``ops`` with the launch counts set to 0 just before and read
   just after (one launch a case; every aligned bf16 case on the ``wgmma``
   route of its kernel, every f32 case and the offset bf16 case on
   ``tf32x3``), then each output against its plain
   version (f32 within 1e-4; bf16 within one rounding step more, and on
   the tensor-core flash route 2^-8 · plain(q, k, |v|) more for the
   probabilities rounded to bf16), the f32 prefill against
   ``multihead_attention``, kernel, plain version and library yardstick
   timed beside the bound (route, TFLOP/s, % of bound, blocks), and every
   compiled instance of both kernels (each rank width, dtype pairing and
   head width, rows with no valid key, bf16 shapes TMA refuses) checked at
   small shapes on its asserted route, and bf16 operands at an odd element
   offset (qwen2-0.5b's ``wq`` and a causal GQA attention), which the route
   functions send to ``"tf32x3"``;
5. serve — qwen2-0.5b at full width in bf16 (random weights from a seed),
   12 tenants of ranks 8/16/32/64 through an 8-slot adapter bank, 48
   requests with chunked prefill and ``lora_backend="grouped"``; every
   request must complete with its tokens, cold tenants must page in, and
   the BGMV wrapper's call count must equal 2 LoRA sites × 24 layers × the
   serve/prefill calls (each call launches two kernels); then a second,
   shorter run (16 requests of 16 tokens) under ``torch.profiler``: the
   device's busy share, the BGMV kernels' share of the device time, the
   largest device rows;
6. agreement — the same model in f32 serves 16 requests through the
   ``grouped`` and the ``gather`` backends: greedy tokens must be equal;
7. train — fedbench-100m at full width in f32 (random base weights from a
   seed), 10 clients with 60% missing modalities, 3 FediLoRA rounds of 4
   clients × 10 local AdamW steps through ``aggregator="fedilora_kernel"``,
   then ``evaluate_global(n=32)``: losses and BLEU/RSUM finite, one edited
   module per sampled client, one host sync per round after the first (the
   metrics fetch; ``torch.cuda.set_sync_debug_mode``, each sync's source
   recorded), and ``dim_agg`` launched once a round (one launch over the
   tree of 2 LoRA sites × A and B); one more round runs under
   ``torch.profiler``;
8. train agreement — two trainers from one seed, ``fedilora_kernel`` vs
   ``fedilora`` for 3 rounds, then ``fedilora_trimmed_kernel`` vs
   ``fedilora_trimmed`` (trim 0.25) for 2 rounds, each round from one
   shared starting state: the same cohorts, global adapters equal
   within atol 1e-5 + rtol 1e-4, and one kernel launch a round;
9. slo — the SLO scheduler over qwen2-0.5b at full width and depth (bf16,
   ``lora_backend="grouped"``): under a ``ManualClock``, interactive ahead
   of batch, EDF within a class, a ``reject`` burst, ``drop_lowest``,
   ``degrade``, an in-flight timeout cancelled at the step boundary and a
   retry, each with the assertions of ``tests/test_scheduler.py``
   (admission order, shed and timeout sets, statuses, attempts, the
   ``serving.shed`` / ``serving.timeout`` counts, one ``serve_step`` for
   the step that cancels); in f32 weights, a degraded response is a prefix
   of its unloaded tokens and a retried sampled request reproduces its
   tokens; then an overload burst of 64 requests under the real clock
   (per-class goodput, sheds, timeouts, latency and TTFT p50/p99), gated
   only on invariants: every request ends exactly once and no shed
   request held a slot.  BGMV must launch twice a LoRA site a layer for
   every serve/prefill call;
10. faults — fedbench-100m with one fault configuration (dropout,
    stragglers, NaN on the wire, one Byzantine client) through
    ``fedilora_trimmed_kernel`` (trim 0.25) and ``fedilora_clip_kernel``
    (clip 90), two rounds each, beside their plain aggregators under the
    same faults from one shared state: a finite global, ``health`` equal
    to what the host schedule drew, dropped clients' stored adapters
    unchanged bit for bit, one ``dim_agg_trimmed`` or ``dim_agg`` launch a
    round, kernel and plain globals within atol 1e-5 + rtol 1e-4, one host
    sync a round after the first; then a round in which every client drops
    leaves the global bit for bit;
11. timelines — fedbench-100m through ``fedilora_kernel``: 3
    ``run_round_pipelined`` calls and ``flush_rounds`` against 3
    ``run_round`` calls (the same records, globals within atol 1e-5 + rtol
    1e-4); ``run_round_reference`` against ``run_round`` (cohort and edits
    exact, loss within 1e-4, adapters within 5e-4); ``run_round_async``
    through ``fedbuff_kernel`` at zero delays against the synchronous round
    (2 ticks), then 6 ticks with delays, a buffer of 2 and the faults
    phase's faults: one ``dim_agg`` launch a merge, and merges, staleness
    and deferred stragglers as the reference's bookkeeping gives them.
    The walls of pipelined and blocking rounds and of the async ticks are
    printed as findings;
12. population — the paged client store on fedbench-100m: with a bank of
    4 slots at K = 10 (cohorts of 4 evict), 2 rounds, a pipelined round
    with its flush and a ``fedilora_trimmed_kernel`` round against the
    same calls on resident state from one initial state (cohorts, ranks
    and edits equal; losses and adapters within the round tolerances, the
    largest difference printed), one ``dim_agg`` or ``dim_agg_trimmed``
    launch a round, and the paged sweep's greedy tokens equal to the
    resident sweep's; then a hosted population of 10^5 clients aliasing 4
    synthetic shards, cohort and bank of 8, 3 rounds (round walls, device
    and host bytes, at most 8 rows resident and 24 clients materialised);
    then the spill tier (4 host slots): a spilled client reads back from
    its file as the resident trainer holds it;
13. flora — 2 FLoRA rounds: the base weights' change equals the dense
    delta computed in f64 from the clients' adapters within 1e-5
    relative, losses and ``evaluate_global`` finite, no aggregation kernel
    launched;
14. checkpoint — the faults phase's faults under ``run_round_async`` with
    delays 0-2 and a buffer of 2 on a paged trainer: a save with a cohort
    in flight is refused, a save after tick 1, 2 more ticks, and a fresh
    paged trainer loaded from the save runs the same 2 ticks (cohorts,
    fault draws, health, versions and numpy states equal; losses and
    adapters within the round tolerances);
15. eval_ref — ``evaluate_personalized(vmapped=False)`` against the
    sweep and ``generation_scores(cached=False)`` against the cached
    decode: tokens equal;
16. cli — ``python -m repro_torch.launch.train`` on fedbench-100m as a
    subprocess, then ``AdapterStore.from_checkpoint`` on its checkpoint;
17. families — the Mamba-2, hybrid Jamba and MLA + MoE stacks at their
    published widths in bf16 (mamba2-130m whole; jamba-v0.1-52b cut to
    one pattern period of 8 layers, 13.3 B parameters; deepseek-v2-236b
    cut to 2 layers, 9 B parameters; the cuts are printed and recorded):
    24 requests of 6 tenants through a 4-slot bank with
    ``lora_backend="grouped"``, streamed prefill on the Mamba stacks and
    chunks of 32 on DeepSeek-V2; every request completes, cold tenants
    page in, and BGMV runs once a banked LoRA site a block for every
    serve/prefill call (2 a Mamba or attention sublayer, 1 an MLA one,
    whose ``wkv_b`` folds); a short profiled run (device busy share); then
    in f32 at an MoE capacity factor of max(8, experts / top-k), at which
    no pick drops (the bf16 weights freed first):
    ``decode_step`` streamed with an adapter against ``forward`` at every
    prompt position, past the SSD chunk on the Mamba stacks, within
    ``FAMILY_DECODE_ATOL`` (on mamba2-130m at LoRA scale 2.0 as well), and
    grouped == gather greedy tokens;
18. vision — llama-3.2-vision-11b at its published widths and depth (40
    layers, 8 gated cross layers, 9.8 B parameters) in bf16, every gate
    opened to 1.0, under the train phase's protocol with images of 64
    patches: 2 ``fedilora_kernel`` rounds and 1
    ``fedilora_trimmed_kernel`` round (finite losses, a nonzero B on
    every cross layer, one ``dim_agg`` / ``dim_agg_trimmed`` launch a
    round, both kernels against their plain versions on the round's
    whole tree and timed there), a profiled round,
    ``evaluate_global(n=32)`` and the uncached decode on the same rows
    (in bf16 the tokens that differ are counted; over the weights cast to
    f32 the tokens must be equal); then in f32, an
    adapter on every site: decode ≡ forward within
    ``FAMILY_DECODE_ATOL`` on the VLM cut to 10 layers with 1600 vision
    tokens (a 2688-position prompt: the forward's cross layers chunked)
    and on seamless-m4t-medium uncut; a bf16 ``loss_fn`` on
    seamless-m4t-medium with finite, nonzero gradients on its encoder
    and decoder cross-attention adapters;
19. mesh — the port's meshes over NCCL, in processes spawned with
    ``torch.multiprocessing`` (a rendezvous file under ``build/``), every
    launch of BGMV, ``dim_agg`` and ``dim_agg_trimmed`` in them held
    against its plain version on the same inputs as it runs.  On one card
    (world size 1, every mesh code path): fedbench-100m as the train phase
    sets it up, 2 ``fedilora_kernel`` rounds and 1
    ``fedilora_trimmed_kernel`` round on a ``(1,)`` client mesh and a
    ``(1, 1)`` (client, model) mesh, each bit for bit the unmeshed rounds
    from the same state (records, global and stacked adapters) with one
    kernel launch a round; qwen2-0.5b in bf16 (grouped) on a ``("data",)``
    and a ``("data", "model")`` mesh, tokens equal to the unmeshed
    engine's; the collective counts printed.  With 4 cards or more, also a
    2x2 round (4 ranks) and on 2 ranks a client mesh with n_sample 3 (the
    cohort padded to 4, the trimmed kernel at K = 4 with a client that
    covers nothing), a 2-slot serving mesh and a tensor-parallel serving
    mesh (in f32: GEMMs over fewer rows or columns round bf16 otherwise,
    and a near tie can flip a greedy token),
    each against the unmeshed run: cohorts, edits and ranks exact, losses
    within 1e-4, adapters as ``tests/test_torch_mesh_round.py`` holds
    them, tokens equal.  A line says whether that part ran.
20. mesh_families — the same meshes on the Mamba-2, hybrid Jamba, MLA +
    MoE and cross VLM stacks at published widths (``MESH_FAMILIES``),
    tensor-parallel by ``repro_torch.models.tensor_parallel``'s plan for
    each family, every BGMV / ``dim_agg`` / ``dim_agg_trimmed`` launch
    held as it runs.  On one card, bf16: 2 ``fedilora_kernel`` and 1
    ``fedilora_trimmed_kernel`` rounds (2 of 10 clients a round, 3 local
    steps) of mamba2-130m, Jamba cut to 8 layers, DeepSeek-V2 cut to 2
    and llama-3.2-vision cut to 10 (gates opened) on a ``(1, 1)`` (client,
    model) mesh, and ``(1, 1)`` ``("data", "model")`` engines on the first
    three, each bit for bit the unmeshed run from the same weights.  With
    4 cards or more, also a 2x2 round and a 1x4 engine in f32 against the
    unmeshed f32 run on each rank, and jamba-v0.1-52b uncut (32 layers,
    49.37 B parameters) in bf16 on a (1, 4) engine, each rank drawing only
    its pieces: peak memory per rank, tokens/s, and f32 decode against
    the same mesh's forward.  A line says which parts ran.
21. analysis — the dry run's tooling held against the card: the measured
    bf16 matmul rate (8192^3) and 2 GiB copy rate beside the data-sheet
    peaks of ``repro_torch.launch.roofline``; the dry-run CLI on
    qwen2-0.5b (every shape, 16x16 on a fake process group) and the
    fedbench-100m round, as subprocesses that must exit 0 and leave
    records; four steps at world size 1 with bf16 weights
    (``ANALYSIS_STEPS``: a qwen2-0.5b train step with 2 microbatches and
    remat, a prefill at S 4096, a serve step over a 4096-position cache;
    ``ANALYSIS_ROUND``: fedbench-100m's ``make_fed_round_step``), each
    traced at its sizes by the dry run's tracer and run for real: the real
    ``FlopCounterMode`` count equal to the trace's, the real peak within
    15 % of the predicted one, the CUDA-event time printed beside the
    analytic and the traced roofline times; ``fedilora_kernel`` against
    ``fedilora`` from the same state within atol 1e-5 + rtol 1e-4 with one
    ``dim_agg`` launch; with 4 cards or more a 2x2 round whose collective
    counts and bytes equal a fake-process-group trace's, and a 256 MiB
    NCCL all-reduce's bus bandwidth.
22. placements — the production steps' placements (FSDP over
    ``"data"``, replicated K/V heads, ``ep``, ``sp``, ``ep_sp``, ``seq``,
    ``scoreshard``): each mode on a (1, 1) ``("data", "model")`` mesh over
    NCCL equal to the unmeshed step bit for bit (``PLACEMENT_RUNS``:
    qwen2-0.5b uncut train / prefill / serve under every mode, Jamba-8
    under ``ep`` and ``ep_sp``, DeepSeek-V2-2's decode under
    ``scoreshard`` and ``seq_scoreshard``, bf16); with 4 cards or more
    every mode on a 2x2 mesh in f32 against the baseline placement; and
    the dry run's records of ``PLACEMENT_SWEEP`` (the pairs each mode
    changes, on a fake 16x16 process group), traced on the host's cores
    from the start of the run.
23. examples — the port's six examples (``repro_torch.examples``), each
    ``main`` in this process at its defaults (``federated_finetune`` at
    ``--rounds 2``: fedbench-100m at full width, both methods, 10 local
    steps, batch 8): finite losses, BLEU and RSUM; ``serve_decode``'s
    decode within 2e-3 of the forward and ``serve_multitenant``'s engine
    tokens equal to the single-tenant decode (each example raises
    otherwise); the records' shapes; a line with each example's wall.
    The examples keep the reference's routes (``fedilora``, ``hetlora``,
    ``fedbuff``, the engine's ``"gather"``), so no kernel launches there.

Each path that runs a kernel (ops: ``lora_matmul`` and ``flash_attention``;
serve, slo and families: BGMV; train, faults, timelines, population,
checkpoint, vision and analysis: ``dim_agg``; the trimmed runs and vision:
``dim_agg_trimmed``; mesh and mesh_families: all three) is driven
with the launch counts set to 0 just before it and read just after; a
kernel that its path never launched fails the run.  It prints a JSON
line describing every kernel, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
rest of the repository beside it, it fails and prints no result.  A full
record (every kernel case, the compiler's register and shared-memory
report, the SASS counts, the serve counters and profile, each phase's
wall) goes to ``build/chip_smoke.json``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

KERNEL_SHAPES = [(16, 896, 896), (16, 896, 128), (512, 896, 896),
                 (512, 896, 128),
                 # qwen2-0.5b's wq / wv columns at tensor-parallel degree 2
                 (16, 896, 448), (16, 896, 64)]
N_TENANTS, RANKS, BANK_SLOTS = 12, (8, 16, 32, 64), 8
KERNEL_SOURCES = ("grouped_lora_matmul", "dim_agg", "lora_matmul",
                  "lora_matmul_wgmma", "flash_attention",
                  "flash_attention_wgmma")
# every compiled BGMV instance at small ragged shapes (checked, not timed):
# (M, K, N, r) over each pairing of x/W and bank types; M <= 64 takes the
# decode tiling, M > 64 the prefill tiling; K or N not a multiple of 8
# stages by plain loads, and ranks go up to 128
WIDTH_BGMV = [(13, 200, 150, 8), (7, 96, 40, 128), (40, 896, 896, 64),
              (100, 200, 150, 24), (130, 152, 96, 40), (70, 896, 896, 128)]
# BGMV at the LoRA sites the families phase serves: (site, M, K, N), M = 16
# slots at decode and 16 x 32 at DeepSeek-V2's chunked prefill; bf16 x/W
# over the serve path's f32 bank (G 8, r 64), held to ``_hold``'s limits
FAMILY_BGMV = [("mamba2-130m.in_proj", 16, 768, 3352),
               ("mamba2-130m.out_proj", 16, 1536, 768),
               ("jamba-v0.1-52b.in_proj", 16, 4096, 16768),
               ("jamba-v0.1-52b.out_proj", 16, 8192, 4096),
               ("jamba-v0.1-52b.wq", 16, 4096, 4096),
               ("jamba-v0.1-52b.wv", 16, 4096, 1024),
               ("deepseek-v2-236b.wuq", 16, 1536, 24576),
               ("deepseek-v2-236b.wuq.prefill", 512, 1536, 24576),
               # a rank's shard at tensor-parallel degree 4 (the
               # mesh_families phase's (1, 4) engines): in_proj cut
               # segment by segment (z, xs and dt by heads beside the
               # whole B / C), out_proj's rows (K cut), wuq by heads
               ("mamba2-130m.in_proj.tp4", 16, 768, 1030),
               ("jamba-v0.1-52b.in_proj.tp4", 16, 4096, 4384),
               ("jamba-v0.1-52b.out_proj.tp4", 16, 2048, 4096),
               ("deepseek-v2-236b.wuq.tp4", 16, 1536, 6144)]

# the round's stacked leaves on fedbench-100m (K = 4 sampled clients,
# 12 layers, r_g = 32): (name, [K, L, P, Q], rank axis), then the JAX
# package's benchmark shape K10_L64_r32_n4096
DIM_AGG_SHAPES = [("wq.A", (4, 12, 32, 768), 2), ("wq.B", (4, 12, 768, 32), 3),
                  ("wv.B", (4, 12, 256, 32), 3),
                  ("K10_L64_r32_n4096", (10, 64, 32, 4096), 2),
                  ("K10_L64_n4096_r32.B", (10, 64, 4096, 32), 3)]
# the round's global rank: the tree cases reduce fedbench-100m's four
# leaves (wq.A, wq.B, wv.A, wv.B) of K = 4 clients in one launch
ROUND_RANK = 32
# dim_agg's routes at these K (the trimmed mean at every compiled K), checked
# and not timed, at (label, (L, P, Q), rank axis, at element offset 1): both
# layouts on the vector route, Q (A) or r (B) not a multiple of 4, and
# contiguous views at an odd element offset, on the scalar route
INSTANCE_KS = (1, 2, 3, 4, 5, 8, 10, 16, 17, 31, 32)
INSTANCE_SHAPES = [("A", (2, 8, 40), 2, False),
                   ("A.q37", (2, 8, 37), 2, False),
                   ("B", (2, 40, 8), 3, False),
                   ("B.r6", (2, 37, 6), 3, False),
                   ("A.offset1", (2, 8, 40), 2, True),
                   ("B.offset1", (2, 40, 8), 3, True)]
TRAIN_ROUNDS, TRAIN_RANKS = 3, (4, 8, 8, 12, 12, 16, 16, 24, 32, 32)
SERVE_PROFILE_REQUESTS = 16

# the ops path (``repro_torch.kernels.ops``): fused LoRA projections
# (name, M, K, N, r) at LoRA sites of supported models, the JAX package's
# kernel-benchmark shapes and a ragged edge, each in f32 and bf16
LORA_CASES = [("qwen2-0.5b.wq", 2048, 896, 896, 64),
              ("qwen2-0.5b.wv", 2048, 896, 128, 64),
              # batch 8 x (32 text + 8 vision-prefix tokens)
              ("fedbench-100m.wq", 320, 768, 768, 32),
              ("2048x2048x2048_r32", 2048, 2048, 2048, 32),
              ("4096x4096x1024_r16", 4096, 4096, 1024, 16),
              ("ragged", 300, 512, 640, 16)]
# attention: (name, (B, Sq, Sk, H, KV, d, dv), causal, window, dtypes)
FLASH_CASES = [("qwen2-0.5b.prefill", (2, 2048, 2048, 14, 2, 64, 64), True, 0,
                ("bfloat16", "float32")),
               ("gemma3-12b.local", (1, 4096, 4096, 16, 8, 256, 256), True,
                1024, ("bfloat16", "float32")),
               ("B4_S2048_d64", (4, 2048, 2048, 1, 1, 64, 64), True, 0,
                ("bfloat16",)),
               ("noncausal_ragged", (1, 1000, 1000, 14, 2, 64, 64), False, 0,
                ("bfloat16", "float32"))]
# the prefill in bf16 with q, k and v at element offset 1, bases TMA
# refuses: what a misaligned caller runs, on the tf32x3 route
FLASH_OFFSET_CASES = [("qwen2-0.5b.prefill.offset1",
                       (2, 2048, 2048, 14, 2, 64, 64), True, 0)]
# every compiled instance of the two kernels at a small ragged shape (checked,
# not timed): the LoRA kernels at r = 8, 24, 40, 128, every instance of the
# tf32x3 route (r <= 32, 64, 128) and the wgmma route's R = 8, 32, 64, 128
# (R = 16 runs in the ops cases at r = 16): N = 150 at each pairing of x/W
# and A/B types takes tf32x3 (bf16 too, whose row stride of 300 bytes TMA
# refuses), N = 152 in bf16 takes wgmma with ragged M and K and ranks past
# r zero-filled; flash in f32 (the tf32x3
# route) and bf16 (the wgmma route) at value widths of each instance of both
# (dv <= 32, 64, 128, 192, 256), d = 72 (padded to 80 in shared memory), MLA's
# d 192 with dv 128, Sq != Sk, a window without the causal mask, and rows
# that see no key at all (query positions >= Sk + window - 1)
WIDTH_LORA = [(130, 200, 150, r) for r in (8, 24, 40, 128)]
WIDTH_LORA_WGMMA = [(130, 200, 152, r) for r in (8, 24, 40, 128)]
WIDTH_FLASH = [("d32", (2, 300, 300, 4, 2, 32, 32), True, 0),
               ("d72.noncausal_ragged", (1, 300, 260, 6, 3, 72, 72), False, 0),
               ("d128.window", (1, 256, 256, 4, 1, 128, 128), True, 64),
               ("d192_dv128.noncausal_window", (1, 200, 333, 4, 4, 192, 128),
                False, 50),
               ("keyless_rows", (1, 400, 150, 4, 2, 64, 64), True, 100),
               ("d64_dv192.noncausal", (1, 130, 140, 4, 2, 64, 192), False,
                0),
               ("d256.window", (2, 300, 200, 2, 1, 256, 256), True, 100)]
# bf16 whose strides TMA refuses (d * 2 = 72 bytes): the tf32x3 route
FLASH_TF32X3_BF16 = [("d36.tma_refused", (1, 200, 200, 1, 1, 36, 36), True,
                      0)]
# bf16 q, k, v at an odd element offset (bases TMA refuses), causal GQA:
# the tf32x3 route; the LoRA case is qwen2-0.5b's wq at an offset
OFFSET_FLASH = (1, 300, 300, 4, 2, 64, 64)
# the limits against the plain version, on every route: f32 outputs within
# 1e-4 (sums over K <= 4096 or Sk <= 4096 in another order, inputs scaled as
# the reference's kernel tests scale them); a bf16 output is the same f32
# value rounded once, so it may sit one bf16 step (2^-7 of its magnitude)
# from the plain version's, beside the f32 difference.  On the tensor-core
# flash route the probabilities are rounded to bf16 before P.V (a relative
# error of 2^-9 on each p), so an output also moves by up to
# 2^-9 sum_j p_j |v_j| / l: it is held to 2^-8 (twice that) times the plain
# version on |v|
F32_ATOL, BF16_RTOL, P_BF16_RTOL = 1e-4, 2.0 ** -7, 2.0 ** -8


def cuda_time_ms(fn, arg_sets, iters: int = 60, warmup: int = 5) -> float:
    """Mean device ms per call over ``iters`` calls cycling through
    ``arg_sets`` (enough distinct weights that each call finds them outside
    L2, as a decode step over 24 layers does).  A sleep kernel holds the
    stream while the host enqueues every call, so the events time the
    device and not the host's launch rate."""
    import torch
    for i in range(warmup):
        fn(*arg_sets[i % len(arg_sets)])
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)         # ~50 ms at the H100's clocks
    t0.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def _bound(nbytes: int, ops: int, bw: float, peak: float) -> dict:
    """The least time for the work: its bytes over the memory rate, or its
    operations over the peak rate of their type, whichever is larger."""
    t_bytes, t_ops = nbytes / bw * 1e3, ops / peak * 1e3
    return {"bytes": nbytes, "ops": ops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def phase_kernels(dev_name: str) -> dict:
    """grouped_lora_matmul vs its plain version at the serving shapes, then
    every compiled instance at the ``WIDTH_BGMV`` shapes."""
    import torch

    from repro_torch.kernels import grouped_lora_matmul as glm
    from repro_torch.kernels.ref import grouped_lora_matmul_ref

    from repro_torch.launch.roofline import peaks_for
    bw, peak_bf16, peak_f32 = peaks_for(dev_name)
    gen = torch.Generator(device="cuda").manual_seed(0)
    G, r, scale = 8, 64, 0.25
    pairings = [(torch.float32, torch.float32),
                (torch.bfloat16, torch.bfloat16),
                (torch.bfloat16, torch.float32),
                (torch.float32, torch.bfloat16)]
    cases = []
    # x/W dtype, bank dtype: f32; bf16; and the serve path's bf16 model
    # over an f32 bank
    for xdt, adt in pairings[:3]:
        for M, K, N in KERNEL_SHAPES:
            sx = torch.finfo(xdt).bits // 8
            sa = torch.finfo(adt).bits // 8
            n_sets = max(2, int(120e6 // (K * N * sx + G * r * (K + N) * sa)))
            sets = []
            for _ in range(n_sets):
                w = (torch.randn(K, N, generator=gen, device="cuda")
                     * K ** -0.5).to(xdt)
                a = (torch.randn(G, r, K, generator=gen, device="cuda")
                     * K ** -0.5).to(adt)
                b = (torch.randn(G, N, r, generator=gen, device="cuda")
                     * r ** -0.5).to(adt)
                sets.append((w, a, b))
            x = torch.randn(M, K, generator=gen, device="cuda").to(xdt)
            # idx with repeats: rows cycle over 6 of the 8 bank slots
            idx = (torch.arange(M, device="cuda", dtype=torch.int32) * 5) % 6
            w, a, b = sets[0]
            y = glm.grouped_lora_matmul_cuda(x, w, a, b, idx, scale=scale)
            torch.cuda.synchronize()
            ref = grouped_lora_matmul_ref(x.float(), w.float(), a.float(),
                                          b.float(), idx, scale=scale)
            err = (y.float() - ref).abs()
            tol = 1e-4 if xdt == adt == torch.float32 else 2e-2
            if not bool((err <= tol + tol * ref.abs()).all()):
                raise AssertionError(
                    f"grouped_lora_matmul {M}x{K}x{N} {xdt}/{adt}: max err "
                    f"{err.max().item():.3e} beyond atol=rtol={tol}")
            kernel_ms = cuda_time_ms(
                lambda w, a, b: glm.grouped_lora_matmul_cuda(
                    x, w, a, b, idx, scale=scale), sets)
            plain_ms = cuda_time_ms(
                lambda w, a, b: grouped_lora_matmul_ref(x, w, a, b, idx,
                                                        scale=scale), sets)
            library_ms = cuda_time_ms(lambda w, a, b: torch.matmul(x, w), sets)
            n_adapters = len(set(idx.tolist()))
            nbytes = (K * N * sx + M * K * sx + M * N * sx
                      + n_adapters * r * (K + N) * sa + M * 4)
            ops = 2 * M * K * N + 2 * M * r * (K + N)
            peak = peak_bf16 if xdt == torch.bfloat16 else peak_f32
            cases.append({
                "M": M, "K": K, "N": N, "G": G, "r": r,
                "x_dtype": str(xdt).split(".")[-1],
                "bank_dtype": str(adt).split(".")[-1],
                "max_abs_err": err.max().item(), "tol": tol,
                "ms": kernel_ms, "plain_ms": plain_ms,
                "library_ms": library_ms, **_bound(nbytes, ops, bw, peak)})
            cases[-1]["pct_of_bound"] = 100 * cases[-1]["bound_ms"] / kernel_ms
            print(f"kernel grouped_lora_matmul M={M} K={K} N={N} "
                  f"{cases[-1]['x_dtype']}/{cases[-1]['bank_dtype']}: "
                  f"err {cases[-1]['max_abs_err']:.3e} kernel {kernel_ms:.4f} "
                  f"ms plain {plain_ms:.4f} ms matmul {library_ms:.4f} ms "
                  f"bound {cases[-1]['bound_ms']:.4f} ms "
                  f"({cases[-1]['bound_by']}, "
                  f"{cases[-1]['pct_of_bound']:.1f} %)", flush=True)
    family = [_family_bgmv_case(gen, site, M, K, N, G, r, scale, bw,
                                peak_bf16) for site, M, K, N in FAMILY_BGMV]
    # every compiled instance (pairing x tiling) at small ragged shapes, with
    # indices outside [0, G) that the kernels clamp
    widths = []
    for M, K, N, r in WIDTH_BGMV:
        for xdt, adt in pairings:
            x = torch.randn(M, K, generator=gen, device="cuda").to(xdt)
            w = (torch.randn(K, N, generator=gen, device="cuda")
                 * K ** -0.5).to(xdt)
            a = (torch.randn(G, r, K, generator=gen, device="cuda")
                 * K ** -0.5).to(adt)
            b = (torch.randn(G, N, r, generator=gen, device="cuda")
                 * r ** -0.5).to(adt)
            idx = (torch.arange(M, device="cuda", dtype=torch.int32) * 3
                   % (G + 2) - 1)
            y = glm.grouped_lora_matmul_cuda(x, w, a, b, idx, scale=scale)
            ref = grouped_lora_matmul_ref(x.float(), w.float(), a.float(),
                                          b.float(), idx.clamp(0, G - 1),
                                          scale=scale)
            err = (y.float() - ref).abs()
            tol = 1e-4 if xdt == adt == torch.float32 else 2e-2
            what = f"grouped_lora_matmul {M}x{K}x{N} r{r} {xdt}/{adt}"
            if not bool((err <= tol + tol * ref.abs()).all()):
                raise AssertionError(f"{what}: max err "
                                     f"{err.max().item():.3e} beyond "
                                     f"atol=rtol={tol}")
            widths.append({"case": what, "max_abs_err": err.max().item()})
    print(f"kernel widths: {len(widths)} BGMV instances and shapes within "
          f"their limits, max err "
          f"{max(c['max_abs_err'] for c in widths):.3e}", flush=True)
    return {"cases": cases, "family_cases": family, "widths": widths}


def _family_bgmv_case(gen, site: str, M: int, K: int, N: int, G: int, r: int,
                      scale: float, bw: float, peak: float) -> dict:
    """One BGMV call at a families-phase site (bf16 x/W, f32 bank) against
    its plain version within ``_hold``'s limits, then timed beside the
    plain version, ``torch.matmul(x, W)`` and the bound."""
    import torch

    from repro_torch.kernels import grouped_lora_matmul as glm
    from repro_torch.kernels.ref import grouped_lora_matmul_ref

    n_sets = max(2, int(120e6 // (K * N * 2 + G * r * (K + N) * 4)))
    sets = [((torch.randn(K, N, generator=gen, device="cuda")
              * K ** -0.5).to(torch.bfloat16),
             torch.randn(G, r, K, generator=gen, device="cuda") * K ** -0.5,
             torch.randn(G, N, r, generator=gen, device="cuda") * r ** -0.5)
            for _ in range(n_sets)]
    x = torch.randn(M, K, generator=gen, device="cuda").to(torch.bfloat16)
    idx = (torch.arange(M, device="cuda", dtype=torch.int32) * 5) % 6
    w, a, b = sets[0]
    y = glm.grouped_lora_matmul_cuda(x, w, a, b, idx, scale=scale)
    err = _hold(f"grouped_lora_matmul {site} {M}x{K}x{N}", y,
                grouped_lora_matmul_ref(x, w, a, b, idx, scale=scale))
    kernel_ms = cuda_time_ms(lambda w, a, b: glm.grouped_lora_matmul_cuda(
        x, w, a, b, idx, scale=scale), sets)
    plain_ms = cuda_time_ms(lambda w, a, b: grouped_lora_matmul_ref(
        x, w, a, b, idx, scale=scale), sets)
    library_ms = cuda_time_ms(lambda w, a, b: torch.matmul(x, w), sets)
    n_adapters = len(set(idx.tolist()))
    nbytes = (K * N * 2 + M * K * 2 + M * N * 2
              + n_adapters * r * (K + N) * 4 + M * 4)
    ops = 2 * M * K * N + 2 * M * r * (K + N)
    case = {"site": site, "M": M, "K": K, "N": N, "G": G, "r": r,
            "x_dtype": "bfloat16", "bank_dtype": "float32",
            "max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, **_bound(nbytes, ops, bw, peak)}
    case["pct_of_bound"] = 100 * case["bound_ms"] / kernel_ms
    print(f"kernel grouped_lora_matmul {site} M={M} K={K} N={N}: err "
          f"{err:.3e} kernel {kernel_ms:.4f} ms plain {plain_ms:.4f} ms "
          f"matmul {library_ms:.4f} ms bound {case['bound_ms']:.4f} ms "
          f"({case['bound_by']}, {case['pct_of_bound']:.1f} %)", flush=True)
    return case


def _offset_view(t, offset: int = 1):
    """t's values in a contiguous view ``offset`` elements into a buffer of
    its own: a base 16-byte vectors and TMA refuse."""
    import torch
    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    view = buf[offset:].view(t.shape)
    view.copy_(t)
    return view


def _hold_agg(what: str, y, ref) -> dict:
    """An aggregation output against its plain version: NaN where the plain
    version has NaN, the same infinities, every finite value within atol
    1e-6 + rtol 1e-5 (f32 sums of K terms in another order: a few ulp of
    the terms); and whether the two are equal bit for bit."""
    import torch
    if y.shape != ref.shape:
        raise AssertionError(f"{what}: shape {tuple(y.shape)}, plain "
                             f"{tuple(ref.shape)}")
    nan = torch.isnan(ref)
    if not torch.equal(torch.isnan(y), nan):
        raise AssertionError(f"{what}: NaN at other positions than the "
                             "plain version's")
    inf = torch.isinf(ref)
    if not torch.equal(y[inf], ref[inf]):
        raise AssertionError(f"{what}: infinities differ")
    fin = ~(nan | inf)
    err = (y[fin] - ref[fin]).abs()
    if not bool((err <= 1e-6 + 1e-5 * ref[fin].abs()).all()):
        raise AssertionError(f"{what}: max err {err.max().item():.3e} beyond "
                             "atol 1e-6 + rtol 1e-5")
    same = bool(torch.equal(y[fin], ref[fin]) and torch.equal(
        torch.signbit(y[fin]), torch.signbit(ref[fin])))
    return {"case": what,
            "max_abs_err": err.max().item() if err.numel() else 0.0,
            "bit_equal": same}


def _dim_agg_bytes(shapes, r: int) -> int:
    """Bytes a reduction of leaves ``shapes`` ([K, L, P, Q] each) must move:
    every leaf read once, every output written once, the weights once."""
    K = shapes[0][0]
    n = sum(L * P * Q for _, L, P, Q in shapes)
    return (K + 1) * n * 4 + K * r * 4 + K * 4


def _round_tree(gen, K: int, quantized: bool = False):
    """The fedbench-100m round's stacked tree (K clients, LoRA on its sites
    at the global rank ``ROUND_RANK``), random from ``gen``: f32 values of
    adapter scale, or ties of 0.01 steps."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.transformer import lora_specs
    tree = {}
    for sp in lora_specs(get_config("fedbench-100m")):
        e = {}
        for m, shape in (("A", (K, sp.num_layers, ROUND_RANK, sp.in_dim)),
                         ("B", (K, sp.num_layers, sp.out_dim, ROUND_RANK))):
            if quantized:
                e[m] = torch.randint(-3, 4, shape, generator=gen,
                                     device="cuda").float() * 0.01
            else:
                e[m] = torch.randn(shape, generator=gen, device="cuda") * 0.05
        tree[sp.name] = e
    return tree


def phase_dim_agg(dev_name: str) -> dict:
    """``dim_agg`` (without and with the per-client scale) and
    ``dim_agg_trimmed`` against their plain versions at the round's leaf
    shapes and the benchmark shape in both layouts, then the round's whole
    tree through the tree functions (one launch each), then every compiled
    instance at small shapes (not timed).  Bounds: bytes = K + 1 leaves of
    f32 (each input read once, the output written once) plus the small
    operands; operations = 2K per output element for ``dim_agg``, and for
    the trimmed mean 8K² + 6K per element (each comparison, multiply and
    add of the K × K counting loop and the weighted sum counted as one
    f32 operation, as the reference's kernel does them; the yardstick does
    not move with the implementation)."""
    import torch

    from repro_torch.core.aggregation import (_client_masks,
                                              dimension_wise_weights,
                                              staleness_discount,
                                              trimmed_dimension_counts)
    from repro_torch.kernels import dim_agg as DK

    from repro_torch.launch.roofline import peaks_for
    bw, _, peak_f32 = peaks_for(dev_name)
    gen = torch.Generator(device="cuda").manual_seed(1)

    def trim_operands(K, r):
        # a client covering fewer dimensions, the trim counts of trim 0.25
        p = torch.rand(K, generator=gen, device="cuda") + 0.1
        cover = torch.ones(K, r, device="cuda")
        cover[0, r // 2:] = 0.0
        m = cover.sum(0)
        t = torch.clamp(torch.minimum(torch.floor(0.25 * m),
                                      torch.floor((m - 1) / 2)), min=0)
        return p, cover, t

    cases = []
    for label, shape, ax in DIM_AGG_SHAPES:
        K, Lx, P, Q = shape
        r = shape[ax]
        n_out = Lx * P * Q
        n_sets = max(2, int(120e6 // (K * n_out * 4)))
        xs = [torch.randn(shape, generator=gen, device="cuda") * 0.05
              for _ in range(n_sets)]
        w = torch.rand(K, r, generator=gen, device="cuda")
        w = w / w.sum(0, keepdim=True)
        s = torch.rand(K, generator=gen, device="cuda")
        # trimmed operands: duplicate values (ties by client index)
        xq = [torch.randint(-3, 4, shape, generator=gen,
                            device="cuda").float() * 0.01 for _ in xs]
        p, cover, t = trim_operands(K, r)
        eq = "kd,kldn->ldn" if ax == 2 else "kd,klmd->lmd"
        ws = w * s[:, None]
        variants = [
            ("dim_agg", None,
             lambda x: DK.dim_agg_cuda(x, w, rank_axis=ax),
             lambda x: DK.plain_dim_agg(x, w, rank_axis=ax),
             lambda x: torch.einsum(eq, w, x), xs, 2 * K),
            ("dim_agg", "scaled",
             lambda x: DK.dim_agg_cuda(x, w, s, rank_axis=ax),
             lambda x: DK.plain_dim_agg(x, w, s, rank_axis=ax),
             lambda x: torch.einsum(eq, ws, x), xs, 2 * K + 1),
            ("dim_agg_trimmed", None,
             lambda x: DK.dim_agg_trimmed_cuda(x, p, cover, t, rank_axis=ax),
             lambda x: DK.plain_dim_agg_trimmed(x, p, cover, t,
                                                rank_axis=ax),
             None, xq, 8 * K * K + 6 * K)]
        for name, variant, kern, plain, lib, inputs, ops_per in variants:
            y = kern(inputs[0])
            torch.cuda.synchronize()
            held = _hold_agg(f"{name} {label} {variant}", y, plain(inputs[0]))
            ms = cuda_time_ms(kern, [(x,) for x in inputs])
            plain_ms = cuda_time_ms(plain, [(x,) for x in inputs])
            lib_ms = (cuda_time_ms(lib, [(x,) for x in inputs])
                      if lib is not None else None)
            cases.append({
                "kernel": name, "variant": variant, "shape": label,
                "dims": list(shape), "rank_axis": ax,
                "route": (DK.dim_agg_route(Q, True) if name == "dim_agg"
                          else f"K={K}"),
                "max_abs_err": held["max_abs_err"],
                "bit_equal": held["bit_equal"], "ms": ms,
                "plain_ms": plain_ms, "library_ms": lib_ms,
                **_bound(_dim_agg_bytes([shape], r), ops_per * n_out, bw,
                         peak_f32)})
            c = cases[-1]
            c["pct_of_bound"] = 100 * c["bound_ms"] / ms
            lib_s = "n/a" if lib_ms is None else f"{lib_ms:.4f} ms"
            print(f"kernel {name}{'+' + variant if variant else ''} {label}: "
                  f"err {c['max_abs_err']:.3e} bit-equal {c['bit_equal']} "
                  f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms einsum "
                  f"{lib_s} bound {c['bound_ms']:.4f} ms ({c['bound_by']}, "
                  f"{c['pct_of_bound']:.1f} %)", flush=True)

    # the round's whole tree: each tree function once, counted, held
    # against the plain version leaf by leaf; then one launch over the tree
    # timed beside the four one-leaf launches and the plain version
    K, r_g = 4, ROUND_RANK
    ranks = torch.tensor([4, 8, 16, 32], device="cuda")
    pw = torch.rand(K, generator=gen, device="cuda") + 0.1
    pw = pw / pw.sum()
    stale = torch.tensor([0.0, 1.0, 2.0, 0.0], device="cuda")
    # enough trees that each call finds its leaves outside the 50 MB L2
    n_sets = max(2, int(120e6 // _dim_agg_bytes(
        [tuple(x.shape) for x, _ in DK.tree_leaves(_round_tree(gen, K))],
        r_g)))
    trees = [_round_tree(gen, K) for _ in range(n_sets)]
    qtrees = [_round_tree(gen, K, quantized=True) for _ in range(n_sets)]
    anchor = {n: {m: e[m][0] for m in ("A", "B")}
              for n, e in _round_tree(gen, 1).items()}
    w = dimension_wise_weights(ranks, pw, r_g)
    disc = staleness_discount(stale, 0.5)
    cover = _client_masks(ranks, r_g, pw.dtype) * (pw > 0).to(pw.dtype)[:, None]
    t = trimmed_dimension_counts(cover, 0.25)
    covered = (w.sum(0) > 0).to(w.dtype)
    resid = covered * (1.0 - (w * disc[:, None]).sum(0))

    def plain_fedbuff(tree):
        out = []
        for (x, ax), (n, m) in zip(DK.tree_leaves(tree), _tree_keys(tree)):
            y = DK.plain_dim_agg(x, w, disc, rank_axis=ax)
            rr = resid[None, :, None] if m == "A" else resid[None, None, :]
            out.append(y + rr * anchor[n][m])
        return out

    tree_cases = []
    for name, kernel, fn, plain, ts, leaf_fn, ops_per in [
            ("fedilora_aggregate_tree", "dim_agg",
             lambda tr: DK.fedilora_aggregate_tree(tr, ranks, pw),
             lambda tr: [DK.plain_dim_agg(x, w, rank_axis=ax)
                         for x, ax in DK.tree_leaves(tr)], trees,
             lambda lv: DK.dim_agg_tree_cuda(lv, w), 2 * K),
            ("fedbuff_aggregate_tree", "dim_agg",
             lambda tr: DK.fedbuff_aggregate_tree(tr, ranks, pw, stale,
                                                  anchor),
             plain_fedbuff, trees,
             lambda lv: DK.dim_agg_tree_cuda(lv, w, disc), 2 * K + 1),
            ("fedilora_trimmed_tree", "dim_agg_trimmed",
             lambda tr: DK.fedilora_trimmed_tree(tr, ranks, pw, 0.25),
             lambda tr: [DK.plain_dim_agg_trimmed(x, pw, cover, t,
                                                  rank_axis=ax)
                         for x, ax in DK.tree_leaves(tr)], qtrees,
             lambda lv: DK.dim_agg_trimmed_tree_cuda(lv, pw, cover, t),
             8 * K * K + 6 * K)]:
        DK.reset_launches()
        out = fn(ts[0])
        torch.cuda.synchronize()
        got = dict(DK.launches)
        want = {"dim_agg": 0, "dim_agg_trimmed": 0, kernel: 1}
        if got != want:
            raise AssertionError(f"{name}: launches {got}, expected {want}")
        if kernel == "dim_agg" and DK.leaves_by_route != {"vector": 4,
                                                          "scalar": 0}:
            raise AssertionError(f"{name}: leaves by route "
                                 f"{DK.leaves_by_route}")
        held = [_hold_agg(f"{name} {n}.{m}", out[n][m], ref)
                for (n, m), ref in zip(_tree_keys(ts[0]), plain(ts[0]))]
        leaves = [DK.tree_leaves(tr) for tr in ts]
        shapes = [tuple(x.shape) for x, _ in leaves[0]]
        ms = cuda_time_ms(leaf_fn, [(lv,) for lv in leaves])
        per_leaf_ms = cuda_time_ms(
            lambda lv: [leaf_fn([e]) for e in lv], [(lv,) for lv in leaves])
        fn_ms = cuda_time_ms(fn, [(tr,) for tr in ts])
        plain_ms = cuda_time_ms(plain, [(tr,) for tr in ts])
        n_out = sum(L * P * Q for _, L, P, Q in shapes)
        tree_cases.append({
            "kernel": kernel, "tree_function": name, "leaves": shapes,
            "launches": got[kernel],
            "max_abs_err": max(h["max_abs_err"] for h in held),
            "bit_equal": all(h["bit_equal"] for h in held),
            "ms": ms, "per_leaf_ms": per_leaf_ms, "tree_function_ms": fn_ms,
            "plain_ms": plain_ms, "library_ms": None,
            **_bound(_dim_agg_bytes(shapes, r_g), ops_per * n_out, bw,
                     peak_f32)})
        c = tree_cases[-1]
        c["pct_of_bound"] = 100 * c["bound_ms"] / ms
        print(f"kernel {kernel} tree ({name}, {len(shapes)} leaves, 1 "
              f"launch): err {c['max_abs_err']:.3e} bit-equal "
              f"{c['bit_equal']} kernel {ms:.4f} ms (one launch per leaf "
              f"{per_leaf_ms:.4f} ms, the tree function {fn_ms:.4f} ms) "
              f"plain {plain_ms:.4f} ms bound {c['bound_ms']:.4f} ms "
              f"({c['bound_by']}, {c['pct_of_bound']:.1f} %)", flush=True)
    return {"cases": cases, "tree_cases": tree_cases,
            "instances": dim_agg_instances(gen)}


def _tree_keys(tree) -> list:
    return [(n, m) for n in tree for m in ("A", "B")]


def dim_agg_instances(gen) -> list:
    """Every compiled ``dim_agg`` route and ``dim_agg_trimmed`` instance at
    small shapes (checked, not timed): ``dim_agg`` at K in ``INSTANCE_KS``
    and past one stage of 32 staged clients, the trimmed mean at every
    compiled K (1 .. 32); both layouts, Q a multiple of 4 or not,
    contiguous views at element offset 1 (the scalar route); trimmed inputs
    from {-2..2} with NaN, +Inf and -Inf in some clients and a client that
    covers nothing; a table past ``MAX_LEAVES`` leaves.  Each call's route
    or instance is asserted from the counts."""
    import torch

    from repro_torch.kernels import dim_agg as DK
    from repro_torch.kernels.build import aligned16

    def operands(K, r):
        w = torch.rand(K, r, generator=gen, device="cuda")
        s = torch.rand(K, generator=gen, device="cuda") + 0.5
        p = torch.rand(K, generator=gen, device="cuda") + 0.1
        cover = (torch.rand(K, r, generator=gen, device="cuda")
                 < 0.8).float()
        if K >= 3:
            cover[1] = 0.0
        m = cover.sum(0)
        t = torch.clamp(torch.minimum(torch.floor(0.3 * m),
                                      torch.floor((m - 1) / 2)), min=0)
        return w, s, p, cover, t

    def leaf(shape, trimmed):
        if not trimmed:
            return torch.randn(shape, generator=gen, device="cuda")
        x = torch.randint(-2, 3, shape, generator=gen, device="cuda").float()
        K = shape[0]
        if K >= 2:
            x[K - 1, 0, :2, :3] = float("nan")
            x[0, 1, 1, :4] = float("inf")
            x[K // 2, 0, 0, -3:] = float("-inf")
        return x

    out = []
    for kernel in ("dim_agg", "dim_agg_trimmed"):
        ks = (INSTANCE_KS + (40,) if kernel == "dim_agg"
              else range(1, DK.MAX_CLIENTS + 1))
        for K in ks:
            for label, dims, ax, offset in INSTANCE_SHAPES:
                shape = (K,) + dims
                r = shape[ax]
                x = leaf(shape, kernel == "dim_agg_trimmed")
                if offset:
                    x = _offset_view(x)
                w, s, p, cover, t = operands(K, r)
                what = f"{kernel} K={K} {label} {tuple(shape)}"
                DK.reset_launches()
                if kernel == "dim_agg":
                    scale = s if K % 2 else None
                    route = DK.dim_agg_route(shape[3], aligned16(x))
                    y = DK.dim_agg_cuda(x, w, scale, rank_axis=ax)
                    ref = DK.plain_dim_agg(x, w, scale, rank_axis=ax)
                    took = dict(DK.leaves_by_route)
                    want = {"vector": 0, "scalar": 0, route: 1}
                else:
                    route = f"K={K}"
                    y = DK.dim_agg_trimmed_cuda(x, p, cover, t, rank_axis=ax)
                    ref = DK.plain_dim_agg_trimmed(x, p, cover, t,
                                                   rank_axis=ax)
                    took = dict(DK.launches_by_clients)
                    want = {K: 1}
                if took != want:
                    raise AssertionError(f"{what}: took {took}, expected "
                                         f"{want}")
                if offset and route != "scalar" and kernel == "dim_agg":
                    raise AssertionError(f"{what}: an offset view took "
                                         f"{route}")
                out.append({**_hold_agg(what, y, ref), "route": route,
                            "nan_outputs": int(torch.isnan(ref).sum())})
    # a table past MAX_LEAVES leaves: two launches
    K, r = 4, 8
    w, s, _, _, _ = operands(K, r)
    leaves = [(torch.randn(K, 1, r, 12 + i, generator=gen, device="cuda"), 2)
              for i in range(DK.MAX_LEAVES + 1)]
    DK.reset_launches()
    ys = DK.dim_agg_tree_cuda(leaves, w, s)
    if DK.launches["dim_agg"] != 2:
        raise AssertionError(f"{len(leaves)} leaves: {DK.launches} launches, "
                             "expected 2")
    for i, ((x, ax), y) in enumerate(zip(leaves, ys)):
        out.append({**_hold_agg(f"dim_agg table of {len(leaves)} leaf {i}",
                                y, DK.plain_dim_agg(x, w, s, rank_axis=ax)),
                    "route": DK.dim_agg_route(x.shape[3], True)})
    n_nan = sum(c.get("nan_outputs", 0) for c in out)
    print(f"dim_agg instances: {len(out)} cases within their limits (NaN "
          f"positions equal, {n_nan} NaN outputs), max err "
          f"{max(c['max_abs_err'] for c in out):.3e}, bit-equal "
          f"{sum(c['bit_equal'] for c in out)} of {len(out)}", flush=True)
    return out


def ptxas_report(lib: str) -> dict:
    """Registers, stack and spill bytes of every kernel in library
    ``lib``'s ``-Xptxas -v`` report (kept beside the library by
    ``build.py``)."""
    import re

    from repro_torch.kernels import build as kbuild

    out, fn = {}, None
    for line in kbuild.BUILD_INFO[lib]["log"].splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn = m.group(1)
            out[fn] = {}
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if fn and m:
            out[fn].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                           spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if fn and m:
            out[fn]["registers"] = int(m.group(1))
    return out


def dim_agg_registers() -> dict:
    """The ptxas report of every ``dim_agg`` instance (``dim_agg_kernel``
    and ``dim_agg_trimmed_kernel`` for each K); a spill, or a missing
    instance, fails the run."""
    import re

    from repro_torch.kernels.dim_agg import MAX_CLIENTS

    rep = ptxas_report("dim_agg")
    found = {}
    for name, v in rep.items():
        m = re.search(r"dim_agg_trimmed_kernelILi(\d+)E", name)
        key = (f"trimmed K={m.group(1)}" if m else
               "dim_agg" if "dim_agg_kernel" in name else None)
        if key and "registers" in v:
            found[key] = v
    want = {"dim_agg"} | {f"trimmed K={k}" for k in range(1, MAX_CLIENTS + 1)}
    if set(found) != want:
        raise AssertionError(f"ptxas report of dim_agg: instances "
                             f"{sorted(found)}, expected {sorted(want)}")
    spills = {k: v for k, v in found.items()
              if v.get("spill_stores") or v.get("spill_loads")}
    if spills:
        raise AssertionError(f"dim_agg instances spill: {spills}")
    regs = [found[f"trimmed K={k}"]["registers"]
            for k in range(1, MAX_CLIENTS + 1)]
    print(f"ptxas dim_agg: dim_agg_kernel {found['dim_agg']['registers']} "
          f"registers; dim_agg_trimmed K = 1..{MAX_CLIENTS}: {regs} "
          f"registers; no spills, no stack "
          f"({max(v['stack'] for v in found.values())} B at most)",
          flush=True)
    return found


def flash_registers() -> dict:
    """The ptxas report of every 3xTF32 flash instance
    (``flash_tf32x3_kernel`` per type and value-width bucket); a missing
    instance, or a spill at a value width up to 128, fails the run."""
    import re

    rep = ptxas_report("flash_attention")
    found = {}
    for name, v in rep.items():
        m = re.search(r"flash_tf32x3_kernelI(f|13__nv_bfloat16)Li(\d+)E",
                      name)
        if m and "registers" in v:
            dt = "f32" if m.group(1) == "f" else "bf16"
            found[f"{dt} dv<={8 * int(m.group(2))}"] = v
    want = {f"{dt} dv<={w}" for dt in ("f32", "bf16")
            for w in (32, 64, 128, 256)}
    if set(found) != want:
        raise AssertionError(f"ptxas report of flash_attention: instances "
                             f"{sorted(found)}, expected {sorted(want)}")
    spills = {k: v for k, v in found.items()
              if (v.get("spill_stores") or v.get("spill_loads"))
              and not k.endswith("<=256")}
    if spills:
        raise AssertionError(f"flash instances spill at dv <= 128: {spills}")
    print("ptxas flash_attention: " + "; ".join(
        f"{k} {v['registers']} registers, spills {v.get('spill_stores', 0)}"
        f"/{v.get('spill_loads', 0)} B, stack {v.get('stack', 0)} B"
        for k, v in sorted(found.items())), flush=True)
    return found


def _valid_pairs(Sq: int, Sk: int, causal: bool, window: int) -> int:
    """(query, key) pairs the mask lets through, positions from 0."""
    import numpy as np
    qp = np.arange(Sq, dtype=np.int64)
    hi = np.minimum(qp + 1, Sk) if causal else np.full(Sq, Sk)
    lo = np.maximum(qp - window + 1, 0) if window > 0 else np.zeros(Sq, int)
    return int(np.clip(hi - lo, 0, None).sum())


def _hold(what: str, y, ref, p_abs=None) -> float:
    """Max abs error of ``y`` against the plain version's ``ref``; raises
    beyond the limit of y's dtype (``F32_ATOL``, and for bf16 one rounding
    step ``BF16_RTOL * |ref|`` more).  ``p_abs``, given for the tensor-core
    flash route only, is the plain version on |v|: the limit then grows by
    ``P_BF16_RTOL * p_abs`` for the probabilities rounded to bf16."""
    import torch
    if y.shape != ref.shape:
        raise AssertionError(f"{what}: shape {tuple(y.shape)}, plain "
                             f"{tuple(ref.shape)}")
    err = (y.float() - ref.float()).abs()
    rtol = BF16_RTOL if y.dtype == torch.bfloat16 else 0.0
    lim = F32_ATOL + rtol * ref.float().abs()
    if p_abs is not None:
        lim = lim + P_BF16_RTOL * p_abs.float()
    if not bool((err <= lim).all()):
        raise AssertionError(
            f"{what}: max err {err.max().item():.3e} beyond atol {F32_ATOL} "
            f"+ rtol {rtol}" + (f" + {P_BF16_RTOL} * plain(q, k, |v|)"
                                if p_abs is not None else ""))
    return err.max().item()


def _hold_flash(what: str, y, q, k, v, causal: bool, window: int,
                route: str, ref=None) -> float:
    """``_hold`` for one flash output: the route's limit against the plain
    version on the same inputs."""
    from repro_torch.kernels import flash as FA
    if ref is None:
        ref = FA.plain_flash_attention(q, k, v, causal=causal, window=window)
    p_abs = None
    if route == "wgmma":
        p_abs = FA.plain_flash_attention(q.float(), k.float(), v.float().abs(),
                                         causal=causal, window=window)
    return _hold(what, y, ref, p_abs)


def _flash_checked(what: str, route: str, q, k, v, causal: bool,
                   window: int) -> dict:
    """One call of the flash kernel wrapper (outside any counted path),
    held to its limit; raises unless it took ``route``."""
    from repro_torch.kernels import flash as FA
    before = dict(FA.launches_by_route)
    y = FA.flash_attention_cuda(q, k, v, causal=causal, window=window)
    took = [r for r in before if FA.launches_by_route[r] != before[r]]
    if took != [route]:
        raise AssertionError(f"{what}: took route(s) {took}, expected "
                             f"{route}")
    return {"case": what, "route": route, "max_abs_err": _hold_flash(
        what, y, q, k, v, causal, window, route)}


def _lora_checked(what: str, route: str, x, w, a, b, scale: float) -> dict:
    """One call of the LoRA kernel wrapper (outside any counted path), held
    to its limit; raises unless it took ``route``."""
    from repro_torch.kernels import lora_matmul as LM
    from repro_torch.kernels.ref import lora_matmul_ref
    before = dict(LM.launches_by_route)
    y = LM.lora_matmul_cuda(x, w, a, b, scale=scale)
    took = [r for r in before if LM.launches_by_route[r] != before[r]]
    if took != [route]:
        raise AssertionError(f"{what}: took route(s) {took}, expected "
                             f"{route}")
    return {"case": what, "route": route, "max_abs_err": _hold(
        what, y, lora_matmul_ref(x, w, a, b, scale=scale))}


def _lora_blocks(route: str, M: int, K: int, N: int, sms: int) -> int:
    """Blocks the route's kernel launches: 128 x 128 tiles of y on the
    tensor-core route; 64 x 128 tiles on the 3xTF32 route, each split over
    K by 2 or 4 blocks while the tiles fill fewer than one block a SM
    (``k_split`` in ``csrc/lora_matmul.cu``)."""
    if route == "wgmma":
        return -(-N // 128) * -(-M // 128)
    tiles, nk, split = -(-N // 128) * -(-M // 64), -(-K // 32), 1
    while split < 4 and tiles * split < sms and nk >= 4 * split:
        split *= 2
    return tiles * split


def offset_view_cases(gen, scale: float) -> list:
    """bf16 operands at an odd element offset, whose bases TMA refuses: the
    route functions send qwen2-0.5b's ``wq`` LoRA projection and a causal
    GQA attention to ``"tf32x3"``, and each output is held to ``_hold``'s
    bf16 limit there."""
    import torch

    from repro_torch.kernels import flash as FA
    from repro_torch.kernels import lora_matmul as LM
    from repro_torch.kernels.build import aligned16

    bf16 = torch.bfloat16

    def randn(*shape, mul=1.0):
        return _offset_view((torch.randn(*shape, generator=gen, device="cuda")
                             * mul).to(bf16))

    out = []
    M, K, N, r = next(c[1:] for c in LORA_CASES if c[0] == "qwen2-0.5b.wq")
    views = [randn(M, K), randn(K, N, mul=0.05), randn(r, K, mul=0.1),
             randn(N, r, mul=0.1)]
    route = LM.lora_route(bf16, bf16, M, K, N, r, aligned16(*views))
    if route != "tf32x3":
        raise AssertionError(f"offset bf16 LoRA operands: route {route}")
    out.append(_lora_checked(
        f"lora_matmul qwen2-0.5b.wq {M}x{K}x{N} r{r} bf16 at element "
        "offset 1", route, *views, scale))
    B, Sq, Sk, H, KV, d, dv = OFFSET_FLASH
    views = [randn(B, Sq, H, d), randn(B, Sk, KV, d), randn(B, Sk, KV, dv)]
    route = FA.flash_route(bf16, *OFFSET_FLASH, aligned16(*views))
    if route != "tf32x3":
        raise AssertionError(f"offset bf16 q, k, v: route {route}")
    out.append(_flash_checked(
        f"flash_attention {OFFSET_FLASH} causal bf16 at element offset 1",
        route, *views, True, 0))
    print("ops offset views: " + "; ".join(
        f"{c['case']} on {c['route']}, err {c['max_abs_err']:.3e}"
        for c in out), flush=True)
    return out


def phase_ops(dev_name: str) -> dict:
    """The ops path: ``ops.fused_lora_matmul`` and ``ops.flash_attention``
    driven once at every case with the launch counts set to 0 just before
    and read just after; then each output against its plain version on the
    same inputs (``_hold``), ``ops.flash_attention`` against the model's
    ``multihead_attention`` at the qwen2-0.5b prefill shape in f32, kernel,
    plain version and library yardstick timed, and every compiled instance
    of both kernels checked at the ``WIDTH_*`` shapes.  Bounds: each input
    read once and the output written once over the memory rate; the
    products' operations (2 per multiply-add; for attention the valid pairs
    only) over the peak of the inputs' type.  The attention yardstick is
    ``scaled_dot_product_attention`` on the same function: ``is_causal``
    for the causal mask, a boolean mask where there is a window."""
    import torch
    import torch.nn.functional as Fn

    from repro_torch.kernels import flash as FA
    from repro_torch.kernels import lora_matmul as LM
    from repro_torch.kernels import ops
    from repro_torch.kernels.build import aligned16
    from repro_torch.kernels.ref import lora_matmul_ref
    from repro_torch.models.layers import multihead_attention

    from repro_torch.launch.roofline import peaks_for
    bw, peak_bf16, peak_f32 = peaks_for(dev_name)
    gen = torch.Generator(device="cuda").manual_seed(2)
    scale = 0.7

    def randn(*shape, mul=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=gen, device="cuda")
                * mul).to(dtype)

    # x, W, A, B scaled as tests/test_kernels.py scales them
    def lora_operands(M, K, N, r, xdt, adt):
        return (randn(M, K, dtype=xdt), randn(K, N, mul=0.05, dtype=xdt),
                randn(r, K, mul=0.1, dtype=adt),
                randn(N, r, mul=0.1, dtype=adt))

    def qkv(B, Sq, Sk, H, KV, d, dv, dt):
        return (randn(B, Sq, H, d, dtype=dt), randn(B, Sk, KV, d, dtype=dt),
                randn(B, Sk, KV, dv, dtype=dt))

    lora, flash = [], []
    for name, M, K, N, r in LORA_CASES:
        for dt in (torch.float32, torch.bfloat16):
            size = torch.finfo(dt).bits // 8
            n_sets = max(2, int(120e6 // ((K * N + r * (K + N)) * size)))
            sets = [lora_operands(M, K, N, r, dt, dt)[1:]
                    for _ in range(n_sets)]
            lora.append({"name": name, "dims": (M, K, N, r), "dtype": dt,
                         "x": randn(M, K, dtype=dt), "sets": sets})
    flash_cases = ([(name, dims, causal, window, getattr(torch, dtn), 0)
                    for name, dims, causal, window, dts in FLASH_CASES
                    for dtn in dts]
                   + [(name, dims, causal, window, torch.bfloat16, 1)
                      for name, dims, causal, window in FLASH_OFFSET_CASES])
    for name, dims, causal, window, dt, offset in flash_cases:
        B, Sq, Sk, H, KV, d, dv = dims
        size = torch.finfo(dt).bits // 8
        per_set = B * (Sq * H * d + Sk * KV * (d + dv)) * size
        n_sets = max(2, int(120e6 // per_set))
        sets = [qkv(*dims, dt) for _ in range(n_sets)]
        if offset:
            sets = [tuple(_offset_view(t, offset) for t in st)
                    for st in sets]
        flash.append({"name": name, "dims": dims, "causal": causal,
                      "window": window, "dtype": dt, "offset": offset,
                      "sets": sets})
    torch.cuda.synchronize()

    # the path: each entry point once per case, counted
    for kern in (LM, FA):
        kern.reset_launches()
    for c in lora:
        c["y"] = ops.fused_lora_matmul(c["x"], *c["sets"][0], scale=scale)
    for c in flash:
        c["y"] = ops.flash_attention(*c["sets"][0], causal=c["causal"],
                                     window=c["window"])
    torch.cuda.synchronize()
    launches = {"lora_matmul": LM.launches, "flash_attention": FA.launches,
                "lora_matmul_by_route": dict(LM.launches_by_route),
                "flash_attention_by_route": dict(FA.launches_by_route)}
    for c in lora:
        c["route"] = LM.lora_route(c["dtype"], c["dtype"], *c["dims"],
                                   aligned16(c["x"], *c["sets"][0]))
        if c["route"] != ("wgmma" if c["dtype"] == torch.bfloat16
                          else "tf32x3"):
            raise AssertionError(f"lora {c['name']} {c['dtype']}: route "
                                 f"{c['route']}")
    for c in flash:
        B, Sq, Sk, H, KV, d, dv = c["dims"]
        c["route"] = FA.flash_route(c["dtype"], B, Sq, Sk, H, KV, d, dv,
                                    aligned16(*c["sets"][0]))
        if c["route"] != ("wgmma" if c["dtype"] == torch.bfloat16
                          and not c["offset"] else "tf32x3"):
            raise AssertionError(f"flash {c['name']} {c['dtype']}: route "
                                 f"{c['route']}")
    n_wgmma = sum(c["dtype"] == torch.bfloat16 and not c["offset"]
                  for c in flash)
    n_lora_bf16 = sum(c["dtype"] == torch.bfloat16 for c in lora)
    want = {"lora_matmul": len(lora), "flash_attention": len(flash),
            "lora_matmul_by_route": {"wgmma": n_lora_bf16,
                                     "tf32x3": len(lora) - n_lora_bf16},
            "flash_attention_by_route": {"wgmma": n_wgmma,
                                         "tf32x3": len(flash) - n_wgmma}}
    if launches != want:
        raise AssertionError(f"ops path launches {launches}, expected "
                             f"{want}")

    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    cases = []
    for c in lora:
        M, K, N, r = c["dims"]
        dt, x = c["dtype"], c["x"]
        w, a, b = c["sets"][0]
        err = _hold(f"fused_lora_matmul {c['name']} {dt}", c["y"],
                    lora_matmul_ref(x, w, a, b, scale=scale))
        ms = cuda_time_ms(lambda w, a, b: LM.lora_matmul_cuda(
            x, w, a, b, scale=scale), c["sets"])
        plain_ms = cuda_time_ms(lambda w, a, b: lora_matmul_ref(
            x, w, a, b, scale=scale), c["sets"])
        lib_ms = cuda_time_ms(lambda w, a, b: torch.matmul(x, w), c["sets"])
        size = torch.finfo(dt).bits // 8
        ops_n = 2 * M * N * K + 2 * M * r * (K + N)
        blocks = _lora_blocks(c["route"], M, K, N, n_sms)
        cases.append({
            "kernel": "lora_matmul", "shape": c["name"], "M": M, "K": K,
            "N": N, "r": r, "dtype": str(dt).split(".")[-1],
            "route": c["route"], "tflops": ops_n / ms / 1e9,
            "blocks": blocks, "sms": n_sms, "sm_waves": blocks / n_sms,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": lib_ms,
            "library_call": "torch.matmul(x, W): the base product only",
            **_bound((M * K + K * N + M * N + r * (K + N)) * size, ops_n,
                     bw, peak_bf16 if dt == torch.bfloat16 else peak_f32)})
    for c in flash:
        B, Sq, Sk, H, KV, d, dv = c["dims"]
        dt, causal, window = c["dtype"], c["causal"], c["window"]
        q, k, v = c["sets"][0]
        ref = FA.plain_flash_attention(q, k, v, causal=causal, window=window)
        err = _hold_flash(f"flash_attention {c['name']} {dt}", c["y"], q, k,
                          v, causal, window, c["route"], ref)
        model_err = None
        if c["name"] == "qwen2-0.5b.prefill" and dt == torch.float32:
            model = multihead_attention(q, k, v, causal=True, chunked=False)
            model_err = (c["y"] - model).abs().max().item()
            if model_err > F32_ATOL:
                raise AssertionError(f"ops.flash_attention vs "
                                     f"multihead_attention: max err "
                                     f"{model_err:.3e} beyond {F32_ATOL}")
            del model
        # the yardstick: SDPA on the same function in the [B, H, S, d]
        # layout it takes (views made outside the timing); a window is a
        # boolean mask (True: attend)
        mask = None
        if window:
            qp = torch.arange(Sq, device="cuda")[:, None]
            kp = torch.arange(Sk, device="cuda")[None, :]
            mask = qp - kp < window
            if causal:
                mask &= qp >= kp
        lib_causal = causal and not window
        lib_call = ("scaled_dot_product_attention(q, k, v, "
                    + ("attn_mask=window mask, " if window else
                       "is_causal=True, " if causal else "")
                    + f"enable_gqa={H != KV}) in the [B, H, S, d] layout")

        def sdpa(q, k, v):
            return Fn.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, is_causal=lib_causal,
                enable_gqa=H != KV)

        tsets = [tuple(t.transpose(1, 2) for t in s) for s in c["sets"]]
        lib_diff = (sdpa(*tsets[0]).transpose(1, 2).float()
                    - ref.float()).abs().max().item()
        del ref
        ms = cuda_time_ms(lambda q, k, v: FA.flash_attention_cuda(
            q, k, v, causal=causal, window=window), c["sets"], iters=20)
        plain_ms = cuda_time_ms(lambda q, k, v: FA.plain_flash_attention(
            q, k, v, causal=causal, window=window), c["sets"], iters=20)
        lib_ms = cuda_time_ms(sdpa, tsets, iters=20)
        size = torch.finfo(dt).bits // 8
        pairs = B * H * _valid_pairs(Sq, Sk, causal, window)
        cases.append({
            "kernel": "flash_attention", "shape": c["name"],
            "dims": {"B": B, "Sq": Sq, "Sk": Sk, "H": H, "KV": KV, "d": d,
                     "dv": dv}, "causal": causal, "window": window,
            "dtype": str(dt).split(".")[-1], "route": c["route"],
            "element_offset": c["offset"],
            "tflops": 2 * pairs * (d + dv) / ms / 1e9,
            "max_abs_err": err, "model_max_abs_err": model_err,
            "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "library_call": lib_call, "library_max_abs_diff": lib_diff,
            **_bound((B * Sq * H * (d + dv) + B * Sk * KV * (d + dv)) * size,
                     2 * pairs * (d + dv), bw,
                     peak_bf16 if dt == torch.bfloat16 else peak_f32)})
    for c in cases:
        c["pct_of_bound"] = 100 * c["bound_ms"] / c["ms"]
        extra = f" route {c['route']} {c['tflops']:.1f} TFLOP/s"
        if "blocks" in c:
            extra += f" blocks {c['blocks']} for {c['sms']} SMs"
        print(f"ops {c['kernel']} {c['shape']} {c['dtype']}: err "
              f"{c['max_abs_err']:.3e} kernel {c['ms']:.4f} ms plain "
              f"{c['plain_ms']:.4f} ms library {c['library_ms']:.4f} ms "
              f"bound {c['bound_ms']:.4f} ms ({c['bound_by']}, "
              f"{c['pct_of_bound']:.1f} %){extra}", flush=True)
    print(f"ops path launches: {launches}", flush=True)

    # every compiled instance, through the kernel wrappers (after the
    # counted run)
    widths = []
    for M, K, N, r in WIDTH_LORA:
        for xdt, adt in [(torch.float32, torch.float32),
                         (torch.bfloat16, torch.bfloat16),
                         (torch.bfloat16, torch.float32),
                         (torch.float32, torch.bfloat16)]:
            widths.append(_lora_checked(
                f"lora_matmul {M}x{K}x{N} r{r} {xdt}/{adt}", "tf32x3",
                *lora_operands(M, K, N, r, xdt, adt), scale))
    for M, K, N, r in WIDTH_LORA_WGMMA:
        widths.append(_lora_checked(
            f"lora_matmul {M}x{K}x{N} r{r} bf16/bf16", "wgmma",
            *lora_operands(M, K, N, r, torch.bfloat16, torch.bfloat16),
            scale))
    for name, dims, causal, window in WIDTH_FLASH:
        for dt, route in ((torch.float32, "tf32x3"),
                          (torch.bfloat16, "wgmma")):
            widths.append(_flash_checked(f"flash_attention {name} {dims} {dt}",
                                         route, *qkv(*dims, dt), causal,
                                         window))
    for name, dims, causal, window in FLASH_TF32X3_BF16:
        widths.append(_flash_checked(
            f"flash_attention {name} {dims} bf16", "tf32x3",
            *qkv(*dims, torch.bfloat16), causal, window))
    print(f"ops widths: {len(widths)} kernel instances and shapes within "
          f"their limits, max err "
          f"{max(c['max_abs_err'] for c in widths):.3e}", flush=True)

    offsets = offset_view_cases(gen, scale)
    return {"launches": launches, "cases": cases, "widths": widths,
            "offset_views": offsets}


# a register-only loop of independent mma.sync.m16n8k8 TF32 products: the
# rate the 3xTF32 route's instruction can reach on this card
PROBE_MMA_TF32 = r"""
#include <cuda_runtime.h>
#include <stdint.h>
__global__ void probe(float* out, int iters) {
  float c[16][4] = {};
  const uint32_t a0 = threadIdx.x, a1 = 3u * threadIdx.x;
  const uint32_t b0 = 5u * threadIdx.x, b1 = 7u * threadIdx.x;
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int t = 0; t < 16; ++t)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0,%1,%2,%3}, {%4,%5,%4,%5}, {%6,%7}, {%0,%1,%2,%3};"
          : "+f"(c[t][0]), "+f"(c[t][1]), "+f"(c[t][2]), "+f"(c[t][3])
          : "r"(a0), "r"(a1), "r"(b0), "r"(b1));
  float s = 0.f;
  for (int t = 0; t < 16; ++t) s += c[t][0] + c[t][1] + c[t][2] + c[t][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
// TFLOP/s of 16 independent products a warp, 8 warps x 2 blocks a SM
extern "C" double probe_mma_tf32(int sms) {
  const int blocks = 2 * sms, threads = 256, iters = 4096;
  float* out;
  if (cudaMalloc(&out, blocks * threads * sizeof(float)) != cudaSuccess)
    return -1.0;
  probe<<<blocks, threads>>>(out, 16);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  cudaEventRecord(e0);
  probe<<<blocks, threads>>>(out, iters);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, e0, e1);
  const bool ok = cudaGetLastError() == cudaSuccess;
  cudaFree(out);
  return ok ? (double)blocks * 8 * iters * 16 * 2048.0 / ms / 1e9 : -1.0;
}
"""


def probe_mma_tf32() -> dict:
    """Build and run ``PROBE_MMA_TF32``: the mma.sync TF32 rate, against
    which the 3xTF32 route's rate is read."""
    import ctypes

    import torch

    from repro_torch.kernels import build as kbuild

    out_dir = os.path.join(ROOT, "build", "probe")
    os.makedirs(out_dir, exist_ok=True)
    src, lib = (os.path.join(out_dir, f"mma_tf32.{e}") for e in ("cu", "so"))
    with open(src, "w") as f:
        f.write(PROBE_MMA_TF32)
    subprocess.run([kbuild.nvcc_path(), *kbuild.NVCC_FLAGS, "-o", lib, src],
                   capture_output=True, text=True, check=True)
    fn = ctypes.CDLL(lib).probe_mma_tf32
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_double
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    tflops = fn(sms)
    if not tflops > 0:
        raise RuntimeError("the mma.sync TF32 probe failed")
    print(f"probe: mma.sync.m16n8k8 TF32, 16 independent products a warp, "
          f"16 warps a SM: {tflops:.1f} TFLOP/s", flush=True)
    return {"mma_sync_tf32_tflops": tflops}


def sass_counts() -> dict:
    """Tensor-core instructions in the built libraries (``cuobjdump
    -sass``): HGMMA in each flash and LoRA wgmma kernel, HMMA in each bf16
    BGMV instance, TF32 HMMA in each 3xTF32 LoRA and flash instance.
    Raises if a total is 0, or any such kernel has none."""
    import re

    from repro_torch.kernels import build as kbuild

    tool = os.path.join(os.path.dirname(kbuild.nvcc_path()), "cuobjdump")
    out = {}
    for lib, key, instr, regex in [
            ("flash_attention_wgmma", "flash_wgmma_kernel", "HGMMA",
             r"\bHGMMA\."),
            ("lora_matmul_wgmma", "lora_wgmma_kernel", "HGMMA",
             r"\bHGMMA\."),
            ("grouped_lora_matmul", "base_expand_kernelI13__nv_bfloat16",
             "HMMA", r"\bHMMA\."),
            ("lora_matmul", "lora_tf32x3_kernel", "HMMA.TF32",
             r"\bHMMA\.\S*TF32"),
            ("flash_attention", "flash_tf32x3_kernel", "HMMA.TF32",
             r"\bHMMA\.\S*TF32")]:
        sass = subprocess.run([tool, "-sass", kbuild.BUILD_INFO[lib]["path"]],
                              capture_output=True, text=True,
                              check=True).stdout
        pat = re.compile(regex)
        per, fn = {}, None
        for line in sass.splitlines():
            if "Function :" in line:
                name = line.split("Function :")[1].strip()
                fn = name[name.index(key):] if key in name else None
                if fn:
                    per[fn] = 0
            elif fn and pat.search(line):
                per[fn] += 1
        out[lib] = {"instruction": instr, "total": sum(per.values()),
                    "per_kernel": per}
        if not per or not all(per.values()):
            raise AssertionError(f"{lib}: {instr} counts {per}: a kernel "
                                 "that should run on the tensor cores has "
                                 "no tensor-core instruction")
    print("sass: " + ", ".join(
        f"{lib} {v['total']} {v['instruction']} over {len(v['per_kernel'])} "
        f"kernels" for lib, v in out.items()), flush=True)
    return out


def make_adapters(cfg, rng, n: int):
    import numpy as np

    from repro_torch.models.transformer import lora_specs
    specs = lora_specs(cfg)
    out = {}
    for t in range(n):
        rank = RANKS[t % len(RANKS)]
        out[f"tenant{t}"] = ({s.name: {
            "A": (rng.standard_normal((s.num_layers, rank, s.in_dim))
                  * s.in_dim ** -0.5).astype(np.float32),
            "B": (rng.standard_normal((s.num_layers, s.out_dim, rank))
                  * rank ** -0.5).astype(np.float32)} for s in specs}, rank)
    return out


def make_requests(cfg, rng, n: int, *, gen_len=None):
    from repro_torch.serving import Request
    reqs = []
    for _ in range(n):
        plen = int(rng.integers(16, 129))
        reqs.append(Request(
            adapter_id=f"tenant{int(rng.integers(0, N_TENANTS))}",
            prompt_tokens=rng.integers(0, cfg.vocab_size, size=plen),
            gen_len=gen_len or int(rng.integers(16, 65))))
    return reqs


def make_engine(cfg, params, adapters, *, backend: str, mesh=None):
    from repro_torch.serving import AdapterStore, ServingEngine
    store = AdapterStore(slots=BANK_SLOTS, rank=max(RANKS), mesh=mesh)
    for tid, (lora, rank) in adapters.items():
        store.register(tid, lora, rank)
    eng = ServingEngine(cfg, params, store, lora_scale=16.0 / max(RANKS),
                        max_slots=16, max_prompt=128, max_gen=64,
                        prefill_chunk=32, lora_backend=backend, mesh=mesh)
    return eng, store


def serve(cfg, params, adapters, requests, *, backend: str):
    import torch

    eng, store = make_engine(cfg, params, adapters, backend=backend)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = eng.run(requests)
    torch.cuda.synchronize()
    return eng, store, done, time.perf_counter() - t0


def phase_serve() -> dict:
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import grouped_lora_matmul as glm
    from repro_torch.models.transformer import init_params

    cfg = get_config("qwen2-0.5b")
    rng = np.random.default_rng(0)
    params = init_params(cfg, seed=0)                  # bf16 on the card
    adapters = make_adapters(cfg, rng, N_TENANTS)
    reqs = make_requests(cfg, rng, 48)
    glm.reset_launches()
    eng, store, done, wall = serve(cfg, params, adapters, reqs,
                                   backend="grouped")
    launches = glm.launches
    dc = eng.dispatch_count
    calls = dc["serve_step"] + dc["serve_prefill"]
    by_uid = {d["uid"]: d for d in done}
    for q in reqs:
        d = by_uid[q.uid]
        if d["status"] != "ok" or len(d["tokens"]) != q.gen_len:
            raise AssertionError(f"request {q.uid}: status {d['status']}, "
                                 f"{len(d['tokens'])} of {q.gen_len} tokens")
        if not ((d["tokens"] >= 0) & (d["tokens"] < cfg.vocab_size)).all():
            raise AssertionError(f"request {q.uid}: token out of vocabulary")
    if store.loads <= BANK_SLOTS:
        raise AssertionError(f"only {store.loads} page-ins for {N_TENANTS} "
                             f"tenants over {BANK_SLOTS} slots")
    want = 2 * cfg.num_blocks * calls
    if launches != want:
        raise AssertionError(f"grouped_lora_matmul launched {launches} times, "
                             f"expected 2*{cfg.num_blocks}*{calls} = {want}")
    tokens = sum(q.gen_len for q in reqs)
    # a short second run under the profiler, after the counted one: does
    # the BGMV kernels' time reach the serve wall, or does the host set the
    # pace?
    preqs = make_requests(cfg, np.random.default_rng(2),
                          SERVE_PROFILE_REQUESTS, gen_len=16)
    peng, _ = make_engine(cfg, params, adapters, backend="grouped")
    prof = _profiled(lambda: peng.run(preqs), f"serve, {len(preqs)} requests",
                     ("shrink_kernel", "base_expand_kernel"))
    out = {"requests": len(reqs), "steps": eng.steps, "profile": prof,
           "dispatch_count": dict(dc), "adapter_loads": store.loads,
           "evictions": store.evictions, "wall_s": wall,
           "generated_tokens": tokens, "tokens_per_s": tokens / wall,
           "launches": launches,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    print(f"serve (smoke run, not a benchmark): qwen2-0.5b bf16, "
          f"{len(reqs)} requests, {eng.steps} steps, {calls} serve/prefill "
          f"calls, {store.loads} page-ins, {wall:.2f} s wall, "
          f"{tokens / wall:.1f} generated tokens/s, {launches} kernel "
          f"launches", flush=True)
    return out


def phase_agreement() -> dict:
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params

    cfg = get_config("qwen2-0.5b")
    rng = np.random.default_rng(1)
    params = init_params(cfg, seed=0, dtype="float32")
    adapters = make_adapters(cfg, rng, N_TENANTS)
    reqs = make_requests(cfg, rng, 16, gen_len=32)
    toks = {}
    for backend in ("grouped", "gather"):
        _, _, done, _ = serve(cfg, params, adapters, reqs, backend=backend)
        toks[backend] = {d["uid"]: d["tokens"].tolist() for d in done}
    bad = [u for u in toks["gather"] if toks["gather"][u] != toks["grouped"][u]]
    if bad or len(toks["gather"]) != len(reqs):
        raise AssertionError(f"f32 grouped vs gather greedy tokens differ for "
                             f"requests {bad}")
    print(f"agreement: f32 grouped == gather greedy tokens for {len(reqs)} "
          f"requests x 32 tokens", flush=True)
    return {"requests": len(reqs), "identical": True}


# the slo phase: 3 tenants at ManualClock, then an overload burst of
# 64 requests on the serve phase's engine under the real clock; the
# interactive deadline sits inside the time 16 slots take to decode 16-64
# tokens (about 40 ms a step on the card), so that both classes complete
# some requests and report latency percentiles
SLO_TENANTS, SLO_GEN, SLO_BURST, SLO_INTERACTIVE_S = 3, 8, 64, 2.5
STANDARD_DISPATCH = {"serve_step", "serve_prefill", "serve_admit",
                     "adapter_load", "fetch"}


def _bgmv_held(engines, what: str) -> int:
    """The BGMV wrapper's launches since the last reset must be two a LoRA
    site a layer for every serve/prefill call of ``engines``."""
    from repro_torch.kernels import grouped_lora_matmul as glm
    calls = sum(e.dispatch_count["serve_step"]
                + e.dispatch_count["serve_prefill"] for e in engines)
    want = 2 * engines[0].cfg.num_blocks * calls
    if glm.launches != want or not want:
        raise AssertionError(f"{what}: grouped_lora_matmul launched "
                             f"{glm.launches} times, expected {want}")
    return glm.launches


def phase_slo() -> dict:
    """The SLO scheduler over qwen2-0.5b at full width and depth, bf16,
    ``lora_backend="grouped"``: the scenarios of ``tests/test_scheduler.py``
    that ``tests/test_torch_scheduler.py`` holds against the reference,
    under a ``ManualClock`` with the test's assertions; two token
    properties in f32 weights; then an overload burst under the real clock
    (per-class goodput, sheds, timeouts, latency and TTFT percentiles),
    gated only on invariants."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import grouped_lora_matmul as glm
    from repro_torch.models.transformer import init_params
    from repro_torch.serving import (AdapterStore, ManualClock, RetryPolicy,
                                     Request, SamplingConfig,
                                     SchedulerConfig, ServingEngine,
                                     SLOScheduler)

    cfg = get_config("qwen2-0.5b")
    rng = np.random.default_rng(3)
    adapters = make_adapters(cfg, rng, SLO_TENANTS)
    prompts = {(k, i): rng.integers(0, cfg.vocab_size,
                                    size=int(rng.integers(8, 33)))
               for k in range(SLO_TENANTS) for i in range(2)}
    bf16 = init_params(cfg, seed=0)

    def engine(params, slots, **kw):
        store = AdapterStore(slots=SLO_TENANTS, rank=max(RANKS))
        for tid, (lora, rank) in adapters.items():
            store.register(tid, lora, rank)
        return ServingEngine(cfg, params, store, lora_scale=16.0 / max(RANKS),
                             max_slots=slots, max_prompt=32, max_gen=SLO_GEN,
                             prefill_chunk=16, lora_backend="grouped", **kw)

    def req(k, i=0, **kw):
        return Request(adapter_id=f"tenant{k}", prompt_tokens=prompts[(k, i)],
                       gen_len=SLO_GEN, **kw)

    def sched(eng, cfg_=None):
        clock = ManualClock()
        return SLOScheduler(eng, cfg_, clock=clock), clock

    def drain(sc, clock):
        for _ in range(2000):
            eng = sc.engine
            if not (sc.pending or sc.waiting_retries or eng.queue
                    or eng.busy_slots):
                return
            if (sc.waiting_retries and not sc.pending
                    and not eng.busy_slots and not eng.queue):
                clock.advance(sc._retry[0][0] - clock() + 1e-9)
            sc.step()
            clock.advance(1e-4)
        raise AssertionError("scheduler failed to drain")

    def status(sc, uid):
        return next(r for r in sc.results if r["uid"] == uid)

    def check(cond, what):
        if not cond:
            raise AssertionError(f"slo: {what}")

    glm.reset_launches()
    engines, seen = [], []

    # interactive ahead of batch, EDF within a class
    eng = engine(bf16, 1)
    sc, clock = sched(eng)
    b, i = req(0, slo="batch"), req(1, slo="interactive")
    sc.submit(b)
    sc.submit(i)
    sc.step()
    check(eng._requests[0] is i, "interactive did not take the slot first")
    drain(sc, clock)
    check([r["uid"] for r in sc.results if r["status"] == "ok"]
          == [i.uid, b.uid], "completion order")
    engines.append(eng)
    seen.append("interactive_ahead_of_batch")

    eng = engine(bf16, 1)
    sc, clock = sched(eng)
    late, soon = (req(0, slo="batch", deadline_s=50.0),
                  req(1, slo="batch", deadline_s=20.0))
    sc.submit(late)
    sc.submit(soon)
    sc.step()
    check(eng._requests[0] is soon, "EDF within a class")
    drain(sc, clock)
    check({r["status"] for r in sc.results} == {"ok"}, "EDF statuses")
    engines.append(eng)
    seen.append("edf_within_class")

    # reject burst: shed requests never hold a slot
    eng = engine(bf16, 1)
    sc, clock = sched(eng, SchedulerConfig(queue_limit=0,
                                           shed_policy="reject"))
    rs = [req(k) for k in range(3)]
    for r in rs:
        sc.submit(r)
    check([r["uid"] for r in sc.results if r["status"] == "shed"]
          == [rs[1].uid, rs[2].uid], "reject shed set")
    drain(sc, clock)
    m = eng.telemetry.metrics
    check(eng.dispatch_count["serve_admit"] == 1, "reject admissions")
    check(m.get("serving.shed").value == 2, "serving.shed")
    check(m.snapshot()["histograms"]["serving.latency_seconds"]["count"]
          == 1, "latency histogram counts only ok completions")
    engines.append(eng)
    seen.append("reject_burst")

    # drop_lowest: an interactive arrival evicts a pending batch request
    eng = engine(bf16, 1)
    sc, clock = sched(eng, SchedulerConfig(queue_limit=1,
                                           shed_policy="drop_lowest"))
    b1, b2, i1, i2 = (req(0, slo="batch"), req(1, slo="batch"),
                      req(2, slo="interactive"), req(0, slo="interactive"))
    sc.submit(b1)
    sc.step()
    for r in (b2, i1, i2):
        clock.advance(1e-3)
        sc.submit(r)
    check([r["uid"] for r in sc.results if r["status"] == "shed"]
          == [b2.uid, i2.uid], "drop_lowest shed set")
    drain(sc, clock)
    check({r["uid"] for r in sc.results if r["status"] == "ok"}
          == {b1.uid, i1.uid}, "drop_lowest completions")
    engines.append(eng)
    seen.append("drop_lowest")

    # degrade: admitted with its length clamped
    eng = engine(bf16, 1)
    sc, clock = sched(eng, SchedulerConfig(queue_limit=0,
                                           shed_policy="degrade",
                                           degrade_gen_len=2))
    first, deg = req(1), req(0)
    sc.submit(first)
    sc.submit(deg)
    check(deg.gen_len == 2 and deg.degraded, "degrade clamp")
    drain(sc, clock)
    rec = status(sc, deg.uid)
    check(rec["status"] == "ok" and rec.get("degraded")
          and len(rec["tokens"]) == 2, "degraded completion")
    engines.append(eng)
    seen.append("degrade")

    # in-flight timeout: cancelled at the step boundary, no extra launch
    eng = engine(bf16, 1)
    sc, clock = sched(eng, SchedulerConfig(interactive_deadline_s=0.05,
                                           batch_deadline_s=100.0))
    doomed, after = req(0, slo="interactive"), req(1, slo="batch")
    sc.submit(doomed)
    sc.submit(after)
    sc.step()
    check(eng._requests[0] is doomed, "timeout: doomed admitted")
    steps0 = eng.dispatch_count["serve_step"]
    clock.advance(1.0)
    sc.step()
    check(eng._requests[0] is after, "timeout: slot reused at once")
    check(eng.dispatch_count["serve_step"] == steps0 + 1,
          "timeout: the cancelling step launched more than one step")
    check(status(sc, doomed.uid)["status"] == "timeout", "timeout status")
    check(eng.telemetry.metrics.get("serving.timeout").value == 1,
          "serving.timeout")
    drain(sc, clock)
    dc = dict(eng.dispatch_count)
    check(set(dc) <= STANDARD_DISPATCH and dc["serve_step"] == eng.steps
          and dc["fetch"] == 1, f"timeout: dispatches {dc}")
    check(status(sc, after.uid)["status"] == "ok", "timeout: survivor")
    engines.append(eng)
    seen.append("timeout_cancels_in_flight")

    # retry with backoff: the same request object comes back
    eng = engine(bf16, 1)
    sc, clock = sched(eng, SchedulerConfig(
        queue_limit=0, shed_policy="reject",
        retry=RetryPolicy(max_attempts=3, backoff_s=0.5, multiplier=2.0)))
    r1, r2 = req(0), req(1)
    sc.submit(r1)
    sc.submit(r2)
    check(sc.waiting_retries == 1 and r2.attempts == 1, "retry queued")
    sc.step()
    check(sc.waiting_retries == 1, "retry before its backoff")
    drain(sc, clock)
    rec = status(sc, r2.uid)
    check(rec["status"] == "ok" and rec["attempts"] == 2, "retry outcome")
    engines.append(eng)
    seen.append("retry_backoff")
    scenario_launches = _bgmv_held(engines, "slo scenarios")

    # token properties in f32 weights (as the agreement phase runs them)
    f32 = init_params(cfg, seed=0, dtype="float32")
    full = engine(f32, 1).run([req(0)])[0]["tokens"]
    eng = engine(f32, 1)
    sc, clock = sched(eng, SchedulerConfig(queue_limit=0,
                                           shed_policy="degrade",
                                           degrade_gen_len=2))
    sc.submit(req(1))
    deg = req(0)
    sc.submit(deg)
    drain(sc, clock)
    check(status(sc, deg.uid)["tokens"].tolist() == full[:2].tolist(),
          "degraded tokens are not a prefix of the unloaded run")
    sampling = SamplingConfig(temperature=0.8, top_k=5)
    again = req(0)
    ref = engine(f32, 1, sampling=sampling, sample_seed=7).run(
        [again])[0]["tokens"]
    eng = engine(f32, 1, sampling=sampling, sample_seed=7)
    sc, clock = sched(eng, SchedulerConfig(
        queue_limit=0, shed_policy="reject",
        retry=RetryPolicy(max_attempts=3, backoff_s=0.5)))
    sc.submit(req(1))
    sc.submit(again)
    drain(sc, clock)
    rec = status(sc, again.uid)
    check(rec["attempts"] == 2 and rec["tokens"].tolist() == ref.tolist(),
          "a retried sampled request changed its tokens")
    del f32

    # overload burst under the real clock on the serve phase's engine
    burst_adapters = make_adapters(cfg, np.random.default_rng(4), N_TENANTS)
    eng, store = make_engine(cfg, bf16, burst_adapters, backend="grouped")
    brng = np.random.default_rng(5)
    burst = make_requests(cfg, brng, SLO_BURST)
    for r in burst:
        r.slo = "interactive" if brng.random() < 0.35 else "batch"
    sc = SLOScheduler(eng, SchedulerConfig(
        interactive_deadline_s=SLO_INTERACTIVE_S, batch_deadline_s=8.0,
        queue_limit=16,
        shed_policy="drop_lowest",
        retry=RetryPolicy(max_attempts=2, backoff_s=0.2)))
    glm.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = sc.run(burst)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    burst_launches = _bgmv_held([eng], "slo burst")
    uids = sorted(r["uid"] for r in done)
    check(uids == sorted(r.uid for r in burst),
          "burst: a request ended more than once or never")
    by_uid = {r.uid: r for r in burst}
    check(all(by_uid[r["uid"]].admitted_at is None
              for r in done if r["status"] == "shed"),
          "burst: a shed request held a slot")
    rep = sc.slo_report()
    m = eng.telemetry.metrics
    classes = {}
    for c, d in rep["per_class"].items():
        lat, ttft = (m.get(f"serving.latency_seconds.{c}"),
                     m.get(f"serving.ttft_seconds.{c}"))
        classes[c] = dict(d, **{
            f"{name}_{q}": (h.quantile(v) if h is not None else None)
            for name, h in (("latency_s", lat), ("ttft_s", ttft))
            for q, v in (("p50", 0.5), ("p99", 0.99))})
    tokens = sum(len(r["tokens"]) for r in done if r["status"] == "ok")
    print(f"slo (smoke run, not a benchmark): qwen2-0.5b bf16 grouped, "
          f"{len(seen)} ManualClock scenarios held, f32 degrade-prefix and "
          f"retry-reproduces-tokens held; burst of {len(burst)} requests "
          f"(16 slots, queue_limit 16, drop_lowest, interactive deadline "
          f"{SLO_INTERACTIVE_S} s, batch 8 s) in {wall:.2f} s, "
          f"{tokens} ok tokens, goodput {rep['goodput']}/{rep['offered']}; "
          + "; ".join(
              f"{c}: offered {d['offered']} goodput {d['goodput']} shed "
              f"{d['shed']} timeout {d['timeout']} latency p50/p99 "
              f"{_fmt(d['latency_s_p50'])}/{_fmt(d['latency_s_p99'])} s "
              f"ttft p50/p99 {_fmt(d['ttft_s_p50'])}/{_fmt(d['ttft_s_p99'])} s"
              for c, d in classes.items())
          + f"; BGMV launches {scenario_launches} + {burst_launches}",
          flush=True)
    return {"scenarios": seen, "launches": scenario_launches + burst_launches,
            "scenario_launches": scenario_launches,
            "burst_launches": burst_launches, "burst_wall_s": wall,
            "burst_ok_tokens": tokens, "report": rep, "classes": classes,
            "burst_steps": eng.steps, "adapter_loads": store.loads}


def _fmt(x) -> str:
    return "n/a" if x is None else f"{x:.3f}"


_FED_DATA: dict = {}


def fed_setup(aggregator: str, *, base=None, model: str = "fedbench-100m",
              task: dict | None = None, mesh=None, cfg=None,
              split: bool = False, **fed_kw):
    """fedbench-100m as ``examples/federated_finetune.py`` sets it up: the
    synthetic task with seed 1, 10 clients of heterogeneous sizes, 80/20
    train/eval shards, 60% missing modalities, ranks 4..32, 4 clients a
    round, batch 8, 10 local steps, editing on.  ``model`` and ``task``
    (``SyntheticTaskConfig`` fields, e.g. the image width) put another
    model under the same protocol.  Each corpus is made once and shared by
    every trainer (none writes to it).  ``fed_kw`` override
    ``FederatedConfig`` fields; ``mesh`` is the trainer's round mesh.
    ``cfg`` replaces ``model``'s published config (a cut depth, another
    dtype); ``split``: ``base`` holds this rank's tensor-parallel pieces
    for ``mesh`` (``init_params(..., tp=)``)."""
    from repro_torch.configs import get_config
    from repro_torch.core.editing import EditConfig
    from repro_torch.data import (SyntheticTaskConfig, apply_missing_modality,
                                  heterogeneous_sizes,
                                  make_federated_datasets)
    from repro_torch.federated import FederatedConfig, FederatedTrainer
    from repro_torch.models.transformer import init_params
    from repro_torch.optim import OptimizerConfig

    key = tuple(sorted((task or {}).items()))
    if key not in _FED_DATA:
        tcfg = SyntheticTaskConfig(seed=1, **dict(key))
        sizes = heterogeneous_sizes(10, 900, seed=1)
        clients, gtest = make_federated_datasets(tcfg, 10, sizes, seed=1)
        tr, ev = [], []
        for k, d in enumerate(clients):
            n_tr = int(d["tokens"].shape[0] * 0.8)
            tr.append(apply_missing_modality(
                {kk: v[:n_tr] for kk, v in d.items()}, 0.6, tcfg.prompt_len,
                seed=k))
            ev.append({kk: v[n_tr:] for kk, v in d.items()})
        _FED_DATA[key] = dict(tr=tr, ev=ev, gtest=gtest)
    data = _FED_DATA[key]
    fed = FederatedConfig(**{**dict(
        num_clients=10, sample_rate=0.4, ranks=TRAIN_RANKS, local_steps=10,
        batch_size=8, aggregator=aggregator, edit=EditConfig()), **fed_kw})
    opt = OptimizerConfig(peak_lr=1e-3, total_steps=TRAIN_ROUNDS * 10)
    cfg = cfg or get_config(model)
    if base is None:
        base = init_params(cfg, seed=42)
    tr = FederatedTrainer(cfg, fed, opt, data["tr"], data["ev"],
                          data["gtest"], base_params=base, mesh=mesh)
    if split:
        tr.set_base_params(base, split=True)
    return tr


def phase_train() -> dict:
    """3 FediLoRA rounds on fedbench-100m through ``fedilora_kernel``."""
    import math

    import torch

    from repro_torch.kernels import dim_agg as DK
    from repro_torch.kernels import grouped_lora_matmul as glm

    trainer = fed_setup("fedilora_kernel")
    n_params = sum(v.numel() for v in _leaves(trainer.base_params))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    glm.reset_launches()
    DK.reset_launches()
    walls, recs, syncs = [], [], []
    for _ in range(TRAIN_ROUNDS):
        # every synchronising CUDA call warns; record where each came from
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            t0 = time.perf_counter()
            recs.append(trainer.run_round())
            walls.append(time.perf_counter() - t0)
            torch.cuda.set_sync_debug_mode("default")
        syncs.append([f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}"
                      for w in caught if "synchroniz" in str(w.message)])
    # after the first round (one-time set-up) a round makes exactly one
    # host sync: its metrics fetch
    if not syncs[0] or any(len(s_) != 1 for s_ in syncs[1:]):
        raise AssertionError(f"host syncs per round {syncs}, expected one "
                             "(the metrics fetch) after the first round")
    t0 = time.perf_counter()
    ev = trainer.evaluate_global(n=32)
    eval_s = time.perf_counter() - t0
    launches = dict(DK.launches)
    if glm.launches:
        raise AssertionError("the train path launched the BGMV kernel")
    for rec in recs:
        if not math.isfinite(rec["train_loss"]):
            raise AssertionError(f"round {rec['round']}: loss "
                                 f"{rec['train_loss']}")
        if len(rec["edited_layers"]) != len(rec["sampled"]):
            raise AssertionError(f"round {rec['round']}: edited "
                                 f"{rec['edited_layers']} for sampled "
                                 f"{rec['sampled']}")
    want = TRAIN_ROUNDS
    if launches["dim_agg"] != want or launches["dim_agg_trimmed"]:
        raise AssertionError(f"dim_agg launches {launches}, expected "
                             f"{want} dim_agg (one a round over the tree "
                             "of 2 sites x A, B) and no trimmed")
    if not all(math.isfinite(ev[k]) for k in ("loss", "bleu", "rsum")):
        raise AssertionError(f"evaluate_global: {ev}")
    prof = profile_round(trainer)
    out = {"model": "fedbench-100m", "params": n_params, "profile": prof,
           "rounds": recs, "round_wall_s": walls, "host_syncs": syncs,
           "rounds_per_s": TRAIN_ROUNDS / sum(walls),
           "eval_global": ev, "eval_wall_s": eval_s,
           "launches": launches,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    print(f"train (smoke run, not a benchmark): fedbench-100m f32 "
          f"{n_params / 1e6:.1f}M params, {TRAIN_ROUNDS} rounds x 4 clients "
          f"x 10 steps, losses "
          f"{[round(r['train_loss'], 4) for r in recs]}, round walls "
          f"{[round(w, 3) for w in walls]} s ({out['rounds_per_s']:.3f} "
          f"rounds/s, the first includes warm-up), host syncs per round "
          f"{syncs}, eval_global "
          f"{ev} in {eval_s:.2f} s, dim_agg launches {launches['dim_agg']}, "
          f"peak {out['peak_mem_gb']:.2f} GB", flush=True)
    return out


def _profiled(fn, what: str, kernel_keys=()) -> dict:
    """Run ``fn()`` under ``torch.profiler``: its wall, the device time
    summed over its kernels, copies and memsets (the busy share is that
    over the wall), the share of the device time in the kernels whose names
    hold one of ``kernel_keys``, and the largest device rows."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side events only (kernels, copies, memsets), summed by name
    # from the raw trace: the CPU op rows report their kernels' time again,
    # and building the profiler's event tree (``key_averages``) takes
    # minutes for a round's 10^5-10^6 events
    t0 = time.perf_counter()
    by_name: dict = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            n, t = by_name.get(e.name(), (0, 0))
            by_name[e.name()] = (n + 1, t + e.duration_ns())
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    device_s = sum(t for _, (_, t) in rows) / 1e9
    mine = [(n, c) for n, c in rows if any(k in n for k in kernel_keys)]
    mine_s = sum(t for _, (_, t) in mine) / 1e9
    out = {"wall_s": wall, "device_s": device_s,
           "device_busy_share": device_s / wall,
           "summary_s": time.perf_counter() - t0,
           "kernel_launches": sum(c for _, (c, _) in rows),
           "top": [{"name": n[:80], "count": c, "device_ms": t / 1e6}
                   for n, (c, t) in rows[:8]]}
    if kernel_keys:
        out.update({"kernels": list(kernel_keys), "kernels_device_s": mine_s,
                    "kernels_launches": sum(c for _, (c, _) in mine),
                    "kernels_device_share": mine_s / max(device_s, 1e-12)})
    print(f"profile ({what}, profiler on): wall {wall:.3f} s, device "
          f"{device_s:.3f} s busy ({out['device_busy_share']:.1%}), "
          f"{out['kernel_launches']} kernel launches (summed in "
          f"{out['summary_s']:.1f} s)"
          + (f"; {'/'.join(kernel_keys)} {mine_s * 1e3:.1f} ms "
             f"({out['kernels_device_share']:.1%} of the device time) over "
             f"{out['kernels_launches']} launches" if kernel_keys else "")
          + "; top: "
          + "; ".join(f"{t['name'][:40]} {t['device_ms']:.1f} ms x"
                      f"{t['count']}" for t in out["top"][:4]), flush=True)
    return out


def profile_round(trainer) -> dict:
    """One more round under ``torch.profiler`` (after the counted rounds)."""
    return _profiled(trainer.run_round, "one round")


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def _adapter_err(a, b) -> dict:
    """Largest |a - b| and whether every element is within atol 1e-5 +
    rtol 1e-4 of b."""
    worst, ok = 0.0, True
    for n in b:
        for m in ("A", "B"):
            d = (a[n][m] - b[n][m]).abs()
            worst = max(worst, d.max().item())
            ok &= bool((d <= 1e-5 + 1e-4 * b[n][m].abs()).all())
    return {"max_abs_err": worst, "within_tol": ok}


def _sync_adapters(dst, src) -> None:
    """Give trainer ``dst`` copies of ``src``'s adapters (global, previous
    global, stacked clients)."""
    import torch

    def clone(tree):
        return {n: {m: torch.clone(e[m]) for m in ("A", "B")}
                for n, e in tree.items()}

    dst.server.global_lora = clone(src.server.global_lora)
    dst.server.prev_global = clone(src.server.prev_global)
    dst.stacked_lora = clone(src.stacked_lora)


def phase_train_agreement() -> dict:
    """Kernel and plain aggregators in two trainers from one seed.  After
    each round the plain trainer takes the kernel trainer's adapters, so
    every round compares the two aggregations from one starting state:
    the plain entries return strided (non-contiguous) adapters, the next
    round's GEMMs then round differently in the last bit, and AdamW (which
    divides by each gradient's magnitude) grows that into 1e-4 by the
    second round."""
    from repro_torch.kernels import dim_agg as DK

    out = {}
    for kern, plain, rounds, kw in [
            ("fedilora_kernel", "fedilora", 3, {}),
            ("fedilora_trimmed_kernel", "fedilora_trimmed", 2,
             {"trim_frac": 0.25})]:
        a = fed_setup(kern, **kw)
        b = fed_setup(plain, base=a.base_params, **kw)
        DK.reset_launches()
        errs = []
        for _ in range(rounds):
            ra, rb = a.run_round(), b.run_round()
            if ra["sampled"] != rb["sampled"]:
                raise AssertionError(f"{kern}: cohorts {ra['sampled']} vs "
                                     f"{rb['sampled']}")
            errs.append(_adapter_err(a.server.global_lora,
                                     b.server.global_lora))
            _sync_adapters(b, a)
        launches = dict(DK.launches)
        out[kern] = {"rounds": rounds, "errors": errs, "launches": launches}
        print(f"agreement: {kern} vs {plain}, {rounds} round(s): global "
              f"adapter max err {[e['max_abs_err'] for e in errs]}, "
              f"launches {launches}", flush=True)
        if not all(e["within_tol"] for e in errs):
            raise AssertionError(f"{kern} vs {plain}: global adapters differ "
                                 f"beyond atol 1e-5 + rtol 1e-4: {errs}")
        key = "dim_agg_trimmed" if "trimmed" in kern else "dim_agg"
        if launches[key] != rounds:
            raise AssertionError(f"{kern}: launches {launches}, expected "
                                 f"{rounds} {key} (one a round)")
    return out


# the faults phase: dropout, stragglers, NaN on the wire and one Byzantine
# client (7, sampled in both rounds of fed_setup's cohorts), drawn so that
# the two rounds hold each kind at least once; the clip norm sits inside
# fedbench-100m's adapter norms (about 48 at rank 4 to 136 at rank 32), so
# the clients of rank >= 16 are clipped
SMOKE_FAULTS = dict(enabled=True, dropout_rate=0.2, straggler_rate=0.2,
                    corrupt_rate=0.3, corrupt_mode="nan",
                    byzantine_clients=(7,), seed=19)
FAULT_ROUNDS, FAULT_CLIP = 2, 90.0
# the timelines phase: pipelined and blocking rounds, async ticks
PIPELINED_ROUNDS, ASYNC_TICKS = 3, 6
ASYNC_DELAYS = (0, 1, 0, 2, 0, 1, 0, 2, 0, 1)


def _round_synced(call):
    """Run ``call()`` (a round, which ends in its blocking fetch) and record
    the host syncs it made, by source."""
    import torch
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            t0 = time.perf_counter()
            rec = call()
            wall = time.perf_counter() - t0
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}"
             for w in caught if "synchroniz" in str(w.message)]
    return rec, wall, syncs


def _finite(tree) -> bool:
    return all(bool(x.isfinite().all()) for x in _leaves(tree))


def phase_faults() -> dict:
    """Faulted rounds on fedbench-100m through ``fedilora_trimmed_kernel``
    (trim 0.25) and ``fedilora_clip_kernel`` (clip 90), two rounds each,
    beside the plain aggregators under the same faults from one shared
    state each round; then one round in which every client drops."""
    import numpy as np
    import torch

    from repro_torch.federated import FaultConfig, FaultSchedule
    from repro_torch.kernels import dim_agg as DK

    faults = FaultConfig(**SMOKE_FAULTS)
    schedule = FaultSchedule(faults, 10)
    out, base = {}, None
    for kern, plain, key, kw in [
            ("fedilora_trimmed_kernel", "fedilora_trimmed", "dim_agg_trimmed",
             {"trim_frac": 0.25}),
            ("fedilora_clip_kernel", "fedilora_clip", "dim_agg",
             {"clip_norm": FAULT_CLIP})]:
        a = fed_setup(kern, base=base, faults=faults, **kw)
        base = a.base_params
        b = fed_setup(plain, base=base, faults=faults, **kw)
        DK.reset_launches()
        rows = []
        for t in range(FAULT_ROUNDS):
            before = {n: {m: e[m].clone() for m in ("A", "B")}
                      for n, e in a.stacked_lora.items()}
            ra, wall, syncs = _round_synced(a.run_round)
            rb = b.run_round()
            co = schedule.cohort(t, ra["sampled"])
            alive = (co["keep"] > 0) & (co["weight"] > 0)
            want = {"n_dropped": float(co["n_dropped"]),
                    "n_forfeited": float(co["n_forfeited"]),
                    "n_nonfinite": float((alive & np.isnan(co["nan"])).sum())}
            got = {k: ra["health"][k] for k in want}
            if got != want or {k: rb["health"][k] for k in want} != want:
                raise AssertionError(f"{kern} round {t}: health {ra['health']}"
                                     f" (plain {rb['health']}), the schedule "
                                     f"drew {want}")
            if ra["sampled"] != rb["sampled"]:
                raise AssertionError(f"{kern}: cohorts {ra['sampled']} vs "
                                     f"{rb['sampled']}")
            dropped = [k for i, k in enumerate(ra["sampled"])
                       if co["keep"][i] <= 0]
            for k in dropped:
                for n, e in a.stacked_lora.items():
                    for m in ("A", "B"):
                        if not torch.equal(e[m][k], before[n][m][k]):
                            raise AssertionError(f"{kern}: dropped client {k}"
                                                 f"'s stored {n}.{m} moved")
            if not _finite(a.server.global_lora):
                raise AssertionError(f"{kern} round {t}: global not finite")
            if DK.launches[key] != t + 1:
                raise AssertionError(f"{kern} round {t}: launches "
                                     f"{dict(DK.launches)}, expected {t + 1} "
                                     f"{key}")
            if t > 0 and len(syncs) != 1:
                raise AssertionError(f"{kern} round {t}: host syncs {syncs}, "
                                     "expected one (the metrics fetch)")
            err = _adapter_err(a.server.global_lora, b.server.global_lora)
            rows.append({"round": t, "sampled": ra["sampled"],
                         "health": ra["health"], "dropped": dropped,
                         "wall_s": wall, "host_syncs": syncs, **err})
            _sync_adapters(b, a)
        if not all(r["within_tol"] for r in rows):
            raise AssertionError(f"{kern} vs {plain} under faults: {rows}")
        if key == "dim_agg" and a.health["clip_rate_sum"] <= 0:
            raise AssertionError(f"{kern}: nothing was clipped ({a.health})")
        out[kern] = {"rounds": rows, "health": dict(a.health),
                     "launches": dict(DK.launches)}
        print(f"faults: {kern} vs {plain}, {FAULT_ROUNDS} faulted rounds: "
              f"health {[r['health'] for r in rows]}, dropped "
              f"{[r['dropped'] for r in rows]} kept their state, global err "
              f"{[r['max_abs_err'] for r in rows]}, launches "
              f"{dict(DK.launches)}, host syncs {[r['host_syncs'] for r in rows]}",
              flush=True)
    gone = fed_setup("fedilora_kernel", base=base,
                     faults=FaultConfig(enabled=True, dropout_rate=1.0))
    g0 = {n: {m: e[m].clone() for m in ("A", "B")}
          for n, e in gone.server.global_lora.items()}
    DK.reset_launches()
    rec = gone.run_round()
    if rec["health"]["n_dropped"] != 4.0 or \
            _adapter_err(gone.server.global_lora, g0)["max_abs_err"] != 0.0:
        raise AssertionError(f"all-dropped round moved the global: {rec}")
    out["all_dropped"] = {"health": rec["health"],
                          "launches": dict(DK.launches)}
    print(f"faults: an all-dropped round kept the global bit for bit "
          f"(health {rec['health']})", flush=True)
    out["launches"] = {
        "dim_agg_trimmed": out["fedilora_trimmed_kernel"]["launches"][
            "dim_agg_trimmed"],
        "dim_agg": out["fedilora_clip_kernel"]["launches"]["dim_agg"]
        + out["all_dropped"]["launches"]["dim_agg"]}
    return out


def _expected_async(recs, delays, M: int, schedule) -> list:
    """The reference's async bookkeeping replayed on the host from the
    ticks' cohorts: each tick's merges, staleness list and deferred count,
    and whether every cohort was drawn from idle clients."""
    inflight, buffer, version, out = [], [], 0, []
    for rec in recs:
        tick, deferred = rec["tick"], 0
        busy = {c for c, _, _ in inflight}
        idle = not set(rec["sampled"]) & busy
        if rec["sampled"]:
            co = schedule.cohort(tick, rec["sampled"])
            deferred = int(co["n_forfeited"])
            for i, k in enumerate(rec["sampled"]):
                if co["keep"][i] > 0:
                    inflight.append((k, version, tick + delays[k]
                                     + int(co["extra_ticks"][i])))
        buffer += [e for e in inflight if e[2] <= tick]
        inflight = [e for e in inflight if e[2] > tick]
        stal = []
        while len(buffer) >= M:
            batch, buffer = buffer[:M], buffer[M:]
            stal += [float(version - v) for _, v, _ in batch]
            version += 1
        out.append({"merges": len(stal) // M, "staleness": stal,
                    "n_deferred": deferred, "idle": idle})
    return out


def phase_timelines() -> dict:
    """fedbench-100m through ``fedilora_kernel``: pipelined rounds against
    blocking ones, the reference host loop against the fused round, and
    the buffered-async timeline through ``fedbuff_kernel``, at zero delays
    against the synchronous round, then with delays, a buffer of 2 and the
    faults phase's fault configuration."""
    import torch

    from repro_torch.federated import FaultConfig, FaultSchedule
    from repro_torch.kernels import dim_agg as DK

    def same_record(x, y, what, loss_tol):
        for k in ("round", "sampled", "edited_layers"):
            if x[k] != y[k]:
                raise AssertionError(f"{what}: {k} {x[k]} vs {y[k]}")
        if abs(x["train_loss"] - y["train_loss"]) > loss_tol:
            raise AssertionError(f"{what}: loss {x['train_loss']} vs "
                                 f"{y['train_loss']}")

    out = {}
    # ---- pipelined against blocking
    a = fed_setup("fedilora_kernel")
    base = a.base_params
    b = fed_setup("fedilora_kernel", base=base)
    DK.reset_launches()
    piped, pipe_walls = [], []
    torch.cuda.synchronize()
    t_all = time.perf_counter()
    for _ in range(PIPELINED_ROUNDS):
        t0 = time.perf_counter()
        piped.append(a.run_round_pipelined())
        pipe_walls.append(time.perf_counter() - t0)
    piped.append(a.flush_rounds())
    torch.cuda.synchronize()
    pipe_total = time.perf_counter() - t_all
    block_walls, blocked = [], []
    t_all = time.perf_counter()
    for _ in range(PIPELINED_ROUNDS):
        t0 = time.perf_counter()
        blocked.append(b.run_round())
        block_walls.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    block_total = time.perf_counter() - t_all
    if piped[0] is not None:
        raise AssertionError("the first pipelined call returned a record")
    for x, y in zip(piped[1:], blocked):
        same_record(x, y, "pipelined vs blocking", 1e-5)
    pipe_err = _adapter_err(a.server.global_lora, b.server.global_lora)
    if not pipe_err["within_tol"] or \
            DK.launches["dim_agg"] != 2 * PIPELINED_ROUNDS:
        raise AssertionError(f"pipelined vs blocking: {pipe_err}, launches "
                             f"{dict(DK.launches)}")
    out["pipelined"] = {"records": piped[1:], "pipelined_call_wall_s":
                        pipe_walls, "blocking_round_wall_s": block_walls,
                        "pipelined_total_s": pipe_total,
                        "blocking_total_s": block_total, **pipe_err,
                        "bit_equal": pipe_err["max_abs_err"] == 0.0}
    print(f"timelines: {PIPELINED_ROUNDS} pipelined rounds + flush == "
          f"{PIPELINED_ROUNDS} blocking rounds (global max err "
          f"{pipe_err['max_abs_err']}); calls {[round(w, 3) for w in pipe_walls]}"
          f" s (total {pipe_total:.3f} s with the flush) vs rounds "
          f"{[round(w, 3) for w in block_walls]} s (total {block_total:.3f}"
          " s)", flush=True)

    # ---- the reference host loop against the fused round
    c = fed_setup("fedilora_kernel", base=base)
    d = fed_setup("fedilora_kernel", base=base)
    t0 = time.perf_counter()
    rr = c.run_round_reference()
    ref_wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    rf = d.run_round()
    fused_wall = time.perf_counter() - t0
    same_record(rr, rf, "reference loop vs fused round", 1e-4)
    errs = {what: max(_adapter_err(x, y)["max_abs_err"] for x, y in pairs)
            for what, pairs in (
                ("global", [(c.server.global_lora, d.server.global_lora)]),
                ("stacked", [(c.stacked_lora, d.stacked_lora)]))}
    if max(errs.values()) > 5e-4:
        raise AssertionError(f"reference loop vs fused round: {errs}")
    out["reference"] = {"errors": errs, "reference_wall_s": ref_wall,
                        "fused_wall_s": fused_wall}
    print(f"timelines: run_round_reference == run_round (cohort "
          f"{rr['sampled']}, edits {rr['edited_layers']}, max err {errs}); "
          f"walls {ref_wall:.3f} s vs {fused_wall:.3f} s", flush=True)

    # ---- async at zero delays against the synchronous round
    e = fed_setup("fedbuff_kernel", base=base)
    f = fed_setup("fedilora_kernel", base=base)
    zero = []
    for t in range(2):
        DK.reset_launches()
        t0 = time.perf_counter()
        ra = e.run_round_async()
        torch.cuda.synchronize()
        tick_wall = time.perf_counter() - t0
        merges = DK.launches["dim_agg"]
        rs = f.run_round()
        if ra["sampled"] != rs["sampled"] or ra["merges"] != 1 or \
                merges != 1 or ra["staleness"] != [0.0] * 4:
            raise AssertionError(f"async tick {t} vs round: {ra} vs {rs}, "
                                 f"{merges} launches")
        err = _adapter_err(e.server.global_lora, f.server.global_lora)
        if not err["within_tol"]:
            raise AssertionError(f"async tick {t} vs round: {err}")
        zero.append({"tick_wall_s": tick_wall, **err})
        _sync_adapters(f, e)
    out["async_zero_delays"] = zero

    # ---- async with delays, a buffer of 2 and the faults
    faults = FaultConfig(**SMOKE_FAULTS)
    g = fed_setup("fedbuff_kernel", base=base, buffer_size=2,
                  async_delays=ASYNC_DELAYS, faults=faults)
    recs, walls, launches = [], [], []
    for _ in range(ASYNC_TICKS):
        DK.reset_launches()
        t0 = time.perf_counter()
        recs.append(g.run_round_async())
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        launches.append(DK.launches["dim_agg"])
    want = _expected_async(recs, ASYNC_DELAYS, 2, FaultSchedule(faults, 10))
    for rec, w, n in zip(recs, want, launches):
        got = {"merges": rec["merges"], "staleness": rec["staleness"],
               "n_deferred": rec.get("health", {}).get("n_deferred", 0),
               "idle": True}
        if got != w or n != rec["merges"]:
            raise AssertionError(f"async tick {rec['tick']}: {got}, "
                                 f"{n} launches; the reference's "
                                 f"bookkeeping gives {w}")
    if not _finite(g.server.global_lora) or g.health["n_deferred"] <= 0 \
            or sum(launches) == 0:
        raise AssertionError(f"async with faults: health {dict(g.health)}, "
                             f"launches {launches}")
    out["async_delays"] = {"ticks": recs, "tick_wall_s": walls,
                           "launches": launches, "health": dict(g.health)}
    out["launches"] = {"dim_agg": 2 * PIPELINED_ROUNDS + len(zero)
                       + sum(launches)}
    print(f"timelines: async at zero delays == sync (max err "
          f"{[z['max_abs_err'] for z in zero]}, tick walls "
          f"{[round(z['tick_wall_s'], 3) for z in zero]} s); with delays, "
          f"buffer 2 and faults: merges {[r['merges'] for r in recs]}, "
          f"staleness {[r['staleness'] for r in recs]}, health "
          f"{dict(g.health)}, dim_agg launches {launches} (one a merge), "
          f"tick walls {[round(w, 3) for w in walls]} s", flush=True)
    return out


# the population phase: the paged client store at K = 10 (a bank of 4
# slots, so cohorts of 4 evict), the hosted population of 10^5 clients
# aliasing 4 synthetic shards (cohort and bank of 8), and the spill tier
PAGED_SLOTS, SPILL_HOST_SLOTS = 4, 4
POP_K, POP_COHORT, POP_ROUNDS, POP_SHARDS = 100_000, 8, 3, 4
FLORA_ROUNDS = 2
# the checkpoint phase's async delays (0-2): drawn so that the cohort of
# tick 1 retires in its own tick and nothing is in flight when the phase
# saves after tick 1 (a paged trainer with pinned rows refuses to save, as
# the reference's does); ticks 2 and 3 run clients of delay 1 and 2
CHECKPOINT_DELAYS = (0, 0, 2, 2, 1, 1, 2, 0, 2, 0)
CHECKPOINT_TICKS, CHECKPOINT_SLOTS = 2, 8


def _recording(trainer) -> list:
    """``(name, output)`` of every call ``trainer`` dispatches from now on."""
    calls, orig = [], trainer._dispatch

    def dispatch(name, fn, *args, **kw):
        out = orig(name, fn, *args, **kw)
        calls.append((name, out))
        return out

    trainer._dispatch = dispatch
    return calls


def _max_diff(a, b) -> float:
    """Largest |a - b| over two adapter trees (tensors or numpy)."""
    import torch
    worst = 0.0
    for n in b:
        for m in ("A", "B"):
            x, y = (torch.as_tensor(t).cpu() for t in (a[n][m], b[n][m]))
            worst = max(worst, (x - y).abs().max().item())
    return worst


def _clients_diff(a, b) -> float:
    """Largest |a - b| over every exported client adapter of two trainers
    (their ranks must be equal)."""
    ea, eb = a.export_adapters(), b.export_adapters()
    if {k: r for k, (_, r) in ea.items()} != {k: r for k, (_, r) in
                                              eb.items()}:
        raise AssertionError("exported ranks differ")
    return max(_max_diff(ea[k][0], eb[k][0]) for k in ea)


def _same_integers(ra, rb, what: str) -> None:
    keys = [k for k in ra if k != "train_loss"]
    if [ra[k] for k in keys] != [rb.get(k) for k in keys]:
        raise AssertionError(f"{what}: {ra} vs {rb}")


def phase_population() -> dict:
    """Paged equals resident at K = 10 (2 rounds, 1 pipelined round and
    its flush, 1 trimmed round; then the paged sweep); the hosted
    population of 10^5 clients; the spill tier."""
    import shutil

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.editing import EditConfig
    from repro_torch.data import SyntheticTaskConfig, make_federated_datasets
    from repro_torch.federated import FederatedConfig, FederatedTrainer
    from repro_torch.kernels import dim_agg as DK
    from repro_torch.optim import OptimizerConfig

    out, total = {}, {"dim_agg": 0, "dim_agg_trimmed": 0}

    def counted(call, key):
        """Run ``call`` (a round), its wall and its launches of ``key``."""
        n0 = {k: DK.launches[k] for k in total}
        t0 = time.perf_counter()
        rec = call()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {k: DK.launches[k] - n0[k] for k in total}
        for k in total:
            total[k] += got[k]
        return rec, wall, got[key]

    # ---- paged == resident at K = 10, from one initial state
    DK.reset_launches()
    runs, base, snap = {}, None, None
    calls = ("run_round", "run_round", "run_round_pipelined", "flush_rounds")
    for mode in ("paged", "resident"):
        kw = ({"paged": True, "store_slots": PAGED_SLOTS} if mode == "paged"
              else {})
        tr = fed_setup("fedilora_kernel", base=base, **kw)
        base = tr.base_params
        recs, walls = [], []
        for i, call in enumerate(calls):
            rec, wall, n = counted(getattr(tr, call), "dim_agg")
            if n != (0 if call == "flush_rounds" else 1):
                raise AssertionError(f"{mode} {call}: {n} dim_agg launches")
            walls.append(wall)
            if rec is not None:
                recs.append(rec)
            if mode == "resident" and i == 1:
                # the state after 2 rounds, for the spill tier's check
                snap = {n_: {m: e[m].clone() for m in ("A", "B")}
                        for n_, e in tr.stacked_lora.items()}
        trim = fed_setup("fedilora_trimmed_kernel", base=base, trim_frac=0.25,
                         **kw)
        rec, wall, n = counted(trim.run_round, "dim_agg_trimmed")
        if n != 1:
            raise AssertionError(f"{mode} trimmed round: {n} launches")
        runs[mode] = {"trainer": tr, "trim": trim, "records": recs,
                      "trim_record": rec, "walls": walls, "trim_wall": wall}
    p, r = runs["paged"], runs["resident"]
    loss_diff = 0.0
    for ra, rb in zip(p["records"] + [p["trim_record"]],
                      r["records"] + [r["trim_record"]]):
        _same_integers(ra, rb, "paged vs resident")
        loss_diff = max(loss_diff, abs(ra["train_loss"] - rb["train_loss"]))
    for x, y in ((p["trainer"], r["trainer"]), (p["trim"], r["trim"])):
        if list(x.client_ranks) != list(y.client_ranks):
            raise AssertionError("paged vs resident: ranks differ")
    errs = {"loss": loss_diff,
            "global": _max_diff(p["trainer"].server.global_lora,
                                r["trainer"].server.global_lora),
            "clients": _clients_diff(p["trainer"], r["trainer"]),
            "trim_global": _max_diff(p["trim"].server.global_lora,
                                     r["trim"].server.global_lora),
            "trim_clients": _clients_diff(p["trim"], r["trim"])}
    gerr = _adapter_err(p["trainer"].server.global_lora,
                        r["trainer"].server.global_lora)
    if loss_diff > 1e-5 or not gerr["within_tol"] or \
            max(errs.values()) > 5e-4:
        raise AssertionError(f"paged vs resident: {errs}")
    store = p["trainer"].store
    out["paged_vs_resident"] = {
        "records": p["records"], "errors": errs,
        "paged_walls_s": p["walls"], "resident_walls_s": r["walls"],
        "trim_walls_s": [p["trim_wall"], r["trim_wall"]],
        "paging": store.paging_stats, "page_in": int(
            p["trainer"].dispatch_count["page_in"]),
        "device_bytes": store.device_bytes(), "host_bytes": store.host_bytes()}
    print(f"population: paged (bank {PAGED_SLOTS}) == resident at K = 10 "
          f"over 2 rounds, a pipelined round + flush and a trimmed round: "
          f"cohorts, ranks and edits equal, largest differences {errs} "
          f"(0 = bit for bit); paged walls "
          f"{[round(w, 3) for w in p['walls']]} s vs resident "
          f"{[round(w, 3) for w in r['walls']]} s; paging "
          f"{store.paging_stats}", flush=True)

    # ---- the paged sweep against the resident one: the same tokens
    sweeps = {}
    for mode, tr in (("paged", p["trainer"]), ("resident", r["trainer"])):
        rec_calls = _recording(tr)
        t0 = time.perf_counter()
        ev = tr.evaluate_personalized(n=4, loss_n=8)
        wall = time.perf_counter() - t0
        gens = torch.cat([o["gen"].cpu() for name, o in rec_calls
                          if name == "population_eval"])[:10]
        sweeps[mode] = {"eval": ev, "wall_s": wall, "gen": gens,
                        "calls": sum(n == "population_eval"
                                     for n, _ in rec_calls)}
    if not torch.equal(sweeps["paged"]["gen"], sweeps["resident"]["gen"]) \
            or sweeps["paged"]["calls"] != 3:
        raise AssertionError(f"paged sweep: tokens differ or "
                             f"{sweeps['paged']['calls']} tiles")
    out["sweep"] = {m: {k: v for k, v in s.items() if k != "gen"}
                    for m, s in sweeps.items()}
    print(f"population: the paged sweep (3 tiles of {PAGED_SLOTS}) gives "
          f"the resident sweep's tokens; {sweeps['paged']['eval']} in "
          f"{sweeps['paged']['wall_s']:.2f} s vs "
          f"{sweeps['resident']['wall_s']:.2f} s", flush=True)

    # ---- a hosted population of 10^5 clients over 4 shards
    task = SyntheticTaskConfig(seed=1)
    pool, gtest = make_federated_datasets(task, POP_SHARDS,
                                          np.array([24] * POP_SHARDS), seed=1)
    data = [pool[k % POP_SHARDS] for k in range(POP_K)]
    t0 = time.perf_counter()
    big = FederatedTrainer(
        get_config("fedbench-100m"),
        FederatedConfig(num_clients=POP_K, sample_rate=POP_COHORT / POP_K,
                        ranks=tuple(TRAIN_RANKS[k % 10]
                                    for k in range(POP_K)),
                        local_steps=10, batch_size=8,
                        aggregator="fedilora_kernel", edit=EditConfig(),
                        paged=True, store_slots=POP_COHORT),
        OptimizerConfig(peak_lr=1e-3, total_steps=POP_ROUNDS * 10),
        data, data, gtest, base_params=base)
    build_s = time.perf_counter() - t0
    walls, recs = [], []
    for _ in range(POP_ROUNDS):
        rec, wall, n = counted(big.run_round, "dim_agg")
        if n != 1 or not math.isfinite(rec["train_loss"]):
            raise AssertionError(f"population round: {rec}, {n} launches")
        walls.append(wall)
        recs.append(rec)
    st = big.store
    pop = {"clients": POP_K, "cohort": POP_COHORT, "build_s": build_s,
           "round_walls_s": walls, "records": recs,
           "device_bytes": st.device_bytes(), "host_bytes": st.host_bytes(),
           "peak_resident": st.peak_resident,
           "materialized": len(st.materialized_ids),
           "page_in": int(big.dispatch_count["page_in"]),
           "round_step": int(big.dispatch_count["round_step"]),
           "paging": st.paging_stats}
    if pop["peak_resident"] > POP_COHORT or \
            pop["materialized"] > POP_ROUNDS * POP_COHORT or \
            pop["round_step"] != POP_ROUNDS:
        raise AssertionError(f"population of {POP_K}: {pop}")
    out["population"] = pop
    print(f"population: K = {POP_K} clients over {POP_SHARDS} shards, "
          f"cohort and bank {POP_COHORT}: built in {build_s:.2f} s, round "
          f"walls {[round(w, 3) for w in walls]} s, device bytes "
          f"{pop['device_bytes']}, host bytes {pop['host_bytes']}, peak "
          f"resident {pop['peak_resident']}, materialised "
          f"{pop['materialized']}, page_in {pop['page_in']}, round_step "
          f"{pop['round_step']}", flush=True)
    del big, data

    # ---- the spill tier: 2 rounds with 4 host slots
    spill_dir = os.path.join(ROOT, "build", "chip_smoke_spill")
    shutil.rmtree(spill_dir, ignore_errors=True)
    sp = fed_setup("fedilora_kernel", base=base, paged=True,
                   store_slots=PAGED_SLOTS, store_host_slots=SPILL_HOST_SLOTS,
                   store_spill_dir=spill_dir)
    for _ in range(2):
        counted(sp.run_round, "dim_agg")
    spilled = sorted(sp.store._spilled)
    if not spilled:
        raise AssertionError("the spill tier spilled nothing")
    k = spilled[0]
    back = sp.store.host_adapter(k)              # read from its npz file
    err = _max_diff(back, {n: {m: e[m][k] for m in ("A", "B")}
                           for n, e in snap.items()})
    if err > 5e-4 or sp.store.spill_loads != 1:
        raise AssertionError(f"spilled client {k} read back {err} off")
    out["spill"] = {"spilled": spilled, "client": k, "max_abs_err": err,
                    "spills": sp.store.spills,
                    "files": sorted(os.listdir(spill_dir))}
    print(f"population: spill tier ({SPILL_HOST_SLOTS} host slots) spilled "
          f"clients {spilled}; client {k} read back from disk within {err} "
          "of the resident trainer's", flush=True)
    out["launches"] = dict(total)
    out["resident"] = r["trainer"]
    return out


def _site(params, name: str):
    """The base weight a LoRA spec adapts (``[L, in, out]``)."""
    sub, rest = name.split(".", 1)
    node = params["blocks"][sub]
    for part in rest.split("."):
        node = node[part]
    return node


def phase_flora(base) -> dict:
    """FLoRA rounds on fedbench-100m (its own copy of the base weights,
    which FLoRA changes in place): the base weights' change equals the
    dense delta computed in f64 from the clients' adapters, losses and the
    global evaluation finite, no aggregation kernel launched."""
    import numpy as np
    import torch

    from repro_torch.kernels import dim_agg as DK

    tr = fed_setup("flora", base={k: _clone_tree(v) for k, v in base.items()})
    DK.reset_launches()
    rows = []
    for t in range(FLORA_ROUNDS):
        names = [s.name for s in tr.specs]
        before = {n: _site(tr.base_params, n).clone() for n in names}
        t0 = time.perf_counter()
        rec = tr.run_round()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ks = torch.tensor(rec["sampled"], device=before[names[0]].device)
        sizes = np.asarray([tr.clients[k].size for k in rec["sampled"]],
                           np.float64)
        pk = torch.tensor(sizes / sizes.sum(), dtype=torch.float64,
                          device=ks.device)
        rel = 0.0
        for n in names:
            e = tr.stacked_lora[n]
            want = tr.lora_scale * torch.einsum(
                "k,klor,klri->lio", pk, e["B"][ks].double(),
                e["A"][ks].double())
            moved = _site(tr.base_params, n).double() - before[n].double()
            rel = max(rel, ((moved - want).abs().max()
                            / want.abs().max()).item())
        if rel > 1e-5 or not math.isfinite(rec["train_loss"]):
            raise AssertionError(f"FLoRA round {t}: base change {rel} off "
                                 f"the f64 delta (relative), {rec}")
        rows.append({"record": rec, "wall_s": wall, "delta_rel_err": rel})
    ev = tr.evaluate_global(n=32)
    if not all(math.isfinite(ev[k]) for k in ("loss", "bleu", "rsum")):
        raise AssertionError(f"FLoRA evaluate_global: {ev}")
    if any(DK.launches.values()):
        raise AssertionError(f"FLoRA launched {dict(DK.launches)}")
    print(f"flora: {FLORA_ROUNDS} rounds, walls "
          f"{[round(x['wall_s'], 3) for x in rows]} s, losses "
          f"{[round(x['record']['train_loss'], 4) for x in rows]}, base "
          f"change vs the f64 dense delta (relative) "
          f"{[x['delta_rel_err'] for x in rows]}, evaluate_global {ev}, no "
          "aggregation kernel launched", flush=True)
    return {"rounds": rows, "eval_global": ev,
            "launches": dict(DK.launches)}


def _clone_tree(tree):
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    return tree.clone()


def _host_state(tr) -> dict:
    return {"rng": tr.rng.bit_generator.state,
            "client_rng": [c.rng.bit_generator.state for c in tr.clients],
            "health": {k: float(v) for k, v in tr.health.items()},
            "version": tr._global_version, "tick": tr._async_tick,
            "round": tr.server.round, "ranks": list(map(int, tr.client_ranks))}


def phase_checkpoint(base) -> dict:
    """The faults phase's faults under ``run_round_async`` (delays 0-2, a
    buffer of 2) on a paged trainer: a save with a cohort in flight is
    refused; after tick 1 it saves, runs 2 more ticks, and a fresh paged
    trainer loaded from the save runs the same 2 ticks."""
    import shutil

    from repro_torch.checkpoint import load_federated, save_federated
    from repro_torch.federated import FaultConfig
    from repro_torch.kernels import dim_agg as DK

    kw = dict(faults=FaultConfig(**SMOKE_FAULTS), buffer_size=2,
              async_delays=CHECKPOINT_DELAYS, paged=True,
              store_slots=CHECKPOINT_SLOTS)
    d = os.path.join(ROOT, "build", "chip_smoke_ckpt")
    shutil.rmtree(d, ignore_errors=True)
    DK.reset_launches()
    a = fed_setup("fedbuff_kernel", base=base, **kw)
    a.run_round_async()
    pinned = a.store.pinned_ids
    try:
        save_federated(d, a)
    except ValueError:
        refused = True
    else:
        refused = False
    if not pinned or not refused or os.path.exists(d):
        raise AssertionError(f"a save with pinned rows {pinned} was not "
                             "refused")
    for _ in range(CHECKPOINT_TICKS - 1):
        a.run_round_async()
    if a.store.pinned_ids:
        raise AssertionError(f"pinned at the save: {a.store.pinned_ids}")
    t0 = time.perf_counter()
    save_federated(d, a)
    save_s = time.perf_counter() - t0
    saved = _host_state(a)
    n_buffered = len(a._buffer)
    after_a = [a.run_round_async() for _ in range(CHECKPOINT_TICKS)]
    b = fed_setup("fedbuff_kernel", base=base, **kw)
    t0 = time.perf_counter()
    load_federated(d, b)
    load_s = time.perf_counter() - t0
    if _host_state(b) != saved:
        raise AssertionError("the loaded state differs from the saved one")
    after_b = [b.run_round_async() for _ in range(CHECKPOINT_TICKS)]
    loss = 0.0
    for ra, rb in zip(after_a, after_b):
        _same_integers(ra, rb, "resumed tick")
        if "train_loss" in ra:
            loss = max(loss, abs(ra["train_loss"] - rb["train_loss"]))
    if _host_state(a) != _host_state(b):
        raise AssertionError("host state differs after the resumed ticks")
    errs = {"loss": loss,
            "global": _max_diff(a.server.global_lora, b.server.global_lora),
            "clients": _clients_diff(a, b)}
    # the round tolerances of tests/test_torch_fedround.py: loss 1e-5,
    # each element within ticks x local steps x lr
    if loss > 1e-5 or max(errs["global"], errs["clients"]) > \
            CHECKPOINT_TICKS * 10 * 1e-3:
        raise AssertionError(f"resumed ticks: {errs}")
    print(f"checkpoint: paged async with faults, delays "
          f"{CHECKPOINT_DELAYS}, buffer 2: a save with clients {pinned} in "
          f"flight refused; saved after tick {CHECKPOINT_TICKS - 1} "
          f"({n_buffered} buffered) in {save_s:.2f} s, loaded in "
          f"{load_s:.2f} s; {CHECKPOINT_TICKS} resumed ticks equal in "
          f"cohorts, fault draws, health, versions and numpy states; "
          f"largest differences {errs}", flush=True)
    return {"refused_pins": pinned, "save_s": save_s, "load_s": load_s,
            "buffered_at_save": n_buffered, "ticks": after_a,
            "errors": errs, "launches": dict(DK.launches)}


def phase_eval_ref(tr) -> dict:
    """The evaluation's reference arguments on a trained fedbench-100m
    trainer: the host loop against the population sweep, the full-forward
    decode against the cached one; tokens equal."""
    import torch

    calls = _recording(tr)
    t0 = time.perf_counter()
    ev = tr.evaluate_personalized(n=4, loss_n=8)
    sweep_s = time.perf_counter() - t0
    gen_v = next(o["gen"] for n, o in calls if n == "population_eval").cpu()
    calls.clear()
    t0 = time.perf_counter()
    ev_loop = tr.evaluate_personalized(n=4, loss_n=8, vmapped=False)
    loop_s = time.perf_counter() - t0
    gen_l = [o.cpu() for n, o in calls if n == "generate"]
    same = all(torch.equal(gen_v[k][:g.shape[0]], g)
               for k, g in enumerate(gen_l)) and len(gen_l) == len(tr.clients)
    if not same or ev_loop["bleu"] != ev["bleu"] or \
            ev_loop["rsum"] != ev["rsum"] or \
            abs(ev_loop["loss"] - ev["loss"]) > 1e-5:
        raise AssertionError(f"vmapped=False {ev_loop} vs {ev}")
    calls.clear()
    g = tr.server.global_lora
    t0 = time.perf_counter()
    sc = tr.generation_scores(g, tr.global_test, 4)
    cached_s = time.perf_counter() - t0
    tok_c = next(o for n, o in calls if n == "generate").cpu()
    calls.clear()
    t0 = time.perf_counter()
    sc_u = tr.generation_scores(g, tr.global_test, 4, cached=False)
    uncached_s = time.perf_counter() - t0
    tok_u = torch.stack([o.argmax(-1).cpu() for n, o in calls
                         if n == "next_logits"], dim=1)
    if sc != sc_u or not torch.equal(tok_c, tok_u):
        raise AssertionError(f"cached=False: {sc_u} vs {sc}")
    print(f"eval_ref: evaluate_personalized(vmapped=False) == the sweep "
          f"({ev_loop}; {loop_s:.2f} s vs {sweep_s:.2f} s), "
          f"generation_scores(cached=False) == cached ({tok_u.shape[1]} "
          f"tokens x 4 rows; {uncached_s:.2f} s vs {cached_s:.2f} s)",
          flush=True)
    return {"eval": ev, "loop_s": loop_s, "sweep_s": sweep_s,
            "generation": sc, "cached_s": cached_s, "uncached_s": uncached_s,
            "gen_len": int(tok_u.shape[1])}


def phase_cli() -> dict:
    """``python -m repro_torch.launch.train`` on fedbench-100m as a
    subprocess (1 round of 2 local steps through ``fedilora_kernel``), then
    ``AdapterStore.from_checkpoint`` on what it wrote."""
    import shutil

    from repro_torch.serving import AdapterStore

    d = os.path.join(ROOT, "build", "chip_smoke_cli")
    shutil.rmtree(d, ignore_errors=True)
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           "fedbench-100m", "--rounds", "1", "--local-steps", "2",
           "--aggregator", "fedilora_kernel", "--checkpoint-dir", d]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [SRC] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=600)
    wall = time.perf_counter() - t0
    if res.returncode:
        raise AssertionError(f"the CLI exited {res.returncode}: "
                             f"{res.stderr[-2000:]}")
    lines = res.stdout.strip().splitlines()
    rec = json.loads(lines[0])
    if lines[-1] != f"checkpoint written to {d}" or rec["round"] != 1 or \
            not math.isfinite(rec["train_loss"]) or "global" not in rec:
        raise AssertionError(f"the CLI printed {lines}")
    store = AdapterStore.from_checkpoint(d)
    want = {f"client{k}": r for k, r in enumerate(TRAIN_RANKS)}
    if store.ranks != want:
        raise AssertionError(f"from_checkpoint ranks {store.ranks}")
    store.acquire("client9")
    store.release("client9")
    print(f"cli: python -m repro_torch.launch.train (fedbench-100m, 1 round "
          f"x 2 steps) in {wall:.2f} s: {lines[0]}; from_checkpoint read "
          f"{len(store.ranks)} adapters", flush=True)
    return {"wall_s": wall, "record": rec, "ranks": store.ranks}


# the families phase: (config, layers kept — None keeps the published
# depth —, prefill chunk — None streams —, layers of the f32 decode ≡
# forward check and of the f32 grouped-vs-gather serve, its batch and its
# prompt length).  Mamba prompts pass chunk_size (256), so the SSD crosses
# a chunk boundary.
FAMILIES = [("mamba2-130m", None, None, None, 2, 300),
            ("jamba-v0.1-52b", 8, None, 8, 2, 300),
            ("deepseek-v2-236b", 2, 32, 1, 2, 48)]
FAMILY_TENANTS, FAMILY_BANK, FAMILY_REQUESTS = 6, 4, 24
# streamed decode against the full forward in f32 (TF32 off), logits.
# The adapter runs at the engine's LoRA scale (alpha 16 over rank 64).
# At 2.0, Mamba's dt grows to several units, and segment sums taken as
# differences of cumulative sums of dt·A over a 256-position chunk lose
# digits; the SSD now sums each segment on its own
# (tests/test_torch_mamba_scale.py holds scale 2.0 against the reference)
FAMILY_LORA_SCALE = 16.0 / 64
FAMILY_DECODE_ATOL = 1e-3
# mamba2-130m's decode ≡ forward once more at LoRA scale 2.0, within the
# same limit: where the check failed (2.675e-3) while the SSD took segment
# sums as differences of cumulative sums
STRONG_SCALE, STRONG_SCALE_FAMILY = 2.0, "mamba2-130m"


def _family_cfg(name: str, layers, no_drop: bool = False):
    """``name``'s published config, cut to ``layers`` (a multiple of its
    pattern).  ``no_drop`` (the decode ≡ forward check) sets the MoE
    capacity factor to max(8, E/K): 8 as the reference's
    ``tests/test_decode.py``, and E/K where that is larger, at which an
    expert takes every routed token (C >= T), so the forward drops no pick
    that the decode keeps.  DeepSeek-V2 needs it: at 8, its 160 experts
    top-6 take C = 15 of a 48-token prompt, and a random router sends
    more to one expert."""
    import dataclasses

    from repro_torch.configs import get_config
    cfg = get_config(name)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    if no_drop and cfg.moe is not None:
        mo = cfg.moe
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            mo, capacity_factor=max(8.0, mo.num_experts
                                    / mo.experts_per_token)))
    return cfg


def _bgmv_sites(cfg) -> int:
    """Banked BGMV sites a block: every LoRA site but MLA's ``wkv_b``,
    which folds per bank entry."""
    from repro_torch.models.transformer import lora_specs
    return sum(1 for s in lora_specs(cfg) if not s.name.endswith(".wkv_b"))


def family_requests(cfg, rng, n: int, *, gen=(8, 25)):
    from repro_torch.serving import Request
    return [Request(adapter_id=f"tenant{int(rng.integers(0, FAMILY_TENANTS))}",
                    prompt_tokens=rng.integers(0, cfg.vocab_size,
                                               size=int(rng.integers(8, 41))),
                    gen_len=int(rng.integers(*gen))) for _ in range(n)]


def family_engine(cfg, params, adapters, *, backend: str, prefill_chunk,
                  mesh=None, split: bool = False):
    from repro_torch.serving import AdapterStore, ServingEngine
    store = AdapterStore(slots=FAMILY_BANK, rank=max(RANKS), mesh=mesh)
    for tid, (lora, rank) in adapters.items():
        store.register(tid, lora, rank)
    return ServingEngine(cfg, params, store, lora_scale=FAMILY_LORA_SCALE,
                         max_slots=16, max_prompt=48, max_gen=24,
                         prefill_chunk=prefill_chunk, lora_backend=backend,
                         mesh=mesh, split=split)


def _family_tokens(cfg, params, adapters, reqs, backend: str, chunk) -> dict:
    eng = family_engine(cfg, params, adapters, backend=backend,
                        prefill_chunk=chunk)
    return {d["uid"]: d["tokens"].tolist() for d in eng.run(reqs)}


def _decode_vs_forward(cfg, params, lora, B: int, S: int, seed: int, *,
                       prefill: int = 0, scale: float = FAMILY_LORA_SCALE,
                       **inputs) -> float:
    """Largest |logit| difference between ``decode_step`` streamed over S
    positions and one ``forward``, with one adapter.  ``inputs``: the
    model's other inputs (``vision`` / ``audio``), to the forward and to
    ``init_cache``, which builds the static caches with the adapter.
    ``prefill``: positions written first in one ``decode_chunk`` call (no
    logits), the rest streamed and compared."""
    import numpy as np
    import torch

    from repro_torch.models.transformer import (decode_chunk, decode_step,
                                                forward, init_cache)
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S))).cuda()
    full, _ = forward(cfg, params, toks, lora=lora, lora_scale=scale,
                      **inputs)
    cache = init_cache(cfg, params, B, S, lora=lora, lora_scale=scale,
                       **inputs)
    if prefill:
        decode_chunk(cfg, params, cache, params["embed"][toks[:, :prefill]],
                     torch.zeros(B, dtype=torch.long, device="cuda"),
                     adapters=lora, lora_scale=scale, logits=False)
    errs = []
    for t in range(prefill, S):
        lg, cache = decode_step(cfg, params, cache, toks[:, t], t, lora=lora,
                                lora_scale=scale)
        errs.append((lg - full[:, t].float()).abs().max())
    return torch.stack(errs).max().item()


def phase_families() -> dict:
    """Serve the Mamba-2, hybrid Jamba and MLA + MoE stacks at their
    published widths in bf16 (``FAMILIES``: mamba2-130m whole, Jamba cut to
    one pattern period of 8 layers, DeepSeek-V2 to 2 layers) through
    ``lora_backend="grouped"``: 24 requests of 6 tenants through a 4-slot
    bank (cold tenants page in), streamed prefill on Mamba stacks and
    chunks of 32 on DeepSeek-V2; BGMV launched once a banked site a block
    for every serve/prefill call; a short profiled run.  Then, in f32 at
    an MoE capacity that drops nothing (``_family_cfg``): streamed
    ``decode_step`` logits against ``forward`` at every prompt position
    with an adapter (within ``FAMILY_DECODE_ATOL``), and grouped == gather
    greedy tokens.  The bf16
    weights are freed before the f32 ones are drawn."""
    import gc

    import numpy as np
    import torch

    from repro_torch.kernels import grouped_lora_matmul as glm
    from repro_torch.models.transformer import init_params

    out = {}
    for name, layers, chunk, f32_layers, B, S in FAMILIES:
        cfg = _family_cfg(name, layers)
        published = _family_cfg(name, None).num_layers
        rng = np.random.default_rng(5)
        adapters = make_adapters(cfg, rng, FAMILY_TENANTS)
        reqs = family_requests(cfg, rng, FAMILY_REQUESTS)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        params = init_params(cfg, seed=0)                # bf16 on the card
        n_params = sum(v.numel() for v in _leaves(params))
        eng = family_engine(cfg, params, adapters, backend="grouped",
                            prefill_chunk=chunk)
        torch.cuda.synchronize()
        glm.reset_launches()
        t0 = time.perf_counter()
        done = eng.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = glm.launches
        dc = eng.dispatch_count
        calls = dc["serve_step"] + dc["serve_prefill"]
        by_uid = {d["uid"]: d for d in done}
        for q in reqs:
            d = by_uid[q.uid]
            if d["status"] != "ok" or len(d["tokens"]) != q.gen_len:
                raise AssertionError(f"{name} request {q.uid}: status "
                                     f"{d['status']}, {len(d['tokens'])} of "
                                     f"{q.gen_len} tokens")
            if not ((d["tokens"] >= 0) & (d["tokens"] < cfg.vocab_size)).all():
                raise AssertionError(f"{name} request {q.uid}: token out of "
                                     "vocabulary")
        if eng.store.loads <= FAMILY_BANK:
            raise AssertionError(f"{name}: only {eng.store.loads} page-ins "
                                 f"for {FAMILY_TENANTS} tenants over "
                                 f"{FAMILY_BANK} slots")
        sites = _bgmv_sites(cfg)
        want = sites * cfg.num_blocks * calls
        if launches != want or not want:
            raise AssertionError(
                f"{name}: grouped_lora_matmul launched {launches} times, "
                f"expected {sites} sites x {cfg.num_blocks} blocks x {calls} "
                f"serve/prefill calls = {want}")
        if chunk is None and dc["serve_prefill"]:
            raise AssertionError(f"{name}: a streamed engine ran prefill "
                                 "chunks")
        peak = torch.cuda.max_memory_allocated() / 1e9
        tokens = sum(q.gen_len for q in reqs)
        preqs = family_requests(cfg, np.random.default_rng(6), 4, gen=(8, 9))
        peng = family_engine(cfg, params, adapters, backend="grouped",
                             prefill_chunk=chunk)
        prof = _profiled(lambda: peng.run(preqs),
                         f"{name} serve, {len(preqs)} requests",
                         ("shrink_kernel", "base_expand_kernel"))
        rec = {"layers": cfg.num_layers, "published_layers": published,
               "depth_cut": (f"{published} -> {cfg.num_layers} layers"
                             if cfg.num_layers != published else None),
               "d_model": cfg.d_model, "params": n_params,
               "prefill_chunk": chunk, "requests": len(reqs),
               "steps": eng.steps, "dispatch_count": dict(dc),
               "adapter_loads": eng.store.loads,
               "evictions": eng.store.evictions, "wall_s": wall,
               "generated_tokens": tokens, "tokens_per_s": tokens / wall,
               "launches": launches, "bgmv_sites_per_block": sites,
               "peak_mem_gb": peak, "profile": prof}
        print(f"families: {name} bf16 {cfg.num_layers} of {published} "
              f"layers, d_model {cfg.d_model}, {n_params / 1e9:.2f} B "
              f"params; {len(reqs)} requests, {eng.steps} steps, {calls} "
              f"serve/prefill calls, {eng.store.loads} page-ins, "
              f"{wall:.2f} s wall, {tokens / wall:.1f} generated tokens/s, "
              f"{launches} BGMV calls ({sites} sites x {cfg.num_blocks} "
              f"blocks x {calls}), peak {peak:.1f} GB", flush=True)
        del eng, peng, params
        gc.collect()
        torch.cuda.empty_cache()

        # f32, no MoE drops: decode ≡ forward, grouped == gather
        cfg32 = _family_cfg(name, f32_layers, no_drop=True)
        p32 = init_params(cfg32, seed=1, dtype="float32")
        lora = _cuda_adapter(cfg32, 7)
        t0 = time.perf_counter()
        err = _decode_vs_forward(cfg32, p32, lora, B, S, seed=8)
        dvf_s = time.perf_counter() - t0
        cf = cfg32.moe.capacity_factor if cfg32.moe is not None else None
        print(f"families: {name} f32 {cfg32.num_layers} layers, capacity "
              f"factor {cf}: decode vs forward over {B} x {S} positions max "
              f"err {err:.3e} ({dvf_s:.1f} s)", flush=True)
        if not err <= FAMILY_DECODE_ATOL:
            raise AssertionError(f"{name} f32 ({cfg32.num_layers} layers): "
                                 f"decode vs forward max err {err:.3e} "
                                 f"beyond {FAMILY_DECODE_ATOL}")
        if name == STRONG_SCALE_FAMILY:
            t0 = time.perf_counter()
            err2 = _decode_vs_forward(cfg32, p32, lora, B, S, seed=8,
                                      scale=STRONG_SCALE)
            print(f"families: {name} f32 at LoRA scale {STRONG_SCALE}: "
                  f"decode vs forward max err {err2:.3e} "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
            if not err2 <= FAMILY_DECODE_ATOL:
                raise AssertionError(
                    f"{name} f32 at LoRA scale {STRONG_SCALE}: decode vs "
                    f"forward max err {err2:.3e} beyond {FAMILY_DECODE_ATOL}")
            rec["decode_vs_forward_err_strong_scale"] = err2
        areqs = family_requests(cfg32, np.random.default_rng(9), 8,
                                gen=(8, 9))
        ad32 = make_adapters(cfg32, np.random.default_rng(10),
                             FAMILY_TENANTS)
        t0 = time.perf_counter()
        toks = {b: _family_tokens(cfg32, p32, ad32, areqs, b, chunk)
                for b in ("grouped", "gather")}
        agree_s = time.perf_counter() - t0
        if toks["grouped"] != toks["gather"] or len(toks["gather"]) != 8:
            raise AssertionError(f"{name} f32: grouped vs gather greedy "
                                 "tokens differ")
        rec.update({"f32_layers": cfg32.num_layers, "capacity_factor": cf,
                    "decode_batch": B,
                    "decode_positions": S, "decode_vs_forward_err": err,
                    "decode_vs_forward_s": dvf_s,
                    "f32_grouped_eq_gather": True, "agreement_s": agree_s})
        print(f"families: {name} f32: grouped == gather tokens for "
              f"{len(areqs)} requests ({agree_s:.1f} s)", flush=True)
        del p32, lora
        out[name] = rec
    return out


# the vision phase: llama-3.2-vision-11b (hf:meta-llama/Llama-3.2-11B-Vision)
# at its published widths and depth (40 layers, 8 gated cross layers), bf16,
# under fed_setup's protocol with images of 64 patches of vision_dim (the
# published 1600 would make a corpus of ~24 GB of host memory); every gate
# opened to 1.0 (tanh 0.76) before the rounds
VISION = "llama-3.2-vision-11b"
VISION_PATCHES, VISION_GATE, VISION_TRIM = 64, 1.0, 0.25
VISION_ROUNDS = (("fedilora_kernel", 2), ("fedilora_trimmed_kernel", 1))
VISION_EVAL_ROWS = 32
# f32 decode ≡ forward: llama-3.2-vision cut to 10 layers (two periods)
# with 1600 vision tokens, B 2; the prompt's first VISION_PREFILL positions
# go through one decode_chunk and the rest stream.  2688 text positions
# against 1600 vision tokens take the forward's cross layers onto the
# chunked online-softmax path (Sq·Sk > 2048²), the decode's stay naive
VISION_F32_LAYERS, VISION_TOKENS, VISION_B = 10, 1600, 2
VISION_S, VISION_PREFILL = 2688, 2560
# seamless-m4t-medium (arXiv:2308.11596) uncut, 12 + 12 layers; audio frames
# max(S // 4, 8) as the JAX package's input specs give them
ENCDEC, ENCDEC_S = "seamless-m4t-medium", 64


def _open_gates(params, gate: float) -> None:
    for sp in params["blocks"].values():
        if "cross" in sp:
            sp["cross"]["gate"].fill_(gate)


def _cuda_adapter(cfg, seed: int) -> dict:
    """One rank-64 adapter on every LoRA site of ``cfg``, A and B random
    (``make_adapters``' scales), on the card."""
    import numpy as np
    import torch
    one = make_adapters(cfg, np.random.default_rng(seed), 1)["tenant0"][0]
    return {n: {m: torch.from_numpy(e[m]).cuda() for m in ("A", "B")}
            for n, e in one.items()}


def _cohort_tree(trainer, sampled):
    """The round's stacked tree of the cohort ``sampled``, its ranks and
    its size weights: the operands of the round's aggregation."""
    import torch
    idx = torch.tensor(sampled, device="cuda")
    tree = {n: {m: e[m].index_select(0, idx) for m in ("A", "B")}
            for n, e in trainer.stacked_lora.items()}
    ranks = torch.tensor(trainer.client_ranks[sampled], device="cuda")
    sizes = torch.tensor([trainer.clients[k].size for k in sampled],
                         dtype=torch.float32, device="cuda")
    return tree, ranks, sizes / sizes.sum()


def _vision_tree_kernels(trainer, sampled, dev_name: str) -> dict:
    """Both ``dim_agg`` kernels on the vision round's whole tree (the last
    cohort's adapters, cross leaves of width vision_dim among them), held
    leaf by leaf against their plain versions within ``_hold_agg``'s
    limits, one launch each; then timed beside the plain versions and the
    bound (a second copy of the tree, so each call finds its leaves outside
    L2)."""
    import torch

    from repro_torch.core.aggregation import (_client_masks,
                                              dimension_wise_weights,
                                              trimmed_dimension_counts)
    from repro_torch.kernels import dim_agg as DK

    from repro_torch.launch.roofline import peaks_for
    bw, _, peak_f32 = peaks_for(dev_name)
    tree, ranks, p = _cohort_tree(trainer, sampled)
    K, r_g = len(sampled), trainer.lcfg.rank
    w = dimension_wise_weights(ranks, p, r_g)
    cover = _client_masks(ranks, r_g, p.dtype) * (p > 0).to(p.dtype)[:, None]
    t = trimmed_dimension_counts(cover, VISION_TRIM)
    leaves = DK.tree_leaves(tree)
    sets = [(leaves,), ([(x.clone(), ax) for x, ax in leaves],)]
    shapes = [tuple(x.shape) for x, _ in leaves]
    n_out = sum(L * P * Q for _, L, P, Q in shapes)
    nbytes = _dim_agg_bytes(shapes, r_g)
    out = {"leaves": shapes, "tree_bytes": sum(
        x.numel() * x.element_size() for x, _ in leaves)}
    for kernel, fn, plain, leaf_fn, ops_per in [
            ("dim_agg",
             lambda: DK.fedilora_aggregate_tree(tree, ranks, p),
             lambda lv: [DK.plain_dim_agg(x, w, rank_axis=ax)
                         for x, ax in lv],
             lambda lv: DK.dim_agg_tree_cuda(lv, w), 2 * K),
            ("dim_agg_trimmed",
             lambda: DK.fedilora_trimmed_tree(tree, ranks, p, VISION_TRIM),
             lambda lv: [DK.plain_dim_agg_trimmed(x, p, cover, t,
                                                  rank_axis=ax)
                         for x, ax in lv],
             lambda lv: DK.dim_agg_trimmed_tree_cuda(lv, p, cover, t),
             8 * K * K + 6 * K)]:
        DK.reset_launches()
        got = fn()
        torch.cuda.synchronize()
        if DK.launches[kernel] != 1 or sum(DK.launches.values()) != 1:
            raise AssertionError(f"vision tree: {kernel} launches "
                                 f"{dict(DK.launches)}, expected one")
        held = [_hold_agg(f"vision tree {kernel} {n}.{m}", got[n][m], ref)
                for (n, m), ref in zip(_tree_keys(tree), plain(leaves))]
        ms = cuda_time_ms(leaf_fn, sets, iters=20)
        plain_ms = cuda_time_ms(plain, sets, iters=5, warmup=1)
        rec = {"kernel": kernel, "launches": 1,
               "max_abs_err": max(h["max_abs_err"] for h in held),
               "bit_equal": all(h["bit_equal"] for h in held), "ms": ms,
               "plain_ms": plain_ms, "library_ms": None,
               **_bound(nbytes, ops_per * n_out, bw, peak_f32)}
        rec["pct_of_bound"] = 100 * rec["bound_ms"] / ms
        out[kernel] = rec
        print(f"vision: {kernel} on the round's tree ({len(shapes)} leaves, "
              f"{out['tree_bytes'] / 1e6:.1f} MB, K {K}): err "
              f"{rec['max_abs_err']:.3e} bit-equal {rec['bit_equal']} "
              f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms bound "
              f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}, "
              f"{rec['pct_of_bound']:.1f} %)", flush=True)
    return out


def _greedy_both_ways(trainer) -> dict:
    """``evaluate_global(n=VISION_EVAL_ROWS)`` (its cached greedy decode)
    and ``generation_scores(cached=False)`` (a full forward a token) on the
    same rows: the scores, the walls and how many greedy tokens differ."""
    import torch
    calls = _recording(trainer)
    t0 = time.perf_counter()
    ev = trainer.evaluate_global(n=VISION_EVAL_ROWS)
    eval_s = time.perf_counter() - t0
    tok_c = next(o for n_, o in calls if n_ == "generate").cpu()
    calls.clear()
    t0 = time.perf_counter()
    sc_u = trainer.generation_scores(trainer.server.global_lora,
                                     trainer.global_test, VISION_EVAL_ROWS,
                                     cached=False)
    uncached_s = time.perf_counter() - t0
    tok_u = torch.stack([o.argmax(-1).cpu() for n_, o in calls
                         if n_ == "next_logits"], dim=1)
    del trainer._dispatch                 # the class's again
    if tok_c.shape != tok_u.shape:
        raise AssertionError(f"vision: cached tokens {tuple(tok_c.shape)}, "
                             f"uncached {tuple(tok_u.shape)}")
    return {"eval_global": ev, "eval_s": eval_s, "uncached": sc_u,
            "uncached_s": uncached_s, "tokens": tok_u.numel(),
            "tokens_differing": int((tok_c != tok_u).sum())}


def phase_vision(dev_name: str) -> dict:
    """The cross-attention VLM and the enc-dec stack.

    (a) llama-3.2-vision-11b at its published widths and depth in bf16
    (random weights from seed 0) under ``fed_setup``'s protocol, the images
    64 patches of 4096: 2 ``fedilora_kernel`` rounds, then 1
    ``fedilora_trimmed_kernel`` round (trim 0.25), then
    ``evaluate_global(n=32)`` and ``generation_scores(cached=False)`` on
    the same rows.  Every gate is opened to 1.0 first: the reference's
    init draws them at 0, tanh(0) = 0, and a closed gate makes the cross
    layers add nothing, so their adapters would take no gradient.  Held:
    finite losses, a nonzero B on every cross ``wq`` / ``wv`` layer after
    each round, ``dim_agg`` launched once a ``fedilora_kernel`` round and
    ``dim_agg_trimmed`` once in the trimmed round (counts set to 0 just
    before the rounds), both kernels against their plain versions on the
    round's whole tree.  One more (trimmed) round runs under the profiler
    before the evaluation.  The evaluation runs in bf16 (how many greedy
    tokens the cached and uncached decodes part on is recorded: bf16 sums
    in another order can flip a near tie), then over the base weights
    cast to f32, where the cached greedy tokens must equal the uncached
    ones.

    (b) In f32 (TF32 off), the bf16 weights freed first, an adapter on
    every site: ``decode_step`` against ``forward`` within
    ``FAMILY_DECODE_ATOL`` on llama-3.2-vision cut to 10 layers with 1600
    vision tokens and on seamless-m4t-medium uncut; then one bf16
    ``loss_fn`` with LoRA gradients on seamless-m4t-medium, finite and
    nonzero on every ``enc.*`` and ``dec_cross.*`` leaf."""
    import dataclasses
    import gc

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_map
    from repro_torch.kernels import dim_agg as DK
    from repro_torch.kernels import grouped_lora_matmul as glm
    from repro_torch.launch.steps import loss_and_grad
    from repro_torch.models.transformer import init_params

    cfg = get_config(VISION)
    task = dict(image_dim=cfg.vision_dim, num_patches=VISION_PATCHES)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    base = init_params(cfg, seed=0)                   # bf16 on the card
    _open_gates(base, VISION_GATE)
    n_params = sum(v.numel() for v in _leaves(base))
    trainer = fed_setup(VISION_ROUNDS[0][0], base=base, model=VISION,
                        task=task, trim_frac=VISION_TRIM)
    setup_s = time.perf_counter() - t0
    cross = [s.name for s in trainer.specs if ".cross." in s.name]
    torch.cuda.synchronize()
    DK.reset_launches()
    glm.reset_launches()
    recs, walls = [], []
    for agg, n in VISION_ROUNDS:
        if trainer.fcfg.aggregator != agg:
            trainer.fcfg = dataclasses.replace(trainer.fcfg, aggregator=agg)
            trainer._round_step = None        # the engine takes the new one
        for _ in range(n):
            t0 = time.perf_counter()
            rec = trainer.run_round()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            rec["aggregator"] = agg
            recs.append(rec)
            if not math.isfinite(rec["train_loss"]):
                raise AssertionError(f"vision round {rec['round']}: loss "
                                     f"{rec['train_loss']}")
            bmax = {s: trainer.server.global_lora[s]["B"].abs().amax(
                dim=(1, 2)).min().item() for s in cross}
            if not all(v > 0 for v in bmax.values()):
                raise AssertionError(f"vision round {rec['round']}: a cross "
                                     f"layer's B is still zero: {bmax}")
            rec["cross_B_min_of_layer_max"] = bmax
    launches = dict(DK.launches)
    want = {"dim_agg": sum(n for a, n in VISION_ROUNDS
                           if a == "fedilora_kernel"),
            "dim_agg_trimmed": sum(n for a, n in VISION_ROUNDS
                                   if a == "fedilora_trimmed_kernel")}
    if launches != want or glm.launches:
        raise AssertionError(f"vision rounds: dim_agg launches {launches}, "
                             f"BGMV {glm.launches}; expected {want} and no "
                             "BGMV")
    peak_rounds = torch.cuda.max_memory_allocated() / 1e9
    print(f"vision: {VISION} bf16 {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {n_params / 1e9:.2f} B params, gates "
          f"{VISION_GATE}; images {VISION_PATCHES} x {cfg.vision_dim}; "
          f"rounds {[(r['aggregator'], round(r['train_loss'], 4)) for r in recs]}"
          f", walls {[round(w_, 3) for w_ in walls]} s, set-up "
          f"{setup_s:.1f} s, launches {launches}, peak {peak_rounds:.2f} GB",
          flush=True)
    trees = _vision_tree_kernels(trainer, recs[-1]["sampled"], dev_name)
    prof = _profiled(trainer.run_round, "one vision round",
                     ("dim_agg_trimmed_kernel",))

    bf = _greedy_both_ways(trainer)
    ev = bf["eval_global"]
    if not all(math.isfinite(ev[k]) for k in ("loss", "bleu", "rsum")):
        raise AssertionError(f"vision evaluate_global: {ev}")
    # the same adapters over the base weights in f32, where the two decodes
    # must give the same tokens (bf16 sums in another order can flip a
    # near tie)
    trainer.base_params = tree_map(lambda t: t.float(), trainer.base_params)
    del base
    gc.collect()
    torch.cuda.empty_cache()
    f32 = _greedy_both_ways(trainer)
    if f32["tokens_differing"] or (f32["uncached"]["bleu"],
                                   f32["uncached"]["rsum"]) != (
            f32["eval_global"]["bleu"], f32["eval_global"]["rsum"]):
        raise AssertionError(
            f"vision f32: cached and uncached greedy tokens differ "
            f"({f32['tokens_differing']} of {f32['tokens']}): "
            f"{f32['eval_global']} vs {f32['uncached']}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    for what, r in (("bf16", bf), ("f32", f32)):
        print(f"vision: {what} evaluate_global(n={VISION_EVAL_ROWS}) "
              f"{r['eval_global']} in {r['eval_s']:.2f} s; "
              f"generation_scores(cached=False) {r['uncached']} in "
              f"{r['uncached_s']:.2f} s; {r['tokens_differing']} of "
              f"{r['tokens']} greedy tokens differ", flush=True)
    print(f"vision: peak {peak:.2f} GB", flush=True)
    out = {"model": VISION, "layers": cfg.num_layers, "params": n_params,
           "gate": VISION_GATE, "patches": VISION_PATCHES,
           "rounds": recs, "round_wall_s": walls, "setup_s": setup_s,
           "launches": launches, "peak_mem_rounds_gb": peak_rounds,
           "tree": trees, "profile": prof, "eval_bf16": bf, "eval_f32": f32,
           "peak_mem_gb": peak}
    del trainer
    _FED_DATA.pop(tuple(sorted(task.items())))
    gc.collect()
    torch.cuda.empty_cache()

    # (b) f32 decode ≡ forward, an adapter on every site, gates open
    cfg10 = dataclasses.replace(cfg, num_layers=VISION_F32_LAYERS)
    p32 = init_params(cfg10, seed=1, dtype="float32")
    _open_gates(p32, VISION_GATE)
    vision = torch.randn((VISION_B, VISION_TOKENS, cfg.vision_dim),
                         generator=torch.Generator(device="cuda").manual_seed(
                             3), device="cuda")
    t0 = time.perf_counter()
    err_v = _decode_vs_forward(cfg10, p32, _cuda_adapter(cfg10, 12),
                               VISION_B, VISION_S, seed=13,
                               prefill=VISION_PREFILL, vision=vision)
    dvf_v = time.perf_counter() - t0
    del p32, vision
    gc.collect()
    torch.cuda.empty_cache()
    ecfg = get_config(ENCDEC)
    p32 = init_params(ecfg, seed=1, dtype="float32")
    n_frames = max(ENCDEC_S // 4, 8)
    gen = torch.Generator(device="cuda").manual_seed(4)
    audio = torch.randn((2, n_frames, ecfg.audio_dim), generator=gen,
                        device="cuda")
    lora = _cuda_adapter(ecfg, 14)
    t0 = time.perf_counter()
    err_e = _decode_vs_forward(ecfg, p32, lora, 2, ENCDEC_S, seed=15,
                               audio=audio)
    dvf_e = time.perf_counter() - t0
    print(f"vision: f32 decode vs forward: {VISION} {cfg10.num_layers} "
          f"layers, {VISION_TOKENS} vision tokens, B {VISION_B}, "
          f"{VISION_S} positions ({VISION_PREFILL} in one decode_chunk, the "
          f"rest streamed) max err {err_v:.3e} ({dvf_v:.1f} s); {ENCDEC} "
          f"{ecfg.encoder_layers} + {ecfg.num_layers} layers, {n_frames} "
          f"audio frames, {ENCDEC_S} positions max err {err_e:.3e} "
          f"({dvf_e:.1f} s)", flush=True)
    for what, err in ((VISION, err_v), (ENCDEC, err_e)):
        if not err <= FAMILY_DECODE_ATOL:
            raise AssertionError(f"{what} f32: decode vs forward max err "
                                 f"{err:.3e} beyond {FAMILY_DECODE_ATOL}")
    del p32
    gc.collect()
    torch.cuda.empty_cache()
    p16 = init_params(ecfg, seed=2)                   # bf16
    rng = np.random.default_rng(16)
    batch = {"tokens": torch.from_numpy(rng.integers(
        4, ecfg.vocab_size, (2, ENCDEC_S))).cuda(),
        "labels": torch.from_numpy(rng.integers(
            0, ecfg.vocab_size, (2, ENCDEC_S))).cuda(),
        "loss_mask": torch.ones((2, ENCDEC_S), device="cuda"),
        "audio": audio}
    loss, _, grads = loss_and_grad(ecfg, p16, lora, batch, FAMILY_LORA_SCALE)
    gmax = {f"{n}.{m}": g[m].abs().max().item() for n, g in grads.items()
            for m in ("A", "B") if n.startswith("enc.") or ".dec_cross." in n}
    if not math.isfinite(loss.item()) or not all(
            math.isfinite(v) and v > 0 for v in gmax.values()):
        raise AssertionError(f"{ENCDEC} bf16 loss {loss.item()}, enc.* / "
                             f"dec_cross.* gradient max {gmax}")
    print(f"vision: {ENCDEC} bf16 loss_fn {loss.item():.4f}, LoRA gradients "
          f"finite and nonzero on {len(gmax)} enc.* / dec_cross.* leaves "
          f"(smallest max {min(gmax.values()):.3e})", flush=True)
    del p16, grads
    gc.collect()
    torch.cuda.empty_cache()
    out.update({"f32_layers": cfg10.num_layers, "f32_vision_tokens":
                VISION_TOKENS, "f32_positions": VISION_S,
                "f32_prefill": VISION_PREFILL,
                "decode_vs_forward_err": err_v, "decode_vs_forward_s": dvf_v,
                "encdec": {"model": ENCDEC, "positions": ENCDEC_S,
                           "frames": n_frames,
                           "decode_vs_forward_err": err_e,
                           "decode_vs_forward_s": dvf_e,
                           "bf16_loss": loss.item(), "grad_max": gmax}})
    return out


# the mesh phase: rounds on fedbench-100m (as fed_setup builds them) and
# qwen2-0.5b serving, on round and serving meshes over NCCL, each run
# beside the unmeshed run from the same state.  ``MESH_ROUNDS``: (aggregator,
# rounds, FederatedConfig fields); the serving requests are the serve
# phase's kind, shorter
MESH_ROUNDS = (("fedilora_kernel", 2, {}),
               ("fedilora_trimmed_kernel", 1, {"trim_frac": 0.25}))
MESH_SERVE_REQUESTS, MESH_SERVE_GEN = 12, 16
MESH_TIMEOUT_S = 600


def _held_kernels() -> dict:
    """Wrap the launching entry points of BGMV and both ``dim_agg``
    kernels: each launch runs (and counts) as before, then its plain
    version runs on the same inputs and the output is held against it
    (BGMV at the kernels phase's limits, ``dim_agg`` at ``_hold_agg``'s).
    Returns the running record: launches held, the largest error and
    every shape seen, per kernel."""
    import torch

    from repro_torch.kernels import dim_agg as DK
    from repro_torch.kernels import grouped_lora_matmul as glm

    held = {k: {"held": 0, "max_abs_err": 0.0, "shapes": set()}
            for k in ("grouped_lora_matmul", "dim_agg", "dim_agg_trimmed")}

    def note(kernel, err, *shapes):
        h = held[kernel]
        h["held"] += 1
        h["max_abs_err"] = max(h["max_abs_err"], err)
        h["shapes"].update(shapes)

    bgmv = glm.grouped_lora_matmul_cuda

    def bgmv_held(x, w, a, b, idx, *, scale=1.0):
        y = bgmv(x, w, a, b, idx, scale=scale)
        ref = glm.grouped_lora_matmul_ref(x.float(), w.float(), a.float(),
                                          b.float(), idx, scale=scale)
        err = (y.float() - ref).abs()
        tol = 1e-4 if x.dtype == a.dtype == torch.float32 else 2e-2
        if not bool((err <= tol + tol * ref.abs()).all()):
            raise AssertionError(f"mesh BGMV {tuple(x.shape)} x "
                                 f"{tuple(w.shape)}: max err "
                                 f"{err.max().item():.3e} beyond {tol}")
        note("grouped_lora_matmul", err.max().item(),
             (x.shape[0], w.shape[0], w.shape[1], a.shape[0], a.shape[1],
              str(x.dtype).split(".")[-1]))
        return y

    def tree_held(kernel, launch, plain):
        def run(leaves, *args):
            outs = launch(leaves, *args)
            errs = [_hold_agg(f"mesh {kernel} {tuple(x.shape)}", y,
                              plain(x, *args, rank_axis=ax))["max_abs_err"]
                    for (x, ax), y in zip(leaves, outs)]
            note(kernel, max(errs), *(tuple(x.shape) for x, _ in leaves))
            return outs
        return run

    glm.grouped_lora_matmul_cuda = bgmv_held
    DK.dim_agg_tree_cuda = tree_held("dim_agg", DK.dim_agg_tree_cuda,
                                     DK.plain_dim_agg)
    DK.dim_agg_trimmed_tree_cuda = tree_held(
        "dim_agg_trimmed", DK.dim_agg_trimmed_tree_cuda,
        DK.plain_dim_agg_trimmed)
    return held


def _adapters_close(got, want, rounds: int, steps: int, lr: float) -> dict:
    """``got`` against ``want`` at the CPU tests' limits for a
    tensor-parallel round (``tests/test_torch_mesh_round.py``): all but
    0.1 % of each leaf within 5e-4, every element within one AdamW step
    per local step and round, the mean within 1e-6."""
    worst, ok = 0.0, True
    for n in want:
        for m in ("A", "B"):
            d = (got[n][m] - want[n][m]).abs()
            worst = max(worst, d.max().item())
            ok &= bool((d > 5e-4).float().mean() <= 1e-3
                       and d.max() <= rounds * steps * lr
                       and d.mean() <= 1e-6)
    return {"max_abs_err": worst, "within_tol": ok}


def _mesh_rounds(meshes: dict, held: dict, *, exact: bool,
                 **fed_kw) -> dict:
    """``MESH_ROUNDS`` on every mesh of ``meshes`` (name → Mesh) and
    unmeshed, each from fed_setup's state.  ``exact``: every mesh must give
    the unmeshed records and adapters bit for bit; otherwise the cohorts,
    edits and ranks exactly, the losses within 1e-4 and the adapters by
    ``_adapters_close``.  Every rank's global is the same bit for bit (its
    sum over ranks is ``world`` times its own), and ``dim_agg`` /
    ``dim_agg_trimmed`` launch once a round."""
    import torch

    from repro_torch.kernels import dim_agg as DK

    base = fed_setup("fedilora").base_params
    out = {}
    for agg, rounds, kw in MESH_ROUNDS:
        runs = {}
        for name, mesh in [("unmeshed", None)] + list(meshes.items()):
            tr = fed_setup(agg, base=base, mesh=mesh, **kw, **fed_kw)
            DK.reset_launches()
            if mesh is not None:
                mesh.reset_collectives()
            recs, walls = [], []
            for _ in range(rounds):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                recs.append(tr.run_round())
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            key = "dim_agg_trimmed" if "trimmed" in agg else "dim_agg"
            if DK.launches[key] != rounds:
                raise AssertionError(f"mesh {name} {agg}: launches "
                                     f"{dict(DK.launches)}, expected {rounds}"
                                     f" {key}, one a round")
            runs[name] = {"recs": recs, "walls": walls, "trainer": tr,
                          "launches": dict(DK.launches),
                          "collectives": ({} if mesh is None else {
                              f"{op}.{ax}": n for (op, ax), n in
                              mesh.collectives.items()})}
        plain = runs.pop("unmeshed")
        res = {"unmeshed_walls": plain["walls"]}
        for name, r in runs.items():
            tr, mesh = r["trainer"], meshes[name]
            flat = torch.cat([e[m].reshape(-1) for e in
                              tr.server.global_lora.values() for m in "AB"])
            ranks_flat = [torch.empty_like(flat) for _ in
                          range(torch.distributed.get_world_size())]
            torch.distributed.all_gather(ranks_flat, flat)
            if not all(torch.equal(f, flat) for f in ranks_flat):
                raise AssertionError(f"mesh {name} {agg}: the ranks' globals "
                                     "differ")
            pt = plain["trainer"]
            if exact:
                same = (r["recs"] == plain["recs"] and all(
                    torch.equal(tr.server.global_lora[n][m],
                                pt.server.global_lora[n][m])
                    and torch.equal(tr.stacked_lora[n][m],
                                    pt.stacked_lora[n][m])
                    for n in pt.server.global_lora for m in "AB"))
                if not same:
                    raise AssertionError(f"mesh {name} {agg}: not bit for bit"
                                         " the unmeshed rounds")
                err = {"max_abs_err": 0.0, "bit_equal": True}
            else:
                for a, b in zip(r["recs"], plain["recs"]):
                    if (a["sampled"], a["edited_layers"]) != (
                            b["sampled"], b["edited_layers"]) or abs(
                            a["train_loss"] - b["train_loss"]) > 1e-4:
                        raise AssertionError(f"mesh {name} {agg}: {a} vs "
                                             f"{b}")
                if not (tr.client_ranks == pt.client_ranks).all():
                    raise AssertionError(f"mesh {name} {agg}: ranks differ")
                err = _adapters_close(tr.server.global_lora,
                                      pt.server.global_lora, rounds,
                                      tr.fcfg.local_steps, tr.ocfg.peak_lr)
                if not err["within_tol"]:
                    raise AssertionError(f"mesh {name} {agg}: global adapters"
                                         f" {err}")
            res[name] = {"walls": r["walls"], "launches": r["launches"],
                         "collectives": r["collectives"],
                         "losses": [x["train_loss"] for x in r["recs"]],
                         **err}
        out[agg] = res
    return out


def _mesh_serve(meshes: dict, held: dict, *, dtype: str) -> dict:
    """qwen2-0.5b (``dtype``) serving ``MESH_SERVE_REQUESTS`` requests
    through ``lora_backend="grouped"`` on every mesh of ``meshes`` and
    unmeshed: the same tokens, request for request, and two BGMV launches
    a LoRA site a layer for every serve/prefill call."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import grouped_lora_matmul as glm
    from repro_torch.models.transformer import init_params

    cfg = get_config("qwen2-0.5b")
    params = init_params(cfg, seed=0, dtype=dtype)
    adapters = make_adapters(cfg, np.random.default_rng(5), N_TENANTS)
    reqs = make_requests(cfg, np.random.default_rng(6), MESH_SERVE_REQUESTS,
                         gen_len=MESH_SERVE_GEN)
    toks, out = {}, {}
    for name, mesh in [("unmeshed", None)] + list(meshes.items()):
        eng, _ = make_engine(cfg, params, adapters, backend="grouped",
                             mesh=mesh)
        if mesh is not None:
            mesh.reset_collectives()
        glm.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = eng.run([dataclasses.replace(q) for q in reqs])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        toks[name] = [d["tokens"].tolist() for d in
                      sorted(done, key=lambda d: d["uid"])]
        out[name] = {"wall_s": wall, "launches": _bgmv_held([eng], name),
                     "steps": eng.steps,
                     "collectives": ({} if mesh is None else {
                         f"{op}.{ax}": n for (op, ax), n in
                         mesh.collectives.items()})}
        del eng
    for name in meshes:
        if toks[name] != toks["unmeshed"]:
            bad = sum(a != b for a, b in zip(toks[name], toks["unmeshed"]))
            raise AssertionError(f"mesh serve {name} ({dtype}): tokens of "
                                 f"{bad} requests differ from unmeshed")
    return out


def _mesh_rank(rank: int, world: int, rdv: str, out_path: str,
               parts: tuple) -> None:
    """One rank of the mesh phase (spawned): NCCL over ``world`` cards,
    the kernel entry points held (``_held_kernels``), then ``parts``; rank
    0 writes the record to ``out_path``."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import Mesh, init_distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    init_distributed(init_method=f"file://{rdv}", world_size=world,
                     rank=rank)
    held = _held_kernels()
    res = {}
    try:
        for part in parts:
            t0 = time.perf_counter()
            if part == "rounds":
                if world == 1:
                    meshes = {"client(1)": Mesh((1,), ("client",)),
                              "client x model(1x1)": Mesh(
                                  (1, 1), ("client", "model"))}
                    res[part] = _mesh_rounds(meshes, held, exact=True)
                elif world == 2:      # n_sample 3 pads to 4 over 2 ranks
                    res[part] = _mesh_rounds(
                        {"client(2), n_sample 3": Mesh((2,), ("client",))},
                        held, exact=False, sample_rate=0.3)
                else:
                    res[part] = _mesh_rounds(
                        {"client x model(2x2)": Mesh((2, 2), (
                            "client", "model"))}, held, exact=False)
            elif part == "serve":
                n = world
                meshes = {f"data({n})": Mesh((n,), ("data",)),
                          f"data x model(1x{n})": Mesh((1, n),
                                                        ("data", "model"))}
                # split over n > 1 ranks, a GEMM sees other shapes (16 / n
                # slot rows, the model axis's columns), and bf16 rounds
                # them otherwise: a near tie can flip a greedy token (3 of
                # 12 requests differed on 2 x 8 slot rows of two H100s),
                # so those engines serve f32 weights
                res[part if n == 1 else part + ".f32"] = _mesh_serve(
                    meshes, held, dtype="bfloat16" if n == 1 else "float32")
            res.setdefault("wall_s", {})[part] = time.perf_counter() - t0
        res["held"] = {k: dict(v, shapes=sorted(v["shapes"]))
                       for k, v in held.items()}
        if rank == 0:
            with open(out_path, "w") as f:
                json.dump(res, f, default=float)
    finally:
        dist.destroy_process_group()


def _spawn_mesh(world: int, parts: tuple, target=None,
                timeout: float = MESH_TIMEOUT_S) -> dict:
    """Run ``target`` (default ``_mesh_rank``) on ``world`` cards (spawned
    processes, a rendezvous file under ``build/``) for at most
    ``timeout`` seconds; a failing rank fails the phase."""
    import torch.multiprocessing as mp

    out_dir = os.path.join(ROOT, "build")
    os.makedirs(out_dir, exist_ok=True)
    tag = f"mesh-{os.getpid()}-{world}"
    rdv = os.path.join(out_dir, f"{tag}.rdv")
    out_path = os.path.join(out_dir, f"{tag}.json")
    for p in (rdv, out_path):
        if os.path.exists(p):
            os.unlink(p)
    ctx = mp.start_processes(target or _mesh_rank,
                             args=(world, rdv, out_path, parts),
                             nprocs=world, join=False, start_method="spawn")
    end = time.monotonic() + timeout
    while not ctx.join(timeout=max(end - time.monotonic(), 1.0)):
        if time.monotonic() > end:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"mesh ranks ({world}) still running after "
                               f"{timeout} s")
    with open(out_path) as f:
        res = json.load(f)
    for p in (rdv, out_path):
        if os.path.exists(p):
            os.unlink(p)
    return res


def _print_mesh(world: int, res: dict) -> None:
    for agg, r in res.get("rounds", {}).items():
        for name, v in r.items():
            if name == "unmeshed_walls":
                continue
            print(f"mesh ({world} ranks): {agg} on {name}: losses "
                  f"{[round(x, 6) for x in v['losses']]}, walls "
                  f"{[round(w, 3) for w in v['walls']]} s (unmeshed "
                  f"{[round(w, 3) for w in r['unmeshed_walls']]} s), "
                  f"global max err {v['max_abs_err']:.3e}"
                  f"{' (bit for bit)' if v.get('bit_equal') else ''}, "
                  f"launches {v['launches']}, collectives {v['collectives']}",
                  flush=True)
    for part in ("serve", "serve.f32"):
        for name, v in res.get(part, {}).items():
            print(f"mesh ({world} ranks): {part} qwen2-0.5b on {name}: "
                  f"tokens equal to unmeshed, {v['steps']} steps, "
                  f"{v['wall_s']:.2f} s, BGMV launches {v['launches']}, "
                  f"collectives {v['collectives']}", flush=True)
    for k, v in res["held"].items():
        print(f"mesh ({world} ranks): {k} held against its plain version at "
              f"{v['held']} launches, max err {v['max_abs_err']:.3e}, shapes "
              f"{v['shapes']}", flush=True)


def phase_mesh(dev_name: str) -> dict:
    """The meshed rounds and serving over NCCL: world size 1 on one card
    (every mesh code path; each run equal to the unmeshed one bit for
    bit), and with 4 cards or more also the 2x2 round and, on 2 cards, the
    padded client mesh, the 2-slot and the tensor-parallel serving mesh.
    Every launch of BGMV, ``dim_agg`` and ``dim_agg_trimmed`` in the
    meshed runs is held against its plain version."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()          # the ranks share the card's memory
    n_dev = torch.cuda.device_count()
    out = {"devices": n_dev, "one": _spawn_mesh(1, ("rounds", "serve"))}
    _print_mesh(1, out["one"])
    if n_dev >= 4:
        out["four"] = _spawn_mesh(4, ("rounds",))
        _print_mesh(4, out["four"])
        out["two"] = _spawn_mesh(2, ("rounds", "serve"))
        _print_mesh(2, out["two"])
    print(f"mesh: the multi-rank part {'ran' if n_dev >= 4 else 'did not run'}"
          f" ({n_dev} device{'s' if n_dev != 1 else ''}; it needs 4)",
          flush=True)
    return out


# the mesh_families phase: round and serving meshes on the Mamba-2,
# hybrid Jamba, MLA + MoE and cross-attention VLM families at published
# widths, over NCCL.  (config, layers kept on one card in bf16, layers in
# f32 on four — the depth at which the unmeshed f32 run fits one card:
# Jamba's 8 layers are one pattern period, 48 GB of f32 weights).  The
# rounds follow fed_setup's protocol with 2 of the 10 clients a round and
# 3 local steps (``MESH_FAMILY_FED``; the first moves no A, its B
# starting at 0, so with 2 the edited module can hang on near-equal
# similarities), the VLM's images 64 patches of its
# vision width with every gate opened to 1.0; the engines serve
# ``MESH_FAMILY_REQUESTS`` requests of the families phase's kind
MESH_FAMILIES = [("mamba2-130m", None, None), ("jamba-v0.1-52b", 8, 8),
                 ("deepseek-v2-236b", 2, 2),
                 ("llama-3.2-vision-11b", 10, 10)]
MESH_SERVED = ("mamba2-130m", "jamba-v0.1-52b", "deepseek-v2-236b")
MESH_FAMILY_FED = dict(sample_rate=0.2, local_steps=3)
MESH_FAMILY_REQUESTS = 8
# jamba-v0.1-52b (arXiv:2403.19887) uncut, 32 layers, 49.37 B parameters,
# bf16 on a (1, 4) ("data", "model") engine: JAMBA_REQUESTS requests of
# the families phase's FAMILY_TENANTS tenants; then its decode logits
# against the same mesh's forward over JAMBA_DVF (batch, positions) with
# one adapter, in f32 over the same (bf16-valued) weights at a capacity
# that drops nothing: in
# bf16 the decode and the forward round the residual stream in another
# order, and over 16 MoE layers a near tie between two experts flips a
# pick, so bf16 logits part by whole expert outputs.  The limit is the
# families phase's f32 limit
JAMBA = "jamba-v0.1-52b"
JAMBA_REQUESTS, JAMBA_DVF = 8, (2, 40)
# A tensor-parallel run sums in another order than the unmeshed one, so a
# router pick whose probabilities nearly tie can part between the two:
# the runs then differ by whole expert outputs (a Jamba-8 round's loss by
# 1.1e-3 in my four-card chip call 2).  The four-card comparisons of MoE
# stacks record every routing decision of both runs; where they part, the
# first parted call must part only at picks whose probabilities lie
# within ROUTE_TIE of the next in the unmeshed run (f32 sums that differ
# in the sixth digit move a probability by ~1e-5), and the runs are then
# held to be finite and the same on every rank, not to each other
ROUTE_TIE = 1e-4


def _route_recorder() -> list:
    """Record every ``moe_route`` call of this process: the picks
    ``ids`` [T, K] and each token's smallest gap between adjacent ones of
    its K + 1 largest probabilities.  One record a process: a second
    call returns the first's list."""
    from repro_torch.models import layers as L
    if hasattr(L.moe_route, "seen"):
        return L.moe_route.seen
    seen, route = [], L.moe_route

    def recorded(router, xf, cfg):
        out = route(router, xf, cfg)
        top = out[0].topk(out[2].shape[1] + 1, dim=-1).values
        seen.append((out[2].clone(),
                     (top[:, :-1] - top[:, 1:]).min(-1).values))
        return out

    recorded.seen = seen
    L.moe_route = recorded
    return seen


def _first_parting(plain: list, mine: list):
    """Where two runs' routing decisions first part: ``None``, or the
    call, the picks parted there and the largest of their gaps in
    ``plain``."""
    import torch
    if len(plain) != len(mine):
        raise AssertionError(f"{len(mine)} routing calls against "
                             f"{len(plain)} unmeshed")
    for i, ((ia, ga), (ib, _)) in enumerate(zip(plain, mine)):
        if not torch.equal(ia, ib):
            parted = (ia != ib).any(-1)
            return {"call": i, "of": len(plain),
                    "picks": int(parted.sum().item()),
                    "gap": ga[parted].max().item()}
    return None


def _family_round_runs(name: str, layers, dtype: str, meshes: dict, *,
                       exact: bool) -> dict:
    """``MESH_ROUNDS`` on ``name`` (cut to ``layers``, ``dtype``) unmeshed
    and on every mesh of ``meshes``, each trainer from the same seeded
    weights (a meshed one draws only its pieces: ``init_params(tp=)``) and
    freed before the next.  ``exact``: every mesh gives the unmeshed
    records, global and stacked adapters bit for bit; otherwise the
    cohorts, edits and ranks exactly, the losses within 1e-4 and the
    global by ``_adapters_close``.  Every rank's global is the same bit for
    bit; ``dim_agg`` / ``dim_agg_trimmed`` launch once a round."""
    import dataclasses
    import gc

    import torch

    from repro_torch.kernels import dim_agg as DK
    from repro_torch.models.tensor_parallel import TensorParallel
    from repro_torch.models.transformer import init_params

    cfg = dataclasses.replace(_family_cfg(name, layers), dtype=dtype)
    task = (dict(image_dim=cfg.vision_dim, num_patches=VISION_PATCHES)
            if cfg.family == "vlm" else None)
    out = {"layers": cfg.num_layers, "dtype": dtype}
    routes = _route_recorder() if not exact and cfg.moe is not None else []
    for agg, rounds, kw in MESH_ROUNDS:
        runs = {}
        for mname, mesh in [("unmeshed", None)] + list(meshes.items()):
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            tp = None if mesh is None else TensorParallel(cfg, mesh)
            base = init_params(cfg, seed=0, tp=tp)
            _open_gates(base, VISION_GATE)
            tr = fed_setup(agg, base=base, cfg=cfg, task=task, mesh=mesh,
                           split=tp is not None, **MESH_FAMILY_FED, **kw)
            del base
            DK.reset_launches()
            if mesh is not None:
                mesh.reset_collectives()
            routes.clear()
            recs, walls = [], []
            for _ in range(rounds):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                recs.append(tr.run_round())
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            key = "dim_agg_trimmed" if "trimmed" in agg else "dim_agg"
            if DK.launches[key] != rounds:
                raise AssertionError(f"mesh_families {name} {mname} {agg}: "
                                     f"launches {dict(DK.launches)}, "
                                     f"expected {rounds} {key}")
            if not all(math.isfinite(r["train_loss"]) for r in recs):
                raise AssertionError(f"mesh_families {name} {mname} {agg}: "
                                     f"losses {recs}")
            runs[mname] = {
                "recs": recs, "walls": walls, "launches": dict(DK.launches),
                "ranks": tr.client_ranks.copy(),
                "global": _clone_tree(tr.server.global_lora),
                "stacked": _clone_tree(tr.stacked_lora),
                "steps": tr.fcfg.local_steps, "lr": tr.ocfg.peak_lr,
                "routes": list(routes),
                "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                "collectives": ({} if mesh is None else {
                    f"{op}.{ax}": n for (op, ax), n in
                    mesh.collectives.items()})}
            del tr
        plain = runs.pop("unmeshed")
        res = {"unmeshed": {k: plain[k] for k in ("walls", "peak_gb")}}
        for mname, r in runs.items():
            flat = torch.cat([e[m].reshape(-1) for e in r["global"].values()
                              for m in "AB"])
            every = [torch.empty_like(flat) for _ in
                     range(torch.distributed.get_world_size())]
            torch.distributed.all_gather(every, flat)
            if not all(torch.equal(f, flat) for f in every):
                raise AssertionError(f"mesh_families {name} {mname} {agg}: "
                                     "the ranks' globals differ")
            if exact:
                same = r["recs"] == plain["recs"] and all(
                    torch.equal(r[t][n][m], plain[t][n][m])
                    for t in ("global", "stacked") for n in plain[t]
                    for m in "AB")
                if not same:
                    raise AssertionError(f"mesh_families {name} {mname} "
                                         f"{agg}: not bit for bit the "
                                         "unmeshed rounds")
                err = {"max_abs_err": 0.0, "bit_equal": True}
            elif (parting := _round_parting(plain, r, mesh)) is not None:
                err = {"routes_parted": parting, **_adapters_close(
                    r["global"], plain["global"], rounds, r["steps"],
                    r["lr"])}
            else:
                for a, b in zip(r["recs"], plain["recs"]):
                    if (a["sampled"], a["edited_layers"]) != (
                            b["sampled"], b["edited_layers"]) or abs(
                            a["train_loss"] - b["train_loss"]) > 1e-4:
                        raise AssertionError(f"mesh_families {name} {mname}"
                                             f" {agg}: {a} vs {b}")
                if not (r["ranks"] == plain["ranks"]).all():
                    raise AssertionError(f"mesh_families {name} {mname} "
                                         f"{agg}: ranks differ")
                err = _adapters_close(r["global"], plain["global"], rounds,
                                      r["steps"], r["lr"])
                if not err["within_tol"]:
                    raise AssertionError(f"mesh_families {name} {mname} "
                                         f"{agg}: global adapters {err}")
            res[mname] = {"walls": r["walls"], "launches": r["launches"],
                          "collectives": r["collectives"],
                          "peak_gb": r["peak_gb"],
                          "losses": [x["train_loss"] for x in r["recs"]],
                          **err}
        out[agg] = res
    return out


def _round_parting(plain: dict, run: dict, mesh):
    """The first parting of a meshed round's routing from the unmeshed
    round's (``_first_parting``), ``None`` where they agree; raises where
    the first parted picks were no near ties.  A rank of the client axis
    trains its block of each round's cohort, so its calls are that
    block's share of the unmeshed run's, round by round."""
    if not plain["routes"]:
        return None
    n_rounds, n_s = len(plain["recs"]), len(plain["recs"][0]["sampled"])
    groups = mesh.shape["client"]
    per = len(plain["routes"]) // (n_rounds * n_s)     # one client's calls
    c, m = mesh.coord("client"), n_s // groups
    mine = [x for r in range(n_rounds) for x in plain["routes"][
        (r * n_s + c * m) * per:(r * n_s + (c + 1) * m) * per]]
    parting = _first_parting(mine, run["routes"])
    if parting is not None and not parting["gap"] <= ROUTE_TIE:
        raise AssertionError(f"routing parted from the unmeshed run at "
                             f"picks that were no near tie: {parting}")
    return parting


def _family_serve_runs(name: str, layers, dtype: str, meshes: dict) -> dict:
    """``name`` (cut to ``layers``, ``dtype``) serving
    ``MESH_FAMILY_REQUESTS`` requests through ``lora_backend="grouped"``
    unmeshed and on every mesh of ``meshes`` (the engine cuts the whole
    weights): the same tokens, request for request, and one BGMV call a
    banked site a block for every serve/prefill call."""
    import dataclasses
    import gc

    import numpy as np
    import torch

    from repro_torch.kernels import grouped_lora_matmul as glm
    from repro_torch.models.transformer import init_params

    cfg = dataclasses.replace(_family_cfg(name, layers), dtype=dtype)
    chunk = next(c for n, _, c, *_ in FAMILIES if n == name)
    rng = np.random.default_rng(11)
    adapters = make_adapters(cfg, rng, FAMILY_TENANTS)
    reqs = family_requests(cfg, rng, MESH_FAMILY_REQUESTS)
    params = init_params(cfg, seed=0)
    toks, out = {}, {"layers": cfg.num_layers, "dtype": dtype}
    meshed_tp = any(m.shape.get("model", 1) > 1 for m in meshes.values())
    routes = _route_recorder() if meshed_tp and cfg.moe is not None else []
    seen = {}
    for mname, mesh in [("unmeshed", None)] + list(meshes.items()):
        gc.collect()
        torch.cuda.empty_cache()
        routes.clear()
        eng = family_engine(cfg, params, adapters, backend="grouped",
                            prefill_chunk=chunk, mesh=mesh)
        if mesh is not None:
            mesh.reset_collectives()
        glm.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = eng.run([dataclasses.replace(q) for q in reqs])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        dc = eng.dispatch_count
        calls = dc["serve_step"] + dc["serve_prefill"]
        want = _bgmv_sites(cfg) * cfg.num_blocks * calls
        if glm.launches != want or not want:
            raise AssertionError(f"mesh_families serve {name} {mname}: "
                                 f"BGMV launched {glm.launches} times, "
                                 f"expected {want}")
        toks[mname] = [d["tokens"].tolist() for d in
                       sorted(done, key=lambda d: d["uid"])]
        seen[mname] = list(routes)
        out[mname] = {"wall_s": wall, "launches": glm.launches,
                      "steps": eng.steps,
                      "collectives": ({} if mesh is None else {
                          f"{op}.{ax}": n for (op, ax), n in
                          mesh.collectives.items()})}
        del eng
    for mname in meshes:
        if toks[mname] == toks["unmeshed"]:
            continue
        bad = sum(a != b for a, b in zip(toks[mname], toks["unmeshed"]))
        parting = (_first_parting(seen["unmeshed"], seen[mname])
                   if seen["unmeshed"] else None)
        if parting is None or not parting["gap"] <= ROUTE_TIE:
            raise AssertionError(f"mesh_families serve {name} {mname} "
                                 f"({dtype}): tokens of {bad} requests "
                                 f"differ from unmeshed (routing parting "
                                 f"{parting})")
        out[mname].update(routes_parted=parting, requests_parted=bad)
    return out


def _jamba_uncut(mesh) -> dict:
    """jamba-v0.1-52b at its published depth, bf16, each rank drawing only
    its pieces (``init_params(tp=)``): a (1, 4) ``("data", "model")``
    engine serves ``JAMBA_REQUESTS`` requests of ``FAMILY_TENANTS``
    tenants (peak memory per rank, generated tokens/s); then the weights
    are cast to f32 leaf by leaf and the same mesh's ``decode_step``
    streams ``JAMBA_DVF`` positions against one ``forward`` with an
    adapter, at a capacity that drops nothing, within
    ``FAMILY_DECODE_ATOL`` on every rank's vocabulary columns."""
    import dataclasses
    import gc

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import grouped_lora_matmul as glm
    from repro_torch.models.tensor_parallel import TensorParallel
    from repro_torch.models.transformer import (decode_step, forward,
                                                init_cache, init_params)

    cfg = get_config(JAMBA)
    tp = TensorParallel(cfg, mesh)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, tp=tp)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    # the draw holds one whole sublayer beside the pieces: its peak apart
    init_peak = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    local = sum(v.numel() for v in _leaves(params))
    rng = np.random.default_rng(12)
    adapters = make_adapters(cfg, rng, FAMILY_TENANTS)
    reqs = family_requests(cfg, rng, JAMBA_REQUESTS)
    eng = family_engine(cfg, params, adapters, backend="grouped",
                        prefill_chunk=None, mesh=mesh, split=True)
    mesh.reset_collectives()
    glm.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    dc = eng.dispatch_count
    calls = dc["serve_step"] + dc["serve_prefill"]
    want = _bgmv_sites(cfg) * cfg.num_blocks * calls
    if glm.launches != want or not want:
        raise AssertionError(f"jamba uncut: BGMV launched {glm.launches} "
                             f"times, expected {want}")
    for d in done:
        if d["status"] != "ok" or not (
                (d["tokens"] >= 0) & (d["tokens"] < cfg.vocab_size)).all():
            raise AssertionError(f"jamba uncut request {d['uid']}: {d}")
    tokens = sum(q.gen_len for q in reqs)
    peak = torch.cuda.max_memory_allocated() / 1e9
    rec = {"layers": cfg.num_layers, "params_local": local,
           "init_s": init_s, "requests": len(reqs), "steps": eng.steps,
           "wall_s": wall, "generated_tokens": tokens,
           "tokens_per_s": tokens / wall, "launches": glm.launches,
           "collectives": {f"{op}.{ax}": n for (op, ax), n in
                           mesh.collectives.items()}}
    del eng, done
    gc.collect()                      # the engine's closures hold params
    # f32 decode vs forward over the same weights, cast leaf by leaf
    torch.cuda.reset_peak_memory_stats()
    _to_f32_in_place(params)
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(_family_cfg(JAMBA, None, no_drop=True),
                                dtype="float32")
    lora = tp.local_lora(_cuda_adapter(cfg32, 13))
    B, S = JAMBA_DVF
    toks = torch.from_numpy(np.random.default_rng(14).integers(
        0, cfg.vocab_size, (B, S))).cuda()
    t0 = time.perf_counter()
    full, _ = forward(cfg32, params, toks, lora=lora,
                      lora_scale=FAMILY_LORA_SCALE, tp=tp)
    cache = init_cache(cfg32, params, B, S, lora=lora,
                       lora_scale=FAMILY_LORA_SCALE, tp=tp)
    errs = []
    for t in range(S):
        lg, cache = decode_step(cfg32, params, cache, toks[:, t], t,
                                lora=lora, lora_scale=FAMILY_LORA_SCALE,
                                tp=tp)
        errs.append((lg - full[:, t].float()).abs().max())
    err = tp.mesh.all_reduce(torch.stack(errs).max().reshape(1), "model",
                             op="max").item()
    scale = tp.mesh.all_reduce(full.abs().max().float().reshape(1), "model",
                               op="max").item()
    peaks = tp.mesh.all_gather(torch.tensor(
        [init_peak, peak, torch.cuda.max_memory_allocated() / 1e9],
        device="cuda"), "model").reshape(-1, 3)
    rec.update({"decode_vs_forward_err": err, "forward_max_abs": scale,
                "decode_vs_forward_s": time.perf_counter() - t0,
                "decode_batch": B, "decode_positions": S,
                "capacity_factor": cfg32.moe.capacity_factor,
                "peak_init_gb_per_rank": peaks[:, 0].tolist(),
                "peak_serve_gb_per_rank": peaks[:, 1].tolist(),
                "peak_f32_check_gb_per_rank": peaks[:, 2].tolist()})
    if not err <= FAMILY_DECODE_ATOL:
        raise AssertionError(f"jamba uncut f32: decode vs forward max err "
                             f"{err:.3e} beyond {FAMILY_DECODE_ATOL}")
    del params, cache, full
    return rec


def _to_f32_in_place(tree: dict) -> None:
    """Replace every floating leaf of ``tree`` by its f32 copy, one at a
    time, so the memory of both copies is never held at once."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _to_f32_in_place(v)
        elif v.is_floating_point():
            tree[k] = v.float()


def _mesh_families_rank(rank: int, world: int, rdv: str, out_path: str,
                        parts: tuple) -> None:
    """One rank of the mesh_families phase (spawned): NCCL over ``world``
    cards, the kernel entry points held (``_held_kernels``), then
    ``parts``; rank 0 writes the record to ``out_path``."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import Mesh, init_distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    init_distributed(init_method=f"file://{rdv}", world_size=world,
                     rank=rank)
    held = _held_kernels()
    one = world == 1
    res = {"ran": []}
    try:
        for part in parts:
            t0 = time.perf_counter()
            if part == "rounds":
                meshes = ({"client x model(1x1)": Mesh(
                    (1, 1), ("client", "model"))} if one else
                    {"client x model(2x2)": Mesh((2, 2), ("client",
                                                          "model"))})
                res[part] = {name: _family_round_runs(
                    name, layers if one else f32, "bfloat16" if one
                    else "float32", meshes, exact=one)
                    for name, layers, f32 in MESH_FAMILIES}
            elif part == "serve":
                meshes = {f"data x model(1x{world})": Mesh(
                    (1, world), ("data", "model"))}
                res[part] = {name: _family_serve_runs(
                    name, layers if one else f32, "bfloat16" if one
                    else "float32", meshes)
                    for name, layers, f32 in MESH_FAMILIES
                    if name in MESH_SERVED}
            elif part == "jamba":
                res[part] = _jamba_uncut(Mesh((1, world), ("data", "model")))
            res["ran"].append(part)
            res.setdefault("wall_s", {})[part] = time.perf_counter() - t0
        res["held"] = {k: dict(v, shapes=sorted(v["shapes"]))
                       for k, v in held.items()}
        if rank == 0:
            with open(out_path, "w") as f:
                json.dump(res, f, default=float)
    finally:
        dist.destroy_process_group()


def _print_mesh_families(world: int, res: dict) -> None:
    for name, r in res.get("rounds", {}).items():
        for agg in (a for a, *_ in MESH_ROUNDS):
            for mname, v in r[agg].items():
                if mname == "unmeshed":
                    continue
                print(f"mesh_families ({world} ranks): {name} "
                      f"{r['dtype']} {r['layers']} layers, {agg} on {mname}:"
                      f" losses {[round(x, 6) for x in v['losses']]}, walls "
                      f"{[round(w, 3) for w in v['walls']]} s (unmeshed "
                      f"{[round(w, 3) for w in r[agg]['unmeshed']['walls']]}"
                      f" s), peak {v['peak_gb']:.1f} GB, global max err "
                      f"{v['max_abs_err']:.3e}"
                      f"{' (bit for bit)' if v.get('bit_equal') else ''}"
                      f"{_parting_note(v)}, "
                      f"launches {v['launches']}, collectives "
                      f"{v['collectives']}", flush=True)
    for name, r in res.get("serve", {}).items():
        for mname, v in r.items():
            if not isinstance(v, dict):
                continue
            same = ("tokens equal to unmeshed" if "routes_parted" not in v
                      else f"tokens of {v['requests_parted']} requests "
                      f"parted{_parting_note(v)}")
            print(f"mesh_families ({world} ranks): serve {name} "
                  f"{r['dtype']} {r['layers']} layers on {mname}: {same}, "
                  f"{v['steps']} steps, "
                  f"{v['wall_s']:.2f} s, BGMV launches {v['launches']}, "
                  f"collectives {v['collectives']}", flush=True)
    if "jamba" in res:
        j = res["jamba"]
        print(f"mesh_families ({world} ranks): {JAMBA} uncut "
              f"({j['layers']} layers, {j['params_local'] / 1e9:.2f} B "
              f"parameters a rank) bf16 on data x model(1x{world}): "
              f"{j['requests']} requests, {j['steps']} steps, "
              f"{j['wall_s']:.2f} s, {j['tokens_per_s']:.1f} generated "
              f"tokens/s, peak GB per rank serving "
              f"{[round(x, 1) for x in j['peak_serve_gb_per_rank']]}, "
              f"drawing the weights "
              f"{[round(x, 1) for x in j['peak_init_gb_per_rank']]}, in the "
              f"f32 check "
              f"{[round(x, 1) for x in j['peak_f32_check_gb_per_rank']]}; f32 "
              f"decode vs forward over {j['decode_batch']} x "
              f"{j['decode_positions']} positions max err "
              f"{j['decode_vs_forward_err']:.3e} (limit "
              f"{FAMILY_DECODE_ATOL}, logits up to "
              f"{j['forward_max_abs']:.2f})", flush=True)
    for k, v in res["held"].items():
        print(f"mesh_families ({world} ranks): {k} held against its plain "
              f"version at {v['held']} launches, max err "
              f"{v['max_abs_err']:.3e}, shapes {v['shapes']}", flush=True)


def _parting_note(v: dict) -> str:
    p = v.get("routes_parted")
    if p is None:
        return ""
    return (f" (MoE routing parted from the unmeshed run at call "
            f"{p['call']} of {p['of']}, {p['picks']} picks, probability gaps"
            f" up to {p['gap']:.2e}: near ties; the runs not held to each "
            "other)")


def phase_mesh_families(dev_name: str) -> dict:
    """The round and serving meshes on the Mamba-2, hybrid Jamba, MLA +
    MoE and cross VLM stacks at published widths (``MESH_FAMILIES``):
    world size 1 on one card in bf16 — (1, 1) round meshes and (1, 1)
    engines, each bit for bit the unmeshed run from the same weights —
    and with 4 cards or more also a 2x2 round and a 1x4 tensor-parallel
    engine in f32 against the unmeshed f32 run on each rank, then
    jamba-v0.1-52b uncut on a (1, 4) engine (``_jamba_uncut``).  Every
    launch of BGMV, ``dim_agg`` and ``dim_agg_trimmed`` in those runs is
    held against its plain version."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()          # the ranks share the card's memory
    n_dev = torch.cuda.device_count()
    out = {"devices": n_dev,
           "one": _spawn_mesh(1, ("rounds", "serve"),
                              target=_mesh_families_rank)}
    _print_mesh_families(1, out["one"])
    if n_dev >= 4:
        out["four"] = _spawn_mesh(4, ("rounds", "serve", "jamba"),
                                  target=_mesh_families_rank, timeout=1500)
        _print_mesh_families(4, out["four"])
    ran = {k: out[k]["ran"] for k in ("one", "four") if k in out}
    print(f"mesh_families: ran {ran} ({n_dev} device"
          f"{'s' if n_dev != 1 else ''}; the four-card part "
          f"{'ran' if n_dev >= 4 else 'did not run: it needs 4'})",
          flush=True)
    return out


# ---------------------------------------------------------------------------
# analysis: the dry run's tracer and roofline held against the card
# ---------------------------------------------------------------------------

ANALYSIS_RANK = 32
# the steps run for real at world size 1 and traced at the same sizes:
# name -> (arch, kind, batch, seq, microbatches); each peaks above 4 GB
ANALYSIS_STEPS = {"train": ("qwen2-0.5b", "train", 4, 2048, 2),
                  "prefill": ("qwen2-0.5b", "prefill", 32, 4096, None),
                  "serve": ("qwen2-0.5b", "decode", 64, 4096, None)}
# fedbench-100m's round: clients, local steps, batch, sequence, ranks
ANALYSIS_ROUND = ("fedbench-100m", 4, 10, 8, 1024, (8, 16, 24, 32))
# the 2x2 round of the four-card part (clients = the "data" axis)
ANALYSIS_MESH_ROUND = ("fedbench-100m", 2, 4, 8, 256)
ANALYSIS_PEAK_TOL = 0.15
ANALYSIS_TIMEOUT_S = 300
ANALYSIS_MATMUL_N = 8192
ANALYSIS_COPY_BYTES = 2 << 30
ANALYSIS_ALLREDUCE_BYTES = 256 << 20


def _bf16_config(arch: str):
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch), dtype="bfloat16")


def _rand_batch(cfg, lead: tuple, seq: int, gen, dev, labels: bool = True):
    """A batch ``{tokens, [labels, loss_mask,] [image, image_mask]}`` of
    leading shape ``lead``, drawn from ``gen`` on ``dev``."""
    import torch

    from repro_torch.models.transformer import torch_dtype
    ints = lambda: torch.randint(0, cfg.vocab_size, lead + (seq,),
                                 generator=gen, device=dev)
    b = {"tokens": ints()}
    if labels:
        b["labels"] = ints()
        b["loss_mask"] = torch.ones(lead + (seq,), device=dev)
    if cfg.family == "vlm":
        b["image"] = torch.randn(lead + (cfg.num_vision_tokens,
                                         cfg.vision_dim), generator=gen,
                                 device=dev).to(torch_dtype(cfg.dtype))
        if labels:
            b["image_mask"] = (torch.rand(lead, generator=gen, device=dev)
                               < 0.6).float()
    return b


def analysis_inputs(name: str, dev) -> tuple:
    """``(step, args, cfg, analytic InputShape or None)`` of one of the
    analysis phase's steps on ``dev``, bf16 weights from a seed (the
    adapters' ``B`` drawn too, so every product is live)."""
    import torch

    from repro_torch.core.lora import LoRAConfig, init_lora_params
    from repro_torch.launch import steps as S
    from repro_torch.launch.fedround import make_fed_round_step
    from repro_torch.launch.specs import InputShape
    from repro_torch.models import transformer as T
    from repro_torch.optim import OptimizerConfig, adamw_init

    gdev = "cpu" if torch.device(dev).type == "meta" else dev  # sizing
    gen = torch.Generator(device=gdev).manual_seed(7)
    seeded = lambda seed: torch.Generator(device=gdev).manual_seed(seed)
    scale = 16.0 / ANALYSIS_RANK
    if name == "round":
        arch, K, steps, B, seq, ranks = ANALYSIS_ROUND
        cfg = _bf16_config(arch)
        loras = [init_lora_params(T.lora_specs(cfg),
                                  LoRAConfig(rank=ANALYSIS_RANK),
                                  generator=gen, client_rank=r, device=dev)
                 for r in ranks]
        stacked = {n: {m: torch.stack([lo[n][m] for lo in loras])
                       for m in ("A", "B")} for n in loras[0]}
        args = (T.init_params(cfg, generator=seeded(42), device=dev),
                stacked, loras[-1],
                torch.tensor(ranks, dtype=torch.int32, device=dev),
                torch.full((K,), 1.0 / K, device=dev),
                _rand_batch(cfg, (K, steps, B), seq, gen, dev))
        return {agg: make_fed_round_step(
            cfg, OptimizerConfig(peak_lr=1e-3, total_steps=100),
            lora_scale=scale, r_g=ANALYSIS_RANK, aggregator=agg)
            for agg in ("fedilora", "fedilora_kernel")}, args, cfg, None
    arch, kind, B, seq, micro = ANALYSIS_STEPS[name]
    cfg = _bf16_config(arch)
    params = T.init_params(cfg, generator=seeded(0), device=dev)
    lora = init_lora_params(T.lora_specs(cfg), LoRAConfig(rank=ANALYSIS_RANK),
                            generator=gen, device=dev)
    for e in lora.values():
        e["B"].normal_(0.0, 0.02, generator=gen)
    shape = InputShape(name, seq, B, kind)
    if kind == "train":
        step = S.make_train_step(cfg, OptimizerConfig(peak_lr=1e-4),
                                 lora_scale=scale, num_microbatches=micro)
        args = (params, lora, adamw_init(lora),
                _rand_batch(cfg, (B,), seq, gen, dev))
    elif kind == "prefill":
        step = S.make_prefill_step(cfg, lora_scale=scale)
        args = (params, lora, _rand_batch(cfg, (B,), seq, gen, dev,
                                          labels=False))
    else:
        serve = S.make_serve_step(cfg, lora_scale=scale)
        step = lambda p, lo, c, t: serve(p, lo, c, t, seq - 1)
        args = (params, lora, T.init_cache(cfg, params, B, seq),
                torch.randint(0, cfg.vocab_size, (B,), generator=gen,
                              device=dev))
    return step, args, cfg, shape


def analysis_trace(name: str, step, args) -> dict:
    """The dry run's tracer over ``step`` at ``args``' sizes, on meta
    copies (CPU): FLOPs, bytes, the predicted peak and the traced
    roofline terms."""
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import roofline as RL
    from repro_torch.launch.specs import tree_bytes
    meta = D.meta_copy(args)
    t = D.trace(step, *meta)
    arg_bytes = tree_bytes(args)
    return {"flops": t.flops, "bytes_accessed": t.bytes_accessed,
            "args_bytes": arg_bytes, "temp_bytes": t.peak,
            "peak_bytes": arg_bytes + t.peak, "ops": t.ops,
            "trace_s": t.seconds,
            "roofline": RL.roofline({"flops": t.flops,
                                     "bytes accessed": t.bytes_accessed},
                                    {"total_bytes": 0}).as_dict()}


def _analytic_one_card(cfg, shape, micro) -> dict:
    from repro_torch.launch.analytic import MeshInfo, analytic_terms
    at = analytic_terms(cfg, shape, MeshInfo(chips=1, dp=1, tp=1, fsdp=1),
                        rank=ANALYSIS_RANK, num_micro=micro)
    r = at.roofline()
    return {k: r[k] for k in ("compute_s", "memory_s", "collective_s",
                              "dominant", "flops_per_device",
                              "hbm_bytes_per_device")}


def _real_run(step, args) -> dict:
    """The step on the card: its peak above the arguments (after a
    warm-up call), its CUDA-event time and ``FlopCounterMode``'s FLOPs."""
    import gc

    import torch
    from torch.utils.flop_counter import FlopCounterMode
    step(*args)                                   # warm-up (cuBLAS, caches)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = step(*args)
    torch.cuda.synchronize()
    above = torch.cuda.max_memory_allocated() - base
    del out
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    out = step(*args)
    e1.record()
    torch.cuda.synchronize()
    ms = e0.elapsed_time(e1)
    del out
    with FlopCounterMode(display=False) as fc:
        out = step(*args)
    torch.cuda.synchronize()
    del out
    return {"temp_bytes": above, "ms": ms, "flops": fc.get_total_flops()}


def _measured_rates(dev_name: str) -> dict:
    """The card's achieved bf16 matmul rate at 8192^3 and its 2 GiB
    device-to-device copy rate, beside the data-sheet peaks."""
    import torch

    from repro_torch.launch import roofline as RL
    n = ANALYSIS_MATMUL_N
    gen = torch.Generator(device="cuda").manual_seed(3)
    a = torch.randn((n, n), device="cuda", generator=gen).bfloat16()
    b = torch.randn((n, n), device="cuda", generator=gen).bfloat16()
    mm_ms = cuda_time_ms(torch.matmul, [(a, b)], iters=20, warmup=3)
    del a, b
    src = torch.empty(ANALYSIS_COPY_BYTES, dtype=torch.uint8, device="cuda")
    dst = torch.empty_like(src)
    cp_ms = cuda_time_ms(lambda x, y: y.copy_(x), [(src, dst)], iters=20,
                         warmup=3)
    del src, dst
    torch.cuda.empty_cache()
    bw, bf16, _ = RL.peaks_for(dev_name)
    tflops = 2 * n ** 3 / (mm_ms * 1e-3) / 1e12
    gbs = 2 * ANALYSIS_COPY_BYTES / (cp_ms * 1e-3) / 1e9   # read + write
    return {"matmul_bf16_ms": mm_ms, "matmul_bf16_tflops": tflops,
            "copy_ms": cp_ms, "copy_gb_s": gbs,
            "datasheet_bf16_tflops": bf16 / 1e12,
            "datasheet_hbm_gb_s": bw / 1e9,
            "matmul_share": tflops / (bf16 / 1e12),
            "copy_share": gbs / (bw / 1e9)}


def _dryrun_cli(out_dir: str) -> list:
    """Start the dry-run CLI (qwen2-0.5b, every shape, 16x16; and the
    fedbench-100m round) as subprocesses on the host's cores."""
    env = dict(os.environ, PYTHONPATH=SRC)
    base = [sys.executable, "-m", "repro_torch.launch.dryrun", "--mesh",
            "single", "--out", out_dir]
    return [subprocess.Popen(base + a, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True, env=env,
                             cwd=ROOT)
            for a in (["--arch", "qwen2-0.5b", "--shape", "all", "--jobs",
                       "3"], ["--fedround", "--arch", "fedbench-100m"])]


def _dryrun_records(procs, out_dir: str) -> dict:
    """Wait for the CLI runs; each must exit 0 and leave its records."""
    recs = {}
    for p in procs:
        out, _ = p.communicate(timeout=ANALYSIS_TIMEOUT_S)
        if p.returncode != 0:
            raise AssertionError(f"dry run {p.args[3:]} exited "
                                 f"{p.returncode}:\n{out[-3000:]}")
    names = [f"qwen2-0.5b__{s}__16x16" for s in
             ("train_4k", "prefill_32k", "decode_32k", "long_500k")] + [
        "fedbench-100m__fedround__16x16"]
    for n in names:
        with open(os.path.join(out_dir, n + ".json")) as f:
            rec = json.load(f)
        if "error" in rec:
            raise AssertionError(f"dry run {n}: {rec['error']}")
        recs[n] = rec
    if "skipped" not in recs["qwen2-0.5b__long_500k__16x16"]:
        raise AssertionError("qwen2-0.5b long_500k was not skipped")
    return recs


def _fake_round_trace(out_path: str) -> None:
    """The four-card round traced on a fake 4-rank process group (run in
    a subprocess of its own): rank 0's collective schema to ``out_path``."""
    import torch.distributed as dist

    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_debug_mesh
    arch, K, steps, B, seq = ANALYSIS_MESH_ROUND
    D.fake_process_group(4)
    rec = D.dryrun_fedround(arch, multi_pod=False, mesh=make_debug_mesh(2, 2),
                            cfg=_bf16_config(arch), rank=ANALYSIS_RANK,
                            local_steps=steps, client_batch=B, seq=seq)
    dist.destroy_process_group()
    with open(out_path, "w") as f:
        json.dump(rec, f)


def _analysis_rank(rank: int, world: int, rdv: str, out_path: str,
                   parts: tuple) -> None:
    """One rank of the analysis phase's four-card part: the 2x2 fed round
    step on NCCL (its collectives counted on the mesh) and the bus
    bandwidth of a 256 MiB all-reduce over the four ranks."""
    import torch
    import torch.distributed as dist

    from repro_torch.core.lora import LoRAConfig, init_lora_params
    from repro_torch.launch import roofline as RL
    from repro_torch.launch.fedround import make_fed_round_step
    from repro_torch.launch.mesh import Mesh, init_distributed
    from repro_torch.models import transformer as T
    from repro_torch.models.tensor_parallel import TensorParallel
    from repro_torch.optim import OptimizerConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = init_distributed(init_method=f"file://{rdv}", world_size=world,
                           rank=rank)
    res = {}
    try:
        arch, K, steps, B, seq = ANALYSIS_MESH_ROUND
        cfg = _bf16_config(arch)
        mesh = Mesh((2, 2), ("data", "model"))
        gen = torch.Generator(device=dev).manual_seed(11)
        lora = init_lora_params(T.lora_specs(cfg),
                                LoRAConfig(rank=ANALYSIS_RANK), generator=gen)
        stacked = {n: {m: torch.stack([e[m]] * K) for m in ("A", "B")}
                   for n, e in lora.items()}
        step = make_fed_round_step(
            cfg, OptimizerConfig(peak_lr=1e-3, total_steps=100),
            lora_scale=16.0 / ANALYSIS_RANK, r_g=ANALYSIS_RANK,
            aggregator="fedilora_kernel", mesh=mesh)
        params = T.init_params(cfg, seed=42, device=dev,
                               tp=TensorParallel(cfg, mesh))
        batches = _rand_batch(cfg, (K, steps, B), seq, gen, dev)
        args = (params, stacked, lora,
                torch.full((K,), ANALYSIS_RANK, dtype=torch.int32,
                           device=dev),
                torch.full((K,), 1.0 / K, device=dev), batches)
        mesh.reset_collectives()
        t0 = time.perf_counter()
        g, _, loss = step(*args)
        torch.cuda.synchronize()
        res["round_s"] = time.perf_counter() - t0
        res["loss"] = float(loss)
        res["collectives"] = RL.collective_bytes(mesh)
        # NCCL all-reduce bus bandwidth: 2 (n - 1) / n of the bytes a rank
        # sends and receives, over the time
        x = torch.ones(ANALYSIS_ALLREDUCE_BYTES // 4, device=dev)
        for _ in range(3):
            dist.all_reduce(x)
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(10):
            dist.all_reduce(x)
        e1.record()
        torch.cuda.synchronize()
        ms = e0.elapsed_time(e1) / 10
        res["allreduce_ms"] = ms
        res["allreduce_busbw_gb_s"] = (2 * (world - 1) / world
                                       * ANALYSIS_ALLREDUCE_BYTES
                                       / (ms * 1e-3) / 1e9)
        if rank == 0:
            with open(out_path, "w") as f:
                json.dump(res, f, default=float)
    finally:
        dist.destroy_process_group()


def analysis_four() -> dict:
    """The analysis phase's four-card part: the 2x2 round on NCCL, its
    collective counts and bytes held equal to a fake-process-group trace
    of the same round (traced in a subprocess of its own), and the bus
    bandwidth of a 256 MiB all-reduce."""
    fake_path = os.path.join(ROOT, "build", "analysis_fake_round.json")
    code = ("import sys; sys.path.insert(0, %r); sys.path.insert(0, %r);"
            " import chip_smoke; chip_smoke._fake_round_trace(%r)"
            % (SRC, ROOT, fake_path))
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT,
                   timeout=ANALYSIS_TIMEOUT_S)
    with open(fake_path) as f:
        fake = json.load(f)
    four = _spawn_mesh(4, ("round",), target=_analysis_rank,
                       timeout=ANALYSIS_TIMEOUT_S)
    if four["collectives"] != fake["collectives"]:
        raise AssertionError(f"analysis 2x2 round: collectives "
                             f"{four['collectives']} differ from the "
                             f"fake trace's {fake['collectives']}")
    print(f"analysis 2x2 round: collectives equal to the fake trace's "
          f"({four['collectives']['counts']}, "
          f"{four['collectives']['total_bytes']} bytes), round "
          f"{four['round_s']:.2f} s; NCCL all-reduce of 256 MiB "
          f"{four['allreduce_ms']:.3f} ms, bus bandwidth "
          f"{four['allreduce_busbw_gb_s']:.1f} GB/s", flush=True)
    return {"real": four, "fake": fake["collectives"]}


def phase_analysis(dev_name: str) -> dict:
    """The analysis tooling held against the card: the card's measured
    matmul and copy rates beside its data-sheet peaks; the dry-run CLI on
    qwen2-0.5b (every shape, 16x16) and the fedbench-100m round, as
    subprocesses; four steps at world size 1 with bf16 weights, each traced
    with the dry run's tracer at the same sizes and run for real — the
    real ``FlopCounterMode`` count equal to the trace's, the real peak
    (arguments + ``max_memory_allocated`` above them) within 15 % of the
    predicted one, the CUDA-event time printed beside the analytic and the
    traced roofline times; ``make_fed_round_step(aggregator=
    "fedilora_kernel")`` against ``"fedilora"`` from the same state, one
    ``dim_agg`` launch a step; with 4 cards or more a 2x2 round whose
    collectives equal a fake-process-group trace's, and an all-reduce's
    bus bandwidth."""
    import gc

    import torch

    from repro_torch.kernels import dim_agg as DK

    out_dir = os.path.join(ROOT, "build", "analysis_dryrun")
    os.makedirs(out_dir, exist_ok=True)
    procs = _dryrun_cli(out_dir)
    out = {"rates": _measured_rates(dev_name)}
    r = out["rates"]
    print(f"analysis: measured bf16 matmul {r['matmul_bf16_tflops']:.1f} "
          f"TFLOP/s ({100 * r['matmul_share']:.1f} % of the data sheet's "
          f"{r['datasheet_bf16_tflops']:.0f}), 2 GiB copy "
          f"{r['copy_gb_s']:.0f} GB/s ({100 * r['copy_share']:.1f} % of "
          f"{r['datasheet_hbm_gb_s']:.0f}) on {dev_name}", flush=True)
    steps = {}
    for name in list(ANALYSIS_STEPS) + ["round"]:
        gc.collect()
        torch.cuda.empty_cache()
        step, args, cfg, shape = analysis_inputs(name, "cuda")
        if name == "round":
            kernel_step, step = step["fedilora_kernel"], step["fedilora"]
        traced = analysis_trace(name, step, args)
        real = _real_run(step, args)
        real_peak = traced["args_bytes"] + real["temp_bytes"]
        err = real_peak / traced["peak_bytes"] - 1
        rec = {"traced": traced, "real": real, "real_peak_bytes": real_peak,
               "peak_err": err,
               "analytic": (_analytic_one_card(cfg, shape,
                                               ANALYSIS_STEPS[name][4])
                            if shape is not None else None)}
        t_bound = max(traced["roofline"][k] for k in
                      ("compute_s", "memory_s", "collective_s"))
        rec["time_over_traced_bound"] = real["ms"] * 1e-3 / t_bound
        an = rec["analytic"]
        print(f"analysis {name}: FLOPs real {real['flops']:.6e} traced "
              f"{traced['flops']:.6e}; peak real {real_peak / 2**30:.3f} GiB "
              f"predicted {traced['peak_bytes'] / 2**30:.3f} GiB "
              f"({100 * err:+.2f} %); device {real['ms']:.2f} ms, traced "
              f"roofline compute {traced['roofline']['compute_s'] * 1e3:.2f}"
              f" / memory {traced['roofline']['memory_s'] * 1e3:.2f} ms"
              + (f", analytic compute {an['compute_s'] * 1e3:.2f} / memory "
                 f"{an['memory_s'] * 1e3:.2f} ms" if an else "")
              + f"; trace {traced['trace_s']:.1f} s", flush=True)
        if real["flops"] != traced["flops"]:
            raise AssertionError(f"analysis {name}: the real run's FLOPs "
                                 f"{real['flops']} differ from the trace's "
                                 f"{traced['flops']}")
        if abs(err) > ANALYSIS_PEAK_TOL:
            raise AssertionError(f"analysis {name}: real peak {real_peak} "
                                 f"is {100 * err:+.1f} % from the predicted "
                                 f"{traced['peak_bytes']}")
        if traced["peak_bytes"] <= 4e9:
            raise AssertionError(f"analysis {name}: predicted peak "
                                 f"{traced['peak_bytes']} is not above 4 GB")
        if name == "round":
            g0, c0, l0 = step(*args)
            DK.reset_launches()
            g1, c1, l1 = kernel_step(*args)
            torch.cuda.synchronize()
            launches = DK.launches["dim_agg"]
            err_k = 0.0
            for n in g0:
                for m in ("A", "B"):
                    d = (g1[n][m] - g0[n][m]).abs()
                    if not bool((d <= 1e-5 + 1e-4 * g0[n][m].abs()).all()):
                        raise AssertionError(
                            f"analysis round: fedilora_kernel's {n}.{m} "
                            f"differs from fedilora's by {d.max().item():.3e}"
                            ", beyond atol 1e-5 + rtol 1e-4")
                    err_k = max(err_k, d.max().item())
            if launches != 1:
                raise AssertionError(f"analysis round: {launches} dim_agg "
                                     "launches in one fedilora_kernel step")
            if float(l0) != float(l1):
                raise AssertionError("analysis round: the clients' losses "
                                     "differ between the two aggregators")
            rec["kernel"] = {"launches": launches, "max_abs_err": err_k}
            print(f"analysis round: fedilora_kernel held against fedilora, "
                  f"max err {err_k:.3e}, dim_agg launches {launches}",
                  flush=True)
        steps[name] = rec
        del step, args
    out["steps"] = steps
    out["launches"] = {"dim_agg": steps["round"]["kernel"]["launches"]}
    t0 = time.perf_counter()
    out["dryrun"] = _dryrun_records(procs, out_dir)
    out["dryrun_wait_s"] = time.perf_counter() - t0
    for n, rec in out["dryrun"].items():
        if "skipped" in rec:
            print(f"analysis dry run {n}: skipped", flush=True)
            continue
        rt = rec["roofline_traced"]
        print(f"analysis dry run {n}: trace {rec['trace_s']:.1f} s, traced "
              f"-> {rt['dominant']}, analytic -> "
              f"{rec.get('roofline', {}).get('dominant')}, peak "
              f"{rec['memory_analysis']['peak_bytes'] / 2**30:.2f} GiB, "
              f"fits {rec['memory_analysis']['fits']}", flush=True)
    n_dev = torch.cuda.device_count()
    out["devices"] = n_dev
    if n_dev >= 4:
        out["four"] = analysis_four()
    else:
        print(f"analysis: the four-card part did not run ({n_dev} "
              f"device{'s' if n_dev != 1 else ''}; it needs 4)", flush=True)
    return out


# ---------------------------------------------------------------------------
# placements: the production steps' placements (FSDP, replicated K/V heads,
# expert parallelism, sequence parallelism, sequence-split caches,
# scoreshard) held against the unmeshed steps
# ---------------------------------------------------------------------------

PLACEMENT_MODES = ("baseline", "ep", "sp", "ep_sp", "seq", "scoreshard")
# (arch, layers on one card, layers on four, steps, modes): each mode's
# (1, 1) run on NCCL, bf16 at published widths, against the unmeshed step
# bit for bit; the 2x2 runs in f32 (MoE cut to 4 experts)
PLACEMENT_RUNS = [
    ("qwen2-0.5b", None, 8, ("train", "prefill", "serve"), PLACEMENT_MODES),
    ("jamba-v0.1-52b", 8, 8, ("train", "prefill", "serve"),
     ("ep", "ep_sp")),
    ("deepseek-v2-236b", 2, 2, ("serve",), ("scoreshard", "seq_scoreshard"))]
# (batch, sequence, microbatches | decode steps) of each step
PLACEMENT_SIZES = {"train": (4, 512, 2), "prefill": (4, 1024, None),
                   "serve": (8, 512, 4)}
# the dry run's sweep on a fake 16x16 process group: (mode, arch, shape),
# the pairs each mode changes (started at the run's beginning, on the
# host's cores)
PLACEMENT_SWEEP = [
    ("baseline", "qwen2-72b", "decode_32k"),
    ("baseline", "minicpm-2b", "decode_32k"),
    ("baseline", "gemma3-12b", "long_500k"),
    ("baseline", "jamba-v0.1-52b", "long_500k"),
    ("seq", "qwen2-72b", "decode_32k"),
    ("seq", "minicpm-2b", "decode_32k"),
    ("ep", "llama4-scout-17b-a16e", "decode_32k"),
    ("ep", "deepseek-v2-236b", "decode_32k"),
    ("sp", "qwen2-0.5b", "train_4k"),
    ("ep_sp", "jamba-v0.1-52b", "train_4k"),
    ("scoreshard", "deepseek-v2-236b", "decode_32k")]
PLACEMENT_SWEEP_JOBS = 4
PLACEMENT_TIMEOUT_S = 600


def _placement_sweep(out_dir: str) -> None:
    """The ``PLACEMENT_SWEEP`` records through the dry run's own task
    runner, ``PLACEMENT_SWEEP_JOBS`` at a time (run in a subprocess)."""
    import multiprocessing as mp_

    from repro_torch.launch import dryrun as D
    tasks = [("step", arch, shape, False, D.DEFAULT_RANK, mode, 0, out_dir)
             for mode, arch, shape in PLACEMENT_SWEEP]
    with mp_.get_context("spawn").Pool(PLACEMENT_SWEEP_JOBS) as pool:
        for tag, rec in pool.imap(D._run_task, tasks):
            D._report(tag, rec)


def _placement_sweep_start():
    """Start :func:`_placement_sweep` in a subprocess; returns ``(proc,
    out_dir)``."""
    out_dir = os.path.join(ROOT, "build", "placements_dryrun")
    os.makedirs(out_dir, exist_ok=True)
    code = ("import sys; sys.path.insert(0, %r); sys.path.insert(0, %r);"
            " import chip_smoke; chip_smoke._placement_sweep(%r)"
            % (SRC, ROOT, out_dir))
    env = dict(os.environ, PYTHONPATH=SRC)
    return subprocess.Popen([sys.executable, "-c", code],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, env=env, cwd=ROOT), out_dir


def _placement_sweep_records(proc, out_dir: str) -> dict:
    out, _ = proc.communicate(timeout=PLACEMENT_TIMEOUT_S)
    if proc.returncode != 0:
        raise AssertionError(f"placement sweep exited {proc.returncode}:\n"
                             f"{out[-3000:]}")
    from repro_torch.launch.dryrun import _tag
    recs = {}
    for mode, arch, shape in PLACEMENT_SWEEP:
        tag = _tag(arch, shape, False, mode)
        with open(os.path.join(out_dir, tag + ".json")) as f:
            rec = json.load(f)
        if "error" in rec:
            raise AssertionError(f"placement sweep {tag}: {rec['error']}")
        recs[tag] = rec
    return recs


def _equal_trees(a, b, what: str) -> None:
    """Raise unless every tensor leaf of ``a`` equals ``b``'s bit for
    bit."""
    import torch
    if isinstance(a, dict):
        for k in a:
            _equal_trees(a[k], b[k], f"{what}.{k}")
    elif isinstance(a, (list, tuple)):
        for i, (x, y) in enumerate(zip(a, b)):
            _equal_trees(x, y, f"{what}[{i}]")
    elif isinstance(a, torch.Tensor):
        if not torch.equal(a, b):
            d = (a.float() - b.float()).abs().max().item()
            raise AssertionError(f"placements: {what} differs from the "
                                 f"unmeshed step by up to {d:.3e}")
    elif a != b:
        raise AssertionError(f"placements: {what} {a} != {b}")


def _placement_steps(cfg, params, lora, mesh, mode: str, steps) -> dict:
    """Each of ``steps`` under ``mode`` on ``mesh`` (or unmeshed, ``mesh``
    None): the adapter and metrics after one AdamW step, the prefill
    logits, the serve logits of every decode step and the final cache."""
    import torch

    from repro_torch.launch import dryrun as D
    from repro_torch.launch import steps as S
    from repro_torch.models import transformer as T
    from repro_torch.optim import OptimizerConfig, adamw_init
    parts = D.mode_parts(mode)
    out = {}
    for step in steps:
        tp, p = None, params
        if mesh is not None:
            tp = D.make_tp(cfg, mesh, step if step != "serve" else "decode",
                           mode)
            p = tp.shard_params(params)
        g = torch.Generator(device="cuda").manual_seed(7)
        B, seq, k = PLACEMENT_SIZES[step]
        if step == "train":
            batch = _rand_batch(cfg, (B,), seq, g, "cuda")
            batch["loss_mask"] = (torch.rand((B, seq), generator=g,
                                             device="cuda") < 0.7).float()
            fn = S.make_train_step(cfg, OptimizerConfig(peak_lr=1e-3),
                                   lora_scale=FAMILY_LORA_SCALE,
                                   num_microbatches=k, tp=tp, mesh=mesh)
            new, _, m = fn(p, lora, adamw_init(lora), batch)
            out["train"] = {"lora": new, "metrics": m}
        elif step == "prefill":
            batch = _rand_batch(cfg, (B,), seq, g, "cuda", labels=False)
            fn = S.make_prefill_step(cfg, lora_scale=FAMILY_LORA_SCALE,
                                     tp=tp, mesh=mesh)
            out["prefill"] = fn(p, lora, batch)
        else:
            cache_axis = ("model" if mesh is not None and parts["seq"]
                          else None)
            score_axis = ("model" if mesh is not None and parts["scoreshard"]
                          and cfg.mla is not None else None)
            toks = torch.randint(0, cfg.vocab_size, (B, k), generator=g,
                                 device="cuda")
            cache = T.init_cache(cfg, p, B, seq, tp=tp,
                                 cache_axis=cache_axis)
            fn = S.make_serve_step(cfg, lora_scale=FAMILY_LORA_SCALE, tp=tp,
                                   mesh=mesh, cache_axis=cache_axis,
                                   score_axis=score_axis)
            lo = lora if tp is None else tp.local_lora(lora)
            logits = []
            for t in range(k):
                lg, cache = fn(p, lo, cache, toks[:, t], seq - k + t)
                logits.append(lg)
            out["serve"] = {"logits": logits, "cache": cache}
        torch.cuda.synchronize()
    return out


def _placements_rank(rank: int, world: int, rdv: str, out_path: str,
                     parts: tuple) -> None:
    """One rank of the placements phase (spawned, NCCL).  World size 1:
    every ``PLACEMENT_RUNS`` mode on a (1, 1) ``("data", "model")`` mesh
    against the unmeshed steps bit for bit.  Four ranks: every mode of
    qwen2-0.5b (8 layers) and of Jamba-8 and DeepSeek-V2-2 cut to 4
    experts on a 2x2 mesh in f32, against the baseline placement on the
    same mesh within 1e-4 (logits, losses) and 2e-3 (adapters after one
    AdamW step).  Rank 0 writes the record to ``out_path``."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import Mesh, init_distributed
    from repro_torch.launch.roofline import collective_bytes
    from repro_torch.models.transformer import init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    init_distributed(init_method=f"file://{rdv}", world_size=world,
                     rank=rank)
    one = world == 1
    res = {"runs": {}}
    try:
        mesh = Mesh((1, 1) if one else (2, 2), ("data", "model"))
        for arch, layers, layers_four, steps, modes in PLACEMENT_RUNS:
            cfg = _family_cfg(arch, layers if one else layers_four)
            if not one:
                cfg = dataclasses.replace(cfg, dtype="float32")
                if cfg.moe is not None:
                    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                        cfg.moe, num_experts=4,
                        experts_per_token=min(cfg.moe.experts_per_token, 2)))
            params = init_params(cfg, seed=3)
            lora = _cuda_adapter(cfg, 5)
            t0 = time.perf_counter()
            want = _placement_steps(cfg, params, lora,
                                    None if one else mesh, "baseline", steps)
            walls = {"reference": time.perf_counter() - t0}
            colls = {}
            for mode in modes:
                mesh.reset_collectives()
                t0 = time.perf_counter()
                got = _placement_steps(cfg, params, lora, mesh, mode, steps)
                walls[mode] = time.perf_counter() - t0
                colls[mode] = collective_bytes(mesh)["counts"]
                if one:
                    _equal_trees(got, want, f"{arch} {mode}")
                else:
                    _close_trees(got, want, f"{arch} {mode}")
            res["runs"][arch] = {"layers": cfg.num_layers, "steps": steps,
                                 "modes": list(modes), "walls": walls,
                                 "collectives": colls}
            del params
            torch.cuda.empty_cache()
        if rank == 0:
            with open(out_path, "w") as f:
                json.dump(res, f, default=float)
    finally:
        dist.destroy_process_group()


def _close_trees(a, b, what: str) -> None:
    """``a`` against ``b`` leaf by leaf: adapters within 2e-3 (one AdamW
    step moves an element by at most its learning rate), everything else
    within 1e-4."""
    import torch
    if isinstance(a, dict):
        for k in a:
            _close_trees(a[k], b[k], f"{what}.{k}")
    elif isinstance(a, (list, tuple)):
        for i, (x, y) in enumerate(zip(a, b)):
            _close_trees(x, y, f"{what}[{i}]")
    elif isinstance(a, torch.Tensor):
        if a.shape != b.shape:
            return                       # caches of another placement
        tol = 2e-3 if ".lora." in what else 1e-4
        d = (a.float() - b.float()).abs().max().item()
        if d > tol:
            raise AssertionError(f"placements 2x2: {what} differs from the "
                                 f"baseline placement by {d:.3e}")


def phase_placements(dev_name: str, sweep) -> dict:
    """The placements of the production steps: with one card, every mode
    on a (1, 1) mesh over NCCL equal to the unmeshed step bit for bit
    (``PLACEMENT_RUNS``: qwen2-0.5b train / prefill / serve under every
    mode, Jamba-8 under ``ep`` and ``ep_sp``, DeepSeek-V2-2's decode under
    ``scoreshard`` and ``seq_scoreshard``); with four cards also every
    mode on a 2x2 mesh against the baseline placement; and the dry run's
    records of ``PLACEMENT_SWEEP`` on a fake 16x16 process group, started
    at the run's beginning (``sweep``)."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    n_dev = torch.cuda.device_count()
    out = {"devices": n_dev,
           "one": _spawn_mesh(1, (), target=_placements_rank,
                              timeout=PLACEMENT_TIMEOUT_S)}
    for arch, r in out["one"]["runs"].items():
        print(f"placements (1x1 on {dev_name}): {arch} ({r['layers']} "
              f"layers) {'/'.join(r['steps'])} under {r['modes']} equal to "
              f"the unmeshed steps bit for bit; walls "
              f"{ {k: round(v, 2) for k, v in r['walls'].items()} } s; "
              f"collectives {r['collectives']}", flush=True)
    if n_dev >= 4:
        out["four"] = _spawn_mesh(4, (), target=_placements_rank,
                                  timeout=PLACEMENT_TIMEOUT_S)
        for arch, r in out["four"]["runs"].items():
            print(f"placements (2x2): {arch} under {r['modes']} within "
                  f"the limits of the baseline placement; collectives "
                  f"{r['collectives']}", flush=True)
    else:
        print(f"placements: the four-card part did not run ({n_dev} "
              f"device{'s' if n_dev != 1 else ''}; it needs 4)", flush=True)
    t0 = time.perf_counter()
    out["dryrun"] = _placement_sweep_records(*sweep)
    out["dryrun_wait_s"] = time.perf_counter() - t0
    for tag, rec in out["dryrun"].items():
        if "skipped" in rec:
            print(f"placements dry run {tag}: skipped", flush=True)
            continue
        mem, rt = rec["memory_analysis"], rec["roofline_traced"]
        print(f"placements dry run {tag}: arguments "
              f"{mem['argument_size_bytes'] / 1e9:.2f} GB, peak "
              f"{mem['peak_bytes'] / 1e9:.2f} GB, fits {mem['fits']}, "
              f"collective bytes {rec['collectives']['per_op']}, traced "
              f"-> {rt['dominant']}, traced/analytic FLOPs "
              f"{rec['traced_to_analytic_flops']:.2f}, trace "
              f"{rec['trace_s']:.1f} s", flush=True)
    return out


EXAMPLE_ARGV = {"federated_finetune": ["--rounds", "2"]}
EVAL_KEYS = ("loss", "acc", "bleu", "rsum")


def _finite_eval(what: str, ev: dict) -> None:
    if set(ev) != set(EVAL_KEYS) or not all(math.isfinite(ev[k])
                                            for k in EVAL_KEYS):
        raise AssertionError(f"{what}: evaluation {ev}")


def _finite_rounds(what: str, recs: list, n: int) -> None:
    if len(recs) != n or not all(math.isfinite(r["train_loss"])
                                 for r in recs):
        raise AssertionError(f"{what}: {n} finite round losses expected, "
                             f"got {[r['train_loss'] for r in recs]}")


def _example_checks(name: str, rec: dict) -> dict:
    """Hold what an example's ``main`` returned: finite losses and
    metrics, and the shapes its reference counterpart prints.  Returns
    the figures the phase keeps."""
    if name == "heterogeneous_ranks":
        n = rec["norms"]
        if (rec["w"].shape != (4, 8)
                or abs(rec["col_sums"] - 1).max() > 1e-6
                or abs(n["fedilora"] - n["client"]) > 1e-5 * n["client"]
                or abs(4 * n["hetlora"] - n["client"]) > 1e-5 * n["client"]):
            raise AssertionError(f"heterogeneous_ranks: {rec}")
        return {"norms": n}
    if name == "quickstart":
        _finite_rounds(name, rec["rounds"], 8)
        _finite_eval("quickstart global", rec["global"])
        _finite_eval("quickstart personalized", rec["personalized"])
        return {"losses": [r["train_loss"] for r in rec["rounds"]],
                "global": rec["global"], "personalized": rec["personalized"]}
    if name == "async_rounds":
        tl, asy = rec["timeline"], rec["async"]
        blocking, piped = tl["blocking"], tl["pipelined"]
        _finite_rounds("async_rounds blocking", blocking, 7)
        _finite_rounds("async_rounds pipelined", piped[1:], 7)
        if piped[0] is not None or [r["sampled"] for r in piped[1:]] != [
                r["sampled"] for r in blocking]:
            raise AssertionError("async_rounds: the pipelined rounds' cohorts "
                                 "are not the blocking ones")
        if len(asy["ticks"]) != 12 or asy["versions"] < 1:
            raise AssertionError(f"async_rounds: {len(asy['ticks'])} ticks, "
                                 f"{asy['versions']} versions")
        _finite_eval("async_rounds personalized", asy["eval"])
        return {"rounds_per_s": tl["rounds_per_s"],
                "pipelined_loss_gap": max(
                    abs(a["train_loss"] - b["train_loss"])
                    for a, b in zip(piped[1:], blocking)),
                "versions": asy["versions"], "eval": asy["eval"]}
    if name == "federated_finetune":
        if list(rec) != ["fedilora", "hetlora"]:
            raise AssertionError(f"federated_finetune ran {list(rec)}")
        for method, r in rec.items():
            _finite_rounds(method, r["rounds"], 2)
            _finite_eval(f"{method} global", r["global"])
            _finite_eval(f"{method} personalized", r["personalized"])
        return {m: {"losses": [x["train_loss"] for x in r["rounds"]],
                    "global": r["global"], "personalized": r["personalized"],
                    "wall_s": r["wall_s"]} for m, r in rec.items()}
    if name == "serve_decode":
        for arch, r in rec.items():
            if r["gen"].shape != (4, 8) or max(r["errs"]) >= 2e-3:
                raise AssertionError(f"serve_decode {arch}: {r['gen'].shape}, "
                                     f"decode/prefill {max(r['errs'])}")
        return {arch: {"max_err": max(r["errs"]), "cache_mib": r["cache_mib"]}
                for arch, r in rec.items()}
    if name == "serve_multitenant":
        _finite_rounds(name, rec["train"], 2)
        eng, store, done = rec["continuous"]
        eng_s, _, done_s = rec["static"]
        for what, d in (("continuous", done), ("static", done_s),
                        ("sampled", rec["sampled"])):
            if len(d) != 12 or any(r["status"] != "ok" for r in d):
                raise AssertionError(f"serve_multitenant {what}: "
                                     f"{len(d)} requests finished")
        return {"steps": eng.steps, "static_steps": eng_s.steps,
                "dispatch": dict(eng.dispatch_count),
                "pages_in_out": [store.loads, store.evictions],
                "sampled_changed": rec["changed"]}
    raise KeyError(name)


def phase_examples() -> dict:
    """The port's six examples, each ``main`` run in this process on the
    card (``EXAMPLE_ARGV``: the one cut, ``federated_finetune``'s depth).
    Their paths keep the reference's plain routes: no kernel launches."""
    import contextlib
    import importlib
    import io

    import torch

    from repro_torch.examples import EXAMPLES
    from repro_torch.kernels import dim_agg as DK
    from repro_torch.kernels import grouped_lora_matmul as glm

    glm.reset_launches()
    DK.reset_launches()
    out = {}
    for name in EXAMPLES:
        mod = importlib.import_module(f"repro_torch.examples.{name}")
        printed = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            rec = mod.main(EXAMPLE_ARGV.get(name, []))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out[name] = {"wall_s": wall, "argv": EXAMPLE_ARGV.get(name, []),
                     "printed": printed.getvalue(),
                     **_example_checks(name, rec)}
        print(f"examples: {' '.join([name, *out[name]['argv']])} "
              f"{wall:.1f} s", flush=True)
    out["launches"] = {"grouped_lora_matmul": glm.launches, **DK.launches}
    if any(out["launches"].values()):
        raise AssertionError(f"the examples launched kernels "
                             f"{out['launches']} on their plain routes")
    ff = out["federated_finetune"]
    print("examples: federated_finetune --rounds 2 (fedbench-100m): "
          + "; ".join(f"{m} losses {[round(x, 4) for x in r['losses']]}, "
                      f"global BLEU {r['global']['bleu']:.2f} RSUM "
                      f"{r['global']['rsum']:.2f}, personalized BLEU "
                      f"{r['personalized']['bleu']:.2f} RSUM "
                      f"{r['personalized']['rsum']:.2f}, {r['wall_s']} s"
                      for m, r in ff.items() if isinstance(r, dict)
                      and "losses" in r), flush=True)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: no port package under {SRC}", file=sys.stderr)
        return 1
    sys.path.insert(0, SRC)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    dev_name = torch.cuda.get_device_name(0)
    print(f"device: {smi}", flush=True)

    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import build as kbuild
    sweep = _placement_sweep_start()     # host cores, beside the card
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:   # nvcc in parallel
        list(pool.map(kbuild.build, KERNEL_SOURCES))
    build_s = time.perf_counter() - t0
    print(f"build: {build_s:.2f} s "
          f"({', '.join(sorted(kbuild.BUILD_INFO))})", flush=True)

    phase_s = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        phase_s[name] = time.perf_counter() - t0
        return out

    sass = timed("sass", sass_counts)
    regs = timed("ptxas", dim_agg_registers)
    flash_regs = timed("ptxas_flash", flash_registers)
    probe = timed("probe", probe_mma_tf32)
    kern = timed("kernels", phase_kernels, dev_name)
    dagg = timed("dim_agg", phase_dim_agg, dev_name)
    opsr = timed("ops", phase_ops, dev_name)
    served = timed("serve", phase_serve)
    agree = timed("agreement", phase_agreement)
    slo = timed("slo", phase_slo)
    trained = timed("train", phase_train)
    train_agree = timed("train_agreement", phase_train_agreement)
    faulted = timed("faults", phase_faults)
    timelines = timed("timelines", phase_timelines)
    population = timed("population", phase_population)
    resident = population.pop("resident")
    flora = timed("flora", phase_flora, resident.base_params)
    ckpt = timed("checkpoint", phase_checkpoint, resident.base_params)
    eval_ref = timed("eval_ref", phase_eval_ref, resident)
    cli = timed("cli", phase_cli)
    families = timed("families", phase_families)
    vision = timed("vision", phase_vision, dev_name)
    meshed = timed("mesh", phase_mesh, dev_name)
    meshed_families = timed("mesh_families", phase_mesh_families, dev_name)
    analysis = timed("analysis", phase_analysis, dev_name)
    placements = timed("placements", phase_placements, dev_name, sweep)
    examples = timed("examples", phase_examples)
    print("phase wall s: " + ", ".join(f"{k} {v:.1f}"
                                       for k, v in phase_s.items()),
          flush=True)

    # the mesh phase's launches on its meshed runs (one card), per kernel;
    # each was held against its plain version as it ran
    one = meshed["one"]
    mesh_launches = {
        "grouped_lora_matmul": sum(
            v["launches"] for k, v in one["serve"].items()
            if k != "unmeshed"),
        **{key: sum(v["launches"][key] for k, v in one["rounds"][agg].items()
                    if k != "unmeshed_walls")
           for key, agg in (("dim_agg", "fedilora_kernel"),
                            ("dim_agg_trimmed", "fedilora_trimmed_kernel"))}}
    if not all(mesh_launches.values()) or any(
            one["held"][k]["held"] < 1 for k in mesh_launches):
        raise AssertionError(f"the mesh phase did not launch and hold every "
                             f"kernel of its path: {mesh_launches}, "
                             f"{one['held']}")
    # the same for the mesh_families phase's meshed runs (one card)
    fam = meshed_families["one"]
    fam_launches = {
        "grouped_lora_matmul": sum(
            v["launches"] for r in fam["serve"].values()
            for k, v in r.items() if isinstance(v, dict)
            and k != "unmeshed"),
        **{key: sum(v["launches"][key] for r in fam["rounds"].values()
                    for k, v in r[agg].items() if k != "unmeshed")
           for key, agg in (("dim_agg", "fedilora_kernel"),
                            ("dim_agg_trimmed", "fedilora_trimmed_kernel"))}}
    if not all(fam_launches.values()) or any(
            fam["held"][k]["held"] < 1 for k in fam_launches):
        raise AssertionError(f"the mesh_families phase did not launch and "
                             f"hold every kernel of its path: "
                             f"{fam_launches}, {fam['held']}")
    cases = kern["cases"]
    # headline: the decode step's shape and dtypes on the serve path
    head = next(c for c in cases if (c["M"], c["N"]) == (16, 896)
                and c["x_dtype"] == "bfloat16" and c["bank_dtype"] == "float32")
    record = {
        "name": "grouped_lora_matmul", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/grouped_lora_matmul.cu",
        "replaces": "src/repro/kernels/lora_gather_matmul.py:71",
        "launches": served["launches"],
        "path_launches": {"serve": served["launches"],
                          "slo": slo["launches"],
                          **{f"families.{k}": v["launches"]
                             for k, v in families.items()},
                          "mesh": mesh_launches["grouped_lora_matmul"],
                          "mesh_families": fam_launches[
                              "grouped_lora_matmul"]},
        "mesh": meshed["one"]["held"]["grouped_lora_matmul"],
        "mesh_families": fam["held"]["grouped_lora_matmul"],
        "max_abs_err": max(c["max_abs_err"]
                           for c in cases + kern["family_cases"]),
        "max_err_f32": max(c["max_abs_err"] for c in cases
                           if c["x_dtype"] == "float32"),
        "max_err_bf16": max(c["max_abs_err"] for c in cases
                            if c["x_dtype"] == "bfloat16"),
        "ms": head["ms"], "kernel_ms": head["ms"],
        "plain_ms": head["plain_ms"], "library_ms": head["library_ms"],
        "library_call": "torch.matmul(x, W): the base product only",
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "shape": {k: head[k] for k in ("M", "K", "N", "G", "r", "x_dtype",
                                       "bank_dtype")},
        "family_cases": [{k: c[k] for k in (
            "site", "M", "K", "N", "max_abs_err", "ms", "plain_ms",
            "library_ms", "bound_ms", "bound_by")}
            for c in kern["family_cases"]]}
    records = [record]
    # headline for both dim_agg kernels: the round's wq.A leaf, unscaled
    # (the fedilora_kernel path), with the round's whole tree in one launch
    # beside it; every case is in build/chip_smoke.json
    path_launches = {
        "dim_agg": {"train": trained["launches"]["dim_agg"],
                    "faults": faulted["launches"]["dim_agg"],
                    "timelines": timelines["launches"]["dim_agg"],
                    "population": population["launches"]["dim_agg"],
                    "checkpoint": ckpt["launches"]["dim_agg"],
                    "vision": vision["launches"]["dim_agg"],
                    "mesh": mesh_launches["dim_agg"],
                    "mesh_families": fam_launches["dim_agg"],
                    "analysis": analysis["launches"]["dim_agg"]},
        "dim_agg_trimmed": {
            "train_agreement": train_agree["fedilora_trimmed_kernel"][
                "launches"]["dim_agg_trimmed"],
            "faults": faulted["launches"]["dim_agg_trimmed"],
            "population": population["launches"]["dim_agg_trimmed"],
            "vision": vision["launches"]["dim_agg_trimmed"],
            "mesh": mesh_launches["dim_agg_trimmed"],
            "mesh_families": fam_launches["dim_agg_trimmed"]}}
    for kernel, paths in path_launches.items():
        if not all(paths.values()):
            raise AssertionError(f"{kernel} was not launched on every path "
                                 f"that runs it: {paths}")
    for name, line, launches, lib_call, tree_fn in [
            ("dim_agg", 115, trained["launches"]["dim_agg"],
             "torch.einsum('kd,kldn->ldn', w, x)", "fedilora_aggregate_tree"),
            ("dim_agg_trimmed", 88, train_agree["fedilora_trimmed_kernel"][
                "launches"]["dim_agg_trimmed"], None,
             "fedilora_trimmed_tree")]:
        mine = [c for c in dagg["cases"] if c["kernel"] == name]
        h = next(c for c in mine if c["shape"] == "wq.A"
                 and c["variant"] is None)
        tree = next(c for c in dagg["tree_cases"]
                    if c["tree_function"] == tree_fn)
        records.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/dim_agg.cu",
            "replaces": f"src/repro/kernels/dim_agg.py:{line}",
            "launches": launches, "path_launches": path_launches[name],
            "mesh": one["held"][name],
            "mesh_families": fam["held"][name],
            "max_abs_err": max(c["max_abs_err"] for c in mine),
            "ms": h["ms"], "plain_ms": h["plain_ms"],
            "library_ms": h["library_ms"],
            "library_call": lib_call or "none: no one PyTorch call computes "
                                        "a trimmed mean",
            "bound_ms": h["bound_ms"], "bound_by": h["bound_by"],
            "shape": {"dims": h["dims"], "rank_axis": h["rank_axis"],
                      "dtype": "float32"},
            "tree": {k: tree[k] for k in ("tree_function", "ms",
                                          "per_leaf_ms", "plain_ms",
                                          "bound_ms", "max_abs_err",
                                          "bit_equal")},
            "vision_tree": {k: vision["tree"][name][k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err",
                "bit_equal")} | {"bytes": vision["tree"]["tree_bytes"]}})
    # headlines for the ops kernels, one per route: qwen2-0.5b's wq LoRA
    # site and its prefill attention, bf16 on wgmma and f32 in 3xTF32 (the
    # errors over every ops case of the route)
    by_route = opsr["launches"]["flash_attention_by_route"]
    lora_by_route = opsr["launches"]["lora_matmul_by_route"]
    for name, kernel, source, line, route, dtype in [
            ("lora_matmul", "lora_matmul", "lora_matmul_wgmma", 54,
             "wgmma", "bfloat16"),
            ("lora_matmul_tf32x3", "lora_matmul", "lora_matmul", 54,
             "tf32x3", "float32"),
            ("flash_attention", "flash_attention", "flash_attention_wgmma",
             76, "wgmma", "bfloat16"),
            ("flash_attention_tf32x3", "flash_attention", "flash_attention",
             76, "tf32x3", "float32")]:
        launches = (lora_by_route if kernel == "lora_matmul"
                    else by_route)[route]
        mine = [c for c in opsr["cases"] if c["kernel"] == kernel
                and c["route"] == route]
        head_shape = ("qwen2-0.5b.wq" if kernel == "lora_matmul"
                      else "qwen2-0.5b.prefill")
        h = next(c for c in mine if c["shape"] == head_shape
                 and c["dtype"] == dtype)
        rec = {
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{source}.cu",
            "replaces": f"src/repro/kernels/{kernel}.py:{line}",
            "launches": launches,
            "max_abs_err": max(c["max_abs_err"] for c in mine),
            "ms": h["ms"], "plain_ms": h["plain_ms"],
            "library_ms": h["library_ms"], "library_call": h["library_call"],
            "bound_ms": h["bound_ms"], "bound_by": h["bound_by"],
            "shape": {"case": head_shape, "dtype": dtype}}
        records.append(rec)
    out_dir = os.path.join(ROOT, "build")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump({"device": smi, "torch": torch.__version__,
                   "cuda": torch.version.cuda, "build_s": build_s,
                   "phase_s": phase_s,
                   "build_logs": {k: v["log"]
                                  for k, v in kbuild.BUILD_INFO.items()},
                   "kernels": records,
                   "kernel_cases": cases,
                   "kernel_family_cases": kern["family_cases"],
                   "dim_agg_cases": dagg["cases"],
                   "dim_agg_tree_cases": dagg["tree_cases"],
                   "dim_agg_instances": dagg["instances"],
                   "dim_agg_ptxas": regs, "flash_ptxas": flash_regs,
                   "kernel_widths": kern["widths"], "sass": sass,
                   "probe": probe,
                   "ops": opsr,
                   "serve": served, "agreement": agree, "slo": slo,
                   "train": trained, "train_agreement": train_agree,
                   "faults": faulted, "timelines": timelines,
                   "population": population, "flora": flora,
                   "checkpoint": ckpt, "eval_ref": eval_ref, "cli": cli,
                   "families": families, "vision": vision,
                   "mesh": meshed, "mesh_families": meshed_families,
                   "analysis": analysis, "placements": placements,
                   "examples": examples},
                  f, indent=1, default=float)
    print(json.dumps({"kernels": records}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev_name,
        "count": torch.cuda.device_count()}}))
    return 0


def placements_four() -> int:
    """``python3 chip_smoke.py --placements-four``: the placements phase's
    four-card part alone (every mode on a 2x2 NCCL mesh against the
    baseline placement), on a machine with four cards."""
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        print("chip_smoke: the four-card part needs 4 CUDA devices",
              file=sys.stderr)
        return 1
    sys.path.insert(0, SRC)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print("device: " + smi.replace("\n", " | "), flush=True)
    t0 = time.perf_counter()
    four = _spawn_mesh(4, (), target=_placements_rank,
                       timeout=PLACEMENT_TIMEOUT_S)
    wall = time.perf_counter() - t0
    for arch, r in four["runs"].items():
        print(f"placements (2x2): {arch} ({r['layers']} layers) under "
              f"{r['modes']} within the limits of the baseline placement; "
              f"walls { {k: round(v, 2) for k, v in r['walls'].items()} } "
              f"s; collectives {r['collectives']}", flush=True)
    print(f"four-card part wall {wall:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(placements_four() if sys.argv[1:] == ["--placements-four"]
             else main())
