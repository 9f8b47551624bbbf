#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py
    python3 chip_smoke.py --phase dkpca    # build, fit and ring fit alone
    python3 chip_smoke.py --phase lm_families     # build, the families
    python3 chip_smoke.py --phase lm_train_dist   # build, four-card meshes
    python3 chip_smoke.py --phase dryrun          # build, the dry-run
    python3 chip_smoke.py --phase lm_decode_dist  # build, four-card decode
    python3 chip_smoke.py --phase lm_decode_dist --runs falcon-mamba-7b

Needs one NVIDIA card and nvcc. Phases, each printing one JSON line:

  device   card name, count, and nvidia-smi's name + power limit;
  build    nvcc build of every kernel source (src/repro_torch/kernels/csrc),
           and the count of wgmma (HGMMA) instructions per kernel function
           (gram's two routes' and project's must hold some);
  kernels  each hand-written kernel against its plain PyTorch version on the
           card at the main path's shapes (the fit's, the probe's at the
           widths 3072, 4096, 2048 and 1024, and the probe ring's per rank
           and on one card): max abs error, kernel
           / plain / library times per call (CUDA events over back-to-back
           calls, host launch cost included; for gram and center, every
           launch of the op), the kernels' own device time (a profiler trace),
           and the least time the card could take (bytes over 3.35 TB/s, or
           operations over 67 TFLOP/s fp32, or for gram and project 3 x TF32
           products over 495 TFLOP/s, a self-Gram counting n(n+1)/2 pairs);
           gram and project are also held to fp32 grade (within 2x the plain
           version's error against float64); bf16 input to gram (the setup's
           batch) and to project (the served slabs) must give the bits of
           the widened fp32 input; each gram row records its split count
           (gram.py:split_count: 1, or the CTAs of the short-row route's
           cluster), and the probe ring's Grams at batch 1 must be bitwise
           element 0 of the same Grams at batch 4;
  fit      the paper's Fig. 3/5 configuration: J=20 nodes x N=100 samples x
           M=784, ring(20, hops=2), global centering, 30 ADMM iterations,
           central kPCA on the pooled 2000 x 784; similarity at 1/10/30;
  serve    from_decentralized -> save/load -> compress(500), then the batched
           engine answers 3/17/64/128/200-row requests on both models; each
           request is held against the plain projection on the card;
  baselines  the paper's Fig. 4 and Fig. 5 baselines on the same data:
           local_kpca (one kPCA per node) and neighborhood_kpca (one per
           500-sample neighbourhood), mean similarity to central kPCA beside
           the ADMM's at iteration 30; the paper's ordering ADMM@30 >
           neighbourhood > local is checked;
  topk     run_admm_topk(k=2, n_iters=30) at the same size: the first
           component's similarity, the 2-D subspace's alignment inside the
           central top-3, the second component's similarity to central
           component 1 (tests/test_deflation.py's limits); then the C = 2
           model and its 500-landmark compression served through the engine,
           each request held against the plain projection;
  breakdown  setup, ADMM, central kPCA, baselines and top-k once more, warm:
           wall time, then device time, device calls, idle share and top
           kernels from a torch.profiler trace;
  serve_stream  sustained serving on both models: 4096 requests of 1-256
           rows (log-uniform) in drains of 32, timed and then traced over
           the whole stream: queries/s, drain latency p50/p99, device time
           (all of it, and the project kernels'), idle share; every score
           held against the plain projection;
  serve_async  the same stream through the started engine (background
           flusher, device-runner thread, pinned staging, admission
           "reject" at 8 slabs of rows) from 4 client threads: queries/s,
           latency percentiles, device time and idle share beside
           serve_stream's; scores against the plain projection and bitwise
           against the synchronous engine; the stream as bf16 slabs
           (bitwise the fp32 engine on the rounded queries, half the
           host-to-card bytes); a mid-stream publish; request deadlines;
  serve_sharded  the consensus model in 4 shards, and compressed to 125
           landmarks a shard, through the engine: routing "auto" ("single"
           on one card), then "mp" and "dp" over [card, card]; every
           request within 3e-4 of the unsharded plain projection; the
           placement cache's hits and no support split in steady drains;
  faults   the fault-tolerant fit at the fit's size, 40 iterations in chunks
           of 10, with a communication ledger, under two dropouts at t=15
           (nodes 3 and 7), link loss (0-2, t 5-12), a link delay (10-12, t
           8-12) and a straggler (node 16, t 10-14): t, the re-knit, the
           survivors, the events, the survivors' similarity to their pooled
           central kPCA (mean >= 0.99, min >= 0.95) and the ledger's bytes
           and messages (the JAX package's numbers for this plan), then the
           fit's breakdown; then fault-injected serving: the consensus
           model in 4 shards through the started engine under a shard loss
           at the first dispatch (1024 requests from 4 client threads:
           every future resolves within 30 s, a failure only as a typed
           FaultError, one re-balance publish, the survivors' scores within
           3e-4 of the plain projection of the gathered survivor model),
           two transient faults healed by retries, and a publisher whose
           first job crashes while the engine serves the stale version;
  dkpca    the ring fit (``dkpca_distributed`` over ``RingComm``) at the
           fit's configuration on a NCCL group of world 1 in this process:
           from the dense fit's alpha0, alpha@30 within the reference's SPMD
           gate (5e-3 max|alpha| + 1e-4) of the dense fit, similarity@30 >=
           0.99 (also from init="local"), the ledger equal to the JAX
           package's per-node profile (4,800 B / 12 messages / 1 collective
           an iteration, 7,528,000 B / 28 / 1 in setup), at least 21 gram
           launches (20 sweep cross-Grams and the slot Grams) and exactly 30
           admm_step launches; a bf16-message run recorded (finite, 2,400 B
           an iteration); first-run and warm times, device time and idle
           share; then, on a host with 2 or more cards, the same fit over
           min(4, cards) spawned NCCL ranks held to the one-card ring;
  serve_kpca  ``python -m repro_torch.launch.serve_kpca`` at the serving
           width (2000 x 784 model, 4 submitters x 256 requests of 1-256
           rows, 2 injected faults) in a subprocess: rc 0, the served line,
           no faulted future, retries >= 2, its trace (with the engine's
           spans) and metrics files; its q/s, latencies and launches;
  autotune the tile autotuner (``repro_torch.kernels.autotune``): with no
           table the dispatch is the derived one; the CLI's search at the
           paper's shapes into build/autotune/tile_table.json (each
           candidate held to the default's output, then timed on the card:
           device time of one call, best of 5); under the table each op
           against its plain version at 2e-4, a query alone bitwise its
           row of a B128 slab, and a second search with --assert-cached
           runs no trial; each op's default and chosen knob with both
           device times;
  lm_serve the LM serving half: llama3.2-3b at full width and depth,
           mixtral-8x22b and deepseek-v2-236b at full width cut to 2
           layers, bf16 weights drawn on the card from a seeded generator:
           decode against prefill logits at 2e-2 (tests/test_arch_smoke.py's
           gate), DecodeEngine (4 slots, 8 prompts, 16 greedy new tokens)
           tokens/s and peak memory, one decode step traced (wall, device
           time, idle share, beside the time to read every weight once),
           the MoE capacity dispatch against the dense expert loop; the smoke-size llama and mixtral on the card
           against the CPU: the same greedy tokens, logits within 2e-2;
  lm_train the LM training half: llama3.2-3b at full width and depth
           (28 x 3072, vocab 128256), bf16 params and fp32 moments, remat
           "full", 6 AdamW steps (lr 3e-4, cosine_with_warmup(1, 6)) of
           TokenStream(batch 4, seq 128) through train(): every loss
           finite, the first within 2.5 of ln V, no step skipped; the loss
           trajectory, first and warm step time, tokens/s and peak
           allocation; one warm step traced; a step with layers sliced by a
           select per layer against one unbind per stack (time and peak);
           then the DKPCA activation probe on the trained params (96 x 16
           tokens: J=3 nodes of N=32, M=3072, 8 iterations): not skipped,
           finite, gram and admm_step launched; its outputs equal to the
           card run of the same build_setup + run_admm, whose alpha the CPU
           run from the card's alpha0 gives within 2e-4 max|alpha|; at
           smoke size, the fp32 llama3.2-3b-smoke for 8 steps on the card
           and the CPU from the same weights (losses within 1e-4 relative,
           params within 1e-4 max|p|), one bf16 step of the mixtral and
           deepseek smoke configs (loss and grad norm within 2e-2), 8
           straight steps against 4 + checkpoint + resume + 4 (bitwise),
           save_checkpoint_async (its snapshot, found by latest_step), and
           remat "none", "full" and "dots" giving the same grads (bitwise);
  lm_train_mesh  lm_train's run again through train() over a (1, 1) device
           mesh on a NCCL group of world 1: the losses and every leaf's
           checksums (float64 sum, sum of bit patterns) bitwise lm_train's,
           no collective issued, peak and step times beside lm_train's;
           the probe over the mesh is skipped (J = 1 data rank < 3);
  lm_families  the ssm, hybrid and audio families at full width and depth,
           bf16 weights drawn on the card from seed 0: falcon-mamba-7b
           (64 x 4096, d_inner 8192), zamba2-1.2b (38 x 2048) and
           seamless-m4t-large-v2 (24 + 24 x 1024, vocab 256206): the init's
           peak; decode against prefill (the chunked scan; for seamless the
           encoder and the prompt in one step, against a cache whose
           enc_out is set as encdec_prefill sets it) at 2e-2 on the
           weights widened to fp32, and in bf16 for seamless; for
           falcon-mamba and zamba2 in bf16 the decode's relative L2
           distance from the fp32 prefill within 1.25 x the bf16
           prefill's own (+ 1e-3); falcon's
           forward loss at 4 x 128 tokens (within 2.5 of ln V; its training
           state does not fit one card); DecodeEngine (4 slots, 8 prompts,
           16 greedy new tokens; seamless: 512 frames, an 8-token prompt
           and 16 greedy steps) tokens/s and peak; one decode step traced
           beside the time to read its weights once; zamba2 and seamless
           trained through train() as lm_train (6 steps of 4 x 128 tokens,
           seamless with 512 frames), then the probe on the trained params
           (exactly 2 gram and 8 admm_step launches, counted from zero
           before each train(); the CPU's alpha from the card's alpha0
           within 2e-4 max|alpha|); the three smoke configs card against
           CPU (fp32 training 8 steps: losses at 1e-4, params at 1e-4
           max|p|, the leaves drawn as zeros at 1e-4 max(1, max|p|); bf16
           greedy tokens equal, logits within 2e-2);
  lm_train_dist  on a host with 4 cards (else it records that it did not
           run, and why): one-card references, then 4 spawned NCCL ranks:
           llama3.2-3b at full width, 3 steps of lm_train's batches on
           (4, 1), (2, 2) and (1, 4) meshes (step 1's loss within 1e-5 /
           5e-3 / 5e-3 relative of one card, its grad norm within 1e-2,
           every loss finite and the same on every rank, per-card peak at
           (4, 1) under 20 GB); mixtral-8x22b and deepseek-v2-236b at full
           width cut to 2 layers on (1, 4) and (2, 2) (step 1's loss within
           5e-3 of the one-card forward); falcon-mamba-7b at full depth
           on (4, 1) and (1, 4), its layers split over "model" there
           (step 1's loss within 1e-5 / 5e-3 of a one-card forward of the
           same weights, per-card peak under 40 GB) and zamba2-1.2b on
           (2, 2) and (1, 4), its mamba2 layers split over "model" (step
           1's loss within 5e-3 of one card; and its weights widened to
           fp32, step 1's loss and grad norm within 1e-4 of one card's
           fp32 run; for seeds 0, 1 and 2 each, step 1's bf16 gradient
           gathered whole on rank 0 within dm <= 1.25 d1 + 1e-3 |g32| of
           one card's fp32 gradient g32, per leaf and whole, d1 one
           card's bf16 distance; its grad norm's gap recorded), each with
           rank 0's collectives a step by kind and bytes; the probe's
           ring branch on (4, 1) (5 gram and 8 admm_step launches on every
           rank, counted from zero just before it; alpha bitwise the
           world-1 ring of the same x_nodes); the
           fp32 smoke model's params after 3 steps within 3e-5 max|p| of
           one card on each mesh; a (2, 2) checkpoint restored at (4, 1) and on one card
           (bitwise); the launcher under torchrun on 2 x 2 (rc 0, one
           last line, on rank 0);
  lm_decode_dist  on a host with 4 cards (else it records that it did not
           run, and why): prefill and 32 greedy decode steps over 4
           spawned NCCL ranks, fed the one-card run's tokens: llama3.2-3b
           uncut (a 4 x 4096 prompt into a 32768-slot cache) on (4, 1),
           (2, 2) and (1, 4); mixtral-8x22b and deepseek-v2-236b at full
           width cut to 2 layers (4 x 16, drop-free) on (2, 2);
           falcon-mamba-7b uncut on (1, 4); zamba2-1.2b and
           seamless-m4t-large-v2 (4,096 frames) uncut on (2, 2); each in
           fp32 (the bf16 weights widened) within the larger of 1e-4 x
           max(1, |ref|) and 1.25 x the distance of the one-card split
           twin (the products the mesh splits done in its blocks on one
           card, mamba1's and mamba2's included) from the plain one-card
           run; in bf16 its relative L2
           distance from the fp32 card within 1.25 x the one-card bf16
           run's + 1e-3 (the 2e-2 reading recorded); and mixtral at 4 x
           512, past the drop-free bound, its dropped slots and distance
           from one card recorded (capacity semantics: no parity gate);
           every rank's argument bytes and one decode step's collectives
           equal to the dry-run's (its fake backend, in a CPU-only child
           before the timed runs); tokens/s, a traced step, peak per
           card; ``--runs`` keeps the runs of the configs it names;
  dryrun   the XLA-free dry-run's CLI over every cell (after every timed
           phase, CPU only, a pool of workers: 68 ok, 14 SKIP, none
           failed) and the roofline over its output (34 single-pod rows);
           the (1, 1) argument bytes of lm_train's run equal to the live
           training state (params, m, v, step, a batch); llama3.2-3b's
           prefill and 8 greedy steps over a (1, 1) mesh on a NCCL group
           of world 1 bitwise the no-mesh run (logits, tokens, cache), no
           collective issued.

Each path (fit and serve; baselines; top-k; serve_async; serve_sharded;
faults; dkpca; serve_kpca, counted in the launcher's own process, which
starts at zero; autotune; lm_serve, which must launch none of the four
kernels; lm_train, whose probe must launch gram and admm_step; lm_train_mesh, whose
skipped probe launches none; lm_families, each trained family's train()
and probe; lm_train_dist's and lm_decode_dist's ranks count their own;
lm_decode_dist, its references and dryrun must launch none of the four)
is
driven
with every kernel's launch count zeroed just before it and read just
after; a kernel the path must run and never
launched fails the run (the kernels, breakdown and serve_stream phases
count nowhere, nor do the references a path's checks compute after its
count is read).
Gram's launches with a bf16 operand are also counted, and project's by
kind: bf16 slabs, raw partials, support splits. The summary's
``launches`` is the fit and serve path's. Device times per call come from
profiler traces whose recorded launches are checked against the calls
made. The last lines are the kernels summary object, the nvidia-smi line,
and
``{"ok": true, "device": {...}}``. A failed check is reported and the run
goes on, so one run shows every phase; it then exits non-zero before the
summary. An exception (a failed build, a launch error) ends the run at
once, as does a missing CUDA device or a missing repository beside the
script. It imports nothing of JAX or of the JAX package.
"""

import contextlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PEAK_FP32_FLOPS = 67e12        # H100 SXM, fp32 outside the tensor cores
PEAK_TF32_FLOPS = 495e12       # H100 SXM, dense TF32 on the tensor cores
PEAK_BYTES = 3.35e12           # H100 SXM HBM3
TOL = 2e-4                     # kernel vs plain and engine vs plain
SPLIT_KERNEL = "tf32_split_kernel"   # the 3xTF32 split gram, project share
TOLERANCE = ("|kernel - plain| <= 2e-4 * max(1, |plain|): absolute for the "
             "kernel values and scores (all below 1 here), relative for the "
             "raw kernel row-sums of project_partial_op (several hundred "
             "here)")
SIM30_MIN = 0.99
STREAM_REQUESTS = 4096         # sustained serving: requests per stream
STREAM_PER_DRAIN = 32          # requests submitted between two flushes
STREAM_POOL = 8192             # query rows the stream's requests are cut from
ASYNC_THREADS = 4              # serve_async's client threads
ASYNC_QUEUE_FACTOR = 8         # its admission bound: 8 full slabs of rows
ASYNC_RETRY_S = 1e-3           # a refused client's sleep before it retries
SHARDED_REQUESTS = 1024        # serve_sharded's requests per run
SHARDED_TOL = 3e-4             # the reference's sharded tolerance
FAULT_WAIT_S = 30.0            # faults: every future resolved within this
# the JAX package's ledger for the faults phase's plan on this fit (CPU):
# per iteration after the re-knit, and totals over the 40 iterations
FAULT_LEDGER = dict(per_iter=(76800, 192), setup=(0, 0),
                    totals=(3072000, 7680), iterations=40)
# the JAX package's per-node ledger for the ring fit (J=20, N=100, M=784,
# hops=2, global centring): (bytes, messages, collectives) an iteration and
# in setup, 4*100*784*4 + 20*100*784*4 + 4*100*4 bytes
DKPCA_LEDGER = dict(per_iter=(4800, 12, 1), setup=(7528000, 28, 1))
DKPCA_BF16_BYTES = 2400        # bf16 messages: half the fp32 iteration
DKPCA_MAX_RANKS = 4            # the multi-card ring: at most 4 cards
DKPCA_RANK_TIMEOUT_S = 300
SERVE_KPCA_ARGS = ("--n-train", "2000", "--m", "784", "--max-batch", "128",
                   "--submitters", "4", "--requests", "256", "--max-q",
                   "256", "--inject-faults", "2")
SERVE_KPCA_TIMEOUT_S = 300
AUTOTUNE_K = 5                 # autotune: timing repeats per candidate
AUTOTUNE_OUT = "build/autotune/tile_table.json"
LM_TOL = 2e-2                  # the reference's decode tolerance (bf16)
# lm_serve: (config, layers kept: None for all), at full width
LM_FULL = (("llama3.2-3b", None), ("mixtral-8x22b", 2),
           ("deepseek-v2-236b", 2))
LM_SMOKE = ("llama3.2-3b", "mixtral-8x22b")
LM_PROMPTS, LM_SLOTS, LM_MAX_LEN, LM_NEW = 8, 4, 64, 16
# lm_train: llama3.2-3b at full width and depth, 6 AdamW steps of 4 x 128
# tokens; the probe's batch (J=3 nodes of N=32 pooled activations, M=3072)
TRAIN_ARCH, TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = "llama3.2-3b", 6, 4, 128
TRAIN_FIRST_LOSS_SLACK = 2.5   # tests/test_arch_smoke.py: |loss - ln V|
PROBE_BATCH, PROBE_SEQ, PROBE_ITERS, PROBE_NODE = 96, 16, 8, 32
PROBE_TOL = 2e-4               # card vs CPU alpha from one alpha0, x max|a|
TRAIN_SMOKE_STEPS = 8
TRAIN_SMOKE_TOL = 1e-4         # fp32 smoke, card vs CPU: losses (relative),
                               # final params (x max|p| of each tensor)
TRAIN_MOE = ("mixtral-8x22b", "deepseek-v2-236b")   # bf16, one step, 2e-2
# lm_families: the ssm, hybrid and audio families at full width and depth;
# zamba2 and seamless also trained (falcon's training state, 84.06 GB, does
# not fit one card); seamless prefills 512 frames and an 8-token prompt
FAM_FULL = ("falcon-mamba-7b", "zamba2-1.2b", "seamless-m4t-large-v2")
FAM_TRAIN = ("zamba2-1.2b", "seamless-m4t-large-v2")
FAM_FRAMES, FAM_PROMPT = 512, 8
FAM_BF16_RATIO = 1.25          # falcon, zamba2 at full depth: bf16 decode's
                               # distance from the fp32 prefill, over bf16
                               # prefill's (tests/test_torch_families.py's)
# the probe's feature widths on these families' tables
FAM_PROBE_WIDTHS = (4096, 2048, 1024)
# lm_train_dist (four cards): the meshes, llama3.2-3b's steps on each, the
# gates on step 1's loss (relative to one card: the (4, 1) step only
# reorders the mean, the others split contractions) and on the grad norm
DIST_RANKS = 4
DIST_MESHES = ((4, 1), (2, 2), (1, 4))
DIST_STEPS = 3
DIST_LOSS_TOL = {(4, 1): 1e-5, (2, 2): 5e-3, (1, 4): 5e-3}
DIST_GNORM_TOL = 1e-2          # step 1's grad norm, relative
DIST_PEAK_GB_MAX = 20.0        # per card at (4, 1): half of lm_train's peak
# the fp32 smoke's params, x max|p| of each tensor: Adam amplifies the
# rounding of gradients that cancel to about its eps
# (scripts/dist_smoke_gap.py)
DIST_SMOKE_TOL = 3e-5
# the MoE configs at full width cut to 2 layers, on (1, 4) and (2, 2); a
# batch small enough that every shard's dispatch is drop-free
DIST_MOE = (("mixtral-8x22b", 2), ("deepseek-v2-236b", 2))
DIST_MOE_MESHES = ((1, 4), (2, 2))
DIST_MOE_BATCH, DIST_MOE_SEQ, DIST_MOE_TOL = 2, 16, 5e-3
# falcon-mamba-7b at full depth on (4, 1) and (1, 4) (its layers split
# over "model" there): step 1's loss against a one-card forward of the
# same weights (at (1, 4) the split contractions' gate); its per-card peak
# under 40 GB (21.0 GB of params, grads and moments a card at (4, 1), a
# gathered layer and activations); zamba2-1.2b on (2, 2) and (1, 4), its
# mamba2 layers split over "model", against one card (llama's loss gate;
# its step-1 grad-norm gap recorded, not gated); each run's collectives a
# step
DIST_FALCON, DIST_FALCON_PEAK_GB = "falcon-mamba-7b", 40.0
DIST_FALCON_TOL = {(4, 1): 1e-5, (1, 4): 5e-3}
DIST_ZAMBA, DIST_ZAMBA_MESHES = "zamba2-1.2b", ((2, 2), (1, 4))
# and zamba2-1.2b's weights widened to fp32, one card and the same meshes:
# step 1's loss and grad norm within this, relative (the split layers'
# sums reordered in fp32)
DIST_ZAMBA_FP32_TOL = 1e-4
# the rule zamba2's bf16 step-1 gradient over each mesh is held to, for
# each seed's weights and batch (tests/test_torch_bf16_mesh_rule.py holds
# it to the JAX package's own sharded step): per leaf and for the whole
# gradient, its distance dm from one card's fp32 gradient g32 within
# 1.25 x one card's bf16 distance d1 + 1e-3 |g32| (one card's bf16
# gradient of a deep recurrent stack is mostly rounding, so its norm, a
# balance of shrunk signal and that noise, moves by percents when the
# rounding moves at all: PERF.md §6)
DIST_RULE_FACTOR, DIST_RULE_FLOOR = 1.25, 1e-3
DIST_RULE_SEEDS = (0, 1, 2)
DIST_RANK_TIMEOUT_S = 900
DIST_LAUNCH_ARGS = ("--arch", TRAIN_ARCH, "--mesh", "2x2", "--steps", "3",
                    "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ))
DIST_LAUNCH_TIMEOUT_S = 600
# dryrun: the XLA-free dry-run's CLI over every cell (CPU only, its own
# pool of workers), run after every timed phase, and its roofline
DRYRUN_OUT = "build/dryrun/dryrun.json"
DRYRUN_ARGS = ("--arch", "all", "--shape", "all", "--multipod", "both",
               "--dkpca", "--out", DRYRUN_OUT)
DRYRUN_CELLS = (68, 14)            # (ok, SKIP), the dkpca cells included
DRYRUN_TIMEOUT_S = 600
MESH11_BATCH, MESH11_PROMPT, MESH11_MAX_LEN, MESH11_STEPS = 4, 64, 128, 8
# lm_decode_dist: prefill and greedy decode over four cards, each run held
# to the same weights on one card fed the one-card run's tokens: (arch,
# layers or None for all, mesh, batch, prompt, max_len); the MoE prompts
# small enough that every rank's dispatch is drop-free (tokens x top_k <=
# 8 x experts); seamless's frames number its enc_seq (4096)
DECODE_RUNS = (
    ("llama3.2-3b", None, (4, 1), 4, 4096, 32768),
    ("llama3.2-3b", None, (2, 2), 4, 4096, 32768),
    ("llama3.2-3b", None, (1, 4), 4, 4096, 32768),
    ("deepseek-v2-236b", 2, (2, 2), 4, 16, 4096),
    ("mixtral-8x22b", 2, (2, 2), 4, 16, 4096),
    ("falcon-mamba-7b", None, (1, 4), 4, 1024, 2048),
    ("zamba2-1.2b", None, (2, 2), 4, 1024, 4096),
    ("seamless-m4t-large-v2", None, (2, 2), 4, 64, 1024),
)
# and one MoE run past the drop-free bound (each rank routes 1024 tokens):
# the mesh's capacity dispatch drops slots that the one-card dense loop
# keeps, so the two differ by design; its drops and its distance from one
# card are recorded, with no parity gate
DECODE_DROP_RUN = ("mixtral-8x22b", 2, (2, 2), 4, 512, 4096)
DECODE_STEPS = 32
DECODE_SEED = 0
# every run but the drop run is also run in fp32 (the bf16 weights
# widened), on one card and over the mesh, and once more on one card with
# the products the mesh splits over "model" done in its blocks (the split
# twin, ``split_products``): the fp32 mesh within the larger of
# DECODE_FP32_TOL * max(1, |ref|) and FAM_BF16_RATIO x the twin's
# distance from the plain card run (the recurrent stacks amplify the
# rounding of a reordered sum); the bf16 mesh by the families' rule (its
# relative L2 distance from the fp32 card within FAM_BF16_RATIO x the
# bf16 card's + 1e-3); the bf16 2e-2 reading is recorded: two bf16
# reductions of the same weights part past it at depth, and for the
# 2-layer MoE pair (PERF.md §6)
DECODE_FP32_TOL = 1e-4             # the JAX loop's parity tolerance
# the products of token rows with a weight that a mesh splits over
# "model" (the training layout), by equation: the weight's label on
# "model"; its columns where the output keeps the label, else a
# contraction whose ranks' partial products are summed
SPLIT_LABEL = {"ble,ei->bli": "i", "blr,ri->bli": "i", "bli,ir->blr": "i",
               "bli,ie->ble": "i", "bse,ehd->bshd": "h",
               "bsr,rhd->bshd": "h", "bsc,chd->bshd": "h",
               "bshd,chd->bshc": "h", "bshc,chd->bshd": "h",
               "bshd,hde->bse": "h", "bse,ef->bsf": "f",
               "bsf,fe->bse": "f", "bse,ev->bsv": "v"}
DECODE_RANK_TIMEOUT_S = 900


class SmokeFailure(RuntimeError):
    pass


FAILURES = []


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, msg: str) -> None:
    """Record a failed check and go on, so one run shows every phase; the
    run fails before the summary if any check failed."""
    if not cond:
        FAILURES.append(msg)
        print(f"chip_smoke: check failed: {msg}", file=sys.stderr, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise SmokeFailure(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def event_ms(torch, fn, iters: int, warmup: int = 3) -> float:
    """Mean milliseconds per call over ``iters`` back-to-back calls, timed
    with CUDA events after ``warmup`` calls."""
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


def _trace(torch, fn, iters: int) -> dict:
    """{device kernel or copy: (recorded calls, device microseconds)} of a
    ``torch.profiler`` trace of ``iters`` calls of ``fn``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return {e.key: (e.count, e.device_time_total)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.device_time_total > 0}


def device_kernels(torch, fn, iters: int = 10, label: str = "") -> dict:
    """Milliseconds per call that the card spent in each device kernel or
    copy (no host launch overhead). One traced call gives each kernel's
    launches per call; a trace of ``iters`` calls must then hold ``iters``
    times as many, else the profiler dropped events: the trace is taken
    once more on a short count, and a kernel still short fails the check.
    A kernel's time per call is its recorded time over its recorded
    launches, times its launches per call: nothing is divided by launches
    the trace did not hold."""
    fn()
    per_call = {key: n for key, (n, _) in _trace(torch, fn, 1).items()}
    out = {}
    for attempt, count in enumerate((iters, max(2, iters // 5))):
        traced = _trace(torch, fn, count)
        short = sorted(key for key, n in per_call.items()
                       if traced.get(key, (0, 0))[0] < n * count)
        out = {key: us / n * per_call.get(key, n / count) / 1e3
               for key, (n, us) in traced.items() if n}
        if not short:
            break
        print(f"chip_smoke: {label}: the trace of {count} calls is short "
              f"of launches for {short}", file=sys.stderr, flush=True)
        if attempt == 1:
            check(False, f"{label}: the profiler dropped launches of "
                         f"{short} in two traces")
    return out


def device_ms(torch, fn, kernels, iters: int = 10, label: str = ""):
    """Mean milliseconds per call that the card spent in the named kernels;
    None where the trace holds no device time."""
    total = sum(ms for key, ms in device_kernels(torch, fn, iters,
                                                 label).items()
                if any(k in key for k in kernels))
    return total or None


def errors(got, want) -> dict:
    """Max absolute error, and the error scaled by max(1, |plain|) that the
    tolerance is stated on."""
    import torch
    diff = (got - want).abs()
    return dict(max_abs_err=float(diff.max()), max_scaled_err=float(
        (diff / torch.clamp(want.abs(), min=1.0)).max()))


def bound(flops: float, nbytes: float, peak: float = PEAK_FP32_FLOPS):
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def hgmma_by_function(sass: str) -> dict:
    """wgmma (HGMMA) instructions per kernel function of ``cuobjdump -sass``
    output, by demangled name where c++filt is at hand."""
    counts, func = {}, None
    for ln in sass.splitlines():
        if "Function : " in ln:
            func = ln.split("Function : ", 1)[1].strip()
            counts[func] = 0
        elif func is not None and "HGMMA" in ln:
            counts[func] += 1
    try:
        names = subprocess.run(["c++filt"], input="\n".join(counts),
                               capture_output=True, text=True,
                               timeout=60).stdout.splitlines()
    except OSError:
        names = []
    if len(names) != len(counts):
        names = list(counts)
    return dict(zip(names, counts.values()))


def gram_record(spec, x, g, label, y=None):
    """What ``gram_op`` launches on the card (split passes and the
    tensor-core kernel) for a (Z, n, m) batch x against y (Z, k, m), or
    against x itself (y=None: symmetric tiles, K must equal K^T exactly).
    A bf16 x takes the split pass's bf16 instance, which must give the
    bits of the widened fp32 batch."""
    import torch
    from repro_torch.kernels import gram_reference, gram_tiles
    from repro_torch.kernels.gram.gram import split_count

    def run():
        return gram_tiles(spec, x, y, g)

    got = run()
    want = gram_reference(spec, x, y, gamma=g)
    torch.cuda.synchronize()
    cross = y is not None
    yy = y if cross else x
    (z, n, m), k = x.shape, yy.shape[1]
    if not cross:
        check(torch.equal(got, got.mT), f"gram {label}: self-Gram not "
                                        f"exactly symmetric")
    extra = {}
    if x.dtype == torch.bfloat16:
        widened = gram_tiles(spec, x.float(), y, g)
        torch.cuda.synchronize()
        extra["bitwise_vs_widened_fp32"] = bool(torch.equal(got, widened))
        check(extra["bitwise_vs_widened_fp32"],
              f"gram {label}: not the bits of its widened input")
    pairs = z * n * k if cross else z * n * (n + 1) // 2
    nbytes = x.element_size() * z * n * m + 4 * (
        cross * z * k * m + z * n * k + 1)
    b_ms, b_by = bound(flops=3 * 2 * pairs * m, nbytes=nbytes,
                       peak=PEAK_TF32_FLOPS)
    kern = device_kernels(torch, run, label=f"gram {label}")
    # fp32 grade: the kernel within 2x the plain fp32 version's error, both
    # against a float64 Gram of the same inputs
    exact = gram_reference(spec, x.double(), None if y is None
                           else y.double(), gamma=g.double())
    fp64_err = float((got.double() - exact).abs().max())
    fp64_err_plain = float((want.double() - exact).abs().max())
    check(fp64_err <= 2.0 * fp64_err_plain,
          f"gram {label}: error against float64 {fp64_err:.3g} > 2 x the "
          f"plain version's {fp64_err_plain:.3g}")
    if not cross:     # the diagonal is K(x, x) from the row's own norm
        eye = torch.eye(n, dtype=torch.bool, device=x.device)
        for side, k_ in (("", got), ("_plain", want)):
            d = (k_.double() - exact).abs()
            extra[f"fp64_err{side}_diag"] = float(d[:, eye].max())
            extra[f"fp64_err{side}_offdiag"] = float(
                d[:, ~eye].max()) if n > 1 else 0.0
    return dict(
        shape=label, splits=split_count(n, k, m), **errors(got, want),
        **extra, fp64_err=fp64_err, fp64_err_plain=fp64_err_plain,
        ms=event_ms(torch, run, 20),
        device_ms=sum(v for key, v in kern.items()
                      if "gram_" in key or SPLIT_KERNEL in key),
        device_kernels={key[:80]: v for key, v in kern.items()},
        plain_ms=event_ms(torch, lambda: gram_reference(spec, x, y, gamma=g),
                          20),
        library_ms=event_ms(torch, lambda: torch.exp(
            torch.cdist(x.float(), yy.float()).square_().mul_(-g)), 20),
        matmul_ms=event_ms(torch, lambda: torch.matmul(
            x.float(), yy.float().transpose(1, 2)), 20),
        bound_ms=b_ms, bound_by=b_by,
        bound_fp32_ms=bound(flops=z * n * k * (2 * m + 4), nbytes=nbytes)[0])


def project_record(spec, model, xq):
    """The projection kernel serving ``model`` to the (B, M) batch xq (fp32,
    or bf16: the split pass's bf16 instance, which must give the bits of
    the widened fp32 batch), with the model's own coefficients and
    centering terms."""
    import torch
    from repro_torch.core import oos
    from repro_torch.kernels import project_reference
    (b, m), (l, c) = xq.shape, model.coefs.shape
    project = oos.projector(model)
    bf16 = xq.dtype == torch.bfloat16

    def run():
        return project(xq)

    def plain():
        return project_reference(spec, xq, model.x_support, model.coefs,
                                 model.row_mean_coef, model.bias, model.gamma)

    got, want = run(), plain()
    torch.cuda.synchronize()
    # fp32 grade: the kernel within 2x the plain fp32 version's error, both
    # against a float64 projection of the same inputs
    exact = project_reference(spec, *(None if t is None else t.double()
                                      for t in (xq, model.x_support,
                                                model.coefs,
                                                model.row_mean_coef,
                                                model.bias, model.gamma)))
    fp64_err = float((got.double() - exact).abs().max())
    fp64_err_plain = float((want.double() - exact).abs().max())
    check(fp64_err <= 2.0 * fp64_err_plain,
          f"project B{b}xL{l}: error against float64 {fp64_err:.3g} > 2 x "
          f"the plain version's {fp64_err_plain:.3g}")
    extra = {}
    if bf16:
        widened = project(xq.float())
        torch.cuda.synchronize()
        extra["bitwise_vs_widened_fp32"] = bool(torch.equal(got, widened))
        check(extra["bitwise_vs_widened_fp32"],
              f"project B{b}xL{l} bf16: not the bits of its widened queries")
    kern = device_kernels(torch, run, label=f"project B{b}xL{l}")
    nbytes = (2 if bf16 else 4) * b * m + 4 * (
        l * m + l * (c + 1) + l + b * c + 2 * c)
    # the route taken: 3 TF32 products per fp32 one on the tensor cores
    b_ms, b_by = bound(flops=3 * 2 * b * l * m, nbytes=nbytes,
                       peak=PEAK_TF32_FLOPS)
    return dict(
        shape=f"B{b}xL{l}xM{m}xC{c}" + ("xbf16" if bf16 else ""),
        **errors(got, want), **extra,
        fp64_err=fp64_err, fp64_err_plain=fp64_err_plain,
        ms=event_ms(torch, run, 200),
        device_ms=sum(v for key, v in kern.items()
                      if "project_" in key or SPLIT_KERNEL in key),
        device_kernels={key[:80]: v for key, v in kern.items()},
        plain_ms=event_ms(torch, plain, 200),
        library_ms=None,
        matmul_ms=event_ms(torch, lambda: torch.matmul(
            xq.float(), model.x_support.T), 200),
        bound_ms=b_ms, bound_by=b_by,
        bound_fp32_ms=bound(flops=b * l * (2 * m + 4) + 2 * b * l * (c + 1),
                            nbytes=nbytes)[0])


def center_record(k, label):
    """The centering op on k (..., n, m) at its own strides, means
    included, timed as the kernel (all of its launches); the device kernels
    of one op's trace are listed, and must all be centering kernels."""
    import torch
    from repro_torch.kernels import center_op, center_reference

    def run():
        return center_op(k)

    got = run()
    want = center_reference(k)
    torch.cuda.synchronize()
    *lead, n, m = k.shape
    z = math.prod(lead)
    b_ms, b_by = bound(flops=3 * z * n * m,
                       nbytes=4 * (2 * z * n * m))
    kern = device_kernels(torch, run, label=f"center {label}")
    check(all("center_" in key for key in kern),
          f"center {label}: the op launched other kernels: {sorted(kern)}")
    ms = event_ms(torch, run, 20)
    return dict(
        shape=label, contiguous=k.is_contiguous(), **errors(got, want),
        ms=ms, op_ms=ms, device_ms=sum(kern.values()),
        device_kernels={key[:80]: v for key, v in kern.items()},
        plain_ms=event_ms(torch, lambda: center_reference(k), 20),
        library_ms=None, bound_ms=b_ms, bound_by=b_by)


def admm_record(setup, label, nodes=None):
    """The fused local update on the operands the solver hands it at
    iteration 6 of the fit (the eigenvectors, node Grams and inverse
    denominators of the setup, the live duals and z projections of five
    iterations, the schedule's rho); ``nodes``: only the first so many
    nodes' operands (a rank's share of a ring)."""
    import torch
    from repro_torch.core import dense_parts, init_state, initial_alpha
    from repro_torch.core.rho import RhoSchedule
    from repro_torch.core.solver import (admm_step, inverse_denominators,
                                         slot_rho)
    from repro_torch.kernels import (admm_local_update,
                                     admm_local_update_reference)
    ops, comm = dense_parts(setup)
    state = init_state(initial_alpha(setup), setup.n_slots)
    for t in range(5):
        state, _ = admm_step(ops, comm, state,
                             slot_rho(ops.mask, 100.0, RhoSchedule().at(t)))
    rho = slot_rho(ops.mask, 100.0, RhoSchedule().at(5))
    inv = inverse_denominators(ops.lam, torch.sum(rho, dim=1))
    ins = (ops.vec, inv[..., None].contiguous(), ops.k,
           state.b * ops.mask[:, None, :], state.g,
           rho[:, None, :].contiguous())
    if nodes is not None:
        ins = tuple(t[:nodes].contiguous() for t in ins)
    (j, n, _), s = ins[2].shape, ins[5].shape[2]

    def run():
        return admm_local_update(*ins)

    got, want = run(), admm_local_update_reference(*ins)
    torch.cuda.synchronize()
    errs = [errors(a, w) for a, w in zip(got, want)]
    b_ms, b_by = bound(flops=j * (6 * n * n + n + 5 * n * s),
                       nbytes=4 * (2 * j * n * n + 3 * j * n + 3 * j * n * s
                                   + j * s))
    return dict(
        shape=label, max_abs_err=max(e["max_abs_err"] for e in errs),
        max_scaled_err=max(e["max_scaled_err"] for e in errs),
        ms=event_ms(torch, run, 100),
        device_ms=device_ms(torch, run, ("admm_step_kernel",),
                            label=f"admm_step {label}"),
        plain_ms=event_ms(torch, lambda: admm_local_update_reference(*ins),
                          100),
        library_ms=None, bound_ms=b_ms, bound_by=b_by)


def eigh_record(k, label):
    """The Jacobi eigensolve on node Grams k (B, n, n) against its plain
    version on the same tensor: the eigenvalues and V diag(lam) V^T (the
    vectors themselves are a basis of their own within the tail's clustered
    eigenvalues), with V^T V and the sweeps each took; timed as the kernel,
    the plain version and ``torch.linalg.eigh`` (cuSOLVER's batched Jacobi,
    what the fit called before). Bound: 9 n^3 operations a matrix (a
    Householder eigendecomposition with vectors, about one Jacobi sweep) at
    the fp32 peak, against A read and lam, V written once."""
    import torch
    from repro_torch.kernels import sym_eigh, sym_eigh_reference

    def run():
        return sym_eigh(k)

    def plain():
        return sym_eigh_reference(k)

    def outer(lam, vec):
        return vec @ torch.diag_embed(lam) @ vec.transpose(1, 2)

    lam, vec, sweeps = run()
    plam, pvec, psweeps = plain()
    torch.cuda.synchronize()
    errs = [errors(lam, plam), errors(outer(lam, vec), outer(plam, pvec))]
    b, n, _ = k.shape
    b_ms, b_by = bound(flops=9 * b * n ** 3, nbytes=4 * b * (2 * n * n + n))
    return dict(
        shape=label, max_abs_err=max(e["max_abs_err"] for e in errs),
        max_scaled_err=max(e["max_scaled_err"] for e in errs),
        reconstruction_err=float((outer(lam, vec) - k).abs().max()),
        orthogonality_err=float((vec.transpose(1, 2) @ vec - torch.eye(
            n, device=k.device)).abs().max()),
        sweeps=sorted(set(sweeps.tolist())),
        plain_sweeps=sorted(set(psweeps.tolist())),
        ms=event_ms(torch, run, 20),
        device_ms=device_ms(torch, run, ("jacobi_eigh_kernel",),
                            label=f"eigh {label}"),
        plain_ms=event_ms(torch, plain, 1, warmup=0),
        library_ms=event_ms(torch, lambda: torch.linalg.eigh(k), 5),
        bound_ms=b_ms, bound_by=b_by)


def phase_kernels(dev, spec, nodes, pooled, gamma):
    """Each kernel against its plain version at the main path's shapes."""
    import torch
    from repro_torch.core import build_setup, oos, ring
    from repro_torch.core.kernels_math import gram, resolve_gamma
    from repro_torch.data import kpca_dataset, node_dataset
    from repro_torch.kernels import (gram_tiles, project_partial_op,
                                     project_partial_reference)
    g = torch.as_tensor(gamma, dtype=torch.float32, device=dev).reshape(())
    ids, _, _ = ring(20, 2).neighbor_array()
    src = torch.as_tensor([[j, *ids[j]] for j in range(20)], device=dev)
    # the setup phase's batch: every node's 5 slots of 100 samples stacked
    slots = torch.as_tensor(nodes, device=dev)[src].reshape(20, 500, 784)
    pooled_t = torch.as_tensor(pooled, device=dev)
    # cross Grams: one node's block against the pooled set (similarity),
    # and 500 landmarks against it (compress)
    marks = pooled_t[torch.as_tensor(oos.landmark_schedule(2000)[:500],
                                     device=dev)]
    x_t = torch.as_tensor(nodes, device=dev)
    records = {"gram": [
        gram_record(spec, slots.contiguous(), g, "20x500x500x784"),
        gram_record(spec, pooled_t[None].contiguous(), g, "2000x2000x784"),
        gram_record(spec, pooled_t[None, :100].contiguous(), g,
                    "100x2000x784", y=pooled_t[None].contiguous()),
        gram_record(spec, marks[None].contiguous(), g, "500x2000x784",
                    y=pooled_t[None].contiguous()),
        # the ring fit's centring sweep: every node's block against its
        # neighbour's, one cross-Gram launch for the 20 nodes
        gram_record(spec, x_t, g, "20x100x100x784 sweep",
                    y=torch.roll(x_t, -1, dims=0).contiguous())]}
    # bf16 input: the split pass's bf16 instance, on the setup's batch
    records["gram_bf16"] = [gram_record(spec, slots.bfloat16().contiguous(),
                                        g, "20x500x500x784xbf16")]
    # lm_train's probe at llama3.2-3b's width: 3 nodes of 32 pooled
    # activations (M = 3072; seeded rows at the embeddings' scale), the
    # global mean statistics' pooled Gram and the nodes' slot Grams
    acts = torch.randn((PROBE_BATCH, 3072), device=dev, generator=torch
                       .Generator(device=dev).manual_seed(2)) * 0.005
    g_probe = resolve_gamma(spec, acts)
    probe_nodes = acts.reshape(3, PROBE_NODE, 3072)
    records["gram"] += [
        gram_record(spec, acts[None].contiguous(), g_probe,
                    "96x96x3072 probe"),
        gram_record(spec, probe_nodes[torch.as_tensor(
            [[0, 2, 1], [1, 0, 2], [2, 1, 0]], device=dev)]
            .reshape(3, 3 * PROBE_NODE, 3072).contiguous(), g_probe,
            "3x96x96x3072 probe")]
    # lm_families' probe at the families' widths (falcon-mamba-7b 4096,
    # zamba2-1.2b 2048, seamless-m4t-large-v2 1024): the same two launches
    for width in FAM_PROBE_WIDTHS:
        wacts = torch.randn((PROBE_BATCH, width), device=dev,
                            generator=torch.Generator(device=dev)
                            .manual_seed(3)) * 0.005
        g_w = resolve_gamma(spec, wacts)
        records["gram"] += [
            gram_record(spec, wacts[None].contiguous(), g_w,
                        f"96x96x{width} probe"),
            gram_record(spec, wacts.reshape(3, PROBE_NODE, width)[
                torch.as_tensor([[0, 2, 1], [1, 0, 2], [2, 1, 0]],
                                device=dev)].reshape(3, 3 * PROBE_NODE, width)
                .contiguous(), g_w, f"3x96x96x{width} probe")]
    # the probe's ring branch (lm_train_dist): J = 4 nodes of n = 24 rows,
    # hops 1; a rank's sweep cross-Gram and slot Grams (L = 1 node), and
    # the world-1 ring's on one card (L = 4)
    rn = min(PROBE_NODE, PROBE_BATCH // DIST_RANKS)
    ring_nodes = acts[: DIST_RANKS * rn].reshape(DIST_RANKS, rn, 3072)
    rids, _, _ = ring(DIST_RANKS, 1).neighbor_array()
    ring_slots = ring_nodes[torch.as_tensor(
        [[j, *rids[j]] for j in range(DIST_RANKS)], device=dev)].reshape(
        DIST_RANKS, 3 * rn, 3072)
    ring_next = torch.roll(ring_nodes, -1, dims=0)
    for nl in (1, DIST_RANKS):
        records["gram"] += [
            gram_record(spec, ring_nodes[:nl].contiguous(), g_probe,
                        f"{nl}x{rn}x{rn}x3072 probe ring sweep",
                        y=ring_next[:nl].contiguous()),
            gram_record(spec, ring_slots[:nl].contiguous(), g_probe,
                        f"{nl}x{3 * rn}x{3 * rn}x3072 probe ring slots")]
    # a rank's Grams (batch 1) are bitwise element 0 of the world-1 ring's
    # (batch 4): the four-card probe's alpha rests on it
    ring_bits = {}
    for name, xs, ys in (("sweep", ring_nodes, ring_next),
                         ("slots", ring_slots, None)):
        xs = xs.contiguous()
        ys = None if ys is None else ys.contiguous()
        four = gram_tiles(spec, xs, ys, g_probe)
        one = gram_tiles(spec, xs[:1], None if ys is None else ys[:1],
                         g_probe)
        torch.cuda.synchronize()
        ring_bits[name] = bool(torch.equal(four[:1], one))
        check(ring_bits[name], f"gram probe ring {name}: the batch of 1 is "
                               f"not element 0 of the batch of "
                               f"{DIST_RANKS} bit for bit")

    # project: the served models' real coefficients and centering terms (a
    # central fit on the pooled data, and its 500-landmark compression)
    full = oos.fit_central(pooled_t, spec, gamma=g, device=dev)
    small, _ = oos.compress(full, 500, seed=0)
    queries = torch.as_tensor(kpca_dataset(128, m=784, seed=7), device=dev)
    records["project"] = [project_record(spec, model, queries[:b])
                          for model in (small, full) for b in (8, 128)]
    # the served bf16 slabs: the split pass's bf16 instance
    records["project_bf16"] = [project_record(spec, model,
                                              queries.bfloat16())
                               for model in (small, full)]
    # project_partial_op: raw partials with an indicator column (rows past
    # 1500 play a shard's padding)
    ext = torch.cat([full.coefs, torch.ones((2000, 1), device=dev)], dim=1)
    ext[1500:, -1] = 0.0
    got = project_partial_op(spec, queries, full.x_support, ext,
                             gamma=full.gamma)
    want = project_partial_reference(spec, queries, full.x_support, ext,
                                     gamma=full.gamma)
    torch.cuda.synchronize()
    records["partial"] = [dict(shape="B128xL2000xM784xC1",
                               **errors(got, want))]

    # centering on real Grams: central kPCA's (and the similarity metric's)
    # pooled 2000 x 2000, the setup's 20 x 500 x 500 slot Grams as one
    # contiguous batch and as the strided (J, S, S, N, N) block view that
    # center="block" centres, local_kpca's 20 x 100 x 100 batch and one
    # neighbourhood's 500 x 500
    k_slots = gram(spec, slots.contiguous(), gamma=g)
    records["center"] = [
        center_record(gram(spec, pooled_t, gamma=g), "2000x2000"),
        center_record(k_slots, "20x500x500"),
        center_record(k_slots.reshape(20, 5, 100, 5, 100)
                      .permute(0, 1, 3, 2, 4), "20x5x5x100x100 strided"),
        center_record(gram(spec, torch.as_tensor(nodes, device=dev),
                           gamma=g), "20x100x100"),
        center_record(k_slots[0], "500x500")]
    # the fused update on the fit's own setup
    setup = build_setup(nodes, ring(20, hops=2), spec, center="global",
                        gamma=g, device=dev)
    ring_setup = build_setup(ring_nodes, ring(DIST_RANKS, hops=1), spec,
                             device=dev)
    records["admm_step"] = [admm_record(setup, "J20xN100xS5"),
                            admm_record(build_setup(
                                probe_nodes, ring(3, hops=1), spec,
                                device=dev), "J3xN32xS3 probe"),
                            admm_record(ring_setup,
                                        f"J{DIST_RANKS}xN{rn}xS3 probe ring"),
                            admm_record(ring_setup, f"J1xN{rn}xS3 probe ring",
                                        nodes=1)]
    # the eigensolve on the node Grams of a J = 80 fit (fit-j80's size) and
    # of the J = 20 fit above
    nodes80, _ = node_dataset(80, 100, m=784, seed=1)
    records["eigh"] = [
        eigh_record(build_setup(nodes80, ring(80, hops=2), spec,
                                center="global", device=dev).k,
                    "80x100x100 (J80 fit)"),
        eigh_record(setup.k, "20x100x100 (J20 fit)")]
    emit("kernels", tolerance=TOLERANCE, records=records,
         gram_ring_bits=ring_bits)
    for name, recs in records.items():
        worst = max(r["max_scaled_err"] for r in recs)
        check(worst <= TOL, f"{name} kernel disagrees with its plain version:"
                            f" max |err| / max(1, |plain|) {worst:.3g} > {TOL}")
    return records


def mean_similarity(alphas, x_nodes, pooled, alpha_gt, spec, gamma):
    """Mean and least similarity to central kPCA over the nodes (alphas[j]
    a direction on the data x_nodes[j])."""
    from repro_torch.core import similarity
    sims = [float(similarity(alphas[j], x_nodes[j], alpha_gt, pooled, spec,
                             gamma=gamma))
            for j in range(len(x_nodes))]
    return sum(sims) / len(sims), min(sims)


def launch_counters() -> dict:
    """Each kernel's launch count (its wrapper's attribute), and project's
    by kind: its bf16 query slabs (the split pass's bf16 instance), its raw
    partials (the sharded path's partial projector), and the support split
    of ``prepare_support`` (once per model and shard); ``eigh_library``:
    the eigensolves on the card that took ``torch.linalg.eigh`` by shape."""
    from repro_torch.kernels import (admm_local_update, center_tiles,
                                     eigh_op, gram_tiles, prepare_support,
                                     project_tiles, sym_eigh)
    return {"gram": (gram_tiles, "launches"),
            "gram_bf16": (gram_tiles, "bf16_launches"),
            "project": (project_tiles, "launches"),
            "center": (center_tiles, "launches"),
            "admm_step": (admm_local_update, "launches"),
            "project_bf16": (project_tiles, "bf16_launches"),
            "project_partial": (project_tiles, "partial_launches"),
            "project_support": (prepare_support, "launches"),
            "eigh": (sym_eigh, "launches"),
            "eigh_library": (eigh_op, "library_calls")}


def zero_launches() -> None:
    import torch
    torch.cuda.synchronize()
    for wrapper, attr in launch_counters().values():
        setattr(wrapper, attr, 0)


def read_launches(path: str, needed) -> dict:
    """Every kernel's launches since ``zero_launches``; a kernel in
    ``needed`` that never launched on this path fails the run."""
    counts = {name: getattr(w, attr)
              for name, (w, attr) in launch_counters().items()}
    missing = [name for name in needed if counts[name] == 0]
    check(not missing, f"{path}: kernel(s) {missing} never launched: "
                       f"{counts}")
    return counts


def serve_requests(dev, models, requests, label) -> dict:
    """Every request through the batched engine on each model, each held
    against the plain projection on the card."""
    import torch
    from repro_torch.kernels import project_reference
    from repro_torch.serve import KpcaEngine, KpcaServeConfig
    out = {}
    for name, mdl in models:
        engine = KpcaEngine(mdl, KpcaServeConfig(max_batch=128,
                                                 min_bucket=8), device=dev)
        t0 = time.perf_counter()
        outs = engine.project_many(requests)
        wall = time.perf_counter() - t0
        errs = []
        for req, got in zip(requests, outs):
            want = project_reference(
                mdl.spec, torch.as_tensor(req, device=dev), mdl.x_support,
                mdl.coefs, mdl.row_mean_coef, mdl.bias, mdl.gamma)
            check(got.shape == (req.shape[0], mdl.n_components),
                  f"{label} ({name}): bad shape {got.shape}")
            errs.append(float(abs(got - want.cpu().numpy()).max()))
        rows = sum(r.shape[0] for r in requests)
        out[name] = dict(support=mdl.n_support,
                         components=mdl.n_components, max_abs_err=max(errs),
                         queries=rows, wall_s=wall,
                         queries_per_s_wall=rows / wall,
                         padded_rows=engine.stats.n_padded)
        check(max(errs) <= TOL, f"{label} engine ({name}) disagrees with the"
                                f" plain projection: {max(errs):.3g} > {TOL}")
    return out


def phase_baselines(dev, spec, setup, alpha_gt, admm30) -> dict:
    """Fig. 4 and Fig. 5 baselines on the fit's data and bandwidth, beside
    the ADMM's similarity at iteration 30."""
    import torch
    from repro_torch.core import local_kpca, neighborhood_kpca, ring
    x_nodes = setup.x
    pooled = x_nodes.reshape(-1, x_nodes.shape[-1])
    zero_launches()
    t0 = time.perf_counter()
    loc = local_kpca(x_nodes, spec, gamma=setup.gamma, device=dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    nb = neighborhood_kpca(x_nodes, ring(20, hops=2), spec,
                           gamma=setup.gamma, device=dev)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    local = mean_similarity(loc[..., 0], x_nodes, pooled, alpha_gt, spec,
                            setup.gamma)
    nei = mean_similarity([a[:, 0] for a, _ in nb], [xc for _, xc in nb],
                          pooled, alpha_gt, spec, setup.gamma)
    counts = read_launches("baselines", ("gram", "center"))
    emit("baselines", similarity_mean=dict(
        admm_30=admm30[0], neighborhood=nei[0], local=local[0]),
         similarity_min=dict(admm_30=admm30[1], neighborhood=nei[1],
                             local=local[1]),
         local_s=t1 - t0, neighborhood_s=t2 - t1, launches=counts)
    check(admm30[0] > nei[0] > local[0],
          f"baseline ordering ADMM@30 > neighbourhood > local fails: "
          f"{admm30[0]:.5f}, {nei[0]:.5f}, {local[0]:.5f}")
    return counts


def phase_topk(dev, spec, setup, nodes, requests) -> dict:
    """Top-2 by deflation at the fit's size, held to tests/test_deflation.py's
    limits, then packaged as a C = 2 model and served."""
    import torch
    from repro_torch.core import (central_kpca, oos, run_admm_topk,
                                  subspace_alignment)
    x_nodes = setup.x
    pooled = x_nodes.reshape(-1, x_nodes.shape[-1])
    zero_launches()
    t0 = time.perf_counter()
    alphas = run_admm_topk(setup, k=2, n_iters=30)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    gt, lam3, _ = central_kpca(pooled, spec, 3, gamma=setup.gamma,
                               device=dev)
    first = mean_similarity(alphas[0], x_nodes, pooled, gt[:, 0], spec,
                            setup.gamma)
    second = mean_similarity(alphas[1], x_nodes, pooled, gt[:, 0], spec,
                             setup.gamma)
    align = [float(subspace_alignment(
        torch.stack([alphas[0][j], alphas[1][j]], dim=1), x_nodes[j],
        gt[:, :3], pooled, spec, gamma=setup.gamma))
        for j in range(x_nodes.shape[0])]
    model = oos.from_decentralized(nodes, alphas, spec, gamma=setup.gamma,
                                   device=dev)
    compressed, rel_err = oos.compress(model, 500, seed=0)
    served = serve_requests(dev, (("full", model),
                                  ("compressed", compressed)), requests,
                            "topk")
    counts = read_launches("topk", ("gram", "project", "center",
                                    "admm_step", "eigh"))
    check(counts["eigh"] == 1 and counts["eigh_library"] == 0,
          f"topk: eigh launches {counts['eigh']} (1, the one deflation), "
          f"library eigensolves {counts['eigh_library']} (0)")
    emit("topk", k=2, iterations=30, topk_s=t1 - t0,
         first_similarity_mean=first[0], first_similarity_min=first[1],
         alignment_mean=sum(align) / len(align), alignment_min=min(align),
         second_vs_first_mean=second[0],
         central_lambda=[float(v) for v in lam3],
         compress_rel_err=[float(v) for v in rel_err], models=served,
         launches=counts)
    check(first[0] >= SIM30_MIN, f"top-k first component similarity "
                                 f"{first[0]:.4f} < {SIM30_MIN}")
    check(sum(align) / len(align) > 0.85,
          f"top-k alignment {sum(align) / len(align):.4f} <= 0.85")
    check(second[0] < 0.5, f"top-k second component similarity to central "
                           f"component 1 {second[0]:.4f} >= 0.5")
    return counts


def timed_and_traced(torch, fn, calls_by_kernel: bool = False,
                     kernels_of: tuple = (), warm: bool = True):
    """One warm run of ``fn`` (unless ``warm`` is off: the caller warmed
    it), one on the host clock, then one under
    ``torch.profiler``. Returns (the timed run's result, its wall seconds,
    and the traced run's device time, its count of device calls — kernel
    launches and copies —, the card's idle share of the untraced wall time,
    and the five kernels that took the most device time; with
    ``calls_by_kernel``, every device kernel's and copy's call count; with
    ``kernels_of``, the device seconds of the kernels whose name holds one
    of its strings, under the first one's name)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if warm:
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = sorted(((e.device_time_total, e.key, e.count)
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA
                      and e.device_time_total > 0), reverse=True)
    busy = sum(k[0] for k in kernels) / 1e6
    trace = dict(
        device_s=busy if kernels else None,
        device_calls=sum(k[2] for k in kernels),
        idle_share=1.0 - busy / wall if kernels else None,
        top=[dict(kernel=key[:70], calls=n, ms=us / 1e3)
             for us, key, n in kernels[:5]])
    if kernels_of:
        trace[f"{kernels_of[0]}device_s"] = sum(
            us for us, key, _ in kernels
            if any(k in key for k in kernels_of)) / 1e6
    if calls_by_kernel:
        trace["calls_by_kernel"] = [
            dict(kernel=key[:90], calls=n)
            for n, key in sorted(((n, key) for _, key, n in kernels),
                                 reverse=True)]
    return out, wall, trace


def phase_breakdown(torch, fn, calls_by_kernel: bool = False) -> dict:
    """A phase's warm wall time, device time, idle share and top kernels."""
    _, wall, trace = timed_and_traced(torch, fn, calls_by_kernel)
    return dict(wall_s=wall, **trace)


def stream_requests(n_requests: int, seed: int = 11):
    """A served stream: ``n_requests`` (Q, 784) requests, Q log-uniform in
    [1, 256] (single queries to two full slabs), cut from one pool of
    queries made in bulk."""
    import numpy as np
    from repro_torch.data import kpca_dataset
    rng = np.random.default_rng(seed)
    sizes = np.rint(np.exp(rng.uniform(0.0, np.log(256.0), n_requests)))
    sizes = sizes.astype(np.int64).clip(1, 256)
    pool = kpca_dataset(STREAM_POOL, m=784, seed=seed)
    starts = rng.integers(0, STREAM_POOL - sizes + 1)
    return [pool[s0:s0 + q] for s0, q in zip(starts, sizes)]


def drain_stream(engine, requests, per_drain: int):
    """Submit the stream ``per_drain`` requests at a time and flush each
    group: returns every request's scores and each drain's wall seconds
    (submit to results; in the synchronous engine that is each of its
    requests' latency)."""
    outs, drains = [], []
    for i in range(0, len(requests), per_drain):
        t0 = time.perf_counter()
        futs = [engine.submit(x) for x in requests[i:i + per_drain]]
        engine.flush()
        outs.extend(f.result() for f in futs)
        drains.append(time.perf_counter() - t0)
    return outs, drains


def phase_serve_stream(dev, models) -> dict:
    """Sustained serving: STREAM_REQUESTS mixed-size requests in drains of
    STREAM_PER_DRAIN, per model; steady-state wall time, drain latency,
    device time and idle share over the whole stream, every score held
    against the plain projection on the card."""
    import numpy as np
    import torch
    from repro_torch.kernels import project_reference
    from repro_torch.serve import KpcaEngine, KpcaServeConfig
    requests = stream_requests(STREAM_REQUESTS)
    rows = sum(x.shape[0] for x in requests)
    flat = np.concatenate(requests)
    out, sync_scores = {}, {}
    from repro_torch.kernels import project_tiles
    for name, mdl in models:
        engine = KpcaEngine(mdl, KpcaServeConfig(max_batch=128,
                                                 min_bucket=8), device=dev)
        before = project_tiles.launches
        (scores, drains), wall, trace = timed_and_traced(
            torch, lambda: drain_stream(engine, requests, STREAM_PER_DRAIN),
            kernels_of=("project_", SPLIT_KERNEL))
        # timed_and_traced drains the stream three times (warm, timed,
        # traced); the launches of one pass
        project_launches = (project_tiles.launches - before) // 3
        got = np.concatenate(scores)
        sync_scores[name] = scores
        err = 0.0
        for i in range(0, rows, 16384):
            want = project_reference(
                mdl.spec, torch.as_tensor(flat[i:i + 16384], device=dev),
                mdl.x_support, mdl.coefs, mdl.row_mean_coef, mdl.bias,
                mdl.gamma).cpu().numpy()
            err = max(err, float(np.abs(got[i:i + 16384] - want).max()))
        check(got.shape == (rows, mdl.n_components) and err <= TOL,
              f"stream ({name}) disagrees with the plain projection: "
              f"{err:.3g} > {TOL}")
        stats = engine.stats
        drain_ms = np.asarray(drains) * 1e3
        out[name] = dict(
            support=mdl.n_support, max_abs_err=err, wall_s=wall,
            queries_per_s=rows / wall, requests_per_s=len(requests) / wall,
            drain_ms_p50=float(np.percentile(drain_ms, 50)),
            drain_ms_p99=float(np.percentile(drain_ms, 99)),
            drain_ms_max=float(drain_ms.max()),
            padded_share=stats.n_padded / (stats.n_queries + stats.n_padded),
            project_launches=project_launches, **trace)
    emit("serve_stream", requests=len(requests), rows=rows,
         drains=-(-len(requests) // STREAM_PER_DRAIN),
         per_drain=STREAM_PER_DRAIN, max_batch=128, min_bucket=8,
         models=out)
    return {name: dict(numbers, scores=sync_scores[name])
            for name, numbers in out.items()}


STAT_FIELDS = ("n_requests", "n_queries", "n_padded", "n_rejected", "n_shed",
               "n_deadline_expired", "n_donated", "n_zero_copy_slabs",
               "n_h2d_bytes", "n_flushes", "n_compiles", "n_routed_mp",
               "n_routed_dp", "n_routed_single", "max_inflight_drains")


def run_async(engine, requests, threads: int = ASYNC_THREADS, midway=None,
              log=None, retry_s: float = ASYNC_RETRY_S,
              timeout: float = 120.0) -> dict:
    """The stream through a started engine from ``threads`` client threads
    (request i from thread i % threads, in order). A submit refused by
    admission control is retried by its client after a short sleep, and
    counted. ``midway`` runs on client 0 once it has submitted half its
    requests. Returns every request's scores (or its exception), the wall
    seconds from the first submit to the last result, the refused submits,
    the request ids, and this run's engine counters and latency
    percentiles; appended to ``log`` too. Results are awaited until one
    shared deadline, ``timeout`` seconds after the last submit."""
    import threading
    from repro_torch.serve import QueueFullError
    futs = [None] * len(requests)
    refused = [0] * threads

    def client(t):
        mine = range(t, len(requests), threads)
        for k, i in enumerate(mine):
            if midway is not None and t == 0 and k == len(mine) // 2:
                midway()
            while True:
                try:
                    futs[i] = engine.submit(requests[i])
                    break
                except QueueFullError:
                    refused[t] += 1
                    time.sleep(retry_s)

    before = {f: getattr(engine.stats, f) for f in STAT_FIELDS}
    t0 = time.perf_counter()
    clients = [threading.Thread(target=client, args=(t,))
               for t in range(threads)]
    for c in clients:
        c.start()
    for c in clients:
        c.join()
    outs = []
    deadline = time.monotonic() + timeout
    for f in futs:
        try:
            outs.append(f.result(timeout=max(0.0,
                                             deadline - time.monotonic())))
        except Exception as e:          # deadline and fault runs: the error
            outs.append(e)
    wall = time.perf_counter() - t0
    # the last drain's accounting follows its futures' resolution
    t_wait = time.perf_counter()
    while engine.stats.n_requests + engine.stats.n_deadline_expired < \
            before["n_requests"] + before["n_deadline_expired"] + \
            len(requests) and time.perf_counter() - t_wait < 30:
        time.sleep(1e-3)
    stats = {f: getattr(engine.stats, f) - (0 if f == "max_inflight_drains"
                                            else before[f])
             for f in STAT_FIELDS}
    recent = list(engine.stats.per_request)[-len(requests):]
    lat = sorted(r.latency_s for r in recent) or [0.0]
    wait = sorted(r.queue_wait_s for r in recent) or [0.0]
    run = dict(outs=outs, wall=wall, refused=sum(refused), stats=stats,
               rids=[f.request_id for f in futs],
               versions={r.request_id: r.model_version for r in recent},
               latency_ms_p50=1e3 * _pct(lat, 50),
               latency_ms_p99=1e3 * _pct(lat, 99),
               queue_wait_ms_p50=1e3 * _pct(wait, 50),
               queue_wait_ms_p99=1e3 * _pct(wait, 99))
    if log is not None:
        log.append(run)
    return run


def _pct(sorted_values, q) -> float:
    import numpy as np
    return float(np.percentile(sorted_values, q))


def max_err_vs_plain(dev, model, requests, outs) -> float:
    """Largest |score - plain projection| over a stream's requests."""
    import numpy as np
    import torch
    from repro_torch.kernels import project_reference
    flat, got = np.concatenate(requests), np.concatenate(outs)
    err = 0.0
    for i in range(0, flat.shape[0], 16384):
        want = project_reference(
            model.spec, torch.as_tensor(flat[i:i + 16384], device=dev),
            model.x_support, model.coefs, model.row_mean_coef, model.bias,
            model.gamma).cpu().numpy()
        err = max(err, float(np.abs(got[i:i + 16384] - want).max()))
    return err


def same_bits(a, b) -> int:
    """Requests whose scores differ in any bit between two runs."""
    import numpy as np
    return sum(not np.array_equal(x, y) for x, y in zip(a, b))


def async_numbers(run, trace, rows) -> dict:
    keep = {k: v for k, v in run.items()
            if k not in ("outs", "rids", "versions")}
    return dict(keep, queries_per_s=rows / run["wall"],
                requests_per_s=len(run["outs"]) / run["wall"], **trace)


def phase_serve_async(dev, models, sync) -> dict:
    """The started engine (flusher and device-runner threads, pinned
    staging, admission "reject" at queue_factor 8) under 4 client
    threads, on the consensus model and its 500-landmark compression:

      * the serve_stream stream, timed then traced: queries/s, the
        engine's latency percentiles, device time and idle share, beside
        serve_stream's synchronous numbers; every score against the plain
        projection, and bitwise against serve_stream's synchronous scores;
        64 aligned full-slab requests bitwise against the synchronous
        engine on each alone;
      * the same stream as bf16 slabs: bitwise against the synchronous fp32
        engine fed the bf16-rounded queries; host-to-card bytes and the
        project kernels' device time against the fp32 stream's;
      * (consensus model) a refresh through a ``BackgroundPublisher``
        landing mid-stream: every request bitwise the projection of the
        version its ``RequestStats`` names;
      * (consensus model) a request deadline below one drain's time: the
        expired futures carry ``DeadlineExceededError``.

    Launches are counted from the first started engine to the last result:
    the synchronous references run before the count, the comparisons after
    it."""
    import numpy as np
    import torch
    from repro_torch.core import oos
    from repro_torch.data import kpca_dataset
    from repro_torch.faults import DeadlineExceededError
    from repro_torch.serve import (BackgroundPublisher, KpcaEngine,
                                   KpcaServeConfig, ModelHandle)
    t_phase = time.perf_counter()
    requests = stream_requests(STREAM_REQUESTS)
    rows = sum(x.shape[0] for x in requests)
    rounded = [torch.as_tensor(x).bfloat16().float().numpy()
               for x in requests]
    aligned = [kpca_dataset(128, m=784, seed=500 + i) for i in range(64)]
    deadline_reqs = requests[:512]
    cfg = dict(max_batch=128, min_bucket=8, queue_factor=ASYNC_QUEUE_FACTOR,
               admission="reject")
    sync_cfg = KpcaServeConfig(max_batch=128, min_bucket=8)
    runs, out = {}, {}
    for name, mdl in models:        # the synchronous references, uncounted
        sync_eng = KpcaEngine(mdl, sync_cfg, device=dev)
        runs[name] = dict(
            aligned_sync=[sync_eng.project_many([x])[0] for x in aligned],
            rounded_sync=drain_stream(sync_eng, rounded,
                                      STREAM_PER_DRAIN)[0])
    zero_launches()
    for name, mdl in models:
        r = runs[name]
        with KpcaEngine(mdl, KpcaServeConfig(**cfg), device=dev) as eng:
            log = []
            _, _, r["fp32_trace"] = timed_and_traced(
                torch, lambda: run_async(eng, requests, log=log),
                kernels_of=("project_", SPLIT_KERNEL), warm=False)
            r["fp32"] = log[0]
            r["aligned"] = run_async(eng, aligned)["outs"]
        with KpcaEngine(mdl, KpcaServeConfig(query_dtype=torch.bfloat16,
                                             **cfg), device=dev) as eng:
            log = []
            _, _, r["bf16_trace"] = timed_and_traced(
                torch, lambda: run_async(eng, requests, log=log),
                kernels_of=("project_", SPLIT_KERNEL), warm=False)
            r["bf16"] = log[0]
    name, full = models[0]
    handle = ModelHandle(full)
    alpha = -2.0 * full.coefs
    with KpcaEngine(handle, KpcaServeConfig(**cfg), device=dev) as eng, \
            BackgroundPublisher(handle) as pub:
        publish = run_async(eng, requests[:1024],
                            midway=lambda: pub.refresh(alpha))
        pub.drain(timeout=60)
    drain_s = sync[name]["drain_ms_p50"] / 1e3
    deadline_s = min(2e-4, drain_s / 4)
    with KpcaEngine(full, KpcaServeConfig(request_deadline_s=deadline_s,
                                          **cfg), device=dev) as eng:
        late = run_async(eng, deadline_reqs, threads=1)
    launches = read_launches("serve_async", ("project", "project_bf16"))

    for name, mdl in models:
        r = runs[name]
        fp32, bf16 = r["fp32"], r["bf16"]
        err = max_err_vs_plain(dev, mdl, requests, fp32["outs"])
        err_bf16 = max_err_vs_plain(dev, mdl, rounded, bf16["outs"])
        diff_sync = same_bits(fp32["outs"], sync[name]["scores"])
        diff_aligned = same_bits(r["aligned"], r["aligned_sync"])
        diff_bf16 = same_bits(bf16["outs"], r["rounded_sync"])
        check(err <= TOL and err_bf16 <= TOL,
              f"serve_async ({name}) disagrees with the plain projection: "
              f"{err:.3g}, bf16 {err_bf16:.3g} > {TOL}")
        check(diff_aligned == 0, f"serve_async ({name}): {diff_aligned} "
                                 f"aligned requests differ from the sync "
                                 f"engine")
        check(diff_sync == 0, f"serve_async ({name}): {diff_sync} stream "
                              f"requests differ from serve_stream's "
                              f"synchronous scores")
        check(diff_bf16 == 0, f"serve_async ({name}): {diff_bf16} bf16 "
                              f"requests differ from the fp32 engine on the "
                              f"rounded queries")
        check(fp32["stats"]["n_compiles"] == 0,
              f"serve_async ({name}): traffic met an unwarmed shape")
        proj = "project_device_s"
        out[name] = dict(
            support=mdl.n_support, max_abs_err=err, max_abs_err_bf16=err_bf16,
            requests_differing_from_sync_stream=diff_sync,
            aligned_requests_differing_from_sync=diff_aligned,
            bf16_requests_differing_from_fp32_of_rounded=diff_bf16,
            fp32=async_numbers(fp32, r["fp32_trace"], rows),
            bf16=async_numbers(bf16, r["bf16_trace"], rows),
            h2d_bytes_fp32=fp32["stats"]["n_h2d_bytes"],
            h2d_bytes_bf16=bf16["stats"]["n_h2d_bytes"],
            project_device_s_fp32=r["fp32_trace"][proj],
            project_device_s_bf16=r["bf16_trace"][proj],
            sync={k: sync[name][k] for k in (
                "queries_per_s", "drain_ms_p50", "drain_ms_p99",
                "device_s", "idle_share", proj, "wall_s")})
        # bytes per staged row (real and pad rows; dynamic batching pads
        # the two runs differently)
        per_row = {k: r[k]["stats"]["n_h2d_bytes"] / (
            r[k]["stats"]["n_queries"] + r[k]["stats"]["n_padded"])
            for k in ("fp32", "bf16")}
        out[name]["h2d_bytes_per_row"] = per_row
        check(per_row == {"fp32": 4.0 * 784, "bf16": 2.0 * 784},
              f"serve_async ({name}): host-to-card bytes per row {per_row}")

    # the publish: each request against the version its stats name
    name, full = models[0]
    versions = [full, oos.refresh_coefficients(full, alpha)]
    served = {}
    for rid, x, got in zip(publish["rids"], requests[:1024],
                           publish["outs"]):
        v = publish["versions"].get(rid, -1)
        served.setdefault(v, []).append((x, got))
    check(set(served) == {0, 1}, f"serve_async publish: versions served "
                                 f"{sorted(served)}, want both 0 and 1")
    mismatched = 0
    for v, pairs in served.items():
        if v not in (0, 1):
            mismatched += len(pairs)
            continue
        project = oos.projector(versions[v])
        flat = np.concatenate([x for x, _ in pairs])
        want = np.concatenate([
            project(torch.as_tensor(flat[i:i + 8192], device=dev))
            .cpu().numpy() for i in range(0, flat.shape[0], 8192)])
        got = np.concatenate([g for _, g in pairs])
        mismatched += int(not np.array_equal(got, want))
    check(mismatched == 0, "serve_async publish: a request's scores are not "
                           "its recorded version's")
    expired = [o for o in late["outs"] if isinstance(o, Exception)]
    typed = all(isinstance(e, DeadlineExceededError) for e in expired)
    served_late = [(x, o) for x, o in zip(deadline_reqs, late["outs"])
                   if not isinstance(o, Exception)]
    late_err = max_err_vs_plain(dev, full, [x for x, _ in served_late],
                                [o for _, o in served_late]) \
        if served_late else 0.0
    check(expired and typed and
          len(expired) == late["stats"]["n_deadline_expired"]
          and late_err <= TOL,
          f"serve_async deadline: {len(expired)} expired (typed {typed}), "
          f"engine counted {late['stats']['n_deadline_expired']}, served "
          f"error {late_err:.3g}")
    emit("serve_async", requests=len(requests), rows=rows,
         client_threads=ASYNC_THREADS, queue_factor=ASYNC_QUEUE_FACTOR,
         admission="reject", client_retry_s=ASYNC_RETRY_S, max_batch=128,
         min_bucket=8, models=out,
         publish=dict(requests=1024, by_version={
             str(v): len(p) for v, p in sorted(served.items())},
             mismatched=mismatched),
         deadline=dict(requests=len(deadline_reqs), deadline_s=deadline_s,
                       sync_drain_s_p50=drain_s, expired=len(expired),
                       engine_expired=late["stats"]["n_deadline_expired"],
                       served=len(served_late), max_abs_err=late_err),
         launches=launches, phase_s=time.perf_counter() - t_phase)
    return launches


def phase_serve_sharded(dev, full) -> dict:
    """``shard_fitted(full, 4)`` and its 125-landmark-per-shard compression
    (Nystrom per shard, through gram), each served through the started
    engine by routing "auto" (one card: make_serving_mesh(4) is None, so
    "single") and then "mp" and "dp" forced over the mesh [card, card]
    (the mp and dp code driven twice on the one H100: not a multi-card
    result). Every request within 3e-4 of the plain projection of the
    unsharded model (for the compressed one, its gathered form); steady
    drains hit the placement cache and split no support. Device time per
    slab of "single" beside the unsharded engine's on the same requests
    (run after the launch count is read)."""
    import torch
    from repro_torch.core import oos
    from repro_torch.kernels import prepare_support
    from repro_torch.serve import KpcaEngine, KpcaServeConfig
    t_phase = time.perf_counter()
    requests = stream_requests(SHARDED_REQUESTS, seed=13)
    rows = sum(x.shape[0] for x in requests)
    cfg = dict(max_batch=128, min_bucket=8)
    zero_launches()
    sharded, _ = oos.shard_fitted(full, 4)
    compressed, rel_err = oos.shard_fitted(full, 4, landmarks_per_shard=125)
    cases = (("sharded", sharded, full),
             ("sharded_compressed", compressed, oos.gather_fitted(compressed)))
    runs = {}
    for name, sh, unsharded in cases:
        for routing, mesh in (("auto", None), ("mp", [dev, dev]),
                              ("dp", [dev, dev])):
            eng = KpcaEngine(sh, KpcaServeConfig(routing=routing, **cfg),
                             device=dev, mesh=mesh)
            with eng:
                support0 = prepare_support.launches
                log = []
                if routing == "auto":
                    _, _, trace = timed_and_traced(
                        torch, lambda: run_async(eng, requests, log=log),
                        warm=False)
                    run = log[0]
                    trace["device_s_per_slab"] = trace["device_s"] / \
                        log[1]["stats"]["n_donated"]
                else:
                    run, trace = run_async(eng, requests), {}
                steady_splits = prepare_support.launches - support0
            runs[name, routing] = (run, trace, steady_splits,
                                   eng.router.n_placements,
                                   eng.router.n_placement_hits,
                                   eng.stats.routing_summary())
    launches = read_launches("serve_sharded", ("gram", "project",
                                               "project_partial"))
    for name, _, unsharded in cases:    # the unsharded baseline, uncounted
        with KpcaEngine(unsharded, KpcaServeConfig(**cfg), device=dev) as eng:
            log = []
            _, _, trace = timed_and_traced(
                torch, lambda: run_async(eng, requests, log=log), warm=False)
            trace["device_s_per_slab"] = trace["device_s"] / \
                log[1]["stats"]["n_donated"]
            runs[name, "unsharded"] = (log[0], trace)
    out = {}
    for name, sh, unsharded in cases:
        per = out[name] = dict(support=sh.n_support, shards=sh.n_shards,
                               shard_sizes=list(sh.shard_sizes))
        for routing in ("auto", "mp", "dp"):
            run, trace, splits, placements, hits, summary = \
                runs[name, routing]
            err = max_err_vs_plain(dev, unsharded, requests, run["outs"])
            want = "single" if routing == "auto" else routing
            check(err <= SHARDED_TOL, f"serve_sharded ({name}, {routing}): "
                                      f"{err:.3g} > {SHARDED_TOL}")
            check(run["stats"][f"n_routed_{want}"] > 0 and summary.startswith(
                f"{want}:") and "," not in summary,
                f"serve_sharded ({name}, {routing}): routed {summary}")
            check(splits == 0 and hits > 0,
                  f"serve_sharded ({name}, {routing}): {splits} support "
                  f"splits in steady drains, {hits} placement hits")
            per[routing] = dict(
                max_abs_err=err, routed=summary, placements=placements,
                placement_hits=hits, steady_support_splits=splits,
                queries_per_s=rows / run["wall"],
                latency_ms_p50=run["latency_ms_p50"],
                latency_ms_p99=run["latency_ms_p99"], **trace)
        run, trace = runs[name, "unsharded"]
        per["unsharded"] = dict(queries_per_s=rows / run["wall"], **trace)
    emit("serve_sharded", requests=len(requests), rows=rows,
         mesh="[card, card] for mp and dp (one H100)", tolerance=SHARDED_TOL,
         compress_rel_err_bound=[float(v) for v in rel_err], models=out,
         launches=launches, phase_s=time.perf_counter() - t_phase)
    return launches


def fault_plan():
    """The faults phase's plan on the fit's ring(20, hops=2)."""
    from repro_torch.faults import (FaultPlan, LinkFault, NodeDropout,
                                    StragglerStall, link_delay)
    return FaultPlan(seed=3,
                     dropouts=(NodeDropout(t=15, node=3),
                               NodeDropout(t=15, node=7)),
                     links=(LinkFault(t0=5, t1=12, u=0, v=2),
                            link_delay(8, 4, u=10, v=12)),
                     stragglers=(StragglerStall(t0=10, t1=14, node=16),))


def fault_fit(dev, spec, nodes, ledger=None):
    """The fault-tolerant fit of the faults phase, run to its end."""
    from repro_torch.core import ring
    from repro_torch.faults import FaultTolerantRun
    run = FaultTolerantRun(nodes, ring(20, hops=2), spec, fault_plan(),
                           n_iters=40, chunk=10, ledger=ledger, device=dev)
    chunks = list(run.chunks())
    return run, chunks


def phase_faults(dev, spec, nodes, full) -> dict:
    """The fault-tolerant fit and fault-injected serving on the card.

      * fit: ``fault_fit`` with a ``CommLedger``: t, one re-knit, the
        survivors, the events in order, the ledger against the JAX
        package's numbers; after the launch counts are read, the
        survivors' similarity to the central kPCA of their pooled data
        (the run's pinned gamma) and the fit's breakdown;
      * shard loss: ``shard_fitted(full, 4)`` behind a ``ModelHandle``,
        through the started engine with a ``ShardLossInjector`` (shard 1
        lost at the first dispatch), a ``ShardRebalancer`` and
        max_retries=4, 1024 requests of the serve_stream law from 4
        client threads;
      * transient faults: ``transient_faults(2)`` under max_retries=3, on
        the consensus model;
      * publisher crash: a ``CrashingHandle`` (job 0 crashes) under a
        ``BackgroundPublisher``: the engine serves version 0 through the
        crash, and the next job publishes version 1.
    """
    import numpy as np
    import torch
    from repro_torch.core import central_kpca, oos, similarity
    from repro_torch.faults import (CrashingHandle, FaultError, FaultPlan,
                                    InjectedCrashError, PublisherCrash,
                                    ShardLoss, ShardLossInjector,
                                    ShardRebalancer, transient_faults)
    from repro_torch.obs import CommLedger
    from repro_torch.serve import (BackgroundPublisher, KpcaEngine,
                                   KpcaServeConfig, ModelHandle)
    t_phase = time.perf_counter()
    zero_launches()

    # -- the fault-tolerant fit ---------------------------------------------
    ledger = CommLedger()
    t0 = time.perf_counter()
    run, chunks = fault_fit(dev, spec, nodes, ledger)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    survivors = [int(v) for v in run.node_ids]
    events = [e.kind for e in run.events]
    tot = ledger.totals()
    got_ledger = dict(
        per_iter=(ledger.per_iter.bytes, ledger.per_iter.messages),
        setup=(ledger.setup.bytes, ledger.setup.messages),
        totals=(tot.bytes, tot.messages), iterations=ledger.iterations)
    check(run.state.t == 40 and run.n_reknits == 1,
          f"faults fit: t={run.state.t}, {run.n_reknits} re-knits")
    check(survivors == [j for j in range(20) if j not in (3, 7)],
          f"faults fit: survivors {survivors}")
    check(events == ["link", "link", "straggler", "dropout"],
          f"faults fit: events {events}")
    check(bool(torch.isfinite(run.state.alpha).all()),
          "faults fit: non-finite alpha")
    check(got_ledger == FAULT_LEDGER,
          f"faults fit: ledger {got_ledger}, the JAX package's "
          f"{FAULT_LEDGER}")

    # -- shard loss under load ----------------------------------------------
    requests = stream_requests(SHARDED_REQUESTS, seed=17)
    sharded, _ = oos.shard_fitted(full, 4)
    handle = ModelHandle(sharded)
    injector = ShardLossInjector(FaultPlan(
        shard_losses=(ShardLoss(at_dispatch=0, shard=1),)))
    rebalancer = ShardRebalancer()
    cfg = dict(max_batch=128, min_bucket=8)
    t1 = time.perf_counter()
    with KpcaEngine(handle, KpcaServeConfig(max_retries=4,
                                            retry_backoff_s=0.005, **cfg),
                    device=dev, inject_fault=injector,
                    on_fault=rebalancer) as eng:
        loss = run_async(eng, requests, timeout=FAULT_WAIT_S)
        retries = eng.stats.n_retries
    shard_s = time.perf_counter() - t1
    failed = [o for o in loss["outs"] if isinstance(o, Exception)]
    served = [(q, o) for q, o in zip(requests, loss["outs"])
              if not isinstance(o, Exception)]
    survivor = oos.gather_fitted(oos.drop_shard(sharded, 1))
    loss_err = max_err_vs_plain(dev, survivor, [q for q, _ in served],
                                [o for _, o in served]) if served else None
    versions = sorted(set(loss["versions"].values()))
    check(len(loss["outs"]) == len(requests)
          and all(isinstance(e, FaultError) for e in failed),
          f"faults serve: unresolved or untyped failures "
          f"{sorted({type(e).__name__ for e in failed})}")
    check(rebalancer.n_rebalances == 1 and injector.n_raised >= 1,
          f"faults serve: {rebalancer.n_rebalances} re-balances, "
          f"{injector.n_raised} injected losses")
    check(handle.version == 1 and handle.current().shard_sizes[1] == 0,
          f"faults serve: version {handle.version}, shard sizes "
          f"{handle.current().shard_sizes}")
    check(bool(served) and loss_err <= SHARDED_TOL,
          f"faults serve: {len(served)} served, error {loss_err} against "
          f"the survivor model > {SHARDED_TOL}")

    # -- transient faults, healed by retries ----------------------------------
    few = requests[:64]
    with KpcaEngine(full, KpcaServeConfig(max_retries=3,
                                          retry_backoff_s=0.001, **cfg),
                    device=dev, inject_fault=transient_faults(2)) as eng:
        healed = run_async(eng, few, timeout=FAULT_WAIT_S)
        healed_retries = eng.stats.n_retries
    healed_bad = [o for o in healed["outs"] if isinstance(o, Exception)]
    healed_err = max_err_vs_plain(dev, full, few, healed["outs"]) \
        if not healed_bad else None
    check(not healed_bad and healed_retries == 2 and healed_err <= TOL,
          f"faults transient: {len(healed_bad)} failed, {healed_retries} "
          f"retries, error {healed_err}")

    # -- a publisher crash: the engine serves the stale version --------------
    alpha = -2.0 * full.coefs
    base = ModelHandle(full)
    crashing = CrashingHandle(base, FaultPlan(
        publisher_crashes=(PublisherCrash(at_job=0),)))
    crashed = False
    with KpcaEngine(base, KpcaServeConfig(**cfg), device=dev) as eng, \
            BackgroundPublisher(crashing) as pub:
        pub.refresh(alpha)
        try:
            pub.drain(timeout=FAULT_WAIT_S)
        except InjectedCrashError:
            crashed = True
        stale = run_async(eng, few, timeout=FAULT_WAIT_S)
        pub.refresh(alpha)
        pub.drain(timeout=FAULT_WAIT_S)
        fresh = run_async(eng, few, timeout=FAULT_WAIT_S)
    stale_v = sorted(set(stale["versions"].values()))
    fresh_v = sorted(set(fresh["versions"].values()))
    bad = [o for o in stale["outs"] + fresh["outs"]
           if isinstance(o, Exception)]
    errs = (None, None) if bad else (
        max_err_vs_plain(dev, full, few, stale["outs"]),
        max_err_vs_plain(dev, oos.refresh_coefficients(full, alpha), few,
                         fresh["outs"]))
    check(crashed and crashing.n_crashes == 1 and not bad
          and stale_v == [0] and fresh_v == [1] and max(errs) <= TOL,
          f"faults publisher: crashed {crashed} ({crashing.n_crashes}), "
          f"{len(bad)} failed, versions {stale_v} then {fresh_v}, errors "
          f"{errs}")
    launches = read_launches("faults", ("gram", "admm_step", "project",
                                        "project_partial", "eigh"))
    check(launches["eigh"] == 1 + run.n_reknits
          and launches["eigh_library"] == 0,
          f"faults: eigh launches {launches['eigh']} ({1 + run.n_reknits}, "
          f"one a build_setup), library eigensolves "
          f"{launches['eigh_library']} (0)")

    # -- the fit's quality (after the count: the central kPCA and the
    # similarities launch gram and center for the check, not the path) -------
    t0 = time.perf_counter()
    x = run.x_nodes
    pooled = x.reshape(-1, x.shape[-1])
    a_gt, _, _ = central_kpca(pooled, spec, 1, gamma=run.gamma, device=dev)
    sims = [float(similarity(run.state.alpha[j], x[j], a_gt[:, 0], pooled,
                             spec, gamma=run.gamma))
            for j in range(x.shape[0])]
    torch.cuda.synchronize()
    score_s = time.perf_counter() - t0
    check(sum(sims) / len(sims) >= SIM30_MIN and min(sims) >= 0.95,
          f"faults fit: survivor similarity mean "
          f"{sum(sims) / len(sims):.5f} (>= {SIM30_MIN}), min "
          f"{min(sims):.5f} (>= 0.95)")

    # -- where the fit's time goes (after the count) -------------------------
    breakdown = phase_breakdown(torch, lambda: fault_fit(dev, spec, nodes))
    emit("faults",
         fit=dict(nodes=20, per_node=100, features=784, iterations=40,
                  chunk=10, plan=fault_plan().to_dict(), t=run.state.t,
                  reknits=run.n_reknits, survivors=survivors, events=events,
                  chunk_lengths=[int(c.alpha_hist.shape[0]) for c in chunks],
                  chunk_comm_bytes=[c.comm_bytes for c in chunks],
                  similarity_mean=sum(sims) / len(sims),
                  similarity_min=min(sims), ledger=ledger.snapshot(),
                  fit_s=fit_s, score_s=score_s,
                  breakdown=breakdown),
         shard_loss=dict(requests=len(requests),
                         rows=sum(q.shape[0] for q in requests),
                         served=len(served), failed=len(failed),
                         failed_types=sorted({type(e).__name__
                                              for e in failed}),
                         rebalances=rebalancer.n_rebalances,
                         injected=injector.n_raised,
                         dispatches=injector.dispatches, retries=retries,
                         version=handle.version, versions_served=versions,
                         shard_sizes=list(handle.current().shard_sizes),
                         max_abs_err=loss_err, tolerance=SHARDED_TOL,
                         wall_s=loss["wall"], phase_s=shard_s),
         transient=dict(requests=len(few), retries=healed_retries,
                        failed=len(healed_bad), max_abs_err=healed_err),
         publisher=dict(crashed=crashed, crashes=crashing.n_crashes,
                        stale_versions=stale_v, fresh_versions=fresh_v,
                        max_abs_err_stale=errs[0],
                        max_abs_err_fresh=errs[1]),
         launches=launches, phase_s=time.perf_counter() - t_phase)
    return launches


def ring_gate(got, want) -> tuple:
    """The reference's SPMD gate (tests/helpers/check_dkpca_distributed.py):
    (max |got - want|, 5e-3 * max |want| + 1e-4)."""
    err = float((got - want).abs().max())
    return err, 5e-3 * float(want.abs().max()) + 1e-4


def ring_rank(rank: int, world: int, store: str, alpha0, out: str) -> None:
    """One rank of the multi-card ring fit (a spawned process on card
    ``rank``): the fit's configuration, 20 / world nodes a rank; writes
    its gathered alpha (rank 0), its kernel launches and its times."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist
    from repro_torch.core import KernelSpec, dkpca_distributed
    from repro_torch.data import node_dataset
    from repro_torch.kernels import admm_local_update, gram_tiles
    from repro_torch.launch import make_process_group
    group, dev = make_process_group("cuda", rank=rank, world_size=world,
                                    local_rank=rank,
                                    init_method=f"file://{store}")
    try:
        nodes, _ = node_dataset(20, 100, m=784, seed=0)
        times = []
        for _ in range(2):                      # first run, then warm
            dist.barrier()
            t0 = time.perf_counter()
            res = dkpca_distributed(nodes, group=group, hops=2,
                                    spec=KernelSpec(kind="rbf"),
                                    n_iters=30, alpha0=alpha0, device=dev)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        if rank == 0:
            torch.save(res.alpha.cpu(), f"{out}/alpha.pt")
        Path(f"{out}/rank{rank}.json").write_text(json.dumps(dict(
            card=str(dev), first_s=times[0], warm_s=times[1],
            gram=gram_tiles.launches, admm_step=admm_local_update.launches)))
    finally:
        dist.destroy_process_group()


def ring_on_cards(alpha0, want) -> dict:
    """The ring fit spread over min(4, cards) NCCL ranks, one card and
    20 / world nodes each (the largest such world that splits the ring
    evenly), in spawned processes with a timeout; the gathered alpha held
    to the one-card ring's at the reference's gate. On one card it does
    not run, and says why."""
    import multiprocessing
    import torch
    count = torch.cuda.device_count()
    world = max(w for w in range(1, min(DKPCA_MAX_RANKS, count) + 1)
                if 20 % w == 0)
    if world < 2:
        reason = (f"{count} card(s) on this host: the multi-card ring needs "
                  f"2 or more (run it on a four-card host)")
        print(f"chip_smoke: dkpca: the multi-card ring did not run: "
              f"{reason}", file=sys.stderr, flush=True)
        return dict(ran=False, reason=reason)
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        procs = [ctx.Process(target=ring_rank,
                             args=(r, world, f"{tmp}/store", alpha0, tmp))
                 for r in range(world)]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        deadline = time.monotonic() + DKPCA_RANK_TIMEOUT_S
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        wall = time.perf_counter() - t0
        codes = [p.exitcode for p in procs]
        check(not hung and codes == [0] * world,
              f"dkpca cards: ranks {hung} hung, exit codes {codes}")
        if hung or codes != [0] * world:
            return dict(ran=True, world=world, exit_codes=codes, hung=hung)
        ranks = [json.loads(Path(f"{tmp}/rank{r}.json").read_text())
                 for r in range(world)]
        got = torch.load(f"{tmp}/alpha.pt")
    err, gate = ring_gate(got, want.cpu())
    check(err <= gate, f"dkpca cards: alpha {err:.3g} from the one-card "
                       f"ring > {gate:.3g}")
    for r in ranks:
        check(r["gram"] > 0 and r["admm_step"] == 60,
              f"dkpca cards: launches {r}")
    return dict(ran=True, world=world, nodes_per_rank=20 // world,
                max_abs_err_vs_one_card=err, gate=gate, spawn_wall_s=wall,
                ranks=ranks)


def phase_dkpca(dev, spec, nodes, setup, dense_alpha, alpha_gt) -> dict:
    """The ring fit (``dkpca_distributed`` over ``RingComm``) at the fit's
    configuration, in this process on a NCCL group of world 1 (all 20
    nodes on the card; a FileStore under build/), then over several cards
    when the host has them:

      * counted: one run from the dense fit's alpha0 (init="local" of the
        dense setup) with a ledger: its launches (gram: the J sweep
        cross-Grams and one batched slot-Gram launch, at least; admm_step:
        exactly one an iteration), its alpha at iteration 30 against the
        dense run_admm on the card at the reference's SPMD gate, its
        similarity@30, and its ledger against the JAX package's per-node
        profile;
      * after the count: a default init="local" run (similarity@30), a
        bf16-message run (similarity and per-iteration bytes, recorded),
        the warm time and a traced run (device time, calls, idle share),
        and the multi-card ring (``ring_on_cards``)."""
    import torch
    import torch.distributed as dist
    from repro_torch.core import dkpca_distributed, initial_alpha
    from repro_torch.launch import make_process_group
    from repro_torch.obs import CommLedger
    t_phase = time.perf_counter()
    x_nodes = setup.x
    pooled = x_nodes.reshape(-1, x_nodes.shape[-1])
    alpha0 = initial_alpha(setup, "local")
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        group, _ = make_process_group(dev, rank=0, world_size=1,
                                      local_rank=0,
                                      init_method=f"file://{tmp}/store")
        try:
            def fit(**kw):
                return dkpca_distributed(nodes, group=group, hops=2,
                                         spec=spec, center="global",
                                         n_iters=30, device=dev, **kw)

            ledger = CommLedger()
            zero_launches()
            t0 = time.perf_counter()
            res = fit(alpha0=alpha0, ledger=ledger)
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
            launches = read_launches("dkpca", ("gram", "admm_step", "eigh"))
            local = fit()
            bf16_ledger = CommLedger()
            bf16 = fit(alpha0=alpha0, message_dtype=torch.bfloat16,
                       ledger=bf16_ledger)
            _, warm_s, trace = timed_and_traced(
                torch, lambda: fit(alpha0=alpha0))
        finally:
            dist.destroy_process_group()
    err, gate = ring_gate(res.alpha, dense_alpha)
    sims = {name: mean_similarity(r.alpha_hist[29], x_nodes, pooled,
                                  alpha_gt, spec, setup.gamma)
            for name, r in (("alpha0_of_dense", res), ("init_local", local),
                            ("bf16_messages", bf16))}
    got_ledger = dict(
        per_iter=(ledger.per_iter.bytes, ledger.per_iter.messages,
                  ledger.per_iter.collectives),
        setup=(ledger.setup.bytes, ledger.setup.messages,
               ledger.setup.collectives))
    predicted_gram = 20 + 1
    check(err <= gate, f"dkpca: alpha@30 {err:.3g} from the dense fit > "
                       f"{gate:.3g}")
    for name in ("alpha0_of_dense", "init_local"):
        check(sims[name][0] >= SIM30_MIN, f"dkpca ({name}): similarity@30 "
                                          f"{sims[name][0]:.4f} < "
                                          f"{SIM30_MIN}")
    check(got_ledger == DKPCA_LEDGER, f"dkpca: ledger {got_ledger}, the JAX "
                                      f"package's {DKPCA_LEDGER}")
    check(launches["gram"] >= predicted_gram and launches["admm_step"] == 30
          and launches["eigh"] == 1 and launches["eigh_library"] == 0,
          f"dkpca: launches {launches}, predicted gram >= "
          f"{predicted_gram}, admm_step 30, eigh 1 and eigh_library 0")
    check(bool(torch.isfinite(bf16.alpha_hist).all())
          and bf16_ledger.per_iter.bytes == DKPCA_BF16_BYTES,
          f"dkpca bf16: finite {bool(torch.isfinite(bf16.alpha_hist).all())}"
          f", {bf16_ledger.per_iter.bytes} B an iteration")
    cards = ring_on_cards(alpha0.cpu().numpy(), res.alpha)
    emit("dkpca", nodes=20, per_node=100, features=784, hops=2, world=1,
         iterations=30, max_abs_err_vs_dense=err, gate=gate,
         similarity_mean={k: v[0] for k, v in sims.items()},
         similarity_min={k: v[1] for k, v in sims.items()},
         ledger=ledger.snapshot(), bf16_ledger=bf16_ledger.snapshot(),
         predicted_gram_launches=predicted_gram, launches=launches,
         first_s=first_s, warm_s=warm_s, **trace, cards=cards,
         phase_s=time.perf_counter() - t_phase)
    return launches


def phase_serve_kpca() -> dict:
    """``python -m repro_torch.launch.serve_kpca`` at the smoke's serving
    width in a subprocess with a timeout, with its trace and metrics files
    under build/: rc 0, the served line, no faulted future, at least the
    two injected faults retried, both files written with the engine's
    spans in the trace; its q/s and latencies, and the launches it
    reports."""
    import os
    import re
    t_phase = time.perf_counter()
    env = {k: v for k, v in os.environ.items() if k != "REPRO_PLATFORM"}
    env["PYTHONPATH"] = str(ROOT / "src")
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        trace_p, metrics_p = Path(tmp) / "trace.json", Path(tmp) / "m.json"
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.serve_kpca",
             *SERVE_KPCA_ARGS, "--trace-out", str(trace_p), "--metrics-out",
             str(metrics_p)], env=env, cwd=ROOT, capture_output=True,
            text=True, timeout=SERVE_KPCA_TIMEOUT_S)
        wall = time.perf_counter() - t_phase
        spans = sorted({e["name"] for e in json.loads(trace_p.read_text())[
            "traceEvents"]}) if trace_p.exists() else []
        metrics_written = metrics_p.exists() and bool(
            json.loads(metrics_p.read_text()))
    text = out.stdout
    served = re.search(r"served (\d+) queries / (\d+) requests \((\d+) "
                       r"futures\) in ([\d.]+)s -> (\d+) q/s wall", text)
    lat = re.search(r"compute p50=(\S+) p99=(\S+)  queue-wait p50=(\S+) "
                    r"p99=(\S+)", text)
    nums = {k: int(v) for k, v in re.findall(
        r"\b(retries|faulted_futures|gram|project|center|admm_step)=(\d+)",
        text)}
    check(out.returncode == 0 and served is not None,
          f"serve_kpca: rc {out.returncode}, served line "
          f"{served is not None}: {out.stderr[-2000:]}")
    check(nums.get("faulted_futures") == 0 and nums.get("retries", 0) >= 2,
          f"serve_kpca: {nums}")
    check(metrics_written and "serve.dispatch" in spans,
          f"serve_kpca: metrics file {metrics_written}, spans {spans}")
    launches = {k: nums.get(k) for k in ("gram", "project", "center",
                                         "admm_step")}
    check(bool(launches["gram"]) and bool(launches["project"]),
          f"serve_kpca: kernel launches {launches}")
    emit("serve_kpca", args=" ".join(SERVE_KPCA_ARGS), rc=out.returncode,
         queries=served and int(served.group(1)),
         requests=served and int(served.group(2)),
         launcher_wall_s=served and float(served.group(4)),
         queries_per_s_wall=served and int(served.group(5)),
         latency=lat and dict(compute_p50=lat.group(1),
                              compute_p99=lat.group(2),
                              queue_wait_p50=lat.group(3),
                              queue_wait_p99=lat.group(4)),
         retries=nums.get("retries"),
         faulted_futures=nums.get("faulted_futures"),
         spans=spans, launches=launches, stdout=text.splitlines(),
         phase_s=wall)
    return launches


def phase_autotune(dev, spec) -> dict:
    """The tile autotuner on the card: with no table, the dispatch is the
    derived one at the smoke's shapes; the CLI's search writes a table
    under build/ (gram: the ring's sweep cross-Gram 20 x 100 x 100 x 784
    and the 2000^2 x 784 self-Gram; project at L500 and L2000 over the
    buckets 8..128; project_partial at the 4-shard slice, L500; centering
    at 2000^2 and 20 x 100^2), each candidate held to the default's output
    before it is timed; the table installed, each op runs once more against
    its plain version at the kernel's gate, a query alone is bitwise its
    row of a B128 slab, and a second CLI run with --assert-cached runs no
    trial. Prints each op's default and chosen knob with both device
    times. The launch counts cover the search and the runs under the
    table."""
    import torch
    from repro_torch.data import kpca_dataset, node_dataset
    from repro_torch.kernels import (autotune, center_op, center_reference,
                                     gram_op, gram_reference,
                                     project_partial_reference,
                                     project_reference)
    from repro_torch.kernels.centering.centering import (center_plan,
                                                         dispatch_plan)
    from repro_torch.kernels.gram.gram import dispatch_rows, tile_rows
    from repro_torch.kernels.project.ops import partial_projector, projector
    from repro_torch.kernels.project.project import (dispatch_slices,
                                                     support_chunking)
    t_phase = time.perf_counter()
    autotune.set_default_table(autotune.TileTable())
    grams = ((20, 100, 100, 784, False), (1, 2000, 2000, 784, True),
             (20, 500, 500, 784, True))
    supports = (("project", 500), ("project", 2000), ("project_partial", 500))
    centers = ((1, 2000, 2000), (20, 100, 100))

    def knobs_now():
        return dict(
            gram={f"{z}x{n}x{k}x{m}" + ("" if sym else " cross"):
                  dispatch_rows(z, n, k, m, sym, torch.float32, dev)
                  for z, n, k, m, sym in grams},
            project={f"{op} L{l}": dispatch_slices(op, l, 784, dev)
                     for op, l in supports},
            centering={"x".join(map(str, c)): str(dispatch_plan(*c, dev))
                       for c in centers})

    default_knobs = knobs_now()
    derived = dict(
        gram={k: tile_rows(z, n, kk, sym) for k, (z, n, kk, m, sym) in zip(
            default_knobs["gram"], grams)},
        project={k: support_chunking(l)[1] for k, (_, l) in zip(
            default_knobs["project"], supports)},
        centering={k: str(center_plan(*c)) for k, c in zip(
            default_knobs["centering"], centers)})
    check(default_knobs == derived, f"autotune: with no table the dispatch "
                                    f"is not the derived one: "
                                    f"{default_knobs} vs {derived}")
    out = ROOT / AUTOTUNE_OUT
    out.unlink(missing_ok=True)
    zero_launches()
    t0 = time.perf_counter()
    records = autotune.main(["--out", str(out), "--k", str(AUTOTUNE_K)])
    torch.cuda.synchronize()
    search_s = time.perf_counter() - t0
    table = autotune.TileTable.load(str(out))
    autotune.set_default_table(table)
    tuned_knobs = knobs_now()
    # each op under the table against its plain version
    nodes, pooled = node_dataset(20, 100, m=784, seed=0)
    x_nodes = torch.as_tensor(nodes, device=dev)
    xs = torch.as_tensor(pooled, device=dev)
    xq = torch.as_tensor(kpca_dataset(128, m=784, seed=3), device=dev)
    g = torch.as_tensor(0.01, device=dev)
    errs = {}
    neigh = torch.roll(x_nodes, 1, dims=0).contiguous()
    errs["gram 20x100x100x784 cross"] = errors(
        gram_op(spec, x_nodes, neigh, gamma=g),
        gram_reference(spec, x_nodes, neigh, gamma=g))
    errs["gram 2000x784"] = errors(gram_op(spec, xs, gamma=g),
                                   gram_reference(spec, xs, gamma=g))
    rng = torch.Generator(device=dev).manual_seed(0)
    slabs = {}
    for op, l in supports:
        coefs = torch.randn((l, 2), generator=rng, device=dev)
        sup = xs[:l].contiguous()
        if op == "project":
            fn = projector(spec, sup, coefs, gamma=g)
            want = project_reference(spec, xq, sup, coefs, gamma=g)
        else:
            ext = torch.cat([coefs, torch.ones((l, 1), device=dev)], 1)
            fn = partial_projector(spec, sup, ext, gamma=g)
            want = project_partial_reference(spec, xq, sup, ext, gamma=g)
        slabs[(op, l)] = (fn, fn(xq))
        errs[f"{op} B128xL{l}"] = errors(slabs[(op, l)][1], want)
    k_big = gram_op(spec, xs, gamma=g)
    k_nodes = gram_op(spec, x_nodes, gamma=g)
    for label, km in (("centering 2000x2000", k_big),
                      ("centering 20x100x100", k_nodes)):
        errs[label] = errors(center_op(km), center_reference(km))
    torch.cuda.synchronize()
    for label, e in errs.items():
        check(e["max_scaled_err"] <= TOL,
              f"autotune: {label} under the tuned table: {e}")
    # batch invariance under the table: each query alone is its slab row
    invariant = {}
    for (op, l), (fn, slab) in slabs.items():
        invariant[f"{op} L{l}"] = all(
            torch.equal(fn(xq[i:i + 1]), slab[i:i + 1]) for i in (0, 63, 127))
    check(all(invariant.values()), f"autotune: a query alone is not its "
                                   f"slab row under the table: {invariant}")
    launches = read_launches("autotune", ("gram", "project", "center"))
    # the second search answers from the table
    try:
        again = autotune.main(["--out", str(out), "--assert-cached"])
        cached_trials = sum(r["trials"] for r in again)
    except SystemExit as e:
        cached_trials, again = str(e), []
    check(cached_trials == 0, f"autotune: --assert-cached ran trials: "
                              f"{cached_trials}")
    autotune.set_default_table(None)
    emit("autotune", table=AUTOTUNE_OUT, entries=len(table),
         backend=autotune.device_backend(dev.index),
         default_knobs=default_knobs, tuned_knobs=tuned_knobs,
         ops=[{k: r[k] for k in ("op", "shape", "default", "default_ms",
                                 "chosen", "chosen_ms", "trials",
                                 "trial_ms")} for r in records],
         rejected=int(autotune._m_rejected.value),
         errors_under_table=errs, batch_invariant=invariant,
         assert_cached_trials=cached_trials, search_s=search_s,
         launches=launches, phase_s=time.perf_counter() - t_phase)
    return launches


def lm_gate(model, params, vocab, dev) -> dict:
    """tests/test_arch_smoke.py's cache check: the logits of 8 tokens fed
    one by one against one prefill of the same 8, at 2e-2 (rtol and atol);
    finite."""
    import numpy as np
    import torch
    rng = np.random.default_rng(0)
    toks = torch.as_tensor(rng.integers(0, vocab, size=(2, 8),
                                        dtype=np.int32), device=dev)
    cache = model.init_cache(2, 16)
    for t in range(8):
        lg, cache = model.decode_step(params, cache, toks[:, t:t + 1], t)
    lg_all, _ = model.decode_step(params, model.init_cache(2, 16), toks, 0)
    a, b = lg_all.float(), lg.float()
    diff = (a - b).abs()
    ok = bool(torch.isfinite(a).all() and torch.isfinite(b).all()
              and (diff <= LM_TOL + LM_TOL * b.abs()).all())
    return dict(ok=ok, max_abs_err=float(diff.max()),
                max_abs_logit=float(b.abs().max()),
                worst_ratio=float((diff / (LM_TOL + LM_TOL * b.abs())).max()))


def lm_prompts(vocab: int):
    import numpy as np
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, size=rng.integers(4, 12)).tolist()
            for _ in range(LM_PROMPTS)]


def record_logits(engine, seen: list) -> None:
    """Keep each sampled step's logits (fp32, on the host)."""
    inner = engine._sample

    def sample(logits):
        seen.append(logits.float().cpu())
        return inner(logits)

    engine._sample = sample


def phase_lm_serve(dev) -> dict:
    """The LM serving half on the card: llama3.2-3b at full width and depth,
    mixtral-8x22b and deepseek-v2-236b at full width cut to 2 layers
    (deepseek's dense first layer and one MoE/MLA layer), bf16 weights
    drawn on the card from a seeded generator: the decode-vs-forward gate
    at 2e-2, DecodeEngine (4 slots, 8 prompts of 4-11 tokens, max_len 64,
    16 greedy new tokens) with tokens/s and the peak memory the model
    allocated, tokens in range; one decode step of the 4 slots traced; the
    MoE models' capacity dispatch against the dense expert loop on the same
    hidden states; then the smoke-size
    llama and mixtral drawn on the CPU, copied to the card, and decoded on
    both: the greedy tokens and the logits (2e-2) compared. None of the
    four kernels runs on this path."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.common import slice_layer
    from repro_torch.models.moe import moe_forward, moe_forward_ref
    from repro_torch.serve import DecodeEngine, ServeConfig
    t_phase = time.perf_counter()
    zero_launches()
    serve_cfg = ServeConfig(max_len=LM_MAX_LEN, max_new_tokens=LM_NEW)
    full = {}
    for name, layers in LM_FULL:
        cfg = get_config(name)
        if layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        model = build_model(cfg, device=dev)
        t0 = time.perf_counter()
        params, _ = model.init(0)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = sum(p.numel() for p in params.values())
        weight_bytes = sum(p.numel() * p.element_size()
                           for p in params.values())
        with torch.inference_mode():
            gate = lm_gate(model, params, cfg.vocab, dev)
        check(gate["ok"], f"lm_serve {name}: decode vs forward {gate}")
        engine = DecodeEngine(model, params, LM_SLOTS, serve_cfg)
        prompts = lm_prompts(cfg.vocab)
        engine.generate(prompts[:LM_SLOTS])           # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = engine.generate(prompts)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        n_tok = sum(len(o) for o in outs)
        check(n_tok == LM_PROMPTS * LM_NEW and all(
            0 <= t < cfg.vocab for o in outs for t in o),
            f"lm_serve {name}: {n_tok} tokens, or a token out of range")
        # one decode step of the 4 slots at cache length 16, traced; the
        # bound reads every weight once
        cache = model.init_cache(LM_SLOTS, LM_MAX_LEN)
        tok = torch.zeros((LM_SLOTS, 1), dtype=torch.int32, device=dev)
        with torch.inference_mode():
            step = phase_breakdown(torch, lambda: model.decode_step(
                params, cache, tok, 16))
        step["bound_ms"] = weight_bytes / PEAK_BYTES * 1e3
        del cache
        moe = None
        if cfg.is_moe:
            mp = slice_layer(params, "layers")
            mp = {k[len("moe/"):]: v[0] for k, v in mp.items()
                  if k.startswith("moe/")}
            hx = torch.randn((2, 8, cfg.d_model), device=dev,
                             generator=torch.Generator(device=dev)
                             .manual_seed(1)).to(torch.bfloat16)
            with torch.inference_mode():
                y, _ = moe_forward(mp, cfg, hx)
                y_ref, _ = moe_forward_ref(mp, cfg, hx)
            d = (y.float() - y_ref.float()).abs()
            moe = dict(max_abs_err=float(d.max()),
                       max_abs=float(y_ref.float().abs().max()))
            check(bool((d <= LM_TOL + LM_TOL * y_ref.float().abs()).all()),
                  f"lm_serve {name}: MoE dispatch vs dense loop {moe}")
        full[name] = dict(
            layers=cfg.n_layers, d_model=cfg.d_model, vocab=cfg.vocab,
            params=n_params, weight_gb=weight_bytes / 1e9, init_s=init_s,
            decode_vs_forward=gate, tokens=n_tok, generate_s=gen_s,
            tokens_per_s=n_tok / gen_s, decode_step=step,
            peak_alloc_gb=(torch.cuda.max_memory_allocated() - base) / 1e9,
            moe_dispatch_vs_ref=moe, first_tokens=outs[0][:8])
        del engine, params, model
    torch.cuda.empty_cache()
    # smoke size: the same weights on the CPU and on the card
    smoke = {}
    for name in LM_SMOKE:
        cfg = get_config(name, smoke=True)
        cpu_model = build_model(cfg, device="cpu")
        params, _ = cpu_model.init(0)
        card_model = build_model(cfg, device=dev)
        card_params = {k: v.to(dev) for k, v in params.items()}
        seen, outs = {}, {}
        for side, model, p in (("cpu", cpu_model, params),
                               ("card", card_model, card_params)):
            eng = DecodeEngine(model, p, LM_SLOTS, serve_cfg)
            record_logits(eng, seen.setdefault(side, []))
            outs[side] = eng.generate(lm_prompts(cfg.vocab))
        max_err, first_diff = 0.0, None
        for i, (a, b) in enumerate(zip(seen["cpu"], seen["card"])):
            max_err = max(max_err, float((a - b).abs().max()))
            if first_diff is None and not torch.equal(a.argmax(-1),
                                                      b.argmax(-1)):
                first_diff = i
                break
        same = outs["cpu"] == outs["card"]
        smoke[name] = dict(tokens_equal=same, logits_max_abs_err=max_err,
                           first_differing_step=first_diff,
                           prompts_equal=sum(a == b for a, b in zip(
                               outs["cpu"], outs["card"])))
        check(same and max_err <= LM_TOL,
              f"lm_serve {name} smoke: card against CPU {smoke[name]}")
    launches = read_launches("lm_serve", ())
    check(not any(launches.values()),
          f"lm_serve: the LM path launched a kPCA kernel: {launches}")
    emit("lm_serve", full=full, smoke_card_vs_cpu=smoke, tolerance=LM_TOL,
         launches=launches, phase_s=time.perf_counter() - t_phase)
    return launches


def rel_close(got: float, want: float, tol: float) -> bool:
    return math.isfinite(got) and abs(got - want) <= tol * abs(want)


def params_within(got: dict, want: dict, tol: float) -> tuple:
    """(all within tol * max|p| of each tensor, the worst ratio)."""
    worst = 0.0
    for k, w in want.items():
        w = w.float().cpu()
        d = float((got[k].float().cpu() - w).abs().max())
        worst = max(worst, d / max(float(w.abs().max()), 1e-30))
    return worst <= tol, worst


def same_state(a: dict, b: dict) -> bool:
    import torch
    return all(torch.equal(a[g][k].cpu(), b[g][k].cpu())
               for g in ("params", "m", "v") for k in a[g]) \
        and int(a["step"]) == int(b["step"])


def timed_step(torch, step_fn, state, batch) -> dict:
    """One step on the host clock, synchronised at both ends, and the peak
    allocation above what was held before it."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    step_fn(state, batch)
    torch.cuda.synchronize()
    return dict(s=time.perf_counter() - t0,
                peak_above_state_gb=(torch.cuda.max_memory_allocated()
                                     - held) / 1e9)


def select_slices(stacked):
    """Layers sliced by a select per layer (``v[i]``): what
    ``common.layer_slices`` replaced, for the unbind-vs-select timing."""
    from repro_torch.models.common import n_stacked
    return [{k: v[i] for k, v in stacked.items()}
            for i in range(n_stacked(stacked))]


def probe_fit(acts, spec, dev, alpha0=None):
    """The probe's single-device branch on pooled activations (J=3, N=32,
    ring(3, 1)): (setup, result)."""
    from repro_torch.core import RhoSchedule, build_setup, ring, run_admm
    j = PROBE_BATCH // PROBE_NODE
    x_nodes = acts[: j * PROBE_NODE].reshape(j, PROBE_NODE, -1)
    setup = build_setup(x_nodes, ring(j, hops=1), spec, device=dev)
    return setup, run_admm(setup, n_iters=PROBE_ITERS, rho2=RhoSchedule(),
                           alpha0=alpha0)


def probe_rerun(params, probe_batch, probe, spec, dev) -> dict:
    """The probe's code once more on the card (its outputs must be
    ``probe``'s) and on the CPU from the card's alpha0 (alpha within
    PROBE_TOL max|alpha|): the card run equal, the CPU's alpha error, the
    card's max|alpha|. Launches the kernels (after the path's count)."""
    import torch
    from repro_torch.core import initial_alpha
    from repro_torch.train.probes import pooled_activations
    acts = pooled_activations(params, probe_batch["tokens"])
    setup, res = probe_fit(acts, spec, dev)
    energy = torch.linalg.norm(res.alpha, dim=1)
    again = dict(consensus_residual=float(res.primal_residual[-1]),
                 participation_mean=float(torch.mean(energy)),
                 participation_cv=float(
                     torch.std(energy, unbiased=False)
                     / torch.clamp(torch.mean(energy), min=1e-9)))
    alpha0 = initial_alpha(setup, "local")
    _, res_cpu = probe_fit(acts.cpu(), spec, "cpu", alpha0=alpha0.cpu())
    out = dict(card_rerun_equal=all(probe.get(k) == v
                                    for k, v in again.items()),
               alpha_cpu_err=float((res_cpu.alpha - res.alpha.cpu())
                                   .abs().max()),
               alpha_max_abs=float(res.alpha.abs().max()),
               features=acts.shape[-1])
    check(out["card_rerun_equal"]
          and out["alpha_cpu_err"] <= PROBE_TOL * out["alpha_max_abs"],
          f"probe on the card's params: outputs {probe} vs the card run "
          f"{again}; {out} (gate {PROBE_TOL} x max|alpha|)")
    return out


def smoke_steps_card_vs_cpu(cfg, dev, frames: int = 0) -> dict:
    """TRAIN_SMOKE_STEPS fp32 AdamW steps of ``cfg`` (cosine_with_warmup(1,
    TRAIN_SMOKE_STEPS)) from the same CPU-drawn weights and stream on the
    CPU and the card: {side: (losses, final params)}, and under "init" the
    weights both started from."""
    import torch
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig, adamw_init, cosine_with_warmup
    from repro_torch.train import build_train_step
    opt = AdamWConfig(schedule=cosine_with_warmup(1, TRAIN_SMOKE_STEPS))
    weights, _ = build_model(cfg, device="cpu").init(0)
    runs = {}
    for side, d in (("cpu", torch.device("cpu")), ("card", dev)):
        _, step_fn = build_train_step(build_model(cfg, device=d), opt)
        params = {k: v.clone().to(d) for k, v in weights.items()}
        state = dict(params=params, **adamw_init(params))
        data = family_stream(cfg, TRAIN_BATCH, 32, 0, d, frames)
        runs[side] = ([float(step_fn(state, data.next_batch())[1]["loss"])
                       for _ in range(TRAIN_SMOKE_STEPS)], state["params"])
    runs["init"] = weights
    return runs


def train_smoke_checks(dev) -> dict:
    """The smoke-size checks of lm_train (card against CPU, resume, the
    async checkpoint, remat); none of them launches a kPCA kernel."""
    import dataclasses
    import torch
    from repro_torch.checkpoint import (latest_step, restore_checkpoint,
                                        save_checkpoint_async)
    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream
    from repro_torch.models import build_model
    from repro_torch.optim import (AdamWConfig, cosine_with_warmup,
                                   global_norm)
    from repro_torch.train import TrainConfig, train
    from repro_torch.train.loop import (_flatten_state, _unflatten_state,
                                        loss_and_grads)
    out = {}
    # fp32 llama3.2-3b-smoke, 8 steps from the same weights on both sides
    runs = smoke_steps_card_vs_cpu(fp32(get_config(TRAIN_ARCH, smoke=True)),
                                   dev)
    opt = AdamWConfig(schedule=cosine_with_warmup(1, TRAIN_SMOKE_STEPS))
    loss_ok = all(rel_close(a, b, TRAIN_SMOKE_TOL)
                  for a, b in zip(runs["card"][0], runs["cpu"][0]))
    p_ok, worst = params_within(runs["card"][1], runs["cpu"][1],
                                TRAIN_SMOKE_TOL)
    out["fp32_card_vs_cpu"] = dict(
        steps=TRAIN_SMOKE_STEPS, losses_card=runs["card"][0],
        losses_cpu=runs["cpu"][0],
        max_rel_loss_err=max(abs(a - b) / abs(b) for a, b in zip(
            runs["card"][0], runs["cpu"][0])),
        max_param_err_over_max_abs=worst)
    check(loss_ok and p_ok, f"lm_train smoke fp32: card against CPU "
                            f"{out['fp32_card_vs_cpu']}")
    # bf16 MoE smoke configs: one step's loss and grad norm
    moe = {}
    for name in TRAIN_MOE:
        mcfg = get_config(name, smoke=True)
        w, _ = build_model(mcfg, device="cpu").init(0)
        got = {}
        for side, d in (("cpu", torch.device("cpu")), ("card", dev)):
            model = build_model(mcfg, device=d)
            batch = TokenStream(mcfg.vocab, 2, 32, seed=0,
                                device=str(d)).next_batch()
            loss, _, grads = loss_and_grads(
                model, {k: v.to(d) for k, v in w.items()}, batch)
            got[side] = (float(loss), float(global_norm(grads)))
        moe[name] = dict(loss=got, ok=all(
            math.isfinite(c) and abs(c - w) <= LM_TOL * (1 + abs(w))
            for c, w in zip(got["card"], got["cpu"])))
        check(moe[name]["ok"], f"lm_train {name} smoke: card against CPU "
                               f"{moe[name]}")
    out["moe_one_step"] = moe
    # resume on the card: 8 straight steps against 4 + checkpoint + 4
    scfg = get_config(TRAIN_ARCH, smoke=True)
    model = build_model(scfg, device=dev)
    tcfg = lambda steps, d: TrainConfig(steps=steps, ckpt_dir=d,
                                        ckpt_every=4, log_every=0)
    stream = lambda: TokenStream(scfg.vocab, TRAIN_BATCH, 32, seed=0,
                                 device=str(dev))
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        straight, hs = train(model, opt, stream(), tcfg(8, f"{tmp}/a"))
        train(model, opt, stream(), tcfg(4, f"{tmp}/b"))
        data = stream()
        resumed, hr = train(model, opt, data, tcfg(8, f"{tmp}/b"))
        resume_ok = (hs["loss"][4:] == hr["loss"] and data.step == 8
                     and same_state(straight, resumed))
        out["resume"] = dict(bitwise=resume_ok, losses=hs["loss"],
                             resumed_losses=hr["loss"])
        check(resume_ok, f"lm_train resume: {out['resume']}")
        # the async checkpoint: a snapshot, found by latest_step
        flat = _flatten_state(resumed)
        th = save_checkpoint_async(f"{tmp}/c", 8, flat,
                                   metadata={"data_state": data.state()})
        snap = {k: v.clone() for k, v in resumed["params"].items()}
        for v in resumed["params"].values():
            v.add_(1)                     # training goes on in place
        th.join(timeout=120)
        back, meta, step = restore_checkpoint(f"{tmp}/c")
        back = _unflatten_state(back, device=dev)
        async_ok = (not th.is_alive() and latest_step(f"{tmp}/c") == 8
                    and step == 8 and meta["data_state"]["step"] == 8
                    and all(torch.equal(back["params"][k], v)
                            for k, v in snap.items()))
        out["async_checkpoint"] = dict(ok=async_ok, step=step)
        check(async_ok, "lm_train: save_checkpoint_async's step is missing "
                        "or not the snapshot")
    # remat "none", "full", "dots": the same grads on the card, bitwise
    batch = TokenStream(scfg.vocab, TRAIN_BATCH, 32, seed=3,
                        device=str(dev)).next_batch()
    w, _ = model.init(1)
    grads = {r: loss_and_grads(build_model(dataclasses.replace(
        scfg, remat=r), device=dev), w, batch)[2]
        for r in ("none", "full", "dots")}
    remat_ok = all(torch.equal(grads[r][k], grads["none"][k])
                   for r in ("full", "dots") for k in w)
    out["remat_bitwise"] = remat_ok
    check(remat_ok, "lm_train: remat modes give different grads")
    return out


def phase_lm_train(dev, spec) -> dict:
    """The LM training half on the card (see the module docstring): the
    full-width train() and the probe are the path whose launches count; the
    checks after the count launch nothing the count needs."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream
    from repro_torch.models import build_model
    from repro_torch.models import common as mcommon
    from repro_torch.optim import AdamWConfig, cosine_with_warmup
    from repro_torch.train import TrainConfig, activation_probe, train
    from repro_torch.train.loop import build_train_step
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    cfg = get_config(TRAIN_ARCH)
    model = build_model(cfg, device=dev)
    opt = AdamWConfig(schedule=cosine_with_warmup(1, TRAIN_STEPS))
    data = TokenStream(cfg.vocab, TRAIN_BATCH, TRAIN_SEQ, seed=0,
                       device=str(dev))
    probe_batch = TokenStream(cfg.vocab, PROBE_BATCH, PROBE_SEQ, seed=1,
                              device=str(dev)).next_batch()
    zero_launches()
    t0 = time.perf_counter()
    state, hist = train(model, opt, data,
                        TrainConfig(steps=TRAIN_STEPS, log_every=0))
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    # what lm_train_mesh is held to, before anything else moves the state
    ref = dict(losses=hist["loss"], sums=leaf_checksums(state), peak=peak,
               state_bytes=nbytes(t for g in ("params", "m", "v")
                                  for t in state[g].values())
               + nbytes([state["step"]]),
               first=hist["step_time"][0],
               warm=sorted(hist["step_time"][1:])[
                   len(hist["step_time"][1:]) // 2])
    run_probe = lambda: activation_probe(state["params"], probe_batch,
                                         n_iters=PROBE_ITERS,
                                         samples_per_node=PROBE_NODE)
    t0 = time.perf_counter()
    probe = run_probe()
    torch.cuda.synchronize()
    probe_s = time.perf_counter() - t0
    launches = read_launches("lm_train", ("gram", "admm_step"))
    n_params = sum(p.numel() for p in state["params"].values())
    losses = hist["loss"]
    first_ok = abs(losses[0] - math.log(cfg.vocab)) < TRAIN_FIRST_LOSS_SLACK
    check(all(math.isfinite(x) for x in losses) and first_ok
          and not any(hist["skipped"]),
          f"lm_train {TRAIN_ARCH}: losses {losses} (ln V "
          f"{math.log(cfg.vocab):.4f}), skipped {hist['skipped']}")
    check(not probe["skipped"] and all(
        math.isfinite(v) for k, v in probe.items() if k != "skipped"),
        f"lm_train probe: {probe}")
    # the probe's code once more on the card: the same outputs; the CPU
    # from the card's alpha0 within PROBE_TOL max|alpha|
    rerun = probe_rerun(state["params"], probe_batch, probe, spec, dev)
    _, probe_wall, probe_trace = timed_and_traced(torch, run_probe)
    # one warm step traced; then a select per layer against one unbind
    # per stack, in turns: unbind, select, select, unbind (warm)
    _, step_fn = build_train_step(model, opt)
    batch = data.next_batch()
    _, wall, trace = timed_and_traced(torch, lambda: step_fn(state, batch))
    slicing = {"unbind": [], "select": []}
    for kind in ("unbind", "select", "select", "unbind"):
        orig = mcommon.layer_slices
        if kind == "select":
            mcommon.layer_slices = select_slices
        try:
            slicing[kind].append(timed_step(torch, step_fn, state, batch))
        finally:
            mcommon.layer_slices = orig
    warm = sorted(hist["step_time"][1:])[len(hist["step_time"][1:]) // 2]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    full = dict(
        arch=TRAIN_ARCH, layers=cfg.n_layers, d_model=cfg.d_model,
        vocab=cfg.vocab, params=n_params, remat=cfg.remat,
        batch=TRAIN_BATCH, seq=TRAIN_SEQ, steps=TRAIN_STEPS,
        losses=losses, ln_vocab=math.log(cfg.vocab),
        skipped=hist["skipped"], train_s=train_s,
        first_step_s=hist["step_time"][0], warm_step_s_median=warm,
        tokens_per_s=tokens / warm, peak_alloc_gb=peak,
        state_gb=sum(t.numel() * t.element_size()
                     for g in ("params", "m", "v")
                     for t in state[g].values()) / 1e9,
        warm_step=dict(wall_s=wall, tokens_per_s=tokens / wall, **trace),
        layer_slicing=slicing)
    del state
    torch.cuda.empty_cache()
    smoke = train_smoke_checks(dev)
    emit("lm_train", full=full,
         probe=dict(out=probe, first_s=probe_s,
                    warm=dict(wall_s=probe_wall, **probe_trace),
                    tolerance=PROBE_TOL, nodes=PROBE_BATCH // PROBE_NODE,
                    per_node=PROBE_NODE, iterations=PROBE_ITERS, **rerun),
         smoke=smoke, launches=launches,
         phase_s=time.perf_counter() - t_phase)
    return launches, ref


class FramesStream:
    """A TokenStream's batches with seamless's frame-embedding stub added:
    (batch, frames, d_model) fp32 draws from a seeded numpy generator (the
    JAX package's concrete_train_batch draws its frames so)."""

    def __init__(self, tokens, cfg, frames: int, seed: int, dev):
        import numpy as np
        self.tokens, self.dev = tokens, dev
        self.shape = (tokens.batch, frames, cfg.d_model)
        self.rng = np.random.default_rng(seed)

    def next_batch(self):
        import numpy as np
        import torch
        b = self.tokens.next_batch()
        b["frames"] = torch.as_tensor(self.rng.normal(
            0, 0.02, size=self.shape).astype(np.float32), device=self.dev)
        return b


def family_stream(cfg, batch: int, seq: int, seed: int, dev, frames: int):
    """The training stream of ``cfg``: TokenStream, with frames for
    audio."""
    from repro_torch.data import TokenStream
    tokens = TokenStream(cfg.vocab, batch, seq, seed=seed, device=str(dev))
    if cfg.family != "audio":
        return tokens
    return FramesStream(tokens, cfg, frames, seed, dev)


def family_gate(model, params, cfg, dev) -> tuple:
    """Decode against prefill: ``model.prefill`` (the chunked scan; for
    audio the encoder and the prompt in one step) of 8 tokens against the
    same 8 fed one by one through ``decode_step`` (for audio from a cache
    whose enc_out is set as encdec_prefill sets it), last-token logits at
    2e-2 (rtol and atol); finite. Returns (the record, the prefill's and
    the decode's logits in fp32). ``serve_family`` gates this in bf16 for
    seamless and on the weights widened to fp32 for all three; for
    falcon-mamba and zamba2 in bf16 through 64 and 38 layers of random
    weights the two computations' roundings grow past 2e-2, as the
    reference's do (the JAX package's own bf16 gap is 0.418 for a 64 x 256
    falcon-mamba and 0.249 for a 38 x 256 zamba2 on the CPU:
    scripts/family_bf16_gap.py), so there each bf16 path is held to the
    fp32 prefill instead (see ``serve_family``)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(0)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, size=(2, 8),
                                        dtype=np.int32), device=dev)
    batch = {"tokens": toks}
    cache = model.init_cache(2, 16)
    if cfg.family == "audio":
        from repro_torch.models.encdec import _encode
        batch["frames"] = torch.as_tensor(rng.normal(0, 0.02, size=(
            2, FAM_FRAMES, cfg.d_model)).astype(np.float32), device=dev)
        cache = cache._replace(enc_out=_encode(
            params, cfg, batch["frames"]).to(cache.enc_out.dtype))
    pre, _ = model.prefill(params, batch, 16)
    for t in range(8):
        lg, cache = model.decode_step(params, cache, toks[:, t:t + 1], t)
    a, b = pre.float(), lg.float()
    diff = (a - b).abs()
    ok = bool(torch.isfinite(a).all() and torch.isfinite(b).all()
              and (diff <= LM_TOL + LM_TOL * b.abs()).all())
    return dict(within_tol=ok, max_abs_err=float(diff.max()),
                max_abs_logit=float(b.abs().max()),
                worst_ratio=float((diff / (LM_TOL + LM_TOL * b.abs())).max())
                ), a, b


def greedy_audio(model, params, batch, steps: int, max_len: int):
    """seamless's serving loop: prefill (frames and prompt), then ``steps``
    greedy decode steps. Returns (tokens (B, steps + 1) on the host, each
    step's logits (fp32, host), the last cache)."""
    import torch
    logits, cache = model.prefill(params, batch, max_len)
    plen = batch["tokens"].shape[1]
    toks, seen = [], [logits.float().cpu()]
    for i in range(steps):
        nxt = torch.argmax(logits.float(), dim=-1)
        toks.append(nxt)
        logits, cache = model.decode_step(params, cache,
                                          nxt[:, None].to(torch.int32),
                                          plen + i)
        seen.append(logits.float().cpu())
    toks.append(torch.argmax(logits.float(), dim=-1))
    return torch.stack(toks, 1).cpu(), seen, cache


def decode_bytes(params, cfg) -> float:
    """The bytes one decode step must read: every weight but the
    encoder's, and for audio the encoder output once for each decoder
    layer's K and V."""
    n = sum(p.numel() * p.element_size() for k, p in params.items()
            if not k.startswith(("enc/", "enc_norm")))
    if cfg.family == "audio":
        n += 2 * cfg.n_layers * LM_SLOTS * FAM_FRAMES * cfg.d_model * 2
    return n


def serve_family(name: str, dev) -> tuple:
    """One family's serving checks at full width and depth (bf16 weights
    drawn on the card from seed 0): the init's peak, the decode-vs-prefill
    gate, for falcon a forward loss at 4 x 128 tokens, DecodeEngine (4
    slots, 8 prompts, 16 greedy new tokens; for seamless a prefill of
    512 frames and an 8-token prompt and 16 greedy steps), one decode step
    traced beside the time to read its weights once; then the decode
    against prefill gate on the weights widened to fp32 (see family_gate),
    and the bf16 gates: seamless's decode against prefill at 2e-2, and for
    falcon-mamba and zamba2 the bf16 decode's relative L2 distance from
    the fp32 prefill within FAM_BF16_RATIO times the bf16 prefill's own
    (+ 1e-3). Returns the record."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream
    from repro_torch.models import build_model
    from repro_torch.serve import DecodeEngine, ServeConfig
    cfg = get_config(name)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    model = build_model(cfg, device=dev)
    t0 = time.perf_counter()
    params, _ = model.init(0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    torch.cuda.reset_peak_memory_stats()
    weight_bytes = sum(p.numel() * p.element_size() for p in params.values())
    rec = dict(layers=cfg.n_layers, d_model=cfg.d_model, vocab=cfg.vocab,
               params=sum(p.numel() for p in params.values()),
               weight_gb=weight_bytes / 1e9, init_s=init_s,
               init_peak_alloc_gb=init_peak)
    with torch.inference_mode():
        rec16, pre16, dec16 = family_gate(model, params, cfg, dev)
        rec["decode_vs_prefill_bf16"] = rec16
        if cfg.family == "ssm":
            batch = TokenStream(cfg.vocab, TRAIN_BATCH, TRAIN_SEQ, seed=0,
                                device=str(dev)).next_batch()
            loss = float(model.loss(params, batch)[1]["loss"])
            rec["forward_loss"] = dict(loss=loss, ln_vocab=math.log(
                cfg.vocab), batch=TRAIN_BATCH, seq=TRAIN_SEQ)
            check(math.isfinite(loss) and abs(loss - math.log(cfg.vocab))
                  < TRAIN_FIRST_LOSS_SLACK,
                  f"lm_families {name}: forward loss {loss}")
    if cfg.family == "audio":
        rng = np.random.default_rng(0)
        batch = {"tokens": torch.as_tensor(rng.integers(
            0, cfg.vocab, size=(LM_SLOTS, FAM_PROMPT), dtype=np.int32),
            device=dev), "frames": torch.as_tensor(rng.normal(
                0, 0.02, size=(LM_SLOTS, FAM_FRAMES, cfg.d_model))
                .astype(np.float32), device=dev)}
        with torch.inference_mode():
            greedy_audio(model, params, batch, 2, LM_MAX_LEN)     # warm
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            toks, _, cache = greedy_audio(model, params, batch, LM_NEW,
                                          LM_MAX_LEN)
            torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        n_tok = LM_SLOTS * LM_NEW
        first = toks[0, :8].tolist()
        ok = bool(((toks >= 0) & (toks < cfg.vocab)).all())
        step_at, tok = FAM_PROMPT + LM_NEW, toks[:, -1:].to(dev).to(
            torch.int32)
    else:
        engine = DecodeEngine(model, params, LM_SLOTS, ServeConfig(
            max_len=LM_MAX_LEN, max_new_tokens=LM_NEW))
        prompts = lm_prompts(cfg.vocab)
        engine.generate(prompts[:LM_SLOTS])           # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = engine.generate(prompts)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        n_tok = sum(len(o) for o in outs)
        first = outs[0][:8]
        ok = n_tok == LM_PROMPTS * LM_NEW and all(
            0 <= t < cfg.vocab for o in outs for t in o)
        cache = model.init_cache(LM_SLOTS, LM_MAX_LEN)
        step_at = 16
        tok = torch.zeros((LM_SLOTS, 1), dtype=torch.int32, device=dev)
    check(ok, f"lm_families {name}: {n_tok} tokens, or one out of range")
    with torch.inference_mode():
        step = phase_breakdown(torch, lambda: model.decode_step(
            params, cache, tok, step_at))
    step["bound_ms"] = decode_bytes(params, cfg) / PEAK_BYTES * 1e3
    del cache
    rec.update(tokens=n_tok, generate_s=gen_s, tokens_per_s=n_tok / gen_s,
               decode_step=step, serve_peak_alloc_gb=(
                   torch.cuda.max_memory_allocated() - base) / 1e9,
               first_tokens=first)
    # the gate: the same weights widened to fp32
    c32 = dataclasses.replace(cfg, param_dtype="float32",
                              compute_dtype="float32")
    for k in list(params):
        params[k] = params.pop(k).float()
    with torch.inference_mode():
        gate, pre32, _ = family_gate(build_model(c32, device=dev), params,
                                     c32, dev)
    check(gate["within_tol"], f"lm_families {name}: decode vs prefill "
                              f"(fp32) {gate}")
    rec["decode_vs_prefill_fp32"] = gate
    if cfg.family == "audio":
        check(rec16["within_tol"], f"lm_families {name}: decode vs prefill "
                                   f"(bf16) {rec16}")
    else:
        # each bf16 path's relative L2 distance from the fp32 prefill: the
        # token-by-token decode within FAM_BF16_RATIO of the chunked
        # prefill's own (the CPU test's rule for the port against the
        # reference; the reference's decode reads 0.76 and 1.01 of its
        # prefill's at 64 x 256 and 38 x 256, scripts/family_bf16_gap.py,
        # and the port's decode with its state rounded to bf16 each step
        # reads 1.39 there)
        e_p, e_d = (float(torch.linalg.norm(t - pre32)
                          / torch.linalg.norm(pre32)) for t in (pre16, dec16))
        rec16.update(prefill_vs_fp32=e_p, decode_vs_fp32=e_d,
                     decode_over_prefill=e_d / e_p,
                     gate=f"decode_vs_fp32 <= {FAM_BF16_RATIO} x "
                          f"prefill_vs_fp32 + 1e-3")
        check(e_d <= FAM_BF16_RATIO * e_p + 1e-3,
              f"lm_families {name}: bf16 decode's error {rec16}")
    del params, model
    torch.cuda.empty_cache()
    return rec


def train_family(name: str, dev, spec) -> tuple:
    """train() at full width and depth: 6 AdamW steps (lr 3e-4,
    cosine_with_warmup(1, 6)) of 4 x 128 tokens (seamless: and 512
    frames), remat "full"; every loss finite, the first within 2.5 of
    ln V, no step skipped; then the probe on the trained params (J=3 nodes
    of N=32 pooled activations): exactly 2 gram and 8 admm_step launches,
    its outputs the card run's of the same code, the CPU's alpha from the
    card's alpha0 within 2e-4 max|alpha|. Returns (the record, the
    launches of train() and the probe)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig, cosine_with_warmup
    from repro_torch.train import TrainConfig, activation_probe, train
    cfg = get_config(name)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    model = build_model(cfg, device=dev)
    opt = AdamWConfig(schedule=cosine_with_warmup(1, TRAIN_STEPS))
    data = family_stream(cfg, TRAIN_BATCH, TRAIN_SEQ, 0, dev, FAM_FRAMES)
    probe_batch = TokenStream(cfg.vocab, PROBE_BATCH, PROBE_SEQ, seed=1,
                              device=str(dev)).next_batch()
    zero_launches()
    t0 = time.perf_counter()
    state, hist = train(model, opt, data,
                        TrainConfig(steps=TRAIN_STEPS, log_every=0))
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    probe = activation_probe(state["params"], probe_batch,
                             n_iters=PROBE_ITERS,
                             samples_per_node=PROBE_NODE)
    torch.cuda.synchronize()
    launches = read_launches(f"lm_families {name}", ("gram", "admm_step"))
    check(launches["gram"] == 2 and launches["admm_step"] == PROBE_ITERS,
          f"lm_families {name}: the probe launched gram "
          f"{launches['gram']} (2), admm_step {launches['admm_step']} "
          f"({PROBE_ITERS})")
    losses = hist["loss"]
    check(all(math.isfinite(x) for x in losses)
          and abs(losses[0] - math.log(cfg.vocab)) < TRAIN_FIRST_LOSS_SLACK
          and not any(hist["skipped"]),
          f"lm_families {name}: losses {losses} (ln V "
          f"{math.log(cfg.vocab):.4f}), skipped {hist['skipped']}")
    check(not probe["skipped"] and all(
        math.isfinite(v) for k, v in probe.items() if k != "skipped"),
        f"lm_families {name} probe: {probe}")
    rerun = probe_rerun(state["params"], probe_batch, probe, spec, dev)
    steps = hist["step_time"]
    warm = sorted(steps[1:])[len(steps[1:]) // 2]
    rec = dict(batch=TRAIN_BATCH, seq=TRAIN_SEQ, steps=TRAIN_STEPS,
               frames=FAM_FRAMES if cfg.family == "audio" else None,
               remat=cfg.remat, losses=losses, ln_vocab=math.log(cfg.vocab),
               skipped=hist["skipped"], train_s=train_s,
               step_s=steps, first_step_s=steps[0], warm_step_s_median=warm,
               tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / warm,
               peak_alloc_gb=peak,
               state_gb=sum(t.numel() * t.element_size()
                            for g in ("params", "m", "v")
                            for t in state[g].values()) / 1e9,
               probe=dict(out=probe, launches=launches, **rerun))
    del state
    torch.cuda.empty_cache()
    return rec, launches


def family_smoke_checks(dev) -> dict:
    """The smoke configs of the three families, card against CPU from the
    same weights: fp32 training for 8 steps (losses within 1e-4 relative;
    params within 1e-4 max|p| of each tensor, and for the leaves drawn as
    zeros (a_log, dt_bias, conv_b), which hold only Adam's normalized
    steps of about lr each, within 1e-4 max(1, max|p|): an element whose
    gradient cancels to near Adam's eps moves with its gradient's rounding,
    shown leaf by leaf by scripts/family_smoke_gap.py; each side's worst
    ratio to its own max|p| is recorded), and bf16 greedy decoding (falcon
    and zamba2 through DecodeEngine on lm_prompts, seamless by prefill of
    frames and a prompt and 16 greedy steps): the same tokens, every
    step's logits within 2e-2."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serve import DecodeEngine, ServeConfig
    out = {}
    for name in FAM_FULL:
        cfg = get_config(name, smoke=True)
        runs = smoke_steps_card_vs_cpu(fp32(cfg), dev, cfg.enc_seq)
        worst = {"drawn": (0.0, ""), "zeros": (0.0, "")}
        zeros_max1, p_ok = 0.0, True
        for k, w in runs["cpu"][1].items():
            d = float((runs["card"][1][k].cpu() - w).abs().max())
            top = float(w.abs().max())
            kind = "drawn" if bool(runs["init"][k].any()) else "zeros"
            ratio = d / max(top, 1e-30)
            worst[kind] = max(worst[kind], (ratio, k))
            if kind == "zeros":
                zeros_max1 = max(zeros_max1, d / max(1.0, top))
                p_ok &= d <= TRAIN_SMOKE_TOL * max(1.0, top)
            else:
                p_ok &= d <= TRAIN_SMOKE_TOL * top
        rel = max(abs(a - b) / abs(b) for a, b in zip(runs["card"][0],
                                                      runs["cpu"][0]))
        train_rec = dict(losses_card=runs["card"][0],
                         losses_cpu=runs["cpu"][0], max_rel_loss_err=rel,
                         drawn_max_param_err_over_max_abs=worst["drawn"],
                         zeros_max_param_err_over_max_abs=worst["zeros"],
                         zeros_max_param_err_over_max1_abs=zeros_max1)
        check(rel <= TRAIN_SMOKE_TOL and p_ok,
              f"lm_families {name} smoke fp32: card against CPU {train_rec}")
        # bf16 decoding
        params, _ = build_model(cfg, device="cpu").init(0)
        seen, toks = {}, {}
        for side, d in (("cpu", torch.device("cpu")), ("card", dev)):
            model = build_model(cfg, device=d)
            p = {k: v.to(d) for k, v in params.items()}
            if cfg.family == "audio":
                rng = np.random.default_rng(0)
                batch = {"tokens": torch.as_tensor(rng.integers(
                    0, cfg.vocab, size=(LM_SLOTS, FAM_PROMPT),
                    dtype=np.int32), device=d),
                    "frames": torch.as_tensor(rng.normal(0, 0.02, size=(
                        LM_SLOTS, cfg.enc_seq, cfg.d_model)).astype(
                            np.float32), device=d)}
                t, seen[side], _ = greedy_audio(model, p, batch, LM_NEW,
                                                LM_MAX_LEN)
                toks[side] = t.tolist()
            else:
                eng = DecodeEngine(model, p, LM_SLOTS, ServeConfig(
                    max_len=LM_MAX_LEN, max_new_tokens=LM_NEW))
                record_logits(eng, seen.setdefault(side, []))
                toks[side] = eng.generate(lm_prompts(cfg.vocab))
        max_err = max(float((a - b).abs().max())
                      for a, b in zip(seen["cpu"], seen["card"]))
        rel_l2 = max(float(torch.linalg.norm(a - b) / torch.linalg.norm(a))
                     for a, b in zip(seen["cpu"], seen["card"]))
        same = toks["cpu"] == toks["card"]
        dec_rec = dict(tokens_equal=same, logits_max_abs_err=max_err,
                       logits_max_rel_l2=rel_l2, steps=len(seen["cpu"]))
        check(same and max_err <= LM_TOL,
              f"lm_families {name} smoke bf16: card against CPU {dec_rec}")
        out[name] = dict(fp32_train=train_rec, bf16_decode=dec_rec)
    return out


def phase_lm_families(dev, spec) -> dict:
    """The ssm, hybrid and audio families on the card (see the module
    docstring). The path whose launches count is each trained family's
    train() and probe (counted from zero just before each); the serving
    checks and the smoke checks launch none of the four kernels (checked:
    their counts stay 0)."""
    t_phase = time.perf_counter()
    zero_launches()
    serving = {}
    for name in FAM_FULL:
        serving[name] = serve_family(name, dev)
    served = read_launches("lm_families serving", ())
    check(not any(served.values()),
          f"lm_families: serving launched a kPCA kernel: {served}")
    training, launches = {}, {}
    for name in FAM_TRAIN:
        training[name], counts = train_family(name, dev, spec)
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
    smoke = family_smoke_checks(dev)
    emit("lm_families", serving=serving, training=training,
         smoke_card_vs_cpu=smoke, tolerance=LM_TOL, launches=launches,
         phase_s=time.perf_counter() - t_phase)
    return launches


def leaf_checksums(state) -> dict:
    """Per leaf of params, m and v: (the float64 sum of its values, the
    int64 sum of its bit patterns), a slice of 2**26 values at a time."""
    import torch
    ints = {torch.bfloat16: torch.int16, torch.float32: torch.int32}
    out = {}
    for group in ("params", "m", "v"):
        for k, t in state[group].items():
            flat = t.reshape(-1)
            out[f"{group}::{k}"] = [
                sum(float(r.double().sum()) for r in flat.split(1 << 26)),
                sum(int(r.view(ints[t.dtype]).sum(dtype=torch.int64))
                    for r in flat.split(1 << 26))]
    return out


def mesh_of(shape, store: str, rank: int = 0, world: int = 1):
    """A ("data", "model") mesh of this process on card ``rank``."""
    from repro_torch.launch import make_mesh
    return make_mesh(shape, ("data", "model"), device="cuda", rank=rank,
                     world_size=world, local_rank=rank,
                     init_method=f"file://{store}")


def phase_lm_train_mesh(dev, ref) -> dict:
    """lm_train again through train(mesh=(1, 1) mesh, rules=default_rules)
    on a NCCL group of world 1: at world 1 every collective is the
    identity and every shard the whole leaf, so the losses and every
    leaf's checksums must equal lm_train's bit for bit; peak memory and
    step times beside lm_train's; the probe over the mesh is skipped (J = 1
    data rank < 3, as in the JAX package) and launches nothing."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream
    from repro_torch.distributed import default_rules
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig, cosine_with_warmup
    from repro_torch.train import TrainConfig, activation_probe, train
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    cfg = get_config(TRAIN_ARCH)
    opt = AdamWConfig(schedule=cosine_with_warmup(1, TRAIN_STEPS))
    data = TokenStream(cfg.vocab, TRAIN_BATCH, TRAIN_SEQ, seed=0,
                       device=str(dev))
    probe_batch = TokenStream(cfg.vocab, PROBE_BATCH, PROBE_SEQ, seed=1,
                              device=str(dev)).next_batch()
    rules = default_rules(False)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        mesh = mesh_of((1, 1), f"{tmp}/store")
        try:
            model = build_model(cfg, mesh=mesh)
            zero_launches()
            t0 = time.perf_counter()
            state, hist = train(model, opt, data,
                                TrainConfig(steps=TRAIN_STEPS, log_every=0),
                                mesh=mesh, rules=rules)
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
            peak = (torch.cuda.max_memory_allocated() - base) / 1e9
            sums = leaf_checksums(state)
            probe = activation_probe(state["params"], probe_batch, mesh=mesh,
                                     shards=model.shards(),
                                     n_iters=PROBE_ITERS,
                                     samples_per_node=PROBE_NODE)
            launches = read_launches("lm_train_mesh", ())
            collectives = dict(mesh.counts)
        finally:
            dist.destroy_process_group()
    del state
    torch.cuda.empty_cache()
    losses_same = hist["loss"] == ref["losses"]
    differ = sorted(k for k, v in sums.items() if ref["sums"].get(k) != v)
    check(losses_same and not differ and len(sums) == len(ref["sums"]),
          f"lm_train_mesh: the (1, 1) mesh is not lm_train's run bit for "
          f"bit: losses {hist['loss']} vs {ref['losses']}, leaves that "
          f"differ {differ[:8]}")
    check(probe == {"skipped": True},
          f"lm_train_mesh: the probe over a one-rank mesh ran: {probe}")
    check(not collectives, f"lm_train_mesh: collectives issued on a world "
                           f"of 1: {collectives}")
    steps = hist["step_time"]
    emit("lm_train_mesh", arch=TRAIN_ARCH, mesh=[1, 1], layers=cfg.n_layers,
         d_model=cfg.d_model, steps=TRAIN_STEPS, losses=hist["loss"],
         lm_train_losses=ref["losses"], losses_bitwise=losses_same,
         leaves=len(sums), leaves_differing=differ,
         checksums_bitwise=not differ, train_s=train_s,
         first_step_s=steps[0],
         warm_step_s_median=sorted(steps[1:])[len(steps[1:]) // 2],
         lm_train_first_step_s=ref["first"],
         lm_train_warm_step_s_median=ref["warm"], peak_alloc_gb=peak,
         lm_train_peak_alloc_gb=ref["peak"], probe=probe,
         collectives=collectives, launches=launches,
         phase_s=time.perf_counter() - t_phase)
    return launches


def fp32(cfg):
    import dataclasses
    return dataclasses.replace(cfg, param_dtype="float32",
                               compute_dtype="float32")


def smoke_steps(model, dev, mesh=None):
    """DIST_STEPS steps of the fp32 llama3.2-3b-smoke from seed 0 (the
    training checks' optimizer and stream): (state, build_train_step's
    model layout)."""
    from repro_torch.data import TokenStream
    from repro_torch.optim import AdamWConfig, cosine_with_warmup
    from repro_torch.train import build_train_step
    opt = AdamWConfig(schedule=cosine_with_warmup(1, TRAIN_SMOKE_STEPS))
    init_fn, step_fn = build_train_step(model, opt, mesh)
    state, _ = init_fn(0)
    data = TokenStream(model.cfg.vocab, TRAIN_BATCH, 32, seed=0,
                       device=str(dev))
    for _ in range(DIST_STEPS):
        step_fn(state, data.next_batch())
    return state


def lm_steps(model, dev, mesh=None) -> tuple:
    """DIST_STEPS steps of ``model`` (llama3.2-3b, falcon-mamba-7b or
    zamba2-1.2b at full width) from lm_train's seed, optimizer and batches:
    (state, per-step loss / grad norm / seconds (and over ``mesh`` the
    step's collectives, ``Mesh.counts``), peak allocation in GB above what
    was held before)."""
    import torch
    from repro_torch.data import TokenStream
    from repro_torch.optim import AdamWConfig, cosine_with_warmup
    from repro_torch.train import build_train_step
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    opt = AdamWConfig(schedule=cosine_with_warmup(1, TRAIN_STEPS))
    init_fn, step_fn = build_train_step(model, opt, mesh)
    state, _ = init_fn(0)
    data = TokenStream(model.cfg.vocab, TRAIN_BATCH, TRAIN_SEQ, seed=0,
                       device=str(dev))
    steps = []
    for _ in range(DIST_STEPS):
        before = dict(mesh.counts) if mesh is not None else {}
        t0 = time.perf_counter()
        _, met = step_fn(state, data.next_batch())
        loss = float(met["loss"])
        steps.append(dict(loss=loss, grad_norm=float(met["grad_norm"]),
                          s=time.perf_counter() - t0))
        if mesh is not None:
            steps[-1]["collectives"] = {
                k: v - before.get(k, 0) for k, v in mesh.counts.items()}
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    return state, steps, peak


def moe_loss(cfg, dev, mesh=None) -> dict:
    """Step 1 of a cut MoE config from seed 0: over a mesh one training
    step's loss, on one card the forward loss alone (its training state
    does not fit beside the activations); and the peak allocation."""
    import torch
    from repro_torch.data import TokenStream
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import build_train_step
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    batch = TokenStream(cfg.vocab, DIST_MOE_BATCH, DIST_MOE_SEQ, seed=0,
                        device=str(dev)).next_batch()
    model = build_model(cfg, mesh=mesh, device=dev)
    if mesh is None:
        params, _ = model.init(0)
        with torch.no_grad():
            loss = float(model.loss(params, batch)[1]["loss"])
        del params
    else:
        init_fn, step_fn = build_train_step(model, AdamWConfig(), mesh)
        state, _ = init_fn(0)
        loss = float(step_fn(state, batch)[1]["loss"])
        del state
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    torch.cuda.empty_cache()
    return dict(loss=loss, peak_alloc_gb=peak)


def moe_cfgs():
    import dataclasses
    from repro_torch.configs import get_config
    return {arch: dataclasses.replace(get_config(arch), n_layers=layers)
            for arch, layers in DIST_MOE}


def falcon_loss(dev) -> dict:
    """falcon-mamba-7b's forward loss on one card (no grads: its training
    state does not fit), from seed 0 on lm_train's first batch."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream
    from repro_torch.models import build_model
    cfg = get_config(DIST_FALCON)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    model = build_model(cfg, device=dev)
    params, _ = model.init(0)
    batch = TokenStream(cfg.vocab, TRAIN_BATCH, TRAIN_SEQ, seed=0,
                        device=str(dev)).next_batch()
    with torch.no_grad():
        loss = float(model.loss(params, batch)[1]["loss"])
    del params
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    torch.cuda.empty_cache()
    return dict(loss=loss, peak_alloc_gb=peak)


def dist_reference(dev) -> dict:
    """The one-card runs lm_train_dist is held to: llama3.2-3b's steps, the
    cut MoE configs' forward losses, falcon-mamba-7b's forward loss,
    zamba2-1.2b's steps (bf16, and its weights widened to fp32), the fp32
    smoke model's params."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    state, steps, peak = lm_steps(build_model(get_config(TRAIN_ARCH),
                                              device=dev), dev)
    del state
    ref = dict(llama=dict(steps=steps, peak_alloc_gb=peak),
               moe={arch: moe_loss(cfg, dev)
                    for arch, cfg in moe_cfgs().items()},
               falcon=falcon_loss(dev))
    torch.cuda.empty_cache()
    for key, cfg in (("zamba2", get_config(DIST_ZAMBA)),
                     ("zamba2_fp32", fp32(get_config(DIST_ZAMBA)))):
        state, steps, peak = lm_steps(build_model(cfg, device=dev), dev)
        del state
        torch.cuda.empty_cache()
        ref[key] = dict(steps=steps, peak_alloc_gb=peak)
    state = smoke_steps(build_model(fp32(get_config(TRAIN_ARCH, smoke=True)),
                                    device=dev), dev)
    ref["smoke"] = {k: v.cpu() for k, v in state["params"].items()}
    del state
    torch.cuda.empty_cache()
    return ref


def zamba_rule(meshes, dev, rank: int, seed: int):
    """zamba2-1.2b's step-1 bf16 gradient from ``seed``'s weights and
    batch over each of DIST_ZAMBA_MESHES, gathered whole on rank 0, which
    then takes it alone in bf16 (g1) and with the weights widened to fp32
    (g32): on rank 0 per mesh the loss and, per leaf, the squared norms of
    g32, g1 and the mesh's gm and of d1 = g1 - g32 and dm = gm - g32 (the
    other ranks: None)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream
    from repro_torch.distributed import local_shard
    from repro_torch.distributed.collectives import gather_full
    from repro_torch.models import build_model
    from repro_torch.train.loop import loss_and_grads, sum_replicated_grads
    cfg = get_config(DIST_ZAMBA)
    w, _ = build_model(cfg, device=dev).init(seed)
    batch = TokenStream(cfg.vocab, TRAIN_BATCH, TRAIN_SEQ, seed=seed,
                        device=str(dev)).next_batch()
    gms = {}
    for shape in DIST_ZAMBA_MESHES:
        mesh = meshes[shape]
        model = build_model(cfg, mesh=mesh)
        sh = model.shards()
        _, met, g = loss_and_grads(model, {
            k: local_shard(v, sh.specs[k], mesh).clone()
            for k, v in w.items()}, batch)
        sum_replicated_grads(g, sh)
        # every rank joins each leaf's gathers; rank 0 keeps the whole
        whole = {}
        for k in list(g):
            full = gather_full(g.pop(k), sh.specs[k], mesh)
            if rank == 0:
                whole[k] = full
            del full
        gms[str(list(shape))] = (float(met["loss"]), whole)
        del g
    if rank != 0:
        del w
        torch.cuda.empty_cache()
        return None
    _, m1, g1 = loss_and_grads(build_model(cfg, device=dev), w, batch)
    w32 = {k: v.float() for k, v in w.items()}
    del w
    _, m32, g32 = loss_and_grads(build_model(fp32(cfg), device=dev), w32,
                                 batch)
    del w32
    sq = lambda t: float(t.double().pow(2).sum())
    out = dict(loss_one_card=float(m1["loss"]),
               loss_one_card_fp32=float(m32["loss"]), meshes={})
    for key, (loss, gm) in gms.items():
        out["meshes"][key] = dict(loss=loss, sums={k: dict(
            g32=sq(v), g1=sq(g1[k]), gm=sq(gm[k]),
            d1=sq(g1[k].float() - v), dm=sq(gm[k].float() - v))
            for k, v in g32.items()})
    del gms, g1, g32
    torch.cuda.empty_cache()
    return out


def rule_readings(sums: dict) -> dict:
    """zamba_rule's squared norms of one mesh as the rule reads them: per
    leaf and "whole" (the flattened gradient) |g32|, d1, dm, r = dm / d1
    and whether dm <= 1.25 d1 + 1e-3 |g32|; the step-1 grad norm's gap
    from one card's, relative; the leaves past the rule."""
    sums = dict(sums, whole={f: sum(v[f] for v in sums.values())
                             for f in ("g32", "g1", "gm", "d1", "dm")})
    leaves = {}
    for k, v in sums.items():
        n32, d1, dm = (math.sqrt(v[f]) for f in ("g32", "d1", "dm"))
        leaves[k] = dict(g32=n32, d1=d1, dm=dm,
                         r=dm / d1 if d1 > 0 else None,
                         ok=dm <= DIST_RULE_FACTOR * d1
                         + DIST_RULE_FLOOR * n32)
    g1, gm = (math.sqrt(sums["whole"][f]) for f in ("g1", "gm"))
    return dict(leaves=leaves, grad_norm_rel_gap=abs(gm - g1) / g1,
                misses=[k for k, v in leaves.items() if not v["ok"]])


def dist_rank(rank: int, world: int, store: str, out: str) -> None:
    """One rank of lm_train_dist (a spawned process on card ``rank``): the
    three meshes over the same world, then on each llama3.2-3b at full
    width (DIST_STEPS steps, per-step loss and grad norm, peak memory), at
    (4, 1) the probe's ring branch (its launches, its x_nodes and alpha),
    falcon-mamba-7b and zamba2-1.2b's steps, zamba2's step-1 gradients
    for the rule (``zamba_rule``, each of DIST_RULE_SEEDS), the cut MoE
    configs on (1, 4) and (2, 2), the fp32 smoke model's params
    after DIST_STEPS steps, and at (2, 2) a sharded checkpoint restored at
    (4, 1); writes rank<r>.json (and rank 0 the tensors)."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.core import KernelSpec, dkpca_distributed
    from repro_torch.data import TokenStream
    from repro_torch.distributed.collectives import all_gather, gather_full
    from repro_torch.models import build_model
    from repro_torch.models.common import local_batch
    from repro_torch.train import activation_probe
    from repro_torch.train.loop import (_flatten_state, _unflatten_state,
                                        state_shardings)
    from repro_torch.train.probes import pooled_activations
    meshes = {shape: mesh_of(shape, store, rank, world)
              for shape in DIST_MESHES}
    dev = meshes[DIST_MESHES[0]].device
    out = Path(out)
    res = dict(card=str(dev), llama={}, moe={}, smoke={})
    full = lambda tree, shards: {k: gather_full(v, shards.specs[k],
                                                shards.mesh).cpu()
                                 for k, v in tree.items()}
    try:
        cfg = get_config(TRAIN_ARCH)
        for shape, mesh in meshes.items():
            mesh.counts.clear()
            model = build_model(cfg, mesh=mesh)
            state, steps, peak = lm_steps(model, dev, mesh)
            entry = dict(steps=steps, peak_alloc_gb=peak,
                         params_m_v_gb=sum(t.numel() * t.element_size()
                                      for g in ("params", "m", "v")
                                      for t in state[g].values()) / 1e9,
                         collectives=dict(mesh.counts))
            if shape == (4, 1):
                batch = TokenStream(cfg.vocab, PROBE_BATCH, PROBE_SEQ,
                                    seed=1, device=str(dev)).next_batch()
                torch.cuda.synchronize()
                zero_launches()
                probe = activation_probe(state["params"], batch, mesh=mesh,
                                         shards=model.shards(),
                                         n_iters=PROBE_ITERS)
                torch.cuda.synchronize()
                counts = read_launches("lm_train_dist probe",
                                       ("gram", "admm_step"))
                entry["probe"] = dict(out=probe, gram=counts["gram"],
                                      admm_step=counts["admm_step"])
                # its x_nodes and alpha: the probe's own steps again
                rows, _ = local_batch({"tokens": batch["tokens"]}, mesh)
                acts = all_gather(pooled_activations(
                    state["params"], rows["tokens"], model.shards()), 0,
                    mesh, ("data",))
                n = min(PROBE_NODE, PROBE_BATCH // world)
                x_nodes = acts[: world * n].reshape(world, n, -1)
                ring = dkpca_distributed(x_nodes, group=mesh.group("data"),
                                         hops=1, spec=KernelSpec(kind="rbf"),
                                         n_iters=PROBE_ITERS, device=dev)
                energy = torch.linalg.norm(ring.alpha, dim=1)
                mean = torch.mean(energy)
                again = dict(
                    skipped=False,
                    consensus_residual=float(ring.primal_residual[-1]),
                    participation_mean=float(mean),
                    participation_cv=float(torch.std(energy, unbiased=False)
                                           / torch.clamp(mean, min=1e-9)))
                entry["probe"]["rerun_equal"] = again == probe
                if rank == 0:
                    torch.save(dict(x_nodes=x_nodes.cpu(),
                                    alpha=ring.alpha.cpu()),
                               out / "probe.pt")
            res["llama"][str(list(shape))] = entry
            del state, model
            torch.cuda.empty_cache()
        # falcon-mamba-7b at full depth on (4, 1) and (1, 4); zamba2-1.2b
        # on (2, 2) and (1, 4), in bf16 and widened to fp32
        for arch, shapes, wide in (
                (DIST_FALCON, tuple(DIST_FALCON_TOL), False),
                (DIST_ZAMBA, DIST_ZAMBA_MESHES, False),
                (DIST_ZAMBA, DIST_ZAMBA_MESHES, True)):
            cfg = fp32(get_config(arch)) if wide else get_config(arch)
            for shape in shapes:
                model = build_model(cfg, mesh=meshes[shape])
                state, steps, peak = lm_steps(model, dev, meshes[shape])
                res.setdefault(arch + (" fp32" if wide else ""), {})[
                    str(list(shape))] = dict(
                    steps=steps, peak_alloc_gb=peak,
                    params_m_v_gb=sum(t.numel() * t.element_size()
                                      for g in ("params", "m", "v")
                                      for t in state[g].values()) / 1e9)
                del state, model
                torch.cuda.empty_cache()
        res["zamba2_rule"] = {str(seed): zamba_rule(meshes, dev, rank, seed)
                              for seed in DIST_RULE_SEEDS}
        for arch, mcfg in moe_cfgs().items():
            for shape in DIST_MOE_MESHES:
                res["moe"][f"{arch} {list(shape)}"] = moe_loss(
                    mcfg, dev, meshes[shape])
        scfg = fp32(get_config(TRAIN_ARCH, smoke=True))
        for shape, mesh in meshes.items():
            model = build_model(scfg, mesh=mesh)
            state = smoke_steps(model, dev, mesh)
            params = full(state["params"], model.shards())
            if rank == 0:
                torch.save(params, out / f"smoke_{shape[0]}x{shape[1]}.pt")
            if shape == (2, 2):
                sh = model.shards()
                save_checkpoint(str(out / "ckpt22"), DIST_STEPS,
                                _flatten_state(state),
                                shardings=state_shardings(sh))
                saved = {g: full(state[g], sh) for g in ("params", "m", "v")}
                if rank == 0:
                    torch.save(saved, out / "ckpt22_state.pt")
                sh41 = build_model(scfg, mesh=meshes[(4, 1)]).shards()
                flat, _, step = restore_checkpoint(
                    str(out / "ckpt22"), shardings=state_shardings(sh41))
                back = _unflatten_state(flat, device=dev)
                # every rank joins every gather before any comparison
                back = {g: full(back[g], sh41) for g in saved}
                res["elastic_22_to_41_bitwise"] = step == DIST_STEPS and all(
                    torch.equal(back[g][k], saved[g][k])
                    for g in saved for k in saved[g])
            del state, model
        (out / f"rank{rank}.json").write_text(json.dumps(res))
    finally:
        dist.destroy_process_group()


def phase_lm_train_dist(dev) -> dict:
    """Data-, tensor- and expert-parallel training over min(4, cards) NCCL
    ranks in spawned processes (``dist_rank``), held to one-card runs of
    the same seeds and batches (``dist_reference``); then the probe's alpha
    against the world-1 ring fit of the same x_nodes on one card
    (bitwise), the (2, 2) checkpoint restored on one card (bitwise), and
    the training launcher under torchrun on a 2 x 2 mesh. On a host with
    fewer than 4 cards it does not run, and says why."""
    import multiprocessing
    import torch
    import torch.distributed as dist
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.core import KernelSpec, dkpca_distributed
    from repro_torch.launch import make_process_group
    from repro_torch.train.loop import _unflatten_state
    t_phase = time.perf_counter()
    count = torch.cuda.device_count()
    if count < DIST_RANKS:
        reason = (f"{count} card(s) on this host: the (4, 1), (2, 2) and "
                  f"(1, 4) meshes need {DIST_RANKS} (run --phase "
                  f"lm_train_dist on a four-card host)")
        print(f"chip_smoke: lm_train_dist did not run: {reason}",
              file=sys.stderr, flush=True)
        emit("lm_train_dist", ran=False, reason=reason)
        return dict(ran=False, reason=reason)
    world = DIST_RANKS
    t0 = time.perf_counter()
    ref = dist_reference(dev)
    ref_s = time.perf_counter() - t0
    ctx = multiprocessing.get_context("spawn")
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        procs = [ctx.Process(target=dist_rank,
                             args=(r, world, f"{tmp}/store", tmp))
                 for r in range(world)]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        deadline = time.monotonic() + DIST_RANK_TIMEOUT_S
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        ranks_s = time.perf_counter() - t0
        codes = [p.exitcode for p in procs]
        check(not hung and codes == [0] * world,
              f"lm_train_dist: ranks {hung} hung, exit codes {codes}")
        if hung or codes != [0] * world:
            emit("lm_train_dist", ran=True, exit_codes=codes, hung=hung)
            return dict(ran=True, exit_codes=codes, hung=hung)
        ranks = [json.loads(Path(f"{tmp}/rank{r}.json").read_text())
                 for r in range(world)]
        probe_t = torch.load(f"{tmp}/probe.pt")
        smoke = {shape: torch.load(f"{tmp}/smoke_{shape[0]}x{shape[1]}.pt")
                 for shape in DIST_MESHES}
        saved = torch.load(f"{tmp}/ckpt22_state.pt")
        flat, _, _ = restore_checkpoint(f"{tmp}/ckpt22")
        back = _unflatten_state(flat, device="cpu")
        one_card_restore = all(torch.equal(back[g][k].cpu(), saved[g][k])
                               for g in saved for k in saved[g])
        # the probe's ring on one card: a NCCL group of world 1
        group, _ = make_process_group(dev, rank=0, world_size=1, local_rank=0,
                                      init_method=f"file://{tmp}/store1")
        try:
            one = dkpca_distributed(probe_t["x_nodes"].to(dev), group=group,
                                    hops=1, spec=KernelSpec(kind="rbf"),
                                    n_iters=PROBE_ITERS, device=dev)
        finally:
            dist.destroy_process_group()
        alpha_bitwise = torch.equal(one.alpha.cpu(), probe_t["alpha"])
        alpha_err = float((probe_t["alpha"] - one.alpha.cpu()).abs().max())
    # the launcher under torchrun
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    try:
        run = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", str(world), "-m", "repro_torch.launch.train",
             *DIST_LAUNCH_ARGS], env=env, capture_output=True, text=True,
            timeout=DIST_LAUNCH_TIMEOUT_S, cwd=ROOT)
        rc, stdout, stderr = run.returncode, run.stdout, run.stderr
    except subprocess.TimeoutExpired as e:
        rc, stdout, stderr = "timeout", str(e.stdout), str(e.stderr)
    launch_s = time.perf_counter() - t0
    finals = [ln for ln in str(stdout).splitlines()
              if ln.startswith("final loss: ")]
    launcher = dict(args=list(DIST_LAUNCH_ARGS), rc=rc, seconds=launch_s,
                    last_line=str(stdout).strip().splitlines()[-1:],
                    final_lines=len(finals))
    check(rc == 0 and len(finals) == 1
          and str(stdout).strip().splitlines()[-1] == finals[0],
          f"lm_train_dist: the launcher under torchrun: {launcher}, "
          f"stderr {str(stderr)[-2000:]}")
    # gates
    r0 = ranks[0]
    llama = {}
    ref_steps = ref["llama"]["steps"]
    for shape in DIST_MESHES:
        key = str(list(shape))
        got = r0["llama"][key]["steps"]
        loss_gap = abs(got[0]["loss"] - ref_steps[0]["loss"]) / abs(
            ref_steps[0]["loss"])
        # the gates read step 1 (the same weights on both sides); later
        # steps part as bf16 rounding moves each first Adam update
        gn_gaps = [abs(g["grad_norm"] - w["grad_norm"]) / abs(w["grad_norm"])
                   for g, w in zip(got, ref_steps)]
        loss_gaps = [abs(g["loss"] - w["loss"]) / abs(w["loss"])
                     for g, w in zip(got, ref_steps)]
        peaks = [r["llama"][key]["peak_alloc_gb"] for r in ranks]
        same_on_ranks = all(r["llama"][key]["steps"][i]["loss"]
                            == got[i]["loss"] for r in ranks
                            for i in range(DIST_STEPS))
        llama[key] = dict(
            losses=[g["loss"] for g in got],
            grad_norms=[g["grad_norm"] for g in got],
            step_s=[g["s"] for g in got], step1_loss_rel_gap=loss_gap,
            gate=DIST_LOSS_TOL[shape], step1_grad_norm_rel_gap=gn_gaps[0],
            grad_norm_gate=DIST_GNORM_TOL, loss_rel_gap_by_step=loss_gaps,
            grad_norm_rel_gap_by_step=gn_gaps,
            peak_alloc_gb_by_rank=peaks,
            params_m_v_gb_per_card=r0["llama"][key]["params_m_v_gb"],
            collectives_rank0=r0["llama"][key]["collectives"],
            loss_same_on_every_rank=same_on_ranks)
        check(loss_gap <= DIST_LOSS_TOL[shape] and gn_gaps[0] <= DIST_GNORM_TOL
              and same_on_ranks and all(math.isfinite(g["loss"])
                                        for g in got),
              f"lm_train_dist llama {key}: {llama[key]}")
    peak41 = max(llama["[4, 1]"]["peak_alloc_gb_by_rank"])
    check(peak41 < DIST_PEAK_GB_MAX, f"lm_train_dist: per-card peak at "
                                     f"(4, 1) {peak41:.3f} GB >= "
                                     f"{DIST_PEAK_GB_MAX} GB")
    probe = [r["llama"]["[4, 1]"]["probe"] for r in ranks]
    # the world-1 ring batches the 4 nodes into each operation, the
    # four-card ring runs one a rank: every per-node operation is
    # batch-invariant (scripts/ring_batch_bits.py) and RingComm.all_sum
    # folds the centring mean's node terms in node order at every layout,
    # so alpha must be the world-1 ring's bits
    check(all(not p["out"]["skipped"] and p["gram"] == 5
              and p["admm_step"] == PROBE_ITERS and p["rerun_equal"]
              for p in probe) and alpha_bitwise,
          f"lm_train_dist probe: {probe}, alpha {alpha_err:.3g} from the "
          f"one-card ring (bitwise: {alpha_bitwise})")
    # the families: falcon-mamba-7b at (4, 1) and (1, 4) against its
    # one-card forward loss, zamba2-1.2b at (2, 2) and (1, 4) against its
    # one-card steps; each with rank 0's collectives a step
    families = {}
    want = ref["falcon"]["loss"]
    for shape, tol in DIST_FALCON_TOL.items():
        key = str(list(shape))
        got = r0[DIST_FALCON][key]["steps"]
        peaks = [r[DIST_FALCON][key]["peak_alloc_gb"] for r in ranks]
        rec = dict(
            losses=[g["loss"] for g in got],
            grad_norms=[g["grad_norm"] for g in got],
            step_s=[g["s"] for g in got], one_card_forward_loss=want,
            step1_loss_rel_gap=abs(got[0]["loss"] - want) / abs(want),
            gate=tol, peak_alloc_gb_by_rank=peaks,
            peak_gate_gb=DIST_FALCON_PEAK_GB,
            params_m_v_gb_per_card=r0[DIST_FALCON][key]["params_m_v_gb"],
            one_card_forward_peak_gb=ref["falcon"]["peak_alloc_gb"],
            collectives_rank0_by_step=[g["collectives"] for g in got])
        same = all(r[DIST_FALCON][key]["steps"][i]["loss"] == got[i]["loss"]
                   for r in ranks for i in range(DIST_STEPS))
        families[f"{DIST_FALCON} {key}"] = rec
        check(same and all(math.isfinite(g["loss"]) for g in got)
              and rec["step1_loss_rel_gap"] <= tol
              and max(peaks) < DIST_FALCON_PEAK_GB,
              f"lm_train_dist {DIST_FALCON} {key}: {rec}, losses the same "
              f"on every rank {same}")
    zref = ref["zamba2"]["steps"]
    for shape in DIST_ZAMBA_MESHES:
        key = str(list(shape))
        got = r0[DIST_ZAMBA][key]["steps"]
        rec = dict(
            losses=[g["loss"] for g in got],
            grad_norms=[g["grad_norm"] for g in got],
            step_s=[g["s"] for g in got],
            one_card_losses=[w["loss"] for w in zref],
            step1_loss_rel_gap=abs(got[0]["loss"] - zref[0]["loss"])
            / abs(zref[0]["loss"]),
            step1_grad_norm_rel_gap=abs(got[0]["grad_norm"]
                                        - zref[0]["grad_norm"])
            / abs(zref[0]["grad_norm"]),
            gate=DIST_LOSS_TOL[shape],
            peak_alloc_gb_by_rank=[r[DIST_ZAMBA][key]["peak_alloc_gb"]
                                   for r in ranks],
            params_m_v_gb_per_card=r0[DIST_ZAMBA][key]["params_m_v_gb"],
            collectives_rank0_by_step=[g["collectives"] for g in got])
        same = all(r[DIST_ZAMBA][key]["steps"][i]["loss"] == got[i]["loss"]
                   for r in ranks for i in range(DIST_STEPS))
        families[f"{DIST_ZAMBA} {key}"] = rec
        check(same and all(math.isfinite(g["loss"]) for g in got)
              and rec["step1_loss_rel_gap"] <= DIST_LOSS_TOL[shape],
              f"lm_train_dist {DIST_ZAMBA} {key}: {rec}, losses the same "
              f"on every rank {same}")
        # the rule, each seed on its own (no max or mean over seeds)
        rule = {}
        for seed, got_s in r0["zamba2_rule"].items():
            m = got_s["meshes"][key]
            rule[seed] = dict(rule_readings(m["sums"]), loss=m["loss"],
                              loss_one_card=got_s["loss_one_card"],
                              loss_one_card_fp32=got_s["loss_one_card_fp32"])
        families[f"{DIST_ZAMBA} rule {key}"] = rule
        check(all(not v["misses"] for v in rule.values()),
              f"lm_train_dist {DIST_ZAMBA} {key}: step 1's bf16 gradient "
              f"past dm <= {DIST_RULE_FACTOR} d1 + {DIST_RULE_FLOOR} |g32| "
              f"on {({seed: v['misses'] for seed, v in rule.items()})}")
        # fp32: the weights widened, one card and the mesh
        got = r0[DIST_ZAMBA + " fp32"][key]["steps"]
        want32 = ref["zamba2_fp32"]["steps"][0]
        rec32 = dict(
            losses=[g["loss"] for g in got],
            grad_norms=[g["grad_norm"] for g in got],
            step_s=[g["s"] for g in got],
            one_card_losses=[w["loss"] for w in ref["zamba2_fp32"]["steps"]],
            one_card_grad_norms=[w["grad_norm"]
                                 for w in ref["zamba2_fp32"]["steps"]],
            step1_loss_rel_gap=abs(got[0]["loss"] - want32["loss"])
            / abs(want32["loss"]),
            step1_grad_norm_rel_gap=abs(got[0]["grad_norm"]
                                        - want32["grad_norm"])
            / abs(want32["grad_norm"]),
            gate=DIST_ZAMBA_FP32_TOL,
            one_card_bf16_step1_grad_norm_rel_to_fp32=abs(
                zref[0]["grad_norm"] - want32["grad_norm"])
            / abs(want32["grad_norm"]))
        families[f"{DIST_ZAMBA} fp32 {key}"] = rec32
        check(all(math.isfinite(g["loss"]) for g in got)
              and rec32["step1_loss_rel_gap"] <= DIST_ZAMBA_FP32_TOL
              and rec32["step1_grad_norm_rel_gap"] <= DIST_ZAMBA_FP32_TOL,
              f"lm_train_dist {DIST_ZAMBA} fp32 {key}: {rec32}")
    moe = {}
    for key, got in r0["moe"].items():
        arch = key.split()[0]
        want = ref["moe"][arch]["loss"]
        gap = abs(got["loss"] - want) / abs(want)
        moe[key] = dict(loss=got["loss"], one_card_loss=want, rel_gap=gap,
                        peak_alloc_gb_by_rank=[r["moe"][key]["peak_alloc_gb"]
                                               for r in ranks])
        check(math.isfinite(got["loss"]) and gap <= DIST_MOE_TOL,
              f"lm_train_dist {key}: {moe[key]}")
    smoke_gaps = {}
    for shape in DIST_MESHES:
        ok, worst = params_within(smoke[shape], ref["smoke"], DIST_SMOKE_TOL)
        smoke_gaps[str(list(shape))] = worst
        check(ok, f"lm_train_dist fp32 smoke {shape}: params {worst:.3g} "
                  f"x max|p| from one card > {DIST_SMOKE_TOL}")
    elastic = r0["elastic_22_to_41_bitwise"]
    check(elastic and one_card_restore,
          f"lm_train_dist: the (2, 2) checkpoint restored at (4, 1) "
          f"{elastic}, on one card {one_card_restore}")
    out = dict(ran=True, world=world, cards=[r["card"] for r in ranks],
               one_card=ref["llama"], one_card_moe=ref["moe"], llama=llama,
               peak_alloc_gb_4x1_max=peak41, probe_by_rank=probe,
               probe_alpha_bitwise_one_card_ring=alpha_bitwise,
               probe_alpha_max_abs_err_one_card_ring=alpha_err,
               families=families, one_card_zamba2=ref["zamba2"],
               one_card_zamba2_fp32=ref["zamba2_fp32"], moe=moe,
               fp32_smoke_params_max_err_over_max_abs=smoke_gaps,
               fp32_smoke_gate=DIST_SMOKE_TOL,
               elastic_22_to_41_bitwise=elastic,
               elastic_22_to_one_card_bitwise=one_card_restore,
               launcher=launcher, reference_s=ref_s, ranks_s=ranks_s,
               phase_s=time.perf_counter() - t_phase)
    emit("lm_train_dist", **out)
    return out


# ---------------------------------------------------------------------------
# the XLA-free dry-run and decode over a mesh


def run_cli(args, log_path, timeout: float, env=None):
    """``python -m`` a module of the port in a CPU-only child (no card
    visible to it), in a session of its own so that a timeout ends it with
    every worker it started; its output to ``log_path``: (rc or
    "timeout", seconds)."""
    import signal
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="", **(env or {}))
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        proc = subprocess.Popen([sys.executable, *args], env=env, cwd=ROOT,
                                stdout=log, stderr=subprocess.STDOUT,
                                start_new_session=True)
        try:
            rc = proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
            rc = "timeout"
    return rc, time.perf_counter() - t0


def nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def greedy_run(model, params, batch, max_len: int, feed=None, mesh=None,
               steps: int = DECODE_STEPS, dtype=None):
    """Prefill, then ``steps`` decode steps fed ``feed`` (steps, B) or the
    greedy tokens: (logits (steps + 1, B, V) fp32 on the host, the tokens
    fed, prefill seconds, decode seconds, the last step's collectives, the
    last cache)."""
    import torch
    kw = {} if dtype is None else {"dtype": dtype}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, batch, max_len, **kw)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    s = batch["tokens"].shape[1]
    outs, fed = [logits.float().cpu()], []
    for i in range(steps):
        tok = torch.argmax(logits.float(), dim=-1) if feed is None \
            else feed[i].to(logits.device)
        fed.append(tok.cpu())
        if mesh is not None and i == steps - 1:
            mesh.counts.clear()
        logits, cache = model.decode_step(params, cache,
                                          tok[:, None].to(torch.int32),
                                          s + i)
        outs.append(logits.float().cpu())
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    counts = {} if mesh is None else dict(mesh.counts)
    return torch.stack(outs), torch.stack(fed), t1 - t0, t2 - t1, counts, \
        cache


def decode_cfg(arch: str, layers):
    """A decode run's config: full width, cut to ``layers``, chunked
    attention (a 4 x 4096 prompt's scores over a 32768-slot cache would
    take 51 GB einsummed)."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(arch), attention_impl="chunked")
    return cfg if layers is None else dataclasses.replace(cfg,
                                                          n_layers=layers)


def decode_batch(cfg, b: int, prompt: int, dev):
    """A run's prompt (and seamless's enc_seq frames), drawn with numpy
    from DECODE_SEED."""
    import numpy as np
    import torch
    rng = np.random.default_rng(DECODE_SEED)
    batch = {"tokens": torch.as_tensor(rng.integers(
        0, cfg.vocab, size=(b, prompt), dtype=np.int32), device=dev)}
    if cfg.family == "audio":
        batch["frames"] = torch.as_tensor(rng.normal(0, 0.02, size=(
            b, cfg.enc_seq, cfg.d_model)).astype(np.float32), device=dev)
    return batch


def run_key(run) -> str:
    arch, layers, shape, _, prompt, _ = run
    return f"{arch}{'' if layers is None else f' x{layers}'} " \
           f"{shape[0]}x{shape[1]}" + \
           (f" p{prompt}" if run == DECODE_DROP_RUN else "")


def decode_runs(only=None):
    """DECODE_RUNS and the drop run, or those of the archs in ``only``."""
    runs = DECODE_RUNS + (DECODE_DROP_RUN,)
    return runs if not only else tuple(r for r in runs if r[0] in only)


def mesh11_decode(dev) -> dict:
    """llama3.2-3b at full width and depth on the card: a prefill of 4 x 64
    tokens and 8 greedy steps without a mesh and over a (1, 1) mesh (a NCCL
    group of world 1), bitwise: the logits, the tokens and the cache."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config(TRAIN_ARCH)
    model = build_model(cfg, device=dev)
    params, _ = model.init(DECODE_SEED)
    batch = decode_batch(cfg, MESH11_BATCH, MESH11_PROMPT, dev)
    with torch.no_grad():
        want, wtok, _, wdec, _, wcache = greedy_run(
            model, params, batch, MESH11_MAX_LEN, steps=MESH11_STEPS)
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
            mesh = mesh_of((1, 1), f"{tmp}/store")
            try:
                m11 = build_model(cfg, mesh=mesh)
                got, gtok, _, gdec, counts, gcache = greedy_run(
                    m11, params, batch, MESH11_MAX_LEN, mesh=mesh,
                    steps=MESH11_STEPS)
                issued = dict(mesh.counts)
            finally:
                dist.destroy_process_group()
    same_cache = all(torch.equal(a, b) for a, b in zip(wcache,
                                                       gcache.shards))
    del params, wcache, gcache
    torch.cuda.empty_cache()
    return dict(arch=TRAIN_ARCH, batch=MESH11_BATCH, prompt=MESH11_PROMPT,
                max_len=MESH11_MAX_LEN, steps=MESH11_STEPS,
                logits_bitwise=torch.equal(got, want),
                tokens_equal=torch.equal(gtok, wtok),
                cache_bitwise=same_cache,
                max_abs_err=float((got - want).abs().max()),
                collectives=issued, decode_s=gdec, no_mesh_decode_s=wdec)


def phase_dryrun(dev, train_ref=None) -> dict:
    """The dry-run's CLI over every cell (after every timed phase, so that
    its CPU workers share the host with none) and the roofline over its
    output; its (1, 1) argument bytes for lm_train's run against the live
    training state (params, m, v, step and a batch of lm_train's stream,
    built on the card); a (1, 1) mesh decode bitwise the no-mesh decode
    (``mesh11_decode``). None of the four kernels launches."""
    import torch
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.data import TokenStream
    from repro_torch.launch import dryrun
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import build_train_step
    t_phase = time.perf_counter()
    out = ROOT / DRYRUN_OUT
    out.parent.mkdir(parents=True, exist_ok=True)
    if out.exists():
        out.unlink()
    rc, cli_s = run_cli(("-m", "repro_torch.launch.dryrun", *DRYRUN_ARGS),
                        out.with_suffix(".log"), DRYRUN_TIMEOUT_S)
    cells = json.loads(out.read_text()) if out.exists() else {}
    n_ok = sum(1 for v in cells.values() if v["ok"])
    n_skip = sum(1 for v in cells.values()
                 if v.get("error", "").startswith("SKIP"))
    failed = sorted(k for k, v in cells.items() if not v["ok"]
                    and not v.get("error", "").startswith("SKIP"))
    check(rc == 0 and (n_ok, n_skip) == DRYRUN_CELLS and not failed,
          f"dryrun: the CLI's rc {rc}, {n_ok} ok, {n_skip} skipped, failed "
          f"{failed[:6]} (want {DRYRUN_CELLS})")
    md = out.with_name("roofline.md")
    roof = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.roofline", "--dryrun",
         str(out), "--out", str(out.with_name("roofline.json")),
         "--markdown", str(md)], env=dict(os.environ,
                                          PYTHONPATH=str(ROOT / "src")),
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    rows = [ln for ln in roof.stdout.splitlines() if ln.startswith("| ")
            and not ln.startswith("| arch")]
    check(roof.returncode == 0 and len(rows) == 34,
          f"dryrun: roofline rc {roof.returncode}, {len(rows)} rows (want "
          f"34 single-pod cells), stderr {roof.stderr[-1500:]}")
    # the (1, 1) argument bytes of lm_train's run against its live state
    zero_launches()
    cfg = get_config(TRAIN_ARCH)
    shape = ShapeSpec("lm_train", "train", TRAIN_SEQ, TRAIN_BATCH)
    parts, _ = dryrun.cell_bytes(cfg, shape, dryrun.StubMesh(
        (1, 1), ("data", "model")), dryrun.rules_for(cfg, False))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    init_fn, _ = build_train_step(build_model(cfg, device=dev),
                                  AdamWConfig())
    state, _ = init_fn(0)
    batch = TokenStream(cfg.vocab, TRAIN_BATCH, TRAIN_SEQ, seed=0,
                        device=str(dev)).next_batch()
    live = dict(params=nbytes(state["params"].values()),
                m=nbytes(state["m"].values()), v=nbytes(state["v"].values()),
                step=nbytes([state["step"]]), batch=nbytes(batch.values()))
    del state
    torch.cuda.empty_cache()
    if train_ref is not None:
        check(train_ref["state_bytes"] == live["params"] + live["m"]
              + live["v"] + live["step"],
              f"dryrun: lm_train's state {train_ref['state_bytes']} B vs "
              f"the built one {live}")
    check(parts == live, f"dryrun: (1, 1) argument bytes of lm_train's run "
                         f"{parts} vs the live state {live}")
    m11 = mesh11_decode(dev)
    check(m11["logits_bitwise"] and m11["tokens_equal"]
          and m11["cache_bitwise"] and not m11["collectives"],
          f"dryrun: a (1, 1) mesh decode is not the no-mesh decode: {m11}")
    launches = read_launches("dryrun", ())
    check(not any(launches.values()),
          f"dryrun: a kPCA kernel launched: {launches}")
    single = {k: v for k, v in cells.items() if v.get("ok")
              and v["mesh"] == "16x16"}
    out_rec = dict(
        cli=dict(args=list(DRYRUN_ARGS), rc=rc, seconds=cli_s, ok=n_ok,
                 skipped=n_skip, failed=failed),
        roofline=dict(rc=roof.returncode, rows=len(rows),
                      markdown=str(md.relative_to(ROOT))),
        flops_per_device_16x16={k: v["flops_per_device"]
                                for k, v in sorted(single.items())},
        argument_bytes_11=dict(dryrun=parts, live=live,
                               equal=parts == live,
                               lm_train_peak_alloc_gb=None if train_ref
                               is None else train_ref["peak"]),
        mesh11_decode=m11, launches=launches,
        phase_s=time.perf_counter() - t_phase)
    emit("dryrun", **out_rec)
    return out_rec


def decode_predictions(path: str, only=None) -> None:
    """The dry-run's argument bytes and one decode step's collectives (the
    fake backend, rank 0) for every run of ``decode_runs(only)``: a JSON
    file. Run in a process of its own (it makes a fake process group)."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import ShapeSpec
    from repro_torch.launch import dryrun
    res = {}
    for run in decode_runs(only):
        arch, layers, shape, b, prompt, max_len = run
        cfg = decode_cfg(arch, layers)
        spec = ShapeSpec("decode", "decode", max_len, b)
        parts, _ = dryrun.cell_bytes(cfg, spec, dryrun.StubMesh(
            shape, ("data", "model")), dryrun.rules_for(cfg, False))
        flops, _, colls = dryrun.measure(cfg, spec, False, mesh_shape=shape,
                                         axes=("data", "model"))
        res[run_key(run)] = dict(argument_bytes=parts, flops=flops,
                                 collectives=colls)
    Path(path).write_text(json.dumps(res))


def count_drops(into: list):
    """Wrap ``moe._dispatch`` so that each call appends (slots routed,
    slots over their expert's capacity) of the tokens it routes; returns
    the wrapped function, to put back."""
    import torch
    from repro_torch.models import moe
    orig = moe._dispatch

    def run(router, w_gate, w_up, w_down, cfg, x, first=0, repl=1):
        t = x.shape[0] * x.shape[1]
        ids, _, _ = moe._route({"router": router}, cfg, x.reshape(t, -1))
        per_expert = torch.bincount(ids.reshape(-1),
                                    minlength=cfg.n_experts)
        over = torch.clamp(per_expert - moe._capacity(t, cfg), min=0)
        into.append((ids.numel(), int(over.sum())))
        return orig(router, w_gate, w_up, w_down, cfg, x, first, repl)

    moe._dispatch = run
    return orig


def decode_rank(rank: int, world: int, store: str, tmp: str,
                only=None) -> None:
    """One rank of lm_decode_dist (a spawned process on card ``rank``):
    every run of ``decode_runs(only)`` on its mesh, fed the one-card run's
    tokens; rank 0 writes the logits (and, but for the drop run, those of
    the same run in fp32 through the widened weights); every rank its
    times, peak, live argument bytes, one bf16 decode step's collectives,
    a traced step, the drop run's dropped slots, and its kernel launches
    (counted from zero at its start)."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist
    from repro_torch.distributed.collectives import batch_axes_of
    from repro_torch.launch.dryrun import collectives_of
    from repro_torch.models import build_model, moe
    from repro_torch.train.loop import shard_place
    meshes = {shape: mesh_of(shape, store, rank, world)
              for shape in DIST_MESHES}
    dev = meshes[DIST_MESHES[0]].device
    feeds = torch.load(f"{tmp}/feeds.pt")
    zero_launches()
    res = {}
    try:
        with torch.no_grad():
            for run in decode_runs(only):
                arch, layers, shape, b, prompt, max_len = run
                key = run_key(run)
                cfg, mesh = decode_cfg(arch, layers), meshes[shape]
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                model = build_model(cfg, mesh=mesh)
                params, _ = model.init(DECODE_SEED,
                                       place=shard_place(model.shards()))
                batch = decode_batch(cfg, b, prompt, dev)
                drops = []
                orig = count_drops(drops) if run == DECODE_DROP_RUN \
                    else None
                try:
                    logits, _, pre_s, dec_s, counts, cache = greedy_run(
                        model, params, batch, max_len, feed=feeds[key],
                        mesh=mesh)
                finally:
                    if orig is not None:
                        moe._dispatch = orig
                dp = mesh.size(batch_axes_of(mesh))
                rows = b // dp if b % dp == 0 else b
                live = dict(params=nbytes(params.values()),
                            cache=nbytes(cache.shards), tokens=4 * rows,
                            cache_len=4)
                tok = feeds[key][-1].to(dev)[:, None].to(torch.int32)
                pos = prompt + DECODE_STEPS
                _, wall, trace = timed_and_traced(
                    torch, lambda: model.decode_step(params, cache, tok,
                                                     pos))
                res[key] = dict(
                    prefill_s=pre_s, decode_s=dec_s,
                    tokens_per_s=b * DECODE_STEPS / dec_s,
                    step=dict(wall_s=wall, **trace),
                    peak_alloc_gb=torch.cuda.max_memory_allocated() / 1e9,
                    argument_bytes=live,
                    collectives=collectives_of(counts),
                    slots_routed=sum(n for n, _ in drops),
                    slots_dropped=sum(d for _, d in drops))
                del cache
                saved = dict(bf16=logits)
                if run != DECODE_DROP_RUN:
                    # the same tokens through the widened weights, in fp32
                    wide = {k: v.float() for k, v in params.items()}
                    del params
                    torch.cuda.empty_cache()
                    m32 = build_model(fp32(cfg), mesh=mesh)
                    saved["fp32"], *_ = greedy_run(
                        m32, wide, batch, fp32_len(cfg, prompt, max_len),
                        feed=feeds[key], mesh=mesh, dtype=torch.float32)
                    del wide, m32
                if rank == 0:
                    torch.save(saved, f"{tmp}/mesh_{key}.pt")
                del model, saved
        torch.cuda.synchronize()
        launches = {name: getattr(w, attr)
                    for name, (w, attr) in launch_counters().items()}
        (Path(tmp) / f"decode_rank{rank}.json").write_text(json.dumps(
            dict(runs=res, launches=launches)))
    finally:
        dist.destroy_process_group()


def split_einsum(orig, tp: int):
    """``tok_einsum`` with the products of SPLIT_LABEL done in ``tp``
    blocks of the weight's label: output columns concatenated, or the
    blocks' partial products summed in rank order."""
    import torch

    def run(eq, x, w):
        lab = SPLIT_LABEL.get(eq)
        if lab is None:
            return orig(eq, x, w)
        ins, out = eq.split("->")
        xs, ws = ins.split(",")
        wd = ws.index(lab)
        xd = xs.index(lab) if lab in xs else None
        xparts = x.chunk(tp, xd) if xd is not None else [x] * tp
        parts = [orig(eq, xp, wp) for xp, wp in zip(xparts,
                                                    w.chunk(tp, wd))]
        if lab in out:
            return torch.cat(parts, out.index(lab))
        acc = parts[0]
        for part in parts[1:]:
            acc = acc + part
        return acc
    return run


def split_rms_norm(tp: int):
    """``common.rms_norm`` with the sum of squares taken in ``tp`` blocks
    of the last dim and the blocks' sums added in rank order: mamba2's
    gated RMSNorm as the mesh computes it (each rank's sum of its columns,
    all-reduced)."""
    import torch

    def run(x, weight, eps=1e-5):
        xf = x.float()
        parts = [(b * b).sum(-1, keepdim=True) for b in xf.chunk(tp, -1)]
        ss = parts[0]
        for part in parts[1:]:
            ss = ss + part
        out = xf * torch.rsqrt(ss / x.shape[-1] + eps)
        return (out * weight.float()).to(x.dtype)
    return run


@contextlib.contextmanager
def split_products(tp: int):
    """On one card, the products a mesh of ``tp`` "model" ranks splits
    (SPLIT_LABEL) done in its blocks, in every model module that computes
    them over a mesh: all but the MoE experts (dispatched whole, by
    expert); and mamba2's gated RMSNorm with its sum of squares split
    alike (mamba's ``rms_norm`` is that norm's alone)."""
    from repro_torch.models import attention, common, encdec, lm, mamba, mlp
    mods = [attention, encdec, lm, mamba, mlp]
    saved = [m.tok_einsum for m in mods]
    saved_norm = mamba.rms_norm
    for m in mods:
        m.tok_einsum = split_einsum(common.tok_einsum, tp)
    mamba.rms_norm = split_rms_norm(tp)
    try:
        yield
    finally:
        for m, f in zip(mods, saved):
            m.tok_einsum = f
        mamba.rms_norm = saved_norm


def fp32_len(cfg, prompt: int, max_len: int) -> int:
    """The fp32 run's cache slots: the prompt and the steps, rounded up to
    a 1024-slot attention chunk (llama3.2-3b's 32768 fp32 slots, held
    twice across a step, do not fit one card). A full-attention cache's
    slots past the last position are masked and add exact zeros, so the
    values are those of max_len slots; a sliding window's ring keeps
    max_len."""
    if cfg.attn_kind == "swa":
        return max_len
    return min(max_len, -(-(prompt + DECODE_STEPS) // 1024) * 1024)


def decode_references(dev, tmp: str, only=None) -> dict:
    """The one-card runs lm_decode_dist is held to: every distinct run of
    ``decode_runs(only)`` greedy in bf16 on card 0 (its tokens are what
    the ranks are fed), and, but for the drop run, the same tokens
    through the bf16 weights widened to fp32 (fp32 caches of ``fp32_len``
    slots): plainly, and as the split twin of each "model" size its
    meshes have above 1 (``split_products``). Saves the feeds for the
    ranks."""
    import torch
    from repro_torch.models import build_model
    runs = decode_runs(only)
    refs, feeds = {}, {}
    done = {}
    with torch.no_grad():
        for run in runs:
            arch, layers, shape, b, prompt, max_len = run
            key = run_key(run)
            one = (arch, layers, b, prompt, max_len)
            if one in done:
                refs[key], feeds[key] = refs[done[one]], feeds[done[one]]
                continue
            done[one] = key
            cfg = decode_cfg(arch, layers)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            model = build_model(cfg, device=dev)
            params, _ = model.init(DECODE_SEED)
            batch = decode_batch(cfg, b, prompt, dev)
            logits, toks, pre_s, dec_s, _, cache = greedy_run(
                model, params, batch, max_len)
            rec = dict(logits=logits, prefill_s=pre_s, decode_s=dec_s,
                       tokens_per_s=b * DECODE_STEPS / dec_s,
                       peak_alloc_gb=torch.cuda.max_memory_allocated() / 1e9)
            del cache
            if run != DECODE_DROP_RUN:
                wide = {k: v.float() for k, v in params.items()}
                del params
                torch.cuda.empty_cache()
                n32, c32 = fp32_len(cfg, prompt, max_len), fp32(cfg)
                rec["fp32"], *_ = greedy_run(build_model(c32, device=dev),
                                             wide, batch, n32, feed=toks,
                                             dtype=torch.float32)
                tps = sorted({r[2][1] for r in runs if r[:2] == run[:2]
                              and r[3:] == run[3:] and r[2][1] > 1})
                for tp in tps:
                    with split_products(tp):
                        twin, *_ = greedy_run(
                            build_model(c32, device=dev), wide, batch, n32,
                            feed=toks, dtype=torch.float32)
                    rec[f"twin_err_{tp}"] = float(
                        (twin - rec["fp32"]).abs().max())
                    del twin
                del wide
            refs[key], feeds[key] = rec, toks
            torch.cuda.empty_cache()
    torch.save(feeds, f"{tmp}/feeds.pt")
    return refs


def rel_l2(a, b) -> float:
    import torch
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b))


def decode_record(run, ref, got, got32, ranks, predicted) -> tuple:
    """(a run's record, whether it meets its gates)."""
    import torch
    key = run_key(run)
    want = ref["logits"]
    diff = (got - want).abs()
    rec = dict(
        mesh=list(run[2]), batch=run[3], prompt=run[4], max_len=run[5],
        steps=DECODE_STEPS, max_abs_err=float(diff.max()),
        max_abs_logit=float(want.abs().max()),
        worst_ratio_2e2=float((diff / (LM_TOL + LM_TOL * want.abs())).max()),
        greedy_agree=float((got[:-1].argmax(-1) == want[:-1].argmax(-1))
                           .float().mean()),
        rel_l2_to_one_card=rel_l2(got, want),
        one_card=dict(prefill_s=ref["prefill_s"], decode_s=ref["decode_s"],
                      tokens_per_s=ref["tokens_per_s"],
                      peak_alloc_gb=ref["peak_alloc_gb"]))
    ok = bool(torch.isfinite(got).all())
    if got32 is not None:
        tp = run[2][1]
        err32 = float((got32 - ref["fp32"]).abs().max())
        twin = ref[f"twin_err_{tp}"] if tp > 1 else 0.0
        gate32 = max(DECODE_FP32_TOL * max(
            1.0, float(ref["fp32"].abs().max())), FAM_BF16_RATIO * twin)
        mesh_d, one_d = rel_l2(got, ref["fp32"]), rel_l2(want, ref["fp32"])
        rec.update(fp32_max_abs_err=err32, fp32_twin_err=twin,
                   fp32_gate=gate32, rel_l2_to_fp32=mesh_d,
                   one_card_rel_l2_to_fp32=one_d,
                   bf16_gate=f"<= {FAM_BF16_RATIO} x one card + 1e-3")
        ok = ok and err32 <= gate32 and \
            mesh_d <= FAM_BF16_RATIO * one_d + 1e-3
    else:
        rec.update(slots_routed_by_rank=[r["runs"][key]["slots_routed"]
                                         for r in ranks],
                   slots_dropped_by_rank=[r["runs"][key]["slots_dropped"]
                                          for r in ranks])
    r0 = ranks[0]["runs"][key]
    pred_k = predicted[key]
    live_bytes = [r["runs"][key]["argument_bytes"] for r in ranks]
    bytes_eq = all(lb == pred_k["argument_bytes"] for lb in live_bytes)
    colls_eq = all(r["runs"][key]["collectives"] == pred_k["collectives"]
                   for r in ranks)
    rec.update(
        prefill_s=r0["prefill_s"], decode_s=r0["decode_s"],
        tokens_per_s=r0["tokens_per_s"], step_rank0=r0["step"],
        peak_alloc_gb_by_rank=[r["runs"][key]["peak_alloc_gb"]
                               for r in ranks],
        argument_bytes_live=live_bytes[0],
        argument_bytes_dryrun=pred_k["argument_bytes"],
        collectives_live=r0["collectives"],
        collectives_dryrun=pred_k["collectives"],
        flops_per_card_dryrun=pred_k["flops"],
        argument_bytes_equal=bytes_eq, collectives_equal=colls_eq)
    return rec, ok and bytes_eq and colls_eq


def phase_lm_decode_dist(dev, only=None) -> dict:
    """Prefill and decode over min(4, cards) NCCL ranks in spawned
    processes (``decode_rank``), every run of ``decode_runs(only)`` fed
    its one-card greedy tokens (``decode_references``) and held to one
    card: in fp32 (the bf16 weights widened, both sides) within the larger
    of DECODE_FP32_TOL * max(1, |ref|) and 1.25 x the split twin's
    distance from the plain card run; in bf16 by the families' rule, the
    mesh's relative L2 distance from the fp32 card within 1.25 x the bf16
    card's + 1e-3 (the 2e-2 reading recorded). The drop run records its
    dropped slots and its distance from one card, and has no parity gate.
    Also: the dry-run's per-card argument bytes and one decode step's
    collectives (``decode_predictions``, the fake backend, in a CPU-only
    child before any timed run) against the live ranks', equal; tokens/s,
    a traced step's device time and idle share, peak; no kPCA kernel
    launched, in the references or on any rank. On a host with fewer than
    4 cards it does not run, and says why."""
    import multiprocessing
    import torch
    t_phase = time.perf_counter()
    count = torch.cuda.device_count()
    if count < DIST_RANKS:
        reason = (f"{count} card(s) on this host: the (4, 1), (2, 2) and "
                  f"(1, 4) meshes need {DIST_RANKS} (run --phase "
                  f"lm_decode_dist on a four-card host)")
        print(f"chip_smoke: lm_decode_dist did not run: {reason}",
              file=sys.stderr, flush=True)
        emit("lm_decode_dist", ran=False, reason=reason)
        return dict(ran=False, reason=reason)
    world = DIST_RANKS
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        pred_rc, pred_s = run_cli(
            ("-c", "import sys; sys.path.insert(0, "
             f"{str(ROOT)!r}); import chip_smoke; "
             "chip_smoke.decode_predictions(sys.argv[1], "
             "sys.argv[2:] or None)", f"{tmp}/predictions.json",
             *(only or ())), f"{tmp}/predictions.log",
            DECODE_RANK_TIMEOUT_S)
        plog = Path(tmp, "predictions.log").read_text()[-2000:]
        check(pred_rc == 0,
              f"lm_decode_dist: the predictions' rc {pred_rc}: {plog}")
        if pred_rc != 0:
            emit("lm_decode_dist", ran=True, predictions_rc=pred_rc)
            return dict(ran=True, predictions_rc=pred_rc)
        zero_launches()
        t0 = time.perf_counter()
        refs = decode_references(dev, tmp, only)
        ref_s = time.perf_counter() - t0
        ref_launches = read_launches("lm_decode_dist references", ())
        torch.cuda.empty_cache()
        ctx = multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=decode_rank,
                             args=(r, world, f"{tmp}/store", tmp, only))
                 for r in range(world)]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        deadline = time.monotonic() + DECODE_RANK_TIMEOUT_S
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        ranks_s = time.perf_counter() - t0
        codes = [p.exitcode for p in procs]
        check(not hung and codes == [0] * world,
              f"lm_decode_dist: ranks {hung} hung, exit codes {codes}")
        if hung or codes != [0] * world:
            emit("lm_decode_dist", ran=True, exit_codes=codes, hung=hung)
            return dict(ran=True, exit_codes=codes, hung=hung)
        ranks = [json.loads(Path(f"{tmp}/decode_rank{r}.json").read_text())
                 for r in range(world)]
        launches = [ref_launches] + [r["launches"] for r in ranks]
        check(not any(v for c in launches for v in c.values()),
              f"lm_decode_dist: a kPCA kernel launched (references, then "
              f"each rank): {launches}")
        predicted = json.loads(Path(f"{tmp}/predictions.json").read_text())
        runs = {}
        for run in decode_runs(only):
            key = run_key(run)
            saved = torch.load(f"{tmp}/mesh_{key}.pt")
            rec, ok = decode_record(run, refs[key], saved["bf16"],
                                    saved.get("fp32"), ranks, predicted)
            check(ok, f"lm_decode_dist {key}: {rec}")
            del saved
            runs[key] = rec
        out = dict(ran=True, world=world, runs=runs, only=only,
                   predictions_s=pred_s, reference_s=ref_s,
                   ranks_s=ranks_s, launches=launches,
                   phase_s=time.perf_counter() - t_phase)
    emit("lm_decode_dist", **out)
    return out


def warm_start_split(vec, lam, x_nodes, alpha_gt, spec, gamma) -> int:
    """Nodes whose init="local" warm start v1/sqrt(lam1) points against the
    central component, counted on the smaller side (the global sign is
    arbitrary; only a split between nodes slows the consensus)."""
    import torch
    from repro_torch.core.kernels_math import center_gram_global, gram
    pooled = x_nodes.reshape(-1, x_nodes.shape[-1])
    k_g = gram(spec, pooled, gamma=gamma)
    neg = 0
    for j in range(x_nodes.shape[0]):
        a0 = vec[j, :, -1] / torch.sqrt(lam[j, -1])
        k_jx = gram(spec, x_nodes[j], pooled, gamma=gamma)
        kc = center_gram_global(k_jx, k_jx, k_g, k_g)
        neg += int(float(a0 @ kc @ alpha_gt) < 0)
    return min(neg, x_nodes.shape[0] - neg)


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description="chip smoke test of the port")
    ap.add_argument("--phase", choices=("all", "dkpca", "lm_families",
                                        "lm_train_dist", "dryrun",
                                        "lm_decode_dist"),
                    default="all",
                    help="dkpca: the build, the fit it is held to and the "
                         "ring fit alone (its multi-card part on a "
                         "four-card host); lm_families: the build and the "
                         "ssm, hybrid and audio families alone; "
                         "lm_train_dist: the build and the four-card "
                         "training meshes alone; dryrun: the build and the "
                         "dry-run alone; lm_decode_dist: the build and "
                         "the four-card decode meshes alone")
    ap.add_argument("--runs", default=None,
                    help="lm_decode_dist: only the runs of these configs "
                         "(comma-separated names), to recheck some of "
                         "them without the others")
    args = ap.parse_args(argv)
    phase = args.phase
    only = None if args.runs is None else tuple(args.runs.split(","))
    only_dkpca = phase == "dkpca"
    import torch
    if not torch.cuda.is_available():
        raise SmokeFailure("torch sees no CUDA device")
    if not (ROOT / "src" / "repro_torch").is_dir():
        raise SmokeFailure(f"no src/repro_torch beside {Path(__file__).name}:"
                           f" run it from a checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    dev = torch.device("cuda")

    # -- device --------------------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = smi_line()
    emit("device", kind=kind, count=count, nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)

    # -- build ---------------------------------------------------------------
    from repro_torch.kernels import _build
    info = _build.build(force=True)
    _build.load_library()
    usage = [ln.split("info    : ", 1)[-1] for ln in info.log.splitlines()
             if "Used" in ln or "spill" in ln]
    # gram and project must run on the tensor cores: wgmma is HGMMA in SASS
    sass = subprocess.run(
        [str(Path(_build.nvcc_path()).parent / "cuobjdump"), "-sass",
         str(info.path)], capture_output=True, text=True, timeout=120).stdout
    hgmma = hgmma_by_function(sass)
    emit("build", seconds=info.seconds, library=str(info.path.relative_to(
        ROOT)), sources=[str(p.relative_to(ROOT)) for p in _build.sources()],
        ptxas=usage, hgmma_instructions=sum(hgmma.values()),
        hgmma_by_function=hgmma)
    for kernel in ("gram_mma_kernel", "gram_split_kernel",
                   "project_partials_kernel"):
        check(any(kernel in f and n > 0 for f, n in hgmma.items()),
              f"no wgmma (HGMMA) instruction in {kernel}")

    if phase in ("lm_families", "lm_train_dist", "dryrun", "lm_decode_dist"):
        if phase == "lm_families":
            from repro_torch.core import KernelSpec
            phase_lm_families(dev, KernelSpec(kind="rbf"))
        elif phase == "lm_train_dist":
            phase_lm_train_dist(dev)
        elif phase == "dryrun":
            phase_dryrun(dev)
        else:
            phase_lm_decode_dist(dev, only)
        if FAILURES:
            raise SmokeFailure(f"{len(FAILURES)} check(s) failed: "
                               f"{FAILURES}")
        print(smi, flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind, "count": count}}), flush=True)
        return 0

    from repro_torch.core import (KernelSpec, build_setup, central_kpca,
                                  local_kpca, neighborhood_kpca, oos, ring,
                                  run_admm, run_admm_topk)
    from repro_torch.core.kernels_math import resolve_gamma
    from repro_torch.data import kpca_dataset, node_dataset
    spec = KernelSpec(kind="rbf")
    nodes, pooled = node_dataset(20, 100, m=784, seed=0)

    # -- kernels -------------------------------------------------------------
    gamma = resolve_gamma(spec, torch.as_tensor(pooled, device=dev))
    records = None if only_dkpca else phase_kernels(dev, spec, nodes,
                                                    pooled, gamma)

    # -- main path: fit, then serve (launch counts zeroed just before) -------
    zero_launches()
    t0 = time.perf_counter()
    setup = build_setup(nodes, ring(20, hops=2), spec, center="global",
                        device=dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    res = run_admm(setup, n_iters=30)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    alpha_gt, lam_gt, _ = central_kpca(pooled, spec, 1, gamma=setup.gamma,
                                       device=dev)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    x_nodes = setup.x
    pooled_t = x_nodes.reshape(2000, 784)
    sims = {}
    for it in (1, 10, 30):
        sims[it] = mean_similarity(res.alpha_hist[it - 1], x_nodes,
                                   pooled_t, alpha_gt[:, 0], spec,
                                   setup.gamma)
    # init="local" keys on the node Grams' eigenvector signs: the eigh
    # kernel's against LAPACK's on the same matrices, and how many nodes' warm starts
    # point against the central component under each (on the CPU, so no
    # kernel launch of this diagnostic counts as the main path's).
    k_cpu = setup.k.cpu()
    lam_cpu, vec_cpu = torch.linalg.eigh(k_cpu)
    agree = int(torch.sum(torch.einsum(
        "jn,jn->j", setup.vec[:, :, -1].cpu(), vec_cpu[:, :, -1]) > 0))
    split = {src: warm_start_split(vec.cpu(), lam.cpu(), x_nodes.cpu(),
                                   alpha_gt[:, 0].cpu(), spec,
                                   setup.gamma.cpu())
             for src, vec, lam in (("card", setup.vec, setup.lam),
                                   ("cpu", vec_cpu, lam_cpu))}
    check(bool(torch.isfinite(res.alpha_hist).all()), "non-finite alpha")
    emit("fit", nodes=20, per_node=100, features=784, neighbors=4,
         iterations=30, gamma=float(setup.gamma),
         similarity_mean={str(k): v[0] for k, v in sims.items()},
         similarity_min={str(k): v[1] for k, v in sims.items()},
         primal_residual_30=float(res.primal_residual[-1]),
         central_lambda1=float(lam_gt[0]),
         eigh_top_sign_agrees_with_cpu=f"{agree}/20",
         warm_starts_against_the_rest=split,
         setup_s=t1 - t0, admm_s=t2 - t1, central_s=t3 - t2)
    check(sims[30][0] >= SIM30_MIN,
          f"similarity@30 {sims[30][0]:.4f} < {SIM30_MIN}")
    if only_dkpca:
        phase_dkpca(dev, spec, nodes, setup, res.alpha, alpha_gt[:, 0])
        if FAILURES:
            raise SmokeFailure(f"{len(FAILURES)} check(s) failed: "
                               f"{FAILURES}")
        print(smi, flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind, "count": count}}), flush=True)
        return 0

    model = oos.from_decentralized(nodes, res.alpha, spec,
                                   gamma=setup.gamma, device=dev)
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as ckpt:
        oos.save_fitted(ckpt, model)
        loaded = oos.load_fitted(ckpt, device=dev)
    check(torch.equal(loaded.coefs, model.coefs)
          and torch.equal(loaded.x_support, model.x_support),
          "save_fitted/load_fitted round trip changed the model")
    compressed, rel_err = oos.compress(loaded, 500, seed=0)
    sizes = (3, 17, 64, 128, 200)
    requests = [kpca_dataset(q, m=784, seed=100 + q) for q in sizes]
    serve = serve_requests(dev, (("full", loaded),
                                 ("compressed", compressed)), requests,
                           "serve")
    launches = read_launches("fit and serve", ("gram", "project", "center",
                                               "admm_step", "eigh"))
    check(launches["eigh"] == 1 and launches["eigh_library"] == 0,
          f"fit and serve: eigh launches {launches['eigh']} (1, the one "
          f"build_setup), library eigensolves {launches['eigh_library']} (0)")
    emit("serve", requests=list(sizes), models=serve,
         compress_rel_err=float(rel_err[0]), launches=launches)

    # -- the paper's baselines, then top-k (each path its own counts) -------
    path_launches = {
        "fit_and_serve": launches,
        "baselines": phase_baselines(dev, spec, setup, alpha_gt[:, 0],
                                     sims[30]),
        "topk": phase_topk(dev, spec, setup, nodes, requests)}

    # -- where the time goes: each phase once more, warm, timed and then
    # traced (after the launch counts were read, so none of this counts) -----
    emit("breakdown", **{name: phase_breakdown(torch, fn, name == "admm")
                         for name, fn in {
        "setup": lambda: build_setup(nodes, ring(20, hops=2), spec,
                                     center="global", device=dev),
        "admm": lambda: run_admm(setup, n_iters=30),
        "central": lambda: central_kpca(pooled, spec, 1, gamma=setup.gamma,
                                        device=dev),
        "baselines": lambda: (
            local_kpca(setup.x, spec, gamma=setup.gamma, device=dev),
            neighborhood_kpca(setup.x, ring(20, hops=2), spec,
                              gamma=setup.gamma, device=dev)),
        "topk": lambda: run_admm_topk(setup, k=2, n_iters=30),
    }.items()})
    served = (("full", loaded), ("compressed", compressed))
    sync = phase_serve_stream(dev, served)
    path_launches["serve_async"] = phase_serve_async(dev, served, sync)
    path_launches["serve_sharded"] = phase_serve_sharded(dev, loaded)
    path_launches["faults"] = phase_faults(dev, spec, nodes, loaded)
    path_launches["dkpca"] = phase_dkpca(dev, spec, nodes, setup, res.alpha,
                                         alpha_gt[:, 0])
    path_launches["serve_kpca"] = phase_serve_kpca()
    path_launches["autotune"] = phase_autotune(dev, spec)
    path_launches["lm_serve"] = phase_lm_serve(dev)
    path_launches["lm_train"], train_ref = phase_lm_train(dev, spec)
    path_launches["lm_train_mesh"] = phase_lm_train_mesh(dev, train_ref)
    path_launches["lm_families"] = phase_lm_families(dev, spec)
    phase_lm_train_dist(dev)
    phase_lm_decode_dist(dev)
    phase_dryrun(dev, train_ref)
    del train_ref
    check("jax" not in sys.modules and not any(
        k == "repro" or k.startswith("repro.") for k in sys.modules),
        "the JAX package was imported")

    if FAILURES:
        raise SmokeFailure(f"{len(FAILURES)} check(s) failed: {FAILURES}")

    # -- summary -------------------------------------------------------------
    summary = []
    for name, src, replaces, idx in (
            ("gram", "src/repro_torch/kernels/csrc/gram.cu",
             "src/repro/kernels/gram/gram.py:70", 0),
            ("project", "src/repro_torch/kernels/csrc/project.cu",
             "src/repro/kernels/project/project.py:92", 3),
            ("admm_step", "src/repro_torch/kernels/csrc/admm_step.cu",
             "src/repro/kernels/admm_step/admm_step.py:50", 0),
            ("center", "src/repro_torch/kernels/csrc/center.cu",
             "src/repro/kernels/centering/centering.py:29", 0),
            ("eigh", "src/repro_torch/kernels/csrc/eigh.cu",
             "none (the JAX package calls jnp.linalg.eigh; on the card it "
             "takes cuSOLVER's place)", 0)):
        r = records[name][idx]
        summary.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=launches[name],
            launches_by_path={p: c.get(name) for p, c in
                              path_launches.items()},
            max_abs_err=max(x["max_abs_err"] for x in records[name]),
            tolerance=TOL,
            ms=r["ms"], device_ms=r["device_ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
            shape=r["shape"],
            **({"bound_fp32_ms": r["bound_fp32_ms"],
                "matmul_ms": r["matmul_ms"]} if name in ("gram", "project")
               else {})))
    # gram's and project's bf16 instances (bf16 operands, the served bf16
    # slabs), and project's launches by kind on every path
    keys = ("shape", "max_abs_err", "bitwise_vs_widened_fp32", "ms",
            "device_ms", "plain_ms", "bound_ms", "bound_by")
    summary[0]["bf16"] = {k: records["gram_bf16"][0][k] for k in keys}
    bf16 = records["project_bf16"][1]
    summary[1]["bf16"] = {k: bf16[k] for k in keys}
    summary[1]["launches_by_kind"] = {
        p: {k: c.get(f"project_{k}") for k in ("bf16", "partial",
                                                "support")}
        for p, c in path_launches.items()}
    print(json.dumps({"kernels": summary}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
