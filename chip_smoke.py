#!/usr/bin/env python3
"""Drive the PyTorch/H100 port on one CUDA card: the predict forward, the train step,
the predict CLI, view-parallel predict, tensor- and view-parallel training,
token-space training, the test CLI, the scoring daemon, the native host
input path and the data-parallel CLIs.

    python3 chip_smoke.py                  # from the repository root, one card
    python3 chip_smoke.py --kernels-only   # steps 1-3 only, no result lines

In order:
1. print the card's name and power limit (``nvidia-smi``);
2. build the kernels from ``crossscore_tpu_torch/csrc/`` (one ``nvcc`` per
   source, all at once) and print the build time, each kernel's registers
   and spills, and for the bf16 wgmma kernels (the forward's, the
   backward's, the fused MLP's) their static shared memory, any wgmma ptxas
   serialised (C7515 and the other notes that say so), each head dim's tile
   plan and the fused MLP's plan at D 64 and 384 (rows a block, the
   cluster, the hidden chunk, the ring stages, dynamic shared memory, W1/W2
   bytes read from L2 per 1000 rows and at the predict point); fail on a
   spill or a serialised wgmma in the forward at hd 48 or 64 or in the
   fused MLP, on a plan above the block's shared memory, or on MLP weight
   reads above half of what 64-row blocks that each read them would take;
3. hold K1 (backbone self-attention), K2 (fused LN->MLP) and K3 (decoder
   attention) against their plain PyTorch versions at the predict shapes
   (dinov2-small, 518 px, K=8 references, B=8; K2 also timed beside the
   unfused chain of PyTorch calls, a yardstick), K2 (tanh and exact) and
   K10 on the bf16 body at D 64 and 384 over 1, 63, 65, 127, 129, 255, 257
   and 2741 rows, each launched twice for the same bits, K4 (decoder attention
   backward) at the train shapes (B=24, K=5), and K5 and K6 (the masked
   forwards of shape-bucketed inference) at the bucketed predict shapes
   (540x960 images -> 518x921 -> a 560x1008 bucket, B=8, K=5; per-item and
   shared token biases), and K7 (the head-major forward) at the
   view-parallel shapes (q (8, 8, 1369, 48) over Nk 5476 and 1369, with and
   without a shared bias, on contiguous tensors and on head-major views; and
   at the tp train step's backbone shape, q/k/v (144, 6, 1370, 64), on
   views and contiguous, by o, l and m), and
   K8/K9 (the head-major backward) at the tp train step's shapes (q (24, 8,
   1369, 48) over Nk 1369 and 6845; TP = 2's local 4 heads), at the
   view-parallel shard fed the global statistics (Nk 5476 of 10952) and at
   the backbone's hd 64 (N 1370), on head-major views and on contiguous
   tensors, in bf16 and fp32 (and at the other presets' head dims and widths
   at small shapes, K4 and K8/K9 at every head dim 16-128 and K4, K8 and K9
   at ragged and tiny lengths, Nq 1, 63, 65 over Nk 1, 65, 2049, views and
   contiguous; K1 and K2 (tanh and exact) at the token cache's encode shape,
   qkv (16, 1939, 1152) and x (16, 1939, 384): 532x714 images, 38x51 patches
   and CLS; K4-K9 by the relative L2 error of each output; the backward
   launched twice on the same inputs must give the same bits; the forward
   K1, K3 and K7, views and contiguous, at every head dim 16-128, and K1,
   K3, K5, K6 and K7 at the same ragged lengths at hd 48 and 128, K5 and K6
   with a bias that masks a third of the columns, each held by the relative
   L2 of each of o, l and m, as K1 and K3 also are at their main shapes, and
   launched twice for the same bits), and time
   the kernel, the plain version
   and, for the attention kernels, one ``F.scaled_dot_product_attention``
   call (K4, K8, K9: one backward of it; K5/K6: with the bias as a float
   mask) on the same inputs (a yardstick only; the port never calls it), and
   K4 on the same work as K8/K9; and the timing instruments of the sixth
   slice, which no model path reaches: K10 (LN -> MLP with the attention
   residual folded in) at x (72, 1370, 384), bf16 and fp32, timed beside the
   residual add and K2, its backward at B=1; K11 (K1's probes nomax, nosum,
   mxu and its split-KV chunks 2 and 3) at qkv (72, 1370, 1152) beside K1;
   K7' (mxuprobe, noexp, bf16exp) at the backbone and the decoder shape
   beside K7; K12 (the backward's products without exponentials) at the TPU
   tool's four geometries. The wrong-math modes are held by the relative L2
   of each output;
4. run the full-width forward through ``make_predict_step`` (dinov2-small,
   518 px, K=8, B=8, bf16, seeded random weights) with the launch counters
   zeroed, check the score map and that the forward launched 12 / 12 / 4 / 0
   kernels, and time it with CUDA events;
5. run the net again at B=1 with every kernel replaced by its plain version
   and bound the score-map difference, in bf16 and fp32;
6. run the full-width train step through ``make_train_step`` (B=24, K=5,
   bf16 compute, fp32 master weights) with the counters zeroed: 12 / 12 / 4 /
   4 launches, a finite loss, the decoder and head changed, the backbone and
   PE bit-identical; time it, read its peak memory and print its device-time
   breakdown (``torch.profiler``);
7. compare the whole-step gradients at B=1, kernels against the all-plain
   path, in fp32 and bf16;
8. run the train CLI (``tasks/train.py``) at dinov2-small width on a seeded
   synthetic dataset for a few steps at B=2, then resume it from its
   checkpoint;
9. run the predict CLI (``tasks/predict.py``) at full width (dinov2-small,
   518 px short side, B=8, K=5, bf16, a seeded Lightning checkpoint) over a
   seeded 540x960 query/reference pair of directories four times: buckets
   off and on, each with the reference-token cache off and on. Check the
   kernels each mode launches, the cache's misses, and that the valid region
   of every score map agrees across the four runs; print maps/s with the
   loader in the loop;
10. view-parallel predict, on the one card: (i) the context-parallel op
    over one NCCL rank at the full shape against local K7; (ii) the fp32 B=1
    forward (K=8) on two gloo ranks that share the card against the
    single-process all-plain net; (iii) the predict CLI on two such ranks
    (``model.gpu.view_parallel=on``, K=8 over a pool of 8 references, B=8,
    3 batches of 518x518 images), uncached and cached: launches and cache
    misses per rank, the same maps on both ranks, and the written maps
    against the single-rank CLI; maps/s of two ranks time-slicing one card;
11. tensor-parallel training over one NCCL rank (TP = 1): the full-width
    train step on the ``tp`` route (B=24, K=5, bf16 compute): launches (K7
    16, K8 2, K9 2, K2 12, the rest 0), a loss within the bf16 bound of the
    ``flash`` route's on the same weights and batch, the decoder and head
    updated and the backbone and PE bit-identical, ms/step, peak memory and
    the device breakdown; and the context-parallel backward over the same
    rank against local K9;
12. two gloo ranks sharing the card: (i) TP = 2, an fp32 B=1 step (K=5)
    whose gathered gradients and updated parameters are held against the
    single-process all-plain step (at the same L1 subgradient), and a bf16
    B=2 step whose loss is held against the one-rank ``tp`` route's; (ii)
    view-parallel training, an fp32 B=1 backward (K=8, the PE trainable)
    whose every trainable gradient on each rank is held against the
    single-process all-plain net's; launches and ms/step per rank (two ranks
    time-slicing one card: not a scaling number);
13. drive the instruments through their entry points: K10's op forward and
    backward, ``tools.attn_microbench`` at the backbone and the decoder
    shape, ``tools.lane_pad_probe``, ``tools.bwd_microbench`` (K4 at the
    train shape, hd 64 and 48) and ``tools.mlp_microbench`` (the unfused
    chain and K2 at the predict point), each with the counts zeroed just
    before it and read just after: every mode launched, K4 by
    ``bwd_microbench``, K2 by ``mlp_microbench``, every run exit 0;
14. token-space training: (i) the full-width token step through
    ``make_train_step`` (B=24, K=5, 1369-token windows, bf16 compute, fp32
    master weights) with the counters zeroed: K3 4 and K4 4 launches and no
    other, a finite loss, the decoder and head changed, the backbone and PE
    bit-identical; time it, read its peak memory and print its device-time
    breakdown; (ii) at B=1, fp32 and bf16, the token graph on tokens encoded
    from the same 518 px crops against the pixel graph, and against the
    all-plain token graph (score-map MAE and every gradient leaf, the bounds
    of steps 5 and 7); (iii) the train CLI with ``train_recipe=token_fast``
    on step 8's synthetic tree (540x720 images, encoded whole at 532x714:
    1939 tokens; pools of 4 and 3 references, padded to K=5 with the empty
    placeholder), B=2, 2 steps and a resume
    to 4: K4 4 a step, K3 4 a step
    and a validation batch, K1 and K2 12 a call of the encoder (cache misses)
    or a validation batch, both counted; (iv) ``tasks.encode_tokens`` into a
    store (the images and the placeholder), then a ``token_fast`` run on it
    whose encoder is never called and whose K1/K2 launches are validation's
    alone;
15. run the test CLI (``tasks/test.py``: dinov2-small, bf16, 518 px short
    side, B=8, K=5, seeded weights) over seeded NVS trees of 540x720 renders
    (20 test frames: 3 batches, the last partial) and, with a third test
    scene of 720x540 renders, for the bucketed modes, in four modes: (a)
    buckets off, cache off; (b) cache on, then again on its warm disk store;
    (c) buckets and cache on; (d) buckets on, cache off. Check each mode's
    launches (K1/K2/K3 or K5/K2/K6, the cache's misses counted), one
    ``metrics.csv`` row per batch and a finite ``mean`` row, the misses
    (the reference pool; 0 on the warm store), the mean losses against (a)
    and (d) against (c); one bucketed batch at B=1 through
    ``make_eval_step`` on the kernels against the all-plain net, bf16 and
    fp32; ``summarise_score_gt`` paired row for row with the predicted
    summary; print maps/s per mode over the whole run and each mode's
    device step alone;
16. the scoring daemon (``tasks/serve.py``; dinov2-small, 518x518, K=8,
    bf16, seeded weights): (a) the warm-cache step alone through
    ``make_predict_step_cached`` at B=8, timed (median of 5 CUDA-event steps,
    the spread, the peak memory) on per-item tokens and on the daemon's one
    token set broadcast to the batch (the same bits as its contiguous copy),
    K1 12, K2 12 and K3 4 launches and no other, and at B=1 against the
    uncached step and the all-plain cached net, bf16 and fp32; (b) the
    daemon in this process on an ephemeral port (8 references, micro-batches
    of up to 8): its startup and launches, ``/healthz``, one ``map=npy``
    map against the predict CLI's on the same query and references, the
    load bench at 1, 4 and 8 workers x 16 requests (req/s, p50/p95/p99, the
    dispatches and launches per dispatch), a reload to seed 1's weights in
    the middle of a storm, and the typed 503s of a full queue; (c) the CLI
    in a child process: SIGTERM in the middle of a storm with a request in
    flight (every accepted request 200, the later ones a typed 503,
    ``/livez`` 200 and ``/healthz`` 503 during the drain, exit 0), then a
    warm-up-only run on the token store the first run filled;
17. the native host input path (``data/fastimage.py``, ``data/records.py``,
    the decode skip): (a) build ``csrc/fastimage.cpp`` with g++ (its
    version, whether ``png.h`` is found, the seconds) and decode a seeded
    540x960 PNG natively against the Pillow path: float32 resized to a short
    side of 518 and trimmed to whole patches, the uint8 wire cropped and
    resized, and a ``CSRT`` payload of it (the cropped wire and every
    ``CSRT`` decode bit-equal; a missing ``png.h`` is printed and the rest
    runs on Pillow, any other build error fails); (b) the predict CLI on
    step 9's renders and pool (B=8, K=5, unbucketed), uncached and cached,
    from files on Pillow (``CROSSSCORE_NO_NATIVE=1``) and natively and from
    the shards of ``data.pack`` and ``data.pack --decoded``: launches as in
    step 9, hits + decode-skips + the miss batch's slots = the reference
    slots, decode-skips above 0 with the skip on, the maps byte-equal
    between one decoder's sources and within MAE 1e-2 of Pillow's, maps/s;
    (c) the test CLI, cached, from decoded shards against files: the
    ``metrics.csv`` mean within 1e-6; (d) the ``token_fast`` CLI on step
    14's warm store with the skip: no encoder call, no image of the train
    split decoded (score maps only), every slot that holds an image
    decode-skipped, the losses within 1e-6 of a Pillow run's; (e)
    ``tools.ingest_bench`` and ``tools.token_assembly_bench`` (the loader's
    retained malloc arena, and glibc's defaults), beside the host's CPU
    count;
18. data parallelism on two gloo ranks that share the card (one node):
    (a) the train CLI (dinov2-small, 518 px crops, bf16, K=5, B=4 a step,
    2 a rank) for 4 steps with validation and a checkpoint at step 2: per
    rank per step K1 12, K2 12, K3 4, K4 4 (and a validation batch's), the
    step's loss on both ranks the logged global one, the parameters'
    sha256 equal across ranks, one checkpoint set written by rank 0, a
    resume from step 2 within 1e-6 of the uninterrupted run; then fp32, 2
    ranks x B=1 against one rank x B=2 for 2 steps (losses 1e-5, parameters
    2e-5); ms/step and the gradient all-reduce's ms per rank, reported
    only; (b) ``token_fast`` on step 14's warm store: no encoder call, K3 4
    and K4 4 a step per rank, the losses equal on both ranks; (c) the test
    CLI, modes (a) and (c), against one rank: the same rows within 1e-2, the
    mean the rows' weighted mean, each rank's misses the pools of its
    blocks; (d) the predict CLI, modes (b) and (d), data parallel against
    one rank: the same file names, maps within MAE 1e-2, maps/s per rank;
    (e) ``tools.dryrun_multichip 4`` through its entry point: exit 0;
19. print one ``{"kernels": [...]}`` line, then, last, the device line.

Exits non-zero, printing no result, without a CUDA card or outside the
repository. No JAX is imported.
"""

from __future__ import annotations

import contextlib
import json
import re
import sys
import time
from pathlib import Path

SEED = 0
B, K, HW = 8, 8, 518  # predict operating point: 72 backbone views of 1370 tokens
PREDICT_ROWS = B * (1 + K) * ((HW // 14) ** 2 + 1)  # the backbone MLP's rows there: 98,640
TB, TK = 24, 5  # train operating point (config/data/combined_training.yaml): 144 views
# bucketed predict (config/data/SimpleReference.yaml, B=8, K=5): 540x960 images
# resize to 518x921 (a 37x65 patch grid) and pad to the 560x1008 bucket (40x72)
PB, PK, PHW, BUCKET_GRID = 8, 5, (540, 960), (40, 72)
# valid grids mixed in one bucket-packed batch: 16.5% and 16.7% of the columns masked
VALID_GRIDS = ((37, 65), (40, 60))
# view-parallel predict at B=8, K=8: each rank's KV length, 4*1369 on 2 ranks
# and 1369 on 8
VP_NK = (4 * 1369, 1369)
# K8/K9 at the main-path shapes: name -> (B, heads, Nq, Nk, hd, the global
# Nk whose (o, l, m) feed the backward or None): the tp train step's decoder
# at TP = 1 (self-attention over 1369 keys: K8; cross-attention over 5*1369:
# K9) and at TP = 2's local 4 heads; the view-parallel cross-attention's shard
# of 4*1369 keys fed the global statistics of 8*1369 (the CP backward). And
# the backbone's self-attention at hd 64, N 1370: in the JAX package the
# backbone's tp route calls the same custom_vjp, so K8 is its backward there;
# both packages freeze the backbone, so no main path of either runs K8 at this
# shape (the port's backbone runs K7 forward only, held at its own shape)
K89_SHAPES = {
    "K8": (TB, 8, 1369, 1369, 48, None),
    "K9": (TB, 8, 1369, TK * 1369, 48, None),
    "K8 tp2": (TB, 4, 1369, 1369, 48, None),
    "K9 tp2": (TB, 4, 1369, TK * 1369, 48, None),
    "K9 cp shard": (B, 8, 1369, 4 * 1369, 48, 8 * 1369),
    "K8 backbone": (B, 6, 1370, 1370, 64, None),
}

# least time the card could take: the larger of ops / peak and bytes / rate,
# and for attention of its exponentials / the special-function units' rate.
# Dense peaks from NVIDIA's data sheets (bf16 tensor cores, fp32 CUDA cores);
# exp2 rates: 3.9 T/s on the SXM part (FlashAttention-3, arXiv 2407.08608,
# section 1: 16 a clock on each of 132 SMs), the others at 16 a clock per SM
# at their boost clocks.
PEAKS = {  # name fragment: (bf16 op/s, fp32 op/s, bytes/s, exp2/s)
    "H100 PCIe": (756e12, 51e12, 2.0e12, 114 * 16 * 1.755e9),
    "H100 NVL": (835e12, 60e12, 3.9e12, 132 * 16 * 1.785e9),
    "H100": (989e12, 67e12, 3.35e12, 3.9e12),  # SXM
}

# kernel-vs-plain tolerances at the main-path shapes: the largest of
# |kernel - plain| / (1 + |plain|) over o (or out), m and l.
# fp32: both sides are full fp32 and differ by summation order and exp2 ulps.
# bf16: the kernels round p to bf16 before P.V (as the TPU kernels do) and
# every output is rounded to bf16 once (2^-8 relative): two bf16 ulps.
TOL = {"float32": 5e-5, "bfloat16": 1.6e-2}
# K4: the largest relative L2 error ||kernel - plain|| / ||plain|| of dq, dk
# and dv, each against its own scale (the gradients are ~1e-2, so a bound
# relative to 1 + |plain| would be as large as they are). On the H100 the
# sound kernel reads at most 2.5e-4 in bf16 (p and ds rounded to bf16 before
# the products, where exp2 on the special-function unit flips some roundings)
# and 6.7e-7 in fp32 (summation order); a ds scale 3% off reads 3.0e-2, a
# dropped ragged last KV tile 9.7e-2 and a dropped last q tile 0.13 (PERF.md).
TOL_K4 = {"float32": 1e-5, "bfloat16": 2e-3}
# K8/K9 are held as K4 (relative L2 of dq, dk, dv; TOL_K4): the same recipe,
# read through head strides.
# K5/K6: besides TOL, the largest relative L2 error of o, l and m, each
# against its own scale. At the cross shape o is ~0.015 (about 12000 valid
# random keys), where an o 15% off reads 1.72e-2 by TOL's measure, just over
# its bound. On the H100 the sound kernels read at most 3.12e-3 in bf16 (o,
# rounded to bf16 once on each side) and 2.80e-6 in fp32; o 15% off reads
# 0.150 and a kernel that ignores the bias 0.30-0.52 (PERF.md).
TOL_L2 = {"float32": 2e-5, "bfloat16": 8e-3}
# the CP op over one rank against local K7: o * l / l in fp32, rounded back
# once; any difference is an fp32 ulp turned into a bf16 rounding flip. The
# CP backward over one rank against local K9 (relative L2 of dq, dk, dv):
# the same kernel fed the combine's o, l and m
VP_ONE_RANK_TOL = 1e-5
# tp train step, bf16: the score maps' MAE against the flash route's on the
# same weights and batch (TP = 1), and each TP = 2 rank's against the one-rank
# tp route's; the losses too, whose difference the maps' MAE bounds. On the
# H100 the sound readings are 0 (TP = 1: bit-equal maps) and about 1e-3
# (TP = 2: the row-parallel partial sums round in bf16 before their sum); a
# TP = 2 whose in_proj shards pair each rank's q heads with the other's k/v
# reads 0.133 (PERF.md)
TP_MAP_TOL = 5e-3
# TP = 2 and view-parallel training, fp32 B=1 at full width: the worst leaf's
# relative L2 gradient error against the all-plain net run at the two-rank
# run's own L1 subgradient and ReLU gates (phase 12). On the H100 the sound
# readings are of order 1e-6 (fp32 summation order); a copy-to-group backward
# without its all-reduce reads 0.89 (TP = 2) and 0.50 (view-parallel), the
# mispaired in_proj shards 1.35 (PERF.md)
PINNED_GRAD_TOL = 1e-5
# the same against the all-plain net at its own gates: fp32 rounding moves the
# decoder's activations by ~1e-7 and flips the gate of the ReLU inputs that
# lie that close to 0; a flip moves one row of linear1's gradient by one
# token's share and the PE's gradient at one position by one view's share.
# A bound on what the flips may cost, the witness of the tight check above
TWO_RANK_GRAD_TOL = 5e-3
# TP = 2, fp32: the parameters after one AdamW step on the model ranks'
# shards, gathered, against the single-process AdamW on the same gathered
# gradients, over every element (JAX's TP tolerance)
TP_PARAM_ATOL = 2e-5
# K10's backward at B=1: the reference recompute on both sides (K10's forward
# feeds it nothing but the saved inputs), so the gradients agree bit for bit;
# held by the worst relative L2 of the ten
K10_BWD_TOL = 1e-6
# K11's probes and K7' (wrong math, unnormalised outputs): the relative L2 of
# each of o, l and m against the plain version (TOL_L2; the l and m a probe
# zeroes must be exactly 0); K11's chunks as K1 (TOL and TOL_L2) against the
# plain chunked version and K1's; K12 as K4 (TOL_K4) on the lanes it writes
# whole-net score-map MAE, kernel path vs all-plain path, B=1 (scores in [0, 1])
NET_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
# predict CLI, bf16: mean |difference| of the valid region of the written
# score maps between any two of the four modes (the B=1 net bound): the
# bucketed runs go through K5/K6 with per-item resized position tables, the
# cached runs encode the references in other batches, and bf16 rounds each
# path differently through 12 blocks
CLI_TOL = 1e-2
# step 17: the native decoder's float32 pixels (ImageNet-normalised) against
# the Pillow path's, resized 540x960 -> 518x921: a few float32 ulps apart
# (the C path multiplies by 1/255 where numpy divides, and g++ contracts
# multiply-adds under -march=native)
DECODE_TOL = 1e-5
# whole-step decoder/head gradients, kernel path vs all-plain path, B=1:
# fp32, the largest |difference| of a leaf over its largest entry (summation
# order through 12 backbone layers and the decoder); bf16, the relative L2
# error of a leaf (each path's own bf16 gradient is 5-10% off the fp32 one
# at small sizes, tests/test_torch_train.py)
GRAD_TOL = {"float32": 1e-3, "bfloat16": 0.1}
# the test CLI (step 15): seeded NVS trees of 540x720 renders (518 px short
# side, trimmed to 518x686: a 37x49 patch grid) and, for the bucketed modes,
# the same tree with a third test scene of 720x540 renders; each scene half
# holds PK frames, so every query takes the whole pool of its scene's other
# half as its K=5 references
EVAL_HW, EVAL_HW_T = (540, 720), (720, 540)
# the test CLI's overrides besides the tree and the mode: B=8, K=5, no figures
# (they need matplotlib, which the card's machine lacks)
EVAL_OVERRIDES = [f"data.loader.validation.batch_size={PB}", f"data.neighbour_config.cross={PK}",
                  "logger.test.write.config.vis_img_every_n_steps=-1"]


def _fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def _peaks(name: str):
    for frag, peaks in PEAKS.items():
        if frag in name:
            return frag, peaks
    return "H100", PEAKS["H100"]


def _bound(ops: float, nbytes: float, peak: float, peak_bw: float, exps: float = 0.0, peak_ex2: float = 1.0) -> dict:
    """The least time the card could take for a kernel's work: the larger of
    its products' floor (``ops`` at ``peak``), its bytes' floor (``nbytes``
    at ``peak_bw``) and its exponentials' floor (``exps`` at ``peak_ex2``),
    each floor's ms and which one binds (``bound_by``: bytes or operations,
    the exponentials being operations of the special-function units)."""
    floors = {"products": ops / peak, "bytes": nbytes / peak_bw, "exponentials": exps / peak_ex2}
    by = max(floors, key=floors.get)
    return dict(bound_ms=1e3 * floors[by], bound_by="bytes" if by == "bytes" else "operations", bound_floor=by,
                products_ms=1e3 * floors["products"], exp_ms=1e3 * floors["exponentials"])


def _eval_plan(scene_groups: list, n: int, batch: int, encode_batch: int) -> tuple[int, int, int]:
    """The test CLI's batches, the token cache's encoder calls and its misses
    on a step-15 tree: ``scene_groups`` lists the test scenes of each batch
    group (a bucket, or the whole tree) in loader order; a scene's items are
    its ``n`` train-half queries, whose references are its ``n`` test-half
    captures, then the reverse. A batch's misses are the pools it meets first,
    encoded in chunks of ``encode_batch``."""
    import math

    n_batches = n_calls = 0
    seen: set = set()
    for group in scene_groups:
        items = [(scene, half) for scene in group for half in ("test", "train") for _ in range(n)]
        for i0 in range(0, len(items), batch):
            new = set(items[i0:i0 + batch]) - seen
            seen |= new
            n_batches += 1
            n_calls += math.ceil(len(new) * n / encode_batch)
    return n_batches, n_calls, len(seen) * n


def _eval_phases(torch, dev, zero_launches, read_launches) -> dict:
    """Step 15, the test CLI on the card (dinov2-small, bf16, 518 px short
    side, B=8, K=5, seeded weights): four modes, buckets off / on and the
    reference-token cache off / on, and the cached run again on its warm
    disk store; launches per mode, ``metrics.csv``, the cache's misses, the
    modes' mean losses against each other; one bucketed batch at B=1 through
    ``make_eval_step`` on the kernels against the all-plain net, bf16 and
    fp32; ``summarise_score_gt`` paired with the predicted summary; and each
    mode's device step alone on one batch. Returns the readings."""
    import csv
    import dataclasses
    import tempfile

    import numpy as np

    from crossscore_tpu_torch.confsys import load_config
    from crossscore_tpu_torch.data.bucketing import ShapeBucketedLoader
    from crossscore_tpu_torch.data.loader import Loader
    from crossscore_tpu_torch.data.nvs_index import get_dataset
    from crossscore_tpu_torch.data.synthetic import generate
    from crossscore_tpu_torch.io.convert import init_params, load_into
    from crossscore_tpu_torch.io.summariser import SummaryReader
    from crossscore_tpu_torch.models import CrossScoreConfig, CrossScoreNet
    from crossscore_tpu_torch.models.crossscore import make_backbone_encoder
    from crossscore_tpu_torch.tasks.summarise_score_gt import main as summarise_main
    from crossscore_tpu_torch.tasks.test import main as test_main
    from crossscore_tpu_torch.train.step import batch_to_device, make_eval_step

    ev: dict = {"modes": {}}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # <method>/<dataset>/res_540: the summaries group by the two names
        single, mixed = tmp / "gaussian" / "single", tmp / "gaussian" / "mixed"
        generate(single, hw=EVAL_HW, scenes_per_split={"train": 1, "test": 2}, n_train_imgs=PK, n_test_imgs=PK,
                 seed=SEED)
        # the same draws, then a third test scene of the other aspect
        generate(mixed, hw=[EVAL_HW, EVAL_HW, EVAL_HW, EVAL_HW_T], scenes_per_split={"train": 1, "test": 3},
                 n_train_imgs=PK, n_test_imgs=PK, seed=SEED)
        cfg = load_config("default_test", EVAL_OVERRIDES)
        mcfg = CrossScoreConfig.from_config(cfg)
        params = init_params(mcfg, SEED, dev)
        ckpt = tmp / "run" / "ckpt" / "seeded.ckpt"
        ckpt.parent.mkdir(parents=True)
        torch.save({"state_dict": {f"model.{k}": v.cpu() for k, v in params.items()}}, ckpt)
        enc_batch = int(cfg.this_main.ref_token_cache_encode_batch)
        n_layers, n_dec = mcfg.backbone.num_layers, 2 * mcfg.decoder_layers
        # (tree, buckets, cache, the plan's scene groups); "b warm" reruns (b)
        # on the disk store (b) filled
        modes = {"a": (single, "off", "off", [[1, 2]]), "b": (single, "off", "on", [[1, 2]]),
                 "b warm": (single, "off", "on", [[1, 2]]), "c": (mixed, "on", "on", [[1, 2], [3]]),
                 "d": (mixed, "on", "off", [[1, 2], [3]])}
        bad = []
        for tag, (tree, buckets, cache, groups) in modes.items():
            argv = EVAL_OVERRIDES + [f"trainer.ckpt_path_to_load={ckpt}", f"data.dataset.path=[{tree}]",
                                     f"this_main.shape_buckets={buckets}", f"this_main.ref_token_cache={cache}",
                                     f"this_main.ref_token_cache_dir={tmp / ('store_' + tree.name)}",
                                     f"logger.test.out_dir={tmp / ('out_' + tag.replace(' ', '_'))}"]
            tee = _Tee(sys.stdout)
            zero_launches()
            with contextlib.redirect_stdout(tee):
                out = test_main(argv)
            launches = read_launches()
            text = "".join(tee.text)
            rate = re.search(r"test: (\d+) maps in ([0-9.]+) s = ([0-9.]+) maps/s", text)
            counts = re.search(r"ref-token cache: (\d+) hits, (\d+) unique misses, (\d+) disk hits", text)
            with open(out / "metrics.csv") as f:
                rows = list(csv.DictReader(f))
            n_b, n_calls, pool = _eval_plan(groups, PK, PB, enc_batch)
            fwd = n_b + (n_calls if cache == "on" and tag != "b warm" else 0)  # backbone forwards
            att, dec = ("K5", "K6") if buckets == "on" else ("K1", "K3")
            want = _launches(K2=n_layers * fwd, **{att: n_layers * fwd, dec: n_dec * n_b})
            r = {"launches": launches, "maps": int(rate.group(1)), "seconds": float(rate.group(2)),
                 "maps_per_s": float(rate.group(3)), "batches": len(rows) - 1,
                 "hits": int(counts.group(1)) if counts else None, "misses": int(counts.group(2)) if counts else None,
                 "disk_hits": int(counts.group(3)) if counts else None,
                 "mean": {k: float(v) for k, v in rows[-1].items() if k != "batch_idx"},
                 "rows": [{k: (v if k == "batch_idx" else float(v)) for k, v in row.items()} for row in rows]}
            ev["modes"][tag] = r
            print(f"test CLI ({tag}) buckets {buckets}, cache {cache}: launches "
                  f"{ {k: v for k, v in launches.items() if v} } (expected { {k: v for k, v in want.items() if v} }); "
                  f"{r['maps']} maps in {r['seconds']:.3f} s = {r['maps_per_s']:.2f} maps/s; {r['batches']} batches; "
                  f"cache hits {r['hits']}, misses {r['misses']}, disk hits {r['disk_hits']}; mean {r['mean']}")
            values = [v for row in r["rows"] for k, v in row.items() if k != "batch_idx"]
            if launches != want or r["batches"] != n_b or rows[-1]["batch_idx"] != "mean" \
                    or not np.isfinite(values).all() or r["maps"] != 2 * PK * sum(map(len, groups)):
                bad.append(f"{tag} launches/rows/maps")
            want_misses = None if cache == "off" else 0 if tag == "b warm" else pool
            if r["misses"] != want_misses or (tag == "b warm" and r["disk_hits"] != pool):
                bad.append(f"{tag} cache misses {r['misses']} (disk hits {r['disk_hits']}), expected {want_misses}")
        # the mean losses: (b) and its warm run against (a) on the same tree;
        # (c) and (d) against (a) over the batches of (a)'s frames (the mixed
        # tree's first bucket holds them, batched alike), and (d) against (c)
        m = ev["modes"]
        n_a = m["a"]["batches"]
        weights = [PB] * (n_a - 1) + [m["a"]["maps"] - PB * (n_a - 1)]

        def first_mean(tag: str) -> float:
            return float(np.average([row["test/loss"] for row in m[tag]["rows"][:n_a]], weights=weights))

        agree = {"b": abs(m["b"]["mean"]["test/loss"] - m["a"]["mean"]["test/loss"]),
                 "b warm": abs(m["b warm"]["mean"]["test/loss"] - m["a"]["mean"]["test/loss"]),
                 "c": abs(first_mean("c") - m["a"]["mean"]["test/loss"]),
                 "d": abs(first_mean("d") - m["a"]["mean"]["test/loss"]),
                 "d vs c": abs(m["d"]["mean"]["test/loss"] - m["c"]["mean"]["test/loss"])}
        ev["loss_agreement"] = agree
        print("test CLI mean-loss agreement, |difference| (tol "
              f"{CLI_TOL:.0e}): " + ", ".join(f"{k} {v:.3e}" for k, v in agree.items()))
        bad += [f"{k} mean loss off by {v}" for k, v in agree.items() if not v <= CLI_TOL]

        # the GT summary of the tree, paired row for row with (a)'s predictions
        summarise_main(["--dir_in", str(single / "res_540"), "--dir_out", str(tmp / "gt_summary"), "-n", "8"])
        gt = SummaryReader.read_summary(tmp / "gt_summary", "single", ["gaussian"], ["s00001", "s00002"], [""], [])
        pred = SummaryReader.read_summary(tmp / "out_a" / "score_summary", "single", ["gaussian"], [""], [""], [])
        try:
            SummaryReader.check_summary_gt_prediction_rows(gt, pred)
        except ValueError as e:
            bad.append(f"summaries: {e}")
        ev["summary_rows"] = len(pred)
        print(f"summarise_score_gt: {len(gt)} GT rows paired with {len(pred)} predicted rows")
        if len(pred) != 4 * PK:
            bad.append(f"{len(pred)} predicted summary rows")

        def dataset(tree: Path):
            return get_dataset(load_config("default_test", EVAL_OVERRIDES + [f"data.dataset.path=[{tree}]"]),
                               "test", return_item_paths=True, crop_mode="integer_patches",
                               resize_short_side=cfg.this_main.resize_short_side, deterministic_crop=True)

        # one batch of each shape class at B=1 through make_eval_step, the
        # kernels against the all-plain net: a 37x49 batch (K1, K2, K3: q
        # 1813 over 5 * 1813 keys) and a bucketed 540x720 one (K5, K2, K6 in
        # its bucket). The score maps' MAE over the valid region holds the
        # kernels (a mean loss lets their errors cancel); loss and correlation
        # are held too
        ds_mixed = dataset(mixed)
        b1s = {"unbucketed": (next(iter(Loader(dataset(single), 1, shuffle=False, num_workers=1).epoch(0))),
                              _launches(K1=n_layers, K2=n_layers, K3=n_dec)),
               "bucketed": (next(iter(ShapeBucketedLoader(ds_mixed, 1, num_workers=1, seed=cfg.seed).epoch(0))),
                            _launches(K5=n_layers, K2=n_layers, K6=n_dec))}
        ev["b1"] = {}
        p = mcfg.patch_size
        for kind, (b1, want) in b1s.items():
            hgt, wdt = b1["query/score_map"].shape[1:3]
            if "_valid_hw" in b1:
                hgt, wdt = (int(v) // p * p for v in b1["_valid_hw"][0])
            for dtype in (torch.bfloat16, torch.float32):
                tname = str(dtype).split(".")[-1]
                got = {}
                for impl, mlp_impl in (("flash", "fused_exact"), ("dense", "unfused")):
                    c = dataclasses.replace(mcfg, compute_dtype=dtype, attention_impl=impl, mlp_impl=mlp_impl)
                    net = load_into(CrossScoreNet(c, device=dev), params)
                    zero_launches()
                    got[impl] = make_eval_step(net)(batch_to_device(b1, dev))
                    got[impl + " launches"] = read_launches()
                mae = float((got["flash"][0] - got["dense"][0])[:, :hgt, :wdt].float().abs().mean())
                errs = {k: abs(float(got["flash"][1][k]) - float(got["dense"][1][k]))
                        for k in ("loss", "correlation_cross")}
                ev["b1"][f"{kind} {tname}"] = {"score_mae": mae, **errs}
                print(f"eval step B=1 {kind} {tname} (valid {hgt}x{wdt} in {b1['query/img'].shape[1:3]}), "
                      f"kernels vs all-plain: score MAE {mae:.3e}, |d loss| {errs['loss']:.3e}, "
                      f"|d corr| {errs['correlation_cross']:.3e} (tol {NET_TOL[tname]:.0e}); launches "
                      f"{ {k: v for k, v in got['flash launches'].items() if v} } (expected "
                      f"{ {k: v for k, v in want.items() if v} }), plain "
                      f"{ {k: v for k, v in got['dense launches'].items() if v} }")
                if not max(mae, *errs.values()) < NET_TOL[tname] or got["flash launches"] != want \
                        or any(got["dense launches"].values()):
                    bad.append(f"B=1 {kind} {tname} kernels vs plain: score MAE {mae}, {errs}")
        if bad:
            _fail("test CLI: " + ", ".join(bad))

        # each mode's device step alone, on one batch already on the card
        host_a = next(iter(Loader(dataset(single), PB, shuffle=False, num_workers=8).epoch(0)))
        host_c = next(iter(ShapeBucketedLoader(ds_mixed, PB, num_workers=8).epoch(0)))
        net = load_into(CrossScoreNet(mcfg, device=dev), params)
        step, encode = make_eval_step(net), make_backbone_encoder(mcfg)
        batch_a, batch_d = batch_to_device(host_a, dev), batch_to_device(host_c, dev)

        def cached(batch: dict, valid_hw=None) -> dict:
            refs = batch["reference/cross/imgs"]
            vhw = None if valid_hw is None else np.repeat(valid_hw, PK, axis=0)
            tokens = encode(net, refs.reshape(PB * PK, *refs.shape[2:]), vhw)
            tokens = tokens.reshape(PB, PK, -1, mcfg.backbone.hidden_size)
            return {k: v for k, v in batch.items() if k != "reference/cross/imgs"} | {"reference/cross/tokens": tokens}

        batch_b, batch_c = cached(batch_a), cached(batch_d, host_c["_valid_hw"])
        device_ms = {tag: _time_ms(torch, lambda b=b: step(b), reps=5)
                     for tag, b in (("a", batch_a), ("b", batch_b), ("c", batch_c), ("d", batch_d))}
        for tag, ms in device_ms.items():
            m[tag]["device_step_ms"] = ms
        print("test CLI breakdown: device step alone (eval step with its metrics), ms per batch of 8 (maps/s): "
              + ", ".join(f"({k}) {v:.2f} ({1e3 * PB / v:.1f})" for k, v in device_ms.items()))
        del net, step, batch_a, batch_b, batch_c, batch_d, params
    ev["seconds"] = time.perf_counter() - t0
    print(f"test CLI step: {ev['seconds']:.1f} s")
    return ev


def _event_times(torch, fn, reps: int = 5, warmup: int = 2) -> list:
    """``reps`` CUDA-event timings of ``fn`` in ms, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return times


class _Lines:
    """A child process's merged output, read on a thread (so that its pipe
    never fills), with an event set on the first line that matches."""

    def __init__(self, proc, pattern: str):
        import threading

        self.lines, self.match = [], None
        self.found = threading.Event()
        self._re = re.compile(pattern)
        self._thread = threading.Thread(target=self._read, args=(proc,), daemon=True)
        self._thread.start()

    def _read(self, proc):
        for line in proc.stdout:
            self.lines.append(line)
            if self.match is None and self._re.search(line):
                self.match = self._re.search(line)
                self.found.set()

    def text(self) -> str:
        self._thread.join(timeout=10)
        return "".join(self.lines)


def _serve_phases(torch, dev, params, card, zero_launches, read_launches) -> dict:
    """Step 16, the scoring daemon on the card (dinov2-small, 518x518, K=8,
    bf16, seeded weights): (a) the warm-cache step alone at B=8 (the
    benchmark's point, then the daemon's one token set broadcast to the
    batch), its launches, and at B=1 against the uncached step and the
    all-plain cached net; (b) the daemon in this process on an ephemeral
    port: startup, ``/healthz``, one map against the predict CLI's, the load
    bench at 1, 4 and 8 workers, a reload mid-storm and the typed 503 of a
    full queue; (c) the CLI in a child process, SIGTERM mid-storm with a
    request in flight, then a warm-up-only run on the token store the first
    run filled. Returns the readings."""
    import http.client
    import os
    import signal
    import subprocess
    import tempfile
    import threading

    import numpy as np

    from crossscore_tpu_torch.client import ScoreClient, ScoreClientError
    from crossscore_tpu_torch.io.convert import init_params, load_into
    from crossscore_tpu_torch.io.images import image_read_bytes, metric_map_read
    from crossscore_tpu_torch.models import CrossScoreConfig, CrossScoreNet
    from crossscore_tpu_torch.models.crossscore import make_backbone_encoder
    from crossscore_tpu_torch.tasks.common import parse_cli
    from crossscore_tpu_torch.tasks.predict import main as predict_main
    from crossscore_tpu_torch.tasks.serve import make_server
    from crossscore_tpu_torch.tools.serve_load_bench import run as load_bench
    from crossscore_tpu_torch.train.step import make_predict_step, make_predict_step_cached

    t_step = time.perf_counter()
    sv: dict = {"card": card}
    root = Path(__file__).resolve().parent
    gen = torch.Generator(device=dev).manual_seed(SEED + 16)
    per_dispatch = _launches(K1=12, K2=12, K3=4)

    # --- (a) the warm-cache step alone ----------------------------------------
    cfg = CrossScoreConfig()  # dinov2-small, bf16, flash, fused
    model = load_into(CrossScoreNet(cfg, device=dev), params)
    encode = make_backbone_encoder(cfg)
    step = make_predict_step_cached(model)
    query = torch.randint(0, 256, (B, HW, HW, 3), generator=gen, device=dev, dtype=torch.uint8)
    refs = torch.randint(0, 256, (B, K, HW, HW, 3), generator=gen, device=dev, dtype=torch.uint8)
    tokens = torch.cat([encode(model, refs[i]) for i in range(B)]).reshape(B, K, -1, cfg.backbone.hidden_size)
    shared = tokens[:1].expand(B, *tokens.shape[1:])  # the daemon's form: one set, stride 0 over the batch
    forms = {"per_item": tokens, "broadcast": shared}
    sv["warm_cache_step"] = {}
    for form, tok in forms.items():
        zero_launches()
        score = step(query, tok)["score_map_ref_cross"]
        torch.cuda.synchronize()
        launches = read_launches()
        if launches != per_dispatch:
            _fail(f"warm-cache step ({form}) launches {launches} != {per_dispatch}")
        if tuple(score.shape) != (B, HW, HW) or not bool(torch.isfinite(score).all()) \
                or float(score.min()) < 0.0 or float(score.max()) > 1.0:
            _fail(f"warm-cache step ({form}) score map shape / finite / range check failed")
        torch.cuda.reset_peak_memory_stats()
        times = _event_times(torch, lambda tok=tok: step(query, tok), reps=5)
        med = sorted(times)[2]
        r = {"ms": times, "median_ms": med, "maps_per_s": 1e3 * B / med,
             "maps_per_s_spread": [1e3 * B / max(times), 1e3 * B / min(times)],
             "peak_gib": torch.cuda.max_memory_allocated() / 2**30, "launches": {k: v for k, v in launches.items() if v}}
        sv["warm_cache_step"][form] = r
        print(f"warm-cache step ({form} tokens (B, K, N, D) = {tuple(tok.shape)}, strides {tok.stride()}): "
              f"median {med:.3f} ms per batch of {B} = {r['maps_per_s']:.2f} maps/s (5 steps: "
              + ", ".join(f"{t:.3f}" for t in times) + f" ms; {r['maps_per_s_spread'][0]:.2f}-"
              f"{r['maps_per_s_spread'][1]:.2f} maps/s); peak {r['peak_gib']:.2f} GiB; launches {r['launches']}; "
              f"{HW} px, K={K}, bf16; {card}")
    # where the step's time goes: the device's busy share (torch.profiler),
    # and the host's time to enqueue the step (the wall of the call, no sync)
    r = sv["warm_cache_step"]["per_item"]
    r["device_busy_ms"] = _profile(torch, lambda: step(query, forms["per_item"]), r["median_ms"], top=10,
                                   what="warm-cache step (per-item tokens)")

    def enqueue_ms():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(query, forms["per_item"])
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return 1e3 * (t1 - t0)

    r["host_enqueue_ms"] = sorted(enqueue_ms() for _ in range(5))[2]
    print(f"warm-cache step: the host enqueues it in {r['host_enqueue_ms']:.3f} ms (median of 5; the CUDA-event "
          f"step {r['median_ms']:.3f} ms, device busy {r['device_busy_ms']:.3f} ms); {card}")
    same = torch.equal(step(query, shared)["score_map_ref_cross"],
                       step(query, shared.contiguous())["score_map_ref_cross"])
    print(f"warm-cache step: the broadcast (stride-0) tokens give the contiguous copy's bits: {same}")
    if not same:
        _fail("the stride-0 broadcast tokens and their contiguous copy give other score maps")
    del tokens, shared, forms, model, step

    # B=1: the cached step against the uncached one on the same images, and
    # against the all-plain cached net
    q1, r1 = query[:1], refs[:1]
    sv["b1"] = {}
    for dtype, mlp in ((torch.bfloat16, "fused"), (torch.float32, "fused_exact")):
        tname = str(dtype).split(".")[-1]
        nets = {impl: load_into(CrossScoreNet(CrossScoreConfig(compute_dtype=dtype, attention_impl=impl,
                                                               mlp_impl=m), device=dev), params)
                for impl, m in (("flash", mlp), ("dense", "unfused"))}
        maps = {}
        for impl, net in nets.items():
            tok = encode(net, r1[0])[None]
            maps[impl] = make_predict_step_cached(net)(q1, tok)["score_map_ref_cross"]
        uncached = make_predict_step(nets["flash"])(q1, r1)["score_map_ref_cross"]
        mae_unc = float((maps["flash"] - uncached).abs().mean())
        mae_plain = float((maps["flash"] - maps["dense"]).abs().mean())
        sv["b1"][tname] = {"mae_vs_uncached": mae_unc, "mae_vs_all_plain_cached": mae_plain, "tol": NET_TOL[tname]}
        print(f"warm-cache B=1 {tname} ({mlp}): score MAE against the uncached step {mae_unc:.3e}, against the "
              f"all-plain cached net {mae_plain:.3e} (tol {NET_TOL[tname]:.0e})")
        if not (mae_unc < NET_TOL[tname] and mae_plain < NET_TOL[tname]):
            _fail(f"warm-cache B=1 {tname}: MAE {mae_unc} / {mae_plain} >= {NET_TOL[tname]}")
        del nets, maps, uncached
    del query, refs, q1, r1
    torch.cuda.empty_cache()
    sv["seconds_a"] = time.perf_counter() - t_step

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        qdir, rdir = _write_predict_dirs(tmp, 1, K, hw=(HW, HW))
        qpath = next(qdir.iterdir())
        qbytes = qpath.read_bytes()
        ckpt = {}
        for seed in (0, 1):
            ckpt[seed] = tmp / "run" / "ckpt" / f"seed{seed}.ckpt"
            ckpt[seed].parent.mkdir(parents=True, exist_ok=True)
            torch.save({"state_dict": {f"model.{k}": v.cpu() for k, v in init_params(cfg, seed, dev).items()}},
                       ckpt[seed])
        base = [f"data.dataset.reference_dir={rdir}", f"trainer.ckpt_path_to_load={ckpt[0]}",
                f"this_main.resize_short_side={HW}", "this_main.serve_port=0", "this_main.serve_batch_window_ms=2"]

        # --- (b) the daemon in this process ------------------------------------
        servers = []

        def start(extra):
            zero_launches()
            t0 = time.perf_counter()
            srv, scorer = make_server(parse_cli("default_predict", base + extra))
            seconds = time.perf_counter() - t0
            srv.RequestHandlerClass.log_message = lambda *a: None  # one line a request otherwise
            thread = threading.Thread(target=srv.serve_forever, daemon=True)
            thread.start()
            servers.append((srv, thread))
            host, port = srv.server_address[:2]
            return srv, scorer, ScoreClient(f"http://{host}:{port}", timeout=120), seconds, read_launches()

        try:
            srv, scorer, client, seconds, launches = start(["this_main.serve_max_batch=8"])
            # one encode call (8 references in a batch of 16) and a warm-up
            # dispatch at each bucket 1/2/4/8
            want = _launches(K1=12 * 5, K2=12 * 5, K3=4 * 4)
            sv["startup"] = {"seconds": seconds, "split": scorer.startup_s,
                             "launches": {k: v for k, v in launches.items() if v}}
            print(f"daemon startup: {seconds:.2f} s (kernels loaded {scorer.startup_s['kernels']:.2f} s, "
                  f"{K} references read and encoded {scorer.startup_s['references']:.2f} s, warm-up of buckets "
                  f"1/2/4/8 {scorer.startup_s['warmup']:.2f} s); launches {sv['startup']['launches']}")
            if launches != want:
                _fail(f"daemon startup launches {launches} != {want}")
            health = client.health()
            sv["healthz"] = health
            print(f"daemon /healthz: {json.dumps(health)}")

            zero_launches()
            got = client.score_map(qbytes)
            launches = read_launches()
            if launches != per_dispatch or got.shape != (HW, HW):
                _fail(f"daemon map=npy: launches {launches}, shape {got.shape}")
            out = predict_main(base[:3] + [
                f"data.dataset.query_dir={qdir}", f"data.neighbour_config.cross={K}",
                "data.loader.validation.batch_size=1", "data.loader.validation.num_workers=0",
                "logger.predict.write.config.vis_img_every_n_steps=-1",
                "logger.predict.write.config.score_map_colour_mode=gray",
                "logger.predict.write.flag.image_query=false", "logger.predict.write.flag.image_reference=false",
                f"logger.predict.out_dir={tmp / 'predict_out'}"])
            written = next((out / "batch" / "score_map_ref_cross").glob("*.png"))
            want_map = metric_map_read(written, [-1, 1])  # SSIM maps are written in [-1, 1]
            mae = float(np.abs(got - want_map).mean())
            sv["map_vs_predict_cli"] = {"mae": mae, "max": float(np.abs(got - want_map).max()),
                                        "tol": NET_TOL["bfloat16"]}
            print(f"daemon map=npy against the predict CLI on the same query and references: MAE {mae:.3e} "
                  f"(max {sv['map_vs_predict_cli']['max']:.3e}; tol {NET_TOL['bfloat16']:.0e})")
            if not mae <= NET_TOL["bfloat16"]:
                _fail(f"daemon map against the predict CLI: MAE {mae}")

            sv["load"] = {}
            for workers in (1, 4, 8):
                zero_launches()
                r = load_bench(client.base_url, qbytes, workers, 16)
                launches = read_launches()
                disp = r["daemon"]["dispatches"]
                want = _launches(**{k: v * disp for k, v in per_dispatch.items()})
                r["launches"] = {k: v for k, v in launches.items() if v}
                r["launches_per_dispatch"] = {k: v / disp for k, v in r["launches"].items()}
                r["mean_batch"] = r["daemon"]["requests"] / disp
                sv["load"][workers] = r
                lat = r["latency_ms"]
                print(f"load bench {workers} workers x 16 JSON requests: {r['throughput_rps']:.2f} req/s, p50 "
                      f"{lat['p50']:.2f} / p95 {lat['p95']:.2f} / p99 {lat['p99']:.2f} ms (max {lat['max']:.2f}); "
                      f"{r['daemon']['requests']} requests in {disp} dispatches (mean batch {r['mean_batch']:.2f}, "
                      f"max_batch_seen {r['daemon']['max_batch_seen']}); launches per dispatch "
                      f"{r['launches_per_dispatch']}; errors {r['errors']}; {card}")
                if r["errors"] or launches != want:
                    _fail(f"load bench at {workers} workers: {r['errors']} errors {r['error_messages']}, "
                          f"launches {launches} != {want}")
            if not (sv["load"][8]["daemon"]["max_batch_seen"] > 1 and sv["load"][8]["mean_batch"] > 1):
                _fail("8 concurrent workers never shared a dispatch")

            # one request's parts alone, each the median of 10 on the idle daemon
            def host_ms(fn, n: int = 10):
                times = []
                for _ in range(n):
                    t0 = time.perf_counter()
                    out = fn()
                    times.append(1e3 * (time.perf_counter() - t0))
                return sorted(times)[n // 2], out

            decode_ms, img = host_ms(lambda: image_read_bytes(qbytes))
            prep_ms, q = host_ms(lambda: scorer._preprocess(img))
            dispatch_ms, _ = host_ms(lambda: scorer._run_device(q[None], False, count=False))
            q_dev = torch.from_numpy(q[None]).to(dev)
            device_ms = sorted(_event_times(torch, lambda: scorer._forward(scorer.model, q_dev, scorer.tokens),
                                            reps=10))[5]
            busy_ms = _profile(torch, lambda: scorer._forward(scorer.model, q_dev, scorer.tokens), device_ms, top=0,
                               what="the daemon's B=1 forward")
            req_ms = sv["load"][1]["latency_ms"]["p50"]
            sv["request_split"] = {"request_p50_ms": req_ms, "decode_ms": decode_ms, "preprocess_ms": prep_ms,
                                   "dispatch_ms": dispatch_ms, "device_ms": device_ms, "device_busy_ms": busy_ms,
                                   "rest_ms": req_ms - decode_ms - prep_ms - dispatch_ms}
            print(f"one request (1 worker, p50 {req_ms:.2f} ms), its parts alone: PNG decode {decode_ms:.2f} ms, "
                  f"preprocess {prep_ms:.2f} ms, the B=1 dispatch {dispatch_ms:.2f} ms of host wall (upload, "
                  f"launches, the mean's fetch) of which {device_ms:.2f} ms between CUDA events around the forward "
                  f"({busy_ms:.2f} ms device busy); "
                  f"the rest (HTTP, the 2 ms batch window, the client, threads) "
                  f"{sv['request_split']['rest_ms']:.2f} ms; {card}")

            # a reload to seed 1's weights in the middle of a storm
            old_mean = client.score(qbytes)["mean_score"]
            first = scorer.reload(str(ckpt[1]))
            new_mean = client.score(qbytes)["mean_score"]
            scorer.reload(str(ckpt[0]))
            means, errors = [], []
            lock = threading.Lock()

            def storm_worker():
                for _ in range(12):
                    try:
                        m = client.score(qbytes)["mean_score"]
                    except Exception as e:  # counted and reported below
                        with lock:
                            errors.append(repr(e))
                        continue
                    with lock:
                        means.append(m)

            threads = [threading.Thread(target=storm_worker) for _ in range(8)]
            for t in threads:
                t.start()
            while not means and not errors:
                time.sleep(0.001)
            res = client.reload(str(ckpt[1]))
            for t in threads:
                t.join(timeout=120)
            off = max(min(abs(m - old_mean), abs(m - new_mean)) for m in means)
            n_new = sum(abs(m - new_mean) < abs(m - old_mean) for m in means)
            sv["reload_storm"] = {"errors": len(errors), "requests": len(means), "after_swap": n_new,
                                  "old_mean": old_mean, "new_mean": new_mean, "max_off": off,
                                  "reload": res, "reload_alone": first}
            print(f"reload mid-storm (8 workers x 12): {len(means)} answered, {len(errors)} errors, {n_new} on the "
                  f"new weights; means {old_mean:.6f} -> {new_mean:.6f}, every one within {off:.3e} of one (tol "
                  f"2e-3); /reload {res['seconds']} s, peak {res['peak_memory_gib']} GiB (alone: "
                  f"{first['seconds']} s, {first['peak_memory_gib']} GiB); {card}")
            if errors or len(means) != 96 or off > 2e-3 or old_mean == new_mean:
                _fail(f"reload storm: {errors[:3]}, {len(means)} answered, max off {off}")

            # a full queue: with the card held, serve_max_queue=1 gives typed 503s
            srv2, scorer2, client2, _, _ = start(["this_main.serve_max_batch=2", "this_main.serve_max_queue=1"])
            results = []

            def one():
                try:
                    results.append(client2.score(qbytes)["mean_score"])
                except ScoreClientError as e:
                    results.append(e)

            with scorer2._lock:
                threads = [threading.Thread(target=one) for _ in range(8)]
                for t in threads:
                    t.start()
                deadline = time.monotonic() + 60
                while scorer2._rejected.value < 5 and time.monotonic() < deadline:
                    time.sleep(0.005)
            for t in threads:
                t.join(timeout=60)
            refused = [r for r in results if isinstance(r, ScoreClientError)]
            typed = all("503" in str(e) and "ServerOverloaded" in str(e) for e in refused)
            sv["backpressure"] = {"requests": len(results), "refused_503": len(refused),
                                  "rejected_503": client2.health()["rejected_503"]}
            print(f"backpressure (serve_max_queue=1, the card held): {len(refused)} of {len(results)} refused with "
                  f"a typed 503, /healthz rejected_503 {sv['backpressure']['rejected_503']}")
            if not (refused and typed and len(results) == 8 and sv["backpressure"]["rejected_503"] == len(refused)):
                _fail(f"backpressure: {sv['backpressure']}, typed {typed}")
        finally:
            for srv, thread in servers:
                srv.shutdown()
                srv.server_close()
                thread.join(timeout=30)

        sv["seconds_b"] = time.perf_counter() - t_step - sv["seconds_a"]

        # --- (c) the CLI in a child process ------------------------------------
        store = tmp / "token_store"
        cli = [sys.executable, "-m", "crossscore_tpu_torch.tasks.serve", *base,
               "this_main.serve_max_batch=8", f"this_main.ref_token_cache_dir={store}"]
        env = dict(os.environ, PYTHONPATH=str(root))
        t0 = time.perf_counter()
        proc = subprocess.Popen(cli, cwd=tmp, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        try:
            out = _Lines(proc, r"serve: ready on http://([\d.]+):(\d+)")
            if not out.found.wait(timeout=300):
                _fail("the serve CLI never printed its ready line:\n" + "".join(out.lines)[-3000:])
            ready_s = time.perf_counter() - t0
            host, port = out.match.group(1), int(out.match.group(2))
            client = ScoreClient(f"http://{host}:{port}", timeout=120)
            print(f"serve CLI: ready after {ready_s:.1f} s (process start included): {out.match.string.strip()}")
            oks, drains, refused_conn, errors = [], [], [], []
            sent_term = threading.Event()

            def cli_worker():
                for _ in range(400):
                    try:
                        oks.append(client.score(qbytes)["mean_score"])
                    except ScoreClientError as e:
                        if "503" in str(e) and "ServerDraining" in str(e) and sent_term.is_set():
                            drains.append(str(e))
                        else:
                            errors.append(str(e))
                        return
                    except OSError as e:  # the listener closed once the drain ended
                        (refused_conn if sent_term.is_set() else errors).append(repr(e))
                        return

            threads = [threading.Thread(target=cli_worker) for _ in range(4)]
            for t in threads:
                t.start()
            # a request in flight across the drain: its body half sent
            slow = http.client.HTTPConnection(host, port, timeout=120)
            slow.putrequest("POST", "/score", skip_accept_encoding=True)
            slow.putheader("Content-Length", str(len(qbytes)))
            slow.endheaders()
            slow.send(qbytes[:4096])
            while len(oks) < 20 and not errors:
                time.sleep(0.01)
            time.sleep(0.5)
            sent_term.set()
            proc.send_signal(signal.SIGTERM)
            time.sleep(0.5)
            probes = {}
            for path in ("/livez", "/healthz"):
                conn = http.client.HTTPConnection(host, port, timeout=30)
                conn.request("GET", path)
                r = conn.getresponse()
                probes[path] = (r.status, json.loads(r.read())["status"])
            try:
                client.score(qbytes)
                late = "200"
            except ScoreClientError as e:
                late = str(e)
            slow.send(qbytes[4096:])
            r = slow.getresponse()
            slow_status = r.status
            r.read()
            for t in threads:
                t.join(timeout=120)
            rc = proc.wait(timeout=120)
            text = out.text()
            drain_line = next((ln.strip() for ln in text.splitlines() if "SIGTERM drain" in ln), None)
            sv["cli"] = {"ready_s": ready_s, "ok": len(oks), "drain_503": len(drains), "refused": len(refused_conn),
                         "errors": errors[:5], "probes": probes, "late_post": late, "in_flight_status": slow_status,
                         "rc": rc, "drain_line": drain_line, "seconds": time.perf_counter() - t0}
            print(f"serve CLI under SIGTERM mid-storm: {len(oks)} requests 200, {len(drains)} typed 503 after the "
                  f"signal, {len(refused_conn)} refused after the listener closed, errors {errors[:3]}; during the "
                  f"drain /livez {probes['/livez']}, /healthz {probes['/healthz']}, a new POST -> {late[:80]}; the "
                  f"request in flight -> {slow_status}; exit {rc}; {drain_line}")
            if (errors or rc != 0 or slow_status != 200 or probes["/livez"] != (200, "draining")
                    or probes["/healthz"] != (503, "draining") or "ServerDraining" not in late
                    or drain_line is None or "drain complete" not in drain_line):
                _fail(f"serve CLI drain: {sv['cli']}")
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)

        t0 = time.perf_counter()
        res = subprocess.run(cli + ["this_main.serve_warmup_only=true"], cwd=tmp, env=env, capture_output=True,
                             text=True, timeout=300)
        line = next((ln for ln in res.stdout.splitlines() if "warmup-only done" in ln), "")
        sv["warmup_only"] = {"rc": res.returncode, "line": line, "seconds": time.perf_counter() - t0}
        print(f"serve CLI warm-up only on the token store: exit {res.returncode} in {sv['warmup_only']['seconds']:.1f} "
              f"s: {line.strip()}")
        if res.returncode != 0 or f"{K} references encoded ({K} from the token store)" not in line:
            _fail(f"serve_warmup_only run: {res.returncode}\n{(res.stdout + res.stderr)[-3000:]}")
    sv["seconds"] = time.perf_counter() - t_step
    print(f"serving daemon step: {sv['seconds']:.1f} s ((a) the warm-cache step {sv['seconds_a']:.1f} s, (b) the "
          f"daemon in process {sv['seconds_b']:.1f} s, (c) the CLI {sv['seconds'] - sv['seconds_a'] - sv['seconds_b']:.1f}"
          f" s)")
    return sv


def _time_ms(torch, fn, reps: int = 10) -> float:
    """Median of ``reps`` CUDA-event timings after two warm-up calls."""
    return sorted(_event_times(torch, fn, reps))[reps // 2]


def _rel_err(got, want) -> float:
    got, want = got.float(), want.float()
    return float(((got - want).abs() / (1.0 + want.abs())).max())


def _rel_l2(got, want) -> float:
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm())


def _max_abs(got, want) -> float:
    return float((got.float() - want.float()).abs().max())


def _masked_errs(pairs) -> tuple[float, float]:
    """K5/K6 against their plain versions over (kernel, plain) output triples:
    the largest max |d| / (1 + |plain|) and the largest relative L2 error of
    any of o, l, m."""
    pairs = [(g, w) for got, want in pairs for g, w in zip(got, want)]
    return max(_rel_err(g, w) for g, w in pairs), max(_rel_l2(g, w) for g, w in pairs)



def _rel_l2_or_zero(got, want) -> float:
    """The relative L2 error, or max |got| where the plain output is all zero
    (the l and m that a wrong-math probe sets to 0)."""
    if not bool(want.any()):
        return float(got.float().abs().max())
    return _rel_l2(got, want)

def _check_instruments(torch, F, dev, report, peak_bf16, peak_f32, peak_bw, peak_ex2, *, views, n, d, h, f, eps,
                       nq, dec_h) -> dict:
    """Step 3's part for K10-K12: fill ``report`` with each kernel or mode
    against its plain version at the shapes of its entry point, timed; return
    the inputs the kernels line names. Its inputs come from a generator of its
    own, so the later phases draw what they drew before."""
    from crossscore_tpu_torch.ops import flash_attention as fa
    from crossscore_tpu_torch.ops import lane_pad_probe as lpp
    from crossscore_tpu_torch.ops.fused_mlp import (
        _reference_res, fused_ln_mlp, fused_res_ln_mlp, fused_res_ln_mlp_plain,
    )

    gen = torch.Generator(device=dev).manual_seed(SEED + 2)

    def randn(*shape, dtype, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(dtype)

    def bound(ops, nbytes, peak, exps=0.0):
        return _bound(ops, nbytes, peak, peak_bw, exps, peak_ex2)

    # K10 at the backbone's width over the predict point's 72 views, both dtypes:
    # against its plain version, timed beside K2 after the separate residual add
    for dtype in (torch.bfloat16, torch.float32):
        tname = str(dtype).split(".")[-1]
        es = dtype.itemsize
        x, attn = randn(views, n, d, dtype=dtype), randn(views, n, d, dtype=dtype, scale=0.3)
        mlp = (randn(d, dtype=torch.float32, scale=0.05) + 1, randn(d, dtype=torch.float32, scale=0.1) + 1,
               randn(d, dtype=torch.float32, scale=0.1), randn(f, d, dtype=torch.float32, scale=d ** -0.5),
               randn(f, dtype=torch.float32, scale=0.1), randn(d, f, dtype=torch.float32, scale=f ** -0.5),
               randn(d, dtype=torch.float32, scale=0.1), randn(d, dtype=torch.float32, scale=0.5) + 1)
        ls1_dt = mlp[0].to(dtype)
        got, want = fused_res_ln_mlp(x, attn, *mlp, eps), fused_res_ln_mlp_plain(x, attn, *mlp, eps)
        rows = views * n
        # the backward once at B=1: K10 forward + the reference recompute against
        # plain autograd through the same recompute, one fixed cotangent
        leaves = [t[:1].clone().requires_grad_() for t in (x, attn)] + [t.clone().requires_grad_() for t in mlp]
        gout = randn(1, n, d, dtype=dtype)
        g_k10 = torch.autograd.grad(fused_res_ln_mlp(*leaves, eps), leaves, gout)
        g_plain = torch.autograd.grad(_reference_res(*leaves, eps), leaves, gout)
        bwd_err = max(_rel_l2(g, w) for g, w in zip(g_k10, g_plain))
        report[("K10", tname)] = dict(
            err=_rel_err(got, want), tol=TOL[tname], l2=bwd_err, tol_l2=K10_BWD_TOL,
            max_abs=_max_abs(got, want),
            ms=_time_ms(torch, lambda: fused_res_ln_mlp(x, attn, *mlp, eps)),
            plain_ms=_time_ms(torch, lambda: fused_res_ln_mlp_plain(x, attn, *mlp, eps), reps=3),
            library_ms=None,
            # what the block does today: the residual add in PyTorch, then K2
            k2res_ms=_time_ms(torch, lambda: fused_ln_mlp(x + attn * ls1_dt, *mlp[1:], eps, "tanh")),
            **bound(4.0 * rows * d * f, 3 * rows * d * es + 2 * d * f * es + (5 * d + f) * es,
                    peak_bf16 if dtype == torch.bfloat16 else peak_f32),
        )
        print(f"K10 {tname}: backward at B=1 against plain autograd, worst relative L2 of the ten "
              f"gradients {bwd_err:.3e}")
        del x, attn, mlp, got, want, leaves, g_k10, g_plain
    torch.cuda.empty_cache()

    bf16, es = torch.bfloat16, 2
    hd = d // h

    # K11 at the backbone's qkv of the predict point, K1 timed in the same run
    qkv = randn(views, n, 3 * d, dtype=bf16)
    k1_ms = _time_ms(torch, lambda: fa.flash_qkv_self_attention(qkv, h))
    k1_work = (4.0 * views * h * n * n * hd, views * n * 4 * d * es + 2 * views * h * n * 4, peak_bf16)
    k1_bound = bound(*k1_work, views * h * n * n)
    k1_plain = fa.flash_qkv_self_attention_plain(qkv, h)
    for probe in fa.QKV_PROBES:
        got = fa.flash_qkv_self_attention_probe(qkv, h, probe)
        want = fa.flash_qkv_self_attention_probe_plain(qkv, h, probe)
        report[(f"K11 {probe}", "bfloat16")] = dict(
            err=max(_rel_l2_or_zero(g, w) for g, w in zip(got, want)), tol=TOL_L2["bfloat16"],
            max_abs=_max_abs(got[0], want[0]),
            ms=_time_ms(torch, lambda: fa.flash_qkv_self_attention_probe(qkv, h, probe)),
            plain_ms=_time_ms(torch, lambda: fa.flash_qkv_self_attention_probe_plain(qkv, h, probe), reps=3),
            # mxu runs the products and loads only: no exponentials to floor
            library_ms=None, k1_ms=k1_ms, **(bound(*k1_work) if probe == "mxu" else k1_bound))
        del got, want
    views_hm = [qkv.view(views, n, 3, h, hd)[:, :, i].transpose(1, 2) for i in range(3)]
    sdpa_ms = _time_ms(torch, lambda: F.scaled_dot_product_attention(*views_hm))
    for chunks in (2, 3):
        got = fa.flash_qkv_self_attention_chunked(qkv, h, chunks)
        want = fa.flash_qkv_self_attention_chunked_plain(qkv, h, chunks)
        # against the plain chunked version, and K1's plain version (the same function)
        err, l2 = _masked_errs([(got, want), (got, k1_plain)])
        report[(f"K11 chunks{chunks}", "bfloat16")] = dict(
            err=err, tol=TOL["bfloat16"], l2=l2, tol_l2=TOL_L2["bfloat16"], max_abs=_max_abs(got[0], want[0]),
            ms=_time_ms(torch, lambda: fa.flash_qkv_self_attention_chunked(qkv, h, chunks)),
            plain_ms=_time_ms(torch, lambda: fa.flash_qkv_self_attention_chunked_plain(qkv, h, chunks), reps=3),
            library_ms=sdpa_ms, k1_ms=k1_ms, **k1_bound)
        del got, want
    del qkv, views_hm, k1_plain
    torch.cuda.empty_cache()

    # K7' at the backbone shape and at the decoder's cross shape over K=8
    # references (the microbenchmark's two), contiguous head-major tensors; K7
    # timed on the same inputs
    shapes = {"backbone": (views, h, n, n, hd), "decoder": (8, dec_h, nq, 8 * nq, d // dec_h)}
    for where, (bb, hh, n_q, nk, hdim) in shapes.items():
        q, k_, v_ = (randn(bb, hh, m_, hdim, dtype=bf16) for m_ in (n_q, nk, nk))
        k7_ms = _time_ms(torch, lambda: fa.flash_attention_head_major(q, k_, v_))
        ops = 4.0 * bb * hh * n_q * nk * hdim
        nbytes = bb * hh * (2 * n_q + 2 * nk) * hdim * es + 2 * bb * hh * n_q * 4
        for variant in fa.HEAD_MAJOR_VARIANTS:
            got = fa.flash_attention_head_major_variant(q, k_, v_, variant)
            want = fa.flash_attention_head_major_variant_plain(q, k_, v_, variant)
            report[(f"K7' {variant}" + (" backbone" if where == "backbone" else ""), "bfloat16")] = dict(
                err=max(_rel_l2_or_zero(g, w) for g, w in zip(got, want)), tol=TOL_L2["bfloat16"],
                max_abs=_max_abs(got[0], want[0]),
                ms=_time_ms(torch, lambda: fa.flash_attention_head_major_variant(q, k_, v_, variant)),
                plain_ms=_time_ms(torch, lambda: fa.flash_attention_head_major_variant_plain(q, k_, v_, variant),
                                  reps=3),
                # bf16exp is softmax attention with a coarser exp: SDPA computes the same function
                library_ms=_time_ms(torch, lambda: F.scaled_dot_product_attention(q, k_, v_))
                if variant == "bf16exp" else None,
                # mxuprobe and noexp compute no exponentials: no floor for them
                k7_ms=k7_ms, **bound(ops, nbytes, peak_bf16, bb * hh * n_q * nk if variant == "bf16exp" else 0.0))
            del got, want
        del q, k_, v_
        torch.cuda.empty_cache()

    # K12's four geometries at the TPU tool's shapes (b 24, K 5), on the lanes
    # each writes: the relative L2 of dq, dk and dv
    b12 = 24
    nq_p, nk_p = lpp.probe_shapes(b12, 5)
    qp, dop = (randn(b12, nq_p, lpp.LANES, dtype=bf16) for _ in range(2))
    kp, vp = (randn(b12, nk_p, lpp.LANES, dtype=bf16) for _ in range(2))
    for geometry in lpp.GEOMETRIES:
        lanes = torch.cat([torch.arange(lo, hi, device=dev) for lo, hi in lpp.slices(geometry)])
        got = lpp.lane_pad_probe(qp, dop, kp, vp, geometry)
        want = lpp.lane_pad_probe_plain(qp, dop, kp, vp, geometry)
        pairs = [(g[..., lanes], w[..., lanes]) for g, w in zip(got, want)]
        width = len(lanes)
        report[(f"K12 {geometry}", "bfloat16")] = dict(
            err=max(_rel_l2(g, w) for g, w in pairs), tol=TOL_K4["bfloat16"],
            max_abs=max(_max_abs(g, w) for g, w in pairs),
            ms=_time_ms(torch, lambda: lpp.lane_pad_probe(qp, dop, kp, vp, geometry)),
            plain_ms=_time_ms(torch, lambda: lpp.lane_pad_probe_plain(qp, dop, kp, vp, geometry), reps=3),
            library_ms=None,
            **bound(lpp.useful_flops(b12, nq_p, nk_p, geometry),
                    b12 * (2 * nq_p + 2 * nk_p) * width * es + b12 * (nq_p + 2 * nk_p) * width * es, peak_bf16))
        del got, want, pairs
    del qp, dop, kp, vp
    torch.cuda.empty_cache()
    return {"K10": f"x, attn ({views}, {n}, {d}) bf16, F={f}",
            "K11": f"qkv ({views}, {n}, {3 * d}) bf16",
            "K7'": f"q ({shapes['decoder'][0]}, {dec_h}, {nq}, {d // dec_h}), k/v (.., {8 * nq}, ..) bf16; "
                   f"backbone q/k/v ({views}, {h}, {n}, {hd})",
            "K12": f"q/do ({b12}, {nq_p}, {lpp.LANES}), k/v ({b12}, {nk_p}, {lpp.LANES}) bf16"}


def _token_bias(torch, grids, dev, grid=BUCKET_GRID, cls: bool = False):
    """(len(grids), N) fp32 token bias over a padded ``grid``: 0 in each
    item's valid (gh_v, gw_v) top-left region, -1e30 elsewhere (the model's
    bucket mask); ``cls`` prepends an always-valid column."""
    gh, gw = grid
    valid = torch.zeros(len(grids), gh, gw, dtype=torch.bool)
    for i, (vh, vw) in enumerate(grids):
        valid[i, :vh, :vw] = True
    valid = valid.reshape(len(grids), gh * gw)
    if cls:
        valid = torch.cat([torch.ones(len(grids), 1, dtype=torch.bool), valid], 1)
    return torch.where(valid, 0.0, -1e30).to(dev).contiguous()


def _shared_bias(torch, nk: int, dev):
    """A seeded (nk,) fp32 bias row in natural units: offsets in [-1, 0], a
    fifth of the columns masked with -1e30."""
    g = torch.Generator().manual_seed(SEED + 7)
    bias = -torch.rand(nk, generator=g)
    bias[torch.rand(nk, generator=g) < 0.2] = -1e30
    return bias.to(dev)


def _write_predict_dirs(root: Path, n_query: int, n_ref: int, hw=PHW) -> tuple[Path, Path]:
    """Seeded ``hw`` RGB PNGs: ``n_query`` renders and ``n_ref`` references
    (smooth random fields, each render a noisy copy of a reference)."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(SEED)
    qdir, rdir = root / "query", root / "reference"
    qdir.mkdir(parents=True)
    rdir.mkdir(parents=True)
    h, w = hw
    refs = []
    for i in range(n_ref):
        coarse = rng.random((h // 60 + 1, w // 60 + 1, 3))
        img = np.kron(coarse, np.ones((60, 60, 1)))[:h, :w]
        refs.append(img)
        Image.fromarray((img * 255).astype(np.uint8)).save(rdir / f"frame_{i:05d}.png")
    for i in range(n_query):
        img = np.clip(refs[i % n_ref] + 0.1 * rng.standard_normal((h, w, 3)), 0, 1)
        Image.fromarray((img * 255).astype(np.uint8)).save(qdir / f"frame_{i:05d}.png")
    return qdir, rdir


def _k89_inputs(randn, shape, dtype):
    """K8/K9 operands at ``shape`` (K89_SHAPES): -> the head-major views (q,
    k, v, o, do, l, m) of token-major (B, N, H*hd) tensors, and the
    token-major (q, k, v, o, do, l, m) that K4 takes for the same work (None
    for a shard fed the global statistics). o, l and m come from K7 over
    the global KV length; the backward then takes the first Nk keys."""
    from crossscore_tpu_torch.ops.flash_attention import _merge_heads, flash_attention_head_major

    bb, hh, n_q, nk, hdim, nk_global = shape
    xq, xdo = randn(bb, n_q, hh * hdim, dtype=dtype), randn(bb, n_q, hh * hdim, dtype=dtype)
    xk, xv = (randn(bb, nk_global or nk, hh * hdim, dtype=dtype) for _ in range(2))
    q, k, v, do = (t.view(bb, -1, hh, hdim).transpose(1, 2) for t in (xq, xk, xv, xdo))
    o, l, m = flash_attention_head_major(q, k, v)
    hm = [q, k[:, :, :nk], v[:, :, :nk], o, do, l, m]
    tm = None if nk_global else (xq, xk, xv, _merge_heads(o).contiguous(), xdo, l, m)
    return hm, tm


@contextlib.contextmanager
def _gates(record: list | None = None, pinned: list | None = None):
    """The decoder's ReLUs and the head's leaky ReLU (``F.relu``,
    ``F.leaky_relu``), in call order. ``record``: each call's own gate
    (input > 0) is appended, as a bool tensor; ``pinned``: each call takes
    its gate from the list instead of its input's sign, returning y * gate (y *
    where(gate, 1, slope)) with that gate's gradient, so a net run at
    another's gates takes the same side of every kink. A gate of another
    shape, or a count that differs, fails."""
    import torch
    import torch.nn.functional as F

    relu, leaky = F.relu, F.leaky_relu
    todo = None if pinned is None else list(pinned)

    def gate(y):
        if record is not None:
            record.append((y > 0).detach())
        if todo is None:
            return None
        if not todo:
            _fail("a net ran more ReLUs than the gates pinned")
        g = todo.pop(0)
        if tuple(g.shape) != tuple(y.shape):
            _fail(f"pinned gate {tuple(g.shape)} for a ReLU input {tuple(y.shape)}")
        return g.to(y.device)

    def relu_(y, inplace=False):
        g = gate(y)
        return relu(y) if g is None else y * g.to(y.dtype)

    def leaky_(y, negative_slope=0.01, inplace=False):
        g = gate(y)
        return leaky(y, negative_slope) if g is None else \
            y * torch.where(g, 1.0, negative_slope).to(y.dtype)

    F.relu, F.leaky_relu = relu_, leaky_
    try:
        yield
    finally:
        F.relu, F.leaky_relu = relu, leaky
    if todo:
        _fail(f"{len(todo)} pinned gates were not used")


class _Tee:
    """stdout that also keeps what was written (the CLI's report lines)."""

    def __init__(self, out):
        self.out, self.text = out, []

    def write(self, s):
        self.text.append(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


# the forward's head dims whose instantiations must compile without spills
# or serialised wgmma (the main path's: the decoder's 48, the backbone's 64)
FWD_STRICT_HDS = (48, 64)
# the dynamic shared memory a block may take on the H100
SMEM_LIMIT = 232448


def _ptxas_entries(_build, src: str, pattern: str) -> dict:
    """What ``-Xptxas -v`` says of each entry function of ``src`` whose
    mangled name matches ``pattern``: {match groups: {registers, spill
    stores, spill loads, static smem, wgmma serialised}}."""
    log = (_build.BUILD_DIR / f"{src}.log").read_text().splitlines()
    out, key = {}, None
    for line in log:
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            k = re.search(pattern, m.group(1))
            key = k.groups() if k else None
            if key:
                out.setdefault(key, {})
            continue
        if "C7515" in line or "instructions are serialized" in line:  # the function named, else the current entry
            named = re.search(r"_Z\w+", line)
            k = re.search(pattern, named.group(0)) if named else None
            target = k.groups() if k else None if named else key
            if target:
                out.setdefault(target, {})["wgmma serialised"] = "yes"
        if key is None:
            continue
        for name, pat in (("registers", r"Used (\d+) registers"), ("spill stores", r"(\d+) bytes spill stores"),
                          ("spill loads", r"(\d+) bytes spill loads"), ("static smem", r"(\d+) bytes smem")):
            m = re.search(pat, line)
            if m:
                out[key][name] = int(m.group(1))
    return out


def _wgmma_build_report(_build) -> dict:
    """Print, for the bf16 kernels on wgmma, what ``-Xptxas -v`` says of each
    (registers at launch, spill stores and loads, static shared memory, any
    wgmma it serialised: C7515 and the other notes that say so) and the tile
    plans from the libraries: the forward's at each head dim (K1, K3, K5-K7,
    K11, K7'; ``attn_fwd_wgmma<HD, BIAS, MODE>``: q rows a block, KV tile,
    stages, dynamic shared memory), the backward's (K4, K8, K9; K12 with
    PROBE) and the fused MLP's at D 64 and 384 (K2, K10; ``ln_mlp_tma<D,
    RES, TANH>``: rows a block, blocks a cluster, hidden chunk, the two
    rings' stages, dynamic shared memory, W1/W2 bytes read from L2 per 1000
    rows). Fail on a spill or a serialised wgmma in the forward's hd 48 or 64
    instantiations or in any ``ln_mlp_tma``, on a head dim or width without
    a plan, on a plan above the block's shared memory, or on an MLP plan
    whose L2 weight reads at the predict point exceed half of 64-row blocks
    that each read both matrices. Return the MLP's plan at D 384."""
    import ctypes

    bad = []
    for (width, res, tanh), info in _ptxas_entries(_build, "fused_ln_mlp", r"ln_mlp_tmaILi(\d+)ELb(\d)ELb(\d)E").items():
        print(f"  ptxas fused_ln_mlp ln_mlp_tma<{width}, {'K10' if res == '1' else 'K2'}, "
              f"{'tanh' if tanh == '1' else 'erf'}>: " + ", ".join(f"{k} {v}" for k, v in info.items()))
        if info.get("spill stores") or info.get("spill loads") or "wgmma serialised" in info:
            bad.append(f"fused_ln_mlp ln_mlp_tma<{width}, {res}, {tanh}>")
    for src in ("flash_qkv", "flash_cross"):
        for (hd, bias, mode), info in _ptxas_entries(_build, src, r"attn_fwd_wgmmaILi(\d+)ELb(\d)ELi(\d)E").items():
            print(f"  ptxas {src} attn_fwd_wgmma<{hd}, {'BIAS' if bias == '1' else 'no bias'}, mode {mode}>: "
                  + ", ".join(f"{k} {v}" for k, v in info.items()))
            if int(hd) in FWD_STRICT_HDS and (info.get("spill stores") or info.get("spill loads")
                                              or "wgmma serialised" in info):
                bad.append(f"{src} attn_fwd_wgmma<{hd}, {bias}, {mode}>")
    for src in ("flash_cross_bwd", "lane_pad_probe"):
        for (kern, hd, probe), info in _ptxas_entries(_build, src, r"(attn_bwd_\w+_wgmma)ILi(\d+)ELb(\d)").items():
            print(f"  ptxas {src} {kern}<{hd}{', PROBE' if probe == '1' else ''}>: "
                  + ", ".join(f"{k} {v}" for k, v in info.items()))
    fwd = _build.load("flash_cross").cs_flash_attention_fwd_plan
    bwd = _build.load("flash_cross_bwd").cs_flash_attention_bwd_plan
    for fn in (fwd, bwd):
        fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_void_p], ctypes.c_int
    for hdim in range(16, 129, 16):
        out = (ctypes.c_int * 6)()
        if fwd(hdim, ctypes.addressof(out)) != 0:
            _fail(f"the bf16 forward has no tile plan at hd {hdim}")
        rows, bk, stages, smem = out[:4]
        print(f"  bf16 forward plan hd {hdim}: {rows} q rows a block over KV tiles of {bk}, {stages} stages, "
              f"dynamic shared memory {smem} bytes")
        if smem > SMEM_LIMIT:
            bad.append(f"forward plan hd {hdim}: {smem} bytes of shared memory")
        if bwd(hdim, ctypes.addressof(out)) != 0:
            _fail(f"the bf16 backward has no tile plan at hd {hdim}")
        rows, bq, bk, stages, smem1, smem2 = out
        print(f"  bf16 backward plan hd {hdim}: pass 1 {rows} KV rows a block over q tiles of {bq}, pass 2 {rows} "
              f"q rows over KV tiles of {bk}, {stages} stages, dynamic shared memory {smem1} / {smem2} bytes")
    mlp = _build.load("fused_ln_mlp").cs_fused_ln_mlp_plan
    mlp.argtypes, mlp.restype = [ctypes.c_int, ctypes.c_void_p], ctypes.c_int
    plan = {}
    for width in (64, 384):
        out = (ctypes.c_int * 7)()
        if mlp(width, ctypes.addressof(out)) != 0:
            _fail(f"the bf16 fused MLP has no plan at D {width}")
        rows, cl, fch, s1, s2, smem, per_1000 = out
        # W1 and W2 (4 D^2 bf16 values) read once per cluster at the predict point
        weights = 2 * 2 * width * 4 * width
        l2 = -(-PREDICT_ROWS // (rows * cl)) * weights
        old = -(-PREDICT_ROWS // 64) * weights
        print(f"  bf16 fused MLP plan D {width}: {rows} rows a block, clusters of {cl}, hidden chunks of {fch}, "
              f"{s1} + {s2} ring stages, dynamic shared memory {smem} bytes; W1/W2 read from L2: {per_1000} bytes "
              f"per 1000 rows, {l2 / 1e9:.3f} GB at the predict point's {PREDICT_ROWS} rows (64-row blocks that "
              f"each read them: {old / 1e9:.3f} GB)")
        if smem > SMEM_LIMIT:
            bad.append(f"fused MLP plan D {width}: {smem} bytes of shared memory")
        if 2 * l2 > old:
            bad.append(f"fused MLP plan D {width}: {l2} bytes of L2 weight reads at the predict point")
        plan = dict(rows_per_block=rows, cluster=cl, hidden_chunk=fch, stages=[s1, s2], smem_bytes=smem,
                    l2_weight_bytes_per_1000_rows=per_1000, l2_weight_bytes_predict=l2)
    if bad:
        _fail("the wgmma kernels' build: " + "; ".join(bad))
    return plan


def _twice(fn, *args):
    """``fn(*args)`` and whether a second launch on the same inputs gives the
    same bits."""
    import torch

    first, again = fn(*args), fn(*args)
    return first, all(torch.equal(a, b) for a, b in zip(first, again))


def _rank_launches() -> dict:
    from crossscore_tpu_torch.ops.flash_attention import (
        flash_attention_bwd_multi, flash_attention_bwd_single, flash_attention_head_major,
        flash_cross_attention, flash_cross_attention_bwd, flash_cross_attention_masked,
        flash_qkv_self_attention, flash_qkv_self_attention_masked,
    )
    from crossscore_tpu_torch.ops.flash_attention import (
        flash_attention_head_major_variant, flash_qkv_self_attention_chunked, flash_qkv_self_attention_probe,
    )
    from crossscore_tpu_torch.ops.fused_mlp import fused_ln_mlp, fused_res_ln_mlp
    from crossscore_tpu_torch.ops.lane_pad_probe import lane_pad_probe

    return {"K1": flash_qkv_self_attention, "K2": fused_ln_mlp, "K3": flash_cross_attention,
            "K4": flash_cross_attention_bwd, "K5": flash_qkv_self_attention_masked,
            "K6": flash_cross_attention_masked, "K7": flash_attention_head_major,
            "K8": flash_attention_bwd_single, "K9": flash_attention_bwd_multi,
            # the timing instruments (K11 and K7' also count per mode in .launches_by_mode)
            "K10": fused_res_ln_mlp, "K11 probe": flash_qkv_self_attention_probe,
            "K11 chunks": flash_qkv_self_attention_chunked, "K7'": flash_attention_head_major_variant,
            "K12": lane_pad_probe}


def _launches(**counts) -> dict:
    """Expected launches: the named counts, 0 for every other kernel."""
    return {k: counts.get(k, 0) for k in _rank_launches()}


@contextlib.contextmanager
def _one_nccl_rank():
    """This process as the one rank of an NCCL process group: the launcher's
    environment set for the block and restored after, the group left."""
    import os

    from crossscore_tpu_torch.parallel import mesh
    from crossscore_tpu_torch.parallel.launch import free_port

    env = dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", LOCAL_WORLD_SIZE="1", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(free_port()))
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        mesh.init_distributed("nccl", "cuda")
        yield
    finally:
        mesh.teardown()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _tp_train_rank(dtype_name: str, batch_np: dict) -> dict:
    """One rank of TP = 2 (gloo; the ranks share the card): one train step of
    the seeded dinov2-small net on the ``tp`` route (fp32: K2 exact, bf16:
    the default tanh form) -> the global loss and this rank's score map, the
    step's launches, ms/step, and on rank 0 the gradients, the updated
    parameters and the gates of the step's ReLUs (``_gates``), each gathered
    over the model group."""
    import torch
    import torch.distributed as dist

    from crossscore_tpu_torch.confsys import load_config
    from crossscore_tpu_torch.io.convert import init_params, load_into
    from crossscore_tpu_torch.models import CrossScoreConfig, CrossScoreNet
    from crossscore_tpu_torch.parallel import mesh
    from crossscore_tpu_torch.parallel.collectives import all_gather
    from crossscore_tpu_torch.parallel.tensor_parallel import gather_state_dict, shard_state_dict
    from crossscore_tpu_torch.train.optim import make_optimizer
    from crossscore_tpu_torch.train.step import TrainState, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _, dev = mesh.init_distributed("gloo", "cuda")
    try:
        mesh.make_groups(2)
        group = mesh.model_group()
        dtype = getattr(torch, dtype_name)
        cfg = CrossScoreConfig(compute_dtype=dtype, attention_impl="tp",
                               mlp_impl="fused_exact" if dtype == torch.float32 else "fused")
        model = load_into(CrossScoreNet(cfg, device=dev), shard_state_dict(
            init_params(cfg, SEED, dev), dist.get_rank(group), dist.get_world_size(group), cfg.mlp_impl))
        optimizer, scheduler, _ = make_optimizer(load_config("default"), model, steps_per_epoch=1)
        step = make_train_step(model, optimizer, scheduler)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in batch_np.items()}
        wrappers = _rank_launches()
        for w in wrappers.values():
            w.launches = 0
        gates = []
        with _gates(record=gates):
            state, metrics = step(TrainState(), batch)
        torch.cuda.synchronize()
        out = {"loss": float(metrics["loss"]), "launches": {k: w.launches for k, w in wrappers.items()},
               "pred": metrics["pred"].float().cpu().numpy()}
        trained = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
        grads = gather_state_dict({n: p.grad for n, p in trained}, group, cfg.mlp_impl)
        params = gather_state_dict({n: p.detach() for n, p in trained}, group, cfg.mlp_impl)
        # each ReLU's input is a column-parallel layer's: this rank's features
        gates = [all_gather(g.to(torch.uint8), group, dim=-1).bool() for g in gates]
        if dist.get_rank() == 0:
            out["grads"] = {k: v.cpu().numpy() for k, v in grads.items()}
            out["params"] = {k: v.cpu().numpy() for k, v in params.items()}
            out["gates"] = [g.cpu().numpy() for g in gates]
        out["ms"] = _time_ms(torch, lambda: step(state, batch), reps=3)
        return out
    finally:
        mesh.teardown()


def _vp_train_rank(batch_np: dict) -> dict:
    """One rank of view-parallel training (gloo; the ranks share the card):
    one fp32 backward of the seeded net on the ``cp`` route, the PE
    trainable, this rank's reference views -> its launches, score map, the
    gates of its ReLUs (``_gates``; the query side is whole on every rank)
    and every trainable gradient."""
    import torch

    from crossscore_tpu_torch.io.convert import init_params, load_into
    from crossscore_tpu_torch.models import CrossScoreConfig, CrossScoreNet
    from crossscore_tpu_torch.parallel import mesh
    from crossscore_tpu_torch.parallel.view_parallel import view_shard
    from crossscore_tpu_torch.train.step import loss_fn

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _, dev = mesh.init_distributed("gloo", "cuda")
    try:
        cfg = CrossScoreConfig(compute_dtype=torch.float32, attention_impl="cp", mlp_impl="fused_exact",
                               pe_trainable=True)
        model = load_into(CrossScoreNet(cfg, device=dev), init_params(cfg, SEED, dev))
        refs = batch_np["reference/cross/imgs"]
        batch = {k: torch.from_numpy(v).to(dev) for k, v in batch_np.items()}
        batch["reference/cross/imgs"] = torch.from_numpy(refs[:, view_shard(refs.shape[1])].copy()).to(dev)
        wrappers = _rank_launches()
        for w in wrappers.values():
            w.launches = 0
        gates = []
        with _gates(record=gates):
            loss, (pred, _, _) = loss_fn(model, batch)
        loss.backward()
        torch.cuda.synchronize()
        return {"launches": {k: w.launches for k, w in wrappers.items()}, "pred": pred.detach().cpu().numpy(),
                "gates": [g.cpu().numpy() for g in gates],
                "grads": {n: p.grad.cpu().numpy() for n, p in model.named_parameters() if p.requires_grad}}
    finally:
        mesh.teardown()


def _vp_forward_rank(query, refs) -> dict:
    """One rank of the fp32 B=1 view-parallel forward (gloo, the ranks share
    the card): the seeded net built with the ``cp`` route, this rank's views."""
    import torch

    from crossscore_tpu_torch.io.convert import init_params, load_into
    from crossscore_tpu_torch.models import CrossScoreConfig, CrossScoreNet
    from crossscore_tpu_torch.parallel import mesh
    from crossscore_tpu_torch.parallel.view_parallel import make_view_parallel_apply, view_shard

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _, dev = mesh.init_distributed("gloo", "cuda")
    try:
        cfg = CrossScoreConfig(compute_dtype=torch.float32, attention_impl="cp", mlp_impl="fused_exact")
        model = load_into(CrossScoreNet(cfg, device=dev), init_params(cfg, SEED, dev))
        wrappers = _rank_launches()
        for w in wrappers.values():
            w.launches = 0
        q = torch.from_numpy(query).to(dev)
        r = torch.from_numpy(refs[:, view_shard(refs.shape[1])].copy()).to(dev)
        maps = make_view_parallel_apply(model)(q, r).cpu().numpy()
        return {"maps": maps, "launches": {k: w.launches for k, w in wrappers.items()}}
    finally:
        mesh.teardown()


def _vp_cli_rank(argv: list) -> dict:
    """One rank of the predict CLI, its report lines captured, with its
    kernel launches counted from 0."""
    import contextlib
    import io

    from crossscore_tpu_torch.tasks.predict import main as predict_main

    wrappers = _rank_launches()
    for w in wrappers.values():
        w.launches = 0
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        predict_main(argv)
    return {"text": out.getvalue(), "launches": {k: w.launches for k, w in wrappers.items()}}


def _profile(torch, fn, step_ms: float, top: int = 16, what: str = "train step") -> float:
    """Print the device-time breakdown of one call of ``fn`` (torch.profiler,
    after the caller's warm-up): device ms per kernel, launches, and the
    device's busy share of ``step_ms``, the call's unprofiled time; return
    the busy ms. Fails when the trace holds no kernel."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for evt in prof.key_averages():
        if "CUDA" not in str(evt.device_type):
            continue  # a CPU-side op: its kernels are listed on their own
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = evt.self_cuda_time_total
        if dev_us > 0:
            rows.append((dev_us / 1e3, evt.count, evt.key))
    if not rows:
        _fail(f"the profiler recorded no kernel of the {what}")
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    print(f"{what} device time: {busy:.3f} ms busy of a {step_ms:.3f} ms step "
          f"({100 * busy / step_ms:.1f}% busy, {len(rows)} kernel names)")
    for ms, count, key in rows[:top]:
        print(f"  {ms:9.3f} ms {100 * ms / busy:5.1f}% x{count:<4d} {key[:110]}")
    return busy


def _token_phases(torch, dev, params, vit, zero_launches, read_launches, work: Path) -> dict:
    """Step 14, token-space training on the card: (i) the full-width token
    step through ``make_train_step``; (ii) at B=1 the token graph against
    the pixel graph on tokens encoded from the same crops, and against the
    all-plain token graph, fp32 and bf16; (iii) the train CLI with
    ``train_recipe=token_fast`` and a resume; (iv) ``tasks.encode_tokens``,
    then a ``token_fast`` run on the warm store. The tree and the store stay
    in ``work`` (``datadir``, ``tokens``) for step 17. Returns the readings."""
    import dataclasses
    import math
    import tempfile

    import numpy as np

    import crossscore_tpu_torch.tasks.train as train_mod
    from crossscore_tpu_torch.confsys import load_config
    from crossscore_tpu_torch.data.synthetic import generate
    from crossscore_tpu_torch.io.convert import load_into
    from crossscore_tpu_torch.models import CrossScoreConfig, CrossScoreNet
    from crossscore_tpu_torch.models.crossscore import make_backbone_encoder
    from crossscore_tpu_torch.tasks.encode_tokens import main as encode_main
    from crossscore_tpu_torch.train.optim import make_optimizer
    from crossscore_tpu_torch.train.step import TrainState, loss_fn, make_train_step

    tok: dict = {}
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    d = vit.hidden_size
    nq = (HW // vit.patch_size) ** 2  # 1369 tokens a view

    # (i) the token step at the train point: B=24, K=5, 37x37 windows, bf16
    tcfg = load_config("default")
    mcfg = CrossScoreConfig.from_config(tcfg)
    n_dec = 2 * mcfg.decoder_layers
    model = load_into(CrossScoreNet(mcfg, device=dev), params)
    optimizer, scheduler, _ = make_optimizer(tcfg, model, steps_per_epoch=1)
    step = make_train_step(model, optimizer, scheduler)
    batch = {"query/tokens": torch.randn(TB, nq, d, generator=gen, device=dev).to(torch.bfloat16),
             "reference/cross/tokens": torch.randn(TB, TK, nq, d, generator=gen, device=dev).to(torch.bfloat16),
             "query/score_map": torch.rand(TB, HW, HW, generator=gen, device=dev),
             "_valid": torch.tensor(TB, device=dev)}
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    zero_launches()
    state, metrics = step(TrainState(), batch)
    torch.cuda.synchronize()
    tok["launches"] = read_launches()
    want = _launches(K3=n_dec, K4=n_dec)
    print(f"token train step launches: {tok['launches']} (expected {want})")
    if tok["launches"] != want:
        _fail(f"token train launch counts {tok['launches']} != {want}")
    loss = float(metrics["loss"])
    if not np.isfinite(loss) or tuple(metrics["pred"].shape) != (TB, HW, HW):
        _fail(f"token train step loss {loss} / pred shape {tuple(metrics['pred'].shape)}")
    after = model.state_dict()
    frozen = [k for k in after if k.startswith("backbone.") or k == "pos_enc_fn.PE"]
    trained = [k for k, prm in model.named_parameters() if prm.requires_grad]
    moved_frozen = [k for k in frozen if not torch.equal(after[k], before[k])]
    unmoved = [k for k in trained if torch.equal(after[k], before[k])]
    if moved_frozen or unmoved or not all(k.startswith("ref_cross.") for k in trained):
        _fail(f"token step: frozen parameters moved {moved_frozen[:3]}, trained ones did not {unmoved[:3]}")
    torch.cuda.reset_peak_memory_stats()
    tok["step_ms"] = _time_ms(torch, lambda: step(state, batch), reps=5)
    tok["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    tok["loss"] = loss
    print(f"token train step: loss {loss:.6f}, {len(trained)} decoder/head tensors updated, {len(frozen)} "
          f"backbone/PE tensors bit-identical; {tok['step_ms']:.2f} ms per step of B={TB}, K={TK} "
          f"({nq} tokens a view, bf16 compute, fp32 master weights; median of 5 after warm-up); peak memory "
          f"{tok['peak_gib']:.2f} GiB")
    _profile(torch, lambda: step(state, batch), tok["step_ms"], what="token train step")
    del model, optimizer, scheduler, step, batch, before, after, metrics, state
    torch.cuda.empty_cache()

    # (ii) B=1: the token graph on tokens encoded from the same crops against
    # the pixel graph (the same function: the encoder runs the pixel graph's
    # backbone batch), and against the all-plain token graph
    q1 = torch.randint(0, 256, (1, HW, HW, 3), generator=gen, device=dev, dtype=torch.uint8)
    r1 = torch.randint(0, 256, (1, TK, HW, HW, 3), generator=gen, device=dev, dtype=torch.uint8)
    gt1 = torch.rand(1, HW, HW, generator=gen, device=dev)
    tok["b1"] = {}
    for dtype in (torch.float32, torch.bfloat16):
        tname = str(dtype).split(".")[-1]
        nets = {impl: load_into(CrossScoreNet(dataclasses.replace(mcfg, compute_dtype=dtype, attention_impl=impl,
                                                                  mlp_impl=mlp), device=dev), params)
                for impl, mlp in (("flash", "fused_exact"), ("dense", "unfused"))}
        tokens = make_backbone_encoder(nets["flash"].cfg)(nets["flash"], torch.cat([q1, r1[0]]))
        token_batch = {"query/tokens": tokens[:1], "reference/cross/tokens": tokens[1:][None],
                       "query/score_map": gt1}
        runs = {}
        for tag, net, b1 in (("pixel", nets["flash"], {"query/img": q1, "reference/cross/imgs": r1,
                                                        "query/score_map": gt1}),
                             ("token", nets["flash"], token_batch), ("token plain", nets["dense"], token_batch)):
            net.zero_grad(set_to_none=True)
            loss, (pred, _, _) = loss_fn(net, b1)
            loss.backward()
            runs[tag] = (pred.detach().float(),
                         {n: prm.grad.clone() for n, prm in net.named_parameters() if prm.grad is not None})
        for ref in ("pixel", "token plain"):
            mae = float((runs["token"][0] - runs[ref][0]).abs().mean())
            errs = []
            for leaf, g in runs[ref][1].items():
                got = runs["token"][1][leaf]
                errs.append(float((got - g).abs().max() / g.abs().max()) if dtype == torch.float32
                            else float(torch.linalg.vector_norm(got - g) / torch.linalg.vector_norm(g)))
            tok["b1"][f"{tname} vs {ref}"] = {"mae": mae, "grad_err": max(errs), "leaves": len(errs)}
            print(f"token graph B=1 {tname} vs {ref}: score MAE {mae:.3e} (tol {NET_TOL[tname]:.1e}), "
                  f"{len(errs)} gradient leaves, worst {max(errs):.3e} (tol {GRAD_TOL[tname]:.1e})")
            if not (mae < NET_TOL[tname] and max(errs) <= GRAD_TOL[tname]
                    and runs["token"][1].keys() == runs[ref][1].keys()):
                _fail(f"token graph {tname} against {ref}: MAE {mae}, gradients {max(errs)}")
    del nets, tokens, token_batch, runs
    torch.cuda.empty_cache()

    # (iii) the train CLI with train_recipe=token_fast, then a resume; and
    # (iv) tasks.encode_tokens, then a token_fast run on the warm store. The
    # encoder's and the eval step's calls are counted, so that K1 and K2
    # (12 a call) are held to cache misses and validation exactly
    calls = {"encode": 0, "eval": 0}
    make_encoder, make_eval = train_mod.make_backbone_encoder, train_mod.make_eval_step

    def counted(factory, key):
        def make(*args, **kw):
            fn = factory(*args, **kw)

            def call(*a, **kw):
                calls[key] += 1
                return fn(*a, **kw)
            return call
        return make

    def rows(run):
        return [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]

    train_mod.make_backbone_encoder = counted(make_encoder, "encode")
    train_mod.make_eval_step = counted(make_eval, "eval")
    n_layers = vit.num_layers
    try:
        with contextlib.nullcontext(str(work)) as tmp:
            t0 = time.perf_counter()
            # step 8's tree: reference pools of 4 and 3 captures, so that the
            # empty placeholder pads K=5 slots and its tokens are cached too
            generate(Path(tmp) / "datadir", hw=(540, 720), scenes_per_split={"train": 1, "test": 1}, seed=SEED)
            ov = [f"data.dataset.path=[{tmp}/datadir]", f"run.dir={tmp}/log",
                  "data.loader.train.batch_size=2", "data.loader.validation.batch_size=2",
                  "data.loader.train.num_workers=4", "data.loader.validation.num_workers=4",
                  "trainer.num_sanity_val_steps=1", "trainer.limit_val_batches=1",
                  "logger.vis_scalar_every_n_train_steps=1", "this_main.train_recipe=token_fast"]
            zero_launches()
            tee = _Tee(sys.stdout)
            with contextlib.redirect_stdout(tee):
                run1 = train_mod.main(ov + ["trainer.max_steps=2", "alias=token_first"])
                run2 = train_mod.main(ov + ["trainer.max_steps=4", f"trainer.ckpt_path_to_load={run1 / 'ckpt'}",
                                            "alias=token_resumed"])
            torch.cuda.synchronize()
            cli = {"launches": read_launches(), **calls, "s": time.perf_counter() - t0}
            text = "".join(tee.text)
            steps1 = [r["step"] for r in rows(run1) if "train/loss" in r]
            steps2 = [r["step"] for r in rows(run2) if "train/loss" in r]
            losses = [r["train/loss"] for r in rows(run1) + rows(run2) if "train/loss" in r]
            val = [r["validation/loss"] for r in rows(run1) + rows(run2) if "validation/loss" in r]
            ckpts = sorted(p.name for p in (run2 / "ckpt").glob("*.ckpt"))
            n_steps = len(steps1) + len(steps2)
            want = _launches(K1=n_layers * (cli["encode"] + cli["eval"]), K2=n_layers * (cli["encode"] + cli["eval"]),
                             K3=n_dec * (n_steps + cli["eval"]), K4=n_dec * n_steps)
            tok["cli"] = cli | {"steps": steps1 + steps2, "losses": losses, "val": val}
            print(f"token_fast train CLI (dinov2-small, 518 px windows of 532x714 grids, B=2, K={TK}, bf16): steps "
                  f"{steps1} then, resumed, {steps2}; losses {[round(x, 6) for x in losses]}; validation losses "
                  f"{[round(x, 6) for x in val]}; checkpoints {ckpts}; encoder calls {cli['encode']}, validation "
                  f"batches {cli['eval']}; launches {cli['launches']} (expected {want}); {cli['s']:.1f} s")
            if steps1 != [1, 2] or steps2 != [3, 4] or not all(np.isfinite(losses)) or len(val) < 2 \
                    or ckpts != ["step_00000004.ckpt"] or cli["launches"] != want or not cli["encode"] \
                    or text.count("token cache: ") != 2:
                _fail("token_fast train CLI run or resume")

            t0 = time.perf_counter()
            store = f"{tmp}/tokens"
            zero_launches()
            n_images = encode_main(ov + [f"this_main.ref_token_cache_dir={store}"])
            torch.cuda.synchronize()
            enc_launches = read_launches()
            # the images and the empty placeholder at their one shape, in
            # chunks of the encode batch
            n_chunks = math.ceil((n_images + 1) / int(tcfg.this_main.ref_token_cache_encode_batch))
            want = _launches(K1=n_layers * n_chunks, K2=n_layers * n_chunks)
            tok["encode_tokens"] = {"images": n_images, "launches": enc_launches, "s": time.perf_counter() - t0,
                                    "files": len(list(Path(store).glob("*.npz")))}
            print(f"encode_tokens: {n_images} images ({tok['encode_tokens']['files']} files, the empty "
                  f"placeholder among them) in {tok['encode_tokens']['s']:.1f} s; launches {enc_launches} "
                  f"(expected {want})")
            # one train scene: 4 + 3 renders and as many captures
            if n_images != 14 or tok["encode_tokens"]["files"] != n_images + 1 or enc_launches != want:
                _fail("encode_tokens")

            calls.update(encode=0, eval=0)
            zero_launches()
            tee = _Tee(sys.stdout)
            with contextlib.redirect_stdout(tee):
                run3 = train_mod.main(ov + ["trainer.max_steps=2", f"this_main.ref_token_cache_dir={store}",
                                            "alias=token_warm"])
            torch.cuda.synchronize()
            warm = {"launches": read_launches(), **calls}
            cache_line = re.search(r"token cache: (\d+) hits, (\d+) misses, (\d+) disk hits", "".join(tee.text))
            steps3 = [r["step"] for r in rows(run3) if "train/loss" in r]
            want = _launches(K1=n_layers * warm["eval"], K2=n_layers * warm["eval"],
                             K3=n_dec * (len(steps3) + warm["eval"]), K4=n_dec * len(steps3))
            tok["warm"] = warm | {"steps": steps3, "cache": cache_line.groups() if cache_line else None}
            print(f"token_fast on the warm store: steps {steps3}; encoder calls {warm['encode']}; token cache "
                  f"{tok['warm']['cache']} (hits, misses, disk hits); launches {warm['launches']} (expected {want})")
            if steps3 != [1, 2] or warm["encode"] or warm["launches"] != want or cache_line is None \
                    or cache_line.group(2) != "0" or cache_line.group(3) == "0":
                _fail("token_fast run on the warm store encoded or launched K1/K2 outside validation")
    finally:
        train_mod.make_backbone_encoder, train_mod.make_eval_step = make_encoder, make_eval
    return tok


@contextlib.contextmanager
def _pillow_only(on: bool):
    """``CROSSSCORE_NO_NATIVE=1`` for the block when ``on``: the dataset
    decodes with Pillow (the port reads the variable at every call)."""
    import os

    old = os.environ.pop("CROSSSCORE_NO_NATIVE", None)
    if on:
        os.environ["CROSSSCORE_NO_NATIVE"] = "1"
    try:
        yield
    finally:
        os.environ.pop("CROSSSCORE_NO_NATIVE", None)
        if old is not None:
            os.environ["CROSSSCORE_NO_NATIVE"] = old


def _decoder_build() -> dict:
    """Step 17(a), the build: g++'s version, whether ``png.h`` is found, the
    build's seconds; fails on any build error but a missing ``png.h``."""
    import os
    import shutil
    import subprocess

    from crossscore_tpu_torch.data import fastimage
    from crossscore_tpu_torch.ops import _build

    import ctypes.util

    gxx = shutil.which("g++")
    version = subprocess.run([gxx, "--version"], capture_output=True, text=True,
                             timeout=60).stdout.splitlines()[0] if gxx else None

    def header(name: str) -> bool:
        return gxx is not None and subprocess.run([gxx, "-E", "-x", "c++", "-", "-o", os.devnull],
                                                  input=f"#include <{name}>\n", capture_output=True, text=True,
                                                  timeout=60).returncode == 0

    png_h = header("png.h")
    # what a decoder without libpng's headers could link against instead
    print(f"host libraries: zlib.h {'found' if header('zlib.h') else 'not found'}; shared libpng "
          f"{ctypes.util.find_library('png16') or ctypes.util.find_library('png')}; shared zlib "
          f"{ctypes.util.find_library('z')}")
    built_before = _build.host_library_path().exists()
    t0 = time.perf_counter()
    error = None
    try:
        _build.build_host()
    except RuntimeError as e:
        error = str(e)
    info = {"gxx": version, "png_h": png_h, "build_s": time.perf_counter() - t0, "built_before": built_before,
            "native": error is None, "error": error}
    print(f"native decoder: {version}; png.h {'found' if png_h else 'not found'}; g++ build "
          f"{info['build_s']:.1f} s{' (the library was there)' if built_before else ''}; "
          f"{'built' if error is None else 'NOT built'}")
    if error is not None:
        print("native decoder build error: " + " | ".join(error.splitlines()[-8:]))
        if png_h or "png.h" not in error:
            _fail("the native decoder failed to build for another reason than a missing png.h")
    elif not fastimage.available():
        _fail(f"the native decoder built but does not load: {fastimage.load_error()}")
    return info


def _decoder_equality(tmp: Path) -> dict:
    """Step 17(a), a seeded 540x960 PNG decoded natively against the Pillow
    path: float32 resized to a short side of 518 and trimmed to whole
    patches, the uint8 wire (cropped, and resized), and a ``CSRT`` payload
    of it."""
    import numpy as np

    from crossscore_tpu_torch.data import fastimage
    from crossscore_tpu_torch.data.nvs_index import to_wire_uint8
    from crossscore_tpu_torch.data.records import encode_raw_payload
    from crossscore_tpu_torch.io.images import image_read, image_read_bytes, normalize_imagenet
    from crossscore_tpu_torch.ops.interpolate import resize_bilinear_antialias

    qdir, _ = _write_predict_dirs(tmp, 1, 1)
    path = str(qdir / "frame_00000.png")
    h, w = PHW
    rh, rw = HW, round(w * HW / h)  # 518x921
    trim = (0, 0, rh - rh % 14, rw - rw % 14)  # 518x910
    crop = (11, 25, rh - rh % 14, rw - rw % 14)  # an unresized crop of the same size
    sl = lambda c: (slice(c[0], c[0] + c[2]), slice(c[1], c[1] + c[3]))  # noqa: E731
    px = image_read(path)
    resized = resize_bilinear_antialias(px, rh, rw)
    payload = encode_raw_payload(path)
    pairs = {
        "float32 resized+trimmed, native vs Pillow": (
            fastimage.load_rgb(path, resize_hw=(rh, rw), crop=trim), normalize_imagenet(resized[sl(trim)])),
        "uint8 wire cropped, native vs Pillow": (
            fastimage.load_rgb(path, crop=crop, as_uint8=True), to_wire_uint8(px[sl(crop)])),
        "uint8 wire resized+trimmed, native vs Pillow": (
            fastimage.load_rgb(path, resize_hw=(rh, rw), crop=trim, as_uint8=True), to_wire_uint8(resized[sl(trim)])),
        "CSRT float32 resized+trimmed, native vs native PNG": (
            fastimage.load_rgb_bytes(payload, resize_hw=(rh, rw), crop=trim),
            fastimage.load_rgb(path, resize_hw=(rh, rw), crop=trim)),
        "CSRT uint8 wire resized+trimmed, native vs native PNG": (
            fastimage.load_rgb_bytes(payload, resize_hw=(rh, rw), crop=trim, as_uint8=True),
            fastimage.load_rgb(path, resize_hw=(rh, rw), crop=trim, as_uint8=True)),
        "CSRT, Pillow path vs Pillow PNG": (image_read_bytes(payload), px),
    }
    out = {}
    for name, (got, want) in pairs.items():
        d = np.abs(got.astype(np.float64) - want.astype(np.float64))
        out[name] = {"bit_equal": bool(np.array_equal(got, want)), "max_abs": float(d.max()),
                     "n_differ": int((d > 0).sum()), "n": int(d.size)}
        r = out[name]
        print(f"decode {name} ({got.shape} {got.dtype}): bit-equal {r['bit_equal']}; max |d| {r['max_abs']:.3e}, "
              f"{r['n_differ']} of {r['n']} elements differ")
    # exact: the cropped uint8 wire (a copy of the PNG's bytes) and every
    # CSRT comparison (the stored tensor is the decode's output). The float
    # and the resized uint8 Pillow comparisons may differ by roundings: the
    # Pillow path divides by 255 and sums in numpy, the C path multiplies by
    # 1/255 and g++ contracts multiply-adds under -march=native (the C path
    # equals the JAX package's decoder built with the same flags bit for bit)
    exact = [n for n in out if "cropped" in n or n.startswith("CSRT")]
    bad = [n for n in exact if not out[n]["bit_equal"]]
    bad += [n for n in out if "float32" in n and out[n]["max_abs"] > DECODE_TOL]
    bad += [n for n in out if "uint8" in n and out[n]["max_abs"] > 1]
    if bad:
        _fail("native decode against the Pillow path: " + ", ".join(bad))
    return out


def _input_phases(torch, tok_work: Path, zero_launches, read_launches) -> dict:
    """Step 17, the native host input path on the card's host: (a) the
    decoder's build and its decodes against the Pillow path; (b) the predict
    CLI from files on Pillow and natively and from PNG and decoded shards,
    uncached and cached with the decode skip; (c) the test CLI from decoded
    shards against files; (d) the ``token_fast`` CLI on step 14's warm store
    with the decode skip, against a Pillow run; (e) ``ingest_bench`` and
    ``token_assembly_bench``. Returns the readings."""
    import csv
    import json as _json
    import os
    import subprocess
    import tempfile

    import numpy as np
    from PIL import Image

    import crossscore_tpu_torch.tasks.train as train_mod
    from crossscore_tpu_torch.confsys import load_config
    from crossscore_tpu_torch.data import fastimage
    from crossscore_tpu_torch.data.pack import main as pack_main
    from crossscore_tpu_torch.data.synthetic import generate
    from crossscore_tpu_torch.io.convert import init_params
    from crossscore_tpu_torch.models import CrossScoreConfig
    from crossscore_tpu_torch.tasks.predict import main as predict_main
    from crossscore_tpu_torch.tasks.test import main as test_main

    t_start = time.perf_counter()
    inp: dict = {"cpus": os.cpu_count(), "usable_cpus": len(os.sched_getaffinity(0))}
    print(f"host: {inp['cpus']} CPUs, {inp['usable_cpus']} usable")
    inp["build"] = _decoder_build()
    native = inp["build"]["native"]

    def save_ckpt(path: Path, cfg_name: str) -> Path:
        mcfg = CrossScoreConfig.from_config(load_config(cfg_name))
        path.parent.mkdir(parents=True)
        torch.save({"state_dict": {f"model.{k}": v.cpu() for k, v in init_params(mcfg, SEED).items()}}, path)
        return path

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        if native:
            inp["decode"] = _decoder_equality(tmp / "one")

        # (b) the predict CLI: step 9's 24 renders and pool of 5, unbucketed,
        # (a) uncached and (b) cached, the decode skip on in (b) natively
        data = tmp / "predict_data"
        qdir, rdir = _write_predict_dirs(data, 3 * PB, PK)
        t0 = time.perf_counter()
        pack_main([str(data), str(tmp / "png")])
        pack_main([str(data), str(tmp / "raw"), "--decoded"])
        inp["pack_s"] = time.perf_counter() - t0
        ckpt = save_ckpt(tmp / "run" / "ckpt" / "seeded.ckpt", "default_predict")
        common = [f"trainer.ckpt_path_to_load={ckpt}", f"data.dataset.query_dir={qdir}",
                  f"data.dataset.reference_dir={rdir}", f"data.neighbour_config.cross={PK}",
                  f"data.loader.validation.batch_size={PB}", "this_main.shape_buckets=off",
                  "logger.predict.write.config.score_map_colour_mode=gray",
                  "logger.predict.write.config.vis_img_every_n_steps=-1",
                  "logger.predict.write.flag.image_query=false",
                  "logger.predict.write.flag.image_reference=false"]
        decoder = "native" if native else "pillow"
        sources = {"pillow files": (False, None), f"{decoder} png shards": (native, "png"),
                   f"{decoder} decoded shards": (native, "raw")}
        if native:
            sources = {"pillow files": (False, None), "native files": (True, None)} | {
                k: v for k, v in sources.items() if k.startswith("native")}
        pcfg = CrossScoreConfig.from_config(load_config("default_predict"))
        n_b, n_layers, n_dec = 3, pcfg.backbone.num_layers, 2 * pcfg.decoder_layers
        runs, bad = {}, []
        for src, (use_native, store) in sources.items():
            for mode, cache in (("a", "off"), ("b", "on")):
                tag = f"{src} ({mode})"
                argv = common + [f"this_main.ref_token_cache={cache}",
                                 f"logger.predict.out_dir={tmp}/out_{src.replace(' ', '_')}_{mode}"]
                if store:
                    argv.append(f"+data.dataset.record_dir={tmp / store}")
                tee = _Tee(sys.stdout)
                zero_launches()
                with _pillow_only(not use_native), contextlib.redirect_stdout(tee):
                    out = predict_main(argv)
                torch.cuda.synchronize()
                text = "".join(tee.text)
                rate = re.search(r"= ([0-9.]+) maps/s", text)
                counts = re.search(r"ref-token cache: (\d+) hits, (\d+) unique misses, (\d+) decode-skips", text)
                skip_on = "decode-skip on" in text
                r = {"launches": read_launches(), "maps_per_s": float(rate.group(1)), "skip_on": skip_on,
                     "hits": int(counts.group(1)) if counts else None,
                     "misses": int(counts.group(2)) if counts else None,
                     "skips": int(counts.group(3)) if counts else None,
                     "maps": sorted((out / "batch" / "score_map_ref_cross").glob("*.png"))}
                runs[tag] = r
                enc = n_layers * (n_b + (cache == "on"))
                want = _launches(K1=enc, K2=enc, K3=n_dec * n_b)
                print(f"predict CLI from {tag}: {r['maps_per_s']:.2f} maps/s; decode-skip "
                      f"{'on' if skip_on else 'off'}; cache hits {r['hits']}, misses {r['misses']}, decode-skips "
                      f"{r['skips']}; launches { {k: v for k, v in r['launches'].items() if v} } (expected "
                      f"{ {k: v for k, v in want.items() if v} }); {len(r['maps'])} maps")
                if r["launches"] != want or len(r["maps"]) != 3 * PB:
                    bad.append(f"{tag} launches/maps")
                if cache == "on":
                    # the first batch's slots resolve from its PK misses; every
                    # later slot is a hit or, with the skip, a decode skip
                    if r["misses"] != PK or r["hits"] + r["skips"] != (n_b - 1) * PB * PK:
                        bad.append(f"{tag} hits + misses + skips")
                    if skip_on != use_native or (r["skips"] > 0) != use_native:
                        bad.append(f"{tag} decode skip {'on' if skip_on else 'off'}, {r['skips']} skips")

        def read_maps(tag):
            return [np.asarray(Image.open(p)).astype(np.int64) for p in runs[tag]["maps"]]

        inp["predict"] = {}
        for tag, r in runs.items():
            mode = tag[-3:]
            ref_tag = f"pillow files {mode}"
            if tag != ref_tag:
                got, want = read_maps(tag), read_maps(ref_tag)
                r["byte_equal_vs_pillow_files"] = all(np.array_equal(x, y) for x, y in zip(got, want))
                r["mae_vs_pillow_files"] = float(np.mean([np.abs(x - y).mean() for x, y in zip(got, want)])) / 32767
                print(f"predict CLI maps {tag} vs {ref_tag}: byte-equal {r['byte_equal_vs_pillow_files']}; "
                      f"MAE {r['mae_vs_pillow_files']:.3e} (tol {CLI_TOL:.0e})")
                if not r["mae_vs_pillow_files"] <= CLI_TOL:
                    bad.append(f"{tag} maps against Pillow's")
            # one decoder gives the same pixels from files and from either shard
            first = f"{decoder} {'files' if native else 'png shards'} {mode}"
            if tag.startswith(decoder) and tag != first and not all(
                    np.array_equal(x, y) for x, y in zip(read_maps(tag), read_maps(first))):
                bad.append(f"{tag} maps differ from {first}'s")
            inp["predict"][tag] = {k: v for k, v in r.items() if k != "maps"}
        if bad:
            _fail("step 17 predict CLI: " + ", ".join(bad))

        # (c) the test CLI, mode (b), from decoded shards against files
        tree = tmp / "gaussian" / "single"
        generate(tree, hw=EVAL_HW, scenes_per_split={"train": 1, "test": 2}, n_train_imgs=PK, n_test_imgs=PK,
                 seed=SEED)
        pack_main([str(tree), str(tmp / "test_raw"), "--decoded"])
        ckpt = save_ckpt(tmp / "test_run" / "ckpt" / "seeded.ckpt", "default_test")
        inp["test"] = {}
        for src, extra in (("files", []), ("decoded shards", [f"data.dataset.record_dir={tmp / 'test_raw'}"])):
            tee = _Tee(sys.stdout)
            with contextlib.redirect_stdout(tee):
                out = test_main(EVAL_OVERRIDES + [f"trainer.ckpt_path_to_load={ckpt}", f"data.dataset.path=[{tree}]",
                                                  "this_main.shape_buckets=off", "this_main.ref_token_cache=on",
                                                  f"logger.test.out_dir={tmp / ('test_out_' + src[0])}"] + extra)
            rate = re.search(r"= ([0-9.]+) maps/s", "".join(tee.text))
            with open(out / "metrics.csv") as f:
                mean = {k: float(v) for k, v in list(csv.DictReader(f))[-1].items() if k != "batch_idx"}
            inp["test"][src] = {"maps_per_s": float(rate.group(1)), "mean": mean}
            print(f"test CLI (b) from {src} ({decoder}): {inp['test'][src]['maps_per_s']:.2f} maps/s; mean {mean}")
        diff = max(abs(inp["test"]["decoded shards"]["mean"][k] - v) for k, v in inp["test"]["files"]["mean"].items())
        inp["test"]["max_mean_diff"] = diff
        print(f"test CLI (b) metrics.csv mean, decoded shards vs files: max |difference| {diff:.3e} (tol 1e-6)")
        if not diff <= 1e-6:
            _fail(f"test CLI from decoded shards: mean off by {diff}")

    # (d) token_fast on step 14's warm store, with the decode skip, against a
    # Pillow run: no encoder call, no query or reference decode, the same losses
    ov = [f"data.dataset.path=[{tok_work}/datadir]", f"run.dir={tok_work}/log17",
          "data.loader.train.batch_size=2", "data.loader.validation.batch_size=2",
          "data.loader.train.num_workers=4", "data.loader.validation.num_workers=4",
          "trainer.num_sanity_val_steps=0", "trainer.limit_val_batches=1", "trainer.max_steps=2",
          "logger.vis_scalar_every_n_train_steps=1", "this_main.train_recipe=token_fast",
          f"this_main.ref_token_cache_dir={tok_work}/tokens"]
    res = tok_work / "datadir" / "res_540"
    train_scenes = json.loads((res / "split.json").read_text())["train"]
    decodes: list = []
    wrapped = {name: getattr(fastimage, name) for name in ("load_rgb", "load_rgb_bytes", "load_metric",
                                                            "load_metric_bytes")}

    def counting(name, fn):
        def call(src, *a, **kw):
            decodes.append((name, src if isinstance(src, str) else "<payload>"))
            return fn(src, *a, **kw)
        return call

    calls = {"encode": 0}
    make_encoder = train_mod.make_backbone_encoder

    def counted_encoder(*args):
        fn = make_encoder(*args)

        def call(*a, **kw):
            calls["encode"] += 1
            return fn(*a, **kw)
        return call

    tf = {}
    try:
        train_mod.make_backbone_encoder = counted_encoder
        for name, fn in wrapped.items():
            setattr(fastimage, name, counting(name, fn))
        for src in (decoder, "pillow") if native else ("pillow",):
            decodes.clear()
            calls["encode"] = 0
            tee = _Tee(sys.stdout)
            zero_launches()
            with _pillow_only(src == "pillow"), contextlib.redirect_stdout(tee):
                run = train_mod.main(ov + [f"alias=token_input_{src}"])
            torch.cuda.synchronize()
            text = "".join(tee.text)
            cache = re.search(r"token cache: (\d+) hits, (\d+) misses, (\d+) disk hits", text)
            skips = re.search(r"decode skip: (\d+) images", text)
            rows = [_json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
            in_train = lambda p: any(f"/res_540/{s}/" in p for s in train_scenes)  # noqa: E731
            tf[src] = {"losses": [r["train/loss"] for r in rows if "train/loss" in r],
                       "encode_calls": calls["encode"], "launches": read_launches(),
                       "hits": int(cache.group(1)), "misses": int(cache.group(2)), "skips": int(skips.group(1)),
                       "train_rgb_decodes": sum(n.startswith("load_rgb") and in_train(p) for n, p in decodes),
                       "train_metric_decodes": sum(n.startswith("load_metric") and in_train(p) for n, p in decodes)}
            r = tf[src]
            print(f"token_fast on the warm store ({src}): losses {r['losses']}; encoder calls {r['encode_calls']}; "
                  f"cache hits {r['hits']}, misses {r['misses']}, decode-skips {r['skips']}; native decodes of the "
                  f"train split: {r['train_rgb_decodes']} images, {r['train_metric_decodes']} score maps")
    finally:
        train_mod.make_backbone_encoder = make_encoder
        for name, fn in wrapped.items():
            setattr(fastimage, name, fn)
    slots = 2 * 2 * (1 + PK)  # 2 steps of B=2, a query and K=5 references each
    if native:
        r, p = tf[decoder], tf["pillow"]
        tf["max_loss_diff"] = max(abs(a - b) for a, b in zip(r["losses"], p["losses"]))
        print(f"token_fast losses, native skip vs Pillow: bit-equal {r['losses'] == p['losses']}; max |difference| "
              f"{tf['max_loss_diff']:.3e} (tol 1e-6)")
        # the placeholder slots (pools of 4 and 3 padded to K=5) are cache
        # hits: they carry no image to decode
        if r["encode_calls"] or r["misses"] or r["skips"] + r["hits"] != slots or not r["skips"] \
                or r["train_rgb_decodes"] or not r["train_metric_decodes"] \
                or len(r["losses"]) != 2 or not tf["max_loss_diff"] <= 1e-6:
            _fail("step 17 token_fast on the warm store with the decode skip")
    elif tf["pillow"]["encode_calls"] or tf["pillow"]["misses"]:
        _fail("step 17 token_fast on the warm store encoded")
    inp["token_fast"] = tf

    # (e) the two host benchmarks, each in its own process (mallopt is
    # process-wide), with the host's CPU count beside them
    benches = {"ingest": ["-m", "crossscore_tpu_torch.tools.ingest_bench", "10"],
               "assembly loader": ["-m", "crossscore_tpu_torch.tools.token_assembly_bench"],
               "assembly glibc": ["-m", "crossscore_tpu_torch.tools.token_assembly_bench", "--arena", "glibc"]}
    inp["bench"] = {}
    for name, args in benches.items():
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, *args], cwd=Path(__file__).resolve().parent, capture_output=True,
                              text=True, timeout=600)
        lines = proc.stdout.strip().splitlines()
        for line in lines:
            print(f"  {name}: {line}")
        if proc.returncode != 0:
            print(proc.stderr[-3000:])
            _fail(f"{name} bench exit {proc.returncode}")
        rows = {m.group(1).strip(): float(m.group(2))
                for m in (re.match(r"(.+?)\s*: +([0-9.]+) items/s", x) for x in lines) if m}
        fin = next((re.search(r"_finalize: ([0-9.]+) ms \(min ([0-9.]+), p50 ([0-9.]+)\)", x) for x in lines
                    if x.startswith("_finalize")), None)
        h2d = next((x for x in lines if x.startswith("host-to-device")), None)
        inp["bench"][name] = {"items_per_s": rows} if rows else {
            "finalize_ms": [float(g) for g in fin.groups()] if fin else None, "h2d": h2d}
        inp["bench"][name]["s"] = time.perf_counter() - t0
    inp["s"] = time.perf_counter() - t_start
    print(f"step 17: {inp['s']:.1f} s")
    return inp


# step 18: the data-parallel CLIs on two gloo ranks that share the card. The
# fp32 comparison's parameters are held as tests/test_torch_data_parallel_train.py
# holds them: every leaf within DP_PARAM_TOL but the key projections' biases,
# whose gradient is 0 in exact arithmetic (the bias shifts each query's logits
# by one constant, which the softmax removes), so AdamW steps them by
# normalised rounding noise, at most lr a step from their zero init
DP_LOSS_TOL, DP_PARAM_TOL, DP_RESUME_TOL = 1e-5, 2e-5, 1e-6
# the test CLI's rows and the predict CLI's maps against one rank: bf16, the
# existing bounds (step 15's mean losses, step 9's maps); the mean row against
# the rows it weighs: the CSV's 6 decimals
DP_ROW_TOL, DP_MAP_TOL, DP_MEAN_TOL = 1e-2, 1e-2, 2e-6


def _dp_cli_rank(task: str, argv: list) -> dict:
    """One rank of a data-parallel CLI (gloo, the ranks share the card), its
    report lines captured and its kernels' launches counted from 0; for the
    train CLI also each step's loss (the step's own metric) and ms, each
    gradient all-reduce's ms, the encoder's and the eval step's calls, and a
    sha256 of the model's parameters after the run."""
    import hashlib
    import importlib
    import io

    import torch

    from crossscore_tpu_torch.train import step as step_mod

    mod = importlib.import_module(f"crossscore_tpu_torch.tasks.{task}")
    wrappers = _rank_launches()
    for w in wrappers.values():
        w.launches = 0
    rec = {"losses": [], "step_ms": [], "allreduce_ms": [], "encode": 0, "eval": 0}
    models = []
    saved = {}
    if task == "train":
        saved = {"make_train_step": mod.make_train_step, "make_backbone_encoder": mod.make_backbone_encoder,
                 "make_eval_step": mod.make_eval_step}
        sum_gradients = step_mod._sum_gradients

        def make_train_step(model, *args):
            models.append(model)
            fn = saved["make_train_step"](model, *args)

            def train_step(state, batch):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, metrics = fn(state, batch)
                rec["losses"].append(float(metrics["loss"]))
                rec["step_ms"].append(1e3 * (time.perf_counter() - t0))
                return state, metrics
            return train_step

        def counted(name, key):
            def make(*args, **kw):
                fn = saved[name](*args, **kw)

                def call(*a, **k):
                    rec[key] += 1
                    return fn(*a, **k)
                return call
            return make

        def timed_sum(params, group):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sum_gradients(params, group)
            torch.cuda.synchronize()
            rec["allreduce_ms"].append(1e3 * (time.perf_counter() - t0))

        mod.make_train_step = make_train_step
        mod.make_backbone_encoder = counted("make_backbone_encoder", "encode")
        mod.make_eval_step = counted("make_eval_step", "eval")
        step_mod._sum_gradients = timed_sum
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            ret = mod.main(argv)
        torch.cuda.synchronize()
    finally:
        for k, v in saved.items():
            setattr(mod, k, v)
        if saved:
            step_mod._sum_gradients = sum_gradients
    digest = None
    if models:
        h = hashlib.sha256()
        for v in models[0].state_dict().values():
            h.update(v.detach().float().cpu().numpy().tobytes())
        digest = h.hexdigest()
    return {"out": None if ret is None else str(ret), "text": out.getvalue(),
            "launches": {k: w.launches for k, w in wrappers.items()}, "sha256": digest, **rec}


def _dp_misses(groups: list, n: int, batch: int, rank: int, ranks: int) -> int:
    """A rank's token-cache misses on a step-15 tree (``_eval_plan``'s item
    order): the pools of the scene halves its block of each batch meets,
    the padding rows repeating the batch's last item."""
    seen: set = set()
    b = batch // ranks
    for group in groups:
        items = [(scene, half) for scene in group for half in ("test", "train") for _ in range(n)]
        for i0 in range(0, len(items), batch):
            chunk = items[i0:i0 + batch]
            block = chunk[rank * b:(rank + 1) * b] or chunk[-1:]
            seen |= set(block)
    return len(seen) * n


def _dp_phases(torch, zero_launches, read_launches, tok_work: Path, card: str) -> dict:
    """Step 18, the data-parallel CLIs on two gloo ranks that share the card
    (one node of 2 ranks; two ranks time-slicing one card are no scaling
    measurement): (a) the pixel train CLI (dinov2-small, 518 px crops, bf16,
    K=5, B=4 a step: 2 a rank) for 4 steps with validation and a checkpoint
    at step 2, a resume from it, and fp32 2 ranks x B=1 against one rank x
    B=2; (b) ``token_fast`` on step 14's warm store; (c) the test CLI on step
    15's tree, modes (a) and (c), against one rank; (d) the predict CLI on
    step 9's renders, modes (b) and (d), against one rank; (e)
    ``tools.dryrun_multichip 4``. Returns the readings."""
    import csv
    import tempfile

    import numpy as np

    from crossscore_tpu_torch.confsys import load_config
    from crossscore_tpu_torch.data.synthetic import generate
    from crossscore_tpu_torch.io.convert import init_params
    from crossscore_tpu_torch.models import CrossScoreConfig
    from crossscore_tpu_torch.parallel.launch import RankPool
    from crossscore_tpu_torch.tasks.predict import main as predict_main
    from crossscore_tpu_torch.tasks.test import main as test_main
    from crossscore_tpu_torch.tasks.train import main as train_main
    from crossscore_tpu_torch.tools import dryrun_multichip

    dp: dict = {}
    t_all = time.perf_counter()
    mcfg = CrossScoreConfig.from_config(load_config("default"))
    n_layers, n_dec = mcfg.backbone.num_layers, 2 * mcfg.decoder_layers
    bad = []

    def rows(run) -> list:
        return [json.loads(line) for line in (Path(run) / "metrics.jsonl").read_text().splitlines()]

    def series(run, key) -> list:
        return [r[key] for r in rows(run) if key in r]

    def same_dir(res) -> Path:
        outs = {r["out"] for r in res}
        if len(outs) != 1 or None in outs:
            _fail(f"step 18: the ranks name different output dirs {outs}")
        return Path(outs.pop())

    with tempfile.TemporaryDirectory() as tmp, RankPool(2) as pool:
        tmp = Path(tmp)
        # --- (a) the pixel train CLI ----------------------------------------------
        t0 = time.perf_counter()
        # step 8's tree with a second train scene: 14 items, 3 steps of 4
        generate(tmp / "datadir", hw=(540, 720), scenes_per_split={"train": 2, "test": 1}, seed=SEED)
        ov = [f"data.dataset.path=[{tmp}/datadir]", f"run.dir={tmp}/log", "data.loader.train.batch_size=4",
              "data.loader.validation.batch_size=4", "data.loader.train.num_workers=4",
              "data.loader.validation.num_workers=4", "trainer.num_sanity_val_steps=0",
              "trainer.limit_train_batches=2", "trainer.limit_val_batches=2",
              "trainer.checkpointing.every_n_train_steps=2", "logger.vis_scalar_every_n_train_steps=1",
              "model.gpu.dist_backend=gloo"]
        full = pool.run(_dp_cli_rank, "train", ov + ["trainer.max_epochs=2", "alias=dp_full"], timeout=600)
        first = pool.run(_dp_cli_rank, "train", ov + ["trainer.max_epochs=1", "alias=dp_first"], timeout=600)
        run_first = same_dir(first)
        second = pool.run(_dp_cli_rank, "train", ov + ["trainer.max_epochs=2", "alias=dp_second",
                                                       f"trainer.ckpt_path_to_load={run_first / 'ckpt'}"],
                          timeout=600)
        run_full, run_second = same_dir(full), same_dir(second)
        want = _launches(K1=n_layers * (4 + 4), K2=n_layers * (4 + 4), K3=n_dec * (4 + 4), K4=n_dec * 4)
        logged = series(run_full, "train/loss_cross")
        resumed = series(run_first, "train/loss_cross") + series(run_second, "train/loss_cross")
        files = sorted(str(p.relative_to(run_full)) for p in run_full.rglob("*") if p.is_file())
        runs = sorted(p.name for p in (tmp / "log").iterdir())
        a = {"launches_per_rank": [r["launches"] for r in full], "expected": want,
             "losses_per_rank": [r["losses"] for r in full], "logged": logged, "resumed": resumed,
             "sha256": [r["sha256"] for r in full], "files": files, "run_dirs": runs,
             "ms_per_step_per_rank": [r["step_ms"] for r in full],
             "allreduce_ms_per_rank": [r["allreduce_ms"] for r in full]}
        ok = (all(r["launches"] == want for r in full) and len(logged) == 4
              and all(len(r["losses"]) == 4 and max(abs(x - y) for x, y in zip(r["losses"], logged)) <= DP_LOSS_TOL
                      for r in full)
              and len(set(a["sha256"])) == 1 and len(resumed) == 4
              and max(abs(x - y) for x, y in zip(resumed[2:], logged[2:])) <= DP_RESUME_TOL
              and files == ["ckpt/hparams.yaml", "ckpt/step_00000002.ckpt", "ckpt/step_00000004.ckpt",
                            "config.yaml", "metrics.jsonl"]
              and len(runs) == 3 and len(series(run_full, "validation/loss")) == 2
              and all(np.isfinite(logged)))
        print(f"step 18 (a) train CLI on 2 gloo ranks sharing the card (dinov2-small, 518 px crops, bf16, K=5, "
              f"B=4 a step, 2 a rank): launches per rank "
              f"{[{k: v for k, v in x.items() if v} for x in a['launches_per_rank']]} (expected "
              f"{ {k: v for k, v in want.items() if v} }: 4 steps, 4 validation batches); the step's loss per "
              f"rank {[[round(x, 6) for x in r] for r in a['losses_per_rank']]} against the logged "
              f"{[round(x, 6) for x in logged]}; parameters' sha256 per rank {[h[:12] for h in a['sha256']]}; "
              f"resumed steps 3-4 {[round(x, 8) for x in resumed[2:]]} against {[round(x, 8) for x in logged[2:]]} "
              f"(tol {DP_RESUME_TOL:.0e}); files {files}; ms/step per rank "
              f"{[[round(x, 1) for x in r] for r in a['ms_per_step_per_rank']]}, gradient all-reduce ms per rank "
              f"{[[round(x, 1) for x in r] for r in a['allreduce_ms_per_rank']]} (gloo through host memory, two "
              f"ranks time-slicing one card: not a scaling number); {card}")
        if not ok:
            bad.append("(a) the train CLI on two ranks")

        # fp32: 2 ranks x B=1 against one rank x B=2, 2 steps, from the same seed
        ov32 = [x for x in ov if not x.startswith(("data.loader.train.batch_size", "data.loader.validation.batch_size",
                                                   "trainer.checkpointing.every_n_train_steps"))] + [
            "model.gpu.compute_dtype=float32", "model.gpu.mlp_impl=fused_exact", "trainer.max_steps=2",
            "trainer.limit_val_batches=1", "data.loader.validation.batch_size=2", "data.loader.train.batch_size=2"]
        two = pool.run(_dp_cli_rank, "train", ov32 + ["alias=dp32_two"], timeout=600)
        zero_launches()
        one = train_main(ov32 + ["alias=dp32_one"])
        run_two = same_dir(two)
        l_two, l_one = series(run_two, "train/loss_cross"), series(one, "train/loss_cross")
        sd = [torch.load(r / "ckpt" / "step_00000002.ckpt", map_location="cpu", weights_only=True)["state_dict"]
              for r in (run_two, one)]
        lr = float(load_config("default").trainer.optimizer.lr)

        def held(state: dict) -> tuple[dict, list]:
            """Every leaf, the packed in_proj_bias without its key third
            (q, k, v): -> (the held leaves, the key biases)."""
            out, keys = {}, []
            for k, v in state.items():
                v = v.float().reshape(-1)
                if k.endswith("in_proj_bias"):
                    n = v.numel() // 3
                    keys.append(v[n:2 * n])
                    v = torch.cat([v[:n], v[2 * n:]])
                out[k] = v
            return out, keys

        (h_two, k_two), (h_one, k_one) = held(sd[0]), held(sd[1])
        worst = max(float((h_two[k] - h_one[k]).abs().max()) for k in h_one)
        noise_max = max(float(v.abs().max()) for v in k_two + k_one)
        a["fp32"] = {"loss_two_ranks": l_two, "loss_one_rank": l_one, "param_max_abs": worst,
                     "key_biases": len(k_one), "key_bias_max_abs": noise_max}
        print(f"step 18 (a) fp32, 2 ranks x B=1 against one rank x B=2, 2 steps: losses {l_two} against {l_one} "
              f"(tol {DP_LOSS_TOL:.0e}); parameters max |d| {worst:.3e} (tol {DP_PARAM_TOL:.0e}) over every "
              f"element but the {len(k_one)} key-projection biases (no gradient in exact arithmetic), those within "
              f"{noise_max:.2e} of 0 (bound 2 x lr = {2 * lr:.0e})")
        if not (len(l_two) == len(l_one) == 2 and max(abs(x - y) for x, y in zip(l_two, l_one)) <= DP_LOSS_TOL
                and worst <= DP_PARAM_TOL and noise_max <= 2 * lr):
            bad.append("(a) fp32 two ranks against one")
        a["s"] = time.perf_counter() - t0
        dp["train"] = a

        # --- (b) token_fast on step 14's warm store ---------------------------------
        t0 = time.perf_counter()
        work = Path(tok_work)
        ovt = [f"data.dataset.path=[{work}/datadir]", f"run.dir={tmp}/log_tok", "data.loader.train.batch_size=2",
               "data.loader.validation.batch_size=2", "data.loader.train.num_workers=4",
               "data.loader.validation.num_workers=4", "trainer.num_sanity_val_steps=1",
               "trainer.limit_val_batches=1", "logger.vis_scalar_every_n_train_steps=1",
               "this_main.train_recipe=token_fast", f"this_main.ref_token_cache_dir={work}/tokens",
               "trainer.max_steps=2", "model.gpu.dist_backend=gloo"]
        tok = pool.run(_dp_cli_rank, "train", ovt + ["alias=dp_tok"], timeout=600)
        run_tok = same_dir(tok)
        b = {"encode_calls": [r["encode"] for r in tok], "eval_calls": [r["eval"] for r in tok],
             "launches_per_rank": [r["launches"] for r in tok], "losses_per_rank": [r["losses"] for r in tok],
             "logged": series(run_tok, "train/loss_cross")}
        wants = [_launches(K1=n_layers * r["eval"], K2=n_layers * r["eval"], K3=n_dec * (2 + r["eval"]),
                           K4=n_dec * 2) for r in tok]
        print(f"step 18 (b) token_fast on 2 ranks, step 14's warm store: encoder calls per rank {b['encode_calls']}, "
              f"validation batches {b['eval_calls']}; launches per rank "
              f"{[ {k: v for k, v in x.items() if v} for x in b['launches_per_rank']]} (expected "
              f"{[ {k: v for k, v in x.items() if v} for x in wants]}); the step's loss per rank "
              f"{b['losses_per_rank']}, logged {b['logged']}")
        if any(b["encode_calls"]) or [r["launches"] for r in tok] != wants \
                or b["losses_per_rank"][0] != b["losses_per_rank"][1] or len(b["logged"]) != 2 \
                or max(abs(x - y) for x, y in zip(b["losses_per_rank"][0], b["logged"])) > DP_LOSS_TOL:
            bad.append("(b) token_fast on two ranks")
        b["s"] = time.perf_counter() - t0
        dp["token_fast"] = b

        # --- (c) the test CLI on step 15's tree, modes (a) and (c) ----------------------
        t0 = time.perf_counter()
        single, mixed = tmp / "gaussian" / "single", tmp / "gaussian" / "mixed"
        generate(single, hw=EVAL_HW, scenes_per_split={"train": 1, "test": 2}, n_train_imgs=PK, n_test_imgs=PK,
                 seed=SEED)
        generate(mixed, hw=[EVAL_HW, EVAL_HW, EVAL_HW, EVAL_HW_T], scenes_per_split={"train": 1, "test": 3},
                 n_train_imgs=PK, n_test_imgs=PK, seed=SEED)
        ckpt = tmp / "run" / "ckpt" / "seeded.ckpt"
        ckpt.parent.mkdir(parents=True)
        tcfg = CrossScoreConfig.from_config(load_config("default_test", EVAL_OVERRIDES))
        torch.save({"state_dict": {f"model.{k}": v for k, v in init_params(tcfg, SEED).items()}}, ckpt)
        c = {}
        for tag, (tree, buckets, cache, groups) in {"a": (single, "off", "off", [[1, 2]]),
                                                    "c": (mixed, "on", "on", [[1, 2], [3]])}.items():
            argv = EVAL_OVERRIDES + [f"trainer.ckpt_path_to_load={ckpt}", f"data.dataset.path=[{tree}]",
                                     f"this_main.shape_buckets={buckets}", f"this_main.ref_token_cache={cache}"]
            one_out = test_main(argv + [f"logger.test.out_dir={tmp / ('test_one_' + tag)}"])
            res = pool.run(_dp_cli_rank, "test", argv + ["model.gpu.dist_backend=gloo",
                                                         f"logger.test.out_dir={tmp / ('test_two_' + tag)}"],
                           timeout=600)
            two_out = same_dir(res)

            def table(out):
                with open(Path(out) / "metrics.csv") as f:
                    return list(csv.DictReader(f))

            t_one, t_two = table(one_out), table(two_out)
            keys = [k for k in t_one[0] if k != "batch_idx"]
            cells = max(abs(float(x[k]) - float(y[k])) for x, y in zip(t_one, t_two) for k in keys)
            # the mean row against its rows, weighed by each global batch's items
            n_items = [min(PB, 2 * PK * len(g) - i0) for g in groups for i0 in range(0, 2 * PK * len(g), PB)]
            w = np.asarray(n_items, np.float64)
            mean_err = max(abs(float(t_two[-1][k]) - float(np.sum(w * [float(r[k]) for r in t_two[:-1]]) / w.sum()))
                           for k in keys)
            misses = [re.search(r"ref-token cache: \d+ hits, (\d+) unique misses", r["text"]) for r in res]
            want_miss = [_dp_misses(groups, PK, PB, r, 2) for r in range(2)]
            c[tag] = {"launches_per_rank": [r["launches"] for r in res],
                      "rows_one": len(t_one), "rows_two": len(t_two), "max_cell_diff": cells,
                      "mean_row_err": mean_err, "mean": {k: float(t_two[-1][k]) for k in keys},
                      "misses_per_rank": [int(m.group(1)) if m else None for m in misses],
                      "expected_misses": want_miss if cache == "on" else None,
                      "maps_per_s_per_rank": [float(re.search(r"= ([0-9.]+) maps/s", r["text"]).group(1))
                                              for r in res]}
            print(f"step 18 (c) test CLI ({tag}) buckets {buckets}, cache {cache} on 2 ranks against one rank: "
                  f"{len(t_two) - 1} batch rows, largest cell difference {cells:.3e} (tol {DP_ROW_TOL:.0e}); the "
                  f"mean row against its rows weighed by the global batches' items {mean_err:.1e} (tol "
                  f"{DP_MEAN_TOL:.0e}); misses per rank {c[tag]['misses_per_rank']} (expected "
                  f"{c[tag]['expected_misses']}); maps/s per rank {c[tag]['maps_per_s_per_rank']}")
            if len(t_one) != len(t_two) or [r["batch_idx"] for r in t_one] != [r["batch_idx"] for r in t_two] \
                    or cells > DP_ROW_TOL or mean_err > DP_MEAN_TOL \
                    or not all(np.isfinite(list(c[tag]["mean"].values()))) \
                    or (cache == "on" and c[tag]["misses_per_rank"] != want_miss):
                bad.append(f"(c) the test CLI, mode {tag}")
        c["s"] = time.perf_counter() - t0
        dp["test"] = c

        # --- (d) the predict CLI on step 9's renders, modes (b) and (d) -------------------
        t0 = time.perf_counter()
        qdir, rdir = _write_predict_dirs(tmp / "predict", 3 * PB, PK)
        pcfg = CrossScoreConfig.from_config(load_config("default_predict"))
        pckpt = tmp / "prun" / "ckpt" / "seeded.ckpt"
        pckpt.parent.mkdir(parents=True)
        torch.save({"state_dict": {f"model.{k}": v for k, v in init_params(pcfg, SEED).items()}}, pckpt)
        common = [f"trainer.ckpt_path_to_load={pckpt}", f"data.dataset.query_dir={qdir}",
                  f"data.dataset.reference_dir={rdir}", f"data.neighbour_config.cross={PK}",
                  f"data.loader.validation.batch_size={PB}", "model.gpu.view_parallel=off",
                  "logger.predict.write.config.score_map_colour_mode=gray",
                  "logger.predict.write.config.vis_img_every_n_steps=-1",
                  "logger.predict.write.flag.image_query=false", "logger.predict.write.flag.image_reference=false"]
        d = {}
        from PIL import Image

        for tag, (buckets, cache) in {"b": ("off", "on"), "d": ("on", "off")}.items():
            argv = common + [f"this_main.shape_buckets={buckets}", f"this_main.ref_token_cache={cache}"]
            one_out = predict_main(argv + [f"logger.predict.out_dir={tmp / ('pred_one_' + tag)}"])
            res = pool.run(_dp_cli_rank, "predict", argv + ["model.gpu.dist_backend=gloo",
                                                            f"logger.predict.out_dir={tmp / ('pred_two_' + tag)}"],
                           timeout=600)
            two_out = same_dir(res)
            names = [sorted(p.name for p in (Path(o) / "batch" / "score_map_ref_cross").glob("*.png"))
                     for o in (one_out, two_out)]
            maes = [float(np.abs(np.asarray(Image.open(Path(one_out) / "batch" / "score_map_ref_cross" / n),
                                            np.float64) -
                                 np.asarray(Image.open(Path(two_out) / "batch" / "score_map_ref_cross" / n),
                                            np.float64)).mean()) / 32767.0 for n in names[0] if n in names[1]]
            d[tag] = {"maps": len(names[1]), "same_names": names[0] == names[1], "max_mae": max(maes or [1.0]),
                      "launches_per_rank": [{k: v for k, v in r["launches"].items() if v} for r in res],
                      "maps_per_s_per_rank": [float(re.search(r"= ([0-9.]+) maps/s", r["text"]).group(1))
                                              for r in res]}
            print(f"step 18 (d) predict CLI ({tag}) buckets {buckets}, cache {cache}, data parallel on 2 ranks "
                  f"against one rank: {d[tag]['maps']} maps, the same names {d[tag]['same_names']}, worst map MAE "
                  f"{d[tag]['max_mae']:.3e} (tol {DP_MAP_TOL:.0e}); launches per rank {d[tag]['launches_per_rank']}; "
                  f"maps/s per rank {d[tag]['maps_per_s_per_rank']} (two ranks time-slicing one card)")
            if not d[tag]["same_names"] or d[tag]["maps"] != 3 * PB or d[tag]["max_mae"] > DP_MAP_TOL \
                    or not all("data-parallel predict: 2 data ranks" in r["text"] for r in res):
                bad.append(f"(d) the predict CLI, mode {tag}")
        d["s"] = time.perf_counter() - t0
        dp["predict"] = d

    # --- (e) the dry run through its entry point ------------------------------------------
    t0 = time.perf_counter()
    rc = dryrun_multichip.main(["4"])
    dp["dryrun_multichip"] = {"rc": rc, "s": time.perf_counter() - t0}
    print(f"step 18 (e) tools.dryrun_multichip 4 (4 gloo ranks sharing the card): exit {rc} in "
          f"{dp['dryrun_multichip']['s']:.1f} s")
    if rc != 0:
        bad.append("(e) dryrun_multichip 4")
    dp["s"] = time.perf_counter() - t_all
    print(f"step 18: {dp['s']:.1f} s")
    if bad:
        _fail("step 18: " + "; ".join(bad))
    return dp


def main() -> int:
    import argparse

    import numpy as np
    import torch

    ap = argparse.ArgumentParser(description="Drive the port on one CUDA card.")
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after the kernel checks (steps 1-3), printing no result lines")
    kernels_only = ap.parse_args().kernels_only

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    root = Path(__file__).resolve().parent
    if not (root / "crossscore_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(root))
    import torch.nn.functional as F

    from crossscore_tpu_torch.io.convert import init_params, load_into
    from crossscore_tpu_torch.models import CrossScoreConfig, CrossScoreNet, VIT_PRESETS
    from crossscore_tpu_torch.ops import _build
    from crossscore_tpu_torch.confsys import load_config
    from crossscore_tpu_torch.ops.flash_attention import (
        flash_cross_attention, flash_cross_attention_bwd, flash_cross_attention_bwd_plain,
        flash_cross_attention_masked, flash_cross_attention_masked_plain, flash_cross_attention_plain,
        flash_qkv_self_attention, flash_qkv_self_attention_masked, flash_qkv_self_attention_masked_plain,
        flash_qkv_self_attention_plain, flash_attention_head_major, flash_attention_head_major_plain,
        flash_attention_head_major_bwd, flash_attention_head_major_bwd_plain,
    )
    from crossscore_tpu_torch.ops.fused_mlp import (
        fused_ln_mlp, fused_ln_mlp_plain, fused_res_ln_mlp, fused_res_ln_mlp_plain,
    )
    from crossscore_tpu_torch.tools._common import card_line
    from crossscore_tpu_torch.tools.mlp_microbench import unfused_chain
    from crossscore_tpu_torch.train.optim import make_optimizer
    from crossscore_tpu_torch.train.step import TrainState, loss_fn, make_predict_step, make_train_step

    # full fp32 for fp32 products and convolutions (cuDNN defaults to TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    print(card)
    print(f"name, power limit, max SM clock: {card_line('clocks.max.sm')}")
    name = torch.cuda.get_device_name(0)
    peak_row, (peak_bf16, peak_f32, peak_bw, peak_ex2) = _peaks(name)
    print(f"peaks used for bounds: {peak_row} row: {peak_bf16 / 1e12:g} TFLOP/s bf16, "
          f"{peak_f32 / 1e12:g} TFLOP/s fp32, {peak_bw / 1e12:g} TB/s, {peak_ex2 / 1e12:g} T exp2/s")

    t0 = time.perf_counter()
    secs = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s wall "
          + " ".join(f"{k}={v:.1f}s" for k, v in secs.items()))
    for src in _build.SOURCES:
        log = _build.BUILD_DIR / f"{src}.log"
        entry = ""
        for line in (log.read_text().splitlines() if log.exists() else []):
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                entry = m.group(1)
            m = re.search(r"(\d+) bytes spill stores", line)
            if m and m.group(1) != "0":
                print(f"  ptxas {src} {entry}: {line.strip()}")
            m = re.search(r"Used (\d+) registers", line)
            if m:
                print(f"  ptxas {src} {entry}: {m.group(1)} registers")
    mlp_plan = _wgmma_build_report(_build)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    vit = VIT_PRESETS["dinov2-small"]
    d, h, hd = vit.hidden_size, vit.num_heads, vit.hidden_size // vit.num_heads
    f = vit.mlp_ratio * d
    n = (HW // vit.patch_size) ** 2 + 1  # 1370 tokens
    nq = n - 1  # decoder query tokens
    dec_h = CrossScoreConfig().decoder_heads
    views = B * (1 + K)

    def randn(*shape, dtype, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(dtype)

    report = {}

    # --- 3. kernels vs plain versions at the main-path shapes ----------------
    for dtype in (torch.bfloat16, torch.float32):
        tname = str(dtype).split(".")[-1]
        es = dtype.itemsize
        peak = peak_bf16 if dtype == torch.bfloat16 else peak_f32

        qkv = randn(views, n, 3 * d, dtype=dtype)
        got = flash_qkv_self_attention(qkv, h)
        want = flash_qkv_self_attention_plain(qkv, h)
        err, l2 = _masked_errs([(got, want)])
        ops = 4.0 * views * h * n * n * hd
        nbytes = views * n * (3 * d + d) * es + 2 * views * h * n * 4
        report[("K1", tname)] = dict(
            err=err, tol=TOL[tname], l2=l2, tol_l2=TOL_L2[tname], max_abs=_max_abs(got[0], want[0]),
            ms=_time_ms(torch, lambda: flash_qkv_self_attention(qkv, h)),
            plain_ms=_time_ms(torch, lambda: flash_qkv_self_attention_plain(qkv, h), reps=3),
            library_ms=_time_ms(torch, lambda: F.scaled_dot_product_attention(
                *(qkv.view(views, n, 3, h, hd)[:, :, i].transpose(1, 2) for i in range(3)))),
            **_bound(ops, nbytes, peak, peak_bw, views * h * n * n, peak_ex2),
        )
        del qkv, got, want

        x = randn(views, n, d, dtype=dtype)
        mlp = (randn(d, dtype=torch.float32, scale=0.1) + 1, randn(d, dtype=torch.float32, scale=0.1),
               randn(f, d, dtype=torch.float32, scale=d ** -0.5), randn(f, dtype=torch.float32, scale=0.1),
               randn(d, f, dtype=torch.float32, scale=f ** -0.5), randn(d, dtype=torch.float32, scale=0.1),
               randn(d, dtype=torch.float32, scale=0.5) + 1)
        got = fused_ln_mlp(x, *mlp, vit.layer_norm_eps, "tanh")
        want = fused_ln_mlp_plain(x, *mlp, vit.layer_norm_eps, "tanh")
        err = _rel_err(got, want)
        if dtype == torch.bfloat16:  # the exact-erf form too (fused_exact)
            err = max(err, _rel_err(fused_ln_mlp(x, *mlp, vit.layer_norm_eps, "exact"),
                                    fused_ln_mlp_plain(x, *mlp, vit.layer_norm_eps, "exact")))
        rows = views * n
        ops = 4.0 * rows * d * f
        nbytes = 2 * rows * d * es + 2 * d * f * es + (4 * d + f) * es
        mlp_dt = [t.to(dtype) for t in mlp]
        report[("K2", tname)] = dict(
            err=err, tol=TOL[tname], max_abs=_max_abs(got, want),
            ms=_time_ms(torch, lambda: fused_ln_mlp(x, *mlp, vit.layer_norm_eps, "tanh")),
            plain_ms=_time_ms(torch, lambda: fused_ln_mlp_plain(x, *mlp, vit.layer_norm_eps, "tanh"), reps=3),
            # no single call computes LN -> MLP; the unfused chain (separate
            # PyTorch calls, weights already in x's dtype) is the yardstick
            library_ms=None, unfused_ms=_time_ms(torch, lambda: unfused_chain(x, *mlp_dt, vit.layer_norm_eps)),
            **_bound(ops, nbytes, peak, peak_bw),
        )
        del x, mlp, mlp_dt, got, want

        q = randn(B, nq, d, dtype=dtype)
        for tag, nk in (("K3", K * nq), ("K3self", nq)):  # cross, then self
            k_, v_ = randn(B, nk, d, dtype=dtype), randn(B, nk, d, dtype=dtype)
            got = flash_cross_attention(q, k_, v_, dec_h)
            want = flash_cross_attention_plain(q, k_, v_, dec_h)
            err, l2 = _masked_errs([(got, want)])
            dhd = d // dec_h
            ops = 4.0 * B * dec_h * nq * nk * dhd
            nbytes = B * (2 * nq + 2 * nk) * d * es + 2 * B * dec_h * nq * 4
            heads = lambda t: t.view(B, -1, dec_h, dhd).transpose(1, 2)  # noqa: E731
            report[(tag, tname)] = dict(
                err=err, tol=TOL[tname], l2=l2, tol_l2=TOL_L2[tname], max_abs=_max_abs(got[0], want[0]),
                ms=_time_ms(torch, lambda: flash_cross_attention(q, k_, v_, dec_h)),
                plain_ms=_time_ms(torch, lambda: flash_cross_attention_plain(q, k_, v_, dec_h), reps=3),
                library_ms=_time_ms(torch, lambda: F.scaled_dot_product_attention(
                    heads(q), heads(k_), heads(v_))),
                **_bound(ops, nbytes, peak, peak_bw, B * dec_h * nq * nk, peak_ex2),
            )
            del k_, v_, got, want
        del q

        # K4 at the train shapes: q/o/do (TB, Nq, D), k/v (TB, Nk, D)
        q, do = randn(TB, nq, d, dtype=dtype), randn(TB, nq, d, dtype=dtype)
        for tag, nk in (("K4", TK * nq), ("K4self", nq)):
            k_, v_ = randn(TB, nk, d, dtype=dtype), randn(TB, nk, d, dtype=dtype)
            o, l, m = flash_cross_attention(q, k_, v_, dec_h)
            args = (q, k_, v_, o, do, l, m, dec_h)
            got, same = _twice(flash_cross_attention_bwd, *args)
            want = flash_cross_attention_bwd_plain(*args)
            dhd = d // dec_h
            ops = 10.0 * TB * dec_h * nq * nk * dhd
            # reads q, o, do, k, v, l, m; writes dq, dk, dv
            nbytes = TB * (3 * nq + 2 * nk) * d * es + 2 * TB * dec_h * nq * 4 + TB * (nq + 2 * nk) * d * es
            heads = lambda t: t.view(t.shape[0], -1, dec_h, dhd).transpose(1, 2)  # noqa: E731
            qh, kh, vh = (heads(t).detach().requires_grad_() for t in (q, k_, v_))
            oh = F.scaled_dot_product_attention(qh, kh, vh)
            errs = [_rel_l2(g, w) for g, w in zip(got, want)]  # dq, dk, dv
            print(f"{tag} {tname} relative L2 error dq {errs[0]:.3e} dk {errs[1]:.3e} dv {errs[2]:.3e}; "
                  f"max|d|/max|plain| " + " ".join(
                      f"{_max_abs(g, w) / float(w.float().abs().max()):.3e}" for g, w in zip(got, want)))
            report[(tag, tname)] = dict(
                err=max(errs), tol=TOL_K4[tname], bit_equal=same,
                max_abs=max(_max_abs(g, w) for g, w in zip(got, want)),
                ms=_time_ms(torch, lambda: flash_cross_attention_bwd(*args)),
                plain_ms=_time_ms(torch, lambda: flash_cross_attention_bwd_plain(*args), reps=3),
                library_ms=_time_ms(torch, lambda: torch.autograd.grad(
                    oh, (qh, kh, vh), heads(do), retain_graph=True)),
                # one exponential per score: the function needs p once, as it
                # needs its 5 products, however often the kernel recomputes them
                **_bound(ops, nbytes, peak, peak_bw, TB * dec_h * nq * nk, peak_ex2),
            )
            del k_, v_, o, l, m, args, got, want, qh, kh, vh, oh
        del q, do
        torch.cuda.empty_cache()

        # K5 and K6 at the bucketed predict shapes: a per-item bias mixing two
        # valid extents (checked and timed) and the shared (N,) form (checked)
        nb = BUCKET_GRID[0] * BUCKET_GRID[1]  # 2880 patch tokens per view
        item_bias = _token_bias(torch, [VALID_GRIDS[i % 2] for i in range(PB)], dev)  # (PB, nb)
        qkv = randn(PB, nb + 1, 3 * d, dtype=dtype)
        bias5 = torch.cat([torch.zeros(PB, 1, device=dev), item_bias], 1).contiguous()  # CLS valid
        got = flash_qkv_self_attention_masked(qkv, bias5, h)
        want = flash_qkv_self_attention_masked_plain(qkv, bias5, h)
        err, l2 = _masked_errs([(got, want), (
            flash_qkv_self_attention_masked(qkv, bias5[1].contiguous(), h),
            flash_qkv_self_attention_masked_plain(qkv, bias5[1].contiguous(), h))])
        valid_cols = float((bias5 == 0).sum())  # summed over the batch
        ops = 4.0 * h * (nb + 1) * valid_cols * hd  # masked columns need no work
        nbytes = PB * (nb + 1) * (3 * d + d) * es + 2 * PB * h * (nb + 1) * 4 + bias5.numel() * 4
        mask = bias5[:, None, None, :].to(dtype)
        report[("K5", tname)] = dict(
            err=err, tol=TOL[tname], l2=l2, tol_l2=TOL_L2[tname], max_abs=_max_abs(got[0], want[0]),
            ms=_time_ms(torch, lambda: flash_qkv_self_attention_masked(qkv, bias5, h)),
            # K1 on the same qkv: what the bias costs at equal shape
            k1_ms=_time_ms(torch, lambda: flash_qkv_self_attention(qkv, h)),
            plain_ms=_time_ms(torch, lambda: flash_qkv_self_attention_masked_plain(qkv, bias5, h), reps=3),
            library_ms=_time_ms(torch, lambda: F.scaled_dot_product_attention(
                *(qkv.view(PB, nb + 1, 3, h, hd)[:, :, i].transpose(1, 2) for i in range(3)),
                attn_mask=mask)),
            **_bound(ops, nbytes, peak, peak_bw, h * (nb + 1) * valid_cols, peak_ex2),
        )
        del qkv, got, want, mask
        q = randn(PB, nb, d, dtype=dtype)
        for tag, reps_ in (("K6", PK), ("K6self", 1)):  # cross over K views, then self
            k_, v_ = randn(PB, reps_ * nb, d, dtype=dtype), randn(PB, reps_ * nb, d, dtype=dtype)
            bias6 = item_bias.repeat(1, reps_).contiguous()
            got = flash_cross_attention_masked(q, k_, v_, bias6, dec_h)
            want = flash_cross_attention_masked_plain(q, k_, v_, bias6, dec_h)
            err, l2 = _masked_errs([(got, want), (
                flash_cross_attention_masked(q, k_, v_, bias6[1].contiguous(), dec_h),
                flash_cross_attention_masked_plain(q, k_, v_, bias6[1].contiguous(), dec_h))])
            dhd = d // dec_h
            exps = dec_h * nb * float((bias6 == 0).sum())  # masked columns need no work
            ops = 4.0 * exps * dhd
            nbytes = PB * (2 * nb + 2 * reps_ * nb) * d * es + 2 * PB * dec_h * nb * 4 + bias6.numel() * 4
            heads = lambda t: t.view(PB, -1, dec_h, dhd).transpose(1, 2)  # noqa: E731
            mask = bias6[:, None, None, :].to(dtype)
            report[(tag, tname)] = dict(
                err=err, tol=TOL[tname], l2=l2, tol_l2=TOL_L2[tname], max_abs=_max_abs(got[0], want[0]),
                ms=_time_ms(torch, lambda: flash_cross_attention_masked(q, k_, v_, bias6, dec_h)),
                plain_ms=_time_ms(torch, lambda: flash_cross_attention_masked_plain(q, k_, v_, bias6, dec_h),
                                  reps=3),
                library_ms=_time_ms(torch, lambda: F.scaled_dot_product_attention(
                    heads(q), heads(k_), heads(v_), attn_mask=mask)),
                **_bound(ops, nbytes, peak, peak_bw, exps, peak_ex2),
            )
            del k_, v_, got, want, mask
        del q, item_bias, bias5, bias6
        torch.cuda.empty_cache()

        # K7 at the view-parallel shapes: B*H = 64 (B=8, the 8 decoder heads),
        # Nq 1369, hd 48; Nk = 4*1369 per rank on 2 ranks at K=8, 1369 on 8
        # ranks. Without and with a shared bias row, on contiguous (B, H, N,
        # hd) tensors and on head-major hm of token-major projections
        dhd = d // dec_h
        k7_bias = _shared_bias(torch, VP_NK[0], dev)
        errs, l2s = [], []
        for nk in VP_NK:
            xq, xk, xv = randn(B, nq, d, dtype=dtype), randn(B, nk, d, dtype=dtype), randn(B, nk, d, dtype=dtype)
            hm = [t.view(B, -1, dec_h, dhd).transpose(1, 2) for t in (xq, xk, xv)]
            for layout in (hm, [t.contiguous() for t in hm]):
                for bias in (None, k7_bias[:nk].contiguous()):
                    got = flash_attention_head_major(*layout, bias)
                    want = flash_attention_head_major_plain(*layout, bias)
                    err, l2 = _masked_errs([(got, want)])
                    errs.append(err)
                    l2s.append(l2)
            del got, want
            if nk == VP_NK[0]:  # time the main path's form: hm, no bias
                ops = 4.0 * B * dec_h * nq * nk * dhd
                nbytes = B * dec_h * (2 * nq + 2 * nk) * dhd * es + 2 * B * dec_h * nq * 4
                k7 = dict(
                    max_abs=max(_max_abs(g, w) for g, w in zip(flash_attention_head_major(*hm),
                                                               flash_attention_head_major_plain(*hm))),
                    ms=_time_ms(torch, lambda: flash_attention_head_major(*hm)),
                    plain_ms=_time_ms(torch, lambda: flash_attention_head_major_plain(*hm), reps=3),
                    library_ms=_time_ms(torch, lambda: F.scaled_dot_product_attention(*hm)),
                    **_bound(ops, nbytes, peak, peak_bw, B * dec_h * nq * nk, peak_ex2),
                    # K3 on the token-major tensors the hm read: the same work
                    k3_ms=_time_ms(torch, lambda: flash_cross_attention(xq, xk, xv, dec_h)),
                )
            del xq, xk, xv, hm, layout
        report[("K7", tname)] = dict(err=max(errs), tol=TOL[tname], l2=max(l2s), tol_l2=TOL_L2[tname], **k7)
        if dtype == torch.bfloat16:  # K7 and K3 at the 1-rank K=8 length, timed only
            nk = K * nq
            xq, xk, xv = randn(B, nq, d, dtype=dtype), randn(B, nk, d, dtype=dtype), randn(B, nk, d, dtype=dtype)
            hm = [t.view(B, -1, dec_h, dhd).transpose(1, 2) for t in (xq, xk, xv)]
            report[("K7", tname)].update(
                ms_nk10952=_time_ms(torch, lambda: flash_attention_head_major(*hm)),
                k3_ms_nk10952=_time_ms(torch, lambda: flash_cross_attention(xq, xk, xv, dec_h)),
                bound_ms_nk10952=_bound(4.0 * B * dec_h * nq * nk * dhd, 0.0, peak, peak_bw,
                                        B * dec_h * nq * nk, peak_ex2)["bound_ms"])
            del xq, xk, xv, hm
        torch.cuda.empty_cache()

        # K7 at the tp route's backbone shape: the train step's 144 views
        # (TB x (TK + 1)), 6 heads, N 1370 (ragged), hd 64; on the head-major
        # views of the three q/k/v projections (the main path's form, timed)
        # and on contiguous tensors
        bv = TB * (TK + 1)
        g_bb = torch.Generator(device=dev).manual_seed(SEED + 1)  # its own stream: later draws stay as they were
        xq, xk, xv = (torch.randn(bv, n, d, generator=g_bb, device=dev).to(dtype) for _ in range(3))
        hm = [t.view(bv, n, h, hd).transpose(1, 2) for t in (xq, xk, xv)]
        err, l2 = _masked_errs([(flash_attention_head_major(*layout), flash_attention_head_major_plain(*layout))
                                for layout in (hm, [t.contiguous() for t in hm])])
        ops = 4.0 * bv * h * n * n * hd
        nbytes = 4 * bv * n * d * es + 2 * bv * h * n * 4
        qkv = torch.cat([xq, xk, xv], -1)
        report[("K7 backbone", tname)] = dict(
            err=err, tol=TOL[tname], l2=l2, tol_l2=TOL_L2[tname],
            max_abs=max(_max_abs(g, w) for g, w in zip(flash_attention_head_major(*hm),
                                                       flash_attention_head_major_plain(*hm))),
            ms=_time_ms(torch, lambda: flash_attention_head_major(*hm)),
            plain_ms=_time_ms(torch, lambda: flash_attention_head_major_plain(*hm), reps=3),
            library_ms=_time_ms(torch, lambda: F.scaled_dot_product_attention(*hm)),
            **_bound(ops, nbytes, peak, peak_bw, bv * h * n * n, peak_ex2),
            # K1 on the fused qkv of the same projections: the flash route's form
            k1_ms=_time_ms(torch, lambda: flash_qkv_self_attention(qkv, h)),
        )
        del xq, xk, xv, hm, qkv
        torch.cuda.empty_cache()

        # K8/K9 at the main-path shapes (K89_SHAPES): on head-major views of
        # token-major projections (the main path's form, timed) and on
        # contiguous tensors; the CP case fed the global (o, l, m)
        for tag, shape in K89_SHAPES.items():
            bb, hh, n_q, nk, hdim = shape[:5]
            hm, tm = _k89_inputs(randn, shape, dtype)
            errs, same = [], True
            for layout in (hm, [t.contiguous() for t in hm[:5]] + list(hm[5:])):
                got, same_ = _twice(flash_attention_head_major_bwd, *layout)
                want = flash_attention_head_major_bwd_plain(*layout)
                errs += [_rel_l2(g, w) for g, w in zip(got, want)]
                same = same and same_
            entry = dict(err=max(errs), tol=TOL_K4[tname], bit_equal=same)
            if tag in ("K8", "K9"):  # the tp route's decoder at TP = 1: timed
                ops = 10.0 * bb * hh * n_q * nk * hdim
                nbytes = bb * hh * (3 * n_q + 2 * nk) * hdim * es + 2 * bb * hh * n_q * 4 \
                    + bb * hh * (n_q + 2 * nk) * hdim * es
                qh, kh, vh = (t.detach().requires_grad_() for t in hm[:3])
                oh = F.scaled_dot_product_attention(qh, kh, vh)
                entry.update(
                    max_abs=max(_max_abs(g, w) for g, w in zip(got, want)),
                    ms=_time_ms(torch, lambda: flash_attention_head_major_bwd(*hm)),
                    plain_ms=_time_ms(torch, lambda: flash_attention_head_major_bwd_plain(*hm), reps=3),
                    library_ms=_time_ms(torch, lambda: torch.autograd.grad(oh, (qh, kh, vh), hm[4],
                                                                           retain_graph=True)),
                    **_bound(ops, nbytes, peak, peak_bw, bb * hh * n_q * nk, peak_ex2),  # as K4's
                    # K4 on the token-major tensors the views read: the same work
                    k4_ms=_time_ms(torch, lambda: flash_cross_attention_bwd(*tm, hh)),
                )
                del qh, kh, vh, oh
            print(f"{tag} {tname} shape {shape}: relative L2 of dq, dk, dv, views and contiguous, worst "
                  f"{entry['err']:.3e}")
            report[(tag, tname)] = entry
            del hm, tm, got, want, layout
        torch.cuda.empty_cache()

    # K10, K11, K7' and K12, the timing instruments of the sixth slice (no
    # model path reaches them): each against its plain version, the K11 and
    # K7' modes and K12 in bf16 (their CUDA kernels' only type), K10 in both
    instruments = _check_instruments(torch, F, dev, report, peak_bf16, peak_f32, peak_bw, peak_ex2,
                                     views=views, n=n, d=d, h=h, f=f, eps=vit.layer_norm_eps,
                                     nq=nq, dec_h=dec_h)

    # the other presets' widths, small shapes, correctness only: K1, K3 and K7
    # (views and contiguous) at every head dim 16-128 (dinov2-test's 16, base's
    # and large's 64, the decoders' 48, 96, 128), K2 at D 64, 768, 1024, K4 and
    # K8/K9 at every head dim; the forward held by TOL and the relative L2 of
    # each of o, l and m, each launched twice on the same inputs
    def fwd_entry(pairs, tname):
        """The report entry of forward (kernel, plain) output pairs, each kernel
        output a (first launch, same bits again) pair from _twice."""
        err, l2 = _masked_errs([(got, want) for (got, _), want in pairs])
        return dict(err=err, tol=TOL[tname], l2=l2, tol_l2=TOL_L2[tname],
                    bit_equal=all(same for (_, same), _ in pairs))

    for dtype in (torch.bfloat16, torch.float32):
        tname = str(dtype).split(".")[-1]
        for hdim in range(16, 129, 16):
            qkv = randn(2, 300, 3 * 3 * hdim, dtype=dtype)
            report[(f"K1 hd{hdim}", tname)] = fwd_entry(
                [(_twice(flash_qkv_self_attention, qkv, 3), flash_qkv_self_attention_plain(qkv, 3))], tname)
            q, k_, v_ = (randn(2, n_, 3 * hdim, dtype=dtype) for n_ in (300, 700, 700))
            report[(f"K3 hd{hdim}", tname)] = fwd_entry(
                [(_twice(flash_cross_attention, q, k_, v_, 3), flash_cross_attention_plain(q, k_, v_, 3))], tname)
            hm = [t.view(2, -1, 3, hdim).transpose(1, 2) for t in (q, k_, v_)]
            report[(f"K7 hd{hdim}", tname)] = fwd_entry(
                [(_twice(flash_attention_head_major, *layout), flash_attention_head_major_plain(*layout))
                 for layout in (hm, [t.contiguous() for t in hm])], tname)
        # ragged and tiny shapes, where the bf16 forward's TMA boxes run past Nq
        # or Nk and read zeros: K3, K6 and K7 (views and contiguous, without
        # and with a shared bias) at Nq 1, 63, 65 over Nk 1, 65, 2049, and K1
        # and K5 at N 1, 63, 65, 2049, at hd 48 and 128; K5 and K6 with a
        # per-item bias and K7 with a shared one, each masking a third of the
        # columns; each launched twice
        def ragged_bias(rows, nk_):
            col = torch.arange(nk_, device=dev)
            off = -torch.rand(rows, nk_, generator=torch.Generator().manual_seed(SEED + 9)).to(dev)
            return torch.stack([torch.where((col + i) % 3 == 1, -1e30, off[i]) for i in range(rows)])

        for hdim in (48, 128):
            for nq_ in (1, 63, 65, 2049):
                qkv = randn(2, nq_, 3 * 3 * hdim, dtype=dtype)
                bias = ragged_bias(2, nq_)
                report[(f"K1 n{nq_} hd{hdim}", tname)] = fwd_entry(
                    [(_twice(flash_qkv_self_attention, qkv, 3), flash_qkv_self_attention_plain(qkv, 3))], tname)
                report[(f"K5 n{nq_} hd{hdim}", tname)] = fwd_entry(
                    [(_twice(flash_qkv_self_attention_masked, qkv, bias, 3),
                      flash_qkv_self_attention_masked_plain(qkv, bias, 3))], tname)
                if nq_ == 2049:
                    continue
                for nk_ in (1, 65, 2049):
                    q = randn(2, nq_, 3 * hdim, dtype=dtype)
                    k_, v_ = randn(2, nk_, 3 * hdim, dtype=dtype), randn(2, nk_, 3 * hdim, dtype=dtype)
                    bias = ragged_bias(2, nk_)
                    report[(f"K3 nq{nq_} nk{nk_} hd{hdim}", tname)] = fwd_entry(
                        [(_twice(flash_cross_attention, q, k_, v_, 3), flash_cross_attention_plain(q, k_, v_, 3))],
                        tname)
                    report[(f"K6 nq{nq_} nk{nk_} hd{hdim}", tname)] = fwd_entry(
                        [(_twice(flash_cross_attention_masked, q, k_, v_, bias, 3),
                          flash_cross_attention_masked_plain(q, k_, v_, bias, 3))], tname)
                    hm = [t.view(2, -1, 3, hdim).transpose(1, 2) for t in (q, k_, v_)]
                    report[(f"K7 nq{nq_} nk{nk_} hd{hdim}", tname)] = fwd_entry(
                        [(_twice(flash_attention_head_major, *layout, b_), flash_attention_head_major_plain(*layout, b_))
                         for layout in (hm, [t.contiguous() for t in hm]) for b_ in (None, bias[0].contiguous())],
                        tname)
        if dtype == torch.bfloat16:
            # K2 (tanh and exact) and K10 on the bf16 body at D 64 and 384, at
            # row counts that leave ragged 64-row tiles, tiles wholly past the
            # end (the grid is a whole number of clusters of two) and odd
            # cluster counts; each launched twice for the same bits. A
            # generator of its own keeps the later draws what they were
            g_mlp = torch.Generator(device=dev).manual_seed(SEED + 4)

            def mlp_randn(*shape, dtype, scale=1.0, gen=g_mlp):
                return (torch.randn(*shape, generator=gen, device=dev) * scale).to(dtype)

            for width in (64, 384):
                mlp = (mlp_randn(width, dtype=torch.float32, scale=0.1) + 1,
                       mlp_randn(width, dtype=torch.float32, scale=0.1),
                       mlp_randn(4 * width, width, dtype=torch.float32, scale=width ** -0.5),
                       mlp_randn(4 * width, dtype=torch.float32, scale=0.1),
                       mlp_randn(width, 4 * width, dtype=torch.float32, scale=(4 * width) ** -0.5),
                       mlp_randn(width, dtype=torch.float32, scale=0.1), mlp_randn(width, dtype=torch.float32) + 1)
                ls1 = mlp_randn(width, dtype=torch.float32, scale=0.5) + 1
                for rows_ in (1, 63, 65, 127, 129, 255, 257, 2 * n + 1):
                    x, attn = mlp_randn(rows_, width, dtype=dtype), mlp_randn(rows_, width, dtype=dtype, scale=0.3)
                    for g in ("tanh", "exact"):
                        (got,), same = _twice(lambda *a: (fused_ln_mlp(*a),), x, *mlp, 1e-6, g)
                        report[(f"K2 {g} D{width} rows{rows_}", tname)] = dict(
                            err=_rel_err(got, fused_ln_mlp_plain(x, *mlp, 1e-6, g)), tol=TOL[tname], bit_equal=same)
                    (got,), same = _twice(lambda *a: (fused_res_ln_mlp(*a),), x, attn, ls1, *mlp, 1e-6)
                    report[(f"K10 D{width} rows{rows_}", tname)] = dict(
                        err=_rel_err(got, fused_res_ln_mlp_plain(x, attn, ls1, *mlp, 1e-6)), tol=TOL[tname],
                        bit_equal=same)
        for width in (64, 768, 1024):
            x = randn(2, 300, width, dtype=dtype)
            mlp = (randn(width, dtype=torch.float32, scale=0.1) + 1,
                   randn(width, dtype=torch.float32, scale=0.1),
                   randn(4 * width, width, dtype=torch.float32, scale=width ** -0.5),
                   randn(4 * width, dtype=torch.float32, scale=0.1),
                   randn(width, 4 * width, dtype=torch.float32, scale=(4 * width) ** -0.5),
                   randn(width, dtype=torch.float32, scale=0.1), randn(width, dtype=torch.float32) + 1)
            err = max(_rel_err(fused_ln_mlp(x, *mlp, 1e-6, g), fused_ln_mlp_plain(x, *mlp, 1e-6, g))
                      for g in ("tanh", "exact"))
            report[(f"K2 D{width}", tname)] = dict(err=err, tol=TOL[tname])
        for hdim in range(16, 129, 16):  # K4 at every head dim it takes
            q, k_, v_ = (randn(2, n_, 8 * hdim, dtype=dtype) for n_ in (300, 700, 700))
            o, l, m = flash_cross_attention(q, k_, v_, 8)
            args = (q, k_, v_, o, randn(2, 300, 8 * hdim, dtype=dtype), l, m, 8)
            err = max(_rel_l2(g, w) for g, w in zip(
                flash_cross_attention_bwd(*args), flash_cross_attention_bwd_plain(*args)))
            report[(f"K4 hd{hdim}", tname)] = dict(err=err, tol=TOL_K4[tname])
        # ragged and tiny shapes, where the bf16 kernels' TMA boxes run past
        # Nq or Nk and read zeros: K4 and K8/K9 (views and contiguous) at hd
        # 48 and 128, o drawn at random so that ds is no rounding noise (at
        # Nk 1 the true o is v and dp equals delta); each launched twice
        for nq_ in (1, 63, 65):
            for nk_ in (1, 65, 2049):
                for hdim in (48, 128):
                    q, do_ = randn(2, nq_, 3 * hdim, dtype=dtype), randn(2, nq_, 3 * hdim, dtype=dtype)
                    k_, v_ = randn(2, nk_, 3 * hdim, dtype=dtype), randn(2, nk_, 3 * hdim, dtype=dtype)
                    _, l, m = flash_cross_attention_plain(q, k_, v_, 3)
                    o = randn(2, nq_, 3 * hdim, dtype=dtype)
                    got, same = _twice(flash_cross_attention_bwd, q, k_, v_, o, do_, l, m, 3)
                    errs = [_rel_l2(g, w) for g, w in zip(
                        got, flash_cross_attention_bwd_plain(q, k_, v_, o, do_, l, m, 3))]
                    hm = [t.view(2, -1, 3, hdim).transpose(1, 2) for t in (q, k_, v_, o, do_)] + [l, m]
                    for layout in (hm, [t.contiguous() for t in hm[:5]] + hm[5:]):
                        got, same_ = _twice(flash_attention_head_major_bwd, *layout)
                        errs += [_rel_l2(g, w) for g, w in zip(got, flash_attention_head_major_bwd_plain(*layout))]
                        same = same and same_
                    report[(f"K4/K8/K9 nq{nq_} nk{nk_} hd{hdim}", tname)] = dict(
                        err=max(errs), tol=TOL_K4[tname], bit_equal=same)
        for hdim in range(16, 129, 16):  # K8/K9 at every head dim they take, views and contiguous
            hm, _ = _k89_inputs(randn, (2, 3, 130, 300, hdim, None), dtype)
            err = max(_rel_l2(g, w) for layout in (hm, [t.contiguous() for t in hm[:5]] + hm[5:])
                      for g, w in zip(flash_attention_head_major_bwd(*layout),
                                      flash_attention_head_major_bwd_plain(*layout)))
            report[(f"K8 hd{hdim}", tname)] = dict(err=err, tol=TOL_K4[tname])
        for heads_, hdim in ((4, 16), (12, 64)):  # K5: dinov2-test, base/large backbones
            qkv = randn(2, 301, 3 * heads_ * hdim, dtype=dtype)
            bias = _token_bias(torch, [(10, 30), (15, 17)], dev, grid=(15, 20), cls=True)
            err, l2 = _masked_errs([(flash_qkv_self_attention_masked(qkv, b_, heads_),
                                     flash_qkv_self_attention_masked_plain(qkv, b_, heads_))
                                    for b_ in (bias, bias[1].contiguous())])
            report[(f"K5 hd{hdim}", tname)] = dict(err=err, tol=TOL[tname], l2=l2, tol_l2=TOL_L2[tname])
        for heads_, hdim in ((8, 64), (8, 96), (8, 128)):  # K6: other decoders' head dims
            q, k_ = randn(2, 300, heads_ * hdim, dtype=dtype), randn(2, 600, heads_ * hdim, dtype=dtype)
            bias = _token_bias(torch, [(10, 20), (15, 17)], dev, grid=(15, 20)).repeat(1, 2).contiguous()
            err, l2 = _masked_errs([(flash_cross_attention_masked(q, k_, k_, b_, heads_),
                                     flash_cross_attention_masked_plain(q, k_, k_, b_, heads_))
                                    for b_ in (bias, bias[1].contiguous())])
            report[(f"K6 hd{hdim}", tname)] = dict(err=err, tol=TOL[tname], l2=l2, tol_l2=TOL_L2[tname])

    # the token cache's encode shape (tasks.encode_tokens and the token_fast
    # loader's misses): chunks of ref_token_cache_encode_batch whole images of
    # step 8's tree, 540x720 trimmed to 532x714, 38x51 patches and CLS (1939
    # rows: a ragged last tile); K1 and K2 (tanh and exact) against their
    # plain versions at step 3's bounds, each launched twice. A generator of
    # its own keeps the other draws what they were
    g_enc = torch.Generator(device=dev).manual_seed(SEED + 5)
    enc_b = int(load_config("default").this_main.ref_token_cache_encode_batch)
    enc_n = (540 // vit.patch_size) * (720 // vit.patch_size) + 1

    def enc_randn(*shape, dtype, scale=1.0):
        return (torch.randn(*shape, generator=g_enc, device=dev) * scale).to(dtype)

    for dtype in (torch.bfloat16, torch.float32):
        tname = str(dtype).split(".")[-1]
        qkv = enc_randn(enc_b, enc_n, 3 * d, dtype=dtype)
        report[(f"K1 encode ({enc_b}, {enc_n})", tname)] = fwd_entry(
            [(_twice(flash_qkv_self_attention, qkv, h), flash_qkv_self_attention_plain(qkv, h))], tname)
        x = enc_randn(enc_b, enc_n, d, dtype=dtype)
        mlp = (enc_randn(d, dtype=torch.float32, scale=0.1) + 1, enc_randn(d, dtype=torch.float32, scale=0.1),
               enc_randn(f, d, dtype=torch.float32, scale=d ** -0.5), enc_randn(f, dtype=torch.float32, scale=0.1),
               enc_randn(d, f, dtype=torch.float32, scale=f ** -0.5), enc_randn(d, dtype=torch.float32, scale=0.1),
               enc_randn(d, dtype=torch.float32, scale=0.5) + 1)
        for g in ("tanh", "exact"):
            (got,), same = _twice(lambda *a: (fused_ln_mlp(*a),), x, *mlp, vit.layer_norm_eps, g)
            report[(f"K2 {g} encode ({enc_b}, {enc_n})", tname)] = dict(
                err=_rel_err(got, fused_ln_mlp_plain(x, *mlp, vit.layer_norm_eps, g)), tol=TOL[tname], bit_equal=same)
        del qkv, x, mlp, got

    bad = []
    for (kern, tname), r in report.items():
        ok = r["err"] <= r["tol"] and r.get("l2", 0.0) <= r.get("tol_l2", 0.0) and r.get("bit_equal", True)
        line = f"{kern:7s} {tname:8s} err {r['err']:.3e} (tol {r['tol']:.1e})"
        if "bit_equal" in r:
            line += f" rerun bit-equal {r['bit_equal']}"
        if "l2" in r:
            line += f" rel L2 {r['l2']:.3e} (tol {r['tol_l2']:.1e})"
        if "ms" in r:  # not a preset-width check
            line += (f" max|d| {r['max_abs']:.3e} kernel {r['ms']:.3f} ms plain {r['plain_ms']:.3f} ms "
                     f"library {r['library_ms'] if r['library_ms'] is None else round(r['library_ms'], 3)} ms "
                     f"bound {r['bound_ms']:.3f} ms ({r.get('bound_floor', r['bound_by'])})")
        if "k1_ms" in r:
            line += f" K1 same qkv {r['k1_ms']:.3f} ms"
        if "k3_ms" in r:
            line += f" K3 same work {r['k3_ms']:.3f} ms"
        if "k4_ms" in r:
            line += f" K4 same work {r['k4_ms']:.3f} ms"
        if "k7_ms" in r:
            line += f" K7 same inputs {r['k7_ms']:.3f} ms"
        if "k2res_ms" in r:
            line += f" residual add + K2 {r['k2res_ms']:.3f} ms"
        if "unfused_ms" in r:
            line += f" unfused chain {r['unfused_ms']:.3f} ms"
        if "ms_nk10952" in r:
            line += (f"; at Nk 10952: kernel {r['ms_nk10952']:.3f} ms, K3 {r['k3_ms_nk10952']:.3f} ms, "
                     f"bound {r['bound_ms_nk10952']:.3f} ms")
        print(f"{line} {'ok' if ok else 'FAIL'}")
        if not ok:
            bad.append(f"{kern} {tname}")
    if bad:
        _fail("kernel disagrees with its plain version: " + ", ".join(bad))
    if kernels_only:
        print("chip_smoke: kernel checks passed; --kernels-only stops here")
        return 0

    # --- 4. the full-width forward through make_predict_step ------------------
    cfg = CrossScoreConfig()  # dinov2-small, bf16, flash, fused
    params = init_params(cfg, SEED, dev)
    model = load_into(CrossScoreNet(cfg, device=dev), params)
    step = make_predict_step(model)
    query = torch.randint(0, 256, (B, HW, HW, 3), generator=gen, device=dev, dtype=torch.uint8)
    refs = torch.randint(0, 256, (B, K, HW, HW, 3), generator=gen, device=dev, dtype=torch.uint8)
    wrappers = _rank_launches()

    def zero_launches():
        for w in wrappers.values():
            w.launches = 0
            if hasattr(w, "launches_by_mode"):
                w.launches_by_mode = dict.fromkeys(w.launches_by_mode, 0)

    def read_launches():
        return {k: w.launches for k, w in wrappers.items()}

    zero_launches()
    score = step(query, refs)["score_map_ref_cross"]
    torch.cuda.synchronize()
    launches = read_launches()
    want = _launches(K1=vit.num_layers, K2=vit.num_layers, K3=2 * cfg.decoder_layers)
    print(f"predict path launches per forward: {launches} (expected {want})")
    if launches != want:
        _fail(f"launch counts {launches} != {want}")
    if tuple(score.shape) != (B, HW, HW) or not bool(torch.isfinite(score).all()) \
            or float(score.min()) < 0.0 or float(score.max()) > 1.0:
        _fail(f"score map shape {tuple(score.shape)} / finite / range check failed")
    print(f"score map {tuple(score.shape)} mean {float(score.mean()):.6f} "
          f"min {float(score.min()):.6f} max {float(score.max()):.6f}")
    torch.cuda.reset_peak_memory_stats()
    step_ms = _time_ms(torch, lambda: step(query, refs), reps=5)
    print(f"predict step: {step_ms:.2f} ms per batch of {B} maps = {1e3 * B / step_ms:.2f} maps/s "
          f"(518 px, K={K}, bf16, median of 5 after warm-up); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # --- 5. the same net at B=1, kernels vs all-plain, bf16 and fp32 ----------
    q1, r1 = query[:1], refs[:1]
    for dtype, kernel_mlp in ((torch.bfloat16, "fused_exact"), (torch.bfloat16, "fused"),
                              (torch.float32, "fused_exact")):
        tname = str(dtype).split(".")[-1]
        maps = {}
        for impl, mlp_impl in (("flash", kernel_mlp), ("dense", "unfused")):
            c = CrossScoreConfig(compute_dtype=dtype, attention_impl=impl, mlp_impl=mlp_impl)
            net = load_into(CrossScoreNet(c, device=dev), params)
            maps[impl] = make_predict_step(net)(q1, r1)["score_map_ref_cross"]
        mae = float((maps["flash"] - maps["dense"]).abs().mean())
        # the default bf16 path uses the tanh GELU, the plain one the exact form
        tol = NET_TOL[tname] if kernel_mlp == "fused_exact" else 2 * NET_TOL[tname]
        print(f"whole net B=1 {tname} {kernel_mlp} vs dense/unfused: score MAE {mae:.3e} (tol {tol:.1e})")
        if not mae < tol:
            _fail(f"whole-net {tname} {kernel_mlp} MAE {mae} >= {tol}")
    del model, step, query, refs, net, maps
    torch.cuda.empty_cache()

    # --- 6. the full-width train step through make_train_step -----------------
    tcfg = load_config("default")  # dinov2-small, bf16, flash, fused; AdamW 5e-4, StepLR
    mcfg = CrossScoreConfig.from_config(tcfg)
    model = load_into(CrossScoreNet(mcfg, device=dev), params)
    optimizer, scheduler, _ = make_optimizer(tcfg, model, steps_per_epoch=1)
    train_step = make_train_step(model, optimizer, scheduler)
    batch = {
        "query/img": torch.randint(0, 256, (TB, HW, HW, 3), generator=gen, device=dev, dtype=torch.uint8),
        "reference/cross/imgs": torch.randint(0, 256, (TB, TK, HW, HW, 3), generator=gen, device=dev,
                                              dtype=torch.uint8),
        "query/score_map": torch.rand(TB, HW, HW, generator=gen, device=dev),
        "_valid": torch.tensor(TB, device=dev),
    }
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    zero_launches()
    state, metrics = train_step(TrainState(), batch)
    torch.cuda.synchronize()
    train_launches = read_launches()
    want = _launches(K1=vit.num_layers, K2=vit.num_layers, K3=2 * mcfg.decoder_layers,
                     K4=2 * mcfg.decoder_layers)
    print(f"train step launches: {train_launches} (expected {want})")
    if train_launches != want:
        _fail(f"train launch counts {train_launches} != {want}")
    loss = flash_loss = float(metrics["loss"])
    flash_pred = metrics["pred"].float().clone()  # the tp route's reference (step 11)
    if not np.isfinite(loss) or tuple(metrics["pred"].shape) != (TB, HW, HW):
        _fail(f"train step loss {loss} / pred shape {tuple(metrics['pred'].shape)}")
    after = model.state_dict()
    frozen = [k for k in after if k.startswith("backbone.") or k == "pos_enc_fn.PE"]
    trained = [k for k, p in model.named_parameters() if p.requires_grad]
    moved_frozen = [k for k in frozen if not torch.equal(after[k], before[k])]
    unmoved = [k for k in trained if torch.equal(after[k], before[k])]
    if moved_frozen or unmoved or not all(k.startswith("ref_cross.") for k in trained):
        _fail(f"frozen parameters moved {moved_frozen[:3]}, trained ones did not {unmoved[:3]}")
    print(f"train step: loss {loss:.6f}, {len(trained)} decoder/head tensors updated, "
          f"{len(frozen)} backbone/PE tensors bit-identical")
    torch.cuda.reset_peak_memory_stats()
    train_ms = _time_ms(torch, lambda: train_step(state, batch), reps=5)
    train_peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"train step: {train_ms:.2f} ms per step of B={TB}, K={TK} (518 px, bf16 compute, "
          f"fp32 master weights; median of 5 after warm-up); peak memory {train_peak:.2f} GiB")
    _profile(torch, lambda: train_step(state, batch), train_ms)
    del model, optimizer, scheduler, train_step, before, after, metrics
    torch.cuda.empty_cache()

    # --- 7. whole-step gradients at B=1, kernels vs all-plain, fp32 and bf16 --
    batch1 = {k: (v[:1] if v.ndim else torch.tensor(1, device=dev)) for k, v in batch.items()}
    for dtype in (torch.float32, torch.bfloat16):
        tname = str(dtype).split(".")[-1]
        grads = {}
        for impl, mlp_impl in (("flash", "fused_exact"), ("dense", "unfused")):
            net = load_into(CrossScoreNet(CrossScoreConfig(compute_dtype=dtype, attention_impl=impl,
                                                           mlp_impl=mlp_impl), device=dev), params)
            loss_fn(net, batch1)[0].backward()
            grads[impl] = {n: p.grad for n, p in net.named_parameters() if p.grad is not None}
        errs = []
        for leaf, g in grads["dense"].items():
            got = grads["flash"][leaf]
            if dtype == torch.float32:
                errs.append(float((got - g).abs().max() / g.abs().max()))
            else:
                errs.append(float(torch.linalg.vector_norm(got - g) / torch.linalg.vector_norm(g)))
        err = max(errs)
        print(f"whole step B=1 {tname} gradients, kernels vs dense/unfused: {len(errs)} leaves, "
              f"worst {err:.3e} (tol {GRAD_TOL[tname]:.1e})")
        if not err <= GRAD_TOL[tname]:
            _fail(f"whole-step {tname} gradients differ: {err} > {GRAD_TOL[tname]}")
    del batch1, net, grads  # the batch serves the tp route's step (step 11)
    torch.cuda.empty_cache()

    # --- 8. the train CLI end to end, then a resume ----------------------------
    import tempfile

    from crossscore_tpu_torch.data.synthetic import generate
    from crossscore_tpu_torch.tasks.train import main as train_main

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        # short side 540 (the training resize) so that 518 px crops exist
        generate(Path(tmp) / "datadir", hw=(540, 720), scenes_per_split={"train": 1, "test": 1}, seed=SEED)
        ov = [f"data.dataset.path=[{tmp}/datadir]", f"run.dir={tmp}/log",
              "data.loader.train.batch_size=2", "data.loader.validation.batch_size=2",
              "data.loader.train.num_workers=4", "data.loader.validation.num_workers=4",
              "trainer.num_sanity_val_steps=1", "trainer.limit_val_batches=1",
              "logger.vis_scalar_every_n_train_steps=1"]
        zero_launches()
        run1 = train_main(ov + ["trainer.max_steps=2", "alias=first"])
        run2 = train_main(ov + ["trainer.max_steps=4", f"trainer.ckpt_path_to_load={run1 / 'ckpt'}",
                                "alias=resumed"])
        cli_launches = read_launches()

        def rows(run):
            return [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]

        steps1 = [r["step"] for r in rows(run1) if "train/loss" in r]
        steps2 = [r["step"] for r in rows(run2) if "train/loss" in r]
        losses = [r["train/loss"] for r in rows(run1) + rows(run2) if "train/loss" in r]
        val = [r["validation/loss"] for r in rows(run1) + rows(run2) if "validation/loss" in r]
        ckpts = sorted(p.name for p in (run2 / "ckpt").glob("*.ckpt"))
        print(f"train CLI (dinov2-small, 518 px crops, B=2, K={TK}, bf16): steps {steps1} then, resumed, "
              f"{steps2}; losses {[round(x, 6) for x in losses]}; validation losses "
              f"{[round(x, 6) for x in val]}; checkpoints {ckpts}; launches {cli_launches}; "
              f"{time.perf_counter() - t0:.1f} s")
        if steps1 != [1, 2] or steps2 != [3, 4] or not all(np.isfinite(losses)) or len(val) < 2 \
                or ckpts != ["step_00000004.ckpt"] or cli_launches["K4"] != 4 * (len(steps1) + len(steps2)):
            _fail("train CLI run or resume")

    # --- 9. the predict CLI at full width, four modes --------------------------
    import contextlib

    from crossscore_tpu_torch.tasks.predict import main as predict_main

    n_query, n_ref = 3 * PB, PK  # three batches; every query takes the whole pool
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        qdir, rdir = _write_predict_dirs(Path(tmp), n_query, n_ref)
        pcfg = CrossScoreConfig.from_config(load_config("default_predict"))
        ckpt = Path(tmp) / "run" / "ckpt" / "seeded.ckpt"  # the CLI makes <tmp>/run/predict
        ckpt.parent.mkdir(parents=True)
        torch.save({"state_dict": {f"model.{k}": v.cpu() for k, v in init_params(pcfg, SEED).items()}}, ckpt)
        # gray maps and no figures: rgb maps and figures need matplotlib, which
        # the card's machine lacks; no image copies, so that maps/s reads the
        # loader, the device and the score-map writer
        common = [f"trainer.ckpt_path_to_load={ckpt}", f"data.dataset.query_dir={qdir}",
                  f"data.dataset.reference_dir={rdir}", f"data.neighbour_config.cross={PK}",
                  f"data.loader.validation.batch_size={PB}",
                  "logger.predict.write.config.score_map_colour_mode=gray",
                  "logger.predict.write.config.vis_img_every_n_steps=-1",
                  "logger.predict.write.flag.image_query=false",
                  "logger.predict.write.flag.image_reference=false"]
        modes = {"a": ("off", "off"), "b": ("off", "on"), "c": ("on", "on"), "d": ("on", "off")}
        cli = {}
        for tag, (buckets, cache) in modes.items():
            tee = _Tee(sys.stdout)
            zero_launches()
            with contextlib.redirect_stdout(tee):
                out = predict_main(common + [f"this_main.shape_buckets={buckets}",
                                             f"this_main.ref_token_cache={cache}",
                                             f"logger.predict.out_dir={tmp}/out_{tag}"])
            torch.cuda.synchronize()
            text = "".join(tee.text)
            rate = re.search(r"= ([0-9.]+) maps/s", text)
            h2d = re.search(r"host-to-device ([0-9.]+) MiB per batch", text)
            hits = re.search(r"ref-token cache: (\d+) hits, (\d+) unique misses", text)
            cli[tag] = dict(launches=read_launches(), maps_per_s=float(rate.group(1)),
                            h2d_mib_per_batch=float(h2d.group(1)),
                            hits=int(hits.group(1)) if hits else None,
                            misses=int(hits.group(2)) if hits else None,
                            maps=sorted((out / "batch" / "score_map_ref_cross").glob("*.png")))
        # three full batches; a cached run adds one miss batch through the backbone
        n_b, n_layers, n_dec = n_query // PB, vit.num_layers, 2 * pcfg.decoder_layers
        bad = []
        for tag, (buckets, cache) in modes.items():
            r = cli[tag]
            enc = n_layers * (n_b + (cache == "on"))
            att, dec = ("K5", "K6") if buckets == "on" else ("K1", "K3")
            other = ("K1", "K3") if buckets == "on" else ("K5", "K6")
            want = {"K2": enc, att: enc, dec: n_dec * n_b, other[0]: 0, other[1]: 0, "K4": 0}
            got = {k: r["launches"][k] for k in want}
            print(f"predict CLI ({tag}) buckets {buckets}, cache {cache}: launches {got} (expected {want}); "
                  f"{r['maps_per_s']:.2f} maps/s; host-to-device {r['h2d_mib_per_batch']:.2f} MiB per batch; "
                  f"cache hits {r['hits']}, misses {r['misses']}; {len(r['maps'])} maps")
            if got != want or len(r["maps"]) != n_query:
                bad.append(f"{tag} launches/maps")
            # the first batch's slots all resolve from its own misses (counted as
            # misses, as the JAX counter does); every later slot is a hit
            if cache == "on" and (r["misses"] != n_ref or r["hits"] != (n_b - 1) * PB * PK):
                bad.append(f"{tag} cache misses {r['misses']} != {n_ref}")
        # the valid region of every written map agrees across the four modes
        from PIL import Image

        def read_maps(tag):
            return [np.asarray(Image.open(p)).astype(np.float64) / 32767.0 - 1.0 for p in cli[tag]["maps"]]

        maps = {tag: read_maps(tag) for tag in modes}
        names = [p.name for p in cli["a"]["maps"]]
        agree = {}
        for tag in "bcd":
            if [p.name for p in cli[tag]["maps"]] != names:
                bad.append(f"{tag} map names")
                continue
            diffs = [np.abs(x - y) for x, y in zip(maps[tag], maps["a"])]
            agree[tag] = (float(np.mean([dd.mean() for dd in diffs])), float(max(dd.max() for dd in diffs)))
            print(f"predict CLI ({tag}) vs (a): score-map MAE {agree[tag][0]:.3e} (tol {CLI_TOL:.0e}), "
                  f"max |d| {agree[tag][1]:.3e}, shape {maps[tag][0].shape}")
            if not agree[tag][0] <= CLI_TOL:
                bad.append(f"{tag} maps disagree")
        print(f"predict CLI: 4 runs in {time.perf_counter() - t0:.1f} s")
        if bad:
            _fail("predict CLI: " + ", ".join(bad))

        # where the CLI's time goes: the host loader alone (decode, resize,
        # normalise, collate on 8 threads), then each mode's device step alone
        # on one batch already on the card
        from crossscore_tpu_torch.data.loader import Loader
        from crossscore_tpu_torch.data.simple_reference import SimpleReference
        from crossscore_tpu_torch.models.crossscore import make_backbone_encoder
        from crossscore_tpu_torch.train.step import make_predict_step_cached

        dataset = SimpleReference(str(qdir), str(rdir), {"strategy": "random", "cross": PK, "deterministic": False})
        t1 = time.perf_counter()
        host = list(Loader(dataset, PB, shuffle=False, num_workers=8).epoch(0))
        loader_rate = n_query / (time.perf_counter() - t1)
        model = load_into(CrossScoreNet(pcfg, device=dev), init_params(pcfg, SEED, dev))
        step, step_cached = make_predict_step(model), make_predict_step_cached(model)
        encode = make_backbone_encoder(pcfg)
        q_img = torch.from_numpy(host[0]["query/img"]).to(dev)
        r_img = torch.from_numpy(host[0]["reference/cross/imgs"]).to(dev)
        bucket = (BUCKET_GRID[0] * 14, BUCKET_GRID[1] * 14)
        pad = lambda t: F.pad(t, (0, 0, 0, bucket[1] - t.shape[-2], 0, bucket[0] - t.shape[-3]))  # noqa: E731
        vhw = np.tile(np.asarray(host[0]["query/img"].shape[1:3], np.int32), (PB, 1))
        tokens = encode(model, r_img.reshape(PB * PK, *r_img.shape[2:])).reshape(PB, PK, -1, d)
        tokens_b = encode(model, pad(r_img).reshape(PB * PK, *bucket, 3),
                          np.repeat(vhw, PK, axis=0)).reshape(PB, PK, -1, d)
        device_ms = {
            "a": _time_ms(torch, lambda: step(q_img, r_img), reps=5),
            "b": _time_ms(torch, lambda: step_cached(q_img, tokens), reps=5),
            "c": _time_ms(torch, lambda: step_cached(pad(q_img), tokens_b, vhw), reps=5),
            "d": _time_ms(torch, lambda: step(pad(q_img), pad(r_img), vhw), reps=5),
        }
        print(f"predict CLI breakdown: host loader alone {loader_rate:.2f} maps/s (8 threads); device step "
              "alone, ms per batch of 8 (maps/s): " + ", ".join(
                  f"({k}) {v:.2f} ({1e3 * PB / v:.1f})" for k, v in device_ms.items()))
        del model, step, step_cached, tokens, tokens_b, q_img, r_img, host
        torch.cuda.empty_cache()

    # --- 10. view-parallel predict ----------------------------------------------
    # The card's machine has one H100: NCCL runs with one rank, and the
    # two-rank runs use gloo ranks that share the card (NCCL refuses two
    # ranks on one device), so their maps/s is not a scaling number.
    from crossscore_tpu_torch.ops.context_parallel import context_parallel_cross_attention
    from crossscore_tpu_torch.parallel.launch import RankPool

    vp = {}
    # (i) the CP op through NCCL over one rank at the full shape: the
    # all-reduces are the identity, so o is local K7's o
    with _one_nccl_rank():
        dhd = d // dec_h
        xs = [randn(B, n_, d, dtype=torch.bfloat16) for n_ in (nq, VP_NK[0], VP_NK[0])]
        hm = [t.view(B, -1, dec_h, dhd).transpose(1, 2) for t in xs]
        o_cp = context_parallel_cross_attention(*hm)
        o_k7 = flash_attention_head_major(*hm)[0]
        torch.cuda.synchronize()
        vp["nccl_one_rank_rel_l2"] = _rel_l2(o_cp, o_k7)
        vp["nccl_one_rank_max_abs"] = _max_abs(o_cp, o_k7)
        del xs, hm, o_cp, o_k7
    print(f"view-parallel (i): CP op over one NCCL rank at q ({B}, {dec_h}, {nq}, {d // dec_h}), Nk "
          f"{VP_NK[0]}, bf16: relative L2 against local K7 {vp['nccl_one_rank_rel_l2']:.3e}, max |d| "
          f"{vp['nccl_one_rank_max_abs']:.3e} (tol {VP_ONE_RANK_TOL:.0e})")
    if not vp["nccl_one_rank_rel_l2"] <= VP_ONE_RANK_TOL:
        _fail("the CP op over one NCCL rank differs from local K7")
    torch.cuda.empty_cache()

    n_query, n_ref = 3 * B, K  # three batches; every query lists the pool in one order
    with tempfile.TemporaryDirectory() as tmp, RankPool(2) as pool:
        # (ii) fp32 B=1 forward on two gloo ranks against the all-plain net
        q1 = torch.randint(0, 256, (1, HW, HW, 3), generator=gen, device=dev, dtype=torch.uint8)
        r1 = torch.randint(0, 256, (1, K, HW, HW, 3), generator=gen, device=dev, dtype=torch.uint8)
        plain_cfg = CrossScoreConfig(compute_dtype=torch.float32, attention_impl="dense", mlp_impl="unfused")
        net = load_into(CrossScoreNet(plain_cfg, device=dev), init_params(plain_cfg, SEED, dev))
        want = make_predict_step(net)(q1, r1)["score_map_ref_cross"].cpu().numpy()
        del net
        torch.cuda.empty_cache()
        ranks = pool.run(_vp_forward_rank, q1.cpu().numpy(), r1.cpu().numpy(), timeout=600)
        vp["fwd_mae"] = float(np.abs(ranks[0]["maps"] - want).mean())
        same = bool(np.array_equal(ranks[0]["maps"], ranks[1]["maps"]))
        print(f"view-parallel (ii): fp32 B=1 K={K} forward on 2 gloo ranks sharing the card vs the "
              f"single-process all-plain net: score MAE {vp['fwd_mae']:.3e} (tol {NET_TOL['float32']:.0e}); "
              f"ranks equal {same}; launches per rank {[r['launches'] for r in ranks]}")
        if not (vp["fwd_mae"] < NET_TOL["float32"] and same
                and all(r["launches"]["K7"] == cfg.decoder_layers for r in ranks)):
            _fail("view-parallel forward on two ranks")

        # (iii) the predict CLI: two gloo ranks, uncached and cached, against
        # the single-rank CLI on 518x518 images (the kernel shapes above)
        qdir, rdir = _write_predict_dirs(Path(tmp), n_query, n_ref, hw=(HW, HW))
        pcfg = CrossScoreConfig.from_config(load_config("default_predict"))
        ckpt = Path(tmp) / "run" / "ckpt" / "seeded.ckpt"
        ckpt.parent.mkdir(parents=True)
        torch.save({"state_dict": {f"model.{k}": v.cpu() for k, v in init_params(pcfg, SEED).items()}}, ckpt)
        common = [f"trainer.ckpt_path_to_load={ckpt}", f"data.dataset.query_dir={qdir}",
                  f"data.dataset.reference_dir={rdir}", f"data.neighbour_config.cross={K}",
                  "data.neighbour_config.deterministic=true", f"data.loader.validation.batch_size={B}",
                  "logger.predict.write.config.score_map_colour_mode=gray",
                  "logger.predict.write.config.vis_img_every_n_steps=-1",
                  "logger.predict.write.flag.image_query=false",
                  "logger.predict.write.flag.image_reference=false"]
        t0 = time.perf_counter()
        zero_launches()
        with contextlib.redirect_stdout(_Tee(sys.stdout)):
            one = predict_main(common + ["this_main.ref_token_cache=off", f"logger.predict.out_dir={tmp}/one"])
        torch.cuda.synchronize()
        single_s = time.perf_counter() - t0
        n_layers, n_b = vit.num_layers, n_query // B
        vp_cli = {}
        for cache in ("off", "on"):
            t0 = time.perf_counter()
            ranks = pool.run(_vp_cli_rank, common + [
                f"this_main.ref_token_cache={cache}", "model.gpu.view_parallel=on",
                "model.gpu.dist_backend=gloo", f"logger.predict.out_dir={tmp}/vp_{cache}"], timeout=900)
            wall = time.perf_counter() - t0
            enc = n_layers * (n_b + (cache == "on"))  # a cached run adds one miss batch
            want_l = _launches(K1=enc, K2=enc, K3=pcfg.decoder_layers * n_b, K7=pcfg.decoder_layers * n_b)
            digests, rates, misses, bad = set(), [], [], []
            for rank, r in enumerate(ranks):
                text = r["text"]
                digests.add(re.search(r"score maps sha256 (\w+)", text).group(1))
                rates.append(float(re.search(r"= ([0-9.]+) maps/s", text).group(1)))
                hits = re.search(r"ref-token cache: (\d+) hits, (\d+) unique misses", text)
                misses.append(int(hits.group(2)) if hits else None)
                if r["launches"] != want_l:
                    bad.append(f"rank {rank} launches {r['launches']} != {want_l}")
            if cache == "on" and misses != [K // 2, K // 2]:
                bad.append(f"misses per rank {misses} != {[K // 2] * 2}")
            if len(digests) != 1:
                bad.append("the ranks' maps differ")
            got_maps = sorted(Path(f"{tmp}/vp_{cache}/batch/score_map_ref_cross").glob("*.png"))
            ref_maps = sorted((one / "batch" / "score_map_ref_cross").glob("*.png"))
            if [p.name for p in got_maps] != [p.name for p in ref_maps] or len(got_maps) != n_query:
                bad.append("map files differ from the single-rank run")
                mae = float("nan")
            else:
                from PIL import Image

                mae = float(np.mean([np.abs(np.asarray(Image.open(a), np.float64)
                                            - np.asarray(Image.open(b), np.float64)).mean() / 32767.0
                                     for a, b in zip(got_maps, ref_maps)]))
            vp_cli[cache] = dict(launches_per_rank=ranks[0]["launches"], misses_per_rank=misses,
                                 maps_per_s_per_rank=rates, wall_s=wall, mae_vs_single_rank=mae)
            print(f"view-parallel (iii) predict CLI, 2 gloo ranks time-slicing one card, cache {cache}: "
                  f"launches per rank {ranks[0]['launches']} (expected {want_l}); misses per rank {misses}; "
                  f"ranks' maps equal {len(digests) == 1}; MAE vs the single-rank CLI {mae:.3e} "
                  f"(tol {CLI_TOL:.0e}); {rates} maps/s per rank (two ranks time-slicing one card, the "
                  f"loader in the loop), {wall:.1f} s wall; single-rank run {single_s:.1f} s")
            if not mae <= CLI_TOL:
                bad.append(f"MAE {mae} vs the single-rank CLI")
            if bad:
                _fail(f"view-parallel predict CLI, cache {cache}: " + "; ".join(bad))
        vp["cli"] = vp_cli
    torch.cuda.empty_cache()

    # --- 11. tensor-parallel training over one NCCL rank ------------------------
    import dataclasses

    from crossscore_tpu_torch.ops.flash_attention import head_major_flash_attention

    from crossscore_tpu_torch.parallel import mesh

    tp = {}
    n_dec = mcfg.decoder_layers
    with _one_nccl_rank():
        mesh.make_groups(1)  # TP = 1: the whole of every layer on this rank
        tp_cfg = dataclasses.replace(mcfg, attention_impl="tp")
        model = load_into(CrossScoreNet(tp_cfg, device=dev), params)  # TP = 1: the shard is the whole
        batch2 = {k: (v[:2] if v.ndim else torch.tensor(2, device=dev)) for k, v in batch.items()}
        with torch.no_grad():  # the reference of the two-rank bf16 step (step 12)
            loss2, (pred2, _, _) = loss_fn(model, batch2)
        tp["loss_b2_one_rank"], pred_b2_one_rank = float(loss2), pred2.float().cpu().numpy()
        optimizer, scheduler, _ = make_optimizer(tcfg, model, steps_per_epoch=1)
        tp_step = make_train_step(model, optimizer, scheduler)
        before = {k: v.detach().clone() for k, v in model.state_dict().items()}
        zero_launches()
        state, metrics = tp_step(TrainState(), batch)
        torch.cuda.synchronize()
        tp_launches = read_launches()
        want = _launches(K2=vit.num_layers, K7=vit.num_layers + 2 * n_dec, K8=n_dec, K9=n_dec)
        print(f"tp train step (TP = 1, one NCCL rank) launches: {tp_launches} (expected {want})")
        if tp_launches != want:
            _fail(f"tp train launch counts {tp_launches} != {want}")
        tp["loss"] = float(metrics["loss"])
        pred = metrics["pred"].float()
        tp["map_mae_vs_flash"] = float((pred - flash_pred).abs().mean())
        tp["map_max_vs_flash"] = float((pred - flash_pred).abs().max())
        after = model.state_dict()
        moved_frozen = [k for k in frozen if not torch.equal(after[k], before[k])]
        unmoved = [k for k in trained if torch.equal(after[k], before[k])]
        print(f"tp train step: score maps against the flash route's on the same weights and batch: MAE "
              f"{tp['map_mae_vs_flash']:.3e} (tol {TP_MAP_TOL:.0e}), max |d| {tp['map_max_vs_flash']:.3e}; loss "
              f"{tp['loss']:.6f} against {flash_loss:.6f} (tol {TP_MAP_TOL:.0e}); {len(trained) - len(unmoved)} "
              f"of {len(trained)} decoder/head tensors updated; {len(frozen) - len(moved_frozen)} of "
              f"{len(frozen)} backbone/PE tensors bit-identical")
        if not (tuple(pred.shape) == (TB, HW, HW) and bool(torch.isfinite(pred).all())
                and tp["map_mae_vs_flash"] <= TP_MAP_TOL and abs(tp["loss"] - flash_loss) <= TP_MAP_TOL) \
                or moved_frozen or unmoved:
            _fail("tp train step: score maps, loss, or which parameters moved")
        del pred, flash_pred
        torch.cuda.reset_peak_memory_stats()
        tp["step_ms"] = _time_ms(torch, lambda: tp_step(state, batch), reps=5)
        tp["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        print(f"tp train step: {tp['step_ms']:.2f} ms per step of B={TB}, K={TK} (TP = 1; the flash route "
              f"{train_ms:.2f} ms above); peak memory {tp['peak_gib']:.2f} GiB")
        _profile(torch, lambda: tp_step(state, batch), tp["step_ms"], what="tp train step")
        del model, optimizer, scheduler, tp_step, before, after, metrics
        torch.cuda.empty_cache()

        # the CP backward over the one rank against local K9: the dq sum is
        # the identity, and the combine's o, l, m are local K7's
        dhd = d // dec_h
        xs = [randn(B, n_, d, dtype=torch.bfloat16).requires_grad_() for n_ in (nq, VP_NK[0], VP_NK[0])]
        hm = lambda ts: [t.view(B, -1, dec_h, dhd).transpose(1, 2) for t in ts]  # noqa: E731
        o_cp = context_parallel_cross_attention(*hm(xs))
        g = randn(*o_cp.shape, dtype=torch.bfloat16)
        got = torch.autograd.grad(o_cp, xs, g)
        xs_k = [t.detach().clone().requires_grad_() for t in xs]
        want_g = torch.autograd.grad(head_major_flash_attention(*hm(xs_k)), xs_k, g)
        tp["cp_bwd_one_rank_rel_l2"] = max(_rel_l2(a, b) for a, b in zip(got, want_g))
        print(f"CP backward over one NCCL rank at q ({B}, {dec_h}, {nq}, {dhd}), Nk {VP_NK[0]}, bf16: relative "
              f"L2 of dq, dk, dv against local K9, worst {tp['cp_bwd_one_rank_rel_l2']:.3e} "
              f"(tol {VP_ONE_RANK_TOL:.0e})")
        if not tp["cp_bwd_one_rank_rel_l2"] <= VP_ONE_RANK_TOL:
            _fail("the CP backward over one NCCL rank differs from local K9")
        del xs, xs_k, o_cp, g, got, want_g
    torch.cuda.empty_cache()

    # --- 12. two gloo ranks sharing the card: TP = 2, then view-parallel training
    # fp32 gradients at full width meet three kinks: the L1 loss where a score
    # equals its target (268324 pixels), and the decoder's ReLUs and the
    # head's leaky ReLU where an input is 0 (1369 x 384 inputs each). A few
    # sit within the two paths' fp32 rounding of their kink, and a flip there
    # moves a row of a gradient by one token's or one pixel's share. So the
    # all-plain reference is also run at the two-rank run's own L1 subgradient
    # and ReLU gates (``_gates``): the same function as the two-rank run's
    # wherever the two agree, which is everywhere else. That reading is held
    # tight (PINNED_GRAD_TOL); the reference at its own gates, with the flips
    # counted, is the witness of what the flips cost (TWO_RANK_GRAD_TOL).
    def host(bt):
        return {k: v.cpu().numpy() for k, v in bt.items()}

    def plain_net(c):
        pc = dataclasses.replace(c, attention_impl="dense", mlp_impl="unfused")
        return load_into(CrossScoreNet(pc, device=dev), init_params(pc, SEED, dev))

    def plain_grads(c, bt, pred_other, gates=None):
        """The single-process all-plain net (dense, unfused) of ``c``'s dtype
        and PE flag, backpropagating the L1 subgradient at ``pred_other``'s
        signs and, with ``gates``, its ReLUs at those gates: -> (gradients,
        the pixels whose sign differs from its own score map's, the ReLU
        inputs whose gate differs from its own, per ReLU)."""
        net, own = plain_net(c), []
        with _gates(record=own, pinned=None if gates is None else [torch.from_numpy(g) for g in gates]):
            _, (pred, _, w) = loss_fn(net, bt)
        gt = bt["query/score_map"].float()
        other = torch.from_numpy(pred_other).to(dev)
        w = torch.ones_like(gt) if w is None else w
        pred.backward(torch.sign(other - gt) * w / torch.clamp(w.sum(), min=1.0))
        flips = int((torch.sign(other - gt) != torch.sign(pred.detach() - gt)).sum())
        gate_flips = [0] * len(own) if gates is None else \
            [int((g.cpu().numpy() != p_).sum()) for g, p_ in zip(own, gates)]
        grads = {n: p.grad.cpu().numpy() for n, p in net.named_parameters() if p.requires_grad}
        del net
        torch.cuda.empty_cache()
        return grads, flips, gate_flips

    def adamw_on(c, grads):
        """The all-plain net's trainable parameters after one AdamW step (the
        default config's) on ``grads``."""
        net = plain_net(c)
        opt, _, _ = make_optimizer(tcfg, net, steps_per_epoch=1)
        for k, p in net.named_parameters():
            if p.requires_grad:
                p.grad = torch.from_numpy(grads[k]).to(dev)
        opt.step()
        out = {k: p.detach().cpu().numpy() for k, p in net.named_parameters() if p.requires_grad}
        del net, opt
        torch.cuda.empty_cache()
        return out

    def grad_err(got: dict, want: dict, what: str) -> float:
        """The worst leaf's relative L2 error; prints the three worst leaves
        with their max |difference| over their largest entry beside it."""
        if sorted(got) != sorted(want):
            _fail(f"gradient leaves differ: {sorted(set(got) ^ set(want))[:4]}")
        errs = sorted(((float(np.linalg.norm(got[k] - w) / max(np.linalg.norm(w), 1e-30)),
                        float(np.abs(got[k] - w).max() / max(np.abs(w).max(), 1e-30)), k) for k, w in want.items()),
                      reverse=True)
        print(f"  {what}: worst leaves (relative L2; max |d| over max |g|): "
              + "; ".join(f"{k} {e:.3e}; {m:.3e}" for e, m, k in errs[:3]))
        return errs[0][0]

    def two_rank_grads(c, bt, r) -> dict:
        """One rank's gradients against the all-plain net's, at the rank's
        gates and at the plain net's own (the witness)."""
        g_pin, flips, gate_flips = plain_grads(c, bt, r["pred"], r["gates"])
        g_own, _, _ = plain_grads(c, bt, r["pred"])
        return {"pinned": grad_err(r["grads"], g_pin, "at the ranks' gates"),
                "own_gates": grad_err(r["grads"], g_own, "at the plain net's own gates"),
                "l1_sign_flips": flips, "gate_flips": gate_flips}

    t0 = time.perf_counter()
    bad = []
    batch1 = {k: (v[:1] if v.ndim else torch.tensor(1, device=dev)) for k, v in batch.items()}
    vp_batch = {"query/img": torch.randint(0, 256, (1, HW, HW, 3), generator=gen, device=dev, dtype=torch.uint8),
                "reference/cross/imgs": torch.randint(0, 256, (1, K, HW, HW, 3), generator=gen, device=dev,
                                                      dtype=torch.uint8),
                "query/score_map": torch.rand(1, HW, HW, generator=gen, device=dev)}
    fp32_cfg = CrossScoreConfig(compute_dtype=torch.float32)
    with RankPool(2) as pool:
        # (i) TP = 2: fp32 B=1 against the all-plain step, bf16 B=2 against one rank
        r32 = pool.run(_tp_train_rank, "float32", host(batch1), timeout=600)
        g = two_rank_grads(fp32_cfg, batch1, r32[0])
        tp["tp2_fp32_grad_err"], tp["tp2_fp32_grad_err_own_gates"] = g["pinned"], g["own_gates"]
        tp["tp2_fp32_l1_sign_flips"], tp["tp2_fp32_gate_flips"] = g["l1_sign_flips"], g["gate_flips"]
        # the optimiser on the model ranks' shards against the single-process
        # AdamW on the same gathered gradients: every element of every leaf
        p_ref = adamw_on(fp32_cfg, r32[0]["grads"])
        tp["tp2_fp32_param_max_abs"] = max(float(np.abs(r32[0]["params"][k] - w).max()) for k, w in p_ref.items())
        r16 = pool.run(_tp_train_rank, "bfloat16", host(batch2), timeout=600)
        tp["tp2_bf16_loss"] = [r["loss"] for r in r16]
        tp["tp2_bf16_map_mae"] = [float(np.abs(r["pred"] - pred_b2_one_rank).mean()) for r in r16]
        tp["tp2_bf16_map_max"] = [float(np.abs(r["pred"] - pred_b2_one_rank).max()) for r in r16]
        want2 = _launches(K2=vit.num_layers, K7=vit.num_layers + 2 * n_dec, K8=n_dec, K9=n_dec)
        launches_ok = all(r["launches"] == want2 for r in r32 + r16)
        tp["tp2_launches_per_rank"] = r16[0]["launches"]
        tp["tp2_ms_per_rank"] = {"fp32_b1": [r["ms"] for r in r32], "bf16_b2": [r["ms"] for r in r16]}
        print(f"TP = 2 on 2 gloo ranks sharing the card: fp32 B=1 gathered gradients against the all-plain "
              f"step at the ranks' L1 subgradient and ReLU gates, worst leaf's relative L2 "
              f"{tp['tp2_fp32_grad_err']:.3e} (tol {PINNED_GRAD_TOL:.0e}); at the plain net's own gates "
              f"{tp['tp2_fp32_grad_err_own_gates']:.3e} (tol {TWO_RANK_GRAD_TOL:.0e}; gates that differ per "
              f"ReLU {tp['tp2_fp32_gate_flips']}, pixels whose L1 sign differs {tp['tp2_fp32_l1_sign_flips']}); "
              f"parameters after the step against AdamW on the same gradients, max |d| over every element "
              f"{tp['tp2_fp32_param_max_abs']:.3e} (tol {TP_PARAM_ATOL:.0e}); bf16 B=2 score maps per rank "
              f"against one rank's: MAE {tp['tp2_bf16_map_mae']} (tol {TP_MAP_TOL:.0e}), max |d| "
              f"{tp['tp2_bf16_map_max']}; loss per rank {tp['tp2_bf16_loss']} against "
              f"{tp['loss_b2_one_rank']:.6f} (tol {TP_MAP_TOL:.0e}); launches per rank "
              f"{tp['tp2_launches_per_rank']} (expected {want2}); ms/step per rank {tp['tp2_ms_per_rank']} "
              "(two ranks time-slicing one card, gloo through host memory: not a scaling number)")
        if not (tp["tp2_fp32_grad_err"] <= PINNED_GRAD_TOL and tp["tp2_fp32_grad_err_own_gates"] <= TWO_RANK_GRAD_TOL
                and tp["tp2_fp32_param_max_abs"] <= TP_PARAM_ATOL
                and all(e <= TP_MAP_TOL for e in tp["tp2_bf16_map_mae"])
                and all(abs(x - tp["loss_b2_one_rank"]) <= TP_MAP_TOL for x in tp["tp2_bf16_loss"])
                and launches_ok):
            bad.append("TP = 2 on two ranks")

        # (ii) view-parallel training: K=8 over the two ranks, the PE trainable
        rv = pool.run(_vp_train_rank, host(vp_batch), timeout=600)
        vp_cfg = CrossScoreConfig(compute_dtype=torch.float32, pe_trainable=True)
        per_rank = [two_rank_grads(vp_cfg, vp_batch, r) for r in rv]
        tp["vp_train_grad_err_per_rank"] = [r["pinned"] for r in per_rank]
        tp["vp_train_grad_err_own_gates_per_rank"] = [r["own_gates"] for r in per_rank]
        tp["vp_train_l1_sign_flips"] = [r["l1_sign_flips"] for r in per_rank]
        tp["vp_train_gate_flips"] = [r["gate_flips"] for r in per_rank]
        tp["vp_train_launches_per_rank"] = rv[0]["launches"]
        want_v = _launches(K1=vit.num_layers, K2=vit.num_layers, K3=n_dec, K4=n_dec, K7=n_dec, K9=n_dec)
        print(f"view-parallel training on 2 gloo ranks sharing the card, fp32 B=1, K={K}, PE trainable: every "
              f"trainable gradient ({len(rv[0]['grads'])} leaves) against the single-process all-plain net at "
              f"the rank's L1 subgradient and ReLU gates, worst leaf's relative L2 per rank "
              f"{tp['vp_train_grad_err_per_rank']} (tol {PINNED_GRAD_TOL:.0e}); at the plain net's own gates "
              f"{tp['vp_train_grad_err_own_gates_per_rank']} (tol {TWO_RANK_GRAD_TOL:.0e}; gates that differ per "
              f"ReLU {tp['vp_train_gate_flips']}, pixels whose L1 sign differs "
              f"{tp['vp_train_l1_sign_flips']}); launches per rank {tp['vp_train_launches_per_rank']} "
              f"(expected {want_v})")
        if not (all(r["pinned"] <= PINNED_GRAD_TOL and r["own_gates"] <= TWO_RANK_GRAD_TOL for r in per_rank)
                and all(r["launches"] == want_v for r in rv)):
            bad.append("view-parallel training on two ranks")
    tp["two_rank_phases_s"] = time.perf_counter() - t0
    if bad:
        _fail("; ".join(bad))
    del batch, batch1, batch2, vp_batch, p_ref, r32, r16, rv
    torch.cuda.empty_cache()

    # --- 13. the timing instruments through their entry points -------------------
    # K10 through its op (forward and backward at the predict point's 72 views),
    # then one short run of each tool; the counts zeroed just before each and
    # read just after
    from crossscore_tpu_torch.ops import flash_attention as fa
    from crossscore_tpu_torch.ops import lane_pad_probe as lpp
    from crossscore_tpu_torch.ops.fused_mlp import fused_res_ln_mlp
    from crossscore_tpu_torch.tools import attn_microbench, bwd_microbench, mlp_microbench
    from crossscore_tpu_torch.tools import lane_pad_probe as lane_pad_tool

    def modes():
        return {k: dict(w.launches_by_mode) for k, w in wrappers.items() if hasattr(w, "launches_by_mode")}

    inst = {}
    g10 = torch.Generator(device=dev).manual_seed(SEED + 3)
    x10, a10 = (torch.randn(views, n, d, generator=g10, device=dev).to(torch.bfloat16).requires_grad_()
                for _ in range(2))
    p10 = [torch.randn(d, generator=g10, device=dev) * 0.05 + 1, torch.ones(d, device=dev), torch.zeros(d, device=dev),
           torch.randn(f, d, generator=g10, device=dev) * d ** -0.5, torch.zeros(f, device=dev),
           torch.randn(d, f, generator=g10, device=dev) * f ** -0.5, torch.zeros(d, device=dev),
           torch.ones(d, device=dev)]
    zero_launches()
    out10 = fused_res_ln_mlp(x10, a10, *p10, vit.layer_norm_eps)
    out10.float().square().mean().backward()
    torch.cuda.synchronize()
    inst["K10 op"] = {"launches": read_launches()}
    want10 = _launches(K10=1)
    print(f"K10 op, forward and backward at x ({views}, {n}, {d}) bf16: launches {inst['K10 op']['launches']} "
          f"(expected {want10})")
    if inst["K10 op"]["launches"] != want10 or not bool(torch.isfinite(out10).all()) \
            or not all(bool(torch.isfinite(t.grad).all()) for t in (x10, a10)):
        _fail("K10 op: launches or a non-finite output / gradient")
    del x10, a10, p10, out10
    torch.cuda.empty_cache()
    tool_runs = {
        "attn_microbench backbone": (attn_microbench.main, [
            "--layers", "2", "qkv:688,2", "qkvc:688,2,2", "qkvc:688,2,3", "qkvp:688,2,nomax", "qkvp:688,2,nosum",
            "qkvp:688,2,mxu", "v2:688,1408,2", "v2mxu:688,1408,2", "v2noexp:688,1408,2", "v2bf16:688,1408,2"]),
        "attn_microbench decoder": (attn_microbench.main, [
            "--decoder", "--layers", "2", "v2:1369,1024,1", "v2mxu:1369,1024,1", "v2noexp:1369,1024,1",
            "v2bf16:1369,1024,1", "xln:1369,1024"]),
        "lane_pad_probe": (lane_pad_tool.main, ["--reps", "5", "--step-ms", f"{train_ms:.2f}"]),
        "bwd_microbench": (bwd_microbench.main, ["--reps", "5"]),
        "mlp_microbench": (mlp_microbench.main, ["--reps", "5"]),
    }
    for tag, (tool, argv) in tool_runs.items():
        zero_launches()
        t0 = time.perf_counter()
        rc = tool(argv)
        torch.cuda.synchronize()
        inst[tag] = {"rc": rc, "s": time.perf_counter() - t0, "launches": read_launches(), "by_mode": modes()}
        print(f"{tag} ({' '.join(argv)}): exit {rc} in {inst[tag]['s']:.1f} s; launches "
              f"{ {k: v for k, v in inst[tag]['launches'].items() if v} }; per mode {inst[tag]['by_mode']}")
        if rc != 0:
            _fail(f"{tag} exited {rc}")
    bb, dec, lp, _, _ = (inst[t]["by_mode"] for t in tool_runs)
    if not inst["bwd_microbench"]["launches"]["K4"]:
        _fail("bwd_microbench never launched K4")
    if not inst["mlp_microbench"]["launches"]["K2"]:
        _fail("mlp_microbench never launched K2")
    missing = [f"K11 {m}" for m in fa.QKV_PROBES if not bb["K11 probe"].get(m)] \
        + [f"K11 chunks{c}" for c in (2, 3) if not bb["K11 chunks"].get(f"chunks{c}")] \
        + [f"K7' {m}" for m in fa.HEAD_MAJOR_VARIANTS if not (bb["K7'"].get(m) and dec["K7'"].get(m))] \
        + [f"K12 {g}" for g in lpp.GEOMETRIES if not lp["K12"].get(g)]
    if missing:
        _fail("a timing mode was never launched by its entry point: " + ", ".join(missing))

    # --- 14. token-space training: the token step, the token graph at B=1, the
    # token_fast train CLI, encode_tokens and a run on the warm store -----------
    tok_work = tempfile.TemporaryDirectory()  # step 14's tree and token store, read again in step 17
    tok = _token_phases(torch, dev, params, vit, zero_launches, read_launches, Path(tok_work.name))

    # --- 15. the test CLI: four modes and a warm store, B=1 kernels against the
    # all-plain net, the GT summary -----------------------------------------------
    ev = _eval_phases(torch, dev, zero_launches, read_launches)
    torch.cuda.empty_cache()

    # --- 16. the serving daemon: the warm-cache step, the daemon in this
    # process, the CLI in a child process ----------------------------------------
    sv = _serve_phases(torch, dev, params, card, zero_launches, read_launches)
    torch.cuda.empty_cache()

    # --- 17. the native host input path: the decoder's build and decodes, the
    # predict, test and token_fast CLIs from files and record shards with the
    # decode skip, the two host benchmarks ----------------------------------------
    inp = _input_phases(torch, Path(tok_work.name), zero_launches, read_launches)
    torch.cuda.empty_cache()

    # --- 18. data parallelism: the train (pixel and token_fast), test and
    # predict CLIs on two gloo ranks that share the card, and the dry run ------
    dpr = _dp_phases(torch, zero_launches, read_launches, Path(tok_work.name), card)
    tok_work.cleanup()
    torch.cuda.empty_cache()

    # --- 19. the kernels line, then the device line ---------------------------
    sources = {"K1": ("flash_qkv_self_attention", "crossscore_tpu_torch/csrc/flash_qkv.cu",
                      "crossscore_tpu/ops/flash_attention.py:1347"),
               "K2": ("fused_ln_mlp", "crossscore_tpu_torch/csrc/fused_ln_mlp.cu",
                      "crossscore_tpu/ops/fused_mlp.py:64"),
               "K3": ("flash_cross_attention", "crossscore_tpu_torch/csrc/flash_cross.cu",
                      "crossscore_tpu/ops/flash_attention.py:799"),
               "K4": ("flash_cross_attention_bwd", "crossscore_tpu_torch/csrc/flash_cross_bwd.cu",
                      "crossscore_tpu/ops/flash_attention.py:949"),
               "K5": ("flash_qkv_self_attention_masked", "crossscore_tpu_torch/csrc/flash_qkv.cu",
                      "crossscore_tpu/ops/flash_attention.py:1227"),
               "K6": ("flash_cross_attention_masked", "crossscore_tpu_torch/csrc/flash_cross.cu",
                      "crossscore_tpu/ops/flash_attention.py:799"),
               "K7": ("flash_attention_head_major", "crossscore_tpu_torch/csrc/flash_cross.cu",
                      "crossscore_tpu/ops/flash_attention.py:69"),
               "K8": ("flash_attention_head_major_bwd, Nk <= 2048", "crossscore_tpu_torch/csrc/flash_cross_bwd.cu",
                      "crossscore_tpu/ops/flash_attention.py:441"),
               "K9": ("flash_attention_head_major_bwd, Nk > 2048", "crossscore_tpu_torch/csrc/flash_cross_bwd.cu",
                      "crossscore_tpu/ops/flash_attention.py:571")}
    shapes = {"K1": f"qkv ({views}, {n}, {3 * d}) bf16",
              "K2": f"x ({views}, {n}, {d}) bf16, F={f}",
              "K3": f"q ({B}, {nq}, {d}), k/v ({B}, {K * nq}, {d}) bf16, hd {d // dec_h}",
              "K4": f"q/o/do ({TB}, {nq}, {d}), k/v ({TB}, {TK * nq}, {d}) bf16, hd {d // dec_h}",
              "K5": f"qkv ({PB}, {BUCKET_GRID[0] * BUCKET_GRID[1] + 1}, {3 * d}) bf16, per-item bias",
              "K6": f"q ({PB}, {BUCKET_GRID[0] * BUCKET_GRID[1]}, {d}), k/v ({PB}, "
                    f"{PK * BUCKET_GRID[0] * BUCKET_GRID[1]}, {d}) bf16, hd {d // dec_h}, per-item bias",
              "K7": f"q ({B}, {dec_h}, {nq}, {d // dec_h}), k/v ({B}, {dec_h}, {VP_NK[0]}, {d // dec_h}) bf16 "
                    "head-major views, no bias",
              "K7 backbone": f"q/k/v ({TB * (TK + 1)}, {h}, {n}, {hd}) bf16 head-major views, no bias",
              **{kern: "q/o/do ({0}, {1}, {2}, {4}), k/v ({0}, {1}, {3}, {4}) bf16 head-major views".format(
                  *K89_SHAPES[kern][:5]) for kern in ("K8", "K9")}}
    stats = ("err", "tol", "l2", "tol_l2", "max_abs", "ms", "plain_ms", "library_ms", "bound_ms", "bound_floor",
             "k1_ms", "k3_ms", "k4_ms", "unfused_ms")
    kernels = []
    for kern, (fn, src, replaces) in sources.items():
        r, r32 = report[(kern, "bfloat16")], report[(kern, "float32")]
        # the main path of K1-K4 is the train step; of K5 and K6, the bucketed
        # predict CLI run (c); of K7, rank 0 of the uncached view-parallel CLI;
        # of K8 and K9, the tp route's train step
        main_launches = (cli["c"]["launches"][kern] if kern in ("K5", "K6")
                         else vp["cli"]["off"]["launches_per_rank"][kern] if kern == "K7"
                         else tp_launches[kern] if kern in ("K8", "K9")
                         else train_launches[kern])
        row = {"name": fn, "route": "cuda", "source": src, "replaces": replaces,
               "launches": main_launches, "max_abs_err": r["max_abs"], "ms": r["ms"],
               "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
               "library_ms": r["library_ms"], "rel_err": r["err"], "tol": r["tol"],
               "err_kind": "relative L2 of dq, dk, dv" if kern in ("K4", "K8", "K9")
               else "max |d| / (1 + |plain|)" if kern == "K2"
               else "max |d| / (1 + |plain|); l2: relative L2 of o, l, m",
               "launches_by_path": {"predict": launches[kern], "bucketed_predict": cli["c"]["launches"][kern],
                                    "train_step": train_launches[kern],
                                    "token_train_step": tok["launches"][kern],
                                    "view_parallel_predict_rank0": vp["cli"]["off"]["launches_per_rank"][kern],
                                    "tp_train_step": tp_launches[kern],
                                    "eval_cli": {tag: r["launches"][kern] for tag, r in ev["modes"].items()},
                                    "serve_dispatch": sv["load"][8]["launches_per_dispatch"].get(kern, 0),
                                    "host_input_predict": {tag: r["launches"][kern]
                                                           for tag, r in inp["predict"].items()},
                                    "host_input_token_fast": {src: r["launches"][kern]
                                                              for src, r in inp["token_fast"].items()
                                                              if isinstance(r, dict)},
                                    # step 18, per rank of the two (rank 0's; both read the same)
                                    "data_parallel_rank0": {
                                        "train_cli_4_steps_4_val": dpr["train"]["launches_per_rank"][0][kern],
                                        "token_fast_2_steps": dpr["token_fast"]["launches_per_rank"][0][kern],
                                        "test_cli": {tag: dpr["test"][tag]["launches_per_rank"][0][kern]
                                                     for tag in ("a", "c")},
                                        "predict_cli": {tag: dpr["predict"][tag]["launches_per_rank"][0].get(kern, 0)
                                                        for tag in ("b", "d")}}},
               "fp32": {k: r32[k] for k in stats if k in r32}, "shape": shapes[kern]}
        # K5-K7: the relative L2 of o, l, m; K5: K1's time on the same qkv;
        # K7: K3's on the same work, and both at the 1-rank length; K8/K9:
        # K4's on the same work
        row.update({k: r[k] for k in ("l2", "tol_l2", "k1_ms", "k3_ms", "ms_nk10952", "k3_ms_nk10952",
                                      "bound_ms_nk10952", "k4_ms", "bound_floor", "products_ms", "exp_ms",
                                      "unfused_ms")
                    if k in r})
        if kern == "K2":  # the bf16 body's plan at D 384 (step 2)
            row["plan"] = mlp_plan
        if kern in ("K3", "K4", "K6"):
            s, s32 = report[(f"{kern}self", "bfloat16")], report[(f"{kern}self", "float32")]
            row["self"] = {k: s[k] for k in stats if k in s}
            row["self_fp32"] = {k: s32[k] for k in stats if k in s32}
        if kern == "K7":  # the tp train step's backbone shape, 12 of its 16 launches
            s, s32 = report[("K7 backbone", "bfloat16")], report[("K7 backbone", "float32")]
            row["backbone"] = {k: s[k] for k in stats if k in s} | {"shape": shapes["K7 backbone"]}
            row["backbone_fp32"] = {k: s32[k] for k in stats if k in s32}
        kernels.append(row)
    # K10-K12: their launches from step 13's runs of their entry points (K10:
    # its op; K11: the microbenchmark at the backbone shape; K7': at the
    # decoder shape, the MXU probe's home, the backbone run's beside it; K12:
    # its tool)
    fa_src, qkv_src = "crossscore_tpu_torch/csrc/flash_cross.cu", "crossscore_tpu_torch/csrc/flash_qkv.cu"
    flash_py = "crossscore_tpu/ops/flash_attention.py"
    new_rows = {"K10": ("fused_res_ln_mlp", "crossscore_tpu_torch/csrc/fused_ln_mlp.cu",
                        "crossscore_tpu/ops/fused_mlp.py:72", inst["K10 op"]["launches"]["K10"], instruments["K10"])}
    for m in fa.QKV_PROBES:
        new_rows[f"K11 {m}"] = (f"flash_qkv_self_attention_probe, probe {m}", qkv_src, f"{flash_py}:1255",
                                bb["K11 probe"][m], instruments["K11"])
    for c in (2, 3):
        new_rows[f"K11 chunks{c}"] = (f"flash_qkv_self_attention_chunked, chunks {c}", qkv_src, f"{flash_py}:1295",
                                      bb["K11 chunks"][f"chunks{c}"], instruments["K11"])
    for m, line in (("mxuprobe", 157), ("noexp", 231), ("bf16exp", 231)):
        new_rows[f"K7' {m}"] = (f"flash_attention_head_major_variant, {m}", fa_src, f"{flash_py}:{line}",
                                dec["K7'"][m], instruments["K7'"])
    for g in lpp.GEOMETRIES:
        new_rows[f"K12 {g}"] = (f"lane_pad_probe, {g}", "crossscore_tpu_torch/csrc/lane_pad_probe.cu",
                                "tools/lane_pad_probe.py:73", lp["K12"][g], instruments["K12"])
    for kern, (fn, src, replaces, main_launches, shape) in new_rows.items():
        r = report[(kern, "bfloat16")]
        row = {"name": fn, "route": "cuda", "source": src, "replaces": replaces, "launches": main_launches,
               "max_abs_err": r["max_abs"], "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
               "bound_by": r["bound_by"], "library_ms": r["library_ms"], "rel_err": r["err"], "tol": r["tol"],
               "err_kind": "relative L2 of o, l, m" if kern.startswith(("K11 n", "K11 m", "K7'"))
               else "relative L2 of dq, dk, dv on the written lanes" if kern.startswith("K12")
               else "max |d| / (1 + |plain|)", "shape": shape}
        row.update({k: r[k] for k in ("l2", "tol_l2", "k1_ms", "k7_ms", "k2res_ms", "bound_floor", "products_ms",
                                      "exp_ms") if k in r})
        if kern == "K10":
            row["fp32"] = {k: v for k, v in report[("K10", "float32")].items()}
        if kern.startswith("K7'"):
            row["backbone"] = {k: v for k, v in report[(f"{kern} backbone", "bfloat16")].items()} \
                | {"launches": bb["K7'"][kern.split()[1]]}
        kernels.append(row)
    seconds = time.perf_counter() - t_start
    print(f"chip_smoke: every phase passed in {seconds:.1f} s")
    # (a) is the reference of the agreement check: it has no reading of its own
    print(json.dumps({"kernels": kernels, "card": card, "maps_per_s": 1e3 * B / step_ms,
                      "step_ms": step_ms, "train_step_ms": train_ms, "train_peak_gib": train_peak,
                      "token_train": tok,
                      "predict_cli": {tag: {k: v for k, v in r.items() if k not in ("maps", "launches")}
                                      | ({"mae_vs_a": agree[tag][0], "max_vs_a": agree[tag][1]}
                                         if tag in agree else {})
                                      | {"device_step_ms": device_ms[tag]}
                                      for tag, r in cli.items()},
                      "predict_loader_maps_per_s": loader_rate, "view_parallel": vp,
                      "tensor_parallel": tp, "instruments": inst,
                      "serving": sv, "host_input": inp,
                      "data_parallel": dpr,
                      "eval_cli": ev | {"modes": {tag: {k: ({n: c for n, c in v.items() if c} if k == "launches" else v)
                                                        for k, v in r.items()} for tag, r in ev["modes"].items()}},
                      "seconds": seconds}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
