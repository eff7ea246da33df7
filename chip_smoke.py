#!/usr/bin/env python3
"""Drive the PyTorch/H100 port on one CUDA card: the predict forward, the train step,
the predict CLI, view-parallel predict, tensor- and view-parallel training,
token-space training, the test CLI, the scoring daemon, the native host
input path, the data-parallel CLIs, the ViT-L stress path, the
training-quality workflow and the int8 backbone, alone and under tensor
parallelism.

    python3 chip_smoke.py                  # from the repository root, one card
    python3 chip_smoke.py --kernels-only   # steps 1-3 only, no result lines
    python3 chip_smoke.py --against DIR    # also step 4's fp32 A/B against another checkout

In order:
1. print the card's name and power limit (``nvidia-smi``);
2. build the kernels from ``crossscore_tpu_torch/csrc/`` (one ``nvcc`` per
   source, all at once) and print the build time, each kernel's registers
   and spills, and for the bf16 wgmma kernels (the forward's, the
   backward's, the fused MLP's) their static shared memory, any wgmma ptxas
   serialised (C7515 and the other notes that say so), each head dim's tile
   plan and the fused MLP's plans at D 64, 384, 768 and 1024 (rows a block
   or tile, the cluster, the hidden chunk, the ring stages, dynamic shared
   memory, W1/W2 bytes read from L2 per 1000 rows and at the main point),
   and for the fp32 forward (the 3xTF32 body and its pre-pass) its ptxas
   lines, each head dim's plan and the HGMMA instructions that
   ``cuobjdump -sass`` finds in each instantiation of the body;
   fail on a serialised wgmma in the fp32 body at any head dim, a body with
   no HGMMA, a spill or a serialised wgmma in the forward at hd 48 or 64 or in
   the fused MLP, on a plan above the block's shared memory, or on MLP weight
   reads above half of what 64-row blocks that each read them would take (D
   768 and 1024: above once per 64-row tile);
3. hold K1 (backbone self-attention), K2 (fused LN->MLP) and K3 (decoder
   attention) against their plain PyTorch versions at the predict shapes
   (dinov2-small, 518 px, K=8 references, B=8; K2 also timed beside the
   unfused chain of PyTorch calls, a yardstick), K2 (tanh and exact) and
   K10 on the bf16 body at D 64 and 384 over 1, 63, 65, 127, 129, 255, 257
   and 2741 rows, each launched twice for the same bits (K2 and K10 at D 768
   and 1024 too, 2 x 300 rows, bf16 and fp32), K4 (decoder attention
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
   launched twice for the same bits; every forward at the main shapes is
   launched twice for the same bits too, and in fp32 K1's pre-pass is held
   bit for bit against its plain version, at every head dim on head-major
   views too, and K1's body run on stages whose K and V lo halves this
   script zeroes must miss TOL_L2), and time
   the kernel, the plain version
   and, for the attention kernels, one ``F.scaled_dot_product_attention``
   call (K4, K8, K9: one backward of it; K5/K6: with the bias as a float
   mask) on the same inputs (a yardstick only; the port never calls it;
   in fp32 the kernels it ran, by profiler name), beside the bound (fp32
   forwards: three TF32 products at the tensor cores' TF32 rate, with the
   CUDA cores' floor beside it), and
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
   kernels, and time it with CUDA events; the same at the parity preset
   (``model.gpu.parity=true``: fp32 compute, the exact GELU), K1 and K3 on
   the fp32 forward; with ``--against DIR``, that checkout's fp32 forward
   (its ``flash_qkv.cu``, ``flash_cross.cu`` and launchers) in turns with
   this tree's (other / this / this / other): K1, K5, K3, K6, K7 and K7 at
   the tp backbone shape at step 3's shapes beside SDPA, and the parity
   predict step;
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
    ``bwd_microbench``, K2 by ``mlp_microbench``, every run exit 0; (b)
    the profiling tools and the build-flag sweep the same way:
    ``tools.model_breakdown full backbone decoder``, ``tools.train_microbench
    24 5``, ``tools.train_trace`` on the pixel and the token step (K1 12, K2
    12, K3 4, K4 4 and K3 4, K4 4 a step, over its warm-up and traced
    steps), ``tools.trace_breakdown`` with no argument and on the pixel
    trace (a K4 family in it), ``tools.trace_events`` on that trace with a
    family filter (each K4 kernel linked to ``_FlashCrossAttentionBackward``
    and its recorded input shapes), ``tools.h2d_probe`` and ``tools.xla_flag_sweep baseline
    ptxas_o2`` (both sets' lines, each timed or rejected); then the
    converter (``io/convert.py``) at dinov2-small width: ``--reverse`` of a
    port checkpoint, the default mode on the file it wrote, ``--hf-backbone``
    on a ``config.json`` + ``pytorch_model.bin`` directory, and the converted
    directory restored through ``tasks/common.py`` into a net whose B=1 maps
    are the source net's bits;
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
    of up to 8, one CUDA graph per bucket): its startup and launches (an
    eager run and a capture per bucket), ``/healthz``, one ``map=npy`` map
    against the predict CLI's on the same query and references, the load
    bench at 1, 4 and 8 workers x 16 requests (req/s, p50/p95/p99, the
    dispatches, and no counted launch: every dispatch a replay), a reload to
    seed 1's weights in the middle of a storm, and the typed 503s of a full
    queue; (c) the CLI in a child process: SIGTERM in the middle of a storm
    with a request in flight (every accepted request 200, the later ones a
    typed 503, ``/livez`` 200 and ``/healthz`` 503 during the drain, exit
    0), then a warm-up-only run on the token store the first run filled;
    (d) the daemon's graphs and artifacts: at buckets 1/2/4/8 the replayed
    graph bit-equal to the eager forward, with K1 12, K2 12 and K3 4 kernels
    by name in one replay (``torch.profiler``) and no other attention or MLP
    kernel; the warm-cache step at B=8 and B=1 and the B=1 dispatch by
    replay and eagerly, in turns (device ms, the host's enqueue ms, maps/s);
    after (b)'s reload mid-storm, the replay bit-equal to a fresh net on
    seed 1's weights; a planted fault, the bicubic constant a graph keeps
    halved in place, caught by the clearing's check and the replay
    bit-equal again once it is restored; the exporter (``serve_warmup_only``,
    ``serve_aot_save``) and a loader (``serve_aot_load``, an empty
    ``$CROSSSCORE_COMPILE_CACHE``) in child processes: no ``nvcc``, the
    libraries byte-equal, (b)'s map bit for bit, ``aot_shapes`` 4; three bad
    artifacts refused by field; two replicas on the one card and the int8
    backbone's graph bit-equal to eager (its Q1 and Q2 counted where a
    capture passes the wrappers; the profiler loses some of their records);
17. the native host input path (``data/fastimage.py``, ``data/records.py``,
    the decode skip): (a) build ``csrc/fastimage.cpp`` with g++ (its
    version, whether ``png.h`` is found, the seconds) and decode a seeded
    540x960 PNG natively against the Pillow path: float32 resized to a short
    side of 518 and trimmed to whole patches, the uint8 wire cropped and
    resized, and a ``CSRT`` payload of it (the cropped wire and every
    ``CSRT`` decode bit-equal; a missing ``png.h`` is printed and the rest
    runs on Pillow, any other build error fails); (b) the predict CLI on
    two batches of step 9's renders and its pool (B=8, K=5, unbucketed), uncached and cached,
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
    ``tools.ingest_bench`` (4 epochs) and ``tools.token_assembly_bench`` (10
    batches; the loader's retained malloc arena, and glibc's defaults),
    beside the host's CPU count;
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
    blocks; (d) the predict CLI, modes (b) and (d), on two batches of step
    9's renders, data parallel against one rank: the same file names, maps
    within MAE 1e-2, maps/s per rank;
    (e) ``tools.dryrun_multichip 4`` through its entry point: exit 0;
19. the ViT-L stress path (BASELINE config #5: dinov2-large at 1036 px, a
    74x74 patch grid): (a) K2 (tanh and exact) and K10 on the wide bf16 body
    at D 1024 (32,862 rows, F 4096: B=1, K=5) and D 768 (dinov2-base's
    predict point, 98,640 rows, F 3072) and at 1, 63 and 300 rows against
    their plain versions, each launched twice for the same bits, timed beside
    the plain version, the unfused chain of PyTorch calls and the bound, and
    K1 on a fused qkv of more than 2^31 elements (B=8,
    K=16: the last views bit-equal to the same views alone; bf16 and fp32); (b) from the
    port's seeded init, the forward at K=5
    (B 1, 2, 4) and K=16 (B 1) and the pixel and token train steps at K=5,
    B=1: launches (K1 24, K2 24, K3 4 a forward; K3 4 and K4 4 a step),
    ms, maps/s, MFU, peak memory, the device-time breakdown (``torch.profiler``)
    of the K=5, B=1 forward and of both steps, the decoder and head updated
    and the backbone and PE bit-identical; (c) B=1 against the all-plain net,
    dinov2-large at 1036 px (K=2) and dinov2-base at 518 px (K=8, K2 at D
    768); (d) ``tools.stress_vitl``, ``tools.probe_vitl_token_bwd`` and
    ``tools.batch_sweep`` through their entry points at small arguments,
    each exit 0 with its JSON line;
20. the training-quality workflow: (a) K3, K6, K7, K4 and K8/K9 at hd 8
    (the dinov2-test decoder's; the wrappers zero-pad it to the hd 16 bodies
    at the scale 1/sqrt(8)) against their plain versions at hd 8, bf16 and
    fp32, at B 4, 36 queries over 72 keys and at 1369 over 6845, each
    launched twice for the same bits and timed beside the plain version,
    SDPA and the bound; then the route given a launcher that passes the
    padded width's scale, which K3's check must catch; (b) the train CLI at the tiny geometry (dinov2-test,
    fp32, B=4, K=2, crop 84) for 3 steps and a validation batch, the
    backbone from a seeded HuggingFace-keyed file (``init_path``) and the
    histograms every step: K3 4 and K4 4 a step, a finite loss, the
    backbone after the run the file's bit for bit, the histogram rows
    summing to the batch's pixels, and a run with figures on stopped at
    startup with matplotlib missing; (c) ``tools.overfit_convergence``
    (80 steps, its correlation past 0.5, ms/step),
    ``tools.ab_token_vs_pixel --preset gpu-medium`` (both arms, 2 steps,
    then one validation batch), ``tools.multimethod_eval --train-steps 4 --ks
    8``, ``tools.k_sweep`` on its corpus and checkpoint and
    ``tools.bench_stress_attention`` (K7 and K3 at B 2, 16 heads, hd 64,
    5476 queries over 87,616 keys beside SDPA and the bound, o within
    relative L2 8e-3 of SDPA's, and K7's o scaled by 0.85 caught), each
    through its entry point, exit 0 with its output lines, the launches
    of the A/B arms' and ``multimethod_eval``'s CLI child processes
    counted through ``chip_smoke.py --count-launches``;
21. the int8 W8A8 backbone (``model.gpu.backbone_quant=int8``): (a) Q1 (row
    quantise) and Q2 (the int8 linear) against their plain versions at the
    predict point's four products (98,640 rows: fc1, fc2, qkv, out), the
    weights' shapes and 1, 17, 63, 129 and 2741 rows at K 64-4096 (Q2 also
    at the rows of one tile more than the card has SMs, a ragged last wave
    of its persistent grid), bf16 and fp32: Q1's codes and scales bit-equal,
    Q2 within one ulp (its elements that are not bit-equal counted), each
    launched twice for the same bits (Q2's int32 form: step 22 (a)); a
    scale of 1/126 planted in Q1 caught; each timed beside its plain
    version, ``torch._int_mm`` and a PyTorch dequantisation, bf16
    ``F.linear`` and the bound; (b) the int8 predict step at the headline point (dinov2-small,
    518 px, K=8, B=8, bf16, ``mlp_impl=fused`` requested): launches (K1 12,
    K2 0, K3 4, Q1 96, Q2 48), the score map within JAX's int8 tier of the
    unquantised step (MAE 5e-3, max 5e-2), maps/s of both in this call and
    the backbone's device time split into Q1, Q2, K1 and the rest, and the
    int8 pixel train step at B=24, K=5 beside the unquantised one (launches
    K1 12, K3 4, K4 4, Q1 96, Q2 48; the loss finite, the backbone frozen);
    (c) the predict CLI, mode (c), with and without int8: K5, K6, Q1 and Q2
    launched and K2 not, the maps within the int8 tier; (d)
    ``tools.matmul_microbench`` through its entry point; (e) dinov2-large at
    1036 px, K=5, B=1: an int8 forward beside the bf16 one;
22. the int8 backbone under tensor parallelism (``attention_impl="tp"``
    with ``backbone_quant="int8"``): (a) the row layer's split forms, Q1a
    (row absmax), Q1b (codes from a given absmax) and Q2's int32 form,
    against their plain versions at the predict point's four products and
    at 1-2741 rows (Q2's int32 form also at step 21's ragged-wave rows),
    bf16 and fp32, each bit-equal and launched twice for the same bits, Q1a
    then Q1b bit-equal to Q1 and the PyTorch dequantisation of the int32
    products to Q2's epilogue, each timed beside Q1 / Q2, its plain version,
    ``torch._int_mm`` (Q2's int32 form), bf16 ``F.linear`` and the bound;
    (b) TP = 1 on one NCCL rank at the headline point (dinov2-small, 518
    px, K=8, B=8, bf16): the int8 tp forward with
    the MLP split (``unfused``) and whole (``fused`` requested) against the
    int8 ``flash`` forward (score-map MAE 5e-3) with its launches, every
    row-parallel product bit-equal to the one-rank int8 linear on the same
    operands, and the int8 tp train step at B=24, K=5 (launches, a finite
    loss, the backbone and PE bit-identical, the decoder updated) timed in
    turns beside the int8 ``flash`` step; (c) TP = 2 on two gloo ranks
    sharing the card: the fp32 B=1 forward against the one-rank int8 net on
    the same kernels (MAE 1e-4), and against the one-rank all-plain int8 net
    beside the one-rank kernel net's own distance to it (within JAX's int8
    tier, 5e-3: the fp32 summation order of the kernels and the plain
    versions flips codes at rounding boundaries, which the 12 quantised
    blocks carry to the map), each rank's bf16 B=2 train step against one rank's
    (maps and loss within 5e-3), block 0's out and fc2 products bit-equal to
    the one-rank product on the gathered operands, and the planted fault
    (their MAX all-reduce left out) caught; (d) K11 (probes and chunks) at
    qkv (8, 1370, 3 x 8 x 128) and K7' at the ViT-L decoder's cross shape (B
    1, 8 heads, 5476 queries over 27,380 keys) at hd 128, held as step 3
    holds them at hd 48/64, launched twice for the same bits, timed beside
    K1 / K7 at hd 128 and the bound;
23. print one ``{"kernels": [...]}`` line, then, last, the device line.

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
# step 16 (d)'s query widths off the DINOv2 table's native 37x37 grid: a warm
# shape (the daemon's documented example) and one first seen mid-storm
WARM_W, NEW_W = 686, 602
PREDICT_ROWS = B * (1 + K) * ((HW // 14) ** 2 + 1)  # the backbone MLP's rows there: 98,640
TB, TK = 24, 5  # train operating point (config/data/combined_training.yaml): 144 views
# the ViT-L stress path (BASELINE config #5, tools/stress_vitl.py): dinov2-large
# at 1036 px, twice the 518 px training crop: a 74x74 patch grid, 5477 tokens
# a view; K=5 (and K=16) references
VITL_HW, VITL_K = 1036, 5
VITL_ROWS = (1 + VITL_K) * ((VITL_HW // 14) ** 2 + 1)  # K2's rows at B=1, K=5: 32,862
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
# the tensor cores' dense TF32 rate, half the bf16 one (NVIDIA's data
# sheets): the fp32 attention forward runs three TF32 products a product
# (3xTF32), so its floor is 3 x its operations at this rate, below the CUDA
# cores' floor at the fp32 rate above
TF32_PEAKS = {"H100 PCIe": 378e12, "H100 NVL": 417.5e12, "H100": 495e12}

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
# the train CLI's figures need matplotlib too: every train CLI run turns them
# off (tasks/train.py stops a run that would draw one without it)
FIGURES_OFF = ["logger.vis_imgs_every_n_train_steps=100000", "logger.cache_size.validation.n_fig=0"]

# step 21: the predict point's backbone products (K, N) over its 98,640
# rows, and the ragged rows and widths Q1 and Q2 are held at besides; Q2
# also at the rows of one 128-row tile more than the card has SMs (and 77
# rows of it), whose tiles leave its persistent grid a ragged last wave
INT8_PRODUCTS = {"fc1": (384, 1536), "fc2": (1536, 384), "qkv": (384, 1152), "out": (384, 384)}
INT8_ROWS = (1, 17, 63, 129, 2741)
# (K, N): dinov2-test's qkv, out's row shards under tp at TP 4 and 2 (one and
# two of Q2's resident K chunks), dinov2-base's qkv, -large's fc1 and fc2
INT8_WIDTHS = ((64, 192), (96, 384), (192, 384), (768, 2304), (1024, 4096), (4096, 1024))
# JAX's int8 tier (tests/test_quant.py:80-92): score maps (in [0, 1]) of
# the int8 net against the same net unquantised, MAE and max
INT8_TIER = (5e-3, 5e-2)
# step 22 (d): the timing modes at hd 128, the ViT-L decoder's head dim. K7'
# at its cross-attention at 1036 px, K=5 (B 1, 8 heads, 5476 queries over
# 27,380 keys); K11 at a qkv of 8 views of 1370 tokens, 8 heads of hd 128
HD128_K7 = (1, 8, 5476, 5 * 5476, 128)
HD128_QKV = (8, 1370, 8, 128)


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


def _tf32_peak(name: str) -> float:
    return next((p for frag, p in TF32_PEAKS.items() if frag in name), TF32_PEAKS["H100"])


def _fwd_bound(dtype_name: str, ops: float, nbytes: float, exps: float, peaks, peak_tf32: float) -> dict:
    """The attention forward's bound (``_bound``): bf16 on its tensor-core
    rate; fp32 as the 3xTF32 body runs it, three TF32 products a product, with
    the CUDA cores' floor (one fp32 product at the fp32 rate) beside it as
    ``cuda_core_bound_ms``."""
    peak_bf16, peak_f32, peak_bw, peak_ex2 = peaks
    if dtype_name == "bfloat16":
        return _bound(ops, nbytes, peak_bf16, peak_bw, exps, peak_ex2)
    return dict(_bound(3.0 * ops, nbytes, peak_tf32, peak_bw, exps, peak_ex2),
                cuda_core_bound_ms=_bound(ops, nbytes, peak_f32, peak_bw, exps, peak_ex2)["bound_ms"])


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


# kernels of a library's attention, and of the unfused MLP (its GELU), which
# a replay of the daemon's graphs must not hold (step 16 (d); the int8
# backbone runs its MLP unfused by design, with Q2 in place of K2)
FOREIGN_ATTENTION = re.compile(r"fmha|flash_fwd|flash_bwd|efficient_attention|mem_eff|softmax", re.I)
FOREIGN_MLP = re.compile(r"gelu", re.I)
REPLAY_GROUPS = {"K1 backbone attention": "K1", "K2 fused LN-MLP": "K2", "K3 decoder attention": "K3",
                 "K10 fused residual LN-MLP": "K10", "Q1 int8 row quantise": "Q1", "Q2 int8 linear": "Q2"}


def _replay_kernels(torch, fn, foreign, want: dict, attempts: int = 16) -> tuple[dict, list, int]:
    """The kernels one call of ``fn`` runs on the card, by ``torch.profiler``
    name: ({K1, K2, K3, K10, Q1, Q2: the most records of the group in any
    one profiled call}, [the names that match any of the patterns
    ``foreign`` in any call], the calls profiled: until those counts are
    ``want``'s or ``attempts`` are spent). A trace with no kernel is a lost
    trace. The profiler loses kernel records of graph replays whose outputs
    are whole: 1-3 of the int8 graph's 12 K1, 96 Q1 and 48 Q2 kernels on some
    hosts (once no record at all), and once one of the 518x686 bf16 graph's
    12 K1 kernels, the same records in every profiled replay of a run (with
    the replay bit-equal to the eager forward, whose counted launches were
    whole). A record can be lost but never made up, so a group's most in one
    call is never above what a replay runs; the exact counts are the graph's
    own nodes (``_graph_kernels``)."""
    from torch.profiler import ProfilerActivity, profile

    from crossscore_tpu_torch.tools.trace_breakdown import counts_as_launch, kernel_group

    most, found, tries, traced = {v: 0 for v in REPLAY_GROUPS.values()}, [], 0, False
    for tries in range(1, attempts + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        seen, kernels = {v: 0 for v in REPLAY_GROUPS.values()}, 0
        for evt in prof.key_averages():
            if "CUDA" not in str(evt.device_type):
                continue
            kernels += evt.count
            kern = REPLAY_GROUPS.get(kernel_group(evt.key))
            if kern is not None and not counts_as_launch(evt.key):  # the fp32 pre-pass: its body's launch
                continue
            if kern is not None:
                seen[kern] += evt.count
            elif any(pat.search(evt.key) for pat in foreign) and evt.key[:100] not in found:
                found.append(evt.key[:100])
        if not kernels:
            continue
        traced = True
        most = {k: max(v, seen[k]) for k, v in most.items()}
        if {k: v for k, v in most.items() if v} == want:
            break
    if not traced:
        _fail(f"the profiler recorded no kernel of a graph replay in {attempts} calls")
    return most, found, tries


def _graph_kernels(graph, foreign, path: Path) -> tuple[dict, list, int]:
    """The kernel nodes of a captured ``torch.cuda.CUDAGraph``, from the
    graph itself (``cudaGraphDebugDotPrint`` of the graph that
    ``keep_graph`` keeps: ``_serve_phases`` makes the daemon's graphs so):
    ({K1, K2, K3, K10, Q1, Q2: count}, [the names that match any of
    the patterns ``foreign``], the kernel nodes). Unlike the profiler, which
    loses records of replays (``_replay_kernels``), this reads every node.
    The dump is written to ``path``."""
    from crossscore_tpu_torch.tools.trace_breakdown import counts_as_launch, kernel_group

    path.unlink(missing_ok=True)
    graph.debug_dump(str(path))
    text = path.read_text(errors="replace") if path.exists() else ""
    # a kernel node's label names its function before its launch shape, <<<grid>>>
    names = re.findall(r"([A-Za-z_$][\w$]*)(?:\\?<|&lt;){3}", text)
    if not names:
        _fail(f"step 16 (d): the graph's dump {path} names no kernel node: {text[:400]!r}")
    seen = {v: 0 for v in REPLAY_GROUPS.values()}
    found = []
    for name in names:
        kern = REPLAY_GROUPS.get(kernel_group(name))
        if kern is not None and not counts_as_launch(name):  # the fp32 pre-pass: its body's launch
            continue
        if kern is not None:
            seen[kern] += 1
        elif any(pat.search(name) for pat in foreign) and name[:100] not in found:
            found.append(name[:100])
    return {k: v for k, v in seen.items() if v}, found, len(names)


def _rewrite_artifact(src: Path, dst: Path, edit) -> Path:
    """A copy of the artifact ``src`` at ``dst`` with ``edit`` applied to its
    decoded header."""
    import zipfile

    with zipfile.ZipFile(src) as zf:
        members = {n: zf.read(n) for n in zf.namelist()}
    header = json.loads(members["header.json"])
    edit(header)
    members["header.json"] = json.dumps(header).encode()
    with zipfile.ZipFile(dst, "w") as zf:
        for n, data in members.items():
            zf.writestr(n, data)
    return dst


def _graph_phases(torch, dev, card: str, scorer, base: list, tmp: Path, qpath: Path, map0, ckpt: dict,
                  zero_launches, read_launches) -> dict:
    """Step 16 (d), the daemon's CUDA graphs and its artifacts, on (b)'s
    daemon (``scorer``, on seed 1's weights after (b)'s storm): replay
    against eager at every bucket, with the kernels of one replay by name;
    a warm shape off the position table's grid (its graph holding its resize
    constants through a clearing of their table, and a kept constant
    overwritten in place caught by the same check) and a shape first captured
    while a load-bench storm is served; the warm-cache step and the B=1 dispatch by replay and eagerly, in
    turns; the reload's bits; the exporter and a loader in child processes;
    three bad artifacts; two replicas on the one card; the int8 backbone's
    graph. Returns the readings."""
    import os
    import signal
    import subprocess
    import threading

    import numpy as np

    from crossscore_tpu_torch.client import ScoreClient
    from crossscore_tpu_torch.data.token_cache import RefTokenCache
    from crossscore_tpu_torch.io import aot
    from crossscore_tpu_torch.io.images import image_read
    from crossscore_tpu_torch.models import CrossScoreConfig, CrossScoreNet
    from crossscore_tpu_torch.ops import _build, interpolate
    from crossscore_tpu_torch.tasks.common import load_model_params, parse_cli
    from crossscore_tpu_torch.tasks.serve import Scorer, _Graph, make_server
    from crossscore_tpu_torch.tools.serve_load_bench import run as load_bench
    from crossscore_tpu_torch.utils import compilation_cache

    t_step = time.perf_counter()
    gd: dict = {"card": card, "memory": scorer.graph_memory}
    bad = []
    rng = np.random.default_rng(SEED + 161)
    q_real = scorer._preprocess(image_read(str(qpath)))
    batch = np.stack([q_real] + [rng.standard_normal(q_real.shape).astype(np.float32) for _ in range(7)])

    def graph_of(sc, key):
        execs = sc._executables[key]
        if not all(isinstance(x, _Graph) for x in execs):
            _fail(f"step 16 (d): the daemon's executables at {key} are not CUDA graphs: {execs}")
        return execs

    def replay_vs_eager(sc, b: int, tag: str, hold_names: bool = True, data=batch) -> dict:
        (g,) = graph_of(sc, (*data.shape[1:3], b))
        q = torch.from_numpy(data[:b])
        zero_launches()
        maps_r, means_r = (t.clone() for t in g(q))
        torch.cuda.synchronize()
        counted = {k: v for k, v in read_launches().items() if v}
        zero_launches()
        maps_e, means_e = sc._forward(sc.model, q.to(dev), sc.tokens)
        torch.cuda.synchronize()
        eager = {k: v for k, v in read_launches().items() if v}
        # no library attention; and no unfused MLP where the eager forward runs K2
        patterns = (FOREIGN_ATTENTION, FOREIGN_MLP) if eager.get("K2") else (FOREIGN_ATTENTION,)
        counts, foreign, tries = _replay_kernels(torch, lambda: g(q), patterns, eager)
        nodes, node_foreign, n_nodes = _graph_kernels(g.graph, patterns, tmp / f"graph_{tag.replace(' ', '_')}_{b}.dot")
        profiled = {k: v for k, v in counts.items() if v}
        r = {"bit_equal": torch.equal(maps_r, maps_e) and torch.equal(means_r, means_e),
             "max_abs": float((maps_r - maps_e).abs().max()), "replay_counted_launches": counted,
             "eager_launches": eager, "graph_kernels": nodes, "graph_kernel_nodes": n_nodes,
             "replay_kernels": profiled, "foreign": foreign + node_foreign, "profiled_calls": tries}
        print(f"step 16 (d) {tag} bucket {b}: replay against eager maps and means bit-equal {r['bit_equal']} "
              f"(max |d| {r['max_abs']:.3e}); the graph's kernel nodes by name {nodes} of {n_nodes}, the eager "
              f"forward's counted launches {eager}, the replay's counted {counted}; by profiler name, each the most "
              f"in one of {tries} profiled replay(s), {profiled}; library attention"
              f"{'/MLP' if eager.get('K2') else ''} kernels {r['foreign']}")
        # the graph holds exactly the eager forward's kernels; a replay runs
        # every node, and the profiler (which loses records) saw each group
        # and no more of it than the graph holds
        profiled_in = set(profiled) == set(eager) and all(v <= eager[k] for k, v in profiled.items())
        if not r["bit_equal"] or counted or r["foreign"] or nodes != eager or (hold_names and not profiled_in):
            bad.append(f"{tag} bucket {b}: {r}")
        return r

    # --- 1. replay against eager at every bucket ----------------------------------
    gd["buckets"] = {b: replay_vs_eager(scorer, b, "bf16 daemon") for b in (1, 2, 4, 8)}
    if gd["buckets"][8]["graph_kernels"] != {"K1": 12, "K2": 12, "K3": 4}:
        bad.append(f"bucket 8 graph kernels {gd['buckets'][8]['graph_kernels']} != K1 12, K2 12, K3 4")

    # --- 1b. a warm shape off the position table's grid (serve_warm_shapes) ---------
    # 518x686 resizes the DINOv2 table bicubically (37x37 -> 37x49) inside the
    # capture. Then the resize constants' table is cleared and memory of their
    # sizes is taken and filled (NaN, or index 0): the graph, which keeps them,
    # must replay the same bits, and the eager forward (new constants) too.
    t0 = time.perf_counter()
    wide = rng.standard_normal((8, HW, WARM_W, 3)).astype(np.float32)
    srv_w, scw = make_server(parse_cli("default_predict", base + ["this_main.serve_max_batch=8",
                                                                  f"this_main.serve_warm_shapes=[{HW}x{WARM_W}]"]))
    srv_w.RequestHandlerClass.log_message = lambda *a: None
    bicubic = ("bicubic", HW // 14, WARM_W // 14, torch.device("cuda", torch.cuda.current_device()))
    gd["off_grid"] = {"bicubic_constant_made": bicubic in interpolate._CONSTANTS}
    gd["off_grid"].update({b: replay_vs_eager(scw, b, f"{HW}x{WARM_W} warm shape", data=wide) for b in (1, 8)})
    (g,) = graph_of(scw, (HW, WARM_W, 8))
    q = torch.from_numpy(wide)
    want_maps, want_means = (t.clone() for t in g(q))

    def replay_kept() -> bool:
        """The check: bucket 8's replay bit-equal to its replay before."""
        maps, means = g(q)
        return torch.equal(maps, want_maps) and torch.equal(means, want_means)

    # the graph's constants are the table as it stood at its capture (a
    # table never evicted): the bicubic matrix's place in it is its place there
    if not gd["off_grid"]["bicubic_constant_made"]:
        _fail(f"step 16 (d): {HW}x{WARM_W}'s bicubic constant was never made")
    kept = list(interpolate._CONSTANTS).index(bicubic)
    same = g.constants[kept].data_ptr() == interpolate._CONSTANTS[bicubic].data_ptr()
    sizes = [(t.shape, t.dtype) for v in interpolate._CONSTANTS.values() for t in (v if isinstance(v, tuple) else (v,))
             if t.is_cuda]  # shapes only: a reference here would keep them alive
    interpolate._CONSTANTS.clear()
    junk = [torch.full(shape, float("nan"), dtype=dt, device=dev) if dt.is_floating_point
            else torch.zeros(shape, dtype=dt, device=dev) for shape, dt in sizes]
    replay_equal = replay_kept()
    eager_maps, eager_means = scw._forward(scw.model, q.to(dev), scw.tokens)
    torch.cuda.synchronize()
    gd["off_grid"]["after_clear"] = {
        "constants_cleared": len(sizes), "replay_bit_equal": replay_equal,
        "eager_bit_equal": torch.equal(eager_maps, want_maps) and torch.equal(eager_means, want_means)}
    del junk, eager_maps, eager_means
    print(f"step 16 (d) {HW}x{WARM_W} (DINOv2 table 37x37 -> 37x{WARM_W // 14} bicubic, constant made "
          f"{gd['off_grid']['bicubic_constant_made']}): after the resize constants' table was cleared and "
          f"{len(sizes)} buffers of their sizes were taken and filled, bucket 8's replay bit-equal to its replay "
          f"before {gd['off_grid']['after_clear']['replay_bit_equal']}, the eager forward too "
          f"{gd['off_grid']['after_clear']['eager_bit_equal']}")
    if not (gd["off_grid"]["bicubic_constant_made"] and all(gd["off_grid"]["after_clear"].values())):
        bad.append(f"{HW}x{WARM_W} after the constants' clearing: {gd['off_grid']}")
    # the planted fault: the bicubic matrix the graph keeps, halved in place,
    # must fail the same check; restored, the replay must pass it again. It
    # frees nothing, so no read can fault.
    held = g.constants[kept]
    saved = held.clone()
    held.mul_(0.5)
    caught = not replay_kept()
    held.copy_(saved)
    restored = replay_kept()
    torch.cuda.synchronize()
    gd["off_grid"]["planted_constant"] = {"the_graph_holds_the_table_entry": same, "caught": caught,
                                          "restored_bit_equal": restored}
    del held, saved
    print(f"step 16 (d) planted fault, the kept bicubic constant 37x{WARM_W // 14} halved in place after the "
          f"capture: bucket 8's replay bit-equal to its replay before {not caught} (caught {caught}); restored, "
          f"bit-equal again {restored}; the graph's list held the table's tensor {same}")
    if not (same and caught and restored):
        bad.append(f"the planted constant: {gd['off_grid']['planted_constant']}")
    for b in (1, 8):
        if gd["off_grid"][b]["graph_kernels"] != {"K1": 12, "K2": 12, "K3": 4}:
            bad.append(f"{HW}x{WARM_W} bucket {b} graph kernels {gd['off_grid'][b]['graph_kernels']}")

    # --- 1c. a shape first captured at request time, under the lock, mid-storm ------
    thread = threading.Thread(target=srv_w.serve_forever, daemon=True)
    thread.start()
    try:
        host, port = srv_w.server_address[:2]
        storm: dict = {}
        bench = threading.Thread(target=lambda: storm.update(
            load_bench(f"http://{host}:{port}", qpath.read_bytes(), 8, 32)))
        bench.start()
        while scw.n_requests < 2 and bench.is_alive():  # the warm request, then the storm's first
            time.sleep(0.001)
        img = rng.random((HW, NEW_W, 3), dtype=np.float32)
        new_key = (HW, NEW_W, 1)
        first = new_key not in scw.compiled_shapes
        res = scw.score(img)
        overlapped = bench.is_alive()
        bench.join(timeout=300)
    finally:
        srv_w.shutdown()
        srv_w.server_close()
        thread.join(timeout=30)
    q_new = torch.from_numpy(scw._preprocess(img)[None]).to(dev)
    want_new = scw._forward(scw.model, q_new, scw.tokens)[0][0].cpu().numpy()
    graph_of(scw, new_key)
    gd["first_in_storm"] = {"first_dispatch": first, "storm_running_after": overlapped,
                            "bit_equal_eager": bool(np.array_equal(res["score_map"], want_new)),
                            "storm_ok": storm.get("requests_ok"), "storm_errors": storm.get("errors"),
                            "storm_rps": storm.get("throughput_rps"), "latency_ms": storm.get("latency_ms")}
    print(f"step 16 (d) {HW}x{NEW_W} first dispatched while 8 workers x 32 requests were served: captured then "
          f"{first}, the storm still running when it answered {overlapped}, its map bit-equal to the eager "
          f"forward {gd['first_in_storm']['bit_equal_eager']}; the storm {storm.get('requests_ok')} ok, errors "
          f"{storm.get('errors')}, {storm.get('throughput_rps', 0):.2f} req/s, latency {storm.get('latency_ms')}; "
          f"{time.perf_counter() - t0:.1f} s; {card}")
    if not (first and overlapped and gd["first_in_storm"]["bit_equal_eager"] and storm.get("errors") == 0
            and storm.get("requests_ok") == 8 * 32):
        bad.append(f"first dispatch mid-storm: {gd['first_in_storm']}")
    del scw, srv_w, g, q
    torch.cuda.empty_cache()

    # --- 2. the warm-cache step and the B=1 dispatch, replay and eager in turns --
    def enqueue_ms(fn) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return 1e3 * (t1 - t0)

    gd["timing"] = {}
    for b in (8, 1):
        (g,) = graph_of(scorer, (HW, HW, b))
        q_dev = torch.from_numpy(batch[:b]).to(dev)
        g.q.copy_(q_dev)
        arms = {"replay": g.graph.replay, "eager": lambda q_dev=q_dev: scorer._forward(scorer.model, q_dev,
                                                                                        scorer.tokens)}
        res = {arm: {"ms": [], "enqueue_ms": []} for arm in arms}
        for order in (("eager", "replay"), ("replay", "eager"), ("replay", "eager"), ("eager", "replay")):
            for arm in order:
                res[arm]["ms"] += _event_times(torch, arms[arm], reps=5, warmup=1)
                res[arm]["enqueue_ms"] += [enqueue_ms(arms[arm]) for _ in range(3)]
        for arm, r in res.items():
            r["median_ms"] = float(np.median(r["ms"]))
            r["median_enqueue_ms"] = float(np.median(r["enqueue_ms"]))
            r["maps_per_s"] = 1e3 * b / r["median_ms"]
            r["spread_ms"] = [min(r["ms"]), max(r["ms"])]
        gd["timing"][f"step_b{b}"] = res
        print(f"step 16 (d) warm-cache step B={b} ({HW} px, K={K}, bf16), 20 CUDA-event calls each in turns: "
              + "; ".join(f"{arm} {r['median_ms']:.3f} ms (spread {r['spread_ms'][0]:.3f}-{r['spread_ms'][1]:.3f}), "
                          f"host enqueue {r['median_enqueue_ms']:.3f} ms, {r['maps_per_s']:.2f} maps/s"
                          for arm, r in res.items()) + f"; {card}")
    q1 = batch[:1]

    def eager_dispatch():  # the dispatch before graphs: upload, the eager forward, the mean's fetch
        q = torch.from_numpy(np.ascontiguousarray(q1))
        with scorer._lock:
            return scorer._forward(scorer.model, q.to(dev), scorer.tokens)[1].cpu().numpy()

    arms = {"replay": lambda: scorer._run_device(q1, False, count=False), "eager": eager_dispatch}
    res = {arm: [] for arm in arms}
    for order in (("eager", "replay"), ("replay", "eager"), ("replay", "eager"), ("eager", "replay")):
        for arm in order:
            arms[arm]()
            for _ in range(5):
                t0 = time.perf_counter()
                arms[arm]()
                res[arm].append(1e3 * (time.perf_counter() - t0))
    gd["timing"]["dispatch_b1"] = {arm: {"ms": v, "median_ms": float(np.median(v)),
                                         "maps_per_s": 1e3 / float(np.median(v))} for arm, v in res.items()}
    print("step 16 (d) the B=1 dispatch (host wall: upload, forward, the mean's fetch), 20 each in turns: "
          + "; ".join(f"{arm} {r['median_ms']:.3f} ms ({min(r['ms']):.3f}-{max(r['ms']):.3f}), "
                      f"{r['maps_per_s']:.2f} maps/s" for arm, r in gd["timing"]["dispatch_b1"].items())
          + f"; {card}")

    # --- 3. after (b)'s reload mid-storm: the new weights' bits ---------------------
    cfg1 = parse_cli("default_predict", base + [f"trainer.ckpt_path_to_load={ckpt[1]}"])
    fresh = load_model_params(cfg1, CrossScoreNet(CrossScoreConfig.from_config(cfg1), device=dev))
    tok1 = RefTokenCache(scorer._encode_fn(fresh), encode_batch=scorer._encode_batch, max_items=scorer.n_refs) \
        .gather([[p] for p in scorer._ref_paths], scorer._ref_imgs).to(dev)
    want = scorer._forward(fresh, torch.from_numpy(q_real[None]).to(dev), tok1)[0].cpu().numpy()
    got = scorer._run_device(q_real[None], True, count=False)[0]
    gd["reload"] = {"ckpt": str(scorer.ckpt_path), "bit_equal_fresh_seed1": bool(np.array_equal(got, want)),
                    "differs_from_seed0": bool(not np.array_equal(got, map0))}
    print(f"step 16 (d) after (b)'s reload mid-storm ({Path(str(scorer.ckpt_path)).name}): the replayed map "
          f"bit-equal to a fresh net on seed 1's weights and tokens {gd['reload']['bit_equal_fresh_seed1']}, "
          f"other than seed 0's {gd['reload']['differs_from_seed0']}")
    if not (gd["reload"]["bit_equal_fresh_seed1"] and gd["reload"]["differs_from_seed0"]
            and Path(str(scorer.ckpt_path)) == ckpt[1]):
        bad.append(f"reload bits {gd['reload']}")
    del fresh, tok1

    # --- 4. the exporter, then a loader with an empty build cache ------------------
    root = Path(__file__).resolve().parent
    art = tmp / "serve.aot"
    cli = [sys.executable, "-m", "crossscore_tpu_torch.tasks.serve", *base, "this_main.serve_max_batch=8"]
    env = dict(os.environ, PYTHONPATH=str(root))
    env.pop(compilation_cache.ENV, None)
    t0 = time.perf_counter()
    res = subprocess.run(cli + ["this_main.serve_warmup_only=true", f"this_main.serve_aot_save={art}"], cwd=tmp,
                         env=env, capture_output=True, text=True, timeout=300)
    saved = next((ln.strip() for ln in res.stdout.splitlines() if "serve: saved" in ln), "")
    done = next((ln.strip() for ln in res.stdout.splitlines() if "warmup-only done" in ln), "")
    inv = aot.describe(art) if art.exists() else {"entries": {}, "libraries": {}}
    gd["exporter"] = {"rc": res.returncode, "seconds": time.perf_counter() - t0, "saved": saved, "done": done,
                      "entries": sorted(inv["entries"]), "libraries": inv["libraries"],
                      "artifact_bytes": art.stat().st_size if art.exists() else 0}
    print(f"step 16 (d) exporter (serve_warmup_only, serve_aot_save) in a child: exit {res.returncode} in "
          f"{gd['exporter']['seconds']:.1f} s: {saved} / {done}; entries {gd['exporter']['entries']}; "
          f"{len(inv['libraries'])} libraries, {gd['exporter']['artifact_bytes']} bytes")
    want_keys = sorted(aot.key(HW, HW, b) for b in (1, 2, 4, 8))
    if res.returncode != 0 or gd["exporter"]["entries"] != want_keys or len(inv["libraries"]) != 4 \
            or "kernels built: none" not in done:
        _fail(f"step 16 (d) exporter: {gd['exporter']}\n{(res.stdout + res.stderr)[-3000:]}")

    cache = tmp / "empty_cache"
    cache.mkdir()
    env_l = dict(env, **{compilation_cache.ENV: str(cache)})
    t0 = time.perf_counter()
    proc = subprocess.Popen(cli + [f"this_main.serve_aot_load={art}"], cwd=tmp, env=env_l,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        out = _Lines(proc, r"serve: ready on http://([\d.]+):(\d+)")
        if not out.found.wait(timeout=300):
            _fail("step 16 (d) the loader never printed its ready line:\n" + "".join(out.lines)[-3000:])
        ready_s = time.perf_counter() - t0
        client = ScoreClient(f"http://{out.match.group(1)}:{out.match.group(2)}", timeout=120)
        health = client.health()
        map_l = client.score_map(qpath.read_bytes())
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    text = out.text()
    ready = out.match.string.strip()
    installed = sorted(p.name for p in cache.iterdir())
    same_bytes = all((cache / n).read_bytes() == (_build.build_dir() / n).read_bytes() for n in installed)
    split = dict(re.findall(r"(artifact|kernels|references|warm-up) ([\d.]+) s", ready))
    gd["loader"] = {"rc": rc, "ready_s": ready_s, "ready_line": ready, "split_s": split,
                    "installed": installed, "bytes_equal_exporter": same_bytes,
                    "aot_shapes": health.get("aot_shapes"), "map_bit_equal": bool(np.array_equal(map_l, map0)),
                    "loaded_line": next((ln.strip() for ln in text.splitlines() if "graph keys from" in ln), "")}
    print(f"step 16 (d) loader (serve_aot_load, empty $CROSSSCORE_COMPILE_CACHE) in a child: ready after "
          f"{ready_s:.1f} s (process start included): {ready}; {gd['loader']['loaded_line']}; installed "
          f"{installed}, byte-equal to the exporter's {same_bytes}; /healthz aot_shapes {health.get('aot_shapes')}; "
          f"map=npy bit-equal to (b)'s {gd['loader']['map_bit_equal']}; exit {rc}; {card}")
    if (rc != 0 or "(built: none)" not in ready or not same_bytes or health.get("aot_shapes") != 4
            or not gd["loader"]["map_bit_equal"] or sorted(inv["libraries"]) != installed
            or any(n.endswith(".log") for n in installed)):
        bad.append(f"loader {gd['loader']}")

    # --- 5. three bad artifacts, refused by field -------------------------------------
    def flip_digest(h):
        rec = h["libraries"][0]
        rec["file"] = rec["file"].replace(rec["digest"], "f" * 16)
        rec["digest"] = "f" * 16

    gd["refusals"] = {}
    for field, edit, match in (
            ("params_signature", lambda h: h["meta"]["params_signature"][0].__setitem__(1, [1]), "params_signature"),
            ("ref_grid", lambda h: h["meta"].update(ref_grid=[49, 37]), "ref_grid"),
            ("library digest", flip_digest, "built from other sources")):
        bad_art = _rewrite_artifact(art, tmp / f"bad_{field.replace(' ', '_')}.aot", edit)
        try:
            Scorer(parse_cli("default_predict", base + ["this_main.serve_max_batch=8",
                                                        f"this_main.serve_aot_load={bad_art}"]))
            msg = None
        except ValueError as e:
            msg = str(e)
        gd["refusals"][field] = None if msg is None else msg[:300]
        print(f"step 16 (d) an artifact with another {field}: refused: {gd['refusals'][field]}")
        if msg is None or match not in msg:
            bad.append(f"bad artifact ({field}) not refused by name: {msg}")
    torch.cuda.empty_cache()

    # --- 6. two replicas on the one card: one graph each ---------------------------------
    sc2 = Scorer(parse_cli("default_predict", base + ["this_main.serve_max_batch=2"]), devices=[dev, dev])
    execs = graph_of(sc2, (HW, HW, 2))
    maps2, means2 = sc2._run_device(batch[:2], True, count=False)
    halves = [sc2._forward(sc2.model, torch.from_numpy(batch[i:i + 1]).to(dev), sc2.tokens) for i in (0, 1)]
    gd["replicas"] = {"graphs": len(execs),
                      "bit_equal": bool(np.array_equal(maps2, torch.cat([h[0] for h in halves]).cpu().numpy())
                                        and np.array_equal(means2, torch.cat([h[1] for h in halves]).cpu().numpy()))}
    print(f"step 16 (d) two replicas on the one card, bucket 2: {len(execs)} graphs, bit-equal to the eager "
          f"forwards of the halves {gd['replicas']['bit_equal']}")
    if len(execs) != 2 or not gd["replicas"]["bit_equal"]:
        bad.append(f"replicas {gd['replicas']}")
    del sc2, execs, halves
    torch.cuda.empty_cache()

    # --- 7. the int8 backbone's graph: Q1 and Q2 captured ------------------------------
    # its kernels are counted where the capture passes the wrappers: a graph
    # of the same forward, made beside the daemon's (an eager run, then the
    # capture), counts the eager forward's launches twice
    sc8 = Scorer(parse_cli("default_predict", base + ["model.gpu.backbone_quant=int8"]))
    gd["int8"] = r = replay_vs_eager(sc8, 1, "int8 daemon", hold_names=False)
    zero_launches()
    _Graph(sc8._forward, sc8.model, sc8.tokens, dev, (1, HW, HW, 3), sc8._in_dtype, sc8._pool)
    torch.cuda.synchronize()
    both = {k: v for k, v in read_launches().items() if v}
    r["captured_launches"] = {k: v - r["eager_launches"].get(k, 0) for k, v in both.items()}
    print(f"step 16 (d) int8 daemon: launches counted in a capture {r['captured_launches']} (the eager forward's "
          f"{r['eager_launches']}); the graph's kernel nodes by name {r['graph_kernels']}; by profiler name, each "
          f"the most in one of {r['profiled_calls']} profiled replays, {r['replay_kernels']}, reported only")
    if r["captured_launches"] != r["eager_launches"] or not (r["eager_launches"].get("Q1")
                                                             and r["eager_launches"].get("Q2")):
        bad.append(f"int8 capture: {r['captured_launches']} against the eager {r['eager_launches']}")
    del sc8
    torch.cuda.empty_cache()

    gd["seconds"] = time.perf_counter() - t_step
    print(f"step 16 (d): {gd['seconds']:.1f} s")
    if bad:
        _fail("step 16 (d): " + "; ".join(bad))
    return gd



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
    # the daemon's graphs keep each captured graph beside its executable,
    # which is made at the capture's end as before, for (d)'s reading of its
    # kernel nodes (keep_graph is a graph's own, set before its capture)
    plain_graph = torch.cuda.CUDAGraph

    class KeptGraph(plain_graph):
        def __new__(cls, keep_graph: bool = False):
            return super().__new__(cls, True)

        def __init__(self, keep_graph: bool = False):
            super().__init__(True)

        def capture_end(self):
            super().capture_end()
            self.instantiate()

    torch.cuda.CUDAGraph = KeptGraph
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
            # one encode call (8 references in a batch of 16), and at each
            # bucket 1/2/4/8 an eager run and the capture of its graph (the
            # warm-up's replay counts nothing)
            want = _launches(K1=12 * 9, K2=12 * 9, K3=4 * 8)
            sv["startup"] = {"seconds": seconds, "split": scorer.startup_s, "graph_memory": scorer.graph_memory,
                             "launches": {k: v for k, v in launches.items() if v}}
            print(f"daemon startup: {seconds:.2f} s (kernels loaded {scorer.startup_s['kernels']:.2f} s, "
                  f"{K} references read and encoded {scorer.startup_s['references']:.2f} s, warm-up and capture "
                  f"of buckets 1/2/4/8 {scorer.startup_s['warmup']:.2f} s); launches {sv['startup']['launches']}; "
                  f"memory {json.dumps(scorer.graph_memory)} (GiB: the peak of the eager runs and of the "
                  f"captures, and what stays allocated)")
            if launches != want:
                _fail(f"daemon startup launches {launches} != {want}")
            health = client.health()
            sv["healthz"] = health
            print(f"daemon /healthz: {json.dumps(health)}")

            zero_launches()
            got = client.score_map(qbytes)
            launches = read_launches()
            map0 = got  # seed 0's map, for step 16 (d)'s loader
            if launches != _launches() or got.shape != (HW, HW):  # a replay passes no wrapper
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
                want = _launches()  # every dispatch a replay (step 16 (d) counts its kernels by name)
                r["launches"] = {k: v for k, v in launches.items() if v}
                r["mean_batch"] = r["daemon"]["requests"] / disp
                sv["load"][workers] = r
                lat = r["latency_ms"]
                print(f"load bench {workers} workers x 16 JSON requests: {r['throughput_rps']:.2f} req/s, p50 "
                      f"{lat['p50']:.2f} / p95 {lat['p95']:.2f} / p99 {lat['p99']:.2f} ms (max {lat['max']:.2f}); "
                      f"{r['daemon']['requests']} requests in {disp} dispatches (mean batch {r['mean_batch']:.2f}, "
                      f"max_batch_seen {r['daemon']['max_batch_seen']}); counted launches {r['launches']} (replays); "
                      f"errors {r['errors']}; {card}")
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
                  f"replay, the mean's fetch); the eager forward {device_ms:.2f} ms between CUDA events "
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
        sv["seconds_c"] = time.perf_counter() - t_step - sv["seconds_a"] - sv["seconds_b"]

        # --- (d) the daemon's graphs and artifacts ----------------------------------
        sv["graphs"] = _graph_phases(torch, dev, card, scorer, base, tmp, qpath, map0, ckpt,
                                     zero_launches, read_launches)
        del scorer
    torch.cuda.CUDAGraph = plain_graph
    sv["seconds"] = time.perf_counter() - t_step
    print(f"serving daemon step: {sv['seconds']:.1f} s ((a) the warm-cache step {sv['seconds_a']:.1f} s, (b) the "
          f"daemon in process {sv['seconds_b']:.1f} s, (c) the CLI {sv['seconds_c']:.1f} s, (d) graphs and "
          f"artifacts {sv['graphs']['seconds']:.1f} s)")
    return sv


def _time_ms(torch, fn, reps: int = 10) -> float:
    """Median of ``reps`` CUDA-event timings after two warm-up calls."""
    return sorted(_event_times(torch, fn, reps))[reps // 2]


def _stream_ms(torch, fn, calls: int = 20, turns: int = 3) -> float:
    """The in-stream mean of one call of ``fn`` in ms: events around
    ``calls`` back-to-back calls, the median of ``turns`` such means after
    two warm-up calls. The host enqueues ahead of the card, so a short
    kernel's time holds no Python of its wrapper's."""
    for _ in range(2):
        fn()
    means = []
    for _ in range(turns):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        means.append(a.elapsed_time(b) / calls)
    return sorted(means)[turns // 2]


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

def _k11_modes(torch, F, fa, qkv, h: int, bound) -> dict:
    """K11's probes and chunks on ``qkv`` (B, N, 3*h*hd) bf16 against their
    plain versions (the probes by the relative L2 of each of o, l and m; the
    chunks as K1, against the plain chunked version and K1's), each launched
    twice for the same bits, timed beside K1 on the same qkv, with SDPA beside
    the chunks; ``bound(ops, nbytes, exps)``."""
    b, n, d3 = qkv.shape
    hd = d3 // 3 // h
    k1_ms = _time_ms(torch, lambda: fa.flash_qkv_self_attention(qkv, h))
    work = (4.0 * b * h * n * n * hd, b * n * 4 * h * hd * 2 + 2 * b * h * n * 4)
    k1_plain = fa.flash_qkv_self_attention_plain(qkv, h)
    out = {}
    for probe in fa.QKV_PROBES:
        got, same = _twice(fa.flash_qkv_self_attention_probe, qkv, h, probe)
        want = fa.flash_qkv_self_attention_probe_plain(qkv, h, probe)
        out[f"K11 {probe}"] = dict(
            err=max(_rel_l2_or_zero(g, w) for g, w in zip(got, want)), tol=TOL_L2["bfloat16"], bit_equal=same,
            max_abs=_max_abs(got[0], want[0]),
            ms=_time_ms(torch, lambda: fa.flash_qkv_self_attention_probe(qkv, h, probe)),
            plain_ms=_time_ms(torch, lambda: fa.flash_qkv_self_attention_probe_plain(qkv, h, probe), reps=3),
            # mxu runs the products and loads only: no exponentials to floor
            library_ms=None, k1_ms=k1_ms, **(bound(*work) if probe == "mxu" else bound(*work, b * h * n * n)))
        del got, want
    views_hm = [qkv.view(b, n, 3, h, hd)[:, :, i].transpose(1, 2) for i in range(3)]
    sdpa_ms = _time_ms(torch, lambda: F.scaled_dot_product_attention(*views_hm))
    for chunks in (2, 3):
        got, same = _twice(fa.flash_qkv_self_attention_chunked, qkv, h, chunks)
        want = fa.flash_qkv_self_attention_chunked_plain(qkv, h, chunks)
        # against the plain chunked version, and K1's plain version (the same function)
        err, l2 = _masked_errs([(got, want), (got, k1_plain)])
        out[f"K11 chunks{chunks}"] = dict(
            err=err, tol=TOL["bfloat16"], l2=l2, tol_l2=TOL_L2["bfloat16"], bit_equal=same,
            max_abs=_max_abs(got[0], want[0]),
            ms=_time_ms(torch, lambda: fa.flash_qkv_self_attention_chunked(qkv, h, chunks)),
            plain_ms=_time_ms(torch, lambda: fa.flash_qkv_self_attention_chunked_plain(qkv, h, chunks), reps=3),
            library_ms=sdpa_ms, k1_ms=k1_ms, **bound(*work, b * h * n * n))
        del got, want
    return out


def _k7p_modes(torch, F, fa, q, k_, v_, bound) -> dict:
    """K7' (mxuprobe, noexp, bf16exp) on contiguous head-major q (B, H, Nq,
    hd) and k/v (B, H, Nk, hd) bf16 against their plain versions by the
    relative L2 of each of o, l and m, each launched twice for the same bits,
    timed beside K7 on the same inputs (and bf16exp beside SDPA, which
    computes the same function with a finer exp); ``bound(ops, nbytes, exps)``."""
    bb, hh, n_q, hdim = q.shape
    nk = k_.shape[2]
    k7_ms = _time_ms(torch, lambda: fa.flash_attention_head_major(q, k_, v_))
    ops, nbytes = 4.0 * bb * hh * n_q * nk * hdim, bb * hh * (2 * n_q + 2 * nk) * hdim * 2 + 2 * bb * hh * n_q * 4
    out = {}
    for variant in fa.HEAD_MAJOR_VARIANTS:
        got, same = _twice(fa.flash_attention_head_major_variant, q, k_, v_, variant)
        want = fa.flash_attention_head_major_variant_plain(q, k_, v_, variant)
        out[f"K7' {variant}"] = dict(
            err=max(_rel_l2_or_zero(g, w) for g, w in zip(got, want)), tol=TOL_L2["bfloat16"], bit_equal=same,
            max_abs=_max_abs(got[0], want[0]),
            ms=_time_ms(torch, lambda: fa.flash_attention_head_major_variant(q, k_, v_, variant)),
            plain_ms=_time_ms(torch, lambda: fa.flash_attention_head_major_variant_plain(q, k_, v_, variant),
                              reps=3),
            library_ms=_time_ms(torch, lambda: F.scaled_dot_product_attention(q, k_, v_))
            if variant == "bf16exp" else None,
            # mxuprobe and noexp compute no exponentials: no floor for them
            k7_ms=k7_ms, **bound(ops, nbytes, bb * hh * n_q * nk if variant == "bf16exp" else 0.0))
        del got, want
    return out


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
    def bound_bf16(ops, nbytes, exps=0.0):
        return bound(ops, nbytes, peak_bf16, exps)

    for kern, r in _k11_modes(torch, F, fa, qkv, h, bound_bf16).items():
        report[(kern, "bfloat16")] = r
    del qkv
    torch.cuda.empty_cache()

    # K7' at the backbone shape and at the decoder's cross shape over K=8
    # references (the microbenchmark's two), contiguous head-major tensors; K7
    # timed on the same inputs
    shapes = {"backbone": (views, h, n, n, hd), "decoder": (8, dec_h, nq, 8 * nq, d // dec_h)}
    for where, (bb, hh, n_q, nk, hdim) in shapes.items():
        q, k_, v_ = (randn(bb, hh, m_, hdim, dtype=bf16) for m_ in (n_q, nk, nk))
        for kern, r in _k7p_modes(torch, F, fa, q, k_, v_, bound_bf16).items():
            report[(kern + (" backbone" if where == "backbone" else ""), "bfloat16")] = r
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
    log = (_build.build_dir() / f"{src}.log").read_text().splitlines()
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
    """Print, for the kernels on wgmma (bf16, and Q2's int8), what ``-Xptxas
    -v`` says of each (registers at launch, spill stores and loads, static
    shared memory, any wgmma it serialised: C7515 and the other notes that say
    so) and the tile plans from the libraries: the forward's at each head dim (K1, K3, K5-K7,
    K11, K7'; ``attn_fwd_wgmma<HD, BIAS, MODE>``: q rows a block, KV tile,
    stages, dynamic shared memory), the backward's (K4, K8, K9; K12 with
    PROBE) and the fused MLP's at D 64 and 384 (K2, K10; ``ln_mlp_tma<D,
    RES, TANH>``: rows a block, blocks a cluster, hidden chunk, the two
    rings' stages, dynamic shared memory, W1/W2 bytes read from L2 per 1000
    rows). Fail on a spill or a serialised wgmma in the forward's hd 48 or 64
    instantiations, in any ``ln_mlp_tma`` or in Q2, on a head dim or width
    without a plan, on a plan above the block's shared memory, or on an MLP
    plan whose L2 weight reads at the predict point exceed half of 64-row blocks
    that each read both matrices. Return the MLP's plan at D 384."""
    import ctypes

    bad = []
    for body in ("ln_mlp_tma", "ln_mlp_wide"):
        entries = _ptxas_entries(_build, "fused_ln_mlp", body + r"ILi(\d+)ELb(\d)ELb(\d)E")
        for (width, res, tanh), info in entries.items():
            print(f"  ptxas fused_ln_mlp {body}<{width}, {'K10' if res == '1' else 'K2'}, "
                  f"{'tanh' if tanh == '1' else 'erf'}>: " + ", ".join(f"{k} {v}" for k, v in info.items()))
            if info.get("spill stores") or info.get("spill loads") or "wgmma serialised" in info:
                bad.append(f"fused_ln_mlp {body}<{width}, {res}, {tanh}>")
    for src in ("flash_qkv", "flash_cross", "attention_modes"):
        for (hd, bias, mode), info in _ptxas_entries(_build, src, r"attn_fwd_wgmmaILi(\d+)ELb(\d)ELi(\d)E").items():
            print(f"  ptxas {src} attn_fwd_wgmma<{hd}, {'BIAS' if bias == '1' else 'no bias'}, mode {mode}>: "
                  + ", ".join(f"{k} {v}" for k, v in info.items()))
            if int(hd) in FWD_STRICT_HDS and (info.get("spill stores") or info.get("spill loads")
                                              or "wgmma serialised" in info):
                bad.append(f"{src} attn_fwd_wgmma<{hd}, {bias}, {mode}>")
    # the fp32 forward (attention_fwd_f32.cuh): the 3xTF32 body and its
    # pre-pass, in both attention libraries; no serialised wgmma at any hd
    for src in ("flash_qkv", "flash_cross"):
        pattern = r"(attn_fwd_tf32|attn_fwd_split_kv)ILi(\d+)E(?:Lb(\d)E)?"
        for (kern, hd, bias), info in _ptxas_entries(_build, src, pattern).items():
            print(f"  ptxas {src} {kern}<{hd}" + ("" if bias is None else f", {'BIAS' if bias == '1' else 'no bias'}")
                  + ">: " + ", ".join(f"{k} {v}" for k, v in info.items()))
            if "wgmma serialised" in info or (int(hd) in FWD_STRICT_HDS
                                              and (info.get("spill stores") or info.get("spill loads"))):
                bad.append(f"{src} {kern}<{hd}, {bias}>")
    # Q2 and its int32 form (int8_linear_kernel<T, RC>): wgmma.s8 fed by TMA
    out_types = {"i": "int32", "f": "fp32", "13__nv_bfloat16": "bf16"}  # mangled
    for (typ, res), info in _ptxas_entries(_build, "int8_linear", r"int8_linear_kernelI(\w+?)Li(\d)E").items():
        print(f"  ptxas int8_linear int8_linear_kernel<{out_types.get(typ, typ)}, "
              f"{'streamed K' if res == '0' else f'A resident, {res} K chunks'}>: "
              + ", ".join(f"{k} {v}" for k, v in info.items()))
        if info.get("spill stores") or info.get("spill loads") or "wgmma serialised" in info:
            bad.append(f"int8_linear int8_linear_kernel<{typ}, {res}>")
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
    from crossscore_tpu_torch.ops.flash_attention import f32_plan

    for hdim in range(16, 129, 16):
        plan = f32_plan(_build.load("flash_qkv"), hdim)
        print(f"  fp32 forward plan hd {hdim}: {plan['rows']} q rows a block ({plan['consumer_warpgroups']} consumer "
              f"warpgroups) over KV tiles of {plan['block_k']}, {plan['stages']} stages of {plan['tile_bytes']} bytes, "
              f"dynamic shared memory {plan['smem_bytes']} bytes")
        if plan["smem_bytes"] > SMEM_LIMIT:
            bad.append(f"fp32 forward plan hd {hdim}: {plan['smem_bytes']} bytes of shared memory")
    bad += _f32_sass(_build)
    mlp = _build.load("fused_ln_mlp").cs_fused_ln_mlp_plan
    mlp.argtypes, mlp.restype = [ctypes.c_int, ctypes.c_void_p], ctypes.c_int
    plans = {}
    for width in (64, 384, 768, 1024):
        out = (ctypes.c_int * 7)()
        if mlp(width, ctypes.addressof(out)) != 0:
            _fail(f"the bf16 fused MLP has no plan at D {width}")
        rows, cl, fch, s1, s2, smem, per_1000 = out
        # W1 and W2 (4 D^2 bf16 values) read once per cluster (D 64, 384: of
        # two 64-row tiles) or once per 64-row tile (D 768, 1024: the cluster
        # shares one tile) at the main point: the predict point at D <= 384,
        # dinov2-large's K=5 forward at 1024, dinov2-base's predict point at 768
        wide = width >= 768
        weights = 2 * 2 * width * 4 * width
        point = VITL_ROWS if width == 1024 else PREDICT_ROWS
        l2 = -(-point // (rows * (1 if wide else cl))) * weights
        alone = -(-point // 64) * weights  # 64-row blocks that each read them
        print(f"  bf16 fused MLP plan D {width}: {rows} rows a {'tile' if wide else 'block'}, clusters of {cl}, "
              f"hidden chunks of {fch}, {s1} + {s2} ring stages, dynamic shared memory {smem} bytes; W1/W2 read "
              f"from L2: {per_1000} bytes per 1000 rows, {l2 / 1e9:.3f} GB at {point} rows"
              + ("" if wide else f" (64-row blocks that each read them: {alone / 1e9:.3f} GB)"))
        if smem > SMEM_LIMIT:
            bad.append(f"fused MLP plan D {width}: {smem} bytes of shared memory")
        # D <= 384: at most half of 64-row blocks' reads; wide: once per 64-row tile
        if (l2 > alone) if wide else (2 * l2 > alone):
            bad.append(f"fused MLP plan D {width}: {l2} bytes of L2 weight reads at {point} rows")
        plans[width] = dict(rows_per_block=rows, cluster=cl, hidden_chunk=fch, stages=[s1, s2], smem_bytes=smem,
                            l2_weight_bytes_per_1000_rows=per_1000, l2_weight_bytes_at_point=l2, rows_at_point=point)
    if bad:
        _fail("the wgmma kernels' build: " + "; ".join(bad))
    return plans


def _f32_sass(_build) -> list:
    """``cuobjdump -sass`` of the K1/K5 library: the tensor-core instructions
    (HGMMA) of each instantiation of the fp32 body, one quoted; a body
    without any is returned as a fault."""
    import shutil
    import subprocess

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    lib = _build.library_path("flash_qkv")
    res = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True)
    if res.returncode != 0:
        return [f"cuobjdump -sass {lib.name}: rc {res.returncode} {res.stderr[-300:]}"]
    counts, first, fn = {}, {}, None
    for line in res.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1) if "attn_fwd_tf32" in m.group(1) else None
            if fn:
                counts[fn] = 0
        elif fn and "HGMMA" in line:
            counts[fn] += 1
            first.setdefault(fn, re.sub(r"^\s*/\*\w+\*/\s*", "", line).strip())
    for fn, n_ in counts.items():
        print(f"  sass flash_qkv {fn}: {n_} HGMMA, e.g. {first.get(fn, '-')}")
    if len(counts) != 16:
        return [f"cuobjdump found {len(counts)} fp32 body instantiations in {lib.name}, not 16"]
    return [f"{fn}: no HGMMA" for fn, n_ in counts.items() if not n_]


def _kernel_names(torch, fn) -> list:
    """The CUDA kernels one call of ``fn`` runs, by ``torch.profiler`` name
    (which backend a library call took)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({evt.key[:120] for evt in prof.key_averages() if "CUDA" in str(evt.device_type)})


def _f32_prepass(torch, qkv, h: int) -> dict:
    """K1's fp32 route at its main shape taken apart, by this script's own
    calls of the two launchers: the pre-pass's stages bit-equal to their
    plain version (``f32_kv_tiles_plain``), then the body run on the stages
    with their K lo and Vt lo zeroed (q's and p's lo halves untouched), whose
    relative L2 against the plain version must exceed TOL_L2: the bound sees
    the split's low halves."""
    import math

    from crossscore_tpu_torch.ops import _build
    from crossscore_tpu_torch.ops import flash_attention as fa

    lib = _build.load("flash_qkv")
    b, n, _ = qkv.shape
    q, k, v = fa.qkv_head_views(qkv, h)
    hd = q.shape[-1]
    bk = fa.f32_plan(lib, hd)["block_k"]
    tiles = fa.f32_split_kv(lib, k, v)
    same = torch.equal(tiles.view(torch.int32), fa.f32_kv_tiles_plain(k, v, bk).view(torch.int32))
    kt, vt = bk * 32 * -(-hd // 32), bk * hd  # the floats of K hi (or lo) and of Vt hi (or lo) in a stage
    tiles[..., kt:2 * kt] = 0
    tiles[..., 2 * kt + vt:] = 0
    o = torch.empty(b, n, h * hd, device=qkv.device)
    l, m = fa.f32_forward(lib, q, tiles, n, fa._split_heads(o, h), None, 1.0 / math.sqrt(hd), "K1 planted")
    _, l2 = _masked_errs([((o, l, m), fa.flash_qkv_self_attention_plain(qkv, h))])
    return {"prepass_bit_equal": same, "planted_lo_zero_l2": l2, "planted_caught": l2 > TOL_L2["float32"]}


def _f32_against(torch, F, dev, other: Path, parity_step, card: str) -> dict:
    """``--against``: another checkout's fp32 attention forward in turns with
    this tree's (other / this / this / other): its ``csrc/flash_qkv.cu`` and
    ``flash_cross.cu`` built with this tree's flags and bound in place of this
    tree's libraries, its ``ops/flash_attention.py`` launchers in place of
    this tree's, on this tree's wrappers. Times K1, K5, K3 (cross and self),
    K6 (cross and self), K7 (the view-parallel views) and K7 at the tp
    backbone shape, fp32 at step 3's shapes, SDPA on the same inputs in each
    turn, and the parity predict step: the median of 10 CUDA-event timed calls
    a turn (5 for the step). Returns {what: {"other": [...], "this": [...],
    "sdpa": [...]}} in ms."""
    import concurrent.futures
    import ctypes
    import importlib.util

    from crossscore_tpu_torch.ops import _build
    from crossscore_tpu_torch.ops import flash_attention as fa
    from crossscore_tpu_torch.tools.matmul_microbench import build_other

    other = other.resolve()
    sources = ("flash_qkv", "flash_cross")
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        paths = dict(zip(sources, pool.map(lambda src: build_other(other, src), sources)))
    libs = {src: ctypes.CDLL(str(path)) for src, path in paths.items()}
    spec = importlib.util.spec_from_file_location("other_flash_attention",
                                                  other / "crossscore_tpu_torch" / "ops" / "flash_attention.py")
    ofa = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ofa)
    launchers = ("_launch_qkv", "_launch_cross", "_launch_head_major")
    print(f"--against {other}: its {', '.join(sources)} built in {time.perf_counter() - t0:.1f} s; turns "
          "other / this / this / other")

    @contextlib.contextmanager
    def bound(turn):
        if turn == "this":
            yield
            return
        saved = {src: _build._libs.get(src) for src in sources}, {n: getattr(fa, n) for n in launchers}
        _build._libs.update(libs)
        for n in launchers:
            setattr(fa, n, getattr(ofa, n))
        try:
            yield
        finally:
            for src, lib in saved[0].items():
                if lib is None:
                    _build._libs.pop(src, None)
                else:
                    _build._libs[src] = lib
            for n, fn in saved[1].items():
                setattr(fa, n, fn)

    gen = torch.Generator(device=dev).manual_seed(SEED + 10)

    def rn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    d, h, dec_h, n, nq = 384, 6, 8, 1370, 1369
    nb = BUCKET_GRID[0] * BUCKET_GRID[1]

    def heads(t, hh):
        return t.view(t.shape[0], -1, hh, t.shape[-1] // hh).transpose(1, 2)

    cases = {}
    qkv = rn(B * (1 + K), n, 3 * d)
    sec = [heads(qkv[..., i * d:(i + 1) * d], h) for i in range(3)]
    cases["K1"] = (lambda: fa.flash_qkv_self_attention(qkv, h), lambda: F.scaled_dot_product_attention(*sec))
    qkv5 = rn(PB, nb + 1, 3 * d)
    bias5 = torch.cat([torch.zeros(PB, 1, device=dev),
                       _token_bias(torch, [VALID_GRIDS[i % 2] for i in range(PB)], dev)], 1).contiguous()
    sec5 = [heads(qkv5[..., i * d:(i + 1) * d], h) for i in range(3)]
    cases["K5"] = (lambda: fa.flash_qkv_self_attention_masked(qkv5, bias5, h),
                   lambda: F.scaled_dot_product_attention(*sec5, attn_mask=bias5[:, None, None, :]))
    q3 = rn(B, nq, d)
    for tag, nk in (("K3", K * nq), ("K3self", nq)):
        k3, v3 = rn(B, nk, d), rn(B, nk, d)
        cases[tag] = (lambda k3=k3, v3=v3: fa.flash_cross_attention(q3, k3, v3, dec_h),
                      lambda k3=k3, v3=v3: F.scaled_dot_product_attention(heads(q3, dec_h), heads(k3, dec_h),
                                                                          heads(v3, dec_h)))
    q6 = rn(PB, nb, d)
    item_bias = _token_bias(torch, [VALID_GRIDS[i % 2] for i in range(PB)], dev)
    for tag, reps_ in (("K6", PK), ("K6self", 1)):
        k6, v6 = rn(PB, reps_ * nb, d), rn(PB, reps_ * nb, d)
        b6 = item_bias.repeat(1, reps_).contiguous()
        cases[tag] = (lambda k6=k6, v6=v6, b6=b6: fa.flash_cross_attention_masked(q6, k6, v6, b6, dec_h),
                      lambda k6=k6, v6=v6, b6=b6: F.scaled_dot_product_attention(
                          heads(q6, dec_h), heads(k6, dec_h), heads(v6, dec_h), attn_mask=b6[:, None, None, :]))
    hm = [heads(t, dec_h) for t in (rn(B, nq, d), rn(B, VP_NK[0], d), rn(B, VP_NK[0], d))]
    cases["K7"] = (lambda: fa.flash_attention_head_major(*hm), lambda: F.scaled_dot_product_attention(*hm))
    bb = [heads(rn(TB * (TK + 1), n, d), h) for _ in range(3)]
    cases["K7 backbone"] = (lambda: fa.flash_attention_head_major(*bb), lambda: F.scaled_dot_product_attention(*bb))

    out = {}
    for what, (fn, sdpa) in cases.items():
        r = {"other": [], "this": [], "sdpa": []}
        for turn in ("other", "this", "this", "other"):
            with bound(turn):
                r[turn].append(_time_ms(torch, fn))
            r["sdpa"].append(_time_ms(torch, sdpa))
        out[what] = r
        print(f"--against {what} fp32: other {r['other'][0]:.3f}, {r['other'][1]:.3f} / this {r['this'][0]:.3f}, "
              f"{r['this'][1]:.3f} ms; SDPA {', '.join(f'{t:.3f}' for t in r['sdpa'])} ms; {card}")
    del cases, qkv, sec, qkv5, sec5, q3, q6, hm, bb
    torch.cuda.empty_cache()
    r = {"other": [], "this": []}
    for turn in ("other", "this", "this", "other"):
        with bound(turn):
            r[turn].append(_time_ms(torch, parity_step, reps=5))
    out["parity predict step"] = r
    print(f"--against parity predict step (518 px, K={K}, B={B}): other {r['other'][0]:.2f}, {r['other'][1]:.2f} / "
          f"this {r['this'][0]:.2f}, {r['this'][1]:.2f} ms; {card}")
    return out


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
    from crossscore_tpu_torch.ops.quant import (
        int8_linear, int8_matmul_s32, quantize_rowwise, quantize_rowwise_given, row_absmax,
    )

    return {"K1": flash_qkv_self_attention, "K2": fused_ln_mlp, "K3": flash_cross_attention,
            "K4": flash_cross_attention_bwd, "K5": flash_qkv_self_attention_masked,
            "K6": flash_cross_attention_masked, "K7": flash_attention_head_major,
            "K8": flash_attention_bwd_single, "K9": flash_attention_bwd_multi,
            # the timing instruments (K11 and K7' also count per mode in .launches_by_mode)
            "K10": fused_res_ln_mlp, "K11 probe": flash_qkv_self_attention_probe,
            "K11 chunks": flash_qkv_self_attention_chunked, "K7'": flash_attention_head_major_variant,
            "K12": lane_pad_probe,
            # the int8 backbone's kernels, which have no Pallas counterpart, and
            # the split forms of its tensor-parallel row layer
            "Q1": quantize_rowwise, "Q2": int8_linear, "Q1a": row_absmax, "Q1b": quantize_rowwise_given,
            "Q2s32": int8_matmul_s32}


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
                  "logger.vis_scalar_every_n_train_steps=1", "this_main.train_recipe=token_fast"] + FIGURES_OFF
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
        qdir, rdir = _write_predict_dirs(data, 2 * PB, PK)  # two batches of step 9's renders
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
        n_b, n_layers, n_dec = 2, pcfg.backbone.num_layers, 2 * pcfg.decoder_layers
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
                if r["launches"] != want or len(r["maps"]) != n_b * PB:
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
          f"this_main.ref_token_cache_dir={tok_work}/tokens"] + FIGURES_OFF
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
    benches = {"ingest": ["-m", "crossscore_tpu_torch.tools.ingest_bench", "4"],
               "assembly loader": ["-m", "crossscore_tpu_torch.tools.token_assembly_bench", "--iters", "10"],
               "assembly glibc": ["-m", "crossscore_tpu_torch.tools.token_assembly_bench", "--arena", "glibc",
                                  "--iters", "10"]}
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
    two batches of step 9's renders, modes (b) and (d), against one rank; (e)
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
              "model.gpu.dist_backend=gloo"] + FIGURES_OFF
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
               "trainer.max_steps=2", "model.gpu.dist_backend=gloo"] + FIGURES_OFF
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
        qdir, rdir = _write_predict_dirs(tmp / "predict", 2 * PB, PK)  # two batches of step 9's renders
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
            if not d[tag]["same_names"] or d[tag]["maps"] != 2 * PB or d[tag]["max_mae"] > DP_MAP_TOL \
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


def _vitl_phases(torch, dev, card: str, peaks, zero_launches, read_launches) -> dict:
    """Step 19, the ViT-L stress path on the card: (a) K2 (tanh and exact)
    and K10 at D 1024 and 768 against their plain versions at the ViT-L
    shape (32,862 rows, F 4096), at dinov2-base's predict point (98,640
    rows, F 3072) and at ragged rows, each launched twice for the same bits,
    timed beside the plain version, the unfused chain of PyTorch calls (the
    library yardstick) and the bound, and K1 past
    2^31 elements (the 32-bit audit); (b) dinov2-large at 1036 px from the
    port's seeded init: the forward at K=5 (B 1, 2, 4) and K=16 (B 1), the
    pixel and the token train step at K=5, B=1, with launches, ms, maps/s,
    MFU and peak memory, and the device-time breakdown of the K=5, B=1
    forward and of both steps; (c) B=1 parity
    against the all-plain net, dinov2-large at 1036 px (K=2) and
    dinov2-base at 518 px (K=8); (d) the three tools through their entry
    points. Returns the readings."""
    import contextlib
    import io

    import numpy as np

    from crossscore_tpu_torch.io.convert import init_params, load_into
    from crossscore_tpu_torch.models import CrossScoreConfig, CrossScoreNet, VIT_PRESETS
    from crossscore_tpu_torch.ops.flash_attention import flash_qkv_self_attention
    from crossscore_tpu_torch.ops.fused_mlp import (
        fused_ln_mlp, fused_ln_mlp_plain, fused_res_ln_mlp, fused_res_ln_mlp_plain,
    )
    from crossscore_tpu_torch.tools import batch_sweep, probe_vitl_token_bwd, stress_vitl
    from crossscore_tpu_torch.tools.mlp_microbench import unfused_chain
    from crossscore_tpu_torch.train.optim import make_optimizer
    from crossscore_tpu_torch.train.step import TrainState, make_predict_step, make_train_step

    t_step = time.perf_counter()
    peak_bf16, peak_bw = peaks
    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    out, bad = {"wide": {}, "forward": {}, "train": {}, "parity": {}, "tools": {}}, []

    def rn(*shape, scale=1.0, shift=0.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=gen, device=dev) * scale + shift).to(dtype)

    # --- (a) K2 and K10 at D 1024 and 768 ------------------------------------
    for width, rows in ((1024, VITL_ROWS), (768, PREDICT_ROWS)):
        f = 4 * width
        mlp = (rn(width, scale=0.1, shift=1.0), rn(width, scale=0.1), rn(f, width, scale=width ** -0.5),
               rn(f, scale=0.1), rn(width, f, scale=f ** -0.5), rn(width, scale=0.1), rn(width, shift=1.0))
        ls1 = rn(width, scale=0.5, shift=1.0)
        checks = {}
        for rows_ in (1, 63, 300, rows):
            x, attn = rn(rows_, width, dtype=bf16), rn(rows_, width, scale=0.3, dtype=bf16)
            for g in ("tanh", "exact"):
                (got,), same = _twice(lambda *a: (fused_ln_mlp(*a),), x, *mlp, 1e-6, g)
                checks[f"K2 {g} rows{rows_}"] = (_rel_err(got, fused_ln_mlp_plain(x, *mlp, 1e-6, g)), same)
            (got,), same = _twice(lambda *a: (fused_res_ln_mlp(*a),), x, attn, ls1, *mlp, 1e-6)
            checks[f"K10 rows{rows_}"] = (_rel_err(got, fused_res_ln_mlp_plain(x, attn, ls1, *mlp, 1e-6)), same)
        # x and attn hold the main shape's rows now
        mb = [m.to(bf16) for m in mlp]
        ls1b = ls1.to(bf16)
        ops = 4.0 * rows * width * f
        k2_bytes = 2 * 2 * rows * width + 2 * 2 * width * f + 2 * (f + 5 * width)
        got, want = fused_ln_mlp(x, *mlp, 1e-6, "tanh"), fused_ln_mlp_plain(x, *mlp, 1e-6, "tanh")
        k2 = dict(rows=rows, F=f, err=checks[f"K2 tanh rows{rows}"][0], max_abs=_max_abs(got, want),
                  ms=_time_ms(torch, lambda: fused_ln_mlp(x, *mlp, 1e-6, "tanh")),
                  plain_ms=_time_ms(torch, lambda: fused_ln_mlp_plain(x, *mlp, 1e-6, "tanh"), reps=3),
                  library_ms=_time_ms(torch, lambda: unfused_chain(x, *mb)),
                  **_bound(ops, k2_bytes, peak_bf16, peak_bw))
        got, want = fused_res_ln_mlp(x, attn, ls1, *mlp, 1e-6), fused_res_ln_mlp_plain(x, attn, ls1, *mlp, 1e-6)
        k10 = dict(rows=rows, F=f, err=checks[f"K10 rows{rows}"][0], max_abs=_max_abs(got, want),
                   ms=_time_ms(torch, lambda: fused_res_ln_mlp(x, attn, ls1, *mlp, 1e-6)),
                   plain_ms=_time_ms(torch, lambda: fused_res_ln_mlp_plain(x, attn, ls1, *mlp, 1e-6), reps=3),
                   library_ms=_time_ms(torch, lambda: unfused_chain(x + attn * ls1b, *mb)),
                   **_bound(ops, k2_bytes + 2 * rows * width + 2 * width, peak_bf16, peak_bw))
        worst = max(e for e, _ in checks.values())
        same = all(s_ for _, s_ in checks.values())
        out["wide"][f"D{width}"] = {"K2": k2, "K10": k10, "worst_err": worst, "bit_equal": same}
        print(f"step 19 (a) K2/K10 bf16 D {width}, F {f}, rows 1, 63, 300 and {rows}: worst max|d|/(1+|plain|) "
              f"{worst:.3e} (tol {TOL['bfloat16']:.1e}), reruns bit-equal {same}; at {rows} rows: K2 "
              f"{k2['ms']:.3f} ms (plain {k2['plain_ms']:.3f} ms, unfused "
              f"chain {k2['library_ms']:.3f} ms, bound {k2['bound_ms']:.3f} ms, {k2['bound_by']}), K10 "
              f"{k10['ms']:.3f} ms (plain {k10['plain_ms']:.3f} ms, residual add + unfused chain "
              f"{k10['library_ms']:.3f} ms, bound {k10['bound_ms']:.3f} ms); {card}")
        if not (worst <= TOL["bfloat16"] and same):
            bad.append(f"(a) K2/K10 at D {width}: " + ", ".join(
                k for k, (e, s_) in checks.items() if e > TOL["bfloat16"] or not s_))
        del x, attn, got, want, mlp, mb
    torch.cuda.empty_cache()
    # the 32-bit audit's one tensor past 2^31 elements on this path: K1's fused
    # qkv at B=8, K=16 (136 views x 5477 tokens x 3072); the last views, whose
    # element offsets pass 2^31, against the same views launched alone
    views, n_tok = 8 * 17, (VITL_HW // 14) ** 2 + 1
    qkv = rn(views, n_tok, 3 * 1024, dtype=bf16)
    big = flash_qkv_self_attention(qkv, 16)
    alone = flash_qkv_self_attention(qkv[-2:].contiguous(), 16)
    same = all(torch.equal(a[-2:], b_) for a, b_ in zip(big, alone))
    out["k1_past_2_31"] = {"elements": qkv.numel(), "last_views_bit_equal": same}
    print(f"step 19 (a) K1 at qkv ({views}, {n_tok}, 3072) bf16, {qkv.numel()} elements (2^31 = {2 ** 31}): the "
          f"last 2 views bit-equal to the same views launched alone: {same}")
    if not same:
        bad.append("(a) K1 past 2^31 elements")
    del qkv, big, alone
    torch.cuda.empty_cache()
    # the same in fp32 (9.2 GB of qkv, ~12 GB of the pre-pass's stages): the
    # 3xTF32 body and its pre-pass past 2^31 elements; a generator of its own
    # keeps the later draws what they were
    qkv = torch.randn(views, n_tok, 3 * 1024, generator=torch.Generator(device=dev).manual_seed(SEED + 11),
                      device=dev)
    big = flash_qkv_self_attention(qkv, 16)
    alone = flash_qkv_self_attention(qkv[-2:].contiguous(), 16)
    same = all(torch.equal(a[-2:], b_) for a, b_ in zip(big, alone))
    out["k1_fp32_past_2_31"] = {"elements": qkv.numel(), "last_views_bit_equal": same}
    print(f"step 19 (a) K1 at qkv ({views}, {n_tok}, 3072) fp32, {qkv.numel()} elements: the last 2 views bit-equal "
          f"to the same views launched alone: {same}")
    if not same:
        bad.append("(a) K1 fp32 past 2^31 elements")
    del qkv, big, alone
    torch.cuda.empty_cache()

    # --- (b) dinov2-large at 1036 px: forward and train steps -----------------
    cfg, mcfg, model = stress_vitl.build("dinov2-large", [], dev, SEED)
    vit = mcfg.backbone
    d, n_dec = vit.hidden_size, 2 * mcfg.decoder_layers
    print(f"step 19 (b) dinov2-large ({vit.num_layers} layers, D {d}, {vit.num_heads} heads) at {VITL_HW} px, "
          f"{sum(p.numel() for p in model.parameters()) / 1e6:.0f} M parameters, seeded init, bf16 compute")
    step = make_predict_step(model)
    want_fwd = _launches(K1=vit.num_layers, K2=vit.num_layers, K3=n_dec)
    for k, b in ((VITL_K, 1), (VITL_K, 2), (VITL_K, 4), (16, 1)):
        batch = stress_vitl.make_batch(gen, dev, b, k, VITL_HW, d)
        q, r = batch["query/img"], batch["reference/cross/imgs"]
        zero_launches()
        score = step(q, r)["score_map_ref_cross"]
        torch.cuda.synchronize()
        launches = read_launches()
        ok = (launches == want_fwd and tuple(score.shape) == (b, VITL_HW, VITL_HW)
              and bool(torch.isfinite(score).all()) and 0.0 <= float(score.min()) <= float(score.max()) <= 1.0)
        torch.cuda.reset_peak_memory_stats()
        ts = sorted(_event_times(torch, lambda: step(q, r), reps=5))
        ms = ts[2]
        enc_f, dec_f = stress_vitl.model_flops(VITL_HW, k, vit, d, mcfg.decoder_layers, mcfg.decoder_ffn_ratio,
                                               mcfg.patch_size)
        row = {"ms": ms, "spread_ms": [ts[0], ts[-1]], "maps_per_s": b / (ms / 1e3),
               "mfu": b * (enc_f + dec_f) / (ms / 1e3) / peak_bf16,
               "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
               "launches": {k_: v for k_, v in launches.items() if v}}
        out["forward"][f"K{k} B{b}"] = row
        print(f"step 19 (b) forward K={k} B={b}: {ms:.2f} ms (spread {ts[0]:.2f}-{ts[-1]:.2f}), "
              f"{row['maps_per_s']:.3f} maps/s, MFU {row['mfu']:.3f} of {peak_bf16 / 1e12:g} TFLOP/s "
              f"({(enc_f + dec_f) / 1e12:.2f} TFLOP a map), peak {row['peak_gib']:.2f} GiB, launches "
              f"{row['launches']} (expected K1 {vit.num_layers}, K2 {vit.num_layers}, K3 {n_dec}); {card}")
        if not ok:
            bad.append(f"(b) forward K={k} B={b}: launches {launches} / score map check")
        if (k, b) == (VITL_K, 1):
            row["busy_ms"] = _profile(torch, lambda: step(q, r), ms, what=f"step 19 (b) forward K={k} B={b}")
        del batch, q, r, score
    out["k2_launches"] = out["forward"][f"K{VITL_K} B1"]["launches"]["K2"]
    optimizer, scheduler, _ = make_optimizer(cfg, model, steps_per_epoch=1)
    train_step = make_train_step(model, optimizer, scheduler)
    enc_f, dec_f = stress_vitl.model_flops(VITL_HW, VITL_K, vit, d, mcfg.decoder_layers, mcfg.decoder_ffn_ratio,
                                           mcfg.patch_size)
    for mode in ("pixel", "token"):
        token = mode == "token"
        batch = stress_vitl.make_batch(gen, dev, 1, VITL_K, VITL_HW, d, with_map=True, token=token)
        before = {k_: v.detach().clone() for k_, v in model.state_dict().items()}
        zero_launches()
        state, metrics = train_step(TrainState(), batch)
        torch.cuda.synchronize()
        launches = read_launches()
        want = _launches(K3=n_dec, K4=n_dec) if token else _launches(
            K1=vit.num_layers, K2=vit.num_layers, K3=n_dec, K4=n_dec)
        loss = float(metrics["loss"])
        after = model.state_dict()
        frozen = [k_ for k_ in after if k_.startswith("backbone.") or k_ == "pos_enc_fn.PE"]
        trained = [k_ for k_, prm in model.named_parameters() if prm.requires_grad]
        moved = [k_ for k_ in frozen if not torch.equal(after[k_], before[k_])]
        unmoved = [k_ for k_ in trained if torch.equal(after[k_], before[k_])]
        del before
        torch.cuda.reset_peak_memory_stats()
        ts = sorted(_event_times(torch, lambda: train_step(state, batch), reps=5))
        ms = ts[2]
        row = {"ms": ms, "spread_ms": [ts[0], ts[-1]], "ms_per_map": ms,
               "mfu": ((0 if token else enc_f) + 3 * dec_f) / (ms / 1e3) / peak_bf16,
               "peak_gib": torch.cuda.max_memory_allocated() / 2**30, "loss": loss,
               "launches": {k_: v for k_, v in launches.items() if v}, "updated": len(trained),
               "frozen_bit_identical": len(frozen) - len(moved)}
        row["busy_ms"] = _profile(torch, lambda: train_step(state, batch), ms, what=f"step 19 (b) {mode} train step")
        out["train"][mode] = row
        print(f"step 19 (b) {mode} train step K={VITL_K} B=1: loss {loss:.6f}, {len(trained) - len(unmoved)} of "
              f"{len(trained)} decoder/head tensors updated, {len(frozen) - len(moved)} of {len(frozen)} "
              f"backbone/PE tensors bit-identical; {ms:.2f} ms (spread {ts[0]:.2f}-{ts[-1]:.2f}), MFU "
              f"{row['mfu']:.3f}, peak {row['peak_gib']:.2f} GiB, launches {row['launches']} (expected "
              f"{ {k_: v for k_, v in want.items() if v} }); {card}")
        if launches != want or not np.isfinite(loss) or moved or unmoved \
                or not all(k_.startswith("ref_cross.") for k_ in trained):
            bad.append(f"(b) {mode} train step: launches, loss or parameters")
        del batch, metrics
    del model, optimizer, scheduler, train_step, step
    torch.cuda.empty_cache()

    # --- (c) B=1 against the all-plain net -----------------------------------
    for preset, hw, k in (("dinov2-large", VITL_HW, 2), ("dinov2-base", HW, 8)):
        vit_ = VIT_PRESETS[preset]
        params = init_params(CrossScoreConfig(backbone=vit_), SEED, dev)
        batch = stress_vitl.make_batch(gen, dev, 1, k, hw, vit_.hidden_size)
        maps, launches = {}, {}
        for impl, mlp_impl in (("flash", "fused_exact"), ("dense", "unfused")):
            c = CrossScoreConfig(backbone=vit_, compute_dtype=bf16, attention_impl=impl, mlp_impl=mlp_impl)
            net = load_into(CrossScoreNet(c, device=dev), params)
            zero_launches()
            maps[impl] = make_predict_step(net)(batch["query/img"], batch["reference/cross/imgs"])[
                "score_map_ref_cross"]
            torch.cuda.synchronize()
            launches[impl] = read_launches()
            del net
            torch.cuda.empty_cache()
        mae = float((maps["flash"] - maps["dense"]).abs().mean())
        want = _launches(K1=vit_.num_layers, K2=vit_.num_layers, K3=n_dec)
        out["parity"][preset] = {"hw": hw, "k": k, "mae": mae, "tol": NET_TOL["bfloat16"],
                                 "launches": {k_: v for k_, v in launches["flash"].items() if v}}
        print(f"step 19 (c) {preset} at {hw} px, B=1, K={k}, bf16, kernels (exact GELU) against the all-plain "
              f"net: score MAE {mae:.3e} (tol {NET_TOL['bfloat16']:.0e}); kernel-path launches "
              f"{out['parity'][preset]['launches']} (expected K1 {vit_.num_layers}, K2 {vit_.num_layers} at D "
              f"{vit_.hidden_size}, K3 {n_dec}), plain-path launches {sum(launches['dense'].values())}")
        if not (mae < NET_TOL["bfloat16"]) or launches["flash"] != want or any(launches["dense"].values()):
            bad.append(f"(c) {preset} parity or launches")
        del params, batch, maps
        torch.cuda.empty_cache()

    # --- (d) the three tools through their entry points ----------------------
    runs = {"stress_vitl": (stress_vitl.main, ["--batches", "1", "--k", "2"]),
            "probe_vitl_token_bwd": (probe_vitl_token_bwd.main, ["--k", "2"]),
            "batch_sweep": (batch_sweep.main, ["--batches", "16", "--modes", "token"])}
    for tag, (tool, argv) in runs.items():
        buf = io.StringIO()
        zero_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = tool(argv)
        torch.cuda.synchronize()
        lines = buf.getvalue().strip().splitlines()
        try:
            last = json.loads(lines[-1])
        except (IndexError, ValueError):
            last = None
        errors = "error" in json.dumps(last) if last is not None else True
        run = {"rc": rc, "s": time.perf_counter() - t0, "launches": {k_: v for k_, v in read_launches().items() if v},
               "last_line": last}
        out["tools"][tag] = run
        print(f"step 19 (d) tools.{tag} {' '.join(argv)}: exit {rc} in {run['s']:.1f} s, launches {run['launches']}; "
              f"its card line: {lines[0] if lines else None}; its last line: {lines[-1] if lines else None}")
        if rc != 0 or last is None or errors or not run["launches"]:
            bad.append(f"(d) tools.{tag}")
        torch.cuda.empty_cache()
    out["s"] = time.perf_counter() - t_step
    print(f"step 19: {out['s']:.1f} s")
    if bad:
        _fail("step 19: " + "; ".join(bad))
    return out


# step 20 (a): the kernels' hd 8 route at the dinov2-test decoder (B 4, 8
# heads of hd 8, crop 84 and K=2: 36 queries over 72 keys) and at a ragged
# larger shape: name -> (B, Nq, Nk)
HD8_SHAPES = {"tiny": (4, 36, 72), "ragged": (1, 1369, 6845)}
# step 20 (c): the overfit run's steps and the correlation they must pass.
# The TPU tool's protocol is 300 steps and 0.95; on the H100 the port reads
# 0.74 at step 76 and a plateau of 0.947-0.948 from step 176 at ~363 ms a
# step, as the JAX CLI plateaus at 0.949 on the CPU from the same corpus
# (tests/overfit_curves.py; PERF.md, PR 16), so step 20 takes the first 80
# steps
OVERFIT_STEPS, OVERFIT_MIN_CORR = 80, 0.5


def _hd8_phases(torch, F, dev, peaks, zero_launches, read_launches) -> dict:
    """Step 20 (a): K3, K6, K7, K4 and K8/K9 at hd 8, where every wrapper
    zero-pads the heads to 16 lanes, launches the hd 16 body at the scale
    1/sqrt(8) and slices the outputs back, against their plain versions at hd
    8 itself, bf16 and fp32, at step 3's tolerances; each launched twice for
    the same bits, timed beside the plain version, SDPA (its backward for K4
    and K8/K9) and the bound of the hd 8 work. Then the route is given a
    launcher that passes the padded width's 1/sqrt(16) in place of the
    route's scale, and K3's check must fail.
    Returns the readings by kernel, shape and dtype."""
    import math

    from crossscore_tpu_torch.ops import flash_attention as fa

    peak_bf16, peak_f32, peak_bw, peak_ex2 = peaks
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    h, hd = 8, fa.NARROW_HEAD_DIM
    d = h * hd
    out: dict = {"readings": {}}
    bad = []

    def randn(*shape, dtype):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    def heads(t):
        return t.view(t.shape[0], -1, h, hd).transpose(1, 2)

    def sdpa_bwd(q, k, v, do):
        qh, kh, vh = (heads(t).detach().requires_grad_() for t in (q, k, v))
        oh = F.scaled_dot_product_attention(qh, kh, vh)
        return lambda: torch.autograd.grad(oh, (qh, kh, vh), heads(do), retain_graph=True)

    zero_launches()
    for dtype in (torch.bfloat16, torch.float32):
        tname = str(dtype).split(".")[-1]
        es, peak = dtype.itemsize, (peak_bf16 if dtype == torch.bfloat16 else peak_f32)
        for sname, (b, nq, nk) in HD8_SHAPES.items():
            q, do = randn(b, nq, d, dtype=dtype), randn(b, nq, d, dtype=dtype)
            k, v = randn(b, nk, d, dtype=dtype), randn(b, nk, d, dtype=dtype)
            bias = torch.zeros(b, nk, device=dev)
            for i in range(b):  # each item masks another third of the keys
                bias[i, i % 3::3] = -1e30
            exps = float(b * h * nq * nk)
            fwd_bytes = (2 * b * nq * d + 2 * b * nk * d) * es + 2 * b * h * nq * 4
            bwd_bytes = b * (3 * nq + 2 * nk) * d * es + 2 * b * h * nq * 4 + b * (nq + 2 * nk) * d * es
            rows = {}
            hq, hk, hv = heads(q), heads(k), heads(v)
            fwd = {"K3": (lambda: fa.flash_cross_attention(q, k, v, h), lambda: fa.flash_cross_attention_plain(q, k, v, h),
                          lambda: F.scaled_dot_product_attention(hq, hk, hv), exps),
                   "K6": (lambda: fa.flash_cross_attention_masked(q, k, v, bias, h),
                          lambda: fa.flash_cross_attention_masked_plain(q, k, v, bias, h),
                          lambda: F.scaled_dot_product_attention(hq, hk, hv, attn_mask=bias[:, None, None, :].to(dtype)),
                          h * nq * float((bias == 0).sum())),
                   "K7": (lambda: fa.flash_attention_head_major(hq, hk, hv),
                          lambda: fa.flash_attention_head_major_plain(hq, hk, hv),
                          lambda: F.scaled_dot_product_attention(hq, hk, hv), exps)}
            for kern, (fn, plain, lib, n_exp) in fwd.items():
                got, same = _twice(fn)
                want = plain()
                err, l2 = _masked_errs([(got, want)])
                rows[kern] = dict(err=err, tol=TOL[tname], l2=l2, tol_l2=TOL_L2[tname], bit_equal=same,
                                  max_abs=_max_abs(got[0], want[0]), ms=_time_ms(torch, fn),
                                  plain_ms=_time_ms(torch, plain, reps=3), library_ms=_time_ms(torch, lib),
                                  **_fwd_bound(tname, 4.0 * n_exp * hd, fwd_bytes, n_exp, peaks,
                                               _tf32_peak(torch.cuda.get_device_name(0))))
                if not same or err > TOL[tname] or l2 > TOL_L2[tname]:
                    bad.append(f"{kern} hd 8 {sname} {tname}: err {err:.3e}, l2 {l2:.3e}, same bits {same}")
            o, l, m = fa.flash_cross_attention(q, k, v, h)
            oh, lh, mh = fa.flash_attention_head_major(hq, hk, hv)
            kb = "K8" if nk <= fa.BWD_SINGLE_MAX_NK else "K9"
            bwd = {"K4": (lambda: fa.flash_cross_attention_bwd(q, k, v, o, do, l, m, h),
                          lambda: fa.flash_cross_attention_bwd_plain(q, k, v, o, do, l, m, h)),
                   kb: (lambda: fa.flash_attention_head_major_bwd(hq, hk, hv, oh, heads(do), lh, mh),
                        lambda: fa.flash_attention_head_major_bwd_plain(hq, hk, hv, oh, heads(do), lh, mh))}
            lib = sdpa_bwd(q, k, v, do)
            for kern, (fn, plain) in bwd.items():
                got, same = _twice(fn)
                want = plain()
                err = max(_rel_l2(g, w) for g, w in zip(got, want))
                rows[kern] = dict(err=err, tol=TOL_K4[tname], bit_equal=same,
                                  max_abs=max(_max_abs(g, w) for g, w in zip(got, want)), ms=_time_ms(torch, fn),
                                  plain_ms=_time_ms(torch, plain, reps=3), library_ms=_time_ms(torch, lib),
                                  **_bound(10.0 * exps * hd, bwd_bytes, peak, peak_bw, exps, peak_ex2))
                if not same or err > TOL_K4[tname]:
                    bad.append(f"{kern} hd 8 {sname} {tname}: relative L2 {err:.3e}, same bits {same}")
            for kern, r in rows.items():
                out["readings"][(kern, sname, tname)] = r
                print(f"step 20 (a) {kern} hd 8 {sname} (B {b}, {h} heads, Nq {nq}, Nk {nk}) {tname}: err "
                      f"{r['err']:.3e} (tol {r['tol']:g})" + (f", l2 {r['l2']:.3e}" if "l2" in r else "")
                      + f", same bits {r['bit_equal']}; {r['ms']:.4f} ms, plain {r['plain_ms']:.4f}, SDPA "
                      f"{r['library_ms']:.4f}, bound {r['bound_ms']:.4f} ({r['bound_floor']})")
            del q, k, v, do, o, l, m, oh, lh, mh, hq, hk, hv, lib, got, want
    out["launches"] = {kk: c for kk, c in read_launches().items() if c}

    # the planted fault: the route with a launcher that passes the padded
    # width's scale in place of the one the route gives it
    b, nq, nk = HD8_SHAPES["tiny"]
    q, k, v = (randn(b, n, d, dtype=torch.bfloat16) for n in (nq, nk, nk))
    wrong = fa.narrow_head_route(lambda q, k, v, scale: fa._launch_cross(
        "flash_cross_attention", q, k, v, h, scale=1.0 / math.sqrt(fa.NARROW_PADDED)), (q, k, v), 1)
    err, l2 = _masked_errs([(wrong, fa.flash_cross_attention_plain(q, k, v, h))])
    out["planted_scale"] = {"err": err, "l2": l2, "caught": err > TOL["bfloat16"] or l2 > TOL_L2["bfloat16"]}
    print(f"step 20 (a) planted fault, scale 1/sqrt(16) in the hd 8 route: K3 err {err:.3e}, l2 {l2:.3e} "
          f"(bounds {TOL['bfloat16']:g}, {TOL_L2['bfloat16']:g}): caught {out['planted_scale']['caught']}")
    if not out["planted_scale"]["caught"]:
        bad.append("the planted wrong scale was not caught")
    if bad:
        _fail("step 20 (a): " + "; ".join(bad))
    return out


def _quality_train(torch, zero_launches, read_launches, work: Path) -> dict:
    """Step 20 (b): the train CLI at the cpu-tiny geometry on the card
    (dinov2-test, fp32, B=4, K=2, crop 84), 3 steps and a validation batch,
    the backbone from a seeded HuggingFace-keyed torch file
    (``model.backbone.init_path``) and the histograms every step: K3 4 and
    K4 4 launches a step, a finite loss, the backbone after the run the
    file's bit for bit, the ``train/score_hist_*`` and
    ``train/l1_diff_hist_*`` rows summing to the batch's pixels; then a run
    with the figures on must stop at startup, matplotlib missing, with the
    startup check's message."""
    import importlib.util

    import numpy as np

    from crossscore_tpu_torch.confsys import load_config
    from crossscore_tpu_torch.data.synthetic import generate
    from crossscore_tpu_torch.io.convert import init_params
    from crossscore_tpu_torch.models import CrossScoreConfig, VIT_PRESETS
    from crossscore_tpu_torch.tasks.train import main as train_main

    t0 = time.perf_counter()
    generate(work / "tiny", hw=(112, 140), scenes_per_split={"train": 2, "val": 1, "test": 1}, seed=SEED)
    mcfg = CrossScoreConfig.from_config(load_config("default", ["model.backbone.preset=dinov2-test"]))
    backbone = {k[len("backbone."):]: v for k, v in init_params(mcfg, SEED + 7).items() if k.startswith("backbone.")}
    torch.save(backbone, work / "backbone_hf.pt")
    crop, batch, n_layers = 84, 4, VIT_PRESETS["dinov2-test"].num_layers
    ov = [f"data.dataset.path=[{work}/tiny]", f"run.dir={work}/log20", "model.gpu.compute_dtype=float32",
          "model.backbone.preset=dinov2-test", "data.neighbour_config.cross=2",
          f"data.loader.train.batch_size={batch}", f"data.loader.validation.batch_size={batch}",
          f"data.transforms.crop_size={crop}", "this_main.resize_short_side=-1", "trainer.max_steps=3",
          "trainer.num_sanity_val_steps=1", "trainer.limit_val_batches=1", "logger.vis_scalar_every_n_train_steps=1",
          "logger.vis_histogram_every_n_train_steps=1", f"model.backbone.init_path={work / 'backbone_hf.pt'}"]
    zero_launches()
    run = train_main(ov + FIGURES_OFF + ["alias=tiny"])
    torch.cuda.synchronize()
    launches = {k: c for k, c in read_launches().items() if c}
    rows = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    losses = [r["train/loss"] for r in rows if "train/loss" in r]
    sd = torch.load(run / "ckpt" / "step_00000003.ckpt", map_location="cpu", weights_only=True)["state_dict"]
    bb_equal = all(torch.equal(sd[f"model.backbone.{k}"], v) for k, v in backbone.items())
    hists = {name: [sum(r[f"{name}_{i}"] for i in range(10)) for r in rows if f"{name}_0" in r]
             for name in ("train/score_hist", "train/l1_diff_hist")}
    want = _launches(K1=4 * n_layers, K2=4 * n_layers, K3=4 * 4, K4=4 * 3)  # 3 steps and 1 validation batch
    res = {"losses": losses, "launches": launches, "backbone_equal": bb_equal, "hist_sums": hists,
           "validation": [r["validation/loss"] for r in rows if "validation/loss" in r]}
    # the figures on, matplotlib missing (as on the card's machine): the run stops before a step
    res["matplotlib_importable"] = importlib.util.find_spec("matplotlib") is not None
    saved = sys.modules.get("matplotlib", ...)
    sys.modules["matplotlib"] = None
    try:
        train_main(ov + ["logger.vis_imgs_every_n_train_steps=1", "alias=tiny_figures"])
        res["startup_check"] = None
    except RuntimeError as e:
        res["startup_check"] = str(e)
    finally:
        if saved is ...:
            del sys.modules["matplotlib"]
        else:
            sys.modules["matplotlib"] = saved
    res["s"] = time.perf_counter() - t0
    print(f"step 20 (b) train CLI, dinov2-test fp32 at crop {crop}, B={batch}, K=2, init_path: losses "
          f"{[round(x, 6) for x in losses]}, validation {res['validation']}, launches {launches} (expected "
          f"{ {k: c for k, c in want.items() if c} }), backbone after the run the file's: {bb_equal}; histogram "
          f"sums {hists} (pixels a batch {batch * crop * crop}); with figures on, matplotlib missing "
          f"(importable here: {res['matplotlib_importable']}): {res['startup_check']!r}; {res['s']:.1f} s")
    ok = (len(losses) == 3 and all(np.isfinite(losses)) and len(res["validation"]) == 1 and bb_equal
          and {k: launches.get(k, 0) for k in want} == want
          and all(v == [batch * crop * crop] * 3 for v in hists.values())
          and res["startup_check"] is not None and "logger.vis_imgs_every_n_train_steps" in res["startup_check"]
          and "logger.cache_size.validation.n_fig" in res["startup_check"])
    if not ok:
        _fail("step 20 (b): the train CLI at the tiny geometry")
    return res


def _trailing_json(text: str):
    """The indented JSON object that ends a tool's output, or None."""
    try:
        return json.loads(text[text.rindex("\n{\n") + 1:])
    except ValueError:
        return None


def _quality_tools(torch, zero_launches, read_launches, work: Path) -> dict:
    """Step 20 (c): the quality tools through their entry points at
    dinov2-small width, 518 px: ``overfit_convergence`` (B=4, K=2, 224 px
    crops, OVERFIT_STEPS steps: its correlation must pass
    OVERFIT_MIN_CORR), ``ab_token_vs_pixel --preset gpu-medium`` (both arms,
    2 steps, then one validation batch each), ``multimethod_eval
    --train-steps 4 --ks 8`` and ``k_sweep`` on its corpus and
    checkpoint, and ``bench_stress_attention`` (K7 and K3 beside SDPA at
    5476 queries over 87,616 keys). Each must exit 0 with its output lines
    and launch its kernels. ``ab_token_vs_pixel`` and ``multimethod_eval``
    run their CLIs in child processes, as the TPU tools do: each child runs
    through :func:`_counted_cli`, and its launches add to the tool's."""
    import io
    from unittest import mock

    from crossscore_tpu_torch.tools import (
        _common, ab_token_vs_pixel, bench_stress_attention, k_sweep, multimethod_eval, overfit_convergence,
    )

    import subprocess

    # the host's busiest processes when the step starts: the children share
    # its 8 cores with whatever an earlier step left running
    ps = subprocess.run(["ps", "-eo", "pid,ppid,pcpu,rss,etime,comm", "--sort=-pcpu"], capture_output=True,
                        text=True).stdout.splitlines()
    print("step 20 (c) host processes, busiest first:\n  " + "\n  ".join(ps[:8]) + f"\n  ({len(ps) - 1} in all)")
    res: dict = {}
    bad = []
    counts = work / "cli_launches"
    counts.mkdir(parents=True, exist_ok=True)

    def counted_command(task):
        n = len(list(counts.iterdir()))
        (counts / f"{n}.json").write_text('{"launches": {}}')  # the slot; the child overwrites it
        return [sys.executable, str(Path(__file__).resolve()), "--count-launches", str(counts / f"{n}.json"),
                "-m", f"crossscore_tpu_torch.tasks.{task}"]

    def run(tag, tool, argv):
        buf = io.StringIO()
        zero_launches()
        for f in counts.iterdir():
            f.unlink()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf), mock.patch.object(_common, "cli_command", counted_command):
            rc = tool(argv)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        launches = read_launches()
        children = [json.loads(f.read_text()) for f in sorted(counts.iterdir(), key=lambda f: int(f.stem))]
        for child in children:
            for k, c in child["launches"].items():
                launches[k] += c
        r = {"rc": rc, "s": time.perf_counter() - t0, "launches": {k: c for k, c in launches.items() if c},
             "children": [[round(c.get("import_s", -1), 1), round(c.get("s", -1), 1)] for c in children],
             "text": buf.getvalue()}
        res[tag] = r
        return r

    r = run("overfit_convergence", overfit_convergence.main,
            [str(OVERFIT_STEPS), str(work / "overfit"), "--min-corr", str(OVERFIT_MIN_CORR)])
    final = re.search(r"final: step (\d+) L1 ([\d.]+) corr (-?[\d.]+) \(best corr (-?[\d.]+)\)", r["text"])
    ms = re.search(r"ms/step: ([\d.]+)", r["text"])
    r.update(final_step=int(final.group(1)) if final else None, final_l1=float(final.group(2)) if final else None,
             final_corr=float(final.group(3)) if final else None, best_corr=float(final.group(4)) if final else None,
             ms_per_step=float(ms.group(1)) if ms else None)
    if r["rc"] != 0 or not final or not ms or not all(r["launches"].get(k) for k in ("K1", "K2", "K3", "K4")):
        bad.append("overfit_convergence")

    # 2 steps, then one validation batch: the epoch cut to 2 batches and
    # validated (trainer.max_steps would stop the run before the epoch-end
    # validation); the sustained window over step 2
    r = run("ab_token_vs_pixel", ab_token_vs_pixel.main,
            ["--preset", "gpu-medium", "--out", str(work / "ab"), "--sustained", "1",
             "--extra", "trainer.max_epochs=1", "--extra", "trainer.limit_train_batches=2",
             "--extra", "trainer.check_val_every_n_epoch=1", "--extra", "trainer.limit_val_batches=1"])
    report = _trailing_json(r["text"])
    r["arms"] = [{k: a.get(k) for k in ("arm", "steps", "wall_s", "sustained_ms_per_step", "final_val_loss",
                                         "final_val_corr", "error")} for a in (report or {}).get("arms", [])]
    if r["rc"] != 0 or [a["arm"] for a in r["arms"]] != ["pixel", "token"] \
            or any(a["steps"] != 2 or a["final_val_loss"] is None or a["error"] for a in r["arms"]) \
            or not all(r["launches"].get(k) for k in ("K1", "K2", "K3", "K4")):
        bad.append("ab_token_vs_pixel")

    r = run("multimethod_eval", multimethod_eval.main,
            ["--out", str(work / "mm"), "--train-steps", "4", "--ks", "8"])
    report = _trailing_json(r["text"])
    r["report"] = report
    if r["rc"] != 0 or report is None or [x["K"] for x in report["runs"]] != [8] \
            or any(set(x["per_method"]) != set(multimethod_eval.METHODS) for x in report["runs"]) \
            or not all(r["launches"].get(k) for k in ("K1", "K2", "K3", "K4")):
        bad.append("multimethod_eval")
        report = None

    if report is not None:
        base = multimethod_eval.geometry(False)[4] + [multimethod_eval.TEST_FIGURES_OFF]
        root = work / "mm" / "corpus" / multimethod_eval.METHODS[0] / multimethod_eval.DATASET
        r = run("k_sweep", k_sweep.main, [str(root), report["ckpt"]] + base)
        r["lines"] = [line for line in r["text"].splitlines() if line.startswith("k_sweep K=")]
        if r["rc"] != 0 or len(r["lines"]) != 3 or not r["launches"].get("K3"):
            bad.append("k_sweep")
    else:
        bad.append("k_sweep (no checkpoint)")

    r = run("bench_stress_attention", bench_stress_attention.main, [])
    try:
        last = json.loads(r["text"].strip().splitlines()[-1])
    except (IndexError, ValueError):
        last = None
    r["last_line"] = last
    # the planted fault: K7's o at the stress point scaled by 0.85 must fail
    # the check the tool's readings pass (relative L2 of o against SDPA)
    from crossscore_tpu_torch.ops.flash_attention import flash_attention_head_major

    q, k, v = bench_stress_attention.inputs(torch.device("cuda"), 74, torch.bfloat16)
    want = torch.nn.functional.scaled_dot_product_attention(q, k, v)
    r["planted"] = bench_stress_attention.errors(0.85 * flash_attention_head_major(q, k, v)[0], want)
    r["planted"]["caught"] = r["planted"]["rel_l2_vs_sdpa"] > TOL_L2["bfloat16"]
    del q, k, v, want
    if r["rc"] != 0 or last is None or set(last["kernels"]) != {"head-major K7", "layout-native K3"} \
            or any(x["rel_l2_vs_sdpa"] > TOL_L2["bfloat16"] for x in last["kernels"].values()) \
            or not (r["launches"].get("K3") and r["launches"].get("K7")) or not r["planted"]["caught"]:
        bad.append("bench_stress_attention")

    for tag, r in res.items():
        text = r.pop("text")
        print(f"step 20 (c) tools.{tag}: exit {r['rc']} in {r['s']:.1f} s, launches {r['launches']} (of them in "
              f"{len(r['children'])} child processes, [import s, s] each {r['children']}); "
              f"its last line: {text.strip().splitlines()[-1] if text.strip() else None}")
        if any(b.startswith(tag) for b in bad):
            print(f"step 20 (c) tools.{tag} output, the last 3000 characters:\n{text[-3000:]}")
    o = res["overfit_convergence"]
    print(f"step 20 (c) overfit: step {o['final_step']} L1 {o['final_l1']} corr {o['final_corr']} (best "
          f"{o['best_corr']}), {o['ms_per_step']} ms/step (wall clock, loader in the loop)")
    print(f"step 20 (c) A/B arms: {res['ab_token_vs_pixel']['arms']}")
    st = res["bench_stress_attention"]
    print(f"step 20 (c) stress point against SDPA (relative L2 of o, bound {TOL_L2['bfloat16']:g}): "
          + ", ".join(f"{name} {x['rel_l2_vs_sdpa']:.3e} (max |d| {x['max_abs_vs_sdpa']:.3e})"
                      for name, x in ((st["last_line"] or {}).get("kernels") or {}).items())
          + f"; planted, K7's o x 0.85: {st['planted']['rel_l2_vs_sdpa']:.3e} (max |d| "
            f"{st['planted']['max_abs_vs_sdpa']:.3e}), caught {st['planted']['caught']}")
    if bad:
        _fail("step 20 (c): " + ", ".join(bad))
    return res


def _quality_phases(torch, F, dev, peaks, zero_launches, read_launches) -> dict:
    """Step 20, the training-quality workflow: (a) the kernels at hd 8, (b)
    the train CLI at the tiny geometry, (c) the quality tools at full width.
    Returns the readings."""
    import tempfile

    t0 = time.perf_counter()
    out = {"hd8": _hd8_phases(torch, F, dev, peaks, zero_launches, read_launches)}
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        out["train_cli"] = _quality_train(torch, zero_launches, read_launches, Path(tmp))
        torch.cuda.empty_cache()
        out["tools"] = _quality_tools(torch, zero_launches, read_launches, Path(tmp))
    out["s"] = time.perf_counter() - t0
    print(f"step 20: {out['s']:.1f} s")
    return out


def _ulps(torch, got, want) -> int:
    """The largest distance between two tensors of one float dtype in units
    in its last place (bit patterns ordered as their values)."""
    bits, mask = (torch.int16, 0x7FFF) if got.dtype == torch.bfloat16 else (torch.int32, 0x7FFFFFFF)
    a, b = (t.contiguous().view(bits).long() for t in (got, want))
    a, b = (torch.where(v < 0, -(v & mask), v) for v in (a, b))
    return int((a - b).abs().max())


def _wave_rows(torch) -> int:
    """Rows of one 128-row tile more than the card has SMs, the last tile
    77 rows: Q2's persistent blocks (one a SM) then take unequal runs of
    tiles at every width."""
    return (torch.cuda.get_device_properties(0).multi_processor_count) * 128 + 77


def _int8_kernels(torch, F, dev, rows_main: int, peaks) -> tuple[dict, list]:
    """Step 21 (a): Q1 and Q2 against their plain versions, the planted
    scale, and their times at the predict point's products."""
    from crossscore_tpu_torch.ops import quant

    peak_bf16, peak_bw = peaks
    peak_int8 = 2 * peak_bf16  # Hopper's dense int8 rate is twice its bf16 rate
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    bad, res = [], {"Q1": {"cases": 0, "reruns_bit_equal": True, "max_abs_err": 0.0},
                    "Q2": {"cases": 0, "not_bit_equal": 0, "elements_not_bit_equal": 0, "max_ulps": 0,
                           "reruns_bit_equal": True, "max_abs_err": 0.0}}

    def activation(rows, k, dtype):
        x = torch.randn(rows, k, generator=gen, device=dev) * 2
        x[0, :6] = torch.tensor([127.0, 2.5, -3.5, 0.5, -1.5, 126.5], device=dev)  # ties at s = 1
        if rows > 1:
            x[1] = 0  # the eps scale
        return x.to(dtype)

    def weight(n, k):
        return torch.randn(n, k, generator=gen, device=dev) / k ** 0.5

    # Q1: codes and scales bit-equal to the plain version, and a rerun's bits
    q1_cases = [(rows_main, k, dt) for k in (384, 1536) for dt in (torch.bfloat16, torch.float32)]
    q1_cases += [(r, k, dt) for r in INT8_ROWS for k in (64, 768, 1024, 4096) for dt in (torch.bfloat16, torch.float32)]
    q1_cases += [(n, k, torch.float32) for k, n in INT8_PRODUCTS.values()]  # the fp32 weights
    for rows, k, dt in q1_cases:
        x = activation(rows, k, dt)
        (q, s), same = _twice(quant.quantize_rowwise, x)
        qp, sp = quant.quantize_rowwise_plain(x)
        res["Q1"]["cases"] += 1
        res["Q1"]["reruns_bit_equal"] &= same
        # the codes' and the scales' largest |kernel - plain|
        res["Q1"]["max_abs_err"] = max(res["Q1"]["max_abs_err"], _max_abs(q, qp), _max_abs(s, sp))
        if not (torch.equal(q, qp) and torch.equal(s, sp) and same):
            bad.append(f"Q1 ({rows}, {k}) {dt}: {int((q != qp).sum())} codes, {int((s != sp).sum())} scales off, "
                       f"rerun bit-equal {same}")
    # Q2 on the plain version's codes: within one ulp (bit-equal expected), a rerun's bits
    dtypes = (torch.bfloat16, torch.float32)
    q2_cases = [(rows_main, k, n, dt, True) for k, n in INT8_PRODUCTS.values() for dt in dtypes]
    q2_cases += [(rows_main, 384, 1536, torch.bfloat16, False)]
    q2_cases += [(r, k, n, dt, True) for r in INT8_ROWS for k, n in INT8_WIDTHS for dt in dtypes]
    wave = _wave_rows(torch)
    q2_cases += [(wave, k, n, dt, True) for k, n in (*INT8_WIDTHS, *INT8_PRODUCTS.values()) for dt in dtypes]
    for rows, k, n, dt, with_bias in q2_cases:
        xq, sx = quant.quantize_rowwise_plain(activation(rows, k, dt))
        wq, sw = quant.quantize_rowwise_plain(weight(n, k))
        bias = (torch.randn(n, generator=gen, device=dev) * 0.1).to(dt) if with_bias else None
        got, same = _twice(lambda *a: (quant.int8_linear(*a, bias, dt),), (xq, sx), (wq, sw))
        want = quant.int8_product_plain(xq, sx, wq, sw, bias, dt)
        ulps = _ulps(torch, got[0], want)
        r = res["Q2"]
        r["cases"] += 1
        r["not_bit_equal"] += int(not torch.equal(got[0], want))
        r["elements_not_bit_equal"] += int((got[0] != want).sum())
        r["max_ulps"] = max(r["max_ulps"], ulps)
        r["max_abs_err"] = max(r["max_abs_err"], _max_abs(got[0], want))
        r["reruns_bit_equal"] &= same
        if ulps > 1 or not same:
            bad.append(f"Q2 ({rows}, {k} -> {n}) {dt}: {ulps} ulps, rerun bit-equal {same}")
    print(f"step 21 (a) Q1 against its plain version over {res['Q1']['cases']} cases (98,640 rows at K 384 and "
          f"1536, rows {INT8_ROWS} at K 64-4096, bf16 and fp32, the fp32 weights): codes and scales bit-equal "
          f"{not any(b.startswith('Q1') for b in bad)}, reruns bit-equal {res['Q1']['reruns_bit_equal']}; Q2 over "
          f"{res['Q2']['cases']} cases (also {wave} rows, a ragged last wave of its persistent grid): max "
          f"{res['Q2']['max_ulps']} ulps (limit 1), {res['Q2']['elements_not_bit_equal']} elements in "
          f"{res['Q2']['not_bit_equal']} cases not bit-equal, reruns bit-equal {res['Q2']['reruns_bit_equal']}")

    # the planted fault: Q1 with the scale absmax / 126 must be caught, by
    # Q1's check and through Q2 by the linear's
    k, n = INT8_PRODUCTS["fc1"]
    x, w = activation(rows_main, k, torch.bfloat16), weight(n, k)
    bias = (torch.randn(n, generator=gen, device=dev) * 0.1).to(torch.bfloat16)
    q_bad, s_bad = quant._launch_q1(x, 126.0)
    qp, sp = quant.quantize_rowwise_plain(x)
    y_bad = quant.int8_linear((q_bad, s_bad), quant.quantize_rowwise(w), bias, torch.bfloat16)
    planted = {"codes_off": int((q_bad != qp).sum()), "scales_off": int((s_bad != sp).sum()),
               "linear_ulps": _ulps(torch, y_bad, quant.int8_linear_plain(x, w, bias))}
    res["planted_scale"] = planted
    print(f"step 21 (a) planted fault, scale absmax / 126 in Q1 at fc1's input: {planted['codes_off']} codes and "
          f"{planted['scales_off']} scales off the plain version's, the linear {planted['linear_ulps']} ulps off")
    if not (planted["codes_off"] and planted["scales_off"] and planted["linear_ulps"] > 1):
        bad.append("the planted scale was not caught")

    # times at the predict point's products, bf16 activations and the fp32
    # weights, as the backbone runs them: in-stream means over back-to-back
    # calls, every operand (the bf16 bias too) made before the timed calls
    res["products"] = {}
    for tag, (k, n) in INT8_PRODUCTS.items():
        x, w = activation(rows_main, k, torch.bfloat16), weight(n, k)
        bias = torch.randn(n, generator=gen, device=dev) * 0.1
        b16, w16 = bias.to(torch.bfloat16), w.to(torch.bfloat16)
        xq, sx = quant.quantize_rowwise(x)
        wq, sw = quant.quantize_rowwise(w)
        m = rows_main
        q1 = {"ms": _stream_ms(torch, lambda: quant.quantize_rowwise(x)),
              "plain_ms": _stream_ms(torch, lambda: quant.quantize_rowwise_plain(x), calls=5),
              "weight_ms": _stream_ms(torch, lambda: quant.quantize_rowwise(w)), "library_ms": None,
              **_bound(0.0, m * k * 2 + m * k + m * 4, peak_int8, peak_bw)}
        q2 = {"ms": _stream_ms(torch, lambda: quant.int8_linear((xq, sx), (wq, sw), b16, torch.bfloat16)),
              "plain_ms": _stream_ms(torch, lambda: quant.int8_product_plain(xq, sx, wq, sw, b16, torch.bfloat16),
                                     calls=5),
              "library_ms": _stream_ms(torch, lambda: (torch._int_mm(xq, wq.t()).float() * sx * sw.t()).to(
                  torch.bfloat16) + b16),
              "int_mm_ms": _stream_ms(torch, lambda: torch._int_mm(xq, wq.t())),
              "bf16_linear_ms": _stream_ms(torch, lambda: F.linear(x, w16, b16)),
              "linear_ms": _stream_ms(torch, lambda: quant.int8_linear(x, w, b16)),
              **_bound(2.0 * m * k * n, m * k + n * k + 4 * (m + n) + 2 * n + 2 * m * n, peak_int8, peak_bw)}
        res["products"][tag] = {"Q1": q1, "Q2": q2, "shape": f"x ({m}, {k}) bf16, weight ({n}, {k}) fp32"}
        print(f"step 21 (a) {tag} ({m} x {k} -> {n}): Q1 on x {q1['ms']:.3f} ms (plain {q1['plain_ms']:.3f}, bound "
              f"{q1['bound_ms']:.3f} {q1['bound_by']}), on the weight {q1['weight_ms']:.3f}; Q2 {q2['ms']:.3f} ms "
              f"({2.0 * m * k * n / q2['ms'] / 1e9:.0f} TOP/s; plain {q2['plain_ms']:.3f}, torch._int_mm + dequant "
              f"{q2['library_ms']:.3f}, torch._int_mm alone {q2['int_mm_ms']:.3f}, bound {q2['bound_ms']:.3f} "
              f"{q2['bound_by']}); the int8 linear {q2['linear_ms']:.3f} against bf16 F.linear "
              f"{q2['bf16_linear_ms']:.3f}")
    return res, bad


def _int8_rows(int8: dict) -> list:
    """The kernels line's rows of Q1 and Q2 from step 21's readings: the
    port's own kernels (the JAX package leaves these functions to XLA); the
    main path's launches are the int8 predict step's."""
    ik, rows = int8["kernels"], []
    for kern, fn, replaces, err in (
            ("Q1", "quantize_rowwise", "crossscore_tpu/ops/quant.py:35", "bit-equal codes and scales"),
            ("Q2", "int8_linear", "crossscore_tpu/ops/quant.py:51", "ulps of the output dtype")):
        r = ik["products"]["fc1"][kern]
        row = {"name": fn, "route": "cuda", "source": "crossscore_tpu_torch/csrc/int8_linear.cu",
               "replaces": replaces, "pallas_counterpart": None,
               "launches": int8["predict_step"]["launches"].get(kern, 0),
               "max_abs_err": ik[kern]["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
               "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"],
               "err_kind": err, "shape": ik["products"]["fc1"]["shape"],
               "products": {tag: v[kern] for tag, v in ik["products"].items()},
               "launches_by_path": {"int8_predict": int8["predict_step"]["launches"].get(kern, 0),
                                    "int8_predict_cli_c": int8["predict_cli"]["int8"]["launches"].get(kern, 0),
                                    "int8_vitl_forward": int8["vitl"]["launches"].get(kern, 0),
                                    "matmul_microbench": int8["matmul_microbench"]["launches"].get(kern, 0)}}
        if kern == "Q2":
            row["max_ulps"], row["cases_not_bit_equal"] = ik["Q2"]["max_ulps"], ik["Q2"]["not_bit_equal"]
            row["elements_not_bit_equal"] = ik["Q2"]["elements_not_bit_equal"]
        rows.append(row)
    return rows


def _backbone_split(torch, fn) -> dict:
    """Device ms of one call of ``fn`` by group: Q1, Q2, K1 and the rest
    (``tools/trace_breakdown.py::kernel_group``'s names)."""
    from torch.profiler import ProfilerActivity, profile

    from crossscore_tpu_torch.tools.trace_breakdown import kernel_group

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    split: dict = {}
    for evt in prof.key_averages():
        if "CUDA" not in str(evt.device_type):
            continue
        dev_us = getattr(evt, "self_device_time_total", None)
        dev_us = evt.self_cuda_time_total if dev_us is None else dev_us
        if dev_us > 0:
            g = kernel_group(evt.key)
            split[g] = split.get(g, 0.0) + dev_us / 1e3
    if not split:
        _fail("the profiler recorded no kernel of the int8 backbone")
    return split


def _int8_phases(torch, F, dev, card: str, peaks, params, zero_launches, read_launches) -> dict:
    """Step 21, the int8 W8A8 backbone: (a) Q1 and Q2 against their plain
    versions (:func:`_int8_kernels`); (b) the int8 predict step at the
    headline point beside the unquantised one, both from ``params`` (step
    4's seeded init) on seeded uint8 images, then the pixel train step at
    the train point, int8 beside unquantised; (c) the predict CLI, mode (c),
    with and without int8; (d) ``tools.matmul_microbench``; (e) dinov2-large
    at 1036 px, K=5, B=1, int8 beside bf16. Returns the readings."""
    import dataclasses
    import io
    import tempfile

    import numpy as np
    from PIL import Image

    from crossscore_tpu_torch.confsys import load_config
    from crossscore_tpu_torch.io.convert import init_params, load_into
    from crossscore_tpu_torch.models import CrossScoreConfig, CrossScoreNet
    from crossscore_tpu_torch.models.crossscore import make_backbone_encoder
    from crossscore_tpu_torch.tasks.predict import main as predict_main
    from crossscore_tpu_torch.tools import matmul_microbench, stress_vitl
    from crossscore_tpu_torch.train.optim import make_optimizer
    from crossscore_tpu_torch.train.step import TrainState, make_predict_step, make_train_step

    t_all = time.perf_counter()
    out: dict = {}
    cfg = CrossScoreConfig()
    vit, n_dec = cfg.backbone, 2 * cfg.decoder_layers
    views = B * (1 + K)
    out["kernels"], bad = _int8_kernels(torch, F, dev, views * ((HW // vit.patch_size) ** 2 + 1), peaks)
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    query = torch.randint(0, 256, (B, HW, HW, 3), generator=gen, device=dev, dtype=torch.uint8)
    refs = torch.randint(0, 256, (B, K, HW, HW, 3), generator=gen, device=dev, dtype=torch.uint8)
    torch.cuda.empty_cache()

    def tier(got, want) -> tuple[float, float]:
        d = (got.float() - want.float()).abs()
        return float(d.mean()), float(d.max())

    # --- (b) the int8 predict step at the headline point -----------------------
    cfg8 = dataclasses.replace(cfg, backbone_quant="int8")  # mlp_impl "fused" requested
    nets = {"default": load_into(CrossScoreNet(cfg, device=dev), params),
            "int8": load_into(CrossScoreNet(cfg8, device=dev), params)}
    steps = {tag: make_predict_step(net) for tag, net in nets.items()}
    maps, launches = {}, {}
    for tag, step in steps.items():
        zero_launches()
        maps[tag] = step(query, refs)["score_map_ref_cross"]
        torch.cuda.synchronize()
        launches[tag] = read_launches()
    q_per = 4 * vit.num_layers  # qkv, out, fc1, fc2
    want = _launches(K1=vit.num_layers, K3=n_dec, Q1=2 * q_per, Q2=q_per)
    s8 = maps["int8"]
    mae, mx = tier(s8, maps["default"])
    b = {"launches": {k: v for k, v in launches["int8"].items() if v}, "expected": {k: v for k, v in want.items() if v},
         "mae_vs_default": mae, "max_vs_default": mx}
    ok = (launches["int8"] == want and tuple(s8.shape) == (B, HW, HW) and bool(torch.isfinite(s8).all())
          and 0.0 <= float(s8.min()) <= float(s8.max()) <= 1.0 and mae < INT8_TIER[0] and mx < INT8_TIER[1])
    times = {}
    for tag in ("default", "int8", "int8", "default"):  # in turns
        times.setdefault(tag, []).extend(_event_times(torch, lambda s=steps[tag]: s(query, refs), reps=5))
    for tag, ts in times.items():
        ts = sorted(ts)
        b[tag] = {"ms": ts[len(ts) // 2], "spread_ms": [ts[0], ts[-1]], "maps_per_s": 1e3 * B / ts[len(ts) // 2]}
    encode = make_backbone_encoder(cfg8)
    imgs = torch.cat([query[:, None], refs], dim=1).reshape(views, HW, HW, 3)
    b["backbone_split_ms"] = _backbone_split(torch, lambda: encode(nets["int8"], imgs))
    b["backbone_split_ms_default"] = _backbone_split(torch, lambda: make_backbone_encoder(cfg)(nets["default"], imgs))
    out["predict_step"] = b
    print(f"step 21 (b) int8 predict step (dinov2-small, {HW} px, K={K}, B={B}, bf16, mlp_impl fused requested): "
          f"launches {b['launches']} (expected {b['expected']}); score map against the unquantised step: MAE "
          f"{mae:.3e} (tier {INT8_TIER[0]:g}), max {mx:.3e} (tier {INT8_TIER[1]:g}); int8 {b['int8']['ms']:.2f} ms "
          f"= {b['int8']['maps_per_s']:.2f} maps/s (spread {b['int8']['spread_ms'][0]:.2f}-"
          f"{b['int8']['spread_ms'][1]:.2f}), default {b['default']['ms']:.2f} ms = {b['default']['maps_per_s']:.2f} "
          f"maps/s (spread {b['default']['spread_ms'][0]:.2f}-{b['default']['spread_ms'][1]:.2f}), median of 10 "
          f"in turns; {card}")
    for tag in ("backbone_split_ms", "backbone_split_ms_default"):
        print(f"step 21 (b) {'int8' if tag == 'backbone_split_ms' else 'default'} backbone device ms over {views} "
              "views: " + ", ".join(f"{g} {v:.3f}" for g, v in sorted(b[tag].items(), key=lambda kv: -kv[1])))
    if not ok:
        bad.append("(b) the int8 predict step: launches, score map or tier")
    del nets, steps, maps
    torch.cuda.empty_cache()

    # the int8 pixel train step at the train operating point (B=24, K=5),
    # beside the unquantised one: K4 per decoder layer, Q1/Q2 per backbone
    # forward, the loss finite, the backbone frozen, the decoder updated
    tcfg = load_config("default")
    tbatch = {
        "query/img": torch.randint(0, 256, (TB, HW, HW, 3), generator=gen, device=dev, dtype=torch.uint8),
        "reference/cross/imgs": torch.randint(0, 256, (TB, TK, HW, HW, 3), generator=gen, device=dev,
                                              dtype=torch.uint8),
        "query/score_map": torch.rand(TB, HW, HW, generator=gen, device=dev),
        "_valid": torch.tensor(TB, device=dev),
    }
    train, tsteps = {}, {}
    for tag, c_ in (("default", cfg), ("int8", cfg8)):
        tnet = load_into(CrossScoreNet(c_, device=dev), params)
        optimizer, scheduler, _ = make_optimizer(tcfg, tnet, steps_per_epoch=1)
        tsteps[tag] = make_train_step(tnet, optimizer, scheduler)
        before = {k_: v.detach().clone() for k_, v in tnet.state_dict().items()}
        zero_launches()
        state, metrics = tsteps[tag](TrainState(), tbatch)
        torch.cuda.synchronize()
        got = read_launches()
        after = tnet.state_dict()
        frozen = [k_ for k_ in after if k_.startswith("backbone.") or k_ == "pos_enc_fn.PE"]
        trained = [k_ for k_, prm in tnet.named_parameters() if prm.requires_grad]
        train[tag] = {"loss": float(metrics["loss"]), "launches": {k_: v for k_, v in got.items() if v},
                      "frozen_moved": sum(not torch.equal(after[k_], before[k_]) for k_ in frozen),
                      "trained_unmoved": sum(torch.equal(after[k_], before[k_]) for k_ in trained),
                      "state": state}
        del before, after, metrics
    want_t = {"default": _launches(K1=vit.num_layers, K2=vit.num_layers, K3=n_dec, K4=n_dec),
              "int8": _launches(K1=vit.num_layers, K3=n_dec, K4=n_dec, Q1=2 * q_per, Q2=q_per)}
    times = {}
    for tag in ("default", "int8", "int8", "default"):  # in turns
        times.setdefault(tag, []).extend(_event_times(
            torch, lambda s=tsteps[tag], st=train[tag]["state"]: s(st, tbatch), reps=3))
    for tag, ts in times.items():
        ts = sorted(ts)
        train[tag].pop("state")
        train[tag].update(ms=ts[len(ts) // 2], spread_ms=[ts[0], ts[-1]],
                          expected={k_: v for k_, v in want_t[tag].items() if v})
    b["train_step"] = train
    t8, t0_ = train["int8"], train["default"]
    print(f"step 21 (b) int8 pixel train step (B={TB}, K={TK}, {HW} px, bf16): launches {t8['launches']} (expected "
          f"{t8['expected']}); loss {t8['loss']:.6f} against {t0_['loss']:.6f} unquantised; backbone/PE tensors "
          f"moved {t8['frozen_moved']}, decoder/head tensors not updated {t8['trained_unmoved']}; int8 "
          f"{t8['ms']:.2f} ms (spread {t8['spread_ms'][0]:.2f}-{t8['spread_ms'][1]:.2f}), default {t0_['ms']:.2f} "
          f"ms (spread {t0_['spread_ms'][0]:.2f}-{t0_['spread_ms'][1]:.2f}), median of 6 in turns; {card}")
    for tag in ("default", "int8"):
        r_ = train[tag]
        if r_["launches"] != r_["expected"] or not np.isfinite(r_["loss"]) or r_["frozen_moved"] \
                or r_["trained_unmoved"]:
            bad.append(f"(b) the {tag} pixel train step: launches, loss or parameters")
    del tsteps, tbatch
    torch.cuda.empty_cache()

    # --- (c) the predict CLI, mode (c), with and without int8 ------------------
    n_b = 2
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        qdir, rdir = _write_predict_dirs(tmp, n_b * PB, PK)
        pcfg = CrossScoreConfig.from_config(load_config("default_predict"))
        ckpt = tmp / "run" / "ckpt" / "seeded.ckpt"
        ckpt.parent.mkdir(parents=True)
        torch.save({"state_dict": {f"model.{k}": v.cpu() for k, v in init_params(pcfg, SEED).items()}}, ckpt)
        common = [f"trainer.ckpt_path_to_load={ckpt}", f"data.dataset.query_dir={qdir}",
                  f"data.dataset.reference_dir={rdir}", f"data.neighbour_config.cross={PK}",
                  f"data.loader.validation.batch_size={PB}", "this_main.shape_buckets=on",
                  "this_main.ref_token_cache=on", "logger.predict.write.config.score_map_colour_mode=gray",
                  "logger.predict.write.config.vis_img_every_n_steps=-1",
                  "logger.predict.write.flag.image_query=false", "logger.predict.write.flag.image_reference=false"]
        c = {}
        for quant_mode in ("none", "int8"):
            tee = _Tee(sys.stdout)
            zero_launches()
            with contextlib.redirect_stdout(tee):
                run = predict_main(common + [f"model.gpu.backbone_quant={quant_mode}",
                                             f"logger.predict.out_dir={tmp}/out_{quant_mode}"])
            torch.cuda.synchronize()
            rate = re.search(r"= ([0-9.]+) maps/s", "".join(tee.text))
            c[quant_mode] = {"launches": {k: v for k, v in read_launches().items() if v},
                             "maps_per_s": float(rate.group(1)),
                             "maps": sorted((run / "batch" / "score_map_ref_cross").glob("*.png"))}
        enc = vit.num_layers * (n_b + 1)  # a cached run encodes one miss batch more
        wants = {"none": {"K2": enc, "K5": enc, "K6": n_dec * n_b},
                 "int8": {"K5": enc, "K6": n_dec * n_b, "Q1": 8 * enc, "Q2": 4 * enc}}
        names = [p.name for p in c["none"]["maps"]]
        diffs = [np.abs(np.asarray(Image.open(x)).astype(np.float64) - np.asarray(Image.open(y)).astype(np.float64))
                 / 65535.0 for x, y in zip(c["int8"]["maps"], c["none"]["maps"])]  # [0, 1] scores, uint16
        c["mae"] = float(np.mean([dd.mean() for dd in diffs]))
        c["max"] = float(max(dd.max() for dd in diffs))
        for tag in ("none", "int8"):
            c[tag]["n_maps"] = len(c[tag].pop("maps"))
        print(f"step 21 (c) predict CLI (c) buckets on, cache on, {n_b * PB} maps: int8 launches "
              f"{c['int8']['launches']} (expected {wants['int8']}), {c['int8']['maps_per_s']:.2f} maps/s; without "
              f"int8 {c['none']['launches']} (expected {wants['none']}), {c['none']['maps_per_s']:.2f} maps/s; maps "
              f"int8 against none: MAE {c['mae']:.3e}, max {c['max']:.3e} (tier {INT8_TIER[0]:g}, {INT8_TIER[1]:g})")
        if c["none"]["launches"] != wants["none"] or c["int8"]["launches"] != wants["int8"] \
                or {c["none"]["n_maps"], c["int8"]["n_maps"], len(names)} != {n_b * PB} \
                or not (c["mae"] < INT8_TIER[0] and c["max"] < INT8_TIER[1]):
            bad.append("(c) the predict CLI under int8")
        out["predict_cli"] = c

    # --- (d) tools.matmul_microbench through its entry point -------------------
    t0 = time.perf_counter()
    buf = io.StringIO()
    zero_launches()
    with contextlib.redirect_stdout(buf):
        rc = matmul_microbench.main([])
    torch.cuda.synchronize()
    lines = buf.getvalue().splitlines()
    timed = [x for x in lines if " ms " in x and ("TOP/s" in x or "TFLOP/s" in x)]
    d = {"rc": rc, "s": time.perf_counter() - t0, "launches": {k: v for k, v in read_launches().items() if v},
         "lines": lines}
    out["matmul_microbench"] = d
    print("step 21 (d) tools.matmul_microbench:\n  " + "\n  ".join(lines))
    print(f"step 21 (d) exit {rc} in {d['s']:.1f} s, launches {d['launches']}")
    if rc != 0 or len(timed) != len(matmul_microbench.PRODUCTS) * len(matmul_microbench.MODES) \
            or not d["launches"].get("Q1") or not d["launches"].get("Q2"):
        bad.append("(d) matmul_microbench")

    # --- (e) dinov2-large at 1036 px, K=5, B=1: int8 beside bf16 -------------
    _, mcfg_l, model_l = stress_vitl.build("dinov2-large", [], dev, SEED)
    vit_l = mcfg_l.backbone
    model_l8 = load_into(CrossScoreNet(dataclasses.replace(mcfg_l, backbone_quant="int8"), device=dev),
                         model_l.state_dict())
    batch = stress_vitl.make_batch(gen, dev, 1, VITL_K, VITL_HW, vit_l.hidden_size)
    q, r = batch["query/img"], batch["reference/cross/imgs"]
    steps = {"bf16": make_predict_step(model_l), "int8": make_predict_step(model_l8)}
    zero_launches()
    s8 = steps["int8"](q, r)["score_map_ref_cross"]
    torch.cuda.synchronize()
    got_l = read_launches()
    q_per = 4 * vit_l.num_layers
    want_l = _launches(K1=vit_l.num_layers, K3=2 * mcfg_l.decoder_layers, Q1=2 * q_per, Q2=q_per)
    mae, mx = tier(s8, steps["bf16"](q, r)["score_map_ref_cross"])
    times = {}
    for tag in ("bf16", "int8", "int8", "bf16"):
        times.setdefault(tag, []).extend(_event_times(torch, lambda s=steps[tag]: s(q, r), reps=3))
    e = {"launches": {k: v for k, v in got_l.items() if v}, "mae_vs_bf16": mae, "max_vs_bf16": mx}
    for tag, ts in times.items():
        ts = sorted(ts)
        e[tag] = {"ms": ts[len(ts) // 2], "spread_ms": [ts[0], ts[-1]]}
    out["vitl"] = e
    print(f"step 21 (e) dinov2-large at {VITL_HW} px, K={VITL_K}, B=1 forward: int8 {e['int8']['ms']:.2f} ms (spread "
          f"{e['int8']['spread_ms'][0]:.2f}-{e['int8']['spread_ms'][1]:.2f}) against bf16 {e['bf16']['ms']:.2f} "
          f"(spread {e['bf16']['spread_ms'][0]:.2f}-{e['bf16']['spread_ms'][1]:.2f}), median of 6 in turns; int8 "
          f"launches {e['launches']} (expected {({k: v for k, v in want_l.items() if v})}); score map against bf16 "
          f"MAE {mae:.3e}, max {mx:.3e} (reported); {card}")
    if got_l != want_l or not bool(torch.isfinite(s8).all()) or not 0.0 <= float(s8.min()) <= float(s8.max()) <= 1.0:
        bad.append("(e) the ViT-L int8 forward")
    del model_l, model_l8, steps, batch, q, r, s8
    torch.cuda.empty_cache()

    out["s"] = time.perf_counter() - t_all
    print(f"step 21: {out['s']:.1f} s")
    if bad:
        _fail("step 21: " + "; ".join(bad))
    return out


@contextlib.contextmanager
def _drop_max_reduce():
    """The planted fault of the int8 row layer: its all-reduce MAX of the
    absmaxes left out, every other collective untouched, so each rank
    quantises its shard at its own scales."""
    import torch.distributed as dist

    import crossscore_tpu_torch.parallel.tensor_parallel as tp

    real = tp.all_reduce
    tp.all_reduce = lambda t, op=dist.ReduceOp.SUM, group=None: t if op == dist.ReduceOp.MAX else real(t, op, group)
    try:
        yield
    finally:
        tp.all_reduce = real


@contextlib.contextmanager
def _row_products(check=None):
    """Every call of the backbone's int8 row layer recorded as (x, weight,
    bias, output); with ``check``, each call's ``check(*record)`` kept instead."""
    from crossscore_tpu_torch.models import dinov2

    real, seen = dinov2.int8_row_linear, []

    def record(x, w, b, group):
        y = real(x, w, b, group)
        seen.append((x, w, b, y) if check is None else check(x, w, b, y))
        return y

    dinov2.int8_row_linear = record
    try:
        yield seen
    finally:
        dinov2.int8_row_linear = real


def _tp_int8_rank(batch1_np: dict, batch2_np: dict) -> dict:
    """One rank of TP = 2 under int8 (gloo; the ranks share the card), the
    seeded dinov2-small net with every backbone product split (``unfused``):
    (i) the fp32 B=1 forward -> its score map and launches; its first
    block's out and fc2 products against the one-rank int8 linear on the
    operands gathered over the group, and again with the MAX all-reduce left
    out (the planted fault); (ii) one bf16 B=2 train step -> the loss, the
    score map, the launches and ms/step."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from crossscore_tpu_torch.confsys import load_config
    from crossscore_tpu_torch.io.convert import init_params, load_into
    from crossscore_tpu_torch.models import CrossScoreConfig, CrossScoreNet
    from crossscore_tpu_torch.ops.quant import int8_linear
    from crossscore_tpu_torch.parallel import mesh
    from crossscore_tpu_torch.parallel.collectives import all_gather
    from crossscore_tpu_torch.parallel.tensor_parallel import int8_row_linear, shard_state_dict
    from crossscore_tpu_torch.train.optim import make_optimizer
    from crossscore_tpu_torch.train.step import TrainState, make_predict_step, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _, dev = mesh.init_distributed("gloo", "cuda")
    try:
        mesh.make_groups(2)
        group = mesh.model_group()
        rank, mp = dist.get_rank(group), dist.get_world_size(group)
        wrappers = _rank_launches()

        def zero():
            for w in wrappers.values():
                w.launches = 0

        out = {}
        cfg = CrossScoreConfig(compute_dtype=torch.float32, attention_impl="tp", mlp_impl="unfused",
                               backbone_quant="int8")
        model = load_into(CrossScoreNet(cfg, device=dev),
                          shard_state_dict(init_params(cfg, SEED, dev), rank, mp, cfg.mlp_impl))
        q, r = (torch.from_numpy(batch1_np[k]).to(dev) for k in ("query/img", "reference/cross/imgs"))
        zero()
        with _row_products() as seen:
            out["map"] = make_predict_step(model)(q, r)["score_map_ref_cross"].cpu().numpy()
        torch.cuda.synchronize()
        out["launches_fp32_b1"] = {k: w.launches for k, w in wrappers.items()}
        rows = []
        with torch.inference_mode():
            for tag, (x, w, b, y) in zip(("out", "fc2"), seen[:2]):  # block 0's two row-parallel products
                want = int8_linear(all_gather(x, group, dim=-1), all_gather(w, group, dim=-1), b)
                with _drop_max_reduce():
                    y_bad = int8_row_linear(x, w, b, group)
                rows.append({"product": tag, "x": list(x.shape), "bit_equal": bool(torch.equal(y, want)),
                             "max_abs": float((y - want).abs().max()),
                             "planted_elements_off": int((y_bad != want).sum()), "elements": want.numel()})
        out["row_products"] = rows
        del model, seen
        torch.cuda.empty_cache()

        cfg16 = dataclasses.replace(cfg, compute_dtype=torch.bfloat16)
        model = load_into(CrossScoreNet(cfg16, device=dev),
                          shard_state_dict(init_params(cfg16, SEED, dev), rank, mp, cfg16.mlp_impl))
        optimizer, scheduler, _ = make_optimizer(load_config("default"), model, steps_per_epoch=1)
        step = make_train_step(model, optimizer, scheduler)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in batch2_np.items()}
        zero()
        state, metrics = step(TrainState(), batch)
        torch.cuda.synchronize()
        out.update(launches_bf16_b2_step={k: w.launches for k, w in wrappers.items()}, loss=float(metrics["loss"]),
                   pred=metrics["pred"].float().cpu().numpy(),
                   ms=_time_ms(torch, lambda: step(state, batch), reps=3))
        return out
    finally:
        mesh.teardown()


def _tp_int8_kernels(torch, dev, rows_main: int, peaks) -> tuple[dict, list]:
    """Step 22 (a): Q1a, Q1b and Q2's int32 form against their plain
    versions and against Q1 / Q2, reruns bit-equal, and their times beside
    Q1 and Q2 (and bf16 ``F.linear``) at the predict point's products."""
    import torch.nn.functional as F

    from crossscore_tpu_torch.ops import quant

    peak_bf16, peak_bw = peaks
    peak_int8 = 2 * peak_bf16
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    bad = []
    res = {k: {"cases": 0, "reruns_bit_equal": True, "max_abs_err": 0.0} for k in ("Q1a", "Q1b", "Q2s32")}
    res["q1a_q1b_is_q1"] = res["dequant_is_q2_epilogue"] = True

    def activation(rows, k, dtype):
        x = torch.randn(rows, k, generator=gen, device=dev) * 2
        x[0, :6] = torch.tensor([127.0, 2.5, -3.5, 0.5, -1.5, 126.5], device=dev)  # ties at s = 1
        if rows > 1:
            x[1] = 0  # the eps scale
        return x.to(dtype)

    def note(kern, same, err, ok, what):
        r = res[kern]
        r["cases"] += 1
        r["reruns_bit_equal"] &= same
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if not (ok and same):
            bad.append(f"{kern} {what}: not bit-equal to its plain version, or a rerun's bits differ")

    dtypes = (torch.bfloat16, torch.float32)
    q1_cases = [(rows_main, k, dt) for k in (384, 1536) for dt in dtypes]
    q1_cases += [(r, k, dt) for r in INT8_ROWS for k in (64, 768, 1024, 4096) for dt in dtypes]
    q1_cases += [(n, k, torch.float32) for k, n in INT8_PRODUCTS.values()]  # the fp32 weights
    for rows, k, dt in q1_cases:
        x = activation(rows, k, dt)
        (m,), same = _twice(lambda t: (quant.row_absmax(t),), x)
        mp = quant.row_absmax_plain(x)
        note("Q1a", same, _max_abs(m, mp), torch.equal(m, mp), f"({rows}, {k}) {dt}")
        (q, s_), same = _twice(quant.quantize_rowwise_given, x, m)
        qp, sp = quant.quantize_rowwise_given_plain(x, m)
        note("Q1b", same, max(_max_abs(q, qp), _max_abs(s_, sp)), torch.equal(q, qp) and torch.equal(s_, sp),
             f"({rows}, {k}) {dt}")
        q1, s1 = quant.quantize_rowwise(x)
        if not (torch.equal(q, q1) and torch.equal(s_, s1)):
            res["q1a_q1b_is_q1"] = False
            bad.append(f"Q1a then Q1b ({rows}, {k}) {dt} is not Q1")
    q2_cases = [(rows_main, k, n, dt) for k, n in INT8_PRODUCTS.values() for dt in dtypes]
    q2_cases += [(r, k, n, dt) for r in INT8_ROWS for k, n in INT8_WIDTHS for dt in dtypes]
    q2_cases += [(_wave_rows(torch), k, n, dt) for k, n in (*INT8_WIDTHS, *INT8_PRODUCTS.values()) for dt in dtypes]
    for rows, k, n, dt in q2_cases:
        xq, sx = quant.quantize_rowwise_plain(activation(rows, k, dt))
        wq, sw = quant.quantize_rowwise_plain(torch.randn(n, k, generator=gen, device=dev) / k ** 0.5)
        (acc,), same = _twice(lambda a, b: (quant.int8_matmul_s32(a, b),), xq, wq)
        want = quant.int8_matmul_s32_plain(xq, wq)
        note("Q2s32", same, _max_abs(acc, want), torch.equal(acc, want), f"({rows}, {k} -> {n}) {dt}")
        bias = (torch.randn(n, generator=gen, device=dev) * 0.1).to(dt)
        if not torch.equal(quant.dequantize_s32(acc, sx, sw, bias, dt),
                           quant.int8_linear((xq, sx), (wq, sw), bias, dt)):
            res["dequant_is_q2_epilogue"] = False
            bad.append(f"the PyTorch dequantisation of ({rows}, {k} -> {n}) {dt} is not Q2's epilogue")
    print(f"step 22 (a) Q1a, Q1b over {res['Q1a']['cases']} cases each and Q2's int32 form over "
          f"{res['Q2s32']['cases']} (98,640 rows at the predict point's widths, rows {INT8_ROWS} and "
          f"{_wave_rows(torch)}, bf16 and fp32): "
          f"bit-equal to their plain versions {not bad}, reruns bit-equal "
          f"{all(res[k]['reruns_bit_equal'] for k in ('Q1a', 'Q1b', 'Q2s32'))}, Q1a then Q1b is Q1 "
          f"{res['q1a_q1b_is_q1']}, the PyTorch dequantisation of the int32 products is Q2's epilogue "
          f"{res['dequant_is_q2_epilogue']}")

    # times at the predict point's products (bf16 x, fp32 weights), in stream
    res["products"] = {}
    for tag, (k, n) in INT8_PRODUCTS.items():
        m_ = rows_main
        x, w = activation(m_, k, torch.bfloat16), torch.randn(n, k, generator=gen, device=dev) / k ** 0.5
        b16, w16 = (torch.randn(n, generator=gen, device=dev) * 0.1).to(torch.bfloat16), w.to(torch.bfloat16)
        mx = quant.row_absmax(x)
        (xq, sx), (wq, sw) = quant.quantize_rowwise(x), quant.quantize_rowwise(w)
        acc = quant.int8_matmul_s32(xq, wq)
        r = {"Q1a": {"ms": _stream_ms(torch, lambda: quant.row_absmax(x)),
                     "plain_ms": _stream_ms(torch, lambda: quant.row_absmax_plain(x), calls=5),
                     "library_ms": _stream_ms(torch, lambda: torch.linalg.vector_norm(x, float("inf"), dim=-1,
                                                                                     keepdim=True)),
                     **_bound(0.0, m_ * k * 2 + m_ * 4, peak_int8, peak_bw)},
             "Q1b": {"ms": _stream_ms(torch, lambda: quant.quantize_rowwise_given(x, mx)),
                     "plain_ms": _stream_ms(torch, lambda: quant.quantize_rowwise_given_plain(x, mx), calls=5),
                     "library_ms": None, **_bound(0.0, m_ * k * 2 + m_ * 4 + m_ * k + m_ * 4, peak_int8, peak_bw)},
             "Q2s32": {"ms": _stream_ms(torch, lambda: quant.int8_matmul_s32(xq, wq)),
                       "plain_ms": _stream_ms(torch, lambda: quant.int8_matmul_s32_plain(xq, wq), calls=5),
                       "library_ms": _stream_ms(torch, lambda: torch._int_mm(xq, wq.t())),
                       "dequant_ms": _stream_ms(torch, lambda: quant.dequantize_s32(acc, sx, sw, b16, torch.bfloat16)),
                       **_bound(2.0 * m_ * k * n, m_ * k + n * k + 4 * m_ * n, peak_int8, peak_bw)},
             "Q1_ms": _stream_ms(torch, lambda: quant.quantize_rowwise(x)),
             "Q2_ms": _stream_ms(torch, lambda: quant.int8_linear((xq, sx), (wq, sw), b16, torch.bfloat16)),
             "bf16_linear_ms": _stream_ms(torch, lambda: F.linear(x, w16, b16)),
             "shape": f"x ({m_}, {k}) bf16, weight ({n}, {k}) fp32"}
        res["products"][tag] = r
        print(f"step 22 (a) {tag} ({m_} x {k} -> {n}): Q1a {r['Q1a']['ms']:.3f} ms (plain {r['Q1a']['plain_ms']:.3f}, "
              f"vector_norm(inf) {r['Q1a']['library_ms']:.3f}, bound {r['Q1a']['bound_ms']:.3f}), Q1b "
              f"{r['Q1b']['ms']:.3f} (plain {r['Q1b']['plain_ms']:.3f}, bound {r['Q1b']['bound_ms']:.3f}) beside Q1 "
              f"{r['Q1_ms']:.3f}; Q2's int32 form {r['Q2s32']['ms']:.3f} (plain {r['Q2s32']['plain_ms']:.3f}, "
              f"torch._int_mm {r['Q2s32']['library_ms']:.3f}, bound {r['Q2s32']['bound_ms']:.3f} "
              f"{r['Q2s32']['bound_by']}) + the PyTorch dequantisation {r['Q2s32']['dequant_ms']:.3f} beside Q2 "
              f"{r['Q2_ms']:.3f} and bf16 F.linear {r['bf16_linear_ms']:.3f}")
    return res, bad


def _hd128_modes(torch, F, dev, peaks, zero_launches, read_launches) -> tuple[dict, list]:
    """Step 22 (d): K11 (probes and chunks) and K7' at hd 128 against their
    plain versions (step 3's tolerances at hd 48/64), each launched twice for
    the same bits, timed beside K1 / K7 at hd 128 and the bound."""
    from crossscore_tpu_torch.ops import flash_attention as fa

    peak_bf16, peak_bw, peak_ex2 = peaks
    gen = torch.Generator(device=dev).manual_seed(SEED + 12)

    def bound(ops, nbytes, exps=0.0):
        return _bound(ops, nbytes, peak_bf16, peak_bw, exps, peak_ex2)

    zero_launches()
    b, n, h, hd = HD128_QKV
    qkv = torch.randn(b, n, 3 * h * hd, generator=gen, device=dev).to(torch.bfloat16)
    out = _k11_modes(torch, F, fa, qkv, h, bound)
    del qkv
    torch.cuda.empty_cache()
    bb, hh, nq, nk, hdim = HD128_K7
    q, k_, v_ = (torch.randn(bb, hh, m_, hdim, generator=gen, device=dev).to(torch.bfloat16) for m_ in (nq, nk, nk))
    out |= _k7p_modes(torch, F, fa, q, k_, v_, bound)
    del q, k_, v_
    torch.cuda.empty_cache()
    launches, modes, bad = read_launches(), _rank_launches(), []
    for kern, r in out.items():
        fn = modes["K7'" if kern.startswith("K7'") else "K11 chunks" if "chunks" in kern else "K11 probe"]
        r["launches"] = fn.launches_by_mode.get(kern.split()[1], 0)
        r["shape"] = (f"qkv ({b}, {n}, {3 * h * hd}) bf16, {h} heads of hd {hd}" if kern.startswith("K11")
                      else f"q ({bb}, {hh}, {nq}, {hdim}), k/v ({bb}, {hh}, {nk}, {hdim}) bf16")
        ok = r["err"] <= r["tol"] and r.get("l2", 0.0) <= r.get("tol_l2", 1.0) and r["bit_equal"]
        print(f"step 22 (d) {kern} hd 128 ({r['shape']}): err {r['err']:.3e} (tol {r['tol']:g})"
              + (f", l2 {r['l2']:.3e} (tol {r['tol_l2']:g})" if "l2" in r else "")
              + f", rerun bit-equal {r['bit_equal']}; {r['ms']:.3f} ms beside "
              + (f"K1 {r['k1_ms']:.3f}" if kern.startswith("K11") else f"K7 {r['k7_ms']:.3f}")
              + f" (plain {r['plain_ms']:.3f}, bound {r['bound_ms']:.3f} {r['bound_floor']}"
              + (f", SDPA {r['library_ms']:.3f}" if r["library_ms"] else "") + ")")
        if not ok:
            bad.append(f"{kern} at hd 128")
    out["launches"] = {k: v for k, v in launches.items() if v}
    return out, bad


def _tp_int8_phases(torch, F, dev, card: str, peaks, params, zero_launches, read_launches) -> dict:
    """Step 22, the int8 backbone under tensor parallelism: (a) Q1a, Q1b and
    Q2's int32 form (:func:`_tp_int8_kernels`); (b) TP = 1 on one NCCL rank at
    the headline point (``params``, step 4's seeded init): the int8 tp
    forward against the int8 flash forward, every row-parallel product
    against the one-rank int8 linear, the launches, and the int8 tp train
    step at B=24, K=5 beside the int8 flash step; (c) TP = 2 on two gloo
    ranks sharing the card (:func:`_tp_int8_rank`) against the one-rank
    int8 net, on its kernels and all-plain, and the one-rank tp route; (d)
    K11 and K7' at hd 128
    (:func:`_hd128_modes`). Returns the readings."""
    import dataclasses

    import numpy as np

    from crossscore_tpu_torch.confsys import load_config
    from crossscore_tpu_torch.io.convert import init_params, load_into
    from crossscore_tpu_torch.models import CrossScoreConfig, CrossScoreNet
    from crossscore_tpu_torch.models import dinov2
    from crossscore_tpu_torch.ops import quant
    from crossscore_tpu_torch.parallel import mesh
    from crossscore_tpu_torch.parallel.launch import RankPool
    from crossscore_tpu_torch.train.optim import make_optimizer
    from crossscore_tpu_torch.train.step import TrainState, loss_fn, make_predict_step, make_train_step

    t_all = time.perf_counter()
    peak_bf16, peak_f32, peak_bw, peak_ex2 = peaks
    cfg = CrossScoreConfig()
    vit, n_dec = cfg.backbone, 2 * cfg.decoder_layers
    views = B * (1 + K)
    out: dict = {}
    out["kernels"], bad = _tp_int8_kernels(torch, dev, views * ((HW // vit.patch_size) ** 2 + 1),
                                           (peak_bf16, peak_bw))
    torch.cuda.empty_cache()

    # --- (b) TP = 1 on one NCCL rank ---------------------------------------------
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    query = torch.randint(0, 256, (B, HW, HW, 3), generator=gen, device=dev, dtype=torch.uint8)
    refs = torch.randint(0, 256, (B, K, HW, HW, 3), generator=gen, device=dev, dtype=torch.uint8)
    cfg8 = dataclasses.replace(cfg, backbone_quant="int8")
    layers = vit.num_layers
    # per forward: unfused, the qkv and fc1 column products (Q1 on x and on
    # the weight, Q2) and the out and fc2 row products (Q1a and Q1b on x and
    # on the weight, Q2's int32 form); with fused requested fc1 and fc2 whole
    want_f = {"unfused": _launches(K7=layers + n_dec, Q1=4 * layers, Q2=2 * layers, Q1a=4 * layers,
                                   Q1b=4 * layers, Q2s32=2 * layers),
              "fused": _launches(K7=layers + n_dec, Q1=6 * layers, Q2=3 * layers, Q1a=2 * layers, Q1b=2 * layers,
                                 Q2s32=layers)}
    b = {}
    with _one_nccl_rank():
        mesh.make_groups(1)
        flash8 = load_into(CrossScoreNet(cfg8, device=dev), params)
        want_map = make_predict_step(flash8)(query, refs)["score_map_ref_cross"]
        del flash8
        nets = {}
        for mlp in ("unfused", "fused"):
            nets[mlp] = load_into(CrossScoreNet(dataclasses.replace(cfg8, attention_impl="tp", mlp_impl=mlp),
                                                device=dev), params)
            zero_launches()
            s = make_predict_step(nets[mlp])(query, refs)["score_map_ref_cross"]
            torch.cuda.synchronize()
            got = read_launches()
            d = (s.float() - want_map.float()).abs()
            b[mlp] = {"launches": {k: v for k, v in got.items() if v},
                      "expected": {k: v for k, v in want_f[mlp].items() if v},
                      "mae_vs_flash": float(d.mean()), "max_vs_flash": float(d.max())}
            if got != want_f[mlp] or tuple(s.shape) != (B, HW, HW) or not bool(torch.isfinite(s).all()) \
                    or not b[mlp]["mae_vs_flash"] < TP_MAP_TOL:
                bad.append(f"(b) the int8 tp forward, mlp {mlp}: launches or the map against the flash route's")
        # every row-parallel product of a forward against the one-rank linear on the same operands
        with _row_products(lambda x, w, bias, y: torch.equal(y, quant.int8_linear(x, w, bias))) as checks:
            make_predict_step(nets["unfused"])(query, refs)
        b["row_products_bit_equal"] = [sum(checks), len(checks)]
        if len(checks) != 2 * layers or not all(checks):
            bad.append("(b) a row-parallel product is not the one-rank int8 linear")
        step_ms = {}
        for mlp, net in nets.items():
            step_ms[mlp] = sorted(_event_times(torch, lambda m=net: make_predict_step(m)(query, refs), reps=5))[2]
        b["forward_ms"] = step_ms
        print(f"step 22 (b) TP = 1 on one NCCL rank, int8 tp forward (dinov2-small, {HW} px, K={K}, B={B}, bf16): "
              + "; ".join(f"mlp {mlp}: launches {b[mlp]['launches']} (expected {b[mlp]['expected']}), map against "
                          f"the int8 flash forward MAE {b[mlp]['mae_vs_flash']:.3e} max {b[mlp]['max_vs_flash']:.3e} "
                          f"(tol {TP_MAP_TOL:g}), {step_ms[mlp]:.2f} ms" for mlp in nets)
              + f"; row-parallel products bit-equal to the one-rank int8 linear: {sum(checks)} of {len(checks)}")
        del nets, checks, want_map
        torch.cuda.empty_cache()

        # the train step at B=24, K=5, tp (unfused) beside flash, both int8; B=2 for step (c)
        tcfg = load_config("default")
        tbatch = {
            "query/img": torch.randint(0, 256, (TB, HW, HW, 3), generator=gen, device=dev, dtype=torch.uint8),
            "reference/cross/imgs": torch.randint(0, 256, (TB, TK, HW, HW, 3), generator=gen, device=dev,
                                                  dtype=torch.uint8),
            "query/score_map": torch.rand(TB, HW, HW, generator=gen, device=dev),
            "_valid": torch.tensor(TB, device=dev),
        }
        batch2 = {k: (v[:2] if v.ndim else torch.tensor(2, device=dev)) for k, v in tbatch.items()}
        train, tsteps = {}, {}
        for tag, c_ in (("flash", cfg8), ("tp", dataclasses.replace(cfg8, attention_impl="tp", mlp_impl="unfused"))):
            tnet = load_into(CrossScoreNet(c_, device=dev), params)
            if tag == "tp":
                with torch.no_grad():
                    loss2, (pred2, _, _) = loss_fn(tnet, batch2)
                b["loss_b2"], pred_b2 = float(loss2), pred2.float().cpu().numpy()
            optimizer, scheduler, _ = make_optimizer(tcfg, tnet, steps_per_epoch=1)
            tsteps[tag] = make_train_step(tnet, optimizer, scheduler)
            before = {k_: v.detach().clone() for k_, v in tnet.state_dict().items()}
            zero_launches()
            state, metrics = tsteps[tag](TrainState(), tbatch)
            torch.cuda.synchronize()
            got = read_launches()
            after = tnet.state_dict()
            frozen = [k_ for k_ in after if k_.startswith("backbone.") or k_ == "pos_enc_fn.PE"]
            trained = [k_ for k_, prm in tnet.named_parameters() if prm.requires_grad]
            train[tag] = {"loss": float(metrics["loss"]), "launches": {k_: v for k_, v in got.items() if v},
                          "frozen_moved": sum(not torch.equal(after[k_], before[k_]) for k_ in frozen),
                          "trained_unmoved": sum(torch.equal(after[k_], before[k_]) for k_ in trained),
                          "state": state}
            del before, after, metrics
        want_t = {"flash": _launches(K1=layers, K3=n_dec, K4=n_dec, Q1=8 * layers, Q2=4 * layers),
                  "tp": _launches(K7=layers + n_dec, K8=cfg.decoder_layers, K9=cfg.decoder_layers,
                                  **{k: v for k, v in want_f["unfused"].items() if k != "K7" and v})}
        times = {}
        for tag in ("flash", "tp", "tp", "flash"):  # in turns
            times.setdefault(tag, []).extend(_event_times(
                torch, lambda s_=tsteps[tag], st=train[tag]["state"]: s_(st, tbatch), reps=3))
        for tag, ts in times.items():
            ts = sorted(ts)
            train[tag].pop("state")
            train[tag].update(ms=ts[len(ts) // 2], spread_ms=[ts[0], ts[-1]],
                              expected={k_: v for k_, v in want_t[tag].items() if v})
            r_ = train[tag]
            if r_["launches"] != r_["expected"] or not np.isfinite(r_["loss"]) or r_["frozen_moved"] \
                    or r_["trained_unmoved"]:
                bad.append(f"(b) the int8 {tag} train step: launches, loss or parameters")
        b["train_step"] = train
        t8, tf = train["tp"], train["flash"]
        print(f"step 22 (b) int8 tp train step (TP = 1, unfused; B={TB}, K={TK}, {HW} px, bf16): launches "
              f"{t8['launches']} (expected {t8['expected']}); loss {t8['loss']:.6f} against the int8 flash step's "
              f"{tf['loss']:.6f}; backbone/PE tensors moved {t8['frozen_moved']}, decoder/head tensors not updated "
              f"{t8['trained_unmoved']}; {t8['ms']:.2f} ms (spread {t8['spread_ms'][0]:.2f}-{t8['spread_ms'][1]:.2f}) "
              f"against the int8 flash step's {tf['ms']:.2f} (spread {tf['spread_ms'][0]:.2f}-"
              f"{tf['spread_ms'][1]:.2f}), median of 6 in turns; {card}")
        del tsteps, tbatch
        torch.cuda.empty_cache()
    out["tp1"] = b

    # --- (c) TP = 2 on two gloo ranks sharing the card ------------------------------
    t0 = time.perf_counter()
    host = lambda bt: {k: v.cpu().numpy() for k, v in bt.items()}  # noqa: E731
    batch1 = {"query/img": query[:1], "reference/cross/imgs": refs[:1]}
    with RankPool(2) as pool:
        ranks = pool.run(_tp_int8_rank, host(batch1), host(batch2), timeout=600)
    # the one-rank int8 net, fp32 B=1, on its kernels (flash) and all-plain
    # (dense, unfused, the plain W8A8 linear)
    ref_maps = {}
    for tag, impl, mlp in (("kernels", "flash", "fused_exact"), ("plain", "dense", "unfused")):
        rcfg = CrossScoreConfig(compute_dtype=torch.float32, attention_impl=impl, mlp_impl=mlp, backbone_quant="int8")
        real = dinov2.int8_linear
        if tag == "plain":
            dinov2.int8_linear = quant.int8_linear_plain
        try:
            rnet = load_into(CrossScoreNet(rcfg, device=dev), init_params(rcfg, SEED, dev))
            ref_maps[tag] = make_predict_step(rnet)(query[:1], refs[:1])["score_map_ref_cross"].cpu().numpy()
        finally:
            dinov2.int8_linear = real
        del rnet
        torch.cuda.empty_cache()
    want_r = {"fp32": _launches(**want_f["unfused"]),
              "bf16": _launches(K8=cfg.decoder_layers, K9=cfg.decoder_layers,
                                **{k: v for k, v in want_f["unfused"].items() if v})}
    c = {"fp32_map_mae": [float(np.abs(r["map"] - ref_maps["kernels"]).mean()) for r in ranks],
         "fp32_map_max": [float(np.abs(r["map"] - ref_maps["kernels"]).max()) for r in ranks],
         "fp32_map_mae_vs_all_plain": [float(np.abs(r["map"] - ref_maps["plain"]).mean()) for r in ranks],
         "one_rank_kernels_mae_vs_all_plain": float(np.abs(ref_maps["kernels"] - ref_maps["plain"]).mean()),
         "bf16_map_mae": [float(np.abs(r["pred"] - pred_b2).mean()) for r in ranks],
         "bf16_loss": [r["loss"] for r in ranks], "loss_b2_one_rank": b["loss_b2"],
         "row_products": [r["row_products"] for r in ranks], "ms_per_rank_bf16_b2": [r["ms"] for r in ranks],
         "launches_fp32_b1": {k: v for k, v in ranks[0]["launches_fp32_b1"].items() if v},
         "launches_bf16_b2_step": {k: v for k, v in ranks[0]["launches_bf16_b2_step"].items() if v}}
    rows_ok = all(p["bit_equal"] and p["planted_elements_off"] > 0 for r in ranks for p in r["row_products"])
    print(f"step 22 (c) TP = 2 on 2 gloo ranks sharing the card, int8, unfused: fp32 B=1 score maps per rank "
          f"against the one-rank int8 net on the same kernels, MAE {c['fp32_map_mae']} (tol {NET_TOL['float32']:g}), "
          f"max {c['fp32_map_max']}; against the one-rank all-plain int8 net MAE {c['fp32_map_mae_vs_all_plain']}, "
          f"where the one-rank kernel net reads {c['one_rank_kernels_mae_vs_all_plain']:.3e} (tier "
          f"{INT8_TIER[0]:g}: fp32 summation order flips codes at a rounding boundary); bf16 B=2 "
          f"train step per rank against the one-rank tp route: map MAE {c['bf16_map_mae']} (tol {TP_MAP_TOL:g}), "
          f"loss {c['bf16_loss']} against {b['loss_b2']:.6f}; block 0's row products against the one-rank int8 "
          f"linear on the gathered operands, and with the MAX all-reduce left out (planted): " + "; ".join(
              f"rank {i} {p['product']} x {p['x']} bit-equal {p['bit_equal']}, planted {p['planted_elements_off']} of "
              f"{p['elements']} elements off" for i, r in enumerate(ranks) for p in r["row_products"])
          + f"; launches per rank {c['launches_fp32_b1']} (forward), {c['launches_bf16_b2_step']} (step); ms/step "
            f"per rank {c['ms_per_rank_bf16_b2']} (two ranks time-slicing one card, gloo through host memory)")
    if not (all(e < NET_TOL["float32"] for e in c["fp32_map_mae"])
            and all(e < INT8_TIER[0] for e in (*c["fp32_map_mae_vs_all_plain"], c["one_rank_kernels_mae_vs_all_plain"]))
            and all(e <= TP_MAP_TOL for e in c["bf16_map_mae"])
            and all(abs(x - b["loss_b2"]) <= TP_MAP_TOL for x in c["bf16_loss"]) and rows_ok
            and all(r["launches_fp32_b1"] == want_r["fp32"] and r["launches_bf16_b2_step"] == want_r["bf16"]
                    for r in ranks)):
        bad.append("(c) TP = 2 under int8")
    c["s"] = time.perf_counter() - t0
    out["tp2"] = c
    del query, refs, batch1, batch2
    torch.cuda.empty_cache()

    # --- (d) K11 and K7' at hd 128 -------------------------------------------------
    out["hd128"], bad_d = _hd128_modes(torch, F, dev, (peak_bf16, peak_bw, peak_ex2), zero_launches,
                                       read_launches)
    bad += bad_d
    out["s"] = time.perf_counter() - t_all
    print(f"step 22: {out['s']:.1f} s")
    if bad:
        _fail("step 22: " + "; ".join(bad))
    return out


def _tp_int8_rows(tpi: dict, int8: dict) -> list:
    """The kernels line's rows of Q1a, Q1b and Q2's int32 form from step 22's
    readings; their main path is the int8 tp forward (TP = 1, unfused)."""
    ik, rows = tpi["kernels"], []
    tp1 = tpi["tp1"]
    for kern, fn, replaces, err in (
            ("Q1a", "row_absmax", "crossscore_tpu/ops/quant.py:35", "bit-equal absmaxes"),
            ("Q1b", "quantize_rowwise_given", "crossscore_tpu/ops/quant.py:35", "bit-equal codes and scales"),
            ("Q2s32", "int8_matmul_s32", "crossscore_tpu/ops/quant.py:51", "bit-equal int32 products")):
        r = ik["products"]["fc2"][kern]
        rows.append({"name": fn, "route": "cuda", "source": "crossscore_tpu_torch/csrc/int8_linear.cu",
                     "replaces": replaces, "pallas_counterpart": None,
                     "launches": tp1["unfused"]["launches"].get(kern, 0), "max_abs_err": ik[kern]["max_abs_err"],
                     "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                     "library_ms": r["library_ms"], "err_kind": err, "shape": ik["products"]["fc2"]["shape"],
                     "products": {tag: v[kern] | {"Q1_ms": v["Q1_ms"], "Q2_ms": v["Q2_ms"]}
                                  for tag, v in ik["products"].items()},
                     "launches_by_path": {"tp_int8_forward_unfused": tp1["unfused"]["launches"].get(kern, 0),
                                          "tp_int8_forward_fused_requested": tp1["fused"]["launches"].get(kern, 0),
                                          "tp_int8_train_step": tp1["train_step"]["tp"]["launches"].get(kern, 0),
                                          "tp2_rank0_forward": tpi["tp2"]["launches_fp32_b1"].get(kern, 0),
                                          "tp2_rank0_train_step": tpi["tp2"]["launches_bf16_b2_step"].get(kern, 0),
                                          "int8_predict": int8["predict_step"]["launches"].get(kern, 0)}})
    return rows


def main() -> int:
    import argparse

    import numpy as np
    import torch

    ap = argparse.ArgumentParser(description="Drive the port on one CUDA card.")
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after the kernel checks (steps 1-3), printing no result lines")
    ap.add_argument("--against", type=Path, default=None,
                    help="another checkout's root (the parent commit unpacked): its fp32 attention forward timed in "
                         "turns with this tree's after step 4")
    cli_args = ap.parse_args()
    kernels_only = cli_args.kernels_only

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
    peaks, peak_tf32 = (peak_bf16, peak_f32, peak_bw, peak_ex2), _tf32_peak(name)
    print(f"peaks used for bounds: {peak_row} row: {peak_bf16 / 1e12:g} TFLOP/s bf16, "
          f"{peak_f32 / 1e12:g} TFLOP/s fp32, {peak_bw / 1e12:g} TB/s, {peak_ex2 / 1e12:g} T exp2/s")

    t0 = time.perf_counter()
    secs = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s wall "
          + " ".join(f"{k}={v:.1f}s" for k, v in secs.items()))
    for src in _build.SOURCES:
        log = _build.build_dir() / f"{src}.log"
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

    _lap(t_start, 2)
    # --- 3. kernels vs plain versions at the main-path shapes ----------------
    for dtype in (torch.bfloat16, torch.float32):
        tname = str(dtype).split(".")[-1]
        es = dtype.itemsize
        peak = peak_bf16 if dtype == torch.bfloat16 else peak_f32

        qkv = randn(views, n, 3 * d, dtype=dtype)
        got, same = _twice(flash_qkv_self_attention, qkv, h)
        want = flash_qkv_self_attention_plain(qkv, h)
        err, l2 = _masked_errs([(got, want)])
        ops = 4.0 * views * h * n * n * hd
        nbytes = views * n * (3 * d + d) * es + 2 * views * h * n * 4

        def sdpa():
            return F.scaled_dot_product_attention(*(qkv.view(views, n, 3, h, hd)[:, :, i].transpose(1, 2)
                                                    for i in range(3)))

        report[("K1", tname)] = dict(
            err=err, tol=TOL[tname], l2=l2, tol_l2=TOL_L2[tname], bit_equal=same, max_abs=_max_abs(got[0], want[0]),
            ms=_time_ms(torch, lambda: flash_qkv_self_attention(qkv, h)),
            plain_ms=_time_ms(torch, lambda: flash_qkv_self_attention_plain(qkv, h), reps=3),
            library_ms=_time_ms(torch, sdpa),
            **_fwd_bound(tname, ops, nbytes, views * h * n * n, peaks, peak_tf32),
        )
        if dtype == torch.float32:  # the 3xTF32 route taken apart; the library call's kernels
            report[("K1", tname)].update(_f32_prepass(torch, qkv, h), sdpa_kernels=_kernel_names(torch, sdpa))
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
            got, same = _twice(flash_cross_attention, q, k_, v_, dec_h)
            want = flash_cross_attention_plain(q, k_, v_, dec_h)
            err, l2 = _masked_errs([(got, want)])
            dhd = d // dec_h
            ops = 4.0 * B * dec_h * nq * nk * dhd
            nbytes = B * (2 * nq + 2 * nk) * d * es + 2 * B * dec_h * nq * 4
            heads = lambda t: t.view(B, -1, dec_h, dhd).transpose(1, 2)  # noqa: E731
            sdpa = lambda: F.scaled_dot_product_attention(heads(q), heads(k_), heads(v_))  # noqa: E731
            report[(tag, tname)] = dict(
                err=err, tol=TOL[tname], l2=l2, tol_l2=TOL_L2[tname], bit_equal=same,
                max_abs=_max_abs(got[0], want[0]),
                ms=_time_ms(torch, lambda: flash_cross_attention(q, k_, v_, dec_h)),
                plain_ms=_time_ms(torch, lambda: flash_cross_attention_plain(q, k_, v_, dec_h), reps=3),
                library_ms=_time_ms(torch, sdpa),
                **_fwd_bound(tname, ops, nbytes, B * dec_h * nq * nk, peaks, peak_tf32),
            )
            if dtype == torch.float32:
                report[(tag, tname)]["sdpa_kernels"] = _kernel_names(torch, sdpa)
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
        got, same = _twice(flash_qkv_self_attention_masked, qkv, bias5, h)
        want = flash_qkv_self_attention_masked_plain(qkv, bias5, h)
        err, l2 = _masked_errs([(got, want), (
            flash_qkv_self_attention_masked(qkv, bias5[1].contiguous(), h),
            flash_qkv_self_attention_masked_plain(qkv, bias5[1].contiguous(), h))])
        valid_cols = float((bias5 == 0).sum())  # summed over the batch
        ops = 4.0 * h * (nb + 1) * valid_cols * hd  # masked columns need no work
        nbytes = PB * (nb + 1) * (3 * d + d) * es + 2 * PB * h * (nb + 1) * 4 + bias5.numel() * 4
        mask = bias5[:, None, None, :].to(dtype)

        def sdpa():
            return F.scaled_dot_product_attention(*(qkv.view(PB, nb + 1, 3, h, hd)[:, :, i].transpose(1, 2)
                                                    for i in range(3)), attn_mask=mask)

        report[("K5", tname)] = dict(
            err=err, tol=TOL[tname], l2=l2, tol_l2=TOL_L2[tname], bit_equal=same, max_abs=_max_abs(got[0], want[0]),
            ms=_time_ms(torch, lambda: flash_qkv_self_attention_masked(qkv, bias5, h)),
            # K1 on the same qkv: what the bias costs at equal shape
            k1_ms=_time_ms(torch, lambda: flash_qkv_self_attention(qkv, h)),
            plain_ms=_time_ms(torch, lambda: flash_qkv_self_attention_masked_plain(qkv, bias5, h), reps=3),
            library_ms=_time_ms(torch, sdpa),
            **_fwd_bound(tname, ops, nbytes, h * (nb + 1) * valid_cols, peaks, peak_tf32),
        )
        if dtype == torch.float32:
            report[("K5", tname)]["sdpa_kernels"] = _kernel_names(torch, sdpa)
        del qkv, got, want, mask
        q = randn(PB, nb, d, dtype=dtype)
        for tag, reps_ in (("K6", PK), ("K6self", 1)):  # cross over K views, then self
            k_, v_ = randn(PB, reps_ * nb, d, dtype=dtype), randn(PB, reps_ * nb, d, dtype=dtype)
            bias6 = item_bias.repeat(1, reps_).contiguous()
            got, same = _twice(flash_cross_attention_masked, q, k_, v_, bias6, dec_h)
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
            sdpa = lambda: F.scaled_dot_product_attention(heads(q), heads(k_), heads(v_), attn_mask=mask)  # noqa: E731
            report[(tag, tname)] = dict(
                err=err, tol=TOL[tname], l2=l2, tol_l2=TOL_L2[tname], bit_equal=same,
                max_abs=_max_abs(got[0], want[0]),
                ms=_time_ms(torch, lambda: flash_cross_attention_masked(q, k_, v_, bias6, dec_h)),
                plain_ms=_time_ms(torch, lambda: flash_cross_attention_masked_plain(q, k_, v_, bias6, dec_h),
                                  reps=3),
                library_ms=_time_ms(torch, sdpa),
                **_fwd_bound(tname, ops, nbytes, exps, peaks, peak_tf32),
            )
            if dtype == torch.float32:
                report[(tag, tname)]["sdpa_kernels"] = _kernel_names(torch, sdpa)
            del k_, v_, got, want, mask
        del q, item_bias, bias5, bias6
        torch.cuda.empty_cache()

        # K7 at the view-parallel shapes: B*H = 64 (B=8, the 8 decoder heads),
        # Nq 1369, hd 48; Nk = 4*1369 per rank on 2 ranks at K=8, 1369 on 8
        # ranks. Without and with a shared bias row, on contiguous (B, H, N,
        # hd) tensors and on head-major hm of token-major projections
        dhd = d // dec_h
        k7_bias = _shared_bias(torch, VP_NK[0], dev)
        errs, l2s, same = [], [], True
        for nk in VP_NK:
            xq, xk, xv = randn(B, nq, d, dtype=dtype), randn(B, nk, d, dtype=dtype), randn(B, nk, d, dtype=dtype)
            hm = [t.view(B, -1, dec_h, dhd).transpose(1, 2) for t in (xq, xk, xv)]
            for layout in (hm, [t.contiguous() for t in hm]):
                for bias in (None, k7_bias[:nk].contiguous()):
                    got, same_ = _twice(flash_attention_head_major, *layout, bias)
                    want = flash_attention_head_major_plain(*layout, bias)
                    err, l2 = _masked_errs([(got, want)])
                    errs.append(err)
                    l2s.append(l2)
                    same = same and same_
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
                    **_fwd_bound(tname, ops, nbytes, B * dec_h * nq * nk, peaks, peak_tf32),
                    # K3 on the token-major tensors the hm read: the same work
                    k3_ms=_time_ms(torch, lambda: flash_cross_attention(xq, xk, xv, dec_h)),
                )
                if dtype == torch.float32:
                    k7["sdpa_kernels"] = _kernel_names(torch, lambda: F.scaled_dot_product_attention(*hm))
            del xq, xk, xv, hm, layout
        report[("K7", tname)] = dict(err=max(errs), tol=TOL[tname], l2=max(l2s), tol_l2=TOL_L2[tname], bit_equal=same,
                                     **k7)
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
        runs = [(_twice(flash_attention_head_major, *layout), flash_attention_head_major_plain(*layout))
                for layout in (hm, [t.contiguous() for t in hm])]
        err, l2 = _masked_errs([(got, want) for (got, _), want in runs])
        ops = 4.0 * bv * h * n * n * hd
        nbytes = 4 * bv * n * d * es + 2 * bv * h * n * 4
        qkv = torch.cat([xq, xk, xv], -1)
        report[("K7 backbone", tname)] = dict(
            err=err, tol=TOL[tname], l2=l2, tol_l2=TOL_L2[tname], bit_equal=all(same for (_, same), _ in runs),
            max_abs=max(_max_abs(g, w) for g, w in zip(flash_attention_head_major(*hm),
                                                       flash_attention_head_major_plain(*hm))),
            ms=_time_ms(torch, lambda: flash_attention_head_major(*hm)),
            plain_ms=_time_ms(torch, lambda: flash_attention_head_major_plain(*hm), reps=3),
            library_ms=_time_ms(torch, lambda: F.scaled_dot_product_attention(*hm)),
            **_fwd_bound(tname, ops, nbytes, bv * h * n * n, peaks, peak_tf32),
            # K1 on the fused qkv of the same projections: the flash route's form
            k1_ms=_time_ms(torch, lambda: flash_qkv_self_attention(qkv, h)),
        )
        del xq, xk, xv, hm, qkv, runs
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
            if dtype == torch.float32:  # the fp32 pre-pass's stages, bit for bit, on the views
                from crossscore_tpu_torch.ops import flash_attention as fa_

                lib_ = _build.load("flash_cross")
                same = torch.equal(fa_.f32_split_kv(lib_, hm[1], hm[2]).view(torch.int32), fa_.f32_kv_tiles_plain(
                    hm[1], hm[2], fa_.f32_plan(lib_, hdim)["block_k"]).view(torch.int32))
                report[(f"fp32 pre-pass hd{hdim}", tname)] = dict(err=0.0 if same else 1.0, tol=0.0, bit_equal=same)
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
        # K10 at the wide widths (bf16: the wide body; fp32: the CUDA cores),
        # from a generator of its own so that the later draws stay what they were
        g_wide = torch.Generator(device=dev).manual_seed(SEED + 7)
        for width in (768, 1024):
            def wide_randn(*shape, scale=1.0):
                return torch.randn(*shape, generator=g_wide, device=dev) * scale

            x, attn = wide_randn(2, 300, width).to(dtype), wide_randn(2, 300, width, scale=0.3).to(dtype)
            mlp = (wide_randn(width, scale=0.1) + 1, wide_randn(width, scale=0.1),
                   wide_randn(4 * width, width, scale=width ** -0.5), wide_randn(4 * width, scale=0.1),
                   wide_randn(width, 4 * width, scale=(4 * width) ** -0.5), wide_randn(width, scale=0.1),
                   wide_randn(width) + 1)
            ls1 = wide_randn(width, scale=0.5) + 1
            (got,), same = _twice(lambda *a: (fused_res_ln_mlp(*a),), x, attn, ls1, *mlp, 1e-6)
            report[(f"K10 D{width}", tname)] = dict(
                err=_rel_err(got, fused_res_ln_mlp_plain(x, attn, ls1, *mlp, 1e-6)), tol=TOL[tname], bit_equal=same)
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
            report[(f"K5 hd{hdim}", tname)] = fwd_entry(
                [(_twice(flash_qkv_self_attention_masked, qkv, b_, heads_),
                  flash_qkv_self_attention_masked_plain(qkv, b_, heads_)) for b_ in (bias, bias[1].contiguous())], tname)
        for heads_, hdim in ((8, 64), (8, 96), (8, 128)):  # K6: other decoders' head dims
            q, k_ = randn(2, 300, heads_ * hdim, dtype=dtype), randn(2, 600, heads_ * hdim, dtype=dtype)
            bias = _token_bias(torch, [(10, 20), (15, 17)], dev, grid=(15, 20)).repeat(1, 2).contiguous()
            report[(f"K6 hd{hdim}", tname)] = fwd_entry(
                [(_twice(flash_cross_attention_masked, q, k_, k_, b_, heads_),
                  flash_cross_attention_masked_plain(q, k_, k_, b_, heads_)) for b_ in (bias, bias[1].contiguous())],
                tname)

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
        ok = (r["err"] <= r["tol"] and r.get("l2", 0.0) <= r.get("tol_l2", 0.0) and r.get("bit_equal", True)
              and r.get("prepass_bit_equal", True) and r.get("planted_caught", True))
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
        if "cuda_core_bound_ms" in r:
            line += f"; CUDA-core floor {r['cuda_core_bound_ms']:.3f} ms"
        if "prepass_bit_equal" in r:
            line += (f"; pre-pass bit-equal {r['prepass_bit_equal']}, K/V lo zeroed: rel L2 {r['planted_lo_zero_l2']:.3e}"
                     f" caught {r['planted_caught']}")
        if "sdpa_kernels" in r:
            line += f"; SDPA ran {r['sdpa_kernels']}"
        print(f"{line} {'ok' if ok else 'FAIL'}")
        if not ok:
            bad.append(f"{kern} {tname}")
    if bad:
        _fail("kernel disagrees with its plain version: " + ", ".join(bad))
    if kernels_only:
        print("chip_smoke: kernel checks passed; --kernels-only stops here")
        return 0

    _lap(t_start, 3)
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

    # the parity preset (model.gpu.parity=true: fp32 compute, K2's exact
    # GELU) at the same point: K1 and K3 on the fp32 forward's 3xTF32 body
    pnet = load_into(CrossScoreNet(CrossScoreConfig(parity=True), device=dev), params)
    pstep = make_predict_step(pnet)
    zero_launches()
    pscore = pstep(query, refs)["score_map_ref_cross"]
    torch.cuda.synchronize()
    plaunches = read_launches()
    if plaunches != want or tuple(pscore.shape) != (B, HW, HW) or not bool(torch.isfinite(pscore).all()) \
            or float(pscore.min()) < 0.0 or float(pscore.max()) > 1.0:
        _fail(f"parity predict step: launches {plaunches} (expected {want}) or its score map "
              f"{tuple(pscore.shape)} is not finite in [0, 1]")
    parity = {"ms": _time_ms(torch, lambda: pstep(query, refs), reps=5), "launches": plaunches}
    print(f"parity predict step (model.gpu.parity=true: fp32, fused_exact; 518 px, K={K}, B={B}): "
          f"{parity['ms']:.2f} ms per batch (median of 5), launches {plaunches}; {card}")
    if cli_args.against is not None:
        parity["against"] = _f32_against(torch, F, dev, cli_args.against, lambda: pstep(query, refs), card)
    del pnet, pstep, pscore
    torch.cuda.empty_cache()

    _lap(t_start, 4)
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

    _lap(t_start, 5)
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

    _lap(t_start, 6)
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

    _lap(t_start, 7)
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
              "logger.vis_scalar_every_n_train_steps=1"] + FIGURES_OFF
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

    _lap(t_start, 8)
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

    _lap(t_start, 9)
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

    _lap(t_start, 10)
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

    _lap(t_start, 11)
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

    _lap(t_start, 12)
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
    # (b) the profiling tools, the build-flag sweep and the converter
    inst["profiling"] = _profiling_phases(torch, dev, params, zero_launches, read_launches)

    _lap(t_start, 13)
    # --- 14. token-space training: the token step, the token graph at B=1, the
    # token_fast train CLI, encode_tokens and a run on the warm store -----------
    tok_work = tempfile.TemporaryDirectory()  # step 14's tree and token store, read again in step 17
    tok = _token_phases(torch, dev, params, vit, zero_launches, read_launches, Path(tok_work.name))

    _lap(t_start, 14)
    # --- 15. the test CLI: four modes and a warm store, B=1 kernels against the
    # all-plain net, the GT summary -----------------------------------------------
    ev = _eval_phases(torch, dev, zero_launches, read_launches)
    torch.cuda.empty_cache()

    _lap(t_start, 15)
    # --- 16. the serving daemon: the warm-cache step, the daemon in this
    # process, the CLI in a child process ----------------------------------------
    sv = _serve_phases(torch, dev, params, card, zero_launches, read_launches)
    torch.cuda.empty_cache()

    _lap(t_start, 16)
    # --- 17. the native host input path: the decoder's build and decodes, the
    # predict, test and token_fast CLIs from files and record shards with the
    # decode skip, the two host benchmarks ----------------------------------------
    inp = _input_phases(torch, Path(tok_work.name), zero_launches, read_launches)
    torch.cuda.empty_cache()

    _lap(t_start, 17)
    # --- 18. data parallelism: the train (pixel and token_fast), test and
    # predict CLIs on two gloo ranks that share the card, and the dry run ------
    dpr = _dp_phases(torch, zero_launches, read_launches, Path(tok_work.name), card)
    tok_work.cleanup()
    torch.cuda.empty_cache()

    _lap(t_start, 18)
    # --- 19. the ViT-L stress path: K2 and K10 at D 768 and 1024, dinov2-large
    # at 1036 px (forward and train steps), parity on the card, the three tools
    vitl = _vitl_phases(torch, dev, card, (peak_bf16, peak_bw), zero_launches, read_launches)
    torch.cuda.empty_cache()

    _lap(t_start, 19)
    # --- 20. the training-quality workflow: the kernels at hd 8, the train CLI
    # at the tiny geometry with init_path and the histograms, the quality tools
    # at full width ----------------------------------------------------------------
    qual = _quality_phases(torch, F, dev, (peak_bf16, peak_f32, peak_bw, peak_ex2), zero_launches, read_launches)
    torch.cuda.empty_cache()

    _lap(t_start, 20)
    # --- 21. the int8 backbone: Q1 and Q2 against their plain versions, the
    # int8 predict step, the predict CLI, matmul_microbench, ViT-L -----------------
    int8 = _int8_phases(torch, F, dev, card, (peak_bf16, peak_bw), params, zero_launches, read_launches)
    torch.cuda.empty_cache()

    _lap(t_start, 21)
    # --- 22. the int8 backbone under tensor parallelism: the split forms, TP = 1
    # on one NCCL rank, TP = 2 on two gloo ranks, K11 and K7' at hd 128 ------------
    tpi = _tp_int8_phases(torch, F, dev, card, (peak_bf16, peak_f32, peak_bw, peak_ex2), params, zero_launches,
                          read_launches)
    torch.cuda.empty_cache()

    _lap(t_start, 22)
    # --- 23. the kernels line, then the device line ---------------------------
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
             "k1_ms", "k3_ms", "k4_ms", "unfused_ms", "bit_equal", "cuda_core_bound_ms", "sdpa_kernels",
             "prepass_bit_equal", "planted_lo_zero_l2")
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
                                    # by torch.profiler name: the daemon's dispatches are replays
                                    "serve_replay_b8": sv["graphs"]["buckets"][8]["replay_kernels"].get(kern, 0),
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
                                                        for tag in ("b", "d")}},
                                    # step 20: the tiny train CLI (3 steps, 1 validation batch)
                                    "quality_train_cli": qual["train_cli"]["launches"].get(kern, 0),
                                    "quality_tools": {tag: r["launches"].get(kern, 0)
                                                      for tag, r in qual["tools"].items()}},
               "fp32": {k: r32[k] for k in stats if k in r32}, "shape": shapes[kern]}
        # K5-K7: the relative L2 of o, l, m; K5: K1's time on the same qkv;
        # K7: K3's on the same work, and both at the 1-rank length; K8/K9:
        # K4's on the same work
        row.update({k: r[k] for k in ("l2", "tol_l2", "k1_ms", "k3_ms", "ms_nk10952", "k3_ms_nk10952",
                                      "bound_ms_nk10952", "k4_ms", "bound_floor", "products_ms", "exp_ms",
                                      "unfused_ms")
                    if k in r})
        if kern == "K2":  # the bf16 bodies' plans (step 2) and the D 768 / 1024 readings (step 19)
            row["plan"] = mlp_plan
            row["wide"] = {w: r_["K2"] for w, r_ in vitl["wide"].items()}
            row["launches_by_path"]["vitl"] = vitl["k2_launches"]
            # step 21: the int8 backbone takes the unfused chain
            row["launches_by_path"]["int8_predict"] = int8["predict_step"]["launches"].get("K2", 0)
            row["launches_by_path"]["int8_predict_cli_c"] = int8["predict_cli"]["int8"]["launches"].get("K2", 0)
        if kern in ("K3", "K4", "K6"):
            s, s32 = report[(f"{kern}self", "bfloat16")], report[(f"{kern}self", "float32")]
            row["self"] = {k: s[k] for k in stats if k in s}
            row["self_fp32"] = {k: s32[k] for k in stats if k in s32}
        # step 20 (a): hd 8 through the zero-pad route, at the tiny decoder's
        # shape and a ragged one; step 20 (c): the stress point beside SDPA
        hd8 = {f"{sname} {tname}": {k: v for k, v in r_.items() if k in stats or k == "bit_equal"}
               for (kern_, sname, tname), r_ in qual["hd8"]["readings"].items() if kern_ == kern}
        if hd8:
            row["hd8"] = hd8
        stress = qual["tools"]["bench_stress_attention"]["last_line"]
        if kern in ("K3", "K7"):
            row["stress"] = stress["kernels"]["layout-native K3" if kern == "K3" else "head-major K7"] \
                | {"sdpa_ms": stress["sdpa_ms"], "bound_ms": stress["bound_ms"], "geometry": stress["geometry"]}
        if kern in ("K7", "K8", "K9"):  # step 22: the int8 tp forward and train step (TP = 1)
            row["launches_by_path"]["tp_int8_forward"] = tpi["tp1"]["unfused"]["launches"].get(kern, 0)
            row["launches_by_path"]["tp_int8_train_step"] = tpi["tp1"]["train_step"]["tp"]["launches"].get(kern, 0)
        if kern == "K7":  # the tp train step's backbone shape, 12 of its 16 launches
            s, s32 = report[("K7 backbone", "bfloat16")], report[("K7 backbone", "float32")]
            row["backbone"] = {k: s[k] for k in stats if k in s} | {"shape": shapes["K7 backbone"]}
            row["backbone_fp32"] = {k: s32[k] for k in stats if k in s32}
        kernels.append(row)
    # K10-K12: their launches from step 13's runs of their entry points (K10:
    # its op; K11: the microbenchmark at the backbone shape; K7': at the
    # decoder shape, the MXU probe's home, the backbone run's beside it; K12:
    # its tool)
    modes_src = "crossscore_tpu_torch/csrc/attention_modes.cu"
    flash_py = "crossscore_tpu/ops/flash_attention.py"
    new_rows = {"K10": ("fused_res_ln_mlp", "crossscore_tpu_torch/csrc/fused_ln_mlp.cu",
                        "crossscore_tpu/ops/fused_mlp.py:72", inst["K10 op"]["launches"]["K10"], instruments["K10"])}
    for m in fa.QKV_PROBES:
        new_rows[f"K11 {m}"] = (f"flash_qkv_self_attention_probe, probe {m}", modes_src, f"{flash_py}:1255",
                                bb["K11 probe"][m], instruments["K11"])
    for c in (2, 3):
        new_rows[f"K11 chunks{c}"] = (f"flash_qkv_self_attention_chunked, chunks {c}", modes_src, f"{flash_py}:1295",
                                      bb["K11 chunks"][f"chunks{c}"], instruments["K11"])
    for m, line in (("mxuprobe", 157), ("noexp", 231), ("bf16exp", 231)):
        new_rows[f"K7' {m}"] = (f"flash_attention_head_major_variant, {m}", modes_src, f"{flash_py}:{line}",
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
            row["wide"] = {w: r_["K10"] for w, r_ in vitl["wide"].items()}
        if kern.startswith("K7'"):
            row["backbone"] = {k: v for k, v in report[(f"{kern} backbone", "bfloat16")].items()} \
                | {"launches": bb["K7'"][kern.split()[1]]}
        if kern in tpi["hd128"]:  # step 22 (d): the ViT-L decoder's head dim
            row["hd128"] = tpi["hd128"][kern]
        kernels.append(row)
    kernels += _int8_rows(int8)
    kernels[-1]["build_s"] = secs.get("int8_linear")  # Q2: csrc/int8_linear.cu's nvcc seconds (step 2)
    for row in kernels[-2:]:  # Q1 and Q2 on the int8 tp path (step 22)
        kern = "Q1" if row["name"] == "quantize_rowwise" else "Q2"
        row["launches_by_path"]["tp_int8_forward"] = tpi["tp1"]["unfused"]["launches"].get(kern, 0)
        row["launches_by_path"]["tp_int8_train_step"] = tpi["tp1"]["train_step"]["tp"]["launches"].get(kern, 0)
    kernels += _tp_int8_rows(tpi, int8)
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
                      "data_parallel": dpr, "vitl": {k: v for k, v in vitl.items() if k != "wide"},
                      "quality": {"s": qual["s"], "hd8_planted_scale": qual["hd8"]["planted_scale"],
                                  "train_cli": qual["train_cli"],
                                  "tools": {tag: {k: v for k, v in r.items() if k != "report"}
                                            for tag, r in qual["tools"].items()}},
                      "int8": {k: v for k, v in int8.items() if k != "kernels"}
                      | {"planted_scale": int8["kernels"]["planted_scale"]},
                      "tp_int8": {k: v for k, v in tpi.items() if k not in ("kernels", "hd128")}
                      | {"hd128_launches": tpi["hd128"]["launches"]},
                      "parity_predict": parity,
                      "eval_cli": ev | {"modes": {tag: {k: ({n: c for n, c in v.items() if c} if k == "launches" else v)
                                                        for k, v in r.items()} for tag, r in ev["modes"].items()}},
                      "seconds": seconds}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                              "count": torch.cuda.device_count()}}))
    return 0


def _run_teed(fn, argv) -> tuple[int, str]:
    """``fn(argv)``, its printed lines shown and kept -> (its exit code, its
    standard output)."""
    tee = _Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        rc = fn(argv)
    return rc, "".join(tee.text)


def _profiling_phases(torch, dev, params, zero_launches, read_launches) -> dict:
    """Step 13 (b): the profiling tools and the build-flag sweep through their
    entry points, each with the counts zeroed just before it and read just
    after, then the converter's three modes at dinov2-small width and the
    converted checkpoint restored through ``tasks/common.py`` into a net
    whose B=1 maps must be the source net's bits. Returns the readings."""
    import tempfile

    from crossscore_tpu_torch.confsys import load_config
    from crossscore_tpu_torch.io import convert
    from crossscore_tpu_torch.io.checkpoint import CheckpointManager
    from crossscore_tpu_torch.models import CrossScoreConfig, CrossScoreNet
    from crossscore_tpu_torch.tasks.common import load_model_params
    from crossscore_tpu_torch.tools import (h2d_probe, model_breakdown, trace_breakdown, trace_events,
                                            train_microbench, train_trace, xla_flag_sweep)
    from crossscore_tpu_torch.train.optim import make_optimizer
    from crossscore_tpu_torch.train.step import make_predict_step

    t_step = time.perf_counter()
    out, bad = {}, []
    work = tempfile.TemporaryDirectory()
    tmp = Path(work.name)
    pixel, token = tmp / "pixel_trace.json", tmp / "token_trace.json"
    steps = train_trace.WARMUP + train_trace.STEPS
    runs = {
        "model_breakdown": (model_breakdown.main, ["full", "backbone", "decoder"]),
        "train_microbench": (train_microbench.main, ["24", "5"]),
        "train_trace pixel": (train_trace.main, ["24", "5", str(pixel)]),
        "train_trace tokens": (train_trace.main, ["24", "5", str(token), "tokens"]),
        "trace_breakdown": (trace_breakdown.main, []),
        "trace_breakdown on train_trace's file": (trace_breakdown.main, [str(pixel)]),
        "trace_events": (trace_events.main, [str(pixel), str(train_trace.STEPS), "attn_bwd"]),
        "h2d_probe": (h2d_probe.main, []),
        "xla_flag_sweep": (xla_flag_sweep.main, ["baseline", "ptxas_o2"]),
    }
    for tag, (tool, argv) in runs.items():
        zero_launches()
        t0 = time.perf_counter()
        rc, text = _run_teed(tool, argv)
        torch.cuda.synchronize()
        out[tag] = {"rc": rc, "s": time.perf_counter() - t0, "text": text,
                    "launches": {k: v for k, v in read_launches().items() if v}}
        print(f"step 13 (b) {tag} ({' '.join(argv)}): exit {rc} in {out[tag]['s']:.1f} s; launches "
              f"{out[tag]['launches']}", flush=True)
        if rc != 0:
            bad.append(f"{tag} exited {rc}")
        torch.cuda.empty_cache()
    # the traced train steps, held to the launches a step counts
    for tag, per_step in (("train_trace pixel", _launches(K1=12, K2=12, K3=4, K4=4)),
                          ("train_trace tokens", _launches(K3=4, K4=4))):
        want = {k: steps * v for k, v in per_step.items() if v}
        if out[tag]["launches"] != want:
            bad.append(f"{tag} launches {out[tag]['launches']} != {want} ({steps} steps)")
    text = out["trace_breakdown on train_trace's file"]["text"]
    if not re.search(r"x\s*\d+\s+K4 decoder attention backward\s+\S*attn_bwd", text):
        bad.append("trace_breakdown: no K4 family in the pixel train step's trace")
    # every K4 kernel under the filter linked to the decoder's backward op and its recorded shapes
    links = re.findall(r"launched by (.*)", out["trace_events"]["text"])
    if "in filter attn_bwd" not in out["trace_events"]["text"] or not links or not all(
            re.match(r"_FlashCrossAttentionBackward, input shapes \[\[\d", ln) for ln in links):
        bad.append(f"trace_events: a K4 kernel under the filter without its launching op and shapes: {links}")
    lines = {t: [ln for ln in out["xla_flag_sweep"]["text"].splitlines() if ln.startswith(t + " ")]
             for t in ("baseline", "ptxas_o2")}
    out["xla_flag_sweep"]["sets"] = lines
    if any(len(v) != 1 for v in lines.values()) or "ms/fwd" not in lines["baseline"][0]:
        bad.append(f"xla_flag_sweep: the sets' lines {lines}")
    n_copies = sum("MB/s" in ln for ln in out["h2d_probe"]["text"].splitlines())
    if n_copies != 3 * h2d_probe.REPS * 2:
        bad.append(f"h2d_probe: {n_copies} copies timed")
    for tag, keys in (("model_breakdown", ("full(warm) ", "full ", "backbone ", "decoder ")),
                      ("train_microbench", ("train step B=24 K=5 518px: ",))):
        missing = [k for k in keys if not any(ln.startswith(k) for ln in out[tag]["text"].splitlines())]
        if missing:
            bad.append(f"{tag}: no line {missing}")

    # the converter: a port checkpoint --reverse, the default mode on what it
    # wrote, --hf-backbone on an HF directory written here; then the converted
    # directory restored into a net on the card
    t0 = time.perf_counter()
    cfg = CrossScoreConfig()
    source = CrossScoreNet(cfg, device=dev)
    source.load_state_dict(params, strict=True)
    optimizer, scheduler, _ = make_optimizer(load_config("default"), source, steps_per_epoch=100)
    run_ckpt = tmp / "run" / "ckpt"
    CheckpointManager(run_ckpt).save(3, source, optimizer, scheduler, {"step": 3, "epoch": 0, "batch_in_epoch": 3})
    lightning, converted, hf_dir = tmp / "lightning.ckpt", tmp / "converted", tmp / "hf"
    convert.main([str(run_ckpt), str(lightning), "--reverse"])
    convert.main([str(lightning), str(converted)])
    hf_dir.mkdir()
    vit = cfg.backbone
    (hf_dir / "config.json").write_text(json.dumps({
        "model_type": "dinov2", "hidden_size": vit.hidden_size, "num_hidden_layers": vit.num_layers,
        "num_attention_heads": vit.num_heads, "mlp_ratio": vit.mlp_ratio, "patch_size": vit.patch_size,
        "image_size": vit.image_size, "layerscale_value": vit.layerscale_init, "layer_norm_eps": vit.layer_norm_eps}))
    torch.save({k: v.cpu() for k, v in source.backbone.state_dict().items()}, hf_dir / "pytorch_model.bin")
    convert.main([str(hf_dir), str(tmp / "backbone.pt"), "--hf-backbone"])
    blob = torch.load(lightning, map_location="cpu", weights_only=True)
    envelope = {k: blob[k] for k in ("pytorch-lightning_version", "epoch", "global_step", "loops")}
    restored = load_model_params(load_config("default_predict", overrides=[
        f"trainer.ckpt_path_to_load={converted}"]), CrossScoreNet(cfg, device=dev))
    hf_net = convert.load_backbone(CrossScoreNet(cfg, device=dev), tmp / "backbone.pt")
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    q1 = torch.randint(0, 256, (1, HW, HW, 3), generator=gen, device=dev, dtype=torch.uint8)
    r1 = torch.randint(0, 256, (1, K, HW, HW, 3), generator=gen, device=dev, dtype=torch.uint8)
    zero_launches()
    maps = {tag: make_predict_step(net)(q1, r1)["score_map_ref_cross"]
            for tag, net in (("source", source), ("restored", restored))}
    torch.cuda.synchronize()
    got, got_hf = restored.state_dict(), hf_net.backbone.state_dict()
    conv = {"envelope": envelope, "launches": {k: v for k, v in read_launches().items() if v},
            "maps_bit_equal": torch.equal(maps["source"], maps["restored"]),
            "state_bit_equal": all(torch.equal(v, got[k]) for k, v in source.state_dict().items()),
            "hf_backbone_bit_equal": all(torch.equal(v, got_hf[k]) for k, v in source.backbone.state_dict().items()),
            "s": time.perf_counter() - t0}
    out["convert"] = conv
    print(f"step 13 (b) converter at dinov2-small width: --reverse of a port checkpoint (step 3) -> envelope "
          f"{envelope}; the default mode on that file restored through tasks/common.py: every tensor bit-equal "
          f"{conv['state_bit_equal']}, the B=1 maps bit-equal to the source net's {conv['maps_bit_equal']} "
          f"(launches of the two forwards {conv['launches']}); --hf-backbone of a config.json + pytorch_model.bin "
          f"directory: the backbone bit-equal {conv['hf_backbone_bit_equal']}; {conv['s']:.1f} s")
    if envelope != {"pytorch-lightning_version": "2.1.3", "epoch": 0, "global_step": 3, "loops": {}} \
            or not (conv["maps_bit_equal"] and conv["state_bit_equal"] and conv["hf_backbone_bit_equal"]) \
            or conv["launches"] != {"K1": 24, "K2": 24, "K3": 8}:
        bad.append(f"the converter: {conv}")
    del source, restored, hf_net, optimizer, maps, got, got_hf
    work.cleanup()
    torch.cuda.empty_cache()
    out["s"] = time.perf_counter() - t_step
    print(f"step 13 (b): {out['s']:.1f} s")
    if bad:
        _fail("step 13 (b): " + "; ".join(bad))
    for run in out.values():
        if isinstance(run, dict):
            run.pop("text", None)
    return out


def _lap(t_start: float, step: int) -> None:
    """The script's time when a step ends: the breakdown of its time limit."""
    print(f"chip_smoke: steps 1-{step} done at {time.perf_counter() - t_start:.1f} s", flush=True)


def _counted_cli(argv: list) -> None:
    """``chip_smoke.py --count-launches FILE -m MODULE ARGS...``: MODULE run
    as ``python -m`` runs it, with every kernel's count from 0; the counts
    go to FILE as JSON when it ends, with the seconds from here to the
    module's start (the port's import) and to its end. Step 20 (c) runs the
    tools' CLI children so, to read their launches."""
    import runpy

    t0 = time.perf_counter()
    path, module = argv[1], argv[3]
    wrappers = _rank_launches()
    for w in wrappers.values():
        w.launches = 0
    sys.argv = [module] + argv[4:]
    t_import = time.perf_counter() - t0
    try:
        runpy.run_module(module, run_name="__main__", alter_sys=True)
    finally:
        Path(path).write_text(json.dumps({"launches": {k: w.launches for k, w in wrappers.items()},
                                          "import_s": t_import, "s": time.perf_counter() - t0}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--count-launches"]:
        _counted_cli(sys.argv[1:])
        sys.exit(0)
    sys.exit(main())
