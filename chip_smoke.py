#!/usr/bin/env python3
"""The port on one CUDA card, end to end: build the kernels, hold each
against its plain version, drive the three ported SPML train steps, the
dilated-conv probe, the flagship step with backbone remat, the
single-scale KNN inference path per image and batched, the training
drivers from an image list on disk (with a profiler window) and the
self-training chain after them (MSC, CRF, softmax inference,
pseudo-labels), two data-parallel ranks of the flagship step, the
drivers and batched inference, two height-sharded ranks of the flagship
network, the softmax baseline, the SegSort step, the DensePose point
step and the drivers, three at crop 513 (uneven shards) and at crops 15
and 6 (ranks that hold no row of the deeper maps), report.

Run from the repository root (needs one CUDA card, nvcc and no network):

    python3 chip_smoke.py
    python3 chip_smoke.py --csrc OTHER/spml_tpu_torch/csrc

The second form builds another checkout's kernel sources (say, a parent
commit's; their C signatures must be this checkout's) and runs them
under this script's checks and timings, for an A/B in one call.

Phases, each printing one line or more:
 1. device: the card's name and power limit, torch and CUDA versions;
 2. build: nvcc for sm_90a of every csrc/*.cu, one process each, in
    parallel, with the seconds it took, ptxas's registers and spilled
    bytes for each kernel, and any ptxas line on wgmma or a performance
    loss (a serialized wgmma shows there); a spill in a tiled kernel
    (stats_tile_kernel, grad_tile_kernel, each in its float32 and its
    bf16-operand form, the last template argument 0 or 1) fails the run,
    and so does a missing form or a per-row stats_kernel in this
    checkout's sources;
 3. kernels: each SegSort kernel family through its autograd.Function
    against the plain version, computed in float64 on the same float32
    values (plain version over row chunks). Every SegSort kernel is
    tiled: a block of 128 threads owns 128 rows and walks 64-row tiles of
    the other side, the products on the tensor cores in split TF32; dE
    skips the warps of 32 pixels none of which carries a nonzero
    cotangent, and the blocks with no such warp; the dP grid of 264
    blocks is split on the card into valid prototype tiles x pixel
    chunks. Cotangents are randn on every row but in the cases that say
    otherwise: each family also takes them on ~0.5% of the rows in short
    runs, on none (dE and dP must then be exactly 0) and on the last row
    of a ragged N alone, and the hard family at DensePose's 139 valid
    rows on 354 rows in runs, the path's own sparsity; dE must be exactly
    0 on every row without one.
    - joint, K1 (stats), K2 (dE), K3 (dP): at N = 16384 / P = 2048,
      D = 64 (full and ~20% fill, N not a multiple of the tile, all
      prototypes invalid, one valid, both kappa branches) and D = 32 (~20%
      fill), and at the flagship N = 131072 / P = 6144, D = 64;
    - hard labels, K4 (stats), K5 (dE), K6 (dP): at N = 16384 / P = 2048,
      D = 32 (full and ~20% fill, ragged N, all invalid, one valid, 64
      and 65 valid: the last prototype tile one full tile or one row) and
      D = 64, and at the DensePose N = 65536 / P = 2048, D = 32, ~15% fill
      and 139 valid rows, the path's own (K6's second prototype tile: 11
      live rows, three warps skipping);
    - tag sets, K7 (stats), K8 (dE), K9 (dP): at N = 16384 / P = 2048,
      D = 64 (full and ~20% fill, ragged N, all invalid, one valid: one
      live prototype tile over 264 pixel chunks) and D = 32, and at
      the tag step's N = 65536 / P = 3072, D = 64, ~20% fill; one to three
      tags of 20 per row, a tenth of the rows below the valid count
      invalid (their own mask still counts);
    - the bf16-operand forms of K1-K9 (tpu.loss_operand_dtype
      "bfloat16": E and P read as bf16, one TF32 product of bf16 values,
      c rounded to the nearest bf16 before product 2) on each family's
      BF16_CASES (full and ~20% fill, ragged N, zero cotangents) and its
      main-path sized case, against the plain version in float64 on the
      same bf16 values with c rounded (segsort_loss._PlainBf16), dE and
      dP within their tolerance plus the spread of c's rounding
      (segsort_loss.bf16_rounding_spread: pairs whose float32 and float64
      c may round to different bf16 neighbours); then at the main-path
      sized case against the float32 forms, at the JAX package's
      quantified delta (BF16_LOSS_RTOL on each masked-mean loss,
      BF16_GRAD_COS on dE and dP of their sum), both printed;
    - the dP kernels K3, K6 and K9, float32 and bf16 operands, at N = 0
      (a height-sharded rank with no row of the embeddings) with ~20% of
      P = 2048 valid: dP exactly 0, as the plain version gives, and the
      stats and dE empty (check_no_pixels);
    - the dilated conv K10 against its plain version in float64 on the
      same bf16 values: ragged shapes at d = 1, 2, 4 (B = 1, H and W not
      multiples of the 8 x 16 tile, C = 16 and 48 under a 64-channel box,
      O = 16 and 144 filling part of a 256-channel tile), a 3 x 3 image
      at d = 4 where every tap but the centre lies outside, two channel
      chunks with two N tiles, and the probe's two shapes (B = 8,
      64 x 64, 256 -> 256 at d = 2, 512 -> 512 at d = 4);
 4. main paths, each from random weights of seed 0, 3 warm-up and 10
    timed steps, every loss finite, segments formed, each of its kernels
    launched once per step and the other families' not at all, the KNN
    kernels (the top-5 retrieval accuracy) once a logged step; then each
    kernel timed at the path's own inputs beside the plain version and its
    bound (every SegSort kernel: at the split-TF32 rate its products use,
    with the float32 bound beside it as bound_f32_ms); dE and dP on randn
    cotangents, and again on the cotangents the path's last backward
    handed them (path_cotangent_ms, beside a bound that counts only the
    pixels carrying a nonzero one). Each SegSort recipe runs twice: as
    shipped (float32 operands) and with tpu.loss_operand_dtype
    "bfloat16", where its bf16 forms launch once a step and no float32
    form; the bf16 forms timed at that arm's inputs beside the bf16 plain
    version and a bound at the bf16 tensor-core peak; a line gives both
    arms' ms/step and peak memory:
    - flagship (panoptic_deeplab_101, crop 512, batch 8, 6x6 k-means x10,
      capacity 256, memory bank 2, sem_ann + sem_occ + img_sim with the
      fused joint loss, bf16 convolutions) on blobby synthetic labels:
      K1-K3;
    - DensePose point (panoptic_pspnet_101_densepose, dim 32, crop 512,
      batch 4, 12x12 k-means x10, capacity 512, no memory bank, sem_ann
      + img_sim with the fused hard-label loss, bf16 convolutions) on
      synthetic point labels, with labelled pixels in the loss: K4-K6;
    - VOC image tags, tags only (the flagship network at batch 4, sem_ann
      off, sem_occ + img_sim with the fused tag-set loss) on the flagship's
      blobby labels: K7-K9;
    - the dilated-conv probe (spml_tpu_torch/tools/dilated_conv_probe.py)
      at its two shapes: K10, then K10 timed at the first shape (res4 d2)
      beside its plain version, cuDNN (F.conv2d, the library yardstick)
      and its bound at the bf16 tensor-core peak;
    - the KNN kernels of csrc/knn_topk.cu alone at VOC's inference shape
      (144 unit queries, BANK_SIZE unit prototypes, D 64, top 20, labels
      the bank index): rows equal to the plain version's (the scores and
      a stable sort on the card), each differing row's first difference
      a float64 near-tie, at least KNN_ROWS_EQUAL; CUDA events over 20
      calls of the kernels, of the plain version and of the library's
      own top-k (the scores, the mask and torch.topk, whose tie order is
      unspecified), and the bound as the SegSort kernels' (the products
      in split TF32, the float32 bound beside it as bound_f32_ms);
 5. remat, the flagship recipe from one seed-0 state and one batch with
    no remat, tpu.remat_backbone (every block of res3-res5 under
    torch.utils.checkpoint; the frozen stem and res2 run plainly) and
    tpu.remat_stages (4,): after one step the losses and every parameter
    within REMAT_RTOL / REMAT_ATOL of the no-remat step's, every BN
    buffer and num_batches_tracked equal; 3 warm-up and 10 timed steps
    (CUDA events), K1-K3 once a step and no other kernel; one [remat]
    line: ms/step, peak memory, the largest difference in tolerances;
 6. dp, DP_WORLD = 2 ranks (parallel/mesh.py::spawn, once, the kernels
    built before it): NCCL on cuda:0 / cuda:1 with two or more cards,
    else gloo with both ranks on cuda:0 (NCCL refuses two ranks on one
    card), the case printed; a rank that fails fails the script.
    (a) float32 with TF32 off, the classifier's dropout 0: one flagship
    step (train.batch_size DP_BATCH 4 a rank) of 2 ranks x 4 against
    one process x 8 (train.batch_size 4: the same two loss groups), from
    one seed-0 state and one global batch, once on the one process's
    k-means segments and once free (each side clustering its own
    embeddings; compare_step, DP_CHECKS): losses within DP_LOSS_RTOL;
    the bank's labels, tags, validity and batch indices and the integer
    buffers equal; the L2 of every update's difference within
    DP_UPDATE_RTOL of the updates'; bank prototypes of the segments with
    the same pixels in both within DP_BANK_ATOL; and, on the one
    process's segments, every bank prototype within DP_BANK_ATOL and the
    update of each tensor tests/test_torch_train_step.py checks
    (DP_CHECKED) within DP_UPDATE_RTOL max|update| + one float32 unit.
    Each tolerance adds the float32 floor of its mode: the largest
    difference between the one-process step and the same step in
    DP_FLOOR_RUNS (the halves swapped; plain-autograd BN in float32 and
    with float64 statistics), which run none of the data-parallel code.
    Free, k-means near-ties move pixels to other segments in every
    arithmetic, so the updates and the whole bank are printed there
    beside the floor runs', each of those held to the floor of the other
    two, and the pixels in other segments counted. The ranks'
    parameters, buffers and banks equal (sha256). (b) K1-K3 once a rank
    in each of those steps, at N 65,536 and P 6,144; (c) bf16, 3 warm-up
    and 10 timed steps a rank (CUDA events), then 3 with every collective
    timed by the label its call site gives it (the gradient sum, batch
    norms, the prototype gather, the rest; an unlabelled one fails),
    beside one process x 8 timed the same way; (d)
    train_spml (the driver phase's stage 1 at batch 4 a rank) on a world
    of WORLD_IMAGES images for 4 iterations and resumed to 6: K1-K3 once
    a step a rank, iterations 0-3 then 4-5, checkpoints 2, 4, 6 from rank
    0 with both ranks' generator states, tpu.num_devices 2, the ranks
    equal; (e) train_classifier over that snapshot, 2 iterations, no
    kernel, the heads equal; (f) run_knn_inference in float32 with
    infer_batch DP_INFER_BATCH 4 over DP_INFER_IMAGES 8 images sharded
    over the ranks (the bank from run_prototype on rank 0), run_benchmark
    on rank 0: its PNGs equal a one-process run's; (g) (a)'s step on the
    one process's segments with tpu.loss_operand_dtype "bfloat16":
    K1-K3's bf16 forms once a rank at (a)'s N and P, each loss within
    BF16_LOSS_RTOL of the one process's float32 step and each checked
    update within its tolerance + float32 floor + plain-bf16 floor (the
    one process's step with segsort_loss._PlainBf16 statistics against
    its float32 step: bf16_reference), with the share of those limits a
    rank counted twice reaches in the one process's float32 step printed
    beside it. Lines (a)-(g) and
    a summary: the case, ms/step, global images/s, peak a rank, the
    nvidia-smi line;
 7. sp, height-sharded training (tpu.spatial_partition, parallel/
    halo.py): SP_SPACE = 2 space ranks of one data rank spawned once (as
    dp: NCCL on two cards, else gloo with both on cuda:0). (a) float32
    with TF32 off: the flagship network (panoptic_deeplab_101, 64-d) from
    seed 0, BN momentum 0.1, every parameter trained, in train mode on
    SP_BATCH 8 blobby images at crop 512, one forward and the backward
    of a seeded cotangent: the ranks' rows (256 image rows each) joined
    against one process's embeddings (SP_EMB_ATOL x max), location
    features (equal), BN running statistics' updates (SP_STAT_RTOL) and
    every parameter gradient (SP_GRAD_RTOL in L2, each and all), each
    plus the float32 floor of SP_FLOOR_RUNS (the one process in cuDNN's
    benchmark mode, with the images reversed, in NCHW), which run none of
    the spatial code; (b) the softmax baseline (network.prediction_types
    softmax_classifier) on the flagship recipe in bf16 at the global
    batch 8: 3 warm-up and 10 timed steps a rank, then 3 with every
    collective timed by its label (the gradient sum, batch norms, halo
    exchanges, the rest), beside one process x 8 timed the same way;
    (c) train_spml with the softmax baseline (the driver phase's stage
    1, batch 4, tensorboard_step 1: the image panels' eval forward on
    both ranks) on a fresh world of WORLD_IMAGES images for 4 iterations
    and resumed to 6, then train_classifier over its snapshot for 2: the
    iterations, checkpoints 2, 4, 6 from rank 0 with both generator
    states, tpu.num_devices 2, finite losses, the ranks' tensors equal
    (sha256), no kernel launched (the path has none). The SegSort branch
    on the flagship recipe (fused joint loss, bank 2): (d) float32 (TF32
    off, dropout 0) at SP_SEG_BATCH 8, free and on the one process's
    k-means segments (each rank its rows of them), [dp] (a)'s checks and
    DP_* tolerances, each plus the floor of SP_SEG_FLOOR_RUNS (the one
    process with the batch's halves swapped, with batch norm by plain
    autograd, in NCHW: none of the spatial code), K1-K3 once a step a
    rank at N 65,536 (its rows) and P 6,144, the ranks equal (sha256);
    float64 at SP_SEG_F64_BATCH 2 with the dense losses: the segments
    and bank labels equal the one process's, the losses, every gradient
    element (over its max) and the bank within SP_F64_RTOL + the floor
    of the batch reversed; (e) the tags-only and sem_ann-only arms, one
    float32 step at batch 2 on the one process's segments: losses
    within DP_LOSS_RTOL, K7-K9 and K4-K6 once a rank; (f) the bf16 step,
    3 warm-up and 10 timed steps a rank, then 3 with every collective
    timed by its label (SP_SEG_KINDS: with "segments", k-means' and the
    prototypes' sums over the space group), beside one process x 8;
    (g) train_spml on the driver phase's stage 1 (SegSort, batch 4) for
    4 iterations resumed to 6: K1-K3 once an iteration, checkpoints 2,
    4, 6 from rank 0, the ranks equal. DensePose, PSPP's pools summed
    over the space group and the colour features made from the gathered
    images (the DensePose point recipe, panoptic_pspnet_101_densepose,
    32-d, crop 512, 12x12 k-means x10, capacity 512, no bank, the fused
    hard-label loss, at its global batch SP_DP_BATCH 4): (h) float32
    (TF32 off, dropout 0) on the one process's segments, [dp] (a)'s
    checks over the tensors of SP_DP_CHECKED, each tolerance plus the
    floor of SP_SEG_FLOOR_RUNS, K4-K6 once a rank at N 32,768 and P
    2,048; then the recipe as it ships (bf16 convolutions), 3 warm-up
    and 10 timed steps a rank and 3 with every collective timed by its
    label (SP_DP_KINDS: "pool" and "colour" among them), beside one
    process; (i) float64 at SP_SEG_F64_BATCH with the dense losses and
    sem_occ + tpu.apply_feat_aff (NN-propagated tags, feat_aff), held as
    (d)'s float64 run; (j) (h)'s step with tpu.loss_operand_dtype
    "bfloat16": K4-K6's bf16 forms once a rank, each loss within
    BF16_LOSS_RTOL of the one process's float32 step and each checked
    update within its bf16 limit, as [dp] (g); (k) the DensePose
    CLIs' drivers (dropout 0) on SP_DP_WORLD_IMAGES point-labelled
    images: train_spml with DenseposeTagDataset for SP_DP_DRIVER_ITERS
    iterations in float64 (the dense losses; the ranks on the one
    process's k-means segments), its logged losses within SP_F64_RTOL of
    one process's, then train_classifier with DenseposeClassifierDataset
    over its snapshot in float32, within DP_LOSS_RTOL (no kernel in
    either), the ranks equal. Lines (a)-(k) and a summary: ms/step and
    peak a rank against one process, the nvidia-smi line. Then uneven
    shards, a second spawn of SP3_SPACE = 3 space ranks (NCCL with a
    card each when there are 3, else gloo with all on cuda:0) at crop
    SP3_CROP = 513, DeepLab-v2's VOC training crop (each map split by
    halo.partition: 257 and 65 rows at strides 2 and 8, the embedding
    grid's 130 as 43, 43, 44): (l) the flagship
    SegSort step (fused joint loss, bank 2) in float32 at SP_SEG_BATCH 8
    on the one process's segments, [dp] (a)'s checks each plus the floor
    of SP_SEG_FLOOR_RUNS, K1-K3 once a step a rank at its own N (44,720
    / 44,720 / 45,760) and P 6,144, the ranks equal; float64 at
    SP_SEG_F64_BATCH 2, dense losses, as (d)'s float64 run; the bf16
    step as it ships, 3 warm-up and 10 timed steps a rank, collectives
    by label, beside one process; (m) the same for the DensePose point
    step at SP_DP_BATCH 4, K4-K6 (N 22,360 / 22,360 / 22,880, P 2,048).
    In the same spawn, (n): ranks that hold no row of a map, the same
    two steps at crop heights SP3_EMPTY_CROPS, SP3_CROP wide (15: the
    stride-8 map's 2 rows as none, 1, 1, the embedding grid's 4 as 1, 1,
    2; 6: the stride-8 map's 1 row as none, none, 1, the embedding
    grid's 2 as none, 1, 1, so rank 0 calls K1-K3 and K4-K6 with N = 0,
    which start no stats or dE grid), float32 on the one process's
    segments and float64 dense, held as (l) and (m) but for the losses
    and the update L2, also held at tolerance + their floor there (the
    floor runs of the DensePose step at 15 rows lie past the bare L2
    tolerance), and DensePose's img_sim, printed beside its floor, not
    held (SP3_UNHELD); each rank's N and launches printed (K3 and K6 on
    every rank, K1, K2, K4, K5 where N > 0), the float32 step's ms and
    peak a rank (one step, the first at its shapes), no bf16 timing.
    Lines (l), (m), (n) and a summary with the phase's seconds, (n)'s
    among them;
 8. inference, the single-scale KNN path at VOC's test geometry
    (bashscripts/voc12/train_spml_scribble.sh:50-52, 82-100; no custom
    kernel on it): panoptic_deeplab_101 from random weights of seed 0
    (cli.build_eval_models without a snapshot; eval mode, bf16 convs),
    test.image_size 512, crop = stride = 512, 12x12 k-means x10, 21
    classes, top 20. build_prototypes on 8 blobby images (512 x 384 and
    384 x 512); a bank of 1,523,808 (VOC train_aug's 10,582 images x 144
    clusters): each built prototype 20 times, the rest random unit
    vectors with labels 0-20 (seed 0); predict_semantic on the same 8.
    Checks: (a) labels in [0, 21); (b) each prediction equals its own
    clusters' majority labels, but on clusters whose float64
    self-affinity lies within TIE_GAP of another prototype's; (c) on a
    fresh image, the top-20 labels equal a float64 recomputation on the
    card as multisets, but where the 20th and 21st float64 affinities
    lie within TIE_GAP, and the stages composed equal predict_semantic;
    then the device path against the CPU path in float32 (crop 128,
    stride 64, a 192 x 160 image: 2 x 2 windows): the stitched map within
    STITCH_RTOL, clusters, labels and predictions equal. One [inference]
    line: build and predict ms/image and images/s (CUDA events, 3
    warm-up and 10 timed images; the KNN kernels launched once each an
    image), the split of a prediction (upload, forward, stitch, kmeans,
    knn, vote), peak memory, the nvidia-smi line. Then (d) batched prediction, predict_semantic_batch over
    groups of INFER_BATCH 4 of the 8 images (one bucket) against the
    same bank: in bf16 each prediction equals the stages run on its
    group's stitched map, which lies within BF16_STITCH_ATOL of the
    image's own (cuDNN rounds otherwise at batch 4), and the pixels that
    differ from predict_semantic's are counted; in float32 (TF32 off,
    the same weights) each prediction equals predict_semantic's; a
    second [inference] line: batched ms/image (CUDA events, 4 groups
    after one) and peak memory beside the per-image ones;
 9. driver, the train entry points as a user runs them, on a world of 24
    JPEGs (500 x 375 and 375 x 500) with blobby 21-class PNG labels
    (255 around each blob) and ~30 Voronoi segments each as instance
    maps, written from seed 0 (spml_tpu_torch/data/synthetic.py):
    - stage 1, train/driver.py::train_spml with ListTagDataset on the
      recipe of bashscripts/voc12/train_spml_scribble.sh:17-46
      (panoptic_deeplab_101, 64-d, bf16 convs, batch 4, crop 512,
      mirror / scale / crop, 4 loader threads, 6 x 6 k-means x 10,
      capacity 256, memory bank 2, kappa 6 / 12 / 16 with weights 1 /
      0.5 / 0.1, tpu.use_fused_loss on), 4 iterations with snapshot_step
      2, then again with train.resume to iteration 6: finite losses,
      K1-K3 launched once a step and no other kernel, the second call
      starting at step 4 at the schedule's LR of step 4, checkpoints 2,
      4 and 6; then K1-K3 on the stats inputs of step 6 (N = 65536,
      P = 3072, D = 64, kappa 6 / 12), on the cotangents its backward
      handed them and on randn ones, against the plain version as in
      phase 3; a line saying the C++ train item (native/dataio) is not
      ported and which of its headers g++ cannot include on the host
      (tools/dataio_probe.py); then stage 1 from scratch for 3
      iterations with the profiler window tpu.profile_start 1,
      profile_steps 2 (train/driver.py::TraceWindow): one Chrome trace
      holding exactly 2 launches each of K1, K2 and K3 and no other
      SegSort kernel, its path, size and event count printed;
    - the single-scale KNN chain on that snapshot (cli.build_eval_models
      reads the port checkpoint): run_prototype over 8 images,
      run_knn_inference over 4 (12 x 12 clusters), run_benchmark: the
      mIoU a finite number in [0, 1], the 4 PNGs written;
    - stage 2, train_classifier with ListTagClassifierDataset over the
      stage-1 snapshot (softmax_classifier, batch 16, crop 512, no
      k-means, 1 x 1 clusters; train_spml_scribble.sh:123-129), 12
      iterations: every embedding parameter and BN buffer equal to stage
      1's, every head parameter changed, finite losses, no kernel; and
      the two runs' loaders alone, ms a batch over 8 batches with no
      step running;
    - the baseline, train_spml with softmax_classifier and Adam, batch
      4, 12 iterations: no kernel, the memory bank empty, the stem and
      res2 unchanged and every res3-5 parameter changed, finite losses.
    For stages 1 and 2 and the baseline a [driver] line: the steady state
    over the steps after the first (each step call between CUDA events
    and a synchronize): host ms in the step call, the loader wait
    (next(loader)) ms, device ms, images/s; the same over the steps after
    the first 5 (after the 4 batches prefetched during the first step are
    used up) with the data-wait share, wait / (wait + step call); each
    step's wait, the first step; then the same step replayed on the
    run's last batch with the loader closed, timed the same way and back
    to back (as the recipes are); peak memory, the nvidia-smi line;
10. selftrain, the VOC scribble recipe after stage 1
    (train_spml_scribble.sh:82-170) on the driver phase's world and
    snapshots, at full width (no custom kernel on it): (a)
    run_knn_inference on the stage-1 snapshot and bank over 4 images with
    MSC (scales 0.5-1.5 x flips) + CRF, and with MSC alone, whose labels
    must equal the float64 argmax of the very float32 sums it resized
    but at near-ties (MSC_TIE_GAP); (b) run_softmax_inference of the
    stage-2 snapshot with MSC + CRF and without; (c) run_pseudo_softmax
    (walk, CRF, scales (1.0,)) over the 24 images, run_benchmark on it,
    the list rewritten to the pseudo-labels as the recipe's sed does, 2
    steps of train_classifier on it; (d) run_pseudo_knn and
    run_pseudo_camrw_crf (CAMs from data/synthetic.py) over 4 images,
    run_pseudo_densepose over 2 point-labelled images on
    panoptic_pspnet_101_densepose from seed 0 weights; (e) the walk at a
    500 x 375 image's grid (n = 2852) against float64 on the card, the
    KNN and softmax pyramids against the CPU in float32 (crop 128, stride
    64, 192 x 160), the CRF twice equal, no SegSort or K10 launch in the
    phase; one [selftrain] line: ms/image of KNN MSC + CRF (device
    pyramid, float16 download, host CRF), of the softmax pyramid and of
    the pseudo-label step (forward, affinity, walk, CRF), peak memory,
    the nvidia-smi line;
11. the kernel list as one JSON line: the nine SegSort kernels in
    float32 and in bf16 operands (the _bf16 names), K10 and the KNN
    kernels;
12. the card's name and power limit (nvidia-smi), then the last line
    {"ok": true, "device": {...}}.

Any failed phase raises: the script exits non-zero and prints no result.
Tolerances: the SegSort statistics rtol 1e-5 (float32 sums in another
order, amplified by exp(kappa * logit)); dE and dP rtol 1e-4 with atol
1e-5 * max|reference|, for the bf16 forms plus the spread of c's bf16
rounding (segsort_loss.C_REL_ERR: the float32 c's error, 2^-14 of its
terms); the bf16 forms against float32 JAX's delta (loss rtol 1.5e-2,
gradient cosine > 0.999); the dilated conv rtol 2^-8 (one bf16 rounding of
the output) with atol 1e-3 * max|reference| (float32 sums of 9 C terms
that cancel near zero); inference TIE_GAP 1e-5 (float32 rounding of a
64-term dot of unit vectors stays below 3.8e-6), the stitched map rtol
1e-4 with atol 1e-5 * max|CPU| (cuDNN against oneDNN through ResNet-101);
selftrain: MSC_TIE_GAP 1e-4 (float32 sums of 10 members' values up to
1), the walk rtol 1e-3 with atol 1e-4 * max|float64| (six float32
squarings of [n, n] products), the pyramids' float32 probabilities card
against CPU rtol 1e-5 / atol 1e-6 (KNN: exact one-hot means, resize sums
alone differ) and rtol 1e-3 / atol 1e-4 (softmax: the stitch's rtol
through the logits), their labels equal but where the CPU's top two lie
within that tolerance; remat REMAT_RTOL 2e-4 with REMAT_ATOL 1e-6 (the
JAX package's tests/test_train_step.py::test_remat_stages_exactness: the
backward's sums in another order); batched bf16 BF16_STITCH_ATOL 2^-6
(two bf16 roundings of a unit-scale component); dp those of
tests/test_torch_train_step.py for another reduction order (DP_*, at
their definition); sp SP_* at their definition.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"  # every tensor of the run lives here
STATS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL_REL = 1e-4, 1e-5
CONV_RTOL, CONV_ATOL_REL = 2.0 ** -8, 1e-3
# NVIDIA H100 SXM data sheet: float32 outside the tensor cores, dense
# bf16 on the tensor cores, HBM3
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
PALLAS = "spml_tpu/ops/pallas/segsort_loss.py"
PROBE = "pyscripts/misc/pallas_dilated_conv_probe.py"
SEGSORT_SOURCE = "spml_tpu_torch/csrc/segsort_joint.cu"
F32_KERNELS = {  # launch counter -> (name, line of the TPU kernel replaced)
    "joint_stats": ("segsort_joint_stats", f"{PALLAS}:664"),
    "joint_grad_emb": ("segsort_joint_grad_emb", f"{PALLAS}:716"),
    "joint_grad_proto": ("segsort_joint_grad_proto", f"{PALLAS}:716"),
    "hard_stats": ("segsort_hard_stats", f"{PALLAS}:130"),
    "hard_grad_emb": ("segsort_hard_grad_emb", f"{PALLAS}:200"),
    "hard_grad_proto": ("segsort_hard_grad_proto", f"{PALLAS}:240"),
    "set_stats": ("segsort_set_stats", f"{PALLAS}:408"),
    "set_grad_emb": ("segsort_set_grad_emb", f"{PALLAS}:444"),
    "set_grad_proto": ("segsort_set_grad_proto", f"{PALLAS}:444"),
}
# the bf16-operand forms (tpu.loss_operand_dtype "bfloat16"): the same TPU
# kernels, run with bf16 operands
BF16 = "_bf16"
KERNELS = {**F32_KERNELS,
           **{key + BF16: (name + BF16, replaces)
              for key, (name, replaces) in F32_KERNELS.items()}}
# kernels whose D-long products run on the tensor cores in split TF32 (the
# bf16 forms: one TF32 product of bf16 values)
TENSOR_CORE = tuple(F32_KERNELS)
# the tiled SegSort kernels: a spill in any of them fails the build phase
TILED_KERNELS = ("stats_tile_kernel", "grad_tile_kernel")
PER_ROW_KERNEL = "stats_kernel<"  # retired: fails the build phase
CONV_KERNEL = ("dilated_conv3x3_bf16", f"{PROBE}:31",
               "spml_tpu_torch/csrc/dilated_conv.cu")
KINDS = ("stats", "grad_emb", "grad_proto")
N_STATS = {"joint": 6, "hard": 3, "set": 3}
N_KAPPAS = {"joint": 2, "hard": 1, "set": 1}
# recipe (spml_tpu_torch/train/recipes.py) -> family of its loss kernels
RECIPE_FAMILY = {"flagship": "joint", "densepose_point": "hard",
                 "voc_tag": "set"}
# JAX's quantified delta of the bf16 operands against float32
# (tests/test_pallas_loss.py:295-325): the loss rtol, the gradients' cosine
BF16_LOSS_RTOL, BF16_GRAD_COS = 1.5e-2, 0.999


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def kernel_name(mangled):
    """A kernel's name and integer template arguments from its mangled
    name (grad_tile_kernel<64,0,1>); other names as they are."""
    m = re.match(r"_ZN(\d+)_GLOBAL__N_", mangled)  # anonymous namespace
    if not m:
        return mangled
    rest = mangled[m.end(1) + int(m.group(1)):]
    m = re.match(r"\d+", rest)
    end = m.end() + int(m.group(0))
    name, args = rest[m.end():end], re.match(r"I((?:L[a-z]+\d+E)+)E",
                                             rest[end:])
    if args:
        name += "<" + ",".join(re.findall(r"L[a-z]+(\d+)E", args.group(1))) \
            + ">"
    return name


def ptxas_kernels(report):
    """[(kernel, registers, spilled bytes stored + loaded)] of a ptxas -v
    report."""
    out, name, spill = [], None, 0
    for ln in report.splitlines():
        if m := re.search(r"Compiling entry function '(\S+)'", ln):
            name, spill = kernel_name(m.group(1)), 0
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                            r"loads", ln):
            spill = int(m.group(1)) + int(m.group(2))
        elif (m := re.search(r"Used (\d+) registers", ln)) and name:
            out.append((name, int(m.group(1)), spill))
            name = None
    return out


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Kernel checks
# ---------------------------------------------------------------------------

def make_case(torch, n, p, fill, seed, d=64, n_classes=21, n_tags=20,
              sparse_tags=False):
    """Inputs of the SegSort kernels as the wrapper hands them over:
    prototypes sorted valid-first, pixels near their own prototype.
    sparse_tags (the set family's cases): one to three tags per row, as
    images carry, a sixth of the prototypes tagless, and a tenth of the
    rows below the valid count invalid (touched only as an own
    prototype)."""
    rng = np.random.RandomState(seed)
    nv = int(round(fill * p))
    protos = rng.randn(p, d)
    protos /= np.linalg.norm(protos, axis=1, keepdims=True)
    own = rng.randint(0, max(nv, 1), n)
    stray = rng.rand(n) < 0.05  # own prototype past the valid count
    own[stray] = rng.randint(0, p, stray.sum())
    emb = protos[own] + 0.35 * rng.randn(n, d) / math.sqrt(d)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    plab = np.where(np.arange(p) < nv, rng.randint(0, n_classes, p), -1)
    pval = (np.arange(p) < nv).astype(np.int32)
    ptag = rng.randint(0, 2 ** n_tags, p)
    lab = np.where(rng.rand(n) < 0.9, plab[own], rng.randint(0, n_classes,
                                                             n))
    tag = rng.randint(0, 2 ** n_tags, n)
    if sparse_tags:
        def few_tags(k):
            bits = [1 << rng.randint(0, n_tags, k) for _ in range(3)]
            return np.where(rng.rand(k) < 0.5, bits[0], 0) | \
                np.where(rng.rand(k) < 0.3, bits[1], 0) | bits[2]
        ptag = np.where(rng.rand(p) < 1 / 6, 0, few_tags(p))
        tag = np.where(rng.rand(n) < 0.7, ptag[own], few_tags(n))
        pval[rng.rand(p) < 0.1] = 0

    def cuda(a, dt):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                               device=DEVICE)

    f32, i32 = torch.float32, torch.int32
    return dict(emb=cuda(emb, f32), pix_lab=cuda(lab, i32),
                own_idx=cuda(own, i32), pix_tags=cuda(tag, i32),
                protos=cuda(protos, f32), proto_lab=cuda(plab, i32),
                proto_tags=cuda(ptag, i32), proto_valid=cuda(pval, i32),
                num_valid=cuda([nv], i32))


# the positional tensor arguments of each family's stats function; the
# kappas follow them
STATS_ARGS = {
    "joint": ("emb", "pix_lab", "own_idx", "pix_tags", "protos",
              "proto_lab", "proto_tags", "proto_valid", "num_valid"),
    "set": ("emb", "pix_tags", "own_idx", "protos", "proto_tags",
            "proto_valid", "num_valid"),
    "hard": ("emb", "pix_lab", "own_idx", "protos", "proto_lab",
             "num_valid")}
PIXEL_ARGS = ("pix_lab", "own_idx", "pix_tags")


def stats_args(family, case, emb, protos, rows=slice(None)):
    """The positional tensor arguments of the family's stats function
    (pixel arrays cut to `rows`)."""
    given = {"emb": emb, "protos": protos}
    return [given[k] if k in given else
            case[k][rows] if k in PIXEL_ARGS else case[k]
            for k in STATS_ARGS[family]]


STATS_FN = {"joint": "joint_segsort_stats", "hard": "segsort_stats",
            "set": "set_segsort_stats"}


def stats_fns(fused, family):
    """(kernel path, plain version) of a family."""
    name = STATS_FN[family]
    return getattr(fused, name), getattr(fused, name + "_reference")


def reference64(torch, fused, family, case, grads, kappas, rows=16384,
                operand_dtype="float32"):
    """Plain version in float64 over row chunks: stats, dE, dP, and the
    spread that c's bf16 rounding allows dE and dP (zeros for float32
    operands; segsort_loss.bf16_rounding_spread)."""
    stats, d_emb, spread_e = [], [], []
    d_protos = torch.zeros_like(case["protos"], dtype=torch.float64)
    spread_p = torch.zeros_like(d_protos)
    n = case["emb"].shape[0]
    plain = stats_fns(fused, family)[1]
    for r0 in range(0, max(n, 1), rows):  # N = 0: one empty chunk
        sl = slice(r0, min(r0 + rows, n))
        e = case["emb"][sl].double().requires_grad_(True)
        p = case["protos"].double().requires_grad_(True)
        args = stats_args(family, case, e, p, sl)
        s = plain(*args, *kappas, operand_dtype=operand_dtype)
        g = grads[:, sl].double()
        ge, gp = torch.autograd.grad((s * g).sum(), (e, p))
        stats.append(s.detach())
        d_emb.append(ge)
        d_protos += gp
        if operand_dtype == "bfloat16":
            se, sp = fused.bf16_rounding_spread(
                family, [a.detach() for a in args] + list(kappas), g)
            spread_e.append(se)
            spread_p += sp
    spread_e = torch.cat(spread_e) if spread_e else torch.zeros_like(
        case["emb"], dtype=torch.float64)
    return (torch.cat(stats, 1), torch.cat(d_emb), d_protos, spread_e,
            spread_p)


def kernel_outputs(torch, fused, family, case, grads, kappas,
                   operand_dtype="float32"):
    e = case["emb"].clone().requires_grad_(True)
    p = case["protos"].clone().requires_grad_(True)
    s = stats_fns(fused, family)[0](*stats_args(family, case, e, p),
                                    *kappas, operand_dtype=operand_dtype)
    s.backward(grads)
    torch.cuda.synchronize()
    if e.grad.dtype != torch.float32 or p.grad.dtype != torch.float32:
        raise AssertionError(f"{operand_dtype} operands: gradients "
                             f"{e.grad.dtype}, {p.grad.dtype}, not float32")
    return s.detach(), e.grad, p.grad


def carrying_rows(n, kind, seed):
    """[N] bool, the rows given a nonzero cotangent: every row ("randn");
    short runs of 1 to 3 rows at random starts over ~0.5% of the rows
    ("runs"), or over 354 rows ("densepose"), as the DensePose step's
    labelled points fall; none ("zero"); the last row alone ("last")."""
    rows = np.zeros(n, bool)
    if kind == "randn":
        rows[:] = True
    elif kind == "last":
        rows[-1] = True
    elif kind in ("runs", "densepose"):
        want = 354 if kind == "densepose" else round(0.005 * n)
        rng = np.random.RandomState(seed)
        while rows.sum() < want:
            start = rng.randint(0, n)
            rows[start:start + min(rng.randint(1, 4), want - rows.sum())] \
                = True
    elif kind != "zero":
        raise ValueError(kind)
    return rows


def check_case(torch, fused, family, label, case, kappas, seed,
               cotangents="randn", operand_dtype="float32"):
    """The family's three kernels on one case, against the plain version;
    the cotangents are randn on the rows of carrying_rows(cotangents), 0
    on the others, or the [stats, N] tensor `cotangents` itself; dE must
    be exactly 0 on the rows without one (dE and dP both when no row
    carries one). operand_dtype "bfloat16": the bf16 forms against the
    plain version's, dE and dP within the tolerance plus the spread of
    c's rounding (reference64)."""
    n = case["emb"].shape[0]
    if torch.is_tensor(cotangents):
        g = cotangents
        carries = (g != 0).any(0)
    else:
        g = torch.randn(N_STATS[family], n, device=DEVICE,
                        generator=torch.Generator(DEVICE).manual_seed(seed))
        carries = torch.as_tensor(carrying_rows(n, cotangents, seed),
                                  device=DEVICE)
        g = torch.where(carries, g, 0.0)
    s, de, dp = kernel_outputs(torch, fused, family, case, g, kappas,
                               operand_dtype)
    rs, rde, rdp, spread_e, spread_p = reference64(
        torch, fused, family, case, g, kappas, operand_dtype=operand_dtype)
    errs, margins = {}, {}
    for name, got, ref, rtol, atol, spread in (
            ("stats", s, rs, STATS_RTOL, 0.0, 0.0),
            ("dE", de, rde, GRAD_RTOL, GRAD_ATOL_REL, spread_e),
            ("dP", dp, rdp, GRAD_RTOL, GRAD_ATOL_REL, spread_p)):
        if not torch.isfinite(got).all():
            raise AssertionError(f"{label}: {name} not finite")
        abs_tol = atol * float(ref.abs().max())
        err = (got.double() - ref).abs()
        tol = abs_tol + rtol * ref.abs() + spread
        if not (err <= tol).all():
            worst = int((err - tol).argmax())
            raise AssertionError(
                f"{label} {name}: {int((err > tol).sum())} of "
                f"{err.numel()} elements past the tolerance; worst at "
                f"{worst}: got {float(got.flatten()[worst])}, want "
                f"{float(ref.flatten()[worst])}, tolerance "
                f"{float(tol.flatten()[worst])}")
        errs[name] = float(err.max())
        # share of the tolerance used by the worst element (<= 1 passes)
        margins[name] = float((err / tol.clamp(min=1e-38)).max())
    if not (de[~carries] == 0).all():
        raise AssertionError(f"{label}: dE not exactly 0 on a row without a "
                             "cotangent")
    if not carries.any() and not (dp == 0).all():
        raise AssertionError(f"{label}: dP not exactly 0 under zero "
                             "cotangents")
    log("kernels", f"{family}{fused.OPERAND_DTYPES[operand_dtype][1]} "
        f"{label}: N={n} P={case['protos'].shape[0]} "
        f"D={case['emb'].shape[1]} valid={int(case['num_valid'])} "
        f"kappa={kappas} rows with a cotangent {int(carries.sum())} "
        "max_abs_err "
        + " ".join(f"{k}={v:.3e}" for k, v in errs.items())
        + " | tolerance used "
        + " ".join(f"{k}={v:.3f}" for k, v in margins.items()) + " ok")
    return errs


# the cases the bf16-operand forms take (each family's of these labels,
# then its main-path sized case)
BF16_CASES = ("mid full fill", "mid 20% fill", "mid ragged N",
              "mid ragged N, two exps", "mid 20% fill, zero cotangents")


def check_kernels(torch, fused):
    """Every family's cases; then the bf16 forms on BF16_CASES and the
    main-path sized case, and at that case against the float32 forms
    (check_bf16_delta). Returns {family or family + BF16: errors of its
    main-path sized case on randn cotangents (the last)}. A fourth
    element names the cotangents' rows (carrying_rows; randn on all by
    default)."""
    mid = 16384
    cases = {
        "joint": [
            ("mid full fill", (mid, 2048, 1.0, 1, 64), (6.0, 12.0)),
            ("mid 20% fill", (mid, 2048, 0.2, 2, 64), (6.0, 12.0)),
            ("mid ragged N, two exps", (mid - 1, 2048, 0.2, 3, 64),
             (6.0, 10.0)),
            ("mid all invalid", (mid, 2048, 0.0, 4, 64), (6.0, 12.0)),
            ("mid one valid, two exps", (mid, 2048, 1 / 2048, 7, 64),
             (6.0, 10.0)),
            ("mid 20% fill", (mid, 2048, 0.2, 6, 32), (6.0, 12.0)),
            ("mid 20% fill, 0.5% of rows in runs", (mid, 2048, 0.2, 8, 64),
             (6.0, 12.0), "runs"),
            ("mid 20% fill, zero cotangents", (mid, 2048, 0.2, 9, 64),
             (6.0, 12.0), "zero"),
            ("mid ragged N, last row only", (mid - 1, 2048, 0.2, 10, 64),
             (6.0, 10.0), "last"),
            ("flagship 17% fill", (131072, 6144, 0.17, 5, 64),
             (6.0, 12.0))],
        "hard": [
            ("mid full fill", (mid, 2048, 1.0, 11, 32), (6.0,)),
            ("mid 20% fill", (mid, 2048, 0.2, 12, 32), (6.0,)),
            ("mid ragged N", (mid - 1, 2048, 0.2, 13, 32), (6.0,)),
            ("mid all invalid", (mid, 2048, 0.0, 14, 32), (6.0,)),
            ("mid one valid", (mid, 2048, 1 / 2048, 17, 32), (6.0,)),
            ("mid 64 valid, one full prototype tile",
             (mid, 2048, 64 / 2048, 33, 32), (6.0,)),
            ("mid 65 valid, one row in the last prototype tile",
             (mid, 2048, 65 / 2048, 34, 32), (6.0,)),
            ("mid 20% fill", (mid, 2048, 0.2, 15, 64), (6.0,)),
            ("DensePose 15% fill", (65536, 2048, 0.15, 16, 32), (6.0,)),
            ("mid 20% fill, 0.5% of rows in runs", (mid, 2048, 0.2, 19, 32),
             (6.0,), "runs"),
            ("mid 20% fill, zero cotangents", (mid, 2048, 0.2, 20, 32),
             (6.0,), "zero"),
            ("mid ragged N, last row only", (mid - 1, 2048, 0.2, 28, 32),
             (6.0,), "last"),
            ("DensePose 139 valid, 354 rows in runs",
             (65536, 2048, 139 / 2048, 29, 32), (6.0,), "densepose"),
            ("DensePose 139 valid", (65536, 2048, 139 / 2048, 18, 32),
             (6.0,))],
        "set": [
            ("mid full fill", (mid, 2048, 1.0, 21, 64), (8.0,)),
            ("mid 20% fill", (mid, 2048, 0.2, 22, 64), (8.0,)),
            ("mid ragged N", (mid - 1, 2048, 0.2, 23, 64), (8.0,)),
            ("mid all invalid", (mid, 2048, 0.0, 24, 64), (8.0,)),
            ("mid one valid", (mid, 2048, 1 / 2048, 27, 64), (8.0,)),
            ("mid 20% fill", (mid, 2048, 0.2, 25, 32), (8.0,)),
            ("mid 20% fill, 0.5% of rows in runs", (mid, 2048, 0.2, 30, 64),
             (8.0,), "runs"),
            ("mid 20% fill, zero cotangents", (mid, 2048, 0.2, 31, 64),
             (8.0,), "zero"),
            ("mid ragged N, last row only", (mid - 1, 2048, 0.2, 32, 64),
             (8.0,), "last"),
            ("tag step 20% fill", (65536, 3072, 0.2, 26, 64), (8.0,))],
    }
    errs = {}
    for family, family_cases in cases.items():
        for label, (n, p, fill, seed, d), kappas, *cotangents in \
                family_cases:
            case = make_case(torch, n, p, fill, seed, d=d,
                             sparse_tags=family == "set")
            errs[family] = check_case(torch, fused, family, label, case,
                                      kappas, seed, *cotangents)
    for family, family_cases in cases.items():
        picked = [c for c in family_cases[:-1] if c[0] in BF16_CASES]
        for label, (n, p, fill, seed, d), kappas, *cotangents in \
                picked + family_cases[-1:]:
            case = make_case(torch, n, p, fill, seed, d=d,
                             sparse_tags=family == "set")
            errs[family + BF16] = check_case(
                torch, fused, family, label, case, kappas, seed, *cotangents,
                operand_dtype="bfloat16")
        check_bf16_delta(torch, fused, family, label, case, kappas)
    check_no_pixels(torch, fused)
    return errs


# check_no_pixels' cases: family -> (D, kappas), P = 2048, ~20% valid
NO_PIXEL_CASES = {"joint": (64, (6.0, 12.0)), "hard": (32, (6.0,)),
                  "set": (64, (8.0,))}


def check_no_pixels(torch, fused):
    """Each family's kernels at N = 0 (a height-sharded rank that holds no
    row of the embeddings), in both operand types: the statistics [stats,
    0] and dE [0, D] empty, no stats or dE grid started (the C functions
    return before one), and the dP kernel (K3, K6, K9) launched once over
    its tiles with no pixel chunk to walk: dP exactly 0 on every
    prototype row, equal to the plain version's in float64."""
    for family, (d, kappas) in NO_PIXEL_CASES.items():
        case = make_case(torch, 0, 2048, 0.2, 40, d=d,
                         sparse_tags=family == "set")
        for dtype, (_, suffix) in fused.OPERAND_DTYPES.items():
            g = torch.zeros(N_STATS[family], 0, device=DEVICE)
            fused.reset_launch_counts()
            s, de, dp = kernel_outputs(torch, fused, family, case, g, kappas,
                                       dtype)
            launches = {k: v for k, v in fused.LAUNCHES.items() if v}
            rdp = reference64(torch, fused, family, case, g, kappas,
                              operand_dtype=dtype)[2]
            want = ((N_STATS[family], 0), (0, d),
                    {f"{family}_grad_proto{suffix}": 1})
            got = (tuple(s.shape), tuple(de.shape), launches)
            if (got != want or not torch.equal(dp.double(), rdp)
                    or bool((dp != 0).any())):
                raise AssertionError(
                    f"{family}{suffix} at N = 0: (stats shape, dE shape, "
                    f"launches) {got}, want {want}; dP's largest |value| "
                    f"{float(dp.abs().max())} (the plain version's "
                    f"{float(rdp.abs().max())})")
            log("kernels", f"{family}{suffix} N=0 P=2048 D={d} "
                f"valid={int(case['num_valid'])}: stats {tuple(s.shape)} "
                f"and dE {tuple(de.shape)} empty, no stats or dE grid; dP "
                f"launched once, {dp.numel()} elements exactly 0 as the "
                "plain version's ok")


def check_bf16_delta(torch, fused, family, label, case, kappas):
    """The bf16 forms against the float32 forms at JAX's quantified delta
    (BF16_LOSS_RTOL, BF16_GRAD_COS): the masked-mean log likelihood of each
    loss the family computes (pixels whose own prototype is valid), and
    dE and dP of their sum, the cotangents from the float32 statistics."""
    own = case["own_idx"] < case["num_valid"]

    def losses(stats):
        return [fused._ll_from_stats(*stats[i:i + 3], own)
                for i in range(0, stats.shape[0], 3)]

    s = stats_fns(fused, family)[0](
        *stats_args(family, case, case["emb"], case["protos"]),
        *kappas).requires_grad_(True)
    (g,) = torch.autograd.grad(sum(losses(s)), s)
    out = {dt: kernel_outputs(torch, fused, family, case, g, kappas, dt)
           for dt in ("float32", "bfloat16")}
    ll = {dt: [float(x) for x in losses(o[0])] for dt, o in out.items()}
    cos = {name: float(torch.nn.functional.cosine_similarity(
        out["bfloat16"][i].double().flatten(),
        out["float32"][i].double().flatten(), dim=0))
        for i, name in ((1, "dE"), (2, "dP"))}
    log("kernels", f"{family}{BF16} {label} against float32: loss "
        + ", ".join(f"{a:.6f} (float32 {b:.6f})"
                    for a, b in zip(ll["bfloat16"], ll["float32"]))
        + " | cosine " + " ".join(f"{k}={v:.6f}" for k, v in cos.items()))
    for a, b in zip(ll["bfloat16"], ll["float32"]):
        if not abs(a - b) <= BF16_LOSS_RTOL * abs(b):
            raise AssertionError(f"{family}{BF16} {label}: loss {a} against "
                                 f"float32 {b}, past rtol {BF16_LOSS_RTOL}")
    if min(cos.values()) <= BF16_GRAD_COS:
        raise AssertionError(f"{family}{BF16} {label}: gradient cosine "
                             f"{cos} against float32, not above "
                             f"{BF16_GRAD_COS}")


def check_recorded(torch, fused, family, label, recorded, seed):
    """The family's kernels on the stats inputs a path recorded (its last
    call), on the cotangents its backward handed them and on randn ones,
    against the plain version at the kernel checks' tolerances."""
    names = STATS_ARGS[family]
    case = dict(zip(names, recorded["args"]))
    kappas = tuple(recorded["args"][len(names):])
    check_case(torch, fused, family, f"{label}, its own cotangents", case,
               kappas, seed, recorded["grads"])
    check_case(torch, fused, family, f"{label}, randn cotangents", case,
               kappas, seed)


@contextlib.contextmanager
def recording_stats(torch, fused, family):
    """Patches the family's stats function to keep its last call's inputs
    ("args") and the cotangent that the backward hands its kernels
    ("grads"); yields the dict they go into."""
    name = STATS_FN[family]
    orig = getattr(fused, name)
    last = {}

    def keep_cotangent(g):
        last["grads"] = g.detach().clone()

    def recording(*args, **kwargs):
        last["args"] = [a.detach() if torch.is_tensor(a) else a
                        for a in args]
        stats = orig(*args, **kwargs)
        stats.register_hook(keep_cotangent)
        return stats

    setattr(fused, name, recording)
    try:
        yield last
    finally:
        setattr(fused, name, orig)


# ---------------------------------------------------------------------------
# Main paths
# ---------------------------------------------------------------------------

def run_main_path(torch, fused, recipe, operand_dtype="float32"):
    """3 warm-up and 10 timed steps of one recipe with
    tpu.loss_operand_dtype = operand_dtype; its family's kernels of that
    operand type launched once a step and no other SegSort kernel. Returns
    (launch counts, the last call's stats inputs, the cotangent of its
    stats that the last backward handed to the kernels, (ms/step, peak
    GiB))."""
    from spml_tpu_torch.ops import knn
    from spml_tpu_torch.train import recipes
    from spml_tpu_torch.train import step as step_lib

    cfg, batch = recipes.setup(recipe, device=DEVICE)
    suffix = fused.OPERAND_DTYPES[operand_dtype][1]
    if suffix:  # the shipped recipes run float32 operands ("")
        cfg.tpu.loss_operand_dtype = operand_dtype
    family = RECIPE_FAMILY[recipe]
    b = cfg.train.batch_size
    t0 = time.perf_counter()
    state = step_lib.init_state(cfg, 0, batch["image"], device=DEVICE)
    train_step = step_lib.make_train_step(cfg)
    recipe += suffix  # the log's name of this arm
    log(recipe, f"state built in {time.perf_counter() - t0:.1f} s")

    masked = []
    orig_ll = fused._ll_from_stats

    def counting(own_s, same_s, diff_s, pixel_mask, reduction="mean"):
        masked.append(pixel_mask.sum())  # pixels in the loss, read later
        return orig_ll(own_s, same_s, diff_s, pixel_mask, reduction)

    fused._ll_from_stats = counting
    metrics_log = []
    torch.cuda.reset_peak_memory_stats()
    fused.reset_launch_counts()
    knn.reset_launch_counts()
    # the last call's inputs, for the timings
    with recording_stats(torch, fused, family) as last:
        try:
            for _ in range(3):
                state, m = train_step(state, batch)
                metrics_log.append(m)
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            for _ in range(10):
                state, m = train_step(state, batch)
                metrics_log.append(m)
            end.record()
            torch.cuda.synchronize()
            host_s = time.perf_counter() - t0
        finally:
            fused._ll_from_stats = orig_ll
    launches = dict(fused.LAUNCHES)

    steps = len(metrics_log)
    losses = {k: [float(m[k]) for m in metrics_log]
              for k in metrics_log[0] if k.endswith("loss")}
    nsegs = [int(m["num_segments"]) for m in metrics_log]
    if not all(math.isfinite(x) for v in losses.values() for x in v):
        raise AssertionError(f"{recipe}: non-finite loss: {losses}")
    if min(nsegs) <= 0:
        raise AssertionError(f"{recipe}: no segments formed: {nsegs}")
    if min(int(x) for x in masked) <= 0:
        raise AssertionError(f"{recipe}: a step had no pixel in the loss")
    for key in KERNELS:
        want = steps if key in family_keys(family, suffix) else 0
        if launches[key] != want:
            raise AssertionError(f"{recipe}: {key} launched {launches[key]}"
                                 f" times in {steps} steps, want {want}")
    logged = sum(not cfg.tpu.lazy_metrics
                 or s % cfg.train.tensorboard_step == 0 for s in range(steps))
    if knn.LAUNCHES != dict.fromkeys(knn.LAUNCHES, logged):
        raise AssertionError(f"{recipe}: KNN launches {knn.LAUNCHES} in "
                             f"{logged} logged steps, want {logged} each")
    ms = start.elapsed_time(end) / 10
    cap = b * cfg.tpu.segment_capacity
    loss = losses["loss"]
    carrying = int((last["grads"] != 0).any(0).sum())
    log(recipe, f"{steps} steps, loss {loss[0]:.4f} -> {loss[-1]:.4f} ("
        + ", ".join(f"{k} {v[-1]:.4f}" for k, v in losses.items()
                    if k != "loss")
        + f"), segments {nsegs[-1]}/{cap} ({nsegs[-1] / cap:.1%} of "
        f"capacity), loss pixels {int(masked[-1])}, pixels with a nonzero "
        f"stats cotangent {carrying} of {last['grads'].shape[1]}, kernel "
        f"valid count {int(last['args'][-1 - N_KAPPAS[family]])}, accuracy "
        f"step 0 {float(metrics_log[0]['accuracy']):.4f}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(recipe, f"train step {ms:.2f} ms (CUDA events; host clock "
        f"{host_s * 100:.2f} ms), {b * 1000 / ms:.2f} imgs/s, peak memory "
        f"{peak:.2f} GiB, launches "
        f"{ {k: v for k, v in {**launches, **knn.LAUNCHES}.items() if v} }"
        f", card "
        f"{nvidia_smi_line()}")
    return launches, last["args"], last["grads"], (ms, peak)


def family_keys(family, suffix=""):
    """The launch counters of a family's three kernels of one operand
    type."""
    return [f"{family}_{kind}{suffix}" for kind in KINDS]


# ---------------------------------------------------------------------------
# Remat: the flagship step with the backbone's activation checkpointing
# ---------------------------------------------------------------------------

REMAT = (("no remat", {}), ("remat_backbone", {"remat_backbone": True}),
         ("remat_stages (4,)", {"remat_stages": (4,)}))
# tests/test_train_step.py::test_remat_stages_exactness
REMAT_RTOL, REMAT_ATOL = 2e-4, 1e-6


def model_tensors(state):
    """{name: clone} of every parameter and buffer of both models."""
    return {f"{prefix}.{k}": v.detach().clone()
            for prefix, model in (("emb", state.emb_model),
                                  ("cls", state.cls_model))
            for k, v in model.state_dict().items()}


def run_remat(torch, fused):
    """The flagship recipe (train/recipes.py, batch 8, crop 512, bf16, the
    fused joint loss) from one seed-0 state and one batch with no remat,
    tpu.remat_backbone and tpu.remat_stages (4,): after one step the
    losses and every parameter within REMAT_RTOL / REMAT_ATOL of the
    no-remat step's, every BN buffer and num_batches_tracked
    torch.equal; then 3 warm-up and 10 timed steps (CUDA events); K1-K3
    once a step, no other kernel. One [remat] line."""
    import copy

    from spml_tpu_torch.train import recipes
    from spml_tpu_torch.train import step as step_lib

    cfg0, batch = recipes.setup("flagship", device=DEVICE)
    ref = None
    results = []
    for label, tpu in REMAT:
        cfg = copy.deepcopy(cfg0)
        for k, v in tpu.items():
            setattr(cfg.tpu, k, v)
        state = step_lib.init_state(cfg, 0, batch["image"], device=DEVICE)
        train_step = step_lib.make_train_step(cfg)
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fused.reset_launch_counts()
        state, m = train_step(state, batch)
        losses = {k: float(v) for k, v in m.items() if k.endswith("loss")}
        after = model_tensors(state)
        if ref is None:
            ref, worst = (losses, after), 0.0
        else:
            worst = check_remat_step(torch, label, ref, losses, after)
        after = None
        for _ in range(3):
            state, m = train_step(state, batch)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(10):
            state, m = train_step(state, batch)
        end.record()
        torch.cuda.synchronize()
        if not math.isfinite(float(m["loss"])):
            raise AssertionError(f"remat {label}: non-finite loss")
        launches = {k: v for k, v in fused.LAUNCHES.items() if v}
        want = dict.fromkeys(("joint_stats", "joint_grad_emb",
                              "joint_grad_proto"), 14)
        if launches != want:
            raise AssertionError(f"remat {label}: launches {launches}, want "
                                 f"{want} (K1-K3 once a step, no other)")
        results.append((label, start.elapsed_time(end) / 10,
                        torch.cuda.max_memory_allocated() / 2**30,
                        held / 2**30, worst))
        state = train_step = m = None
    log("remat", "flagship (panoptic_deeplab_101 bf16, batch 8, crop 512, "
        "K1-K3 once a step): " + "; ".join(
            f"{label}: {ms:.2f} ms/step, peak {peak:.2f} GiB ({held:.2f} "
            f"held before), step 1 vs no remat: largest |a - b| / "
            f"({REMAT_ATOL} + {REMAT_RTOL} |b|) {worst:.3f}"
            for label, ms, peak, held, worst in results)
        + f"; every BN buffer torch.equal; card {nvidia_smi_line()}")


def check_remat_step(torch, label, ref, losses, after):
    """One remat step against the no-remat one: losses and parameters
    within REMAT_RTOL / REMAT_ATOL, buffers equal. Returns the largest
    |a - b| / (atol + rtol |b|) over every parameter element."""
    ref_losses, ref_after = ref
    for k, v in ref_losses.items():
        if abs(losses[k] - v) > REMAT_ATOL + REMAT_RTOL * abs(v):
            raise AssertionError(f"remat {label}: {k} {losses[k]} against "
                                 f"{v} without remat")
    worst = 0.0
    for name, want in ref_after.items():
        got = after[name]
        if not want.is_floating_point() or "running_" in name:
            if not torch.equal(got, want):
                raise AssertionError(f"remat {label}: buffer {name} differs "
                                     "from the no-remat step's")
            continue
        ratio = float(((got - want).abs()
                       / (REMAT_ATOL + REMAT_RTOL * want.abs())).max())
        if ratio > 1.0:
            raise AssertionError(f"remat {label}: {name} off the no-remat "
                                 f"step by {ratio:.3f} of the tolerance")
        worst = max(worst, ratio)
    return worst


# ---------------------------------------------------------------------------
# Data parallel: two ranks of the flagship step, the drivers and batched
# inference (parallel/mesh.py)
# ---------------------------------------------------------------------------

DP_WORLD = 2
DP_BATCH = 4  # train.batch_size a rank (train_spml_scribble.sh:29)
# tests/test_torch_train_step.py's tolerances for another reduction
# order: losses rtol 1e-4; the update of each tensor that file checks
# (DP_CHECKED) within 1e-2 of its max|update| plus one float32 unit of
# its largest value (no two float32 values differ by less); bank
# prototypes atol 3e-4. Over every parameter and BN buffer the update
# differences' L2 norm within 1e-2 of the updates' (DP_UPDATE_RTOL).
# At ResNet-101's depth the float32 step itself is not that exact: a
# tensor whose gradient mostly cancels (BN biases, res3.0.conv2, the
# first trained conv) moves by rounding noise, and k-means near-ties
# move pixels to other segments with it. So each checked tensor's
# tolerance, and the bank's, adds the float32 floor of the one-process
# step (dp_reference): its largest difference from the reference step
# in DP_FLOOR_RUNS, other exact arithmetics of that same step that run
# none of the data-parallel code (_SyncBatchNorm, parallel/mesh.py).
DP_LOSS_RTOL, DP_UPDATE_RTOL, DP_BANK_ATOL = 1e-4, 1e-2, 3e-4
DP_CHECKED = [  # tests/test_torch_train_step.py's CHECKED_PARAMS + _STATS
    "emb.aspp.aspp_1.0.weight", "emb.aspp.aspp_3.0.bias",
    "emb.resnet_backbone.res3.0.conv2.weight",
    "emb.resnet_backbone.res4.0.bn1.weight",
    "emb.resnet_backbone.res5.0.downsample.0.weight",
    "emb.resnet_backbone.conv1.conv1.0.weight",
    "cls.semantic_classifier.0.weight", "cls.semantic_classifier.4.bias",
    "emb.resnet_backbone.conv1.bn1.running_mean",
    "emb.resnet_backbone.res2.0.bn3.running_var",
    "emb.resnet_backbone.res5.0.bn2.running_mean",
    "cls.semantic_classifier.1.running_var"]
# the floor's arithmetics of the one-process step (dp_one_process):
# the global batch with its halves swapped (every reduction over the
# batch, the convolutions' weight gradients and the BN statistics, in
# another order), and BatchNorm2d's statistics and their gradient by
# plain torch autograd with the statistics in float32 or in float64
DP_FLOOR_RUNS = {"halves swapped": {"swap": True},
                 "plain BN": {"bn": "float32"},
                 "plain BN, float64 statistics": {"bn": "float64"}}
# what compare_step checks; the free run, where each side clusters its
# own embeddings, holds the first five: k-means near-ties move tens of
# pixels to other segments in every float32 arithmetic of the step, and
# one such pixel moves its segments' prototypes by up to ~1e-2 and the
# gradients with them, so there the updates and the whole bank differ
# by which pixels moved (the (a) line prints them for the ranks and for
# each floor run held to the floor of the other two); the run on the
# one process's segments holds all
DP_CHECKS = ("losses", "bank labels", "buffers", "update L2",
             "matched bank prototypes", "bank prototypes", "updates")
DP_FREE_CHECKS = DP_CHECKS[:5]
DP_INFER_IMAGES = 8
DP_INFER_BATCH = 4


def dp_flagship(dtype, **tpu):
    """The flagship recipe (train/flagship.py) at DP_BATCH a rank in
    `dtype`, with `tpu`'s overrides: DP_WORLD ranks step the recipe's
    global batch of 8."""
    import copy

    from spml_tpu_torch.train import flagship

    over = copy.deepcopy(flagship.OVERRIDES)
    over["train"]["batch_size"] = DP_BATCH
    over["tpu"].update(compute_dtype=dtype, **tpu)
    return over


def dp_devices(torch):
    """(rank devices, backend, the case in words): NCCL with one card a
    rank when there are DP_WORLD cards, else gloo with every rank on
    cuda:0 (NCCL refuses two ranks on one card)."""
    count = torch.cuda.device_count()
    if count >= DP_WORLD:
        return ([f"cuda:{i}" for i in range(DP_WORLD)], "nccl",
                f"NCCL, one card a rank ({count} cards)")
    return (["cuda:0"] * DP_WORLD, "gloo",
            f"gloo, {DP_WORLD} ranks share one card ({count} card): "
            "two ranks share one card over gloo: not a scaling figure")


def digest(tensors) -> str:
    """sha256 of every tensor's bytes, by sorted name: equal digests are
    torch.equal tensors."""
    import hashlib

    import torch

    h = hashlib.sha256()
    for k in sorted(tensors):
        t = tensors[k].detach().cpu().contiguous().view(-1)
        h.update(k.encode())
        h.update(t.view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


class Clock:
    """Milliseconds between start() and stop(): CUDA events on a card,
    the host clock on the CPU (the phase's CPU rehearsal)."""

    def __init__(self, torch, device):
        self.torch, self.cuda = torch, device.type == "cuda"

    def start(self):
        if self.cuda:
            self.a = self.torch.cuda.Event(enable_timing=True)
            self.b = self.torch.cuda.Event(enable_timing=True)
            self.a.record()
        else:
            self.t0 = time.perf_counter()
        return self

    def stop(self):
        if self.cuda:
            self.b.record()
        else:
            self.t1 = time.perf_counter()
        return self

    def ms(self):
        if self.cuda:
            self.b.synchronize()
            return self.a.elapsed_time(self.b)
        return (self.t1 - self.t0) * 1e3


COLLECTIVE_KINDS = ("gradient", "batch norm", "gather", "other")


@contextlib.contextmanager
def timing_collectives(torch, device, mesh_lib):
    """Times every collective of parallel/mesh.py by the label its call
    site gives it (mesh_lib.collective: the gradient sum, a batch norm,
    the prototype gather, a halo exchange, or other: the loss groups'
    counts, the metrics); yields {kind: [Clock, ...]}. A collective
    without a label raises, so a call site that loses its label fails
    the phase instead of moving its time to another kind."""
    kinds = {}

    @contextlib.contextmanager
    def timer(kind):
        if kind is None:
            raise AssertionError("a collective without a label: "
                                 + "".join(traceback.format_stack(limit=8)))
        clock = Clock(torch, device).start()
        yield
        kinds.setdefault(kind, []).append(clock.stop())

    mesh_lib.set_collective_timer(timer)
    try:
        yield kinds
    finally:
        mesh_lib.set_collective_timer(None)


def dp_model_tensors(state):
    return {k: v.cpu() for k, v in model_tensors(state).items()}


def recipe_batch(cfg, device, batch=None):
    """The seed-0 synthetic batch of cfg's recipe, `batch` images (cfg's
    train.batch_size when None): DensePose's point labels
    (train/densepose_point.py) on a DensePose backbone, else the
    flagship's blobby labels (train/flagship.py). A crop of h x w rows
    and columns that is not square: the centre h x w of the square batch
    of side max(h, w)."""
    from spml_tpu_torch.train import densepose_point, flagship

    b = batch or cfg.train.batch_size
    h, w = cfg.train.crop_size
    side = max(h, w)
    if "densepose" in cfg.network.backbone_types:
        out = densepose_point.point_batch(b, side, seed=0, device=device)
    else:
        out = flagship.blobby_batch(b, side, cfg.dataset.num_classes,
                                    device=device)
    if h == w:
        return out
    top, left = (side - h) // 2, (side - w) // 2
    return {k: v[:, top:top + h, left:left + w].contiguous()
            if v.ndim >= 3 else v for k, v in out.items()}


def dp_setup(spec, dtype, device):
    """(config, the global batch of the recipe from seed 0, the seed-0
    state) of spec[dtype] (the flagship at DP_BATCH a rank, or the
    recipe spec names). In float32 ("f32", "f32_lbf16": float32
    convolutions) the classifier's dropout is 0, as in the parity tests:
    rank r draws its masks from seed + r over its own images, one process
    from seed over all of them."""
    from spml_tpu_torch.config import load_config
    from spml_tpu_torch.train import step as step_lib

    cfg = load_config(overrides=spec[dtype])
    batch = recipe_batch(cfg, device, spec["global"])
    state = step_lib.init_state(cfg, 0, batch["image"], device=device)
    if dtype.startswith("f32"):
        state.cls_model.semantic_classifier[3].p = 0.0
    return cfg, batch, state


def halo_partition(rows, space):
    """parallel/halo.py::partition (imported where the port is on the
    path)."""
    from spml_tpu_torch.parallel import halo

    return halo.partition(rows, space)


def grid_rows(crop):
    """The embedding grid's global rows over images `crop` rows high:
    the network's three stride-2 halvings, each rounding up, then x2
    (EmbeddingModel.embedding_rows)."""
    return 2 * -(-crop // 8)


def sp_shard(mesh, crop):
    """segments_of's shard of this rank at crop height `crop`."""
    return (mesh.space_rank, mesh.space, grid_rows(crop))


@contextlib.contextmanager
def segments_of(torch, given=None, rows=slice(None), shard=(0, 1, None),
                each=None):
    """Records the k-means segments of the train step (kmeans.
    segment_batch) into the yielded dict ("segments": the last call's,
    "every": each call's); with `given` (a recorded Segments, every image
    of the global batch), the step takes images `rows` of those in place
    of its own; height-sharded (shard = (space rank, space, the
    embedding grid's global rows): sp_shard), the rank's rows of the
    grid's partition of their pixel fields (the segment fields whole).
    each: a list of recorded Segments, the n-th call taking each[n] as
    `given`."""
    from spml_tpu_torch.ops import kmeans
    from spml_tpu_torch.parallel import halo

    orig, rec = kmeans.segment_batch, {"every": []}
    s, space, grid = shard

    def cut(t, pixel):
        t = t[rows]
        if not pixel or space == 1:
            return t
        p = halo.partition(grid, space)[s]
        t = t.reshape(t.shape[0], grid, -1)
        return t[:, p.start:p.stop].reshape(t.shape[0], len(p) * t.shape[2])

    def recording(emb, *a, **k):
        out = orig(emb, *a, **k)
        take = given if each is None else each[len(rec["every"])]
        if take is not None:
            out = (kmeans.Segments(*[
                cut(t, name.startswith("pixel")).to(emb.device)
                for name, t in zip(kmeans.Segments._fields, take)]),
                *out[1:])
        rec["segments"] = [t.cpu() for t in out[0]]
        rec["every"].append(rec["segments"])
        return out

    kmeans.segment_batch = recording
    try:
        yield rec
    finally:
        kmeans.segment_batch = orig


def dp_step_result(torch, state, m, rec):
    return {"after": dp_model_tensors(state),
            "losses": {k: float(v) for k, v in m.items()
                       if k.endswith("loss")},
            "memory": {k: v.cpu() for k, v in vars(state.memory).items()},
            "segments": rec["segments"]}


@contextlib.contextmanager
def plain_batch_norm(torch, stats_dtype):
    """models/resnet.py's BatchNorm2d in train mode by plain torch
    autograd, in one process: the batch mean and biased variance in
    `stats_dtype`, x normalized with them in its own type, the running
    statistics updated as BatchNorm2d updates them (outside a remat
    recomputation)."""
    from spml_tpu_torch.models import resnet

    orig = resnet.BatchNorm2d.forward
    shape = (1, -1, 1, 1)

    def forward(self, x):
        if not self.training:
            return orig(self, x)
        var, mean = torch.var_mean(x.to(getattr(torch, stats_dtype)),
                                   dim=(0, 2, 3), correction=0)
        mean, var = mean.to(x.dtype), var.to(x.dtype)
        scale = self.weight * torch.rsqrt(var + self.eps)
        y = ((x - mean.view(shape)) * scale.view(shape)
             + self.bias.view(shape))
        if not getattr(resnet._RECOMPUTE, "active", False):
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
                self.running_var.mul_(1.0 - m).add_(var, alpha=m)
                self.num_batches_tracked.add_(1)
        return y

    resnet.BatchNorm2d.forward = forward
    try:
        yield
    finally:
        resnet.BatchNorm2d.forward = orig


def dp_one_process(torch, spec, device, given=None, swap=False, bn=None,
                   nchw=False, arm="f32"):
    """One float32 step of one process at the global batch
    (train.batch_size DP_BATCH, so the same loss groups) from the seed-0
    state: its initial and updated tensors, losses, bank and k-means
    segments. given: the segments to take in place of its own; swap: the
    batch's halves swapped (the bank and segments handed back in the
    batch's order); bn: plain_batch_norm's statistics type; nchw: the
    models and the images in the contiguous NCHW layout; arm: spec's
    configuration ("f32_lbf16": bf16 loss operands)."""
    from spml_tpu_torch.train import step as step_lib

    cfg, batch, state = dp_setup(spec, arm, device)
    init = dp_model_tensors(state)
    g = spec["global"]
    order = list(range(g))
    if swap:  # swapping the halves twice is the identity
        order = order[g // 2:] + order[:g // 2]
    batch = {k: v[order] for k, v in batch.items()}
    if nchw:
        for model in (state.emb_model, state.cls_model):
            model.to(memory_format=torch.contiguous_format)
        batch["image"] = (batch["image"].permute(0, 3, 1, 2).contiguous()
                          .permute(0, 2, 3, 1))
    with segments_of(torch, given, order) as rec, \
            (plain_batch_norm(torch, bn) if bn else contextlib.nullcontext()):
        state, m = step_lib.make_train_step(cfg)(state, batch)
    out = {"init": init, **dp_step_result(torch, state, m, rec)}
    p = cfg.tpu.segment_capacity
    out["memory"] = {k: v.reshape(v.shape[0], g, p, *v.shape[2:])[:, order]
                     .reshape(v.shape) for k, v in out["memory"].items()}
    out["segments"] = [t[order] for t in out["segments"]]
    return out


def dp_floor(measures):
    """The float32 floor of a set of compare_step measures: each checked
    tensor's, the bank prototypes' and those of segments with the same
    pixels' largest difference; each loss's largest relative difference
    and the largest update L2 (held by compare_step's floor_all)."""
    measures = list(measures)
    return {"tensors": {k: max(m["diffs"][k] for m in measures)
                        for k in measures[0]["checked"]},
            "bank": max(m["bank_err"] for m in measures),
            "matched": max(m["matched"][0] for m in measures),
            "losses": {k: max(m["loss_rel"][k] for m in measures)
                       for k in measures[0]["loss_rel"]},
            "l2": max(m["l2"] for m in measures)}


def dp_reference(torch, spec, device, floor_runs=DP_FLOOR_RUNS,
                 modes=("free", "equal")):
    """The one-process step the ranks hold theirs against, and its
    float32 floor: the step in each of floor_runs, free and on the
    reference's segments (`modes`), against the reference (compare_step
    over spec's "checked" tensors, DP_CHECKED when it names none);
    dp_floor of a mode's runs is that mode's floor. Each floor run is
    also held to the floor of the others ("alone"). Saves the
    reference with its floors to spec["ref"]; returns {mode: {floor run:
    its measures}}."""
    ref = dp_one_process(torch, spec, device)
    every = slice(0, spec["global"])
    ref["floor"], runs = {}, {}
    for mode in modes:
        given = ref["segments"] if mode == "equal" else None
        runs[mode] = {}
        for name, kw in floor_runs.items():
            run = dp_one_process(torch, spec, device, given, **kw)
            runs[mode][name], _ = compare_step(
                torch, ref, run, every, spec["capacity"],
                checked=spec.get("checked", DP_CHECKED))
        ref["floor"][mode] = dp_floor(runs[mode].values())
        for name, m in runs[mode].items():
            m["alone"] = dp_shares(m, dp_floor(
                o for n, o in runs[mode].items() if n != name))
        if device.type == "cuda":
            torch.cuda.empty_cache()
    torch.save(ref, spec["ref"])
    return runs


@contextlib.contextmanager
def plain_stats(fused, family):
    """The family's stats function replaced by its plain version on the
    card too (segsort_loss.*_reference; with bf16 operands _PlainBf16,
    the statistics of bf16-rounded E and P and c rounded to bf16)."""
    name = STATS_FN[family]
    orig = getattr(fused, name)
    setattr(fused, name, getattr(fused, name + "_reference"))
    try:
        yield
    finally:
        setattr(fused, name, orig)


@contextlib.contextmanager
def miscounted_rows(fused, family, rows):
    """The family's statistics' cotangent doubled on the pixel rows
    `rows` (a [N] bool tensor): those rows counted twice in dE and in
    their share of dP, as a rank counted twice would be."""
    name = STATS_FN[family]
    orig = getattr(fused, name)

    def doubled(*args, **kwargs):
        stats = orig(*args, **kwargs)
        scale = 1.0 + rows.to(stats.device, stats.dtype)
        stats.register_hook(lambda g: g * scale)
        return stats

    setattr(fused, name, doubled)
    try:
        yield
    finally:
        setattr(fused, name, orig)


def bf16_reference(torch, fused, spec, device, family, rank_rows):
    """The limits of a step with bf16 loss operands (spec["f32_lbf16"])
    held against the one process's float32 step on its own segments
    (spec["ref"], dp_reference's): each checked tensor's [dp] (a)
    tolerance plus its equal-mode floor plus its plain-bf16 floor, how far
    the one process's step with the plain bf16 form of the family's
    statistics (plain_stats) lies from its float32 step. Then the one
    process's float32 step with a rank counted twice (miscounted_rows on
    rank_rows, that rank's pixel rows): its shares of the limits, each
    over 1 if the limits would catch it. Saves the limits with the
    reference; returns (plain-bf16 floors, miscounted shares)."""
    ref = torch.load(spec["ref"], weights_only=True)
    every = slice(0, spec["global"])
    checked = spec.get("checked", DP_CHECKED)
    with plain_stats(fused, family):
        plain = dp_one_process(torch, spec, device, ref["segments"],
                               arm="f32_lbf16")
    pm, _ = compare_step(torch, ref, plain, every, spec["capacity"],
                         checked=checked)
    floor = ref["floor"]["equal"]["tensors"]
    ref["bf16_limit"] = {k: pm["tol"][k] + floor[k] + pm["diffs"][k]
                         for k in checked}
    plain = None
    with miscounted_rows(fused, family, rank_rows):
        wrong = dp_one_process(torch, spec, device, ref["segments"])
    wm, _ = compare_step(torch, ref, wrong, every, spec["capacity"],
                         checked=checked)
    torch.save(ref, spec["ref"])
    return ({k: pm["diffs"][k] for k in checked},
            {k: wm["diffs"][k] / ref["bf16_limit"][k] for k in checked})


def bf16_update_shares(ref, got):
    """A bf16-operand step's checked updates (got["after"]) against the
    float32 reference's: each one's share of ref["bf16_limit"]."""
    return {k: float((got["after"][k].double()
                      - ref["after"][k].double()).abs().max()) / lim
            for k, lim in ref["bf16_limit"].items()}


def time_steps(torch, step, state, batch, device, barrier=None):
    """3 warm-up and 10 timed steps (ranks meet at `barrier` first):
    (state, ms/step, peak GiB)."""
    for _ in range(3):
        state, m = step(state, batch)
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    if barrier is not None:
        barrier()
    clock = Clock(torch, device).start()
    for _ in range(10):
        state, m = step(state, batch)
    ms = clock.stop().ms() / 10
    if not math.isfinite(float(m["loss"])):
        raise AssertionError(f"dp: non-finite loss {float(m['loss'])}")
    peak = (torch.cuda.max_memory_allocated() / 2**30
            if device.type == "cuda" else 0.0)
    return state, ms, peak


def dp_time_one_process(torch, spec, device):
    """The bf16 step of one process at the global batch
    (train.batch_size DP_BATCH), timed: (ms/step, peak GiB)."""
    from spml_tpu_torch.train import step as step_lib

    cfg, batch, state = dp_setup(spec, "bf16", device)
    _, ms, peak = time_steps(torch, step_lib.make_train_step(cfg), state,
                             batch, device)
    return ms, peak


def matched_bank_err(torch, ref_seg, seg, ref_proto, proto, p):
    """Bank prototypes of two runs over the segments that hold the same
    pixels in both (a pixel that k-means puts in another segment changes
    the members of two, and so their means): (max|difference|, segments
    matched, segments of ref_seg). ref_seg, seg: the runs' Segments of
    the same images; ref_proto, proto [images * p, D]: their prototypes
    at segment capacity p."""
    err, matched, total = 0.0, 0, 0
    for i in range(ref_seg[0].shape[0]):
        a = torch.where(ref_seg[1][i], ref_seg[0][i], -1) + 1
        b = torch.where(seg[1][i], seg[0][i], -1) + 1
        na = torch.bincount(a, minlength=p + 1)
        nb = torch.bincount(b, minlength=p + 1)
        pairs, n = torch.unique(a * (p + 1) + b, return_counts=True)
        s, t = pairs // (p + 1), pairs % (p + 1)
        ok = (n == na[s]) & (n == nb[t]) & (s > 0) & (t > 0)
        total += int((na[1:] > 0).sum())
        matched += int(ok.sum())
        if ok.any():
            d = ref_proto[i * p + s[ok] - 1] - proto[i * p + t[ok] - 1]
            err = max(err, float(d.abs().max()))
    return err, matched, total


def dp_shares(m, floor=None):
    """A step's shares of tolerance + floor (compare_step's measures,
    dp_floor's floor): the checked updates' largest, the bank
    prototypes', and theirs over segments with the same pixels."""
    f = floor or {"tensors": dict.fromkeys(m["checked"], 0.0), "bank": 0.0,
                  "matched": 0.0}
    return {"updates": max(m["diffs"][k] / (m["tol"][k] + f["tensors"][k])
                           for k in m["checked"]),
            "bank prototypes": m["bank_err"] / (DP_BANK_ATOL + f["bank"]),
            "matched bank prototypes": (m["matched"][0]
                                        / (DP_BANK_ATOL + f["matched"]))}


def compare_step(torch, ref, got, rows, p, floor=None, checks=DP_CHECKS,
                 checked=DP_CHECKED, floor_all=False, unheld=()):
    """One step's losses, tensors, bank and segments (got: dp_step_result
    of images `rows` of the global batch) against the reference's at the
    DP_* tolerances, each plus its float32 floor (dp_floor's, when given),
    the updates of the tensors `checked` each held; floor_all: the losses
    and the update L2 also at tolerance + their floor (a step whose own
    equally exact runs lie past the bare tolerances there), but the
    losses named in `unheld`, whose share is printed: (measures, {check:
    failure} of `checks` that failed)."""
    failed = {}
    loss_rel = {k: abs(got["losses"][k] - v) / abs(v) if v else
                (0.0 if got["losses"][k] == v else math.inf)
                for k, v in ref["losses"].items()}
    loss_floor = (floor["losses"] if floor_all
                  else dict.fromkeys(loss_rel, 0.0))
    failed["losses"] = [
        f"{k} {got['losses'][k]} against {v}"
        for k, v in ref["losses"].items()
        if k not in unheld and loss_rel[k] > DP_LOSS_RTOL + loss_floor[k]]
    bank_err, memory = 0.0, got["memory"]
    failed["bank labels"] = []
    for k, want in ref["memory"].items():
        if want.is_floating_point():
            bank_err = max(bank_err, float((memory[k] - want).abs().max()))
        elif not torch.equal(memory[k], want):
            failed["bank labels"].append(
                f"{k}: {int((memory[k] != want).sum())} entries differ")
    ratios, diffs, tol, diff2, upd2 = {}, {}, {}, 0.0, 0.0
    failed["buffers"] = []
    for name, want in ref["after"].items():
        after = got["after"][name]
        if not want.is_floating_point():
            if not torch.equal(after, want):
                failed["buffers"].append(f"{name} differs")
            continue
        upd = want.double() - ref["init"][name].double()
        diff = after.double() - want.double()
        diff2 += float((diff ** 2).sum())
        upd2 += float((upd ** 2).sum())
        unit = float(np.spacing(np.float32(want.abs().max())))
        diffs[name] = float(diff.abs().max())
        tol[name] = DP_UPDATE_RTOL * float(upd.abs().max()) + unit
        ratios[name] = diffs[name] / tol[name]
    l2 = math.sqrt(diff2 / upd2)
    if l2 > DP_UPDATE_RTOL + (floor["l2"] if floor_all else 0.0):
        failed["update L2"] = f"{l2:.3e}"
    names, checked = checked, {k: ratios[k] for k in checked}
    top = sorted(ratios, key=ratios.get, reverse=True)[:3]
    own = slice(rows.start * p, rows.stop * p)  # the bank's newest slot
    m = {"worst": max(checked.values()), "checked": names,
         "worst_name": max(checked, key=checked.get), "l2": l2,
         "any": [(k, ratios[k]) for k in top], "diffs": diffs, "tol": tol,
         "bank_err": bank_err,
         "matched": matched_bank_err(
             torch, [t[rows] for t in ref["segments"]], got["segments"],
             ref["memory"]["prototype"][-1][own],
             memory["prototype"][-1][own], p),
         "flips": int((got["segments"][0]
                       != ref["segments"][0][rows]).sum()),
         "loss_rel": loss_rel}
    m["shares"] = dp_shares(m, floor)
    if floor_all:
        share = {k: v / (DP_LOSS_RTOL + loss_floor[k])
                 for k, v in loss_rel.items()}
        m["shares"]["losses"] = max(v for k, v in share.items()
                                    if k not in unheld)
        m["shares"]["update L2"] = l2 / (DP_UPDATE_RTOL + floor["l2"])
        m["unheld"] = {k: share[k] for k in unheld}
    for k, share in m["shares"].items():
        if share > 1.0:
            failed[k] = f"{share:.3f} of tolerance + floor"
    return m, {k: v for k, v in failed.items() if v and k in checks}


def dp_equality(torch, fused, spec, device, mesh):
    """(a), (b): this rank's float32 step against the one-process one,
    first free (the pixels whose k-means segment differs counted), then
    on the one-process run's segments, each held to every DP_* tolerance
    plus that mode's float32 floor; K1-K3 once a step with their N and
    P."""
    from spml_tpu_torch.train import step as step_lib

    ref = torch.load(spec["ref"], weights_only=True)
    rows = mesh.shard(spec["global"])
    out = {}
    for run, given in (("free", None), ("equal", ref["segments"])):
        cfg, batch, state = dp_setup(spec, "f32", device)
        local = {k: v[rows] for k, v in batch.items()}
        step = step_lib.make_train_step(cfg)
        fused.reset_launch_counts()
        with recording_stats(torch, fused, "joint") as last, \
                segments_of(torch, given, rows) as rec:
            state, m = step(state, local)
        got = dp_step_result(torch, state, m, rec)
        measures, bad = compare_step(
            torch, ref, got, rows, spec["capacity"], ref["floor"][run],
            DP_FREE_CHECKS if given is None else DP_CHECKS)
        if bad:
            raise AssertionError(f"dp rank {mesh.rank} against one process "
                                 f"({run} segments): {bad} ({measures})")
        out[run] = {**measures, "losses": got["losses"],
                    "launches": {k: v for k, v in fused.LAUNCHES.items()
                                 if v},
                    "n": int(last["args"][0].shape[0]),
                    "p": int(last["args"][4].shape[0]),
                    "digest": digest({**got["after"], **{
                        "bank." + k: v for k, v in got["memory"].items()}})}
        state = m = None
    return out


def dp_loss_operands(torch, fused, spec, device, mesh):
    """(g): (a)'s step on the one process's segments with
    tpu.loss_operand_dtype "bfloat16" (K1-K3's bf16 forms): each loss
    within BF16_LOSS_RTOL of the one process's float32 step, each checked
    update within its bf16 limit (bf16_reference)."""
    from spml_tpu_torch.train import step as step_lib

    ref = torch.load(spec["ref"], weights_only=True)
    rows = mesh.shard(spec["global"])
    cfg, batch, state = dp_setup(spec, "f32_lbf16", device)
    local = {k: v[rows] for k, v in batch.items()}
    step = step_lib.make_train_step(cfg)
    fused.reset_launch_counts()
    with recording_stats(torch, fused, "joint") as last, \
            segments_of(torch, ref["segments"], rows):
        state, m = step(state, local)
    losses = {k: float(v) for k, v in m.items() if k.endswith("loss")}
    rel = {k: abs(losses[k] - v) / abs(v) for k, v in ref["losses"].items()}
    shares = bf16_update_shares(ref, {"after": dp_model_tensors(state)})
    if losses.keys() != ref["losses"].keys() or \
            max(rel.values()) > BF16_LOSS_RTOL or max(shares.values()) > 1:
        raise AssertionError(f"dp rank {mesh.rank}, bf16 loss operands: "
                             f"losses {losses} against float32 "
                             f"{ref['losses']}, rtol {BF16_LOSS_RTOL}; "
                             f"updates' shares of their limits {shares}")
    return {"losses": losses, "rel": max(rel.values()), "shares": shares,
            "launches": {k: v for k, v in fused.LAUNCHES.items() if v},
            "n": int(last["args"][0].shape[0]),
            "p": int(last["args"][4].shape[0])}


def dp_timing(torch, fused, spec, device, mesh, mesh_lib):
    """(c): 3 warm-up and 10 timed bf16 steps of this rank, then 3 with
    every collective timed by what it serves."""
    from spml_tpu_torch.train import step as step_lib

    cfg, batch, state = dp_setup(spec, "bf16", device)
    local = {k: v[mesh.shard(spec["global"])] for k, v in batch.items()}
    step = step_lib.make_train_step(cfg)
    fused.reset_launch_counts()
    state, ms, peak = time_steps(torch, step, state, local, device,
                                 mesh_lib.barrier)
    with timing_collectives(torch, device, mesh_lib) as kinds:
        for _ in range(3):
            state, m = step(state, local)
    if set(kinds) != set(COLLECTIVE_KINDS):  # a caller renamed
        raise AssertionError(f"dp: collectives of kinds {sorted(kinds)}, "
                             f"want {COLLECTIVE_KINDS}")
    coll = {k: (sum(c.ms() for c in v) / 3, len(v) // 3)
            for k, v in kinds.items()}
    launches = {k: v for k, v in fused.LAUNCHES.items() if v}
    return {"ms": ms, "peak": peak, "collectives": coll,
            "launches": launches}


def dp_driver(torch, fused, spec, device, mesh):
    """(d), (e): train_spml on the world for 4 iterations and resumed to
    6, then train_classifier over its snapshot for 2, on every rank."""
    import argparse

    from spml_tpu_torch.config import load_config
    from spml_tpu_torch.data import datasets
    from spml_tpu_torch.train import driver
    from spml_tpu_torch.utils import checkpoint as ckpt

    root = spec["root"]
    stage1_dir = os.path.join(root, "dp_stage1")

    def args(snapshot):
        return argparse.Namespace(data_dir=spec["data"],
                                  data_list=spec["list"],
                                  snapshot_dir=snapshot)

    logged = []
    log_metrics = driver._log_metrics

    def capture(writer, metrics, it, prefix=""):
        logged.append(it)
        log_metrics(writer, metrics, it, prefix)

    driver._log_metrics = capture
    out = {"runs": []}
    try:
        stage1 = load_config(overrides=spec["stage1"])
        stage1.train.tensorboard_step = 1  # every iteration logged
        for first, last in ((0, 4), (4, 6)):
            stage1.train.max_iteration = last
            stage1.train.resume = first > 0
            logged.clear()
            fused.reset_launch_counts()
            state = driver.train_spml(args(stage1_dir), stage1,
                                      datasets.ListTagDataset, device=device)
            out["runs"].append((first, last, list(logged), {
                k: v for k, v in fused.LAUNCHES.items() if v}))
        out["stage1"] = digest({**model_tensors(state), **{
            "bank." + k: v for k, v in vars(state.memory).items()}})
        out["num_devices"] = stage1.tpu.num_devices
        ck_dir = os.path.join(stage1_dir, "checkpoints")
        saved = ckpt.read(ck_dir)
        out["checkpoints"] = ckpt.steps(ck_dir)
        out["rank_generators"] = len(saved.get("rank_generators", []))
        state = None
        stage2 = load_config(overrides=spec["stage1"])
        stage2.network.pretrained = stage1_dir
        stage2.network.prediction_types = "softmax_classifier"
        stage2.network.kmeans_iterations = 0
        stage2.network.kmeans_num_clusters = (1, 1)
        stage2.train.max_iteration = 2
        stage2.train.tensorboard_step = 1
        fused.reset_launch_counts()
        logged.clear()
        head = driver.train_classifier(
            args(os.path.join(root, "dp_stage2")), stage2,
            datasets.ListTagClassifierDataset, device=device).cls_model
        out["stage2"] = digest(head.state_dict())
        out["stage2_launches"] = {k: v for k, v in fused.LAUNCHES.items()
                                  if v}
        out["stage2_iterations"] = list(logged)
    finally:
        driver._log_metrics = log_metrics
    return out


def dp_inference(spec, device, mesh, mesh_lib):
    """(f): rank 0 builds the bank of the stage-1 snapshot, then every
    rank predicts its share of each group of DP_INFER_BATCH (float32),
    and rank 0 runs run_benchmark after the barrier."""
    from spml_tpu_torch.config import load_config
    from spml_tpu_torch.inference import runner

    cfg = load_config(overrides=spec["infer"])
    t0 = time.perf_counter()
    if mesh.rank == 0:
        runner.run_prototype(dp_infer_args(spec, "bank"), cfg, device=device)
    mesh_lib.barrier()
    t1 = time.perf_counter()
    runner.run_knn_inference(dp_infer_args(spec, "dp"), cfg, device=device)
    t2 = time.perf_counter()
    miou = None
    if mesh.rank == 0:
        miou = runner.run_benchmark(dp_infer_args(spec, "dp"),
                                    cfg)["mean_iou"]
    return {"bank_s": t1 - t0, "predict_s": t2 - t1, "miou": miou}


def dp_infer_args(spec, out):
    import argparse

    root = spec["root"]
    return argparse.Namespace(
        data_dir=spec["data"], data_list=spec["infer_list"],
        snapshot_dir=os.path.join(root, "dp_stage1"),
        save_dir=os.path.join(root, "infer_" + out),
        semantic_memory_dir=os.path.join(root, "infer_bank",
                                         "semantic_prototype"))


def dp_rank(spec, *, device):
    """One rank of the [dp] phase, in a process of its own
    (parallel/mesh.py::spawn): (a) and (b), (g), (c), (d) and (e), (f)."""
    import torch

    from spml_tpu_torch.ops import _cuda
    from spml_tpu_torch.ops import segsort_loss as fused
    from spml_tpu_torch.parallel import mesh as mesh_lib

    _cuda.CSRC = Path(spec["csrc"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = mesh_lib.make_mesh()
    t0 = time.perf_counter()
    out = {"rank": mesh.rank, "world": mesh.world}
    for name, run in (
            ("equality", lambda: dp_equality(torch, fused, spec, device,
                                             mesh)),
            ("loss operands", lambda: dp_loss_operands(torch, fused, spec,
                                                       device, mesh)),
            ("timing", lambda: dp_timing(torch, fused, spec, device, mesh,
                                         mesh_lib)),
            ("driver", lambda: dp_driver(torch, fused, spec, device, mesh)),
            ("inference", lambda: dp_inference(spec, device, mesh,
                                               mesh_lib))):
        out[name] = run()
        if device.type == "cuda":  # the ranks may share one card
            torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    return out


def run_dp(torch, fused, devices=None, backend=None, device=None):
    """The [dp] phase: DP_WORLD ranks spawned once (the kernels already
    built here, so no rank builds), each running dp_rank; this process
    computes the one-process references before and after. devices,
    backend, device: the CPU rehearsal's (cpu ranks, gloo, cpu)."""
    import copy
    import tempfile

    from spml_tpu_torch.config import load_config
    from spml_tpu_torch.data import synthetic
    from spml_tpu_torch.inference import runner
    from spml_tpu_torch.ops import _cuda
    from spml_tpu_torch.parallel import mesh as mesh_lib

    if devices is None:
        devices, backend, case = dp_devices(torch)
    else:
        case = f"{backend} on {devices}"
    device = torch.device(device or DEVICE)
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="spml_dp_") as root:
        data = os.path.join(root, "world")
        lst = synthetic.write_world(data, WORLD_IMAGES, seed=0)
        with open(lst) as f:
            items = f.read().splitlines()
        infer_list = os.path.join(root, "infer.txt")
        with open(infer_list, "w") as f:
            f.write("\n".join(items[:DP_INFER_IMAGES]) + "\n")
        stage1 = copy.deepcopy(STAGE1)
        stage1["train"]["batch_size"] = DP_BATCH
        infer = copy.deepcopy(STAGE1)
        infer["network"]["kmeans_num_clusters"] = [12, 12]
        infer["tpu"].update(compute_dtype="float32",
                            infer_batch=DP_INFER_BATCH)
        spec = {"csrc": str(_cuda.CSRC), "root": root, "data": data,
                "list": lst, "infer_list": infer_list,
                "f32": dp_flagship("float32"), "bf16": dp_flagship("bfloat16"),
                "f32_lbf16": dp_flagship("float32",
                                         loss_operand_dtype="bfloat16"),
                "global": DP_BATCH * DP_WORLD, "stage1": stage1,
                "infer": infer, "ref": os.path.join(root, "ref.pt")}
        f32 = load_config(overrides=spec["f32"])
        spec["n"] = DP_BATCH * (f32.train.crop_size[0] // 4) ** 2
        spec["capacity"] = f32.tpu.segment_capacity
        spec["p"] = (spec["global"] * f32.tpu.segment_capacity
                     * (1 + f32.train.memory_bank_size))
        log("dp", f"{len(devices)} ranks on {devices}: {case}; "
            f"torch.cuda.device_count() {torch.cuda.device_count()}")
        floors = dp_reference(torch, spec, device)
        # (g)'s limits; a rank counted twice: rank 0's images' pixels
        n_all = spec["n"] * DP_WORLD
        bf16_floor, miscounted = bf16_reference(
            torch, fused, spec, device, "joint",
            torch.arange(n_all) < spec["n"])
        one_ms, one_peak = dp_time_one_process(torch, spec, device)
        if device.type == "cuda":
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ranks = mesh_lib.spawn(dp_rank, (spec,), devices, backend)
        spawn_s = time.perf_counter() - t0
        # the one-process inference over the same snapshot and bank
        runner.run_knn_inference(dp_infer_args(spec, "one"),
                                 load_config(overrides=spec["infer"]),
                                 device=device)
        pngs = {w: read_pngs(dp_infer_args(spec, w).save_dir,
                             DP_INFER_IMAGES, 21, f"dp inference ({w})")
                for w in ("dp", "one")}
        check_dp(spec, ranks, pngs)
        check_dp_launches(spec, ranks)
    eq = [r["equality"] for r in ranks]
    tm = [r["timing"] for r in ranks]
    dr = ranks[0]["driver"]
    ms = max(t["ms"] for t in tm)
    g = DP_BATCH * DP_WORLD
    coll = {k: max(t["collectives"].get(k, (0.0, 0))[0] for t in tm)
            for k in COLLECTIVE_KINDS}
    counts = {k: tm[0]["collectives"].get(k, (0.0, 0))[1] for k in coll}
    free = [e["free"] for e in eq]
    equal = [e["equal"] for e in eq]
    log("dp", f"(a) float32 (TF32 off, dropout 0), {DP_WORLD} ranks x "
        f"{DP_BATCH} against one process x {g} (train.batch_size "
        f"{DP_BATCH}), tolerances: losses rtol {DP_LOSS_RTOL}; bank labels, "
        f"tags, validity and batch indices and the integer buffers equal; "
        f"update L2 within {DP_UPDATE_RTOL}; the {len(DP_CHECKED)} checked "
        f"updates within {DP_UPDATE_RTOL} max|update| and the bank "
        f"prototypes (those of segments with the same pixels, and all) "
        f"within atol {DP_BANK_ATOL}, each plus its float32 floor. "
        + " ".join(dp_mode_words(mode, [e[mode] for e in eq], floors[mode],
                                 g * spec["n"] // DP_BATCH)
                   for mode in ("free", "equal"))
        + f" Losses {free[0]['losses']}; the ranks' parameters, buffers "
        "and banks torch.equal (sha256)")
    log("dp", "(b) launches a rank in each f32 step "
        + " / ".join(str(e["launches"]) for e in free + equal)
        + f": K1-K3 once each at N {free[0]['n']}, P {free[0]['p']}")
    lo = [r["loss operands"] for r in ranks]
    log("dp", f"(g) (a) on the one process's segments with "
        f"tpu.loss_operand_dtype bfloat16: losses {lo[0]['losses']}, "
        f"relative to the one process's float32 at most "
        + " / ".join(f"{g['rel']:.3e}" for g in lo)
        + f" (rtol {BF16_LOSS_RTOL}); " + bf16_words(
            [g["shares"] for g in lo], bf16_floor, miscounted)
        + "; launches a rank " + " / ".join(str(g["launches"]) for g in lo)
        + f" at N {lo[0]['n']}, P {lo[0]['p']}")
    log("dp", f"(c) bf16, 3 + 10 steps: {ms:.2f} ms/step (ranks "
        + " / ".join(f"{t['ms']:.2f}" for t in tm)
        + f"), {g * 1000 / ms:.2f} images/s global, peak "
        + " / ".join(f"{t['peak']:.2f}" for t in tm)
        + " GiB a rank; collectives a step (slowest rank, ms, count): "
        + ", ".join(f"{k} {v:.2f} ({counts[k]})" for k, v in coll.items())
        + f"; one process x {g}: {one_ms:.2f} ms/step, "
        f"{g * 1000 / one_ms:.2f} images/s, peak {one_peak:.2f} GiB; "
        f"case: {case}")
    log("dp", f"(d) train_spml {DP_WORLD} ranks x {DP_BATCH}: runs "
        + ", ".join(f"{a}-{b} launches {la}" for a, b, _, la in dr["runs"])
        + f", tpu.num_devices {dr['num_devices']}, checkpoints "
        f"{dr['checkpoints']} from rank 0 with {dr['rank_generators']} "
        "generator states, resumed at step 4, ranks torch.equal; (e) "
        f"train_classifier iterations {dr['stage2_iterations']}, launches "
        f"{dr['stage2_launches']}, heads torch.equal; (f) "
        "run_knn_inference, infer_batch "
        f"{DP_INFER_BATCH}, {DP_INFER_IMAGES} images over {DP_WORLD} ranks "
        f"in float32: PNGs equal the one-process run's, mIoU "
        f"{ranks[0]['inference']['miou']:.4f}")
    log("dp", f"summary, {case}: {ms:.2f} ms/step, {g * 1000 / ms:.2f} "
        f"images/s, peak {max(t['peak'] for t in tm):.2f} GiB a rank "
        f"(one process x {g}: {one_ms:.2f} ms/step); spawn to join "
        f"{spawn_s:.1f} s, phase {time.perf_counter() - t_phase:.1f} s; "
        f"card {nvidia_smi_line()}")


def bf16_words(shares, bf16_floor, miscounted):
    """The words on a bf16-operand step's updates held to their limits
    (bf16_reference): each rank's largest share, the plain-bf16 floors'
    range and a miscounted rank's largest share."""
    worst = [max(sh, key=sh.get) for sh in shares]
    wrong = max(miscounted, key=miscounted.get)
    return (f"the {len(shares[0])} checked updates against the one "
            "process's float32 ones, each limit its tolerance + float32 "
            "floor + plain-bf16 floor (the one process with "
            f"segsort_loss._PlainBf16 statistics: "
            f"{min(bf16_floor.values()):.3e}-{max(bf16_floor.values()):.3e})"
            ": worst share " + " / ".join(
                f"{sh[k]:.3f} ({k})" for sh, k in zip(shares, worst))
            + f"; a rank counted twice in the one process's float32 step "
            f"(the statistics' cotangent x2 on its rows) reaches "
            f"{miscounted[wrong]:.2f} ({wrong}), and "
            f"{sum(v > 1 for v in miscounted.values())} of "
            f"{len(miscounted)} limits")


def dp_mode_words(mode, ranks, floor_runs, pixels):
    """(a)'s words on one mode: each rank's differences and shares of
    tolerance + floor, then each floor run's, with its shares of
    tolerance + the floor of the other two."""
    def words(m):
        s = m["shares"]
        return (f"updates up to {m['worst']:.3f} tolerances "
                f"({m['worst_name']}), {s['updates']:.3f} of tolerance + "
                f"floor; bank {m['bank_err']:.3e} "
                f"({s['bank prototypes']:.3f}), on the {m['matched'][1]} of "
                f"{m['matched'][2]} segments with the same pixels "
                f"{m['matched'][0]:.3e} ({s['matched bank prototypes']:.3f});"
                f" L2 {m['l2']:.3e}; {m['flips']} pixels in other segments")

    checks = DP_FREE_CHECKS if mode == "free" else DP_CHECKS
    head = ("Free" if mode == "free"
            else "On the one process's segments")
    return (f"{head} (held: {', '.join(checks)}; {pixels} pixels): "
            + " | ".join(f"rank {r}: {words(m)}" for r, m in enumerate(ranks))
            + ". Floor runs: " + " | ".join(
                f"{name}: {words(m)}; against the other two's floor: "
                + ", ".join(f"{k} {v:.3f}" for k, v in m["alone"].items())
                for name, m in floor_runs.items()) + ".")


def check_dp(spec, ranks, pngs):
    """The ranks' results against each other, the driver's checkpoints
    and logged iterations, and the sharded run's PNGs against the
    one-process run's."""
    a, b = ranks
    digests = [(r["equality"]["free"]["digest"],
                r["equality"]["equal"]["digest"], r["driver"]["stage1"],
                r["driver"]["stage2"]) for r in ranks]
    if digests[0] != digests[1]:
        raise AssertionError(f"dp: the ranks' tensors differ: {digests}")
    for r in ranks:
        dr = r["driver"]
        for eq in r["equality"].values():
            if (eq["n"], eq["p"]) != (spec["n"], spec["p"]):
                raise AssertionError(f"dp rank {r['rank']}: K1-K3 at N "
                                     f"{eq['n']}, P {eq['p']}, want "
                                     f"{spec['n']}, {spec['p']}")
        if [(f, la, it) for f, la, it, _ in dr["runs"]] != [
                (0, 4, [0, 1, 2, 3]), (4, 6, [4, 5])]:
            raise AssertionError(f"dp rank {r['rank']}: stage 1 runs "
                                 f"{dr['runs']}")
        if (dr["checkpoints"] != [2, 4, 6]
                or dr["rank_generators"] != DP_WORLD
                or dr["num_devices"] != DP_WORLD
                or dr["stage2_iterations"] != [0, 1]):
            raise AssertionError(f"dp rank {r['rank']} driver: {dr}")
    miou = a["inference"]["miou"]
    if not (math.isfinite(miou) and 0.0 <= miou <= 1.0):
        raise AssertionError(f"dp inference: mIoU {miou}")
    got, want = pngs["dp"], pngs["one"]
    if got.keys() != want.keys():
        raise AssertionError(f"dp inference: PNGs {sorted(got)} against "
                             f"{sorted(want)}")
    bad = [k for k in got if not np.array_equal(got[k], want[k])]
    if bad:
        raise AssertionError(f"dp inference: PNGs differ from one "
                             f"process's: {bad}")


def check_dp_launches(spec, ranks):
    """K1-K3 once a step a rank, no kernel in stage 2, and in (g) K1-K3's
    bf16 forms once a rank at (a)'s N and P."""
    k13 = ("joint_stats", "joint_grad_emb", "joint_grad_proto")
    for r in ranks:
        g = r["loss operands"]
        if (g["launches"], g["n"], g["p"]) != (
                {k + BF16: 1 for k in k13}, spec["n"], spec["p"]):
            raise AssertionError(f"dp rank {r['rank']} (g): launches "
                                 f"{g['launches']} at N {g['n']}, P "
                                 f"{g['p']}, want K1-K3's bf16 forms once "
                                 f"at N {spec['n']}, P {spec['p']}")
        runs = r["driver"]["runs"]
        got = [*(e["launches"] for e in r["equality"].values()),
               r["timing"]["launches"], *(la for *_, la in runs),
               r["driver"]["stage2_launches"]]
        want = [dict.fromkeys(k13, n) for n in (1, 1, 16, 4, 2)] + [{}]
        if got != want:
            raise AssertionError(f"dp rank {r['rank']}: launches {got}, "
                                 f"want {want} (K1-K3 once a step)")


# ---------------------------------------------------------------------------
# Height-sharded training: two space ranks of the softmax baseline and the
# stage-2 classifier (tpu.spatial_partition, parallel/halo.py)
# ---------------------------------------------------------------------------

SP_SPACE = 2  # space ranks, data 1
SP_BATCH = 8  # the global batch of (a) and (b): each rank all 8 images
SP_DRIVER_BATCH = 4  # train.batch_size of (c): the driver phase's stage 1
# (a), TF32 off: one forward and backward of the ranks, their rows
# joined, against one process, each tolerance plus the floor of that
# precision's SP_FLOOR_RUNS: the largest difference from the one process
# of the same forward and backward in other exact arithmetics, none of
# them the spatial code (cuDNN's own choice of algorithms against its
# heuristics' for the same shapes; the batch's images in reverse order,
# every reduction over the batch in another order; the contiguous NCHW
# layout, other convolution kernels).
# float32 at SP_BATCH, set before the phase's first run on the card: the
# embeddings within SP_EMB_ATOL x max|one process's|, the location
# features equal, each BN running statistic's update within
# SP_STAT_RTOL x max|update| + one float32 unit; each gradient's
# difference in L2 printed as a share of SP_GRAD_RTOL of its L2 + floor,
# not held: the first card run measured the float32 floor runs 3.3%
# off the one process in the gradients' L2 (a stem gradient that is the
# small remainder of large terms through 101 layers of batch norm), and
# the ranks 3.6%.
# float64 at SP_F64_BATCH (the same network, full width and depth), so
# that the gradients can be held: the embeddings, the statistics'
# updates, each gradient element (x max|gradient|) and each gradient
# and all of them in L2 within SP_F64_RTOL, plus that floor.
SP_EMB_ATOL, SP_STAT_RTOL, SP_GRAD_RTOL = 1e-4, 1e-3, 1e-3
SP_F64_BATCH, SP_F64_RTOL = 2, 1e-7
SP_FLOOR_RUNS = {"float32": {"cudnn.benchmark": {"benchmark": True},
                             "images reversed": {"reverse": True},
                             "NCHW": {"nchw": True}},
                 "float64": {"images reversed": {"reverse": True},
                             "NCHW": {"nchw": True}}}
SP_KINDS = ("gradient", "batch norm", "halo", "other")
# (d)-(g): the SegSort branch on the flagship recipe (train/flagship.py:
# panoptic_deeplab_101, 64-d, crop 512, 6x6 k-means x10, capacity 256,
# bank 2, the fused joint loss). (d) float32 at SP_SEG_BATCH (one loss
# group), TF32 off, dropout 0, free and on the one process's segments,
# held to [dp] (a)'s checks and DP_* tolerances, each plus the float32
# floor of SP_SEG_FLOOR_RUNS: the one-process step in other exact
# arithmetics that run none of the spatial code (the batch's halves
# swapped; batch norm by plain autograd; the NCHW layout, other
# convolution kernels). float64 at SP_SEG_F64_BATCH with the dense
# losses (the kernels take float32 alone): the k-means Segments equal,
# every gradient element within SP_F64_RTOL x max|gradient|, the bank
# prototypes within SP_F64_RTOL and the losses within SP_F64_RTOL
# relative, each plus the floor of the one process with its images in
# the other order. All set before the phase's first chip run.
SP_SEG_BATCH, SP_SEG_F64_BATCH, SP_ARM_BATCH = 8, 2, 2
SP_SEG_FLOOR_RUNS = {"halves swapped": {"swap": True},
                     "plain BN": {"bn": "float32"}, "NCHW": {"nchw": True}}
# (e) one float32 step of each arm at SP_ARM_BATCH on the one process's
# segments: losses within DP_LOSS_RTOL of the one process; the arm's
# kernel family launched once a rank
SP_ARMS = {"tags only": ({"sem_ann_loss_types": "none"}, "set"),
           "sem_ann only": ({"sem_occ_loss_types": "none"}, "hard")}
# (f) the labels of the SegSort step's collectives at data 1: the
# prototypes' gather runs over a data group of one rank, which takes no
# collective
SP_SEG_KINDS = ("gradient", "batch norm", "halo", "segments", "other")
K13 = ("joint_stats", "joint_grad_emb", "joint_grad_proto")
# (h)-(k): the DensePose point recipe (train/densepose_point.py:
# panoptic_pspnet_101_densepose, 32-d, crop 512, 12x12 k-means x10,
# capacity 512, no bank, the fused hard-label loss K4-K6) at its global
# batch SP_DP_BATCH over the SP_SPACE ranks (256 image rows a rank).
# (h) float32 (TF32 off, dropout 0) on the one process's k-means
# segments (free, k-means near-ties move pixels in every float32
# arithmetic: (d)), [dp] (a)'s checks and DP_* tolerances over
# SP_DP_CHECKED (tests/test_torch_densepose_step.py's tensors), each plus
# the floor of SP_SEG_FLOOR_RUNS; K4-K6 once a rank at N 32,768 (its rows
# of the 4 images) and P 2,048; then the recipe as it ships (bf16
# convolutions) timed as (f), with PSPP's pools ("pool") and the colour
# features' gather ("colour") among the collectives. (i) float64 at
# SP_SEG_F64_BATCH with the dense losses and sem_occ + tpu.apply_feat_aff
# on (the NN-propagated tags and the feat_aff loss, which the shipped
# recipe leaves off), held as (d)'s float64 run. (j) (h)'s step with
# tpu.loss_operand_dtype "bfloat16" (K4-K6's bf16 forms once a rank):
# each loss within BF16_LOSS_RTOL of the one process's float32 step (and
# [dp] (g): [dp] (a)'s forced flagship step with the knob, K1-K3's bf16
# forms). (k) the DensePose CLIs' drivers: train_spml with
# DenseposeTagDataset for SP_DP_DRIVER_ITERS iterations on
# SP_DP_WORLD_IMAGES point-labelled images, then train_classifier with
# DenseposeClassifierDataset over its snapshot for as many, the ranks'
# train steps on the one process's k-means segments, every logged loss
# within SP_DP_DRIVER_RTOL of one process's: stage 1 with the models,
# bank and images in float64 (the dense losses) and held at SP_F64_RTOL,
# as (i); stage 2 in float32 at DP_LOSS_RTOL; and stage 1 as it ships
# (float32, the fused loss: K4-K6 once a rank) for its first iteration,
# each loss within DP_LOSS_RTOL + the floor of SP_DP_F32_FLOOR_RUNS (the
# one process on its own segments in other exact arithmetics: batch
# norm by plain autograd; the NCHW layout, other convolution kernels;
# the dense loss's prototypes in reverse order), img_sim's taken image by
# image (sp_dp_driver_floor): img_sim is a mean over the images of the
# few point-labelled pixels of each (13, 11, 14 and 10 here), and a
# card run found the ranks' and the floor runs' differences of each
# image of one size, 1e-4 to 5e-4, that cancelled in the floor runs'
# mean of the four images and not in the ranks'.
# The first card runs held both stages in float32 at DP_LOSS_RTOL for
# two iterations and missed it by 3.2e-4 of img_sim at the first
# iteration and 3% at the second, on equal batches (a third run's
# digests), with or without the image panels; the one process itself
# with batch norm by plain autograd lay 0.17% (sem_ann) and 4% (img_sim)
# from it at the second iteration (a fourth): the float32 step of this
# randomly initialized PSPNet on these images magnifies rounding from one
# step to the next (a weight's difference grew 58x), so, as (a) and (d)
# do, the drivers' two iterations are held in float64.
SP_DP_BATCH, SP_DP_DRIVER_ITERS, SP_DP_WORLD_IMAGES = 4, 2, 8
SP_DP_DRIVER_RTOL = {"stage1": SP_F64_RTOL, "stage2": DP_LOSS_RTOL,
                     "stage1_f32": DP_LOSS_RTOL}
SP_DP_DRIVER_RUN_ITERS = {"stage1": SP_DP_DRIVER_ITERS,
                          "stage2": SP_DP_DRIVER_ITERS, "stage1_f32": 1}
SP_DP_F32_FLOOR_RUNS = {"plain BN": {"bn": "float32"},
                        "NCHW": {"nchw": True},
                        "prototypes reversed": {"reverse": True}}
SP_DP_CHECKED = [  # tests/test_torch_densepose_step.py's CHECKED_*
    "emb.pspp.0.pspp_1.1.weight", "emb.pspp.0.pspp_4.2.bias",
    "emb.pspp.0.conv.0.weight", "emb.pspp.0.conv.1.weight",
    "emb.pspp.1.weight", "emb.pspp.1.bias",
    "emb.resnet_backbone.res5.0.conv2.weight",
    "emb.resnet_backbone.res3.0.bn1.weight",
    "cls.semantic_classifier.0.weight",
    "emb.pspp.0.pspp_3.2.running_mean", "emb.pspp.0.conv.1.running_var",
    "emb.resnet_backbone.res4.0.bn2.running_mean",
    "cls.semantic_classifier.1.running_var"]
SP_DP_KINDS = ("gradient", "batch norm", "halo", "segments", "pool",
               "colour", "other")
SP_TIMED_KINDS = {"bf16": SP_KINDS, "seg_bf16": SP_SEG_KINDS,
                  "dp_bf16": SP_DP_KINDS, "l_bf16": SP_SEG_KINDS,
                  "m_bf16": SP_DP_KINDS}
K46 = ("hard_stats", "hard_grad_emb", "hard_grad_proto")


def sp_spec_model(spec, torch, device, dtype):
    """The flagship network (spec's: panoptic_deeplab_101, 64-d) from
    seed 0 in `dtype` (float32 or float64), BN momentum 0.1 (the running
    statistics move visibly in one forward), every parameter trained
    (the stem's stride-2 halo too), in train mode; the global batch's
    images (SP_BATCH in float32, SP_F64_BATCH in float64) and a seeded
    cotangent."""
    from spml_tpu_torch.models.embeddings import build_embedding_model
    from spml_tpu_torch.train import flagship

    dt = getattr(torch, dtype)
    model = build_embedding_model(
        spec["backbone"], spec["dim"], compute_dtype=dt, bn_momentum=0.1,
        generator=torch.Generator().manual_seed(0))
    model = model.to(device, dt, memory_format=torch.channels_last).train()
    crop = spec["crop"]
    b = SP_BATCH if dtype == "float32" else SP_F64_BATCH
    images = flagship.blobby_batch(b, crop, 21, device=device)["image"]
    cot = torch.randn((b, crop // 4, crop // 4, spec["dim"]),
                      generator=torch.Generator().manual_seed(1))
    return model, images.to(dt), cot.to(device, dt)


def sp_forward_backward(torch, model, images, cot, mesh=None, height=None):
    """One train-mode forward of `images` (this rank's rows of images
    `height` rows high inside halo.sharded(mesh, height)) and the
    backward of sum(embeddings * cot): the
    embeddings, location features, running statistics and every
    parameter gradient (summed over the ranks)."""
    from spml_tpu_torch.parallel import halo
    from spml_tpu_torch.parallel import mesh as mesh_lib

    def stats():
        return {k: v.detach().clone() for k, v in
                model.state_dict().items() if "running" in k}

    before = stats()
    with halo.sharded(mesh, height):
        emb, loc = model(images)
    (emb * cot).sum().backward()
    params = list(model.named_parameters())
    grads = torch.cat([p.grad.reshape(-1) for _, p in params])
    with mesh_lib.collective("gradient"):
        grads = mesh_lib.all_reduce(grads)
    sizes = [p.numel() for _, p in params]
    return {"emb": emb.detach(), "loc": loc, "stats": stats(),
            "init_stats": before,
            "grads": {n: g.view_as(p) for (n, p), g in zip(
                params, grads.split(sizes))}}


def sp_one_process(torch, spec, device, dtype, benchmark=False,
                   reverse=False, nchw=False):
    """sp_forward_backward of one process over the whole global batch
    (benchmark: cuDNN's benchmark mode; reverse: the images in reverse
    order, the outputs handed back in the batch's order; nchw: the model
    and its activations in the contiguous NCHW layout, not
    channels_last)."""
    model, images, cot = sp_spec_model(spec, torch, device, dtype)
    if nchw:
        model = model.to(memory_format=torch.contiguous_format)
        images = images.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    order = list(range(images.shape[0]))
    if reverse:
        order = order[::-1]
    old = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = benchmark
    try:
        out = sp_forward_backward(torch, model, images[order], cot[order])
    finally:
        torch.backends.cudnn.benchmark = old
    out["emb"], out["loc"] = out["emb"][order], out["loc"][order]
    return out


def sp_measures(ref, got):
    """Each compared tensor's difference from the reference: the largest
    of the embeddings', location features' and statistics', each
    gradient's largest ("gmax.") and its L2 ("grads."), and the L2 of
    all of them ("grads L2")."""
    m = {"emb": float((got["emb"] - ref["emb"]).abs().max()),
         "loc": float((got["loc"] - ref["loc"]).abs().max())}
    for k, v in ref["stats"].items():
        m["stats." + k] = float((got["stats"][k].to(v.device) - v)
                                .abs().max())
    diff2 = 0.0
    for k, v in ref["grads"].items():
        d = got["grads"][k].to(v.device) - v
        m["grads." + k] = float(d.norm())
        m["gmax." + k] = float(d.abs().max())
        diff2 += m["grads." + k] ** 2
    m["grads L2"] = math.sqrt(diff2)
    return m


def sp_reference(torch, spec, device):
    """For each precision of (a): the one process's forward and backward,
    its floor (the largest difference of SP_FLOOR_RUNS from it) and its
    tolerances, saved to spec["ref"] + precision for the ranks. Returns
    {precision: the floor runs' measures}."""
    out = {}
    for dtype, floor_runs in SP_FLOOR_RUNS.items():
        ref = sp_one_process(torch, spec, device, dtype)
        runs = {name: sp_measures(ref, sp_one_process(
            torch, spec, device, dtype, **kw))
            for name, kw in floor_runs.items()}
        floor = {k: max(r[k] for r in runs.values())
                 for k in runs[next(iter(runs))]}
        f64 = dtype == "float64"
        tol = {"emb": (SP_F64_RTOL if f64 else SP_EMB_ATOL)
               * float(ref["emb"].abs().max()), "loc": 0.0}
        for k, v in ref["stats"].items():
            upd = float((v - ref["init_stats"][k]).abs().max())
            unit = 0.0 if f64 else float(np.spacing(np.float32(
                v.abs().max().item())))
            tol["stats." + k] = (SP_F64_RTOL if f64 else SP_STAT_RTOL) \
                * upd + unit
        rtol = SP_F64_RTOL if f64 else SP_GRAD_RTOL
        for k, v in ref["grads"].items():
            tol["grads." + k] = rtol * float(v.norm())
            tol["gmax." + k] = rtol * float(v.abs().max())
        tol["grads L2"] = rtol * math.sqrt(sum(
            float(v.norm()) ** 2 for v in ref["grads"].values()))
        ref = {k: ({n: t.cpu() for n, t in v.items()}
                   if isinstance(v, dict) else v.cpu())
               for k, v in ref.items()}
        torch.save({**ref, "floor": floor, "tol": tol},
                   spec["ref"] + dtype)
        out[dtype] = runs
        ref = None
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def sp_equality(torch, spec, device, mesh):
    """(a): for each precision, this rank's rows of the forward and
    backward, the ranks' embeddings and location features joined,
    against the one process at tolerance + floor (in float32 the
    gradients' shares printed, not held); the shares, the worst held
    and the worst gradient ones first."""
    from spml_tpu_torch.parallel import mesh as mesh_lib

    out = {}
    for dtype in SP_FLOOR_RUNS:
        model, images, cot = sp_spec_model(spec, torch, device, dtype)
        rows = mesh.rows(images.shape[1])
        grid = cot.shape[1]
        got = sp_forward_backward(torch, model, images[:, rows],
                                  cot[:, mesh.rows(grid)], mesh,
                                  images.shape[1])
        model = images = cot = None
        got["emb"] = mesh_lib.gather_rows(got["emb"].contiguous(), mesh,
                                          grid)
        got["loc"] = mesh_lib.gather_rows(got["loc"].contiguous(), mesh,
                                          grid)
        ref = torch.load(spec["ref"] + dtype, weights_only=True)
        ref = {k: ({n: t.to(device) for n, t in v.items()}
                   if k in ("stats", "grads") else v)
               for k, v in ref.items()}
        ref["emb"], ref["loc"] = ref["emb"].to(device), ref["loc"].to(
            device)
        m = sp_measures(ref, got)
        limit = {k: ref["tol"][k] + ref["floor"][k] for k in m}
        shares = {k: m[k] / limit[k] if limit[k] > 0 else (
            0.0 if m[k] == 0 else math.inf) for k in m}
        held = [k for k in m if dtype == "float64"
                or not k.startswith(("grads", "gmax"))]
        bad = {k: (m[k], ref["tol"][k], ref["floor"][k]) for k in held
               if shares[k] > 1.0}
        if bad:
            raise AssertionError(f"sp rank {mesh.rank} against one "
                                 f"process, {dtype} (difference, "
                                 f"tolerance, floor): {bad}")
        grads = [k for k in m if k.startswith("grads")]
        out[dtype] = {
            "held": sorted(((k, shares[k]) for k in held),
                           key=lambda kv: -kv[1])[:3],
            "grads": sorted(((k, shares[k]) for k in grads),
                            key=lambda kv: -kv[1])[:3],
            "emb": m["emb"], "floor_emb": ref["floor"]["emb"],
            "l2": shares["grads L2"], "n_grads": len(ref["grads"]),
            "n_stats": len(ref["stats"])}
        got = ref = None
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def sp_config():
    """The softmax baseline on the flagship recipe (train/flagship.py,
    bf16) at the global batch SP_BATCH (each of the SP_SPACE ranks its
    rows of all of it)."""
    import copy

    from spml_tpu_torch.train import flagship

    over = copy.deepcopy(flagship.OVERRIDES)
    over["network"]["prediction_types"] = "softmax_classifier"
    over["train"]["batch_size"] = SP_BATCH
    return over


def sp_time(torch, spec, device, mesh=None, mesh_lib=None, key="bf16",
            fused=None):
    """(b), (f), (h): the bf16 step of spec[key] (the softmax baseline,
    the SegSort step, DensePose's), 3 warm-up and 10 timed steps: this
    rank's rows (mesh) or one process; then, for a rank, 3 steps with
    every collective timed by its label (SP_TIMED_KINDS[key]), and the
    kernels launched in all 16 (fused)."""
    from spml_tpu_torch.config import load_config
    from spml_tpu_torch.train import step as step_lib

    cfg = load_config(overrides=spec[key])
    if mesh is not None:
        cfg.tpu.spatial_partition = mesh.space
    batch = recipe_batch(cfg, device)
    state = step_lib.init_state(cfg, 0, batch["image"], device=device)
    step = step_lib.make_train_step(cfg)
    if mesh is None:
        _, ms, peak = time_steps(torch, step, state, batch, device)
        return {"ms": ms, "peak": peak}
    if fused is not None:
        fused.reset_launch_counts()
    local = mesh_lib.shard_rows(batch, mesh)
    state, ms, peak = time_steps(torch, step, state, local, device,
                                 mesh_lib.barrier)
    with timing_collectives(torch, device, mesh_lib) as kinds:
        for _ in range(3):
            state, m = step(state, local)
    want = SP_TIMED_KINDS[key]
    if set(kinds) != set(want):  # a call site lost its label
        raise AssertionError(f"sp: collectives of kinds {sorted(kinds)}, "
                             f"want {want}")
    coll = {k: (sum(c.ms() for c in v) / 3, len(v) // 3)
            for k, v in kinds.items()}
    out = {"ms": ms, "peak": peak, "collectives": coll,
           "loss": float(m["loss"])}
    if fused is not None:
        out["launches"] = {k: v for k, v in fused.LAUNCHES.items() if v}
    return out


def sp_driver(torch, fused, spec, device, mesh):
    """(c): train_spml with the softmax baseline for 4 iterations and
    resumed to 6, then train_classifier over its snapshot for 2, on
    every rank: iterations, checkpoints, launches, digests."""
    import argparse

    from spml_tpu_torch.config import load_config
    from spml_tpu_torch.data import datasets
    from spml_tpu_torch.train import driver
    from spml_tpu_torch.utils import checkpoint as ckpt

    root = spec["root"]
    stage1_dir = os.path.join(root, "sp_stage1")

    def args(snapshot):
        return argparse.Namespace(data_dir=spec["data"],
                                  data_list=spec["list"],
                                  snapshot_dir=snapshot)

    logged = []
    log_metrics = driver._log_metrics

    def capture(writer, metrics, it, prefix=""):
        logged.append((it, float(metrics["loss"])))
        log_metrics(writer, metrics, it, prefix)

    driver._log_metrics = capture
    out = {"runs": []}
    try:
        for first, last in ((0, 4), (4, 6)):
            cfg = load_config(overrides=spec["stage1"])
            cfg.train.max_iteration = last
            cfg.train.resume = first > 0
            cfg.train.tensorboard_step = 1  # every iteration, with panels
            logged.clear()
            fused.reset_launch_counts()
            state = driver.train_spml(args(stage1_dir), cfg,
                                      datasets.ListTagDataset, device=device)
            out["runs"].append((first, last, [it for it, _ in logged],
                                [loss for _, loss in logged], {
                                    k: v for k, v in fused.LAUNCHES.items()
                                    if v}))
        out["stage1"] = digest(model_tensors(state))
        out["num_devices"] = cfg.tpu.num_devices
        ck_dir = os.path.join(stage1_dir, "checkpoints")
        out["checkpoints"] = ckpt.steps(ck_dir)
        out["rank_generators"] = len(ckpt.read(ck_dir).get(
            "rank_generators", []))
        state = None
        stage2 = load_config(overrides=spec["stage1"])
        stage2.network.pretrained = stage1_dir
        stage2.train.max_iteration = 2
        stage2.train.tensorboard_step = 1
        logged.clear()
        fused.reset_launch_counts()
        head = driver.train_classifier(
            args(os.path.join(root, "sp_stage2")), stage2,
            datasets.ListTagClassifierDataset, device=device).cls_model
        out["stage2"] = digest(head.state_dict())
        out["stage2_iterations"] = [it for it, _ in logged]
        out["stage2_losses"] = [loss for _, loss in logged]
        out["stage2_launches"] = {k: v for k, v in fused.LAUNCHES.items()
                                  if v}
    finally:
        driver._log_metrics = log_metrics
    return out


def sp_segsort_config(dtype, batch, fused=True, **train):
    """The flagship SegSort recipe (train/flagship.py) at train.batch_size
    `batch` in `dtype`, the fused loss on or off, with `train`'s
    overrides."""
    import copy

    from spml_tpu_torch.train import flagship

    over = copy.deepcopy(flagship.OVERRIDES)
    over["train"].update(batch_size=batch, **train)
    over["tpu"].update(compute_dtype=dtype, use_fused_loss=fused)
    return over


def sp_join_segments(torch, segs, mesh, crop, width=None):
    """A rank's Segments with its pixel fields ([B, rows x W], its rows
    of the embedding grid at crop height `crop`, width `width`: crop
    when None) joined with the other space ranks' rows, in order: the
    whole images'."""
    from spml_tpu_torch.ops import kmeans
    from spml_tpu_torch.parallel import halo
    from spml_tpu_torch.parallel import mesh as mesh_lib

    grid, cols = grid_rows(crop), grid_rows(width or crop)
    mine = len(halo.partition(grid, mesh.space)[mesh.space_rank])
    return [mesh_lib.gather_rows(t.reshape(t.shape[0], mine, cols)
                                 .contiguous(), mesh, grid)
            .reshape(t.shape[0], -1).cpu()
            if name.startswith("pixel") else t
            for name, t in zip(kmeans.Segments._fields, segs)]


def sp_segsort_equality(torch, fused, spec, device, mesh):
    """(d) float32: this rank's rows of the flagship SegSort step against
    the one process (dp_reference over SP_SEG_FLOOR_RUNS), free and on
    the one process's segments, each held to [dp] (a)'s checks at
    tolerance + that mode's floor; K1-K3 once a step with their N and
    P."""
    from spml_tpu_torch.parallel import mesh as mesh_lib
    from spml_tpu_torch.train import step as step_lib

    seg = spec["seg"]
    ref = torch.load(seg["ref"], weights_only=True)
    every = slice(0, seg["global"])
    out = {}
    for run, given in (("free", None), ("equal", ref["segments"])):
        cfg, batch, state = dp_setup(seg, "f32", device)
        cfg.tpu.spatial_partition = SP_SPACE
        local = mesh_lib.shard_rows(batch, mesh)
        step = step_lib.make_train_step(cfg)
        fused.reset_launch_counts()
        crop = cfg.train.crop_size[0]
        with recording_stats(torch, fused, "joint") as last, \
                segments_of(torch, given, every,
                            sp_shard(mesh, crop)) as rec:
            state, m = step(state, local)
        launches = {k: v for k, v in fused.LAUNCHES.items() if v}
        got = dp_step_result(torch, state, m, rec)
        got["segments"] = sp_join_segments(torch, got["segments"], mesh,
                                           crop)
        measures, bad = compare_step(
            torch, ref, got, every, seg["capacity"], ref["floor"][run],
            DP_FREE_CHECKS if given is None else DP_CHECKS)
        if bad:
            raise AssertionError(f"sp rank {mesh.rank} SegSort against one "
                                 f"process ({run} segments): {bad} "
                                 f"({measures})")
        out[run] = {**measures, "losses": got["losses"],
                    "launches": launches,
                    "n": int(last["args"][0].shape[0]),
                    "p": int(last["args"][4].shape[0]),
                    "digest": digest({**got["after"], **{
                        "bank." + k: v for k, v in got["memory"].items()}})}
        state = m = got = None
    return out


def sp_f64_step(torch, spec, device, mesh=None, swap=False, key="seg"):
    """One float64 step of spec[key]["f64"] (the flagship SegSort recipe
    at SP_SEG_F64_BATCH, or DensePose's) with the dense losses from the
    seed-0 state, dropout 0, the models, bank and images in float64:
    losses, k-means Segments (a rank's rows joined), every parameter's
    gradient and the bank. mesh: this rank's rows; swap: the images in
    the other order (handed back in the batch's)."""
    import dataclasses

    from spml_tpu_torch.config import load_config
    from spml_tpu_torch.parallel import mesh as mesh_lib
    from spml_tpu_torch.train import step as step_lib

    cfg = load_config(overrides=spec[key]["f64"])
    if mesh is not None:
        cfg.tpu.spatial_partition = mesh.space
    g = cfg.train.batch_size
    batch = recipe_batch(cfg, device)
    state = step_lib.init_state(cfg, 0, batch["image"], device=device)
    state.cls_model.semantic_classifier[3].p = 0.0
    for model in (state.emb_model, state.cls_model):
        model.double()
        model.compute_dtype = torch.float64
    state.memory = dataclasses.replace(state.memory, **{
        k: v.double() for k, v in vars(state.memory).items()
        if v.is_floating_point()})
    order = list(range(g))[::-1] if swap else list(range(g))
    batch = {k: v[order] for k, v in batch.items()}
    batch["image"] = batch["image"].double()
    if mesh is not None:
        batch = mesh_lib.shard_rows(batch, mesh)
    with segments_of(torch) as rec:
        state, m = step_lib.make_train_step(cfg)(state, batch)
    segs = rec["segments"]
    if mesh is not None:
        segs = sp_join_segments(torch, segs, mesh, *cfg.train.crop_size)
    p = cfg.tpu.segment_capacity
    return {"losses": {k: float(v) for k, v in m.items()
                       if k.endswith("loss")},
            "segments": [t[order] for t in segs],
            "grads": {n: q.grad.detach().cpu()
                      for n, q in step_lib._named_params(state)
                      if q.grad is not None},
            "bank": {k: v.cpu().reshape(v.shape[0], g, p, *v.shape[2:])
                     [:, order].reshape(v.shape)
                     for k, v in vars(state.memory).items()}}


def sp_f64_measures(ref, got):
    """got's differences from ref: each loss (relative), each gradient
    element (over the gradient's max |ref|), the bank's floats, and the
    Segments' and bank labels' equality."""
    m = {"loss." + k: abs(got["losses"][k] - v) / max(abs(v), 1e-300)
         for k, v in ref["losses"].items()}
    for k, v in ref["grads"].items():
        m["grad." + k] = float((got["grads"][k] - v).abs().max()
                               / v.abs().max().clamp(min=1e-300))
    m["bank"] = max(float((got["bank"][k] - v).abs().max())
                    for k, v in ref["bank"].items() if v.is_floating_point())
    equal = all(a.equal(b) for a, b in zip(got["segments"],
                                           ref["segments"]))
    labels = all(got["bank"][k].equal(v) for k, v in ref["bank"].items()
                 if not v.is_floating_point())
    return m, equal, labels


def sp_seg_reference(torch, spec, device):
    """The one-process references of (d), (e) and (f): (d) float32 with
    dp_reference over SP_SEG_FLOOR_RUNS, float64 with its floor run;
    (e) each arm's step; (f) the bf16 step timed. Returns what (d)'s
    line prints of the floor runs and (f)'s one-process timing."""
    seg = spec["seg"]
    out = {"f32": dp_reference(torch, seg, device, SP_SEG_FLOOR_RUNS)}
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref = sp_f64_step(torch, spec, device)
    floor, equal, _ = sp_f64_measures(
        ref, sp_f64_step(torch, spec, device, swap=True))
    if not equal:  # float64 has no k-means near-ties to move a pixel
        raise AssertionError("sp float64 floor run: the segments of the "
                             "reversed batch differ")
    torch.save({**ref, "floor": floor}, seg["ref64"])
    out["f64_floor"] = max(floor.values())
    ref = None
    if device.type == "cuda":
        torch.cuda.empty_cache()
    arms = {arm: sp_arm_step(torch, None, spec, arm, device)
            for arm in SP_ARMS}
    torch.save(arms, seg["ref_arms"])
    out["arms"] = {a: r["losses"] for a, r in arms.items()}
    out["time"] = sp_time(torch, spec, device, key="seg_bf16")
    return out


def sp_f64_equality(torch, spec, device, mesh, key="seg"):
    """(d), (i) float64: this rank's rows of the dense step of spec[key]
    against the one process: the Segments and bank labels equal, every
    measure within SP_F64_RTOL + its floor."""
    ref = torch.load(spec[key]["ref64"], weights_only=True)
    got = sp_f64_step(torch, spec, device, mesh, key=key)
    m, equal, labels = sp_f64_measures(ref, got)
    bad = {k: (v, ref["floor"][k]) for k, v in m.items()
           if v > SP_F64_RTOL + ref["floor"][k]}
    if bad or not (equal and labels):
        raise AssertionError(f"sp rank {mesh.rank} float64 SegSort step: "
                             f"segments equal {equal}, bank labels equal "
                             f"{labels}, over tolerance + floor: {bad}")
    worst = max(m, key=lambda k: m[k] / (SP_F64_RTOL + ref["floor"][k]))
    return {"worst": (worst, m[worst], ref["floor"][worst]),
            "n_grads": len(ref["grads"]),
            "pixels": int(ref["segments"][0].numel())}


def sp_arm_step(torch, fused, spec, arm, device, mesh=None, given=None):
    """(e): one float32 step of an arm (SP_ARMS) of the flagship recipe
    at SP_ARM_BATCH from the seed-0 state, dropout 0: losses, k-means
    Segments and the kernels launched. mesh: this rank's rows; given:
    the one process's Segments to take in place of its own."""
    from spml_tpu_torch.config import load_config
    from spml_tpu_torch.parallel import mesh as mesh_lib
    from spml_tpu_torch.train import flagship
    from spml_tpu_torch.train import step as step_lib

    cfg = load_config(overrides=spec["seg"]["arms"][arm])
    shard = (0, 1, None)
    if mesh is not None:
        cfg.tpu.spatial_partition = SP_SPACE
        shard = sp_shard(mesh, cfg.train.crop_size[0])
    batch = flagship.blobby_batch(SP_ARM_BATCH, cfg.train.crop_size[0],
                                  cfg.dataset.num_classes, device=device)
    state = step_lib.init_state(cfg, 0, batch["image"], device=device)
    state.cls_model.semantic_classifier[3].p = 0.0
    if mesh is not None:
        batch = mesh_lib.shard_rows(batch, mesh)
    step = step_lib.make_train_step(cfg)
    if fused is not None:
        fused.reset_launch_counts()
    with segments_of(torch, given, slice(None), shard) as rec:
        state, m = step(state, batch)
    out = {"losses": {k: float(v) for k, v in m.items()
                      if k.endswith("loss")},
           "segments": rec["segments"]}
    if fused is not None:
        out["launches"] = {k: v for k, v in fused.LAUNCHES.items() if v}
    return out


def sp_arms(torch, fused, spec, device, mesh):
    """(e) on this rank: each arm's step on the one process's segments,
    its losses within DP_LOSS_RTOL of the one process's."""
    refs = torch.load(spec["seg"]["ref_arms"], weights_only=True)
    out = {}
    for arm in SP_ARMS:
        got = sp_arm_step(torch, fused, spec, arm, device, mesh,
                          refs[arm]["segments"])
        want = refs[arm]["losses"]
        bad = {k: (got["losses"][k], v) for k, v in want.items()
               if abs(got["losses"][k] - v) > DP_LOSS_RTOL * abs(v)}
        if bad or got["losses"].keys() != want.keys():
            raise AssertionError(f"sp rank {mesh.rank} {arm}: losses "
                                 f"(rank, one process) {bad}")
        out[arm] = {"launches": got["launches"],
                    "rel": max(abs(got["losses"][k] - v) / (abs(v) or 1.0)
                               for k, v in want.items())}
    return out


def sp_segsort_driver(torch, fused, spec, device, mesh):
    """(g): train_spml on the flagship SegSort recipe (the driver phase's
    stage 1, batch SP_DRIVER_BATCH, tensorboard_step 1) for 4 iterations
    and resumed to 6: iterations, launches, checkpoints, digests."""
    import argparse

    from spml_tpu_torch.config import load_config
    from spml_tpu_torch.data import datasets
    from spml_tpu_torch.train import driver
    from spml_tpu_torch.utils import checkpoint as ckpt

    snapshot = os.path.join(spec["root"], "sp_segsort")
    args = argparse.Namespace(data_dir=spec["data"], data_list=spec["list"],
                              snapshot_dir=snapshot)
    logged = []
    log_metrics = driver._log_metrics

    def capture(writer, metrics, it, prefix=""):
        logged.append((it, float(metrics["loss"])))
        log_metrics(writer, metrics, it, prefix)

    driver._log_metrics = capture
    out = {"runs": []}
    try:
        for first, last in ((0, 4), (4, 6)):
            cfg = load_config(overrides=spec["seg"]["stage1"])
            cfg.train.max_iteration = last
            cfg.train.resume = first > 0
            cfg.train.tensorboard_step = 1  # every iteration, with panels
            logged.clear()
            fused.reset_launch_counts()
            state = driver.train_spml(args, cfg, datasets.ListTagDataset,
                                      device=device)
            out["runs"].append((first, last, [it for it, _ in logged],
                                [loss for _, loss in logged], {
                                    k: v for k, v in fused.LAUNCHES.items()
                                    if v}))
        out["digest"] = digest({**model_tensors(state), **{
            "bank." + k: v for k, v in vars(state.memory).items()}})
        out["bank_images"] = int(state.memory.prototype.shape[1]
                                 // cfg.tpu.segment_capacity)
        out["num_devices"] = cfg.tpu.num_devices
        ck_dir = os.path.join(snapshot, "checkpoints")
        out["checkpoints"] = ckpt.steps(ck_dir)
        out["rank_generators"] = len(ckpt.read(ck_dir).get(
            "rank_generators", []))
    finally:
        driver._log_metrics = log_metrics
    return out


def sp_rank(spec, *, device):
    """One rank of the [sp] phase, in a process of its own
    (parallel/mesh.py::spawn): (a), (b), (c), then the SegSort branch's
    (d), (e), (f) and (g), then DensePose's (h), (i), (j), (k)."""
    import torch

    from spml_tpu_torch.ops import _cuda
    from spml_tpu_torch.ops import segsort_loss as fused
    from spml_tpu_torch.parallel import mesh as mesh_lib

    _cuda.CSRC = Path(spec["csrc"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = mesh_lib.make_mesh(SP_SPACE)
    t0 = time.perf_counter()
    out = {"rank": mesh.rank, "world": mesh.world, "space": mesh.space}
    for name, run in (
            ("equality", lambda: sp_equality(torch, spec, device, mesh)),
            ("timing", lambda: sp_time(torch, spec, device, mesh,
                                       mesh_lib)),
            ("driver", lambda: sp_driver(torch, fused, spec, device,
                                         mesh)),
            ("segsort", lambda: sp_segsort_equality(torch, fused, spec,
                                                    device, mesh)),
            ("segsort64", lambda: sp_f64_equality(torch, spec, device,
                                                  mesh)),
            ("arms", lambda: sp_arms(torch, fused, spec, device, mesh)),
            ("seg_timing", lambda: sp_time(torch, spec, device, mesh,
                                           mesh_lib, "seg_bf16", fused)),
            ("seg_driver", lambda: sp_segsort_driver(torch, fused, spec,
                                                     device, mesh)),
            ("dp", lambda: sp_dp_equality(torch, fused, spec, device, mesh)),
            ("dp64", lambda: sp_f64_equality(torch, spec, device, mesh,
                                             "dp")),
            ("dp_timing", lambda: sp_time(torch, spec, device, mesh,
                                          mesh_lib, "dp_bf16", fused)),
            ("dp_driver", lambda: sp_dp_driver(torch, fused, spec, device,
                                               mesh))):
        out[name] = run()
        if device.type == "cuda":  # the ranks may share one card
            torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    return out


def check_sp(spec, ranks):
    """The ranks against each other, the drivers' iterations,
    checkpoints and launches (none on the softmax path; K1-K3 once a
    step on the SegSort path)."""
    digests = [(r["driver"]["stage1"], r["driver"]["stage2"],
                r["segsort"]["free"]["digest"],
                r["segsort"]["equal"]["digest"], r["seg_driver"]["digest"])
               for r in ranks]
    if digests[0] != digests[1]:
        raise AssertionError(f"sp: the ranks' tensors differ: {digests}")
    for r in ranks:
        dr = r["driver"]
        if [(f, la, it) for f, la, it, _, _ in dr["runs"]] != [
                (0, 4, [0, 1, 2, 3]), (4, 6, [4, 5])]:
            raise AssertionError(f"sp rank {r['rank']}: stage 1 runs "
                                 f"{dr['runs']}")
        if (dr["checkpoints"] != [2, 4, 6]
                or dr["rank_generators"] != SP_SPACE
                or dr["num_devices"] != SP_SPACE
                or dr["stage2_iterations"] != [0, 1]):
            raise AssertionError(f"sp rank {r['rank']} driver: {dr}")
        losses = [x for *_, ls, _ in dr["runs"] for x in ls] + dr[
            "stage2_losses"] + [r["timing"]["loss"]]
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"sp rank {r['rank']}: losses {losses}")
        launched = [la for *_, la in dr["runs"]] + [dr["stage2_launches"]]
        if any(launched):
            raise AssertionError(f"sp rank {r['rank']}: kernels launched "
                                 f"{launched} on a path that has none")
        check_sp_segsort(spec, r)


def check_sp_segsort(spec, r):
    """(d)-(g) of one rank: K1-K3 once a step at the rank's N and P, each
    arm's family once, the driver's iterations, checkpoints and
    launches."""
    seg = spec["seg"]
    for run, eq in r["segsort"].items():
        if (eq["n"], eq["p"]) != (seg["n"], seg["p"]):
            raise AssertionError(f"sp rank {r['rank']} ({run}): K1-K3 at N "
                                 f"{eq['n']}, P {eq['p']}, want {seg['n']}, "
                                 f"{seg['p']}")
    for arm, (_, family) in SP_ARMS.items():
        want = {f"{family}_{kind}": 1 for kind in KINDS}
        if r["arms"][arm]["launches"] != want:
            raise AssertionError(f"sp rank {r['rank']} {arm}: launches "
                                 f"{r['arms'][arm]['launches']}, want {want}")
    dr = r["seg_driver"]
    got = [*(e["launches"] for e in r["segsort"].values()),
           r["seg_timing"]["launches"], *(la for *_, la in dr["runs"])]
    want = [dict.fromkeys(K13, n) for n in (1, 1, 16, 4, 2)]
    if got != want:
        raise AssertionError(f"sp rank {r['rank']}: SegSort launches {got}, "
                             f"want {want} (K1-K3 once a step)")
    if ([(f, la, it) for f, la, it, _, _ in dr["runs"]] != [
            (0, 4, [0, 1, 2, 3]), (4, 6, [4, 5])]
            or dr["checkpoints"] != [2, 4, 6]
            or dr["rank_generators"] != SP_SPACE
            or dr["num_devices"] != SP_SPACE
            or dr["bank_images"] != SP_DRIVER_BATCH):
        raise AssertionError(f"sp rank {r['rank']} SegSort driver: {dr}")
    losses = [x for *_, ls, _ in dr["runs"] for x in ls] + [
        r["seg_timing"]["loss"]]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"sp rank {r['rank']}: SegSort losses {losses}")


def run_sp(torch, devices=None, backend=None, device=None):
    """The [sp] phase: SP_SPACE ranks of one data rank spawned once, each
    running sp_rank; this process computes the one-process references,
    their floors and timings first. devices, backend, device: the CPU
    rehearsal's (cpu ranks, gloo, cpu)."""
    import copy
    import tempfile

    from spml_tpu_torch.data import synthetic
    from spml_tpu_torch.ops import _cuda
    from spml_tpu_torch.ops import segsort_loss as fused
    from spml_tpu_torch.parallel import mesh as mesh_lib
    from spml_tpu_torch.train import densepose_point

    if devices is None:
        devices, backend, case = dp_devices(torch)
    else:
        case = f"{backend} on {devices}"
    device = torch.device(device or DEVICE)
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="spml_sp_") as root:
        data = os.path.join(root, "world")
        lst = synthetic.write_world(data, WORLD_IMAGES, seed=0)
        stage1 = copy.deepcopy(STAGE1)
        stage1["network"]["prediction_types"] = "softmax_classifier"
        stage1["train"]["batch_size"] = SP_DRIVER_BATCH
        stage1["tpu"]["spatial_partition"] = SP_SPACE
        seg_stage1 = copy.deepcopy(STAGE1)
        seg_stage1["train"]["batch_size"] = SP_DRIVER_BATCH
        seg_stage1["tpu"]["spatial_partition"] = SP_SPACE
        f32 = sp_segsort_config("float32", SP_SEG_BATCH)
        crop = f32["train"]["crop_size"][0]
        capacity = f32["tpu"]["segment_capacity"]
        seg = {"f32": f32, "global": SP_SEG_BATCH, "capacity": capacity,
               "f64": sp_segsort_config("float64", SP_SEG_F64_BATCH,
                                        fused=False),
               "arms": {a: sp_segsort_config("float32", SP_ARM_BATCH, **t)
                        for a, (t, _) in SP_ARMS.items()},
               "stage1": seg_stage1,
               # K1-K3 on a rank: its rows' pixels of every image, against
               # the global batch's prototypes and the bank's
               "n": SP_SEG_BATCH * (crop // 4) ** 2 // SP_SPACE,
               "p": SP_SEG_BATCH * capacity
               * (1 + f32["train"]["memory_bank_size"]),
               "ref": os.path.join(root, "seg_ref.pt"),
               "ref64": os.path.join(root, "seg_ref64.pt"),
               "ref_arms": os.path.join(root, "seg_arms.pt")}
        spec = {"csrc": str(_cuda.CSRC), "root": root, "data": data,
                "list": lst, "stage1": stage1,
                "backbone": STAGE1["network"]["backbone_types"],
                "dim": STAGE1["network"]["embedding_dim"],
                "crop": STAGE1["train"]["crop_size"][0],
                "bf16": sp_config(), "ref": os.path.join(root, "ref.pt"),
                "seg_bf16": sp_segsort_config("bfloat16", SP_SEG_BATCH),
                "seg": seg, "dp": sp_densepose_spec(root),
                "dp_bf16": copy.deepcopy(densepose_point.OVERRIDES)}
        log("sp", f"{len(devices)} ranks (data 1 x space {SP_SPACE}) on "
            f"{devices}: {case}")
        t_ref = time.perf_counter()
        floor_runs = sp_reference(torch, spec, device)
        if device.type == "cuda":
            torch.cuda.empty_cache()
        one = sp_time(torch, spec, device)
        if device.type == "cuda":
            torch.cuda.empty_cache()
        seg_one = sp_seg_reference(torch, spec, device)
        if device.type == "cuda":
            torch.cuda.empty_cache()
        dp_one = sp_dp_reference(torch, fused, spec, device)
        if device.type == "cuda":
            torch.cuda.empty_cache()
        t_ref = time.perf_counter() - t_ref
        t0 = time.perf_counter()
        ranks = mesh_lib.spawn(sp_rank, (spec,), devices, backend)
        spawn_s = time.perf_counter() - t0
        check_sp(spec, ranks)
    eq = [r["equality"] for r in ranks]
    tm = [r["timing"] for r in ranks]
    st = [r["seg_timing"] for r in ranks]
    dr = ranks[0]["driver"]
    ms = max(t["ms"] for t in tm)
    coll = {k: max(t["collectives"][k][0] for t in tm) for k in SP_KINDS}
    counts = {k: tm[0]["collectives"][k][1] for k in SP_KINDS}
    a = eq[0]["float32"]
    log("sp", f"(a) TF32 off, {spec['backbone']} {spec['dim']}-d, crop "
        f"{spec['crop']}, train mode, every parameter trained, one forward "
        f"and backward: the {SP_SPACE} ranks' rows joined against one "
        f"process, each tolerance plus its floor. float32, batch "
        f"{SP_BATCH}: embeddings atol {SP_EMB_ATOL} x max, location "
        f"features equal, {a['n_stats']} running statistics' updates "
        f"within {SP_STAT_RTOL} held; {a['n_grads']} gradients' L2 against "
        f"{SP_GRAD_RTOL} printed. float64, batch {SP_F64_BATCH}: all of "
        f"those and every gradient element and L2 within {SP_F64_RTOL} "
        "held. " + " | ".join(
            f"rank {r}, {dt}: embeddings {e[dt]['emb']:.3e} (floor "
            f"{e[dt]['floor_emb']:.3e}), gradients' L2 {e[dt]['l2']:.3f} "
            "of tolerance + floor; worst held " + ", ".join(
                f"{k} {v:.3f}" for k, v in e[dt]["held"])
            + "; worst gradients " + ", ".join(
                f"{k} {v:.3f}" for k, v in e[dt]["grads"])
            for r, e in enumerate(eq) for dt in SP_FLOOR_RUNS)
        + ". Floor runs: " + " | ".join(
            f"{dt} {name}: embeddings {m['emb']:.3e}, gradients' L2 "
            f"{m['grads L2']:.3e}" for dt, runs in floor_runs.items()
            for name, m in runs.items()))
    log("sp", f"(b) bf16 softmax baseline, global batch {SP_BATCH}, 3 + 10 "
        f"steps: {ms:.2f} ms/step (ranks "
        + " / ".join(f"{t['ms']:.2f}" for t in tm)
        + f"), {SP_BATCH * 1000 / ms:.2f} images/s, peak "
        + " / ".join(f"{t['peak']:.2f}" for t in tm)
        + " GiB a rank; collectives a step (slowest rank, ms, count): "
        + ", ".join(f"{k} {coll[k]:.2f} ({counts[k]})" for k in SP_KINDS)
        + f"; one process x {SP_BATCH}: {one['ms']:.2f} ms/step, peak "
        f"{one['peak']:.2f} GiB; case: {case}")
    log("sp", f"(c) train_spml softmax baseline, batch {SP_DRIVER_BATCH}, "
        f"{SP_SPACE} space ranks: runs "
        + ", ".join(f"{a}-{b} losses {[round(x, 4) for x in ls]}"
                    for a, b, _, ls, _ in dr["runs"])
        + f", tpu.num_devices {dr['num_devices']}, checkpoints "
        f"{dr['checkpoints']} from rank 0 with {dr['rank_generators']} "
        "generator states, resumed at step 4, ranks torch.equal; "
        f"train_classifier iterations {dr['stage2_iterations']}, losses "
        f"{[round(x, 4) for x in dr['stage2_losses']]}, heads torch.equal; "
        "no kernel launched")
    log_sp_segsort(spec, ranks, seg_one)
    sp_densepose_lines(spec, ranks, dp_one)
    dt = [r["dp_timing"] for r in ranks]
    log("sp", f"summary, {case}: {ms:.2f} ms/step, peak "
        f"{max(t['peak'] for t in tm):.2f} GiB a rank against "
        f"{one['ms']:.2f} ms/step, {one['peak']:.2f} GiB one process "
        f"(softmax baseline); SegSort {max(t['ms'] for t in st):.2f} "
        f"ms/step, peak {max(t['peak'] for t in st):.2f} GiB a rank against "
        f"{seg_one['time']['ms']:.2f} ms/step, "
        f"{seg_one['time']['peak']:.2f} GiB one process; DensePose "
        f"{max(t['ms'] for t in dt):.2f} ms/step, peak "
        f"{max(t['peak'] for t in dt):.2f} GiB a rank against "
        f"{dp_one['time']['ms']:.2f} ms/step, "
        f"{dp_one['time']['peak']:.2f} GiB one process; "
        f"one-process references {t_ref:.1f} s, spawn to join "
        f"{spawn_s:.1f} s, "
        f"phase {time.perf_counter() - t_phase:.1f} s; card "
        f"{nvidia_smi_line()}")


def log_sp_segsort(spec, ranks, one):
    """Lines (d)-(g) of the [sp] phase."""
    seg = spec["seg"]
    eq = [r["segsort"] for r in ranks]
    log("sp", f"(d) float32 (TF32 off, dropout 0), the flagship SegSort "
        f"step (fused joint loss, bank 2) at batch {SP_SEG_BATCH} over "
        f"{SP_SPACE} space ranks against one process, [dp] (a)'s "
        f"tolerances (losses rtol {DP_LOSS_RTOL}; bank labels, tags, "
        f"validity, batch indices and integer buffers equal; update L2 "
        f"{DP_UPDATE_RTOL}; the {len(DP_CHECKED)} checked updates "
        f"{DP_UPDATE_RTOL} max|update|; bank prototypes atol "
        f"{DP_BANK_ATOL}), each plus the floor of "
        f"{', '.join(SP_SEG_FLOOR_RUNS)}. "
        + " ".join(dp_mode_words(mode, [e[mode] for e in eq],
                                 one["f32"][mode], seg["n"] * SP_SPACE)
                   for mode in ("free", "equal"))
        + f" Losses {eq[0]['free']['losses']}; the ranks' parameters, "
        "buffers and banks torch.equal (sha256)")
    f64 = [r["segsort64"] for r in ranks]
    log("sp", f"(d) float64, batch {SP_SEG_F64_BATCH}, dense losses: the "
        f"{f64[0]['pixels']} pixels' k-means segments and the bank labels "
        f"equal one process's; losses, {f64[0]['n_grads']} gradients (each "
        f"element over its max) and the bank prototypes within "
        f"{SP_F64_RTOL} + the floor (images reversed, largest "
        f"{one['f64_floor']:.3e}); worst " + " | ".join(
            f"rank {r}: {w[0]} {w[1]:.3e} (floor {w[2]:.3e})"
            for r, w in enumerate(f["worst"] for f in f64)))
    log("sp", "(d) launches a rank in each float32 step " + " / ".join(
        str(e[m]["launches"]) for e in eq for m in ("free", "equal"))
        + f": K1-K3 once each at N {eq[0]['free']['n']} (a rank's rows), "
        f"P {eq[0]['free']['p']}")
    log("sp", f"(e) one float32 step at batch {SP_ARM_BATCH} on the one "
        f"process's segments, losses within rtol {DP_LOSS_RTOL}: " + "; ".join(
            f"{arm} (losses {one['arms'][arm]}) worst relative "
            + " / ".join(f"{r['arms'][arm]['rel']:.2e}" for r in ranks)
            + " , launches a rank " + " / ".join(
                str(r["arms"][arm]["launches"]) for r in ranks)
            for arm in SP_ARMS))
    st = [r["seg_timing"] for r in ranks]
    ms = max(t["ms"] for t in st)
    kinds = SP_SEG_KINDS + ("gather",)
    coll = {k: max(t["collectives"].get(k, (0.0, 0))[0] for t in st)
            for k in kinds}
    counts = {k: st[0]["collectives"].get(k, (0.0, 0))[1] for k in kinds}
    log("sp", f"(f) bf16 flagship SegSort step, global batch "
        f"{SP_SEG_BATCH}, 3 + 10 steps: {ms:.2f} ms/step (ranks "
        + " / ".join(f"{t['ms']:.2f}" for t in st)
        + f"), {SP_SEG_BATCH * 1000 / ms:.2f} images/s, peak "
        + " / ".join(f"{t['peak']:.2f}" for t in st)
        + " GiB a rank; collectives a step (slowest rank, ms, count): "
        + ", ".join(f"{k} {coll[k]:.2f} ({counts[k]})" for k in kinds)
        + " (gather: the prototypes' data group is one rank, no "
        f"collective); one process x {SP_SEG_BATCH}: "
        f"{one['time']['ms']:.2f} ms/step, peak {one['time']['peak']:.2f} "
        "GiB; launches a rank " + " / ".join(str(t["launches"])
                                             for t in st))
    dr = ranks[0]["seg_driver"]
    log("sp", f"(g) train_spml on the SegSort recipe (fused joint loss, "
        f"batch {SP_DRIVER_BATCH}, bank of the global batch), "
        f"{SP_SPACE} space ranks: runs "
        + ", ".join(f"{a}-{b} losses {[round(x, 4) for x in ls]} launches "
                    f"{la}" for a, b, _, ls, la in dr["runs"])
        + f", tpu.num_devices {dr['num_devices']}, checkpoints "
        f"{dr['checkpoints']} from rank 0 with {dr['rank_generators']} "
        "generator states, resumed at step 4, ranks torch.equal")


def sp_densepose_spec(root):
    """spec["dp"] of (h)-(k): the recipe's configurations, sizes and the
    paths of the one-process references, and a world of
    SP_DP_WORLD_IMAGES point-labelled images for the drivers."""
    import copy

    from spml_tpu_torch.data import synthetic
    from spml_tpu_torch.train import densepose_point

    def over(dtype, batch, train=(), **tpu):
        o = copy.deepcopy(densepose_point.OVERRIDES)
        o["train"].update(batch_size=batch, **dict(train))
        o["tpu"].update(compute_dtype=dtype, **tpu)
        return o

    f32 = over("float32", SP_DP_BATCH)
    crop = f32["train"]["crop_size"][0]
    capacity = f32["tpu"]["segment_capacity"]
    data = os.path.join(root, "densepose_world")
    lst = synthetic.write_world(
        data, SP_DP_WORLD_IMAGES, shapes=((427, 640), (640, 427)),
        num_classes=densepose_point.NUM_CLASSES, seed=0,
        points=DENSEPOSE_POINTS)
    return {"f32": f32, "global": SP_DP_BATCH, "capacity": capacity,
            "checked": SP_DP_CHECKED, "recipe": "densepose_point",
            "f32_lbf16": over("float32", SP_DP_BATCH,
                              loss_operand_dtype="bfloat16"),
            "f64": over("float64", SP_SEG_F64_BATCH,
                        {"sem_occ_loss_types": "segsort"},
                        use_fused_loss=False, apply_feat_aff=True),
            "driver": over("float32", SP_DP_BATCH, {
                "max_iteration": SP_DP_DRIVER_ITERS, "tensorboard_step": 1,
                "snapshot_step": SP_DP_DRIVER_ITERS},
                spatial_partition=SP_SPACE, use_fused_loss=False),
            "data": data, "list": lst,
            # K4-K6 on a rank: its rows' pixels of every image, against
            # the global batch's prototypes (no bank)
            "n": SP_DP_BATCH * (crop // 4) ** 2 // SP_SPACE,
            "p": SP_DP_BATCH * capacity,
            "ref": os.path.join(root, "dp_ref.pt"),
            "ref64": os.path.join(root, "dp_ref64.pt"),
            "ref_driver": os.path.join(root, "dp_ref_driver.pt")}


def sp_dp_reference(torch, fused, spec, device):
    """The one-process references of (h)-(k): (h) float32 on its own
    segments with the floor of SP_SEG_FLOOR_RUNS on them (dp_reference),
    (i) float64 with the floor of its images reversed, (h) the bf16 step
    timed, (k) the drivers. Returns what the lines print of them."""
    dp = spec["dp"]
    out = {"f32": dp_reference(torch, dp, device, SP_SEG_FLOOR_RUNS,
                               ("equal",))["equal"],
           "f32_losses": torch.load(dp["ref"], weights_only=True)["losses"]}
    if device.type == "cuda":
        torch.cuda.empty_cache()
    # (j)'s limits; a rank counted twice: rank 0's rows of every image
    grid = grid_rows(dp["f32"]["train"]["crop_size"][0])
    rank0 = torch.zeros(dp["global"], grid, grid, dtype=torch.bool)
    rank0[:, :len(halo_partition(grid, SP_SPACE)[0])] = True
    out["bf16_floor"], out["miscounted"] = bf16_reference(
        torch, fused, dp, device, "hard", rank0.reshape(-1))
    ref = sp_f64_step(torch, spec, device, key="dp")
    floor, equal, _ = sp_f64_measures(
        ref, sp_f64_step(torch, spec, device, swap=True, key="dp"))
    if not equal:  # float64 has no k-means near-ties to move a pixel
        raise AssertionError("sp DensePose float64 floor run: the segments "
                             "of the reversed batch differ")
    torch.save({**ref, "floor": floor}, dp["ref64"])
    out["f64_floor"] = max(floor.values())
    ref = None
    if device.type == "cuda":
        torch.cuda.empty_cache()
    out["time"] = sp_time(torch, spec, device, key="dp_bf16")
    out["driver"] = sp_dp_driver(torch, fused, spec, device)
    return out


def sp_dp_equality(torch, fused, spec, device, mesh, key="dp",
                   arms=("f32", "f32_lbf16"), family="hard"):
    """(h) float32 and (j) (and (l), (m) at crop 513: key "l" or "m",
    the float32 arm alone): this rank's rows of spec[key]'s step on the
    one process's segments (each rank its rows of them), first with
    float32 loss operands, held to [dp] (a)'s checks at tolerance + floor
    over spec[key]'s checked tensors, then with tpu.loss_operand_dtype
    "bfloat16", its losses within BF16_LOSS_RTOL of the one process's
    float32 step and its checked updates within their bf16 limits
    (bf16_reference); the family's kernels launched with their N and
    P."""
    from spml_tpu_torch.parallel import mesh as mesh_lib
    from spml_tpu_torch.train import step as step_lib

    dp = spec[key]
    ref = torch.load(dp["ref"], weights_only=True)
    every = slice(0, dp["global"])
    at = STATS_ARGS[family].index("protos")
    out = {}
    for arm in arms:
        cfg, batch, state = dp_setup(dp, arm, device)
        cfg.tpu.spatial_partition = mesh.space
        crop = cfg.train.crop_size[0]
        local = mesh_lib.shard_rows(batch, mesh)
        step = step_lib.make_train_step(cfg)
        fused.reset_launch_counts()
        if device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with recording_stats(torch, fused, family) as last, \
                segments_of(torch, ref["segments"], every,
                            sp_shard(mesh, crop)) as rec:
            state, m = step(state, local)
        if device.type == "cuda":
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3  # one step, the first
        got = dp_step_result(torch, state, m, rec)
        entry = {"losses": got["losses"],
                 "launches": {k: v for k, v in fused.LAUNCHES.items() if v},
                 "n": int(last["args"][0].shape[0]),
                 "p": int(last["args"][at].shape[0]), "ms": ms,
                 "peak": torch.cuda.max_memory_allocated() / 2**30
                 if device.type == "cuda" else 0.0}
        if arm == "f32":
            got["segments"] = sp_join_segments(torch, got["segments"], mesh,
                                               *cfg.train.crop_size)
            measures, bad = compare_step(
                torch, ref, got, every, dp["capacity"], ref["floor"]["equal"],
                DP_CHECKS, dp.get("checked", DP_CHECKED),
                dp.get("floor_all", False), dp.get("unheld", ()))
            if bad:
                raise AssertionError(f"sp rank {mesh.rank} {key} against one "
                                     f"process: {bad} ({measures})")
            entry.update(measures)
            entry["digest"] = digest({**got["after"], **{
                "bank." + k: v for k, v in got["memory"].items()}})
        else:
            want = ref["losses"]
            entry["rel"] = {k: abs(got["losses"][k] - v) / abs(v)
                            for k, v in want.items()}
            entry["shares"] = bf16_update_shares(ref, got)
            if (got["losses"].keys() != want.keys()
                    or max(entry["rel"].values()) > BF16_LOSS_RTOL
                    or max(entry["shares"].values()) > 1):
                raise AssertionError(
                    f"sp rank {mesh.rank} {key}, bf16 loss operands: "
                    f"losses {got['losses']} against float32 {want}, "
                    f"rtol {BF16_LOSS_RTOL}; updates' shares of their "
                    f"limits {entry['shares']}")
        out[arm] = entry
        state = m = got = None
    return out


@contextlib.contextmanager
def prototypes_reversed():
    """The dense SegSort loss (ops/losses.py::segsort_log_likelihood,
    img_sim's) with the prototype axis in reverse order: the same sums
    over the prototypes, added in another order."""
    from spml_tpu_torch.ops import losses

    orig = losses.segsort_log_likelihood

    def flipped(emb, own, same, diff, protos, concentration):
        return orig(emb, protos.shape[-2] - 1 - own, same.flip(-1),
                    diff.flip(-1), protos.flip(-2), concentration)

    losses.segsort_log_likelihood = flipped
    try:
        yield
    finally:
        losses.segsort_log_likelihood = orig


@contextlib.contextmanager
def img_sim_images():
    """Records the per-image means of the train step's img_sim
    (train/step.py::_grouped_masked_mean's per_image calls): the yielded
    list gets each call's values, float."""
    from spml_tpu_torch.train import step

    orig, got = step._grouped_masked_mean, []

    def recording(values, mask, *a, per_image=False, **k):
        if per_image:
            got.append(values.detach().double().cpu().tolist())
        return orig(values, mask, *a, per_image=per_image, **k)

    step._grouped_masked_mean = recording
    try:
        yield got
    finally:
        step._grouped_masked_mean = orig


def sp_dp_driver(torch, fused, spec, device, mesh=None):
    """(k): the DensePose CLIs' drivers on every rank (mesh) or in one
    process: train_spml with DenseposeTagDataset for SP_DP_DRIVER_ITERS
    iterations with the models, bank and images in float64 (the dense
    losses), then train_classifier with DenseposeClassifierDataset over
    its snapshot in float32, then train_spml as the recipe ships
    (float32, the fused loss) for one iteration ("stage1_f32"), and in
    one process that again in each of SP_DP_F32_FLOOR_RUNS on its
    segments: each run's logged losses, launches, digest. The
    classifiers' dropout is 0 (rank r draws its rows' masks from seed +
    r, one process from seed), as in (a)-(j). The one process writes its
    k-means segments of each run's steps to spec["dp"]["ref_driver"];
    the ranks' steps take their rows of those."""
    import argparse
    import dataclasses

    from spml_tpu_torch.config import load_config
    from spml_tpu_torch.data import datasets
    from spml_tpu_torch.train import classifier_step, driver
    from spml_tpu_torch.train import step as step_lib

    dp = spec["dp"]
    root = os.path.join(spec["root"], "dp_sp" if mesh else "dp_one")
    logged = []
    log_metrics, next_batch = driver._log_metrics, driver._next_batch

    def capture(writer, metrics, it, prefix=""):
        logged.append((it, {k: float(v) for k, v in metrics.items()
                            if k.endswith("loss")}))
        log_metrics(writer, metrics, it, prefix)

    # opts: the running run's (the loop below): f64, nchw, bn, reverse
    def next_run(*a, **k):  # the run's images: float64, NCHW layout
        batch = next_batch(*a, **k)
        image = batch["image"]
        if opts.get("f64"):
            image = image.double()
        if opts.get("nchw"):
            image = image.permute(0, 3, 1, 2).contiguous().permute(
                0, 2, 3, 1)
        return {**batch, "image": image}

    def config(pretrained=None, shipped=False):
        cfg = load_config(overrides=dp["driver"])
        if mesh is None:
            cfg.tpu.spatial_partition = 1
        if pretrained:
            cfg.network.pretrained = pretrained
        if shipped:  # stage1_f32: one iteration, the fused loss
            cfg.train.max_iteration = SP_DP_DRIVER_RUN_ITERS["stage1_f32"]
            cfg.tpu.use_fused_loss = True
        return cfg

    def stage1_state(*a, **k):
        state = inits[0](*a, **k)
        state.cls_model.semantic_classifier[3].p = 0.0
        for model in (state.emb_model, state.cls_model):
            if opts.get("nchw"):
                model.to(memory_format=torch.contiguous_format)
            if opts.get("f64"):
                model.double()
                model.compute_dtype = torch.float64
        if opts.get("f64"):
            state.memory = dataclasses.replace(state.memory, **{
                k: v.double() for k, v in vars(state.memory).items()
                if v.is_floating_point()})
        return state

    def stage2_state(*a, **k):
        state = inits[1](*a, **k)
        state.cls_model.semantic_classifier[3].p = 0.0
        return state

    inits = step_lib.init_state, classifier_step.init_classifier_state
    step_lib.init_state = stage1_state
    classifier_step.init_classifier_state = stage2_state
    tag = (driver.train_spml, datasets.DenseposeTagDataset)
    runs = [("stage1", *tag, config(), {"f64": True}),
            ("stage2", driver.train_classifier,
             datasets.DenseposeClassifierDataset,
             config(os.path.join(root, "stage1")), {}),
            ("stage1_f32", *tag, config(shipped=True), {})]
    if mesh is None:
        runs += [(f"stage1_f32 {name}", *tag, config(shipped=True), kw)
                 for name, kw in SP_DP_F32_FLOOR_RUNS.items()]
    out, every = {}, {}
    driver._log_metrics, driver._next_batch = capture, next_run
    given = (None if mesh is None
             else torch.load(dp["ref_driver"], weights_only=True))
    shard = ((0, 1, None) if mesh is None
             else sp_shard(mesh, config().train.crop_size[0]))
    try:
        for run, fn, data_cls, cfg, opts in runs:
            logged.clear()
            fused.reset_launch_counts()
            each = (given[run] if given else every["stage1_f32"]
                    if run.startswith("stage1_f32 ") else None)
            with segments_of(torch, shard=shard, each=each) as rec, \
                    (plain_batch_norm(torch, opts["bn"]) if "bn" in opts
                     else contextlib.nullcontext()), \
                    (prototypes_reversed() if opts.get("reverse")
                     else contextlib.nullcontext()), \
                    img_sim_images() as images:
                state = fn(argparse.Namespace(
                    data_dir=dp["data"], data_list=dp["list"],
                    snapshot_dir=os.path.join(root, run)), cfg, data_cls,
                    device=device)
            every[run] = rec["every"]
            w = cfg.train.img_sim_loss_weight
            out[run] = {
                "logged": list(logged),
                "launches": {k: v for k, v in fused.LAUNCHES.items() if v},
                "digest": digest(model_tensors(state)
                                 if state.emb_model is not None
                                 else state.cls_model.state_dict()),
                # each step's img_sim of each image (a rank: its share)
                # and its valid pixels (a rank: its rows')
                "img_sim_images": [[w * x for x in v] for v in images],
                "img_sim_pixels": [seg[1].sum(-1).tolist()  # pixel_valid
                                   for seg in rec["every"]]}
            state = None
    finally:
        driver._log_metrics, driver._next_batch = log_metrics, next_batch
        step_lib.init_state, classifier_step.init_classifier_state = inits
    if mesh is None:
        torch.save(every, dp["ref_driver"])
    return out


def sp_densepose_lines(spec, ranks, one):
    """Lines (h)-(k), then their checks (the lines first: a failure
    shows them)."""
    log_sp_densepose(spec, ranks, one)
    check_sp_densepose(spec, ranks, one)


def sp_dp_driver_floor(one):
    """{run: [{loss: floor} an iteration]}: 0 but in stage1_f32, where a
    loss's floor is the largest |difference| of a run of
    SP_DP_F32_FLOOR_RUNS from the one process's; img_sim's, the mean over
    the images of each image's largest (img_sim is a mean over the images
    of a few point-labelled pixels each, and the runs' differences of
    the images may cancel in their mean by chance); the total loss's,
    the sum of its terms' floors."""
    dr, out = one["driver"], {}
    for run in SP_DP_DRIVER_RTOL:
        out[run] = []
        for i, (it, m) in enumerate(dr[run]["logged"]):
            fl = dict.fromkeys(m, 0.0)
            if run == "stage1_f32":
                runs = [dr[f"{run} {name}"] for name in SP_DP_F32_FLOOR_RUNS]
                fl = {k: max(abs(dict(f["logged"])[it][k] - v) for f in runs)
                      for k, v in m.items()}
                fl["img_sim_loss"] = float(np.mean([
                    max(abs(f["img_sim_images"][i][j] - x) for f in runs)
                    for j, x in enumerate(dr[run]["img_sim_images"][i])]))
                fl["loss"] = fl["sem_ann_loss"] + fl["img_sim_loss"]
            out[run].append(fl)
    return out


def check_sp_densepose(spec, ranks, one):
    """(h)-(k) of the ranks: equal to each other, K4-K6 (and in (j) their
    bf16 forms) once a step a rank at the rank's N and P, the drivers'
    iterations and launches, and their losses against one process's."""
    dp = spec["dp"]
    if len({(r["dp"]["f32"]["digest"], *(r["dp_driver"][run]["digest"]
                                          for run in SP_DP_DRIVER_RTOL))
            for r in ranks}) != 1:
        raise AssertionError("sp DensePose: the ranks' tensors differ")
    bf16 = tuple(k + BF16 for k in K46)
    for r in ranks:
        e = r["dp"]
        got = [(e[a]["launches"], e[a]["n"], e[a]["p"]) for a in e] + [
            r["dp_timing"]["launches"],
            *(r["dp_driver"][run]["launches"] for run in SP_DP_DRIVER_RTOL)]
        want = [(dict.fromkeys(K46, 1), dp["n"], dp["p"]),
                (dict.fromkeys(bf16, 1), dp["n"], dp["p"]),
                dict.fromkeys(K46, 16), {}, {}, dict.fromkeys(K46, 1)]
        if got != want:
            raise AssertionError(f"sp rank {r['rank']} DensePose: (launches, "
                                 f"N, P) {got}, want {want}")
        check_sp_dp_driver(r, one)


def check_sp_dp_driver(r, one):
    """(k) of rank r: each run's iterations, and each logged loss within
    its run's SP_DP_DRIVER_RTOL of one process's, plus the floor."""
    floor = sp_dp_driver_floor(one)
    for run, rtol in SP_DP_DRIVER_RTOL.items():
        mine = r["dp_driver"][run]["logged"]
        ref = one["driver"][run]["logged"]
        its = [it for it, _ in mine]
        bad = {(it, k): (v, w[k]) for (it, m), (_, w), fl in zip(
            mine, ref, floor[run]) for k, v in m.items()
               if not abs(v - w[k]) <= rtol * abs(w[k]) + fl[k]}
        if (its != list(range(SP_DP_DRIVER_RUN_ITERS[run]))
                or its != [it for it, _ in ref] or bad):
            raise AssertionError(f"sp rank {r['rank']} DensePose {run} "
                                 f"driver: iterations {its}, losses "
                                 f"(rank, one process) {bad}")


def log_sp_densepose(spec, ranks, one):
    """Lines (h)-(k) of the [sp] phase."""
    dp = spec["dp"]
    eq = [r["dp"]["f32"] for r in ranks]
    log("sp", f"(h) float32 (TF32 off, dropout 0), the DensePose point step "
        f"(panoptic_pspnet_101_densepose, fused hard-label loss) at batch "
        f"{SP_DP_BATCH} over {SP_SPACE} space ranks against one process, "
        f"[dp] (a)'s tolerances over the {len(SP_DP_CHECKED)} tensors of "
        "tests/test_torch_densepose_step.py, each plus the floor of "
        f"{', '.join(SP_SEG_FLOOR_RUNS)}. "
        + dp_mode_words("equal", eq, one["f32"], dp["n"] * SP_SPACE)
        + f" Losses {eq[0]['losses']}; launches a rank "
        + " / ".join(str(e["launches"]) for e in eq)
        + f": K4-K6 once each at N {eq[0]['n']} (a rank's rows), P "
        f"{eq[0]['p']}; the ranks' parameters, buffers and banks "
        "torch.equal (sha256)")
    f64 = [r["dp64"] for r in ranks]
    log("sp", f"(i) float64, batch {SP_SEG_F64_BATCH}, dense losses with "
        f"sem_occ and tpu.apply_feat_aff (NN tags, feat_aff): the "
        f"{f64[0]['pixels']} pixels' k-means segments and the bank labels "
        f"equal one process's; losses, {f64[0]['n_grads']} gradients (each "
        f"element over its max) and the bank prototypes within "
        f"{SP_F64_RTOL} + the floor (images reversed, largest "
        f"{one['f64_floor']:.3e}); worst " + " | ".join(
            f"rank {r}: {w[0]} {w[1]:.3e} (floor {w[2]:.3e})"
            for r, w in enumerate(f["worst"] for f in f64)))
    lb = [r["dp"]["f32_lbf16"] for r in ranks]
    log("sp", f"(j) (h) with tpu.loss_operand_dtype bfloat16: losses "
        f"{lb[0]['losses']}, relative to the one process's float32 "
        f"{one['f32_losses']} at most " + " / ".join(
            f"{max(e['rel'].values()):.3e}" for e in lb)
        + f" (rtol {BF16_LOSS_RTOL}); " + bf16_words(
            [e["shares"] for e in lb], one["bf16_floor"], one["miscounted"])
        + "; launches a rank "
        + " / ".join(str(e["launches"]) for e in lb)
        + f" at N {lb[0]['n']}, P {lb[0]['p']}")
    st = [r["dp_timing"] for r in ranks]
    ms = max(t["ms"] for t in st)
    coll = {k: max(t["collectives"][k][0] for t in st) for k in SP_DP_KINDS}
    counts = {k: st[0]["collectives"][k][1] for k in SP_DP_KINDS}
    log("sp", f"(h) bf16 DensePose point step as it ships, global batch "
        f"{SP_DP_BATCH}, 3 + 10 steps: {ms:.2f} ms/step (ranks "
        + " / ".join(f"{t['ms']:.2f}" for t in st)
        + f"), {SP_DP_BATCH * 1000 / ms:.2f} images/s, peak "
        + " / ".join(f"{t['peak']:.2f}" for t in st)
        + f" GiB a rank against one process's {one['time']['peak']:.2f} "
        f"GiB ({one['time']['ms']:.2f} ms/step); collectives a step "
        "(slowest rank, ms, count): "
        + ", ".join(f"{k} {coll[k]:.2f} ({counts[k]})" for k in SP_DP_KINDS)
        + "; launches a rank " + " / ".join(str(t["launches"]) for t in st))
    log_sp_dp_driver(ranks, one)


def sum_ranks(ranks, key, run="stage1_f32"):
    """The ranks' per-image lists of dp_driver[run][key], summed over
    the ranks, a step each."""
    return [[float(f"{sum(x):.9g}") for x in zip(*steps)] for steps in zip(
        *(r["dp_driver"][run][key] for r in ranks))]


def log_sp_dp_driver(ranks, one):
    """Line (k) of the [sp] phase."""
    dr = ranks[0]["dp_driver"]

    def rel(run):
        """Each logged loss's difference from one process's, relative."""
        return [{k: float(f"{abs(v - w[k]) / abs(w[k] or 1.0):.3e}")
                 for k, v in m.items()}
                for (_, m), (_, w) in zip(dr[run]["logged"],
                                          one["driver"][run]["logged"])]

    def share(d, tol):
        return d / tol if tol else math.inf if d else 0.0

    f32 = zip(dr["stage1_f32"]["logged"], one["driver"]["stage1_f32"][
        "logged"], sp_dp_driver_floor(one)["stage1_f32"])
    log("sp", f"(k) the DensePose CLIs' drivers, {SP_SPACE} space ranks "
        "against one process (its k-means segments), dropout 0: "
        f"train_spml (DenseposeTagDataset, batch {SP_DP_BATCH}) in float64 "
        "with the dense losses " + "; ".join(
            f"iteration {it} {m}" for it, m in dr["stage1"]["logged"])
        + "; train_classifier (DenseposeClassifierDataset) over its "
        "snapshot, float32, " + "; ".join(
            f"iteration {it} {m}" for it, m in dr["stage2"]["logged"])
        + ", no kernel; train_spml as it ships (float32, K4-K6 "
        f"{dr['stage1_f32']['launches']}) " + "; ".join(
            f"iteration {it} {m}: |difference| " + ", ".join(
                f"{k} {abs(v - w[k]):.3e} (floor {fl[k]:.3e}, "
                f"{share(abs(v - w[k]), DP_LOSS_RTOL * abs(w[k]) + fl[k]):.3f}"
                " of tolerance + floor)" for k, v in m.items())
            for (it, m), (_, w), fl in f32)
        + f"; floor runs ({', '.join(SP_DP_F32_FLOOR_RUNS)}) " + str(
            {name: one["driver"][f"stage1_f32 {name}"]["logged"]
             for name in SP_DP_F32_FLOOR_RUNS})
        + "; img_sim of each image (weighted), the ranks' shares summed "
        f"{sum_ranks(ranks, 'img_sim_images')}, one process "
        f"{one['driver']['stage1_f32']['img_sim_images']}, " + ", ".join(
            f"{name} {one['driver'][f'stage1_f32 {name}']['img_sim_images']}"
            for name in SP_DP_F32_FLOOR_RUNS)
        + ", over valid pixels (ranks summed) "
        f"{sum_ranks(ranks, 'img_sim_pixels')}"
        + "; relative to one process's " + str(
            {run: rel(run) for run in SP_DP_DRIVER_RTOL})
        + f" (rtol {SP_DP_DRIVER_RTOL}); the ranks torch.equal")


# ---------------------------------------------------------------------------
# Uneven height shards: three space ranks at crop 513
# ---------------------------------------------------------------------------

# (l), (m): DeepLab-v2's VOC training crop, 513 x 513, over SP3_SPACE
# space ranks of one data rank (171 image rows a rank), so the maps split
# unevenly at strides 2 (257 rows) and 8 (65: 21, 22, 22) and on the
# embedding grid (130: 43, 43, 44), at full width. (l) the flagship
# SegSort step (fused joint loss, bank 2) in float32 at SP_SEG_BATCH on
# the one process's segments, [dp] (a)'s checks and DP_* tolerances plus
# the floor of SP_SEG_FLOOR_RUNS, as (d); float64 at SP_SEG_F64_BATCH
# with the dense losses, as (d)'s float64 run. (m) the DensePose point
# step at SP_DP_BATCH, held as (h) and (i). K1-K3 (l) and K4-K6 (m) once
# a step a rank, each at its own N. Each recipe's bf16 step as it ships
# timed beside one process, as (f) and (h).
SP3_SPACE, SP3_CROP = 3, 513
SP3_KEYS = {"l": ("joint", K13), "m": ("hard", K46)}
# (n) in the same spawn: ranks that hold no row of a map. (l)'s and (m)'s
# steps at crops whose deeper maps have fewer rows than SP3_SPACE, float32
# on the one process's segments and float64 dense, held as (l) and (m),
# not timed: crop heights 15 (the stride-8 map's 2 rows as none, 1, 1;
# the embedding grid's 4 as 1, 1, 2) and 6 (the stride-8 map's 1 row as
# none, none, 1; the embedding grid's 2 as none, 1, 1: rank 0 calls the
# kernels with N = 0, and K1, K2, K4 and K5 start no grid there), each
# SP3_CROP wide (the centre rows of the crop-513 batch). Square crops
# that short leave res5 2 x 2 and 1 x 1 a image, so batch norm there
# reads 8-32 values a channel: a first chip run found the one process's
# own float32 floor runs 11 (crop 15) and 50-250 (crop 6) tolerances
# apart on the updates and 1e-4 to 5e-3 on the losses, which holds
# nothing. 513 columns give res5 65 columns.
SP3_EMPTY_CROPS = (15, 6)
# (n)'s float32 losses printed beside their floor, not held: DensePose's
# img_sim is a mean over each image's few point-labelled pixels, a dozen
# in 15 rows, and a chip run found the one process's floor runs 4e-4 to
# 2e-3 apart on it and the ranks 3e-3 (its float64 step holds it).
SP3_UNHELD = {"hard": ("img_sim_loss",)}
SP3_EMPTY_KEYS = {f"n{crop}{key}": (key, crop) for crop in SP3_EMPTY_CROPS
                  for key in SP3_KEYS}


def sp3_cases():
    """{key: (family, kernels, crop, timed)} of (l), (m) and (n)."""
    out = {k: (*v, SP3_CROP, True) for k, v in SP3_KEYS.items()}
    out.update({k: (*SP3_KEYS[base], crop, False)
                for k, (base, crop) in SP3_EMPTY_KEYS.items()})
    return out


def sp3_devices(torch):
    """(rank devices, backend, the case in words) of the SP3_SPACE
    ranks: NCCL with a card each when there are as many, else gloo with
    every rank on cuda:0."""
    count = torch.cuda.device_count()
    if count >= SP3_SPACE:
        return ([f"cuda:{i}" for i in range(SP3_SPACE)], "nccl",
                f"NCCL, one card a rank ({count} cards)")
    return (["cuda:0"] * SP3_SPACE, "gloo",
            f"gloo, {SP3_SPACE} ranks share one card ({count} card): "
            "not a scaling figure")


def sp3_rank_n(batch, crop, width=None):
    """Each rank's pixels of the embedding grid at crop `crop` x `width`
    (crop when None): its rows of the grid's partition x the grid's
    columns x the images."""
    grid, cols = grid_rows(crop), grid_rows(width or crop)
    return [batch * len(p) * cols for p in halo_partition(grid, SP3_SPACE)]


def sp3_spec(root):
    """The configurations, sizes and reference paths of (l), (m) and
    (n)."""
    import copy

    from spml_tpu_torch.train import densepose_point, flagship

    def at_crop(over, dtype, batch, crop, train=(), **tpu):
        o = copy.deepcopy(over)
        o["train"].update(batch_size=batch, crop_size=[crop, SP3_CROP],
                          **dict(train))
        o["tpu"].update(compute_dtype=dtype, **tpu)
        return o

    spec = {"root": root, "space": SP3_SPACE}
    for key, (family, _, crop, timed) in sp3_cases().items():
        base, batch, checked = {
            "joint": (flagship.OVERRIDES, SP_SEG_BATCH, DP_CHECKED),
            "hard": (densepose_point.OVERRIDES, SP_DP_BATCH, SP_DP_CHECKED),
        }[family]
        over = at_crop(base, "float32", batch, crop)
        spec[key] = {
            "f32": over, "global": batch,
            "capacity": over["tpu"]["segment_capacity"], "checked": checked,
            "f64": at_crop(base, "float64", SP_SEG_F64_BATCH, crop,
                           use_fused_loss=False),
            "n": sp3_rank_n(batch, crop, SP3_CROP),
            "p": batch * over["tpu"]["segment_capacity"]
            * (1 + over["train"].get("memory_bank_size", 0)),
            "ref": os.path.join(root, f"{key}_ref.pt"),
            "ref64": os.path.join(root, f"{key}_ref64.pt"),
            # (n)'s short crops: the losses and L2 at tolerance + floor,
            # but DensePose's img_sim (SP3_UNHELD)
            "floor_all": not timed,
            "unheld": () if timed else SP3_UNHELD.get(family, ())}
        if timed:
            spec[key + "_bf16"] = at_crop(base, "bfloat16",
                                          base["train"]["batch_size"], crop)
    return spec


def sp3_reference(torch, fused, spec, device):
    """The one-process references of (l), (m) and (n): float32 on its own
    segments with the floor of SP_SEG_FLOOR_RUNS on them (dp_reference),
    float64 with the floor of its images reversed, the bf16 step timed
    ((l) and (m)). Returns what the lines print of them."""
    out = {"n_seconds": 0.0}
    for key, (_, _, _, timed) in sp3_cases().items():
        t0 = time.perf_counter()
        s = spec[key]
        one = {"f32": dp_reference(torch, s, device, SP_SEG_FLOOR_RUNS,
                                   ("equal",))["equal"]}
        one["floor"] = torch.load(s["ref"], weights_only=True)["floor"][
            "equal"]
        if device.type == "cuda":
            torch.cuda.empty_cache()
        ref = sp_f64_step(torch, spec, device, key=key)
        floor, equal, _ = sp_f64_measures(
            ref, sp_f64_step(torch, spec, device, swap=True, key=key))
        if not equal:  # float64 has no k-means near-ties to move a pixel
            raise AssertionError(f"sp {key} float64 floor run: the segments "
                                 "of the reversed batch differ")
        torch.save({**ref, "floor": floor}, s["ref64"])
        one["f64_floor"] = max(floor.values())
        ref = None
        if device.type == "cuda":
            torch.cuda.empty_cache()
        if timed:
            one["time"] = sp_time(torch, spec, device, key=key + "_bf16")
        else:
            out["n_seconds"] += time.perf_counter() - t0
        out[key] = one
    return out


def sp3_rank(spec, *, device):
    """One rank of (l), (m) and (n), in a process of its own: the float32
    step on the one process's segments, the float64 step, the bf16 step
    timed ((l) and (m)), for each; the seconds of the whole and of
    (n)."""
    import torch

    from spml_tpu_torch.ops import _cuda
    from spml_tpu_torch.ops import segsort_loss as fused
    from spml_tpu_torch.parallel import mesh as mesh_lib

    _cuda.CSRC = Path(spec["csrc"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = mesh_lib.make_mesh(SP3_SPACE)
    t0 = time.perf_counter()
    out = {"rank": mesh.rank, "world": mesh.world, "space": mesh.space}
    for key, (family, _, _, timed) in sp3_cases().items():
        if key in SP3_EMPTY_KEYS and "n_t0" not in out:
            out["n_t0"] = time.perf_counter()
        for name, run in (
                ("f32", lambda: sp_dp_equality(torch, fused, spec, device,
                                               mesh, key, ("f32",),
                                               family)["f32"]),
                ("f64", lambda: sp_f64_equality(torch, spec, device, mesh,
                                                key)),
                ("timing", lambda: sp_time(torch, spec, device, mesh,
                                           mesh_lib, key + "_bf16", fused)
                 if timed else None)):
            out[key + " " + name] = run()
            if device.type == "cuda":  # the ranks share one card
                torch.cuda.empty_cache()
    out["n_seconds"] = time.perf_counter() - out.pop("n_t0")
    out["seconds"] = time.perf_counter() - t0
    return out


def sp3_launches(kernels, n):
    """The launches of a step's family kernels (stats, dE, dP) on a rank
    at N pixels: each once, but the stats and dE kernels none at N = 0
    (their C functions start no grid; the dP kernel still writes P's
    zeros)."""
    return {k: 1 for k in kernels if n or k.endswith("grad_proto")}


def check_sp3(spec, ranks):
    """(l), (m), (n) of the ranks: equal to each other; the family's
    kernels once a step a rank (sp3_launches), each rank at its own N
    (sp3_rank_n) and the global P; (n) at crop 6 with N = 0 on rank 0."""
    for key, (_, kernels, _, timed) in sp3_cases().items():
        if len({r[key + " f32"]["digest"] for r in ranks}) != 1:
            raise AssertionError(f"sp {key}: the ranks' tensors differ")
        s = spec[key]
        for r in ranks:
            e, t = r[key + " f32"], r[key + " timing"]
            n = s["n"][r["rank"]]
            got = (e["launches"], e["n"], e["p"])
            want = (sp3_launches(kernels, n), n, s["p"])
            if timed:
                got += (t["launches"],)
                want += (dict.fromkeys(kernels, 16),)
            if got != want:
                raise AssertionError(f"sp rank {r['rank']} {key}: (launches, "
                                     f"N, P, timed launches) {got}, want "
                                     f"{want}")
            if timed and not math.isfinite(t["loss"]):
                raise AssertionError(f"sp rank {r['rank']} {key}: bf16 loss "
                                     f"{t['loss']}")
    if min(spec[f"n{min(SP3_EMPTY_CROPS)}l"]["n"]) != 0:
        raise AssertionError("sp (n): no rank at N = 0")


def log_sp3(spec, ranks, one, case):
    """Lines (l) and (m)."""
    what = {"l": f"the flagship SegSort step (panoptic_deeplab_101 64-d, "
                 f"fused joint loss, bank 2) at batch {SP_SEG_BATCH}",
            "m": f"the DensePose point step (panoptic_pspnet_101_densepose "
                 f"32-d, fused hard-label loss) at batch {SP_DP_BATCH}"}
    grid = grid_rows(SP3_CROP)
    rows = "/".join(str(len(p)) for p in halo_partition(grid, SP3_SPACE))
    for key, (_, kernels) in SP3_KEYS.items():
        s, o = spec[key], one[key]
        eq = [r[key + " f32"] for r in ranks]
        log("sp", f"({key}) crop {SP3_CROP} over {SP3_SPACE} space ranks "
            f"(embedding rows {rows} of {grid}), float32 (TF32 off, dropout "
            f"0), {what[key]} on the one process's segments against one "
            f"process, [dp] (a)'s tolerances over {len(s['checked'])} "
            f"checked tensors, each plus the floor of "
            f"{', '.join(SP_SEG_FLOOR_RUNS)}. "
            + dp_mode_words("equal", eq, o["f32"], sum(s["n"]))
            + f" Losses {eq[0]['losses']}; launches a rank "
            + " / ".join(str(e["launches"]) for e in eq)
            + f" at N " + " / ".join(str(e["n"]) for e in eq)
            + f", P {eq[0]['p']}; the ranks' parameters, buffers and banks "
            "torch.equal (sha256)")
        f64 = [r[key + " f64"] for r in ranks]
        log("sp", f"({key}) float64, batch {SP_SEG_F64_BATCH}, dense losses: "
            f"the {f64[0]['pixels']} pixels' k-means segments and the bank "
            f"labels equal one process's; losses, {f64[0]['n_grads']} "
            f"gradients (each element over its max) and the bank prototypes "
            f"within {SP_F64_RTOL} + the floor (images reversed, largest "
            f"{o['f64_floor']:.3e}); worst " + " | ".join(
                f"rank {r}: {w[0]} {w[1]:.3e} (floor {w[2]:.3e})"
                for r, w in enumerate(f["worst"] for f in f64)))
        st = [r[key + " timing"] for r in ranks]
        ms = max(t["ms"] for t in st)
        b = s["global"]
        kinds = SP_TIMED_KINDS[key + "_bf16"]
        coll = {k: max(t["collectives"][k][0] for t in st) for k in kinds}
        counts = {k: st[0]["collectives"][k][1] for k in kinds}
        log("sp", f"({key}) bf16 as it ships, crop {SP3_CROP}, global batch "
            f"{b}, 3 + 10 steps: {ms:.2f} ms/step (ranks "
            + " / ".join(f"{t['ms']:.2f}" for t in st)
            + f"), {b * 1000 / ms:.2f} images/s, peak "
            + " / ".join(f"{t['peak']:.2f}" for t in st)
            + f" GiB a rank against one process's {o['time']['peak']:.2f} "
            f"GiB ({o['time']['ms']:.2f} ms/step); collectives a step "
            "(slowest rank, ms, count): "
            + ", ".join(f"{k} {coll[k]:.2f} ({counts[k]})" for k in kinds)
            + "; launches a rank " + " / ".join(str(t["launches"])
                                                 for t in st)
            + f"; {case}")


def log_sp3_empty(spec, ranks, one):
    """Lines (n): each crop and recipe, and (n)'s seconds."""
    what = {"joint": f"the flagship SegSort step at batch {SP_SEG_BATCH}",
            "hard": f"the DensePose point step at batch {SP_DP_BATCH}"}
    for key, (base, crop) in SP3_EMPTY_KEYS.items():
        family = SP3_KEYS[base][0]
        s, o = spec[key], one[key]
        eq = [r[key + " f32"] for r in ranks]
        f64 = [r[key + " f64"] for r in ranks]
        maps = "; ".join(
            f"stride {st}: {rows} rows as " + "/".join(
                str(len(p)) for p in halo_partition(rows, SP3_SPACE))
            for st, rows in ((8, grid_rows(crop) // 2),
                             (4, grid_rows(crop))))
        log("sp", f"(n) crop {crop} x {SP3_CROP} over {SP3_SPACE} space "
            f"ranks ({maps}; {grid_rows(SP3_CROP)} grid columns), "
            f"{what[family]} as ({base}): float32 on the one process's "
            f"segments against one process, [dp] (a)'s tolerances over "
            f"{len(s['checked'])} checked tensors, each plus the floor of "
            f"{', '.join(SP_SEG_FLOOR_RUNS)}. "
            + dp_mode_words("equal", eq, o["f32"], sum(s["n"]))
            + " The losses and the update L2 at tolerance + floor (the "
            "floor runs' largest, "
            + ", ".join(f"{k} {v:.3e}" for k, v in sorted(
                o["floor"]["losses"].items())) + f", L2 {o['floor']['l2']:.3e}"
            + "): shares a rank " + " / ".join(
                f"{e['shares']['losses']:.3f}, {e['shares']['update L2']:.3f}"
                for e in eq)
            + "".join(f"; {k} printed, not held (SP3_UNHELD): shares "
                      + " / ".join(f"{e['unheld'][k]:.3f}" for e in eq)
                      for k in s["unheld"])
            + f". Losses {eq[0]['losses']}; launches a rank "
            + " / ".join(str(e["launches"]) for e in eq)
            + " at N " + " / ".join(str(e["n"]) for e in eq)
            + f", P {eq[0]['p']}; the ranks' parameters, buffers and banks "
            f"torch.equal. float64, batch {SP_SEG_F64_BATCH}, dense losses: "
            f"the {f64[0]['pixels']} pixels' segments and the bank labels "
            f"equal one process's; losses, {f64[0]['n_grads']} gradients "
            f"and the bank within {SP_F64_RTOL} + the floor (images "
            f"reversed, largest {o['f64_floor']:.3e}); worst " + " | ".join(
                f"rank {r}: {w[0]} {w[1]:.3e} (floor {w[2]:.3e})"
                for r, w in enumerate(f["worst"] for f in f64)))
        log("sp", f"(n) crop {crop} x {SP3_CROP} ({base}): the float32 "
            "step, the first "
            "at its shapes (host clock, synchronized), "
            + " / ".join(f"{e['ms']:.2f}" for e in eq)
            + " ms a rank, peak " + " / ".join(f"{e['peak']:.2f}"
                                                 for e in eq) + " GiB")
    log("sp", "(n) seconds a rank (the ranks' own steps, after (l) and "
        "(m)): " + " / ".join(f"{r['n_seconds']:.1f}" for r in ranks))


def run_sp3(torch, devices=None, backend=None, device=None):
    """(l), (m), (n) of the [sp] phase: SP3_SPACE ranks of one data rank
    spawned once, each running sp3_rank; this process computes the
    one-process references, their floors and timings first. devices,
    backend, device: the CPU rehearsal's (cpu ranks, gloo, cpu)."""
    import tempfile

    from spml_tpu_torch.ops import _cuda
    from spml_tpu_torch.ops import segsort_loss as fused
    from spml_tpu_torch.parallel import mesh as mesh_lib

    if devices is None:
        devices, backend, case = sp3_devices(torch)
    else:
        case = f"{backend} on {devices}"
    device = torch.device(device or DEVICE)
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="spml_sp3_") as root:
        spec = {**sp3_spec(root), "csrc": str(_cuda.CSRC)}
        log("sp", f"(l), (m): {len(devices)} ranks (data 1 x space "
            f"{SP3_SPACE}) at crop {SP3_CROP} on {devices}: {case}")
        t_ref = time.perf_counter()
        one = sp3_reference(torch, fused, spec, device)
        t_ref = time.perf_counter() - t_ref
        t0 = time.perf_counter()
        ranks = mesh_lib.spawn(sp3_rank, (spec,), devices, backend)
        spawn_s = time.perf_counter() - t0
        log_sp3(spec, ranks, one, case)
        log_sp3_empty(spec, ranks, one)
        check_sp3(spec, ranks)
    log("sp", f"(l), (m), (n) summary, {case}: one-process references "
        f"{t_ref:.1f} s ((n)'s {one['n_seconds']:.1f} s), spawn to join "
        f"{spawn_s:.1f} s, phase {time.perf_counter() - t_phase:.1f} s; "
        f"card {nvidia_smi_line()}")


# ---------------------------------------------------------------------------
# Timings at the main paths' inputs
# ---------------------------------------------------------------------------

def bounds(family, n, p, nv, d, rows=None, bf16=False):
    """{kind: (bound_ms, bound_by, float32 bound ms)} of a family from this
    run's shapes: bytes each input read once and each output written once
    (prototype rows up to the valid count), operations per live (pixel,
    prototype) pair at the float32 peak; for the kernels whose products
    run on the tensor cores in split TF32 (TENSOR_CORE), the product flops
    a pair (2 D for the stats, 4 D for dE and dP) three times at the TF32
    peak plus the rest at the float32 peak. bf16: the bf16-operand forms,
    E and P 2 bytes an element and the product flops once at the bf16
    tensor-core peak (the outputs float32 as ever). rows: the pixels whose
    pairs the gradients need, those with a nonzero cotangent (all N by
    default); the gradients' pairs and pixel operands count only these,
    their cotangents and outputs in full."""
    rows = n if rows is None else rows
    ns = N_STATS[family]
    eb = 2 if bf16 else 4  # bytes of an element of E and P
    if family == "joint":  # rows carry label, own / tag, valid
        pix_row, proto_row = d * eb + 3 * 4, d * eb + 3 * 4
        ops_stats, ops_grad = 2 * d + 10, 4 * d + 14  # 2 exps, 6 sums
    elif family == "set":  # rows carry tag bitword, own / bitword, valid
        pix_row, proto_row = d * eb + 8, d * eb + 8
        ops_stats, ops_grad = 2 * d + 7, 4 * d + 9  # 1 exp, 3 sums, 1 AND
    else:  # rows carry label, own / label
        pix_row, proto_row = d * eb + 8, d * eb + 4
        ops_stats, ops_grad = 2 * d + 6, 4 * d + 8
    protos_in, grads_in = nv * proto_row, ns * n * 4
    work = {  # bytes, operations a pair, product flops a pair, pairs
        "stats": (n * pix_row + protos_in + ns * n * 4, ops_stats, 2 * d,
                  n * nv),
        "grad_emb": (rows * pix_row + grads_in + protos_in + n * d * 4,
                     ops_grad, 4 * d, rows * nv),
        "grad_proto": (rows * pix_row + grads_in + protos_in + p * d * 4,
                       ops_grad, 4 * d, rows * nv),
    }
    out = {}
    for kind, (nbytes, ops, prod, pairs) in work.items():
        t_bytes = nbytes / PEAK_BYTES * 1e3
        t_f32 = pairs * ops / PEAK_F32_FLOPS * 1e3
        t_ops = t_f32
        if bf16:
            t_ops = pairs * (prod / PEAK_BF16_FLOPS
                             + (ops - prod) / PEAK_F32_FLOPS) * 1e3
        elif f"{family}_{kind}" in TENSOR_CORE:
            t_ops = pairs * (3 * prod / PEAK_TF32_FLOPS
                             + (ops - prod) / PEAK_F32_FLOPS) * 1e3
        out[kind] = ((t_ops, "operations") if t_ops >= t_bytes
                     else (t_bytes, "bytes")) + (max(t_f32, t_bytes),)
    return out


def time_kernels(torch, fused, family, args, path_grads,
                 operand_dtype="float32"):
    """Each kernel of a family at a main path's last inputs (CUDA events,
    20 launches) beside the plain version (3 runs over row chunks) and
    its bound, dE and dP on randn cotangents and again on path_grads, the
    cotangents the path's last backward handed them (its bound counting
    only the rows that carry one); operand_dtype "bfloat16": the bf16
    forms and the bf16 plain version. Returns {counter: (ms, plain ms,
    (bound ms, by, float32 bound ms), (path ms, path bound, rows) or
    None)}."""
    from spml_tpu_torch.tools.dilated_conv_probe import cuda_ms

    ns, nk = N_STATS[family], N_KAPPAS[family]
    tensors, kappas = args[:-nk], tuple(args[-nk:])
    scalars = kappas  # as the C functions take them
    if family == "joint":
        scalars = (*kappas, int(kappas[1] == 2.0 * kappas[0]))
    f32, i32 = torch.float32, torch.int32
    operand, suffix = fused.OPERAND_DTYPES[operand_dtype]
    at = fused._FAMILIES[family][1]  # the prototypes among the inputs
    inputs = tuple(fused._kernel_operand(t, operand if i in (0, at) else i32)
                   for i, t in enumerate(tensors))
    emb, protos = inputs[0], inputs[at]
    n, d = emb.shape
    p = protos.shape[0]
    nv = int(inputs[-1])
    grads = torch.randn(ns, n, device=DEVICE)
    path_grads = fused._kernel_operand(path_grads, f32)
    carrying = int((path_grads != 0).any(0).sum())

    def grad_ms(kind, g):
        launch = getattr(fused, f"_launch_{kind}")
        return cuda_ms(lambda: launch(family, inputs, scalars, g, suffix),
                       20)

    kernel_ms = {
        "stats": cuda_ms(
            lambda: fused._launch_stats(family, inputs, scalars, suffix),
            20),
        "grad_emb": grad_ms("grad_emb", grads),
        "grad_proto": grad_ms("grad_proto", grads),
    }
    path_ms = {kind: grad_ms(kind, path_grads)
               for kind in ("grad_emb", "grad_proto")}

    rows = 32768  # the plain version over row chunks (it is [N, P] dense)
    plain_fn = stats_fns(fused, family)[1]

    def plain(kind):
        for r0 in range(0, n, rows):
            sl = slice(r0, min(r0 + rows, n))
            e = emb[sl].detach().float().requires_grad_(kind == "grad_emb")
            pr = protos.detach().float().requires_grad_(kind == "grad_proto")
            pix = [t[sl] for t in inputs[1:at]]
            s = plain_fn(e, *pix, pr, *inputs[at + 1:], *kappas,
                         operand_dtype=operand_dtype)
            if kind != "stats":
                torch.autograd.grad((s * grads[:, sl]).sum(),
                                    e if kind == "grad_emb" else pr)

    plain_ms = {kind: cuda_ms(lambda: plain(kind), 3)
                for kind in KINDS}
    bnd = bounds(family, n, p, nv, d, bf16=bool(suffix))
    path_bnd = bounds(family, n, p, nv, d, carrying, bf16=bool(suffix))
    out = {}
    for kind in KINDS:
        key = f"{family}_{kind}{suffix}"
        path = None
        if kind in path_ms:
            path = (path_ms[kind], path_bnd[kind], carrying)
        out[key] = (kernel_ms[kind], plain_ms[kind], bnd[kind], path)
        log("timing", f"{KERNELS[key][0]}: N={n} P={p} valid={nv} D={d} "
            f"kernel {kernel_ms[kind]:.4f} ms, plain {plain_ms[kind]:.3f} "
            f"ms, bound {bnd[kind][0]:.4f} ms ({bnd[kind][1]}; float32 "
            f"{bnd[kind][2]:.4f} ms)" + ("" if path is None else
            f"; on the path's cotangents ({carrying} rows carry one) kernel "
            f"{path[0]:.4f} ms, bound {path[1][0]:.4f} ms ({path[1][1]}; "
            f"float32 {path[1][2]:.4f} ms)"))
    return out


# ---------------------------------------------------------------------------
# The dilated conv K10
# ---------------------------------------------------------------------------

def check_dilated_conv(torch, dc):
    """K10 against its plain version in float64 on the same bf16 values;
    returns the largest absolute error at the probe's shapes."""
    from spml_tpu_torch.tools.dilated_conv_probe import SHAPES

    gen = torch.Generator(DEVICE).manual_seed(0)
    cases = [("ragged d1", 2, 9, 7, 16, 32, 1),
             ("ragged d2 C 48 O 16", 3, 13, 20, 48, 16, 2),
             ("ragged d4 B 1 O 144", 1, 6, 33, 32, 144, 4),
             ("taps outside but the centre", 1, 3, 3, 16, 16, 4),
             ("two chunks, two N tiles", 1, 10, 17, 80, 272, 3),
             ("B 1 C 48 O 400", 1, 17, 23, 48, 400, 2)]
    probe_err = 0.0
    for label, b, h, w, c, o, d in cases + SHAPES:
        x = torch.randn(b, h, w, c, device=DEVICE, generator=gen).bfloat16()
        wt = (0.05 * torch.randn(3, 3, c, o, device=DEVICE,
                                 generator=gen)).bfloat16()
        got = dc.dilated_conv3x3(x, wt, d)
        torch.cuda.synchronize()
        ref = dc.dilated_conv3x3_reference(x.double(), wt.double(), d)
        if got.dtype != torch.bfloat16 or not torch.isfinite(got).all():
            raise AssertionError(f"dilated conv {label}: bad output")
        abs_tol = CONV_ATOL_REL * float(ref.abs().max())
        torch.testing.assert_close(got.double(), ref, rtol=CONV_RTOL,
                                   atol=abs_tol,
                                   msg=lambda m: f"dilated conv {label}: {m}")
        err = (got.double() - ref).abs()
        margin = float((err / (abs_tol + CONV_RTOL * ref.abs())).max())
        if (label, b, h, w, c, o, d) in SHAPES:
            probe_err = max(probe_err, float(err.max()))
        log("kernels", f"dilated conv {label}: x [{b}, {h}, {w}, {c}] -> "
            f"{o}, d={d} max_abs_err {float(err.max()):.3e} | tolerance "
            f"used {margin:.3f} ok")
    return probe_err


def run_probe_path(torch, dc):
    """The dilated-conv probe's entry point at its two shapes; returns the
    launch count of that run."""
    from spml_tpu_torch.tools import dilated_conv_probe

    dc.reset_launch_counts()
    dilated_conv_probe.main()
    launches = dc.LAUNCHES["dilated_conv3x3"]
    # per shape: the error check, the warm-up call, ITERS timed calls
    want = len(dilated_conv_probe.SHAPES) * (2 + dilated_conv_probe.ITERS)
    if launches != want:
        raise AssertionError(f"probe: dilated_conv3x3 launched {launches} "
                             f"times, want {want}")
    return launches


def time_dilated_conv(torch, dc):
    """K10 at the probe's first shape (res4 d2) beside its plain version,
    cuDNN and its bound; returns (ms, plain ms, library ms, (bound ms,
    by))."""
    from spml_tpu_torch.tools.dilated_conv_probe import (
        SHAPES, cuda_ms, cudnn_conv, cudnn_weight)

    label, b, h, w, c, o, d = SHAPES[0]
    gen = torch.Generator(DEVICE).manual_seed(1)
    x = torch.randn(b, h, w, c, device=DEVICE, generator=gen).bfloat16()
    wt = (0.05 * torch.randn(3, 3, c, o, device=DEVICE,
                             generator=gen)).bfloat16()
    w_oihw = cudnn_weight(wt)
    ms = cuda_ms(lambda: dc.dilated_conv3x3(x, wt, d), 20)
    plain_ms = cuda_ms(lambda: dc.dilated_conv3x3_reference(x, wt, d), 5)
    library_ms = cuda_ms(lambda: cudnn_conv(x, w_oihw, d), 20)
    t_ops = 2 * b * h * w * c * o * 9 / PEAK_BF16_FLOPS * 1e3
    t_bytes = 2 * (b * h * w * (c + o) + 9 * c * o) / PEAK_BYTES * 1e3
    bound = (t_ops, "operations") if t_ops >= t_bytes else (t_bytes,
                                                             "bytes")
    log("timing", f"dilated_conv3x3_bf16 ({label}): kernel {ms:.4f} ms, "
        f"plain {plain_ms:.3f} ms, cuDNN {library_ms:.4f} ms, bound "
        f"{bound[0]:.4f} ms ({bound[1]})")
    return ms, plain_ms, library_ms, bound


# ---------------------------------------------------------------------------
# KNN top-k (csrc/knn_topk.cu): no Pallas counterpart
# ---------------------------------------------------------------------------

KNN_KERNEL = ("knn_topk_partial + knn_topk_merge",
              "none (no Pallas counterpart; ops/knn.py)",
              "spml_tpu_torch/csrc/knn_topk.cu")
KNN_QUERIES, KNN_DIM, KNN_TOP_K = 144, 64, 20  # 12 x 12 segments, top 20
KNN_ROWS_EQUAL = 0.995  # least share of rows whose 20 labels equal the sort's


def run_knn_topk(torch):
    """The two KNN kernels alone at VOC's inference shape (KNN_QUERIES unit
    queries against BANK_SIZE unit prototypes, D 64, top 20; labels the
    bank indices): rows equal to the plain version's (the [N, P] scores and
    a stable sort, on the card), each differing row's first difference a
    near-tie in float64 (gap < TIE_GAP); then CUDA events over 20 calls of
    the kernels, of the plain version and of the library's own top-k (the
    masked scores and torch.topk, whose tie order is unspecified). The
    bound as the SegSort kernels': the products three times at the TF32
    rate (split TF32, the form the card's tensor cores offer float32 at),
    a compare a pair at the float32 rate, or the bytes if more; the
    float32 bound beside it. Returns the kernel table row, its launches
    left to the inference phase, which counts them on the main path."""
    from spml_tpu_torch.ops import knn
    from spml_tpu_torch.tools.dilated_conv_probe import cuda_ms

    gen = torch.Generator(DEVICE).manual_seed(3)
    bank = torch.randn(BANK_SIZE, KNN_DIM, device=DEVICE, generator=gen)
    bank /= bank.norm(dim=1, keepdim=True)
    queries = torch.randn(KNN_QUERIES, KNN_DIM, device=DEVICE, generator=gen)
    queries /= queries.norm(dim=1, keepdim=True)
    index = torch.arange(BANK_SIZE, device=DEVICE)
    mask = torch.ones(BANK_SIZE, dtype=torch.bool, device=DEVICE)
    args = (queries, bank, index, KNN_TOP_K, mask)
    knn.reset_launch_counts()
    got = knn.top_k_labels(*args)
    want = knn.top_k_labels_reference(*args)
    torch.cuda.synchronize()
    if knn.LAUNCHES != {"knn_topk_partial": 1, "knn_topk_merge": 1}:
        raise AssertionError(f"knn: launches {knn.LAUNCHES}")
    equal = (got == want).all(dim=1)
    aff = queries.double() @ bank.double().T
    for r in torch.nonzero(~equal).flatten().tolist():
        j = int(torch.nonzero(got[r] != want[r])[0])
        gap = abs(float(aff[r, got[r, j]] - aff[r, want[r, j]]))
        if gap >= TIE_GAP:
            raise AssertionError(f"knn: row {r} rank {j}: {got[r].tolist()} "
                                 f"against the sort's {want[r].tolist()}, "
                                 f"float64 gap {gap:.3e}")
    share = float(equal.float().mean())
    if share < KNN_ROWS_EQUAL:
        raise AssertionError(f"knn: {share:.4f} of rows equal the sort's")
    del aff
    ms = cuda_ms(lambda: knn.top_k_labels(*args), 20)
    plain_ms = cuda_ms(lambda: knn.top_k_labels_reference(*args), 20)
    library_ms = cuda_ms(lambda: torch.topk(torch.where(
        mask, queries @ bank.T, knn.NEG_INF), KNN_TOP_K, dim=1)[1], 20)
    pairs = KNN_QUERIES * BANK_SIZE
    flops = 2 * KNN_DIM * pairs
    nbytes = (4 * (BANK_SIZE + KNN_QUERIES) * KNN_DIM + BANK_SIZE
              + 8 * KNN_QUERIES * KNN_TOP_K)
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_f32 = (flops + pairs) / PEAK_F32_FLOPS * 1e3
    t_ops = (3 * flops / PEAK_TF32_FLOPS + pairs / PEAK_F32_FLOPS) * 1e3
    bound = (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
    log("knn", f"top {KNN_TOP_K} of {BANK_SIZE} x {KNN_DIM} for "
        f"{KNN_QUERIES} queries: {share:.4f} of rows equal the sort's, the "
        f"rest near-ties; kernels {ms:.4f} ms ({flops / ms / 1e9:.1f} "
        f"TFLOP/s float32), plain (scores + stable sort) {plain_ms:.3f} ms, "
        f"library (scores + torch.topk) {library_ms:.3f} ms, bound "
        f"{bound[0]:.4f} ms ({bound[1]}; float32 {max(t_f32, t_bytes):.4f}); "
        f"card {nvidia_smi_line()}")
    name, replaces, source = KNN_KERNEL
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": None, "rows_equal": share,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0],
            "bound_by": bound[1], "bound_f32_ms": max(t_f32, t_bytes),
            "library_ms": library_ms}


# ---------------------------------------------------------------------------
# Inference: the single-scale KNN path at VOC's test geometry
# ---------------------------------------------------------------------------

BANK_SIZE = 1523808  # VOC train_aug: 10582 images x at most 144 clusters
COPIES = 20  # each built prototype's copies in the bank
# f64-vs-f32 near-tie gap of a 64-term dot of unit vectors: float32
# rounding stays below 64 * 2^-24 = 3.8e-6
TIE_GAP = 1e-5
# the card's float32 stitched map against the CPU's (cuDNN vs oneDNN
# through ResNet-101, TF32 off)
STITCH_RTOL, STITCH_ATOL_REL = 1e-4, 1e-5
INFERENCE = {  # bashscripts/voc12/train_spml_scribble.sh:50-52, 82-100
    "network": {"backbone_types": "panoptic_deeplab_101",
                "embedding_dim": 64, "kmeans_num_clusters": [12, 12],
                "kmeans_iterations": 10},
    "dataset": {"num_classes": 21},
    "test": {"image_size": 512, "crop_size": [512, 512],
             "stride": [512, 512]},
    "tpu": {"compute_dtype": "bfloat16"},
}


def inference_images(cfg, n, seed):
    """n normalized images with blobby labels, 512 x 384 and 384 x 512 in
    turn (VOC's shapes after the 512 resize)."""
    from spml_tpu_torch.train.flagship import blobby_batch

    batch = blobby_batch(n, 512, cfg.dataset.num_classes, seed=seed,
                         device="cpu")
    mean = np.asarray(cfg.network.pixel_means, np.float32)
    std = np.asarray(cfg.network.pixel_stds, np.float32)
    out = []
    for i in range(n):
        h, w = (512, 384) if i % 2 == 0 else (384, 512)
        img = batch["image"][i, :h, :w].numpy()
        out.append((((img - mean) / std).astype(np.float32),
                    batch["semantic_label"][i, :h, :w].numpy()))
    return out


def make_bank(torch, built, num_classes):
    """The bank: each built prototype COPIES times (row r at r + k *
    len(built)), then random unit vectors with labels 0..C-1 (seed 0) up
    to BANK_SIZE. Returns (prototypes, labels, valid, built row of each
    bank row or -1)."""
    protos, labels = built
    nb = protos.shape[0]
    rest = BANK_SIZE - COPIES * nb
    gen = torch.Generator(DEVICE).manual_seed(0)
    rand = torch.randn(rest, protos.shape[1], device=DEVICE, generator=gen)
    rand = rand / rand.norm(dim=1, keepdim=True)
    bank_p = torch.cat([protos.repeat(COPIES, 1), rand])
    bank_l = torch.cat([labels.repeat(COPIES),
                        torch.randint(0, num_classes, (rest,), device=DEVICE,
                                      generator=gen, dtype=labels.dtype)])
    owner = torch.cat([torch.arange(nb, device=DEVICE).repeat(COPIES),
                       torch.full((rest,), -1, device=DEVICE)])
    return (bank_p, bank_l, torch.ones(BANK_SIZE, dtype=torch.bool,
                                       device=DEVICE), owner)


def check_self_retrieval(torch, eng, images, builds, offsets, bank, owner):
    """(a) predictions in [0, C); (b) each image's prediction equals its
    own clusters' majority labels, but on clusters whose self-affinity in
    float64 lies within TIE_GAP of a prototype not its copy (a near-tie
    the float32 top 20 may break either way). Returns (mismatched pixels,
    near-tie clusters)."""
    c = eng.config.dataset.num_classes
    bank64 = bank[0].double()
    mismatched, near = 0, 0
    for (image, _), (protos, labels, valid, clusters), off in zip(
            images, builds, offsets):
        pred = eng.predict_semantic(image, *bank)
        if pred.min() < 0 or pred.max() >= c:
            raise AssertionError(f"inference: prediction outside [0, {c})")
        want = labels[clusters]
        bad = np.unique(clusters[pred != want])
        rows = np.cumsum(valid) - 1 + off  # built row of each valid cluster
        for k in np.flatnonzero(valid):
            p = torch.as_tensor(protos[k], device=DEVICE).double()
            aff = bank64 @ p
            own = owner == int(rows[k])
            tie = float(aff[~own].max()) >= float(aff[own].min()) - TIE_GAP
            near += tie
            if k in bad and not tie:
                raise AssertionError(
                    f"inference: cluster {k} predicted "
                    f"{np.unique(pred[clusters == k])}, its majority label "
                    f"is {labels[k]}, and no prototype ties its own")
        mismatched += int((pred != want).sum())
    return mismatched, near


def check_topk(torch, eng, image, bank):
    """(c) one image not in the bank: each valid segment's top-20 labels
    against a float64 recomputation of its affinities on the card, equal
    as multisets but where the 20th and 21st float64 affinities lie within
    TIE_GAP; and the stages composed equal predict_semantic. Returns
    (segments checked, segments excused)."""
    h, w = image.shape[:2]
    img = eng.upload_image(image)
    seg_ids, protos, seg_valid = eng.segment(eng.stitch(img), (h, w))
    topk = eng.retrieve(protos, seg_valid, bank)
    staged = eng.vote(topk, seg_ids, tuple(img.shape[:2]))[:h, :w]
    if not np.array_equal(staged.cpu().numpy(),
                          eng.predict_semantic(image, *bank)):
        raise AssertionError("inference: the stages differ from "
                             "predict_semantic")
    aff = protos.double() @ bank[0].double().T
    vals, idx = torch.sort(aff, dim=1, descending=True, stable=True)
    want = bank[1][idx[:, :20]]
    checked = excused = 0
    for k in torch.nonzero(seg_valid).flatten().tolist():
        checked += 1
        if torch.equal(torch.sort(topk[k])[0], torch.sort(want[k])[0]):
            continue
        if float(vals[k, 19] - vals[k, 20]) >= TIE_GAP:
            raise AssertionError(f"inference: segment {k} top-20 labels "
                                 f"{topk[k].tolist()}, float64 "
                                 f"{want[k].tolist()}")
        excused += 1
    return checked, excused


def check_card_against_cpu(torch):
    """The device path against the CPU path, float32, crop 128, stride 64,
    a 192 x 160 image (2 x 2 windows): stitched map within STITCH_RTOL,
    cluster maps, prototype labels and predictions equal. Returns the
    stitched map's largest absolute error."""
    import copy

    from spml_tpu_torch.config import load_config
    from spml_tpu_torch.inference import engine
    from spml_tpu_torch.models.embeddings import build_embedding_model

    over = dict(INFERENCE, test={"image_size": 0, "crop_size": [128, 128],
                                 "stride": [64, 64]},
                tpu={"compute_dtype": "float32"})
    cfg = load_config(overrides=over)
    model = build_embedding_model("panoptic_deeplab_101", 64)
    engines = {dev: engine.InferenceEngine(cfg, copy.deepcopy(model), dev)
               for dev in ("cpu", DEVICE)}
    image, label = inference_images(cfg, 1, seed=2)[0]
    image, label = image[:192, :160], label[:192, :160]
    if engines["cpu"].windows(*engines["cpu"].bucket_shape(192, 160)) != [
            (0, 0), (0, 64), (64, 0), (64, 64)]:
        raise AssertionError("inference: the CPU check is not 2 x 2 windows")
    rng = np.random.RandomState(1)
    bank_p = rng.randn(2000, 64).astype(np.float32)
    bank_p /= np.linalg.norm(bank_p, axis=1, keepdims=True)
    bank = (bank_p, rng.randint(0, 21, 2000), np.ones(2000, bool))
    out = {dev: (eng.stitched_embeddings(image).cpu(),
                 eng.build_prototypes(image, label, return_clusters=True),
                 eng.predict_semantic(image, *bank))
           for dev, eng in engines.items()}
    (want, wbuild, wpred), (got, gbuild, gpred) = out["cpu"], out[DEVICE]
    atol = STITCH_ATOL_REL * float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=STITCH_RTOL, atol=atol,
                               msg=lambda m: f"inference stitch: {m}")
    for name, g, w in (("clusters", gbuild[3], wbuild[3]),
                       ("labels", gbuild[1], wbuild[1]),
                       ("valid", gbuild[2], wbuild[2]),
                       ("prediction", gpred, wpred)):
        if not np.array_equal(g, w):
            raise AssertionError(f"inference: card and CPU {name} differ in "
                                 f"{int((g != w).sum())} places")
    return float((got - want).abs().max())


def time_inference(torch, eng, images, bank):
    """CUDA events around 10 images after 3 warm-up images: (build ms,
    predict ms, host ms of predict, {stage: ms}, peak bytes of predict,
    KNN kernel launches of predict's 13 images, each counter once an
    image)."""
    from spml_tpu_torch.ops import knn

    order = [images[i % len(images)] for i in range(13)]

    def timed(fn):
        for image, label in order[:3]:
            fn(image, label)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for image, label in order[3:]:
            fn(image, label)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / 10, (time.perf_counter() - t0) * 100

    build_ms, _ = timed(lambda im, lab: eng.build_prototypes(im, lab))
    torch.cuda.reset_peak_memory_stats()
    knn.reset_launch_counts()
    predict_ms, host_ms = timed(lambda im, lab: eng.predict_semantic(
        im, *bank))
    peak = torch.cuda.max_memory_allocated()
    if knn.LAUNCHES != dict.fromkeys(knn.LAUNCHES, len(order)):
        raise AssertionError(f"inference: KNN launches {knn.LAUNCHES} in "
                             f"{len(order)} images, want one each an image")
    knn_launches = sum(knn.LAUNCHES.values())

    stages = ("upload", "forward", "stitch", "kmeans", "knn", "vote")
    totals = dict.fromkeys(stages, 0.0)
    for n, (image, _) in enumerate(order):
        h, w = image.shape[:2]
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(7)]
        ev[0].record()
        img = eng.upload_image(image)
        ev[1].record()
        emb = eng.embed_windows(img)
        ev[2].record()
        emb_map = eng.overlap_average(emb, *img.shape[:2])
        ev[3].record()
        seg_ids, protos, seg_valid = eng.segment(emb_map, (h, w))
        ev[4].record()
        topk = eng.retrieve(protos, seg_valid, bank)
        ev[5].record()
        eng.vote(topk, seg_ids, tuple(img.shape[:2]))[:h, :w].cpu()
        ev[6].record()
        torch.cuda.synchronize()
        if n >= 3:
            for i, st in enumerate(stages):
                totals[st] += ev[i].elapsed_time(ev[i + 1]) / 10
    return build_ms, predict_ms, host_ms, totals, peak, knn_launches


def run_inference(torch):
    """The single-scale KNN path at VOC's test geometry: the flagship
    network from random weights of seed 0 (eval mode, bf16 convs), 12 x 12
    k-means x 10, 21 classes, top 20, crop = stride = 512; memory bank
    entries from 8 images, a bank of BANK_SIZE, prediction of the same 8,
    the checks and the timings. Returns the KNN kernels' launches in the
    timed predict_semantic run."""
    import tempfile

    from spml_tpu_torch import cli
    from spml_tpu_torch.config import load_config
    from spml_tpu_torch.inference import engine

    t0 = time.perf_counter()
    cfg = load_config(overrides=INFERENCE)
    with tempfile.TemporaryDirectory() as snapshot:  # none: seed 0 weights
        eng = engine.InferenceEngine(
            cfg, cli.build_eval_models(cfg, snapshot, DEVICE), DEVICE)
    images = inference_images(cfg, 8, seed=0)
    builds, offsets, parts = [], [], ([], [])
    for image, label in images:
        protos, labels, valid, clusters = eng.build_prototypes(
            image, label, return_clusters=True)
        builds.append((protos, labels, valid, clusters))
        offsets.append(sum(len(p) for p in parts[0]))
        parts[0].append(protos[valid])
        parts[1].append(labels[valid])
    built = (torch.as_tensor(np.concatenate(parts[0]), device=DEVICE),
             torch.as_tensor(np.concatenate(parts[1]), device=DEVICE))
    *bank, owner = make_bank(torch, built, cfg.dataset.num_classes)
    log("inference", f"model and 8 memory-bank entries in "
        f"{time.perf_counter() - t0:.1f} s: {built[0].shape[0]} valid "
        f"prototypes of {8 * 144}, bank {bank[0].shape[0]} x "
        f"{bank[0].shape[1]} float32 ({COPIES} copies each, the rest random "
        "unit vectors)")
    mismatched, near = check_self_retrieval(torch, eng, images, builds,
                                            offsets, bank, owner)
    fresh = inference_images(cfg, 1, seed=1)[0][0]
    checked, excused = check_topk(torch, eng, fresh, bank)
    stitch_err = check_card_against_cpu(torch)
    log("inference", f"checks ok: (a) predictions in [0, 21); (b) "
        f"self-retrieval {mismatched} pixels off their clusters' majority "
        f"labels, {near} near-tie clusters (gap {TIE_GAP}); (c) top-20 "
        f"labels of {checked} segments equal float64's, {excused} excused "
        f"as near-ties; card vs CPU float32 (crop 128, stride 64, 192 x "
        f"160, 2 x 2 windows) stitched max_abs_err {stitch_err:.3e} "
        f"(rtol {STITCH_RTOL}), clusters, labels and predictions equal")
    build_ms, predict_ms, host_ms, stages, peak, knn_launches = \
        time_inference(torch, eng, images, bank)
    log("inference", f"VOC test geometry (panoptic_deeplab_101 bf16, 512 x "
        f"384 / 384 x 512 in a 512 x 512 bucket, 12 x 12 k-means x 10, top "
        f"20 of {BANK_SIZE}): build_prototypes {build_ms:.2f} ms/image; "
        f"predict_semantic {predict_ms:.2f} ms/image (host clock "
        f"{host_ms:.2f}), {1000 / predict_ms:.2f} images/s; split "
        + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
        + f" ms; peak memory {peak / 2**30:.2f} GiB; KNN kernel launches "
        f"{knn_launches} in 13 images; card "
        f"{nvidia_smi_line()}")
    differ, moved, worst = check_batched(torch, eng, images, bank)
    f32_exact = check_batched_float32(torch, images, bank)
    batch_ms, batch_peak = time_batched(torch, eng, images, bank)
    pixels = sum(im.shape[0] * im.shape[1] for im, _ in images)
    log("inference", f"batched (tpu.infer_batch {INFER_BATCH}, "
        f"predict_semantic_batch, one window forward a group of "
        f"{INFER_BATCH}): (d) bf16: each prediction equal to the stages run "
        f"on its group's stitched map, which lies within {worst:.3e} of the "
        f"image's own (atol {BF16_STITCH_ATOL}); {differ} of {pixels} "
        f"pixels differ from predict_semantic's, {moved} pixels in other "
        f"clusters; float32 (TF32 off): predictions equal to "
        f"predict_semantic's ({f32_exact} of {len(images)} stitched maps "
        f"bit-equal); {batch_ms:.2f} ms/image ({1000 / batch_ms:.2f} "
        f"images/s), peak {batch_peak / 2**30:.2f} GiB, against per image "
        f"{predict_ms:.2f} ms/image, peak {peak / 2**30:.2f} GiB; card "
        f"{nvidia_smi_line()}")
    return knn_launches


INFER_BATCH = 4  # images a group of the batched prediction
# a group's bf16 window forward against the image's own: at batch 4
# cuDNN may pick other algorithms, so the embeddings round otherwise in
# bf16; two roundings of 2^-7 each of a unit-scale embedding component
BF16_STITCH_ATOL = 2.0 ** -6


def groups_of(images):
    return [[im for im, _ in images[g:g + INFER_BATCH]]
            for g in range(0, len(images), INFER_BATCH)]


def check_batched(torch, eng, images, bank):
    """(d) in bf16, predict_semantic_batch over groups of INFER_BATCH (all 8
    images share the 512 x 512 bucket): each prediction equal to the
    stages (segment, retrieve, vote) run on its group's stitched map,
    and that map within BF16_STITCH_ATOL of the image's own. Returns
    (pixels whose prediction differs from predict_semantic's, pixels in
    other clusters than the image's own map gives, the largest stitched
    difference)."""
    differ = moved = 0
    worst = 0.0
    for group in groups_of(images):
        preds = eng.predict_semantic_batch(group, *bank)
        together = eng.stitch(torch.stack([eng.upload_image(im)
                                           for im in group]))
        memory = eng.memory(*bank)
        for pred, image, emb in zip(preds, group, together):
            h, w = image.shape[:2]
            pad = tuple(emb.shape[:2])
            alone = eng.stitch(eng.upload_image(image))
            worst = max(worst, float((alone - emb).abs().max()))
            seg, protos, valid = eng.segment(emb, (h, w))
            topk = eng.retrieve(protos, valid, memory)
            staged = eng.vote(topk, seg, pad)[:h, :w].cpu().numpy()
            if not np.array_equal(staged, pred):
                raise AssertionError("inference (d): a batched prediction "
                                     "differs from the stages on its map")
            seg_alone = eng.segment(alone, (h, w))[0]
            moved += int((seg_alone != seg).reshape(pad)[:h, :w].sum())
            differ += int((pred != eng.predict_semantic(image, *bank)).sum())
    if worst > BF16_STITCH_ATOL:
        raise AssertionError(f"inference (d): a group's stitched map lies "
                             f"{worst:.3e} from the image's own")
    return differ, moved, worst


def check_batched_float32(torch, images, bank):
    """(d) in float32 (TF32 off; the same seed-0 weights), the same groups
    and bank: each batched prediction equal to predict_semantic's.
    Returns the stitched maps bit-equal to the image's own."""
    import tempfile

    from spml_tpu_torch import cli
    from spml_tpu_torch.config import load_config
    from spml_tpu_torch.inference import engine

    cfg = load_config(overrides=dict(INFERENCE,
                                     tpu={"compute_dtype": "float32"}))
    with tempfile.TemporaryDirectory() as snapshot:  # none: seed 0 weights
        eng = engine.InferenceEngine(
            cfg, cli.build_eval_models(cfg, snapshot, DEVICE), DEVICE)
    exact = 0
    for group in groups_of(images):
        preds = eng.predict_semantic_batch(group, *bank)
        together = eng.stitch(torch.stack([eng.upload_image(im)
                                           for im in group]))
        for pred, image, emb in zip(preds, group, together):
            exact += bool(torch.equal(eng.stitch(eng.upload_image(image)),
                                      emb))
            off = pred != eng.predict_semantic(image, *bank)
            if off.any():
                raise AssertionError(
                    f"inference (d) float32: {int(off.sum())} pixels off "
                    "predict_semantic")
    return exact


def time_batched(torch, eng, images, bank):
    """CUDA events around 4 groups of INFER_BATCH (16 images) after one
    warm-up group: (ms/image, peak bytes)."""
    groups = groups_of(images)
    eng.predict_semantic_batch(groups[0], *bank)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for k in range(4):
        eng.predict_semantic_batch(groups[k % len(groups)], *bank)
    end.record()
    torch.cuda.synchronize()
    return (start.elapsed_time(end) / (4 * INFER_BATCH),
            torch.cuda.max_memory_allocated())


# ---------------------------------------------------------------------------
# Driver: the train entry points from an image list on disk
# ---------------------------------------------------------------------------

WORLD_IMAGES = 24
PREFETCH = 4  # the driver's Loader default: batches made ahead
# stage 2 and the baseline: enough steps that the last ones come after
# the batches prefetched during the first step (the warm-up) are used up
DRAINED_STEPS = 12
STAGE1 = {  # bashscripts/voc12/train_spml_scribble.sh:17-46 rendered into
    # configs/voc12_template.yaml, cut to 4 + 2 iterations
    "network": {"backbone_types": "panoptic_deeplab_101",
                "embedding_dim": 64, "kmeans_num_clusters": [6, 6],
                "kmeans_iterations": 10, "label_divisor": 2048,
                "prediction_types": "segsort", "bn_momentum": 3e-4},
    "dataset": {"num_classes": 21, "semantic_ignore_index": 255},
    "train": {"lr_policy": "poly", "snapshot_step": 2,
              "tensorboard_step": 100, "max_iteration": 4,
              "warmup_iteration": 100, "base_lr": 3e-3,
              "weight_decay": 5e-4, "momentum": 0.9, "batch_size": 4,
              "crop_size": [512, 512], "memory_bank_size": 2,
              "random_mirror": True, "random_scale": True,
              "random_crop": True, "shuffle": True,
              "sem_ann_concentration": 6.0, "sem_occ_concentration": 12.0,
              "img_sim_concentration": 16.0, "sem_ann_loss_weight": 1.0,
              "sem_occ_loss_weight": 0.5, "img_sim_loss_weight": 0.1},
    "test": {"image_size": 512, "crop_size": [512, 512],
             "stride": [512, 512]},
    # the fused joint loss as bench.py and train/flagship.py set it: the
    # shipped template leaves it off (the dense losses, no kernel)
    "tpu": {"segment_capacity": 256, "compute_dtype": "bfloat16",
            "use_fused_loss": True},
    "num_threads": 4,
}


def driver_configs(stage1_dir):
    """(stage 1, stage 2, the Adam baseline) configs. Stage 2 is the
    rendered classifier config (train_spml_scribble.sh:123-129:
    PRETRAINED = the stage-1 snapshot, softmax_classifier, batch 16, 1 x 1
    clusters, no k-means iteration), cut to DRAINED_STEPS iterations; the
    baseline is stage 1 with softmax_classifier and Adam, as many."""
    from spml_tpu_torch.config import load_config

    stage1 = load_config(overrides=STAGE1)
    stage2 = load_config(overrides=STAGE1)
    stage2.network.pretrained = stage1_dir
    stage2.network.prediction_types = "softmax_classifier"
    stage2.network.kmeans_iterations = 0
    stage2.network.kmeans_num_clusters = (1, 1)
    stage2.train.batch_size = 16
    stage2.train.max_iteration = DRAINED_STEPS
    base = load_config(overrides=STAGE1)
    base.network.prediction_types = "softmax_classifier"
    base.train.optimizer = "adam"
    base.train.max_iteration = DRAINED_STEPS
    return stage1, stage2, base


class DriverProbe:
    """Times one driver call from the outside: the loader's next() (the
    wait of each step), and each step call between CUDA events on the
    host clock, followed by a synchronize (so the host time is the
    step's own; the driver itself synchronizes only to log). Keeps every
    step's metrics, the first step's state and the frozen embedding a
    classifier step is built over."""

    def __init__(self, torch):
        self.torch = torch
        self.waits, self.steps, self.metrics = [], [], []
        self.first_step, self.first_params, self.frozen = None, None, None
        self.recorded, self.held = None, 0  # set by the caller

    def __enter__(self):
        from unittest import mock

        from spml_tpu_torch.data import datasets
        from spml_tpu_torch.train import classifier_step, step

        loader_iter = datasets.Loader.__iter__
        probe = self

        def timed_iter(loader):
            it = loader_iter(loader)
            try:
                while True:
                    t0 = time.perf_counter()
                    batch = next(it)
                    probe.waits.append(time.perf_counter() - t0)
                    yield batch
            finally:
                it.close()

        self.patches = [
            mock.patch.object(datasets.Loader, "__iter__", timed_iter),
            mock.patch.object(step, "make_train_step",
                              self.timed(step.make_train_step)),
            mock.patch.object(
                classifier_step, "make_classifier_train_step",
                self.timed(classifier_step.make_classifier_train_step))]
        for p in self.patches:
            p.start()
        return self

    def __exit__(self, *exc):
        for p in self.patches:
            p.stop()
        self.patches = None  # its closures hold the probe: no cycle left

    def timed(self, make):
        torch = self.torch

        def make_timed(config, *rest):
            if rest:
                self.frozen = rest[0]
            train_step = make(config, *rest)
            self.raw_step = train_step

            def step(state, batch):
                self.last_batch = batch
                if self.first_step is None:
                    self.first_step = state.step
                    model = (state.emb_model if state.emb_model is not None
                             else state.cls_model)
                    self.first_params = {
                        n: p.detach().clone()
                        for n, p in model.named_parameters()}
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                t0 = time.perf_counter()
                start.record()
                state, metrics = train_step(state, batch)
                end.record()
                torch.cuda.synchronize()
                self.steps.append((time.perf_counter() - t0, start, end))
                self.metrics.append({k: float(v) for k, v in metrics.items()})
                return state, metrics
            return step
        return make_timed

    def replay(self, state, n=5):
        """After the driver call (its loader closed): one warm-up and n
        steps of the same step function on the run's last batch, first
        each between CUDA events and a synchronize as the driver's steps
        are timed, then n back to back between two events, as the
        recipes' steps are; (host ms, device ms, back-to-back ms) per
        step."""
        torch = self.torch
        state, _ = self.raw_step(state, self.last_batch)
        torch.cuda.synchronize()
        host, dev = [], []
        for _ in range(n):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            state, _ = self.raw_step(state, self.last_batch)
            end.record()
            torch.cuda.synchronize()
            host.append((time.perf_counter() - t0) * 1000)
            dev.append(start.elapsed_time(end))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            state, _ = self.raw_step(state, self.last_batch)
        end.record()
        torch.cuda.synchronize()
        self.replayed = (float(np.mean(host)), float(np.mean(dev)),
                         start.elapsed_time(end) / n)

    def check_finite(self, what):
        bad = [m for m in self.metrics
               if not all(math.isfinite(v) for k, v in m.items()
                          if k.endswith("loss"))]
        if bad or not self.metrics:
            raise AssertionError(f"{what}: non-finite loss: {bad}")

    def steady(self, first):
        """(host ms in the step call, loader wait ms, device ms) a step,
        means over the steps from index `first` on."""
        n = len(self.steps)
        return (float(np.mean([h * 1000 for h, _, _ in self.steps[first:]])),
                float(np.mean([w * 1000 for w in self.waits[first:n]])),
                float(np.mean([s.elapsed_time(e)
                               for _, s, e in self.steps[first:]])))

    def line(self, what, batch, state):
        """The [driver] line: steady state over the steps after the first,
        and over those after the start-up prefetch drained (the steps
        after the first PREFETCH + 1, whose batches the loader made while
        steps ran); then the replay (which moves `state` on: call it after
        the checks)."""
        self.replay(state)
        n = len(self.steps)
        host, wait, dev = self.steady(1)
        drained = "none: too few steps"
        if n > PREFETCH + 1:
            d_host, d_wait, _ = self.steady(PREFETCH + 1)
            drained = (
                f"loader wait {d_wait:.2f} ms/step, data-wait share "
                f"{d_wait / (d_wait + d_host):.1%}, host {d_host:.2f} ms/step"
                f" in the step call, {batch * 1000 / (d_wait + d_host):.2f} "
                "images/s")
        log("driver", f"{what}: {n} steps; steady state (steps 2-{n}): "
            f"host {host:.2f} ms/step in the step call, loader wait "
            f"{wait:.2f} ms/step, device {dev:.2f} ms/step (CUDA events), "
            f"{batch * 1000 / (host + wait):.2f} images/s (batch {batch} "
            f"over wait + step); after the start-up prefetch of {PREFETCH} "
            f"batches drained (steps {PREFETCH + 2}-{n}): {drained}; waits "
            f"{[round(w * 1000, 1) for w in self.waits[:n]]} ms; first step "
            f"{self.steps[0][0] * 1000:.0f} ms; the same step on the last "
            f"batch with the loader closed: host {self.replayed[0]:.2f} ms, "
            f"device {self.replayed[1]:.2f} ms a step, "
            f"{self.replayed[2]:.2f} ms back to back; peak memory "
            f"{self.torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
            f"({self.held / 2**30:.2f} GiB held when the run began); "
            f"card {nvidia_smi_line()}")


def run_driver(torch, fused, dc):
    """Stage 1 (train_spml, ListTagDataset, K1-K3 on every step) for 4
    iterations and resumed to 6, the single-scale KNN chain on its
    snapshot, stage 2 (train_classifier over it), and the baseline
    (softmax_classifier with Adam), on a world of WORLD_IMAGES images
    written from seed 0 into a temporary directory; then the
    self-training phase on that world and those snapshots; the checks of
    the module docstring."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="spml_driver_") as root:
        world = drive_all(torch, fused, root)
        run_selftrain(torch, fused, dc, world)


def drive_all(torch, fused, root):
    import argparse

    from spml_tpu_torch.data import datasets, synthetic
    from spml_tpu_torch.inference import runner
    from spml_tpu_torch.train import driver, optim
    from spml_tpu_torch.utils import checkpoint as ckpt

    t0 = time.perf_counter()
    data = os.path.join(root, "world")
    lst = synthetic.write_world(data, WORLD_IMAGES, seed=0)
    log("driver", f"world of {WORLD_IMAGES} JPEGs (500 x 375 / 375 x 500, 21 "
        f"classes, ~30 segments each) in {time.perf_counter() - t0:.1f} s")
    stage1_dir = os.path.join(root, "stage1")
    stage1, stage2, base = driver_configs(stage1_dir)

    def args(snapshot, data_list=lst, save=None, memory=None):
        return argparse.Namespace(data_dir=data, data_list=data_list,
                                  snapshot_dir=snapshot, save_dir=save,
                                  semantic_memory_dir=memory)

    def drive(what, fn, cfg, *a):
        torch.cuda.reset_peak_memory_stats()
        fused.reset_launch_counts()
        held = torch.cuda.memory_allocated()
        with DriverProbe(torch) as probe, \
                recording_stats(torch, fused, "joint") as recorded:
            state = fn(args(*a), cfg, device=DEVICE)
        launches = {k: v for k, v in fused.LAUNCHES.items() if v}
        probe.check_finite(what)
        probe.recorded, probe.held = recorded, held
        return state, probe, launches

    # ---- stage 1: 4 iterations, then resumed to 6 ----
    ck_dir = os.path.join(stage1_dir, "checkpoints")
    for first, last in ((0, 4), (4, 6)):
        stage1.train.max_iteration = last
        stage1.train.resume = first > 0
        state = probe = None  # the last run's, out of this run's peak
        state, probe, launches = drive(f"stage 1 {first}-{last}",
                                       driver.train_spml, stage1,
                                       stage1_dir)
        n = last - first
        want = {"joint_stats": n, "joint_grad_emb": n,
                "joint_grad_proto": n}
        if launches != want:
            raise AssertionError(f"stage 1: launches {launches}, want "
                                 f"{want} (K1-K3 once a step, no other)")
        lr = optim.make_schedule(stage1.train)(first)
        if (probe.first_step != first or state.step != last
                or probe.metrics[0]["learning_rate"] != lr):
            raise AssertionError(
                f"stage 1 {first}-{last}: first step {probe.first_step} "
                f"(lr {probe.metrics[0]['learning_rate']}, want {lr}), "
                f"last {state.step}")
        losses = ", ".join(f"{k} {v:.4f}" for k, v in sorted(
            probe.metrics[-1].items()) if k.endswith("loss"))
        log("driver", f"stage 1 {first}-{last}: started at step "
            f"{probe.first_step} at lr {lr:.3e} (the schedule's), "
            f"launches {launches}; last step {losses}, "
            f"{int(probe.metrics[-1]['num_segments'])} segments")
        probe.line(f"stage 1 {first}-{last} (panoptic_deeplab_101 bf16, "
                   "ListTagDataset, crop 512)", stage1.train.batch_size,
                   state)
    if ckpt.steps(ck_dir) != [2, 4, 6]:
        raise AssertionError(f"stage 1 checkpoints {ckpt.steps(ck_dir)}")
    # K1-K3 at the driver's own shapes: the last step's stats inputs
    check_recorded(torch, fused, "joint", "stage 1 step 6", probe.recorded,
                   seed=40)
    state = probe = None
    log_native_item()
    trace_stage1(torch, fused, stage1, args(os.path.join(root, "traced")),
                 os.path.join(root, "profile"))

    # ---- the single-scale KNN chain on the stage-1 snapshot ----
    infer = load_infer_config(stage1)
    with open(lst) as f:
        items = f.read().splitlines()
    lists = {}
    for name, n in (("memory", 8), ("test", 4)):
        lists[name] = os.path.join(root, f"{name}.txt")
        with open(lists[name], "w") as f:
            f.write("\n".join(items[:n]) + "\n")
    train_out = os.path.join(root, "results", "train")
    val_out = os.path.join(root, "results", "val")
    t0 = time.perf_counter()
    runner.run_prototype(args(stage1_dir, lists["memory"], train_out),
                         infer, device=DEVICE)
    runner.run_knn_inference(
        args(stage1_dir, lists["test"], val_out,
             os.path.join(train_out, "semantic_prototype")),
        infer, device=DEVICE)
    result = runner.run_benchmark(args(stage1_dir, lists["test"], val_out),
                                  infer)
    pngs = sorted(os.listdir(os.path.join(val_out, "semantic_gray")))
    miou = result["mean_iou"]
    if not (math.isfinite(miou) and 0.0 <= miou <= 1.0) or len(pngs) != 4:
        raise AssertionError(f"inference chain: mIoU {miou}, PNGs {pngs}")
    log("driver", f"KNN chain on the stage-1 snapshot (step 6): "
        f"run_prototype over 8 images, run_knn_inference over 4, "
        f"run_benchmark mIoU {miou:.4f}, {len(pngs)} PNGs, "
        f"{time.perf_counter() - t0:.1f} s")

    # ---- stage 2 over the stage-1 snapshot ----
    saved = ckpt.read(ck_dir)["emb_model"]  # host memory
    state, probe, launches = drive("stage 2", driver.train_classifier,
                                   stage2, os.path.join(root, "stage2"))
    frozen = {k: v.cpu() for k, v in probe.frozen.state_dict().items()}
    changed = [n for n, p in state.cls_model.named_parameters()
               if not torch.equal(p, probe.first_params[n])]
    if (launches or frozen.keys() != saved.keys()
            or not all(torch.equal(frozen[k], saved[k]) for k in saved)
            or len(changed) != len(probe.first_params)):
        raise AssertionError(
            f"stage 2: launches {launches}, embedding equal to stage 1's: "
            f"{all(torch.equal(frozen[k], saved[k]) for k in saved)}, "
            f"head parameters changed {changed}")
    log("driver", f"stage 2: the embedding's {len(saved)} parameters and "
        f"BN buffers equal to stage 1's step 6, all "
        f"{len(changed)} head parameters changed, no kernel launched; last "
        f"step loss {probe.metrics[-1]['loss']:.4f}, accuracy "
        f"{probe.metrics[-1]['accuracy']:.4f}")
    rates = [loader_ms(cfg, cls, args(root)) for cfg, cls in (
        (stage1, datasets.ListTagDataset),
        (stage2, datasets.ListTagClassifierDataset))]
    log("driver", "the loaders alone, 8 batches each drawn back to back "
        "from a fresh Loader (4 threads, 4 batches prefetched, no step "
        f"running): stage 1 (ListTagDataset, batch 4) {rates[0]:.1f} ms a "
        "batch; stage 2 (ListTagClassifierDataset, batch 16) "
        f"{rates[1]:.1f} ms a batch")
    probe.line("stage 2 (ListTagClassifierDataset, frozen "
               "panoptic_deeplab_101, crop 512)", stage2.train.batch_size,
               state)

    # ---- the fully supervised baseline with Adam ----
    state = probe = None
    state, probe, launches = drive("baseline", driver.train_spml, base,
                                   os.path.join(root, "baseline"))
    moved = {n: not torch.equal(p, probe.first_params[n])
             for n, p in state.emb_model.named_parameters()}
    frozen_moved = [n for n, m in moved.items()
                    if m and n.split(".")[1] in ("conv1", "res2")]
    trained_still = [n for n, m in moved.items() if not m
                     and n.split(".")[1] in ("res3", "res4", "res5")]
    if (launches or state.memory.valid.any() or frozen_moved
            or trained_still or state.adam_count != DRAINED_STEPS):
        raise AssertionError(
            f"baseline: launches {launches}, bank entries "
            f"{int(state.memory.valid.sum())}, stem/res2 moved "
            f"{frozen_moved}, res3-5 unmoved {trained_still}, Adam count "
            f"{state.adam_count}")
    log("driver", f"baseline (softmax_classifier, Adam): no kernel "
        f"launched, bank empty, stem and res2 unchanged, every res3-5 "
        f"parameter moved, Adam count {state.adam_count}; last step "
        f"sem_ann_loss {probe.metrics[-1]['sem_ann_loss']:.4f}")
    probe.line("baseline (panoptic_deeplab_101 bf16, ListTagDataset, crop "
               "512, Adam)", base.train.batch_size, state)
    return argparse.Namespace(root=root, data=data, list=lst,
                              lists=lists, stage1_dir=stage1_dir,
                              stage1=stage1, stage2=stage2,
                              stage2_dir=os.path.join(root, "stage2"),
                              bank=os.path.join(train_out,
                                                "semantic_prototype"))


# ---------------------------------------------------------------------------
# Self-training: MSC, CRF, softmax and the pseudo-labels on the world and
# snapshots of the driver phase
# ---------------------------------------------------------------------------

MSC_SCALES = (0.5, 0.75, 1, 1.25, 1.5)  # inference_msc.py
# cli.parse_args's --crf_* defaults: the recipe passes none
# (train_spml_scribble.sh:140, 168, CRF_FLAGS unset)
CRF_FLAGS = dict(crf_iter_max=10, crf_pos_xy_std=1, crf_pos_w=3,
                 crf_bi_xy_std=67, crf_bi_w=4, crf_bi_rgb_std=3)
# float32 label path against float64: a sum of 10 members' values up to 1
# through two bilinear resizes, a few tens of roundings of 2^-24 * 10
MSC_TIE_GAP = 1e-4
# the walk (T ** 64 by six float32 squarings of [n, n] products) against
# float64, and the pyramids' float32 probabilities card against CPU: the
# KNN one's are sums of exact one-hot means (resize sums alone differ),
# the softmax one's carry the conv stack's STITCH_RTOL through the logits
WALK_RTOL, WALK_ATOL_REL = 1e-3, 1e-4
KNN_PROB_RTOL, KNN_PROB_ATOL = 1e-5, 1e-6
# a member pixel may join another cluster on the card only where the
# CPU's last k-means E-step, in float64, puts its two best clusters this
# close: the card's stitched map is within STITCH_RTOL 1e-4 of the CPU's,
# so each unit-vector affinity moves by ~2e-4 at most
KMEANS_TIE_GAP = 1e-3
SOFTMAX_PROB_RTOL, SOFTMAX_PROB_ATOL = 1e-3, 1e-4
DENSEPOSE_POINTS = 300  # labelled pixels an image, the rest 255
PSEUDO_STAGES = ("forward", "affinity", "walk", "pseudo_crf")


def quiet(torch, fn, *a, **k):
    """fn(*a, **k) with its per-image lines kept from the log; (seconds
    to the card's last result, lines printed)."""
    import io

    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        fn(*a, **k)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out.getvalue().count("\n")


def read_pngs(save_dir, n, num_classes, what):
    """The n gray PNGs of a run, {name: labels}; each label in [0, C) or
    the ignore label."""
    import PIL.Image

    gray = os.path.join(save_dir, "semantic_gray")
    names = sorted(os.listdir(gray))
    colour = sorted(os.listdir(os.path.join(save_dir, "semantic_color")))
    if len(names) != n or colour != names:
        raise AssertionError(f"{what}: {len(names)} gray and {len(colour)} "
                             f"colour PNGs, want {n}")
    out = {}
    for name in names:
        lab = np.array(PIL.Image.open(os.path.join(gray, name)))
        bad = (lab >= num_classes) & (lab != 255)
        if bad.any():
            raise AssertionError(f"{what}: {name} holds labels "
                                 f"{np.unique(lab[bad])}")
        out[name] = lab
    return out


def check_msc_labels(torch, recorded, pngs):
    """(a) the MSC labels of the runner against the float64 argmax of the
    very sums it resized (recorded): equal but where the float64 top two
    lie within MSC_TIE_GAP. Returns (pixels, near-tie pixels)."""
    from spml_tpu_torch.inference import msc

    pixels = near = 0
    for (acc, final_hw), (name, lab) in zip(recorded, sorted(pngs.items())):
        h, w = acc.shape[:2]
        wr = msc.bilinear_resize_weights(final_hw[0], h, final_hw[0], h,
                                         False, acc.device).double()
        wc = msc.bilinear_resize_weights(final_hw[1], w, final_hw[1], w,
                                         False, acc.device).double()
        res = torch.einsum("pw,owc->opc", wc,
                           torch.einsum("oi,iwc->owc", wr, acc.double()))
        top2 = torch.topk(res, 2, dim=-1).values
        gap = (top2[..., 0] - top2[..., 1]).cpu().numpy()
        want = res.argmax(-1).cpu().numpy()
        off = lab != want
        if (gap[off] >= MSC_TIE_GAP).any():
            raise AssertionError(
                f"selftrain (a): {name}: {int(off.sum())} labels off the "
                f"float64 argmax, largest gap {gap[off].max():.3e}")
        pixels += lab.size
        near += int(off.sum())
    return pixels, near


def near_tie_mismatch(got, want, probs, rtol, atol, what, skip=None):
    """Labels of the card against the CPU's: equal but where the CPU's
    top two probabilities lie within the probabilities' tolerance, and
    outside `skip`. Returns the excused pixels."""
    top2 = np.sort(probs, axis=-1)[..., -2:]
    tol = atol + rtol * top2[..., 1]
    off = got != want
    if skip is not None:
        off &= ~skip
    if (top2[..., 1] - top2[..., 0] >= tol)[off].any():
        raise AssertionError(f"selftrain (e): card and CPU {what} labels "
                             f"differ in {int(off.sum())} places")
    return int(off.sum())


def kmeans_gap64(torch, eng, emb_map, hw, pixels):
    """The float64 gap between a member's two best clusters at `pixels`
    in the last E-step of engine.segment's k-means on emb_map: the first
    iterations in float32 as segment runs them, the last M-step and
    E-step in float64."""
    from spml_tpu_torch.ops import common, kmeans

    net = eng.config.network
    hb, wb, d = emb_map.shape
    k = net.kmeans_num_clusters[0] * net.kmeans_num_clusters[1]
    rows = torch.arange(hb)[:, None] < hw[0]
    cols = torch.arange(wb)[None, :] < hw[1]
    valid = (rows & cols).reshape(-1)
    loc = common.generate_location_features(hb, wb) - 0.5
    emb_loc = common.normalize_embedding(torch.cat(
        [common.normalize_embedding(emb_map.reshape(-1, d)),
         loc.reshape(-1, 2)], dim=-1))
    grid = kmeans.initialize_cluster_labels(
        tuple(net.kmeans_num_clusters), (hb, wb)).reshape(-1)
    labels = kmeans.kmeans_with_initial_labels(
        emb_loc[None], grid[None], k, net.kmeans_iterations - 1,
        valid[None].float())[0]
    protos = kmeans.calculate_prototypes_from_labels(
        emb_loc.double(), labels, k, valid.double())
    top2 = torch.topk(emb_loc.double()[pixels] @ protos.T, 2, dim=-1).values
    return top2[:, 0] - top2[:, 1]


def knn_cluster_footprint(torch, engines, image, scales):
    """Each pyramid member on the card against the CPU: the stitched maps
    within STITCH_RTOL, the cluster maps equal but at float64 near-ties
    of the last E-step (gap below KMEANS_TIE_GAP). Returns (the base
    pixels those near-tie pixels feed through the resize, [h, w] bool;
    the near-tie pixels)."""
    from spml_tpu_torch.inference import msc

    h, w = image.shape[:2]
    footprint = torch.zeros(h, w, dtype=torch.bool)
    near = 0
    for scale in scales:
        member_hw = (int(h * scale), int(w * scale))
        out = {}
        for dev, eng in engines.items():
            members = eng.members(eng.upload_image(image), (h, w), member_hw,
                                  (False, True))
            emb = eng.stitch(members)
            out[dev] = (emb.cpu(), [eng.segment(e, member_hw)[0].cpu()
                                    for e in emb])
        (emb, want), (emb_card, got) = out["cpu"], out[DEVICE]
        torch.testing.assert_close(
            emb_card, emb, rtol=STITCH_RTOL,
            atol=STITCH_ATOL_REL * float(emb.abs().max()),
            msg=lambda m: f"selftrain (e) member {member_hw} stitch: {m}")
        hb, wb = emb.shape[1:3]
        inside = torch.zeros(hb, wb, dtype=torch.bool)
        inside[:member_hw[0], :member_hw[1]] = True
        for i, flip in enumerate((False, True)):
            off = (got[i] != want[i]) & inside.reshape(-1)
            if not off.any():
                continue
            gap = kmeans_gap64(torch, engines["cpu"], emb[i], member_hw,
                               off)
            if (gap >= KMEANS_TIE_GAP).any():
                raise AssertionError(
                    f"selftrain (e): member {member_hw} flip {flip}: "
                    f"{int(off.sum())} pixels in other clusters on the "
                    f"card, float64 gap up to {float(gap.max()):.3e}")
            near += int(off.sum())
            fed = msc.bilinear_resize(off.reshape(hb, wb, 1).float(),
                                      member_hw, (h, w), flip=flip)
            footprint |= fed[..., 0] > 0
    return footprint.numpy(), near


def check_pyramids_card_against_cpu(torch):
    """(e) the KNN and softmax device pyramids, float32, crop 128, stride
    64, a 192 x 160 image, scales (0.75, 1) with flips, card against CPU:
    the softmax probabilities within their tolerance and the labels equal
    but at near-ties; the KNN members' clusters equal but at k-means
    near-ties, and outside the base pixels those feed, the probabilities
    within their tolerance and the labels equal but at near-ties.
    Returns {engine: (max abs error outside near-ties, excused labels,
    k-means near-tie pixels)}."""
    import copy

    from spml_tpu_torch.config import load_config
    from spml_tpu_torch.inference import engine, msc
    from spml_tpu_torch.inference.softmax import SoftmaxInferenceEngine
    from spml_tpu_torch.models.embeddings import (build_classifier_head,
                                                  build_embedding_model)

    over = dict(INFERENCE, test={"image_size": 0, "crop_size": [128, 128],
                                 "stride": [64, 64]},
                tpu={"compute_dtype": "float32"})
    cfg = load_config(overrides=over)
    net, c = cfg.network, cfg.dataset.num_classes
    model = build_embedding_model(net.backbone_types, net.embedding_dim)
    head = build_classifier_head(c, net.embedding_dim)
    image = inference_images(cfg, 1, seed=2)[0][0][:192, :160]
    scales = (0.75, 1.0)
    rng = np.random.RandomState(1)
    bank_p = rng.randn(2000, net.embedding_dim).astype(np.float32)
    bank_p /= np.linalg.norm(bank_p, axis=1, keepdims=True)
    bank = (bank_p, rng.randint(0, c, 2000), np.ones(2000, bool))
    out = {}
    for kind, rtol, atol in (("knn", KNN_PROB_RTOL, KNN_PROB_ATOL),
                             ("softmax", SOFTMAX_PROB_RTOL,
                              SOFTMAX_PROB_ATOL)):
        engines, args = {}, {}
        for dev in ("cpu", DEVICE):
            if kind == "knn":
                engines[dev] = engine.InferenceEngine(
                    cfg, copy.deepcopy(model), dev)
                args[dev] = engines[dev].memory(*bank)
            else:
                engines[dev] = SoftmaxInferenceEngine(
                    cfg, copy.deepcopy(model), copy.deepcopy(head), dev)
                args[dev] = ()
        skip, near = np.zeros(image.shape[:2], bool), 0
        if kind == "knn":
            skip, near = knn_cluster_footprint(torch, engines, image, scales)
        res = {dev: (msc.msc_predict_probs_device(
            eng, image, args[dev], scales, transfer_dtype=np.float32),
            msc.msc_predict_labels_device(eng, image, args[dev], scales))
            for dev, eng in engines.items()}
        (want, wlab), (got, glab) = res["cpu"], res[DEVICE]
        torch.testing.assert_close(
            torch.from_numpy(got[~skip]), torch.from_numpy(want[~skip]),
            rtol=rtol, atol=atol,
            msg=lambda m, kind=kind: f"selftrain (e) {kind}: {m}")
        out[kind] = (float(np.abs(got - want)[~skip].max()),
                     near_tie_mismatch(glab, wlab, want, rtol, atol, kind,
                                       skip), near)
    return out


def check_walk_float64(torch, config, emb_model, image, scores):
    """(e) the walk on the card against float64 on the card, at the grid
    of a 500 x 375 image (n = 62 * 46). Returns (n, max abs error,
    float64 ms, float32 ms)."""
    from spml_tpu_torch.inference import runner
    from spml_tpu_torch.ops import randomwalk

    h, w = image.shape[:2]
    aff = runner._stride8_affinity(config, emb_model, image)
    c = scores.shape[0]
    s8 = torch.nn.functional.interpolate(
        torch.from_numpy(scores)[None].to(aff.device), size=(h // 8, w // 8),
        mode="bilinear", align_corners=False)[0].reshape(c, -1)
    randomwalk.random_walk_from_affinity(aff, s8)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = randomwalk.random_walk_from_affinity(aff, s8)
    torch.cuda.synchronize()
    f32_ms = (time.perf_counter() - t0) * 1000
    t0 = time.perf_counter()
    trans = aff.double() ** 20
    trans = trans / trans.sum(0, keepdim=True)
    for _ in range(6):
        trans = trans @ trans
    want = s8.double() @ trans
    torch.cuda.synchronize()
    f64_ms = (time.perf_counter() - t0) * 1000
    torch.testing.assert_close(
        got.double(), want, rtol=WALK_RTOL,
        atol=WALK_ATOL_REL * float(want.abs().max()),
        msg=lambda m: f"selftrain (e) walk: {m}")
    return aff.shape[0], float((got.double() - want).abs().max()), \
        f64_ms, f32_ms


def time_selftrain(torch, eng, memory, seng, peng, images, crf_model,
                   config):
    """(f) ms/image over `images` (normalized, with their labels), each
    stage ended by a synchronize: KNN MSC + CRF split into the device
    pyramid, the float16 download, the host resize and CRF; the softmax
    pyramid; the pseudo-label step split into forward (the softmax
    pyramid and the stride-8 embeddings), affinity, walk and CRF."""
    from spml_tpu_torch import cli
    from spml_tpu_torch.data import transforms
    from spml_tpu_torch.inference import msc, runner
    from spml_tpu_torch.ops import randomwalk

    t = dict.fromkeys(("pyramid", "download", "crf", "softmax", "forward",
                       "affinity", "walk", "pseudo_crf"), 0.0)

    def clock(key, fn, *a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a)
        torch.cuda.synchronize()
        t[key] += (time.perf_counter() - t0) * 1000 / len(images)
        return out

    c = config.dataset.num_classes
    for image0, sem in images:
        oh, ow = image0.shape[:2]
        image = runner._maybe_resize_input(eng.config, image0)[0]
        acc, n = clock("pyramid", msc._msc_accumulate_device, eng, image,
                       memory, MSC_SCALES, True)
        small = clock("download", lambda: acc.half().cpu().numpy())
        rgb = cli.denormalize_image(image0, config)
        clock("crf", lambda: crf_model(rgb, transforms._resize_image(
            small.astype(np.float32) / n, oh, ow).transpose(2, 0, 1)))
        clock("softmax", msc._msc_accumulate_device, seng, image, (),
              MSC_SCALES, True)
        h, w = image0.shape[:2]
        probs = clock("forward", msc.msc_predict_probs_device, peng, image0,
                      (), (1.0,), True)
        e = clock("forward", runner._stride8_embeddings, config,
                  peng.emb_model, image0)
        aff = clock("affinity", lambda: (randomwalk.pixel_affinity(e[0])
                                         + randomwalk.pixel_affinity(e[1]))
                    * 0.5)
        probs = runner._tag_mask(probs.transpose(2, 0, 1), sem, c)
        probs = probs / np.maximum(probs.max(axis=(1, 2), keepdims=True),
                                   1e-8)
        walked = clock("walk", runner._walk_scores, aff, probs,
                       (h // 8, w // 8))
        clock("pseudo_crf", crf_model, rgb, np.ascontiguousarray(walked))
    return t


def run_selftrain(torch, fused, dc, w):
    """The VOC scribble recipe after stage 1 (train_spml_scribble.sh:82-170)
    on the driver phase's world and snapshots, at full width: (a) KNN with
    MSC and CRF, and MSC alone; (b) softmax inference of the stage-2
    snapshot with and without MSC + CRF; (c) the recipe's pseudo-labels
    (pseudo_softmaxrw_crf) over the 24 training images, their mIoU, the
    list rewritten to them and 2 steps of train_classifier on it; (d)
    run_pseudo_knn, run_pseudo_camrw_crf (synthetic CAMs) and
    run_pseudo_densepose (a point-labelled world); (e) the card checks;
    (f) one [selftrain] line."""
    import argparse
    import copy
    from unittest import mock

    from spml_tpu_torch import cli, crf
    from spml_tpu_torch.config import load_config
    from spml_tpu_torch.data import datasets, synthetic
    from spml_tpu_torch.inference import engine, msc, runner
    from spml_tpu_torch.inference.softmax import SoftmaxInferenceEngine
    from spml_tpu_torch.train import densepose_point, driver

    t_phase = time.perf_counter()
    fused.reset_launch_counts()
    dc.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    root, stage1_dir, test4 = w.root, w.stage1_dir, w.lists["test"]
    infer = load_infer_config(w.stage1)
    c = infer.dataset.num_classes

    def args(snapshot, data_list, save, **extra):
        return argparse.Namespace(
            data_dir=w.data, data_list=data_list, snapshot_dir=snapshot,
            save_dir=os.path.join(root, "selftrain", save),
            semantic_memory_dir=w.bank, cam_dir=None, **CRF_FLAGS, **extra)

    # (a) KNN with MSC + CRF, and MSC alone with its sums recorded
    runs = {}
    runs["knn msc+crf"] = quiet(torch, runner.run_knn_inference,
                                args(stage1_dir, test4, "knn_msc_crf"),
                                infer, msc=True, crf=True, device=DEVICE)
    recorded = []
    resize_argmax = msc.resize_argmax

    def recording(acc, final_hw):
        recorded.append((acc.clone(), tuple(final_hw)))
        return resize_argmax(acc, final_hw)

    with mock.patch.object(msc, "resize_argmax", recording):
        runs["knn msc"] = quiet(torch, runner.run_knn_inference,
                                args(stage1_dir, test4, "knn_msc"), infer,
                                msc=True, device=DEVICE)
    read_pngs(os.path.join(root, "selftrain", "knn_msc_crf"), 4, c, "(a)")
    pixels, near = check_msc_labels(torch, recorded, read_pngs(
        os.path.join(root, "selftrain", "knn_msc"), 4, c, "(a)"))
    log("selftrain", f"(a) KNN MSC (scales {MSC_SCALES} x flips) + CRF and "
        f"MSC alone over 4 images: PNGs written; MSC labels equal the "
        f"float64 argmax of the resized float32 sums on {pixels - near} of "
        f"{pixels} pixels, {near} near-ties (gap < {MSC_TIE_GAP})")

    # (b) softmax inference of the stage-2 snapshot
    for name, kw in (("softmax msc+crf", dict(msc=True, crf=True)),
                     ("softmax", {})):
        save = name.replace(" ", "_").replace("+", "_")
        runs[name] = quiet(torch, runner.run_softmax_inference,
                           args(w.stage2_dir, test4, save), w.stage2,
                           device=DEVICE, **kw)
        read_pngs(os.path.join(root, "selftrain", save), 4, c, "(b)")
    log("selftrain", "(b) run_softmax_inference of the stage-2 snapshot "
        "(its frozen embedding from stage 1) over 4 images, MSC + CRF and "
        "single scale: PNGs written")

    # (c) the recipe's pseudo-labels, their mIoU, stage 2 on them
    pcfg = copy.deepcopy(infer)
    pcfg.network.kmeans_num_clusters = (1, 1)  # the recipe's flag
    pseudo = os.path.join(root, "selftrain", "pseudo_cam_rw")
    runs["pseudo softmax"] = quiet(
        torch, runner.run_pseudo_softmax, args(stage1_dir, w.list,
                                               "pseudo_cam_rw"), pcfg,
        with_crf=True, with_walk=True, scales=(1.0,), device=DEVICE)
    read_pngs(pseudo, WORLD_IMAGES, c, "(c)")
    with contextlib.redirect_stdout(None):
        miou = runner.run_benchmark(
            args(stage1_dir, w.list, "pseudo_cam_rw"), pcfg)["mean_iou"]
    if not (math.isfinite(miou) and 0.0 <= miou <= 1.0):
        raise AssertionError(f"selftrain (c): pseudo-label mIoU {miou}")
    with open(w.list) as f:  # the recipe's sed: labels -> pseudo-labels
        items = f.read().replace(
            "semantic/", os.path.join(pseudo, "semantic_gray") + "/")
    plist = os.path.join(pseudo, "list.txt")
    with open(plist, "w") as f:
        f.write(items)
    cls_cfg = copy.deepcopy(w.stage2)
    cls_cfg.train.max_iteration = 2
    with DriverProbe(torch) as probe:
        quiet(torch, driver.train_classifier,
              args(os.path.join(root, "softmax_classifier_stage1"), plist,
                   "unused"), cls_cfg, datasets.ListTagClassifierDataset,
              device=DEVICE)
    probe.check_finite("selftrain (c) classifier")
    if len(probe.metrics) != 2:
        raise AssertionError(f"selftrain (c): {len(probe.metrics)} stage-2 "
                             "steps, want 2")
    log("selftrain", f"(c) pseudo_softmaxrw_crf over {WORLD_IMAGES} images "
        f"(scales (1.0,) x flips, walk, CRF): mIoU {miou:.4f} against the "
        f"world's labels; the list rewritten to them; train_classifier 2 "
        f"steps, loss {probe.metrics[-1]['loss']:.4f}")

    # (d) the other pseudo-label paths
    runs["pseudo knn"] = quiet(torch, runner.run_pseudo_knn,
                               args(stage1_dir, test4, "pseudo_knn"), infer,
                               device=DEVICE)
    read_pngs(os.path.join(root, "selftrain", "pseudo_knn"), 4, c, "(d)")
    cams = os.path.join(root, "selftrain", "cams")
    synthetic.write_cams(cams, w.data, test4, num_classes=c, seed=0)
    camrw_args = args(stage1_dir, test4, "pseudo_camrw")
    camrw_args.cam_dir = cams
    runs["pseudo camrw"] = quiet(torch, runner.run_pseudo_camrw_crf,
                                 camrw_args, infer, device=DEVICE)
    read_pngs(camrw_args.save_dir, 4, c, "(d)")
    dp_data = os.path.join(root, "densepose")
    dp_list = synthetic.write_world(
        dp_data, 2, shapes=((427, 640), (640, 427)),
        num_classes=densepose_point.NUM_CLASSES, seed=0,
        points=DENSEPOSE_POINTS)
    dp_cfg = load_config(overrides=densepose_point.OVERRIDES)
    dp_cfg.network.kmeans_num_clusters = (24, 24)  # the recipe's flag
    dp_cfg.test.image_size = 640
    dp_cfg.test.crop_size = dp_cfg.test.stride = (640, 640)
    dp_args = args(os.path.join(root, "no_snapshot"), dp_list, "densepose")
    dp_args.data_dir = dp_data
    runs["pseudo densepose"] = quiet(torch, runner.run_pseudo_densepose,
                                     dp_args, dp_cfg, device=DEVICE)
    dp = read_pngs(dp_args.save_dir, 2, densepose_point.NUM_CLASSES, "(d)")
    for name, lab in dp.items():
        sem = datasets.read_label(os.path.join(dp_data, "semantic", name))
        if not ((lab == 255) == (sem == 255)).all():
            raise AssertionError(f"selftrain (d): {name}: the pixels "
                                 "without a point are not exactly the 255s")
    log("selftrain", "(d) run_pseudo_knn (scales (0.5, 1, 1.5, 2) x flips, "
        "tag mask, CRF, floor 0.15) and run_pseudo_camrw_crf over 4 images; "
        "run_pseudo_densepose over 2 images of 427 x 640 / 640 x 427 with "
        f"{DENSEPOSE_POINTS} points (panoptic_pspnet_101_densepose, seed 0, "
        "24 x 24 clusters, crop 640; train_spml_point.sh:49-53, 97-104): "
        "PNGs written, 255 exactly off the points")

    # (e) the card checks
    eng = engine.InferenceEngine(
        infer, cli.build_eval_models(infer, stage1_dir, DEVICE), DEVICE)
    memory = runner._load_memory(args(stage1_dir, test4, "unused"), infer,
                                 eng)
    seng = SoftmaxInferenceEngine(w.stage2, *cli.build_eval_models(
        w.stage2, w.stage2_dir, DEVICE, with_classifier=True), DEVICE)
    peng = SoftmaxInferenceEngine(pcfg, *cli.build_eval_models(
        pcfg, stage1_dir, DEVICE, with_classifier=True), DEVICE)
    items = [(img, sem) for _, _, img, sem, _ in cli.iterate_test_images(
        infer, w.data, test4)]
    probs = msc.msc_predict_probs_device(peng, items[0][0], (), (1.0,))
    n, walk_err, f64_ms, f32_ms = check_walk_float64(
        torch, pcfg, peng.emb_model, items[0][0],
        np.ascontiguousarray(probs.transpose(2, 0, 1)))
    crf_model = cli.crf_from_args(argparse.Namespace(**CRF_FLAGS))
    rgb = cli.denormalize_image(items[0][0], infer)
    unary = np.ascontiguousarray(probs.transpose(2, 0, 1))
    if not np.array_equal(crf_model(rgb, unary), crf_model(rgb, unary)):
        raise AssertionError("selftrain (e): the CRF gave two answers")
    pyramids = check_pyramids_card_against_cpu(torch)
    launches = {k: v for k, v in {**fused.LAUNCHES, **dc.LAUNCHES}.items()
                if v}
    if launches:
        raise AssertionError(f"selftrain (e): kernels launched: {launches}")
    log("selftrain", f"(e) checks ok: the walk at n = {n} (a 500 x 375 "
        f"image's grid) against float64 on the card, max_abs_err "
        f"{walk_err:.3e} (rtol {WALK_RTOL}; float32 {f32_ms:.2f} ms, "
        f"float64 {f64_ms:.2f} ms); card vs CPU float32 (crop 128, stride "
        f"64, 192 x 160, scales (0.75, 1) x flips): KNN members' clusters "
        f"equal but {pyramids['knn'][2]} k-means near-tie pixels (float64 "
        f"gap < {KMEANS_TIE_GAP}), outside the base pixels they feed the "
        f"probabilities' max_abs_err {pyramids['knn'][0]:.3e} (rtol "
        f"{KNN_PROB_RTOL}) and labels equal but {pyramids['knn'][1]} "
        "near-ties; softmax "
        f"{pyramids['softmax'][0]:.3e} (rtol {SOFTMAX_PROB_RTOL}), labels "
        f"equal but {pyramids['softmax'][1]} near-ties; the CRF the same "
        "twice; no SegSort or K10 launch in the phase")

    # (f) the split, on the 4 test images once more
    times = time_selftrain(torch, eng, memory, seng, peng, items, crf_model,
                           infer)
    peak = torch.cuda.max_memory_allocated()
    log("selftrain", "panoptic_deeplab_101 bf16, 4 images of 500 x 375 / "
        "375 x 500 (512 on the larger side for KNN and softmax), ms/image, "
        "each stage ended by a synchronize: KNN MSC + CRF "
        f"{times['pyramid'] + times['download'] + times['crf']:.2f} (device "
        f"pyramid {times['pyramid']:.2f}, float16 download "
        f"{times['download']:.2f}, host resize + CRF {times['crf']:.2f}); "
        f"softmax MSC pyramid {times['softmax']:.2f}; pseudo-label step "
        f"{sum(times[k] for k in PSEUDO_STAGES):.2f} (forward "
        f"{times['forward']:.2f}, affinity {times['affinity']:.2f}, walk "
        f"{times['walk']:.2f}, CRF {times['pseudo_crf']:.2f}); runner "
        "wall s, model build included: "
        + ", ".join(f"{k} {v[0]:.1f}" for k, v in runs.items())
        + f"; peak memory {peak / 2**30:.2f} GiB ({held / 2**30:.2f} held "
        f"as the phase began); phase {time.perf_counter() - t_phase:.1f} s; "
        f"card {nvidia_smi_line()}")


def log_native_item():
    """The JAX package's fused C++ train item (native/dataio) is not
    ported: it needs libjpeg's and libpng's headers, which the card's
    machine lacks. The driver line says so from this host's own probe."""
    from spml_tpu_torch.tools import dataio_probe

    missing = dataio_probe.missing_headers()
    log("driver", "C++ train item (native/dataio): not ported, every item "
        "through the Python path; headers g++ cannot include here: "
        f"{', '.join(missing) or 'none'} "
        "(spml_tpu_torch/tools/dataio_probe.py)")


TRACE_START, TRACE_STEPS = 1, 2  # tpu.profile_start, tpu.profile_steps
# the kernels of csrc/segsort_joint.cu a trace names: (template, family
# argument, DP argument (SQUARE for the stats), BF argument) -> launch
# counter; the family is 0 for JOINT
TRACE_KERNEL = re.compile(r"(stats_tile_kernel|grad_tile_kernel)<"
                          r"\s*\d+\s*,\s*(\d+)\s*,\s*(true|false|1|0)\s*,"
                          r"\s*(true|false|1|0)\s*>")
TRACE_FAMILY = {0: "joint", 1: "hard", 2: "set"}


def traced_kernel(name):
    """The launch counter of a SegSort kernel's name in a trace (mangled
    or demangled), or None."""
    m = TRACE_KERNEL.search(kernel_name(name))
    if not m:
        return None
    family = TRACE_FAMILY.get(int(m.group(2)), m.group(2))
    suffix = BF16 if m.group(4) in ("true", "1") else ""  # the operands
    if m.group(1) == "stats_tile_kernel":
        return f"{family}_stats{suffix}"
    dp = m.group(3) in ("true", "1")
    return f"{family}_grad_{'proto' if dp else 'emb'}{suffix}"


def trace_stage1(torch, fused, stage1, args, profile_dir):
    """(c) stage 1 from scratch for 3 iterations with the profiler window
    of tpu.profile_start TRACE_START, profile_steps TRACE_STEPS: one Chrome
    trace in profile_dir holding exactly TRACE_STEPS launches each of K1,
    K2 and K3 (their kernel names read with kernel_name) and no other
    SegSort kernel; K1-K3 launched once a step."""
    import collections
    import copy

    from spml_tpu_torch.train import driver

    cfg = copy.deepcopy(stage1)
    cfg.train.max_iteration = 3
    cfg.train.resume = False
    cfg.tpu.profile_dir = profile_dir
    cfg.tpu.profile_start, cfg.tpu.profile_steps = TRACE_START, TRACE_STEPS
    fused.reset_launch_counts()
    t0 = time.perf_counter()
    driver.train_spml(args, cfg, device=DEVICE)
    launches = {k: v for k, v in fused.LAUNCHES.items() if v}
    files = sorted(os.listdir(profile_dir))
    want_file = (f"steps_{TRACE_START}-{TRACE_START + TRACE_STEPS}"
                 ".pt.trace.json")
    if files != [want_file]:
        raise AssertionError(f"trace: {files} in {profile_dir}, want "
                             f"[{want_file}]")
    path = os.path.join(profile_dir, want_file)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    counts = collections.Counter(
        k for k in (traced_kernel(e["name"]) for e in kernels) if k)
    want = dict.fromkeys(("joint_stats", "joint_grad_emb",
                          "joint_grad_proto"), TRACE_STEPS)
    if dict(counts) != want or launches != dict.fromkeys(want, 3):
        raise AssertionError(f"trace: SegSort kernels {dict(counts)}, want "
                             f"{want}; launches {launches}")
    log("driver", f"profiler window (tpu.profile_start {TRACE_START}, "
        f"profile_steps {TRACE_STEPS}) on stage 1 from scratch, 3 "
        f"iterations in {time.perf_counter() - t0:.1f} s: {path}, "
        f"{os.path.getsize(path) / 2**20:.1f} MiB, {len(events)} events, "
        f"{len(kernels)} kernel launches, K1-K3 {dict(counts)}")


def loader_ms(cfg, dataset_cls, args, batches=8):
    """ms per batch of the driver's loader with nothing consuming it: the
    rate the host makes batches at, prefetch included."""
    from spml_tpu_torch.parallel import mesh as mesh_lib
    from spml_tpu_torch.train import driver

    loader = driver._loader(args, cfg, dataset_cls, mesh_lib.Mesh())
    try:
        t0 = time.perf_counter()
        for _ in range(batches):
            next(loader)
        return (time.perf_counter() - t0) * 1000 / batches
    finally:
        loader.close()


def load_infer_config(stage1):
    """The inference config of the stage-1 snapshot
    (train_spml_scribble.sh:86-100: --kmeans_num_clusters 12,12,
    --label_divisor 2048)."""
    import copy

    cfg = copy.deepcopy(stage1)
    cfg.network.kmeans_num_clusters = (12, 12)
    return cfg


def main() -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--csrc", help="build the kernels from this directory "
                    "in place of spml_tpu_torch/csrc")
    opts = ap.parse_args()
    t_start = time.perf_counter()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on "
              "the card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from spml_tpu_torch.ops import _cuda, dilated_conv as dc
    from spml_tpu_torch.ops import segsort_loss as fused

    if opts.csrc:
        _cuda.CSRC = Path(opts.csrc).resolve()
        log("build", f"kernel sources from {_cuda.CSRC}")
    smi = nvidia_smi_line()
    log("device", f"{smi} | torch {torch.__version__} CUDA "
        f"{torch.version.cuda} | {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    reports = _cuda.build()
    kernels = {src: ptxas_kernels(r) for src, r in reports.items()}
    warnings = [f"{src}: {ln.strip()}" for src, r in reports.items()
                for ln in r.splitlines()
                if any(k in ln for k in ("wgmma", "Performance Loss"))]
    log("build", f"{len(reports)} source(s) in "
        f"{time.perf_counter() - t0:.1f} s; ptxas (registers, spilled "
        "bytes): " + " | ".join(f"{k} {regs} {spill}"
                                for ks in kernels.values()
                                for k, regs, spill in ks)
        + "".join(f" | {w}" for w in warnings))
    segsort = kernels.get("segsort_joint", [])
    tiled = [(k, spill) for k, _, spill in segsort
             if k.startswith(TILED_KERNELS)]
    spilled = [k for k, spill in tiled if spill]
    bf16_forms = {k.split("<")[0] for k, _ in tiled if k.endswith(",1>")}
    if spilled or {k.split("<")[0] for k, _ in tiled} != set(TILED_KERNELS) \
            or bf16_forms != set(TILED_KERNELS):
        raise AssertionError(f"ptxas: tiled kernels (both operand types) "
                             f"spill or are missing: {spilled or tiled}")
    per_row = [k for k, _, _ in segsort if k.startswith(PER_ROW_KERNEL)]
    if per_row and not opts.csrc:  # another checkout's may still hold one
        raise AssertionError(f"ptxas: per-row kernels left: {per_row}")

    errs = check_kernels(torch, fused)
    conv_err = check_dilated_conv(torch, dc)
    launches, times = {}, {}
    for recipe, family in RECIPE_FAMILY.items():
        arms = {}  # operand type -> (ms/step, peak GiB)
        for dtype, (_, suffix) in fused.OPERAND_DTYPES.items():
            path_launches, args, path_grads, arms[dtype] = run_main_path(
                torch, fused, recipe, dtype)
            launches.update({k: path_launches[k]
                             for k in family_keys(family, suffix)})
            times.update(time_kernels(torch, fused, family, args,
                                      path_grads, dtype))
        (ms16, peak16), (ms32, peak32) = arms["bfloat16"], arms["float32"]
        log(recipe, f"tpu.loss_operand_dtype bfloat16: {ms16:.2f} ms/step, "
            f"peak {peak16:.2f} GiB; float32: {ms32:.2f} ms/step, peak "
            f"{peak32:.2f} GiB; card {nvidia_smi_line()}")
    conv_launches = run_probe_path(torch, dc)
    conv_ms, conv_plain, conv_lib, (conv_bound, conv_by) = \
        time_dilated_conv(torch, dc)
    knn_row = run_knn_topk(torch)
    run_remat(torch, fused)
    run_dp(torch, fused)
    run_sp(torch)
    run_sp3(torch)
    knn_row["launches"] = run_inference(torch)
    run_driver(torch, fused, dc)

    err_name = {"stats": "stats", "grad_emb": "dE", "grad_proto": "dP"}
    table = []
    for key, (name, replaces) in KERNELS.items():
        suffix = BF16 if key.endswith(BF16) else ""
        family, kind = key.removesuffix(suffix).split("_", 1)
        ms, plain_ms, (bound_ms, bound_by, f32_ms), path = times[key]
        table.append({
            "name": name, "route": "cuda", "source": SEGSORT_SOURCE,
            "replaces": replaces, "launches": launches[key],
            "max_abs_err": errs[family + suffix][err_name[kind]], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None})
        if key in TENSOR_CORE:  # the bound of the same work in float32
            table[-1]["bound_f32_ms"] = f32_ms
        if path is not None:  # dE, dP on the path's own cotangents
            path_ms, (path_bound, path_by, _), rows = path
            table[-1].update({"path_cotangent_ms": path_ms,
                              "path_cotangent_bound_ms": path_bound,
                              "path_cotangent_bound_by": path_by,
                              "path_cotangent_rows": rows})
    log("total", f"{time.perf_counter() - t_start:.1f} s from the start "
        "to the report")
    name, replaces, source = CONV_KERNEL
    table.append({
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": conv_launches,
        "max_abs_err": conv_err, "ms": conv_ms, "plain_ms": conv_plain,
        "bound_ms": conv_bound, "bound_by": conv_by,
        "library_ms": conv_lib})
    table.append(knn_row)
    print(json.dumps({"kernels": table}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
