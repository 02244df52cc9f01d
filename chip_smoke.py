#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout.  It builds the port's CUDA kernels from
``lightgbm_tpu_torch/csrc`` (one nvcc per source, started together) and,
beside them, the host libraries of ``csrc/host`` (the native reader with
g++, the C API shim with gcc), then (the files it writes go under the
git-ignored ``build/smoke_files``):

1. prints the card (nvidia-smi name and power limit), the build times,
   the Python the shim builds against (Python.h, ``Py_ENABLE_SHARED``,
   ``LIBDIR``) and each kernel's registers / shared memory (nvcc -Xptxas
   -v);
2. holds the histogram kernel (K1) against its plain PyTorch version on
   the CPU bitwise, against float64 sums, and K2 over one leaf against it,
   at the main path's shapes and the edge cases (a dominant bin, u16 x
   5000 bins, 0, 1, 2,049 and 130,001 rows, F = 5 and 29); checks two
   launches are bitwise equal; times kernel, plain version and one
   PyTorch ``index_add_`` call at the main path's shapes and at 2,048,
   16,384, 131,072 and 1M rows, pass 1 and pass 2 apart at the root;
3. prints the search kernels' registers and spills, holds the split-search
   kernel (K3) against its plain version, its [2, 16] rows torch.equal, on
   100 random cases and the crafted ties at F = 28 x 255 bins, on 10 and
   the tie at each of the warp scan's other branches (B = 7: no block
   offsets; 300: the level-1 halves; 600: two segments; 5000: u16 bins,
   levels above 256 blocks), at the LambdaRank path's F = 136 and at
   F = 5000 (above the shared-memory ceiling the kernels had before the
   warp scan), and times both beside
   the one-thread scan's time;
4. holds the record-window histogram (K1') against its plain version and
   against K1 on the unpacked rows, bitwise, at the record route's shapes
   (the 1M-row root, a 60k window at an unaligned begin, u16 bins) and on
   windows at odd begins whose F is not a multiple of k (k = 4 and k = 2,
   u16 x 5000 bins), at the LambdaRank path's width (F = 136: its
   ~1.4M-column root and 16,683 columns at an odd begin), and times it
   beside its plain version and ``index_add_`` there and at 2,048,
   16,384 and 131,072 rows, pass 1 and pass 2 apart at the root;
5. holds the fused subtract + search + buffer update (K4) against its
   plain version, buffer and rows torch.equal, at phase 3's shapes and
   cases (small left and right in turn), and times it beside the
   one-thread scan's time;
6. prints record.cu's registers and spills, holds the record partition
   (K6 compact, K7 place) against its plain versions on the 1M-row root
   window, a 60k interior window at an unaligned begin, all-left,
   all-right, a ragged last tile, windows at begin % 4 = 1, 2 and 3 of
   lengths that are not multiples of 4, windows of 1, 3, 5, 400, 513 and
   16,683 columns, a window whose middle tiles are all left then all
   right, a u16 record with an odd number of carried rows, a W = 505
   record (F = 2000) and the 2^24-column envelope (32,768 tiles): the
   whole record after the split bitwise, rows outside the window
   untouched, K6's run lanes and counts == the plain version's; times K6
   and K7 (call and device ms) at the root, 16,683 and 400 columns beside
   their times before the redesign and their byte bounds;
7. holds the mega route's split step (K8) against its plain version,
   bitwise (comp's valid lanes, counts, the buffer rows, the search rows,
   nleft), with two launches bitwise equal, on the 1M-row root window, a
   60k interior window at an unaligned begin, a 6,000-column window,
   all-left, all-right, a ragged last tile, a one-tile window, 2,049
   columns at an odd begin, a categorical split, u16 x 300 bins, ~90 % of
   every feature's columns in one bin, u16 x 5000 bins (several count-
   table passes, a four-level scan), F = 29 with u16 bins (k = 2) and
   crafted equal gains across bins and features (the winner must be the
   smallest feature and the largest threshold), a 16,683-column window,
   and at the LambdaRank path's width (F = 136, u8 bins, a 39-word
   record) the 1M-column root, a 16,683-column window and a ragged one;
   runs K7 on K8's output and holds the record bitwise against
   the plain placement, rows outside the window untouched, and times K7
   there at the root, 16,683 and 400 columns; prints the resident grid
   (blocks an SM) and K8's registers and spills, and times K8 at 1M,
   60,000, 6,000 and 400 columns beside its times before the redesign,
   and at F = 136 at the root and on 16,683 columns;
8. trains the bench model (bench.py's config: binary, 1M x 28 HIGGS-like
   rows from seed 7 plus 200k valid rows, 255 bins, 255 leaves) through
   ``lightgbm_tpu_torch``'s entry points on the three routes in turn: the
   mega route (the default on the card), the record route
   (``LGBM_TPU_FUSE_HIST=0``) and the order route (``LGBM_TPU_OPT_HISTS=0``):
   one warm tree, then 10 timed trees each; checks every kernel of the
   route launched the expected number of times and no other, the host
   syncs per tree, and that train/valid AUC land in the band the JAX
   package recorded for the same data and config;
   then trains it with ``tree_growth=depthwise`` (the level histogram K1''
   once per level), depthwise under ``LGBM_TPU_HIST_KERNEL=bsub`` (K2 in
   its place; trees bitwise the v1 run's) and ``tree_growth=hybrid``
   (K1'' per phase-1 level and for the resume, then K1 + K3 per split):
   the same checks, each growth's AUC against the JAX package's for the
   same growth;
9. grows 2 trees at 100k rows on the card on all three routes and on the
   CPU (plain versions) on the order and mega routes: the record and order
   routes must be bitwise equal on the card in every tree field and in the
   train scores and structurally identical to the CPU order route, and the
   card's mega route structurally identical to the CPU's; depthwise and
   hybrid trees on the card structurally identical to the CPU's; under
   ``bsub``, depthwise and leaf-wise (the order route, K2 + K3) trees
   bitwise equal to the v1 runs';
10. (run between 7 and 8, on the bench data) holds the level histogram K1''
   against its plain version bitwise at the bench shape with the leaf ids
   of a real depthwise level (255 leaves, most of them empty), with one
   leaf, with u16 x 300 bins, with ~90 % of every feature's rows in one
   bin and with u16 x 5000 bins (more than its count table holds); its
   chunk table bitwise against ``level_layout``'s; two launches bitwise
   equal; K2 bitwise equal to K1'', and K2 with one leaf to K1; times K1'',
   K2, ``level_layout`` and the sort alone, the plain version and one
   ``index_add_`` on leaf-bin keys at the real level and the dominant bin;
11. holds the pooled split step (K5) against its plain version, bitwise
   (the whole pool and the search rows), with the parent resident in its
   slot and recomputed, for both values of ``small_is_left``: at the bench
   shape on 25 cases, at phase 3's other shapes and at F=2000 x 256 bins;
   holds K3 and K4 at F=2000 against their plain versions, bitwise; times
   K5 at the bench shape and K3, K4 and K5 at F=2000 beside the one-thread
   scan's times;
12. writes windows back into a record with K9 through
   ``ops/record.write_window`` at begin 0, 1, 37, 500 and 511 and at two
   begins the call clamps, and at begins 0-3 on records of 16 rows whose
   length is not a multiple of 4 and of one row, with window widths that
   are not multiples of 4; holds each record bitwise against the plain
   version (``copy_`` on the CPU) and against ``copy_`` into the same
   slice on the card; times K9 and ``copy_`` (its plain version and the
   one library call) on a 1M-column window of the bench record's 12 rows
   at begin 0 and 37, as calls and as device time;
13. (run with phase 8) the ``pooled`` main path: the bench model with
   ``histogram_pool_size=4`` (48 slots of 85,680 B against 255 leaves),
   checked for its exact launches (K1 = trees + splits + recomputes, K3 =
   trees, K5 = splits), 2 + 2 * splits host syncs, recomputes > 0 and its
   AUC against the JAX package's pooled AUC on the CPU; phase 9 adds the
   pooled route on the card against the CPU's plain pooled step, and on
   exact-sum data (grad in {+-1, +-0.5}, hess 1) pooled trees (both steps)
   bitwise equal to unpooled ones in every tree field; then a wide run: n =
   4096, F = 2000, max_bin 256, 255 leaves, ``histogram_pool_size=64`` (10
   slots; an unpooled buffer would be 1.57 GB), 2 trees, with its peak
   device memory;
14-16. the main paths of the other objectives, each on the default (mega)
   route at full width: regression (bench rows, 1M + 200k x 28, the
   target of ``synthetic.regression_labels``, 10 trees), five-class
   multiclass (the same rows, ``synthetic.multiclass_labels``, 4
   iterations = 20 trees) and LambdaRank (``synthetic.rank_data``: 10,000
   MSLR-WEB10K-shaped queries, ~1.4M rows x 136 features, 31 leaves, 10
   trees): counts set to 0 just before the iterations and read just
   after (K1' and K3 once a tree, K8 and K7 once a split, 2 + splits host
   syncs a tree); the gradients' ms an iteration and the peak memory of
   one call; the card's gradients against the plain version's on the
   CPU (bitwise; LambdaRank to rtol 1e-5 on 1,000 queries and every query
   of 600 rows or more); train (and valid) RMSE within 0.5 % and NDCG@1/3/5
   within +-0.005 of the JAX package's on the same data
   (``tools/jax_growth_auc.py --objective``); multiclass predictions' rows
   summing to 1 within 1e-6.  Multiclass at 1M rows prints both packages'
   metrics and the first iteration's root-sum shortfall and off leaves
   (ROADMAP C3: the metrics are float32 noise there in both packages)
   and fails unless leaf 0, the leaf that shortfall lands on, is the
   only leaf of any class's first tree off its Newton step; then runs again at 300k + 60k rows, where multi_logloss and
   multi_error are held within +-0.005 of the JAX package's;
17. (run after phase 8, on the bench data, on the default mega route) the
   training API: (a) ``train`` with the training and valid sets in
   ``valid_sets`` (binary_logloss and auc), 40 rounds, ``learning_rates``
   0.1 x 20 then 4.0 x 20, ``early_stopping_rounds=3`` and
   ``evals_result``: it stops before round 40 at the best round the
   callback's rule gives on the recorded history, ``predict`` defaults to
   it bitwise, and its first 20 trees' text equals a plain 20-round
   ``train``'s (timed beside it, with host syncs, peak memory and K8/K7
   launches); (b) 10 trees saved to a file, continued for 10 more: the
   replayed valid scores bitwise the 10-tree booster's, and the 20 trees'
   text the plain run's; (c) an ``fobj`` returning the built-in
   gradients grows the plain run's first 10 trees bitwise, and five-class
   multiclass at 300k rows does for 2 iterations; (d) ``snapshot_state``
   / ``restore_state`` replays 3 iterations bitwise under bagging 0.8 and
   feature_fraction 0.9; (e) ``rollback_one_iter`` restores the scores
   within 1e-6; (f) a 3-fold stratified ``cv`` of 5 rounds, whose means
   equal the fold boosters' own ``eval_valid`` means.

18. (run after phase 17, on the bench data, on the default mega route)
   prediction and serving: (a) the bench model at 100 trees; kernel P1
   (``csrc/predict.cu``) held bitwise against its plain version on the
   card, sums and leaf indices, on all 1.2M rows in the chunked order
   (``GBDT._iter_chunk``), at ``num_iteration=37``, on rows with NaN,
   +-inf and +-3e9 in five features, a five-class model (300k rows, 4
   iterations), a model with a categorical feature holding NaN, one-leaf
   trees and a 7-leaf continuation of a 31-leaf model; and in P1's other
   configurations: 1 and 8 rows (one tree a thread), 32 rows a block with
   chunks of 3 iterations (group boundaries inside chunks; records through
   L1 and staged) and the bench trees' columns spread over 5,000
   features at 1,024 rows (tiled) and 4,096 rows (X read from global
   memory); the valid AUC from ``predict`` against the one training
   reported; ``Booster.predict`` on 1M rows timed (wall, rows/s, P1
   launches and synchronizing calls a call) beside P1's and the plain
   version's device ms and P1's bound, its wall split into stages (input
   to float64, float32, host-to-device copy, P1, copy back, float64 and
   transform); P1's ms a call and kernel device ms (profiler), node visits
   a second and PR 13's time at 1M rows (sums and leaves) and at 1, 8,
   128 and 1,024 rows; the same 100 trees walked by kernel P2 over the
   binned rows, update mode over the 1M training rows (an init model's
   replay) and replay mode over the 200k valid rows, each held bitwise
   against its plain version and timed (ms a call, device ms, visits a
   second) beside P1 on the same trees;
   (b) the model saved with its ``.sha256`` sidecar, loaded into a
   ``ServingEngine`` (buckets 8 ... 1024) behind a ``MicroBatchQueue``:
   8 client threads x 250 requests of 1, 7, 64, 300 and 1,024 rows,
   every response bitwise ``Booster.predict`` of its rows, no kernel
   built after prewarm, ``memory_reserved`` flat; p50/p99 latency,
   requests/s, rows/s and the dispatch's P1 and host ms at 1, 8, 128 and
   1,024 rows;
   (c) a hot-swap under load to a 120-tree continuation, every response
   the offline answer of the model its ``model_id`` names; (d) 100
   ``POST /v1/predict`` over HTTP, ``/v1/healthz`` and ``/metrics``.

19. (run after phases 14-16) files, the CLI, the batch tier, ``task=serve``
   and sklearn at the bench width: the bench data (1M + 200k rows x 28
   features) written as ``%.17g`` CSV by a pool of processes (timed
   apart); the parse rate of the native reader (``native.py``, OpenMP,
   its threads and the OpenMP runtimes mapped printed beside the host's
   CPUs) and of the numpy parser (``LIGHTGBM_TPU_NO_NATIVE=1``), one-shot
   and streamed, both bitwise the written floats; ``cli.main``
   training from a ``train.conf`` of the reference's keys (one-shot
   load, ``use_two_round_loading`` writing the binary cache, then the
   cache): each model text bitwise the in-memory model of phase 8's mega
   route (the same data and parameters), with load, its stages (parse,
   bin finding, encode, labels and masks, the cache) and s/tree beside
   phase 8's mega s/tree; no bench file handed to numpy
   (``native_fallbacks``); ``task=predict`` and
   ``pipelined_predict_file`` (its reader / P1 / writer stage times) equal
   to ``format_block`` of ``Booster.predict``; ``task=serve`` answering
   ``POST /v1/predict`` with the offline answers, then draining; an
   ``LGBMClassifier`` (this machine has no scikit-learn) with the same
   model text and ``predict_proba == predict``;
23. (run after phase 19, on its files) the C API: the shim
   (``csrc/host/lgbm_capi.c``, built in phase 1 beside the native reader)
   loaded with ctypes, ``LGBM_DatasetCreateFromFile`` on the train CSV
   and on the valid CSV with the train handle as reference (no hand-off
   to numpy; load stages), ``BoosterCreate``, ``AddValidData``, TREES
   ``UpdateOneIter`` with every count set to 0 just before (phase 8's
   mega launches, K8 = K7 = 2540, K1' = K3 = 10, and one P2 launch a
   tree for the valid set), ``GetEval``, ``SaveModel`` bitwise phase 8's
   mega model, ``PredictForMat`` on the valid rows bitwise
   ``Booster.predict`` and ``PredictForFile`` bitwise ``task=predict``'s
   result file;
20. sparse depthwise at Allstate's width (1M rows, cut from 13.18M; 4,228
   one-hot columns in 33 categorical groups, 33 stored entries a row,
   density 0.0078): 10 depthwise trees of 255 leaves through kernel S1
   (``csrc/sparse_histogram.cu``), S1 held bitwise against its plain
   version at every level of the first tree on the tree's own leaf ids,
   on the 500k-row default-bin case (relative error under 2e-5 against
   float64), on uint16 x 300 bins, on 64-entry segments, on 200 leaves x
   300 uint16 bins in 512-entry segments (four leaf tiles, each folded),
   on wide-bin features of two segments at 128 leaves (the fold adds the
   remainder of each of two tiles) and on a level whose leaves are two
   thirds empty, and timed at a wide-bin shape (1M rows x 1,000 features
   of 255 bins, 20 entries a row, at 16 and 128 leaves: one and two leaf
   tiles); a
   100k-row LibSVM file of the same rows binned like the CSR ingest; the
   dense K1'' route (``sparse_hist_density=0``) trained beside it for
   DENSE_TREES trees, its train and valid AUC within 0.005 of the S1
   route's at as many trees; the ms a level of S1 and of K1'' (on the 4.2
   GB dense bins), the byte bound of S1 and the ms of ``index_add_`` over
   the stored entries.

21. (run after phase 17, on the bench data, on the default mega route)
   DART and kernel P2 (``csrc/predict_binned.cu``, every binned walk of
   training): DART with its default drop parameters for
   ``synthetic.DART_ROUNDS`` (30) rounds with the valid set, its trees,
   drop sets and scores bitwise the same run's with P2 swapped for its
   plain version, P2 launched once a round (the new tree over the valid
   rows) and three times more in a round with drops (the drop and the
   renormalisation of the train scores, the valid adjustment), the
   learner's host syncs unchanged (2 + splits a tree), every P2 call
   (table build and launch) under ``torch.cuda.set_sync_debug_mode
   ("error")`` and counted (a table build a new tree and one a round
   with drops, an update call a launch), train and valid AUC within +-0.005 of the JAX package's
   DART (``tools/jax_growth_auc.py --boosting dart``), s/tree beside
   phase 8's and peak memory; P2 held bitwise against its plain version
   (two launches equal) on the 1M training rows, the 200k valid rows,
   replay mode in chunks of 7 and 30 iterations, uint16 x 300 bins,
   stumps and categorical nodes, K = 5 in both modes (class offsets 0, 2
   and 4), every scale DART and rollback give, and in every kind of
   configuration ``p2_config`` picks, each reached by its shape: 256
   rows one a thread with the records staged (the bench rows) or through
   L1 (the trees' columns spread over 136 uint8 features), tree slots
   over 1, 255, 257 and 3,000 rows and at 128 rows (136 uint16 features),
   the bins from global memory at 2,000 features (one tree at 256 rows,
   a quarter of the list with tree slots);
   P2's ms a call and device ms beside its byte bound, P2's before its
   redesign, its plain version's and the per-tree reference walk's
   (``predict_binned``); the table build of a new tree (ms, device
   events); one P2 call traced with ``torch.profiler``, a spin kernel
   before and after it to tell a complete trace from a short one (in a
   fresh process, ``chip_smoke.py --p2-trace``, when none of ten here is
   complete): one P2 kernel and no host-to-device copy; P2 calls with
   every host upload
   (pinned memory, ``models/tree.upload``, ``Tensor.to`` / ``copy_``)
   made to raise; continued training from the
   DART model file (the init model's replay, the valid replay, one
   iteration and a rollback: five P2 launches) bitwise the plain
   version's; and the three non-finite guards under ``nan_grads:1`` at
   100k rows.

22. (run after phase 21, on the bench data) float64 histograms
   (``hist_dtype=float64``) and their kernels K1-f64, K1''-f64 and K3-f64
   (``csrc/histogram.cu``, ``level_histogram.cu``, ``search.cu``): K1-f64
   bitwise its plain version on the CPU (two launches equal, every
   feature's counts summing to the rows) at the 1M-row root of the bench
   bins, 0, 1, 2,049, 16,384 (one group of chunks), 18,433 and 130,001
   rows, ~90 % of every feature's rows in one bin (its pass 1 timed),
   u16 x 5000 bins (100,000 rows, the bin sort's bin-range passes, and
   140,000 rows, the walk's) and F = 5 / 29 (70,001 rows, and F = 29 again
   at 140,001; the bin sort below 131,072 rows, the walk from there, each
   reached); K1''-f64 on a real level's leaf ids
   in 255 leaf slots, two thirds of 40 leaves empty, leaves of 8, 9 and 17
   chunks (and of one chunk, one row and none) and u16 x 5000 bins, its
   chunk and group tables ``level_layout``'s; K3-f64 on phase 3's cases
   in float64, on each side of its size switch (one cluster, the
   ticketed grid): its root form's rows, and its step form's rows and
   written buffer (small left and right, a resident and a recomputed
   parent), torch.equal to the plain versions' on the CPU; each timed (ms
   a call, device ms, byte bound and share) beside its plain version, its
   float32 kernel and, for the histograms, one float64 ``index_add_``
   (K3-f64 both forms and both branches, beside the composition its step
   form replaced), with PR 19's sorted design's numbers from PERF.md
   printed beside for reference (K1-f64 with its passes and its scratch
   bytes, the wrapper's allocation);
   then the bench model with ``hist_dtype=float64`` leaf-wise (10 trees:
   K1-f64 = trees + splits, K3-f64's root form = trees, its step form =
   splits, no other kernel, 2 + 2 * splits host syncs a tree, AUC within
   +-0.005 of the JAX package's float64 run), depthwise (10 trees:
   K1''-f64 once a level, AUC within +-0.005 of the float32 depthwise
   reference at 10 trees; the JAX package's float64 depthwise grower
   raises, ROADMAP C9), pooled (24 slots of 8-byte cells: K1-f64 also for
   each rebuilt parent, the step form through ``search2_pool``; AUC within
   +-0.005 of the JAX package's float64 pooled run) and hybrid (K1''-f64
   a level and once for the resume, then K1-f64 and the step form a
   split; AUC within +-0.005 of the float32 hybrid reference, C9), with
   the plain versions made to raise; then
   2**24 + 2**20 = 17,825,792 bench-shaped rows drawn on the card: float32
   refused naming hist_dtype=float64, float64 trains 2 leaf-wise and 2
   depthwise trees on the float64 kernels only, every leaf count equal to
   the rows reaching it (exact, and its float32 rounding), K1-f64's root
   counts summing to the rows for every feature and its sums equal to
   ``np.bincount`` in float64 within rtol 1e-12; P1's walk of the raw
   rows agreeing row for row with training's leaves once each threshold
   that float32 rounded above its float64 bin bound is lowered to the
   float32 below it (ROADMAP C10; the model's own walk differs on the
   rows equal to such a threshold, printed); s/tree, peak memory and
   K1-f64's root ms there, the scratch its wrapper allocates held to at
   most 1/8 of a partial a chunk (PR 19's design).
24. The forest (after phase 17, on its data; (f) after phase 19, on its
   files): F1 and F3 (csrc/forest.cu) bitwise their plain versions on
   the CPU, in both forms: the root forms, two launches equal, at 1-64
   lanes, 100 / 2,048 / 5,000 / 1M rows, u8 and u16 bins, F = 28 and
   136, idle lanes, empty targets and lanes with no feature; the step
   forms (``ForestStep``: the partition, the smaller children and their
   left counts, the buffer rows and the search rows), two ForestSteps
   equal, at 8 and 64 lanes, with inactive lanes, ties, categorical
   splits, u16 bins, F = 136 and 64 lanes x 1M rows, the scratch sized
   from the step's parents; each form timed a call and on the device
   beside its plain version (F1's root form also beside one
   ``index_add_``); (b) ``train_many`` of 8 models (learning
   rate, ``lambda_l2``, ``feature_fraction`` and seeds varied) over the
   bench's first 2,048 rows, 31 leaves, 50 rounds, as lanes and as
   sequential rounds on the order route (model strings bitwise) and on
   the mega route (printed), each with s/round, host syncs, F1/F3
   launches a round, the device idle share, the lanes' device events a
   step and peak memory; (c) 5-class
   multiclass on those rows, 20 iterations, lanes bitwise the class
   loop; (d) 4 models at 1M rows x 255 leaves, 3 rounds, lanes bitwise
   sequential (order route); (e) phase 17's bin-once cv folds bitwise
   the subset-trained folds, their ``-mean`` metrics equal, with the
   binned bytes each uploads; (f) ``task=train_many`` (3 models, 5
   iterations) on ``valid.csv``, model i bitwise ``task=train seed=i``.
25. Checkpoints, resume and the fleet (after phase 24 (f), on phase
   19's files and phase 18's model, before phase 23 removes the files):
   (a) the route matrix: 100k bench rows x 28, 63 leaves, a checkpoint
   after 3 of 6 trees written to a file and restored into a new booster
   (with the valid set) on the mega, record, order, pooled, depthwise,
   hybrid, float64 leaf-wise, DART-with-bagging, multiclass-lanes (2,048
   rows) and multiclass class-loop routes: the model text bitwise the
   uninterrupted run's and the resumed trees' launches equal to its
   (every kernel of the route launched); (b) ``python -m
   lightgbm_tpu_torch`` on phase 19's train.conf with ``snapshot_freq=3``,
   two processes at a time: killed by ``LGBM_TPU_FAULT=kill_after_tree:4``
   and by an external SIGTERM after an iteration drawn from a printed
   seed, each exits 75 with no model, and its ``--resume`` writes phase
   19's model-one-shot.txt byte for byte on the card (its manifest's
   backend), with the checkpoint's bytes and seconds (and of them the
   host sync and device reads) and the resume's seconds; (c)
   ``ReplicaSupervisor(subprocess_factory(...), replicas=2)`` behind a
   ``FleetFrontEnd`` over phase 18's bench100.txt: 4 clients x 100
   requests of 1-64 valid rows, replica 0 SIGKILLed after 50 answers,
   no request failed, every answer bitwise ``Booster.predict`` of its
   rows, at least one restart, the replacement's seconds to ready and
   the front end's p50 / p99, then ``stop()``: both replicas exit 75.

26. The parallel learners (after phase 20, on the bench data made anew):
   (a) a one-rank NCCL world in this process at the bench's full width
   (255 leaves): the data-parallel learner (record route) grows 3 trees
   on an exact-sum copy of the gradients (integers in [-4, 4], unit
   hessians), each bitwise the serial record route's tree and leaf ids,
   with exactly K1' = K3 = 1 + S and K6 = K7 = S launches, 3 + 2S host
   syncs and the census's 3 collectives a split plus the root's 3 and
   the leaf ids' (S splits); then 3 trees from the serial run's
   gradients (at most one divergent node a tree against the serial
   learner grown from the same gradients and the root totals the world
   reduced; the divergence from the mega route's trees printed) and 3
   bench trees through the training API (train / valid AUC within 0.005
   of the serial run's); the group is destroyed.  (b) four rank
   processes sharing cuda:0 over gloo (``--parallel-rank R 4 PORT``),
   one world, each making the bench data from its seed: the
   data-parallel learner leaf-wise, depthwise and hybrid, feature,
   voting (``top_k`` 20 and 5) and a 2 x 2 grid at 15 leaves (a
   collective of four processes time-slicing one card costs
   milliseconds: 255 leaves took ~9 s a tree), 3 trees each through the
   API (the same trees and AUC on every rank, within 0.005 of serial;
   each rank's launches, host syncs and collectives exactly those the
   learner's route makes for the trees it grew), from the serial run's
   gradients (at most one divergent node a tree against the serial
   learner given the root totals the world reduced, as in (a); not for
   ``top_k`` 5, which selects 10 of 28 features) and on the exact-sum
   copy (bitwise the serial trees and leaf ids; not for ``top_k`` 5);
   prints s/tree, the collectives a tree and their ms, host syncs a
   tree, each rank's launches a tree, the peak device memory of each
   rank and a tiny all-gather's ms on the card's tensors.  Every
   learner of (b) also runs the desync sentinel: one host read of the
   tree and one all-gather a tree beyond its route's counts.

27. Multihost and the training gang (after phase 25, before phase 23
   empties phase 19's files), every rank a ``python -m
   lightgbm_tpu_torch`` child on the card, in two waves.  Wave 1: (a)
   ``task=train_fleet`` of phase 19's train.conf (1M + 200k rows, 255
   leaves, 10 trees), 2 redundant ranks, checkpoint barriers every 2
   trees, slot 1 SIGKILLed at iteration 5 (``LGBM_TPU_GANG_CHAOS_KILL``):
   exit 0, both ranks' models bitwise phase 19's one-shot model, one
   restart, ``failed_iterations`` 0, the MTTR and the gang's readiness
   times, each rank's K8 / K7 / K1' / K3 launches and host syncs from
   its rank snapshot exactly the mega route's for the trees it grew;
   (c1) a 2-rank ``machine_list_file`` world on 127.0.0.1 sharing
   cuda:0 over gloo on the valid file (63 leaves, 4 trees), rank 1 with
   another ``bagging_seed`` and ``delay_collective:1:200``, and (c2) the
   same training from torchrun's env: one model on every rank of both
   worlds, each rank's launches, host syncs and census exactly the
   record route's plus one sentinel check a tree, rank 0's merged
   manifest naming rank 1 the straggler, the sentinel's and the config
   sync's ms.  Wave 2: (b) ``gang_shard_data=true`` on the valid file
   (one parity check, each rank's model bitwise ``task=train`` of its
   shard), (c3) ranks that differ in ``num_leaves`` (both exit non-zero
   at the config sync, naming the fingerprints), (c4) ``desync_step:1``
   (both stop naming rank 1 at iteration 1).  The rank children's
   launches are added to the kernels' record as ``multihost_launches``.

28. The rest of obs (after phase 22, on the bench data; (b) after phase
   27, on phase 19's files): (a) ``obs/device_time.trace_phases`` around
   3 trees of a mega booster at the bench width (launches and host syncs
   exactly the route's), the phase buckets beside per-kernel sums, >= 90 %
   of the trace's kernel time in named phases and the buckets summing to
   its device time within 1 %; ``oom_dispatch`` at ``train_one_iter``
   leaving an ``oom`` post-mortem with the census and the memory model's
   prediction; the census's ``dataset`` and ``scores`` owners within
   max(20 %, 8 KiB) of ``obs/memmodel``; (b) one ``task=train
   profile=true`` CLI run (3 trees) whose manifest's ``phases`` has
   histogram, partition and split-search seconds; (c) every earlier run's
   measured peak beside the model's largest training phase, held within
   20 % on mega, record, order, float64 leaf-wise and forest (d).

The seconds each phase took are printed before the result.

Every phase must pass or the script exits non-zero without a result.  The
line before the last is the kernels' JSON record, the last line the
device record.  Without a CUDA card, or without the package beside it, it
exits non-zero.  Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# bench.py:57-64 — the driver workload
N_FEAT, NUM_BINS, NUM_LEAVES = 28, 255, 255
LEARNING_RATE, MIN_DATA = 0.1, 100
ROWS, VALID_ROWS, TREES = 1_000_000, 200_000, 10
# train/valid AUC of the JAX package on the same data and config: leaf-wise
# from BENCH_r05; depthwise and hybrid from the JAX package on the CPU,
#   JAX_PLATFORMS=cpu python tools/jax_growth_auc.py --growth depthwise
#   JAX_PLATFORMS=cpu python tools/jax_growth_auc.py --growth hybrid
# and pooled leaf-wise growth (histogram_pool_size=4, 48 slots) the same
# way (37 s on the CPU),
#   JAX_PLATFORMS=cpu python tools/jax_growth_auc.py --growth leafwise \
#       --histogram-pool-size 4
AUC_TRAIN, AUC_VALID, AUC_TOL = 0.8571, 0.8477, 0.005
# and leaf-wise growth under hist_dtype=float64 (44 s on the CPU), pooled
# too (46 s; its 24 slots give the unpooled AUCs),
#   JAX_PLATFORMS=cpu python tools/jax_growth_auc.py --growth leafwise \
#       --hist-dtype float64 [--histogram-pool-size 4]
AUC_REF = {"leafwise": (AUC_TRAIN, AUC_VALID),
           "depthwise": (0.842062, 0.833879),
           "hybrid": (0.852152, 0.843580),
           "pooled": (0.853401, 0.844557),
           "f64-leafwise": (0.853378, 0.844567),
           "f64-pooled": (0.853378, 0.844567)}
K1PP = "K1″"  # the level histogram's launch counter (ops.KERNEL_COUNTERS)
POOL_MB = 4.0  # the pooled main path's histogram_pool_size: 48 slots
RANK_FEAT = 136  # the LambdaRank main path's width (MSLR-WEB10K)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
F32_FLOPS = 67e12  # H100 SXM, float32 outside the tensor cores
STRUCT = ("split_feature", "threshold_bin", "decision_type", "left_child",
          "right_child", "leaf_count", "leaf_parent", "leaf_depth")
TREE_FIELDS = STRUCT + ("split_feature_real", "threshold_real", "split_gain",
                        "internal_value", "internal_count", "leaf_value")


# the card's nvidia-smi name and power limit, set by phase 1 and printed
# beside every line that holds a time
CARD = {"name": ""}
TIMED = re.compile(r"ms\b|_ms=|ms=|s/tree|s/iteration|\d\.?\d*s\b")


def say(msg: str) -> None:
    if CARD["name"] and TIMED.search(msg) and CARD["name"] not in msg:
        msg = f"{msg} [{CARD['name']}]"
    print(msg, flush=True)


PHASE_S = {}  # seconds each phase took, in the order run


def timed(name, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, its wall seconds kept in PHASE_S[name]."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    PHASE_S[name] = round(time.perf_counter() - t0, 3)
    return out


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"FAILED: {what}")


def time_ms(torch, fn, reps: int = 20, warm: int = 3) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` after ``warm``
    calls."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


SPIN_CYCLES = 100_000_000  # 50 ms or more: longer than the enqueue


def queued_ms(torch, fn, calls: int = 50, reps: int = 5) -> float:
    """Device ms a call of ``fn`` with no host in the loop: ``calls`` calls
    enqueued behind a spin kernel (``torch.cuda._sleep``) while the card
    is busy, then run back to back between two CUDA events; the median of
    ``reps`` such runs, over ``calls``.  No CUDA graph (its private memory
    pool would change the caching allocator's state, and so the peaks of
    the phases after this one)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        a.record()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        enqueue_s = time.perf_counter() - t0
        b.record()
        b.synchronize()
        check(enqueue_s < 0.02, f"queued_ms: enqueuing {calls} calls took "
              f"{enqueue_s * 1e3:.1f} ms, not within the spin")
        times.append(a.elapsed_time(b) / calls)
    return statistics.median(times)


# --------------------------------------------------------------- phase 1
def phase_build(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, "nvidia-smi")
    card = smi.stdout.strip().splitlines()[0]
    CARD["name"] = card
    say(f"[device] {card}")
    say(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    import sysconfig

    from lightgbm_tpu_torch.ops import _build

    def host(name):
        t = time.perf_counter()
        _build.build_host(name)
        return time.perf_counter() - t

    t0 = time.perf_counter()
    # the host libraries (native reader, C API shim) build beside nvcc
    with ThreadPoolExecutor(1) as ex:
        hosts = ex.submit(lambda: {n: host(n) for n in _build.HOST_LIBS})
        secs = _build.build_all(force=True)
        secs.update(hosts.result())
    say(f"[build] {json.dumps({k: round(v, 2) for k, v in secs.items()})} "
        f"wall {time.perf_counter() - t0:.2f}s")
    say(f"[build] python {sys.version.split()[0]} Python.h under "
        f"{sysconfig.get_paths()['include']}, Py_ENABLE_SHARED="
        f"{sysconfig.get_config_var('Py_ENABLE_SHARED')} LIBDIR="
        f"{sysconfig.get_config_var('LIBDIR')}: "
        f"{' '.join(_build.python_flags())}")
    for name in _build.SOURCES:
        for line in _build.ptxas_report(name).splitlines():
            if "Compiling entry" in line or "Used" in line or "spill" in line:
                say(f"[ptxas {name}] {line.strip()}")
    return card


# --------------------------------------------------------------- phase 2
SWEEP = (2048, 16_384, 131_072, ROWS)  # K1/K1' row counts timed


def _index_add_fn(torch, bins, g, h, m, B):
    """One ``index_add_`` of the single-leaf sums (the library yardstick)."""
    F = bins.shape[0]
    keys = (bins.to(torch.int64) + torch.arange(F, device="cuda")[:, None]
            * B).reshape(-1)
    src = torch.stack([g * m, h * m, m], -1).repeat(F, 1)
    return lambda: torch.zeros(F * B, 3, device="cuda").index_add_(
        0, keys, src)


def _passes_ms(torch, fn, pass1="sorted_partial", pass2="hist_reduce"):
    """Device ms per call of K1/K1''s pass 1 and pass 2 (profiler; K1-f64's
    pass 1 is ``walk_partial``)."""
    from lightgbm_tpu_torch.profile_slice import device_ms_by_kernel

    dev = device_ms_by_kernel(torch, fn)
    return (sum(v for k, v in dev.items() if pass1 in k),
            sum(v for k, v in dev.items() if pass2 in k))


def phase_histogram(torch):
    """K1 against its plain version, bitwise (on the CPU, and two launches
    on the card), and against float64 sums, with K2 over one leaf equal to
    it, at the main path's shapes and the edge cases; times K1, its plain
    version and ``index_add_`` at the main path's shapes and across row
    counts, pass 1 and pass 2 apart at the root."""
    from lightgbm_tpu_torch.ops import cuda_histogram
    from lightgbm_tpu_torch.ops.histogram import histogram_feature_major

    rng = np.random.RandomState(0)
    # (name, F, cap, B, bin dtype, ~90 % of every feature's rows in one bin,
    #  timed)
    shapes = [("root", 28, ROWS, 255, np.uint8, False, True),
              ("mid-split", 28, 60_000, 255, np.uint8, False, True),
              ("odd", 5, 700, 37, np.uint8, False, True),
              ("uint16", 28, 100_000, 300, np.uint16, False, True),
              ("dominant-bin", 28, ROWS, 255, np.uint8, True, True),
              ("u16x5000", 4, 100_000, 5000, np.uint16, False, False),
              ("rows-1", 28, 1, 255, np.uint8, False, False),
              ("rows-2049", 28, 2049, 255, np.uint8, False, False),
              ("rows-130001", 28, 130_001, 255, np.uint8, False, False),
              ("F5", 5, 70_001, 37, np.uint8, False, False),
              ("F29", 29, 70_001, 255, np.uint8, False, False),
              ("empty", 28, 0, 255, np.uint8, False, False)]
    shapes += [(f"sweep-{n}", 28, n, 255, np.uint8, False, True)
               for n in SWEEP if n != ROWS]
    record = None
    for name, F, cap, B, dt, dominant, timed in shapes:
        b_np = rng.randint(0, B, (F, cap)).astype(dt)
        if dominant:
            b_np[rng.rand(F, cap) < 0.9] = B // 3
        bins = torch.from_numpy(b_np).cuda()
        g = torch.from_numpy(rng.randn(cap).astype(np.float32)).cuda()
        h = torch.from_numpy(np.abs(rng.randn(cap)).astype(np.float32)).cuda()
        m = torch.from_numpy((rng.rand(cap) < 0.8).astype(np.float32)).cuda()
        k1 = cuda_histogram.histogram_single_leaf_cuda(bins, g, h, m, B)
        k2 = cuda_histogram.histogram_single_leaf_cuda(bins, g, h, m, B)
        bsub = cuda_histogram.histogram_single_leaf_bsub_cuda(bins, g, h, m,
                                                              B)
        torch.cuda.synchronize()
        check(torch.equal(k1, k2), f"histogram {name}: launches not bitwise "
              "equal")
        check(torch.equal(bsub, k1), f"histogram {name}: K2 over one leaf "
              "differs from K1")
        cpu = histogram_feature_major(bins.cpu(), g.cpu(), h.cpu(), m.cpu(), B)
        plain_err = float((k1.cpu() - cpu).abs().max()) if cap else 0.0
        check(torch.equal(k1.cpu(), cpu),
              f"histogram {name}: K1 differs from its plain version on the "
              f"CPU (max abs {plain_err})")
        ref = histogram_feature_major(bins, g.double(), h.double(),
                                      m.double(), B)
        absg = histogram_feature_major(bins, g.double().abs(),
                                       h.double().abs(), m.double(), B)
        err = (k1.double() - ref).abs()
        check(torch.equal(k1[..., 2].double(), ref[..., 2]),
              f"histogram {name}: counts differ")
        tol = 1e-5 * absg[..., :2] + 1e-6
        check(bool((err[..., :2] <= tol).all()),
              f"histogram {name}: g/h beyond 1e-5*sum|x| + 1e-6")
        max_err = float(err.max()) if cap else 0.0
        line = (f"[hist {name}] F={F} cap={cap} B={B} {np.dtype(dt).name} "
                f"bitwise: launches, == plain (CPU), K2 one leaf == K1; "
                f"max_abs_err_vs_f64={max_err:.3g}")
        if timed:
            def kernel():
                return cuda_histogram.histogram_single_leaf_cuda(
                    bins, g, h, m, B)

            ms = time_ms(torch, kernel)
            plain_ms = time_ms(torch, lambda: histogram_feature_major(
                bins, g, h, m, B), reps=5, warm=1)
            lib_ms = time_ms(torch, _index_add_fn(torch, bins, g, h, m, B))
            nbytes = F * cap * bins.element_size() + 12 * cap + F * B * 12
            bound = max(nbytes / HBM_BYTES_PER_S,
                        3 * F * cap / F32_FLOPS) * 1e3
            line += (f" ms={ms:.4f} plain_ms={plain_ms:.4f} "
                     f"library_ms={lib_ms:.4f} bound_ms={bound:.5f} "
                     f"share={bound / ms:.4f} "
                     f"faster_than_index_add={ms < lib_ms}")
            if name == "root":
                p1, p2 = _passes_ms(torch, kernel)
                line += f" device pass1_ms={p1:.4f} pass2_ms={p2:.4f}"
                record = dict(max_abs_err=plain_err, ms=ms,
                              plain_ms=plain_ms, bound_ms=bound,
                              library_ms=lib_ms)
        say(line)
        del bins, g, h, m, ref, absg, err, cpu
    return record


# --------------------------------------------------------------- phase 3
# K3/K4/K5's ms a call with the one-thread scan they had before the warp
# scan (chip_smoke.py, PERF.md §6), at F = 28, B = 255 and at F = 2000,
# B = 256 (K4 was not timed there)
SEARCH_PARENT_MS = {("K3", 28): 0.1413, ("K4", 28): 0.2065,
                    ("K5", 28): 0.1720, ("K3", 2000): 1.8964,
                    ("K5", 2000): 3.6206}
# the warp scan's branches F = 28 x 255 bins never reaches: no block offsets
# (7), the level-1 halves (300), two segments (600), u16 bins and the
# levels above 256 blocks (5000)
SCAN_BINS = (7, 300, 600, 5000)
WIDE_F = 5000  # features beyond the shared-memory ceiling K3/K4/K5 had


def _parent_ms(kernel, F):
    ms = SEARCH_PARENT_MS.get((kernel, F))
    return "not timed" if ms is None else f"{ms:.4f}"


def _search_shapes():
    """(F, B, random cases) of phases 3, 5 and 11: the main path's shape,
    the scan's branches, the LambdaRank main path's F = 136 and F = 5000;
    each shape adds its crafted tie."""
    return ([(N_FEAT, NUM_BINS, 100)]
            + [(N_FEAT, b, 10) for b in SCAN_BINS]
            + [(RANK_FEAT, NUM_BINS, 10), (WIDE_F, NUM_BINS, 2)])


def _search_cases(rng, F, B, count=100):
    cases = []
    for _ in range(count):
        hs = []
        for _c in range(2):
            g = rng.randn(F, B).astype(np.float32)
            h = (np.abs(rng.randn(F, B)) + 0.1).astype(np.float32)
            c = rng.randint(1, 50, (F, B)).astype(np.float32)
            hs.append(np.stack([g, h, c], -1))
        iscat = rng.rand(F) < 0.1
        fmask = rng.rand(F) < 0.9
        nbpf = rng.randint(2, B + 1, F).astype(np.int32)
        consts = [float(rng.choice([1.0, 20.0])), float(rng.choice([0.0, 5.0])),
                  float(rng.choice([0.0, 0.5])), float(rng.choice([0.0, 1.0])),
                  0.0]
        cases.append((hs, fmask, nbpf, iscat, consts))
    # exact ties: a feature duplicated (feature asc) and empty bins
    # (bin desc), integer stats so both sides compute identical floats
    g = rng.randint(-8, 9, (F, B)).astype(np.float32)
    hh = rng.randint(1, 5, (F, B)).astype(np.float32)
    c = rng.randint(1, 5, (F, B)).astype(np.float32)
    tie = np.stack([g, hh, c], -1)
    tie[2, :, 0] = np.where(np.arange(B) < B // 2, 32.0, -32.0)
    tie[2, :, 1:] = [1.0, 4.0]
    tie[2, B // 2 - 2:B // 2] = 0.0
    tie[9] = tie[2]
    cases.append(([tie, tie], np.ones(F, bool), np.full(F, B, np.int32),
                  np.zeros(F, bool), [1.0, 0.0, 0.0, 1.0, 0.0]))
    return cases


def _case_tensors(torch, case):
    """A case's two children on the card, its meta and its scal (the leaf
    totals are feature 2's sums)."""
    from lightgbm_tpu_torch.ops import cuda_search

    hs, fmask, nbpf, iscat, consts = case
    hl, hr = (torch.from_numpy(a).cuda() for a in hs)
    meta = cuda_search.pack_meta(torch.from_numpy(fmask),
                                 torch.from_numpy(nbpf),
                                 torch.from_numpy(iscat), "cuda")
    scal = [1.0]
    for hcur in hs:
        scal += [float(v) for v in hcur[2].sum(axis=0)]
    return hl, hr, meta, scal + consts


def _check_tie(rows, B, what):
    """The crafted tie: feature 2 (not its copy 9) at bin B//2 - 1 (the
    largest of three equal thresholds).  Below 64 bins the random features
    can outscore the crafted one (the case is then held bitwise only)."""
    if B >= 64:
        check(int(rows[0, 1]) == 2 and int(rows[0, 2]) == B // 2 - 1,
              f"{what}: tie resolved to {rows[0, 1:3].tolist()}")


def _search_ptxas():
    from lightgbm_tpu_torch.ops import _build

    for line in _build.ptxas_report("search").splitlines():
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            say(f"[search ptxas] {line.strip()}")


def phase_search(torch):
    """K3 against its plain version, its [2, 16] rows torch.equal, at the
    main path's shape (100 random cases and the crafted tie), at the scan's
    branches (B = 7, 300, 600, 5000) and at F = 5000; times both."""
    from lightgbm_tpu_torch.ops import cuda_search
    from lightgbm_tpu_torch.ops.split import search2_rows

    rng = np.random.RandomState(1)
    _search_ptxas()
    n = 0
    for F, B, count in _search_shapes():
        for case in _search_cases(rng, F, B, count):
            hl, hr, meta, scal = _case_tensors(torch, case)
            k = cuda_search._search2_rows_cuda(hl, hr, scal, meta)
            p = search2_rows(hl, hr, scal, meta)
            check(torch.equal(k, p), f"K3 F={F} B={B}: rows differ from the "
                  f"plain version's:\n{k.tolist()}\n{p.tolist()}")
            n += 1
        _check_tie(k, B, f"K3 F={F} B={B}")  # the last case is the tie
        if (F, B) == (N_FEAT, NUM_BINS):
            ms = time_ms(torch, lambda: cuda_search._search2_rows_cuda(
                hl, hr, scal, meta))
            plain_ms = time_ms(torch, lambda: search2_rows(hl, hr, scal,
                                                           meta))
    F, B = N_FEAT, NUM_BINS
    nbytes = 2 * F * B * 12 + F * 16 + 2 * 16 * 4
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    say(f"[search] cases={n} rows torch.equal plain (F=28 x B=255, "
        f"B={'/'.join(map(str, SCAN_BINS))}, F={RANK_FEAT}/{WIDE_F}) "
        f"ms={ms:.4f} "
        f"parent_ms={_parent_ms('K3', F)} plain_ms={plain_ms:.4f} "
        f"bound_ms={bound:.6f}")
    return dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                library_ms=None)


# --------------------------------------------------------------- phase 4
def _random_record(torch, rng, F, n, B, dt):
    from lightgbm_tpu_torch.ops.record import build_record

    bins = torch.from_numpy(rng.randint(0, B, (F, n)).astype(dt)).cuda()
    g = torch.from_numpy(rng.randn(n).astype(np.float32)).cuda()
    h = torch.from_numpy(np.abs(rng.randn(n)).astype(np.float32)).cuda()
    m = torch.from_numpy((rng.rand(n) < 0.8).astype(np.float32)).cuda()
    return bins, g, h, m, build_record(bins, g, h, m)


def phase_record_histogram(torch):
    from lightgbm_tpu_torch.ops import cuda_histogram
    from lightgbm_tpu_torch.ops import histogram as plain
    from lightgbm_tpu_torch.ops.histogram import histogram_feature_major
    from lightgbm_tpu_torch.ops.record import bins_per_word, num_words
    from lightgbm_tpu_torch.synthetic import rank_rows

    rng = np.random.RandomState(2)
    # (name, F, record columns, begin, cnt, B, bin dtype, timed); k = 4 for
    # u8 bins, 2 for u16
    shapes = [("root", 28, ROWS, 0, ROWS, 255, np.uint8, True),
              ("mid-split", 28, ROWS, 333_333, 60_000, 255, np.uint8, True),
              ("uint16", 28, 100_000, 0, 100_000, 300, np.uint16, True),
              ("k4-F29", 29, 50_000, 777, 40_001, 255, np.uint8, False),
              ("k2-F5", 5, 50_000, 1001, 30_003, 300, np.uint16, False),
              ("k2-F29-5000", 29, 20_000, 3, 12_345, 5000, np.uint16,
               False)]
    shapes += [(f"sweep-{n}", 28, n + 1001, 1001, n, 255, np.uint8, True)
               for n in SWEEP if n != ROWS]
    # the LambdaRank main path's root (136 u8 features, a 39-word record)
    # and a median window at an odd begin of the same record
    rank_n = rank_rows()
    shapes += [("F136-root", RANK_FEAT, rank_n, 0, rank_n, 255, np.uint8,
                True),
               ("F136-odd-begin", RANK_FEAT, rank_n, 12_347, 16_683, 255,
                np.uint8, False)]
    record, made = None, {}
    for name, F, n, begin, cnt, B, dt, timed in shapes:
        if made.get("key") != (F, n, B, dt):
            made = dict(key=(F, n, B, dt),
                        arrays=_random_record(torch, rng, F, n, B, dt))
        bins, g, h, m, rec = made["arrays"]
        k = bins_per_word(bins.dtype)
        sl = slice(begin, begin + cnt)
        ub, ug, uh, um = (bins[:, sl].contiguous(), g[sl].contiguous(),
                          h[sl].contiguous(), m[sl].contiguous())

        def kernel():
            return cuda_histogram.histogram_record_window_cuda(
                rec, begin, cnt, F, k, B)

        a, b = kernel(), kernel()
        k1 = cuda_histogram.histogram_single_leaf_cuda(ub, ug, uh, um, B)
        torch.cuda.synchronize()
        check(torch.equal(a, b), f"K1' {name}: launches not bitwise equal")
        check(torch.equal(a, k1), f"K1' {name}: differs from K1 on the "
              "unpacked rows")
        cpu = plain.histogram_record_window(rec.cpu(), begin, cnt, F, k, B)
        plain_err = float((a.cpu() - cpu).abs().max())
        check(plain_err == 0.0 and torch.equal(a.cpu(), cpu),
              f"K1' {name}: differs from its plain version")
        ref = histogram_feature_major(ub, ug.double(), uh.double(),
                                      um.double(), B)
        max_err = float((a.double() - ref)[..., :2].abs().max())
        line = (f"[hist-record {name}] F={F} k={k} n={n} begin={begin} "
                f"cnt={cnt} B={B} {np.dtype(dt).name} bitwise: launches, "
                f"==K1, ==plain max_abs_err_vs_plain={plain_err} "
                f"max_abs_err_vs_f64={max_err:.3g}")
        if timed:
            ms = time_ms(torch, kernel)
            plain_ms = time_ms(torch, lambda: plain.histogram_record_window(
                rec, begin, cnt, F, k, B), reps=5, warm=1)
            lib_ms = time_ms(torch, _index_add_fn(torch, ub, ug, uh, um, B))
            nbytes = (num_words(F, k) + 3) * 4 * cnt + F * B * 12
            bound = max(nbytes / HBM_BYTES_PER_S,
                        3 * F * cnt / F32_FLOPS) * 1e3
            line += (f" ms={ms:.4f} plain_ms={plain_ms:.4f} "
                     f"library_ms={lib_ms:.4f} bound_ms={bound:.5f} "
                     f"share={bound / ms:.4f} "
                     f"faster_than_index_add={ms < lib_ms}")
            if name == "root":
                p1, p2 = _passes_ms(torch, kernel)
                line += f" device pass1_ms={p1:.4f} pass2_ms={p2:.4f}"
                record = dict(max_abs_err=plain_err, ms=ms,
                              plain_ms=plain_ms, bound_ms=bound,
                              library_ms=lib_ms)
        say(line)
        del bins, g, h, m, rec, ub, ug, uh, um
    del made
    return record


# --------------------------------------------------------------- phase 5
def phase_search_update(torch):
    """K4 against its plain version, the buffer and the rows torch.equal,
    at phase 3's shapes (small left and right in turn); times both."""
    from lightgbm_tpu_torch.ops import cuda_search
    from lightgbm_tpu_torch.ops.split import search2_update

    rng = np.random.RandomState(3)
    L, parent, new = 4, 1, 3
    n = 0
    for F, B, count in _search_shapes():
        for i, case in enumerate(_search_cases(rng, F, B, count)):
            hl, hr, meta, scal = _case_tensors(torch, case)
            hists = torch.from_numpy(
                rng.randn(L, F, B, 3).astype(np.float32)).cuda()
            hists[parent] = hl + hr
            small_is_left = i % 2 == 0
            small = hl if small_is_left else hr
            hk, hp = hists.clone(), hists.clone()
            k = cuda_search._search2_update_cuda(hk, small, parent, new,
                                                 small_is_left, scal, meta)
            p = search2_update(hp, small, parent, new, small_is_left, scal,
                               meta)
            check(torch.equal(hk, hp), f"K4 F={F} B={B}: updated buffer "
                  "differs from the plain version's")
            check(torch.equal(hk[[0, 2]], hists[[0, 2]]),
                  f"K4 F={F} B={B}: other rows moved")
            check(torch.equal(k, p), f"K4 F={F} B={B}: rows differ from the "
                  f"plain version's:\n{k.tolist()}\n{p.tolist()}")
            n += 1
        # the last case is the crafted tie (small = left = tie, parent = 2
        # tie)
        _check_tie(k, B, f"K4 F={F} B={B}")
        if (F, B) == (N_FEAT, NUM_BINS):
            ms = time_ms(torch, lambda: cuda_search._search2_update_cuda(
                hk, small, parent, new, True, scal, meta))
            plain_ms = time_ms(torch, lambda: search2_update(
                hp, small, parent, new, True, scal, meta))
        del hists, hk, hp
    F, B = N_FEAT, NUM_BINS
    nbytes = 4 * F * B * 12 + F * 16 + 2 * 16 * 4
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    say(f"[search-update] cases={n} buffer and rows torch.equal plain "
        f"(F=28 x B=255, B={'/'.join(map(str, SCAN_BINS))}, "
        f"F={RANK_FEAT}/{WIDE_F}) "
        f"ms={ms:.4f} parent_ms={_parent_ms('K4', F)} "
        f"plain_ms={plain_ms:.4f} bound_ms={bound:.6f}")
    return dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                library_ms=None)


# --------------------------------------------------------------- phase 6
# K6's and K7's (call ms, device ms of every kernel the call launches)
# before their redesign (one thread a column, and K7 with the run-offset
# scan before it, a cumsum and a subtraction) at the windows phases 6 and
# 7 time: tools/partition_variants.py --parent-csrc, its parent run
# (W = 12, begin 0; PERF.md section 6)
PARTITION_PARENT_MS = {("K6", "root"): (0.0900, 0.0457),
                       ("K6", "median"): (0.0655, 0.0030),
                       ("K6", "400"): (0.0413, 0.0027),
                       ("K7", "root"): (0.0992, 0.0483),
                       ("K7", "median"): (0.0891, 0.0066),
                       ("K7", "400"): (0.0695, 0.0057)}
PARTITION_TIMED = {"root": 1_000_000, "median": 16_683, "400": 400}
ENVELOPE = 1 << 24  # the float32 count envelope: nt = 32,768 tiles


def _parent_partition_ms(kernel, name):
    ms = PARTITION_PARENT_MS.get((kernel, name))
    return ("not timed" if ms is None
            else f"{ms[0]:.4f} parent_device_ms={ms[1]:.4f}")


def _record_ptxas():
    from lightgbm_tpu_torch.ops import _build

    for line in _build.ptxas_report("record").splitlines():
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            say(f"[record ptxas] {line.strip()}")


def _crafted_record(torch, rng, n, f, T):
    """Random u8 bins, 28 features, but feature f's bins 0 over window
    tiles 1-2 and 254 over tiles 3-4 of a window at begin 3: tiles with
    no rights, then tiles with no lefts, in the middle of the window."""
    from lightgbm_tpu_torch.ops.record import build_record

    bins = rng.randint(0, NUM_BINS, (N_FEAT, n)).astype(np.uint8)
    bins[f, 3 + T:3 + 3 * T] = 0
    bins[f, 3 + 3 * T:3 + 5 * T] = NUM_BINS - 1
    return build_record(*(torch.from_numpy(a).cuda() for a in (
        bins, rng.randn(n).astype(np.float32),
        np.abs(rng.randn(n)).astype(np.float32),
        (rng.rand(n) < 0.8).astype(np.float32))))


def _envelope_record(torch, n):
    """A W = 12 record of n columns made on the card (seed 0)."""
    from lightgbm_tpu_torch.ops.record import build_record

    gen = torch.Generator(device="cuda").manual_seed(0)
    bins = torch.randint(0, NUM_BINS, (N_FEAT, n), dtype=torch.uint8,
                         device="cuda", generator=gen)
    g = torch.randn(n, device="cuda", generator=gen)
    h = torch.rand(n, device="cuda", generator=gen)
    m = (torch.rand(n, device="cuda", generator=gen) < 0.8).float()
    return build_record(bins, g, h, m)


def _partition_times(torch, name, W, pcnt, k6, k7):
    """Call ms and device ms of K6 and K7 at one window, with the byte
    bounds."""
    from lightgbm_tpu_torch.profile_slice import device_ms_by_kernel

    out = {}
    for kernel, fn, tag, nbytes in (
            ("K6", k6, "compact_kernel", 2 * (W - 1) * 4 * pcnt),
            ("K7", k7, "place_kernel", (2 * W - 1) * 4 * pcnt)):
        ms = time_ms(torch, fn)
        dev = sum(v for key, v in device_ms_by_kernel(torch, fn).items()
                  if tag in key)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        out[kernel] = (ms, dev, bound)
        say(f"[partition times] {kernel} {name} ({pcnt} columns) "
            f"ms={ms:.4f} device_ms={dev:.4f} bound_ms={bound:.5f} "
            f"share={bound / ms:.4f} "
            f"parent_ms={_parent_partition_ms(kernel, name)}")
    return out


def phase_partition(torch):
    from lightgbm_tpu_torch.ops import cuda_record
    from lightgbm_tpu_torch.ops import record as R

    _record_ptxas()
    rng = np.random.RandomState(4)
    F, n, B = N_FEAT, ROWS, NUM_BINS
    T = R.TILE
    # (record, bins a word)
    recs = {"big": (_random_record(torch, rng, F, n, B, np.uint8)[-1], 4),
            "crafted": (_crafted_record(torch, rng, 6 * T + 100, 2, T), 4),
            "u16-odd": (_random_record(torch, rng, 9, 20_000, 300,
                                       np.uint16)[-1], 2),
            "wide": (_random_record(torch, rng, 2000, 5_000, B,
                                    np.uint8)[-1], 4),
            "envelope": (_envelope_record(torch, ENVELOPE), 4)}
    # (name, record, begin, pcnt, f, thr, is_cat)
    cases = [("root", "big", 0, n, 13, 127, False),
             ("interior", "big", 333_333, 60_000, 6, 90, False),
             ("all-left", "big", 1000, 200_000, 20, B - 1, False),
             ("all-right", "big", 1000, 200_000, 20, B, True),
             ("ragged", "big", 12_345, 5 * T + 77, 27, 40, True),
             ("begin%4=1", "big", 1001, 1297, 2, 7, False),
             ("begin%4=2", "big", 1002, 1299, 3, 100, False),
             ("begin%4=3", "big", 1003, 1301, 5, 11, True),
             ("pcnt=1", "big", 333, 1, 1, 7, False),
             ("pcnt=3", "big", 5, 3, 4, 200, False),
             ("pcnt=5", "big", 6, 5, 0, 100, False),
             ("pcnt=513", "big", 37, 513, 3, 100, False),
             ("median", "big", 5555, 16_683, 9, 120, False),
             ("400", "big", 77, 400, 9, 120, False),
             ("left-then-right-tiles", "crafted", 3, 6 * T + 90, 2, 7,
              False),
             ("u16-odd-R", "u16-odd", 7, 19_001, 8, 150, False),
             ("W=505", "wide", 13, 4_900, 1777, 127, False),
             ("envelope", "envelope", 0, ENVELOPE, 13, 127, False)]
    times, out = {}, {}
    for name, key, begin, pcnt, f, thr, is_cat in cases:
        rec, k = recs[key]
        W = rec.shape[0]
        rk, rp = rec.clone(), rec.clone()
        nl_k = int(R.partition_window(rk, f, thr, is_cat, begin, pcnt, 3, 9,
                                      k))
        go = R.go_flags(rp, f, thr, is_cat, begin, pcnt, k)
        comp_p, cl, cr = R.compact_tiles(rp[:W - 1, begin:begin + pcnt], go)
        nl_p = int(cl.sum())
        R.place_runs(rp, comp_p, cl, cr, begin, pcnt, nl_p, 3, 9)
        torch.cuda.synchronize()
        check(nl_k == nl_p, f"K6/K7 {name}: nleft {nl_k} != {nl_p}")
        err = int((rk.to(torch.int64) - rp.to(torch.int64)).abs().max())
        check(err == 0 and torch.equal(rk, rp),
              f"K6/K7 {name}: record differs from the plain version's")
        del rp
        check(torch.equal(rk[:, :begin], rec[:, :begin])
              and torch.equal(rk[:, begin + pcnt:], rec[:, begin + pcnt:]),
              f"K6/K7 {name}: rows outside the window moved")
        comp, counts = cuda_record.compact_cuda(rec, f, thr, is_cat, begin,
                                                pcnt, k)
        check(torch.equal(counts[0], cl) and torch.equal(counts[1], cr),
              f"K6 {name}: tile counts differ")
        lane = torch.arange(T, device="cuda")[None]
        for half, cnt in ((slice(0, T), cl), (slice(T, 2 * T), cr)):
            valid = lane < cnt[:, None]
            check(torch.equal(comp[:, :, half].permute(1, 0, 2)[:, valid],
                              comp_p[:, :, half].permute(1, 0, 2)[:, valid]),
                  f"K6 {name}: run lanes differ")
        del comp_p
        expect = {"all-left": pcnt, "all-right": 0}.get(name)
        check(expect is None or nl_k == expect, f"K6/K7 {name}: nleft {nl_k}")
        if name == "left-then-right-tiles":
            check(cl[1:3].tolist() == [T, T] and cl[3:5].tolist() == [0, 0],
                  f"K6 {name}: tiles 1-4 hold {cl[1:5].tolist()} lefts")
        grid = cuda_record.grids(-(-pcnt // T), W, rec.device)
        say(f"[partition {name}] W={W} k={k} begin={begin} pcnt={pcnt} "
            f"f={f} thr={thr} cat={is_cat} nleft={nl_k} grid={grid}: record "
            "bitwise == plain, outside untouched, K6 runs == plain")
        if name in PARTITION_TIMED:
            snap = rk.clone()
            times[name] = _partition_times(
                torch, name, W, pcnt,
                lambda: cuda_record.compact_cuda(rec, f, thr, is_cat, begin,
                                                 pcnt, k),
                lambda: cuda_record.place_cuda(rk, comp, counts, begin, pcnt,
                                               3, 9))
            # K7 rewrites the same columns with the same values
            check(torch.equal(rk, snap),
                  "K7: repeated launches changed the record")
            del snap
        if name == "root":
            win = rec[:W - 1, :n]
            k6_plain = time_ms(torch, lambda: R.compact_tiles(
                win, R.go_flags(rec, f, thr, is_cat, 0, n, k)))
            comp_p, cl, cr = R.compact_tiles(win, R.go_flags(
                rec, f, thr, is_cat, 0, n, k))
            rp2 = rec.clone()
            k7_plain = time_ms(torch, lambda: R.place_runs(
                rp2, comp_p, cl, cr, 0, n, nl_k, 3, 9))
            check(torch.equal(rp2, rk), "K7: the plain version's timed "
                  "runs differ from the kernel's record")
            say(f"[partition times] root plain K6 ms={k6_plain:.4f} "
                f"K7 ms={k7_plain:.4f}")
            out = dict(err=float(err), k6_plain=k6_plain, k7_plain=k7_plain)
            del win, comp_p, rp2
        del rk, comp, counts
    del recs
    torch.cuda.empty_cache()
    (k6_ms, _, k6_bound), (k7_ms, _, k7_bound) = (
        times["root"]["K6"], times["root"]["K7"])
    return (dict(max_abs_err=out["err"], ms=k6_ms, plain_ms=out["k6_plain"],
                 bound_ms=k6_bound, library_ms=None),
            dict(max_abs_err=out["err"], ms=k7_ms, plain_ms=out["k7_plain"],
                 bound_ms=k7_bound, library_ms=None))


# --------------------------------------------------------------- phase 7
# K8's time before its redesign at the four windows phase 7 times, those of
# tools/split_step_phases.py (ms of 20 calls after 3, PERF.md §6)
K8_PARENT_MS = {"root": 3.9426, "interior": 0.4397, "small": 0.2468,
                "one-tile": 0.2515}
K8_F136_TIMED = ("F136-root", "F136-median")  # no time before this width


def _tied_record(torch, rng, F, n, B):
    """Feature 0 uniform over the bins (the split feature); every other
    feature of a column in bin 3 or bin B-4, the same for all of them, with
    the gradient +4 in bin 3 and -4 in bin B-4: in each child every
    threshold from 3 to B-5 of every feature but 0 ties for the best."""
    from lightgbm_tpu_torch.ops.record import build_record

    col = np.where(rng.rand(n) < 0.5, 3, B - 4).astype(np.uint8)
    bins = np.repeat(col[None], F, 0)
    bins[0] = rng.randint(0, B, n)
    bins = torch.from_numpy(bins).cuda()
    g = torch.from_numpy(np.where(col == 3, 4.0, -4.0).astype(np.float32)
                         ).cuda()
    h = torch.ones(n, dtype=torch.float32, device="cuda")
    m = torch.ones(n, dtype=torch.float32, device="cuda")
    return build_record(bins, g, h, m)


def phase_split_step(torch):
    from lightgbm_tpu_torch.ops import _build, cuda_histogram, cuda_record
    from lightgbm_tpu_torch.ops import cuda_split_step
    from lightgbm_tpu_torch.ops import record as R
    from lightgbm_tpu_torch.ops.cuda_search import pack_meta
    from lightgbm_tpu_torch.profile_slice import device_ms_by_kernel

    rng = np.random.RandomState(5)
    n, B, T = ROWS, NUM_BINS, R.TILE
    # (record, bins a word)
    big = (_random_record(torch, rng, N_FEAT, n, B, np.uint8)[-1], 4)
    u16 = (_random_record(torch, rng, N_FEAT, 100_000, 300, np.uint16)[-1],
           2)
    dom_bins = rng.randint(0, B, (N_FEAT, 300_000)).astype(np.uint8)
    dom_bins[rng.rand(N_FEAT, 300_000) < 0.9] = B // 3
    dom = (R.build_record(*(torch.from_numpy(a).cuda() for a in (
        dom_bins, rng.randn(300_000).astype(np.float32),
        np.abs(rng.randn(300_000)).astype(np.float32),
        (rng.rand(300_000) < 0.8).astype(np.float32)))), 4)
    wide = (_random_record(torch, rng, 6, 40_000, 5000, np.uint16)[-1], 2)
    odd = (_random_record(torch, rng, 29, 50_000, 300, np.uint16)[-1], 2)
    tied = (_tied_record(torch, rng, N_FEAT, 20_000, B), 4)
    # the LambdaRank main path's width: 136 u8 features, a 39-word record
    r136 = (_random_record(torch, rng, RANK_FEAT, n, B, np.uint8)[-1], 4)
    # (name, (record, k), F, bins, begin, pcnt, f, thr, is_cat)
    cases = [("root", big, N_FEAT, B, 0, n, 13, 127, False),
             ("interior", big, N_FEAT, B, 333_333, 60_000, 6, 90, False),
             ("small", big, N_FEAT, B, 777_777, 6_000, 20, 60, False),
             ("all-left", big, N_FEAT, B, 1000, 200_000, 20, B - 1, False),
             ("all-right", big, N_FEAT, B, 1000, 200_000, 20, B, True),
             ("ragged", big, N_FEAT, B, 12_345, 5 * T + 77, 27, 40, False),
             ("one-tile", big, N_FEAT, B, 5_003, 400, 2, 100, False),
             ("median", big, N_FEAT, B, 5_555, 16_683, 9, 120, False),
             ("2049-odd-begin", big, N_FEAT, B, 12_347, 2049, 9, 130, False),
             ("categorical", big, N_FEAT, B, 777, 100_000, 4, 17, True),
             ("uint16", u16, N_FEAT, 300, 0, 100_000, 11, 150, False),
             ("dominant", dom, N_FEAT, B, 5, 250_001, 7, B // 3, False),
             ("u16x5000", wide, 6, 5000, 1001, 30_003, 3, 2400, False),
             ("F29-u16", odd, 29, 300, 777, 40_001, 28, 140, False),
             ("ties", tied, N_FEAT, B, 3, 15_001, 0, 127, False),
             ("F136-root", r136, RANK_FEAT, B, 0, n, 100, 127, False),
             ("F136-median", r136, RANK_FEAT, B, 5_555, 16_683, 70, 120,
              False),
             ("F136-ragged", r136, RANK_FEAT, B, 12_345, 5 * T + 77, 135, 40,
              False)]
    L, parent, new = 4, 1, 3
    out, times = None, {}
    for name, (rec, k), F, nb, begin, pcnt, f, thr, is_cat in cases:
        W = rec.shape[0]
        hists = torch.from_numpy(rng.randn(L, F, nb, 3).astype(np.float32)
                                 ).cuda()
        hists[parent] = cuda_histogram.histogram_record_window_cuda(
            rec, begin, pcnt, F, k, nb)  # the parent's own histogram
        iscat = np.zeros(F, bool)
        iscat[f] = is_cat
        fmask = torch.ones(F, dtype=torch.bool)
        if name == "ties":
            fmask[0] = False  # the split feature is out of the search
        meta = pack_meta(fmask, torch.full((F,), nb),
                         torch.from_numpy(iscat), "cuda")
        go = R.go_flags(rec, f, thr, is_cat, begin, pcnt, k).float()
        wb = R.num_words(F, k)
        g, h, m = (rec[wb + i, begin:begin + pcnt].view(torch.float32)
                   for i in range(3))
        scal = [1.0]
        for side in (go, 1.0 - go):
            scal += [float((g * m * side).sum()), float((h * m * side).sum()),
                     float((m * side).sum())]
        scal += [float(MIN_DATA), 1e-3, 0.0, 0.0, 0.0]
        args = (f, thr, is_cat, begin, pcnt, parent, new, scal)

        def kernel(hk):
            return cuda_split_step.split_step_cuda(rec, hk, *args, meta, k,
                                                   nb)

        hk, hk2 = hists.clone(), hists.clone()
        comp, counts, rows = kernel(hk)
        comp2, counts2, rows2 = kernel(hk2)
        torch.cuda.synchronize()
        check(torch.equal(hk, hk2) and torch.equal(rows, rows2)
              and torch.equal(counts, counts2),
              f"K8 {name}: launches not bitwise equal")
        rec_c = rec.cpu()
        hp = hists.cpu()
        comp_p, counts_p, rows_p = R.split_step_plain(
            rec_c, hp, *args, meta.cpu(), k, nb)
        check(torch.equal(counts.cpu(), counts_p),
              f"K8 {name}: tile counts differ from the plain version's")
        lane = torch.arange(T)[None]
        comp_c = comp.cpu()
        for half, cnt in ((slice(0, T), counts_p[0]),
                          (slice(T, 2 * T), counts_p[1])):
            valid = lane < cnt[:, None]
            check(torch.equal(comp_c[:, :, half].permute(1, 0, 2)[:, valid],
                              comp_p[:, :, half].permute(1, 0, 2)[:, valid]),
                  f"K8 {name}: run lanes differ")
        err = float((hk.cpu() - hp).abs().max())
        check(torch.equal(hk.cpu(), hp),
              f"K8 {name}: buffer rows differ (max abs {err})")
        rows_c = rows.cpu()
        check(torch.equal(rows_c, rows_p),
              f"K8 {name}: search rows differ {rows_c} vs {rows_p}")
        nleft = int(rows_c[0, 11])
        check(nleft == int(counts_p[0].sum()), f"K8 {name}: nleft {nleft}")
        expect = {"all-left": pcnt, "all-right": 0}.get(name)
        check(expect is None or nleft == expect, f"K8 {name}: nleft {nleft}")
        if name == "ties":  # the largest tied threshold, the smallest feature
            check(all(int(rows_c[c, 1]) == 1 and int(rows_c[c, 2]) == B - 5
                      for c in range(2)),
                  f"K8 ties: (feature, threshold) {rows_c[:, 1:3].tolist()}"
                  f", not (1, {B - 5}) in both children")
        # K7 on K8's output against the plain placement
        rk, rp = rec.clone(), rec_c.clone()
        cuda_record.place_cuda(rk, comp, counts, begin, pcnt, parent, new)
        R.place_window(rp, comp_p, counts_p, begin, pcnt, parent, new)
        rk_c = rk.cpu()
        check(torch.equal(rk_c, rp), f"K7 after K8 {name}: record differs "
              "from the plain version's")
        check(torch.equal(rk_c[:, :begin], rec_c[:, :begin])
              and torch.equal(rk_c[:, begin + pcnt:], rec_c[:, begin + pcnt:]),
              f"K7 after K8 {name}: rows outside the window moved")
        timed = {"root": "root", "median": "median", "one-tile": "400"}
        if name in timed:  # K7 on K8's output at phase 6's windows
            fn = lambda: cuda_record.place_cuda(  # noqa: E731
                rk, comp, counts, begin, pcnt, parent, new)
            ms = time_ms(torch, fn)
            dev = sum(v for key, v in device_ms_by_kernel(torch, fn).items()
                      if "place_kernel" in key)
            check(torch.equal(rk.cpu(), rk_c),
                  f"K7 after K8 {name}: repeated launches changed the record")
            say(f"[split-step K7 times] {name} ({pcnt} columns) ms={ms:.4f} "
                f"device_ms={dev:.4f} bound_ms="
                f"{(2 * W - 1) * 4 * pcnt / HBM_BYTES_PER_S * 1e3:.5f} "
                f"parent_ms={_parent_partition_ms('K7', timed[name])}")
        grid = cuda_split_step.grid_blocks(pcnt, F, nb)
        say(f"[split-step {name}] begin={begin} pcnt={pcnt} F={F} f={f} "
            f"thr={thr} cat={is_cat} B={nb} k={k} nleft={nleft} grid={grid}: "
            "comp lanes, counts, buffer rows, search rows bitwise == plain; "
            "two launches equal; K7 record bitwise == plain, outside "
            "untouched")
        if name in K8_PARENT_MS or name in K8_F136_TIMED:
            hs = hists.clone()
            ms = time_ms(torch, lambda: kernel(hs))
            nbytes = 2 * (W - 1) * 4 * pcnt + 3 * F * nb * 12
            bound = max(nbytes / HBM_BYTES_PER_S,
                        3 * F * pcnt / F32_FLOPS) * 1e3
            times[name] = (ms, bound, grid)
            if name == "root":
                hpc = hists.clone()
                plain_ms = time_ms(torch, lambda: R.split_step_plain(
                    rec, hpc, *args, meta, k, nb))
                out = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                           bound_ms=bound, library_ms=None)
        del hists, hk, hk2, comp, comp2, comp_c, comp_p, rk, rp, rk_c, rec_c
        del rec
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for nb in (B, 300):
        cap = cuda_split_step.grid_blocks(1 << 40, N_FEAT, nb)
        say(f"[split-step occupancy] B={nb}: resident grid {cap} blocks on "
            f"{sms} SMs, {cap / sms:g} blocks an SM")
    for line in _build.ptxas_report("split_step").splitlines():
        if "Used" in line or "spill" in line:
            say(f"[split-step ptxas] {line.strip()}")
    for name, (ms, bound, grid) in times.items():
        say(f"[split-step times] {name} ms={ms:.4f} bound_ms={bound:.6f} "
            f"share={bound / ms:.4f} grid={grid} "
            f"parent_ms={K8_PARENT_MS.get(name, 'none')}")
    say(f"[split-step times] root plain_ms={out['plain_ms']:.4f}")
    del big, u16, dom, wide, odd, tied, r136
    return out


# --------------------------------------------------------------- phase 8
_V1 = {"LGBM_TPU_OPT_HISTS": "1", "LGBM_TPU_FUSE_HIST": "1",
       "LGBM_TPU_HIST_KERNEL": "v1"}
ROUTE_ENV = {"mega": _V1,
             "record": dict(_V1, LGBM_TPU_FUSE_HIST="0"),
             "order": dict(_V1, LGBM_TPU_OPT_HISTS="0"),
             "leafwise-bsub": dict(_V1, LGBM_TPU_HIST_KERNEL="bsub"),
             "pooled": _V1,
             "depthwise": _V1,
             "depthwise-bsub": dict(_V1, LGBM_TPU_HIST_KERNEL="bsub"),
             "hybrid": _V1, "f64-leafwise": _V1, "f64-depthwise": _V1,
             "f64-pooled": _V1, "f64-hybrid": _V1}
GROWTH = {"depthwise": "depthwise", "depthwise-bsub": "depthwise",
          "hybrid": "hybrid", "f64-hybrid": "hybrid",
          "f64-depthwise": "depthwise"}  # every other run grows leaf-wise
# parameters a route adds to the bench config
ROUTE_PARAMS = {"pooled": {"histogram_pool_size": POOL_MB},
                "f64-leafwise": {"hist_dtype": "float64"},
                "f64-depthwise": {"hist_dtype": "float64"},
                "f64-pooled": {"hist_dtype": "float64",
                               "histogram_pool_size": POOL_MB},
                "f64-hybrid": {"hist_dtype": "float64"}}


@contextlib.contextmanager
def route_env(route: str):
    """The JAX package's knobs set for ``route`` inside, restored after:
    on the card "mega" is the default, ``LGBM_TPU_FUSE_HIST=0`` selects
    the record route, ``LGBM_TPU_OPT_HISTS=0`` the order route and
    ``LGBM_TPU_HIST_KERNEL=bsub`` kernel 2 for the histograms (and the
    order route for leaf-wise growth)."""
    saved = {k: os.environ.get(k) for k in ROUTE_ENV[route]}
    os.environ.update(ROUTE_ENV[route])
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def reset_counts():
    """Every kernel's launch count, the host-sync count, the pool's
    recompute count and the depthwise level counts to 0."""
    from lightgbm_tpu_torch.learners import depthwise, serial
    from lightgbm_tpu_torch.ops import reset_launch_counts

    reset_launch_counts()
    serial.HOST_SYNCS = serial.POOL_RECOMPUTES = 0
    depthwise.LEVELS = depthwise.LEVEL_SPLITS = 0


def make_bench_data(lt, quiet=False):
    from lightgbm_tpu_torch.synthetic import bench_data

    t0 = time.perf_counter()
    X, y, Xv, yv = bench_data(ROWS, seed=7, n_valid=VALID_ROWS)
    params = {"objective": "binary", "num_leaves": NUM_LEAVES,
              "max_bin": NUM_BINS, "learning_rate": LEARNING_RATE,
              "min_data_in_leaf": MIN_DATA, "metric": "auc", "verbose": -1}
    train_set = lt.Dataset(X, label=y, max_bin=NUM_BINS, params=params)
    train_set.construct()
    valid_set = train_set.create_valid(Xv, label=yv)
    if not quiet:
        say(f"[main] data + binning {time.perf_counter() - t0:.1f}s")
    return params, train_set, valid_set, Xv


def _expected(route, trees, levels, level_splits, recomputes):
    """Each kernel's launches and the host syncs a run must show: the
    leaf-wise routes' from the trees (the pooled route's K1 also from the
    parents it rebuilt); depthwise one level histogram and one sync per
    level; hybrid's phase 1 the same, then one level pass and one sync for
    the resume and, per best-first split, K1 + K3 and two syncs."""
    from lightgbm_tpu_torch.ops import KERNEL_COUNTERS

    splits = sum(t.num_leaves - 1 for t in trees)
    n = len(trees)
    counts = dict.fromkeys(KERNEL_COUNTERS, 0)
    growth = GROWTH.get(route, "leafwise")
    if route.startswith("f64"):  # the float64 kernels only: K3-f64's
        # root form at each root, its step form at every split
        if growth == "depthwise":
            counts["K1″-f64"] = levels
            return counts, levels
        if growth == "hybrid":
            tail = splits - level_splits
            counts.update({"K1″-f64": levels + n, "K1-f64": tail,
                           "K3-f64 step": tail})
            return counts, levels + n + 2 * tail
        counts.update({"K1-f64": n + splits + recomputes, "K3-f64": n,
                       "K3-f64 step": splits})
        return counts, 2 * n + 2 * splits
    if growth == "depthwise":
        counts["K2" if route.endswith("bsub") else K1PP] = levels
        return counts, levels
    if growth == "hybrid":
        tail = splits - level_splits
        counts.update({K1PP: levels + n, "K1": tail, "K3": tail})
        return counts, levels + n + 2 * tail
    counts.update({
        "mega": {"K1'": n, "K3": n, "K7": splits, "K8": splits},
        "record": {"K1'": n + splits, "K3": n, "K4": splits, "K6": splits,
                   "K7": splits},
        "order": {"K1": n + splits, "K3": n + splits},
        "pooled": {"K1": n + splits + recomputes, "K3": n, "K5": splits},
        "leafwise-bsub": {"K2": n + splits, "K3": n + splits}}[route])
    # two at the root; one per split on the mega route, two on the others
    return counts, 2 * n + (1 if route == "mega" else 2) * splits


def phase_main_path(torch, lt, route, params, train_set, valid_set, Xv):
    """The bench model on one route or growth mode: 1 warm tree, then
    TREES timed trees with every kernel count set to 0 just before and read
    just after."""
    from lightgbm_tpu_torch.learners import depthwise, serial
    from lightgbm_tpu_torch.ops import launch_counts

    growth = GROWTH.get(route, "leafwise")
    params = dict(params, tree_growth=growth, **ROUTE_PARAMS.get(route, {}))
    with route_env(route):
        warm = lt.train(params, train_set, num_boost_round=1)
        torch.cuda.synchronize()
        del warm
        booster = lt.Booster(params=params, train_set=train_set)
        # earlier runs' boosters sit in reference cycles until a
        # collection: the peak is this run's only after one
        gc.collect()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(TREES):
            booster.update()
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        counts = launch_counts()
        syncs, recomputes = serial.HOST_SYNCS, serial.POOL_RECOMPUTES
        levels, level_splits = depthwise.LEVELS, depthwise.LEVEL_SPLITS
        peak = torch.cuda.max_memory_allocated()
        mm = booster._gbdt._memmodel_params()  # phase 28's memory model
    trees = booster._gbdt.models
    leaves = [t.num_leaves for t in trees]
    slots = booster._gbdt._hist_pool_slots()
    expect, expect_syncs = _expected(route, trees, levels, level_splits,
                                     recomputes)
    train_auc = booster.eval_train()[0][2]
    booster.add_valid(valid_set, "valid")
    valid_auc = booster.eval_valid()[0][2]
    pv = booster.predict(Xv[:1000])
    say(f"[main {route}] {TREES} trees {elapsed:.3f}s "
        f"s/tree={elapsed / TREES:.4f} leaves={leaves} levels={levels} "
        f"level_splits={level_splits} pool_slots={slots} "
        f"recomputes={recomputes} "
        f"train_auc={train_auc:.6f} valid_auc={valid_auc:.6f} "
        f"launches={json.dumps(counts)} expected={json.dumps(expect)} "
        f"host_syncs_per_tree={syncs / TREES:.1f} peak_mem_bytes={peak}")
    check(len(trees) == TREES, f"main {route}: tree count")
    if growth == "depthwise":
        # a level that splits nothing still reads its rows, then stops
        depth_levels = sum(int(t.leaf_depth[:t.num_leaves].max())
                           + (t.num_leaves < NUM_LEAVES) for t in trees)
        check(levels == depth_levels and level_splits == sum(
            nl - 1 for nl in leaves),
            f"main {route}: {levels} levels / {level_splits} splits do not "
            "match the trees")
    if growth == "hybrid":
        check(TREES <= levels and level_splits <= TREES * NUM_LEAVES // 2,
              f"main {route}: phase 1 ran {levels} levels, "
              f"{level_splits} splits")
    if route == "f64-pooled":  # 8-byte cells: half the slots
        check(slots == 24 and recomputes > 0,
              f"main {route}: {slots} slots, {recomputes} parents rebuilt")
    if route == "pooled":
        check(slots == 48 and recomputes > 0,
              f"main {route}: {slots} slots, {recomputes} parents rebuilt")
    check(all(counts[name] > 0 for name, want in expect.items() if want),
          f"main {route}: a kernel of the route never launched")
    check(counts == expect, f"main {route}: launches {counts} != {expect}")
    check(syncs == expect_syncs,
          f"main {route}: {syncs} host syncs, expected {expect_syncs}")
    ref_train, ref_valid = AUC_REF[route if route in AUC_REF else growth]
    check(abs(train_auc - ref_train) <= AUC_TOL,
          f"main {route}: train AUC {train_auc} outside "
          f"{ref_train}+-{AUC_TOL}")
    check(abs(valid_auc - ref_valid) <= AUC_TOL,
          f"main {route}: valid AUC {valid_auc} outside "
          f"{ref_valid}+-{AUC_TOL}")
    check(pv.shape == (1000,) and bool(np.isfinite(pv).all())
          and bool(((pv > 0) & (pv < 1)).all()), f"main {route}: predictions")
    return dict(counts=counts, s_per_tree=elapsed / TREES,
                auc=(train_auc, valid_auc), syncs_per_tree=syncs / TREES,
                peak=peak, leaves=leaves, recomputes=recomputes,
                text=booster.model_to_string(), mm=mm)


# --------------------------------------------------------------- phase 9
def pool_exact(torch):
    """On exact-sum data (grad in {+-1, +-0.5}, hess 1: every histogram
    sum exact, so a rebuilt parent equals the resident one), pooled trees
    on the card, through K5 and through PyTorch subtraction + K3, bitwise
    equal to the unpooled order route's in every tree field and leaf id."""
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.learners import serial
    from lightgbm_tpu_torch.learners.serial import TreeLearnerParams, grow_tree
    from lightgbm_tpu_torch.ops.cuda_histogram import histogram_record_window

    rng = np.random.RandomState(13)
    n, F, B = 100_000, N_FEAT, NUM_BINS
    ones = torch.ones(n, device="cuda")
    args = (torch.from_numpy(rng.randint(0, B, (F, n)).astype(np.uint8))
            .cuda(),
            torch.from_numpy(rng.choice([-1.0, -0.5, 0.5, 1.0], n)
                             .astype(np.float32)).cuda(),
            ones, ones, torch.ones(F, dtype=torch.bool, device="cuda"),
            torch.full((F,), B, device="cuda"),
            torch.zeros(F, dtype=torch.bool, device="cuda"),
            TreeLearnerParams.from_config(Config(min_data_in_leaf=MIN_DATA,
                                                 min_sum_hessian_in_leaf=1e-3)),
            B, NUM_LEAVES)
    t0, lid0 = grow_tree(*args)
    ok = True
    for pool in (48, 2):
        for raw in (histogram_record_window, None):
            reset_counts()
            t1, lid1 = grow_tree(*args, hist_fn_raw=raw, hist_pool=pool)
            ok &= t1.num_leaves == t0.num_leaves and torch.equal(lid1, lid0)
            ok &= all(torch.equal(getattr(t1, k), getattr(t0, k))
                      for k in TREE_FIELDS)
            ok &= serial.POOL_RECOMPUTES > 0
            say(f"[trees pooled exact-sum] pool={pool} step="
                f"{'K5' if raw else 'subtraction+K3'} leaves={t1.num_leaves}"
                f" recomputes={serial.POOL_RECOMPUTES} bitwise == unpooled "
                f"(every tree field, leaf ids): {ok}")
    check(ok, "pooled and unpooled trees differ on exact-sum data")


def phase_trees(torch, lt):
    from lightgbm_tpu_torch.learners import serial
    from lightgbm_tpu_torch.models.gbdt import GBDT
    from lightgbm_tpu_torch.ops import launch_counts
    from lightgbm_tpu_torch.ops.cuda_histogram import histogram_record_window
    from lightgbm_tpu_torch.synthetic import bench_data

    X, y = bench_data(100_000, seed=11)
    params = {"objective": "binary", "num_leaves": NUM_LEAVES,
              "max_bin": NUM_BINS, "learning_rate": LEARNING_RATE,
              "min_data_in_leaf": MIN_DATA, "verbose": -1}
    runs = {}
    # (run, device, route); "cpu-mega" forces the mega route on the CPU,
    # where train takes the order route, to grow it with the plain versions
    for name, dev, route in (("mega", "cuda", "mega"),
                             ("record", "cuda", "record"),
                             ("order", "cuda", "order"),
                             ("cpu", "cpu", "mega"),
                             ("cpu-mega", "cpu", "mega"),
                             ("pooled", "cuda", "pooled"),
                             ("cpu-pooled", "cpu", "pooled"),
                             ("order-bsub", "cuda", "leafwise-bsub"),
                             ("depthwise", "cuda", "depthwise"),
                             ("depthwise-bsub", "cuda", "depthwise-bsub"),
                             ("cpu-depthwise", "cpu", "depthwise"),
                             ("hybrid", "cuda", "hybrid"),
                             ("cpu-hybrid", "cpu", "hybrid")):
        saved = GBDT._leafwise_hist_fn_raw
        if name in ("cpu-mega", "cpu-pooled"):
            # the card's raw histogram: the mega route, or K5's pooled step
            GBDT._leafwise_hist_fn_raw = lambda self: histogram_record_window
        try:
            with route_env(route):
                reset_counts()
                ds = lt.Dataset(X, label=y, max_bin=NUM_BINS, device=dev)
                b = lt.train(dict(params, tree_growth=GROWTH.get(
                    route, "leafwise"), **ROUTE_PARAMS.get(route, {})), ds,
                    num_boost_round=2, device=dev)
                counts = launch_counts()
                counts["recomputes"] = serial.POOL_RECOMPUTES
        finally:
            GBDT._leafwise_hist_fn_raw = saved
        runs[name] = (b._gbdt.models, b._gbdt._scores.cpu(), counts)
    n = {r: runs[r][2] for r in runs}
    check(n["pooled"].pop("recomputes") > 0
          and n["cpu-pooled"].pop("recomputes") > 0,
          "trees: the pooled runs rebuilt no parent")
    only = {"mega": {"K1'", "K3", "K7", "K8"}, "record": {"K1'", "K3", "K4",
                                                          "K6", "K7"},
            "order": {"K1", "K3"}, "order-bsub": {"K2", "K3"},
            "pooled": {"K1", "K3", "K5"},
            "depthwise": {K1PP}, "depthwise-bsub": {"K2"},
            "hybrid": {K1PP, "K1", "K3"}}
    check(all({k for k, v in n[r].items() if v and k != "recomputes"}
              == only.get(r, set()) for r in runs),
          f"trees: routes not taken as asked {n}")

    def same(r1, r2, fields, scores):
        ok = not scores or torch.equal(runs[r1][1], runs[r2][1])
        for a, b in zip(runs[r1][0], runs[r2][0]):
            ok &= a.num_leaves == b.num_leaves
            for k in fields:
                ok &= bool(torch.equal(getattr(a, k).cpu(), getattr(b, k)
                                       .cpu()))
        return ok

    bitwise = same("record", "order", TREE_FIELDS, True)
    struct_cpu = same("order", "cpu", STRUCT, False)
    struct_mega = same("mega", "cpu-mega", STRUCT, False)
    struct_pool = same("pooled", "cpu-pooled", STRUCT, False)
    struct_dw = same("depthwise", "cpu-depthwise", STRUCT, False)
    struct_hy = same("hybrid", "cpu-hybrid", STRUCT, False)
    bsub_dw = same("depthwise-bsub", "depthwise", TREE_FIELDS, True)
    bsub_ord = same("order-bsub", "order", TREE_FIELDS, True)
    leaves = {r: [t.num_leaves for t in runs[r][0]]
              for r in ("mega", "record", "pooled", "depthwise", "hybrid")}
    say(f"[trees] 2 trees at 100k rows, leaves={leaves}: record route == "
        f"order route on the card (every tree field, train scores): "
        f"{bitwise}; card == CPU plain (structure): order {struct_cpu}, "
        f"mega {struct_mega}, pooled {struct_pool}, depthwise {struct_dw}, "
        f"hybrid {struct_hy}; "
        f"bsub == v1 (every tree field, train scores): depthwise "
        f"{bsub_dw}, order route {bsub_ord}")
    check(bitwise, "record-route and order-route trees differ on the card")
    check(struct_cpu, "kernel-grown and plain-grown trees differ")
    check(struct_mega, "kernel-grown and plain-grown mega-route trees differ")
    check(struct_pool, "kernel-grown and plain-grown pooled trees differ")
    pool_exact(torch)
    check(struct_dw and struct_hy,
          "kernel-grown and plain-grown depthwise/hybrid trees differ")
    check(bsub_dw and bsub_ord, "bsub-grown and v1-grown trees differ")


# -------------------------------------------------------------- phase 10
def phase_level_histogram(torch, train_set):
    """K1'' and K2 against their plain version and each other, at the
    bench shape with a real level's leaf ids, with one leaf, with u16 x
    300 bins, with ~90 % of every feature's rows in one bin and with u16 x
    5000 bins (more than the kernels' count table holds); K2 with one leaf
    against K1 on every case's bins; times them, and ``level_layout``
    alone, at the level-6 and dominant-bin cases."""
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.learners.depthwise import grow_tree_depthwise
    from lightgbm_tpu_torch.learners.serial import TreeLearnerParams
    from lightgbm_tpu_torch.ops import cuda_histogram as ch
    from lightgbm_tpu_torch.ops.histogram import (
        histogram_by_leaf, histogram_by_leaf_sorted_plain, level_layout)

    inner = train_set.construct()
    bins = inner.bins_T("cuda")
    F, n = bins.shape
    B = max(int(inner.max_num_bin), 2)
    # the leaf ids after 6 depthwise levels of the first tree (gradients
    # at score 0), for the 255-leaf level histogram: most leaves empty
    y = torch.from_numpy(np.asarray(train_set.label, np.float32)).cuda()
    g0 = 0.5 - y
    h0 = torch.full_like(g0, 0.25)
    prm = TreeLearnerParams.from_config(Config(min_data_in_leaf=MIN_DATA,
                                               max_depth=6))
    tree6, lid6 = grow_tree_depthwise(
        bins, g0, h0, torch.ones_like(g0),
        torch.ones(F, dtype=torch.bool, device="cuda"),
        torch.as_tensor(inner.num_bins_per_feature).cuda(),
        torch.zeros(F, dtype=torch.bool, device="cuda"), prm, B, NUM_LEAVES)
    rng = np.random.RandomState(6)

    def stats(m):
        return (torch.from_numpy(rng.randn(m).astype(np.float32)).cuda(),
                torch.from_numpy(np.abs(rng.randn(m)).astype(np.float32))
                .cuda(),
                torch.from_numpy((rng.rand(m) < 0.8).astype(np.float32))
                .cuda())

    u16 = torch.from_numpy(rng.randint(0, 300, (F, 100_000)).astype(
        np.uint16)).cuda()
    dom = torch.where(torch.from_numpy(rng.rand(F, n) < 0.9).cuda(),
                      torch.full_like(bins, B // 3), bins)
    many = torch.from_numpy(rng.randint(0, 5000, (4, 100_000)).astype(
        np.uint16)).cuda()

    def leaves(L, m):
        return torch.from_numpy(rng.randint(0, L, m).astype(np.int32)).cuda()

    cases = [("level-6", bins, lid6, B, NUM_LEAVES),
             ("one-leaf", bins, torch.zeros_like(lid6), B, 1),
             ("uint16", u16, leaves(64, 100_000), 300, 64),
             ("dominant-bin", dom, lid6, B, NUM_LEAVES),
             ("many-bins", many, leaves(64, 100_000), 5000, 64)]
    record = None
    for name, b, lid, nb, L in cases:
        g, h, m = stats(b.shape[1])
        F = b.shape[0]
        lay = level_layout(lid, L)
        _, table = ch._level_launch("lgbm_level_hist", "v1", b, lid, g, h,
                                    m, nb, L, 0, tables=True)
        check(all(torch.equal(t, x) for t, x in zip(table, lay[2:])),
              f"K1'' {name}: its chunk table differs from level_layout's")
        a = ch.histogram_by_leaf_sorted_cuda(b, lid, g, h, m, nb, L, "v1")
        a2 = ch.histogram_by_leaf_sorted_cuda(b, lid, g, h, m, nb, L, "v1")
        k2 = ch.histogram_by_leaf_sorted_cuda(b, lid, g, h, m, nb, L, "bsub")
        torch.cuda.synchronize()
        check(torch.equal(a, a2), f"K1'' {name}: launches not bitwise equal")
        check(torch.equal(k2, a), f"K2 {name}: differs from K1''")
        cpu = histogram_by_leaf_sorted_plain(b.cpu(), lid.cpu(), g.cpu(),
                                             h.cpu(), m.cpu(), nb, L)
        err = float((a.cpu() - cpu).abs().max())
        check(err == 0.0 and torch.equal(a.cpu(), cpu),
              f"K1'' {name}: differs from its plain version (max {err})")
        ref = histogram_by_leaf(b, lid, g.double(), h.double(), m.double(),
                                nb, L)
        err64 = float((a.double() - ref)[..., :2].abs().max())
        check(torch.equal(a[..., 2].double(), ref[..., 2]),
              f"K1'' {name}: counts differ from the float64 sums")
        live = int((a[:, 0, :, 2].sum(1) > 0).sum())
        k1 = ch.histogram_single_leaf_cuda(b, g, h, m, nb)
        k2s = ch.histogram_single_leaf_bsub_cuda(b, g, h, m, nb)
        torch.cuda.synchronize()
        check(torch.equal(k2s, k1), f"K2 {name}: one leaf differs from K1")
        check(L > 1 or torch.equal(a[0], k1),
              f"K1'' {name}: one leaf differs from K1")
        top = float(a[..., 2].amax())
        say(f"[level-hist {name}] F={F} n={b.shape[1]} B={nb} L={L} "
            f"non-empty leaves={live} largest cell={top:.0f} rows bitwise: "
            f"launches, K2 == K1'', == plain, K2 one leaf == K1"
            f"{', K1 == K1 (one leaf)' if L == 1 else ''} "
            f"max_abs_err_vs_f64={err64:.3g}")
        if name in ("level-6", "dominant-bin"):
            keys = ((lid.to(torch.int64)[None, :] * F
                     + torch.arange(F, device="cuda")[:, None]) * nb
                    + b.to(torch.int64)).reshape(-1)
            src = torch.stack([g * m, h * m, m], -1).repeat(F, 1)

            def library():
                return torch.zeros(L * F * nb, 3, device="cuda").index_add_(
                    0, keys, src)

            times = {v: time_ms(
                torch, lambda v=v: ch.histogram_by_leaf_sorted_cuda(
                    b, lid, g, h, m, nb, L, v)) for v in ("v1", "bsub")}
            layout_ms = time_ms(torch, lambda: level_layout(lid, L))
            sort_ms = time_ms(torch, lambda: torch.sort(lid, stable=True))
            plain_ms = time_ms(torch, lambda: histogram_by_leaf_sorted_plain(
                b, lid, g, h, m, nb, L), reps=5, warm=1)
            lib_ms = time_ms(torch, library)
            nbytes = F * n * b.element_size() + 16 * n + L * F * nb * 12
            bound = max(nbytes / HBM_BYTES_PER_S,
                        3 * F * n / F32_FLOPS) * 1e3
            say(f"[level-hist times] {name}: K1'' ms={times['v1']:.4f} "
                f"K2 ms={times['bsub']:.4f} level_layout_ms={layout_ms:.4f} "
                f"(the call's own prep: sort_ms={sort_ms:.4f}, then the "
                f"chunk table in the kernel) "
                f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
                f"bound_ms={bound:.5f} ({nbytes} bytes) "
                f"share K1''={bound / times['v1']:.4f} "
                f"K2={bound / times['bsub']:.4f}")
            if name == "level-6":
                record = {v: dict(max_abs_err=err, ms=times[v],
                                  plain_ms=plain_ms, bound_ms=bound,
                                  library_ms=lib_ms) for v in ("v1", "bsub")}
            del keys, src
        del a, a2, k2, cpu, ref, k1, k2s, lay, table
    del u16, dom, many, lid6, tree6
    return record["v1"], record["bsub"]


# -------------------------------------------------------------- phase 11
def phase_pool_search(torch):
    """K5 against its plain version, the pool and the rows torch.equal
    (resident and recomputed parent, both values of small_is_left), at the
    bench shape (25 cases), at the scan's branches (B = 7, 300, 600, 5000)
    and at F = 5000 x 255 and 2000 x 256 bins; K3 and K4 at F = 2000
    against their plain versions, bitwise; times K5 at the bench shape and
    K3, K4 and K5 at F = 2000 beside their one-thread scan's times."""
    from lightgbm_tpu_torch.ops import cuda_search
    from lightgbm_tpu_torch.ops import split as plain

    rng = np.random.RandomState(11)
    P = 6

    def run(hl, hr, meta, scal, resident, sil):
        """K5 and its plain version on the same pool; True if bitwise."""
        pool = torch.from_numpy(rng.randn(P, *hl.shape).astype(np.float32)
                                ).cuda()
        pool[2] = hl + hr
        # resident: the parent in slot 2, which the left child takes;
        # recomputed: the parent as a separate row, the children in 4 and 2
        parent, s1, s2 = (2, 2, 5) if resident else (hl + hr, 4, 2)
        small = hl if sil else hr
        pk, pp = pool.clone(), pool.clone()
        k = cuda_search._search2_pool_cuda(pk, small, parent, s1, s2, sil,
                                           scal, meta)
        p = plain.search2_pool(pp, small, parent, s1, s2, sil, scal, meta)
        return torch.equal(pk, pp) and torch.equal(k, p), k

    n = 0
    shapes = [(F, B, 24 if F == N_FEAT and B == NUM_BINS else count)
              for F, B, count in _search_shapes()]
    for F, B, count in shapes:
        for case in _search_cases(rng, F, B, count):
            hl, hr, meta, scal = _case_tensors(torch, case)
            for resident in (True, False):
                for sil in (True, False):
                    same, k = run(hl, hr, meta, scal, resident, sil)
                    check(same, f"K5 F={F} B={B}: pool or rows differ from "
                          f"the plain version's (resident={resident}, "
                          f"small_is_left={sil})")
                    n += 1
        # the crafted tie: small = tie, parent = 2 * tie
        _check_tie(k, B, f"K5 F={F} B={B}")
        if (F, B) == (N_FEAT, NUM_BINS):
            pool = torch.from_numpy(
                rng.randn(P, F, B, 3).astype(np.float32)).cuda()
            ms = time_ms(torch, lambda: cuda_search._search2_pool_cuda(
                pool, hl, 2, 2, 5, True, scal, meta))
            plain_ms = time_ms(torch, lambda: plain.search2_pool(
                pool, hl, 2, 2, 5, True, scal, meta))
            del pool
    F, B = N_FEAT, NUM_BINS
    nbytes = 4 * F * B * 12 + F * 16 + 2 * 16 * 4
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    say(f"[pool-search] cases={n} (resident/recomputed x small left/right "
        f"at F=28 x B=255, B={'/'.join(map(str, SCAN_BINS))}, "
        f"F={RANK_FEAT}/{WIDE_F}) "
        f"pool and rows torch.equal plain ms={ms:.4f} "
        f"parent_ms={_parent_ms('K5', F)} plain_ms={plain_ms:.4f} "
        f"bound_ms={bound:.6f} ({nbytes} bytes) share={bound / ms:.5f}")
    record = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                  library_ms=None)

    # ---- F=2000 x 256 bins: K5, K4 and K3
    Fw, Bw = 2000, 256
    hw = [np.stack([rng.randn(Fw, Bw), np.abs(rng.randn(Fw, Bw)) + 0.1,
                    rng.randint(1, 50, (Fw, Bw))], -1).astype(np.float32)
          for _ in range(2)]
    hl, hr = (torch.from_numpy(a).cuda() for a in hw)
    meta = cuda_search.pack_meta(torch.ones(Fw, dtype=torch.bool),
                                 torch.full((Fw,), Bw),
                                 torch.zeros(Fw, dtype=torch.bool), "cuda")
    scal = [1.0] + [float(v) for a in hw for v in a[2].sum(axis=0)] + [
        float(MIN_DATA), 1e-3, 0.0, 0.0, 0.0]
    for resident in (True, False):
        for sil in (True, False):
            same, k = run(hl, hr, meta, scal, resident, sil)
            check(same, f"K5 F={Fw}: pool or rows differ from the plain "
                  f"version's (resident={resident}, small_is_left={sil})")
    k3 = cuda_search._search2_rows_cuda(hl, hr, scal, meta)
    check(torch.equal(k3, plain.search2_rows(hl, hr, scal, meta)),
          f"K3 F={Fw}: rows differ from the plain version's")
    check(int(k3[0, 1]) >= 0, f"K3 F={Fw}: no split found")
    bufs = torch.from_numpy(rng.randn(4, Fw, Bw, 3).astype(np.float32)
                            ).cuda()
    bufs[1] = hl + hr
    bk, bp = bufs.clone(), bufs.clone()
    k4 = cuda_search._search2_update_cuda(bk, hl, 1, 3, True, scal, meta)
    p4 = plain.search2_update(bp, hl, 1, 3, True, scal, meta)
    check(torch.equal(bk, bp) and torch.equal(k4, p4),
          f"K4 F={Fw}: buffer or rows differ from the plain version's")
    pool = torch.from_numpy(rng.randn(4, Fw, Bw, 3).astype(np.float32)).cuda()
    ms5 = time_ms(torch, lambda: cuda_search._search2_pool_cuda(
        pool, hl, 2, 2, 3, True, scal, meta), reps=5, warm=1)
    ms4 = time_ms(torch, lambda: cuda_search._search2_update_cuda(
        bk, hl, 1, 3, True, scal, meta), reps=5, warm=1)
    ms3 = time_ms(torch, lambda: cuda_search._search2_rows_cuda(
        hl, hr, scal, meta), reps=5, warm=1)
    b45 = (4 * Fw * Bw * 12 + Fw * 16 + 128) / HBM_BYTES_PER_S * 1e3
    b3 = (2 * Fw * Bw * 12 + Fw * 16 + 128) / HBM_BYTES_PER_S * 1e3
    say(f"[pool-search F={Fw} B={Bw}] K5 (resident/recomputed x small "
        f"left/right), K4 and K3 bitwise == plain; "
        + "; ".join(f"{name} ms={t:.4f} parent_ms={_parent_ms(name, Fw)} "
                    f"bound_ms={bd:.5f} share={bd / t:.5f}"
                    for name, t, bd in (("K3", ms3, b3), ("K4", ms4, b45),
                                        ("K5", ms5, b45))))
    del pool, bufs, bk, bp, hl, hr
    return record


# -------------------------------------------------------------- phase 12
def phase_writeback(torch):
    """K9 through ``write_window`` on records of 16 rows (row length a
    multiple of 4 and not) and of one row, at begins of every residue mod
    4, windows whose width is and is not a multiple of 4, and two clamped
    begins (counted), each record bitwise against the plain version and
    against ``copy_`` on the card; times at a 1M-column window of the bench
    record's 12 rows at begin 0 and at begin 37, beside ``copy_``."""
    from lightgbm_tpu_torch.ops import launch_counts
    from lightgbm_tpu_torch.ops import record as R
    from lightgbm_tpu_torch.profile_slice import device_ms_by_kernel

    rng = np.random.RandomState(12)
    T = R.TILE
    # (rows, record columns, window columns, begin)
    cases = [(16, 8 * T, 2 * T, b) for b in (0, 1, 37, 500, T - 1, 7 * T,
                                             -5)]
    cases += [(W, n, cap, b) for W, n, cap in ((16, 8 * T + 1, 2 * T + 3),
                                               (1, 8 * T, 1235), (1, 9, 5))
              for b in (0, 1, 2, 3)]
    recs, outs = [], []
    for W, n, cap, _ in cases:
        recs.append(torch.from_numpy(rng.randint(-2**30, 2**30, (W, n))
                                     .astype(np.int32)))
        outs.append(torch.from_numpy(rng.randint(-2**30, 2**30, (W, cap))
                                     .astype(np.int32)))
    dev = [r.cuda() for r in recs]
    outs_c = [o.cuda() for o in outs]
    reset_counts()
    for r, o, (_, _, _, b) in zip(dev, outs_c, cases):
        R.write_window(r, o, b)
    torch.cuda.synchronize()
    launches = launch_counts()["K9"]
    check(launches == len(cases), f"K9: {launches} launches for "
          f"{len(cases)} windows")
    for r, rec, o, (W, n, cap, b) in zip(dev, recs, outs, cases):
        placed = min(max(b + n if b < 0 else b, 0), n - cap)
        lib = rec.cuda()
        lib[:, placed:placed + cap].copy_(o.cuda())
        cpu = R.write_window(rec.clone(), o, b)
        check(torch.equal(r.cpu(), cpu) and torch.equal(r, lib),
              f"K9 W={W} n={n} cap={cap} begin={b}: record differs from the "
              "plain version's or copy_'s")
    rec_big = torch.empty((12, ROWS + 2 * T), dtype=torch.int32,
                          device="cuda").random_(-2**30, 2**30)
    out_big = torch.empty((12, ROWS), dtype=torch.int32,
                          device="cuda").random_(-2**30, 2**30)
    t = {}
    for b in (0, 37):
        k9 = lambda: R.write_window(rec_big, out_big, b)  # noqa: E731
        # the plain version is this copy_, the one library call
        lib = lambda: rec_big[:, b:b + ROWS].copy_(out_big)  # noqa: E731
        t[b] = (time_ms(torch, k9), time_ms(torch, lib),
                sum(device_ms_by_kernel(torch, k9).values()),
                sum(device_ms_by_kernel(torch, lib).values()))
    bound = 2 * 12 * ROWS * 4 / HBM_BYTES_PER_S * 1e3
    say(f"[writeback] {len(cases)} windows, launches={launches}: records "
        "bitwise == plain (CPU) and == copy_ (card); 1M-column window x 12 "
        "rows (call ms, then device ms): " + "; ".join(
            f"begin {b} ms={ms:.4f} copy_ms={cms:.4f} device {dms:.4f} / "
            f"copy_ {dcms:.4f}" for b, (ms, cms, dms, dcms) in t.items())
        + f"; bound_ms={bound:.5f} share at 37={bound / t[37][0]:.4f}")
    del rec_big, out_big, dev
    ms, copy_ms = t[37][:2]
    return dict(launches=launches, max_abs_err=0.0, ms=ms, plain_ms=copy_ms,
                bound_ms=bound, library_ms=copy_ms)


# -------------------------------------------------------------- phase 13
def phase_wide(torch, lt):
    """tests/test_hist_pool.py's wide shape on the card: n=4096, F=2000,
    max_bin 256, 255 leaves, histogram_pool_size=64 (10 slots), 2 trees
    through the entry points, counted and with its peak device memory."""
    from lightgbm_tpu_torch.learners import serial
    from lightgbm_tpu_torch.ops import launch_counts

    n, F = 4096, 2000
    rng = np.random.RandomState(5)
    X = rng.randn(n, F).astype(np.float32)
    y = (X[:, 0] + X[:, 1] * X[:, 2] > 0).astype(np.float32)
    params = {"objective": "binary", "num_leaves": NUM_LEAVES, "max_bin": 256,
              "min_data_in_leaf": 5, "histogram_pool_size": 64.0,
              "verbose": -1}
    t0 = time.perf_counter()
    with route_env("pooled"):
        booster = lt.Booster(params=params, train_set=lt.Dataset(
            X, label=y, max_bin=256, params=params))
        setup = time.perf_counter() - t0
        gb = booster._gbdt
        slots, B = gb._hist_pool_slots(), gb._num_bins
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        for _ in range(2):
            booster.update()
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        counts, recomputes = launch_counts(), serial.POOL_RECOMPUTES
        peak = torch.cuda.max_memory_allocated()
    trees = gb.models
    splits = sum(t.num_leaves - 1 for t in trees)
    want = dict.fromkeys(counts, 0)
    want.update({"K1": 2 + splits + recomputes, "K3": 2, "K5": splits})
    slot_bytes = F * B * 12
    say(f"[wide] n={n} F={F} B={B} slots={slots} leaves="
        f"{[t.num_leaves for t in trees]} recomputes={recomputes} "
        f"launches={json.dumps(counts)} setup {setup:.1f}s, 2 trees "
        f"{elapsed:.3f}s s/tree={elapsed / 2:.4f} peak_mem_bytes={peak} "
        f"(pool {slots * slot_bytes} B; unpooled {NUM_LEAVES * slot_bytes} B)")
    check(slots == 10, f"wide: {slots} slots, the JAX package's rule gives 10")
    check(counts == want and recomputes > 0,
          f"wide: launches {counts} != {want} or no parent rebuilt")
    check(all(t.num_leaves > 50 for t in trees), "wide: trees too small")
    check(bool(torch.isfinite(gb._scores).all()), "wide: scores not finite")
    check(peak < NUM_LEAVES * slot_bytes, f"wide: peak {peak} B is not "
          "under an unpooled buffer")
    del booster, gb, X
    return dict(s_per_tree=elapsed / 2, peak=peak, counts=counts)


# ------------------------------------------------------------ phases 14-16
# the JAX package's metrics on the same data and config, on the CPU:
#   JAX_PLATFORMS=cpu python tools/jax_growth_auc.py --growth leafwise \
#       --objective regression   (and multiclass, lambdarank)
#   (multiclass with --rows 300000: see MULTICLASS_BAND_ROWS)
OBJ_REF = {"regression": {"train": {"l2": 3.43718103887776},
                          "valid": {"l2": 3.466224429992701}},
           "multiclass": {"train": {"multi_logloss": 1.451367974898815,
                                    "multi_error": 0.48568666666666666},
                          "valid": {"multi_logloss": 1.4649656590491533,
                                    "multi_error": 0.5321833333333333}},
           "lambdarank": {"train": {"ndcg@1": 0.9251266666666533,
                                    "ndcg@3": 0.8979770361581438,
                                    "ndcg@5": 0.8767569234571149}}}
# Multiclass at 1M rows is not held to the JAX package's metrics (ROADMAP
# C3): both packages sum the root's Σh in row order in float32 (the JAX
# package's contract, which the port keeps); with every first-iteration
# hessian 0.32 that sum falls thousands short of its float64 value at 1M
# rows, one leaf of each class's tree takes the whole shortfall, and its
# value — so every metric — is float32 noise (the JAX package's own run:
# MULTICLASS_1M_JAX).  The phase prints the shortfall and that leaf beside
# both packages' metrics, and holds the metrics at MULTICLASS_BAND_ROWS,
# where the shortfall is a small fraction of that leaf's Σh.
MULTICLASS_1M_JAX = {"train": {"multi_logloss": 1.8999690012831953,
                               "multi_error": 0.528726},
                     "valid": {"multi_logloss": 1.895752716322266,
                               "multi_error": 0.54572}}
MULTICLASS_BAND_ROWS = 300_000
RMSE_REL_TOL, METRIC_TOL = 0.005, 0.005
RANK_CHECK_QUERIES = 1000  # plus every query of 600 rows or more


def _gradients_on_cpu(torch, kind, gb, scores, g, h):
    """The card's gradients against the plain (CPU) objective on the same
    scores: bitwise for regression and multiclass; LambdaRank to rtol
    1e-5 / atol 1e-7 on the first RANK_CHECK_QUERIES queries and every
    query of 600 rows or more (every bucket, the chunked ones included).
    Returns the count of differing values."""
    from lightgbm_tpu_torch.io.metadata import Metadata
    from lightgbm_tpu_torch.objectives import create_objective

    meta = gb.train_set.metadata
    if kind != "lambdarank":
        gc, hc = create_objective(gb.config, meta, gb.num_data, "cpu") \
            .get_gradients(scores.cpu())
        diff = int((gc != g.cpu()).sum() + (hc != h.cpu()).sum())
        check(diff == 0, f"main {kind}: card gradients differ from the "
              f"plain version's in {diff} values")
        return diff
    qb = meta.query_boundaries
    sizes = np.diff(qb)
    qs = np.flatnonzero((np.arange(len(sizes)) < RANK_CHECK_QUERIES)
                        | (sizes >= 600))
    rows = np.concatenate([np.arange(qb[q], qb[q + 1]) for q in qs])
    sub = Metadata(label=meta.label[rows],
                   query_boundaries=np.concatenate([[0],
                                                    np.cumsum(sizes[qs])]))
    idx = torch.from_numpy(rows).to(scores.device)
    out = []
    for dev in (scores.device, "cpu"):
        obj = create_objective(gb.config, sub, len(rows), dev)
        out.append([t.cpu() for t in obj.get_gradients(scores[idx].to(dev))])
    diff = 0
    for a, b in zip(*out):
        check(torch.allclose(a, b, rtol=1e-5, atol=1e-7),
              f"main {kind}: card gradients outside rtol 1e-5 of the plain "
              f"version's (max abs {float((a - b).abs().max())})")
        diff += int((a != b).sum())
    say(f"[main {kind}] card vs plain gradients on {len(qs)} queries "
        f"({len(rows)} rows, buckets up to {int(sizes[qs].max())} rows): "
        f"{diff} of {2 * len(rows)} values differ, all within rtol 1e-5")
    return diff


def _objective_metrics(kind, booster, train_set, valid, ref):
    """Train (and valid) metrics by name, checked against ``ref``."""
    got = {"train": {m: v for _, m, v, _ in booster.eval_train()}}
    if valid is not None:
        booster.add_valid(train_set.create_valid(*valid), "valid")
        got["valid"] = {m: v for _, m, v, _ in booster.eval_valid()}
    for split, vals in ref.items():
        for name, want in vals.items():
            v = got[split][name]
            tol = RMSE_REL_TOL * want if name == "l2" else METRIC_TOL
            check(abs(v - want) <= tol, f"main {kind}: {split} {name} {v} "
                  f"outside {want} +- {tol}")
    return got


def _root_sum_shortfall(torch, gb):
    """ROADMAP C3 on this run: the float32 row-order root Σh of the first
    iteration against its float64 sum, and each first-iteration tree's
    leaves that are off the exact Newton step (-lr Σg / Σh over the leaf's
    rows, float64) by more than 1e-3.  Fails unless leaf 0 (the leaf whose
    sums are the root's less its siblings', so the one the root's
    shortfall lands on) is the only such leaf of any class's tree."""
    from lightgbm_tpu_torch.models.tree import predict_leaf_binned

    g, h = gb.objective.get_gradients(torch.zeros_like(gb._scores))
    hk = h[0].cpu().numpy()
    s32 = float(np.cumsum(hk, dtype=np.float32)[-1])
    s64 = float(hk.astype(np.float64).sum())
    bins = gb._bins_T.T.to(torch.int32)
    off = []
    for k, tree in enumerate(gb.models[:gb.num_class]):
        L = tree.num_leaves
        lid = predict_leaf_binned(tree, bins).cpu().numpy()
        want = -gb.learning_rate * (
            np.bincount(lid, g[k].cpu().numpy().astype(np.float64), L)
            / np.bincount(lid, h[k].cpu().numpy().astype(np.float64), L))
        got = tree.leaf_value.cpu().numpy()[:L]
        bad = np.flatnonzero(np.abs(got - want) > 1e-3)
        off.append({"class": k, "leaves": bad.tolist(),
                    "value": got[bad[:1]].tolist(),
                    "newton": want[bad[:1]].tolist(),
                    "rows": np.bincount(lid, minlength=L)[bad[:1]].tolist()})
    say(f"[main multiclass] C3: root sum of h float32 row order {s32} "
        f"against float64 {s64} (short by {s64 - s32:.3f}); first-iteration "
        f"leaves off the Newton step: {json.dumps(off)}")
    check(all(set(o["leaves"]) <= {0} for o in off),
          "main multiclass: a first-iteration leaf other than leaf 0 is off "
          "its Newton step, which the root's float32 shortfall (C3) does "
          "not explain")


def phase_objective(torch, lt, card, kind, rows=ROWS):
    """A main path of another objective at full width on the default
    (mega) route: regression and five-class multiclass on the bench rows
    (1M + 200k x 28), LambdaRank on 10,000 MSLR-WEB10K-shaped queries
    (~1.38M rows x 136, 31 leaves).  Counts set to 0 just before the
    iterations and read just after: K1' and K3 once a tree, K8 and K7 once
    a split, 2 + splits host syncs a tree.  Then the gradients' device ms
    an iteration and peak memory, the card's gradients against the plain
    version's, and the metrics against the JAX package's."""
    from lightgbm_tpu_torch.learners import serial
    from lightgbm_tpu_torch.ops import launch_counts
    from lightgbm_tpu_torch.synthetic import ROUNDS, workload

    t0 = time.perf_counter()
    params, (X, y, group), valid = workload(
        kind, rows, n_valid=0 if kind == "lambdarank" else rows // 5)
    train_set = lt.Dataset(X, label=y, group=group,
                           max_bin=params["max_bin"], params=params)
    del X, y
    booster = lt.Booster(params=params, train_set=train_set)
    gb = booster._gbdt
    setup = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    for _ in range(ROUNDS[kind]):
        booster.update()
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    counts, syncs = launch_counts(), serial.HOST_SYNCS
    peak = torch.cuda.max_memory_allocated()
    trees = gb.models
    n, splits = len(trees), sum(t.num_leaves - 1 for t in trees)
    want = dict.fromkeys(counts, 0)
    want.update({"K1'": n, "K3": n, "K8": splits, "K7": splits})
    check(n == ROUNDS[kind] * gb.num_class, f"main {kind}: {n} trees")
    check(all(counts[k] > 0 for k in ("K1'", "K3", "K8", "K7")),
          f"main {kind}: a kernel of the mega route never launched")
    check(counts == want, f"main {kind}: launches {counts} != {want}")
    check(syncs == 2 * n + splits,
          f"main {kind}: {syncs} host syncs, expected {2 * n + splits}")
    # the gradients of one iteration, on the final scores
    scores = gb._scores if gb.num_class > 1 else gb._scores[0]
    grads = lambda: gb.objective.get_gradients(scores)  # noqa: E731
    grad_ms = time_ms(torch, grads, reps=5, warm=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    g, h = grads()
    torch.cuda.synchronize()
    grad_peak = torch.cuda.max_memory_allocated() - base
    diff = _gradients_on_cpu(torch, kind, gb, scores, g, h)
    held = not (kind == "multiclass" and rows == ROWS)  # ROADMAP C3
    ref = OBJ_REF[kind] if held else MULTICLASS_1M_JAX
    got = _objective_metrics(kind, booster, train_set, valid,
                             ref if held else {})
    if kind == "multiclass":
        _root_sum_shortfall(torch, gb)
    X = valid[0] if valid is not None else train_set.data
    pv = booster.predict(X[:1000])
    shape = (min(len(X), 1000),) + ((gb.num_class,) if gb.num_class > 1
                                    else ())
    check(pv.shape == shape and bool(np.isfinite(pv).all()),
          f"main {kind}: predictions")
    if gb.num_class > 1:
        check(bool((np.abs(pv.sum(1) - 1.0) <= 1e-6).all()),
              f"main {kind}: predicted rows do not sum to 1")
    say(f"[main {kind}] on {card}: rows={gb.num_data} F="
        f"{gb._bins_T.shape[0]} setup {setup:.1f}s, {n} trees "
        f"{elapsed:.3f}s s/tree={elapsed / n:.4f} "
        f"s/iteration={elapsed / ROUNDS[kind]:.4f} "
        f"gradient_ms/iteration={grad_ms:.3f} "
        f"gradient_peak_bytes={grad_peak} metrics={json.dumps(got)} "
        f"jax={json.dumps(ref)} "
        f"{'within the band' if held else 'not compared (C3)'} "
        f"host_syncs_per_tree={syncs / n:.1f} peak_mem_bytes={peak} "
        f"launches={json.dumps(counts)} "
        f"leaves={[t.num_leaves for t in trees]} "
        f"gradients card vs plain: {diff} values differ")
    del booster, gb, train_set, g, h, scores
    return dict(s_per_tree=elapsed / n, grad_ms=grad_ms, peak=peak)


# ----------------------------------------------------------------- phase 17
API_ROUNDS, API_STOP = 40, 3
API_RATES = [0.1] * 20 + [4.0] * 20


def _tree_texts(text: str):
    """The ``Tree=i`` blocks of a model text."""
    return text.split("feature importances:")[0].split("Tree=")[1:]


def _best_round(evals, train_name, stop):
    """(best iteration, 1-based; round it stops at, 0-based) by the early
    stopping callback's rule on a recorded history, or None."""
    keys = [(d, m) for d in evals for m in evals[d]]
    best = dict.fromkeys(keys, (None, 0))
    for i in range(len(evals[keys[0][0]][keys[0][1]])):
        for d, m in keys:
            v, bi = best[(d, m)]
            now = evals[d][m][i]
            if v is None or (now > v if m == "auc" else now < v):
                best[(d, m)] = (now, i)
            elif d != train_name and i - bi >= stop:
                return bi + 1, i
    return None


def _same_trees_bitwise(torch, a, b) -> bool:
    ok = len(a) == len(b)
    for ta, tb in zip(a, b):
        ok &= ta.num_leaves == tb.num_leaves
        ok &= all(bool(torch.equal(getattr(ta, k), getattr(tb, k)))
                  for k in TREE_FIELDS)
    return ok


def _timed_train(torch, fn):
    """(result, s, host syncs, peak B, launches) of ``fn()``, with every
    count set to 0 just before and read just after."""
    from lightgbm_tpu_torch.learners import serial
    from lightgbm_tpu_torch.ops import launch_counts

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (out, time.perf_counter() - t0, serial.HOST_SYNCS,
            torch.cuda.max_memory_allocated(), launch_counts())


def _mega_counts_ok(counts, trees, valid_sets=0) -> bool:
    """The mega route's launches for ``trees``, and one P2 launch a tree
    a valid set (the new tree's walk over its rows)."""
    splits = sum(t.num_leaves - 1 for t in trees)
    want = dict.fromkeys(counts, 0)
    want.update({"K1'": len(trees), "K3": len(trees), "K8": splits,
                 "K7": splits, "P2": len(trees) * valid_sets})
    return counts == want and splits > 0


def _builtin_fobj(torch, lt, params, train_set):
    """A custom objective returning the built-in objective's gradients:
    the port's objective on the card, fed the host scores ``train``
    hands a custom objective."""
    from lightgbm_tpu_torch.objectives import create_objective

    inner = train_set.construct()
    obj = create_objective(lt.Config.from_dict(params), inner.metadata,
                           inner.num_data, "cuda")

    def fobj(preds, _dataset):
        s = torch.from_numpy(preds).cuda().reshape(-1, inner.num_data)
        g, h = obj.get_gradients(s if s.shape[0] > 1 else s[0])
        return g.reshape(-1).cpu().numpy(), h.reshape(-1).cpu().numpy()

    return fobj


def phase_api(torch, lt, params, train_set, valid_set, Xv):
    """The training API on the bench data, mega route (see item 17)."""
    import tempfile

    from lightgbm_tpu_torch.synthetic import workload

    # leaf-wise and unpooled whatever the earlier phases' train calls
    # left in the dataset's merged parameters
    base = dict(params, metric=["binary_logloss", "auc"],
                tree_growth="leafwise", histogram_pool_size=0.0)
    with route_env("mega"):
        # the bare mega run: 20 rounds, no valid set
        plain, plain_s, plain_syncs, plain_peak, plain_n = _timed_train(
            torch, lambda: lt.train(dict(base), train_set, 20,
                                    verbose_eval=False))
        plain_trees = plain._gbdt.models
        check(_mega_counts_ok(plain_n, plain_trees),
              f"api: the plain run's launches {plain_n}")
        plain_text = _tree_texts(plain.model_to_string())
        # (a) early stopping with both sets, two metrics, a rate schedule
        evals = {}
        run_a, a_s, a_syncs, a_peak, a_n = _timed_train(torch, lambda: lt.train(
            dict(base), train_set, API_ROUNDS,
            valid_sets=[train_set, valid_set], valid_names=["train", "valid"],
            early_stopping_rounds=API_STOP, evals_result=evals,
            learning_rates=API_RATES, verbose_eval=False))
        a_trees = run_a._gbdt.models
        recomputed = _best_round(evals, "train", API_STOP)
        pa = run_a.predict(Xv)
        a_ok = (run_a.current_iteration < API_ROUNDS
                and recomputed is not None
                and recomputed[0] == run_a.best_iteration
                and recomputed[1] + 1 == run_a.current_iteration
                and np.array_equal(pa, run_a.predict(
                    Xv, num_iteration=run_a.best_iteration))
                and not np.array_equal(pa, run_a.predict(
                    Xv, num_iteration=API_ROUNDS))
                and _tree_texts(run_a.model_to_string(
                    num_iteration=20)) == plain_text)
        say(f"[api a] early stopping: stopped after "
            f"{run_a.current_iteration} of {API_ROUNDS} rounds, "
            f"best_iteration={run_a.best_iteration} (recomputed from "
            f"evals_result: {recomputed}), best_score="
            f"{json.dumps(run_a.best_score)}; predict default == "
            f"best_iteration bitwise, first 20 trees' text == the plain "
            f"run's: {a_ok}")
        check(a_ok, "api (a): early stopping")
        # what an iteration of (a) adds to the bare run's: each set's
        # evaluation (a host copy of its scores, auc and binary_logloss
        # on the host) and the new tree's walk over the valid rows (P2)
        from lightgbm_tpu_torch.models.tree import binned_table
        from lightgbm_tpu_torch.ops.predict import ensemble_update_binned_

        cost = {}
        for name, fn in (("eval_train", run_a.eval_train),
                         ("eval_valid", run_a.eval_valid),
                         ("valid_walk", lambda: ensemble_update_binned_(
                             run_a._gbdt._valid_scores[0].clone(),
                             binned_table(a_trees[-1:]),
                             run_a._gbdt._valid_bins[0], 0, 1.0))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            cost[name] = round(time.perf_counter() - t0, 4)
        say(f"[api a] host s of one iteration's extra work: "
            f"{json.dumps(cost)}")
        check(_mega_counts_ok(a_n, a_trees, valid_sets=1),
              f"api (a): launches {a_n} are not the mega route's")
        rows = {"a": (a_s / len(a_trees), a_syncs / len(a_trees), a_peak,
                      a_n),
                "plain": (plain_s / 20, plain_syncs / 20, plain_peak,
                          plain_n)}
        for run, (spt, spp, peak, n) in rows.items():
            say(f"[api {run}] s/tree={spt:.4f} learner host_syncs_per_tree="
                f"{spp:.1f} peak_mem_bytes={peak} launches={json.dumps(n)}")
        del run_a

        # (b) 10 + 10 from a saved file
        b10 = lt.train(dict(base), train_set, 10, valid_sets=[valid_set],
                       verbose_eval=False)
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "m10.txt")
            b10.save_model(path)
            cont = lt.Booster(dict(base, input_model=path), train_set)
            cont.add_valid(valid_set, "valid")
            replay_ok = (torch.equal(cont._gbdt._valid_scores[0],
                                     b10._gbdt._valid_scores[0])
                         and torch.equal(cont._gbdt._scores,
                                         b10._gbdt._scores))
            rebind = [(bool(torch.equal(t.threshold_bin[:t.num_leaves - 1],
                                        o.threshold_bin[:o.num_leaves - 1])))
                      for t, o in zip(cont._gbdt.models, b10._gbdt.models)]
            for _ in range(10):
                cont.update()
        cont_ok = _tree_texts(cont.model_to_string()) == plain_text
        say(f"[api b] 10 + 10 from a file: threshold_bin recovered in "
            f"{sum(rebind)}/10 trees; replayed train and valid scores == "
            f"the 10-tree booster's bitwise: {replay_ok}; 20 trees' text "
            f"== the plain run's: {cont_ok}")
        check(all(rebind) and replay_ok and cont_ok, "api (b): continued "
              "training")
        del b10, cont

        # (c) fobj with the built-in gradients
        fob = lt.train(dict(base), train_set, 10,
                       fobj=_builtin_fobj(torch, lt, base, train_set),
                       verbose_eval=False)
        fobj_ok = _same_trees_bitwise(torch, fob._gbdt.models,
                                      plain_trees[:10])
        del fob
        mparams, (X, y, _), _ = workload("multiclass", MULTICLASS_BAND_ROWS)
        mset = lt.Dataset(X, label=y, max_bin=mparams["max_bin"],
                          params=mparams)
        del X, y
        mc = [lt.train(dict(mparams), mset, 2, fobj=f, verbose_eval=False)
              for f in (None, _builtin_fobj(torch, lt, mparams, mset))]
        mc_ok = (len(mc[0]._gbdt.models) == 10
                 and _same_trees_bitwise(torch, mc[0]._gbdt.models,
                                         mc[1]._gbdt.models))
        say(f"[api c] fobj returning the built-in gradients: binary 10 "
            f"trees bitwise the plain run's: {fobj_ok}; multiclass "
            f"{MULTICLASS_BAND_ROWS} rows, 2 iterations (10 trees) bitwise "
            f"the built-in run's: {mc_ok}")
        check(fobj_ok and mc_ok, "api (c): fobj")
        del mc, mset

        # (d) snapshot / restore under bagging and feature fraction
        bag = lt.Booster(dict(base, bagging_fraction=0.8, bagging_freq=1,
                              feature_fraction=0.9), train_set)
        bag.add_valid(valid_set, "valid")
        bag.update()
        gb = bag._gbdt
        snap = gb.snapshot_state()
        runs = []
        for _ in range(2):
            gb.restore_state(snap)
            for _ in range(3):
                bag.update()
            runs.append((list(gb.models), gb._scores.clone(),
                         gb._valid_scores[0].clone()))
        snap_ok = (_same_trees_bitwise(torch, runs[0][0], runs[1][0])
                   and torch.equal(runs[0][1], runs[1][1])
                   and torch.equal(runs[0][2], runs[1][2]))
        # (e) rollback
        before = (gb._scores.clone(), gb._valid_scores[0].clone())
        bag.update()
        bag.rollback_one_iter()
        roll_err = max(float((gb._scores - before[0]).abs().max()),
                       float((gb._valid_scores[0] - before[1]).abs().max()))
        roll_ok = bag.current_iteration == 4 and roll_err <= 1e-6
        say(f"[api d] snapshot/restore, 3 iterations twice under bagging "
            f"0.8 / feature_fraction 0.9: bitwise {snap_ok}; [api e] "
            f"rollback_one_iter: iteration {bag.current_iteration}, scores "
            f"within {roll_err:.3g} of before (<= 1e-6: {roll_ok})")
        check(snap_ok, "api (d): snapshot/restore")
        check(roll_ok, "api (e): rollback")
        del bag, gb, snap, runs, before

        # (f) cross validation
        seen = {}
        hist, cv_s, cv_syncs, cv_peak, cv_n = _timed_train(torch, lambda: lt.cv(
            dict(base), train_set, num_boost_round=5, nfold=3,
            stratified=True, callbacks=[lambda env: seen.setdefault(
                "folds", env.model)]))
        folds = seen["folds"].boosters
        per_fold = [b.eval_valid() for b in folds]
        cv_ok = len(folds) == 3 and all(b.current_iteration == 5
                                        for b in folds)
        for j, (_, metric, _, _) in enumerate(per_fold[0]):
            vals = [f[j][2] for f in per_fold]
            cv_ok &= hist[f"valid {metric}-mean"][-1] == float(np.mean(vals))
        cv_trees = [t for b in folds for t in b._gbdt.models]
        cv_ok &= _mega_counts_ok(cv_n, cv_trees, valid_sets=1)
        say(f"[api f] cv 3 folds x 5 rounds (stratified): "
            f"{json.dumps({k: v[-1] for k, v in hist.items()})}; means == "
            f"the fold boosters' eval_valid means: {cv_ok}; "
            f"s/tree={cv_s / len(cv_trees):.4f} learner host_syncs_per_tree="
            f"{cv_syncs / len(cv_trees):.1f} peak_mem_bytes={cv_peak} "
            f"K8={cv_n['K8']} K7={cv_n['K7']}")
        check(cv_ok, "api (f): cv")
        cv_run = dict(base=dict(base), hist=hist, s=cv_s, peak=cv_peak,
                      texts=[b.model_to_string() for b in folds],
                      bins=[b._gbdt._bins_T for b in folds])
        del folds, seen
    return dict(a=rows["a"], plain=rows["plain"],
                cv=(cv_s / len(cv_trees), cv_syncs / len(cv_trees), cv_peak),
                cv_run=cv_run)


# ----------------------------------------------------------------- phase 24
# the root forms' cases (F1 over every lane's leaf 0, F3 on it): (name,
# lanes, rows, features, bins, bin dtype, leaves the rows are spread over,
# lanes with no row of leaf 0, timed)
ROOT_CASES = [("b1-n100", 1, 100, 28, 255, np.uint8, 1, (), False),
              ("b8-n2048", 8, 2048, 28, 255, np.uint8, 4, (2,), True),
              ("b8-n5000-u16", 8, 5000, 136, 300, np.uint16, 3, (5,),
               False),
              ("b64-n2048", 64, 2048, 28, 255, np.uint8, 8, (7,), True),
              ("b64-n5000-F136", 64, 5000, 136, 255, np.uint8, 2, (),
               False),
              ("b4-n1M", 4, ROWS, 28, 255, np.uint8, 1, (), True),
              ("b64-n1M", 64, ROWS, 28, 255, np.uint8, 64, (5,), True)]
# the step forms' cases: (name, lanes, active lanes (None: all), rows,
# features, bins, bin dtype, leaves the rows are spread over, lanes that
# split on a categorical feature, the lane whose split is a tie, timed)
STEP_CASES = [("b8-n2048", 8, None, 2048, 28, 255, np.uint8, 4, (), 1, True),
              ("b8-n5000-u16-inactive", 8, (0, 2, 3, 6), 5000, 28, 300,
               np.uint16, 3, (2,), 3, False),
              ("b64-n5000-F136-cat", 64, tuple(range(0, 64, 3)), 5000, 136,
               255, np.uint8, 4, (0, 9), 6, False),
              ("b64-n1M", 64, None, ROWS, 28, 255, np.uint8, 16, (5,), 2,
               True)]
# the forest's main paths: train_many over the first FOREST_ROWS bench
# rows, FOREST_MODELS models of FOREST_LEAVES leaves, FOREST_ROUNDS rounds
FOREST_ROWS, FOREST_MODELS, FOREST_ROUNDS, FOREST_LEAVES = 2048, 8, 50, 31
FOREST_PROFILED = 2  # rounds of (b)'s profiled call (the idle share)
FOREST_CLASSES, FOREST_MC_ROUNDS = 5, 20
FOREST_WIDE_MODELS, FOREST_WIDE_ROUNDS = 4, 3
FOREST_CLI_MODELS, FOREST_CLI_ROUNDS = 3, 5


def _root_case(torch, rng, B, n, F, nb, dt, leaves, empty):
    """CPU tensors of one root case: ~1/(leaves + 1) of each lane's rows
    outside every leaf (-1), the rest spread over the leaves (lanes
    ``empty`` with no row of leaf 0); meta (a tenth of the features
    categorical, every feature of the last lane masked); an L = 2 buffer
    of zeros; the lanes' search scalars from the plain roots' totals."""
    from lightgbm_tpu_torch.ops.cuda_search import pack_meta

    gen = np.random.default_rng(rng.randint(2 ** 31))  # bulk draws
    bins = torch.from_numpy(gen.integers(0, nb, (F, n), dtype=dt))
    g = torch.from_numpy(gen.standard_normal((B, n), np.float32))
    h = torch.from_numpy(np.abs(gen.standard_normal((B, n), np.float32)))
    m = torch.from_numpy((gen.random((B, n), np.float32) < 0.8).astype(
        np.float32))
    lid = gen.integers(-1, leaves, (B, n), dtype=np.int32)
    for b in empty:
        lid[b][lid[b] == 0] = -1
    fm = rng.rand(B, F) < 0.8
    fm[B - 1] = False  # a lane with every feature masked: no winner
    meta = torch.stack([pack_meta(torch.from_numpy(fm[a]),
                                  torch.full((F,), nb),
                                  torch.from_numpy(rng.rand(F) < 0.1),
                                  "cpu") for a in range(B)])
    return [bins, g, h, m, torch.from_numpy(lid)], meta, \
        torch.zeros((B, 2, F, nb, 3))


def _root_scal(rng, tot):
    """[B, 12] search scalars of B roots of totals ``tot`` [B, 3]: (can,
    the root's totals as both children's, the constraints)."""
    B = tot.shape[0]
    return np.column_stack([
        rng.rand(B) < 0.9, tot, tot, rng.choice([1.0, 5.0, 20.0], B),
        rng.choice([0.0, 1e-3], B), rng.choice([0.0, 0.5], B),
        rng.choice([0.5, 1.0, 10.0], B),
        rng.choice([0.0, 0.1], B)]).astype(np.float32)


def _f1_library(torch, bins, g, h, m, lid, nb):
    """One ``index_add_`` of every lane's sums over its rows of leaf 0
    (the library yardstick: the same function, unordered)."""
    F = bins.shape[0]
    lane, row = torch.nonzero(lid == 0, as_tuple=True)
    keys = ((lane[None] * F + torch.arange(F, device="cuda")[:, None]) * nb
            + bins[:, row].to(torch.int64)).reshape(-1)
    mm = m[lane, row]
    src = torch.stack([g[lane, row] * mm, h[lane, row] * mm, mm],
                      -1).repeat(F, 1)
    B = g.shape[0]
    return lambda: torch.zeros(B * F * nb, 3, device="cuda").index_add_(
        0, keys, src), int(row.numel())


def _f1_bound(B, n, F, members, nb, bin_bytes, parent=0, moved=0):
    """F1's least ms: the lanes' map (4 B a row a lane), in the step form
    the split feature's bin of each of the ``parent`` rows of the split
    leaves and the new leaf id of each of the ``moved`` rows that go
    right, each member's bins and stats, the histograms out; or its adds
    at the f32 peak."""
    nbytes = (4 * B * n + parent * bin_bytes + 4 * moved
              + members * (F * bin_bytes + 12) + B * F * nb * 12)
    return max(nbytes / HBM_BYTES_PER_S, 3 * F * members / F32_FLOPS) * 1e3


def _step_case(torch, rng, B, act, n, F, nb, dt, leaves, cat, tie):
    """CPU tensors of one step: a map over ``leaves`` leaves (-1 outside
    the root sets), meta (feature 0 categorical), a random buffer, and the
    step of lanes ``act`` (default all), each splitting leaf 0 on its own
    feature at its own threshold (lanes ``cat`` on feature 0; lane ``tie``
    at a feature's median bin that gives 2 * nleft == pcnt)."""
    from lightgbm_tpu_torch.ops.cuda_search import pack_meta

    act = np.arange(B) if act is None else np.asarray(act)
    gen = np.random.default_rng(rng.randint(2 ** 31))  # bulk draws
    bins = gen.integers(0, nb, (F, n), dtype=dt)
    lid = gen.integers(-1, leaves, (B, n), dtype=np.int32)
    is_cat = np.zeros(F, bool)
    is_cat[0] = True
    feats = rng.randint(1, F, len(act))
    thrs = rng.randint(0, nb, len(act))
    for i, b in enumerate(act):
        if b in cat:
            feats[i], thrs[i] = 0, int(bins[0][lid[b] == 0][0])
        if b == tie:  # an even count, split at its median
            rows = np.flatnonzero(lid[b] == 0)
            if len(rows) % 2:
                lid[b, rows[-1]] = -1
                rows = rows[:-1]
            h = len(rows) // 2
            for f in range(1, F):  # a feature whose median splits evenly
                v = np.sort(bins[f][rows])
                if h and v[h - 1] < v[h]:
                    feats[i], thrs[i] = f, v[h - 1]
                    break
    pcnt = (lid[act] == 0).sum(1)
    L = leaves + 1
    t = [torch.from_numpy(x) for x in (
        bins, gen.standard_normal((B, n), np.float32),
        np.abs(gen.standard_normal((B, n), np.float32)),
        (gen.random((B, n), np.float32) < 0.8).astype(np.float32), lid)]
    meta = torch.stack([pack_meta(torch.from_numpy(rng.rand(F) < 0.8),
                                  torch.full((F,), nb),
                                  torch.from_numpy(is_cat), "cpu")
                        for _ in range(B)])
    hists = torch.from_numpy(gen.random((B, L, F, nb, 3), np.float32))
    scal = np.column_stack([np.ones(len(act)), rng.rand(len(act), 6) * 100,
                            np.tile([5.0, 1e-3, 0.0, 1.0, 0.0],
                                    (len(act), 1))]).astype(np.float32)
    spec = (act, np.zeros(len(act), np.int64), feats, thrs, is_cat[feats],
            pcnt, leaves, scal)
    return t, meta, hists, spec


def _same_bits(a, b) -> bool:
    """Two tensors of 4-byte elements hold the same bits (NaN, -0 too),
    compared where they lie (on the CPU where either does)."""
    import torch

    if a.device != b.device:
        a, b = a.cpu(), b.cpu()
    return a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def _restored_ms(torch, restore, fn, reps: int = 20, warm: int = 3):
    """``time_ms`` of ``fn`` with ``restore()`` run and finished before
    each call (outside the events)."""
    for _ in range(warm):
        restore()
        fn()
    times = []
    for _ in range(reps):
        restore()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def phase_forest_kernels(torch):
    """F1 and F3 against their plain versions (on the CPU), bitwise, in
    both forms, through ``ForestStep``, the grower's entry.  Root forms
    (``root_histogram`` into ``hists[:, 0]``, then ``root_search``): two
    calls bitwise equal, the buffer's other row untouched, at B = 1-64
    lanes, 100 to 1M rows (the root in one or two lane batches), u8 and
    u16 bins, F = 28 and 136, lanes with an empty root and with every
    feature masked.  Step forms: the map, the smaller children, the left
    counts, the buffer and the rows, at 8 and 64 lanes, inactive lanes,
    ties, categorical splits, u16 bins, F = 136 and 64 lanes x 1M rows
    with the scratch sized from the step's parents, two ForestSteps on
    fresh copies equal.  Times each form a call (CUDA events) and on the
    device (queued), beside its plain version on the card (F1's root form
    also beside one ``index_add_``); a timed step starts from the map
    before the step each call."""
    from lightgbm_tpu_torch.ops import cuda_forest
    from lightgbm_tpu_torch.ops.forest import (forest_histogram_plain,
                                               forest_search_plain,
                                               forest_search_step_plain,
                                               forest_split_plain)

    rng = np.random.RandomState(24)
    records, batches = {}, 0
    for (name, B, n, F, nb, dt, leaves, empty, timed_) in ROOT_CASES:
        t_case = time.perf_counter()
        cpu, meta, hbuf = _root_case(torch, rng, B, n, F, nb, dt, leaves,
                                     empty)
        zeros = torch.zeros(B, dtype=torch.int32)
        plain = forest_histogram_plain(*cpu, zeros, nb)
        scal = _root_scal(rng, plain[:, 0].sum(1).numpy())
        plain_rows = forest_search_plain(plain, plain, meta,
                                         torch.from_numpy(scal))
        dev = [t.cuda() for t in cpu]
        fs = cuda_forest.ForestStep(*dev, nb, meta=meta.cuda(),
                                    hists=hbuf.cuda())
        c0 = cuda_forest.LAUNCHES
        k1 = fs.root_histogram().clone()
        calls = cuda_forest.LAUNCHES - c0
        batches = max(batches, calls)
        r1 = fs.root_search(scal).clone()
        r2 = fs.root(scal)
        torch.cuda.synchronize()
        k2 = fs.hists[:, 0]
        err = float((k1.cpu() - plain).abs().max())
        check(torch.equal(k1, k2) and _same_bits(r1, r2),
              f"forest root {name}: two calls differ")
        check(int(torch.count_nonzero(fs.hists[:, 1])) == 0,
              f"forest F1 root {name}: wrote outside hists[:, 0]")
        check(torch.equal(k1.cpu(), plain),
              f"forest F1 root {name}: differs from its plain version "
              f"(max abs {err})")
        check(_same_bits(r1, plain_rows),
              f"forest F3 root {name}: differs from its plain version")
        wins = int((plain_rows[:, :, 1] >= 0).sum())
        line = (f"[forest root {name}] B={B} n={n} F={F} bins={nb} "
                f"{np.dtype(dt).name} empty={list(empty)} F1 calls={calls} "
                f"children with a winner={wins}/{2 * B} bitwise: two calls, "
                "F1 (hists[:, 0]) and F3 (rows) == plain (CPU)")
        if timed_:
            f1, f3 = fs.root_histogram, (lambda: fs.root_search(scal))
            lib, members = _f1_library(torch, *dev, nb)
            ms, dev_ms = time_ms(torch, f1), queued_ms(torch, f1)
            zd = zeros.cuda()
            plain_ms = time_ms(torch, lambda: forest_histogram_plain(
                *dev, zd, nb), reps=3, warm=1)
            lib_ms = time_ms(torch, lib)
            bound = _f1_bound(B, n, F, members, nb, dev[0].element_size())
            records[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                 bound_ms=bound, library_ms=lib_ms,
                                 device_ms=dev_ms)
            ms3, dev3 = time_ms(torch, f3), queued_ms(torch, f3)
            b3 = (B * F * nb * 12 + B * F * 16 + B * 80 + B * 128) \
                / HBM_BYTES_PER_S * 1e3
            line += (f" member_rows={members}; F1 root ms={ms:.4f} "
                     f"device_ms={dev_ms:.4f} plain_ms={plain_ms:.4f} "
                     f"library_ms={lib_ms:.4f} bound_ms={bound:.5f} "
                     f"share={bound / ms:.4f} "
                     f"faster_than_index_add={ms < lib_ms}; F3 root "
                     f"ms={ms3:.4f} device_ms={dev3:.4f} "
                     f"bound_ms={b3:.5f}")
            del lib, zd
        say(f"{line} case_s={time.perf_counter() - t_case:.1f}")
        del dev, fs, k1, k2, r1, r2, cpu, hbuf, plain
        torch.cuda.empty_cache()
    check(batches > 1, "forest root: no case ran F1's root form in more "
          "than one lane batch")
    for (name, B, act, n, F, nb, dt, leaves, cat, tie,
         timed_) in STEP_CASES:
        t_case = time.perf_counter()
        cpu, meta, hbuf, spec = _step_case(torch, rng, B, act, n, F, nb,
                                           dt, leaves, cat, tie)
        A, pcnt = len(spec[0]), spec[5]
        # the plain step on CPU copies: F1's part, then F3's
        lid_p, hbuf_p = cpu[4].clone(), hbuf.clone()
        h_small, nleft, small_left = forest_split_plain(
            *cpu[:4], lid_p, nb, *spec[:7])
        rows_p = forest_search_step_plain(hbuf_p, meta, h_small, nleft,
                                          small_left, spec[0], spec[1],
                                          spec[6], spec[7])
        ties = int((2 * nleft == torch.from_numpy(pcnt)).sum())
        outs = []
        for _ in range(2):  # two ForestSteps on fresh copies
            dev = [t.cuda() for t in cpu]
            fs = cuda_forest.ForestStep(*dev, nb, max_rows=int(pcnt.max()),
                                        meta=meta.cuda(), hists=hbuf.cuda())
            hk = fs.split_histogram(*spec).clone()
            info = fs.lane_info[:A].clone()
            rows = fs.search()
            torch.cuda.synchronize()
            outs.append((hk, info, rows.clone(), dev[4], fs.hists))
        (hk, info, rows, lid_k, hb_k), second = outs[0], outs[1]
        check(all(_same_bits(x, y) for x, y in zip(outs[0], second)),
              f"forest step {name}: two ForestSteps differ")
        err = float((hk.cpu() - h_small).abs().max())
        check(torch.equal(hk.cpu(), h_small)
              and torch.equal(info[:, 1].cpu().long(), nleft)
              and torch.equal(info[:, 2].cpu() == 0, small_left)
              and torch.equal(lid_k.cpu(), lid_p),
              f"forest F1 step {name}: differs from its plain version "
              f"(max abs {err})")
        check(_same_bits(rows, rows_p) and _same_bits(hb_k, hbuf_p),
              f"forest F3 step {name}: differs from its plain version")
        line = (f"[forest step {name}] B={B} active={A} n={n} F={F} "
                f"bins={nb} {np.dtype(dt).name} categorical lanes="
                f"{list(cat)} ties={ties} smaller right="
                f"{int((~small_left).sum())} max_rows={int(pcnt.max())} "
                "bitwise: two ForestSteps, F1 (map, smaller children, "
                "left counts) and F3 (rows, buffer) == plain (CPU)")
        if timed_:
            # every timed F1 call is the step itself: the map before the
            # step is restored before it (device ms: the queued restores'
            # own ms taken off); F3 re-splits the rows the step wrote
            smalls, parent = int(info[:, 0].sum()), int(pcnt.sum())
            moved = parent - int(info[:, 1].sum())
            lid0 = cpu[4].cuda()
            f1 = lambda: fs.split_histogram(*spec)  # noqa: E731
            restore = lambda: dev[4].copy_(lid0)  # noqa: E731

            def f1_restored():
                restore()
                f1()

            ms = _restored_ms(torch, restore, f1)
            dev_ms = queued_ms(torch, f1_restored) - queued_ms(torch,
                                                               restore)
            check(torch.equal(fs.lane_info[:A], info),
                  f"forest F1 step {name}: a timed call differs")
            bufs = fs.hists.clone()

            def f1_plain():
                return forest_split_plain(*dev[:4], dev[4], nb, *spec[:7])

            plain_ms = _restored_ms(torch, restore, f1_plain, reps=3, warm=1)
            bound = _f1_bound(A, n, F, smalls, nb, dev[0].element_size(),
                              parent=parent, moved=moved)
            records[f"F1 step {name}"] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                library_ms=None, device_ms=dev_ms)
            f3 = fs.search
            ms3, dev3 = time_ms(torch, f3), queued_ms(torch, f3)
            restore()
            hs, nl, sl = f1_plain()
            plain3 = time_ms(torch, lambda: forest_search_step_plain(
                bufs, fs.meta, hs, nl, sl, spec[0], spec[1], spec[6],
                spec[7]), reps=2, warm=1)
            b3 = (4 * A * F * nb * 12 + A * F * 16 + A * 80 + A * 128) \
                / HBM_BYTES_PER_S * 1e3
            records[f"F3 step {name}"] = dict(
                max_abs_err=0.0, ms=ms3, plain_ms=plain3, bound_ms=b3,
                library_ms=None, device_ms=dev3)
            line += (f" smaller_rows={smalls} parent_rows={parent} "
                     f"moved_rows={moved}; F1 step ms={ms:.4f} "
                     f"device_ms={dev_ms:.4f} plain_ms={plain_ms:.4f} "
                     f"bound_ms={bound:.5f} share={bound / ms:.4f}; F3 step "
                     f"ms={ms3:.4f} device_ms={dev3:.4f} "
                     f"plain_ms={plain3:.4f} bound_ms={b3:.5f}")
            del bufs, hs, lid0
        say(f"{line} case_s={time.perf_counter() - t_case:.1f}")
        del outs, second, dev, fs, hk, rows, lid_k, hb_k, cpu, hbuf
        del lid_p, hbuf_p, h_small
        torch.cuda.empty_cache()
    return records


def _forest_run(torch, fn, rounds, profiled=0):
    """(result, s a round, host syncs a round, F1 and F3 launches a round,
    peak device bytes) of ``fn()`` with every count set to 0 just before
    and read just after; with ``profiled`` > 0 the device idle share of a
    second, profiled call of ``fn(profiled)`` too and, where it grows
    lanes, the device events a forest step (else None)."""
    from lightgbm_tpu_torch.learners import serial
    from lightgbm_tpu_torch.ops import launch_counts
    from lightgbm_tpu_torch.profile_slice import _busy_us

    torch.cuda.synchronize()
    gc.collect()  # earlier runs' boosters in reference cycles
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    out = fn(rounds)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = launch_counts()
    rec = dict(s_round=wall / rounds, syncs=serial.HOST_SYNCS / rounds,
               f1=n["F1"] / rounds, f3=n["F3"] / rounds, counts=n,
               peak=torch.cuda.max_memory_allocated(), idle=None,
               step_events=None)
    if profiled:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn(profiled)
            torch.cuda.synchronize()
            pwall = time.perf_counter() - t0
        ev = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
        rec["idle"] = 1.0 - _busy_us(ev) * 1e-6 / pwall
        # a forest step's device events: the median count from one step's
        # F3 launch to the next (a round's root and boosting fall between
        # the rounds' last and first steps only)
        ev.sort(key=lambda e: e.time_range.start)
        at = [i for i, e in enumerate(ev) if "lane_step_kernel" in e.name]
        if len(at) > 1:
            rec["step_events"] = float(np.median(np.diff(at)))
    return out, rec


def _texts(boosters):
    return [b.model_to_string() for b in boosters]


def _forest_say(tag, rec):
    idle = "not measured" if rec["idle"] is None else f"{rec['idle']:.4f}"
    steps = ("" if rec["step_events"] is None
             else f" device_events_a_step={rec['step_events']:.1f}")
    say(f"[forest {tag}] s/round={rec['s_round']:.4f} host_syncs/round="
        f"{rec['syncs']:.1f} F1/round={rec['f1']:.1f} F3/round="
        f"{rec['f3']:.1f} device_idle_share={idle}{steps} "
        f"peak_mem_bytes={rec['peak']} launches={json.dumps(rec['counts'])}")


def phase_forest(torch, lt, params, train_set, cv_run):
    """The forest's main paths (b-e) on the bench data: ``train_many`` of
    8 models at 2,048 rows as lanes against sequential rounds (order route:
    bitwise; mega route: printed), 5-class multiclass lanes against the
    class loop, 4 models at 1M rows x 255 leaves as lanes against
    sequential rounds, and phase 17's bin-once cv folds against the
    subset-trained folds; each run's s/round, host syncs, F1/F3 launches,
    idle share and peak memory."""
    from lightgbm_tpu_torch.learners import forest

    saved_params = dict(train_set.params)
    X, y = train_set.data, np.asarray(train_set.label)
    base = dict(objective="binary", num_leaves=FOREST_LEAVES,
                max_bin=NUM_BINS, min_data_in_leaf=20, verbose=-1)
    plist = [dict(base, learning_rate=float(lr), lambda_l2=float(l2),
                  feature_fraction=float(ff), feature_fraction_seed=2 + i,
                  seed=i)
             for i, (lr, l2, ff) in enumerate(zip(
                 np.linspace(0.05, 0.4, FOREST_MODELS),
                 np.linspace(0.0, 10.0, FOREST_MODELS),
                 np.linspace(0.6, 1.0, FOREST_MODELS)))]
    small = lt.Dataset(X[:FOREST_ROWS], label=y[:FOREST_ROWS],
                       max_bin=NUM_BINS)

    def many(ps, knob, ds=small):
        return lambda r: lt.train_many(
            [dict(p, forest_batching=knob) for p in ps], ds, r)

    # ---- (b) train_many: lanes, then sequential rounds, order route
    with route_env("order"):
        lanes, rec_l = _forest_run(torch, many(plist, "on"), FOREST_ROUNDS,
                                   profiled=FOREST_PROFILED)
        rec_l["mm"] = dict(lanes[0]._gbdt._memmodel_params(),
                           forest_batch=len(lanes))
        seq, rec_s = _forest_run(torch, many(plist, "off"), FOREST_ROUNDS,
                                 profiled=FOREST_PROFILED)
    with route_env("mega"):
        mega, rec_m = _forest_run(torch, many(plist, "off"), FOREST_ROUNDS,
                                  profiled=FOREST_PROFILED)
    same = _texts(lanes) == _texts(seq)
    same_mega = _texts(mega) == _texts(seq)
    trees = sum(b.num_trees() for b in lanes)
    splits = sum(t.num_leaves - 1 for b in lanes for t in b._gbdt.models)
    for tag, rec in (("b lanes", rec_l), ("b sequential order", rec_s),
                     ("b sequential mega", rec_m)):
        _forest_say(tag, rec)
    say(f"[forest b] train_many {FOREST_MODELS} models x {FOREST_ROUNDS} "
        f"rounds at {FOREST_ROWS} rows, {trees} trees, {splits} splits: "
        f"lanes == sequential (order route) bitwise: {same}; mega route's "
        f"trees == the order route's: {same_mega}; grow_forest calls "
        f"{forest.DISPATCHES}")
    check(same, "forest (b): lanes differ from sequential rounds")
    check(rec_l["counts"]["F1"] > 0 and rec_l["counts"]["F3"] > 0
          and rec_s["counts"]["F1"] == 0,
          "forest (b): lanes never launched F1/F3, or sequential did")
    # the lanes' launches: one F1 and F3 at each round's root, one each a
    # forest step (every step of a round splits at least one lane)
    launches = dict(F1=rec_l["counts"]["F1"], F3=rec_l["counts"]["F3"])
    del lanes, seq, mega

    # ---- (c) multiclass lanes against the class loop, order route
    cls = np.digitize(X[:FOREST_ROWS, 0] + X[:FOREST_ROWS, 1],
                      np.quantile(X[:FOREST_ROWS, 0] + X[:FOREST_ROWS, 1],
                                  [0.2, 0.4, 0.6, 0.8])).astype(np.float32)
    mc = lt.Dataset(X[:FOREST_ROWS], label=cls, max_bin=NUM_BINS)
    mp = dict(base, objective="multiclass", num_class=FOREST_CLASSES)
    with route_env("order"):
        on, rec_on = _forest_run(torch, lambda r: lt.train(
            dict(mp, forest_batching="on"), mc, r), FOREST_MC_ROUNDS)
        off, rec_off = _forest_run(torch, lambda r: lt.train(
            dict(mp, forest_batching="off"), mc, r), FOREST_MC_ROUNDS)
    same_mc = on.model_to_string() == off.model_to_string()
    _forest_say("c multiclass lanes", rec_on)
    _forest_say("c multiclass class loop", rec_off)
    say(f"[forest c] multiclass {FOREST_CLASSES} classes x "
        f"{FOREST_MC_ROUNDS} iterations at {FOREST_ROWS} rows: lanes == "
        f"class loop bitwise: {same_mc}")
    check(same_mc and rec_on["counts"]["F1"] > 0,
          "forest (c): multiclass lanes differ from the class loop")
    del on, off

    # ---- (d) full width: 4 models at 1M rows x 255 leaves
    wide = [dict(p, num_leaves=NUM_LEAVES, min_data_in_leaf=MIN_DATA)
            for p in plist[:FOREST_WIDE_MODELS]]
    with route_env("order"):
        w_on, rec_won = _forest_run(torch, many(wide, "on", train_set),
                                    FOREST_WIDE_ROUNDS)
        rec_won["mm"] = dict(w_on[0]._gbdt._memmodel_params(),
                             forest_batch=len(w_on))
        w_off, rec_woff = _forest_run(torch, many(wide, "off", train_set),
                                      FOREST_WIDE_ROUNDS)
    same_w = _texts(w_on) == _texts(w_off)
    _forest_say("d 1M lanes", rec_won)
    _forest_say("d 1M sequential order", rec_woff)
    say(f"[forest d] {FOREST_WIDE_MODELS} models x {FOREST_WIDE_ROUNDS} "
        f"rounds at {ROWS} rows x {N_FEAT} features x {NUM_BINS} bins, "
        f"{NUM_LEAVES} leaves: lanes == sequential (order route) bitwise: "
        f"{same_w}; leaves={[t.num_leaves for b in w_on for t in b._gbdt.models]}")
    check(same_w, "forest (d): 1M-row lanes differ from sequential rounds")
    del w_on, w_off
    train_set.params = saved_params

    # ---- (e) phase 17's bin-once cv folds against subset-trained folds
    folds = {}
    with route_env("mega"):
        hist_sub, rec_sub = _forest_run(torch, lambda r: lt.cv(
            dict(cv_run["base"]), train_set, num_boost_round=r, nfold=3,
            stratified=True, fpreproc=lambda tr, te, p: (tr, te, p),
            callbacks=[lambda env: folds.setdefault("f", env.model)]), 5)
    sub = folds["f"].boosters
    same_cv = _texts(sub) == cv_run["texts"]
    same_mean = all(hist_sub[k] == cv_run["hist"][k]
                    for k in hist_sub if k.endswith("-mean"))
    up_once = sum({id(t): t.numel() * t.element_size()
                   for t in cv_run["bins"]}.values())
    up_sub = sum(b._gbdt._bins_T.numel() * b._gbdt._bins_T.element_size()
                 for b in sub)
    say(f"[forest e] cv 3 stratified folds x 5 rounds at {ROWS} rows (mega "
        f"route): bin-once folds == subset-trained folds bitwise: "
        f"{same_cv}; -mean metrics equal: {same_mean}; bin-once "
        f"s/round={cv_run['s'] / 5:.4f} peak_mem_bytes={cv_run['peak']} "
        f"binned bytes uploaded={up_once} (one shared matrix, resident "
        f"since phase 8); subset s/round={rec_sub['s_round']:.4f} "
        f"peak_mem_bytes={rec_sub['peak']} binned bytes uploaded={up_sub} "
        f"(a copy a fold)")
    check(same_cv and same_mean,
          "forest (e): bin-once folds differ from subset-trained folds")
    del sub, folds
    return dict(launches=launches, b=(rec_l, rec_s, rec_m),
                d=(rec_won, rec_woff))


def phase_forest_cli(torch, lt, files):
    """(f) ``task=train_many`` through the CLI on phase 19's valid file:
    model i bitwise ``task=train`` with ``seed=i``."""
    from lightgbm_tpu_torch import cli

    out = os.path.join(FILES_DIR, "forest_m.txt")
    common = [f"data={files['valid']}", "objective=binary",
              f"num_iterations={FOREST_CLI_ROUNDS}", "num_leaves=63",
              f"max_bin={NUM_BINS}"]
    t0 = time.perf_counter()
    _run_cli(torch, cli, ["task=train_many", f"num_models="
                          f"{FOREST_CLI_MODELS}", f"output_model={out}"]
             + common)
    many_s = time.perf_counter() - t0
    same = []
    for i in range(FOREST_CLI_MODELS):
        one = f"{out}.alone{i}"
        _run_cli(torch, cli, ["task=train", f"seed={i}",
                              f"output_model={one}"] + common)
        with open(f"{out}.{i}") as a, open(one) as b:
            same.append(a.read() == b.read())
    say(f"[forest f] task=train_many num_models={FOREST_CLI_MODELS} x "
        f"{FOREST_CLI_ROUNDS} iterations on {VALID_ROWS} rows in "
        f"{many_s:.2f}s: output_model.i == task=train seed=i bitwise: "
        f"{same}")
    check(all(same), "forest (f): task=train_many models differ from "
          "task=train")


# ----------------------------------------------------------------- phase 21
# DART's train/valid AUC of the JAX package on the same data and config
# (synthetic.workload(boosting="dart"), DART_ROUNDS rounds), on the CPU:
#   JAX_PLATFORMS=cpu python tools/jax_growth_auc.py --growth leafwise \
#       --boosting dart   (81.7 s on the CPU)
DART_AUC = (0.876573, 0.865780)
GUARD_ROWS, GUARD_LEAVES = 100_000, 63
# the scales DART and rollback give P2: add, subtract, renormalise (k = 2
# drops: keep = 2/3) and the valid sets' keep - 1
P2_SCALES = (1.0, -1.0, 2.0 / 3.0, 2.0 / 3.0 - 1.0)
P2_WIDE_F = 2000  # P2's wide configuration: 2,000 uint8 bins a row
P2_NARROW_F = 136  # LambdaRank's width: records through L1, or 128 rows
# P2 before its redesign (NVIDIA H100 80GB HBM3, 700.00 W; the final
# run, PERF.md section 6): one tree's ms a call and device ms, 3 trees and
# the replay of 30 trees, a call
P2_BEFORE_MS = {"train_1M": (0.1064, 0.0292, 0.1170, None),
                "valid_200k": (0.0596, 0.0092, None, 0.2150)}


@contextlib.contextmanager
def p2_route(torch, plain=False, strict=False):
    """Inside, the boosting layer's binned walks (the table build, P2's
    update and replay as models/gbdt.py and models/dart.py bind them) run
    P2's plain version on the card when ``plain``, and under
    ``torch.cuda.set_sync_debug_mode("error")`` when ``strict`` (any host
    sync raises).  Yields each kind's call count."""
    from lightgbm_tpu_torch.models import dart, gbdt, tree

    calls = {"table": 0, "update": 0, "replay": 0}
    new = {(gbdt, "binned_table"): ("table", tree.binned_table),
           (dart, "binned_table"): ("table", tree.binned_table),
           (gbdt, "ensemble_update_binned_"): (
               "update", tree.binned_update_ if plain
               else gbdt.ensemble_update_binned_),
           (gbdt, "ensemble_replay_binned_"): (
               "replay", tree.binned_replay_ if plain
               else gbdt.ensemble_replay_binned_)}
    saved = {k: getattr(*k) for k in new}

    def wrap(kind, fn):
        def run(*a, **kw):
            calls[kind] += 1
            if not strict:
                return fn(*a, **kw)
            torch.cuda.set_sync_debug_mode("error")
            try:
                return fn(*a, **kw)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        return run

    for (mod, attr), (kind, fn) in new.items():
        setattr(mod, attr, wrap(kind, fn))
    try:
        yield calls
    finally:
        for (mod, attr), fn in saved.items():
            setattr(mod, attr, fn)


def _p2_hold(torch, name, bins, K, calls):
    """P2 against its plain version on the card, bitwise, from the same
    random [K, n] scores, through ``calls`` in turn: ``(table, c0,
    scale)`` in update mode, ``(table, None, chunk)`` in replay mode; two
    launches equal.  Each call runs in the configuration p2_config picks
    for its shape.  Returns (the largest absolute difference, 0.0; the
    configurations the calls ran in)."""
    from lightgbm_tpu_torch.models import tree as pt
    from lightgbm_tpu_torch.ops import cuda_predict_binned as P2

    gen = torch.Generator(device="cuda").manual_seed(len(name))
    init = torch.randn((K, bins.shape[1]), device="cuda", generator=gen)
    plain = init.clone()
    runs = [init.clone(), init.clone()]
    F, n = bins.shape
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    configs = set()
    for table, c0, x in calls:
        if c0 is None:
            pt.binned_replay_(plain, table, bins, K, x)
        else:
            pt.binned_update_(plain, table, bins, c0, x)
        for r in runs:
            if c0 is None:
                P2.binned_replay_cuda_(r, table, bins, K, x)
            else:
                P2.binned_update_cuda_(r, table, bins, c0, x)
        configs.add(P2.p2_config(n, F, bins.element_size(), table.num_trees,
                                 K, sms, table.max_steps, c0 is None))
    torch.cuda.synchronize()
    err = float((runs[0] - plain).abs().max())
    ok = torch.equal(runs[0], runs[1]) and torch.equal(runs[0], plain)
    mode = ("replay chunk " + str(calls[0][2]) if calls[0][1] is None
            else "update " + ", ".join(f"c0={c} x{sc:.4g}"
                                       for _, c, sc in calls))
    say(f"[dart p2 hold] {name}: {sum(c[0].num_trees for c in calls)} "
        f"trees, K={K}, bins {tuple(bins.shape)} {str(bins.dtype)[6:]}, "
        f"{mode}, configs {sorted(configs)}: bitwise the plain version and "
        f"two launches equal: {ok}")
    check(ok, f"dart: P2 differs from its plain version at {name}")
    return err, configs


def _scaled(trees, c0=0):
    """A list of trees as four update calls, one a quarter of the list,
    each with one of P2_SCALES: every scale DART and rollback give."""
    from lightgbm_tpu_torch.models.tree import binned_table

    q = -(-len(trees) // 4)
    return [(binned_table(trees[i * q:(i + 1) * q]), c0, P2_SCALES[i])
            for i in range(4) if trees[i * q:(i + 1) * q]]


def _spread(torch, trees, bins, F, dtype, seed):
    """The trees' columns spread over ``F`` features of ``dtype`` (the
    others random bins below 255): wider rows over the same walks."""
    rng = np.random.RandomState(seed)
    perm = rng.choice(F, bins.shape[0], replace=False)
    pdev = torch.from_numpy(perm.astype(np.int32)).cuda()
    out = [t.replace(split_feature=torch.where(
        t.split_feature >= 0, pdev[t.split_feature.clamp(min=0).long()],
        t.split_feature)) for t in trees]
    wb = rng.randint(0, 255, (F, bins.shape[1])).astype(
        np.uint16 if dtype == torch.uint16 else np.uint8)
    wb[perm] = bins.cpu().numpy()
    return out, torch.from_numpy(wb).cuda()


def _p2_holds(torch, gb):
    """P2 at the bench shape and the edges, on the DART model's trees, in
    every kind of configuration p2_config picks, each reached by its
    shape: 256 rows one a thread with the records staged (the bench rows),
    through L1 (136 uint8 features: the tile and the staged records
    overflow 48 KB together) or the bins from global memory (2,000
    features, one tree); fewer rows with tree slots, the bins tiled (a
    list over few rows; 136 uint16 features, cut to 128 rows) or from
    global memory (2,000 features, a quarter of the list)."""
    from lightgbm_tpu_torch.models.tree import binned_table, empty_tree

    trees = gb.models
    T = len(trees)
    table = binned_table(trees)
    tr, va = gb._bins_T, gb._valid_bins[0]
    holds = [("train_1M", tr, 1, _scaled(trees)),
             ("valid_200k", va, 1, _scaled(trees)),
             ("replay_valid_7", va, 1, [(table, None, 7)]),
             (f"replay_valid_{T}", va, 1, [(table, None, T)])]
    u16 = torch.from_numpy(np.random.RandomState(3).randint(
        0, 300, va.shape).astype(np.uint16)).cuda()
    holds.append(("u16_x300", u16, 1, _scaled(trees)))
    stump = empty_tree(NUM_LEAVES, "cuda")
    stump = stump.replace(leaf_value=stump.leaf_value + 0.37)
    cat = []
    for t in trees[:6]:
        odd = torch.arange(t.decision_type.shape[0], device="cuda") % 2 == 1
        cat.append(t.replace(decision_type=odd.to(torch.int32)))
    edge = [stump] + cat + [stump]
    holds += [("stumps_categorical", va, 1, _scaled(edge)),
              ("K5_update", va, 5, _scaled(trees)
               + [(binned_table(trees[-1:]), 4, 1.0)]),
              ("K5_replay_chunk4", va, 5, [(table, None, 4)])]
    # few rows: tree slots, and n = 1, 255, 257 (partial tiles, no 16-byte
    # tile loads)
    for n in (1, 255, 257, 3000):
        sub = va[:, :n].contiguous()
        holds += [(f"rows_{n}", sub, 1, [(table, 0, P2_SCALES[2])]),
                  (f"rows_{n}_replay", sub, 1, [(table, None, 7)]),
                  (f"rows_{n}_K5", sub, 5, [(table, 2, P2_SCALES[3])])]
    # wider rows: the trees' 28 columns spread over P2_NARROW_F features
    # (uint8 and uint16, the valid rows) and P2_WIDE_F uint8 features
    for F, dtype, n in ((P2_NARROW_F, torch.uint8, va.shape[1]),
                        (P2_NARROW_F, torch.uint16, va.shape[1]),
                        (P2_WIDE_F, torch.uint8, 20_000)):
        spread, wb = _spread(torch, trees, va[:, :n], F, dtype, 182)
        name = f"F{F}_{str(dtype)[6:]}"
        holds += [(name, wb, 1, _scaled(spread)
                   + [(binned_table(spread[-1:]), 0, 1.0)]),
                  (f"{name}_replay", wb, 1,
                   [(binned_table(spread), None, 7)])]
    err, seen = 0.0, set()
    for name, bins, K, calls in holds:
        e, configs = _p2_hold(torch, name, bins, K, calls)
        err, seen = max(err, e), seen | configs
    kinds = {("staged" if c[3] else "tiled" if c[1] else "global",
              c[0] == 256) for c in seen}
    say(f"[dart p2 hold] configurations held: {sorted(seen)}")
    check(kinds == {("staged", True), ("tiled", True), ("global", True),
                    ("tiled", False), ("global", False)},
          f"dart: the P2 holds missed a kind of configuration: {kinds}")
    return err


def _p2_profile(torch, fn, calls=3, traces=10):
    """``calls`` calls of ``fn`` in one torch.profiler trace, each between
    two spin kernels (``torch.cuda._sleep``): (HtoD memcpy events, P2
    kernel events, the other device events) a call, from the first of
    ``traces`` traces that holds all its spin kernels (None if none
    does), and how many of the traces did.  A torch.profiler trace can
    come back short of device events; the spins before and after each
    call tell a complete trace from a short one."""
    from torch.profiler import ProfilerActivity, profile

    got, complete = None, 0
    for _ in range(traces):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                torch.cuda._sleep(1000)
                fn()
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        dev = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        rest = [d for d in dev if "spin_kernel" not in d]
        if len(dev) - len(rest) != 2 * calls:
            continue
        complete += 1
        if got is None:
            got = (sum("HtoD" in d for d in rest) / calls,
                   sum("p2_rows_kernel" in d or "p2_slots_kernel" in d
                       for d in rest) / calls, len(rest) / calls)
    return got, complete


def _p2_trace_in_child(torch, table, bins):
    """One P2 update call of ``table`` over ``bins`` traced by
    ``_p2_profile`` in a fresh process (``chip_smoke.py --p2-trace``),
    whose profiler no earlier trace has used: (the trace, complete traces
    of 10)."""
    import dataclasses
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "call.pt")
        fields = {f.name: getattr(table, f.name)
                  for f in dataclasses.fields(table)}
        torch.save({"bins": bins.cpu(), "table": {
            k: v.cpu() if torch.is_tensor(v) else v
            for k, v in fields.items()}}, path)
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--p2-trace", path], capture_output=True,
                             text=True, timeout=300)
    check(out.returncode == 0,
          f"dart: the P2 trace's process failed: {out.stderr[-2000:]}")
    res = json.loads(out.stdout.strip().splitlines()[-1])
    return (tuple(res["trace"]) if res["trace"] else None), res["complete"]


def _p2_trace_child(torch, path) -> int:
    """``--p2-trace PATH``: the P2 call saved at PATH traced here; prints
    ``{"trace": ..., "complete": ...}``."""
    from lightgbm_tpu_torch.models.tree import BinnedTrees
    from lightgbm_tpu_torch.ops.cuda_predict_binned import binned_update_cuda_

    d = torch.load(path)
    table = BinnedTrees(**{k: v.cuda() if torch.is_tensor(v) else v
                           for k, v in d["table"].items()})
    bins = d["bins"].cuda()
    s = torch.zeros((1, bins.shape[1]), device="cuda")
    binned_update_cuda_(s, table, bins, 0, 1.0)
    torch.cuda.synchronize()
    got, complete = _p2_profile(
        torch, lambda: binned_update_cuda_(s, table, bins, 0, 1.0))
    print(json.dumps({"trace": got, "complete": complete}))
    return 0


@contextlib.contextmanager
def _uploads_raise(torch):
    """Inside, every way the port sends host data to the card raises:
    pinned memory, ``models/tree.upload``, ``Tensor.to`` / ``.cuda`` /
    ``.copy_`` and new tensors from host data."""
    from lightgbm_tpu_torch.models import tree

    def refuse(name):
        def run(*a, **kw):
            raise AssertionError(f"{name} called inside a P2 call")
        return run

    swaps = [(torch.Tensor, "pin_memory"), (torch.Tensor, "to"),
             (torch.Tensor, "cuda"), (torch.Tensor, "copy_"),
             (torch, "tensor"), (torch, "as_tensor"), (torch, "from_numpy"),
             (tree, "upload")]
    own = [vars(obj).get(attr) for obj, attr in swaps]  # None: inherited
    for obj, attr in swaps:
        setattr(obj, attr, refuse(attr))
    try:
        yield
    finally:
        for (obj, attr), fn in zip(swaps, own):
            if fn is None:
                delattr(obj, attr)
            else:
                setattr(obj, attr, fn)


def _p2_times(torch, gb):
    """P2's ms a call (CUDA events, median of 20 after 3) and device ms
    (calls queued behind a spin) beside the plain version's, the per-tree
    reference walk's (``predict_binned`` over an int32 copy of the rows,
    the port's walk before P2) and P2's before its redesign at its
    shapes; the table
    build of a new tree (ms a call and device events); one call's trace
    (no host-to-device copy)."""
    from lightgbm_tpu_torch.models.tree import (binned_table, binned_update_,
                                                predict_binned)
    from lightgbm_tpu_torch.ops.cuda_predict_binned import (
        binned_replay_cuda_, binned_update_cuda_)

    trees = gb.models
    one, drop3 = binned_table(trees[-1:]), binned_table(trees[:3])
    every = binned_table(trees)
    out = {}
    for name, bins in (("train_1M", gb._bins_T),
                       ("valid_200k", gb._valid_bins[0])):
        K, n = 1, bins.shape[1]
        s = torch.zeros((K, n), device="cuda")
        call = time_ms(torch, lambda: binned_update_cuda_(s, one, bins, 0,
                                                          1.0))
        dev = queued_ms(torch, lambda: binned_update_cuda_(s, one, bins, 0,
                                                           1.0))
        plain = time_ms(torch, lambda: binned_update_(s, one, bins, 0, 1.0),
                        reps=5, warm=1)
        rows = bins.T.to(torch.int32)
        ref = time_ms(torch, lambda: s[0].add_(predict_binned(trees[-1],
                                                              rows)),
                      reps=5, warm=1)
        del rows
        drop = time_ms(torch, lambda: binned_update_cuda_(
            s, drop3, bins, 0, -1.0))
        replay = time_ms(torch, lambda: binned_replay_cuda_(
            s, every, bins, 1, gb._iter_chunk(n)))
        bound = (bins.numel() * bins.element_size() + 2 * 4 * K * n) \
            / HBM_BYTES_PER_S * 1e3
        out[name] = dict(ms=call, device_ms=dev, plain_ms=plain,
                         walk_ms=ref, drop3_ms=drop, replay_ms=replay,
                         bound_ms=bound)
        was = P2_BEFORE_MS[name]
        say(f"[dart p2 time] {name}: one tree P2 {call:.4f} ms a call, "
            f"{dev:.4f} ms device (before: {was[0]:.4f}, {was[1]:.4f}); byte "
            f"bound {bound:.5f} ms: {100 * bound / call:.1f} % a call, "
            f"{100 * bound / dev:.1f} % device; plain version {plain:.3f} "
            f"ms; the per-tree reference walk (predict_binned, int32 rows) "
            f"{ref:.3f} ms; 3 trees {drop:.4f} ms (before: {was[2] or '-'}); "
            f"replay of {len(trees)} trees {replay:.4f} ms (before: "
            f"{was[3] or '-'}) [{CARD['name']}]")
    table_ms = time_ms(torch, lambda: binned_table(trees[-1:]))
    table_trace, t_complete = _p2_profile(
        torch, lambda: binned_table(trees[-1:]))
    tr, va = gb._bins_T, gb._valid_bins[0]
    s = torch.zeros((1, tr.shape[1]), device="cuda")
    sv = torch.zeros((1, va.shape[1]), device="cuda")
    trace, complete = _p2_profile(
        torch, lambda: binned_update_cuda_(s, one, tr, 0, 1.0))
    where = ""
    if trace is None:  # the profiler gives short traces in this process
        trace, child = _p2_trace_in_child(torch, one, tr)
        where = f"; in a fresh process {child} of 10"
    t_htod, _, t_events = table_trace or (None,) * 3
    htod, p2, events = trace or (None,) * 3
    say(f"[dart p2 time] table build of a new tree (binned_table([tree])): "
        f"{table_ms:.4f} ms a call, {t_events} device events a call "
        f"({t_htod} host-to-device copy); a P2 call's trace (3 calls): "
        f"{events} device events, {p2} P2 kernel, {htod} host-to-device "
        f"copies a call; complete traces (every spin kernel there): "
        f"{t_complete} and {complete} of 10{where} [{CARD['name']}]")
    check(trace is not None and p2 == 1 and events == 1 and htod == 0,
          f"dart: a P2 call's trace is {trace}, not one P2 kernel and no "
          f"host-to-device copy")
    with _uploads_raise(torch):  # raises if a call sends anything up
        for _ in range(3):
            binned_update_cuda_(s, one, tr, 0, 1.0)
            binned_update_cuda_(s, drop3, tr, 0, -1.0)
            binned_replay_cuda_(sv, every, va, 1, gb._iter_chunk(va.shape[1]))
    torch.cuda.synchronize()
    say("[dart p2 time] P2 calls (update of 1 and 3 trees, replay) with "
        "every host upload made to raise: none raised")
    out["table_ms"], out["table_events"] = table_ms, t_events
    out["trace_complete"] = (t_complete, complete)
    return out


def _dart_run(torch, lt, params, train_set, valid_set, plain):
    """DART_ROUNDS rounds on the mega route with the valid set, P2 (or its
    plain version) for every binned walk, timed with every count set to
    0 just before; P2's calls under sync-debug "error"."""
    from lightgbm_tpu_torch import synthetic
    from lightgbm_tpu_torch.learners import serial
    from lightgbm_tpu_torch.ops import launch_counts

    with p2_route(torch, plain=plain, strict=not plain) as calls:
        bst = lt.Booster(dict(params), train_set)
        bst.add_valid(valid_set, "valid")
        gb = bst._gbdt
        drops, orig = [], gb._select_drops
        gb._select_drops = lambda: drops.append(orig()) or drops[-1]
        per_iter = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        before_calls = dict(calls)
        t0 = time.perf_counter()
        for _ in range(synthetic.DART_ROUNDS):
            before = launch_counts()["P2"]
            bst.update()
            per_iter.append(launch_counts()["P2"] - before)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        counts, syncs = launch_counts(), serial.HOST_SYNCS
        peak = torch.cuda.max_memory_allocated()
    return dict(bst=bst, drops=drops, per_iter=per_iter, s=elapsed,
                counts=counts, syncs=syncs, peak=peak,
                calls={k: calls[k] - before_calls[k] for k in calls})


def _continued(torch, lt, params, train_set, valid_set, path, plain):
    """From the DART model file: the init model's replay (merge_from),
    the valid replay, one DART iteration and a rollback, P2's calls
    under sync-debug "error" (or all on the plain version)."""
    from lightgbm_tpu_torch.ops import launch_counts

    reset_counts()
    with p2_route(torch, plain=plain, strict=not plain) as calls:
        cont = lt.Booster(dict(params, input_model=path), train_set)
        cont.add_valid(valid_set, "valid")
        cont.update()
        cont.rollback_one_iter()
        torch.cuda.synchronize()
    gb = cont._gbdt
    return (gb._scores.clone(), gb._valid_scores[0].clone(), dict(calls),
            launch_counts()["P2"], len(gb.models))


def _guard_holds(torch, lt, params, train_set):
    """The three guards under ``nan_grads:1`` at GUARD_ROWS rows."""
    from lightgbm_tpu_torch.obs import telemetry
    from lightgbm_tpu_torch.resilience import faults
    from lightgbm_tpu_torch.resilience.guards import NonFiniteError

    sub = train_set.subset(np.arange(GUARD_ROWS))
    tel = telemetry.get_telemetry()
    out = {}
    for policy in ("raise", "skip_tree", "clip"):
        p = dict(params, num_leaves=GUARD_LEAVES, nonfinite_policy=policy)
        b = lt.Booster(p, sub)
        gb = b._gbdt
        counter = {"raise": "nonfinite_grad_events",
                   "skip_tree": "nonfinite_skipped_trees",
                   "clip": "nonfinite_values_clipped"}[policy]
        c0 = tel.counter(counter)
        b.update()
        before = gb._scores.clone()
        faults.set_fault("nan_grads:1")
        try:
            raised = False
            try:
                b.update()
            except NonFiniteError:
                raised = True
            restored = torch.equal(gb._scores, before)
            b.update()
            gb.finalize_guards()
        finally:
            faults.clear_faults()
        finite = bool(torch.isfinite(gb._scores).all()) and all(
            bool(torch.isfinite(t.leaf_value).all()) for t in gb.models)
        moved = tel.counter(counter) - c0
        want_trees = {"raise": 2, "skip_tree": 2, "clip": 3}[policy]
        ok = (finite and gb.num_trees == want_trees and moved > 0
              and raised == (policy == "raise")
              and (restored or policy != "raise"))
        out[policy] = ok
        say(f"[dart guards] {policy} under nan_grads:1 at {GUARD_ROWS} rows: "
            f"raised {raised}, scores restored bitwise {restored}, "
            f"{gb.num_trees} trees, finite {finite}, {counter} +{moved}: "
            f"{ok}")
        check(ok, f"dart: the {policy} guard")
    return out


def phase_dart(torch, lt, params, train_set, valid_set, Xv,
               mega_s_per_tree):
    """DART and P2 on the bench data, mega route (see item 21)."""
    import tempfile

    dparams = dict(params, boosting_type="dart", tree_growth="leafwise",
                   histogram_pool_size=0.0, metric="auc")
    with route_env("mega"):
        run = _dart_run(torch, lt, dparams, train_set, valid_set, False)
        plain = _dart_run(torch, lt, dparams, train_set, valid_set, True)
        bst, gb = run["bst"], run["bst"]._gbdt
        trees = gb.models
        n, splits = len(trees), sum(t.num_leaves - 1 for t in trees)
        want = [1 + 3 * bool(d) for d in run["drops"]]
        growth = dict(run["counts"], P2=0)
        same = (_same_trees_bitwise(torch, trees, plain["bst"]._gbdt.models)
                and run["drops"] == plain["drops"]
                and torch.equal(gb._scores, plain["bst"]._gbdt._scores)
                and torch.equal(gb._valid_scores[0],
                                plain["bst"]._gbdt._valid_scores[0]))
        plain_calls = plain["calls"]
        del plain
        train_auc = bst.eval_train()[0][2]
        valid_auc = bst.eval_valid()[0][2]
        pv = bst.predict(Xv, raw_score=True)
        say(f"[dart] {n} trees {run['s']:.3f}s s/tree={run['s'] / n:.4f} "
            f"(phase 8 mega s/tree={mega_s_per_tree:.4f}); drops a round "
            f"{[len(d) for d in run['drops']]}; P2 launches a round "
            f"{run['per_iter']} (1 + (2 + 1 valid set) with drops); "
            f"learner host_syncs_per_tree={run['syncs'] / n:.1f} "
            f"(2 + splits: {2 + splits / n:.1f}); peak_mem_bytes="
            f"{run['peak']}; train_auc={train_auc:.6f} valid_auc="
            f"{valid_auc:.6f} (JAX DART {DART_AUC[0]}/{DART_AUC[1]}); "
            f"trees, drops and scores bitwise the plain walk's: {same}")
        check(same, "dart: P2 and its plain version train other models")
        check(run["per_iter"] == want and sum(want) == run["counts"]["P2"]
              and any(run["drops"]),
              f"dart: P2 launches {run['per_iter']}, expected {want}")
        # a table a new tree (its valid walk) and one a round with drops
        # (models/dart.py's own binding), each built under sync-debug
        # "error"; an update call a P2 launch
        want_calls = {"table": n + sum(map(bool, run["drops"])),
                      "update": sum(want), "replay": 0}
        say(f"[dart] binned walk calls in {len(run['per_iter'])} rounds: "
            f"{json.dumps(run['calls'])} on P2, {json.dumps(plain_calls)} "
            f"on the plain version (expected {json.dumps(want_calls)})")
        check(run["calls"] == want_calls and plain_calls == want_calls,
              f"dart: binned walk calls {run['calls']} / {plain_calls}, "
              f"expected {want_calls}")
        check(_mega_counts_ok(growth, trees),
              f"dart: launches {run['counts']} are not the mega route's")
        check(run["syncs"] == 2 * n + splits,
              f"dart: {run['syncs']} learner host syncs, expected "
              f"{2 * n + splits}")
        check(abs(train_auc - DART_AUC[0]) <= AUC_TOL
              and abs(valid_auc - DART_AUC[1]) <= AUC_TOL,
              f"dart: AUC {train_auc}/{valid_auc} outside {DART_AUC}"
              f"+-{AUC_TOL}")
        check(abs(_auc(valid_set.label, pv) - valid_auc) <= 1e-6,
              "dart: predict's valid AUC is not the one training reported")
        err = _p2_holds(torch, gb)
        times = _p2_times(torch, gb)
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "dart.txt")
            bst.save_model(path)
            k = _continued(torch, lt, dparams, train_set, valid_set, path,
                           False)
            p = _continued(torch, lt, dparams, train_set, valid_set, path,
                           True)
        cont_ok = (torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])
                   and k[4] == n and k[3] == 5 and p[3] == 0
                   and k[2]["replay"] == 1 and k[2]["update"] == 4)
        say(f"[dart continued] init-model replay, valid replay, one "
            f"iteration and a rollback with P2's calls under "
            f"sync_debug_mode=error: calls {json.dumps(k[2])}, P2 launches "
            f"{k[3]} (1 + 1 + 1 + 2); scores bitwise the plain version's: "
            f"{cont_ok}; train "
            f"scores within {float((k[0] - gb._scores).abs().max()):.3g} "
            f"of the trained model's")
        check(cont_ok, "dart: continued training on P2")
        guards = _guard_holds(torch, lt, dict(dparams, boosting_type="gbdt"),
                              train_set)
    t = times["train_1M"]
    return dict(launches=run["counts"]["P2"], max_abs_err=err, ms=t["ms"],
                plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
                library_ms=None, s_per_tree=run["s"] / n, guards=guards)


# ----------------------------------------------------------------- phase 22
# the JAX package's float64 leaf-wise train/valid AUC on the same data and
# config (synthetic.workload(hist_dtype="float64")), on the CPU:
#   JAX_PLATFORMS=cpu python tools/jax_growth_auc.py --growth leafwise \
#       --hist-dtype float64   (44 s on the CPU)
# Its float64 depthwise grower raises (ROADMAP C9): the port's float64
# depthwise AUC is held to AUC_REF["depthwise"], the float32 reference at
# as many trees.
ENVELOPE_ROWS = (1 << 24) + (1 << 20)  # past the float32 count envelope
ENVELOPE_TREES = {"leafwise": 2, "depthwise": 2}
ENVELOPE_BLOCK = 1 << 20  # rows drawn at a time
F64_FLOPS = 34e12  # H100 SXM, float64 outside the tensor cores
# the float64 histograms' sorted design, before the walk, as an earlier
# run of phase 22 measured it (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md
# section 6), printed for reference and compared with nothing measured
# here: device ms at the 1M-row root and at 1M rows in 255 leaf slots, the
# 17,825,792-row root's ms a call, and its partials' bytes there (one a
# chunk)
SORTED_F64 = {"K1-f64": 0.4720, "K1″-f64": 0.6673, "envelope_ms": 8.3498,
            "envelope_partials": 1_491_517_440}


@contextlib.contextmanager
def plain_versions_raise():
    """The plain versions of K1-f64, K1''-f64 and K3-f64 (both forms)
    replaced by a function that raises, inside: a float64 route on the
    card must reach only the kernels (the depthwise level search is plain
    PyTorch ops on every device, H3, and stays)."""
    from lightgbm_tpu_torch.ops import cuda_histogram, histogram, split

    def raises(*args, **kwargs):
        raise AssertionError("a plain version ran on the card's float64 "
                             "route")

    slots = [(cuda_histogram, "histogram_feature_major"),
             (histogram, "histogram_feature_major"),
             (histogram, "histogram_by_leaf_sorted_plain"),
             (split, "search2_rows"), (split, "search2_update"),
             (split, "search2_pool")]
    saved = [getattr(mod, name) for mod, name in slots]
    for mod, name in slots:
        setattr(mod, name, raises)
    try:
        yield
    finally:
        for (mod, name), fn in zip(slots, saved):
            setattr(mod, name, fn)


def _stats64(torch, rng, n):
    """float32 g, h and a 0/1 mask (80 % ones) on the card."""
    return (torch.from_numpy(rng.randn(n).astype(np.float32)).cuda(),
            torch.from_numpy(np.abs(rng.randn(n)).astype(np.float32)).cuda(),
            torch.from_numpy((rng.rand(n) < 0.8).astype(np.float32)).cuda())


def _f64_histogram_holds(torch, bins, nb):
    """K1-f64 bitwise its plain version on the CPU, two launches equal, at
    the 1M-row root of the bench bins and the edge cases, on both of its
    pass-1 branches: the bin sort below the library's walk_min_chunks
    (64) chunks (rows-2049/16384/18433, u16x5000 with its bin-range
    passes, F5, F29), the walk from there (root, rows-130001, dominant,
    u16x5000-walk, F29-walk); its times at the root beside K1's, the plain
    version's and float64 ``index_add_``'s."""
    from lightgbm_tpu_torch.ops import cuda_histogram as ch
    from lightgbm_tpu_torch.ops.histogram import histogram_feature_major

    f64 = torch.float64
    rng = np.random.RandomState(22)
    F, n = bins.shape

    def rand_bins(Fr, m, B, dt):
        return torch.from_numpy(rng.randint(0, B, (Fr, m)).astype(dt)).cuda()

    dominant = bins[:, :300_000].clone()  # ~90 % of each feature in a bin
    dominant[torch.from_numpy(rng.rand(F, 300_000) < 0.9).cuda()] = nb // 3
    cases = [("root", bins, nb), ("rows-0", bins[:, :0], nb),
             ("rows-1", bins[:, :1].contiguous(), nb),
             ("rows-2049", bins[:, :2049].contiguous(), nb),
             ("rows-16384", bins[:, :16_384].contiguous(), nb),
             ("rows-18433", bins[:, :18_433].contiguous(), nb),
             ("rows-130001", bins[:, :130_001].contiguous(), nb),
             ("dominant", dominant, nb),
             ("u16x5000", rand_bins(4, 100_000, 5000, np.uint16), 5000),
             ("u16x5000-walk", rand_bins(4, 140_000, 5000, np.uint16),
              5000),
             ("F5", rand_bins(5, 70_001, 37, np.uint8), 37),
             ("F29", rand_bins(29, 70_001, NUM_BINS, np.uint8), NUM_BINS),
             ("F29-walk", rand_bins(29, 140_001, NUM_BINS, np.uint8),
              NUM_BINS)]
    for name, b, B in cases:
        g, h, m = _stats64(torch, rng, b.shape[1])
        k = ch.histogram_single_leaf_f64_cuda(b, g, h, m, B)
        k2 = ch.histogram_single_leaf_f64_cuda(b, g, h, m, B)
        torch.cuda.synchronize()
        check(k.dtype == f64 and torch.equal(k, k2),
              f"K1-f64 {name}: launches not bitwise equal")
        cpu = histogram_feature_major(b.cpu(), g.cpu(), h.cpu(), m.cpu(), B,
                                      f64)
        check(torch.equal(k.cpu(), cpu),
              f"K1-f64 {name}: differs from its plain version on the CPU")
        check(torch.equal(k[..., 2].sum(1).cpu(),
                          torch.full((b.shape[0],), float(m.sum().item()),
                                     dtype=f64)),
              f"K1-f64 {name}: a feature's counts do not sum to the rows")
        walk = ch.f64_group_chunks(b.shape[1]) > 1
        say(f"[f64 K1] {name} F={b.shape[0]} rows={b.shape[1]} B={B} "
            f"pass 1={'walk' if walk else 'bin sort'} bitwise: launches, "
            "== plain (CPU); counts sum to the rows")
        if name == "dominant":
            p1, _ = _passes_ms(torch, lambda: ch.histogram_single_leaf_f64_cuda(
                b, g, h, m, B), "walk_partial")
            say(f"[f64 K1 times] dominant (~90 % of each feature in one "
                f"bin) rows={b.shape[1]}: pass1_ms={p1:.4f}")
        if name != "root":
            continue

        def kernel():
            return ch.histogram_single_leaf_f64_cuda(b, g, h, m, B)

        keys = (b.to(torch.int64) + torch.arange(F, device="cuda")[:, None]
                * B).reshape(-1)
        md = m.double()
        src = torch.stack([g.double() * md, h.double() * md, md],
                          -1).repeat(F, 1)
        ms = time_ms(torch, kernel)
        dev_ms = queued_ms(torch, kernel, calls=20, reps=3)
        plain_ms = time_ms(torch, lambda: histogram_feature_major(
            b, g, h, m, B, f64), reps=5, warm=1)
        f32_ms = time_ms(torch, lambda: ch.histogram_single_leaf_cuda(
            b, g, h, m, B))
        lib_ms = time_ms(torch, lambda: torch.zeros(
            F * B, 3, dtype=f64, device="cuda").index_add_(0, keys, src))
        nbytes = F * n * b.element_size() + 12 * n + F * B * 24
        bound = max(nbytes / HBM_BYTES_PER_S, 3 * F * n / F64_FLOPS) * 1e3
        p1, p2 = _passes_ms(torch, kernel, "walk_partial")
        partials = 8 * math.prod(ch.scratch_shape(F, n, B,
                                                  ch.f64_group_chunks(n)))
        say(f"[f64 K1 times] root F={F} rows={n}: ms={ms:.4f} "
            f"device_ms={dev_ms:.4f} (pass1_ms={p1:.4f} pass2_ms={p2:.4f}; "
            f"PR 19's run, PERF.md: {SORTED_F64['K1-f64']:.4f}) "
            f"bound_ms={bound:.5f} ({nbytes} bytes) share={bound / ms:.4f} "
            f"device share={bound / dev_ms:.4f} plain_ms={plain_ms:.4f} "
            f"K1 (float32) ms={f32_ms:.4f} library_ms={lib_ms:.4f} "
            f"(float64 index_add_, not deterministic) "
            f"group partials={partials} bytes")
        record = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                      bound_ms=bound, library_ms=lib_ms)
        del keys, src
    return record


# rows a leaf of phase 22's chunked level: 8, 9 and 17 chunks, one chunk,
# one row and empty leaves
CHUNKED_LEAVES = (8 * 2048, 0, 9 * 2048, 17 * 2048, 0, 2048, 1, 0)


def _f64_level_holds(torch, bins, nb, nbpf):
    """K1''-f64 bitwise its plain version on the CPU, two launches equal,
    its chunk and group tables level_layout's: the 1M bench rows in 255
    leaf slots on a real level's leaf ids (most of them empty), leaves
    two thirds empty, leaves of 8, 9 and 17 chunks (and of one chunk, one
    row, none) and u16 x 5000 bins; its times on the real level beside
    K1'''s, the plain version's and float64 ``index_add_``'s on leaf-bin
    keys."""
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.learners.depthwise import grow_tree_depthwise
    from lightgbm_tpu_torch.learners.serial import TreeLearnerParams
    from lightgbm_tpu_torch.ops import cuda_histogram as ch
    from lightgbm_tpu_torch.ops.histogram import (
        histogram_by_leaf_sorted_plain, level_layout)

    f64 = torch.float64
    rng = np.random.RandomState(23)
    F, n = bins.shape
    g, h, m = _stats64(torch, rng, n)
    prm = TreeLearnerParams.from_config(Config(min_data_in_leaf=MIN_DATA,
                                               max_depth=6))
    _, lid6 = grow_tree_depthwise(
        bins, g, h, torch.ones_like(g),
        torch.ones(F, dtype=torch.bool, device="cuda"), nbpf,
        torch.zeros(F, dtype=torch.bool, device="cuda"), prm, nb,
        NUM_LEAVES)
    sparse = torch.from_numpy(3 * rng.randint(0, 14, n).astype(
        np.int32)).cuda()
    many = torch.from_numpy(rng.randint(0, 5000, (4, 100_000)).astype(
        np.uint16)).cuda()
    chunked = torch.from_numpy(rng.permutation(np.repeat(
        np.arange(len(CHUNKED_LEAVES)), CHUNKED_LEAVES)).astype(
            np.int32)).cuda()
    cases = [("level-6", bins, lid6, nb, NUM_LEAVES),
             ("empty-leaves", bins, sparse, nb, 40),
             ("8-9-17-chunks", bins[:, :chunked.shape[0]].contiguous(),
              chunked, nb, len(CHUNKED_LEAVES)),
             ("u16x5000", many, torch.from_numpy(rng.randint(
                 0, 64, 100_000).astype(np.int32)).cuda(), 5000, 64)]
    for name, b, lid, B, L in cases:
        if b.shape[1] != n:
            g, h, m = _stats64(torch, rng, b.shape[1])
        a = ch.histogram_by_leaf_sorted_f64_cuda(b, lid, g, h, m, B, L)
        a2 = ch.histogram_by_leaf_sorted_f64_cuda(b, lid, g, h, m, B, L)
        torch.cuda.synchronize()
        check(a.dtype == f64 and torch.equal(a, a2),
              f"K1''-f64 {name}: launches not bitwise equal")
        cpu = histogram_by_leaf_sorted_plain(b.cpu(), lid.cpu(), g.cpu(),
                                             h.cpu(), m.cpu(), B, L, f64)
        check(torch.equal(a.cpu(), cpu),
              f"K1''-f64 {name}: differs from its plain version on the CPU")
        _, table = ch._level_launch("lgbm_level_hist_f64", "float64", b, lid,
                                    g, h, m, B, L, dtype=f64, tables=True)
        check(all(torch.equal(t, x) for t, x in zip(
            table, level_layout(lid, L)[2:])),
              f"K1''-f64 {name}: its chunk and group tables differ from "
              "level_layout's")
        live = int((a[:, 0, :, 2].sum(1) > 0).sum())
        groups = [int(v) for v in table[5].diff().tolist()]
        say(f"[f64 K1''] {name} F={b.shape[0]} rows={b.shape[1]} B={B} "
            f"L={L} non-empty leaves={live} groups a leaf (max)="
            f"{max(groups)} bitwise: launches, == plain (CPU); tables == "
            "level_layout's")
        if name != "level-6":
            continue

        def kernel():
            return ch.histogram_by_leaf_sorted_f64_cuda(b, lid, g, h, m, B,
                                                        L)

        keys = ((lid.to(torch.int64)[None, :] * F
                 + torch.arange(F, device="cuda")[:, None]) * B
                + b.to(torch.int64)).reshape(-1)
        md = m.double()
        src = torch.stack([g.double() * md, h.double() * md, md],
                          -1).repeat(F, 1)
        ms = time_ms(torch, kernel)
        dev_ms = queued_ms(torch, kernel, calls=20, reps=3)
        plain_ms = time_ms(torch, lambda: histogram_by_leaf_sorted_plain(
            b, lid, g, h, m, B, L, f64), reps=5, warm=1)
        f32_ms = time_ms(torch, lambda: ch.histogram_by_leaf_sorted_cuda(
            b, lid, g, h, m, B, L, "v1"))
        lib_ms = time_ms(torch, lambda: torch.zeros(
            L * F * B, 3, dtype=f64, device="cuda").index_add_(0, keys, src))
        nbytes = F * n * b.element_size() + 16 * n + L * F * B * 24
        bound = max(nbytes / HBM_BYTES_PER_S, 3 * F * n / F64_FLOPS) * 1e3
        say(f"[f64 K1'' times] level-6 ({L} leaf slots, {live} non-empty): "
            f"ms={ms:.4f} device_ms={dev_ms:.4f} (PR 19's run, PERF.md: "
            f"{SORTED_F64['K1″-f64']:.4f}) bound_ms={bound:.5f} "
            f"({nbytes} bytes) share={bound / ms:.4f} device "
            f"share={bound / dev_ms:.4f} plain_ms={plain_ms:.4f} K1'' "
            f"(float32) ms={f32_ms:.4f} library_ms={lib_ms:.4f} (float64 "
            "index_add_, not deterministic)")
        record = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                      bound_ms=bound, library_ms=lib_ms)
        del keys, src
    del lid6, sparse, many, chunked
    return record


def _k3f64_branches(cuda_search, F, B):
    """The configurations phase 22 holds kernel 3-f64 in at (F, B):
    search64_config's choice (None) and the other side of its size switch
    (the ticketed grid where it picks a cluster; where it picks the grid,
    the widest cluster, if B allows one)."""
    if cuda_search.search64_config(F, B)[0] > 0:
        return [None, (0, 0)]
    if B <= cuda_search.CLUSTER_BINS:
        return [None, (cuda_search.MAX_CLUSTER, cuda_search.CLUSTER_WARPS)]
    return [None]


@contextlib.contextmanager
def _forced_k3f64(cuda_search, config):
    saved = cuda_search._forced_config
    cuda_search._forced_config = config
    try:
        yield
    finally:
        cuda_search._forced_config = saved


def _f64_search_holds(torch):
    """Kernel 3-f64 on phase 3's cases in float64 (100 random cases and
    the crafted tie at the bench shape, B = 7 / 300 / 600 / 5000, F = 136
    / 5000), on each side of its size switch: the root form's [2, 16]
    rows, and the step form's rows and written buffer (small left and
    right in turn; a resident parent, every fourth case a recomputed one
    through search2_pool), torch.equal to the plain versions' on the CPU;
    two launches equal.  Times both forms at the bench shape (ms a call,
    queued device ms, each branch) beside the plain versions, K3 and the
    composition the float64 learner ran before the step form (a PyTorch
    subtraction, the root form, two row copies)."""
    from lightgbm_tpu_torch.ops import cuda_search, split

    rng = np.random.RandomState(1)
    n = 0
    branch_ms = {}
    for F, B, count in _search_shapes():
        branches = _k3f64_branches(cuda_search, F, B)
        for i, (hs, fmask, nbpf, iscat, consts) in enumerate(
                _search_cases(rng, F, B, count)):
            case64 = ([x.astype(np.float64) for x in hs], fmask, nbpf,
                      iscat, consts)
            hl, hr, meta, scal = _case_tensors(torch, case64)
            mc, hlc, hrc = meta.cpu(), hl.cpu(), hr.cpu()
            want = split.search2_rows(hlc, hrc, scal, mc)
            sil = i % 2 == 0
            small, smc = (hl, hlc) if sil else (hr, hrc)
            recomputed = i % 4 == 1
            buf = torch.zeros((3, F, B, 3), dtype=torch.float64,
                              device="cuda")
            parent = hl + hr
            if not recomputed:
                buf[1] = parent
            bp = buf.cpu()
            wstep = (split.search2_pool(bp, smc, parent.cpu(), 2, 0, sil,
                                        scal, mc) if recomputed else
                     split.search2_update(bp, smc, 1, 2, sil, scal, mc))
            for config in branches:
                what = f"K3-f64 F={F} B={B} config={config or 'shipped'}"
                with _forced_k3f64(cuda_search, config):
                    k = [cuda_search._search2_rows_cuda(hl, hr, scal, meta)
                         for _ in range(2)]
                    bk = buf.clone()
                    rk = (cuda_search.search2_pool(bk, small, parent, 2, 0,
                                                   sil, scal, meta)
                          if recomputed else cuda_search.search2_update(
                              bk, small, 1, 2, sil, scal, meta))
                check(k[0].dtype == torch.float64 and torch.equal(k[0], k[1])
                      and torch.equal(k[0].cpu(), want),
                      f"{what}: root rows differ from the plain version's:"
                      f"\n{k[0].tolist()}\n{want.tolist()}")
                check(torch.equal(rk.cpu(), wstep) and torch.equal(bk.cpu(),
                                                                   bp),
                      f"{what}: step rows or buffer differ from the plain "
                      f"version's:\n{rk.tolist()}\n{wstep.tolist()}")
            n += 1
        _check_tie(k[0].cpu(), B, f"K3-f64 F={F} B={B}")  # every branch ==
        if (F, B) == (N_FEAT, NUM_BINS):
            buf[1] = parent
            step = cuda_search.F64Step(buf, meta)

            def root(hl=hl, hr=hr, scal=scal, meta=meta):
                return cuda_search._search2_rows_cuda(hl, hr, scal, meta)

            def step_call(step=step, small=small, scal=scal):
                return step.update(small, 1, 2, True, scal)

            def composition(buf=buf, small=small, scal=scal, meta=meta):
                large = buf[1] - small
                rows = cuda_search._search2_rows_cuda(small, large, scal,
                                                      meta)
                buf[1] = small
                buf[2] = large
                return rows

            for config in branches:
                with _forced_k3f64(cuda_search, config):
                    name = "cluster" if cuda_search.search64_config(
                        F, B)[0] else "grid"
                    fresh = cuda_search.F64Step(buf, meta)
                    branch_ms[name] = (
                        queued_ms(torch, root),
                        queued_ms(torch, lambda: fresh.update(
                            small, 1, 2, True, scal)))
            t = dict(root_ms=time_ms(torch, root),
                     root_dev=queued_ms(torch, root),
                     ms=time_ms(torch, step_call),
                     dev=queued_ms(torch, step_call),
                     comp_ms=time_ms(torch, composition),
                     comp_dev=queued_ms(torch, composition),
                     plain_root=time_ms(torch, lambda: split.search2_rows(
                         hl, hr, scal, meta)),
                     plain_ms=time_ms(torch, lambda: split.search2_update(
                         buf, small, 1, 2, True, scal, meta)))
            hl32, hr32 = hl.float(), hr.float()
            t["f32_ms"] = time_ms(torch, lambda: cuda_search._search2_rows_cuda(
                hl32, hr32, scal, meta))
            del step
    F, B = N_FEAT, NUM_BINS
    root_bytes = 2 * F * B * 24 + F * 16 + 2 * 16 * 8
    step_bytes = 4 * F * B * 24 + F * 16 + 2 * 16 * 8
    root_bound = root_bytes / HBM_BYTES_PER_S * 1e3
    bound = step_bytes / HBM_BYTES_PER_S * 1e3
    say(f"[f64 K3] cases={n} float64 root rows, step rows and buffers "
        f"torch.equal plain (CPU), each branch of the size switch "
        f"(F=28 x B=255, B={'/'.join(map(str, SCAN_BINS))}, "
        f"F={RANK_FEAT}/{WIDE_F}); at F=28 x B=255: root ms={t['root_ms']:.4f}"
        f" device_ms={t['root_dev']:.4f} bound_ms={root_bound:.6f} "
        f"({root_bytes} bytes) plain_ms={t['plain_root']:.4f}; step ms="
        f"{t['ms']:.4f} device_ms={t['dev']:.4f} bound_ms={bound:.6f} "
        f"({step_bytes} bytes) plain_ms={t['plain_ms']:.4f}; the composition "
        f"it replaced ms={t['comp_ms']:.4f} device_ms={t['comp_dev']:.4f}; "
        f"K3 (float32) ms={t['f32_ms']:.4f}; device ms (root, step) by "
        f"branch: {json.dumps(branch_ms)}")
    return dict(max_abs_err=0.0, ms=t["ms"], plain_ms=t["plain_ms"],
                bound_ms=bound, library_ms=None, device_ms=t["dev"],
                root_ms=t["root_ms"], root_device_ms=t["root_dev"],
                root_bound_ms=root_bound, root_plain_ms=t["plain_root"])


def _envelope_data(torch, n, seed=19):
    """Bench-shaped rows (bench_data's features and decision boundary)
    drawn on the card from ``torch.Generator(seed)``, ENVELOPE_BLOCK rows
    at a time; returns the float32 matrix on the card and the labels on
    the host."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    w1, w2 = (torch.randn(N_FEAT, device="cuda", generator=gen)
              for _ in range(2))
    X = torch.empty((n, N_FEAT), device="cuda")
    z = torch.empty(n, device="cuda")
    for r0 in range(0, n, ENVELOPE_BLOCK):
        Xb = X[r0:r0 + ENVELOPE_BLOCK]
        Xb.normal_(generator=gen)
        z[r0:r0 + len(Xb)] = (Xb @ w1 + 0.5 * (Xb ** 2 - 1.0) @ w2
                              + 0.8 * Xb[:, 0] * Xb[:, 1])
    z = (z - z.mean()) / z.std()
    noise = torch.randn(n, device="cuda", generator=gen)
    y = ((z + 0.5 * noise) > 0).float().cpu().numpy()
    return X, y


@contextlib.contextmanager
def _leaf_ids(torch, gb):
    """Inside, the row -> leaf map of every tree ``gb`` grows (the
    grower's own ``leaf_id``) goes into the list it yields."""
    grow, ids = gb.grow, []

    def kept(*args, **kwargs):
        tree, leaf_id = grow(*args, **kwargs)
        ids.append(leaf_id.clone())
        return tree, leaf_id

    gb.grow = kept
    try:
        yield ids
    finally:
        del gb.grow


def _leaf_counts_exact(torch, gb, ids, n, what):
    """Every leaf's count of every tree equals the rows its leaf ids put
    there, exactly, and its float32 rounding; the root's internal count is
    the row count."""
    for t, (tree, lid) in enumerate(zip(gb.models, ids)):
        lc = tree.leaf_count.cpu().numpy()
        count = torch.bincount(lid.to(torch.int64),
                               minlength=tree.num_leaves).cpu().numpy()
        check(len(count) == tree.num_leaves
              and np.array_equal(lc, count.astype(np.float32))
              and np.array_equal(lc.astype(np.int64), count),
              f"{what}: tree {t}'s leaf counts differ from its rows")
        check(tree.num_leaves == 1 or float(tree.internal_count[0]) == n,
              f"{what}: tree {t}'s root count {tree.internal_count[0]}")


def _raw_walks(torch, gb, ids, X):
    """P1's walks of the raw rows ``X`` (on the card) against training's
    row -> leaf maps ``ids``.  Training bins a value x by x <= its bin's
    float64 upper bound; the model keeps that bound rounded to float32
    (``threshold_real``), which lies above the bound where it rounded up,
    and a float32 value equal to it then goes left where training sent
    it right.  Returns (rows the model's walk puts in another leaf, the
    thresholds that rounded up, of how many, rows in another leaf when
    each numerical threshold is the largest float32 at or below its
    bound): no float32 value lies between the two rules in that last walk,
    so it must agree row for row."""
    from lightgbm_tpu_torch.models.tree import pack_trees
    from lightgbm_tpu_torch.ops.predict import ensemble_leaves

    bounds = gb.train_set.bin_thresholds_real()
    lowered, up, total = [], 0, 0
    for tree in gb.models:
        ni = tree.num_leaves - 1
        sf = tree.split_feature.cpu().numpy()
        tb = tree.threshold_bin.cpu().numpy()
        dt = tree.decision_type.cpu().numpy()
        thr = tree.threshold_real.cpu().numpy().copy()
        for i in range(ni):
            if dt[i] == 1:  # categorical: a category, not a bound
                continue
            ub = bounds[sf[i]][tb[i]]
            if not np.isfinite(ub):
                continue
            t32 = np.float32(ub)
            check(t32 == thr[i], f"threshold {thr[i]} is not the float32 "
                  f"rounding of its bin bound {ub!r}")
            if t32 > ub:
                t32 = np.nextafter(t32, np.float32(-np.inf))
                up += 1
            thr[i] = t32
            total += 1
        lowered.append(tree.replace(threshold_real=torch.from_numpy(thr).to(
            tree.threshold_real.device)))
    gaps = []
    for trees in (gb.models, lowered):
        leaves = ensemble_leaves(pack_trees(trees, 1, X.device), X,
                                 len(trees))
        gaps.append(sum(int((leaves[t] != lid).sum())
                        for t, lid in enumerate(ids)))
        del leaves
    return gaps[0], up, total, gaps[1]


def _envelope(torch, lt, params):
    """2**24 + 2**20 bench-shaped rows: float32 refused naming
    hist_dtype=float64; float64 trains 2 leaf-wise and 2 depthwise trees,
    only on the float64 kernels, with every count exact; K1-f64's root
    counts and sums against host float64 sums."""
    from lightgbm_tpu_torch.learners import depthwise, serial
    from lightgbm_tpu_torch.ops import cuda_histogram as ch
    from lightgbm_tpu_torch.ops import launch_counts

    free = subprocess.run(["free", "-g"], capture_output=True, text=True)
    say(f"[f64 envelope] host memory before the data (free -g):\n"
        f"{free.stdout.rstrip()}")
    t0 = time.perf_counter()
    X_dev, y = _envelope_data(torch, ENVELOPE_ROWS)
    X = X_dev.cpu().numpy()
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    train_set = lt.Dataset(X, label=y, max_bin=NUM_BINS, params=params)
    inner = train_set.construct()
    bin_s = time.perf_counter() - t0
    n = inner.num_data
    check(n == ENVELOPE_ROWS > 1 << 24, f"envelope rows {n}")
    try:
        lt.Booster(params=dict(params, hist_dtype="float32"),
                   train_set=train_set)
        refused = ""
    except ValueError as e:
        refused = str(e)
    check("hist_dtype=float64" in refused,
          f"envelope: float32 at {n} rows was not refused naming "
          f"hist_dtype=float64 ({refused!r})")
    say(f"[f64 envelope] {n} rows x {N_FEAT}: data {gen_s:.1f}s, binning "
        f"{bin_s:.1f}s; float32 refused: {refused}")
    out = {}
    for growth, trees in ENVELOPE_TREES.items():
        p64 = dict(params, hist_dtype="float64", tree_growth=growth)
        with route_env("mega"), plain_versions_raise():
            bst = lt.Booster(params=p64, train_set=train_set)
            gb = bst._gbdt
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            with _leaf_ids(torch, gb) as ids:
                reset_counts()
                t0 = time.perf_counter()
                for _ in range(trees):
                    bst.update()
                torch.cuda.synchronize()
                s_tree = (time.perf_counter() - t0) / trees
                counts = {k: v for k, v in launch_counts().items() if v}
                syncs, levels = serial.HOST_SYNCS, depthwise.LEVELS
                peak = torch.cuda.max_memory_allocated()
        splits = sum(t.num_leaves - 1 for t in gb.models)
        want = ({"K1″-f64": levels} if growth == "depthwise" else
                {"K1-f64": trees + splits, "K3-f64": trees,
                 "K3-f64 step": splits})
        check(counts == want, f"envelope {growth}: launches {counts} != "
              f"{want}")
        _leaf_counts_exact(torch, gb, ids, n, f"envelope {growth}")
        gap, up, nthr, gap_lowered = _raw_walks(torch, gb, ids, X_dev)
        del ids
        check(gap_lowered == 0 and (gap == 0 or up > 0),
              f"envelope {growth}: P1's walk of the raw rows puts {gap} "
              f"rows in another leaf than training ({gap_lowered} with the "
              "thresholds lowered to their float64 bounds)")
        say(f"[f64 envelope {growth}] {trees} trees s/tree={s_tree:.4f} "
            f"leaves={[t.num_leaves for t in gb.models]} "
            f"launches={json.dumps(counts)} host_syncs_per_tree="
            f"{syncs / trees:.1f} peak_mem_bytes={peak} (the raw rows, "
            f"{X_dev.nbytes} bytes, and the leaf ids stay on the card for "
            "the walk); every leaf count "
            f"== its rows (exact, == its float32 rounding); P1's walk of "
            f"the raw rows puts {gap} rows in another leaf than training: "
            f"{up} of {nthr} thresholds are float32 roundings above their "
            "float64 bin bound (ROADMAP C10), and with each lowered to the "
            "float32 at or below it the walk agrees row for row (held)")
        out[growth] = dict(s_per_tree=s_tree, peak=peak)
        if growth == "leafwise":
            # the root histogram of K1-f64 over every row, all rows in
            rng = np.random.RandomState(24)
            g = rng.randn(n).astype(np.float32)
            h = np.abs(rng.randn(n)).astype(np.float32)
            bins = gb._bins_T
            gd, hd = torch.from_numpy(g).cuda(), torch.from_numpy(h).cuda()
            ones = torch.ones(n, dtype=torch.float32, device="cuda")
            nb = gb._num_bins
            hist = ch.histogram_single_leaf_f64_cuda(bins, gd, hd, ones, nb)
            torch.cuda.synchronize()
            cnt = hist[..., 2].sum(1).cpu()
            check(torch.equal(cnt, torch.full_like(cnt, float(n))),
                  f"envelope: K1-f64's root counts {cnt.tolist()} != {n}")
            hb = hist.cpu().numpy()
            bins_h = bins.cpu().numpy()
            rel = 0.0
            for f in range(N_FEAT):
                for c, w in ((0, g), (1, h)):
                    ref = np.bincount(bins_h[f], weights=w.astype(np.float64),
                                      minlength=nb)
                    gap = np.abs(hb[f, :, c] - ref)
                    rel = max(rel, float((gap / np.maximum(np.abs(ref),
                                                           1e-300)).max()))
                    check(bool((gap <= 1e-12 * np.abs(ref)).all()),
                          f"envelope: K1-f64 feature {f} channel {c} beyond "
                          "rtol 1e-12 of np.bincount")
            root_ms = time_ms(torch, lambda: ch.histogram_single_leaf_f64_cuda(
                bins, gd, hd, ones, nb), reps=5, warm=1)
            # the scratch the wrapper allocates, against one a chunk
            partials = 8 * math.prod(ch.scratch_shape(
                N_FEAT, n, nb, ch.f64_group_chunks(n)))
            chunked = 8 * math.prod(ch.scratch_shape(N_FEAT, n, nb))
            check(8 * partials <= chunked,
                  f"envelope: K1-f64's {partials} bytes of scratch are more "
                  f"than 1/8 of a partial a chunk's {chunked}")
            say(f"[f64 envelope K1] root over {n} rows: every feature's "
                f"counts sum to {n}; g/h == np.bincount float64 within "
                f"rtol 1e-12 (largest {rel:.3g}); ms={root_ms:.4f} (PR 19's "
                f"run, PERF.md: {SORTED_F64['envelope_ms']:.4f}) scratch="
                f"{partials} bytes of group partials (<= 1/8 of a partial a "
                f"chunk's {chunked}; PR 19's run, PERF.md: "
                f"{SORTED_F64['envelope_partials']})")
            out["root_ms"] = root_ms
            del hist, gd, hd, ones, bins_h, hb
        del bst, gb
    del train_set, inner, X, X_dev
    return out


def phase_f64(torch, lt, params, train_set, valid_set, Xv, order):
    """Float64 histograms (hist_dtype=float64, see item 22): the three
    kernels' holds and times, the leaf-wise and depthwise main paths on
    the bench data with the plain versions made to raise, then the
    2**24 + 2**20-row envelope."""
    inner = train_set.construct()
    bins = inner.bins_T("cuda")
    nb = max(int(inner.max_num_bin), 2)
    nbpf = torch.as_tensor(inner.num_bins_per_feature).cuda()
    rec = {"K1-f64": _f64_histogram_holds(torch, bins, nb),
           "K1″-f64": _f64_level_holds(torch, bins, nb, nbpf),
           "K3-f64": _f64_search_holds(torch)}
    del bins
    with plain_versions_raise():
        lw = phase_main_path(torch, lt, "f64-leafwise", params, train_set,
                             valid_set, Xv)
        dw = phase_main_path(torch, lt, "f64-depthwise", params, train_set,
                             valid_set, Xv)
        pw = phase_main_path(torch, lt, "f64-pooled", params, train_set,
                             valid_set, Xv)
        hw = phase_main_path(torch, lt, "f64-hybrid", params, train_set,
                             valid_set, Xv)
    say(f"[f64 main] leaf-wise float64 s/tree={lw['s_per_tree']:.4f} auc="
        f"{lw['auc'][0]:.6f}/{lw['auc'][1]:.6f} (the JAX package's float64 "
        f"{AUC_REF['f64-leafwise'][0]:.6f}/{AUC_REF['f64-leafwise'][1]:.6f};"
        f" phase 8's float32 order route {order['auc'][0]:.6f}/"
        f"{order['auc'][1]:.6f}, s/tree={order['s_per_tree']:.4f}) "
        f"peak_mem_bytes={lw['peak']}; depthwise float64 "
        f"s/tree={dw['s_per_tree']:.4f} "
        f"auc={dw['auc'][0]:.6f}/{dw['auc'][1]:.6f} peak_mem_bytes="
        f"{dw['peak']}; pooled float64 s/tree={pw['s_per_tree']:.4f} auc="
        f"{pw['auc'][0]:.6f}/{pw['auc'][1]:.6f}; hybrid float64 s/tree="
        f"{hw['s_per_tree']:.4f} auc={hw['auc'][0]:.6f}/{hw['auc'][1]:.6f}")
    env = _envelope(torch, lt, params)
    for k, n in (("K1-f64", lw["counts"]["K1-f64"]),
                 ("K1″-f64", dw["counts"]["K1″-f64"])):
        rec[k]["launches"] = n
    rec["K3-f64"].update(launches=lw["counts"]["K3-f64"]
                         + lw["counts"]["K3-f64 step"],
                         root_launches=lw["counts"]["K3-f64"],
                         step_launches=lw["counts"]["K3-f64 step"])
    runs = {"f64-leafwise": lw, "f64-depthwise": dw, "f64-pooled": pw,
            "f64-hybrid": hw}
    return rec, env, runs


# ----------------------------------------------------------------- phase 18
PREDICT_TREES, SWAP_TREES = 100, 20  # the served model, its continuation
SERVE_SIZES = (1, 7, 64, 300, 1024)
SERVE_CLIENTS, SERVE_REQUESTS = 8, 250  # per client
HTTP_REQUESTS = 100
P1_BUCKETS = (1, 8, 128, 1024)  # P1 and dispatch ms timed at these rows
WIDE_F = 5000  # the wide configuration's hold: the bench trees' 28 columns
# P1's times before its redesign (NVIDIA H100 80GB HBM3, 700.00 W): CUDA-
# event ms a call at 1M rows and buckets 8, 128 and 1,024 from PR 13's own
# phase 18 (PERF.md section 6); at 1 row and in leaves mode at 1M rows,
# PR 13's kernel timed beside this one by tools/p1_variants.py
# --parent-csrc
PR13_P1_MS = {"sum": 5.0246, "leaves": 4.9837, 1: 0.3602, 8: 0.5990,
              128: 0.5652, 1024: 0.4849}


def _p1_cases(torch, lt, params, train_set, X_all):
    """The models and inputs P1 is held on against its plain version:
    (name, booster, X [n, F] f32 on the card, n_trees, chunk_iters)."""
    from lightgbm_tpu_torch.synthetic import multiclass_labels

    rng = np.random.RandomState(18)
    X = X_all[:1_000_000]
    small = dict(params, num_leaves=31)
    # a categorical column (category = floor(4 * x0) + 4, 0..8) with NaN
    Xc = X[:200_000].copy()
    Xc[:, 0] = np.clip(np.floor(Xc[:, 0] * 4) + 4, 0, 8)
    yc = train_set.label[:200_000]
    cat = lt.train(small, lt.Dataset(Xc, label=yc, params=small,
                                     categorical_feature=[0]), 10)
    Xc[rng.choice(len(Xc), 20_000, replace=False), 0] = np.nan
    # rows with NaN, +-inf and +-3e9 in five features
    Xs = X_all[:200_000].copy()
    for j, v in enumerate((np.nan, np.inf, -np.inf, 3e9, -3e9)):
        Xs[rng.choice(len(Xs), 20_000, replace=False), j * 5] = v
    y5, _ = multiclass_labels(X[:300_000], X[:0])
    mc = lt.train(dict(params, objective="multiclass", num_class=5,
                       metric="multi_logloss"),
                  lt.Dataset(X[:300_000], label=y5, params=params), 4)
    stump = lt.train(dict(small, min_gain_to_split=1e9),
                     lt.Dataset(X[:100_000], label=yc[:100_000],
                                params=small), 3)
    base31 = lt.train(small, lt.Dataset(X[:200_000], label=yc,
                                        params=small), 10)
    cont7 = lt.train(dict(small, num_leaves=7),
                     lt.Dataset(X[:200_000], label=yc, params=small), 10,
                     init_model=base31)
    return [("cat_nan", cat, Xc), ("special_values", None, Xs),
            ("five_class", mc, X[:300_000]), ("one_leaf", stump, Xs),
            ("cont_31_then_7", cont7, X[:200_000])]


def _p1_hold(torch, name, p, X, n_trees, chunk, config=None):
    """P1 (sum and leaves modes) on the packed trees ``p`` against its
    plain version on the card, bitwise, in ``p1_config``'s configuration
    or ``config``; returns the max |difference| of the sums."""
    from lightgbm_tpu_torch.models.tree import (ensemble_leaves_raw,
                                                ensemble_sum_raw)
    from lightgbm_tpu_torch.ops.cuda_predict import (ensemble_leaves_cuda,
                                                     ensemble_sum_cuda,
                                                     p1_config)

    Xc = torch.from_numpy(np.ascontiguousarray(X, np.float32)).cuda()
    s_k = ensemble_sum_cuda(p, Xc, n_trees, chunk, config)
    s_p = ensemble_sum_raw(p, Xc, n_trees, chunk)
    l_k = ensemble_leaves_cuda(p, Xc, n_trees, config)
    l_p = ensemble_leaves_raw(p, Xc, n_trees)
    torch.cuda.synchronize()
    err = float((s_k - s_p).abs().max())
    ok = torch.equal(s_k, s_p) and torch.equal(l_k, l_p)
    leaves = [int(v) for v in p.num_leaves[:n_trees].tolist()]
    if config is None:
        config = p1_config(X.shape[0], X.shape[1], n_trees, p.num_class,
                           torch.cuda.get_device_properties(0)
                           .multi_processor_count, p.max_tree_nodes)
    say(f"[predict {name}] {X.shape[0]} rows x {X.shape[1]} features x "
        f"{n_trees} trees (leaves {min(leaves)}-{max(leaves)}, "
        f"K={p.num_class}, depth {p.depth}), chunks of {chunk} iterations, "
        f"P1 (rows a block, tiled, staged records) {tuple(config)}: sums "
        f"and leaves bitwise the plain version's: {ok} (max |diff| "
        f"{err:.3g})")
    check(ok, f"predict {name}: P1 differs from its plain version")
    return err


def _auc(y, s):
    from lightgbm_tpu_torch.metrics import auc

    return float(auc(s, y))


def _percentiles(xs):
    a = np.asarray(xs) * 1e3
    return float(np.percentile(a, 50)), float(np.percentile(a, 99))


def phase_predict(torch, lt, params, train_set, valid_set, Xv):
    """Phase 18 (a): P1 held bitwise against its plain version on the
    bench model and the edge models; Booster.predict timed."""
    from lightgbm_tpu_torch.models.tree import ensemble_sum_raw
    from lightgbm_tpu_torch.ops import cuda_predict, launch_counts

    base = dict(params, tree_growth="leafwise", histogram_pool_size=0.0)
    with route_env("mega"):
        t0 = time.perf_counter()
        bst = lt.train(dict(base), train_set, PREDICT_TREES,
                       valid_sets=[valid_set], valid_names=["valid"],
                       verbose_eval=False)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        cases = _p1_cases(torch, lt, base, train_set,
                          np.concatenate([train_set.data, Xv]))
    gb = bst._gbdt
    X_all = np.ascontiguousarray(np.concatenate([train_set.data, Xv]),
                                 np.float32)
    n_all = X_all.shape[0]
    err = _p1_hold(torch, "bench_all_rows", gb._packed(), X_all,
                   PREDICT_TREES, gb._iter_chunk(n_all))
    err = max(err, _p1_hold(torch, "num_iteration_37", gb._packed(), X_all,
                            37, gb._iter_chunk(n_all)))
    # the timed call's shape: 1M rows in chunks of _iter_chunk(1M)
    err = max(err, _p1_hold(torch, "predict_1M", gb._packed(), X_all[:ROWS],
                            PREDICT_TREES, gb._iter_chunk(ROWS)))
    for name, b, X in cases:
        g = (b or bst)._gbdt
        T = len(g.models)
        err = max(err, _p1_hold(torch, name, g._packed(), X, T,
                                g._iter_chunk(X.shape[0])))
    del cases
    err = max(err, _p1_redesign_holds(torch, gb, X_all))
    # the valid AUC from predict against the one training reported
    reported = bst.eval_valid()[0][2]
    from_predict = _auc(valid_set.label, bst.predict(Xv, raw_score=True))
    say(f"[predict auc] valid AUC from predict {from_predict:.6f}, "
        f"reported by training {reported:.6f} [{CARD['name']}]")
    check(abs(from_predict - reported) <= 1e-6, "predict: valid AUC")

    # timing on 1M rows: Booster.predict (host wall), P1 and the plain
    # version (device ms, CUDA events)
    X1 = X_all[:ROWS]
    p = gb._packed()
    Xc = torch.from_numpy(X1).cuda()
    chunk = gb._iter_chunk(ROWS)
    bst.predict(X1)
    torch.cuda.synchronize()
    reset_counts()
    syncs = []
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        import warnings

        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = bst.predict(X1)
        syncs = [w for w in caught if "synchroniz" in str(w.message)]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    predict_s = time.perf_counter() - t0
    one_call = launch_counts()["P1"]
    check(one_call == 1 and out.shape == (ROWS,)
          and bool(np.isfinite(out).all()),
          f"predict: {one_call} P1 launches for one call")
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        bst.predict(X1)
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)
    stages = _predict_stages(torch, bst, X1, out)
    ms = time_ms(torch, lambda: cuda_predict.ensemble_sum_cuda(
        p, Xc, PREDICT_TREES, chunk), reps=10, warm=2)
    plain_ms = time_ms(torch, lambda: ensemble_sum_raw(
        p, Xc, PREDICT_TREES, chunk), reps=2, warm=1)
    # the bytes P1 must move: X once, the scores once, the node records,
    # leaf values and roots once; the operations: one comparison a node
    # visited (from the leaves' depths)
    leaves = cuda_predict.ensemble_leaves_cuda(p, Xc, PREDICT_TREES)
    visits = _visits(torch, gb.models, leaves)
    table = 4 * (p.node.numel() + p.leaf_value.numel() + p.root.numel()
                 + p.node_offset.numel())
    nbytes = X1.nbytes + ROWS * 4 + table
    bound_ms = max(nbytes / HBM_BYTES_PER_S, visits / F32_FLOPS) * 1e3
    bound_by = "bytes" if nbytes / HBM_BYTES_PER_S >= visits / F32_FLOPS \
        else "operations"
    say(f"[predict time] Booster.predict {ROWS} rows x {PREDICT_TREES} "
        f"trees of {NUM_LEAVES} leaves: wall {wall * 1e3:.2f} ms "
        f"(first timed call {predict_s * 1e3:.2f} ms), "
        f"{ROWS / wall:.4g} rows/s; P1 {one_call} launch and "
        f"{len(syncs)} synchronizing calls a predict; P1 device "
        f"ms={ms:.4f}, plain version ms={plain_ms:.2f}, bound "
        f"ms={bound_ms:.5f} ({bound_by}: {nbytes} B, {visits:.4g} node "
        f"visits, mean depth {visits / ROWS / PREDICT_TREES:.2f}), share "
        f"{100 * bound_ms / ms:.2f} %; node records {table} B; "
        f"training {PREDICT_TREES} trees {train_s:.1f}s")
    say("[predict stages] Booster.predict on 1M rows, median of 5, ms: "
        + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
        + f"; sum {sum(stages.values()):.2f} of the wall {wall * 1e3:.2f}")
    p1_ms = _p1_times(torch, gb, X1, Xc, visits, leaves)
    del Xc, leaves
    _p2_bench(torch, gb, X_all[ROWS:], visits, p1_ms["sum"])
    return bst, one_call, dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                               bound_by=bound_by, library_ms=None,
                               max_abs_err=err, predict_wall_ms=wall * 1e3,
                               p1_ms=p1_ms, stages=stages)


def _p2_bench(torch, gb, Xv, visits_1m, p1):
    """The served model's trees walked by P2: update mode over the 1M
    training rows (``merge_from``'s replay of an init model) and replay
    mode over the valid rows (``add_valid_dataset``), each held bitwise
    against the plain version and timed (ms a call, device ms, node
    visits a second) beside P1 over the same trees and the raw 1M rows
    in this run."""
    from lightgbm_tpu_torch.models.tree import binned_table
    from lightgbm_tpu_torch.ops import cuda_predict
    from lightgbm_tpu_torch.ops.cuda_predict_binned import (
        binned_replay_cuda_, binned_update_cuda_)

    trees = gb.models
    T = len(trees)
    table = binned_table(trees)
    tr, va = gb._bins_T, gb._valid_bins[0]
    chunk = gb._iter_chunk(va.shape[1])
    _p2_hold(torch, f"bench_{T}_update_1M", tr, 1, [(table, 0, 1.0)])
    _p2_hold(torch, f"bench_{T}_replay_valid", va, 1, [(table, None, chunk)])
    Xvc = torch.from_numpy(np.ascontiguousarray(Xv, np.float32)).cuda()
    visits_v = _visits(torch, trees, cuda_predict.ensemble_leaves_cuda(
        gb._packed(), Xvc, T))
    del Xvc
    s = torch.zeros((1, tr.shape[1]), device="cuda")
    sv = torch.zeros((1, va.shape[1]), device="cuda")
    runs = (("update, 1M training rows", visits_1m,
             lambda: binned_update_cuda_(s, table, tr, 0, 1.0)),
            (f"replay, {va.shape[1]} valid rows", visits_v,
             lambda: binned_replay_cuda_(sv, table, va, 1, chunk)))
    for label, vis, fn in runs:
        call = time_ms(torch, fn, reps=10, warm=2)
        dev = queued_ms(torch, fn, calls=5)
        say(f"[predict P2] {T} trees, {label}: ms={call:.4f} a call, "
            f"device ms={dev:.4f} a call queued, {vis / dev * 1e3:.4g} node "
            f"visits/s; P1 over the same trees and the raw 1M rows in this "
            f"run: ms={p1['ms']:.4f}, device ms={p1['device_ms']:.4f}, "
            f"{p1['visits'] / p1['device_ms'] * 1e3:.4g} visits/s "
            f"[{CARD['name']}]")


def _visits(torch, trees, leaves):
    """Node visits of a leaves-mode result ``[T, n]``: each row's leaf
    depth in each tree."""
    depth = torch.stack([t.leaf_depth.to(leaves.device)[leaves[i].long()]
                         for i, t in enumerate(trees)])
    return float(depth.double().sum())


def _p1_redesign_holds(torch, gb, X_all):
    """The holds of P1's configurations: 1 and 8 rows (one tree a slot),
    group boundaries inside chunks (32 rows a block, 8 tree slots, chunks
    of 3 iterations; through L1 and staged), and the bench trees' columns
    spread over ``WIDE_F`` features at 1,024 rows (tiled) and 4,096 rows
    (the wide configuration, X from global memory)."""
    p = gb._packed()
    T = p.num_trees
    err = 0.0
    for n in (1, 8):
        err = max(err, _p1_hold(torch, f"rows_{n}", p, X_all[:n], T, T))
    for stage in (0, 512):
        err = max(err, _p1_hold(torch, f"group_in_chunk_stage{stage}", p,
                                X_all[:20_000], T, 3, (32, True, stage)))
    from lightgbm_tpu_torch.models.tree import pack_trees

    rng = np.random.RandomState(181)
    perm = rng.choice(WIDE_F, N_FEAT, replace=False)
    to = torch.as_tensor(perm, dtype=torch.int32)
    wide = [t.replace(split_feature_real=torch.where(
        t.split_feature_real >= 0,
        to.to(t.split_feature_real.device)[
            t.split_feature_real.clamp(min=0).long()],
        t.split_feature_real)) for t in gb.models]
    pw = pack_trees(wide, 1, "cuda")
    Xw = rng.randn(4096, WIDE_F).astype(np.float32)
    Xw[:, perm] = X_all[:4096]
    for n in (1024, 4096):
        err = max(err, _p1_hold(torch, f"F{WIDE_F}_rows_{n}", pw, Xw[:n], T,
                                T))
    return err


def _predict_stages(torch, bst, X1, want):
    """Booster.predict's wall on ``X1`` split into its stages, each run
    as predict runs it (timed only; the path is not changed): the input
    to float64 (``basic._to_2d_float``), float64 -> float32 and the
    host-to-device copy (``GBDT._device_rows``), P1, the copy back, and
    the float64 cast and transform.  Median ms of 5 of each; the result is
    held bitwise to ``want``."""
    from lightgbm_tpu_torch.basic import _to_2d_float
    from lightgbm_tpu_torch.models.gbdt import transform_scores
    from lightgbm_tpu_torch.ops.predict import ensemble_sum

    gb = bst._gbdt
    names = ("input_to_f64", "f64_to_f32", "host_to_device", "p1",
             "device_to_host", "f64_and_transform")
    laps = {k: [] for k in names}
    for _ in range(5):
        torch.cuda.synchronize()
        t = [time.perf_counter()]
        X = _to_2d_float(X1)
        t.append(time.perf_counter())
        X32 = np.ascontiguousarray(X, np.float32)
        t.append(time.perf_counter())
        Xt = torch.from_numpy(X32).to(gb.device)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        acc = ensemble_sum(gb._packed(), Xt, gb._n_trees(-1),
                           gb._iter_chunk(Xt.shape[0]))
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        host = acc.cpu().numpy()
        t.append(time.perf_counter())
        out = transform_scores(host.astype(np.float64), gb.num_class,
                               gb.sigmoid, gb.objective_name())
        t.append(time.perf_counter())
        for k, a, b in zip(names, t, t[1:]):
            laps[k].append((b - a) * 1e3)
    check(np.array_equal(out, want), "predict stages: another answer")
    return {k: statistics.median(v) for k, v in laps.items()}


def _p1_times(torch, gb, X1, Xc, visits_1m, leaves_1m):
    """P1's device ms at 1M rows (sums and leaves) and at 1, 8, 128 and
    1,024 rows (sums, one chunk, as a dispatch runs it): the CUDA-event ms
    a call (as PR 13 timed it, the host's launch inside the window) and
    the device ms a call of back-to-back launches (``queued_ms``), each
    with the node visits a second and PR 13's time."""
    from lightgbm_tpu_torch.ops import cuda_predict

    p = gb._packed()
    T = p.num_trees
    chunk = gb._iter_chunk(X1.shape[0])
    runs = [("sum", X1.shape[0], visits_1m,
             lambda: cuda_predict.ensemble_sum_cuda(p, Xc, T, chunk)),
            ("leaves", X1.shape[0], visits_1m,
             lambda: cuda_predict.ensemble_leaves_cuda(p, Xc, T))]
    for n in P1_BUCKETS:
        Xn = Xc[:n].contiguous()
        vis = _visits(torch, gb.models, leaves_1m[:, :n])
        runs.append((n, n, vis, lambda Xn=Xn: cuda_predict.ensemble_sum_cuda(
            p, Xn, T, T)))
    out = {}
    for key, n, vis, fn in runs:
        small = n < X1.shape[0]
        call = time_ms(torch, fn, reps=50 if small else 10)
        dev = queued_ms(torch, fn, calls=50 if small else 5)
        cfg = cuda_predict.p1_config(
            n, X1.shape[1], T, 1,
            torch.cuda.get_device_properties(0).multi_processor_count,
            p.max_tree_nodes, key == "leaves")
        out[key] = dict(ms=call, device_ms=dev, visits=vis)
        label = f"{key} mode, {n} rows" if key in ("sum", "leaves") else \
            f"sum mode, {n} rows (one chunk)"
        say(f"[predict P1] {label}, config {cfg}: ms={call:.4f} a call, "
            f"device ms={dev:.4f} a call queued, {vis / dev * 1e3:.4g} node "
            f"visits/s ({vis:.4g} visits); PR 13: ms={PR13_P1_MS[key]:.4f} "
            f"a call ({PR13_P1_MS[key] / call:.1f}x)")
    return out


def _serve_pool(rng, Xv, bst_by_id):
    """The requests (rows of each size) and every model's offline answer
    to each, computed before any client runs."""
    reqs = [Xv[rng.randint(0, len(Xv) - n):][:n].astype(np.float64)
            for n in SERVE_SIZES for _ in range(8)]
    want = {mid: [b.predict(X).tobytes() for X in reqs]
            for mid, b in bst_by_id.items()}
    return reqs, want


def _run_clients(q, reqs, n_clients, n_each, out, stop=None):
    """Client threads sending ``n_each`` requests each (or until
    ``stop``): (latencies, errors)."""
    import threading

    lats, errs, lock = [], [], threading.Lock()

    def client(c):
        for i in range(n_each):
            if stop is not None and stop.is_set():
                return
            j = (c * 7 + i) % len(reqs)
            t0 = time.perf_counter()
            try:
                r = q.predict(reqs[j], timeout=120)
            except Exception as e:  # noqa: BLE001 — counted, checked empty
                errs.append(e)
                return
            with lock:
                lats.append(time.perf_counter() - t0)
                out.append((j, r.model_id, r.values.tobytes()))

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(n_clients)]
    for t in threads:
        t.start()
    return threads, lats, errs


def phase_serving(torch, lt, bst, params, train_set, Xv):
    """Phase 18 (b)-(d): the engine and queue under 8 clients, the
    hot-swap under load and the HTTP front end."""
    import threading
    import urllib.request

    from lightgbm_tpu_torch import serving
    from lightgbm_tpu_torch.obs import telemetry
    from lightgbm_tpu_torch.ops import _build, cuda_predict, launch_counts

    out_dir = os.path.join(ROOT, "build", "serving")
    os.makedirs(out_dir, exist_ok=True)
    path_a = os.path.join(out_dir, "bench100.txt")
    bst.save_model(path_a)
    check(os.path.exists(path_a + ".sha256"), "serving: no sidecar")
    with route_env("mega"):
        more = lt.train(dict(params, tree_growth="leafwise",
                             histogram_pool_size=0.0), train_set,
                        SWAP_TREES, init_model=bst, verbose_eval=False)
    path_b = os.path.join(out_dir, "bench120.txt")
    more.save_model(path_b)
    off_a = lt.Booster(model_file=path_a)
    off_b = lt.Booster(model_file=path_b)
    pm = serving.load_packed_model(path_a)
    t0 = time.perf_counter()
    eng = serving.ServingEngine(pm)
    warm_s = time.perf_counter() - t0
    id_a = eng.model_id
    pm_b = serving.load_packed_model(path_b)
    id_b = pm_b.model_id
    # P1 at the dispatches' shapes: bucket inputs padded as the engine
    # pads them, the whole model in one chunk, on both served models
    err = 0.0
    for m in (pm, pm_b):
        for n in (1024, 300, 7, 1):
            Xp = np.zeros((eng.bucket_for(n), m.num_features), np.float32)
            Xp[:n] = Xv[:n]
            err = max(err, _p1_hold(
                torch, f"bucket_{Xp.shape[0]}_rows_{n}", m.packed, Xp,
                m.num_trees, m.num_trees // m.num_class))
    rng = np.random.RandomState(180)
    reqs, want = _serve_pool(rng, Xv, {id_a: off_a, id_b: off_b})
    telemetry.get_telemetry().reset()
    torch.cuda.synchronize()
    builds, reserved = _build.BUILDS, torch.cuda.memory_reserved()
    reset_counts()
    # (b) 8 clients x 250 requests through one queue
    res = []
    with serving.MicroBatchQueue(eng) as q:
        t0 = time.perf_counter()
        threads, lats, errs = _run_clients(q, reqs, SERVE_CLIENTS,
                                           SERVE_REQUESTS, res)
        for t in threads:
            t.join(600)
        wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = launch_counts()["P1"]
    tel = telemetry.get_telemetry()
    dispatches = tel.counter("serving.dispatches")
    grew = torch.cuda.memory_reserved() - reserved
    built = _build.BUILDS - builds
    same = all(mid == id_a and blob == want[id_a][j]
               for j, mid, blob in res)
    rows = sum(reqs[j].shape[0] for j, _, _ in res)
    p50, p99 = _percentiles(lats)
    say(f"[serve b] {len(res)} requests ({SERVE_CLIENTS} clients x "
        f"{SERVE_REQUESTS}, sizes {list(SERVE_SIZES)}) in {wall:.3f}s: "
        f"{len(res) / wall:.1f} requests/s, {rows / wall:.4g} rows/s, "
        f"latency p50 {p50:.3f} ms p99 {p99:.3f} ms; {dispatches} "
        f"dispatches, P1 launches {launches}; every response bitwise "
        f"Booster.predict of its rows: {same}; kernel builds after "
        f"prewarm {built}; memory_reserved grew {grew} B; prewarm of "
        f"{len(eng.buckets)} buckets {warm_s:.3f}s; errors {len(errs)}")
    check(not errs and len(res) == SERVE_CLIENTS * SERVE_REQUESTS,
          f"serving: {len(errs)} errors")
    check(same, "serving: a response differs from Booster.predict")
    check(built == 0 and grew == 0,
          f"serving: {built} builds, reserved grew {grew} B")
    check(launches == dispatches > 0, f"serving: {launches} P1 launches "
          f"for {dispatches} dispatches")
    # one dispatch's P1 (CUDA-event ms a call, and device ms a call of
    # back-to-back launches) and host ms (pad, copies, sync), at the padded
    # bucket the engine runs
    bucket_ms = {}
    for b in P1_BUCKETS:
        Xh = np.ascontiguousarray(reqs[-1][:b], np.float32)  # 1,024 rows
        Xp = np.zeros((eng.bucket_for(b), pm.num_features), np.float32)
        Xp[:b] = Xh
        Xb = torch.from_numpy(Xp).cuda()

        def p1():
            return cuda_predict.ensemble_sum_cuda(
                pm.packed, Xb, pm.num_trees, pm.num_trees)

        call_ms = time_ms(torch, p1, reps=50, warm=5)
        kernel_ms = queued_ms(torch, p1)
        host = []
        for _ in range(50):
            t0 = time.perf_counter()
            eng._dispatch_rows(pm, Xh)
            host.append(time.perf_counter() - t0)
        bucket_ms[b] = (call_ms, kernel_ms, statistics.median(host) * 1e3)
    say("[serve dispatch] " + ", ".join(
        f"{b} rows (bucket {eng.bucket_for(b)}): P1 ms={c:.4f} a call, "
        f"device ms={k:.4f} queued, whole dispatch host ms={h:.4f}"
        for b, (c, k, h) in bucket_ms.items()))

    # (c) hot-swap under load to the 120-tree continuation
    res_c = []
    stop = threading.Event()
    with serving.MicroBatchQueue(eng) as q:
        threads, lats_c, errs_c = _run_clients(q, reqs, 4, 10 ** 6, res_c,
                                               stop)
        while len(res_c) < 100 and not errs_c:
            time.sleep(0.005)
        summary = serving.adopt_model(eng, path_b)
        n_at = len(res_c)
        while len(res_c) < n_at + 200 and not errs_c:
            time.sleep(0.005)
        stop.set()
        for t in threads:
            t.join(120)
    ids = {mid for _, mid, _ in res_c}
    swap_ok = (not errs_c and ids == {id_a, id_b}
               and all(blob == want[mid][j] for j, mid, blob in res_c))
    say(f"[serve c] hot-swap under load (4 clients): {len(res_c)} "
        f"responses, model ids {sorted(i[:12] for i in ids)}, each "
        f"bitwise the offline answer of the model it names: {swap_ok}; "
        f"swap {summary['seconds']:.3f}s, kernel builds "
        f"{summary['warm']['compiles']}")
    check(swap_ok, f"serving: hot-swap ({len(errs_c)} errors)")

    # (d) HTTP
    http_lats, http_ok = [], True
    with serving.MicroBatchQueue(eng) as q:
        server = serving.ServingServer(eng, q, port=0).start()
        try:
            for i in range(HTTP_REQUESTS):
                j = i % len(reqs)
                body = json.dumps({"rows": reqs[j].tolist()}).encode()
                rq = urllib.request.Request(
                    server.url + "/v1/predict", data=body,
                    headers={"Content-Type": "application/json"})
                t0 = time.perf_counter()
                with urllib.request.urlopen(rq, timeout=60) as resp:
                    got = json.loads(resp.read())
                http_lats.append(time.perf_counter() - t0)
                http_ok &= (resp.status == 200 and got["model_id"] == id_b
                            and np.asarray(got["predictions"]).tobytes()
                            == want[id_b][j])
            with urllib.request.urlopen(server.url + "/v1/healthz",
                                        timeout=60) as resp:
                health = json.loads(resp.read())
            with urllib.request.urlopen(server.url + "/metrics",
                                        timeout=60) as resp:
                metrics = resp.read().decode()
        finally:
            server.close()
    hp50, hp99 = _percentiles(http_lats)
    say(f"[serve d] HTTP: {HTTP_REQUESTS} POST /v1/predict, latency p50 "
        f"{hp50:.3f} ms p99 {hp99:.3f} ms, bitwise offline: {http_ok}; "
        f"healthz {health['status']} {health['num_trees']} trees on "
        f"{health['device']}; /metrics {len(metrics.splitlines())} lines")
    check(http_ok and health["status"] == "ok"
          and health["num_trees"] == PREDICT_TREES + SWAP_TREES
          and "lgbm_serving_requests_total" in metrics
          and "lgbm_memory_reserved_bytes" in metrics, "serving: HTTP")
    return dict(launches=launches, max_abs_err=err, p50=p50, p99=p99,
                rps=len(res) / wall, rows_ps=rows / wall,
                http=(hp50, hp99), buckets=bucket_ms)


# ----------------------------------------------------------------- phase 19
FILES_DIR = os.path.join(ROOT, "build", "smoke_files")
CSV_CHUNK_ROWS = 25_000  # rows a formatting worker writes at a time


def _format_csv_rows(block):
    """``%.17g`` CSV lines of ``block`` [m, 1 + F] (label first): a
    process-pool worker's task."""
    fmt = ",".join(["%.17g"] * block.shape[1]) + "\n"
    return "".join(fmt % tuple(row) for row in block.tolist())


def write_csv(path, y, X):
    """The label and the features as ``%.17g`` CSV, formatted by a pool of
    spawned processes (one per core) and written in row order; returns
    the seconds it took."""
    import concurrent.futures as cf
    import multiprocessing as mp

    t0 = time.perf_counter()
    blocks = (np.column_stack([y[i:i + CSV_CHUNK_ROWS],
                               X[i:i + CSV_CHUNK_ROWS]]).astype(np.float64)
              for i in range(0, len(y), CSV_CHUNK_ROWS))
    with cf.ProcessPoolExecutor(os.cpu_count() or 1,
                                mp_context=mp.get_context("spawn")) as ex, \
            open(path, "w") as fh:
        for text in ex.map(_format_csv_rows, blocks):
            fh.write(text)
    return time.perf_counter() - t0


def _run_cli(torch, cli, argv):
    """``cli.main(argv, device="cuda")`` at verbose=1 with its log
    captured: (loading seconds, seconds to the last iteration) as the
    log reports them (None for a task without them)."""
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv + ["verbose=1"], device="cuda")
    torch.cuda.synchronize()
    log = buf.getvalue()
    check(rc == 0, f"cli {argv[:1]}: exit code {rc}:\n{log[-2000:]}")
    load = re.findall(r"Finish loading data, use ([0-9.]+) seconds", log)
    train = re.findall(r"([0-9.]+) seconds elapsed, finished iteration",
                       log)
    return (float(load[-1]) if load else None,
            float(train[-1]) if train else None)


def phase_files(torch, lt, params, mega):
    """Files, the CLI, the batch tier, ``task=serve`` and sklearn at the
    bench width: the bench data as ``%.17g`` CSV (1M + 200k rows, label
    in column 0); the CLI's model bitwise the in-memory model of phase 8's
    mega route (``mega``: its text and s/tree; the same data, parameters
    and trees), also from two-round loading and from the binary cache;
    ``task=predict``
    and ``pipelined_predict_file`` equal to ``Booster.predict`` formatted
    by ``format_block``; a few ``POST /v1/predict`` to ``task=serve``; an
    ``LGBMClassifier`` with the same model text."""
    import http.client

    from lightgbm_tpu_torch import cli, native
    from lightgbm_tpu_torch import sklearn as lsk
    from lightgbm_tpu_torch.io import parser
    from lightgbm_tpu_torch.serving import batch
    from lightgbm_tpu_torch.synthetic import bench_data

    os.makedirs(FILES_DIR, exist_ok=True)
    X, y, Xv, yv = bench_data(ROWS, seed=7, n_valid=VALID_ROWS)
    train_csv = os.path.join(FILES_DIR, "train.csv")
    valid_csv = os.path.join(FILES_DIR, "valid.csv")
    write_s = write_csv(train_csv, y, X) + write_csv(valid_csv, yv, Xv)
    mb = {p: os.path.getsize(p) / 1e6 for p in (train_csv, valid_csv)}
    say(f"[files] wrote {ROWS}+{VALID_ROWS} rows x {N_FEAT} features as "
        f"%.17g CSV ({mb[train_csv]:.1f} + {mb[valid_csv]:.1f} MB) in "
        f"{write_s:.2f}s with {os.cpu_count()} processes")

    # ---- parse rates of both readers, one-shot and streamed, on the
    # valid file, each bitwise the written floats
    fallbacks = native_fallbacks()
    for reader, switch in (("native", None), ("numpy", "1")):
        with env_var("LIGHTGBM_TPU_NO_NATIVE", switch):
            t0 = time.perf_counter()
            raw, _ = parser.parse_file(valid_csv)
            one_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            streamed = np.vstack(list(parser.parse_file_chunks(valid_csv)))
            stream_s = time.perf_counter() - t0
        check(np.array_equal(raw, streamed)
              and np.array_equal(raw[:, 1:], Xv.astype(np.float64))
              and np.array_equal(raw[:, 0], yv),
              f"files: the {reader} parse of the valid file differs from "
              "the written floats")
        say(f"[files] {reader} parse one-shot {mb[valid_csv] / one_s:.1f} "
            f"MB/s {VALID_ROWS / one_s:.0f} rows/s ({one_s:.3f}s); "
            f"streamed {mb[valid_csv] / stream_s:.1f} MB/s "
            f"{VALID_ROWS / stream_s:.0f} rows/s ({stream_s:.3f}s); host "
            f"CPUs {os.cpu_count()}")
        del raw, streamed
    with open("/proc/self/maps") as fh:
        gomp = sorted({line.split()[-1] for line in fh if "libgomp" in line})
    say(f"[files] native reader threads {native.num_threads()} (host CPUs "
        f"{os.cpu_count()}); OpenMP runtimes mapped: {gomp}")
    check(native.num_threads() == os.cpu_count(),
          "files: the native reader does not run a thread a CPU")

    ref_text, mega_s_per_tree = mega["text"], mega["s_per_tree"]

    # ---- the CLI: one-shot load, two-round load (writing the binary
    # cache), then the cache
    conf = os.path.join(FILES_DIR, "train.conf")
    with open(conf, "w") as fh:
        fh.write("\n".join([
            "task = train", "objective = binary", "metric = auc",
            "metric_freq = 1", "is_training_metric = false",
            f"max_bin = {NUM_BINS}", f"data = {train_csv}",
            f"valid_data = {valid_csv}", f"num_trees = {TREES}",
            f"learning_rate = {LEARNING_RATE}", f"num_leaves = {NUM_LEAVES}",
            f"min_data_in_leaf = {MIN_DATA}"]) + "\n")
    torch.cuda.reset_peak_memory_stats()
    for name, extra in (
            ("one-shot", ["enable_load_from_binary_file=false"]),
            ("two-round", ["use_two_round_loading=true",
                           "is_save_binary_file=true", "valid_data="]),
            ("binary-cache", ["valid_data="])):
        out = os.path.join(FILES_DIR, f"model-{name}.txt")
        stages = load_stages()
        t0 = time.perf_counter()
        load_s, train_s = _run_cli(
            torch, cli, [f"config={conf}", f"output_model={out}", *extra])
        wall = time.perf_counter() - t0
        stages = {k: v - stages[k] for k, v in load_stages().items()}
        with open(out) as fh:
            check(fh.read() == ref_text, f"files: the CLI's {name} model "
                  "differs from the in-memory train model")
        check(name != "two-round" or os.path.exists(train_csv + ".bin"),
              "files: no binary cache")
        say(f"[files cli {name}] wall {wall:.3f}s load_s={load_s:.3f} "
            f"train_s={train_s:.3f} s/tree={train_s / TREES:.4f} (phase 8 "
            f"mega s/tree={mega_s_per_tree:.4f}); model bitwise the "
            "in-memory train model")
        say(f"[files cli {name}] load stages " + " ".join(
            f"{k}={v:.3f}s" for k, v in stages.items()))
    os.remove(train_csv + ".bin")  # the C API's load parses the file
    say(f"[files] CLI peak device memory "
        f"{torch.cuda.max_memory_allocated()} bytes")

    # ---- task=predict and the pipelined batch tier
    model = os.path.join(FILES_DIR, "model-one-shot.txt")
    bst = lt.Booster(model_file=model)
    pred = bst.predict(Xv)
    want = batch.format_block(pred)
    result = os.path.join(FILES_DIR, "predict.txt")
    t0 = time.perf_counter()
    _run_cli(torch, cli, ["task=predict", f"data={valid_csv}",
                          f"input_model={model}", f"output_result={result}"])
    predict_s = time.perf_counter() - t0
    with open(result) as fh:
        check(fh.read() == want,
              "files: task=predict differs from Booster.predict")
    piped = os.path.join(FILES_DIR, "pipelined.txt")
    stats = batch.pipelined_predict_file(bst, valid_csv, piped,
                                         stream_threshold=0,
                                         chunk_rows=50_000)
    with open(piped) as fh:
        check(fh.read() == want, "files: pipelined_predict_file differs "
              "from Booster.predict")
    say(f"[files predict] task=predict {VALID_ROWS / predict_s:.0f} rows/s "
        f"({predict_s:.3f}s wall, one-shot); pipelined "
        f"{VALID_ROWS / stats['wall_s']:.0f} rows/s ({stats['wall_s']:.3f}s"
        f", {stats['chunks']} chunks): reader {stats['read_s']:.3f}s, "
        f"predict (P1) {stats['predict_s']:.3f}s, writer "
        f"{stats['write_s']:.3f}s, waiting on the reader "
        f"{stats['parse_wait_s']:.3f}s; both == format_block(predict)")

    # ---- task=serve
    cfg = lt.Config.from_dict(cli.load_parameters(
        ["task=serve", f"input_model={model}", "serve_port=0"]))
    server = cli.run_serve(cfg, device="cuda", block=False)
    try:
        conn = http.client.HTTPConnection(server.host, server.port,
                                          timeout=60)
        for lo, m in ((0, 1), (10, 7), (100, 64), (1000, 300)):
            rows = Xv[lo:lo + m].astype(np.float64)
            conn.request("POST", "/v1/predict",
                         json.dumps({"rows": rows.tolist()}),
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()
            body = json.loads(resp.read())
            check(resp.status == 200 and np.asarray(
                body["predictions"]).tobytes() == bst.predict(rows).tobytes(),
                f"files: task=serve's answer for {m} rows differs")
        conn.close()
    finally:
        server.queue.drain()
        server.close()
    say("[files serve] task=serve answered POST /v1/predict of 1, 7, 64 and "
        "300 rows with the offline answers, then drained")

    # ---- sklearn's classifier (this machine has no scikit-learn)
    est = lt.LGBMClassifier(
        n_estimators=TREES, num_leaves=NUM_LEAVES, max_bin=NUM_BINS,
        learning_rate=LEARNING_RATE, min_child_samples=MIN_DATA,
        min_child_weight=10.0, subsample_freq=0, device="cuda")
    t0 = time.perf_counter()
    est.fit(X, y.astype(int))
    fit_s = time.perf_counter() - t0
    check(est.booster_.model_to_string() == ref_text,
          "files: LGBMClassifier's model differs from the train model")
    proba = est.predict_proba(Xv)
    check(np.array_equal(proba[:, 1], est.booster_.predict(Xv))
          and np.array_equal(proba[:, 0], 1.0 - proba[:, 1]),
          "files: predict_proba differs from predict")
    say(f"[files sklearn] LGBMClassifier (base class "
        f"{lsk._SKLBase.__module__}.{lsk._SKLBase.__name__}) fit "
        f"{fit_s:.3f}s (binning the arrays in memory and {TREES} trees); "
        "model bitwise the train model; predict_proba == predict")
    check(native_fallbacks() == fallbacks,
          "files: the native reader handed a bench file to numpy")
    return dict(train=train_csv, valid=valid_csv, result=result, Xv=Xv,
                pred=pred)


def native_fallbacks():
    from lightgbm_tpu_torch.obs import telemetry

    return telemetry.get_telemetry().counter("native_fallbacks")


LOAD_STAGES = ("parse", "bin_find", "encode", "labels", "binary_cache")


def load_stages():
    """The loading spans' seconds so far (io/dataset.py's ``load.*``)."""
    from lightgbm_tpu_torch.obs import telemetry

    tel = telemetry.get_telemetry()
    return {k: getattr(tel.span_stat(f"load.{k}"), "total_s", 0.0)
            for k in LOAD_STAGES}


@contextlib.contextmanager
def env_var(name, value):
    """``name`` set to ``value`` inside (removed for None), then restored."""
    saved = os.environ.get(name)
    if value is None:
        os.environ.pop(name, None)
    else:
        os.environ[name] = value
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = saved


# ----------------------------------------------------------------- phase 23
def phase_capi(torch, lt, params, mega, files):
    """The C API (``csrc/host/lgbm_capi.c`` over ``capi_impl``) on the card
    with phase 19's files: the train and valid CSVs through
    ``LGBM_DatasetCreateFromFile`` (the native reader), ``BoosterCreate``,
    ``AddValidData``, TREES ``UpdateOneIter`` with every count set to 0
    just before (phase 8's mega launches, one P2 launch a tree for the
    valid set), ``GetEval``, ``SaveModel`` bitwise phase 8's mega model,
    ``PredictForMat`` on the valid rows bitwise ``Booster.predict`` and
    ``PredictForFile`` bitwise ``task=predict``'s result file."""
    import ctypes

    from lightgbm_tpu_torch import capi_impl
    from lightgbm_tpu_torch.ops import launch_counts

    try:
        with env_var("LGBM_CAPI_PLATFORM", None):
            _capi_run(torch, ctypes, capi_impl, launch_counts, params, mega,
                      files)
    finally:
        for name in os.listdir(FILES_DIR):
            os.remove(os.path.join(FILES_DIR, name))


def _capi_run(torch, ctypes, capi_impl, launch_counts, params, mega, files):
    t0 = time.perf_counter()
    lib = ctypes.CDLL(capi_impl.library_path())
    lib.LGBM_GetLastError.restype = ctypes.c_char_p
    load_s = time.perf_counter() - t0

    def ok(rc, what):
        check(rc == 0, f"capi {what}: {lib.LGBM_GetLastError().decode()}")

    pstr = " ".join(f"{k}={v}" for k, v in params.items()).encode()
    fallbacks, stages = native_fallbacks(), load_stages()
    train, valid, bst = (ctypes.c_void_p() for _ in range(3))
    t0 = time.perf_counter()
    ok(lib.LGBM_DatasetCreateFromFile(files["train"].encode(), pstr, None,
                                      ctypes.byref(train)), "train dataset")
    train_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ok(lib.LGBM_DatasetCreateFromFile(files["valid"].encode(), pstr, train,
                                      ctypes.byref(valid)), "valid dataset")
    valid_s = time.perf_counter() - t0
    stages = {k: v - stages[k] for k, v in load_stages().items()}
    check(native_fallbacks() == fallbacks,
          "capi: the native reader handed a bench file to numpy")
    ok(lib.LGBM_BoosterCreate(train, pstr, ctypes.byref(bst)), "booster")
    ok(lib.LGBM_BoosterAddValidData(bst, valid), "valid data")
    fin = ctypes.c_int()
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    for _ in range(TREES):
        ok(lib.LGBM_BoosterUpdateOneIter(bst, ctypes.byref(fin)), "update")
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    counts = launch_counts()
    want = dict(mega["counts"], P2=TREES)
    check(counts == want, f"capi: launches {counts} != {want}")
    n = ctypes.c_int64()
    ok(lib.LGBM_BoosterGetEvalCounts(bst, ctypes.byref(n)), "eval counts")
    check(n.value == 1, f"capi: {n.value} metrics, expected the AUC")
    auc = (ctypes.c_double * 1)()
    ok(lib.LGBM_BoosterGetEval(bst, 1, ctypes.byref(n), auc), "eval")
    model = os.path.join(FILES_DIR, "model-capi.txt")
    ok(lib.LGBM_BoosterSaveModel(bst, -1, model.encode()), "save")
    with open(model) as fh:
        check(fh.read() == mega["text"],
              "capi: the model differs from phase 8's mega model")
    Xv = np.ascontiguousarray(files["Xv"], np.float64)
    out = np.empty(len(Xv), np.float64)
    reset_counts()
    t0 = time.perf_counter()
    ok(lib.LGBM_BoosterPredictForMat(
        bst, Xv.ctypes.data_as(ctypes.c_void_p), 1, len(Xv), Xv.shape[1], 1,
        0, ctypes.c_int64(-1), ctypes.byref(n),
        out.ctypes.data_as(ctypes.c_void_p)), "predict mat")
    mat_s = time.perf_counter() - t0
    p1 = launch_counts()["P1"]
    check(n.value == len(Xv) and out.tobytes() == files["pred"].tobytes(),
          "capi: PredictForMat differs from Booster.predict")
    result = os.path.join(FILES_DIR, "predict-capi.txt")
    t0 = time.perf_counter()
    ok(lib.LGBM_BoosterPredictForFile(
        bst, files["valid"].encode(), 0, 0, ctypes.c_int64(-1),
        result.encode()), "predict file")
    file_s = time.perf_counter() - t0
    with open(result) as fh, open(files["result"]) as ref:
        check(fh.read() == ref.read(),
              "capi: PredictForFile differs from task=predict")
    for h in (train, valid):
        ok(lib.LGBM_DatasetFree(h), "free")
    ok(lib.LGBM_BoosterFree(bst), "free")
    say(f"[capi] shim loaded in {load_s:.3f}s; DatasetCreateFromFile train "
        f"{train_s:.3f}s, valid {valid_s:.3f}s (stages " + " ".join(
            f"{k}={v:.3f}s" for k, v in stages.items()) + f"); {TREES} "
        f"UpdateOneIter {elapsed:.3f}s s/tree={elapsed / TREES:.4f} (phase 8 "
        f"mega s/tree={mega['s_per_tree']:.4f}); launches "
        f"{json.dumps({k: v for k, v in counts.items() if v})}; valid AUC "
        f"{auc[0]:.6f} (phase 8 {mega['auc'][1]:.6f}); model bitwise phase "
        f"8's mega model")
    say(f"[capi] PredictForMat {len(Xv)} rows {mat_s:.3f}s ({p1} P1 "
        f"launches) bitwise Booster.predict; PredictForFile {file_s:.3f}s "
        "bitwise task=predict")


# ----------------------------------------------------------------- phase 20
SPARSE_ROWS, SPARSE_VALID = 1_000_000, 200_000
SPARSE_COLS, SPARSE_GROUPS = 4228, 33  # Allstate's one-hot width, ~33 a row
LIBSVM_ROWS = 100_000
DENSE_TREES = 3  # trees of the dense K1'' route compared with S1's


def allstate_csr(n, seed):
    """Allstate-shaped one-hot rows: SPARSE_GROUPS categorical columns of
    seeded lognormal cardinalities (SPARSE_COLS one-hot columns in all),
    Zipf-skewed categories, one stored 1.0 per group a row; a binary
    label from a seeded linear function of 5 % of the columns plus noise.
    The cardinalities and weights do not depend on ``n`` or ``seed``.
    Returns (indptr, indices, values, label)."""
    rng = np.random.RandomState(1234)
    w = rng.lognormal(0, 1.2, SPARSE_GROUPS)
    sizes = np.maximum(2, np.round(w / w.sum() * SPARSE_COLS)).astype(int)
    sizes[-1] += SPARSE_COLS - sizes.sum()
    off = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    coef = rng.randn(SPARSE_COLS) * (rng.rand(SPARSE_COLS) < 0.05)
    rng = np.random.RandomState(seed)
    cats = np.empty((n, SPARSE_GROUPS), np.int64)
    for g in range(SPARSE_GROUPS):
        p = 1.0 / np.arange(1, sizes[g] + 1) ** 1.1
        cats[:, g] = rng.choice(sizes[g], n, p=p / p.sum())
    idx = (cats + off).reshape(-1)
    z = coef[idx].reshape(n, SPARSE_GROUPS).sum(1)
    y = (z - z.mean()) / z.std() + 0.8 * rng.randn(n) > 0
    indptr = np.arange(0, n * SPARSE_GROUPS + 1, SPARSE_GROUPS,
                       dtype=np.int64)
    return indptr, idx, np.ones(len(idx)), y.astype(np.float32)


def _s1_holds(torch, cs, sh, what, cpu, gpu, lid, g, h, m, L, B,
              want=None):
    """S1 on the card against its plain version on the CPU (``want``, or
    computed here), bitwise, and two launches against each other: (S1's
    output, the largest absolute difference from the plain version)."""
    got = cs.sparse_histogram_by_leaf_cuda(gpu, lid, g, h, m, L, B)
    again = cs.sparse_histogram_by_leaf_cuda(gpu, lid, g, h, m, L, B)
    if want is None:
        want = sh.sparse_histogram_by_leaf_plain(cpu, lid.cpu(), g.cpu(),
                                                 h.cpu(), m.cpu(), L, B)
    torch.cuda.synchronize()
    check(torch.equal(got, again), f"S1 {what}: launches differ")
    err = float((got.cpu() - want).abs().max())
    check(torch.equal(got.cpu(), want),
          f"S1 {what}: differs from its plain version (max {err})")
    return got, err


def _s1_random_case(torch, sh, cs, rng, what, n, F, per_row, nb, dtype, L,
                    seg=None, leaves=None):
    """S1 against its plain version on random CSR entries (``seg``
    entries a segment, by default the dataset's choice for ``nb`` bins;
    rows in ``leaves``, by default all L): (the largest absolute
    difference, S1's inputs on the card)."""
    nnz_row = rng.poisson(per_row, n)
    indptr = np.concatenate([[0], np.cumsum(nnz_row)]).astype(np.int64)
    col = rng.randint(0, F, int(indptr[-1])).astype(np.int32)
    args = (indptr, col, rng.randint(0, nb, len(col)).astype(dtype),
            rng.randint(0, nb, F).astype(np.int32), F)
    seg = seg or sh.segment_entries(nb)
    cpu, gpu = sh.csc_from_csr(*args, "cpu", seg), sh.csc_from_csr(
        *args, "cuda", seg)

    def dev(a):
        return torch.from_numpy(a).cuda()

    lid = rng.randint(0, L, n) if leaves is None else rng.choice(leaves, n)
    inputs = (dev(lid.astype(np.int32)),
              dev(rng.randn(n).astype(np.float32)),
              dev(rng.rand(n).astype(np.float32)),
              dev((rng.rand(n) < 0.8).astype(np.float32)))
    _, err = _s1_holds(torch, cs, sh, what, cpu, gpu, *inputs, L, nb)
    return err, (gpu, *inputs, L, nb)


def _default_bin_case(torch, sh, cs):
    """tests/test_sparse.py:293's case (500k rows, 2 leaves): S1 bitwise
    its plain version, the default bins within 2e-5 relative of float64.
    Returns (the worst relative error, the largest absolute difference
    from the plain version)."""
    rng = np.random.RandomState(11)
    n, f, nb, L = 500_000, 4, 16, 2
    indptr = np.concatenate(
        [[0], np.cumsum(rng.binomial(f, 0.01, n))]).astype(np.int64)
    col = rng.randint(0, f, int(indptr[-1])).astype(np.int32)
    args = (indptr, col, rng.randint(1, nb, len(col)).astype(np.uint8),
            np.zeros(f, np.int32), f)
    lid = rng.randint(0, L, n).astype(np.int32)
    g = (rng.rand(n) + 0.5).astype(np.float32)
    h = (rng.rand(n) + 0.5).astype(np.float32)
    got, err = _s1_holds(torch, cs, sh, "500k default bin",
                         sh.csc_from_csr(*args, "cpu"),
                         sh.csc_from_csr(*args, "cuda"),
                         torch.from_numpy(lid).cuda(),
                         torch.from_numpy(g).cuda(),
                         torch.from_numpy(h).cuda(),
                         torch.ones(n, device="cuda"), L, nb)
    got = got.cpu().numpy()
    erow = sh.entry_rows(indptr)
    worst = 0.0
    for lf in range(L):
        tot = np.sum(g[lid == lf], dtype=np.float64)
        for ff in range(f):
            sel = (lid[erow] == lf) & (col == ff)
            want = tot - np.sum(g[erow][sel], dtype=np.float64)
            worst = max(worst, abs(float(got[lf, ff, 0, 0]) - want)
                        / max(abs(want), 1.0))
    check(worst < 2e-5, f"S1 default bin: relative error {worst}")
    return worst, err


def _libsvm_matches_csr(lt, params, indptr, idx, vals, y):
    """The first LIBSVM_ROWS rows as a LibSVM file, loaded by
    ``from_file``: the same SparseBins as the CSR ingest of those rows."""
    from lightgbm_tpu_torch.io.dataset import BinnedDataset

    path = os.path.join(FILES_DIR, "allstate.svm")
    os.makedirs(FILES_DIR, exist_ok=True)
    t0 = time.perf_counter()
    end = int(indptr[LIBSVM_ROWS])
    # every row stores SPARSE_GROUPS entries (allstate_csr)
    check(end == LIBSVM_ROWS * SPARSE_GROUPS, "sparse: ragged rows")
    fmt = "%d" + " %d:1" * SPARSE_GROUPS + "\n"
    table = np.column_stack([y[:LIBSVM_ROWS].astype(np.int64),
                             idx[:end].reshape(LIBSVM_ROWS, SPARSE_GROUPS)])
    with open(path, "w") as fh:
        fh.write("".join(fmt % tuple(r) for r in table.tolist()))
    write_s = time.perf_counter() - t0
    cfg = lt.Config.from_dict(params)
    t0 = time.perf_counter()
    loaded = BinnedDataset.from_file(path, cfg)
    load_s = time.perf_counter() - t0
    direct = BinnedDataset.from_csr(indptr[:LIBSVM_ROWS + 1], idx[:end],
                                    vals[:end], SPARSE_COLS,
                                    loaded.metadata, cfg)
    check(loaded.is_sparse and all(
        np.array_equal(getattr(loaded.X_bin, k), getattr(direct.X_bin, k))
        for k in ("indptr", "col", "bin", "default_bins")),
        "sparse: the LibSVM file's bins differ from the CSR ingest's")
    os.remove(path)
    say(f"[sparse libsvm] {LIBSVM_ROWS} rows written in {write_s:.2f}s, "
        f"loaded by from_file in {load_s:.2f}s: bins == the CSR ingest's")


def _train_timed(torch, booster, trees, pause_at=None, paused=None):
    """``trees`` updates with every kernel count set to 0 just before: (s/tree,
    launch counts read just after, depthwise levels grown, peak device
    bytes, what ``paused()`` returned).  ``paused`` runs after update
    ``pause_at`` with the clock stopped; it launches no counted kernel."""
    from lightgbm_tpu_torch.learners import depthwise
    from lightgbm_tpu_torch.ops import launch_counts

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    torch.cuda.synchronize()
    elapsed, got = 0.0, None
    t0 = time.perf_counter()
    for i in range(1, trees + 1):
        booster.update()
        if i == pause_at:
            torch.cuda.synchronize()
            elapsed += time.perf_counter() - t0
            got = paused()
            t0 = time.perf_counter()
    torch.cuda.synchronize()
    elapsed += time.perf_counter() - t0
    return (elapsed / trees, launch_counts(), depthwise.LEVELS,
            torch.cuda.max_memory_allocated(), got)


def _s1_wide_times(torch, cs, sh, rng):
    """S1 held and timed at a wide-bin shape: 1M rows x 1,000 features of
    255 bins, 20 stored entries a row (one leaf tile at 16 leaves, two at
    128).  Returns {leaves: (ms, plain ms, index_add_ ms, bound ms)} and
    the largest absolute difference."""
    n, F, per_row, nb = 1_000_000, 1000, 20, 255
    out, worst = {}, 0.0
    for L in (16, 128):
        err, (csc, lid, g, h, m, L, B) = _s1_random_case(
            torch, sh, cs, rng, f"wide bins, {L} leaves", n, F, per_row, nb,
            np.uint8, L)
        worst = max(worst, err)
        row = csc["row"].to(torch.int64)
        feat = torch.repeat_interleave(torch.arange(F, device="cuda"),
                                       torch.diff(csc["col_ptr"]))
        keys = ((lid.to(torch.int64)[row] * F + feat) * B
                + csc["bin"].to(torch.int64))
        src = torch.stack([g * m, h * m, m], -1).index_select(0, row)
        nnz = int(row.numel())
        out[L] = (
            time_ms(torch, lambda: cs.sparse_histogram_by_leaf_cuda(
                csc, lid, g, h, m, L, B)),
            time_ms(torch, lambda: sh.sparse_histogram_by_leaf_plain(
                csc, lid, g, h, m, L, B), reps=3, warm=1),
            time_ms(torch, lambda: torch.zeros(L * F * B, 3, device="cuda")
                    .index_add_(0, keys, src)),
            (nnz * 5 + 16 * n + L * F * B * 12) / HBM_BYTES_PER_S * 1e3)
        del keys, src, row, feat
    return out, worst


def phase_sparse(torch, lt):
    """Sparse depthwise at Allstate's width (module docstring, phase 20).
    Returns (S1's kernel record, its launches on the main path)."""
    import scipy.sparse as sps

    from lightgbm_tpu_torch.metrics import auc
    from lightgbm_tpu_torch.ops import cuda_histogram as ch
    from lightgbm_tpu_torch.ops import cuda_sparse_hist as cs
    from lightgbm_tpu_torch.ops import sparse_hist as sh

    t0 = time.perf_counter()
    indptr, idx, vals, y = allstate_csr(SPARSE_ROWS, seed=21)
    vptr, vidx, vvals, yv = allstate_csr(SPARSE_VALID, seed=22)
    X = sps.csr_matrix((vals, idx, indptr), shape=(SPARSE_ROWS, SPARSE_COLS))
    Xv = sps.csr_matrix((vvals, vidx, vptr),
                        shape=(SPARSE_VALID, SPARSE_COLS))
    gen_s = time.perf_counter() - t0
    params = {"objective": "binary", "num_leaves": NUM_LEAVES,
              "max_bin": NUM_BINS, "learning_rate": LEARNING_RATE,
              "min_data_in_leaf": MIN_DATA, "metric": "auc",
              "tree_growth": "depthwise", "verbose": -1}
    train_set = lt.Dataset(X, label=y, params=params)
    inner = train_set.construct()
    valid_set = train_set.create_valid(Xv, label=yv)
    valid_set.construct()
    bin_s = time.perf_counter() - t0 - gen_s
    bins = inner.bins_T("cuda")
    csc = inner.sparse_device("cuda")
    F = inner.num_features
    torch.cuda.synchronize()
    say(f"[sparse] {SPARSE_ROWS} rows x {SPARSE_COLS} one-hot columns ({F} "
        f"used, {inner.max_num_bin} bins), nnz={inner.X_bin.nnz} "
        f"density={inner.density:.5f}; data {gen_s:.1f}s, binning (train "
        f"and valid) {bin_s:.1f}s, the dense routing bins "
        f"({bins.numel()} bytes) and the CSC copy on the card "
        f"{time.perf_counter() - t0 - gen_s - bin_s:.1f}s")
    check(inner.is_sparse and inner.density <= 0.05, "sparse: not sparse")

    # ---- the sparse main path: TREES depthwise trees through S1, the
    # first tree's levels recorded for the checks below, the train AUC
    # after DENSE_TREES for the dense route's comparison
    booster = lt.Booster(params=params, train_set=train_set)
    gb = booster._gbdt
    real = gb._level_hist_fn()
    check(real.__qualname__.startswith("make_sparse_hist_fn"),
          "sparse: the gate did not pick the sparse histogram")
    levels = []

    def recording(bins_T, leaf_id, grad, hess, mask, num_leaves):
        if not gb.models:
            levels.append((leaf_id.clone(), grad, hess, mask, num_leaves))
        return real(bins_T, leaf_id, grad, hess, mask, num_leaves)

    gb._level_hist_fn = lambda: recording
    sparse_s, counts, n_levels, peak, train_auc_k = _train_timed(
        torch, booster, TREES, DENSE_TREES,
        lambda: booster.eval_train()[0][2])
    check(counts["S1"] == n_levels >= len(levels) > 0
          and counts[K1PP] == 0,
          f"sparse: launches {counts} over {n_levels} levels")
    booster.add_valid(valid_set, "valid")
    sp_auc = (booster.eval_train()[0][2], booster.eval_valid()[0][2])
    pv = booster.predict(Xv, raw_score=True)
    check(np.isfinite(pv).all() and abs(auc(pv, yv) - sp_auc[1]) < 1e-6,
          f"sparse: predict's valid AUC {auc(pv, yv)} vs {sp_auc[1]}")
    sp_auc_k = (train_auc_k, auc(booster.predict(
        Xv, raw_score=True, num_iteration=DENSE_TREES), yv))
    B = gb._num_bins

    # ---- S1 against its plain version at every level of the first tree;
    # the levels' plain versions run on four host threads at once
    cpu = inner.sparse_device("cpu")

    def plain(level):
        lid, g, h, m, L = level
        return sh.sparse_histogram_by_leaf_plain(cpu, lid.cpu(), g.cpu(),
                                                 h.cpu(), m.cpu(), L, B)

    with ThreadPoolExecutor(4) as pool:
        errs = [_s1_holds(torch, cs, sh, f"level {k} ({L} leaves)", cpu, csc,
                          lid, g, h, m, L, B, want)[1]
                for k, ((lid, g, h, m, L), want) in enumerate(
                    zip(levels, pool.map(plain, levels)))]
    s1_ms_levels = [time_ms(torch, lambda a=a: cs.sparse_histogram_by_leaf_cuda(
        csc, a[0], a[1], a[2], a[3], a[4], B), reps=5, warm=1)
        for a in levels]
    lid, g, h, m, L = levels[-1]
    s1_ms = time_ms(torch, lambda: cs.sparse_histogram_by_leaf_cuda(
        csc, lid, g, h, m, L, B))
    plain_ms = time_ms(torch, lambda: sh.sparse_histogram_by_leaf_plain(
        csc, lid, g, h, m, L, B), reps=3, warm=1)
    row = csc["row"].to(torch.int64)
    feat = torch.repeat_interleave(torch.arange(F, device="cuda"),
                                   torch.diff(csc["col_ptr"]))
    keys = ((lid.to(torch.int64)[row] * F + feat) * B
            + csc["bin"].to(torch.int64))
    src = torch.stack([g * m, h * m, m], -1).index_select(0, row)

    def library():
        return torch.zeros(L * F * B, 3, device="cuda").index_add_(0, keys,
                                                                   src)

    lib_ms = time_ms(torch, library)
    del keys, src, row, feat
    k1_ms = time_ms(torch, lambda: ch.histogram_by_leaf_sorted_cuda(
        bins, lid, g, h, m, B, L, "v1"), reps=5, warm=1)
    nnz = int(csc["row"].numel())
    nbytes = (nnz * (4 + csc["bin"].element_size()) + 16 * SPARSE_ROWS
              + L * F * B * 12)
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    say(f"[sparse S1] {len(levels)} levels of tree 1 bitwise == plain; at "
        f"the last level ({L} leaves): S1 ms={s1_ms:.4f} "
        f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} (index_add_ of "
        f"the stored entries, not deterministic) K1'' ms={k1_ms:.4f} on the "
        f"dense bins ({bins.numel()} bytes) bound_ms={bound:.5f} "
        f"({nbytes} bytes) share={bound / s1_ms:.4f}; S1 ms by level "
        f"{[round(t, 4) for t in s1_ms_levels]}")

    # ---- the 500k-row default-bin case, uint16 bins, short segments,
    # several leaf tiles, features of several segments over two tiles, a
    # level of empty leaves and the wide-bin shape
    worst, err = _default_bin_case(torch, sh, cs)
    errs.append(err)
    rng = np.random.RandomState(12)
    for what, args, kw in (
            ("uint16 x 300 bins", (200_000, 50, 5, 300, np.uint16, 16), {}),
            ("64-entry segments", (50_000, 40, 4, 300, np.uint16, 9),
             dict(seg=64)),
            ("200 leaves x 300 uint16 bins, 512-entry segments",
             (30_000, 40, 4, 300, np.uint16, 200), dict(seg=512)),
            ("two-segment wide features, 128 leaves", (140_000, 2, 1, 255,
                                                       np.uint8, 128), {}),
            ("empty leaves", (100_000, 30, 3, 255, np.uint8, 40),
             dict(leaves=np.arange(0, 40, 3)))):
        errs.append(_s1_random_case(torch, sh, cs, rng, what, *args,
                                    **kw)[0])
    check(cs.leaf_tiles(200, 300)[1] == 4 and cs.leaf_tiles(128, 255)[1] == 2,
          f"S1 plan: {cs.leaf_tiles(200, 300)}, {cs.leaf_tiles(128, 255)}")
    wide, err = _s1_wide_times(torch, cs, sh, rng)
    errs.append(err)
    say(f"[sparse S1] bitwise == plain on the 500k-row default-bin case "
        f"(default bins within {worst:.2e} relative of float64), on uint16 "
        "x 300 bins, 64-entry segments, 200 leaves x 300 bins in 512-entry "
        "segments (4 leaf tiles, each folded), two-segment wide features "
        "at 128 leaves (2 tiles) and 26 of 40 leaves empty")
    for nl, (ms, p_ms, l_ms, b_ms) in wide.items():
        say(f"[sparse S1 wide] 1M rows x 1000 features x 255 bins, 20M "
            f"entries, {nl} leaves ({cs.leaf_tiles(nl, 255)[1]} leaf "
            f"tiles): bitwise == plain; S1 ms={ms:.4f} plain_ms={p_ms:.4f} "
            f"library_ms={l_ms:.4f} bound_ms={b_ms:.5f} "
            f"share={b_ms / ms:.4f}")
    _libsvm_matches_csr(lt, params, indptr, idx, vals, y)

    # ---- the dense K1'' route on the same data, DENSE_TREES trees
    dense = lt.Booster(params=dict(params, sparse_hist_density=0.0),
                       train_set=train_set)
    check(not dense._gbdt._level_hist_fn().__qualname__.startswith(
        "make_sparse_hist_fn"), "sparse: sparse_hist_density=0 kept S1")
    dense_s, dense_counts, dense_levels, dense_peak, _ = _train_timed(
        torch, dense, DENSE_TREES)
    check(dense_counts[K1PP] == dense_levels > 0 and dense_counts["S1"] == 0,
          f"sparse: the dense route launched {dense_counts}")
    dense.add_valid(valid_set, "valid")
    de_auc = (dense.eval_train()[0][2], dense.eval_valid()[0][2])
    check(all(abs(a - b) <= AUC_TOL for a, b in zip(sp_auc_k, de_auc)),
          f"sparse: AUC at {DENSE_TREES} trees {sp_auc_k} (S1) vs {de_auc} "
          f"(K1'') beyond +-{AUC_TOL}")
    say(f"[sparse main] S1 route s/tree={sparse_s:.4f} auc={sp_auc[0]:.6f}/"
        f"{sp_auc[1]:.6f} ({sp_auc_k[0]:.6f}/{sp_auc_k[1]:.6f} at "
        f"{DENSE_TREES} trees) launches={json.dumps(counts)} peak_mem_bytes="
        f"{peak}; dense K1'' route ({DENSE_TREES} trees) s/tree={dense_s:.4f} "
        f"auc={de_auc[0]:.6f}/{de_auc[1]:.6f} launches="
        f"{json.dumps(dense_counts)} peak_mem_bytes={dense_peak}")
    return dict(max_abs_err=max(errs), ms=s1_ms, plain_ms=plain_ms,
                bound_ms=bound, library_ms=lib_ms), counts["S1"]


# ----------------------------------------------------------------- phase 25
# (a) the route matrix: bench rows, RES_LEAVES leaves, RES_TREES trees, one
# checkpoint after RES_AT written to a file and restored into a new booster
RES_ROWS, RES_VALID_ROWS, RES_LEAVES = 100_000, 20_000, 63
RES_TREES, RES_AT, RES_LANE_ROWS, RES_CLASSES = 6, 3, 2048, 5
# (name, route_env key, parameters over the matrix's bench config, rows,
# the kernels the resumed trees must launch)
RES_MC = {"objective": "multiclass", "num_class": RES_CLASSES,
          "metric": "multi_logloss"}
RES_ROUTES = [
    ("mega", "mega", {}, RES_ROWS, ("K1'", "K3", "K8", "K7", "P2")),
    ("record", "record", {}, RES_ROWS, ("K1'", "K3", "K4", "K6", "K7", "P2")),
    ("order", "order", {}, RES_ROWS, ("K1", "K3", "P2")),
    ("pooled", "pooled", {"histogram_pool_size": POOL_MB}, RES_ROWS,
     ("K1", "K3", "K5", "P2")),
    ("depthwise", "depthwise", {"tree_growth": "depthwise"}, RES_ROWS,
     (K1PP, "P2")),
    ("hybrid", "hybrid", {"tree_growth": "hybrid"}, RES_ROWS,
     (K1PP, "K1", "K3", "P2")),
    ("f64-leafwise", "f64-leafwise", {"hist_dtype": "float64"}, RES_ROWS,
     ("K1-f64", "K3-f64", "K3-f64 step", "P2")),
    ("dart", "mega", {"boosting_type": "dart", "bagging_fraction": 0.8,
                      "bagging_freq": 1, "feature_fraction": 0.8,
                      "drop_rate": 0.5, "skip_drop": 0.0}, RES_ROWS,
     ("K1'", "K3", "K8", "K7", "P2")),
    ("multiclass-lanes", "mega", RES_MC, RES_LANE_ROWS, ("F1", "F3", "P2")),
    ("multiclass-loop", "mega", RES_MC, RES_ROWS,
     ("K1'", "K3", "K8", "K7", "P2")),
]
# (b) the CLI at the bench width: phase 19's train.conf with a snapshot
# every RES_SNAPSHOT iterations, the kill fault after RES_KILL_AT, and an
# external SIGTERM after an iteration drawn from RES_SIGTERM_SEED
RES_SNAPSHOT, RES_KILL_AT, RES_SIGTERM_SEED = 3, 4, 25
# (c) the fleet over phase 18's model: FLEET_CLIENTS clients of
# FLEET_REQUESTS requests of 1-64 valid rows, replica 0 SIGKILLed after
# FLEET_KILL_AFTER answered requests
FLEET_CLIENTS, FLEET_REQUESTS, FLEET_KILL_AFTER = 4, 100, 50
RES_DIR = os.path.join(ROOT, "build", "resilience")


def _res_sets(lt, base):
    """The matrix's train and valid sets: binary and five-class labels
    on the bench rows, and the lanes' first RES_LANE_ROWS rows."""
    from lightgbm_tpu_torch.synthetic import bench_data, multiclass_labels

    X, y, Xv, yv = bench_data(RES_ROWS, seed=7, n_valid=RES_VALID_ROWS)
    ymc, yvmc = multiclass_labels(X, Xv, RES_CLASSES)
    sets = {}
    for kind, (a, b) in (("binary", (y, yv)), ("multiclass", (ymc, yvmc))):
        for n in (RES_ROWS, RES_LANE_ROWS):
            tr = lt.Dataset(X[:n], label=a[:n], max_bin=NUM_BINS,
                            params=base)
            tr.construct()
            m = n * RES_VALID_ROWS // RES_ROWS
            sets[kind, n] = (tr, tr.create_valid(Xv[:m], label=b[:m]))
    return sets


def _res_route(torch, lt, ck, sets, base, route):
    """One route of (a): the uninterrupted booster checkpointed after
    RES_AT trees (its state unchanged by it) and trained on; a new booster
    restored from the file and trained to RES_TREES; the model strings
    and the resumed trees' launches compared."""
    from lightgbm_tpu_torch.ops import launch_counts

    name, env, extra, n, kernels = route
    params = dict(base, **extra)
    tr, va = sets["multiclass" if "num_class" in params else "binary", n]

    def booster():
        bst = lt.Booster(params=params, train_set=tr)
        bst.add_valid(va, "valid")
        return bst

    def rest(bst):
        torch.cuda.synchronize()
        reset_counts()
        for _ in range(RES_TREES - RES_AT):
            bst.update()
        torch.cuda.synchronize()
        return launch_counts()

    path = ck.checkpoint_file(os.path.join(RES_DIR, name), RES_AT)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with route_env(env):
        full = booster()
        for _ in range(RES_AT):
            full.update()
        t0 = time.perf_counter()
        ck.save_checkpoint(path, full._gbdt, full._gbdt.config,
                           iteration=RES_AT)
        save_s = time.perf_counter() - t0
        want = rest(full)
        res = booster()
        t0 = time.perf_counter()
        payload = ck.load_checkpoint(path)
        ck.validate_against_config(payload, res._gbdt.config, path)
        at = ck.restore_training_state(res._gbdt, payload)
        load_s = time.perf_counter() - t0
        got = rest(res)
    same = res.model_to_string() == full.model_to_string()
    launched = {k: v for k, v in got.items() if v}
    say(f"[resilience a {name}] {n} rows x {N_FEAT}, {RES_LEAVES} leaves: "
        f"checkpoint after {at} trees ({os.path.getsize(path)} bytes, "
        f"save {save_s:.4f}s, load + restore {load_s:.4f}s); resumed model "
        f"bitwise the uninterrupted run's: {same}; launches of trees "
        f"{RES_AT + 1}-{RES_TREES} resumed {json.dumps(launched)}, "
        f"uninterrupted equal: {got == want}")
    check(at == RES_AT and same,
          f"resilience (a) {name}: the resumed model differs")
    check(got == want, f"resilience (a) {name}: resumed launches {got} != "
          f"the uninterrupted run's {want}")
    check(all(got[k] > 0 for k in kernels),
          f"resilience (a) {name}: a kernel of the route never launched "
          f"({launched})")
    return launched


def _cli_argv(conf, out, *extra):
    return [sys.executable, "-u", "-m", "lightgbm_tpu_torch",
            f"config={conf}", "enable_load_from_binary_file=false",
            f"snapshot_freq={RES_SNAPSHOT}", f"output_model={out}",
            "verbose=1", *extra]


def _child_env(fault=""):
    env = {k: v for k, v in os.environ.items() if k != "LGBM_TPU_FAULT"}
    if fault:
        env["LGBM_TPU_FAULT"] = fault
    return env


def _finish_child(proc, log_path, want_rc, what):
    rc = proc.wait(300)
    with open(log_path) as fh:
        log = fh.read()
    check(rc == want_rc, f"resilience (b) {what}: exit code {rc}, expected "
          f"{want_rc}:\n{log[-3000:]}")
    return log


def _cli_chain(conf, out, kind, term_at, procs, result):
    """One of (b)'s two runs: ``python -m lightgbm_tpu_torch`` preempted
    (``kind`` "kill": the kill fault; "term": SIGTERM from here once its
    log says iteration ``term_at`` finished), then its ``--resume``;
    ``result`` gets both logs and their seconds."""
    import signal

    log = os.path.join(FILES_DIR, f"{kind}.log")
    t0 = time.perf_counter()
    if kind == "kill":
        with open(log, "w") as fh:
            proc = subprocess.Popen(
                _cli_argv(conf, out), stdout=fh, stderr=subprocess.STDOUT,
                cwd=ROOT, env=_child_env(f"kill_after_tree:{RES_KILL_AT}"))
        procs.append(proc)
    else:
        proc = subprocess.Popen(
            _cli_argv(conf, out), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, cwd=ROOT, env=_child_env())
        procs.append(proc)
        sent = False
        with open(log, "w") as fh:
            for line in proc.stdout:
                fh.write(line)
                if not sent and line.rstrip().endswith(
                        f"finished iteration {term_at}"):
                    proc.send_signal(signal.SIGTERM)
                    sent = True
        check(sent, "resilience (b): the SIGTERM run never reached "
              f"iteration {term_at}")
    result["killed"] = _finish_child(proc, log, 75, kind)
    result["killed_s"] = time.perf_counter() - t0
    result["wrote"] = os.path.exists(out)
    log = os.path.join(FILES_DIR, f"{kind}-resume.log")
    t0 = time.perf_counter()
    with open(log, "w") as fh:
        proc = subprocess.Popen(
            _cli_argv(conf, out, "--resume"), stdout=fh,
            stderr=subprocess.STDOUT, cwd=ROOT, env=_child_env())
    procs.append(proc)
    result["resumed"] = _finish_child(proc, log, 0, f"{kind} --resume")
    result["resumed_s"] = time.perf_counter() - t0


def _res_cli(torch):
    """(b) ``python -m lightgbm_tpu_torch`` on phase 19's train.conf (the
    mega route, 1M + 200k rows, TREES trees, the valid AUC each round)
    with a snapshot every RES_SNAPSHOT iterations: killed by the fault
    after RES_KILL_AT, and by an external SIGTERM after a drawn iteration,
    the two runs side by side, each resumed as soon as it exits; each
    exits 75 and its ``--resume`` writes phase 19's model-one-shot.txt
    byte for byte, on the card."""
    import threading

    conf = os.path.join(FILES_DIR, "train.conf")
    with open(os.path.join(FILES_DIR, "model-one-shot.txt"), "rb") as fh:
        want = fh.read()
    term_at = int(np.random.RandomState(RES_SIGTERM_SEED).randint(
        2, TREES - 2))
    say(f"[resilience b] external SIGTERM after the log line of iteration "
        f"{term_at} (drawn from seed {RES_SIGTERM_SEED})")
    out = {k: os.path.join(FILES_DIR, f"model-{k}.txt")
           for k in ("kill", "term")}
    res = {"kill": {}, "term": {}}
    procs, errors = [], []

    def kill_chain():
        try:
            _cli_chain(conf, out["kill"], "kill", term_at, procs,
                       res["kill"])
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    t0 = time.perf_counter()
    side = threading.Thread(target=kill_chain)
    try:
        side.start()
        _cli_chain(conf, out["term"], "term", term_at, procs, res["term"])
        side.join()
    finally:
        side.join(600)
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(30)
    if errors:
        raise errors[0]
    wall = time.perf_counter() - t0
    for k in ("kill", "term"):
        r = res[k]
        check(not r["wrote"],
              f"resilience (b) {k}: a model was written on preemption")
        stop = int(re.findall(r"preempted at iteration (\d+)",
                              r["killed"])[-1])
        check(stop == RES_KILL_AT if k == "kill" else stop >= term_at,
              f"resilience (b) {k}: preempted at iteration {stop}")
        with open(out[k], "rb") as fh:
            same = fh.read() == want
        with open(out[k] + ".manifest.json") as fh:
            runtime = json.load(fh)["runtime"]
        snaps = re.findall(
            r"Checkpoint written: \S+ \(iteration (\d+), (\d+) bytes in "
            r"([0-9.]+) seconds, device reads ([0-9.]+) seconds\)",
            r["killed"])
        restore = re.findall(r"continuing at iteration (\d+) \(read, checked "
                             r"and restored in ([0-9.]+) seconds\)",
                             r["resumed"])
        load = re.findall(r"Finish loading data, use ([0-9.]+) seconds",
                          r["resumed"])
        check(bool(snaps) and bool(restore),
              f"resilience (b) {k}: no checkpoint / resume line")
        say(f"[resilience b {k}] preempted after iteration {stop} -> exit 75 "
            f"({r['killed_s']:.2f}s); checkpoints " + ", ".join(
                f"iteration {it}: {b} bytes in {s}s (host sync + device "
                f"reads of the 1.2M scores and the trees {d}s)"
                for it, b, s, d in snaps)
            + f"; --resume ({r['resumed_s']:.2f}s) read, checked and "
            f"restored the checkpoint in {restore[-1][1]}s (continuing at "
            f"iteration {restore[-1][0]}; the data load {load[-1]}s) -> exit "
            f"0; model bitwise phase 19's model-one-shot.txt: {same}; "
            f"backend {runtime.get('backend')} "
            f"({runtime.get('device_kind')})")
        check(same, f"resilience (b) {k}: the resumed model differs from "
              "model-one-shot.txt")
        check(runtime.get("backend") == "cuda",
              f"resilience (b) {k}: the resumed run ran on {runtime}")
        shutil.rmtree(out[k] + ".ckpt")  # phase 23 empties FILES_DIR of files
    say(f"[resilience b] both runs and their resumes, side by side, in "
        f"{wall:.2f}s")


class _ResFleet:
    """(c) ``ReplicaSupervisor(subprocess_factory(...), replicas=2)``
    behind a ``FleetFrontEnd`` over phase 18's 100-tree model: 4 clients,
    SIGKILL of replica 0 under load, no request failed, every answer
    bitwise ``Booster.predict`` of its rows, the replacement's seconds to
    ready, then ``stop()``: the replicas drain and exit 75.  The replicas
    boot while (a) runs and the replacement while (b) runs: ``start``,
    ``serve`` and ``finish`` are the three steps."""

    def __init__(self, lt, files):
        import threading

        from lightgbm_tpu_torch import cli, serving

        model = os.path.join(ROOT, "build", "serving", "bench100.txt")
        offline = lt.Booster(model_file=model)
        Xv = files["Xv"]
        rng = np.random.RandomState(250)
        self.reqs = []
        for _ in range(FLEET_CLIENTS * FLEET_REQUESTS):
            m = int(rng.randint(1, 65))
            lo = int(rng.randint(0, len(Xv) - m))
            rows = Xv[lo:lo + m].astype(np.float64)
            self.reqs.append((rows, offline.predict(rows).tobytes()))
        self.workdir = os.path.join(ROOT, "build", "fleet")
        shutil.rmtree(self.workdir, ignore_errors=True)
        os.makedirs(self.workdir)
        cfg = lt.Config.from_dict(cli.load_parameters(
            ["task=serve_fleet", f"input_model={model}", "serve_port=0"]))
        self.sup = serving.ReplicaSupervisor(
            serving.subprocess_factory(cfg, self.workdir), replicas=2,
            restart_budget=cfg.serve_restart_budget, seed=cfg.seed,
            health_interval_s=0.1)
        self.serving, self.front = serving, None
        self.lock = threading.Lock()
        self.answered, self.failed, self.lats = [], [], []
        self.kill, self.error = {}, None
        self.thread = threading.Thread(target=self._start)

    def _start(self):
        try:
            t0 = time.perf_counter()
            self.sup.start()
            self.start_s = time.perf_counter() - t0
        except BaseException as e:  # noqa: BLE001 — raised in serve()
            self.error = e

    def start(self):
        self.thread.start()

    def _watch(self, old_pid):
        while time.perf_counter() - self.kill["t"] < 300:
            pids = [r["pid"] for r in self.sup.describe()["replicas"]]
            if old_pid not in pids and len(pids) == 2:
                self.kill["ready_s"] = time.perf_counter() - self.kill["t"]
                return
            time.sleep(0.005)

    def _client(self, c):
        import http.client
        import threading

        front = self.front
        conn = http.client.HTTPConnection(front.host, front.port, timeout=60)
        for j in range(c, len(self.reqs), FLEET_CLIENTS):
            rows, want = self.reqs[j]
            t0 = time.perf_counter()
            try:
                conn.request("POST", "/v1/predict",
                             json.dumps({"rows": rows.tolist()}),
                             {"Content-Type": "application/json"})
                resp = conn.getresponse()
                body = json.loads(resp.read())
            except (OSError, http.client.HTTPException) as e:
                self.failed.append(f"transport: {e}")
                conn = http.client.HTTPConnection(front.host, front.port,
                                                  timeout=60)
                continue
            dt = time.perf_counter() - t0
            ok = resp.status == 200 and np.asarray(
                body.get("predictions")).tobytes() == want
            with self.lock:
                self.lats.append(dt)
                if ok:
                    self.answered.append(j)
                else:
                    self.failed.append((resp.status, str(body)[:200]))
                if len(self.answered) == FLEET_KILL_AFTER and not self.kill:
                    sup = self.sup
                    self.kill["pid"] = sup.describe()["replicas"][0]["pid"]
                    self.kill["t"] = time.perf_counter()
                    sup.chaos_kill(0)
                    threading.Thread(target=self._watch,
                                     args=(self.kill["pid"],),
                                     daemon=True).start()
        conn.close()

    def serve(self):
        """The clients through the front end; the killed replica's
        replacement boots after they return."""
        import threading

        self.thread.join()
        if self.error is not None:
            raise self.error
        self.front = self.serving.FleetFrontEnd(self.sup)
        t0 = time.perf_counter()
        threads = [threading.Thread(target=self._client, args=(c,))
                   for c in range(FLEET_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        self.load_s = time.perf_counter() - t0

    def finish(self):
        """Wait for the replacement, stop the fleet, check and print."""
        while "ready_s" not in self.kill and \
                time.perf_counter() - self.kill.get("t", 0) < 300:
            time.sleep(0.01)
        handles = [s.handle for s in self.sup._slots]
        restarts, fleet_failed = self.sup.restarts_total, self.sup.failed
        self.close()
        rcs = [h.exit_code() for h in handles]
        p50, p99 = _percentiles(self.lats)
        kill, failed = self.kill, self.failed
        say(f"[resilience c] 2 replicas ({self.start_s:.2f}s to ready, "
            f"booting during (a)) behind the front end: "
            f"{len(self.answered)} of {len(self.reqs)} requests answered "
            f"({FLEET_CLIENTS} clients, 1-64 rows) in {self.load_s:.2f}s, "
            f"failed {len(failed)}; every answer bitwise Booster.predict "
            f"of its rows: {not failed}; replica 0 (pid {kill.get('pid')}) "
            f"SIGKILLed after {FLEET_KILL_AFTER} answers, replacement ready "
            f"after {kill.get('ready_s', float('nan')):.2f}s (booting "
            f"during (b)); restarts_total {restarts}; front end latency p50 "
            f"{p50:.3f} ms p99 {p99:.3f} ms; stop(): replicas exited {rcs}")
        check(kill and not failed
              and len(self.answered) == len(self.reqs),
              f"resilience (c): {len(failed)} failed requests: {failed[:3]}")
        check(restarts >= 1 and fleet_failed is None and "ready_s" in kill,
              f"resilience (c): restarts {restarts}, failed {fleet_failed}")
        check(rcs == [75, 75], f"resilience (c): replicas exited {rcs}")
        shutil.rmtree(self.workdir, ignore_errors=True)

    def close(self):
        """Stop the front end and the fleet (idempotent): every replica
        process ends."""
        if self.front is not None:
            self.front.close()
            self.front = None
        self.thread.join()
        self.sup.stop()


def phase_resilience(torch, lt, files):
    """Phase 25: checkpoints, resume and the fleet on the card: (a) the
    route matrix, (b) the CLI at the bench width, (c) the fleet, whose
    replicas boot while (a) and (b) run."""
    from lightgbm_tpu_torch.resilience import checkpoint as ck

    base = {"objective": "binary", "num_leaves": RES_LEAVES,
            "max_bin": NUM_BINS, "learning_rate": LEARNING_RATE,
            "min_data_in_leaf": MIN_DATA, "metric": "auc", "verbose": -1}
    fleet = _ResFleet(lt, files)
    try:
        fleet.start()
        t0 = time.perf_counter()
        sets = _res_sets(lt, base)
        for route in RES_ROUTES:
            _res_route(torch, lt, ck, sets, base, route)
        shutil.rmtree(RES_DIR, ignore_errors=True)
        del sets
        say(f"[resilience a] {len(RES_ROUTES)} routes bitwise, launches "
            f"equal, in {time.perf_counter() - t0:.2f}s")
        t0 = time.perf_counter()
        fleet.serve()
        serve_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        _res_cli(torch)
        cli_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        fleet.finish()
        say(f"[resilience] (c) clients {serve_s:.2f}s, (b) {cli_s:.2f}s, "
            f"(c) the rest {time.perf_counter() - t0:.2f}s")
    finally:
        fleet.close()


# -------------------------------------------------------------- phase 26
PAR_TREES = 3  # trees a learner grows in phase 26, bench and exact-sum
PAR_WORLD = 4  # (b)'s gloo ranks sharing cuda:0
# (b)'s leaves: every collective of four ranks sharing one card costs
# milliseconds (gloo over loopback, the card time-sliced between four
# processes), and a 255-leaf tree makes 766 of them
PAR_B_LEAVES = 15
PAR_DIR = os.path.join(ROOT, "build", "smoke_parallel")
# (b)'s learners: (name, tree_learner, extra params); voting5 selects 10
# of the 28 features a split, so it need not grow the serial tree
PAR_LEARNERS = (("data", "data", {}),
                ("data-depthwise", "data", {"tree_growth": "depthwise"}),
                ("data-hybrid", "data", {"tree_growth": "hybrid"}),
                ("feature", "feature", {}),
                ("voting20", "voting", {"top_k": 20}),
                ("voting5", "voting", {"top_k": 5}),
                ("grid", "grid", {"grid_feature_shards": 2}))


def _par_growth(extra) -> str:
    return extra.get("tree_growth", "leafwise")


def _par_exact_grads(torch, n):
    """PAR_TREES exact-sum gradient vectors: integers in [-4, 4] (every
    sum of 1M rows stays below 2**24 units: exact in float32), hessians
    1."""
    rng = np.random.RandomState(26)
    return [torch.from_numpy(rng.randint(-4, 5, n).astype(np.float32))
            .cuda() for _ in range(PAR_TREES)]


def _par_args(torch, gbdt, grad, hess=None):
    """A grower's arguments on ``gbdt``'s bins and constraints, every row
    and feature in, with ``grad`` (and unit hessians by default)."""
    ones = torch.ones_like(grad)
    return (gbdt._bins_T, grad, ones if hess is None else hess, ones,
            torch.ones(gbdt._bins_T.shape[0], dtype=torch.bool,
                       device=grad.device), gbdt._nbpf, gbdt._is_cat,
            gbdt._params)


def _par_tree(t) -> dict:
    return {k: getattr(t, k).cpu() for k in TREE_FIELDS} | {
        "num_leaves": int(t.num_leaves)}


def _par_refs(torch, lt, params, train_set, valid_set, growths):
    """The serial learner's references at ``params``: per growth, PAR_TREES
    bench trees through the API with each iteration's gradients and the
    AUCs, and the exact-sum trees with their leaf ids (leaf-wise on the
    record route, the data-parallel learner's own)."""
    import functools

    from lightgbm_tpu_torch.learners.depthwise import grow_tree_depthwise
    from lightgbm_tpu_torch.learners.hybrid import grow_tree_hybrid
    from lightgbm_tpu_torch.learners.serial import grow_tree
    from lightgbm_tpu_torch.ops.cuda_histogram import (
        histogram_record_window, histogram_single_leaf, make_level_hist_fn)

    refs = {"bench": {}, "exact": {}}
    for growth in growths:
        bst = lt.Booster(params=dict(params, tree_growth=growth),
                         train_set=train_set)
        gb = bst._gbdt
        grads = []
        for _ in range(PAR_TREES):
            g, h = gb.objective.get_gradients(gb._scores[0])
            grads.append((g.cpu(), h.cpu()))
            bst.update()
        bst.add_valid(valid_set, "valid")
        refs["bench"][growth] = dict(
            trees=[_par_tree(t) for t in gb.models], grads=grads,
            auc=(bst.eval_train()[0][2], bst.eval_valid()[0][2]))
        kw = dict(num_bins=NUM_BINS, max_leaves=gb.max_leaves)
        exact = []
        for g in _par_exact_grads(torch, gb.num_data):
            args = _par_args(torch, gb, g)
            if growth == "depthwise":
                t, lid = grow_tree_depthwise(*args, **kw)
            elif growth == "hybrid":
                t, lid = grow_tree_hybrid(
                    *args, **kw, hist_fn=functools.partial(
                        histogram_single_leaf, num_bins=NUM_BINS),
                    level_hist_fn=make_level_hist_fn(NUM_BINS))
            else:
                t, lid = grow_tree(*args, **kw,
                                   hist_fn_raw=histogram_record_window)
            exact.append((_par_tree(t), lid.cpu()))
        refs["exact"][growth] = exact
    return refs


def _par_bitwise(torch, t, lid, ref) -> bool:
    tree, ref_lid = ref
    return (int(t.num_leaves) == tree["num_leaves"]
            and all(torch.equal(getattr(t, k).cpu(), tree[k])
                    for k in TREE_FIELDS)
            and torch.equal(lid.cpu(), ref_lid))


def _par_root_sg(grad, hess, blocks: int) -> float:
    """The relative difference of the root's Σg as the serial learner
    sums it (every row in one float32 pass) and as ``blocks`` ranks of
    contiguous rows do (a pass each, the partials added in rank order)."""
    from lightgbm_tpu_torch.learners.serial import _root_sums

    ones = grad.new_ones(grad.shape)
    whole = float(_root_sums(grad, hess, ones)[0])
    part = np.zeros(2, np.float32)
    for gb, hb, mb in zip(grad.chunk(blocks), hess.chunk(blocks),
                          ones.chunk(blocks)):
        part = part + _root_sums(gb, hb, mb)[:2]
    return float(f"{abs(float(part[0]) - whole) / max(abs(whole), 1e-30):.3g}")


def _par_divergent(t, r) -> tuple:
    """(the internal nodes whose feature, threshold bin or decision type
    differ between trees ``t`` and ``r`` (None: another leaf count), the
    relative gap of the two split gains at the first such node)."""
    k = min(t["num_leaves"], r["num_leaves"]) - 1
    same = np.ones(k, bool)
    for f in ("split_feature", "threshold_bin", "decision_type"):
        same &= t[f][:k].numpy() == r[f][:k].numpy()
    bad = np.flatnonzero(~same)
    gap = 0.0
    if len(bad):
        a = float(t["split_gain"][bad[0]])
        b = float(r["split_gain"][bad[0]])
        gap = abs(a - b) / max(abs(b), 1e-30)
    return (int(len(bad)) if t["num_leaves"] == r["num_leaves"] else None,
            round(gap, 6))


def _par_div_ok(div) -> bool:
    """At most one divergent node in every tree, against the serial
    learner given the root totals the world reduced."""
    return all(d["witness"][0] is not None and d["witness"][0] <= 1
               for d in div)


def _par_same_grads(torch, gbdt, ref, blocks: int):
    """The learner's trees grown from the serial run's gradients of each
    iteration (structure comparable tree by tree, where boosting's own
    scores drift apart after a flip), each against (``witness``) the
    serial learner grown from the same gradients with the root's
    ``[Σg, Σh, count]`` the world all-reduced (the record route with a
    ``reduce_fn`` that returns them; the serial tree where the learner
    reduced no root sums), and against (``serial``) the serial run's
    tree, with ``sg``, the root Σg's relative difference of ``blocks``
    row blocks and one pass.  The rank's reduced root sums are taken
    from ``Mesh.psum`` at the ``*.root_sums_allreduce`` sites."""
    from lightgbm_tpu_torch.learners.serial import grow_tree
    from lightgbm_tpu_torch.ops.cuda_histogram import histogram_record_window
    from lightgbm_tpu_torch.parallel import mesh as pmesh

    psum = pmesh.Mesh.psum
    seen = []

    def recording_psum(self, x, site=None):
        out = psum(self, x, site)
        if site and site.endswith("root_sums_allreduce"):
            seen.append(out.cpu().clone())
        return out

    out = []
    for (g, h), serial_tree in zip(ref["grads"], ref["trees"]):
        g, h = g.cuda(), h.cuda()
        seen.clear()
        pmesh.Mesh.psum = recording_psum
        try:
            t, _ = gbdt._learner(*_par_args(torch, gbdt, g, h))
        finally:
            pmesh.Mesh.psum = psum
        t = _par_tree(t)
        witness = serial_tree
        if seen:
            totals = seen[-1]
            w, _ = grow_tree(*_par_args(torch, gbdt, g, h), num_bins=NUM_BINS,
                             max_leaves=gbdt.max_leaves,
                             hist_fn_raw=histogram_record_window,
                             reduce_fn=lambda x: totals.to(x.dtype),
                             child_counts_fn=lambda nl, nr: torch.stack(
                                 [nl, nr]))
            witness = _par_tree(w)
        out.append(dict(witness=_par_divergent(t, witness),
                        serial=_par_divergent(t, serial_tree),
                        sg=_par_root_sg(g, h, blocks)))
    return out


def _par_census():
    from lightgbm_tpu_torch.obs.dist import collective_census

    return collective_census()


def _par_delta(after, before) -> dict:
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0) and k.startswith("collective_site.")}


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _par_nccl(torch, lt, params, train_set, valid_set, refs):
    """(a) A one-rank NCCL world in this process, the bench at full
    width: the data-parallel learner on the record route, its exact-sum
    trees bitwise the serial record route's with each tree's launches,
    host syncs and census exact, then PAR_TREES bench trees through the
    training API."""
    import torch.distributed as dist

    from lightgbm_tpu_torch.learners import serial
    from lightgbm_tpu_torch.ops import launch_counts
    from lightgbm_tpu_torch.parallel import data_mesh
    from lightgbm_tpu_torch.parallel import mesh as pmesh
    from lightgbm_tpu_torch.parallel.data_parallel import \
        make_data_parallel_grower

    pmesh.init_world("nccl", 0, 1, f"tcp://127.0.0.1:{_free_port()}",
                     timeout_s=60, device=torch.device("cuda:0"))
    try:
        grower = make_data_parallel_grower(data_mesh(device="cuda"),
                                           NUM_BINS, NUM_LEAVES)
        bst = lt.Booster(params=dict(params, tree_learner="data"),
                         train_set=train_set)
        gb = bst._gbdt
        gb._learner = grower  # a world of one grows serially
        ok, per_tree = True, []
        for i, g in enumerate(_par_exact_grads(torch, gb.num_data)):
            args = _par_args(torch, gb, g)
            torch.cuda.synchronize()
            reset_counts()
            pmesh.reset_counters()
            c0 = _par_census()
            t0 = time.perf_counter()
            t, lid = grower(*args)
            torch.cuda.synchronize()
            per_tree.append(time.perf_counter() - t0)
            counts = {k: v for k, v in launch_counts().items() if v}
            sites = {k.split(".")[2]: v
                     for k, v in _par_delta(_par_census(), c0).items()}
            S = t.num_leaves - 1
            want = {"K1'": 1 + S, "K3": 1 + S, "K6": S, "K7": S}
            want_sites = {"root_sums_allreduce": 1,
                          "hist_reduce_scatter": S + 1,
                          "root_split_allgather": 1,
                          "child_counts_allgather": S,
                          "split_allgather": S, "leaf_id_allgather": 1}
            bit = _par_bitwise(torch, t, lid, refs["exact"]["leafwise"][i])
            ok &= (bit and counts == want and sites == want_sites
                   and serial.HOST_SYNCS == 3 + 2 * S
                   and pmesh.CALLS == 3 * S + 4)
            say(f"[parallel a exact] tree {i}: {t.num_leaves} leaves, "
                f"{per_tree[-1]:.4f}s, bitwise the serial record route's "
                f"(every tree field, leaf ids): {bit}; launches "
                f"{json.dumps(counts)} (expected {json.dumps(want)}); host "
                f"syncs {serial.HOST_SYNCS} (expected {3 + 2 * S}); "
                f"collectives {pmesh.CALLS} (3 a split, the root's 3, the "
                f"leaf ids' 1) in {pmesh.SECONDS * 1e3:.1f} ms; census "
                f"{json.dumps(sites)}")
        check(ok, "phase 26 (a): the one-rank NCCL learner's exact-sum "
              "trees, launches, host syncs or census differ")
        div = _par_same_grads(torch, gb, refs["bench"]["leafwise"], 1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(PAR_TREES):
            bst.update()
        torch.cuda.synchronize()
        el = (time.perf_counter() - t0) / PAR_TREES
        bst.add_valid(valid_set, "valid")
        auc = (bst.eval_train()[0][2], bst.eval_valid()[0][2])
    finally:
        dist.destroy_process_group()
    ref_auc = refs["bench"]["leafwise"]["auc"]
    say(f"[parallel a bench] {PAR_TREES} trees s/tree={el:.4f} "
        f"(exact-sum s/tree={statistics.median(per_tree):.4f}); from the "
        f"serial (mega) run's gradients, a tree's divergent nodes and the "
        f"gain gap where they start, against the serial learner given the "
        f"world's root totals and against the serial run's tree, and the "
        f"root's Σg of one block against one pass: {json.dumps(div)}; AUC "
        f"{auc[0]:.6f}/{auc[1]:.6f}, serial {ref_auc[0]:.6f}/"
        f"{ref_auc[1]:.6f}")
    check(_par_div_ok(div), f"phase 26 (a): divergent nodes {div}")
    check(all(abs(a - b) <= AUC_TOL for a, b in zip(auc, ref_auc)),
          f"phase 26 (a): AUC {auc} against {ref_auc}")


def _par_latency(torch, mesh, reps=100) -> float:
    """ms a tiny all-gather of this world's CUDA tensors takes (a child
    count's)."""
    x = torch.zeros(2, dtype=torch.int32, device="cuda")
    mesh.all_gather(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        mesh.all_gather(x)
    return (time.perf_counter() - t0) * 1e3 / reps


def _par_expected(name, n, splits, levels, level_splits):
    """The launches, host syncs and collectives of ``n`` trees of (b)'s
    learner ``name`` with ``splits`` splits, ``levels`` level histograms
    and ``level_splits`` of the splits made by levels: leaf-wise on the
    record route (data, voting) a root K1' + K3 and per split K6, K7, one
    window K1' and K3 (voting: K3 once a child), three host syncs at the
    root (the sums, their all-reduce, the search) and two a split, and
    the root's three collectives (the sums, the histogram or votes +
    histograms, the split) plus three a split; the feature and grid
    learners on the order route K1 + K3 at the root and a split, the
    feature learner's only collective its split all-gather and its root
    sums not reduced; depthwise one K1'' pass, one host sync and a
    reduce-scatter + all-gather a level; hybrid its level phase, then the
    resume's fused pass (a K1'' pass, a sync, two collectives) and per
    best-first split K1, K3, two syncs and three collectives.  Every
    row-sharded learner all-gathers the leaf ids once a tree.  Every
    learner of a world of more than one rank adds the desync sentinel's
    host read of the tree and its all-gather, one each a tree
    (parallel/multihost.py)."""
    launches, syncs, calls = _par_route_counts(name, n, splits, levels,
                                               level_splits)
    return launches, syncs + n, calls + n


def _par_route_counts(name, n, splits, levels, level_splits):
    """``_par_expected``'s counts of the learner's route alone."""
    S = splits
    if name == "data-depthwise":
        return {"K1″": levels}, levels, 2 * levels + n
    if name == "data-hybrid":
        tail = splits - level_splits
        return ({"K1″": levels + n, "K1": tail, "K3": tail},
                levels + n + 2 * tail, 2 * levels + 3 * n + 3 * tail)
    if name == "feature":
        return {"K1": n + S, "K3": n + S}, 2 * n + 2 * S, n + S
    if name == "grid":
        return {"K1": n + S, "K3": n + S}, 3 * n + 2 * S, 4 * n + 3 * S
    k3 = n + (2 * S if name.startswith("voting") else S)
    return ({"K1'": n + S, "K3": k3, "K6": S, "K7": S}, 3 * n + 2 * S,
            4 * n + 3 * S)


def _par_rank_child(torch, rank: int, world: int, port: int) -> int:
    """``--parallel-rank R W PORT``: one of (b)'s gloo ranks on cuda:0.
    Makes the bench data from its seed and, for each learner, grows its
    bench trees through the training API, its trees from the serial
    run's gradients and its exact-sum trees, and saves what it saw to
    PAR_DIR/rank<R>.pt."""
    import lightgbm_tpu_torch as lt
    import torch.distributed as dist

    from lightgbm_tpu_torch.learners import depthwise, serial
    from lightgbm_tpu_torch.ops import launch_counts
    from lightgbm_tpu_torch.parallel import data_mesh
    from lightgbm_tpu_torch.parallel import mesh as pmesh

    torch.cuda.set_device(0)
    torch.set_num_threads(2)
    pmesh.init_world("gloo", rank, world, f"tcp://127.0.0.1:{port}",
                     timeout_s=60)
    try:
        refs = torch.load(os.path.join(PAR_DIR, "refs.pt"))
        t0 = time.perf_counter()
        params, train_set, valid_set, _ = make_bench_data(lt, quiet=True)
        params["num_leaves"] = PAR_B_LEAVES
        out = {"data_s": time.perf_counter() - t0, "learners": {},
               "latency_ms": _par_latency(torch, data_mesh(device="cuda"))}
        for name, tl, extra in PAR_LEARNERS:
            bst = lt.Booster(params=dict(params, tree_learner=tl, **extra),
                             train_set=train_set)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            pmesh.reset_counters()
            t0 = time.perf_counter()
            for _ in range(PAR_TREES):
                bst.update()
            torch.cuda.synchronize()
            el = time.perf_counter() - t0
            trees = [_par_tree(t) for t in bst._gbdt.models]
            r = dict(s_per_tree=el / PAR_TREES,
                     launches={k: v for k, v in launch_counts().items() if v},
                     syncs=serial.HOST_SYNCS, calls=pmesh.CALLS,
                     coll_ms=pmesh.SECONDS * 1e3 / PAR_TREES,
                     peak=torch.cuda.max_memory_allocated(), trees=trees,
                     expected=_par_expected(
                         name, PAR_TREES,
                         sum(t["num_leaves"] - 1 for t in trees),
                         depthwise.LEVELS, depthwise.LEVEL_SPLITS))
            bst.add_valid(valid_set, "valid")
            r["auc"] = (bst.eval_train()[0][2], bst.eval_valid()[0][2])
            growth = _par_growth(extra)
            r["divergent"] = _par_same_grads(
                torch, bst._gbdt, refs["bench"][growth],
                {"feature": 1, "grid": 2}.get(name, world))
            r["exact"] = []
            for i, g in enumerate(_par_exact_grads(torch, ROWS)):
                t, lid = bst._gbdt._learner(*_par_args(torch, bst._gbdt, g))
                r["exact"].append(_par_bitwise(torch, t, lid,
                                               refs["exact"][growth][i]))
            out["learners"][name] = r
        torch.save(out, os.path.join(PAR_DIR, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
    return 0


def _par_gloo(torch):
    """(b) PAR_WORLD rank processes sharing cuda:0 over gloo, one world
    for every learner: the trees the same on every rank, bitwise the
    serial trees on the exact-sum copy, within one divergent node a tree
    of the serial learner given the world's root totals from the same
    gradients (voting5 aside), within AUC_TOL of their AUC through the
    API, and each rank's launches, host syncs and collectives exactly
    the route's for the trees it grew."""
    refs = torch.load(os.path.join(PAR_DIR, "refs.pt"))
    port = _free_port()
    logs = [open(os.path.join(PAR_DIR, f"rank{r}.log"), "w")
            for r in range(PAR_WORLD)]
    t0 = time.perf_counter()
    # gloo over the loopback device: the ranks share this host
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--parallel-rank",
         str(r), str(PAR_WORLD), str(port)], stdout=logs[r],
        stderr=subprocess.STDOUT, env=env) for r in range(PAR_WORLD)]
    try:
        for p in procs:
            p.wait(timeout=max(240 - (time.perf_counter() - t0), 1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    wall = time.perf_counter() - t0
    for r, p in enumerate(procs):
        if p.returncode != 0:
            with open(os.path.join(PAR_DIR, f"rank{r}.log")) as f:
                print(f.read()[-4000:], flush=True)
            check(False, f"phase 26 (b): rank {r} exited {p.returncode}")
    ranks = [torch.load(os.path.join(PAR_DIR, f"rank{r}.pt"))
             for r in range(PAR_WORLD)]
    ok = True
    for name, tl, extra in PAR_LEARNERS:
        rs = [rk["learners"][name] for rk in ranks]
        r0 = rs[0]
        same = all(
            all(a["num_leaves"] == b["num_leaves"]
                and all(torch.equal(a[k], b[k]) for k in TREE_FIELDS)
                for a, b in zip(r["trees"], r0["trees"]))
            and r["auc"] == r0["auc"] for r in rs)
        exact = all(all(r["exact"]) for r in rs)
        ref = refs["bench"][_par_growth(extra)]
        div = r0["divergent"]
        auc_ok = all(abs(a - b) <= AUC_TOL
                     for a, b in zip(r0["auc"], ref["auc"]))
        div_ok = _par_div_ok(div)
        counted = all((r["launches"], r["syncs"], r["calls"])
                      == r["expected"] for r in rs)
        ok &= (same and auc_ok and counted
               and (name == "voting5" or exact and div_ok))
        per = [{k: v / PAR_TREES for k, v in r["launches"].items()}
               for r in rs]
        say(f"[parallel b {name}] s/tree={r0['s_per_tree']:.4f} "
            f"(ranks {[round(r['s_per_tree'], 4) for r in rs]}); "
            f"collectives a tree {r0['calls'] / PAR_TREES:.1f} in "
            f"{r0['coll_ms']:.1f} ms; host syncs a tree "
            f"{r0['syncs'] / PAR_TREES:.1f}; launches a tree per rank "
            f"{json.dumps(per)}; launches, host syncs and collectives of "
            f"the {PAR_TREES} trees on every rank exactly the route's "
            f"{json.dumps(r0['expected'])}: {counted}; peak device memory "
            f"a rank {[r['peak'] for r in rs]}; trees the same on every "
            f"rank: {same}; exact-sum trees bitwise the serial learner's: "
            f"{exact}; from the serial run's gradients, a tree's divergent "
            f"nodes and the gain gap where they start, against the serial "
            f"learner given the world's root totals and against the serial "
            f"run's tree, and the root's Σg summed by blocks against in one "
            f"pass: {json.dumps(div)}; AUC {r0['auc'][0]:.6f}/"
            f"{r0['auc'][1]:.6f} (serial {ref['auc'][0]:.6f}/"
            f"{ref['auc'][1]:.6f})")
    say(f"[parallel b] {PAR_WORLD} gloo ranks on cuda:0, {PAR_B_LEAVES} "
        f"leaves, {wall:.1f}s (data + binning a rank "
        f"{ranks[0]['data_s']:.1f}s); a tiny all-gather of the world's "
        f"CUDA tensors {ranks[0]['latency_ms']:.3f} ms")
    check(ok, "phase 26 (b): a learner's trees differ across ranks, from "
          "the serial trees, in AUC or in launches, host syncs or "
          "collectives")


def phase_parallel(torch, lt):
    """Phase 26: the parallel learners on the card, (a) one NCCL rank in
    this process at the bench's full width, (b) PAR_WORLD gloo ranks
    sharing the card, every learner at PAR_B_LEAVES leaves."""
    params, train_set, valid_set, _ = make_bench_data(lt)
    os.makedirs(PAR_DIR, exist_ok=True)
    try:
        refs = _par_refs(torch, lt, params, train_set, valid_set,
                         ("leafwise",))
        _par_nccl(torch, lt, params, train_set, valid_set, refs)
        torch.save(_par_refs(torch, lt, dict(params,
                                             num_leaves=PAR_B_LEAVES),
                             train_set, valid_set,
                             ("leafwise", "depthwise", "hybrid")),
                   os.path.join(PAR_DIR, "refs.pt"))
        del train_set, valid_set, refs
        torch.cuda.empty_cache()
        _par_gloo(torch)
    finally:
        shutil.rmtree(PAR_DIR, ignore_errors=True)


# -------------------------------------------------------------- phase 27
MH_DIR = os.path.join(ROOT, "build", "smoke_multihost")
# (a): the gang's barriers every GANG_EVERY trees, slot 1 SIGKILLed once
# its heartbeat reaches GANG_KILL_AT (the gang rolls back to barrier 4,
# or a later one where slot 1 got further before the kill landed)
GANG_EVERY, GANG_KILL_AT = 2, 5
GANG_B_TREES = 4  # (b): trees of each shard's rank
# (c): the worlds' trees and leaves on phase 19's valid file (200k rows:
# a gloo collective of two processes sharing the card costs ms)
ML_TREES, ML_LEAVES = 4, 63
ML_SEEDS = (7, 3)  # (c) rank 0's and rank 1's bagging_seed: the sync's 3
ML_DELAY_MS = 200  # (c) rank 1's delay before every traced collective
MH_WAVE_S = 240  # a wave's deadline
# the launcher env a rank child must not inherit from this process
MH_ENV_DROP = ("LGBM_TPU_FAULT", "LGBM_TPU_GANG", "LGBM_TPU_PROCESS_ID",
               "LGBM_TPU_NUM_PROCESSES", "LGBM_TPU_COORDINATOR",
               "LGBM_TPU_RANK_OBS_DIR", "MASTER_ADDR", "MASTER_PORT",
               "RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE")


class _MhProc:
    """A ``python -m lightgbm_tpu_torch`` child on the card, its output
    written to ``<MH_DIR>/<name>.log`` with each line's seconds since the
    start."""

    def __init__(self, name, argv, **env):
        import threading

        self.name, self.lines = name, []
        self.log = os.path.join(MH_DIR, f"{name}.log")
        e = {k: v for k, v in os.environ.items()
             if not k.startswith(MH_ENV_DROP)}
        e.update(GLOO_SOCKET_IFNAME="lo", **{k: str(v)
                                             for k, v in env.items()})
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-u", "-m", "lightgbm_tpu_torch", *argv,
             "verbose=1"], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, cwd=ROOT, env=e)
        self.reader = threading.Thread(target=self._read, daemon=True)
        self.reader.start()

    def _read(self):
        with open(self.log, "w") as fh:
            for line in self.proc.stdout:
                t = time.perf_counter() - self.t0
                self.lines.append((t, line.rstrip("\n")))
                fh.write(f"{t:9.3f} {line}")
        self.s = time.perf_counter() - self.t0  # its output closed: it ended

    def wait(self, deadline):
        try:
            self.proc.wait(max(1.0, deadline - time.perf_counter()))
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
        self.reader.join(10)
        return self.proc.returncode

    def text(self):
        return "\n".join(line for _, line in self.lines)

    def first(self, needle):
        """Seconds since the start of the first line holding ``needle``."""
        return next((t for t, line in self.lines if needle in line), None)


def _mh_wait(procs, want_rc=0):
    """Wait for ``procs`` (a dict name -> _MhProc) under one deadline;
    every exit code must be ``want_rc`` (None: any but 0)."""
    deadline = time.perf_counter() + MH_WAVE_S
    for name, p in procs.items():
        rc = p.wait(deadline)
        ok = rc != 0 if want_rc is None else rc == want_rc
        check(ok, f"phase 27 {name}: exit code {rc}:\n{p.text()[-3000:]}")


def _mh_leaves(path):
    with open(path) as fh:
        return [int(v) for v in re.findall(r"^num_leaves=(\d+)$", fh.read(),
                                           re.M)]


def _mh_snap(path):
    with open(path) as fh:
        return json.load(fh)


def _mh_rank_counts(snap, want, sites):
    """A rank snapshot's launches of the ``want`` kernels (every other
    learner kernel 0), learner host syncs and census calls at ``sites``."""
    got = snap["extra"]["kernel_launches"]
    learner = ("K1", "K1'", "K1″", "K2", "K3", "K4", "K5", "K6", "K7", "K8")
    counts = {k: got.get(k, 0) for k in learner if got.get(k) or k in want}
    c = snap["telemetry"]["counters"]
    calls = {s: c.get(f"collective_site.{s}", 0) for s in sites}
    return counts, snap["extra"]["learner_host_syncs"], calls


def _mh_argv_c(files, out, *extra):
    return [f"data={files['valid']}", "objective=binary",
            f"max_bin={NUM_BINS}", f"num_leaves={ML_LEAVES}",
            f"num_trees={ML_TREES}", f"learning_rate={LEARNING_RATE}",
            f"min_data_in_leaf={MIN_DATA}", "tree_learner=data",
            "num_machines=2", "bagging_fraction=0.8", "bagging_freq=1",
            "enable_load_from_binary_file=false",
            f"output_model={os.path.join(MH_DIR, out)}", *extra]


def _mh_mlist(name):
    path = os.path.join(MH_DIR, f"{name}.mlist")
    with open(path, "w") as fh:
        fh.write(f"127.0.0.1 {_free_port()}\n127.0.0.1 {_free_port()}\n")
    return path


def _mh_world_c(files, name, extra_of, env_of):
    """Two ``task=train`` ranks of a machine-list world on 127.0.0.1
    (sharing cuda:0 over gloo), rank r with ``extra_of(r)`` argv and
    ``env_of(r)`` env."""
    ml = _mh_mlist(name)
    return {f"{name}{r}": _MhProc(
        f"{name}{r}", _mh_argv_c(files, f"{name}{r}.txt",
                                 f"machine_list_file={ml}", *extra_of(r)),
        LGBM_TPU_PROCESS_ID=r, **env_of(r)) for r in range(2)}


def _mh_gang_counts(gdir, model, trees_total):
    """Each gang rank's launches a tree against the mega route's, from its
    rank snapshot (the last incarnation's: the trees from its
    ``first_iteration``): K1' = K3 = 1, K8 = K7 = its splits."""
    leaves = _mh_leaves(model)
    out = []
    for slot in (0, 1):
        snap = _mh_snap(os.path.join(gdir, "obs", f"rank_{slot}.json"))
        first = snap["extra"]["first_iteration"]
        n = trees_total - first
        S = sum(v - 1 for v in leaves[first:])
        want = {"K1'": n, "K3": n, "K8": S, "K7": S}
        counts, syncs, _ = _mh_rank_counts(snap, want, ())
        # the rank's log holds every incarnation: s/tree of the last
        with open(os.path.join(gdir, f"r{slot}", "log.txt")) as fh:
            its = re.findall(r"([0-9.]+) seconds elapsed, finished "
                             r"iteration (\d+)", fh.read())
        out.append(dict(slot=slot, first=first, counts=counts, syncs=syncs,
                        ok=counts == want and syncs == 2 * n + S,
                        gang=snap.get("gang"),
                        s_tree=float(its[-1][0]) / n if its else math.nan))
    return out


def _mh_world_counts(obs_dir, model):
    """Each rank of a 2-rank data-parallel world on its partition (record
    route) against the route's formula plus the sentinel: K1' = K3 = n +
    S, K6 = K7 = S; 3n + 2S host syncs and one tree read a tree; 3n + 3S
    collectives of the learner and one sentinel all-gather (and its
    barrier) a tree; the config sync's one gather and one barrier and the
    fingerprint's gather."""
    leaves = _mh_leaves(model)
    n, S = len(leaves), sum(v - 1 for v in leaves)
    want = {"K1'": n + S, "K3": n + S, "K6": S, "K7": S}
    want_calls = {"dp.root_sums_allreduce.all-reduce": n,
                  "dp.hist_reduce_scatter.reduce-scatter": n + S,
                  "dp.root_split_allgather.all-gather": n,
                  "dp.child_counts_allgather.all-gather": S,
                  "dp.split_allgather.all-gather": S,
                  "desync_sentinel.all-gather": n,
                  "desync_sentinel.barrier": n,
                  "config_sync.all-gather": 1, "config_sync.barrier": 1,
                  "config_fingerprint.all-gather": 1}
    out = []
    for r in (0, 1):
        snap = _mh_snap(os.path.join(obs_dir, f"rank_{r}.json"))
        counts, syncs, calls = _mh_rank_counts(snap, want, want_calls)
        res = snap["telemetry"]["reservoirs"]
        spans = snap["telemetry"]["spans"]

        def ms(name):
            return 1e3 * res.get(name, {}).get("mean_s", 0.0)

        out.append(dict(
            rank=r, counts=counts, syncs=syncs, calls=calls,
            ok=(counts == want and syncs == 4 * n + 2 * S
                and calls == want_calls),
            sentinel_wait_ms=ms("collective.desync_sentinel.wait_s"),
            sentinel_transfer_ms=ms("collective.desync_sentinel.transfer_s"),
            tree_read_ms=1e3 * spans.get("dist.grow.fetch", {}).get(
                "total_s", 0.0) / max(1, n),
            sync_ms=ms("collective.config_sync.wait_s")
            + ms("collective.config_sync.transfer_s")
            + ms("collective.config_fingerprint.transfer_s")))
    return out, n, S


def _mh_s_per_tree(proc, trees):
    t = re.findall(r"([0-9.]+) seconds elapsed, finished iteration",
                   proc.text())
    return float(t[-1]) / trees if len(t) == trees else float("nan")


def _mh_launch_sum(snaps):
    total = {}
    for s in snaps:
        for k, v in s["extra"]["kernel_launches"].items():
            total[k] = total.get(k, 0) + v
    return total


def phase_multihost(torch, lt, files):
    """Phase 27: the training gang and machine-list worlds on the card,
    every rank a ``python -m lightgbm_tpu_torch`` child.  Wave 1: (a)
    ``task=train_fleet`` of phase 19's train.conf, 2 redundant ranks,
    barriers every GANG_EVERY trees, slot 1 SIGKILLed at GANG_KILL_AT;
    (c1) a 2-rank machine-list world on 127.0.0.1 sharing cuda:0 over
    gloo, rank 1 with another bagging_seed and ML_DELAY_MS before every
    traced collective; (c2) the same world from torchrun's env.  Wave 2:
    (b) ``gang_shard_data=true`` on the valid file; (c3) a world whose
    ranks differ in num_leaves; (c4) a world under ``desync_step:1``.
    Returns the launches of the kernels its rank children ran."""
    from lightgbm_tpu_torch import cli

    shutil.rmtree(MH_DIR, ignore_errors=True)
    os.makedirs(MH_DIR)
    conf = os.path.join(FILES_DIR, "train.conf")
    with open(os.path.join(FILES_DIR, "model-one-shot.txt")) as fh:
        one_shot = fh.read()
    t_phase = time.perf_counter()
    # ---- wave 1
    gdir_a = os.path.join(MH_DIR, "gang_a")
    wave = {"a": _MhProc("a", [
        f"config={conf}", "task=train_fleet",
        "enable_load_from_binary_file=false", "train_ranks=2",
        f"gang_barrier_every={GANG_EVERY}", f"gang_dir={gdir_a}",
        f"output_model={os.path.join(MH_DIR, 'gang_a.txt')}"],
        LGBM_TPU_GANG_CHAOS_KILL=f"1:{GANG_KILL_AT}")}
    wave.update(_mh_world_c(
        files, "ml", lambda r: [f"bagging_seed={ML_SEEDS[r]}"],
        lambda r: dict(
            LGBM_TPU_RANK_OBS_DIR=os.path.join(MH_DIR, "ml_obs"),
            **({"LGBM_TPU_FAULT": f"delay_collective:1:{ML_DELAY_MS}"}
               if r else {}))))
    port = _free_port()
    for r in range(2):
        wave[f"tr{r}"] = _MhProc(
            f"tr{r}", _mh_argv_c(files, f"tr{r}.txt",
                                 f"bagging_seed={min(ML_SEEDS)}"),
            RANK=r, LOCAL_RANK=r, WORLD_SIZE=2, LOCAL_WORLD_SIZE=2,
            MASTER_ADDR="127.0.0.1", MASTER_PORT=port,
            LGBM_TPU_RANK_OBS_DIR=os.path.join(MH_DIR, "tr_obs"))
    _mh_wait(wave)
    wave1_s = time.perf_counter() - t_phase

    # (a) the gang: rank 0's model bitwise phase 19's one-shot train
    with open(os.path.join(MH_DIR, "gang_a.txt")) as fh:
        gang_model = fh.read()
    with open(os.path.join(gdir_a, "r1", "model.txt")) as fh:
        slot1_model = fh.read()
    art = _mh_snap(os.path.join(gdir_a, "train_fleet.json"))
    tf = art["train_fleet"]
    rec = tf["recovery_timeline"]
    gang = _mh_gang_counts(gdir_a, os.path.join(MH_DIR, "gang_a.txt"), TREES)
    sup = wave["a"]
    formed = [t for t, line in sup.lines if "gang: formed with" in line]
    say(f"[multihost a] train_fleet of {TREES} trees, 2 ranks, barrier "
        f"every {GANG_EVERY}, slot 1 killed at {GANG_KILL_AT}: exit 0 in "
        f"{sup.s:.2f}s; rank 0's model bitwise phase 19's task=train: "
        f"{gang_model == one_shot}, slot 1's too: {slot1_model == one_shot}; "
        f"failed_iterations {tf['failed_iterations']}, restarts "
        f"{tf['restarts']}, rank_deaths {tf['rank_deaths']}, mttr_s "
        f"{tf['mttr_s']}, lost_iterations {tf['lost_iterations']}, final "
        f"barrier {tf['final_barrier']}, wall_s {tf['wall_s']}; the gang "
        f"formed (ready) at {[round(t, 3) for t in formed]}s; recoveries "
        f"{json.dumps(rec)}; counters {json.dumps(art['counters'])}")
    for g in gang:
        say(f"[multihost a slot {g['slot']}] from iteration {g['first']}: "
            f"s/tree={g['s_tree']:.4f} (the valid AUC each round, the "
            f"other rank on the card beside it), launches "
            f"{json.dumps(g['counts'])}, learner host syncs "
            f"{g['syncs']} (the mega route's, exact: {g['ok']}); gang "
            f"stamp {json.dumps(g['gang'])}")
    check(gang_model == one_shot and slot1_model == one_shot,
          "phase 27 (a): the gang's model differs from task=train's")
    check(tf["failed_iterations"] == 0 and tf["restarts"] == 1
          and tf["rank_deaths"] == 1 and tf["exit_code"] == 0
          and len(rec) == 1 and rec[0]["barrier"] >= GANG_KILL_AT - 1,
          f"phase 27 (a): the recovery {json.dumps(tf)}")
    check(all(g["ok"] for g in gang), "phase 27 (a): a gang rank's "
          "launches or host syncs differ from the mega route's")

    # (c1), (c2): one model on every rank of both worlds
    models = {}
    for name in ("ml0", "ml1", "tr0", "tr1"):
        with open(os.path.join(MH_DIR, f"{name}.txt")) as fh:
            models[name] = fh.read()
    man = _mh_snap(os.path.join(MH_DIR, "ml0.txt.manifest.json"))
    strag = {s["site"]: s for s in man["extra"]["distributed"]["stragglers"]}
    ml, n, S = _mh_world_counts(os.path.join(MH_DIR, "ml_obs"),
                                os.path.join(MH_DIR, "ml0.txt"))
    tr, _, _ = _mh_world_counts(os.path.join(MH_DIR, "tr_obs"),
                                os.path.join(MH_DIR, "tr0.txt"))
    same = len(set(models.values())) == 1
    backend = all("backend=gloo on cuda:0" in wave[f"ml{r}"].text()
                  for r in range(2))
    for world, ranks in (("c1 machine list", ml), ("c2 torchrun env", tr)):
        for r in ranks:
            p = wave[("ml" if world.startswith("c1") else "tr") + str(r["rank"])]
            say(f"[multihost {world} rank {r['rank']}] s/tree="
                f"{_mh_s_per_tree(p, ML_TREES):.4f} ({n} trees, {S} splits, "
                f"{ML_LEAVES} leaves, 200k rows over 2 ranks); launches "
                f"{json.dumps(r['counts'])}, learner host syncs {r['syncs']}, "
                f"census {json.dumps(r['calls'])} (the route's formula plus "
                f"one sentinel check a tree, exact: {r['ok']}); sentinel wait "
                f"{r['sentinel_wait_ms']:.3f} ms + transfer "
                f"{r['sentinel_transfer_ms']:.3f} ms a tree, tree read "
                f"{r['tree_read_ms']:.3f} ms; config sync "
                f"{r['sync_ms']:.3f} ms; process {p.s:.2f}s")
    say(f"[multihost c1] every rank of both worlds wrote one model: {same}; "
        f"machine-list ranks on gloo on cuda:0: {backend}; rank 0's merged "
        f"manifest: ranks {[x['process_index'] for x in man['ranks']]}, "
        f"stragglers {json.dumps(list(strag.values()))}")
    check(same, "phase 27 (c): the worlds' models differ")
    check(backend, "phase 27 (c): a machine-list rank is not on gloo on "
          "cuda:0")
    check(all(r["ok"] for r in ml + tr), "phase 27 (c): a rank's launches, "
          "host syncs or collectives differ from the route's")
    check(strag.get("desync_sentinel", {}).get("straggler_rank") == 1
          and strag.get("config_sync", {}).get("straggler_rank") == 1,
          f"phase 27 (c1): the straggler is not rank 1: {strag}")

    # ---- wave 2
    t2 = time.perf_counter()
    gdir_b = os.path.join(MH_DIR, "gang_b")
    wave = {"b": _MhProc("b", [
        f"config={conf}", "task=train_fleet", f"data={files['valid']}",
        "valid_data=", f"num_trees={GANG_B_TREES}", "gang_shard_data=true",
        "enable_load_from_binary_file=false", "train_ranks=2",
        f"gang_barrier_every={GANG_EVERY}", f"gang_dir={gdir_b}",
        f"output_model={os.path.join(MH_DIR, 'gang_b.txt')}"])}
    wave.update(_mh_world_c(
        files, "cfg", lambda r: [f"num_leaves={(ML_LEAVES, 31)[r]}"],
        lambda r: {}))
    wave.update(_mh_world_c(files, "ds", lambda r: [],
                            lambda r: {"LGBM_TPU_FAULT": "desync_step:1"}))
    _mh_wait({k: v for k, v in wave.items() if k.startswith("b")})
    plain = []
    for slot in (0, 1):
        out = os.path.join(MH_DIR, f"plain_r{slot}.txt")
        _run_cli(torch, cli, [
            f"config={conf}", f"data={os.path.join(gdir_b, f'shard_r{slot}.csv')}",
            "valid_data=", f"num_trees={GANG_B_TREES}",
            "enable_load_from_binary_file=false", f"output_model={out}"])
        with open(out) as fh, open(os.path.join(gdir_b, f"r{slot}",
                                                "model.txt")) as gh:
            plain.append(fh.read() == gh.read())
    _mh_wait({k: v for k, v in wave.items() if not k.startswith("b")},
             want_rc=None)
    art_b = _mh_snap(os.path.join(gdir_b, "train_fleet.json"))
    mismatch = all("differs across processes" in wave[f"cfg{r}"].text()
                   and not os.path.exists(os.path.join(MH_DIR, f"cfg{r}.txt"))
                   for r in range(2))
    named = all("cross-rank desync at iteration 1: rank(s) [1]"
                in wave[f"ds{r}"].text() for r in range(2))
    say(f"[multihost b] sharded gang of {GANG_B_TREES} trees on the valid "
        f"file: exit 0 in {wave['b'].s:.2f}s; parity checks "
        f"{art_b['counters'].get('lgbm_gang_parity_checks', 0)}; each "
        f"slot's model bitwise task=train of its shard: {plain}")
    say(f"[multihost c3] ranks with num_leaves {ML_LEAVES} and 31: both "
        f"exited non-zero at the config sync ({wave['cfg0'].s:.2f}s, "
        f"{wave['cfg1'].s:.2f}s), naming the fingerprints: {mismatch}")
    say(f"[multihost c4] desync_step:1: both ranks stopped with a "
        f"DesyncError naming rank 1 at iteration 1: {named} "
        f"({wave['ds0'].s:.2f}s, {wave['ds1'].s:.2f}s)")
    check(art_b["counters"].get("lgbm_gang_parity_checks", 0) >= 1
          and all(plain), "phase 27 (b): the sharded gang's models or "
          "parity check")
    check(mismatch, "phase 27 (c3): the config mismatch was not refused")
    check(named, "phase 27 (c4): the desync was not named")
    say(f"[multihost] wave 1 {wave1_s:.2f}s, wave 2 "
        f"{time.perf_counter() - t2:.2f}s")
    snaps = [_mh_snap(os.path.join(d, f"rank_{r}.json")) for r in (0, 1)
             for d in (os.path.join(gdir_a, "obs"), os.path.join(gdir_b, "obs"),
                       os.path.join(MH_DIR, "ml_obs"),
                       os.path.join(MH_DIR, "tr_obs"))]
    shutil.rmtree(MH_DIR, ignore_errors=True)
    return _mh_launch_sum(snaps)


# -------------------------------------------------------------- phase 28
OBS_TREES = 3  # trees traced on the mega route, and of the profiled CLI run
OBS_DIR = os.path.join(ROOT, "build", "smoke_obs")
# the runs whose measured peak the memory model must meet within
# max(20 %, 8 KiB); the others' ratios are printed
MEM_HELD = ("mega", "record", "order", "f64-leafwise", "forest d")
GROW_PHASES = ("histogram", "partition", "split-search")


def _kernel_name(name: str) -> str:
    """A demangled kernel signature's function name."""
    head = re.sub(r"<.*", "", name.split("(")[0]).replace("void ", "")
    return head.strip().split("::")[-1] or name


def _kernel_sums(events, trees):
    """Per-kernel device ms a tree and launches a tree of a trace, the
    largest first (profile_slice's ``kernel_ms_per_tree``)."""
    from lightgbm_tpu_torch.obs import device_time as dt

    sums = {}
    for ev in events:
        if ev.get("ph") == "X" and ev.get("cat") == "kernel":
            k = _kernel_name(str(ev.get("name", "")))
            ms, n = sums.get(k, (0.0, 0))
            sums[k] = (ms + float(ev["dur"]) / 1e3, n + 1)
    return [(k, round(ms / trees, 4), n / trees,
             dt.classify_event(k) or "unattributed")
            for k, (ms, n) in sorted(sums.items(), key=lambda kv: -kv[1][0])]


def _obs_oom(torch, booster, mm):
    """``oom_dispatch`` at ``train_one_iter`` on the card: a flight-recorder
    dump whose tail is ``oom`` with the census (a ``dataset`` owner) and
    the memory model's prediction for the booster's shape, ``oom.train``
    up by one, and the next iteration trains."""
    from lightgbm_tpu_torch.obs import flightrec, memmodel, telemetry
    from lightgbm_tpu_torch.resilience import faults

    dump_dir = os.path.join(OBS_DIR, "flightrec")
    os.makedirs(dump_dir, exist_ok=True)
    tel = telemetry.get_telemetry()
    before = tel.counter("oom.train")
    flightrec.set_dump_dir(dump_dir)
    flightrec.reset()
    faults.set_fault("oom_dispatch")
    try:
        booster.update()
        raised = False
    except faults.InjectedResourceExhausted:
        raised = True
    finally:
        faults.clear_faults()
        flightrec.set_dump_dir(None)
    dumps = sorted(f for f in os.listdir(dump_dir) if f.endswith(".json"))
    check(raised and dumps, "obs: oom_dispatch at training left no dump")
    with open(os.path.join(dump_dir, dumps[0])) as fh:
        tail = json.load(fh)["events"][-1]
    pred = memmodel.predict(**mm)
    by_owner = tail["census"]["by_owner"]
    say(f"[obs oom] tail kind={tail['kind']} where={tail['where']} "
        f"census by_owner={json.dumps(by_owner)} predicted_peak_bytes="
        f"{tail['predicted_peak_bytes']} hbm_bytes_in_use="
        f"{tail['hbm']['hbm_bytes_in_use']} oom.train "
        f"{before} -> {tel.counter('oom.train')}")
    check(tail["kind"] == "oom" and "dataset" in by_owner
          and tail["predicted_peak_bytes"] == pred["peak_bytes"]
          and tel.counter("oom.train") == before + 1,
          "obs: the training OOM post-mortem lacks its census, prediction "
          "or count")
    trees = booster.num_trees()
    booster.update()
    check(booster.num_trees() == trees + 1,
          "obs: training did not go on after the injected OOM")


def phase_obs(torch, lt, params, train_set, peaks):
    """Phase 28 (a) and (c): ``trace_phases`` around OBS_TREES trees of
    a mega booster at the bench width (its launches and host syncs
    exactly the route's), the buckets beside per-kernel sums, >= 90 % of
    the kernel time in named phases and the buckets summing to the
    trace's device time within 1 %; the injected training OOM; the census
    against the memory model; each earlier run's measured peak against
    the model's largest training phase (``peaks``: run -> (peak bytes,
    the booster's ``_memmodel_params``))."""
    from lightgbm_tpu_torch.learners import serial
    from lightgbm_tpu_torch.obs import device_time as dt
    from lightgbm_tpu_torch.obs import memmodel, memory
    from lightgbm_tpu_torch.ops import launch_counts

    shutil.rmtree(OBS_DIR, ignore_errors=True)
    # ---- (a) the trace's buckets on the default route
    with route_env("mega"):
        booster = lt.Booster(params=params, train_set=train_set)
        booster.update()  # a warm tree outside the trace
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        with dt.trace_phases(OBS_DIR) as traced:
            for _ in range(OBS_TREES):
                booster.update()
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts, syncs = launch_counts(), serial.HOST_SYNCS
        mm = booster._gbdt._memmodel_params()
    trees = booster._gbdt.models[1:]
    splits = sum(t.num_leaves - 1 for t in trees)
    want = dict.fromkeys(counts, 0)
    want.update({"K1'": OBS_TREES, "K3": OBS_TREES, "K8": splits,
                 "K7": splits})
    check(counts == want and syncs == 2 * OBS_TREES + splits,
          f"obs: the traced trees' launches {counts} / {syncs} host syncs "
          f"are not the mega route's {want} / {2 * OBS_TREES + splits}")
    check(traced.path is not None, "obs: no trace was written")
    t0 = time.perf_counter()
    events = dt.load_trace_events(traced.path)
    dev_s = dt.device_seconds(events)
    kern_s = dt.device_seconds(events, ("kernel",))
    kern = dt.bucket_events(events, cats=("kernel",))
    named = sum(v for k, v in kern.items() if k != "unattributed")
    total = sum(traced.phases.values())
    read_s = time.perf_counter() - t0
    say(f"[obs a] {OBS_TREES} mega trees traced in {wall:.3f}s "
        f"({splits} splits; launches and host syncs the route's), trace "
        f"{os.path.getsize(traced.path)} bytes, {len(events)} events, "
        f"read and bucketed in {read_s:.3f}s; device ms a tree "
        f"{dev_s * 1e3 / OBS_TREES:.4f}, kernels {kern_s * 1e3 / OBS_TREES:.4f}"
        f"; buckets ms a tree " + " ".join(
            f"{k}={v * 1e3 / OBS_TREES:.4f}"
            for k, v in sorted(traced.phases.items())) +
        f"; kernel time in named phases {named / max(kern_s, 1e-12):.4f}")
    for k, ms, n, phase in _kernel_sums(events, OBS_TREES)[:10]:
        say(f"[obs a kernel] {k}: {ms:.4f} ms a tree, {n:.1f} launches a "
            f"tree -> {phase}")
    check(kern_s > 0 and named >= 0.9 * kern_s,
          f"obs: {named:.6f}s of {kern_s:.6f}s kernel time in named phases")
    check(abs(total - dev_s) <= 0.01 * dev_s,
          f"obs: the buckets sum to {total:.6f}s, the trace's device time "
          f"is {dev_s:.6f}s")
    check(all(traced.phases.get(p, 0) > 0 for p in GROW_PHASES),
          f"obs: a grow phase has no device time: {traced.phases}")

    # ---- the injected OOM at training, and the census against the model
    _obs_oom(torch, booster, mm)
    gc.collect()
    census = memory.live_buffer_census()["by_owner"]
    comp = memmodel.predict(**mm)["components"]
    got_ds = census.get("dataset", {}).get("bytes", 0)
    got_sc = census.get("scores", {}).get("bytes", 0)
    model_sc = comp["scores"] + comp["bag_mask"]
    say(f"[obs census] dataset {got_ds} bytes (model {comp['dataset']}, "
        f"ratio {comp['dataset'] / max(got_ds, 1):.4f}); scores + bag "
        f"{got_sc} (model {model_sc}, ratio {model_sc / max(got_sc, 1):.4f})"
        f"; by_owner={json.dumps(census)}")
    check(memmodel.within_tolerance(comp["dataset"], got_ds)
          and memmodel.within_tolerance(model_sc, got_sc),
          "obs: the census's dataset / scores owners are outside "
          "max(20 %, 8 KiB) of the model")
    del booster, traced, events

    # ---- (c) each run's measured peak against the model
    off = []
    for run, (peak, params_mm) in peaks.items():
        pred = memmodel.predict(**params_mm)
        phase, bytes_ = memmodel.training_peak(pred)
        limiter = memmodel.limiting_component(pred)
        held = run in MEM_HELD
        ok = memmodel.within_tolerance(bytes_, peak)
        say(f"[obs memory] {run}: predicted {bytes_} bytes ({phase}; "
            f"routing={params_mm['routing']} growth={params_mm['growth']} "
            f"pool_slots={params_mm['pool_slots']} forest_batch="
            f"{params_mm.get('forest_batch', 1)}) measured {peak} ratio "
            f"{bytes_ / peak:.4f}; largest component {limiter[0]} "
            f"{limiter[1]}; {'held' if held else 'printed'}"
            f"{'' if ok else ' (outside 20 %)'}")
        if held and not ok:
            off.append(run)
    check(not off, f"obs: the memory model is outside 20 % of {off}")


def phase_obs_cli(torch, files):
    """Phase 28 (b): one ``task=train profile=true`` CLI run on phase 19's
    train.conf (OBS_TREES trees, no valid file): its manifest's
    ``phases`` (the trace this run wrote) has positive histogram,
    partition and split-search seconds, its ``per_tree`` the dispatch
    reservoir."""
    from lightgbm_tpu_torch import cli

    conf = os.path.join(FILES_DIR, "train.conf")
    check(os.path.exists(conf) and os.path.exists(files["train"]),
          "obs cli: phase 19's files are gone")
    prof = os.path.join(OBS_DIR, "prof")
    out = os.path.join(OBS_DIR, "model-profiled.txt")
    t0 = time.perf_counter()
    load_s, train_s = _run_cli(torch, cli, [
        f"config={conf}", f"output_model={out}", f"num_trees={OBS_TREES}",
        "valid_data=", "profile=true", f"profile_dir={prof}"])
    wall = time.perf_counter() - t0
    with open(out + ".manifest.json") as fh:
        man = json.load(fh)
    phases, per_tree = man["phases"], man["per_tree"]
    traces = sorted(os.listdir(prof))
    say(f"[obs b] task=train profile=true, {OBS_TREES} trees: wall "
        f"{wall:.3f}s load_s={load_s:.3f} train_s={train_s:.3f} (profiled)"
        f"; trace files {traces}; manifest phases (device s) "
        f"{json.dumps(phases, sort_keys=True)}; per_tree "
        f"{json.dumps(per_tree, sort_keys=True)}")
    check(all(phases.get(p, 0) > 0 for p in GROW_PHASES),
          f"obs cli: the manifest's phases lack a grow phase: {phases}")
    check(per_tree.get("count", 0) >= OBS_TREES,
          f"obs cli: per_tree {per_tree}")
    shutil.rmtree(OBS_DIR, ignore_errors=True)


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "lightgbm_tpu_torch")):
        print("chip_smoke: run from a checkout: lightgbm_tpu_torch/ is not "
              "beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    if "--p2-trace" in sys.argv:  # phase 21's trace in a fresh process
        return _p2_trace_child(torch, sys.argv[sys.argv.index("--p2-trace")
                                                + 1])
    if "--parallel-rank" in sys.argv:  # one of phase 26 (b)'s ranks
        i = sys.argv.index("--parallel-rank")
        return _par_rank_child(torch, *map(int, sys.argv[i + 1:i + 4]))
    import lightgbm_tpu_torch as lt

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = timed("build", phase_build, torch)
    hist = timed("histogram", phase_histogram, torch)
    search = timed("search", phase_search, torch)
    hist_rec = timed("record_histogram", phase_record_histogram, torch)
    update = timed("search_update", phase_search_update, torch)
    compact, place = timed("partition", phase_partition, torch)
    step = timed("split_step", phase_split_step, torch)
    data = timed("bench_data", make_bench_data, lt)
    level, level_bsub = timed("level_histogram", phase_level_histogram,
                              torch, data[1])
    pool_search = timed("pool_search", phase_pool_search, torch)
    writeback = timed("writeback", phase_writeback, torch)
    routes = {r: timed(f"main_{r}", phase_main_path, torch, lt, r, *data)
              for r in ("mega", "record", "order", "pooled", "depthwise",
                        "depthwise-bsub", "hybrid")}
    for r, m in routes.items():
        say(f"[main {r}] s/tree={m['s_per_tree']:.4f} "
            f"auc={m['auc'][0]:.6f}/{m['auc'][1]:.6f} "
            f"host_syncs_per_tree={m['syncs_per_tree']:.1f} "
            f"peak_mem_bytes={m['peak']}")
    main_rec, main_ord = routes["record"], routes["order"]
    check(main_rec["auc"] == main_ord["auc"],
          f"the two routes' AUCs differ: {main_rec['auc']} vs "
          f"{main_ord['auc']}")
    main_dw, main_bsub = routes["depthwise"], routes["depthwise-bsub"]
    check(main_dw["auc"] == main_bsub["auc"]
          and main_dw["leaves"] == main_bsub["leaves"],
          f"depthwise under bsub and v1 differ: {main_bsub['auc']} vs "
          f"{main_dw['auc']}")
    api = timed("api", phase_api, torch, lt, *data)
    forest_k = timed("forest_kernels", phase_forest_kernels, torch)
    forest_main = timed("forest", phase_forest, torch, lt, data[0], data[1],
                        api.pop("cv_run"))
    dart = timed("dart", phase_dart, torch, lt, *data,
                 routes["mega"]["s_per_tree"])
    f64, _, f64_runs = timed("f64", phase_f64, torch, lt, *data,
                             routes["order"])
    peaks = {r: (m["peak"], m["mm"]) for r, m in routes.items()}
    peaks.update({r: (m["peak"], m["mm"]) for r, m in f64_runs.items()})
    for tag, rec in (("forest b lanes", forest_main["b"][0]),
                     ("forest d", forest_main["d"][0])):
        peaks[tag] = (rec["peak"], rec["mm"])
    timed("obs", phase_obs, torch, lt, *data[:2], peaks)
    del f64_runs
    params, train_set, valid_set, Xv = data
    reset_counts()
    served, one_call, p1 = timed("predict", phase_predict, torch, lt, params,
                                 train_set, valid_set, Xv)
    serve = timed("serving", phase_serving, torch, lt, served, params,
                  train_set, Xv)
    del data, served, train_set, valid_set
    timed("trees", phase_trees, torch, lt)
    timed("wide", phase_wide, torch, lt)
    for kind in ("regression", "multiclass", "lambdarank"):
        timed(kind, phase_objective, torch, lt, card, kind)
    timed("multiclass_300k", phase_objective, torch, lt, card, "multiclass",
          rows=MULTICLASS_BAND_ROWS)
    files = timed("files", phase_files, torch, lt, params, routes["mega"])
    timed("forest_cli", phase_forest_cli, torch, lt, files)
    timed("resilience", phase_resilience, torch, lt, files)
    mh_n = timed("multihost", phase_multihost, torch, lt, files)
    timed("obs_cli", phase_obs_cli, torch, files)
    timed("capi", phase_capi, torch, lt, params, routes["mega"], files)
    del files
    sparse, s1_launches = timed("sparse", phase_sparse, torch, lt)
    timed("parallel", phase_parallel, torch, lt)
    p1_launches = one_call + serve["launches"]  # one predict + served
    p1["max_abs_err"] = max(p1["max_abs_err"], serve["max_abs_err"])
    say(f"[phase seconds] {json.dumps(PHASE_S)}")
    say(f"[done] all phases passed in {time.perf_counter() - t_start:.1f}s "
        f"on {card}")
    src = "lightgbm_tpu_torch/csrc/"
    rec_n, ord_n = main_rec["counts"], main_ord["counts"]
    mega_n = routes["mega"]["counts"]
    pool_n = routes["pooled"]["counts"]
    kernels = [
        dict(name="histogram_single_leaf", route="cuda",
             source=src + "histogram.cu",
             replaces="lightgbm_tpu/ops/pallas_histogram.py:193",
             path="order", launches=ord_n["K1"], bound_by="bytes", **hist),
        dict(name="search2", route="cuda", source=src + "search.cu",
             replaces="lightgbm_tpu/ops/pallas_search.py:264",
             path="order", launches=ord_n["K3"], bound_by="bytes", **search),
        dict(name="histogram_record_window", route="cuda",
             source=src + "histogram.cu",
             replaces="lightgbm_tpu/ops/pallas_histogram.py:193",
             path="record", launches=rec_n["K1'"], bound_by="bytes",
             **hist_rec),
        dict(name="search2_update", route="cuda", source=src + "search.cu",
             replaces="lightgbm_tpu/ops/pallas_search.py:409",
             path="record", launches=rec_n["K4"], bound_by="bytes", **update),
        dict(name="record_compact", route="cuda", source=src + "record.cu",
             replaces="lightgbm_tpu/ops/record.py:1205", path="record",
             launches=rec_n["K6"], bound_by="bytes", **compact),
        dict(name="record_place", route="cuda", source=src + "record.cu",
             replaces="lightgbm_tpu/ops/record.py:977", path="record",
             launches=rec_n["K7"], bound_by="bytes", **place),
        dict(name="split_step", route="cuda", source=src + "split_step.cu",
             replaces="lightgbm_tpu/ops/record.py:1112", path="mega",
             launches=mega_n["K8"], bound_by="bytes", **step),
        dict(name="histogram_by_leaf_sorted", route="cuda",
             source=src + "level_histogram.cu",
             replaces="lightgbm_tpu/ops/pallas_histogram.py:193",
             path="depthwise", launches=main_dw["counts"][K1PP],
             bound_by="bytes", **level),
        dict(name="histogram_by_leaf_sorted_bsub", route="cuda",
             source=src + "level_histogram.cu",
             replaces="lightgbm_tpu/ops/pallas_histogram.py:220",
             path="depthwise-bsub", launches=main_bsub["counts"]["K2"],
             bound_by="bytes", **level_bsub),
        dict(name="search2_pool", route="cuda", source=src + "search.cu",
             replaces="lightgbm_tpu/ops/pallas_search.py:455",
             path="pooled", launches=pool_n["K5"], bound_by="bytes",
             **pool_search),
        dict(name="write_window", route="cuda", source=src + "record.cu",
             replaces="lightgbm_tpu/ops/record.py:655", path="writeback",
             bound_by="bytes", **writeback),
        # no pallas_call: the JAX package predicts in jnp (the stacked
        # walk, models/tree.py:192-228; ops/predict_matmul.py:153 on TPU)
        dict(name="ensemble_predict", route="cuda",
             source=src + "predict.cu",
             replaces="lightgbm_tpu/models/tree.py:192", path="predict+serve",
             launches=p1_launches, **p1),
        # no pallas_call: the JAX package's CSR level histogram is a jnp
        # segment_sum (ops/sparse_hist.py:45); S1 is its kernels below
        dict(name="sparse_histogram_by_leaf", route="cuda",
             source=src + "sparse_histogram.cu",
             replaces="lightgbm_tpu/ops/sparse_hist.py:45",
             path="sparse-depthwise", launches=s1_launches,
             bound_by="bytes",
             entry_points=["s1_rows_kernel", "s1_leaf_total_kernel",
                           "s1_stored_kernel", "s1_fold_kernel"], **sparse),
        # no pallas_call: the JAX package walks binned rows in jnp
        # (predict_binned, ensemble_sum_binned: models/tree.py:114, :211);
        # its time and bound at one tree over the 1M training rows
        dict(name="ensemble_walk_binned", route="cuda",
             source=src + "predict_binned.cu",
             replaces="lightgbm_tpu/models/tree.py:114", path="dart",
             bound_by="bytes", launches=dart["launches"],
             **{k: dart[k] for k in ("max_abs_err", "ms", "plain_ms",
                                     "bound_ms", "library_ms")}),
        # no pallas_call: under hist_dtype=float64 the JAX package sums
        # with jnp segment_sum and searches with jnp (ops/histogram.py:29,
        # :49; ops/split.py:69); K1-f64, K1''-f64 and K3-f64 replace them
        dict(name="histogram_single_leaf_f64", route="cuda",
             source=src + "histogram.cu",
             replaces="lightgbm_tpu/ops/histogram.py:29", path="f64-leafwise",
             bound_by="bytes", **f64["K1-f64"]),
        dict(name="histogram_by_leaf_sorted_f64", route="cuda",
             source=src + "level_histogram.cu",
             replaces="lightgbm_tpu/ops/histogram.py:49",
             path="f64-depthwise", bound_by="bytes", **f64["K1″-f64"]),
        dict(name="search2_f64", route="cuda", source=src + "search.cu",
             replaces="lightgbm_tpu/ops/split.py:69", path="f64-leafwise",
             bound_by="bytes", **f64["K3-f64"]),
        # no pallas_call: the JAX package's forest lanes are jnp vmaps
        # (learners/forest.py:123 _batched_hist, :112-121 the searches);
        # times at train_many's shape (8 lanes, 2,048 rows, F = 28): F1's
        # root form beside index_add_, F3's step form (a round's 30 of 31)
        dict(name="forest_histogram", route="cuda",
             source=src + "forest.cu",
             replaces="lightgbm_tpu/learners/forest.py:123",
             path="forest", launches=forest_main["launches"]["F1"],
             bound_by="bytes", **forest_k["b8-n2048"]),
        dict(name="forest_search", route="cuda", source=src + "forest.cu",
             replaces="lightgbm_tpu/learners/forest.py:112",
             path="forest", launches=forest_main["launches"]["F3"],
             bound_by="bytes", **forest_k["F3 step b8-n2048"]),
    ]
    # the launches of phase 27's rank children (the gang's and the worlds'
    # ranks, read from their rank snapshots)
    mh_codes = {"histogram_record_window": "K1'", "search2": "K3",
                "record_compact": "K6", "record_place": "K7",
                "split_step": "K8"}
    for k in kernels:
        if k["name"] in mh_codes:
            k["multihost_launches"] = mh_n.get(mh_codes[k["name"]], 0)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
