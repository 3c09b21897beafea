"""Smoke run of lightgbm_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line).  Where a
phase holds device scores against Booster.predict(raw_score=True), that
call is the host f64 walk of every tree (LIGHTGBM_TPU_DEVICE_PREDICT=0,
`host_walk`), a reference independent of the device predictors:

1. build   — compile every CUDA kernel of lightgbm_tpu_torch/csrc/ (one
             nvcc per source, in parallel) and print the seconds taken.
2. kernels — each dense-store kernel against its plain PyTorch version on
             the card, on seeded inputs at the main path's shapes: K1
             (int8 histogram) on a gathered pass (84 slot runs given by
             their bounds in the scratch, three empty), read from the
             row-major byte copy built from the int32 and from the int8
             store and from both [F, N] stores, bitwise equal to its
             plain version over the runs' bounds and to the masked-feed
             one, and bitwise from run to run; K1 on a tree's root pass
             (masked feed, one slot, every row), bitwise the same way; K2
             (float32 histogram, one owner thread a cell) on the same
             gathered pass from the byte copy and both [F, N] stores,
             within K2_ATOL of both plain versions and bitwise from run to
             run, and on the root pass with dyadic values, bitwise; K3
             (lookup fused with the score add, and one level of the
             valid-set walk, bitwise), K4 (row partition, bitwise and
             from run to run, over each of its feeds: the int8 [F, N]
             store the learner passes, the row-major byte copy and the
             int32 store, each timed, with the bytes of the 32-byte
             sectors its gathers touch); median times of kernel, plain
             version and, where one exists, a single PyTorch call
             computing the same function (library_ms; K3 has none — one
             index_select, which neither adds into the score nor zeroes
             out-of-range ids, is printed as a note).  The {"kernels"}
             line reports the gathered pass for K1/K2 and the score add
             for K3; the other shapes are printed on their own lines.
             Last the split search (csrc/split.cu) against its plain
             version on exact-sum histograms, bit for bit and twice the
             same bits: both children of a chunk of the rounds learner
             (k=84, F=28, B=256, the can-split gate on) written into a
             per-leaf table, and a root (k=1); timed, its row in the
             {"kernels"} line (the chunk).
3. main    — lightgbm_tpu_torch.train on synth_higgs(2_000_000) x 28
             (255 leaves, max_bin 255, int8 histograms, a 200k-row valid
             set scored with AUC each iteration; 2 warm-up and 10 timed
             iterations of one train, timed by the host clock between
             device synchronisations at the end of iteration 2 and of
             iteration 12, from a training callback), then
             Booster.predict; launch counts are
             zeroed before and read after, and every kernel of the path
             must have launched.  The float32-histogram path is driven
             the same way (2 warm-up, 10 timed; K2 must launch and the
             valid AUC exceed 0.75).  Then one tree of each replayed: a
             one-tree train with K1's (int8) or K2's (float32) wrapper
             recording each call's inputs, every call then held against
             its plain version (K1 bitwise, K2 within n * 2^-23 * sum|x|
             a cell) and run twice bitwise, timed, and given its bound;
             the per-tree sums are printed.  The same for every K4 call
             of the int8 tree (bitwise against its plain version, two
             runs bitwise), timed on the learner's feed and, by graph, on
             the other feeds of the store.
4. ctr set-up — synth_ctr(500_000) x 50,000 hashed-count features at
             density 0.01 (scipy CSR, 20-row queries) through
             lightgbm_tpu_torch.Dataset with CTR_PARAMS (sparse_store=csr):
             host seconds of the binning and of the ELL store build; a
             valid set synth_ctr(4_080, seed=7) given as a dense ndarray,
             sparsified against its reference; then the column-sorted
             entry streams that K7/K8 read, built on the card from the ELL
             arrays as the rounds learner builds them: seconds, bytes and
             the build's peak device memory.
5. sparse kernels — K7 (int8) and K8 (float32) against their plain
             version (hist_streams_plain: index_add_ of the stream entries,
             the zero bins, the dequantize) on the ctr store itself (N=500k
             rows, K=31 slots, Cp=its columns, B=128), both given the same
             slot totals: K7 bitwise, K8 bitwise on dyadic gradients and
             on real ones within n * 2^-23 * sum|x| in every cell (n f32
             additions in any order lie within n * 2^-24 * sum|x| of the
             exact sum, and the plain version's index_add_ reorders too; a
             stored cell counts its entries, a zero bin the slot's rows);
             K7 also through the whole hist_sparse_multileaf pass against
             hist_sparse_xla over the ELL arrays, bitwise; times of
             kernel, plain version and one index_add_ over the flattened
             (slot, column, channel, bin) indices of the stored entries.
             The slot-totals kernels of each pass (the zero-bin anchors;
             csrc/hist_sparse.cu) against their plain version: int32
             bitwise, float32 within n * 2^-23 * sum|x| a total; timed
             beside one index_add_, their row in the {"kernels"} line.
             Then K7 at K=84, B=256 the same way (alone and through the
             whole pass, bitwise), once at the module's shared-memory
             budget and block length and once with slot tiles and
             long-column chunks forced.  Then the learner's own passes:
             one tree per dtype on the ctr store with the kernel's wrapper
             recording each pass's inputs, and each recorded pass checked
             (as above) and timed, with its bound.
6. ctr main — lightgbm_tpu_torch.train with CTR_PARAMS on the phase-4
             datasets, float32 then int8 histograms (2 warm-up and 10
             timed iterations each, timed as in phase 3), NDCG@1..5 on
             the valid set every iteration; fails unless hist_sparse_f32,
             hist_sparse_int8, slot_totals and table_lookup launched, no
             sparse store was densified (train or valid), NDCG@5 is
             finite and no lower
             after the last iteration than after the first, and the
             device-scored valid set agrees with Booster.predict(
             raw_score=True) within 1e-4.
7. card vs CPU — the same training on the CPU (plain versions) and on the
             card (kernels), first trees identical unless their first
             differing split is an f32 gain tie: 5 iterations of the
             phase-3 configuration on synth_higgs(50_000) (valid AUCs
             within 1e-4), and 3 iterations of CTR_PARAMS on
             synth_ctr(4_000, 2_048, 0.01), float32 and int8 (valid
             NDCG@5 within 1e-4).
8. onehot set-up — synth_onehot(2_000_000): 40 one-hot groups of 6, 240
             features (bench.py BENCH_WORKLOAD=onehot, cut from 10.5M
             rows) through lightgbm_tpu_torch.Dataset with ONEHOT_PARAMS:
             host seconds of data, binning with the bundle plan, and the
             store apart; fails unless EFB packed the 240 features into 40
             store columns with 0 conflicting rows.  Valid set
             synth_onehot(200_000, seed=7) on the same plan.
9. gathered kernels — K5 (histogram_from_indices) against its plain
             version at the exact learner's shapes, over its byte feeds
             ([N+1, C] uint8) with the live row count: the root of the
             onehot store (every row, C=40 columns of 7 bins, B=128), a
             mid-tree leaf (65,536 index slots, 60,000 of them rows), and a
             north-star store (C=28, 255 bins, B=256, every row); K6
             (hist_multileaf) at M=128 value rows, F=28, B=256, C=2M.
             Bitwise on dyadic values, and on real ones within
             n * 2^-23 * sum|x| per cell (the kernel's fixed-order float
             sums and the plain version's index_add_ order differ); the
             count channel always bitwise; K5 and K6 run twice, bitwise
             equal.
             Times of kernel, plain version and one PyTorch call over
             prebuilt flat indices (index_add_ for K5; for K6 one
             scatter_add_ over stride-0 views, since its flat index would
             hold F*M*C = 7.2e9 entries).
10. onehot main — the serial exact leaf-wise learner (tree_growth=exact
             with the SerialTreeLearner built on the card directly, as
             the JAX package's tests build a learner: the card's `exact`
             is the fused builder of phase 18) on the phase-8 datasets,
             12 iterations (s/iter over iterations 3-12,
             timed as in phase 3), valid AUC every iteration; fails unless
             the learner is the exact one, K5 launched, AUC rose from
             iteration 1 to 12, and the device-scored valid set agrees with
             Booster.predict(raw_score=True) within 1e-4.  Then the rounds
             learner (tree_growth=auto) on the same bundled store, 6
             iterations, which must launch K1, K3 and K4.  Then one tree
             of each learner replayed: a one-tree train with K5's wrapper
             (exact) or K1's (rounds, 7 bins a column) recording each
             call's inputs, every call then checked as in phase 9 (K5) or
             phase 3 (K1), timed and given its bound; the per-tree sums
             are printed.
11. losslessness — synth_onehot(50_000) with enable_bundle true and
             false, for each learner: the same first tree (unless its first
             differing split is an f32 gain tie), predictions within 1e-5.
12. onehot card vs CPU — 5 iterations of the exact learner on the CPU and
             on the card, on synth_onehot(50_000) with ONEHOT_PARAMS and on
             synth_higgs(50_000) with the north-star parameters: first
             trees as in phase 7, valid AUC within 1e-4; the serial
             learner on both, and the card's fused builder against the
             CPU's serial learner.
13. objectives — regression and 5-class multiclass through the rounds
             learner at the main path's shape: synth_higgs(2_000_000) x 28
             with its labeling function left unthresholded (the target:
             logit + 0.5 x logistic noise) and that target cut at its
             20/40/60/80% quantiles; valid synth_higgs(200_000, seed=7)
             by the same rules (the training cuts); the north-star
             parameters (int8) with objective=regression (l2), then
             multiclass, num_class=5 (multi_logloss); 2 warm-up and 4
             timed iterations each, timed as in phase 3.  Fails unless K1,
             K3 and K4 launched in every class tree, the valid metric fell
             from the first iteration to the last, and the device-scored
             valid set agrees with Booster.predict(raw_score=True) within
             1e-4.  Then card against CPU on a 50,000-row version of each
             (valid 10,000): 5 iterations; every class tree of the first
             iteration identical unless its first differing split is an
             f32 gain tie; later iterations compared until the first
             that differs (the card's and the CPU's last-bit exp and
             cumulative sums can move an int8 gradient across a
             quantization boundary), which is printed; the valid metric
             of the first iteration and of every identical one within
             1e-4.  s/iter, trees a second and
             host syncs a tree are printed with the card.
14. training surface — on phase 3's north-star datasets (not binned
             again), the north-star parameters (int8, rounds learner):
             GOSS (top_rate 0.2, other_rate 0.1, 14 iterations: 10
             warm-up at lr 0.1, then 4 on 600,000 sampled rows), which
             must launch K1, K3 and K4 in every sampled tree and raise the
             valid AUC from iteration 10 to 14; then GOSS on the CPU and
             on the card (synth_higgs(50_000), lr 0.5: 2 warm-up
             iterations of 4): the first sampled iteration's selection,
             run again on the CPU from the card's gradients, bitwise
             (bag, amplified g and h), the runs' own bags compared, trees
             identical until a first differing split that is an f32 gain
             tie.  DART (drop_rate 0.1, 8 iterations): trees dropped and
             the K3 launches of the drop and renormalization walks
             printed; fails unless a tree was dropped and the
             device-scored valid set agrees with Booster.predict(
             raw_score=True) within 1e-4.  Checkpoint/resume (lr 0.5,
             bagging 0.8 every iteration, seed 3; a temporary
             directory): the model string of a run checkpointed every 3
             iterations, stopped at 6 and resumed to 10 equals the
             uninterrupted run's.  Continuation from that model's file
             (init_model, 5 more iterations: 15, valid AUC no lower than
             at 10).  Its init score (the init model's raw predictions
             on the training rows, past the work gate the device walk)
             must equal the init model's own Booster.predict bitwise and
             lie within T * 2^-23 * sum|leaf| of the host walk with every
             value and threshold rounded to f32 (the device's compares) on
             every row; the rows more than 1e-5 off the f64 host walk are
             counted.  Then two rollbacks: the training scores within
             1e-5 of that init score plus a fresh replay of the trees
             after it, the valid scores within 1e-5 of a fresh replay of
             the trees left; the training scores' gap to a binned replay
             of every tree (bin routing, as the f64 walk) is printed.
             Early stopping (early_stopping_rounds=3, lr 0.5, 30 rounds):
             best_iteration printed.
15. serving — the device predictors and the serving plane at
             scripts/bench_serve.py's shape (:60-96): a model trained on
             the card on RandomState(0).rand(20_000, 28) with a linear
             label at its median (binary, 63 leaves, max_depth 8,
             min_data_in_leaf 20, 500 iterations; a second of 100 on
             RandomState(1)), written with its .refbin to a temporary
             directory (lightgbm_tpu_torch.synth.train_serve_model).
             predict_ensemble_any on the card (perfect layout) against the
             same call on the CPU over RandomState(1).rand(200_000, 28),
             and phase 3's booster (255 leaves) over its valid set: leaf
             indices bitwise, raw scores within T * 2^-23 * sum|leaf|;
             phase 3's card scores also within that bound of the host walk
             on f32-rounded values and thresholds on every row (else
             fail), and the rows more than 1e-5 off the f64 host walk
             counted.
             Booster.predict rows/s on the 200,000 rows, tensorized and
             walk; phase 3's booster replayed onto its training store with
             add_trees, tensorized against the walk (within the bound),
             both timed.  Then a PredictionServer (ModelRegistry, one
             replica, warmed at the 64-512-row buckets) on 127.0.0.1:0,
             serve_quantize=binned from the .refbin, then raw: 8
             closed-loop clients of 64 rows a request for 10 s; every
             answer bitwise equal to the card's predict_ensemble_any after
             the sigmoid, cache_misses unchanged through the loop;
             p50/p95/p99 ms, requests/s and rows/s printed, and each
             request buffer's bytes a row.  Two tenants co-stacked
             (serve_costack): each tenant's answers bitwise equal to its
             solo runtime on the card.  A hot swap on the raw server: the
             model file overwritten with the second model and polled; the
             generation flips, the answers are the second model's bitwise,
             and cache_misses does not move.
16. online  — the online loop and the router at scripts/bench_online.py's
             scenario, uncut (synth.synth_drift: 28 features, a base of
             100,000 rows, a drifted window of 25,000, a drifted eval set
             of 16,000; 60 trees of up to 255 leaves, max_bin 255, lr
             0.1, min_data_in_leaf 20, min_sum_hessian_in_leaf 100,
             refit_decay_rate 0, refit_min_rows 1).  A base model trained
             on the card; LeafRefitter over a streaming window of the
             training mappers, routed by the binned walk on the card: the
             first refit and 5 steady refits (reset, refill with a fresh
             drifted window, refit) timed; the leaf values held against
             the CPU refit of the same model and window routed by the host
             walk (within REFIT_RTOL relative + REFIT_ATOL), the rows the
             two walks route differently counted, a second refit of the
             first window bitwise the first; a 60-tree retrain on the
             window timed; drifted-eval AUC of base, refit and retrain
             (the refit's must beat the base's).  Then a PredictionServer
             on the card (one replica, model_poll_seconds 0.2) over the
             base model's file and an OnlineTrainer in refit mode fed the
             window through append_traffic in 5 chunks: generation 1
             published and adopted (publish to adoption timed), /stats
             shows it with its refbin_sha1, cache_misses unchanged across
             the swap, 16 answers of 64 rows bitwise the published
             model's predict_ensemble_any after the sigmoid.  An
             OnlineTrainer in continue mode appends 5 trees on the same
             traffic, each launching K2, K4 and K3 (counts zeroed before
             and read after).  Two backends on the card serving the
             refitted model behind router_from_config: routed answers
             bitwise the direct ones with X-Model-Id relayed; closed loops
             (8 clients of 64 rows, 2 s) direct and routed, twice each,
             interleaved, p50/p99 printed; the home backend stopped under
             a routed loop with no client error, restarted on its port and
             readmitted by the health sweep.
17. files and the C ABI — the product surface through files at the
             north-star width (28 features, 255 leaves, max_bin 255, int8
             histograms, lr 0.1, metric auc), in a temporary directory:
             synth_higgs(500_000) written to train.csv (label first,
             %.9g) with a seeded train.csv.weight, synth_higgs(100_000,
             seed=7) to valid.tsv with a header, and a train.conf in the
             reference's `key = value` format with # comments (20
             iterations, is_save_binary_file=true).  Application on the
             config in-process (the native parser must have read
             train.csv; K1, K3 and K4 must launch); `python -m
             lightgbm_tpu_torch` on the same config as a subprocess
             (cache off, so it parses the CSV too), lt.train on
             parse_text_file of the same files, and an in-process rerun
             that must load train.csv.bin: all four model strings equal
             (where they are not, the first differing line is printed,
             every structural line must be equal and every float line
             within rtol 1e-6).  A two-round load of train.csv (5
             iterations, valid AUC above 0.75).  task=predict on
             valid.tsv: bitwise Predictor.predict, within 1e-6 of the
             host f64 walk, within 1e-7 of a run in chunks of 37,000
             rows.  task=refit on a copy of 100,000 training rows with
             flipped labels: leaf values bitwise Booster.refit's.
             task=serve as a subprocess: /healthz answers, four 64-row
             requests answered bitwise as resolve_runtime on the same
             model file in-process, exit 0 on SIGTERM.  The training C
             ABI (liblgbt_train_torch, built with g++ against the
             interpreter's headers, loaded with ctypes):
             LGBM_DatasetCreateFromFile on train.csv, the valid set from
             a matrix with its reference, 10 LGBM_BoosterUpdateOneIter on
             the card (K1, K3, K4 must launch), LGBM_BoosterPredictForMat
             bitwise Booster.predict on the saved model string,
             LGBM_BoosterRefit on PREDICT_LEAF leaves bitwise
             refit_gbdt(leaf_idx=) from Python; lightgbm_tpu never loaded.
             Seconds of each step printed.

18. the bundled sparse store and the fused builder (~120 s; its
             parts run beside the phases whose data they share, and print
             "[phase 18...]"):
             18a (after phase 7) — synth_ctr(500_000) x 5,000 (bench.py's
             BENCH_CTR_FEATURES knob of the ctr shape) with CTR_PARAMS
             and enable_bundle=true: store columns, bundles, conflicting
             rows, nnz and set-up seconds; 12 iterations through the
             rounds learner (K8, K3; s/iter as in phase 3, the tree/*
             counters printed), valid NDCG@5 must not fall, no store
             densified, device valid scores within 1e-4 of the host walk
             on the valid rows without a bundle conflict (a conflicting
             row keeps one member in any bundled store); K8 over the
             bundled store against its plain version (a K=31 pass, as
             phase 5), timed — its row in the {"kernels"} line.  On a
             50,000-row cut, with dyadic gradients (every sum exact): the
             rounds learner's tree over the bundled csr store bitwise the
             one over the dense bundled store; card and CPU first trees
             (phase 7's rule).  The 20,000 x 3,000 sparse probe at
             density 0.01 with the stock parameters: a bundle plan, the
             csr store, 2 iterations, no densification.
             18d — the fused builder (tree_growth=exact) on the same cut:
             its sparse feed (K8, K=1 a pass) bitwise its dense feed (K2)
             with dyadic gradients, no densification.
             18b (after phase 10) — the fused builder on the onehot
             datasets of phase 8, 12 iterations (s/iter as in phase 3)
             under HotPathSanitizer(warmup=1, strict): every tree after
             the first makes no synchronising call and builds no kernel,
             the host reads each tree once (one packed read), K2
             launches once at the root and once a split of every tree and
             K5 never; valid AUC must rise; its first tree structurally
             the serial learner's of phase 10 unless the first differing
             split is an f32 gain tie.  K2's one-slot pass as the builder
             calls it (a leaf of half the rows in the mask) against its
             plain version, timed — its row in the {"kernels"} line.
             18c (after phase 15, so that serving runs as before it) —
             the fused builder on phase 3's north-star datasets,
             float32, 6 iterations, with 18b's checks; 3 more with
             bagging 0.8 (the row mask); its first tree against the
             serial learner's on the card; s/iter of the fused and the
             serial learner alternating, F S F S (4 iterations each
             after the first, 3 timed).
19. multi-rank training (~60 s, after phase 17) — the one-rank models
             of five workloads trained here first on synth_higgs(500,000)
             x 28 with the north-star parameters (3 iterations), then W
             rank processes of this script (`--multigpu-rank`, started
             by lightgbm_tpu_torch.diagnostics.worlds.run_world: a file
             store in a temporary directory, a 120 s collective timeout
             and a 400 s limit on the world; a rank that fails or hangs
             kills the others and fails the phase): W = 2 on one card,
             both on cuda:0 over gloo (collectives staged through host
             memory), or one rank a card over NCCL (W = the card count,
             at most 4).  Each rank builds the same dataset and trains,
             under BENCH_SANITIZE=1, the rounds learner data-parallel in
             int8 with hist_exchange=psum and =psum_scatter (K1, K3, K4),
             in float32 with psum (K2, K3, K4), and the fused builder
             feature-parallel and voting (top_k 28, every feature; K2)
             under HotPathSanitizer(warmup=1, strict); and PV-Tree
             voting with top_k 5 (10 of 28 features' histograms
             reduce-scattered a search; K2) on synth_higgs(20,000), which
             a CPU world of 2 gloo ranks then trains too.  Fails unless
             every rank's model string is rank 0's, each launched its
             workload's kernels, DivergenceSanitizer counted checks and
             no divergence, no implicit transfer was made, and the model
             is its reference's — the one-rank model, or for top_k 5
             (which a single rank cannot grow) the CPU world's: bitwise
             in int8, else every tree's structure equal and its float
             lines within rtol 1e-4, atol 1e-6 (a structure that parts
             must part first at an f32 gain tie, as phase 7); and top_k
             5 must exchange at most half the histogram bytes a tree of
             top_k 28.  Prints one {"multigpu": {...}} line a workload
             (backend, world, devices, rows, reference, trees_equal,
             each rank's s/iter over iterations 2-3, collective,
             histogram and record bytes a tree).
20. training observability and ingest (after phase 3, on its data):
             20a — the phase-3 int8 configuration (K1, K3, K4) trained
             three times for 12 iterations with the valid AUC: with no
             telemetry; with telemetry_path in params and
             checkpoint_path with checkpoint_interval=4; and with
             telemetry on and every iteration after the second inside
             HotPathSanitizer(warmup=2) (the learner's declared reads
             are explicit transfers: any other synchronising call
             counts).  Fails unless the three model strings are equal,
             the file holds 12 train.iteration records (iterations 1-12,
             with the tree and score phases), 12 train.eval and 4
             train.checkpoint (iterations 4, 8, 12 and the final
             snapshot), the host reads a tree are the same with
             telemetry on and off, and the sanitizer counted 0 implicit
             transfers and 0 kernel builds; prints s/iter over
             iterations 3-12 of each run (a reading, no limit).  Then
             train.after_checkpoint:2 armed on an 8-iteration run
             checkpointed every 2 (learning rate 0.5, a dyadic rate: the
             device path shrinks in f32, the model in f64): the injected
             fault is caught, the resumed run's model string equals the
             uninterrupted run's, and train.resume is recorded.
             20b — the phase-3 rows (synth_higgs(2_000_000), seed 42)
             through Dataset.from_stream in chunks of 65,536 and through
             the monolithic constructor (bin_construct_sample_cnt
             covering every row, where the streamed mappers are exact):
             the two stores sha1-equal; a bin_find=sketch dataset of the
             same rows; set-up seconds of each.  3 iterations on the
             streamed and on the sketch dataset (K1, K3, K4 launched,
             valid AUC > 0.70); on a 100,000-row cut of each (streamed),
             card and CPU first trees as phase 7 and valid AUCs within
             1e-4.
21. run to run (its parts run beside the phases whose data they share,
             and print "[phase 21...]"; the ctr store is not rebuilt):
             21a (phase 5 and 18a) — K8 twice on the real-valued K=31 pass
             of the ctr store and of the bundled ctr store: bitwise.
             21b (phase 5) — the slot totals of that float32 pass twice:
             bitwise.  21c (phase 6) — its float32 training (12
             iterations) once more: one model string and NDCG@1..5 equal
             at every iteration.  21d
             (phase 6) — AUC, NDCG@1..5 and MAP@1..5 of that model's
             training scores, three calls each on the card: bitwise.
             21e (at the end) — the native bulk binner must run on this
             host, and must have binned every numerical column of the
             uint8 stores of phase 17's file load and phase 20b's
             monolithic set-up; their seconds are printed.  Fails on any
             difference; prints the phase's seconds.

Every kernel's ms is timed by CUDA events around each call, the method
of earlier versions of this script; it includes the wrapper's host
enqueue where that takes longer than the kernel.  K1-K5 are also timed
as graph_ms, the device time of one call with no host in between, from a
CUDA graph of 10 calls replayed between events (in their {"kernels"}
rows too), and so is K6; K1, K2 and K5 also as host_us, the wrapper's
host time a call.

Prints the card's name and power limit, one {"kernels": [...]} JSON line,
and last {"ok": true, "device": {...}}.  Exits with 2 and no result when
no CUDA device is visible.
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

# H100 SXM peaks (NVIDIA data sheet): device-memory rate, and the
# float32 / int32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12

# K2 tolerance on phase 2's gathered pass: K2 sums a cell in a fixed
# order, its plain version's index_add_ in another; n f32 additions
# reorder within n * 2^-24 * sum|x|, which for the ~60 rows of |x| <= 4
# that a cell receives here stays below 1e-3
K2_ATOL = 1e-3

# shapes: a gathered histogram pass at the capacity tier of a 10.5M-row
# training set, the row counts of the main path, the card-vs-CPU run
HIST_ROWS = 1_312_512
MAIN_ROWS = 2_000_000
VALID_ROWS = 200_000
COMPARE_ROWS = 50_000
# the ctr configuration (scripts/run_chip_queue.sh bench_ctr): rows,
# hashed features, density; its valid set; the card-vs-CPU shape
CTR_ROWS = 500_000
CTR_FEATURES = 50_000
CTR_DENSITY = 0.01
CTR_VALID_ROWS = 4_080
CTR_COMPARE = (4_000, 2_048)
# slots of the sparse-kernel phase: the ctr tree's 31 leaves
CTR_SLOTS = 31
# the onehot configuration (bench.py BENCH_WORKLOAD=onehot), cut from
# 10.5M to 2M rows; its valid set; the losslessness and card-vs-CPU shape
ONEHOT_ROWS = 2_000_000
ONEHOT_VALID_ROWS = 200_000
ONEHOT_COMPARE = 50_000
# phase 13's multiclass workload (the reference's multiclass example has 5)
CLASSES = 5
# K5's mid-tree leaf (index slots, rows) and K6's value rows
LEAF_CAP, LEAF_ROWS = 65_536, 60_000
K6_ROWS = 128
GPU = "cuda"


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def host_walk(bst, X, **kw):
    """Booster.predict through the host f64 walk of every tree, whatever
    the batch's size (LIGHTGBM_TPU_DEVICE_PREDICT=0)."""
    old = os.environ.get("LIGHTGBM_TPU_DEVICE_PREDICT")
    os.environ["LIGHTGBM_TPU_DEVICE_PREDICT"] = "0"
    try:
        return bst.predict(X, **kw)
    finally:
        if old is None:
            del os.environ["LIGHTGBM_TPU_DEVICE_PREDICT"]
        else:
            os.environ["LIGHTGBM_TPU_DEVICE_PREDICT"] = old


def f32_host_walk(lt, bst, X):
    """The host walk (raw scores) with every feature value and threshold
    rounded to f32 first: the device walk's compares, made on the host,
    so its leaves are the device's; only the order of the leaf sums
    differs (within `tree_bound`)."""
    twin = lt.Booster(params={"device_type": "cpu", "verbose": -1},
                      model_str=bst.model_to_string())
    for t in twin._gbdt.models:
        t.threshold = t.threshold.astype(np.float32).astype(np.float64)
    return host_walk(twin, np.asarray(X, np.float32).astype(np.float64),
                     raw_score=True)


def tree_bound(trees) -> float:
    """T * 2^-23 * sum|leaf| a row (max |leaf| a tree): the f32
    reordering bound of ops/predict.py."""
    return len(trees) * 2.0 ** -23 * sum(
        float(np.abs(t.leaf_value[:t.num_leaves]).max()) for t in trees)


def check_device_walk(lt, label, bst, X, dev):
    """`dev`, bst's raw scores over X from the device walk, against the
    host: within `tree_bound` of the f32-operand host walk on every row
    (else fail); the rows more than 1e-5 off the f64 walk (f32 rounding
    sent them to another leaf) and the largest such gap, printed."""
    host32 = f32_host_walk(lt, bst, X)
    host64 = host_walk(bst, X, raw_score=True)
    bound = tree_bound(bst._gbdt.models)
    err32 = float(np.abs(dev - host32).max())
    gap = np.abs(dev - host64)
    off = int((gap > 1e-5).sum())
    print(f"[{label}] device walk over {len(X)} rows: max |diff| to the "
          f"f32-operand host walk {err32:.3e} (bound {bound:.3e}); rows "
          f"> 1e-5 off the f64 host walk: {off}, largest gap "
          f"{float(gap.max()):.3e}", flush=True)
    if not err32 <= bound:
        fail(f"{label}: the device walk is {err32} off the host walk on "
             f"f32 operands (bound {bound})")
    return off


def time_ms(torch, fn, reps: int, warmup: int = 2) -> float:
    """Median device time of one call, by CUDA events around each call."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


_SIDE = []


def graph_ms(torch, fn, reps: int = 10, per: int = 10) -> float:
    """Median device time of one call with no host in between: `per`
    calls captured in a CUDA graph (on one side stream, after warm-up
    calls on it, which also allocate whatever the calls keep), the graph
    replayed between CUDA events `reps` times.  A small kernel's wrapper
    takes longer on the host than the kernel on the card, so events
    around each call (`time_ms`) time the host enqueue; this times the
    card."""
    if not _SIDE:
        _SIDE.append(torch.cuda.Stream())
    side = _SIDE[0]
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(per):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / per)
    del graph
    return statistics.median(times)


def host_us(torch, fn, reps: int = 100) -> float:
    """Host microseconds of one call of a kernel wrapper (enqueue only:
    no synchronisation inside the loop)."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t) / reps * 1e6
    torch.cuda.synchronize()
    return us


def bound_ms(nbytes: float, ops: float) -> tuple:
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = ops / SCALAR_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def steady_window(torch, warmup: int, total: int, marks: list):
    """After-iteration callback of lightgbm_tpu_torch.train: at the end of
    iteration `warmup` and of iteration `total` (counted from 1) it
    synchronises the device and appends the host clock to `marks`, so
    s/iter = (marks[1] - marks[0]) / (total - warmup) is a steady window
    inside one train."""
    def cb(env):
        if env.iteration + 1 in (warmup, total):
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
    return cb


def sparse_bound(torch, cols, srow, vals, K: int, Cp: int, B: int):
    """(bound ms, basis, rows, entries) of one K7/K8 pass: the stored
    entries (column and bin, 8 B) of the rows in a slot that carry a
    value, the slot of every row and the three value lanes of the rows
    in a slot, read once; the [K, Cp, 3, B] output written once; three
    adds per entry."""
    N = cols.shape[0]
    slotted = srow < K
    active = slotted & (vals != 0).any(dim=0)
    n_slotted = int(slotted.sum())
    entries = int(((cols >= 0) & (cols < Cp) & active[:, None]).sum())
    nbytes = entries * 8 + N * 4 + n_slotted * 12 + K * Cp * 3 * B * 4
    return bound_ms(nbytes, 3.0 * entries) + (n_slotted, entries)


def sparse_check(torch, H, SS, name, st, zb, srow, v, tot, scale, K, Cp,
                 B, exact: bool) -> float:
    """K7/K8 against their plain version on one pass's inputs (the same
    slot totals `tot` for both): bitwise when `exact`, else every cell
    within n * 2^-23 * sum|x| (n f32 additions in any order lie within
    n * 2^-24 * sum|x| of the exact sum, and the plain version's
    index_add_ reorders too), where a stored cell counts its own entries
    and a zero bin (slot total minus the column's stored sums) the slot's
    rows.  Returns the max |diff|."""
    got = SS._hist_streams_cuda(st, zb, srow, v, tot, scale, K, Cp, B)
    ref = SS.hist_streams_plain(st, zb, srow, v, tot, scale, K, Cp, B)
    torch.cuda.synchronize()
    # in slices of a few slots: a K=84, B=256 pass is 12.9 GB in float32
    err = max((got[k:k + 8].double() - ref[k:k + 8].double()).abs().max()
              .item() for k in range(0, K, 8))
    if exact and not torch.equal(got, ref):
        fail(f"{name} differs from its plain version: max |diff| {err}")
    if not exact:
        absv = torch.stack([v[0].abs(), v[1].abs(), v[2]])
        ta = H._slot_totals(srow, absv, K)
        s = SS.hist_streams_plain(st, torch.full_like(zb, -1), srow, absv,
                                  ta, None, K, Cp, B).double()
        tol = s[:, :, 2:3, :] * 2.0 ** -23 * s
        del s
        ta = ta.double()
        ok = (zb >= 0).nonzero()[:, 0]
        tol[:, ok, :, zb[ok].long().clamp(max=B - 1)] += (
            ta[:, 2:3] * 2.0 ** -23 * ta)[None]
        bad = ((got.double() - ref.double()).abs() > tol).sum().item()
        if bad:
            fail(f"{name}: {bad} cells beyond n*2^-23*sum|x| (max |diff| "
                 f"{err})")
    return err


def phase_kernels(torch, kernels, H, LK, P):
    dev = torch.device(GPU)
    rng = np.random.RandomState(7)
    rows = []

    # ---- K1 / K2: one gathered pass at a capacity tier ------------------
    F, B, K, C = 28, 256, 84, HIST_ROWS
    N = 2 * C
    bins_np = rng.randint(0, 255, size=(F, N)).astype(np.int32)
    counts = rng.multinomial(int(C * 0.95), np.full(K, 1.0 / K))
    counts[[5, 40, 83]] = 0                           # empty slots
    lid_np = np.full(C, -2, np.int32)                 # pad rows past total
    lid_np[:counts.sum()] = np.repeat(np.arange(K), counts)
    row_idx_np = np.sort(rng.choice(N, C, replace=False)).astype(np.int32)
    sl_np = np.arange(K, dtype=np.int32)
    sl_np[[5, 40, 83]] = -1
    g = (rng.randn(C) * (lid_np >= 0)).astype(np.float32)
    h = (rng.rand(C) * 0.25 * (lid_np >= 0)).astype(np.float32)
    gh = torch.as_tensor(np.stack([g, h, (lid_np >= 0).astype(np.float32)]),
                         device=dev)
    ghq, _, _ = H._quantize_gh(gh)
    lid = torch.as_tensor(lid_np, device=dev)
    row_idx = torch.as_tensor(row_idx_np, device=dev)
    sl = torch.as_tensor(sl_np, device=dev)
    base = torch.as_tensor(np.concatenate([[0], np.cumsum(counts)]),
                           dtype=torch.int64, device=dev)
    bins32 = torch.as_tensor(bins_np, device=dev)
    bins8 = (bins32 - 128).to(torch.int8)
    rows32 = H.row_major_bins(bins32, 255)
    rows8 = H.row_major_bins(bins8, 255)
    if not (torch.equal(rows32.rows, rows8.rows) and torch.equal(
            rows32.rows[:, :F].t().to(torch.int32), bins32)):
        fail("the row-major byte copy differs from the [F, N] store")
    n_match = int(counts.sum())

    def library_hist(vals, acc_dtype):
        """One index_add_ over a flattened (slot, feature, channel, bin)
        index — the same sums as the kernel, index built beforehand."""
        pos = torch.arange(n_match, device=dev)
        kk = lid[pos].long()
        b = bins32[:, row_idx[pos].long()].long()           # [F, E]
        f = torch.arange(F, device=dev)[:, None]
        idx = torch.cat([(((kk[None, :] * F + f) * 3 + ch) * B + b).reshape(-1)
                         for ch in range(3)])
        v = torch.cat([vals[ch, pos][None, :].expand(F, -1).reshape(-1)
                       for ch in range(3)]).to(acc_dtype)
        out = torch.zeros(K * F * 3 * B, dtype=acc_dtype, device=dev)
        return lambda: out.zero_().index_add_(0, idx, v)

    # K1 over the segment plan: from the byte copy (built from the int32
    # and from the int8 store) and from both [F, N] stores, bitwise equal
    # to its plain version over the runs' bounds and to the masked-feed one
    ref = H._hist_plain(bins32, row_idx, lid, ghq, sl, B)
    errs = []
    for label, bins, rws in (("byte copy of int32", bins32, rows32),
                             ("byte copy of int8", bins8, rows8),
                             ("int32 [F, N]", bins32, None),
                             ("int8 [F, N]", bins8, None)):
        got = H._hist_q_cuda(bins, rws, row_idx, ghq, B, base=base)
        again = H._hist_q_cuda(bins, rws, row_idx, ghq, B, base=base)
        plan_ref = H._segments_plain(bins, rws, row_idx, ghq, base, B)
        torch.cuda.synchronize()
        errs.append((got.double() - ref.double()).abs().max().item())
        if not (torch.equal(got, ref) and torch.equal(got, plan_ref)
                and torch.equal(got, again)):
            fail(f"hist_masked_int8 gathered pass ({label}) differs from "
                 f"its plain version: max |diff| {errs[-1]}")
    del plan_ref, again

    def k1_gathered():
        return H._hist_q_cuda(bins32, rows32, row_idx, ghq, B, base=base)
    ms = time_ms(torch, k1_gathered, 20)
    graph = graph_ms(torch, k1_gathered)
    host = host_us(torch, k1_gathered)
    plain = time_ms(torch, lambda: H._segments_plain(
        bins32, rows32, row_idx, ghq, base, B), 3, 1)
    lib = time_ms(torch, library_hist(ghq, torch.int32), 5, 1)
    F4 = rows32.rows.shape[1]
    # the byte rows and (row id, 3 values) of the positions in a run, the
    # segment bounds, the [K, F, 3, B] int32 output once
    bms, by = bound_ms(n_match * (F4 + 4 + 12) + (K + 1) * 8
                       + K * F * 3 * B * 4, 3.0 * F * n_match)
    rows.append(dict(name="hist_masked_int8", route="cuda",
                     source="lightgbm_tpu_torch/csrc/histogram.cu",
                     replaces="lightgbm_tpu/ops/histogram.py:503",
                     max_abs_err=max(errs), ms=ms, graph_ms=graph,
                     plain_ms=plain, bound_ms=bms, bound_by=by,
                     library_ms=lib))
    print(f"[kernels] hist_masked_int8 (gathered pass): C={C} F={F} K={K} "
          f"B={B} rows={n_match} "
          f"f_tile={H._k1_feature_tile(F, 255, True, True)} "
          f"max_abs_err={max(errs):.3g} ms={ms:.4f} graph_ms={graph:.4f} "
          f"host_us={host:.1f} plain_ms={plain:.4f} library_ms={lib:.4f} "
          f"bound_ms={bms:.4f} ({by})", flush=True)
    del ref, got

    # K2 over the same segment plan: from the byte copy and from both
    # [F, N] stores, within K2_ATOL of its plain version over the runs'
    # bounds and of the masked-feed one, and bitwise from run to run
    ref = H._hist_plain(bins32, row_idx, lid, gh, sl, B)
    errs = []
    for label, bins, rws in (("byte copy", bins32, rows32),
                             ("int32 [F, N]", bins32, None),
                             ("int8 [F, N]", bins8, None)):
        got = H._hist_f_cuda(bins, rws, row_idx, gh, B, base=base)
        again = H._hist_f_cuda(bins, rws, row_idx, gh, B, base=base)
        plan_ref = H._segments_plain(bins, rws, row_idx, gh, base, B)
        torch.cuda.synchronize()
        err = max((got.double() - r.double()).abs().max().item()
                  for r in (ref, plan_ref))
        errs.append(err)
        if not err <= K2_ATOL:
            fail(f"hist_masked_f32 gathered pass ({label}) max |diff| {err} "
                 f"> {K2_ATOL}")
        if not torch.equal(got, again):
            fail(f"hist_masked_f32 gathered pass ({label}) differs from run "
                 "to run")
    del plan_ref, again

    def k2_gathered():
        return H._hist_f_cuda(bins32, rows32, row_idx, gh, B, base=base)
    ms = time_ms(torch, k2_gathered, 20)
    graph = graph_ms(torch, k2_gathered)
    host = host_us(torch, k2_gathered)
    plain = time_ms(torch, lambda: H._segments_plain(
        bins32, rows32, row_idx, gh, base, B), 3, 1)
    lib = time_ms(torch, library_hist(gh, torch.float32), 5, 1)
    # the same bytes as K1's pass: byte rows, row id and 3 values of the
    # positions in a run, the bounds, the [K, F, 3, B] float32 output
    bms, by = bound_ms(n_match * (F4 + 4 + 12) + (K + 1) * 8
                       + K * F * 3 * B * 4, 3.0 * F * n_match)
    lay = H._k2_layout(F, 255, True, K)
    rows.append(dict(name="hist_masked_f32", route="cuda",
                     source="lightgbm_tpu_torch/csrc/histogram.cu",
                     replaces="lightgbm_tpu/ops/histogram.py:443",
                     max_abs_err=max(errs), ms=ms, graph_ms=graph,
                     plain_ms=plain, bound_ms=bms, bound_by=by,
                     library_ms=lib))
    print(f"[kernels] hist_masked_f32 (gathered pass): C={C} F={F} K={K} "
          f"B={B} rows={n_match} f_tile={lay[0]} "
          f"max_abs_err={max(errs):.3g} ms={ms:.4f} graph_ms={graph:.4f} "
          f"host_us={host:.1f} plain_ms={plain:.4f} library_ms={lib:.4f} "
          f"bound_ms={bms:.4f} ({by})", flush=True)
    del ref, got, rows8

    # ---- K1 / K2: each tree's root pass, the masked feed (no row index),
    # one slot, every training row in leaf 0.  grad and hess are dyadic
    # (multiples of 2^-6 and 2^-8, |g| < 2^4) so that every partial sum of
    # a cell (~N/255 rows) is exact in f32: any order of the float adds
    # gives the same sums, and K2 is held bitwise here as well ----------
    Nr = MAIN_ROWS
    pbins = bins32[:, :Nr].contiguous()
    prows = H.row_major_bins(pbins, 255)
    rlid = torch.zeros(Nr, dtype=torch.int32, device=dev)
    rsl = torch.zeros(1, dtype=torch.int32, device=dev)
    rg = np.clip(np.round(rng.randn(Nr) * 64), -1000, 1000) / 64
    rh = np.round(rng.rand(Nr) * 64) / 256
    rgh = torch.as_tensor(np.stack([rg, rh, np.ones(Nr)]).astype(np.float32),
                          device=dev)
    rghq, _, _ = H._quantize_gh(rgh)
    errs = []
    for label, bins, rws in (("byte copy", pbins, prows),
                             ("int32 [F, N]", pbins, None),
                             ("int8 [F, N]", (pbins - 128).to(torch.int8),
                              None)):
        got = H._hist_q_cuda(bins, rws, None, rghq, B, lid=rlid, sl=rsl)
        again = H._hist_q_cuda(bins, rws, None, rghq, B, lid=rlid, sl=rsl)
        ref = H._hist_plain(bins, None, rlid, rghq, rsl, B)
        torch.cuda.synchronize()
        errs.append((got.double() - ref.double()).abs().max().item())
        if not (torch.equal(got, ref) and torch.equal(got, again)):
            fail(f"hist_masked_int8 root pass ({label}) differs from its "
                 f"plain version: max |diff| {errs[-1]}")

    def k1_root():
        return H._hist_q_cuda(pbins, prows, None, rghq, B, lid=rlid, sl=rsl)
    ms = time_ms(torch, k1_root, 20)
    graph = graph_ms(torch, k1_root)
    host = host_us(torch, k1_root)
    plain = time_ms(torch, lambda: H._hist_plain(pbins, None, rlid, rghq,
                                                 rsl, B), 3, 1)
    bms, by = bound_ms(Nr * (F4 + 4 + 12) + 4 + F * 3 * B * 4, 3.0 * F * Nr)
    print(f"[kernels] hist_masked_int8 root pass: C=N={Nr} F={F} K=1 B={B} "
          f"f_tile={H._k1_feature_tile(F, 255, True, False)} "
          f"max_abs_err={max(errs):.3g} ms={ms:.4f} graph_ms={graph:.4f} "
          f"host_us={host:.1f} plain_ms={plain:.4f} bound_ms={bms:.4f} "
          f"({by})", flush=True)
    errs = []
    for label, bins, rws in (("byte copy", pbins, prows),
                             ("int32 [F, N]", pbins, None),
                             ("int8 [F, N]", (pbins - 128).to(torch.int8),
                              None)):
        got = H._hist_f_cuda(bins, rws, None, rgh, B, lid=rlid, sl=rsl)
        again = H._hist_f_cuda(bins, rws, None, rgh, B, lid=rlid, sl=rsl)
        ref = H._hist_plain(bins, None, rlid, rgh, rsl, B)
        torch.cuda.synchronize()
        errs.append((got.double() - ref.double()).abs().max().item())
        if not (torch.equal(got, ref) and torch.equal(got, again)):
            fail(f"hist_masked_f32 root pass ({label}) differs from its "
                 f"plain version: max |diff| {errs[-1]}")

    def k2_root():
        return H._hist_f_cuda(pbins, prows, None, rgh, B, lid=rlid, sl=rsl)
    ms = time_ms(torch, k2_root, 20)
    graph = graph_ms(torch, k2_root)
    host = host_us(torch, k2_root)
    plain = time_ms(torch, lambda: H._hist_plain(pbins, None, rlid, rgh, rsl,
                                                 B, rows=prows), 3, 1)
    bms, by = bound_ms(Nr * (F4 + 4 + 12) + 4 + F * 3 * B * 4, 3.0 * F * Nr)
    print(f"[kernels] hist_masked_f32 root pass: C=N={Nr} F={F} K=1 B={B} "
          f"max_abs_err={max(errs):.3g} ms={ms:.4f} graph_ms={graph:.4f} "
          f"host_us={host:.1f} plain_ms={plain:.4f} bound_ms={bms:.4f} "
          f"({by})", flush=True)
    del got, ref

    # ---- K3: the training-score add, T=1, S=255, N=2M -------------------
    table = torch.as_tensor(rng.randn(1, 255).astype(np.float32), device=dev)
    ids = torch.as_tensor(rng.randint(-1, 255, size=Nr).astype(np.int32),
                          device=dev)
    score = torch.as_tensor(rng.randn(1, Nr).astype(np.float32), device=dev)
    got = LK._lookup_cuda(table, ids, score)
    ref = LK._lookup_plain(table, ids, score)
    torch.cuda.synchronize()
    err = (got - ref).abs().max().item()
    if not torch.equal(got, ref):
        fail(f"table_lookup differs from its plain version: {err}")
    ms = time_ms(torch, lambda: LK._lookup_cuda(table, ids, score), 50)
    graph = graph_ms(torch, lambda: LK._lookup_cuda(table, ids, score))
    plain = time_ms(torch, lambda: LK._lookup_plain(table, ids, score), 10)
    # no single PyTorch call adds into the score and zeroes out-of-range
    # ids, so K3 has no library time; one index_select over in-range ids
    # (neither) is printed as a note
    ids_in = ids.clamp(0, 254).long()
    sel = time_ms(torch, lambda: torch.index_select(table[0], 0, ids_in), 50)
    bms, by = bound_ms(Nr * 4 + 255 * 4 + 2 * Nr * 4, Nr)
    rows.append(dict(name="table_lookup", route="cuda",
                     source="lightgbm_tpu_torch/csrc/lookup.cu",
                     replaces="lightgbm_tpu/ops/lookup.py:23",
                     max_abs_err=err, ms=ms, graph_ms=graph, plain_ms=plain,
                     bound_ms=bms, bound_by=by, library_ms=None))
    print(f"[kernels] table_lookup (fused add): T=1 S=255 N={Nr} "
          f"max_abs_err={err} ms={ms:.4f} graph_ms={graph:.4f} "
          f"plain_ms={plain:.4f} "
          f"index_select_ms={sel:.4f} bound_ms={bms:.4f} ({by})",
          flush=True)

    # ---- K3: one level of the valid-set walk, T=5 node fields, S=254
    # nodes, no addend ------------------------------------------------------
    Nv, T, Sw = VALID_ROWS, 5, 254
    wtab = torch.as_tensor(rng.randn(T, Sw).astype(np.float32), device=dev)
    wids = torch.as_tensor(rng.randint(0, Sw, size=Nv).astype(np.int32),
                           device=dev)
    got = LK._lookup_cuda(wtab, wids)
    ref = LK._lookup_plain(wtab, wids)
    torch.cuda.synchronize()
    werr = (got - ref).abs().max().item()
    if not torch.equal(got, ref):
        fail(f"table_lookup (walk) differs from its plain version: {werr}")
    wms = time_ms(torch, lambda: LK._lookup_cuda(wtab, wids), 50)
    wplain = time_ms(torch, lambda: LK._lookup_plain(wtab, wids), 10)
    wids_l = wids.long()
    wsel = time_ms(torch, lambda: torch.index_select(wtab, 1, wids_l), 50)
    wbms, wby = bound_ms(Nv * 4 + T * Sw * 4 + T * Nv * 4, T * Nv)
    print(f"[kernels] table_lookup (walk step): T={T} S={Sw} N={Nv} "
          f"max_abs_err={werr} ms={wms:.4f} plain_ms={wplain:.4f} "
          f"index_select_ms={wsel:.4f} bound_ms={wbms:.4f} ({wby})",
          flush=True)

    # ---- K4: partition, S=256, N=2M, F=28, over each feed: the int8
    # [F, N] store the learner passes and the int32 one ------------------
    S = 256
    tbl = np.zeros((7, S), np.float32)
    act = rng.rand(S - 1) < 0.5
    tbl[0, :-1] = np.where(act, rng.randint(0, F, S - 1), 0)
    tbl[1, :-1] = np.where(act, rng.randint(0, 255, S - 1), 0)
    tbl[3, :-1] = np.where(act, np.arange(S - 1) + 128, 0)
    tbl[5] = float(1 << 30)
    tblt = torch.as_tensor(tbl, device=dev)
    plid = torch.as_tensor(rng.randint(0, 128, size=Nr).astype(np.int32),
                           device=dev)
    feeds = partition_feeds(torch, pbins)
    ref = P._partition_plain(pbins, plid, tblt)
    errs, times = [], {}
    for label, b in feeds:
        def k4(b=b):
            return P._partition_cuda(b, plid, tblt)
        got, again = k4(), k4()
        feed_ref = P._partition_plain(b, plid, tblt)
        torch.cuda.synchronize()
        errs.append((got - ref).abs().max().item())
        if not (torch.equal(got, feed_ref) and torch.equal(got, ref)
                and torch.equal(got, again)):
            fail(f"partition_rows ({label}) differs from its plain version: "
                 f"{errs[-1]}")
        times[label] = dict(ms=time_ms(torch, k4, 50),
                            graph_ms=graph_ms(torch, k4),
                            gather_mb=partition_gather_bytes(
                                torch, b, plid, tblt) / 1e6)
    plain = time_ms(torch, lambda: P._partition_plain(feeds[0][1], plid,
                                                      tblt), 10)
    # the learner's feed, the int8 store: a byte a bin
    mine = times[feeds[0][0]]
    del got, again, feed_ref, feeds
    bms, by, n_split = partition_bound(torch, plid, tblt, 1)
    rows.append(dict(name="partition_rows", route="cuda",
                     source="lightgbm_tpu_torch/csrc/partition.cu",
                     replaces="lightgbm_tpu/ops/partition.py:76",
                     max_abs_err=float(max(errs)), ms=mine["ms"],
                     graph_ms=mine["graph_ms"], plain_ms=plain,
                     bound_ms=bms, bound_by=by, library_ms=None))
    print(f"[kernels] partition_rows: S={S} N={Nr} F={F} "
          f"splitting_rows={n_split} ms={mine['ms']:.4f} "
          f"graph_ms={mine['graph_ms']:.4f} plain_ms={plain:.4f} "
          f"bound_ms={bms:.4f} ({by}); by feed: {json.dumps(times)}",
          flush=True)
    rows.append(split_kernel_row(torch))
    return rows


def split_case(torch, k, F, B, seed, dev):
    """Histograms [k, F, 3, B] of dyadic values (gradients in 1/64,
    hessians in 1/256, whole counts), so that every prefix sum is exact
    in float64 and any scan order gives the same bits: each leaf's 255
    bins, 15% of them empty (ties across thresholds), in another order in
    every feature, and feature 1 a copy of feature 0 (ties across
    features); the leaves' totals [k, 3]; [F] metadata with categorical
    features and a partial feature mask."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    u = 255

    def draw(fn, *a):
        return fn(*a, generator=gen, device=dev)
    leaf = torch.stack([
        torch.round(draw(torch.randn, k, u) * 256) / 64,
        (torch.round(draw(torch.rand, k, u) * 511) + 1) / 256,
        draw(torch.randint, 1, 40, (k, u)).float()], dim=1)
    leaf *= (draw(torch.rand, k, 1, u) >= 0.15).float()
    perm = torch.argsort(draw(torch.rand, k, F, u), dim=-1)
    perm[:, 1] = perm[:, 0]
    hist = torch.zeros(k, F, 3, B, device=dev)
    hist[..., :u] = torch.gather(leaf[:, None].expand(k, F, 3, u), 3,
                                 perm[:, :, None].expand(k, F, 3, u))
    sums = leaf.double().sum(dim=-1).float()
    is_cat = draw(torch.rand, F) < 0.1
    fmask = draw(torch.rand, F) < 0.9
    is_cat[:2] = False
    fmask[:2] = True
    return (hist, sums, torch.full((F,), u, dtype=torch.int64, device=dev),
            is_cat, fmask)


def split_kernel_row(torch):
    """The split search (csrc/split.cu) against its plain version on the
    card at the main path's shapes, bit for bit (a NaN leaf output
    matching a NaN) and from run to run: the rounds learner's chunk
    (both children of 84 splits, F=28, B=256, the can-split gate on,
    written into a per-leaf table) and a root (k=1).
    Returns the chunk's {"kernels"} row."""
    from lightgbm_tpu_torch.ops import split as S
    dev = torch.device(GPU)
    k, F, B, L = 84, 28, 256, 255
    kw = dict(lambda_l1=0.0, lambda_l2=0.0, min_data_in_leaf=20,
              min_sum_hessian_in_leaf=1.0, min_gain_to_split=0.0,
              can_split=(20, 1.0))
    ha, sa, nb, ic, fm = split_case(torch, k, F, B, 11, dev)
    hb, sb = split_case(torch, k, F, B, 12, dev)[:2]
    sb[: k // 4, 1] = 1.5           # under twice the hessian floor: gated
    rng = np.random.RandomState(13)
    rows = torch.as_tensor(rng.permutation(L)[:2 * k], device=dev)
    sel = torch.as_tensor(rng.rand(k) < 0.5, device=dev)
    args = (sel, rows[:k], rows[k:], ha, sa, hb, sb, nb, ic, fm)

    def kern(out):
        S.split_children(out, *args, **kw)

    def plain(out):
        S.write_children(
            out, sel, rows[:k], rows[k:],
            S._best_split_plain(ha, nb, ic, fm, sa[:, 0], sa[:, 1],
                                sa[:, 2], **kw),
            S._best_split_plain(hb, nb, ic, fm, sb[:, 0], sb[:, 1],
                                sb[:, 2], **kw))

    tabs = [torch.full((L, 11), -np.inf, device=dev) for _ in range(3)]
    plain(tabs[0])
    kern(tabs[1])
    kern(tabs[2])
    root_args = (ha[:1], nb, ic, fm, sa[:1, 0], sa[:1, 1], sa[:1, 2])
    root = [S.best_split(*root_args, **kw) for _ in range(2)]
    root_ref = S._best_split_plain(*root_args, **kw)
    torch.cuda.synchronize()
    for label, got, again, ref in (("chunk", tabs[1], tabs[2], tabs[0]),
                                   ("root", root[0], root[1], root_ref)):
        # the same bits, but for the payload of a 0/0 leaf output's NaN,
        # which the card's division and PyTorch's may set differently
        nan = torch.isnan(got)
        bits = [torch.where(nan, 0, x.view(torch.int32))
                for x in (got, ref)]
        bad = (bits[0] != bits[1]) | (nan != torch.isnan(ref))
        twice = torch.equal(got.view(torch.int32), again.view(torch.int32))
        if bool(bad.any()) or not twice:
            r = int(bad.any(dim=-1).nonzero()[0, 0]) if bool(bad.any()) \
                else 0
            fail(f"split_search ({label}): {int(bad.sum())} fields differ "
                 f"from the plain version (by field {bad.sum(0).tolist()}"
                 f"; row {r}: {got[r].tolist()} against {ref[r].tolist()})"
                 f", two calls the same bits: {twice}")
    if not bool(torch.isfinite(tabs[0][rows, 0]).any()):
        fail("split_search check: no leaf of the chunk found a split")
    out = tabs[1]
    ms = time_ms(torch, lambda: kern(out), 50)
    gms = graph_ms(torch, lambda: kern(out))
    pms = time_ms(torch, lambda: plain(out), 10)
    rms = time_ms(torch, lambda: S.best_split(*root_args, **kw), 50)
    rplain = time_ms(torch, lambda: S._best_split_plain(*root_args, **kw),
                     10)
    bms, by = bound_ms(2 * k * F * 3 * B * 4, 0)
    print(f"[kernels] split_search: chunk k={k} F={F} B={B} both sides "
          f"ms={ms:.4f} graph_ms={gms:.4f} plain_ms={pms:.4f} "
          f"bound_ms={bms:.5f} ({by}); root k=1 ms={rms:.4f} "
          f"plain_ms={rplain:.4f}; bitwise equal to the plain version",
          flush=True)
    return dict(name="split_search", route="cuda",
                source="lightgbm_tpu_torch/csrc/split.cu",
                replaces="lightgbm_tpu/ops/split.py:best_split",
                max_abs_err=0.0, ms=ms, graph_ms=gms, plain_ms=pms,
                bound_ms=bms, bound_by=by, library_ms=None)


def partition_feeds(torch, bins):
    """K4's feeds of one [F, N] store (int32, or int8 holding value - 128),
    the learner's first: the int8 store, the int32 store."""
    b8 = bins if bins.dtype == torch.int8 else (bins - 128).to(torch.int8)
    b32 = bins if bins.dtype == torch.int32 else bins.to(torch.int32) + 128
    return (("int8 [F, N]", b8), ("int32 [F, N]", b32))


def partition_feed_label(bins):
    return "int8 [F, N]" if bins.element_size() == 1 else "int32 [F, N]"


def partition_split_rows(torch, lid, tbl):
    """[N] bool: the rows whose leaf splits (new leaf > 0) on a column
    inside the store, the rows whose bin K4 reads."""
    S = tbl.shape[1]
    ok = (lid >= 0) & (lid < S)
    col = tbl[:, lid.clamp(0, S - 1).long()]
    return ok & (col[3] > 0)


def partition_bound(torch, lid, tbl, bin_bytes):
    """(bound ms, basis, splitting rows) of one K4 call: the leaf id of
    every row read and its new id written (8 B a row), the table, and
    one bin of `bin_bytes` for each row whose leaf splits."""
    N, S = lid.shape[0], tbl.shape[1]
    n_split = int(partition_split_rows(torch, lid, tbl).sum())
    return bound_ms(N * 8 + 7 * S * 4 + n_split * bin_bytes,
                    8.0 * N) + (n_split,)


def partition_gather_bytes(torch, bins_fn, lid, tbl) -> int:
    """Bytes of the distinct 32-byte sectors that K4's bin gathers touch
    on these inputs (the rows of splitting leaves only): what the gather
    costs in device memory, whatever the bin's size."""
    split = partition_split_rows(torch, lid, tbl)
    n = split.nonzero()[:, 0]
    col = tbl[0, lid[n].long()].long()
    F, N = bins_fn.shape
    keep = (col >= 0) & (col < F)
    n, col = n[keep], col[keep]
    addr = (col * N + n) * bins_fn.element_size()
    return int(torch.unique(addr // 32).numel()) * 32


def phase_ctr_setup(lt, rows):
    """The ctr training and valid Datasets, built once (phase 4)."""
    from lightgbm_tpu_torch.synth import CTR_PARAMS, synth_ctr
    params = dict(CTR_PARAMS, device_type=GPU)
    t0 = time.perf_counter()
    X, y, g = synth_ctr(rows, CTR_FEATURES, CTR_DENSITY)
    Xv, yv, gv = synth_ctr(CTR_VALID_ROWS, CTR_FEATURES, CTR_DENSITY,
                           seed=7)
    Xv = Xv.toarray()
    synth_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ds = lt.Dataset(X, y, group=g, params=params).construct()
    train_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    vs = lt.Dataset(Xv, yv, group=gv, reference=ds,
                    params=params).construct()
    valid_s = time.perf_counter() - t0
    sp = ds._inner.sparse
    if sp is None or vs._inner.sparse is None:
        fail("the ctr datasets did not build the sparse store")
    # the column-sorted entry streams K7/K8 read, built on the card from
    # the ELL arrays as the rounds learner builds them
    from lightgbm_tpu_torch.ops.sparse_streams import build_sparse_streams
    import torch
    cols, binsv, zb = ds._inner.sparse_triple(torch.device(GPU))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    streams = build_sparse_streams(cols, binsv, sp.num_columns)
    torch.cuda.synchronize()
    streams_s = time.perf_counter() - t0
    st = dict(rows=len(y), features=CTR_FEATURES,
              store_columns=sp.num_columns, nnz=sp.nnz,
              ell_width=sp.nnz_capacity, synth_s=synth_s,
              setup_binning_s=ds._inner.setup_seconds["binning"],
              setup_store_s=ds._inner.setup_seconds["store"],
              setup_train_total_s=train_s, setup_valid_s=valid_s,
              streams_s=streams_s, streams_bytes=streams.nbytes,
              streams_build_peak_bytes=torch.cuda.max_memory_allocated()
              - base, streams_stored_bins=streams.num_bins,
              streams_longest_column=int(
                  (streams.col_off[1:] - streams.col_off[:-1]).max()))
    print(f"[ctr setup] {json.dumps(st)}", flush=True)
    del X
    return params, ds, vs, Xv, (cols, binsv, zb, streams)


def sparse_pass_inputs(torch, H, N, K, seed):
    """Leaf ids (some leaves unslotted), slots (two empty) and gradient
    rows — dyadic and real — of one K-slot sparse pass over N rows."""
    dev = torch.device(GPU)
    rng = np.random.RandomState(seed)
    lid_np = rng.randint(0, K + 9, N).astype(np.int32)
    sl_np = np.arange(K, dtype=np.int32)
    sl_np[[K // 4, (3 * K) // 5]] = -1                  # empty slots
    m = (rng.rand(N) > 0.05).astype(np.float32)
    dy = np.stack([np.round(rng.randn(N) * 8) / 8 * m,
                   np.round(rng.rand(N) * 16) / 32 * m, m])
    real = np.stack([rng.randn(N) * m, rng.rand(N) * m, m])
    return (torch.as_tensor(lid_np, device=dev),
            torch.as_tensor(sl_np, device=dev),
            torch.as_tensor(dy.astype(np.float32), device=dev),
            torch.as_tensor(real.astype(np.float32), device=dev))


def whole_pass_check(torch, H, sp, lid, gh, sl, Cp, B) -> None:
    """hist_sparse_multileaf(int8) — the pass the learner makes, zero bins
    and the one dequantize included — against hist_sparse_xla over the
    ELL arrays: bitwise, as both sum the same integers."""
    full = H.hist_sparse_multileaf(sp, lid, gh, sl, num_columns_padded=Cp,
                                   num_bins_padded=B, input_dtype="int8")
    plain_full = H.hist_sparse_xla(sp[0], sp[1], sp[2], lid, gh, sl,
                                   num_columns_padded=Cp,
                                   num_bins_padded=B, input_dtype="int8")
    if not torch.equal(full, plain_full):
        fail(f"hist_sparse_multileaf (int8, K={sl.shape[0]}, B={B}) "
             "differs from hist_sparse_xla on the card")
    del full, plain_full
    gc.collect()
    torch.cuda.empty_cache()


def slot_totals_check(torch, SS, srow, vals, K: int) -> dict:
    """The slot-totals kernels against their plain version on one pass's
    inputs (phase 5): int32 bitwise, float32 within n * 2^-23 * sum|x|
    of each total (both sides reorder n additions, each within
    n * 2^-24 * sum|x| of the exact sum); timed, with the bound (the slot
    and three values of every row read once, [K, 3] written) and one
    index_add_, which computes the same function.  Returns its
    {"kernels"} row."""
    quant = not vals.is_floating_point()
    got = SS._slot_totals_cuda(srow, vals, K)
    ref = SS.slot_totals_plain(srow, vals, K)
    torch.cuda.synchronize()
    err = (got.double() - ref.double()).abs().max().item()
    if quant:
        if not torch.equal(got, ref):
            fail(f"slot totals (int32) differ from their plain version: "
                 f"max |diff| {err}")
    else:
        ta = SS.slot_totals_plain(srow, vals.abs(), K).double()
        tol = ta[:, 2:3] * 2.0 ** -23 * ta
        if ((got.double() - ref.double()).abs() > tol).any():
            fail(f"slot totals (float32) beyond n*2^-23*sum|x|: max |diff| "
                 f"{err}")
    N = srow.shape[0]
    ms = time_ms(torch, lambda: SS._slot_totals_cuda(srow, vals, K), 20)
    plain = time_ms(torch, lambda: SS.slot_totals_plain(srow, vals, K), 20)
    out = torch.zeros((K + 1, 3), dtype=vals.dtype, device=srow.device)
    idx, vt = srow.long(), vals.t()
    lib = time_ms(torch, lambda: out.zero_().index_add_(0, idx, vt), 20)
    bms, by = bound_ms(N * 16 + K * 12, 3.0 * N)
    dtype = "int32" if quant else "float32"
    print(f"[sparse kernels] slot_totals ({dtype}): N={N} K={K} "
          f"max_abs_err={err:.3g} ms={ms:.4f} plain_ms={plain:.4f} "
          f"library_ms={lib:.4f} bound_ms={bms:.4f} ({by})", flush=True)
    return dict(name="slot_totals", route="cuda",
                source="lightgbm_tpu_torch/csrc/hist_sparse.cu",
                replaces="lightgbm_tpu/ops/histogram.py:963",
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms,
                bound_by=by, library_ms=lib)


def phase_sparse_kernels(torch, H, SS, ds, sp):
    """K7 / K8 against their plain version on the ctr store (phase 5)."""
    dev = torch.device(GPU)
    cols, binsv, zb, streams = sp
    N, R = cols.shape
    Cp, B, K = streams.num_columns, 128, CTR_SLOTS
    lid, sl, gh_dy, gh = sparse_pass_inputs(torch, H, N, K, 11)
    nnz = ds._inner.sparse.nnz
    rows = []
    for name, input_dtype, replaces in (
            ("hist_sparse_int8", "int8",
             "lightgbm_tpu/ops/histogram.py:1180"),
            ("hist_sparse_f32", "float32",
             "lightgbm_tpu/ops/histogram.py:1133")):
        quant = input_dtype == "int8"
        srow, vals, tot, scale = H._sparse_pass(lid, gh, sl, input_dtype)
        tot_row = slot_totals_check(torch, SS, srow, vals, K)
        if not quant:
            rows.append(tot_row)
        errs = [sparse_check(torch, H, SS, name, streams, zb, srow, vals,
                             tot, scale, K, Cp, B, quant)]
        if not quant:
            dsrow, dvals, dtot, _ = H._sparse_pass(lid, gh_dy, sl,
                                                   input_dtype)
            errs.append(sparse_check(torch, H, SS, name, streams, zb, dsrow,
                                     dvals, dtot, None, K, Cp, B, True))
            del dsrow, dvals, dtot
            gc.collect()
            torch.cuda.empty_cache()
            # phase 21a/21b: K8 and the slot totals on the real-valued
            # gradients, twice each on the same inputs
            run_to_run(torch, "a", f"{name} K={K} real-valued pass",
                       lambda: SS._hist_streams_cuda(
                           streams, zb, srow, vals, tot, None, K, Cp, B))
            run_to_run(torch, "b", f"slot totals (float32, K={K}, {N:,} "
                       "rows)", lambda: H._slot_totals(srow, vals, K))
        gc.collect()
        torch.cuda.empty_cache()
        if quant:
            whole_pass_check(torch, H, sp, lid, gh, sl, Cp, B)
        ms = time_ms(torch, lambda: SS._hist_streams_cuda(
            streams, zb, srow, vals, tot, scale, K, Cp, B), 10)
        plain = time_ms(torch, lambda: SS.hist_streams_plain(
            streams, zb, srow, vals, tot, scale, K, Cp, B), 2, 1)
        # one index_add_ over the stored entries' flattened (slot, col,
        # channel, bin) indices, built beforehand: the stored-entry sums
        # alone (no zero bins, no dequantize)
        acc = vals.dtype
        r0, j0 = torch.nonzero((cols < Cp) & (srow < K)[:, None],
                               as_tuple=True)
        base = ((srow[r0].long() * Cp + cols[r0, j0].long()) * (3 * B)
                + binsv[r0, j0].long().clamp(max=B - 1))
        idx = torch.cat([base + ch * B for ch in range(3)])
        v = torch.cat([vals[ch, r0] for ch in range(3)]).to(acc)
        out = torch.zeros(K * Cp * 3 * B, dtype=acc, device=dev)
        del base, r0, j0
        lib = time_ms(torch, lambda: out.zero_().index_add_(0, idx, v), 5, 1)
        del idx, v, out
        gc.collect()
        torch.cuda.empty_cache()
        bms, by, _, entries = sparse_bound(torch, cols, srow, vals, K, Cp,
                                           B)
        rows.append(dict(name=name, route="cuda",
                         source="lightgbm_tpu_torch/csrc/hist_sparse.cu",
                         replaces=replaces, max_abs_err=max(errs), ms=ms,
                         plain_ms=plain, bound_ms=bms, bound_by=by,
                         library_ms=lib))
        print(f"[sparse kernels] {name}: N={N} R={R} nnz={nnz} "
              f"(of rows in a slot, with a value: {entries}) K={K} Cp={Cp} "
              f"B={B} "
              f"max_abs_err={max(errs):.3g} ms={ms:.4f} "
              f"plain_ms={plain:.4f} library_ms={lib:.4f} "
              f"bound_ms={bms:.4f} ({by})", flush=True)
        del srow, vals, tot, scale

    # K7 at K=84 (LEAVES_PER_BATCH), B=256: alone and through the whole
    # pass, bitwise; once as the module's constants have it, once with
    # slot tiles and long-column chunks forced (every column of more than
    # 2^15 entries in chunks, slots in tiles of 20)
    K84, B256 = 84, 256
    lid, sl, _, gh = sparse_pass_inputs(torch, H, N, K84, 12)
    srow, vals, tot, scale = H._sparse_pass(lid, gh, sl, "int8")
    nb = min(streams.num_bins, B256)
    for budget, chunk in ((SS.SPARSE_SMEM_BUDGET, SS.SPARSE_BLOCK_ENTRIES),
                          (20 * 3 * (nb | 1) * 4, 1 << 15)):
        saved = SS.SPARSE_SMEM_BUDGET, SS.SPARSE_BLOCK_ENTRIES
        SS.SPARSE_SMEM_BUDGET, SS.SPARSE_BLOCK_ENTRIES = budget, chunk
        try:
            k_tile = SS.slot_tile(K84, nb, budget, 3)
            plan = streams.plan(chunk)
            err = sparse_check(torch, H, SS, "hist_sparse_int8", streams, zb,
                               srow, vals, tot, scale, K84, Cp, B256, True)
            gc.collect()
            torch.cuda.empty_cache()
            whole_pass_check(torch, H, sp, lid, gh, sl, Cp, B256)
            ms = time_ms(torch, lambda: SS._hist_streams_cuda(
                streams, zb, srow, vals, tot, scale, K84, Cp, B256), 5)
        finally:
            SS.SPARSE_SMEM_BUDGET, SS.SPARSE_BLOCK_ENTRIES = saved
        bms, by, _, entries = sparse_bound(torch, cols, srow, vals, K84, Cp,
                                           B256)
        print(f"[sparse kernels] hist_sparse_int8 K={K84} B={B256} nb={nb} "
              f"k_tile={k_tile} slot tiles={-(-K84 // k_tile)} chunk={chunk} "
              f"chunked columns={plan.n_long} chunks={plan.n_parts} "
              f"max_abs_err={err:.3g} ms={ms:.4f} bound_ms={bms:.4f} ({by})",
              flush=True)
    del lid, sl, gh, srow, vals, tot, scale
    gc.collect()
    torch.cuda.empty_cache()
    return rows


def phase_learner_passes(torch, lt, H, SS, params, ds, sp):
    """K7 / K8 at the pass shapes the learner makes (end of phase 5): one
    tree per dtype on the ctr store, with the kernel's wrapper recording
    each pass's inputs; every recorded pass is then held against the
    plain version (int8 bitwise, float32 within n * 2^-23 * sum|x|) and
    timed, and their sums over the tree are printed."""
    real = SS._hist_streams_cuda
    cols = sp[0]
    for dtype, name in (("float32", "hist_sparse_f32"),
                        ("int8", "hist_sparse_int8")):
        passes = []

        def record(st, zb, srow, vals, tot, scale, K, Cp, B):
            passes.append((st, zb, srow.clone(), vals.clone(), tot.clone(),
                           None if scale is None else scale.clone(), K, Cp,
                           B))
            return real(st, zb, srow, vals, tot, scale, K, Cp, B)
        SS._hist_streams_cuda = record
        try:
            lt.train(dict(params, histogram_dtype=dtype), ds, 1,
                     verbose_eval=False)
        finally:
            SS._hist_streams_cuda = real
        per = []
        for i, (st, zb, srow, vals, tot, scale, K, Cp, B) in \
                enumerate(passes):
            err = sparse_check(torch, H, SS, name, st, zb, srow, vals, tot,
                               scale, K, Cp, B, name == "hist_sparse_int8")
            ms = time_ms(torch, lambda: real(st, zb, srow, vals, tot, scale,
                                             K, Cp, B), 10)
            plain = time_ms(torch, lambda: SS.hist_streams_plain(
                st, zb, srow, vals, tot, scale, K, Cp, B), 2, 1)
            bms, by, n_slotted, entries = sparse_bound(torch, cols, srow,
                                                       vals, K, Cp, B)
            per.append(dict(K=K, rows=n_slotted, entries=entries,
                            max_abs_err=err, ms=ms, plain_ms=plain,
                            bound_ms=bms, bound_by=by))
            print(f"[learner passes] {name} pass {i}: K={K} rows in a slot "
                  f"{n_slotted} entries {entries} max_abs_err={err:.3g} "
                  f"ms={ms:.4f} plain_ms={plain:.4f} bound_ms={bms:.4f} "
                  f"({by})", flush=True)
        del passes
        gc.collect()
        torch.cuda.empty_cache()
        tree = dict(passes=len(per),
                    ms_per_tree=sum(p["ms"] for p in per),
                    plain_ms_per_tree=sum(p["plain_ms"] for p in per),
                    bound_ms_per_tree=sum(p["bound_ms"] for p in per),
                    largest=max(per, key=lambda p: p["ms"]))
        print(f"[learner passes] {name} per tree: {json.dumps(tree)}",
              flush=True)


# phase 21's parts, run beside the phases whose data they share: seconds
# by part, and the set-up seconds and binners of phases 17 and 20b
P21 = {"s": {}, "setup": {}}


def run_to_run(torch, part: str, label: str, fn, calls: int = 2) -> None:
    """Phase 21: `calls` calls of fn on the same inputs, each result (a
    tensor or a tuple of them) bitwise the first call's."""
    t0 = time.perf_counter()
    first = fn()
    first = first if isinstance(first, tuple) else (first,)
    for _ in range(calls - 1):
        again = fn()
        again = again if isinstance(again, tuple) else (again,)
        for a, b in zip(first, again):
            if not torch.equal(a, b):
                n = int((a != b).sum()) if a.shape == b.shape else -1
                fail(f"[phase 21{part}] {label}: {n} of {a.numel()} values "
                     "differ between two calls on the same inputs")
        del again
    del first
    torch.cuda.synchronize()
    took = time.perf_counter() - t0
    P21["s"][part] = P21["s"].get(part, 0.0) + took
    print(f"[phase 21{part}] {label}: {calls} calls bitwise equal "
          f"({took:.2f} s)", flush=True)


def ctr_train_twice(torch, lt, params, ds, vs, bst, res) -> None:
    """Phase 21c: phase 6's float32 training again, the same 12
    iterations: one model string and the same NDCG@1..5 at every
    iteration, bit for bit."""
    n = bst.num_trees()
    ref = bst.model_to_string()
    t0 = time.perf_counter()
    res2 = {}
    again = lt.train(params, ds, n, valid_sets=[vs], evals_result=res2,
                     verbose_eval=False)
    got = again.model_to_string()
    if got != ref:
        a, b = ref.splitlines(), got.splitlines()
        i = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                 min(len(a), len(b)))
        fail(f"[phase 21c] ctr float32, {n} iterations: two trainings give "
             f"two models; first differing line {i}: "
             f"{a[i][:120] if i < len(a) else None!r} vs "
             f"{b[i][:120] if i < len(b) else None!r}")
    if res2 != res:
        fail("[phase 21c] ctr float32: the valid NDCG differs between two "
             "trainings of one model")
    took = time.perf_counter() - t0
    P21["s"]["c"] = took
    print(f"[phase 21c] ctr float32, {n} iterations, trained twice: one "
          f"model string ({len(ref)} chars), NDCG@1..5 equal at every "
          f"iteration ({took:.2f} s)", flush=True)
    del again


def ctr_metrics_twice(torch, lt, ds, bst) -> None:
    """Phase 21d: AUC (labels > 0), NDCG@1..5 and MAP@1..5 of the ctr
    training scores (500,000 rows, 25,000 queries) on the card, three
    calls each: bitwise."""
    from lightgbm_tpu_torch.config import config_from_params
    from lightgbm_tpu_torch.metrics import create_metric
    dev = torch.device(GPU)
    md = ds._inner.metadata
    score = bst._gbdt.train_score.score
    for name in ("ndcg", "map", "auc"):
        m = create_metric(name, config_from_params({"device_type": GPU}))
        m.init(md, ds._inner.num_data, dev)
        run_to_run(torch, "d", f"{name} of the ctr training scores",
                   lambda: torch.stack([v for _, v in m.eval(score)]), 3)


def drive_ctr(torch, lt, kernels, dataset_mod, params, ds, vs, Xv,
              warmup, timed, rows_ok=None, res=None):
    """lightgbm_tpu_torch.train on the built ctr Datasets, NDCG@1..5 of
    the valid set every iteration (into `res` when given); counts zeroed
    before, read after.  s/iter as in `drive`.  `rows_ok` (a bool mask)
    limits the comparison of the device valid scores with the host walk
    to those rows."""
    gc.collect()
    kernels.reset_launches()
    dataset_mod.reset_sparse_fallbacks()
    n, marks = warmup + timed, []
    res = {} if res is None else res
    torch.cuda.synchronize()
    t = time.perf_counter()
    bst = lt.train(params, ds, n, valid_sets=[vs], evals_result=res,
                   callbacks=[steady_window(torch, warmup, n, marks)],
                   verbose_eval=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    if bst.num_trees() != n:
        fail(f"ctr training stopped early: {bst.num_trees()} of {n}")
    launches = dict(kernels.LAUNCHES)
    fallbacks = dataset_mod.sparse_fallbacks()
    nd5 = res["valid_0"]["ndcg@5"]
    dev_raw = bst._gbdt.valid_sets[0][2].score[0].double().cpu().numpy()
    t = time.perf_counter()
    host_raw = host_walk(bst, Xv, raw_score=True)
    predict_s = time.perf_counter() - t
    if rows_ok is not None:
        dev_raw, host_raw = dev_raw[rows_ok], host_raw[rows_ok]
    st = dict(s_per_iter=(marks[1] - marks[0]) / timed, train_wall_s=wall,
              ndcg={k: [v[0], v[-1]] for k, v in res["valid_0"].items()},
              syncs_per_tree=statistics.mean(bst._gbdt.host_syncs_per_tree),
              launches=launches,
              launches_per_tree={k: v / n for k, v in launches.items() if v},
              sparse_fallbacks=fallbacks,
              valid_walk_vs_host=float(np.abs(dev_raw - host_raw).max()),
              predict_s=predict_s,
              peak_device_gb=torch.cuda.max_memory_allocated() / 1e9)
    if not (math.isfinite(nd5[0]) and math.isfinite(nd5[-1])
            and nd5[-1] >= nd5[0]):
        fail(f"valid NDCG@5 went {nd5[0]} -> {nd5[-1]}")
    if fallbacks:
        fail(f"a sparse store was densified {fallbacks} times")
    if st["valid_walk_vs_host"] > 1e-4:
        fail("device valid scores disagree with the host walk: "
             f"{st['valid_walk_vs_host']}")
    return bst, st


def phase_ctr_main(torch, lt, kernels, dataset_mod, params, ds, vs, Xv):
    out = {}
    for dtype, name in (("float32", "hist_sparse_f32"),
                        ("int8", "hist_sparse_int8")):
        torch.cuda.reset_peak_memory_stats()
        res = {}
        bst, st = drive_ctr(torch, lt, kernels, dataset_mod,
                            dict(params, histogram_dtype=dtype), ds, vs, Xv,
                            2, 10, res=res)
        print(f"[ctr main] {dtype}: {json.dumps(st)}", flush=True)
        for k in (name, "table_lookup", "slot_totals", "split_search"):
            if st["launches"][k] <= 0:
                fail(f"ctr main path ({dtype}) never launched {k}")
        out[dtype] = st
        if dtype == "float32":
            ctr_train_twice(torch, lt, dict(params, histogram_dtype=dtype),
                            ds, vs, bst, res)
            ctr_metrics_twice(torch, lt, ds, bst)
        del bst
    return out


def drive(torch, lt, kernels, params, X, y, Xv, yv, warmup, timed):
    """Train through lightgbm_tpu_torch.train (the valid set's AUC each
    iteration) and predict with Booster.predict, with the launch counts
    zeroed before and read after.  s/iter excludes set-up and warm-up:
    the host clock over iterations warmup+1 .. warmup+timed of one train,
    between device synchronisations at the end of iteration warmup and of
    the last (`steady_window`)."""
    kernels.reset_launches()
    t0 = time.perf_counter()
    ds = lt.Dataset(X, y, params=params).construct()
    vs = lt.Dataset(Xv, yv, reference=ds, params=params).construct()
    setup_s = time.perf_counter() - t0
    n, res, marks = warmup + timed, {}, []
    torch.cuda.synchronize()
    t = time.perf_counter()
    bst = lt.train(params, ds, n, valid_sets=[vs], evals_result=res,
                   callbacks=[steady_window(torch, warmup, n, marks)],
                   verbose_eval=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    if bst.num_trees() != n:
        fail(f"training stopped early: {bst.num_trees()} of {n} trees")
    t = time.perf_counter()
    pred = bst.predict(Xv)
    predict_s = time.perf_counter() - t
    launches = dict(kernels.LAUNCHES)
    syncs = bst._gbdt.host_syncs_per_tree
    return bst, dict(setup_s=setup_s,
                     s_per_iter=(marks[1] - marks[0]) / timed,
                     train_wall_s=wall, auc=res["valid_0"]["auc"][-1],
                     syncs_per_tree=statistics.mean(syncs),
                     predict_s=predict_s, launches=launches), pred, (ds, vs)


def phase_main(torch, lt, kernels):
    from lightgbm_tpu_torch.synth import NORTH_STAR_PARAMS, synth_higgs
    X, y = synth_higgs(MAIN_ROWS)
    Xv, yv = synth_higgs(VALID_ROWS, seed=7)
    params = dict(NORTH_STAR_PARAMS, device_type=GPU)
    bst, st, pred, (ds, vs) = drive(torch, lt, kernels, params, X, y, Xv,
                                    yv, 2, 10)
    print(f"[main] int8: {json.dumps(st)}", flush=True)
    for k in ("hist_masked_int8", "table_lookup", "partition_rows",
              "split_search"):
        if st["launches"][k] <= 0:
            fail(f"main path (int8) never launched {k}")
    if not (pred.shape == (VALID_ROWS,) and np.all(np.isfinite(pred))
            and np.all((pred >= 0) & (pred <= 1))):
        fail("Booster.predict gave non-finite or out-of-range values")
    if not (math.isfinite(st["auc"]) and st["auc"] > 0.75):
        fail(f"valid AUC {st['auc']} is not a trained model's")
    # the host f64 walk of the model against the device-scored valid set
    dev_raw = bst._gbdt.valid_sets[0][2].score[0].double().cpu().numpy()
    host_raw = host_walk(bst, Xv, raw_score=True)
    walk_err = float(np.abs(dev_raw - host_raw).max())
    print(f"[main] device valid score vs host walk: max |diff| {walk_err}",
          flush=True)
    if walk_err > 1e-4:
        fail(f"device valid scores disagree with the host walk: {walk_err}")
    params32 = dict(params, histogram_dtype="float32")
    _, st32, _, _ = drive(torch, lt, kernels, params32, X, y, Xv, yv, 2, 10)
    print(f"[main] float32: {json.dumps(st32)}", flush=True)
    print(f"[main] float32: s/iter {st32['s_per_iter']:.4f} valid AUC "
          f"{st32['auc']:.6f}", flush=True)
    for k in ("hist_masked_f32", "table_lookup", "partition_rows",
              "split_search"):
        if st32["launches"][k] <= 0:
            fail(f"main path (float32) never launched {k}")
    if not (math.isfinite(st32["auc"]) and st32["auc"] > 0.75):
        fail(f"float32 valid AUC {st32['auc']} is not a trained model's")
    return st, st32, params, ds, vs, Xv, bst


def tree_sums(per, label):
    """Print the per-tree sums of a replay's calls (ms by events around
    each call, graph ms, plain ms, bound ms) and, by rows a call, how
    they split."""
    tree = dict(calls=len(per), ms_per_tree=sum(p["ms"] for p in per),
                graph_ms_per_tree=sum(p["graph_ms"] for p in per),
                plain_ms_per_tree=sum(p["plain_ms"] for p in per),
                bound_ms_per_tree=sum(p["bound_ms"] for p in per),
                largest=max(per, key=lambda p: p["ms"]))
    buckets = {}
    for lo, hi in ((1_000_000, None), (100_000, 1_000_000),
                   (10_000, 100_000), (0, 10_000)):
        sel = [p for p in per if p["rows"] >= lo
               and (hi is None or p["rows"] < hi)]
        if sel:
            buckets[f"rows>={lo}"] = dict(
                calls=len(sel), ms=sum(p["ms"] for p in sel),
                graph_ms=sum(p["graph_ms"] for p in sel),
                bound_ms=sum(p["bound_ms"] for p in sel))
    tree["by_rows"] = buckets
    print(f"[tree replay] {label} per tree: {json.dumps(tree)}", flush=True)


def reorder_tol(torch, plain_fn, vals):
    """Per-cell bound on a float histogram's reordering: n * 2^-23 *
    sum|x| over the cell's n positions (n float additions in any order
    lie within n * 2^-24 * sum|x| of the exact sum, and the kernel and
    the plain version's index_add_ both reorder); `plain_fn(v)` sums
    the values v [3, C] as the checked call does."""
    s = plain_fn(torch.stack([vals[0].abs(), vals[1].abs(),
                              torch.ones_like(vals[2])])).double()
    return s[:, :, 2:3] * 2.0 ** -23 * s


def phase_rounds_tree(torch, lt, H, params, ds, label):
    """The dense histogram kernel of the rounds learner on every call of
    one tree: K1 when params ask for int8 histograms, K2 for float32.
    The wrapper records each call's inputs during a one-tree train; each
    call is then held against its plain version (over the slot runs'
    bounds for the gathered feed, the leaf ids for the masked one) and
    run twice: K1 bitwise, K2 within n * 2^-23 * sum|x| a cell
    (`reorder_tol`) and bitwise from run to run; then timed and given
    its bound."""
    name = "_hist_f_cuda" if params.get("histogram_dtype") == "float32" \
        else "_hist_q_cuda"
    kname = "hist_masked_f32" if name == "_hist_f_cuda" \
        else "hist_masked_int8"
    real = getattr(H, name)
    calls = []

    def record(bins, rows, row_idx, vals, B, **kw):
        calls.append((bins, rows, None if row_idx is None
                      else row_idx.clone(), vals.clone(), B,
                      {k: v.clone() if torch.is_tensor(v) else v
                       for k, v in kw.items()}))
        return real(bins, rows, row_idx, vals, B, **kw)
    setattr(H, name, record)
    try:
        lt.train(params, ds, 1, verbose_eval=False)
    finally:
        setattr(H, name, real)
    per = []
    for i, (bins, rows, row_idx, vals, B, kw) in enumerate(calls):
        lid, sl, base = kw.get("lid"), kw.get("sl"), kw.get("base")
        rb = kw.get("round_bf16", False)
        F, C = bins.shape[0], vals.shape[1]

        def run():
            return real(bins, rows, row_idx, vals, B, **kw)
        F4 = rows.rows.shape[1] if rows is not None else \
            F * bins.element_size()
        if base is not None:
            def plain_fn(v=vals):
                return H._segments_plain(bins, rows, row_idx, v, base, B,
                                         rb)
            K, n = base.numel() - 1, int(base[-1])
            nbytes = n * (F4 + 4 + 12) + (K + 1) * 8
        else:
            def plain_fn(v=vals):
                return H._hist_plain(bins, row_idx, lid, v, sl, B, rb,
                                     rows=rows)
            K = sl.numel()
            n = int(torch.isin(lid, sl).sum())
            nbytes = C * 4 + n * (F4 + 12)
        got, again, ref = run(), run(), plain_fn()
        torch.cuda.synchronize()
        err = (got.double() - ref.double()).abs().max().item()
        if vals.is_floating_point():
            ok = bool(((got.double() - ref.double()).abs()
                       <= reorder_tol(torch, plain_fn, vals)).all())
        else:
            ok = torch.equal(got, ref)
        if not (ok and torch.equal(got, again)):
            fail(f"{kname} on call {i} of the {label} tree differs from its "
                 f"plain version (max |diff| {err})")
        del got, again, ref
        ms = time_ms(torch, run, 10)
        graph = graph_ms(torch, run, 5)
        plain = time_ms(torch, plain_fn, 2, 1)
        bms, by = bound_ms(nbytes + K * F * 3 * B * 4, 3.0 * F * n)
        per.append(dict(feed="gathered" if base is not None else "masked",
                        K=K, rows=n, nb=rows.num_bins if rows is not None
                        else B, max_abs_err=err, ms=ms, graph_ms=graph,
                        plain_ms=plain, bound_ms=bms, bound_by=by))
        print(f"[tree replay] {kname} ({label}) call {i}: "
              f"{json.dumps(per[-1])}", flush=True)
    del calls
    gc.collect()
    torch.cuda.empty_cache()
    if not per:
        fail(f"the {label} tree launched no {kname}")
    tree_sums(per, f"{kname} ({label})")


def phase_partition_tree(torch, lt, P, params, ds, label):
    """Kernel K4 on every call of one tree: the wrapper records each
    call's inputs during a one-tree train; each call is then held
    bitwise against its plain version and run twice (bitwise), timed on
    the feed the learner passed and, by graph, on the other feed of the
    same store (`partition_feeds`), and given its bound."""
    real = P._partition_cuda
    calls = []

    def record(bins_fn, leaf_id, tbl):
        calls.append((bins_fn, leaf_id.clone(), tbl.clone()))
        return real(bins_fn, leaf_id, tbl)
    P._partition_cuda = record
    try:
        lt.train(params, ds, 1, verbose_eval=False)
    finally:
        P._partition_cuda = real
    if not calls:
        fail(f"the {label} tree launched no partition_rows")
    per, others, feeds = [], {}, {}
    for i, (bins_fn, lid, tbl) in enumerate(calls):
        def run():
            return real(bins_fn, lid, tbl)
        got, again = run(), run()
        ref = P._partition_plain(bins_fn, lid, tbl)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        if not (torch.equal(got, ref) and torch.equal(got, again)):
            fail(f"partition_rows on call {i} of the {label} tree differs "
                 f"from its plain version (max |diff| {err})")
        del got, again, ref
        mine = partition_feed_label(bins_fn)
        bms, by, n_split = partition_bound(
            torch, lid, tbl, 1 if mine != "int32 [F, N]" else 4)
        per.append(dict(feed=mine, rows=n_split, max_abs_err=err,
                        ms=time_ms(torch, run, 20),
                        graph_ms=graph_ms(torch, run),
                        plain_ms=time_ms(torch, lambda: P._partition_plain(
                            bins_fn, lid, tbl), 2, 1),
                        bound_ms=bms, bound_by=by,
                        gather_mb=partition_gather_bytes(
                            torch, bins_fn, lid, tbl) / 1e6))
        # the other feeds of the same store, built once
        key = id(bins_fn)
        if key not in feeds:
            feeds[key] = partition_feeds(torch, bins_fn)
        for flabel, b in feeds[key]:
            if flabel == mine:
                continue
            o = others.setdefault(flabel, dict(graph_ms=0.0, gather_mb=0.0))
            o["graph_ms"] += graph_ms(torch, lambda: real(b, lid, tbl))
            o["gather_mb"] += partition_gather_bytes(torch, b, lid,
                                                     tbl) / 1e6
        print(f"[tree replay] partition_rows ({label}) call {i}: "
              f"{json.dumps(per[-1])}", flush=True)
    del calls, feeds
    gc.collect()
    torch.cuda.empty_cache()
    tree_sums(per, f"partition_rows ({label})")
    print(f"[tree replay] partition_rows ({label}) per tree, the other "
          f"feed: {json.dumps(others)}", flush=True)


def phase_k5_tree(torch, lt, H, params, ds):
    """Kernel K5 on every call of one onehot exact-learner tree: the
    wrapper records each call's inputs during a one-tree train; each call
    is then checked as in phase 9 (count channel bitwise, the others
    within n * 2^-23 * sum|x|, two runs bitwise), timed and given its
    bound."""
    real = H._from_indices_cuda
    calls = []

    def record(bins_t, gp, hp, idx, B, input_dtype="float32", count=None,
               nb=None):
        # the learner writes none of these after the call
        calls.append((bins_t, gp, hp, idx, B, input_dtype, count, nb))
        return real(bins_t, gp, hp, idx, B, input_dtype, count, nb)
    H._from_indices_cuda = record
    try:
        with serial_exact():
            lt.train(dict(params, tree_growth="exact"), ds, 1,
                     verbose_eval=False)
    finally:
        H._from_indices_cuda = real
    per = []
    for i, (bt, gp, hp, idx, B, dt, count, nb) in enumerate(calls):
        err = gathered_check(torch, H, f"hist_gathered (tree call {i})", bt,
                             gp, hp, idx, B, count, nb, False)
        def run():
            return real(bt, gp, hp, idx, B, dt, count, nb)
        ms = time_ms(torch, run, 10)
        graph = graph_ms(torch, run, 5)
        plain = time_ms(torch, lambda: H._from_indices_plain(
            bt, gp, hp, idx, B, dt, count, nb), 1, 1)
        n = idx.numel() if count is None else count
        bms, by = gathered_bound(bt, n, B)
        per.append(dict(cap=idx.numel(), rows=n, max_abs_err=err, ms=ms,
                        graph_ms=graph, plain_ms=plain, bound_ms=bms,
                        bound_by=by))
    del calls
    gc.collect()
    torch.cuda.empty_cache()
    tree_sums(per, "hist_gathered (onehot, exact learner)")


def compare_first_trees(label, tc, tg, m_c, m_g, metric):
    """First trees of the CPU and card runs: identical, unless their
    first differing split is an f32 gain tie; metrics within 1e-4."""
    n = min(tc.num_leaves, tg.num_leaves) - 1
    diff = [i for i in range(n)
            if (tc.split_feature[i], tc.threshold_in_bin[i])
            != (tg.split_feature[i], tg.threshold_in_bin[i])]
    print(f"[card-vs-cpu] {label}: leaves cpu={tc.num_leaves} "
          f"cuda={tg.num_leaves} differing splits={len(diff)} {metric} "
          f"cpu={m_c} cuda={m_g}", flush=True)
    if diff or tc.num_leaves != tg.num_leaves:
        i = diff[0] if diff else n
        gc_, gg = float(tc.split_gain[i]), float(tg.split_gain[i])
        tie = (diff and abs(gc_ - gg) <= 1e-5 * max(abs(gc_), abs(gg)))
        print(f"[card-vs-cpu] {label}: first differing split at node {i}: "
              f"cpu (feature {tc.split_feature[i]}, bin "
              f"{tc.threshold_in_bin[i]}, gain {gc_!r}) vs cuda (feature "
              f"{tg.split_feature[i]}, bin {tg.threshold_in_bin[i]}, gain "
              f"{gg!r}); f32 gain tie: {bool(tie)}", flush=True)
        if not tie:
            fail(f"card and CPU grew different first trees ({label})")
    if not abs(m_c - m_g) <= 1e-4:
        fail(f"card and CPU valid {metric} differ ({label}): {m_c} vs "
             f"{m_g}")


def phase_onehot_setup(lt):
    """The onehot training and valid Datasets, built once (phase 8)."""
    from lightgbm_tpu_torch.synth import ONEHOT_PARAMS, synth_onehot
    params = dict(ONEHOT_PARAMS, device_type=GPU)
    t0 = time.perf_counter()
    X, y = synth_onehot(ONEHOT_ROWS)
    Xv, yv = synth_onehot(ONEHOT_VALID_ROWS, seed=7)
    synth_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ds = lt.Dataset(X, y, params=params).construct()
    train_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    vs = lt.Dataset(Xv, yv, reference=ds, params=params).construct()
    valid_s = time.perf_counter() - t0
    inner = ds._inner
    st = dict(rows=inner.num_data, features=inner.num_features,
              store_columns=inner.num_store_columns,
              conflict_rows=inner.bundle_conflict_rows,
              max_store_bins=inner.max_num_bin, synth_s=synth_s,
              setup_binning_s=inner.setup_seconds["binning"],
              setup_store_s=inner.setup_seconds["store"],
              setup_train_total_s=train_s, setup_valid_s=valid_s)
    print(f"[onehot setup] {json.dumps(st)}", flush=True)
    if (inner.num_features != 240 or inner.num_store_columns != 40
            or inner.bundle_conflict_rows != 0
            or vs._inner.bundle_plan is not inner.bundle_plan):
        fail("EFB did not bundle the onehot workload's 240 features into "
             "40 store columns with 0 conflicting rows")
    del X
    return params, ds, vs, Xv


def gathered_check(torch, H, name, bins_t, gp, hp, idx, B, count, nb,
                   exact: bool) -> float:
    """K5 against its plain version on one histogram's inputs: bitwise
    when `exact`, else every cell within n * 2^-23 * sum|x|; the count
    channel always bitwise; two runs of the kernel bitwise equal.
    Returns the max |diff|."""
    got = H._from_indices_cuda(bins_t, gp, hp, idx, B, "float32", count, nb)
    again = H._from_indices_cuda(bins_t, gp, hp, idx, B, "float32", count,
                                 nb)
    ref = H._from_indices_plain(bins_t, gp, hp, idx, B, "float32", count, nb)
    torch.cuda.synchronize()
    err = (got.double() - ref.double()).abs().max().item()
    if not torch.equal(got, again):
        fail(f"{name}: two runs of the kernel differ")
    if not torch.equal(got[:, 2], ref[:, 2]):
        fail(f"{name}: the count channel differs from the plain version")
    if exact and not torch.equal(got, ref):
        fail(f"{name} differs from its plain version: max |diff| {err}")
    if not exact:
        absum = H._from_indices_plain(bins_t, gp.abs(), hp.abs(), idx, B,
                                      "float32", count, nb)
        tol = absum[:, 2:3].double() * 2.0 ** -23 * absum.double()
        bad = ((got.double() - ref.double()).abs() > tol).sum().item()
        if bad:
            fail(f"{name}: {bad} cells beyond n*2^-23*sum|x| (max |diff| "
                 f"{err})")
    return err


def gathered_bound(bins_t, count, B):
    """(bound ms, basis) of one K5 call over `count` rows: the row ids,
    the rows' bins in the feed's bytes and their (grad, hess), read once;
    the [C, 3, B] output written once; three adds per (row, column)."""
    C = bins_t.shape[1]
    return bound_ms(count * (4 + C * bins_t.element_size() + 8)
                    + C * 3 * B * 4, 3.0 * C * count)


def multirow_check(torch, H, gb, vals, B, exact: bool) -> float:
    """K6 against its plain version, as gathered_check: bitwise when
    `exact`, else every cell within n * 2^-23 * sum|x|; two runs of the
    kernel bitwise equal."""
    got = H._multirow_cuda(gb, vals, B, "float32")
    again = H._multirow_cuda(gb, vals, B, "float32")
    ref = H.hist_multileaf_xla(gb, vals, num_bins_padded=B)
    torch.cuda.synchronize()
    err = (got.double() - ref.double()).abs().max().item()
    if not torch.equal(got, again):
        fail("hist_multirow: two runs of the kernel differ")
    del again
    if exact and not torch.equal(got, ref):
        fail(f"hist_multirow differs from its plain version: {err}")
    if not exact:
        absum = H.hist_multileaf_xla(gb, vals.abs(), num_bins_padded=B)
        ones = torch.ones((1, gb.shape[1]), device=gb.device)
        n = H.hist_multileaf_xla(gb, ones, num_bins_padded=B)
        tol = n.double() * 2.0 ** -23 * absum.double()
        bad = ((got.double() - ref.double()).abs() > tol).sum().item()
        if bad:
            fail(f"hist_multirow: {bad} cells beyond n*2^-23*sum|x| (max "
                 f"|diff| {err})")
    return err


def phase_gathered_kernels(torch, H, ds):
    """K5 and K6 against their plain versions at the exact learner's
    shapes (phase 9).  Returns their {"kernels"} rows: K5 at the onehot
    root, K6 at M=128."""
    from lightgbm_tpu_torch.learner.common import (padded_bin_count,
                                                   sentinel_bins_feed)
    dev = torch.device(GPU)
    rng = np.random.RandomState(13)
    inner = ds._inner
    N = inner.num_data

    def values(n):
        """(real, dyadic) padded gradient pairs [n+1] on the card."""
        out = []
        for g, h in ((rng.randn(n), rng.rand(n) * 0.25),
                     (np.clip(np.round(rng.randn(n) * 64), -1000, 1000) / 64,
                      np.round(rng.rand(n) * 64) / 256)):
            out.append(tuple(torch.as_tensor(
                np.concatenate([v, [0.0]]).astype(np.float32), device=dev)
                for v in (g, h)))
        return out

    # the exact learner's byte feeds: the onehot store (40 columns of 7
    # bins) and a north-star-shaped one (28 columns of 255 bins)
    onehot_bt = torch.as_tensor(sentinel_bins_feed(inner), device=dev)
    onehot_B, onehot_nb = padded_bin_count(inner.max_num_bin), \
        inner.max_num_bin
    ns_bt = torch.as_tensor(np.concatenate([
        rng.randint(0, 255, size=(N, 28)), np.zeros((1, 28))]).astype(
            np.uint8), device=dev)
    leaf_idx = np.full(LEAF_CAP, N, np.int32)
    leaf_idx[:LEAF_ROWS] = np.sort(rng.choice(N, LEAF_ROWS, replace=False))
    root_idx = torch.arange(N, dtype=torch.int32, device=dev)
    shapes = (("onehot root", onehot_bt, onehot_B, onehot_nb, root_idx, N),
              ("onehot leaf", onehot_bt, onehot_B, onehot_nb,
               torch.as_tensor(leaf_idx, device=dev), LEAF_ROWS),
              ("north-star root", ns_bt, 256, 255, root_idx, N))
    rows = []
    for label, bt, B, nb, idx, count in shapes:
        C = bt.shape[1]
        (g, h), (gd, hd) = values(N)
        errs = [gathered_check(torch, H, f"hist_gathered ({label})", bt, gd,
                               hd, idx, B, count, nb, True),
                gathered_check(torch, H, f"hist_gathered ({label})", bt, g, h,
                               idx, B, count, nb, False)]
        def k5():
            return H._from_indices_cuda(bt, g, h, idx, B, "float32", count,
                                        nb)
        ms = time_ms(torch, k5, 20)
        graph = graph_ms(torch, k5)
        host = host_us(torch, k5)
        plain = time_ms(torch, lambda: H._from_indices_plain(
            bt, g, h, idx, B, "float32", count, nb), 3, 1)
        live = idx[:count].long()
        E = int(live.numel())
        b = bt[live].long()                                     # [E, C]
        f = torch.arange(C, device=dev)[None, :]
        flat = torch.cat([((f * 3 + ch) * B + b).reshape(-1)
                          for ch in range(3)])
        vals = torch.cat([v[live][:, None].expand(E, C).reshape(-1)
                          for v in (g, h, torch.ones_like(g))])
        out = torch.zeros(C * 3 * B, device=dev)
        del b
        lib = time_ms(torch, lambda: out.zero_().index_add_(0, flat, vals),
                      5, 1)
        del flat, vals, out
        gc.collect()
        torch.cuda.empty_cache()
        bms, by = gathered_bound(bt, E, B)
        print(f"[gathered kernels] hist_gathered {label}: cap={idx.numel()} "
              f"rows={E} C={C} B={B} nb={nb} feed={bt.dtype} "
              f"max_abs_err={max(errs):.3g} ms={ms:.4f} "
              f"graph_ms={graph:.4f} host_us={host:.1f} "
              f"plain_ms={plain:.4f} library_ms={lib:.4f} "
              f"bound_ms={bms:.4f} ({by})", flush=True)
        if label == "onehot root":
            rows.append(dict(name="hist_gathered", route="cuda",
                             source="lightgbm_tpu_torch/csrc/hist_gathered.cu",
                             replaces="lightgbm_tpu/ops/histogram.py:178",
                             max_abs_err=max(errs), ms=ms, graph_ms=graph,
                             plain_ms=plain, bound_ms=bms, bound_by=by,
                             library_ms=lib))
    del onehot_bt, ns_bt
    gc.collect()
    torch.cuda.empty_cache()

    # ---- K6: M value rows over an [F, C] store ---------------------------
    F, M, B, C = 28, K6_ROWS, 256, ONEHOT_ROWS
    gb = torch.as_tensor(rng.randint(0, 255, size=(F, C)).astype(np.int32),
                         device=dev)
    vals = torch.as_tensor(rng.randn(M, C).astype(np.float32), device=dev)
    dy = torch.round(vals * 16) / 16
    errs = [multirow_check(torch, H, gb, dy, B, True),
            multirow_check(torch, H, gb, vals, B, False)]
    del dy
    def k6():
        return H._multirow_cuda(gb, vals, B, "float32")
    ms = time_ms(torch, k6, 10)
    graph = graph_ms(torch, k6)
    plain = time_ms(torch, lambda: H.hist_multileaf_xla(
        gb, vals, num_bins_padded=B), 2, 1)
    # one scatter_add_: bins broadcast over the M rows, values over the F
    # features (stride-0 views, nothing materialised)
    index = gb.long()[:, None, :].expand(F, M, C)
    src = vals[None, :, :].expand(F, M, C)
    out = torch.zeros((F, M, B), device=dev)
    lib = time_ms(torch, lambda: out.zero_().scatter_add_(2, index, src), 5,
                  1)
    del index, src, out
    bms, by = bound_ms(F * C * 4 + M * C * 4 + F * M * B * 4, float(F) * M * C)
    lay = H._k6_layout(F, M, B, C, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    print(f"[gathered kernels] hist_multirow: F={F} M={M} C={C} B={B} "
          f"layout={json.dumps(lay._asdict())} max_abs_err={max(errs):.3g} "
          f"ms={ms:.4f} graph_ms={graph:.4f} plain_ms={plain:.4f} "
          f"library_ms={lib:.4f} bound_ms={bms:.4f} ({by})", flush=True)
    rows.append(dict(name="hist_multirow", route="cuda",
                     source="lightgbm_tpu_torch/csrc/hist_gathered.cu",
                     replaces="lightgbm_tpu/ops/histogram.py:252",
                     max_abs_err=max(errs), ms=ms, graph_ms=graph,
                     plain_ms=plain, bound_ms=bms, bound_by=by,
                     library_ms=lib))
    del gb, vals
    gc.collect()
    torch.cuda.empty_cache()
    return rows


def drive_onehot(torch, lt, kernels, params, ds, vs, Xv, warmup, timed):
    """lightgbm_tpu_torch.train on the built onehot Datasets, the valid
    AUC every iteration; counts zeroed before, read after; s/iter as in
    `drive`."""
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    n, res, marks = warmup + timed, {}, []
    torch.cuda.synchronize()
    t = time.perf_counter()
    bst = lt.train(params, ds, n, valid_sets=[vs], evals_result=res,
                   callbacks=[steady_window(torch, warmup, n, marks)],
                   verbose_eval=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = dict(kernels.LAUNCHES)
    if bst.num_trees() != n:
        fail(f"onehot training stopped early: {bst.num_trees()} of {n}")
    auc = res["valid_0"]["auc"]
    models = bst._gbdt.models
    dev_raw = bst._gbdt.valid_sets[0][2].score[0].double().cpu().numpy()
    walk_err = float(np.abs(dev_raw - host_walk(bst, Xv,
                                                raw_score=True)).max())
    st = dict(learner=type(bst._gbdt.learner).__name__,
              s_per_iter=(marks[1] - marks[0]) / timed, train_wall_s=wall,
              auc_first=auc[0], auc_last=auc[-1],
              leaves_per_tree=statistics.mean(t.num_leaves for t in models),
              syncs_per_tree=statistics.mean(bst._gbdt.host_syncs_per_tree),
              launches=launches,
              launches_per_tree={k: v / n for k, v in launches.items() if v},
              valid_walk_vs_host=walk_err,
              peak_device_gb=torch.cuda.max_memory_allocated() / 1e9)
    if not (math.isfinite(auc[0]) and math.isfinite(auc[-1])):
        fail(f"onehot valid AUC is not finite: {auc}")
    if walk_err > 1e-4:
        fail(f"onehot device valid scores disagree with the host walk: "
             f"{walk_err}")
    return st, models[0]


def phase_onehot_main(torch, lt, kernels, params, ds, vs, Xv):
    with serial_exact():
        st, first = drive_onehot(torch, lt, kernels,
                                 dict(params, tree_growth="exact"), ds, vs,
                                 Xv, 2, 10)
    print(f"[onehot main] exact: {json.dumps(st)}", flush=True)
    if st["learner"] != "SerialTreeLearner":
        fail(f"tree_growth=exact ran {st['learner']}")
    if st["launches"]["hist_gathered"] <= 0:
        fail("the exact learner never launched hist_gathered")
    if not st["auc_last"] > st["auc_first"]:
        fail(f"onehot valid AUC did not rise: {st['auc_first']} -> "
             f"{st['auc_last']}")
    rd, _ = drive_onehot(torch, lt, kernels, params, ds, vs, Xv, 2, 4)
    print(f"[onehot main] rounds: {json.dumps(rd)}", flush=True)
    if rd["learner"] != "RoundsTreeLearner":
        fail(f"tree_growth=auto ran {rd['learner']}")
    for k in ("hist_masked_int8", "table_lookup", "partition_rows"):
        if rd["launches"][k] <= 0:
            fail(f"the rounds learner on the bundled store never launched "
                 f"{k}")
    return st, rd, first


def phase_lossless(lt):
    """Bundled against unbundled training on the card (phase 11)."""
    from lightgbm_tpu_torch.synth import ONEHOT_PARAMS, synth_onehot
    X, y = synth_onehot(ONEHOT_COMPARE)
    for growth in ("exact", "auto"):
        out = {}
        for eb in (True, False):
            p = dict(ONEHOT_PARAMS, device_type=GPU, tree_growth=growth,
                     enable_bundle=eb)
            ds = lt.Dataset(X, y, params=p)
            bst = lt.train(p, ds, 1, verbose_eval=False)
            if (ds._inner.bundle_plan is not None) != eb:
                fail(f"enable_bundle={eb} did not decide the bundling")
            out[eb] = (bst._gbdt.models[0], bst.predict(X))
        compare_first_trees(f"onehot bundled vs not ({growth})", out[True][0],
                            out[False][0], 0.0, 0.0, "-")
        d = float(np.abs(out[True][1] - out[False][1]).max())
        print(f"[lossless] {growth}: predictions max |diff| {d}", flush=True)
        if d > 1e-5:
            fail(f"bundled and unbundled predictions differ by {d} "
                 f"({growth})")


def phase_onehot_card_vs_cpu(lt):
    """The exact learners on the CPU and on the card (phase 12): the
    serial learner on both, and the card's fused builder (its `exact`)
    against the CPU's serial learner."""
    from lightgbm_tpu_torch.synth import (NORTH_STAR_PARAMS, ONEHOT_PARAMS,
                                          synth_higgs, synth_onehot)
    for label, data, base in (("onehot exact", synth_onehot, ONEHOT_PARAMS),
                              ("higgs exact", synth_higgs,
                               NORTH_STAR_PARAMS)):
        X, y = data(ONEHOT_COMPARE)
        Xv, yv = data(ONEHOT_COMPARE // 5, seed=7)
        out = {}
        for run, dev in (("cpu", "cpu"), ("serial", GPU), ("fused", GPU)):
            p = dict(base, device_type=dev, tree_growth="exact")
            ds = lt.Dataset(X, y, params=p)
            res = {}
            with (serial_exact() if run == "serial"
                  else contextlib.nullcontext()):
                bst = lt.train(p, ds, 5, valid_sets=[lt.Dataset(
                    Xv, yv, reference=ds)], evals_result=res,
                    verbose_eval=False)
            want = "FusedTreeLearner" if run == "fused" \
                else "SerialTreeLearner"
            if type(bst._gbdt.learner).__name__ != want:
                fail(f"{label} ({run}) ran {type(bst._gbdt.learner)}")
            out[run] = (bst._gbdt.models[0], res["valid_0"]["auc"][-1])
        compare_first_trees(label, out["cpu"][0], out["serial"][0],
                            out["cpu"][1], out["serial"][1], "auc")
        compare_first_trees(f"{label}, fused (card) vs serial (CPU)",
                            out["cpu"][0], out["fused"][0], out["cpu"][1],
                            out["fused"][1], "auc")


def phase_card_vs_cpu(lt):
    from lightgbm_tpu_torch.synth import (CTR_PARAMS, NORTH_STAR_PARAMS,
                                          synth_ctr, synth_higgs)
    X, y = synth_higgs(COMPARE_ROWS)
    Xv, yv = synth_higgs(COMPARE_ROWS // 5, seed=7)
    out = {}
    for dev in ("cpu", GPU):
        # both sides pinned to the gathered row feed (auto resolves to
        # masked on the CPU), so they quantize the same rows per pass
        p = dict(NORTH_STAR_PARAMS, device_type=dev, hist_rows="gathered")
        ds = lt.Dataset(X, y, params=p)
        res = {}
        bst = lt.train(p, ds, 5, valid_sets=[lt.Dataset(Xv, yv,
                                                        reference=ds)],
                       evals_result=res, verbose_eval=False)
        out[dev] = (bst._gbdt.models[0], res["valid_0"]["auc"][-1])
    compare_first_trees("higgs", out["cpu"][0], out[GPU][0], out["cpu"][1],
                        out[GPU][1], "auc")
    n, f = CTR_COMPARE
    X, y, g = synth_ctr(n, f, CTR_DENSITY)
    Xv, yv, gv = synth_ctr(n // 5, f, CTR_DENSITY, seed=7)
    Xv = Xv.toarray()
    for dtype in ("float32", "int8"):
        out = {}
        for dev in ("cpu", GPU):
            p = dict(CTR_PARAMS, device_type=dev, histogram_dtype=dtype)
            ds = lt.Dataset(X, y, group=g, params=p)
            res = {}
            bst = lt.train(p, ds, 3, valid_sets=[lt.Dataset(
                Xv, yv, group=gv, reference=ds)], evals_result=res,
                           verbose_eval=False)
            if bst._gbdt.train_set.sparse is None:
                fail("the card-vs-CPU ctr run did not use the sparse store")
            out[dev] = (bst._gbdt.models[0], res["valid_0"]["ndcg@5"][-1])
        compare_first_trees(f"ctr {dtype}", out["cpu"][0], out[GPU][0],
                            out["cpu"][1], out[GPU][1], "ndcg@5")

def objective_workloads(n_train: int, n_valid: int):
    """Phase 13's two workloads on synth_higgs rows: the labeling
    function left unthresholded (regression), and that target cut at the
    training target's 20/40/60/80% quantiles (5 classes); the valid set
    (seed 7) follows the same rules.  Returns {objective: (X, y, Xv, yv,
    params)}."""
    from lightgbm_tpu_torch.synth import (NORTH_STAR_PARAMS,
                                          quantile_classes,
                                          synth_higgs_target)
    X, t = synth_higgs_target(n_train)
    Xv, tv = synth_higgs_target(n_valid, seed=7)
    cuts = np.quantile(t, [0.2, 0.4, 0.6, 0.8])
    reg = dict(NORTH_STAR_PARAMS, objective="regression", metric="l2")
    mc = dict(NORTH_STAR_PARAMS, objective="multiclass", num_class=CLASSES,
              metric="multi_logloss")
    return {"regression": (X, t, Xv, tv, reg),
            "multiclass": (X, quantile_classes(t, cuts), Xv,
                           quantile_classes(tv, cuts), mc)}


TREE_KERNELS = ("hist_masked_int8", "partition_rows", "table_lookup")


@contextlib.contextmanager
def tree_launches(kernels, names=TREE_KERNELS):
    """Each tree's launches of the kernels `names` (K1, K4 and K3 by
    default) while the block runs: the rounds learner's train_device is
    wrapped to snapshot the counts as each tree starts, so the counts
    between two snapshots (the last taken when the block ends) are the
    histograms, partitions and score adds (the training rows by leaf id,
    the valid walk, and any walk of earlier trees before the next tree)
    of one tree.  Yields the list that receives one entry a tree, its
    counts in the order of `names`."""
    from lightgbm_tpu_torch.learner.rounds import RoundsTreeLearner
    snaps, per_tree = [], []
    real = RoundsTreeLearner.train_device

    def wrapped(self, *a, **k):
        snaps.append([kernels.LAUNCHES[n] for n in names])
        return real(self, *a, **k)

    RoundsTreeLearner.train_device = wrapped
    try:
        yield per_tree
    finally:
        RoundsTreeLearner.train_device = real
        snaps.append([kernels.LAUNCHES[n] for n in names])
        per_tree.extend([b - a for a, b in zip(snaps[t], snaps[t + 1])]
                        for t in range(len(snaps) - 1))


def drive_objective(torch, lt, kernels, params, X, y, Xv, yv, warmup,
                    timed):
    """Train one phase-13 workload through lightgbm_tpu_torch.train, with
    the launch counts zeroed before and read after, and each class tree's
    launches of K1, K3 and K4 recorded (`tree_launches`)."""
    ds = lt.Dataset(X, y, params=params).construct()
    vs = lt.Dataset(Xv, yv, reference=ds, params=params).construct()
    n, res, marks = warmup + timed, {}, []
    kernels.reset_launches()
    with tree_launches(kernels) as per_tree:
        torch.cuda.synchronize()
        t = time.perf_counter()
        bst = lt.train(params, ds, n, valid_sets=[vs], evals_result=res,
                       callbacks=[steady_window(torch, warmup, n, marks)],
                       verbose_eval=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    g = bst._gbdt
    K = g.K
    if g.iter_ != n or len(per_tree) != n * K:
        fail(f"phase 13 ({params['objective']}): {g.iter_} of {n} "
             f"iterations, {len(per_tree)} class trees")
    metric = params["metric"]
    vals = res["valid_0"][metric]
    dev = g.valid_sets[0][2].score.double().cpu().numpy()
    host = host_walk(bst, Xv, raw_score=True).reshape(len(yv), K).T
    syncs = g.host_syncs_per_tree
    s_iter = (marks[1] - marks[0]) / timed
    return bst, dict(
        objective=params["objective"], trees_per_iteration=K,
        s_per_iter=s_iter, trees_per_s=K / s_iter, train_wall_s=wall,
        first=vals[0], last=vals[-1], metric=metric,
        syncs_per_tree=statistics.mean(syncs),
        walk_err=float(np.abs(dev - host).max()),
        launches=dict(kernels.LAUNCHES),
        min_per_tree=[min(c[i] for c in per_tree) for i in range(3)])


def phase_objectives(torch, lt, kernels, card: str):
    """Regression and 5-class multiclass through the rounds learner at
    the main path's shape (phase 13), then card against CPU."""
    data = objective_workloads(MAIN_ROWS, VALID_ROWS)
    for obj, (X, y, Xv, yv, base) in data.items():
        p = dict(base, device_type=GPU)
        _, st = drive_objective(torch, lt, kernels, p, X, y, Xv, yv, 2, 4)
        print(f"[objectives] {obj}: {json.dumps(st)}", flush=True)
        print(f"[objectives] {obj}: s/iter {st['s_per_iter']:.4f}, trees/s "
              f"{st['trees_per_s']:.2f}, host syncs/tree "
              f"{st['syncs_per_tree']:.2f}, valid {st['metric']} "
              f"{st['first']:.6f} -> {st['last']:.6f} ({card})", flush=True)
        hist, part, look = st["min_per_tree"]
        print(f"[objectives] {obj}: fewest launches in a class tree: K1 "
              f"{hist}, K4 {part}, K3 {look}", flush=True)
        if hist <= 0 or part <= 0 or look <= 0:
            fail(f"phase 13 ({obj}): a class tree launched K1 {hist}, K4 "
                 f"{part}, K3 {look} times")
        if not (math.isfinite(st["last"]) and st["last"] < st["first"]):
            fail(f"phase 13 ({obj}): valid {st['metric']} did not fall: "
                 f"{st['first']} -> {st['last']}")
        if st["walk_err"] > 1e-4:
            fail(f"phase 13 ({obj}): device valid scores disagree with "
                 f"Booster.predict(raw_score=True): {st['walk_err']}")
        del X, Xv
    del data
    gc.collect()
    torch.cuda.empty_cache()
    phase_objectives_card_vs_cpu(lt)


def phase_objectives_card_vs_cpu(lt):
    """Phase 13's workloads at 50,000 rows on the CPU and on the card."""
    small = objective_workloads(COMPARE_ROWS, COMPARE_ROWS // 5)
    for obj, (X, y, Xv, yv, base) in small.items():
        out = {}
        for dev in ("cpu", GPU):
            # both sides pinned to the gathered row feed, as in phase 7
            p = dict(base, device_type=dev, hist_rows="gathered")
            ds = lt.Dataset(X, y, params=p)
            res = {}
            bst = lt.train(p, ds, 5, valid_sets=[lt.Dataset(
                Xv, yv, reference=ds)], evals_result=res, verbose_eval=False)
            out[dev] = (bst._gbdt, res["valid_0"][base["metric"]])
        compare_class_trees(obj, out["cpu"], out[GPU], base["metric"])


def compare_class_trees(label, cpu, card, metric, tie_until: int = 1):
    """The class trees of the CPU and card runs, iteration by iteration.
    Every class tree of the first iteration (each grown from the same
    initial scores) is identical, or its first differing split is an f32
    gain tie, as phase 7 holds first trees.  Later the runs may part: the
    card's and the CPU's exp and f32 cumulative sums round differently
    in the last bit, so do the scores, and an int8 histogram then rounds
    a gradient that sits on a quantization boundary to the next integer;
    the first such difference is printed.  The valid metric of the first
    iteration, and of every iteration before the first difference,
    agrees within 1e-4; the rest is printed.  A first difference in one
    of the first `tie_until` iterations must be an f32 gain tie."""
    from lightgbm_tpu_torch.diagnostics.worlds import first_split_difference
    (gc_, mc), (gg, mg) = cpu, card
    K, first = gc_.K, 1 if gc_.boost_from_average_used else 0
    n_iter = len(mc)
    same = n_iter
    for it in range(n_iter):
        parted = False
        for k in range(K):
            tc, tg = (m.models[first + it * K + k] for m in (gc_, gg))
            i = first_split_difference(tc, tg)
            if i is None:
                continue
            parted = True
            a, b = float(tc.split_gain[i]), float(tg.split_gain[i])
            tie = abs(a - b) <= 1e-5 * max(abs(a), abs(b))
            print(f"[card-vs-cpu] {label}: iteration {it + 1} class {k}, "
                  f"node {i}: cpu (feature {tc.split_feature[i]}, bin "
                  f"{tc.threshold_in_bin[i]}, children {tc.left_child[i]} "
                  f"{tc.right_child[i]}, gain {a!r}) vs cuda (feature "
                  f"{tg.split_feature[i]}, bin {tg.threshold_in_bin[i]}, "
                  f"children {tg.left_child[i]} {tg.right_child[i]}, gain "
                  f"{b!r}); f32 gain tie: {tie}", flush=True)
            if it < tie_until and not tie:
                fail(f"card and CPU grew different trees ({label}, "
                     f"iteration {it + 1}, class {k})")
        if parted:
            same = it
            break
    checked = max(same, 1)
    print(f"[card-vs-cpu] {label}: {K} class trees an iteration, {same} of "
          f"{n_iter} iterations identical; {metric} cpu={mc} cuda={mg}",
          flush=True)
    err = max(abs(x - y) for x, y in zip(mc[:checked], mg[:checked]))
    if not err <= 1e-4:
        fail(f"card and CPU valid {metric} differ ({label}): {err}")



def phase_goss(torch, lt, kernels, params, ds, vs):
    """GOSS at the main path's shape (phase 14, part 1): 10 warm-up
    iterations at lr 0.1, then 4 on 600,000 sampled rows of 2M."""
    p = dict(params, boosting="goss", top_rate=0.2, other_rate=0.1)
    n, warm, res, marks = 14, 10, {}, []
    kernels.reset_launches()
    with tree_launches(kernels) as per_tree:
        bst = lt.train(p, ds, n, valid_sets=[vs], evals_result=res,
                       callbacks=[steady_window(torch, warm, n, marks)],
                       verbose_eval=False)
    g = bst._gbdt
    if type(g).__name__ != "GOSS" or g.iter_ != n or len(per_tree) != n:
        fail(f"GOSS: {type(g).__name__}, {g.iter_} of {n} iterations")
    auc = res["valid_0"]["auc"]
    sampled = per_tree[warm:]
    st = dict(s_per_iter=(marks[1] - marks[0]) / (n - warm),
              sampled_rows=g.bag_cnt, bag_capacity=int(g.bag_idx.numel()),
              syncs_per_tree=statistics.mean(g.host_syncs_per_tree[warm:]),
              launches=dict(kernels.LAUNCHES),
              sampled_tree_launches=sampled, auc_10=auc[warm - 1],
              auc_14=auc[-1])
    print(f"[training surface] goss: {json.dumps(st)}", flush=True)
    print(f"[training surface] goss: s/iter {st['s_per_iter']:.4f} over "
          f"the sampled iterations 11-14, {g.bag_cnt} sampled rows, host "
          f"syncs/tree {st['syncs_per_tree']:.2f}, valid AUC "
          f"{auc[warm - 1]:.6f} -> {auc[-1]:.6f}", flush=True)
    want = int(g.num_data * 0.2) + int(g.num_data * 0.1)
    if g.bag_cnt != want:
        fail(f"GOSS sampled {g.bag_cnt} rows, not {want}")
    for i, (hist, part, look) in enumerate(sampled):
        if hist <= 0 or part <= 0 or look <= 0:
            fail(f"GOSS sampled tree {warm + i + 1} launched K1 {hist}, "
                 f"K4 {part}, K3 {look} times")
    if not auc[-1] > auc[warm - 1]:
        fail(f"GOSS valid AUC did not rise over the sampled iterations: "
             f"{auc[warm - 1]} -> {auc[-1]}")
    return st


def phase_goss_card_vs_cpu(torch, lt):
    """GOSS on synth_higgs(50_000) at lr 0.5 (2 warm-up iterations), 4
    iterations on the CPU and on the card.  The first sampled
    iteration's selection, recorded on the card, is run again on the CPU
    from the same gradients: bag and amplified g/h bitwise.  The two
    runs' own first bags are compared too (equal when their gradients
    are).  Trees are identical until the first differing split, which
    must be an f32 gain tie and is printed."""
    from lightgbm_tpu_torch.boosting import goss as goss_mod
    from lightgbm_tpu_torch.synth import NORTH_STAR_PARAMS, synth_higgs
    X, y = synth_higgs(COMPARE_ROWS)
    Xv, yv = synth_higgs(COMPARE_ROWS // 5, seed=7)
    real = goss_mod._goss_select
    out = {}
    for dev in ("cpu", GPU):
        calls = []

        def record(g, h, key, **kw):
            r = real(g, h, key, **kw)
            calls.append(((g.cpu(), h.cpu(), key.clone(), kw),
                          tuple(t.cpu() for t in r)))
            return r

        p = dict(NORTH_STAR_PARAMS, device_type=dev, hist_rows="gathered",
                 boosting="goss", learning_rate=0.5)
        ds = lt.Dataset(X, y, params=p)
        res = {}
        goss_mod._goss_select = record
        try:
            bst = lt.train(p, ds, 4, valid_sets=[lt.Dataset(
                Xv, yv, reference=ds)], evals_result=res,
                verbose_eval=False)
        finally:
            goss_mod._goss_select = real
        if len(calls) != 2:
            fail(f"GOSS ({dev}) sampled {len(calls)} iterations, not 2")
        out[dev] = (bst._gbdt, res["valid_0"]["auc"], calls[0])
    (g_in, h_in, key, kw), card_sel = out[GPU][2]
    again = real(g_in, h_in, key, **kw)
    same = [torch.equal(a, b) for a, b in zip(again, card_sel)]
    print(f"[training surface] goss card vs cpu: first sampled iteration's "
          f"selection, card against CPU on the card's gradients: bag, g, "
          f"h bitwise {same}", flush=True)
    if not all(same):
        fail("GOSS selection differs between the card and the CPU")
    (cg, ch, _, _), cpu_sel = out["cpu"][2]
    inputs_equal = torch.equal(cg, g_in) and torch.equal(ch, h_in)
    bags_equal = torch.equal(cpu_sel[0], card_sel[0])
    print(f"[training surface] goss card vs cpu: the runs' own first "
          f"sampled gradients bitwise {inputs_equal} (max |diff| "
          f"{float((cg - g_in).abs().max())}), bags bitwise {bags_equal}",
          flush=True)
    if inputs_equal and not (bags_equal and all(
            torch.equal(a, b) for a, b in zip(cpu_sel, card_sel))):
        fail("GOSS drew different bags from the same gradients")
    # with the same bags every tree is held to the tie rule; bags drawn
    # from gradients that differ in the last bit hold only the warm-up
    compare_class_trees("goss", out["cpu"][:2], out[GPU][:2], "auc",
                        tie_until=4 if bags_equal else 2)


def phase_dart(torch, lt, kernels, params, ds, vs, Xv):
    """DART at the main path's shape (phase 14, part 2): drop_rate 0.1, 8
    iterations; the trees dropped each iteration and the K3 launches of
    the drops' and renormalization's walks are recorded."""
    from lightgbm_tpu_torch.boosting.dart import DART
    p = dict(params, boosting="dart", drop_rate=0.1)
    drops, walk = [], [0]
    real_drop, real_norm = DART._dropping_trees, DART._normalize

    def counted(fn):
        def run(self):
            before = kernels.LAUNCHES["table_lookup"]
            fn(self)
            walk[0] += kernels.LAUNCHES["table_lookup"] - before
        return run

    def dropping(self):
        counted(real_drop)(self)
        drops.append(len(self.drop_index))

    n, warm, res, marks = 8, 2, {}, []
    kernels.reset_launches()
    DART._dropping_trees, DART._normalize = dropping, counted(real_norm)
    try:
        bst = lt.train(p, ds, n, valid_sets=[vs], evals_result=res,
                       callbacks=[steady_window(torch, warm, n, marks)],
                       verbose_eval=False)
    finally:
        DART._dropping_trees, DART._normalize = real_drop, real_norm
    g = bst._gbdt
    dev_raw = g.valid_sets[0][2].score[0].double().cpu().numpy()
    err = float(np.abs(dev_raw - host_walk(bst, Xv, raw_score=True)).max())
    st = dict(s_per_iter=(marks[1] - marks[0]) / (n - warm),
              dropped=drops, drop_walk_k3_launches=walk[0],
              syncs_per_tree=statistics.mean(g.host_syncs_per_tree),
              launches=dict(kernels.LAUNCHES), walk_err=err,
              auc=res["valid_0"]["auc"][-1])
    print(f"[training surface] dart: {json.dumps(st)}", flush=True)
    print(f"[training surface] dart: s/iter {st['s_per_iter']:.4f}, trees "
          f"dropped per iteration {drops}, K3 launches of the drop and "
          f"renormalization walks {walk[0]}, device valid score vs "
          f"Booster.predict max |diff| {err}", flush=True)
    if type(g).__name__ != "DART" or g.iter_ != n:
        fail(f"DART: {type(g).__name__}, {g.iter_} of {n} iterations")
    if not any(drops) or walk[0] <= 0:
        fail(f"DART dropped no tree (drops {drops}, walk launches "
             f"{walk[0]})")
    if err > 1e-4:
        fail(f"DART's device valid scores disagree with "
             f"Booster.predict(raw_score=True): {err}")
    return st


def phase_resume(torch, lt, params, ds, vs, tmp):
    """Checkpoint/resume, continuation and rollback at the main path's
    shape (phase 14, parts 3 and 4)."""
    p = dict(params, learning_rate=0.5, bagging_fraction=0.8,
             bagging_freq=1, seed=3)
    res = {}
    t0 = time.perf_counter()
    full = lt.train(p, ds, 10, valid_sets=[vs], evals_result=res,
                    verbose_eval=False)
    ck = os.path.join(tmp, "ck.json")
    pc = dict(p, checkpoint_path=ck, checkpoint_interval=3)
    lt.train(pc, ds, 6, valid_sets=[vs], verbose_eval=False)
    t1 = time.perf_counter()
    resumed = lt.train(pc, ds, 10, valid_sets=[vs], verbose_eval=False)
    t2 = time.perf_counter()
    same = resumed.model_to_string() == full.model_to_string()
    print(f"[training surface] resume: uninterrupted and killed runs "
          f"{t1 - t0:.1f} s, resume to 10 {t2 - t1:.1f} s; resumed model "
          f"string equal to the uninterrupted one: {same}", flush=True)
    if not same:
        fail("the resumed model string differs from the uninterrupted one")

    model = os.path.join(tmp, "model.txt")
    full.save_model(model)
    auc10 = res["valid_0"]["auc"][-1]
    res_c = {}
    t0 = time.perf_counter()
    cont = lt.train(p, ds, 5, valid_sets=[vs], evals_result=res_c,
                    init_model=model, verbose_eval=False)
    t1 = time.perf_counter()
    # the continued run's training scores started from its init score:
    # the init model's raw predictions (Booster.predict: past its work
    # gate the device walk, f32 compares on raw features), held here
    # against the init model's own predict and the host walks
    init_score = np.asarray(ds.get_init_score()).copy()
    ds.set_init_score(None)
    init_bst = lt.Booster(params=p, model_file=model)
    n_init = len(init_bst._gbdt.models)
    raw_X = ds._raw_X if ds._raw_X is not None else ds.data
    own = init_bst.predict(raw_X, raw_score=True)
    print(f"[training surface] continuation's init score equal to the "
          f"init model's predict: {np.array_equal(init_score, own)}",
          flush=True)
    if not np.array_equal(init_score, own):
        fail("the continued run's init score is not the init model's "
             "predict")
    check_device_walk(lt, "training surface", init_bst, raw_X, own)
    auc15 = res_c["valid_0"]["auc"][-1]
    print(f"[training surface] continuation: {cont.current_iteration()} "
          f"iterations in {t1 - t0:.1f} s, valid AUC {auc10:.6f} after 10 "
          f"-> {auc15:.6f} after 15", flush=True)
    if cont.current_iteration() != 15:
        fail(f"the continued booster holds {cont.current_iteration()} "
             f"iterations, not 15")
    if not auc15 >= auc10:
        fail(f"continued valid AUC {auc15} fell below {auc10}")

    from lightgbm_tpu_torch.boosting.score_updater import ScoreUpdater
    cont.rollback_one_iter()
    cont.rollback_one_iter()
    g = cont._gbdt
    errs = []
    # the training scores started from the init model's predictions;
    # the valid scores replayed every tree of the continued model
    for su, init, trees in ((g.train_score, init_score, g.models[n_init:]),
                            (g.valid_sets[0][2], None, g.models)):
        fresh = ScoreUpdater(su.bins_fn, su.num_data, 1, g.device,
                             init_score=init, feat_tbl=su.feat_tbl)
        fresh.add_trees(trees, 1)
        errs.append(float((su.score - fresh.score).abs().max()))
    print(f"[training surface] rollback twice: {g.current_iteration()} "
          f"iterations; training scores vs the init model's predictions "
          f"plus a fresh replay of the {len(g.models) - n_init} trees "
          f"after it, valid scores vs a fresh replay of the "
          f"{len(g.models)} trees left: max |diff| {errs}", flush=True)
    if g.current_iteration() != 13 or max(errs) > 1e-5:
        fail(f"rollback: {g.current_iteration()} iterations, scores off a "
             f"fresh replay by {errs}")
    # the training scores against a replay of every tree from the binned
    # store (f64 routing by bin, as the host walk): printed, as the init
    # score's f32 routing parts from it
    su = g.train_score
    fresh = ScoreUpdater(su.bins_fn, su.num_data, 1, g.device,
                         feat_tbl=su.feat_tbl)
    fresh.add_trees(g.models, 1)
    print(f"[training surface] training scores vs a binned replay of all "
          f"{len(g.models)} trees: max |diff| "
          f"{float((su.score - fresh.score).abs().max())}", flush=True)
    return dict(resume_equal=same, auc_10=auc10, auc_15=auc15,
                rollback_err=errs)


def phase_early_stopping(lt, params, ds, vs):
    """early_stopping_rounds=3 on the valid set (phase 14, part 5)."""
    p = dict(params, learning_rate=0.5)
    res = {}
    t0 = time.perf_counter()
    bst = lt.train(p, ds, 30, valid_sets=[vs], evals_result=res,
                   early_stopping_rounds=3, verbose_eval=False)
    auc = res["valid_0"]["auc"]
    print(f"[training surface] early stopping: best_iteration "
          f"{bst.best_iteration} of {len(auc)} evaluated, valid AUC there "
          f"{auc[bst.best_iteration - 1]:.6f}, {time.perf_counter() - t0:.1f}"
          f" s", flush=True)
    if not 1 <= bst.best_iteration <= len(auc):
        fail(f"early stopping returned best_iteration {bst.best_iteration}")


def phase_training_surface(torch, lt, kernels, params, ds, vs, Xv):
    """Phase 14: GOSS, DART, checkpoint/resume, continuation, rollback
    and early stopping on phase 3's north-star datasets."""
    st = {"goss": phase_goss(torch, lt, kernels, params, ds, vs)}
    phase_goss_card_vs_cpu(torch, lt)
    st["dart"] = phase_dart(torch, lt, kernels, params, ds, vs, Xv)
    with tempfile.TemporaryDirectory() as tmp:
        st["resume"] = phase_resume(torch, lt, params, ds, vs, tmp)
    phase_early_stopping(lt, params, ds, vs)
    return st


# phase 15: the north-star serving shape (scripts/bench_serve.py:60-96):
# 500 trees of 63 leaves at depth 8 over 28 features, 20,000 training
# rows; 8 closed-loop clients of 64 rows a request for 10 s
SERVE_TREES_B = 100
SERVE_PREDICT_ROWS = 200_000
SERVE_CLIENTS, SERVE_ROWS_PER_REQ, SERVE_SECONDS = 8, 64, 10.0
# every batch the closed loop can form (1-8 requests of 64 rows)
SERVE_BUCKETS = (64, 128, 256, 512)


def serve_train(lt, seed: int, rounds: int, tmp: str, name: str):
    """bench_serve.py's model (synth.train_serve_model on
    RandomState(seed)'s rows), trained on the card; the model file and
    its .refbin sidecar written to `tmp`."""
    from lightgbm_tpu_torch.synth import train_serve_model
    t0 = time.perf_counter()
    bst, ds, X = train_serve_model(seed, rounds, device_type=GPU)
    secs = time.perf_counter() - t0
    path = os.path.join(tmp, name)
    bst.save_model(path)
    ds.save_refbin(path + ".refbin")
    depth = max(t.max_depth_grown for t in bst._gbdt.models)
    print(f"[serve] trained {name}: {bst.num_trees()} trees, "
          f"{max(t.num_leaves for t in bst._gbdt.models)} leaves at most, "
          f"depth {depth}, {secs:.1f} s on the card", flush=True)
    if bst.num_trees() != rounds:
        fail(f"serving model {name}: {bst.num_trees()} of {rounds} trees")
    return bst, X, path


def ensemble_on(torch, trees, X, device, chunk: int = 50_000):
    """predict_ensemble_any and the model-order leaf indices of `trees`
    over X on `device` (in row chunks), as host numpy."""
    from lightgbm_tpu_torch.ops import predict as PR
    stack, meta = PR.build_ensemble([trees])
    st = PR.to_device(stack, device)
    lstack, lmeta = PR.stack_ensemble([[t] for t in trees], binned=False)
    lst = PR.to_device(lstack, device)
    raw, leaf = [], []
    for a in range(0, len(X), chunk):
        xc = torch.as_tensor(np.ascontiguousarray(X[a:a + chunk],
                                                  np.float32),
                             device=device)
        raw.append(PR.predict_ensemble_any(st, xc, meta=meta)[0].cpu())
        leaf.append(PR.predict_ensemble_leaf(lst, xc, meta=lmeta).cpu())
    return (torch.cat(raw).numpy(), torch.cat(leaf, dim=1).numpy(),
            type(stack).__name__)


def serve_predictors(torch, lt, label, trees, X):
    """Card against CPU: leaf indices bitwise, raw within the bound.
    Returns the layout and the card's raw scores."""
    t0 = time.perf_counter()
    raw_g, leaf_g, layout = ensemble_on(torch, trees, X, GPU)
    t1 = time.perf_counter()
    raw_c, leaf_c, _ = ensemble_on(torch, trees, X, "cpu")
    t2 = time.perf_counter()
    err = float(np.abs(raw_g - raw_c).max())
    bound = tree_bound(trees)
    same = bool(np.array_equal(leaf_g, leaf_c))
    msg = (f"[serve] predictors, {label}: {len(trees)} trees, {layout}, "
           f"{len(X)} rows; leaf indices card == CPU: {same}; raw max "
           f"|card - CPU| {err:.3e} (bound {bound:.3e}); card "
           f"{t1 - t0:.2f} s, CPU {t2 - t1:.2f} s")
    print(msg, flush=True)
    if not same:
        fail(f"{label}: card and CPU leaf indices differ")
    if not err <= bound:
        fail(f"{label}: card and CPU raw scores differ by {err} > {bound}")
    return layout, raw_g


def serve_booster_rate(torch, lt, path, X):
    """rows/s of Booster.predict on the device path, tensorized and
    walk (one warm call each first)."""
    out = {}
    for kernel in ("tensorized", "walk"):
        bst = lt.Booster(params={"device_type": GPU,
                                 "predict_kernel": kernel},
                         model_file=path)
        bst.predict(X[:1000])
        os.environ["LIGHTGBM_TPU_DEVICE_PREDICT"] = "1"
        try:
            bst.predict(X[:50_000])
            t0 = time.perf_counter()
            pred = bst.predict(X)
            out[kernel] = len(X) / (time.perf_counter() - t0)
        finally:
            os.environ.pop("LIGHTGBM_TPU_DEVICE_PREDICT")
        if not (pred.shape == (len(X),) and np.all(np.isfinite(pred))):
            fail(f"Booster.predict ({kernel}) gave {pred.shape} or "
                 "non-finite values")
    print(f"[serve] Booster.predict rows/s on {len(X)} rows: tensorized "
          f"{out['tensorized']:.0f}, walk {out['walk']:.0f}", flush=True)
    return out


def serve_replay(torch, lt, bst):
    """The tensorized add_trees replay of phase 3's booster onto its
    training store, against the walk replay."""
    from lightgbm_tpu_torch.boosting.score_updater import ScoreUpdater
    g = bst._gbdt
    su = g.train_score
    times, scores = {}, {}
    for kernel in ("tensorized", "walk"):
        fresh = ScoreUpdater(su.bins_fn, su.num_data, g.K, g.device,
                             feat_tbl=su.feat_tbl)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fresh.add_trees(g.models, g.K, kernel)
        torch.cuda.synchronize()
        times[kernel] = time.perf_counter() - t0
        scores[kernel] = fresh.score
    err = float((scores["tensorized"] - scores["walk"]).abs().max())
    bound = tree_bound(g.models)
    print(f"[serve] replay of {len(g.models)} trees onto {su.num_data} "
          f"training rows: tensorized {times['tensorized']:.4f} s, walk "
          f"{times['walk']:.4f} s, max |diff| {err:.3e} (bound "
          f"{bound:.3e})", flush=True)
    if not err <= bound:
        fail(f"tensorized replay off the walk replay by {err} > {bound}")
    return times


def closed_loop(srv, X, path="/predict", seconds=SERVE_SECONDS):
    """SERVE_CLIENTS keep-alive clients, each sending SERVE_ROWS_PER_REQ
    rows a request as soon as its last answer came (bench_serve.py's
    closed loop).  Returns the latencies (s), the (row offset, answers)
    of every request, the wall seconds and the errors."""
    import http.client
    lat, answers, errors = [], [], []
    lock = threading.Lock()
    t_end = time.monotonic() + seconds
    span = len(X) - SERVE_ROWS_PER_REQ

    def client(idx):
        conn = http.client.HTTPConnection(srv.host, srv.port, timeout=120)
        k = 0
        try:
            while time.monotonic() < t_end:
                k += 1
                lo = (idx * 7919 + k * SERVE_ROWS_PER_REQ) % span
                body = "\n".join(json.dumps([float(v) for v in r])
                                 for r in X[lo:lo + SERVE_ROWS_PER_REQ])
                t0 = time.perf_counter()
                conn.request("POST", path, body)
                resp = conn.getresponse()
                text = resp.read().decode()
                dt = time.perf_counter() - t0
                if resp.status != 200:
                    errors.append(f"HTTP {resp.status}: {text[:200]}")
                    return
                got = np.array([json.loads(v) for v in text.split()])
                with lock:
                    lat.append(dt)
                    answers.append((lo, got))
        except Exception as e:  # noqa: BLE001 — reported by the caller
            errors.append(repr(e))
        finally:
            conn.close()

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(SERVE_CLIENTS)]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=seconds + 120)
    if any(t.is_alive() for t in threads):
        errors.append("a client did not finish")
    return lat, answers, time.monotonic() - t0, errors


def loop_stats(lat, wall):
    ms = np.sort(np.asarray(lat)) * 1e3
    n = len(ms)

    def q(p):   # nearest rank, as profiling.summary
        return float(ms[min(n - 1, max(0, math.ceil(p * n) - 1))])
    return dict(requests=n, p50_ms=q(0.5), p95_ms=q(0.95), p99_ms=q(0.99),
                requests_per_s=n / wall,
                rows_per_s=n * SERVE_ROWS_PER_REQ / wall)


def value_ref(torch, trees, X, sigmoid: float):
    """The card's predict_ensemble_any over X, after the sigmoid (the
    runtime's device transform), as float64."""
    from lightgbm_tpu_torch.ops import predict as PR
    stack, meta = PR.build_ensemble([trees])
    st = PR.to_device(stack, GPU)
    xs = torch.as_tensor(np.ascontiguousarray(X, np.float32), device=GPU)
    raw = PR.predict_ensemble_any(st, xs, meta=meta)
    return torch.sigmoid(sigmoid * raw)[0].cpu().numpy().astype(np.float64)


def check_answers(label, answers, ref):
    bad = sum(1 for lo, got in answers
              if not np.array_equal(got, ref[lo:lo + SERVE_ROWS_PER_REQ]))
    print(f"[serve] {label}: {len(answers)} answers, {bad} not bitwise "
          f"equal to predict_ensemble_any on the card", flush=True)
    if bad:
        fail(f"{label}: {bad} of {len(answers)} answers differ from "
             "predict_ensemble_any on the card")


def stats_of(srv):
    import http.client
    conn = http.client.HTTPConnection(srv.host, srv.port, timeout=60)
    try:
        conn.request("GET", "/stats")
        return json.loads(conn.getresponse().read())
    finally:
        conn.close()


def serve_loop(torch, srv, X, ref, label, card):
    """One closed loop against `srv`, checked row by row against `ref`
    and for a warm cache.  The profiling registry is reset first, so the
    server's /stats then describe this loop alone: its batches, the
    seconds of serve/execute (the runtime's predict, host and device)
    and the batcher's latency (enqueue to answer)."""
    from lightgbm_tpu_torch import profiling
    profiling.reset()
    before = stats_of(srv)["cache_misses"]
    lat, answers, wall, errors = closed_loop(srv, X)
    stats = stats_of(srv)
    after = stats["cache_misses"]
    if errors or not lat:
        fail(f"{label}: closed loop failed: {errors[:3]}")
    st = loop_stats(lat, wall)
    st["cache_misses_during_loop"] = after - before
    batches = max(stats["batches"], 1)
    st["batches"] = stats["batches"]
    st["requests_per_batch"] = stats["requests"] / batches
    st["execute_ms_per_batch"] = (
        stats["phase_totals_s"].get("serve/execute", 0.0) * 1e3 / batches)
    st["batcher_latency_ms"] = {k: stats["latency_ms"].get(k)
                                for k in ("p50", "p99")}
    print(f"[serve] {label} ({card}): {json.dumps(st)}", flush=True)
    print(f"[serve] {label}: p50 {st['p50_ms']:.3f} ms, p95 "
          f"{st['p95_ms']:.3f} ms, p99 {st['p99_ms']:.3f} ms, "
          f"{st['requests_per_s']:.1f} requests/s, {st['rows_per_s']:.0f} "
          f"rows/s; cache_misses {before} -> {after}", flush=True)
    if after != before:
        fail(f"{label}: cache_misses moved during the loop, "
             f"{before} -> {after}")
    check_answers(label, answers, ref)
    return st


def serve_costack(torch, lt, path_a, path_b, trees, X, sig):
    """Two tenants co-stacked: each tenant's answers over HTTP bitwise
    equal to its solo runtime on the card."""
    import http.client
    from lightgbm_tpu_torch.serving import (ModelCatalog, PredictionServer,
                                            PredictorRuntime)
    cat = ModelCatalog({"default": path_a, "b": path_b},
                       params={"verbose": -1, "device_type": GPU},
                       serve_quantize="raw",
                       costack=True, warmup_buckets=SERVE_BUCKETS)
    if len(cat._groups) != 1:
        fail(f"two serving tenants formed {len(cat._groups)} groups")
    group = next(iter(cat._groups.values()))
    solo = {mid: PredictorRuntime(lt.Booster(params={"device_type": GPU},
                                             model_file=p), replicas=1)
            for mid, p in (("default", path_a), ("b", path_b))}
    jobs = [(mid, 64 * i) for i in range(24) for mid in ("default", "b")]
    res, errors = {}, []

    def client(mid, lo):
        conn = http.client.HTTPConnection(srv.host, srv.port, timeout=120)
        try:
            body = "\n".join(json.dumps([float(v) for v in r])
                             for r in X[lo:lo + 64])
            conn.request("POST", f"/predict?model={mid}", body)
            resp = conn.getresponse()
            text = resp.read().decode()
            if resp.status != 200:
                errors.append(text[:200])
                return
            res[(mid, lo)] = np.array([json.loads(v) for v in text.split()])
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(repr(e))
        finally:
            conn.close()

    with PredictionServer(catalog=cat, model_poll_seconds=0) as srv:
        threads = [threading.Thread(target=client, args=j, daemon=True)
                   for j in jobs]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        stats = stats_of(srv)
    if errors or len(res) != len(jobs):
        fail(f"co-stacked requests failed: {errors[:3]}")
    bad = sum(1 for (mid, lo), got in res.items()
              if not np.array_equal(got, solo[mid].predict(X[lo:lo + 64])))
    gid = next(iter(stats["groups"]))
    g = stats["groups"][gid]
    print(f"[serve] co-stacked {g['members']} ({g['trees']} trees, "
          f"{g['costack_kernel']} kernel): {len(res)} answers, {bad} not "
          f"bitwise equal to per-tenant dispatch; group batches rows "
          f"{g['stacked_rows'] + g['segment_rows']:.0f}", flush=True)
    if bad:
        fail(f"{bad} co-stacked answers differ from per-tenant dispatch")
    ref = value_ref(torch, trees, X[:64 * 24], sig)
    if not all(np.array_equal(res[("default", lo)], ref[lo:lo + 64])
               for _, lo in jobs):
        fail("co-stacked default tenant off predict_ensemble_any")
    return {"answers": len(res), "not_bitwise": bad}


def serve_hot_swap(torch, srv, path_a, path_b, trees_b, X, sig):
    """Overwrite the default tenant's model file with model B and poll:
    the generation flips, answers follow model B, and the requests after
    the swap's warmup build nothing."""
    import http.client
    import shutil
    gen0 = srv.registry.generation
    tmp = path_a + ".swap"
    shutil.copyfile(path_b, tmp)
    shutil.copyfile(path_b + ".refbin", path_a + ".refbin")
    os.replace(tmp, path_a)
    t0 = time.perf_counter()
    swaps = srv.catalog.poll_once()
    swap_s = time.perf_counter() - t0
    gen1 = srv.registry.generation
    before = stats_of(srv)["cache_misses"]
    ref = value_ref(torch, trees_b, X[:64 * 16], sig)
    bad = 0
    conn = http.client.HTTPConnection(srv.host, srv.port, timeout=120)
    try:
        for i in range(16):
            lo = 64 * i
            body = "\n".join(json.dumps([float(v) for v in r])
                             for r in X[lo:lo + 64])
            conn.request("POST", "/predict", body)
            resp = conn.getresponse()
            text = resp.read().decode()
            if resp.status != 200 or int(
                    resp.getheader("X-Model-Generation")) != gen1:
                fail(f"after the swap: HTTP {resp.status}, generation "
                     f"{resp.getheader('X-Model-Generation')}")
            got = np.array([json.loads(v) for v in text.split()])
            bad += not np.array_equal(got, ref[lo:lo + 64])
    finally:
        conn.close()
    after = stats_of(srv)["cache_misses"]
    print(f"[serve] hot swap: {swaps} swap in {swap_s:.2f} s, generation "
          f"{gen0} -> {gen1}; 16 requests after it, {bad} not bitwise "
          f"model B's; cache_misses {before} -> {after}", flush=True)
    if swaps != 1 or gen1 != gen0 + 1:
        fail(f"hot swap: {swaps} swaps, generation {gen0} -> {gen1}")
    if bad:
        fail(f"{bad} answers after the swap are not model B's")
    if after != before:
        fail(f"hot swap: cache_misses moved {before} -> {after}")


def phase_serving(torch, lt, ns_bst, ns_Xv, card):
    """Phase 15: the predictors and the serving plane on the card."""
    from lightgbm_tpu_torch.serving import ModelRegistry, PredictionServer
    from lightgbm_tpu_torch.synth import SERVE_FEATURES, SERVE_TREES
    st = {}
    with tempfile.TemporaryDirectory() as tmp:
        bst_a, X, path_a = serve_train(lt, 0, SERVE_TREES, tmp, "a.txt")
        bst_b, _, path_b = serve_train(lt, 1, SERVE_TREES_B, tmp, "b.txt")
        trees_a = lt.Booster(params={"device_type": GPU},
                             model_file=path_a)._gbdt.models
        trees_b = lt.Booster(params={"device_type": GPU},
                             model_file=path_b)._gbdt.models
        sig = float(bst_a._gbdt.objective.sigmoid)
        X1 = np.random.RandomState(1).rand(SERVE_PREDICT_ROWS,
                                           SERVE_FEATURES)
        st["layout"], _ = serve_predictors(torch, lt, "serving model",
                                           trees_a, X1)
        _, raw = serve_predictors(torch, lt, "north-star booster",
                                  ns_bst._gbdt.models, ns_Xv)
        st["rows_off_f64_walk"] = check_device_walk(
            lt, "serve", ns_bst, ns_Xv, raw.astype(np.float64))
        st["booster_rows_per_s"] = serve_booster_rate(torch, lt, path_a, X1)
        st["replay_s"] = serve_replay(torch, lt, ns_bst)
        ref = value_ref(torch, trees_a, X, sig)
        # binned first: the raw server's hot swap overwrites path_a
        for variant in ("binned", "raw"):
            reg = ModelRegistry(path_a,
                                params={"verbose": -1, "device_type": GPU},
                                replicas=1,
                                serve_quantize=variant,
                                warmup_buckets=SERVE_BUCKETS)
            rt = reg.current()
            if rt.variant != variant or rt.replicas[0].device.type != GPU:
                fail(f"{variant} server runs {rt.variant} on "
                     f"{rt.replicas[0].device}")
            print(f"[serve] {variant} request buffer: "
                  f"{np.dtype(rt._buf_dtype).itemsize * rt._buf_cols} "
                  f"bytes a row", flush=True)
            with PredictionServer(reg, model_poll_seconds=0) as srv:
                st[variant] = serve_loop(torch, srv, X, ref,
                                         f"server, {variant}", card)
                if variant == "raw":
                    st["costack"] = serve_costack(torch, lt, path_a,
                                                  path_b, trees_a, X, sig)
                    serve_hot_swap(torch, srv, path_a, path_b, trees_b, X,
                                   sig)
    print(f"[serve] {json.dumps(st)}", flush=True)
    return st


# phase 16: the online loop and the router at scripts/bench_online.py's
# scenario (:47-53, :111-123), uncut: 28 features, a 100,000-row base,
# a 25,000-row drifted window, a 16,000-row drifted eval set, 60 trees
ONLINE_BASE_ROWS, ONLINE_WINDOW, ONLINE_EVAL = 100_000, 25_000, 16_000
ONLINE_TREES, ONLINE_REPS, ONLINE_CHUNKS = 60, 5, 5
# card refit against the CPU refit of the same model and window: the
# gradients differ in the last f32 bits (CUDA's exp against the host's),
# and each iteration's scores feed the next, so a leaf may move by a few
# f32 ulps of its gradient mass per iteration over 60 iterations
REFIT_RTOL, REFIT_ATOL = 1e-4, 1e-6
# continue mode: trees appended; the router's closed-loop rounds
CONTINUE_TREES, ROUTE_SECONDS = 5, 2.0
# the float32 path's kernels of one tree: K2, K4, K3, the split search
F32_TREE_KERNELS = ("hist_masked_f32", "partition_rows", "table_lookup",
                    "split_search")


def online_params(**kw) -> dict:
    """scripts/bench_online.py's parameters on the card."""
    from lightgbm_tpu_torch.synth import ONLINE_PARAMS
    return dict(ONLINE_PARAMS, device_type=GPU, **kw)


def auc(y, p) -> float:
    """Rank-based AUC (Mann-Whitney, average ranks over tied scores), as
    scripts/bench_online.py computes it."""
    y = np.asarray(y) > 0.5
    p = np.asarray(p, np.float64)
    order = np.argsort(p, kind="mergesort")
    _, inv, cnt = np.unique(p[order], return_inverse=True,
                            return_counts=True)
    ends = np.cumsum(cnt)
    ranks = np.empty(len(p))
    ranks[order] = ((ends - cnt + 1 + ends) / 2.0)[inv]
    npos = int(y.sum())
    nneg = len(y) - npos
    return float((ranks[y].sum() - npos * (npos + 1) / 2) / (npos * nneg))


def leaf_table(models) -> np.ndarray:
    """Every tree's leaf values, padded with NaN: [trees, max leaves]."""
    m = max(t.num_leaves for t in models)
    out = np.full((len(models), m), np.nan)
    for i, t in enumerate(models):
        out[i, : t.num_leaves] = t.leaf_value[: t.num_leaves]
    return out


def online_refit(torch, lt, bst, Xw, yw, w_drift, Xe, ye, st):
    """Part 1: LeafRefitter over a streaming window on the card (binned
    routing), first and steady refits timed; the card's leaf values
    against the CPU refit of the same model and window routed by the
    host walk; run to run bitwise; AUCs of base, refit and retrain."""
    from lightgbm_tpu_torch.dataset import Dataset as RawDataset
    from lightgbm_tpu_torch.online import LeafRefitter, refit_gbdt
    from lightgbm_tpu_torch.synth import synth_drift
    g = bst._gbdt
    cfg = g.config
    cpu = lt.Booster(params=dict(bst.params, device_type="cpu"),
                     model_str=bst.model_to_string())
    window = RawDataset.streaming_from(g.train_set, cfg,
                                       capacity=ONLINE_WINDOW)
    window.append_rows(Xw, yw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    refitter = LeafRefitter(g, window)
    stats = refitter.refit()
    torch.cuda.synchronize()
    st["refit_first_s"] = time.perf_counter() - t0
    if stats["trees_refit"] != ONLINE_TREES or refitter.device.type != GPU:
        fail(f"refit on {refitter.device}: {stats}")
    card = leaf_table(g.models)
    st["auc_refit"] = auc(ye, host_walk(bst, Xe))
    # the card's routes against the host walk's, on the same rows
    card_leaf = refitter.route_binned().cpu().numpy().T
    os.environ["LIGHTGBM_TPU_DEVICE_PREDICT"] = "0"
    try:
        host_leaf = cpu._gbdt.predict_leaf_index(Xw)
    finally:
        os.environ.pop("LIGHTGBM_TPU_DEVICE_PREDICT")
    off = card_leaf != host_leaf
    st["rows_routed_differently"] = int(off.any(axis=1).sum())
    st["row_tree_pairs_routed_differently"] = int(off.sum())
    t0 = time.perf_counter()
    refit_gbdt(cpu._gbdt, window, leaf_idx=host_leaf)
    st["cpu_refit_s"] = time.perf_counter() - t0
    ref = leaf_table(cpu._gbdt.models)
    err = np.abs(card - ref)
    ok = err <= REFIT_RTOL * np.abs(ref) + REFIT_ATOL
    st["refit_max_abs_err"] = float(np.nanmax(err))
    st["refit_max_rel_err"] = float(np.nanmax(err / np.maximum(
        np.abs(ref), 1e-12)))
    # the daemon's cycle: reset, refill with a fresh drifted window, refit
    steady = []
    for i in range(ONLINE_REPS):
        window.reset_rows()
        Xr, yr = synth_drift(ONLINE_WINDOW, w_drift, seed=100 + i)
        window.append_rows(Xr, yr)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        refitter.refit()
        torch.cuda.synchronize()
        steady.append(time.perf_counter() - t0)
    st["refit_steady_s"] = steady
    st["refit_steady_median_s"] = float(np.median(steady))
    # the first window again: the same bits (the sums add in a fixed
    # order; decay 0 makes the values independent of the last refit's)
    window.reset_rows()
    window.append_rows(Xw, yw)
    refitter.refit()
    same = bool(np.array_equal(leaf_table(g.models), card, equal_nan=True))
    print(f"[online] refit on the card: first {st['refit_first_s']:.4f} s, "
          f"steady median {st['refit_steady_median_s']:.4f} s "
          f"({', '.join(f'{t:.4f}' for t in steady)}); CPU refit "
          f"{st['cpu_refit_s']:.2f} s; {st['rows_routed_differently']} "
          f"window rows ({st['row_tree_pairs_routed_differently']} "
          f"(row, tree) pairs) routed differently by the card's binned "
          f"walk and the host walk; leaf values card - CPU: max abs "
          f"{st['refit_max_abs_err']:.3e}, max rel "
          f"{st['refit_max_rel_err']:.3e} (tolerance {REFIT_RTOL:g} rel + "
          f"{REFIT_ATOL:g}); run to run bitwise: {same}", flush=True)
    if not ok[~np.isnan(ref)].all():
        fail(f"card refit off the CPU refit: {int((~ok).sum())} leaves "
             f"beyond {REFIT_RTOL:g} rel + {REFIT_ATOL:g}")
    if not same:
        fail("two card refits of one window differ")


def online_serve_swap(torch, lt, path, Xw, yw, Xe, st):
    """Part 2: a PredictionServer on the card polling `path`; an
    OnlineTrainer (refit mode) fed the drifted window through
    append_traffic in chunks publishes generation 1 to `path`; the
    server adopts it with cache_misses unchanged and answers bitwise
    the published model's value_ref."""
    import http.client
    from lightgbm_tpu_torch.config import config_from_params
    from lightgbm_tpu_torch.online import OnlineTrainer, append_traffic
    from lightgbm_tpu_torch.quantize import file_sha1
    from lightgbm_tpu_torch.serving import ModelRegistry, PredictionServer
    traffic = path + ".traffic.jsonl"
    params = {"verbose": -1, "device_type": GPU}
    reg = ModelRegistry(path, params=params, replicas=1,
                        serve_quantize="raw", warmup_buckets=SERVE_BUCKETS)
    if reg.current().replicas[0].device.type != GPU:
        fail(f"online server runs on {reg.current().replicas[0].device}")
    cfg = config_from_params(online_params(
        online_trigger_rows=ONLINE_WINDOW))
    trainer = OnlineTrainer(lt.Booster(params=params, model_file=path),
                            traffic, path, config=cfg)
    with PredictionServer(reg, model_poll_seconds=0.2) as srv:
        if stats_of(srv)["online"] is not None:
            fail("online block before any publish")
        before = stats_of(srv)["cache_misses"]
        gen0 = srv.registry.generation
        step = ONLINE_WINDOW // ONLINE_CHUNKS
        t0 = time.perf_counter()
        published = []
        for c in range(ONLINE_CHUNKS):
            lo = c * step
            append_traffic(traffic, Xw[lo:lo + step], yw[lo:lo + step],
                           trace_ids=f"chunk-{c}")
            published.append(trainer.poll_once())
        t_pub = time.perf_counter()
        st["traffic_and_refresh_s"] = t_pub - t0
        if published != [False] * (ONLINE_CHUNKS - 1) + [True]:
            fail(f"online trainer published {published}")
        while srv.registry.generation == gen0:
            if time.perf_counter() - t_pub > 60:
                fail("the server did not adopt generation 1 in 60 s")
            time.sleep(0.005)
        st["swap_to_adoption_s"] = time.perf_counter() - t_pub
        pub = lt.Booster(params=params, model_file=path)
        ref = value_ref(torch, pub._gbdt.models, Xe[:64 * 16],
                        float(pub._gbdt.objective.sigmoid))
        bad = 0
        conn = http.client.HTTPConnection(srv.host, srv.port, timeout=120)
        try:
            for i in range(16):
                lo = 64 * i
                body = "\n".join(json.dumps([float(v) for v in r])
                                 for r in Xe[lo:lo + 64])
                conn.request("POST", "/predict", body)
                resp = conn.getresponse()
                text = resp.read().decode()
                if resp.status != 200:
                    fail(f"after the swap: HTTP {resp.status} {text[:200]}")
                got = np.array([json.loads(v) for v in text.split()])
                bad += not np.array_equal(got, ref[lo:lo + 64])
        finally:
            conn.close()
        stats = stats_of(srv)
    online = stats["online"] or {}
    meta = trainer._read_meta() or {}
    st["online_generation"] = online.get("generation")
    st["refresh_seconds"] = meta.get("refresh_seconds")
    print(f"[online] serve -> refit -> serve: {ONLINE_WINDOW} rows in "
          f"{ONLINE_CHUNKS} chunks, traffic + refresh "
          f"{st['traffic_and_refresh_s']:.2f} s (refresh "
          f"{meta.get('refresh_seconds')} s), publish to adoption "
          f"{st['swap_to_adoption_s']:.3f} s; /stats online generation "
          f"{online.get('generation')}, refbin_sha1 "
          f"{str(online.get('refbin_sha1'))[:12]}; cache_misses {before} "
          f"-> {stats['cache_misses']}; 16 answers after the swap, {bad} "
          f"not bitwise the published model's", flush=True)
    if online.get("generation") != 1 or not online.get("refbin_sha1"):
        fail(f"/stats online block: {online}")
    if online["refbin_sha1"] != file_sha1(path + ".refbin"):
        fail("published refbin_sha1 does not hash the .refbin")
    if stats["cache_misses"] != before:
        fail(f"the swap moved cache_misses {before} -> "
             f"{stats['cache_misses']}")
    if bad:
        fail(f"{bad} answers after the swap are not the published model's")
    return traffic


def online_continue(torch, lt, kernels, path, traffic, tmp, st):
    """Part 3: an OnlineTrainer in continue mode over the same traffic
    appends CONTINUE_TREES trees through the float32 rounds learner: each
    tree launches K2, K4 and K3 (counts zeroed before the refresh)."""
    from lightgbm_tpu_torch.config import config_from_params
    from lightgbm_tpu_torch.online import OnlineTrainer
    params = {"verbose": -1, "device_type": GPU}
    base = lt.Booster(params=params, model_file=path)
    n0 = base.num_trees()
    cfg = config_from_params(online_params(
        online_mode="continue", num_iterations=CONTINUE_TREES,
        online_trigger_rows=ONLINE_WINDOW))
    trainer = OnlineTrainer(base, traffic, os.path.join(tmp, "cont.txt"),
                            config=cfg)
    kernels.reset_launches()
    with tree_launches(kernels, F32_TREE_KERNELS) as per_tree:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = trainer.poll_once()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    launches = {k: kernels.LAUNCHES[k] for k in F32_TREE_KERNELS}
    n1 = lt.Booster(params=params,
                    model_file=os.path.join(tmp, "cont.txt")).num_trees()
    st["continue"] = dict(seconds=secs, trees=[n0, n1], launches=launches,
                          per_tree=per_tree)
    print(f"[online] continue mode: {n0} -> {n1} trees in {secs:.2f} s "
          f"(parse, bin, replay, grow); launches {json.dumps(launches)}; "
          f"per tree [K2, K4, K3, split] {per_tree}", flush=True)
    if not done or n1 != n0 + CONTINUE_TREES:
        fail(f"continue mode: published {done}, {n0} -> {n1} trees")
    if len(per_tree) != CONTINUE_TREES or any(min(c) < 1 for c in per_tree):
        fail(f"continue mode: a tree launched no K2, K4, K3 or split "
             f"search: {per_tree}")


def online_router(torch, lt, path, Xe, tmp, st):
    """Part 4: two backends on the card serving the refitted model behind
    router_from_config: routed answers bitwise the direct ones with
    X-Model-Id relayed; closed loops direct and routed, twice each,
    interleaved; a backend stopped mid-loop with no client error, then
    restarted on its port and readmitted by the health sweep."""
    import http.client
    import shutil
    from lightgbm_tpu_torch.config import config_from_params
    from lightgbm_tpu_torch.router import router_from_config
    from lightgbm_tpu_torch.serving import ModelRegistry, PredictionServer
    params = {"verbose": -1, "device_type": GPU}
    model = os.path.join(tmp, "routed.txt")
    shutil.copyfile(path, model)

    def backend(port=0):
        reg = ModelRegistry(model, params=params, replicas=1,
                            serve_quantize="raw",
                            warmup_buckets=SERVE_BUCKETS)
        return PredictionServer(reg, port=port,
                                model_poll_seconds=0).start()

    servers = [backend(), backend()]
    addrs = [f"127.0.0.1:{s.port}" for s in servers]
    rt = router_from_config(config_from_params({
        "task": "route", "route_backends": ",".join(addrs),
        "route_port": 0, "serve_host": "127.0.0.1",
        "route_health_interval_ms": 200}))
    bst = lt.Booster(params=params, model_file=model)
    ref = value_ref(torch, bst._gbdt.models, Xe,
                    float(bst._gbdt.objective.sigmoid))
    try:
        with rt:
            bad = 0
            conn = http.client.HTTPConnection(rt.host, rt.port, timeout=120)
            try:
                for i in range(16):
                    body = "\n".join(json.dumps([float(v) for v in r])
                                     for r in Xe[64 * i:64 * i + 64])
                    conn.request("POST", "/predict", body)
                    resp = conn.getresponse()
                    routed = resp.read()
                    if (resp.status != 200
                            or resp.getheader("X-Model-Id") != "default"):
                        fail(f"routed: HTTP {resp.status}, X-Model-Id "
                             f"{resp.getheader('X-Model-Id')}")
                    for s in servers:
                        c2 = http.client.HTTPConnection(s.host, s.port,
                                                        timeout=120)
                        try:
                            c2.request("POST", "/predict", body)
                            bad += c2.getresponse().read() != routed
                        finally:
                            c2.close()
            finally:
                conn.close()
            print(f"[route] 16 routed answers, {bad} not bitwise the "
                  "direct answers of both backends; X-Model-Id relayed",
                  flush=True)
            if bad:
                fail(f"{bad} routed answers differ from direct ones")
            home = addrs.index(rt.ring.place("default"))
            loops = {}
            for rnd in range(2):
                for name, srv in (("direct", servers[home]),
                                  ("routed", rt)):
                    lat, answers, wall, errors = closed_loop(
                        srv, Xe, seconds=ROUTE_SECONDS)
                    if errors or not lat:
                        fail(f"{name} loop: {errors[:3]}")
                    check_answers(f"router, {name}", answers, ref)
                    loops.setdefault(name, []).append(loop_stats(lat, wall))
            best = {k: min(v, key=lambda d: d["p50_ms"])
                    for k, v in loops.items()}
            st["route"] = best
            st["route_added_p50_ms"] = (best["routed"]["p50_ms"]
                                        - best["direct"]["p50_ms"])
            print(f"[route] closed loop ({SERVE_CLIENTS} clients x "
                  f"{SERVE_ROWS_PER_REQ} rows, {ROUTE_SECONDS:g} s, best of "
                  f"2 interleaved rounds): direct p50 "
                  f"{best['direct']['p50_ms']:.3f} ms p99 "
                  f"{best['direct']['p99_ms']:.3f} ms; routed p50 "
                  f"{best['routed']['p50_ms']:.3f} ms p99 "
                  f"{best['routed']['p99_ms']:.3f} ms; added p50 "
                  f"{st['route_added_p50_ms']:.3f} ms", flush=True)
            # the home backend dies under load: every request still 200
            port = servers[home].port
            out = {}
            loop = threading.Thread(target=lambda: out.update(zip(
                ("lat", "answers", "wall", "errors"),
                closed_loop(rt, Xe, seconds=3 * ROUTE_SECONDS))))
            loop.start()
            time.sleep(ROUTE_SECONDS)
            servers[home].stop()
            loop.join(timeout=120)
            if loop.is_alive() or out.get("errors") or not out.get("lat"):
                fail(f"loop through a backend stop: "
                     f"{(out.get('errors') or ['no answers'])[:3]}")
            check_answers("router, backend stopped", out["answers"], ref)
            healthy = rt.healthy_count()
            servers[home] = backend(port)
            t0 = time.perf_counter()
            while rt.healthy_count() < 2:
                if time.perf_counter() - t0 > 30:
                    fail("the restarted backend was not readmitted in 30 s")
                time.sleep(0.05)
            st["readmit_s"] = time.perf_counter() - t0
            print(f"[route] home backend stopped mid-loop: "
                  f"{len(out['lat'])} requests, 0 client errors, healthy "
                  f"{healthy} of 2 after; restarted on its port, readmitted "
                  f"in {st['readmit_s']:.2f} s", flush=True)
    finally:
        for s in servers:
            s.stop()


def phase_online(torch, lt, kernels, card):
    """Phase 16: the online loop and the router on the card."""
    from lightgbm_tpu_torch.synth import drift_weights, synth_drift
    t_phase = time.perf_counter()
    params = online_params()
    w_base, w_drift = drift_weights()
    Xb, yb = synth_drift(ONLINE_BASE_ROWS, w_base, seed=1)
    Xw, yw = synth_drift(ONLINE_WINDOW, w_drift, seed=2)
    Xe, ye = synth_drift(ONLINE_EVAL, w_drift, seed=3)
    st = {}
    t0 = time.perf_counter()
    bst = lt.train(params, lt.Dataset(Xb, yb, params=params), ONLINE_TREES,
                   verbose_eval=False)
    torch.cuda.synchronize()
    st["base_train_s"] = time.perf_counter() - t0
    if bst.num_trees() != ONLINE_TREES:
        fail(f"online base model: {bst.num_trees()} of {ONLINE_TREES} trees")
    st["auc_base"] = auc(ye, host_walk(bst, Xe))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "model.txt")
        bst.save_model(path)
        online_refit(torch, lt, bst, Xw, yw, w_drift, Xe, ye, st)
        lt.train(params, lt.Dataset(Xw, yw, params=params), 2,
                 verbose_eval=False)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        re_bst = lt.train(params, lt.Dataset(Xw, yw, params=params),
                          ONLINE_TREES, verbose_eval=False)
        torch.cuda.synchronize()
        st["retrain_s"] = time.perf_counter() - t0
        st["auc_retrain"] = auc(ye, host_walk(re_bst, Xe))
        print(f"[online] base model {st['base_train_s']:.2f} s on "
              f"{ONLINE_BASE_ROWS} rows; retrain of {ONLINE_TREES} trees on "
              f"the window {st['retrain_s']:.2f} s; drifted-eval AUC base "
              f"{st['auc_base']:.6f}, refit {st['auc_refit']:.6f}, retrain "
              f"{st['auc_retrain']:.6f} ({card})", flush=True)
        if not st["auc_refit"] > st["auc_base"]:
            fail(f"refit AUC {st['auc_refit']} not above base "
                 f"{st['auc_base']}")
        traffic = online_serve_swap(torch, lt, path, Xw, yw, Xe, st)
        online_continue(torch, lt, kernels, path, traffic, tmp, st)
        online_router(torch, lt, path, Xe, tmp, st)
    st["phase_s"] = time.perf_counter() - t_phase
    print(f"[online] {json.dumps(st)}", flush=True)
    print(f"[online] phase 16: {st['phase_s']:.1f} s", flush=True)
    return st


# phase 17: the product surface through files — the config file, the CLI
# (in-process and `python -m`), the binary cache, two-round loading,
# task=predict/refit/serve, and the training C ABI — at the north-star
# width (FILE_TRAIN_ROWS x 28, as the north-star bench's valid split)
FILE_TRAIN_ROWS = 500_000
FILE_VALID_ROWS = 100_000
FILE_DRIFT_ROWS = 100_000
FILE_ITERS = 20
FILE_CAPI_ITERS = 10
FILE_PREDICT_CHUNK = 37_000
FILE_SERVE_REQUESTS = 4
FILE_SERVE_ROWS = 64
# the checkout's root: the subprocesses import lightgbm_tpu_torch from it
REPO_DIR = os.path.dirname(os.path.abspath(__file__))

_FLOAT_LINES = ("split_gain", "leaf_value", "internal_value")


def file_params() -> dict:
    from lightgbm_tpu_torch.synth import NORTH_STAR_PARAMS
    return dict(NORTH_STAR_PARAMS, device_type=GPU)


def write_conf(path: str, params: dict, data: str, model: str) -> None:
    """A training config in the reference's `key = value` format."""
    lines = ["# phase 17: the north-star configuration, trained from files",
             "task = train", f"data = {data}", f"output_model = {model}",
             f"num_iterations = {FILE_ITERS}",
             "is_save_binary_file = true  # train.csv.bin for the rerun",
             "is_training_metric = true", "metric_freq = 10"]
    # verbose 1: the load seconds and the cache line are read off the log
    lines += [f"{k} = {v}" for k, v in dict(params, verbose=1).items()]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def same_model(label: str, ref: str, got: str) -> bool:
    """True when the model strings are equal.  Otherwise print the first
    differing line and fail unless every structural line is equal and
    every float line is within rtol 1e-6 (the float lines then differ by
    an operation of the card that is not bitwise from run to run)."""
    if got == ref:
        return True
    a, b = ref.splitlines(), got.splitlines()
    if len(a) != len(b):
        fail(f"{label}: {len(b)} model lines against {len(a)}")
    first = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
    print(f"[files] {label}: first differing line {first}: {a[first]!r} "
          f"against {b[first]!r}", flush=True)
    for i, (x, y) in enumerate(zip(a, b)):
        key = x.split("=", 1)[0]
        if x == y:
            continue
        if key not in _FLOAT_LINES or y.split("=", 1)[0] != key:
            fail(f"{label}: structural line {i} differs: {x!r} / {y!r}")
        va = np.array(x.split("=", 1)[1].split(), np.float64)
        vb = np.array(y.split("=", 1)[1].split(), np.float64)
        if va.shape != vb.shape or not np.allclose(vb, va, rtol=1e-6,
                                                   atol=0):
            fail(f"{label}: float line {i} beyond rtol 1e-6")
    return False


def read_text(path: str) -> str:
    with open(path) as f:
        return f.read()


def files_write(tmp: str, st: dict):
    """Step 1: the data files, the weight side file and the config."""
    from lightgbm_tpu_torch.synth import synth_higgs
    X, y = synth_higgs(FILE_TRAIN_ROWS)
    Xv, yv = synth_higgs(FILE_VALID_ROWS, seed=7)
    w = np.random.RandomState(11).rand(FILE_TRAIN_ROWS) + 0.5
    paths = {k: os.path.join(tmp, n) for k, n in (
        ("train", "train.csv"), ("valid", "valid.tsv"),
        ("conf", "train.conf"), ("model", "model.txt"),
        ("drift", "drift.csv"))}
    t0 = time.perf_counter()
    np.savetxt(paths["train"], np.column_stack([y, X]), delimiter=",",
               fmt="%.9g")
    np.savetxt(paths["train"] + ".weight", w, fmt="%.9g")
    header = "\t".join(["label"] + [f"f{j}" for j in range(X.shape[1])])
    np.savetxt(paths["valid"], np.column_stack([yv, Xv]), delimiter="\t",
               fmt="%.9g", header=header, comments="")
    Xd = X[:FILE_DRIFT_ROWS]
    np.savetxt(paths["drift"], np.column_stack([1.0 - y[:FILE_DRIFT_ROWS],
                                                Xd]),
               delimiter=",", fmt="%.9g")
    write_conf(paths["conf"], file_params(), paths["train"], paths["model"])
    st["write_s"] = time.perf_counter() - t0
    st["file_mb"] = sum(os.path.getsize(p) for p in (
        paths["train"], paths["train"] + ".weight", paths["valid"],
        paths["drift"])) / 1e6
    print(f"[files] wrote {st['file_mb']:.1f} MB in {st['write_s']:.2f} s",
          flush=True)
    return paths


def run_app(torch, argv):
    """Application(argv).run() in-process; returns (its log, seconds)."""
    import contextlib
    import io
    from lightgbm_tpu_torch.application import Application
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        Application(argv).run()
    torch.cuda.synchronize()
    return buf.getvalue(), time.perf_counter() - t0


def files_train(torch, lt, kernels, paths, st):
    """Steps 2-4: the config in-process, `python -m` in a subprocess,
    lt.train on the parsed files, and the in-process rerun from the
    binary cache; one model string."""
    from lightgbm_tpu_torch import native
    from lightgbm_tpu_torch.dataset import parse_text_file
    conf, model = paths["conf"], paths["model"]
    parses = dict(native.PARSES)
    binned = dict(native.BINNED)
    kernels.reset_launches()
    out, st["cli_s"] = run_app(torch, [f"config={conf}"])
    launches = dict(kernels.LAUNCHES)
    st["cli_launches"] = launches
    for k in TREE_KERNELS:
        if not launches[k]:
            fail(f"task=train from the config: {k} launched 0 times")
    st["parser"] = ("native" if native.PARSES["native"] > parses["native"]
                    else "numpy")
    if st["parser"] != "native":
        fail("train.csv was not read by the native parser")
    st["cli_load_s"] = float(out.split("finished loading data in ")[1]
                             .split(" seconds")[0])
    P21["setup"]["17_file_load_s"] = st["cli_load_s"]
    P21["setup"]["17_binned"] = {k: native.BINNED[k] - binned[k]
                                 for k in binned}
    if not os.path.exists(paths["train"] + ".bin"):
        fail("is_save_binary_file wrote no train.csv.bin")
    ref = read_text(model)
    print(f"[files] task=train in-process {st['cli_s']:.2f} s (load "
          f"{st['cli_load_s']:.2f} s, {st['parser']} parser; launches "
          f"{json.dumps(launches)})", flush=True)

    sub_model = os.path.join(os.path.dirname(model), "model_sub.txt")
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "lightgbm_tpu_torch", f"config={conf}",
         f"output_model={sub_model}", "is_save_binary_file=false",
         "enable_load_from_binary_file=false"],
        cwd=REPO_DIR, capture_output=True, text=True, timeout=600)
    st["subprocess_s"] = time.perf_counter() - t0
    if r.returncode != 0:
        fail(f"python -m lightgbm_tpu_torch: rc {r.returncode}\n"
             f"{r.stdout[-2000:]}\n{r.stderr[-2000:]}")
    st["bitwise"] = {"subprocess": same_model(
        "python -m lightgbm_tpu_torch", ref, read_text(sub_model))}

    params = file_params()
    t0 = time.perf_counter()
    X, y, _ = parse_text_file(paths["train"])
    w = np.loadtxt(paths["train"] + ".weight", dtype=np.float32)
    bst = lt.train(params, lt.Dataset(X, y, weight=w, params=params),
                   FILE_ITERS, verbose_eval=False)
    torch.cuda.synchronize()
    st["api_s"] = time.perf_counter() - t0
    st["bitwise"]["lt.train"] = same_model("lt.train on parse_text_file",
                                           ref, bst.model_to_string())

    rerun = os.path.join(os.path.dirname(model), "model_rerun.txt")
    out, st["rerun_s"] = run_app(torch, [f"config={conf}",
                                         f"output_model={rerun}"])
    if f"loading binary dataset cache {paths['train']}.bin" not in out:
        fail("the rerun did not load train.csv.bin")
    st["rerun_load_s"] = float(out.split("finished loading data in ")[1]
                               .split(" seconds")[0])
    st["bitwise"]["cache"] = same_model("rerun from train.csv.bin", ref,
                                        read_text(rerun))
    print(f"[files] python -m {st['subprocess_s']:.2f} s; lt.train "
          f"{st['api_s']:.2f} s; rerun from the cache {st['rerun_s']:.2f} s "
          f"(load {st['rerun_load_s']:.2f} s); model strings equal "
          f"{json.dumps(st['bitwise'])}", flush=True)
    return X, y, w


def files_two_round(lt, paths, Xv, yv, st):
    """Step 5: the train file in two streaming passes, 5 iterations."""
    params = dict(file_params(), use_two_round_loading=True,
                  enable_load_from_binary_file=False)
    t0 = time.perf_counter()
    ds = lt.Dataset(paths["train"], params=params).construct()
    st["two_round_load_s"] = time.perf_counter() - t0
    bst = lt.train(params, ds, 5, verbose_eval=False)
    st["two_round_auc"] = auc(yv, host_walk(bst, Xv))
    print(f"[files] two-round load {st['two_round_load_s']:.2f} s; 5 "
          f"iterations: valid AUC {st['two_round_auc']:.6f}", flush=True)
    if not st["two_round_auc"] > 0.75:
        fail(f"two-round valid AUC {st['two_round_auc']}")


def files_predict(lt, paths, Xv, st):
    """Step 6: task=predict on valid.tsv."""
    from lightgbm_tpu_torch.application import Predictor, main as cli_main
    out = os.path.join(os.path.dirname(paths["model"]), "pred.txt")
    t0 = time.perf_counter()
    if cli_main(["task=predict", f"data={paths['valid']}",
                 "has_header=true", f"input_model={paths['model']}",
                 f"output_result={out}", "verbose=-1",
                 f"device_type={GPU}"]) != 0:
        fail("task=predict returned non-zero")
    st["predict_s"] = time.perf_counter() - t0
    got = np.loadtxt(out)
    bst = lt.Booster(model_file=paths["model"], params={"device_type": GPU})
    cfg = lt.config_from_params({})
    pred = Predictor(bst, num_iteration=cfg.num_iteration_predict,
                     predict_kernel=cfg.predict_kernel,
                     serve_quantize=cfg.serve_quantize,
                     refbin=paths["model"] + ".refbin")
    if not np.array_equal(got, pred.predict(Xv)):
        fail("task=predict differs from Predictor.predict")
    st["predict_vs_host"] = float(np.abs(got - host_walk(bst, Xv)).max())
    if not st["predict_vs_host"] <= 1e-6:
        fail(f"task=predict {st['predict_vs_host']} off the host walk")
    chunked = out + ".chunked"
    pred.predict_file(paths["valid"], chunked, has_header=True,
                      chunk_rows=FILE_PREDICT_CHUNK)
    st["predict_chunked_diff"] = float(np.abs(np.loadtxt(chunked)
                                              - got).max())
    if not st["predict_chunked_diff"] <= 1e-7:
        fail(f"chunked task=predict {st['predict_chunked_diff']} off")
    print(f"[files] task=predict {st['predict_s']:.2f} s on "
          f"{FILE_VALID_ROWS} rows; max |diff| host walk "
          f"{st['predict_vs_host']:.3g}, chunks of {FILE_PREDICT_CHUNK} "
          f"{st['predict_chunked_diff']:.3g}", flush=True)


def files_refit(torch, lt, paths, st):
    """Step 7: task=refit on a copy of training rows with flipped labels,
    against Booster.refit on the same rows (both route on raw values)."""
    from lightgbm_tpu_torch.application import main as cli_main
    from lightgbm_tpu_torch.dataset import parse_text_file
    out = os.path.join(os.path.dirname(paths["model"]), "refit.txt")
    t0 = time.perf_counter()
    if cli_main(["task=refit", f"data={paths['drift']}",
                 f"input_model={paths['model']}", f"output_model={out}",
                 "refit_decay_rate=0.5", "verbose=-1",
                 f"device_type={GPU}"]) != 0:
        fail("task=refit returned non-zero")
    torch.cuda.synchronize()
    st["refit_s"] = time.perf_counter() - t0
    Xd, yd, _ = parse_text_file(paths["drift"])
    ref = lt.Booster(model_file=paths["model"], params={
        "device_type": GPU}).refit(Xd, yd, decay_rate=0.5)
    got = lt.Booster(model_file=out, params={"device_type": GPU})
    if not np.array_equal(leaf_table(got._gbdt.models),
                          leaf_table(ref._gbdt.models), equal_nan=True):
        fail("task=refit leaf values differ from Booster.refit")
    print(f"[files] task=refit {st['refit_s']:.2f} s on {FILE_DRIFT_ROWS} "
          "rows: leaf values bitwise Booster.refit", flush=True)


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def files_serve(lt, paths, Xv, st):
    """Step 8: task=serve as a subprocess, against resolve_runtime on the
    same model file in-process."""
    import http.client
    import signal
    from lightgbm_tpu_torch.serving.runtime import resolve_runtime
    port = free_port()
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "lightgbm_tpu_torch", "task=serve",
         f"input_model={paths['model']}", f"serve_port={port}",
         "serve_host=127.0.0.1", "model_poll_seconds=0",
         f"device_type={GPU}"],
        cwd=REPO_DIR, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)

    def request(method, path, body=None):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        try:
            conn.request(method, path, body=body)
            r = conn.getresponse()
            return r.status, r.read().decode()
        finally:
            conn.close()

    try:
        while True:
            if proc.poll() is not None:
                fail(f"task=serve exited: {proc.stdout.read()[-3000:]}")
            if time.perf_counter() - t0 > 300:
                fail("task=serve: no /healthz answer in 300 s")
            try:
                if request("GET", "/healthz")[0] == 200:
                    break
            except OSError:
                time.sleep(0.2)
        st["serve_start_s"] = time.perf_counter() - t0
        rt = resolve_runtime(
            lt.Booster(model_file=paths["model"],
                       params={"device_type": GPU}),
            serve_quantize="auto", refbin=paths["model"] + ".refbin")
        for i in range(FILE_SERVE_REQUESTS):
            rows = Xv[i * FILE_SERVE_ROWS:(i + 1) * FILE_SERVE_ROWS]
            status, text = request("POST", "/predict", "\n".join(
                json.dumps(r.tolist()) for r in rows))
            if status != 200:
                fail(f"task=serve answered {status}: {text[:500]}")
            got = np.array([json.loads(t) for t in text.splitlines()])
            if not np.array_equal(got, rt.predict(rows)):
                fail(f"task=serve request {i} differs from resolve_runtime")
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            out, _ = proc.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            fail("task=serve did not stop on SIGTERM")
    if proc.returncode != 0:
        fail(f"task=serve exited {proc.returncode}: {out[-2000:]}")
    print(f"[files] task=serve subprocess answered /healthz after "
          f"{st['serve_start_s']:.2f} s; {FILE_SERVE_REQUESTS} requests of "
          f"{FILE_SERVE_ROWS} rows bitwise resolve_runtime; exit 0 on "
          "SIGTERM", flush=True)


def files_capi(torch, lt, kernels, paths, X, Xv, st):
    """Step 9: the training C ABI, loaded into this process."""
    import ctypes
    import sysconfig
    from lightgbm_tpu_torch import native
    from lightgbm_tpu_torch.online.refit import refit_gbdt
    inc = sysconfig.get_path("include")
    if not os.path.exists(os.path.join(inc, "Python.h")):
        st["capi"] = f"left out: no Python.h under {inc}"
        print(f"[files] C ABI {st['capi']}", flush=True)
        return
    t0 = time.perf_counter()
    lib = native.train_lib()
    st["capi_build_s"] = time.perf_counter() - t0

    def check(rc):
        if rc != 0:
            fail(f"C ABI: {lib.LGBM_GetLastError().decode()}")

    pstr = " ".join(f"{k}={v}" for k, v in file_params().items()).encode()
    t0 = time.perf_counter()
    ds = ctypes.c_void_p()
    check(lib.LGBM_DatasetCreateFromFile(paths["train"].encode(), pstr, None,
                                         ctypes.byref(ds)))
    Xvc = np.ascontiguousarray(Xv, np.float64)
    dv = ctypes.c_void_p()
    check(lib.LGBM_DatasetCreateFromMat(
        Xvc.ctypes.data_as(ctypes.c_void_p), 1, ctypes.c_int32(len(Xv)),
        ctypes.c_int32(Xv.shape[1]), 1, pstr, ds, ctypes.byref(dv)))
    bst = ctypes.c_void_p()
    check(lib.LGBM_BoosterCreate(ds, pstr, ctypes.byref(bst)))
    check(lib.LGBM_BoosterAddValidData(bst, dv))
    st["capi_setup_s"] = time.perf_counter() - t0
    kernels.reset_launches()
    fin = ctypes.c_int()
    t0 = time.perf_counter()
    for _ in range(FILE_CAPI_ITERS):
        check(lib.LGBM_BoosterUpdateOneIter(bst, ctypes.byref(fin)))
    torch.cuda.synchronize()
    st["capi_train_s"] = time.perf_counter() - t0
    st["capi_launches"] = dict(kernels.LAUNCHES)
    for k in TREE_KERNELS:
        if not st["capi_launches"][k]:
            fail(f"LGBM_BoosterUpdateOneIter: {k} launched 0 times")

    ln = ctypes.c_int()
    check(lib.LGBM_BoosterSaveModelToString(bst, -1, 0, ctypes.byref(ln),
                                            None))
    buf = ctypes.create_string_buffer(ln.value)
    check(lib.LGBM_BoosterSaveModelToString(bst, -1, ln.value,
                                            ctypes.byref(ln), buf))
    text = buf.value.decode()
    py = lt.Booster(model_str=text, params={"device_type": GPU})

    def predict(X, ptype):
        n = ctypes.c_int64()
        check(lib.LGBM_BoosterCalcNumPredict(bst, len(X), ptype, -1,
                                             ctypes.byref(n)))
        out = np.empty(n.value, np.float64)
        Xc = np.ascontiguousarray(X, np.float64)
        check(lib.LGBM_BoosterPredictForMat(
            bst, Xc.ctypes.data_as(ctypes.c_void_p), 1,
            ctypes.c_int32(len(X)), ctypes.c_int32(X.shape[1]), 1, ptype,
            -1, ctypes.byref(n), out.ctypes.data_as(
                ctypes.POINTER(ctypes.c_double))))
        return out

    t0 = time.perf_counter()
    if not np.array_equal(predict(Xv, 0), py.predict(Xv)):
        fail("LGBM_BoosterPredictForMat differs from Booster.predict")
    st["capi_predict_s"] = time.perf_counter() - t0
    leaf = predict(X, 2).astype(np.int32)
    ref = lt.Booster(model_str=text, params=file_params())
    inner = lt.Dataset(paths["train"], params=file_params()
                       ).construct()._inner
    refit_gbdt(ref._gbdt, inner,
               leaf_idx=leaf.reshape(len(X), -1).copy())
    t0 = time.perf_counter()
    check(lib.LGBM_BoosterRefit(
        bst, leaf.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int32(len(X)), ctypes.c_int32(leaf.size // len(X))))
    torch.cuda.synchronize()
    st["capi_refit_s"] = time.perf_counter() - t0
    check(lib.LGBM_BoosterSaveModelToString(bst, -1, 0, ctypes.byref(ln),
                                            None))
    buf = ctypes.create_string_buffer(ln.value)
    check(lib.LGBM_BoosterSaveModelToString(bst, -1, ln.value,
                                            ctypes.byref(ln), buf))
    got = lt.Booster(model_str=buf.value.decode(),
                     params={"device_type": GPU})
    if not np.array_equal(leaf_table(got._gbdt.models),
                          leaf_table(ref._gbdt.models), equal_nan=True):
        fail("LGBM_BoosterRefit differs from refit_gbdt(leaf_idx=)")
    for h, free in ((bst, lib.LGBM_BoosterFree), (dv, lib.LGBM_DatasetFree),
                    (ds, lib.LGBM_DatasetFree)):
        check(free(h))
    if any(m == "lightgbm_tpu" or m.startswith("lightgbm_tpu.")
           for m in sys.modules):
        fail("the C ABI loaded the JAX package")
    st["capi"] = "ran"
    print(f"[files] C ABI: build {st['capi_build_s']:.2f} s, datasets and "
          f"booster {st['capi_setup_s']:.2f} s, {FILE_CAPI_ITERS} "
          f"UpdateOneIter {st['capi_train_s']:.2f} s (launches "
          f"{json.dumps(st['capi_launches'])}), PredictForMat bitwise "
          f"Booster.predict, Refit bitwise refit_gbdt "
          f"({st['capi_refit_s']:.2f} s); lightgbm_tpu not loaded",
          flush=True)


def phase_files(torch, lt, kernels, card):
    """Phase 17: files, the CLI and the C ABI on the card."""
    from lightgbm_tpu_torch.dataset import parse_text_file
    t_phase = time.perf_counter()
    st = {}
    with tempfile.TemporaryDirectory() as tmp:
        paths = files_write(tmp, st)
        X, _, _ = files_train(torch, lt, kernels, paths, st)
        Xv, yv, _ = parse_text_file(paths["valid"], has_header=True)
        files_two_round(lt, paths, Xv, yv, st)
        files_predict(lt, paths, Xv, st)
        files_refit(torch, lt, paths, st)
        files_serve(lt, paths, Xv, st)
        files_capi(torch, lt, kernels, paths, X, Xv, st)
    st["phase_s"] = time.perf_counter() - t_phase
    print(f"[files] {json.dumps(st)}", flush=True)
    print(f"[files] phase 17: {st['phase_s']:.1f} s ({card})", flush=True)
    return st


# ---------------------------------------------------------------------------
# Phase 18: the bundled sparse store and the fused single-split builder
# ---------------------------------------------------------------------------

CTRB_ROWS = 500_000
CTRB_FEATURES = 5_000
CTRB_ITERS = (2, 10)
CTRB_CUT = 50_000
PROBE_SHAPE = (20_000, 3_000)
FUSED_ONEHOT_ITERS = (2, 10)
FUSED_NS_ITERS = (2, 4)
FUSED_BAG_ITERS = 3
FUSED_AB_ITERS = 4


@contextlib.contextmanager
def serial_exact():
    """tree_growth=exact builds the serial (host-loop) learner on the card,
    as the JAX package's own tests build a learner directly: the card's
    `exact` is the fused builder, and the phases that time K5 and hold
    the serial learner against the CPU need the serial one."""
    from lightgbm_tpu_torch.boosting import gbdt
    from lightgbm_tpu_torch.learner.serial import SerialTreeLearner
    real = gbdt.create_tree_learner

    def make(ds, cfg):
        if getattr(cfg, "tree_growth", "auto") == "exact":
            return SerialTreeLearner(ds, cfg)
        return real(ds, cfg)
    gbdt.create_tree_learner = make
    try:
        yield
    finally:
        gbdt.create_tree_learner = real


def tree_counters(profiling, before):
    """The tree/* counters' growth since `before` (a counters() dict)."""
    now = profiling.counters("tree/")
    return {k: now.get(k, 0.0) - before.get(k, 0.0) for k in
            (profiling.HIST_ROWS_TOUCHED, profiling.SPARSE_NNZ_TOUCHED,
             profiling.SPARSE_FALLBACKS)}


def drive_fused(torch, lt, kernels, params, ds, vs, Xv, warmup, timed,
                label):
    """The fused builder (tree_growth=exact on the card) through
    lightgbm_tpu_torch.train, under HotPathSanitizer(warmup=1, strict):
    every tree after the first must make no synchronising call (one
    explicit packed read a tree) and build no kernel.  Fails unless the
    learner is the fused one, K2 launched once at the root and once a
    split of every tree, K5 never, and the host read each tree once."""
    from lightgbm_tpu_torch.diagnostics.sanitize import (HotPathSanitizer,
                                                         fused_tree_steps)
    with HotPathSanitizer(warmup=1, strict=True, label=label) as san:
        with fused_tree_steps(san):
            st, first = drive_onehot(torch, lt, kernels, params, ds, vs, Xv,
                                     warmup, timed)
    san.check()
    L = int(params["num_leaves"])
    n = warmup + timed
    rep = san.report()
    st.update(sanitize={k: rep[k] for k in (
        "steps", "retraces_after_warmup", "implicit_transfers",
        "compiles_total")},
        k2_per_tree=st["launches"].get("hist_masked_f32", 0) / n)
    if st["learner"] != "FusedTreeLearner":
        fail(f"tree_growth=exact on the card ran {st['learner']} ({label})")
    if st["launches"].get("hist_masked_f32", 0) != n * L:
        fail(f"K2 launched {st['launches'].get('hist_masked_f32')} times "
             f"in {n} fused trees of {L} leaves ({label})")
    if st["launches"].get("hist_gathered", 0):
        fail(f"the fused builder launched K5 ({label})")
    if st["syncs_per_tree"] != 1:
        fail(f"the fused builder read the host {st['syncs_per_tree']} "
             f"times a tree ({label})")
    if rep["steps"] != n:
        fail(f"the sanitizer saw {rep['steps']} trees of {n} ({label})")
    return st, first


def fused_k2_row(torch, H, learner, launches):
    """Kernel K2 as the fused builder calls it: one slot, the masked feed
    over every row of the learner's store (byte copy), a leaf of about
    half the rows in the mask; real gradients within n * 2^-23 * sum|x|
    a cell and dyadic ones bitwise against its plain version, two runs
    bitwise; timed, with its bound and one index_add_."""
    dev = torch.device(GPU)
    bins, rows = learner.bins_dev, learner.rows
    F, N = bins.shape
    B = learner.B
    rng = np.random.RandomState(18)
    mask = torch.as_tensor((rng.rand(N) < 0.5).astype(np.float32),
                           device=dev)
    g = torch.as_tensor(rng.randn(N).astype(np.float32), device=dev)
    h = torch.as_tensor(rng.rand(N).astype(np.float32), device=dev)
    gd = torch.as_tensor((np.round(rng.randn(N) * 16) / 16
                          ).astype(np.float32), device=dev)
    hd = torch.as_tensor((np.round(rng.rand(N) * 64) / 256
                          ).astype(np.float32), device=dev)
    errs = []
    for gg, hh, exact in ((g, h, False), (gd, hd, True)):
        gh8, lid, sl = H._mask_feed(gg, hh, mask)
        got = H._hist_f_cuda(bins, rows, None, gh8, B, lid=lid, sl=sl)
        again = H._hist_f_cuda(bins, rows, None, gh8, B, lid=lid, sl=sl)
        ref = H._hist_plain(bins, None, lid, gh8, sl, B, rows=rows)
        torch.cuda.synchronize()
        errs.append((got.double() - ref.double()).abs().max().item())
        if not torch.equal(got, again):
            fail("K2 (fused one-slot pass) differs from run to run")
        if exact and not torch.equal(got, ref):
            fail(f"K2 (fused one-slot pass) differs from its plain version "
                 f"on dyadic values: {errs[-1]}")
        if not exact:
            tol = reorder_tol(torch, lambda v: H._hist_plain(
                bins, None, lid, v, sl, B, rows=rows), gh8)
            if ((got.double() - ref.double()).abs() > tol).any():
                fail(f"K2 (fused one-slot pass) beyond n*2^-23*sum|x|: "
                     f"{errs[-1]}")
        full = H.histogram_full_masked(bins, gg, hh, mask,
                                       num_bins_padded=B, rows=rows)
        if not torch.equal(full, got[0]):
            fail("histogram_full_masked did not run K2's one-slot pass")
    gh8, lid, sl = H._mask_feed(g, h, mask)

    def k2():
        return H._hist_f_cuda(bins, rows, None, gh8, B, lid=lid, sl=sl)
    ms = time_ms(torch, k2, 20)
    graph = graph_ms(torch, k2)
    plain = time_ms(torch, lambda: H._hist_plain(bins, None, lid, gh8, sl, B,
                                                 rows=rows), 3, 1)
    b = (bins.long() + (128 if bins.dtype == torch.int8 else 0))
    live = (lid == 0)
    idx = (torch.arange(F, device=dev)[:, None] * (3 * B) + b)[:, live]
    idx = torch.cat([idx.reshape(-1) + ch * B for ch in range(3)])
    v = torch.cat([gh8[ch][live][None].expand(F, -1).reshape(-1)
                   for ch in range(3)])
    out = torch.zeros(F * 3 * B, dtype=torch.float32, device=dev)
    lib = time_ms(torch, lambda: out.zero_().index_add_(0, idx, v), 5, 1)
    del idx, v, out, b
    F4 = rows.rows.shape[1]
    # the leaf id of every row (which rows are in the mask), the byte row
    # and 3 values of each row in the mask, the [F, 3, B] output once
    n = int(live.sum())
    bms, by = bound_ms(N * 4 + n * (F4 + 12) + F * 3 * B * 4, 3.0 * F * n)
    print(f"[phase 18b] hist_masked_f32 (fused one-slot pass): N={N} F={F} "
          f"B={B} max_abs_err={max(errs):.3g} ms={ms:.4f} "
          f"graph_ms={graph:.4f} plain_ms={plain:.4f} library_ms={lib:.4f} "
          f"bound_ms={bms:.4f} ({by})", flush=True)
    return dict(name="hist_masked_f32 (fused exact, one slot)", route="cuda",
                source="lightgbm_tpu_torch/csrc/histogram.cu",
                replaces="lightgbm_tpu/ops/histogram.py:443",
                launches=launches, max_abs_err=max(errs), ms=ms,
                graph_ms=graph, plain_ms=plain, bound_ms=bms, bound_by=by,
                library_ms=lib)


def phase_fused_onehot(torch, lt, kernels, params, ds, vs, Xv, serial_first):
    """Phase 18b: the fused builder on the onehot workload (phase 8's
    datasets, 40 bundle columns), its first tree against the serial
    learner's (phase 10) on the card, and K2's one-slot pass."""
    t0 = time.perf_counter()
    p = dict(params, tree_growth="exact")
    st, first = drive_fused(torch, lt, kernels, p, ds, vs, Xv,
                            *FUSED_ONEHOT_ITERS, "fused onehot")
    print(f"[phase 18b] fused exact, onehot: {json.dumps(st)}", flush=True)
    if not st["auc_last"] > st["auc_first"]:
        fail(f"fused onehot valid AUC did not rise: {st['auc_first']} -> "
             f"{st['auc_last']}")
    compare_first_trees("onehot, fused vs serial learner on the card",
                        serial_first, first, 0.0, 0.0, "-")
    from lightgbm_tpu_torch.config import config_from_params
    from lightgbm_tpu_torch.learner.fused import FusedTreeLearner
    from lightgbm_tpu_torch.ops import histogram as H
    learner = FusedTreeLearner(ds._inner, config_from_params(p))
    row = fused_k2_row(torch, H, learner, st["launches"]["hist_masked_f32"])
    del learner
    gc.collect()
    torch.cuda.empty_cache()
    st["phase_s"] = time.perf_counter() - t0
    print(f"[phase 18b] {st['phase_s']:.1f} s", flush=True)
    return st, row


def phase_fused_northstar(torch, lt, kernels, ns_params, ds, vs, Xv):
    """Phase 18c: the fused builder on the north-star datasets (phase 3's,
    2M rows), float32; a bagged run for the row mask; its first tree
    against the serial learner's on the card."""
    t0 = time.perf_counter()
    p = dict(ns_params, tree_growth="exact", histogram_dtype="float32")
    st, first = drive_fused(torch, lt, kernels, p, ds, vs, Xv,
                            *FUSED_NS_ITERS, "fused north-star")
    print(f"[phase 18c] fused exact, north-star: {json.dumps(st)}",
          flush=True)
    if not st["auc_last"] > st["auc_first"]:
        fail(f"fused north-star valid AUC did not rise: {st['auc_first']} "
             f"-> {st['auc_last']}")
    pb = dict(p, bagging_fraction=0.8, bagging_freq=1, bagging_seed=3)
    bag, _ = drive_fused(torch, lt, kernels, pb, ds, vs, Xv, 1,
                         FUSED_BAG_ITERS - 1, "fused north-star, bagged")
    print(f"[phase 18c] fused exact, north-star, bagging 0.8: "
          f"{json.dumps(bag)}", flush=True)
    # the serial learner on the same data, alternating with the fused
    # one: F S F S, each a steady window of FUSED_AB_ITERS - 1 iterations
    pairs = []
    for rep in range(2):
        if rep:
            fu, _ = drive_fused(torch, lt, kernels, p, ds, vs, Xv, 1,
                                FUSED_AB_ITERS - 1, "fused north-star, A/B")
            pairs.append(("fused", fu["s_per_iter"]))
        else:
            pairs.append(("fused", st["s_per_iter"]))
        with serial_exact():
            se, sfirst = drive_onehot(torch, lt, kernels, p, ds, vs, Xv, 1,
                                      FUSED_AB_ITERS - 1)
        if se["learner"] != "SerialTreeLearner":
            fail("the serial learner was not built on the card")
        pairs.append(("serial", se["s_per_iter"]))
        if not rep:
            compare_first_trees("north-star, fused vs serial learner on "
                                "the card", sfirst, first, 0.0, 0.0, "-")
    st["ab_s_per_iter"] = pairs
    print(f"[phase 18c] north-star float32 s/iter, fused and serial "
          f"learners alternating: {json.dumps(pairs)}", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    st["phase_s"] = time.perf_counter() - t0
    print(f"[phase 18c] {st['phase_s']:.1f} s", flush=True)
    return st


def dyadic_gh(torch, y, device):
    """Dyadic gradients (-1 / +1 by label, hessian 0.5: every histogram
    sum exact in any order) on `device`."""
    g = np.where(np.asarray(y) > 0, -1.0, 1.0).astype(np.float32)
    return (torch.as_tensor(g, device=device),
            torch.full((len(g),), 0.5, dtype=torch.float32, device=device))


def same_tree(label, a, la, b, lb):
    """Trees a and b (leaf ids la, lb) bitwise: structure, leaf values
    and leaf ids."""
    n = a.num_leaves
    ok = b.num_leaves == n and all(
        np.array_equal(getattr(a, f)[:n - 1], getattr(b, f)[:n - 1])
        for f in ("split_feature", "threshold_in_bin", "left_child",
                  "right_child"))
    ok = ok and np.array_equal(a.leaf_value[:n], b.leaf_value[:n])
    ok = ok and np.array_equal(la.cpu().numpy(), lb.cpu().numpy())
    print(f"[phase 18] {label}: leaves {n} / {b.num_leaves}, bitwise: {ok}",
          flush=True)
    if not ok:
        fail(f"{label}: the trees differ")


def conflict_rows(inner, X):
    """[rows] bool: the rows of raw X on which two members of one bundle
    of `inner`'s plan are both off their default bin.  Such a row keeps
    one of them in any bundled store (EFB's loss, counted as
    bundle_conflict_rows), so its binned walk may leave the raw one."""
    plan = inner.bundle_plan
    cnt = np.zeros((X.shape[0], plan.num_columns), np.int32)
    for k, i in enumerate(inner.used_features):
        if plan.feat_packed[k]:
            m = inner.mappers[i]
            off = m.value_to_bin(np.asarray(X[:, i], np.float64)) \
                != m.default_bin
            cnt[off, int(plan.feat_col[k])] += 1
    return (cnt > 1).any(axis=1)


def bundled_k8_row(torch, H, SS, ds, launches):
    """K8 on the bundled csr store: one K=31 float32 pass (as
    phase 5 on the unbundled one) against its plain version, real
    gradients within the reorder bound and dyadic ones bitwise; timed,
    with its bound and one index_add_."""
    dev = torch.device(GPU)
    cols, binsv, zb = ds._inner.sparse_triple(dev)
    Cp = int(zb.shape[0])
    streams = SS.build_sparse_streams(cols, binsv, Cp)
    N, K, B = cols.shape[0], CTR_SLOTS, 128
    lid, sl, gh_dy, gh = sparse_pass_inputs(torch, H, N, K, 18)
    srow, vals, tot, _ = H._sparse_pass(lid, gh, sl, "float32")
    name = "hist_sparse_f32 (bundled csr)"
    errs = [sparse_check(torch, H, SS, name, streams, zb, srow, vals, tot,
                         None, K, Cp, B, False)]
    dsrow, dvals, dtot, _ = H._sparse_pass(lid, gh_dy, sl, "float32")
    errs.append(sparse_check(torch, H, SS, name, streams, zb, dsrow, dvals,
                             dtot, None, K, Cp, B, True))
    del dsrow, dvals, dtot
    run_to_run(torch, "a", f"{name} K={K} real-valued pass",
               lambda: SS._hist_streams_cuda(streams, zb, srow, vals, tot,
                                             None, K, Cp, B))
    ms = time_ms(torch, lambda: SS._hist_streams_cuda(
        streams, zb, srow, vals, tot, None, K, Cp, B), 10)
    plain = time_ms(torch, lambda: SS.hist_streams_plain(
        streams, zb, srow, vals, tot, None, K, Cp, B), 2, 1)
    r0, j0 = torch.nonzero((cols < Cp) & (srow < K)[:, None], as_tuple=True)
    base = ((srow[r0].long() * Cp + cols[r0, j0].long()) * (3 * B)
            + binsv[r0, j0].long().clamp(max=B - 1))
    idx = torch.cat([base + ch * B for ch in range(3)])
    v = torch.cat([vals[ch, r0] for ch in range(3)])
    out = torch.zeros(K * Cp * 3 * B, dtype=torch.float32, device=dev)
    del base, r0, j0
    lib = time_ms(torch, lambda: out.zero_().index_add_(0, idx, v), 5, 1)
    del idx, v, out
    bms, by, _, entries = sparse_bound(torch, cols, srow, vals, K, Cp, B)
    print(f"[phase 18a] {name}: N={N} nnz={ds._inner.sparse.nnz} "
          f"(of rows in a slot, with a value: {entries}) K={K} Cp={Cp} "
          f"B={B} max_abs_err={max(errs):.3g} ms={ms:.4f} "
          f"plain_ms={plain:.4f} library_ms={lib:.4f} bound_ms={bms:.4f} "
          f"({by})", flush=True)
    del streams, cols, binsv, srow, vals, tot
    gc.collect()
    torch.cuda.empty_cache()
    return dict(name=name, route="cuda",
                source="lightgbm_tpu_torch/csrc/hist_sparse.cu",
                replaces="lightgbm_tpu/ops/histogram.py:1133",
                launches=launches, max_abs_err=max(errs), ms=ms,
                plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=lib)


def phase_ctr_bundled(torch, lt, kernels, dataset_mod, profiling, H, SS):
    """Phase 18a (the bundled csr CTR store, trained by the rounds
    learner) and 18d (the fused builder's sparse feed on a cut of it),
    and the wide sparse probe with default parameters."""
    import scipy.sparse as spm
    from lightgbm_tpu_torch.config import config_from_params
    from lightgbm_tpu_torch.learner.fused import FusedTreeLearner
    from lightgbm_tpu_torch.learner.rounds import RoundsTreeLearner
    from lightgbm_tpu_torch.synth import CTR_PARAMS, synth_ctr
    t_phase = time.perf_counter()
    dev = torch.device(GPU)
    params = dict(CTR_PARAMS, enable_bundle=True, device_type=GPU)
    t0 = time.perf_counter()
    X, y, g = synth_ctr(CTRB_ROWS, CTRB_FEATURES, CTR_DENSITY)
    Xv, yv, gv = synth_ctr(CTR_VALID_ROWS, CTRB_FEATURES, CTR_DENSITY,
                           seed=7)
    Xv = Xv.toarray()
    synth_s = time.perf_counter() - t0
    dataset_mod.reset_sparse_fallbacks()
    t0 = time.perf_counter()
    ds = lt.Dataset(X, y, group=g, params=params).construct()
    train_s = time.perf_counter() - t0
    vs = lt.Dataset(Xv, yv, group=gv, reference=ds,
                    params=params).construct()
    inner = ds._inner
    plan = inner.bundle_plan
    if plan is None or inner.sparse is None or vs._inner.sparse is None:
        fail("the bundled ctr datasets did not build a csr store over a "
             "bundle plan")
    st = dict(rows=len(y), features=CTRB_FEATURES,
              used_features=inner.num_features,
              store_columns=inner.num_store_columns,
              bundles=plan.num_bundles, conflict_rows=inner.
              bundle_conflict_rows, nnz=inner.sparse.nnz,
              ell_width=inner.sparse.nnz_capacity, synth_s=synth_s,
              setup_binning_s=inner.setup_seconds["binning"],
              setup_store_s=inner.setup_seconds["store"],
              setup_train_total_s=train_s)
    print(f"[phase 18a] bundled ctr set-up: {json.dumps(st)}", flush=True)
    conflicts = conflict_rows(inner, Xv)
    before = profiling.counters("tree/")
    _, run = drive_ctr(torch, lt, kernels, dataset_mod, params, ds, vs, Xv,
                       *CTRB_ITERS, rows_ok=~conflicts)
    run["tree_counters"] = tree_counters(profiling, before)
    run["valid_conflict_rows"] = int(conflicts.sum())
    run["valid_bundle_conflicts"] = vs._inner.bundle_conflict_rows
    print(f"[phase 18a] bundled ctr, rounds learner: {json.dumps(run)}",
          flush=True)
    for k in ("hist_sparse_f32", "table_lookup"):
        if run["launches"][k] <= 0:
            fail(f"the bundled ctr run never launched {k}")
    if run["tree_counters"][profiling.SPARSE_FALLBACKS]:
        fail("tree/sparse_fallbacks grew on the bundled ctr run")
    row = bundled_k8_row(torch, H, SS, ds, run["launches"]["hist_sparse_f32"])
    del ds, vs
    gc.collect()
    torch.cuda.empty_cache()

    # ---- a 50,000-row cut: csr against dense bundled, rounds and fused,
    # dyadic gradients; card against CPU --------------------------------
    Xc, yc = X[:CTRB_CUT], y[:CTRB_CUT]
    gc_ = g[:CTRB_CUT // 20]
    del X
    cut = {}
    for store in ("csr", "dense"):
        cfg = config_from_params(dict(params, sparse_store=store))
        cut[store] = (lt.Dataset(Xc, yc, group=gc_, params=dict(
            params, sparse_store=store)).construct()._inner, cfg)
    if cut["csr"][0].sparse is None or cut["dense"][0].sparse is not None:
        fail("the 50,000-row cut did not build csr and dense stores")
    gd, hd = dyadic_gh(torch, yc, dev)
    dataset_mod.reset_sparse_fallbacks()
    kernels.reset_launches()
    out = {}
    for store in ("csr", "dense"):
        ds_, cfg = cut[store]
        out[store] = RoundsTreeLearner(ds_, cfg).train(gd, hd)
    same_tree("18a rounds learner, bundled csr vs bundled dense (dyadic)",
              out["csr"][0], out["csr"][1], out["dense"][0], out["dense"][1])
    k8_rounds = kernels.LAUNCHES["hist_sparse_f32"]
    for store in ("csr", "dense"):
        ds_, cfg = cut[store]
        cfg = config_from_params(dict(params, sparse_store=store,
                                      tree_growth="exact"))
        learner = FusedTreeLearner(ds_, cfg)
        out[store] = learner.train(gd, hd)
    same_tree("18d fused builder, sparse feed vs dense feed (dyadic)",
              out["csr"][0], out["csr"][1], out["dense"][0], out["dense"][1])
    fused_k8 = kernels.LAUNCHES["hist_sparse_f32"] - k8_rounds
    fb = dataset_mod.sparse_fallbacks()
    print(f"[phase 18d] fused sparse feed: K8 launches {fused_k8} in one "
          f"tree of {out['csr'][0].num_leaves} leaves, sparse fallbacks "
          f"{fb}", flush=True)
    if fb:
        fail(f"a bundled csr store was densified {fb} times")
    if fused_k8 != int(params["num_leaves"]):
        fail(f"the fused sparse feed launched K8 {fused_k8} times")
    firsts = {}
    for d in ("cpu", GPU):
        p = dict(params, device_type=d)
        ds_ = lt.Dataset(Xc, yc, group=gc_, params=p)
        firsts[d] = lt.train(p, ds_, 1, verbose_eval=False)._gbdt.models[0]
    compare_first_trees("bundled ctr cut, rounds learner", firsts["cpu"],
                        firsts[GPU], 0.0, 0.0, "-")
    del cut, out, firsts, Xc
    gc.collect()
    torch.cuda.empty_cache()

    # ---- the wide sparse probe, stock parameters ------------------------
    t0 = time.perf_counter()
    Xp = spm.random(*PROBE_SHAPE, density=0.01, format="csc",
                    random_state=np.random.RandomState(0))
    yp = np.asarray(Xp[:, :10].sum(1) > 0).ravel().astype(np.float64)
    dataset_mod.reset_sparse_fallbacks()
    # the stock parameters (device_type names the card, its default)
    stock = {"verbose": -1, "device_type": GPU}
    dp = lt.Dataset(Xp, label=yp, params=stock).construct()
    bp = lt.train(stock, dp, 2, verbose_eval=False)
    pst = dict(store_columns=dp._inner.num_store_columns,
               bundles=(dp._inner.bundle_plan.num_bundles
                        if dp._inner.bundle_plan is not None else 0),
               csr=dp._inner.sparse is not None,
               learner=type(bp._gbdt.learner).__name__,
               leaves=[t.num_leaves for t in bp._gbdt.models],
               sparse_fallbacks=dataset_mod.sparse_fallbacks(),
               seconds=time.perf_counter() - t0)
    print(f"[phase 18a] default-parameter probe {PROBE_SHAPE}: "
          f"{json.dumps(pst)}", flush=True)
    if (not pst["csr"] or not pst["bundles"] or pst["sparse_fallbacks"]
            or len(pst["leaves"]) != 3 or max(pst["leaves"]) < 2):
        fail("the default-parameter probe did not train over a bundled "
             "csr store")
    run["phase_s"] = time.perf_counter() - t_phase
    print(f"[phase 18a/18d] {run['phase_s']:.1f} s", flush=True)
    return run, row


# ---- phase 19: multi-rank training on the card -----------------------------

MG_ROWS = 500_000
# the PV-Tree workload that votes a subset of the features: its rows, and
# the CPU world that trains it too (the CPU tests hold that path against
# the JAX package's voting learner; here the card is held against it)
MG_SUBSET_ROWS = 20_000
MG_ITERS = (1, 3)           # (warm-up, total) iterations a workload
MG_TIMEOUT_S = 400
_MG_INT8 = ("hist_masked_int8", "partition_rows", "table_lookup")
# name, learner parameters, kernels each rank must launch
MG_WORKLOADS = (
    ("rounds_int8_psum", dict(tree_learner="data", hist_exchange="psum"),
     _MG_INT8),
    ("rounds_int8_psum_scatter",
     dict(tree_learner="data", hist_exchange="psum_scatter"), _MG_INT8),
    ("rounds_float32", dict(tree_learner="data", histogram_dtype="float32",
                            hist_exchange="psum"),
     ("hist_masked_f32", "partition_rows", "table_lookup")),
    ("fused_feature", dict(tree_learner="feature"), ("hist_masked_f32",)),
    ("fused_voting", dict(tree_learner="voting", top_k=28),
     ("hist_masked_f32",)),
    # top_k 5 of 28 features: each split exchanges the 10 voted features'
    # histograms only, reduce-scattered over the ranks
    ("fused_voting_subset", dict(tree_learner="voting", top_k=5,
                                 hist_exchange="psum_scatter"),
     ("hist_masked_f32",)),
    # pre-partitioned: each rank loads only its rows of one TSV (the mappers
    # from every rank's sample, MG_ROWS of them, so they are the one-rank
    # mappers) and boosts over them; no leaf-id all_gather
    ("prepart_rounds_int8", dict(tree_learner="data", hist_exchange="psum",
                                 is_pre_partition=True), _MG_INT8),
    ("prepart_fused_data", dict(tree_learner="data", tree_growth="exact",
                                histogram_dtype="float32",
                                is_pre_partition=True),
     ("hist_masked_f32", "table_lookup")),
)
MG_SUBSET = "fused_voting_subset"
# the valid file of the pre-partitioned workloads (each rank scores its
# block of it)
MG_VALID_ROWS = 100_000


def _mg_fused(over: dict) -> bool:
    return (over.get("tree_learner") in ("feature", "voting")
            or over.get("tree_growth") == "exact")


def _mg_prepart(over: dict) -> bool:
    return bool(over.get("is_pre_partition"))


def mg_prepart_params(base: dict, over: dict) -> dict:
    """A pre-partitioned workload's parameters: the mapper sample covers
    every row of the file."""
    return dict(base, **over, bin_construct_sample_cnt=MG_ROWS)


def mg_write_files(d: str) -> dict:
    """The pre-partitioned workloads' TSVs (label first, %.9g):
    synth_higgs(MG_ROWS) and a valid file of synth_higgs(MG_VALID_ROWS,
    seed=7); returns their paths and the write seconds."""
    from lightgbm_tpu_torch.synth import synth_higgs
    t0 = time.perf_counter()
    files = {}
    for key, rows, seed in (("train", MG_ROWS, 42),
                            ("valid", MG_VALID_ROWS, 7)):
        X, y = synth_higgs(rows, seed=seed)
        files[key] = os.path.join(d, f"prepart_{key}.tsv")
        np.savetxt(files[key], np.column_stack([y, X]), delimiter="\t",
                   fmt="%.9g")
    files["write_s"] = time.perf_counter() - t0
    return files


def multigpu_rank(rank: int, world: int, store: str, out: str,
                  backend: str, device_type: str, names: str) -> None:
    """One rank of phase 19 (`chip_smoke.py --multigpu-rank ...`): joins
    the world, trains each workload of MG_WORKLOADS named in `names` (a
    comma list) on the mesh (the fused ones under HotPathSanitizer,
    strict) over the north-star dataset (MG_SUBSET_ROWS rows for
    MG_SUBSET, MG_ROWS for the others) and writes its model strings,
    s/iter, collective bytes, launches and divergence checks to
    out/rank<r>.json.  device_type "cpu" runs the plain versions (the
    CPU world of MG_SUBSET)."""
    import torch
    if device_type == "cpu":
        torch.cuda.synchronize = lambda *a, **k: None
    from lightgbm_tpu_torch.distributed import init_process_group
    device = init_process_group(backend, rank, world, "file://" + store,
                                local_rank=rank, timeout_s=120)
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch import kernels, profiling
    from lightgbm_tpu_torch.diagnostics.sanitize import (
        DIVERGENCE_CHECKS, DIVERGENCES, HotPathSanitizer, fused_tree_steps)
    from lightgbm_tpu_torch.synth import NORTH_STAR_PARAMS, synth_higgs
    base = dict(NORTH_STAR_PARAMS, device_type=device_type)
    datasets = {}
    res = {}
    for name, over, _ in MG_WORKLOADS:
        if name not in names.split(","):
            continue
        rows = MG_SUBSET_ROWS if name == MG_SUBSET else MG_ROWS
        valid_sets = []
        if _mg_prepart(over):
            # this rank's block of the files, loaded once
            p = mg_prepart_params(base, over)
            if "prepart" not in datasets:
                with open(os.path.join(out, "files.json")) as f:
                    files = json.load(f)
                t0 = time.perf_counter()
                tr = lt.Dataset(files["train"], params=p).construct()
                va = lt.Dataset(files["valid"], params=p,
                                reference=tr).construct()
                datasets["prepart"] = (tr, va, time.perf_counter() - t0)
            train_set, va, load_s = datasets["prepart"]
            valid_sets = [va]
        else:
            p = dict(base, **over)
            if rows not in datasets:
                X, y = synth_higgs(rows)
                datasets[rows] = lt.Dataset(X, y, params=base).construct()
            train_set = datasets[rows]
        kernels.reset_launches()
        c0 = profiling.counters()
        marks = []
        fused = _mg_fused(over)
        san = HotPathSanitizer(warmup=1, strict=True, label=name)
        with san, (fused_tree_steps(san) if fused
                   else contextlib.nullcontext()):
            bst = lt.train(p, train_set, MG_ITERS[1], valid_sets=valid_sets,
                           callbacks=[steady_window(torch, *MG_ITERS,
                                                    marks)],
                           verbose_eval=False)
        if fused:
            san.check()
        learner = bst._gbdt.learner
        c1 = profiling.counters()

        def grew(key):
            return c1.get(key, 0.0) - c0.get(key, 0.0)
        mesh = learner.mesh
        res[name] = dict(
            device=device, learner=type(learner).__name__,
            mesh=list(mesh.shape), backend=mesh.backend, rows=rows,
            model=bst.model_to_string(),
            s_iter=(marks[1] - marks[0]) / (MG_ITERS[1] - MG_ITERS[0]),
            collective_bytes_per_tree=mesh.collective_bytes / MG_ITERS[1],
            collective_calls_per_tree=mesh.collective_calls / MG_ITERS[1],
            hist_bytes_per_tree=grew(profiling.HIST_EXCHANGE_BYTES)
            / MG_ITERS[1],
            record_bytes_per_tree=grew(profiling.SPLIT_RECORDS_BYTES)
            / MG_ITERS[1],
            launches=dict(kernels.LAUNCHES),
            divergence_checks=grew(DIVERGENCE_CHECKS),
            divergences=grew(DIVERGENCES),
            implicit_transfers=san.implicit_transfers if fused else None,
            num_data=bst._gbdt.num_data)
        if valid_sets:
            rr = bst._gbdt.train_set.rank_rows
            res[name].update(
                rank_rows=[rr.start, rr.stop] if rr is not None else None,
                load_s=load_s,
                valid_auc=[v for _, m, v, _ in bst._gbdt.eval_valid()
                           if m == "auc"][0],
                valid_rows=va._inner.num_data)
        del bst, learner, mesh
        gc.collect()
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    import torch.distributed as dist
    dist.destroy_process_group()


def mg_trees(label: str, ref: str, got: str, exact: bool) -> str:
    """compare_models (lightgbm_tpu_torch/diagnostics/worlds.py) of a
    mesh model against its reference: bitwise where `exact` (int8),
    else structure equal and float lines within rtol 1e-4, atol 1e-6,
    or parted first at an f32 gain tie, as phase 7 holds card against
    CPU.  Fails the phase otherwise."""
    from lightgbm_tpu_torch.diagnostics.worlds import compare_models
    try:
        verdict = compare_models(ref, got, exact)
    except ValueError as e:
        fail(f"phase 19 {label}: {e}")
    print(f"[phase 19] {label}: {verdict}", flush=True)
    return verdict


def mg_one_rank(lt, p: dict, train_set, fused: bool) -> str:
    """The one-rank reference model of a phase 19 workload: tree_learner
    serial (exact growth: the one-device fused builder), MG_ITERS[1]
    iterations.  A pre-partitioned world takes the synchronous path
    (host trees shrunk in f64), so its reference is pinned to it."""
    p = dict(p, tree_learner="serial")
    if fused:
        p["tree_growth"] = "exact"
    if not _mg_prepart(p):
        return lt.train(p, train_set, MG_ITERS[1],
                        verbose_eval=False).model_to_string()
    bst = lt.Booster(p, train_set)
    bst._gbdt._can_pipeline = lambda: False
    for _ in range(MG_ITERS[1]):
        bst.update()
    return bst.model_to_string()


# phase 20: training observability and ingest
TELEM_ITERS = (2, 12)        # (warm-up, total) iterations of 20a's runs
TELEM_CKPT_INTERVAL = 4
RESUME_ITERS = 8
INGEST_CHUNK = 65_536
INGEST_ITERS = 3
INGEST_COMPARE = 100_000


@contextlib.contextmanager
def iteration_steps(san):
    """Run every GBDT.train_one_iter (one boosting iteration) inside one
    `san.step()`: the eval and the checkpoint between iterations stay
    outside the guard."""
    from lightgbm_tpu_torch.boosting.gbdt import GBDT
    real = GBDT.train_one_iter

    def wrapped(self, *a, **k):
        with san.step():
            return real(self, *a, **k)
    GBDT.train_one_iter = wrapped
    try:
        yield
    finally:
        GBDT.train_one_iter = real


def read_records(path: str) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def telemetry_train(torch, lt, kernels, params, ds, vs, extra, san=None):
    """One 12-iteration train of 20a: (booster, s/iter over iterations
    3-12, final valid AUC, launches)."""
    warm, n = TELEM_ITERS
    marks, res = [], {}
    kernels.reset_launches()
    steps = (iteration_steps(san) if san is not None
             else contextlib.nullcontext())
    torch.cuda.synchronize()
    with steps:
        bst = lt.train(dict(params, **extra), ds, n, valid_sets=[vs],
                       evals_result=res,
                       callbacks=[steady_window(torch, warm, n, marks)],
                       verbose_eval=False)
    if bst.current_iteration() != n:
        fail(f"[phase 20a] training stopped at {bst.current_iteration()} "
             f"of {n} iterations")
    return (bst, (marks[1] - marks[0]) / (n - warm),
            res["valid_0"]["auc"][-1], dict(kernels.LAUNCHES))


def phase_telemetry(torch, lt, kernels, params, ds, vs, tmp):
    """Phase 20a: telemetry and the training fault seams on the card."""
    from lightgbm_tpu_torch import telemetry
    from lightgbm_tpu_torch.diagnostics import faults
    from lightgbm_tpu_torch.diagnostics.sanitize import HotPathSanitizer
    warm, n = TELEM_ITERS
    telemetry.reset()
    off, s_off, auc_off, _ = telemetry_train(torch, lt, kernels, params, ds,
                                             vs, {})
    if telemetry.enabled():
        fail("[phase 20a] telemetry is on with no sink configured")
    sink = os.path.join(tmp, "train.jsonl")
    on, s_on, auc_on, launches = telemetry_train(
        torch, lt, kernels, params, ds, vs,
        {"telemetry_path": sink,
         "checkpoint_path": os.path.join(tmp, "ck.json"),
         "checkpoint_interval": TELEM_CKPT_INTERVAL})
    telemetry.reset()
    sink_san = os.path.join(tmp, "train_sanitized.jsonl")
    san = HotPathSanitizer(warmup=warm, label="telemetry/rounds")
    with san:
        guarded, s_san, _, _ = telemetry_train(
            torch, lt, kernels, params, ds, vs,
            {"telemetry_path": sink_san}, san=san)
    telemetry.reset()
    rep = san.report()
    recs = read_records(sink)
    count = {k: sum(1 for r in recs if r["name"] == k)
             for k in ("train.iteration", "train.eval", "train.checkpoint")}
    iters = [r["attrs"] for r in recs if r["name"] == "train.iteration"]
    ckpts = [r["attrs"]["iteration"] for r in recs
             if r["name"] == "train.checkpoint"]
    models = [b.model_to_string() for b in (off, on, guarded)]
    syncs = [b._gbdt.host_syncs_per_tree for b in (off, on, guarded)]
    st = dict(s_per_iter_off=s_off, s_per_iter_on=s_on,
              s_per_iter_sanitized=s_san, auc_off=auc_off, auc_on=auc_on,
              records=count, checkpoint_iterations=ckpts,
              host_syncs_per_tree_off=statistics.mean(syncs[0]),
              host_syncs_per_tree_on=statistics.mean(syncs[1]),
              phases=sorted(iters[-1]["phases"]) if iters else [],
              counters=iters[-1]["counters"] if iters else {},
              sanitize={k: rep[k] for k in (
                  "steps", "retraces_after_warmup", "implicit_transfers",
                  "compiles_total")},
              launches={k: launches.get(k, 0) for k in TREE_KERNELS})
    print(f"[phase 20a] {json.dumps(st)}", flush=True)
    print(f"[phase 20a] s/iter over iterations {warm + 1}-{n}: telemetry "
          f"off {s_off:.4f}, on {s_on:.4f}, on under the sanitizer "
          f"{s_san:.4f}; host reads a tree {st['host_syncs_per_tree_off']}"
          f" / {st['host_syncs_per_tree_on']}", flush=True)
    if len(set(models)) != 1:
        fail("[phase 20a] the model strings differ with telemetry on, off "
             "and under the sanitizer")
    if syncs[0] != syncs[1] or syncs[0] != syncs[2]:
        fail(f"[phase 20a] host reads a tree differ with telemetry: {syncs}")
    if count != {"train.iteration": n, "train.eval": n,
                 "train.checkpoint": n // TELEM_CKPT_INTERVAL + 1}:
        fail(f"[phase 20a] records {count}")
    if [a["iteration"] for a in iters] != list(range(1, n + 1)) or any(
            not {"tree", "score"} <= set(a["phases"]) for a in iters):
        fail("[phase 20a] train.iteration records lack iterations or the "
             "tree and score phases")
    if ckpts != [4, 8, 12, 12]:
        fail(f"[phase 20a] checkpoint records at iterations {ckpts}")
    if rep["implicit_transfers"] or rep["retraces_after_warmup"] \
            or rep["steps"] != n:
        fail(f"[phase 20a] sanitizer: {rep}")
    for k in TREE_KERNELS:
        if launches.get(k, 0) <= 0:
            fail(f"[phase 20a] the telemetry run never launched {k}")
    if not auc_on > 0.75:
        fail(f"[phase 20a] valid AUC {auc_on}")

    # the after-checkpoint seam: a crash as iteration 4's checkpoint
    # lands, then a resume from the file on disk
    pr = dict(params, learning_rate=0.5)
    full = lt.train(pr, ds, RESUME_ITERS, verbose_eval=False)
    ck = os.path.join(tmp, "resume.json")
    sink_r = os.path.join(tmp, "resume.jsonl")
    pc = dict(pr, checkpoint_path=ck, checkpoint_interval=2,
              telemetry_path=sink_r)
    faults.reset()
    faults.arm("train.after_checkpoint:2")
    try:
        lt.train(pc, ds, RESUME_ITERS, verbose_eval=False)
        crashed = None
    except faults.InjectedFault as e:
        crashed = e
    finally:
        faults.reset()
    if crashed is None:
        fail("[phase 20a] the armed train.after_checkpoint seam never fired")
    with open(ck) as f:
        at = json.load(f)["iteration"]
    resumed = lt.train(pc, ds, RESUME_ITERS, verbose_eval=False)
    telemetry.reset()
    res_recs = [r for r in read_records(sink_r)
                if r["name"] == "train.resume"]
    same = resumed.model_to_string() == full.model_to_string()
    print(f"[phase 20a] after-checkpoint crash at iteration {at} "
          f"({crashed}); resumed to {RESUME_ITERS}: model string equal to "
          f"the uninterrupted run's: {same}; train.resume "
          f"{[r['attrs'] for r in res_recs]}", flush=True)
    if at != 4 or not same:
        fail("[phase 20a] the resumed model is not the uninterrupted one")
    trees = 4 + (1 if resumed._gbdt.boost_from_average_used else 0)
    if [r["attrs"] for r in res_recs] != [
            {"checkpoint_iteration": 4, "trees": trees}]:
        fail(f"[phase 20a] train.resume records {res_recs}")
    st["resume_equal"] = same
    return st


def ingest_train(torch, lt, kernels, params, inner, Xv, yv, iters, label):
    """`iters` iterations on a constructed inner dataset through
    lt.train with the valid AUC: (booster, AUC, launches)."""
    from lightgbm_tpu_torch.capi import _wrap_inner
    shell = _wrap_inner(inner, params)
    res = {}
    kernels.reset_launches()
    bst = lt.train(params, shell, iters,
                   valid_sets=[lt.Dataset(Xv, yv, reference=shell)],
                   evals_result=res, verbose_eval=False)
    if bst.current_iteration() != iters:
        fail(f"[phase 20b] {label}: {bst.current_iteration()} of {iters} "
             f"iterations")
    return bst, res["valid_0"]["auc"][-1], dict(kernels.LAUNCHES)


def phase_ingest(torch, lt, kernels, base_params):
    """Phase 20b: streamed and sketch-binned datasets on the card."""
    import hashlib
    from lightgbm_tpu_torch import native
    from lightgbm_tpu_torch.config import config_from_params
    from lightgbm_tpu_torch.dataset import Dataset as RawDataset
    from lightgbm_tpu_torch.sharded.ingest import array_stream
    from lightgbm_tpu_torch.synth import synth_higgs
    X, y = synth_higgs(MAIN_ROWS)
    Xv, yv = synth_higgs(VALID_ROWS, seed=7)
    p = dict(base_params, bin_construct_sample_cnt=MAIN_ROWS,
             stream_chunk_rows=INGEST_CHUNK)
    y32 = y.astype(np.float32)
    t0 = time.perf_counter()
    streamed = RawDataset.from_stream(
        array_stream(X, y, chunk_rows=INGEST_CHUNK),
        config_from_params(p)).compacted()
    t1 = time.perf_counter()
    binned = dict(native.BINNED)
    mono = RawDataset(X, y32, config_from_params(p))
    t2 = time.perf_counter()
    P21["setup"]["20b_monolithic_s"] = t2 - t1
    P21["setup"]["20b_monolithic_store_s"] = mono.setup_seconds["store"]
    P21["setup"]["20b_stream_s"] = t1 - t0
    P21["setup"]["20b_binned"] = {k: native.BINNED[k] - binned[k]
                                  for k in binned}
    ps = dict(p, bin_find="sketch")
    sketch = RawDataset(X, y32, config_from_params(ps))
    t3 = time.perf_counter()
    sha = [hashlib.sha1(np.ascontiguousarray(d.bins).tobytes()).hexdigest()
           for d in (streamed, mono, sketch)]
    st = dict(rows=int(streamed.num_data), setup_s_stream=t1 - t0,
              setup_s_monolithic=t2 - t1, setup_s_sketch=t3 - t2,
              sha1_stream=sha[0][:16], sha1_monolithic=sha[1][:16],
              sha1_sketch=sha[2][:16])
    print(f"[phase 20b] set-up: {json.dumps(st)}", flush=True)
    if sha[0] != sha[1] or streamed.num_data != MAIN_ROWS:
        fail("[phase 20b] the streamed store differs from the monolithic "
             "one")
    del mono
    for label, inner, prm in (("streamed", streamed, p),
                              ("sketch", sketch, ps)):
        _, auc, launches = ingest_train(torch, lt, kernels, prm, inner, Xv,
                                        yv, INGEST_ITERS, label)
        st[f"auc_{label}"] = auc
        st[f"launches_{label}"] = {k: launches.get(k, 0)
                                   for k in TREE_KERNELS}
        print(f"[phase 20b] {label}: {INGEST_ITERS} iterations, valid AUC "
              f"{auc:.6f}, launches {st[f'launches_{label}']}", flush=True)
        if not auc > 0.70:
            fail(f"[phase 20b] {label} valid AUC {auc}")
        for k in TREE_KERNELS:
            if launches.get(k, 0) <= 0:
                fail(f"[phase 20b] the {label} run never launched {k}")
    del streamed, sketch
    # card against CPU on a cut, both sides on the gathered row feed
    Xc, yc = X[:INGEST_COMPARE], y[:INGEST_COMPARE]
    Xcv, ycv = Xv[:INGEST_COMPARE // 5], yv[:INGEST_COMPARE // 5]
    for label, extra in (("streamed", {}), ("sketch",
                                            {"bin_find": "sketch"})):
        out = {}
        for dev in ("cpu", GPU):
            pd_ = dict(p, device_type=dev, hist_rows="gathered", **extra)
            cfg = config_from_params(pd_)
            inner = (RawDataset.from_stream(
                array_stream(Xc, yc, chunk_rows=INGEST_CHUNK),
                cfg).compacted() if not extra
                else RawDataset(Xc, yc.astype(np.float32), cfg))
            bst, auc, _ = ingest_train(torch, lt, kernels, pd_, inner, Xcv,
                                       ycv, INGEST_ITERS,
                                       f"{label} cut on {dev}")
            out[dev] = (bst._gbdt.models[0], auc)
        compare_first_trees(f"{label} store, {INGEST_COMPARE} rows",
                            out["cpu"][0], out[GPU][0], out["cpu"][1],
                            out[GPU][1], "auc")
        st[f"card_vs_cpu_{label}"] = [out["cpu"][1], out[GPU][1]]
    return st


def phase_observability(torch, lt, kernels, params, ds, vs):
    """Phase 20 (20a, 20b) with its seconds."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        a = phase_telemetry(torch, lt, kernels, params, ds, vs, tmp)
    t1 = time.perf_counter()
    b = phase_ingest(torch, lt, kernels, params)
    t2 = time.perf_counter()
    print(f"[phase 20] {t2 - t0:.1f} s (20a {t1 - t0:.1f}, 20b "
          f"{t2 - t1:.1f})", flush=True)
    return a, b


def phase_multigpu(torch, lt, kernels, card: str):
    """Phase 19: W rank processes of this script train on the card(s)
    through lightgbm_tpu_torch.train with a distributed tree_learner;
    each model against the one-rank model trained here first, and the
    voting-subset model against a CPU world's.  The pre-partitioned
    workloads train from one TSV written here, each rank loading only
    its rows; their one-rank models load the whole file."""
    from lightgbm_tpu_torch.diagnostics.worlds import WorldFailed, run_world
    from lightgbm_tpu_torch.synth import NORTH_STAR_PARAMS, synth_higgs
    t_phase = time.perf_counter()
    n_cards = torch.cuda.device_count()
    world, backend = ((min(4, n_cards), "nccl") if n_cards >= 2
                      else (2, "gloo"))
    print(f"[phase 19] {world} ranks over {backend} on {n_cards} card(s), "
          f"synth_higgs({MG_ROWS}) x 28 ({MG_SUBSET}: {MG_SUBSET_ROWS} rows, "
          f"also in a CPU world of 2; prepart_*: from a TSV, valid "
          f"{MG_VALID_ROWS} rows), {MG_ITERS[1]} iterations a workload",
          flush=True)
    tmp_dir = tempfile.TemporaryDirectory()
    tmp = tmp_dir.name
    card_dir = os.path.join(tmp, "card")
    os.mkdir(card_dir)
    files = mg_write_files(tmp)
    with open(os.path.join(card_dir, "files.json"), "w") as f:
        json.dump(files, f)
    print(f"[phase 19] wrote the pre-partitioned TSVs in "
          f"{files['write_s']:.1f} s", flush=True)
    X, y = synth_higgs(MG_ROWS)
    base = dict(NORTH_STAR_PARAMS, device_type=GPU)
    ds = lt.Dataset(X, y, params=base).construct()
    refs = {}
    file_ds = None
    for name, over, _ in MG_WORKLOADS:
        if name == MG_SUBSET:
            continue
        if _mg_prepart(over):
            p = mg_prepart_params(base, over)
            if file_ds is None:
                # no world here: the whole file loads
                file_ds = lt.Dataset(files["train"], params=p).construct()
            refs[name] = mg_one_rank(lt, p, file_ds, _mg_fused(over))
        else:
            refs[name] = mg_one_rank(lt, dict(base, **over), ds,
                                     _mg_fused(over))
    del ds, X, y, file_ds
    gc.collect()
    torch.cuda.empty_cache()
    ref_s = time.perf_counter() - t_phase
    env = dict(os.environ, BENCH_SANITIZE="1")
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        env.pop(k, None)
    # the CPU world's two ranks share the host's cores instead of each
    # starting a thread a core
    cpu_env = dict(env, OMP_NUM_THREADS=str(max(1, (os.cpu_count() or 2)
                                                // 2)))
    me = os.path.abspath(__file__)
    all_names = ",".join(n for n, _, _ in MG_WORKLOADS)
    res = {}
    with tmp_dir:
        # the card world, then the CPU world of the voting subset
        for key, w, bk, dev, names, wenv in (
                ("card", world, backend, GPU, all_names, env),
                ("cpu", 2, "gloo", "cpu", MG_SUBSET, cpu_env)):
            t0 = time.perf_counter()
            d = os.path.join(tmp, key)
            os.makedirs(d, exist_ok=True)
            argvs = [[sys.executable, me, "--multigpu-rank", str(r), str(w),
                      os.path.join(d, "store"), d, bk, dev, names]
                     for r in range(w)]
            try:
                run_world(argvs, timeout=MG_TIMEOUT_S, env=wenv, log_dir=d,
                          name=f"phase19_{key}", tail=4000)
            except WorldFailed as e:
                fail(f"phase 19: {e}")
            res[key] = []
            for r in range(w):
                with open(os.path.join(d, f"rank{r}.json")) as f:
                    res[key].append(json.load(f))
            print(f"[phase 19] {key} world: {time.perf_counter() - t0:.1f} s",
                  flush=True)
    out = {}
    for name, over, need in MG_WORKLOADS:
        # int8 histograms are integer sums: bitwise (the fused builder
        # runs float32)
        exact = (dict(NORTH_STAR_PARAMS, **over)["histogram_dtype"]
                 == "int8" and not _mg_fused(over))
        per = [st[name] for st in res["card"]]
        for r, st in enumerate(per):
            if st["model"] != per[0]["model"]:
                fail(f"phase 19 {name}: rank {r}'s model string is not "
                     "rank 0's")
            for k in need:
                if st["launches"].get(k, 0) <= 0:
                    fail(f"phase 19 {name}: rank {r} never launched {k}")
            if st["divergence_checks"] <= 0 or st["divergences"]:
                fail(f"phase 19 {name}: rank {r} divergence checks "
                     f"{st['divergence_checks']}, divergences "
                     f"{st['divergences']}")
            if st["implicit_transfers"]:
                fail(f"phase 19 {name}: rank {r} made "
                     f"{st['implicit_transfers']} implicit transfers")
        if _mg_prepart(over):
            # the ranks' blocks tile the file, each loaded alone
            blocks = [st["rank_rows"] for st in per]
            if (blocks[0][0] != 0 or blocks[-1][1] != MG_ROWS
                    or any(a[1] != b[0] for a, b in zip(blocks, blocks[1:]))
                    or [st["num_data"] for st in per]
                    != [b - a for a, b in blocks]):
                fail(f"phase 19 {name}: rank blocks {blocks} do not tile "
                     f"{MG_ROWS} rows")
            if not all(0.5 < st["valid_auc"] <= 1.0 for st in per):
                fail(f"phase 19 {name}: local valid AUC "
                     f"{[st['valid_auc'] for st in per]}")
        if name == MG_SUBSET:
            cpu = [st[name] for st in res["cpu"]]
            if cpu[1]["model"] != cpu[0]["model"]:
                fail(f"phase 19 {name}: the CPU world's ranks differ")
            reference = "CPU world"
            trees = mg_trees(f"{name} (card vs CPU world)",
                             cpu[0]["model"], per[0]["model"], False)
            # the voted subset, not every feature: 10 of 28 features'
            # histograms a search against top_k 28's 28
            full = res["card"][0]["fused_voting"]["hist_bytes_per_tree"]
            if not 0 < per[0]["hist_bytes_per_tree"] <= 0.5 * full:
                fail(f"phase 19 {name}: {per[0]['hist_bytes_per_tree']} "
                     f"histogram bytes a tree against {full} with every "
                     "feature voted")
        else:
            reference = ("one rank, whole file" if _mg_prepart(over)
                         else "one rank")
            trees = mg_trees(name, refs[name],
                             per[0]["model"], exact)
        line = {"backend": backend, "world": world,
                "devices": [st["device"] for st in per], "workload": name,
                "rows": per[0]["rows"], "reference": reference,
                "trees_equal": trees,
                "s_iter": [st["s_iter"] for st in per],
                "collective_bytes_per_tree":
                    per[0]["collective_bytes_per_tree"],
                "hist_bytes_per_tree": per[0]["hist_bytes_per_tree"],
                "record_bytes_per_tree": per[0]["record_bytes_per_tree"]}
        if _mg_prepart(over):
            line.update(num_data=[st["num_data"] for st in per],
                        valid_auc=[st["valid_auc"] for st in per],
                        valid_rows=[st["valid_rows"] for st in per],
                        load_s=[st["load_s"] for st in per],
                        collective_mb_per_tree=[
                            st["collective_bytes_per_tree"] / 1e6
                            for st in per])
        print(json.dumps({"multigpu": line}), flush=True)
        print(f"[phase 19] {name}: learner {per[0]['learner']}, mesh "
              f"{per[0]['mesh']}, collectives a tree "
              f"{per[0]['collective_calls_per_tree']:.0f}, divergence "
              f"checks {[st['divergence_checks'] for st in per]}, launches "
              f"{json.dumps(per[0]['launches'])}", flush=True)
        out[name] = line
    phase_s = time.perf_counter() - t_phase
    print(f"[phase 19] {phase_s:.1f} s (one-rank references "
          f"{ref_s:.1f} s) on {card}", flush=True)
    return out


def phase_run_to_run_summary(card: str) -> None:
    """Phase 21e and the phase's total: the native binner must be built
    on this host and must have binned the uint8 stores of phases 17 and
    20b; their set-up seconds are printed beside which binner ran."""
    import lightgbm_tpu_torch.native as native
    probe = native.bin_numerical_native(
        np.array([[-np.inf], [-0.0], [0.5], [np.nan], [np.inf]]), [0],
        [np.array([0.0, 1.0, np.inf])])
    if probe is None or probe[0].tolist() != [0, 0, 1, 0, 2]:
        fail(f"[phase 21e] the native bulk binner did not run here: "
             f"{probe}")
    for key in ("17_binned", "20b_binned"):
        got = P21["setup"].get(key)
        if not got or not got["native"] or got["numpy"]:
            fail(f"[phase 21e] {key}: the numerical columns did not all "
                 f"bin through the native binner: {got}")
    for part in "abcd":
        if part not in P21["s"]:
            fail(f"[phase 21{part}] did not run")
    print(f"[phase 21e] set-up with the native binner: "
          f"{json.dumps(P21['setup'])}", flush=True)
    print(f"[phase 21] {sum(P21['s'].values()):.1f} s ("
          + ", ".join(f"21{k} {v:.1f}" for k, v in sorted(P21["s"].items()))
          + f") on {card}", flush=True)


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        sys.exit(2)
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch import dataset as dataset_mod
    from lightgbm_tpu_torch import kernels
    from lightgbm_tpu_torch.ops import histogram as H
    from lightgbm_tpu_torch.ops import lookup as LK
    from lightgbm_tpu_torch.ops import partition as P
    from lightgbm_tpu_torch.ops import sparse_streams as SS

    t_start = time.perf_counter()
    t0 = time.perf_counter()
    took = kernels.build()
    print(f"[build] {time.perf_counter() - t0:.1f} s "
          f"({', '.join(f'{k} {v:.1f} s' for k, v in took.items())})",
          flush=True)
    rows = phase_kernels(torch, kernels, H, LK, P)
    st, st32, ns_params, ns_ds, ns_vs, ns_Xv, ns_bst = phase_main(
        torch, lt, kernels)
    for r in rows:
        src = (st32 if r["name"] in ("hist_masked_f32", "split_search")
               else st)
        r["launches"] = src["launches"][r["name"]]
    phase_rounds_tree(torch, lt, H, ns_params, ns_ds, "north-star")
    phase_partition_tree(torch, lt, P, ns_params, ns_ds, "north-star")
    phase_rounds_tree(torch, lt, H, dict(ns_params, histogram_dtype="float32"),
                      ns_ds, "north-star, float32")
    phase_observability(torch, lt, kernels, ns_params, ns_ds, ns_vs)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[time] {time.perf_counter() - t_start:.1f} s", flush=True)

    params, ds, vs, Xv, sp = phase_ctr_setup(lt, CTR_ROWS)
    print(f"[time] {time.perf_counter() - t_start:.1f} s", flush=True)
    sparse_rows = phase_sparse_kernels(torch, H, SS, ds, sp)
    phase_learner_passes(torch, lt, H, SS, params, ds, sp)
    del sp
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[time] {time.perf_counter() - t_start:.1f} s", flush=True)
    ctr = phase_ctr_main(torch, lt, kernels, dataset_mod, params, ds, vs,
                         Xv)
    for r in sparse_rows:
        # K8 and the slot totals: from the float32 run
        src = ctr["int8" if r["name"] == "hist_sparse_int8" else "float32"]
        r["launches"] = src["launches"][r["name"]]
    rows += sparse_rows
    del ds, vs, Xv
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[time] {time.perf_counter() - t_start:.1f} s", flush=True)
    phase_card_vs_cpu(lt)
    print(f"[time] {time.perf_counter() - t_start:.1f} s", flush=True)
    from lightgbm_tpu_torch import profiling
    ctrb, k8row = phase_ctr_bundled(torch, lt, kernels, dataset_mod,
                                    profiling, H, SS)
    print(f"[time] {time.perf_counter() - t_start:.1f} s", flush=True)

    params, ds, vs, Xv = phase_onehot_setup(lt)
    gathered_rows = phase_gathered_kernels(torch, H, ds)
    print(f"[time] {time.perf_counter() - t_start:.1f} s", flush=True)
    ex, _, serial_first = phase_onehot_main(torch, lt, kernels, params, ds,
                                            vs, Xv)
    for r in gathered_rows:
        # K6 has no caller on any training path (as in the JAX package)
        r["launches"] = ex["launches"][r["name"]]
    rows += gathered_rows
    phase_k5_tree(torch, lt, H, params, ds)
    phase_rounds_tree(torch, lt, H, params, ds, "onehot, rounds learner")
    fo, k2row = phase_fused_onehot(torch, lt, kernels, params, ds, vs, Xv,
                                   serial_first)
    del ds, vs, Xv
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[time] {time.perf_counter() - t_start:.1f} s", flush=True)
    phase_lossless(lt)
    phase_onehot_card_vs_cpu(lt)
    print(f"[time] {time.perf_counter() - t_start:.1f} s", flush=True)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail("nvidia-smi did not report the card")
    card = smi.stdout.strip().splitlines()[0]
    phase_objectives(torch, lt, kernels, card)
    print(f"[time] {time.perf_counter() - t_start:.1f} s", flush=True)
    phase_training_surface(torch, lt, kernels, ns_params, ns_ds, ns_vs,
                           ns_Xv)
    print(f"[time] {time.perf_counter() - t_start:.1f} s", flush=True)
    phase_serving(torch, lt, ns_bst, ns_Xv, card)
    print(f"[time] {time.perf_counter() - t_start:.1f} s", flush=True)
    # after serving, so phase 15 reads the process as earlier versions of
    # this script left it
    fn = phase_fused_northstar(torch, lt, kernels, ns_params, ns_ds, ns_vs,
                               ns_Xv)
    print(f"[phase 18] {ctrb['phase_s'] + fo['phase_s'] + fn['phase_s']:.1f}"
          f" s (18a/18d {ctrb['phase_s']:.1f}, 18b {fo['phase_s']:.1f}, "
          f"18c {fn['phase_s']:.1f})", flush=True)
    rows += [k2row, k8row]
    del ns_ds, ns_vs, ns_Xv, ns_bst
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[time] {time.perf_counter() - t_start:.1f} s", flush=True)
    phase_online(torch, lt, kernels, card)
    print(f"[time] {time.perf_counter() - t_start:.1f} s", flush=True)
    phase_files(torch, lt, kernels, card)
    print(f"[time] {time.perf_counter() - t_start:.1f} s", flush=True)
    phase_multigpu(torch, lt, kernels, card)
    print(f"[time] {time.perf_counter() - t_start:.1f} s", flush=True)
    phase_run_to_run_summary(card)
    print(card, flush=True)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "graph_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    print(json.dumps({"kernels": [{k: r.get(k) for k in keys}
                                  for r in rows]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--multigpu-rank"]:
        multigpu_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                      sys.argv[5], sys.argv[6], sys.argv[7], sys.argv[8])
    else:
        main()
