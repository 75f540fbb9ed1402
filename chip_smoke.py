#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`predictionio_torch`) on one GPU.

Run from the root of a checkout on a machine with a CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

0. native  — before any child starts, g++ builds the native package's
             library (predictionio_torch/native: the bucketizer, the
             columnar scan, the property fold, the importer and the
             exporter) into build/torch_native/, and it must load; a
             native fallback line logged in this process, in any console
             child or in phase 10's writer child fails the run;
1. build   — nvcc builds every kernel source under predictionio_torch/csrc,
             one nvcc per source, all started together, and prints the
             -Xptxas -v report; the register kernels' instantiations
             (gj_reg.cu: KP = 16, 32, 64 × aug/packed/blocked2 layout;
             gj_cta.cu: KP = 96, 128 × the three layouts, the split
             kernel × the three, and the multi-RHS block kernel at
             KP = 64 × C = 32, 64 column slots and KP = 96, 128 × 32;
             gj_multi_reg.cu: KP = 16, 32 × one or two column slots;
             session.cu: the warp-body encoder at (D, H) = (8, 16) × (1,
             2, 4) and the tiled readout) must show a 0-byte stack frame
             and no spills;
             their SASS size goes to the report, with blocks an SM (for
             the split kernels the runtime's occupancy and dynamic shared
             bytes at K = 129, 192, 255, 256, the even ones for blocked2);
2. kernels — each of the fifteen solve kernels against its plain PyTorch
             version and a float64 solve on the card at the main paths'
             shapes, the eval path's rank-8 and rank-16 grid solves among
             them (max-rel < 1e-4, all-zero systems exactly 0), with its
             time, the plain version's, one library call's (Cholesky +
             cholesky_solve) and the card's bound (bytes, or the
             operations of a Cholesky solve); each block kernel beside
             the one it replaced, at the same shapes. The kernels (csrc/):
             the aug layout runs `gj_aug_reg` (gj_reg.cu, a warp per
             system, its rows in registers) at K ≤ 64, `gj_aug_cta`
             (gj_cta.cu, a block per system, a row per thread in
             registers) at 64 < K ≤ 128 (held at K = 80, 96, 128),
             `gj_aug_split` (gj_cta.cu, the same with each row's first
             K − 128 columns in shared memory) at 128 < K ≤ 256 (held at
             [13 850, 192, 1] and [1 024, 255, 1]) and `gj_aug`
             (gj_solve.cu, shared or device memory) above, where no route
             goes (held at K = 255, its device-memory variant, and timed
             at K = 64-192 beside the kernels that took those ranks over);
             the packed layout (PIO_GJ_LAYOUT=packed) runs the same three
             bodies with A loaded transposed, `gj_packed_reg` at K ≤ 64,
             `gj_packed_cta` at 64 < K ≤ 128 and `gj_packed_split` at
             128 < K ≤ 256, and `gj_packed` (gj_layouts.cu, a block per
             system) above (K = 255; timed at K = 128 and 192 too);
             the Schur recursion's base calls go by (K, M)
             (`multi_kernel`): `gj_aug_multi_reg` (gj_multi_reg.cu) at
             K ≤ 32, a warp per system and chunk of right-hand sides with
             its columns in registers, held against both plain versions at
             the rank-128 base calls (R = 13 850, the path's largest bucket
             2 744, and a small one, 560), at rank 96's and rank 256's, and
             timed under both chunk widths; above K = 32 with one
             right-hand side (every odd rank from 97 to 255) the aug
             kernel of K; `gj_aug_multi_cta` (gj_cta.cu, a block per
             system and chunk of up to 64 columns of B, 32 above K = 64,
             a row of A and its chunk of B per thread in registers) at
             32 < K ≤ 128 with M > 1 (ranks 2·odd and 4·odd from 98),
             held at rank 196's, 150's, 252's and 250's widest base calls
             ([13 850, 49, 50], [13 850, 75, 76], [2 744, 63, 190],
             [2 744, 125, 126]) and a small bucket, [560, 125, 126];
             `gj_aug_multi` (gj_solve.cu) keeps K > 128 with M > 1, where
             no route goes, held at rank 98's [2 744, 49, 50] and timed at
             the rank-128 shapes and beside `gj_aug_multi_cta` at its
             five;
             the blocked2 layout (PIO_GJ_LAYOUT=blocked2, even K) runs the
             aug bodies two pivots a step, `gj_blocked2_reg` at K ≤ 64
             (held at the aug kernel's four shapes), `gj_blocked2_cta` at
             64 < K ≤ 128 (K = 80, 96, 128) and `gj_blocked2_split` at
             128 < K ≤ 256 ([13 850, 192, 1] and [1 024, 256, 1]), each
             also against the plain version of `gj_blocked2`
             (gj_layouts.cu, shared or device memory), which keeps K > 256,
             where no route goes, and is timed beside them at every shape;
             the fold's shapes (phase 6): `gj_aug_reg` at [8, 64, 1] and
             [128, 64, 1], `gj_aug_multi_reg` at [128, 32, 97];
3. train   — `als_train` on synth_explicit("2m") at rank 64 (`gj_aug_reg`
             alone), rank 80 (`gj_aug_cta` alone), rank 128 (Schur
             recursion over `gj_aug_multi_reg` alone), rank 250 (Schur
             over `gj_aug_multi_cta` and `gj_aug_cta`), rank 255 (Schur
             base [R, 255, 1] on `gj_aug_split` alone), rank 64 under
             PIO_GJ_LAYOUT=packed (`gj_packed_reg`) and =blocked2
             (`gj_blocked2_reg`), rank 128 under =packed (`gj_packed_cta`)
             and =blocked2 (`gj_blocked2_cta`), rank 192 under =aug
             (`gj_aug_split`) and rank 256 under =packed
             (`gj_packed_split`) and =blocked2 (`gj_blocked2_split`); each
             run launches its kernels and no
             other; each RMSE trajectory within rtol 2e-3 of a
             solver="chol" run of its rank; profiles of the rank-64, 80
             and 128 trains must show their register kernel and no
             `gj_kernel<` (gj_solve.cu's);
4. serve   — synth_explicit("100k") as a JSON-lines events file,
             `console train` on the card, `console deploy --port 0` in a
             subprocess, POST /queries.json answers equal the in-process
             model's and exclude seen items; one 1,024-user batch_predict
             through the device branch of recommend_topk agrees with the
             host branch wherever scores are not tied; then the store:
             `console app new`, `console import` of the events file into
             a pio.db under a fresh PIO_FS_BASEDIR, `console train` from
             the store (an engine-instance row and a model blob) and
             `console deploy` of the latest completed instance, whose
             answers equal the events-file model's top-k ids wherever the
             scores are not tied;
5. eval    — (a) `als_train_grid` at `2m`, rank 64, λ ∈ {0.01, 0.1} with
             solver chol and with gj under the auto, packed and blocked2
             layouts: each gj grid's per-cell RMSE within rtol 2e-3 of the
             chol grid's, and the auto grid's cells equal to sequential
             `als_train` runs (factors rel < 1e-4); (b) `console eval` of
             RecommendationEvaluation on phase 4's events file in a
             subprocess under each layout: the grid path (3 folds × 2 rank
             groups), the layout's warp kernel launched at K = 8 and at
             K = 16, the same best cell and
             per-cell MAP@10 within rel 2e-3 + abs 2e-5 of the auto run's;
             (c)
             `console batchpredict` of 1,024 queries on phase 4's model in
             a subprocess equals the in-process batch_predict;
6. fold    — on phase 3's `2m` rank-64 and rank-128 `auto` models (full
             width): 1,000 existing users re-rating, 100 never-seen users
             and 20 never-seen items written to a sqlite store beside the
             re-raters' training ratings, collected by a batch-mode
             StoreTailer, each dirty user's and new item's full history
             gathered from the store, then `fold_model` on the card. Bars:
             folded rows within rtol 1e-3 / atol 1e-4 of a float64 solve
             of their weighted normal equations; eight users folded alone
             bitwise equal to the eight folded together at their shared
             tier; a replay bitwise idempotent; untouched rows bitwise
             unchanged; cold rows appended with the BiMaps extended; a
             folded user's recommendations exclude what it rated; the
             solves launch the rank's kernel alone (`gj_aug_reg` at 64,
             `gj_aug_multi_reg` under Schur at 128). Reported: fold wall
             ms at 1, 8, 32 and 128 dirty users and for the backlog, the
             backlog's host (bucketing, upload) and device (solve) ms,
             launches by tier, and the difference between a user folded
             alone and inside the backlog (another row tier; not gated).
7. online  — the online plane (`online/plane.py`) in a deployed server:
             (a) `console deploy` of phase 4's pio.db with PIO_ONLINE=1
             in a child process; 20 rounds written into that pio.db with
             the storage API (one never-seen user rating 3 items, 4
             existing users re-rating one item each), each polled with
             POST /queries.json until the new user is served without
             what it rated (30 s a round). Bars: 20 of 20 rounds
             servable, GET /'s `online.eventsFolded` equal to the events
             written, the child's launches `gj_aug_reg` alone. Reported:
             event → servable ms (write commit → first answer that
             reflects it), /metrics' `online_event_to_servable_seconds`,
             `online_foldin_seconds` and `storage_op_seconds`, query ms
             before and after the first fold. (b) In process on a copy of
             that pio.db (fold_items=False): the crash drill at
             `online.pre_watermark` (the fold lands, the replay is bitwise
             equal, the next poll folds nothing), a second train and POST
             /reload (a new user then folds into the new instance), and
             `parity_check` (rel_max ≤ 0.05). (c) Phase 3's `2m` rank-64
             and rank-128 models as completed instances in phase 6's
             store, each served with the plane (fold_items=False): one
             poll of phase 6's backlog with a cold history cache, one
             after each of its 1,100 users re-rates an item (warm);
             history gather and fold ms of both, launches `gj_aug_reg`
             alone at rank 64 and `gj_aug_multi_reg` alone at 128.
8. serving — the serving plane (`serving/`) behind /queries.json. Four
             `console deploy` children start together. (a) Phase 6's
             store's `2m` rank-64 instance (13 850 users × 2 700 items)
             with the default PIO_SERVING_* and with
             PIO_SERVING_BATCHING=0: 2,000 seeded {"user", "num": 10}
             queries from 1, 8 and 32 keep-alive clients (`http.client`,
             a thread and a connection each); qps, p50 and p99 ms, and
             from /metrics the dispatches, mean batch size and padded
             rows. Bar: every answer equals, byte for byte, the
             one-client batching-on answer to the same query. (b) The same
             instance with PIO_SERVING_MAX_BATCH=128 and
             PIO_SERVING_MAX_QUEUE=256 under 128 clients, twice (cold:
             the child's first device dispatch; warm): the batches
             above 64 (`recommend_topk`'s device branch) and their
             share; bars: at least one such batch a run, and every
             answer's item ids equal (a)'s wherever the scores are not
             tied (the max abs score difference is reported). (c) In process: phase 4's
             model and an als + popular model trained from phase 4's
             events file (in phase 4, on the train → serve path);
             X-PIO-Deadline-Ms: 0.0001 → 503, a shed
             (max_queue 0) → 200 + X-PIO-Degraded: 1 with the
             popularity answer, and 429 without the popularity algorithm,
             each with Retry-After, counted on /metrics. (d) Phase 4's
             store with PIO_ONLINE=1, PIO_HTTP_RESULT_CACHE=1 and a 600 s
             TTL: once the plane has folded phase 7's events, users u and
             w answer twice (the second a hit); u rates three of its
             recommended items, and within 30 s its answer leaves them
             while w's stays a hit (only the invalidation bus can explain
             u's fresh answer); POST /reload makes w a miss. The child's
             folds launch `gj_aug_reg`.
9. eventserver — the port's event server (`data/api.py`, `ingest/
             writer.py`) in `console eventserver --port 0` children on
             phase 6's store, beside a `console deploy` child of its `2m`
             rank-64 instance with PIO_ONLINE=1 and
             PIO_HTTP_RESULT_CACHE=1; the access keys and a channel made
             with the console. (a) 2,000 seeded rate events on existing
             users and items from 1, 8 and 32 keep-alive clients with
             group commit on, 32 against a child with
             PIO_INGEST_GROUPING=0, then one /batch/events.json of 50:
             events/s, p50 and p99 ms of a 201, /metrics' commits, group
             count and sum, sheds. Bars: every 201's id reads back through
             GET /events/<id>.json, and the app's rows in pio.db grew by
             exactly the 201s (no row without its 201, no 201 without its
             row). (b) The contract: 401 on a bad key, 400 on an invalid
             event and on an event outside the key's whitelist, 404 for
             an unknown connector, 201 through /webhooks/segmentio.json,
             `?channel=` writing to the channel, and against a child with
             PIO_INGEST_MAX_QUEUE=1 under 32 clients at least one 429,
             each with Retry-After, all counted in ingest_shed_total.
             (c) 20 rounds as phase 7a's (a never-seen user rating 3
             items, 4 existing users re-rating one), each event a single
             POST /events.json, each polled on the deploy child's
             /queries.json until the new user is served without what it
             rated (30 s a round; median and max ms from the round's last
             201). The deploy child's folds launch `gj_aug_reg` alone; the
             event-server children never initialise CUDA and are absent
             from `nvidia-smi --query-compute-apps`.

10. templates — the similarproduct, ecommerce and productranking
             templates at their shipped engine.json (rank 10, 20
             iterations). (a) A child started with the run writes
             synth_implicit("2m")'s 1.8 M training pairs as `view` events
             of app "Shop" (one second apart), a seeded one in eight also
             as a `buy`, a `$set` of 1-2 of 8 categories on every item and
             a `$set` on constraint/unavailableItems naming 20 items, as a
             JSON-lines file, and `console import`s it (the native
             importer) into a sqlite pio.db, the file deleted after; the
             import's seconds beside `insert_batch`'s (20,000 a chunk) on
             the first 200,000 of those events into a scratch store. On
             the store, in that child: the templates' `find_columnar`
             (views and buys, unordered) and `aggregate_properties` of the
             items, each on the native tier and then under PIO_NATIVE=0
             (the SQL tier): their seconds, and both reads equal bit for
             bit. `console status`'s native line. (b) `console template
             get … --app-name` and `console build` of each, then `console train` of each in a child (the
             two implicit ones from that store, productranking from phase
             4's): the data-read, prepare and train seconds from its log,
             its launches by rank (`gj_aug_reg` at K = 10 alone), a
             completed instance; in process, on the PreparedData each
             implicit template's train ran on (saved by the child), the
             train under `auto` (epoch ms) and its RMSE trajectory under
             `auto` and chol within 2e-3. (c) Three `console deploy` children, the result
             cache off: similarproduct 1,000 seeded one-item queries from
             1 and 32 keep-alive clients, byte for byte the in-process
             answer of the instance's model, and a categories, whiteList
             and blackList query obeying its filter; ecommerce 1,000
             seeded user queries from 1 and 32 clients, none holding an
             item its user viewed or bought or an unavailable one, a
             never-seen user with three views written then answered
             through the cold-start path, a new constraint obeyed within
             30 s; productranking 200 queries of 10 candidates from 1 and
             32 clients, equal to the in-process answer, scores
             descending, a never-seen user's candidates in order with
             isOriginal. qps, p50, p99, dispatches and mean batch of each
             run. (d) `console import` of synth_implicit("100k") into app
             "Shop100k" of phase 4's store (the native importer; its rows
             equal a PIO_NATIVE=0 import's of the same file into a scratch
             store apart from event ids and creation times, and `console
             export` of the app byte for byte the PIO_NATIVE=0 export)
             and `console eval` of
             SimilarProductEvaluation there (3 folds; MAP@10 per cell, the
             best, the wall; 3 grid trains of 4 cells on `gj_aug_reg` at
             K = 8 alone; a completed evaluation instance), run beside
             (b); `console template list`.
11. runtime — the train runtime on phase 3's `2m` data, run before phase
             10; a child started with the run imports the training ratings
             into a store of their own (app MyApp2m, `console import`).
             (a) `als_train` at rank 64 and 128 (auto) with a fresh
             bucket_cache_dir, a miss then a hit: the set-up seconds
             (call wall − Σ epochs) of each and the entry's bytes; bars:
             the hit's factors bitwise the miss's, its buckets bitwise
             the native bucketizer's. (b) The crash drill, `console
             train` children on that store at rank 64 (auto), 10 epochs:
             one uninterrupted, and one with `--checkpoint-dir D
             --checkpoint-every 1` and PIO_FAULTS=als.epoch_boundary:4,
             which dies (exit 137) after its 4th epoch and before that
             epoch's save; the same command again logs "resumed from
             checkpoint step 3" and a bucket-cache hit. Bars: its factors
             bitwise the uninterrupted train's, its `gj_aug_reg`
             launches 7/10 of that train's. (c) `console eval` of
             HoldoutEvaluation (this module: one fold, the whole app
             against phase 3's held-out ratings, rank 64 × λ {0.01, 0.1})
             with the cache on and with PIO_BUCKET_CACHE=0, beside the
             resumed train: the grid's bucketing a hit on the train's
             entry, its set-up seconds against the miss's, the same
             scores. (d) `console train --profile-dir` on phase 4's
             store: the trace names `gj_reg_kernel` and the train's
             read, prepare and als stages. (e) `2m` rank-64 trains at
             split cap 1 024 (split rows on both sides), plain, under the
             assert mode (`--check-asserts`) twice, plain: all bitwise
             equal, the epoch times; the split rows' old combine (a float
             `index_add_`, atomics) against the port's fixed-order one on
             the item side's buckets: ms, and whether each repeats its
             bits.
12. classify — the classification ops (`ops/classify.py`) and the
             classification and leadscoring templates, run last; a child
             started with the run writes their store (`console import`,
             the native importer): 2,000,000 `$set` / `$unset` / `$delete`
             property events of 200,000 users in a 90 / 8 / 2 mix (the
             reference's bench_aggprops shape; attr0-attr2 and the "plan"
             label) and 200,000 `view` sessions with about 10 % `buy`s.
             (a) Config 2's shape, 1,000,000 × 128 f32 → 10 classes, made
             on the card, linearly separable: `logreg_train` at 200 Adam
             iterations (wall, upload ms, device ms a step by CUDA events,
             peak memory, training accuracy), again and with
             `checkpoint_every` 50 (bars: the same bits), the first
             100,000 rows on the card against the CPU (rtol 2e-4 / atol
             1e-5), `naive_bayes_train` on |x|. (b) 8-cell grids at
             200,000 × 16 → 4: `logreg_train_grid` with mixed horizons
             (≤ 200) and `naive_bayes_train_grid`, each beside its 8
             sequential fits, every cell within rtol 2e-4 / atol 1e-5
             (NB 1e-6 / 1e-7) of its fit. (c) `console template get` and
             `build` of classification, `console train` of its `naive`
             default and of a `logisticregression` variant (store read,
             fit, wall; the points must be the writer's), `console
             deploy` of each, 100 queries each equal to the in-process
             model's answer. (d) leadscoring: `console train` at 300
             iterations, deploy, 100 queries equal to the in-process
             answer, `console eval` of LeadScoringEvaluation (AUC by
             regParam, each > 0.6). (e) The drill: `console train
             --checkpoint-dir D --model-out M` of leadscoring with
             PIO_FAULTS=logreg.step_boundary:3 dies (exit 137) after its
             3rd chunk of 30 steps; the same command again resumes from
             step 60, and M's model bytes equal (d)'s uninterrupted
             model's. Each line carries the card's name and power limit.
13. text   — the text ops (`ops/text.py`) and the textclassification
             template, run last; a child started with the run writes its
             store (`console import`): 50,000 `$set` content documents
             of 8 categories, 8-24 tokens each from a 20,000-word Zipf
             vocabulary and 100 words a category (app Text50k). (a) The
             SGNS loop at the JAX package's benchmarks/w2v_roofline.py
             shape: V 100,000 × dim 128, batch 16,384, 5 negatives,
             1,000,000 seeded pairs, 500 steps through
             `word2vec_fit_pairs`: wall, peak memory, the step's device
             ms by CUDA events and pairs/s, its bound (each row a step
             touches read and written once; beside it every gathered row
             read, then read and written by the scatter); a second fit, a
             fit in chunks of 100 and one resumed from step 300 bitwise
             the first; the fixed-order scatter against `index_add_` and
             `index_put_(accumulate=True)` on the same batches (ms, and
             whether each repeats its bits); 50 steps on the card and on
             the CPU from the same tables and draws (rtol 1e-5 /
             atol 1e-6). (b) `console template get` and `build`, `console
             train` of the shipped `nb` (numFeatures 1024), of `lr` (200
             iterations) and of `word2vec` (dim 128, window 2, 5
             negatives, batch 16,384, 500 steps, head 200 iterations):
             read, prepare and fit seconds; `console deploy` of each, 100
             queries each equal to the in-process answer (p50, p99);
             `console eval` of TextEvaluation (NB, 3 folds, accuracy).
             (c) The drills: a `word2vec` train with `--checkpoint-dir`
             killed (exit 137) by PIO_FAULTS=w2v.step_boundary:2 resumes
             from step 50 and runs 450 SGNS steps; one killed by
             logreg.step_boundary:2 in its head resumes the embeddings
             from step 500 (no SGNS step) and the head from step 20; both
             models' bytes equal (b)'s uninterrupted train's. Each line
             carries the card's name and power limit.
14. basket — the basket ops (`ops/basket.py`) and the
             complementarypurchase template, run last; a child started
             with the run writes its store (`console import`): 200,000
             `buy` events of 20,000 users over 2,000 Zipf items, in
             baskets of 1 + Poisson(9) items 60-300 s apart, a user's
             baskets 6 h apart (app Cart200k). (b) `console template get`
             and `build`, then `console train` (the shipped defaults) in a
             child beside (a): (a) `mine_rules` with the template's
             defaults at its dense bound, 8,192 items × 200,000 seeded
             baskets of 1 + Poisson(9) Zipf items (the public Instacart
             data's ~10-item mean order), 20 of them "bot" baskets of
             600-2,000 distinct items with repeats: wall, peak memory,
             the dense path taken (its cap warning, no fallback line);
             the same call in its pieces (host pre-pass, upload, the Gram
             by the host's clock and by CUDA events, C's copy back, the
             host rule pass), its rules bitwise the first's; C equal,
             entry for entry, to an independent count (the deduped and
             capped in-basket pairs enumerated with numpy and counted by
             `np.bincount`); the Gram's bound (2·baskets·items² int8
             operations at 1,979 TOP/s, beside bf16's and f32's); at
             1,024 × 20,000 the card's C and rules bitwise the CPU's; at
             300 × 3,000 the host fallback (`max_dense_items=1`) with the
             dense path's rules. (b) The train's read, prepare and train
             seconds (its log: every event read, every basket formed),
             `console deploy`, 100 carts of 1-3 items (some unknown,
             `num` 1-10) each equal to the persisted model's in-process
             answer (p50, p99). Each line carries the card's name and
             power limit.
15. session — the attention op and the sessionrec template, run last; a
             child started with the run writes its stores (`console
             import`): 200,000 `view` events of 20,000 users over 2,000
             items (app Sess200k) and 20,000 of 2,000 users over 500
             items (app Sess2k), each user's views a walk over the
             catalog (1-3 items ahead, else a Zipf draw), every event
             time distinct. (d) `console template get` and `build`, then
             `console train` of the shipped engine.json (D 16, 1 block, 2
             heads, window 32, 30 epochs) in a child beside (a)-(c):
             (a) the two kernels of csrc/session.cu, `session_encode` (a
             warp a history at tiers ≤ 32) and `session_readout` (item
             tiles in shared memory), against their plain versions on
             the card at V 8,192 for (D, blocks) = (16, 1), (8, 1), (16,
             2), at every seq tier of the default ladder (8, 16, 32) and
             of PIO_SERVING_SEQ_TIERS=5,12 (with 32) and every batch tier
             1, 2, 4 … 64: within rtol 1e-5 / atol 1e-6, bitwise their
             first versions (`_v1`), `score`'s launch pair bitwise the
             two launched apart, and every row bitwise the same history
             scored alone at its own tier; at [64, 32, 16, 8,192] each
             kernel, its `_v1` kernel and the BLAS formulation
             (`encode`; `torch.matmul`) in turns (v1, new, BLAS, BLAS,
             new, v1): ms a call by CUDA events, device ms a launch by
             torch.profiler; its plain version's ms and its bound; one
             query (tier 8, batch 1) through `score` beside the `_v1`
             pair; then, with the kernels' counts zeroed, (b) the
             template's fit at 8,192 users × 8,192 items (windows of 2-32
             distinct Zipf items), 30 epochs: ms an epoch by CUDA events,
             wall, peak memory, losses, a second fit bitwise equal; 1,000
             queries of 1-40 items (every third a user's window) through
             `batch_predict` in mixed batches, each answer equal to that
             query's alone; (c) 512 users × 256 items, 4 epochs, on the
             card and the CPU: each epoch's loss within rtol 1e-4, the
             top-10 ids equal wherever the CPU's scores are more than
             1e-5 apart; (d) the train's read, prepare and train seconds
             (its log: every user read, every item trained), `console
             deploy`, 100 queries (half {"user"}, half {"items"}) each
             equal to the persisted model's in-process answer (p50,
             p99), and SessionRecEvaluation in this process on Sess2k (3
             folds; MAP@10 of each cell of (8, 16) × (1, 2)); (e) the
             online session fold in that deploy child, started with
             PIO_ONLINE=1: 20 rounds written into its pio.db with the
             storage API (a never-seen user viewing 3 items, 4 existing
             users one each, the first an item it viewed before, which
             moves to the end of its window; one round's last view a
             never-seen item), each polled with POST /queries.json until
             the new user is served without what it viewed (30 s a
             round). Bars: 20 of 20 rounds servable; every folded user's
             served answer equal to the persisted model folded in this
             process by `SessionFold` on the same histories read from
             the store, and to its new window sent as {"items"}; GET /'s
             `online.eventsFolded` equal to the events written;
             `session_windows_folded_total` and
             `session_cold_items_total` moved; the child launched both
             session kernels and no `_v1` and no solve kernel. Then in
             this process a backlog of 1,000 existing and 100 new users
             folded, and 64 of them scored in one batch equal to each
             alone. Reported: event → servable ms, the fold's ms for one
             user and for the backlog. Each line carries the card's name
             and power limit.
16. parity — the quality-parity bar at BASELINE.md's parity
             configuration: `run_parity` at `2m` (13,850 × 2,700),
             rank 64, 10 iterations, λ 0.05, explicit and implicit (α
             40), the port's ALS trained on the card, the MLlib-faithful
             numpy ALS (`quality/mllib_als.py`) trained on the same split
             by a child started with the run (niced, two BLAS threads),
             which writes its factors and the implicit split to a file.
             Bars: the port's explicit held-out RMSE at most the
             MLlib-faithful side's + 0.01, both below 1.0; its implicit
             MAP@10 at least 0.9 × the MLlib-faithful side's, both above
             0.01; the trains launch `gj_aug_reg` alone. Reported: both
             metrics, both sides' epoch seconds, the port's wall.

Launch counts are zeroed just before each path (phases 3-4: train →
serve; phase 5: eval → batchpredict; phase 6: fold; phase 7: online,
with the deployed child's counts added; phase 8: serving, with the four
children's counts added; phase 9: eventserver, with the deploy child's
counts added; phase 10: templates, with every console child's counts
added; phase 11: runtime, with its console children's counts added, the
killed train's lost with it; phase 12: classify, with every console
child's counts added; phases 13, 14 and 15: text, basket and session,
likewise; phase 15's own kernels from 15b on, 15e's in-process scoring
and its deploy child's folds and queries among them; phase 16: parity)
and read just after;
every kernel of a path must have launched there (on the serving path,
`gj_aug_reg` in (d)'s child alone), and `gj_aug`, `gj_packed`
and `gj_blocked2` (K > 256 only) and `gj_aug_multi` (K > 128 with M > 1
only) on none; the paths of phases 12-15 solve no system and launch no
solve kernel, and phase 15's path launches both session kernels and
neither `_v1` kernel; phase 16's launches `gj_aug_reg` alone. The eval
path's counts add the console
children's own to the grids'; the sequential trains phase 5a compares
with run before its counts are zeroed. `--report PATH` also writes a JSON report
with every number (the ptxas output, the profile's kernel table). The last
stdout line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import dataclasses
import io
import json
import logging
import os
import pickle
import queue
import re
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from datetime import datetime, timedelta, timezone

HERE = os.path.dirname(os.path.abspath(__file__))
# H100 SXM data-sheet peaks (dense, at the 700 W limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
REL_BAR = 1e-4
RMSE_RTOL = 2e-3
ITERATIONS = 3
# per-cell MAP@10 of a forced layout against the auto run's. The layouts'
# factors differ by float rounding, which can swap two near-tied items
# for a few of the ~943 test users of a fold. A swap that moves one
# held-out item across the top-10 boundary changes that user's AP by
# ~0.1/10 and the cell's 3-fold mean by ~3.5e-6: the absolute term allows
# about six such swaps, the relative one the rounding of the mean itself
MAP_RTOL = 2e-3
MAP_ATOL = 2e-5
EVAL_CLASS = ("predictionio_torch.templates.recommendation.evaluation."
              "RecommendationEvaluation")
# the TPU kernel each port kernel replaces, and the port's source
_AUG = "predictionio_tpu/ops/pallas_solve.py:249"
_PACKED = "predictionio_tpu/ops/pallas_solve.py:101"
_MULTI = "predictionio_tpu/ops/pallas_solve.py:296"
_BLOCKED2 = "predictionio_tpu/ops/pallas_solve.py:177"
KERNELS = {
    "gj_aug_reg": (_AUG, "gj_reg.cu"),
    "gj_aug_cta": (_AUG, "gj_cta.cu"),
    "gj_aug_split": (_AUG, "gj_cta.cu"),
    "gj_aug": (_AUG, "gj_solve.cu"),
    "gj_aug_multi_reg": (_MULTI, "gj_multi_reg.cu"),
    "gj_aug_multi_cta": (_MULTI, "gj_cta.cu"),
    "gj_aug_multi": (_MULTI, "gj_solve.cu"),
    "gj_packed_reg": (_PACKED, "gj_reg.cu"),
    "gj_packed_cta": (_PACKED, "gj_cta.cu"),
    "gj_packed_split": (_PACKED, "gj_cta.cu"),
    "gj_packed": (_PACKED, "gj_layouts.cu"),
    "gj_blocked2_reg": (_BLOCKED2, "gj_reg.cu"),
    "gj_blocked2_cta": (_BLOCKED2, "gj_cta.cu"),
    "gj_blocked2_split": (_BLOCKED2, "gj_cta.cu"),
    "gj_blocked2": (_BLOCKED2, "gj_layouts.cu"),
}
# the ranks each kernel takes on the paths below
KERNEL_RANKS = {"gj_aug_reg": "aug, K ≤ 64; Schur base [R, K, 1] at odd "
                              "K 33-63",
                "gj_aug_cta": "aug, 64 < K ≤ 128 (auto: rank 65-95); Schur "
                              "base [R, K, 1] at odd K 65-127",
                "gj_aug_split": "forced aug, 128 < K ≤ 256; Schur base "
                                "[R, K, 1] at odd K 129-255",
                "gj_aug": "aug, K > 256 (no route: ranks stop at 256)",
                "gj_aug_multi_reg": "Schur base, K ≤ 32",
                "gj_aug_multi_cta": "Schur base, 32 < K ≤ 128 with M > 1 "
                                    "(ranks 2·odd and 4·odd from 98)",
                "gj_aug_multi": "Schur base, K > 128 with M > 1 (no route)",
                "gj_packed_reg": "forced packed, K ≤ 64",
                "gj_packed_cta": "forced packed, 64 < K ≤ 128",
                "gj_packed_split": "forced packed, 128 < K ≤ 256",
                "gj_packed": "forced packed, K > 256 (no route)",
                "gj_blocked2_reg": "forced blocked2, even K ≤ 64",
                "gj_blocked2_cta": "forced blocked2, even 64 < K ≤ 128",
                "gj_blocked2_split": "forced blocked2, even 128 < K ≤ 256",
                "gj_blocked2": "forced blocked2, K > 256 (no route)"}
# phase 6: the ranks it folds at, the solve kernel each launches (the
# aug kernel of rank 64, the Schur base kernel at 128), the batch sizes it
# times, the new events of the backlog and when they start
FOLD_RANKS = (64, 128)
FOLD_KERNEL = {64: "gj_aug_reg", 128: "gj_aug_multi_reg"}
FOLD_SIZES = (1, 8, 32, 128)
FOLD_RERATERS, FOLD_NEW_USERS, FOLD_NEW_ITEMS = 1_000, 100, 20
FOLD_T0 = datetime(2026, 2, 1, tzinfo=timezone.utc)
# the kernels on no main path: gj_aug, gj_packed and gj_blocked2
# (K > 256), gj_aug_multi (K > 128 with M > 1)
OFF_PATH = ("gj_aug", "gj_packed", "gj_aug_multi", "gj_blocked2")
PATH_KERNELS = [name for name in KERNELS if name not in OFF_PATH]
# the register kernels' sources: (kernel symbols, instantiations)
REG_SOURCES = {"gj_reg": (("gj_reg_kernel",), 9),
               "gj_cta": (("gj_cta_kernel", "gj_split_kernel",
                           "gj_multi_cta_kernel"), 13),
               "gj_multi_reg": (("gj_multi_reg_kernel",), 4)}
# the split kernels' ranks whose shared memory and occupancy phase 1
# reports (the pair kernel's: the even ones)
SPLIT_REPORT_RANKS = (129, 192, 255, 256)
# the split kernels by their layout template argument (kLayout)
SPLIT_KERNELS = ("gj_aug_split", "gj_packed_split", "gj_blocked2_split")
# the kernel each PIO_GJ_LAYOUT runs at rank ≤ 64
LAYOUT_KERNEL = {"auto": "gj_aug_reg", "packed": "gj_packed_reg",
                 "blocked2": "gj_blocked2_reg"}
# the kernels that keep their working copy in registers (the split ones
# in registers and shared memory), each also held against the plain
# version of the shared-memory kernel that ran its ranks before
REGISTER_KERNELS = ("gj_aug_reg", "gj_aug_cta", "gj_aug_split",
                    "gj_aug_multi_reg", "gj_aug_multi_cta", "gj_packed_reg",
                    "gj_packed_cta",
                    "gj_packed_split", "gj_blocked2_reg", "gj_blocked2_cta",
                    "gj_blocked2_split")
# each kernel that took ranks over from an older one, and that kernel
# (gj_packed_reg's, gj_packed with ⌊128/K⌋ systems a block, is gone: its
# times stand in PERF.md)
REPLACED = {"gj_aug_cta": "gj_aug", "gj_packed_cta": "gj_packed",
            "gj_aug_split": "gj_aug", "gj_packed_split": "gj_packed",
            "gj_blocked2_reg": "gj_blocked2",
            "gj_blocked2_cta": "gj_blocked2",
            "gj_blocked2_split": "gj_blocked2",
            "gj_aug_multi_cta": "gj_aug_multi"}
# phase 4's store: the PIO_FS_BASEDIR its pio.db lies under (phase 7
# deploys it with the online plane)
STORE_BASE = "pio_base"
# phase 7: the rounds written into the deployed store (each one
# never-seen user rating ONLINE_NEW_RATINGS items and ONLINE_RERATERS
# existing users re-rating one item), the seconds a round may take to
# become servable, and the queries timed before and after the first fold
ONLINE_ROUNDS, ONLINE_NEW_RATINGS, ONLINE_RERATERS = 20, 3, 4
ONLINE_ROUND_TIMEOUT_S = 30.0
ONLINE_TIMED_QUERIES = 50
ONLINE_PARITY_BAR = 0.05
# phase 8: the queries of each load run (8a, 8b), the client counts of 8a
# and 8b, the seconds a fold may take to reach a cached answer (8d), and
# the knobs a deploy child takes only where phase 8 sets them
SERVING_QUERIES = 2_000
SERVING_CLIENTS = (1, 8, 32)
SERVING_DEVICE_CLIENTS = 128
CACHE_RYW_TIMEOUT_S = 30.0
SERVING_KNOBS = (
    "PIO_SERVING_BATCHING", "PIO_SERVING_MAX_BATCH",
    "PIO_SERVING_MAX_WAIT_MS", "PIO_SERVING_MAX_QUEUE",
    "PIO_SERVING_DEFAULT_DEADLINE_MS", "PIO_SERVING_RETRY_AFTER_S",
    "PIO_HTTP_RESULT_CACHE", "PIO_HTTP_RESULT_CACHE_SIZE",
    "PIO_HTTP_RESULT_CACHE_TTL_S", "PIO_ONLINE", "PIO_ONLINE_INTERVAL_S",
    "PIO_ONLINE_FOLD_ITEMS", "PIO_ONLINE_MAX_BATCH", "PIO_ONLINE_APP_ID",
    "PIO_FAULTS", "PIO_INGEST_GROUPING", "PIO_INGEST_MAX_GROUP",
    "PIO_INGEST_MAX_WAIT_MS", "PIO_INGEST_MAX_QUEUE",
    "PIO_INGEST_RETRY_AFTER_S")
# phase 9: the events of each ingest run (9a), its client counts, the
# events of its batch POST, the requests of the shedding run (9b)
INGEST_EVENTS = 2_000
INGEST_CLIENTS = (1, 8, 32)
INGEST_BATCH = 50
SHED_EVENTS = 640
# phase 10: the templates' store (synth_implicit's training pairs at
# TEMPLATE_SCALE as views of TEMPLATE_APP, one pair in BUY_EVERY also a
# buy, every item `$set` with 1-2 of TEMPLATE_CATEGORIES categories,
# UNAVAILABLE items in the constraint), the queries of each server's
# load runs and their client counts, the seconds a new constraint may
# take to be obeyed (the ecommerce lookups' TTL is 3 s), and the eval
TEMPLATE_SCALE = "2m"
STORE_RESULT = "store.json"
TEMPLATE_APP = "Shop"
TEMPLATE_CATEGORIES = 8
BUY_EVERY = 8
UNAVAILABLE = 20
TEMPLATE_QUERIES = 1_000
TEMPLATE_CLIENTS = (1, 32)
RANKING_QUERIES, RANKING_CANDIDATES = 200, 10
CONSTRAINT_TIMEOUT_S = 30.0
TEMPLATE_NAMES = ("ecommerce", "productranking", "recommendation",
                  "similarproduct")
TEMPLATE_EVAL_APP = "Shop100k"
# the native line of `console status`, before its status
NATIVE_STATUS = "Native fast paths (scan/bucketize/import/export/aggregate):"
# 10a: the events of the template store that `insert_batch` also writes,
# into a scratch store, beside the native import of all of them
INSERT_BATCH_EVENTS = 200_000
# what the port logs when a native path falls back: the native
# package's wrappers (`predictionio_torch/native/__init__.py`: a failed
# build or load, a scan, bucketizer, property fold, import or export that
# bailed), a folded payload the storage could not decode
# (`storage/sqlite.py`), and an import that handed lines to Python
# (`tools/transfer.py`); a process whose log holds one failed the native
# tier
NATIVE_FALLBACK = ("native: build failed", "native: cannot load",
                   "native scan: ", "native: row ids outside",
                   "native: fill/plan disagreement", "native aggprops: ",
                   "native import: rc=", "native export: rc=",
                   "aggregate pushdown: bad folded payload",
                   "import: native path stopped mid-file",
                   "outside the native fast path")
# the loggers of those lines
NATIVE_LOGGERS = ("predictionio_torch.native",
                  "predictionio_torch.storage.sqlite",
                  "predictionio_torch.tools.transfer")
TEMPLATE_EVAL_CLASS = ("predictionio_torch.templates.similarproduct."
                       "evaluation.SimilarProductEvaluation")
# phase 11: the store of phase 3's `2m` training ratings (app RUNTIME_APP,
# written by a child from the start of the run) and its writer's result
# file; the drill's epochs (rank 64); the chunk whose boundary kills the
# drill's child (the fault site fires after a chunk is computed and before
# its save: at `--checkpoint-every 1` the re-run resumes from step
# RUNTIME_KILL - 1); the split cap of (e), under which rows split at `2m`
RUNTIME_APP = "MyApp2m"
RATINGS_RESULT = "ratings.json"
RUNTIME_ITERATIONS = 10
RUNTIME_KILL = 4
RUNTIME_SPLIT_CAP = 1024
# 12: config 2's shape (BASELINE.md: LogReg 1 M × 128 → 10 classes, 200
# Adam iterations) for `logreg_train` and `naive_bayes_train`; the chunk
# of the checkpointed fit; the rows of the fit held against the CPU's
CONFIG2_N, CONFIG2_D, CONFIG2_C, CONFIG2_ITERS = 1_000_000, 128, 10, 200
CONFIG2_LR = 0.1
CONFIG2_CHUNK = 50
CONFIG2_CPU_N = 100_000
# the bars of the reference's tests/test_classify_grid.py
LOGREG_TOL = {"rtol": 2e-4, "atol": 1e-5}
NB_TOL = {"rtol": 1e-6, "atol": 1e-7}
# 12b: the grid of BASELINE.md's grid receipt, 8 cells at N 200 000, D 16,
# C 4, up to 200 Adam iterations: (stepSize, regParam, iterations) a cell
GRID_N, GRID_D, GRID_C = 200_000, 16, 4
GRID_CELLS = ((0.05, 0.0, 200), (0.1, 0.0, 150), (0.2, 0.0, 100),
              (0.4, 0.0, 50), (0.05, 0.01, 200), (0.1, 0.01, 175),
              (0.2, 0.01, 125), (0.4, 0.01, 75))
GRID_SMOOTHINGS = (0.01, 0.1, 0.5, 1.0, 2.0, 5.0, 10.0, 25.0)
# 12c-12e: the classification store (the shape of the reference's
# bench.py::bench_aggprops: $set / $unset / $delete 90 / 8 / 2 over
# 200 000 entities) and the leadscoring sessions, by scale: (property
# events, users, sessions); written by a child started with the run
CLASSIFY_SCALES = {"2m": (2_000_000, 200_000, 200_000),
                   "20k": (20_000, 2_000, 2_000)}
CLASSIFY_MIX = (90, 8, 2)
CLASSIFY_APP, LEAD_APP = "Attr2m", "Lead200k"
CLASSIFY_RESULT = "classify.json"
CLASSIFY_QUERIES = 100
LEAD_PAGES, LEAD_REFERRERS = 20, 10
LEAD_BROWSERS = ("Chrome", "Firefox", "Safari", "Edge")
# the leadscoring train killed after its 3rd chunk of 30 Adam steps
# (checkpoint_every_or(300 // 10)), before that chunk's save: it resumes
# from step 60
LEAD_KILL = 3
LEAD_CHUNK = 30
CLASSIFY_TEMPLATE_NAMES = ("classification", "leadscoring")
LEAD_EVAL_CLASS = ("predictionio_torch.templates.leadscoring.evaluation."
                   "LeadScoringEvaluation")
# 13a: the SGNS loop at the JAX package's benchmarks/w2v_roofline.py
# defaults (:38-41, :55): vocabulary V, dim K, batch B, negatives N, a
# table of W2V_PAIRS uniform pairs from a seeded numpy generator, and
# W2V_STEPS steps at the reference's default learning rate; chunks of
# W2V_CHUNK, a resume from step W2V_RESUME_AT; the steps timed by CUDA
# events; the card against the CPU on W2V_CPU_STEPS steps of the same
# draws, at the reference's loop bar; the scatters timed on
# W2V_SCATTER_BATCHES batches
W2V_V, W2V_K, W2V_B, W2V_N = 100_000, 128, 16_384, 5
W2V_PAIRS, W2V_STEPS, W2V_LR = 1_000_000, 500, 0.05
W2V_CHUNK, W2V_RESUME_AT, W2V_CPU_STEPS = 100, 300, 50
W2V_TIMED_STEPS, W2V_SCATTER_BATCHES = 100, 20
W2V_TOL = {"rtol": 1e-5, "atol": 1e-6}
# 13b-13c: the text store, by scale: (documents, shared words); each
# document one of TEXT_CATEGORIES categories and 8-24 tokens, a token
# with TEXT_OWN_SHARE one of its category's TEXT_OWN_WORDS words, else a
# shared word (both Zipf); written by a child started with the run
TEXT_SCALES = {"50k": (50_000, 20_000), "2k": (2_000, 2_000)}
TEXT_CATEGORIES, TEXT_OWN_WORDS, TEXT_OWN_SHARE = 8, 100, 0.3
TEXT_APP = "Text50k"
TEXT_RESULT = "text.json"
TEXT_QUERIES = 100
# the template's variants beside its shipped `nb` (numFeatures 1024): `lr`
# and `word2vec` (its head `iterations` Adam steps)
TEXT_LR_PARAMS = {"iterations": 200, "stepSize": 0.1, "numFeatures": 1024}
TEXT_W2V_PARAMS = {"dim": 128, "window": 2, "negatives": 5,
                   "batchSize": 16_384, "steps": 500, "iterations": 200,
                   "stepSize": 0.1}
# the drills: a word2vec train killed after its TEXT_KILL-th chunk of
# steps // 10 SGNS steps, and one killed after its head's TEXT_KILL-th
# chunk of iterations // 10 Adam steps, both before that chunk's save
TEXT_KILL = 2
# 13b's evaluation (`chip_smoke.TextEvaluation`): NB at these λ, k folds
TEXT_EVAL_LAMBDAS, TEXT_EVAL_K = (0.25, 1.0), 3
# 14a: the co-occurrence Gram at the template's dense bound (maxDenseItems
# 8 192) over BASKET_BASKETS seeded baskets of 1 + Poisson(BASKET_MEAN)
# Zipf-drawn items (the ~10-item mean order of the public Instacart Market
# Basket data), BASKET_BOTS of them "bot" baskets of BASKET_BOT_SIZES
# distinct items with repeats; the template's default rules
BASKET_ITEMS, BASKET_BASKETS, BASKET_MEAN = 8_192, 200_000, 9
BASKET_BOTS, BASKET_BOT_SIZES = 20, (600, 2_000)
BASKET_RULES = {"min_support": 0.001, "min_confidence": 0.05,
                "min_lift": 1.0, "top_k": 10, "score": "lift"}
BASKET_CAP, BASKET_CHUNK = 512, 1024  # mine_rules' max_basket_items, chunk
BASKET_GRAM_REPS = 3
# the card against the CPU, and the dense path against the host fallback,
# at these (items, baskets, bots)
BASKET_CPU_SHAPE = (1_024, 20_000, 2)
BASKET_FALLBACK_SHAPE = (300, 3_000, 0)
# 14b: the store, by scale: (buy events, users, items), written by a child
# started with the run; a user's baskets BASKET_SPACING s apart, a
# basket's purchases 60-300 s apart, the template's basketWindow 3 600 s
BASKET_SCALES = {"200k": (200_000, 20_000, 2_000), "2k": (2_000, 200, 100)}
BASKET_SPACING = 6 * 3_600
BASKET_APP = "Cart200k"
BASKET_RESULT = "basket.json"
BASKET_QUERIES = 100
# the card's published dense peaks (the on-chip guide's table)
PEAK_INT8_OPS, PEAK_BF16_FLOPS = 1_979e12, 989e12
# 15a: the template's published width (engine.json: embedDim 16, 1 block,
# 2 heads, maxSeqLen 32) over phase 14's 8 192-item catalog, and the eval
# grid's D 8 and 2 blocks; the seq-tier ladders (the default, and
# PIO_SERVING_SEQ_TIERS=5,12 with its top tier), the batch tiers, the
# kernels' bar against their plain versions, the timed launches
SESSION_V, SESSION_D, SESSION_HEADS, SESSION_L = 8_192, 16, 2, 32
SESSION_CONFIGS = ((16, 1), (8, 1), (16, 2))
SESSION_LADDERS = ((8, 16, 32), (5, 12, 32))
SESSION_BATCH_TIERS = (1, 2, 4, 8, 16, 32, 64)
SESSION_TOL = {"rtol": 1e-5, "atol": 1e-6}
# (B, L) at the template's width past the batch and warp tiers: a fold
# through one batch_predict (the readout's 32- and 64-row groups, 2 and 8
# warp histories a block), and L 64 (the block body in shared memory)
SESSION_WIDE = ((128, 32), (512, 32), (4_096, 32), (64, 64))
SESSION_REPS = 200
# 15b: the fit (8 192 users' windows, the template's epochs and step
# size), the queries after it and the batch sizes they go in, cycled
SESSION_FIT_USERS, SESSION_EPOCHS, SESSION_LR = 8_192, 30, 0.05
SESSION_QUERIES = 1_000
SESSION_MIXED_BATCHES = (1, 3, 64, 7, 16, 33, 2, 50, 5)
# 15c: the card against the CPU at (users, items, epochs)
SESSION_CPU_SHAPE = (512, 256, 4)
# 15d: the template's store and the evaluation's, by scale: (view events,
# users, items), written by a child started with the run; the queries
# over HTTP, the evaluation's folds
SESSION_SCALES = {"200k": (200_000, 20_000, 2_000), "2k": (2_000, 200, 100)}
SESSION_EVAL_SCALES = {"200k": (20_000, 2_000, 500), "2k": (1_000, 100, 50)}
SESSION_APP, SESSION_EVAL_APP = "Sess200k", "Sess2k"
SESSION_RESULT = "session.json"
SESSION_HTTP_QUERIES = 100
SESSION_EVAL_K = 3
# 15e: the rounds written into 15d's deployed store (each one never-seen
# user viewing SESSION_ONLINE_NEW_VIEWS items and SESSION_ONLINE_VIEWERS
# existing users viewing one, the first an item it viewed before; round
# SESSION_ONLINE_COLD_ROUND's last viewer a never-seen item), the seconds
# a round may take to become servable, the in-process backlog (existing,
# new users) and the folded users scored in one batch
SESSION_ONLINE_ROUNDS = 20
SESSION_ONLINE_NEW_VIEWS, SESSION_ONLINE_VIEWERS = 3, 4
SESSION_ONLINE_COLD_ROUND = 7
SESSION_ONLINE_TIMEOUT_S = 30.0
SESSION_BACKLOG = (1_000, 100)
SESSION_BATCH_CHECK = 64
# phase 16: quality parity at BASELINE.md's parity configuration (rank
# 64, 10 iterations, λ 0.05, α 40 for implicit), the bars (explicit RMSE
# at most the MLlib-faithful side's + PARITY_RMSE_SLACK and both below
# PARITY_RMSE_MAX; implicit MAP@10 at least PARITY_MAP_SHARE × its and
# both above PARITY_MAP_MIN), and the MLlib-faithful side's child: its
# result file and its BLAS threads
PARITY_SCALE, PARITY_RANK, PARITY_ITERS = "2m", 64, 10
PARITY_REG, PARITY_ALPHA, PARITY_SEED = 0.05, 40.0, 0
PARITY_MODES = ("explicit", "implicit")
PARITY_RMSE_SLACK, PARITY_RMSE_MAX = 0.01, 1.0
PARITY_MAP_SHARE, PARITY_MAP_MIN = 0.9, 0.01
PARITY_RESULT, PARITY_ARRAYS = "parity.json", "parity.npz"
PARITY_THREADS = {k: "2" for k in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS",
                                   "MKL_NUM_THREADS")}
# the port's session kernels (no TPU counterpart): the reference's
# function each takes over, and the port's source
SESSION_KERNELS = {
    "session_encode": "predictionio_tpu/templates/sessionrec/engine.py:179",
    "session_readout": "predictionio_tpu/templates/sessionrec/engine.py:222",
}
# session.cu's register-tiled kernels (six warp-body instantiations and the
# tiled readout), which phase 1 holds to no stack frame and no spills
SESSION_REG_KERNELS, SESSION_REG_COUNT = (
    ("encode_warp_kernel", "readout_tile_kernel"), 7)
# deploys the console in a child process and writes, when it exits, its
# launch counts to the file named by its first argument
_DEPLOY_CHILD = (
    "import json, sys\n"
    "from predictionio_torch.ops import session, spd_solve\n"
    "from predictionio_torch.tools import console\n"
    "rc = console.main(sys.argv[2:])\n"
    "with open(sys.argv[1], 'w') as f:\n"
    "    json.dump({'launches': spd_solve.launches,\n"
    "               'by_rank': spd_solve.launches_by_rank,\n"
    "               'session': {**session.launches,\n"
    "                           **session.launches_v1}}, f)\n"
    "sys.exit(rc)\n")
# serves the console's event server in a child process and writes, when
# it exits, whether it ever initialised CUDA to the file named by its
# first argument
_EVENTSERVER_CHILD = (
    "import json, sys, torch\n"
    "from predictionio_torch.tools import console\n"
    "rc = console.main(sys.argv[2:])\n"
    "with open(sys.argv[1], 'w') as f:\n"
    "    json.dump({'cuda_initialized': torch.cuda.is_initialized()}, f)\n"
    "sys.exit(rc)\n")
# `console train` (its arguments from the second on) in a child process,
# which prints its launch counts as _CONSOLE_CHILD does and saves the
# PreparedData the train ran on (the object the engine's sanity check is
# handed) to the .npz its first argument names
_TRAIN_CHILD = (
    "import json, sys\n"
    "import numpy as np\n"
    "from predictionio_torch.controller import engine\n"
    "from predictionio_torch.ops import als_grid, spd_solve\n"
    "from predictionio_torch.tools import console\n"
    "check = engine.run_sanity_check\n"
    "def keep(obj, stage):\n"
    "    if stage == 'prepared data':\n"
    "        values = next(getattr(obj, f) for f in\n"
    "                      ('counts', 'confidence', 'ratings')\n"
    "                      if hasattr(obj, f))\n"
    "        np.savez(sys.argv[1], user_idx=obj.user_idx,\n"
    "                 item_idx=obj.item_idx, values=values,\n"
    "                 n_users=len(obj.user_ids), n_items=len(obj.item_ids))\n"
    "    check(obj, stage)\n"
    "engine.run_sanity_check = keep\n"
    "rc = console.main(sys.argv[2:])\n"
    "print(json.dumps({'launches': spd_solve.launches,\n"
    "                  'by_rank': spd_solve.launches_by_rank,\n"
    "                  'grids': als_grid.grid_log}), flush=True)\n"
    "sys.exit(rc)\n")
# writes a store of phase 10 or 11 (`write_template_store`,
# `write_ratings_store`): its arguments are the checkout, the store's
# directory, the scale and the writer's name; its log goes to writer.log
# beside the store
_STORE_CHILD = (
    "import sys\n"
    "sys.path.insert(0, sys.argv[1])\n"
    "import chip_smoke\n"
    "getattr(chip_smoke, sys.argv[4])(sys.argv[2], sys.argv[3])\n")
# runs the console in a child process and prints, as its last line, its
# launch counts, its grid trains (als_grid.grid_log) and its SGNS steps
_CONSOLE_CHILD = (
    "import json, sys\n"
    "from predictionio_torch.ops import als_grid, session, spd_solve, text\n"
    "from predictionio_torch.tools import console\n"
    "rc = console.main(sys.argv[1:])\n"
    "print(json.dumps({'launches': spd_solve.launches,\n"
    "                  'by_rank': spd_solve.launches_by_rank,\n"
    "                  'grids': als_grid.grid_log,\n"
    "                  'sgns_steps': text.sampler_calls['sgns'],\n"
    "                  'session': {**session.launches,\n"
    "                              **session.launches_v1}}),\n"
    "      flush=True)\n"
    "sys.exit(rc)\n")


def _require_native_log(log: str, who: str) -> None:
    """Raise if `log` holds a line of NATIVE_FALLBACK."""
    fell = [line for line in log.splitlines()
            if any(mark in line for mark in NATIVE_FALLBACK)]
    if fell:
        raise AssertionError(f"{who} fell back from the native tier: "
                             f"{fell[:5]}")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound_ms(bytes_moved: float, flops: float) -> tuple[float, str]:
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def solve_operations(k: int, m: int) -> float:
    """FP32 operations of the least work that solves one SPD system
    [K | M], whatever the kernel's own elimination: a Cholesky
    factorisation (K³/3) and a forward and a back substitution for each
    right-hand side (2K² each together), as the library call does. Every
    system of phase 2 is SPD (the packed kernels' Aᵀ is A there)."""
    return k ** 3 / 3 + 2 * k * k * m


@contextlib.contextmanager
def gj_layout(layout: str):
    """PIO_GJ_LAYOUT set to `layout` inside the block ("auto": unset)."""
    old = os.environ.pop("PIO_GJ_LAYOUT", None)
    if layout != "auto":
        os.environ["PIO_GJ_LAYOUT"] = layout
    try:
        yield
    finally:
        os.environ.pop("PIO_GJ_LAYOUT", None)
        if old is not None:
            os.environ["PIO_GJ_LAYOUT"] = old


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# -- phase 1 -----------------------------------------------------------------

def sass_instructions(library) -> dict:
    """Per kernel (mangled name) of a built library: its SASS
    instructions, as `cuobjdump -sass` lists them ({} without
    cuobjdump)."""
    from predictionio_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    if not os.path.exists(tool):
        return {}
    out = subprocess.run([tool, "-sass", str(library)], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    counts: dict = {}
    current = None
    for line in out.splitlines():
        if "Function : " in line:
            current = line.split("Function : ")[1].strip()
            counts[current] = 0
        elif current is not None and re.search(r"/\*[0-9a-f]{4,}\*/", line):
            counts[current] += 1
    return counts


def blocks_per_sm(threads: int, registers: int) -> int:
    """Resident blocks an H100 SM holds by registers alone: 65 536 a SM,
    allocated 8 a thread at a time (shared memory does not bind here)."""
    return min(32, 65_536 // (threads * -(-registers // 8) * 8))


def phase_build(report: dict, card: str, device) -> None:
    from predictionio_torch.ops import _build, spd_solve

    names = _build.sources()
    t0 = time.perf_counter()
    _build.build(names)
    wall = time.perf_counter() - t0
    for name in names:
        seconds, ptxas = _build.build_log[name]
        print(ptxas.strip())
        emit({"phase": "build", "source": f"csrc/{name}.cu",
              "nvcc_s": seconds, "card": card})
    # the register kernels keep their working copy in registers: no stack
    # frame (a register array indexed at run time) and no spills
    report["build"] = {"sources": names, "wall_s": wall}
    for source, (symbols, count) in REG_SOURCES.items():
        reg = {fn: props for fn, props in
               _build.ptxas_kernels(_build.build_log[source][1]).items()
               if any(symbol in fn for symbol in symbols)}
        sass = sass_instructions(_build._lib_path(source))
        for fn, props in reg.items():
            props["sass_instructions"] = sass.get(fn)
            split = re.search(r"gj_split_kernelILi(\d)E", fn)
            if split:
                # shared memory binds here too: the runtime's reckoning,
                # per rank
                name = SPLIT_KERNELS[int(split.group(1))]
                props["kernel"] = name
                props["by_rank"] = {}
                for k in SPLIT_REPORT_RANKS:
                    if name == "gj_blocked2_split" and k % 2:
                        continue
                    shared, blocks = spd_solve.split_occupancy(name, k,
                                                               device)
                    props["by_rank"][k] = {"dynamic_shared_bytes": shared,
                                           "blocks_per_sm": blocks}
                continue
            # a block is 128 threads, but for gj_cta_kernel<KP> and
            # gj_multi_cta_kernel<KP, C>: KP
            kp = re.search(r"ILi(\d+)E", fn)
            threads = (int(kp.group(1)) if "gj_cta_kernel" in fn
                       or "gj_multi_cta_kernel" in fn else 128)
            if "registers" in props:
                props["blocks_per_sm"] = blocks_per_sm(threads,
                                                       props["registers"])
        emit({"phase": "build", f"ptxas_{source}": reg})
        if len(reg) != count or any(
                props.get(key, 1) for props in reg.values()
                for key in ("stack", "spill_stores", "spill_loads")):
            raise AssertionError(f"{source}.cu: want {count} kernels with no "
                                 f"stack frame or spills, ptxas says {reg}")
        report["build"][f"ptxas_{source}"] = reg
    # the session kernels: the warp body keeps a lane's rows in registers
    # (every index a constant), the readout its 2 × 4 tile
    reg = {fn: props for fn, props in _build.ptxas_kernels(
        _build.build_log["session"][1]).items()
        if any(k in fn for k in SESSION_REG_KERNELS)}
    emit({"phase": "build", "ptxas_session": reg})
    report["build"]["ptxas_session"] = reg
    if len(reg) != SESSION_REG_COUNT or any(
            props.get(key, 1) for props in reg.values()
            for key in ("stack", "spill_stores", "spill_loads")):
        raise AssertionError(f"session.cu: want {SESSION_REG_COUNT} kernels "
                             f"with no stack frame or spills, ptxas says "
                             f"{reg}")


# -- phase 2 -----------------------------------------------------------------

def _spd(gen, r, k, m, device):
    import torch

    y = torch.randn(r, k, k, generator=gen, device=device)
    a = y @ y.transpose(1, 2) + 0.5 * k * torch.eye(k, device=device)
    b = torch.randn(r, k, m, generator=gen, device=device)
    a[1] = 0.0  # an all-zero padding system must solve to exactly 0
    b[1] = 0.0
    return a, b


def _rel(x, want) -> float:
    return ((x - want).abs().max() / want.abs().max()).item()


def _kernel_calls(name, a, b):
    """(kernel call, plain call) of `name` on a [R, K, K], b [R, K, M]."""
    from predictionio_torch.ops import spd_solve

    k, m = b.shape[1], b.shape[2]
    if name in ("gj_aug_multi_reg", "gj_aug_multi_cta"):
        if spd_solve.multi_kernel(k, m) != name:
            raise AssertionError(f"aug_multi at K = {k}, M = {m} does not "
                                 f"route to {name}")
        plain = (spd_solve.gj_solve_multi_reg_plain
                 if name == "gj_aug_multi_reg" else
                 spd_solve.gj_solve_cta_plain)
        return (lambda: spd_solve.gj_solve_multi(a, b),
                lambda: plain(a, b))
    if name == "gj_aug_multi":  # straight to it: no route reaches it
        return (lambda: spd_solve._launch(name, a, b),
                lambda: spd_solve.gj_solve_multi_plain(a, b))
    b1 = b[..., 0]

    def block_packed(a, b):
        return spd_solve.gj_solve_cta_plain(a, b, transpose=True)

    plain = {"gj_aug_reg": spd_solve.gj_solve_reg_plain,
             "gj_aug_cta": spd_solve.gj_solve_cta_plain,
             "gj_aug_split": spd_solve.gj_solve_cta_plain,
             "gj_aug": spd_solve.gj_solve_plain,
             "gj_packed_reg": spd_solve.gj_solve_packed_reg_plain,
             "gj_packed_cta": block_packed,
             "gj_packed_split": block_packed,
             "gj_packed": spd_solve.gj_solve_packed_plain,
             "gj_blocked2_reg": spd_solve.gj_solve_pair_plain,
             "gj_blocked2_cta": spd_solve.gj_solve_pair_plain,
             "gj_blocked2_split": spd_solve.gj_solve_pair_plain,
             "gj_blocked2": spd_solve.gj_solve_blocked2_plain}[name]
    layout = ("blocked2" if name.startswith("gj_blocked2") else
              "packed" if name.startswith("gj_packed") else "aug")
    routed = {"aug": spd_solve.aug_kernel, "packed": spd_solve.packed_kernel,
              "blocked2": spd_solve.blocked2_kernel}[layout](k)

    def kernel():
        if routed == name:  # through the layout, as a caller gets it
            return spd_solve.gj_solve(a, b1, layout=layout)
        return spd_solve._launch(name, a, b)[..., 0]

    if routed != name and name not in REPLACED.values():
        raise AssertionError(f"{layout} at K = {k} routes to {routed}, not "
                             f"{name}")
    return kernel, lambda: plain(a, b1)


def _check_kernel(name, r, k, m, gen, device, reps):
    import torch

    from predictionio_torch.ops import spd_solve

    a, b = _spd(gen, r, k, m, device)
    kernel, plain = _kernel_calls(name, a, b)
    before = spd_solve.launches[name]
    x = kernel()
    want = plain()
    torch.cuda.synchronize()
    if spd_solve.launches[name] != before + 1:
        raise AssertionError(f"{name} at {[r, k, m]}: the call launched "
                             f"another kernel ({spd_solve.launches})")
    err = (x - want).abs().max().item()
    rel = err / want.abs().max().item()
    rel_shared = rel  # against the shared-memory kernel's plain version
    if name in ("gj_aug_multi_reg", "gj_aug_multi_cta"):
        rel_shared = _rel(x, spd_solve.gj_solve_multi_plain(a, b))
    elif name in REGISTER_KERNELS:
        shared = (spd_solve.gj_solve_packed_plain
                  if name.startswith("gj_packed") else
                  spd_solve.gj_solve_blocked2_plain
                  if name.startswith("gj_blocked2")
                  else spd_solve.gj_solve_plain)
        rel_shared = _rel(x, shared(a, b[..., 0]))
    # a float64 solve (the packed kernels solve Aᵀx = b; the all-zero
    # system, whose b is 0, becomes I x = 0)
    a64 = a.double()
    a64[1] = torch.eye(k, dtype=torch.float64, device=device)
    if name.startswith("gj_packed"):
        a64 = a64.transpose(1, 2)
    exact = torch.linalg.solve(a64, b.double())
    rel_f64 = _rel(x.double(), exact.reshape(x.shape))
    zeros = bool((x[1] == 0).all().item())
    finite = bool(torch.isfinite(x).all().item())

    def library():
        chol, _ = torch.linalg.cholesky_ex(a)
        return torch.cholesky_solve(b, chol)

    row = {
        "name": name, "shape": [r, k, m],
        "shared_memory": (None if name in REGISTER_KERNELS else
                          spd_solve.shared_fits(k, m, device, name)),
        "max_abs_err": err, "max_rel_err": rel,
        "max_rel_err_vs_gj_solve_plain": rel_shared,
        "max_rel_err_vs_float64": rel_f64,
        "zero_system_exact": zeros,
        "kernel_ms": time_ms(kernel, reps),
        "plain_ms": time_ms(plain, max(1, reps // 10), warmup=1),
        "library_ms": time_ms(library, reps),
    }
    row["bound_ms"], row["bound_by"] = bound_ms(
        4.0 * (r * k * k + 2 * r * k * m), solve_operations(k, m) * r)
    same = True
    if name == "gj_aug_multi_reg":
        # the widest chunk a warp takes: X is bitwise the same under each
        row["chunk"] = spd_solve.MULTI_CHUNK
        row["kernel_ms_by_chunk"] = {}
        for chunk in (32, 64):
            def call(chunk=chunk):
                return spd_solve._launch(name, a, b, chunk=chunk)
            same = same and torch.equal(call(), x)
            row["kernel_ms_by_chunk"][chunk] = time_ms(call, reps)
        row["chunks_bitwise_equal"] = same
    elif name == "gj_aug_multi_cta":
        # one barrier a step: a buffer overwritten early would show here
        same = torch.equal(kernel(), x)
        row["repeat_bitwise_equal"] = same
    emit(dict(phase="kernels", **row))
    if not (rel < REL_BAR and rel_shared < REL_BAR and rel_f64 < REL_BAR
            and zeros and finite and same):
        raise AssertionError(f"{name} at {[r, k, m]} disagrees with its "
                             f"plain version: {row}")
    return row


def phase_kernels(report: dict, device) -> dict:
    import torch

    gen = torch.Generator(device=device).manual_seed(0)
    # the rank-64 user half-epoch, config 1's quickstart rank, and the
    # largest eval-grid solves of `console eval` at ranks 8 and 16 (943
    # users × 2 cells); every layout at each
    shapes = ((13_850, 64, 20), (943, 10, 50), (1_886, 8, 50),
              (1_886, 16, 50))
    rows = [_check_kernel("gj_aug_reg", r, k, 1, gen, device, reps)
            for r, k, reps in shapes]
    # KP = 32 at the same R: per-system cost against the KP = 64 body
    rows.append(_check_kernel("gj_aug_reg", 13_850, 32, 1, gen, device, 20))
    # the block kernel at the ranks 64 < K ≤ 128 it took over (80: one
    # `auto` sends it), and the shared-memory kernel beside it there and
    # at the rank-64 shape beside the warp kernel
    rows += [_check_kernel("gj_aug_cta", 13_850, k, 1, gen, device, 20)
             for k in (80, 96, 128)]
    rows += [_check_kernel("gj_aug", 13_850, k, 1, gen, device, reps)
             for k, reps in ((64, 20), (80, 20), (96, 10), (128, 5))]
    # the rank-128 base calls (K = 32, M = 97, 65, 33, 1) at the whole user
    # side and at the path's largest bucket; rank 96's (K = 24) and rank
    # 256's widest (four chunks); the shared-memory kernel beside them and
    # at a K it still takes (rank 98: 49 + 49, M = 50 and 1)
    for r, reps in ((13_850, 20), (2_744, 50)):
        rows += [_check_kernel("gj_aug_multi_reg", r, 32, m, gen, device,
                               reps) for m in (1, 33, 65, 97)]
    # a small bucket (15 of the path's 24 have R ≤ 560): one wave
    rows += [_check_kernel("gj_aug_multi_reg", r, k, m, gen, device, 50)
             for r, k, m in ((560, 32, 97), (2_744, 24, 73),
                             (2_744, 32, 225))]
    rows += [_check_kernel("gj_aug_multi", 13_850, 32, m, gen, device, 20)
             for m in (1, 33, 65, 97)]
    rows += [_check_kernel("gj_aug_multi", 2_744, 49, m, gen, device, 20)
             for m in (1, 50)]
    deep = [_check_kernel("gj_aug", 1_024, 255, 1, gen, device, 3)]
    # the forced layouts also at rank 128 (a forced layout bypasses Schur):
    # packed on its two register kernels, the block one beside the kernel
    # it replaced
    rows += [_check_kernel("gj_packed_reg", r, k, 1, gen, device, reps)
             for r, k, reps in shapes]
    rows.append(_check_kernel("gj_packed_cta", 13_850, 128, 1, gen, device,
                              20))
    rows.append(_check_kernel("gj_packed", 13_850, 128, 1, gen, device, 5))
    # the kernel the pair kernels replaced, at their shapes (more below)
    rows += [_check_kernel("gj_blocked2", r, k, 1, gen, device, reps)
             for r, k, reps in shapes + ((13_850, 128, 5),)]
    deep.append(_check_kernel("gj_packed", 1_024, 255, 1, gen, device, 3))
    if any(row["shared_memory"] for row in deep):
        raise AssertionError("K = 255 should take the device-memory variant")
    rows += deep
    # the split kernels at a rank-192 user half-epoch (the replaced
    # kernels' shared-memory variant, timed beside them) and at K = 255
    # (their device-memory variant, above)
    for name, old in (("gj_aug_split", "gj_aug"),
                      ("gj_packed_split", "gj_packed")):
        rows += [_check_kernel(name, r, k, 1, gen, device, reps)
                 for r, k, reps in ((13_850, 192, 10), (1_024, 255, 20))]
        rows.append(_check_kernel(old, 13_850, 192, 1, gen, device, 2))
        if not rows[-1]["shared_memory"]:
            raise AssertionError(f"{old} at K = 192 should take its "
                                 "shared-memory variant")
    # gj_blocked2 above K = 128: its shared-memory variant at K = 192, its
    # device-memory variant at K = 256 (a [K][K + 1] copy of 263 KB)
    for r, k, shared in ((13_850, 192, True), (1_024, 256, False)):
        rows.append(_check_kernel("gj_blocked2", r, k, 1, gen, device, 2))
        if rows[-1]["shared_memory"] != shared:
            raise AssertionError(f"gj_blocked2 at K = {k}: shared memory "
                                 f"{rows[-1]['shared_memory']}, want {shared}")
    rows += [_check_kernel("gj_blocked2", 13_850, k, 1, gen, device, 10)
             for k in (80, 96)]
    # the blocked2 layout's pair kernels, after every other row so that
    # the other rows' inputs do not move: the warp kernel at the rank-64
    # and eval shapes, the block kernel at 64 < K ≤ 128, the split one at
    # a rank-192 user half-epoch and at K = 256
    rows += [_check_kernel("gj_blocked2_reg", r, k, 1, gen, device, reps)
             for r, k, reps in shapes]
    rows += [_check_kernel("gj_blocked2_cta", 13_850, k, 1, gen, device, 20)
             for k in (80, 96, 128)]
    rows += [_check_kernel("gj_blocked2_split", r, k, 1, gen, device, reps)
             for r, k, reps in ((13_850, 192, 10), (1_024, 256, 20))]
    # the multi-RHS block kernel at the widest base calls of ranks 196
    # (whole user side), 150, 252 and 250 (the path's largest bucket) and
    # at a small bucket, each beside the kernel it replaced; after every
    # other row, as above
    for r, k, m in ((13_850, 49, 50), (13_850, 75, 76), (2_744, 63, 190),
                    (2_744, 125, 126), (560, 125, 126)):
        rows.append(_check_kernel("gj_aug_multi_cta", r, k, m, gen, device,
                                  20))
        rows.append(_check_kernel("gj_aug_multi", r, k, m, gen, device, 5))
    # the fold's shapes (phase 6), after every other row as above: the
    # rank-64 fold runs gj_aug_reg at its row tiers 8 and 128, the
    # rank-128 fold's largest Schur base call is [128, 32, 97]
    rows += [_check_kernel("gj_aug_reg", r, 64, 1, gen, device, 50)
             for r in (8, 128)]
    rows.append(_check_kernel("gj_aug_multi_reg", 128, 32, 97, gen, device,
                              50))
    # each new kernel's time over the one it replaced, at the same shape
    for row in rows:
        old = REPLACED.get(row["name"])
        ref = next((o for o in rows if o["name"] == old
                    and o["shape"] == row["shape"]), None)
        if ref is not None:
            row["replaced_ms"] = ref["kernel_ms"]
            emit({"phase": "kernels", "name": row["name"],
                  "shape": row["shape"], "replaced": old,
                  "kernel_ms": row["kernel_ms"],
                  "replaced_ms": ref["kernel_ms"],
                  "library_ms": row["library_ms"]})
    report["kernels"] = rows
    # each kernel's main-path shape: the rank-64 user half-epoch, for
    # gj_aug_cta a rank auto sends it (80), for gj_packed_cta rank 128,
    # for the split kernels the rank-192 user half-epoch, for gj_aug and
    # gj_packed K = 255 (their device-memory variant), for the
    # multi-RHS register kernel the largest base call of the rank-128
    # recursion (its largest bucket, widest M), for the multi-RHS block
    # kernel and the kernel it replaced rank 250's
    main_shape = {"gj_aug_reg": [13_850, 64, 1],
                  "gj_aug_cta": [13_850, 80, 1],
                  "gj_aug_split": [13_850, 192, 1],
                  "gj_aug": [1_024, 255, 1],
                  "gj_aug_multi_reg": [2_744, 32, 97],
                  "gj_aug_multi_cta": [2_744, 125, 126],
                  "gj_aug_multi": [2_744, 125, 126],
                  "gj_packed_reg": [13_850, 64, 1],
                  "gj_packed_cta": [13_850, 128, 1],
                  "gj_packed_split": [13_850, 192, 1],
                  "gj_packed": [1_024, 255, 1],
                  "gj_blocked2_reg": [13_850, 64, 1],
                  "gj_blocked2_cta": [13_850, 128, 1],
                  "gj_blocked2_split": [13_850, 192, 1],
                  "gj_blocked2": [1_024, 256, 1]}
    return {name: next(row for row in rows if row["name"] == name
                       and row["shape"] == shape)
            for name, shape in main_shape.items()}


# -- phase 3 -----------------------------------------------------------------

def _train(data, rank, solver, device):
    from predictionio_torch.ops.als import ALSConfig, als_train

    cfg = ALSConfig(rank=rank, iterations=ITERATIONS, reg=0.01, seed=0,
                    solver=solver)
    t0 = time.perf_counter()
    res = als_train(data.train_u, data.train_i, data.train_r, data.n_users,
                    data.n_items, cfg, device=device, compute_rmse=True)
    wall = time.perf_counter() - t0
    if not res.rmse_history or not all(
            x == x and x < 10 for x in res.rmse_history):
        raise AssertionError(f"rank {rank} {solver}: bad RMSE "
                             f"{res.rmse_history}")
    return res, wall


def bucketize_ab(report: dict, data) -> dict:
    """Phase 3's host set-up, its bucketizer alone: `als_train`'s two
    `bucket_ragged_split` calls on `data` (users, then items; the default
    ALSConfig's split cap and ladder) on the native tier, then under
    PIO_NATIVE=0 (numpy), twice each in turn; the seconds of each and
    whether the buckets are bitwise equal."""
    import numpy as np

    from predictionio_torch.ops.als import ALSConfig, bucket_ragged_split

    cfg = ALSConfig()

    def both():
        t0 = time.perf_counter()
        out = [bucket_ragged_split(rows, cols, data.train_r, n, 8,
                                   cfg.split_cap, cap_growth=cfg.cap_growth)
               for rows, cols, n in (
                   (data.train_u, data.train_i, data.n_users),
                   (data.train_i, data.train_u, data.n_items))]
        return out, time.perf_counter() - t0

    seconds = {"native": [], "numpy": []}
    got = {}
    try:
        for tier in ("native", "numpy", "numpy", "native"):
            if tier == "numpy":
                os.environ["PIO_NATIVE"] = "0"
            got[tier], took = both()
            seconds[tier].append(took)
            os.environ.pop("PIO_NATIVE", None)
    finally:
        os.environ.pop("PIO_NATIVE", None)
    equal = all(
        np.array_equal(sa, sb) and len(ba) == len(bb) and all(
            np.array_equal(getattr(x, f), getattr(y, f))
            and getattr(x, f).dtype == getattr(y, f).dtype
            for x, y in zip(ba, bb) for f in ("rows", "cols", "vals", "mask"))
        for (ba, sa), (bb, sb) in zip(got["native"], got["numpy"]))
    row = {"ratings": int(len(data.train_r)), "native_s": seconds["native"],
           "numpy_s": seconds["numpy"], "bitwise_equal": equal}
    emit(dict(phase="bucketize", **row))
    report["bucketize"] = row
    if not equal:
        raise AssertionError(f"the native buckets differ from numpy's: "
                             f"{row}")
    return row


def phase_train_reference(report: dict, data, device) -> dict:
    """The solver='chol' runs the kernels' trajectories are held to (no
    kernel launches), and profiles of the rank-64, 80 and 128 trains."""
    from predictionio_torch.ops import spd_solve
    from predictionio_torch.tools.profile_train import profile_train

    out = {}
    for rank in (64, 80, 128, 192, 250, 255, 256):
        before = dict(spd_solve.launches)
        res, wall = _train(data, rank, "chol", device)
        if spd_solve.launches != before:
            raise AssertionError("solver='chol' launched a GJ kernel")
        out[rank] = res
        emit({"phase": "train", "rank": rank, "solver": "chol",
              "rmse": res.rmse_history, "epoch_s": res.epoch_times,
              "wall_s": wall})
    # each train's solves run on its register kernel alone
    for rank, kernel in ((64, "gj_reg_kernel"), (80, "gj_cta_kernel"),
                         (128, "gj_multi_reg_kernel")):
        prof = profile_train(data, device, rank, ITERATIONS)
        report[f"profile_rank{rank}"] = prof
        emit({"phase": "profile",
              **{k: v for k, v in prof.items() if k != "top"},
              "top": prof["top"][:8]})
        names = [r["name"] for r in prof["solve"]]
        if (not any(kernel in n for n in names)
                or any("gj_kernel<" in n for n in names)):
            raise AssertionError(f"rank-{rank} profile: solve kernels "
                                 f"{names}")
    return out


def phase_train(report: dict, data, device, chol: dict) -> tuple:
    """solver='gj' at rank 64, 80, 128, 250 and 255 under the auto layout,
    at rank 64 under each forced layout, at rank 128 and 256 under the
    packed and the blocked2 one and at rank 192 under the aug one; every
    run's RMSE trajectory against the chol run's of its rank, and its
    kernels launched alone. Returns the runs' rows and the rank-64 and
    rank-128 auto trains' results, which phase 6 folds into."""
    from predictionio_torch.ops import spd_solve

    runs = {}
    trained = {}
    for rank, layout, kernels in (
            (64, "auto", ("gj_aug_reg",)), (80, "auto", ("gj_aug_cta",)),
            (128, "auto", ("gj_aug_multi_reg",)),
            (250, "auto", ("gj_aug_multi_cta", "gj_aug_cta")),
            (255, "auto", ("gj_aug_split",)),
            (64, "packed", ("gj_packed_reg",)),
            (128, "packed", ("gj_packed_cta",)),
            (192, "aug", ("gj_aug_split",)),
            (256, "packed", ("gj_packed_split",)),
            (64, "blocked2", ("gj_blocked2_reg",)),
            (128, "blocked2", ("gj_blocked2_cta",)),
            (256, "blocked2", ("gj_blocked2_split",))):
        before = dict(spd_solve.launches)
        with gj_layout(layout):
            res, wall = _train(data, rank, "gj", device)
        launched = {k: spd_solve.launches[k] - before[k] for k in before}
        ref = chol[rank].rmse_history
        factor_diff = float(abs(res.item_factors
                                - chol[rank].item_factors).max())
        ok = all(abs(x - y) <= RMSE_RTOL * abs(y)
                 for x, y in zip(res.rmse_history, ref))
        row = {"rank": rank, "solver": "gj", "layout": layout,
               "rmse": res.rmse_history, "rmse_chol": ref,
               "item_factor_max_abs_diff": factor_diff,
               "epoch_s": res.epoch_times,
               "wall_s": wall, "setup_s": wall - sum(res.epoch_times),
               "launches": launched,
               "launches_per_epoch": {k: v / ITERATIONS
                                      for k, v in launched.items()}}
        emit(dict(phase="train", **row))
        if not ok or len(res.rmse_history) != len(ref):
            raise AssertionError(f"rank {rank} {layout}: gj trajectory "
                                 f"{res.rmse_history} vs chol {ref}")
        others = {k: v for k, v in launched.items()
                  if k not in kernels and v}
        if any(launched[k] <= 0 for k in kernels) or others:
            raise AssertionError(f"rank {rank} {layout}: want {kernels} "
                                 f"alone, launched {launched}")
        runs[(rank, layout)] = row
        if layout == "auto" and rank in FOLD_RANKS:
            trained[rank] = res
    report["train"] = {f"{rank}-{layout}": row
                       for (rank, layout), row in runs.items()}
    return runs, trained


# -- phase 4 -----------------------------------------------------------------

def _write_events(path, data) -> None:
    t0 = datetime(2026, 1, 1, tzinfo=timezone.utc)
    with open(path, "w") as f:
        for n, (u, i, r) in enumerate(zip(data.train_u, data.train_i,
                                          data.train_r)):
            when = (t0 + timedelta(seconds=n)).isoformat()
            f.write(json.dumps({
                "event": "rate", "entityType": "user", "entityId": f"u{u}",
                "targetEntityType": "item", "targetEntityId": f"i{i}",
                "properties": {"rating": float(r)},
                "eventTime": when.replace("+00:00", "Z"),
            }) + "\n")


def _read_deployed_line(proc, timeout_s: float,
                        marker: str = " deployed on ") -> str:
    """The server's "deployed on ip:port" line (or the first line holding
    `marker`); its output keeps being drained so the pipe never fills."""
    lines: "queue.Queue[str]" = queue.Queue()
    tail: list = []

    def pump():
        for line in proc.stdout:
            tail.append(line)
            del tail[:-40]
            lines.put(line)
        lines.put("")

    threading.Thread(target=pump, daemon=True).start()
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        try:
            line = lines.get(timeout=1.0)
        except queue.Empty:
            continue
        if marker in line:
            return line
        if line == "":
            break
    raise AssertionError(f"deploy did not come up (exit {proc.poll()}):\n"
                         + "".join(tail))


def _post(url: str, query: dict) -> dict:
    req = urllib.request.Request(
        url + "/queries.json", data=json.dumps(query).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())


def phase_serve(report: dict, device, tmp: str) -> dict:
    """The train → deploy → query path, from an events file and a model
    file, then through the store (`_serve_from_store`); returns the paths
    phase 5 reuses (events file, engine.json, model file)."""
    import numpy as np

    from predictionio_torch.ops import ranking
    from predictionio_torch.quality.datasets import synth_explicit
    from predictionio_torch.templates.recommendation.engine import ALSAlgorithm
    from predictionio_torch.tools import console
    from predictionio_torch.workflow.core_workflow import read_model_file

    data = synth_explicit("100k")
    events = os.path.join(tmp, "events.jsonl")
    _write_events(events, data)
    with open(os.path.join(HERE, "predictionio_torch", "templates",
                           "recommendation", "engine.json")) as f:
        variant = json.load(f)
    # the ALS algorithm alone at rank 64, so each answer is the model's
    # recommend_products
    als_block = dict(variant["algorithms"][0])
    als_block["params"] = dict(als_block["params"], rank=64)
    variant["algorithms"] = [als_block]
    variant["serving"] = {"name": "first"}
    engine_json = os.path.join(tmp, "engine.json")
    with open(engine_json, "w") as f:
        json.dump(variant, f)
    model_path = os.path.join(tmp, "model.pio")

    t0 = time.perf_counter()
    rc = console.main(["train", "--engine-json", engine_json, "--events",
                       events, "--model-out", model_path,
                       "--device", str(device)])
    train_s = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"console train exited {rc}")
    _instance, (model,) = read_model_file(model_path)
    model.device = str(device)

    seen: dict = {}
    for u, i in zip(data.train_u, data.train_i):
        seen.setdefault(f"u{u}", set()).add(f"i{i}")
    env = dict(os.environ, PYTHONPATH=HERE)
    proc = subprocess.Popen(
        [sys.executable, "-m", "predictionio_torch.tools.console", "deploy",
         "--engine-json", engine_json, "--model", model_path, "--ip",
         "127.0.0.1", "--port", "0", "--device", str(device)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=HERE, env=env)
    try:
        line = _read_deployed_line(proc, 300.0)
        url = f"http://127.0.0.1:{int(line.rsplit(':', 1)[1])}"
        queries = [{"user": f"u{u}", "num": n}
                   for u in (0, 1, 7, 42, 500, 942) for n in (5, 20)]
        queries.append({"user": "nobody", "num": 5})
        t_q = time.perf_counter()
        for q in queries:
            got = _post(url, q)
            want = {"itemScores": [
                {"item": i, "score": s}
                for i, s in model.recommend_products(q["user"], q["num"])]}
            if got != want:
                raise AssertionError(f"served {got} != in-process {want}")
            items = {s["item"] for s in got["itemScores"]}
            if items & seen.get(q["user"], set()):
                raise AssertionError(f"seen items served for {q}")
        query_ms = (time.perf_counter() - t_q) / len(queries) * 1e3
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()

    # one 1,024-user batch_predict through the device branch
    algo = ALSAlgorithm(None)
    users = [f"u{u % data.n_users}" for u in range(1_024)]
    bulk_q = [{"user": u, "num": 10} for u in users]
    t_b = time.perf_counter()
    bulk = algo.batch_predict(model, bulk_q)
    batch_ms = (time.perf_counter() - t_b) * 1e3
    ids = np.asarray([model.user_ids[u] for u in users], dtype=np.int32)
    exclude = {int(r): model.seen.get(int(r), np.empty(0, np.int32))
               for r in set(ids.tolist())}
    host_s, host_i = ranking.topk_host(model.user_factors,
                                       model.item_factors, ids, 10, exclude)
    inv = model.item_ids.inverse()
    compared = 0
    for row, got in enumerate(bulk):
        s = host_s[row]
        gaps = np.abs(np.diff(s))
        tied = np.zeros(len(s), bool)
        tied[:-1] |= gaps < 1e-5
        tied[1:] |= gaps < 1e-5
        got_items = [e["item"] for e in got["itemScores"]]
        for pos in np.nonzero(~tied)[0]:
            if got_items[pos] != inv[int(host_i[row][pos])]:
                raise AssertionError(f"device top-k differs from host for "
                                     f"{users[row]} at {pos}")
            compared += 1
    row = {"events": int(len(data.train_u)), "train_s": train_s,
           "queries": len(queries), "query_ms_mean": query_ms,
           "batch_users": len(users), "batch_predict_ms": batch_ms,
           "topk_positions_compared": compared}
    row.update(_serve_from_store(device, tmp, events, engine_json, model,
                                 queries))
    emit(dict(phase="serve", **row))
    report["serve"] = row
    return {"events": events, "engine_json": engine_json,
            "model": model_path, "n_users": data.n_users,
            "store_base": os.path.join(tmp, STORE_BASE),
            "users": sorted({f"u{u}" for u in data.train_u}),
            "items": sorted({f"i{i}" for i in data.train_i})}


def _serve_from_store(device, tmp: str, events: str, engine_json: str,
                      model, queries: list) -> dict:
    """`console app new` → `console import` of the events file into a
    pio.db under a fresh PIO_FS_BASEDIR → `console train` from the store
    → `console deploy` of the latest completed instance; its answers
    against the events-file model's: top-k ids identical wherever the
    scores are not tied."""
    import numpy as np

    from predictionio_torch.storage.registry import Storage
    from predictionio_torch.tools import console
    from predictionio_torch.workflow.workflow_utils import read_engine_json

    base = os.path.join(tmp, STORE_BASE)
    old = os.environ.get("PIO_FS_BASEDIR")
    os.environ["PIO_FS_BASEDIR"] = base
    try:
        t0 = time.perf_counter()
        for argv in (["app", "new", "MyApp1"],
                     ["import", "--appname", "MyApp1", "--input", events]):
            if console.main(argv) != 0:
                raise AssertionError(f"console {argv[0]} exited non-zero")
        import_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        if console.main(["train", "--engine-json", engine_json,
                         "--device", str(device)]) != 0:
            raise AssertionError("console train from the store failed")
        train_s = time.perf_counter() - t0
        variant = read_engine_json(engine_json)
        storage = Storage.get()
        try:
            instance = storage.meta_engine_instances().get_latest_completed(
                variant.id, "1", variant.variant)
            blob = (None if instance is None else
                    storage.model_data_models().get(instance.id))
        finally:
            storage.close()
            Storage.reset(None)
        if instance is None or blob is None:
            raise AssertionError("the store holds no completed instance "
                                 "with its model blob")
    finally:
        os.environ.pop("PIO_FS_BASEDIR")
        if old is not None:
            os.environ["PIO_FS_BASEDIR"] = old
    env = dict(os.environ, PYTHONPATH=HERE, PIO_FS_BASEDIR=base)
    proc = subprocess.Popen(
        [sys.executable, "-m", "predictionio_torch.tools.console", "deploy",
         "--engine-json", engine_json, "--ip", "127.0.0.1", "--port", "0",
         "--device", str(device)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=HERE, env=env)
    compared = 0
    try:
        line = _read_deployed_line(proc, 300.0)
        if instance.id not in line:
            raise AssertionError(f"deployed {line!r}, not {instance.id}")
        url = f"http://127.0.0.1:{int(line.rsplit(':', 1)[1])}"
        for q in queries:
            got = [s["item"] for s in _post(url, q)["itemScores"]]
            want = model.recommend_products(q["user"], q["num"])
            if len(got) != len(want):
                raise AssertionError(f"store deploy answered {got} for {q}, "
                                     f"the events-file model {want}")
            scores = np.asarray([sc for _, sc in want])
            gaps = np.abs(np.diff(scores)) < 1e-5
            tied = np.zeros(len(want), bool)
            tied[:-1] |= gaps
            tied[1:] |= gaps
            for pos in np.nonzero(~tied)[0]:
                if got[pos] != want[pos][0]:
                    raise AssertionError(f"store deploy differs from the "
                                         f"events-file model for {q} at "
                                         f"{pos}: {got} vs {want}")
                compared += 1
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    return {"store_import_s": import_s, "store_train_s": train_s,
            "store_instance": instance.id,
            "store_topk_positions_compared": compared}


# -- phase 5 -----------------------------------------------------------------

def _grid_cfgs(solver):
    from predictionio_torch.ops.als import ALSConfig

    return [ALSConfig(rank=64, iterations=ITERATIONS, reg=lam, seed=0,
                      solver=solver) for lam in (0.01, 0.1)]


def sequential_trains(data, device) -> list:
    """One `als_train` per cell of the phase-5a grid: what its auto grid's
    cells must equal. Run before the eval path's counts are zeroed, as they
    are no part of that path."""
    from predictionio_torch.ops.als import als_train

    return [als_train(data.train_u, data.train_i, data.train_r,
                      data.n_users, data.n_items, cfg, device=device)
            for cfg in _grid_cfgs("gj")]


def phase_grid(report: dict, data, device, sequential: list) -> dict:
    """The grid at the north-star width: chol, then gj under each layout,
    each against the chol grid; the auto grid against `sequential`."""
    import numpy as np

    from predictionio_torch.ops import spd_solve
    from predictionio_torch.ops.als_grid import als_train_grid

    grids = {}
    rows = []
    for name, solver, layout in (("chol", "chol", "auto"),
                                 ("auto", "gj", "auto"),
                                 ("packed", "gj", "packed"),
                                 ("blocked2", "gj", "blocked2")):
        before = dict(spd_solve.launches)
        t0 = time.perf_counter()
        with gj_layout(layout):
            res = als_train_grid(data.train_u, data.train_i, data.train_r,
                                 data.n_users, data.n_items,
                                 _grid_cfgs(solver),
                                 device=device, compute_rmse=True)
        wall = time.perf_counter() - t0
        launched = {k: spd_solve.launches[k] - before[k] for k in before}
        row = {"grid": name, "rank": 64, "reg": [0.01, 0.1],
               "rmse": [r.rmse_history for r in res],
               "step_s": res[0].epoch_times, "wall_s": wall,
               "setup_s": wall - sum(res[0].epoch_times),
               "launches": launched}
        emit(dict(phase="eval_grid", **row))
        rows.append(row)
        if name == "chol":
            if any(launched.values()):
                raise AssertionError("the chol grid launched a GJ kernel")
        else:
            kernel = LAYOUT_KERNEL[layout]
            if launched[kernel] <= 0:
                raise AssertionError(f"{name} grid: {kernel} never launched")
            for cell, ref in zip(res, grids["chol"]):
                if len(cell.rmse_history) != ITERATIONS or not all(
                        abs(x - y) <= RMSE_RTOL * abs(y) for x, y in
                        zip(cell.rmse_history, ref.rmse_history)):
                    raise AssertionError(
                        f"{name} grid RMSE {cell.rmse_history} vs chol "
                        f"{ref.rmse_history}")
        grids[name] = res
    seq_rel = []
    for cell, seq in zip(grids["auto"], sequential):
        for got, want in ((cell.user_factors, seq.user_factors),
                          (cell.item_factors, seq.item_factors)):
            seq_rel.append(float(np.abs(got - want).max()
                                 / np.abs(want).max()))
    emit({"phase": "eval_grid", "grid_vs_sequential_factor_rel": seq_rel})
    if max(seq_rel) >= REL_BAR:
        raise AssertionError(f"grid cells differ from sequential trains: "
                             f"{seq_rel}")
    report["eval_grid"] = {"grids": rows, "vs_sequential_rel": seq_rel}
    return {row["grid"]: row for row in rows}


def _console_child(args: list, layout: str = "auto", timeout_s=900.0,
                   env_extra: dict = None, prepared: str = None):
    """Run the port's console in a child process with PIO_GJ_LAYOUT set to
    `layout` (and `env_extra`); with `prepared`, a `train` through
    _TRAIN_CHILD that saves its PreparedData there. Returns (stderr,
    {"launches", "by_rank", "grids"}, seconds)."""
    env = dict(os.environ, PYTHONPATH=HERE, **(env_extra or {}))
    env.pop("PIO_GJ_LAYOUT", None)
    if layout != "auto":
        env["PIO_GJ_LAYOUT"] = layout
    t0 = time.perf_counter()
    code = [_CONSOLE_CHILD] if prepared is None else [_TRAIN_CHILD, prepared]
    proc = subprocess.run([sys.executable, "-c", *code, *args],
                          capture_output=True, text=True, cwd=HERE, env=env,
                          timeout=timeout_s)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"console {args[0]} ({layout}) exited "
                             f"{proc.returncode}:\n{proc.stderr[-4000:]}")
    _require_native_log(proc.stderr, f"console {args[0]} ({layout})")
    record = json.loads(proc.stdout.strip().splitlines()[-1])
    return proc.stderr, record, seconds


def phase_eval(report: dict, device, tmp: str, served: dict) -> dict:
    """`console eval` under each layout: the grid path, the layout's
    kernel, and the same ranking of the grid's cells as the auto run."""
    runs = {}
    for layout in ("auto", "packed", "blocked2"):
        out = os.path.join(tmp, f"eval-{layout}.json")
        stderr, child, seconds = _console_child(
            ["eval", EVAL_CLASS, "--events", served["events"], "--out", out,
             "--device", str(device)], layout)
        with open(out) as f:
            record = json.load(f)
        result = json.loads(record["evaluator_results_json"])
        maps = [r["scores"]["MAP@10"] for r in result["results"]]
        best = [r["engineParams"] for r in result["results"]].index(
            result["bestEngineParams"])
        grids = child["grids"]
        launches = child["launches"]
        row = {"layout": layout, "wall_s": seconds,
               "status": record["status"], "map_at_10": maps, "best": best,
               "grid_trains": len(grids),
               "grid_setup_s": sum(g["setup_s"] for g in grids),
               "grid_steps_s": sum(g["steps_s"] for g in grids),
               "launches": launches, "launches_by_rank": child["by_rank"]}
        emit(dict(phase="eval", **row))
        # the child's log (timestamped stages) goes to the report only
        report.setdefault("eval_log", {})[layout] = stderr.splitlines()
        if (record["status"] != "EVALCOMPLETED" or len(grids) != 6
                or any(g["cells"] != 2 for g in grids)):
            raise AssertionError(f"console eval ({layout}) did not take "
                                 f"the grid path (3 folds × 2 rank groups): "
                                 f"{row}")
        kernel = LAYOUT_KERNEL[layout]
        ranks = [f"{kernel}/K={k}" for k in (8, 16)]
        if (any(child["by_rank"].get(key, 0) <= 0 for key in ranks)
                or any(launches[name] for name in OFF_PATH)):
            raise AssertionError(f"console eval ({layout}): want {ranks} "
                                 f"and none of {OFF_PATH}, got "
                                 f"{child['by_rank']}")
        runs[layout] = row
    auto = runs["auto"]
    for layout in ("packed", "blocked2"):
        row = runs[layout]
        if row["best"] != auto["best"] or not all(
                abs(x - y) <= MAP_RTOL * abs(y) + MAP_ATOL
                for x, y in zip(row["map_at_10"], auto["map_at_10"])):
            raise AssertionError(f"console eval ({layout}) ranks the grid "
                                 f"differently from auto: {row} vs {auto}")
    report["eval"] = runs
    return runs


def phase_batchpredict(report: dict, device, tmp: str, served: dict) -> dict:
    """`console batchpredict` of 1,024 queries on phase 4's model against
    the in-process batch_predict of the same model."""
    from predictionio_torch.templates.recommendation.engine import ALSAlgorithm
    from predictionio_torch.workflow.core_workflow import read_model_file

    queries = [{"user": f"u{u % served['n_users']}", "num": 10}
               for u in range(1_024)]
    q_path = os.path.join(tmp, "queries.jsonl")
    o_path = os.path.join(tmp, "predictions.jsonl")
    with open(q_path, "w") as f:
        f.writelines(json.dumps(q) + "\n" for q in queries)
    _, child, seconds = _console_child(
        ["batchpredict", "--engine-json", served["engine_json"], "--model",
         served["model"], "--input", q_path, "--output", o_path,
         "--device", str(device)])
    with open(o_path) as f:
        got = [json.loads(line) for line in f]
    _instance, (model,) = read_model_file(served["model"])
    model.device = str(device)
    want = ALSAlgorithm(None).batch_predict(model, queries)
    if [g["query"] for g in got] != queries:
        raise AssertionError("batchpredict lost or reordered queries")
    for g, w in zip(got, want):
        if g["prediction"] != w:
            raise AssertionError(f"batchpredict {g} != in-process {w}")
    row = {"queries": len(queries), "wall_s": seconds,
           "launches": child["launches"]}
    emit(dict(phase="batchpredict", **row))
    report["batchpredict"] = row
    return row


# -- phase 6 -----------------------------------------------------------------

def _fold_events(data, seed: int = 6):
    """The new rating events phase 6 folds: FOLD_RERATERS existing users
    rating 1-5 items each (items they rated before among them), then
    FOLD_NEW_USERS never-seen users rating 5-40 items each, and
    FOLD_NEW_ITEMS never-seen items rated by some of both; one event a
    second from FOLD_T0."""
    import numpy as np

    rng = np.random.default_rng(seed)
    rerate = rng.choice(data.n_users, FOLD_RERATERS, replace=False)
    new_items = [f"newi{j}" for j in range(FOLD_NEW_ITEMS)]
    rows = []
    for u in rerate:
        for i in rng.choice(data.n_items, rng.integers(1, 6),
                            replace=False):
            rows.append((f"u{u}", f"i{i}"))
    for j in range(FOLD_NEW_USERS):
        for i in rng.choice(data.n_items, rng.integers(5, 41),
                            replace=False):
            rows.append((f"newu{j}", f"i{i}"))
    raters = [f"u{u}" for u in rerate[:60]] + [
        f"newu{j}" for j in range(FOLD_NEW_USERS)][:40]
    for n, item in enumerate(new_items):
        for u in rng.choice(raters, 5, replace=False):
            rows.append((str(u), item))
    order = rng.permutation(len(rows))
    return [(rows[k][0], rows[k][1], float(rng.integers(1, 11)) / 2,
             FOLD_T0 + timedelta(seconds=int(n)))
            for n, k in enumerate(order)]


def _fold_store(tmp: str, data, new_events):
    """A sqlite store holding the dirty users' training ratings (at
    2026-01-01 + one second each) and the new events; returns (storage,
    app id)."""
    import numpy as np

    from predictionio_torch.data.datamap import DataMap
    from predictionio_torch.data.events import Event
    from predictionio_torch.storage.base import App
    from predictionio_torch.storage.registry import (
        SourceConfig,
        Storage,
        StorageConfig,
    )

    src = SourceConfig(name="FOLD", type="sqlite",
                       path=os.path.join(tmp, "fold", "pio.db"))
    storage = Storage(StorageConfig(metadata=src, modeldata=src,
                                    eventdata=src))
    app_id = storage.meta_apps().insert(App(id=0, name="FoldApp"))
    dirty = {u for u, _, _, _ in new_events if u.startswith("u")}
    codes = np.asarray([int(u[1:]) for u in dirty])
    sel = np.nonzero(np.isin(data.train_u, codes))[0]
    t0 = datetime(2026, 1, 1, tzinfo=timezone.utc)

    def rate(u, i, r, t):
        return Event(event="rate", entity_type="user", entity_id=u,
                     target_entity_type="item", target_entity_id=i,
                     properties=DataMap({"rating": r}), event_time=t)

    base = [rate(f"u{data.train_u[n]}", f"i{data.train_i[n]}",
                 float(data.train_r[n]), t0 + timedelta(seconds=int(n)))
            for n in sel]
    le = storage.l_events()
    for lo in range(0, len(base), 20_000):
        le.insert_batch(base[lo:lo + 20_000], app_id)
    le.insert_batch([rate(*e) for e in new_events], app_id)
    return storage, app_id, len(base)


def _histories(storage, app_id, users, items):
    """Each dirty user's and new item's full keep-last history out of the
    store, [(opposing id, rating)] in event-time order."""
    def keep_last(events, key, other):
        hist: dict = {}
        for e in events:  # (event_time, creation_time, id) order
            hist.setdefault(key(e), {})[other(e)] = float(
                e.properties["rating"])
        return {k: list(v.items()) for k, v in hist.items()}

    le = storage.l_events()
    user_hist = keep_last(
        le.find(app_id, entity_id=sorted(users), event_names=["rate"]),
        lambda e: e.entity_id, lambda e: e.target_entity_id)
    item_hist = keep_last(
        le.find(app_id, target_entity_id=sorted(items),
                event_names=["rate"]),
        lambda e: e.target_entity_id, lambda e: e.entity_id)
    return user_hist, item_hist


def _entries(hist: dict, ids) -> list:
    import numpy as np

    return [(np.asarray([ids[o] for o, _ in pairs], np.int32),
             np.asarray([v for _, v in pairs], np.float32))
            for _, pairs in sorted(hist.items())]


def _normal_equations_rel(factors, rows: dict, opposing, ids, reg: float):
    """Largest violation, over the folded rows, of rtol 1e-3 / atol 1e-4
    against a float64 solve of each row's weighted normal equations;
    ≤ 1 passes (the reference's bar, tests/test_online.py)."""
    import numpy as np

    worst = 0.0
    opp = np.asarray(opposing, np.float64)
    k = opp.shape[1]
    for row, pairs in rows.items():
        y = opp[[ids[o] for o, _ in pairs]]
        v = np.asarray([r for _, r in pairs])
        want = np.linalg.solve(y.T @ y + reg * len(pairs) * np.eye(k),
                               y.T @ v)
        err = np.abs(factors[row] - want) / (1e-4 + 1e-3 * np.abs(want))
        worst = max(worst, float(err.max()))
    return worst


def _launch_delta(before: dict) -> dict:
    from predictionio_torch.ops import spd_solve

    return {k: v - before.get(k, 0)
            for k, v in spd_solve.launches_by_rank.items()
            if v != before.get(k, 0)}


# the functions of a fold whose cumulative host ms phase 6 reports, as
# (module file, function): id growth, history coding, the seen sets, the
# solve's bucketing, upload and device half
FOLD_HOST_FUNCS = (
    ("foldin.py", "fold_model"), ("foldin.py", "extend_bimap"),
    ("foldin.py", "entries"), ("foldin.py", "rows_of"),
    ("foldin.py", "solve_rows"), ("foldin.py", "fold_bucket"),
    ("als.py", "bucket_ragged"), ("als.py", "_put_buckets"),
    ("als.py", "_solve_buckets_device"), ("bimap.py", "__init__"),
    ("bimap.py", "__getitem__"), ("arraysetops", "unique"))


def _fold_profile(model, cfg, user_hist, item_hist) -> dict:
    """Where one backlog `fold_model` call spends its time: its wall
    (median of three, synchronised), the device's busy ms in the same
    call under `torch.profiler` (kernels, copies and sets), and the host
    ms by function under cProfile: cumulative for FOLD_HOST_FUNCS, and
    the ten largest self times (`fold_model`'s own is its id-set and
    seen-set loops, comprehensions included)."""
    import cProfile
    import pstats

    import torch

    from predictionio_torch.online import fold_model
    from predictionio_torch.tools.profile_train import device_time_by_kernel

    def fold():
        fold_model(model, cfg, user_hist, item_hist)
        torch.cuda.synchronize()

    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fold()
        walls.append((time.perf_counter() - t0) * 1e3)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fold()
    by_kernel = device_time_by_kernel(prof)
    busy = sum(r["device_ms"] for r in by_kernel)
    host = cProfile.Profile()
    host.enable()
    fold()
    host.disable()
    stats = pstats.Stats(host).stats
    cum, own = {}, []
    for (path, _, func), (_, _, self_s, cum_s, _) in stats.items():
        base = os.path.basename(path)
        if "arraysetops" in base:  # numpy's module, by its version
            base = "arraysetops"
        if (base, func) in FOLD_HOST_FUNCS:
            cum[f"{base}:{func}"] = cum.get(f"{base}:{func}", 0.0) + cum_s * 1e3
        own.append((self_s * 1e3, f"{base}:{func}"))
    wall = sorted(walls)[1]
    return {"wall_ms": wall, "device_busy_ms": busy,
            "host_share": 1.0 - busy / wall, "device_top": by_kernel[:6],
            "cprofile_wall_ms": cum.get("foldin.py:fold_model", 0.0),
            "host_cum_ms": cum,
            "host_self_ms_top": [{"name": n, "ms": ms}
                                 for ms, n in sorted(own, reverse=True)[:10]]}


def _full_width_model(res, data, device):
    """Phase 3's `2m` train result as the template's ALSModel."""
    from predictionio_torch.data.bimap import BiMap
    from predictionio_torch.models.als_model import ALSModel, SeenItems

    return ALSModel(
        user_factors=res.user_factors, item_factors=res.item_factors,
        user_ids=BiMap.string_int([f"u{n}" for n in range(data.n_users)]),
        item_ids=BiMap.string_int([f"i{n}" for n in range(data.n_items)]),
        seen=SeenItems(data.train_u, data.train_i, data.n_users),
        device=str(device))


def _fold_rank(rank: int, res, data, device, storage, app_id, new_events):
    """Phase 6 at one rank; returns its row."""
    import numpy as np
    import torch

    from predictionio_torch.ingest.tailer import StoreTailer
    from predictionio_torch.online import fold_model, solve_rows
    from predictionio_torch.online.foldin import fold_bucket
    from predictionio_torch.ops import spd_solve
    from predictionio_torch.ops.als import ALSConfig

    class Backlog(StoreTailer):
        """Batch mode: the whole fresh batch, marked once collected."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.batch = []

        def _process(self, fresh):
            self.batch.extend(fresh)
            for e in fresh:
                self._mark(e)
            return len(fresh)

    model = _full_width_model(res, data, device)
    cfg = ALSConfig(rank=rank, reg=0.01)  # the train's λ, solver auto
    kernel = FOLD_KERNEL[rank]
    tailer = Backlog(storage, app_id=app_id, event_names=["rate"],
                     since=FOLD_T0)
    t0 = time.perf_counter()
    collected = tailer.poll_once()
    poll_ms = (time.perf_counter() - t0) * 1e3
    if collected != len(new_events) or tailer.poll_once() != 0:
        raise AssertionError(f"the tailer collected {collected} of "
                             f"{len(new_events)} new events")
    dirty = {e.entity_id for e in tailer.batch}
    new_items = sorted({e.target_entity_id for e in tailer.batch}
                       - set(model.item_ids.keys()))
    t0 = time.perf_counter()
    user_hist, item_hist = _histories(storage, app_id, dirty, new_items)
    gather_ms = (time.perf_counter() - t0) * 1e3

    # the whole backlog, users then the new items, on the card
    before = dict(spd_solve.launches_by_rank)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    folded, stats = fold_model(model, cfg, user_hist, item_hist)
    backlog_ms = (time.perf_counter() - t0) * 1e3
    launches = {"backlog": _launch_delta(before)}
    n_users, n_items = len(model.user_ids), len(model.item_ids)
    new_users = sorted(u for u in dirty if u not in model.user_ids)
    if (stats.folded_users, stats.new_users, stats.folded_items,
            stats.new_items) != (len(user_hist), len(new_users),
                                 len(new_items), len(new_items)):
        raise AssertionError(f"rank {rank}: fold stats {stats}")
    if ([folded.user_ids[u] for u in new_users]
            != list(range(n_users, n_users + len(new_users)))
            or [folded.item_ids[i] for i in new_items]
            != list(range(n_items, n_items + len(new_items)))
            or folded.user_factors.shape != (n_users + len(new_users), rank)
            or folded.item_factors.shape != (n_items + len(new_items), rank)):
        raise AssertionError(f"rank {rank}: cold rows not appended")
    touched_u = np.zeros(len(folded.user_ids), bool)
    touched_u[[folded.user_ids[u] for u in user_hist]] = True
    untouched = (np.array_equal(folded.user_factors[:n_users][
        ~touched_u[:n_users]], model.user_factors[~touched_u[:n_users]])
        and np.array_equal(folded.item_factors[:n_items],
                           model.item_factors))
    # users solve against the item factors they were given, the new
    # items against the folded users
    rel_users = _normal_equations_rel(
        folded.user_factors,
        {folded.user_ids[u]: p for u, p in user_hist.items()},
        np.concatenate([model.item_factors,
                        np.zeros((len(new_items), rank), np.float32)]),
        folded.item_ids, cfg.reg)
    rel_items = _normal_equations_rel(
        folded.item_factors,
        {folded.item_ids[i]: p for i, p in item_hist.items()},
        folded.user_factors, folded.user_ids, cfg.reg)
    # a folded user's recommendations exclude what it rated
    excluded = True
    for u in sorted(user_hist)[:50]:
        recs = {i for i, _ in folded.recommend_products(u, 10)}
        excluded &= not recs & {i for i, _ in user_hist[u]}

    # replay (users only: with items on, a replay is one more
    # alternation half-step) is bitwise idempotent
    once, _ = fold_model(model, cfg, user_hist)
    twice, _ = fold_model(once, cfg, user_hist)
    replay_equal = (np.array_equal(once.user_factors, twice.user_factors)
                    and np.array_equal(once.item_factors,
                                       twice.item_factors))

    # single ≡ batched at a matched tier: eight users whose lone folds
    # share one capacity tier, folded together and alone
    entries = _entries(user_hist, folded.item_ids)
    names = sorted(user_hist)
    caps = [fold_bucket([e], rank, cfg.cap_growth)[0].cols.shape[1]
            for e in entries]
    common = max(set(caps), key=caps.count)
    eight = [n for n, c in enumerate(caps) if c == common][:8]
    opp_all = torch.as_tensor(np.concatenate([
        model.item_factors, np.zeros((len(new_items), rank), np.float32)]),
        device=device)
    batched = solve_rows(opp_all, [entries[n] for n in eight], cfg)
    alone = torch.cat([solve_rows(opp_all, [entries[n]], cfg)
                       for n in eight])
    matched_equal = bool(torch.equal(batched, alone))
    # ... and across tiers: alone (tier 8) against inside the backlog
    in_backlog = torch.as_tensor(once.user_factors[
        [once.user_ids[names[n]] for n in eight]], device=device)
    cross_tier = float((alone - in_backlog).abs().max())

    # wall by batch size, the backlog's host/device split, launches by tier
    sizes = {}
    for size in FOLD_SIZES:
        part = {u: user_hist[u] for u in names[:size]}
        fold_model(model, cfg, part)  # warm
        walls = []
        before = dict(spd_solve.launches_by_rank)
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fold_model(model, cfg, part)
            walls.append((time.perf_counter() - t0) * 1e3)
        launches[str(size)] = {k: v // 5 for k, v in
                               _launch_delta(before).items()}
        sizes[str(size)] = sorted(walls)[2]
    profile = _fold_profile(model, cfg, user_hist, item_hist)

    row = {"rank": rank, "kernel": kernel,
           "new_events": len(new_events), "collected": collected,
           "poll_ms": poll_ms, "history_gather_ms": gather_ms,
           "dirty_users": len(user_hist), "new_users": len(new_users),
           "new_items": len(new_items),
           "history_entries": sum(len(p) for p in user_hist.values()),
           "fold_ms_by_users": sizes, "fold_ms_backlog": backlog_ms,
           "backlog_profile": profile,
           "launches_by_tier": launches,
           "normal_equations_worst": max(rel_users, rel_items),
           "single_equals_batched_matched_tier": matched_equal,
           "matched_cap_tier": common,
           "cross_tier_max_abs_diff": cross_tier,
           "replay_bitwise_equal": replay_equal,
           "untouched_bitwise_equal": untouched,
           "recommendations_exclude_rated": excluded}
    emit(dict(phase="fold", **row))
    # every tier's solves on the rank's kernel, and on nothing else
    wrong = {tier: by_rank for tier, by_rank in launches.items()
             if not by_rank or any(not k.startswith(kernel + "/")
                                   for k in by_rank)}
    if (row["normal_equations_worst"] > 1.0 or not matched_equal
            or not replay_equal or not untouched or not excluded
            or wrong):
        raise AssertionError(f"rank {rank} fold failed a bar: {row}")
    return row


def phase_fold(report: dict, data, device, trained: dict, tmp: str) -> dict:
    """New ratings written to a sqlite store, collected by a batch-mode
    StoreTailer, each dirty user's full history gathered from the store,
    then `fold_model` on the card at rank 64 and 128."""
    new_events = _fold_events(data)
    t0 = time.perf_counter()
    storage, app_id, n_base = _fold_store(tmp, data, new_events)
    store_s = time.perf_counter() - t0
    try:
        rows = {rank: _fold_rank(rank, trained[rank], data, device, storage,
                                 app_id, new_events)
                for rank in FOLD_RANKS}
    finally:
        storage.close()
    report["fold"] = {"store_events": n_base + len(new_events),
                      "store_write_s": store_s, **{
                          str(rank): row for rank, row in rows.items()}}
    return rows


# -- phase 7 -----------------------------------------------------------------

def _metric_totals(text: str, families) -> dict:
    """Count and sum of each histogram family in a `/metrics` exposition,
    by label set ("" for a family without labels)."""
    out: dict = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        series, value = line.rsplit(" ", 1)
        name, _, labels = series.partition("{")
        for family in families:
            for part in ("count", "sum"):
                if name == f"{family}_{part}":
                    out.setdefault(family, {}).setdefault(
                        labels.rstrip("}"), {})[part] = float(value)
    return out


def _get(url: str):
    with urllib.request.urlopen(url, timeout=60) as resp:
        return resp.read()


def _where(factors) -> str:
    """Where a served model holds its factors."""
    import torch

    if isinstance(factors, torch.Tensor):
        return f"{factors.device} tensor"
    return "host numpy"


def _timed_queries(url: str, users) -> float:
    """Mean ms of one POST /queries.json over `users`."""
    t0 = time.perf_counter()
    for u in users:
        _post(url, {"user": u, "num": 10})
    return (time.perf_counter() - t0) / len(users) * 1e3


def _online_http(device, tmp: str, served: dict) -> tuple[dict, dict]:
    """(a) `console deploy` of phase 4's store with PIO_ONLINE=1 in a
    child process; ONLINE_ROUNDS rounds written into the same pio.db with
    the storage API, each one polled over HTTP until its never-seen user
    is served with what it rated excluded. Returns its row and the
    child's launch counts."""
    import numpy as np

    from predictionio_torch.data.datamap import DataMap
    from predictionio_torch.data.events import Event
    from predictionio_torch.storage.registry import Storage, StorageConfig

    base = served["store_base"]
    launches_path = os.path.join(tmp, "online-child-launches.json")
    env = dict(os.environ, PYTHONPATH=HERE, PIO_FS_BASEDIR=base,
               PIO_ONLINE="1")
    for knob in ("PIO_ONLINE_INTERVAL_S", "PIO_ONLINE_FOLD_ITEMS",
                 "PIO_ONLINE_MAX_BATCH", "PIO_ONLINE_APP_ID"):
        env.pop(knob, None)
    proc = subprocess.Popen(
        [sys.executable, "-c", _DEPLOY_CHILD, launches_path, "deploy",
         "--engine-json", served["engine_json"], "--ip", "127.0.0.1",
         "--port", "0", "--device", str(device)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=HERE, env=env)
    storage = Storage(StorageConfig.from_env({"PIO_FS_BASEDIR": base}))
    rng = np.random.default_rng(7)
    users, items = served["users"], served["items"]
    rounds = []
    try:
        line = _read_deployed_line(proc, 300.0)
        url = f"http://127.0.0.1:{int(line.rsplit(':', 1)[1])}"
        status = json.loads(_get(url + "/"))
        if "online" not in status:
            raise AssertionError(f"the deployed server runs no online "
                                 f"plane: {status}")
        app_id = storage.meta_apps().get_by_name("MyApp1").id
        le = storage.l_events()
        timed_users = users[:ONLINE_TIMED_QUERIES]
        query_ms = {"before_first_fold": _timed_queries(url, timed_users)}
        written = 0
        for r in range(ONLINE_ROUNDS):
            new_user = f"online-u{r}"
            rated = [str(i) for i in rng.choice(items, ONLINE_NEW_RATINGS,
                                                replace=False)]
            rows = [(new_user, i, 5.0) for i in rated]
            rows += [(str(u), str(rng.choice(items)),
                      float(rng.integers(1, 11)) / 2)
                     for u in rng.choice(users, ONLINE_RERATERS,
                                         replace=False)]
            for u, i, rating in rows:
                le.insert(Event(event="rate", entity_type="user",
                                entity_id=u, target_entity_type="item",
                                target_entity_id=i,
                                properties=DataMap({"rating": rating})),
                          app_id)
            committed = time.perf_counter()
            written += len(rows)
            queries = 0
            servable_ms = None
            while time.perf_counter() - committed < ONLINE_ROUND_TIMEOUT_S:
                got = [s["item"] for s in _post(
                    url, {"user": new_user, "num": 10})["itemScores"]]
                queries += 1
                if got and not set(got) & set(rated):
                    servable_ms = (time.perf_counter() - committed) * 1e3
                    break
                time.sleep(0.002)
            rounds.append({"round": r, "servable_ms": servable_ms,
                           "queries": queries})
            if r == 0:
                query_ms["after_first_fold"] = _timed_queries(
                    url, timed_users)
        query_ms["after_last_round"] = _timed_queries(url, timed_users)
        status = json.loads(_get(url + "/"))
        metrics = _metric_totals(_get(url + "/metrics").decode(), (
            "online_event_to_servable_seconds", "online_foldin_seconds",
            "storage_op_seconds"))
    finally:
        storage.close()
        proc.terminate()
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    with open(launches_path) as f:
        child = json.load(f)
    servable = [r["servable_ms"] for r in rounds
                if r["servable_ms"] is not None]
    row = {"rounds": len(rounds), "rounds_servable": len(servable),
           "events_written": written,
           "events_folded": status["online"]["eventsFolded"],
           "watermark": status["online"]["watermark"],
           "event_to_servable_ms_median": (float(np.median(servable))
                                           if servable else None),
           "event_to_servable_ms_max": max(servable, default=None),
           "event_to_servable_ms": [r["servable_ms"] for r in rounds],
           "queries_until_servable": [r["queries"] for r in rounds],
           "query_ms": query_ms, "metrics": metrics,
           "child_launches": {k: v for k, v in child["launches"].items()
                              if v},
           "child_launches_by_rank": child["by_rank"]}
    other = {k: v for k, v in child["launches"].items()
             if v and k != "gj_aug_reg"}
    if (len(servable) != ONLINE_ROUNDS or written != row["events_folded"]
            or child["launches"]["gj_aug_reg"] <= 0 or other):
        raise AssertionError(f"online over HTTP failed a bar: {row}")
    return row, child["launches"]


def _hand_polled_server(engine_json: str, device, storage, config):
    """A PredictionServer over `storage` whose online plane polls only when
    called: a deployed plane starts its tailer thread at once, and its
    first pass would fold a backlog already in the store on that thread."""
    from predictionio_torch.online import OnlinePlane
    from predictionio_torch.workflow.create_server import PredictionServer

    server = PredictionServer(engine_json, ip="127.0.0.1", port=0,
                              device=device, storage=storage)
    server.online = OnlinePlane(server, config)
    return server


def _online_in_process(device, tmp: str, served: dict) -> dict:
    """(b) A PredictionServer with the plane (fold_items=False) over a
    copy of (a)'s pio.db: the crash drill at `online.pre_watermark`, a
    second train and POST /reload, then `parity_check`."""
    import shutil

    import numpy as np

    from predictionio_torch.controller import WorkflowContext
    from predictionio_torch.data.datamap import DataMap
    from predictionio_torch.data.events import Event
    from predictionio_torch.online import OnlineConfig
    from predictionio_torch.storage.registry import Storage, StorageConfig
    from predictionio_torch.utils.faults import FaultInjected
    from predictionio_torch.workflow.core_workflow import CoreWorkflow
    from predictionio_torch.workflow.workflow_utils import (
        extract_engine_params,
        get_engine,
        read_engine_json,
    )

    base = os.path.join(tmp, "online-copy")
    shutil.copytree(served["store_base"], base)
    storage = Storage(StorageConfig.from_env({"PIO_FS_BASEDIR": base}))
    server = _hand_polled_server(served["engine_json"], device, storage,
                                 OnlineConfig(fold_items=False))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    items = served["items"]
    app_id = storage.meta_apps().get_by_name("MyApp1").id

    def rate(rows):
        for u, i, rating in rows:
            storage.l_events().insert(Event(
                event="rate", entity_type="user", entity_id=u,
                target_entity_type="item", target_entity_id=i,
                properties=DataMap({"rating": rating})), app_id)

    def recommended(user):
        return [s["item"] for s in server.predict(
            {"user": user, "num": 10})["itemScores"]]

    try:
        first = server.state.instance.id
        t0 = time.perf_counter()
        caught_up = server.online.poll_once()  # (a)'s rounds, replayed
        catch_up_ms = (time.perf_counter() - t0) * 1e3
        factors = server.state.models[0].user_factors
        where = _where(factors)

        # the crash drill: the fold lands, the watermark does not
        drill = [("drill-u", items[3], 5.0), ("drill-u", items[30], 4.0),
                 ("drill-u", items[300], 5.0), (served["users"][5],
                                                items[7], 1.0)]
        rate(drill)
        os.environ["PIO_FAULTS"] = "online.pre_watermark=error"
        try:
            try:
                server.online.poll_once()
                raised = False
            except FaultInjected:
                raised = True
        finally:
            os.environ.pop("PIO_FAULTS")
        model = server.state.models[0]
        rows = [model.user_ids.get(u) for u in ("drill-u",
                                                served["users"][5])]
        pre = (np.array(np.asarray(model.user_factors)[rows], copy=True)
               if None not in rows else None)
        replayed = server.online.poll_once()
        model = server.state.models[0]
        replay_equal = pre is not None and np.array_equal(
            np.asarray(model.user_factors)[rows], pre)
        settled = server.online.poll_once()

        # a second train into the store, then POST /reload
        variant = read_engine_json(served["engine_json"])
        engine = get_engine(variant.engine_factory)
        second = CoreWorkflow.run_train(
            engine, extract_engine_params(engine, variant), variant,
            WorkflowContext(device=device, storage=storage, seed=2)).id
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.port}/reload", data=b"")
        with urllib.request.urlopen(req, timeout=120) as resp:
            reloaded = json.loads(resp.read())
        after = [("reload-u", items[11], 5.0), ("reload-u", items[12], 5.0),
                 ("reload-u", items[13], 4.5)]
        rate(after)
        after_reload = server.online.poll_once()
        recs = recommended("reload-u")
        folded_on_new = (server.state.instance.id == second
                         and server.state.models[0].user_ids.get("reload-u")
                         is not None)
        t0 = time.perf_counter()
        parity = server.online.parity_check()[variant.variant]
        parity["ms"] = (time.perf_counter() - t0) * 1e3
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
        storage.close()
    row = {"catch_up_events": caught_up, "catch_up_ms": catch_up_ms,
           "factors_after_fold": where,
           "drill_raised": raised, "drill_replayed": replayed,
           "replay_bitwise_equal": bool(replay_equal),
           "drill_settled": settled, "first_instance": first,
           "second_instance": second, "reload": reloaded,
           "after_reload_events": after_reload,
           "after_reload_servable": bool(recs) and not (
               set(recs) & {i for _, i, _ in after}),
           "folded_on_new_instance": folded_on_new, "parity": parity}
    if (not raised or replayed != len(drill) or not replay_equal
            or settled != 0 or reloaded.get("engineInstanceId") != second
            or second == first or after_reload < len(after)
            or not row["after_reload_servable"] or not folded_on_new
            or parity["rel_max"] > ONLINE_PARITY_BAR):
        raise AssertionError(f"online in process failed a bar: {row}")
    return row


def _persist_instance(storage, engine_json: str, model, start_time):
    """A completed engine instance of `engine_json`'s engine holding
    `model`, as `CoreWorkflow.run_train` persists one, begun at
    `start_time` (where the plane's watermark starts)."""
    from predictionio_torch.storage.base import EngineInstance, Model
    from predictionio_torch.workflow.workflow_utils import (
        engine_params_to_json,
        extract_engine_params,
        get_engine,
        read_engine_json,
    )

    variant = read_engine_json(engine_json)
    engine = get_engine(variant.engine_factory)
    instance = EngineInstance(
        id="", status="COMPLETED", start_time=start_time,
        end_time=start_time, engine_id=variant.id, engine_version="1",
        engine_variant=variant.variant,
        engine_factory=variant.engine_factory,
        **engine_params_to_json(extract_engine_params(engine, variant)))
    instance.id = storage.meta_engine_instances().insert(instance)
    storage.model_data_models().insert(
        Model(id=instance.id, models=engine.serialize_models([model])))
    return instance.id


def _timed_plane(plane) -> dict:
    """Time every `_gather_histories` and `_fold_batch` call of `plane`;
    returns the dict of lists the calls append their ms to."""
    log = {"gather": [], "fold_pass": []}
    for name, key in (("_gather_histories", "gather"),
                      ("_fold_batch", "fold_pass")):
        inner = getattr(plane, name)

        def timed(*args, _inner=inner, _key=key):
            t0 = time.perf_counter()
            try:
                return _inner(*args)
            finally:
                log[_key].append((time.perf_counter() - t0) * 1e3)

        setattr(plane, name, timed)
    return log


def _online_full_width(device, tmp: str, data, trained: dict,
                       fold_rows: dict) -> dict:
    """(c) Phase 3's `2m` rank-64 and rank-128 models as completed
    instances in phase 6's store, each served by a PredictionServer with
    the plane (fold_items=False): one poll of phase 6's backlog with a
    cold history cache, then one after each of its users re-rates one
    item (warm)."""
    import numpy as np

    from predictionio_torch.data.datamap import DataMap
    from predictionio_torch.data.events import Event
    from predictionio_torch.ops import spd_solve
    from predictionio_torch.online import OnlineConfig
    from predictionio_torch.storage.registry import (
        SourceConfig,
        Storage,
        StorageConfig,
    )

    src = SourceConfig(name="FOLD", type="sqlite",
                       path=os.path.join(tmp, "fold", "pio.db"))
    storage = Storage(StorageConfig(metadata=src, modeldata=src,
                                    eventdata=src))
    app_id = storage.meta_apps().get_by_name("FoldApp").id
    backlog_events = storage.l_events().find(app_id, start_time=FOLD_T0)
    backlog = len(backlog_events)
    dirty = sorted({e.entity_id for e in backlog_events})
    servers, timers = {}, {}
    rows = {}
    try:
        for rank in FOLD_RANKS:
            engine_json = os.path.join(tmp, f"engine-fold{rank}.json")
            with open(engine_json, "w") as f:
                json.dump({
                    "id": f"fold{rank}", "engineFactory": "predictionio_"
                    "torch.templates.recommendation.RecommendationEngine",
                    "datasource": {"params": {"appName": "FoldApp",
                                              "eventNames": ["rate"]}},
                    "algorithms": [{"name": "als", "params": {
                        "rank": rank, "lambda": 0.01}}],
                    "serving": {"name": "first"}}, f)
            t0 = time.perf_counter()
            _persist_instance(storage, engine_json,
                              _full_width_model(trained[rank], data, device),
                              FOLD_T0)
            persist_ms = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            server = _hand_polled_server(
                engine_json, device, storage,
                OnlineConfig(fold_items=False,
                             max_batch=max(4096, 2 * backlog)))
            servers[rank] = server
            timers[rank] = _timed_plane(server.online)
            rows[rank] = {"rank": rank, "kernel": FOLD_KERNEL[rank],
                          "persist_ms": persist_ms,
                          "load_ms": (time.perf_counter() - t0) * 1e3}
        polls = {}
        for phase in ("cold", "warm"):
            if phase == "warm":
                # every user of the backlog re-rates one item, after it
                rng = np.random.default_rng(8)
                start = FOLD_T0 + timedelta(seconds=2 * backlog)
                storage.l_events().insert_batch([Event(
                    event="rate", entity_type="user", entity_id=u,
                    target_entity_type="item",
                    target_entity_id=f"i{rng.integers(data.n_items)}",
                    properties=DataMap({"rating": float(
                        rng.integers(1, 11)) / 2}),
                    event_time=start + timedelta(seconds=n))
                    for n, u in enumerate(dirty)], app_id)
            for rank, server in servers.items():
                before = dict(spd_solve.launches_by_rank)
                t0 = time.perf_counter()
                events = server.online.poll_once()
                poll_ms = (time.perf_counter() - t0) * 1e3
                timer = timers[rank]
                polls[(rank, phase)] = {
                    "events": events, "poll_ms": poll_ms,
                    "history_gather_ms": timer["gather"][-1],
                    "fold_pass_ms": timer["fold_pass"][-1],
                    "fold_ms": timer["fold_pass"][-1] - timer["gather"][-1],
                    "launches": _launch_delta(before)}
        for rank, server in servers.items():
            model = server.state.models[0]
            factors = model.user_factors
            rows[rank].update({
                "backlog_events": backlog,
                "cold": polls[(rank, "cold")], "warm": polls[(rank, "warm")],
                "phase6_history_gather_ms": fold_rows[rank][
                    "history_gather_ms"],
                "factors_after_fold": _where(factors),
                "users_served": len(model.user_ids),
                "rerating_users": len(dirty)})
    finally:
        for server in servers.values():
            server.server_close()
        storage.close()
    for rank, row in rows.items():
        kernel = FOLD_KERNEL[rank]
        emit(dict(phase="online_full_width", **row))
        wrong = [p for p in ("cold", "warm")
                 if not row[p]["launches"] or any(
                     not k.startswith(kernel + "/")
                     for k in row[p]["launches"])]
        if (row["cold"]["events"] != backlog
                or row["warm"]["events"] != len(dirty)
                or len(dirty) != FOLD_RERATERS + FOLD_NEW_USERS or wrong):
            raise AssertionError(f"rank {rank} online at full width failed "
                                 f"a bar: {row}")
    return rows


def phase_online(report: dict, device, tmp: str, served: dict, data,
                 trained: dict, fold_rows: dict) -> dict:
    """Phase 7: (a) over HTTP in a child process, (b) in process on a copy
    of (a)'s store, (c) at full width on phase 6's store. Returns the
    child's launch counts (the in-process ones are the caller's)."""
    t0 = time.perf_counter()
    http, child_launches = _online_http(device, tmp, served)
    emit(dict(phase="online_http", **http))
    in_process = _online_in_process(device, tmp, served)
    emit(dict(phase="online_in_process", **in_process))
    full = _online_full_width(device, tmp, data, trained, fold_rows)
    report["online"] = {"http": http, "in_process": in_process,
                        "full_width": {str(k): v for k, v in full.items()},
                        "wall_s": time.perf_counter() - t0}
    return child_launches


# -- phase 8 -----------------------------------------------------------------

def _scrape(url: str) -> dict:
    """Every sample of a `/metrics` exposition: series (name and labels,
    as rendered) → value."""
    out = {}
    for line in _get(url + "/metrics").decode().splitlines():
        if line and not line.startswith("#"):
            series, value = line.rsplit(" ", 1)
            out[series] = float(value)
    return out


def _delta(after: dict, before: dict, series: str) -> float:
    return after.get(series, 0.0) - before.get(series, 0.0)


def _start_deploy(args: list, env_extra: dict, launches_path: str):
    """A `console deploy` child through _DEPLOY_CHILD, which writes its
    launch counts to `launches_path` when it exits; its output is
    drained by `_read_deployed_line`."""
    env = dict(os.environ, PYTHONPATH=HERE, **env_extra)
    for knob in SERVING_KNOBS:
        if knob not in env_extra:
            env.pop(knob, None)
    return subprocess.Popen(
        [sys.executable, "-c", _DEPLOY_CHILD, launches_path, "deploy"]
        + args, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=HERE, env=env)


def _stop(proc) -> None:
    proc.terminate()
    try:
        proc.wait(timeout=60)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()


def _closed_loop(port: int, requests: list, clients: int) -> tuple:
    """Send every (method, path, body) of `requests` over `clients`
    keep-alive connections (`http.client`, one thread and connection a
    client, started together, the requests dealt round robin). Returns
    (status, body bytes, Retry-After header, ms) by request and the wall
    seconds; raises if a connection failed."""
    import http.client

    out: list = [None] * len(requests)
    errors: list = []
    start = threading.Barrier(clients + 1)

    def client(k: int) -> None:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        try:
            start.wait(timeout=60)
            for n in range(k, len(requests), clients):
                method, path, body = requests[n]
                t0 = time.perf_counter()
                conn.request(method, path, body=body,
                             headers={"Content-Type": "application/json"})
                resp = conn.getresponse()
                data = resp.read()
                out[n] = (resp.status, data, resp.getheader("Retry-After"),
                          (time.perf_counter() - t0) * 1e3)
        except Exception as e:  # noqa: BLE001 — reported as the run's failure
            errors.append((k, repr(e)))
        finally:
            conn.close()

    threads = [threading.Thread(target=client, args=(k,), daemon=True)
               for k in range(clients)]
    for t in threads:
        t.start()
    start.wait(timeout=60)
    t0 = time.perf_counter()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in threads) or None in out:
        raise AssertionError(f"{clients}-client run on port {port} failed: "
                             f"{errors[:5]}")
    return out, wall


def _load(url: str, queries: list, clients: int) -> tuple[list, dict]:
    """POST every query of `queries` over `clients` keep-alive
    connections (`_closed_loop`). Returns the answer bodies (bytes) by
    query and the run's row: qps over the wall, p50 and p99 of the
    per-request ms, and the serving families' deltas from `/metrics`:
    dispatches, mean batch size (before padding), padded rows and batches
    above SERVE_HOST_MAX_BATCH (the device branch)."""
    import numpy as np

    before = _scrape(url)
    out, wall = _closed_loop(
        int(url.rsplit(":", 1)[1]),
        [("POST", "/queries.json", json.dumps(q)) for q in queries], clients)
    after = _scrape(url)
    errors = [(n, status, body[:200])
              for n, (status, body, _, _) in enumerate(out) if status != 200]
    if errors:
        raise AssertionError(f"{clients}-client load on {url} failed: "
                             f"{errors[:5]}")
    bodies = [body for _, body, _, _ in out]
    ms = [t for _, _, _, t in out]
    batches = _delta(after, before, "serving_batch_size_count")
    small = _delta(after, before,
                   'serving_batch_size_bucket{le="64"}')
    row = {"clients": clients, "queries": len(queries), "wall_s": wall,
           "qps": len(queries) / wall,
           "p50_ms": float(np.percentile(ms, 50)),
           "p99_ms": float(np.percentile(ms, 99)),
           "dispatches": batches,
           "mean_batch": (_delta(after, before, "serving_batch_size_sum")
                          / batches if batches else None),
           "padded_rows": _delta(after, before, "serving_padded_rows_total"),
           "batches_above_64": batches - small,
           "device_share": (batches - small) / batches if batches else None}
    return bodies, row


def _untied_against(bodies: list, reference: list) -> dict:
    """Each answer's item ids against the reference answer's wherever
    its scores are not tied (raises on a difference); the positions
    compared and the max abs score difference."""
    import numpy as np

    max_diff, compared = 0.0, 0
    for got_raw, want_raw in zip(bodies, reference):
        got = json.loads(got_raw)["itemScores"]
        want = json.loads(want_raw)["itemScores"]
        if len(got) != len(want):
            raise AssertionError(f"device-branch answer {got} != {want}")
        scores = np.asarray([s["score"] for s in want])
        gaps = np.abs(np.diff(scores)) < 1e-5
        tied = np.zeros(len(want), bool)
        tied[:-1] |= gaps
        tied[1:] |= gaps
        for pos in np.nonzero(~tied)[0]:
            if got[pos]["item"] != want[pos]["item"]:
                raise AssertionError(f"device branch differs from the "
                                     f"host's at {pos}: {got} vs {want}")
            compared += 1
        if want:
            max_diff = max(max_diff, float(np.max(np.abs(
                np.asarray([s["score"] for s in got]) - scores))))
    return {"positions_compared": compared, "max_abs_score_diff": max_diff}


def _serving_loads(urls: dict, data) -> dict:
    """8a and 8b: the `2m` rank-64 instance under 1, 8 and 32 clients
    with batching on and off, then twice (cold, warm) under 128 clients
    with max_batch 128. Every answer of 8a equals, byte for byte, the
    one-client answer with batching on; every answer of 8b has its item
    ids wherever the scores are not tied, and each 8b run dispatched at
    least one batch above 64 (the device branch)."""
    import numpy as np

    rng = np.random.default_rng(8)
    queries = [{"user": f"u{int(u)}", "num": 10}
               for u in rng.integers(0, data.n_users, SERVING_QUERIES)]
    runs, reference = [], None
    for mode in ("batching_on", "batching_off"):
        for clients in SERVING_CLIENTS:
            bodies, row = _load(urls[mode], queries, clients)
            if reference is None:
                reference = bodies
            row.update(mode=mode, byte_identical=bodies == reference)
            emit(dict(phase="serving_load", **row))
            runs.append(row)
    device = []
    for when in ("cold", "warm"):
        # the cold run holds the child's first device-branch dispatch
        # (CUDA's lazy start on its dispatcher thread), the warm run not
        bodies, row = _load(urls["device"], queries, SERVING_DEVICE_CLIENTS)
        row.update(mode="max_batch_128", run=when,
                   **_untied_against(bodies, reference))
        emit(dict(phase="serving_load", **row))
        device.append(row)
    if (not all(r["byte_identical"] for r in runs)
            or not all(r["batches_above_64"] > 0 for r in device)):
        raise AssertionError(f"serving under load failed a bar: "
                             f"{runs + device}")
    return {"runs": runs, "device": device}


@contextlib.contextmanager
def _in_process_server(engine_json: str, model: str, device,
                       serving_config=None):
    """A PredictionServer of a model file (its plane configured by
    `serving_config`, None: the defaults), serving on a thread of this
    process."""
    from predictionio_torch.serving import ServingConfig
    from predictionio_torch.workflow.create_server import PredictionServer

    server = PredictionServer(engine_json, model, ip="127.0.0.1", port=0,
                              device=device,
                              serving_config=serving_config or ServingConfig())
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield server, f"http://127.0.0.1:{server.port}"
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)


def _raw_post(url: str, query: dict, headers=None) -> tuple:
    req = urllib.request.Request(
        url + "/queries.json", data=json.dumps(query).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read()), resp.headers
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), e.headers


def train_serving_multi(device, tmp: str, served: dict) -> None:
    """The als + popular engine that 8c sheds to its popularity answer,
    trained from phase 4's events file at phase 4's rank (its launches
    count on the train → serve path); adds its engine.json and model
    file to `served`."""
    from predictionio_torch.tools import console

    with open(served["engine_json"]) as f:
        variant = json.load(f)
    variant["id"] = "serving-multi"
    variant["algorithms"] = variant["algorithms"] + [
        {"name": "popular", "params": {}}]
    variant["serving"] = {"name": "weighted",
                          "params": {"weights": [0.8, 0.2]}}
    multi_json = os.path.join(tmp, "engine-serving-multi.json")
    with open(multi_json, "w") as f:
        json.dump(variant, f)
    multi_model = os.path.join(tmp, "serving-multi.pio")
    if console.main(["train", "--engine-json", multi_json, "--events",
                     served["events"], "--model-out", multi_model,
                     "--device", str(device)]) != 0:
        raise AssertionError("console train of the als + popular engine "
                             "failed")
    served.update(multi_engine_json=multi_json, multi_model=multi_model)


def _serving_contract(device, served: dict) -> dict:
    """8c, in process on the card: phase 4's ALS model and the als +
    popular model of `train_serving_multi`. A lapsed X-PIO-Deadline-Ms
    answers 503, a shed with the popularity algorithm 200 +
    X-PIO-Degraded: 1 and its answer, a shed without it 429, both with
    Retry-After; /metrics counts each."""
    from predictionio_torch.serving import AdmissionConfig, ServingConfig

    query = {"user": served["users"][3], "num": 10}
    row = {}
    with _in_process_server(served["engine_json"], served["model"],
                            device) as (_, url):
        before = _scrape(url)
        code, body, headers = _raw_post(url, query,
                                        {"X-PIO-Deadline-Ms": "0.0001"})
        row["deadline"] = {"status": code, "body": body,
                           "retry_after": headers.get("Retry-After")}
        code, body, headers = _raw_post(url, query)
        row["normal"] = {"status": code,
                         "degraded": headers.get("X-PIO-Degraded")}
    shed = ServingConfig(admission=AdmissionConfig(max_queue=0))
    with _in_process_server(served["multi_engine_json"],
                            served["multi_model"], device,
                            shed) as (server, url):
        code, body, headers = _raw_post(url, query)
        st = server.state
        popular = st.engine.degraded_predict(
            st.engine_params, st.models, query, components=st.components)
        row["degraded"] = {"status": code,
                           "degraded": headers.get("X-PIO-Degraded"),
                           "equals_popularity": body == popular,
                           "items": len(body.get("itemScores", []))}
    with _in_process_server(served["engine_json"], served["model"], device,
                            shed) as (_, url):
        code, body, headers = _raw_post(url, query)
        row["shed"] = {"status": code, "body": body,
                       "retry_after": headers.get("Retry-After")}
        after = _scrape(url)
    row["metrics"] = {series: _delta(after, before, series) for series in (
        'serving_shed_total{reason="queue_full"}',
        'serving_shed_total{reason="deadline"}',
        "serving_deadline_misses_total", "serving_degraded_total",
        "engine_queries_failed_total")}
    m = row["metrics"]
    if (row["deadline"]["status"] != 503 or not row["deadline"]["retry_after"]
            or row["normal"] != {"status": 200, "degraded": None}
            or row["degraded"]["status"] != 200
            or row["degraded"]["degraded"] != "1"
            or not row["degraded"]["equals_popularity"]
            or not row["degraded"]["items"]
            or row["shed"]["status"] != 429 or not row["shed"]["retry_after"]
            or m['serving_shed_total{reason="queue_full"}'] < 2
            or m["serving_deadline_misses_total"] < 1
            or m["serving_degraded_total"] < 1
            or m["engine_queries_failed_total"] < 2):
        raise AssertionError(f"the serving HTTP contract failed: {row}")
    return row


def _serving_cache(url: str, served: dict, events_folded: int) -> dict:
    """8d: read-your-writes of the result cache under a 600 s TTL, on
    phase 4's store deployed with the online plane (its child started by
    `phase_serving`). Once the plane has caught up with phase 7's events:
    users u and w answer twice each (the second a hit); u rates three of
    its recommended items; within CACHE_RYW_TIMEOUT_S u's answer leaves
    them while w's stays a hit; /reload then makes w a miss."""
    import numpy as np

    from predictionio_torch.data.datamap import DataMap
    from predictionio_torch.data.events import Event
    from predictionio_torch.storage.registry import Storage, StorageConfig

    deadline = time.monotonic() + 120
    while json.loads(_get(url + "/"))["online"]["eventsFolded"] \
            < events_folded:
        if time.monotonic() > deadline:
            raise AssertionError("the plane never caught up with phase 7's "
                                 "events")
        time.sleep(0.05)
    hits, misses = ("http_result_cache_hits_total",
                    "http_result_cache_misses_total")
    invalidations = "http_result_cache_invalidations_total"
    rng = np.random.default_rng(9)
    u, w = (served["users"][int(n)]
            for n in rng.choice(len(served["users"]), 2, replace=False))

    def items(user):
        return [s["item"] for s in _post(url, {"user": user,
                                               "num": 10})["itemScores"]]

    m0 = _scrape(url)
    u_first, u_second = items(u), items(u)
    w_first, w_second = items(w), items(w)
    m1 = _scrape(url)
    rated = u_first[:3]
    storage = Storage(StorageConfig.from_env(
        {"PIO_FS_BASEDIR": served["store_base"]}))
    try:
        app_id = storage.meta_apps().get_by_name("MyApp1").id
        for item in rated:
            storage.l_events().insert(Event(
                event="rate", entity_type="user", entity_id=u,
                target_entity_type="item", target_entity_id=item,
                properties=DataMap({"rating": 5.0})), app_id)
    finally:
        storage.close()
    committed = time.perf_counter()
    fresh_ms, u_fresh, polls = None, u_first, 0
    while time.perf_counter() - committed < CACHE_RYW_TIMEOUT_S:
        u_fresh = items(u)
        polls += 1
        if not set(u_fresh) & set(rated):
            fresh_ms = (time.perf_counter() - committed) * 1e3
            break
        time.sleep(0.002)
    m2 = _scrape(url)
    w_third = items(w)
    m3 = _scrape(url)
    req = urllib.request.Request(url + "/reload", data=b"")
    with urllib.request.urlopen(req, timeout=120) as resp:
        reloaded = json.loads(resp.read())
    m4 = _scrape(url)
    w_after_reload = items(w)
    m5 = _scrape(url)
    row = {"user_u": u, "user_w": w, "rated": rated,
           "second_queries": {"hits": _delta(m1, m0, hits),
                              "misses": _delta(m1, m0, misses)},
           "u_repeat_equal": u_first == u_second,
           "w_repeat_equal": w_first == w_second,
           "event_to_fresh_answer_ms": fresh_ms, "u_polls": polls,
           "u_answer_after": u_fresh,
           "invalidations": _delta(m2, m1, invalidations),
           "w_hit_after_fold": _delta(m3, m2, hits) == 1
           and w_third == w_first,
           "reload": reloaded,
           "reload_invalidations": _delta(m4, m3, invalidations),
           "w_miss_after_reload": _delta(m5, m4, misses) == 1
           and _delta(m5, m4, hits) == 0,
           "w_after_reload": w_after_reload}
    if (row["second_queries"] != {"hits": 2.0, "misses": 2.0}
            or not row["u_repeat_equal"] or not row["w_repeat_equal"]
            or fresh_ms is None or row["invalidations"] < 1
            or not row["w_hit_after_fold"] or "engineInstanceId" not in
            reloaded or not row["w_miss_after_reload"]):
        raise AssertionError(f"read-your-writes through the result cache "
                             f"failed a bar: {row}")
    return row


def phase_serving(report: dict, device, tmp: str, served: dict,
                  data) -> tuple[dict, dict]:
    """Phase 8: the serving plane. Four `console deploy` children start
    together: phase 6's store's `2m` rank-64 instance with batching on,
    with it off, and with max_batch 128 (8a, 8b), and phase 4's store
    with the online plane and the result cache (8d); 8c runs in process
    while they come up. Returns each child's launch counts (by child)
    and the 8d child's."""
    t0 = time.perf_counter()
    fold64 = ["--engine-json", os.path.join(tmp, "engine-fold64.json"),
              "--ip", "127.0.0.1", "--port", "0", "--device", str(device)]
    fold_store = {"PIO_FS_BASEDIR": os.path.join(tmp, "fold")}
    children = {
        "batching_on": (fold64, fold_store),
        "batching_off": (fold64, dict(fold_store, PIO_SERVING_BATCHING="0")),
        "device": (fold64, dict(fold_store, PIO_SERVING_MAX_BATCH="128",
                                PIO_SERVING_MAX_QUEUE="256")),
        "cache": (["--engine-json", served["engine_json"], "--ip",
                   "127.0.0.1", "--port", "0", "--device", str(device)],
                  {"PIO_FS_BASEDIR": served["store_base"], "PIO_ONLINE": "1",
                   "PIO_HTTP_RESULT_CACHE": "1",
                   "PIO_HTTP_RESULT_CACHE_TTL_S": "600"})}
    paths = {name: os.path.join(tmp, f"serving-{name}-launches.json")
             for name in children}
    procs = {name: _start_deploy(args, env, paths[name])
             for name, (args, env) in children.items()}
    try:
        contract = _serving_contract(device, served)
        emit(dict(phase="serving_http", **contract))
        urls = {}
        for name, proc in procs.items():
            line = _read_deployed_line(proc, 300.0)
            urls[name] = f"http://127.0.0.1:{int(line.rsplit(':', 1)[1])}"
        ready_s = time.perf_counter() - t0
        loads = _serving_loads(urls, data)
        cache = _serving_cache(urls["cache"], served,
                               report["online"]["http"]["events_written"])
        emit(dict(phase="serving_cache", **cache))
    finally:
        for proc in procs.values():
            _stop(proc)
    launches = {}
    for name, path in paths.items():
        with open(path) as f:
            launches[name] = json.load(f)["launches"]
    report["serving"] = {
        "loads": loads, "http": contract, "cache": cache,
        "children_ready_s": ready_s, "wall_s": time.perf_counter() - t0,
        "child_launches": {name: {k: v for k, v in counts.items() if v}
                           for name, counts in launches.items()}}
    return launches, launches["cache"]


# -- phase 9 -----------------------------------------------------------------

def _console_out(args: list, base: str, env_extra: dict = None) -> str:
    """The port's console in a child process on the store under `base`
    (and `env_extra`); its standard output. Raises if it failed or its log
    holds a native fallback line."""
    env = dict(os.environ, PYTHONPATH=HERE, PIO_FS_BASEDIR=base,
               **(env_extra or {}))
    proc = subprocess.run(
        [sys.executable, "-m", "predictionio_torch.tools.console"] + args,
        capture_output=True, text=True, cwd=HERE, env=env, timeout=300)
    if proc.returncode != 0:
        raise AssertionError(f"console {args} failed: {proc.stderr[-2000:]}")
    _require_native_log(proc.stderr, f"console {args[0]}")
    return proc.stdout


def _start_eventserver(base: str, env_extra: dict, done_path: str):
    """A `console eventserver --port 0` child on the store under `base`
    through _EVENTSERVER_CHILD, which writes whether it initialised CUDA
    to `done_path` when it exits; PIO_INGEST_* only as `env_extra` sets
    them."""
    env = dict(os.environ, PYTHONPATH=HERE, PIO_FS_BASEDIR=base,
               **env_extra)
    for knob in SERVING_KNOBS:
        if knob not in env_extra:
            env.pop(knob, None)
    return subprocess.Popen(
        [sys.executable, "-c", _EVENTSERVER_CHILD, done_path, "eventserver",
         "--ip", "127.0.0.1", "--port", "0"], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, cwd=HERE, env=env)


def _rate_body(user: str, item: str, rating: float) -> str:
    return json.dumps({"event": "rate", "entityType": "user",
                       "entityId": user, "targetEntityType": "item",
                       "targetEntityId": item,
                       "properties": {"rating": rating}})


def _db_rows(db: str, sql: str, params: tuple) -> list:
    """The rows of one query on the pio.db at `db`, read-only (the
    event servers write it meanwhile)."""
    import sqlite3

    conn = sqlite3.connect(f"file:{db}?mode=ro", uri=True, timeout=60)
    try:
        return conn.execute(sql, params).fetchall()
    finally:
        conn.close()


def _app_rows(db: str, app_id: int) -> set:
    """The ids of the app's rows in the pio.db at `db`, every channel."""
    return {r[0] for r in _db_rows(
        db, "SELECT id FROM events WHERE app_id=?", (app_id,))}


def _ingest_run(url: str, key: str, bodies: list, clients: int) -> tuple:
    """POST /events.json of every body over `clients` keep-alive clients;
    the 201s' event ids and the run's row: events/s, p50 and p99 ms of a
    201, the statuses, and the /metrics deltas of the write plane."""
    import numpy as np

    path = f"/events.json?accessKey={key}"
    before = _scrape(url)
    out, wall = _closed_loop(int(url.rsplit(":", 1)[1]),
                             [("POST", path, b) for b in bodies], clients)
    after = _scrape(url)
    ok = [(json.loads(body)["eventId"], ms)
          for status, body, _, ms in out if status == 201]
    statuses: dict = {}
    for status, _, _, _ in out:
        statuses[status] = statuses.get(status, 0) + 1
    groups = _delta(after, before, "ingest_group_size_count")
    row = {"clients": clients, "events": len(bodies), "wall_s": wall,
           "events_per_s": len(ok) / wall,
           "p50_ms": float(np.percentile([ms for _, ms in ok], 50))
           if ok else None,
           "p99_ms": float(np.percentile([ms for _, ms in ok], 99))
           if ok else None,
           "statuses": statuses,
           "commits": _delta(after, before, "ingest_commits_total"),
           "groups": groups,
           "grouped_events": _delta(after, before, "ingest_group_size_sum"),
           "mean_group": (_delta(after, before, "ingest_group_size_sum")
                          / groups if groups else None),
           "shed": _delta(after, before, "ingest_shed_total")}
    return [eid for eid, _ in ok], out, row


def _read_back(url: str, key: str, ids: list, query: str = "") -> int:
    """GET /events/<id>.json of every id over 16 keep-alive clients; the
    number that answered 200."""
    out, _ = _closed_loop(
        int(url.rsplit(":", 1)[1]),
        [("GET", f"/events/{eid}.json?accessKey={key}{query}", None)
         for eid in ids], 16)
    return sum(1 for status, _, _, _ in out if status == 200)


def _ingest_phase(urls: dict, keys: dict, data, db: str, app_id: int):
    """9a: the closed-loop ingest runs and the batch POST; returns the
    runs' rows and every 201's id."""
    import numpy as np

    rng = np.random.default_rng(14)

    def bodies(n):
        users = rng.integers(0, data.n_users, n)
        items = rng.integers(0, data.n_items, n)
        ratings = rng.integers(1, 11, n) / 2
        return [_rate_body(f"u{u}", f"i{i}", float(r))
                for u, i, r in zip(users, items, ratings)]

    rows_before = _app_rows(db, app_id)
    ids, runs = [], []
    for mode, clients in [("grouping_on", c) for c in INGEST_CLIENTS] + [
            ("grouping_off", INGEST_CLIENTS[-1])]:
        run_ids, _, row = _ingest_run(urls[mode], keys["all"],
                                      bodies(INGEST_EVENTS), clients)
        row["mode"] = mode
        ids += run_ids
        emit(dict(phase="eventserver_ingest", **row))
        runs.append(row)
    req = urllib.request.Request(
        urls["grouping_on"] + f"/batch/events.json?accessKey={keys['all']}",
        data=json.dumps([json.loads(b) for b in bodies(INGEST_BATCH)])
        .encode(), headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=120) as resp:
        results = json.loads(resp.read())
    batch = {"events": INGEST_BATCH,
             "ms": (time.perf_counter() - t0) * 1e3,
             "statuses": sorted({r["status"] for r in results})}
    ids += [r["eventId"] for r in results if r["status"] == 201]
    readable = _read_back(urls["grouping_on"], keys["all"], ids)
    grown = _app_rows(db, app_id) - rows_before
    row = {"runs": runs, "batch": batch, "acknowledged": len(ids),
           "readable": readable, "rows_grown": len(grown),
           "rows_equal_acks": grown == set(ids)}
    if (readable != len(ids) or not row["rows_equal_acks"]
            or batch["statuses"] != [201]
            or any(set(r["statuses"]) != {201} for r in runs)):
        raise AssertionError(f"event-server ingest failed a bar: {row}")
    return row, ids


def _contract_phase(urls: dict, keys: dict, db: str, app_id: int,
                    channel_id: int) -> dict:
    """9b: the answers of the event server's contract, and shedding
    under PIO_INGEST_MAX_QUEUE=1."""
    rows_before = _app_rows(db, app_id)
    url, key = urls["grouping_on"], keys["all"]
    rate = _rate_body("u1", "i1", 4.0)

    def post(path, body, content_type="application/json"):
        req = urllib.request.Request(url + path, data=body.encode(),
                                     headers={"Content-Type": content_type})
        try:
            with urllib.request.urlopen(req, timeout=60) as resp:
                return resp.status, json.loads(resp.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    def get(path):
        try:
            with urllib.request.urlopen(url + path, timeout=60) as resp:
                return resp.status
        except urllib.error.HTTPError as e:
            return e.code

    codes = {
        "bad_key": post("/events.json?accessKey=WRONG", rate)[0],
        "invalid_event": post(
            f"/events.json?accessKey={key}", json.dumps(
                {"event": "$unset", "entityType": "user",
                 "entityId": "u1"}))[0],
        "outside_whitelist": post(
            f"/events.json?accessKey={keys['view']}", rate)[0],
        "unknown_connector": post(
            f"/webhooks/none.json?accessKey={key}", "{}")[0]}
    acked = []
    status, body = post(f"/webhooks/segmentio.json?accessKey={key}",
                        json.dumps({"type": "track", "userId": "u7",
                                    "event": "Signed Up"}))
    codes["segmentio"] = status
    if status == 201:
        acked.append(body["eventId"])
        codes["segmentio_read_back"] = get(
            f"/events/{body['eventId']}.json?accessKey={key}")
    status, body = post(f"/events.json?accessKey={key}&channel=smoke", rate)
    codes["channel"] = status
    if status == 201:
        acked.append(body["eventId"])
        codes["channel_read_back"] = get(
            f"/events/{body['eventId']}.json?accessKey={key}&channel=smoke")
        codes["channel_read_back_default"] = get(
            f"/events/{body['eventId']}.json?accessKey={key}")
    stored_channel = [r[0] for r in _db_rows(
        db, "SELECT channel_id FROM events WHERE id=?", (acked[-1],))]
    shed_ids, out, shed = _ingest_run(
        urls["max_queue_1"], key,
        [_rate_body(f"u{n % 100}", f"i{n % 50}", 3.0)
         for n in range(SHED_EVENTS)], INGEST_CLIENTS[-1])
    acked += shed_ids
    sheds = [retry for status, _, retry, _ in out if status == 429]
    grown = _app_rows(db, app_id) - rows_before
    row = {"codes": codes, "channel_id": channel_id,
           "stored_channel_id": stored_channel, "shed_run": shed,
           "responses_429": len(sheds),
           "retry_after": sorted({r for r in sheds if r is not None}),
           "rows_grown": len(grown), "rows_equal_acks": grown == set(acked)}
    want = {"bad_key": 401, "invalid_event": 400, "outside_whitelist": 400,
            "unknown_connector": 404, "segmentio": 201,
            "segmentio_read_back": 200, "channel": 201,
            "channel_read_back": 200, "channel_read_back_default": 404}
    if (codes != want or stored_channel != [channel_id] or not sheds
            or None in sheds or shed["shed"] != len(sheds)
            or set(shed["statuses"]) != {201, 429}
            or not row["rows_equal_acks"]):
        raise AssertionError(f"the event server's contract failed a bar: "
                             f"{row}")
    return row


def _front_door_phase(es_url: str, key: str, deploy_url: str, data,
                      last_id: str) -> dict:
    """9c: once the deploy child has folded through the newest event of
    9a/9b, ONLINE_ROUNDS rounds as phase 7a's, each event a single POST
    /events.json, each polled on /queries.json until its never-seen user
    is served without what it rated."""
    import numpy as np

    with urllib.request.urlopen(
            f"{es_url}/events/{last_id}.json?accessKey={key}",
            timeout=60) as resp:
        newest = datetime.fromisoformat(
            json.loads(resp.read())["eventTime"].replace("Z", "+00:00"))
    t0 = time.perf_counter()
    while True:
        mark = json.loads(_get(deploy_url + "/"))["online"]["watermark"]
        if mark is not None and datetime.fromisoformat(mark) >= newest:
            break
        if time.perf_counter() - t0 > 180:
            raise AssertionError(f"the deploy child never folded through "
                                 f"{newest} (watermark {mark})")
        time.sleep(0.05)
    catch_up_s = time.perf_counter() - t0
    rng = np.random.default_rng(15)
    path = f"{es_url}/events.json?accessKey={key}"
    rounds, acked = [], 0
    for r in range(ONLINE_ROUNDS):
        new_user = f"es-u{r}"
        rated = [f"i{i}" for i in rng.choice(data.n_items,
                                             ONLINE_NEW_RATINGS,
                                             replace=False)]
        rows = [(new_user, i, 5.0) for i in rated]
        rows += [(f"u{u}", f"i{rng.integers(data.n_items)}",
                  float(rng.integers(1, 11)) / 2)
                 for u in rng.choice(data.n_users, ONLINE_RERATERS,
                                     replace=False)]
        for u, i, rating in rows:
            req = urllib.request.Request(
                path, data=_rate_body(u, i, rating).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as resp:
                if resp.status != 201:
                    raise AssertionError(f"POST answered {resp.status}")
            acked += 1
        committed = time.perf_counter()
        queries, servable_ms = 0, None
        while time.perf_counter() - committed < ONLINE_ROUND_TIMEOUT_S:
            got = [s["item"] for s in _post(
                deploy_url, {"user": new_user, "num": 10})["itemScores"]]
            queries += 1
            if got and not set(got) & set(rated):
                servable_ms = (time.perf_counter() - committed) * 1e3
                break
            time.sleep(0.002)
        rounds.append({"round": r, "servable_ms": servable_ms,
                       "queries": queries})
    servable = [r["servable_ms"] for r in rounds
                if r["servable_ms"] is not None]
    metrics = _metric_totals(_get(deploy_url + "/metrics").decode(), (
        "online_event_to_servable_seconds", "online_foldin_seconds"))
    row = {"catch_up_s": catch_up_s, "rounds": len(rounds),
           "rounds_servable": len(servable), "events_posted": acked,
           "event_to_servable_ms_median": (float(np.median(servable))
                                           if servable else None),
           "event_to_servable_ms_max": max(servable, default=None),
           "event_to_servable_ms": [r["servable_ms"] for r in rounds],
           "queries_until_servable": [r["queries"] for r in rounds],
           "metrics": metrics}
    if len(servable) != ONLINE_ROUNDS:
        raise AssertionError(f"event → servable through the event server "
                             f"failed a bar: {row}")
    return row


def _compute_pids() -> list:
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return [int(p) for p in out.stdout.split() if p.strip().isdigit()]


def phase_eventserver(report: dict, device, tmp: str, data) -> dict:
    """Phase 9: three event-server children (group commit on, off, and
    PIO_INGEST_MAX_QUEUE=1) and a deploy child of the `2m` rank-64
    instance with the online plane, all on phase 6's store; keys and a
    channel made with the console. Returns the deploy child's launch
    counts."""
    t0 = time.perf_counter()
    base = os.path.join(tmp, "fold")
    db = os.path.join(base, "pio.db")
    done = {name: os.path.join(tmp, f"eventserver-{name}.json")
            for name in ("grouping_on", "grouping_off", "max_queue_1")}
    knobs = {"grouping_on": {}, "grouping_off": {"PIO_INGEST_GROUPING": "0"},
             "max_queue_1": {"PIO_INGEST_MAX_QUEUE": "1"}}
    launches_path = os.path.join(tmp, "eventserver-deploy-launches.json")
    procs = {name: _start_eventserver(base, knobs[name], done[name])
             for name in done}
    deploy = _start_deploy(
        ["--engine-json", os.path.join(tmp, "engine-fold64.json"), "--ip",
         "127.0.0.1", "--port", "0", "--device", str(device)],
        {"PIO_FS_BASEDIR": base, "PIO_ONLINE": "1",
         "PIO_HTTP_RESULT_CACHE": "1"}, launches_path)
    # the deploy child comes up (and folds phase 6's backlog) while 9a
    # and 9b run; its output is drained from the start
    pool = concurrent.futures.ThreadPoolExecutor(1)
    deployed = pool.submit(_read_deployed_line, deploy, 300.0)
    try:
        keys = {"all": _console_out(["accesskey", "new", "FoldApp"], base),
                "view": _console_out(["accesskey", "new", "FoldApp",
                                      "--event", "view"], base)}
        keys = {k: v.rsplit(":", 1)[1].strip() for k, v in keys.items()}
        channel = _console_out(["app", "channel-new", "FoldApp", "smoke"],
                               base)
        channel_id = int(re.search(r"\(id=(\d+)\)", channel).group(1))
        listed = _console_out(["accesskey", "list", "FoldApp"], base)
        if f"{keys['view']} events=['view']" not in listed:
            raise AssertionError(f"accesskey list: {listed}")
        urls = {}
        for name, proc in procs.items():
            line = _read_deployed_line(proc, 120.0, marker=" listening on ")
            urls[name] = f"http://127.0.0.1:{int(line.rsplit(':', 1)[1])}"
        ready_s = time.perf_counter() - t0
        [(app_id,)] = _db_rows(db, "SELECT id FROM apps WHERE name=?",
                               ("FoldApp",))
        ingest, ids = _ingest_phase(urls, keys, data, db, app_id)
        emit(dict(phase="eventserver_ingest_bars",
                  **{k: v for k, v in ingest.items() if k != "runs"}))
        contract = _contract_phase(urls, keys, db, app_id, channel_id)
        emit(dict(phase="eventserver_contract", **contract))
        line = deployed.result()
        deploy_url = f"http://127.0.0.1:{int(line.rsplit(':', 1)[1])}"
        deploy_ready_s = time.perf_counter() - t0
        status = json.loads(_get(deploy_url + "/"))
        if "online" not in status or status.get("device") != str(device):
            raise AssertionError(f"the deploy child runs no online plane "
                                 f"on {device}: {status}")
        front = _front_door_phase(urls["grouping_on"], keys["all"],
                                  deploy_url, data, ids[-1])
        emit(dict(phase="eventserver_front_door", **front))
        pids = _compute_pids()
        visible = {"deploy_child_listed": deploy.pid in pids,
                   "eventserver_children_listed": [
                       name for name, p in procs.items() if p.pid in pids]}
    finally:
        for proc in [*procs.values(), deploy]:
            _stop(proc)
        pool.shutdown()
    cuda = {}
    for name, path in done.items():
        with open(path) as f:
            cuda[name] = json.load(f)["cuda_initialized"]
    with open(launches_path) as f:
        child = json.load(f)
    row = {"eventservers_ready_s": ready_s,
           "deploy_ready_s": deploy_ready_s, "compute_apps": visible,
           "eventserver_cuda_initialized": cuda,
           "deploy_child_launches": {k: v for k, v in
                                     child["launches"].items() if v},
           "deploy_child_launches_by_rank": child["by_rank"],
           "wall_s": time.perf_counter() - t0}
    emit(dict(phase="eventserver", **row))
    if visible["eventserver_children_listed"] or any(cuda.values()):
        raise AssertionError(f"an event-server child took the card: {row}")
    report["eventserver"] = {"ingest": ingest, "contract": contract,
                             "front_door": front, **row}
    return child["launches"]


# -- phase 10 ----------------------------------------------------------------

def _scaffolded(name: str, directory: str, app_name: str) -> str:
    """`console template get NAME DIR --app-name APP`, its algorithms set
    to the shipped engine.json's (the app name kept), then `console
    build`; returns the engine.json's path."""
    from predictionio_torch.tools import console

    with contextlib.redirect_stdout(io.StringIO()):
        if console.main(["template", "get", name, directory, "--app-name",
                         app_name]) != 0:
            raise AssertionError(f"console template get {name} failed")
        engine_json = os.path.join(directory, "engine.json")
        with open(engine_json) as f:
            variant = json.load(f)
        with open(os.path.join(HERE, "predictionio_torch", "templates", name,
                               "engine.json")) as f:
            shipped = json.load(f)
        variant["algorithms"] = [
            {"name": a["name"], "params": {
                k: (app_name if k == "appName" else v)
                for k, v in a["params"].items()}}
            for a in shipped["algorithms"]]
        with open(engine_json, "w") as f:
            json.dump(variant, f, indent=2)
        if console.main(["build", "--engine-json", engine_json]) != 0:
            raise AssertionError(f"console build of {name} failed")
    return engine_json


def _store_at(base: str):
    """The port's storage on the sqlite pio.db under `base`."""
    from predictionio_torch.storage.registry import (
        SourceConfig,
        Storage,
        StorageConfig,
    )

    src = SourceConfig(name="PIO", type="sqlite",
                       path=os.path.join(base, "pio.db"))
    return Storage(StorageConfig(metadata=src, modeldata=src, eventdata=src))


def _stamp(t0, seconds: int) -> str:
    """`t0` + `seconds` as an event time."""
    return (t0 + timedelta(seconds=seconds)).strftime("%Y-%m-%dT%H:%M:%S.%fZ")


def _template_events(data, rng) -> tuple:
    """10a's events as JSON-lines dicts: synth_implicit's training pairs
    as `view`s one second apart, a seeded one in BUY_EVERY of them also
    as a `buy`, a `$set` of 1-2 of TEMPLATE_CATEGORIES categories on every
    item, then a `$set` on constraint/unavailableItems naming UNAVAILABLE
    seeded items. Returns (the dicts in file order, the views, the buys,
    each item's categories, the unavailable items)."""
    import numpy as np

    n = len(data.train_u)
    buys = np.sort(rng.choice(n, n // BUY_EVERY, replace=False))
    users = [f"u{u}" for u in range(data.n_users)]
    items = [f"i{i}" for i in range(data.n_items)]
    t0 = datetime(2026, 1, 1, tzinfo=timezone.utc)
    train_u, train_i = data.train_u.tolist(), data.train_i.tolist()

    def pair(name, k, seconds):
        return {"event": name, "entityType": "user",
                "entityId": users[train_u[k]], "targetEntityType": "item",
                "targetEntityId": items[train_i[k]],
                "eventTime": _stamp(t0, seconds)}

    events = [pair("view", k, k) for k in range(n)]
    events += [pair("buy", k, n + j) for j, k in enumerate(buys.tolist())]
    t_props = n + len(buys)
    item_cats = {item: [f"c{c}" for c in rng.choice(
        TEMPLATE_CATEGORIES, int(rng.integers(1, 3)), replace=False)]
        for item in items}
    events += [{"event": "$set", "entityType": "item", "entityId": item,
                "properties": {"categories": cats},
                "eventTime": _stamp(t0, t_props)}
               for item, cats in item_cats.items()]
    unavailable = sorted(items[i] for i in rng.choice(
        np.unique(data.train_i), UNAVAILABLE, replace=False))
    events.append({"event": "$set", "entityType": "constraint",
                   "entityId": "unavailableItems",
                   "properties": {"items": unavailable},
                   "eventTime": _stamp(t0, t_props + 1)})
    return events, n, len(buys), item_cats, unavailable


def _canonical_rows(cols):
    """An unordered scan's columns as raw bits (values and times bitwise),
    rows sorted by those bits."""
    import numpy as np

    table = np.stack([
        cols.entity_ids.astype(np.int64), cols.target_ids.astype(np.int64),
        cols.event_codes.astype(np.int64),
        np.asarray(cols.values, np.float32).view(np.uint32).astype(np.int64),
        np.asarray(cols.times, np.float64).view(np.int64)], axis=1)
    return table[np.lexsort(table.T[::-1])] if len(table) else table


def _read_ab(base: str, app_name: str) -> dict:
    """10a's in-process A/B on the store under `base`: the templates'
    `find_columnar` (ecommerce's: user → item views and buys, unordered)
    and `aggregate_properties` of the items on the native tier, then
    under PIO_NATIVE=0 (the SQL tier); the seconds of each, and whether
    the two returned the same columns bit for bit (BiMaps in order) and
    the same property maps (values with their types, both times)."""
    import numpy as np

    from predictionio_torch import native
    from predictionio_torch.data.store import EventStore

    answered = []
    scan, agg = native.columnar_scan_native, native.agg_props_native

    def spy(real):
        def call(*a, **k):
            out = real(*a, **k)
            answered.append(out is not None)
            return out
        return call

    native.columnar_scan_native = spy(scan)
    native.agg_props_native = spy(agg)
    storage = _store_at(base)
    store = EventStore(storage)
    out = {}
    try:
        for tier in ("native", "sql"):
            if tier == "sql":
                os.environ["PIO_NATIVE"] = "0"
            t0 = time.perf_counter()
            cols = store.find_columnar(
                app_name, entity_type="user", target_entity_type="item",
                event_names=["view", "buy"], ordered=False)
            t1 = time.perf_counter()
            props = store.aggregate_properties(app_name, "item")
            t2 = time.perf_counter()
            out[tier] = (cols, props, t1 - t0, t2 - t1)
    finally:
        os.environ.pop("PIO_NATIVE", None)
        native.columnar_scan_native, native.agg_props_native = scan, agg
        storage.close()
    (nc, nprops, n_scan, n_agg), (sc, sprops, s_scan, s_agg) = \
        out["native"], out["sql"]

    def typed(props):
        return {eid: (json.dumps(p.to_dict(), sort_keys=True),
                      sorted((k, type(v).__name__)
                             for k, v in p.to_dict().items()),
                      p.first_updated, p.last_updated)
                for eid, p in props.items()}

    columns_equal = bool(
        len(nc) == len(sc) and nc.event_names == sc.event_names
        and list(nc.entity_bimap.items()) == list(sc.entity_bimap.items())
        and list(nc.target_bimap.items()) == list(sc.target_bimap.items())
        and np.array_equal(_canonical_rows(nc), _canonical_rows(sc)))
    return {"rows": len(nc), "users": len(nc.entity_bimap),
            "items": len(nc.target_bimap), "entities_folded": len(nprops),
            "native_answered": answered,
            "find_columnar_native_s": n_scan, "find_columnar_sql_s": s_scan,
            "aggregate_native_s": n_agg, "aggregate_sql_s": s_agg,
            "columns_bitwise_equal": columns_equal,
            "properties_equal": typed(nprops) == typed(sprops)}


def write_template_store(base: str, scale: str) -> None:
    """10a, in the writer child: `_template_events(synth_implicit(scale))`
    written as a JSON-lines file under `base`, then `console app new` of
    TEMPLATE_APP and `console import` of the file into a sqlite pio.db
    under `base` (the native importer), the file deleted; `insert_batch`
    (20,000 a chunk) timed on the first INSERT_BATCH_EVENTS of those
    events into a scratch store, deleted after; `_read_ab` on the store.
    Then STORE_RESULT under `base`: the app id, the unavailable items,
    each item's categories and the write's row."""
    import numpy as np

    from predictionio_torch.data.events import Event
    from predictionio_torch.quality.datasets import synth_implicit
    from predictionio_torch.tools import console

    t_start = time.perf_counter()
    data = synth_implicit(scale, seed=0)
    events, n_views, n_buys, item_cats, unavailable = _template_events(
        data, np.random.default_rng(10))
    path = os.path.join(base, "template-events.jsonl")
    t0 = time.perf_counter()
    with open(path, "w") as f:
        for event in events:
            f.write(json.dumps(event) + "\n")
    file_s = time.perf_counter() - t0
    file_bytes = os.path.getsize(path)
    os.environ["PIO_FS_BASEDIR"] = base
    with contextlib.redirect_stdout(io.StringIO()) as said:
        if console.main(["app", "new", TEMPLATE_APP]) != 0:
            raise AssertionError("console app new failed")
        t0 = time.perf_counter()
        if console.main(["import", "--appname", TEMPLATE_APP, "--input",
                         path]) != 0:
            raise AssertionError("console import of the template store "
                                 "failed")
        import_s = time.perf_counter() - t0
    os.unlink(path)
    imported = said.getvalue().strip().splitlines()[-1]
    if imported != f"Imported {len(events)} events.":
        raise AssertionError(f"console import said {imported!r}")
    storage = _store_at(base)
    app_id = storage.meta_apps().get_by_name(TEMPLATE_APP).id
    storage.close()

    # insert_batch on the first INSERT_BATCH_EVENTS, into a scratch store
    scratch = os.path.join(base, "insert-batch")
    os.makedirs(scratch)
    storage = _store_at(scratch)
    from predictionio_torch.storage.base import App

    scratch_app = storage.meta_apps().insert(App(id=0, name=TEMPLATE_APP))
    le = storage.l_events()
    head = [Event.from_dict(e) for e in events[:INSERT_BATCH_EVENTS]]
    n_head = len(head)
    t0 = time.perf_counter()
    for lo in range(0, len(head), 20_000):
        le.insert_batch(head[lo:lo + 20_000], scratch_app)
    insert_batch_s = time.perf_counter() - t0
    storage.close()
    del head
    for name in os.listdir(scratch):
        os.unlink(os.path.join(scratch, name))
    os.rmdir(scratch)
    read_ab = _read_ab(base, TEMPLATE_APP)
    row = {"scale": scale, "views": n_views, "buys": n_buys,
           "items_set": data.n_items, "events": len(events),
           "file_s": file_s, "file_bytes": file_bytes,
           "import_s": import_s, "import_events_per_s": len(events) / import_s,
           "insert_batch_events": n_head, "insert_batch_s": insert_batch_s,
           "insert_batch_events_per_s": n_head / insert_batch_s,
           "read_ab": read_ab, "write_s": time.perf_counter() - t_start}
    with open(os.path.join(base, STORE_RESULT), "w") as f:
        json.dump({"app_id": app_id, "unavailable": unavailable,
                   "item_categories": item_cats, "row": row}, f)


def _start_store_writer(base: str, scale: str = TEMPLATE_SCALE,
                        writer: str = "write_template_store",
                        env_extra: dict = None):
    """A store written by a child process (phase 10's
    `write_template_store`, phase 11's `write_ratings_store`) from the
    start of the run, so that it overlaps the phases before its own; its
    output goes to a log beside the store."""
    os.makedirs(base, exist_ok=True)
    log = open(os.path.join(base, "writer.log"), "w")
    try:
        return subprocess.Popen(
            [sys.executable, "-c", _STORE_CHILD, HERE, base, scale, writer],
            stdout=log, stderr=subprocess.STDOUT, cwd=HERE,
            env=dict(os.environ, PYTHONPATH=HERE, **(env_extra or {})))
    finally:
        log.close()


def _await_store(writer, base: str) -> dict:
    """The writer child's result, once it has exited; raises with its
    log's tail if it failed."""
    rc = writer.wait(timeout=1_200)
    path = os.path.join(base, STORE_RESULT)
    if rc != 0 or not os.path.exists(path):
        with open(os.path.join(base, "writer.log")) as f:
            tail = f.read()[-3000:]
        raise AssertionError(f"the template store's writer exited {rc}:\n"
                             f"{tail}")
    with open(os.path.join(base, "writer.log")) as f:
        _require_native_log(f.read(), "the template store's writer")
    with open(path) as f:
        written = json.load(f)
    ab = written["row"]["read_ab"]
    if not (ab["columns_bitwise_equal"] and ab["properties_equal"]
            and ab["native_answered"] == [True, True, False, False]):
        raise AssertionError(f"the native and SQL reads of the template "
                             f"store differ: {ab}")
    return written


_LOG_TIME = re.compile(r"^(\d{4}-\d\d-\d\d \d\d:\d\d:\d\d,\d{3}) ")
# the console train's log lines that open and close its stages
_TRAIN_MARKS = {"read_start": "Engine.train: reading training data",
                "read_end": " DataSource: ",
                "train_start": "Engine.train: training algorithm",
                "persisted": " byte blob"}


def _stage_seconds(stderr: str) -> dict:
    """A console train's data-read, prepare and train (the model's
    persisting included) seconds, from its log's ms timestamps."""
    at = {}
    for line in stderr.splitlines():
        m = _LOG_TIME.match(line)
        for key, marker in _TRAIN_MARKS.items():
            if m and key not in at and marker in line:
                at[key] = datetime.strptime(
                    m.group(1), "%Y-%m-%d %H:%M:%S,%f").timestamp()
    if len(at) != len(_TRAIN_MARKS):
        raise AssertionError(f"console train logged no stage times: {at}")
    return {"read_s": at["read_end"] - at["read_start"],
            "prepare_s": at["train_start"] - at["read_end"],
            "train_s": at["persisted"] - at["train_start"]}


def _completed_instance(base: str, engine_json: str) -> str:
    """The id of the latest completed instance of `engine_json`'s engine
    in the store under `base`; raises if there is none."""
    from predictionio_torch.workflow.workflow_utils import read_engine_json

    variant = read_engine_json(engine_json)
    storage = _store_at(base)
    try:
        instance = storage.meta_engine_instances().get_latest_completed(
            variant.id, "1", variant.variant)
    finally:
        storage.close()
    if instance is None:
        raise AssertionError(f"console train left no completed instance of "
                             f"{variant.id} under {base}")
    return instance.id


def _latest_models(storage, engine_json: str) -> tuple:
    """(engine, engine params, models, components) of the latest completed
    instance of `engine_json`'s engine in `storage`, loaded as the
    deployed server loads them."""
    from predictionio_torch.workflow.workflow_utils import (
        extract_engine_params,
        get_engine,
        read_engine_json,
    )

    variant = read_engine_json(engine_json)
    engine = get_engine(variant.engine_factory)
    ep = extract_engine_params(engine, variant)
    instance = storage.meta_engine_instances().get_latest_completed(
        variant.id, "1", variant.variant)
    if instance is None or instance.status != "COMPLETED":
        raise AssertionError(f"no completed instance of {variant.id}")
    models = engine.deserialize_models(
        storage.model_data_models().get(instance.id).models)
    return engine, ep, models, engine.components(ep)


def _latest_model(storage, engine_json: str):
    """A function answering one query with the latest completed instance
    of `engine_json`'s engine in `storage`, as the deployed server does."""
    engine, ep, models, components = _latest_models(storage, engine_json)
    return lambda q: engine.predict(ep, models, q, components=components)


def _als_config(engine_json: str):
    """The implicit ALSConfig of `engine_json`'s first algorithm, as the
    similarproduct and ecommerce templates build it."""
    from predictionio_torch.ops.als import ALSConfig
    from predictionio_torch.workflow.workflow_utils import (
        extract_engine_params,
        get_engine,
        read_engine_json,
    )

    variant = read_engine_json(engine_json)
    ep = extract_engine_params(get_engine(variant.engine_factory), variant)
    p = ep.algorithm_params_list[0][1]
    return ALSConfig(rank=p.rank, iterations=p.numIterations, reg=p.lambda_,
                     implicit=True, alpha=p.alpha, seed=p.seed)


def _trajectories(prepared: str, cfg, device) -> dict:
    """10b in process, on the PreparedData a console train ran on (saved
    by _TRAIN_CHILD at `prepared`): the train under `auto` (epoch ms), and
    its RMSE trajectory under `auto` and `solver="chol"`, held within
    RMSE_RTOL of each other at every epoch."""
    import numpy as np

    from predictionio_torch.ops.als import als_train

    pd = np.load(prepared)
    runs = {}
    for key, solver, rmse in (("auto", "auto", False),
                              ("auto_rmse", "auto", True),
                              ("chol", "chol", True)):
        t0 = time.perf_counter()
        res = als_train(pd["user_idx"], pd["item_idx"], pd["values"],
                        int(pd["n_users"]), int(pd["n_items"]),
                        dataclasses.replace(cfg, solver=solver),
                        device=device, compute_rmse=rmse)
        runs[key] = (res, time.perf_counter() - t0)
    auto = runs["auto_rmse"][0].rmse_history
    chol = runs["chol"][0].rmse_history
    row = {"pairs": int(len(pd["user_idx"])), "users": int(pd["n_users"]),
           "items": int(pd["n_items"]), "rank": cfg.rank,
           "iterations": cfg.iterations,
           "epoch_ms": [t * 1e3 for t in runs["auto"][0].epoch_times],
           "call_s": runs["auto"][1], "rmse_auto": auto, "rmse_chol": chol,
           "rmse_max_rel": max((abs(x - y) / abs(y)
                                for x, y in zip(auto, chol)), default=None)}
    if (len(auto) != cfg.iterations or len(chol) != cfg.iterations
            or row["rmse_max_rel"] > RMSE_RTOL):
        raise AssertionError(f"the auto trajectory is not chol's: {row}")
    return row


def _seen_by_user(data) -> dict:
    """User id → the items it viewed (each buy is of a viewed pair)."""
    import numpy as np

    order = np.argsort(data.train_u, kind="stable")
    u, i = data.train_u[order], data.train_i[order]
    cuts = np.searchsorted(u, np.arange(data.n_users + 1))
    return {f"u{k}": {f"i{x}" for x in i[cuts[k]:cuts[k + 1]].tolist()}
            for k in range(data.n_users) if cuts[k + 1] > cuts[k]}


def _serve_similar(url: str, data, predict, item_cats: dict) -> dict:
    """10c, similarproduct: TEMPLATE_QUERIES seeded one-item queries from
    each client count of TEMPLATE_CLIENTS, every answer byte for byte the
    in-process answer of the instance's model; one query each with
    `categories`, `whiteList` and `blackList` obeys its filter."""
    import numpy as np

    from predictionio_torch.utils import fastjson

    rng = np.random.default_rng(11)
    queries = [{"items": [f"i{int(i)}"], "num": 10}
               for i in rng.choice(np.unique(data.train_i), TEMPLATE_QUERIES)]
    want = [fastjson.dumps_bytes(predict(q)) for q in queries]
    runs = []
    for clients in TEMPLATE_CLIENTS:
        bodies, row = _load(url, queries, clients)
        row.update(byte_identical=bodies == want,
                   answered=sum(len(json.loads(b)["itemScores"]) == 10
                                for b in bodies))
        runs.append(row)
    anchor = queries[0]["items"]
    some = sorted(item_cats)[:40]
    filters = {
        "categories": ({"items": anchor, "num": 10, "categories": ["c1"]},
                       lambda item: "c1" in item_cats[item]),
        "whiteList": ({"items": anchor, "num": 10, "whiteList": some},
                      lambda item: item in some),
        "blackList": ({"items": anchor, "num": 10, "blackList": some},
                      lambda item: item not in some)}
    checked = {}
    for name, (q, ok) in filters.items():
        got = [s["item"] for s in _post(url, q)["itemScores"]]
        checked[name] = {"query": q, "items": got,
                         "categories": [item_cats.get(i) for i in got],
                         "obeyed": bool(got) and all(ok(i) for i in got)}
    out = {"runs": runs, "filters": checked}
    if (not all(r["byte_identical"] and r["answered"] == TEMPLATE_QUERIES
                for r in runs)
            or not all(c["obeyed"] for c in checked.values())):
        raise AssertionError(f"similarproduct serving failed a bar: {out}")
    return out


def _serve_ecommerce(url: str, data, storage, app_id: int,
                     unavailable: list) -> dict:
    """10c, ecommerce: TEMPLATE_QUERIES seeded user queries from each
    client count, no answer holding an item its user viewed or bought or
    an unavailable one; a never-seen user with three views written now
    answered through the cold-start path, without them; a new `$set` on
    unavailableItems obeyed within CONSTRAINT_TIMEOUT_S."""
    import numpy as np

    from predictionio_torch.data.datamap import DataMap
    from predictionio_torch.data.events import Event

    rng = np.random.default_rng(12)
    queries = [{"user": f"u{int(u)}", "num": 10}
               for u in rng.choice(np.unique(data.train_u),
                                   TEMPLATE_QUERIES)]
    seen = _seen_by_user(data)
    banned = set(unavailable)
    runs = []
    for clients in TEMPLATE_CLIENTS:
        bodies, row = _load(url, queries, clients)
        answered = leaked = 0
        for q, body in zip(queries, bodies):
            got = {s["item"] for s in json.loads(body)["itemScores"]}
            answered += bool(got)
            leaked += len(got & (seen[q["user"]] | banned))
        row.update(answered=answered, leaked_items=leaked)
        runs.append(row)
    now = datetime.now(timezone.utc)
    viewed = [f"i{int(i)}" for i in rng.choice(np.unique(data.train_i), 3,
                                                replace=False)]
    storage.l_events().insert_batch([
        Event(event="view", entity_type="user", entity_id="cold-user",
              target_entity_type="item", target_entity_id=item,
              event_time=now + timedelta(milliseconds=k))
        for k, item in enumerate(viewed)], app_id)
    cold = [s["item"] for s in _post(url, {"user": "cold-user",
                                           "num": 10})["itemScores"]]
    # the newest $set is the constraint: the top items of one user's
    # answer become unavailable (and the first twenty available again)
    probe = queries[1]
    top = [s["item"] for s in _post(url, probe)["itemScores"]][:3]
    storage.l_events().insert(Event(
        event="$set", entity_type="constraint", entity_id="unavailableItems",
        properties=DataMap({"items": top}),
        event_time=datetime.now(timezone.utc)), app_id)
    t0 = time.perf_counter()
    obeyed_s = None
    while time.perf_counter() - t0 < CONSTRAINT_TIMEOUT_S:
        got = [s["item"] for s in _post(url, probe)["itemScores"]]
        if got and not set(got) & set(top):
            obeyed_s = time.perf_counter() - t0
            break
        time.sleep(0.1)
    out = {"runs": runs, "cold_start_items": cold, "cold_viewed": viewed,
           "constraint_items": top, "constraint_obeyed_s": obeyed_s}
    if (any(r["leaked_items"] or r["answered"] < TEMPLATE_QUERIES // 2
            for r in runs) or not cold or set(cold) & set(viewed)
            or len(top) < 3 or obeyed_s is None):
        raise AssertionError(f"ecommerce serving failed a bar: {out}")
    return out


def _serve_ranking(url: str, served: dict, predict) -> dict:
    """10c, productranking: RANKING_QUERIES seeded queries of
    RANKING_CANDIDATES candidates (one in ten from a never-seen user)
    from each client count: every answer byte for byte the in-process
    one, a known user's scores descending over exactly its candidates, a
    never-seen user's candidates in their order with `isOriginal: true`."""
    import numpy as np

    from predictionio_torch.utils import fastjson

    rng = np.random.default_rng(13)
    users, items = served["users"], served["items"]
    queries = []
    for k in range(RANKING_QUERIES):
        user = (f"ghost-{k}" if k % 10 == 0
                else users[int(rng.integers(len(users)))])
        queries.append({"user": user, "items": [
            items[int(i)] for i in rng.choice(len(items), RANKING_CANDIDATES,
                                              replace=False)]})
    want = [fastjson.dumps_bytes(predict(q)) for q in queries]
    runs = []
    for clients in TEMPLATE_CLIENTS:
        bodies, row = _load(url, queries, clients)
        bad = 0
        for q, body in zip(queries, bodies):
            got = json.loads(body)
            order = [s["item"] for s in got["itemScores"]]
            scores = [s["score"] for s in got["itemScores"]]
            if q["user"].startswith("ghost-"):
                bad += not (got["isOriginal"] and order == q["items"])
            else:
                bad += (got["isOriginal"]
                        or sorted(order) != sorted(q["items"])
                        or scores != sorted(scores, reverse=True))
        row.update(byte_identical=bodies == want, bad_answers=bad)
        runs.append(row)
    if not all(r["byte_identical"] and not r["bad_answers"] for r in runs):
        raise AssertionError(f"productranking serving failed a bar: {runs}")
    return {"runs": runs}


_EVENT_COLUMNS = ("event, entity_type, entity_id, target_entity_type, "
                  "target_entity_id, properties, event_time, tags, pr_id")


def _app_events(db: str, app_name: str) -> list:
    """The rows of app `app_name` in the pio.db at `db`, without what a
    store gives each event anew (its id and creation time), sorted."""
    (app_id,), = _db_rows(db, "SELECT id FROM apps WHERE name=?",
                          (app_name,))
    return sorted(_db_rows(db, f"SELECT {_EVENT_COLUMNS} FROM events "
                               f"WHERE app_id=?", (app_id,)))


def _import_views(base: str, tmp: str, app_name: str, data) -> dict:
    """10d's data: `console app new` and `console import` of `data`'s
    training pairs as view events (JSON lines, one second apart) into the
    store under `base`, in child processes (the native importer). The
    same file imported under PIO_NATIVE=0 (the Python path) into a
    scratch store at the same time: the rows equal apart from event ids
    and creation times. `console export` of the app under both tiers,
    together: byte for byte."""
    path = os.path.join(tmp, f"{app_name}.jsonl")
    t_first = datetime(2026, 1, 1, tzinfo=timezone.utc)
    with open(path, "w") as f:
        for k, (u, i) in enumerate(zip(data.train_u.tolist(),
                                       data.train_i.tolist())):
            f.write(json.dumps({
                "event": "view", "entityType": "user", "entityId": f"u{u}",
                "targetEntityType": "item", "targetEntityId": f"i{i}",
                "eventTime": (t_first + timedelta(seconds=k)).strftime(
                    "%Y-%m-%dT%H:%M:%S.%fZ")}) + "\n")
    python = {"PIO_NATIVE": "0"}
    python_base = os.path.join(tmp, f"{app_name}-python")
    os.makedirs(python_base)
    seconds = {}

    def imported(tier, where, env):
        t0 = time.perf_counter()
        _console_out(["app", "new", app_name], where, env)
        out = _console_out(["import", "--appname", app_name, "--input",
                            path], where, env)
        seconds[f"import_{tier}_s"] = time.perf_counter() - t0
        if out.strip() != f"Imported {len(data.train_u)} events.":
            raise AssertionError(f"console import ({tier}) said {out!r}")

    def exported(tier, env):
        out_path = os.path.join(tmp, f"{app_name}-export-{tier}.jsonl")
        t0 = time.perf_counter()
        _console_out(["export", "--appname", app_name, "--output",
                      out_path], base, env)
        seconds[f"export_{tier}_s"] = time.perf_counter() - t0
        with open(out_path, "rb") as f:
            body = f.read()
        os.unlink(out_path)
        return body

    # the two tiers' imports (into two stores) run together, then the two
    # exports of one store, each pair in its own children
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        for fut in [pool.submit(imported, "native", base, None),
                    pool.submit(imported, "python", python_base, python)]:
            fut.result()
        rows_equal = (_app_events(os.path.join(base, "pio.db"), app_name)
                      == _app_events(os.path.join(python_base, "pio.db"),
                                     app_name))
        exported = dict(zip(("native", "python"), [
            fut.result() for fut in [pool.submit(exported, "native", None),
                                     pool.submit(exported, "python",
                                                 python)]]))
    row = {"events": int(len(data.train_u)),
           "import_s": seconds["import_native_s"], **seconds,
           "rows_equal_to_python_import": rows_equal,
           "export_bytes": len(exported["native"]),
           "export_byte_identical": exported["native"] == exported["python"]}
    if not (rows_equal and row["export_byte_identical"]
            and exported["native"].count(b"\n") == row["events"]):
        raise AssertionError(f"the native import or export of "
                             f"{app_name} differs from the Python path's: "
                             f"{row}")
    return row


def _template_list() -> list:
    """10d: the names `console template list` prints."""
    from predictionio_torch.tools import console

    listing = io.StringIO()
    with contextlib.redirect_stdout(listing):
        if console.main(["template", "list"]) != 0:
            raise AssertionError("console template list failed")
    return [line.split()[0] for line in listing.getvalue().splitlines()
            if line.strip()]


def _template_eval(tmp: str, device, pio_base: str, imported) -> tuple:
    """10d: once `imported` (the future of `_import_views`) is done,
    `console eval` of SimilarProductEvaluation on TEMPLATE_EVAL_APP
    (3 folds) in a child: its cells' MAP@10, the best cell, the grid
    trains (one a fold, four cells each), a completed evaluation instance
    in the store. Returns (the row, the child's log, its launch record)."""
    imported = imported.result()
    out = os.path.join(tmp, "eval-similarproduct.json")
    stderr, child, seconds = _console_child(
        ["eval", TEMPLATE_EVAL_CLASS, "--out", out, "--device", str(device)],
        env_extra={"PIO_FS_BASEDIR": pio_base,
                   "PIO_EVAL_APP_NAME": TEMPLATE_EVAL_APP, "PIO_EVAL_K": "3"})
    with open(out) as f:
        record = json.load(f)
    result = json.loads(record["evaluator_results_json"])
    cells = [r["engineParams"] for r in result["results"]]
    stored = _db_rows(os.path.join(pio_base, "pio.db"),
                      "SELECT status FROM evaluation_instances WHERE id=?",
                      (record["id"],))
    row = {"wall_s": seconds, "status": record["status"],
           "stored_status": [s for (s,) in stored],
           "map_at_10": [r["scores"]["MAP@10"] for r in result["results"]],
           "cells": [{k: v for k, v in c["algorithms"][0]["params"].items()
                      if k in ("rank", "numIterations", "lambda", "lambda_")}
                     for c in cells],
           "best": cells.index(result["bestEngineParams"]),
           "grid_trains": len(child["grids"]), "grids": child["grids"],
           "launches": {k: v for k, v in child["launches"].items() if v},
           "launches_by_rank": child["by_rank"], "import": imported}
    if (record["status"] != "EVALCOMPLETED"
            or row["stored_status"] != ["EVALCOMPLETED"]
            or len(cells) != 4 or len(child["grids"]) != 3
            or any(g["cells"] != 4 for g in child["grids"])):
        raise AssertionError(f"the similar-product evaluation failed a bar: "
                             f"{row}")
    return row, stderr, child


def phase_templates(report: dict, device, tmp: str, served: dict,
                    writer, shop: str) -> dict:
    """Phase 10: the similarproduct, ecommerce and productranking
    templates scaffolded with the console, trained from the store on the
    card and served by `console deploy` children, and
    `SimilarProductEvaluation` through `console eval`. `writer` is the
    child writing the store under `shop` (`_start_store_writer`). The
    console trains and the evaluation run together; the servers are
    measured alone. Returns
    each console child's launch record (the three trains, the three
    deploys, the eval)."""
    from predictionio_torch.quality.datasets import synth_implicit

    t_all = time.perf_counter()
    pio_base = served["store_base"]
    engines = {"similarproduct": (os.path.join(tmp, "SimilarProduct"),
                                  TEMPLATE_APP, shop),
               "ecommerce": (os.path.join(tmp, "ECommerce"), TEMPLATE_APP,
                             shop),
               "productranking": (os.path.join(tmp, "ProductRanking"),
                                  "MyApp1", pio_base)}
    launch_paths = {name: os.path.join(tmp, f"templates-{name}.json")
                    for name in engines}
    pool = concurrent.futures.ThreadPoolExecutor(8)
    storage = None
    deploys = {}
    try:
        # 10d's import into phase 4's store, then its eval, from now on
        imported = pool.submit(_import_views, pio_base, tmp,
                               TEMPLATE_EVAL_APP, synth_implicit("100k"))
        evaluated = pool.submit(_template_eval, tmp, device, pio_base,
                                imported)
        t0 = time.perf_counter()
        written = _await_store(writer, shop)
        store = dict(written["row"], waited_s=time.perf_counter() - t0)
        # `console status` in a child: the native tier built, not loaded
        status = [line for line in _console_out(["status"], shop)
                  .splitlines() if line.startswith("Native fast paths")]
        if status != [f"{NATIVE_STATUS} available (cached build)"]:
            raise AssertionError(f"console status said {status}")
        print(status[0], flush=True)
        store["console_status"] = status[0]
        emit(dict(phase="templates_store", **store))
        app_id = written["app_id"]
        item_cats = written["item_categories"]
        data = synth_implicit(store["scale"], seed=0)
        storage = _store_at(shop)

        # 10b: scaffold, build and `console train` each template in a
        # child, all together
        jsons = {name: _scaffolded(name, directory, app)
                 for name, (directory, app, _) in engines.items()}
        prepared = {name: os.path.join(tmp, f"prepared-{name}.npz")
                    for name in ("similarproduct", "ecommerce")}
        trains = {name: pool.submit(
            _console_child, ["train", "--engine-json", jsons[name],
                             "--device", str(device)],
            env_extra={"PIO_FS_BASEDIR": store_base},
            prepared=prepared.get(name))
            for name, (_, _, store_base) in engines.items()}
        train_rows, children = {}, {}
        for name, fut in trains.items():
            stderr, child, seconds = fut.result()
            children[f"train_{name}"] = child
            train_rows[name] = dict(
                template=name, wall_s=seconds, **_stage_seconds(stderr),
                instance=_completed_instance(engines[name][2], jsons[name]),
                launches={k: v for k, v in child["launches"].items() if v},
                launches_by_rank=child["by_rank"])
            report.setdefault("templates_log", {})[name] = \
                stderr.splitlines()[-40:]

        # 10c: the three servers come up while the in-process auto and
        # chol trains run
        t_deploy = time.perf_counter()
        deploys = {name: _start_deploy(
            ["--engine-json", jsons[name], "--ip", "127.0.0.1", "--port",
             "0", "--device", str(device)], {"PIO_FS_BASEDIR": store_base},
            launch_paths[name])
            for name, (_, _, store_base) in engines.items()}
        for name, path in prepared.items():
            train_rows[name]["in_process"] = _trajectories(
                path, _als_config(jsons[name]), device)
        for row in train_rows.values():
            emit(dict(phase="templates_train", **row))
        urls = {}
        for name, proc in deploys.items():
            line = _read_deployed_line(proc, 300.0)
            urls[name] = f"http://127.0.0.1:{int(line.rsplit(':', 1)[1])}"
        ready_s = time.perf_counter() - t_deploy
        # the servers are measured once the evaluation is done
        evaluation, eval_log, children["eval"] = evaluated.result()
        similar = _serve_similar(
            urls["similarproduct"], data,
            _latest_model(storage, jsons["similarproduct"]), item_cats)
        ecomm = _serve_ecommerce(urls["ecommerce"], data, storage, app_id,
                                 written["unavailable"])
        rank_storage = _store_at(pio_base)
        try:
            ranked = _latest_model(rank_storage, jsons["productranking"])
        finally:
            rank_storage.close()
        ranking = _serve_ranking(urls["productranking"], served, ranked)
        for name, out in (("similarproduct", similar), ("ecommerce", ecomm),
                          ("productranking", ranking)):
            for row in out["runs"]:
                emit(dict(phase="templates_serve", template=name, **row))
        emit(dict(phase="templates_serve_bars", ready_s=ready_s,
                  filters=similar["filters"],
                  **{k: v for k, v in ecomm.items() if k != "runs"}))
    finally:
        for proc in deploys.values():
            _stop(proc)
        if storage is not None:
            storage.close()
        pool.shutdown(wait=True)
    for name, path in launch_paths.items():
        with open(path) as f:
            children[f"deploy_{name}"] = json.load(f)
    evaluation["templates_listed"] = _template_list()
    emit(dict(phase="templates_eval", **evaluation))
    report.setdefault("templates_log", {})["eval"] = \
        eval_log.splitlines()[-40:]
    if sorted(evaluation["templates_listed"]) != sorted(
            TEMPLATE_NAMES + CLASSIFY_TEMPLATE_NAMES
            + ("textclassification", "complementarypurchase",
               "sessionrec")):
        raise AssertionError(f"console template list printed "
                             f"{evaluation['templates_listed']}")
    wall = time.perf_counter() - t_all
    emit({"phase": "templates", "wall_s": wall})
    report["templates"] = {"store": store, "train": train_rows,
                           "serve": {"ready_s": ready_s,
                                     "similarproduct": similar,
                                     "ecommerce": ecomm,
                                     "productranking": ranking},
                           "eval": evaluation, "wall_s": wall}
    return children


# -- phase 11 ----------------------------------------------------------------

def write_ratings_store(base: str, scale: str) -> None:
    """11, in a writer child started with the run: synth_explicit(scale)'s
    training ratings as `rate` events of RUNTIME_APP (`_write_events`),
    `console import`ed (the native importer) into a sqlite pio.db under
    `base`, the file deleted; then RATINGS_RESULT under `base`."""
    from predictionio_torch.quality.datasets import synth_explicit
    from predictionio_torch.tools import console

    t_start = time.perf_counter()
    data = synth_explicit(scale)
    path = os.path.join(base, "ratings.jsonl")
    _write_events(path, data)
    file_s = time.perf_counter() - t_start
    os.environ["PIO_FS_BASEDIR"] = base
    with contextlib.redirect_stdout(io.StringIO()) as said:
        if console.main(["app", "new", RUNTIME_APP]) != 0:
            raise AssertionError("console app new failed")
        t0 = time.perf_counter()
        if console.main(["import", "--appname", RUNTIME_APP, "--input",
                         path]) != 0:
            raise AssertionError("console import of the ratings failed")
        import_s = time.perf_counter() - t0
    os.unlink(path)
    imported = said.getvalue().strip().splitlines()[-1]
    if imported != f"Imported {len(data.train_r)} events.":
        raise AssertionError(f"console import said {imported!r}")
    with open(os.path.join(base, RATINGS_RESULT), "w") as f:
        json.dump({"scale": scale, "events": int(len(data.train_r)),
                   "file_s": file_s, "import_s": import_s,
                   "write_s": time.perf_counter() - t_start}, f)


def _await_ratings(writer, base: str, result: str = RATINGS_RESULT,
                   who: str = "the ratings store's writer") -> dict:
    """The writer's result (`result` under `base`) once it has exited;
    raises with its log's tail if it failed or fell back from the native
    tier."""
    rc = writer.wait(timeout=1_200)
    path = os.path.join(base, result)
    with open(os.path.join(base, "writer.log")) as f:
        log = f.read()
    if rc != 0 or not os.path.exists(path):
        raise AssertionError(f"{who} exited {rc}:\n{log[-3000:]}")
    _require_native_log(log, who)
    with open(path) as f:
        return json.load(f)


def __getattr__(name):
    """`HoldoutEvaluation` and `TextEvaluation`, which `console eval
    chip_smoke.HoldoutEvaluation` (and `.TextEvaluation`) name: built on
    first use, since they subclass the port's classes and this module
    imports the port only inside functions."""
    factories = {"HoldoutEvaluation": _holdout_evaluation,
                 "TextEvaluation": _text_evaluation}
    if name in factories:
        globals()[name] = cls = factories[name]()
        return cls
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def _holdout_evaluation():
    """An evaluation of the Recommendation template on one fold: every
    training event of RUNTIME_APP, queried for the held-out items of
    $CHIP_SMOKE_HOLDOUT ([[user, [items]], ...]); a grid of rank 64 × λ
    {0.01, 0.1} at RUNTIME_ITERATIONS epochs, MAP@10. Its fold trains on
    exactly what `console train` trains on, so its grid's bucketing is
    that train's bucket-cache entry."""
    from predictionio_torch.controller import MAPatK
    from predictionio_torch.controller.engine import Engine, EngineParams
    from predictionio_torch.controller.evaluation import (
        EngineParamsGenerator,
        Evaluation,
    )
    from predictionio_torch.templates.recommendation import engine as rec

    class HoldoutDataSource(rec.DataSource):
        def read_eval(self, ctx):
            with open(os.environ["CHIP_SMOKE_HOLDOUT"]) as f:
                held = json.load(f)
            return [(self._read_events(ctx),
                     [({"user": u, "num": 10}, {"items": items})
                      for u, items in held])]

    class HoldoutEvaluation(Evaluation, EngineParamsGenerator):
        def __init__(self):
            self.engine = Engine(HoldoutDataSource, rec.Preparator,
                                 {"als": rec.ALSAlgorithm})
            self.metric = MAPatK(10)
            self.engine_params_list = [EngineParams(
                data_source_params=rec.DataSourceParams(appName=RUNTIME_APP),
                algorithm_params_list=[("als", rec.ALSAlgorithmParams(
                    rank=64, numIterations=RUNTIME_ITERATIONS, lambda_=lam,
                    seed=3))]) for lam in (0.01, 0.1)]

    return HoldoutEvaluation


class _Lines(logging.Handler):
    """Keeps what one logger logs (INFO and above) while installed."""

    def __init__(self, name: str):
        super().__init__(logging.INFO)
        self.lines: list = []
        self._logger = logging.getLogger(name)

    def __enter__(self):
        self._old_level = self._logger.level
        self._logger.setLevel(logging.INFO)
        self._logger.addHandler(self)
        return self

    def __exit__(self, *exc):
        self._logger.removeHandler(self)
        self._logger.setLevel(self._old_level)

    def emit(self, record) -> None:
        self.lines.append(record.getMessage())


def _same_buckets(got, want) -> bool:
    """Two `bucketize_cached` results (both sides' buckets and split rows)
    bitwise equal, dtypes included."""
    import numpy as np

    def same(a, b):
        return (a is None) == (b is None) and (
            a is None or (a.dtype == b.dtype and np.array_equal(a, b)))

    return all(
        same(sa, sb) and len(ba) == len(bb) and all(
            same(getattr(x, f), getattr(y, f))
            for x, y in zip(ba, bb)
            for f in ("rows", "cols", "vals", "mask", "segmap"))
        for ba, sa, bb, sb in ((got[0], got[1], want[0], want[1]),
                               (got[2], got[3], want[2], want[3])))


def _runtime_cache(data, device, tmp: str) -> dict:
    """11a: `als_train` at rank 64 and 128 (auto) with a fresh
    `bucket_cache_dir`, a miss then a hit: set-up seconds (call wall − Σ
    epochs) of each, the entry's bytes; the hit's factors bitwise the
    miss's, its buckets bitwise the native bucketizer's."""
    import numpy as np

    from predictionio_torch.ops import als
    from predictionio_torch.ops.als import ALSConfig, als_train

    rows = {}
    for rank in (64, 128):
        cache = os.path.join(tmp, f"cache{rank}")
        cfg = ALSConfig(rank=rank, iterations=ITERATIONS, reg=0.01, seed=0)
        runs = {}
        for kind in ("miss", "hit"):
            with _Lines("predictionio_torch.ops.als") as lines:
                t0 = time.perf_counter()
                res = als_train(data.train_u, data.train_i, data.train_r,
                                data.n_users, data.n_items, cfg,
                                device=device, bucket_cache_dir=cache)
                wall = time.perf_counter() - t0
            if not any(f"bucket cache {kind}" in m for m in lines.lines):
                raise AssertionError(f"11a rank {rank}: no bucket cache "
                                     f"{kind} logged: {lines.lines}")
            runs[kind] = (res, wall)
        (entry,) = os.listdir(cache)
        split_cap = cfg.split_cap if cfg.split_cap > 0 else None
        args = (data.train_u, data.train_i, data.train_r, data.n_users,
                data.n_items, 8, split_cap, cfg.cap_growth)
        hit_arrays = als.bucketize_cached(*args, cache)
        native = als.bucketize_cached(*args, None)
        (miss, miss_wall), (hit, hit_wall) = runs["miss"], runs["hit"]
        row = {"rank": rank, "entry_bytes": os.path.getsize(
                   os.path.join(cache, entry)),
               "setup_s_miss": miss_wall - sum(miss.epoch_times),
               "setup_s_hit": hit_wall - sum(hit.epoch_times),
               "wall_s_miss": miss_wall, "wall_s_hit": hit_wall,
               "factors_bitwise_equal": bool(
                   np.array_equal(miss.user_factors, hit.user_factors)
                   and np.array_equal(miss.item_factors, hit.item_factors)),
               "buckets_bitwise_native": _same_buckets(hit_arrays, native)}
        if not (row["factors_bitwise_equal"]
                and row["buckets_bitwise_native"]):
            raise AssertionError(f"11a: the bucket cache's hit differs: "
                                 f"{row}")
        rows[rank] = row
    emit({"phase": "runtime", "part": "a_bucket_cache", "ranks": rows})
    return rows


def _start_child(args: list, base: str, env_extra: dict = None):
    """The console (`_CONSOLE_CHILD`) in a child process on the store
    under `base`, PIO_FAULTS unset unless `env_extra` sets it."""
    env = dict(os.environ, PYTHONPATH=HERE, PIO_FS_BASEDIR=base)
    env.pop("PIO_FAULTS", None)
    env.update(env_extra or {})
    return subprocess.Popen([sys.executable, "-c", _CONSOLE_CHILD, *args],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, cwd=HERE, env=env)


def _finish(proc, who: str, want_rc: int = 0, timeout_s: float = 900.0,
            phase: str = "11"):
    """(stdout, stderr, launch record or None) once `proc` (a child of
    `phase`) exits with `want_rc`; raises otherwise, or on a native
    fallback line."""
    out, err = proc.communicate(timeout=timeout_s)
    if proc.returncode != want_rc:
        raise AssertionError(f"{phase} {who} exited {proc.returncode}, want "
                             f"{want_rc}:\n{err[-4000:]}")
    _require_native_log(err, f"{phase} {who}")
    record = (json.loads(out.strip().splitlines()[-1]) if want_rc == 0
              else None)
    return out, err, record


def _cache_keys(log: str, kind: str) -> set:
    """The bucket-cache keys a log names after "bucket cache <kind>"."""
    return set(re.findall(rf"bucket cache {kind}(?: — saved)? ([0-9a-f]+)",
                          log))


def _model_factors(path: str):
    from predictionio_torch.workflow.core_workflow import read_model_file

    _, models = read_model_file(path)
    return models[0].user_factors, models[0].item_factors


def _combine_ab(data, device) -> dict:
    """11e: on the item side's buckets at RUNTIME_SPLIT_CAP (rank 64,
    seeded partials of each bucket's real shapes), the old combine (a
    float `index_add_` into [U, K, K] accumulators keyed by segmap) and
    the port's (`index_copy_` to a position a segment, then
    `als._sum_segments`): ms of each, and whether each gives the same
    bits twice."""
    import torch

    from predictionio_torch.ops import als

    buckets, split = als.bucket_ragged_split(
        data.train_i, data.train_u, data.train_r, data.n_items, 8,
        RUNTIME_SPLIT_CAP)
    k = 64
    _, plan = als._put_side(buckets, split, device)
    positions = als._split_positions(buckets, len(split))[0]
    gen = torch.Generator(device=device).manual_seed(11)
    parts = []
    for b, pos in zip(buckets, positions):
        if b.segmap is None:
            continue
        r = len(b.segmap)
        parts.append((torch.as_tensor(b.segmap, dtype=torch.int64,
                                      device=device),
                      torch.as_tensor(pos, device=device),
                      torch.randn((r, k, k), generator=gen, device=device)))
    n_split = len(split)

    def old():
        acc = torch.zeros((n_split + 1, k, k), device=device)
        for segmap, _pos, a in parts:
            acc.index_add_(0, segmap, a)
        return acc[:n_split]

    def new():
        table = torch.zeros((plan.n_segments + 2, k, k), device=device)
        for _segmap, pos, a in parts:
            table.index_copy_(0, pos, a)
        return als._sum_segments(plan.segments, table)[0]

    row = {"split_rows": n_split, "segments": plan.n_segments,
           "segment_width": int(plan.segments.shape[1]),
           "old_ms": time_ms(old, 20), "new_ms": time_ms(new, 20),
           "old_bitwise_repeat": bool(torch.equal(old(), old())),
           "new_bitwise_repeat": bool(torch.equal(new(), new())),
           "max_abs_old_new": float((old() - new()).abs().max())}
    return row


def phase_runtime(report: dict, device, tmp: str, served: dict, data,
                  ratings_writer, ratings_base: str) -> dict:
    """Phase 11, the train runtime: (a) the bucket cache in process,
    (b) the crash drill in `console train` children on the ratings store,
    (c) the eval grid's reuse of the train's entry, (d) `--profile-dir`,
    (e) trains with split rows (two plain, two checked), the combine A/B.
    Returns each child's launch record (their counts start at 0)."""
    import numpy as np

    from predictionio_torch.ops import spd_solve
    from predictionio_torch.ops.als import ALSConfig, als_train
    from predictionio_torch.utils import checks

    t_phase = time.perf_counter()
    work = os.path.join(tmp, "runtime")
    os.makedirs(work)
    cache = _runtime_cache(data, device, work)

    written = _await_ratings(ratings_writer, ratings_base)
    with open(os.path.join(HERE, "predictionio_torch", "templates",
                           "recommendation", "engine.json")) as f:
        variant = json.load(f)
    als_block = dict(variant["algorithms"][0])
    als_block["params"] = dict(als_block["params"], rank=64,
                               numIterations=RUNTIME_ITERATIONS)
    variant.update(algorithms=[als_block], serving={"name": "first"},
                   datasource={"params": {"appName": RUNTIME_APP}})
    engine_json = os.path.join(work, "engine.json")
    with open(engine_json, "w") as f:
        json.dump(variant, f)
    ckpt = os.path.join(work, "ckpt")
    dev = str(device)

    def train(model: str, *extra) -> list:
        return ["train", "--engine-json", engine_json, "--device", dev,
                "--model-out", os.path.join(work, model), *extra]

    drill = ["--checkpoint-dir", ckpt, "--checkpoint-every", "1"]
    # (b) the uninterrupted train and the killed one, together
    t0 = time.perf_counter()
    whole = _start_child(train("whole.pio"), ratings_base)
    killed = _start_child(train("killed.pio", *drill), ratings_base,
                          {"PIO_FAULTS": f"als.epoch_boundary:{RUNTIME_KILL}"})
    _, whole_err, whole_rec = _finish(whole, "uninterrupted train")
    _, killed_err, _ = _finish(killed, "killed train", want_rc=137)
    first_s = time.perf_counter() - t0
    if "dying at als.epoch_boundary" not in killed_err:
        raise AssertionError("11b: the killed train did not die at the "
                             "epoch boundary")
    steps = sorted(os.listdir(os.path.join(ckpt, "als")))
    keys = _cache_keys(whole_err, "miss")

    # then, together: the resumed train, the eval grid with the cache and
    # without it, and the profiled train on phase 4's store
    held = {}
    for u, i in zip(data.test_u, data.test_i):
        held.setdefault(f"u{u}", set()).add(f"i{i}")
    holdout = os.path.join(work, "holdout.json")
    with open(holdout, "w") as f:
        json.dump([[u, sorted(items)] for u, items in sorted(held.items())],
                  f)
    profile = os.path.join(work, "profile")
    evaluate = ["eval", "chip_smoke.HoldoutEvaluation", "--device", dev]
    t0 = time.perf_counter()
    children = {
        "resumed": _start_child(train("resumed.pio", *drill), ratings_base),
        "eval_hit": _start_child(evaluate, ratings_base,
                                 {"CHIP_SMOKE_HOLDOUT": holdout}),
        "eval_miss": _start_child(evaluate, ratings_base,
                                  {"CHIP_SMOKE_HOLDOUT": holdout,
                                   "PIO_BUCKET_CACHE": "0"}),
        "profiled": _start_child(
            ["train", "--engine-json", served["engine_json"], "--device",
             dev, "--model-out", os.path.join(work, "profiled.pio"),
             "--profile-dir", profile], served["store_base"]),
    }
    done = {name: _finish(proc, name) for name, proc in children.items()}
    second_s = time.perf_counter() - t0
    _, resumed_err, resumed_rec = done["resumed"]
    if f"resumed from checkpoint step {RUNTIME_KILL - 1}" not in resumed_err:
        raise AssertionError(f"11b: the re-run did not resume from step "
                             f"{RUNTIME_KILL - 1}: {resumed_err[-3000:]}")
    if not _cache_keys(resumed_err, "hit") & keys:
        raise AssertionError("11b: the re-run train missed the bucket "
                             "cache")
    same = all(np.array_equal(a, b) for a, b in zip(
        _model_factors(os.path.join(work, "resumed.pio")),
        _model_factors(os.path.join(work, "whole.pio"))))
    b_row = {"iterations": RUNTIME_ITERATIONS, "kill_at_chunk": RUNTIME_KILL,
             "steps_after_kill": steps, "factors_bitwise_equal": same,
             "launches_uninterrupted": whole_rec["by_rank"],
             "launches_resumed": resumed_rec["by_rank"],
             "children_s": [first_s, second_s], "store": written}
    emit(dict(phase="runtime", part="b_crash_drill", **b_row))
    if not same or steps != [f"step_{s}" for s in range(
            max(1, RUNTIME_KILL - 3), RUNTIME_KILL)]:
        raise AssertionError(f"11b: the crash drill failed: {b_row}")

    # (c) the grid's bucketize: a hit on the train's entry
    hit_out, hit_err, hit_rec = done["eval_hit"]
    miss_out, miss_err, miss_rec = done["eval_miss"]
    c_row = {"hit_keys": sorted(_cache_keys(hit_err, "hit")),
             "train_keys": sorted(keys),
             "setup_s_hit": [g["setup_s"] for g in hit_rec["grids"]],
             "setup_s_miss": [g["setup_s"] for g in miss_rec["grids"]],
             "steps_s_hit": [g["steps_s"] for g in hit_rec["grids"]],
             "steps_s_miss": [g["steps_s"] for g in miss_rec["grids"]],
             "launches_hit": hit_rec["by_rank"],
             "launches_miss": miss_rec["by_rank"]}
    # the two grids train on the same buckets: the same scores
    c_row["scores"] = [[line.strip() for line in out.splitlines()
                        if "score=" in line] for out in (hit_out, miss_out)]
    emit(dict(phase="runtime", part="c_grid_reuse", **c_row))
    if (not set(c_row["hit_keys"]) & keys or _cache_keys(hit_err, "miss")
            or len(hit_rec["grids"]) != 1 or len(miss_rec["grids"]) != 1
            or c_row["scores"][0] != c_row["scores"][1]
            or len(c_row["scores"][0]) != 2):
        raise AssertionError(f"11c: the eval grid did not reuse the "
                             f"train's entry: {c_row}")

    # (d) the profiled train's trace names its solve kernel
    trace_path = os.path.join(profile, "trace.json")
    with open(trace_path) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    gj = sorted(n for n in names if "gj_" in n and "kernel" in n)
    stages = sorted(n for n in names if n.startswith("Engine.train "))
    d_row = {"trace_bytes": os.path.getsize(trace_path), "gj_events": gj,
             "stages": stages,
             "launches": done["profiled"][2]["by_rank"]}
    emit(dict(phase="runtime", part="d_profile", **d_row))
    if stages != ["Engine.train als", "Engine.train prepare",
                  "Engine.train read"]:
        raise AssertionError(f"11d: the trace lacks the train's stages: "
                             f"{d_row}")

    # (e) trains with split rows, unchecked and checked in turns (plain,
    # checked, checked, plain), and the combine A/B
    cfg = ALSConfig(rank=64, iterations=ITERATIONS, reg=0.01, seed=0,
                    split_cap=RUNTIME_SPLIT_CAP)
    runs = {"plain": [], "checked": []}
    for kind in ("plain", "checked", "checked", "plain"):
        checks.enable(kind == "checked")
        try:
            runs[kind].append(als_train(
                data.train_u, data.train_i, data.train_r, data.n_users,
                data.n_items, cfg, device=device))
        finally:
            checks.enable(False)
    twice = runs["plain"]
    e_row = {"split_cap": RUNTIME_SPLIT_CAP,
             "split_users": int((np.bincount(data.train_u) >
                                 RUNTIME_SPLIT_CAP).sum()),
             "split_items": int((np.bincount(data.train_i) >
                                 RUNTIME_SPLIT_CAP).sum()),
             "factors_bitwise_equal": bool(all(
                 np.array_equal(getattr(twice[0], f), getattr(twice[1], f))
                 for f in ("user_factors", "item_factors"))),
             "checked_bitwise_equal": bool(all(
                 np.array_equal(getattr(c, f), getattr(twice[0], f))
                 for c in runs["checked"]
                 for f in ("user_factors", "item_factors"))),
             "epoch_s": [r.epoch_times for r in twice],
             "epoch_s_checked": [r.epoch_times for r in runs["checked"]],
             "combine": _combine_ab(data, device)}
    emit(dict(phase="runtime", part="e_determinism", **e_row))
    if not (e_row["factors_bitwise_equal"] and e_row["checked_bitwise_equal"]
            and e_row["split_items"] > 0
            and e_row["combine"]["new_bitwise_repeat"]):
        raise AssertionError(f"11e: trains with split rows differ: {e_row}")
    report["runtime"] = {"a": cache, "b": b_row, "c": c_row, "d": d_row,
                         "e": e_row, "store": written,
                         "wall_s": time.perf_counter() - t_phase}
    return {"whole": whole_rec, "resumed": resumed_rec,
            "eval_hit": hit_rec, "eval_miss": miss_rec,
            "profiled": done["profiled"][2]}


# -- phase 12 ----------------------------------------------------------------

def _classify_events(n_events: int, n_users: int, rng) -> tuple:
    """12c's property events, the shape of the reference's
    bench.py::bench_aggprops: `n_events` `$set` / `$unset` / `$delete` of
    users drawn from `n_users`, in CLASSIFY_MIX, one second apart. Each
    user's plan (its class c) is drawn once; a `$set` sets attr0-attr2 to
    onehot(c)·4 + a draw of {0, 1} and the plan, an `$unset` removes one
    attribute. Returns (an iterator of the event dicts, the count of each
    kind, the users the fold keeps: those whose last event is a
    `$set`)."""
    import numpy as np

    mix = np.asarray(CLASSIFY_MIX, dtype=np.float64)
    kinds = rng.choice(3, n_events, p=mix / mix.sum())
    users = rng.integers(0, n_users, n_events)
    plans = rng.integers(0, 3, n_users)
    noise = rng.integers(0, 2, (n_events, 3))
    unset = rng.integers(0, 3, n_events)
    last = np.full(n_users, -1)
    np.maximum.at(last, users, np.arange(n_events))
    labeled = int(((last >= 0) & (kinds[np.maximum(last, 0)] == 0)).sum())
    names = ("$set", "$unset", "$delete")
    t0 = datetime(2026, 1, 1, tzinfo=timezone.utc)

    def events():
        for k in range(n_events):
            kind, user = int(kinds[k]), int(users[k])
            event = {"event": names[kind], "entityType": "user",
                     "entityId": f"u{user}", "eventTime": _stamp(t0, k)}
            if kind == 0:
                plan = int(plans[user])
                event["properties"] = {
                    **{f"attr{j}": 4.0 * (plan == j) + float(noise[k, j])
                       for j in range(3)},
                    "plan": float(plan)}
            elif kind == 1:
                event["properties"] = {f"attr{int(unset[k])}": None}
            yield event

    counts = {name: int((kinds == i).sum()) for i, name in enumerate(names)}
    return events(), counts, labeled


def _lead_events(n_sessions: int, rng) -> tuple:
    """12d's sessions: a `view` of user v{n} opening session s{n} from one
    of LEAD_PAGES landing pages, LEAD_REFERRERS referrers and the
    LEAD_BROWSERS, and for some a `buy` in the session, drawn with a
    conversion logit planted per page, referrer and browser (about 10 % in
    all). Returns (the event dicts, the sessions, the buys)."""
    import numpy as np

    pages = rng.integers(0, LEAD_PAGES, n_sessions)
    refs = rng.integers(0, LEAD_REFERRERS, n_sessions)
    browsers = rng.integers(0, len(LEAD_BROWSERS), n_sessions)
    logit = (rng.normal(0.0, 1.0, LEAD_PAGES)[pages]
             + rng.normal(0.0, 0.5, LEAD_REFERRERS)[refs]
             + rng.normal(0.0, 0.3, len(LEAD_BROWSERS))[browsers] - 2.3)
    buyers = np.nonzero(rng.random(n_sessions)
                        < 1.0 / (1.0 + np.exp(-logit)))[0].tolist()
    t0 = datetime(2026, 2, 1, tzinfo=timezone.utc)
    events = [{"event": "view", "entityType": "user", "entityId": f"v{n}",
               "properties": {"sessionId": f"s{n}",
                              "landingPageId": f"lp{pages[n]}",
                              "referrerId": f"r{refs[n]}",
                              "browser": LEAD_BROWSERS[browsers[n]]},
               "eventTime": _stamp(t0, n)} for n in range(n_sessions)]
    events += [{"event": "buy", "entityType": "user", "entityId": f"v{n}",
                "targetEntityType": "item", "targetEntityId": f"i{n % 50}",
                "properties": {"sessionId": f"s{n}"},
                "eventTime": _stamp(t0, n_sessions + j)}
               for j, n in enumerate(buyers)]
    return events, n_sessions, len(buyers)


def write_classify_store(base: str, scale: str) -> None:
    """12, in a writer child started with the run: CLASSIFY_APP's property
    events (`_classify_events`) and LEAD_APP's sessions (`_lead_events`)
    at CLASSIFY_SCALES[scale], each written as a JSON-lines file and
    `console import`ed (the native importer) into a sqlite pio.db under
    `base`, the file deleted after; then CLASSIFY_RESULT under `base`:
    the counts and each file's and import's seconds."""
    import numpy as np

    from predictionio_torch.tools import console

    t_start = time.perf_counter()
    n_events, n_users, n_sessions = CLASSIFY_SCALES[scale]
    rng = np.random.default_rng(12)
    props, kinds, labeled = _classify_events(n_events, n_users, rng)
    lead, sessions, buys = _lead_events(n_sessions, rng)
    os.environ["PIO_FS_BASEDIR"] = base
    row = {"scale": scale}
    for app, events, n in ((CLASSIFY_APP, props, n_events),
                           (LEAD_APP, lead, len(lead))):
        path = os.path.join(base, f"{app}.jsonl")
        t0 = time.perf_counter()
        with open(path, "w") as f:
            for event in events:
                f.write(json.dumps(event) + "\n")
        file_s = time.perf_counter() - t0
        with contextlib.redirect_stdout(io.StringIO()) as said:
            if console.main(["app", "new", app]) != 0:
                raise AssertionError(f"console app new {app} failed")
            t0 = time.perf_counter()
            if console.main(["import", "--appname", app, "--input",
                             path]) != 0:
                raise AssertionError(f"console import of {app} failed")
            import_s = time.perf_counter() - t0
        os.unlink(path)
        imported = said.getvalue().strip().splitlines()[-1]
        if imported != f"Imported {n} events.":
            raise AssertionError(f"console import said {imported!r}")
        row[app] = {"events": n, "file_s": file_s, "import_s": import_s,
                    "import_events_per_s": n / import_s}
    row[CLASSIFY_APP].update(users=n_users, kinds=kinds,
                             labeled_users=labeled)
    row[LEAD_APP].update(sessions=sessions, buys=buys)
    row["write_s"] = time.perf_counter() - t_start
    with open(os.path.join(base, CLASSIFY_RESULT), "w") as f:
        json.dump(row, f)


def _separable(device, n: int, d: int, c: int, seed: int) -> tuple:
    """Features x ~ N(0, 1) [n, d] f32 and labels argmax(x @ W) of a seeded
    W [d, c] (linearly separable), made on `device`; host numpy."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((n, d), generator=gen, device=device)
    w = torch.randn((d, c), generator=gen, device=device)
    y = (x @ w).argmax(1).int()
    return x.cpu().numpy(), y.cpu().numpy()


def _same_bits(a, b) -> bool:
    import numpy as np

    return bool(np.array_equal(a.weights, b.weights)
                and np.array_equal(a.bias, b.bias)
                and a.loss_history == b.loss_history)


def _within(pairs, tol: dict) -> tuple:
    """(max abs error over the (got, want) array pairs, all within `tol`)."""
    import numpy as np

    err, ok = 0.0, True
    for got, want in pairs:
        got, want = np.asarray(got), np.asarray(want)
        err = max(err, float(np.abs(got - want).max()) if got.size else 0.0)
        ok = ok and got.shape == want.shape and bool(
            np.allclose(got, want, **tol))
    return err, ok


def _logreg_pairs(got, want) -> list:
    return [(got.weights, want.weights), (got.bias, want.bias),
            (got.loss_history, want.loss_history)]


def _steps_ms(inputs, device, n_steps: int) -> float:
    """Device ms an Adam step of `ops.classify`'s fit, by CUDA events
    around `n_steps` steps on uploaded `inputs` (one cell at CONFIG2_LR)."""
    import torch

    from predictionio_torch.ops import classify

    lrs = torch.tensor([CONFIG2_LR], device=device)
    regs = torch.zeros(1, device=device)
    state = classify._init_state(inputs[0].shape[1], 1, CONFIG2_C, device)
    classify._logreg_steps(state, inputs, lrs, regs, 2)  # warm-up
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    classify._logreg_steps(state, inputs, lrs, regs, n_steps)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n_steps


def _classify_config2(device) -> dict:
    """12a: `logreg_train` at config 2's shape on the card (wall, upload,
    device ms a step, peak memory, training accuracy), twice and chunked
    (bits), `naive_bayes_train` at the same shape on |x|, and the fit of
    the first CONFIG2_CPU_N rows on the card against the CPU's."""
    import numpy as np
    import torch

    from predictionio_torch.device import synchronize
    from predictionio_torch.ops import classify

    n, d, c = CONFIG2_N, CONFIG2_D, CONFIG2_C
    t0 = time.perf_counter()
    x, y = _separable(device, n, d, c, seed=12)
    make_s = time.perf_counter() - t0

    def timed(fn):
        synchronize(device)
        t = time.perf_counter()
        out = fn()
        synchronize(device)
        return out, time.perf_counter() - t

    def fit(rows=n, dev=device, **kw):
        return timed(lambda: classify.logreg_train(
            x[:rows], y[:rows], c, iterations=CONFIG2_ITERS,
            learning_rate=CONFIG2_LR, device=dev, **kw))

    # the fit's upload alone (pageable host memory, as the fit's)
    uploaded, upload_s = timed(lambda: torch.from_numpy(x).to(device))
    del uploaded
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.init()  # the peak counters exist once CUDA is up
        torch.cuda.reset_peak_memory_stats(device)
    first, first_s = fit()
    peak = torch.cuda.max_memory_allocated(device) if on_card else None
    second, second_s = fit()
    with tempfile.TemporaryDirectory() as ckpt:
        chunked, chunked_s = fit(checkpoint_dir=ckpt,
                                 checkpoint_every=CONFIG2_CHUNK)
        steps = sorted(os.listdir(ckpt))
    inputs = classify._logreg_inputs(x, y, c, device)
    step_ms = _steps_ms(inputs, device, CONFIG2_ITERS)
    weights = torch.from_numpy(first.weights).to(device)
    bias = torch.from_numpy(first.bias).to(device)
    accuracy = float(((inputs[0][:n] @ weights + bias).argmax(1)
                      == inputs[1][:n]).float().mean())
    del inputs
    counts = np.abs(x)
    _, nb_s = timed(lambda: classify.naive_bayes_train(counts, y, c,
                                                       device=device))
    card, card_s = fit(rows=CONFIG2_CPU_N)
    host, host_s = fit(rows=CONFIG2_CPU_N, dev=torch.device("cpu"))
    cpu_err, cpu_ok = _within(_logreg_pairs(card, host), LOGREG_TOL)
    return {"shape": [n, d, c], "iterations": CONFIG2_ITERS,
            "learning_rate": CONFIG2_LR, "make_s": make_s,
            "upload_ms": upload_s * 1e3, "fit_s": first_s,
            "fit_again_s": second_s, "fit_chunked_s": chunked_s,
            "step_ms": step_ms, "peak_bytes": peak,
            "train_accuracy": accuracy,
            "loss_first_last": [first.loss_history[0],
                                first.loss_history[-1]],
            "bitwise_again": _same_bits(first, second),
            "bitwise_chunked": _same_bits(first, chunked),
            "chunk": CONFIG2_CHUNK, "checkpoint_steps": steps,
            "nb_fit_s": nb_s,
            "cpu_rows": CONFIG2_CPU_N, "card_fit_s": card_s,
            "cpu_fit_s": host_s, "card_cpu_max_abs": cpu_err,
            "card_cpu_within_bars": cpu_ok}


def _classify_grid(device) -> dict:
    """12b: `logreg_train_grid` over GRID_CELLS (mixed horizons) and
    `naive_bayes_train_grid` over GRID_SMOOTHINGS at GRID_N × GRID_D →
    GRID_C, each timed against its cells' sequential fits in this run and
    every cell held against its sequential fit at the reference's bars."""
    import numpy as np

    from predictionio_torch.device import synchronize
    from predictionio_torch.ops import classify

    x, y = _separable(device, GRID_N, GRID_D, GRID_C, seed=13)
    counts = np.abs(x)

    def timed(fn):
        synchronize(device)
        t = time.perf_counter()
        out = fn()
        synchronize(device)
        return out, time.perf_counter() - t

    grid, grid_s = timed(lambda: classify.logreg_train_grid(
        x, y, GRID_C, [n for _, _, n in GRID_CELLS],
        [lr for lr, _, _ in GRID_CELLS], [rg for _, rg, _ in GRID_CELLS],
        device=device))
    seq, seq_s = timed(lambda: [classify.logreg_train(
        x, y, GRID_C, iterations=n, learning_rate=lr, reg=rg, device=device)
        for lr, rg, n in GRID_CELLS])
    nb_grid, nb_grid_s = timed(lambda: classify.naive_bayes_train_grid(
        counts, y, GRID_C, GRID_SMOOTHINGS, device=device))
    nb_seq, nb_seq_s = timed(lambda: [classify.naive_bayes_train(
        counts, y, GRID_C, smoothing=s, device=device)
        for s in GRID_SMOOTHINGS])
    logreg = [_within(_logreg_pairs(g, s), LOGREG_TOL)
              for g, s in zip(grid, seq)]
    nb = [_within([(g.log_prior, s.log_prior), (g.log_theta, s.log_theta)],
                  NB_TOL) for g, s in zip(nb_grid, nb_seq)]
    return {"shape": [GRID_N, GRID_D, GRID_C], "cells": GRID_CELLS,
            "history_lengths": [len(g.loss_history) for g in grid],
            "logreg_grid_s": grid_s, "logreg_sequential_s": seq_s,
            "nb_grid_s": nb_grid_s, "nb_sequential_s": nb_seq_s,
            "logreg_cell_max_abs": [e for e, _ in logreg],
            "logreg_cells_within": all(ok for _, ok in logreg),
            "nb_cell_max_abs": [e for e, _ in nb],
            "nb_cells_within": all(ok for _, ok in nb),
            "smoothings": GRID_SMOOTHINGS}


def _served_equal(url: str, queries: list, predict) -> dict:
    """Every query POSTed to `url` answers as `predict` (the in-process
    model) does; the answers' ms."""
    import numpy as np

    ms, differ = [], []
    for q in queries:
        t0 = time.perf_counter()
        got = _post(url, q)
        ms.append((time.perf_counter() - t0) * 1e3)
        if got != predict(q):
            differ.append((q, got))
    return {"queries": len(queries), "differ": differ[:5],
            "equal": len(queries) - len(differ),
            "ms_p50": float(np.percentile(ms, 50)),
            "ms_p99": float(np.percentile(ms, 99))}


def _count_logged(stderr: str, pattern: str) -> list:
    """The integers that `pattern`'s groups match in the last log line it
    matches ([] when none does)."""
    found = re.findall(pattern, stderr)
    if not found:
        return []
    last = found[-1]
    return [int(v) for v in (last if isinstance(last, tuple) else (last,))]


def _finish_together(started: dict, t_start: dict, want_rc: dict,
                     phase: str = "12") -> tuple:
    """`_finish` of every child of `started` (name → process) on threads of
    its own, so that no child waits on a full pipe: ({name: (stdout,
    stderr, launch record)}, {name: seconds from its start, `t_start[name]`,
    to its exit}). `want_rc` names the children that must exit with
    another code than 0."""
    def finish(name, proc):
        out = _finish(proc, name, want_rc.get(name, 0), phase=phase)
        return out, time.perf_counter() - t_start[name]

    with concurrent.futures.ThreadPoolExecutor(len(started)) as pool:
        futures = {name: pool.submit(finish, name, proc)
                   for name, proc in started.items()}
        results = {name: fut.result() for name, fut in futures.items()}
    return ({name: out for name, (out, _) in results.items()},
            {name: wall for name, (_, wall) in results.items()})


def phase_classify(report: dict, device, tmp: str, writer,
                   base: str) -> dict:
    """Phase 12: (a) the classification ops at config 2's shape, (b) their
    grids, (c) the classification template over the property store, (d)
    the leadscoring template (train, serve, AUC eval), (e) its crash
    drill. `writer` is the child writing the store under `base`
    (`write_classify_store`). Returns each console child's launch
    record."""
    import numpy as np

    t_phase = time.perf_counter()
    card = report["card"]
    a_row = _classify_config2(device)
    emit(dict(phase="classify", part="a_config2", card=card, **a_row))
    if not (a_row["bitwise_again"] and a_row["bitwise_chunked"]
            and a_row["card_cpu_within_bars"]
            and a_row["checkpoint_steps"] == [
                f"step_{s}" for s in range(CONFIG2_ITERS - 2 * CONFIG2_CHUNK,
                                           CONFIG2_ITERS + 1, CONFIG2_CHUNK)]
            and a_row["train_accuracy"] > 0.8):
        raise AssertionError(f"12a: config 2's fits failed their bars: "
                             f"{a_row}")
    b_row = _classify_grid(device)
    emit(dict(phase="classify", part="b_grid", card=card, **b_row))
    if not (b_row["logreg_cells_within"] and b_row["nb_cells_within"]
            and b_row["history_lengths"] == [n for _, _, n in GRID_CELLS]):
        raise AssertionError(f"12b: a grid cell left its bar: {b_row}")

    t0 = time.perf_counter()
    written = _await_ratings(writer, base, CLASSIFY_RESULT,
                             "the classification store's writer")
    waited_s = time.perf_counter() - t0
    dev = str(device)
    cls_json = _scaffolded("classification",
                           os.path.join(tmp, "Classification"), CLASSIFY_APP)
    with open(cls_json) as f:
        variant = json.load(f)
    variant.update(id="classification-lr", algorithms=[
        {"name": "logisticregression",
         "params": {"iterations": CONFIG2_ITERS, "stepSize": CONFIG2_LR,
                    "regParam": 0.0}}])
    lr_json = os.path.join(tmp, "Classification", "engine-lr.json")
    with open(lr_json, "w") as f:
        json.dump(variant, f, indent=2)
    lead_json = _scaffolded("leadscoring", os.path.join(tmp, "LeadScoring"),
                            LEAD_APP)
    ckpt = os.path.join(tmp, "lead-ckpt")
    drill_model = os.path.join(tmp, "lead-drill.pio")

    def train(engine_json: str, *extra) -> list:
        return ["train", "--engine-json", engine_json, "--device", dev,
                *extra]

    drill = train(lead_json, "--checkpoint-dir", ckpt, "--model-out",
                  drill_model)
    deploys, later = {}, {}
    storage = None
    try:
        # the three trains, the drill's killed one and the evaluation start
        # together; the evaluation runs on beside the servers
        eval_out = os.path.join(tmp, "lead-eval.json")
        t0 = time.perf_counter()
        t_start = {name: t0 for name in (
            "train_naive", "train_lr", "train_lead", "killed", "eval")}
        later = {"eval": _start_child(
            ["eval", LEAD_EVAL_CLASS, "--device", dev, "--out", eval_out],
            base, {"PIO_EVAL_APP_NAME": LEAD_APP})}
        started = {
            "train_naive": _start_child(train(cls_json), base),
            "train_lr": _start_child(train(lr_json), base),
            "train_lead": _start_child(train(lead_json), base),
            "killed": _start_child(drill, base, {
                "PIO_FAULTS": f"logreg.step_boundary:{LEAD_KILL}"})}
        done, walls = _finish_together(started, t_start, {"killed": 137})
        trains_s = time.perf_counter() - t0
        killed_err = done["killed"][1]
        killed_steps = sorted(os.listdir(os.path.join(ckpt, "lr")))
        if ("dying at logreg.step_boundary" not in killed_err
                or killed_steps != [f"step_{LEAD_CHUNK * k}"
                                    for k in range(1, LEAD_KILL)]):
            raise AssertionError(f"12e: the killed train did not die at its "
                                 f"step boundary ({killed_steps}):\n"
                                 f"{killed_err[-3000:]}")
        rows = {}
        for name in ("train_naive", "train_lr", "train_lead"):
            _, err, rec = done[name]
            rows[name] = dict(_stage_seconds(err), wall_s=walls[name],
                              launches=rec["by_rank"])
            report.setdefault("classify_log", {})[name] = \
                err.splitlines()[-30:]
        points = _count_logged(done["train_naive"][1],
                               r"DataSource: (\d+) labeled points")
        sessions = _count_logged(
            done["train_lead"][1],
            r"DataSource: (\d+) sessions \((\d+) converted")
        store = written[CLASSIFY_APP]
        lead_store = written[LEAD_APP]
        if (points != [store["labeled_users"]]
                or _count_logged(done["train_lr"][1],
                                 r"DataSource: (\d+) labeled points") != points
                or sessions != [lead_store["sessions"], lead_store["buys"]]):
            raise AssertionError(f"12c/d: the trains read {points} points and "
                                 f"{sessions} sessions, the writer wrote "
                                 f"{written}")

        # the servers and the resumed drill, beside the evaluation
        launch_paths = {name: os.path.join(tmp, f"classify-{name}.json")
                        for name in ("naive", "lr", "lead")}
        deploys = {name: _start_deploy(
            ["--engine-json", path, "--ip", "127.0.0.1", "--port", "0",
             "--device", dev], {"PIO_FS_BASEDIR": base}, launch_paths[name])
            for name, path in (("naive", cls_json), ("lr", lr_json),
                               ("lead", lead_json))}
        t0 = time.perf_counter()
        t_start["resumed"] = t0
        later["resumed"] = _start_child(drill, base)
        urls = {}
        for name, proc in deploys.items():
            line = _read_deployed_line(proc, 300.0)
            urls[name] = f"http://127.0.0.1:{int(line.rsplit(':', 1)[1])}"
        ready_s = time.perf_counter() - t0
        rng = np.random.default_rng(14)
        plans = rng.integers(0, 3, CLASSIFY_QUERIES)
        cls_queries = [
            {f"attr{j}": 4.0 * (int(p) == j) + float(rng.integers(0, 2))
             for j in range(3)} for p in plans]
        lead_queries = [
            {"landingPageId": f"lp{rng.integers(0, LEAD_PAGES)}",
             "referrerId": f"r{rng.integers(0, LEAD_REFERRERS)}",
             "browser": LEAD_BROWSERS[rng.integers(0, len(LEAD_BROWSERS))]}
            for _ in range(CLASSIFY_QUERIES - 1)]
        lead_queries.append({"landingPageId": "lp-new", "referrerId": "r-new",
                             "browser": "Lynx"})
        storage = _store_at(base)
        served = {}
        for name, path, queries in (("naive", cls_json, cls_queries),
                                    ("lr", lr_json, cls_queries),
                                    ("lead", lead_json, lead_queries)):
            predict = _latest_model(storage, path)
            served[name] = _served_equal(urls[name], queries, predict)
            if name != "lead":
                served[name]["planted_class_share"] = float(np.mean(
                    [predict(q)["label"] == float(p)
                     for q, p in zip(queries, plans)]))
        finished, later_walls = _finish_together(later, t_start, {})
        done.update(finished)
        walls.update(later_walls)
        later_s = time.perf_counter() - t0
        uninterrupted = storage.model_data_models().get(
            _completed_instance(base, lead_json)).models
    finally:
        for proc in list(deploys.values()) + list(later.values()):
            if proc.poll() is None:
                _stop(proc)
        if storage is not None:
            storage.close()
    for name, path in launch_paths.items():
        with open(path) as f:
            done[f"deploy_{name}"] = (None, None, json.load(f))
    for name, path in (("naive", cls_json), ("lr", lr_json)):
        emit(dict(phase="classify", part="c_classification", card=card,
                  algorithm=name, points=points[0], store=store,
                  waited_s=waited_s, trains_s=trains_s,
                  **rows[f"train_{name}"], serve=served[name],
                  ready_s=ready_s))
    with open(drill_model, "rb") as f:
        resumed_models = pickle.load(f)["models"]
    resumed_err = done["resumed"][1]
    start = _count_logged(resumed_err,
                          r"logreg_train: resumed from checkpoint step (\d+)")
    with open(eval_out) as f:
        record = json.load(f)
    results = json.loads(record["evaluator_results_json"])
    aucs = [{"regParam": r["engineParams"]["algorithms"][0]["params"][
                 "regParam"], "auc": r["scores"]["AUC"]}
            for r in results["results"]]
    metrics_line = re.findall(r"metrics\[train/leadscoring\] (.*)",
                              done["train_lead"][1])
    d_row = dict(rows["train_lead"], sessions=lead_store,
                 metrics_line=metrics_line[-1:], serve=served["lead"],
                 eval={"status": record["status"], "aucs": aucs,
                       "best": results["bestScore"]},
                 eval_launches=done["eval"][2]["by_rank"],
                 eval_wall_s=walls["eval"], later_s=later_s)
    emit(dict(phase="classify", part="d_leadscoring", card=card, **d_row))
    e_row = {"kill_at_chunk": LEAD_KILL, "chunk": LEAD_CHUNK,
             "steps_after_kill": killed_steps, "resumed_from": start,
             "killed_wall_s": walls["killed"],
             "resumed_wall_s": walls["resumed"],
             "model_bytes": len(resumed_models),
             "model_bytes_equal": resumed_models == uninterrupted}
    emit(dict(phase="classify", part="e_drill", card=card, **e_row))
    bad = [name for name, row in served.items()
           if row["equal"] != row["queries"]]
    if bad or record["status"] != "EVALCOMPLETED" or not all(
            a["auc"] > 0.6 for a in aucs) or not metrics_line:
        raise AssertionError(f"12c/d: served answers differ in {bad}, or "
                             f"the evaluation failed: {aucs}")
    if start != [LEAD_CHUNK * (LEAD_KILL - 1)] or not e_row[
            "model_bytes_equal"]:
        raise AssertionError(f"12e: the drill did not resume to the "
                             f"uninterrupted model: {e_row}")
    wall = time.perf_counter() - t_phase
    emit({"phase": "classify", "wall_s": wall, "card": card})
    report["classify"] = {"a": a_row, "b": b_row, "c": {
        "store": store, "trains": rows, "served": served},
        "d": d_row, "e": e_row, "wall_s": wall}
    return {name: rec for name, (_, _, rec) in done.items()
            if rec is not None}


# -- phase 13: the text ops and the textclassification template -------------

def _text_evaluation():
    """An evaluation of the Text Classification template: NB (numFeatures
    1024) at TEXT_EVAL_LAMBDAS over TEXT_EVAL_K folds of TEXT_APP, scored
    by accuracy. The λ cells share one featurization, so each fold trains
    them as one grid (`NBAlgorithm.train_grid`)."""
    from predictionio_torch.controller import AverageMetric
    from predictionio_torch.controller.engine import EngineParams
    from predictionio_torch.controller.evaluation import (
        EngineParamsGenerator,
        Evaluation,
    )
    from predictionio_torch.templates.textclassification import engine as tc

    class Accuracy(AverageMetric):
        def calculate(self, query, predicted, actual):
            return 1.0 if predicted["category"] == actual["category"] else 0.0

    class TextEvaluation(Evaluation, EngineParamsGenerator):
        def __init__(self):
            self.engine = tc.TextClassificationEngine().apply()
            self.metric = Accuracy()
            self.engine_params_list = [EngineParams(
                data_source_params=tc.DataSourceParams(
                    appName=TEXT_APP, evalK=TEXT_EVAL_K),
                algorithm_params_list=[("nb", tc.NBParams(
                    lambda_=lam, numFeatures=1024))])
                for lam in TEXT_EVAL_LAMBDAS]

    return TextEvaluation


def _text_events(n_docs: int, n_words: int, rng) -> tuple:
    """13b's documents: `n_docs` `$set`s of content entities doc{i}, one
    second apart, each of a category drawn from TEXT_CATEGORIES and 8-24
    tokens; a token is, with TEXT_OWN_SHARE, one of its category's
    TEXT_OWN_WORDS words, else one of `n_words` shared words, each Zipf
    (p ∝ 1/rank). Returns (the event dicts, the documents a category, the
    tokens)."""
    import numpy as np

    cats = rng.integers(0, TEXT_CATEGORIES, n_docs)
    lengths = rng.integers(8, 25, n_docs)
    total = int(lengths.sum())
    doc = np.repeat(np.arange(n_docs), lengths)

    def zipf(n: int, size: int):
        p = 1.0 / np.arange(1, n + 1)
        return rng.choice(n, size, p=p / p.sum())

    shared = np.asarray([f"w{j}" for j in range(n_words)])
    own = np.asarray([[f"c{c}w{j}" for j in range(TEXT_OWN_WORDS)]
                      for c in range(TEXT_CATEGORIES)])
    tokens = np.where(rng.random(total) < TEXT_OWN_SHARE,
                      own[cats[doc], zipf(TEXT_OWN_WORDS, total)],
                      shared[zipf(n_words, total)])
    t0 = datetime(2026, 3, 1, tzinfo=timezone.utc)
    events = [{"event": "$set", "entityType": "content",
               "entityId": f"doc{i:06d}",
               "properties": {"text": " ".join(words).capitalize() + ".",
                              "category": f"cat{cats[i]}"},
               "eventTime": _stamp(t0, i)}
              for i, words in enumerate(np.split(tokens,
                                                 np.cumsum(lengths)[:-1]))]
    counts = np.bincount(cats, minlength=TEXT_CATEGORIES).tolist()
    return events, counts, total


def write_text_store(base: str, scale: str) -> None:
    """13, in a writer child started with the run: TEXT_APP's documents
    (`_text_events`) at TEXT_SCALES[scale], written as a JSON-lines file
    and `console import`ed (the native importer) into a sqlite pio.db
    under `base`, the file deleted after; then TEXT_RESULT under `base`:
    the counts and the file's and the import's seconds."""
    import numpy as np

    from predictionio_torch.tools import console

    t_start = time.perf_counter()
    n_docs, n_words = TEXT_SCALES[scale]
    events, per_category, tokens = _text_events(n_docs, n_words,
                                                np.random.default_rng(13))
    os.environ["PIO_FS_BASEDIR"] = base
    path = os.path.join(base, f"{TEXT_APP}.jsonl")
    t0 = time.perf_counter()
    with open(path, "w") as f:
        for event in events:
            f.write(json.dumps(event) + "\n")
    file_s = time.perf_counter() - t0
    with contextlib.redirect_stdout(io.StringIO()) as said:
        if console.main(["app", "new", TEXT_APP]) != 0:
            raise AssertionError(f"console app new {TEXT_APP} failed")
        t0 = time.perf_counter()
        if console.main(["import", "--appname", TEXT_APP, "--input",
                         path]) != 0:
            raise AssertionError(f"console import of {TEXT_APP} failed")
        import_s = time.perf_counter() - t0
    os.unlink(path)
    imported = said.getvalue().strip().splitlines()[-1]
    if imported != f"Imported {n_docs} events.":
        raise AssertionError(f"console import said {imported!r}")
    row = {"scale": scale, "documents": n_docs, "shared_words": n_words,
           "tokens": tokens, "per_category": per_category,
           "file_s": file_s, "import_s": import_s,
           "import_events_per_s": n_docs / import_s,
           "write_s": time.perf_counter() - t_start}
    with open(os.path.join(base, TEXT_RESULT), "w") as f:
        json.dump(row, f)


def _w2v_cfg(steps: int = None):
    from predictionio_torch.ops import text

    return text.Word2VecConfig(dim=W2V_K, negatives=W2V_N,
                               steps=W2V_STEPS if steps is None else steps,
                               batch_size=W2V_B, learning_rate=W2V_LR,
                               seed=13)


def _w2v_bound(pairs, draws) -> dict:
    """The least bytes and operations of the SGNS steps of `draws` (a
    step's (pair idx, negatives)), from the code: each embedding row a
    step touches read once and written once (emb_in at the distinct
    centers; emb_out at the distinct contexts and negatives), the draws
    and the drawn pair rows read once; operations the step's
    multiply-adds (scores, gradients, the -lr scale, the row sums), the
    (N + 1)·B sigmoids counted 8 each. Beside them the bytes with every
    one of the B·(N + 2) rows gathered, then read and written again by
    the scatter (no row merged)."""
    import numpy as np
    import torch

    unique_rows = []
    for idx, neg in draws:
        batch = pairs.index_select(0, idx)
        u_in = int(torch.unique(batch[:, 0]).numel())
        u_out = int(torch.unique(torch.cat([batch[:, 1],
                                            neg.reshape(-1)])).numel())
        unique_rows.append(u_in + u_out)
    rows = float(np.mean(unique_rows))
    b, n, k = W2V_B, W2V_N, W2V_K
    index_bytes = b * 8 + b * n * 8 + b * 2 * pairs.element_size()
    least = 2 * rows * k * 4 + index_bytes
    every_row = 3 * b * (n + 2) * k * 4 + index_bytes
    flops = (6 * n + 9) * b * k + 8 * b * (n + 1)
    bound, by = bound_ms(least, flops)
    return {"rows_touched": b * (n + 2), "distinct_rows_mean": rows,
            "bytes_least": least, "bytes_every_row": every_row,
            "operations": flops, "bound_ms": bound, "bound_by": by,
            "bound_ms_every_row": bound_ms(every_row, flops)[0]}


def _scatter_ab(pairs, device) -> dict:
    """13a: the negatives' scatter of W2V_SCATTER_BATCHES of the loop's
    batches (B·N rows of K a call, seeded values) into a [V, K] table by
    `text.scatter_add_rows` (fixed order), `index_add_` (atomics) and
    `index_put_(accumulate=True)`: ms a call of each, and whether each
    gives the same bits twice."""
    import torch

    from predictionio_torch.ops import text

    gen = torch.Generator(device=device).manual_seed(21)
    sampler = text.TorchSampler(gen, len(pairs), W2V_V, _w2v_cfg())
    batches = []
    for _ in range(W2V_SCATTER_BATCHES):
        _, neg = sampler()
        batches.append((neg.reshape(-1), torch.randn(
            (neg.numel(), W2V_K), generator=gen, device=device)))
    table0 = torch.randn((W2V_V, W2V_K), generator=gen, device=device)

    def apply(kind, table):
        for ids, rows in batches:
            if kind == "fixed_order":
                text.scatter_add_rows(table, ids, rows)
            elif kind == "index_add":
                table.index_add_(0, ids, rows)
            else:
                table.index_put_((ids,), rows, accumulate=True)
        return table

    row = {"batches": W2V_SCATTER_BATCHES, "rows_a_call": W2V_B * W2V_N}
    ends = {}
    for kind in ("fixed_order", "index_add", "index_put_accumulate"):
        table = table0.clone()
        row[f"{kind}_ms"] = time_ms(lambda: apply(kind, table),
                                    5) / W2V_SCATTER_BATCHES
        first = apply(kind, table0.clone())
        second = apply(kind, table0.clone())
        ends[kind] = first
        row[f"{kind}_bitwise_repeat"] = bool(torch.equal(first, second))
    row["max_abs_fixed_vs_index_add"] = float(
        (ends["fixed_order"] - ends["index_add"]).abs().max())
    return row


def _w2v_card_cpu(pairs, device) -> dict:
    """13a: W2V_CPU_STEPS steps on the card and on the CPU from the same
    tables with the same draws (made on the card: the CPU's generator
    gives another stream), tables and losses held at W2V_TOL."""
    import numpy as np
    import torch

    from predictionio_torch.ops import text

    cfg = _w2v_cfg()
    gen = torch.Generator(device=device).manual_seed(22)
    sampler = text.TorchSampler(gen, len(pairs), W2V_V, cfg)
    draws = [sampler() for _ in range(W2V_CPU_STEPS)]
    rng = np.random.default_rng(23)
    emb_in0 = (rng.random((W2V_V, W2V_K), dtype=np.float32) - 0.5) / W2V_K
    out, walls = {}, {}
    for where in (device, torch.device("cpu")):
        emb_in = torch.tensor(emb_in0, device=where)
        emb_out = torch.zeros_like(emb_in)
        moved = iter([(i.to(where), n.to(where)) for i, n in draws])
        on = pairs.to(where)
        t0 = time.perf_counter()
        losses = text.sgns_loop(emb_in, emb_out, on, moved.__next__,
                                W2V_CPU_STEPS, cfg).cpu()
        walls[where.type] = time.perf_counter() - t0
        out[where.type] = [t.cpu().numpy() for t in (emb_in, emb_out)]
        out[where.type].append(losses.numpy())
    err, ok = _within(zip(out[device.type], out["cpu"]), W2V_TOL)
    return {"steps": W2V_CPU_STEPS, "card_s": walls[device.type],
            "cpu_s": walls["cpu"], "max_abs_err": err, "within_bars": ok}


def _w2v_loop(device) -> dict:
    """13a: `word2vec_fit_pairs` at W2V_V × W2V_K over W2V_PAIRS seeded
    pairs, W2V_STEPS steps: the first fit's wall and peak memory, a second
    fit, one in chunks of W2V_CHUNK and one resumed from W2V_RESUME_AT
    (bitwise against the first); the step's device ms by CUDA events over
    W2V_TIMED_STEPS steps (draws included) and pairs/s; the step's bound
    from the timed steps' draws; the scatter A/B; the card against the
    CPU."""
    import numpy as np
    import torch

    from predictionio_torch.device import synchronize
    from predictionio_torch.ops import text

    rng = np.random.default_rng(13)
    pairs = rng.integers(0, W2V_V, (W2V_PAIRS, 2), dtype=np.int32)
    cfg = _w2v_cfg()
    on_card = device.type == "cuda"

    def fit(cfg=cfg, **kw):
        synchronize(device)
        t = time.perf_counter()
        out = text.word2vec_fit_pairs(pairs, W2V_V, cfg, device=device, **kw)
        synchronize(device)
        return out, time.perf_counter() - t

    if on_card:
        torch.cuda.init()  # the peak counters exist once CUDA is up
        torch.cuda.reset_peak_memory_stats(device)
    first, first_s = fit()
    peak = torch.cuda.max_memory_allocated(device) if on_card else None
    second, second_s = fit()
    with tempfile.TemporaryDirectory() as ckpt:
        chunked, chunked_s = fit(checkpoint_dir=ckpt,
                                 checkpoint_every=W2V_CHUNK)
        chunk_steps = sorted(os.listdir(ckpt))
    with tempfile.TemporaryDirectory() as ckpt:
        fit(cfg=_w2v_cfg(W2V_RESUME_AT), checkpoint_dir=ckpt,
            checkpoint_every=W2V_CHUNK)
        text.reset_sampler_calls()
        resumed, resumed_s = fit(checkpoint_dir=ckpt,
                                 checkpoint_every=W2V_CHUNK)
        resumed_steps = text.sampler_calls["sgns"]

    def same(a, b) -> bool:
        return (np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
                and a[2] == b[2])

    # the step on the card: fresh tables, the fit's sampler, CUDA events
    pairs_dev = torch.from_numpy(pairs).to(device).long()
    emb_in = torch.tensor(first[0], device=device)
    emb_out = torch.tensor(first[1], device=device)
    gen = torch.Generator(device=device).manual_seed(24)
    sampler = text.TorchSampler(gen, W2V_PAIRS, W2V_V, cfg)
    text.sgns_loop(emb_in, emb_out, pairs_dev, sampler, 5, cfg)  # warm-up
    state = gen.get_state()
    synchronize(device)
    if on_card:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    text.sgns_loop(emb_in, emb_out, pairs_dev, sampler, W2V_TIMED_STEPS,
                   cfg)
    if on_card:
        end.record()
    synchronize(device)
    host_ms = (time.perf_counter() - t0) * 1e3 / W2V_TIMED_STEPS
    step_ms = (start.elapsed_time(end) / W2V_TIMED_STEPS if on_card
               else None)
    replay = torch.Generator(device=device)
    replay.set_state(state)
    replayed = text.TorchSampler(replay, W2V_PAIRS, W2V_V, cfg)
    bound = _w2v_bound(pairs_dev, [replayed()
                                   for _ in range(W2V_TIMED_STEPS)])
    del emb_in, emb_out
    return {"shape": {"vocab": W2V_V, "dim": W2V_K, "batch": W2V_B,
                      "negatives": W2V_N, "pairs": W2V_PAIRS,
                      "steps": W2V_STEPS, "learning_rate": W2V_LR},
            "fit_s": first_s, "fit_again_s": second_s,
            "fit_chunked_s": chunked_s, "fit_resumed_s": resumed_s,
            "peak_bytes": peak,
            "loss_first_last": [first[2][0], first[2][-1]],
            "step_ms": step_ms, "step_host_ms": host_ms,
            "pairs_per_s": (W2V_B / step_ms * 1e3 if step_ms else None),
            "bound": bound,
            "bitwise_again": same(first, second),
            "bitwise_chunked": same(first, chunked),
            "bitwise_resumed": same(first, resumed),
            "chunk": W2V_CHUNK, "checkpoint_steps": chunk_steps,
            "resumed_from": W2V_RESUME_AT, "resumed_steps_run": resumed_steps,
            "scatter_ab": _scatter_ab(pairs_dev, device),
            "card_vs_cpu": _w2v_card_cpu(pairs_dev, device)}


def _text_variants(tmp: str) -> dict:
    """13b: the textclassification template scaffolded and built for
    TEXT_APP (its shipped `nb`, numFeatures 1024) and two variants of its
    engine.json beside it, `lr` and `word2vec`: name → engine.json."""
    nb_json = _scaffolded("textclassification", os.path.join(tmp, "Text"),
                          TEXT_APP)
    with open(nb_json) as f:
        variant = json.load(f)
    paths = {"nb": nb_json}
    for name, algo, params in (("lr", "lr", TEXT_LR_PARAMS),
                               ("w2v", "word2vec", TEXT_W2V_PARAMS)):
        variant.update(id=f"text-{name}", algorithms=[
            {"name": algo, "params": params}])
        paths[name] = os.path.join(tmp, "Text", f"engine-{name}.json")
        with open(paths[name], "w") as f:
            json.dump(variant, f, indent=2)
    return paths


def _text_queries(rng, n: int) -> list:
    """`n` queries in the store's words: a few of a category's own words
    and shared ones, some all shared, one empty and one of unseen words."""
    queries = []
    for j in range(n - 2):
        c = int(rng.integers(0, TEXT_CATEGORIES))
        words = [f"w{int(rng.integers(0, 50))}" for _ in range(4)]
        if j % 4:
            words += [f"c{c}w{int(rng.integers(0, 10))}" for _ in range(2)]
        queries.append({"text": " ".join(words)})
    return queries + [{"text": ""}, {"text": "entirely unseen words"}]


def phase_text(report: dict, device, tmp: str, writer, base: str) -> dict:
    """Phase 13: (a) the SGNS loop at benchmarks/w2v_roofline.py's shape,
    (b) the textclassification template on the store that `writer` (the
    child running `write_text_store`) writes under `base`: three `console
    train` variants, their servers and `console eval` of TextEvaluation,
    (c) the two drills. Returns each console child's launch record."""
    import numpy as np

    t_phase = time.perf_counter()
    card = report["card"]
    a_row = _w2v_loop(device)
    emit(dict(phase="text", part="a_loop", card=card, **a_row))
    scatter = a_row["scatter_ab"]
    if not (a_row["bitwise_again"] and a_row["bitwise_chunked"]
            and a_row["bitwise_resumed"]
            and a_row["resumed_steps_run"] == W2V_STEPS - W2V_RESUME_AT
            and a_row["checkpoint_steps"] == [
                f"step_{s}" for s in range(W2V_STEPS - 2 * W2V_CHUNK,
                                           W2V_STEPS + 1, W2V_CHUNK)]
            and scatter["fixed_order_bitwise_repeat"]
            and a_row["card_vs_cpu"]["within_bars"]
            and np.isfinite(a_row["loss_first_last"]).all()):
        raise AssertionError(f"13a: the SGNS loop failed its bars: {a_row}")

    t0 = time.perf_counter()
    written = _await_ratings(writer, base, TEXT_RESULT,
                             "the text store's writer")
    waited_s = time.perf_counter() - t0
    dev = str(device)
    paths = _text_variants(tmp)
    ckpts = {name: os.path.join(tmp, f"text-ckpt-{name}")
             for name in ("w2v", "head")}
    drill_models = {name: os.path.join(tmp, f"text-drill-{name}.pio")
                    for name in ckpts}

    def train(engine_json: str, *extra) -> list:
        return ["train", "--engine-json", engine_json, "--device", dev,
                *extra]

    drills = {name: train(paths["w2v"], "--checkpoint-dir", ckpts[name],
                          "--model-out", drill_models[name])
              for name in ckpts}
    faults = {"w2v": f"w2v.step_boundary:{TEXT_KILL}",
              "head": f"logreg.step_boundary:{TEXT_KILL}"}
    deploys, later = {}, {}
    storage = None
    try:
        # the trains, the two killed drills and the evaluation start
        # together; the evaluation runs on beside the servers
        eval_out = os.path.join(tmp, "text-eval.json")
        t0 = time.perf_counter()
        t_start = {name: t0 for name in (
            "train_nb", "train_lr", "train_w2v", "killed_w2v",
            "killed_head", "eval")}
        later = {"eval": _start_child(
            ["eval", "chip_smoke.TextEvaluation", "--device", dev, "--out",
             eval_out], base)}
        started = {f"train_{name}": _start_child(train(path), base)
                   for name, path in paths.items()}
        started.update({f"killed_{name}": _start_child(
            drills[name], base, {"PIO_FAULTS": faults[name]})
            for name in ckpts})
        done, walls = _finish_together(
            started, t_start, {"killed_w2v": 137, "killed_head": 137}, "13")
        trains_s = time.perf_counter() - t0
        chunk = max(1, TEXT_W2V_PARAMS["steps"] // 10)
        head_chunk = max(1, TEXT_W2V_PARAMS["iterations"] // 10)
        killed = {name: {
            "w2v": sorted(os.listdir(os.path.join(ckpts[name], "w2v"))),
            "w2v-head": sorted(os.listdir(os.path.join(ckpts[name],
                                                       "w2v-head")))
            if os.path.isdir(os.path.join(ckpts[name], "w2v-head"))
            else None} for name in ckpts}
        want_killed = {
            "w2v": {"w2v": [f"step_{chunk * (TEXT_KILL - 1)}"],
                    "w2v-head": None},
            "head": {"w2v": [f"step_{TEXT_W2V_PARAMS['steps'] - chunk * j}"
                             for j in (2, 1, 0)],
                     "w2v-head": [f"step_{head_chunk * (TEXT_KILL - 1)}"]}}
        for name in ckpts:
            err = done[f"killed_{name}"][1]
            if (f"dying at {faults[name].split(':')[0]}" not in err
                    or killed[name] != want_killed[name]):
                raise AssertionError(
                    f"13c: the killed {name} train did not die at its step "
                    f"boundary ({killed[name]}):\n{err[-3000:]}")
        rows = {}
        for name in paths:
            _, err, rec = done[f"train_{name}"]
            rows[name] = dict(_stage_seconds(err), wall_s=walls[f"train_{name}"],
                              launches=rec["by_rank"],
                              sgns_steps=rec["sgns_steps"])
            report.setdefault("text_log", {})[name] = err.splitlines()[-30:]
        docs = [_count_logged(done[f"train_{name}"][1],
                              r"DataSource: (\d+) documents, (\d+) "
                              r"categories") for name in paths]
        w2v_log = _count_logged(done["train_w2v"][1],
                                r"word2vec_train: vocab (\d+), (\d+) pairs")
        want_docs = [written["documents"], TEXT_CATEGORIES]
        if (docs != [want_docs] * len(paths) or len(w2v_log) != 2
                or rows["w2v"]["sgns_steps"] != TEXT_W2V_PARAMS["steps"]):
            raise AssertionError(f"13b: the trains read {docs} documents "
                                 f"and ran {rows['w2v']['sgns_steps']} SGNS "
                                 f"steps; the writer wrote {written}")

        # the servers and the resumed drills, beside the evaluation
        launch_paths = {name: os.path.join(tmp, f"text-{name}.json")
                        for name in paths}
        deploys = {name: _start_deploy(
            ["--engine-json", path, "--ip", "127.0.0.1", "--port", "0",
             "--device", dev], {"PIO_FS_BASEDIR": base}, launch_paths[name])
            for name, path in paths.items()}
        t0 = time.perf_counter()
        for name in ckpts:
            t_start[f"resumed_{name}"] = t0
            later[f"resumed_{name}"] = _start_child(drills[name], base)
        urls = {}
        for name, proc in deploys.items():
            line = _read_deployed_line(proc, 300.0)
            urls[name] = f"http://127.0.0.1:{int(line.rsplit(':', 1)[1])}"
        ready_s = time.perf_counter() - t0
        queries = _text_queries(np.random.default_rng(15), TEXT_QUERIES)
        storage = _store_at(base)
        served = {}
        for name, path in paths.items():
            served[name] = _served_equal(urls[name], queries,
                                         _latest_model(storage, path))
        finished, later_walls = _finish_together(later, t_start, {}, "13")
        done.update(finished)
        walls.update(later_walls)
        later_s = time.perf_counter() - t0
        uninterrupted = storage.model_data_models().get(
            _completed_instance(base, paths["w2v"])).models
    finally:
        for proc in list(deploys.values()) + list(later.values()):
            if proc.poll() is None:
                _stop(proc)
        if storage is not None:
            storage.close()
    for name, path in launch_paths.items():
        with open(path) as f:
            done[f"deploy_{name}"] = (None, None, json.load(f))
    for name in paths:
        emit(dict(phase="text", part="b_template", card=card,
                  algorithm=name, documents=docs[0][0], store=written,
                  waited_s=waited_s, trains_s=trains_s, **rows[name],
                  w2v_vocab_pairs=w2v_log if name == "w2v" else None,
                  serve=served[name], ready_s=ready_s))
    with open(eval_out) as f:
        record = json.load(f)
    results = json.loads(record["evaluator_results_json"])
    accuracies = [{"lambda": r["engineParams"]["algorithms"][0]["params"].get(
                       "lambda", r["engineParams"]["algorithms"][0][
                           "params"].get("lambda_")),
                   "accuracy": r["scores"]["Accuracy"]}
                  for r in results["results"]]
    emit({"phase": "text", "part": "b_eval", "card": card,
          "status": record["status"], "folds": TEXT_EVAL_K,
          "accuracies": accuracies, "best": results["bestScore"],
          "wall_s": walls["eval"],
          "launches": done["eval"][2]["by_rank"]})
    c_row = {}
    for name in ckpts:
        with open(drill_models[name], "rb") as f:
            resumed_models = pickle.load(f)["models"]
        err = done[f"resumed_{name}"][1]
        c_row[name] = {
            "fault": faults[name], "after_kill": killed[name],
            "w2v_resumed_from": _count_logged(
                err, r"word2vec_train: resumed from checkpoint step (\d+)"),
            "head_resumed_from": _count_logged(
                err, r"logreg_train: resumed from checkpoint step (\d+)"),
            "sgns_steps_after_resume": done[f"resumed_{name}"][2][
                "sgns_steps"],
            "killed_wall_s": walls[f"killed_{name}"],
            "resumed_wall_s": walls[f"resumed_{name}"],
            "model_bytes": len(resumed_models),
            "model_bytes_equal": resumed_models == uninterrupted}
    emit(dict(phase="text", part="c_drills", card=card, later_s=later_s,
              **c_row))
    bad = [name for name, row in served.items()
           if row["equal"] != row["queries"]]
    if bad or record["status"] != "EVALCOMPLETED" or not all(
            a["accuracy"] > 0.5 for a in accuracies):
        raise AssertionError(f"13b: served answers differ in {bad}, or the "
                             f"evaluation failed: {accuracies}")
    steps = TEXT_W2V_PARAMS["steps"]
    want_c = {"w2v": ([chunk * (TEXT_KILL - 1)], [],
                      steps - chunk * (TEXT_KILL - 1)),
              "head": ([steps], [head_chunk * (TEXT_KILL - 1)], 0)}
    wrong = {name: row for name, row in c_row.items()
             if (row["w2v_resumed_from"], row["head_resumed_from"],
                 row["sgns_steps_after_resume"]) != want_c[name]
             or not row["model_bytes_equal"]}
    if wrong:
        raise AssertionError(f"13c: a drill did not resume to the "
                             f"uninterrupted model: {wrong}")
    wall = time.perf_counter() - t_phase
    emit({"phase": "text", "wall_s": wall, "card": card})
    report["text"] = {"a": a_row, "b": {"store": written, "trains": rows,
                                        "served": served,
                                        "eval": accuracies},
                      "c": c_row, "wall_s": wall}
    return {name: rec for name, (_, _, rec) in done.items()
            if rec is not None}


# -- phase 14: the basket ops and the complementarypurchase template --------

RULE_FIELDS = ("cond_items", "cons_items", "scores", "support", "confidence",
               "lift")


def _basket_data(n_items: int, n_baskets: int, n_bots: int, seed: int):
    """(basket idx, item idx) int32 purchases: each basket 1 +
    Poisson(BASKET_MEAN) items drawn Zipf (p ∝ 1/rank, so repeats occur),
    and `n_bots` baskets given besides BASKET_BOT_SIZES distinct items
    (at most the catalog) and a quarter as many repeats of them."""
    import numpy as np

    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, n_items + 1)
    sizes = 1 + rng.poisson(BASKET_MEAN, n_baskets)
    b = [np.repeat(np.arange(n_baskets), sizes)]
    i = [rng.choice(n_items, len(b[0]), p=p / p.sum())]
    hi = min(BASKET_BOT_SIZES[1], n_items)
    for bot in rng.choice(n_baskets, n_bots, replace=False):
        distinct = rng.choice(n_items, int(rng.integers(
            min(BASKET_BOT_SIZES[0], hi), hi + 1)), replace=False)
        items = np.concatenate([distinct,
                                rng.choice(distinct, len(distinct) // 4)])
        b.append(np.full(len(items), bot))
        i.append(items)
    return (np.concatenate(b).astype(np.int32),
            np.concatenate(i).astype(np.int32))


def _exact_counts(b, i, n_baskets: int, n_items: int, cap: int) -> tuple:
    """An independent count of C: (basket, item) pairs deduped, each
    basket cut to its `cap` lowest item ids, then every ordered pair of
    one basket's items (its diagonal included) enumerated with numpy and
    counted by `np.bincount`. Returns (C as int64 [n_items, n_items], the
    pairs enumerated, the largest support of an item inside one
    BASKET_CHUNK-basket chunk)."""
    import numpy as np

    key = np.unique(b.astype(np.int64) * n_items + i)
    bb, ii = key // n_items, key % n_items
    k = np.bincount(bb, minlength=n_baskets)
    start = np.cumsum(k) - k
    keep = np.arange(len(bb)) - start[bb] < cap
    bb, ii = bb[keep], ii[keep]
    k = np.bincount(bb, minlength=n_baskets)
    start = np.cumsum(k) - k
    per = k[bb]  # an entry pairs with every entry of its basket
    first = np.repeat(np.arange(len(bb)), per)
    second = start[bb[first]] + np.arange(len(first)) - np.repeat(
        np.cumsum(per) - per, per)
    counts = np.bincount(ii[first] * n_items + ii[second],
                         minlength=n_items * n_items)
    chunk_support = np.bincount((bb // BASKET_CHUNK) * n_items + ii).max()
    return (counts.reshape(n_items, n_items), int(len(first)),
            int(chunk_support))


def _rules_equal(a, b) -> bool:
    """Every BasketRules array of `a` and `b` the same bits (and dtype)."""
    import numpy as np

    return a.n_baskets == b.n_baskets and all(
        getattr(a, f).dtype == getattr(b, f).dtype
        and np.array_equal(getattr(a, f), getattr(b, f)) for f in RULE_FIELDS)


def _gram_alternatives(walk_d, n_items: int, C, device) -> dict:
    """14a: the Gram by the other exact formulations of `cooccurrence_
    matrix`'s docstring, each timed once by CUDA events over the whole
    walk and held against C: int8 → int32 one chunk a GEMM
    (GROUP_BYTES 1), an f32 GEMM a chunk (TF32 off) and, on CUDA, bf16
    inputs with an f32 output (`out_dtype`) a chunk, cuBLAS's bf16
    reduced-precision reduction turned off around it. {name: (ms, C
    equal)}; bf16 None off CUDA."""
    import numpy as np
    import torch

    from predictionio_torch.ops import basket

    rows, cols, valid = walk_d
    n_pad = max(24, -(-n_items // 8) * 8)

    def per_chunk(dtype, mm):
        one = torch.ones((), dtype=dtype, device=device)
        acc = torch.zeros((n_pad, n_pad), dtype=torch.float32, device=device)
        for c in range(rows.shape[0]):
            m = torch.zeros((n_pad + 1, BASKET_CHUNK), dtype=dtype,
                            device=device)
            item = torch.where(valid[c], cols[c].long(), n_pad)
            m.index_put_((item, rows[c].long()), one)
            m = m[:n_pad]
            acc += mm(m, m.t())
        return acc

    def one_chunk_a_gemm():
        old, basket.GROUP_BYTES = basket.GROUP_BYTES, 1
        try:
            return basket._gram(rows, cols, valid, n_items, BASKET_CHUNK)
        finally:
            basket.GROUP_BYTES = old

    matmul = torch.backends.cuda.matmul

    def bf16_out_f32():
        flag = matmul.allow_bf16_reduced_precision_reduction
        matmul.allow_bf16_reduced_precision_reduction = False
        try:
            return per_chunk(torch.bfloat16, lambda a, b: torch.mm(
                a, b, out_dtype=torch.float32))
        finally:
            matmul.allow_bf16_reduced_precision_reduction = flag

    runs = {"int8_one_chunk_a_gemm": one_chunk_a_gemm,
            "f32_a_chunk": lambda: per_chunk(torch.float32, torch.mm),
            "bf16_out_f32_a_chunk": bf16_out_f32}
    out = {}
    for name, fn in runs.items():
        if name.startswith("bf16") and device.type != "cuda":
            out[name] = None
            continue
        got = []
        ms = time_ms(lambda: got.append(fn()), 1, warmup=0)
        out[name] = (ms, bool(np.array_equal(
            got[-1][:n_items, :n_items].float().cpu().numpy(), C)))
        del got
    return out


def _basket_gram(device) -> dict:
    """14a at BASKET_ITEMS × BASKET_BASKETS: `mine_rules` with the
    template's defaults (wall, peak memory, its log: the dense path's
    cap warning and no host fallback), then the same call in its pieces
    (host pre-pass, upload, the Gram by the host's clock and by CUDA
    events over BASKET_GRAM_REPS calls, C's copy back, the host rule
    pass) whose rules must equal the first's bit for bit, the Gram's
    other formulations (`_gram_alternatives`); C against `_exact_counts`
    entry for entry; the bound of the Gram."""
    import numpy as np
    import torch

    from predictionio_torch.device import synchronize
    from predictionio_torch.ops import basket

    n_items, n_baskets = BASKET_ITEMS, BASKET_BASKETS
    t0 = time.perf_counter()
    b, i = _basket_data(n_items, n_baskets, BASKET_BOTS, 14)
    data_s = time.perf_counter() - t0
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.init()  # the peak counters exist once CUDA is up
        torch.cuda.reset_peak_memory_stats(device)
    with _Lines(basket.__name__) as logged:
        t0 = time.perf_counter()
        first = basket.mine_rules(b, i, n_baskets, n_items, device=device,
                                  **BASKET_RULES)
        whole_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) if on_card else None
    dense = (logged.lines == [f"cooccurrence_matrix: truncating "
                              f"{BASKET_BOTS} basket(s) larger than "
                              f"{BASKET_CAP} distinct items"])

    t0 = time.perf_counter()
    b_sorted, i_sorted = basket._dedup_and_cap(b, i, n_baskets, BASKET_CAP,
                                               "chip_smoke")
    walk = basket._chunk_walk(b_sorted, i_sorted, n_baskets, BASKET_CHUNK)
    prepass_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    walk_d = [torch.from_numpy(a).to(device) for a in walk]
    synchronize(device)
    upload_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    acc = basket._gram(*walk_d, n_items, BASKET_CHUNK)
    synchronize(device)
    gram_host_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    C = acc[:n_items, :n_items].float().cpu().numpy()
    copy_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    second = basket._rules_from_dense(C, n_baskets, *BASKET_RULES.values())
    rules_s = time.perf_counter() - t0
    del acc
    gram_ms = time_ms(lambda: basket._gram(*walk_d, n_items, BASKET_CHUNK),
                      BASKET_GRAM_REPS, warmup=0)
    alternatives = _gram_alternatives(walk_d, n_items, C, device)

    t0 = time.perf_counter()
    exact, n_pairs, chunk_support = _exact_counts(b, i, n_baskets, n_items,
                                                  BASKET_CAP)
    exact_s = time.perf_counter() - t0
    # the Gram's least work on these inputs: 2·baskets·items² int8
    # operations; each walk entry read once and C written once (f32)
    ops = 2.0 * n_baskets * n_items * n_items
    moved = sum(a.nbytes for a in walk) + 4 * n_items * n_items
    t_bytes = moved / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_INT8_OPS * 1e3
    k_chunk = -(-BASKET_CHUNK // 8) * 8
    return {
        "items": n_items, "baskets": n_baskets,
        "purchases": int(len(b)), "deduped_capped": int(len(b_sorted)),
        "walk": list(walk[0].shape), "data_s": data_s,
        "mine_rules_s": whole_s, "peak_bytes": peak, "dense_path": dense,
        "logged": logged.lines[:5],
        "rules": int((first.cons_items >= 0).sum()),
        "cond_items": int(len(first.cond_items)),
        "split_s": {"prepass": prepass_s, "upload": upload_s,
                    "gram": gram_host_ms / 1e3, "copy_back": copy_s,
                    "rules": rules_s},
        "gram_ms": gram_ms, "gram_host_ms": gram_host_ms,
        "alternatives": alternatives,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bound_bf16_ms": ops / PEAK_BF16_FLOPS * 1e3,
        "bound_f32_ms": ops / PEAK_FP32_FLOPS * 1e3,
        "gemm_operations": 2.0 * len(walk[0]) * k_chunk
        * (-(-n_items // 8) * 8) ** 2,
        "operations": ops, "bytes": moved,
        "rules_bitwise_again": _rules_equal(first, second),
        "c_equals_exact": bool(np.array_equal(C, exact)),
        "exact_pairs": n_pairs, "exact_s": exact_s,
        "c_max_offdiag": float((C - np.diag(np.diag(C))).max()),
        "c_entries_over_256": int((C > 256).sum()),
        "max_chunk_support": chunk_support}


def _basket_card_cpu(device) -> dict:
    """14a: at BASKET_CPU_SHAPE, the card's C and rules against the
    CPU's (bitwise); at BASKET_FALLBACK_SHAPE, `max_dense_items=1` (the
    host fallback, logged) against the dense path: the same condition
    items, and each one's consequents and scores to 5 decimals (the
    reference's own bar), with whether every array is equal."""
    import numpy as np

    from predictionio_torch.ops import basket

    n_items, n_baskets, bots = BASKET_CPU_SHAPE
    b, i = _basket_data(n_items, n_baskets, bots, 15)
    grams, rules, secs = {}, {}, {}
    for where in (device, "cpu"):
        t0 = time.perf_counter()
        grams[str(where)] = basket.cooccurrence_matrix(
            b, i, n_baskets, n_items, device=where)
        rules[str(where)] = basket.mine_rules(b, i, n_baskets, n_items,
                                              device=where, **BASKET_RULES)
        secs[str(where)] = time.perf_counter() - t0
    card, cpu = str(device), "cpu"
    n_items, n_baskets, bots = BASKET_FALLBACK_SHAPE
    b, i = _basket_data(n_items, n_baskets, bots, 16)
    kw = dict(BASKET_RULES, min_support=0.0, min_lift=0.0)
    dense = basket.mine_rules(b, i, n_baskets, n_items, device=device, **kw)
    with _Lines(basket.__name__) as logged:
        host = basket.mine_rules(b, i, n_baskets, n_items, device=device,
                                 max_dense_items=1, **kw)
    same_rows = np.array_equal(dense.cond_items, host.cond_items) and all(
        {(int(j), round(float(s), 5)) for j, s in zip(
            dense.cons_items[r], dense.scores[r]) if j >= 0}
        == {(int(j), round(float(s), 5)) for j, s in zip(
            host.cons_items[r], host.scores[r]) if j >= 0}
        for r in range(len(dense.cond_items)))
    return {"shape": list(BASKET_CPU_SHAPE),
            "c_bitwise": bool(np.array_equal(grams[card], grams[cpu])),
            "rules_bitwise": _rules_equal(rules[card], rules[cpu]),
            "rules": int((rules[cpu].cons_items >= 0).sum()),
            "card_s": secs[card], "cpu_s": secs[cpu],
            "fallback_shape": list(BASKET_FALLBACK_SHAPE),
            "fallback_logged": any("sparse host count" in line
                                   for line in logged.lines),
            "fallback_rules": int((host.cons_items >= 0).sum()),
            "fallback_same_rules": bool(same_rows),
            "fallback_arrays_equal": _rules_equal(dense, host)}


def _basket_events(n_events: int, n_users: int, n_items: int, rng) -> tuple:
    """14b's `buy` events: baskets of 1 + Poisson(BASKET_MEAN) Zipf-drawn
    items (the last cut at `n_events`), each of a random user; a user's
    k-th basket starts k·BASKET_SPACING s after the start (plus up to
    half an hour), its purchases 60-300 s apart, so that only the
    baskets' gaps pass the template's basketWindow. Returns (the event
    dicts, the baskets)."""
    import numpy as np

    sizes = 1 + rng.poisson(BASKET_MEAN, n_events // BASKET_MEAN + 16)
    sizes = sizes[:int(np.searchsorted(np.cumsum(sizes), n_events)) + 1]
    sizes[-1] -= int(sizes.sum()) - n_events
    users = rng.integers(0, n_users, len(sizes))
    order = np.argsort(users, kind="stable")
    nth = np.empty(len(sizes), np.int64)  # the basket's rank in its user's
    nth[order] = np.arange(len(sizes)) - np.searchsorted(users[order],
                                                         users[order])
    p = 1.0 / np.arange(1, n_items + 1)
    items = rng.choice(n_items, n_events, p=p / p.sum())
    basket = np.repeat(np.arange(len(sizes)), sizes)
    start = nth * BASKET_SPACING + rng.integers(0, 1_800, len(sizes))
    offsets = rng.integers(60, 301, n_events)
    first = np.cumsum(sizes) - sizes
    offsets[first] = 0
    seconds = start[basket] + np.cumsum(offsets) - np.repeat(
        np.cumsum(offsets)[first], sizes)
    t0 = datetime(2026, 4, 1, tzinfo=timezone.utc)
    events = [{"event": "buy", "entityType": "user",
               "entityId": f"u{users[bk]}", "targetEntityType": "item",
               "targetEntityId": f"i{it}", "eventTime": _stamp(t0, int(t))}
              for bk, it, t in zip(basket, items, seconds)]
    return events, len(sizes)


def write_basket_store(base: str, scale: str) -> None:
    """14, in a writer child started with the run: BASKET_APP's purchases
    (`_basket_events`) at BASKET_SCALES[scale], written as a JSON-lines
    file and `console import`ed (the native importer) into a sqlite
    pio.db under `base`, the file deleted after; then BASKET_RESULT under
    `base`: the counts and the file's and the import's seconds."""
    import numpy as np

    from predictionio_torch.tools import console

    t_start = time.perf_counter()
    n_events, n_users, n_items = BASKET_SCALES[scale]
    events, n_baskets = _basket_events(n_events, n_users, n_items,
                                       np.random.default_rng(14))
    os.environ["PIO_FS_BASEDIR"] = base
    path = os.path.join(base, f"{BASKET_APP}.jsonl")
    t0 = time.perf_counter()
    with open(path, "w") as f:
        for event in events:
            f.write(json.dumps(event) + "\n")
    file_s = time.perf_counter() - t0
    with contextlib.redirect_stdout(io.StringIO()) as said:
        if console.main(["app", "new", BASKET_APP]) != 0:
            raise AssertionError(f"console app new {BASKET_APP} failed")
        t0 = time.perf_counter()
        if console.main(["import", "--appname", BASKET_APP, "--input",
                         path]) != 0:
            raise AssertionError(f"console import of {BASKET_APP} failed")
        import_s = time.perf_counter() - t0
    os.unlink(path)
    imported = said.getvalue().strip().splitlines()[-1]
    if imported != f"Imported {n_events} events.":
        raise AssertionError(f"console import said {imported!r}")
    row = {"scale": scale, "events": n_events, "users": n_users,
           "items": n_items, "baskets": n_baskets, "file_s": file_s,
           "import_s": import_s, "write_s": time.perf_counter() - t_start}
    with open(os.path.join(base, BASKET_RESULT), "w") as f:
        json.dump(row, f)


def _basket_queries(rng, n: int, n_items: int) -> list:
    """`n` carts of 1-3 items (every other one among the 50 commonest),
    every seventh with an unknown item besides, `num` 1-10."""
    queries = []
    for j in range(n):
        top = 50 if j % 2 else n_items
        items = [f"i{int(rng.integers(0, top))}"
                 for _ in range(int(rng.integers(1, 4)))]
        if j % 7 == 0:
            items.append(f"unknown{j}")
        queries.append({"items": items, "num": int(rng.integers(1, 11))})
    return queries


def phase_basket(report: dict, device, tmp: str, writer, base: str) -> dict:
    """Phase 14: (b) `console template get` and `build` of
    complementarypurchase on the store that `writer` (the child running
    `write_basket_store`) writes under `base`, its `console train`
    started in a child, then (a) in this process meanwhile, then (b) its
    `console deploy` and BASKET_QUERIES queries against the in-process
    answers. Returns each console child's launch record."""
    import numpy as np

    t_phase = time.perf_counter()
    card = report["card"]
    written = _await_ratings(writer, base, BASKET_RESULT,
                             "the basket store's writer")
    waited_s = time.perf_counter() - t_phase
    engine_json = _scaffolded("complementarypurchase",
                              os.path.join(tmp, "Cart"), BASKET_APP)
    dev = str(device)
    t0 = time.perf_counter()
    started = {"train": _start_child(["train", "--engine-json", engine_json,
                                      "--device", dev], base)}
    a_row = _basket_gram(device)
    emit(dict(phase="basket", part="a_gram", card=card, **a_row))
    a_cpu = _basket_card_cpu(device)
    emit(dict(phase="basket", part="a_card_cpu", card=card, **a_cpu))
    if not (a_row["c_equals_exact"] and a_row["dense_path"]
            and a_row["rules_bitwise_again"] and a_row["rules"] > 0
            and a_cpu["c_bitwise"] and a_cpu["rules_bitwise"]
            and a_cpu["fallback_logged"] and a_cpu["fallback_same_rules"]
            and a_cpu["fallback_rules"] > 0):
        raise AssertionError(f"14a: the Gram or the rules failed their "
                             f"bars: {a_row} {a_cpu}")
    done, walls = _finish_together(started, {"train": t0}, {}, "14")
    _, err, train_rec = done["train"]
    stages = _stage_seconds(err)
    read = _count_logged(err, r"DataSource: (\d+) buy events")
    prepared = _count_logged(err, r"Preparator: (\d+) baskets over (\d+) "
                                  r"purchases \((\d+) items\)")
    mined = _count_logged(err, r"AssociationAlgorithm: (\d+) rules over "
                               r"(\d+) condition items")
    if (read != [written["events"]] or prepared[:1] != [written["baskets"]]
            or not mined or mined[0] <= 0):
        raise AssertionError(f"14b: the train read {read} events into "
                             f"{prepared} baskets and mined {mined}; the "
                             f"writer wrote {written}")
    launch_path = os.path.join(tmp, "basket-deploy.json")
    deploy = _start_deploy(["--engine-json", engine_json, "--ip",
                            "127.0.0.1", "--port", "0", "--device", dev],
                           {"PIO_FS_BASEDIR": base}, launch_path)
    storage = None
    try:
        t0 = time.perf_counter()
        line = _read_deployed_line(deploy, 300.0)
        ready_s = time.perf_counter() - t0
        url = f"http://127.0.0.1:{int(line.rsplit(':', 1)[1])}"
        queries = _basket_queries(np.random.default_rng(14), BASKET_QUERIES,
                                  written["items"])
        storage = _store_at(base)
        predict = _latest_model(storage, engine_json)
        served = _served_equal(url, queries, predict)
        served["answered"] = sum(bool(predict(q)["rules"]) for q in queries)
    finally:
        _stop(deploy)
        if storage is not None:
            storage.close()
    with open(launch_path) as f:
        deploy_rec = json.load(f)
    b_row = dict(stages, wall_s=walls["train"], store=written,
                 waited_s=waited_s, events=read[0], baskets=prepared[0],
                 purchases=prepared[1], items=prepared[2], rules=mined[0],
                 cond_items=mined[1], ready_s=ready_s, serve=served)
    emit(dict(phase="basket", part="b_template", card=card, **b_row))
    if served["equal"] != served["queries"] or served["answered"] < 10:
        raise AssertionError(f"14b: served answers differ from the "
                             f"in-process model's: {served}")
    wall = time.perf_counter() - t_phase
    emit({"phase": "basket", "wall_s": wall, "card": card})
    report["basket"] = {"a": a_row, "a_card_cpu": a_cpu, "b": b_row,
                        "log": err.splitlines()[-30:], "wall_s": wall}
    return {"train": train_rec, "deploy": deploy_rec}


# -- phase 15 ----------------------------------------------------------------

def _session_inputs(v: int, d: int, n_blocks: int, l: int, b: int, seed: int):
    """15a's inputs: the template's seeded init (V v, D d, n_blocks
    blocks, a positional table of l rows) and b histories of 1..l
    distinct items, right-padded with the pad row v (the first of length
    1, the second of l)."""
    import numpy as np

    from predictionio_torch.templates.sessionrec import engine as sessionrec

    rng = np.random.default_rng(seed)
    params = sessionrec.init_params(v, d, n_blocks, l, rng)
    lengths = rng.integers(1, l + 1, b).astype(np.int32)
    lengths[:2] = (1, l)
    seq = np.full((b, l), v, np.int32)
    for r, n in enumerate(lengths):
        seq[r, :n] = rng.choice(v, int(n), replace=False)
    return params, seq, lengths


def session_encode_work(lengths, d: int, n_blocks: int, n_heads: int,
                        l: int) -> tuple[float, float]:
    """(bytes, FP32 operations) the encoder's function needs on these
    histories: each history's n = clamp(length, 1, l) embedding and
    positional rows, its n ids, its length, every block's weights once
    and the [B, D] output; per block and history 16·n·D² (the six
    products), 4·D·T (scores and weighted values over the T = n(n+1)/2
    causal pairs), 5·H·T (max, subtract, exp, sum, divide) and 7·n·D
    (bias, relu and residual adds), plus n·D for the positional add."""
    import numpy as np

    n = np.clip(np.asarray(lengths, np.int64), 1, l)
    t = n * (n + 1) // 2
    per_block = 16 * n * d * d + 4 * d * t + 5 * n_heads * t + 7 * n * d
    ops = float((n_blocks * per_block + n * d).sum())
    weights = n_blocks * (8 * d * d + 3 * d)
    nbytes = 4.0 * (2 * n.sum() * d + n.sum() + len(n) + weights
                    + len(n) * d)
    return nbytes, ops


def device_ms_per_call(fn, calls: int, want: str = "",
                       tries: int = 3) -> tuple:
    """`fn` run `calls` times under torch.profiler (after one warm call):
    the device's time a call (every kernel, copy and set) and each
    kernel's ms a launch with its launch count, from `key_averages()`.
    A window whose trace holds no device row, or none whose name holds
    `want`, is run again, up to `tries` windows (CUPTI has returned such
    windows on an H100); then (None, {})."""
    import torch

    from predictionio_torch.tools.profile_train import device_time_by_kernel

    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for _ in range(tries):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        rows = device_time_by_kernel(prof)
        if any(want in r["name"] for r in rows):
            return (sum(r["device_ms"] for r in rows) / calls,
                    {r["name"]: (r["device_ms"] / r["calls"], r["calls"])
                     for r in rows})
    return None, {}


def _session_kernels(device) -> dict:
    """15a: `session_encode` and `session_readout` against their plain
    versions and their first versions (`_v1`) on the same card tensors,
    for each (D, blocks) of SESSION_CONFIGS at V SESSION_V: every seq tier
    of the default ladder and of PIO_SERVING_SEQ_TIERS=5,12 (each with the
    top tier), every batch tier of SESSION_BATCH_TIERS (the rows whose
    history fits the seq tier, repeated to fill the batch). Bars: within
    SESSION_TOL of the plain versions; bitwise the `_v1` kernels'; `score`
    (the launch pair) bitwise the two kernels launched apart; and every
    row's scores and state bitwise the same history's scored alone at its
    smallest default tier. The same bars (every row checked alone: four
    rows of each) at each (B, L) of SESSION_WIDE, whose plans must take
    the branches it names. Then, at the template's width [64, 32, 16,
    8 192], each kernel beside its `_v1` kernel and its yardstick (the BLAS
    formulation: `encode` + the last position; `torch.matmul`) in turns
    (v1, new, yardstick, yardstick, new, v1): ms a call by CUDA events
    over SESSION_REPS calls, and device ms a launch by torch.profiler;
    its plain version's ms and its bound; and one query of 8 items at
    seq tier 8 and batch tier 1 through `score` beside the `_v1` pair."""
    import numpy as np
    import torch

    from predictionio_torch.ops import session
    from predictionio_torch.serving.batcher import pad_to_seq_tier

    b_max = max(SESSION_BATCH_TIERS)
    checks, bitwise_misses, tol_misses = 0, [], []
    v1_misses, pair_misses = [], []
    max_err = {"session_encode": 0.0, "session_readout": 0.0}
    ladders = sorted({t for ladder in SESSION_LADDERS for t in ladder})
    for d, n_blocks in SESSION_CONFIGS:
        params, seq, lengths = _session_inputs(SESSION_V, d, n_blocks,
                                               SESSION_L, b_max, d + n_blocks)
        p = session.params_on(params, device)
        items = p["emb"][:-1]

        def run(rows, tier):
            s = np.full((len(rows), tier), SESSION_V, np.int32)
            for j, r in enumerate(rows):
                s[j, :lengths[r]] = seq[r, :lengths[r]]
            s_t = torch.tensor(s, device=device)
            l_t = torch.tensor(lengths[rows], device=device)
            h = session.session_encode(p["emb"], p["pos"], p["packed"],
                                       n_blocks, s_t, l_t, SESSION_HEADS)
            return h, session.session_readout(h, items), s_t, l_t

        singles = [tuple(t[0] for t in run(
            [r], pad_to_seq_tier(int(lengths[r]), SESSION_LADDERS[0]))[:2])
            for r in range(b_max)]
        for tier in ladders:
            fits = [r for r in range(b_max) if lengths[r] <= tier]
            for bt in SESSION_BATCH_TIERS:
                rows = (fits * (bt // len(fits) + 1))[:bt]
                h, scores, s_t, l_t = run(rows, tier)
                h_plain = session.session_encode_plain(p, s_t, l_t,
                                                       SESSION_HEADS)
                s_plain = session.session_readout_plain(h, items)
                for name, got, want in (("session_encode", h, h_plain),
                                        ("session_readout", scores,
                                         s_plain)):
                    max_err[name] = max(max_err[name], float(
                        (got - want).abs().max()))
                    if not torch.allclose(got, want, **SESSION_TOL):
                        tol_misses.append((name, d, n_blocks, tier, bt))
                h1 = session.session_encode_v1(p["emb"], p["pos"],
                                               p["packed"], n_blocks, s_t,
                                               l_t, SESSION_HEADS)
                if not (torch.equal(h, h1) and torch.equal(
                        scores, session.session_readout_v1(h1, items))):
                    v1_misses.append((d, n_blocks, tier, bt))
                if not torch.equal(scores, session.score(p, s_t, l_t,
                                                         SESSION_HEADS)):
                    pair_misses.append((d, n_blocks, tier, bt))
                for j, r in enumerate(rows):
                    if not (torch.equal(h[j], singles[r][0])
                            and torch.equal(scores[j], singles[r][1])):
                        bitwise_misses.append((d, n_blocks, tier, bt, r))
                checks += 1
    # past the batch and warp tiers: the plans' B- and L-dependent branches
    limits = session.card_limits(torch.cuda.current_device())
    wide = []
    for b, l in SESSION_WIDE:
        params, seq, lengths = _session_inputs(SESSION_V, SESSION_D, 1, l, b,
                                               b + l)
        p = session.params_on(params, device)
        items = p["emb"][:-1]
        s_t = torch.tensor(seq, device=device)
        l_t = torch.tensor(lengths, device=device)
        plan = session.launch_plan(b, l, SESSION_D, SESSION_HEADS, SESSION_V,
                                   1, *limits)
        wide.append(dict(b=b, l=l, body=plan.body, histories=plan.histories,
                         rd_rows=plan.rd_rows))
        h = session.session_encode(p["emb"], p["pos"], p["packed"], 1, s_t,
                                   l_t, SESSION_HEADS)
        scores = session.session_readout(h, items)
        for name, got, want in (
                ("session_encode", h, session.session_encode_plain(
                    p, s_t, l_t, SESSION_HEADS)),
                ("session_readout", scores,
                 session.session_readout_plain(h, items))):
            max_err[name] = max(max_err[name], float(
                (got - want).abs().max()))
            if not torch.allclose(got, want, **SESSION_TOL):
                tol_misses.append((name, SESSION_D, 1, l, b))
        h1 = session.session_encode_v1(p["emb"], p["pos"], p["packed"], 1,
                                       s_t, l_t, SESSION_HEADS)
        if not (torch.equal(h, h1) and torch.equal(
                scores, session.session_readout_v1(h1, items))):
            v1_misses.append((SESSION_D, 1, l, b))
        if not torch.equal(scores, session.score(p, s_t, l_t,
                                                 SESSION_HEADS)):
            pair_misses.append((SESSION_D, 1, l, b))
        for r in (0, 1, b // 2, b - 1):
            alone = session.score(p, s_t[r:r + 1], l_t[r:r + 1],
                                  SESSION_HEADS)[0]
            if not torch.equal(scores[r], alone):
                bitwise_misses.append((SESSION_D, 1, l, b, r))
        checks += 1
    wide_taken = (any(w["body"] == "warp" and w["histories"] > 1
                      for w in wide)
                  and {32, 64} <= {w["rd_rows"] for w in wide}
                  and any(w["body"] == "block" for w in wide))
    # times at the template's width, the batch and seq tiers' tops
    params, seq, lengths = _session_inputs(SESSION_V, SESSION_D, 1,
                                           SESSION_L, b_max, 99)
    p = session.params_on(params, device)
    items = p["emb"][:-1]
    s_t = torch.tensor(seq, device=device)
    l_t = torch.tensor(lengths, device=device)
    idx = (l_t.long() - 1).clamp(0, SESSION_L - 1)
    rows_t = torch.arange(b_max, device=device)
    h = session.session_encode(p["emb"], p["pos"], p["packed"], 1, s_t, l_t,
                               SESSION_HEADS)
    # one query of 8 items at seq tier 8 and batch tier 1 (the second
    # history, of length 8)
    single = _session_inputs(SESSION_V, SESSION_D, 1, 8, 2, 98)
    p1 = session.params_on(single[0], device)
    s1 = torch.tensor(single[1][1:], device=device)
    l1 = torch.tensor(single[2][1:], device=device)

    def pair_v1():
        h1 = session.session_encode_v1(p1["emb"], p1["pos"], p1["packed"], 1,
                                       s1, l1, SESSION_HEADS)
        return session.session_readout_v1(h1, p1["emb"][:-1])

    # (v1, new, yardstick) a kernel; the kernels by their names in the
    # profile
    trio = {
        "session_encode": (
            lambda: session.session_encode_v1(
                p["emb"], p["pos"], p["packed"], 1, s_t, l_t, SESSION_HEADS),
            lambda: session.session_encode(
                p["emb"], p["pos"], p["packed"], 1, s_t, l_t, SESSION_HEADS),
            lambda: session.encode(p, s_t, SESSION_HEADS)[rows_t, idx]),
        "session_readout": (
            lambda: session.session_readout_v1(h, items),
            lambda: session.session_readout(h, items),
            lambda: torch.matmul(h, items.T)),
        "score": (pair_v1, lambda: session.score(p1, s1, l1, SESSION_HEADS),
                  None),
    }
    names = {"session_encode": ("encode_block_kernel", "encode_warp_kernel"),
             "session_readout": ("readout_v1_kernel", "readout_tile_kernel")}
    per_call = {k: {"v1": [], "new": [], "library": []} for k in trio}
    on_device = {k: {"v1": [], "new": [], "library": []} for k in trio}
    kernel_device = {k: {"v1": [], "new": []} for k in names}
    with torch.no_grad():
        for turn in (("v1", "new", "library"), ("library", "new", "v1")):
            for name, fns in trio.items():
                for which in turn:
                    fn = fns[("v1", "new", "library").index(which)]
                    if fn is None:
                        continue
                    per_call[name][which].append(time_ms(fn, SESSION_REPS))
                    want = (names[name][which == "new"]
                            if name in names and which != "library" else "")
                    total, by_kernel = device_ms_per_call(fn, 20, want)
                    on_device[name][which].append(total)
                    if want:
                        kernel_device[name][which].append(next(
                            (ms for k, (ms, _) in by_kernel.items()
                             if want in k), None))
        plain = {
            "session_encode": time_ms(lambda: session.session_encode_plain(
                p, s_t, l_t, SESSION_HEADS), 5),
            "session_readout": time_ms(
                lambda: session.session_readout_plain(h, items), 20)}
    enc_bytes, enc_ops = session_encode_work(lengths, SESSION_D, 1,
                                             SESSION_HEADS, SESSION_L)
    rd_bytes = 4.0 * (b_max * SESSION_D + SESSION_V * SESSION_D
                      + b_max * SESSION_V)
    rd_ops = 2.0 * b_max * SESSION_V * SESSION_D
    bounds = {"session_encode": bound_ms(enc_bytes, enc_ops),
              "session_readout": bound_ms(rd_bytes, rd_ops)}

    def mean(xs):
        """The mean of the measured values; None (not measured) if the
        profiler returned none."""
        got = [x for x in xs if x is not None]
        return sum(got) / len(got) if got else None

    out = {}
    for name in names:
        bound, by = bounds[name]
        out[name] = dict(
            ms=mean(per_call[name]["new"]), ms_turns=per_call[name]["new"],
            device_ms=mean(kernel_device[name]["new"]),
            plain_ms=plain[name], library_ms=mean(per_call[name]["library"]),
            library_device_ms=mean(on_device[name]["library"]),
            v1_ms=mean(per_call[name]["v1"]),
            v1_ms_turns=per_call[name]["v1"],
            v1_device_ms=mean(kernel_device[name]["v1"]),
            bound_ms=bound, bound_by=by, max_abs_err=max_err[name],
            shape=[b_max, SESSION_L, SESSION_D, SESSION_V])
    plan = session.launch_plan(
        b_max, SESSION_L, SESSION_D, SESSION_HEADS, SESSION_V, 1, *limits)
    return {"kernels": out, "checks": checks, "wide": wide,
            "wide_branches_taken": wide_taken,
            "configs": [list(c) for c in SESSION_CONFIGS],
            "seq_tiers": ladders, "batch_tiers": list(SESSION_BATCH_TIERS),
            "tol_misses": tol_misses[:10], "bitwise_misses":
            bitwise_misses[:10], "v1_misses": v1_misses[:10],
            "pair_misses": pair_misses[:10],
            "single_query_score_ms": mean(per_call["score"]["new"]),
            "single_query_score_ms_turns": per_call["score"]["new"],
            "single_query_score_device_ms": mean(on_device["score"]["new"]),
            "single_query_v1_pair_ms": mean(per_call["score"]["v1"]),
            "single_query_v1_pair_ms_turns": per_call["score"]["v1"],
            "single_query_v1_pair_device_ms": mean(on_device["score"]["v1"]),
            "plan": repr(plan),
            "encode_shared": session.encode_shared_fits(
                SESSION_L, SESSION_D, SESSION_HEADS, device)}


def _session_windows(n_users: int, n_items: int, rng) -> dict:
    """15b's windows: user → 2-32 distinct items, drawn Zipf, oldest
    first (its events' distinct times in that order)."""
    import numpy as np

    p = 1.0 / np.arange(1, n_items + 1)
    p /= p.sum()
    sizes = rng.integers(2, SESSION_L + 1, n_users)
    draws = rng.choice(n_items, (n_users, 4 * SESSION_L), p=p)
    out = {}
    for u in range(n_users):
        _, first = np.unique(draws[u], return_index=True)
        items = draws[u][np.sort(first)][:sizes[u]]
        if len(items) < sizes[u]:
            rest = np.setdiff1d(rng.permutation(n_items), items,
                                assume_unique=True)
            items = np.concatenate([items, rest[:sizes[u] - len(items)]])
        out[f"u{u}"] = items.astype(np.int32)
    return out


def _item_ids(n_items: int):
    """The item map of `_session_windows`' rows: row j is item "i<j>"."""
    from predictionio_torch.data.bimap import BiMap

    return BiMap.string_int([f"i{j}" for j in range(n_items)])


def _session_queries(rng, n: int, n_items: int, users: int) -> list:
    """`n` queries: every third a user's window, the others 1-40 Zipf
    items (with repeats; over 32 the newest are kept), `num` 1-20."""
    import numpy as np

    p = 1.0 / np.arange(1, n_items + 1)
    p /= p.sum()
    out = []
    for j in range(n):
        num = int(rng.integers(1, 21))
        if j % 3 == 0:
            out.append({"user": f"u{int(rng.integers(0, users))}",
                        "num": num})
        else:
            size = int(rng.integers(1, 41))
            out.append({"items": [f"i{int(i)}" for i in
                                  rng.choice(n_items, size, p=p)],
                        "num": num})
    return out


def _fit_ms(fn, device) -> tuple:
    """(fn's result, its CUDA-event ms, the host's seconds, the peak
    device bytes)."""
    import torch

    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    return (out, start.elapsed_time(end), wall,
            torch.cuda.max_memory_allocated(device))


def _session_fit(device) -> dict:
    """15b: the template's fit at SESSION_FIT_USERS users × SESSION_V
    items (windows of `_session_windows`), SESSION_EPOCHS epochs at full
    width: the fit's device ms by CUDA events (an epoch's: the whole
    fit's over the epochs, upload and copy back included), wall, peak
    memory, losses; a second fit bitwise the first. Then SESSION_QUERIES
    queries through `batch_predict` in mixed batches, each answer equal
    (every id and score) to that query's alone."""
    import numpy as np
    import torch

    from predictionio_torch.ops import session
    from predictionio_torch.templates.sessionrec import engine as sessionrec

    rng = np.random.default_rng(15)
    user_seqs = _session_windows(SESSION_FIT_USERS, SESSION_V, rng)
    seq, lengths, n = sessionrec.training_batch(user_seqs, SESSION_V,
                                                SESSION_L, SESSION_L)
    params0 = sessionrec.init_params(SESSION_V, SESSION_D, 1, SESSION_L,
                                     np.random.default_rng(3))

    def fit():
        return session.train_params(params0, seq, lengths, SESSION_HEADS,
                                    SESSION_LR, SESSION_EPOCHS, device)

    (params, losses), fit_ms, wall, peak = _fit_ms(fit, device)
    (again, losses2), fit_ms2, wall2, _ = _fit_ms(fit, device)
    torch.cuda.empty_cache()  # the train child beside needs the room
    same = bool(np.array_equal(losses, losses2) and all(
        np.array_equal(a, b) for a, b in zip(
            session._flat(params), session._flat(again))))
    model = sessionrec.served_model(params, _item_ids(SESSION_V), user_seqs,
                                    SESSION_L, SESSION_HEADS, device)
    algo = sessionrec.SessionRecAlgorithm(sessionrec.SessionRecParams())
    queries = _session_queries(rng, SESSION_QUERIES, SESSION_V,
                               SESSION_FIT_USERS)
    t0 = time.perf_counter()
    batched, at, k = [], 0, 0
    while at < len(queries):
        size = SESSION_MIXED_BATCHES[k % len(SESSION_MIXED_BATCHES)]
        batched += algo.batch_predict(model, queries[at:at + size])
        at, k = at + size, k + 1
    batch_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    singles = [algo.predict(model, q) for q in queries]
    single_s = time.perf_counter() - t0
    equal = sum(a == b for a, b in zip(batched, singles))
    return {"users": SESSION_FIT_USERS, "items": SESSION_V,
            "sequences": n, "batch_tier": int(seq.shape[0]),
            "epochs": SESSION_EPOCHS,
            "epoch_ms": fit_ms / SESSION_EPOCHS,
            "epoch_ms_again": fit_ms2 / SESSION_EPOCHS,
            "fit_wall_s": wall, "fit_wall_again_s": wall2,
            "peak_bytes": peak, "loss_first": float(losses[0]),
            "loss_final": float(losses[-1]),
            "losses_finite": bool(np.isfinite(losses).all()),
            "fits_bitwise": same, "queries": len(queries),
            "batches": k, "batched_equal_single": int(equal),
            "answered": sum(bool(a["itemScores"]) for a in singles),
            "batch_predict_s": batch_s, "single_predict_s": single_s}


def _session_card_cpu(device) -> dict:
    """15c: at SESSION_CPU_SHAPE (users, items, epochs) the same seeded
    windows and init fitted on the card and on the CPU: each epoch's loss
    within rtol 1e-4; each model serving on its own device, the top-10
    ids of 200 queries equal wherever the CPU's scores are more than
    1e-5 apart."""
    import numpy as np

    from predictionio_torch.ops import session
    from predictionio_torch.templates.sessionrec import engine as sessionrec

    users, n_items, epochs = SESSION_CPU_SHAPE
    rng = np.random.default_rng(16)
    user_seqs = _session_windows(users, n_items, rng)
    seq, lengths, _ = sessionrec.training_batch(user_seqs, n_items,
                                                SESSION_L, SESSION_L)
    params0 = sessionrec.init_params(n_items, SESSION_D, 1, SESSION_L,
                                     np.random.default_rng(3))
    fits, secs = {}, {}
    for where in (device, "cpu"):
        t0 = time.perf_counter()
        fits[str(where)] = session.train_params(
            params0, seq, lengths, SESSION_HEADS, SESSION_LR, epochs,
            where)
        secs[str(where)] = time.perf_counter() - t0
    card, cpu = fits[str(device)], fits["cpu"]
    algo = sessionrec.SessionRecAlgorithm(sessionrec.SessionRecParams())
    queries = [dict(q, num=11) for q in _session_queries(
        rng, 200, n_items, users)]
    answers = {where: algo.batch_predict(sessionrec.served_model(
        fits[where][0], _item_ids(n_items), user_seqs, SESSION_L,
        SESSION_HEADS, where), queries) for where in fits}
    checked = differ = 0
    for got, want in zip(answers[str(device)], answers["cpu"]):
        w_ids = [s["item"] for s in want["itemScores"]]
        w_sc = [s["score"] for s in want["itemScores"]]
        g_ids = [s["item"] for s in got["itemScores"]]
        for j in range(min(10, len(w_ids) - 1)):
            gap = min(w_sc[j - 1] - w_sc[j] if j else np.inf,
                      w_sc[j] - w_sc[j + 1])
            if gap > 1e-5:
                checked += 1
                differ += g_ids[j] != w_ids[j]
    rel = np.abs(card[1] - cpu[1]) / np.abs(cpu[1])
    return {"shape": list(SESSION_CPU_SHAPE), "card_s": secs[str(device)],
            "cpu_s": secs["cpu"], "loss_card": card[1].tolist(),
            "loss_cpu": cpu[1].tolist(), "loss_rel_max": float(rel.max()),
            "losses_within": bool(np.allclose(card[1], cpu[1], rtol=1e-4,
                                              atol=0)),
            "untied_ids_checked": checked, "untied_ids_differ": differ}


def _session_events(n_events: int, n_users: int, n_items: int, rng) -> list:
    """15d's `view` events: n_events over n_users (each at least one, the
    rest spread multinomially), each user's items a walk over the catalog
    (the next item 1-3 ahead of the last with probability 0.8, else a
    Zipf draw), all event times distinct (one second apart, user after
    user)."""
    import numpy as np

    counts = 1 + rng.multinomial(n_events - n_users,
                                 np.full(n_users, 1.0 / n_users))
    p = 1.0 / np.arange(1, n_items + 1)
    zipf = rng.choice(n_items, n_events, p=p / p.sum())
    steps = rng.integers(1, 4, n_events)
    walk = rng.random(n_events) < 0.8
    t0 = datetime(2026, 5, 1, tzinfo=timezone.utc)
    events, at = [], 0
    for u, count in enumerate(counts):
        item = int(zipf[at])
        for j in range(at, at + int(count)):
            if j > at:
                item = ((item + int(steps[j])) % n_items if walk[j]
                        else int(zipf[j]))
            events.append({"event": "view", "entityType": "user",
                           "entityId": f"u{u}", "targetEntityType": "item",
                           "targetEntityId": f"i{item}",
                           "eventTime": _stamp(t0, j)})
        at += int(count)
    return events


def write_session_store(base: str, scale: str) -> None:
    """15, in a writer child started with the run: the template's store
    (SESSION_APP: `_session_events` at SESSION_SCALES[scale]) and the
    evaluation's (SESSION_EVAL_APP at SESSION_EVAL_SCALES[scale]), each
    written as a JSON-lines file and `console import`ed (the native
    importer) into one sqlite pio.db under `base`, the files deleted
    after; then SESSION_RESULT under `base`: the counts and seconds."""
    import numpy as np

    from predictionio_torch.tools import console

    t_start = time.perf_counter()
    os.environ["PIO_FS_BASEDIR"] = base
    row = {"scale": scale}
    for app, (n_events, n_users, n_items), seed in (
            (SESSION_APP, SESSION_SCALES[scale], 15),
            (SESSION_EVAL_APP, SESSION_EVAL_SCALES[scale], 17)):
        events = _session_events(n_events, n_users, n_items,
                                 np.random.default_rng(seed))
        path = os.path.join(base, f"{app}.jsonl")
        with open(path, "w") as f:
            for event in events:
                f.write(json.dumps(event) + "\n")
        with contextlib.redirect_stdout(io.StringIO()) as said:
            if console.main(["app", "new", app]) != 0:
                raise AssertionError(f"console app new {app} failed")
            t0 = time.perf_counter()
            if console.main(["import", "--appname", app, "--input",
                             path]) != 0:
                raise AssertionError(f"console import of {app} failed")
            import_s = time.perf_counter() - t0
        os.unlink(path)
        imported = said.getvalue().strip().splitlines()[-1]
        if imported != f"Imported {n_events} events.":
            raise AssertionError(f"console import said {imported!r}")
        viewed: dict = {}
        for event in events:
            viewed.setdefault(event["entityId"], set()).add(
                event["targetEntityId"])
        row[app] = {"events": n_events, "users": n_users, "items": n_items,
                    "items_viewed": len(set().union(*viewed.values())),
                    "sequences": sum(len(v) >= 2 for v in viewed.values()),
                    "import_s": import_s}
    row["write_s"] = time.perf_counter() - t_start
    with open(os.path.join(base, SESSION_RESULT), "w") as f:
        json.dump(row, f)


def _session_eval(device, base: str) -> dict:
    """15d: SessionRecEvaluation in this process on SESSION_EVAL_APP
    (SESSION_EVAL_K folds): MAP@10 of each cell of its (8, 16) × (1, 2)
    grid, the best, the wall."""
    from predictionio_torch.controller import WorkflowContext
    from predictionio_torch.controller.evaluation import MetricEvaluator
    from predictionio_torch.templates.sessionrec.evaluation import (
        SessionRecEvaluation,
    )

    saved = {k: os.environ.get(k) for k in ("PIO_EVAL_APP_NAME",
                                            "PIO_EVAL_K")}
    os.environ.update(PIO_EVAL_APP_NAME=SESSION_EVAL_APP,
                      PIO_EVAL_K=str(SESSION_EVAL_K))
    try:
        evaluation = SessionRecEvaluation()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    storage = _store_at(base)
    try:
        t0 = time.perf_counter()
        result = MetricEvaluator.evaluate(
            WorkflowContext(device=device, seed=0, storage=storage),
            evaluation, evaluation.engine_params_list)
        wall = time.perf_counter() - t0
    finally:
        storage.close()
    cells = []
    for r in result.all_results:
        (_, algo_params), = r.engine_params.algorithm_params_list
        cells.append({"embedDim": algo_params.embedDim,
                      "numBlocks": algo_params.numBlocks,
                      "map10": r.scores[result.metric_name]})
    return {"cells": cells, "best": result.best.scores[result.metric_name],
            "folds": SESSION_EVAL_K, "wall_s": wall}


def _view_histories(storage, app_id: int, users, names) -> dict:
    """Each user's every `names` event on an item as (item, 1.0, event
    time), read with one `find` (the plane's gather reads the same)."""
    from predictionio_torch.online.plane import _aware

    hist: dict = {u: [] for u in users}
    for e in storage.l_events().find(
            app_id, entity_type="user", entity_id=sorted(users),
            target_entity_type="item", event_names=list(names)):
        if e.target_entity_id:
            hist[str(e.entity_id)].append(
                (str(e.target_entity_id), 1.0, _aware(e.event_time)))
    return hist


def _session_online(url: str, storage, engine_json: str, device) -> dict:
    """15e: the online session fold in 15d's deployed server (PIO_ONLINE=1).
    SESSION_ONLINE_ROUNDS rounds of views written into its store with the
    storage API, each polled until its never-seen user is served; then
    every folded user's served answer against the persisted model folded
    in this process by `SessionFold` on the same histories (read from the
    store) and against its new window sent as {"items"}; then, in
    process, a backlog of SESSION_BACKLOG users folded and
    SESSION_BATCH_CHECK of them scored in one batch and alone."""
    import numpy as np

    from predictionio_torch.data.datamap import DataMap
    from predictionio_torch.data.events import Event
    from predictionio_torch.online.session import SessionFold

    engine, ep, models, components = _latest_models(storage, engine_json)
    model = models[0]
    (_, params), = ep.algorithm_params_list
    fold = SessionFold(getattr(params, "maxSeqLen", model.max_seq_len))
    names = list(ep.data_source_params.eventNames)
    app_id = storage.meta_apps().get_by_name(SESSION_APP).id
    le = storage.l_events()
    rng = np.random.default_rng(19)
    users = sorted(model.user_windows)
    items = sorted(model.item_ids.keys())
    before = _scrape(url)

    def view(user, item, t):
        le.insert(Event(event="view", entity_type="user", entity_id=user,
                        target_entity_type="item", target_entity_id=item,
                        properties=DataMap({}), event_time=t), app_id)

    rounds, dirty, last_view = [], set(), {}
    written = 0
    for r in range(SESSION_ONLINE_ROUNDS):
        new_user = f"sess-online-u{r}"
        viewed = [str(i) for i in rng.choice(items, SESSION_ONLINE_NEW_VIEWS,
                                             replace=False)]
        rows = [(new_user, i) for i in viewed]
        viewers = [str(u) for u in rng.choice(users, SESSION_ONLINE_VIEWERS,
                                              replace=False)]
        # the first viewer re-views its window's oldest item, which moves
        # to the end; the cold round's last viewer views a never-seen item
        rows.append((viewers[0], model.user_windows[viewers[0]][0]))
        rows += [(u, str(rng.choice(items))) for u in viewers[1:]]
        if r == SESSION_ONLINE_COLD_ROUND:
            rows[-1] = (rows[-1][0], f"sess-online-cold{r}")
        t0 = datetime.now(timezone.utc)
        for j, (u, i) in enumerate(rows):
            view(u, i, t0 + timedelta(milliseconds=j))
            last_view[u] = i
        committed = time.perf_counter()
        written += len(rows)
        dirty.update(u for u, _ in rows)
        queries, servable_ms = 0, None
        while time.perf_counter() - committed < SESSION_ONLINE_TIMEOUT_S:
            got = [s["item"] for s in _post(
                url, {"user": new_user, "num": 10})["itemScores"]]
            queries += 1
            if got and not set(got) & set(viewed):
                servable_ms = (time.perf_counter() - committed) * 1e3
                break
            time.sleep(0.002)
        rounds.append({"round": r, "servable_ms": servable_ms,
                       "queries": queries})
    # the last round's viewers may fold a poll after its new user
    t_wait = time.perf_counter()
    status = json.loads(_get(url + "/"))
    while (status["online"]["eventsFolded"] < written
           and time.perf_counter() - t_wait < SESSION_ONLINE_TIMEOUT_S):
        time.sleep(0.05)
        status = json.loads(_get(url + "/"))
    after = _scrape(url)
    # the persisted model folded here on the store's histories
    hist = _view_histories(storage, app_id, dirty, names)
    t0 = time.perf_counter()
    folded, stats = fold.fold(model, hist)
    fold_dirty_ms = (time.perf_counter() - t0) * 1e3

    def predict(m, q):
        return engine.predict(ep, [m], q, components=components)

    differ, window_differ, served_ms = [], [], []
    for u in sorted(dirty):
        q = {"user": u, "num": 10}
        t0 = time.perf_counter()
        got = _post(url, q)
        served_ms.append((time.perf_counter() - t0) * 1e3)
        if got != predict(folded, q):
            differ.append(u)
        if _post(url, {"items": list(folded.user_windows[u]),
                       "num": 10}) != got:
            window_differ.append(u)
    moved_last = sum(folded.user_windows[u][-1] == i
                     for u, i in last_view.items()
                     if model.item_ids.contains(i))

    # in process: a backlog of existing and never-seen users
    n_old, n_new = SESSION_BACKLOG
    old = [str(u) for u in rng.choice(sorted(set(users) - dirty), n_old,
                                      replace=False)]
    t_read = time.perf_counter()
    backlog = _view_histories(storage, app_id, old, names)
    read_ms = (time.perf_counter() - t_read) * 1e3
    now = datetime.now(timezone.utc)
    for k, u in enumerate(old):
        backlog[u].append((str(rng.choice(items)), 1.0,
                           now + timedelta(milliseconds=k)))
    for k in range(n_new):
        backlog[f"sess-backlog-u{k}"] = [
            (str(i), 1.0, now + timedelta(milliseconds=j))
            for j, i in enumerate(rng.choice(items, 3, replace=False))]
    one = old[0]
    one_ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        fold.fold(model, {one: backlog[one]})
        one_ms.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    folded_b, stats_b = fold.fold(model, backlog)
    backlog_ms = (time.perf_counter() - t0) * 1e3
    check = sorted(rng.choice(sorted(backlog), SESSION_BATCH_CHECK,
                              replace=False))
    qs = [{"user": str(u), "num": 10} for u in check]
    batch = engine.predict_batch(ep, [folded_b], qs, components=components)
    batched_equal = sum(predict(folded_b, q) == a for q, a in zip(qs, batch))
    servable = [r["servable_ms"] for r in rounds
                if r["servable_ms"] is not None]
    series = {
        "windows_folded": "session_windows_folded_total",
        "cold_items": "session_cold_items_total",
        "e2s_count": "online_family_event_to_servable_seconds_count"
                     '{family="sessionrec"}',
        "e2s_sum": "online_family_event_to_servable_seconds_sum"
                   '{family="sessionrec"}',
        "foldin_count": "online_foldin_seconds_count",
        "foldin_sum": "online_foldin_seconds_sum"}
    return {
        "rounds": len(rounds), "rounds_servable": len(servable),
        "events_written": written,
        "events_folded": status["online"]["eventsFolded"],
        "event_to_servable_ms": [r["servable_ms"] for r in rounds],
        "event_to_servable_ms_median": (float(np.median(servable))
                                        if servable else None),
        "event_to_servable_ms_max": max(servable, default=None),
        "queries_until_servable": [r["queries"] for r in rounds],
        "metrics": {k: _delta(after, before, v) for k, v in series.items()},
        "folded_users": len(dirty), "fold_stats": dataclasses.asdict(stats),
        "fold_dirty_ms": fold_dirty_ms, "served_differ": differ[:5],
        "served_equal": len(dirty) - len(differ),
        "window_equal": len(dirty) - len(window_differ),
        "served_ms_p50": float(np.percentile(served_ms, 50)),
        "reviewed_last": moved_last,
        "reviewed_known": sum(model.item_ids.contains(i)
                              for i in last_view.values()),
        "backlog": {"users": len(backlog), "existing": n_old, "new": n_new,
                    "read_ms": read_ms, "fold_ms": backlog_ms,
                    "fold_one_ms": float(np.median(one_ms)),
                    "fold_stats": dataclasses.asdict(stats_b),
                    "batch": len(qs), "batched_equal_single": batched_equal,
                    "answered": sum(bool(a["itemScores"]) for a in batch)}}


def phase_session(report: dict, device, tmp: str, writer, base: str) -> dict:
    """Phase 15: (d) `console template get` and `build` of sessionrec on
    the store that `writer` (the child running `write_session_store`)
    writes under `base`, its `console train` started in a child; (a) the
    kernels against their plain versions meanwhile, in this process, then
    the main path: (b) the fit at scale and `batch_predict`, (c) the card
    against the CPU, (d) the train's log, `console deploy` (with
    SessionRecEvaluation in this process while it comes up: its
    `ready_s` counts from the deploy's start), and SESSION_HTTP_QUERIES
    queries against the in-process answers, (e) the online session fold
    in that deploy (`_session_online`). Returns (this process's session
    kernel launches on the main path, each console child's launch
    record)."""
    import numpy as np

    from predictionio_torch.ops import session

    import torch

    t_phase = time.perf_counter()
    card = report["card"]
    written = _await_ratings(writer, base, SESSION_RESULT,
                             "the session store's writer")
    waited_s = time.perf_counter() - t_phase
    # the train child's logits (~8 GB, three alive in a step) share the
    # card with 15b's fit: hand back what earlier phases left cached
    torch.cuda.empty_cache()
    engine_json = _scaffolded("sessionrec", os.path.join(tmp, "Sess"),
                              SESSION_APP)
    dev = str(device)
    t0 = time.perf_counter()
    started = {"train": _start_child(["train", "--engine-json", engine_json,
                                      "--device", dev], base)}
    a_row = _session_kernels(device)
    emit(dict(phase="session", part="a_kernels", card=card, **a_row))
    if (a_row["tol_misses"] or a_row["bitwise_misses"]
            or a_row["v1_misses"] or a_row["pair_misses"]
            or not a_row["checks"] or not a_row["wide_branches_taken"]):
        raise AssertionError(f"15a: the kernels failed their bars: {a_row}")

    session.reset_launches()  # the session main path starts here
    b_row = _session_fit(device)
    emit(dict(phase="session", part="b_fit", card=card, **b_row))
    if not (b_row["fits_bitwise"] and b_row["losses_finite"]
            and b_row["loss_final"] < b_row["loss_first"]
            and b_row["batched_equal_single"] == b_row["queries"]
            and b_row["answered"] == b_row["queries"]):
        raise AssertionError(f"15b: the fit or the answers failed their "
                             f"bars: {b_row}")
    c_row = _session_card_cpu(device)
    emit(dict(phase="session", part="c_card_cpu", card=card, **c_row))
    if not (c_row["losses_within"] and c_row["untied_ids_checked"] > 100
            and c_row["untied_ids_differ"] == 0):
        raise AssertionError(f"15c: the card and the CPU differ: {c_row}")
    done, walls = _finish_together(started, {"train": t0}, {}, "15")
    _, err, train_rec = done["train"]
    stages = _stage_seconds(err)
    users = _count_logged(err, r"DataSource: (\d+) users with sequences")
    trained = _count_logged(err, r"SessionRec: trained (\d+) sequences, "
                                 r"(\d+) items")
    want = written[SESSION_APP]
    if (users != [want["users"]]
            or trained != [want["sequences"], want["items_viewed"]]):
        raise AssertionError(f"15d: the train read {users} users and "
                             f"trained {trained}; the writer wrote {want}")
    launch_path = os.path.join(tmp, "session-deploy.json")
    # the online plane from the start: it has nothing to fold until 15e
    deploy = _start_deploy(["--engine-json", engine_json, "--ip",
                            "127.0.0.1", "--port", "0", "--device", dev],
                           {"PIO_FS_BASEDIR": base, "PIO_ONLINE": "1"},
                           launch_path)
    storage = None
    try:
        t0 = time.perf_counter()
        d_eval = _session_eval(device, base)  # while the server comes up
        line = _read_deployed_line(deploy, 300.0)
        ready_s = time.perf_counter() - t0
        url = f"http://127.0.0.1:{int(line.rsplit(':', 1)[1])}"
        rng = np.random.default_rng(18)
        queries = _session_queries(rng, 3 * SESSION_HTTP_QUERIES,
                                   want["items"], want["users"])
        users_q = [q for q in queries if "user" in q]
        items_q = [q for q in queries if "items" in q]
        half = SESSION_HTTP_QUERIES // 2
        queries = users_q[:half] + items_q[:SESSION_HTTP_QUERIES - half]
        storage = _store_at(base)
        predict = _latest_model(storage, engine_json)
        served = _served_equal(url, queries, predict)
        served["answered"] = sum(bool(predict(q)["itemScores"])
                                 for q in queries)
        t0 = time.perf_counter()
        e_row = _session_online(url, storage, engine_json, device)
        e_row["wall_s"] = time.perf_counter() - t0
    finally:
        _stop(deploy)
        if storage is not None:
            storage.close()
    with open(launch_path) as f:
        deploy_rec = json.load(f)
    here = {**session.launches, **session.launches_v1}  # ... and ends here
    d_row = dict(stages, wall_s=walls["train"], store=written,
                 waited_s=waited_s, users=users[0], sequences=trained[0],
                 items=trained[1], ready_s=ready_s, serve=served,
                 eval=d_eval)
    emit(dict(phase="session", part="d_console", card=card, **d_row))
    if (served["equal"] != served["queries"]
            or served["answered"] < served["queries"] // 2
            or len(d_eval["cells"]) != 4
            or not all(c["map10"] > 0 for c in d_eval["cells"])):
        raise AssertionError(f"15d: served answers differ from the "
                             f"in-process model's, or the evaluation "
                             f"failed: {served} {d_eval}")
    e_row["child_launches"] = {k: v for k, v in deploy_rec["launches"].items()
                               if v}
    e_row["child_session"] = deploy_rec["session"]
    emit(dict(phase="session", part="e_online", card=card, **e_row))
    backlog = e_row["backlog"]
    folded = e_row["folded_users"]
    if (e_row["rounds_servable"] != SESSION_ONLINE_ROUNDS
            or e_row["events_folded"] != e_row["events_written"]
            or e_row["served_equal"] != folded
            or e_row["window_equal"] != folded
            or e_row["reviewed_last"] != e_row["reviewed_known"]
            or e_row["fold_stats"]["folded_users"] != folded
            or e_row["fold_stats"]["new_items"] != 1
            or e_row["metrics"]["windows_folded"] < folded
            or e_row["metrics"]["cold_items"] < 1
            or backlog["fold_stats"]["folded_users"] != sum(SESSION_BACKLOG)
            or backlog["batched_equal_single"] != SESSION_BATCH_CHECK
            or backlog["answered"] != SESSION_BATCH_CHECK
            or e_row["child_launches"]
            or not all(deploy_rec["session"][k] > 0 for k in SESSION_KERNELS)
            or any(deploy_rec["session"][f"{k}_v1"]
                   for k in SESSION_KERNELS)):
        raise AssertionError(f"15e: the online session fold failed a bar: "
                             f"{e_row}")
    wall = time.perf_counter() - t_phase
    emit({"phase": "session", "wall_s": wall, "card": card})
    report["session"] = {"a": a_row, "b": b_row, "c": c_row, "d": d_row,
                         "e": e_row, "log": err.splitlines()[-30:],
                         "wall_s": wall}
    return here, {"train": train_rec, "deploy": deploy_rec}


def _split_digest(split) -> str:
    """A digest of a RatingSplit's arrays and shape."""
    import hashlib

    h = hashlib.sha256(f"{split.n_users} {split.n_items}".encode())
    for a in (split.train_u, split.train_i, split.train_r, split.test_u,
              split.test_i, split.test_r):
        h.update(a.tobytes())
    return h.hexdigest()


def write_parity_reference(base: str, scale: str) -> None:
    """16, in a child started with the run (niced, PARITY_THREADS BLAS
    threads): the MLlib-faithful side of `run_parity` at `scale` for each
    of PARITY_MODES, with its split. Writes PARITY_ARRAYS under `base`
    (each side's factors and epoch seconds, and the implicit split's
    arrays, which this process is slow to synthesise) and then
    PARITY_RESULT (each side's wall, the split's seconds and digest)."""
    import numpy as np

    from predictionio_torch.quality.parity import parity_split, reference_side

    os.nice(10)  # below the phases it overlaps
    arrays, row = {}, {"scale": scale}
    for mode in PARITY_MODES:
        t0 = time.perf_counter()
        split = parity_split(mode, scale, PARITY_SEED)
        split_s = time.perf_counter() - t0
        side = reference_side(split, mode, PARITY_RANK, PARITY_ITERS,
                              PARITY_REG, PARITY_ALPHA, PARITY_SEED)
        arrays.update({f"{mode}_user_factors": side["user_factors"],
                       f"{mode}_item_factors": side["item_factors"],
                       f"{mode}_epoch_times": np.asarray(side["epoch_times"])})
        if mode == "implicit":
            arrays.update({f"split_{k}": getattr(split, k) for k in (
                "train_u", "train_i", "train_r", "test_u", "test_i",
                "test_r")})
            arrays["split_shape"] = np.asarray([split.n_users,
                                                split.n_items])
        row[mode] = {"wall_s": side["wall_s"], "split_s": split_s,
                     "digest": _split_digest(split)}
    tmp = os.path.join(base, "partial.npz")
    np.savez(tmp, **arrays)
    os.replace(tmp, os.path.join(base, PARITY_ARRAYS))
    with open(os.path.join(base, PARITY_RESULT), "w") as f:
        json.dump(row, f)


def phase_parity(report: dict, device, data, writer, base: str) -> dict:
    """Phase 16: `run_parity` at PARITY_SCALE in each of PARITY_MODES, the
    port's ALS trained on the card, the MLlib-faithful side the one that
    `writer` (the child running `write_parity_reference`) trained on the
    same split; `data` is phase 3's explicit split. Returns the rows."""
    import numpy as np

    from predictionio_torch.quality.datasets import RatingSplit
    from predictionio_torch.quality.parity import run_parity

    t_phase = time.perf_counter()
    card = report["card"]
    written = _await_ratings(writer, base, PARITY_RESULT,
                             "the parity reference's child")
    waited_s = time.perf_counter() - t_phase
    with np.load(os.path.join(base, PARITY_ARRAYS)) as z:
        arrays = {k: z[k] for k in z.files}
    n_users, n_items = (int(v) for v in arrays["split_shape"])
    splits = {"explicit": data, "implicit": RatingSplit(
        *(arrays[f"split_{k}"] for k in ("train_u", "train_i", "train_r",
                                        "test_u", "test_i", "test_r")),
        n_users, n_items)}
    rows = {}
    for mode in PARITY_MODES:
        if _split_digest(splits[mode]) != written[mode]["digest"]:
            raise AssertionError(f"16: the {mode} split differs from the "
                                 f"MLlib-faithful side's")
        side = {"user_factors": arrays[f"{mode}_user_factors"],
                "item_factors": arrays[f"{mode}_item_factors"],
                "epoch_times": arrays[f"{mode}_epoch_times"].tolist(),
                "wall_s": written[mode]["wall_s"]}
        t0 = time.perf_counter()
        out = run_parity(mode, PARITY_SCALE, rank=PARITY_RANK,
                         iterations=PARITY_ITERS, reg=PARITY_REG,
                         alpha=PARITY_ALPHA, seed=PARITY_SEED, device=device,
                         split=splits[mode], ref_side=side)
        out["call_s"] = time.perf_counter() - t0
        out["ref"]["split_s"] = written[mode]["split_s"]
        rows[mode] = out
        emit(dict(phase="parity", part=mode, card=card, **out))
    wall = time.perf_counter() - t_phase
    ex, im = rows["explicit"], rows["implicit"]
    key = "map10"
    if not (ex["ours"]["rmse"] <= ex["ref"]["rmse"] + PARITY_RMSE_SLACK
            and max(ex["ours"]["rmse"], ex["ref"]["rmse"]) < PARITY_RMSE_MAX
            and im["ours"][key] >= PARITY_MAP_SHARE * im["ref"][key]
            and min(im["ours"][key], im["ref"][key]) > PARITY_MAP_MIN):
        raise AssertionError(f"16: the port's ALS failed the parity bars: "
                             f"{rows}")
    emit({"phase": "parity", "wall_s": wall, "waited_s": waited_s,
          "card": card})
    report["parity"] = {**rows, "wall_s": wall, "waited_s": waited_s}
    return rows


def _require_runtime_launches(children: dict, profiled: dict) -> None:
    """Phase 11's launch bars (card only): the resumed train launched
    `gj_aug_reg` (RUNTIME_ITERATIONS − RUNTIME_KILL + 1) / RUNTIME_ITERATIONS
    times as often as the uninterrupted one, and the profiled train's
    trace names `gj_reg_kernel`, which it launched."""
    whole = children["whole"]["launches"]["gj_aug_reg"]
    resumed = children["resumed"]["launches"]["gj_aug_reg"]
    if whole <= 0 or (resumed * RUNTIME_ITERATIONS
                      != whole * (RUNTIME_ITERATIONS - RUNTIME_KILL + 1)):
        raise AssertionError(f"11b: the resumed train launched gj_aug_reg "
                             f"{resumed} times, the uninterrupted one "
                             f"{whole}")
    if (not any("gj_reg_kernel" in n for n in profiled["gj_events"])
            or not children["profiled"]["launches"]["gj_aug_reg"]):
        raise AssertionError(f"11d: the trace names no gj_reg_kernel "
                             f"launch: {profiled}")


def _require_template_launches(children: dict, here: dict) -> None:
    """Phase 10's solves: each `console train` and this process's auto
    trains on `gj_aug_reg` at the engine.json's rank (10) alone, the
    eval's grids on it at rank 8 alone, the deploy children none (no
    template here folds)."""
    want = {**{f"train_{name}": {"gj_aug_reg/K=10"}
               for name in TEMPLATE_NAMES if name != "recommendation"},
            "eval": {"gj_aug_reg/K=8"},
            **{f"deploy_{name}": set() for name in TEMPLATE_NAMES
               if name != "recommendation"}}
    got = {name: children[name]["by_rank"] for name in want}
    got["in_process"] = here
    want["in_process"] = {"gj_aug_reg/K=10"}
    wrong = {name: by_rank for name, by_rank in got.items()
             if set(by_rank) != want[name]
             or not all(v > 0 for v in by_rank.values())}
    if wrong:
        raise AssertionError(f"on the templates path: want {want}, got "
                             f"{wrong}")


def _require_launches(path: str, launches: dict, kernels) -> None:
    """Every kernel in `kernels` launched on the path, and no kernel of
    OFF_PATH."""
    missing = [k for k in kernels if launches[k] <= 0]
    off = {k: launches[k] for k in OFF_PATH if launches[k]}
    if missing or off:
        raise AssertionError(f"on the {path} path: kernels never launched "
                             f"{missing}, off-path kernels launched {off} "
                             f"({launches})")


class _NativeFallbacks(logging.Handler):
    """Keeps what NATIVE_LOGGERS log in this process (at INFO and above:
    the scan's fallback is an INFO line)."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.lines: list = []
        for name in NATIVE_LOGGERS:
            logger = logging.getLogger(name)
            logger.setLevel(logging.INFO)
            logger.addHandler(self)

    def emit(self, record) -> None:
        self.lines.append(record.getMessage())


def native_build() -> dict:
    """Builds (or loads) the native package's library with g++ and
    requires it loaded: the status before, the seconds the first use
    took (the g++ build's, unless the status said it was built), the
    library and the status after."""
    from predictionio_torch import native

    before = native.native_status()
    t0 = time.perf_counter()
    lib = native.get_lib()
    seconds = time.perf_counter() - t0
    status = native.native_status()
    if lib is None or status != "available (loaded)":
        raise AssertionError(f"the native library did not build or load: "
                             f"{status}")
    return {"status_before": before, "first_use_s": seconds,
            "library": os.path.relpath(lib._name, HERE), "status": status}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--report", default=None,
                        help="also write every number as JSON to this path")
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    try:
        import predictionio_torch  # noqa: F401 — the checkout's package
    except ImportError as e:
        print(f"chip_smoke: run from the root of a checkout ({e})",
              file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    card = card_line()
    report: dict = {"card": card, "torch": torch.__version__,
                    "cuda": torch.version.cuda}
    t_all = time.perf_counter()
    # the native package (g++, one library) before any child starts, so
    # that every process of the run loads this build; its fallback lines
    # in this process are kept and fail the run at its end
    fallbacks = _NativeFallbacks()
    report["native"] = native_build()
    emit(dict(phase="native", **report["native"]))
    # the stores of phases 10-14 are written by children from here on,
    # beside the phases before them (they take minutes; those phases leave
    # host cores idle)
    shop = tempfile.TemporaryDirectory()
    ratings = tempfile.TemporaryDirectory()
    props = tempfile.TemporaryDirectory()
    texts = tempfile.TemporaryDirectory()
    baskets = tempfile.TemporaryDirectory()
    sessions = tempfile.TemporaryDirectory()
    parity = tempfile.TemporaryDirectory()
    writer = _start_store_writer(shop.name)
    ratings_writer = _start_store_writer(ratings.name, "2m",
                                         "write_ratings_store")
    props_writer = _start_store_writer(props.name, "2m",
                                       "write_classify_store")
    text_writer = _start_store_writer(texts.name, "50k", "write_text_store")
    basket_writer = _start_store_writer(baskets.name, "200k",
                                        "write_basket_store")
    session_writer = _start_store_writer(sessions.name, "200k",
                                         "write_session_store")
    # phase 16's MLlib-faithful side: host numpy, niced, its BLAS threads
    # capped, so that it takes the cores the phases before it leave idle
    parity_writer = _start_store_writer(parity.name, PARITY_SCALE,
                                        "write_parity_reference",
                                        PARITY_THREADS)
    # the run's PIO_FS_BASEDIR (the bucket cache of a console child that
    # names no store lives under it), unless a phase sets its own
    basedir = tempfile.TemporaryDirectory()
    os.environ.setdefault("PIO_FS_BASEDIR", basedir.name)
    try:
        return _run(args, report, card, device, t_all, writer, shop.name,
                    fallbacks, ratings_writer, ratings.name, props_writer,
                    props.name, text_writer, texts.name, basket_writer,
                    baskets.name, session_writer, sessions.name,
                    parity_writer, parity.name)
    finally:
        _stop(writer)
        _stop(ratings_writer)
        _stop(props_writer)
        _stop(text_writer)
        _stop(basket_writer)
        _stop(session_writer)
        _stop(parity_writer)
        shop.cleanup()
        ratings.cleanup()
        props.cleanup()
        texts.cleanup()
        baskets.cleanup()
        sessions.cleanup()
        parity.cleanup()
        basedir.cleanup()


def _run(args, report: dict, card: str, device, t_all: float, writer,
         shop: str, fallbacks, ratings_writer, ratings: str, props_writer,
         props: str, text_writer, texts: str, basket_writer,
         baskets: str, session_writer, sessions: str, parity_writer,
         parity: str) -> int:
    """Phases 1-16 and the kernels line (`main`'s body, with the store
    writers of phases 10-15 and phase 16's MLlib-faithful side started)."""
    import torch

    from predictionio_torch.ops import session, spd_solve
    from predictionio_torch.quality.datasets import synth_explicit

    phase_build(report, card, device)
    main_shapes = phase_kernels(report, device)
    data = synth_explicit("2m")
    chol = phase_train_reference(report, data, device)

    spd_solve.reset_launches()  # the train → serve path starts here
    train_runs, trained = phase_train(report, data, device, chol)
    bucketize_ab(report, data)
    with tempfile.TemporaryDirectory() as tmp:
        served = phase_serve(report, device, tmp)
        train_serving_multi(device, tmp, served)  # phase 8c's model
        serve_launches = dict(spd_solve.launches)  # ... and ends here
        _require_launches("train → serve", serve_launches, PATH_KERNELS)

        sequential = sequential_trains(data, device)
        spd_solve.reset_launches()  # the eval → batchpredict path starts here
        phase_grid(report, data, device, sequential)
        eval_runs = phase_eval(report, device, tmp, served)
        batch = phase_batchpredict(report, device, tmp, served)
        grid_launches = dict(spd_solve.launches)  # ... and ends here
        spd_solve.reset_launches()  # the fold path starts here
        fold_rows = phase_fold(report, data, device, trained, tmp)
        fold_launches = dict(spd_solve.launches)  # ... and ends here
        spd_solve.reset_launches()  # the online path starts here
        child = phase_online(report, device, tmp, served, data, trained,
                             fold_rows)
        # ... and ends here: this process's launches and the deployed
        # child's (its counts start at 0 with the process)
        online_launches = {k: v + child[k]
                           for k, v in spd_solve.launches.items()}
        spd_solve.reset_launches()  # the serving path starts here
        children, cache_child = phase_serving(report, device, tmp, served,
                                              data)
        # ... and ends here: this process's launches (8c's servers) and
        # the four deployed children's (the 8d child's folds)
        serving_launches = {
            k: v + sum(c[k] for c in children.values())
            for k, v in spd_solve.launches.items()}
        spd_solve.reset_launches()  # the event-server path starts here
        eventserver_child = phase_eventserver(report, device, tmp, data)
        # ... and ends here: this process's launches (none: it only
        # sends HTTP) and the deploy child's folds
        eventserver_launches = {k: v + eventserver_child[k]
                                for k, v in spd_solve.launches.items()}
        spd_solve.reset_launches()  # the runtime path starts here
        runtime_children = phase_runtime(report, device, tmp, served, data,
                                         ratings_writer, ratings)
        # ... and ends here: this process's launches ((a), (e)) and the
        # console children's (the killed train's died with it)
        runtime_launches = {
            k: v + sum(c["launches"][k] for c in runtime_children.values())
            for k, v in spd_solve.launches.items()}
        _require_runtime_launches(runtime_children, report["runtime"]["d"])
        spd_solve.reset_launches()  # the templates path starts here
        template_children = phase_templates(report, device, tmp, served,
                                            writer, shop)
        # ... and ends here: this process's launches (its auto trains)
        # and every console child's (trains, deploys, eval)
        _require_template_launches(template_children,
                                   dict(spd_solve.launches_by_rank))
        templates_launches = {
            k: v + sum(c["launches"][k] for c in template_children.values())
            for k, v in spd_solve.launches.items()}
        spd_solve.reset_launches()  # the classify path starts here
        classify_children = phase_classify(report, device, tmp,
                                           props_writer, props)
        # ... and ends here: this process's launches (12a-12b) and every
        # console child's (trains, deploys, eval, the drill's re-run)
        classify_launches = {
            k: v + sum(c["launches"][k] for c in classify_children.values())
            for k, v in spd_solve.launches.items()}
        spd_solve.reset_launches()  # the text path starts here
        text_children = phase_text(report, device, tmp, text_writer, texts)
        # ... and ends here: this process's launches (13a) and every
        # console child's (trains, deploys, eval, the drills' re-runs)
        text_launches = {
            k: v + sum(c["launches"][k] for c in text_children.values())
            for k, v in spd_solve.launches.items()}
        spd_solve.reset_launches()  # the basket path starts here
        basket_children = phase_basket(report, device, tmp, basket_writer,
                                       baskets)
        # ... and ends here: this process's launches (14a) and the console
        # children's (the train, the deploy)
        basket_launches = {
            k: v + sum(c["launches"][k] for c in basket_children.values())
            for k, v in spd_solve.launches.items()}
        spd_solve.reset_launches()  # the session path starts here (its
        # own kernels' counts are zeroed inside, after 15a's comparisons)
        session_here, session_children = phase_session(
            report, device, tmp, session_writer, sessions)
        # ... and ends here: this process's launches (15b-15d) and the
        # console children's (the train, the deploy)
        session_launches = {
            k: v + sum(c["launches"][k] for c in session_children.values())
            for k, v in spd_solve.launches.items()}
        session_kernel_launches = {
            k: v + sum(c["session"][k] for c in session_children.values())
            for k, v in session_here.items()}
        spd_solve.reset_launches()  # the parity path starts here
        phase_parity(report, device, data, parity_writer, parity)
        parity_launches = dict(spd_solve.launches)  # ... and ends here
    _require_launches("fold", fold_launches, FOLD_KERNEL.values())
    # the runtime path: gj_aug_reg at rank 64, the Schur base at 128
    _require_launches("runtime", runtime_launches, FOLD_KERNEL.values())
    _require_launches("online", online_launches, FOLD_KERNEL.values())
    # the fold kernel from the 8d child's folds alone; no off-path kernel
    # in any of the serving path's processes
    _require_launches("serving (8d's folds)", cache_child,
                      [FOLD_KERNEL[64]])
    _require_launches("serving", serving_launches, [])
    # the fold kernel from the deploy child's folds alone, and no other
    _require_launches("eventserver", eventserver_launches,
                      [FOLD_KERNEL[64]])
    if any(v for k, v in eventserver_launches.items()
           if k != FOLD_KERNEL[64]):
        raise AssertionError(f"on the eventserver path: kernels other than "
                             f"{FOLD_KERNEL[64]} launched "
                             f"({eventserver_launches})")
    # the templates' solves on gj_aug_reg alone (rank 10 and 8)
    _require_launches("templates", templates_launches, ["gj_aug_reg"])
    if any(v for k, v in templates_launches.items() if k != "gj_aug_reg"):
        raise AssertionError(f"on the templates path: kernels other than "
                             f"gj_aug_reg launched ({templates_launches})")
    # the classification ops solve no system: no solve kernel launches
    if any(classify_launches.values()):
        raise AssertionError(f"on the classify path: solve kernels launched "
                             f"({classify_launches})")
    # nor do the text ops: no kernel of OFF_PATH, and none at all
    _require_launches("text", text_launches, [])
    if any(text_launches.values()):
        raise AssertionError(f"on the text path: solve kernels launched "
                             f"({text_launches})")
    # nor do the basket ops (a torch int8 GEMM, no solve)
    _require_launches("basket", basket_launches, [])
    if any(basket_launches.values()):
        raise AssertionError(f"on the basket path: solve kernels launched "
                             f"({basket_launches})")
    # nor does the sessionrec path (its own two kernels, both launched)
    _require_launches("session", session_launches, [])
    if any(session_launches.values()):
        raise AssertionError(f"on the session path: solve kernels launched "
                             f"({session_launches})")
    # the parity trains (rank 64, auto) on gj_aug_reg alone
    _require_launches("parity", parity_launches, ["gj_aug_reg"])
    if any(v for k, v in parity_launches.items() if k != "gj_aug_reg"):
        raise AssertionError(f"on the parity path: kernels other than "
                             f"gj_aug_reg launched ({parity_launches})")
    if (not all(session_kernel_launches[k] > 0 for k in SESSION_KERNELS)
            or any(session_kernel_launches[f"{k}_v1"] for k in SESSION_KERNELS)):
        raise AssertionError(f"on the session path: a session kernel never "
                             f"launched, or a first version did "
                             f"({session_kernel_launches})")
    # the path's launches: the grids in this process and the console
    # children's (each child's counts start at 0 with the process)
    children = [run["launches"] for run in eval_runs.values()]
    children.append(batch["launches"])
    eval_launches = {k: v + sum(c[k] for c in children)
                     for k, v in grid_launches.items()}
    _require_launches("eval", eval_launches, LAYOUT_KERNEL.values())
    report["launches"] = {"train_serve": serve_launches,
                          "eval": eval_launches, "eval_grid": grid_launches,
                          "fold": fold_launches, "online": online_launches,
                          "serving": serving_launches,
                          "eventserver": eventserver_launches,
                          "templates": templates_launches,
                          "runtime": runtime_launches,
                          "classify": classify_launches,
                          "text": text_launches,
                          "basket": basket_launches,
                          "session": session_launches,
                          "session_kernels": session_kernel_launches,
                          "parity": parity_launches}

    kernels = []
    for name, (replaces, source) in KERNELS.items():
        row = main_shapes[name]
        per_epoch = {f"{rank}-{layout}": run["launches_per_epoch"][name]
                     for (rank, layout), run in train_runs.items()}
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"predictionio_torch/csrc/{source}",
            "replaces": replaces, "ranks": KERNEL_RANKS[name],
            "launches": (serve_launches[name] + eval_launches[name]
                         + fold_launches[name] + online_launches[name]
                         + serving_launches[name]
                         + eventserver_launches[name]
                         + templates_launches[name]
                         + runtime_launches[name]
                         + classify_launches[name]
                         + text_launches[name]
                         + basket_launches[name]
                         + session_launches[name]
                         + parity_launches[name]),
            "max_abs_err": row["max_abs_err"], "ms": row["kernel_ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "shape": row["shape"],
            "launches_train_serve": serve_launches[name],
            "launches_eval": eval_launches[name],
            "launches_eval_grid": grid_launches[name],
            "launches_fold": fold_launches[name],
            "launches_online": online_launches[name],
            "launches_serving": serving_launches[name],
            "launches_eventserver": eventserver_launches[name],
            "launches_templates": templates_launches[name],
            "launches_runtime": runtime_launches[name],
            "launches_classify": classify_launches[name],
            "launches_text": text_launches[name],
            "launches_basket": basket_launches[name],
            "launches_session": session_launches[name],
            "launches_parity": parity_launches[name],
            "launches_per_epoch_2m": per_epoch,
            "launches_console_eval": {layout: run["launches"][name]
                                      for layout, run in eval_runs.items()},
        })
    for name, replaces in SESSION_KERNELS.items():
        row = report["session"]["a"]["kernels"][name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "predictionio_torch/csrc/session.cu",
            "replaces": replaces,
            "ranks": "no TPU counterpart: the sessionrec scorer, bitwise "
                     "batched ≡ single at every tier",
            "launches": session_kernel_launches[name],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "shape": row["shape"], "device_ms": row["device_ms"],
            "library_device_ms": row["library_device_ms"],
            "launches_session": session_kernel_launches[name],
            # the first version it replaced, timed in the same turns
            "replaced": {"name": f"{name}_v1", "ms": row["v1_ms"],
                         "device_ms": row["v1_device_ms"],
                         "launches": session_kernel_launches[f"{name}_v1"]}})
    report["kernels_line"] = kernels
    _require_native_log("\n".join(fallbacks.lines), "this process")
    report["wall_s"] = time.perf_counter() - t_all
    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)),
                    exist_ok=True)
        with open(args.report, "w") as f:
            json.dump(report, f, indent=1, default=str)

    emit({"kernels": kernels})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
