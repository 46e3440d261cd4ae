#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) end to end on one GPU.

Run from the repository root:  python3 chip_smoke.py

Phases, one JSON line each:
  env      the card (nvidia-smi name and power limit), the cards the
           process sees (torch.cuda.device_count() and nvidia-smi -L),
           torch and CUDA versions, and the build of the CUDA kernels from
           csrc/;
  main     the serving slice at the two-tower-retrieval index width
           (n = 256, D = 32, K = 256, L = 1024) over N = 1,000,000 vectors:
           learn R with GCD steps, build the IVF-PQ index, serve ragged
           batches at three nprobe, check nprobe = L against the flat scan,
           take a subspace-GCD step, refresh without a rebuild, serve
           again. Holds the IVF recall acceptance of
           benchmarks/ivf_recall_qps.py:265 over the nprobe sweep: some
           nprobe reaches recall@10 ≥ 0.9 against the flat scan of the
           same codes at a scan reduction (N over the rows scanned per
           query) ≥ 5. The kernel launch counts are set to 0 just before
           this phase and read just after it;
  kernels  every kernel of that path against its plain PyTorch version on
           the operands the main path gave it (the serve_p99 batch at
           nprobe 32, the flat-check batch, the subspace step's G and R):
           the two index scans bit for bit in every LUT type (float32,
           int8, uint8) with and without the id mask, at b = 1, 5, 64 and
           512 served queries, ivf_adc also on the Engine's bucket
           schedules (8, 64, 128, 512), on a shuffled and a ragged
           schedule, and both on rows of 24 code bytes; ivf_adc timed at
           each bucket beside serve_p99; gcd_score at n = 48, 200 and
           520 (both tile widths, ragged edges; bit-antisymmetric, within
           1e-5); pq_assign on the
           build's encode of all N rows (coarse VQ, then PQ on the
           residuals) with its float32-tie flips counted; givens_rotate on
           the refresh's R, centroids and codebook rows, bit-equal to the
           plain version and to what the refresh stored. Times per launch
           from a CUDA graph of back-to-back launches (device time, host
           enqueue left out) for each kernel, its plain version, its
           library yardstick and the launch floor; one-shot CUDA-event
           times with a cold L2 (host latency included); then the
           serve_p99 batch stage by stage;
  engine   the serving front end on main's refreshed index: a fused-refresh
           IVF state (nprobe 32) behind search.Engine, driven by 48
           requests from SEED (sizes 512, 100, 37, 1, 300, 64 in turn,
           about half their rows repeats) with a subspace-GCD refresh after
           request 16 and a GCD-G refresh (pairs across subspaces) after
           request 32, then the stream again with int8 tables. Checked
           against direct searches, the LUT cache's hits, invalidations and
           executables, an eager refresh of the same index by the same
           deltas, recall against the exact backend, and the exact
           backends against the plain Q·Xᵀ; counts are set to 0 just
           before the path and read just after it. Then fused_lut against
           its plain version on the path's operands (b = 512 at two
           rotations, b = 1, 37, 300 and the Engine's buckets 8, 64, 128,
           a depth-2 RQ column map, n = 512, and its launch plan's edges:
           Dp = 31, K = 250, a Q that is not 16-byte aligned); the 512
           serve_p99 queries' tables bit-equal whether built at b = 512
           or in slices of b = 1, 8, 37, 64, 128 and 300 (LUT_SLICES), at
           n = 256 and at n = 512 (a query's table does not depend on its
           batch); its time at b = 512 and at the Engine's buckets beside
           its times when its order of sums still moved with the batch
           (LUT_BEFORE_MS), the two library calls that compute the
           same tables and the eager LUT stage;
  churn    live churn on main's index (repro_torch.bench.churn's loop):
           a fused-refresh IVF state (nprobe 32) behind search.Engine
           (k = 10, min_bucket 32) and a ChurnController (a 4,096-row
           buffer, flush at 0.5, compact at 0.03), the first search with
           the buffer in, then 24 steps of 2,048 deletes drawn from SEED,
           2,048 adds (held-out rows of main's sift_like draw, ids from N
           up), a subspace-GCD delta through Engine.refresh and the 512
           serve_p99 queries. Held: the JAX churn script's seven checks
           (benchmarks/churn.py:208-219: no new executable, no LUT
           invalidation, no grow, no dead id served, every mutation
           exercised, recall@10 within 0.01 of a same-quantizer repack
           and no lower than a fresh ivf.build less 0.01), every state
           tensor's shape and
           max_blocks at every step, and the launches each step implies
           (counts set to 0 just before the loop and read just after).
           Then 8 steps with a BackgroundCompactor, a StalenessTracker and
           a re-encode from the rows: a swap, no double swap, launches;
           and a quiet pass bit-equal to a foreground compact of its
           snapshot. adc_lookup as the side pass (b = 1, 32, 512; the
           buffer half full, full and empty; float32 and int8 tables) and
           ivf_adc on the tombstoned CSR with the widened window, bit for
           bit against their plain versions. Reported: each mutation's ms,
           the Engine's latency at bucket 512 beside an Engine without a
           buffer, rows scanned and the window's rows a query, the side
           pass's time, bound and F.embedding_bag time. The fresh build
           is the JAX script's from main's build's generator state (it
           builds both from one key), and four more from BUILD_SEEDS:
           k-means alone moves one build's recall by more than 0.01
           here, so recall_within_rebuild is held against the five
           builds' mean (its margin printed), the one build's comparison
           printed beside it and the churned index's rank among the
           builds; the card's k-means sums in a fixed order, so a seed
           builds one index and these recalls repeat run to run. How much of a
           background pass the serving loop hides: batches of 512 with no
           pass in flight, then while one runs (without and with the
           tracker's re-encode); hidden = the worker's time less what the
           submit, the swap's poll and the slower batches add to the
           serving thread;
  rq       a depth-2 residual (RQ) index on main's corpus and R at the
           serving width (codes M·D = 64 bytes a row): build, the 649
           queries at nprobe 8, 32 and 128 and the flat scan of its codes,
           a subspace-GCD refresh without a rebuild, serve again, then an
           Engine over a fused-refresh RQ state with int8 tables through
           one within-subspace refresh. Held: rq_beats_pq_quantization
           against main's PQ index (residual distortion of RQ_SAMPLE rows
           strictly lower, flat recall@10 against exact no lower;
           benchmarks/ivf_recall_qps.py:384-393), rq2_end_to_end (refresh
           mismatch ≤ RQ_MISMATCH_LIMIT; the flipped rows that first differ
           at a level-0 float32 tie are counted and printed), nprobe = L
           against the flat scan, some nprobe at recall ≥ 0.9 against the
           flat scan with a ≥ 5× reduction, and the fused Engine's
           executables and tables. Kernels on the phase's operands:
           ivf_adc (serve_p99) and adc_lookup (the flat check) at Dp = 64
           bit-equal in every LUT type, fused_lut with the level-major
           column map (the Engine's call), pq_assign on the build's last
           level-1 residuals (ties counted) and givens_rotate on the
           stacked (M·K, n) codebook rows, bit-equal; the scans and
           fused_lut timed beside their bounds and library yardsticks;
  train_e2e
           repro_torch.bench.train_e2e's loop on main's PQ index (nprobe
           32, the 512 serve_p99 queries as probes): a GCD-G trainer on
           the JAX script's loss at batch TE_BATCH for TE_STEPS steps with
           a prefetching pipeline, LiveIndexLoop refreshing the Engine
           every TE_REFRESH_EVERY steps, a ChurnController (the churn
           phase's buffer, TE_CHURN_BATCH deletes and adds every
           TE_CHURN_EVERY steps) and a BackgroundCompactor re-encoding
           TE_REENCODE_ROWS stalest rows every TE_COMPACT_EVERY rounds;
           the bare, bg and sync arms and the replayed rebuild arm. Held:
           zero_steady_recompiles (no new executable, every state shape
           and max_blocks unchanged after the warm-up),
           recall_matches_rebuild, background_ran, prefetch_effective,
           training_converged, LiveIndexLoop.stats() and each part's
           launches (train step, churn step, refresh, probe, background
           or synchronous pass, counted by thread); gcd_score, pq_assign,
           ivf_adc, adc_lookup and givens_rotate on the bg arm's last
           operands. Reported: live_step_overhead_ok and
           bg_p99_below_sync with their values and margins, each arm's
           step p50 / p99 and its host ms by part;
  serve    repro_torch.bench.serve_load's cells (serve_cells) over two
           namespaces at the serving index's width: alpha main's 1M-row
           index attached as a fused-refresh state (with a
           ChurnController's 256-row buffer), beta a second 1M-row
           sift_like corpus from SERVE_BETA_SEED built as main builds; the
           JAX script's traffic (SERVE_LADDER 2 / 8 / 32, SERVE_TRAFFIC:
           1,500 requests, load 1.1, SLO 4× the top rung's bucket time,
           admission 2 ms, buckets of 16, a cross-subspace GCD refresh of
           alpha every 200 arrivals, 30% warm-up), one trace replayed by
           the three fixed cells and the adaptive one after three
           calibration frontends (the median top-rung time sets the
           rate). Held: the script's five non-timing checks, both built
           states bit-equal after the cells, SERVE_SAMPLES served tickets
           a cell equal to a direct IVF.search of the row at the rung it
           was served at on the state that served it (ids, or a float32
           tie; scores within ATOL and RTOL), beta's build's launches equal
           main's build's, each part's launches (flushes, warm-ups:
           one ivf_adc a submit, one fused_lut a submit with a table
           miss, one adc_lookup a submit on alpha's buffer; refreshes:
           gcd_score 1 and givens_rotate 3 each; idle ticks none), and
           ivf_adc at each rung on alpha's window and beta's, fused_lut at
           each miss width, the side pass, gcd_score, givens_rotate and
           beta's build's last pq_assign against their plain versions.
           Reported: adaptive_beats_best_fixed_p99_at_equal_recall with
           its margin, each cell's p50 / p99, recall@10 against exact, SLO
           attainment, QPS, rung mix and EWMA per (bucket, rung), the
           queue waits, host ms by part, and ivf_adc's times at bucket 16
           beside their bounds and F.embedding_bag; the result is written
           through obs.write_bench into a temporary directory and
           validated;
  sharded  the row-sharded serving family (search.sharded) on main's
           1M-row index, SHARDS = 4 shards laid on the one card
           (make_data_mesh(4, devices=("cuda:0",) * 4)): ivf_sharded and
           flat_sharded attached (shard_split by id rank, codes carried),
           held bit-equal to the single-device ivf at batches 512 / 100 /
           37 and nprobe 8 / 32 / 128 and to flat_adc on 64 queries, and
           exact_sharded against exact (ids equal, scores within ATOL),
           the shares of equal ids and scores printed; the summed scanned
           held equal to the shards' probe windows and at least the single
           index's, each shard's share within SHARD_SHARE of 1/4;
           sharded_parity (recall ≥ 0.999 against each replicated twin);
           an eager refresh of the sharded state (rotate_components on
           every replica) bit-equal to the refreshed single index;
           build_sharded from 4 chunks of 250,000 rows with the coarse fit
           by vq_kmeans_sharded on the mesh, its recall@10 against the
           flat scan of its codes and against exact beside the single
           build's (held within SHARD_BUILD_RECALL); an Engine over a
           fused-refresh ivf_sharded state through ENGINE_SIZES, a
           subspace-GCD refresh, no new executable, its results on
           unseen queries bit-equal to a direct sharded search; the churn
           --devices cell: a ChurnController (buffers of CHURN_STAGING
           rows a shard, rebalance at 1.03) removing the lowest live ids
           (shard 0's) and adding CHURN_BATCH rows a step until the
           trigger fires, the flat top-k of the live set (every packed and
           staged row) bit-equal before and after the rebalance, no
           tombstoned id served, the first step's
           staged rows served by the side passes bit-equal to the single
           index with the same buffer. ivf_adc, adc_lookup and pq_assign
           timed at a shard's shapes beside their plain versions, bounds
           and library calls (the four shards' scans beside the single
           index's), the sharded and single batch latency; the six
           kernels of the path (SHARDED_KERNELS) held against their plain
           versions at every shape the phase launched them at, the
           sharded ivf and flat searches' launches exact. The 1M-row index
           is freed after;
  train    the training slice at the full width of the paper's two-tower
           model (configs/paper_twotower.make_config: 1,541,673 items,
           embedding 512, towers (512, 512), history 16, D = 64, K = 256)
           by the protocol of benchmarks/fig3_table1_e2e.py: warm-up steps
           without the index layer, an OPQ warm start of (R, codebooks),
           then the same joint steps from the same warm start for each row
           of the paper's Table 1 (frozen, cayley_sgd, gcd_random,
           gcd_greedy, gcd_steepest), and for each the whole corpus
           encoded through the item tower and retrieved by ADC for p@50 /
           r@50, with the five fig3 checks reported (at 20 steps a result,
           not a gate). Every trainable R stays orthogonal to 1e-5 and
           moves; the frozen R stays bit-equal. Counts are set to 0 just
           before and read just after, with the exact launches each part
           implies checked. Cut to fit a run:
           the step counts (10 warm-up, 20 joint), OPQ iterations (10) and
           the batch (16,384, not RECSYS_SHAPES train_batch 65,536: the
           in-batch (B, B) hinge loss is 17 GB per temporary there, and the
           JAX package has no chunked loss to port);
  train_kernels
           givens_rotate, pq_assign and embedding_bag against their plain
           versions on the operands the train phase gave them, plus ragged
           shapes (odd n with unpaired columns, givens_rotate's run edges
           at (8192, 256), 8,197 and 15 rows and an unaligned X, the
           coarse-VQ shape with a row of its own, m not a multiple of the
           tile, one row, sub = 16 and 17 on either side of pq_assign's
           two bodies, weights, padding and empty bags) and the
           rotation's backward, timed like the others; adc_lookup on the
           eval retrieval's own tables
           (Dp = 64) over the encoded corpus, and gcd_score on the last GCD
           step's (G, R) at n = 512 beside its torch.matmul yardstick;
           gcd_score and givens_rotate also on the GCD-R and GCD-S rows'
           last (G, R) and deltas, whose pairs must be perfect matchings,
           GCD-S's the 2-opt refinement of its A, at least as heavy as the
           greedy matching; Cayley-SGD's last step against the same step
           on the CPU, at the path's lr and at an lr that moves Δ by 1e-2;
  table1   repro_torch.bench.fig3_table1_e2e.run() on the card at the JAX
           script's default sizes (make_smoke, 1,024 items, 40 warm-up and
           250 joint steps of batch 64, five rows), under deterministic
           algorithms; the five fig3 checks and their margins reported,
           those in TABLE1_HELD held, the launches its steps imply
           checked, and each of its five kernels held against its plain
           version on the operands of its last call in the run;
  fig4     repro_torch.bench.fig4_runtime.run() at the JAX script's dims
           (n = 64, 128, 256, 512): every registry learner's update at
           batch 1 (wall µs, the paper's quantity, and CUDA-event µs), the
           serial and round-wise greedy matchings and the Procrustes solve.
           Held: gcd_r_faster_than_cayley_at_512 and gcd_scales_better,
           every R orthogonal to 1e-5 after its learner's timed calls
           (Cayley-SGD to CAYLEY_RTOL of how far it moved R), the launches
           the calls imply, and gcd_score and givens_rotate on the last
           operands of each n. Reported: the SVD-projected update over
           GCD-R at 512, and GCD-R's step at 512 split into score, pair
           draw, angles, the disjointness check's host sync and apply;
  fig2     repro_torch.bench.fig2a_convergence.run() and
           fig2bc_stability.run() at the JAX scripts' defaults and seeds,
           under deterministic algorithms. Held: every trace finite,
           every final R orthogonal to 1e-4, the frozen R the identity,
           the launches the OPQ loops imply, and gcd_score, givens_rotate
           and pq_assign on the last operands of each shape. Reported, as
           the JAX scripts report them: the six fig2a checks and
           gcd_more_stable, each with its margin;
  decode   PQ-compressed KV-cache decode of olmo-1b at the full width of
           configs.get("olmo-1b").config_for_shape("long_500k") (16
           layers, d_model 2048, 16 heads of 128, KVQuantConfig(128, 16,
           256), bf16 weights from the seeded init, batch 1, a cache of
           524,288 positions). Cut to fit a run: a prompt of 4,096 seeded
           tokens is prefilled (prefilling all 524,288 is O(S²) attention);
           the KV codebooks are fitted per layer by PQ.fit on the prompt's
           K·R and V·R (R the identity init gives; the init's 0.02-scale
           codebooks would make the accuracy checks empty); positions
           4,096 … 524,279 are filled by tiling the prompt's codes and the
           length set to 524,280, so the last of 8 greedy decode tokens
           attends over every position. Counts are set to 0 just before and
           read just after, and checked against what the path implies
           (adc_batch 16 a token, pq_assign 2 a layer a prefill and a
           token, plus the fit's). Checked: compressed attention of the
           last token's last layer, over all S positions, against dense
           attention over decode_k/decode_v of the same codes (1e-4 of the
           largest entry); reported: PQ against a dense cache at the
           prompt's length (top-1 agreement, largest logit gap), per-token
           decode time, a per-layer device split by CUDA events, peak
           memory and cache bytes against a dense bf16 cache;
  decode_kernels
           adc_batch against its plain version on the decode's own operands
           (bit-equal for float32 tables, 1e-5 of the largest entry for
           int8/uint8 packs), on Nemotron's KV geometry (r = 12, Dp = 24,
           tables staged in three chunks of four), on Dp = 16 with r = 3
           and S not a multiple of a block's rows, timed (the decode's
           operands and Nemotron's) beside its plain version, its bound and
           one F.embedding_bag over per-group offsets; pq_assign
           on the last token's last encode (16 rows), timed;
  lm_train LM training on the port at olmo-1b's full width (16 layers,
           d_model 2048, bf16, 1.28B parameters), the card freed between
           its two arms. The kvq arm mirrors launch/cells.py's LM train
           cell: long_500k's KVQuantConfig(128, 16, 256) with
           train_kv_quant, forward_train with remat, _opt_cfg_for's
           optimizer (AdamW lr 3e-4, clip 1.0, float32 moments, GCD-G at
           lr 1e-3 on the stacked kvq/rot_k and rot_v), LMT_STEPS steps of
           seeded lm_batch tokens at train_4k's sequence (4,096), batch 8
           as two microbatches (cut: train_4k's 256 with accumulation 8 is
           a pod's batch). Held: losses finite and the last below the
           first, every layer's R moved and orthogonal within the bf16
           bound lm_orth_bound, the launches exactly as the path implies
           (lm_train_launches), and pq_assign, gcd_score and givens_rotate
           on the last step's operands against their plain versions,
           timed beside their bounds and library calls. Reported: step
           ms p50 / p95, tokens/s, the device split by CUDA events, peak
           memory, the loss and KV-term trajectories, ‖R − I‖_F, and the
           trained and the initial kvq leaves through serve_prefill (4,096
           tokens) and 8 serve_decode tokens on a PQ cache against a dense
           one (top-1 agreement; its launches checked). The launcher arm:
           launch.train("olmo-1b", full=True, batch 32, 8 steps), then the
           same job stopped after 4 with a checkpoint under build/ and
           resumed, under deterministic algorithms; the final loss held
           within rtol 1e-4 of the straight run's, no kernel launched
           (dense), the parameters' bit-equality, the checkpoint's bytes
           and save / restore seconds and the free disk reported;
  moe      MoE on the port at full width and MOE_LAYERS layers
           (models/moe.py, the dense/MoE interleave, moe_chunk, Adafactor),
           the card freed between the architectures. moe_block in float32
           against a plain per-token reference in float64 (the same
           float32 routing; each (token, choice) in order takes its
           expert's next slot while one is left), within MOE_RTOL of the
           largest entry: at grok-1's width (d 6,144, d_ff 32,768, 8
           experts, top-2) on 512 tokens, and at llama4's 128 experts
           (top-1) on 4,096 tokens at capacity factor 0.5, so about half
           of them drop (d_ff cut to 1,024: 8,192 in float32 is 64 GB).
           grok-1-314b (2 of its 64 layers, bf16, 11.45e9 parameters):
           serve_prefill of prefill_32k's 32,768 tokens at batch 1 into a
           dense cache with moe_chunk 16,384 (two chunks; the shape's
           131,072 would need 21.5 GB (E·C, d_ff) buffers), no kernel; 6
           train steps of train_4k's 4,096 tokens at batch 1
           (accumulation 1: the 16 is ROADMAP 14d) with the KV term of
           long_500k's KVQuantConfig(128, 16, 256),
           launch.cells._opt_cfg_for's Adafactor in bf16 and GCD-G on
           the stacked kvq rotations, under deterministic algorithms (the
           loss falls, every R moved and within lm_orth_bound, launches
           exact); then the decode phase's PQ path on the trained weights:
           a 4,096-token prompt, the KV codebooks fitted per layer, 524,288
           positions filled by tiling, 4 greedy tokens, compressed against
           dense attention on the last layer, and PQ against a dense cache
           of 32,768 positions (top-1 agreement, largest logit gap).
           llama4-maverick-400b-a17b (2 of 48 layers: one dense/MoE block,
           128 experts, 18.43e9 parameters): the prefill (one chunk) and
           the decode; it does not train on one card (parameters and
           gradients alone are 73.7 GB). A memory reckoning is printed
           before each arm and the peak after it; each MoE call's route /
           dispatch / experts / combine split (CUDA events), its entries
           over capacity and aux; pq_assign, gcd_score, givens_rotate and
           adc_batch held against their plain versions at every shape the
           phase launched them at, and timed;
  zoo      the model zoo at the configs' full widths: GraphSAGE
           (graphsage-reddit adjusted to minibatch_lg: d_in 602, d_hidden
           128, 2 layers, 41 classes, fanout (15, 10)) trained ZOO_GNN_STEPS
           minibatch steps of 1,024 seeds on a synthetic graph of 232,965
           nodes at average degree 492 (114.5M edges; the blocks sampled
           on the host, gathered on the card), twice from one seed under
           deterministic algorithms (losses finite and falling, the runs
           bit-equal); gnn_index on its full-graph embeddings
           (bench/gnn_index.py: OPQ with PQConfig(8, 32) frozen and GCD-G,
           flat_adc, neighbour recall@10 of 1,000 nodes against exact; R
           orthogonal to 1e-5, launches exact, pq_assign, gcd_score,
           givens_rotate and adc_lookup held against their plain versions
           at its shapes and timed); full-batch training at full_graph_sm's
           sizes (2,708 nodes, d_in 1,433) and graph-batch training at
           molecule's (128 graphs of 30 nodes and 64 edges, d_in 64), each
           under mean and max, twice from one seed; then launch.train at
           the full config of graphsage-reddit (1,024 seeds), wide-deep
           (40 × 1M × 32, batch 65,536), mind (2M × 64, batch 16,384: the
           (B, I, B) scores are 68.7 GB at 65,536) and din (1M × 18,
           batch 65,536), straight and stopped-and-resumed under
           deterministic algorithms (the final losses within 1e-4, no
           kernel launched), with Wide&Deep's serve_p99 forward, MIND's
           retrieval over 1M candidates against float64 and DIN's bulk
           scoring of 1M candidates. A memory reckoning is printed before
           each arm and the peak beside it;
  dryrun   the launch layer (launch.cells, launch.dryrun, roofline) on the
           card: olmo-1b × train_4k at DRY_MICRO sequences a microbatch
           [cut: 32] and the cell's accumulation of 8, DRY_STEPS steps at
           full depth and at DRY_DEPTHS layers, the fit to 16 layers held
           within DRY_HELD of the measurement in peak bytes and in the
           fastest step's microbatch time;
           then launch.dryrun.run_cell's records of two-tower-retrieval ×
           train_batch (at DRY_TT_BATCHES [cut: 65,536]), its
           retrieval_cand, olmo-1b's and grok-1's long_500k (grok-1 does
           not fit one card whole: two depths, fits_hbm false),
           graphsage-reddit × molecule and wide-deep × serve_p99, each
           printed on its own line and held complete (every JAX key,
           model_flops_total the cell's, the launches its runs imply);
           embedding_bag, pq_assign, gcd_score, givens_rotate, adc_lookup
           and adc_batch held against their plain versions on the
           operands of their last call at each shape;
  tooling  the rest of queue 1: one GCD-G step of a stacked (2, 128, 128)
           bf16 rotation (the learner state's R bf16 and bit-equal to the
           leaf, R within lm_orth_bound(1)); training.grad_compress over
           two spawned gloo ranks on the one card, four steps of error
           feedback on 16M-element gradients from a seed, each step
           bit-equal in every rank to a one-process reference of the same
           formulas and the same on both ranks, with a case of equal
           positive gradients whose int8 sum wraps as the JAX package's
           does (payload bytes and ms a step printed); GraphSAGE's blocked
           aggregation against gnn.aggregate_edges_ref on a 4,000-node
           graph in 82 blocks (forward bit-equal, gradients within 1e-5
           of the largest entry, mean and max); graphsage-reddit ×
           ogb_products whole through launch.dryrun.run_cell (2,449,030
           nodes, 61.9M edges, three timed steps under deterministic
           algorithms, twice: losses finite and bit-equal, fits_hbm,
           nothing reduced, peak and step printed); the three examples
           (repro_torch.examples) at their JAX scripts' defaults through
           their main: quickstart (exact recall 1.0, GCD-G below frozen,
           every R orthogonal to 1e-4), serve_ann (no new executable after
           the refresh, refresh_mismatch ≤ 1%, recall before and after)
           and train_twotower straight and resumed from its step-300
           checkpoint (loss and p@50 bit-equal), every kernel they
           launched held against its plain version at each shape;
  sharded_train  Wide&Deep at its full config (40 fields × 1,000,000 rows
           × 32, MLP 1280-1024-512-256-1) and the zoo's batch of 65,536,
           its table and wide leaves placed on a (data 1, model 4) mesh of
           ("cuda:0",) * 4 (1.28 GB a table piece), batches from the
           pipeline with the cell's input shardings, under deterministic
           algorithms. Arm A runs psum_lookup=True (embedding
           .sharded_lookup), arm B the same init and batches with the
           plain gather; 4 AdamW steps each (launch.cells._opt_cfg_for).
           Held: step-1 logits bit-equal, every table piece's step-1
           gradient bit-equal to its rows of B's, the losses within 1e-6
           relative at every step, and A's step-2 checkpoint (one table
           entry, the JAX layout) restored at 2 shards and at 1 reaching
           step 4 within 1e-6 of A's losses. Prints each arm's
           synchronised step ms (p50), its peak memory and the piece
           bytes, and the checkpoint's bytes and seconds. The path reaches
           no hand-written kernel (the JAX one is jnp.take inside
           shard_map): its launches are held at none.
Every check raises on failure, so the script exits non-zero with the error;
it also exits non-zero without a CUDA device. The last three lines are the
nvidia-smi line, the per-kernel JSON summary and the device JSON. A
kernel's launches there are those of the paths' own calls, summed,
with the split by path: serving's learn, build, serve and refresh; the
Engine's attach, requests and refreshes (with the learner steps that give
their deltas); churn's attach, first search and both runs' steps; rq's
build, serving, flat scan, refresh and fused Engine; train_e2e's three
arms; serve's build of beta and its seven frontends; sharded's attach,
searches, refreshes, build_sharded, Engine and churn steps;
train's parts; table1's run; fig4's and fig2's runs;
decode's prefill and greedy tokens; lm_train's kvq steps, and its decode
of the trained and initial leaves; moe's PQ prefills, greedy tokens and
train steps; zoo's gnn_index; dryrun's cells; tooling's bf16 rotation
step; the examples' runs; sharded_train's arm A (none). The checks that run beside them in a phase's window are left out.
"""
from __future__ import annotations

import contextlib
import functools
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

SEED = 0
N, DIM, D, K, L, BS = 1_000_000, 256, 32, 256, 1024, 128
TRAIN = 65536
BATCHES = (512, 100, 37)           # serve_p99 and two ragged sizes
NPROBES = (8, 32, 128)
SERVE_NPROBE = 32                  # the index's default probe width
#: benchmarks/ivf_recall_qps.py:265: some nprobe reaches this recall@10
#: against the flat ADC scan of the same codes at this scan reduction
ACCEPT_RECALL, ACCEPT_REDUCTION = 0.9, 5.0
FLAT_QUERIES = 64
EXACT_TILE = 4096                  # corpus rows per tile of the exact scan
GCD_STEPS, GCD_LR = 4, 1e-3
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
FP32_FLOP_PER_S = 67e12            # H100 SXM float32, outside tensor cores
ATOL, RTOL = 1e-4, 1e-5            # scans: Dp float32 sums
GCD_ATOL = 1e-5
GCD_RAGGED = (48, 200, 520)        # gcd_score beside the path's n = 256
#: pq_assign's shapes (m, D, K, sub): the paths' own (the joint step, the
#: OPQ sample, the serving build's residuals and coarse quantizer, a decode
#: step, one row, a ragged m and K) and the edges of the kernel's bodies
#: (sub = 16 | 17: resident | tiled; 3036 | 3040: rows kept | streamed;
#: 3041: streamed by 4-byte copies). train_kernels holds the kernel to its
#: plain version on each, on the train path's own operands where it has
#: them; kernel_bench.py times every entry on ``assign_operands``.
ASSIGN_SHAPES = {
    "joint_step": (16_384, 64, 256, 8),
    "opq_sample": (65_536, 64, 256, 8),
    "serve_residuals": (65_536, 32, 256, 8),
    "coarse_vq": (100_003, 1, 1024, 256),
    "decode": (16, 16, 256, 8),
    "one_row": (1, 64, 256, 8),
    "ragged_m_K": (1001, 64, 200, 8),
    "sub16": (4096, 2, 256, 16),
    "sub17": (4096, 1, 200, 17),
    "sub3036": (300, 1, 200, 3036),
    "sub3040": (300, 1, 200, 3040),
    "sub3041": (300, 1, 200, 3041),
}
MISMATCH_LIMIT = 1e-3              # about 1e-4 seen on an H100 at N = 1M
TIE_GAP = 1e-5                     # a code flip this close is a float32 tie
SOURCES = {  # kernel: (CUDA source, the TPU kernel it replaces)
    "ivf_adc": ("src/repro_torch/kernels/csrc/adc_scan.cu",
                "src/repro/kernels/ivf_adc.py:78"),
    "adc_lookup": ("src/repro_torch/kernels/csrc/adc_scan.cu",
                   "src/repro/kernels/adc_lookup.py:53"),
    "gcd_score": ("src/repro_torch/kernels/csrc/gcd_score.cu",
                  "src/repro/kernels/gcd_score.py:51"),
    "givens_rotate": ("src/repro_torch/kernels/csrc/givens_rotate.cu",
                      "src/repro/kernels/givens_rotate.py:36"),
    "pq_assign": ("src/repro_torch/kernels/csrc/pq_assign.cu",
                  "src/repro/kernels/pq_assign.py:35"),
    "embedding_bag": ("src/repro_torch/kernels/csrc/embedding_bag.cu",
                      "src/repro/kernels/embedding_bag.py:44"),
    "fused_lut": ("src/repro_torch/kernels/csrc/fused_lut.cu",
                  "src/repro/kernels/lut_build.py:55"),
    "adc_batch": ("src/repro_torch/kernels/csrc/adc_scan.cu",
                  "src/repro/kernels/adc_batch.py:38"),
}
#: The kernels each path runs: the serving path's index build assigns codes
#: and its refresh rotates; the training path adds the EmbeddingBag.
SERVE_KERNELS = ("ivf_adc", "adc_lookup", "gcd_score", "pq_assign",
                 "givens_rotate")
TRAIN_KERNELS = ("gcd_score", "givens_rotate", "pq_assign", "embedding_bag",
                 "adc_lookup")

# engine phase: the Engine over a fused-refresh IVF state on main's index
ENGINE_REQUESTS = 48
ENGINE_SIZES = (512, 100, 37, 1, 300, 64)
LUT_RTOL = 1e-5                    # fused_lut: of the table's max |entry|
#: the batch sizes whose slices of one 512-query batch must give that
#: batch's fused_lut tables bit for bit
LUT_SLICES = (1, 8, 37, 64, 128, 300)
#: fused_lut's device ms per launch at serve_p99 and the Engine's
#: buckets while its runs of sums still moved with the batch (PERF.md §6)
LUT_BEFORE_MS = {512: 0.01203, 8: 0.00503, 64: 0.00559, 128: 0.00626}

# churn phase: live churn on the engine phase's index (bench/churn.py)
CHURN_STEPS, CHURN_BATCH = 24, 2048
CHURN_STAGING, CHURN_FLUSH_AT, CHURN_COMPACT_AT = 4096, 0.5, 0.03
#: the second run, with a BackgroundCompactor: its steps and a threshold
#: low enough for a pass to fire in them (1% of the CSR, 5.5 steps)
BG_STEPS, BG_COMPACT_AT, BG_REENCODE_ROWS = 8, 0.01, 256
#: held-out rows of main's sift_like draw, the churn phase's adds
CHURN_ADDS = (CHURN_STEPS + BG_STEPS) * CHURN_BATCH
#: the side pass's adc_lookup held at these batches, its buffer half full,
#: full and empty
SIDE_BATCHES = (1, 32, 512)
#: more fresh builds of the live rows, from these seeds: recall_within_rebuild
#: is held against the mean of these and the JAX script's build (k-means
#: alone moves one build's recall by 0.018 at N = 1M, PERF.md §6)
BUILD_SEEDS = (11, 12, 13, 14)
#: batches of 512 served with no background pass in flight, the baseline of
#: what a pass in flight adds to the serving loop
HIDE_IDLE_BATCHES = 16

# rq phase: a depth-2 residual index on main's corpus and R, at the serving
# index's width (codes 64 B a row)
RQ_DEPTH = 2
RQ_SAMPLE = 4096                   # residual distortion rows (the JAX script)
RQ_MISMATCH_LIMIT = 0.01           # its rq2_end_to_end

# train_e2e phase: benchmarks/train_e2e.py's loop on main's PQ index, with
# the serve_p99 queries as probes (PERF.md §4 lists each departure from the
# script's defaults)
TE_STEPS, TE_BATCH = 120, 16_384
TE_REFRESH_EVERY, TE_COMPACT_EVERY = 8, 2
TE_REENCODE_ROWS = 51_200          # the script's 2,048 of 40,000 rows: 5.12%
TE_CHURN_BATCH, TE_CHURN_EVERY = 1024, 2
TE_WARMUP, TE_PROBE_EVERY = 34, 12

# serve phase: benchmarks/serve_load.py's traffic over two namespaces at
# the serving index's width: alpha main's index, beta a second corpus
SERVE_LADDER = (2, 8, 32)          # the top rung is the index's nprobe
SERVE_TRAFFIC = dict(requests=1500, load=1.1, slo_factor=4.0,
                     admission_ms=2.0, max_admit=16, refresh_every=200,
                     warm_frac=0.3)
SERVE_POOL = 64                    # each namespace's query pool
SERVE_BETA_SEED = SEED + 30        # beta's corpus, rotation, build, pool
SERVE_SAMPLES = 48                 # tickets a cell held to a direct search
SERVE_TIMING = "adaptive_beats_best_fixed_p99_at_equal_recall"

# train phase (cut to fit a run; see the module docstring)
#: table1 phase: benchmarks/fig3_table1_e2e.py run()'s default sizes and
#: seed, and the checks it holds: all five. The run is deterministic, so
#: the card gives one answer for the seed (PERF.md §6: at seed 0 every
#: check holds; at seeds 1 and 3 trainable_beats_frozen fails on the card,
#: at seed 3 on the JAX package too)
TABLE1_SIZES = dict(steps=250, warmup=40, batch=64, item_vocab=1024)
TABLE1_HELD = ("trainable_beats_frozen", "greedy_le_random",
               "steepest_le_greedy", "cayley_r_trains", "frozen_r_stays")
TRAIN_BATCH = 16_384               # RECSYS_SHAPES train_batch is 65,536
WARMUP_STEPS, JOINT_STEPS = 10, 20
OPQ_SAMPLE, OPQ_ITERS = 65_536, 10
TRAIN_LR = ROT_LR = 3e-3           # benchmarks/fig3_table1_e2e.py
SCHEDULE_WARMUP = 10
CLICK_DIM = 32                     # the click log's latent width (fig3)
EVAL_QUERIES, EVAL_K = 256, 50
TOWER_CHUNK = 262_144              # item-tower rows per call in the encode
ASSIGN_GAP = 1e-5                  # a pq_assign flip this close is a tie
BAG_RTOL = 1e-5
DTHETA_RTOL = 1e-4
CAYLEY_ATOL = 1e-5                 # Cayley-SGD's step, card against CPU
CAYLEY_MOVE = 1e-2                 # max |Δ − I| of the moved step
#: the moved step's error against float64, of how far it moved: a wrong
#: step (Δ = I, a pull-back off by a factor or a sign) misses by 50–200%;
#: float32 rounding on an H100 left 3.2e-4 and 4.9e-4 against the CPU
CAYLEY_RTOL = 1e-2


def engine_buckets() -> list:
    """The batches the engine phase's Engine pads ENGINE_SIZES' requests
    to, asked of an Engine built as that phase builds it."""
    from repro_torch import search

    engine = search.Engine(search.make("ivf"), None, k=10)
    return sorted({engine._bucket(s) for s in ENGINE_SIZES})


def ivf_cases() -> dict:
    """ivf_adc's cases, one table for this script and kernel_bench.py: b
    queries at SERVE_NPROBE over the serving index, at serve_p99 (the
    Engine's bucket 512 has the same shape) and at the Engine's other
    buckets."""
    return {"serve_p99": BATCHES[0],
            **{f"bucket_{b}": b for b in engine_buckets() if b != BATCHES[0]}}


def flat_cases() -> dict:
    """adc_lookup's cases for kernel_bench.py, (b, Dp, rows): the flat
    check over the serving index (rows None: its capacity) and the train
    phase's eval retrieval over paper_twotower's corpus."""
    from repro_torch.configs import paper_twotower

    cfg = paper_twotower.make_config()
    return {"flat_check": (FLAT_QUERIES, D, None),
            "train_eval": (EVAL_QUERIES, cfg.index.num_subspaces,
                           cfg.item_vocab)}


def rotate_cases() -> dict:
    """givens_rotate's (m, n) on the paths, one table for train_kernels'
    holds and kernel_bench.py: training's R at paper_twotower's index
    width, the serving refresh's R, coarse centroids and codebook rows (the
    Engine's fused refresh rotates two matrices of R's shape), and the
    (TRAIN_BATCH, 512) batch of the backward train_kernels holds."""
    from repro_torch.configs import paper_twotower

    nt = paper_twotower.make_config().index.dim
    return {"train_R": (nt, nt), "serve_R": (DIM, DIM),
            "centroids": (L, DIM), "codebook_rows": (D * K, DIM),
            "backward": (TRAIN_BATCH, nt)}


#: batches at which the kernels phase holds both scans bit-equal to their
#: plain versions, beside the Engine's buckets; and a code row that is not
#: whole 16-byte words
SCAN_CHECK_BATCHES = (1, 5, 64, 512)
NARROW_DP = 24
ODD_K = 200                        # codewords: not a multiple of 16

# decode phase (cut to fit a run; see the module docstring)
DECODE_ARCH, DECODE_SHAPE = "olmo-1b", "long_500k"
PROMPT_LEN = 4096
DECODE_TOKENS = 8
FIT_ITERS = 10                     # k-means iterations of the codebook fit
ATTN_RTOL = 1e-4                   # compressed vs dense attention
BATCH_RTOL = 1e-5                  # adc_batch on int8/uint8 packs
SPLIT_REPS = 5                     # repetitions of the per-layer split
DECODE_KERNELS = ("adc_batch", "pq_assign")


# lm_train phase (cut to fit a run; see the module docstring)
LMT_ARCH, LMT_SHAPE = "olmo-1b", "long_500k"
LMT_SEQ, LMT_BATCH, LMT_ACCUM, LMT_STEPS = 4096, 8, 2, 12
LMT_LR, LMT_ROT_LR = 3e-4, 1e-3   # launch/cells.py _opt_cfg_for (< 50B)
#: the launcher arm: launch.train's job, then the same job stopped after
#: LMT_STOP_AFTER steps and resumed; JAX's rtol on the final loss
LMT_LAUNCH_STEPS, LMT_LAUNCH_BATCH, LMT_STOP_AFTER = 8, 32, 4
LMT_RESUME_RTOL = 1e-4
#: bf16's unit roundoff: a bf16 rotation leaf is R rounded entrywise
BF16_U = 2.0 ** -8
LMT_PROMPT, LMT_DECODE_TOKENS = 4096, 8
LMT_KERNELS = ("pq_assign", "gcd_score", "givens_rotate")


# moe phase (cut to fit a run; see the module docstring)
MOE_ARCHS = ("grok-1-314b", "llama4-maverick-400b-a17b")
MOE_TRAIN_ARCH = "grok-1-314b"     # llama4's params and grads are 73.7 GB
MOE_LAYERS = 2                     # 64 and 48 layers are 630 and 800 GB
MOE_SEQ = 32768                    # prefill_32k's sequence, at batch 1
#: prefill_32k's moe_chunk (131,072) cut so grok's prefill runs two chunks
MOE_CHUNK = {"grok-1-314b": 16384}
MOE_PROMPT, MOE_DECODE_TOKENS = 4096, 4
MOE_PQ_LEN = 524288                # long_500k's PQ cache
MOE_DENSE_LEN = 32768              # the dense cache beside it
MOE_TRAIN_SEQ, MOE_TRAIN_STEPS = 4096, 6   # train_4k's sequence at batch 1
MOE_CHECK_TOKENS = 512
MOE_RTOL = 1e-4                    # moe_block vs float64: of the largest
#: the 128-expert check: factor 0.5 over 4,096 tokens gives 16 slots an
#: expert for 32 tokens on average, so about half drop (512 tokens would
#: get the floor of 8 slots for 4 and drop almost none); d_ff 8,192 in
#: float32 would be 64 GB
MOE_DROP_FACTOR, MOE_DROP_TOKENS, MOE_CHECK_FF = 0.5, 4096, 1024
MOE_PARTS = ("route", "dispatch", "experts", "combine")
MOE_KERNELS = ("pq_assign", "adc_batch", "gcd_score", "givens_rotate")
#: the zoo: GraphSAGE's minibatch_lg graph (114,615,892 edges over 232,965
#: nodes: average degree 492), its minibatch steps and the small arms'
ZOO_SEED = SEED + 90
ZOO_AVG_DEGREE = 492
ZOO_GNN_STEPS, ZOO_GNN_LR = 8, 1e-2
ZOO_SMALL_STEPS, ZOO_SMALL_LR = 4, 1e-2
#: gnn_index: examples/gnn_index.py's PQConfig(8, 32) and OPQ settings
ZOO_PQ = (8, 32)
ZOO_OPQ = dict(iters=15, inner_steps=5, lr=2e-3)
ZOO_PROBES = 1000
ZOO_ORTH = 1e-5
#: the launcher arms: RECSYS_SHAPES train_batch 65,536 (MIND 16,384: its
#: (B, I, B) float32 scores are 68.7 GB at 65,536), GraphSAGE 1,024 seeds
ZOO_LAUNCH = {"graphsage-reddit": 1024, "wide-deep": 65536, "mind": 16384,
              "din": 65536}
ZOO_LAUNCH_STEPS, ZOO_STOP_AFTER = 4, 2
ZOO_BATCH_CALLS = 3
ZOO_RESUME_RTOL = 1e-4
ZOO_SERVE_BATCH = 512              # RECSYS_SHAPES serve_p99
ZOO_CANDIDATES = 1_000_000         # RECSYS_SHAPES retrieval_cand
ZOO_KERNELS = ("pq_assign", "gcd_score", "givens_rotate", "adc_lookup")
# dryrun (launch.dryrun's cells on the card)
DRY_MICRO = 2                      # olmo-1b train_4k's microbatch [cut: 32]
DRY_DEPTHS = (2, 4)                # extrapolated to olmo-1b's 16 layers
DRY_HELD = 0.10                    # extrapolated against measured
DRY_STEPS = 3                      # timed steps a depth; the fastest held
DRY_TT_BATCHES = (16_384, 8_192)   # two-tower train_batch [cut: 65,536]
DRY_RECORDS = (("two-tower-retrieval", "retrieval_cand"),
               ("olmo-1b", "long_500k"),
               ("grok-1-314b", "long_500k"),   # does not fit one card whole
               ("graphsage-reddit", "molecule"), ("wide-deep", "serve_p99"))
DRY_KERNELS = ("embedding_bag", "pq_assign", "gcd_score", "givens_rotate",
               "adc_lookup", "adc_batch")
#: operands larger than this are kept by reference, not copied, by the
#: dryrun phase's spies (the two-tower item table is 10.2 GB)
DRY_COPY_BYTES = 1 << 28
# tooling (14c, grad_compress, ogb_products, the three examples)
TOOL_SEED = SEED + 110
TOOL_ROT = (2, 128)                # a stacked bf16 rotation: (L, n)
TOOL_GC_RANKS = 2                  # gloo ranks on the one card
TOOL_GC_STEPS = 4
TOOL_GC_SIZE = 1 << 24             # gradient elements a rank (64 MB f32)
TOOL_GC_PEAK = 2.553               # the equal gradients' largest entry
TOOL_GC_TIMEOUT = 300              # seconds the ranks may take
TOOL_GNN_STEPS = 3                 # timed steps of the ogb_products cell
TOOL_GNN_SMALL = (4000, 40_000, 64)  # nodes, edges, width: blocked vs ref
TOOL_GNN_BLOCK_ROWS = 500          # message rows a block there
TOOL_GNN_RTOL = 1e-5               # gradients: of the reference's largest
TOOL_REFRESH_MISMATCH = 0.01       # serve_ann: tests/test_ivf.py:112
TOOL_ORTH = 1e-4                   # quickstart: ‖RᵀR − I‖ of every learner
EXAMPLE_KERNELS = ("pq_assign", "gcd_score", "givens_rotate", "ivf_adc",
                   "adc_lookup", "embedding_bag")
#: the sharded phase: main's index on SHARDS shards laid on one card
SHARDS = 4
SHARD_DEVICE = "cuda:0"
SHARDED_KERNELS = ("ivf_adc", "adc_lookup", "pq_assign", "fused_lut",
                   "givens_rotate", "gcd_score")
SHARD_SHARE = 0.05                 # a shard's rows scanned: 1/S within this
SHARD_PARITY = 0.999               # benchmarks/ivf_recall_qps.py sharded_parity
SHARD_BUILD_RECALL = 0.15          # tests/test_distributed.py: build_sharded
SHARD_BUILD_SEED = SEED + 120
SHARD_REBALANCE = 1.03             # benchmarks/churn.py's sharded cell
SHARD_COMPACT_AT = 0.05            # its compact_at
SHARD_MAX_STEPS = 24               # the trigger fires at step 15 (PERF.md)
#: sharded_train: Wide&Deep's table over ST_SHARDS shards of one card
ST_ARCH = "wide-deep"
ST_SHARDS = 4
ST_DEVICE = "cuda:0"
ST_BATCH = 65_536                  # RECSYS_SHAPES train_batch (the zoo's)
ST_STEPS = 4
ST_CKPT_AT = 2                     # A's checkpoint; resumed at RESHARD
ST_RESHARD = (2, 1)
ST_SEED = SEED + 130
ST_RTOL = 1e-6                     # losses: global_norm sums in shard order


def lm_orth_bound(steps: int) -> float:
    """The orthogonality bound of a bf16-stored R after ``steps`` GCD steps
    from the identity (ROADMAP.md, parity hazards): each step rotates the
    stored R in float32 (its Gram unchanged, to float32 rounding) and
    rounds every entry to bf16, |F_ij| ≤ u·|Q_ij|, which moves each entry
    of RᵀR − I by at most (2u + u²)(1 + e): e_T ≤ (1 + u)^(2T) − 1; plus
    1e-5 for the float32 products."""
    return (1.0 + BF16_U) ** (2 * steps) - 1.0 + 1e-5

def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


_FLUSH = []


def time_ms(fn, reps: int, warmup: int = 2, flush: bool = True) -> float:
    """Median milliseconds of one call of ``fn`` between a CUDA-event pair,
    over ``reps`` calls, each after a 256 MiB write that evicts the 50 MB L2
    cache (unless ``flush`` is False: back-to-back serving finds it warm).
    The figure includes the host's enqueue time of the call, so it is a
    latency, not a device time, for calls shorter than tens of µs."""
    import torch

    if not _FLUSH:
        _FLUSH.append(torch.empty(1 << 26, dtype=torch.int32, device="cuda"))
    for _ in range(warmup):
        fn()
    events = []
    for _ in range(reps):
        if flush:
            _FLUSH[0].zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def graph_ms(fn, launches: int, reps: int = 10) -> float:
    """Device milliseconds per call of ``fn``: ``launches`` calls captured
    back to back in one CUDA graph, the graph replayed ``reps`` times
    between CUDA-event pairs, the median replay over ``launches``. Unlike
    one event pair around one call from Python, this leaves the host's
    enqueue cost out. The caches are warm, as for back-to-back batches."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(launches):
            fn()
    graph.replay()
    events = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    ms = statistics.median(s.elapsed_time(e) for s, e in events) / launches
    del graph
    torch.cuda.empty_cache()
    return ms


def compare(got, want, atol: float, rtol: float) -> float:
    """Max |got − want| over finite entries; −inf positions must match."""
    import torch

    check(got.shape == want.shape, f"shape {tuple(got.shape)} != "
          f"{tuple(want.shape)}")
    check(torch.equal(torch.isneginf(got), torch.isneginf(want)),
          "−inf positions differ from the plain version")
    fin = torch.isfinite(want)
    check(bool(torch.all(torch.isfinite(got) == fin)), "non-finite output")
    err = (got[fin] - want[fin]).abs()
    ok = bool(torch.all(err <= atol + rtol * want[fin].abs()))
    max_err = float(err.max()) if err.numel() else 0.0
    check(ok, f"max abs error {max_err} beyond atol {atol} rtol {rtol}")
    return max_err


def bit_equal(got, want, what: str) -> float:
    """0.0 if ``got`` equals ``want`` bit for bit (−inf at the same
    places); raises otherwise."""
    import torch

    torch.cuda.synchronize()
    check(got.shape == want.shape and torch.equal(got, want),
          f"{what} is not bit-equal to its plain version")
    return 0.0


def phase_env():
    import torch

    from repro_torch.kernels import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    smi = smi.splitlines()[0]
    cards = subprocess.run(["nvidia-smi", "-L"], capture_output=True,
                           text=True, check=True).stdout.strip().splitlines()
    t0 = time.perf_counter()
    _build.library()
    emit("env", nvidia_smi=smi, torch=torch.__version__,
         device_count=torch.cuda.device_count(), nvidia_smi_L=cards,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         allow_tf32_matmul=torch.backends.cuda.matmul.allow_tf32,
         allow_tf32_cudnn=torch.backends.cudnn.allow_tf32,
         kernel_build_s=time.perf_counter() - t0,
         nvcc_s=_build.build_info.get("seconds"),
         ptxas=_build.build_info.get("ptxas"))
    return smi


# -- main ------------------------------------------------------------------


def _serve(searcher, state, queries, truth, flat_truth, nprobe: int,
           smi: str):
    import torch

    from repro_torch.metrics import recall_at_k

    ids, lat, scanned = [], [], []
    lo = 0
    for bsz in BATCHES:
        qb = queries[lo:lo + bsz]
        lo += bsz
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = searcher.search(state, qb, k=10, nprobe=nprobe)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
        check(res.ids.shape == (bsz, 10) and res.scores.shape == (bsz, 10),
              "result shape")
        check(bool(torch.all(torch.isfinite(res.scores))),
              "non-finite top-10 score")
        ids.append(res.ids)
        scanned.append(res.scanned.float())
    ids = torch.cat(ids)
    return dict(nprobe=nprobe, recall_at_10=recall_at_k(ids, truth),
                recall_vs_flat_adc=recall_at_k(ids, flat_truth),
                rows_scanned_per_query=float(torch.cat(scanned).mean()),
                batch_latency_ms=dict(zip(map(str, BATCHES), lat)),
                card=smi)


def _code_flips(index, X) -> dict:
    """Rows whose stored codes differ from a float32 re-encode against
    ``index``, and for each how far apart, in float64, the stored and the
    re-encoded choice are: the largest gap between their squared
    distances, relative to the distances' scale, over the coarse list and
    every subspace. A flip at a gap of a few float32 roundings is a tie
    that rounding broke the other way, not a stale code."""
    import torch

    from repro_torch.index import ivf

    lists, codes = ivf.encode(X @ index.R, index.coarse, index.quantizer)
    rows = torch.nonzero(index.ids >= 0).squeeze(1)
    item = index.ids[rows].long()
    flip = torch.any(index.codes[rows].int() != codes[item], dim=1)
    rows, item = rows[flip], item[flip]
    out = dict(rows=int(rows.numel()), coarse_flips=0, max_rel_gap=0.0)
    if not rows.numel():
        return out
    x = X[item].double() @ index.R.double()
    C = index.centroids.double()
    ls = torch.searchsorted(index.list_offsets.long(), rows, right=True) - 1
    lr = lists[item].long()
    dc_s = ((x - C[ls]) ** 2).sum(-1)
    dc_r = ((x - C[lr]) ** 2).sum(-1)
    gaps = [(dc_s - dc_r).abs() / ((x ** 2).sum(-1) + (C[ls] ** 2).sum(-1))]
    same = ls == lr
    out["coarse_flips"] = int((~same).sum())
    if bool(same.any()):
        cb = index.codebooks.double()                     # (D, K, sub)
        r = (x[same] - C[ls[same]]).view(-1, D, DIM // D)
        d_idx = torch.arange(D, device=x.device)
        c_s = cb[d_idx, index.codes[rows[same]].long()]   # (m, D, sub)
        c_r = cb[d_idx, codes[item[same]].long()]
        ds = ((r - c_s) ** 2).sum(-1)
        dr = ((r - c_r) ** 2).sum(-1)
        scale = (r ** 2).sum(-1) + torch.maximum((c_s ** 2).sum(-1),
                                                 (c_r ** 2).sum(-1))
        gaps.append(((ds - dr).abs() / scale).amax(dim=1))
    out["max_rel_gap"] = float(torch.cat(gaps).max())
    return out


def serve_config():
    """The serving index's configuration (also kernel_bench.py's)."""
    from repro_torch import search

    return search.SearchConfig(num_lists=L, subspaces=D, codewords=K,
                               block_size=BS, nprobe=SERVE_NPROBE,
                               train_size=TRAIN)


def phase_main(smi: str) -> dict:
    import torch

    from repro_torch import device, rotations, search
    from repro_torch.core import givens
    from repro_torch.data import synthetic
    from repro_torch.index import maintain
    from repro_torch.kernels import ops
    from repro_torch.quant import PQ, PQConfig

    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t_all = time.perf_counter()
    g = device.generator(SEED)
    nq = sum(BATCHES)
    # the corpus, the queries, and the churn phase's adds: one draw
    allx = synthetic.sift_like(g, N + nq + CHURN_ADDS, DIM)
    X, Q, adds = allx[:N], allx[N:N + nq], allx[N + nq:]
    sample = X[:TRAIN]
    torch.cuda.synchronize()
    t_data = time.perf_counter() - t_all

    # learn R: GCD-G steps on the PQ distortion gradient, PQ refit between
    own = {}     # the launches of the path's own calls, without the checks
    t0 = time.perf_counter()
    learner = rotations.make("gcd_greedy")
    gstate = learner.init(DIM)
    trace = []
    with _counted(own):
        for _ in range(GCD_STEPS):
            pq, _ = PQ.fit(g, sample @ gstate.R, PQConfig(D, K), iters=4)
            Rp = gstate.R.clone().requires_grad_(True)
            loss = pq.distortion(sample @ Rp)
            (G,) = torch.autograd.grad(loss, Rp)
            gstate, _ = learner.update(gstate, G, GCD_LR)
            trace.append(loss.item())
    R = gstate.R
    orth_learn = float(givens.orthogonality_error(R))
    check(all(v == v and v < float("inf") for v in trace),
          "distortion not finite")
    check(orth_learn < 1e-5, f"orthogonality error {orth_learn} after GCD")
    t_learn = time.perf_counter() - t0

    # build
    searcher = search.make("ivf")
    cfg = serve_config()
    build_rng = g.get_state()      # the churn phase's fresh-build oracle
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    build_launches = {}      # one build's own (the serve phase's beta)
    with _counted(own), _counted(build_launches):
        state = searcher.build(g, X, R, cfg)
        torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    st = searcher.stats(state)
    check(st["rows"] == N, "index lost rows")

    # ground truths: exact MIPS by the port's exact backend (held against
    # the plain Q·Xᵀ in phase engine), and the flat ADC scan of the codes
    exact = search.make("exact")
    exact_state = exact.build(None, X, R, search.SearchConfig(
        tile_rows=EXACT_TILE))
    truth = exact.search(exact_state, Q, k=10).ids
    flat = search.make("flat_adc")
    flat_truth = flat.search(flat.attach(state.index), Q, k=10).ids
    with _counted(own):
        searcher.search(state, Q[:BATCHES[-1]], k=10)    # warm-up
        serve = [_serve(searcher, state, Q, truth, flat_truth, p, smi)
                 for p in NPROBES]
    recalls = [s["recall_at_10"] for s in serve]
    check(recalls[-1] > 0.0, "zero recall")
    check(recalls[-1] >= recalls[0] - 0.01, f"recall falls with nprobe: "
          f"{recalls}")
    # the IVF recall acceptance of benchmarks/ivf_recall_qps.py:265
    for s in serve:
        s["scan_reduction"] = N / s["rows_scanned_per_query"]
    at_recall = dict(
        sweep=[{k: s[k] for k in ("nprobe", "recall_vs_flat_adc",
                                  "recall_at_10", "scan_reduction")}
               for s in serve],
        recall_vs_flat_min=ACCEPT_RECALL, reduction_min=ACCEPT_REDUCTION)
    at_recall["passed"] = any(
        s["recall_vs_flat_adc"] >= ACCEPT_RECALL
        and s["scan_reduction"] >= ACCEPT_REDUCTION for s in serve)

    # nprobe = L against the flat scan over the same codes
    qf = Q[:FLAT_QUERIES]
    full = searcher.search(state, qf, k=10, nprobe=L)
    ref_res = flat.search(flat.attach(state.index), qf, k=10)
    flat_ids_equal = bool(torch.equal(full.ids, ref_res.ids))
    flat_err = float((full.scores - ref_res.scores).abs().max())
    check(flat_ids_equal, "nprobe = L ids differ from flat_adc")
    check(flat_err <= 1e-4, f"nprobe = L scores differ by {flat_err}")

    # one subspace-GCD step, refreshed into the live index, then serve
    mismatch_before = maintain.refresh_mismatch(state.index, X)
    index_before = state.index
    R_before = index_before.R
    with _counted(own):
        Rp = R_before.clone().requires_grad_(True)
        loss = state.index.quantizer.distortion(sample @ Rp)
        (G_sub,) = torch.autograd.grad(loss, Rp)
        sub_learner = rotations.make("subspace_gcd", sub=DIM // D)
        _, delta = sub_learner.update(sub_learner.init_from(R_before), G_sub,
                                      GCD_LR)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = searcher.refresh(state, delta)
        torch.cuda.synchronize()
        t_refresh = time.perf_counter() - t0
        after = _serve(searcher, state, Q, truth, flat_truth, SERVE_NPROBE,
                       smi)
    mismatch = maintain.refresh_mismatch(state.index, X)
    flips = _code_flips(state.index, X)
    orth = float(givens.orthogonality_error(state.index.R))
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    emit("main", n=N, dim=DIM, subspaces=D, codewords=K, num_lists=L,
         block_size=BS, capacity=st["capacity"],
         max_blocks=st["max_blocks"], data_s=t_data, learn_s=t_learn,
         distortion_trace=trace, build_s=t_build, serve=serve,
         flat_check=dict(queries=FLAT_QUERIES, ids_equal=flat_ids_equal,
                         max_abs_score_diff=flat_err),
         pq_scan_reduction_at_recall=at_recall,
         refresh_s=t_refresh, after_refresh=after,
         refresh_mismatch_before=mismatch_before, refresh_mismatch=mismatch,
         refresh_code_flips=flips, theta_max=float(delta.theta.abs().max()),
         orthogonality_error=orth, launches=launches, path_launches=own,
         peak_memory_bytes=peak, total_s=time.perf_counter() - t_all,
         card=smi, exact_truth="repro_torch search backend exact")
    check(at_recall["passed"], f"pq_scan_reduction_at_recall: no nprobe "
          f"reaches recall@10 {ACCEPT_RECALL} against the flat scan at a "
          f"{ACCEPT_REDUCTION}x scan reduction: {at_recall['sweep']}")
    check(mismatch_before == 0.0,
          f"stored codes differ from a re-encode before any refresh "
          f"({mismatch_before})")
    check(mismatch <= MISMATCH_LIMIT, f"refresh_mismatch {mismatch} after "
          "a subspace-GCD refresh")
    check(flips["max_rel_gap"] <= TIE_GAP, f"a refreshed code is stale, not "
          f"a float32 tie: {flips}")
    check(orth < 1e-5, f"orthogonality error {orth} after refresh")
    for name in SERVE_KERNELS:
        check(launches[name] > 0,
              f"kernel {name} was not launched on the main path")
    return dict(launches=launches, path_launches=own, index=state.index,
                Q=Q, G=G_sub, adds=adds, build_rng=build_rng,
                R=R_before.contiguous(), X=X, index_before=index_before,
                delta=delta, peak_memory_bytes=peak, exact=exact_state,
                truth=truth, after_recall=after["recall_at_10"],
                build_launches=build_launches)


# -- kernels ----------------------------------------------------------------


def _scan_bytes(lut, scales, codes, ids, tiles, bs, out_elems, sched):
    """Bytes a scan must move: the LUT pack once, the id of every row of the
    tiles it visits and the codes of their live rows, once each, the
    schedule, and the output."""
    import torch

    rows = (tiles.long()[:, None] * bs
            + torch.arange(bs, device=tiles.device)).reshape(-1)
    live = int(torch.sum(ids[rows] >= 0))
    lut_b = lut.numel() * lut.element_size()
    if scales is not None:
        lut_b += scales.numel() * 4
    return (lut_b + rows.numel() * 4 + live * codes.shape[1]
            + sched * 4 + out_elems * 4)


def ivf_work(lut, scales, codes, ids, bi, bs: int) -> dict:
    """What one masked ivf_adc launch over schedule ``bi`` must do: its
    steps, distinct tiles, live rows scored (one float32 add per looked-up
    entry), the bytes it must move (``_scan_bytes``) and the bound."""
    import torch

    S = bi.numel()
    tiles = torch.unique(bi)
    nbytes = _scan_bytes(lut, scales, codes, ids, tiles, bs, S * bs, 2 * S)
    live = int(torch.sum(ids.view(-1, bs)[bi.long()] >= 0))
    flops = live * codes.shape[1]
    return dict(S=S, unique_tiles=int(tiles.numel()), live_rows=live,
                bytes=nbytes, flops=flops, **_bound(nbytes, flops))


def ivf_library(lut32, codes, bi, bq, bs: int):
    """The ivf_adc library yardstick: one embedding_bag over the scheduled
    tiles' rows, each row a bag of its Dp entries of the flattened
    (b·Dp·K) tables; unmasked, and its int32 index tensor is made here,
    outside the call that is timed."""
    import torch
    import torch.nn.functional as F

    _, Dp, Kc = lut32.shape
    rows_s = (bi.long()[:, None] * bs
              + torch.arange(bs, device=bi.device)).reshape(-1)
    bag = codes[rows_s].int()                                 # (S·bs, Dp)
    bag += (torch.arange(Dp, device=bag.device, dtype=torch.int32) * Kc)
    bag += (bq.repeat_interleave(bs) * (Dp * Kc))[:, None]
    return functools.partial(F.embedding_bag, bag, lut32.reshape(-1, 1),
                             mode="sum")


def flat_library(lut, codes):
    """The adc_lookup library yardstick: one embedding_bag, each code row a
    bag of its Dp entries of the (Dp·K, b) table, giving the scores
    transposed; unmasked, and its int32 index tensor is made here, outside
    the call that is timed."""
    import torch
    import torch.nn.functional as F

    _, Dp, Kc = lut.shape
    bag = codes.int() + torch.arange(Dp, device=codes.device,
                                     dtype=torch.int32) * Kc
    table = lut.permute(1, 2, 0).reshape(Dp * Kc, -1).contiguous()
    return functools.partial(F.embedding_bag, bag, table, mode="sum")


def _bound(nbytes: int, flops: int) -> dict:
    """The least time on the card: the larger of bytes over the memory rate
    and float32 operations over the float32 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / FP32_FLOP_PER_S
    return dict(bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def _lut_variants(lut):
    """The float32 table and its int8/uint8 packs."""
    from repro_torch.kernels import ops

    return {"float32": (lut, None),
            **{dt: ops.quantize_luts(lut, dt) for dt in ("int8", "uint8")}}


def phase_kernels(ctx: dict) -> dict:
    """Each kernel against its plain version on the main path's operands."""
    import torch

    from repro_torch.index import ivf
    from repro_torch.index import search as index_search
    from repro_torch.kernels import ops, ref

    index = ctx["index"]
    codes, ids = index.codes, index.ids
    rows, errs, one_shot = {}, {}, {}

    # ivf_adc: bit-equal to its plain version in every LUT type, masked
    # and not, on the schedules of b served queries at the index's default
    # nprobe (SCAN_CHECK_BATCHES and the Engine's buckets), and on rows of
    # NARROW_DP random codes and of ODD_K-word codes under the serve_p99
    # schedule
    mb = index.max_list_blocks()
    scheds = {}
    for b in sorted({*SCAN_CHECK_BATCHES, *ivf_cases().values()}):
        QRb = ctx["Q"][:b] @ index.R
        sb = index_search.scan_schedule(index, QRb, nprobe=SERVE_NPROBE,
                                        max_blocks=mb)
        scheds[b] = (sb.block_idx, sb.block_query,
                     index_search.build_luts(index.quantizer, QRb))
    g_narrow = torch.Generator(device=codes.device)
    g_narrow.manual_seed(SEED + 6)
    narrow = torch.randint(0, K, (index.capacity, NARROW_DP),
                           generator=g_narrow, device=codes.device,
                           dtype=torch.uint8)
    lut_narrow = torch.randn((BATCHES[0], NARROW_DP, K), generator=g_narrow,
                             device=codes.device)
    ivf_checks = {f"b={b}": (codes, bi_b, bq_b, lut_b)
                  for b, (bi_b, bq_b, lut_b) in scheds.items()}
    ivf_checks[f"dp={NARROW_DP}"] = (narrow, *scheds[BATCHES[0]][:2],
                                     lut_narrow)
    odd = torch.randint(0, ODD_K, (index.capacity, D), generator=g_narrow,
                        device=codes.device, dtype=torch.uint8)
    ivf_checks[f"k={ODD_K}"] = (odd, *scheds[BATCHES[0]][:2], torch.randn(
        (BATCHES[0], D, ODD_K), generator=g_narrow, device=codes.device))
    # schedules that are not query-major: b = 64's steps shuffled (a
    # multiple of b, so the plan still cuts runs per query and the kernel's
    # window check must restage), and without its last step
    bi64, bq64, lut64 = scheds[64]
    perm = torch.randperm(bi64.numel(), generator=g_narrow,
                          device=codes.device)
    ivf_checks["shuffled"] = (codes, bi64[perm].contiguous(),
                              bq64[perm].contiguous(), lut64)
    ivf_checks["ragged"] = (codes, bi64[:-1], bq64[:-1], lut64)
    for case, (cd, bi_c, bq_c, lut_c) in ivf_checks.items():
        for dt, (lut, scales) in _lut_variants(lut_c).items():
            for m in (None, ids):
                got = ops.ivf_adc(lut, cd, bi_c, bq_c, scales, m,
                                  block_size=BS)
                want = ref.ivf_adc_ref(lut, cd, bi_c, bq_c, block_size=BS,
                                       scales=scales, ids=m)
                errs[f"ivf_adc/{case}/{dt}/mask={m is not None}"] = \
                    bit_equal(got, want, f"ivf_adc {case} {dt}")
                del got, want
    qb = ctx["Q"][:BATCHES[0]]
    QR = qb @ index.R
    bi, bq, lut32 = scheds[BATCHES[0]]
    S = bi.numel()
    one_shot["ivf_adc"] = time_ms(lambda: ops.ivf_adc(
        lut32, codes, bi, bq, None, ids, block_size=BS), reps=30)
    k_ms = graph_ms(lambda: ops.ivf_adc(lut32, codes, bi, bq, None, ids,
                                        block_size=BS), launches=20)
    p_ms = graph_ms(lambda: ref.ivf_adc_ref(lut32, codes, bi, bq,
                                            block_size=BS, ids=ids),
                    launches=2)
    lib = ivf_library(lut32, codes, bi, bq, BS)
    compare(lib().view(S, BS), ref.ivf_adc_ref(lut32, codes, bi, bq,
                                               block_size=BS), ATOL, RTOL)
    lib_ms = graph_ms(lib, launches=5)
    del lib
    # one served batch, stage by stage, with a warm L2 as back-to-back
    # batches find it; "search" is the whole of search_prepared
    stages = {
        "rotate": lambda: qb @ index.R,
        "lut": lambda: index_search.build_luts(index.quantizer, QR),
        "schedule": lambda: index_search.scan_schedule(
            index, QR, nprobe=SERVE_NPROBE, max_blocks=mb),
        "scan": lambda: ops.ivf_adc(lut32, codes, bi, bq, None, ids,
                                    block_size=BS),
        "search": lambda: index_search.search_prepared(
            index, QR, lut32, nprobe=SERVE_NPROBE, k=10, max_blocks=mb),
    }
    stage_ms = {name: time_ms(fn, reps=20, flush=False)
                for name, fn in stages.items()}
    tiny = torch.empty(1, device=codes.device)
    launch_floor_ms = graph_ms(tiny.zero_, launches=100)
    host_launch_ms = time_ms(tiny.zero_, reps=50, flush=False)
    work = ivf_work(lut32, None, codes, ids, bi, BS)
    rows["ivf_adc"] = dict(
        shape=dict(b=qb.shape[0], nprobe=SERVE_NPROBE, max_blocks=mb, Dp=D,
                   K=K, cap=index.capacity, S=S, block_size=BS,
                   unique_tiles=work["unique_tiles"]),
        ms=k_ms, plain_ms=p_ms, live_rows=work["live_rows"],
        bytes=work["bytes"], flops=work["flops"], bound_ms=work["bound_ms"],
        bound_by=work["bound_by"], library_ms=lib_ms)
    # the Engine's other buckets, timed alike
    case_rows = {}
    for name, b in ivf_cases().items():
        bi_b, bq_b, lut_b = scheds[b]
        w = ivf_work(lut_b, None, codes, ids, bi_b, BS)
        case_rows[name] = dict(
            b=b, S=w["S"], live_rows=w["live_rows"],
            bytes=w["bytes"], bound_ms=w["bound_ms"], bound_by=w["bound_by"])
        if b == BATCHES[0]:
            case_rows[name].update(ms=k_ms, plain_ms=p_ms, library_ms=lib_ms)
            continue
        case_rows[name].update(
            ms=graph_ms(lambda: ops.ivf_adc(lut_b, codes, bi_b, bq_b, None,
                                            ids, block_size=BS),
                        launches=20),
            plain_ms=graph_ms(lambda: ref.ivf_adc_ref(
                lut_b, codes, bi_b, bq_b, block_size=BS, ids=ids),
                launches=2),
            library_ms=graph_ms(ivf_library(lut_b, codes, bi_b, bq_b, BS),
                                launches=5))
    del scheds, narrow, lut_narrow, ivf_checks

    # adc_lookup: bit-equal in every LUT type, masked and not, on b served
    # queries over every CSR row, and on 5 over rows of NARROW_DP codes
    # and of ODD_K-word codes
    narrow = torch.randint(0, K, (index.capacity, NARROW_DP),
                           generator=g_narrow, device=codes.device,
                           dtype=torch.uint8)
    flat_checks = {f"b={b}": (codes, index_search.build_luts(
        index.quantizer, ctx["Q"][:b] @ index.R))
        for b in SCAN_CHECK_BATCHES}
    flat_checks[f"dp={NARROW_DP}"] = (narrow, torch.randn(
        (5, NARROW_DP, K), generator=g_narrow, device=codes.device))
    flat_checks[f"k={ODD_K}"] = (odd, torch.randn(
        (5, D, ODD_K), generator=g_narrow, device=codes.device))
    for case, (cd, lut_c) in flat_checks.items():
        for dt, (lut, scales) in _lut_variants(lut_c).items():
            for m in (None, ids):
                got = ops.adc_lookup(lut, cd, scales, m)
                want = ref.adc_lookup_ref(lut, cd, scales, m)
                errs[f"adc_lookup/{case}/{dt}/mask={m is not None}"] = \
                    bit_equal(got, want, f"adc_lookup {case} {dt}")
                del got, want
    del flat_checks, narrow, odd
    QRf = ctx["Q"][:FLAT_QUERIES] @ index.R
    lutf = index_search.build_luts(index.quantizer, QRf)
    one_shot["adc_lookup"] = time_ms(
        lambda: ops.adc_lookup(lutf, codes, None, ids), reps=30)
    k_ms = graph_ms(lambda: ops.adc_lookup(lutf, codes, None, ids),
                    launches=20)
    p_ms = graph_ms(lambda: ref.adc_lookup_ref(lutf, codes, None, ids),
                    launches=2)
    lib = flat_library(lutf, codes)
    compare(lib().T, ref.adc_lookup_ref(lutf, codes), ATOL, RTOL)
    lib_ms = graph_ms(lib, launches=5)
    del lib
    all_tiles = torch.arange(index.capacity // BS, device=codes.device)
    qf = QRf.shape[0]
    nbytes = _scan_bytes(lutf, None, codes, ids, all_tiles, BS,
                         qf * index.capacity, 0)
    flops = qf * int(torch.sum(ids >= 0)) * D
    rows["adc_lookup"] = dict(
        shape=dict(b=qf, Dp=D, K=K, N=index.capacity), ms=k_ms,
        plain_ms=p_ms, bytes=nbytes, flops=flops, **_bound(nbytes, flops),
        library_ms=lib_ms)

    # gcd_score: the subspace step's (G, R), and ragged n on both tile
    # widths (48: 16-wide, a grid of six pairs; 200; 520: 32-wide)
    dev = codes.device
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 1)
    pairs = {DIM: (ctx["G"], ctx["R"])}
    for nr in GCD_RAGGED:
        pairs[nr] = (torch.randn((nr, nr), generator=g, device=dev),
                     torch.linalg.qr(torch.randn((nr, nr), generator=g,
                                                 device=dev))[0])
    for n, (G, R) in pairs.items():
        G, R = G.contiguous(), R.contiguous()
        got = ops.gcd_score(G, R)
        want = ref.gcd_score_ref(G, R)
        torch.cuda.synchronize()
        errs[f"gcd_score/n={n}"] = compare(got, want, GCD_ATOL, 0.0)
        check(torch.equal(got, -got.T), f"gcd_score n={n} not antisymmetric")
    G, R = (t.contiguous() for t in pairs[DIM])
    n = DIM
    want = ref.gcd_score_ref(G, R)
    one_shot["gcd_score"] = time_ms(lambda: ops.gcd_score(G, R), reps=50)
    k_ms = graph_ms(lambda: ops.gcd_score(G, R), launches=100)
    p_ms = graph_ms(lambda: ref.gcd_score_ref(G, R), launches=100)
    # the library yardstick: one matmul, [Gᵀ | −Rᵀ] · [R; G] = GᵀR − RᵀG
    lhs = torch.cat([G, -R], dim=0).T.contiguous()           # (n, 2n)
    rhs = torch.cat([R, G], dim=0).contiguous()              # (2n, n)
    lib_ms = graph_ms(lambda: torch.matmul(lhs, rhs), launches=100)
    check(torch.allclose(torch.matmul(lhs, rhs), want, atol=GCD_ATOL),
          "library yardstick computes another function")
    # one n³ product (M = GᵀR) and the n² subtraction; G and R read once,
    # A written once
    flops = 2 * n ** 3 + n * n
    nbytes = 3 * n * n * 4
    rows["gcd_score"] = dict(
        shape=dict(n=n), ms=k_ms, plain_ms=p_ms, bytes=nbytes, flops=flops,
        **_bound(nbytes, flops), library_ms=lib_ms)

    # pq_assign: the index build's encode of all N rows, as ivf.encode runs
    # it, chunk by chunk: the coarse VQ (K = L, sub = n) on X·R, then the PQ
    # codebooks on the residuals to the kernel's lists
    before = ctx["index_before"]
    cents = before.centroids[None].contiguous()               # (1, L, n)
    cbs = before.codebooks.contiguous()                       # (D, K, sub)
    XR = ctx["X"] @ before.R
    serve_flips = {}
    for lo in range(0, N, ivf.ENCODE_ROWS):
        xr = XR[lo:lo + ivf.ENCODE_ROWS]
        lists = ops.pq_assign(xr, cents)
        res = (xr - before.centroids[lists[:, 0].long()]).contiguous()
        codes_c = ops.pq_assign(res, cbs)
        for what, x, C, got in (("coarse_vq", xr, cents, lists),
                                ("pq", res, cbs, codes_c)):
            _merge_flips(serve_flips.setdefault(what, {}), _assign_flips(
                x, C, got, ref.pq_assign_ref(x, C)))
        del xr, lists, res, codes_c
    del XR
    for what, f in serve_flips.items():
        errs[f"pq_assign/serve_{what}"] = f["max_abs_gap"]

    # givens_rotate: the refresh's own operands, R, the coarse centroids and
    # the codebook rows (cross-subspace angles zeroed, as
    # index.maintain.rotate_components does), each bit-equal to the plain
    # version and to what the refresh stored
    delta = ctx["delta"]
    pi, pj = delta.pi.int().contiguous(), delta.pj.int().contiguous()
    sub = DIM // D
    theta_w = torch.where(delta.pi // sub == delta.pj // sub, delta.theta,
                          torch.zeros_like(delta.theta))
    refresh_cases = {
        "R": (before.R, delta.theta, index.R),
        "centroids": (before.centroids, delta.theta, index.centroids),
        "codebook_rows": (before.codebooks.movedim(-2, -3).reshape(-1, DIM),
                          theta_w,
                          index.codebooks.movedim(-2, -3).reshape(-1, DIM)),
    }
    for what, (Xr, th, stored) in refresh_cases.items():
        c, s = torch.cos(th).contiguous(), torch.sin(th).contiguous()
        got = ops.givens_rotate(Xr.contiguous(), pi, pj, c, s)
        want = ref.pair_rotate_ref(Xr, pi, pj, c, s)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"givens_rotate on the refresh's "
              f"{what} is not bit-equal to its plain version")
        check(torch.equal(stored, want), f"the refreshed {what} differs "
              "from the plain rotation")
        errs[f"givens_rotate/refresh_{what}"] = 0.0

    for name in rows:
        rows[name]["max_abs_err"] = max(v for key, v in errs.items()
                                        if key.startswith(name + "/"))
    emit("kernels", max_abs_err=errs, kernels=rows, ivf_adc_cases=case_rows,
         launches=ctx["launches"], one_shot_ms=one_shot,
         serve_p99_stage_ms=stage_ms, launch_floor_ms=launch_floor_ms,
         host_launch_ms=host_launch_ms, serve_pq_assign_flips=serve_flips,
         card=torch.cuda.get_device_name(0))
    return rows, errs


# -- engine -----------------------------------------------------------------


def _stream():
    """The engine phase's request stream, from SEED: ENGINE_REQUESTS row
    lists into a pool of fresh queries, sizes cycling through
    ENGINE_SIZES, about half of each request's rows (none of the first's)
    repeats of rows served before."""
    import numpy as np

    rng = np.random.RandomState(SEED)
    seen, fresh, out = [], 0, []
    for r in range(ENGINE_REQUESTS):
        size = ENGINE_SIZES[r % len(ENGINE_SIZES)]
        reps = (rng.choice(seen, size // 2).tolist() if seen else [])
        new = list(range(fresh, fresh + size - len(reps)))
        fresh += len(new)
        rows = np.array(reps + new)
        rng.shuffle(rows)
        out.append(rows)
        seen.extend(new)
    return out, fresh


def _expected_cache(stream, invalidate_before: set) -> list:
    """What the Engine's LUT cache must do on the stream (no eviction: the
    stream's distinct rows fit in the cache): per request (hits, misses,
    whether a table is built). The cache is cleared before the requests
    in ``invalidate_before``."""
    cached, out = set(), []
    for r, rows in enumerate(stream):
        if r in invalidate_before:
            cached.clear()
        hits = sum(int(i) in cached for i in rows)
        out.append((hits, len(rows) - hits, hits < len(rows)))
        cached.update(int(i) for i in rows)
    return out


def _gcd_delta(learner, R, sample, quantizer):
    """One learner step from the distortion gradient at rotation R."""
    import torch

    Rp = R.clone().requires_grad_(True)
    (G,) = torch.autograd.grad(quantizer.distortion(sample @ Rp), Rp)
    _, delta = learner.update(learner.init_from(R.detach()), G, GCD_LR)
    return delta


def _hold_fused_lut(name, Q, qdelta, cb, colmap, errs, rel, fails) -> None:
    """fused_lut against its plain version: max |kernel − plain| within
    LUT_RTOL of the table's scale, and the int8/uint8 packs of the two
    tables at most one step apart."""
    import torch

    from repro_torch.kernels import ops, ref

    got = ops.fused_lut(Q, qdelta, cb, colmap)
    want = ref.fused_lut_ref(Q, qdelta, cb, colmap)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    errs[f"fused_lut/{name}"] = err
    rel[name] = err / scale
    if not err <= LUT_RTOL * scale:
        fails.append(f"fused_lut {name}: max abs error {err} beyond "
                     f"{LUT_RTOL} of the scale {scale}")
    for dt in ("int8", "uint8"):
        qg, _ = ops.quantize_luts(got, dt)
        qw, _ = ops.quantize_luts(want, dt)
        step = int((qg.int() - qw.int()).abs().max())
        if step > 1:
            fails.append(f"fused_lut {name}: {dt} codes {step} steps apart")


def phase_engine(ctx: dict, smi: str):
    """The Engine over a fused-refresh IVF state on main's index, held
    against direct searches, an eager refresh and the exact backends."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import obs, rotations, search
    from repro_torch.data import synthetic
    from repro_torch.index import search as index_search
    from repro_torch.kernels import ops, ref
    from repro_torch.metrics import recall_at_k

    index, X, Q = ctx["index"], ctx["X"], ctx["Q"]
    sample = X[:TRAIN]
    fails, errs = [], {}
    t_all = time.perf_counter()

    # the exact backends: exact against the plain product Q·Xᵀ (rows that
    # differ must hold float32 ties), exact_stream against exact
    exact, estate = search.make("exact"), ctx["exact"]
    ex = exact.search(estate, Q, k=10)
    plain_ids = torch.topk(Q @ X.T, 10, dim=1).indices
    differ = torch.nonzero(~(ex.ids.long() == plain_ids).all(1)).squeeze(1)
    tie_gap = 0.0
    for r in differ.tolist():
        q = Q[r].double()
        a = torch.sort(X[ex.ids[r].long()].double() @ q).values
        b = torch.sort(X[plain_ids[r]].double() @ q).values
        tie_gap = max(tie_gap, float((a - b).abs().max()
                                     / b.abs().max()))
    if tie_gap > TIE_GAP:
        fails.append(f"exact differs from the plain Q·Xᵀ top-10 beyond "
                     f"float32 ties (gap {tie_gap})")
    del plain_ids
    t0 = time.perf_counter()
    stream_b = search.make("exact_stream")
    sstate = stream_b.build(None, X, ctx["R"],
                            search.SearchConfig(tile_rows=EXACT_TILE))
    torch.cuda.synchronize()
    t_stream_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    sres = stream_b.search(sstate, Q, k=10)
    torch.cuda.synchronize()
    t_stream = time.perf_counter() - t0
    if not torch.equal(sres.ids, ex.ids):
        fails.append("exact_stream ids differ from exact")
    t0 = time.perf_counter()
    exact.search(estate, Q, k=10)
    torch.cuda.synchronize()
    t_exact = time.perf_counter() - t0
    del sstate
    truth = ex.ids

    # the path: counts from 0 here, read after the stream and its checks
    ops.reset_launches()
    expect = {"fused_lut": 0, "ivf_adc": 0}
    own = {}     # the Engine's own: attach, requests, refreshes and the
    #              learner steps that give them their deltas
    ivf, flat = search.make("ivf"), search.make("flat_adc")
    with _counted(own):
        state = ivf.attach(index, nprobe=SERVE_NPROBE, fused_refresh=True)
    state0 = state
    fstate = flat.attach(index, fused_refresh=True)
    # nprobe = L through the fused tables equals the fused flat scan
    qf = Q[:FLAT_QUERIES]
    full = ivf.search(state, qf, k=10, nprobe=L)
    fres = flat.search(fstate, qf, k=10)
    expect["fused_lut"] += 2
    expect["ivf_adc"] += 1
    if not torch.equal(full.ids, fres.ids):
        fails.append("fused nprobe = L ids differ from the fused flat scan")

    g = torch.Generator(device=X.device)
    g.manual_seed(SEED + 3)
    stream, n_fresh = _stream()
    pool = synthetic.sift_like(g, n_fresh, DIM)
    within_at, cross_at = ENGINE_REQUESTS // 3, 2 * ENGINE_REQUESTS // 3
    cache = _expected_cache(stream, {cross_at})
    engine = search.Engine(ivf, state, k=10)
    deltas, refreshes = [], {}
    direct = dict(equal=0, within_rows=0, within_ids_equal=0)
    for r, rows in enumerate(stream):
        if r == within_at:
            with _counted(own):
                d = _gcd_delta(rotations.make("subspace_gcd", sub=DIM // D),
                               engine.state.rot, sample, index.quantizer)
            before = engine.stats()
            with _counted(own):
                engine.refresh(d)
            deltas.append(d)
            refreshes["within"] = dict(
                invariant=ivf.luts_refresh_invariant(state, d),
                theta_max=float(d.theta.abs().max()))
        if r == cross_at:
            with _counted(own):
                d = _gcd_delta(rotations.make("gcd_greedy"),
                               engine.state.rot, sample, index.quantizer)
            mid = engine.stats()
            with _counted(own):
                engine.refresh(d)
            deltas.append(d)
            after = engine.stats()
            refreshes["cross"] = dict(
                invariant=ivf.luts_refresh_invariant(engine.state, d),
                theta_max=float(d.theta.abs().max()),
                invalidations=after["lut_invalidations"]
                - mid["lut_invalidations"],
                epoch=after["lut_epoch"] - mid["lut_epoch"])
        qb = pool[torch.from_numpy(rows).to(X.device)]
        with _counted(own):
            got = engine.search(qb)
        expect["ivf_adc"] += 1
        expect["fused_lut"] += int(cache[r][2])
        want = ivf.search(engine.state, qb, k=10)
        expect["ivf_adc"] += 1
        expect["fused_lut"] += 1
        same = torch.equal(got.ids, want.ids)
        diff = float((got.scores - want.scores).abs().max())
        if within_at <= r < cross_at:
            # cached tables from before the refresh: equal in exact
            # arithmetic, not in float32
            direct["within_rows"] += len(rows)
            direct["within_ids_equal"] += int(
                (got.ids == want.ids).all(1).sum())
            if not torch.allclose(got.scores, want.scores, atol=1e-4,
                                  rtol=1e-4):
                fails.append(f"request {r}: scores off by {diff} after the "
                             "within-subspace refresh")
        else:
            direct["equal"] += int(same)
            if not (same and torch.allclose(got.scores, want.scores,
                                            atol=1e-6, rtol=1e-6)):
                fails.append(f"request {r}: Engine differs from a direct "
                             f"search (ids equal {same}, scores {diff})")
        if r == cross_at - 1:
            st = engine.stats()
            hits = sum(c[0] for c in cache[:r + 1])
            if st["lut_invalidations"] != 0 or st["lut_hits"] != hits \
                    or st["executables"] != before["executables"]:
                fails.append(f"within-subspace refresh: invalidations "
                             f"{st['lut_invalidations']}, hits "
                             f"{st['lut_hits']} (the stream repeats {hits}"
                             f"), executables {before['executables']} -> "
                             f"{st['executables']}")
    if refreshes["within"]["invariant"] is not True \
            or refreshes["cross"]["invariant"] is not False:
        fails.append(f"refresh invariance misjudged: {refreshes}")
    if refreshes["cross"]["invalidations"] != 1 \
            or refreshes["cross"]["epoch"] != 1:
        fails.append(f"GCD-G refresh: {refreshes['cross']}")
    if direct["within_ids_equal"] < 0.99 * direct["within_rows"]:
        fails.append(f"after the within-subspace refresh only "
                     f"{direct['within_ids_equal']} of "
                     f"{direct['within_rows']} rows have the direct "
                     "search's ids")
    st1 = engine.stats()
    want_hits = sum(c[0] for c in cache)
    if st1["lut_hits"] != want_hits or \
            st1["lut_misses"] != sum(c[1] for c in cache):
        fails.append(f"LUT hits {st1['lut_hits']} / misses "
                     f"{st1['lut_misses']}, the stream implies {want_hits}")
    reqs1 = engine.requests

    # the second pass of the stream with int8 tables. A cached table row
    # was built from Q·R₀ of an earlier batch, whose float32 product may
    # round differently at another batch size, and a last-bit difference
    # can move an int8 code by one step: each score may then move by at
    # most one step in every column, Σ_d scale_d
    engine8 = search.Engine(ivf, dataclasses.replace(engine.state,
                                                     lut_dtype="int8"), k=10)
    cache8 = _expected_cache(stream, set())
    direct8 = dict(rows=0, ids_equal=0, max_diff_over_step=0.0)
    for r, rows in enumerate(stream):
        qb = pool[torch.from_numpy(rows).to(X.device)]
        with _counted(own):
            got = engine8.search(qb)
        QRb = ivf.rotate_queries(engine8.state, qb)
        lut8 = ivf.luts(engine8.state, QRb)
        want = ivf.search_prepared(engine8.state, QRb, lut8, k=10)
        expect["ivf_adc"] += 2
        expect["fused_lut"] += int(cache8[r][2]) + 1
        step = lut8[1][..., 0].sum(dim=1, keepdim=True)
        over = float(((got.scores - want.scores).abs() / step).max())
        direct8["rows"] += len(rows)
        direct8["ids_equal"] += int((got.ids == want.ids).all(1).sum())
        direct8["max_diff_over_step"] = max(direct8["max_diff_over_step"],
                                            over)
        if over > 1.0:
            fails.append(f"int8 request {r}: scores {over} steps from a "
                         "direct search")
    if direct8["ids_equal"] < 0.99 * direct8["rows"]:
        fails.append(f"int8 pass: {direct8['ids_equal']} of "
                     f"{direct8['rows']} rows have the direct search's ids")
    st8 = engine8.stats()

    # the end state: the fused state against an eager copy of the index
    # refreshed by the same two deltas, and recall against exact
    state = engine.state
    eager = ivf.attach(index, nprobe=SERVE_NPROBE)
    for d in deltas:
        eager = ivf.refresh(eager, d)
    r_e = ivf.search(eager, Q, k=10)
    probe = obs.RecallProbe(Q, truth, k=10)
    recall = probe.run(lambda q: ivf.search(state, q, k=10))
    r_f = ivf.search(state, Q, k=10)
    expect["ivf_adc"] += 3
    expect["fused_lut"] += 2
    eager_share = float((r_e.ids == r_f.ids).float().mean())
    eager_diff = float((r_e.scores - r_f.scores).abs().max())
    # The two states probe through other float32 products (the fused one
    # at R₀, the eager one against rotated centroids), so a query whose
    # nprobe-th and next lists are a float32 tie may probe another list in
    # each. Every query's scores are held to 1e-4 against the eager state
    # searched over the lists the fused state probed: r_e itself where the
    # lists agree, else a second eager search through the prepared path
    # with the probe pinned to the fused lists. Each such query must also
    # be a tie: every list one state alone probes lies within TIE_GAP (of
    # the query's coarse scale) of the fused nprobe-th coarse score.
    QRf, QRe = ivf.rotate_queries(state, Q), ivf.rotate_queries(eager, Q)
    cf = index_search.coarse_scores(state.index, QRf)
    ce = index_search.coarse_scores(eager.index, QRe)
    vals_f, lists_f = torch.sort(cf, dim=1, descending=True, stable=True)
    lists_e = torch.sort(ce, dim=1, descending=True, stable=True).indices
    flipped = torch.zeros_like(cf, dtype=torch.bool).scatter_(
        1, lists_f[:, :SERVE_NPROBE], True) ^ torch.zeros_like(
        cf, dtype=torch.bool).scatter_(1, lists_e[:, :SERVE_NPROBE], True)
    moved = flipped.any(1)
    edge = vals_f[:, SERVE_NPROBE - 1:SERVE_NPROBE]
    probe_gap = float(((cf - edge).abs() * flipped).amax(1).div(
        cf.abs().amax(1)).max())
    if probe_gap > TIE_GAP:
        fails.append(f"fused and eager refresh probe other lists beyond a "
                     f"float32 tie (gap {probe_gap})")
    want_scores = r_e.scores.clone()
    if moved.any():
        QRm = QRe[moved]
        with _probe_pinned(index_search, lists_f[moved, :SERVE_NPROBE]):
            want_scores[moved] = ivf.search_prepared(
                eager, QRm, ivf.luts(eager, QRm), k=10).scores
        expect["ivf_adc"] += 1
    pinned_diff = float((want_scores - r_f.scores).abs().max())
    if not torch.allclose(want_scores, r_f.scores, atol=1e-4, rtol=1e-4):
        fails.append(f"fused and eager refresh: scores off by {pinned_diff} "
                     "over the same probed lists")
    if eager_share < 0.95:
        fails.append(f"fused and eager refresh: {eager_share} of ids equal")
    if abs(recall - ctx["after_recall"]) > 0.005:
        fails.append(f"recall@10 {recall} against exact, main's after "
                     f"refresh {ctx['after_recall']}")
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    for name, n in expect.items():
        if launches[name] != n:
            fails.append(f"{name} launched {launches[name]} times, the path "
                         f"implies {n}")
    # of which the Engine's own: one scan a request, a table build a miss
    own_expect = dict(ivf_adc=2 * len(stream), fused_lut=sum(
        int(c[2]) for c in cache) + sum(int(c[2]) for c in cache8))
    if {k: own.get(k, 0) for k in own_expect} != own_expect:
        fails.append(f"the Engine's own launches {own}, its requests imply "
                     f"{own_expect}")
    t_path = time.perf_counter() - t_all

    # fused_lut against its plain version on the path's operands
    rel = {}
    cb, colmap = index.quantizer.lut_operands()
    QR512 = ivf.rotate_queries(state, Q[:BATCHES[0]])
    for name, qd in (("b512_attach", state0.qdelta),
                     ("b512_after_gcd_g", state.qdelta)):
        _hold_fused_lut(name, QR512, qd, cb, colmap, errs, rel, fails)
    # one query, ragged batches (b not a multiple of the plan's query
    # tile) and the Engine's smaller buckets
    buckets = [b for b in engine_buckets() if b != BATCHES[0]]
    for b in (1, 37, 300, *buckets):
        qb = ivf.rotate_queries(state, pool[:b])
        _hold_fused_lut(f"b{b}", qb, state.qdelta, cb, colmap, errs, rel,
                        fails)
    # the layout's edges: Dp = 31 (not a multiple of the column group the
    # plan takes at b = 300 and 512), K = 250 (scalar stores; a span that
    # runs past K), and Q at an address that is not 16-byte aligned
    # (4-byte copies)
    q300 = ivf.rotate_queries(state, pool[:300])
    for name, qb in (("b512", QR512), ("b300", q300)):
        _hold_fused_lut(f"dp31_{name}", qb, state.qdelta,
                        cb[:31].contiguous(), colmap[:31], errs, rel, fails)
    for name, qb in (("b512", QR512), ("b37", q300[:37]), ("b1", q300[:1])):
        _hold_fused_lut(f"k250_{name}", qb.contiguous(), state.qdelta,
                        cb[:, :250].contiguous(), colmap, errs, rel, fails)
    spill = torch.empty(37 * DIM + 1, device=cb.device)
    q_odd = spill[1:].view(37, DIM)
    q_odd.copy_(q300[:37])
    _hold_fused_lut("unaligned_q", q_odd, state.qdelta, cb, colmap, errs,
                    rel, fails)
    levels = torch.cat([cb, 0.5 * cb.flip(1)])            # (2D, K, sub)
    rq_map = torch.eye(D, device=cb.device)[
        torch.arange(2 * D, device=cb.device) % D]
    _hold_fused_lut("rq_depth2", QR512, state.qdelta, levels.contiguous(),
                    rq_map, errs, rel, fails)
    n2, D2 = 512, 64
    q2 = torch.randn((300, n2), generator=g, device=cb.device)
    qd2 = torch.linalg.qr(torch.randn((n2, n2), generator=g,
                                      device=cb.device))[0].contiguous()
    cb2 = torch.randn((D2, K, n2 // D2), generator=g, device=cb.device)
    _hold_fused_lut("n512_D64", q2, qd2, cb2,
                    torch.eye(D2, device=cb.device), errs, rel, fails)

    # a query's table does not depend on its batch: the 512 serve_p99
    # queries' tables built at b = 512 in one call, and again in slices of
    # each of LUT_SLICES, must be bit-equal (n = 256 on the path's
    # operands; n = 512 on the D = 64 operands above, 512 queries)
    q512 = torch.randn((BATCHES[0], n2), generator=g, device=cb.device)
    eye2 = torch.eye(D2, device=cb.device)
    lut_cases = {
        "n256": (QR512, state.qdelta, cb, colmap, state.lut_cols),
        "n512": (q512, qd2, cb2, eye2, ops.lut_column_map(eye2))}
    lut_batch = {}
    for name, (qb, qd_b, cb_b, cm_b, cols_b) in lut_cases.items():
        whole = ops.fused_lut(qb, qd_b, cb_b, cm_b, cols=cols_b)
        lut_differ = {}
        for b in LUT_SLICES:
            parts = torch.cat([
                ops.fused_lut(qb[s:s + b], qd_b, cb_b, cm_b, cols=cols_b)
                for s in range(0, qb.shape[0], b)])
            lut_differ[b] = int((parts != whole).sum())
        plans = {b: ops.fused_lut_plan(b, qb.shape[1], *cb_b.shape,
                                       ops._sms(cb.device))
                 for b in (*LUT_SLICES, qb.shape[0])}
        lut_batch[name] = dict(
            entries_differing=lut_differ,
            runs={b: p["runs"] for b, p in plans.items()},
            layouts={b: [p["tile"], p["group"], p["rq"], p["kc"]]
                     for b, p in plans.items()})
        if any(lut_differ.values()):
            fails.append(f"fused_lut {name}: a query's table depends on "
                         f"its batch: entries differing by b {lut_differ}")

    # times per launch at b = 512
    qd = state.qdelta
    cols = state.lut_cols
    k_ms = graph_ms(lambda: ops.fused_lut(QR512, qd, cb, colmap, cols=cols),
                    launches=50)
    p_ms = graph_ms(lambda: ref.fused_lut_ref(QR512, qd, cb, colmap),
                    launches=20)
    cbT = cb.transpose(1, 2).contiguous()                  # (D, sub, K)
    b512 = QR512.shape[0]

    def two_calls():
        QL = torch.matmul(QR512, qd).view(b512, D, -1).transpose(0, 1)
        return torch.bmm(QL, cbT)                          # (D, b, K)

    lib_err = float((two_calls().transpose(0, 1)
                     - ref.fused_lut_ref(QR512, qd, cb, colmap)).abs().max())
    lib_ms = graph_ms(two_calls, launches=20)
    eager_lut_ms = graph_ms(lambda: index.quantizer.adc_tables(QR512),
                            launches=20)
    bucket_ms = {}
    for b in buckets:
        qb = ivf.rotate_queries(state, pool[:b])
        bucket_ms[b] = graph_ms(
            lambda qb=qb: ops.fused_lut(qb, qd, cb, colmap, cols=cols),
            launches=50)
    Dp, _, sub = cb.shape
    nbytes = 4 * (b512 * DIM + DIM * DIM + Dp * K * sub + b512 * Dp * K + Dp)
    flops = 2 * b512 * DIM * DIM + 2 * b512 * Dp * K * sub
    row = dict(shape=dict(b=b512, n=DIM, Dp=Dp, K=K, sub=sub), ms=k_ms,
               plain_ms=p_ms, bytes=nbytes, flops=flops,
               **_bound(nbytes, flops), library_ms=lib_ms,
               library="two calls: torch.matmul(Q, qdelta), then torch.bmm "
                       "over the subspaces",
               library_max_abs_err=lib_err, eager_lut_ms=eager_lut_ms,
               max_abs_err=max(v for v in errs.values()),
               rel_err=rel, bucket_ms=bucket_ms, before_ms=LUT_BEFORE_MS,
               batch_independence=lut_batch)

    keys = ("requests", "queries", "compiles", "executables", "refreshes",
            "lut_hits", "lut_misses", "lut_hit_rate", "lut_invalidations",
            "lut_epoch", "lut_cached_rows", "latency_ms_p50",
            "latency_ms_p99")
    emit("engine", requests=ENGINE_REQUESTS, sizes=list(ENGINE_SIZES),
         fresh_rows=n_fresh, rows=sum(len(r) for r in stream),
         nprobe=SERVE_NPROBE, refreshes=refreshes,
         float32={k: st1[k] for k in keys}, int8={k: st8[k] for k in keys},
         latency_ms_by_bucket=dict(float32=_by_bucket(reqs1),
                                   int8=_by_bucket(engine8.requests)),
         direct_searches=direct, int8_direct_searches=direct8,
         eager_ids_equal_share=eager_share, eager_max_score_diff=eager_diff,
         eager_probe_flips=int(moved.sum()), eager_probe_tie_gap=probe_gap,
         eager_pinned_max_score_diff=pinned_diff,
         recall_at_10=recall, main_after_refresh_recall=ctx["after_recall"],
         exact=dict(rows_differing_from_plain=int(differ.numel()),
                    max_tie_gap=tie_gap, search_s=t_exact,
                    stream_search_s=t_stream,
                    stream_build_s=t_stream_build),
         launches=launches, expected_launches=expect, path_launches=own,
         fused_lut=row,
         path_s=t_path, total_s=time.perf_counter() - t_all, card=smi,
         fails=fails)
    check(not fails, "; ".join(fails))
    return {"fused_lut": row}, errs, own


# -- churn ------------------------------------------------------------------


@contextlib.contextmanager
def _timed_calls(module, names, into: dict):
    """Inside the block, every call of ``module.<name>`` for each name is
    timed on the host clock, the card synchronised before and after, and
    appended (ms) to ``into[name]``; the call goes on as before."""
    import torch

    real = {n: getattr(module, n) for n in names}

    def spy(name):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real[name](*args, **kwargs)
            torch.cuda.synchronize()
            into.setdefault(name, []).append(
                (time.perf_counter() - t0) * 1e3)
            return out
        return call

    for n in names:
        setattr(module, n, spy(n))
    try:
        yield
    finally:
        for n, fn in real.items():
            setattr(module, n, fn)


def _pcts(values) -> dict:
    """n, p50 and p95 of a list of milliseconds."""
    if not values:
        return dict(n=0)
    v = sorted(values)
    return dict(n=len(v), p50=statistics.median(v),
                p95=v[min(len(v) - 1, math.ceil(0.95 * len(v)) - 1)])


def _by_bucket(reqs) -> dict:
    """n, p50 and p99 of the Engine's request latencies, by bucket."""
    from repro_torch import obs

    out = {}
    for rec in reqs:
        out.setdefault(rec["bucket"], obs.Distribution(
            "latency_ms", window=len(reqs))).observe(rec["latency_ms"])
    return {str(b): dict(n=d.count, p50=d.percentile(50),
                         p99=d.percentile(99))
            for b, d in sorted(out.items())}


def _hidden_ms(engine, Q, comp, fails: list) -> dict:
    """What one background pass of ``comp`` hides from the serving loop:
    the Engine's batches of Q with no pass in flight, then the submit, the
    batches while the worker runs, and the poll that swaps, all on this
    thread. hidden = the worker's time less what those add (the submit,
    the swap's poll and each batch above the idle median)."""
    import torch

    def batch_ms():
        t = time.perf_counter()
        engine.search(Q)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3

    idle = [batch_ms() for _ in range(HIDE_IDLE_BATCHES)]
    t = time.perf_counter()
    comp.submit()
    submit = (time.perf_counter() - t) * 1e3
    during = []
    while True:
        t = time.perf_counter()
        swapped = comp.poll()
        poll = (time.perf_counter() - t) * 1e3
        if swapped or not comp.in_flight:
            break
        during.append(batch_ms())
    comp.close()
    if not swapped:
        fails.append("a background pass with nothing to race was discarded")
        return {}
    worker = comp.obs.distribution("churn.bg_compact_ms").window_values()[0]
    base = statistics.median(idle)
    added = submit + poll + sum(d - base for d in during)
    return dict(worker_ms=worker, submit_ms=submit, swap_poll_ms=poll,
                idle_batch_ms=_pcts(idle), batch_ms_during=_pcts(during),
                batches_during=len(during), added_serving_ms=added,
                hidden_ms=worker - added)


def phase_churn(ctx: dict, smi: str):
    """Live churn on main's 1M-row index behind search.Engine, by
    repro_torch.bench.churn's loop: the JAX churn script's seven checks,
    shapes and launches held; then a shorter run with a
    BackgroundCompactor; then the side pass's adc_lookup and the widened,
    tombstoned ivf_adc against their plain versions."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import churn, device, obs, search
    from repro_torch.bench import churn as cbench
    from repro_torch.churn import ops as churn_ops
    from repro_torch.kernels import ops, ref

    t_all = time.perf_counter()
    index, X, Q512 = ctx["index"], ctx["X"], ctx["Q"][:BATCHES[0]]
    pool = torch.cat([X, ctx["adds"]])        # row = item id
    live = np.zeros(pool.shape[0], dtype=bool)
    live[:N] = True
    ivf = search.make("ivf")
    fails, errs, own = [], {}, {}

    # without churn: the same queries through an Engine without a buffer
    base = search.Engine(ivf, ivf.attach(index, nprobe=SERVE_NPROBE,
                                         fused_refresh=True),
                         k=10, min_bucket=32)
    for _ in range(CHURN_STEPS + 1):
        base.search(Q512)
    base_st = base.stats()
    base_lat = _by_bucket(base.requests[1:])
    del base

    # the path: attach, the controller, the first search with the buffer
    # in, then the loop; launches counted from 0 just before the loop
    with _counted(own):
        state = ivf.attach(index, nprobe=SERVE_NPROBE, fused_refresh=True)
        engine = search.Engine(ivf, state, k=10, min_bucket=32)
        ctl = churn.ChurnController(engine, staging_rows=CHURN_STAGING,
                                    flush_at=CHURN_FLUSH_AT,
                                    compact_at=CHURN_COMPACT_AT)
        engine.search(Q512)
    es0 = engine.stats()
    before = {k: es0[k] for k in ("compiles", "executables")}
    shapes0 = cbench.state_shapes(ctl.state)
    shape_moves = []

    def on_step(step, add_ids, dead):
        if cbench.state_shapes(ctl.state) != shapes0:
            shape_moves.append(step)

    mut = {}
    ops.reset_launches()
    t0 = time.perf_counter()
    with _counted(own), _timed_calls(
            churn_ops, ("stage", "tombstone", "flush", "compact"), mut):
        records, _ = cbench.churn_loop(
            engine, ctl, Q512, pool, live, steps=CHURN_STEPS,
            batch=CHURN_BATCH, next_id=N, rng=np.random.default_rng(SEED),
            on_step=on_step)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    loop_launches = dict(ops.LAUNCHES)
    # a step: one scan and one side pass for the Engine's batch (its
    # tables all cache hits), a score field and a plane rotation for the
    # subspace step, two plane rotations for the fused refresh, two
    # assigns for the stage
    want = dict(ivf_adc=CHURN_STEPS, adc_lookup=CHURN_STEPS,
                givens_rotate=3 * CHURN_STEPS, gcd_score=CHURN_STEPS,
                pq_assign=2 * CHURN_STEPS)
    got = {k: v for k, v in loop_launches.items() if v}
    if got != want:
        fails.append(f"churn loop launches {got}, the path implies {want}")
    es = engine.stats()
    churn_lat = _by_bucket(engine.requests[-CHURN_STEPS:])
    if shape_moves or cbench.state_shapes(ctl.state) != shapes0:
        fails.append(f"a state shape moved at steps {shape_moves}: "
                     f"{shapes0} -> {cbench.state_shapes(ctl.state)}")

    # the side pass and the scan, held on the operands of one more batch
    seen = {}
    with _last_call("adc_lookup", seen), _last_call("ivf_adc", seen):
        engine.search(Q512)
    lut_s, codes_s, scales_s, ids_s = seen["adc_lookup"]
    bit_equal(ops.adc_lookup(lut_s, codes_s, scales_s, ids_s),
              ref.adc_lookup_ref(lut_s, codes_s, scales_s, ids_s),
              "adc_lookup side pass")
    errs["adc_lookup/churn_side_pass"] = 0.0
    lut_i, codes_i, bi, bq, scales_i, ids_i = seen["ivf_adc"]
    errs["ivf_adc/churn_tombstoned_window"] = bit_equal(
        ops.ivf_adc(lut_i, codes_i, bi, bq, scales_i, ids_i, block_size=BS),
        ref.ivf_adc_ref(lut_i, codes_i, bi, bq, block_size=BS,
                        scales=scales_i, ids=ids_i),
        "ivf_adc on the tombstoned CSR")
    scan = dict(steps=int(bi.numel()), max_blocks=ctl.state.max_blocks,
                max_list_blocks=ctl.state.index.max_list_blocks(),
                rows_in_window=int(bi.numel()) * BS,
                masked_rows_in_window=int(torch.sum(ids_i.view(-1, BS)[
                    bi.long()] < 0)))
    del seen, codes_i, ids_i

    # the JAX script's seven checks; its fresh build starts from the key
    # the index's build started from, so this one from main's build state
    g_build = torch.Generator(device=X.device)
    g_build.set_state(ctx["build_rng"])
    recalls = cbench.recall_oracles(engine, ctl, serve_config(), Q512, pool,
                                    live, SERVE_NPROBE, generator=g_build)
    # k-means alone moves one fresh build's recall by more than the check's
    # 0.01 at this size (PERF.md §6), so recall_within_rebuild is held
    # against the mean of that build and BUILD_SEEDS' builds of the same
    # live rows; the one build's comparison is printed beside it
    truth = cbench.exact_top10(Q512, pool, live)
    build_seeds = {seed: cbench.fresh_build_recall(
        Q512, pool, live, ctl.state.index.R, serve_config(), SERVE_NPROBE,
        device.generator(seed), truth) for seed in BUILD_SEEDS}
    del truth
    builds = [recalls["recall_build"], *build_seeds.values()]
    recall_build_mean = statistics.fmean(builds)
    checks = cbench.checks_of(
        es, before, records, CHURN_STEPS, CHURN_BATCH,
        dict(recalls, recall_build=recall_build_mean))
    one_build = recalls["recall_churn"] >= recalls["recall_build"] - 0.01
    rank = 1 + sum(b > recalls["recall_churn"] for b in builds)
    for name, ok in checks.items():
        if not ok:
            fails.append(f"churn check {name} failed")

    # the side pass at its shapes: b = 1, 32, 512 served queries' float32
    # and int8 tables, the buffer half full, full and empty
    stg = ctl.state.staging
    lut_all = ivf.luts(ctl.state, ivf.rotate_queries(ctl.state, Q512))
    g = torch.Generator(device=X.device)
    g.manual_seed(SEED + 5)
    codes_b = torch.randint(0, K, stg.codes.shape, generator=g,
                            device=X.device, dtype=torch.uint8)
    full = torch.arange(CHURN_STAGING, dtype=torch.int32, device=X.device)
    fills = {"half": torch.where(full % 2 == 0, full, -1), "full": full,
             "empty": torch.full_like(full, -1)}
    for b in SIDE_BATCHES:
        for dt, (lut, scales) in _lut_variants(lut_all[:b]).items():
            if dt == "uint8":
                continue
            for fill, ids_b in fills.items():
                name = f"adc_lookup/side_b{b}_{dt}_{fill}"
                errs[name] = bit_equal(
                    ops.adc_lookup(lut, codes_b, scales, ids_b),
                    ref.adc_lookup_ref(lut, codes_b, scales, ids_b), name)
    lut512 = lut_all.contiguous()
    half = fills["half"]
    side_ms = graph_ms(lambda: ops.adc_lookup(lut512, codes_b, None, half),
                       launches=50)
    side_plain_ms = graph_ms(
        lambda: ref.adc_lookup_ref(lut512, codes_b, None, half), launches=5)
    lib = flat_library(lut512, codes_b)
    side_lib_ms = graph_ms(lib, launches=20)
    del lib
    tiles = torch.arange(CHURN_STAGING // BS, device=X.device)
    nbytes = _scan_bytes(lut512, None, codes_b, half, tiles, BS,
                         BATCHES[0] * CHURN_STAGING, 0)
    flops = BATCHES[0] * int(torch.sum(half >= 0)) * D
    side = dict(shape=dict(b=BATCHES[0], Dp=D, K=K, N=CHURN_STAGING,
                           live=int(torch.sum(half >= 0))),
                ms=side_ms, plain_ms=side_plain_ms, library_ms=side_lib_ms,
                bytes=nbytes, flops=flops, **_bound(nbytes, flops))
    # a prepared batch with and without the side pass and its merge
    # (CUDA events, host latency inside: the side pass syncs once for its
    # top-k's candidate count)
    QR512 = ivf.rotate_queries(ctl.state, Q512)
    bare = dataclasses.replace(ctl.state, staging=None)
    side["search_event_ms"] = {
        name: time_ms(lambda st=st: ivf.search_prepared(st, QR512, lut512,
                                                        k=10),
                      reps=10, flush=False)
        for name, st in (("without_side_pass", bare),
                         ("with_side_pass", ctl.state))}

    # the second run: a BackgroundCompactor, a StalenessTracker and a
    # re-encode from the pool, on a new Engine over the end state
    engine2 = search.Engine(ivf, ctl.state, k=10, min_bucket=32)
    t0 = time.perf_counter()
    tracker = churn.StalenessTracker(np.nonzero(live)[0])
    track_s = time.perf_counter() - t0
    comp = churn.BackgroundCompactor(
        engine2, tracker=tracker, reencode_rows=BG_REENCODE_ROWS,
        reencode_fn=lambda rid: pool[torch.from_numpy(
            np.asarray(rid)).to(pool.device)])
    ctl2 = churn.ChurnController(engine2, flush_at=CHURN_FLUSH_AT,
                                 compact_at=BG_COMPACT_AT, compactor=comp)
    submit_ms = []
    real_submit = comp.submit

    def timed_submit():
        t = time.perf_counter()
        out = real_submit()
        submit_ms.append((time.perf_counter() - t) * 1e3)
        return out

    comp.submit = timed_submit

    def bg_step(step, add_ids, dead):
        tracker.bump()
        tracker.record(add_ids)
        tracker.forget(dead)

    bg_mut = {}
    bg_before = dict(ops.LAUNCHES)
    with _counted(own), _timed_calls(churn_ops, ("stage", "tombstone",
                                                 "flush"), bg_mut):
        bg_records, _ = cbench.churn_loop(
            engine2, ctl2, Q512, pool, live, steps=BG_STEPS,
            batch=CHURN_BATCH, next_id=N + CHURN_STEPS * CHURN_BATCH,
            rng=np.random.default_rng(SEED + 1), on_step=bg_step)
        comp.join()
        ctl2.poll_background()
    bg_launch = _launch_delta(bg_before)
    bg = engine2.stats()["churn"]
    if bg["bg_compactions"] < 1:
        fails.append(f"no background compaction swapped in: {bg}")
    if bg["bg_compactions"] + bg["bg_discarded"] > bg["bg_submitted"]:
        fails.append(f"more swaps than submits: {bg}")
    if not all(r["ids_live"] and not r["surfaced_tombstone"]
               for r in bg_records):
        fails.append("a dead id was served in the background run")
    passes = bg["bg_submitted"]
    # as a step above, the new Engine's first batch building its tables,
    # and two assigns for each pass's re-encode
    want_bg = dict(ivf_adc=BG_STEPS, adc_lookup=BG_STEPS,
                   givens_rotate=3 * BG_STEPS, gcd_score=BG_STEPS,
                   pq_assign=2 * BG_STEPS + 2 * passes, fused_lut=1)
    if bg_launch != want_bg:
        fails.append(f"background run launches {bg_launch}, the path "
                     f"implies {want_bg} ({passes} re-encoding passes)")
    # a pass that raced nothing equals a foreground compact of its snapshot
    snap = engine2.state
    fg = churn_ops.compact(snap, include_staged=False)
    comp_q = churn.BackgroundCompactor(engine2)
    comp_q.submit()
    comp_q.join()
    swapped = comp_q.poll()
    bg_equal = bool(swapped and torch.equal(engine2.state.index.codes,
                                            fg.index.codes)
                    and torch.equal(engine2.state.index.ids, fg.index.ids))
    if not bg_equal:
        fails.append("a quiet background pass differs from a foreground "
                     "compact of its snapshot")
    comp.close()
    comp_q.close()
    bg_hidden = engine2.obs.distribution("churn.compact_hidden_ms")
    hidden = {
        name: _hidden_ms(engine2, Q512, churn.BackgroundCompactor(
            engine2, registry=obs.Registry(), **kw), fails)
        for name, kw in (("bare", {}), ("reencode", dict(
            tracker=tracker, reencode_rows=BG_REENCODE_ROWS,
            reencode_fn=lambda rid: pool[torch.from_numpy(
                np.asarray(rid)).to(pool.device)])))}

    emit("churn", n=N, steps=CHURN_STEPS, batch=CHURN_BATCH,
         staging_rows=CHURN_STAGING, flush_at=CHURN_FLUSH_AT,
         compact_at=CHURN_COMPACT_AT, nprobe=SERVE_NPROBE,
         queries=BATCHES[0], checks=checks, **recalls,
         recall_build_by_seed=build_seeds,
         recall_build_mean=recall_build_mean,
         recall_within_rebuild_margin=(recalls["recall_churn"]
                                       - (recall_build_mean - 0.01)),
         recall_within_one_rebuild=one_build,
         recall_churn_rank=dict(rank=rank, of=len(builds) + 1),
         stats={k: es["churn"][k] for k in (
             "staged", "flushed", "tombstoned", "flushes", "compactions",
             "grows", "flush_ms_p95")},
         new_executables=es["executables"] - before["executables"],
         lut_invalidations=es["lut_invalidations"],
         shapes=shapes0, launches=loop_launches, expected_launches=want,
         mutate_ms={k: _pcts(v) for k, v in mut.items()},
         step_ms=_pcts([r["mutate_ms"] for r in records]),
         latency_ms_by_bucket=dict(churn=churn_lat, without=base_lat),
         rows_scanned_per_query=dict(
             without_staging=base_st["scanned_rows_mean"],
             with_staging=es["scanned_rows_mean"],
             max_blocks=dict(without=base_st["searcher"]["max_blocks"],
                             with_staging=ctl.state.max_blocks),
             window_rows=dict(
                 without=SERVE_NPROBE * base_st["searcher"]["max_blocks"]
                 * BS, with_staging=SERVE_NPROBE * ctl.state.max_blocks
                 * BS)),
         side_pass=side, scan_window=scan,
         background=dict(
             steps=BG_STEPS, compact_at=BG_COMPACT_AT,
             **{k: bg[k] for k in ("bg_submitted", "bg_compactions",
                                   "bg_discarded", "flushes_deferred",
                                   "reencoded", "compactions",
                                   "compact_hidden_ms_total")},
             bg_compact_ms=_pcts(bg_hidden.window_values()),
             submit_ms=_pcts(submit_ms), tracker_record_s=track_s,
             mutate_ms={k: _pcts(v) for k, v in bg_mut.items()},
             launches=bg_launch, expected_launches=want_bg,
             quiet_pass_bit_equal=bg_equal, hidden=hidden),
         loop_s=loop_s, total_s=time.perf_counter() - t_all, card=smi,
         fails=fails)
    check(not fails, "; ".join(fails))
    return errs, own


# -- rq -----------------------------------------------------------------------


def _rq_flips(index, X) -> dict:
    """Rows whose stored RQ codes differ from a float32 re-encode against
    ``index``; of those in the same list, how many first differ in a
    level-0 column, and how many of these are a float32 tie there: the two
    level-0 codewords' squared distances to the residual, in float64,
    within TIE_GAP of the scale. A level-0 flip changes the residual every
    later level sees, so its later columns differ too."""
    import torch

    from repro_torch.index import ivf

    lists, codes = ivf.encode(X @ index.R, index.coarse, index.quantizer)
    rows = torch.nonzero(index.ids >= 0).squeeze(1)
    item = index.ids[rows].long()
    flip = torch.any(index.codes[rows].int() != codes[item], dim=1)
    rows, item = rows[flip], item[flip]
    out = dict(rows=int(rows.numel()), coarse_flips=0, level0_first=0,
               level0_ties=0, max_level0_rel_gap=0.0)
    if not rows.numel():
        return out
    ls = torch.searchsorted(index.list_offsets.long(), rows, right=True) - 1
    same = ls == lists[item].long()
    out["coarse_flips"] = int((~same).sum())
    stored = index.codes[rows[same]].long()
    new = codes[item[same]].long()
    first = (stored != new).int().argmax(dim=1)
    lvl0 = first < D
    out["level0_first"] = int(lvl0.sum())
    if bool(lvl0.any()):
        sub = DIM // D
        x = X[item[same][lvl0]].double() @ index.R.double()
        r = (x - index.centroids.double()[ls[same][lvl0]]).view(-1, D, sub)
        d = first[lvl0]
        rd = r[torch.arange(r.shape[0], device=r.device), d]
        cb0 = index.quantizer.codebooks[0].double()
        cs = cb0[d, stored[lvl0, d]]
        cr = cb0[d, new[lvl0, d]]
        gap = (((rd - cs) ** 2).sum(-1) - ((rd - cr) ** 2).sum(-1)).abs() / (
            (rd ** 2).sum(-1) + torch.maximum((cs ** 2).sum(-1),
                                              (cr ** 2).sum(-1)))
        out["level0_ties"] = int((gap <= TIE_GAP).sum())
        out["max_level0_rel_gap"] = float(gap.max())
    return out


def _residual_distortion(index, X) -> float:
    """The JAX script's residual distortion: the quantizer's distortion of
    the first RQ_SAMPLE rows' residuals to their coarse centroids."""
    XRs = X[:RQ_SAMPLE] @ index.R
    res = XRs - index.centroids[index.coarse.assign(XRs).long()]
    return float(index.quantizer.distortion(res))


def phase_rq(ctx: dict, smi: str):
    """A depth-2 residual (RQ) index on main's corpus and R at the serving
    width: build, serve at three nprobe and the flat scan, a subspace-GCD
    refresh, serve again, and an Engine over a fused-refresh RQ state with
    int8 tables through one refresh. Held: rq_beats_pq_quantization
    against main's PQ index, rq2_end_to_end, nprobe = L against the flat
    scan, the scan reduction at recall, the fused Engine's executables and
    tables, and the path's kernels at Dp = M·D on its operands."""
    import torch

    from repro_torch import device, rotations, search
    from repro_torch.index import maintain
    from repro_torch.index import search as index_search
    from repro_torch.kernels import ops, ref
    from repro_torch.metrics import recall_at_k

    t_all = time.perf_counter()
    X, Q, R, truth = ctx["X"], ctx["Q"], ctx["R"], ctx["truth"]
    Dp = RQ_DEPTH * D
    ivf, flat = search.make("ivf"), search.make("flat_adc")
    own, errs, seen, fails = {}, {}, {}, []
    ops.reset_launches()
    g = device.generator(SEED + 7)
    t0 = time.perf_counter()
    with _counted(own), _last_call("pq_assign", seen):
        state = ivf.build(g, X, R, serve_config()._replace(depth=RQ_DEPTH))
        torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    st = ivf.stats(state)
    check(st["rows"] == N, "the RQ index lost rows")
    check(st["code_bytes_per_row"] == Dp, f"RQ code bytes {st}")
    # pq_assign on the build's last call: the last chunk's level-1 residuals
    xa, cba = seen.pop("pq_assign")
    check(torch.equal(cba, state.index.quantizer.codebooks[1]),
          "the build's last assign is not level 1's")
    level1_flips = _assign_flips(xa, cba, ops.pq_assign(xa, cba),
                                 ref.pq_assign_ref(xa, cba))
    errs["pq_assign/rq_level1_residuals"] = level1_flips["max_abs_gap"]

    with _counted(own):
        flat_truth = flat.search(flat.attach(state.index), Q, k=10).ids
        ivf.search(state, Q[:BATCHES[-1]], k=10)          # warm-up
        serve = [_serve(ivf, state, Q, truth, flat_truth, p, smi)
                 for p in NPROBES]
    for s in serve:
        s["scan_reduction"] = N / s["rows_scanned_per_query"]
    at_recall = any(s["recall_vs_flat_adc"] >= ACCEPT_RECALL
                    and s["scan_reduction"] >= ACCEPT_REDUCTION
                    for s in serve)
    if not at_recall:
        fails.append(f"no nprobe reaches recall {ACCEPT_RECALL} against the "
                     f"flat scan at a {ACCEPT_REDUCTION}x reduction: {serve}")

    # rq_beats_pq_quantization (benchmarks/ivf_recall_qps.py:384-393):
    # against main's PQ index of the same corpus under the same R
    pq_index = ctx["index_before"]
    pq_d = _residual_distortion(pq_index, X)
    rq_d = _residual_distortion(state.index, X)
    pq_flat = recall_at_k(flat.search(flat.attach(pq_index), Q, k=10).ids,
                          truth)
    rq_flat = recall_at_k(flat_truth, truth)
    rq_beats = rq_d < pq_d and rq_flat >= pq_flat - 1e-6
    if not rq_beats:
        fails.append(f"rq_beats_pq_quantization: distortion {rq_d} against "
                     f"{pq_d}, flat recall {rq_flat} against {pq_flat}")

    # nprobe = L against the flat scan over the same codes
    qf = Q[:FLAT_QUERIES]
    full = ivf.search(state, qf, k=10, nprobe=L)
    ref_res = flat.search(flat.attach(state.index), qf, k=10)
    flat_err = float((full.scores - ref_res.scores).abs().max())
    if not (torch.equal(full.ids, ref_res.ids) and flat_err <= 1e-4):
        fails.append(f"nprobe = L differs from flat_adc (scores {flat_err})")

    # a subspace-GCD step, refreshed into the RQ index, then serve
    index_before = state.index
    with _counted(own):
        Rp = R.clone().requires_grad_(True)
        loss = index_before.quantizer.distortion(X[:TRAIN] @ Rp)
        (G,) = torch.autograd.grad(loss, Rp)
        learner = rotations.make("subspace_gcd", sub=DIM // D)
        _, delta = learner.update(learner.init_from(R), G, GCD_LR)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with _last_call("givens_rotate", seen, by_shape=True):
            state = ivf.refresh(state, delta)
        torch.cuda.synchronize()
        t_refresh = time.perf_counter() - t0
        after = _serve(ivf, state, Q, truth, flat_truth, SERVE_NPROBE, smi)
    mismatch = maintain.refresh_mismatch(state.index, X)
    flips = _rq_flips(state.index, X)
    end_to_end = (mismatch <= RQ_MISMATCH_LIMIT
                  and math.isfinite(after["recall_at_10"])
                  and after["recall_at_10"] > 0.0)
    if not end_to_end:
        fails.append(f"rq2_end_to_end: refresh mismatch {mismatch}, recall "
                     f"after {after['recall_at_10']}")
    # givens_rotate on the stacked codebook rows (M·K, n)
    rows_shape = (RQ_DEPTH * K, DIM)
    rot_args = seen.pop(("givens_rotate", rows_shape))
    errs["givens_rotate/rq_codebook_rows"] = bit_equal(
        ops.givens_rotate(*rot_args), ref.pair_rotate_ref(*rot_args),
        f"givens_rotate on the RQ codebook rows {rows_shape}")
    stored = state.index.codebooks.movedim(-2, -3).reshape(rows_shape)
    check(torch.equal(stored, ref.pair_rotate_ref(*rot_args)),
          "the refreshed RQ codebooks differ from the plain rotation")

    # the Engine over a fused-refresh RQ state with int8 tables: a
    # within-subspace refresh makes no executable and drops no table
    with _counted(own), _last_call("fused_lut", seen):
        fstate = ivf.attach(state.index, nprobe=SERVE_NPROBE,
                            fused_refresh=True, lut_dtype="int8")
        engine = search.Engine(ivf, fstate, k=10, min_bucket=32)
        Q512 = Q[:BATCHES[0]]
        engine.search(Q512)
        es0 = engine.stats()
        Rp = state.index.R.clone().requires_grad_(True)
        loss = state.index.quantizer.distortion(X[:TRAIN] @ Rp)
        (G2,) = torch.autograd.grad(loss, Rp)
        _, delta2 = learner.update(learner.init_from(state.index.R), G2,
                                   GCD_LR)
        engine.refresh(delta2)
        res_f = engine.search(Q512)
        torch.cuda.synchronize()
    es = engine.stats()
    fused = dict(new_executables=es["executables"] - es0["executables"],
                 lut_invalidations=es["lut_invalidations"],
                 lut_epoch=es["lut_epoch"], lut_hits=es["lut_hits"],
                 recall_at_10=recall_at_k(res_f.ids, truth[:BATCHES[0]]))
    if fused["new_executables"] or fused["lut_invalidations"] \
            or fused["lut_epoch"]:
        fails.append(f"the fused RQ Engine's refresh moved its executables "
                     f"or tables: {fused}")
    launches = dict(ops.LAUNCHES)
    t_path = time.perf_counter() - t_all

    # fused_lut with the level-major map, on the Engine's own operands
    rel = {}
    q_l, qd_l, cb_l, cm_l = seen.pop("fused_lut")[:4]
    check(cb_l.shape == (Dp, K, DIM // D), f"fused_lut operands {cb_l.shape}")
    _hold_fused_lut("rq_level_major", q_l, qd_l, cb_l, cm_l, errs, rel,
                    fails)

    # the scans at Dp = M·D, bit-equal in every LUT type, masked and not:
    # ivf_adc on the serve_p99 schedule at nprobe 32, adc_lookup on the
    # flat check's tables over every CSR row
    index = state.index
    codes, ids = index.codes, index.ids
    mb = index.max_list_blocks()
    QR = Q512 @ index.R
    sched = index_search.scan_schedule(index, QR, nprobe=SERVE_NPROBE,
                                       max_blocks=mb)
    bi, bq = sched.block_idx, sched.block_query
    lut32 = index_search.build_luts(index.quantizer, QR)
    lutf = index_search.build_luts(index.quantizer, Q[:FLAT_QUERIES]
                                   @ index.R)
    for dt, (lut, scales) in _lut_variants(lut32).items():
        for m in (None, ids):
            errs[f"ivf_adc/rq_dp{Dp}/{dt}/mask={m is not None}"] = \
                bit_equal(ops.ivf_adc(lut, codes, bi, bq, scales, m,
                                      block_size=BS),
                          ref.ivf_adc_ref(lut, codes, bi, bq, block_size=BS,
                                          scales=scales, ids=m),
                          f"ivf_adc at Dp = {Dp} {dt}")
    for dt, (lut, scales) in _lut_variants(lutf).items():
        for m in (None, ids):
            errs[f"adc_lookup/rq_dp{Dp}/{dt}/mask={m is not None}"] = \
                bit_equal(ops.adc_lookup(lut, codes, scales, m),
                          ref.adc_lookup_ref(lut, codes, scales, m),
                          f"adc_lookup at Dp = {Dp} {dt}")

    # times: the scans at Dp = 64 and fused_lut at the RQ shapes, beside
    # their plain versions, bounds and library yardsticks
    S = bi.numel()
    work = ivf_work(lut32, None, codes, ids, bi, BS)
    # the yardstick's index tensor holds S·BS·Dp = 2.7e9 entries here,
    # past the 2^31 a single embedding_bag call indexes: two calls, one a
    # half of the schedule
    halves = [ivf_library(lut32, codes, bi[h], bq[h], BS)
              for h in (slice(0, S // 2), slice(S // 2, S))]

    def lib():
        return [f() for f in halves]

    ivf_row = dict(
        shape=dict(b=BATCHES[0], nprobe=SERVE_NPROBE, max_blocks=mb, Dp=Dp,
                   K=K, S=S), live_rows=work["live_rows"],
        ms=graph_ms(lambda: ops.ivf_adc(lut32, codes, bi, bq, None, ids,
                                        block_size=BS), launches=20),
        plain_ms=graph_ms(lambda: ref.ivf_adc_ref(lut32, codes, bi, bq,
                                                  block_size=BS, ids=ids),
                          launches=2),
        library_ms=graph_ms(lib, launches=5),
        library="two F.embedding_bag calls, a half of the schedule each",
        bytes=work["bytes"], flops=work["flops"],
        bound_ms=work["bound_ms"], bound_by=work["bound_by"])
    del lib, halves
    qf_n = lutf.shape[0]
    all_tiles = torch.arange(index.capacity // BS, device=codes.device)
    nbytes = _scan_bytes(lutf, None, codes, ids, all_tiles, BS,
                         qf_n * index.capacity, 0)
    flops = qf_n * int(torch.sum(ids >= 0)) * Dp
    lib = flat_library(lutf, codes)
    flat_row = dict(
        shape=dict(b=qf_n, N=index.capacity, Dp=Dp, K=K),
        ms=graph_ms(lambda: ops.adc_lookup(lutf, codes, None, ids),
                    launches=20),
        plain_ms=graph_ms(lambda: ref.adc_lookup_ref(lutf, codes, None,
                                                     ids), launches=2),
        library_ms=graph_ms(lib, launches=5), bytes=nbytes, flops=flops,
        **_bound(nbytes, flops))
    del lib
    cols = ops.lut_column_map(cm_l)
    b_l, sub = q_l.shape[0], DIM // D
    cbT = cb_l.transpose(1, 2).contiguous()                  # (Dp, sub, K)

    def lut_library():
        QL = torch.matmul(q_l, qd_l).view(b_l, D, sub).transpose(0, 1)
        return torch.bmm(QL.repeat(RQ_DEPTH, 1, 1), cbT)      # (Dp, b, K)

    nbytes = 4 * (b_l * DIM + DIM * DIM + Dp * K * sub + b_l * Dp * K + Dp)
    flops = 2 * b_l * DIM * DIM + 2 * b_l * Dp * K * sub
    lut_row = dict(
        shape=dict(b=b_l, n=DIM, Dp=Dp, K=K, sub=sub),
        ms=graph_ms(lambda: ops.fused_lut(q_l, qd_l, cb_l, cm_l, cols=cols),
                    launches=50),
        plain_ms=graph_ms(lambda: ref.fused_lut_ref(q_l, qd_l, cb_l, cm_l),
                          launches=20),
        library_ms=graph_ms(lut_library, launches=20),
        library="torch.matmul(Q, qdelta), the subspaces repeated per "
                "level, then torch.bmm",
        library_max_abs_err=float((lut_library().transpose(0, 1)
                                   - ref.fused_lut_ref(q_l, qd_l, cb_l,
                                                       cm_l)).abs().max()),
        bytes=nbytes, flops=flops, **_bound(nbytes, flops), rel_err=rel)

    # givens_rotate on the stacked codebook rows, its yardstick one matmul
    # by the dense Δ; pq_assign on the build's last level-1 residuals
    Xr, pi, pj, c, s_ = rot_args
    m_r, p_r = Xr.shape[0], pi.numel()
    dense = ref.pair_rotate_ref(torch.eye(DIM, device=Xr.device), pi, pj,
                                c, s_)
    nbytes, flops = 2 * m_r * DIM * 4 + 4 * p_r * 4, 6 * m_r * p_r
    rot_row = dict(
        shape=dict(m=m_r, n=DIM, pairs=p_r),
        ms=graph_ms(lambda: ops.givens_rotate(*rot_args), launches=100),
        plain_ms=graph_ms(lambda: ref.pair_rotate_ref(*rot_args),
                          launches=100),
        library_ms=graph_ms(lambda: torch.matmul(Xr, dense), launches=100),
        bytes=nbytes, flops=flops, **_bound(nbytes, flops))
    m_a = xa.shape[0]
    Da, Ka, suba = cba.shape
    nbytes = m_a * DIM * 4 + Da * Ka * suba * 4 + m_a * Da * 4
    flops = 2 * m_a * DIM * Ka
    assign_row = dict(
        shape=dict(m=m_a, n=DIM, D=Da, K=Ka, sub=suba),
        ms=graph_ms(lambda: ops.pq_assign(xa, cba), launches=20),
        plain_ms=graph_ms(lambda: ref.pq_assign_ref(xa, cba), launches=2),
        library_ms=None, bytes=nbytes, flops=flops,
        **_bound(nbytes, flops))
    del xa, dense

    for name in ("ivf_adc", "adc_lookup", "fused_lut", "pq_assign",
                 "givens_rotate", "gcd_score"):
        if not own.get(name):
            fails.append(f"kernel {name} was not launched on the rq path")
    emit("rq", n=N, dim=DIM, subspaces=D, codewords=K, num_lists=L,
         depth=RQ_DEPTH, code_bytes_per_row=st["code_bytes_per_row"],
         capacity=st["capacity"], max_blocks=st["max_blocks"],
         build_s=t_build, serve=serve, scan_reduction_at_recall=at_recall,
         rq_beats_pq_quantization=dict(
             passed=rq_beats, residual_distortion=dict(rq=rq_d, pq=pq_d),
             flat_recall_at_10=dict(rq=rq_flat, pq=pq_flat),
             sample_rows=RQ_SAMPLE),
         flat_check=dict(queries=FLAT_QUERIES, max_abs_score_diff=flat_err),
         refresh_s=t_refresh, after_refresh=after,
         rq2_end_to_end=dict(passed=end_to_end, refresh_mismatch=mismatch,
                             limit=RQ_MISMATCH_LIMIT, code_flips=flips),
         fused_engine=fused, level1_assign_flips=level1_flips,
         kernels=dict(ivf_adc=ivf_row, adc_lookup=flat_row,
                      fused_lut=lut_row, givens_rotate=rot_row,
                      pq_assign=assign_row),
         launches=launches, path_launches=own, path_s=t_path,
         total_s=time.perf_counter() - t_all, card=smi, fails=fails)
    check(not fails, "; ".join(fails))
    return errs, own


# -- train_e2e ----------------------------------------------------------------


class _PartLaunches(dict):
    """``kernels.ops.LAUNCHES`` for a block (``_parts``): every increment a
    wrapper makes also lands on the part its thread is in, the main
    thread's current part or the name of a worker thread's pool
    ("background" for the compactor, "prefetch" for the input pipeline),
    under a lock, so the worker's launches are counted apart from the
    training thread's, whatever they overlap."""

    def __init__(self, base: dict, part_of):
        super().__init__(base)
        self._lock = threading.Lock()
        self._read = threading.local()
        self._part_of = part_of
        self.parts: dict = {}

    def __getitem__(self, key):
        value = super().__getitem__(key)
        self._read.last = (key, value)
        return value

    def __setitem__(self, key, value):
        last = getattr(self._read, "last", None)
        self._read.last = None
        with self._lock:
            if last is not None and last[0] == key and value == last[1] + 1:
                super().__setitem__(key, super().__getitem__(key) + 1)
                part = self.parts.setdefault(self._part_of(), {})
                part[key] = part.get(key, 0) + 1
            else:
                super().__setitem__(key, value)


@contextlib.contextmanager
def _parts(into: dict, ms: dict):
    """Inside the block, the launches of each part, by thread: yields
    ``part(name)``, a context that names the main thread's part and adds
    its host milliseconds to ``ms[name]``; ``into`` gets {part: {kernel:
    launches}} and ``kernels.ops.LAUNCHES`` the totals."""
    from repro_torch.kernels import ops

    current = ["other"]

    def part_of() -> str:
        t = threading.current_thread()
        if t is threading.main_thread():
            return current[0]
        if t.name.startswith("churn-compact"):
            return "background"
        if t.name.startswith("pipeline-prefetch"):
            return "prefetch"
        return t.name

    @contextlib.contextmanager
    def part(name: str):
        was = current[0]
        current[0] = name
        t0 = time.perf_counter()
        try:
            yield
        finally:
            ms.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
            current[0] = was

    base = ops.LAUNCHES
    counting = _PartLaunches(base, part_of)
    ops.LAUNCHES = counting
    try:
        yield part
    finally:
        ops.LAUNCHES = base
        base.update(dict(counting))
        for p, counts in counting.parts.items():
            mine = into.setdefault(p, {})
            for k, v in counts.items():
                mine[k] = mine.get(k, 0) + v


def _scaled(counts: dict, times: int) -> dict:
    return {k: v * times for k, v in counts.items() if v * times}


def _sum_counts(*parts: dict) -> dict:
    out: dict = {}
    for p in parts:
        for k, v in p.items():
            out[k] = out.get(k, 0) + v
    return {k: v for k, v in out.items() if v}


def phase_train_e2e(ctx: dict, smi: str):
    """The overlapped training loop of repro_torch.bench.train_e2e on
    main's PQ index: the bare, bg and sync arms and the replayed rebuild
    arm, at TE_* sizes. Held: zero_steady_recompiles, recall_matches_rebuild,
    background_ran, prefetch_effective, training_converged, the loop's
    counts and each part's launches; reported: the two timing checks with
    their margins, each arm's step p50 / p99 and where its time goes."""
    import numpy as np
    import torch

    from repro_torch.bench import train_e2e as te
    from repro_torch.kernels import ops, ref

    t_all = time.perf_counter()
    X, Q512 = ctx["X"], ctx["Q"][:BATCHES[0]]
    index0 = ctx["index"]
    pool = torch.cat([X, ctx["adds"]])            # row = item id
    live0 = np.zeros(pool.shape[0], dtype=bool)
    live0[:N] = True
    sched = te.schedule(N, TE_STEPS, TE_CHURN_BATCH, TE_CHURN_EVERY)
    check(N + sum(len(e[0]) for e in sched if e) <= pool.shape[0],
          "the schedule's adds outrun main's held-out rows")
    kw = dict(index0=index0, pool=pool, Q=Q512, live0=live0, sched=sched,
              steps=TE_STEPS, batch=TE_BATCH, dim=DIM, nprobe=SERVE_NPROBE,
              staging_rows=CHURN_STAGING, refresh_every=TE_REFRESH_EVERY,
              compact_every=TE_COMPACT_EVERY,
              reencode_rows=TE_REENCODE_ROWS, warmup=TE_WARMUP,
              probe_every=TE_PROBE_EVERY, seed=SEED + 7)
    arms, parts, part_ms, seen, fails, errs = {}, {}, {}, {}, [], {}
    own = {}
    for mode in ("bare", "bg", "sync"):
        parts[mode], part_ms[mode] = {}, {}
        ops.reset_launches()
        t0 = time.perf_counter()
        spies = ([_last_call(n, seen) for n in ("gcd_score", "pq_assign",
                                                "ivf_adc", "adc_lookup")]
                 + [_last_call("givens_rotate", seen, by_shape=True)]
                 if mode == "bg" else [])
        with contextlib.ExitStack() as stack:
            for s in spies:
                stack.enter_context(s)
            stack.enter_context(_counted(own))
            part = stack.enter_context(_parts(parts[mode], part_ms[mode]))
            arms[mode] = te.train_arm(mode, part=part, **kw)
            torch.cuda.synchronize()
        arms[mode]["arm_s"] = time.perf_counter() - t0
        arms[mode]["launches"] = {k: v for k, v in ops.LAUNCHES.items() if v}
    bare, bg, sync = arms["bare"], arms["bg"], arms["sync"]
    t0 = time.perf_counter()
    rebuild = te.rebuild_arm(
        index0=index0, pool=pool, Q=Q512, live0=live0, sched=sched,
        deltas=bg["deltas"], steps=TE_STEPS, nprobe=SERVE_NPROBE,
        staging_rows=CHURN_STAGING, refresh_every=TE_REFRESH_EVERY,
        probe_every=TE_PROBE_EVERY)
    rebuild_s = time.perf_counter() - t0
    results, checks = te.checks_of(bare, bg, sync, rebuild,
                                   TE_REENCODE_ROWS)

    # the launches each part implies: a train step scores, rotates R and
    # encodes its batch once; a churn step stages (two assigns); a delta
    # rotates R, the centroids and the codebooks; a probe (and the first
    # search) scans once and runs the side pass; a background or
    # synchronous pass re-encodes its stalest rows (two assigns)
    churn_steps = sum(e is not None for e in sched)
    probes = TE_STEPS // TE_PROBE_EVERY
    step = dict(pq_assign=1, gcd_score=1, givens_rotate=1)
    want = {"bare": {"train_step": _scaled(step, TE_STEPS)}}
    for mode in ("bg", "sync"):
        ch = arms[mode]["churn"]
        want[mode] = {
            "train_step": _scaled(step, TE_STEPS),
            "churn": _scaled(dict(pq_assign=2), churn_steps),
            "refresh": _scaled(dict(givens_rotate=3), TE_STEPS),
            "probe": _scaled(dict(ivf_adc=1, adc_lookup=1), 1 + probes)}
        if mode == "bg":
            want[mode]["background"] = _scaled(
                dict(pq_assign=2), ch["bg_compactions"] + ch["bg_discarded"])
        else:
            want[mode]["sync_compact"] = _scaled(
                dict(pq_assign=2), TE_STEPS // (TE_REFRESH_EVERY
                                                * TE_COMPACT_EVERY))
    for mode in arms:
        got = {p: c for p, c in parts[mode].items() if c}
        if got != want[mode]:
            fails.append(f"{mode} arm launches {got}, the loop implies "
                         f"{want[mode]}")
        if arms[mode]["launches"] != _sum_counts(*got.values()):
            fails.append(f"{mode} arm: the parts' launches do not add up to "
                         f"its total {arms[mode]['launches']}")

    # the path's kernels on the bg arm's last operands
    G, Rg = seen.pop("gcd_score")
    got = ops.gcd_score(G, Rg)
    errs["gcd_score/train_e2e"] = compare(got, ref.gcd_score_ref(G, Rg),
                                          GCD_ATOL, 0.0)
    check(torch.equal(got, -got.T), "gcd_score train_e2e not antisymmetric")
    xa, cba = seen.pop("pq_assign")
    assign_flips = _assign_flips(xa, cba, ops.pq_assign(xa, cba),
                                 ref.pq_assign_ref(xa, cba))
    errs["pq_assign/train_e2e"] = assign_flips["max_abs_gap"]
    lut, codes, bi, bq, scales, ids = seen.pop("ivf_adc")
    errs["ivf_adc/train_e2e_window"] = bit_equal(
        ops.ivf_adc(lut, codes, bi, bq, scales, ids, block_size=BS),
        ref.ivf_adc_ref(lut, codes, bi, bq, block_size=BS, scales=scales,
                        ids=ids), "ivf_adc in train_e2e")
    args = seen.pop("adc_lookup")
    errs["adc_lookup/train_e2e_side_pass"] = bit_equal(
        ops.adc_lookup(*args), ref.adc_lookup_ref(*args),
        "adc_lookup side pass in train_e2e")
    rot_shapes = []
    for key in [k for k in seen if k[0] == "givens_rotate"]:
        args = seen.pop(key)
        rot_shapes.append(list(key[1]))
        errs[f"givens_rotate/train_e2e_{key[1][0]}x{key[1][1]}"] = bit_equal(
            ops.givens_rotate(*args), ref.pair_rotate_ref(*args),
            f"givens_rotate {key[1]} in train_e2e")
    del seen, G, Rg, xa, lut, codes, ids, args

    loop = bg["loop"]
    held = {k: checks[k] for k in ("zero_steady_recompiles",
                                   "recall_matches_rebuild",
                                   "background_ran", "prefetch_effective",
                                   "training_converged")}
    for name, ok in held.items():
        if not ok:
            fails.append(f"train_e2e check {name} failed")
    if loop["deltas_applied"] != TE_STEPS or \
            loop["refresh_rounds"] != TE_STEPS // TE_REFRESH_EVERY:
        fails.append(f"LiveIndexLoop.stats() {loop}: {TE_STEPS} deltas in "
                     f"{TE_STEPS // TE_REFRESH_EVERY} rounds expected")
    overhead = results["overhead_ratio"]
    timing = dict(
        live_step_overhead_ok=dict(
            passed=checks["live_step_overhead_ok"], ratio=overhead,
            limit=1.15, margin=1.15 - overhead),
        bg_p99_below_sync=dict(
            passed=checks["bg_p99_below_sync"], bg_ms=bg["step_ms_p99"],
            sync_ms=sync["step_ms_p99"],
            margin_ms=sync["step_ms_p99"] - bg["step_ms_p99"]))

    def arm_summary(a, mode):
        return dict(
            step_ms_p50=a["step_ms_p50"], step_ms_p99=a["step_ms_p99"],
            step_ms_max=a["step_ms_max"], loss_final=a["loss_final"],
            prefetch_hits=a["prefetch_hits"],
            prefetch_misses=a["prefetch_misses"], arm_s=a["arm_s"],
            part_ms={p: dict(_pcts(v), total=sum(v))
                     for p, v in part_ms[mode].items()},
            launches_by_part=parts[mode])

    emit("train_e2e", n=N, dim=DIM, nprobe=SERVE_NPROBE,
         queries=BATCHES[0], steps=TE_STEPS, batch=TE_BATCH,
         refresh_every=TE_REFRESH_EVERY, compact_every=TE_COMPACT_EVERY,
         reencode_rows=TE_REENCODE_ROWS, staging_rows=CHURN_STAGING,
         churn_batch=TE_CHURN_BATCH, churn_every=TE_CHURN_EVERY,
         warmup=TE_WARMUP, probe_every=TE_PROBE_EVERY,
         checks=held, timing_checks=timing,
         arms={m: arm_summary(arms[m], m) for m in arms},
         recall=dict(live_mean=results["recall_live_mean"],
                     rebuild_mean=results["recall_rebuild_mean"],
                     gap=results["recall_gap"],
                     live=bg["probes"], rebuild=rebuild),
         loop=loop, churn=bg["churn"], sync_churn=sync["churn"],
         compact_hidden_ms=bg["compact_hidden_ms"],
         staleness_hist=bg["staleness_hist"],
         shapes=bg["shapes_warm"], recompiles_steady=bg["recompiles_steady"],
         expected_launches=want, assign_flips=assign_flips,
         rotate_shapes=rot_shapes, rebuild_s=rebuild_s,
         total_s=time.perf_counter() - t_all, card=smi, fails=fails)
    check(not fails, "; ".join(fails))
    return errs, own


# -- serve ------------------------------------------------------------------


def _state_tensors(obj, prefix: str = "") -> dict:
    """Every tensor of a search state, by its path of dataclass fields."""
    import dataclasses

    import torch

    if isinstance(obj, torch.Tensor):
        return {prefix: obj}
    out = {}
    if dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            out.update(_state_tensors(getattr(obj, f.name),
                                      f"{prefix}.{f.name}"))
    return out


@contextlib.contextmanager
def _serve_spies(part, served: list, submits: dict):
    """Inside the block, the serving front end's work by part:
    ``part(name)`` (``_parts``) wraps each flush (``Frontend._serve``),
    idle tick (``_maintenance_tick``), warm-up (``create_namespace``) and
    refresh (``serve_load._cross_subspace_delta`` and ``Engine.refresh``).
    Every ``Engine.submit`` adds to ``submits[part]`` the launches its
    Pending implies: one ivf_adc, one fused_lut when a table missed the
    cache, one adc_lookup side pass on a state with a staging buffer.
    ``served`` gets a list a Frontend, in the order they are made, of
    (ticket, the state that served it)."""
    from repro_torch.bench import serve_load as sl
    from repro_torch.search.engine import Engine
    from repro_torch.serve.frontend import Frontend

    cur = ["other"]
    order = {}

    def named(name, fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            was, cur[0] = cur[0], name
            try:
                with part(name):
                    return fn(*args, **kwargs)
            finally:
                cur[0] = was
        return wrapped

    real = [(Frontend, "__init__"), (Frontend, "_serve"),
            (Frontend, "_maintenance_tick"), (Frontend, "create_namespace"),
            (Engine, "submit"), (Engine, "refresh"),
            (sl, "_cross_subspace_delta")]
    real = [(owner, name, getattr(owner, name)) for owner, name in real]
    init, flush, tick, create, submit, refresh, delta = (f for _, _, f
                                                         in real)

    def spy_init(self, *args, **kwargs):
        init(self, *args, **kwargs)
        order[id(self)] = len(served)
        served.append([])

    timed_flush = named("flush", flush)

    def spy_serve(self, ns, batch):
        state = ns.engine.state
        done = timed_flush(self, ns, batch)
        served[order[id(self)]].extend((t, state) for t in done)
        return done

    def spy_submit(self, Q, **kwargs):
        pending = submit(self, Q, **kwargs)
        tally = submits.setdefault(cur[0], {})
        for k, n in (("ivf_adc", 1),
                     ("fused_lut", int(pending.lut_misses > 0)),
                     ("adc_lookup", int(self.state.staging is not None))):
            tally[k] = tally.get(k, 0) + n
        return pending

    spies = (spy_init, spy_serve, named("idle_tick", tick),
             named("warmup", create), spy_submit, named("refresh", refresh),
             named("refresh", delta))
    for (owner, name, _), spy in zip(real, spies):
        setattr(owner, name, spy)
    try:
        yield
    finally:
        for owner, name, fn in real:
            setattr(owner, name, fn)


def _direct_agrees(ivf, state, t, fails: list, cell: str) -> dict:
    """A served ticket against a direct ``IVF.search`` of its row at the
    nprobe it was served at, on the state that served it: ids equal, or
    where they differ the direct search's scores tied within TIE_GAP of
    the scale (the Engine rotated the row in a batch of up to 16, where
    cuBLAS may round Q·R₀ otherwise); scores within the scans' ATOL and
    RTOL."""
    import torch

    q = torch.from_numpy(t.query).to(state.index.device)[None]
    want = ivf.search(state, q, k=t.k + 1, nprobe=t.nprobe_served)
    w_ids, w_sc = want.ids[0], want.scores[0]
    g_ids, g_sc = t.result.ids, t.result.scores
    # a query whose probed lists hold fewer than k rows is padded: id −1,
    # score −inf, at the same places in both
    fin = torch.isfinite(w_sc[:t.k])
    pads = torch.equal(torch.isneginf(g_sc), ~fin)
    diff = (float((g_sc[fin] - w_sc[:t.k][fin]).abs().max())
            if bool(fin.any()) else 0.0)
    same = bool(torch.equal(g_ids, w_ids[:t.k]))
    w_fin = w_sc[torch.isfinite(w_sc)]
    scale = float(w_fin.abs().max()) if w_fin.numel() else 0.0
    tie = not same and all(
        bool(fin[p]) and min(float((w_sc[p] - w_sc[p + d]).abs())
                             for d in (-1, 1)
                             if 0 <= p + d < w_sc.numel()
                             and bool(torch.isfinite(w_sc[p + d])))
        <= TIE_GAP * scale
        for p in torch.nonzero(g_ids != w_ids[:t.k]).flatten().tolist())
    if not ((same or tie) and pads and diff <= ATOL + RTOL * scale):
        fails.append(f"{cell}: request {t.rid} ({t.namespace}, nprobe "
                     f"{t.nprobe_served}) differs from a direct search: "
                     f"ids equal {same}, scores {diff}")
    return dict(same=same, tie=tie, diff=diff, padded=int((~fin).sum()))


def phase_serve(ctx: dict, smi: str):
    """repro_torch.bench.serve_load's cells over two 1M-row namespaces at
    the serving index's width: alpha main's index as a fused-refresh
    state, beta a second sift_like corpus built as main builds. Held: the
    script's five non-timing checks, the built states bit-equal after the
    cells, sampled tickets against direct searches, each part's launches
    and every kernel of the path against its plain version; reported:
    adaptive_beats_best_fixed_p99_at_equal_recall with its margin, each
    cell's latency, recall, SLO attainment, QPS, rung mix and EWMAs."""
    import tempfile

    import torch

    from repro_torch import device, obs, search
    from repro_torch.bench import serve_load as sl
    from repro_torch.core import givens
    from repro_torch.data import synthetic
    from repro_torch.kernels import ops, ref

    t_all = time.perf_counter()
    fails, errs, own, seen = [], {}, {}, {}
    ivf = search.make("ivf")
    ops.reset_launches()

    # beta: a second corpus, drawn, rotated and built as main's
    t0 = time.perf_counter()
    Xb = synthetic.sift_like(device.generator(SERVE_BETA_SEED), N, DIM)
    Rb = givens.random_rotation(device.generator(SERVE_BETA_SEED + 1), DIM)
    build_own = {}
    with _last_call("pq_assign", seen), _counted(own), _counted(build_own):
        beta = ivf.build(device.generator(SERVE_BETA_SEED + 2), Xb, Rb,
                         serve_config()._replace(fused_refresh=True))
        torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    _expect("beta's build", build_own, ctx["build_launches"])
    alpha = ivf.attach(ctx["index"], nprobe=SERVE_NPROBE, fused_refresh=True)
    pool_b = synthetic.sift_like(device.generator(SERVE_BETA_SEED + 3),
                                 SERVE_POOL, DIM)
    corpora = {"alpha": sl.namespace_corpus(alpha, ctx["X"],
                                            ctx["Q"][:SERVE_POOL]),
               "beta": sl.namespace_corpus(beta, Xb, pool_b)}
    del Xb, pool_b
    before = {nm: {p: v.clone() for p, v in _state_tensors(c["state"])
                   .items()} for nm, c in corpora.items()}

    # the path: the calibration frontends, three fixed cells and the
    # adaptive one, on one trace
    parts, part_ms, submits, served = {}, {}, {}, []
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        for name in ("gcd_score", "adc_lookup"):
            stack.enter_context(_last_call(name, seen))
        stack.enter_context(_last_call("fused_lut", seen, by_shape=True))
        stack.enter_context(_last_call("givens_rotate", seen, by_shape=True))
        stack.enter_context(_last_call(
            "ivf_adc", seen, key=lambda a: (a[1].shape[0], a[2].numel())))
        stack.enter_context(_counted(own))
        part = stack.enter_context(_parts(parts, part_ms))
        stack.enter_context(_serve_spies(part, served, submits))
        results, checks = sl.serve_cells(
            ivf, corpora, dim=DIM, ladder=SERVE_LADDER, verbose=False,
            **SERVE_TRAFFIC)
        torch.cuda.synchronize()
    t_cells = time.perf_counter() - t0
    launches = {k: v for k, v in ops.LAUNCHES.items() if v}
    cells = results["cells"]

    # the states given to the seven frontends are left as they were built
    for nm, c in corpora.items():
        now = _state_tensors(c["state"])
        if now.keys() != before[nm].keys() or not all(
                torch.equal(v, before[nm][p]) for p, v in now.items()):
            fails.append(f"serving changed {nm}'s built state")
    del before

    held = {k: v for k, v in checks.items() if k != SERVE_TIMING}
    for name, ok in held.items():
        if not ok:
            fails.append(f"serve check {name} failed")
    a = cells["adaptive"]
    timing = {SERVE_TIMING: dict(
        passed=checks[SERVE_TIMING], adaptive_p99_ms=a["p99_ms"],
        best_fixed_p99_ms=results["best_fixed_p99_ms"],
        comparable_fixed=results["comparable_fixed"],
        margin_ms=results["best_fixed_p99_ms"] - a["p99_ms"])}

    # the launches each part implies: a submit's scan, table build and side
    # pass; a refresh's GCD step (score, R) and fused refresh (rot, wacc);
    # an idle tick with nothing staged launches nothing
    refreshes = sum(c["alpha_refreshes"] for c in cells.values())
    want = {p: {k: v for k, v in t.items() if v} for p, t in submits.items()}
    want["refresh"] = dict(gcd_score=refreshes, givens_rotate=3 * refreshes)
    got = {p: c for p, c in parts.items() if c}
    if got != {p: c for p, c in want.items() if c}:
        fails.append(f"serve launches by part {got}, the path implies {want}")
    if launches != _sum_counts(build_own, *got.values()):
        fails.append(f"the parts' launches do not add up to {launches}")
    ticks = sum(c["maintenance_ticks"] for c in cells.values())
    if len(part_ms.get("idle_tick", [])) != ticks:
        fails.append(f"{len(part_ms.get('idle_tick', []))} idle ticks timed, "
                     f"the cells count {ticks}")

    # sampled tickets against direct searches on the state that served them
    names = ([f"calibration{i}" for i in range(sl.CALIBRATIONS)]
             + [f"fixed_np{r}" for r in SERVE_LADDER] + ["adaptive"])
    check(len(served) == len(names), f"{len(served)} frontends made")
    sampled = {}
    for cell, tickets in zip(names, served):
        step = max(1, len(tickets) // SERVE_SAMPLES)
        rows = [_direct_agrees(ivf, st, t, fails, cell)
                for t, st in tickets[::step]]
        sampled[cell] = dict(
            samples=len(rows), ids_equal=sum(r["same"] for r in rows),
            ties=sum(r["tie"] for r in rows),
            padded=sum(r["padded"] > 0 for r in rows),
            max_score_diff=max((r["diff"] for r in rows), default=0.0))
    waits = {cell: _pcts([t.waited_ms for t, _ in tickets])
             for cell, tickets in zip(names, served) if tickets}
    windows = {t.namespace: st.max_blocks
               for tickets in served for t, st in tickets}
    by_rows = {st.index.codes.shape[0]: t.namespace
               for tickets in served for t, st in tickets}
    check(len(by_rows) == 2, f"the namespaces' CSRs: {by_rows}")
    del served

    # the path's kernels on their last operands: ivf_adc at each rung with
    # (alpha) and without (beta) the staging window, fused_lut at each
    # miss width, the side pass, the GCD step and rotations, beta's build
    rows = {}
    for key in sorted(k for k in seen if k[0] == "ivf_adc"):
        lut, codes, bi, bq, scales, ids = seen.pop(key)
        b = lut.shape[0]
        nm = by_rows[codes.shape[0]]
        npb = bi.numel() // (b * windows[nm])
        tag = f"{nm}_np{npb}"
        errs[f"ivf_adc/serve_{tag}"] = bit_equal(
            ops.ivf_adc(lut, codes, bi, bq, scales, ids, block_size=BS),
            ref.ivf_adc_ref(lut, codes, bi, bq, block_size=BS,
                            scales=scales, ids=ids), f"ivf_adc serve {tag}")
        work = ivf_work(lut, scales, codes, ids, bi, BS)
        rows[f"ivf_adc/{tag}"] = dict(
            namespace=nm, b=b, nprobe=npb, max_blocks=windows[nm],
            S=bi.numel(), live_rows=work["live_rows"],
            ms=graph_ms(lambda: ops.ivf_adc(lut, codes, bi, bq, scales, ids,
                                            block_size=BS), launches=50),
            plain_ms=graph_ms(lambda: ref.ivf_adc_ref(
                lut, codes, bi, bq, block_size=BS, scales=scales, ids=ids),
                launches=5),
            library_ms=graph_ms(ivf_library(lut, codes, bi, bq, BS),
                                launches=20),
            bytes=work["bytes"], flops=work["flops"],
            bound_ms=work["bound_ms"], bound_by=work["bound_by"])
    rel = {}
    widths = []
    for key in sorted(k for k in seen if k[0] == "fused_lut"):
        Qm, qd, cb, colmap = seen.pop(key)[:4]
        widths.append(Qm.shape[0])
        _hold_fused_lut(f"serve_b{Qm.shape[0]}", Qm, qd, cb, colmap, errs,
                        rel, fails)
    args = seen.pop("adc_lookup")
    errs["adc_lookup/serve_side_pass"] = bit_equal(
        ops.adc_lookup(*args), ref.adc_lookup_ref(*args),
        "adc_lookup side pass in serve")
    side_live = int(torch.sum(args[3] >= 0))
    G, Rg = seen.pop("gcd_score")
    got_a = ops.gcd_score(G, Rg)
    errs["gcd_score/serve"] = compare(got_a, ref.gcd_score_ref(G, Rg),
                                      GCD_ATOL, 0.0)
    check(torch.equal(got_a, -got_a.T), "gcd_score serve not antisymmetric")
    for key in [k for k in seen if k[0] == "givens_rotate"]:
        rargs = seen.pop(key)
        errs[f"givens_rotate/serve_{key[1][0]}x{key[1][1]}"] = bit_equal(
            ops.givens_rotate(*rargs), ref.pair_rotate_ref(*rargs),
            f"givens_rotate {key[1]} in serve")
    xa, cba = seen.pop("pq_assign")
    assign_flips = _assign_flips(xa, cba, ops.pq_assign(xa, cba),
                                 ref.pq_assign_ref(xa, cba))
    errs["pq_assign/serve_beta_build"] = assign_flips["max_abs_gap"]
    del seen, args, G, Rg, got_a, xa, cba
    for name in ("ivf_adc", "fused_lut", "adc_lookup", "gcd_score",
                 "givens_rotate", "pq_assign"):
        if not own.get(name):
            fails.append(f"kernel {name} was not launched on the serve path")

    # the result through the BENCH writer, outside the checkout
    with tempfile.TemporaryDirectory() as tmp:
        path = obs.write_bench(tmp, "torch_serve", sections={"serve": results},
                               checks=checks, config=dict(
                                   n=N, dim=DIM, subspaces=D, codewords=K,
                                   num_lists=L, ladder=SERVE_LADDER,
                                   **SERVE_TRAFFIC))
        bench_errs = obs.validate_bench(path)
        emit("serve_bench", path=path, valid=not bench_errs,
             errors=bench_errs)
    if bench_errs:
        fails.append(f"the serve trajectory is invalid: {bench_errs}")

    emit("serve", n=N, dim=DIM, subspaces=D, codewords=K, num_lists=L,
         ladder=SERVE_LADDER, **SERVE_TRAFFIC, build_s=t_build,
         cells_s=t_cells, rate_qps=results["rate_qps"],
         slo_ms=results["slo_ms"], top_ms=results["top_ms"],
         top_ms_samples=results["top_ms_samples"],
         checks=held, timing_checks=timing,
         cells=cells,
         waited_ms=waits, sampled=sampled,
         part_ms={p: dict(_pcts(v), n=len(v), total=sum(v))
                  for p, v in part_ms.items()},
         launches_by_part=got, expected_launches=want,
         build_launches=build_own, lut_miss_widths=widths,
         side_pass_live_rows=side_live, kernels=rows, fused_lut_rel=rel,
         assign_flips=assign_flips, total_s=time.perf_counter() - t_all,
         card=smi, fails=fails)
    check(not fails, "; ".join(fails))
    return errs, own


# -- train ------------------------------------------------------------------


class _StepTimer:
    """CUDA events at the marks of each train step (``make_train_step``'s
    ``marks``: start, forward, backward, adamw, rotation) or decode step
    (``serve_decode``'s)."""

    def __init__(self):
        self.steps = []

    def start(self) -> None:
        self.steps.append([])
        self("start")

    def __call__(self, name: str) -> None:
        import torch

        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.steps[-1].append((name, ev))

    def split_ms(self) -> dict:
        """Median device milliseconds of each part over the steps."""
        import torch

        torch.cuda.synchronize()
        parts: dict[str, list] = {}
        for marks in self.steps:
            for (_, a), (name, b) in zip(marks, marks[1:]):
                parts.setdefault(name, []).append(a.elapsed_time(b))
        self.steps = []
        return {k: statistics.median(v) for k, v in parts.items()}


@contextlib.contextmanager
def _last_call(name: str, into: dict, module=None, by_shape: bool = False,
               key=None):
    """Inside the block, keep a copy of the positional operands of the last
    call of ``module.<name>`` (default: ``kernels.ops``; a class for a
    method, whose first operand is then the instance) in ``into[name]``,
    or with ``by_shape`` the last call at each shape of the first operand
    in ``into[(name, shape)]``, or with ``key`` (a function of the
    operands) the last call at each key in ``into[(name, key)]``; tensors
    and the tensors of a NamedTuple state copied. The call itself goes on
    as before and launches (and counts) as it would."""
    import torch

    from repro_torch.kernels import ops

    module = ops if module is None else module
    real = getattr(module, name)

    def copy(a):
        if torch.is_tensor(a):
            return a.detach().clone()
        if isinstance(a, tuple) and hasattr(a, "_replace"):  # a state
            return type(a)(*map(copy, a))
        return a

    def spy(*args, **kwargs):
        if key is not None:
            at = (name, key(args))
        else:
            at = (name, tuple(args[0].shape)) if by_shape else name
        into[at] = tuple(map(copy, args))
        return real(*args, **kwargs)

    setattr(module, name, spy)
    try:
        yield
    finally:
        setattr(module, name, real)


@contextlib.contextmanager
def _probe_pinned(index_search, lists):
    """Inside the block, ``index_search.probe`` returns ``lists`` (b, p)
    and each one's coarse score from the searched index, in place of that
    index's own top-p: a search then scans exactly these lists."""
    real = index_search.probe

    def pinned(index, QR, nprobe):
        assert lists.shape == (QR.shape[0], nprobe)
        return lists, index_search.coarse_scores(index, QR).gather(1, lists)

    index_search.probe = pinned
    try:
        yield
    finally:
        index_search.probe = real


def _run_steps(step, state, batches, timer: _StepTimer):
    """Drive ``step`` over the batches; losses and host-clock ms per step
    (synchronised before and after)."""
    import torch

    losses, host_ms, last = [], [], None
    for h, pos in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        timer.start()
        state, last = step(state, h, pos)
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(last["loss"]))
    check(all(math.isfinite(v) for v in losses), f"a loss is not finite: "
          f"{losses}")
    return state, losses, host_ms, last


def _launch_delta(before: dict) -> dict:
    from repro_torch.kernels import ops

    return {k: v - before.get(k, 0) for k, v in ops.LAUNCHES.items()
            if v != before.get(k, 0)}


@contextlib.contextmanager
def _counted(into: dict):
    """Add the launches made inside the block to ``into``: a path's own
    calls, apart from the checks that run beside them in its window."""
    from repro_torch.kernels import ops

    before = dict(ops.LAUNCHES)
    yield
    for k, v in _launch_delta(before).items():
        into[k] = into.get(k, 0) + v


def _expect(what: str, got: dict, want: dict) -> None:
    check(got == want, f"{what}: launches {got}, the path implies {want}")


def _evaluate(model, cfg, sample_ids, hist, truth):
    """Fig. 3 distortion on fresh item-tower outputs of the OPQ sample, then
    Table 1: the whole corpus through the item tower and the index layer's
    pq_assign, queries scored by ADC (adc_lookup), p@k / r@k against the
    latent-similarity truth. Returns the metrics, the corpus codes (uint8)
    and the ADC scores."""
    import torch

    from repro_torch.core import index_layer as il
    from repro_torch.models import recsys

    with torch.no_grad():
        R = model.index.R
        v, _ = recsys.item_tower(model, sample_ids, cfg)
        dist = float(il.quantizer(model.index).distortion(v @ R))
        del v
        ids = torch.arange(cfg.item_vocab, device=R.device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vecs = torch.cat([recsys.item_tower(model, ids[s:s + TOWER_CHUNK],
                                            cfg)[0]
                          for s in range(0, cfg.item_vocab, TOWER_CHUNK)])
        vecs /= torch.clamp(torch.linalg.vector_norm(vecs, dim=-1,
                                                     keepdim=True), min=1e-6)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        codes = il.encode(model.index, vecs)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        del vecs
        check(codes.shape == (cfg.item_vocab, cfg.index.num_subspaces)
              and int(codes.min()) >= 0
              and int(codes.max()) < cfg.index.num_codewords, "corpus codes")
        scores = recsys.twotower_retrieve_adc(model, hist, codes, cfg)
        check(bool(torch.all(torch.isfinite(scores))), "non-finite ADC score")
        top = torch.topk(scores, EVAL_K, dim=1).indices
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        hits = (top[:, :, None] == truth[:, None, :]).any(-1).sum(1).double()
    ev = dict(distortion=dist, p_at_50=float(hits.mean()) / EVAL_K,
              r_at_50=float(hits.mean()) / truth.shape[1],
              item_tower_s=t1 - t0, encode_s=t2 - t1, retrieve_s=t3 - t2)
    return ev, codes.to(torch.uint8), scores


def phase_train(smi: str) -> dict:
    import torch

    from repro_torch import device, rotations
    from repro_torch.bench import fig3_table1_e2e as table1
    from repro_torch.configs import paper_twotower
    from repro_torch.configs.base import RECSYS_SHAPES
    from repro_torch.core import index_layer as il
    from repro_torch.data import synthetic
    from repro_torch.kernels import ops
    from repro_torch.models import recsys
    from repro_torch.training import optimizer as opt_lib
    from repro_torch.training import train_state as ts

    cfg = paper_twotower.make_config()
    peaks, counts, secs = {}, {}, {}

    def part(name: str, before: dict) -> None:
        torch.cuda.synchronize()
        peaks[name] = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        counts[name] = _launch_delta(before)

    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t_all = time.perf_counter()
    g = device.generator(SEED + 2)
    log = synthetic.ClickLog(SEED, cfg.item_vocab, dim=CLICK_DIM)
    model = recsys.TwoTower.init(g, cfg._replace(index=None))
    warm_batches = [log.batch(1000 + i, TRAIN_BATCH, cfg.hist_len)
                    for i in range(WARMUP_STEPS)]
    joint_batches = [log.batch(2000 + i, TRAIN_BATCH, cfg.hist_len)
                     for i in range(JOINT_STEPS)]
    hist, truth = log.eval_queries(7, EVAL_QUERIES, cfg.hist_len,
                                   k_truth=EVAL_K)
    secs["data"] = time.perf_counter() - t_all
    part("data", {})

    # 1. warm-up without the index layer: one embedding_bag per step
    ocfg = opt_lib.OptimizerConfig(
        lr=TRAIN_LR, total_steps=JOINT_STEPS, warmup_steps=SCHEDULE_WARMUP,
        rotation=rotations.RotationConfig("gcd_greedy", lr=ROT_LR))
    timer = _StepTimer()
    before = dict(ops.LAUNCHES)
    step = ts.make_train_step(lambda p, h, pos: recsys.twotower_loss(
        p, h, pos, cfg, use_index=False), ocfg, marks=timer)
    _, warm_losses, warm_ms, _ = _run_steps(
        step, ts.init_state(None, model, ocfg), warm_batches, timer)
    warm_split = timer.split_ms()
    part("warmup", before)
    _expect("warm-up", counts["warmup"], {"embedding_bag": WARMUP_STEPS})

    # 2. OPQ warm start of (R, codebooks) on item-tower outputs
    before = dict(ops.LAUNCHES)
    sample_ids = torch.arange(OPQ_SAMPLE, device=g.device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        v, _ = recsys.item_tower(model, sample_ids, cfg)
    model.index = il.warm_start(g, v, cfg.index, opq_iters=OPQ_ITERS,
                                kmeans_iters=1)
    torch.cuda.synchronize()
    secs["opq"] = time.perf_counter() - t0
    opq_X = (v @ model.index.R).detach()
    orth_warm = float(rotations.orthogonality_error(model.index.R.detach()))
    check(orth_warm <= 1e-5, f"OPQ warm-start orthogonality error "
          f"{orth_warm}")
    del v
    part("opq", before)
    # one k-means assign to start, then per iteration the k-means refresh,
    # the Procrustes target and the recorded distortion
    _expect("OPQ", counts["opq"], {"pq_assign": 1 + 3 * OPQ_ITERS})
    start = {k: p.detach().clone()
             for k, p in opt_lib.named_leaves(model).items()}

    # 3. joint steps from the warm start, one row per learner of the
    # paper's Table 1 (fig3_table1_e2e's rows)
    joint_loss = functools.partial(_joint_loss, cfg=cfg)
    runs, ops_ctx = {}, {"rows": {}}
    gcd_step = {"embedding_bag": 1, "pq_assign": 2, "gcd_score": 1,
                "givens_rotate": 1}
    for spec in table1.METHODS:
        with torch.no_grad():
            for k, p in opt_lib.named_leaves(model).items():
                p.copy_(start[k])
        scfg = ocfg._replace(rotation=rotations.RotationConfig(
            spec, lr=table1.ROT_LRS.get(spec, ROT_LR)))
        before = dict(ops.LAUNCHES)
        step = ts.make_train_step(joint_loss, scfg, emit_deltas=True,
                                  marks=timer)
        seen = {}
        with _last_call("gcd_score", seen), \
                _last_call("update", seen, rotations.CayleySGD):
            _, losses, host_ms, last = _run_steps(
                step, ts.init_state(device.generator(SEED + 5), model, scfg),
                joint_batches, timer)
        split = timer.split_ms()
        part(f"joint/{spec}", before)
        # frozen and Cayley-SGD launch neither gcd_score nor givens_rotate
        per_step = (gcd_step if spec.startswith("gcd_")
                    else {"embedding_bag": 1, "pq_assign": 2})
        _expect(f"joint steps, {spec}", counts[f"joint/{spec}"],
                {k: JOINT_STEPS * v for k, v in per_step.items()})
        R = model.index.R.detach()
        moved = float((R - start["index/R"]).abs().max())
        orth = float(rotations.orthogonality_error(R))
        delta = last["rotation_deltas"]["index/R"]
        if spec == "frozen":
            check(torch.equal(R, start["index/R"]),
                  "frozen R differs from the warm start")
        else:
            check(orth <= 1e-5, f"{spec} orthogonality error {orth}")
            check(moved > 0.0, f"{spec} left R at the warm start")
        kind = (rotations.DenseDelta if spec == "cayley_sgd"
                else rotations.GivensDelta)
        check(isinstance(delta, kind), f"{spec} emitted a "
              f"{type(delta).__name__}")
        if spec == "cayley_sgd":
            _, state, grad, lr, _ = seen["update"]
            ops_ctx["cayley_last"] = (state.R, grad, lr)
        if spec.startswith("gcd_"):
            # only a GivensDelta has pairs and angles
            ops_ctx["rows"][spec] = dict(
                R=R.clone(), pi=delta.pi, pj=delta.pj, theta=delta.theta,
                score_G=seen["gcd_score"][0], score_R=seen["gcd_score"][1])
        if spec == "gcd_greedy":
            h, pos = joint_batches[-1]
            check(cfg.scoring == "cosine", "the ADC tables below assume "
                  "cosine scoring")
            with torch.no_grad():
                v, _ = recsys.item_tower(model, pos, cfg)
                # the eval queries' ADC tables, built as
                # recsys.twotower_retrieve_adc builds them (this user-tower
                # pass is outside every part and so not counted)
                u = recsys.user_tower(model, hist, cfg)
                u = u / torch.clamp(torch.linalg.vector_norm(
                    u, dim=-1, keepdim=True), min=1e-6)
                ops_ctx.update(
                    ops_ctx["rows"][spec],
                    assign_X=(v @ R).contiguous(), opq_X=opq_X,
                    codebooks=model.index.codebooks.detach().clone(),
                    table=model.item_table.detach(), hist=h,
                    adc_lut=il.quantizer(model.index).adc_tables(
                        u @ R).contiguous())
            del v, u
        before = dict(ops.LAUNCHES)
        ev, codes, scores = _evaluate(model, cfg, sample_ids, hist, truth)
        part(f"eval/{spec}", before)
        _expect(f"eval, {spec}", counts[f"eval/{spec}"],
                {"pq_assign": 2, "embedding_bag": 1, "adc_lookup": 1})
        if spec == "gcd_greedy":
            ops_ctx.update(corpus_codes=codes, adc_scores=scores)
        del codes, scores
        runs[spec] = dict(losses=losses, step_host_ms=host_ms,
                          step_host_ms_median=statistics.median(host_ms),
                          step_device_ms_median=split,
                          rotation_device_ms_median=split["rotation"],
                          r_moved_max_abs=moved, orthogonality_error=orth,
                          dR_from_warmstart=float(torch.linalg.matrix_norm(
                              R - start["index/R"])),
                          **ev)
    del start
    launches = {}                    # the path's: every part's, summed
    for c in counts.values():
        for k, v in c.items():
            launches[k] = launches.get(k, 0) + v
    emit("train", config=cfg.name, item_vocab=cfg.item_vocab,
         embed_dim=cfg.embed_dim, tower_dims=list(cfg.tower_dims),
         hist_len=cfg.hist_len, index=cfg.index._asdict(),
         batch=TRAIN_BATCH, warmup_steps=WARMUP_STEPS,
         joint_steps=JOINT_STEPS, opq_sample=OPQ_SAMPLE, opq_iters=OPQ_ITERS,
         lr=TRAIN_LR, rotation_lr={spec: table1.ROT_LRS.get(spec, ROT_LR)
                                   for spec in table1.METHODS},
         eval_queries=EVAL_QUERIES,
         warmup=dict(losses=warm_losses, step_host_ms=warm_ms,
                     step_device_ms_median=warm_split),
         warm_start_orthogonality_error=orth_warm,
         runs=runs, seconds=secs, launches=launches,
         launches_by_part=counts, peak_memory_bytes=peaks,
         fig3_checks=table1.checks_of(runs),
         total_s=time.perf_counter() - t_all, card=smi,
         cuts=dict(batch=dict(run=TRAIN_BATCH, config=RECSYS_SHAPES[
                       "train_batch"].params["batch"]),
                   steps=f"{WARMUP_STEPS} warm-up + {JOINT_STEPS} joint",
                   opq_iters=OPQ_ITERS))
    for name in TRAIN_KERNELS:
        check(launches[name] > 0,
              f"kernel {name} was not launched on the train path")
    return dict(launches=launches, model=model, **ops_ctx)


def _joint_loss(p, h, pos, cfg):
    from repro_torch.models import recsys

    return recsys.twotower_loss(p, h, pos, cfg, use_index=True)


# -- train kernels -----------------------------------------------------------


def assign_operands(g, m: int, D: int, K: int, sub: int):
    """Seeded pq_assign operands: X (m, D·sub) of SIFT-like rows, and K
    rows of it as the codebooks (D, K, sub), as k-means starts."""
    import torch

    from repro_torch.data import synthetic

    X = synthetic.sift_like(g, max(m, K), D * sub)
    pick = torch.randperm(X.shape[0], generator=g, device=X.device)[:K]
    C = X[pick].reshape(K, D, sub).transpose(0, 1).contiguous()
    return X[:m].contiguous(), C


def _assign_flips(X, C, got, want) -> dict:
    """pq_assign codes against the plain version's: every differing
    (row, subspace) must be a float32 tie, the two choices' plain scores
    ‖c‖² − 2⟨x, c⟩ (taken in float64) within ASSIGN_GAP of the scale
    ‖x_d‖² + max ‖c‖²."""
    import torch

    flip = got != want
    out = dict(flips=int(flip.sum()), entries=int(flip.numel()),
               max_abs_gap=0.0, max_rel_gap=0.0)
    if out["flips"]:
        r, d = torch.nonzero(flip, as_tuple=True)
        D, _, sub = C.shape
        x = X.view(X.shape[0], D, sub)[r, d].double()
        cg = C[d, got[r, d].long()].double()
        cw = C[d, want[r, d].long()].double()
        sg = (cg * cg).sum(-1) - 2 * (x * cg).sum(-1)
        sw = (cw * cw).sum(-1) - 2 * (x * cw).sum(-1)
        scale = (x * x).sum(-1) + torch.maximum((cg * cg).sum(-1),
                                                (cw * cw).sum(-1))
        out["max_abs_gap"] = float((sg - sw).abs().max())
        out["max_rel_gap"] = float(((sg - sw).abs() / scale).max())
    check(out["max_rel_gap"] <= ASSIGN_GAP,
          f"a pq_assign code differs beyond a float32 tie: {out}")
    return out


def _merge_flips(into: dict, f: dict) -> None:
    """Add one chunk's ``_assign_flips`` to a running total."""
    for key in ("flips", "entries"):
        into[key] = into.get(key, 0) + f[key]
    for key in ("max_abs_gap", "max_rel_gap"):
        into[key] = max(into.get(key, 0.0), f[key])


def _bag_error(got, want, valid_bag) -> float:
    """Max |got − want|, held to BAG_RTOL of max |want|; bags without a
    real entry must be exact zeros."""
    import torch

    check(got.shape == want.shape, "embedding_bag shape")
    check(bool(torch.all(got[~valid_bag] == 0)),
          "a padded or empty bag is not an exact zero")
    err = float((got - want).abs().max())
    rel = err / (float(want.abs().max()) or 1.0)
    check(rel <= BAG_RTOL, f"embedding_bag relative error {rel}")
    return err


def phase_train_kernels(ctx: dict) -> dict:
    """givens_rotate, pq_assign and embedding_bag against their plain
    versions on the train phase's operands, plus ragged shapes."""
    import torch
    import torch.nn.functional as F

    from repro_torch import rotations
    from repro_torch.core import matching
    from repro_torch.kernels import ops, ref
    from repro_torch.rotations import cayley as rot_cayley

    dev = ctx["R"].device
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 3)
    rows, errs, extra = {}, {}, {}

    # givens_rotate: the last GCD step's pairs on R, an odd n with unpaired
    # columns, and the backward on a (16384, 512) X
    R, theta = ctx["R"].contiguous(), ctx["theta"]
    pi, pj = ctx["pi"].int().contiguous(), ctx["pj"].int().contiguous()
    c, s = torch.cos(theta).contiguous(), torch.sin(theta).contiguous()
    n, p = R.shape[1], pi.numel()
    cases = {"R": (R, pi, pj, c, s)}
    perm = torch.randperm(513, generator=g, device=dev)
    th = 0.1 * torch.randn(200, generator=g, device=dev)
    cases["odd_n"] = (torch.randn((1000, 513), generator=g, device=dev),
                      perm[:200].int().contiguous(),
                      perm[200:400].int().contiguous(),
                      torch.cos(th), torch.sin(th))
    # the plan's edges at the serving width: (8192, 256) (the codebook
    # rows' shape, 16-row runs), a last run cut short (8197 rows), fewer
    # rows than that run (15), and X at an address that is not 16-byte
    # aligned (4-byte copies)
    mc, nc = rotate_cases()["codebook_rows"]
    perm = torch.randperm(nc, generator=g, device=dev)
    th = 0.1 * torch.randn(nc // 2, generator=g, device=dev)
    pairs = (perm[:nc // 2].int().contiguous(),
             perm[nc // 2:].int().contiguous(), torch.cos(th), torch.sin(th))
    for name, m in (("rows_8192", mc), ("ragged_run", mc + 5),
                    ("rows_15", 15)):
        cases[name] = (torch.randn((m, nc), generator=g, device=dev),
                       *pairs)
    spill = torch.randn(100 * nc + 1, generator=g, device=dev)
    cases["unaligned_x"] = (spill[1:].view(100, nc), *pairs)
    for name, args in cases.items():
        got = ops.givens_rotate(*args)
        want = ref.pair_rotate_ref(*args)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"givens_rotate {name} is not "
              "bit-equal to its plain version")
        errs[f"givens_rotate/{name}"] = 0.0
    Xb = torch.randn((TRAIN_BATCH, n), generator=g,
                     device=dev).requires_grad_(True)
    tb = theta.clone().requires_grad_(True)
    dY = torch.randn((TRAIN_BATCH, n), generator=g, device=dev)
    a = torch.autograd.grad(ops.apply_pair_rotations(Xb, pi, pj, tb),
                            (Xb, tb), dY)
    b = torch.autograd.grad(ref.apply_pair_rotations_ref(Xb, pi, pj, tb),
                            (Xb, tb), dY)
    check(torch.equal(a[0], b[0]), "givens_rotate backward dX is not "
          "bit-equal to autograd of the plain version")
    dth = float((a[1] - b[1]).abs().max()) / float(b[1].abs().max())
    check(dth <= DTHETA_RTOL, f"givens_rotate dθ relative error {dth}")
    errs["givens_rotate/backward_dX"] = 0.0
    extra["givens_rotate"] = dict(backward_dtheta_rel=dth)
    Xd = Xb.detach()
    k_ms = graph_ms(lambda: ops.givens_rotate(R, pi, pj, c, s), launches=100)
    p_ms = graph_ms(lambda: ref.pair_rotate_ref(R, pi, pj, c, s),
                    launches=100)
    # the library yardstick: one matmul by the dense Δ, built outside
    delta = ref.pair_rotate_ref(torch.eye(n, device=dev), pi, pj, c, s)
    check(torch.allclose(R @ delta, ref.pair_rotate_ref(R, pi, pj, c, s),
                         atol=1e-6), "library yardstick computes another "
          "function")
    lib_ms = graph_ms(lambda: torch.matmul(R, delta), launches=100)
    extra["givens_rotate"].update(
        ms_16384=graph_ms(lambda: ops.givens_rotate(Xd, pi, pj, c, s),
                          launches=20),
        library_ms_16384=graph_ms(lambda: torch.matmul(Xd, delta),
                                  launches=20))
    m = R.shape[0]
    nbytes = 2 * m * n * 4 + 4 * p * 4
    flops = 6 * m * p
    rows["givens_rotate"] = dict(
        shape=dict(m=m, n=n, pairs=p), ms=k_ms, plain_ms=p_ms, bytes=nbytes,
        flops=flops, **_bound(nbytes, flops), library_ms=lib_ms)
    del Xb, Xd, dY, a, b

    # pq_assign: a joint step's XR, the OPQ sample's XR, an m and a K that
    # are not multiples of a tile, one row; the coarse-VQ shape and the
    # bodies' edges on seeded operands (ASSIGN_SHAPES)
    C = ctx["codebooks"].contiguous()
    assign_cases = {
        "joint_step": (ctx["assign_X"], C),
        "opq_sample": (ctx["opq_X"].contiguous(), C),
        "ragged_m_K": (ctx["assign_X"][:1001].contiguous(),
                       C[:, :200].contiguous()),
        "one_row": (ctx["assign_X"][:1].contiguous(), C),
    }
    for name in ("coarse_vq", "sub16", "sub17", "sub3036", "sub3040",
                 "sub3041"):
        assign_cases[name] = assign_operands(g, *ASSIGN_SHAPES[name])
    flips = {}
    for name, (X, Cb) in assign_cases.items():
        check((X.shape[0], *Cb.shape) == ASSIGN_SHAPES[name],
              f"pq_assign {name}: shape {(X.shape[0], *Cb.shape)}")
        got = ops.pq_assign(X, Cb)
        want = ref.pq_assign_ref(X, Cb)
        torch.cuda.synchronize()
        flips[name] = _assign_flips(X, Cb, got, want)
        errs[f"pq_assign/{name}"] = flips[name]["max_abs_gap"]
        del got, want
    X = ctx["assign_X"]
    mq, nq = X.shape
    D, K, sub = C.shape
    k_ms = graph_ms(lambda: ops.pq_assign(X, C), launches=20)
    p_ms = graph_ms(lambda: ref.pq_assign_ref(X, C), launches=2)
    Xc, Cc = assign_cases["coarse_vq"]
    c_ms = graph_ms(lambda: ops.pq_assign(Xc, Cc), launches=5)
    extra["pq_assign"] = dict(flips=flips, ms_coarse_vq=c_ms)
    for name, (X_, C_) in assign_cases.items():
        if name not in ("coarse_vq", "joint_step"):
            extra["pq_assign"][f"ms_{name}"] = graph_ms(
                lambda: ops.pq_assign(X_, C_), launches=20)
    nbytes = mq * nq * 4 + D * K * sub * 4 + mq * D * 4
    flops = 2 * mq * nq * K
    rows["pq_assign"] = dict(
        shape=dict(m=mq, n=nq, D=D, K=K, sub=sub), ms=k_ms, plain_ms=p_ms,
        bytes=nbytes, flops=flops, **_bound(nbytes, flops), library_ms=None)
    # the coarse quantizer's shape, the tiled body, as a row of its own
    mc, nc = Xc.shape
    Dc, Kc, subc = Cc.shape
    nbytes = mc * nc * 4 + Dc * Kc * subc * 4 + mc * Dc * 4
    flops = 2 * mc * nc * Kc
    rows["pq_assign_coarse_vq"] = dict(
        shape=dict(m=mc, n=nc, D=Dc, K=Kc, sub=subc), ms=c_ms,
        plain_ms=graph_ms(lambda: ref.pq_assign_ref(Xc, Cc), launches=2),
        bytes=nbytes, flops=flops, **_bound(nbytes, flops), library_ms=None,
        max_abs_err=flips["coarse_vq"]["max_abs_gap"])
    del Xc, Cc, assign_cases

    # embedding_bag: the last joint batch's histories over the item table,
    # then weights, extra padding and empty bags
    table, hist = ctx["table"], ctx["hist"]
    B, Lh = hist.shape
    idx = hist.reshape(-1).contiguous()
    bag = torch.arange(B, dtype=torch.int32, device=dev).repeat_interleave(Lh)
    got = ops.embedding_bag(table, idx, bag, B)
    want = ref.embedding_bag_ref(table, idx, bag, B)
    torch.cuda.synchronize()
    has = (hist >= 0).any(1)
    errs["embedding_bag/main"] = _bag_error(got, want, has)
    idx2 = torch.where(torch.rand(idx.shape, generator=g, device=dev) < 0.2,
                       -1, idx).int()
    bag2 = 2 * bag                           # odd bags have no entries
    idx2[bag2 == 6] = -1                     # bag 6: entries, all padding
    w = torch.randn(idx.shape, generator=g, device=dev)
    got = ops.embedding_bag(table, idx2, bag2, 2 * B + 1, w)
    want = ref.embedding_bag_ref(table, idx2, bag2, 2 * B + 1, w)
    torch.cuda.synchronize()
    has2 = torch.zeros(2 * B + 1, dtype=torch.bool, device=dev)
    has2[bag2[idx2 >= 0].long()] = True
    errs["embedding_bag/weighted_padded_empty"] = _bag_error(got, want, has2)
    del got, want
    k_ms = graph_ms(lambda: ops.embedding_bag(table, idx, bag, B),
                    launches=20)
    p_ms = graph_ms(lambda: ref.embedding_bag_ref(table, idx, bag, B),
                    launches=2)
    # the library yardstick: F.embedding_bag over the unpadded entries with
    # their offsets, built outside the timed call
    keep = idx >= 0
    lib_idx = idx[keep].long()
    offsets = torch.searchsorted(bag[keep].contiguous(),
                                 torch.arange(B, dtype=torch.int32,
                                              device=dev)).long()
    lib = functools.partial(F.embedding_bag, lib_idx, table, offsets,
                            mode="sum")
    check(torch.allclose(lib(), ref.embedding_bag_ref(table, idx, bag, B),
                         atol=1e-6), "library yardstick computes another "
          "function")
    lib_ms = graph_ms(lib, launches=5)
    w_keep = w[keep].contiguous()
    extra["embedding_bag"] = dict(
        weighted_ms=graph_ms(lambda: ops.embedding_bag(table, idx, bag, B, w),
                             launches=20),
        weighted_library_ms=graph_ms(functools.partial(
            F.embedding_bag, lib_idx, table, offsets, mode="sum",
            per_sample_weights=w_keep), launches=5))
    valid = int(keep.sum())
    unique_rows = int(torch.unique(lib_idx).numel())
    nbytes = unique_rows * table.shape[1] * 4 + idx.numel() * 8 \
        + B * table.shape[1] * 4
    flops = valid * table.shape[1]
    rows["embedding_bag"] = dict(
        shape=dict(V=table.shape[0], dim=table.shape[1], bags=B,
                   entries=idx.numel(), valid=valid, unique_rows=unique_rows),
        ms=k_ms, plain_ms=p_ms, bytes=nbytes, flops=flops,
        **_bound(nbytes, flops), library_ms=lib_ms)

    # adc_lookup: the eval retrieval's own tables (256, 64, 256), a 64 KiB
    # float32 row past the default 48 KiB of shared memory, over the whole
    # encoded corpus; first the tables are shown to be the path's
    lut, corpus = ctx["adc_lut"], ctx["corpus_codes"]
    got = ops.adc_lookup(lut, corpus)
    compare(got, ctx["adc_scores"], ATOL, RTOL)
    want = ref.adc_lookup_ref(lut, corpus)
    errs["adc_lookup/train_corpus"] = bit_equal(got, want,
                                                "adc_lookup train corpus")
    del got, want
    extra["adc_lookup"] = dict(
        shape=dict(b=lut.shape[0], Dp=lut.shape[1], K=lut.shape[2],
                   N=corpus.shape[0]),
        ms=graph_ms(lambda: ops.adc_lookup(lut, corpus), launches=5))

    # gcd_score: the last GCD step's (G, R) at n = 512
    G, Rs = ctx["score_G"], ctx["score_R"]
    got = ops.gcd_score(G, Rs)
    want = ref.gcd_score_ref(G, Rs)
    torch.cuda.synchronize()
    n = G.shape[0]
    errs[f"gcd_score/train_n={n}"] = compare(got, want, GCD_ATOL, 0.0)
    check(torch.equal(got, -got.T), f"gcd_score n={n} not antisymmetric")
    lhs = torch.cat([G, -Rs], dim=0).T.contiguous()          # (n, 2n)
    rhs = torch.cat([Rs, G], dim=0).contiguous()             # (2n, n)
    check(torch.allclose(torch.matmul(lhs, rhs), want, atol=GCD_ATOL),
          "library yardstick computes another function")
    flops, nbytes = 2 * n ** 3 + n * n, 3 * n * n * 4
    extra["gcd_score"] = dict(
        n=n, ms=graph_ms(lambda: ops.gcd_score(G, Rs), launches=100),
        plain_ms=graph_ms(lambda: ref.gcd_score_ref(G, Rs), launches=100),
        library_ms=graph_ms(lambda: torch.matmul(lhs, rhs), launches=100),
        bytes=nbytes, flops=flops, **_bound(nbytes, flops))

    # the GCD-R and GCD-S rows' last step: gcd_score on their (G, R),
    # givens_rotate on their R by their delta; GCD-S's pairs are the 2-opt
    # refinement of that A's greedy matching, a perfect matching at least
    # as heavy
    for spec, row in ctx["rows"].items():
        if spec == "gcd_greedy":
            continue
        G, Rs = row["score_G"], row["score_R"]
        A = ops.gcd_score(G, Rs)
        want = ref.gcd_score_ref(G, Rs)
        torch.cuda.synchronize()
        errs[f"gcd_score/{spec}"] = compare(A, want, GCD_ATOL, 0.0)
        check(torch.equal(A, -A.T), f"gcd_score {spec} not antisymmetric")
        Rr = row["R"].contiguous()
        pi, pj = row["pi"].int().contiguous(), row["pj"].int().contiguous()
        c, s = torch.cos(row["theta"]), torch.sin(row["theta"])
        got = ops.givens_rotate(Rr, pi, pj, c, s)
        torch.cuda.synchronize()
        check(torch.equal(got, ref.pair_rotate_ref(Rr, pi, pj, c, s)),
              f"givens_rotate {spec} is not bit-equal to its plain version")
        errs[f"givens_rotate/{spec}"] = 0.0
        n = A.shape[0]
        check(sorted(torch.cat([pi, pj]).tolist()) == list(range(n)),
              f"{spec}: the delta's pairs are not a perfect matching")
        if spec == "gcd_steepest":
            gpi, gpj = matching.greedy_matching_fast(A)
            spi, spj = matching.steepest_matching(A)
            check(torch.equal(spi.int(), pi) and torch.equal(spj.int(), pj),
                  "gcd_steepest: the step's pairs are not the 2-opt "
                  "refinement of its A")
            w_g = float(matching.matching_weight(A, gpi, gpj))
            w_s = float(matching.matching_weight(A, spi, spj))
            check(w_s >= w_g, f"2-opt weight {w_s} below greedy's {w_g}")
            # one event pair around each call: the host's launches and the
            # greedy scan's copy to the host are part of what a step pays
            extra["two_opt"] = dict(
                greedy_ms=time_ms(lambda: matching.greedy_matching_fast(A),
                                  reps=10, flush=False),
                two_opt_ms=time_ms(lambda: matching.two_opt_refine(
                    A, gpi, gpj), reps=10, flush=False),
                greedy_weight=w_g, steepest_weight=w_s,
                pairs_changed=len(
                    {tuple(sorted(q)) for q in zip(spi.tolist(),
                                                   spj.tolist())}
                    - {tuple(sorted(q)) for q in zip(gpi.tolist(),
                                                     gpj.tolist())}))

    # Cayley-SGD's last step of the train path (its solves are
    # torch.linalg.solve, cuSOLVER on the card) against the same step on
    # the CPU from the same (R, G): at the path's lr, where Δ − I is of
    # order 1e-6, R_new and Δ within CAYLEY_ATOL; and at the lr that makes
    # max |Δ − I| CAYLEY_MOVE, the card's Δ and R_new within CAYLEY_RTOL of
    # how far they moved from the same step in float64 (a Δ = I, or a
    # pull-back off by a factor, misses by all of it); the CPU's float32
    # step's error beside it
    R0, G0, lr = ctx["cayley_last"]
    learner = rotations.make("cayley_sgd")
    R64, G64 = R0.cpu().double(), G0.cpu().double()
    eye = torch.eye(R0.shape[0], dtype=torch.float64)

    def cayley_step(lr_):
        st, d = learner.update(learner.init_from(R0), G0, lr_)
        st_c, d_c = learner.update(learner.init_from(R0.cpu()), G0.cpu(),
                                   lr_)
        _, vjp = torch.func.vjp(lambda q: R64 @ rot_cayley.cayley(q),
                                torch.zeros_like(R64))
        d64 = rot_cayley.cayley(-lr_ * vjp(G64)[0])
        torch.cuda.synchronize()

        def err(a, b):
            return float((a.cpu().double() - b).abs().max())

        return dict(
            lr=lr_, delta_move=err(d64, eye), R_move=err(R64 @ d64, R64),
            delta_err=err(d.dR, d64), R_err=err(st.R, R64 @ d64),
            cpu_delta_err=err(d_c.dR, d64), cpu_R_err=err(st_c.R, R64 @ d64),
            card_vs_cpu=max(err(d.dR, d_c.dR.double()),
                            err(st.R, st_c.R.double())),
            orthogonality_error=float(rotations.orthogonality_error(st.R)),
            cpu_orthogonality_error=float(rotations.orthogonality_error(
                st_c.R)))

    path = cayley_step(lr)
    check(path["card_vs_cpu"] <= CAYLEY_ATOL,
          f"Cayley-SGD's step on the card is not the CPU's: {path}")
    moved = cayley_step(lr * CAYLEY_MOVE / path["delta_move"])
    check(moved["delta_err"] <= CAYLEY_RTOL * moved["delta_move"]
          and moved["R_err"] <= CAYLEY_RTOL * moved["R_move"],
          f"Cayley-SGD's moved step on the card is not float64's: {moved}")
    errs["cayley_sgd/card_vs_cpu"] = path["card_vs_cpu"]
    extra["cayley_sgd"] = dict(
        n=R0.shape[0], path_lr=path, moved_lr=moved, update_ms=time_ms(
            lambda: learner.update(learner.init_from(R0), G0, lr), reps=10,
            flush=False))

    for name in rows:
        if "max_abs_err" not in rows[name]:
            rows[name]["max_abs_err"] = max(v for key, v in errs.items()
                                            if key.startswith(name + "/"))
    emit("train_kernels", max_abs_err=errs, kernels=rows, extra=extra,
         launches=ctx["launches"], card=torch.cuda.get_device_name(0))
    return rows, errs


# -- table1 -----------------------------------------------------------------


def phase_table1(smi: str) -> tuple[dict, dict]:
    """The port's fig3_table1_e2e at the JAX script's default sizes on the
    card (deterministic algorithms, so a seed gives one answer); the checks
    in TABLE1_HELD are held, the others reported. Each of the path's five
    kernels is then held against its plain version on the operands of its
    last call in the run (n = 64, make_smoke's D = 8 and K = 32, 1,024
    items). Returns the path's own launches, checked against what its steps
    imply, and the kernels' errors."""
    import torch

    from repro_torch.bench import fig3_table1_e2e as table1
    from repro_torch.configs import paper_twotower
    from repro_torch.kernels import ops, ref

    sizes = TABLE1_SIZES
    own, seen = {}, {}
    names = ("embedding_bag", "pq_assign", "gcd_score", "givens_rotate",
             "adc_lookup")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.ExitStack() as spies:
        for name in names:
            spies.enter_context(_last_call(name, seen))
        with _counted(own):
            results, checks = table1.run(verbose=False, **sizes)
            torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    rows, steps = len(table1.METHODS), sizes["steps"]
    gcd_rows = len(table1.GCD_ROWS)
    # warm-up: a bag a step; OPQ: 1 + 3 an iteration; a joint step: a bag
    # and 2 assigns, and for GCD a score and a rotate; each row's eval: 2
    # assigns, a bag, a flat scan
    want = dict(embedding_bag=sizes["warmup"] + rows * (steps + 1),
                pq_assign=1 + 3 * table1.OPQ_ITERS + rows * (2 * steps + 2),
                gcd_score=gcd_rows * steps, givens_rotate=gcd_rows * steps,
                adc_lookup=rows)

    # the five kernels on their last operands of the run
    errs = {}
    G, R = seen["gcd_score"]
    got = ops.gcd_score(G, R)
    torch.cuda.synchronize()
    errs["gcd_score/table1"] = compare(got, ref.gcd_score_ref(G, R),
                                       GCD_ATOL, 0.0)
    check(torch.equal(got, -got.T), "gcd_score table1 not antisymmetric")
    args = seen["givens_rotate"]
    check(torch.equal(ops.givens_rotate(*args), ref.pair_rotate_ref(*args)),
          "givens_rotate table1 is not bit-equal to its plain version")
    errs["givens_rotate/table1"] = 0.0
    X, C = seen["pq_assign"]
    flips = _assign_flips(X, C, ops.pq_assign(X, C), ref.pq_assign_ref(X, C))
    errs["pq_assign/table1"] = flips["max_abs_gap"]
    table, idx, bag, num_bags = seen["embedding_bag"]
    has = torch.zeros(num_bags, dtype=torch.bool, device=table.device)
    has[bag[idx >= 0].long()] = True
    errs["embedding_bag/table1"] = _bag_error(
        ops.embedding_bag(table, idx, bag, num_bags),
        ref.embedding_bag_ref(table, idx, bag, num_bags), has)
    lut, codes = seen["adc_lookup"]
    errs["adc_lookup/table1"] = bit_equal(
        ops.adc_lookup(lut, codes), ref.adc_lookup_ref(lut, codes),
        "adc_lookup table1")
    shapes = dict(gcd_score=tuple(G.shape),
                  givens_rotate=(tuple(args[0].shape), args[1].numel()),
                  pq_assign=(tuple(X.shape), tuple(C.shape)),
                  embedding_bag=(tuple(table.shape), idx.numel(), num_bags),
                  adc_lookup=(tuple(lut.shape), tuple(codes.shape)))
    del seen

    emit("table1", config=paper_twotower.make_smoke().name, **sizes,
         rows=results, checks=checks, held=TABLE1_HELD,
         margins=table1.margins_of(results), seconds=seconds, launches=own,
         max_abs_err=errs, kernel_shapes=shapes, pq_assign_flips=flips,
         card=smi)
    _expect("table1", own, want)
    failed = [k for k in TABLE1_HELD if not checks[k]]
    check(not failed, f"fig3/Table 1 checks failed at the JAX script's "
          f"default sizes: {failed}")
    return own, errs


# -- fig4 and fig2 -----------------------------------------------------------


def _hold_rotation_kernels(phase: str, seen: dict, errs: dict) -> dict:
    """gcd_score, givens_rotate and pq_assign against their plain versions
    on the operands of the last call at each shape a phase launched them
    at (``_last_call(..., by_shape=True)``): gcd_score within GCD_ATOL and
    bit-antisymmetric, givens_rotate bit for bit, pq_assign's flips all
    float32 ties. Returns the shapes held, by kernel, and pq_assign's
    flips."""
    import torch

    from repro_torch.kernels import ops, ref

    shapes, flips = {}, {}
    for (name, shape), args in sorted(seen.items()):
        tag = f"{name}/{phase}_{'x'.join(map(str, shape))}"
        if name == "gcd_score":
            got = ops.gcd_score(*args)
            torch.cuda.synchronize()
            errs[tag] = compare(got, ref.gcd_score_ref(*args), GCD_ATOL, 0.0)
            check(torch.equal(got, -got.T), f"{tag} not antisymmetric")
        elif name == "givens_rotate":
            check(torch.equal(ops.givens_rotate(*args),
                              ref.pair_rotate_ref(*args)),
                  f"{tag} is not bit-equal to its plain version")
            errs[tag] = 0.0
        else:
            X, C = args
            f = _assign_flips(X, C, ops.pq_assign(X, C),
                              ref.pq_assign_ref(X, C))
            errs[tag] = f["max_abs_gap"]
            flips[tag] = f
        shapes.setdefault(name, []).append(list(shape))
    return dict(shapes=shapes, pq_assign_flips=flips)


def phase_fig4(smi: str) -> tuple[dict, dict]:
    """The port's fig4_runtime.run() at the JAX script's dims: every
    learner's update at batch 1 (wall and CUDA-event µs), the two greedy
    matchings and the Procrustes solve; both checks held, every learner's
    R orthogonal to 1e-5 after its timed calls (Cayley-SGD to CAYLEY_RTOL
    of how far it moved R), the launches its calls imply checked, and
    gcd_score and givens_rotate held on the last operands of each n.
    Then GCD-R's step at n = 512 split into its parts (outside the path's
    count). Returns the path's own launches and the kernels' errors."""
    import torch

    from repro_torch.bench import fig4_runtime as fig4

    own, seen, detail = {}, {}, {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.ExitStack() as spies:
        for name in ("gcd_score", "givens_rotate"):
            spies.enter_context(_last_call(name, seen, by_shape=True))
        with _counted(own):
            out, checks = fig4.run(verbose=False, detail=detail)
            torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    # every timed function is called 2 + 5 times an n; the GCD family
    # scores once a call, and its disjoint members rotate R once
    calls = 7 * len(fig4.DIMS)
    gcd = [s for s in fig4.SWEEP if s.startswith("gcd_")
           or s == "subspace_gcd"]
    want = dict(gcd_score=calls * len(gcd),
                givens_rotate=calls * sum("overlap" not in s for s in gcd))
    bad = {}
    for n, errs_n in detail["orth_err"].items():
        for spec, err in errs_n.items():
            limit = (CAYLEY_RTOL * detail["move"][n][spec]
                     if spec == "cayley_sgd" else 1e-5)
            if not err <= limit:
                bad[f"{spec}@{n}"] = (err, limit)
    errs = {}
    held = _hold_rotation_kernels("fig4", seen, errs)
    del seen
    top = max(fig4.DIMS)
    split = fig4.gcd_random_split(top)
    emit("fig4", dims=list(fig4.DIMS), lr=fig4.LR, wall_us=out,
         device_us=detail["device_us"], orth_err=detail["orth_err"],
         move=detail["move"], checks=checks,
         svd_update_over_gcd_r=out[top]["procrustes"]
         / out[top]["gcd_random"],
         cayley_over_gcd_r=out[top]["cayley_sgd"] / out[top]["gcd_random"],
         gcd_random_split=split,
         seconds=seconds, launches=own, max_abs_err=errs, kernels=held,
         card=smi)
    _expect("fig4", own, want)
    check(not bad, f"fig4: R off orthogonal after the timed calls: {bad}")
    failed = [k for k, ok in checks.items() if not ok]
    check(not failed, f"fig4 checks failed: {failed}")
    return own, errs


def phase_fig2(smi: str) -> tuple[dict, dict]:
    """The port's fig2a_convergence.run() and fig2bc_stability.run() at
    the JAX scripts' defaults and seeds, under deterministic algorithms.
    Held: every trace finite, every final R orthogonal to 1e-4, the frozen
    R the identity, the launches the OPQ loops imply, and gcd_score,
    givens_rotate and pq_assign on the last operands of each shape.
    Reported, not held (the JAX scripts only report them): the six fig2a
    checks and gcd_more_stable, each with its margin."""
    import numpy as np
    import torch

    from repro_torch.bench import fig2a_convergence as fig2a
    from repro_torch.bench import fig2bc_stability as fig2bc

    own, seen = {}, {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.ExitStack() as spies:
        for name in ("gcd_score", "givens_rotate", "pq_assign"):
            spies.enter_context(_last_call(name, seen, by_shape=True))
        with _counted(own):
            ra, checks_a = fig2a.run(verbose=False)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            rb, stable = fig2bc.run(verbose=False)
            torch.cuda.synchronize()
    t2 = time.perf_counter()

    # launches: an OPQ loop of `it` iterations assigns once for its k-means
    # init, then each iteration once for the k-means refresh, once for the
    # distortion, and once (procrustes) or once an inner step (gradient
    # learners) for the rotation step; a GCD inner step scores once, and
    # rotates R once unless its pairs overlap
    def loop(spec, it, inner):
        step = (1 if spec == "procrustes" else 0 if spec == "frozen"
                else inner)
        gcd = spec.startswith("gcd_")
        return dict(pq_assign=1 + it * (2 + step),
                    gcd_score=it * inner if gcd else 0,
                    givens_rotate=(it * inner if gcd and "overlap" not in spec
                                   else 0))

    want = {}
    runs = [(s, 25, 5) for s in fig2a.SOLVERS] + [
        (s, 20, 5) for _ in fig2bc.FRACTIONS for _ in range(5)
        for s in fig2bc.SOLVERS]
    for spec, it, inner in runs:
        for k, v in loop(spec, it, inner).items():
            want[k] = want.get(k, 0) + v
    bad = []
    for s, r in ra.items():
        if not np.all(np.isfinite(r["trace"])):
            bad.append(f"fig2a {s}: trace not finite")
        if not r["orth_err"] <= 1e-4:
            bad.append(f"fig2a {s}: R off orthogonal by {r['orth_err']}")
    if ra["frozen"]["dR_from_identity"] != 0.0:
        bad.append("fig2a frozen: R moved")
    for frac, stats in rb.items():
        for s, st in stats.items():
            if not st["finite"]:
                bad.append(f"fig2bc {frac} {s}: a trace not finite")
            if not st["orth_err"] <= 1e-4:
                bad.append(f"fig2bc {frac} {s}: R off orthogonal by "
                           f"{st['orth_err']}")
    errs = {}
    held = _hold_rotation_kernels("fig2", seen, errs)
    del seen
    emit("fig2", fig2a=dict(
        final={s: r["final"] for s, r in ra.items()},
        us_per_iter={s: r["us_per_iter"] for s, r in ra.items()},
        orth_err={s: r["orth_err"] for s, r in ra.items()},
        checks=checks_a, margins=fig2a.margins_of(ra), seconds=t1 - t0),
         fig2bc=dict(stats={str(f): v for f, v in rb.items()},
                     checks={"gcd_more_stable": stable},
                     margins={"gcd_more_stable": fig2bc.margin_of(rb)},
                     seconds=t2 - t1),
         seconds=t2 - t0, launches=own, max_abs_err=errs, kernels=held,
         card=smi)
    _expect("fig2", own, want)
    check(not bad, "; ".join(bad))
    return own, errs


# -- decode -----------------------------------------------------------------


def _fit_codebooks(g, params, cache, cfg) -> None:
    """Per layer, PQ.fit on the prompt's K·R and V·R (R from init) in
    place of the init's random codebooks."""
    import torch

    from repro_torch import quant

    kvq, hd = params["kvq"], cfg.head_dim
    for layer in range(cfg.num_layers):
        for x, rot, cb in ((cache.k, "rot_k", "cb_k"),
                           (cache.v, "rot_v", "cb_v")):
            X = x[layer].reshape(-1, hd).float() @ kvq[rot][layer].float()
            pq, _ = quant.PQ.fit(g, X, cfg.kv_quant.pq_cfg, iters=FIT_ITERS)
            with torch.no_grad():
                kvq[cb][layer] = pq.codebooks.to(kvq[cb].dtype)


def _tile_prompt_codes(cache, prompt_len: int, length: int):
    """Fill positions prompt_len … length−1 of both code tensors by tiling
    the prompt's own codes; return the cache with ``length`` set."""
    import torch

    for codes in (cache.k_codes, cache.v_codes):
        for s0 in range(prompt_len, length, prompt_len):
            n = min(prompt_len, length - s0)
            codes[:, :, :, s0:s0 + n] = codes[:, :, :, :n]
    return cache._replace(length=torch.full_like(cache.length, length))


def _decode_layer_split(params, cache, cfg, token) -> dict:
    """Median device milliseconds of each part of a layer's decode step
    (``serve_decode``'s ``marks``, a CUDA event each), over every layer of
    SPLIT_REPS steps at the cache's full length; "head" is the final norm
    and logits, once a step. Each step writes the cache's last position
    again."""
    from repro_torch.models import transformer as tfm

    last = cache._replace(length=cache.length - 1)
    timer = _StepTimer()
    for _ in range(SPLIT_REPS):
        timer.start()
        tfm.serve_decode(params, token, last, cfg, marks=timer)
    return timer.split_ms()


def phase_decode(smi: str) -> dict:
    import numpy as np
    import torch

    from repro_torch import configs, device
    from repro_torch.core import kv_quant
    from repro_torch.kernels import ops
    from repro_torch.models import layers
    from repro_torch.models import transformer as tfm

    spec = configs.get(DECODE_ARCH)
    cfg = spec.config_for_shape(DECODE_SHAPE)
    dense_cfg = cfg._replace(kv_quant=None)
    shape = spec.shapes[DECODE_SHAPE].params
    S, B, L = shape["seq_len"], shape["global_batch"], cfg.num_layers
    check(shape.get("pq_cache") and cfg.kv_quant is not None,
          f"{DECODE_SHAPE} does not switch the PQ cache on")
    peaks, counts, secs = {}, {}, {}

    def part(name: str, before: dict) -> None:
        torch.cuda.synchronize()
        peaks[name] = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        counts[name] = _launch_delta(before)

    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t_all = time.perf_counter()
    g = device.generator(SEED + 4)
    params = tfm.init_params(g, cfg)
    prompt = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (B, PROMPT_LEN))).to(params["embed"].device)
    secs["init"] = time.perf_counter() - t_all
    part("init", {})

    with torch.no_grad():
        # 1. the prompt through a dense cache: each layer's K and V
        before = dict(ops.LAUNCHES)
        t0 = time.perf_counter()
        dense_logits, dcache = tfm.serve_prefill(params, prompt, dense_cfg)
        torch.cuda.synchronize()
        secs["prefill_dense"] = time.perf_counter() - t0
        part("prefill_dense", before)
        _expect("dense prefill", counts["prefill_dense"], {})

        # 2. the codebooks, fitted per layer on the prompt's K·R and V·R
        before = dict(ops.LAUNCHES)
        t0 = time.perf_counter()
        _fit_codebooks(g, params, dcache, cfg)
        torch.cuda.synchronize()
        secs["fit"] = time.perf_counter() - t0
        del dcache
        part("fit", before)
        _expect("codebook fit", counts["fit"],
                {"pq_assign": 2 * L * FIT_ITERS})

        # 3. the PQ prefill into a cache of S positions, then the tiling
        before = dict(ops.LAUNCHES)
        t0 = time.perf_counter()
        logits, cache = tfm.serve_prefill(params, prompt, cfg, max_len=S)
        torch.cuda.synchronize()
        secs["prefill"] = time.perf_counter() - t0
        check(torch.equal(logits, dense_logits), "the PQ prefill's logits "
              "differ from the dense prefill's (its attention is dense)")
        cache = _tile_prompt_codes(cache, PROMPT_LEN, S - DECODE_TOKENS)
        part("prefill", before)
        _expect("PQ prefill", counts["prefill"], {"pq_assign": 2 * L})
        cache_ptrs = [t.data_ptr() for t in cache[:2]]

        # 4. greedy decode: the last token attends over all S positions
        before = dict(ops.LAUNCHES)
        tok = logits.argmax(-1)
        host_ms, out_tokens, seen = [], [], {}
        for i in range(DECODE_TOKENS):
            with contextlib.ExitStack() as spies:
                if i == DECODE_TOKENS - 1:   # the last layer's operands
                    spies.enter_context(_last_call("adc_batch", seen))
                    spies.enter_context(_last_call("pq_assign", seen))
                    spies.enter_context(_last_call(
                        "adc_decode_attention", seen, module=kv_quant))
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits, cache = tfm.serve_decode(params, tok, cache, cfg)
                torch.cuda.synchronize()
            host_ms.append((time.perf_counter() - t0) * 1e3)
            check(bool(torch.isfinite(logits).all()) and logits.shape
                  == (B, cfg.vocab_size), f"decode step {i}: logits")
            tok = logits.argmax(-1)
            out_tokens.append(int(tok[0]))
        part("decode", before)
        _expect("decode", counts["decode"],
                {"adc_batch": L * DECODE_TOKENS,
                 "pq_assign": 2 * L * DECODE_TOKENS})
        check(int(cache.length[0]) == S, f"cache length {cache.length}")
        check([t.data_ptr() for t in cache[:2]] == cache_ptrs,
              "decode did not write the cache in place")

        # 5. compressed against dense attention, the last layer, every
        # position
        kvp, q, kc, vc, mask = seen["adc_decode_attention"]
        check(bool(mask.all()), "the last token's mask is not all of S")
        got = kv_quant.adc_decode_attention(kvp, q, kc, vc, mask)
        khat, vhat = kv_quant.decode_k(kvp, kc), kv_quant.decode_v(kvp, vc)
        want = layers.decode_attention(q.float(), khat, vhat,
                                       torch.full((B,), S, device=q.device))
        del khat, vhat
        attn_err = float((got - want).abs().max())
        attn_rel = attn_err / float(want.abs().max())
        check(attn_rel <= ATTN_RTOL, f"compressed attention is {attn_rel} "
              "(relative) from dense attention over the decoded cache")
        del got, want
        split = _decode_layer_split(params, cache, cfg, tok)
        torch.cuda.synchronize()     # the check's peak; its launches are
        peaks["attention_check"] = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()    # not the path's

        # 6. the quantization's effect on logits, PQ against a dense cache,
        # both fed the dense path's greedy tokens
        before = dict(ops.LAUNCHES)
        short = PROMPT_LEN + DECODE_TOKENS
        lp, cp = tfm.serve_prefill(params, prompt, cfg, max_len=short)
        ld, cd = tfm.serve_prefill(params, prompt, dense_cfg, max_len=short)
        agree, gaps = [], []
        for _ in range(DECODE_TOKENS):
            tok = ld.argmax(-1)
            lp, cp = tfm.serve_decode(params, tok, cp, cfg)
            ld, cd = tfm.serve_decode(params, tok, cd, dense_cfg)
            agree.append(bool((lp.argmax(-1) == ld.argmax(-1)).all()))
            gaps.append(float((lp - ld).abs().max()))
        del cp, cd
        part("quant_effect", before)
        _expect("PQ against dense", counts["quant_effect"],
                {"adc_batch": L * DECODE_TOKENS,
                 "pq_assign": 2 * L * (DECODE_TOKENS + 1)})

    launches = {}
    for c in counts.values():
        for k, v in c.items():
            launches[k] = launches.get(k, 0) + v
    hd, D = cfg.head_dim, cfg.kv_quant.num_subspaces
    cache_bytes = sum(t.numel() * t.element_size() for t in cache[:2])
    dense_bytes = 2 * L * B * cfg.num_kv_heads * S * hd * 2
    emit("decode", config=cfg.name, shape=DECODE_SHAPE, layers=L,
         d_model=cfg.d_model, heads=cfg.num_heads,
         kv_heads=cfg.num_kv_heads, head_dim=hd, d_ff=cfg.d_ff,
         vocab=cfg.vocab_size, kv_quant=cfg.kv_quant._asdict(),
         dtype=str(cfg.dtype), batch=B, max_len=S,
         num_params=tfm.num_params(cfg),
         cuts=dict(prompt=PROMPT_LEN, prefill_of=S,
                   codebooks=f"PQ.fit per layer on the prompt's K·R, V·R, "
                             f"{FIT_ITERS} iterations",
                   tiled=[PROMPT_LEN, S - DECODE_TOKENS - 1],
                   decode_tokens=DECODE_TOKENS, weights="seeded init"),
         tokens=out_tokens, step_host_ms=host_ms,
         step_host_ms_median=statistics.median(host_ms),
         layer_device_ms=split,
         layer_device_ms_total=sum(v for k, v in split.items()
                                   if k != "head"),
         attention_vs_dense=dict(max_abs_err=attn_err, rel=attn_rel),
         pq_vs_dense=dict(max_len=short, top1_agree=agree,
                          max_logit_gap=gaps),
         cache_bytes=cache_bytes, dense_bf16_cache_bytes=dense_bytes,
         seconds=secs, launches=launches, launches_by_part=counts,
         peak_memory_bytes=peaks, total_s=time.perf_counter() - t_all,
         card=smi)
    for name in DECODE_KERNELS:
        check(launches.get(name, 0) > 0,
              f"kernel {name} was not launched on the decode path")
    lut, codes = seen["adc_batch"]
    assign_X, assign_C = seen["pq_assign"]
    del params, cache, seen
    # the path a user calls: serve_prefill, then serve_decode token by token
    main_launches = {k: counts["prefill"].get(k, 0)
                     + counts["decode"].get(k, 0)
                     for k in set(counts["prefill"]) | set(counts["decode"])}
    return dict(launches=launches, main_launches=main_launches, lut=lut,
                codes=codes, assign_X=assign_X, assign_C=assign_C)


def _adc_batch_row(lut, codes) -> dict:
    """adc_batch at (lut, codes): device ms per launch, its plain
    version's, the bound, and one F.embedding_bag computing the same
    function (held to BATCH_RTOL of it)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref

    dev = codes.device
    gq, r, Dp, K = lut.shape
    S = codes.shape[1]
    k_ms = graph_ms(lambda: ops.adc_batch(lut, codes), launches=20)
    p_ms = graph_ms(lambda: ref.adc_batch_ref(lut, codes), launches=2)
    # the library yardstick: one embedding_bag, each (group, row) a bag of
    # its Dp entries of a (g·Dp·K, r) table, the group's offset g·Dp·K
    # added to its codes; the int32 index tensor is made outside the call
    offs = (torch.arange(gq, device=dev, dtype=torch.int32)[:, None, None]
            * (Dp * K)
            + torch.arange(Dp, device=dev, dtype=torch.int32) * K)
    bag = (codes.int() + offs).reshape(gq * S, Dp)
    table = lut.permute(0, 2, 3, 1).reshape(gq * Dp * K, r).contiguous()
    lib = functools.partial(F.embedding_bag, bag, table, mode="sum")
    want = ref.adc_batch_ref(lut, codes)
    lib_err = float((lib().reshape(gq, S, r).permute(0, 2, 1) - want).abs()
                    .max()) / float(want.abs().max())
    check(lib_err <= BATCH_RTOL, f"library yardstick computes another "
          f"function (relative error {lib_err})")
    del want
    lib_ms = graph_ms(lib, launches=5)
    del bag, table, lib, offs
    nbytes = codes.numel() + gq * r * S * 4 + lut.numel() * 4
    flops = gq * r * S * Dp
    return dict(shape=dict(g=gq, r=r, Dp=Dp, K=K, S=S), ms=k_ms,
                plain_ms=p_ms, bytes=nbytes, flops=flops,
                **_bound(nbytes, flops), library_ms=lib_ms)


def phase_decode_kernels(ctx: dict) -> dict:
    """adc_batch against its plain version on the decode's operands and on
    other geometries, timed beside its bound and a library call."""
    import torch

    from repro_torch.kernels import ops, ref

    lut, codes = ctx["lut"].contiguous(), ctx["codes"]
    dev = codes.device
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 5)

    def random_case(groups, r, Dp, S):
        return (torch.randn((groups, r, Dp, 256), generator=g, device=dev),
                torch.randint(0, 256, (groups, S, Dp), generator=g,
                              device=dev, dtype=torch.uint8))

    cases = {"decode": (lut, codes),
             "nemotron_r12_dp24": random_case(8, 12, 24, 65_537),
             "dp16_r3_ragged": random_case(5, 3, 16, 100_003)}
    errs = {}
    for name, (lt, cd) in cases.items():
        for dt, (lv, sc) in _lut_variants(lt).items():
            got = ops.adc_batch(lv, cd, sc)
            want = ref.adc_batch_ref(lv, cd, sc)
            torch.cuda.synchronize()
            if dt == "float32":
                check(torch.equal(got, want), f"adc_batch {name} float32 is "
                      "not bit-equal to its plain version")
                errs[f"adc_batch/{name}/{dt}"] = 0.0
            else:
                err = float((got - want).abs().max())
                rel = err / float(want.abs().max())
                check(rel <= BATCH_RTOL, f"adc_batch {name} {dt}: relative "
                      f"error {rel}")
                errs[f"adc_batch/{name}/{dt}"] = err
            del got, want
    row = _adc_batch_row(lut, codes)
    extra = {}
    for dt in ("int8", "uint8"):
        lv, sc = ops.quantize_luts(lut, dt)
        extra[f"{dt}_ms"] = graph_ms(lambda: ops.adc_batch(lv, codes, sc),
                                     launches=20)
    extra["nemotron_r12_dp24"] = _adc_batch_row(*cases["nemotron_r12_dp24"])
    # pq_assign on the last decode token's last encode (the new values of
    # every KV head of the last layer)
    Xa, Ca = ctx["assign_X"], ctx["assign_C"]
    got = ops.pq_assign(Xa, Ca)
    want = ref.pq_assign_ref(Xa, Ca)
    torch.cuda.synchronize()
    flips = _assign_flips(Xa, Ca, got, want)
    errs["pq_assign/decode"] = flips["max_abs_gap"]
    ma, na = Xa.shape
    Da, Ka, suba = Ca.shape
    a_bytes = ma * na * 4 + Da * Ka * suba * 4 + ma * Da * 4
    a_flops = 2 * ma * na * Ka
    extra["pq_assign"] = dict(
        shape=dict(m=ma, n=na, D=Da, K=Ka, sub=suba), flips=flips,
        ms=graph_ms(lambda: ops.pq_assign(Xa, Ca), launches=100),
        plain_ms=graph_ms(lambda: ref.pq_assign_ref(Xa, Ca), launches=100),
        bytes=a_bytes, flops=a_flops, **_bound(a_bytes, a_flops))
    rows = {"adc_batch": dict(
        **row, max_abs_err=max(v for key, v in errs.items()
                               if key.startswith("adc_batch/")))}
    emit("decode_kernels", max_abs_err=errs, kernels=rows, extra=extra,
         launches=ctx["launches"], card=torch.cuda.get_device_name(0))
    return rows, errs


# -- lm_train ----------------------------------------------------------------


@contextlib.contextmanager
def _recorded(module, name: str, into: list):
    """Inside the block, every result of ``module.<name>`` is appended
    (detached) to ``into``; the call goes on as before."""
    real = getattr(module, name)

    def spy(*args, **kwargs):
        out = real(*args, **kwargs)
        into.append(out.detach())
        return out

    setattr(module, name, spy)
    try:
        yield
    finally:
        setattr(module, name, real)


def lm_train_config():
    """olmo-1b at full width with the PQ KV cache of long_500k
    (KVQuantConfig(128, 16, 256)) and the distortion term in the loss."""
    from repro_torch import configs

    cfg = configs.get(LMT_ARCH).config_for_shape(LMT_SHAPE)
    check(cfg.kv_quant is not None, f"{LMT_SHAPE} sets no kv_quant")
    return cfg._replace(train_kv_quant=True)


def lm_opt_config(cfg):
    """``launch/cells.py`` ``_opt_cfg_for`` below 50B parameters: AdamW lr
    3e-4, clip 1.0, float32 moments and update, GCD-G at lr 1e-3 on the
    rotations; accumulation LMT_ACCUM (train_4k's 8 is a pod's batch)."""
    import torch

    from repro_torch import rotations
    from repro_torch.models import transformer as tfm
    from repro_torch.training import optimizer as opt_lib

    check(tfm.num_params(cfg) <= 50e9, "lm_train takes the < 50B optimizer")
    return opt_lib.OptimizerConfig(
        lr=LMT_LR, grad_clip=1.0, moment_dtype=torch.float32,
        compute_dtype=torch.float32, accum_steps=LMT_ACCUM,
        accum_dtype=torch.float32,
        rotation=rotations.RotationConfig(learner="gcd", method="greedy",
                                          lr=LMT_ROT_LR))


def lm_train_launches(cfg, steps: int) -> dict:
    """What ``steps`` KV-quantised train steps launch: per layer and
    microbatch, pq_assign for K and for V in the forward and again in the
    remat's recompute; per step, one gcd_score and one givens_rotate per
    layer of each of rot_k and rot_v."""
    L = cfg.num_layers
    remat = 2 if cfg.remat else 1
    return {"pq_assign": steps * LMT_ACCUM * L * 2 * remat,
            "gcd_score": steps * 2 * L, "givens_rotate": steps * 2 * L}


def _lm_agreement(params, kvq, cfg, prompt) -> dict:
    """PQ against a dense cache on one prompt, both fed the dense path's
    greedy tokens (LMT_DECODE_TOKENS of them), with the ``kvq`` leaves
    given: top-1 agreement and the largest logit gap per token."""
    from repro_torch.models import transformer as tfm

    p = dict(params, kvq=kvq)
    dense_cfg = cfg._replace(kv_quant=None, train_kv_quant=False)
    short = prompt.shape[1] + LMT_DECODE_TOKENS
    lp, cp = tfm.serve_prefill(p, prompt, cfg, max_len=short)
    ld, cd = tfm.serve_prefill(p, prompt, dense_cfg, max_len=short)
    agree, gaps = [], []
    for _ in range(LMT_DECODE_TOKENS):
        tok = ld.argmax(-1)
        lp, cp = tfm.serve_decode(p, tok, cp, cfg)
        ld, cd = tfm.serve_decode(p, tok, cd, dense_cfg)
        agree.append(bool((lp.argmax(-1) == ld.argmax(-1)).all()))
        gaps.append(float((lp - ld).abs().max()))
    return dict(top1_agree=agree, top1_share=sum(agree) / len(agree),
                max_logit_gap=gaps)


def _lm_kvq_arm(smi: str, errs: dict) -> tuple[dict, dict, dict]:
    """The KV-quantised train step at olmo-1b's full width: LMT_STEPS steps
    of (LMT_BATCH, LMT_SEQ) tokens, launches exact, then the kernels at
    these shapes against their plain versions, timed, and the trained
    leaves through a PQ decode. Returns (the phase's fields, the kernel
    rows, the path's launches)."""
    import numpy as np
    import torch

    from repro_torch import device, rotations
    from repro_torch.core import kv_quant
    from repro_torch.data import synthetic
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tfm
    from repro_torch.training import optimizer as opt_lib
    from repro_torch.training import train_state as ts

    cfg = lm_train_config()
    ocfg = lm_opt_config(cfg)
    L, hd = cfg.num_layers, cfg.head_dim
    t_all = time.perf_counter()
    g = device.generator(SEED + 40)
    params = tfm.init_params(g, cfg)
    for leaf in opt_lib.named_leaves(params).values():
        leaf.requires_grad_(True)
    kvq0 = {k: v.detach().clone() for k, v in params["kvq"].items()}
    state = ts.init_state(device.generator(SEED + 41), params, ocfg)
    timer = _StepTimer()
    step = ts.make_train_step(
        lambda p, a, b: tfm.forward_train(p, a, b, cfg), ocfg, marks=timer)
    data = device.generator(SEED + 42)
    losses, host_ms, dist_terms, seen = [], [], [], {}
    launches: dict = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    for i in range(LMT_STEPS):
        tok, lab = synthetic.lm_batch(data, LMT_BATCH, LMT_SEQ,
                                      cfg.vocab_size)
        dists: list = []
        with contextlib.ExitStack() as spies:
            spies.enter_context(_recorded(kv_quant, "kv_distortion", dists))
            if i == LMT_STEPS - 1:
                for name in LMT_KERNELS:
                    spies.enter_context(_last_call(name, seen,
                                                   by_shape=True))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            timer.start()
            with _counted(launches):
                state, m = step(state, tok, lab)
                torch.cuda.synchronize()
            host_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
        # the mean of the layers' terms over the microbatches; the remat's
        # recompute stops once the backward has what it needs, before its
        # call returns, so only the forward's calls are recorded
        dist_terms.append(float(sum(dists)) / len(dists))
    peak = torch.cuda.max_memory_allocated()
    split = timer.split_ms()
    check(all(math.isfinite(v) for v in losses), f"lm_train losses {losses}")
    check(losses[-1] < losses[0], f"lm_train loss did not fall: {losses}")
    want = lm_train_launches(cfg, LMT_STEPS)
    _expect("lm_train kvq steps", launches, want)
    bound = lm_orth_bound(LMT_STEPS)
    leaves = {}
    for key in ("rot_k", "rot_v"):
        R = params["kvq"][key].detach()
        check(R.dtype == cfg.param_dtype, f"{key} dtype {R.dtype}")
        eye = torch.eye(hd, device=R.device)
        orth = [float(rotations.orthogonality_error(r.float())) for r in R]
        moved = [float(torch.linalg.norm(r.float() - eye)) for r in R]
        check(all(v > 0 for v in moved), f"{key}: a layer's R did not move "
              f"({moved})")
        check(max(orth) <= bound, f"{key}: orthogonality {max(orth)} beyond "
              f"the bf16 bound {bound}")
        leaves[key] = dict(max_orth_err=max(orth), orth_err=orth,
                           fro_from_identity=moved)
    state_bytes = sum(t.numel() * t.element_size() for t in
                      list(state.opt_state.mu.values())
                      + list(state.opt_state.nu.values()))
    train_s = time.perf_counter() - t_all
    tokens = LMT_BATCH * LMT_SEQ
    pct = _pcts(host_ms[1:])
    fields = dict(
        config=cfg.name, shape=LMT_SHAPE, layers=L, d_model=cfg.d_model,
        heads=cfg.num_heads, kv_heads=cfg.num_kv_heads, head_dim=hd,
        d_ff=cfg.d_ff, vocab=cfg.vocab_size,
        kv_quant=cfg.kv_quant._asdict(), dtype=str(cfg.dtype),
        num_params=tfm.num_params(cfg), remat=cfg.remat,
        optimizer=dict(name=ocfg.name, lr=ocfg.lr, grad_clip=ocfg.grad_clip,
                       moment_dtype=str(ocfg.moment_dtype),
                       warmup_steps=ocfg.warmup_steps,
                       rotation=ocfg.rotation._asdict()),
        cuts=dict(seq=LMT_SEQ, batch=LMT_BATCH, accum_steps=LMT_ACCUM,
                  train_4k="global batch 256 with accumulation 8 is a "
                           "pod's batch", steps=LMT_STEPS,
                  weights="seeded init"),
        losses=losses, kv_dist_per_layer=dist_terms,
        step_host_ms=host_ms, step_host_ms_after_first=pct,
        tokens_per_s=tokens / (pct["p50"] / 1e3) if pct.get("p50") else None,
        device_split_ms=split, peak_memory_bytes=peak,
        moment_bytes=state_bytes, rotations=leaves, orth_bound=bound,
        launches=launches, train_s=train_s)
    del state, m, step
    torch.cuda.empty_cache()

    # the kernels at this path's shapes, against their plain versions
    held = _hold_rotation_kernels("lm_train", seen, errs)
    rows = _lm_kernel_rows(seen)
    fields["kernels_held"] = held
    del seen

    # reported only: the trained leaves through a PQ decode
    before = dict(ops.LAUNCHES)
    prompt = torch.from_numpy(np.random.default_rng(SEED + 43).integers(
        0, cfg.vocab_size, (1, LMT_PROMPT))).to(params["embed"].device)
    with torch.no_grad():
        trained = {k: v.detach() for k, v in params["kvq"].items()}
        fields["decode"] = dict(
            prompt=LMT_PROMPT, tokens=LMT_DECODE_TOKENS,
            trained=_lm_agreement(params, trained, cfg, prompt),
            initial=_lm_agreement(params, kvq0, cfg, prompt))
    decode_launches = _launch_delta(before)
    per_run = {"pq_assign": 2 * L * (LMT_DECODE_TOKENS + 1),
               "adc_batch": L * LMT_DECODE_TOKENS}
    _expect("lm_train decode", decode_launches,
            {k: 2 * v for k, v in per_run.items()})
    fields["decode"]["launches"] = decode_launches
    fields["seconds"] = time.perf_counter() - t_all
    del params, kvq0, trained
    torch.cuda.empty_cache()
    return fields, rows, dict(kvq=launches, decode=decode_launches)


def _lm_kernel_rows(seen: dict, phase: str = "lm_train") -> dict:
    """pq_assign, gcd_score and givens_rotate on a phase's last call at
    each shape: device ms per launch, the plain version's, the bound and
    a library call computing the same function (none for pq_assign)."""
    import torch

    from repro_torch.kernels import ops, ref

    rows = {}
    for (name, shape), args in sorted(seen.items()):
        tag = f"{name}_{phase}_{'x'.join(map(str, shape))}"
        if name == "pq_assign":
            X, C = args
            m, n = X.shape
            D, K, sub = C.shape
            nbytes = m * n * 4 + D * K * sub * 4 + m * D * 4
            flops = 2 * m * n * K
            rows[tag] = dict(
                shape=dict(m=m, n=n, D=D, K=K, sub=sub),
                ms=graph_ms(lambda: ops.pq_assign(X, C), launches=100),
                plain_ms=graph_ms(lambda: ref.pq_assign_ref(X, C),
                                  launches=20),
                bytes=nbytes, flops=flops, **_bound(nbytes, flops),
                library_ms=None)
        elif name == "gcd_score":
            G, R = args
            n = G.shape[0]
            lhs = torch.cat([G, -R], dim=0).T.contiguous()
            rhs = torch.cat([R, G], dim=0).contiguous()
            check(torch.allclose(torch.matmul(lhs, rhs),
                                 ref.gcd_score_ref(G, R), atol=GCD_ATOL),
                  "gcd_score's library yardstick computes another function")
            nbytes, flops = 3 * n * n * 4, 2 * n ** 3 + n * n
            rows[tag] = dict(
                shape=dict(n=n),
                ms=graph_ms(lambda: ops.gcd_score(G, R), launches=100),
                plain_ms=graph_ms(lambda: ref.gcd_score_ref(G, R),
                                  launches=100),
                bytes=nbytes, flops=flops, **_bound(nbytes, flops),
                library_ms=graph_ms(lambda: torch.matmul(lhs, rhs),
                                    launches=100))
        else:
            X, pi, pj, c, s = args
            m, n = X.shape
            p = pi.shape[0]
            dense = ref.pair_rotate_ref(torch.eye(n, device=X.device), pi,
                                        pj, c, s)
            check(torch.allclose(X @ dense, ref.pair_rotate_ref(
                X, pi, pj, c, s), atol=1e-6), "givens_rotate's library "
                "yardstick computes another function")
            nbytes, flops = 2 * m * n * 4 + 4 * p * 4, 6 * m * p
            rows[tag] = dict(
                shape=dict(m=m, n=n, pairs=p),
                ms=graph_ms(lambda: ops.givens_rotate(X, pi, pj, c, s),
                            launches=100),
                plain_ms=graph_ms(lambda: ref.pair_rotate_ref(X, pi, pj, c,
                                                              s),
                                  launches=100),
                bytes=nbytes, flops=flops, **_bound(nbytes, flops),
                library_ms=graph_ms(lambda: torch.matmul(X, dense),
                                    launches=100))
    return rows


def _lm_ckpt_dir() -> Path:
    return Path(__file__).resolve().parent / "build" / "lm_train_ckpt"


def _lm_launcher_arm(smi: str) -> dict:
    """``launch.train`` on olmo-1b at full width: the job straight, then
    stopped after LMT_STOP_AFTER steps with a checkpoint and resumed, under
    deterministic algorithms; the final losses held within
    LMT_RESUME_RTOL, no kernel launched (a dense config), the checkpoint's
    bytes and seconds reported."""
    import shutil

    import torch

    from repro_torch.bench import common
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training import optimizer as opt_lib

    d = _lm_ckpt_dir()
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    free0 = shutil.disk_usage(d).free
    kw = dict(steps=LMT_LAUNCH_STEPS, batch=LMT_LAUNCH_BATCH, full=True,
              seed=SEED, log_every=LMT_LAUNCH_STEPS)
    io_ms: dict = {}
    launches: dict = {}
    t_all = time.perf_counter()
    try:
        with common.deterministic(), _counted(launches):
            t0 = time.perf_counter()
            state_a, hist_a = launch.train(LMT_ARCH, ckpt_dir=None, **kw)
            torch.cuda.synchronize()
            straight_s = time.perf_counter() - t0
            want = {k: v.detach().cpu() for k, v in
                    opt_lib.named_leaves(state_a.params).items()}
            del state_a
            torch.cuda.empty_cache()
            with _timed_calls(ckpt, ("save", "restore"), io_ms):
                t0 = time.perf_counter()
                _, hist_c = launch.train(LMT_ARCH, ckpt_dir=str(d),
                                         stop_after=LMT_STOP_AFTER, **kw)
                stopped_s = time.perf_counter() - t0
                step_dir = d / f"step_{LMT_STOP_AFTER:010d}"
                ckpt_bytes = sum(f.stat().st_size
                                 for f in step_dir.iterdir())
                free_after_save = shutil.disk_usage(d).free
                torch.cuda.empty_cache()
                t0 = time.perf_counter()
                state_b, hist_b = launch.train(LMT_ARCH, ckpt_dir=str(d),
                                               **kw)
                torch.cuda.synchronize()
                resumed_s = time.perf_counter() - t0
        got = opt_lib.named_leaves(state_b.params)
        bit_equal = all(torch.equal(got[k].detach().cpu(), v)
                        for k, v in want.items())
        del state_b, got, want
    finally:
        shutil.rmtree(d, ignore_errors=True)
        torch.cuda.empty_cache()
    check(len(hist_a) == LMT_LAUNCH_STEPS and len(hist_c) == LMT_STOP_AFTER
          and len(hist_b) == LMT_LAUNCH_STEPS - LMT_STOP_AFTER,
          f"launcher step counts {len(hist_a)}, {len(hist_c)}, {len(hist_b)}")
    check(all(math.isfinite(v) for v in hist_a + hist_b),
          f"launcher losses {hist_a} {hist_b}")
    rel = abs(hist_b[-1] - hist_a[-1]) / abs(hist_a[-1])
    check(rel <= LMT_RESUME_RTOL, f"resumed final loss {hist_b[-1]} is "
          f"{rel} from the straight run's {hist_a[-1]}")
    _expect("launcher (dense olmo-1b)", launches, {})
    return dict(steps=LMT_LAUNCH_STEPS, batch=LMT_LAUNCH_BATCH,
                seq=launch.LM_SEQ, stop_after=LMT_STOP_AFTER,
                losses_straight=hist_a, losses_stopped=hist_c,
                losses_resumed=hist_b, final_rel_diff=rel,
                params_bit_equal=bit_equal, deterministic=True,
                checkpoint_bytes=ckpt_bytes, disk_free_before=free0,
                disk_free_after_save=free_after_save,
                save_ms=io_ms.get("save"), restore_ms=io_ms.get("restore"),
                straight_s=straight_s, stopped_s=stopped_s,
                resumed_s=resumed_s, launches=launches,
                seconds=time.perf_counter() - t_all)


def phase_lm_train(smi: str) -> tuple[dict, dict, dict]:
    """LM training on the port at olmo-1b's full width: the kvq arm (the
    kernels' path), then the launcher arm (the users' entry point), the
    card freed between. Returns (kernel rows, errors, launches by
    path)."""
    import torch

    errs: dict = {}
    kvq, rows, launches = _lm_kvq_arm(smi, errs)
    torch.cuda.empty_cache()
    launcher = _lm_launcher_arm(smi)
    emit("lm_train", kvq=kvq, launcher=launcher, kernels=rows,
         max_abs_err=errs, card=smi)
    return rows, errs, launches


# -- moe ---------------------------------------------------------------------


class _MoESpy:
    """Inside ``with``, every ``moe.moe_block`` call runs with a CUDA event
    at each of its marks; ``split_ms`` gives each call's parts in ms, the
    entries over capacity and aux (read after the arm, one sync)."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        import torch

        from repro_torch.models import moe

        self._real = real = moe.moe_block

        def spy(x, router_w, wi, wg, wo, cfg, *, activation, marks=None):
            events = []

            def mark(name):
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                events.append((name, ev))

            mark("start")
            out, aux = real(x, router_w, wi, wg, wo, cfg,
                            activation=activation, marks=mark)
            with torch.no_grad():
                over = moe.dropped(moe.route(x, router_w, cfg)[2], cfg,
                                   x.shape[0])
            self.calls.append(dict(tokens=x.shape[0], events=events,
                                   aux=aux.detach(), dropped=over))
            return out, aux

        moe.moe_block = spy
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe

        moe.moe_block = self._real
        return False

    def report(self) -> dict:
        """Per call: tokens, each part's ms, dropped entries, aux; and the
        median of each part over the calls. Clears the calls."""
        import torch

        torch.cuda.synchronize()
        calls = []
        for c in self.calls:
            ev = c["events"]
            calls.append(dict(
                tokens=c["tokens"], dropped=int(c["dropped"]),
                aux=float(c["aux"]),
                **{name: a.elapsed_time(b)
                   for (_, a), (name, b) in zip(ev, ev[1:])}))
        self.calls = []
        med = {p: statistics.median(c[p] for c in calls) for p in MOE_PARTS} \
            if calls else {}
        return dict(calls=len(calls), median_ms=med, per_call=calls)


def _moe_reference(x, router_w, wi, wg, wo, cfg, activation: str):
    """The plain per-token MoE: the float32 routing of ``moe.route``, then
    a loop over the tokens and their k choices in order, each (token,
    choice) taking its expert's next slot while slots remain (the stable
    sort's order), each expert's kept tokens through its products in
    float64, weighted by their gates and summed. Returns (out float64,
    dropped entries)."""
    import torch

    from repro_torch.models import layers, moe

    T, d = x.shape
    C = moe.capacity(T, cfg)
    _, gates, ids = moe.route(x, router_w, cfg)
    used = [0] * cfg.num_experts
    kept: dict[int, list] = {}
    dropped = 0
    for t, row in enumerate(ids.tolist()):
        for j, e in enumerate(row):
            if used[e] < C:
                used[e] += 1
                kept.setdefault(e, []).append((t, j))
            else:
                dropped += 1
    out = torch.zeros((T, d), dtype=torch.float64, device=x.device)
    x64, g64 = x.double(), gates.double()
    for e, pairs in kept.items():
        tt = torch.tensor([t for t, _ in pairs], device=x.device)
        jj = torch.tensor([j for _, j in pairs], device=x.device)
        xe = x64[tt]
        h = layers.activate(xe @ wi[e].double(), activation)
        if wg is not None:
            h = h * (xe @ wg[e].double())
        out.index_add_(0, tt, (h @ wo[e].double()) * g64[tt, jj][:, None])
    return out, dropped


def _moe_block_check(name: str, T: int, d: int, f: int, cfg,
                     activation: str, glu: bool, errs: dict) -> dict:
    """moe_block in float32 on T seeded tokens against
    ``_moe_reference``: within MOE_RTOL of the largest entry, the same
    entries dropped, aux against its float64 value."""
    import torch

    from repro_torch import device
    from repro_torch.models import moe

    g = device.generator(SEED + 60)
    E = cfg.num_experts

    def w(*shape):
        return torch.randn(shape, generator=g, device=g.device) / math.sqrt(
            shape[-2])

    x = torch.randn((T, d), generator=g, device=g.device)
    router, wi, wo = w(d, E), w(E, d, f), w(E, f, d)
    wg = w(E, d, f) if glu else None
    out, aux = moe.moe_block(x, router, wi, wg, wo, cfg,
                             activation=activation)
    want, dropped = _moe_reference(x, router, wi, wg, wo, cfg, activation)
    err = float((out.double() - want).abs().max())
    rel = err / float(want.abs().max())
    check(rel <= MOE_RTOL, f"moe_block {name}: {rel} of the largest entry "
          "from its plain per-token reference")
    probs, _, ids = moe.route(x, router, cfg)
    density = torch.nn.functional.one_hot(ids[:, 0], E).double().mean(0)
    aux64 = float((density * probs.double().mean(0)).sum() * E)
    check(abs(float(aux) - aux64) <= 1e-5 * abs(aux64),
          f"moe_block {name}: aux {float(aux)} against {aux64}")
    errs[f"moe_block/{name}"] = err
    return dict(tokens=T, d_model=d, d_ff=f, experts=E, top_k=cfg.top_k,
                capacity_factor=cfg.capacity_factor,
                capacity=moe.capacity(T, cfg), dropped=dropped,
                entries=T * cfg.top_k, max_abs_err=err, rel=rel,
                aux=float(aux), aux_float64=aux64)


def _moe_reckoning(cfg, arm: str, tokens: int) -> dict:
    """What an arm should hold at its peak, in bytes, from the shapes:
    the bf16 parameters, and per arm the gradients, the float32 logits
    chunk and its gradient, the caches, one MoE layer's dispatch buffers
    (E·C rows of d and of d_ff in bf16: xe, ye, and h, g, their product
    and, in training, the recompute's copies) and a query chunk's float32
    attention scores."""
    from repro_torch.models import moe
    from repro_torch.models import transformer as tfm

    E, f, d = cfg.moe.num_experts, cfg.d_ff, cfg.d_model
    T = min(tokens, cfg.moe_chunk) if cfg.moe_chunk else tokens
    rows = E * moe.capacity(T, cfg.moe)
    terms = dict(params=2 * tfm.num_params(cfg),
                 dispatch=rows * (2 * d + 4 * f) * 2)
    if arm == "train":
        terms["grads"] = terms["params"]
        terms["logits_chunk"] = 2 * 4 * min(tokens, cfg.xent_chunk) \
            * cfg.vocab_size
        terms["dispatch"] *= 2
    else:
        L, Hkv, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
        terms["attention_chunk"] = 4 * cfg.num_heads * cfg.q_chunk * tokens
        if arm == "decode":
            terms["pq_cache"] = 2 * L * Hkv * MOE_PQ_LEN \
                * cfg.kv_quant.num_subspaces
            terms["dense_cache"] = 2 * 2 * L * Hkv * MOE_DENSE_LEN * hd
        else:
            terms["dense_cache"] = 2 * 2 * L * Hkv * tokens * hd
    return dict(terms=terms, total=sum(terms.values()))


def _moe_plan(arch: str, arm: str, cfg, tokens: int) -> int:
    """Print an arm's memory reckoning and reset the peak; returns the
    reckoned bytes."""
    import torch

    plan = _moe_reckoning(cfg, arm, tokens)
    emit("moe_plan", arch=arch, arm=arm, layers=cfg.num_layers,
         gb={k: v / 1e9 for k, v in plan["terms"].items()},
         total_gb=plan["total"] / 1e9)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return plan["total"]


def _moe_layers(cfg) -> int:
    return cfg.num_layers // 2 if cfg.interleaved else cfg.num_layers


def _moe_prefill(arch: str, params, cfg, spy: _MoESpy) -> dict:
    """serve_prefill of MOE_SEQ seeded tokens at batch 1 into a dense
    cache; no kernel launches; every MoE layer runs once a chunk."""
    import numpy as np
    import torch

    from repro_torch.models import transformer as tfm

    tok = torch.from_numpy(np.random.default_rng(SEED + 64).integers(
        0, cfg.vocab_size, (1, MOE_SEQ))).to(params["embed"].device)
    reckoned = _moe_plan(arch, "prefill", cfg, MOE_SEQ)
    launches: dict = {}
    with torch.no_grad(), spy, _counted(launches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = tfm.serve_prefill(params, tok, cfg)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated()
    _expect(f"{arch} prefill (dense cache)", launches, {})
    chunks = (MOE_SEQ // cfg.moe_chunk
              if cfg.moe_chunk and MOE_SEQ > cfg.moe_chunk else 1)
    split = spy.report()
    check(split["calls"] == _moe_layers(cfg) * chunks,
          f"{arch} prefill: {split['calls']} MoE calls")
    check(bool(torch.isfinite(logits).all())
          and logits.shape == (1, cfg.vocab_size), f"{arch} prefill logits")
    del cache, logits
    return dict(seq=MOE_SEQ, batch=1, moe_chunk=cfg.moe_chunk, chunks=chunks,
                host_ms=ms, tokens_per_s=MOE_SEQ / ms * 1e3, moe=split,
                peak_memory_bytes=peak, reckoned_bytes=reckoned)


def _moe_decode(arch: str, params, cfg, g, spy: _MoESpy, seen: dict,
                adc_seen: dict, main: dict) -> dict:
    """The PQ cache of long_500k: a MOE_PROMPT-token prompt through a
    dense prefill, the KV codebooks fitted per layer, the PQ prefill into
    MOE_PQ_LEN positions filled by tiling, MOE_DECODE_TOKENS greedy
    tokens (the last over every position), compressed against dense
    attention on the last layer; then PQ against a dense cache of
    MOE_DENSE_LEN positions, both fed the dense path's greedy tokens."""
    import numpy as np
    import torch

    from repro_torch.core import kv_quant
    from repro_torch.models import layers
    from repro_torch.models import transformer as tfm

    L, S, N = cfg.num_layers, MOE_PQ_LEN, MOE_DECODE_TOKENS
    dense_cfg = cfg._replace(kv_quant=None)
    prompt = torch.from_numpy(np.random.default_rng(SEED + 65).integers(
        0, cfg.vocab_size, (1, MOE_PROMPT))).to(params["embed"].device)
    reckoned = _moe_plan(arch, "decode", cfg, MOE_PROMPT)
    fit: dict = {}
    path: dict = {}
    agree_l: dict = {}
    with torch.no_grad():
        with _counted(fit):
            dense_logits, dcache = tfm.serve_prefill(params, prompt,
                                                     dense_cfg)
            _fit_codebooks(g, params, dcache, cfg)
        del dcache
        _expect(f"{arch} codebook fit", fit,
                {"pq_assign": 2 * L * FIT_ITERS})
        with _counted(path), _last_call("pq_assign", seen, by_shape=True):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = tfm.serve_prefill(params, prompt, cfg,
                                              max_len=S)
            torch.cuda.synchronize()
            prefill_ms = (time.perf_counter() - t0) * 1e3
        check(torch.equal(logits, dense_logits), f"{arch}: the PQ prefill's "
              "logits differ from the dense prefill's")
        cache = _tile_prompt_codes(cache, MOE_PROMPT, S - N)
        tok = logits.argmax(-1)
        host_ms, out_tokens, att = [], [], {}
        with spy:
            for i in range(N):
                with contextlib.ExitStack() as spies:
                    if i == N - 1:
                        spies.enter_context(_last_call(
                            "adc_batch", adc_seen, key=lambda a: arch))
                        spies.enter_context(_last_call(
                            "pq_assign", seen, by_shape=True))
                        spies.enter_context(_last_call(
                            "adc_decode_attention", att, module=kv_quant))
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    with _counted(path):
                        logits, cache = tfm.serve_decode(params, tok, cache,
                                                         cfg)
                    torch.cuda.synchronize()
                host_ms.append((time.perf_counter() - t0) * 1e3)
                check(bool(torch.isfinite(logits).all()),
                      f"{arch} decode step {i}: logits")
                tok = logits.argmax(-1)
                out_tokens.append(int(tok[0]))
        split = spy.report()
        check(int(cache.length[0]) == S, f"{arch} cache length")
        _expect(f"{arch} PQ prefill and decode", path,
                {"pq_assign": 2 * L * (N + 1), "adc_batch": L * N})
        check(split["calls"] == _moe_layers(cfg) * N,
              f"{arch} decode: {split['calls']} MoE calls")
        kvp, q, kc, vc, mask = att["adc_decode_attention"]
        check(bool(mask.all()), "the last token's mask is not all of S")
        got = kv_quant.adc_decode_attention(kvp, q, kc, vc, mask)
        khat, vhat = kv_quant.decode_k(kvp, kc), kv_quant.decode_v(kvp, vc)
        want = layers.decode_attention(q.float(), khat, vhat,
                                       torch.full((1,), S, device=q.device))
        attn_err = float((got - want).abs().max())
        attn_rel = attn_err / float(want.abs().max())
        check(attn_rel <= ATTN_RTOL, f"{arch}: compressed attention is "
              f"{attn_rel} (relative) from dense attention")
        del got, want, khat, vhat, att, cache
        peak = torch.cuda.max_memory_allocated()
        with _counted(agree_l):
            lp, cp = tfm.serve_prefill(params, prompt, cfg,
                                       max_len=MOE_DENSE_LEN)
            ld, cd = tfm.serve_prefill(params, prompt, dense_cfg,
                                       max_len=MOE_DENSE_LEN)
            agree, gaps = [], []
            for _ in range(N):
                nxt = ld.argmax(-1)
                lp, cp = tfm.serve_decode(params, nxt, cp, cfg)
                ld, cd = tfm.serve_decode(params, nxt, cd, dense_cfg)
                agree.append(bool((lp.argmax(-1) == ld.argmax(-1)).all()))
                gaps.append(float((lp - ld).abs().max()))
        del cp, cd
        _expect(f"{arch} PQ against dense", agree_l,
                {"pq_assign": 2 * L * (N + 1), "adc_batch": L * N})
    for k, v in path.items():
        main[k] = main.get(k, 0) + v
    return dict(prompt=MOE_PROMPT, max_len=S, tiled=[MOE_PROMPT, S - N - 1],
                decode_tokens=N, tokens=out_tokens, prefill_host_ms=prefill_ms,
                step_host_ms=host_ms,
                step_host_ms_median=statistics.median(host_ms), moe=split,
                attention_vs_dense=dict(max_abs_err=attn_err, rel=attn_rel),
                pq_vs_dense=dict(max_len=MOE_DENSE_LEN, top1_agree=agree,
                                 max_logit_gap=gaps),
                launches=dict(fit=fit, path=path, pq_vs_dense=agree_l),
                peak_memory_bytes=peak, reckoned_bytes=reckoned)


def _moe_train(arch: str, params, cfg, full_cfg, spy: _MoESpy, seen: dict,
               main: dict) -> dict:
    """MOE_TRAIN_STEPS steps of (1, MOE_TRAIN_SEQ) seeded tokens with the
    KV term, ``_opt_cfg_for`` of the full config (Adafactor in bf16) and
    GCD-G on the stacked kvq rotations, under deterministic algorithms:
    losses finite and falling, launches exact, every R moved and within
    the bf16 bound."""
    import torch

    from repro_torch import device, rotations
    from repro_torch.bench import common
    from repro_torch.data import synthetic
    from repro_torch.launch import cells
    from repro_torch.models import transformer as tfm
    from repro_torch.training import optimizer as opt_lib
    from repro_torch.training import train_state as ts

    L, hd = cfg.num_layers, cfg.head_dim
    ocfg = cells._opt_cfg_for(full_cfg)
    check(ocfg.name == "adafactor" and ocfg.compute_dtype == torch.bfloat16,
          f"{arch}: _opt_cfg_for gave {ocfg.name}")
    for leaf in opt_lib.named_leaves(params).values():
        leaf.requires_grad_(True)
    reckoned = _moe_plan(arch, "train", cfg, MOE_TRAIN_SEQ)
    state = ts.init_state(device.generator(SEED + 66), params, ocfg)
    timer = _StepTimer()
    part_peaks: dict = {}

    def marks(name: str) -> None:
        """The step's CUDA event, and the peak memory of the part it
        ends (forward, backward, the optimizer, rotation)."""
        timer(name)
        part_peaks[name] = max(part_peaks.get(name, 0),
                               torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()

    step = ts.make_train_step(
        lambda p, a, b: tfm.forward_train(p, a, b, cfg), ocfg, marks=marks)
    data = device.generator(SEED + 67)
    losses, host_ms, launches = [], [], {}
    split = {}
    with common.deterministic():
        for i in range(MOE_TRAIN_STEPS):
            tok, lab = synthetic.lm_batch(data, 1, MOE_TRAIN_SEQ,
                                          cfg.vocab_size)
            with contextlib.ExitStack() as spies:
                if i == MOE_TRAIN_STEPS - 1:
                    for name in LMT_KERNELS:
                        spies.enter_context(_last_call(name, seen,
                                                       by_shape=True))
                    spies.enter_context(spy)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                timer.start()
                with _counted(launches):
                    state, m = step(state, tok, lab)
                    torch.cuda.synchronize()
                host_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(m["loss"]))
        split = spy.report()
    peak = max(torch.cuda.max_memory_allocated(), *part_peaks.values())
    device_ms = timer.split_ms()
    check(all(math.isfinite(v) for v in losses), f"{arch} losses {losses}")
    check(losses[-1] < losses[0], f"{arch} loss did not fall: {losses}")
    remat = 2 if cfg.remat else 1
    _expect(f"{arch} train steps", launches,
            {"pq_assign": MOE_TRAIN_STEPS * L * 2 * remat,
             "gcd_score": MOE_TRAIN_STEPS * 2 * L,
             "givens_rotate": MOE_TRAIN_STEPS * 2 * L})
    check(split["calls"] == _moe_layers(cfg) * remat,
          f"{arch} train: {split['calls']} MoE calls in the last step")
    bound = lm_orth_bound(MOE_TRAIN_STEPS)
    rots = {}
    for key in ("rot_k", "rot_v"):
        R = params["kvq"][key].detach()
        eye = torch.eye(hd, device=R.device)
        orth = [float(rotations.orthogonality_error(r.float())) for r in R]
        moved = [float(torch.linalg.norm(r.float() - eye)) for r in R]
        check(all(v > 0 for v in moved), f"{arch} {key}: a layer's R did "
              f"not move ({moved})")
        check(max(orth) <= bound, f"{arch} {key}: orthogonality "
              f"{max(orth)} beyond the bf16 bound {bound}")
        rots[key] = dict(max_orth_err=max(orth), fro_from_identity=moved)
    stat_bytes = sum(t.numel() * t.element_size() for t in
                     list(state.opt_state.mu.values())
                     + list(state.opt_state.nu.values()))
    del state, m, step
    for leaf in opt_lib.named_leaves(params).values():
        leaf.requires_grad_(False)
    torch.cuda.empty_cache()
    for k, v in launches.items():
        main[k] = main.get(k, 0) + v
    pct = _pcts(host_ms[1:])
    return dict(seq=MOE_TRAIN_SEQ, batch=1, accum_steps=ocfg.accum_steps,
                steps=MOE_TRAIN_STEPS,
                optimizer=dict(name=ocfg.name, lr=ocfg.lr,
                               grad_clip=ocfg.grad_clip,
                               compute_dtype=str(ocfg.compute_dtype),
                               warmup_steps=ocfg.warmup_steps,
                               rotation=ocfg.rotation._asdict()),
                losses=losses, step_host_ms=host_ms,
                step_host_ms_after_first=pct,
                tokens_per_s=(MOE_TRAIN_SEQ / (pct["p50"] / 1e3)
                              if pct.get("p50") else None),
                device_split_ms=device_ms, moe=split, rotations=rots,
                orth_bound=bound, adafactor_stat_bytes=stat_bytes,
                launches=launches, deterministic=True,
                peak_memory_bytes=peak, peak_memory_by_part=part_peaks,
                reckoned_bytes=reckoned)


def phase_moe(smi: str) -> tuple[dict, dict, dict]:
    """MoE on the port at full width and MOE_LAYERS layers: moe_block held
    to its plain per-token reference at grok-1's width and at llama4's 128
    experts with tokens dropped; grok-1 prefills MOE_SEQ tokens through
    two MoE chunks, trains (MOE_TRAIN_ARCH) and decodes with the PQ cache;
    llama4-maverick prefills and decodes; then the kernels at the shapes
    this phase launched them at against their plain versions, timed.
    Returns (kernel rows, errors, the main path's launches)."""
    import torch

    from repro_torch import configs, device
    from repro_torch.kernels import ops, ref
    from repro_torch.models import moe
    from repro_torch.models import transformer as tfm

    t_all = time.perf_counter()
    gc.collect()               # earlier phases' tensors held in cycles
    torch.cuda.empty_cache()
    at_start = torch.cuda.memory_allocated()
    errs: dict = {}
    grok, llama = (configs.get(a).make_config() for a in MOE_ARCHS)
    blocks = dict(
        grok_width=_moe_block_check(
            "grok_width", MOE_CHECK_TOKENS, grok.d_model, grok.d_ff,
            grok.moe, grok.activation, grok.use_glu, errs),
        llama4_experts=_moe_block_check(
            "llama4_128_experts", MOE_DROP_TOKENS, llama.d_model,
            MOE_CHECK_FF,
            llama.moe._replace(capacity_factor=MOE_DROP_FACTOR),
            llama.activation, llama.use_glu, errs))
    check(blocks["llama4_experts"]["dropped"] > 0,
          "the 128-expert check dropped no token")
    torch.cuda.empty_cache()

    seen: dict = {}
    adc_seen: dict = {}
    main: dict = {}
    arms: dict = {}
    spy = _MoESpy()
    for arch in MOE_ARCHS:
        spec = configs.get(arch)
        full = spec.make_config()
        base = full._replace(num_layers=MOE_LAYERS)
        pre_cfg = spec.adjust(base, "prefill_32k")
        if arch in MOE_CHUNK:
            pre_cfg = pre_cfg._replace(moe_chunk=MOE_CHUNK[arch])
        dec_cfg = spec.adjust(base, "long_500k")
        t0 = time.perf_counter()
        g = device.generator(SEED + 63)
        params = tfm.init_params(g, dec_cfg)
        arm = dict(num_params=tfm.num_params(dec_cfg),
                   full_num_params=tfm.num_params(full),
                   init_s=time.perf_counter() - t0)
        arm["prefill"] = _moe_prefill(arch, params, pre_cfg, spy)
        if arch == MOE_TRAIN_ARCH:
            arm["train"] = _moe_train(
                arch, params, dec_cfg._replace(train_kv_quant=True), full,
                spy, seen, main)
        arm["decode"] = _moe_decode(arch, params, dec_cfg, g, spy, seen,
                                    adc_seen, main)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        arm["allocated_after"] = torch.cuda.memory_allocated()
        arm["seconds"] = time.perf_counter() - t0
        arms[arch] = dict(config=dict(
            layers=MOE_LAYERS, d_model=full.d_model, heads=full.num_heads,
            kv_heads=full.num_kv_heads, d_ff=full.d_ff,
            experts=full.moe.num_experts, top_k=full.moe.top_k,
            moe_every=full.moe_every, vocab=full.vocab_size,
            dtype=str(full.dtype)), **arm)

    # the kernels at this phase's shapes against their plain versions
    held = _hold_rotation_kernels("moe", seen, errs)
    rows = _lm_kernel_rows(seen, "moe")
    del seen
    for (_, arch), (lut, codes) in sorted(adc_seen.items()):
        lut = lut.contiguous()
        check(torch.equal(ops.adc_batch(lut, codes),
                          ref.adc_batch_ref(lut, codes)),
              f"adc_batch at {arch}'s decode is not bit-equal to its plain "
              "version")
        errs[f"adc_batch/moe_{arch}"] = 0.0
        rows[f"adc_batch_moe_{arch}"] = _adc_batch_row(lut, codes)
    del adc_seen
    torch.cuda.empty_cache()
    for name in MOE_KERNELS:
        check(main.get(name, 0) > 0, f"kernel {name} was not launched on the "
              "moe path")
    emit("moe", allocated_at_start=at_start, block_checks=blocks,
         arms=arms, kernels=rows,
         kernels_held=held, max_abs_err=errs, launches=main,
         cuts=dict(layers=f"{MOE_LAYERS} (grok-1 has 64, llama4 48: 630 GB "
                          "and 800 GB in bf16)",
                   prefill="batch 1 (prefill_32k's 32 is 1M tokens); "
                           f"moe_chunk {MOE_CHUNK} (prefill_32k's 131,072 "
                           "needs (E·C, d_ff) buffers of 21.5 GB for grok)",
                   decode=f"a {MOE_PROMPT}-token prompt tiled to "
                          f"{MOE_PQ_LEN} positions, {MOE_DECODE_TOKENS} "
                          "tokens",
                   train=f"{MOE_TRAIN_ARCH} only (llama4's parameters and "
                         "gradients are 73.7 GB), batch 1 at seq "
                         f"{MOE_TRAIN_SEQ}, accumulation 1 (train_4k's 16 "
                         f"waits for ROADMAP 14d), {MOE_TRAIN_STEPS} steps",
                   block_check=f"llama4's 128 experts at d_ff {MOE_CHECK_FF} "
                               "(8,192 in float32 is 64 GB)",
                   weights="seeded init"),
         seconds=time.perf_counter() - t_all, card=smi)
    return rows, errs, main


# -- zoo ---------------------------------------------------------------------


def _zoo_plan(arm: str, terms: dict) -> dict:
    """Print an arm's memory reckoning (bytes by term, from the shapes) and
    reset the peak; returns the plan."""
    import torch

    torch.cuda.synchronize()
    plan = dict(gb={k: v / 1e9 for k, v in terms.items()},
                total_gb=sum(terms.values()) / 1e9,
                allocated_before_gb=torch.cuda.memory_allocated() / 1e9)
    emit("zoo_plan", arm=arm, **plan)
    torch.cuda.reset_peak_memory_stats()
    return plan


def _zoo_peak(plan: dict) -> dict:
    """The peak since ``_zoo_plan``, beside the reckoning."""
    import torch

    torch.cuda.synchronize()
    return dict(peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                reckoned_gb=plan["total_gb"],
                allocated_before_gb=plan["allocated_before_gb"])


def _zoo_equal(a, b) -> bool:
    """Two models' parameters bit-equal, leaf by leaf."""
    import torch

    from repro_torch.training import optimizer as opt_lib

    la, lb = opt_lib.named_leaves(a), opt_lib.named_leaves(b)
    return la.keys() == lb.keys() and all(torch.equal(la[k], lb[k])
                                          for k in la)


def _zoo_train_twice(make, steps: int) -> tuple:
    """Run ``make()`` -> (model, step, state, batches) twice under
    deterministic algorithms, ``steps`` steps each (host clock,
    synchronised). Held: every loss finite, the last below the first, and
    the second run's losses and parameters equal to the first's. Returns
    (the first run's model, losses, step ms)."""
    import torch

    from repro_torch.bench import common

    runs = []
    with common.deterministic():
        for _ in range(2):
            model, step, state, batches = make()
            losses, ms = [], []
            for i in range(steps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, m = step(state, *batches(i))
                losses.append(float(m["loss"]))
                ms.append((time.perf_counter() - t0) * 1e3)
            runs.append((model, losses, ms))
    (model, losses, ms), (again, losses2, _) = runs
    check(all(math.isfinite(v) for v in losses), f"losses {losses}")
    check(losses[-1] < losses[0], f"the loss did not fall: {losses}")
    check(losses2 == losses and _zoo_equal(model, again),
          f"two runs of one seed differ: {losses} / {losses2}")
    return model, losses, ms


def _zoo_sage_step(cfg, loss_fn, steps: int, lr: float, seed: int):
    """A fresh GraphSAGE on the card, its AdamW state and train step."""
    from repro_torch import device
    from repro_torch.models import gnn
    from repro_torch.training import optimizer as opt_lib
    from repro_torch.training import train_state as ts

    model = gnn.GraphSAGE.init(device.generator(seed), cfg)
    ocfg = opt_lib.OptimizerConfig(lr=lr, total_steps=steps, warmup_steps=1)
    state = ts.init_state(device.generator(seed + 1), model, ocfg)
    return model, ts.make_train_step(loss_fn, ocfg), state


def _zoo_minibatch(graph, feats, cfg) -> tuple:
    """gnn_minibatch: ZOO_GNN_STEPS steps of minibatch_lg's 1,024 seeds,
    step i's seeds and blocks from RandomState(ZOO_SEED + i), sampled on
    the host and gathered from ``feats`` on the card, twice from one seed.
    Returns (model, report)."""
    import numpy as np

    from repro_torch.configs import base
    from repro_torch.data import graph as graph_lib
    from repro_torch.models import gnn, param

    batch = base.GNN_SHAPES["minibatch_lg"].params["batch_nodes"]
    f1, f2 = cfg.sample_sizes
    rows = batch * (1 + f1 + f1 * f2)
    plan = _zoo_plan("gnn_minibatch", dict(
        features=feats.numel() * 4, blocks=rows * cfg.d_in * 4,
        layer_inputs=2 * batch * (1 + f1) * cfg.d_in * 4,
        params_grads_moments=4 * 4 * param.count_params(gnn.param_specs(cfg))))
    blocks_ms = []

    def batches(i):
        t0 = time.perf_counter()
        seeds = np.random.RandomState(ZOO_SEED + i).randint(
            0, graph.num_nodes, size=batch)
        blocks, labels = graph_lib.sample_blocks(
            graph, seeds, cfg.sample_sizes, ZOO_SEED + i, feats)
        blocks_ms.append((time.perf_counter() - t0) * 1e3)
        return (*blocks, labels)

    def make():
        model, step, state = _zoo_sage_step(
            cfg, lambda p, *b: gnn.loss_minibatch(p, list(b[:-1]), b[-1],
                                                  cfg),
            ZOO_GNN_STEPS, ZOO_GNN_LR, ZOO_SEED)
        return model, step, state, batches

    model, losses, ms = _zoo_train_twice(make, ZOO_GNN_STEPS)
    return model, dict(
        batch=batch, fanout=[f1, f2], steps=ZOO_GNN_STEPS, lr=ZOO_GNN_LR,
        losses=losses, one_answer_a_seed=True, step_ms=ms,
        step_ms_p50=statistics.median(ms),
        blocks_ms_p50=statistics.median(blocks_ms[:ZOO_GNN_STEPS]),
        **_zoo_peak(plan))


def _zoo_small(spec) -> dict:
    """gnn_full on full_graph_sm's sizes (a synthetic graph of 2,708 nodes
    at the shape's average degree) and gnn_graph on molecule's (128 graphs
    of 30 nodes and 64 edges: a ring, so every node has an in-edge, and 34
    random edges; features around a centre per graph label), each under
    mean and max, ZOO_SMALL_STEPS full-batch steps twice from one seed."""
    import numpy as np
    import torch

    from repro_torch import device
    from repro_torch.configs import base
    from repro_torch.data import graph as graph_lib
    from repro_torch.models import gnn, param

    dev = device.resolve()
    out = {}
    p = base.GNN_SHAPES["full_graph_sm"].params
    cfg_f = spec.config_for_shape("full_graph_sm")
    g = graph_lib.synthetic_graph(ZOO_SEED + 1, p["n_nodes"],
                                  round(p["n_edges"] / p["n_nodes"]),
                                  p["d_feat"], num_classes=cfg_f.num_classes)
    src, dst = (torch.from_numpy(a).to(dev) for a in g.edge_list())
    feats = torch.from_numpy(g.feats).to(dev)
    labels = torch.from_numpy(g.labels.astype(np.int64)).to(dev)
    mask = torch.from_numpy(
        np.random.RandomState(ZOO_SEED + 2).rand(g.num_nodes) < 0.5).to(dev)
    q = base.GNN_SHAPES["molecule"].params
    G, n, e = q["batch"], q["n_nodes"], q["n_edges"]
    cfg_m = spec.config_for_shape("molecule")
    rng = np.random.RandomState(ZOO_SEED + 3)
    ring = np.arange(n)
    local_src = np.concatenate([np.tile(ring, (G, 1)),
                                rng.randint(0, n, (G, e - n))], axis=1)
    local_dst = np.concatenate([np.tile(np.roll(ring, 1), (G, 1)),
                                rng.randint(0, n, (G, e - n))], axis=1)
    base_id = (np.arange(G) * n)[:, None]
    m_src = torch.from_numpy((local_src + base_id).reshape(-1)).to(dev)
    m_dst = torch.from_numpy((local_dst + base_id).reshape(-1)).to(dev)
    glab = rng.randint(0, cfg_m.num_classes, G)
    centres = rng.randn(cfg_m.num_classes, q["d_feat"]).astype(np.float32)
    m_feats = torch.from_numpy(np.repeat(centres[glab], n, axis=0) + 0.5 *
                               rng.randn(G * n, q["d_feat"]).astype(
                                   np.float32)).to(dev)
    gids = torch.arange(G, device=dev).repeat_interleave(n)
    m_labels = torch.from_numpy(glab.astype(np.int64)).to(dev)
    for agg in ("mean", "max"):
        cf, cm = cfg_f._replace(aggregator=agg), cfg_m._replace(aggregator=agg)
        plan = _zoo_plan(f"gnn_full_{agg}", dict(
            features=feats.numel() * 4,
            messages=2 * src.numel() * cf.d_in * 4,
            layer_inputs=2 * feats.numel() * 4,
            params_grads_moments=4 * 4 * param.count_params(gnn.param_specs(cf))))

        def make_full(cf=cf):
            model, step, state = _zoo_sage_step(
                cf, lambda p_, f, s, d, y, mk: gnn.loss_full_batch(
                    p_, f, s, d, y, mk, cf), ZOO_SMALL_STEPS, ZOO_SMALL_LR,
                ZOO_SEED)
            return model, step, state, lambda i: (feats, src, dst, labels,
                                                  mask)

        _, losses, ms = _zoo_train_twice(make_full, ZOO_SMALL_STEPS)
        out[f"full_graph_sm_{agg}"] = dict(
            nodes=g.num_nodes, edges=g.num_edges, d_in=cf.d_in,
            labelled=int(mask.sum()), losses=losses, step_ms=ms,
            **_zoo_peak(plan))
        plan = _zoo_plan(f"gnn_graph_{agg}", dict(
            features=m_feats.numel() * 4,
            messages=2 * m_src.numel() * cm.d_in * 4,
            params_grads_moments=4 * 4 * param.count_params(gnn.param_specs(cm))))

        def make_graph(cm=cm):
            model, step, state = _zoo_sage_step(
                cm, lambda p_, f, s, d, gi, y: gnn.loss_graph_batch(
                    p_, f, s, d, gi, y, G, cm), ZOO_SMALL_STEPS,
                ZOO_SMALL_LR, ZOO_SEED)
            return model, step, state, lambda i: (m_feats, m_src, m_dst,
                                                  gids, m_labels)

        _, losses, ms = _zoo_train_twice(make_graph, ZOO_SMALL_STEPS)
        out[f"molecule_{agg}"] = dict(
            graphs=G, nodes=G * n, edges=G * e, d_in=cm.d_in, losses=losses,
            step_ms=ms, **_zoo_peak(plan))
    return out


def _zoo_gnn_index(model, graph, feats, cfg, errs: dict) -> tuple:
    """bench/gnn_index.py's index side on the minibatch graph's full-graph
    embeddings: OPQ with the rotation frozen and learned by GCD-G, each
    quantizer served through flat_adc, neighbour recall@10 of ZOO_PROBES
    nodes against the exact backend. Held: R orthogonal to ZOO_ORTH (the
    frozen R the identity, GCD-G's moved), distortion and recall finite,
    at least gnn_index.COMMUNITY_MIN of each probe's top 10 in its own
    community, the launches the path implies, and its four kernels against
    their plain versions at its shapes. Returns (report, kernel rows,
    launches)."""
    import torch

    from repro_torch.bench import gnn_index
    from repro_torch.index import ivf as index_ivf
    from repro_torch.kernels import ops, ref
    from repro_torch.models import gnn
    from repro_torch.quant.base import PQConfig

    N = graph.num_nodes
    plan = _zoo_plan("gnn_index", dict(
        features=feats.numel() * 4, edges=graph.num_edges * 8,
        message_block=gnn.CSR_BLOCK_ELEMS * 4,
        embeddings=2 * N * cfg.d_hidden * 4,
        flat_scores=ZOO_PROBES * N * 4 * 2))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    h = gnn_index.embeddings(model, graph, feats, cfg)
    torch.cuda.synchronize()
    embed_s = time.perf_counter() - t0
    check(tuple(h.shape) == (N, cfg.d_hidden)
          and bool(torch.all(torch.isfinite(h))),
          f"gnn_index: embeddings {tuple(h.shape)} not finite or not "
          f"({N}, {cfg.d_hidden})")
    truth = gnn_index.neighbour_truth(h, ZOO_PROBES)
    seen, adc_seen, launches = {}, {}, {}
    t1 = time.perf_counter()
    with contextlib.ExitStack() as spies:
        for name in ("gcd_score", "givens_rotate", "pq_assign"):
            spies.enter_context(_last_call(name, seen, by_shape=True))
        spies.enter_context(_last_call("adc_lookup", adc_seen))
        with _counted(launches):
            solvers = gnn_index.index_recall(
                h, truth, graph.labels, PQConfig(*ZOO_PQ), seed=ZOO_SEED + 3,
                **ZOO_OPQ)
            torch.cuda.synchronize()
    index_s = time.perf_counter() - t1
    peak = _zoo_peak(plan)
    # OPQ as fig2 counts it (frozen: no rotation step; GCD-G: an assign, a
    # gcd_score and a givens_rotate an inner step), then from_quantizer's
    # encode (a coarse and a PQ assign a chunk of ENCODE_ROWS) and one
    # scan a solver
    it, inner = ZOO_OPQ["iters"], ZOO_OPQ["inner_steps"]
    chunks = -(-N // index_ivf.ENCODE_ROWS)
    want = dict(pq_assign=(1 + 2 * it) + (1 + it * (2 + inner))
                + 2 * 2 * chunks, gcd_score=it * inner,
                givens_rotate=it * inner, adc_lookup=2)
    _expect("zoo gnn_index", launches, want)
    for solver, r in solvers.items():
        check(math.isfinite(r["distortion"]) and math.isfinite(r["recall"]),
              f"gnn_index {solver}: {r}")
        check(r["orthogonality_error"] <= ZOO_ORTH, f"gnn_index {solver}: "
              f"R off orthogonal by {r['orthogonality_error']}")
    check(solvers["frozen"]["r_moved"] == 0.0
          and solvers["gcd_greedy"]["r_moved"] > 0.0,
          f"gnn_index: R moved {solvers}")
    # recall@10 is near chance within a community of near-equal embeddings
    # whether the index works or not; what a working encode, id mapping and
    # top-k find, and random ids do not, is the probe's community
    chance = gnn_index.chance_share(graph.labels)
    exact_share = gnn_index.community_share(truth, graph.labels, ZOO_PROBES)
    for solver, r in solvers.items():
        check(r["community_share"] >= gnn_index.COMMUNITY_MIN,
              f"gnn_index {solver}: {r['community_share']} of the top 10 in "
              f"the probe's community, under {gnn_index.COMMUNITY_MIN} "
              f"(random ids: {chance}, exact: {exact_share})")
    held = _hold_rotation_kernels("zoo", seen, errs)
    rows = _lm_kernel_rows(seen, "zoo")
    del seen
    lut, codes, scales, ids = adc_seen.pop("adc_lookup")
    errs["adc_lookup/zoo_gnn_index"] = bit_equal(
        ops.adc_lookup(lut, codes, scales, ids),
        ref.adc_lookup_ref(lut, codes, scales, ids), "adc_lookup at gnn_index")
    b, (cap, Dp) = lut.shape[0], codes.shape
    lib = flat_library(lut, codes)
    compare(lib().T, ref.adc_lookup_ref(lut, codes), ATOL, RTOL)
    tiles = torch.arange(cap // BS, device=codes.device)
    nbytes = _scan_bytes(lut, None, codes, ids, tiles, BS, b * cap, 0)
    flops = b * int(torch.sum(ids >= 0)) * Dp
    rows[f"adc_lookup_zoo_{b}x{cap}x{Dp}"] = dict(
        shape=dict(b=b, N=cap, Dp=Dp, K=lut.shape[2]),
        ms=graph_ms(lambda: ops.adc_lookup(lut, codes, None, ids),
                    launches=20),
        plain_ms=graph_ms(lambda: ref.adc_lookup_ref(lut, codes, None, ids),
                          launches=2),
        library_ms=graph_ms(lib, launches=5), bytes=nbytes, flops=flops,
        **_bound(nbytes, flops))
    del lib, lut, codes, ids, h
    report = dict(
        embeddings=[N, cfg.d_hidden], embed_s=embed_s,
        pq=dict(subspaces=ZOO_PQ[0], codewords=ZOO_PQ[1]), opq=ZOO_OPQ,
        probes=ZOO_PROBES, served="flat_adc (from_quantizer)",
        solvers=solvers, community_min=gnn_index.COMMUNITY_MIN,
        exact_community_share=exact_share, chance_share=chance, margins=dict(
            distortion_frozen_minus_gcd=solvers["frozen"]["distortion"]
            - solvers["gcd_greedy"]["distortion"],
            recall_gcd_minus_frozen=solvers["gcd_greedy"]["recall"]
            - solvers["frozen"]["recall"]),
        index_s=index_s, launches=launches, kernels_held=held, **peak)
    return report, rows, launches


def _zoo_ranker_extra(arch: str, model, cfg) -> dict:
    """On the straight run's model, without gradients: Wide&Deep's
    serve_p99 forward (512 rows), MIND's retrieval of one user over 1M
    candidates (the first 1M item embeddings) against the same scores in
    float64, DIN's bulk scoring of one user's history against 1M
    candidates in chunks of 8,192, its first 8,192 against one
    din_forward call."""
    import torch

    from repro_torch import device
    from repro_torch.data import synthetic
    from repro_torch.models import recsys

    g = device.generator(ZOO_SEED + 7)
    dev = device.resolve()
    with torch.no_grad():
        if arch == "wide-deep":
            ids, _ = synthetic.ctr_batch(g, ZOO_SERVE_BATCH, cfg.n_sparse,
                                         cfg.vocab_per_field)
            logits = recsys.widedeep_forward(model, ids, cfg)
            check(tuple(logits.shape) == (ZOO_SERVE_BATCH,) and bool(
                torch.all(torch.isfinite(logits))), "wide-deep serve_p99")
            return dict(serve_batch=ZOO_SERVE_BATCH, serve_ms=time_ms(
                lambda: recsys.widedeep_forward(model, ids, cfg), reps=20))
        if arch == "mind":
            hist = torch.randint(0, cfg.item_vocab, (1, cfg.hist_len),
                                 generator=g, device=dev)
            cand = model.item_table[:ZOO_CANDIDATES]
            n = cand.shape[0]
            scores = recsys.mind_retrieve(model, hist, cand, cfg)
            u = recsys.mind_interests(model, hist, cfg).double()
            want = torch.amax(torch.einsum("bie,ne->bin", u, cand.double()),
                              dim=1)
            err = float((scores.double() - want).abs().max())
            scale = float(want.abs().max())
            check(tuple(scores.shape) == (1, n) and err <= 1e-5 * scale,
                  f"mind_retrieve: error {err} against float64 at scale "
                  f"{scale}")
            return dict(candidates=n, max_abs_err_vs_f64=err,
                        scale=scale, retrieve_ms=time_ms(
                            lambda: recsys.mind_retrieve(model, hist, cand,
                                                         cfg), reps=10))
        hist = torch.randint(0, cfg.item_vocab, (cfg.hist_len,), generator=g,
                             device=dev)
        cand = torch.randint(0, cfg.item_vocab, (ZOO_CANDIDATES,),
                             generator=g, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scores = recsys.din_score_candidates(model, hist, cand, cfg)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        chunk = 8192
        first = recsys.din_forward(model, hist[None].expand(chunk, -1),
                                   cand[:chunk], cfg)
        n = ZOO_CANDIDATES // chunk * chunk
        check(tuple(scores.shape) == (n,) and bool(
            torch.all(torch.isfinite(scores)))
            and torch.equal(scores[:chunk], first),
            "din_score_candidates: shape, finiteness or its first chunk")
        return dict(candidates=ZOO_CANDIDATES, scored=n, chunk=chunk,
                    score_ms=ms)


@contextlib.contextmanager
def _timed_steps(train_state, into: list):
    """Inside the block, every train step that ``train_state.make_train_step``
    builds is timed on the host clock, the card synchronised before and
    after, and its ms appended to ``into``."""
    import torch

    real = train_state.make_train_step

    def make(*args, **kwargs):
        step = real(*args, **kwargs)

        def timed(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(*a, **k)
            torch.cuda.synchronize()
            into.append((time.perf_counter() - t0) * 1e3)
            return out
        return timed

    train_state.make_train_step = make
    try:
        yield
    finally:
        train_state.make_train_step = real


def _zoo_batch_ms(arch: str, cfg, batch: int) -> list:
    """ms of each of ZOO_BATCH_CALLS calls of the launcher's batch maker for
    ``arch`` at ``batch`` (host clock, synchronised; the maker built
    first, so GraphSAGE's graph and its one feature upload are left out)."""
    import torch

    from repro_torch import configs, device
    from repro_torch.launch import train as launch

    make = launch.make_batch_fn(cfg, configs.get(arch).family, batch)
    g = device.generator(ZOO_SEED + 11)
    ms = []
    for _ in range(ZOO_BATCH_CALLS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        b = make(g)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        del b
    return ms


def _zoo_launcher(arch: str) -> dict:
    """``launch.train`` at the architecture's full config: the job straight
    (ZOO_LAUNCH_STEPS steps of ZOO_LAUNCH[arch]), then stopped after
    ZOO_STOP_AFTER with a checkpoint under build/ and resumed, under
    deterministic algorithms. Held: the resumed final loss within
    ZOO_RESUME_RTOL of the straight run's and its parameters bit-equal to
    the straight run's (MIND's loss barely moves in a few steps, so the
    loss alone cannot tell a wrong restore), every loss finite, no kernel
    launched; the checkpoint's bytes and the save / restore ms reported,
    and the recommenders' serving calls on the straight run's model
    (``_zoo_ranker_extra``). The straight run's steps are timed without
    their batches (host clock, synchronised; the first holds the warm-up),
    and the batch maker alone (``_zoo_batch_ms``)."""
    import shutil
    import zipfile

    import torch

    from repro_torch import configs
    from repro_torch.bench import common
    from repro_torch.launch import train as launch
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training import optimizer as opt_lib

    cfg = configs.get(arch).make_config()
    batch = ZOO_LAUNCH[arch]
    d = Path(__file__).resolve().parent / "build" / "zoo_ckpt" / arch
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    kw = dict(steps=ZOO_LAUNCH_STEPS, batch=batch, full=True, seed=ZOO_SEED,
              log_every=ZOO_LAUNCH_STEPS)
    io_ms, launches, out, step_ms = {}, {}, {}, []
    t_all = time.perf_counter()
    try:
        with common.deterministic(), _counted(launches):
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            with _timed_steps(launch.ts, step_ms):
                state_a, hist_a = launch.train(arch, ckpt_dir=None, **kw)
            torch.cuda.synchronize()
            out["straight_s"] = time.perf_counter() - t0
            out["step_ms"] = step_ms
            out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
            out["num_params"] = sum(p.numel()
                                    for p in state_a.params.parameters())
            out["batch_ms"] = _zoo_batch_ms(arch, cfg, batch)
            if arch != "graphsage-reddit":
                out.update(_zoo_ranker_extra(arch, state_a.params, cfg))
            want = {k: v.detach().clone() for k, v in
                    opt_lib.named_leaves(state_a.params).items()}
            del state_a
            torch.cuda.empty_cache()
            with _timed_calls(ckpt, ("save", "restore"), io_ms):
                t0 = time.perf_counter()
                _, hist_c = launch.train(arch, ckpt_dir=str(d),
                                         stop_after=ZOO_STOP_AFTER, **kw)
                out["stopped_s"] = time.perf_counter() - t0
                out["checkpoint_bytes"] = sum(
                    f.stat().st_size
                    for f in (d / f"step_{ZOO_STOP_AFTER:010d}").iterdir())
                torch.cuda.empty_cache()
                t0 = time.perf_counter()
                state_b, hist_b = launch.train(arch, ckpt_dir=str(d), **kw)
                torch.cuda.synchronize()
                out["resumed_s"] = time.perf_counter() - t0
        got = opt_lib.named_leaves(state_b.params)
        out["params_bit_equal"] = got.keys() == want.keys() and all(
            torch.equal(got[k], v) for k, v in want.items())
        del state_b, got, want
    finally:
        shutil.rmtree(d, ignore_errors=True)
        torch.cuda.empty_cache()
    check(len(hist_a) == ZOO_LAUNCH_STEPS and len(hist_c) == ZOO_STOP_AFTER
          and len(hist_b) == ZOO_LAUNCH_STEPS - ZOO_STOP_AFTER,
          f"{arch} launcher step counts {len(hist_a)}, {len(hist_c)}, "
          f"{len(hist_b)}")
    check(all(math.isfinite(v) for v in hist_a + hist_c + hist_b),
          f"{arch} launcher losses {hist_a} {hist_c} {hist_b}")
    rel = abs(hist_b[-1] - hist_a[-1]) / abs(hist_a[-1])
    check(rel <= ZOO_RESUME_RTOL, f"{arch}: the resumed final loss "
          f"{hist_b[-1]} is {rel} from the straight run's {hist_a[-1]}")
    check(out["params_bit_equal"], f"{arch}: the resumed run's parameters "
          "differ from the straight run's")
    _expect(f"{arch} launcher", launches, {})
    return dict(batch=batch, steps=ZOO_LAUNCH_STEPS,
                stop_after=ZOO_STOP_AFTER, losses_straight=hist_a,
                losses_stopped=hist_c, losses_resumed=hist_b,
                final_rel_diff=rel, deterministic=True,
                save_ms=io_ms.get("save"), restore_ms=io_ms.get("restore"),
                seconds=time.perf_counter() - t_all, **out)


def phase_zoo(smi: str) -> tuple[dict, dict, dict]:
    """The model zoo on the port at the configs' full widths: GraphSAGE's
    minibatch training on minibatch_lg's graph, the paper's index on its
    embeddings (gnn_index), full-graph and graph-batch training on
    full_graph_sm's and molecule's sizes under mean and max, and every zoo
    architecture through ``launch.train`` with a resume. Returns (kernel
    rows, errors, the main path's launches: gnn_index's)."""
    import gc

    import torch

    from repro_torch import configs, device
    from repro_torch.configs import base
    from repro_torch.data import graph as graph_lib

    dev = device.resolve()
    t_all = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    errs: dict = {}
    spec = configs.get("graphsage-reddit")
    cfg = spec.config_for_shape("minibatch_lg")
    p = base.GNN_SHAPES["minibatch_lg"].params
    t0 = time.perf_counter()
    graph = graph_lib.synthetic_graph(ZOO_SEED, p["n_nodes"], ZOO_AVG_DEGREE,
                                      cfg.d_in, num_classes=cfg.num_classes)
    build_s = time.perf_counter() - t0
    feats = torch.from_numpy(graph.feats).to(dev)
    graph_info = dict(nodes=graph.num_nodes, edges=graph.num_edges,
                      shape_edges=p["n_edges"], avg_degree=ZOO_AVG_DEGREE,
                      d_feat=cfg.d_in, build_s=build_s)
    t0 = time.perf_counter()
    model, minibatch = _zoo_minibatch(graph, feats, cfg)
    minibatch["seconds"] = time.perf_counter() - t0
    index, rows, launches = _zoo_gnn_index(model, graph, feats, cfg, errs)
    del model, feats, graph
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    small = _zoo_small(spec)
    small["seconds"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    launcher = {}
    for arch in ZOO_LAUNCH:
        launcher[arch] = _zoo_launcher(arch)
        gc.collect()
        torch.cuda.empty_cache()
    for name in ZOO_KERNELS:
        check(launches.get(name, 0) > 0, f"kernel {name} was not launched "
              "on the zoo path")
    full = {a: configs.get(a).make_config() for a in ZOO_LAUNCH}
    emit("zoo", graph=graph_info, config=dict(
        graphsage=dict(d_in=cfg.d_in, d_hidden=cfg.d_hidden,
                       layers=cfg.num_layers, classes=cfg.num_classes,
                       aggregator=cfg.aggregator,
                       fanout=list(cfg.sample_sizes)),
        **{a: {k: v for k, v in c._asdict().items()
               if k not in ("dtype", "param_dtype", "name")}
           for a, c in full.items() if a != "graphsage-reddit"}),
        gnn_minibatch=minibatch, gnn_index=index, gnn_small=small,
        launcher=launcher, kernels=rows, max_abs_err=errs,
        launches=launches,
        cuts=dict(
            gnn_minibatch=f"{ZOO_GNN_STEPS} steps",
            graph=f"{graph_info['edges']} edges from the generator at "
                  f"average degree {ZOO_AVG_DEGREE} (the shape's "
                  f"{p['n_edges']})",
            gnn_small=f"{ZOO_SMALL_STEPS} steps each; full_graph_sm's "
                      "edges are the generator's at the shape's average "
                      "degree",
            launcher=f"{ZOO_LAUNCH_STEPS} steps, stopped at "
                     f"{ZOO_STOP_AFTER}; MIND at batch {ZOO_LAUNCH['mind']} "
                     "(its (B, I, B) float32 scores are 68.7 GB at "
                     "train_batch's 65,536)",
            weights="seeded init"),
        seconds=time.perf_counter() - t_all, card=smi)
    return rows, errs, launches


# -- dryrun ------------------------------------------------------------------


@contextlib.contextmanager
def _kernel_spies(into: dict, names):
    """Inside the block, the operands (positional and keyword) of the last
    call of each kernel of ``names`` at each shape of its first operand,
    in ``into[(name, shape)]``: tensors up to DRY_COPY_BYTES copied,
    larger ones (an embedding table the optimizer then updates in place)
    kept by reference: the kernel and its plain version read the same
    tensor either way."""
    import torch

    from repro_torch.kernels import ops

    real = {name: getattr(ops, name) for name in names}

    def keep(a):
        if torch.is_tensor(a):
            small = a.numel() * a.element_size() <= DRY_COPY_BYTES
            return a.detach().clone() if small else a.detach()
        return a

    def spy(name):
        def wrapped(*args, **kwargs):
            into[(name, tuple(args[0].shape))] = (
                tuple(map(keep, args)),
                {k: keep(v) for k, v in kwargs.items()})
            return real[name](*args, **kwargs)
        return wrapped

    for name in names:
        setattr(ops, name, spy(name))
    try:
        yield
    finally:
        for name, fn in real.items():
            setattr(ops, name, fn)


def _hold_spied(phase: str, seen: dict, errs: dict) -> dict:
    """Each kernel a phase's spies saw (``_kernel_spies``) against its
    plain version on the operands of its last call at each shape: the
    scans bit for bit, fused_lut within LUT_RTOL, embedding_bag within
    BAG_RTOL (empty bags exact zeros), gcd_score, givens_rotate and
    pq_assign as ``_hold_rotation_kernels``. Returns the shapes held by
    kernel and pq_assign's flips."""
    import inspect

    import torch

    from repro_torch.kernels import ops, ref

    rot, held, fails = {}, {}, []
    for (name, shape), (args, kwargs) in sorted(seen.items(),
                                                key=lambda kv: kv[0]):
        at = f"{phase}_{'x'.join(map(str, shape))}"
        tag = f"{name}/{at}"
        bound = inspect.signature(getattr(ops, name)).bind(*args, **kwargs)
        a = bound.arguments
        held.setdefault(name, []).append(list(shape))
        if name in ("gcd_score", "givens_rotate", "pq_assign"):
            rot[(name, shape)] = bound.args
        elif name == "embedding_bag":
            got = ops.embedding_bag(*args, **kwargs)
            want = ref.embedding_bag_ref(*bound.args)
            idx, bags = a["indices"], a["bag_ids"]
            valid = torch.zeros(a["num_bags"], dtype=torch.bool,
                                device=idx.device)
            valid[bags[idx >= 0].long()] = True
            errs[tag] = _bag_error(got, want, valid)
        elif name == "fused_lut":
            _hold_fused_lut(at, a["Q"], a["qdelta"], a["cb_flat"],
                            a["colmap"], errs, {}, fails)
        else:
            plain = getattr(ref, f"{name}_ref")
            errs[tag] = bit_equal(getattr(ops, name)(*args, **kwargs),
                                  plain(**a), f"{name} at {shape}")
    check(not fails, f"{phase}: {fails}")
    flips = _hold_rotation_kernels(phase, rot, errs)["pq_assign_flips"]
    return dict(shapes=held, pq_assign_flips=flips)


def _dry_launches(rec: dict) -> dict:
    """The launches a record's runs imply: each run's launches a call ×
    its calls."""
    out: dict = {}
    for p in rec["measured_at"]:
        for k, v in p["launches"].items():
            out[k] = out.get(k, 0) + v * p["calls"]
    return out


def _dry_record(arch: str, shape: str, dev, seen: dict, launches: dict,
                plan=None) -> dict:
    """``launch.dryrun.run_cell`` on the card with the kernels spied and
    counted; held: the record ok, complete (every JAX key, measured or
    reckoned with the reason), model_flops_total the cell's, the launches
    its runs imply exactly. The record prints on its own line."""
    from repro_torch.launch import cells, dryrun

    got: dict = {}
    with _kernel_spies(seen, DRY_KERNELS), _counted(got):
        rec = dryrun.run_cell(arch, shape, device=dev, plan=plan,
                              verbose=False)
    check(rec["ok"], f"dryrun {arch} × {shape}: {rec.get('error')}\n"
          f"{rec.get('traceback')}")
    for k in ("arch", "shape", "mesh", "ok", "kind", "n_chips", "fits_hbm",
              "report", "measured_at", "reduced", "step_s"):
        check(k in rec, f"dryrun {arch} × {shape}: no {k!r}")
    for k in ("flops_per_device", "bytes_per_device", "loop_trips",
              "collective_bytes", "compute_s", "memory_s", "collective_s",
              "dominant", "roofline_fraction", "memory", "model_flops_total",
              "useful_compute_ratio"):
        check(k in rec["report"], f"dryrun {arch} × {shape}: no report "
              f"key {k!r}")
    check(rec["measured_at"] or rec["reduced"],
          f"dryrun {arch} × {shape}: neither measured nor reckoned")
    check(rec["report"]["model_flops_total"]
          == cells.build_cell(arch, shape, smoke=dev.type != "cuda"
                              ).meta["model_flops"],
          f"dryrun {arch} × {shape}: model_flops_total")
    _expect(f"dryrun {arch} × {shape}", got, _dry_launches(rec))
    for k, v in got.items():
        launches[k] = launches.get(k, 0) + v
    emit("dryrun_record", **{k: v for k, v in rec.items()
                             if k != "traceback"})
    return rec


def phase_dryrun(smi: str) -> tuple[dict, dict]:
    """The launch layer on the card (``launch.cells``, ``launch.dryrun``):
    olmo-1b × train_4k at DRY_MICRO sequences a microbatch and the cell's
    accumulation of 8, DRY_STEPS steps at full depth and at DRY_DEPTHS, the
    extrapolation to 16 layers held within DRY_HELD of the measurement in
    peak bytes and in the fastest step's microbatch time; the records of two-tower-retrieval
    × train_batch (at DRY_TT_BATCHES) and of DRY_RECORDS, each complete,
    its launches exact, and every kernel the cells launched held against
    its plain version on the operands of its last call at each shape.
    Returns (errors, the phase's launches)."""
    import torch

    from repro_torch import device
    from repro_torch.launch import cells, dryrun
    from repro_torch.roofline import analysis

    dev = device.resolve()
    t_all = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    errs: dict = {}
    total = torch.cuda.get_device_properties(0).total_memory
    emit("dryrun_memory", chip_hbm_bytes=analysis.CHIP_HBM_BYTES,
         total_memory_bytes=total)
    # the extrapolation against a cell that fits whole at a cut microbatch
    cell = cells.build_cell("olmo-1b", "train_4k")
    A, L = cell.meta["accum"], cell.meta["depth"]
    olmo: dict = {}
    with _counted(olmo):
        t0 = time.perf_counter()
        whole = dryrun.measure(cell, None, DRY_MICRO, A, dev, DRY_STEPS)
        cut = [dryrun.measure(cell, d, DRY_MICRO, A, dev, DRY_STEPS)
               for d in DRY_DEPTHS]
        olmo_s = time.perf_counter() - t0
    _expect("dryrun olmo-1b train_4k", olmo, {})
    # the fastest of DRY_STEPS steps at each depth: a step at 8,192 tokens
    # a microbatch waits on the shared host by up to 6% on an H100 (a
    # depth-4 step 3.27-3.48 s), and the fit from depths 2 and 4 to 16
    # multiplies the error of the slope by 7
    for p in (whole, *cut):
        p["micro_best_s"] = min(p["micro_s_all"])
    x_peak = dryrun.extrapolate(cut, "peak_bytes", L, DRY_MICRO)
    x_micro = dryrun.extrapolate(cut, "micro_best_s", L, DRY_MICRO)
    d_peak = x_peak / whole["peak_bytes"] - 1.0
    d_micro = x_micro / whole["micro_best_s"] - 1.0
    emit("dryrun_extrapolation", cell="olmo-1b × train_4k",
         microbatch=DRY_MICRO, accum=A, depths=list(DRY_DEPTHS), depth=L,
         measured=dict(peak_bytes=whole["peak_bytes"],
                       micro_best_s=whole["micro_best_s"],
                       micro_s=whole["micro_s"],
                       micro_s_all=whole["micro_s_all"],
                       step_s=whole["step_s"], flops=whole["flops"]),
         extrapolated=dict(peak_bytes=x_peak, micro_best_s=x_micro,
                           micro_s=dryrun.extrapolate(cut, "micro_s", L,
                                                      DRY_MICRO),
                           flops=dryrun.extrapolate(cut, "flops", L,
                                                    DRY_MICRO)),
         rel_peak=d_peak, rel_micro=d_micro, held=DRY_HELD,
         runs=[{k: v for k, v in p.items() if k != "step_s_all"}
               for p in cut], seconds=olmo_s)
    check(abs(d_peak) <= DRY_HELD, f"dryrun olmo-1b: peak extrapolated "
          f"{x_peak} against {whole['peak_bytes']} measured ({d_peak:+.3f})")
    check(abs(d_micro) <= DRY_HELD, f"dryrun olmo-1b: microbatch "
          f"extrapolated {x_micro} s against {whole['micro_best_s']} s "
          f"measured ({d_micro:+.3f})")
    launches: dict = {}
    records = {}
    held: dict = dict(shapes={}, pq_assign_flips={})
    plan = dryrun.Plan((None,), DRY_TT_BATCHES, 1, 1,
                       f"batch 65536 -> {DRY_TT_BATCHES}")
    for arch, shape in (("two-tower-retrieval", "train_batch"),
                        *DRY_RECORDS):
        seen: dict = {}
        records[f"{arch}/{shape}"] = _dry_record(
            arch, shape, dev, seen, launches,
            plan=plan if shape == "train_batch" else None)
        # held before the next cell: a spied operand kept by reference
        # (the two-tower item table, 10.2 GB) would count in its peak
        h = _hold_spied("dryrun", seen, errs)
        for name, shapes in h["shapes"].items():
            held["shapes"].setdefault(name, []).extend(shapes)
        held["pq_assign_flips"].update(h["pq_assign_flips"])
        del seen, h
        gc.collect()
        torch.cuda.empty_cache()
    grok = records["grok-1-314b/long_500k"]
    check(not grok["fits_hbm"] and grok["reduced"]
          and len(grok["measured_at"]) >= 2,
          f"dryrun grok-1 long_500k: fits {grok['fits_hbm']}, reduced "
          f"{grok['reduced']}")
    for name in DRY_KERNELS:
        check(launches.get(name, 0) > 0, f"kernel {name} was not launched "
              "on the dryrun path")
    emit("dryrun", records={k: dict(
        fits_hbm=r["fits_hbm"], step_s=r["step_s"],
        peak_bytes=r["report"]["memory"]["peak_bytes"],
        peak_from=r["peak_from"], flops=r["report"]["flops_per_device"],
        model_flops=r["report"]["model_flops_total"],
        useful=r["report"]["useful_compute_ratio"],
        dominant=r["report"]["dominant"], reduced=r["reduced"])
        for k, r in records.items()}, launches=launches, held=held,
         max_abs_err=errs, seconds=time.perf_counter() - t_all, card=smi)
    return errs, launches


# -- tooling ------------------------------------------------------------------


def _tool_rotation(errs: dict) -> tuple[dict, dict]:
    """14c: one GCD-G step of a stacked (L, n, n) bf16 rotation from the
    identity through ``training.optimizer``: the learner state's R in the
    leaf's dtype and bit-equal to the leaf, the accumulators float32, R
    moved and orthogonal within lm_orth_bound(1); gcd_score and
    givens_rotate launched once a layer and held at the step's shapes.
    Returns (report, launches)."""
    import torch

    from repro_torch import device, rotations
    from repro_torch.training import optimizer as opt_lib

    dev = device.resolve()
    L, n = TOOL_ROT
    eye = torch.eye(n, device=dev).expand(L, n, n)
    params = {"kvq": {"rot_k": eye.to(torch.bfloat16).clone()}}
    g = device.generator(TOOL_SEED, dev)
    grads = {"kvq/rot_k": torch.randn((L, n, n), generator=g, device=dev)
             .to(torch.bfloat16)}
    cfg = opt_lib.OptimizerConfig(rotation=rotations.RotationConfig(
        learner="gcd", method="greedy", lr=1e-2))
    state = opt_lib.init(params, cfg)
    check(state.rot["kvq/rot_k"].R.dtype == torch.bfloat16,
          "14c: a bf16 rotation's fresh learner state is not bf16")
    seen: dict = {}
    launches: dict = {}
    with _counted(launches), \
            _last_call("gcd_score", seen, by_shape=True), \
            _last_call("givens_rotate", seen, by_shape=True):
        _, state = opt_lib.update(grads, state, params, cfg)
    _expect("tooling 14c", launches, {"gcd_score": L, "givens_rotate": L})
    st, leaf = state.rot["kvq/rot_k"], params["kvq"]["rot_k"]
    check(st.R.dtype == leaf.dtype == torch.bfloat16
          and st.accum.dtype == st.accum2.dtype == torch.float32,
          f"14c: state dtypes R {st.R.dtype}, accum {st.accum.dtype}")
    check(torch.equal(st.R, leaf) and st.R.data_ptr() != leaf.data_ptr(),
          "14c: the learner state's R is not bit-equal to the leaf")
    moved = float((leaf.float() - eye).abs().max())
    orth = max(float(rotations.orthogonality_error(r.float()))
               for r in leaf)
    check(moved > 0 and orth <= lm_orth_bound(1),
          f"14c: R moved {moved}, orthogonality {orth} against "
          f"{lm_orth_bound(1)}")
    held = _hold_rotation_kernels("tooling", seen, errs)
    return dict(layers=L, n=n, state_R_dtype=str(st.R.dtype),
                state_equals_leaf=True, moved=moved, orthogonality=orth,
                bound=lm_orth_bound(1), held=held["shapes"]), launches


def _gc_grad(case: str, step: int, rank: int, dev):
    """A rank's gradient at a step, from TOOL_SEED: ``random`` its own,
    ``equal`` the same on every rank, its largest entry TOOL_GC_PEAK."""
    import torch

    from repro_torch import device

    who = 0 if case == "equal" else 1 + rank
    g = device.generator(TOOL_SEED + 1000 * step + 100 * who
                         + (50 if case == "equal" else 0), dev)
    x = torch.randn(TOOL_GC_SIZE, generator=g, device=dev)
    if case == "equal":
        x = torch.clamp(x, -2.5, 2.5)
        x[TOOL_GC_SIZE // 3] = TOOL_GC_PEAK
    return x


def _gc_reference(grads: list, errs: list, n: int):
    """The int8 error-feedback all-reduce of ``grads`` computed in one
    process from the formulas (no collective): the shared scale from the
    largest |g + err| over every rank, each rank's int8 codes, their sum
    in int8 (wrapping), the sum dequantized and each rank's new error."""
    import torch

    xf = [g.float() + e for g, e in zip(grads, errs)]
    amax = torch.max(torch.stack([torch.max(torch.abs(x)) for x in xf]))
    scale = torch.clamp(amax, min=1e-12) / amax.new_tensor(127.0)
    q = [torch.clamp(torch.round(x / (scale * n)), -127, 127)
         .to(torch.int8) for x in xf]
    total = q[0].clone()
    for qi in q[1:]:
        total += qi
    g_out = total.float() * scale * n
    return g_out, [x - qi.float() * scale * n for x, qi in zip(xf, q)]


def _gc_rank(rank: int, world: int, port: int, out: str,
             dev_type: str) -> None:
    """One gloo rank of the grad_compress check (spawned): each case's
    TOOL_GC_STEPS steps through ``make_compressed_crosspod_psum`` with
    error feedback, each step timed (synchronised) and held bit for bit
    against ``_gc_reference`` on the same device; the rank's report, with
    a digest of each step's sum, goes to ``out``."""
    import hashlib

    import torch
    import torch.distributed as dist

    from repro_torch.training import grad_compress as gc

    dev = torch.device(dev_type)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    try:
        f = gc.make_compressed_crosspod_psum()
        report = {}
        for case in ("random", "equal"):
            err = torch.zeros(TOOL_GC_SIZE, device=dev)
            ref_errs = [torch.zeros(TOOL_GC_SIZE, device=dev)
                        for _ in range(world)]
            steps = []
            for s in range(TOOL_GC_STEPS):
                grads = [_gc_grad(case, s, r, dev) for r in range(world)]
                sync()
                t0 = time.perf_counter()
                g_out, err = f(grads[rank], err)
                sync()
                ms = (time.perf_counter() - t0) * 1e3
                truth = sum(g.double() + e.double()
                            for g, e in zip(grads, ref_errs))
                want, ref_errs = _gc_reference(grads, ref_errs, world)
                peak = TOOL_GC_SIZE // 3
                steps.append(dict(
                    ms=ms, bit_equal=bool(torch.equal(g_out, want)
                                          and torch.equal(err,
                                                          ref_errs[rank])),
                    sha256=hashlib.sha256(
                        g_out.cpu().numpy().tobytes()).hexdigest(),
                    peak_out=float(g_out[peak]), peak_sum=float(truth[peak]),
                    max_abs_vs_float=float((g_out.double() - truth)
                                           .abs().max())))
            report[case] = steps
        with open(os.path.join(out, f"rank{rank}.json"), "w") as fh:
            json.dump(report, fh)
    finally:
        dist.destroy_process_group()


def _tool_grad_compress() -> dict:
    """``training.grad_compress`` over TOOL_GC_RANKS spawned gloo ranks on
    the one card: every step of both cases bit-equal to the one-process
    reference in every rank, the same sum on every rank, and the equal
    gradients' first sum wrapped at their peak (negative against a
    positive float sum), as the JAX package's int8 psum wraps. Returns the
    payload bytes and the per-step ms."""
    import shutil
    import socket

    import torch.multiprocessing as tmp

    from repro_torch import device

    dev = device.resolve()
    out = Path(__file__).resolve().parent / "build" / "grad_compress"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    t0 = time.perf_counter()
    ctx = tmp.start_processes(_gc_rank, args=(TOOL_GC_RANKS, port, str(out),
                                              dev.type),
                              nprocs=TOOL_GC_RANKS, join=False,
                              start_method="spawn")
    deadline = time.monotonic() + TOOL_GC_TIMEOUT
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.terminate()
            check(False, f"grad_compress: {TOOL_GC_RANKS} ranks did not "
                  f"finish in {TOOL_GC_TIMEOUT} s")
    seconds = time.perf_counter() - t0
    ranks = []
    for r in range(TOOL_GC_RANKS):
        with open(out / f"rank{r}.json") as fh:
            ranks.append(json.load(fh))
    shutil.rmtree(out, ignore_errors=True)
    for case in ("random", "equal"):
        for s in range(TOOL_GC_STEPS):
            rows = [rep[case][s] for rep in ranks]
            check(all(x["bit_equal"] for x in rows),
                  f"grad_compress {case} step {s}: a rank differs from "
                  "the one-process reference")
            check(len({x["sha256"] for x in rows}) == 1,
                  f"grad_compress {case} step {s}: the ranks' sums differ")
    first = ranks[0]["equal"][0]
    check(first["peak_sum"] > 0 > first["peak_out"],
          f"grad_compress: the equal gradients' peak {first['peak_sum']} "
          f"came back as {first['peak_out']}, not wrapped")
    ms = [x["ms"] for rep in ranks for case in rep.values() for x in case]
    return dict(ranks=TOOL_GC_RANKS, backend="gloo", elements=TOOL_GC_SIZE,
                payload_bytes=TOOL_GC_SIZE + 4,
                float32_bytes=4 * TOOL_GC_SIZE, steps=TOOL_GC_STEPS,
                step_ms={f"rank{r}/{case}": [x["ms"] for x in rep[case]]
                         for r, rep in enumerate(ranks) for case in rep},
                step_ms_p50=statistics.median(ms),
                wrap=dict(peak_sum=first["peak_sum"],
                          peak_out=first["peak_out"]),
                random_max_abs_vs_float=[
                    x["max_abs_vs_float"] for x in ranks[0]["random"]],
                seconds=seconds)


def _tool_gnn_small() -> dict:
    """The blocked aggregation against ``gnn.aggregate_edges_ref`` on the
    card, on a graph of TOOL_GNN_SMALL (nodes, edges, width) with ties
    (edges repeated) in blocks of TOOL_GNN_BLOCK_ROWS rows: the forward
    bit-equal, the gradient of h within TOOL_GNN_RTOL of the reference's
    largest entry, under mean and max."""
    import torch

    from repro_torch import device
    from repro_torch.models import gnn

    dev = device.resolve()
    N, E, d = TOOL_GNN_SMALL
    g = device.generator(TOOL_SEED + 5, dev)
    h0 = torch.randn((N, d), generator=g, device=dev)
    src = torch.randint(0, N, (E,), generator=g, device=dev)
    dst = torch.randint(0, N, (E,), generator=g, device=dev)
    src, dst = torch.cat([src, src[:E // 100]]), torch.cat([dst, dst[:E // 100]])
    cot = torch.randn((N, d), generator=g, device=dev)
    saved = gnn.CSR_BLOCK_ELEMS
    gnn.CSR_BLOCK_ELEMS = TOOL_GNN_BLOCK_ROWS * d
    out = {}
    try:
        plan = gnn.EdgePlan.from_edges(src, dst, N)
        blocks = (len(plan.blocks(d)), len(plan.transposed().blocks(d)))
        check(min(blocks) > 4, f"blocked gnn: only {blocks} blocks")
        for agg in ("mean", "max"):
            h1 = h0.clone().requires_grad_(True)
            h2 = h0.clone().requires_grad_(True)
            got = gnn.aggregate(h1, plan, agg)
            want = gnn.aggregate_edges_ref(h2, src, dst, N, agg)
            bit_equal(got, want, f"blocked gnn {agg} forward")
            c = torch.where(torch.isfinite(want), cot, 0.0)
            (g1,) = torch.autograd.grad(got, h1, c)
            (g2,) = torch.autograd.grad(want, h2, c)
            err = float((g1 - g2).abs().max())
            scale = float(g2.abs().max())
            check(err <= TOOL_GNN_RTOL * scale, f"blocked gnn {agg}: "
                  f"gradient {err} against {TOOL_GNN_RTOL} of {scale}")
            out[agg] = dict(forward_bit_equal=True, grad_max_abs=err,
                            grad_scale=scale)
    finally:
        gnn.CSR_BLOCK_ELEMS = saved
    return dict(nodes=N, edges=int(src.numel()), width=d, blocks=blocks,
                **out)


def _tool_ogb_products() -> dict:
    """graphsage-reddit × ogb_products whole through
    ``launch.dryrun.run_cell``: the ladder's first plan is the whole cell;
    TOOL_GNN_STEPS timed steps after the warm one, under deterministic
    algorithms, twice from one seed. Held: the record whole (fits_hbm,
    measured at the cell's own batch, nothing reduced), every loss finite,
    the two runs' losses bit-equal."""
    import torch

    from repro_torch import device
    from repro_torch.launch import cells, dryrun
    from repro_torch.roofline import analysis

    dev = device.resolve()
    cell = cells.build_cell("graphsage-reddit", "ogb_products",
                            smoke=dev.type != "cuda")
    meta = cell.meta
    ladder = dryrun.plans(cell, dryrun.PLAN_SHARE * analysis.CHIP_HBM_BYTES)
    check(ladder and ladder[0].why == "whole",
          f"ogb_products: the first plan is {ladder[:1]}, not whole")
    plan = dryrun.Plan((None,), (meta["batch"],), meta["accum"],
                       TOOL_GNN_STEPS, "whole")
    recs = []
    for _ in range(2):
        rec = dryrun.run_cell("graphsage-reddit", "ogb_products", device=dev,
                              verbose=False, plan=plan)
        check(rec["ok"], f"ogb_products: {rec.get('error')}\n"
              f"{rec.get('traceback')}")
        recs.append(rec)
        gc.collect()
        torch.cuda.empty_cache()
    rec = recs[0]
    (point,) = rec["measured_at"]
    losses = point["losses"]
    # the CPU rehearsal's record names its smoke config first
    cut = rec["reduced"][0 if dev.type == "cuda" else 1:]
    check(rec["fits_hbm"] and not cut and point["batch"] == meta["batch"],
          f"ogb_products: fits {rec['fits_hbm']}, reduced {rec['reduced']},"
          f" batch {point['batch']}")
    check(len(losses) == TOOL_GNN_STEPS + 1
          and all(math.isfinite(v) for v in losses),
          f"ogb_products: losses {losses}")
    again = recs[1]["measured_at"][0]["losses"]
    check(again == losses, f"ogb_products: two runs of one seed differ: "
          f"{losses} / {again}")
    emit("tooling_ogb_products_record",
         **{k: v for k, v in rec.items() if k != "traceback"})
    return dict(nodes=meta["batch"], edges=meta["edges"], losses=losses,
                losses_again=again, peak_gb=point["peak_bytes"] / 1e9
                if point["peak_bytes"] is not None else None,
                reckoned_peak_gb=rec["reckoned_peak_bytes"] / 1e9,
                step_s=rec["step_s"], step_s_all=point["step_s_all"],
                step_s_again=recs[1]["measured_at"][0]["step_s_all"],
                fits_hbm=rec["fits_hbm"], peak_from=rec["peak_from"],
                flops=rec["report"]["flops_per_device"],
                memory_s=rec["report"]["memory_s"])


def _tool_examples(errs: dict) -> tuple[dict, dict]:
    """The three examples at their JAX scripts' defaults through their
    ``main``: quickstart (``exact`` recall 1.0, GCD-G's final distortion
    below frozen's, ‖RᵀR − I‖ ≤ TOOL_ORTH for every learner), serve_ann
    (no new executable after the refresh, refresh_mismatch ≤
    TOOL_REFRESH_MISMATCH, recall after the refresh printed beside
    before), train_twotower straight and resumed from its step-300
    checkpoint (the same loss and p@50, bit for bit); every kernel of
    EXAMPLE_KERNELS launched, and every kernel held at each shape it was
    launched at. Returns (report, launches)."""
    import shutil

    from repro_torch.examples import quickstart, serve_ann, train_twotower
    from repro_torch.kernels import ops

    ckpt = Path(__file__).resolve().parent / "build" / "twotower_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    seen: dict = {}
    launches: dict = {}
    seconds = {}
    with _kernel_spies(seen, tuple(ops.LAUNCHES)), _counted(launches):
        t0 = time.perf_counter()
        q = quickstart.main([])
        seconds["quickstart"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        sa = serve_ann.main([])
        seconds["serve_ann"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        tt = train_twotower.main(["--ckpt-dir", str(ckpt)])
        seconds["train_twotower"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        again = train_twotower.main(["--ckpt-dir", str(ckpt)])
        seconds["train_twotower_resumed"] = time.perf_counter() - t0
    shutil.rmtree(ckpt, ignore_errors=True)
    check(q["backends"]["exact"]["recall"] == 1.0,
          f"quickstart: exact recall {q['backends']['exact']['recall']}")
    check(q["learners"]["gcd_greedy"]["distortion_last"]
          < q["learners"]["frozen"]["distortion_last"],
          f"quickstart: GCD-G {q['learners']['gcd_greedy']} against frozen "
          f"{q['learners']['frozen']}")
    for name, r in q["learners"].items():
        check(r["orthogonality_error"] <= TOOL_ORTH,
              f"quickstart {name}: ‖RᵀR − I‖ {r['orthogonality_error']}")
    r = sa["refresh"]
    check(r["executables_after"] == r["executables_before"],
          f"serve_ann: executables {r['executables_before']} -> "
          f"{r['executables_after']} after the refresh")
    check(r["refresh_mismatch"] <= TOOL_REFRESH_MISMATCH,
          f"serve_ann: refresh_mismatch {r['refresh_mismatch']}")
    last = tt["steps_run"] // tt["ckpt_every"] * tt["ckpt_every"]
    check(again["resumed_from"] == last, f"train_twotower: resumed from "
          f"{again['resumed_from']}, not {last}")
    check(again["final_loss"] == tt["final_loss"]
          and again["p_at_50"] == tt["p_at_50"],
          f"train_twotower: straight loss {tt['final_loss']} p@50 "
          f"{tt['p_at_50']}, resumed {again['final_loss']} "
          f"{again['p_at_50']}")
    for name in EXAMPLE_KERNELS:
        check(launches.get(name, 0) > 0, f"kernel {name} was not launched "
              "on the examples path")
    held = _hold_spied("examples", seen, errs)
    return dict(quickstart=q, serve_ann=sa, train_twotower=tt,
                train_twotower_resumed=again, seconds=seconds,
                held=held), launches


def phase_tooling(smi: str) -> tuple[dict, dict]:
    """The rest of queue 1 on the card: 14c (a bf16 rotation's learner
    state), grad_compress over two gloo ranks, graphsage-reddit ×
    ogb_products trained whole through the blocked aggregation (and the
    blocked path against its reference on a small graph), and the three
    examples at their JAX defaults. Returns (errors, launches by path:
    ``tooling`` the 14c step's, ``examples`` the examples')."""
    import torch

    t_all = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    errs: dict = {}
    seconds = {}
    t0 = time.perf_counter()
    rot, rot_launches = _tool_rotation(errs)
    seconds["bf16_rotation"] = time.perf_counter() - t0
    emit("tooling_bf16_rotation", **rot)
    t0 = time.perf_counter()
    emit("tooling_grad_compress", **_tool_grad_compress())
    seconds["grad_compress"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    emit("tooling_gnn_blocked", **_tool_gnn_small())
    ogb = _tool_ogb_products()
    seconds["ogb_products"] = time.perf_counter() - t0
    emit("tooling_ogb_products", **ogb)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ex, ex_launches = _tool_examples(errs)
    seconds["examples"] = time.perf_counter() - t0
    emit("tooling_examples", **ex)
    emit("tooling", launches=dict(tooling=rot_launches,
                                  examples=ex_launches),
         max_abs_err=errs, seconds=seconds,
         total_s=time.perf_counter() - t_all, card=smi)
    return errs, dict(tooling=rot_launches, examples=ex_launches)


# -- sharded ----------------------------------------------------------------


def _shard_scanned(state, QR, nprobe: int):
    """Rows each shard's probe window visits a query, from its offsets:
    (S, b), the same probed lists on every shard (the shared coarse)."""
    import torch

    from repro_torch.index import search as index_search

    lists, _ = index_search.probe(state.shards[0], QR, nprobe)
    out = []
    for part in state.shards:
        offs = part.list_offsets.long()
        nb = (offs[lists + 1] - offs[lists]) // part.block_size
        out.append(torch.clamp(nb, max=state.max_blocks).sum(dim=1)
                   * part.block_size)
    return torch.stack(out)


def _same(got, want) -> tuple[float, float]:
    """Shares of equal ids and of bit-equal scores of two results."""
    ids = float((got.ids == want.ids).float().mean())
    scores = float((got.scores == want.scores).float().mean())
    return ids, scores


def _shard_kernel_rows(state, index, X, Q, errs) -> dict:
    """ivf_adc, adc_lookup and pq_assign at shard 0's shapes (the four
    shards' are one shape) beside their plain versions, bounds and library
    calls, and the four shards' scans of a batch beside the single index's
    one: serve_p99 (b = 512, nprobe 32), the flat check's 64 queries, and
    one shard's k-means assign of the coarse fit (TRAIN / S rows)."""
    import torch

    from repro_torch.index import search as index_search
    from repro_torch.kernels import ops, ref

    rows = {}
    part = state.shards[0]
    codes, ids = part.codes, part.ids
    QR = Q[:BATCHES[0]] @ index.R
    lut = index_search.build_luts(index.quantizer, QR)
    scheds = []
    for p in (*state.shards, index):
        mb = state.max_blocks if p is not index else index.max_list_blocks()
        sch = index_search.scan_schedule(p, QR, nprobe=SERVE_NPROBE,
                                         max_blocks=mb)
        scheds.append((p, sch.block_idx, sch.block_query))
    _, bi, bq = scheds[0]
    errs["ivf_adc/sharded_serve_p99"] = bit_equal(
        ops.ivf_adc(lut, codes, bi, bq, None, ids, block_size=BS),
        ref.ivf_adc_ref(lut, codes, bi, bq, block_size=BS, ids=ids),
        "ivf_adc at a shard's serve_p99 schedule")
    work = ivf_work(lut, None, codes, ids, bi, BS)
    rows["ivf_adc"] = dict(
        shape=dict(b=BATCHES[0], nprobe=SERVE_NPROBE, S=work["S"],
                   cap=part.capacity, max_blocks=state.max_blocks),
        ms=graph_ms(lambda: ops.ivf_adc(lut, codes, bi, bq, None, ids,
                                        block_size=BS), launches=20),
        plain_ms=graph_ms(lambda: ref.ivf_adc_ref(
            lut, codes, bi, bq, block_size=BS, ids=ids), launches=2),
        library_ms=graph_ms(ivf_library(lut, codes, bi, bq, BS),
                            launches=5), **work)

    def scans(which):
        for p, b_i, b_q in which:
            ops.ivf_adc(lut, p.codes, b_i, b_q, None, p.ids, block_size=BS)

    rows["ivf_adc"]["all_shards_ms"] = graph_ms(
        lambda: scans(scheds[:-1]), launches=10)
    rows["ivf_adc"]["single_index_ms"] = graph_ms(
        lambda: scans(scheds[-1:]), launches=10)

    QRf = Q[:FLAT_QUERIES] @ index.R
    lutf = index_search.build_luts(index.quantizer, QRf)
    errs["adc_lookup/sharded_flat"] = bit_equal(
        ops.adc_lookup(lutf, codes, None, ids),
        ref.adc_lookup_ref(lutf, codes, None, ids),
        "adc_lookup at a shard's flat scan")
    tiles = torch.arange(part.capacity // BS, device=codes.device)
    nbytes = _scan_bytes(lutf, None, codes, ids, tiles, BS,
                         FLAT_QUERIES * part.capacity, 0)
    flops = FLAT_QUERIES * int(torch.sum(ids >= 0)) * D
    rows["adc_lookup"] = dict(
        shape=dict(b=FLAT_QUERIES, Dp=D, K=K, N=part.capacity),
        ms=graph_ms(lambda: ops.adc_lookup(lutf, codes, None, ids),
                    launches=20),
        plain_ms=graph_ms(lambda: ref.adc_lookup_ref(lutf, codes, None, ids),
                          launches=2),
        library_ms=graph_ms(flat_library(lutf, codes), launches=5),
        bytes=nbytes, flops=flops, **_bound(nbytes, flops))

    # one shard's k-means assign: its TRAIN / S rows of the coarse fit's
    # sample (the head of the first chunk) against the L centroids
    Xs = (X[:TRAIN // SHARDS] @ index.R).contiguous()
    C = index.centroids[None].contiguous()
    got, want = ops.pq_assign(Xs, C), ref.pq_assign_ref(Xs, C)
    flips = _assign_flips(Xs, C, got, want)
    errs["pq_assign/sharded_kmeans"] = flips["max_abs_gap"]
    m, n = Xs.shape
    nbytes = m * n * 4 + L * n * 4 + m * 4
    flops = 2 * m * n * L
    rows["pq_assign"] = dict(
        shape=dict(m=m, n=n, D=1, K=L, sub=n), flips=flips,
        ms=graph_ms(lambda: ops.pq_assign(Xs, C), launches=20),
        plain_ms=graph_ms(lambda: ref.pq_assign_ref(Xs, C), launches=2),
        library_ms=None, bytes=nbytes, flops=flops, **_bound(nbytes, flops))
    return rows


def phase_sharded(ctx: dict, smi: str) -> tuple[dict, dict]:
    """The row-sharded serving family on main's 1M-row index, SHARDS
    shards laid on SHARD_DEVICE (search.sharded, index.ivf's shard_split
    and build_sharded, the sharded k-means, sharded churn and
    shard_rebalance). Returns (errors, the path's launches)."""
    import numpy as np
    import torch

    from repro_torch import churn, device, rotations, search
    from repro_torch.churn import ops as churn_ops
    from repro_torch.index import ivf as index_ivf
    from repro_torch.launch.mesh import make_data_mesh
    from repro_torch.metrics import recall_at_k

    t_all = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    index, X, Q, R0 = ctx["index"], ctx["X"], ctx["Q"], ctx["R"]
    mesh = make_data_mesh(SHARDS, devices=(SHARD_DEVICE,) * SHARDS)
    ivf, flat = search.make("ivf"), search.make("flat_adc")
    sh_ivf = search.make("ivf_sharded", mesh=mesh)
    sh_flat = search.make("flat_sharded", mesh=mesh)
    errs, seen, own, side, sec, out = {}, {}, {}, {}, {}, {}

    def held(ok: bool, what: str) -> None:
        check(ok, f"sharded: {what}")

    with _kernel_spies(seen, SHARDED_KERNELS):
        # -- attach, and the twins against the single index -------------
        t0 = time.perf_counter()
        with _counted(own):
            st = sh_ivf.attach(index, mesh=mesh, nprobe=SERVE_NPROBE)
            st_flat = sh_flat.attach(index, mesh=mesh)
            torch.cuda.synchronize()
        sec["attach"] = time.perf_counter() - t0
        stats = sh_ivf.stats(st)
        held(stats["rows"] == N and stats["shards"] == SHARDS,
             f"attach: {stats['rows']} rows over {stats['shards']} shards")
        single = ivf.attach(index, nprobe=SERVE_NPROBE)
        parity, arm, equal = [], {}, {}
        t0 = time.perf_counter()
        runs = {}
        with _counted(arm):
            for p in NPROBES:
                lo = 0
                for b in BATCHES:
                    runs[(p, b, lo)] = sh_ivf.search(st, Q[lo:lo + b], k=10,
                                                    nprobe=p)
                    lo += b
            torch.cuda.synchronize()
        sec["ivf_parity"] = time.perf_counter() - t0
        for key, v in arm.items():
            own[key] = own.get(key, 0) + v
        _expect("the sharded ivf searches", {"ivf_adc": arm.get("ivf_adc")},
                {"ivf_adc": SHARDS * len(NPROBES) * len(BATCHES)})
        shares = []
        for (p, b, lo), got in runs.items():
            q = Q[lo:lo + b]
            want = ivf.search(single, q, k=10, nprobe=p)
            i_eq, s_eq = _same(got, want)
            per = _shard_scanned(st, q @ st.R, p)
            held(torch.equal(per.sum(dim=0).to(got.scanned.dtype),
                             got.scanned),
                 f"scanned at nprobe {p} b {b} is not the shards' windows")
            tot = float(got.scanned.float().mean())
            share = (per.float().mean(dim=1) / tot).tolist()
            shares.append(share)
            parity.append(dict(
                nprobe=p, b=b, ids_equal=i_eq, scores_equal=s_eq,
                scanned=tot, single_scanned=float(want.scanned.float()
                                                  .mean()),
                shard_share=share))
            held(torch.equal(got.ids, want.ids)
                 and torch.equal(got.scores, want.scores),
                 f"ivf_sharded at nprobe {p} b {b} differs from ivf "
                 f"(ids {i_eq}, scores {s_eq} equal)")
            held(tot >= parity[-1]["single_scanned"],
                 f"scanned {tot} below the single index's")
            held(max(abs(s - 1 / SHARDS) for s in share) <= SHARD_SHARE,
                 f"shard shares {share} at nprobe {p} b {b}")
        equal["ivf"] = parity

        qf = Q[:FLAT_QUERIES]
        fl = {}
        with _counted(fl):
            got = sh_flat.search(st_flat, qf, k=10)
        for key, v in fl.items():
            own[key] = own.get(key, 0) + v
        _expect("the sharded flat scan", {"adc_lookup": fl.get(
            "adc_lookup")}, {"adc_lookup": SHARDS})
        want = flat.search(flat.attach(index), qf, k=10)
        i_eq, s_eq = _same(got, want)
        equal["flat"] = dict(ids_equal=i_eq, scores_equal=s_eq)
        held(torch.equal(got.ids, want.ids)
             and torch.equal(got.scores, want.scores),
             f"flat_sharded differs from flat_adc (ids {i_eq}, scores "
             f"{s_eq} equal)")

        ex = search.make("exact_sharded", mesh=mesh)
        t0 = time.perf_counter()
        with _counted(own):
            ex_state = ex.build(None, X, R0, search.SearchConfig(
                tile_rows=EXACT_TILE))
            got = ex.search(ex_state, Q, k=10)
        sec["exact"] = time.perf_counter() - t0
        want = search.make("exact").search(ctx["exact"], Q, k=10)
        i_eq, s_eq = _same(got, want)
        err = float((got.scores - want.scores).abs().max())
        equal["exact"] = dict(ids_equal=i_eq, scores_equal=s_eq,
                              max_abs_score_diff=err)
        held(torch.equal(got.ids, want.ids) and err <= ATOL,
             f"exact_sharded differs from exact (ids {i_eq} equal, scores "
             f"within {err})")
        held(int(got.scanned[0]) == N, "exact_sharded scanned")
        del ex_state
        sharded_parity = {
            "exact_sharded": recall_at_k(got.ids, want.ids),
            "flat_sharded": recall_at_k(
                sh_flat.search(st_flat, Q, k=10).ids,
                flat.search(flat.attach(index), Q, k=10).ids),
            "ivf_sharded": recall_at_k(runs[(8, BATCHES[0], 0)].ids, ivf.search(
                single, Q[:BATCHES[0]], k=10, nprobe=8).ids)}
        held(min(sharded_parity.values()) >= SHARD_PARITY,
             f"sharded_parity {sharded_parity}")

        # -- the eager refresh of the sharded state (rotate_components) --
        learner = rotations.make("subspace_gcd", sub=DIM // D)
        with _counted(own):
            delta = _gcd_delta(learner, index.R, X[:TRAIN], index.quantizer)
            st_r = sh_ivf.refresh(st, delta)
            got = sh_ivf.search(st_r, Q[:BATCHES[0]], k=10)
        want = ivf.search(ivf.refresh(single, delta), Q[:BATCHES[0]], k=10)
        i_eq, s_eq = _same(got, want)
        equal["refreshed"] = dict(ids_equal=i_eq, scores_equal=s_eq)
        held(torch.equal(got.ids, want.ids)
             and torch.equal(got.scores, want.scores),
             f"the refreshed sharded state differs from the refreshed index "
             f"(ids {i_eq}, scores {s_eq} equal)")
        held(all(torch.equal(p.R, st_r.R) and torch.equal(
            p.coarse.centroids, st_r.coarse.centroids)
            for p in st_r.shards), "a shard's replica was not refreshed")
        del st_r

        # -- build_sharded from four chunks, the coarse fit sharded -------
        chunk = N // SHARDS
        chunks = [X[s * chunk:(s + 1) * chunk] for s in range(SHARDS)]
        t0 = time.perf_counter()
        with _counted(own):
            parts = index_ivf.build_sharded(
                device.generator(SHARD_BUILD_SEED), chunks, R0,
                serve_config().ivf_config(), mesh=mesh)
            st_b = search.attach_shards(parts, mesh=mesh,
                                        nprobe=SERVE_NPROBE)
            torch.cuda.synchronize()
        sec["build_sharded"] = time.perf_counter() - t0
        del parts, chunks
        held(sh_ivf.stats(st_b)["rows"] == N, "build_sharded lost rows")
        with _counted(own):
            b_ivf = sh_ivf.search(st_b, Q, k=10)
            b_flat = sh_flat.search(st_b, Q, k=10)
        s_ivf = ivf.search(single, Q, k=10)
        s_flat = flat.search(flat.attach(index), Q, k=10)
        truth = ctx["truth"]
        build = dict(
            recall_vs_flat=recall_at_k(b_ivf.ids, b_flat.ids),
            recall_at_10=recall_at_k(b_ivf.ids, truth),
            single_recall_vs_flat=recall_at_k(s_ivf.ids, s_flat.ids),
            single_recall_at_10=recall_at_k(s_ivf.ids, truth),
            max_blocks=st_b.max_blocks,
            rows_per_shard=sh_ivf.stats(st_b)["rows_per_shard"])
        held(build["recall_at_10"] >= build["single_recall_at_10"]
             - SHARD_BUILD_RECALL,
             f"build_sharded recall {build['recall_at_10']} against the "
             f"single build's {build['single_recall_at_10']}")
        del st_b, b_ivf, b_flat

        # -- the Engine over a fused sharded state, through a refresh -----
        st_f = sh_ivf.attach(index, mesh=mesh, nprobe=SERVE_NPROBE,
                             fused_refresh=True)
        engine = search.Engine(sh_ivf, st_f, k=10, nprobe=SERVE_NPROBE)
        lo, eng = 0, {}
        t0 = time.perf_counter()
        with _counted(own):
            for b in ENGINE_SIZES:
                q = Q[lo % Q.shape[0]:][:b]
                if q.shape[0] < b:
                    q = torch.cat([q, Q[:b - q.shape[0]]])
                lo += b
                engine.search(q)
            before = engine.stats()
            engine.refresh(delta)
            fresh = X[N - ENGINE_SIZES[0]:]       # rows never served
            after = engine.search(fresh)
            for b in ENGINE_SIZES:
                engine.search(Q[:b])
            torch.cuda.synchronize()
        sec["engine"] = time.perf_counter() - t0
        es = engine.stats()
        direct = sh_ivf.search(engine.state, fresh, k=10)
        eng = dict(compiles_before=before["compiles"],
                   compiles_after=es["compiles"],
                   executables=es["executables"], refreshes=es["refreshes"],
                   lut_invalidations=es["lut_invalidations"],
                   lut_hit_rate=es["lut_hit_rate"],
                   latency_ms_p50=es["latency_ms_p50"],
                   equal_direct=_same(after, direct))
        held(es["compiles"] == before["compiles"]
             and es["executables"] == before["executables"],
             f"the refresh made an executable: {eng}")
        held(torch.equal(after.ids, direct.ids)
             and torch.equal(after.scores, direct.scores),
             f"the Engine after the refresh differs from a direct sharded "
             f"search: {eng['equal_direct']}")
        del engine, st_f

        # -- churn: low-end deletes until the 1.03 trigger rebalances ----
        st_c = sh_ivf.attach(index, mesh=mesh, nprobe=SERVE_NPROBE)
        eng_c = search.Engine(sh_ivf, st_c, k=10, nprobe=SERVE_NPROBE,
                              min_bucket=32)
        ctl = churn.ChurnController(
            eng_c, staging_rows=CHURN_STAGING, flush_at=CHURN_FLUSH_AT,
            compact_at=SHARD_COMPACT_AT,
            imbalance_threshold=SHARD_REBALANCE)
        q512 = Q[:BATCHES[0]]
        rebalanced = []
        real = churn_ops.shard_rebalance

        def spy(state, **kw):
            # the same live set: the flat scan's top-k (every CSR and
            # staged row) before and after; the probed top-k may change,
            # since a staged row is scored whatever its list and a packed
            # one only when its list is probed
            qf = Q[:FLAT_QUERIES]
            with _counted(side):
                was = sh_flat.search(state, qf, k=10)
                probed = sh_ivf.search(state, q512, k=10)
            rows_was = churn.shard_rows(state)
            new = real(state, **kw)
            with _counted(side):
                now = sh_flat.search(new, qf, k=10)
                probed_now = sh_ivf.search(new, q512, k=10)
            rebalanced.append(dict(
                ids_equal=bool(torch.equal(was.ids, now.ids)),
                scores_equal=bool(torch.equal(was.scores, now.scores)),
                probed_equal=_same(probed, probed_now),
                rows_before=rows_was, rows_after=churn.shard_rows(new)))
            return new

        adds = ctx["adds"]
        removed = np.zeros(N + adds.shape[0], dtype=bool)
        steps, surfaced, side_equal = 0, 0, None
        t0 = time.perf_counter()
        churn_ops.shard_rebalance = spy
        try:
            with _counted(own):
                eng_c.search(q512)
            while not rebalanced and steps < SHARD_MAX_STEPS:
                lo = steps * CHURN_BATCH
                dead = np.arange(lo, lo + CHURN_BATCH, dtype=np.int32)
                add_ids = np.arange(N + lo, N + lo + CHURN_BATCH,
                                    dtype=np.int32)
                with _counted(own):
                    ctl.step(add=adds[lo:lo + CHURN_BATCH], add_ids=add_ids,
                             remove_ids=dead)
                    res = eng_c.search(q512)
                removed[dead] = True
                got = res.ids.cpu().numpy()
                surfaced += int(removed[got[got >= 0]].sum())
                if steps == 0:
                    # staged rows served by each shard's side pass: the
                    # same live set and buffer on the single index
                    one = churn.with_staging(ivf.attach(
                        index, nprobe=SERVE_NPROBE), CHURN_STAGING * SHARDS,
                        window_slack=0)
                    one = churn.stage(churn.tombstone(one, dead),
                                      adds[:CHURN_BATCH], add_ids)
                    a = sh_ivf.search(ctl.state, q512, k=10)
                    qa = adds[:FLAT_QUERIES]
                    staged_hits = int(torch.isin(sh_ivf.search(
                        ctl.state, qa, k=10).ids, torch.as_tensor(
                            add_ids, device=qa.device)).sum())
                    w = ivf.search(one, q512, k=10)
                    side_equal = _same(a, w)
                    held(churn.staged_rows(ctl.state) == CHURN_BATCH,
                         "the first step's adds are not staged")
                    held(torch.equal(a.ids, w.ids)
                         and torch.equal(a.scores, w.scores),
                         f"the staged sharded state differs from the single "
                         f"index with the same buffer: {side_equal}")
                    del one
                steps += 1
            torch.cuda.synchronize()
        finally:
            churn_ops.shard_rebalance = real
        sec["churn"] = time.perf_counter() - t0
        ch = eng_c.stats()["churn"]
        cell = dict(steps=steps, batch=CHURN_BATCH, rebalances=ch[
            "rebalances"], flushes=ch["flushes"],
            compactions=ch["compactions"], grows=ch["grows"],
            staged=ch["staged"], tombstoned=ch["tombstoned"],
            surfaced_tombstones=surfaced, rebalance=rebalanced,
            side_pass_equal=side_equal, staged_ids_served=staged_hits,
            shard_rows_after=churn.shard_rows(ctl.state))
        held(ch["rebalances"] >= 1 and len(rebalanced) >= 1,
             f"no rebalance in {steps} steps: {cell}")
        held(all(r["ids_equal"] and r["scores_equal"] for r in rebalanced),
             f"the rebalance changed the flat top-k: {rebalanced}")
        held(surfaced == 0, f"{surfaced} tombstoned ids served")
        rows_after = cell["shard_rows_after"]
        held(max(rows_after) - min(rows_after) <= 1,
             f"shards unbalanced after the rebalance: {rows_after}")
        del eng_c, ctl, st_c

        # -- the kernels at the per-shard shapes --------------------------
        timing = _shard_kernel_rows(st, index, X, Q, errs)
        t0 = time.perf_counter()
        lat = dict(
            sharded=time_ms(lambda: sh_ivf.search(st, q512, k=10), reps=20,
                            flush=False),
            single=time_ms(lambda: ivf.search(single, q512, k=10), reps=20,
                           flush=False))
        sec["latency"] = time.perf_counter() - t0
    for key, v in side.items():
        own[key] = own.get(key, 0) - v
    own = {k: v for k, v in own.items() if v}
    for name in SHARDED_KERNELS:
        held(own.get(name, 0) > 0, f"kernel {name} was not launched")
    hold = _hold_spied("sharded", seen, errs)
    emit("sharded", shards=SHARDS, devices=[str(d) for d in mesh.devices],
         capacity_per_shard=st.capacity, max_blocks=st.max_blocks,
         single_max_blocks=single.max_blocks,
         rows_per_shard=stats["rows_per_shard"], parity=equal,
         sharded_parity=sharded_parity, build_sharded=build, engine=eng,
         churn=cell, kernels=timing, search_latency_ms=lat, launches=own,
         held=hold, seconds=sec, total_s=time.perf_counter() - t_all,
         peak_memory_bytes=torch.cuda.max_memory_allocated(), card=smi)
    return errs, own


# -- sharded_train ----------------------------------------------------------


def _st_steps(step, state, batches, start: int = 0):
    """(state, losses, synchronised step ms) over ``batches[start:]``."""
    import torch

    losses, ms = [], []
    for ids, labels in batches[start:]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, ids, labels)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
    return state, losses, ms


def _st_rel(a: list, b: list) -> float:
    return max(abs(x - y) / abs(y) for x, y in zip(a, b))


def phase_sharded_train(smi: str) -> tuple[dict, dict]:
    """Wide&Deep's masked psum lookup trained at full width on ST_SHARDS
    shards of one card (module docstring). Returns (errors, the path's
    launches: arm A's steps)."""
    import shutil
    import zipfile

    import torch

    from repro_torch import configs
    from repro_torch.bench import common
    from repro_torch.data import pipeline, synthetic
    from repro_torch.launch import cells
    from repro_torch.launch.mesh import make_mesh_compat
    from repro_torch.models import recsys
    from repro_torch.sharding import placed
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training import optimizer as opt_lib
    from repro_torch.training import train_state as ts

    t_all = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    cfg_b = configs.get(ST_ARCH).make_config()
    cfg_a = cfg_b._replace(psum_lookup=True)

    def mesh_of(shards: int):
        return make_mesh_compat((1, shards), ("data", "model"),
                                devices=(ST_DEVICE,) * shards)

    mesh = mesh_of(ST_SHARDS)
    dev = mesh.devices[0]
    ocfg = cells._opt_cfg_for(cfg_b)
    cell = cells.build_cell(ST_ARCH, "train_batch", mesh=mesh)
    errs, out, sec, launches = {}, {}, {}, {}

    def make_batch(g):
        return synthetic.ctr_batch(g, ST_BATCH, cfg_b.n_sparse,
                                   cfg_b.vocab_per_field)

    pipe = pipeline.Pipeline(make_batch, seed=ST_SEED, device=dev,
                             shardings=tuple(cell.in_shardings[1:]))
    batches = [next(pipe) for _ in range(ST_STEPS)]
    pipe.close()
    check(all(b[0].device == dev and b[1].device == dev for b in batches),
          "sharded_train: the batches are not on the mesh's first device")

    def step_of(cfg, m):
        return ts.make_train_step(
            lambda p, i, lab: recsys.widedeep_loss(p, i, lab, cfg, m), ocfg,
            grad_shardings=cell.in_shardings[0].params)

    with common.deterministic():
        t0 = time.perf_counter()
        model_b = recsys.WideDeep.init(torch.Generator(dev).manual_seed(
            ST_SEED), cfg_b, device=dev)
        model_a = recsys.WideDeep.init(torch.Generator(dev).manual_seed(
            ST_SEED), cfg_a, mesh=mesh)
        torch.cuda.synchronize()
        sec["init"] = time.perf_counter() - t0
        pieces = model_a.table.pieces
        check(len(pieces) == ST_SHARDS and all(p.device == dev
                                               for p in pieces),
              "sharded_train: the table is not in ST_SHARDS pieces")
        out["piece_bytes"] = {
            k: [p.numel() * p.element_size() for p in leaf.pieces]
            for k, leaf in opt_lib.named_leaves(model_a).items()
            if placed.is_placed(leaf)}
        ids, labels = batches[0]
        # -- step 1 against the dense lookup --------------------------------
        t0 = time.perf_counter()
        with torch.no_grad():
            la = recsys.widedeep_forward(model_a, ids, cfg_a, mesh)
            lb = recsys.widedeep_forward(model_b, ids, cfg_b)
        errs["sharded_train/logits"] = bit_equal(la, lb, "step-1 logits")
        del la, lb
        ga = torch.autograd.grad(recsys.widedeep_loss(
            model_a, ids, labels, cfg_a, mesh), model_a.table.pieces)
        gb = torch.autograd.grad(recsys.widedeep_loss(
            model_b, ids, labels, cfg_b), model_b.table)[0]
        for s, (g, idx) in enumerate(zip(ga, model_a.table.indices)):
            errs[f"sharded_train/grad_piece{s}"] = bit_equal(
                g, gb[idx], f"table piece {s}'s step-1 gradient")
        del ga, gb
        sec["step1_checks"] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
        # -- arm B: the dense lookup ------------------------------------------
        arm = {}
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        st, losses_b, ms_b = _st_steps(
            step_of(cfg_b, None), ts.init_state(None, model_b, ocfg),
            batches)
        arm["B"] = dict(losses=losses_b, step_ms=ms_b,
                        step_p50_ms=statistics.median(ms_b),
                        peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                        resident_gb=base / 1e9)
        del st, model_b
        gc.collect()
        torch.cuda.empty_cache()
        # -- arm A: the psum lookup, a checkpoint at ST_CKPT_AT --------------
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        step_a = step_of(cfg_a, mesh)
        with _counted(launches):
            st, first, ms1 = _st_steps(step_a, ts.init_state(
                None, model_a, ocfg), batches[:ST_CKPT_AT])
            d = Path(__file__).resolve().parent / "build" / \
                "sharded_train_ckpt"
            shutil.rmtree(d, ignore_errors=True)
            t0 = time.perf_counter()
            path = ckpt.save(str(d), ST_CKPT_AT, st._replace(rng=None))
            sec["save"] = time.perf_counter() - t0
            st, rest, ms2 = _st_steps(step_a, st, batches, ST_CKPT_AT)
        losses_a = first + rest
        arm["A"] = dict(losses=losses_a, step_ms=ms1 + ms2,
                        step_p50_ms=statistics.median(ms1 + ms2),
                        peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                        resident_gb=base / 1e9)
        _expect("the sharded_train path", launches, {})
        npz = Path(path) / "arrays.npz"
        out["checkpoint_bytes"] = npz.stat().st_size
        with zipfile.ZipFile(npz) as z:
            keys = {n[:-4] for n in z.namelist()}
        check({"params/table", "opt_state/mu/table"} <= keys and not any(
            k.startswith("params/table/") for k in keys),
            "sharded_train: the checkpoint is not in the JAX layout")
        rel = _st_rel(losses_a, losses_b)
        check(rel <= ST_RTOL, f"sharded_train: losses {losses_a} against "
              f"{losses_b} (rel {rel})")
        errs["sharded_train/losses_rel"] = rel
        del st, model_a, step_a
        gc.collect()
        torch.cuda.empty_cache()
        # -- elastic resume: the step-2 checkpoint at other shard counts -----
        resumed = {}
        specs = recsys.widedeep_specs(cfg_a)
        for shards in ST_RESHARD:
            m = mesh_of(shards)
            t0 = time.perf_counter()
            fresh = recsys.WideDeep({k: torch.empty(v.shape, device=dev)
                                     for k, v in specs.items()}).place(
                cfg_a, m)
            like = ts.init_state(None, fresh, ocfg)._replace(rng=None)
            restored, _ = ckpt.restore(str(d), ST_CKPT_AT, like)
            del like
            with torch.no_grad():
                for k, p in opt_lib.named_leaves(fresh).items():
                    p.copy_(restored.params[k])
            state = ts.TrainState(params=fresh,
                                  opt_state=restored.opt_state,
                                  step=restored.step, rng=None)
            del restored
            restore_s = time.perf_counter() - t0
            _, got, _ = _st_steps(step_of(cfg_a, m), state, batches,
                                  ST_CKPT_AT)
            r = _st_rel(got, losses_a[ST_CKPT_AT:])
            check(r <= ST_RTOL, f"sharded_train: resumed at {shards} "
                  f"shard(s): {got} against {losses_a[ST_CKPT_AT:]}")
            errs[f"sharded_train/resume{shards}_rel"] = r
            resumed[shards] = dict(losses=got, rel=r, restore_s=restore_s,
                                   pieces=len(fresh.table.pieces))
            del state, fresh
            gc.collect()
            torch.cuda.empty_cache()
        shutil.rmtree(d, ignore_errors=True)
    ratio = arm["A"]["step_p50_ms"] / arm["B"]["step_p50_ms"]
    emit("sharded_train", config={k: v for k, v in cfg_a._asdict().items()
                                  if k not in ("dtype", "param_dtype")},
         batch=ST_BATCH, steps=ST_STEPS, mesh=dict(mesh.shape),
         devices=[str(x) for x in mesh.devices], arms=arm,
         a_over_b_step=ratio, resumed=resumed, launches=launches,
         max_abs_err=errs, seconds_by_part=sec,
         seconds=time.perf_counter() - t_all, card=smi, **out)
    return errs, launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = phase_env()
    ctx = phase_main(smi)
    rows, errs = phase_kernels(ctx)
    paths = {"serving": ctx["path_launches"]}
    engine_rows, engine_errs, paths["engine"] = phase_engine(ctx, smi)
    rows.update(engine_rows)
    errs.update(engine_errs)
    churn_errs, paths["churn"] = phase_churn(ctx, smi)
    errs.update(churn_errs)
    rq_errs, paths["rq"] = phase_rq(ctx, smi)
    errs.update(rq_errs)
    te_errs, paths["train_e2e"] = phase_train_e2e(ctx, smi)
    errs.update(te_errs)
    serve_errs, paths["serve"] = phase_serve(ctx, smi)
    errs.update(serve_errs)
    shard_errs, paths["sharded"] = phase_sharded(ctx, smi)
    errs.update(shard_errs)
    del ctx                          # frees the 1M-row index
    torch.cuda.empty_cache()
    tctx = phase_train(smi)
    train_rows, train_errs = phase_train_kernels(tctx)
    rows.update(train_rows)
    errs.update(train_errs)
    paths["train"] = tctx["launches"]
    del tctx                         # frees the two-tower model
    torch.cuda.empty_cache()
    paths["table1"], table1_errs = phase_table1(smi)
    errs.update(table1_errs)
    paths["fig4"], fig4_errs = phase_fig4(smi)
    errs.update(fig4_errs)
    paths["fig2"], fig2_errs = phase_fig2(smi)
    errs.update(fig2_errs)
    dctx = phase_decode(smi)
    decode_rows, decode_errs = phase_decode_kernels(dctx)
    rows.update(decode_rows)
    errs.update(decode_errs)
    paths["decode"] = dctx["main_launches"]
    del dctx
    torch.cuda.empty_cache()
    lm_rows, lm_errs, lm_paths = phase_lm_train(smi)
    errs.update(lm_errs)
    paths["lm_train"] = lm_paths["kvq"]
    paths["lm_train_decode"] = lm_paths["decode"]
    torch.cuda.empty_cache()
    _, moe_errs, paths["moe"] = phase_moe(smi)
    errs.update(moe_errs)
    torch.cuda.empty_cache()
    _, zoo_errs, paths["zoo"] = phase_zoo(smi)
    errs.update(zoo_errs)
    torch.cuda.empty_cache()
    dry_errs, paths["dryrun"] = phase_dryrun(smi)
    errs.update(dry_errs)
    torch.cuda.empty_cache()
    tool_errs, tool_paths = phase_tooling(smi)
    errs.update(tool_errs)
    paths.update(tool_paths)
    torch.cuda.empty_cache()
    st_errs, paths["sharded_train"] = phase_sharded_train(smi)
    errs.update(st_errs)
    summary = []
    for name, (src, replaces) in SOURCES.items():
        r = rows[name]
        by_path = {p: c.get(name, 0) for p, c in paths.items()
                   if c.get(name, 0)}
        summary.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=sum(by_path.values()), launches_by_path=by_path,
            max_abs_err=max(v for key, v in errs.items()
                            if key.startswith(name + "/")),
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"]))
    print(smi, flush=True)
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
