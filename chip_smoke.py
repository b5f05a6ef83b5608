#!/usr/bin/env python3
"""Drive raft_tpu_torch's compile probe, k-means and its IVF-Flat, IVF-PQ
(with its PER_CLUSTER, float16 and legacy variants), tiered and
brute-force serving paths (each request type on its own ladder), the
serving autotuner, random ball cover, the ε-neighbourhood, the
distributed layer (MNMG k-means and kNN at world 1 over NCCL and world 2
over gloo), sharded and replicated serving, the mutable index over a
sharded main, the sparse graph path (single linkage, spectral
partitioning with BASELINE.json configs[3], sparse kNN), the dense
long tail (BLAS, decompositions, least squares, gram matrices, labels,
the LAP solver), the AOT core (``prewarm`` over the kernel cache,
BASELINE.json configs[0] at its own shape) and the program audit on one
NVIDIA card.

    python3 chip_smoke.py            # full size; needs one CUDA card

The deployment is ann-benchmarks' sift-128-euclidean at full size, with
data of the same shape made from a seed (a clustered Gaussian mixture in
float32, since the SIFT files are not in the repository): 1,000,000 base
vectors × 128, 10,000 queries, k = 10, L2.  IVF-Flat with n_lists = 1024
(RAFT's ANN bench entry ``raft_ivf_flat.nlist1024``), n_probes = 20,
kmeans_n_iters = 20, kmeans_trainset_fraction = 0.5.  IVF-PQ with the
JAX package's defaults at n_lists = 1024: pq_dim 64, pq_bits 8,
PER_SUBSPACE codebooks, the PCA-balanced rotation, pq_trainset_cap
262,144; searched with n_probes = 20 and the float32 LUT.  Brute force:
exact kNN under L1 ("l1", cuML's ``NearestNeighbors(algorithm="brute",
metric="manhattan")``) over the same 1,000,000 × 128 dataset, which is
the index (512 MB on the card), in index tiles of 16,384 rows.

Phases, one JSON line each:

1. device — the card, its power limit (nvidia-smi), torch and CUDA; then
   ``probe``, the compile probe (``raft_tpu_torch.kernels.probe``, the
   counterpart of ``bench/tpu_session.py``'s ``pallas_probe_stage``):
   ``probe.cu`` built alone and kernel B6 (x + 1) run on a 128 × 128
   zero tensor, exactly x + 1; then ``fused_l2nn.cu`` built alone and B1
   at 1,024 × 256 × 128 against its plain version.  A failed case prints
   nvcc's or the launch's whole error to stderr and fails the run within
   seconds, before the other sources build.  B6's row: exact on seeded
   values, its median device time, the host's cost of a call (the launch
   overhead), its bytes bound, ``x + 1`` and ``torch.add``.  Then the
   other kernels are built from ``raft_tpu_torch/kernels/csrc`` (nvcc,
   one process per source, all at once).
2. kernels — B1, B2 and B3 against their plain PyTorch versions on the
   card at the main paths' shapes (B1 at the build path's four: the list
   assignment 1,000,000 × 1,024 × 128, B3's E-step 500,000 × 1,024 ×
   128, the meso assignment 1,000,000 × 32 × 128 and one mesocluster's
   fine clustering 16,384 × 32 × 128, each beside the product alone
   (``x @ y.T``), the float32 bound outside the tensor cores and the
   bound of its three TF32 products, with a row's bits the same in
   batches of 1 to 4,097 rows; B1 and B3 also at the PQ codebook
   training shape, 262,144 × 256 × 2; B1's float32 FMA kernel, which no
   main path runs, at 1,000 × 1,000 × 300 and with ``bf16_dot``) and at
   ragged edge shapes, with
   their median device times, the plain versions', one PyTorch library
   call's where one computes the same function, and the least time the
   card could take (bound).  B3 also for all 64 PQ subspaces in one
   launch (64 × 262,144 × 256 × 2) against its plain twin and, bit for
   bit, against 64 launches of one subspace, and its M-step alone at the
   balancing-EM shape; B2 also at a brute-force scan step (1,024 ×
   16,384, k = 10, ``torch.topk`` as the yardstick), all on float32,
   float16 and bfloat16 rows.
3. k-means path — BASELINE.json configs[1], "raft::cluster::kmeans —
   100k×128, k=1024" (reference cpp/bench/cluster/kmeans.cu):
   ``make_blobs(RngState(seed), 100,000, 128, n_clusters=1,024,
   cluster_std=1.0)`` on the card, nothing cut.  ``kmeans``: launch
   counts reset, ``fit_predict(KMeansParams(n_clusters=1024), x)`` with
   the reference defaults (k-means‖, max_iter 300, tol 1e-4), then,
   warm, ``fit_predict`` again, the init alone and the EM from its
   centroids: their seconds, ``n_iter``, inertia, ARI against the
   blobs' labels (at least ``KMEANS_ARI_FLOOR``), B1 and B3 launched,
   and the EM from the init's centroids equal to the fit bit for bit.
   ``kmeans_checks``: from those centroids 20 iterations (``tol`` 0,
   ``loop="fori"``) through the kernels and twice through the plain
   versions: ARI and inertia within ``KMEANS_ARI_GAP`` / the E-step's
   value contract, ``predict`` labels equal except near ties; the
   k-means‖ buffer (10,241 rows, one round filled, the rest copies of the
   first centre or of the sampled rows): no copy slot owns a row.  ``kmeans_l1`` (5 iterations, B5 must
   launch) and ``kmeans_cosine`` (5 iterations, no kernel may launch;
   ``transform`` under L2 and L1 against ``engine="torch"``, rtol 1e-5,
   atol 1e-5) as ``kmeans_checks``.  ``silhouette``: the batched
   silhouette of 10,000 rows of the fit's labels under L2 and L1 (B5),
   within 1e-5 of the plain path's.  Then B1 at the E-step (100,000 ×
   1,024 × 128) and at the k-means‖ width (100,000 × 10,241 × 128), B3
   at the EM step (its labels, values and inertia against the plain
   version's, then its partials) and B5 L1 at one E-step block (2,048 × 1,024 × 128,
   ``torch.cdist`` as the yardstick), each against its plain version
   with its time and bound (the kernels line's ``kmeans_shapes``).
4. IVF-Flat main path — launch counts reset, then ``ivf_flat.build``,
   ``ServeEngine(...).warmup()`` and ragged coalesced ``search()`` calls
   covering all queries; the counts are read right after and B1, B2, B3
   must have launched.  Checks: coalesced results equal solo ``search``
   per request, recall@10 against exact neighbours (``torch.cdist`` +
   ``torch.topk``, the checker) of 1,000 queries, and the kernel path's
   recall within 0.002 of the plain path's (the same index searched
   with ``engine="torch"``); then an index built through the plain
   versions and searched through them, whose recall the kernel-built
   index's must lie within ``BUILD_RECALL_TOL`` of.
   Then its open-loop phase ``serve_stream``: launch counts reset, a
   fresh engine like the serve phase's fed through ``submit()`` from a
   feeder thread, the ragged requests arriving as a Poisson process at
   0.5× and 0.9× the serve phase's qps over all queries, every fourth a
   ``ServeRequest`` with a deadline of 10× the serve phase's per-call
   p50; each line gives achieved qps, the engine's
   ``latency_quantiles((0.5, 0.99))`` (from a ``search()`` entry), the
   open-loop latency p50/p99 (from the request's scheduled arrival to its
   result) with how late the feeder ran, rejections by reason and the
   engine's admission and scheduler counters, beside the card's name and
   power limit.  Checks: every served request bit for bit the serve
   phase's result, every other one a typed ``RejectedError``, none
   hung; one injected transient dispatch fault retried once with
   identical results; ``/metrics`` holds the request latency histogram
   and ``/healthz`` answers 200 (``serve_http(0)``); ``close()``
   resolves what is pending and a later ``submit()`` is refused; the
   launch counts read after show B2 (and for IVF-PQ B4's scan mode).
5. IVF-PQ main path — the same with ``ivf_pq.build`` and an IVF-PQ
   ``ServeEngine``: B1, B2, B3 and B4's scan mode must have launched, B4's
   per-step raw mode never, and the build at most ``MAX_PQ_BUILD_B3``
   times B3.  Checks: coalesced equals solo, kernel-path recall@10 within
   0.002 of the plain path's at the float32 LUT and, for a solo search,
   at the fp8 LUT, and within ``BUILD_RECALL_TOL`` of a plain-built
   index's (float32 LUT).  Then its ``serve_stream`` phase as above,
   which also ``refresh``-es the engine with the index while ``submit()``
   traffic flows: every future resolves without error, bit for bit, and
   ``stats["refreshes"]`` is 1.
6. B4's raw mode against its plain version at the IVF-PQ main path's step
   shape (1,024 queries × the index's capacity, pq_dim 64, 8 bits) for
   all four LUT types, and at ragged shapes (nq 1 and 37, capacities off
   the 256-slot block, pq_bits 4/5/7 with odd code bytes, LUT rows wider
   than a block's shared memory); ``embedding_bag`` is the library
   yardstick.  Then B4's scan mode at the batch shape (1,024 queries × the
   scan's steps × the capacity) with the index's float32 and fp8 LUTs:
   one launch per batch, (distances, ids) bit for bit equal to the
   per-step path (raw mode, the PyTorch epilogue, the live mask, B2 per
   step, the running merge), the live share of the (query, slot) pairs
   the per-step path scores, and its time beside its plain twin's, the
   per-step path's and a bound counted on live slots.
7. brute-force main path — launch counts reset, then
   ``ServeEngine(x, 10, metric="l1", max_batch=1024).warmup()`` and the
   same ragged calls; B5 and B2 must have launched.  Checks: coalesced
   equals solo ``knn`` per request bit for bit; on 1,000 queries, ids
   equal ``torch.cdist(p=1)`` + ``torch.topk`` (the checker) except at
   near ties and distances to rtol 1e-5; on every query, the kernel path
   against the plain path (``engine="torch"``) in the same way.  Then a
   short ``serve_stream`` pass: 1,024 queries at 0.5×, so B5 runs under
   the scheduler.  Then the distributed layer.  ``mnmg``: a world of
   one over NCCL in this process (a ``FileStore`` in a temporary
   directory), every ``self_tests`` check true; MNMG k-means at
   configs[1] from the k-means path's init in its three loops, launch
   counts reset first, each bit for bit ``kmeans.fit`` with
   ``InitMethod.Array`` (centroids, ``n_iter``) with ``n_iter`` + 1
   allreduces (fori: ``max_iter`` + 1) of (k·d + k + 1)·4 bytes and the
   inertia's 4, ``predict`` bit for bit, B1 and B3 launched, seconds
   beside the single-device fit's; ``knn_mnmg`` over the 1M dataset at
   10,000 queries, k = 10, under L2 and L1 with the index and the query
   partition, each bit for bit ``brute_force.knn`` with one allgather of
   nq·2k·4 bytes (the query partition: its padded slice's), B2 and B5
   launched, qps beside ``knn``'s; ``telemetry.gather`` the local
   snapshot.  ``mnmg_w2``: two worker processes on the card over gloo
   (NCCL takes one rank per device), each making the smoke's data from
   the seed and holding half the rows, awaited under
   ``MNMG_W2_TIMEOUT_S`` (a failed or hung worker fails the smoke):
   k-means (tol 0, ``MNMG_W2_ITERS`` steps) within 1e-5 of world 1's
   centroids, ARI ≥ ``MNMG_W2_ARI``, inertia within 1e-5; ``knn_mnmg``
   (index partition) under L1 bit for bit world 1's and under L2 ids
   equal except at near ties, distances to rtol 1e-5; ``gather`` holding
   both hosts; seconds and the collectives staged through the host.
   Then the request types and scale-out serving.  ``serve_dtypes``
   (right after the brute-force phase): the brute-force L1 and IVF-Flat
   engines warmed in float32, bfloat16 and float16 and fed the ragged
   calls over every query in each type (host tensors), the types in
   turns forward and back; every request bit for bit its solo search in
   its type, no signature added, no kernel library built; qps by type.
   ``sharded`` (a world of one over NCCL in this process):
   ``build_sharded`` for both IVF families, bit for bit the built
   indexes' ``shard()``, and ``shard_brute_force`` under L1; each served
   closed loop in turns with a single-device engine over the same index
   (bit for bit its results) and open loop at 0.5× its qps; an IVF-PQ
   ``save_sharded`` / ``load_sharded`` round trip.  ``sharded_w2`` (two
   gloo workers, rank 0 leading each engine, rank 1 in ``follow()``):
   the world-1 IVF indexes from archives, sharded, beside each worker's
   own ``build_sharded``; distances bit for bit world 1's, ids equal
   except at exact ties.  ``replica_w2`` (R = 2 replica groups of one
   rank, IVF-PQ): both lanes serving bit for bit the single-device
   engine, in turns with lane 1 drained; ``AutoTuner(shadow_lane=1)``
   under Poisson live traffic with no live request failed; the fault
   plan ``comms:op=replica_dispatch:rank=1:raise`` draining lane 1 with
   no failed request.  ``sharded_mutable`` (world 1 over NCCL, IVF-Flat
   and IVF-PQ): ``build_sharded`` wrapped in a ``MutableIndex`` and
   ``mutable_path``'s churn at full width through it and a single-device
   ``MutableIndex`` in turns, every search and both engines bit for bit,
   an archive round trip, a ``Compactor`` under closed-loop traffic with
   no failed request; write rows/s, qps, compaction seconds.
   ``sharded_mutable_w2`` (IVF-PQ, two gloo workers, a native
   ``MailboxServer`` as coordinator): the churn through the leader
   (WRITE), equal books on both ranks, distances bit for bit world 1's, a
   compaction under traffic, each compacted shard a fresh
   ``build_sharded``'s.  Each prints its kernels' launches and fails if a
   kernel of its path (``PATH_KERNELS``) never launched.
8. ``pairwise_distance`` — every name of ``SUPPORTED_DISTANCES`` at
   1,024 × 16,384 × 128 against ``engine="torch"`` (rtol 1e-5, atol
   1e-5); the seven B5 metrics must launch B5 and the others must not.
9. B5 against its plain version: all six ops × float32 / bfloat16 /
   float16 at the scan step (bucket 1,024 × tile 16,384 × 128), ragged
   shapes (m 1 and 37, n 1, 129 and 16,385, k 1, 3, 127 and 960, one NaN
   in x), and the rows of every bucket size (1 to 512, and 37) equal to
   the first rows of the 1,024-row batch bit for bit (B5's tile follows
   the batch); each op's time beside the plain version's,
   ``torch.cdist``'s (p = 1, 2 without the matrix-product form, ∞, 3 and
   0; Canberra has none) and the bound, counted from at least
   ``B5_OPS_PER_ELEMENT`` float32 instructions per element at the card's
   instruction rate against the bytes moved.
10. the rest of the IVF family, after the IVF-PQ phases:
   ``ivf_pq_per_cluster`` — the IVF-PQ configuration with PER_CLUSTER
   codebooks (1,024 lists' codebooks trained together, kernel B3 once a
   Lloyd iteration): launch counts reset, build, engine (its super-batch
   clamped to the batch cap), every query; B1, B2, B3 and B4's scan mode
   must launch; coalesced equals solo, recall within 0.002 of the plain
   path and ``BUILD_RECALL_TOL`` of a plain build.  ``ivf_pq_variants``
   on the IVF-PQ index (1,000 queries): the float16 sum through the
   kernels and the plain versions, the legacy search
   (``hoisted_lut=False``) at the float32 and fp8 LUTs with launch
   counts reset around it (B4's raw mode must launch), recall against
   the hoisted path's; then B4's raw mode at the legacy step with both
   float16 sums against its plain twin.  ``lut_scan@*``: B4's scan mode
   on PER_CLUSTER's 64 KB float32 tables, with the float16 sum, on the
   main index with the float16 sum and on PER_CLUSTER's fp8 tables, bit
   for bit against the per-step path at the engine's batch, 1 and 8
   queries.  ``tiered`` for each IVF index (hot_fraction 0.25,
   tile_phys 512; IVF-PQ with the dataset as refine store): launch
   counts reset, a tiered engine over every query, each request bit for
   bit the resident engine's; device bytes against the resident
   index's, cold tiles and prefetch bytes a dispatch, one tile's staging
   rate, IVF-PQ's ``refine_ratio=4`` recall lift (at least 0.05),
   ``refresh(retier(...))`` from the served counts under ``submit()``
   traffic (every request bit for bit), ``save_tiered`` /
   ``load_tiered`` (the same bits), and the busy share of one
   super-batch (``torch.profiler``).  ``approx_knn``:
   ``approx_knn_search`` over both built indexes equals their search.
11. the autotuner, the low-dimensional paths and the ε-neighbourhood:
   ``autotune`` (after the IVF-PQ open-loop phase) on the resident
   IVF-PQ engine: launch counts reset, ``warmup()``, 8 closed-loop calls
   to fill the shadow ring, ``AutoTuner`` over the warmed caps and
   n_probes 10 and 40 with the default recall reference, ``run()`` while
   a feeder thread ``submit()``s Poisson traffic at 0.5× the closed-loop
   qps, then a forced rollback (of the winner, else of a promoted cap):
   no live request failed or shed, each bit for bit the serve phase's
   result or the promoted config's solo search, no kernel library built
   or loaded and no warmed signature added from ``warm_candidates()``
   through the rollback, the baseline restored, ``exact_reference`` on
   the first four requests giving the ground truth's recall; each
   candidate's best-pair qps and p99, worst recall, the decisions and
   the tune's seconds.  ``ball_cover`` (after B5's phase): 1,000,000
   clustered 3-d points and 1,000,000 clustered (lat, lon) points,
   ``build_index`` (√n landmarks), ``knn_query`` of 10,000 queries at
   k = 10 under L2 and Haversine, ``all_knn_query`` (k = 8) over every L2
   point, ``eps_nn`` of 1,000 queries, each against a brute-force
   checker on the card (ids equal except at near ties, adjacency except
   within 1e-5 of ε), with the second-pass queries, B2's launches and
   the seconds.  ``eps``: ``eps_neighbors_l2sq`` of 4,096 rows against
   the 1M × 128 dataset in one batch (ε the median squared 10-NN
   distance) against ``torch.cdist`` (except within 1e-5 × ε of ε), its
   seconds and peak device memory.
12. the sparse graph path: ``single_linkage`` on the k-means path's
   blobs (100,000 × 128, 1,024 clusters): KNN_GRAPH with c = 15 (cuML
   ``AgglomerativeClustering``'s n_neighbors), n − 1 edges in one
   component, ARI against the blobs, the native dendrogram and cut bit
   for bit their numpy twins, seconds by stage and the fix-up rounds;
   PAIRWISE on the first 12,000 rows, its MST weight against scipy's
   ``minimum_spanning_tree`` of the same matrix on the host (in a process
   of its own, started after the next two phases so that none of their
   timings shares the host with it) and not above KNN_GRAPH's; B2 at the
   kNN graph's first tile (4,096 × 100,000, k = 31) bit for bit its plain
   version and against ``torch.topk``.
   ``spectral``: BASELINE.json configs[3] (a ``scipy.sparse.random``
   20,000 × 20,000 graph at density 2e-3, symmetrised, its Laplacian,
   ``lanczos_smallest`` of 8 at tol 1e-6 from a seeded start; solves/s
   over 5 solves), then a planted-partition graph of 1,000,000 vertices
   in 16 communities (12 partners inside, 4 outside a vertex, through
   ``from_triplets`` and ``symmetrize``: ~32M nnz) through
   ``spectral.partition`` and ``modularity_maximization`` (16
   eigenvectors, 16 clusters): every eigenpair's residual within 1e-3 ×
   ‖A‖₁, VᵀV within 1e-4 of I, ARI against the plants at least 0.9,
   ``analyze_partition`` / ``analyze_modularity``, solve and k-means
   seconds, restarts and SpMVs; B1 and B3 at each pipeline's (1M, 16)
   embedding and its labels' centroids against their plain versions (the
   kernels line's ``spectral_shapes``).  ``sparse_knn``: 100,000
   TF-IDF-shaped rows (131,072 Zipf-like features, 32–128 draws a row,
   L2-normalised through ``row_normalize``), the first 1,000 as queries,
   k = 10:
   ``brute_force_knn`` under cosine and inner product (the compressed
   engine) against a ``torch.sparse`` CSR product and ``torch.topk``, and
   under L1 on 1,024 features (the densify engine, B5) against
   ``torch.cdist(p=1)``; ids equal except at near ties.  Each prints its
   kernels' launches and fails if a kernel of its path never launched.
13. ``dense``, the dense long tail (no kernel of the repository; cuBLAS
   and cuSOLVER through ``torch``): ``reduce``, ``row_norm``,
   ``col_norm``, ``coalesced_reduction`` (an ``fmax`` fold) and
   ``normalize`` on 16,384 × 1,024 float32 (bench/bench_linalg.py's
   shape) within γ(n)·Σ|x| of the float64 result (the fold exactly);
   ``gemm`` 4,096² within γ(n) of float64, beside its float32 bound;
   ``matrix.argmin``, equal to the CPU's; the four ``lstsq_*`` on
   configs[1]'s blobs (100,000 × 128) with a planted linear target,
   coefficients within ``DENSE_LSTSQ_RTOL`` of float64
   ``torch.linalg.lstsq`` on the host; ``svd_qr``, ``svd_eig`` and
   ``rsvd_fixed_rank`` (k = 16, one Ω for both) on the blobs and
   ``eig_dc`` / ``eig_sel_dc`` on a 4,096² symmetric matrix, the card's
   reconstruction error and ‖VᵀV − I‖ within ``DENSE_DECOMP_X`` times the
   CPU's (or ``DENSE_DECOMP_FLOOR``), values within ``DENSE_VALUE_RTOL``;
   ``gram_matrix`` RBF at 16,384 × 16,384 × 128 (gamma "scale") against
   its float64 formula on a row block; ``make_monotonic`` (host and card)
   and ``merge_labels`` on the blobs' 100,000 labels against numpy twins;
   ``solve_lap`` on 8 float32 1,024² problems (objective within n·ε_eff
   of scipy's ``linear_sum_assignment``, converged) and one 2,048²
   problem of integer costs below 1,000 (scipy's optimum exactly), with
   the seconds beside scipy's.
14. ``aot`` and ``audit``, the AOT core and the analysis package's
   program audit.  ``aot``: a fresh process (``chip_smoke.py
   --aot-child``) over the build directory the smoke has filled:
   ``prewarm()`` of the default grid (pairwise sqeuclidean, euclidean,
   cosine, inner product and L1 plus ``fused_l2_nn`` at 5,000 × 5,000 ×
   50 and 2,048 × 1,024 × 128, ``select_k`` at 1,024 × 1,000, k = 40),
   which must build no library (``BUILDS["compiled"]`` 0), with each
   signature's first and warm call (``aot_prewarm``,
   ``aot_signatures``); B1 and B5 (L1) at both grid shapes (the k-means
   tile and configs[0]'s 5,000 × 5,000 × 50) and B2 at the select shape,
   prewarmed, against their plain versions with no new compile
   (``aot_checks``: B1's ids on more than 0.999 of the rows and values
   within 1e-4·(max + 1), B5 within rtol = atol = 1e-5, B2 bit for
   bit); configs[0] itself, ``pairwise_distance``
   L2SqrtExpanded on 5,000 × 5,000 × 50, its squared distances within
   1e-5 of ‖x‖² + ‖y‖² of float64 (``config0``, with its time and bytes
   bound); the grid again with ``aot_compile_counters["compiles"]``
   unchanged (``aot_repeat``).  ``audit``: the sync counter checked on
   one ``.item()`` (one sync) and one product (none), then
   ``raft_tpu_torch.analysis.program_audit`` over every registered
   program on the card (the four ``ann_mnmg.*`` at world 1 in a process
   of their own): one line a program with its host syncs and where they
   happened, launches by kernel, collectives and their bytes and
   transient bytes, each beside its budget, its outputs against its
   plain version on the same inputs (every program that launches a
   kernel: ``program_audit.against_plain``, floats within 1e-4·(max + 1),
   ids equal but for near-tie swaps in at most max(4, 1%) of the slots)
   and its fingerprint; any miss fails, and the fingerprints are diffed against committed
   goldens of the card's scope (another scope's are skipped).
   ``--golden-dir DIR`` writes them under ``DIR/<scope>/``.  Each phase
   fails if a kernel of its path (``PATH_KERNELS``) never launched.
15. ``handle`` (after ``approx_knn``): the resource model.  Every query
   of the smoke through ``ivf_pq.search`` at batch 1,024 over the IVF-PQ
   index, three times each with no handle, with ``Handle()`` and with
   ``Handle(n_streams=4)`` (query batch b on pool stream b mod 4): the
   seconds to return, the seconds ``sync()`` then took and the pool
   streams whose ``query()`` was False at return, each output bit for
   bit the handle-less call's; ``ivf_flat.search``, ``knn`` under L1,
   ``pairwise_distance`` cityblock and ``kmeans.fit`` from an array
   init under a handle against the same calls without one (B1–B5); the
   allocator check (the caller drops its queries and fills fresh memory
   of their size on its own stream with NaN while the pool still reads
   them behind a sleep: the results keep their bits and the block is not
   handed out again); a cancel from another thread during
   ``handle.sync()`` raises and a second ``sync()`` completes; and a
   sleeping stream the handle does not own is not waited for.  Only the
   handle runs count towards ``PATH_KERNELS["handle"]``.
16. the zero-compile contract.  Every serving line that warms an engine
   carries ``compiles_after_warmup``: the first calls of keyed programs
   (``aot_compile_counters["compiles"]``) over its traffic after
   ``warmup()``, which must be 0 — serve, serve_stream (and its fault
   retry), serve_dtypes, tiered, autotune (from ``warm_candidates()``
   through the rollback), the mutable reads across the writer thread and
   both compactions (the reading thread's count, ``core.aot.
   thread_compiles()``: a writer's rewarms run on its own), sharded and
   sharded_mutable at world 1, and the w2 leaders (a follower's first
   calls at most its leader's warm-up's).  The ``mutable_*`` lines give
   the rewarms (writes that changed a served shape) beside the upsert
   rows/s.  ``build_compiles`` (after the IVF-PQ path): each IVF family
   built twice from the same 100,000 rows and 20,000 rows extended into
   the first build twice; the second build and extend make no first
   call.  ``retrace`` (before ``aot``): the retrace-closure certifier
   over the checkout, its obligations certified and failed (any failure
   fails the run) and its seconds.
17. the ``{"kernels": [...]}`` line (B1–B6), then the last line
   ``{"ok": true, "device": {...}}``.

``--profile`` adds device time by kernel over one 1,024-query super-batch
of each engine (the world-1 sharded engines too), over one IVF-Flat and
one IVF-PQ build, and over the
k-means path's k-means‖ init and its weighted k-means++ finish alone
(``torch.profiler``).

Any failed check exits non-zero before the last line.  Float32 products
run in full float32 (TF32 off for matmul and cuDNN).
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import math
import pathlib
import statistics
import subprocess
import sys
import threading
import time

import numpy as np

#: the checkout this script lies in
ROOT = pathlib.Path(__file__).resolve().parent
#: the card's published peaks (H100 SXM data sheet, dense, 700 W)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12   # float32 outside the tensor cores
#: float32 instructions issued per second outside the tensor cores (the
#: flop rate counts a fused multiply-add as two)
F32_INSTR_PER_S = F32_FLOP_PER_S / 2
TF32_FLOP_PER_S = 495e12  # tensor cores, TF32 operands, float32 sums

#: cycles the card sleeps before a timed call, ahead of the host's
#: enqueue (about 1 ms)
SLEEP_CYCLES = 2_000_000
#: which TPU kernel each port kernel replaces
REPLACES = {
    "fused_l2_nn": "raft_tpu/kernels/fused_l2nn.py:86",
    "fused_l2_nn_partials": "raft_tpu/kernels/fused_l2nn.py:187",
    "select_k": "raft_tpu/kernels/select_k.py:155",
    "lut_score": "raft_tpu/kernels/ivf_pq_lut.py:98",
    "lut_scan": "raft_tpu/kernels/ivf_pq_lut.py:98",
    "lut_scan_tombstones": "raft_tpu/kernels/ivf_pq_lut.py:98",
    "pairwise_accumulate": "raft_tpu/kernels/pairwise.py:81",
    "add_one": "bench/tpu_session.py:357",
}
SOURCE = {
    "fused_l2_nn": "raft_tpu_torch/kernels/csrc/fused_l2nn.cu",
    "fused_l2_nn_partials": "raft_tpu_torch/kernels/csrc/fused_l2nn.cu",
    "select_k": "raft_tpu_torch/kernels/csrc/select_k.cu",
    "lut_score": "raft_tpu_torch/kernels/csrc/ivf_pq_lut.cu",
    "lut_scan": "raft_tpu_torch/kernels/csrc/ivf_pq_lut.cu",
    "lut_scan_tombstones": "raft_tpu_torch/kernels/csrc/ivf_pq_lut.cu",
    "pairwise_accumulate": "raft_tpu_torch/kernels/csrc/pairwise.cu",
    "add_one": "raft_tpu_torch/kernels/csrc/probe.cu",
}
#: B3 launches an IVF-PQ build may take: the coarse balancing EM (20 + 5
#: iterations) and one per codebook Lloyd iteration (20) for all subspaces
MAX_PQ_BUILD_B3 = 50
#: how far the recall@10 of an index built through the kernels may lie
#: from that of one built through their plain versions.  The plain build
#: does not repeat (its M-step's ``index_add_`` adds in a new order each
#: run): two plain builds of one seed differ with a standard deviation of
#: 0.002 (IVF-Flat) and 0.005 (IVF-PQ), at most 0.0044 and 0.0159
#: (``tools/b1_probe.py --quality`` over thirty seeds on an H100).  About
#: five of those deviations: this catches a broken build, not a shift of
#: a few thousandths, which the probe's seeds resolve.
BUILD_RECALL_TOL = {"ivf_flat": 0.01, "ivf_pq": 0.02}
#: the kernels each main path must launch
PATH_KERNELS = {
    "ivf_flat": ("fused_l2_nn", "fused_l2_nn_partials", "select_k"),
    "ivf_pq": ("fused_l2_nn", "fused_l2_nn_partials", "select_k",
               "lut_scan"),
    "brute_force": ("pairwise_accumulate", "select_k"),
    # extend's list assignment (B1), the compaction's rebuild (B1, B3),
    # every scan's selects (B2) and, for IVF-PQ, the masked scans (B4)
    "ivf_flat_mutable": ("fused_l2_nn", "fused_l2_nn_partials", "select_k"),
    "ivf_pq_mutable": ("fused_l2_nn", "fused_l2_nn_partials", "select_k",
                       "lut_scan_tombstones"),
    # PER_CLUSTER: the codebooks' batched Lloyd is B3 for all 1,024 lists
    "ivf_pq_per_cluster": ("fused_l2_nn", "fused_l2_nn_partials",
                           "select_k", "lut_scan"),
    # hoisted_lut=False: B4's raw mode at every scan step
    "ivf_pq_legacy": ("select_k", "lut_score"),
    "tiered_ivf_flat": ("select_k",),
    "tiered_ivf_pq": ("select_k", "lut_scan"),
    # the brute-force L1 and IVF-Flat engines in three request types
    "serve_dtypes": ("pairwise_accumulate", "select_k"),
    # build_sharded's training and list assignment (B1, B3), every select
    # (B2), the IVF-PQ shard scan (B4) and brute force under L1 (B5)
    "sharded": ("fused_l2_nn", "fused_l2_nn_partials", "select_k",
                "lut_scan", "pairwise_accumulate"),
    "sharded_w2": ("fused_l2_nn", "fused_l2_nn_partials", "select_k",
                   "lut_scan", "pairwise_accumulate"),
    "replica_w2": ("select_k", "lut_scan"),
    # the sharded mutable paths: build_sharded's training and the delta's
    # list assignment (B1, B3), every select (B2) and, for IVF-PQ, the
    # masked shard scans (B4 with the bitmap)
    "sharded_mutable": ("fused_l2_nn", "fused_l2_nn_partials", "select_k",
                        "lut_scan_tombstones"),
    "sharded_mutable_w2": ("fused_l2_nn", "fused_l2_nn_partials",
                           "select_k", "lut_scan_tombstones"),
    # the k-means that clusters each spectral embedding (B1 and B3 at
    # d = 16); the kNN graph's selects; the sparse kNN's selects and, in
    # its densify engine under L1, B5
    "spectral": ("fused_l2_nn", "fused_l2_nn_partials"),
    "single_linkage": ("select_k",),
    "sparse_knn": ("pairwise_accumulate", "select_k"),
    # prewarm's grid and its checks in a fresh process: B1, B2, B5 (L1)
    "aot": ("fused_l2_nn", "select_k", "pairwise_accumulate"),
    # the audited programs: B3 (fused_em_step, kernels.fused_l2_nn), B2,
    # B4's raw mode (kernels.ivf_pq_lut) and scan mode (ivf_pq.full_search)
    "audit": ("fused_l2_nn_partials", "select_k", "lut_score", "lut_scan"),
    # the calls under a handle: kmeans.fit (B1, B3), the searches' selects
    # (B2), the IVF-PQ scan on pool streams (B4), L1 kNN and cityblock (B5)
    "handle": ("fused_l2_nn", "fused_l2_nn_partials", "select_k",
               "lut_scan", "pairwise_accumulate"),
}
#: the kernels each serving path's open-loop phase must launch (serving
#: builds nothing)
STREAM_KERNELS = {"ivf_flat": ("select_k",),
                  "ivf_pq": ("select_k", "lut_scan"),
                  "brute_force": ("pairwise_accumulate", "select_k")}
#: open-loop arrival rates, as fractions of the serve phase's qps
STREAM_RATES = (0.5, 0.9)
#: every 4th submitted request carries a deadline of 10 × the serve
#: phase's per-call p50
STREAM_DEADLINE_EVERY = 4
STREAM_DEADLINE_X = 10
#: the longest the open-loop phase waits on one future (a request that
#: takes longer counts as hung)
STREAM_WAIT_S = 120.0
#: the engine counters each serve_stream line reports
STREAM_STATS = ("admitted", "sheds", "expired", "sched_dispatches",
                "sched_waits", "super_batches", "solo_fallbacks",
                "retries", "dispatch_errors")
#: batch sizes whose rows must equal the first rows of the 1,024-row
#: batch (the serving buckets, a solo query and one size off the ladder)
BUCKET_ROWS = (1, 8, 16, 32, 37, 64, 128, 256, 512)
#: B5's float32 instructions per element, at least (L1: a subtract and an
#: add with an abs modifier; l2: a subtract and a fused multiply-add; linf
#: a subtract and a NaN-propagating max; lp a subtract, log2, multiply,
#: exp2 and add; hamming a compare and an add; canberra a subtract, an add
#: of two abs, a reciprocal and multiply, and an add)
B5_OPS_PER_ELEMENT = {"l1": 2, "l2": 2, "linf": 2, "lp": 5, "hamming": 2,
                      "canberra": 5}

#: the k-means path: BASELINE.json configs[1], "raft::cluster::kmeans —
#: 100k×128, k=1024" (reference cpp/bench/cluster/kmeans.cu), with the
#: reference's defaults (k-means||, max_iter 300, tol 1e-4)
KMEANS_SHAPE = (100_000, 128, 1024)
#: the fit's ARI against make_blobs' labels, at least: a sanity floor (a
#: broken init or EM lands far below it)
KMEANS_ARI_FLOOR = 0.95
#: EM iterations (tol 0) of the kernel-against-plain comparisons
KMEANS_CHECK_ITERS = {"l2": 20, "l1": 5, "cosine": 5}
#: how far the kernel path's fit may lie from the plain path's after those
#: iterations from one init.  The plain path does not repeat (its
#: M-step's ``index_add_`` adds in a new order each run): two plain fits
#: on an H100 gave ARI 1.0 between them and inertia 7.4e-8 apart
#: (relative; ``plain_ari_vs_plain``, ``plain_inertia_gap``, printed with
#: every run).  So the kernel fit's labels must reach ARI 1 −
#: KMEANS_ARI_GAP against the plain fit's (a thousandth of the pairs:
#: room for a few near-tie rows to move), and its inertia lie within the
#: E-step's value contract — per row 1e-5 of ‖x‖² + ‖c‖² for B1 (its
#: 3xTF32 products; the norms are ~64× the distances here, and the first
#: run's gap was 6.5e-5), 1e-5 of the distance for every other metric —
#: plus KMEANS_INERTIA_GAP, about 13× the plain fits' own spread.
KMEANS_ARI_GAP = 1e-3
KMEANS_INERTIA_GAP = 1e-6


class CheckFailed(Exception):
    pass


def check(cond, what: str) -> None:
    if not cond:
        raise CheckFailed(what)


#: when the script started: each phase line carries its seconds since
_T0 = time.perf_counter()


def emit(obj) -> None:
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - _T0}
    print(json.dumps(obj), flush=True)


def compiles() -> int:
    """First calls of keyed programs in this process so far
    (``aot_compile_counters["compiles"]``)."""
    import importlib

    return importlib.import_module(
        "raft_tpu_torch.core.aot").aot_compile_counters["compiles"]


def after_warmup(row, c0, what, n=None) -> None:
    """Record the first calls since *c0* (or *n* of them) as *row*'s
    ``compiles_after_warmup`` and require none: traffic after
    ``warmup()`` runs only warmed signatures."""
    row["compiles_after_warmup"] = compiles() - c0 if n is None else n
    check(row["compiles_after_warmup"] == 0,
          f"{what}: {row['compiles_after_warmup']} first calls of keyed "
          "programs after warmup()")


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def timed(fn, device, reps: int = 5) -> float:
    """Median milliseconds of *fn* over *reps* calls after one warm call
    (CUDA events on the card: device time, unless *fn* waits on the
    host)."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            # the card sleeps while the host enqueues the call, so the
            # events time the device's work, not the wrapper's launch
            torch.cuda.synchronize()
            torch.cuda._sleep(SLEEP_CYCLES)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def bound_ms(n_bytes: float, ops: float, ops_per_s: float = F32_FLOP_PER_S):
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = ops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def mixture(gen, n, dim, centers, noise, device):
    import torch

    comp = torch.randint(0, centers.shape[0], (n,), generator=gen,
                         device=device)
    return centers[comp] + noise * torch.randn(n, dim, generator=gen,
                                               device=device)


def near_ties(x, y, rows: int = 1 << 15, of_norms: bool = False,
              bf16_dot: bool = False):
    """Per row of x: whether its two nearest rows of y (float64) lie
    within 1e-5 relative of each other — of the nearer distance, or with
    *of_norms* of ‖x‖² + ‖y‖² of the nearer row, the scale at which the
    float32 expanded form rounds (a row that is itself a centre has a
    distance of 0 and a neighbour a rounding step away).  With *bf16_dot*
    the dot products are those of the bfloat16-rounded operands."""
    import torch

    yd = y.double()
    yn = (yd * yd).sum(1)
    yp = y.bfloat16().double() if bf16_dot else yd
    out = []
    for r in range(0, x.shape[0], rows):
        xd = x[r:r + rows].double()
        xn = (xd * xd).sum(1)
        xp = x[r:r + rows].bfloat16().double() if bf16_dot else xd
        d = xn[:, None] + yn[None] - 2 * xp @ yp.T
        two = torch.topk(d, 2, dim=1, largest=False)
        scale = (xn + yn[two.indices[:, 0]] if of_norms
                 else two.values[:, 0].clamp_min(1e-30))
        out.append((two.values[:, 1] - two.values[:, 0]) <= 1e-5 * scale)
    return torch.cat(out)


def check_labels(name, idx, ref_idx, x, y, of_norms: bool = False,
                 bf16_dot: bool = False):
    diff = idx != ref_idx
    n_diff = int(diff.sum())
    if n_diff:
        ties = near_ties(x, y, of_norms=of_norms, bf16_dot=bf16_dot)
        check(not bool((diff & ~ties).any()),
              f"{name}: labels differ outside near ties")
    return n_diff


def b1_phase(device, x, centers, rep: int):
    """B1 against its plain version at the build path's shapes — the list
    assignment (every row × n_lists), B3's wide-row E-step (the half
    trainset × n_lists), the meso assignment (every row × √n_lists
    mesoclusters) and one mesocluster's fine clustering (its 16,384-row
    bucket × 32 centres): labels equal except at near ties, values
    within 1e-5 of ‖x‖² + ‖y‖² (and, at the list assignment, to rtol
    1e-5, atol 1e-4), a row's bits the same in batches of 1, 7, 1,000 and
    4,097 rows and at other positions in its block; each shape's time
    beside the plain version's, the product alone (``x @ y.T`` in full
    float32, a yardstick: it finds no minimum), the float32 bound outside
    the tensor cores and the bound of three TF32 products on them.
    Returns the list assignment's row."""
    import torch

    from raft_tpu_torch.distance.fused_l2_nn import fused_l2_nn_plain
    from raft_tpu_torch.kernels import fused_l2nn

    n_meso = max(2, int(math.sqrt(centers.shape[0]) + 0.5))
    shapes = {"list_assignment": (x, centers),
              "b3_e_step": (x[: x.shape[0] // 2], centers),
              "meso_assignment": (x, centers[:n_meso]),
              "fine_cluster": (x[:16384], centers[:32])}
    by_shape = {}
    for name, (xs, y) in shapes.items():
        m, d = xs.shape
        k = y.shape[0]
        val, idx = fused_l2nn.fused_l2_nn(xs, y)
        pv, pi = fused_l2_nn_plain(xs, y)
        n_diff = check_labels(f"fused_l2_nn {name}", idx, pi, xs, y)
        scale = (xs * xs).sum(1) + (y * y).sum(1)[idx.long()]
        err = (val - pv).abs()
        check(bool((err <= 1e-5 * scale).all()),
              f"fused_l2_nn {name}: values beyond 1e-5 of the norms")
        if name == "list_assignment":
            check(torch.allclose(val, pv, rtol=1e-5, atol=1e-4),
                  "fused_l2_nn: values beyond rtol 1e-5, atol 1e-4")
            for mb in (1, 7, 1000, 4097):
                v, i = fused_l2nn.fused_l2_nn(xs[:mb], y)
                check(torch.equal(v, val[:mb]) and torch.equal(i, idx[:mb]),
                      f"fused_l2_nn: rows of a {mb}-row batch differ")
            for r0 in (5, 127, 4096 + 60):
                v, i = fused_l2nn.fused_l2_nn(xs[r0:r0 + 7], y)
                check(torch.equal(v, val[r0:r0 + 7])
                      and torch.equal(i, idx[r0:r0 + 7]),
                      f"fused_l2_nn: rows {r0}.. differ in a batch of 7")
        bound, by = bound_ms(4.0 * (m * d + k * d + 2 * m),
                             6.0 * m * k * d, TF32_FLOP_PER_S)
        bound_f32, _ = bound_ms(0.0, 2.0 * m * k * d)
        ms = timed(lambda: fused_l2nn.fused_l2_nn(xs, y), device, rep)
        by_shape[name] = dict(
            shape=[m, k, d], ms=ms,
            plain_ms=timed(lambda: fused_l2_nn_plain(xs, y),
                           device, 3),
            product_only_ms=timed(lambda: xs @ y.T, device, 3),
            bound_ms=bound, bound_by=by, bound_f32_ms=bound_f32,
            share_of_bound=bound / ms, share_of_f32_bound=bound_f32 / ms,
            max_abs_err=float(err.max()),
            max_err_of_norms=float((err / scale).max()),
            label_diffs_near_ties=n_diff)
        emit({"phase": "kernel", "name": f"fused_l2_nn@{name}",
              **by_shape[name]})
        del val, idx, pv, pi, err, scale
    top = by_shape["list_assignment"]
    return dict(max_abs_err=top["max_abs_err"], ms=top["ms"],
                plain_ms=top["plain_ms"], bound_ms=top["bound_ms"],
                bound_by=top["bound_by"], library_ms=None,
                bound_f32_ms=top["bound_f32_ms"],
                product_only_ms=top["product_only_ms"],
                rows_batch_independent=True, by_shape=by_shape)


def b1_fma_phase(device, gen, x, y, rep: int):
    """B1's float32 FMA kernel, which no main path runs: rows wider than
    ``TC_MAX_D`` (1,000 × 1,000 × 300) and ``bf16_dot`` (the first 65,536
    rows of x against the list centres), each against the plain version
    with its labels equal except near ties and values to rtol 1e-5, atol
    1e-4 (``bf16_dot``: both sum the same exact products of bfloat16
    operands in float32, in other orders); returns their times."""
    import torch

    from raft_tpu_torch.distance.fused_l2_nn import fused_l2_nn_plain
    from raft_tpu_torch.kernels import fused_l2nn

    xw = torch.randn(1000, 300, generator=gen, device=device)
    yw = torch.randn(1000, 300, generator=gen, device=device)
    xb = x[:65536]
    out = {}
    for name, (xs, ys, bf16) in {"wide_d300": (xw, yw, False),
                                 "bf16_dot": (xb, y, True)}.items():
        check(not fused_l2nn.tensor_cores(xs.shape[1], bf16),
              f"fused_l2_nn {name}: not dispatched to the FMA kernel")
        val, idx = fused_l2nn.fused_l2_nn(xs, ys, bf16_dot=bf16)
        pv, pi = fused_l2_nn_plain(xs, ys, bf16_dot=bf16)
        n_diff = check_labels(f"fused_l2_nn {name}", idx, pi, xs, ys,
                              bf16_dot=bf16)
        check(torch.allclose(val, pv, rtol=1e-5, atol=1e-4),
              f"fused_l2_nn {name}: values beyond rtol 1e-5, atol 1e-4")
        out[name] = dict(
            shape=[xs.shape[0], ys.shape[0], xs.shape[1]],
            ms=timed(lambda: fused_l2nn.fused_l2_nn(xs, ys, bf16_dot=bf16),
                     device, rep),
            plain_ms=timed(lambda: fused_l2_nn_plain(
                xs, ys, bf16_dot=bf16), device, 3),
            max_abs_err=float((val - pv).abs().max()),
            label_diffs_near_ties=n_diff)
    emit({"phase": "kernel", "name": "fused_l2_nn@fma_kernel", **out})
    return out


def kernel_phase(device, x, queries, centers_probe, rep: int):
    """Each kernel against its plain version; returns the kernels' rows."""
    import torch

    from raft_tpu_torch.distance.fused_l2_nn import (
        cluster_partials_plain,
        fused_l2_nn_partials_plain,
        fused_l2_nn_plain,
    )
    from raft_tpu_torch.kernels import fused_l2nn, select_k as ksel
    from raft_tpu_torch.matrix.select_k import select_k_plain

    rows = {}
    gen = torch.Generator(device=device).manual_seed(11)

    # B1 at the build path's shapes, and a ragged one
    y = centers_probe
    m, d = x.shape
    k = y.shape[0]
    rows["fused_l2_nn"] = b1_phase(device, x, y, rep)
    xr = torch.randn(1000, 100, generator=gen, device=device)
    yr = torch.randn(1000, 100, generator=gen, device=device)
    rv, ri = fused_l2nn.fused_l2_nn(xr, yr)
    prv, pri = fused_l2_nn_plain(xr, yr)
    n_diff_r = check_labels("fused_l2_nn ragged", ri, pri, xr, yr)
    check(torch.allclose(rv, prv, rtol=1e-5, atol=1e-4),
          "fused_l2_nn ragged: values beyond tolerance")
    emit({"phase": "kernel", "name": "fused_l2_nn@ragged",
          "shape": [1000, 1000, 100], "label_diffs_near_ties": n_diff_r})
    rows["fused_l2_nn"]["fma_kernel"] = b1_fma_phase(device, gen, x, y, rep)

    # B3 at the balancing-EM shape (trainset × n_lists × dim)
    xt = x[: m // 2]
    mt = xt.shape[0]
    out = fused_l2nn.fused_l2_nn_partials(xt, y)
    ref = fused_l2_nn_partials_plain(xt, y)
    n_diff3 = check_labels("fused_l2_nn_partials", out[1], ref[1], xt, y)
    sums_ref, wsum_ref = cluster_partials_plain(xt, out[1], k)
    abs_ref, _ = cluster_partials_plain(xt.abs(), out[1], k)
    err3 = float((out[2] - sums_ref).abs().max())
    check(bool(((out[2] - sums_ref).abs() <= 1e-4 * abs_ref + 1e-6).all()),
          "fused_l2_nn_partials: sums beyond 1e-4 of the members' |sum|")
    check(torch.allclose(out[3], wsum_ref, rtol=1e-4),
          "fused_l2_nn_partials: weights beyond rtol 1e-4")
    again = fused_l2nn.fused_l2_nn_partials(xt, y)
    check(torch.equal(again[2], out[2]), "fused_l2_nn_partials: sums "
          "differ between two runs")
    ms = timed(lambda: fused_l2nn.fused_l2_nn_partials(xt, y), device, rep)
    plain_ms = timed(lambda: fused_l2_nn_partials_plain(xt, y),
                     device, 3)
    # the M-step alone (per-chunk partials from B1's labels) beside its
    # bytes bound: one read of x and the labels, the partials written
    m_ms = (timed(lambda: fused_l2nn._launch_cluster_partials(
        xt, out[1], None, k), device, rep) if device.type == "cuda" else None)
    m_bound, _ = bound_ms(4.0 * (mt * d + mt + k * d + k), 0.0)
    # the E-step's products as three TF32 passes on the tensor cores and
    # the M-step's adds in float32, each at its own rate; beside it the
    # float32 bound of the products as they were before
    t_bytes = 4.0 * (mt * d + 2 * k * d + 2 * mt + k) / HBM_BYTES_PER_S
    t_ops = (6.0 * mt * k * d / TF32_FLOP_PER_S
             + 1.0 * mt * d / F32_FLOP_PER_S)
    b = max(t_bytes, t_ops) * 1e3
    by = "bytes" if t_bytes >= t_ops else "operations"
    b_f32, _ = bound_ms(0.0, 2.0 * mt * k * d + mt * d)
    rows["fused_l2_nn_partials"] = dict(max_abs_err=err3, ms=ms,
                                        plain_ms=plain_ms, bound_ms=b,
                                        bound_by=by, library_ms=None,
                                        bound_f32_ms=b_f32,
                                        m_step_ms=m_ms,
                                        m_step_bound_ms=m_bound)
    emit({"phase": "kernel", "name": "fused_l2_nn_partials",
          "shape": [mt, k, d], "label_diffs_near_ties": n_diff3,
          "sums_bitwise_repeat": True, **rows["fused_l2_nn_partials"]})

    # B1 and B3 at the PQ codebook-training shape: one Lloyd step of one
    # subspace (pq_trainset_cap × 2^8 codewords × ds = 2)
    xc = torch.randn(262144, 2, generator=gen, device=device)
    yc = xc[torch.randperm(262144, generator=gen, device=device)[:256]]
    cv, ci = fused_l2nn.fused_l2_nn(xc, yc)
    pcv, pci = fused_l2_nn_plain(xc, yc)
    n_diff_c = check_labels("fused_l2_nn codebook", ci, pci, xc, yc)
    check(torch.allclose(cv, pcv, rtol=1e-5, atol=1e-5),
          "fused_l2_nn codebook: values beyond rtol 1e-5, atol 1e-5")
    outc = fused_l2nn.fused_l2_nn_partials(xc, yc)
    sums_c, wsum_c = cluster_partials_plain(xc, outc[1], 256)
    abs_c, _ = cluster_partials_plain(xc.abs(), outc[1], 256)
    check(bool(((outc[2] - sums_c).abs() <= 1e-4 * abs_c + 1e-6).all())
          and torch.allclose(outc[3], wsum_c, rtol=1e-4),
          "fused_l2_nn_partials codebook: partials beyond tolerance")
    for name, fn, plain_fn in (
            ("fused_l2_nn", fused_l2nn.fused_l2_nn,
             fused_l2_nn_plain),
            ("fused_l2_nn_partials", fused_l2nn.fused_l2_nn_partials,
             fused_l2_nn_partials_plain)):
        rows[name].update(
            codebook_shape=[262144, 256, 2],
            codebook_ms=timed(lambda: fn(xc, yc), device, rep),
            codebook_plain_ms=timed(lambda: plain_fn(xc, yc), device, rep))
    rows["fused_l2_nn"]["codebook_max_abs_err"] = float(
        (cv - pcv).abs().max())
    rows["fused_l2_nn_partials"]["codebook_max_abs_err"] = float(
        (outc[2] - sums_c).abs().max())
    emit({"phase": "kernel", "name": "fused_l2_nn+partials@codebook",
          "shape": [262144, 256, 2], "label_diffs_near_ties": n_diff_c,
          **{f"{n}_{key}": rows[n][key]
             for n in ("fused_l2_nn", "fused_l2_nn_partials")
             for key in ("codebook_ms", "codebook_plain_ms",
                         "codebook_max_abs_err")}})
    rows["fused_l2_nn_partials"].update(
        b3_batched_phase(device, gen, rep, min(262144, m)))
    # PER_CLUSTER's codebook step: every list's 1,024-row sample at once
    rows["fused_l2_nn_partials"].update(
        b3_batched_phase(device, gen, rep, 1024, s=1024,
                         prefix="per_cluster"))

    # B2 at the coarse top-n_probes shape, a probe-tile shape, a
    # brute-force scan step, and a matrix of ties, NaN and ±inf; float32,
    # float16 and bfloat16 rows
    from raft_tpu_torch.distance.distance_types import DistanceType
    from raft_tpu_torch.kernels import pairwise as pk
    from raft_tpu_torch.neighbors.ivf_flat import _coarse_distances

    coarse = _coarse_distances(queries, y, DistanceType.L2Expanded)
    cases = {
        "coarse": (coarse, 20),
        "probe_tile": (torch.rand(1024, 2448, generator=gen, device=device)
                       * 100.0, 10),
        # a brute-force scan step: L1 distances of 1,024 queries to 16,384
        # rows (B5's output)
        "scan": (pk.pairwise_accumulate(queries[:1024], x[:16384], "l1"),
                 10),
    }
    ties = torch.randint(-40, 40, (1000, 1000), generator=gen,
                         device=device).float() / 4.0
    flat = ties.view(-1)
    spots = torch.randperm(flat.numel(), generator=gen, device=device)[:30000]
    flat[spots[:10000]] = float("nan")
    flat[spots[10000:20000]] = float("inf")
    flat[spots[20000:]] = float("-inf")
    cases["ties_nan_inf"] = (ties, 128)
    info = {}
    for name, (vals, kk) in cases.items():
        for dt in (torch.float32, torch.float16, torch.bfloat16):
            vd = vals.to(dt)
            for select_min in (True, False):
                kv, kp = ksel.select_k_blockwise(vd, kk, select_min)
                pv2, pp = select_k_plain(vd, kk, select_min)
                check(torch.equal(kp, pp),
                      f"select_k {name} {dt}: positions differ")
                check(torch.equal(torch.nan_to_num(kv.float(), nan=0.5),
                                  torch.nan_to_num(pv2.float(), nan=0.5)),
                      f"select_k {name} {dt}: values differ")
        info[name] = [list(vals.shape), kk]
    by_shape = {}
    for name in ("coarse", "probe_tile", "scan"):
        vals, kk = cases[name]
        nq, nl = vals.shape
        b, by = bound_ms(4.0 * nq * nl + 8.0 * nq * kk, float(nq * nl))
        by_shape[name] = dict(
            shape=[nq, nl, kk], bound_ms=b, bound_by=by,
            ms=timed(lambda: ksel.select_k_blockwise(vals, kk), device, rep),
            plain_ms=timed(lambda: select_k_plain(vals, kk), device, rep),
            library_ms=timed(lambda: torch.topk(vals, kk, dim=1,
                                                largest=False), device, rep),
            half_ms={str(dt).split(".")[1]: timed(
                lambda h=vals.to(dt): ksel.select_k_blockwise(h, kk), device,
                rep) for dt in (torch.float16, torch.bfloat16)})
    # the brute-force scan shape is where B2 spends most of its time
    scan = by_shape["scan"]
    rows["select_k"] = dict(max_abs_err=0.0, ms=scan["ms"],
                            plain_ms=scan["plain_ms"],
                            bound_ms=scan["bound_ms"],
                            bound_by=scan["bound_by"],
                            library_ms=scan["library_ms"], by_shape=by_shape)
    emit({"phase": "kernel", "name": "select_k", "shape": scan["shape"],
          "cases": info, "positions_bit_identical": True,
          "library": "torch.topk", **rows["select_k"]})
    return rows


def b3_batched_phase(device, gen, rep: int, n: int, s: int = 64,
                     prefix: str = "batched"):
    """B3 at an IVF-PQ codebook step: s codebooks of n × 2 against 256
    codewords in one launch — the 64 subspaces of PER_SUBSPACE at the
    build's pq_trainset_cap (262,144), or PER_CLUSTER's 1,024 lists of
    1,024 samples — against its plain twin and against launches of one
    codebook each (bit for bit; every codebook of 64, 16 spread over
    more); returns the fields for B3's row, under *prefix*."""
    import torch

    from raft_tpu_torch.distance.fused_l2_nn import (
        cluster_partials_plain,
        fused_l2_nn_partials_batched_plain,
    )
    from raft_tpu_torch.kernels import fused_l2nn

    k, ds = 256, 2
    xs = torch.randn(s, n, ds, generator=gen, device=device)
    ys = torch.stack([xs[i, torch.randperm(n, generator=gen,
                                           device=device)[:k]]
                      for i in range(s)])
    out = fused_l2nn.fused_l2_nn_partials_batched(xs, ys)
    ref = fused_l2_nn_partials_batched_plain(xs, ys)
    n_diff, err = 0, 0.0
    for i in (range(s) if s <= 64 else range(0, s, s // 16)):
        n_diff += check_labels("fused_l2_nn_partials batched", out[1][i],
                               ref[1][i], xs[i], ys[i], of_norms=True)
        sums, wsum = cluster_partials_plain(xs[i], out[1][i], k)
        mag, _ = cluster_partials_plain(xs[i].abs(), out[1][i], k)
        check(bool(((out[2][i] - sums).abs() <= 1e-5 * mag + 1e-6).all())
              and torch.equal(out[3][i], wsum),
              "fused_l2_nn_partials batched: partials beyond 1e-5 of the "
              "members' |sum|")
        err = max(err, float((out[2][i] - sums).abs().max()))
        one = fused_l2nn.fused_l2_nn_partials(xs[i], ys[i])
        check(all(torch.equal(a[i], b) for a, b in zip(out, one)),
              "fused_l2_nn_partials batched: differs from the one-subspace "
              "launch")
    again = fused_l2nn.fused_l2_nn_partials_batched(xs, ys)
    check(all(torch.equal(a, b) for a, b in zip(again, out)),
          "fused_l2_nn_partials batched: differs between two runs")
    # the least work: x and the centres read, labels, values and partials
    # written; (ds + 4) float32 instructions per (row, centre) pair (ds
    # fused multiply-adds, the expanded form, the clamp and the compare)
    b, by = bound_ms(4.0 * (s * n * ds + 2 * s * k * ds + 2 * s * n + s * k),
                     float(s) * n * k * (ds + 4), F32_INSTR_PER_S)
    row = {
        f"{prefix}_shape": [s, n, k, ds], f"{prefix}_max_abs_err": err,
        f"{prefix}_label_diffs_near_ties": n_diff, f"{prefix}_bound_ms": b,
        f"{prefix}_bound_by": by,
        f"{prefix}_ms": timed(lambda: fused_l2nn.fused_l2_nn_partials_batched(
            xs, ys), device, rep),
        f"{prefix}_plain_ms": timed(
            lambda: fused_l2_nn_partials_batched_plain(xs, ys),
            device, 3)}
    if s <= 64:
        row["per_subspace_x64_ms"] = timed(lambda: [
            fused_l2nn.fused_l2_nn_partials(xs[i], ys[i]) for i in range(s)],
            device, 3)
    emit({"phase": "kernel", "name": f"fused_l2_nn_partials@{prefix}",
          "equals_per_subspace_launches": True, "sums_bitwise_repeat": True,
          **row})
    return row


def recall(ids, truth):
    hits = (ids[:, :, None] == truth[:, None, :]).any(-1).sum()
    return float(hits) / truth.numel()


def _kernel_events(prof):
    """The device rows of a profile: kernels and copies, without the CPU-op
    rows (which repeat their kernels' time) and without the telemetry
    spans' ``record_function`` ranges (``serve.*``, which span them)."""
    events = [e for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA")
              and e.self_device_time_total > 0
              and not e.key.startswith("serve.")]
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    return events


def profile_serve(path, eng, q_host, device, top: int = 12):
    """Device time by kernel over one full super-batch (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    batch = q_host[:eng.max_batch]
    eng.search([batch])   # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.search([batch])   # the wall time, without the profiler
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.search([batch])
        torch.cuda.synchronize()
    events = _kernel_events(prof)
    # host-to-device copies run on the copy engines beside the kernels
    copies = [e for e in events if e.key.startswith("Memcpy")]
    kernels = [e for e in events if not e.key.startswith("Memcpy")]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    emit({"phase": "profile", "path": path, "queries": len(batch),
          "wall_ms": wall_ms, "device_ms": device_ms,
          "copy_ms": sum(e.self_device_time_total for e in copies) / 1e3,
          "kernel_launches": sum(e.count for e in kernels),
          "device_busy_share": device_ms / wall_ms if wall_ms else None,
          "top": [{"name": e.key[:80], "calls": e.count,
                   "device_ms": e.self_device_time_total / 1e3}
                  for e in events[:top]]})


#: kernel names of the port's own kernels in a profile (the rest are
#: PyTorch's and cuBLAS's)
OWN_KERNELS = ("fused_l2nn", "tile_y", "em_small", "cluster_partials",
               "reduce_partials", "select_", "lut_", "pairwise")


def profile_build(path, device, x, n_lists: int, top: int = 12):
    """Wall seconds of three builds (median), then device time by kernel
    (torch.profiler) over one more, stage by stage: IVF-Flat's build
    whole, IVF-PQ's training (coarse k-means, list assignment, rotation,
    codebooks) and its population (encode, pack); B1's and B3's kernels
    and PyTorch's own."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from raft_tpu_torch.neighbors import ivf_flat, ivf_pq

    mod = {"ivf_flat": ivf_flat, "ivf_pq": ivf_pq}[path]
    params = mod.IndexParams(n_lists=n_lists)

    def synced(fn):
        out = fn()
        torch.cuda.synchronize()
        return out

    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        synced(lambda: mod.build(params, x, device=device))
        walls.append(time.perf_counter() - t0)
    if path == "ivf_pq":
        model = {}

        def train():
            model["m"] = ivf_pq._train_model(params, x, None)

        def populate():
            centers, labels, rotation, codebooks = model["m"]
            index = ivf_pq._empty_index(centers, rotation, codebooks,
                                        params.metric, params.pq_bits,
                                        "float32")
            ivf_pq._populate(index, x, None, labels)

        stages = {"train": train, "populate": populate}
    else:
        stages = {"build": lambda: mod.build(params, x, device=device)}
    for stage, fn in stages.items():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            synced(fn)
        events = _kernel_events(prof)

        def ms(keys, own=True):
            return sum(e.self_device_time_total for e in events
                       if any(k in e.key for k in keys) == own) / 1e3

        emit({"phase": "profile_build", "path": path, "stage": stage,
              "build_wall_s": statistics.median(walls),
              "build_walls_s": walls,
              "device_ms": ms(OWN_KERNELS) + ms(OWN_KERNELS, own=False),
              "kernel_launches": sum(e.count for e in events),
              "b1_ms": ms(("fused_l2nn", "tile_y")),
              "b1_launches": sum(e.count for e in events
                                 if "fused_l2nn" in e.key),
              "b3_m_step_ms": ms(("em_small", "cluster_partials",
                                  "reduce_partials")),
              "torch_kernels_ms": ms(OWN_KERNELS, own=False),
              "top": [{"name": e.key[:90], "calls": e.count,
                       "device_ms": e.self_device_time_total / 1e3}
                      for e in events[:top]]})


def profile_kmeans(device, x, params, top: int = 12):
    """Where the k-means‖ init's time goes: wall seconds of three inits
    (median), then device time by kernel (torch.profiler) over one more;
    the same for its weighted k-means++ finish alone, on a candidate
    buffer of the init's width (1 + 5·l rows of x) weighted by the rows
    each owns.  The device's busy share is device time over wall time;
    the finish's launches a step are its launches over its k − 1 greedy
    steps."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from raft_tpu_torch.cluster import kmeans, min_cluster_and_distance
    from raft_tpu_torch.random import RngState

    n, k = x.shape[0], params.n_clusters
    l = int(params.oversampling_factor * k)
    cap = 1 + 5 * l
    gen = torch.Generator(device=device).manual_seed(params.seed + 41)
    cand = x[torch.randperm(n, generator=gen, device=device)[:cap]]
    owner = min_cluster_and_distance(x, cand).key.long()
    counts = torch.zeros(cap, device=device).index_add_(
        0, owner, torch.ones(n, device=device))
    u = torch.rand((k, kmeans.local_trials(k)), dtype=torch.float64,
                   generator=gen, device=device)
    stages = {
        "init_plus_plus": lambda: kmeans.init_plus_plus(
            RngState(params.seed), x, k, params.oversampling_factor,
            metric=params.metric),
        "finish": lambda: kmeans._weighted_kmeans_pp(u, cand, counts, k)}
    for stage, fn in stages.items():
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = _kernel_events(prof)
        wall_ms = statistics.median(walls) * 1e3
        device_ms = sum(e.self_device_time_total for e in events) / 1e3
        launches = sum(e.count for e in events)
        emit({"phase": "profile_kmeans", "stage": stage,
              "shape": [n, x.shape[1], k], "candidates": cap,
              "local_trials": kmeans.local_trials(k),
              "wall_ms": wall_ms, "walls_s": walls, "device_ms": device_ms,
              "device_busy_share": device_ms / wall_ms,
              "kernel_launches": launches,
              "launches_per_finish_step": (launches / (k - 1)
                                           if stage == "finish" else None),
              "b1_launches": sum(e.count for e in events
                                 if "fused_l2nn" in e.key),
              "top": [{"name": e.key[:90], "calls": e.count,
                       "device_ms": e.self_device_time_total / 1e3}
                      for e in events[:top]]})


def ragged_calls(q_host, n_queries: int):
    """Ragged requests covering every query, eight to a call."""
    pattern = [1, 7, 64, 300, 1500, 33, 128, 900, 2, 511]
    reqs, start, j = [], 0, 0
    while start < n_queries:
        size = min(pattern[j % len(pattern)], n_queries - start)
        reqs.append(q_host[start:start + size])
        start += size
        j += 1
    return reqs, [reqs[c:c + 8] for c in range(0, len(reqs), 8)]


def serve_path(path, device, eng, k, reqs, calls, n_queries):
    """Serve every query through *eng* after its warmup; the launch counts
    were reset before the path began and are read right after serving."""
    import torch

    from raft_tpu_torch.kernels import native

    t0 = time.perf_counter()
    n_warm = eng.warmup()
    warm_s = time.perf_counter() - t0
    c0 = compiles()
    call_s, results = [], []
    t_serve = time.perf_counter()
    for call in calls:
        t0 = time.perf_counter()
        results.extend(eng.search(call))
        call_s.append(time.perf_counter() - t0)
    serve_s = time.perf_counter() - t_serve
    launches = dict(native.LAUNCHES)
    row = {"phase": "serve", "path": path, "requests": len(reqs),
           "calls": len(calls), "queries": n_queries,
           "max_batch": eng.max_batch, "warmup_signatures": n_warm,
           "warmup_s": warm_s, "serve_s": serve_s,
           "qps": n_queries / serve_s,
           "call_ms_p50": float(np.percentile(call_s, 50) * 1e3),
           "call_ms_p99": float(np.percentile(call_s, 99) * 1e3),
           "stats": dict(eng.stats), "launches": launches,
           "peak_mem_bytes": (torch.cuda.max_memory_allocated()
                              if device.type == "cuda" else None)}
    after_warmup(row, c0, f"{path} serve")
    emit(row)
    for name in PATH_KERNELS[path]:
        check(launches[name] > 0, f"{path} main path never launched {name}")
    for q, (d, i) in zip(reqs, results):
        check(isinstance(d, np.ndarray), f"a request failed: {d!r}")
        check(d.shape == (q.shape[0], k) and np.isfinite(d).all(),
              "results must be finite (n, k)")
    return results, launches, row


#: what a serving path hands its open-loop phase: the serve phase's
#: results (one (distances, ids) pair per ragged request, every query in
#: order), its emitted row, and a factory of an engine like its own
Served = collections.namedtuple("Served", "results row make")


def _stream_pass(eng, reqs, rate_qps, deadline_s, seed, during=None):
    """Submit *reqs* from a feeder thread as a Poisson process of
    *rate_qps* queries a second (exponential gaps of mean rows / rate);
    every ``STREAM_DEADLINE_EVERY``-th request is a ``ServeRequest``
    with *deadline_s* (None: no deadlines).  *during* runs in this
    thread while the feeder submits.  Returns each request's result or
    exception, the time it was due (its arrival on the schedule, from
    which an open loop times it), its submit time and its completion
    time."""
    import concurrent.futures

    from raft_tpu_torch.serve import ServeRequest

    n = len(reqs)
    mean_rows = float(np.mean([q.shape[0] for q in reqs]))
    gaps = np.random.default_rng(seed).exponential(mean_rows / rate_qps, n)
    arrivals = np.cumsum(gaps) - gaps[0]
    futs, t_due, t_sub, t_done = [None] * n, [0.0] * n, [0.0] * n, [None] * n

    def stamp(j):
        return lambda _f: t_done.__setitem__(j, time.perf_counter())

    def feed():
        t0 = time.perf_counter()
        for j, q in enumerate(reqs):
            delay = t0 + arrivals[j] - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            t_due[j] = t0 + arrivals[j]
            req = (ServeRequest(q, timeout_s=deadline_s)
                   if deadline_s is not None
                   and j % STREAM_DEADLINE_EVERY == STREAM_DEADLINE_EVERY - 1
                   else q)
            t_sub[j] = time.perf_counter()
            f = eng.submit(req)
            f.add_done_callback(stamp(j))
            futs[j] = f

    feeder = threading.Thread(target=feed, daemon=True)
    feeder.start()
    if during is not None:
        during()
    feeder.join(float(arrivals[-1]) + STREAM_WAIT_S)
    check(not feeder.is_alive(), "serve_stream: the feeder hung")
    outs = []
    for f in futs:
        try:
            outs.append(f.result(timeout=STREAM_WAIT_S))
        except concurrent.futures.TimeoutError:
            check(False, "serve_stream: a submitted request never resolved")
        except Exception as e:   # typed rejections, checked by the caller
            outs.append(e)
    return outs, t_due, t_sub, t_done


def _check_stream(path, outs, reqs, offsets, ref_d, ref_i, rejections_ok):
    """Every served request bit for bit the serve phase's rows; every other
    one a typed ``RejectedError`` (if *rejections_ok*).  Returns the
    rejection counts by reason."""
    from raft_tpu_torch.serve import RejectedError

    rejected: dict = {}
    for q, off, out in zip(reqs, offsets, outs):
        if isinstance(out, tuple):
            d, i = out
            n = q.shape[0]
            check(np.array_equal(d, ref_d[off:off + n])
                  and np.array_equal(i, ref_i[off:off + n]),
                  f"{path} serve_stream: a result differs from the serve "
                  "phase's search() result")
            continue
        check(rejections_ok and isinstance(out, RejectedError),
              f"{path} serve_stream: a request failed: {out!r}")
        rejected[out.reason] = rejected.get(out.reason, 0) + 1
    return rejected


def _stream_row(path, rate, eng, reqs, timed, rejected, offered_qps,
                deadline_s, smi):
    outs, t_due, t_sub, t_done = timed
    served = [j for j, o in enumerate(outs) if isinstance(o, tuple)]
    rows = sum(reqs[j].shape[0] for j in served)
    e2e = [t_done[j] - t_due[j] for j in served]
    span = (max(t_done[j] for j in served) - min(t_due)) if served else 0.0
    p50, p99 = eng.latency_quantiles((0.5, 0.99))
    stats = dict(eng.stats)
    arrivals = max(t_due) - min(t_due)
    return {"phase": "serve_stream", "path": path, "rate": rate,
            "offered_qps": offered_qps,
            "arrival_qps": (sum(q.shape[0] for q in reqs) / arrivals
                            if arrivals else None),
            "achieved_qps": rows / span if span else None,
            "requests": len(reqs), "served_requests": len(served),
            "queries": sum(q.shape[0] for q in reqs), "served_queries": rows,
            "deadline_every": STREAM_DEADLINE_EVERY, "deadline_s": deadline_s,
            "latency_s_p50": p50, "latency_s_p99": p99,
            "e2e_latency_s_p50": (float(np.percentile(e2e, 50))
                                  if e2e else None),
            "e2e_latency_s_p99": (float(np.percentile(e2e, 99))
                                  if e2e else None),
            "generator_late_s_max": max(b - a for a, b in zip(t_due, t_sub)),
            "rejected": rejected,
            "stats": {key: stats[key] for key in STREAM_STATS},
            "card": smi}


def serve_stream(path, device, served, q_host, n_queries, smi, seed,
                 rates=STREAM_RATES, refresh_index=None, checks=True):
    """The open-loop phase of one serving path: fresh engines like the
    serve phase's, fed through ``submit()`` at each rate (a fraction of
    the serve phase's qps) with the serve phase's ragged requests over
    *n_queries*; then, with *checks*, a transient dispatch fault, a
    ``refresh`` under traffic (of *refresh_index*), the scrape surface and
    ``close()``.  Launch counts are reset before it and read after;
    returns them."""
    import urllib.request

    from raft_tpu_torch.kernels import native
    from raft_tpu_torch.serve import RejectedError
    from raft_tpu_torch.testing import faults

    ref_d = np.concatenate([r[0] for r in served.results])
    ref_i = np.concatenate([r[1] for r in served.results])
    reqs, _ = ragged_calls(q_host, n_queries)
    offsets = np.cumsum([0] + [q.shape[0] for q in reqs[:-1]])
    qps = served.row["qps"]
    deadline_s = STREAM_DEADLINE_X * served.row["call_ms_p50"] / 1e3
    _reset(device)
    eng = None
    for r, rate in enumerate(rates):
        if eng is not None:
            eng.close()
        eng = served.make()
        eng.warmup()
        c0 = compiles()
        timed = _stream_pass(eng, reqs, rate * qps, deadline_s, seed + r)
        rejected = _check_stream(path, timed[0], reqs, offsets, ref_d,
                                 ref_i, rejections_ok=True)
        row = _stream_row(path, rate, eng, reqs, timed, rejected, rate * qps,
                          deadline_s, smi)
        after_warmup(row, c0, f"{path} serve_stream at {rate}")
        emit(row)
    out = {"phase": "serve_stream_checks", "path": path, "card": smi}
    if checks:
        # one transient dispatch fault: retried on the other lane
        check(eng.stats["retries"] == 0, f"{path}: retries before the fault")
        c0 = compiles()
        with faults.plan("dispatch:n=1:raise"):
            futs = [eng.submit(q) for q in reqs[:8]]
            eng.flush()
            outs = [f.result(timeout=STREAM_WAIT_S) for f in futs]
        _check_stream(path, outs, reqs[:8], offsets[:8], ref_d, ref_i,
                      rejections_ok=False)
        check(eng.stats["retries"] == 1,
              f"{path}: one injected fault gave {eng.stats['retries']} "
              "retries")
        out["fault_retries"] = eng.stats["retries"]
        out["fault_compiles"] = compiles() - c0
        check(out["fault_compiles"] == 0,
              f"{path}: the retried dispatch made a first call")
        if refresh_index is not None:
            t0 = time.perf_counter()
            outs = _stream_pass(
                eng, reqs, rates[0] * qps, None, seed + len(rates),
                during=lambda: eng.refresh(refresh_index))[0]
            out["refresh_s"] = time.perf_counter() - t0
            _check_stream(path, outs, reqs, offsets, ref_d, ref_i,
                          rejections_ok=False)
            check(eng.stats["refreshes"] == 1,
                  f"{path}: refreshes {eng.stats['refreshes']} != 1")
            out["refreshes"] = eng.stats["refreshes"]
        srv = eng.serve_http(0)
        with urllib.request.urlopen(srv.url + "/metrics", timeout=10) as rsp:
            metrics = rsp.read().decode()
        check("raft_tpu_serve_request_latency_seconds" in metrics,
              f"{path}: /metrics lacks the request latency histogram")
        with urllib.request.urlopen(srv.url + "/healthz", timeout=10) as rsp:
            check(rsp.status == 200, f"{path}: /healthz {rsp.status}")
            out["healthz"] = rsp.status
        # close() resolves what is pending; a later submit() is refused
        futs = [eng.submit(q) for q in reqs[:8]]
        eng.close()
        outs = []
        for f in futs:
            try:
                outs.append(f.result(timeout=STREAM_WAIT_S))
            except RejectedError as e:
                outs.append(e)
        _check_stream(path, outs, reqs[:8], offsets[:8], ref_d, ref_i,
                      rejections_ok=True)
        out["closed_pending"] = sum(not isinstance(o, tuple) for o in outs)
        try:
            eng.submit(reqs[0])
            check(False, f"{path}: submit() after close() was accepted")
        except RejectedError:
            pass
    eng.close()
    launches = dict(native.LAUNCHES)
    for name in STREAM_KERNELS[path]:
        check(launches[name] > 0,
              f"{path} serve_stream never launched {name}")
    out["launches"] = launches
    emit(out)
    return launches


def emit_build(path, index, build_s, build_info):
    emit({"phase": "build", "path": path, "seconds": build_s,
          "n_lists": index.n_lists, "capacity": index.capacity,
          "padding_fraction": index.padding_fraction, **build_info})


def check_coalesced(path, search_fn, reqs, results):
    for q, (d, i) in zip(reqs, results):
        sd, si = search_fn(q)
        check(np.array_equal(d, sd.cpu().numpy())
              and np.array_equal(i, si.cpu().numpy()),
              f"{path}: coalesced results differ from solo search")


def _reset(device):
    import torch

    from raft_tpu_torch.kernels import native

    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    native.reset_launches()


class _PathLaunches:
    """The launch counts of one path's own work, when a phase interleaves
    it with comparison runs: each :meth:`span` sets the counts to 0 on
    entry and adds them to :attr:`total` on exit, so what runs between
    spans is not counted."""

    def __init__(self):
        from raft_tpu_torch.kernels import native

        self.total = {name: 0 for name in native.LAUNCHES}

    @contextlib.contextmanager
    def span(self):
        from raft_tpu_torch.kernels import native

        native.reset_launches()
        yield
        for name, n in native.LAUNCHES.items():
            self.total[name] += n


def _synced_seconds(device, t0) -> float:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize()
    return time.perf_counter() - t0


def _first_ids(results, nr, device):
    import torch

    return torch.as_tensor(np.concatenate([r[1] for r in results])[:nr],
                           device=device).long()


def plain_build_recall(mod, index_params, search_params, x, qr, k, truth,
                       device):
    """Recall@10 of the whole plain path — the index built through the
    kernels' plain versions (``engine="torch"``) and searched through
    them — and that build's seconds."""
    t0 = time.perf_counter()
    index = mod.build(index_params, x, device=device, engine="torch")
    build_s = _synced_seconds(device, t0)
    _, ids = mod.search(search_params, index, qr, k, engine="torch")
    return recall(ids.long(), truth), build_s


def ivf_flat_path(device, x, reqs, calls, n_queries, truth, qr, n_lists,
                  n_probes, k):
    """The IVF-Flat main path and its checks; returns (engine, launches,
    served)."""
    from raft_tpu_torch.neighbors import ivf_flat
    from raft_tpu_torch.serve import ServeEngine

    _reset(device)
    t0 = time.perf_counter()
    index = ivf_flat.build(ivf_flat.IndexParams(n_lists=n_lists), x,
                           device=device)
    build_s = _synced_seconds(device, t0)
    check(index.size == x.shape[0], "build: index does not hold every row")
    params = ivf_flat.SearchParams(n_probes=n_probes)
    emit_build("ivf_flat", index, build_s,
               {"physical_rows": int(index.list_data.shape[0]),
                "index_bytes": index.list_data.numel() * 4})
    eng = ServeEngine(index, k, params, max_batch=1024)
    results, launches, row = serve_path("ivf_flat", device, eng, k, reqs,
                                        calls, n_queries)
    check_coalesced("ivf_flat",
                    lambda q: ivf_flat.search(params, index, q, k),
                    reqs, results)
    nr = qr.shape[0]
    ids_kernel = _first_ids(results, nr, device)
    _, ids_plain = ivf_flat.search(params, index, qr, k, engine="torch")
    r_kernel = recall(ids_kernel, truth)
    r_plain = recall(ids_plain.long(), truth)
    r_pb, pb_s = plain_build_recall(ivf_flat,
                                    ivf_flat.IndexParams(n_lists=n_lists),
                                    params, x, qr, k, truth, device)
    emit({"phase": "checks", "path": "ivf_flat",
          "coalesced_equals_solo": True, "recall_at_10": r_kernel,
          "recall_at_10_plain_path": r_plain,
          "recall_at_10_plain_build": r_pb, "plain_build_s": pb_s,
          "recall_queries": nr})
    check(abs(r_kernel - r_plain) <= 0.002,
          "ivf_flat: kernel-path recall is not within 0.002 of the plain "
          "path's")
    check(abs(r_kernel - r_pb) <= BUILD_RECALL_TOL["ivf_flat"],
          f"ivf_flat: the kernel-built index's recall is not within "
          f"{BUILD_RECALL_TOL['ivf_flat']} of the plain-built index's")
    return eng, launches, Served(
        results, row, lambda: ServeEngine(index, k, params, max_batch=1024))


def ivf_pq_path(device, x, reqs, calls, n_queries, truth, qr, n_lists,
                n_probes, k):
    """The IVF-PQ main path and its checks; returns (index, engine,
    launches, served)."""
    from raft_tpu_torch.kernels import native
    from raft_tpu_torch.neighbors import ivf_pq
    from raft_tpu_torch.serve import ServeEngine

    _reset(device)
    t0 = time.perf_counter()
    index = ivf_pq.build(ivf_pq.IndexParams(n_lists=n_lists), x,
                         device=device)
    build_s = _synced_seconds(device, t0)
    check(index.size == x.shape[0], "build: index does not hold every row")
    # the coarse trainer's balancing EM and one batched launch per
    # codebook Lloyd iteration for all pq_dim subspaces
    b3_build = native.LAUNCHES["fused_l2_nn_partials"]
    check(0 < b3_build <= MAX_PQ_BUILD_B3,
          f"ivf_pq build launched B3 {b3_build} times (at most "
          f"{MAX_PQ_BUILD_B3})")
    leaf_bytes = sum(getattr(index, f).numel()
                     * getattr(index, f).element_size()
                     for f in ivf_pq.ARRAY_FIELDS)
    params = ivf_pq.SearchParams(n_probes=n_probes)
    emit_build("ivf_pq", index, build_s,
               {"b3_launches": b3_build,
                "pq_dim": index.pq_dim, "pq_bits": index.pq_bits,
                "physical_rows": int(index.list_codes.shape[0]),
                "code_bytes_per_row": int(index.list_codes.shape[2]),
                "codes_bytes": index.list_codes.numel(),
                "index_bytes": leaf_bytes})
    eng = ServeEngine(index, k, params, max_batch=1024)
    results, launches, row = serve_path("ivf_pq", device, eng, k, reqs,
                                        calls, n_queries)
    check(launches["lut_score"] == 0, "ivf_pq: the scan launched B4's "
          "per-step raw mode instead of one scan-mode launch per batch")
    check_coalesced("ivf_pq", lambda q: ivf_pq.search(params, index, q, k),
                    reqs, results)
    nr = qr.shape[0]
    ids_kernel = _first_ids(results, nr, device)
    _, ids_plain = ivf_pq.search(params, index, qr, k, engine="torch")
    r_kernel = recall(ids_kernel, truth)
    r_plain = recall(ids_plain.long(), truth)
    p8 = ivf_pq.SearchParams(n_probes=n_probes, lut_dtype="float8_e4m3")
    _, ids8 = ivf_pq.search(p8, index, qr, k)
    _, ids8_plain = ivf_pq.search(p8, index, qr, k, engine="torch")
    r8, r8_plain = recall(ids8.long(), truth), recall(ids8_plain.long(),
                                                      truth)
    r_pb, pb_s = plain_build_recall(ivf_pq,
                                    ivf_pq.IndexParams(n_lists=n_lists),
                                    params, x, qr, k, truth, device)
    emit({"phase": "checks", "path": "ivf_pq",
          "coalesced_equals_solo": True, "recall_at_10": r_kernel,
          "recall_at_10_plain_path": r_plain,
          "recall_at_10_plain_build": r_pb, "plain_build_s": pb_s,
          "recall_at_10_fp8": r8, "recall_at_10_fp8_plain_path": r8_plain,
          "fp8_batch_cap": ivf_pq.hoisted_batch_cap(index, n_probes,
                                                    "float8_e4m3"),
          "recall_queries": nr})
    check(abs(r_kernel - r_plain) <= 0.002,
          "ivf_pq: kernel-path recall is not within 0.002 of the plain "
          "path's")
    check(abs(r8 - r8_plain) <= 0.002,
          "ivf_pq fp8: kernel-path recall is not within 0.002 of the plain "
          "path's")
    check(abs(r_kernel - r_pb) <= BUILD_RECALL_TOL["ivf_pq"],
          f"ivf_pq: the kernel-built index's recall is not within "
          f"{BUILD_RECALL_TOL['ivf_pq']} of the plain-built index's")
    return index, eng, launches, Served(
        results, row, lambda: ServeEngine(index, k, params, max_batch=1024))


#: the mutable paths' churn, tests/test_mutable.py's script at full width:
#: upserts of live ids with fresh vectors, upserts of new ids, deletes of
#: live ids, re-upserts of deleted ids, in write batches of MUT_BATCH rows
MUT_UPSERT_LIVE = 5_000
MUT_UPSERT_NEW = 5_000
MUT_DELETE = 10_000
MUT_REUPSERT = 1_000
MUT_BATCH = 500
#: batches of MUT_BATCH upserts of new ids and MUT_BATCH deletes that a
#: writer thread applies while the engine serves
MUT_WRITER_BATCHES = 20
#: the churned index's recall@10 against the exact neighbours of its live
#: rows lies within this of the unchurned index's (PERF.md §2)
MUT_RECALL_TOL = {"ivf_flat": 0.01, "ivf_pq": 0.02}
#: share of upserted rows that, queried by their own vector, return their
#: id among the top 10 on IVF-PQ (IVF-Flat: all of them, at rank 1)
MUT_SELF_PQ = 0.99
#: where the mutable paths write their archives (inside the checkout's
#: ignored build/ directory; removed afterwards)
ARCHIVE_DIR = ROOT / "build" / "smoke_archives"


def _serve_all(eng, calls, dead=None):
    """One closed-loop pass of every call through *eng*: the seconds and
    the ids of every request.  With *dead* (a device flag per id and the
    lock its writer holds), no result may hold an id whose delete
    returned before its call began."""
    import torch

    t0 = time.perf_counter()
    ids = []
    for call in calls:
        if dead is not None:
            with dead[1]:
                gone = dead[0].clone()
        outs = eng.search(call)
        for out in outs:
            check(isinstance(out, tuple), f"a mutable request failed: "
                  f"{out!r}")
        got = np.concatenate([o[1] for o in outs])
        if dead is not None:
            t = torch.as_tensor(got, device=gone.device).long()
            check(not bool(gone[t.clamp_min(0)][t >= 0].any()),
                  "a result holds an id deleted before its call")
        ids.append(got)
    return time.perf_counter() - t0, np.concatenate(ids)


def _scan_steps(index, n_probes: int) -> int:
    """Steps of one query's probe scan over *index* (``expand_probes``'
    budget: its probes plus the index's continuation chunks)."""
    n_rows = index.list_indices.shape[0]
    probes = min(n_probes, index.n_lists)
    return max(1, min(probes * index.chunk_table.shape[1],
                      probes + max(0, n_rows - 1 - index.n_lists),
                      n_rows - 1))


def mutable_path(path, device, index, x, build_params, params, calls,
                 n_queries, qr, truth, k, fresh, smi, seed):
    """The mutable path of one family at full width: the main saved and
    loaded, a ``MutableIndex`` over it churned, served on the mutable
    backend while a writer thread writes, the triple saved and loaded,
    then compacted while traffic runs (a faulted promote first, then a
    ``Compactor`` tick); launch counts are reset before it and read
    after.  Returns them."""
    import importlib
    import shutil

    import torch

    from raft_tpu_torch.kernels import native
    from raft_tpu_torch.neighbors import ivf_flat, ivf_pq, mutable, serialize
    from raft_tpu_torch.serve import ServeEngine
    from raft_tpu_torch.testing import faults

    aot = importlib.import_module("raft_tpu_torch.core.aot")
    tag = f"{path}_mutable"
    flat = path == "ivf_flat"
    fam = ivf_flat if flat else ivf_pq
    save = serialize.save_ivf_flat if flat else serialize.save_ivf_pq
    load = serialize.load_ivf_flat if flat else serialize.load_ivf_pq
    n = x.shape[0]
    _reset(device)
    ARCHIVE_DIR.mkdir(parents=True, exist_ok=True)
    try:
        # the main index: saved, loaded, the same bits
        arch = {"phase": "mutable_archive", "path": path, "card": smi}
        t0 = time.perf_counter()
        save(ARCHIVE_DIR / path, index)
        arch["save_main_s"] = time.perf_counter() - t0
        arch["main_bytes"] = (ARCHIVE_DIR / f"{path}.npz").stat().st_size
        t0 = time.perf_counter()
        loaded = load(ARCHIVE_DIR / path, device=device)
        arch["load_main_s"] = _synced_seconds(device, t0)
        d0, i0 = fam.search(params, index, qr, k)
        d1, i1 = fam.search(params, loaded, qr, k)
        check(torch.equal(d0, d1) and torch.equal(i0, i1),
              f"{path}: the loaded main searches other bits")
        del loaded, d1, i1
        r_unchurned = recall(i0.long(), truth)

        # the churn
        mut = mutable.MutableIndex(index, x, build_params=build_params)
        rng = np.random.default_rng(seed)
        # ids: the main's, then the churn's new ones, the writer thread's,
        # and the last writes before the compaction
        top = n + MUT_UPSERT_NEW + (MUT_WRITER_BATCHES + 2) * MUT_BATCH
        alive = np.zeros(top, bool)
        alive[:n] = True
        dead = (torch.zeros(top, dtype=torch.bool, device=device),
                threading.Lock())
        vecs = {}
        tally = {"upsert_s": 0.0, "upsert_rows": 0, "delete_s": 0.0,
                 "delete_rows": 0, "writes": 0}

        def upsert(ids):
            v = fresh(ids.size)
            t0 = time.perf_counter()
            mut.upsert(v, ids)
            tally["upsert_s"] += _synced_seconds(device, t0)
            tally["upsert_rows"] += ids.size
            tally["writes"] += 1
            alive[ids] = True
            with dead[1]:
                dead[0][torch.as_tensor(ids, device=device)] = False
            for r, j in enumerate(ids.tolist()):
                vecs[j] = v[r]

        def delete(ids):
            t0 = time.perf_counter()
            got = mut.delete(ids)
            tally["delete_s"] += _synced_seconds(device, t0)
            tally["delete_rows"] += got
            tally["writes"] += 1
            check(got == ids.size, f"{tag}: a delete missed live ids")
            alive[ids] = False
            with dead[1]:
                dead[0][torch.as_tensor(ids, device=device)] = True
            for j in ids.tolist():
                vecs.pop(j, None)

        def batches(ids):
            return [ids[b:b + MUT_BATCH] for b in range(0, ids.size,
                                                        MUT_BATCH)]

        rewarms0 = mutable.mutable_counters["rewarms"]
        for ids in batches(rng.choice(n, MUT_UPSERT_LIVE, replace=False)):
            upsert(ids)
        for ids in batches(np.arange(n, n + MUT_UPSERT_NEW)):
            upsert(ids)
        gone = rng.choice(np.nonzero(alive)[0], MUT_DELETE, replace=False)
        for ids in batches(gone):
            delete(ids)
        for ids in batches(rng.choice(gone, MUT_REUPSERT, replace=False)):
            upsert(ids)
        check(mut.size == int(alive.sum()), f"{tag}: size after the churn")
        rewarms = mutable.mutable_counters["rewarms"] - rewarms0
        emit({"phase": "mutable_churn", "path": path, "card": smi,
              "size": mut.size, "delta_rows": mut.delta_rows,
              "tombstones": mut.tombstone_count,
              "upsert_rows_per_s": tally["upsert_rows"] / tally["upsert_s"],
              "delete_rows_per_s": tally["delete_rows"] / tally["delete_s"],
              "rewarms": rewarms,
              "rewarms_per_write": rewarms / tally["writes"],
              "delta_block_rows": int(mut._mut_core.delta.list_indices.shape[0]),
              "write_batch_rows": MUT_BATCH, **tally})

        # the plain backend on the same main and traffic, then the mutable
        # backend while a writer thread writes, then a final pass
        plain = ServeEngine(index, k, params, max_batch=1024)
        plain.warmup()
        plain_s, _ = _serve_all(plain, calls)
        plain.close()
        eng = ServeEngine(mut, k, params, max_batch=1024)
        eng.warmup()
        # reads run on this thread, the writer's rewarms on its own
        read0, all0 = aot.thread_compiles(), compiles()
        rewarms0 = mutable.mutable_counters["rewarms"]
        tally0 = dict(tally)
        errors = []

        def writer():
            try:
                w = np.random.default_rng(seed + 1)
                base = n + MUT_UPSERT_NEW
                for b in range(MUT_WRITER_BATCHES):
                    upsert(np.arange(base + b * MUT_BATCH,
                                     base + (b + 1) * MUT_BATCH))
                    delete(w.choice(np.nonzero(alive)[0], MUT_BATCH,
                                    replace=False))
            except Exception as e:   # noqa: BLE001 — checked below
                errors.append(repr(e))

        wt = threading.Thread(target=writer)
        wt.start()
        passes, during_s = 0, None
        while wt.is_alive() or passes == 0:
            s, _ = _serve_all(eng, calls, dead)
            during_s = s if during_s is None else during_s
            passes += 1
        wt.join()
        check(not errors, f"{tag}: the writer failed: {errors}")
        final_s, ids = _serve_all(eng, calls, dead)
        read_compiles = aot.thread_compiles() - read0
        serve_writes = {
            "writes_during_serving": tally["writes"] - tally0["writes"],
            "write_path_compiles": compiles() - all0 - read_compiles,
            "rewarms_during_serving": (mutable.mutable_counters["rewarms"]
                                       - rewarms0),
            "upsert_rows_per_s_during_serving": (
                (tally["upsert_rows"] - tally0["upsert_rows"])
                / (tally["upsert_s"] - tally0["upsert_s"]))}
        live_t = torch.as_tensor(alive, device=device)
        it = torch.as_tensor(ids, device=device).long()
        check(bool((it >= 0).all()) and bool(live_t[it].all()),
              f"{tag}: a returned id is not live")
        sample = rng.choice(np.array(sorted(vecs)), min(1000, len(vecs)),
                            replace=False)
        qv = torch.stack([vecs[int(j)] for j in sample])
        _, si = mutable.search(mut, qv, k, params=params)
        si = si.cpu().numpy()
        self_rank1 = float(np.mean(si[:, 0] == sample))
        self_top10 = float(np.mean((si == sample[:, None]).any(1)))
        check(self_rank1 == 1.0 if flat else self_top10 >= MUT_SELF_PQ,
              f"{tag}: upserted rows do not find themselves (rank 1 "
              f"{self_rank1}, top 10 {self_top10})")
        live_x, live_ids = mut.live_rows()
        dist = torch.cdist(qr, live_x,
                           compute_mode="donot_use_mm_for_euclid_dist")
        exact = torch.as_tensor(live_ids, device=device)[
            torch.topk(dist, k, dim=1, largest=False).indices]
        del dist, live_x
        _, mi = mutable.search(mut, qr, k, params=params)
        r_mut = recall(mi.long(), exact)
        core = mut._mut_core
        emit({"phase": "mutable_serve", "path": path, "card": smi,
              "main_scan_steps": _scan_steps(core.main, params.n_probes),
              "delta_scan_steps": _scan_steps(core.delta, params.n_probes),
              "delta_capacity": core.delta.capacity,
              "queries": n_queries, "plain_qps": n_queries / plain_s,
              "mutable_qps_during_writes": n_queries / during_s,
              "mutable_qps": n_queries / final_s,
              "passes_during_writes": passes,
              "writer_batches": MUT_WRITER_BATCHES,
              "delta_rows": mut.delta_rows,
              "tombstones": mut.tombstone_count,
              "recall_at_10": r_mut, "recall_at_10_unchurned": r_unchurned,
              "self_rank1": self_rank1, "self_top10": self_top10,
              "self_queries": int(sample.size), **serve_writes,
              "compiles_after_warmup": read_compiles,
              "stats": dict(eng.stats)})
        check(read_compiles == 0, f"{tag}: {read_compiles} first calls in "
              "the reads across the writes")
        check(abs(r_mut - r_unchurned) <= MUT_RECALL_TOL[path],
              f"{tag}: recall {r_mut} not within {MUT_RECALL_TOL[path]} "
              f"of the unchurned index's {r_unchurned}")

        # the triple: saved after the churn, loaded, the same bits
        t0 = time.perf_counter()
        serialize.save_mutable(ARCHIVE_DIR / tag, mut)
        arch["save_mutable_s"] = time.perf_counter() - t0
        arch["mutable_bytes"] = (ARCHIVE_DIR / f"{tag}.npz").stat().st_size
        t0 = time.perf_counter()
        back = serialize.load_mutable(ARCHIVE_DIR / tag, device=device)
        arch["load_mutable_s"] = _synced_seconds(device, t0)
        da, ia = mutable.search(mut, qr, k, params=params)
        db, ib = mutable.search(back, qr, k, params=params)
        check(torch.equal(da, db) and torch.equal(ia, ib),
              f"{tag}: the loaded triple searches other bits")
        check(back.size == mut.size, f"{tag}: the loaded triple's size")
        del back
        emit(arch)

        # compaction under closed-loop traffic: a faulted promote (the
        # core is swapped, the engine keeps its backend), then fresh
        # writes and a Compactor tick that promotes
        stop = threading.Event()
        served = [0, 0]

        def reader():
            c0 = aot.thread_compiles()
            try:
                while not stop.is_set():
                    _serve_all(eng, calls[:2])
                    served[0] += 1
            except Exception as e:   # noqa: BLE001 — checked below
                errors.append(repr(e))
            served[1] = aot.thread_compiles() - c0

        rt = threading.Thread(target=reader)
        rt.start()
        errors0 = mutable.mutable_counters["compaction_errors"]
        t0 = time.perf_counter()
        try:
            with faults.plan("refresh:stage=pre_swap:raise"):
                mut.compact(engine=eng)
            check(False, f"{tag}: the injected refresh fault did not fire")
        except faults.InjectedFault:
            pass
        faulted_s = time.perf_counter() - t0
        check(mut.delta_rows == 0 and mut.tombstone_count == 0,
              f"{tag}: the faulted compaction did not swap the core")
        for ids in batches(np.arange(top - 2 * MUT_BATCH, top)):
            upsert(ids)
        for ids in batches(rng.choice(np.nonzero(alive[:n])[0],
                                      2 * MUT_BATCH, replace=False)):
            delete(ids)
        ident = None
        if flat:
            full = ivf_flat.SearchParams(n_probes=index.n_lists)
            d_before, _ = mutable.search(mut, qr[:16], k, params=full)
        size_before = mut.size
        comp = mutable.Compactor(mut, eng, delta_fraction=1e-4,
                                 tomb_fraction=1e-4, seed=seed)
        t0 = time.perf_counter()
        promoted = comp.tick()
        compact_s = time.perf_counter() - t0
        stop.set()
        rt.join()
        check(not errors, f"{tag}: requests failed during compaction: "
              f"{errors[:3]}")
        check(promoted and comp.errors == 0
              and mutable.mutable_counters["compaction_errors"] == errors0,
              f"{tag}: the compaction failed or counted an error")
        check(mut.delta_rows == 0 and mut.tombstone_count == 0
              and mut.size == size_before,
              f"{tag}: after compaction delta {mut.delta_rows}, "
              f"tombstones {mut.tombstone_count}, size {mut.size}")
        check(eng.stats["refreshes"] == 1 and eng.stats["dispatch_errors"]
              == 0, f"{tag}: refreshes {eng.stats['refreshes']}, dispatch "
              f"errors {eng.stats['dispatch_errors']}")
        row = {"phase": "mutable_compact", "path": path, "card": smi,
               "faulted_compact_s": faulted_s, "compact_s": compact_s,
               "compaction_errors": comp.errors, "size": mut.size,
               "reader_passes": served[0], "compiles_after_warmup": served[1],
               "stats": dict(eng.stats)}
        check(served[1] == 0, f"{tag}: {served[1]} first calls in the reads "
              "across the compactions")
        if flat:
            d_after, _ = mutable.search(mut, qr[:16], k, params=full)
            ident = torch.equal(d_before, d_after)
            row["full_coverage_max_abs_diff"] = float(
                (d_before - d_after).abs().max())
            row["full_coverage_bitwise"] = ident
        emit(row)
        if flat:
            check(ident, f"{tag}: at full probe coverage the merged "
                  "distances differ from the compacted index's")
        eng.close()
        launches = dict(native.LAUNCHES)
    finally:
        shutil.rmtree(ARCHIVE_DIR, ignore_errors=True)
    for name in PATH_KERNELS[tag]:
        check(launches[name] > 0, f"{tag} never launched {name}")
    return launches


def lut_phase(device, index, queries, rep: int):
    """B4 against its plain version at the IVF-PQ main path's step shape
    for all four LUT types, and at ragged shapes; returns B4's row."""
    import torch

    from raft_tpu_torch.kernels import ivf_pq_lut as kl
    from raft_tpu_torch.neighbors import ivf_pq
    from raft_tpu_torch.neighbors.ivf_flat import _coarse_distances

    gen = torch.Generator(device=device).manual_seed(13)

    def compare(codes, rows, lut, pq_dim, bits, what):
        kcb = 1 << bits
        got = kl.lut_score_rows(codes, rows, lut, pq_dim, bits, kcb)
        gathered = codes[rows.long()]
        ref = kl._lut_score_plain(gathered, lut, pq_dim, bits, kcb)
        mag = kl._lut_score_plain(gathered, lut.float().abs(), pq_dim, bits,
                                  kcb)
        check(bool(((got - ref).abs() <= 1e-5 * mag).all()),
              f"lut_score {what}: beyond 1e-5 × Σ|lut term| of the plain "
              "version")
        return float((got - ref).abs().max())

    # the main path's step shape: each query's nearest list's first chunk
    nq = min(1024, queries.shape[0])
    pq_dim, bits = index.pq_dim, index.pq_bits
    kcb = 1 << bits
    cap, code_bytes = index.capacity, index.list_codes.shape[2]
    probe = torch.argmin(_coarse_distances(queries[:nq], index.centers,
                                           index.metric), dim=1)
    rows = index.chunk_table[probe, 0].contiguous()
    codes = index.list_codes
    # queries that share a row share its code bytes: the kernel reads rows
    # in place, so the bound counts each distinct row once
    distinct = int(rows.unique().numel())
    by_dtype, errs = {}, []
    for name, dt in ivf_pq._LUT_DTYPES.items():
        lut = (torch.rand(nq, pq_dim * kcb, generator=gen, device=device)
               * 440.0).to(dt)
        errs.append(compare(codes, rows, lut, pq_dim, bits, name))
        itemsize = lut.element_size()
        b, by = bound_ms(distinct * cap * code_bytes
                         + nq * pq_dim * kcb * itemsize
                         + 4.0 * nq * cap + 4.0 * nq, float(nq * cap * pq_dim))
        by_dtype[name] = dict(
            max_abs_err=errs[-1], bound_ms=b, bound_by=by,
            ms=timed(lambda: kl.lut_score_rows(codes, rows, lut, pq_dim,
                                               bits, kcb), device, rep),
            plain_ms=timed(lambda: kl._lut_score_plain(
                codes[rows.long()], lut, pq_dim, bits, kcb), device, 3))
    # the library yardstick, float32: one embedding_bag over the flattened
    # LUT, bag (q, c) holding the pq_dim entries q·F + m·kcb + code
    lut32 = (torch.rand(nq, pq_dim * kcb, generator=gen, device=device)
             * 440.0)
    unpacked = kl.unpack_codes(codes[rows.long()], pq_dim, bits).long()
    ids = (unpacked + (torch.arange(pq_dim, device=device) * kcb)
           + (torch.arange(nq, device=device) * pq_dim * kcb)[:, None, None])
    ids = ids.reshape(nq * cap, pq_dim)
    weight = lut32.reshape(-1, 1)
    bag = torch.nn.functional.embedding_bag(ids, weight, mode="sum")
    ref = kl.lut_score_rows(codes, rows, lut32, pq_dim, bits, kcb)
    check(torch.allclose(bag.reshape(nq, cap), ref, rtol=1e-5, atol=1e-3),
          "embedding_bag yardstick disagrees with B4")
    lib_ms = timed(lambda: torch.nn.functional.embedding_bag(
        ids, weight, mode="sum"), device, rep)
    del ids, unpacked

    # ragged shapes: nq 1 and 37, capacities off the 256-slot block,
    # pq_bits 4/5/7 with odd code bytes, and LUT rows beyond one block's
    # shared memory (read from global memory)
    ragged = []
    for rnq, rcap, rdim, rbits in ((1, 1000, 64, 8), (37, 257, 64, 8),
                                   (37, 1001, 13, 4), (5, 999, 10, 5),
                                   (37, 333, 17, 7), (3, 300, 480, 8),
                                   (4, 130, 2000, 5)):
        rk = 1 << rbits
        rcodes = torch.randint(0, rk, (7 * rcap, rdim), generator=gen,
                               device=device)
        block = ivf_pq._pack_codes(rcodes, rbits).reshape(7, rcap, -1)
        rrows = torch.randint(0, 7, (rnq,), generator=gen, device=device,
                              dtype=torch.int32)
        for name, dt in ivf_pq._LUT_DTYPES.items():
            lut = (torch.rand(rnq, rdim * rk, generator=gen, device=device)
                   * 440.0).to(dt)
            errs.append(compare(block, rrows, lut, rdim, rbits,
                                f"ragged {rnq}×{rcap}×{rdim}@{rbits} {name}"))
        ragged.append([rnq, rcap, rdim, rbits, int(block.shape[2])])
    row = dict(max_abs_err=max(errs), ms=by_dtype["float32"]["ms"],
               plain_ms=by_dtype["float32"]["plain_ms"],
               bound_ms=by_dtype["float32"]["bound_ms"],
               bound_by=by_dtype["float32"]["bound_by"], library_ms=lib_ms,
               by_lut_dtype=by_dtype)
    emit({"phase": "kernel", "name": "lut_score",
          "shape": [nq, cap, code_bytes, pq_dim, bits],
          "distinct_rows": distinct,
          "ragged_shapes_nq_cap_pqdim_bits_codebytes": ragged,
          "library": "embedding_bag", **row})
    return row


def lut_scan_phase(device, index, queries, n_probes: int, k: int,
                   rep: int, seed: int):
    """B4's scan mode at the IVF-PQ batch shape, with the index's own
    float32 LUT (the main path's) and fp8 per-probe LUTs: one launch per
    batch, bit for bit equal to the per-step path, also at 1 and 8
    queries (where each step is split over several blocks); then its
    tombstone variant the same way, with a seeded bitmap that kills 10%
    of the ids.  Returns the scan's row and the variant's."""
    import torch

    from raft_tpu_torch.distance.pairwise import _dot_fixed_rows
    from raft_tpu_torch.kernels import ivf_pq_lut as kl
    from raft_tpu_torch.kernels import native
    from raft_tpu_torch.matrix.select_k import select_k
    from raft_tpu_torch.neighbors import ivf_pq
    from raft_tpu_torch.neighbors.ivf_flat import _coarse_distances

    pq_dim, bits = index.pq_dim, index.pq_bits
    kcb, cap = 1 << bits, index.capacity
    code_bytes = index.list_codes.shape[2]
    kk = min(k, cap)
    select_min = index.metric != ivf_pq.DistanceType.InnerProduct
    engines = ivf_pq._resolve_engines(index, None)

    def batch(q, lut_name):
        coarse = _coarse_distances(q, index.centers, index.metric)
        _, probes = select_k(coarse, n_probes, select_min=True)
        rot_q = _dot_fixed_rows(q, index.rotation.T)
        inp = ivf_pq.scan_inputs(q, probes, rot_q, index, lut_name)
        args = (index.list_codes, inp.phys, index.phys_sizes, inp.tables,
                inp.ords, inp.base, inp.csum, inp.scale, pq_dim, bits, kcb,
                kk, select_min)

        def fused():
            vals, slots = kl.lut_scan_topk(*args)
            return ivf_pq._select_scanned(vals, slots, inp.phys,
                                          index.list_indices, k, select_min,
                                          engines[0])

        def per_step():
            return ivf_pq._scan_per_step(inp, index, k, select_min,
                                         *engines)

        return inp, args, fused, per_step

    # a seeded bitmap over the index's ids that kills 10% of them
    n_ids = int(index.list_indices.max()) + 1
    n_words = -(-n_ids // 32)
    dead_np = np.random.default_rng(seed).random(n_words * 32) < 0.1
    dead_ids = torch.as_tensor(dead_np, device=device)
    words = torch.as_tensor(np.packbits(dead_np, bitorder="little").view(
        np.int32), device=device)
    out, masked = {}, {}
    for lut_name in ("float32", "float8_e4m3"):
        nq = min(1024, queries.shape[0],
                 ivf_pq.hoisted_batch_cap(index, n_probes, lut_name)
                 or 1024)
        q = queries[:nq]
        inp, args, fused, per_step = batch(q, lut_name)
        _reset(device)
        got = fused()
        check(native.LAUNCHES["lut_scan"] == 1
              and native.LAUNCHES["lut_score"] == 0,
              f"lut_scan {lut_name}: not one scan-mode launch per batch")
        native.reset_launches()
        ivf_pq._full_search_impl(q, index, k, n_probes, lut_name, engines)
        check(native.LAUNCHES["lut_scan"] == 1
              and native.LAUNCHES["lut_score"] == 0,
              f"ivf_pq search {lut_name}: not one scan-mode launch")
        native.reset_launches()
        ref = per_step()
        raw_launches = native.LAUNCHES["lut_score"]
        check(torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]),
              f"lut_scan {lut_name}: (distances, ids) differ from the "
              "per-step path")
        n_steps = inp.phys.shape[1]
        live = index.phys_sizes[inp.phys.long()].long()
        live_share = float(live.sum()) / (nq * n_steps * cap)
        # the least traffic: each distinct row's live codes (and list-side
        # sums) once, each query's LUT once, the per-(query, step) rows,
        # bases and LUT slices, and the (nq, S, kk) values and slots; the
        # operations: one float32 add per live (query, slot) and subspace
        rows_u = inp.phys.unique().long()
        live_codes = float(index.phys_sizes[rows_u].long().sum())
        lut_bytes = inp.tables.numel() * inp.tables.element_size()
        per_step_in = 4.0 * (2 + (inp.ords is not None))
        b, by = bound_ms(live_codes * code_bytes + lut_bytes
                         + (4.0 * live_codes if inp.csum is not None else 0)
                         + 4.0 * rows_u.numel() + per_step_in * nq * n_steps
                         + 8.0 * nq * n_steps * kk,
                         float(live.sum()) * pq_dim)
        vals, _ = kl.lut_scan_topk(*args)
        pv, _ = kl.lut_scan_topk_plain(*args)
        fin = torch.isfinite(pv)
        check(torch.equal(fin, torch.isfinite(vals)),
              f"lut_scan {lut_name}: finite entries differ from the plain "
              "twin")
        # the twin sums the same float32 terms in another order: within
        # 1e-5 of the value plus the magnitude of its terms
        terms = (pq_dim * float(inp.tables.float().abs().max())
                 / (float(inp.scale.min()) if inp.scale is not None else 1.0)
                 + float(inp.base.abs().max())
                 + (float(inp.csum.abs().max()) if inp.csum is not None
                    else 0.0))
        diff = (vals - pv)[fin].abs()
        check(bool((diff <= 1e-5 * (pv[fin].abs() + terms)).all()),
              f"lut_scan {lut_name}: beyond 1e-5 of its plain twin")
        err = float(diff.max()) if diff.numel() else 0.0
        # small batches: a solo query and a bucket of 8 split each step
        # over several blocks; the same bits as the per-step path
        small = {}
        for snq in (1, 8):
            _, sargs, sfused, sper_step = batch(queries[:snq], lut_name)
            sgot, sref = sfused(), sper_step()
            check(torch.equal(sgot[0], sref[0])
                  and torch.equal(sgot[1], sref[1]),
                  f"lut_scan {lut_name} at {snq} queries: (distances, ids) "
                  "differ from the per-step path")
            small[str(snq)] = dict(
                ms=timed(lambda: kl.lut_scan_topk(*sargs), device, rep),
                fused_path_ms=timed(sfused, device, rep),
                per_step_path_ms=timed(sper_step, device, rep))
        # the tombstone variant: the same batch with a seeded bitmap that
        # kills 10% of the ids, bit for bit against the per-step path
        # with the same bitmap, at the batch, a solo query and 8 queries
        # (the two split each step over several blocks)
        targs = args + (index.list_indices, words)

        def fused_t(a=targs, i=inp):
            vals, slots = kl.lut_scan_topk(*a)
            return ivf_pq._select_scanned(vals, slots, i.phys,
                                          index.list_indices, k, select_min,
                                          engines[0])

        def per_step_t(i=inp):
            return ivf_pq._scan_per_step(i, index, k, select_min, *engines,
                                         words)

        _reset(device)
        got_t = fused_t()
        check(native.LAUNCHES["lut_scan_tombstones"] == 1
              and native.LAUNCHES["lut_scan"] == 0,
              f"lut_scan tombstones {lut_name}: not one masked launch")
        ref_t = per_step_t()
        check(torch.equal(got_t[0], ref_t[0])
              and torch.equal(got_t[1], ref_t[1]),
              f"lut_scan tombstones {lut_name}: (distances, ids) differ "
              "from the per-step path")
        check(not bool(dead_ids[torch.clamp_min(got_t[1], 0).long()]
                       [got_t[1] >= 0].any()),
              f"lut_scan tombstones {lut_name}: a dead id came back")
        for snq in (1, 8):
            sinp, sargs, _, _ = batch(queries[:snq], lut_name)
            sa = sargs + (index.list_indices, words)
            sg = fused_t(sa, sinp)
            sr = per_step_t(sinp)
            check(torch.equal(sg[0], sr[0]) and torch.equal(sg[1], sr[1]),
                  f"lut_scan tombstones {lut_name} at {snq} queries: "
                  "(distances, ids) differ from the per-step path")
        tv, ts = kl.lut_scan_topk(*targs)
        pv_t, ps_t = kl.lut_scan_topk_plain(*targs)
        fin_t = torch.isfinite(pv_t)
        check(torch.equal(fin_t, torch.isfinite(tv))
              and torch.equal(ps_t[~fin_t], ts[~fin_t]),
              f"lut_scan tombstones {lut_name}: fill entries differ from "
              "the plain twin")
        diff_t = (tv - pv_t)[fin_t].abs()
        check(bool((diff_t <= 1e-5 * (pv_t[fin_t].abs() + terms)).all()),
              f"lut_scan tombstones {lut_name}: beyond 1e-5 of its plain "
              "twin")
        # the bound adds each live candidate's id (4 B) and the bitmap
        bt, byt = bound_ms(live_codes * code_bytes + lut_bytes
                           + (4.0 * live_codes if inp.csum is not None
                              else 0) + 4.0 * live_codes
                           + 4.0 * words.numel()
                           + 4.0 * rows_u.numel()
                           + per_step_in * nq * n_steps
                           + 8.0 * nq * n_steps * kk,
                           float(live.sum()) * pq_dim)
        masked[lut_name] = dict(
            dead_share=float(dead_ids.float().mean()),
            max_abs_err=float(diff_t.max()) if diff_t.numel() else 0.0,
            bound_ms=bt, bound_by=byt,
            ms=timed(lambda: kl.lut_scan_topk(*targs), device, rep),
            unmasked_ms=timed(lambda: kl.lut_scan_topk(*args), device, rep),
            fused_path_ms=timed(fused_t, device, rep),
            per_step_path_ms=timed(per_step_t, device, rep),
            plain_ms=timed(lambda: kl.lut_scan_topk_plain(*targs), device,
                           3))
        emit({"phase": "kernel", "name": "lut_scan_tombstones",
              "lut_dtype": lut_name, "equals_per_step_path_bitwise": True,
              **masked[lut_name]})
        out[lut_name] = dict(
            shape=[nq, n_steps, cap, pq_dim, bits], kk=kk,
            live_share_of_scored_pairs=live_share, max_abs_err=err,
            launches_per_batch=1, per_step_raw_launches=raw_launches,
            distinct_rows=int(rows_u.numel()), bound_ms=b, bound_by=by,
            ms=timed(lambda: kl.lut_scan_topk(*args), device, rep),
            fused_path_ms=timed(fused, device, rep),
            per_step_path_ms=timed(per_step, device, rep),
            plain_ms=timed(lambda: kl.lut_scan_topk_plain(*args), device,
                           3),
            by_queries=small)
    f32 = out["float32"]
    row = dict(max_abs_err=max(o["max_abs_err"] for o in out.values()),
               ms=f32["ms"], plain_ms=f32["plain_ms"],
               bound_ms=f32["bound_ms"], bound_by=f32["bound_by"],
               library_ms=None, by_lut_dtype=out)
    emit({"phase": "kernel", "name": "lut_scan",
          "equals_per_step_path_bitwise": True, **row})
    m32 = masked["float32"]
    trow = dict(max_abs_err=max(o["max_abs_err"] for o in masked.values()),
                ms=m32["ms"], plain_ms=m32["plain_ms"],
                bound_ms=m32["bound_ms"], bound_by=m32["bound_by"],
                library_ms=None, by_lut_dtype=masked)
    return row, trow


def ivf_pq_per_cluster_path(device, x, reqs, calls, n_queries, truth, qr,
                            n_lists, n_probes, k):
    """The IVF-PQ main configuration with PER_CLUSTER codebooks: launch
    counts reset, build, engine, every query served; B1, B2, B3 and B4's
    scan mode must launch.  Checks: coalesced equals solo, kernel-path
    recall within 0.002 of the plain path's on the same index and within
    ``BUILD_RECALL_TOL`` of a plain-built PER_CLUSTER index's.  Returns
    (index, launches)."""
    from raft_tpu_torch.kernels import native
    from raft_tpu_torch.neighbors import ivf_pq
    from raft_tpu_torch.serve import ServeEngine

    path = "ivf_pq_per_cluster"
    bp = ivf_pq.IndexParams(n_lists=n_lists,
                            codebook_kind=ivf_pq.CodebookKind.PER_CLUSTER)
    _reset(device)
    t0 = time.perf_counter()
    index = ivf_pq.build(bp, x, device=device)
    build_s = _synced_seconds(device, t0)
    check(index.size == x.shape[0] and index.per_cluster,
          f"{path} build: wrong index")
    b3_build = native.LAUNCHES["fused_l2_nn_partials"]
    check(0 < b3_build <= MAX_PQ_BUILD_B3,
          f"{path} build launched B3 {b3_build} times (at most "
          f"{MAX_PQ_BUILD_B3})")
    params = ivf_pq.SearchParams(n_probes=n_probes)
    cap = ivf_pq.hoisted_batch_cap(index, n_probes, "float32")
    emit_build(path, index, build_s,
               {"b3_launches": b3_build,
                "codebooks_shape": list(index.codebooks.shape),
                "pq_dim": index.pq_dim, "batch_cap": cap,
                "physical_rows": int(index.list_codes.shape[0])})
    eng = ServeEngine(index, k, params, max_batch=1024)
    check(eng.max_batch == cap, f"{path}: max_batch {eng.max_batch} is not "
          f"the batch cap {cap}")
    results, launches, row = serve_path(path, device, eng, k, reqs, calls,
                                        n_queries)
    check(launches["lut_score"] == 0, f"{path}: the scan launched B4's "
          "per-step raw mode")
    check_coalesced(path, lambda q: ivf_pq.search(params, index, q, k),
                    reqs, results)
    nr = qr.shape[0]
    r_kernel = recall(_first_ids(results, nr, device), truth)
    _, ids_plain = ivf_pq.search(params, index, qr, k, engine="torch")
    r_plain = recall(ids_plain.long(), truth)
    r_pb, pb_s = plain_build_recall(ivf_pq, bp, params, x, qr, k, truth,
                                    device)
    emit({"phase": "checks", "path": path, "coalesced_equals_solo": True,
          "recall_at_10": r_kernel, "recall_at_10_plain_path": r_plain,
          "recall_at_10_plain_build": r_pb, "plain_build_s": pb_s,
          "batch_cap": cap, "qps": row["qps"], "build_s": build_s,
          "recall_queries": nr})
    check(abs(r_kernel - r_plain) <= 0.002,
          f"{path}: kernel-path recall is not within 0.002 of the plain "
          "path's")
    check(abs(r_kernel - r_pb) <= BUILD_RECALL_TOL["ivf_pq"],
          f"{path}: the kernel-built index's recall is not within "
          f"{BUILD_RECALL_TOL['ivf_pq']} of the plain-built index's")
    eng.close()
    return index, launches


def _recall_of(search_fn, qr, truth, **kw):
    _, ids = search_fn(qr, **kw)
    return recall(ids.long(), truth), ids


def ivf_pq_variants_phase(device, index, qr, truth, n_probes, k, rep):
    """On the main PER_SUBSPACE IVF-PQ index: the float16 sum
    (``internal_distance_dtype="float16"``) and the legacy search
    (``hoisted_lut=False``, float32 and fp8 LUTs), each through the
    kernels and through their plain versions.  The legacy searches run
    with launch counts reset just before and read just after: B4's raw
    mode must launch there, its scan mode never.  Then B4's raw mode at
    the legacy step shape with each float16 sum, against its plain twin.
    Returns (the legacy path's launches, the raw rows)."""
    import torch

    from raft_tpu_torch.kernels import ivf_pq_lut as kl
    from raft_tpu_torch.kernels import native
    from raft_tpu_torch.neighbors import ivf_pq

    out = {"phase": "ivf_pq_variants", "queries": qr.shape[0]}
    f32 = ivf_pq.SearchParams(n_probes=n_probes)
    p16 = ivf_pq.SearchParams(n_probes=n_probes,
                              internal_distance_dtype="float16")
    r32, _ = _recall_of(lambda q: ivf_pq.search(f32, index, q, k), qr, truth)
    d16, i16 = ivf_pq.search(p16, index, qr, k)
    d16p, i16p = ivf_pq.search(p16, index, qr, k, engine="torch")
    r16, r16p = recall(i16.long(), truth), recall(i16p.long(), truth)
    gap16 = float((d16 - d16p).abs().max())
    out.update(recall_at_10_float32=r32, recall_at_10_float16=r16,
               recall_at_10_float16_plain_path=r16p,
               float16_max_abs_diff_plain=gap16)
    check(abs(r16 - r16p) <= 0.002, "ivf_pq float16: kernel-path recall is "
          "not within 0.002 of the plain path's")
    # the kernel rounds one float32 sum of the same terms in another order
    check(gap16 <= 2.0 ** -9 * float(d16p.abs().max()),
          "ivf_pq float16: distances beyond a float16 step of the plain "
          "path's")
    _reset(device)
    legacy = {}
    for lut in ("float32", "float8_e4m3"):
        sp = ivf_pq.SearchParams(n_probes=n_probes, lut_dtype=lut,
                                 hoisted_lut=False)
        t0 = time.perf_counter()
        _, ids = ivf_pq.search(sp, index, qr, k)
        legacy[lut] = (recall(ids.long(), truth),
                       _synced_seconds(device, t0))
    launches = dict(native.LAUNCHES)
    check(launches["lut_score"] > 0 and launches["lut_scan"] == 0,
          "ivf_pq legacy: B4's raw mode did not carry the scan")
    for name in PATH_KERNELS["ivf_pq_legacy"]:
        check(launches[name] > 0, f"ivf_pq_legacy never launched {name}")
    p8 = ivf_pq.SearchParams(n_probes=n_probes, lut_dtype="float8_e4m3")
    r8, _ = _recall_of(lambda q: ivf_pq.search(p8, index, q, k), qr, truth)
    for lut, (r_leg, secs) in legacy.items():
        sp = ivf_pq.SearchParams(n_probes=n_probes, lut_dtype=lut,
                                 hoisted_lut=False)
        r_plain, _ = _recall_of(lambda q: ivf_pq.search(
            sp, index, q, k, engine="torch"), qr, truth)
        out[f"legacy_{lut}"] = dict(recall_at_10=r_leg, seconds=secs,
                                    qps=qr.shape[0] / secs,
                                    recall_at_10_plain_path=r_plain)
        check(abs(r_leg - r_plain) <= 0.002, f"ivf_pq legacy {lut}: "
              "kernel-path recall is not within 0.002 of the plain path's")
    out["legacy_launches"] = launches
    out["recall_at_10_fp8_hoisted"] = r8
    # the legacy float16 sum reaches the result: on the main (L2Expanded)
    # index a distance is the float16 sum itself
    check(index.metric == ivf_pq.DistanceType.L2Expanded,
          "ivf_pq_variants: the main index is not L2Expanded")
    dl16, _ = ivf_pq.search(ivf_pq.SearchParams(
        n_probes=n_probes, hoisted_lut=False,
        internal_distance_dtype="float16"), index, qr, k)
    check(torch.equal(dl16, dl16.half().float()), "ivf_pq legacy float16: "
          "a distance is not a float16 value")
    out["legacy_float16_distances_are_float16"] = True
    # the same distance in float32: the two searches rank alike
    check(abs(legacy["float32"][0] - r32) <= 0.002,
          "ivf_pq legacy float32: recall not within 0.002 of the hoisted "
          "search's")
    emit(out)

    # B4's raw mode at the legacy step: each query's nearest list's first
    # chunk, a float32 LUT, the two float16 sums
    from raft_tpu_torch.neighbors.ivf_flat import _coarse_distances

    gen = torch.Generator(device=device).manual_seed(17)
    nq = qr.shape[0]
    pq_dim, bits = index.pq_dim, index.pq_bits
    kcb, cap = 1 << bits, index.capacity
    code_bytes = index.list_codes.shape[2]
    probe = torch.argmin(_coarse_distances(qr, index.centers, index.metric),
                         dim=1)
    rows = index.chunk_table[probe, 0].contiguous()
    lut = (torch.rand(nq, pq_dim * kcb, generator=gen, device=device) - 0.3
           ) * 100.0
    gathered = index.list_codes[rows.long()]
    distinct = int(rows.unique().numel())
    raw = {}
    for acc, name in ((kl.SUM_HALF_SEQUENTIAL, "half_sequential"),
                      (kl.SUM_HALF_ONCE, "half_once")):
        got = kl.lut_score_rows(index.list_codes, rows, lut, pq_dim, bits,
                                kcb, acc)
        ref = kl._lut_score_plain(gathered, lut, pq_dim, bits, kcb, acc)
        mag = kl._lut_score_plain(gathered, lut.abs(), pq_dim, bits, kcb)
        check(torch.equal(got, got.half().float()),
              f"lut_score {name}: a sum is not a float16 value")
        if acc == kl.SUM_HALF_SEQUENTIAL:
            check(torch.equal(got, ref), "lut_score half_sequential: not "
                  "bit for bit its plain twin")
        else:
            check(bool(((got - ref).abs() <= 2.0 ** -10 * mag).all()),
                  "lut_score half_once: beyond a float16 step of its plain "
                  "twin")
        b, by = bound_ms(distinct * cap * code_bytes + 4.0 * nq * pq_dim * kcb
                         + 4.0 * nq * cap + 4.0 * nq,
                         float(nq * cap * pq_dim))
        raw[name] = dict(
            shape=[nq, cap, code_bytes, pq_dim, bits],
            max_abs_err=float((got - ref).abs().max()), bound_ms=b,
            bound_by=by,
            ms=timed(lambda: kl.lut_score_rows(index.list_codes, rows, lut,
                                               pq_dim, bits, kcb, acc),
                     device, rep),
            plain_ms=timed(lambda: kl._lut_score_plain(
                index.list_codes[rows.long()], lut, pq_dim, bits, kcb, acc),
                device, 3))
    emit({"phase": "kernel", "name": "lut_score@float16_sums", **raw})
    return launches, raw


def _scan_bound(index, inp, nq, kk):
    """B4 scan mode's least time for one batch: each distinct row's live
    codes (and list-side sums) once, the LUTs once, the per-(query, step)
    rows, bases and LUT slices, the (nq, S, kk) values and slots; one
    add per live (query, slot) and subspace."""
    n_steps = inp.phys.shape[1]
    code_bytes = index.list_codes.shape[2]
    rows_u = inp.phys.unique().long()
    live_codes = float(index.phys_sizes[rows_u].long().sum())
    live = float(index.phys_sizes[inp.phys.long()].long().sum())
    lut_bytes = inp.tables.numel() * inp.tables.element_size()
    per_step_in = 4.0 * (2 + (inp.ords is not None))
    return bound_ms(live_codes * code_bytes + lut_bytes
                    + (4.0 * live_codes if inp.csum is not None else 0)
                    + 4.0 * rows_u.numel() + per_step_in * nq * n_steps
                    + 8.0 * nq * n_steps * kk, live * index.pq_dim)


def lut_scan_variants_phase(device, index_pc, index_pq, queries,
                            n_probes: int, k: int, rep: int):
    """B4's scan mode on the slice's new inputs: PER_CLUSTER's float32
    per-probe tables (64 KB each at pq_dim 64 × 256, two in a block's
    shared memory), the same with the float16 sum, the main index's
    float32 LUT with the float16 sum, and PER_CLUSTER's fp8 combined
    tables — each bit for bit against the per-step path (raw mode with
    the same sum) at the engine's batch, a solo query and 8 queries, and
    within its tolerance of the plain twin.  Returns the rows."""
    import torch

    from raft_tpu_torch.distance.pairwise import _dot_fixed_rows
    from raft_tpu_torch.kernels import ivf_pq_lut as kl
    from raft_tpu_torch.kernels import native
    from raft_tpu_torch.neighbors import ivf_pq

    out = {}
    for name, index, lut_name, acc in (
            ("per_cluster_float32", index_pc, "float32", kl.SUM_FLOAT32),
            ("per_cluster_float16_sum", index_pc, "float32",
             kl.SUM_HALF_ONCE),
            ("per_subspace_float16_sum", index_pq, "float32",
             kl.SUM_HALF_ONCE),
            ("per_cluster_fp8", index_pc, "float8_e4m3", kl.SUM_FLOAT32)):
        kcb = 1 << index.pq_bits
        kk = min(k, index.capacity)
        engines = ivf_pq._resolve_engines(index, None)
        batch = min(1024, ivf_pq.hoisted_batch_cap(index, n_probes, lut_name)
                    or 1024)

        def setup(nq):
            q = queries[:nq]
            probes = ivf_pq.coarse_probes(q, index, n_probes, engines[0])
            rot_q = _dot_fixed_rows(q, index.rotation.T)
            inp = ivf_pq.scan_inputs(q, probes, rot_q, index, lut_name)
            args = (index.list_codes, inp.phys, index.phys_sizes,
                    inp.tables, inp.ords, inp.base, inp.csum, inp.scale,
                    index.pq_dim, index.pq_bits, kcb, kk, True)

            def fused():
                vals, slots = kl.lut_scan_topk(*args, acc=acc)
                return ivf_pq._select_scanned(vals, slots, inp.phys,
                                              index.list_indices, k, True,
                                              engines[0])

            def per_step():
                return ivf_pq._scan_per_step(inp, index, k, True, *engines,
                                             acc=acc)

            return inp, args, fused, per_step

        by_q = {}
        for nq in (batch, 1, 8):
            inp, args, fused, per_step = setup(nq)
            native.reset_launches()
            got = fused()
            check(native.LAUNCHES["lut_scan"] == 1,
                  f"lut_scan {name}: not one launch per batch")
            ref = per_step()
            check(torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]),
                  f"lut_scan {name} at {nq} queries: (distances, ids) "
                  "differ from the per-step path")
            by_q[nq] = (inp, args, fused, per_step)
        inp, args, fused, per_step = by_q[batch]
        vals, _ = kl.lut_scan_topk(*args, acc=acc)
        pv, _ = kl.lut_scan_topk_plain(*args, acc=acc)
        fin = torch.isfinite(pv)
        check(torch.equal(fin, torch.isfinite(vals)),
              f"lut_scan {name}: finite entries differ from the plain twin")
        terms = (index.pq_dim * float(inp.tables.float().abs().max())
                 / (float(inp.scale.min()) if inp.scale is not None
                    else 1.0))
        tol = ((2.0 ** -10 if acc else 1e-5) * terms
               + 1e-5 * (pv.abs() + float(inp.base.abs().max())
                         + (float(inp.csum.abs().max())
                            if inp.csum is not None else 0.0)))
        diff = (vals - pv).abs()
        check(bool((diff <= tol)[fin].all()),
              f"lut_scan {name}: beyond its tolerance of the plain twin")
        b, by = _scan_bound(index, inp, batch, kk)
        out[name] = dict(
            shape=[batch, inp.phys.shape[1], index.capacity, index.pq_dim,
                   index.pq_bits],
            lut_bytes_per_table=index.pq_dim * kcb
            * inp.tables.element_size(),
            max_abs_err=float(diff[fin].max()) if fin.any() else 0.0,
            bound_ms=b, bound_by=by,
            ms=timed(lambda: kl.lut_scan_topk(*args, acc=acc), device, rep),
            plain_ms=timed(lambda: kl.lut_scan_topk_plain(*args, acc=acc),
                           device, 3),
            fused_path_ms=timed(fused, device, rep),
            per_step_path_ms=timed(per_step, device, rep),
            solo_ms=timed(lambda: kl.lut_scan_topk(*by_q[1][1], acc=acc),
                          device, rep))
        emit({"phase": "kernel", "name": f"lut_scan@{name}",
              "equals_per_step_path_bitwise": True, **out[name]})
    return out


def _index_bytes(index) -> int:
    import torch

    return int(sum(v.numel() * v.element_size() for v in vars(index).values()
                   if isinstance(v, torch.Tensor)))


def tiered_path(kind, device, index, x, resident, q_host, reqs, calls,
                n_queries, qr, truth, n_probes, k, smi, seed):
    """A built index tiered (hot_fraction 0.25, the default tile_phys;
    IVF-PQ with ``dataset=x`` for the refine store) and served by a
    tiered ``ServeEngine`` over every query: launch counts reset just
    before the tier and read right after serving.  Checks: every
    request's (distances, ids) equal the resident engine's bit for bit
    (*resident*: the serve phase's results); IVF-PQ with
    ``refine_ratio=4`` lifts recall@10 by at least 0.05;
    ``refresh(retier(...))`` from the searcher's hotness under
    ``submit()`` traffic resolves every request bit for bit;
    ``save_tiered`` / ``load_tiered`` give the same bits, the load
    putting less than the resident index on the card.  Returns the
    launches."""
    import shutil

    import torch

    from raft_tpu_torch.neighbors import ivf_flat, ivf_pq, serialize, tiering
    from raft_tpu_torch.serve import ServeEngine

    path = f"tiered_{kind}"
    mod = ivf_flat if kind == "ivf_flat" else ivf_pq
    params = mod.SearchParams(n_probes=n_probes)
    _reset(device)
    t0 = time.perf_counter()
    t = tiering.tier(index, hot_fraction=0.25,
                     dataset=x if kind == "ivf_pq" else None)
    tier_s = _synced_seconds(device, t0)
    eng = ServeEngine(t, k, params, max_batch=1024)
    c0 = dict(tiering.tier_counters)
    results, launches, row = serve_path(path, device, eng, k, reqs, calls,
                                        n_queries)
    c1 = dict(tiering.tier_counters)
    for (d, i), (rd, ri) in zip(results, resident):
        check(np.array_equal(i, ri) and np.array_equal(d, rd),
              f"{path}: a request's results differ from the resident "
              "engine's")
    stats = eng._health()["tiering"]
    # every dispatch, the warm ones too, runs the hot phase once
    batches = c1.get("hot_dispatches", 0) - c0.get("hot_dispatches", 0)
    searcher = eng._backend.searcher
    # the staging rate: one tile, pinned, copied on a lane and waited on
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    tensors, lane = searcher._stage(t.cold_tiles[0], 0, "prefetch_bytes")
    lane.synchronize()
    stage_s = time.perf_counter() - t0
    del tensors
    out = {"phase": "tiered", "path": path, "card": smi, "tier_s": tier_s,
           "tier_stats": stats, "resident_device_bytes": _index_bytes(index),
           "device_share": stats["device_bytes"] / _index_bytes(index),
           "qps": row["qps"], "serve_s": row["serve_s"],
           "dispatches": batches,
           "cold_tiles_per_batch": (c1.get("cold_tiles", 0)
                                    - c0.get("cold_tiles", 0)) / batches,
           "prefetch_bytes_per_batch": (c1.get("prefetch_bytes", 0)
                                        - c0.get("prefetch_bytes", 0))
           / batches,
           "tile_copy_s": stage_s,
           "staging_gb_per_s": t.tile_bytes() / stage_s / 1e9,
           "compiles_after_warmup": row["compiles_after_warmup"],
           "equals_resident_bitwise": True}
    nr = qr.shape[0]
    r_tiered = recall(_first_ids(results, nr, device), truth)
    out["recall_at_10"] = r_tiered
    if kind == "ivf_pq":
        rp = ivf_pq.SearchParams(n_probes=n_probes, refine_ratio=4)
        t0 = time.perf_counter()
        _, ids = tiering.search(t, qr, k, params=rp)
        refine_s = _synced_seconds(device, t0)
        r_ref = recall(ids.long(), truth)
        out.update(recall_at_10_refined=r_ref, refine_ratio=4,
                   refined_qps=nr / refine_s)
        check(r_ref >= r_tiered + 0.05, f"{path}: refine_ratio=4 recall "
              f"{r_ref} is not at least the unrefined {r_tiered} + 0.05")
    # re-tiering from the served counts, swapped in under traffic
    hot = searcher.hotness()
    check(int(hot.sum()) > 0, f"{path}: no probe was counted")
    t2 = tiering.retier(t, hot)
    eng2 = ServeEngine(t, k, params, max_batch=1024)
    eng2.warmup()
    ref_d = np.concatenate([r[0] for r in resident])
    ref_i = np.concatenate([r[1] for r in resident])
    offsets = np.cumsum([0] + [q.shape[0] for q in reqs[:-1]])
    t0 = time.perf_counter()
    outs = _stream_pass(eng2, reqs, 0.5 * row["qps"], None, seed,
                        during=lambda: eng2.refresh(t2))[0]
    out["retier_under_traffic_s"] = time.perf_counter() - t0
    _check_stream(path, outs, reqs, offsets, ref_d, ref_i,
                  rejections_ok=False)
    check(eng2.stats["refreshes"] == 1,
          f"{path}: refreshes {eng2.stats['refreshes']} != 1")
    out["retier_hot_lists_changed"] = int((t2.hot_lists != t.hot_lists).sum())
    eng2.close()
    eng.close()
    # the archive: saved, loaded, the same bits
    ARCHIVE_DIR.mkdir(parents=True, exist_ok=True)
    try:
        t0 = time.perf_counter()
        serialize.save_tiered(ARCHIVE_DIR / path, t)
        out["save_s"] = time.perf_counter() - t0
        out["archive_bytes"] = (ARCHIVE_DIR / f"{path}.npz").stat().st_size
        if device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        back = serialize.load_tiered(ARCHIVE_DIR / path, device=device)
        out["load_s"] = _synced_seconds(device, t0)
        check(all(v.device.type == "cpu" for v in back.host.values()
                  if isinstance(v, torch.Tensor)),
              f"{path}: the loaded archive's family leaves left the host")
        if device.type == "cuda":
            # only the model tables and the hot block go to the card
            out["load_peak_device_bytes"] = (torch.cuda.max_memory_allocated()
                                             - base)
            check(out["load_peak_device_bytes"] < _index_bytes(index),
                  f"{path}: loading the archive took "
                  f"{out['load_peak_device_bytes']} device bytes, not less "
                  f"than the resident index's {_index_bytes(index)}")
        a = tiering.search(t, qr, k, params=params)
        b = tiering.search(back, qr, k, params=params)
        check(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]),
              f"{path}: the loaded archive searches differently")
        out["archive_bitwise"] = True
    finally:
        shutil.rmtree(ARCHIVE_DIR, ignore_errors=True)
    emit(out)
    if device.type == "cuda":   # the busy share of one super-batch
        profile_serve(path, ServeEngine(t, k, params, max_batch=1024),
                      q_host, device)
    return launches


def approx_knn_phase(device, index_flat, index_pq, queries, n_probes, k):
    """``approx_knn_search`` over the built IVF-Flat and IVF-PQ indexes
    equals each family's ``search`` bit for bit."""
    import torch

    from raft_tpu_torch.neighbors import ann, ivf_flat, ivf_pq

    q = queries[:1024]
    out = {"phase": "approx_knn", "queries": q.shape[0]}
    for name, idx, mod in (("ivf_flat", index_flat, ivf_flat),
                           ("ivf_pq", index_pq, ivf_pq)):
        kw = {f"{name}_index": idx}
        knn_index = ann.KnnIndex(idx.metric, 2.0, n_probes, **kw)
        got = ann.approx_knn_search(knn_index, q, k)
        ref = mod.search(mod.SearchParams(n_probes=n_probes), idx, q, k)
        check(torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]),
              f"approx_knn_search over {name} differs from its search")
        out[f"{name}_equals_family_search"] = True
    emit(out)


#: the handle phase: the IVF-PQ search's batch and pool, and its repeats
HANDLE_BATCH = 1024
HANDLE_POOL = 4
HANDLE_REPS = 3
#: L1 kNN queries; cityblock rows × columns; k-means rows, k, EM steps
HANDLE_KNN_QUERIES = 256
HANDLE_PAIRWISE = (4096, 1024)
HANDLE_KMEANS = (100_000, 256, 5)
#: cycles the card sleeps ahead of the allocator and cancel checks (about
#: half a second)
HANDLE_SLEEP_CYCLES = 1_000_000_000


def _same(a, b) -> bool:
    import torch

    return all(torch.equal(u, v) for u, v in zip(a, b))


def _cancelled_sync(h) -> dict:
    """A thread's ``h.sync()`` cancelled from this one: whether it
    raised, and whether a second ``sync()`` then completed."""
    from raft_tpu_torch.core import interruptible
    from raft_tpu_torch.core.error import InterruptedError_

    box, started = {}, threading.Event()

    def waiter():
        box["tid"] = threading.get_ident()
        started.set()
        try:
            h.sync()
            box["raised"] = False
        except InterruptedError_:
            box["raised"] = True

    t = threading.Thread(target=waiter)
    t.start()
    check(started.wait(10), "handle: the cancel check's thread did not start")
    time.sleep(0.02)
    interruptible.cancel(box["tid"])
    t.join(timeout=10)
    check(not t.is_alive(), "handle: a cancelled sync did not return")
    pending = not h.get_stream().query()
    t0 = time.perf_counter()
    h.sync()
    return {"raised": box.get("raised"), "pending_after_cancel": pending,
            "second_sync_s": time.perf_counter() - t0,
            "done_after_second_sync": h.get_stream().query()}


def _handle_lifetime_checks(pq_search, ref, queries, path):
    """The card-only checks of the handle phase: the allocator check, a
    cancelled sync, and a stream the handle does not own."""
    import torch

    from raft_tpu_torch.core import Handle

    out = {}
    # the allocator check: the caller's queries outlive the caller
    h = Handle(n_streams=HANDLE_POOL)
    qd = queries.clone()
    ptr = qd.data_ptr()
    with h.get_stream().context():
        torch.cuda._sleep(HANDLE_SLEEP_CYCLES)
    with path.span():
        got = pq_search(h, qd)
    del qd
    junk = torch.empty_like(queries).fill_(float("nan"))
    reused = junk.data_ptr() == ptr
    h.sync()
    check(not reused, "handle: the dropped queries' block was handed out "
          "while the pool still read it")
    check(_same(got, ref), "handle: results changed after the caller "
          "dropped its queries before sync()")
    out["allocator"] = {"block_reused": reused, "bit_for_bit": True}
    del junk, got

    # a cancelled sync, and a stream the handle does not own
    h = Handle()
    with h.get_stream().context():
        torch.cuda._sleep(HANDLE_SLEEP_CYCLES)
    cancel = _cancelled_sync(h)
    check(cancel["raised"] is True and cancel["pending_after_cancel"]
          and cancel["done_after_second_sync"],
          f"handle: the cancel check failed: {cancel}")
    out["cancel"] = cancel
    foreign = torch.cuda.Stream()
    with torch.cuda.stream(foreign):
        torch.cuda._sleep(HANDLE_SLEEP_CYCLES)
    t0 = time.perf_counter()
    Handle(n_streams=2).sync()
    waited = time.perf_counter() - t0
    busy = not foreign.query()
    foreign.synchronize()
    check(busy, "handle: the foreign stream finished before the check")
    out["foreign_stream"] = {"sync_s": waited, "still_busy": busy}

    return out


def handle_phase(device, index_pq, index_flat, x, queries, n_probes, k,
                 smi):
    """The resource model on the card (phase 15 of the module doc).
    Returns the launch counts of the handle runs."""
    import torch

    from raft_tpu_torch.cluster import kmeans
    from raft_tpu_torch.cluster.kmeans_types import InitMethod, KMeansParams
    from raft_tpu_torch.core import Handle
    from raft_tpu_torch.distance import pairwise_distance
    from raft_tpu_torch.neighbors import brute_force, ivf_flat, ivf_pq

    t_phase = time.perf_counter()
    path = _PathLaunches()
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    sp = ivf_pq.SearchParams(n_probes=n_probes)

    def pq_search(h=None, q=queries):
        return ivf_pq.search(sp, index_pq, q, k,
                             batch_size_query=HANDLE_BATCH, handle=h)

    ref = pq_search()
    # one handle per way, made once and first used untimed, as a caller
    # keeps its handle: a stream's first allocations are the allocator's
    handles = {"none": None, "handle": Handle(device),
               f"pool{HANDLE_POOL}": Handle(device, n_streams=HANDLE_POOL)}
    search = {m: {"first_return_s": None, "first_sync_s": None,
                  "return_s": [], "sync_s": [], "pending_pool_streams": [],
                  "pending_main_stream": []} for m in handles}
    for rep in range(HANDLE_REPS + 1):
        for m, h in handles.items():
            sync()
            t0 = time.perf_counter()
            if h is None:
                got = pq_search()
            else:
                with path.span():
                    got = pq_search(h)
            t_ret = time.perf_counter() - t0
            row = search[m]
            pending = (sum(not h.get_stream_from_stream_pool(b).query()
                           for b in range(h.stream_pool_size)),
                       not h.get_stream().query()) if h is not None else None
            t1 = time.perf_counter()
            if h is not None:
                h.sync()
            t_sync = time.perf_counter() - t1
            if rep == 0:
                row["first_return_s"], row["first_sync_s"] = t_ret, t_sync
            else:
                row["return_s"].append(t_ret)
                row["sync_s"].append(t_sync)
                if pending is not None:
                    row["pending_pool_streams"].append(pending[0])
                    row["pending_main_stream"].append(pending[1])
            check(_same(got, ref),
                  f"handle: ivf_pq.search under {m} differs from the call "
                  "without a handle")
    out = {"phase": "handle", "queries": int(queries.shape[0]),
           "batch_size_query": HANDLE_BATCH, "n_probes": n_probes, "k": k,
           "ivf_pq_search": search}

    # the other kernels under one handle, each against its handle-less twin
    h = Handle(device, n_streams=2)
    qk = queries[:HANDLE_KNN_QUERIES]
    xa, ya = x[:HANDLE_PAIRWISE[0]], queries[:HANDLE_PAIRWISE[1]]
    n_km, k_km, it_km = HANDLE_KMEANS
    p_km = KMeansParams(n_clusters=k_km, init=InitMethod.Array,
                        max_iter=it_km, tol=0.0)
    fp = ivf_flat.SearchParams(n_probes=n_probes)
    with path.span():
        flat = ivf_flat.search(fp, index_flat, queries, k, handle=h)
        l1 = brute_force.knn(x, qk, k, "l1", handle=h)
        cb = pairwise_distance(xa, ya, "cityblock", handle=h)
        km = kmeans.fit(p_km, x[:n_km], centroids=x[:k_km], handle=h)
        h.sync()
    km_ref = kmeans.fit(p_km, x[:n_km], centroids=x[:k_km])
    equal = {
        "ivf_flat_search": _same(flat, ivf_flat.search(fp, index_flat,
                                                       queries, k)),
        "knn_l1": _same(l1, brute_force.knn(x, qk, k, "l1", device=device)),
        "pairwise_cityblock": bool(torch.equal(
            cb, pairwise_distance(xa, ya, "cityblock", device=device))),
        "kmeans_fit": _same((km.centroids, km.inertia),
                            (km_ref.centroids, km_ref.inertia))}
    for name, ok in equal.items():
        check(ok, f"handle: {name} under a handle differs from the call "
              "without one")
    out["bit_for_bit"] = equal

    if cuda:
        out.update(_handle_lifetime_checks(pq_search, ref, queries, path))
    launches = path.total
    missing = [kk for kk in PATH_KERNELS["handle"] if not launches.get(kk)]
    check(not missing, f"handle: kernels never launched: {missing}")
    out.update(launches=launches, seconds=time.perf_counter() - t_phase,
               card=smi)
    emit(out)
    return launches


def check_knn(name, d, i, ref_d, ref_i, tie_d):
    """(nq, k) distances and ids against a reference: distances to rtol
    1e-5; ids equal except at near ties, where a position's distance in
    *tie_d* (the checker's best k + 1 per row) lies within 1e-5 relative of
    a neighbour's.  Returns the number of ids that differ at near ties."""
    import torch

    check(bool(((d - ref_d).abs() <= 1e-5 * ref_d.abs() + 1e-6).all()),
          f"{name}: distances beyond rtol 1e-5")
    kk = d.shape[1]
    gap = (tie_d[:, 1:] - tie_d[:, :-1]).abs() <= 1e-5 * tie_d[:, 1:].abs()
    tied = torch.zeros_like(d, dtype=torch.bool)
    tied |= gap[:, :kk]                 # tied with the next candidate
    tied[:, 1:] |= gap[:, :kk - 1]      # tied with the previous one
    diff = i.long() != ref_i.long()
    check(not bool((diff & ~tied).any()),
          f"{name}: ids differ outside near ties")
    return int(diff.sum())


def brute_force_path(device, x, queries, reqs, calls, n_queries, qr, k):
    """The brute-force main path (exact kNN under L1 over the whole
    dataset) and its checks; returns (engine, launches, served)."""
    import torch

    from raft_tpu_torch.neighbors import brute_force
    from raft_tpu_torch.serve import ServeEngine

    _reset(device)
    eng = ServeEngine(x, k, metric="l1", max_batch=1024, device=device)
    results, launches, row = serve_path("brute_force", device, eng, k, reqs,
                                        calls, n_queries)
    check_coalesced("brute_force",
                    lambda q: brute_force.knn(x, q, k, "l1", device=device),
                    reqs, results)
    nr = qr.shape[0]
    got_d = torch.as_tensor(np.concatenate([r[0] for r in results]),
                            device=device)
    got_i = _first_ids(results, n_queries, device)
    # the checker: every L1 distance, then the k + 1 smallest per row
    t0 = time.perf_counter()
    ref = torch.cdist(qr, x, p=1.0)
    ref_d, ref_i = torch.topk(ref, k + 1, dim=1, largest=False)
    del ref
    checker_s = _synced_seconds(device, t0)
    ties_checker = check_knn("brute_force vs torch.cdist", got_d[:nr],
                             got_i[:nr], ref_d[:, :k], ref_i[:, :k], ref_d)
    # the plain path's k + 1 best tell its near ties at rank k
    t0 = time.perf_counter()
    plain_d, plain_i = brute_force.knn(x, queries, k + 1, "l1",
                                       device=device, engine="torch")
    plain_s = _synced_seconds(device, t0)
    ties_plain = check_knn("brute_force kernel vs plain path", got_d, got_i,
                           plain_d[:, :k], plain_i[:, :k], plain_d)
    emit({"phase": "checks", "path": "brute_force", "metric": "l1",
          "coalesced_equals_solo": True, "checker_queries": nr,
          "checker": "torch.cdist(p=1) + torch.topk",
          "checker_s": checker_s,
          "id_diffs_at_near_ties_vs_checker": ties_checker,
          "plain_path_queries": n_queries, "plain_path_s": plain_s,
          "id_diffs_at_near_ties_vs_plain_path": ties_plain,
          "index_bytes": x.numel() * x.element_size()})
    return eng, launches, Served(
        results, row, lambda: ServeEngine(x, k, metric="l1", max_batch=1024,
                                          device=device))


def pairwise_distance_phase(device, rep: int):
    """Every name of SUPPORTED_DISTANCES at the scan step shape against
    ``engine="torch"``; the B5 metrics must launch B5, the others not."""
    import torch

    from raft_tpu_torch.distance import (ACCUMULATE_METRICS, DISTANCE_TYPES,
                                         SUPPORTED_DISTANCES,
                                         pairwise_distance)
    from raft_tpu_torch.kernels import native

    gen = torch.Generator(device=device).manual_seed(17)
    # positive rows: the domain of every metric (Hellinger, KL, JS)
    x = torch.rand(1024, 128, generator=gen, device=device) + 1e-3
    y = torch.rand(16384, 128, generator=gen, device=device) + 1e-3
    out = {}
    for name in SUPPORTED_DISTANCES:
        native.reset_launches()
        got = pairwise_distance(x, y, name, p=3.0, device=device)
        launched = native.LAUNCHES["pairwise_accumulate"]
        b5 = DISTANCE_TYPES[name] in ACCUMULATE_METRICS
        check((launched > 0) == b5,
              f"pairwise_distance {name}: B5 launches {launched}")
        t0 = time.perf_counter()
        ref = pairwise_distance(x, y, name, p=3.0, device=device,
                                engine="torch")
        plain_ms = _synced_seconds(device, t0) * 1e3
        check(got.shape == (1024, 16384) and bool(torch.isfinite(got).all()),
              f"pairwise_distance {name}: not finite (1024, 16384)")
        check(torch.allclose(got, ref, rtol=1e-5, atol=1e-5),
              f"pairwise_distance {name}: beyond rtol 1e-5, atol 1e-5 of "
              "the plain path")
        out[name] = {"b5": b5, "max_abs_err": float((got - ref).abs().max()),
                     "ms": timed(lambda: pairwise_distance(
                         x, y, name, p=3.0, device=device), device, rep),
                     "plain_ms": plain_ms}
    emit({"phase": "pairwise_distance", "shape": [1024, 16384, 128],
          "metric_arg": 3.0, "metrics": out})


def pairwise_kernel_phase(device, x, queries, rep: int):
    """B5 against its plain version: six ops × three input types at the
    brute-force scan step (bucket 1,024 × tile 16,384 × 128) and at ragged
    shapes, the batch-invariance check, and each op's time beside the
    plain version's, a ``torch.cdist`` yardstick's and the bound; returns
    B5's row (the L1 numbers)."""
    import torch

    from raft_tpu_torch.kernels import pairwise as pk

    dtypes = (torch.float32, torch.bfloat16, torch.float16)

    def compare(a, b, op, what):
        got = pk.pairwise_accumulate(a, b, op, 3.0)
        ref = pk.pairwise_accumulate_plain(a, b, op, 3.0)
        nan = torch.isnan(ref)
        check(torch.equal(torch.isnan(got), nan), f"{what}: NaN differs")
        err = (got - ref).abs()[~nan]
        if op in ("linf", "hamming"):
            check(not bool(err.any()), f"{what}: not exact")
        else:   # the terms are non-negative: Σ|terms| is the value
            check(bool((err <= 1e-5 * ref.abs()[~nan]).all()),
                  f"{what}: beyond 1e-5 × Σ|terms| of the plain version")
        return float(err.max()) if err.numel() else 0.0

    # the step shape; values in quarters, so coordinates tie and vanish
    xs = torch.round(queries[:1024] * 4) / 4
    ys = torch.round(x[:16384] * 4) / 4
    m, k = xs.shape
    n = ys.shape[0]
    library = {
        "l1": (lambda: torch.cdist(xs, ys, p=1.0), lambda a: a),
        "l2": (lambda: torch.cdist(
            xs, ys, p=2.0, compute_mode="donot_use_mm_for_euclid_dist"),
            torch.sqrt),
        "linf": (lambda: torch.cdist(xs, ys, p=float("inf")), lambda a: a),
        "lp": (lambda: torch.cdist(xs, ys, p=3.0),
               lambda a: torch.pow(a, 1.0 / 3.0)),
        "hamming": (lambda: torch.cdist(xs, ys, p=0.0), lambda a: a),
    }
    by_op = {}
    for op in pk.OPS:
        errs = {str(dt).split(".")[1]: compare(xs.to(dt), ys.to(dt), op,
                                               f"pairwise {op} {dt} step")
                for dt in dtypes}
        acc = pk.pairwise_accumulate(xs, ys, op, 3.0)
        # B5's tile follows the batch; a row's bits must not
        for mb in BUCKET_ROWS:
            check(torch.equal(pk.pairwise_accumulate(xs[:mb], ys, op, 3.0),
                              acc[:mb]),
                  f"pairwise {op}: rows of a {mb}-row batch differ")
        lib_ms = None
        if op in library:
            fn, fin = library[op]
            check(torch.allclose(fin(acc), fn(), rtol=1e-4, atol=1e-4),
                  f"pairwise {op}: torch.cdist yardstick disagrees")
            lib_ms = timed(fn, device, rep)
        ops_per = B5_OPS_PER_ELEMENT[op]
        b, by = bound_ms(4.0 * (m * k + n * k + m * n),
                         float(ops_per) * m * n * k, F32_INSTR_PER_S)
        by_op[op] = dict(
            max_abs_err=max(errs.values()), max_abs_err_by_dtype=errs,
            ms=timed(lambda: pk.pairwise_accumulate(xs, ys, op, 3.0), device,
                     rep),
            plain_ms=timed(lambda: pk.pairwise_accumulate_plain(xs, ys, op,
                                                                3.0),
                           device, 3),
            library_ms=lib_ms, bound_ms=b, bound_by=by,
            ops_per_element=ops_per)
    half_ms = {str(dt).split(".")[1]: timed(
        lambda: pk.pairwise_accumulate(xs.to(dt), ys.to(dt), "l1"), device,
        rep) for dt in dtypes[1:]}

    # ragged shapes, one NaN in x; k = 960 is above the TPU kernel's cap
    gen = torch.Generator(device=device).manual_seed(19)
    ragged, errs = [], []
    for rm in (1, 37):
        for rn in (1, 129, 16385):
            for rk in (1, 3, 127, 960):
                a = torch.round(torch.randn(rm, rk, generator=gen,
                                            device=device) * 4) / 4
                b = torch.round(torch.randn(rn, rk, generator=gen,
                                            device=device) * 4) / 4
                a[0, rk // 2] = float("nan")
                for op in pk.OPS:
                    for dt in dtypes:
                        errs.append(compare(a.to(dt), b.to(dt), op,
                                            f"pairwise {op} {dt} "
                                            f"{rm}×{rn}×{rk}"))
                ragged.append([rm, rn, rk])
    l1 = by_op["l1"]
    row = dict(max_abs_err=max([l1["max_abs_err"]] + errs), ms=l1["ms"],
               plain_ms=l1["plain_ms"], bound_ms=l1["bound_ms"],
               bound_by=l1["bound_by"], library_ms=l1["library_ms"])
    emit({"phase": "kernel", "name": "pairwise_accumulate",
          "shape": [m, n, k], "library": "torch.cdist",
          "batch_invariant_rows": list(BUCKET_ROWS), "l1_ms_by_dtype": half_ms,
          "ragged_shapes_m_n_k": ragged, "by_op": by_op, **row})
    return row


# ---------------------------------------------------------------------------
# the k-means path (BASELINE.json configs[1])
# ---------------------------------------------------------------------------

def kmeans_near_ties(x, y, metric, rows: int = 8192):
    """Per row of x: whether its two nearest rows of y (float64) under
    *metric* lie within 1e-5 relative of each other — of ‖x‖² + ‖y‖² of
    the nearer row for the L2 family (B1's 3xTF32 products), of the
    nearer distance otherwise."""
    import torch

    from raft_tpu_torch.distance import DistanceType, L2_METRICS

    if metric in L2_METRICS:
        return near_ties(x, y, rows=rows, of_norms=True)
    yd = y.double()
    out = []
    for r in range(0, x.shape[0], rows):
        xd = x[r:r + rows].double()
        if metric == DistanceType.L1:
            d = torch.cdist(xd, yd, p=1.0)
        else:   # cosine
            d = 1.0 - (torch.nn.functional.normalize(xd, dim=1)
                       @ torch.nn.functional.normalize(yd, dim=1).T)
        two = torch.topk(d, 2, dim=1, largest=False).values
        out.append((two[:, 1] - two[:, 0])
                   <= 1e-5 * two[:, 0].abs().clamp_min(1e-30))
    return torch.cat(out)


def kmeans_labels(name, idx, ref_idx, x, y, metric):
    """Labels equal except at near ties (:func:`kmeans_near_ties`);
    returns the count that differ."""
    diff = idx != ref_idx
    n_diff = int(diff.sum())
    if n_diff:
        tied = kmeans_near_ties(x[diff], y, metric)
        check(bool(tied.all()), f"{name}: labels differ outside near ties")
    return n_diff


def kmeans_compare(name, device, x, c0, metric, iters: int):
    """From the init centroids *c0*, *iters* EM iterations (``tol`` 0 and
    ``loop="fori"``: every iteration runs, ``n_iter`` counts those before
    the centroids stopped moving) through the kernels (``engine="cuda"``)
    and twice through the plain versions (``engine="torch"``); the kernel
    fit's labels and inertia held to the
    first plain fit's within ``KMEANS_ARI_GAP`` / ``KMEANS_INERTIA_GAP``
    (the second plain fit shows the plain path's own spread), and
    ``predict`` under the kernel fit's centroids equal on both engines
    except at near ties.  Returns (the line's fields, the kernel fit's
    launches, its centroids)."""
    from raft_tpu_torch import cluster, stats
    from raft_tpu_torch.cluster import InitMethod, KMeansParams
    from raft_tpu_torch.distance import L2_METRICS
    from raft_tpu_torch.kernels import native

    k = c0.shape[0]
    p = KMeansParams(n_clusters=k, init=InitMethod.Array, max_iter=iters,
                     tol=0.0, metric=metric)
    _reset(device)
    t0 = time.perf_counter()
    kern = cluster.fit(p, x, centroids=c0, loop="fori", engine="cuda")
    kern_s = _synced_seconds(device, t0)
    launches = dict(native.LAUNCHES)
    t0 = time.perf_counter()
    plain = cluster.fit(p, x, centroids=c0, loop="fori", engine="torch")
    plain_s = _synced_seconds(device, t0)
    plain2 = cluster.fit(p, x, centroids=c0, loop="fori", engine="torch")
    lk, _ = cluster.predict(p, x, kern.centroids, engine="cuda")
    lp, _ = cluster.predict(p, x, plain.centroids, engine="torch")
    lp2, _ = cluster.predict(p, x, plain2.centroids, engine="torch")
    ik, ip, ip2 = (float(o.inertia) for o in (kern, plain, plain2))
    # the E-step's value contract, summed over the rows
    if metric in L2_METRICS:
        cn = (kern.centroids.double() ** 2).sum(1)
        slack = 1e-5 * float((x.double() ** 2).sum() + cn[lk.long()].sum())
    else:
        slack = 1e-5 * ip
    out = dict(
        metric=metric.name, iters=iters, n_iter=int(kern.n_iter),
        plain_n_iter=int(plain.n_iter),
        kernel_fit_s=kern_s, plain_fit_s=plain_s,
        kernel_iters_per_s=iters / kern_s, plain_iters_per_s=iters / plain_s,
        inertia=ik, plain_inertia=ip, plain2_inertia=ip2,
        inertia_gap=abs(ik - ip) / ip, inertia_gap_bound=(
            slack / ip + KMEANS_INERTIA_GAP),
        plain_inertia_gap=abs(ip2 - ip) / ip,
        ari_vs_plain=float(stats.adjusted_rand_index(lk, lp)),
        plain_ari_vs_plain=float(stats.adjusted_rand_index(lp2, lp)),
        launches=launches)
    check(out["ari_vs_plain"] >= 1.0 - KMEANS_ARI_GAP,
          f"{name}: ARI against the plain path {out['ari_vs_plain']}")
    check(out["inertia_gap"] <= out["inertia_gap_bound"],
          f"{name}: inertia {ik} against the plain path's {ip}")
    lt, _ = cluster.predict(p, x, kern.centroids, engine="torch")
    out["predict_label_diffs_near_ties"] = kmeans_labels(
        f"{name} predict", lk, lt, x, kern.centroids, metric)
    return out, launches, kern.centroids


def kmeans_ties(device, x, k: int, l: int, n_rounds: int, seed: int):
    """The k-means‖ buffer (1 + n_rounds·l rows) as one round leaves it:
    the first centre, l sampled rows, and copies — of the first centre,
    then (a second buffer) of the sampled rows, so copies sit in other
    tiles and lanes than their originals.  Through B1 every copy slot must
    own no row.  Returns (the fields, the first buffer)."""
    import torch

    from raft_tpu_torch.cluster import min_cluster_and_distance

    n, dim = x.shape
    cap = 1 + n_rounds * l
    gen = torch.Generator(device=device).manual_seed(seed + 23)
    rows = x[torch.randperm(n, generator=gen, device=device)[:l]]
    buf = x[:1].expand(cap, dim).clone()
    buf[1:1 + l] = rows
    buf2 = buf.clone()
    reps = -(-(cap - 1 - l) // l)
    buf2[1 + l:] = rows.repeat(reps, 1)[:cap - 1 - l]
    out = {"cap": cap, "filled": 1 + l}
    for name, b in (("copies_of_first", buf), ("copies_of_sampled", buf2)):
        nn = min_cluster_and_distance(x, b, engine="cuda")
        counts = torch.bincount(nn.key.long(), minlength=cap)
        owned = int(counts[1 + l:].sum())
        out[f"{name}_rows_owned"] = owned
        check(owned == 0, f"k-means|| buffer ties ({name}): copy slots own "
              f"{owned} rows")
    return out, buf


def b1_row(name, device, x, y, rep: int):
    """B1 on (x, y) against its plain version: labels equal except at near
    ties, values within 1e-5 of ‖x‖² + ‖y‖²; with its time, the plain
    version's, the product's alone and the bound."""
    from raft_tpu_torch.distance import DistanceType
    from raft_tpu_torch.distance.fused_l2_nn import fused_l2_nn_plain
    from raft_tpu_torch.kernels import fused_l2nn

    n, d = x.shape
    ky = y.shape[0]
    val, idx = fused_l2nn.fused_l2_nn(x, y)
    pv, pi = fused_l2_nn_plain(x, y)
    n_diff = kmeans_labels(f"fused_l2_nn {name}", idx, pi, x, y,
                           DistanceType.L2Expanded)
    scale = (x * x).sum(1) + (y * y).sum(1)[idx.long()]
    err = (val - pv).abs()
    check(bool((err <= 1e-5 * scale).all()),
          f"fused_l2_nn {name}: values beyond 1e-5 of the norms")
    bound, by = bound_ms(4.0 * (n * d + ky * d + 2 * n),
                         6.0 * n * ky * d, TF32_FLOP_PER_S)
    return dict(
        shape=[n, ky, d], max_abs_err=float(err.max()),
        label_diffs_near_ties=n_diff,
        ms=timed(lambda: fused_l2nn.fused_l2_nn(x, y), device, rep),
        plain_ms=timed(lambda: fused_l2_nn_plain(x, y), device, 3),
        product_only_ms=timed(lambda: x @ y.T, device, 3),
        bound_ms=bound, bound_by=by, library_ms=None)


def b3_row(name, device, x, c, rep: int):
    """B3's EM step on (x, c) against the plain version's: its E-step's
    labels equal except at near ties, values within 1e-5 of ‖x‖² + ‖c‖²,
    the inertia within the sum of those bounds (and of B3's own values);
    then its M-step partials keyed by its labels, which are the plain
    labels but at the near ties just checked: a cluster's n_c float32
    terms summed in any order lie within γ(n_c)·Σ|x| of their float64 sum
    (γ(n) = n·u / (1 − n·u), u = 2⁻²⁴), so B3's must, and the plain
    version's within twice that of B3's.  With its time, the plain
    version's and the bound."""
    import torch

    from raft_tpu_torch.distance import DistanceType
    from raft_tpu_torch.distance.fused_l2_nn import (
        cluster_partials_plain,
        fused_l2_nn_partials_plain,
    )
    from raft_tpu_torch.kernels import fused_l2nn
    from raft_tpu_torch.linalg.reduce import segment_sum

    n, d = x.shape
    k = c.shape[0]
    tag = f"fused_l2_nn_partials {name}"
    out = fused_l2nn.fused_l2_nn_partials(x, c)
    ref = fused_l2_nn_partials_plain(x, c)
    n_diff = kmeans_labels(tag, out[1], ref[1], x, c,
                           DistanceType.L2Expanded)
    scale = (x * x).sum(1) + (c * c).sum(1)[out[1].long()]
    check(bool(((out[0] - ref[0]).abs() <= 1e-5 * scale).all()),
          f"{tag}: values beyond 1e-5 of the norms")
    own = float(out[0].double().sum())
    inertia_gap = abs(float(out[4]) - float(ref[4]))
    check(inertia_gap <= 1e-5 * float(scale.double().sum()) + 1e-5 * own
          and abs(float(out[4]) - own) <= 1e-5 * own,
          f"{tag}: inertia {float(out[4])} against the plain version's "
          f"{float(ref[4])} and its values' sum {own}")
    sums, wsum = cluster_partials_plain(x, out[1], k)
    exact = segment_sum(x.double(), out[1], k)
    mag = segment_sum(x.double().abs(), out[1], k)
    nc = segment_sum(torch.ones_like(x[:, 0], dtype=torch.float64), out[1],
                     k)
    u = 2.0 ** -24
    gamma_mag = (nc * u / (1 - nc * u))[:, None] * mag
    err = (out[2] - exact).abs()
    plain_err = (sums - exact).abs()
    check(torch.equal(out[3].double(), nc) and torch.equal(wsum.double(), nc)
          and bool((err <= gamma_mag).all())
          and bool(((out[2] - sums).abs() <= 2 * gamma_mag).all()),
          f"{tag}: partials beyond γ(n_c)·Σ|x| of their float64 sums "
          f"(B3 {float(err.max())}, plain {float(plain_err.max())})")
    del ref, scale
    t_bytes = 4.0 * (n * d + 2 * k * d + 2 * n + k) / HBM_BYTES_PER_S
    t_ops = 6.0 * n * k * d / TF32_FLOP_PER_S + 1.0 * n * d / F32_FLOP_PER_S
    share = (err / gamma_mag.clamp_min(1e-300))
    return dict(
        shape=[n, k, d], max_abs_err=float((out[2] - sums).abs().max()),
        partials_err_vs_f64=float(err.max()),
        plain_partials_err_vs_f64=float(plain_err.max()),
        partials_err_share_of_bound=float(share.max()),
        label_diffs_near_ties=n_diff, inertia_gap=inertia_gap,
        ms=timed(lambda: fused_l2nn.fused_l2_nn_partials(x, c), device, rep),
        plain_ms=timed(lambda: fused_l2_nn_partials_plain(x, c),
                       device, 3),
        bound_ms=max(t_bytes, t_ops) * 1e3,
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        library_ms=None)


def kmeans_kernel_rows(device, x, c, buf, rep: int):
    """B1 at the k-means E-step (n × k × d) and at the k-means‖ width
    (n × (1 + 5·2k) × d), B3 at the EM step (n × k × d) and B5 L1 at one
    E-step block (2,048 × k × d), each against its plain version, with its
    time, the plain version's, the library call's where one computes the
    same function, and the bound."""
    import torch

    from raft_tpu_torch.kernels import pairwise as pk

    d = x.shape[1]
    k = c.shape[0]
    rows = {"fused_l2_nn": {}}
    for name, y in (("kmeans_e_step", c), ("kmeans_pp_width", buf)):
        rows["fused_l2_nn"][name] = b1_row(name, device, x, y, rep)
        emit({"phase": "kernel", "name": f"fused_l2_nn@{name}",
              **rows["fused_l2_nn"][name]})
    rows["fused_l2_nn_partials"] = {
        "kmeans_em_step": b3_row("kmeans", device, x, c, rep)}
    emit({"phase": "kernel", "name": "fused_l2_nn_partials@kmeans_em_step",
          **rows["fused_l2_nn_partials"]["kmeans_em_step"]})

    xb = x[:2048]
    acc = pk.pairwise_accumulate(xb, c, "l1")
    ref = pk.pairwise_accumulate_plain(xb, c, "l1")
    err = (acc - ref).abs()
    check(bool((err <= 1e-5 * ref).all()),
          "pairwise l1 kmeans: beyond 1e-5 × Σ|terms| of the plain version")
    m = xb.shape[0]
    b, by = bound_ms(4.0 * (m * d + k * d + m * k),
                     float(B5_OPS_PER_ELEMENT["l1"]) * m * k * d,
                     F32_INSTR_PER_S)
    rows["pairwise_accumulate"] = {"kmeans_l1_e_step_block": dict(
        shape=[m, k, d], max_abs_err=float(err.max()),
        ms=timed(lambda: pk.pairwise_accumulate(xb, c, "l1"), device, rep),
        plain_ms=timed(lambda: pk.pairwise_accumulate_plain(xb, c, "l1"),
                       device, 3),
        library_ms=timed(lambda: torch.cdist(xb, c, p=1.0), device, rep),
        bound_ms=b, bound_by=by)}
    emit({"phase": "kernel", "name": "pairwise_accumulate@kmeans_l1",
          "library": "torch.cdist(p=1)",
          **rows["pairwise_accumulate"]["kmeans_l1_e_step_block"]})
    return rows


def kmeans_path(device, seed: int, rep: int, smi):
    """The k-means main path at ``KMEANS_SHAPE`` — ``fit_predict`` with
    the reference defaults on ``make_blobs`` data — then its checks (the
    ``kmeans``, ``kmeans_checks``, ``kmeans_l1``, ``kmeans_cosine`` and
    ``silhouette`` lines) and the kernels at its shapes.  Returns (launch
    counts by path, the kernels' k-means fields, the data and the fit's
    parameters for ``--profile``, and the init's centroids)."""
    import torch

    from raft_tpu_torch import cluster, stats
    from raft_tpu_torch.cluster import InitMethod, KMeansParams
    from raft_tpu_torch.distance import DistanceType
    from raft_tpu_torch.kernels import native
    from raft_tpu_torch.random import RngState, make_blobs

    n, dim, k = KMEANS_SHAPE
    t0 = time.perf_counter()
    x, truth, _ = make_blobs(RngState(seed), n, dim, n_clusters=k,
                             cluster_std=1.0, device=device)
    data_s = _synced_seconds(device, t0)
    params = KMeansParams(n_clusters=k, seed=seed)

    # 1. the main path
    _reset(device)
    t0 = time.perf_counter()
    out = cluster.fit_predict(params, x)
    fit_s = _synced_seconds(device, t0)
    launches = dict(native.LAUNCHES)
    peak = (torch.cuda.max_memory_allocated() if device.type == "cuda"
            else None)
    # the first call pays CUDA's lazy loading of every kernel it meets
    t0 = time.perf_counter()
    cluster.fit_predict(params, x)
    warm_s = _synced_seconds(device, t0)
    # the fit again in its two stages, warm: the init from the same seed
    # (the fit's own first draw), then EM from those centroids
    t0 = time.perf_counter()
    c0 = cluster.init_plus_plus(RngState(seed), x, k,
                                params.oversampling_factor,
                                metric=params.metric)
    init_s = _synced_seconds(device, t0)
    t0 = time.perf_counter()
    again = cluster.fit(KMeansParams(n_clusters=k, init=InitMethod.Array,
                                     seed=seed), x, centroids=c0)
    em_s = _synced_seconds(device, t0)
    n_iter = int(out.n_iter)
    repeats = (torch.equal(again.centroids, out.centroids)
               and int(again.n_iter) == n_iter)
    ari = float(stats.adjusted_rand_index(truth, out.labels))
    emit({"phase": "kmeans", "config": "BASELINE.json configs[1]: "
          "raft::cluster::kmeans 100k x 128, k=1024", "n": n, "dim": dim,
          "n_clusters": k, "init": "k-means||", "max_iter": params.max_iter,
          "tol": params.tol, "seed": seed, "card": smi, "data_s": data_s,
          "fit_predict_s": fit_s, "fit_predict_warm_s": warm_s,
          "init_s": init_s, "em_s": em_s,
          "n_iter": n_iter, "em_iters_per_s": n_iter / em_s,
          "inertia": float(out.inertia), "ari_vs_make_blobs": ari,
          "array_init_fit_repeats_fit": repeats, "launches": launches,
          "peak_mem_bytes": peak})
    for name in ("fused_l2_nn", "fused_l2_nn_partials"):
        check(launches[name] > 0, f"kmeans main path never launched {name}")
    check(out.labels.shape == (n,) and out.centroids.shape == (k, dim)
          and bool(torch.isfinite(out.centroids).all())
          and math.isfinite(float(out.inertia)),
          "kmeans: labels (n,), finite centroids (k, d) and inertia")
    check(ari >= KMEANS_ARI_FLOOR, f"kmeans: ARI {ari} against make_blobs")
    check(repeats, "kmeans: a fit from init_plus_plus's centroids differs "
          "from fit_predict's")

    # 2. kernel path against plain path from the same init
    row, _, c_fit = kmeans_compare("kmeans_checks", device, x, c0,
                                   DistanceType.L2Expanded,
                                   KMEANS_CHECK_ITERS["l2"])
    ties, buf = kmeans_ties(device, x, k, int(params.oversampling_factor * k),
                            5, seed)
    emit({"phase": "kmeans_checks", "card": smi, **row, **ties})

    # 3. L1: B5 serves the E-step
    row, launches_l1, c_l1 = kmeans_compare("kmeans_l1", device, x, c0,
                                            DistanceType.L1,
                                            KMEANS_CHECK_ITERS["l1"])
    check(launches_l1["pairwise_accumulate"] > 0,
          "kmeans_l1 never launched pairwise_accumulate")
    emit({"phase": "kmeans_l1", "card": smi, **row})

    # 4. cosine runs no kernel; transform under L2 and L1
    row, launches_cos, _ = kmeans_compare("kmeans_cosine", device, x, c0,
                                          DistanceType.CosineExpanded,
                                          KMEANS_CHECK_ITERS["cosine"])
    check(not any(launches_cos.values()),
          f"kmeans_cosine launched a kernel: {launches_cos}")
    for metric, c in ((DistanceType.L2Expanded, c_fit),
                      (DistanceType.L1, c_l1)):
        p = KMeansParams(n_clusters=k, metric=metric)
        _reset(device)
        got = cluster.transform(p, x, c)
        b5 = native.LAUNCHES["pairwise_accumulate"]
        ref = cluster.transform(p, x, c, engine="torch")
        check(got.shape == (n, k) and torch.allclose(got, ref, rtol=1e-5,
                                                     atol=1e-5),
              f"transform {metric.name}: beyond rtol 1e-5, atol 1e-5 of "
              "the plain path")
        row[f"transform_{metric.name}"] = {
            "max_abs_err": float((got - ref).abs().max()),
            "pairwise_accumulate_launches": b5}
        del got, ref
    emit({"phase": "kmeans_cosine", "card": smi, **row})

    # 5. the silhouette of a subset of the fit's labels
    ns = min(10_000, n)
    xs, ls = x[:ns], out.labels[:ns]
    sil = {}
    for metric in (DistanceType.L2Expanded, DistanceType.L1):
        s = float(stats.silhouette_score_batched(xs, ls, k, metric))
        sp = float(stats.silhouette_score_batched(xs, ls, k, metric,
                                                  engine="torch"))
        # the seconds of a second, warm call of each
        t0 = time.perf_counter()
        stats.silhouette_score_batched(xs, ls, k, metric)
        s_t = _synced_seconds(device, t0)
        t0 = time.perf_counter()
        stats.silhouette_score_batched(xs, ls, k, metric, engine="torch")
        sp_t = _synced_seconds(device, t0)
        check(abs(s - sp) <= 1e-5, f"silhouette {metric.name}: {s} against "
              f"the plain path's {sp}")
        sil[metric.name] = {"score": s, "plain_score": sp, "s": s_t,
                            "plain_s": sp_t}
    emit({"phase": "silhouette", "rows": ns, "n_clusters": k,
          "batch_size": 4096, "card": smi, "by_metric": sil})

    rows = kmeans_kernel_rows(device, x, c_fit, buf, rep)
    return ({"kmeans": launches, "kmeans_l1": launches_l1}, rows,
            (x, params, c0))


#: the autotune phase: the IVF-PQ variants explored beside the live
#: n_probes, the closed-loop calls that fill the shadow ring first, and
#: the live Poisson traffic during the tune, as a fraction of the
#: closed-loop qps
TUNE_PROBES = (10, 40)
TUNE_FILL_CALLS = 8
TUNE_LIVE_RATE = 0.5
#: the forced rollback reports a live p99 of this many pre-promotion p99s
TUNE_ROLLBACK_X = 10.0


def _poisson_feed(eng, reqs, rate_qps, seed, stop):
    """A thread submitting *reqs* (cycling) as Poisson arrivals of
    *rate_qps* queries a second until *stop* is set; returns the thread
    and the (request index, future) list it fills."""
    subs = []
    mean_rows = float(np.mean([q.shape[0] for q in reqs]))
    gaps = np.random.default_rng(seed)

    def feed():
        t = time.perf_counter()
        j = 0
        while not stop.is_set():
            t += gaps.exponential(mean_rows / rate_qps)
            delay = t - time.perf_counter()
            if delay > 0 and stop.wait(delay):
                break
            subs.append((j % len(reqs), eng.submit(reqs[j % len(reqs)])))
            j += 1

    th = threading.Thread(target=feed, daemon=True)
    th.start()
    return th, subs


def _tuner_gauges(eng):
    from raft_tpu_torch import telemetry

    out = {}
    for key, name in (("qps", "raft_tpu_autotune_qps"),
                      ("p99_s", "raft_tpu_autotune_p99_seconds"),
                      ("worst_recall", "raft_tpu_autotune_recall")):
        for labels, v in telemetry.REGISTRY.get(name).items():
            if labels[0] == eng._engine_id:
                out.setdefault(labels[1], {})[key] = v
    return out


def autotune_phase(device, eng, index, x, reqs, calls, resident, truth, k,
                   seed, smi):
    """The autotuner on the resident IVF-PQ engine: ``warmup()``,
    closed-loop calls to fill the shadow ring, then ``AutoTuner(eng,
    param_variants=n_probes TUNE_PROBES)`` over the warmed ladder's caps
    with the default recall reference, ``run()`` while a feeder thread
    ``submit()``s Poisson traffic at ``TUNE_LIVE_RATE`` × the closed-loop
    qps, and a forced rollback (of the winner, else of a promoted cap
    candidate).  Checks: no live request failed or shed, each bit for bit
    the serve phase's result (or the solo search under promoted params),
    no kernel library built or loaded and no warmed signature added from
    ``warm_candidates()`` through the rollback, the baseline restored,
    and ``exact_reference`` on the first four requests giving the
    recall the ground truth gives.  Returns the launch counts."""
    import concurrent.futures

    import torch

    from raft_tpu_torch.kernels import native
    from raft_tpu_torch.neighbors import ivf_pq
    from raft_tpu_torch.serve import AutoTuner, Candidate, TunerConfig
    from raft_tpu_torch.serve.autotune import exact_reference

    _reset(device)
    eng.warmup()
    base_params, base_cap = eng._ctor["params"], eng.max_batch
    fill = calls[:TUNE_FILL_CALLS]
    t0 = time.perf_counter()
    for call in fill:
        eng.search(call)
    closed_qps = (sum(q.shape[0] for call in fill for q in call)
                  / (time.perf_counter() - t0))
    ring = len(eng.shadow_samples())
    sheds0 = eng.stats["sheds"]
    tuner = AutoTuner(eng, TunerConfig(seed=seed), param_variants=tuple(
        ivf_pq.SearchParams(n_probes=p) for p in TUNE_PROBES))
    names = [c.name for c in tuner.candidates()]
    t0 = time.perf_counter()
    n_sig = tuner.warm_candidates()
    frozen = (dict(native.BUILDS), eng.warmed_signatures())
    c0 = compiles()
    stop = threading.Event()
    feeder, subs = _poisson_feed(eng, reqs, TUNE_LIVE_RATE * closed_qps,
                                 seed, stop)
    try:
        report = tuner.run()
        tune_s = time.perf_counter() - t0
        promoted = next((c for c in tuner.candidates()
                         if c.name == report["winner"]), None)
        if promoted is None:   # no paired win: promote a cap to roll back
            cap = max(b for b in eng.warmed_buckets() if b != base_cap)
            promoted = Candidate(f"cap{cap}", max_batch=cap)
            tuner.promote(promoted)
        promoted_cap, promoted_params = eng.max_batch, eng._ctor["params"]
        pre_p99 = tuner._pre_p99
        rolled = tuner.maybe_rollback(
            live_p99_s=TUNE_ROLLBACK_X * pre_p99)
    finally:
        stop.set()
        feeder.join(STREAM_WAIT_S)
    check(not feeder.is_alive(), "autotune: the feeder hung")
    eng.flush()
    if device.type == "cuda":
        torch.cuda.synchronize()
    launches = dict(native.LAUNCHES)
    tuned = {}
    # explore, promote, rollback and the live traffic run warmed programs
    after_warmup(tuned, c0, "autotune")
    check(rolled, "autotune: the forced rollback did not roll back")
    check((dict(native.BUILDS), eng.warmed_signatures()) == frozen,
          "autotune: a kernel library was built or loaded, or a warmed "
          "signature added, between warm_candidates() and the rollback")
    check(eng._ctor["params"] is base_params and eng.max_batch == base_cap,
          "autotune: the rollback did not restore the baseline")
    check(eng.stats["sheds"] == sheds0, "autotune: a live request was shed")
    promoted_solo = {}
    for j, f in subs:
        try:
            d, i = f.result(timeout=STREAM_WAIT_S)
        except concurrent.futures.TimeoutError:
            check(False, "autotune: a live request never resolved")
        except Exception as e:
            check(False, f"autotune: a live request failed: {e!r}")
        if (np.array_equal(d, resident[j][0])
                and np.array_equal(i, resident[j][1])):
            continue
        check(promoted.params is not None,
              "autotune: a live result differs from the baseline's")
        if j not in promoted_solo:
            sd, si = ivf_pq.search(promoted.params, index, reqs[j], k)
            promoted_solo[j] = (sd.cpu().numpy(), si.cpu().numpy())
        check(np.array_equal(d, promoted_solo[j][0])
              and np.array_equal(i, promoted_solo[j][1]),
              "autotune: a live result is neither the baseline's nor the "
              "promoted config's solo search")
    for name in ("select_k", "lut_scan"):
        check(launches[name] > 0, f"autotune: {name} never launched")
    # the exact oracle against the ground truth, on the first 4 requests
    ref = exact_reference(x, k, device=device)
    t_np = truth.cpu().numpy()
    xd = x.double()
    hits_ref = hits_truth = tied = total = off = 0
    for j in range(4):
        q = reqs[j]
        live, got = resident[j][1], ref(q)
        want = t_np[off:off + q.shape[0]]
        off += q.shape[0]
        for row in range(q.shape[0]):
            a, b = set(got[row].tolist()), set(want[row].tolist())
            hits_ref += len(set(live[row].tolist()) & a)
            hits_truth += len(set(live[row].tolist()) & b)
            total += k
            if a != b:   # only where the k-th distance is tied
                qd = torch.as_tensor(q[row], device=device).double()
                dist = ((xd[sorted(a ^ b)] - qd) ** 2).sum(1)
                kth = ((xd[sorted(b)] - qd) ** 2).sum(1).max()
                check(bool(((dist - kth).abs() <= 1e-5 * kth).all()),
                      "autotune: exact_reference differs from the ground "
                      "truth outside near ties")
                tied += len(a - b)
    check(abs(hits_ref - hits_truth) <= tied,
          "autotune: exact_reference's recall is not the ground truth's")
    emit({"phase": "autotune", "path": "ivf_pq", "candidates": names,
          "ring": ring, "closed_loop_qps": closed_qps,
          "live_rate_qps": TUNE_LIVE_RATE * closed_qps,
          "warmed_signatures": n_sig, "tune_s": tune_s,
          "schedule": report["schedule"], "decisions": tuner.decisions,
          "winner": report["winner"], "promoted": promoted.name,
          "promoted_cap": promoted_cap,
          "promoted_n_probes": (promoted_params.n_probes
                                if promoted_params is not None else None),
          "pre_promotion_p99_s": pre_p99, "rolled_back": rolled,
          "scores": _tuner_gauges(eng), "live_requests": len(subs),
          "live_results_of_promoted_config": len(promoted_solo),
          "builds": dict(native.BUILDS),
          "recall_exact_reference": hits_ref / total,
          "recall_ground_truth": hits_truth / total,
          "launches": launches, **tuned, "card": smi})
    return launches


#: the ball-cover phase: RBC's own domain, as cuML's
#: NearestNeighbors(algorithm="rbc") serves it (2-3 features)
BC_POINTS = 1_000_000
BC_QUERIES = 10_000
BC_K = 10
BC_ALL_K = 8
#: points of the all-kNN query: the whole L2 set (18.1 s on an H100,
#: ``tools/ball_cover_probe.py``; the 200,000-point cut it was allowed
#: above 60 s is not needed)
BC_ALL_POINTS = 1_000_000
BC_EPS_QUERIES = 1_000
#: queries per block of the brute-force checkers
ORACLE_ROWS = 1024


def _oracle_topk(q, x, k, dist_fn, rows=ORACLE_ROWS):
    """The k smallest distances of *dist_fn* (sorted) and their ids, per
    row of *q*, in blocks of *rows* queries."""
    import torch

    out_d, out_i = [], []
    for r in range(0, q.shape[0], rows):
        v, i = torch.topk(dist_fn(q[r:r + rows], x), k, dim=1,
                          largest=False)
        out_d.append(v)
        out_i.append(i)
    return torch.cat(out_d), torch.cat(out_i)


def _l2_direct(a, b, dtype=None, squared=False):
    """‖a_i − b_j‖ summed column by column in *dtype* (default float64):
    the checker of the low-dimensional paths (``torch.cdist`` without
    its product form runs one reduction per output, ~1e9 outputs a
    second, which 1M × 1M pairs cannot afford)."""
    import torch

    dtype = dtype or torch.float64
    a, b = a.to(dtype), b.to(dtype)
    d = (a[:, None, 0] - b[None, :, 0]) ** 2
    for c in range(1, a.shape[1]):
        d += (a[:, None, c] - b[None, :, c]) ** 2
    return d if squared else d.sqrt_()


def _haversine64(a, b):
    import torch

    a, b = a.double(), b.double()
    h = (torch.sin((a[:, None, 0] - b[None, :, 0]) / 2) ** 2
         + torch.cos(a[:, None, 0]) * torch.cos(b[None, :, 0])
         * torch.sin((a[:, None, 1] - b[None, :, 1]) / 2) ** 2)
    return 2.0 * torch.arcsin(torch.sqrt(torch.clamp(h, 0.0, 1.0)))


def ball_cover_phase(device, n_lists, seed, smi):
    """Random ball cover over 1,000,000 clustered 3-d points (the
    mixture's recipe in 3 dimensions) and 1,000,000 clustered (lat, lon)
    points: ``build_index`` (√n landmarks), ``knn_query`` of 10,000
    queries at k = 10 under L2SqrtExpanded and Haversine,
    ``all_knn_query`` (k = 8) over the first ``BC_ALL_POINTS`` L2 points
    and ``eps_nn`` of 1,000 queries; each against a brute-force checker
    on the card (ids equal except at near ties, adjacency except within
    1e-5 of ε), with the queries the certificate sent to a second pass
    and the landmarks it scanned, B2's launches and the seconds.  Each
    result prints as it comes.  Returns the launch counts."""
    import torch

    from raft_tpu_torch.distance.distance_types import DistanceType
    from raft_tpu_torch.kernels import native
    from raft_tpu_torch.neighbors import ball_cover as bc

    _reset(device)
    gen = torch.Generator(device=device).manual_seed(seed + 11)
    comps = torch.randn(4 * n_lists, 3, generator=gen, device=device)
    x = mixture(gen, BC_POINTS, 3, comps, 0.7, device)
    q = mixture(gen, BC_QUERIES, 3, comps, 0.7, device)
    centres = torch.stack([
        (torch.rand(4 * n_lists, generator=gen, device=device) * 2 - 1)
        * 1.4,
        (torch.rand(4 * n_lists, generator=gen, device=device) * 2 - 1)
        * math.pi], 1)
    h = mixture(gen, BC_POINTS, 2, centres, 0.02, device)
    hq = mixture(gen, BC_QUERIES, 2, centres, 0.02, device)
    # (first pass of its batch, width, queries, landmarks scanned) a pass
    scans = []
    scan_landmarks, query_batch = bc._scan_landmarks, bc._query_batch
    first_of_batch = [False]

    def marked_batch(*a, **kw):
        first_of_batch[0] = True
        return query_batch(*a, **kw)

    def counting(index, qb, probe_ids, kk, engine=None):
        scans.append((first_of_batch[0], int(probe_ids.shape[1]),
                      int(qb.shape[0]),
                      int((probe_ids < index.n_landmarks).sum())))
        first_of_batch[0] = False
        return scan_landmarks(index, qb, probe_ids, kk, engine)

    def run_knn(name, index, queries, kk, fn):
        scans.clear()
        b2 = native.LAUNCHES["select_k"]
        t0 = time.perf_counter()
        d, i = fn()
        secs = _synced_seconds(device, t0)
        second = [s for s in scans if not s[0]]
        return d, i, {"query": name, "queries": int(queries.shape[0]),
                      "k": kk, "seconds": secs,
                      "qps": queries.shape[0] / secs,
                      "initial_probes": scans[0][1],
                      "second_pass_queries": sum(s[2] for s in second),
                      "second_pass_landmarks_mean": (
                          sum(s[3] for s in second)
                          / max(1, sum(s[2] for s in second))),
                      "b2_launches": native.LAUNCHES["select_k"] - b2}

    def add(row):
        emit({"phase": "ball_cover", **row, "card": smi})

    bc._scan_landmarks, bc._query_batch = counting, marked_batch
    try:
        indexes = {}
        for name, pts, qs, metric, dist_fn in (
                ("l2", x, q, DistanceType.L2SqrtExpanded, _l2_direct),
                ("haversine", h, hq, DistanceType.Haversine,
                 _haversine64)):
            t0 = time.perf_counter()
            index = bc.build_index(pts, metric, seed=seed)
            build_s = _synced_seconds(device, t0)
            indexes[name] = index
            d, i, row = run_knn(name, index, qs, BC_K, lambda: bc.knn_query(
                index, qs, BC_K))
            ref_d, ref_i = _oracle_topk(qs, pts, BC_K + 1, dist_fn,
                                        ORACLE_ROWS // 4)
            row["id_diffs_at_near_ties"] = check_knn(
                f"ball_cover {name} knn_query", d, i, ref_d[:, :BC_K],
                ref_i[:, :BC_K], ref_d)
            row.update(build_s=build_s, n_landmarks=index.n_landmarks,
                       capacity=index.capacity,
                       physical_rows=int(index.list_data.shape[0]))
            add(row)
        pts = x[:BC_ALL_POINTS]
        index = (indexes["l2"] if BC_ALL_POINTS >= BC_POINTS
                 else bc.build_index(pts, seed=seed))
        d, i, row = run_knn("all_knn", index, pts, BC_ALL_K,
                            lambda: bc.all_knn_query(index, BC_ALL_K))
        # float32 squared distances: 1M × 1M pairs in ~1,000 blocks
        t0 = time.perf_counter()
        ref_d, ref_i = _oracle_topk(
            pts, pts, BC_ALL_K + 1,
            lambda a, b: _l2_direct(a, b, torch.float32, squared=True))
        ref_d = ref_d.sqrt_()
        row["checker_s"] = _synced_seconds(device, t0)
        row["id_diffs_at_near_ties"] = check_knn(
            "ball_cover all_knn_query", d, i, ref_d[:, :BC_ALL_K],
            ref_i[:, :BC_ALL_K], ref_d)
        check(bool((i[:, 0].long() == torch.arange(
            pts.shape[0], device=device)).float().mean() > 0.999),
              "ball_cover all_knn_query: points are not their own nearest")
        row["points"] = int(pts.shape[0])
        add(row)
        del ref_d, ref_i, d, i
        # eps_nn: ε the median 10-NN distance of the L2 queries
        eq = q[:BC_EPS_QUERIES]
        d10, _ = bc.knn_query(indexes["l2"], eq, BC_K)
        eps = float(d10[:, -1].median())
        t0 = time.perf_counter()
        adj, vd = bc.eps_nn(indexes["l2"], eq, eps)
        eps_s = _synced_seconds(device, t0)
        edge_pairs = 0
        for r in range(0, eq.shape[0], 256):
            ref = _l2_direct(eq[r:r + 256], x)
            edge = (ref - eps).abs() <= 1e-5
            edge_pairs += int(edge.sum())
            check(not bool(((adj[r:r + 256] != (ref <= eps)) & ~edge).any()),
                  "ball_cover eps_nn: adjacency differs from torch.cdist "
                  "away from ε")
        check(bool((vd == adj.sum(1)).all()),
              "ball_cover eps_nn: degrees are not the adjacency's row sums")
        add({"query": "eps_nn", "queries": int(eq.shape[0]), "eps": eps,
             "seconds": eps_s, "adjacency_bytes": adj.numel(),
             "mean_degree": float(vd.float().mean()),
             "pairs_within_1e-5_of_eps": edge_pairs})
        del adj, vd
    finally:
        bc._scan_landmarks, bc._query_batch = scan_landmarks, query_batch
    launches = dict(native.LAUNCHES)
    check(launches["select_k"] > 0, "ball_cover: B2 never launched")
    emit({"phase": "ball_cover_launches", "points": BC_POINTS,
          "all_knn_points": BC_ALL_POINTS, "launches": launches,
          "card": smi})
    return launches


#: the eps phase: one row batch of the kind cuML's DBSCAN computes
EPS_ROWS = 4096


def eps_phase(device, x, queries, qr, truth, smi):
    """``eps_neighbors_l2sq`` of ``EPS_ROWS`` queries against the whole
    dataset in one batch (``batch_size`` 8,192), ε the median squared
    10-NN distance of the recall queries; checked against a blocked
    ``torch.cdist`` (except pairs within 1e-5 × ε of ε) and the degrees
    against the adjacency's row sums.  Returns the launch counts."""
    import torch

    from raft_tpu_torch.kernels import native
    from raft_tpu_torch.neighbors import eps_neighbors_l2sq

    if device.type == "cuda":
        torch.cuda.empty_cache()
    _reset(device)
    rows = queries[:EPS_ROWS]
    eps = float(((qr - x[truth[:, -1]]) ** 2).sum(1).median())
    t0 = time.perf_counter()
    adj, vd = eps_neighbors_l2sq(rows, x, eps)
    secs = _synced_seconds(device, t0)
    launches = dict(native.LAUNCHES)
    peak = (torch.cuda.max_memory_allocated() if device.type == "cuda"
            else None)
    edge_pairs = 0
    for r in range(0, rows.shape[0], 256):
        ref = torch.cdist(rows[r:r + 256], x,
                          compute_mode="donot_use_mm_for_euclid_dist") ** 2
        edge = (ref - eps).abs() <= 1e-5 * eps
        edge_pairs += int(edge.sum())
        check(not bool(((adj[r:r + 256] != (ref <= eps)) & ~edge).any()),
              "eps: adjacency differs from torch.cdist away from ε")
    check(bool((vd == adj.sum(1)).all()),
          "eps: degrees are not the adjacency's row sums")
    emit({"phase": "eps", "rows": int(rows.shape[0]), "n": int(x.shape[0]),
          "dim": int(x.shape[1]), "eps": eps, "seconds": secs,
          "pairs_per_s": rows.shape[0] * x.shape[0] / secs,
          "adjacency_bytes": adj.numel(),
          "mean_degree": float(vd.float().mean()),
          "pairs_within_1e-5_eps": edge_pairs, "peak_mem_bytes": peak,
          "launches": launches, "card": smi})
    del adj, vd
    return launches

# ---------------------------------------------------------------------------
# the distributed layer: world 1 over NCCL in this process, world 2 over
# gloo in two worker processes on the one card (NCCL takes one rank per
# device)

#: world 2's k-means and its world-1 twin: tol 0 and this many EM steps
#: (``loop="host"`` reads no δ², so exactly this many)
MNMG_W2_ITERS = 20
#: how far world 2's k-means may lie from world 1's: its centroids (rtol,
#: atol), its labels (ARI at least) and its inertia (relative)
MNMG_W2_RTOL = MNMG_W2_ATOL = 1e-5
MNMG_W2_ARI = 0.999
MNMG_W2_INERTIA_RTOL = 1e-5
#: the longest the two workers may take together, their start included
MNMG_W2_TIMEOUT_S = 420
#: every this-many-th row of a dataset is the witness that a worker made
#: the same data as the smoke's process
WITNESS_STEP = 9973


def _witness(t):
    return t[::WITNESS_STEP].cpu().numpy()


def _calls(comms, name):
    return (comms.collective_calls[name],
            comms.collective_calls[f"{name}_bytes"])


def _delta(after, before):
    return tuple(a - b for a, b in zip(after, before))


def mnmg_phase(device, seed, km, x, queries, k, smi):
    """The ``mnmg`` line: a world of one over NCCL in this process (a
    ``FileStore`` in a temporary directory, destroyed at the end): every
    ``self_tests`` check; MNMG k-means at configs[1] from the k-means
    path's init through the three loops, each bit for bit
    ``kmeans.fit(InitMethod.Array)`` with ``n_iter`` + 1 allreduces (fori:
    ``max_iter`` + 1) of (k·d + k + 1)·4 bytes (the last of 4), and
    ``predict`` bit for bit; ``knn_mnmg`` over the 1M dataset under L2
    and L1 with both partitions, bit for bit ``brute_force.knn`` with one
    allgather each; ``telemetry.gather`` the local snapshot.  Returns
    (k-means launches, kNN launches, world 1's results for ``mnmg_w2``)."""
    import shutil
    import tempfile

    import torch

    from raft_tpu_torch import cluster, telemetry
    from raft_tpu_torch.cluster import InitMethod, KMeansParams, kmeans_mnmg
    from raft_tpu_torch.comms import CommsSession, self_tests
    from raft_tpu_torch.core.buckets import bucket_dim
    from raft_tpu_torch.distance import DistanceType
    from raft_tpu_torch.kernels import native
    from raft_tpu_torch.neighbors import brute_force
    from raft_tpu_torch.neighbors.knn_mnmg import knn_mnmg

    t_phase = time.perf_counter()
    kx, kc0 = km
    nk, dim = kc0.shape
    nq = queries.shape[0]
    row = {"phase": "mnmg", "world": 1, "card": smi}
    store = tempfile.mkdtemp(prefix="raft_smoke_store_")
    session = CommsSession(multihost=dict(
        init_method=f"file://{store}/store", world_size=1, rank=0),
        device=device).init()
    try:
        comms = session.comms
        row["backend"] = comms.backend
        want = "nccl" if device.type == "cuda" else "gloo"
        check(comms.backend == want, f"mnmg: backend {comms.backend}")
        row["self_tests"] = self_tests.run_all(comms)
        check(all(row["self_tests"].values()),
              f"mnmg self_tests: {row['self_tests']}")

        # k-means: the three loops, then predict, counted from 0
        params = KMeansParams(n_clusters=nk, init=InitMethod.Array,
                              seed=seed)
        packed = (nk * dim + nk + 1) * 4
        # one step first: the communicator's first 528 KB allreduce
        kmeans_mnmg.fit(KMeansParams(n_clusters=nk, init=InitMethod.Array,
                                     max_iter=1), comms, kx, centroids=kc0)
        _reset(device)
        fits = {}
        for loop in ("device", "fori", "host"):
            before = _calls(comms, "allreduce")
            t0 = time.perf_counter()
            # host: δ² read every step, so it stops where kmeans.fit does
            out = kmeans_mnmg.fit(params, comms, kx, centroids=kc0,
                                  loop=loop, sync_every=1)
            fits[loop] = (out, _synced_seconds(device, t0),
                          _delta(_calls(comms, "allreduce"), before))
        labels, _ = kmeans_mnmg.predict(params, comms, kx,
                                        fits["device"][0].centroids)
        launches_km = dict(native.LAUNCHES)
        for name in ("fused_l2_nn", "fused_l2_nn_partials"):
            check(launches_km[name] > 0, f"mnmg k-means never launched {name}")
        t0 = time.perf_counter()
        ref = cluster.fit(params, kx, centroids=kc0)
        ref_s = _synced_seconds(device, t0)
        ref_labels, _ = cluster.predict(params, kx, ref.centroids)
        n_ref = int(ref.n_iter)
        by_loop = {}
        for loop, (out, secs, (calls, nbytes)) in fits.items():
            steps = params.max_iter if loop == "fori" else n_ref
            same = (torch.equal(out.centroids, ref.centroids)
                    and int(out.n_iter) == n_ref)
            by_loop[loop] = {"s": secs, "n_iter": int(out.n_iter),
                             "inertia": float(out.inertia),
                             "allreduces": calls, "allreduce_bytes": nbytes,
                             "equals_kmeans_fit": same}
            check(same, f"mnmg k-means loop={loop}: centroids or n_iter "
                  "differ from kmeans.fit")
            check((calls, nbytes) == (steps + 1, steps * packed + 4),
                  f"mnmg k-means loop={loop}: {calls} allreduces of "
                  f"{nbytes} bytes, want {steps + 1} of {steps * packed + 4}")
        same_labels = torch.equal(labels, ref_labels)
        check(same_labels, "mnmg predict labels differ from kmeans.predict")
        row["kmeans"] = {
            "config": "BASELINE.json configs[1], from the k-means path's "
            "init", "n": kx.shape[0], "dim": dim, "n_clusters": nk,
            "max_iter": params.max_iter, "tol": params.tol,
            "kmeans_fit_s": ref_s, "n_iter": n_ref, "by_loop": by_loop,
            "allreduce_payload_bytes": packed,
            "predict_equals_kmeans_predict": same_labels,
            "launches": launches_km}
        # world 2's twin: tol 0, exactly MNMG_W2_ITERS steps
        p20 = KMeansParams(n_clusters=nk, init=InitMethod.Array,
                           max_iter=MNMG_W2_ITERS, tol=0.0)
        t0 = time.perf_counter()
        w1 = kmeans_mnmg.fit(p20, comms, kx, centroids=kc0, loop="host")
        w1_s = _synced_seconds(device, t0)
        w1_labels, _ = kmeans_mnmg.predict(p20, comms, kx, w1.centroids)
        row["kmeans"][f"tol0_{MNMG_W2_ITERS}_steps_s"] = w1_s

        # kNN over the 1M dataset, both partitions, counted from 0
        metrics = {"l2": DistanceType.L2SqrtExpanded, "l1": DistanceType.L1}
        # a batch of each metric first: the first products and launches
        # of a shape pay for their loading
        for metric in metrics.values():
            knn_mnmg(comms, x, queries[:1024], k, metric, device=device)
        _reset(device)
        got = {}
        for mname, metric in metrics.items():
            for part in ("index", "queries"):
                before = _calls(comms, "allgather")
                t0 = time.perf_counter()
                d, i = knn_mnmg(comms, x, queries, k, metric, partition=part,
                                device=device)
                got[mname, part] = (d, i, _synced_seconds(device, t0),
                                    _delta(_calls(comms, "allgather"),
                                           before))
        launches_knn = dict(native.LAUNCHES)
        for name in ("select_k", "pairwise_accumulate"):
            check(launches_knn[name] > 0, f"mnmg kNN never launched {name}")
        knn_rows = {}
        for mname, metric in metrics.items():
            t0 = time.perf_counter()
            rd, ri = brute_force.knn(x, queries, k, metric, device=device)
            ref_s = _synced_seconds(device, t0)
            for part in ("index", "queries"):
                d, i, secs, (calls, nbytes) = got[mname, part]
                per = nq if part == "index" else bucket_dim(nq)
                same = torch.equal(d, rd) and torch.equal(i, ri)
                knn_rows[f"{mname}_{part}"] = {
                    "s": secs, "qps": nq / secs, "knn_s": ref_s,
                    "knn_qps": nq / ref_s, "allgathers": calls,
                    "allgather_bytes": nbytes, "equals_knn": same}
                check(same, f"mnmg kNN {mname} partition={part}: differs "
                      "from brute_force.knn")
                check((calls, nbytes) == (1, per * 2 * k * 4),
                      f"mnmg kNN {mname} partition={part}: {calls} "
                      f"allgathers of {nbytes} bytes")
        row["knn"] = {"n": x.shape[0], "queries": nq, "k": k,
                      "by_case": knn_rows, "launches": launches_knn}
        fleet = telemetry.gather(comms)
        local = (fleet["world"] == 1 and list(fleet["hosts"]) == ["0"]
                 and fleet["rollup"] == telemetry.merge(
                     [fleet["hosts"]["0"]]) and not fleet["partial"])
        row["gather_is_local_snapshot"] = local
        check(local, "mnmg: gather at world 1 is not the local snapshot")
        row["collective_calls"] = dict(comms.collective_calls)
        world1 = {"kmeans": (w1.centroids, w1_labels, float(w1.inertia),
                             w1_s),
                  "knn": {m: got[m, "index"][:3] for m in metrics},
                  "tie_l2": brute_force.knn(x, queries, k + 1,
                                            metrics["l2"], device=device)[0]}
    finally:
        session.destroy()
        shutil.rmtree(store, ignore_errors=True)
    row["phase_s"] = time.perf_counter() - t_phase
    emit(row)
    return launches_km, launches_knn, world1


def _w2_worker(comms, p):
    """One rank of ``mnmg_w2``: half the rows of the k-means data and of
    the 1M dataset, made the smoke's way from its seed."""
    import torch

    from raft_tpu_torch import telemetry
    from raft_tpu_torch.cluster import InitMethod, KMeansParams, kmeans_mnmg
    from raft_tpu_torch.distance import DistanceType
    from raft_tpu_torch.kernels import native
    from raft_tpu_torch.neighbors.knn_mnmg import knn_mnmg
    from raft_tpu_torch.random import RngState, make_blobs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = comms.device
    n, dim, nk = p["km_shape"]
    kx, _, _ = make_blobs(RngState(p["seed"]), n, dim, n_clusters=nk,
                          cluster_std=1.0, device=device)
    check(np.array_equal(_witness(kx), p["km_rows"]),
          "mnmg_w2 worker: its k-means data differ from the smoke's")
    c0 = torch.as_tensor(p["c0"], device=device)
    params = KMeansParams(n_clusters=nk, init=InitMethod.Array,
                          max_iter=p["iters"], tol=0.0)
    # one step first: this process's first launches load the kernels
    kmeans_mnmg.fit(KMeansParams(n_clusters=nk, init=InitMethod.Array,
                                 max_iter=1, tol=0.0),
                    comms, kx, centroids=c0, loop="host")
    _reset(device)
    comms.barrier()
    t0 = time.perf_counter()
    fit = kmeans_mnmg.fit(params, comms, kx, centroids=c0, loop="host")
    fit_s = _synced_seconds(device, t0)
    labels, _ = kmeans_mnmg.predict(params, comms, kx, fit.centroids)
    out = {"kmeans": {"centroids": fit.centroids.cpu().numpy(),
                      "labels": labels.cpu().numpy(),
                      "inertia": float(fit.inertia),
                      "n_iter": int(fit.n_iter), "s": fit_s,
                      "launches": dict(native.LAUNCHES)}}
    del kx
    d = p["data"]
    gen = torch.Generator(device=device).manual_seed(p["seed"])
    comps = torch.randn(4 * d["n_lists"], d["dim"], generator=gen,
                        device=device)
    x = mixture(gen, d["n"], d["dim"], comps, 0.7, device)
    queries = mixture(gen, d["n_queries"], d["dim"], comps, 0.7, device)
    check(np.array_equal(_witness(x), p["x_rows"])
          and np.array_equal(_witness(queries), p["q_rows"]),
          "mnmg_w2 worker: its 1M dataset differs from the smoke's")
    metrics = {"l2": DistanceType.L2SqrtExpanded, "l1": DistanceType.L1}
    for metric in metrics.values():
        knn_mnmg(comms, x, queries[:1024], p["k"], metric, device=device)
    _reset(device)
    out["knn"] = {}
    for mname, metric in metrics.items():
        comms.barrier()
        t0 = time.perf_counter()
        dd, ii = knn_mnmg(comms, x, queries, p["k"], metric, device=device)
        out["knn"][mname] = (dd.cpu().numpy(), ii.cpu().numpy(),
                             _synced_seconds(device, t0))
    out["knn_launches"] = dict(native.LAUNCHES)
    fleet = telemetry.gather(comms, timeout=60.0)
    out["gather"] = {"world": fleet["world"],
                     "hosts": sorted(fleet["hosts"]),
                     "partial": fleet["partial"],
                     "missing_ranks": fleet["missing_ranks"]}
    out["collective_calls"] = dict(comms.collective_calls)
    return out


def mnmg_w2_phase(device, seed, km, x, queries, n_lists, k, world1, smi):
    """The ``mnmg_w2`` line: two worker processes on the one card over
    gloo (``raft_tpu_torch.testing.world``), each holding half the rows,
    with a mailbox server in this process for the host plane.  k-means
    (tol 0, ``MNMG_W2_ITERS`` steps) against world 1's: centroids, ARI of
    the labels, inertia; ``knn_mnmg`` (index partition) under L1 bit for
    bit and under L2 ids equal except at near ties, distances to rtol
    1e-5; ``telemetry.gather`` holding both hosts; the seconds and the
    collectives staged through the host.  A worker that fails or hangs
    raises here, and the smoke exits non-zero.  Returns (k-means
    launches, kNN launches), summed over both workers."""
    import tempfile

    import torch

    from raft_tpu_torch import stats
    from raft_tpu_torch.comms.hostcomm import MailboxServer
    from raft_tpu_torch.testing.world import run_world

    t_phase = time.perf_counter()
    kx, kc0 = km
    payload = {"seed": seed, "km_shape": KMEANS_SHAPE,
               "c0": kc0.cpu().numpy(), "km_rows": _witness(kx),
               "data": {"n": x.shape[0], "n_queries": queries.shape[0],
                        "dim": x.shape[1], "n_lists": n_lists},
               "x_rows": _witness(x), "q_rows": _witness(queries),
               "k": k, "iters": MNMG_W2_ITERS}
    parent_memory = _free_for_workers(device)
    with tempfile.TemporaryDirectory(prefix="raft_smoke_w2_") as tmp, \
            MailboxServer() as server:
        t0 = time.perf_counter()
        outs = run_world("chip_smoke:_w2_worker", 2, payload, workdir=tmp,
                         backend="gloo", device=device.type, threads=4,
                         timeout=MNMG_W2_TIMEOUT_S,
                         coordinator="%s:%d" % server.address)
        wall = time.perf_counter() - t0
    row = {"phase": "mnmg_w2", "world": 2, "backend": "gloo",
           "workers_wall_s": wall, "parent_memory": parent_memory,
           "card": smi}
    r0, r1 = outs
    for key in ("centroids", "labels"):
        check(np.array_equal(r0["kmeans"][key], r1["kmeans"][key]),
              f"mnmg_w2: the ranks' k-means {key} differ")
    c1, labels1, inertia1, w1_s = world1["kmeans"]
    c2 = torch.as_tensor(r0["kmeans"]["centroids"], device=device)
    labels2 = torch.as_tensor(r0["kmeans"]["labels"], device=device)
    ari = float(stats.adjusted_rand_index(labels1, labels2))
    gap = abs(r0["kmeans"]["inertia"] - inertia1) / abs(inertia1)
    close = bool(torch.allclose(c2, c1, rtol=MNMG_W2_RTOL,
                                atol=MNMG_W2_ATOL))
    row["kmeans"] = {
        "iters": MNMG_W2_ITERS, "n_iter": r0["kmeans"]["n_iter"],
        "s_by_rank": [o["kmeans"]["s"] for o in outs], "world1_s": w1_s,
        "centroids_max_abs_err": float((c2 - c1).abs().max()),
        "centroids_within_tol": close, "ari_vs_world1": ari,
        "inertia": r0["kmeans"]["inertia"], "world1_inertia": inertia1,
        "inertia_rel_gap": gap}
    check(close, f"mnmg_w2 k-means: centroids beyond rtol {MNMG_W2_RTOL}, "
          f"atol {MNMG_W2_ATOL} of world 1's")
    check(ari >= MNMG_W2_ARI, f"mnmg_w2 k-means: ARI {ari} against world 1")
    check(gap <= MNMG_W2_INERTIA_RTOL,
          f"mnmg_w2 k-means: inertia {gap} relative from world 1's")
    knn_rows = {}
    for mname in ("l2", "l1"):
        d1, i1, s1 = world1["knn"][mname]
        for o in outs[1:]:
            check(all(np.array_equal(a, b) for a, b in zip(
                o["knn"][mname][:2], r0["knn"][mname][:2])),
                f"mnmg_w2 kNN {mname}: the ranks' results differ")
        d2 = torch.as_tensor(r0["knn"][mname][0], device=device)
        i2 = torch.as_tensor(r0["knn"][mname][1], device=device)
        nq = d2.shape[0]
        secs = max(o["knn"][mname][2] for o in outs)
        rowm = {"s": secs, "qps": nq / secs, "world1_s": s1,
                "world1_qps": nq / s1,
                "equals_world1": bool(torch.equal(d2, d1)
                                      and torch.equal(i2, i1))}
        if mname == "l1":
            check(rowm["equals_world1"],
                  "mnmg_w2 kNN l1: differs from world 1 (B5 sums every "
                  "pair in one fixed order)")
        else:
            rowm["id_diffs_at_near_ties"] = check_knn(
                "mnmg_w2 kNN l2 vs world 1", d2, i2, d1, i1,
                world1["tie_l2"])
        knn_rows[mname] = rowm
    row["knn"] = {"partition": "index", "by_metric": knn_rows}
    for o in outs:
        check(o["gather"] == {"world": 2, "hosts": ["0", "1"],
                              "partial": False, "missing_ranks": []},
              f"mnmg_w2 gather: {o['gather']}")
    row["gather_hosts"] = r0["gather"]["hosts"]
    calls = r0["collective_calls"]
    row["collective_calls_rank0"] = calls
    row["host_staged"] = {key[:-len("_host_staged")]: v
                          for key, v in calls.items()
                          if key.endswith("_host_staged")}
    launches_km = {name: sum(o["kmeans"]["launches"][name] for o in outs)
                   for name in r0["kmeans"]["launches"]}
    launches_knn = {name: sum(o["knn_launches"][name] for o in outs)
                    for name in r0["knn_launches"]}
    for name in ("fused_l2_nn", "fused_l2_nn_partials"):
        check(launches_km[name] > 0, f"mnmg_w2 k-means never launched {name}")
    for name in ("select_k", "pairwise_accumulate"):
        check(launches_knn[name] > 0, f"mnmg_w2 kNN never launched {name}")
    row["launches"] = {"kmeans": launches_km, "knn": launches_knn}
    row["phase_s"] = time.perf_counter() - t_phase
    emit(row)
    return launches_km, launches_knn


#: the types the serve_dtypes phase warms and serves
SERVE_DTYPES = ("float32", "bfloat16", "float16")
#: the sharded phase's open-loop rate, a fraction of its closed-loop qps
SHARDED_STREAM_RATE = 0.5
#: the bound on each distributed serving world (start, data, builds,
#: serving): a failed or hung worker fails the smoke
SERVE_W2_TIMEOUT_S = 600
#: the replica phase's live traffic under the shadow-lane tune, as a
#: fraction of its closed-loop qps
REPLICA_TUNE_RATE = 0.5


def serve_dtypes_phase(device, engines, q_host, n_queries, smi):
    """The ``serve_dtypes`` line: the brute-force L1 and IVF-Flat engines
    (*engines*: path → (engine, solo search)) warmed in float32, bfloat16
    and float16, then the ragged closed-loop calls over every query in
    each type, sent as host tensors of that type: every request bit for
    bit its solo search in its own type, no signature added after the
    warm-up and no kernel library built or loaded; qps by type.  Launch
    counts are those of the engines' warm-ups and passes only (the solo
    searches they are checked against run outside the counted spans);
    returns them."""
    import torch

    from raft_tpu_torch.kernels import native
    from raft_tpu_torch.serve.engine import DTYPES

    _reset(device)
    counted = _PathLaunches()
    builds0 = dict(native.BUILDS)
    row = {"phase": "serve_dtypes", "card": smi, "queries": n_queries,
           "types": list(SERVE_DTYPES)}
    for path, (eng, solo) in engines.items():
        t0 = time.perf_counter()
        with counted.span():
            n_warm = eng.warmup(dtypes=SERVE_DTYPES)
        warm_s = time.perf_counter() - t0
        sigs = eng.warmed_signatures()
        typed = {name: ragged_calls(
            torch.from_numpy(q_host).to(DTYPES[name]), n_queries)
            for name in SERVE_DTYPES}
        qps = {name: [] for name in SERVE_DTYPES}
        passes_compiles = 0
        # the types in turns, forward then back: each type's qps is the
        # mean of its two passes
        for order in (SERVE_DTYPES, SERVE_DTYPES[::-1]):
            for name in order:
                reqs, calls = typed[name]
                c0 = compiles()
                with counted.span():
                    results, _, serve_s = _closed_loop(eng, calls,
                                                       warm=False)
                passes_compiles += compiles() - c0
                qps[name].append(n_queries / serve_s)
                if len(qps[name]) > 1:
                    continue
                for q, out in zip(reqs, results):
                    sd, si = solo(q)
                    check(np.array_equal(out[0], sd.cpu().numpy())
                          and np.array_equal(out[1], si.cpu().numpy()),
                          f"serve_dtypes {path} {name}: coalesced results "
                          "differ from the solo search in their type")
        by_type = {name: {"qps": float(np.mean(v)), "qps_passes": v}
                   for name, v in qps.items()}
        check(eng.warmed_signatures() == sigs,
              f"serve_dtypes {path}: serving added a signature")
        row[path] = {"warmup_signatures": n_warm, "warmup_s": warm_s,
                     "signatures": sigs, "by_type": by_type,
                     "qps_vs_float32": {
                         name: by_type[name]["qps"]
                         / by_type["float32"]["qps"]
                         for name in SERVE_DTYPES},
                     "coalesced_equals_solo": True}
        after_warmup(row[path], 0, f"serve_dtypes {path}", passes_compiles)
    check(dict(native.BUILDS) == builds0,
          "serve_dtypes: a kernel library was built or loaded while serving")
    launches = counted.total
    row["launches"] = launches
    emit(row)
    for name in PATH_KERNELS["serve_dtypes"]:
        check(launches[name] > 0, f"serve_dtypes never launched {name}")
    return launches


def _results_arrays(results):
    return (np.concatenate([r[0] for r in results]),
            np.concatenate([r[1] for r in results]))


def _exact_ties_only(what, got, want):
    """Distances bit for bit; ids equal except where the distance is tied
    exactly with a neighbour in its row.  Returns the count of ids that
    differ at such ties."""
    gd, gi = got
    wd, wi = want
    check(np.array_equal(gd, wd), f"{what}: distances differ")
    diff = gi != wi
    tied = np.zeros_like(diff)
    tied[:, 1:] |= wd[:, 1:] == wd[:, :-1]
    tied[:, :-1] |= wd[:, :-1] == wd[:, 1:]
    check(not (diff & ~tied).any(),
          f"{what}: ids differ away from exact distance ties")
    return int(diff.sum())


def _closed_loop(eng, calls, warm: bool = True):
    """Every call through *eng* (after its warm-up, with *warm*):
    (results, warm-up seconds, serve seconds)."""
    t0 = time.perf_counter()
    if warm:
        eng.warmup()
    warm_s = time.perf_counter() - t0
    results = []
    t0 = time.perf_counter()
    for call in calls:
        results.extend(eng.search(call))
    serve_s = time.perf_counter() - t0
    for out in results:
        check(isinstance(out, tuple), f"a request failed: {out!r}")
    return results, warm_s, serve_s


def _index_equal(a, b) -> bool:
    import torch

    return (a.kind == b.kind and a.aux == b.aux
            and all(torch.equal(u, v) for u, v in
                    zip(a.stacked + a.replicated, b.stacked + b.replicated)))


def sharded_phase(device, x, q_host, reqs, calls, n_queries, n_lists,
                  n_probes, k, resident, smi, profile: bool = False):
    """The ``sharded`` line: a world of one over NCCL in this process.
    Launch counts reset, then ``ivf_flat.build_sharded`` and
    ``ivf_pq.build_sharded`` (bit for bit the single-device builds'
    ``shard()``) and ``shard_brute_force`` under L1; each served by a
    ``ServeEngine`` closed loop over every query in turns with a
    single-device engine over the same index (single, sharded, sharded,
    single; each qps the mean of its two passes; the results bit for bit
    the single-device engine's, *resident*) and open loop at
    ``SHARDED_STREAM_RATE`` × its closed-loop qps (every request bit for
    bit); a ``save_sharded`` / ``load_sharded`` round trip of the IVF-PQ
    index.  B1, B2, B3, B4's scan mode and B5 must launch in the sharded
    builds and engines themselves: the launch counts are theirs only (the
    single-device engines and the archive check run outside the counted
    spans).  With
    *profile*, one super-batch of each engine is traced after its open
    loop.  Returns (launches, {kind: results}, {kind: closed-loop
    qps})."""
    import shutil
    import tempfile

    import torch

    from raft_tpu_torch.comms import CommsSession
    from raft_tpu_torch.distance import DistanceType
    from raft_tpu_torch.neighbors import ann_mnmg, ivf_flat, ivf_pq, serialize
    from raft_tpu_torch.serve import ServeEngine

    t_phase = time.perf_counter()
    row = {"phase": "sharded", "world": 1, "card": smi}
    store = tempfile.mkdtemp(prefix="raft_smoke_store_")
    session = CommsSession(multihost=dict(
        init_method=f"file://{store}/store", world_size=1, rank=0),
        device=device).init()
    got, qps = {}, {}
    try:
        comms = session.comms
        row["backend"] = comms.backend
        _reset(device)
        counted = _PathLaunches()
        builds = {}
        for kind, mod, params in (
                ("ivf_flat", ivf_flat, ivf_flat.IndexParams(n_lists=n_lists)),
                ("ivf_pq", ivf_pq, ivf_pq.IndexParams(n_lists=n_lists))):
            t0 = time.perf_counter()
            with counted.span():
                sh = mod.build_sharded(params, x, comms, device=device)
                build_s = _synced_seconds(device, t0)
            same = _index_equal(sh, resident[kind][1].shard(comms))
            check(same, f"sharded {kind}: build_sharded differs from the "
                  "single-device build's shard()")
            builds[kind] = sh
            row[f"{kind}_build"] = {"s": build_s, "aux": sh.aux,
                                    "equals_build_then_shard": same}
        with counted.span():
            builds["brute_force"] = ann_mnmg.shard_brute_force(
                x, comms, DistanceType.L1, device=device)
        params = {"ivf_flat": ivf_flat.SearchParams(n_probes=n_probes),
                  "ivf_pq": ivf_pq.SearchParams(n_probes=n_probes),
                  "brute_force": None}
        offsets = np.cumsum([0] + [q.shape[0] for q in reqs[:-1]])
        for kind, sh in builds.items():
            eng = ServeEngine(sh, k, params[kind], max_batch=1024)
            kw = ({"metric": "l1", "device": device}
                  if kind == "brute_force" else {})
            one = ServeEngine(resident[kind][1], k, params[kind],
                              max_batch=1024, **kw)
            t0 = time.perf_counter()
            with counted.span():
                eng.warmup()
            warm_s = time.perf_counter() - t0
            one.warmup()
            c0 = compiles()
            passes = {"single": [], "sharded": []}
            single = resident[kind][0]
            for who in ("single", "sharded", "sharded", "single"):
                with (counted.span() if who == "sharded"
                      else contextlib.nullcontext()):
                    results, _, serve_s = _closed_loop(
                        one if who == "single" else eng, calls, warm=False)
                passes[who].append(n_queries / serve_s)
                check(all(np.array_equal(a[0], b[0])
                          and np.array_equal(a[1], b[1])
                          for a, b in zip(results, single.results)),
                      f"sharded {kind}: {who} results differ from the "
                      "single-device engine's")
            one.close()
            qps[kind] = float(np.mean(passes["sharded"]))
            ref_d, ref_i = _results_arrays(results)
            rate = SHARDED_STREAM_RATE * qps[kind]
            with counted.span():
                timed = _stream_pass(eng, reqs, rate, None, 0)
            _check_stream(f"sharded {kind}", timed[0], reqs, offsets, ref_d,
                          ref_i, rejections_ok=False)
            stream = _stream_row(f"sharded_{kind}", SHARDED_STREAM_RATE, eng,
                                 reqs, timed, {}, rate, None, smi)
            row[kind] = {"backend": eng.backend, "warmup_s": warm_s,
                         "qps": qps[kind],
                         "single_device_qps": float(np.mean(
                             passes["single"])),
                         "qps_passes": passes,
                         "equals_single_device": True,
                         "open_loop": {key: stream[key] for key in (
                             "offered_qps", "achieved_qps",
                             "latency_s_p50", "latency_s_p99",
                             "e2e_latency_s_p50", "e2e_latency_s_p99")},
                         "stats": dict(eng.stats)}
            after_warmup(row[kind], c0, f"sharded {kind}")
            if profile:
                profile_serve(f"sharded_{kind}", eng, q_host, device)
            eng.close()
            got[kind] = results
        # the archive of the IVF-PQ shard: the same blocks, the same bits
        path = ARCHIVE_DIR / "sharded_ivf_pq"
        ARCHIVE_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        serialize.save_sharded(path, builds["ivf_pq"])
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = serialize.load_sharded(path, comms, device=device)
        load_s = _synced_seconds(device, t0)
        same = _index_equal(back, builds["ivf_pq"])
        d0, i0 = ann_mnmg.search(builds["ivf_pq"], q_host[:1024], k,
                                 params["ivf_pq"])
        d1, i1 = ann_mnmg.search(back, q_host[:1024], k, params["ivf_pq"])
        same = same and torch.equal(d0, d1) and torch.equal(i0, i1)
        check(same, "sharded: the loaded IVF-PQ archive differs")
        row["archive"] = {"kind": "ivf_pq", "save_s": save_s,
                          "load_s": load_s,
                          "bytes": path.with_suffix(".npz").stat().st_size,
                          "round_trip_equal": same}
        path.with_suffix(".npz").unlink()
        launches = counted.total
        row["collective_calls"] = dict(comms.collective_calls)
    finally:
        session.destroy()
        shutil.rmtree(store, ignore_errors=True)
    row["launches"] = launches
    row["phase_s"] = time.perf_counter() - t_phase
    emit(row)
    for name in PATH_KERNELS["sharded"]:
        check(launches[name] > 0, f"sharded never launched {name}")
    return launches, got, qps


def _serve_data(p, device):
    """The smoke's 1M dataset and queries, made in a worker from the seed
    as ``run`` makes them (checked against the parent's rows)."""
    import torch

    d = p["data"]
    gen = torch.Generator(device=device).manual_seed(p["seed"])
    comps = torch.randn(4 * d["n_lists"], d["dim"], generator=gen,
                        device=device)
    x = mixture(gen, d["n"], d["dim"], comps, 0.7, device)
    queries = mixture(gen, d["n_queries"], d["dim"], comps, 0.7, device)
    check(np.array_equal(_witness(x), p["x_rows"])
          and np.array_equal(_witness(queries), p["q_rows"]),
          "serving worker: its data differ from the smoke's")
    return x, queries


def _sharded_w2_worker(comms, p):
    """One rank of ``sharded_w2``: the smoke's data from the seed; the
    two IVF indexes ``build_sharded`` over the world (B1 and B3 on rank
    0), each against the shard of the world-1 index loaded from its
    archive; brute force L1 row-sharded; each served by a ``ServeEngine``
    that rank 0 leads and rank 1 follows.  The launch counts are the
    builds' and the engines' (the archive's load runs outside them)."""
    import torch

    from raft_tpu_torch.distance import DistanceType
    from raft_tpu_torch.kernels import native
    from raft_tpu_torch.neighbors import ann_mnmg, ivf_flat, ivf_pq, serialize
    from raft_tpu_torch.serve import ServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = comms.device
    x, queries = _serve_data(p, device)
    q_host = queries.cpu().numpy()
    _, calls = ragged_calls(q_host, q_host.shape[0])
    # this process's first launches load the kernels
    ivf_flat.search(ivf_flat.SearchParams(),
                    ivf_flat.build(ivf_flat.IndexParams(n_lists=8),
                                   x[:4096], device=device), q_host[:8], 2)
    _reset(device)
    counted = _PathLaunches()
    comms.barrier()
    out = {"rank": comms.get_rank(), "kinds": {}}
    mods = {"ivf_flat": (ivf_flat, serialize.load_ivf_flat),
            "ivf_pq": (ivf_pq, serialize.load_ivf_pq)}
    for kind in ("ivf_flat", "ivf_pq", "brute_force"):
        res = {}
        if kind == "brute_force":
            with counted.span():
                sh = ann_mnmg.shard_brute_force(x, comms, DistanceType.L1,
                                                device=device)
            params = None
        else:
            mod, load = mods[kind]
            t0 = time.perf_counter()
            with counted.span():
                built = mod.build_sharded(
                    mod.IndexParams(n_lists=p["n_lists"]), x, comms,
                    device=device)
                res["build_s"] = _synced_seconds(device, t0)
            sh = load(p["archives"][kind], device=device).shard(comms)
            res["build_sharded_equals_world1_shard"] = _index_equal(built,
                                                                    sh)
            del built
            params = mod.SearchParams(n_probes=p["n_probes"])
        eng = ServeEngine(sh, p["k"], params, max_batch=1024)
        c0 = compiles()
        if eng.is_leader:
            with counted.span():
                t0 = time.perf_counter()
                eng.warmup()
                warm_s = time.perf_counter() - t0
                c1 = compiles()
                results, _, serve_s = _closed_loop(eng, calls, warm=False)
                eng.close()
            res.update(results=_results_arrays(results), warm_s=warm_s,
                       serve_s=serve_s, qps=q_host.shape[0] / serve_s,
                       stats=dict(eng.stats), warmup_compiles=c1 - c0,
                       compiles_after_warmup=compiles() - c1)
        else:
            with counted.span():
                res["follow"] = eng.follow()
            # a follower runs the leader's warm blocks, then its traffic
            res["follower_compiles"] = compiles() - c0
        res["wire"] = dict(eng._wire.calls)
        out["kinds"][kind] = res
        del eng, sh
    out["launches"] = counted.total
    out["collective_calls"] = dict(comms.collective_calls)
    return out


def _payload(seed, x, queries, n_lists, n_probes, k, archives):
    return {"seed": seed,
            "data": {"n": x.shape[0], "n_queries": queries.shape[0],
                     "dim": x.shape[1], "n_lists": n_lists},
            "x_rows": _witness(x), "q_rows": _witness(queries),
            "n_lists": n_lists, "n_probes": n_probes, "k": k,
            "archives": archives}


def _free_for_workers(device) -> dict:
    """Hand the card's memory this process holds but no longer uses to
    the worker processes about to start (their contexts and data need
    it): collect unreachable objects, then empty the allocator's cache.
    Returns the bytes allocated and reserved before and after."""
    import gc

    import torch

    if device.type != "cuda":
        return {}
    torch.cuda.synchronize()
    before = (torch.cuda.memory_allocated(), torch.cuda.memory_reserved())
    gc.collect()
    torch.cuda.empty_cache()
    return {"allocated_bytes": [before[0], torch.cuda.memory_allocated()],
            "reserved_bytes": [before[1], torch.cuda.memory_reserved()]}


def _world(target, payload, device, coordinator=None):
    import tempfile

    from raft_tpu_torch.testing.world import run_world

    _free_for_workers(device)
    with tempfile.TemporaryDirectory(prefix="raft_smoke_serve_") as tmp:
        t0 = time.perf_counter()
        outs = run_world(target, 2, payload, workdir=tmp, backend="gloo",
                         device=device.type, threads=4,
                         timeout=SERVE_W2_TIMEOUT_S,
                         coordinator=coordinator)
        return outs, time.perf_counter() - t0


def sharded_w2_phase(device, seed, x, queries, n_lists, n_probes, k,
                     resident, world1, qps1, smi):
    """The ``sharded_w2`` line: two worker processes on the one card over
    gloo, rank 0 leading each ``ServeEngine`` and rank 1 following.  The
    world-1 IVF indexes reach them as archives (``save_ivf_flat`` /
    ``save_ivf_pq``); each worker also runs ``build_sharded`` over the
    world, which must equal the archive's shard on each rank.  Every
    kind: distances bit for bit world 1's, ids equal except at exact
    distance ties; qps beside world 1's.  Returns the launches summed
    over both workers."""
    from raft_tpu_torch.neighbors import serialize

    t_phase = time.perf_counter()
    ARCHIVE_DIR.mkdir(parents=True, exist_ok=True)
    archives = {}
    for kind, save in (("ivf_flat", serialize.save_ivf_flat),
                       ("ivf_pq", serialize.save_ivf_pq)):
        path = ARCHIVE_DIR / f"w1_{kind}.npz"
        save(path, resident[kind][1])
        archives[kind] = str(path)
    outs, wall = _world("chip_smoke:_sharded_w2_worker",
                        _payload(seed, x, queries, n_lists, n_probes, k,
                                 archives), device)
    for path in archives.values():
        pathlib.Path(path).unlink()
    row = {"phase": "sharded_w2", "world": 2, "backend": "gloo",
           "workers_wall_s": wall, "card": smi}
    lead, follower = outs
    for kind, res in lead["kinds"].items():
        check(follower["kinds"][kind]["follow"] == "close",
              f"sharded_w2 {kind}: the follower was not released")
        ties = _exact_ties_only(f"sharded_w2 {kind} vs world 1",
                                res["results"],
                                _results_arrays(world1[kind]))
        row[kind] = {"qps": res["qps"], "world1_qps": qps1[kind],
                     "warmup_s": res["warm_s"],
                     "id_diffs_at_exact_ties": ties,
                     "distances_equal_world1": True,
                     "warmup_compiles": res["warmup_compiles"],
                     "follower_compiles": follower["kinds"][kind][
                         "follower_compiles"],
                     "stats": res["stats"], "wire_rank0": res["wire"]}
        after_warmup(row[kind], 0, f"sharded_w2 {kind}",
                     res["compiles_after_warmup"])
        # the follower's first calls are the warm blocks' only
        check(row[kind]["follower_compiles"] <= res["warmup_compiles"],
              f"sharded_w2 {kind}: the follower made first calls past "
              "the warm-up's")
        if kind != "brute_force":
            same = [o["kinds"][kind]["build_sharded_equals_world1_shard"]
                    for o in outs]
            check(all(same), f"sharded_w2 {kind}: build_sharded differs "
                  f"from the world-1 archive's shard on a rank ({same})")
            row[kind]["build_s_by_rank"] = [o["kinds"][kind]["build_s"]
                                            for o in outs]
            row[kind]["build_sharded_equals_world1_shard"] = same
    row["collective_calls_rank0"] = lead["collective_calls"]
    row["host_staged"] = {key[:-len("_host_staged")]: v for key, v in
                          lead["collective_calls"].items()
                          if key.endswith("_host_staged")}
    launches = {name: sum(o["launches"][name] for o in outs)
                for name in lead["launches"]}
    row["launches"] = launches
    row["phase_s"] = time.perf_counter() - t_phase
    emit(row)
    for name in PATH_KERNELS["sharded_w2"]:
        check(launches[name] > 0, f"sharded_w2 never launched {name}")
    return launches


def _replica_w2_worker(comms, p):
    """One rank of ``replica_w2``: the world-1 IVF-PQ index from its
    archive, ``replicate``-d into two groups of one rank; rank 0 leads
    the replica engine (closed loop with both lanes live, the
    shadow-lane tune under live traffic, the fault plan that drains lane
    1, closed loop again), rank 1 follows."""
    import torch

    from raft_tpu_torch.kernels import native
    from raft_tpu_torch.neighbors import ann_mnmg, ivf_pq, serialize
    from raft_tpu_torch.serve import AutoTuner, ServeEngine, TunerConfig
    from raft_tpu_torch.testing import faults

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = comms.device
    _, queries = _serve_data(p, device)
    q_host = queries.cpu().numpy()
    reqs, calls = ragged_calls(q_host, q_host.shape[0])
    index = serialize.load_ivf_pq(p["archives"]["ivf_pq"], device=device)
    rep = ann_mnmg.replicate(index, comms, 2)
    params = ivf_pq.SearchParams(n_probes=p["n_probes"])
    _reset(device)
    comms.barrier()
    eng = ServeEngine(rep, p["k"], params, max_batch=1024)
    out = {"rank": comms.get_rank()}
    c0 = compiles()
    if not eng.is_leader:
        out["follow"] = eng.follow()
        out["follower_compiles"] = compiles() - c0
        out["launches"] = dict(native.LAUNCHES)
        out["wire"] = dict(eng._wire.calls)
        return out
    router = eng._router

    def lanes():
        return [router._dispatches.get((eng._engine_id, str(r)))
                for r in range(rep.n_replicas)]

    t0 = time.perf_counter()
    eng.warmup()
    warm_s = time.perf_counter() - t0
    out["warmup_compiles"] = compiles() - c0
    c0 = compiles()
    # both lanes live against lane 1 drained (the router's operator
    # drain), in turns; each qps the mean of its two passes
    passes = {"both": [], "drained": []}
    served = {"both": [0, 0], "drained": [0, 0]}
    first = None
    for who in ("both", "drained", "drained", "both"):
        (router.drain if who == "drained" else router.restore)(1)
        before = lanes()
        results, _, serve_s = _closed_loop(eng, calls, warm=False)
        passes[who].append(q_host.shape[0] / serve_s)
        served[who] = [a + b - c for a, b, c in
                       zip(served[who], lanes(), before)]
        got = _results_arrays(results)
        first = got if first is None else first
        check(np.array_equal(got[0], first[0])
              and np.array_equal(got[1], first[1]),
              f"replica_w2: the {who} pass gave other results")
    router.restore(1)
    out["both_lanes"] = {"results": first,
                         "qps": float(np.mean(passes["both"])),
                         "qps_passes": passes["both"], "warm_s": warm_s,
                         "lanes": served["both"]}
    out["drained"] = {"qps": float(np.mean(passes["drained"])),
                      "qps_passes": passes["drained"],
                      "lanes": served["drained"]}
    # the shadow-lane tune under Poisson live traffic
    sigs = eng.warmed_signatures()
    stop = threading.Event()
    feeder, subs = _poisson_feed(
        eng, reqs, REPLICA_TUNE_RATE * out["both_lanes"]["qps"], p["seed"],
        stop)
    t0 = time.perf_counter()
    report = AutoTuner(eng, TunerConfig(seed=p["seed"]),
                       shadow_lane=1).run()
    tune_s = time.perf_counter() - t0
    stop.set()
    feeder.join(STREAM_WAIT_S)
    check(not feeder.is_alive(), "replica_w2: the feeder hung")
    live = [f.result(timeout=STREAM_WAIT_S) for _, f in subs]
    ref_d, ref_i = out["both_lanes"]["results"]
    offsets = np.cumsum([0] + [q.shape[0] for q in reqs[:-1]])
    for (j, _f), o in zip(subs, live):
        n = reqs[j].shape[0]
        check(isinstance(o, tuple)
              and np.array_equal(o[0], ref_d[offsets[j]:offsets[j] + n])
              and np.array_equal(o[1], ref_i[offsets[j]:offsets[j] + n]),
              "replica_w2: a live request under the tune failed or differs")
    out["tune"] = {"winner": report["winner"], "s": tune_s,
                   "decisions": report["decisions"],
                   "live_requests": len(live),
                   "lane_restored": router.degraded_lanes() == [],
                   "signatures_unchanged": eng.warmed_signatures() == sigs}
    # a promoted cap stays inside the ladder; the fault plan drains lane 1
    faults0 = eng.stats["replica_faults"]
    before = lanes()
    with faults.plan("comms:op=replica_dispatch:rank=1:raise"):
        results, _, serve_s = _closed_loop(eng, calls, warm=False)
    out["one_lane"] = {"results": _results_arrays(results),
                       "qps": q_host.shape[0] / serve_s,
                       "lanes": [a - b for a, b in zip(lanes(), before)],
                       "replica_faults": eng.stats["replica_faults"] - faults0,
                       "replica_reroutes": eng.stats["replica_reroutes"],
                       "dispatch_errors": eng.stats["dispatch_errors"],
                       "healthz_replicas": eng._health()["replicas"]}
    out["stats"] = dict(eng.stats)
    out["compiles_after_warmup"] = compiles() - c0
    eng.close()
    out["launches"] = dict(native.LAUNCHES)
    out["wire"] = dict(eng._wire.calls)
    return out


def replica_w2_phase(device, seed, x, queries, n_lists, n_probes, k,
                     resident, smi):
    """The ``replica_w2`` line: R = 2 replica groups of one rank each on
    the one card (two gloo workers), IVF-PQ from the world-1 archive.
    Both lanes serve (the router's dispatch counts, lane 1's results over
    the wire) bit for bit the single-device engine, in turns with lane 1
    drained (both, drained, drained, both); the shadow-lane tune
    (``AutoTuner(shadow_lane=1)``) runs under Poisson live traffic with no
    failed live request; the fault plan ``comms:op=replica_dispatch:
    rank=1:raise`` drains lane 1 with no failed request; qps with both
    lanes live and with one.  Returns the launches summed over both
    workers."""
    from raft_tpu_torch.neighbors import serialize

    t_phase = time.perf_counter()
    ARCHIVE_DIR.mkdir(parents=True, exist_ok=True)
    path = ARCHIVE_DIR / "w1_ivf_pq.npz"
    serialize.save_ivf_pq(path, resident["ivf_pq"][1])
    outs, wall = _world("chip_smoke:_replica_w2_worker",
                        _payload(seed, x, queries, n_lists, n_probes, k,
                                 {"ivf_pq": str(path)}), device)
    path.unlink()
    lead, follower = outs
    check(follower["follow"] == "close",
          "replica_w2: the follower was not released")
    single = _results_arrays(resident["ivf_pq"][0].results)
    for key in ("both_lanes", "one_lane"):
        got = lead[key]["results"]
        check(np.array_equal(got[0], single[0])
              and np.array_equal(got[1], single[1]),
              f"replica_w2 {key}: results differ from the single-device "
              "engine's")
    both, one = lead["both_lanes"], lead["one_lane"]
    check(all(n > 0 for n in both["lanes"]),
          f"replica_w2: a lane served nothing ({both['lanes']})")
    check(lead["wire"]["result"] > 0,
          "replica_w2: no result came back over the wire from lane 1")
    check(one["replica_faults"] >= 1 and one["replica_reroutes"] > 0
          and one["dispatch_errors"] == 0
          and one["healthz_replicas"]["degraded"] == [1],
          f"replica_w2: the fault plan did not drain lane 1 cleanly ({one})")
    check(lead["tune"]["lane_restored"]
          and lead["tune"]["signatures_unchanged"],
          f"replica_w2: the shadow-lane tune left {lead['tune']}")
    row = {"phase": "replica_w2", "world": 2, "replicas": 2,
           "group_size": 1, "backend": "gloo", "workers_wall_s": wall,
           "card": smi,
           "both_lanes": {key: both[key] for key in (
               "qps", "qps_passes", "lanes", "warm_s")},
           "lane_1_drained": lead["drained"],
           "one_lane": {key: one[key] for key in (
               "qps", "lanes", "replica_faults", "replica_reroutes",
               "dispatch_errors", "healthz_replicas")},
           "single_device_qps": resident["ivf_pq"][0].row["qps"],
           "equals_single_device": True, "tune": lead["tune"],
           "stats": lead["stats"], "wire_rank0": lead["wire"],
           "wire_rank1": follower["wire"],
           "warmup_compiles": lead["warmup_compiles"],
           "follower_compiles": follower["follower_compiles"]}
    after_warmup(row, 0, "replica_w2", lead["compiles_after_warmup"])
    check(row["follower_compiles"] <= row["warmup_compiles"],
          "replica_w2: the follower made first calls past the warm-up's")
    launches = {name: sum(o["launches"][name] for o in outs)
                for name in lead["launches"]}
    row["launches"] = launches
    row["phase_s"] = time.perf_counter() - t_phase
    emit(row)
    for name in PATH_KERNELS["replica_w2"]:
        check(launches[name] > 0, f"replica_w2 never launched {name}")
    return launches


#: the sharded mutable phases: the IVF kinds of the world-1 phase (the
#: world-2 phase runs IVF-PQ, whose shards scan with B4's bitmap mode)
SH_MUT_KINDS = ("ivf_flat", "ivf_pq")


def _churn_plan(n: int, seed: int):
    """``mutable_path``'s churn at full width as a list of write batches
    (``("upsert" | "delete", ids)``, MUT_BATCH rows each): upserts of
    live ids with fresh vectors, upserts of new ids, deletes of live ids,
    re-upserts of deleted ids.  Returns (ops, the live mask after)."""
    rng = np.random.default_rng(seed)
    alive = np.zeros(n + MUT_UPSERT_NEW, bool)
    alive[:n] = True

    def batches(kind, ids):
        return [(kind, ids[b:b + MUT_BATCH])
                for b in range(0, ids.size, MUT_BATCH)]

    ops = batches("upsert", rng.choice(n, MUT_UPSERT_LIVE, replace=False))
    ops += batches("upsert", np.arange(n, n + MUT_UPSERT_NEW))
    alive[n:] = True
    gone = rng.choice(np.nonzero(alive)[0], MUT_DELETE, replace=False)
    ops += batches("delete", gone)
    alive[gone] = False
    back = rng.choice(gone, MUT_REUPSERT, replace=False)
    ops += batches("upsert", back)
    alive[back] = True
    return ops, alive


def _churn_rows(x, seed: int, ops):
    """The upserts' fresh vectors, made from *seed* on *x*'s device: a
    mixture around rows of *x* (so every process that holds the smoke's
    data makes the same ones)."""
    import torch

    n, dim = x.shape
    comps = x[torch.arange(0, 4096, device=x.device) * 241 % n]
    gen = torch.Generator(device=x.device).manual_seed(seed)
    return [mixture(gen, ids.size, dim, comps, 0.7, x.device)
            if kind == "upsert" else None for kind, ids in ops]


def _apply_churn(muts, ops, rows, device, spans=None):
    """Apply the churn to each index of *muts*, batch by batch, the order
    of the indexes reversed every other batch (so each is measured in
    turns with the others), each write inside its index's entry of
    *spans* (context-manager factories; default none); returns each
    one's {upsert, delete} rows/s."""
    t = [{"upsert": [0.0, 0], "delete": [0.0, 0]} for _ in muts]
    spans = spans or [contextlib.nullcontext] * len(muts)
    for j, ((kind, ids), v) in enumerate(zip(ops, rows)):
        order = range(len(muts)) if j % 2 == 0 else reversed(
            range(len(muts)))
        for m in order:
            t0 = time.perf_counter()
            with spans[m]():
                if kind == "upsert":
                    muts[m].upsert(v, ids)
                else:
                    check(muts[m].delete(ids) == ids.size,
                          "a churn delete missed ids")
                t[m][kind][0] += _synced_seconds(device, t0)
            t[m][kind][1] += ids.size
    return [{f"{kind}_rows_per_s": n / s for kind, (s, n) in tm.items()}
            for tm in t]


def _compact_under_traffic(mut, eng, calls):
    """A ``Compactor`` tick while a reader thread serves *calls* closed
    loop through *eng*: (promoted, seconds, reader passes, failures, the
    reads' first calls — all but the compaction's, which run on this
    thread)."""
    import importlib

    from raft_tpu_torch.neighbors import mutable

    aot = importlib.import_module("raft_tpu_torch.core.aot")

    stop = threading.Event()
    failed, passes = [], [0]

    def reader():
        try:
            while not stop.is_set():
                for call in calls[:2]:
                    failed.extend(repr(o) for o in eng.search(call)
                                  if not isinstance(o, tuple))
                passes[0] += 1
        except Exception as e:   # noqa: BLE001 — checked by the caller
            failed.append(repr(e))

    rt = threading.Thread(target=reader)
    rt.start()
    comp = mutable.Compactor(mut, eng, delta_fraction=1e-4,
                             tomb_fraction=1e-4)
    t0 = time.perf_counter()
    c0, own0 = compiles(), aot.thread_compiles()
    try:
        promoted = comp.tick()
    finally:
        stop.set()
        rt.join(STREAM_WAIT_S)
    check(not rt.is_alive(), "the reader under compaction hung")
    reads = compiles() - c0 - (aot.thread_compiles() - own0)
    return (promoted and comp.errors == 0, time.perf_counter() - t0,
            passes[0], failed, reads)


def sharded_mutable_phase(device, seed, x, queries, calls, n_queries,
                          n_lists, n_probes, k, resident, smi):
    """The ``sharded_mutable`` line: a world of one over NCCL in this
    process, for IVF-Flat and IVF-PQ.  The main is built with
    ``build_sharded`` and wrapped in a ``MutableIndex``; a single-device
    ``MutableIndex`` over the single-device index (*resident*) takes the
    same churn (``_churn_plan``, ``mutable_path``'s at full width).  Every
    search through the direct API and the engine is bit for bit the
    single-device index's, and no deleted id comes back; the two engines
    run closed loop over every query in turns (single, sharded, sharded,
    single); a ``save_mutable`` / ``load_mutable`` round trip returns the
    same bits; a ``Compactor`` compacts the sharded index under
    closed-loop traffic through its engine with no failed request, and
    after it (and the single-device index's own compaction) the two
    still answer with the same bits.  Launch counts are the sharded
    index's work only (its build, writes, searches, engine and
    compaction).  Returns (launches, {kind: engine results}, {kind:
    closed-loop qps})."""
    import shutil
    import tempfile

    import torch

    from raft_tpu_torch.comms import CommsSession
    from raft_tpu_torch.neighbors import ivf_flat, ivf_pq, mutable, serialize
    from raft_tpu_torch.serve import ServeEngine

    t_phase = time.perf_counter()
    row = {"phase": "sharded_mutable", "world": 1, "card": smi,
           "churn": {"upsert_live": MUT_UPSERT_LIVE,
                     "upsert_new": MUT_UPSERT_NEW, "delete": MUT_DELETE,
                     "reupsert": MUT_REUPSERT, "batch": MUT_BATCH}}
    store = tempfile.mkdtemp(prefix="raft_smoke_store_")
    session = CommsSession(multihost=dict(
        init_method=f"file://{store}/store", world_size=1, rank=0),
        device=device).init()
    n = x.shape[0]
    ops, alive = _churn_plan(n, seed)
    rows = _churn_rows(x, seed, ops)
    live_t = torch.as_tensor(alive, device=device)
    qr = queries[:1024]
    got, qps = {}, {}
    try:
        comms = session.comms
        row["backend"] = comms.backend
        _reset(device)
        counted = _PathLaunches()
        mods = {"ivf_flat": ivf_flat, "ivf_pq": ivf_pq}
        for kind in SH_MUT_KINDS:
            mod = mods[kind]
            bp = mod.IndexParams(n_lists=n_lists)
            sp = mod.SearchParams(n_probes=n_probes)
            res = {}
            t0 = time.perf_counter()
            with counted.span():
                sh = mod.build_sharded(bp, x, comms, device=device)
                res["build_s"] = _synced_seconds(device, t0)
                mut = mutable.MutableIndex(sh, x, build_params=bp)
            one = mutable.MutableIndex(resident[kind][1], x,
                                       build_params=bp)
            # the churn through both, in turns (the sharded index's
            # writes counted)
            res["writes"], res["single_device_writes"] = _apply_churn(
                (mut, one), ops, rows, device,
                spans=(counted.span, contextlib.nullcontext))
            check(mut.size == one.size == int(alive.sum())
                  and mut.delta_rows == one.delta_rows
                  and mut.tombstone_count == one.tombstone_count,
                  f"sharded_mutable {kind}: books differ after the churn")
            with counted.span():
                d0, i0 = mutable.search(mut, qr, k, sp)
            d1, i1 = mutable.search(one, qr, k, sp)
            check(torch.equal(d0, d1) and torch.equal(i0, i1),
                  f"sharded_mutable {kind}: the direct search differs "
                  "from the single-device index's")
            it = i0.long()
            check(bool((it >= 0).all()) and bool(live_t[it].all()),
                  f"sharded_mutable {kind}: a deleted id came back")
            # the archive of the churned index: the same bits
            path = ARCHIVE_DIR / f"sharded_mutable_{kind}"
            ARCHIVE_DIR.mkdir(parents=True, exist_ok=True)
            t0 = time.perf_counter()
            serialize.save_mutable(path, mut)
            save_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            back = serialize.load_mutable(path, device=device, comms=comms)
            load_s = _synced_seconds(device, t0)
            d2, i2 = mutable.search(back, qr, k, sp)
            check(back.sharded and torch.equal(d0, d2)
                  and torch.equal(i0, i2),
                  f"sharded_mutable {kind}: the loaded archive differs")
            res["archive"] = {
                "save_s": save_s, "load_s": load_s,
                "bytes": path.with_suffix(".npz").stat().st_size,
                "round_trip_equal": True}
            path.with_suffix(".npz").unlink()
            del back
            # the two engines over every query, in turns
            eng = ServeEngine(mut, k, sp, max_batch=1024)
            eng_one = ServeEngine(one, k, sp, max_batch=1024)
            with counted.span():
                eng.warmup()
            eng_one.warmup()
            c0 = compiles()
            passes = {"single": [], "sharded": []}
            first = None
            for who in ("single", "sharded", "sharded", "single"):
                with (counted.span() if who == "sharded"
                      else contextlib.nullcontext()):
                    results, _, serve_s = _closed_loop(
                        eng_one if who == "single" else eng, calls,
                        warm=False)
                passes[who].append(n_queries / serve_s)
                arr = _results_arrays(results)
                first = arr if first is None else first
                check(np.array_equal(arr[0], first[0])
                      and np.array_equal(arr[1], first[1]),
                      f"sharded_mutable {kind}: the {who} engine's results "
                      "differ")
                if who == "sharded":
                    got[kind] = results
            qps[kind] = float(np.mean(passes["sharded"]))
            res.update(qps=qps[kind],
                       single_device_qps=float(np.mean(passes["single"])),
                       qps_passes=passes, equals_single_device=True)
            passes_compiles = compiles() - c0
            eng_one.close()
            # compaction under closed-loop traffic through the engine
            with counted.span():
                ok, compact_s, reader_passes, failed, read_compiles = \
                    _compact_under_traffic(mut, eng, calls)
            after_warmup(res, 0, f"sharded_mutable {kind}",
                         passes_compiles + read_compiles)
            check(ok and not failed and eng.stats["dispatch_errors"] == 0,
                  f"sharded_mutable {kind}: the compaction failed or failed "
                  f"requests ({failed[:3]})")
            res.update(compact_s=compact_s, reader_passes=reader_passes,
                       failed_requests=0, stats=dict(eng.stats),
                       wire=dict(eng._wire.calls))
            eng.close()
            t0 = time.perf_counter()
            one.compact()
            res["single_device_compact_s"] = time.perf_counter() - t0
            check(mut.delta_rows == 0 and mut.tombstone_count == 0
                  and mut.size == one.size,
                  f"sharded_mutable {kind}: books after the compaction")
            with counted.span():
                d0, i0 = mutable.search(mut, qr, k, sp)
            d1, i1 = mutable.search(one, qr, k, sp)
            check(torch.equal(d0, d1) and torch.equal(i0, i1),
                  f"sharded_mutable {kind}: after compaction the results "
                  "differ from the single-device compaction's")
            res["compacted_equals_single_device"] = True
            row[kind] = res
            del eng, mut, one, sh
        launches = counted.total
        row["collective_calls"] = dict(comms.collective_calls)
    finally:
        session.destroy()
        shutil.rmtree(store, ignore_errors=True)
    row["launches"] = launches
    row["phase_s"] = time.perf_counter() - t_phase
    emit(row)
    for name in PATH_KERNELS["sharded_mutable"]:
        check(launches[name] > 0, f"sharded_mutable never launched {name}")
    return launches, got, qps


def _sharded_mutable_w2_worker(comms, p):
    """One rank of ``sharded_mutable_w2``: the smoke's data from the seed,
    the world-1 IVF-PQ index from its archive sharded over the world and
    wrapped in a ``MutableIndex``; rank 0 leads a ``ServeEngine`` over
    it: the churn through the leader (WRITE to rank 1), every call closed
    loop, a compaction under closed-loop traffic; rank 1 follows.  After
    the engine closes, each rank's compacted shard against a fresh
    ``build_sharded`` of the rows it compacted, and the host plane
    (``host_barrier`` over the session's mailbox)."""
    import torch

    from raft_tpu_torch.comms import hostcomm
    from raft_tpu_torch.neighbors import ivf_pq, mutable, serialize
    from raft_tpu_torch.serve import ServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = comms.device
    x, queries = _serve_data(p, device)
    q_host = queries.cpu().numpy()
    _, calls = ragged_calls(q_host, q_host.shape[0])
    ops, _ = _churn_plan(x.shape[0], p["seed"])
    rows = _churn_rows(x, p["seed"], ops)
    bp = ivf_pq.IndexParams(n_lists=p["n_lists"])
    sp = ivf_pq.SearchParams(n_probes=p["n_probes"])
    index = serialize.load_ivf_pq(p["archives"]["ivf_pq"], device=device)
    sh = index.shard(comms)
    del index
    mut = mutable.MutableIndex(sh, x, build_params=bp)
    t0 = time.perf_counter()
    hostcomm.host_barrier(comms._mailbox, comms.get_rank(),
                          comms.get_size(), timeout=60)
    out = {"rank": comms.get_rank(),
           "barrier_s": time.perf_counter() - t0}
    _reset(device)
    counted = _PathLaunches()
    comms.barrier()
    eng = ServeEngine(mut, p["k"], sp, max_batch=1024)
    if eng.is_leader:
        with counted.span():
            eng.warmup()
            r0 = mutable.mutable_counters["rewarms"]
            (out["writes"],) = _apply_churn((mut,), ops, rows, device)
            out["rewarms"] = mutable.mutable_counters["rewarms"] - r0
            c0 = compiles()
            results, _, serve_s = _closed_loop(eng, calls, warm=False)
            out["passes_compiles"] = compiles() - c0
            out["results"] = _results_arrays(results)
            out["qps"] = q_host.shape[0] / serve_s
            out["compaction"] = _compact_under_traffic(mut, eng, calls)
            out["stats"] = dict(eng.stats)
            eng.close()
    else:
        with counted.span():
            out["follow"] = eng.follow()
    out["wire"] = dict(eng._wire.calls)
    out["books"] = (mut.size, mut.delta_rows, mut.tombstone_count)
    # the rows the compaction built from, in its order (the new core's
    # rows, ids by row)
    core = mut._mut_core
    ids = core.main_ids[np.argsort(core.main_row)]
    ref = ivf_pq.build_sharded(bp, core.main_x, comms,
                               ids=torch.as_tensor(ids), device=device)
    out["compacted_equals_build"] = all(
        torch.equal(a, b) for a, b in zip(core.main.stacked, ref.stacked))
    out["launches"] = counted.total
    return out


def sharded_mutable_w2_phase(device, seed, x, queries, n_lists, n_probes,
                             k, resident, world1, qps1, smi):
    """The ``sharded_mutable_w2`` line: two gloo worker processes on the
    one card, rank 0 leading a ``ServeEngine`` over a ``MutableIndex``
    whose main is the world-1 IVF-PQ index sharded over both ranks, rank
    1 following; the session's coordinator is a native
    ``MailboxServer``.  The leader's writes reach the follower (equal
    size, tombstones and delta rows on both ranks); distances bit for bit
    the world-1 sharded mutable engine's, ids equal except at exact
    ties; a compaction under traffic fails no request and each rank's
    compacted shard equals a fresh world-2 ``build_sharded`` of the rows
    it compacted.  Returns the launches summed over both workers."""
    from raft_tpu_torch.comms.hostcomm import MailboxServer
    from raft_tpu_torch.neighbors import serialize

    t_phase = time.perf_counter()
    ARCHIVE_DIR.mkdir(parents=True, exist_ok=True)
    path = ARCHIVE_DIR / "w1_ivf_pq.npz"
    serialize.save_ivf_pq(path, resident["ivf_pq"][1])
    with MailboxServer() as server:
        outs, wall = _world("chip_smoke:_sharded_mutable_w2_worker",
                            _payload(seed, x, queries, n_lists, n_probes, k,
                                     {"ivf_pq": str(path)}), device,
                            coordinator=f"{server.address[0]}:"
                                        f"{server.address[1]}")
        mailbox = server.backend
    path.unlink()
    lead, follower = outs
    check(follower["follow"] == "close",
          "sharded_mutable_w2: the follower was not released")
    check(lead["books"] == follower["books"],
          f"sharded_mutable_w2: the books differ ({lead['books']} vs "
          f"{follower['books']})")
    check(mailbox == "native", f"sharded_mutable_w2: mailbox {mailbox}")
    ties = _exact_ties_only("sharded_mutable_w2 vs world 1",
                            lead["results"],
                            _results_arrays(world1["ivf_pq"]))
    promoted, compact_s, passes, failed, read_compiles = lead["compaction"]
    check(promoted and not failed
          and lead["stats"]["dispatch_errors"] == 0,
          f"sharded_mutable_w2: the compaction failed or failed requests "
          f"({failed[:3]})")
    same = [o["compacted_equals_build"] for o in outs]
    check(all(same), f"sharded_mutable_w2: a compacted shard differs from "
          f"build_sharded of its rows ({same})")
    row = {"phase": "sharded_mutable_w2", "world": 2, "backend": "gloo",
           "kind": "ivf_pq", "card": smi, "workers_wall_s": wall,
           "mailbox": {"backend": mailbox,
                       "barrier_s": [o["barrier_s"] for o in outs]},
           "writes": lead["writes"], "qps": lead["qps"],
           "world1_qps": qps1["ivf_pq"], "id_diffs_at_exact_ties": ties,
           "distances_equal_world1": True, "compact_s": compact_s,
           "reader_passes": passes, "failed_requests": 0,
           "books": lead["books"], "books_equal": True,
           "compacted_equals_build": same, "stats": lead["stats"],
           "rewarms": lead["rewarms"],
           "wire_rank0": lead["wire"], "wire_rank1": follower["wire"]}
    after_warmup(row, 0, "sharded_mutable_w2",
                 lead["passes_compiles"] + read_compiles)
    launches = {name: sum(o["launches"][name] for o in outs)
                for name in lead["launches"]}
    row["launches"] = launches
    row["phase_s"] = time.perf_counter() - t_phase
    emit(row)
    for name in PATH_KERNELS["sharded_mutable_w2"]:
        check(launches[name] > 0,
              f"sharded_mutable_w2 never launched {name}")
    return launches


# ---------------------------------------------------------------------------
# the sparse graph path: BASELINE.json configs[3] and spectral partitioning
# of a planted graph (``spectral``), single-linkage HAC on the k-means
# path's blobs (``single_linkage``), sparse kNN on TF-IDF-shaped rows
# (``sparse_knn``)

#: BASELINE.json configs[3] as bench.py:1555-1591 defines it: a
#: scipy.sparse.random graph, symmetrised, its Laplacian, the 8 smallest
#: eigenpairs at tol 1e-6 from a seeded start, solves/s over 5 solves
SPEC_CFG3 = {"n": 20_000, "density": 2e-3, "k": 8, "tol": 1e-6,
             "solves": 5}
#: the planted-partition graph: communities of equal size, each vertex
#: drawing partners inside its own and outside it, uniformly
SPEC_PLANTED = {"n": 1_000_000, "communities": 16, "inside": 12,
                "outside": 4}
#: every returned eigenpair's ‖Av − λv‖ at most this × ‖A‖₁; VᵀV within
#: this of I; the planted labels' ARI at least this (a sanity floor)
SPEC_RESID = 1e-3
SPEC_ORTH = 1e-4
SPEC_ARI_FLOOR = 0.9
#: single linkage: cuML AgglomerativeClustering's defaults (kNN
#: connectivity, n_neighbors 15 → c), on the k-means path's blobs; the
#: PAIRWISE run on the first rows (12,000: scipy's dense MST on the
#: host, which the smoke waits for, grows with their square)
SL_C = 15
SL_PAIRWISE_ROWS = 12_000
SL_ARI_FLOOR = 0.999
SL_MST_RTOL = 1e-5
#: how long the host reference MST (scipy, in its own process) may take
SL_SCIPY_TIMEOUT_S = 600
#: sparse kNN: TF-IDF-shaped rows (Zipf-like features, positive values,
#: L2-normalised), queries the first rows, k
SPKNN = {"rows": 100_000, "features": 131_072, "nnz": (32, 128),
         "queries": 1_000, "k": 10, "zipf": 1.1,
         "l1_features": 1_024, "l1_nnz": 32}

_SCIPY_MST = """
import sys
import numpy as np
import scipy.sparse as sp
from scipy.sparse.csgraph import minimum_spanning_tree

d = np.load(sys.argv[1], mmap_mode="r")
# the upper triangle: scipy takes an edge's weight from either half
tree = minimum_spanning_tree(sp.csr_matrix(np.triu(d)))
print(repr(float(tree.astype(np.float64).sum())), tree.nnz)
"""


def _eigpair_checks(name, apply, norm1, vals, vecs):
    """Residuals ‖A v − λ v‖ of every returned pair against SPEC_RESID ×
    ‖A‖₁ and VᵀV against I; returns (max residual, max |VᵀV − I|)."""
    import torch

    check(vecs.shape[1] == vals.shape[0]
          and bool(torch.isfinite(vecs).all())
          and bool(torch.isfinite(vals).all()),
          f"{name}: eigenpairs not finite or of the wrong shape")
    resid = max(float(torch.linalg.vector_norm(apply(vecs[:, i].contiguous())
                                               - vals[i] * vecs[:, i]))
                for i in range(vals.shape[0]))
    eye = torch.eye(vecs.shape[1], dtype=vecs.dtype, device=vecs.device)
    orth = float((vecs.T @ vecs - eye).abs().max())
    check(resid <= SPEC_RESID * norm1, f"{name}: residual {resid} above "
          f"{SPEC_RESID} × ‖A‖₁ = {SPEC_RESID * norm1}")
    check(orth <= SPEC_ORTH, f"{name}: |VᵀV − I| {orth} above {SPEC_ORTH}")
    return resid, orth


def _lanczos_counts():
    from raft_tpu_torch import telemetry

    return {k: telemetry.counter(f"raft_tpu_lanczos_{k}_total").get()
            for k in ("matvecs", "restarts", "solves")}


def _planted_graph(seed, device):
    """SPEC_PLANTED's triplets (numpy, seeded), through ``from_triplets``
    and ``symmetrize``; returns (adjacency, planted labels, build s)."""
    import torch

    from raft_tpu_torch import sparse

    p = SPEC_PLANTED
    n, parts = p["n"], p["communities"]
    size = n // parts
    deg = p["inside"] + p["outside"]
    rng = np.random.default_rng(seed)
    comm = np.arange(n) // size
    src = np.repeat(np.arange(n, dtype=np.int32), deg)
    own = np.tile(np.arange(deg) < p["inside"], n)
    other = (comm[src] + rng.integers(1, parts, src.shape[0])) % parts
    dst = (np.where(own, comm[src], other) * size
           + rng.integers(0, size, src.shape[0])).astype(np.int32)
    keep = src != dst
    t0 = time.perf_counter()
    adj = sparse.symmetrize(sparse.from_triplets(
        src[keep], dst[keep], np.ones(int(keep.sum()), np.float32), (n, n),
        device=device))
    build_s = _synced_seconds(device, t0)
    return adj, torch.as_tensor(comm, device=device), build_s


def spectral_phase(device, seed, smi):
    """``spectral``: BASELINE.json configs[3] (solves/s over
    SPEC_CFG3["solves"] solves; no kernel runs there), then
    ``spectral.partition`` and ``modularity_maximization`` on
    SPEC_PLANTED's graph with 16 eigenvectors and 16 clusters, each with
    its launch counts reset: eigenpair residuals and orthogonality, ARI
    against the plants, ``analyze_partition`` / ``analyze_modularity``,
    solve and k-means seconds, restarts and SpMVs; B1 and B3 at each
    pipeline's (n, 16) embedding and its labels' centroids against their
    plain versions.  Returns (the launch counts of both pipelines
    together, those kernels' rows by shape)."""
    import scipy.sparse as sp
    import torch

    from raft_tpu_torch import sparse, spectral, stats, telemetry
    from raft_tpu_torch.kernels import native
    from raft_tpu_torch.sparse.op import segment_reduce
    from raft_tpu_torch.spectral.partition import _transform_eigen_matrix

    # (a) configs[3]
    c = SPEC_CFG3
    n = c["n"]
    g = sp.random(n, n, density=c["density"], format="csr",
                  dtype=np.float32, random_state=1)
    g = (g + g.T).tocsr()
    adj = sparse.CSR(g.indptr, g.indices, g.data, g.shape, device=device)
    lap = sparse.laplacian(adj)
    v0 = torch.as_tensor(np.random.default_rng(0).normal(0, 1, n),
                         dtype=torch.float32, device=device)
    t0 = time.perf_counter()
    vals, vecs = sparse.lanczos_smallest(lap, c["k"], tol=c["tol"], v0=v0)
    first_s = _synced_seconds(device, t0)
    _reset(device)
    before = _lanczos_counts()
    times = []
    for _ in range(c["solves"]):
        t0 = time.perf_counter()
        vals, vecs = sparse.lanczos_smallest(lap, c["k"], tol=c["tol"],
                                             v0=v0)
        times.append(_synced_seconds(device, t0))
    counts = {k: (v - before[k]) / c["solves"]
              for k, v in _lanczos_counts().items()}
    launches_cfg3 = dict(native.LAUNCHES)
    norm1 = float(segment_reduce(lap.data.abs(), lap.row_ids(),
                                 n).max())
    resid, orth = _eigpair_checks("spectral configs[3]",
                                  lambda v: sparse.spmv(lap, v), norm1,
                                  vals, vecs)
    emit({"phase": "spectral", "part": "configs[3]", "config":
          "BASELINE.json configs[3]: raft::sparse Lanczos eigensolver "
          "(bench.py bench_lanczos)", "n": n, "nnz": int(lap.nnz),
          "k": c["k"], "tol": c["tol"], "card": smi,
          "first_solve_s": first_s, "solve_s": times,
          "solves_per_s": c["solves"] / sum(times),
          "restarts_per_solve": counts["restarts"],
          "matvecs_per_solve": counts["matvecs"],
          "eigenvalues": vals.tolist(),
          "max_residual": resid, "norm1": norm1, "max_orth_err": orth,
          "launches": launches_cfg3})
    del adj, lap, vecs

    # (b) the planted graph through both pipelines
    adj, comm, build_s = _planted_graph(seed, device)
    k = SPEC_PLANTED["communities"]
    eig = spectral.LanczosEigenSolver(spectral.EigenSolverConfig(
        n_eigVecs=k))
    km = spectral.KMeansClusterSolver(spectral.ClusterSolverConfig(
        n_clusters=k))
    deg = spectral.degrees(adj)
    two_m = float(deg.sum())
    ones = sparse.CSR(adj.indptr, adj.indices, torch.ones_like(adj.data),
                      adj.shape)
    # exact column sums: L = D − A gives 2d; B = A − d dᵀ / 2m gives
    # 2 d_j − d_j Σ_{i ∈ N(j)} d_i / m (every a_ij ≥ 1 > d_i d_j / 2m)
    norms = {"partition": float(2 * deg.max()),
             "modularity_maximization": float(
                 (2 * deg - deg * sparse.spmv(ones, deg) / (two_m / 2))
                 .max())}
    lap_apply = spectral.laplacian_matvec(adj)[0]
    mod_apply = spectral.modularity_matvec(adj)[0]
    total = {name: 0 for name in native.LAUNCHES}
    rows = {"fused_l2_nn": {}, "fused_l2_nn_partials": {}}
    for name, apply in (("partition", lap_apply),
                        ("modularity_maximization", mod_apply)):
        _reset(device)
        before = _lanczos_counts()
        t0 = time.perf_counter()
        with telemetry.collect_spans() as spans:
            labels, vals, vecs, inertia = getattr(spectral, name)(adj, eig,
                                                                   km)
        secs = _synced_seconds(device, t0)
        launches = dict(native.LAUNCHES)
        peak = (torch.cuda.max_memory_allocated() if device.type == "cuda"
                else None)
        for key, v in launches.items():
            total[key] += v
        counts = {key: v - before[key] for key, v in _lanczos_counts().items()}
        solve_s = sum(e["dur_s"] for e in spans.events
                      if e["span"].startswith("raft_tpu.sparse.lanczos"))
        resid, orth = _eigpair_checks(f"spectral {name}", apply,
                                      norms[name], vals, vecs)
        ari = float(stats.adjusted_rand_index(comm, labels))
        check(labels.shape == (SPEC_PLANTED["n"],)
              and math.isfinite(float(inertia)),
              f"spectral {name}: labels (n,) and a finite inertia")
        check(ari >= SPEC_ARI_FLOOR, f"spectral {name}: ARI {ari} against "
              f"the planted communities (at least {SPEC_ARI_FLOOR})")
        for kern in PATH_KERNELS["spectral"]:
            check(launches[kern] > 0,
                  f"spectral {name}: the k-means never launched {kern}")
        # the k-means alone, warm, on the pipeline's embedding
        emb = _transform_eigen_matrix(vecs)
        if name == "modularity_maximization":
            emb = emb / torch.linalg.vector_norm(emb, dim=1,
                                                 keepdim=True).clamp_min(1e-30)
        t0 = time.perf_counter()
        km.solve(emb)
        kmeans_s = _synced_seconds(device, t0)
        # B1 and B3 at this new width against their plain versions, on the
        # embedding and the centroids of the pipeline's labels
        cnt = torch.bincount(labels.long(), minlength=k).clamp_min(1)
        cent = torch.zeros(k, emb.shape[1], device=device).index_add_(
            0, labels.long(), emb) / cnt[:, None]
        shape = f"spectral_{name}"
        rows["fused_l2_nn"][shape] = b1_row(shape, device, emb, cent, 5)
        rows["fused_l2_nn_partials"][shape] = b3_row(shape, device, emb,
                                                     cent, 5)
        for kern in rows:
            emit({"phase": "kernel", "name": f"{kern}@{shape}",
                  **rows[kern][shape]})
        edge_cut, cost = spectral.analyze_partition(adj, k, labels)
        q = spectral.analyze_modularity(adj, k, labels)
        p_cut, p_cost = spectral.analyze_partition(adj, k, comm)
        p_q = spectral.analyze_modularity(adj, k, comm)
        emit({"phase": "spectral", "part": name, "n": SPEC_PLANTED["n"],
              "nnz": int(adj.nnz), "communities": k, "card": smi,
              "graph_build_s": build_s, "seconds": secs,
              "solve_s": solve_s, "kmeans_warm_s": kmeans_s,
              "restarts": counts["restarts"], "matvecs": counts["matvecs"],
              "eigenvalues": vals.tolist(), "max_residual": resid,
              "norm1": norms[name], "max_orth_err": orth,
              "ari_vs_planted": ari, "inertia": float(inertia),
              "edge_cut": float(edge_cut), "cost": float(cost),
              "modularity": float(q), "planted_edge_cut": float(p_cut),
              "planted_cost": float(p_cost), "planted_modularity":
              float(p_q), "launches": launches, "peak_mem_bytes": peak})
        del labels, vecs, emb, cent
    del adj, ones, lap_apply, mod_apply
    return total, rows


def _mst_weight(w) -> float:
    return float(w.double().sum())


def single_linkage_phase(device, seed, smi):
    """``single_linkage`` on the k-means path's blobs (``KMEANS_SHAPE``,
    the same ``make_blobs`` draw): (a) KNN_GRAPH (c = SL_C) into
    n_clusters = the blob count, its launch counts reset: n − 1 edges in
    one component, ARI against the blobs, the native dendrogram and cut
    bit for bit their numpy twins, seconds by stage; (b) PAIRWISE on the
    first SL_PAIRWISE_ROWS rows: its MST weight against scipy's
    ``minimum_spanning_tree`` on the same distance matrix brought to the
    host (by the returned :class:`_ScipyCheck`), and not above
    KNN_GRAPH's on those rows; B2 at (a)'s first kNN-graph tile against
    its plain version and ``torch.topk`` (:func:`knn_tile_row`).  Returns
    (the launch counts of (a) and (b), the tile's row, the pending
    :class:`_ScipyCheck`)."""
    import importlib

    import torch

    from raft_tpu_torch import stats, telemetry
    from raft_tpu_torch.distance import DistanceType, distance
    from raft_tpu_torch.kernels import native
    from raft_tpu_torch.random import RngState, make_blobs
    from raft_tpu_torch.sparse import neighbors

    sl = importlib.import_module("raft_tpu_torch.cluster.single_linkage")
    n, dim, k = KMEANS_SHAPE
    metric = DistanceType.L2SqrtExpanded
    x, truth, _ = make_blobs(RngState(seed), n, dim, n_clusters=k,
                             cluster_std=1.0, device=device)
    rounds = telemetry.counter("raft_tpu_mst_fixup_rounds_total")

    # (a) KNN_GRAPH, the main path
    _reset(device)
    r0 = rounds.get()
    t0 = time.perf_counter()
    out = sl.single_linkage(x, metric, sl.LinkageDistance.KNN_GRAPH,
                            n_clusters=k, c=SL_C)
    secs = _synced_seconds(device, t0)
    launches = dict(native.LAUNCHES)
    fixups = rounds.get() - r0
    peak = (torch.cuda.max_memory_allocated() if device.type == "cuda"
            else None)
    ari = float(stats.adjusted_rand_index(truth, out.labels))
    # n − 1 merges of a forest (the dendrogram's union-find refuses a
    # cycle) whose last merge holds every point: one component
    check(out.children.shape == (n - 1, 2) and int(out.sizes[-1]) == n,
          "single_linkage: not n − 1 edges in one component")
    check(ari >= SL_ARI_FLOOR, f"single_linkage: ARI {ari} against the "
          f"blobs (at least {SL_ARI_FLOOR})")
    for name in PATH_KERNELS["single_linkage"]:
        check(launches[name] > 0, f"single_linkage never launched {name}")
    # the stages again, timed apart
    t0 = time.perf_counter()
    g = neighbors.knn_graph(x, metric, SL_C)
    knn_s = _synced_seconds(device, t0)
    del g
    t0 = time.perf_counter()
    src, dst, w = neighbors.mst_from_knn_graph(x, metric, SL_C)
    mst_s = _synced_seconds(device, t0) - knn_s
    t0 = time.perf_counter()
    children, deltas, sizes = sl.build_dendrogram_host(src, dst, w)
    labels = sl.extract_flattened_clusters(children, k, n)
    dendro_s = time.perf_counter() - t0
    twin = sl.build_dendrogram_numpy(src.cpu().numpy(), dst.cpu().numpy(),
                                     w.cpu().numpy())
    same = all(np.array_equal(a, b) for a, b in
               zip((children, deltas, sizes), twin))
    same_cut = np.array_equal(
        labels, sl.extract_flattened_clusters_numpy(children, k, n))
    check(same and same_cut, "single_linkage: the native dendrogram or cut "
          "differs from its numpy twin")
    knn_weight = _mst_weight(w)
    tile = knn_tile_row(device, x, metric, neighbors.build_k(n, SL_C))
    emit({"phase": "kernel", "name": "select_k@single_linkage_knn_tile",
          "library": "torch.topk", **tile})
    emit({"phase": "single_linkage", "part": "knn_graph", "n": n,
          "dim": dim, "n_clusters": k, "c": SL_C,
          "k": neighbors.build_k(n, SL_C), "card": smi, "seconds": secs,
          "knn_graph_s": knn_s, "mst_s": mst_s, "dendrogram_s": dendro_s,
          "fixup_rounds": fixups, "ari_vs_make_blobs": ari,
          "mst_weight": knn_weight, "native_equals_numpy": same and same_cut,
          "launches": launches, "peak_mem_bytes": peak})
    del src, dst, w, out

    # (b) PAIRWISE on the first rows; its matrix goes to scipy
    xs = x[:SL_PAIRWISE_ROWS].contiguous()
    ns = xs.shape[0]
    _reset(device)
    t0 = time.perf_counter()
    out = sl.single_linkage(xs, metric, sl.LinkageDistance.PAIRWISE,
                            n_clusters=k, c=SL_C)
    secs = _synced_seconds(device, t0)
    launches_pw = dict(native.LAUNCHES)
    pw_weight = float(np.asarray(out.deltas, np.float64).sum())
    _, _, w_knn = neighbors.mst_from_knn_graph(xs, metric, SL_C)
    knn_small = _mst_weight(w_knn)
    check(pw_weight <= knn_small * (1 + SL_MST_RTOL),
          f"single_linkage: PAIRWISE MST weight {pw_weight} above "
          f"KNN_GRAPH's {knn_small} on the same rows")
    d = distance(xs, xs, metric).fill_diagonal_(0).cpu().numpy()
    path = ROOT / "build" / "smoke_sl" / "pairwise.npy"
    path.parent.mkdir(parents=True, exist_ok=True)
    np.save(path, d)
    del d
    row = {"phase": "single_linkage", "part": "pairwise", "n": ns,
           "dim": dim, "n_clusters": k, "card": smi, "seconds": secs,
           "prim_steps": ns - 1, "mst_weight": pw_weight,
           "knn_graph_mst_weight": knn_small,
           "ari_vs_make_blobs": float(stats.adjusted_rand_index(
               truth[:ns], out.labels)),
           "launches": launches_pw}

    return ({name: launches[name] + launches_pw[name] for name in launches},
            tile, _ScipyCheck(path, pw_weight, ns, row))


def knn_tile_row(device, x, metric, kk: int):
    """B2 at the kNN graph's first tile (``knn_graph``'s batch of 4,096
    rows against all n, self-distances at +inf, k = *kk*): positions and
    values bit for bit the plain version's, and against ``torch.topk``
    through :func:`check_knn`; with its time, the plain version's,
    ``torch.topk``'s and the bound."""
    import torch

    from raft_tpu_torch.distance import distance
    from raft_tpu_torch.kernels import select_k as ksel
    from raft_tpu_torch.matrix.select_k import select_k_plain

    rows = min(4096, x.shape[0])
    d = distance(x[:rows], x, metric)
    ar = torch.arange(rows, device=device)
    d[ar, ar] = float("inf")
    kv, kp = ksel.select_k_blockwise(d, kk)
    pv, pp = select_k_plain(d, kk)
    check(torch.equal(kp, pp) and torch.equal(kv, pv),
          "select_k single_linkage knn tile: differs from the plain version")
    ref_d, ref_i = torch.topk(d, kk + 1, dim=1, largest=False)
    near = check_knn("select_k single_linkage knn tile vs torch.topk", kv,
                     kp, ref_d[:, :kk], ref_i[:, :kk], ref_d)
    nq, nl = d.shape
    b, by = bound_ms(4.0 * nq * nl + 8.0 * nq * kk, float(nq * nl))
    return dict(
        shape=[nq, nl, kk], max_abs_err=float((kv - ref_d[:, :kk]).abs()
                                              .max()),
        positions_equal_plain=True, ids_apart_at_near_ties_vs_topk=near,
        ms=timed(lambda: ksel.select_k_blockwise(d, kk), device, 5),
        plain_ms=timed(lambda: select_k_plain(d, kk), device, 3),
        library_ms=timed(lambda: torch.topk(d, kk, dim=1, largest=False),
                         device, 5),
        bound_ms=b, bound_by=by)


class _ScipyCheck:
    """The host reference MST of ``single_linkage`` (b): :meth:`finish`
    runs it in a process of its own (after the card's timed phases, so no
    timing shares the host with it), checks the weight and emits (b)'s
    line; :meth:`close` stops the process if it still runs and removes
    the matrix's file."""

    def __init__(self, path, weight, n, row):
        self.proc, self.path = None, path
        self.weight, self.n, self.row = weight, n, row

    def close(self):
        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self.path.unlink(missing_ok=True)

    def finish(self):
        t0 = time.perf_counter()
        try:
            self.proc = subprocess.Popen(
                [sys.executable, "-c", _SCIPY_MST, str(self.path)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            out, err = self.proc.communicate(timeout=SL_SCIPY_TIMEOUT_S)
        finally:
            self.close()
        check(self.proc.returncode == 0,
              f"single_linkage: scipy's MST failed: {err[-2000:]}")
        ref, nnz = out.split()
        ref = float(ref)
        rel = abs(self.weight - ref) / ref
        self.row.update({"scipy_mst_weight": ref,
                         "scipy_mst_edges": int(nnz),
                         "scipy_s": time.perf_counter() - t0,
                         "rel_err_vs_scipy": rel})
        emit(self.row)
        check(int(nnz) == self.n - 1 and rel <= SL_MST_RTOL,
              f"single_linkage: PAIRWISE MST weight {self.weight} against "
              f"scipy's {ref} (rel {rel}, edges {nnz})")


def _tfidf_rows(rng, rows, features, nnz, zipf):
    """TF-IDF-shaped CSR triplets: a row's nnz uniform in *nnz*, its
    features Zipf-like (p ∝ 1/(rank + 1)^zipf), values a positive term
    weight × the feature's idf."""
    counts = rng.integers(nnz[0], nnz[1] + 1, rows)
    p = 1.0 / np.arange(1, features + 1) ** zipf
    p /= p.sum()
    cols = rng.choice(features, int(counts.sum()), p=p).astype(np.int32)
    r = np.repeat(np.arange(rows, dtype=np.int32), counts)
    idf = np.log(1.0 / (p * features) + 1.0).astype(np.float32)
    vals = rng.uniform(0.5, 1.5, cols.shape[0]).astype(np.float32) * idf[cols]
    return r, cols, vals


def sparse_knn_phase(device, seed, smi):
    """``sparse_knn``: SPKNN["rows"] TF-IDF-shaped rows over
    SPKNN["features"] features, L2-normalised with ``row_normalize`` (the
    squared values' L1 rows, rooted), the first SPKNN["queries"] rows as
    queries, k = SPKNN["k"]: ``brute_force_knn`` under CosineExpanded and
    InnerProduct (the feature-compressed engine) against a
    ``torch.sparse`` CSR product and ``torch.topk``, and under L1 on a
    SPKNN["l1_features"]-feature variant (the densify engine, B5) against
    ``torch.cdist(p=1)`` on the densified rows; each with its launch
    counts reset.  Returns the launch counts of the three."""
    import torch

    from raft_tpu_torch import sparse
    from raft_tpu_torch.distance import DistanceType
    from raft_tpu_torch.kernels import native
    from raft_tpu_torch.sparse import neighbors

    c = SPKNN
    rng = np.random.default_rng(seed)
    n, f, k, nq = c["rows"], c["features"], c["k"], c["queries"]
    r, cols, vals = _tfidf_rows(rng, n, f, c["nnz"], c["zipf"])
    t0 = time.perf_counter()
    raw = sparse.from_triplets(r, cols, vals, (n, f), device=device)
    sq = sparse.row_normalize(sparse.CSR(raw.indptr, raw.indices,
                                         raw.data * raw.data, raw.shape))
    index = sparse.CSR(sq.indptr, sq.indices, torch.sqrt(sq.data), sq.shape)
    query = sparse.csr_row_slice(index, 0, nq)
    build_s = _synced_seconds(device, t0)
    norms = sparse.spmv(sparse.CSR(index.indptr, index.indices,
                                   index.data * index.data, index.shape),
                        torch.ones(f, device=device))
    check(bool(((norms - 1).abs() <= 1e-5).all()),
          "sparse_knn: rows not L2-normalised")
    csr_t = torch.sparse_csr_tensor(index.indptr.long(), index.indices.long(),
                                    index.data, size=(n, f))
    q_dense = sparse.csr_to_dense(query)
    total = {name: 0 for name in native.LAUNCHES}

    def run(metric, idx, qry, ref_d_full):
        _reset(device)
        t0 = time.perf_counter()
        d, i = neighbors.brute_force_knn(idx, qry, k, metric)
        secs = _synced_seconds(device, t0)
        launches = dict(native.LAUNCHES)
        peak = (torch.cuda.max_memory_allocated() if device.type == "cuda"
                else None)
        for key, v in launches.items():
            total[key] += v
        tie = torch.topk(ref_d_full, k + 1, dim=1, largest=False)
        ref = torch.topk(ref_d_full, k, dim=1, largest=False)
        near = check_knn(f"sparse_knn {metric.name}", d, i, ref.values,
                         ref.indices, tie.values)
        return {"seconds": secs, "qps": qry.shape[0] / secs,
                "ids_apart_at_near_ties": near, "launches": launches,
                "peak_mem_bytes": peak}

    ip = torch.sparse.mm(csr_t, q_dense.T).T.contiguous()   # (nq, n)
    rows = {}
    for metric, ref in ((DistanceType.CosineExpanded, 1.0 - ip),
                        (DistanceType.InnerProduct, ip)):
        rows[metric.name] = run(metric, index, query, ref)
    del ip, csr_t, q_dense
    emit({"phase": "sparse_knn", "part": "compressed", "rows": n,
          "features": f, "nnz": int(index.nnz), "queries": nq, "k": k,
          "card": smi, "build_s": build_s, **rows})

    # L1: the densify engine, B5
    r, cols, vals = _tfidf_rows(rng, n, c["l1_features"],
                                (c["l1_nnz"], c["l1_nnz"]), c["zipf"])
    small = sparse.from_triplets(r, cols, vals, (n, c["l1_features"]),
                                 device=device)
    small_q = sparse.csr_row_slice(small, 0, nq)
    dense = sparse.csr_to_dense(small)
    ref = torch.cdist(dense[:nq], dense, p=1)
    row = run(DistanceType.L1, small, small_q, ref)
    for name in PATH_KERNELS["sparse_knn"]:
        check(row["launches"][name] > 0,
              f"sparse_knn L1 never launched {name}")
    # the compressed engine runs no B5: its selects are the path's B2
    for metric, r in rows.items():
        for name in set(PATH_KERNELS["sparse_knn"]) - {"pairwise_accumulate"}:
            check(r["launches"][name] > 0,
                  f"sparse_knn {metric} never launched {name}")
    emit({"phase": "sparse_knn", "part": "densify", "rows": n,
          "features": c["l1_features"], "nnz": int(small.nnz),
          "queries": nq, "k": k, "card": smi, "L1": row})
    return total


#: the probe phase's kernels (B6, then B1 at the TPU probe's small shape)
PROBE_KERNELS = ("add_one", "fused_l2_nn")


def probe_phase(device, rep: int = 5):
    """The compile probe (``raft_tpu_torch.kernels.probe``): case (a)
    builds ``probe.cu`` alone and runs B6 on a 128 × 128 zero tensor (the
    result must be exactly x + 1), case (b) builds ``fused_l2nn.cu`` alone
    and runs B1 at 1,024 × 256 × 128 against its plain version.  Launch
    counts are reset just before and read just after.  A failed case
    prints its whole error text (nvcc's output, or the launch's) to stderr
    and fails the run.  Then B6's kernels-line row: exact on seeded
    values, the median device time of 5 calls beside its bytes bound, the
    host's cost of one call (back-to-back calls: the launch overhead, which
    is all this kernel's time), the plain version's and ``torch.add``'s.
    Returns (the row, the probe's launch counts)."""
    import torch

    from raft_tpu_torch.kernels import native, probe

    _reset(device)
    t0 = time.perf_counter()
    cases = probe.probe(device)
    launches = dict(native.LAUNCHES)
    seconds = _synced_seconds(device, t0)
    emit({"phase": "probe", "seconds": seconds,
          "cases": [{k: v for k, v in c.items() if k != "error"}
                    for c in cases]})
    for c in cases:
        if not c.get("ok"):
            print(f"chip_smoke: probe case {c['case']} failed:\n"
                  f"{c.get('error', 'result differs from the plain version')}",
                  file=sys.stderr, flush=True)
    check(all(c.get("ok") for c in cases), "probe: a case failed (stderr)")
    for name in PROBE_KERNELS:
        check(launches[name] > 0, f"probe: kernel {name} never launched")

    gen = torch.Generator(device=device).manual_seed(16)
    x = torch.randn(probe.ADD_ONE_SHAPE, generator=gen, device=device)
    got = probe.add_one(x)
    err = float((got - probe.add_one_plain(x)).abs().max())
    check(torch.equal(got, probe.add_one_plain(x)),
          f"add_one: not exactly x + 1 on seeded values ({err})")
    reps = 200
    probe.add_one(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        probe.add_one(x)
    torch.cuda.synchronize()
    host_us = (time.perf_counter() - t0) / reps * 1e6
    n_bytes = 2.0 * x.numel() * 4
    bound, by = bound_ms(n_bytes, float(x.numel()))
    row = dict(shape=list(probe.ADD_ONE_SHAPE), max_abs_err=err,
               build_s=cases[0].get("build_s"),
               b1_build_s=cases[1].get("build_s"),
               ms=timed(lambda: probe.add_one(x), device, rep),
               plain_ms=timed(lambda: probe.add_one_plain(x), device, rep),
               bound_ms=bound, bound_by=by,
               launch_overhead_us=host_us,
               library_ms=timed(lambda: torch.add(x, 1), device, rep))
    emit({"kernel": "add_one", **row})
    return row, launches


#: the dense phase's shapes: the reductions' and argmin's (bench/
#: bench_linalg.py, RAFT's cpp/bench/linalg: 16,384 × 1,024 float32), the
#: product's (4,096²), the symmetric eigenproblem's (4,096²), the RBF gram
#: matrix's (cuML SVC's default kernel: 16,384 × 16,384 × 128, 1 GiB out)
DENSE_REDUCE = (16_384, 1_024)
DENSE_GEMM = 4_096
DENSE_EIG = 4_096
DENSE_GRAM = (16_384, 128)
#: the rank of ``rsvd_fixed_rank`` on the blobs (oversampling 10)
DENSE_RSVD_K = 16
#: the LAP problems (cuGraph's Hungarian sizes): a batch of float32
#: uniform costs in [0, 100), and one problem of integer costs in [0, 1,000)
#: (2,048²: the launch-bound auction took 91–141 s at 4,096², more than
#: the smoke's time limit leaves it)
DENSE_LAP_BATCH = (8, 1_024)
DENSE_LAP_INT = (2_048, 1_000)
#: the least-squares coefficients against float64 ``torch.linalg.lstsq``
#: on the host, relative: κ(X)²·√m·u is 7.6e-5 for the normal equations
#: (``lstsq_eig``) at the blobs' κ ≈ 1.97 and m = 100,000 (float32 on the
#: host errs 2.6e-7–1.4e-6 there)
DENSE_LSTSQ_RTOL = 1e-4
#: a decomposition's reconstruction error and ‖VᵀV − I‖ on the card may be
#: at most DENSE_DECOMP_X times the CPU's on the same input, or
#: DENSE_DECOMP_FLOOR (float32 LAPACK gives 1e-6–3e-6 on these inputs);
#: singular and eigenvalues lie within DENSE_VALUE_RTOL of the CPU's,
#: relative to the largest
DENSE_DECOMP_X = 10.0
DENSE_DECOMP_FLOOR = 1e-5
DENSE_VALUE_RTOL = 1e-4
#: the labels' merge: the masked share of the rows and the labels_b range
DENSE_MERGE_MASKED = 0.01
DENSE_MERGE_B = 64


def _gamma(n: int) -> float:
    """γ(n) = n·u / (1 − n·u), u = 2⁻²⁴: the relative error bound of any
    float32 summation of n terms (against Σ|terms|)."""
    u = 2.0 ** -24
    return n * u / (1 - n * u)


def _rec_orth(a, u, s, v):
    """(relative Frobenius reconstruction error, max |VᵀV − I|)."""
    import torch

    rec = (a - (u * s[None, :]) @ v.T).norm() / a.norm()
    eye = torch.eye(v.shape[1], dtype=v.dtype, device=v.device)
    return float(rec), float((v.T @ v - eye).abs().max())


def _eig_metrics(a, v, w):
    """(‖AV − VΛ‖_F / ‖A‖_F, max |VᵀV − I|) of eigenpairs (v, w) of a."""
    import torch

    res = (a @ v - v * w[None, :]).norm() / a.norm()
    eye = torch.eye(v.shape[1], dtype=v.dtype, device=v.device)
    return float(res), float((v.T @ v - eye).abs().max())


def _held(name, card, cpu, what):
    check(card <= max(DENSE_DECOMP_X * cpu, DENSE_DECOMP_FLOOR),
          f"dense {name}: {what} {card} on the card against {cpu} on the "
          f"CPU")


def _lap_counts():
    from raft_tpu_torch import telemetry

    return {k: telemetry.counter(f"raft_tpu_lap_{k}_total").get()
            for k in ("phases", "rounds", "reads")}


def _merge_twin(labels_a, labels_b, mask):
    """numpy twin of ``merge_labels``: components of the union of the
    labels_a classes and, among masked rows, the labels_b classes; each
    row gets its component's least labels_a value."""
    import scipy.sparse
    import scipy.sparse.csgraph

    n = labels_a.shape[0]
    rows = [np.arange(n)]
    cols = [labels_a]
    idx = np.nonzero(mask)[0]
    first = {}
    for i in idx:
        first.setdefault(int(labels_b[i]), int(i))
    rows.append(idx)
    cols.append(np.array([first[int(labels_b[i])] for i in idx],
                         dtype=np.int64))
    r, c = np.concatenate(rows), np.concatenate(cols)
    g = scipy.sparse.coo_matrix((np.ones(r.shape[0]), (r, c)), shape=(n, n))
    _, comp = scipy.sparse.csgraph.connected_components(g, directed=False)
    low = np.full(comp.max() + 1, n, np.int64)
    np.minimum.at(low, comp, labels_a)
    return low[comp]


def dense_phase(device, seed: int, smi):
    """The dense long tail on the card (see the module docstring): each
    result held to its check, with its time.  The CPU's eigendecomposition
    of the 4,096² matrix runs on a thread of its own (6 of the host's
    threads) while the card works; every time but the LAP's is the card's
    or is taken before the LAP, and the LAP runs after the thread ended."""
    import concurrent.futures

    import scipy.optimize
    import torch

    from raft_tpu_torch import label, linalg, matrix, solver
    from raft_tpu_torch.distance import KernelParams, KernelType
    from raft_tpu_torch.distance import gram_matrix
    from raft_tpu_torch.random import RngState, make_blobs

    t_phase = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(seed + 16)
    out = {"card": smi}

    # the symmetric eigenproblem: its CPU result on a thread of its own
    g_cpu = torch.Generator().manual_seed(seed + 16)
    m = torch.randn(DENSE_EIG, DENSE_EIG, generator=g_cpu)
    sym_cpu = (m + m.T) / 2
    threads = torch.get_num_threads()
    torch.set_num_threads(max(1, min(threads, 6)))
    pool = concurrent.futures.ThreadPoolExecutor(1)
    try:
        eig_cpu = pool.submit(linalg.eig_dc, sym_cpu)
        # 1. reductions against the CPU's float64 result
        rows_, cols_ = DENSE_REDUCE
        x = torch.rand(rows_, cols_, generator=gen, device=device)
        x64 = x.double().cpu()
        red = {}
        cases = {
            "reduce": (lambda: linalg.reduce(x),
                       x64.sum(1), x64.abs().sum(1), cols_),
            "row_norm": (lambda: linalg.row_norm(x),
                         (x64 * x64).sum(1), (x64 * x64).sum(1), cols_),
            "col_norm": (lambda: linalg.col_norm(x),
                         (x64 * x64).sum(0), (x64 * x64).sum(0), rows_),
            "coalesced_reduction": (
                lambda: linalg.coalesced_reduction(x, main_op=torch.abs,
                                                   reduce_op=torch.fmax),
                x64.abs().amax(1), None, cols_),
        }
        for name, (fn, ref, mag, n_terms) in cases.items():
            got = fn().double().cpu()
            err = (got - ref).abs()
            if mag is None:    # a max is exact
                check(bool((err == 0).all()), f"dense {name}: not exact")
                share = float(err.max())
            else:
                bound = _gamma(n_terms) * mag
                check(bool((err <= bound).all()),
                      f"dense {name}: beyond γ(n)·Σ|x| of float64")
                share = float((err / bound.clamp_min(1e-300)).max())
            red[name] = {"ms": timed(fn, device), "bound_share": share,
                         "max_rel_err": float((err / ref.abs().clamp_min(
                             1e-300)).max())}
        got = linalg.normalize(x).double().cpu()
        ref = x64 / x64.norm(dim=1, keepdim=True)
        err = float((got - ref).abs().max())
        check(err <= _gamma(cols_) + 4 * 2.0 ** -24,
              f"dense normalize: {err} from float64")
        red["normalize"] = {"ms": timed(lambda: linalg.normalize(x), device),
                            "max_abs_err": err}
        b_bytes = 4.0 * rows_ * cols_
        out["reductions"] = {"shape": list(DENSE_REDUCE), "by_op": red,
                             "bytes_bound_ms": bound_ms(b_bytes, 0)[0]}
        got = matrix.argmin(x)
        check(torch.equal(got.cpu(), x64.argmin(1)),
              "dense argmin: differs from the CPU's")
        out["argmin"] = {"shape": list(DENSE_REDUCE),
                         "ms": timed(lambda: matrix.argmin(x), device),
                         "bytes_bound_ms": bound_ms(b_bytes, 0)[0]}
        del x, x64

        # 2. the product against float64
        n = DENSE_GEMM
        a = torch.rand(n, n, generator=gen, device=device)
        b = torch.rand(n, n, generator=gen, device=device)
        c64 = a.double() @ b.double()
        err = (linalg.gemm(a, b).double() - c64).abs()
        bound = _gamma(n) * c64       # the terms are non-negative
        check(bool((err <= bound).all()), "dense gemm: beyond γ(n)·Σ|ab|")
        fl_bound, fl_by = bound_ms(3 * 4.0 * n * n, 2.0 * n ** 3)
        out["gemm"] = {"n": n, "ms": timed(lambda: linalg.gemm(a, b), device),
                       "bound_ms": fl_bound, "bound_by": fl_by,
                       "bound_share": float((err / bound).max()),
                       "max_rel_err": float((err / c64).max())}
        del a, b, c64, err, bound

        # 3. least squares and SVDs on configs[1]'s blobs
        xb, lab, _ = make_blobs(RngState(seed), *KMEANS_SHAPE[:2],
                                n_clusters=KMEANS_SHAPE[2], cluster_std=1.0,
                                device=device)
        mrows, d = xb.shape
        w_true = torch.randn(d, generator=gen, device=device)
        yb = xb @ w_true + 0.01 * torch.randn(mrows, generator=gen,
                                              device=device)
        xb_h, yb_h = xb.double().cpu(), yb.double().cpu()
        s64 = torch.linalg.svdvals(xb_h)
        w64 = torch.linalg.lstsq(xb_h, yb_h[:, None]).solution[:, 0]
        ls = {}
        for fn in (linalg.lstsq_svd_qr, linalg.lstsq_eig, linalg.lstsq_qr,
                   linalg.lstsq_svd_jacobi):
            t0 = time.perf_counter()
            w = fn(xb, yb)
            sec = _synced_seconds(device, t0)
            rel = float((w.double().cpu() - w64).norm() / w64.norm())
            check(rel <= DENSE_LSTSQ_RTOL,
                  f"dense {fn.__name__}: coefficients {rel} from float64")
            ls[fn.__name__] = {"s": sec, "rel_err": rel}
        out["lstsq"] = {"shape": [mrows, d],
                        "kappa": float(s64[0] / s64[-1]), "by_algo": ls}
        xf = xb_h.float()
        svd = {}
        omega_h = torch.randn(d, DENSE_RSVD_K + 10, generator=g_cpu)
        for name, fn in (
                ("svd_qr", linalg.svd_qr), ("svd_eig", linalg.svd_eig),
                ("rsvd_fixed_rank", lambda a_: linalg.rsvd_fixed_rank(
                    a_, DENSE_RSVD_K, omega=omega_h.to(a_.device)))):
            t0 = time.perf_counter()
            u_, s_, v_ = fn(xb)
            sec = _synced_seconds(device, t0)
            rec, orth = _rec_orth(xb, u_, s_, v_)
            uc, sc, vc = fn(xf)
            rec_c, orth_c = _rec_orth(xf, uc, sc, vc)
            val = float((s_.cpu() - sc).abs().max() / sc[0])
            if name == "rsvd_fixed_rank":
                # a rank-16 approximation: its error is the spectrum's
                # tail, which both must find alike
                check(abs(rec - rec_c) <= DENSE_VALUE_RTOL,
                      f"dense {name}: reconstruction {rec} against {rec_c}")
            else:
                _held(name, rec, rec_c, "reconstruction error")
            _held(name, orth, orth_c, "‖VᵀV − I‖")
            check(val <= DENSE_VALUE_RTOL,
                  f"dense {name}: singular values {val} from the CPU's")
            svd[name] = {"s": sec, "rec": rec, "cpu_rec": rec_c,
                         "orth": orth, "cpu_orth": orth_c,
                         "value_rel_err": val}
        out["svd"] = {"shape": [mrows, d], "rsvd_k": DENSE_RSVD_K,
                      "by_algo": svd}
        del xb_h, yb_h, xf

        # 4. the symmetric eigenproblem
        sym = sym_cpu.to(device)
        eig = {}
        for name, fn in (("eig_dc", linalg.eig_dc),
                         ("eig_sel_dc", lambda a_: linalg.eig_sel_dc(
                             a_, DENSE_RSVD_K))):
            t0 = time.perf_counter()
            v_, w_ = fn(sym)
            sec = _synced_seconds(device, t0)
            eig[name] = (sec, _eig_metrics(sym, v_, w_), w_.cpu())
        vc, wc = eig_cpu.result()
    finally:
        pool.shutdown(wait=True)
        torch.set_num_threads(threads)
    top = float(wc.abs().max())
    for name, (sec, (res, orth), w_) in eig.items():
        k_ = w_.shape[0]
        res_c, orth_c = _eig_metrics(sym_cpu, vc[:, :k_], wc[:k_])
        val = float((w_ - wc[:k_]).abs().max() / top)
        _held(name, res, res_c, "eigen residual")
        _held(name, orth, orth_c, "‖VᵀV − I‖")
        check(val <= DENSE_VALUE_RTOL,
              f"dense {name}: eigenvalues {val} from the CPU's")
        eig[name] = {"s": sec, "residual": res, "cpu_residual": res_c,
                     "orth": orth, "cpu_orth": orth_c, "value_rel_err": val}
    out["eig"] = {"n": DENSE_EIG, "by_algo": eig}
    del sym, sym_cpu, m, vc, wc

    # 5. the RBF gram matrix, gamma 'scale' (cuML SVC's default)
    gx = xb[:DENSE_GRAM[0], :DENSE_GRAM[1]].contiguous()
    gamma = float(1.0 / (gx.shape[1] * gx.var()))
    params = KernelParams(kernel=KernelType.RBF, gamma=gamma)
    k_mat = gram_matrix(gx, gx, params)
    blk = 256
    g64 = gx.double()
    d64 = torch.cdist(g64[:blk], g64) ** 2
    ref = torch.exp(-gamma * d64)
    nrm = (g64[:blk] ** 2).sum(1)[:, None] + (g64 ** 2).sum(1)[None, :]
    # float32's expanded form errs at most (2γ(d) + 3u)·(‖x‖² + ‖y‖²) in
    # the squared distance (two norms and a product of d terms, two adds),
    # u·γ·sq in the scaling; K then errs that times gamma, relative, plus
    # exp's own few ulp
    u = 2.0 ** -24
    tol = ref * torch.expm1(gamma * ((2 * _gamma(gx.shape[1]) + 3 * u) * nrm
                                     + u * d64)) + 4 * u * ref
    err = (k_mat[:blk].double() - ref).abs()
    check(bool((err <= tol).all()), "dense gram RBF: beyond its bound")
    gn = DENSE_GRAM[0]
    g_bound, g_by = bound_ms(4.0 * (gn * gn + 2 * gn * DENSE_GRAM[1]),
                             2.0 * gn * gn * DENSE_GRAM[1])
    out["gram_rbf"] = {"shape": [gn, gn, DENSE_GRAM[1]], "gamma": gamma,
                       "ms": timed(lambda: gram_matrix(gx, gx, params),
                                   device, 3),
                       "bound_ms": g_bound, "bound_by": g_by,
                       "bytes_bound_ms": bound_ms(4.0 * gn * gn, 0)[0],
                       "max_abs_err": float(err.max()),
                       "bound_share": float((err / tol).max())}
    del k_mat, g64, d64, ref, nrm, tol, err

    # 6. labels on the blobs' 100,000 labels
    lab_h = lab.cpu().numpy().astype(np.int64)
    lab_h = (lab_h * 7919) % 100_003        # spread the values apart
    twin = np.unique(lab_h, return_inverse=True)[1]
    t0 = time.perf_counter()
    host = label.make_monotonic(lab_h, device=device)
    mono_host_s = _synced_seconds(device, t0)
    t0 = time.perf_counter()
    dev_lab = label.make_monotonic(torch.as_tensor(lab_h, device=device))
    mono_dev_s = _synced_seconds(device, t0)
    check(np.array_equal(host.cpu().numpy(), twin)
          and np.array_equal(dev_lab.cpu().numpy(), twin),
          "dense make_monotonic: differs from numpy's")
    rng = np.random.default_rng(seed + 16)
    nl = lab_h.shape[0]
    first = np.full(lab_h.max() + 1, nl, np.int64)
    np.minimum.at(first, lab_h, np.arange(nl))
    labels_a = first[lab_h]
    labels_b = rng.integers(0, DENSE_MERGE_B, nl)
    mask = rng.random(nl) < DENSE_MERGE_MASKED
    t0 = time.perf_counter()
    merged = label.merge_labels(labels_a, labels_b, mask, device=device)
    merge_s = _synced_seconds(device, t0)
    want = _merge_twin(labels_a, labels_b, mask)
    check(np.array_equal(merged.cpu().numpy(), want),
          "dense merge_labels: differs from its numpy twin")
    out["labels"] = {"n": nl, "make_monotonic_host_s": mono_host_s,
                     "make_monotonic_card_s": mono_dev_s,
                     "merge_labels_s": merge_s,
                     "components": int(np.unique(want).shape[0])}
    del xb, yb, lab

    # 7. the LAP solver against scipy
    bsz, n = DENSE_LAP_BATCH
    costs = torch.rand(bsz, n, n, generator=gen, device=device) * 100
    before = _lap_counts()
    t0 = time.perf_counter()
    res = solver.solve_lap(costs)
    lap_s = _synced_seconds(device, t0)
    counts = {k: v - before[k] for k, v in _lap_counts().items()}
    c_h = costs.cpu().numpy()
    spread = float(costs.max() - costs.min())
    eps_eff = max(1e-6, spread * 8 * 2.0 ** -23)
    t0 = time.perf_counter()
    opt = []
    for i in range(bsz):
        r_, c_ = scipy.optimize.linear_sum_assignment(c_h[i])
        opt.append(float(c_h[i][r_, c_].astype(np.float64).sum()))
    scipy_s = time.perf_counter() - t0
    r2c = res.row_assignment.cpu().numpy()
    gaps = []
    for i in range(bsz):
        check(np.array_equal(np.sort(r2c[i]), np.arange(n)),
              f"dense solve_lap: problem {i} is not a permutation")
        got = float(c_h[i][np.arange(n), r2c[i]].astype(np.float64).sum())
        gaps.append(got - opt[i])
        # n·ε_eff, plus the float32 rounding of the costs' sum
        check(got - opt[i] <= n * eps_eff + _gamma(n) * got,
              f"dense solve_lap: problem {i} {got} against scipy's {opt[i]}")
    check(bool(res.converged.all()), "dense solve_lap: not converged")
    lap = {"batch": {"shape": [bsz, n, n], "s": lap_s, "scipy_s": scipy_s,
                     **counts,
                     "eps_eff": eps_eff, "max_gap": max(gaps),
                     "max_residual": float(res.residual.max())}}
    n, hi = DENSE_LAP_INT
    ci = torch.randint(0, hi, (n, n), generator=gen, device=device)
    before = _lap_counts()
    t0 = time.perf_counter()
    res = solver.solve_lap(ci, epsilon=1.0 / (2 * n))
    lap_s = _synced_seconds(device, t0)
    counts = {k: v - before[k] for k, v in _lap_counts().items()}
    ci_h = ci.cpu().numpy()
    t0 = time.perf_counter()
    r_, c_ = scipy.optimize.linear_sum_assignment(ci_h)
    scipy_s = time.perf_counter() - t0
    opt = int(ci_h[r_, c_].sum())
    r2c = res.row_assignment.cpu().numpy()
    check(np.array_equal(np.sort(r2c), np.arange(n)),
          "dense solve_lap: the integer problem is not a permutation")
    got = int(ci_h[np.arange(n), r2c].sum())
    check(got == opt and bool(res.converged),
          f"dense solve_lap: integer objective {got} against scipy's {opt}")
    lap["integer"] = {"shape": [n, n], "costs_below": hi, "s": lap_s,
                      **counts,
                      "scipy_s": scipy_s, "objective": got,
                      "dtype": str(res.objective.dtype),
                      "residual": float(res.residual)}
    out["lap"] = lap
    out["seconds"] = time.perf_counter() - t_phase
    emit({"phase": "dense", **out})


# ---------------------------------------------------------------------------
# the AOT core and the program audit

#: the longest the aot phase's fresh process may take
AOT_CHILD_TIMEOUT_S = 300
#: configs[0]'s own shape: pairwise_distance L2SqrtExpanded, 5,000 × 5,000
#: × 50 float32 (BASELINE.json configs[0])
CONFIG0_SHAPE = (5_000, 5_000, 50)


def aot_child(seed: int) -> int:
    """The aot phase's fresh process: ``prewarm()`` over the build
    directory the smoke filled (nothing may build), each signature's
    first and warm call, B1 / B2 / B5 at prewarmed signatures against
    their plain versions (B1 and B5 at both grid shapes, the k-means tile
    and configs[0]'s 5,000 × 5,000 × 50), configs[0] against float64, and
    the grid again with ``aot_compile_counters["compiles"]`` flat.  One
    JSON line each; exits non-zero on a failed check."""
    import torch

    from raft_tpu_torch import prewarm
    from raft_tpu_torch.core import aot_compile_counters
    from raft_tpu_torch.distance import pairwise_distance
    from raft_tpu_torch.distance.fused_l2_nn import (fused_l2_nn,
                                                     fused_l2_nn_plain)
    from raft_tpu_torch.distance.distance_types import DistanceType
    from raft_tpu_torch.distance.pairwise import _dispatch
    from raft_tpu_torch.kernels import native
    from raft_tpu_torch.matrix.select_k import select_k, select_k_plain

    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    smi = nvidia_smi()
    try:
        native.reset_launches()
        t0 = time.perf_counter()
        r = prewarm(device=device)
        seconds = time.perf_counter() - t0
        check(native.BUILDS["compiled"] == 0,
              f"aot: prewarm built {native.BUILDS['compiled']} libraries "
              "in a process whose cache held them")
        emit({"phase": "aot_prewarm", "nvidia_smi": smi,
              "seconds": seconds, "n_signatures": r["n_signatures"],
              "cache_dir": r["cache_dir"], "builds": dict(native.BUILDS)})
        gen = torch.Generator(device=device).manual_seed(seed + 17)
        sigs = [{"name": g["name"], "first_ms": 1e3 * g["first_s"],
                 "warm_ms": 1e3 * g["warm_s"], "nvidia_smi": smi}
                for g in r["signatures"]]
        # B1 and B5 (L1) at both grid shapes, B2 at the select grid:
        # prewarmed signatures, held to the plain versions
        c0 = aot_compile_counters["compiles"]
        shape_rows = []
        for m, n, k in ((2048, 1024, 128), CONFIG0_SHAPE):
            x = torch.randn((m, k), generator=gen, device=device)
            y = torch.randn((n, k), generator=gen, device=device)
            kv = fused_l2_nn(x, y)
            pv, pi = fused_l2_nn_plain(x, y)
            same = float((kv.key == pi).float().mean())
            check(same > 0.999, f"aot: B1 ids at {m} × {n} × {k} agree "
                  f"with the plain version on {same} of the rows")
            b1_err = float((kv.value - pv).abs().max())
            check(b1_err <= 1e-4 * float(pv.abs().max() + 1),
                  f"aot: B1 values at {m} × {n} × {k}: {b1_err}")
            d5 = pairwise_distance(x, y, "l1", device=device)
            # the plain version through the unkeyed dispatch: another
            # engine is another signature
            p5 = _dispatch(x, y, DistanceType.L1, 2.0, "torch")
            b5_err = float((d5 - p5).abs().max())
            check(torch.allclose(d5, p5, rtol=1e-5, atol=1e-5),
                  f"aot: B5 L1 at {m} × {n} × {k}: max error {b5_err}")
            shape_rows.append({"shape": [m, n, k], "b1_ids_equal": same,
                               "b1_max_abs_err": b1_err,
                               "b5_l1_max_abs_err": b5_err})
        v = torch.randn((1024, 1000), generator=gen, device=device)
        sv, si = select_k(v, 40)
        pv2, pi2 = select_k_plain(v, 40)
        check(torch.equal(sv, pv2) and torch.equal(si, pi2),
              "aot: B2 differs from its plain version")
        check(aot_compile_counters["compiles"] == c0,
              "aot: a prewarmed signature compiled again")
        emit({"phase": "aot_signatures", "nvidia_smi": smi,
              "signatures": sigs})
        emit({"phase": "aot_checks", "nvidia_smi": smi,
              "shapes": shape_rows, "b2_bit_exact": True})
        # configs[0] at its own shape against float64
        m0, n0, k0 = CONFIG0_SHAPE
        x0 = torch.randn((m0, k0), generator=gen, device=device)
        y0 = torch.randn((n0, k0), generator=gen, device=device)
        c1 = aot_compile_counters["compiles"]
        d0 = pairwise_distance(x0, y0, "euclidean", device=device)
        torch.cuda.synchronize()
        t = time.perf_counter()
        reps = 5
        for _ in range(reps):
            pairwise_distance(x0, y0, "euclidean", device=device)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t) / reps
        d64 = torch.cdist(x0.double(), y0.double())
        norms = (x0.double().square().sum(1)[:, None]
                 + y0.double().square().sum(1)[None, :])
        sq_err = float(((d0.double() ** 2 - d64 ** 2).abs()
                        / norms).max())
        abs_err = float((d0.double() - d64).abs().max())
        check(sq_err <= 1e-5,
              f"configs[0]: squared distances off float64 by {sq_err} "
              "of ‖x‖² + ‖y‖²")
        check(aot_compile_counters["compiles"] == c1,
              "configs[0]: the prewarmed signature compiled again")
        emit({"phase": "config0", "nvidia_smi": smi,
              "shape": list(CONFIG0_SHAPE), "metric": "L2SqrtExpanded",
              "max_abs_err": abs_err, "max_sq_err_of_norms": sq_err,
              "ms": ms, "bytes_bound_ms": 1e3 * 4 * (m0 * k0 + n0 * k0
                                                     + m0 * n0) / 3.35e12})
        c2 = aot_compile_counters["compiles"]
        r2 = prewarm(device=device)
        check(aot_compile_counters["compiles"] == c2,
              "aot: repeating the grid compiled again")
        emit({"phase": "aot_repeat", "nvidia_smi": smi,
              "seconds": r2["seconds"], "compiles_added": 0,
              "launches": dict(native.LAUNCHES)})
    except CheckFailed as e:
        print(f"chip_smoke: check failed: {e}", file=sys.stderr)
        return 1
    return 0


def aot_phase(device, seed: int, smi):
    """Run :func:`aot_child` in a fresh process (see the module doc) and
    relay its lines; returns its launch counts."""
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, str(pathlib.Path(__file__)),
                          "--aot-child", "--seed", str(seed)],
                         capture_output=True, text=True,
                         timeout=AOT_CHILD_TIMEOUT_S,
                         cwd=str(pathlib.Path(__file__).resolve().parent))
    launches = {}
    for line in out.stdout.splitlines():
        print(line, flush=True)
        if line.startswith('{"phase": "aot_repeat"'):
            launches = json.loads(line)["launches"]
    if out.returncode != 0:
        print(out.stderr, file=sys.stderr)
    check(out.returncode == 0, f"aot: the fresh process exited "
          f"{out.returncode}")
    emit({"phase": "aot", "nvidia_smi": smi,
          "seconds": time.perf_counter() - t0})
    return launches


#: the build phases' compile check: rows of the smoke's data built twice
#: per IVF family, and rows extended into the first build twice
BUILD_CHECK_ROWS = 100_000
BUILD_CHECK_EXTEND = 20_000


def build_compiles_phase(device, x, n_lists: int, smi):
    """The ``build_compiles`` line: each IVF family built twice from the
    same BUILD_CHECK_ROWS rows (the populate's tiles keyed), then
    BUILD_CHECK_EXTEND rows extended into the first build twice; the
    second build and the second extend make no first call of a keyed
    program (the list slots, the scatters, the encode tiles, the
    selections and the E-steps all run warm signatures)."""
    from raft_tpu_torch.neighbors import ivf_flat, ivf_pq

    xs = x[:BUILD_CHECK_ROWS]
    xe = x[BUILD_CHECK_ROWS:BUILD_CHECK_ROWS + BUILD_CHECK_EXTEND]
    row = {"phase": "build_compiles", "rows": int(xs.shape[0]),
           "extend_rows": int(xe.shape[0]), "card": smi}
    for kind, mod in (("ivf_flat", ivf_flat), ("ivf_pq", ivf_pq)):
        params = mod.IndexParams(n_lists=n_lists)
        c = [compiles()]
        t0 = time.perf_counter()
        first = mod.build(params, xs, device=device)
        c.append(compiles())
        mod.build(params, xs, device=device)
        c.append(compiles())
        mod.extend(first, xe)
        c.append(compiles())
        mod.extend(first, xe)
        c.append(compiles())
        res = {"first_build_compiles": c[1] - c[0],
               "second_build_compiles": c[2] - c[1],
               "first_extend_compiles": c[3] - c[2],
               "second_extend_compiles": c[4] - c[3],
               "seconds": _synced_seconds(device, t0)}
        row[kind] = res
        check(res["second_build_compiles"] == 0
              and res["second_extend_compiles"] == 0,
              f"build_compiles {kind}: a second build or extend at the same "
              f"shapes made first calls ({res})")
    emit(row)


def retrace_phase():
    """The ``retrace`` line: the retrace-closure certifier
    (``raft_tpu_torch.analysis.retrace``) over this checkout's sources,
    in process; any failed obligation fails the run."""
    import io

    from raft_tpu_torch.analysis import retrace

    t0 = time.perf_counter()
    out = io.StringIO()
    reports, failed = retrace.run(out=out)
    row = {"phase": "retrace", "obligations": len(reports),
           "certified": sum(r.status == "ok" for r in reports),
           "failed": failed, "seconds": time.perf_counter() - t0,
           "failures": {r.name: r.findings for r in reports
                        if r.status == "fail"}}
    emit(row)
    check(failed == 0, f"retrace: {failed} obligation(s) failed: "
          f"{out.getvalue()[-2000:]}")


def audit_phase(device, smi, golden_dir=None):
    """``program_audit`` over every registered program on the card: one
    line per program (syncs, launches by kernel, collectives, transient
    bytes against their budgets, its fingerprint); any miss fails.  The
    fingerprints are diffed against committed goldens of the card's scope
    (another scope's: skipped), and written under *golden_dir* when one
    is given."""
    import io

    from raft_tpu_torch.analysis import fingerprint, program_audit, registry
    from raft_tpu_torch.kernels import native

    import torch

    t0 = time.perf_counter()
    # the counter itself first: one .item() is one sync, a product none
    for fn, want in ((lambda t: t.sum().item(), 1), (lambda t: t @ t, 0)):
        probe = registry.ProgramEntry("audit.sync_probe", lambda d: dict(
            fn=fn, args=(torch.ones((4, 4), device=d),)))
        got = program_audit.measure(probe, device)["host_reads"]
        check(got == want, f"audit: the sync counter saw {got} syncs, "
              f"not {want}")
    native.reset_launches()
    entries = registry.iter_programs()
    recs = program_audit.measure_all(entries, device)
    launches = dict(native.LAUNCHES)
    failed = []
    fps = {}
    for e in entries:
        rec = recs[e.name]
        if "error" in rec:
            failed.append(f"{e.name}: {rec['error']}")
            emit({"phase": "audit", "program": e.name, "nvidia_smi": smi,
                  "status": "fail", "error": rec["error"]})
            continue
        findings = program_audit.check(e, rec)
        failed += [f"{e.name}: {f}" for f in findings]
        fps[e.name] = fingerprint.of(rec)
        emit({"phase": "audit", "program": e.name, "nvidia_smi": smi,
              "status": "fail" if findings else "ok",
              "host_syncs": rec["host_reads"],
              "host_syncs_budget": e.host_reads,
              "sync_sites": rec["sync_sites"],
              "launches": rec["launches"],
              "collectives": rec["collectives"],
              "collectives_budget": e.collectives,
              "collective_bytes": rec["collective_bytes"],
              "collective_bytes_budget": e.collective_bytes,
              "transient_bytes": rec["transient_bytes"],
              "transient_bytes_budget": e.transient_bytes,
              "requested_bytes": rec["requested_bytes"],
              "against_plain": rec["plain"],
              "findings": findings, "fingerprint": fps[e.name]})
    out = io.StringIO()
    reports, drift = fingerprint.compare(fps, sorted(fps), out=out)
    if golden_dir:
        fingerprint.compare(fps, sorted(fps), golden_dir=golden_dir,
                            update=True, out=io.StringIO())
    emit({"phase": "audit_fingerprints", "nvidia_smi": smi,
          "scope": program_audit.scope(device),
          "status": {r.name: r.status for r in reports},
          "drift": {r.name: r.findings for r in reports if r.findings}})
    check(not failed, f"audit: {failed}")
    check(drift == 0, f"audit: fingerprint drift {out.getvalue()}")
    emit({"phase": "audit_summary", "nvidia_smi": smi,
          "programs": len(entries), "seconds": time.perf_counter() - t0})
    return launches


def run(device, n: int, n_queries: int, dim: int, n_lists: int,
        n_probes: int, k: int, seed: int, rep: int = 5,
        profile: bool = False, probe=None, golden_dir=None):
    """The phases after the kernel build; returns the kernels' rows.
    *probe* is the probe phase's (B6 row, launch counts); *golden_dir*
    receives the audit's fingerprints."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(seed)
    comps = torch.randn(4 * n_lists, dim, generator=gen, device=device)
    x = mixture(gen, n, dim, comps, 0.7, device)
    queries = mixture(gen, n_queries, dim, comps, 0.7, device)
    probe_centers = mixture(gen, n_lists, dim, comps, 0.7, device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    emit({"phase": "data", "n": n, "dim": dim, "queries": n_queries,
          "seed": seed, "seconds": time.perf_counter() - t0})

    rows = kernel_phase(device, x, queries, probe_centers, rep)
    smi = nvidia_smi() if device.type == "cuda" else "cpu"
    launches_km, km_rows, km_state = kmeans_path(device, seed, rep, smi)

    q_host = queries.cpu().numpy()
    reqs, calls = ragged_calls(q_host, n_queries)
    nr = min(1000, n_queries)
    qr = queries[:nr]
    dist = torch.cdist(qr, x, compute_mode="donot_use_mm_for_euclid_dist")
    truth = torch.topk(dist, k, dim=1, largest=False).indices
    del dist
    args = (device, x, reqs, calls, n_queries, truth, qr, n_lists, n_probes,
            k)
    from raft_tpu_torch.neighbors import ivf_flat, ivf_pq

    gen_m = torch.Generator(device=device).manual_seed(seed + 7)

    def fresh(rows):
        """Fresh vectors from the dataset's mixture (the upserts)."""
        return mixture(gen_m, rows, dim, comps, 0.7, device)

    eng_flat, launches_flat, served = ivf_flat_path(*args)
    resident = {"ivf_flat": (served, eng_flat.index)}
    resident_flat = served.results
    stream_flat = serve_stream("ivf_flat", device, served, q_host, n_queries,
                               smi, seed)
    mut_flat = mutable_path(
        "ivf_flat", device, eng_flat.index, x,
        ivf_flat.IndexParams(n_lists=n_lists),
        ivf_flat.SearchParams(n_probes=n_probes), calls, n_queries, qr,
        truth, k, fresh, smi, seed)
    index_pq, eng_pq, launches_pq, served = ivf_pq_path(*args)
    build_compiles_phase(device, x, n_lists, smi)
    resident["ivf_pq"] = (served, index_pq)
    resident_pq = served.results
    stream_pq = serve_stream("ivf_pq", device, served, q_host, n_queries,
                             smi, seed, refresh_index=index_pq)
    launches_tune = autotune_phase(device, eng_pq, index_pq, x, reqs, calls,
                                   resident_pq, truth, k, seed, smi)
    rows["lut_score"] = lut_phase(device, index_pq, queries, rep)
    rows["lut_scan"], rows["lut_scan_tombstones"] = lut_scan_phase(
        device, index_pq, queries, n_probes, k, rep, seed)
    index_pc, launches_pc = ivf_pq_per_cluster_path(*args)
    launches_legacy, rows["lut_score"]["by_sum"] = ivf_pq_variants_phase(
        device, index_pq, qr, truth, n_probes, k, rep)
    rows["lut_scan"]["by_variant"] = lut_scan_variants_phase(
        device, index_pc, index_pq, queries, n_probes, k, rep)
    del index_pc
    tiered_args = (q_host, reqs, calls, n_queries, qr, truth, n_probes, k,
                   smi, seed)
    launches_tf = tiered_path("ivf_flat", device, eng_flat.index, x,
                              resident_flat, *tiered_args)
    launches_tp = tiered_path("ivf_pq", device, index_pq, x, resident_pq,
                              *tiered_args)
    approx_knn_phase(device, eng_flat.index, index_pq, queries, n_probes, k)
    launches_handle = handle_phase(device, index_pq, eng_flat.index, x,
                                   queries, n_probes, k, smi)
    mut_pq = mutable_path(
        "ivf_pq", device, index_pq, x, ivf_pq.IndexParams(n_lists=n_lists),
        ivf_pq.SearchParams(n_probes=n_probes), calls, n_queries, qr, truth,
        k, fresh, smi, seed)
    eng_bf, launches_bf, served = brute_force_path(device, x, queries, reqs,
                                                   calls, n_queries, qr, k)
    resident["brute_force"] = (served, x)
    stream_bf = serve_stream("brute_force", device, served, q_host,
                             min(1024, n_queries), smi, seed,
                             rates=STREAM_RATES[:1], checks=False)
    from raft_tpu_torch.neighbors import brute_force

    flat_params = ivf_flat.SearchParams(n_probes=n_probes)
    launches_dt = serve_dtypes_phase(device, {
        "brute_force": (eng_bf, lambda q: brute_force.knn(
            x, q, k, "l1", device=device)),
        "ivf_flat": (eng_flat, lambda q: ivf_flat.search(
            flat_params, eng_flat.index, q, k))}, q_host, n_queries, smi)
    km_data = (km_state[0], km_state[2])
    mnmg_km, mnmg_knn, world1 = mnmg_phase(device, seed, km_data, x,
                                           queries, k, smi)
    mnmg_km_w2, mnmg_knn_w2 = mnmg_w2_phase(device, seed, km_data, x,
                                            queries, n_lists, k, world1,
                                            smi)
    del world1
    launches_sh, world1_sh, qps_sh = sharded_phase(
        device, x, q_host, reqs, calls, n_queries, n_lists, n_probes, k,
        resident, smi, profile)
    launches_sh_w2 = sharded_w2_phase(device, seed, x, queries, n_lists,
                                      n_probes, k, resident, world1_sh,
                                      qps_sh, smi)
    del world1_sh
    launches_rep = replica_w2_phase(device, seed, x, queries, n_lists,
                                    n_probes, k, resident, smi)
    launches_sh_mut, world1_mut, qps_mut = sharded_mutable_phase(
        device, seed, x, queries, calls, n_queries, n_lists, n_probes, k,
        resident, smi)
    launches_sh_mut_w2 = sharded_mutable_w2_phase(
        device, seed, x, queries, n_lists, n_probes, k, resident,
        world1_mut, qps_mut, smi)
    del resident, world1_mut
    pairwise_distance_phase(device, rep)
    rows["pairwise_accumulate"] = pairwise_kernel_phase(device, x, queries,
                                                        rep)
    launches_bc = ball_cover_phase(device, n_lists, seed, smi)
    launches_eps = eps_phase(device, x, queries, qr, truth, smi)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    launches_sl, sl_tile, scipy_check = single_linkage_phase(device, seed,
                                                              smi)
    rows["select_k"]["single_linkage_shapes"] = {"knn_graph_tile": sl_tile}
    try:
        launches_spec, spec_rows = spectral_phase(device, seed, smi)
        launches_spknn = sparse_knn_phase(device, seed, smi)
        scipy_check.finish()
    finally:
        scipy_check.close()
    for name, fields in spec_rows.items():
        rows[name]["spectral_shapes"] = fields
    dense_phase(device, seed, smi)
    retrace_phase()
    launches_aot = aot_phase(device, seed, smi)
    launches_audit = audit_phase(device, smi, golden_dir)
    for path, counts in (("aot", launches_aot), ("audit", launches_audit)):
        missing = [kk for kk in PATH_KERNELS[path] if not counts.get(kk)]
        check(not missing, f"{path}: kernels never launched: {missing}")
    launches_probe = {name: 0 for name in launches_spknn}
    if probe is not None:
        rows["add_one"], launches_probe = probe
    by_path = {"probe": launches_probe, "ivf_flat": launches_flat,
               "ivf_flat_stream": stream_flat, "ivf_flat_mutable": mut_flat,
               "ivf_pq": launches_pq, "ivf_pq_stream": stream_pq,
               "ivf_pq_mutable": mut_pq, "ivf_pq_per_cluster": launches_pc,
               "ivf_pq_legacy": launches_legacy,
               "tiered_ivf_flat": launches_tf, "tiered_ivf_pq": launches_tp,
               "brute_force": launches_bf, "brute_force_stream": stream_bf,
               "autotune": launches_tune, "ball_cover": launches_bc,
               "eps": launches_eps, "mnmg_km": mnmg_km,
               "mnmg_km_w2": mnmg_km_w2, "mnmg_knn": mnmg_knn,
               "mnmg_knn_w2": mnmg_knn_w2, "serve_dtypes": launches_dt,
               "sharded": launches_sh, "sharded_w2": launches_sh_w2,
               "replica_w2": launches_rep,
               "sharded_mutable": launches_sh_mut,
               "sharded_mutable_w2": launches_sh_mut_w2,
               "single_linkage": launches_sl, "spectral": launches_spec,
               "sparse_knn": launches_spknn, "aot": launches_aot,
               "audit": launches_audit, "handle": launches_handle,
               **launches_km}
    for name, fields in km_rows.items():
        rows[name]["kmeans_shapes"] = fields
    for name, row in rows.items():
        row["launches_by_path"] = {p: c.get(name, 0)
                                   for p, c in by_path.items()}
        row["launches"] = sum(row["launches_by_path"].values())
    if profile:
        profile_serve("ivf_flat", eng_flat, q_host, device)
        profile_serve("ivf_pq", eng_pq, q_host, device)
        profile_serve("brute_force", eng_bf, q_host, device)
        profile_build("ivf_flat", device, x, n_lists)
        profile_build("ivf_pq", device, x, n_lists)
        profile_kmeans(device, *km_state[:2])
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--queries", type=int, default=10_000)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--n-lists", type=int, default=1024)
    ap.add_argument("--n-probes", type=int, default=20)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also trace one 1024-query super-batch of each "
                    "engine, the builds and the k-means init with "
                    "torch.profiler and print device time by kernel")
    ap.add_argument("--golden-dir", default=None,
                    help="write the audit's fingerprints under this "
                    "directory (<scope>/<program>.json)")
    ap.add_argument("--aot-child", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    try:
        from raft_tpu_torch.kernels import native
    except ImportError as e:
        print(f"chip_smoke: the raft_tpu_torch package is missing ({e})",
              file=sys.stderr)
        return 3
    if args.aot_child:
        return aot_child(args.seed)
    device = torch.device("cuda")
    smi = nvidia_smi()
    print(smi, flush=True)
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})
    try:
        probe = probe_phase(device)
        t0 = time.perf_counter()
        native.load_all()
        emit({"phase": "kernel_build", "seconds": time.perf_counter() - t0,
              "sources": [f"{s}.cu" for s in native.SOURCES]})
        rows = run(device, args.n, args.queries, args.dim, args.n_lists,
                   args.n_probes, args.k, args.seed,
                   profile=args.profile, probe=probe,
                   golden_dir=args.golden_dir)
    except CheckFailed as e:
        print(f"chip_smoke: check failed: {e}", file=sys.stderr)
        return 1
    kernels = [dict(name=name, route="cuda", source=SOURCE[name],
                    replaces=REPLACES[name], **row)
               for name, row in rows.items()]
    print(nvidia_smi(), flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
