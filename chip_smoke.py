#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (``pathway_tpu_torch``) on one card.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. environment: the card's name and power limit, torch/CUDA versions,
   and the build of every kernel from ``pathway_tpu_torch/kernels/csrc``
   (one ``nvcc`` per source, all at once);
2. each kernel against its plain PyTorch version on the card, at the
   shapes of the paths below, with the tolerance stated beside each
   check, and timed beside the plain version and the one PyTorch call
   that computes the same function, where there is one; among them K3
   with a shard's slot offset, K3 at k=256 over the 1M slab (its
   score-only pass and K13), and K13 on [32, 1,048,576] scores at k in
   {129, 256, 1,024} and on [32, 2,048] at k=256 (the IVF probe); the
   f32 forms: K1 at head_dim 16 (the flagship tiny config's) and at
   BGE-base's B=256 L=256, K1 in bf16 at head_dim 16, K4-K7 at the embed
   path's BGE-base shapes (K6 also at a position offset); K14, one ring
   step, in bf16 and f32 at B=8, 2,048 keys, 12 heads of 64 (a middle
   step from a carried state and a finishing step, with a row that has
   no valid key), once with the sequence's any_key (the tile skip) and
   once walking every tile, the two bit-equal, timed beside SDPA over the
   same block and mask (and, named apart, over the whole 8,192-token
   sequence); K3 at nq 32 and 64 in one pass over the slab (4 launches a
   call: the queries' split, the pass, two merges); K3 where q.x is near
   |q||x| (C13, ``k3_edge_cases``): unit rows against themselves, their
   near-duplicates (cosine 0.99-0.9999) and random rows, dot and l2sq,
   the tensor-core pass at every query width and the row-streaming pass,
   within TOPK_ATOL of the plain version, a row's l2sq distance to itself
   below TOPK_ATOL; the same rows through K11, K12 and K10 (C15,
   ``c15_edge_cases``) within ASSIGN_ATOL, TOPK_ATOL and LOGIT_ATOL of
   their plain versions and float64; K9 also at B = 1 and
   13 (one launch each); the ptxas lines of K1, K3, K10-K12 and K14.  C8's f32
   forms: K8 writing f32 rows (from uint8 and f32 images, and on padded
   grids) and K9 reading f32 x, each against its plain version; then
   the tiny f32 dual encoder (``phase_f32_vision``: 32-pixel images,
   hidden 64, 2 layers) on the card against its plain path at 1e-5.
   K1 also, in bf16 and f32, at B=256 L=512 with masks with holes
   (present key tiles between fully masked ones) and rows with no present
   key, whose output must be the uniform average of v, and at L=196 with
   head dims 16 and 32; the share of key tiles K1 walks at each timed
   shape goes on a line.  K13 also on an all-equal row and an ascending
   row (both timed), a row whose chosen bin overflows its candidate
   buffer, rows with fewer live entries than k, signed zeros and k = n,
   each equal to its plain version bit for bit (values and ids), as every
   K13 case must be.  K7's CLS and mean forms in bf16 by CUDA events and
   device time beside their bounds (f32 in ``phase_f32_ring_kernels``), and the
   ingest tail (``pool_normalize_into``,
   K7's slab form with K2's scatter in one launch): the embed chunk's
   hidden state (200 live sequences, 56 pads) into 1M-slot f32 and bf16
   cosine slabs, CLS and mean, against its plain version and against K7
   then K2 on the card (1e-6, one bf16 ulp in a bf16 slab; flags equal),
   its device time beside the pair's; B8, the cross-encoder's head in one
   launch (``phase_cross_head``), on the CLS view of [B, 512, 768] hidden
   states at B = 256 (a rerank chunk) and 32 (one question), bf16 and f32,
   1 and 3 labels, against its plain chain (f32 1e-5; bf16 two ulps of each
   tanh value through the classifier) and the same bits on a second call,
   timed beside its bound and, by queued device time, beside the five
   launches it replaced;
3. the live-RAG embed path at BGE-base full width (768 hidden, 12
   layers, 12 heads, MLP 3072, bf16, seeded random weights): a
   1,048,576-slot cosine index bulk-filled with seeded random vectors,
   ~8k synthetic documents embedded and indexed on the device, a few
   deleted, and queries answered at nq=1 and nq=32; indexed documents
   re-embedded in the same batch must come back as their own top-1 with
   cosine >= 0.999, and the top-k must match a plain matmul + top-k over
   the same slab.  Every kernel of the path must launch during it; each
   chunk's tail is one ingest-tail launch, with no K7 and no K2 launch
   (``tail_launches``), in the timed pass and in the profiled one;
4. the retrieve -> rerank path at BGE-reranker-base full width (the same
   shape, seeded random weights) over phase 3's index: 32 synthetic
   questions retrieve 32 candidates each and the 1,024 pairs are scored
   in chunks of 256 and filtered to 5 per question; then 20 single
   questions, each retrieved and reranked alone.  Every score must be
   finite and within a stated tolerance of the same model run through
   the kernels' plain versions only, the kept five must match the plain
   ranking wherever its 5th/6th margin exceeds that tolerance, and the
   path's kernels must launch during it: the head once a chunk (24), K4
   never with tanh;
5. the image path through ``DualEncoderModel(SIGLIP_BASE, BGE_BASE)`` at
   full width (224-pixel images in 16-pixel patches, 196 patches, 768
   hidden, 12 layers, 12 heads, MLP 3072, bf16, seeded random weights;
   the text tower BGE-base's shape): a 262,144-slot cosine index
   bulk-filled with seeded random unit rows, 4,096 seeded structured
   images uploaded from pinned memory, embedded in chunks of 256 and
   upserted on the device, 256 of them re-embedded (each whose nearest
   other image lies further than the tolerance must come back as its own
   top-1 with cosine >= 0.999), 32 captions searched (top-k equal to a
   plain matmul + top-k over the slab; p50/p99 at nq=1 and nq=32), the
   256 x 256 image x caption logits, and the embeddings held against the
   tower run through the plain versions only and against its f32
   forward.  Every kernel of the path must launch during it;
6. the IVF path (embed -> train -> approximate index -> retrieve) through
   ``IvfKnnIndex(768, metric="cos", capacity=1,048,576)``: the JAX
   package's defaults at that capacity (1,024 cells of 4,096 bf16 slots,
   128 probed, k-means on a 50,000-row sample).  8,192 synthetic
   documents embedded at BGE-base width and 1,040,384 rows of
   ``tests/test_ivf.py``'s mixture at d=768 are added in chunks of
   65,536, the documents with the first chunk, whose 73,728 buffered rows
   train the index; then 1,024 documents re-embedded and upserted, 256
   rows removed and re-added, and queries answered at nq=1 and nq=32.
   Gates: K11 and K12 (both its forms, query-major and cell-major, at nq
   in SCAN_NQ) against their plain versions on the path's data, each
   form's time printed by nq beside the union-bytes bound and K3's brute
   force over the same rows; K12 at nq=32 faster than that brute force;
   the search against its plain search (K3's and K12's plain versions
   over the same tensors) at nq in {1, 8, 32}; recall@10 >= 0.95 for 256
   mixture queries against exact f32 brute force; self-retrieval of the
   documents that have a margin; the grow scenario of
   ``tests/test_ivf.py`` at d=768; an nprobe and a k above 128 against
   the plain search.  Every kernel of the path must launch during it;
7. phase 6's second part, once its 1M-row index is freed: the IVF at the
   JAX defaults from 4,194,304 rows of capacity (2,048 cells of 8,192
   bf16 slots, 25.8 GB, nprobe 256, above K3's k limit of 128): 262,144
   mixture rows train and fill it, searches at nq 1 and 32 with k=10 and
   k=256 must equal its plain search and reach recall@10 >= 0.95, and K13
   must launch for them;
8. the sharded corpus: ``make_mesh({"data": 4}, [card] * 4)``; BGE-base
   data parallel over the mesh embeds phase 3's documents into a
   1,048,576-slot index of four 262,144-row shards, bulk-filled with
   phase 3's seeded rows (the ingest K7 then K2, not the ingest tail);
   searches at nq 1 and 32, k=10 and k=256 (each document its own top-1).
   Gates: every component of the data-parallel
   embeddings within one bf16 ulp of the single-device one (and cosine
   0.999); with the documents' rows set
   to phase 3's, the sharded answers equal the unsharded index's (scores
   within 3e-6, keys but near-ties); K3 on each shard with its offset,
   gathered and merged, equal to K3 over the whole slab.  (One card: the
   copies between cards that a mesh of distinct cards makes are not
   exercised here);
9. BGE-base-width checkpoint directories (``config.json``, a WordPiece
   ``vocab.txt``, ``model.safetensors`` from the port's writer, seeded
   weights) written to a temporary directory and loaded on the card by
   ``TorchEncoderEmbedder(model=dir)`` and ``CrossEncoderReranker(dir)``:
   the loaded tensors equal the written ones, and 256 embeddings and
   pair scores lie within the bf16 tolerances of the plain forward of the
   same weights.

10. sequence and tensor parallelism at BGE-base width, on meshes that
    repeat the card: (a) ``TorchEncoder(sequence_axis="data")`` over 4
    blocks embeds 1,024 of phase 3's documents padded to 512, within
    1e-2 of phase 3's single-device encoder and no further from the f32
    forward than 1.5x it; (b) ``max_len`` 8,192: 8 documents of 8,192
    tokens and the edge rows of ``tests/test_tpu_plane.py`` (at blocks
    of 2,048, a fully masked row among them) through 4 blocks, against
    a 1-block sequence axis (K14 in one step over 8,192 keys) and the
    plain forward (``ring_attention_plain``), each embedding finite and
    within the bf16 embedding tolerance; ``encode_into`` an index whose
    search answers as the 1-block embeddings' does; tokens/s, peak memory
    and a profile of one batch; (c) tensor parallel over ``"model"``
    (``{"data": 1, "model": 2}`` and ``{"data": 2, "model": 2}``) embeds
    the same documents and scores phase 4's pairs within 1e-2 of one
    device on the first weight seed, and on three seeds no further, on
    average, from the f32 forward than 1.5x one device (read beside a
    control that sums the shards' products in f32), with the card holding
    each shard once and no full copy (at most 1.5x one device's weights);
    (d) the flagship tiny f32 config through the 4-block sequence axis
    and on one device, within 1e-5 of its plain forward.

11. the shape repairs C6 and C7 (``phase_shape_repairs``, after phase
    2): K1 at L = 576, 1,024 and 8,192 and at head dims 128 and 80, K14 at
    head dim 128, and K2, K3, K11 and K12 over 262,144 rows of d = 1,536,
    3,072 and 770 (stored with their pitch rounded up), each against its
    plain version; K12's cell-major plan at the shapes it must take and
    refuse, and K12 in both forms at nq=1,024 where every query probes one
    cell and three probe entries lie out of range;
12. the contrastive train step (B15, ``phase_train``, last) at BGE-base
    widths in f32: 64 rows (32 pairs), 128 tokens, ragged masks, 5 Adam
    steps; K15-K19 against their plain versions at the step's shapes, the
    first step's loss and gradients against the plain versions' autograd
    on the card, ms a step, tokens/s, peak memory, the profiled step's idle
    share and split (cuBLAS products counted), its share of the card's
    f32-accurate product peak (3xTF32, PEAK_F32_PRODUCT); K18's loss
    (forward: the product, the loss, raw and lse; backward: d emb, also
    against (G + G^T) @ emb) and its pool backward each against its plain
    version, the same bits twice, device and queued times, the pool
    backward at least half of its bound by queued time, and the loss tail
    one launch of each a step; K15 also at the dry run's D = 16, at
    D = 32, in the cluster form over 2 and 4 blocks (D = 64, 24, 40), and
    in the two-pass form at D = 80 and 128 over 512 keys (K15_CASES), each
    case with a batch row of no present key and rows whose keys lie in one
    block, the same bits on a second call, its form (``bwd_form``) and
    launches a call (1 in the cluster form, 2 in the two-pass form); K15
    at the train shape in one launch, the same bits on a second call and
    on K15_REPEATS more, and by device time (``queued_ms``) no slower
    than SDPA's f32 backward; K19 in one launch a
    step and by device time (CUDA events queued behind a sleep kernel,
    ``queued_ms``) no slower than ``torch.optim.Adam(fused=True)`` (its
    CUDA-event ms, the host's launch path included, beside it); K16 (run
    first) with act none one launch a call and, by CUDA events, no slower
    than ``dy.sum(0)``; K17 (second) with its residual form one launch a
    call and the same bits twice, its embedding form at most two launches
    a call and ``d_position``, dgamma and dbeta the same bits twice, at
    random ids, at all-ones ids (the reference's own train input) and at
    the tokenizer's ids over phase 3's documents (CLS, SEP, PAD tails);
    then ``train.dryrun_multichip(4)`` on a mesh that repeats the card.

13. the host plane's engine core (``phase_engine``, ROADMAP item 12):
    the port's own C++ module (``pathway_torch_native``, built from
    ``pathway_tpu_torch/native/``) must be the one loaded; the groupby
    first target over 2,000 markdown rows and a join + groupby over
    100,000 generated rows through ``pathway_tpu_torch.debug``, each
    equal to a plain-Python computation; phase 3's 8,192 documents
    through ``table_from_pandas -> select(emb=TorchEncoderEmbedder(
    config=BGE_BASE, max_batch_size=1024)(text)) -> table_to_dicts``
    with phase 3's seeded weights, each row within phase 3's gates
    (cosine 0.999, 2e-2) of ``TorchEncoder.encode``, K1 and K4-K7
    launched, docs/s beside phase 3's ``encode_into``; the UDF's batch
    call from a worker thread.

14. the live retrieval pipeline through ``DataIndex`` (``phase_live_rag``,
    ROADMAP items 14 and 13), after phase 13: (a) phase 3's 8,192
    documents as an update stream (then 256 new texts and a few deletes,
    which start a background merge of the delta segment) through
    ``BruteForceKnnFactory(embedder=TorchEncoderEmbedder(BGE-base))`` over
    1,048,576 slots, queried as of now (32 questions in one epoch, 20
    one-question epochs, 256 unchanged documents by their own text, k=10),
    every reply against the same batches through ``TorchEncoder.encode``
    into a ``ShardedKnnIndex`` (keys but near-ties, scores within
    TOPK_ATOL), no deleted key, self-retrieval, a merge run, K1, K2, K3 and
    K4-K7 launched, one query epoch profiled; (b) phase 4's 1,024 pairs
    through ``CrossEncoderReranker`` and ``rerank_topk_filter`` as UDFs,
    within SCORE_ATOL of phase 4's scores, the same kept five, one head
    launch a chunk; (c) 65,536 mixture rows as a vector column into
    ``UsearchKnnFactory(nlist=1,024, nprobe=128)``, which trains inside the
    pipeline, and 256 mixture queries: recall@10 >= 0.95 against exact
    f32, K11 and K12 launched.  Each part logs its rows/s and epoch walls.

15. the RAG server (``phase_rag_server``, ROADMAP item 15), after phase
    14: the first 2,048 of phase 3's documents as files, read by
    ``pw.io.fs.read(mode="streaming")`` into ``VectorStoreServer``
    (BGE-base with phase 3's seed, 1,048,576 slots, split 16-128 tokens)
    and a ``BaseRAGQuestionAnswerer``'s ``QASummaryRestServer`` with a
    stand-in chat, both started by one ``run(threaded=True)`` (what
    ``VectorStoreServer.run_server`` does, in its two steps) on 127.0.0.1; 64 one-question ``/v1/retrieve`` requests, 64 documents by
    their first chunk, 32 requests from 8 client threads, a glob and a
    metadata filter, 8 QA requests, then 64 files added, 32 rewritten and
    32 deleted in place; every reply against the direct path (the engine's
    own batches through ``TorchEncoder.encode`` into a ``ShardedKnnIndex``),
    K1, K2, K3 and K4-K7 launched; logs ingest docs/s, HTTP p50/p99, the
    QA round's p50, a served question's idle share and the live change's
    time to visibility.  Since slice 16a ``pw.run`` analyses the graph and
    runs the plan compiler's rewrite of it (``optimize=2``): before the
    server starts, ``pw.analyze()``, ``pw.explain()`` and
    ``pw.run(strict=True)`` (``analyse_before_run``) read the same graph.
    Since slice 16b the run is ``pw.run(with_http_server=True)`` on a free
    monitoring port, and ``/status`` is scraped once while it serves.

16. the analyzer and the plan compiler (``phase_analysis``, slice 16a),
    after phase 15: phase 15's pre-flight (findings by severity and code,
    the columnar decision of each node, the plan's counters, the strict
    run's outcome, the pre-flight's ms) and its served numbers at
    ``optimize=2``; phase 13's join + groupby over its 100,000 orders, read
    from JSON-lines files, through ``pw.run`` at ``optimize=0`` and ``2``
    in turns (rows/s; the scheduler's ``columnar_rows``, which must count
    columnar rows at ``2``; both levels equal to each other and to plain
    Python); A11's ``device_profile()`` over the installed port (an
    unwaived error fails); ``estimate_memory`` of phase 14's live-index
    graph beside the card's peak while it ran.

17. the serving layer and the monitoring server (``phase_serving``, slice
    16b), after phase 16: ``RagServingApp`` with BGE-base (phase 3's seed)
    as its embedder (``EncoderAdapter``: one text a call, as the app calls
    it) and a 1,048,576-slot ``SegmentedIndex(ShardedKnnIndex)`` on the
    card as its index; 1,024 of phase 15's documents upserted, then three
    tenants under ``LoadGen`` (interactive, batch, and a batch tenant over
    its rate, which admission sheds) while documents are rewritten and
    deleted; 64 answers against the direct path (the adapter over each
    live chunk, an exact numpy top-k), lookahead probes above 0, K1-K7
    launched, ``/v1/answer`` over REST with a 429 and ``Retry-After`` for
    an over-rate tenant and the admission counters equal to the replies,
    ``/metrics``, ``/status`` and ``/debug/stacks`` of
    ``start_http_server``; then ``RagServingApp(shards=2)`` over two
    65,536-slot shards: one owner killed under load answers partially,
    ``ShardFailoverSupervisor`` restores it, the hits equal those before
    the kill.

18. persistence and the chaos drill (``phase_persistence``, slice 16c),
    after phase 17: an ``IndexDrill`` over BGE-base and a 131,072-slot
    f32 slab on the card runs ``pw.run(persistence_config=...)`` under
    OPERATOR_PERSISTING in subprocesses under ``ClusterSupervisor``
    (one process): a fault-free baseline (its ``/status`` checkpoint
    section scraped once), the drill killed between a finished merge and
    its commit and respawned (exactly once: 4,096 documents; answers equal
    to numpy top-10 over the recovered vectors and recall@10 0.99 against
    the baseline; the recovering generation embeds less than the input;
    K1-K7 launched), and a third run over the drill's storage with no new
    input (nothing embedded, no sink row); then phase 3's 1M slab through
    ``state_dict``, ``pickle`` and ``load_state_dict`` into a fresh index,
    K3 giving the same ids and score bits before and after.

19. the streaming stdlib (``phase_stdlib``, slice 16d), after phase 18:
    one ``pw.run`` over 16,384 synthetic documents (16 topics, event
    times a second apart, 5% up to 240 s late) from a Python connector
    that commits every 512 rows, embedded by BGE-base as a UDF: the first
    12,288 by event time train ``pw.ml``'s kNN classifier (``KNNIndex``,
    euclidean: K3's l2sq form over a slab that grows on the card from the
    index's reserve, each grow timed), the other 4,096 are classified;
    sliding windows (hop 60, duration 300, a delay of 60) count them per
    predicted topic; an interval join counts them for each of 512
    questions by topic; a ``KNNIndex`` over the first 2,048 documents
    gives a 5-nearest-neighbour graph, its PageRank (10 steps) and its
    Bellman-Ford distances from document 0 through ``pw.iterate``.
    Checks: the predictions against numpy's exact l2sq top-10 vote over
    the stored vectors (ties excluded, 99% compared), the window and join
    counts against Python's over the predictions received, the edges
    against numpy's exact top-6, the ranks against numpy's run of the
    recurrence and the distances against scipy's Dijkstra (1e-9), K1-K7
    launched with K3 in its l2sq form; K3's l2sq form against its plain
    version on the graph slab; one classify epoch profiled.

20. slice 16e (``phase_apps``), after phase 19: (a) a YAML RAG app in
    the reference's template form (BGE-base on the card, a 1M-slot
    brute-force index, phase 15's 2,048 files) started by ``python -m
    pathway_tpu_torch.cli spawn --threads 2 python app.py`` in a child
    process group and asked 136 questions over REST: each reply against a
    direct path built here on the same seed (ids rank by rank but for
    near-ties, scores within TOPK_ATOL), ``evaluate_retrieval`` of both
    equal, the child's launches (K1, K4-K7, K2, K3) from the file it
    writes at exit, ``cli lint app.py`` equal to ``pw.analyze`` of the
    same graph built here; (b) phase 19's 16,384 documents from
    ``pw.demo.generate_custom_stream`` through BGE-base as a UDF and a
    16-topic cosine ``KNNIndex`` (K2, K3), seven ``pw.sql`` statements
    each equal to ``sqlite3`` over the rows the pipeline wrote, scores
    against numpy, a ``pw.live`` table read during the run, the scored
    table exported and imported into a second graph that indexes its
    embeddings and answers 512 questions at k=10 (numpy's exact top-10),
    ``table_viz`` and ``plot`` holding the grouped rows; one SQL epoch
    profiled.
21. slice 16f (``phase_documents``), after phase 20: (a) 2,048 generated
    files (``make_pdf``, ``make_docx``) read by ``pw.io.fs.read`` into
    ``VectorStoreServer`` with ``OpenParse`` for the PDFs and
    ``ParseUnstructured(mode="elements")`` for the DOCX files, BGE-base
    and a 1M-slot index, served over REST: every parser output equal to
    the same parser's in-process, 136 questions against the direct path
    at DOCS_REPLY_ATOL, 32 at once, a PDF rewritten and a DOCX deleted
    while it serves; (b) 16,384 documents through ``pw.io.kafka.read`` and
    a Debezium change stream through ``pw.io.debezium.read`` (both on a
    ``MockBroker``) into two live ``DataIndex``es, 512 questions each,
    the replies through ``pw.io.postgres.write`` into ``sqlite3`` (and
    ``pw.io.null.write``) and read back by ``pw.io.sqlite.read``: each
    index against the direct path over its final set, no deleted key,
    updated keys' rows equal to their new texts' encodings, the rows read
    back equal to the rows written.

Phases 13-21 and then phase 8 run right after phase 4, while
phase 3's index is alive, and phase 10 after them; phases 5, 6, 9 and 12
follow.  The second-to-last line of
output is a JSON object with one entry per kernel wrapper (K1-K19 and B8's
head; K1 and K4-K7 with their f32 forms); the last is ``{"ok": true, "device":
{...}}``.  Without a CUDA device the script exits 1 and prints no result.

``python3 chip_smoke.py --against-parent DIR`` runs instead, on one card,
only K14, K3's row-streaming pass, K1, K12, K16, K15, K19, K17 (both
forms; the embedding form at random and all-ones ids), K9, K7 (CLS bf16,
mean bf16 and f32), K2 (scatter and clear), the ingest tail (against
the parent's K7 then K2), B8's head (against the parent's five launches)
and K18 (the loss and d emb through autograd against the parent's six
launches; the pool backward) of this tree
beside the same kernels built from the sources under ``DIR`` (another
commit, unpacked) and launched through its launch helper, timed in turns,
each within PARENT_RATIO of the parent where both sides run the parent's
code and no slower at all where this tree runs code the parent does not
(K12 at nq=1, K16 act none, K15, K19, K17, K9, K7, K2, B8 and K18 by
device time, ``queued_ms``;
K19 the same bits as the parent's after two steps;
``phase_against_parent``).

``python3 chip_smoke.py --rag-server-levels`` runs instead, on one card,
only phase 15 over phase 3's documents at ``PATHWAY_OPTIMIZE`` 0 and 2
and at 2 with ``PATHWAY_DISABLE_COLUMNAR=1``, in turns
(``phase_rag_server_levels``): the served numbers of the rewritten plan
beside the captured graph's, and each run's busiest operators.

``python3 chip_smoke.py --serving`` runs instead, on one card, only phase 15
(over phase 3's documents) and phase 17.

``python3 chip_smoke.py --persistence`` runs instead, on one card, only
phase 18 (over a slab built as phase 3 builds its own).

``python3 chip_smoke.py --stdlib`` runs instead, on one card, only phase 19.

``python3 chip_smoke.py --apps`` runs instead, on one card, only phase 20.

``python3 chip_smoke.py --documents`` runs instead, on one card, only
phase 21.

``python3 chip_smoke.py --k3-edge [DIR]`` runs instead, on one card, only
phase 2's C13 and C15 cases (``k3_edge_cases``, ``c15_edge_cases``) on
this tree's K3, K11, K12 and K10 and, with DIR (another commit,
unpacked), on that commit's first, then K3 timed in turns over the 1M
slab and K10 at phase 2's shape (``phase_k3_edge``).

``python3 chip_smoke.py --distinct-cards`` runs instead, on four cards,
only what a mesh that repeats one card cannot show: ring attention and
the sequence-parallel encoder over four cards, tensor parallelism over
two and four, the sharded index (B12), the data-parallel encoder's
replicas and the data-parallel train step, each against the same mesh on
one card, and each card's bytes (``phase_distinct_cards``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import threading
import time
import zlib

SEED = 0
HIDDEN = 768
CAPACITY = 1 << 20  # one million documents, the README's KNN scale
N_DOCS = 8192
DOC_BATCH = 256  # encoder rows per chunk on the main path
N_REMOVED = 16
K = 10
RERANK_BATCH = 256  # pairs per cross-encoder chunk
RERANK_K = 32  # candidates retrieved per question
RERANK_KEEP = 5
N_QUESTIONS = 32  # the batched round
N_SINGLE = 20  # single-question rounds
IMAGE_SIZE, PATCH = 224, 16  # SigLIP-base's image tower
N_PATCH = (IMAGE_SIZE // PATCH) ** 2  # 196 = 3 * 64 + 4: K1's last key tile is partial
IMAGE_BATCH = 256  # images per chunk on the image path
N_IMAGES = 4096
IMAGE_CAPACITY = 1 << 18  # slots of the image index (805 MB of f32 rows)
N_PROBE = 256  # indexed images re-embedded for self-retrieval
N_CAPTIONS = 256  # captions: the first 32 query the index, all 256 make the logits

# stated tolerances
ATTN_ATOL = ATTN_RTOL = 2e-2  # bf16 output (8 mantissa bits); plain rounds logits to bf16, K1 keeps f32
SCATTER_ATOL = 1e-6  # f32 norm summed in another order: ~1 ulp of a unit-norm row
# the ingest tail into a bf16 slab against K7 then K2: one bf16 ulp of the
# value (plus SCATTER_ATOL); the two normalise f32 rows whose norms are
# summed in another order, ~1e-7 apart, and the cast may round those to
# neighbouring bf16 values
TAIL_BF16_RTOL = 2.0**-7
TOPK_ATOL = 1e-5  # f32 dot of unit rows over 768 dims, summed in another order
# C13's rows (k3_edge_cases): unit rows queried against themselves and their near-duplicates
EDGE_BASE = 256
EDGE_COS = (0.99, 0.999, 0.9999)
EDGE_RANDOM = 256  # unrelated unit rows beside them, all valid
EDGE_RANDOM_QUERIES = 64  # unit queries that are not slab rows
EDGE_SLAB = 65536
EDGE_K = 8  # a row, its three near-duplicates and four others
EDGE_SINGLE = 16  # base rows queried one a call (the row-streaming pass)
EDGE_KERNELS = ("knn_topk", "topk_select", "ivf_assign", "ivf_scan", "dual_logits")  # what --k3-edge builds
C15_NLISTS = (1024, 4096)  # K11's centroid counts at the edge
C15_SCAN_CAP = 512  # K12's edge cells: the edge slab as 128 cells of 512 slots ...
C15_SCAN_NPROBE = 64  # ... of which each query probes half
SELECT_ATOL = 0.0  # K13 copies the values it selects
SELECT_K = 256  # the k above K3's MAX_K that phases 2, 6 and 8 search at
SELF_COS = 0.999
# K4-K7: two bf16 ulps of the value; kernel and plain version round at the
# same steps, but LayerNorm statistics and pooling sums are taken in
# another order, so a rounded output may land one ulp apart
BF16_RTOL = 2.0**-6
FUSED_ATOL = 1e-5
# rerank scores against the plain-only forward: the bf16 encoder tolerance
# of the CPU tests.  With seeded random weights the 12 layers amplify any
# bf16 ulp flip: the kernel path and the plain path each lie up to ~9e-3
# (mean ~2e-3) from the same forward in f32, as this phase reports
# ("vs_f32"; NVIDIA H100 80GB HBM3, 700 W), so this is about twice that
# noise floor
SCORE_ATOL = 2e-2
# ... and the kernel path no further from the f32 forward, on average, than
# this many times the plain bf16 path is
F32_RATIO = 1.5
# K9: f32 sums of 196 rows and of 768 products taken in another order
HEAD_ATOL = 1e-5
# B8, the cross-encoder's head, against its plain chain: in f32 the same
# operations, sums taken in another order (the pooler's on 3xTF32), within
# F32_ATOL; in bf16 each tanh value may land BF16_RTOL from the plain one
# (the pooler's bf16-rounded product summed in another order), so a logit
# is held to BF16_RTOL * (|classifier| @ |tanh|) + FUSED_ATOL
CROSS_HEAD_SHAPES = ((RERANK_BATCH, 512), (RERANK_K, 512))  # (B, L): a batched chunk, one question
# K10: f32 dots of unit rows over 768 dims in another order, times e^s (< 10)
LOGIT_ATOL = 1e-5
# image embeddings against the plain-only forward: the bf16 encoder
# tolerance of the CPU tests (cosine per row, and absolute)
EMBED_COS = 0.999
EMBED_ATOL = 2e-2
# self-retrieval decides only images whose cosine to their nearest other
# indexed image is below their own by more than this
SELF_MARGIN = 1.0 - SELF_COS
# phase 6, the IVF path: IvfKnnIndex(768, capacity=IVF_CAPACITY) gives the
# JAX package's defaults nlist=1,024, nprobe=128, cell_cap=4,096 (bf16)
IVF_CAPACITY = 1 << 20
IVF_NLIST, IVF_NPROBE, IVF_CELL_CAP = 1024, 128, 4096
IVF_BULK = IVF_CAPACITY - N_DOCS  # mixture rows beside the documents
IVF_CHUNK = 65536  # rows per add_batch, as a stream adds them
IVF_UPSERT = 1024  # documents re-embedded and upserted
IVF_READD = 256  # bulk rows removed and re-added
IVF_QUERIES = 256  # mixture queries (seed 1): recall and latency
IVF_CHECKED = 64  # of them, held against the plain search
IVF_SELF = 256  # documents queried for self-retrieval
IVF_RECALL = 0.95  # the JAX package's recall@10 contract (tests/test_ivf.py)
SCAN_NQ = (1, 4, 8, 16, 32, 64)  # K12's forms are timed at these query counts
# K11 decides a row where its top-2 scores differ by more than this (f32
# dots of unit rows over 768 dims summed in another order)
ASSIGN_ATOL = 1e-5
# phase 6, continued: IvfKnnIndex(768, capacity=C3_CAPACITY) gives the JAX
# package's defaults nlist=2,048, nprobe=256, cell_cap=8,192 (bf16, 25.8 GB)
C3_CAPACITY = 1 << 22
C3_NLIST, C3_NPROBE, C3_CELL_CAP = 2048, 256, 8192
C3_ROWS = 262_144  # mixture rows loaded (the first add trains the index)
# phase 8, the sharded corpus: the 1M-slot index as SHARDS shards of one card
SHARDS = 4
# f32 kernels (K1, K4-K7, K14) against their plain versions: the same f32
# operations, sums taken in another order
F32_ATOL = 1e-5
# K14 on the card: one block of a long document (B=8, 2,048 keys, BGE-base's
# 12 heads of 64), and the whole 8,192-token sequence SDPA is timed over
RING_B, RING_L, RING_H, RING_D = 8, 2048, 12, 64
LONG_LEN = 8192
# K14 in bf16: the finished output within two bf16 ulps of its largest value
# (RING_ATOL times max |ref|: 1.6e-2 at |o| <= 1).  The f32 state within
# RING_STATE_RTOL of the plain version's, relative to l (o / l is what the
# state carries, and o and l scale together with the running max).  p stays
# f32 in the reference; K14 splits it into two bf16 parts for p.v and lay
# 3.5e-6 from the plain state on an H100 (PERF.md), where the same step with
# p rounded to bf16 once, as K1 rounds it, moves the state far more: the
# limit lies between the two, and phase 2 requires that control to miss it
RING_ATOL = 1.6e-2
RING_STATE_RTOL = 2e-5
# phase 10: sequence and tensor parallelism at BGE-base width, on one card
SEQ_SHARDS = 4
SP_DOCS = 1024  # phase 3's documents embedded by the SP and TP encoders
LONG_DOCS = 8  # documents of LONG_LEN tokens, plus the edge rows
# SP against the single-device (K1) encoder: K14 keeps p in f32 where K1
# rounds it to bf16, a gap the bf16 activations hide end to end (phase 2's
# state check and its control hold p's precision).  TP against one device:
# each shard's partial product is rounded to bf16 before the sum.  The
# pair scores sit at this limit's noise floor: on an H100 one device's own
# forward with its products taken in f32 (the control) lies 7.8e-3-1.1e-2
# from its bf16 forward (PERF.md), so on the TP_SEEDS weight seeds TP is
# held to the f32 forward relative to one device (F32_RATIO, on average),
# and to TP_ATOL on the first seed
SP_ATOL = 1e-2
TP_ATOL = 1e-2
TP_SEEDS = (SEED, SEED + 1, SEED + 2)
# the card's bytes for a TP encoder on a mesh that repeats it: each shard
# once (the embeddings and head once per shard), no full copy beside them
TP_WEIGHTS_RATIO = 1.5
SHARD_ATOL = 3e-6  # sharded against unsharded scores over the same rows
# --against-parent: this tree's time (CUDA events; DEVICE_GATED, device
# time) at most this many times the parent's, in the same call, where both
# sides run the parent's code (one binary, or the same form of a rebuilt
# one): a strict gate would read noise.  Where this tree runs code the
# parent does not (a library rebuilt from changed sources, in a form the
# parent's wrapper does not run at that shape), no slower at all
PARENT_RATIO = 1.05
# ... by device time (``queued_ms``): the short calls whose CUDA-event means
# read host stalls (K12 at nq=1, ~0.2 ms; K16 act none, ~0.02 ms): on an
# H100 two builds of K12 at equal device time read 9-28% apart by events;
# and K15 and K19, whose parents' wrappers spend host time the kernels'
# speed does not measure (K19's parent uploads its tables every step);
# K17 and K9, redesigned for their device time (the parents' K17 makes two
# launches a call); K7, redesigned for its device time, and K2, whose calls
# take less device time than the host takes to make them (two equal
# builds of K2's clear read 17% apart by events on an H100); B8 and K18,
# redesigned as fewer launches for their device time
DEVICE_GATED = ("K12 nq=1 ", "K16 none ", "K15 ", "K19 ", "K17 ", "K9 ", "K7 ", "K2 ", "B8 ", "K18 ")

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s, bf16, TF32 and f32
# (FMA units) FLOP/s
# C6/C7 on the card and the train step (B15)
C7_ROWS = 262_144  # unit rows a C7 width is checked over
TRAIN_B, TRAIN_L = 64, 128  # rows (32 pairs) and tokens of the train step
TRAIN_STEPS = 5
TRAIN_LR = 1e-4
TRAIN_REDRAW = 0.15  # tokens of a pair's second row redrawn
BWD_RTOL = 1e-5  # K15-K19 against their plain versions, of max|ref| (f32 sums in another order)
# K15's other forms, (B, L, heads, D): the dry run's model shard, D = 32,
# the cluster form over 2 and 4 blocks of 128 keys (D = 64, 24 and 40, the
# last two zero-padded), and the two-pass form at the zero-padded D = 80
# and at D = 128 past 128 keys
K15_CASES = ((4, 16, 2, 16), (4, 64, 2, 32), (4, 512, 4, 64), (4, 200, 2, 24), (4, 448, 2, 40),
             (2, 512, 4, 80), (2, 512, 4, 128))
# calls of K15 at the train shape held to the first call's bits
K15_REPEATS = 1000
TRAIN_LOSS_RTOL = 1e-5  # the first step's loss against the plain step's
TRAIN_GRAD_RTOL = 1e-4  # its gradients, each of its tensor's max|g| (12 layers of f32 rounding)
TRAIN_KERNELS = ("attention", "bias_act", "add_layer_norm", "embed_ln", "pool_normalize", "attention_bwd",
                 "bias_act_bwd", "layer_norm_bwd", "embed_ln_bwd", "contrastive_loss", "contrastive_loss_bwd",
                 "pool_normalize_bwd", "adam")

PEAK_BYTES = 3.35e12
ENGINE_MD_ROWS = 2000  # markdown rows of the engine phase's groupby first target
ENGINE_ROWS = 100_000  # generated orders the engine phase joins
ENGINE_CUSTOMERS = 1000
ENGINE_UDF_BATCH = 1024  # the embedder UDF's max_batch_size in the engine phase
LIVE_UPSERTS = 256  # phase 3's documents given new texts in the live index's second epoch
LIVE_DELTA_CAP = 128  # below LIVE_UPSERTS: the second epoch's delta segment starts a background merge
LIVE_SELF = 256  # unchanged documents queried by their own text
LIVE_IVF_ROWS = 65536  # mixture rows into the live IVF: above its 50,000-row training sample
LIVE_IVF_NLIST, LIVE_IVF_NPROBE = 1024, 128  # IvfKnnIndex's defaults at 1,048,576 slots
N_SERVER_DOCS = 2048  # phase 3's first documents, written as files for the served pipeline
SERVER_SPLIT = (16, 128)  # TokenCountSplitter's (min_tokens, max_tokens): the longer documents split in two
SERVER_QUESTIONS = 64  # one-question /v1/retrieve requests; as many documents queried by their first chunk
SERVER_CONCURRENT, SERVER_CLIENTS = 32, 8  # requests sent at once, from client threads
SERVER_FILTERED = 4  # questions asked with a glob and with a metadata filter
SERVER_QA = 8  # /v1/pw_ai_answer requests
SERVER_QA_TOPK = 6  # BaseRAGQuestionAnswerer's search_topk (its default)
SERVER_ADDED, SERVER_REWRITTEN, SERVER_DELETED = 64, 32, 32  # the live change, in place
SERVER_DEADLINE_S = 120.0  # the server's start, and the live change's visibility
ANALYSIS_LEVELS = (0, 2, 2, 0)  # phase 16's runs of the engine join, in turns
#: --rag-server-levels' runs of phase 15, in turns: (optimize, columnar paths off)
SERVER_LEVEL_RUNS = ((0, False), (2, False), (2, True), (2, True), (2, False), (0, False))
SERVER_MTIME0 = 1_700_000_000  # file i's modified_at: SERVER_MTIME0 + i
SERVER_GLOB = "*/doc00[0-9]*.txt"  # files 0-999
SERVER_FILTER = f"modified_at < `{SERVER_MTIME0 + 1024}`"  # files 0-1,023
SERVING_DOCS = 1024  # phase 15's first documents, upserted through RagServingApp.upsert (cut for the script's time)
SERVING_CHUNK_WORDS = 256  # simple_splitter's window: a document of 62-254 words is one chunk
SERVING_DELTA_CAP = 256  # the delta segment's cap: above K - 128, so a probe over a full delta runs K13
SERVING_REWRITTEN, SERVING_DELETED = 128, 64  # documents rewritten and deleted while the load runs
SERVING_LOAD_S = 5.0  # LoadGen's duration
SERVING_CHECKED = 64  # answers held against the direct path
SERVING_DEADLINE_S = 60.0  # the ingest's end, the churn's settling, the REST server's start
FAILOVER_SLOTS = 1 << 16  # each of the two shards' slots: a standby snapshot copies its shard to the host
FAILOVER_DOCS = 256  # documents of the two-shard app
FAILOVER_SNAPSHOT_EVERY = 64  # a shard owner's ops between snapshots: about two a shard, so a standby has one
FAILOVER_DELTA_CAP = 32  # a shard's delta cap: its 128 or so chunks merge into its slab (K2), probes reach it (K3)
FAILOVER_QUERIES = 32  # questions answered before the kill and after the restore
PERSIST_DOCS = 4096  # phase 15's documents read by the persisted pipeline (cut for the script's time)
PERSIST_REUPSERTS = 1024  # seeded ids given new texts after them
PERSIST_QUESTIONS = 128
PERSIST_COMMIT = 256  # the document reader commits every this many rows
PERSIST_EPOCH_ROWS = 192  # PATHWAY_EPOCH_MAX_ROWS: batches below the delta cap go through the delta and merge
PERSIST_SLOTS = 1 << 17  # the index's slots: one checkpoint holds the 403 MB f32 slab
PERSIST_DELTA_CAP = 256
PERSIST_KILL_MERGE = 3  # the drill's process dies between this merge and its commit
PERSIST_CHECKPOINT_S = 1.0  # PATHWAY_CHECKPOINT_INTERVAL
PERSIST_BATCH = 256  # the embedder UDF's max_batch_size
PERSIST_RECALL = 0.99  # the drill's answers against the baseline's, recall@10
PERSIST_RUN_S = 300.0  # the supervisor's limit for one run
PERSIST_PHASE_S = 120.0
PERSIST_EMBEDDER = '"bge-base"'  # TorchEncoderEmbedder's model argument in the drill's program
PERSIST_SLAB_QUERIES = 32  # phase 3's queries held before and after the 1M slab's round trip
STDLIB_DOCS = 16384  # phase 19's documents, streamed in arrival order
STDLIB_LABELLED = 12288  # the first documents by event time carry their label; the rest are classified
STDLIB_QUESTIONS = 512
STDLIB_TOPICS = 16
STDLIB_TOPIC_REPEAT = 24  # times a document's text starts with its topic's word
STDLIB_LATE_SHARE = 0.05  # documents that arrive late ...
STDLIB_LATE_S = 240  # ... by up to this many seconds of event time
STDLIB_COMMIT = 512  # the Python connector commits every this many rows
STDLIB_BATCH = 256  # the embedder UDF's max_batch_size
STDLIB_GRAPH = 2048  # the first labelled documents: the kNN graph's vertices
STDLIB_GRAPH_K = 6  # neighbours asked for: a document itself and its 5 nearest others
STDLIB_CLASSIFY_K = 10
STDLIB_HOP, STDLIB_DURATION, STDLIB_DELAY = 60, 300, 60  # the sliding windows and their behavior's delay
STDLIB_JOIN = (-60, 0)  # the interval join's band: documents up to a minute before a question
STDLIB_PAGERANK_STEPS = 10
STDLIB_TIE_RTOL = 1e-4  # neighbours this close may come in either order: a query is a tie if that changes its vote
STDLIB_GRAPH_RTOL = 1e-9  # ranks and path lengths against numpy and scipy over the received edges
STDLIB_COMPARED = 0.99  # the share of queries that must be compared (not ties)
STDLIB_PHASE_S = 90.0
APPS_DOCS = 2048  # phase 15's files (phase 3's first documents), served by the YAML app
APPS_QUESTIONS = 136  # one-question /v1/retrieve requests to the YAML app
APPS_QA = 8  # /v1/pw_ai_answer requests to it
APPS_BATCH = 256  # the embedder UDF's max_batch_size in both parts
APPS_THREADS = 2  # spawn --threads
APPS_DEADLINE_S = 240.0  # the app's start and ingest, and its exit once asked to stop
APPS_DEVICE = "cuda"  # the YAML's device: entries
APPS_CONFIG = "!pw.BGE_BASE"  # the YAML embedder's config: BGE-base, 768 x 12, bf16
APPS_STREAM_DOCS = STDLIB_DOCS  # phase 19's documents, streamed by pw.demo.generate_custom_stream
APPS_INPUT_RATE = 1e6  # rows a second asked of the demo stream (it commits every 64 rows above 100)
APPS_IMPORT_QUESTIONS = 512  # questions the imported table's index answers
APPS_EPOCH_ROWS = 64  # the profiled SQL epoch: one demo-stream commit
APPS_DELTA_CAP = 8  # below the 16 topic rows: an index batch this large goes straight to the slab
APPS_FLOAT_RTOL = 1e-9  # SQL sums against sqlite's: f64 host arithmetic in another order
DOCS_FILES = 2048  # phase 21's files: the first half PDFs, the rest DOCX
DOCS_QUESTIONS = 136  # one-question /v1/retrieve requests to the document server
DOCS_CONCURRENT = 32  # of them sent at once, from SERVER_CLIENTS threads
DOCS_DELTA_CAP = 8  # the indexes' delta cap: an ingest batch this large goes straight to the slab
DOCS_REPLY_ATOL = 1e-6  # served scores against the direct path's; an updated key's row against its encoding
DOCS_DEADLINE_S = 120.0  # the server's ingest, and each live change's visibility
DOCS_EPOCH_FILES = 64  # files of the profiled ingest epoch: half PDFs, half DOCX
DOCS_CDC = (4096, 1024, 512)  # Debezium creates, then updates and deletes of those keys
DOCS_STREAM_QUESTIONS = 512  # questions each index of part (b) answers at k = K
DOCS_STREAM_DEADLINE_S = 240.0  # the indexes of part (b) reach their final sets
DOCS_PHASE_S = 150.0
DOCS_PDF_PAGES = 2  # pages of a generated PDF (phase 21)
DOCS_LINE_WORDS = 10  # words on a generated PDF's body line; a DOCX paragraph has three lines' worth
PEAK_BF16 = 989e12
PEAK_TF32 = 495e12
PEAK_F32 = 67e12
# an f32-accurate matrix product: three TF32 passes on the tensor cores
# (hi.hi + hi.lo + lo.hi, csrc/tf32x3.cuh), 165 TFLOP/s of f32 product
PEAK_F32_PRODUCT = PEAK_TF32 / 3


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def bound(nbytes: float, flops: float, peak_flops: float) -> tuple[float, str]:
    """Least time in ms for the work, and what bounds it: the larger of
    ``nbytes / PEAK_BYTES`` and ``flops / peak_flops``.  An f32 matrix
    product (K1 f32, K3, K10, K11, K12, K14 f32) passes PEAK_F32_PRODUCT,
    i.e. max(bytes / 3.35e12, 3 * flops / 495e12): three TF32 passes keep
    f32 accuracy and outrun the FMA units' 67 TFLOP/s.  Elementwise f32
    work passes PEAK_F32; bf16 products PEAK_BF16."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` in ms, by CUDA events around ``iters`` calls."""
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


def device_ms(torch, fn, iters: int = 50) -> float:
    """Mean device time of ``fn`` in ms: the kernel time the profiler saw
    over ``iters`` calls, launch gaps left out; recorded beside the gates,
    which read ``queued_ms``.  As in
    ``profile_call``, 32 small kernels run first inside the window (once
    earlier windows have run, a window's trace can lack its first device
    events), and only device events that start during the calls count."""
    from torch.profiler import ProfilerActivity, profile, record_function

    fn()
    scratch = torch.zeros((1,), device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(32):
            scratch.add_(1.0)
        torch.cuda.synchronize()
        with record_function("device_ms"):
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()

    def on_device(e) -> bool:
        return str(getattr(e, "device_type", "")).endswith("CUDA")

    events = prof.events()
    start = next(e for e in events if e.name == "device_ms" and not on_device(e)).time_range.start
    # a ``record_function`` range inside ``fn`` (torch.optim's step has one)
    # shows on the device too, spanning the kernels it holds: not counted
    total = sum(e.time_range.elapsed_us() for e in events
                if on_device(e) and not getattr(e, "is_user_annotation", False) and e.name != "device_ms"
                and e.time_range.start >= start)
    return total / 1e3 / iters


def queued_ms(torch, fn, iters: int = 10) -> float:
    """Mean device time of ``fn`` in ms by CUDA events, with the host kept
    ahead of the card: a sleep kernel holds the stream while the calls are
    enqueued behind it, so the events time them back to back on the device
    (launch gaps included, host time not).  Unlike the profiler's trace,
    which late in a long process has read a library call's kernels short,
    it cannot lose a kernel.  ``fn``'s host time for ``iters`` calls must
    stay under the sleep (about 85 ms on an H100).  Every device-time gate
    of this script reads it: the profiler's trace has read fused Adam at
    0.989 ms a step over ten steps against 1.102 in one step's trace of the
    same run, and one turn of a kernel at 0.0 ms."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(150_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def compare_topk(kv, ki, pv, pi, tol: float) -> float:
    """Kernel (kv, ki) against plain (pv, pi) top-k, both best first:
    values within ``tol``; every slot the plain version ranks clear of its
    k-th value by more than ``tol`` (away from near-ties) is in the
    kernel's list.  Returns the largest value difference."""
    err = (kv - pv).abs().max().item()
    if not err <= tol:
        fail(f"top-k values differ by {err} > {tol}")
    kth = pv[:, -1:]
    for r in range(pv.shape[0]):
        sure = set(pi[r][pv[r] > kth[r] + tol].tolist())
        missing = sure - set(ki[r].tolist())
        if missing:
            fail(f"top-k row {r}: kernel misses slots {sorted(missing)[:5]}")
    return err


def holes_mask(torch, g, dev, B: int, L: int):
    """[B, L] uint8 key masks with holes: each 64-key tile of a row is
    present with probability 0.4, as a run of 1-64 keys, so present tiles
    sit between fully masked ones.  Row 0 keeps every key, row 1 none (K1
    must give it the uniform average of v, walking every tile), row 3 only
    its last key."""
    n_tiles = -(-L // 64)
    pos = torch.arange(64, device=dev)[None]
    tiles = []
    for _ in range(n_tiles):
        start = torch.randint(0, 64, (B, 1), generator=g, device=dev)
        length = torch.randint(1, 65, (B, 1), generator=g, device=dev)
        keep = torch.rand((B, 1), generator=g, device=dev) < 0.4
        tiles.append((pos >= start) & (pos < start + length) & keep)
    mask = torch.cat(tiles, dim=1)[:, :L].to(torch.uint8).contiguous()
    mask[0] = 1
    mask[1] = 0
    mask[3:4] = 0
    mask[3:4, L - 1] = 1
    return mask


def check_attention_case(torch, label: str, v, mask, got, ref, atol: float, rtol: float) -> float:
    """K1's output ``got`` against its plain version ``ref``: finite and
    within atol + rtol |ref| everywhere, and every batch row with no present
    key the uniform average of its v over all L keys, to the same
    tolerance.  Returns the largest difference from ``ref``."""
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    if not bool(torch.isfinite(got).all()) or bool((err > atol + rtol * ref.abs()).any()):
        fail(f"attention {label}: max err {err.max().item()}")
    empty = (mask.sum(dim=1) == 0).nonzero().flatten().tolist()
    err_u = 0.0
    for b in empty:
        mean = v[b].float().mean(dim=0)[None].expand_as(got[b])
        eu = (got[b] - mean).abs()
        if bool((eu > atol + rtol * mean.abs()).any()):
            fail(f"attention {label}: batch row {b} has no present key, but its output is "
                 f"{eu.max().item()} from the uniform average of v")
        err_u = max(err_u, eu.max().item())
    log(f"K1 attention {label}: max_abs_err {err.max().item():.3e}; rows with no present key "
        f"{empty[:8]}{'...' if len(empty) > 8 else ''} within {err_u:.3e} of the mean of v")
    return err.max().item()


def phase_kernels(torch, dev) -> dict:
    """Phase 2: each kernel against its plain version; returns the
    measurements per kernel."""
    import numpy as np
    import torch.nn.functional as F

    from pathway_tpu_torch.kernels import (
        attention,
        attention_plain,
        dual_logits,
        ivf_assign,
        ivf_scan,
        MAX_K,
        knn_topk,
        knn_topk_plain,
        slab_clear,
        slab_clear_plain,
        slab_scatter,
        slab_scatter_plain,
        topk_select,
        topk_select_plain,
    )
    from pathway_tpu_torch.kernels.attention import walked_key_tiles
    from pathway_tpu_torch.kernels.knn_topk import TILED_MIN_QUERIES, merge_passes, tiled_groups
    from pathway_tpu_torch.kernels.knn_topk import _launch as knn_launch
    from pathway_tpu_torch.ops.topk import NEG_INF

    g = torch.Generator(device=dev).manual_seed(SEED)
    bf16 = torch.bfloat16
    out: dict = {}

    # ---- K1 attention.  The embed path's shape: chunks of DOC_BATCH documents
    # of 64-256 tokens, padded to the batch's power-of-two width (256).  The
    # rerank path's: chunks of RERANK_BATCH pairs of 75-283 tokens in the
    # 128/256/512 buckets, and 32 pairs of one question.  Questions embed at
    # widths 16 and 32 in batches of 8 and 32 rows.  Also short/narrow shapes.
    def attn_inputs(B, L, H, D, min_len=1, max_len=None):
        max_len = max_len or L
        q, k, v = (torch.randn((B, L, H, D), generator=g, device=dev).to(bf16) for _ in range(3))
        lens = torch.randint(min_len, max_len + 1, (B,), generator=g, device=dev)
        lens[0] = max_len
        mask = (torch.arange(L, device=dev)[None] < lens[:, None]).to(torch.uint8)
        return q, k, v, mask

    attn_err = 0.0
    widths = set()
    for B, L, H, D in (
        (DOC_BATCH, 256, 12, 64), (DOC_BATCH, 128, 12, 64), (DOC_BATCH, 64, 12, 64),
        (RERANK_BATCH, 512, 12, 64), (32, 512, 12, 64), (32, 256, 12, 64), (32, 128, 12, 64),
        (32, 32, 12, 64), (8, 32, 12, 64), (8, 16, 12, 64), (4, 16, 12, 64), (4, 100, 12, 32),
    ):
        q, k, v, mask = attn_inputs(B, L, H, D)
        got = attention(q, k, v, mask).float()
        ref = attention_plain(q, k, v, mask).float()
        torch.cuda.synchronize()
        err = (got - ref).abs()
        if not torch.isfinite(got).all() or (err > ATTN_ATOL + ATTN_RTOL * ref.abs()).any():
            fail(f"attention B={B} L={L} D={D}: max err {err.max().item()}")
        attn_err = max(attn_err, err.max().item())
        if D == 64:
            widths.add(L)
        log(f"K1 attention B={B} L={L} H={H} D={D}: max_abs_err {err.max().item():.3e}")
        del q, k, v, mask, got, ref, err
    # the image path: every one of N_PATCH patches present, a partial last key tile
    q, k, v, mask = attn_inputs(IMAGE_BATCH, N_PATCH, 12, 64, min_len=N_PATCH)
    got = attention(q, k, v, mask).float()
    ref = attention_plain(q, k, v, mask).float()
    torch.cuda.synchronize()
    err = (got - ref).abs()
    if not bool(mask.all()) or not torch.isfinite(got).all() or (err > ATTN_ATOL + ATTN_RTOL * ref.abs()).any():
        fail(f"attention B={IMAGE_BATCH} L={N_PATCH} (all keys present): max err {err.max().item()}")
    attn_err = max(attn_err, err.max().item())
    widths.add(N_PATCH)
    log(f"K1 attention B={IMAGE_BATCH} L={N_PATCH} H=12 D=64, all keys: max_abs_err {err.max().item():.3e}")
    del q, k, v, mask, got, ref, err
    # masks with holes at the rerank shape (present key tiles between fully
    # masked ones; rows with no present key among partial rows), and the
    # image path's L at head dims 16 and 32, all keys and with holes
    # (their own generator: the later checks keep their inputs)
    g_new = torch.Generator(device=dev).manual_seed(SEED + 8)
    for B, L, D, holes in ((RERANK_BATCH, 512, 64, True), (IMAGE_BATCH, N_PATCH, 16, False),
                           (IMAGE_BATCH, N_PATCH, 32, False), (IMAGE_BATCH // 4, N_PATCH, 16, True),
                           (IMAGE_BATCH // 4, N_PATCH, 32, True)):
        q, k, v = (torch.randn((B, L, 12, D), generator=g_new, device=dev).to(bf16) for _ in range(3))
        mask = (holes_mask(torch, g_new, dev, B, L) if holes
                else torch.ones((B, L), dtype=torch.uint8, device=dev))
        label = f"bf16 B={B} L={L} H=12 D={D} {'holes' if holes else 'all keys'}"
        attn_err = max(attn_err, check_attention_case(
            torch, label, v, mask, attention(q, k, v, mask), attention_plain(q, k, v, mask), ATTN_ATOL, ATTN_RTOL))
        del q, k, v, mask

    walked_share = {}  # computed from the masks on the host, not read from the kernel

    def attn_timing(name, B, L, H, D, min_len, max_len=None):
        """Times at one shape; the bound counts the keys the masks keep:
        every query row attends over its batch row's present keys only."""
        q, k, v, mask = attn_inputs(B, L, H, D, min_len, max_len)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        sdpa_mask = mask.bool()[:, None, None, :]
        keys = int(mask.sum())
        nbytes = 2 * B * L * H * D * 2 + 2 * keys * H * D * 2 + B * L
        b_ms, b_by = bound(nbytes, 4 * H * D * L * keys, PEAK_BF16)
        walked_share[name] = int(walked_key_tiles(mask).sum()) / (B * -(-L // 64))
        return {
            "shape": f"B={B} L={L} H={H} D={D} bf16, {keys} of {B * L} keys present",
            "ms": time_ms(torch, lambda: attention(q, k, v, mask), 20),
            "plain_ms": time_ms(torch, lambda: attention_plain(q, k, v, mask), 5),
            "library_ms": time_ms(
                torch, lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=sdpa_mask), 20
            ),
            "bound_ms": b_ms,
            "bound_by": b_by,
        }

    out["attention"] = {**attn_timing("embed", DOC_BATCH, 256, 12, 64, 64), "max_abs_err": attn_err}
    out["_attention_b32_l512"] = attn_timing("b32_l512", 32, 512, 12, 64, 1)
    out["_attention_rerank"] = attn_timing("rerank", RERANK_BATCH, 512, 12, 64, 75, 283)
    out["_attention_image"] = attn_timing("image", IMAGE_BATCH, N_PATCH, 12, 64, N_PATCH)
    out["_attention_widths"] = widths
    log(f"K1 attention timings: {json.dumps(out['attention'])} {json.dumps(out['_attention_b32_l512'])}"
        f" {json.dumps(out['_attention_rerank'])} {json.dumps(out['_attention_image'])}")
    log("K1 key tiles walked (share of all, from the masks): " + json.dumps(walked_share))

    # ---- K2 slab scatter / clear: 256 rows (200 live + 56 pads) into [1M, 768] f32
    slab = torch.randn((CAPACITY, HIDDEN), generator=g, device=dev)
    slab /= slab.norm(dim=1, keepdim=True)
    valid = (torch.rand((CAPACITY,), generator=g, device=dev) >= 0.1).float()
    n_rows, n_live = 256, 200
    live = torch.randperm(CAPACITY, generator=g, device=dev)[:n_live]
    slots = torch.full((n_rows,), CAPACITY, dtype=torch.int32, device=dev)
    slots[:n_live] = live.int()
    vals = torch.randn((n_rows, HIDDEN), generator=g, device=dev) * 3.0
    slab_k, valid_k = slab.clone(), valid.clone()
    slab_p, valid_p = slab.clone(), valid.clone()
    slab_scatter(slab_k, valid_k, slots, vals, True)
    slab_scatter_plain(slab_p, valid_p, slots, vals, True)
    scatter_err = (slab_k - slab_p).abs().max().item()
    if scatter_err > SCATTER_ATOL or not torch.equal(valid_k, valid_p):
        fail(f"slab_scatter: max err {scatter_err}")
    slab_clear(valid_k, slots)
    slab_clear_plain(valid_p, slots)
    if not torch.equal(valid_k, valid_p):
        fail("slab_clear differs from its plain version")
    # bf16 slab, bf16 rows, no normalise
    sb_k = torch.zeros((4096, HIDDEN), dtype=bf16, device=dev)
    vb_k = torch.zeros((4096,), device=dev)
    sb_p, vb_p = sb_k.clone(), vb_k.clone()
    bslots = torch.randperm(4096, generator=g, device=dev)[:n_rows].int()
    bslots[-8:] = 4096
    slab_scatter(sb_k, vb_k, bslots, vals.to(bf16), False)
    slab_scatter_plain(sb_p, vb_p, bslots, vals.to(bf16), False)
    if not (torch.equal(sb_k, sb_p) and torch.equal(vb_k, vb_p)):
        fail("slab_scatter (bf16) differs from its plain version")
    log(f"K2 slab_scatter/slab_clear: max_abs_err {scatter_err:.3e}")
    kept = live.long()
    # what the function needs: every slot read; the live rows read, written
    # and their valid flags set (pad rows are dropped unread)
    nbytes = n_rows * 4 + n_live * HIDDEN * 4 + n_live * (HIDDEN * 4 + 4)
    b_ms, b_by = bound(nbytes, 3 * n_live * HIDDEN, PEAK_F32)
    out["slab_scatter"] = {
        "shape": f"b={n_rows} ({n_live} live) into [{CAPACITY},{HIDDEN}] f32, normalise",
        "max_abs_err": scatter_err,
        "ms": time_ms(torch, lambda: slab_scatter(slab_k, valid_k, slots, vals, True), 200),
        "plain_ms": time_ms(torch, lambda: slab_scatter_plain(slab_p, valid_p, slots, vals, True), 50),
        "library_ms": time_ms(torch, lambda: slab_k.index_copy_(0, kept, vals[:n_live]), 200),
        "bound_ms": b_ms,
        "bound_by": b_by,
    }
    b_ms, b_by = bound(n_rows * 4 + n_live * 4, 0, PEAK_F32)
    zeros = torch.zeros((n_live,), device=dev)
    out["slab_clear"] = {
        "shape": f"b={n_rows} ({n_live} live) of [{CAPACITY}] valid flags",
        "max_abs_err": 0.0,
        "ms": time_ms(torch, lambda: slab_clear(valid_k, slots), 200),
        "plain_ms": time_ms(torch, lambda: slab_clear_plain(valid_p, slots), 50),
        "library_ms": time_ms(torch, lambda: valid_k.index_copy_(0, kept, zeros), 200),
        "bound_ms": b_ms,
        "bound_by": b_by,
    }
    for name, kern, plain, lib in (
        ("slab_scatter", lambda: slab_scatter(slab_k, valid_k, slots, vals, True),
         lambda: slab_scatter_plain(slab_p, valid_p, slots, vals, True),
         lambda: slab_k.index_copy_(0, kept, vals[:n_live])),
        ("slab_clear", lambda: slab_clear(valid_k, slots), lambda: slab_clear_plain(valid_p, slots),
         lambda: valid_k.index_copy_(0, kept, zeros)),
    ):
        out[name]["device_ms"] = {
            "kernel": device_ms(torch, kern), "plain": device_ms(torch, plain),
            "library": device_ms(torch, lib),
        }
        log(f"K2 {name} device time (profiler): {json.dumps(out[name]['device_ms'])}")
    del slab_p, valid_p, sb_k, sb_p

    # ---- K3 knn_topk over the same slab, unit rows again, ~10% invalid: nq in {1, 32, 64}, k=10
    slab = slab_k
    slab /= slab.norm(dim=1, keepdim=True)
    valid = (torch.rand((CAPACITY,), generator=g, device=dev) >= 0.1).float()
    topk_err = 0.0
    timings = {}
    for nq in (1, 32, 64):
        qn = torch.randn((nq, HIDDEN), generator=g, device=dev)
        qn /= qn.norm(dim=1, keepdim=True)
        kv, ki = knn_topk(qn, slab, valid, K, "dot")
        pv, pi = knn_topk_plain(qn, slab, valid, K, "dot")
        torch.cuda.synchronize()
        topk_err = max(topk_err, compare_topk(kv, ki, pv, pi, TOPK_ATOL))
        if not bool((valid[ki.long()] == 1).all()):
            fail(f"knn_topk nq={nq} returned an invalid slot")
        # what the function needs: the valid rows (an invalid row's contents
        # never reach the answer), every valid flag, the queries, the output
        n_valid = int(valid.sum())
        nbytes = n_valid * HIDDEN * 4 + CAPACITY * 4 + nq * HIDDEN * 4 + nq * K * 8
        b_ms, b_by = bound(nbytes, 2 * nq * n_valid * HIDDEN, PEAK_F32_PRODUCT)
        timings[nq] = {
            "shape": f"nq={nq} k={K} over [{CAPACITY},{HIDDEN}] f32, {n_valid} rows valid",
            "ms": time_ms(torch, lambda: knn_topk(qn, slab, valid, K, "dot"), 10),
            "plain_ms": time_ms(torch, lambda: knn_topk_plain(qn, slab, valid, K, "dot"), 5),
            "library_ms": time_ms(torch, lambda: torch.topk(torch.matmul(qn, slab.T), K), 5),
            "bound_ms": b_ms,
            "bound_by": b_by,
        }
        log(f"K3 knn_topk nq={nq}: {json.dumps(timings[nq])}")
    # one pass over the slab per call at nq 32 and 64 (one group of queries):
    # the split of the queries, the tiled pass, then the merges
    for nq in (32, 64):
        width, groups = tiled_groups(nq)
        before = knn_topk.launches
        knn_topk(qn[:nq], slab, valid, K, "dot")  # qn: the 64 queries of the last timing
        got = knn_topk.launches - before
        blocks = min(-(-CAPACITY // 256), torch.cuda.get_device_properties(dev).multi_processor_count)
        want = 2 + merge_passes(blocks * K, K)  # one list a block and query
        if groups != 1 or got != want:
            fail(f"knn_topk nq={nq}: {got} launches, {groups} query groups; want {want}, one group")
        log(f"K3 knn_topk nq={nq}: {got} launches (the split, one tiled pass of {width} queries over the "
            f"slab on {blocks} blocks, {want - 2} merges)")
    # fewer live rows than k: the rest must come back as NEG_INF sentinels
    few = torch.zeros((CAPACITY,), device=dev)
    few[torch.randperm(CAPACITY, generator=g, device=dev)[:5]] = 1.0
    for qs in (qn[:2], qn):
        kv, ki = knn_topk(qs, slab, few, K, "dot")
        pv, pi = knn_topk_plain(qs, slab, few, K, "dot")
        topk_err = max(topk_err, compare_topk(kv[:, :5], ki[:, :5], pv[:, :5], pi[:, :5], TOPK_ATOL))
        if not bool((kv[:, 5:] <= NEG_INF / 2).all()):
            fail("knn_topk: missing NEG_INF sentinels when k > live rows")
    # both pass-1 paths: bf16 slab, l2sq (f32: the running lists of one
    # and of four entries a lane), the largest k
    small = slab[:65536].to(bf16)
    for qs in (qn[:2], qn[:32], qn):
        for s_, metric, k in ((small, "dot", 128), (small, "l2sq", 10), (slab[:65536], "l2sq", 10),
                              (slab[:65536], "l2sq", 128)):
            kv, ki = knn_topk(qs, s_, valid[:65536], k, metric)
            pv, pi = knn_topk_plain(qs, s_, valid[:65536], k, metric)
            topk_err = max(topk_err, compare_topk(kv, ki, pv, pi, TOPK_ATOL))
    # more than 64 queries: two groups of the tensor-core pass, each over
    # every tile, the running lists started again for the second
    q96 = torch.randn((96, HIDDEN), generator=torch.Generator(device=dev).manual_seed(SEED + 13), device=dev)
    q96 /= q96.norm(dim=1, keepdim=True)
    for k in (K, MAX_K):
        kv, ki = knn_topk(q96, slab, valid, k, "dot")
        pv, pi = knn_topk_plain(q96, slab, valid, k, "dot")
        topk_err = max(topk_err, compare_topk(kv, ki, pv, pi, TOPK_ATOL))
    log(f"K3 knn_topk nq=96 ({tiled_groups(96)[1]} query groups) at k {K} and {MAX_K}: equal to its plain version")
    del q96
    # the largest k: each block's running list of 128, four entries a lane
    k128 = {}
    for nq in (1, 32):
        qs = qn[:nq]
        k128[nq] = time_ms(torch, lambda: knn_topk(qs, slab, valid, MAX_K, "dot"), 5)
    log(f"K3 knn_topk k={MAX_K} ms by nq: {json.dumps(k128)}")
    # the two pass-1 paths against each other by nq: what sets TILED_MIN_QUERIES
    paths = {}
    for nq in (1, 2, 4, 8, 16, 32, 64):
        qs = torch.randn((nq, HIDDEN), generator=g, device=dev)
        qs /= qs.norm(dim=1, keepdim=True)
        pv, pi = knn_topk_plain(qs, slab, valid, K, "dot")
        row = {}
        for tiled in (False, True):
            kv, ki = knn_launch(qs, slab, valid, K, "dot", tiled)
            topk_err = max(topk_err, compare_topk(kv, ki, pv, pi, TOPK_ATOL))
            row["tiled_ms" if tiled else "rows_ms"] = time_ms(
                torch, lambda: knn_launch(qs, slab, valid, K, "dot", tiled), 5
            )
        paths[nq] = row
    log(f"K3 pass-1 paths by nq (TILED_MIN_QUERIES={TILED_MIN_QUERIES}): {json.dumps(paths)}")
    # a shard's search: rows [lo, hi) of the slab as the shard whose first
    # global slot is lo, which must come back as global slots
    # (one of phase 8's four shards), at k=10 and, through the score-only
    # pass and K13, at k=256
    lo, hi = CAPACITY // 4, CAPACITY // 2
    for nq in (1, 32):
        for k in (K, SELECT_K):
            kv, ki = knn_topk(qn[:nq], slab[lo:hi], valid[lo:hi], k, "dot", offset=lo)
            pv, pi = knn_topk_plain(qn[:nq], slab[lo:hi], valid[lo:hi], k, "dot", offset=lo)
            topk_err = max(topk_err, compare_topk(kv, ki, pv, pi, TOPK_ATOL))
            if not bool(((ki >= lo) & (ki < hi)).all()):
                fail(f"knn_topk k={k} with offset {lo}: a slot outside [{lo}, {hi})")
    log(f"K3 with offset {lo} over rows [{lo}, {hi}), k {K} and {SELECT_K}: equal to its plain version")
    # above MAX_K: k=256 over the 1M slab (the score-only pass 1, then K13)
    n_valid = int(valid.sum())
    k256 = {}
    for nq in (1, 32):
        qs = qn[:nq]
        kv, ki = knn_topk(qs, slab, valid, SELECT_K, "dot")
        pv, pi = knn_topk_plain(qs, slab, valid, SELECT_K, "dot")
        topk_err = max(topk_err, compare_topk(kv, ki, pv, pi, TOPK_ATOL))
        nbytes = n_valid * HIDDEN * 4 + CAPACITY * 4 + nq * HIDDEN * 4 + nq * SELECT_K * 8
        b_ms, b_by = bound(nbytes, 2 * nq * n_valid * HIDDEN, PEAK_F32_PRODUCT)
        k256[nq] = {
            "shape": f"nq={nq} k={SELECT_K} over [{CAPACITY},{HIDDEN}] f32, {n_valid} rows valid",
            "ms": time_ms(torch, lambda: knn_topk(qs, slab, valid, SELECT_K, "dot"), 5),
            "plain_ms": time_ms(torch, lambda: knn_topk_plain(qs, slab, valid, SELECT_K, "dot"), 3),
            "library_ms": time_ms(torch, lambda: torch.topk(torch.matmul(qs, slab.T), SELECT_K), 3),
            "bound_ms": b_ms,
            "bound_by": b_by,
        }
        log(f"K3 + K13 knn_topk k={SELECT_K}: {json.dumps(k256[nq])}")
    log(f"K3 knn_topk: max_abs_err {topk_err:.3e}")
    out["knn_topk"] = {**timings[32], "max_abs_err": topk_err}
    out["_knn_topk_by_nq"] = timings
    out["_knn_paths"] = paths
    out["_knn_k128"] = k128
    out["_knn_k256"] = k256

    # ---- K13 topk_select: what K3's score-only pass hands it, the masked
    # scores of 32 queries over the 1M slab, at k in {129, 256, 1024};
    # [32, 2048] centroid scores at k=256, the IVF's probe at its default
    # nprobe from 4,194,304 rows of capacity; and a reduction of candidate
    # lists with their ids, [32, 1024] at k=256: four shards' k=256 lists,
    # the sharded merge's shape
    scores = torch.where(valid.bool(), qn[:32] @ slab.T, NEG_INF)
    cents = torch.randn((2048, HIDDEN), generator=g, device=dev)
    cents /= cents.norm(dim=1, keepdim=True)
    probe_scores = qn[:32] @ cents.T
    cand = torch.randn((32, SHARDS * SELECT_K), generator=g, device=dev)
    cand_ids = torch.randint(0, 2**31 - 1, cand.shape, generator=g, device=dev, dtype=torch.int32)
    # Then the edge cases: an all-equal row and an ascending row (both timed,
    # so that a slow edge case shows; the ascending row's first chosen bin
    # overflows the candidate buffer and is refined), a row where half the
    # entries share the best value (its bin overflows down to the last
    # digit: ties to the lowest positions), rows masked to NEG_INF with fewer
    # live entries than k, signed zeros among ties, and k = n (a row of odd
    # length too).  Every case equals the plain version bit for bit, values
    # and ids.
    n = CAPACITY
    few = torch.full((8, 100_000), NEG_INF, device=dev)
    few[:, ::9_999] = torch.randn((8, 11), generator=g, device=dev)
    zeros = torch.zeros((4, 4096), device=dev)
    zeros[:, ::2] = -0.0
    zeros[:, 5::7] = 1.0
    odd = torch.randn((3, 12_345), generator=g, device=dev)
    head = scores[:2, :65536].contiguous()
    select_err, select_rows = 0.0, {}
    for name, vals, ids, k in (("k129", scores, None, MAX_K + 1), ("k256", scores, None, SELECT_K),
                               ("k1024", scores, None, 1024), ("probe", probe_scores, None, SELECT_K),
                               ("merge", cand, cand_ids, SELECT_K),
                               ("all_equal", torch.full((32, n), 0.25, device=dev), None, SELECT_K),
                               ("ascending", torch.arange(n, device=dev, dtype=torch.float32).expand(32, n)
                                .contiguous(), None, SELECT_K),
                               ("half_ties", torch.where(torch.rand(scores.shape, generator=g, device=dev) < 0.5,
                                                         0.5, scores), None, SELECT_K),
                               ("masked_few_live", few, None, SELECT_K), ("signed_zeros", zeros, None, 1000),
                               ("k_is_n", head, None, head.shape[1]),
                               ("k_is_n_odd_length", odd, None, odd.shape[1])):
        kv, ki = topk_select(vals, k, ids)
        pv, pi = topk_select_plain(vals, k, ids)
        select_err = max(select_err, compare_topk(kv, ki, pv, pi, SELECT_ATOL))
        if not (torch.equal(kv, pv) and torch.equal(ki, pi)):
            bad = (ki != pi).nonzero()[:5].tolist()
            fail(f"topk_select {name}: not equal to its plain version (values equal: {torch.equal(kv, pv)}; "
                 f"ids differ at {bad})")
        nq, n = vals.shape
        if name in ("masked_few_live", "signed_zeros", "half_ties") or name.startswith("k_is_n"):
            log(f"K13 topk_select {name} [{nq},{n}] k={k}: equal to its plain version")
            continue
        n_in = 4 if ids is None else 8  # bytes read per entry: a score, and its id
        b_ms, b_by = bound(nq * n * n_in + nq * k * 8, 0, PEAK_F32)
        select_rows[name] = {
            "shape": f"[{nq},{n}] f32 scores{'' if ids is None else ' + int32 ids'}, k={k}",
            "ms": time_ms(torch, lambda: topk_select(vals, k, ids), 10),
            "plain_ms": time_ms(torch, lambda: topk_select_plain(vals, k, ids), 10),
            "library_ms": time_ms(torch, lambda: torch.topk(vals, k, dim=1), 10),
            "bound_ms": b_ms,
            "bound_by": b_by,
        }
        if name in ("probe", "merge"):  # launches, not bytes, set these: the device's own time
            select_rows[name]["device_ms"] = {
                "kernel": device_ms(torch, lambda: topk_select(vals, k, ids)),
                "library": device_ms(torch, lambda: torch.topk(vals, k, dim=1)),
            }
        log(f"K13 topk_select {name}: {json.dumps(select_rows[name])}")
    before = topk_select.launches
    topk_select(scores, SELECT_K)
    launches = topk_select.launches - before
    log(f"K13 topk_select: {launches} kernels a call")
    out["topk_select"] = {**select_rows["k256"], "max_abs_err": select_err, "launches_per_call": launches}
    out["_topk_select_rows"] = select_rows
    edge = k3_edge_slab(np, torch, dev)
    out["_knn_edge"] = k3_edge_cases(torch, dev, {"tree": (knn_topk, knn_launch)}, edge)["tree"]
    out["_c15_edge"] = c15_edge_cases(torch, dev, {"tree": {
        "ivf_assign": ivf_assign, "ivf_scan": ivf_scan, "dual_logits": dual_logits}}, edge)["tree"]
    del edge
    return out


def k3_edge_slab(np, torch, dev) -> dict:
    """C13's rows: EDGE_BASE unit rows at d = HIDDEN, each with a
    near-duplicate at every cosine of EDGE_COS, EDGE_RANDOM unrelated unit
    rows, all valid, scattered over EDGE_SLAB rows of unit filler (10%
    invalid); queries are the base rows themselves and EDGE_RANDOM_QUERIES
    unit rows that are not in the slab.  Made in float64 by numpy from a
    seed and stored in f32."""
    rng = np.random.default_rng(SEED + 25)

    def unit(n):
        x = rng.standard_normal((n, HIDDEN))
        return x / np.linalg.norm(x, axis=1, keepdims=True)

    base = unit(EDGE_BASE)
    near = []
    for c in EDGE_COS:
        r = rng.standard_normal((EDGE_BASE, HIDDEN))
        r -= (r * base).sum(1, keepdims=True) * base
        r /= np.linalg.norm(r, axis=1, keepdims=True)
        near.append(c * base + math.sqrt(1.0 - c * c) * r)
    rows = np.concatenate([base, *near, unit(EDGE_RANDOM)])
    slab = unit(EDGE_SLAB)
    valid = (rng.random(EDGE_SLAB) >= 0.1).astype(np.float32)
    at = rng.permutation(EDGE_SLAB)[:len(rows)]
    slab[at] = rows
    valid[at] = 1.0
    queries = np.concatenate([slab[at[:EDGE_BASE]], unit(EDGE_RANDOM_QUERIES)])
    return {"slab": torch.from_numpy(slab.astype(np.float32)).to(dev),
            "valid": torch.from_numpy(valid).to(dev),
            "queries": torch.from_numpy(queries.astype(np.float32)).to(dev),
            "self_slot": torch.from_numpy(at[:EDGE_BASE].astype(np.int64)).to(dev),
            "edge_slots": torch.from_numpy(at.astype(np.int64)).to(dev),
            "near_slots": torch.from_numpy(at[EDGE_BASE:EDGE_BASE * (1 + len(EDGE_COS))].astype(np.int64)
                                           .reshape(len(EDGE_COS), EDGE_BASE)).to(dev)}


def k3_edge_cases(torch, dev, kernels: dict, data: dict | None = None) -> dict:
    """C13: K3 where q.x is near |q||x| (``k3_edge_slab``'s rows against
    themselves, their near-duplicates at cosines 0.99-0.9999, and random
    rows), in both forms (dot and l2sq), on the tensor-core pass (every
    query count of TC_WIDTHS and several groups) and the row-streaming pass
    (nq = 1, and groups of 32), each against the plain version
    (``knn_topk_plain``) and against float64 on the returned slots.
    ``kernels`` maps a label to ``(knn_topk, _launch)``: this tree's, and
    with ``--k3-edge DIR`` the parent's too.  The dot form's error on the
    self rows is the dot term's; the l2sq form's error there, less -2 times
    it, is the norms'.  Fails (after every label is measured) if the
    tree's cases miss TOPK_ATOL against the plain version, or a row's l2sq
    distance to itself is not below TOPK_ATOL; another label's failures
    are logged."""
    import numpy as np

    from pathway_tpu_torch.kernels import knn_topk_plain

    data = data or k3_edge_slab(np, torch, dev)
    slab, valid, queries = data["slab"], data["valid"], data["queries"]
    slab64 = slab.double()
    n_base = data["self_slot"].shape[0]
    out: dict = {}
    for label, (fn, launch_fn) in kernels.items():
        cases, bad = {}, []
        for metric in ("dot", "l2sq"):
            runs = [(f"tiled nq={nq}", lambda qs: fn(qs, slab, valid, EDGE_K, metric), nq)
                    for nq in (8, 16, 32, 64, queries.shape[0])]
            runs.append(("rows nq=1", None, 1))
            runs.append(("rows nq=32 groups", lambda qs: launch_fn(qs, slab, valid, EDGE_K, metric, False), None))
            for name, run, nq in runs:
                if run is None:  # one query a call: the row-streaming pass as knn_topk chooses it
                    qs = queries[:EDGE_SINGLE]
                    got = [fn(qs[i:i + 1], slab, valid, EDGE_K, metric) for i in range(EDGE_SINGLE)]
                    kv, ki = torch.cat([v for v, _ in got]), torch.cat([i for _, i in got])
                else:
                    qs = queries if nq is None else queries[:nq]
                    kv, ki = run(qs)
                pv, pi = knn_topk_plain(qs, slab, valid, EDGE_K, metric)
                torch.cuda.synchronize()
                q64, x64 = qs.double()[:, None, :], slab64[ki.long()]
                exact = (q64 * x64).sum(-1) if metric == "dot" else -((q64 - x64) ** 2).sum(-1)
                p64 = slab64[pi.long()]
                p_exact = (q64 * p64).sum(-1) if metric == "dot" else -((q64 - p64) ** 2).sum(-1)
                err = (kv.double() - exact).abs()
                nb = min(qs.shape[0], n_base)  # queries that are slab rows
                is_self = ki[:nb].long() == data["self_slot"][:nb, None]
                is_near = (ki[:nb, :, None].long() == data["near_slots"].T[:nb, None, :]).any(-1)
                row = {
                    "vs_plain": (kv - pv).abs().max().item(),
                    "vs_f64": err.max().item(),
                    "plain_vs_f64": (pv.double() - p_exact).abs().max().item(),
                    "self_vs_f64": err[:nb][is_self].max().item() if bool(is_self.any()) else None,
                    "self_signed_mean": (kv.double() - exact)[:nb][is_self].mean().item()
                    if bool(is_self.any()) else None,
                    "near_vs_f64": err[:nb][is_near].max().item() if bool(is_near.any()) else None,
                    "random_vs_f64": err[nb:].max().item() if qs.shape[0] > nb else None,
                }
                if metric == "l2sq" and bool(is_self.any()):
                    row["self_distance"] = (-kv[:nb][is_self]).max().item()
                if not bool(is_self[:, 0].all()):
                    bad.append(f"{metric} {name}: a row is not its own first neighbour")
                try:
                    compare_topk(kv, ki, pv, pi, TOPK_ATOL)
                except SystemExit as e:
                    bad.append(f"{metric} {name}: {e}")
                if row.get("self_distance", 0.0) >= TOPK_ATOL:
                    bad.append(f"{metric} {name}: a row's l2sq distance to itself is {row['self_distance']:.3e}")
                cases[f"{metric} {name}"] = row
                log(f"K3 edge [{label}] {metric} {name}: {json.dumps(row)}")
        # the l2sq error of the self rows split: the dot term's (-2 x the dot
        # form's signed error on the same rows) and the rest, the norms'
        split = {}
        for name in [c.split(" ", 1)[1] for c in cases if c.startswith("dot ")]:
            d, l2 = cases[f"dot {name}"]["self_signed_mean"], cases[f"l2sq {name}"]["self_signed_mean"]
            if d is not None and l2 is not None:
                split[name] = {"l2sq_self_signed": l2, "dot_term": 2.0 * d, "norms_term": l2 - 2.0 * d}
        log(f"K3 edge [{label}] self rows, l2sq error split (kernel - f64, mean): {json.dumps(split)}")
        out[label] = {"cases": cases, "split": split, "failures": bad}
        log(f"K3 edge [{label}]: {len(bad)} failures" + (": " + "; ".join(bad) if bad else ""))
    if out["tree"]["failures"]:
        fail("K3 near q.x = |q||x| (C13): " + "; ".join(out["tree"]["failures"]))
    return out


def c15_edge_cases(torch, dev, kernels: dict, data: dict | None = None) -> dict:
    """C15: C13's rows (``k3_edge_slab``) through K11, K12 and K10, whose
    tensor-core sums C13's repair of K3 did not reach.  ``kernels`` maps a
    label to ``{"ivf_assign": fn, "ivf_scan": fn, "dual_logits": fn}``:
    this tree's wrappers, and with ``--k3-edge DIR`` the parent's too.

    - K11, both forms: every slab row against centroids seeded from slab
      rows, as ``_kmeans`` seeds them (the base rows and their
      near-duplicates; at 4,096 also the random edge rows and other slab
      rows), so each seeded row is scored against itself.  Decided rows
      that differ and the chosen centroid's shortfall, against the plain
      version's f32 scores and against float64.
    - K12, query-major (nq = 1) and cell-major (nq = 32), over f32 and
      bf16 cells (the slab as C15_SCAN_CELLS cells of C15_SCAN_CAP slots,
      each query probing its own cell and its near-duplicates' first):
      the returned scores against the plain version and against float64
      of the rows (for bf16 cells, of the bf16-rounded query and rows);
      over f32 cells a stored row must come back as its own first
      neighbour.
    - K10: the base rows as images against each group of edge rows as
      texts (IMAGE_BATCH x N_CAPTIONS, phase 5's shape), and all 1,280
      edge rows as both, at phase 2's logit scale and bias, against the
      plain version and float64.

    Fails (after every label is measured) if the tree's cases miss
    ASSIGN_ATOL, TOPK_ATOL or LOGIT_ATOL; another label's failures are
    logged."""
    import ctypes

    import numpy as np

    from pathway_tpu_torch.kernels import _build, dual_logits_plain, ivf_assign_plain, ivf_scan_plain
    from pathway_tpu_torch.kernels.ivf_scan import scan_form

    data = data or k3_edge_slab(np, torch, dev)
    slab, valid, queries = data["slab"], data["valid"], data["queries"]
    at, self_slot, near_slots = data["edge_slots"], data["self_slot"], data["near_slots"]
    n_base = self_slot.shape[0]
    out = {label: {"cases": {}, "failures": []} for label in kernels}

    def record(label: str, name: str, row: dict, bad: list) -> None:
        out[label]["cases"][name] = row
        out[label]["failures"] += [f"{name}: {b}" for b in bad]
        log(f"C15 edge [{label}] {name}: {json.dumps(row)}")

    # ---- K11: centroids seeded from slab rows
    g = torch.Generator().manual_seed(SEED + 26)
    others = torch.ones(EDGE_SLAB, dtype=torch.bool)
    others[at.cpu()] = False
    pool = others.nonzero()[:, 0][torch.randperm(int(others.sum()), generator=g)].to(dev)
    x64 = slab.double()
    for nlist in C15_NLISTS:
        seeds = at[:nlist] if nlist <= at.shape[0] else torch.cat([at, pool[:nlist - at.shape[0]]])
        c = slab[seeds].contiguous()
        c64 = c.double()
        for half_norm in (False, True):
            s32, s64 = slab @ c.T, x64 @ c64.T
            if half_norm:
                s32 -= 0.5 * (c * c).sum(1)
                s64 -= 0.5 * (c64 * c64).sum(1)
            v32, v64 = s32.topk(2, dim=1), s64.topk(2, dim=1)
            dec32 = (v32.values[:, 0] - v32.values[:, 1]) > ASSIGN_ATOL
            dec64 = (v64.values[:, 0] - v64.values[:, 1]) > ASSIGN_ATOL
            want = ivf_assign_plain(slab, c, half_norm).long()
            plain_row = {
                "plain_differ_vs_f64": int((want != v64.indices[:, 0])[dec64].sum()),
                "plain_shortfall_vs_f64": (v64.values[:, 0] - s64.gather(1, want[:, None])[:, 0]).max().item(),
            }
            for label, fns in kernels.items():
                got = fns["ivf_assign"](slab, c, half_norm).long()
                torch.cuda.synchronize()
                row = {
                    "rows": EDGE_SLAB, "nlist": nlist,
                    "decided_vs_plain": int(dec32.sum()), "decided_vs_f64": int(dec64.sum()),
                    "differ_vs_plain": int((got != want)[dec32].sum()),
                    "differ_vs_f64": int((got != v64.indices[:, 0])[dec64].sum()),
                    "shortfall_vs_plain": (v32.values[:, 0] - s32.gather(1, got[:, None])[:, 0]).max().item(),
                    "shortfall_vs_f64": (v64.values[:, 0] - s64.gather(1, got[:, None])[:, 0]).max().item(),
                    "seeded_rows_own_centroid": int((got[seeds] == torch.arange(nlist, device=dev)).sum()),
                    **plain_row,
                }
                bad = []
                if row["differ_vs_plain"] or row["differ_vs_f64"]:
                    bad.append(f"{row['differ_vs_plain']} / {row['differ_vs_f64']} decided rows differ "
                               "from the plain version / float64")
                if not max(row["shortfall_vs_plain"], row["shortfall_vs_f64"]) <= ASSIGN_ATOL:
                    bad.append(f"a chosen centroid scores {row['shortfall_vs_f64']:.3e} below float64's best "
                               f"({row['shortfall_vs_plain']:.3e} below the plain version's)")
                record(label, f"K11 nlist={nlist} half_norm={half_norm}", row, bad)
            del s32, s64
    del x64

    # ---- K12: the slab as cells; stored rows query their own cells first
    cap = C15_SCAN_CAP
    nlist = EDGE_SLAB // cap
    order = torch.randperm(nlist, generator=g).tolist()
    probe_rows = []
    for i in range(queries.shape[0]):
        first = []
        if i < n_base:
            for slot in [int(self_slot[i])] + [int(s) for s in near_slots[:, i]]:
                if slot // cap not in first:
                    first.append(slot // cap)
        probe_rows.append((first + [cell for cell in order if cell not in first])[:C15_SCAN_NPROBE])
    probe = torch.tensor(probe_rows, dtype=torch.int32, device=dev)
    vcells = valid.reshape(nlist, cap)
    for dtype in (torch.float32, torch.bfloat16):
        cells = slab.reshape(nlist, cap, HIDDEN).to(dtype)
        rows64 = cells.double().reshape(-1, HIDDEN)
        q_round = queries.to(dtype).double()
        plan = (ctypes.c_longlong * 2)()
        if not _build.library("ivf_scan").pw_ivf_scan_cells_plan(
                HIDDEN, int(dtype == torch.bfloat16), EDGE_K, nlist, cap, 32 * C15_SCAN_NPROBE, plan):
            fail(f"C15: the cell-major scan refuses its edge case ({dtype})")
        tname = "f32" if dtype == torch.float32 else "bf16"
        for form, nq in (("query-major nq=1", 1), ("cell-major nq=32", 32)):
            if scan_form(nq) != form.split("-")[0]:
                fail(f"C15: ivf_scan at nq={nq} is not {form}")
            spans = ([(i, i + 1) for i in range(EDGE_SINGLE)] if nq == 1
                     else [(lo, min(lo + nq, queries.shape[0])) for lo in range(0, queries.shape[0], nq)])
            if nq > 1 and queries.shape[0] % nq:
                fail(f"C15: {queries.shape[0]} edge queries are not whole batches of {nq}")
            qs = queries[:spans[-1][1]]
            pv, pi = ivf_scan_plain(qs, probe[:len(qs)], cells, vcells, EDGE_K)
            for label, fns in kernels.items():
                got = [fns["ivf_scan"](queries[lo:hi], probe[lo:hi], cells, vcells, EDGE_K) for lo, hi in spans]
                kv, ki = torch.cat([v for v, _ in got]), torch.cat([i for _, i in got])
                torch.cuda.synchronize()
                exact = (q_round[:len(qs), None, :] * rows64[ki.long()]).sum(-1)
                err = (kv.double() - exact).abs()
                nb = min(len(qs), n_base)
                is_self = ki[:nb].long() == self_slot[:nb, None]
                row = {
                    "cells": f"[{nlist}, {cap}, {HIDDEN}] {tname}", "nprobe": C15_SCAN_NPROBE, "queries": len(qs),
                    "vs_plain": (kv - pv).abs().max().item(),
                    "vs_f64": err.max().item(),
                    "plain_vs_f64": (pv.double() - (q_round[:len(qs), None, :] * rows64[pi.long()]).sum(-1))
                    .abs().max().item(),
                    "self_vs_f64": err[:nb][is_self].max().item() if bool(is_self.any()) else None,
                    "self_signed_mean": (kv.double() - exact)[:nb][is_self].mean().item()
                    if bool(is_self.any()) else None,
                    "random_vs_f64": err[nb:].max().item() if len(qs) > nb else None,
                    "self_first": int(is_self[:, 0].sum()), "stored_queries": nb,
                }
                bad = []
                try:
                    compare_topk(kv, ki, pv, pi, TOPK_ATOL)
                except SystemExit as e:
                    bad.append(str(e))
                if not row["vs_f64"] <= TOPK_ATOL:
                    bad.append(f"a score {row['vs_f64']:.3e} from float64")
                if dtype == torch.float32 and row["self_first"] != nb:
                    bad.append(f"{nb - row['self_first']} stored rows are not their own first neighbour")
                record(label, f"K12 {tname} {form}", row, bad)
        del cells, rows64

    # ---- K10: the edge rows as images and texts, at phase 5's shape
    # (IMAGE_BATCH images x N_CAPTIONS captions) and all of them at once
    rows = slab[at].contiguous()
    groups = {"base": rows[:n_base], "random": rows[n_base * (1 + len(EDGE_COS)):]}
    groups.update({f"near {c}": rows[n_base * (1 + j):n_base * (2 + j)] for j, c in enumerate(EDGE_COS)})
    scale, lbias = torch.tensor(2.3, device=dev), torch.tensor(-0.5, device=dev)
    k10_cases = [(f"base x {name}", groups["base"], groups[name], True) for name in groups]
    k10_cases.append(("edge x edge", rows, rows, False))
    for name, a, b, path_shape in k10_cases:
        ref = dual_logits_plain(a, b, scale, lbias)
        ref64 = (a.double() @ b.double().T) * math.exp(scale.item()) + lbias.item()
        for label, fns in kernels.items():
            got = fns["dual_logits"](a, b, scale, lbias)
            torch.cuda.synchronize()
            err = (got.double() - ref64).abs()
            diag = torch.arange(min(a.shape[0], b.shape[0]), device=dev)
            row = {
                "shape": f"[{a.shape[0]}, {HIDDEN}] x [{b.shape[0]}, {HIDDEN}]^T f32, * e^2.3 - 0.5",
                "vs_plain": (got - ref).abs().max().item(), "vs_f64": err.max().item(),
                "plain_vs_f64": (ref.double() - ref64).abs().max().item(),
                "diagonal_vs_f64": err[diag, diag].max().item(),
                "diagonal_signed_mean": (got.double() - ref64)[diag, diag].mean().item(),
            }
            bad = []
            # at the path's shape, within LOGIT_ATOL of the plain version and
            # of float64; over all 1,280 edge rows the plain version's own
            # f32 sums are further than LOGIT_ATOL from float64 (cuBLAS's
            # order at that shape), so there the kernel is held to float64
            if path_shape and not row["vs_plain"] <= LOGIT_ATOL:
                bad.append(f"logits {row['vs_plain']:.3e} from the plain version")
            if not row["vs_f64"] <= LOGIT_ATOL:
                bad.append(f"logits {row['vs_f64']:.3e} from float64")
            record(label, f"K10 {name}", row, bad)

    for label, res in out.items():
        log(f"C15 edge [{label}]: {len(res['failures'])} failures"
            + (": " + "; ".join(res["failures"]) if res["failures"] else ""))
    if out["tree"]["failures"]:
        fail("K11/K12/K10 near q.x = |q||x| (C15): " + "; ".join(out["tree"]["failures"]))
    return out


def phase_k3_edge(torch, dev, parent: str | None) -> dict:
    """``--k3-edge [DIR]``: ``k3_edge_cases`` on this tree's K3 and, with
    DIR (an unpacked ``git archive`` of another commit), on that commit's
    K3 wrapper and kernel on the same rows first; then both timed in turns
    (parent, tree, tree, parent) at phase 2's shapes over a 1,048,576 x 768
    unit f32 slab, 10% invalid: nq 1 and 32 at k=10, nq 32 at k=128; and
    ``c15_edge_cases`` on both trees' K11, K12 and K10 after K3's, with
    K10 timed in turns at phase 2's shape."""
    import types

    import numpy as np

    from pathway_tpu_torch.kernels import MAX_K, dual_logits, ivf_assign, ivf_scan, knn_topk
    from pathway_tpu_torch.kernels import _build
    from pathway_tpu_torch.kernels.knn_topk import _launch as knn_launch

    kernels, c15 = {}, {}
    if parent:
        pb = parent_kernel_module(parent, "_build")
        if all(pb._target(name).name == _build._target(name).name for name in EDGE_KERNELS):
            fail("--k3-edge: the parent's builds of " + ", ".join(EDGE_KERNELS) + " are this tree's")
        pb.build_all(EDGE_KERNELS)
        mods = {name: parent_kernel_module(parent, name) for name in ("knn_topk", "ivf_assign", "ivf_scan",
                                                                      "dual_logits")}
        for mod in mods.values():
            mod._build = types.SimpleNamespace(library=pb.library)
        kernels["parent"] = (mods["knn_topk"].knn_topk, mods["knn_topk"]._launch)
        c15["parent"] = {name: getattr(mods[name], name) for name in ("ivf_assign", "ivf_scan", "dual_logits")}
    kernels["tree"] = (knn_topk, knn_launch)
    c15["tree"] = {"ivf_assign": ivf_assign, "ivf_scan": ivf_scan, "dual_logits": dual_logits}
    data = k3_edge_slab(np, torch, dev)
    try:
        res = {"cases": k3_edge_cases(torch, dev, kernels, data),
               "c15": c15_edge_cases(torch, dev, c15, data)}
    finally:
        del data
    if not parent:
        return res
    g = torch.Generator(device=dev).manual_seed(SEED)
    slab = torch.randn((CAPACITY, HIDDEN), generator=g, device=dev)
    slab /= slab.norm(dim=1, keepdim=True)
    valid = (torch.rand((CAPACITY,), generator=g, device=dev) >= 0.1).float()
    qn = torch.randn((32, HIDDEN), generator=g, device=dev)
    qn /= qn.norm(dim=1, keepdim=True)
    times = {}
    for nq, k in ((1, K), (32, K), (32, MAX_K)):
        qs = qn[:nq]
        t = {"parent": [], "tree": []}
        for who in ("parent", "tree", "tree", "parent"):
            f = kernels[who][0]
            t[who].append(time_ms(torch, lambda: f(qs, slab, valid, k, "dot"), 10))
        times[f"nq={nq} k={k}"] = {who: sum(v) / 2 for who, v in t.items()} | {"turns": t}
        log(f"K3 [parent vs tree] nq={nq} k={k} over [{CAPACITY},{HIDDEN}] f32: {json.dumps(times[f'nq={nq} k={k}'])}")
    # K10 at phase 2's shape (C15's repair): CUDA events and device time
    img = torch.randn((IMAGE_BATCH, HIDDEN), generator=g, device=dev)
    txt = torch.randn((N_CAPTIONS, HIDDEN), generator=g, device=dev)
    img /= img.norm(dim=1, keepdim=True)
    txt /= txt.norm(dim=1, keepdim=True)
    scale, lbias = torch.tensor(2.3, device=dev), torch.tensor(-0.5, device=dev)
    t = {"parent": [], "tree": [], "parent_device": [], "tree_device": []}
    for who in ("parent", "tree", "tree", "parent"):
        f = c15[who]["dual_logits"]
        t[who].append(time_ms(torch, lambda: f(img, txt, scale, lbias), 50))
        t[f"{who}_device"].append(device_ms(torch, lambda: f(img, txt, scale, lbias)))
    times["dual_logits"] = {who: sum(v) / 2 for who, v in t.items()} | {"turns": t}
    log(f"K10 [parent vs tree] [{IMAGE_BATCH},{HIDDEN}] x [{N_CAPTIONS},{HIDDEN}]^T f32: "
        f"{json.dumps(times['dual_logits'])}")
    res["times"] = times
    return res


def check_bf16(name: str, got, ref) -> float:
    """``got`` within two bf16 ulps of ``ref`` everywhere (BF16_RTOL, plus
    FUSED_ATOL near zero); returns the largest absolute difference."""
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    bad = ~(err <= BF16_RTOL * ref.abs() + FUSED_ATOL)  # NaN counts as bad
    if bool(bad.any()) or not bool(got.isfinite().all()):
        fail(f"{name}: {int(bad.sum())} values off, max abs err {err.max().item()}")
    return err.max().item()


def phase_fused(torch, dev) -> dict:
    """Phase 2, continued: K4-K7 against their plain versions at the shapes
    of the embed path (M = DOC_BATCH x 256 rows) and the rerank path
    (M = RERANK_BATCH x 512 rows, the pooler at M = RERANK_BATCH); the
    ingest tail (K7's slab form) against its plain version and against K7
    then K2, CLS and mean into f32 and bf16 slabs, with pad rows."""
    import torch.nn.functional as F

    from pathway_tpu_torch.kernels import (
        add_layer_norm,
        add_layer_norm_plain,
        bias_act,
        bias_act_plain,
        embed_ln,
        embed_ln_plain,
        pool_normalize,
        pool_normalize_into,
        pool_normalize_into_plain,
        pool_normalize_plain,
        slab_scatter,
    )

    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    bf16 = torch.bfloat16
    rows_embed, rows_rerank, rows_image = DOC_BATCH * 256, RERANK_BATCH * 512, IMAGE_BATCH * N_PATCH
    out: dict = {}

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    # ---- K4 bias_act: y is a bf16 product, updated in place
    flops_per = {"none": 1, "gelu_tanh": 9, "gelu_erf": 8, "tanh": 2}
    k4 = {}
    for label, M, N, act in (
        ("embed q/k/v/out/mlp_down", rows_embed, HIDDEN, "none"),
        ("embed mlp_up", rows_embed, 4 * HIDDEN, "gelu_tanh"),
        ("rerank q/k/v/out/mlp_down", rows_rerank, HIDDEN, "none"),
        ("rerank mlp_up", rows_rerank, 4 * HIDDEN, "gelu_tanh"),
        ("image q/k/v/out/mlp_down", rows_image, HIDDEN, "none"),
        ("image mlp_up", rows_image, 4 * HIDDEN, "gelu_tanh"),
        ("gelu_erf", 4096, 4 * HIDDEN, "gelu_erf"),
        ("rerank pooler", RERANK_BATCH, HIDDEN, "tanh"),
    ):
        y = randn(M, N).to(bf16)
        bias = randn(N, scale=0.5)
        got = bias_act(y.clone(), bias, act)
        ref = bias_act_plain(y.clone(), bias, act)
        torch.cuda.synchronize()
        row = {"shape": f"M={M} N={N} act={act} bf16 ({label})",
               "max_abs_err": check_bf16(f"bias_act {label}", got, ref)}
        del got, ref
        b_ms, b_by = bound(2 * M * N * 2 + N * 4, flops_per[act] * M * N, PEAK_F32)
        row.update(
            ms=time_ms(torch, lambda: bias_act(y, bias, act), 20),
            plain_ms=time_ms(torch, lambda: bias_act_plain(y, bias, act), 5),
            bound_ms=b_ms, bound_by=b_by, library_ms=None,
        )
        if act == "none":  # one call computes it: the add of the bf16 bias (cast once, untimed)
            b16 = bias.to(bf16)
            row["library_ms"] = time_ms(torch, lambda: torch.add(y, b16, out=y), 20)
        if M * N < 1 << 20:  # launch-bound: the profiler's device time too
            row["device_ms"] = {
                "kernel": device_ms(torch, lambda: bias_act(y, bias, act)),
                "plain": device_ms(torch, lambda: bias_act_plain(y, bias, act)),
            }
        k4[label] = row
        log(f"K4 bias_act: {json.dumps(row)}")
        del y
    out["bias_act"] = {**k4["embed q/k/v/out/mlp_down"],
                       "max_abs_err": max(r["max_abs_err"] for r in k4.values())}
    out["_bias_act_shapes"] = k4

    # ---- K5 add_layer_norm
    k5 = {}
    for label, M in (("embed", rows_embed), ("rerank", rows_rerank), ("image", rows_image)):
        x, r = randn(M, HIDDEN).to(bf16), randn(M, HIDDEN).to(bf16)
        scale, bias = 1.0 + randn(HIDDEN, scale=0.1), randn(HIDDEN, scale=0.1)
        got = add_layer_norm(x, r, scale, bias, 1e-12)
        ref = add_layer_norm_plain(x, r, scale, bias, 1e-12)
        torch.cuda.synchronize()
        row = {"shape": f"M={M} H={HIDDEN} bf16 ({label})",
               "max_abs_err": check_bf16(f"add_layer_norm {label}", got, ref)}
        del got, ref
        b_ms, b_by = bound(3 * M * HIDDEN * 2 + 2 * HIDDEN * 4, 10 * M * HIDDEN, PEAK_F32)
        row.update(
            ms=time_ms(torch, lambda: add_layer_norm(x, r, scale, bias, 1e-12), 20),
            plain_ms=time_ms(torch, lambda: add_layer_norm_plain(x, r, scale, bias, 1e-12), 5),
            bound_ms=b_ms, bound_by=b_by, library_ms=None,  # no single torch call adds and normalises
        )
        k5[label] = row
        log(f"K5 add_layer_norm: {json.dumps(row)}")
        del x, r
    out["add_layer_norm"] = {**k5["embed"], "max_abs_err": max(r["max_abs_err"] for r in k5.values())}
    out["_add_layer_norm_shapes"] = k5

    # ---- K6 embed_ln: BGE-base's tables, ids as the executor uploads them
    vocab, n_pos = 30522, 512
    word, position, types = randn(vocab, HIDDEN, scale=0.02), randn(n_pos, HIDDEN, scale=0.02), randn(2, HIDDEN, scale=0.02)
    scale, bias = 1.0 + randn(HIDDEN, scale=0.1), randn(HIDDEN, scale=0.1)
    k6 = {}
    for label, B, L in (("embed", DOC_BATCH, 256), ("embed", DOC_BATCH, 128), ("embed", DOC_BATCH, 64),
                        ("rerank", RERANK_BATCH, 512), ("question", 8, 16)):
        ids = torch.randint(1000, vocab, (B, L), generator=g, device=dev).to(torch.int16)
        tids = (torch.arange(L, device=dev)[None] >= L // 3).expand(B, L).to(torch.uint8).contiguous()
        args = (ids, tids, word, position, types, scale, bias, 1e-12)
        got = embed_ln(*args)
        ref = embed_ln_plain(*args, bf16)
        torch.cuda.synchronize()
        err = check_bf16(f"embed_ln B={B} L={L}", got, ref)
        del got, ref
        if (B, L) not in ((DOC_BATCH, 256), (RERANK_BATCH, 512)):
            continue
        # bytes the data needs: each distinct word row, the L position rows
        # and both type rows once, the ids and type ids, the output
        distinct = int(torch.unique(ids).numel())
        nbytes = (distinct + L + 2) * HIDDEN * 4 + B * L * 3 + B * L * HIDDEN * 2
        b_ms, b_by = bound(nbytes, 14 * B * L * HIDDEN, PEAK_F32)
        row = {
            "shape": f"B={B} L={L} H={HIDDEN} int16 ids ({distinct} distinct), uint8 types -> bf16 ({label})",
            "max_abs_err": err,
            "ms": time_ms(torch, lambda: embed_ln(*args), 20),
            "plain_ms": time_ms(torch, lambda: embed_ln_plain(*args, bf16), 5),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None,  # no single torch call gathers, sums and normalises
        }
        k6[label] = row
        log(f"K6 embed_ln: {json.dumps(row)}")
    # ids out of range, as flax's nn.Embed takes them: >= vocab or < -vocab
    # give a NaN row, [-vocab, 0) wraps; type ids likewise
    bad_ids = [vocab, vocab + 5, -1, -vocab, -vocab - 1, -17, 2 * vocab // 3]
    for id_dtype in (torch.int16, torch.int32, torch.int64):
        ids = torch.randint(1000, vocab, (8, 16), generator=g, device=dev)
        ids[0, : len(bad_ids)] = torch.tensor(bad_ids, device=dev)
        tids = torch.zeros((8, 16), dtype=torch.int64, device=dev)
        tids[1, :4] = torch.tensor([1, 2, -1, -3], device=dev)
        args = (ids.to(id_dtype), tids.to(id_dtype), word, position, types, scale, bias, 1e-12)
        got = embed_ln(*args)
        ref = embed_ln_plain(*args, bf16)
        torch.cuda.synchronize()
        want_nan = (ids >= vocab) | (ids < -vocab) | (tids >= 2) | (tids < -2)
        nan_got, nan_ref = got.isnan().all(-1), ref.isnan().all(-1)
        if not (torch.equal(nan_got, want_nan) and torch.equal(nan_ref, want_nan)):
            fail(f"embed_ln {id_dtype}: NaN rows {nan_got.nonzero().tolist()}, plain "
                 f"{nan_ref.nonzero().tolist()}, flax {want_nan.nonzero().tolist()}")
        wrapped = embed_ln_plain(torch.where(ids < 0, ids + vocab, ids).clamp(max=vocab - 1),
                                 torch.where(tids < 0, tids + 2, tids).clamp(max=1), *args[2:], bf16)
        live = ~want_nan
        err = check_bf16(f"embed_ln {id_dtype} out-of-range ids", got[live], ref[live])
        if not torch.equal(ref[live], wrapped[live]):
            fail(f"embed_ln_plain {id_dtype}: negative ids do not wrap as flax's do")
        k6["embed"]["max_abs_err"] = max(k6["embed"]["max_abs_err"], err)
    log(f"K6 embed_ln out-of-range ids: NaN rows {int(want_nan.sum())} of {want_nan.numel()} as flax, "
        "negative ids wrapped, for int16/int32/int64 ids")
    out["embed_ln"] = {**k6["embed"], "max_abs_err": max(r["max_abs_err"] for r in k6.values())}
    out["_embed_ln_shapes"] = k6

    # ---- K7 pool_normalize: CLS + normalise is BGE-base's tail; mean + normalise
    # is MiniLM's/E5's, timed for the record
    x = randn(DOC_BATCH, 256, HIDDEN).to(bf16)
    lens = torch.randint(64, 257, (DOC_BATCH,), generator=g, device=dev)
    mask = (torch.arange(256, device=dev)[None] < lens[:, None]).to(torch.uint8)
    k7 = {}
    for pool in ("cls", "mean"):
        got = pool_normalize(x, mask, pool, True)
        ref = pool_normalize_plain(x, mask, pool, True)
        torch.cuda.synchronize()
        err = check_bf16(f"pool_normalize {pool}", got, ref)
        rows = DOC_BATCH if pool == "cls" else int(mask.sum())
        nbytes = rows * HIDDEN * 2 + (0 if pool == "cls" else DOC_BATCH * 256) + DOC_BATCH * HIDDEN * 4
        b_ms, b_by = bound(nbytes, (2 * rows + 4 * DOC_BATCH) * HIDDEN, PEAK_F32)
        row = {
            "shape": f"B={DOC_BATCH} L=256 H={HIDDEN} bf16, {pool} + normalise, {rows} rows read",
            "max_abs_err": err,
            "ms": time_ms(torch, lambda: pool_normalize(x, mask, pool, True), 50),
            "plain_ms": time_ms(torch, lambda: pool_normalize_plain(x, mask, pool, True), 20),
            "bound_ms": b_ms, "bound_by": b_by,
            # CLS: F.normalize of the first token in f32 is the same function
            # (eps 1e-12); no single torch call takes a masked mean
            "library_ms": time_ms(torch, lambda: F.normalize(x[:, 0].float(), dim=-1), 50) if pool == "cls" else None,
        }
        row["device_ms"] = {
            "kernel": device_ms(torch, lambda: pool_normalize(x, mask, pool, True)),
            "plain": device_ms(torch, lambda: pool_normalize_plain(x, mask, pool, True)),
            **({"library": device_ms(torch, lambda: F.normalize(x[:, 0].float(), dim=-1))} if pool == "cls" else {}),
        }
        k7[pool] = row
        log(f"K7 pool_normalize: {json.dumps(row)}")
    out["pool_normalize"] = {**k7["cls"], "max_abs_err": max(r["max_abs_err"] for r in k7.values())}
    out["_pool_normalize_shapes"] = k7

    # ---- the ingest tail (K7's slab form, K2's scatter in the same launch):
    # the embed chunk's last hidden state into a 1M-slot cosine slab, 200
    # live sequences and 56 pads (dropped unread), CLS (BGE-base) and mean
    # (E5), f32 and bf16 slabs; held against its plain version and against
    # K7 then K2 on the card
    n_live = DOC_BATCH * 25 // 32  # 200 live sequences of 256
    slots = torch.full((DOC_BATCH,), CAPACITY, dtype=torch.int32, device=dev)
    slots[:n_live] = torch.randperm(CAPACITY, generator=g, device=dev)[:n_live].int()
    kept = slots[:n_live].long()
    tail = {}
    for pool in ("cls", "mean"):
        rows = n_live if pool == "cls" else int(mask[:n_live].sum())
        for slab_dtype in (torch.float32, bf16):
            tag = f"{pool} {'f32' if slab_dtype == torch.float32 else 'bf16'}"
            sides = {who: (torch.zeros((CAPACITY, HIDDEN), dtype=slab_dtype, device=dev),
                           torch.zeros((CAPACITY,), device=dev)) for who in ("kernel", "plain", "pair")}

            def kernel(pool=pool, side=sides["kernel"]):
                pool_normalize_into(*side, slots, x, mask, pool, True, True)

            def plain(pool=pool, side=sides["plain"]):
                pool_normalize_into_plain(*side, slots, x, mask, pool, True, True)

            def pair(pool=pool, side=sides["pair"]):
                slab_scatter(*side, slots, pool_normalize(x, mask, pool, True), True)

            kernel(), plain(), pair()
            torch.cuda.synchronize()
            got, want, two = (sides[who][0][kept].float() for who in ("kernel", "plain", "pair"))
            flags = [sides[who][1] for who in ("kernel", "plain", "pair")]
            if not (torch.equal(flags[0], flags[1]) and torch.equal(flags[0], flags[2])
                    and int(flags[0].sum()) == n_live):
                fail(f"pool_normalize_into {tag}: valid flags differ from the plain version's or K7 + K2's")
            err = check_bf16(f"pool_normalize_into {tag} against its plain version", got, want)
            pair_err = (got - two).abs()
            pair_tol = SCATTER_ATOL + (TAIL_BF16_RTOL * two.abs() if slab_dtype == bf16 else 0.0)
            if not bool((pair_err <= pair_tol).all()):
                fail(f"pool_normalize_into {tag}: {pair_err.max().item()} from K7 then K2 on the card")
            elem = 4 if slab_dtype == torch.float32 else 2
            # what the function needs: the live sequences' valid rows (and
            # mask), the slots, the live rows and their flags written
            nbytes = (rows * HIDDEN * 2 + (0 if pool == "cls" else n_live * 256) + DOC_BATCH * 4
                      + n_live * (HIDDEN * elem + 4))
            b_ms, b_by = bound(nbytes, (2 * rows + 7 * n_live) * HIDDEN, PEAK_F32)
            row = {
                "shape": f"B={DOC_BATCH} ({n_live} live) L=256 H={HIDDEN} bf16, {pool} + normalise, "
                         f"into [{CAPACITY},{HIDDEN}] {tag.split()[1]} cos, {rows} rows read",
                "max_abs_err": err, "pair_max_abs_err": pair_err.max().item(),
                "ms": time_ms(torch, kernel, 200), "plain_ms": time_ms(torch, plain, 20),
                "pair_ms": time_ms(torch, pair, 200),
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                "device_ms": {"kernel": device_ms(torch, kernel), "pair": device_ms(torch, pair),
                              "plain": device_ms(torch, plain)},
            }
            tail[tag] = row
            log(f"ingest tail pool_normalize_into: {json.dumps(row)}")
            del sides, kernel, plain, pair, got, want, two, flags
    out["pool_normalize_into"] = {**tail["cls f32"], "max_abs_err": max(r["max_abs_err"] for r in tail.values())}
    out["_pool_normalize_into_shapes"] = tail
    del x, mask, slots, kept
    torch.cuda.empty_cache()
    out.update(phase_cross_head(torch, dev, g))
    return out


def head_chain(x, pooler_w, pooler_b, cls_w, cls_b, bias_act):
    """The five launches the head kernel replaced, with K4 from ``bias_act``
    (this tree's wrapper, or another commit's): the pooler weight's cast, a
    cuBLAS product of the CLS view, K4 with tanh, ``h.float()`` and the f32
    classifier."""
    import torch.nn.functional as F

    h = bias_act(F.linear(x, pooler_w.to(x.dtype)), pooler_b, "tanh")
    return F.linear(h.float(), cls_w.float(), cls_b.float())


def head_err(torch, name: str, got, ref, x, cls_w, pooler_w, pooler_b) -> float:
    """B8's logits ``got`` against the plain chain's ``ref``: f32 within
    F32_ATOL; bf16 within BF16_RTOL * (|classifier| @ |tanh|) + FUSED_ATOL
    (two bf16 ulps of each tanh value, CROSS_HEAD tolerance above).  Returns
    the largest difference."""
    import torch.nn.functional as F

    from pathway_tpu_torch.kernels import bias_act_plain

    err = (got - ref).abs()
    if x.dtype == torch.float32:
        tol = torch.full_like(ref, F32_ATOL)
    else:
        t = bias_act_plain(F.linear(x, pooler_w.to(x.dtype)), pooler_b, "tanh").float()
        tol = BF16_RTOL * (t.abs() @ cls_w.abs().T) + FUSED_ATOL
    if not bool(torch.isfinite(got).all()) or bool((err > tol).any()):
        fail(f"cross_head {name}: max err {err.max().item()} beyond its tolerance")
    return err.max().item()


def phase_cross_head(torch, dev, g) -> dict:
    """Phase 2, continued: B8, the cross-encoder's head in one launch, at a
    batched rerank chunk (B = RERANK_BATCH) and one question (B = RERANK_K),
    on the CLS view of a [B, 512, HIDDEN] hidden state, bf16 and f32, 1 and 3
    labels: against its plain chain (``head_err``), the same bits on a second
    call; by CUDA events, the profiler's device time and queued device time
    beside its bound, the plain chain's, and the five-launch chain it
    replaced (``head_chain``, queued)."""
    from pathway_tpu_torch.kernels import bias_act, cross_head, cross_head_plain

    rows = {}
    for B, L in CROSS_HEAD_SHAPES:
        for dt in (torch.bfloat16, torch.float32):
            hidden = torch.randn((B, L, HIDDEN), generator=g, device=dev).to(dt)
            x = hidden[:, 0]  # the strided CLS view, as the model passes it
            wp = torch.randn((HIDDEN, HIDDEN), generator=g, device=dev) * 0.02
            bp = torch.randn((HIDDEN,), generator=g, device=dev) * 0.5
            for labels in (1, 3):
                wc = torch.randn((labels, HIDDEN), generator=g, device=dev) * 0.02
                bc = torch.randn((labels,), generator=g, device=dev)
                args = (x, wp, bp, wc, bc)
                got = cross_head(*args)
                again = cross_head(*args)
                ref = cross_head_plain(*args)
                torch.cuda.synchronize()
                tag = f"B={B} L={L} H={HIDDEN} {'f32' if dt == torch.float32 else 'bf16'} labels={labels}"
                err = head_err(torch, tag, got, ref, x, wc, wp, bp)
                same = bool(torch.equal(got, again))
                if not same:
                    fail(f"cross_head {tag}: other bits on a second call on the same inputs")
                row = {"shape": tag + " (CLS view of the hidden state)", "max_abs_err": err,
                       "same_bits_twice": same}
                if labels == 1:  # the reranker's head: timed
                    elem = x.element_size()
                    nbytes = HIDDEN * HIDDEN * 4 + B * HIDDEN * elem + HIDDEN * 4 + (HIDDEN + 1) * labels * 4 \
                        + B * labels * 4
                    flops = 2 * B * HIDDEN * HIDDEN + 2 * B * HIDDEN * labels
                    b_ms, b_by = bound(nbytes, flops, PEAK_BF16 if dt == torch.bfloat16 else PEAK_F32_PRODUCT)

                    def kern(args=args):
                        return cross_head(*args)

                    def chain(args=args):
                        return head_chain(*args, bias_act)

                    def plain(args=args):
                        return cross_head_plain(*args)

                    row.update(
                        ms=time_ms(torch, kern, 200), plain_ms=time_ms(torch, plain, 50),
                        chain_ms=time_ms(torch, chain, 200), bound_ms=b_ms, bound_by=b_by,
                        library_ms=None,  # no single torch call takes the pooler, tanh and classifier
                        device_ms={"kernel": device_ms(torch, kern), "chain": device_ms(torch, chain),
                                   "plain": device_ms(torch, plain)},
                        queued_ms={"kernel": queued_ms(torch, kern, 100), "chain": queued_ms(torch, chain, 100)},
                    )
                rows[tag] = row
                log(f"B8 cross_head: {json.dumps(row)}")
            del hidden, x
    main = rows["B={} L={} H={} bf16 labels=1".format(*CROSS_HEAD_SHAPES[0], HIDDEN)]
    return {"cross_head": {**main, "max_abs_err": max(r["max_abs_err"] for r in rows.values()),
                           "same_bits_twice": all(r["same_bits_twice"] for r in rows.values())},
            "_cross_head_shapes": rows}


def phase_vision_kernels(torch, dev) -> dict:
    """Phase 2, continued: K8, K4 with the position addend, K9 and K10
    against their plain versions at the image path's shapes (a chunk of
    IMAGE_BATCH 224-pixel images: M = IMAGE_BATCH x N_PATCH patch rows)."""
    from pathway_tpu_torch.kernels import (
        bias_act,
        bias_act_plain,
        dual_logits,
        dual_logits_plain,
        patch_grid,
        patchify,
        patchify_plain,
        vision_head,
        vision_head_plain,
    )

    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    bf16 = torch.bfloat16
    B, rows, cols = IMAGE_BATCH, IMAGE_BATCH * N_PATCH, PATCH * PATCH * 3
    out: dict = {}

    # ---- K8 patchify: uint8 images (the image path's upload) and f32 (the
    # JAX model's contract); exact, both sides cast the same values
    k8 = {}
    shape = (B, IMAGE_SIZE, IMAGE_SIZE, 3)
    for label, imgs in (
        ("uint8", torch.randint(0, 256, shape, generator=g, device=dev, dtype=torch.uint8)),
        ("f32", torch.rand(shape, generator=g, device=dev) * 255.0),
    ):
        if not torch.equal(patchify(imgs, PATCH), patchify_plain(imgs, PATCH, bf16)):
            fail(f"patchify ({label}) differs from its plain version")
        b_ms, b_by = bound(imgs.numel() * imgs.element_size() + rows * cols * 2, rows * cols, PEAK_F32)
        k8[label] = {
            "shape": f"B={B} {IMAGE_SIZE}x{IMAGE_SIZE}x3 {label} -> [{rows},{cols}] bf16",
            "max_abs_err": 0.0,
            "ms": time_ms(torch, lambda: patchify(imgs, PATCH), 20),
            "plain_ms": time_ms(torch, lambda: patchify_plain(imgs, PATCH, bf16), 5),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None,  # no single torch call cuts NHWC images into (kh, kw, c) rows
        }
        log(f"K8 patchify: {json.dumps(k8[label])}")
        del imgs
    # "SAME" padding (off the path): value by value at the edges and where
    # a patch row's start is not 16-byte aligned
    for h, w, p, dt in ((200, 210, 16, torch.float32), (30, 27, 8, torch.uint8)):
        imgs = (torch.rand((3, h, w, 3), generator=g, device=dev) * 255.0).to(dt)
        got = patchify(imgs, p)
        gh, gw, _, _ = patch_grid(h, w, p)
        if got.shape != (3 * gh * gw, p * p * 3) or not torch.equal(got, patchify_plain(imgs, p, bf16)):
            fail(f"patchify {h}x{w} patch {p} {dt} differs from its plain version")
    # the f32 output form (C8: an f32 tower's activations): 4-value rows
    # stored as f32, from the image path's uint8 upload and from f32 images
    for label, imgs in (
        ("uint8 -> f32", torch.randint(0, 256, shape, generator=g, device=dev, dtype=torch.uint8)),
        ("f32 -> f32", torch.rand(shape, generator=g, device=dev) * 255.0),
    ):
        if not torch.equal(patchify(imgs, PATCH, torch.float32), patchify_plain(imgs, PATCH, torch.float32)):
            fail(f"patchify ({label}) differs from its plain version")
        b_ms, b_by = bound(imgs.numel() * imgs.element_size() + rows * cols * 4, rows * cols, PEAK_F32)
        k8[label] = {
            "shape": f"B={B} {IMAGE_SIZE}x{IMAGE_SIZE}x3 {label.split()[0]} -> [{rows},{cols}] f32",
            "max_abs_err": 0.0,
            "ms": time_ms(torch, lambda: patchify(imgs, PATCH, torch.float32), 20),
            "plain_ms": time_ms(torch, lambda: patchify_plain(imgs, PATCH, torch.float32), 5),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None,
        }
        log(f"K8 patchify {label}: {json.dumps(k8[label])}")
        del imgs
    for h, w, p, dt in ((200, 210, 16, torch.float32), (30, 27, 8, torch.uint8), (9, 9, 2, torch.float32)):
        imgs = (torch.rand((3, h, w, 3 if p > 2 else 1), generator=g, device=dev) * 255.0).to(dt)
        if not torch.equal(patchify(imgs, p, torch.float32), patchify_plain(imgs, p, torch.float32)):
            fail(f"patchify f32 output {h}x{w} patch {p} {dt} differs from its plain version")
    out["patchify"] = {**k8["uint8"], "f32": k8["uint8 -> f32"]}
    out["_patchify_shapes"] = k8

    # ---- K4 with the position addend: the patch embed's bias + pos
    y = torch.randn((rows, HIDDEN), generator=g, device=dev).to(bf16)
    bias = torch.randn((HIDDEN,), generator=g, device=dev) * 0.5
    pos = torch.randn((N_PATCH, HIDDEN), generator=g, device=dev) * 0.3
    got = bias_act(y.clone(), bias, "none", pos)
    ref = bias_act_plain(y.clone(), bias, "none", pos)
    torch.cuda.synchronize()
    err = check_bf16("bias_act pos", got, ref)
    del got, ref
    b_ms, b_by = bound(2 * rows * HIDDEN * 2 + HIDDEN * 4 + N_PATCH * HIDDEN * 4, 2 * rows * HIDDEN, PEAK_F32)
    out["bias_act_pos"] = {
        "shape": f"M={rows} N={HIDDEN} bf16 + pos [{N_PATCH},{HIDDEN}] f32 (image patch embed)",
        "max_abs_err": err,
        "ms": time_ms(torch, lambda: bias_act(y, bias, "none", pos), 20),
        "plain_ms": time_ms(torch, lambda: bias_act_plain(y, bias, "none", pos), 5),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None,  # no single torch call adds both
    }
    log(f"K4 bias_act pos: {json.dumps(out['bias_act_pos'])}")
    del y

    # ---- K9 vision_head: LayerNorm-scale rows, a 0.02-scale projection
    x = torch.randn((B, N_PATCH, HIDDEN), generator=g, device=dev).to(bf16)
    weight = torch.randn((HIDDEN, HIDDEN), generator=g, device=dev) * 0.02
    hbias = torch.randn((HIDDEN,), generator=g, device=dev) * 0.1
    got = vision_head(x, weight, hbias)
    ref = vision_head_plain(x, weight, hbias)
    torch.cuda.synchronize()
    err = (got - ref).abs().max().item()
    if not err <= HEAD_ATOL or not bool(got.isfinite().all()):
        fail(f"vision_head: max err {err} > {HEAD_ATOL}")
    # a batch of one image and one that is not a multiple of the kernel's
    # cluster of 8: its blocks past the last image load nothing and still
    # project; one launch a call
    head_cases = {}
    for nb in (1, 13):
        before = vision_head.launches
        got = vision_head(x[:nb], weight, hbias)
        per_call = vision_head.launches - before
        e = (got - vision_head_plain(x[:nb], weight, hbias)).abs().max().item()
        if not e <= HEAD_ATOL or not bool(got.isfinite().all()) or got.shape != (nb, HIDDEN) or per_call != 1:
            fail(f"vision_head at B={nb}: max err {e} > {HEAD_ATOL}, shape {tuple(got.shape)}, {per_call} launches")
        head_cases[f"B={nb}"] = {"max_abs_err": e, "launches_per_call": per_call}
    log(f"K9 vision_head at small batches: {json.dumps(head_cases)}")
    nbytes = rows * HIDDEN * 2 + HIDDEN * HIDDEN * 4 + HIDDEN * 4 + B * HIDDEN * 4
    b_ms, b_by = bound(nbytes, rows * HIDDEN + 2 * B * HIDDEN * HIDDEN + 3 * B * HIDDEN, PEAK_F32)
    out["vision_head"] = {
        "shape": f"B={B} P={N_PATCH} H={HIDDEN} bf16, projection [{HIDDEN},{HIDDEN}] f32 -> [{B},{HIDDEN}] f32",
        "max_abs_err": err,
        "ms": time_ms(torch, lambda: vision_head(x, weight, hbias), 20),
        "plain_ms": time_ms(torch, lambda: vision_head_plain(x, weight, hbias), 5),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None,  # no single torch call pools, projects and normalises
        "device_ms": {"kernel": device_ms(torch, lambda: vision_head(x, weight, hbias)),
                      "plain": device_ms(torch, lambda: vision_head_plain(x, weight, hbias))},
        "queued_ms": {"kernel": queued_ms(torch, lambda: vision_head(x, weight, hbias), 20)},
        "cases": head_cases,
    }
    log(f"K9 vision_head: {json.dumps(out['vision_head'])}")
    # the f32-x form (C8: an f32 tower's last activations), on the same
    # values: only the load of the patch rows differs
    x32 = x.float()
    got = vision_head(x32, weight, hbias)
    err32 = (got - vision_head_plain(x32, weight, hbias)).abs().max().item()
    if not err32 <= HEAD_ATOL or not bool(got.isfinite().all()):
        fail(f"vision_head f32: max err {err32} > {HEAD_ATOL}")
    cases32 = {}
    for nb in (1, 13):
        before = vision_head.launches
        got = vision_head(x32[:nb], weight, hbias)
        per_call = vision_head.launches - before
        e = (got - vision_head_plain(x32[:nb], weight, hbias)).abs().max().item()
        if not e <= HEAD_ATOL or not bool(got.isfinite().all()) or per_call != 1:
            fail(f"vision_head f32 at B={nb}: max err {e} > {HEAD_ATOL}, {per_call} launches")
        cases32[f"B={nb}"] = {"max_abs_err": e, "launches_per_call": per_call}
    b_ms, b_by = bound(nbytes + rows * HIDDEN * 2, rows * HIDDEN + 2 * B * HIDDEN * HIDDEN + 3 * B * HIDDEN, PEAK_F32)
    out["vision_head"]["f32"] = {
        "shape": f"B={B} P={N_PATCH} H={HIDDEN} f32, projection [{HIDDEN},{HIDDEN}] f32 -> [{B},{HIDDEN}] f32",
        "max_abs_err": err32,
        "ms": time_ms(torch, lambda: vision_head(x32, weight, hbias), 20),
        "plain_ms": time_ms(torch, lambda: vision_head_plain(x32, weight, hbias), 5),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None,
        "queued_ms": {"kernel": queued_ms(torch, lambda: vision_head(x32, weight, hbias), 20)},
        "cases": cases32,
    }
    log(f"K9 vision_head f32: {json.dumps(out['vision_head']['f32'])}")
    del x, x32

    # ---- K10 dual_logits: unit rows, a logit scale and bias off their init
    def unit(n):
        v = torch.randn((n, HIDDEN), generator=g, device=dev)
        return v / v.norm(dim=1, keepdim=True)

    img, txt = unit(B), unit(B)
    scale, lbias = torch.tensor(2.3, device=dev), torch.tensor(-0.5, device=dev)
    err = 0.0
    for a, b in ((img, txt), (img[:100], txt[:37]), (img[:1], txt)):
        got = dual_logits(a, b, scale, lbias)
        ref = dual_logits_plain(a, b, scale, lbias)
        torch.cuda.synchronize()
        e = (got - ref).abs().max().item()
        if not e <= LOGIT_ATOL or got.shape != (a.shape[0], b.shape[0]):
            fail(f"dual_logits {tuple(got.shape)}: max err {e} > {LOGIT_ATOL}")
        err = max(err, e)
    es = torch.exp(scale)  # the library call's multiplier, computed once (untimed)
    b_ms, b_by = bound(2 * B * HIDDEN * 4 + 8 + B * B * 4, 2 * B * B * HIDDEN + 2 * B * B, PEAK_F32_PRODUCT)
    kern = lambda: dual_logits(img, txt, scale, lbias)  # noqa: E731
    plain = lambda: dual_logits_plain(img, txt, scale, lbias)  # noqa: E731
    lib = lambda: torch.matmul(img, txt.T).mul_(es).add_(lbias)  # noqa: E731
    out["dual_logits"] = {
        "shape": f"[{B},{HIDDEN}] x [{B},{HIDDEN}]^T f32, * e^s + b",
        "max_abs_err": err,
        "ms": time_ms(torch, kern, 50), "plain_ms": time_ms(torch, plain, 50),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": time_ms(torch, lib, 50),  # matmul, then the multiply and add in place
        "device_ms": {"kernel": device_ms(torch, kern), "plain": device_ms(torch, plain),
                      "library": device_ms(torch, lib)},
    }
    log(f"K10 dual_logits: {json.dumps(out['dual_logits'])}")
    return out


def phase_f32_ring_kernels(torch, dev) -> dict:
    """Phase 2, continued: K1 in f32 (at the flagship tiny config's head_dim
    16 and at BGE-base's shape) and in bf16 at head_dim 16; K4-K7 in f32 at
    the embed path's BGE-base shapes; K14 in bf16 and f32 at a long
    document's block, one middle step and one finishing step against its
    plain version, each also with every tile walked (bit-equal to the tile
    skip), timed beside SDPA over the same block and, named apart, over the
    whole 8,192-token sequence."""
    import torch.nn.functional as F

    from pathway_tpu_torch.kernels import (
        add_layer_norm,
        add_layer_norm_plain,
        attention,
        attention_plain,
        bias_act,
        bias_act_plain,
        embed_ln,
        embed_ln_plain,
        pool_normalize,
        pool_normalize_plain,
        ring_block,
        ring_block_plain,
        ring_state,
    )
    from pathway_tpu_torch.kernels.attention import walked_key_tiles
    from pathway_tpu_torch.kernels.ring_block import walked_ring_tiles

    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    f32, bf16 = torch.float32, torch.bfloat16
    out: dict = {}

    def randn(*shape, scale=1.0, dtype=f32):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    def check(name, got, ref, tol):
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        if not (bool(torch.isfinite(got.float()).all()) and err <= tol):
            fail(f"{name}: max err {err} > {tol}")
        log(f"{name}: max_abs_err {err:.3e} (tol {tol})")
        return err

    def lengths_mask(B, L, min_len=1):
        lens = torch.randint(min_len, L + 1, (B,), generator=g, device=dev)
        lens[0] = L
        return (torch.arange(L, device=dev)[None] < lens[:, None]).to(torch.uint8)

    # ---- K1: f32 at head_dim 16 and BGE-base's shape; bf16 at head_dim 16
    k1_err = {}
    for dt, B, L, H, D in ((f32, 2, 16, 4, 16), (f32, 8, 64, 4, 16), (f32, DOC_BATCH, 256, 12, 64),
                           (bf16, 2, 16, 4, 16), (bf16, 32, 128, 4, 16)):
        q, k, v = (randn(B, L, H, D, dtype=dt) for _ in range(3))
        mask = lengths_mask(B, L)
        label = f"{'f32' if dt == f32 else 'bf16'} B={B} L={L} H={H} D={D}"
        k1_err[label] = check(f"K1 attention {label}", attention(q, k, v, mask),
                              attention_plain(q, k, v, mask), F32_ATOL if dt == f32 else ATTN_ATOL)
    # in f32 too: masks with holes and rows with no present key at the
    # rerank width, and the image path's L at head dims 16 and 32 (their
    # own generator: the later checks keep their inputs)
    g_new = torch.Generator(device=dev).manual_seed(SEED + 9)
    for B, L, D, holes in ((RERANK_BATCH, 512, 64, True), (IMAGE_BATCH // 4, N_PATCH, 16, False),
                           (IMAGE_BATCH // 4, N_PATCH, 32, False), (IMAGE_BATCH // 4, N_PATCH, 16, True),
                           (IMAGE_BATCH // 4, N_PATCH, 32, True)):
        q, k, v = (torch.randn((B, L, 12, D), generator=g_new, device=dev) for _ in range(3))
        mask = (holes_mask(torch, g_new, dev, B, L) if holes
                else torch.ones((B, L), dtype=torch.uint8, device=dev))
        label = f"f32 B={B} L={L} H=12 D={D} {'holes' if holes else 'all keys'}"
        k1_err[label] = check_attention_case(torch, label, v, mask, attention(q, k, v, mask),
                                             attention_plain(q, k, v, mask), F32_ATOL, 0.0)
        del q, k, v, mask
    B, L, H, D = DOC_BATCH, 256, 12, 64
    q, k, v = (randn(B, L, H, D) for _ in range(3))
    mask = lengths_mask(B, L, 64)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    keys = int(mask.sum())
    b_ms, b_by = bound(2 * B * L * H * D * 4 + 2 * keys * H * D * 4 + B * L, 4 * H * D * L * keys,
                       PEAK_F32_PRODUCT)
    log("K1 key tiles walked at the f32 shape (share of all, from the mask): "
        f"{int(walked_key_tiles(mask).sum()) / (B * -(-L // 64))}")
    out["attention"] = {
        "shape": f"B={B} L={L} H={H} D={D} f32, {keys} of {B * L} keys present",
        "max_abs_err": max(e for lab, e in k1_err.items() if lab.startswith("f32")),
        "bf16_head_dim16_max_abs_err": max(e for lab, e in k1_err.items() if lab.startswith("bf16")),
        "errors": k1_err,
        "ms": time_ms(torch, lambda: attention(q, k, v, mask), 10),
        "plain_ms": time_ms(torch, lambda: attention_plain(q, k, v, mask), 3),
        "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask.bool()[:, None, None, :]), 10),
        "bound_ms": b_ms, "bound_by": b_by,
    }
    log(f"K1 attention f32: {json.dumps(out['attention'])}")
    del q, k, v, qt, kt, vt

    # ---- K4-K7 in f32 at the embed path's shapes (M = DOC_BATCH x 256 rows)
    M = DOC_BATCH * 256
    k4 = {}
    flops_per = {"none": 1, "gelu_tanh": 9}
    for N, act in ((HIDDEN, "none"), (4 * HIDDEN, "gelu_tanh")):
        y, bias = randn(M, N), randn(N, scale=0.5)
        err = check(f"K4 bias_act f32 N={N} {act}", bias_act(y.clone(), bias, act),
                    bias_act_plain(y.clone(), bias, act), F32_ATOL)
        b_ms, b_by = bound(2 * M * N * 4 + N * 4, flops_per[act] * M * N, PEAK_F32)
        k4[act] = {"shape": f"M={M} N={N} act={act} f32", "max_abs_err": err,
                   "ms": time_ms(torch, lambda: bias_act(y, bias, act), 20),
                   "plain_ms": time_ms(torch, lambda: bias_act_plain(y, bias, act), 5),
                   "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
        if act == "none":  # one call computes it: the add of the f32 bias
            k4[act]["library_ms"] = time_ms(torch, lambda: torch.add(y, bias, out=y), 20)
        del y
    out["bias_act"] = {**k4["none"], "max_abs_err": max(r["max_abs_err"] for r in k4.values()),
                       "gelu_tanh": k4["gelu_tanh"]}
    x, r = randn(M, HIDDEN), randn(M, HIDDEN)
    scale, lbias = 1.0 + randn(HIDDEN, scale=0.1), randn(HIDDEN, scale=0.1)
    b_ms, b_by = bound(3 * M * HIDDEN * 4 + 2 * HIDDEN * 4, 10 * M * HIDDEN, PEAK_F32)
    out["add_layer_norm"] = {
        "shape": f"M={M} H={HIDDEN} f32",
        "max_abs_err": check("K5 add_layer_norm f32", add_layer_norm(x, r, scale, lbias, 1e-12),
                             add_layer_norm_plain(x, r, scale, lbias, 1e-12), F32_ATOL),
        "ms": time_ms(torch, lambda: add_layer_norm(x, r, scale, lbias, 1e-12), 20),
        "plain_ms": time_ms(torch, lambda: add_layer_norm_plain(x, r, scale, lbias, 1e-12), 5),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
    }
    del x, r
    vocab, n_pos = 30522, 512
    word, position, types = (randn(n, HIDDEN, scale=0.02) for n in (vocab, n_pos, 2))
    B, L = DOC_BATCH, 256
    ids = torch.randint(1000, vocab, (B, L), generator=g, device=dev).to(torch.int16)
    tids = (torch.arange(L, device=dev)[None] >= L // 3).expand(B, L).to(torch.uint8).contiguous()
    args = (ids, tids, word, position, types, scale, lbias, 1e-12, f32)
    err = check("K6 embed_ln f32", embed_ln(*args), embed_ln_plain(*args), F32_ATOL)
    # a block of a longer sequence: the position table from its offset on
    off = (ids[:, :128].contiguous(), tids[:, :128].contiguous(), word, position[384:], types, scale, lbias,
           1e-12, f32)
    err = max(err, check("K6 embed_ln f32 at position offset 384", embed_ln(*off), embed_ln_plain(*off), F32_ATOL))
    distinct = int(torch.unique(ids).numel())
    b_ms, b_by = bound((distinct + L + 2) * HIDDEN * 4 + B * L * 3 + B * L * HIDDEN * 4, 14 * B * L * HIDDEN,
                       PEAK_F32)
    out["embed_ln"] = {
        "shape": f"B={B} L={L} H={HIDDEN} int16 ids ({distinct} distinct), uint8 types -> f32",
        "max_abs_err": err,
        "ms": time_ms(torch, lambda: embed_ln(*args), 20),
        "plain_ms": time_ms(torch, lambda: embed_ln_plain(*args), 5),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
    }
    x = randn(B, L, HIDDEN)
    mask = lengths_mask(B, L, 64)
    k7 = {}
    for pool in ("cls", "mean"):
        err = check(f"K7 pool_normalize f32 {pool}", pool_normalize(x, mask, pool, True),
                    pool_normalize_plain(x, mask, pool, True), F32_ATOL)
        rows = B if pool == "cls" else int(mask.sum())
        b_ms, b_by = bound(rows * HIDDEN * 4 + (0 if pool == "cls" else B * L) + B * HIDDEN * 4,
                           (2 * rows + 4 * B) * HIDDEN, PEAK_F32)
        k7[pool] = {"shape": f"B={B} L={L} H={HIDDEN} f32, {pool} + normalise, {rows} rows read",
                    "max_abs_err": err,
                    "ms": time_ms(torch, lambda: pool_normalize(x, mask, pool, True), 50),
                    "plain_ms": time_ms(torch, lambda: pool_normalize_plain(x, mask, pool, True), 20),
                    "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                    "device_ms": device_ms(torch, lambda: pool_normalize(x, mask, pool, True))}
    out["pool_normalize"] = {**k7["cls"], "max_abs_err": max(r["max_abs_err"] for r in k7.values()),
                             "mean": k7["mean"]}
    del x, word, position, types
    for name in ("bias_act", "add_layer_norm", "embed_ln", "pool_normalize"):
        log(f"{name} f32: {json.dumps(out[name])}")

    # ---- K14 ring_block: a middle step (from the state a first step left)
    # and the finishing step, against ring_block_plain on the same inputs.
    # Row 1 has no valid key in the first block, row 2 none in any: its
    # output must be the uniform average of v over all keys.  Each step runs
    # twice: with the sequence's any_key (the ring's tile skip) and with
    # any_key all zeros (every tile walked); the two must be bit-equal.
    B, L, H, D = RING_B, RING_L, RING_H, RING_D
    ring = {}
    walked = {}
    for dt in (bf16, f32):
        tag = "bf16" if dt == bf16 else "f32"
        q = randn(B, L, H, D, dtype=dt)
        kv = [(randn(B, L, H, D, dtype=dt), randn(B, L, H, D, dtype=dt), lengths_mask(B, L)) for _ in range(3)]
        kv[0][2][1] = 0
        for _, _, m in kv:
            m[2] = 0
        any_key = torch.stack([m for _, _, m in kv]).amax(dim=(0, 2))
        walk_all = torch.zeros_like(any_key)
        st_p = ring_state(B, L, H, D, dev)
        ring_block_plain(q, *kv[0], *st_p)
        st_k = [t.clone() for t in st_p]
        st_a = [t.clone() for t in st_p]
        ring_block(q, *kv[1], *st_k, any_key=any_key)
        ring_block(q, *kv[1], *st_a, any_key=walk_all)
        ring_block_plain(q, *kv[1], *st_p)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(st_k, st_a)):
            fail(f"ring_block {tag} middle step: the state with the tile skip is not bit-equal to the walk of "
                 f"every tile (o, m, l equal: {[torch.equal(a, b) for a, b in zip(st_k, st_a)]})")
        state_err, m_err = ring_state_err(st_k, st_p)
        state_tol = F32_ATOL if dt == f32 else RING_STATE_RTOL
        if not (state_err <= state_tol and m_err <= state_tol):
            fail(f"ring_block {tag} middle step: state err {state_err}, running max err {m_err} > {state_tol}")
        control = None
        if dt == bf16:  # the gate must tell K14's f32 p from K1's bf16 p
            st_c = ring_state(B, L, H, D, dev)
            ring_step_p_bf16(q, *kv[0], *st_c)
            ring_step_p_bf16(q, *kv[1], *st_c)
            control = ring_state_err(st_c, st_p)[0]
            if not control > state_tol:
                fail(f"ring_block bf16: p rounded to bf16 lies {control} from the f32-p state, within "
                     f"the limit {state_tol}: the gate cannot tell the two apart")
        got = ring_block(q, *kv[2], *st_k, finalize=True, any_key=any_key)
        if not torch.equal(got, ring_block(q, *kv[2], *st_a, finalize=True, any_key=walk_all)):
            fail(f"ring_block {tag} finishing step: the output with the tile skip is not bit-equal to the "
                 "walk of every tile")
        ref = ring_block_plain(q, *kv[2], *st_p, finalize=True)
        err = check(f"K14 ring_block {tag} finishing step", got, ref,
                    F32_ATOL if dt == f32 else RING_ATOL * ref.float().abs().max().item())
        uniform = torch.cat([v for _, v, _ in kv], dim=1)[2].float().mean(dim=0)
        err_u = check(f"K14 ring_block {tag} row with no valid key: the mean of v", got[2],
                      uniform.expand(L, H, D), F32_ATOL if dt == f32 else RING_ATOL * uniform.abs().max().item())
        log(f"K14 ring_block {tag} middle step: state err {state_err:.3e}, running max err {m_err:.3e} "
            f"(tol {state_tol}); with p rounded to bf16 (the control) {control}; finished output "
            f"max |ref| {ref.float().abs().max().item():.4f}; the tile skip bit-equal to the walk of every tile")
        mask = kv[1][2]
        walked[tag] = int(walked_ring_tiles(mask, any_key).sum()) / (B * -(-L // 64))
        keys = int(mask.sum())
        es = 2 if dt == bf16 else 4
        nbytes = 3 * B * L * H * D * es + B * L + B + 2 * (B * H * L * D * 4 + 2 * B * H * L * 4)
        b_ms, b_by = bound(nbytes, 4 * H * D * L * keys, PEAK_BF16 if dt == bf16 else PEAK_F32_PRODUCT)
        st = [t.clone() for t in st_k]
        row = {
            "shape": f"B={B} Lb={L} H={H} D={D} {tag}, a middle step, {keys} of {B * L} keys present",
            "max_abs_err": max(err, err_u), "state_err": state_err, "running_max_err": m_err,
            "state_err_p_bf16": control,
            "ms": time_ms(torch, lambda: ring_block(q, *kv[1], *st, any_key=any_key), 10),
            "walk_all_ms": time_ms(torch, lambda: ring_block(q, *kv[1], *st, any_key=walk_all), 10),
            "plain_ms": time_ms(torch, lambda: ring_block_plain(q, *kv[1], *st_p), 3, warmup=1),
            "bound_ms": b_ms, "bound_by": b_by,
            "finalize_ms": time_ms(torch, lambda: ring_block(q, *kv[2], *st, finalize=True, any_key=any_key), 10),
        }
        # the library yardstick: SDPA over the same block, query block against
        # the K/V block with its key mask (never called by the port); and,
        # named apart, SDPA over the whole sequence at once with a key mask
        # of the same density
        qt, kt, vt = (t.transpose(1, 2) for t in (q, *kv[1][:2]))
        bmask = mask.bool()[:, None, None, :]
        row["library_ms"] = time_ms(
            torch, lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=bmask), 10)
        row["library"] = f"F.scaled_dot_product_attention over the block, B={B} Lq=Lk={L} H={H} D={D} {tag}"
        del st, st_k, st_a, st_p, kv, got, ref, qt, kt, vt
        qf, kf, vf = (randn(B, H, LONG_LEN, D, dtype=dt) for _ in range(3))
        fmask = lengths_mask(B, LONG_LEN).bool()[:, None, None, :]
        row["library_whole_sequence_ms"] = time_ms(
            torch, lambda: F.scaled_dot_product_attention(qf, kf, vf, attn_mask=fmask), 3, warmup=1)
        row["library_whole_sequence"] = f"F.scaled_dot_product_attention over B={B} L={LONG_LEN} H={H} D={D} {tag}"
        del qf, kf, vf
        ring[tag] = row
        log(f"K14 ring_block {tag}: {json.dumps(row)}")
        torch.cuda.empty_cache()
    log("K14 key tiles walked at the middle step (share of all, from the masks and any_key): "
        + json.dumps(walked))
    # the tile skip on masks with holes (present tiles between masked ones),
    # over two ring steps from the first state, every step run with the
    # sequence's any_key and with all zeros: row 1 has keys only in the first
    # block (it walks no tile of the second), row 3 only the last key of the
    # second (it walks no tile of the first), row 2 none anywhere (every
    # tile).  The final states must be bit-equal, and within the middle
    # step's limit of the plain version's (own generator: the checks above
    # keep their inputs)
    g_h = torch.Generator(device=dev).manual_seed(SEED + 14)
    Bh, Lh, Hh = 8, 1024, 4
    holes = {}
    for dt in (bf16, f32):
        tag = "bf16" if dt == bf16 else "f32"
        q, k0, v0, k1, v1 = (torch.randn((Bh, Lh, Hh, D), generator=g_h, device=dev).to(dt) for _ in range(5))
        m0 = holes_mask(torch, g_h, dev, Bh, Lh)
        m0[1] = 1
        m0[3] = 0
        m1 = holes_mask(torch, g_h, dev, Bh, Lh)
        m0[2] = 0
        m1[2] = 0
        any_key = torch.maximum(m0, m1).amax(dim=1)
        st_k, st_a, st_p = (ring_state(Bh, Lh, Hh, D, dev) for _ in range(3))
        for kb, vb, mb in ((k0, v0, m0), (k1, v1, m1)):
            ring_block(q, kb, vb, mb, *st_k, any_key=any_key)
            ring_block(q, kb, vb, mb, *st_a, any_key=torch.zeros_like(any_key))
            ring_block_plain(q, kb, vb, mb, *st_p)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(st_k, st_a)):
            fail(f"ring_block {tag} over masks with holes: the state with the tile skip is not bit-equal to the "
                 f"walk of every tile (o, m, l equal: {[torch.equal(a, b) for a, b in zip(st_k, st_a)]})")
        state_err, m_err = ring_state_err(st_k, st_p)
        state_tol = F32_ATOL if dt == f32 else RING_STATE_RTOL
        if not (state_err <= state_tol and m_err <= state_tol):
            fail(f"ring_block {tag} over masks with holes: state err {state_err}, running max err {m_err} "
                 f"> {state_tol}")
        holes[tag] = {"state_err": state_err, "running_max_err": m_err, "walked_tile_share": [
            int(walked_ring_tiles(mb, any_key).sum()) / (Bh * -(-Lh // 64)) for mb in (m0, m1)]}
        del q, k0, v0, k1, v1, st_k, st_a, st_p
    log(f"K14 over masks with holes, B={Bh} Lb={Lh} H={Hh} D={D}, two steps: the tile skip bit-equal to the walk "
        f"of every tile; against the plain version (walked share from the masks and any_key): {json.dumps(holes)}")
    out["ring_block"] = {**ring["bf16"], "f32": ring["f32"]}
    return out


def ring_state_err(st, ref) -> tuple[float, float]:
    """The distance of ring state ``st`` = (o, m, l) from ``ref``: o and l
    relative to ``ref``'s l, once both are brought to ``ref``'s running
    max (a logit a rounding apart moves the running max, and o and l scale
    with it); and the running max's relative distance."""
    import torch

    (o, m, l), (o_r, m_r, l_r) = st, ref
    shift = torch.exp(m - m_r)
    state = max(((l * shift - l_r).abs() / l_r).max().item(),
                ((o * shift[..., None] - o_r).abs() / l_r[..., None]).max().item())
    return state, ((m - m_r).abs() / m_r.abs().clamp(min=1.0)).max().item()


def ring_step_p_bf16(q, k, v, mask, o, m, l) -> None:
    """The control of K14's state check: ``ring_block_plain``'s step with
    p rounded to bf16 before p.v, as K1 rounds it (l still sums f32 p)."""
    import math

    import torch

    s = torch.einsum("blhd,bmhd->bhlm", q, k).float() * (1.0 / math.sqrt(q.shape[-1]))
    s = s + torch.where(mask.bool()[:, None, None, :], 0.0, -1e30)
    m_new = torch.maximum(m, s.amax(dim=-1))
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    l.copy_(l * alpha + p.sum(dim=-1))
    o.copy_(o * alpha[..., None] + torch.einsum("bhlm,bmhd->bhld", p.bfloat16().float(), v.float()))
    m.copy_(m_new)


@contextlib.contextmanager
def f32_partial_sums():
    """The control of the TP score gap: while open, every encoder block
    computes its out-projection's and ``mlp_down``'s products in f32 (the
    bf16 operands widened, TF32 off) and sums the shards' f32 products
    before rounding once to the activation type, as one device's product
    is rounded once.  The port rounds each shard's product."""
    import torch.nn.functional as F

    from pathway_tpu_torch.models import encoder as enc

    saved = enc.SelfAttention.project, enc.EncoderBlock.mlp, enc.EncoderBlock.__dict__["finish"]

    def project(self, ctx):
        B, L = ctx.shape[:2]
        return F.linear(ctx.reshape(B, L, -1).float(), self.out.weight.to(ctx.dtype).float())

    def mlp(self, x):
        h = enc._dense(x, self.mlp_up, "gelu_tanh" if self.cfg.gelu_approx else "gelu_erf")
        return F.linear(h.float(), self.mlp_down.weight.to(h.dtype).float())

    def finish(x, partials, layer, ln):
        a = partials[0]
        for p in partials[1:]:
            a = a + p.to(a.device)
        return saved[2].__func__(x, [a.to(x.dtype)], layer, ln)

    enc.SelfAttention.project, enc.EncoderBlock.mlp = project, mlp
    enc.EncoderBlock.finish = staticmethod(finish)
    try:
        yield
    finally:
        enc.SelfAttention.project, enc.EncoderBlock.mlp, enc.EncoderBlock.finish = saved


def _plain_dense(h, layer, act="none"):
    import torch.nn.functional as F

    from pathway_tpu_torch.kernels import bias_act_plain

    return bias_act_plain(F.linear(h, layer.weight.to(h.dtype)), layer.bias, act)


def _plain_blocks(blocks, x, mask):
    """The post-LN ``blocks`` (``EncoderBlock``s) over ``x`` through the
    plain versions of K1 (or, when the config is sequence parallel, of
    K14 over the blocks of its sequence axis), K4 and K5."""
    from pathway_tpu_torch.kernels import add_layer_norm_plain, attention_plain
    from pathway_tpu_torch.ops.ring_attention import ring_attention_plain

    def add_ln(a, b, ln):
        return add_layer_norm_plain(a, b, ln.weight, ln.bias, ln.eps)

    B, L, _ = x.shape
    for block in blocks:
        cfg, att = block.cfg, block.attention
        heads = (B, L, cfg.heads, cfg.head_dim)
        q, k, v = (_plain_dense(x, lin).view(heads) for lin in (att.query, att.key, att.value))
        if cfg.seq_mesh is None:
            ctx = attention_plain(q, k, v, mask)
        else:
            ctx = ring_attention_plain(q, k, v, mask, mesh=cfg.seq_mesh, axis=cfg.seq_axis)
        a = _plain_dense(ctx.reshape(B, L, cfg.hidden), att.out)
        x = add_ln(x, a, block.attention_ln)
        h = _plain_dense(x, block.mlp_up, "gelu_tanh" if cfg.gelu_approx else "gelu_erf")
        x = add_ln(x, _plain_dense(h, block.mlp_down), block.mlp_ln)
    return x


def plain_forward(model, ids, mask, type_ids=None):
    """``model``'s forward (a ``TextEncoderModel`` or ``CrossEncoderModel``)
    through the kernels' plain versions only, on whatever device its
    parameters are: the reference phase 4 holds the rerank path to.
    Nothing on either path calls it."""
    import torch
    import torch.nn.functional as F

    from pathway_tpu_torch.kernels import embed_ln_plain, pool_normalize_plain

    cfg = model.cfg
    mask = mask.to(torch.uint8)
    emb = model.embeddings
    types = None if emb.token_type is None else emb.token_type.weight
    x = embed_ln_plain(ids, type_ids, emb.word.weight, emb.position.weight, types,
                       emb.ln.weight, emb.ln.bias, emb.ln.eps, cfg.dtype)
    x = _plain_blocks(model.blocks(), x, mask)
    if not hasattr(model, "classifier"):
        return pool_normalize_plain(x, mask, cfg.pool, cfg.normalize)
    h = _plain_dense(x[:, 0], model.pooler, "tanh")
    logits = F.linear(h.float(), model.classifier.weight.float(), model.classifier.bias.float())
    return logits[:, 0] if logits.shape[1] == 1 else logits


def plain_vision_forward(model, images):
    """A ``VisionEncoderModel``'s forward through the kernels' plain
    versions only (K8, K4 with the position addend, K1, K4, K5, K9), on
    whatever device its parameters are: the reference phase 5 holds the
    image path to.  Nothing on the path calls it."""
    import torch
    import torch.nn.functional as F

    from pathway_tpu_torch.kernels import bias_act_plain, patchify_plain, vision_head_plain

    cfg = model.cfg
    B = images.shape[0]
    x = F.linear(patchify_plain(images, cfg.patch, cfg.dtype), model.patch_embed.weight.to(cfg.dtype))
    x = bias_act_plain(x, model.patch_embed.bias, "none", model.pos_embed[0])
    x = x.view(B, cfg.n_patches, cfg.hidden)
    mask = torch.ones((B, cfg.n_patches), dtype=torch.uint8, device=x.device)
    x = _plain_blocks(model.blocks(), x, mask)
    return vision_head_plain(x, model.projection.weight, model.projection.bias)


def synthetic_images(np, torch, n: int, size: int, seed: int, device):
    """``n`` seeded ``[size, size, 3]`` uint8 images with structure, not
    noise, as a tensor on ``device``: a two-colour gradient along a random
    direction under a grid of colour blocks at a random scale (2 to 14
    cells a side), about half of the cells filled.  The random draws are
    numpy's; the pixels are laid out with torch on ``device``."""
    rng = np.random.default_rng(seed)
    angle = rng.uniform(0.0, 2.0 * np.pi, n)
    c0, c1 = (rng.uniform(0, 255, (n, 1, 1, 3)) for _ in range(2))
    cells = rng.choice(np.array([2, 3, 4, 7, 14]), n)
    colours = rng.uniform(0, 255, (n, 14, 14, 3))
    filled = rng.random((n, 14, 14)) < 0.5

    def dev(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device)

    pos = torch.arange(size, device=device, dtype=torch.float32) / size
    out = torch.empty((n, size, size, 3), dtype=torch.uint8, device=device)
    for lo in range(0, n, 256):
        sl = slice(lo, min(lo + 256, n))
        ang = dev(angle[sl])
        t = torch.cos(ang)[:, None, None] * pos[None, None, :] + torch.sin(ang)[:, None, None] * pos[None, :, None]
        t = t - t.amin(dim=(1, 2), keepdim=True)
        t = t / t.amax(dim=(1, 2), keepdim=True).clamp(min=1e-6)
        lo0, hi0 = dev(c0[sl]), dev(c1[sl])
        img = lo0 + t[..., None] * (hi0 - lo0)
        cell = (torch.arange(size, device=device)[None, :] * torch.from_numpy(cells[sl]).to(device)[:, None]) // size
        b = torch.arange(img.shape[0], device=device)[:, None, None]
        cy, cx = cell[:, :, None], cell[:, None, :]
        on = torch.from_numpy(filled[sl]).to(device)[b, cy, cx]
        img = torch.where(on[..., None], dev(colours[sl])[b, cy, cx], img)
        out[sl] = img.to(torch.uint8)
    return out


def synthetic_docs(np, n: int, seed: int) -> list[str]:
    """``n`` documents of 64-256 tokens (with [CLS]/[SEP]) over a 50k-word
    synthetic vocabulary, from ``seed``."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(62, 255, n)
    words = rng.integers(0, 50_000, int(lens.sum()))
    docs, pos = [], 0
    for ln in lens:
        docs.append(" ".join(f"w{w}" for w in words[pos : pos + ln]))
        pos += ln
    return docs


def profile_call(torch, fn, rows: int, keep_all: bool = False) -> dict:
    """Device time by kernel over one call of ``fn`` (``rows`` inputs), and
    the share of the call's wall time the device was busy (one stream, so
    kernels do not overlap).  Once earlier windows have run in the process,
    a window's trace can lack its first device events (on an H100 it lost
    an image chunk's upload and first kernel, an ingest chunk's upload and
    K11, and a search's probe and scan), so 32 small kernels run first
    inside the window, and only device events that start during the call
    count; ``warmup_seen`` says how many of the 32 the trace kept."""
    from torch.profiler import ProfilerActivity, profile, record_function

    scratch = torch.zeros((1,), device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(32):
            scratch.add_(1.0)
        torch.cuda.synchronize()
        with record_function("profile_call"):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    def on_device(e) -> bool:
        return str(getattr(e, "device_type", "")).endswith("CUDA")

    events = prof.events()
    call = next(e for e in events if e.name == "profile_call" and not on_device(e))
    by_kernel: dict = {}
    warmup_seen = 0
    for e in events:
        if not on_device(e) or e.name == "profile_call":  # the annotation's device span
            continue
        if e.time_range.start < call.time_range.start:
            warmup_seen += 1
            continue
        us, n = by_kernel.get(e.name, (0.0, 0))
        by_kernel[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    ranked = sorted(((us, name, n) for name, (us, n) in by_kernel.items()), reverse=True)
    busy_us = sum(r[0] for r in ranked)
    return {
        "rows": rows,
        "wall_ms": wall_us / 1e3,
        "device_busy_ms": busy_us / 1e3,
        "device_idle_share": max(0.0, 1.0 - busy_us / wall_us),
        "warmup_seen": warmup_seen,
        "top": [{"name": k[:80], "ms": us / 1e3, "calls": n} for us, k, n in ranked[:15]],
        **({"all": [{"name": k, "ms": us / 1e3, "calls": n} for us, k, n in ranked]} if keep_all else {}),
    }


def check_search_against_plain(torch, index, qs) -> None:
    """The index's answers to the queries ``qs`` (host rows) against a
    plain matmul + top-k over its own slab: the same scores within
    TOPK_ATOL, and every key the plain version ranks clear of its k-th
    score in the index's answer."""
    from pathway_tpu_torch.kernels import knn_topk_plain
    from pathway_tpu_torch.ops.distances import normalize

    rows = index.search(qs, K)
    q = normalize(torch.from_numpy(qs).to(index.device))
    pv, pi = knn_topk_plain(q, index._vectors, index._valid, K, "dot")
    for r, row in enumerate(rows):
        got = [s for s, _ in row]
        sure = [index._key_of[int(s)] for s, v in zip(pi[r].tolist(), pv[r].tolist())
                if v > pv[r, -1].item() + TOPK_ATOL]
        if any(key not in got for key in sure):
            fail(f"search row {r} disagrees with the plain top-k over the slab")
        err = max(abs(a - b) for (_, a), b in zip(row, pv[r].tolist()))
        if err > TOPK_ATOL:
            fail(f"search row {r}: scores differ from plain by {err}")


def tail_launches(kernels, before: dict, chunks: int, what: str) -> dict:
    """The ingest tail's and K2's launches since ``before`` (a
    ``launch_counts()``) over an ``encode_into`` of ``chunks`` chunks into a
    one-shard index: one tail a chunk, no K2 and no K7."""
    now = kernels.launch_counts()
    got = {name: now[name] - before[name] for name in ("pool_normalize_into", "slab_scatter", "pool_normalize")}
    got["tail_per_chunk"] = got["pool_normalize_into"] / chunks
    if got["pool_normalize_into"] != chunks or got["slab_scatter"] or got["pool_normalize"]:
        fail(f"{what}: {json.dumps(got)} over {chunks} chunks; one ingest tail a chunk, no K2 and no K7 expected")
    return got


def phase_slice(torch, dev, compared_widths: set) -> tuple[dict, dict]:
    """Phase 3: the embed path at BGE-base full width; returns its
    measurements and what phase 4 reuses (index, embedder, documents)."""
    import numpy as np

    from pathway_tpu_torch import ShardedKnnIndex, TorchEncoderEmbedder, kernels
    from pathway_tpu_torch.internals import device_counters

    res: dict = {}
    kernels.reset_launch_counts()
    device_counters.reset_for_tests()
    torch.cuda.reset_peak_memory_stats()

    index = ShardedKnnIndex(HIDDEN, metric="cos", capacity=CAPACITY, device=dev)
    n_bulk = CAPACITY - N_DOCS - 1024
    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    chunk = 65536
    for start in range(0, n_bulk, chunk):
        n = min(chunk, n_bulk - start)
        vecs = rng.standard_normal((n, HIDDEN), dtype=np.float32)
        index.add_batch(range(start, start + n), vecs)
    torch.cuda.synchronize()
    res["bulk_rows_per_s"] = n_bulk / (time.perf_counter() - t0)
    log(f"bulk fill: {n_bulk} rows through add_batch at {res['bulk_rows_per_s']:.0f} rows/s")

    embedder = TorchEncoderEmbedder("bge-base", max_batch_size=DOC_BATCH, seed=SEED, device=dev)
    if embedder.get_embedding_dimension() != HIDDEN:
        fail("embedder width is not 768")
    docs = synthetic_docs(np, N_DOCS, SEED)
    keys = [f"doc-{i}" for i in range(N_DOCS)]
    torch.cuda.synchronize()
    before = kernels.launch_counts()
    t0 = time.perf_counter()
    n = embedder.encoder.encode_into(index, keys, docs)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    res["embed_docs_per_s"] = n / dt
    res["encoder_batches"] = -(-N_DOCS // DOC_BATCH)
    log(f"encode_into: {n} docs in {dt:.3f} s = {res['embed_docs_per_s']:.1f} docs/s")
    res["ingest_tail"] = tail_launches(kernels, before, res["encoder_batches"], "phase 3's encode_into")
    if len(index) != n_bulk + N_DOCS:
        fail(f"index holds {len(index)} keys, expected {n_bulk + N_DOCS}")
    index.remove(keys[-N_REMOVED:])

    # queries: the first chunk's documents, re-embedded in the same batch
    q_all = embedder.encoder.encode(docs[:DOC_BATCH])
    if q_all.shape != (DOC_BATCH, HIDDEN) or not np.isfinite(q_all).all():
        fail(f"query embeddings: shape {q_all.shape} or non-finite values")
    lat: dict = {}
    for nq, reps in ((1, 50), (32, 20)):
        times = []
        for r in range(reps):
            lo = (r * nq) % (DOC_BATCH - nq + 1)
            qs = q_all[lo : lo + nq]
            t0 = time.perf_counter()
            rows = index.search(qs, K)
            times.append((time.perf_counter() - t0) * 1e3)
            margins = []
            for i, row in enumerate(rows):
                if len(row) != K:
                    fail(f"search nq={nq}: {len(row)} results, expected {K}")
                key, score = row[0]
                if key != keys[lo + i] or score < SELF_COS:
                    fail(f"search nq={nq}: query doc-{lo + i} came back as {key} ({score})")
                margins.append(score - row[1][1])
        lat[nq] = {
            "p50_ms": float(np.percentile(times, 50)),
            "p99_ms": float(np.percentile(times, 99)),
            "min_top1_margin": float(min(margins)),
        }
        log(f"search nq={nq}: {json.dumps(lat[nq])}")
    res["search"] = lat
    res["launches"] = kernels.launch_counts()
    res["transfers"] = device_counters.snapshot()
    res["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9

    check_search_against_plain(torch, index, q_all[:32])

    # host tokenizer alone, and a device profile of one more pass over
    # the first 1024 documents (upserts of the same keys)
    tok = embedder.encoder.tokenizer
    t0 = time.perf_counter()
    n_tok, widths = 0, set()
    for i in range(0, N_DOCS, DOC_BATCH):
        ids, mask = tok.encode_batch(docs[i : i + DOC_BATCH])[:2]
        n_tok += int(mask.sum())
        widths.add(ids.shape[1])
    res["tokenize_tokens_per_s"] = n_tok / (time.perf_counter() - t0)
    res["attention_widths"] = sorted(widths)
    if not widths <= compared_widths:
        fail(f"encoder chunk widths {sorted(widths)} outside the shapes phase 2 compared")
    before = kernels.launch_counts()
    res["profile"] = profile_call(
        torch, lambda: embedder.encoder.encode_into(index, keys[:1024], docs[:1024]), 1024
    )
    res["profile"]["ingest_tail"] = tail_launches(kernels, before, -(-len(docs[:1024]) // DOC_BATCH),
                                                  "the profiled encode_into")
    log(f"profiled encode_into of 1,024 documents: idle {res['profile']['device_idle_share']:.3f}, "
        f"{json.dumps(res['profile']['ingest_tail'])}")

    embed_path = ("attention", "slab_scatter", "slab_clear", "knn_topk", "bias_act", "add_layer_norm",
                  "embed_ln", "pool_normalize", "pool_normalize_into")
    zero = [name for name in embed_path if res["launches"][name] == 0]
    if zero:
        fail(f"kernels not launched on the embed path: {zero}")
    return res, {"index": index, "embedder": embedder, "docs": docs, "keys": keys, "q_all": q_all}


def synthetic_questions(np, docs: list[str], n: int, seed: int) -> list[str]:
    """``n`` questions of 8-24 words, each drawn from one document's words."""
    rng = np.random.default_rng(seed)
    out = []
    for i in rng.integers(0, len(docs), n):
        words = docs[i].split()
        out.append(" ".join(rng.choice(words, int(rng.integers(8, 25)), replace=False)))
    return out


def phase_rerank(torch, dev, ctx: dict, compared_widths: set) -> dict:
    """Phase 4: retrieve -> rerank at BGE-reranker-base full width over
    phase 3's index."""
    import numpy as np

    from pathway_tpu_torch import CrossEncoderModel, CrossEncoderReranker, kernels, rerank_topk_filter

    index, embedder = ctx["index"], ctx["embedder"]
    text_of = dict(zip(ctx["keys"], ctx["docs"]))
    reranker = CrossEncoderReranker(max_batch_size=RERANK_BATCH, seed=SEED, device=dev)
    cross = reranker.encoder
    if (cross.config.hidden, cross.config.layers, cross.config.mlp_dim) != (HIDDEN, 12, 4 * HIDDEN):
        fail(f"reranker config {cross.config} is not BGE-reranker-base")
    tok = cross.tokenizer
    res: dict = {}
    widths: set = set()

    def candidates(question_rows):
        """(doc dicts, question per pair) for every retrieved key; each must
        be an indexed document."""
        docs, qs = [], []
        for q, row in question_rows:
            if len(row) != RERANK_K:
                fail(f"rerank: {len(row)} candidates retrieved, expected {RERANK_K}")
            for key, _ in row:
                if key not in text_of:
                    fail(f"rerank: candidate {key!r} is not an indexed document")
                docs.append({"text": text_of[key], "key": key})
                qs.append(q)
        return docs, qs

    def note_widths(texts, pair=None, batch=RERANK_BATCH):
        for i in range(0, len(texts), batch):
            ids = tok.encode_batch(texts[i : i + batch], pair=None if pair is None else pair[i : i + batch],
                                   max_len=cross.max_len)[0]
            widths.add(ids.shape[1])

    # questions from the documents still indexed (phase 3 removed the last few)
    questions = synthetic_questions(np, ctx["docs"][: N_DOCS - N_REMOVED], N_QUESTIONS + N_SINGLE, SEED + 2)
    batched, singles = questions[:N_QUESTIONS], questions[N_QUESTIONS:]
    reranker.__batch__([{"text": "warm up"}], ["warm up"])  # first-call set-up, untimed
    torch.cuda.synchronize()

    kernels.reset_launch_counts()
    tanh_before = kernels.bias_act.launches_by_act["tanh"]
    # (a) the batched round
    t0 = time.perf_counter()
    hits = index.search(embedder.encoder.encode(batched), RERANK_K)
    pair_docs, pair_qs = candidates(zip(batched, hits))
    t1 = time.perf_counter()
    scores = reranker.__batch__(pair_docs, pair_qs)
    t2 = time.perf_counter()
    kept = [rerank_topk_filter.__wrapped_fun__(pair_docs[i : i + RERANK_K], scores[i : i + RERANK_K], RERANK_KEEP)
            for i in range(0, len(scores), RERANK_K)]
    t3 = time.perf_counter()
    res["batched"] = {
        "questions": N_QUESTIONS, "pairs": len(scores),
        "pairs_per_s": len(scores) / (t2 - t1),
        "embed_search_ms": (t1 - t0) * 1e3, "score_ms": (t2 - t1) * 1e3,
        "round_ms": (t3 - t0) * 1e3,
    }
    # (b) single questions: what one user waits for
    single_ms, search_rerank_ms = [], []
    for q in singles:
        s0 = time.perf_counter()
        q_emb = embedder.encoder.encode([q])
        s1 = time.perf_counter()
        docs_q, qs_q = candidates(zip([q], index.search(q_emb, RERANK_K)))
        rerank_topk_filter.__wrapped_fun__(docs_q, reranker.__batch__(docs_q, qs_q), RERANK_KEEP)
        s2 = time.perf_counter()
        single_ms.append((s2 - s0) * 1e3)
        search_rerank_ms.append((s2 - s1) * 1e3)
        note_widths(qs_q, [d["text"] for d in docs_q])
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    res["launches"] = launches
    res["single"] = {
        "questions": N_SINGLE, "candidates": RERANK_K,
        "p50_ms": float(np.percentile(single_ms, 50)), "p99_ms": float(np.percentile(single_ms, 99)),
        "search_rerank_p50_ms": float(np.percentile(search_rerank_ms, 50)),
        "search_rerank_p99_ms": float(np.percentile(search_rerank_ms, 99)),
    }
    log(f"rerank batched: {json.dumps(res['batched'])}")
    log(f"rerank single: {json.dumps(res['single'])}")
    missing = [n for n in ("attention", "bias_act", "add_layer_norm", "embed_ln", "knn_topk", "cross_head")
               if launches[n] == 0]
    if missing:
        fail(f"kernels not launched on the rerank path: {missing}")
    # the head: one launch a cross-encoder chunk (the batched round's chunks,
    # then one per single question), and no K4 with tanh
    chunks = -(-N_QUESTIONS * RERANK_K // RERANK_BATCH) + N_SINGLE * -(-RERANK_K // RERANK_BATCH)
    res["head"] = {"chunks": chunks, "cross_head_launches": launches["cross_head"],
                   "bias_act_tanh_launches": kernels.bias_act.launches_by_act["tanh"] - tanh_before}
    log(f"rerank head: {json.dumps(res['head'])}")
    if res["head"]["cross_head_launches"] != chunks or res["head"]["bias_act_tanh_launches"]:
        fail(f"rerank head launches {json.dumps(res['head'])}: one head launch a chunk and no K4 tanh expected")

    # gates: finite scores; the plain-only forward of the same model, and
    # the same forward in f32 as the yardstick of bf16 noise
    scores = np.asarray(scores, np.float32)
    if not np.isfinite(scores).all():
        fail("rerank: non-finite scores")
    model32 = CrossEncoderModel(dataclasses.replace(cross.config, dtype=torch.float32), device=dev)
    model32.load_state_dict(cross.model.state_dict())
    plain, plain32 = [], []
    for i in range(0, len(pair_qs), RERANK_BATCH):
        batch = tok.encode_batch(pair_qs[i : i + RERANK_BATCH],
                                 pair=[d["text"] for d in pair_docs[i : i + RERANK_BATCH]],
                                 max_len=cross.max_len)
        widths.add(batch[0].shape[1])
        (args,), n = cross._upload_parts(*batch)
        with torch.inference_mode():
            plain.append(plain_forward(cross.model, *args)[:n].float().cpu().numpy())
            plain32.append(plain_forward(model32, *args)[:n].float().cpu().numpy())
    del model32
    plain, plain32 = np.concatenate(plain), np.concatenate(plain32)
    err = np.abs(scores - plain)
    res["max_abs_err_vs_plain"] = float(err.max())
    res["mean_abs_err_vs_plain"] = float(err.mean())
    res["vs_f32"] = {"kernel_mean": float(np.abs(scores - plain32).mean()),
                     "kernel_max": float(np.abs(scores - plain32).max()),
                     "plain_mean": float(np.abs(plain - plain32).mean()),
                     "plain_max": float(np.abs(plain - plain32).max())}
    res["score_spread"] = {"min": float(scores.min()), "max": float(scores.max()), "std": float(scores.std())}
    if not err.max() <= SCORE_ATOL:
        fail(f"rerank scores differ from the plain-only forward by {err.max()} > {SCORE_ATOL}")
    if not res["vs_f32"]["kernel_mean"] <= F32_RATIO * res["vs_f32"]["plain_mean"]:
        fail(f"rerank scores further from the f32 forward than the plain path: {res['vs_f32']}")
    decided, overlap = 0, 0
    for qi in range(N_QUESTIONS):
        sl = slice(qi * RERANK_K, (qi + 1) * RERANK_K)
        want = {d["key"] for d in rerank_topk_filter.__wrapped_fun__(pair_docs[sl], plain[sl].tolist(), RERANK_KEEP)[0]}
        got = {d["key"] for d in kept[qi][0]}
        overlap += len(got & want)
        ranked = np.sort(plain[sl])[::-1]
        if ranked[RERANK_KEEP - 1] - ranked[RERANK_KEEP] <= SCORE_ATOL:
            continue  # a near tie at the cut: either five is right
        decided += 1
        if got != want:
            fail(f"rerank question {qi}: kept five differ from the plain ranking")
    res["questions_decided"] = decided
    res["kept_overlap_with_plain"] = overlap / (N_QUESTIONS * RERANK_KEEP)
    note_widths(pair_qs, [d["text"] for d in pair_docs])
    note_widths(batched, batch=embedder.encoder.max_batch)
    for q in singles:
        note_widths([q])
    res["attention_widths"] = sorted(widths)
    if not widths <= compared_widths:
        fail(f"rerank path widths {sorted(widths)} outside the shapes phase 2 compared")
    log(f"rerank gates: max_abs_err {err.max():.3e} (tol {SCORE_ATOL}), vs f32 {json.dumps(res['vs_f32'])}, "
        f"{decided}/{N_QUESTIONS} questions decided, kept-five overlap {res['kept_overlap_with_plain']:.3f}, "
        f"widths {sorted(widths)}")
    res["profile"] = profile_call(
        torch, lambda: reranker.__batch__(pair_docs[:RERANK_BATCH], pair_qs[:RERANK_BATCH]), RERANK_BATCH
    )
    res["_pairs"] = (pair_qs, [d["text"] for d in pair_docs])
    res["_pair_scores"] = scores
    return res


def synthetic_captions(np, n: int, seed: int) -> list[str]:
    """``n`` short captions of the kind a user types to find an image."""
    rng = np.random.default_rng(seed)
    colours = ["red", "orange", "yellow", "green", "teal", "blue", "purple", "pink", "brown",
               "grey", "black", "white"]
    shapes = ["blocks", "squares", "tiles", "patches", "cells"]
    sizes = ["large", "small", "tiny", "wide", "many"]
    return [
        f"{rng.choice(sizes)} {rng.choice(colours)} {rng.choice(shapes)} over a "
        f"{rng.choice(colours)} to {rng.choice(colours)} gradient"
        for _ in range(n)
    ]


def phase_image(torch, dev, compared_widths: set) -> dict:
    """Phase 5: images -> embed -> index -> text-to-image retrieve through
    ``DualEncoderModel(SIGLIP_BASE, BGE_BASE)`` at full width."""
    import numpy as np

    from pathway_tpu_torch import BGE_BASE, SIGLIP_BASE, DualEncoderModel, ShardedKnnIndex, kernels
    from pathway_tpu_torch._device import upload
    from pathway_tpu_torch.kernels import dual_logits_plain
    from pathway_tpu_torch.models import HashTokenizer, VisionEncoderModel
    from pathway_tpu_torch.ops.distances import normalize

    res: dict = {}
    wall: dict = {}
    t_phase = t0 = time.perf_counter()

    def lap(name: str) -> None:
        nonlocal t0
        torch.cuda.synchronize()
        now = time.perf_counter()
        wall[name] = now - t0
        t0 = now

    model = DualEncoderModel(SIGLIP_BASE, BGE_BASE, device=dev, seed=SEED)
    vcfg = model.vision_cfg
    widths_cfg = (vcfg.image_size, vcfg.patch, vcfg.hidden, vcfg.layers, vcfg.heads, vcfg.mlp_dim, vcfg.embed_dim)
    if widths_cfg != (IMAGE_SIZE, PATCH, HIDDEN, 12, 12, 4 * HIDDEN, HIDDEN) or vcfg.n_patches != N_PATCH:
        fail(f"vision config {vcfg} is not SigLIP-base")
    tok = HashTokenizer(BGE_BASE.vocab_size)
    widths = {N_PATCH}

    def upload_captions(texts):
        ids, mask, _ = tok.encode_batch(texts)
        widths.add(ids.shape[1])
        return upload(ids, dev), upload(mask.astype(np.uint8), dev)

    # set-up: the index bulk-filled on the device with seeded random unit
    # rows, the images made from the seed and staged in pinned memory
    index = ShardedKnnIndex(HIDDEN, metric="cos", capacity=IMAGE_CAPACITY, device=dev)
    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    n_bulk = IMAGE_CAPACITY - N_IMAGES
    for lo in range(0, n_bulk, 65536):
        n = min(65536, n_bulk - lo)
        index.add_batch_device(range(lo, lo + n), torch.randn((n, HIDDEN), generator=g, device=dev))
    host = synthetic_images(np, torch, N_IMAGES, IMAGE_SIZE, SEED, dev).cpu().pin_memory()
    keys = [f"img-{i}" for i in range(N_IMAGES)]
    captions = synthetic_captions(np, N_CAPTIONS, SEED + 6)
    lap("setup_s")

    with torch.inference_mode():
        model.embed_image(host[:8].to(dev))  # first-call set-up (cuBLAS handles), untimed
        model.embed_text(*upload_captions(captions[:8]))
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()

        # (1) ingest: upload a chunk, embed it, upsert on the device (K2)
        for lo in range(0, N_IMAGES, IMAGE_BATCH):
            x = host[lo : lo + IMAGE_BATCH].to(dev, non_blocking=True)
            index.add_batch_device(keys[lo : lo + IMAGE_BATCH], model.embed_image(x))
        lap("ingest_s")
        res["ingest_images_per_s"] = N_IMAGES / wall["ingest_s"]
        chunks = N_IMAGES // IMAGE_BATCH
        ingest = kernels.launch_counts()
        res["ingest_launches"] = ingest
        # per chunk: K8 once, K4 once with the position addend and 6 times a
        # layer without, K9 once, K2 once
        want = {"patchify": chunks, "bias_act": chunks * (1 + 6 * vcfg.layers), "vision_head": chunks,
                "slab_scatter": chunks}
        if any(ingest[name] != n for name, n in want.items()):
            fail(f"image ingest launches {ingest}, expected {want}")
        if len(index) != n_bulk + N_IMAGES:
            fail(f"image index holds {len(index)} keys, expected {n_bulk + N_IMAGES}")
        log(f"image ingest: {N_IMAGES} images in {wall['ingest_s']:.3f} s = "
            f"{res['ingest_images_per_s']:.1f} images/s")

        # (2) self-retrieval: N_PROBE indexed images from every chunk, re-embedded
        probe = torch.arange(0, N_IMAGES, N_IMAGES // N_PROBE)
        q = model.embed_image(host[probe].to(dev))
        rows = index.search(q.cpu().numpy(), K)
        slots = torch.tensor([index._slot_of[key] for key in keys], device=dev)
        sims = normalize(q) @ index._vectors[slots].T  # [N_PROBE, N_IMAGES]
        at = torch.arange(N_PROBE, device=dev)
        self_cos = sims[at, probe.to(dev)].clone()
        sims[at, probe.to(dev)] = -2.0
        nearest = sims.max(dim=1).values
        decided = (self_cos - nearest) > SELF_MARGIN
        for i, row in enumerate(rows):
            if len(row) != K:
                fail(f"image search: {len(row)} results, expected {K}")
            if bool(decided[i]) and (row[0][0] != keys[int(probe[i])] or row[0][1] < SELF_COS):
                fail(f"image {keys[int(probe[i])]} came back as {row[0]} (nearest other {nearest[i].item()})")
        near = nearest.cpu().numpy()
        res["self_retrieval"] = {
            "probed": N_PROBE, "decided": int(decided.sum()),
            "min_self_cos": float(self_cos.min()),
            "nearest_other_cos": {"min": float(near.min()), "p50": float(np.median(near)), "max": float(near.max())},
        }
        log(f"image self-retrieval: {json.dumps(res['self_retrieval'])}")
        log("image nearest-other cosines: " + " ".join(f"{v:.4f}" for v in near))
        lap("self_retrieval_s")

        # (3) text -> image queries: tokenize, embed (K6 ... K7), search (K3)
        lat: dict = {}
        for nq, reps in ((1, 50), (32, 20)):
            total, search = [], []
            for r in range(reps):
                lo = (r * nq) % (32 - nq + 1)
                s0 = time.perf_counter()
                qs = model.embed_text(*upload_captions(captions[lo : lo + nq])).cpu().numpy()
                s1 = time.perf_counter()
                hits = index.search(qs, K)
                s2 = time.perf_counter()
                total.append((s2 - s0) * 1e3)
                search.append((s2 - s1) * 1e3)
                if any(len(h) != K for h in hits):
                    fail(f"text -> image search nq={nq}: short result")
            lat[nq] = {"p50_ms": float(np.percentile(total, 50)), "p99_ms": float(np.percentile(total, 99)),
                       "search_p50_ms": float(np.percentile(search, 50)),
                       "search_p99_ms": float(np.percentile(search, 99))}
            log(f"text -> image nq={nq}: {json.dumps(lat[nq])}")
        res["query"] = lat
        qs = model.embed_text(*upload_captions(captions[:32])).cpu().numpy()
        check_search_against_plain(torch, index, qs)
        hits = index.search(qs, K)
        res["caption_top1_images"] = sum(str(h[0][0]).startswith("img-") for h in hits)
        lap("query_s")

        # (4) the image x caption logits through K10
        x = host[:IMAGE_BATCH].to(dev)
        cap_ids, cap_mask = upload_captions(captions)
        logits = model(x, cap_ids, cap_mask)
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        res["launches"] = launches
        res["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        img, txt = model.embed_image(x), model.embed_text(cap_ids, cap_mask)
        ref = dual_logits_plain(img, txt, model.logit_scale, model.logit_bias)
        err = (logits - ref).abs().max().item()
        if logits.shape != (IMAGE_BATCH, N_CAPTIONS) or not bool(logits.isfinite().all()) or not err <= LOGIT_ATOL:
            fail(f"image x caption logits {tuple(logits.shape)}: max err {err} vs plain")
        res["logits"] = {"shape": list(logits.shape), "max_abs_err_vs_plain": err,
                         "min": float(logits.min()), "max": float(logits.max())}
        lap("logits_s")
        path = ("patchify", "bias_act", "attention", "add_layer_norm", "vision_head", "embed_ln",
                "pool_normalize", "slab_scatter", "knn_topk", "dual_logits")
        zero = [name for name in path if launches[name] == 0]
        if zero:
            fail(f"kernels not launched on the image path: {zero}")
        res["attention_widths"] = sorted(widths)
        if not widths <= compared_widths:
            fail(f"image path widths {sorted(widths)} outside the shapes phase 2 compared")

        # (5) the embeddings against the same tower through the plain versions
        # only, and both against the same forward in f32
        model32 = VisionEncoderModel(dataclasses.replace(vcfg, dtype=torch.float32), device=dev)
        model32.load_state_dict(model.vision.state_dict())
        plain = plain_vision_forward(model.vision, x)
        plain32 = plain_vision_forward(model32, x)
        del model32
        diff = (img - plain).abs()
        cos = (img * plain).sum(1) / (img.norm(dim=1) * plain.norm(dim=1))
        res["vs_plain"] = {"max_abs_err": diff.max().item(), "mean_abs_err": diff.mean().item(),
                           "min_cos": cos.min().item()}
        res["vs_f32"] = {"kernel_mean": (img - plain32).abs().mean().item(),
                         "kernel_max": (img - plain32).abs().max().item(),
                         "plain_mean": (plain - plain32).abs().mean().item(),
                         "plain_max": (plain - plain32).abs().max().item()}
        log(f"image embeddings vs plain {json.dumps(res['vs_plain'])}, vs f32 {json.dumps(res['vs_f32'])}")
        if not (res["vs_plain"]["min_cos"] >= EMBED_COS and res["vs_plain"]["max_abs_err"] <= EMBED_ATOL):
            fail(f"image embeddings differ from the plain-only forward: {res['vs_plain']}")
        if not res["vs_f32"]["kernel_mean"] <= F32_RATIO * res["vs_f32"]["plain_mean"]:
            fail(f"image embeddings further from the f32 forward than the plain path: {res['vs_f32']}")
        lap("reference_s")

        # (6) where the time goes: one chunk's embed + upsert, and one
        # single-caption query (tokenize, embed, read back, search)
        res["profile"] = profile_call(
            torch, lambda: index.add_batch_device(keys[:IMAGE_BATCH], model.embed_image(
                host[:IMAGE_BATCH].to(dev, non_blocking=True))), IMAGE_BATCH,
        )
        log(f"image chunk profile: {json.dumps(res['profile'])}")
        res["query_profile"] = profile_call(
            torch, lambda: index.search(model.embed_text(*upload_captions(captions[:1])).cpu().numpy(), K), 1,
        )
        log(f"text -> image query profile (nq=1): {json.dumps(res['query_profile'])}")
        lap("profile_s")
    wall["total_s"] = time.perf_counter() - t_phase
    res["wall_s"] = wall
    log(f"image phase wall times: {json.dumps(wall)}")
    return res


def mixture(np, n: int, d: int, seed: int, chunk: int, n_clusters: int = 64) -> list:
    """``tests/test_ivf.py``'s clustered data (``n_clusters`` centres x 3.0
    plus unit noise) from ``seed``, in f32 chunks of ``chunk`` rows: one
    generator, normals drawn in f32 (1M x 768 in float64 would take 6.4 GB)."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clusters, d)).astype(np.float32) * 3.0
    out = []
    for lo in range(0, n, chunk):
        m = min(chunk, n - lo)
        assign = rng.integers(0, n_clusters, size=m)
        x = rng.standard_normal((m, d), dtype=np.float32)
        x += centers[assign]
        out.append(x)
    return out


def check_assign(torch, x, c, half_norm: bool, got=None, label: str = "ivf_assign") -> float:
    """K11 (or ``got``, another build's answer) against its plain version:
    the same centroid on every row whose top-2 scores differ by more than
    ASSIGN_ATOL, elsewhere a centroid within ASSIGN_ATOL of the best.
    Returns the largest score shortfall."""
    from pathway_tpu_torch.kernels import ivf_assign, ivf_assign_plain

    got = (ivf_assign(x, c, half_norm) if got is None else got).long()
    want = ivf_assign_plain(x, c, half_norm).long()
    scores = x @ c.T
    if half_norm:
        scores -= 0.5 * (c * c).sum(1)
    top2 = scores.topk(2, dim=1).values
    decided = (top2[:, 0] - top2[:, 1]) > ASSIGN_ATOL
    if not bool((got[decided] == want[decided]).all()):
        fail(f"{label} (half_norm={half_norm}): {int((got != want)[decided].sum())} decided rows differ")
    short = (top2[:, 0] - scores.gather(1, got[:, None])[:, 0]).max().item()
    if not short <= ASSIGN_ATOL:
        fail(f"{label} (half_norm={half_norm}): a row's centroid scores {short} below the best")
    log(f"K11 {label} n={x.shape[0]} half_norm={half_norm}: {int(decided.sum())} rows decided, "
        f"{int((got != want).sum())} near-tie rows differ, max shortfall {short:.3e}")
    return short


def plain_ivf_search(torch, index, qs, k=K, nprobe=None):
    """The index's search through K3's and K12's plain versions over its own
    tensors: (scores [nq, k], keys per query, and how many queries' probes
    differ from the kernel's by a near-tie, where the plain scan then takes
    the kernel's probe: both are right).  Nothing on the path calls it."""
    from pathway_tpu_torch.kernels import ivf_scan_plain, knn_topk, knn_topk_plain

    nprobe = nprobe or index.nprobe
    q = torch.from_numpy(index._normalize(qs)).to(index.device)
    ones = torch.ones((index.nlist,), device=index.device)
    pv, pi = knn_topk_plain(q, index._centroids, ones, nprobe, "dot")
    kv, ki = knn_topk(q, index._centroids, ones, nprobe, "dot")
    compare_topk(kv, ki, pv, pi, TOPK_ATOL)
    same = torch.tensor([set(a) == set(b) for a, b in zip(pi.tolist(), ki.tolist())], device=q.device)
    probe = torch.where(same[:, None], pi, ki)
    vals, flat = ivf_scan_plain(q, probe, index._cells, index._valid, k, query_block=1)
    keys = [[index._key_of[divmod(f, index.cell_cap)] for f in row] for row in flat.tolist()]
    return vals.cpu().numpy(), keys, int((~same).sum())


def phase_ivf(torch, dev) -> dict:
    """Phase 6: embed -> train -> approximate index -> retrieve through
    ``IvfKnnIndex`` at 1M rows, BGE-base width.  The documents are phase 3's,
    so their encoder widths are the ones phase 3 checked."""
    import numpy as np

    from pathway_tpu_torch import BGE_BASE, IvfKnnIndex, TorchEncoder, kernels
    from pathway_tpu_torch.internals import device_counters
    from pathway_tpu_torch.kernels import (
        ivf_assign, ivf_assign_plain, ivf_scan, ivf_scan_plain, knn_topk, slab_scatter, slab_scatter_plain,
    )
    from pathway_tpu_torch.kernels.ivf_scan import _launch as scan_launch
    from pathway_tpu_torch.kernels.ivf_scan import scan_form
    from pathway_tpu_torch.ops.topk import NEG_INF
    from pathway_tpu_torch.parallel import ivf_knn

    res: dict = {}
    wall: dict = {}
    t_phase = t0 = time.perf_counter()

    def lap(name: str) -> None:
        nonlocal t0
        torch.cuda.synchronize()
        now = time.perf_counter()
        wall[name] = now - t0
        t0 = now

    # set-up: the encoder, the documents, the bulk corpus (host chunks) and
    # the queries, all from the seed
    encoder = TorchEncoder(BGE_BASE, max_batch=DOC_BATCH, seed=SEED, device=dev)
    dim = encoder.config.hidden
    if dim != HIDDEN:
        fail(f"encoder width {dim} is not {HIDDEN}")
    index = IvfKnnIndex(dim, metric="cos", capacity=IVF_CAPACITY, device=dev)
    shape = (index.nlist, index.nprobe, index.cell_cap, index.dtype, index.train_size)
    if shape != (IVF_NLIST, IVF_NPROBE, IVF_CELL_CAP, torch.bfloat16, 50_000):
        fail(f"IVF configuration {shape} is not the JAX package's default at {IVF_CAPACITY}")
    docs = synthetic_docs(np, N_DOCS, SEED)
    doc_keys = [f"doc-{i}" for i in range(N_DOCS)]
    chunks = mixture(np, IVF_BULK, dim, SEED, IVF_CHUNK)
    starts = np.cumsum([0] + [len(c) for c in chunks])
    queries = mixture(np, IVF_QUERIES, dim, SEED + 1, IVF_QUERIES)[0]
    encoder.encode(docs[:8])  # first-call set-up, untimed
    kmeans = ivf_knn._kmeans

    def timed_kmeans(*args, **kwargs):
        k0 = time.perf_counter()
        out = kmeans(*args, **kwargs)
        wall["kmeans_s"] = time.perf_counter() - k0
        return out

    lap("setup_s")

    kernels.reset_launch_counts()
    device_counters.reset_for_tests()
    torch.cuda.reset_peak_memory_stats()
    # (1) embed the documents; the JAX IVF takes host rows, so they come back
    doc_emb = encoder.encode(docs)
    lap("embed_s")
    if doc_emb.shape != (N_DOCS, dim) or not np.isfinite(doc_emb).all():
        fail(f"document embeddings: shape {doc_emb.shape} or non-finite values")
    # (2) the first add: the documents and the first chunk buffer, pass
    # max(nlist * 8, 1024) rows and train the index (k-means through K11),
    # which then adds them
    ivf_knn._kmeans = timed_kmeans
    try:
        index.add_batch(doc_keys + list(range(starts[1])), np.concatenate([doc_emb, chunks[0]]))
    finally:
        ivf_knn._kmeans = kmeans
    lap("first_add_s")
    if not index.trained or len(index) != N_DOCS + starts[1]:
        fail(f"first add: trained={index.trained}, {len(index)} keys")
    # (3) the rest of the bulk, a chunk at a time
    for i in range(1, len(chunks)):
        index.add_batch(range(starts[i], starts[i + 1]), chunks[i])
    lap("bulk_s")
    res["bulk_rows_per_s"] = (IVF_BULK - starts[1]) / wall["bulk_s"]
    res["ingest_rows_per_s"] = (IVF_BULK + N_DOCS) / (wall["first_add_s"] + wall["bulk_s"])
    if len(index) != IVF_BULK + N_DOCS:
        fail(f"IVF index holds {len(index)} keys, expected {IVF_BULK + N_DOCS}")
    # (4) documents edited: re-embedded and upserted (remove + add); rows
    # removed and re-added
    emb2 = encoder.encode(docs[:IVF_UPSERT])
    index.add_batch(doc_keys[:IVF_UPSERT], emb2)
    lap("upsert_s")
    res["upsert_docs_per_s"] = IVF_UPSERT / wall["upsert_s"]
    gone = list(range(starts[1], starts[1] + IVF_READD))
    index.remove(gone)
    if any(key in index for key in gone):
        fail("removed keys still in the index")
    index.add_batch(gone, chunks[1][:IVF_READD])
    lap("readd_s")
    # (5) queries: nq=1 and nq=32, k=10
    lat: dict = {}
    for nq, reps in ((1, 50), (32, 20)):
        times = []
        for r in range(reps):
            lo = (r * nq) % (IVF_QUERIES - nq + 1)
            s0 = time.perf_counter()
            rows = index.search(queries[lo : lo + nq], K)
            times.append((time.perf_counter() - s0) * 1e3)
            if any(len(row) != K for row in rows):
                fail(f"IVF search nq={nq}: short result")
        lat[nq] = {"p50_ms": float(np.percentile(times, 50)), "p99_ms": float(np.percentile(times, 99))}
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    res["launches"] = launches
    res["transfers"] = device_counters.snapshot()
    res["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    res["cell_cap"] = index.cell_cap
    fill = index._valid.sum(1)
    res["cell_rows"] = {"min": int(fill.min()), "max": int(fill.max()), "mean": float(fill.mean())}
    lap("query_s")
    log(f"IVF ingest: {json.dumps(res)} wall {json.dumps(wall)}")
    path = ("ivf_assign", "ivf_scan", "knn_topk", "slab_scatter", "slab_clear",
            "attention", "bias_act", "add_layer_norm", "embed_ln", "pool_normalize")
    zero = [name for name in path if launches[name] == 0]
    if zero:
        fail(f"kernels not launched on the IVF path: {zero}")

    # gates.  The rows as indexed, normalised on the host as the index does,
    # in an f32 slab for the exact truth and K3's brute-force times
    final_emb = doc_emb.copy()
    final_emb[:IVF_UPSERT] = emb2
    keys_of_row = doc_keys + list(range(IVF_BULK))
    slab = torch.empty((len(keys_of_row), dim), device=dev)
    slab[:N_DOCS] = torch.from_numpy(index._normalize(final_emb)).to(dev)
    for i, chunk in enumerate(chunks):
        slab[N_DOCS + starts[i] : N_DOCS + starts[i + 1]] = torch.from_numpy(index._normalize(chunk)).to(dev)
    ones = torch.ones((slab.shape[0],), device=dev)
    qn = torch.from_numpy(index._normalize(queries)).to(dev)

    # (a) recall@10 against exact f32 brute force (K3 over the flat slab)
    got = [row for lo in range(0, IVF_QUERIES, 32) for row in index.search(queries[lo : lo + 32], K)]
    hits = 0
    for lo in range(0, IVF_QUERIES, 32):
        _, ti = knn_topk(qn[lo : lo + 32], slab, ones, K, "dot")
        for row, truth in zip(got[lo : lo + 32], ti.tolist()):
            want = {keys_of_row[s] for s in truth}
            hits += sum(1 for key, _ in row if key in want)
    res["recall_at_10"] = hits / (IVF_QUERIES * K)
    log(f"IVF recall@{K} over {IVF_QUERIES} mixture queries: {res['recall_at_10']:.4f}")
    if not res["recall_at_10"] >= IVF_RECALL:
        fail(f"IVF recall@{K} {res['recall_at_10']:.4f} < {IVF_RECALL}")
    lap("recall_s")

    # (b) the search against its plain search over the same tensors
    pv, pkeys, probe_ties = plain_ivf_search(torch, index, queries[:IVF_CHECKED])
    search_err = 0.0
    for nq in (1, 8, 32):
        for lo in range(0, IVF_CHECKED, nq):
            for r, row in enumerate(index.search(queries[lo : lo + nq], K)):
                want_v, want_k = pv[lo + r], pkeys[lo + r]
                if len(row) != K:
                    fail(f"IVF search nq={nq} query {lo + r}: {len(row)} results")
                err = float(np.abs(np.array([s for _, s in row]) - want_v).max())
                sure = {key for key, v in zip(want_k, want_v) if v > want_v[-1] + TOPK_ATOL}
                if not err <= TOPK_ATOL or not sure <= {key for key, _ in row}:
                    fail(f"IVF search nq={nq} query {lo + r}: differs from the plain search (err {err})")
                search_err = max(search_err, err)
    res["vs_plain"] = {"max_abs_err": search_err, "probe_near_ties": probe_ties}
    log(f"IVF search vs plain at nq 1/8/32: {json.dumps(res['vs_plain'])}")

    # (c) self-retrieval of the documents whose nearest other lies clear below
    probe_docs = np.arange(0, N_DOCS, N_DOCS // IVF_SELF)
    docs_n = slab[:N_DOCS]
    sims = docs_n[probe_docs] @ docs_n.T
    at = torch.arange(len(probe_docs), device=dev)
    self_cos = sims[at, torch.from_numpy(probe_docs).to(dev)].clone()
    sims[at, torch.from_numpy(probe_docs).to(dev)] = -2.0
    nearest = sims.max(dim=1).values
    decided = ((self_cos - nearest) > SELF_MARGIN).tolist()
    rows = index.search(final_emb[probe_docs], K)
    for i, row in enumerate(rows):
        if decided[i] and (row[0][0] != doc_keys[probe_docs[i]] or row[0][1] < SELF_COS):
            fail(f"{doc_keys[probe_docs[i]]} came back as {row[0]} (nearest other {nearest[i].item()})")
    near = nearest.cpu().numpy()
    res["self_retrieval"] = {
        "probed": len(probe_docs), "decided": int(sum(decided)),
        "nearest_other_cos": {"min": float(near.min()), "p50": float(np.median(near)), "max": float(near.max())},
    }
    log(f"IVF self-retrieval: {json.dumps(res['self_retrieval'])}")
    lap("gates_s")

    # (d) K11 against its plain version at the path's shapes: an ingest chunk
    # against the trained centroids, and 50,000 rows with the Lloyd term
    cents = index._centroids
    # the first chunk's rows as the index holds them: buffered before the
    # training, they were normalised when added and again when flushed
    x = torch.from_numpy(index._normalize(index._normalize(chunks[0]))).to(dev)
    assign_err = max(check_assign(torch, x, cents, False), check_assign(torch, x[:50_000], cents, True))
    nb = x.shape[0] * dim * 4 + cents.numel() * 4 + x.shape[0] * 4
    b_ms, b_by = bound(nb, 2 * x.shape[0] * index.nlist * dim, PEAK_F32_PRODUCT)
    kern = lambda: ivf_assign(x, cents, False)  # noqa: E731
    plain = lambda: ivf_assign_plain(x, cents, False)  # noqa: E731
    lib = lambda: torch.argmax(torch.matmul(x, cents.T), dim=1)  # noqa: E731
    xl = x[:50_000]
    half_sq = 0.5 * (cents * cents).sum(1)  # the library call's Lloyd term, computed once (untimed)
    assign_row = {
        "shape": f"n={x.shape[0]} x [{index.nlist},{dim}] f32 -> argmax (ingest chunk)",
        "max_abs_err": assign_err,
        "ms": time_ms(torch, kern, 10),
        "plain_ms": time_ms(torch, plain, 5),
        "library_ms": time_ms(torch, lib, 5),
        "bound_ms": b_ms, "bound_by": b_by,
        "device_ms": {"kernel": device_ms(torch, kern, 10), "plain": device_ms(torch, plain, 10),
                      "library": device_ms(torch, lib, 10)},
        "lloyd_ms": time_ms(torch, lambda: ivf_assign(xl, cents, True), 10),
        "lloyd_library_ms": time_ms(torch, lambda: torch.argmax(torch.matmul(xl, cents.T) - half_sq, dim=1), 5),
        "lloyd_bound_ms": bound(xl.shape[0] * dim * 4 + cents.numel() * 4 + xl.shape[0] * 4,
                                2 * xl.shape[0] * index.nlist * dim + xl.shape[0] * index.nlist,
                                PEAK_F32_PRODUCT)[0],
    }
    log(f"K11 ivf_assign: {json.dumps(assign_row)}")

    # (d2) B11 on K2 over the flat cell view at an ingest chunk's shape: the
    # first chunk's rows written again into their own slots (the same values)
    cells_flat, valid_flat = index._cells.view(-1, dim), index._valid.view(-1)
    flat = torch.tensor([c * index.cell_cap + s for c, s in (index._slot_of[k] for k in range(starts[1]))],
                        dtype=torch.int32, device=dev)
    flat_long, n = flat.long(), x.shape[0]
    slab_scatter(cells_flat, valid_flat, flat, x, normalize=False)
    if not torch.equal(cells_flat[flat_long], x.to(index.dtype)) or not bool(valid_flat[flat_long].all()):
        fail("slab_scatter on the flat cell view: rows or flags differ from the bf16 cast of the chunk")
    b_ms, b_by = bound(n * dim * 4 + n * 4 + n * (dim * 2 + 4), n * dim, PEAK_F32)
    scatter_row = {
        "shape": f"n={n} f32 rows into [{index.nlist * index.cell_cap},{dim}] bf16 (the flat cell view)",
        "ms": time_ms(torch, lambda: slab_scatter(cells_flat, valid_flat, flat, x, normalize=False), 10),
        "plain_ms": time_ms(torch, lambda: slab_scatter_plain(cells_flat, valid_flat, flat, x, False), 5),
        "library_ms": time_ms(torch, lambda: cells_flat.index_copy_(0, flat_long, x.to(index.dtype)), 10),
        "bound_ms": b_ms, "bound_by": b_by,
    }
    log(f"K2 slab_scatter on the flat cell view: {json.dumps(scatter_row)}")
    del x, flat, flat_long

    # (e) K12 against its plain version on the index's cells, in both forms
    # (query-major and cell-major, each with K3's merge) at nq in SCAN_NQ,
    # timed beside the union-bytes bound and K3's brute force over the same
    # rows (f32); the public wrapper's row at nq=1 and nq=32
    ones_c = torch.ones((index.nlist,), device=dev)
    scan_err, scan_rows, forms = 0.0, {}, {}
    for nq in SCAN_NQ:
        q = qn[:nq].contiguous()
        probe = knn_topk(q, cents, ones_c, index.nprobe, "dot")[1]
        qr = q.to(index.dtype).float().contiguous()
        pv_, pi_ = ivf_scan_plain(q, probe, index._cells, index._valid, K, query_block=1)
        errs = {}
        for form in ("query", "cell"):
            kv, ki = scan_launch(qr, probe, index._cells, index._valid, K, form == "cell", dev)
            errs[form] = compare_topk(kv, ki, pv_, pi_, TOPK_ATOL)
        scan_err = max(scan_err, *errs.values())
        cells_used = torch.unique(probe.long())
        live_union = int(index._valid[cells_used].sum())
        live_per_q = int(index._valid[probe.long()].sum())
        nb = (live_union * dim * 2 + cells_used.numel() * index.cell_cap * 4 + q.numel() * 4
              + probe.numel() * 4 + nq * K * 8)
        b_ms, b_by = bound(nb, 2 * live_per_q * dim, PEAK_F32_PRODUCT)
        forms[nq] = {
            "form": scan_form(nq), "max_abs_err": errs,
            "query_ms": time_ms(torch, lambda: scan_launch(qr, probe, index._cells, index._valid, K, False, dev), 10),
            "cell_ms": time_ms(torch, lambda: scan_launch(qr, probe, index._cells, index._valid, K, True, dev), 10),
            "bound_ms": b_ms, "bound_by": b_by,
            "brute_force_ms": time_ms(torch, lambda: knn_topk(q, slab, ones, K, "dot"), 5),
            "live_rows": {"union": live_union, "over_queries": live_per_q},
        }
        log(f"K12 both forms at nq={nq}: {json.dumps(forms[nq])}")
        if nq not in (1, 32):
            continue
        sub_q = q[0].to(index.dtype)
        p0 = probe[0].long()

        def library(p0=p0, sub_q=sub_q):  # gather + einsum + masked top-k, one query
            s = torch.einsum("pcd,d->pc", index._cells[p0], sub_q)
            return torch.topk(torch.where(index._valid[p0].bool(), s.float(), NEG_INF).view(-1), K)

        before = ivf_scan.launches
        ivf_scan(q, probe, index._cells, index._valid, K)
        scan_rows[nq] = {
            "shape": f"nq={nq} k={K}, {index.nprobe} of {index.nlist} cells of {index.cell_cap} bf16 slots, "
                     f"{live_union} live rows in the probed cells ({live_per_q} over the queries), "
                     f"{scan_form(nq)}-major",
            "launches_per_call": ivf_scan.launches - before,
            "ms": time_ms(torch, lambda: ivf_scan(q, probe, index._cells, index._valid, K), 10),
            "plain_ms": time_ms(torch, lambda: ivf_scan_plain(q, probe, index._cells, index._valid, K, 1), 3),
            "library_ms": time_ms(torch, library, 10) if nq == 1 else None,
            "bound_ms": b_ms, "bound_by": b_by,
            "probe_ms": time_ms(torch, lambda: knn_topk(q, cents, ones_c, index.nprobe, "dot"), 10),
            "brute_force_ms": forms[nq]["brute_force_ms"],
        }
        log(f"K12 ivf_scan: {json.dumps(scan_rows[nq])}")
    if not scan_rows[32]["ms"] < scan_rows[32]["brute_force_ms"]:
        fail(f"K12 at nq=32 ({scan_form(32)}-major) takes {scan_rows[32]['ms']:.4f} ms, not below exact K3 over "
             f"the same rows ({scan_rows[32]['brute_force_ms']:.4f} ms)")
    res["ivf_scan_forms"] = forms
    scan_row = {**scan_rows[1], "max_abs_err": max(scan_err, search_err), "_nq32": scan_rows[32]}
    del slab, ones
    lap("kernels_s")

    # (f) the grow scenario of tests/test_ivf.py at d=768, on the card, and
    # an nprobe and a k above K3's MAX_K, which K13 selects
    rng = np.random.default_rng(SEED)
    base = rng.normal(size=(1, dim)).astype(np.float32)
    xs = base + 0.01 * rng.normal(size=(3000, dim)).astype(np.float32)
    small = IvfKnnIndex(dim, metric="dot", capacity=64, nlist=16, nprobe=16, device=dev)
    small.train(xs[:500])
    cap0 = small.cell_cap
    small.add_batch(range(3000), xs)
    outlier = (100.0 * np.eye(1, dim)).astype(np.float32)
    small.add_batch(["outlier"], outlier)
    top = small.search(outlier, 1)[0]
    if not (small.cell_cap > cap0 and top and top[0][0] == "outlier" and len(small) == 3001):
        fail(f"IVF grow: cell_cap {cap0} -> {small.cell_cap}, outlier search {top}, {len(small)} keys")
    res["grow"] = {"cell_cap": [cap0, small.cell_cap], "outlier_score": top[0][1]}
    log(f"IVF grow: {json.dumps(res['grow'])}")
    del small
    wide = IvfKnnIndex(dim, metric="cos", capacity=64, nlist=256, nprobe=8, device=dev)
    wide.train(xs[:300])
    wide.add_batch(range(300), xs[:300])
    for k, nprobe in ((K, 129), (129, 256)):
        got = wide.search(xs[:2], k, nprobe=nprobe)
        want_v, _, _ = plain_ivf_search(torch, wide, xs[:2], k, nprobe)
        for row, want in zip(got, want_v):
            err = float(np.abs(np.array([v for _, v in row]) - want).max())
            if len(row) != k or not err <= TOPK_ATOL:
                fail(f"IVF search k={k} nprobe={nprobe}: {len(row)} results, err {err} against the plain search")
    log("IVF search at nprobe=129 and at k=129 equals its plain search")
    del wide
    lap("grow_s")

    # (g) where the time goes: one ingest chunk (an upsert of the first
    # chunk's keys: remove, assign, scatter) and one nq=32 search
    res["profile"] = profile_call(
        torch, lambda: index.add_batch(range(starts[1]), chunks[0]), IVF_CHUNK
    )
    log(f"IVF ingest chunk profile: {json.dumps(res['profile'])}")
    res["query_profile"] = profile_call(torch, lambda: index.search(queries[:32], K), 32)
    log(f"IVF search profile (nq=32): {json.dumps(res['query_profile'])}")
    lap("profile_s")
    res["search"] = lat
    res["kernels"] = {"ivf_assign": assign_row, "ivf_scan": scan_row}
    res["flat_scatter"] = scatter_row
    res["docs_per_s_embed"] = N_DOCS / wall["embed_s"]
    wall["total_s"] = time.perf_counter() - t_phase
    res["wall_s"] = wall
    log(f"IVF search: {json.dumps(lat)}; phase wall times: {json.dumps(wall)}")
    return res


def compare_rows(got_rows, want_rows, k: int, tol: float, what: str) -> float:
    """Search answers ``[[(key, score), ...], ...]`` against a reference's:
    k results each, scores within ``tol`` rank by rank, and every key the
    reference ranks clear of its k-th score by more than ``tol`` (away from
    near-ties) among the answers.  Returns the largest score difference."""
    import numpy as np

    worst = 0.0
    for r, (got, want) in enumerate(zip(got_rows, want_rows)):
        gv = np.array([v for _, v in got])
        wv = np.array([v for _, v in want])
        if len(got) != k or len(want) != k:
            fail(f"{what} row {r}: {len(got)} results against {len(want)}, expected {k}")
        err = float(np.abs(gv - wv).max())
        sure = {key for key, v in want if v > wv[-1] + tol}
        if not err <= tol or not sure <= {key for key, _ in got}:
            fail(f"{what} row {r}: differs from the reference (err {err}, tol {tol})")
        worst = max(worst, err)
    return worst


def phase_ivf_defaults(torch, dev) -> dict:
    """Phase 6, continued: the JAX IVF's defaults from 4,194,304 rows of
    capacity (nlist 2,048, nprobe 256: above K3's MAX_K, so the probe and
    a k=256 search go through K13).  262,144 mixture rows train and fill
    it; searches at nq 1 and 32, k=10 and k=256, against its plain search;
    recall@10 against exact f32 brute force."""
    import numpy as np

    from pathway_tpu_torch import IvfKnnIndex, kernels
    from pathway_tpu_torch.kernels import knn_topk

    res: dict = {}
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    index = IvfKnnIndex(HIDDEN, metric="cos", capacity=C3_CAPACITY, device=dev)
    shape = (index.nlist, index.nprobe, index.cell_cap, index.dtype)
    if shape != (C3_NLIST, C3_NPROBE, C3_CELL_CAP, torch.bfloat16):
        fail(f"IVF configuration {shape} is not the JAX package's default at {C3_CAPACITY}")
    res["cells_gb"] = index._cells.numel() * index._cells.element_size() / 1e9
    chunks = mixture(np, C3_ROWS, HIDDEN, SEED, IVF_CHUNK)
    starts = np.cumsum([0] + [len(c) for c in chunks])
    queries = mixture(np, IVF_QUERIES, HIDDEN, SEED + 1, IVF_QUERIES)[0]

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    for i, chunk in enumerate(chunks):
        index.add_batch(range(starts[i], starts[i + 1]), chunk)
    torch.cuda.synchronize()
    res["ingest_rows_per_s"] = C3_ROWS / (time.perf_counter() - t0)
    if not index.trained or len(index) != C3_ROWS:
        fail(f"IVF defaults: trained={index.trained}, {len(index)} keys")
    lat: dict = {}
    for k in (K, SELECT_K):
        for nq, reps in ((1, 20), (32, 10)):
            times = []
            for r in range(reps):
                lo = (r * nq) % (IVF_QUERIES - nq + 1)
                s0 = time.perf_counter()
                rows = index.search(queries[lo : lo + nq], k)
                times.append((time.perf_counter() - s0) * 1e3)
                if any(len(row) != k for row in rows):
                    fail(f"IVF defaults search nq={nq} k={k}: short result")
            lat[f"nq{nq}_k{k}"] = {"p50_ms": float(np.percentile(times, 50)),
                                   "p99_ms": float(np.percentile(times, 99))}
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    res["launches"] = launches
    res["search"] = lat
    res["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"IVF defaults (C3): {json.dumps(res)}")
    zero = [n for n in ("ivf_assign", "ivf_scan", "knn_topk", "topk_select", "slab_scatter") if launches[n] == 0]
    if zero:
        fail(f"kernels not launched on the IVF path at its defaults: {zero}")
    if any(t.device != dev for t in (index._cells, index._valid, index._centroids)):
        fail("IVF defaults: the index's tensors left the card")

    # the searches against the plain search over the same tensors (the
    # plain top-256, whose first ten are the plain top-10)
    pv, pkeys, ties = plain_ivf_search(torch, index, queries[:32], SELECT_K)
    err = 0.0
    for nq in (1, 32):
        for k in (K, SELECT_K):
            want = [list(zip(pkeys[r][:k], pv[r][:k].tolist())) for r in range(nq)]
            err = max(err, compare_rows(index.search(queries[:nq], k), want, k, TOPK_ATOL,
                                        f"IVF defaults nq={nq} k={k}"))
    res["vs_plain"] = {"max_abs_err": err, "probe_near_ties": ties}
    # recall@10 against exact f32 brute force over the same rows (K3)
    slab = torch.cat([torch.from_numpy(index._normalize(c)).to(dev) for c in chunks])
    ones = torch.ones((slab.shape[0],), device=dev)
    qn = torch.from_numpy(index._normalize(queries)).to(dev)
    hits = 0
    for lo in range(0, IVF_QUERIES, 32):
        got = index.search(queries[lo : lo + 32], K)
        truth = knn_topk(qn[lo : lo + 32], slab, ones, K, "dot")[1].tolist()
        hits += sum(len({key for key, _ in row} & set(t)) for row, t in zip(got, truth))
    res["recall_at_10"] = hits / (IVF_QUERIES * K)
    res["wall_s"] = time.perf_counter() - t_phase
    log(f"IVF defaults gates: {json.dumps(res['vs_plain'])}, recall@{K} {res['recall_at_10']:.4f}, "
        f"wall {res['wall_s']:.1f} s")
    if not res["recall_at_10"] >= IVF_RECALL:
        fail(f"IVF defaults recall@{K} {res['recall_at_10']:.4f} < {IVF_RECALL}")
    return res


def phase_sharded(torch, dev, ctx: dict) -> dict:
    """Phase 8: the sharded corpus on a mesh of SHARDS copies of the card:
    BGE-base full width data parallel over the mesh embeds phase 3's
    documents into a 1,048,576-slot index of SHARDS shards, bulk-filled
    with phase 3's seeded rows; searches at nq 1 and 32, k=10 and k=256,
    against phase 3's unsharded index over the same rows."""
    import numpy as np

    from pathway_tpu_torch import BGE_BASE, ShardedKnnIndex, TorchEncoder, kernels, make_mesh
    from pathway_tpu_torch.kernels import knn_topk, knn_topk_plain, topk_select_plain
    from pathway_tpu_torch.kernels.knn_topk import merge_partials
    from pathway_tpu_torch.ops.distances import normalize

    index, docs, keys, q_all = ctx["index"], ctx["docs"], ctx["keys"], ctx["q_all"]
    res: dict = {}
    t_phase = time.perf_counter()
    mesh = make_mesh({"data": SHARDS}, [dev] * SHARDS)
    sidx = ShardedKnnIndex(HIDDEN, metric="cos", capacity=CAPACITY, mesh=mesh)
    if (sidx.shards, sidx.shard_rows) != (SHARDS, CAPACITY // SHARDS):
        fail(f"sharded index: {sidx.shards} shards of {sidx.shard_rows} rows")
    dp = TorchEncoder(BGE_BASE, max_batch=DOC_BATCH, seed=SEED, mesh=mesh)
    # set-up: phase 3's seeded bulk rows, copied on the card into the same slots
    n_bulk = CAPACITY - N_DOCS - 1024
    whole = index._vectors
    for lo in range(0, n_bulk, 65536):
        n = min(65536, n_bulk - lo)
        sidx.add_batch_device(range(lo, lo + n), whole[lo : lo + n])
    dp.encode(docs[:8])  # first-call set-up, untimed
    torch.cuda.synchronize()

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    n = dp.encode_into(sidx, keys, docs)
    torch.cuda.synchronize()
    res["dp_embed_docs_per_s"] = n / (time.perf_counter() - t0)
    ingest = kernels.launch_counts()
    res["ingest"] = {name: ingest[name] for name in ("pool_normalize", "slab_scatter", "pool_normalize_into")}
    if ingest["pool_normalize_into"] or not (ingest["pool_normalize"] and ingest["slab_scatter"]):
        fail(f"the sharded ingest must run K7 then K2 (not fused): {json.dumps(res['ingest'])}")
    if n != N_DOCS or len(sidx) != n_bulk + N_DOCS:
        fail(f"sharded index holds {len(sidx)} keys after {n} documents")
    sidx.remove(keys[-N_REMOVED:])
    lat: dict = {}
    for k in (K, SELECT_K):
        for nq, reps in ((1, 50), (32, 20)):
            times = []
            for r in range(reps):
                lo = (r * nq) % (DOC_BATCH - nq + 1)
                s0 = time.perf_counter()
                rows = sidx.search(q_all[lo : lo + nq], k)
                times.append((time.perf_counter() - s0) * 1e3)
                for i, row in enumerate(rows):
                    if len(row) != k or row[0][0] != keys[lo + i] or row[0][1] < SELF_COS:
                        fail(f"sharded search nq={nq} k={k}: query doc-{lo + i} came back as {row[:1]}")
            lat[f"nq{nq}_k{k}"] = {"p50_ms": float(np.percentile(times, 50)),
                                   "p99_ms": float(np.percentile(times, 99))}
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    res["launches"] = launches
    res["search"] = lat
    log(f"sharded corpus ({SHARDS} shards on {dev}): {json.dumps(res)}")
    path = ("knn_topk", "topk_select", "slab_scatter", "slab_clear", "attention", "bias_act",
            "add_layer_norm", "embed_ln", "pool_normalize")
    zero = [name for name in path if launches[name] == 0]
    if zero:
        fail(f"kernels not launched on the sharded path: {zero}")

    # (a) the data-parallel embeddings against the single-device ones: the
    # same kernels over parts of the same chunks, so each component within
    # one bf16 ulp of its single-device value (a cosine gate alone would
    # pass a wrong pad mask or a misplaced row among near-duplicates)
    emb = dp.encode(docs[:DOC_BATCH])
    cos = (emb * q_all).sum(1) / np.linalg.norm(emb, axis=1) / np.linalg.norm(q_all, axis=1)
    diff = np.abs(emb - q_all)
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(q_all), 2.0**-126))) - 7)
    res["dp_vs_single"] = {"min_cos": float(cos.min()), "max_abs_err": float(diff.max()),
                           "n_differ": int((diff > 0).sum()), "max_bf16_ulps": float((diff / ulp).max())}
    if not (np.isfinite(emb).all() and (diff <= ulp).all() and cos.min() >= EMBED_COS):
        fail(f"data-parallel embeddings against the single-device ones: {res['dp_vs_single']}")
    # (b) the same rows: the documents upserted from phase 3's slab, then
    # the sharded index's answers against the unsharded one's
    kept = [key for key in keys if key in index]
    slots = torch.tensor([index._slot_of[key] for key in kept], device=dev)
    sidx.add_batch_device(kept, whole[slots])
    sidx.remove([key for key in keys if key not in index])
    err = 0.0
    for nq in (1, 32):
        for k in (K, SELECT_K):
            qs = q_all[:nq]
            err = max(err, compare_rows(sidx.search(qs, k), index.search(qs, k), k, SHARD_ATOL,
                                        f"sharded vs unsharded nq={nq} k={k}"))
    # (c) K3 on each shard with its offset, gathered and merged, against K3
    # over the whole slab
    q = normalize(torch.from_numpy(q_all[:32]).to(dev))
    flat, flags = sidx._vectors, sidx._valid
    for k in (K, SELECT_K):
        kk = min(k, sidx.shard_rows)
        parts = [knn_topk(q, sidx._vecs[s], sidx._flags[s], kk, "dot", offset=s * sidx.shard_rows)
                 for s in range(SHARDS)]
        mv, mi = merge_partials(torch.cat([p[0] for p in parts], 1), torch.cat([p[1] for p in parts], 1),
                                k, presorted=False)
        wv, wi = knn_topk(q, flat, flags, k, "dot")
        err = max(err, compare_topk(mv, mi, wv, wi, SHARD_ATOL))
    del flat, flags
    res["vs_unsharded_max_abs_err"] = err

    # B12's device program at nq=1, k=10: K3 on each shard with its offset
    # and the merge, beside the same through the plain versions
    def b12(q1, topk, merge):
        parts = [topk(q1, sidx._vecs[s], sidx._flags[s], K, "dot", offset=s * sidx.shard_rows)
                 for s in range(SHARDS)]
        return merge(torch.cat([p[0] for p in parts], 1), torch.cat([p[1] for p in parts], 1))

    q1 = q[:1]
    res["b12_nq1_k10"] = {
        "ms": time_ms(torch, lambda: b12(q1, knn_topk, lambda v, i: merge_partials(v, i, K, presorted=False)), 20),
        "plain_ms": time_ms(torch, lambda: b12(q1, knn_topk_plain, lambda v, i: topk_select_plain(v, K, i)), 5),
    }
    log(f"B12 per-shard K3 + merge, nq=1 k={K}: {json.dumps(res['b12_nq1_k10'])}")
    # where one question's time goes, sharded and not: nq=1, k=10; and a
    # batch at k=256 (K3's score-only pass and twelve K13 launches per
    # shard, then the K13 merge), three times each, for its spread
    res["query_profile"] = profile_call(torch, lambda: sidx.search(q_all[:1], K), 1)
    res["unsharded_query_profile"] = profile_call(torch, lambda: index.search(q_all[:1], K), 1)
    log(f"sharded search profile (nq=1): {json.dumps(res['query_profile'])}; "
        f"unsharded: {json.dumps(res['unsharded_query_profile'])}")
    for name, idx in (("batch_k256_profiles", sidx), ("unsharded_batch_k256_profiles", index)):
        res[name] = [profile_call(torch, lambda: idx.search(q_all[:32], SELECT_K), 32) for _ in range(3)]
        log(f"{name} (nq=32, k={SELECT_K}): {json.dumps(res[name])}")
    res["wall_s"] = time.perf_counter() - t_phase
    log(f"sharded gates: dp vs single {json.dumps(res['dp_vs_single'])}, vs unsharded max err {err:.3e}, "
        f"wall {res['wall_s']:.1f} s")
    return res


def smoke_vocab() -> list[str]:
    """A BERT-layout vocabulary for the synthetic documents: [PAD] 0,
    [unused*], [UNK] 100, [CLS] 101, [SEP] 102, [MASK] 103, the words w0 to
    w29999 and the pieces ##0 to ##9 (higher word numbers split)."""
    vocab = ["[PAD]"] + [f"[unused{i}]" for i in range(99)] + ["[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    return vocab + [f"w{i}" for i in range(30_000)] + [f"##{d}" for d in range(10)]


def write_checkpoint(np, root: str, cross: bool, seed: int) -> dict:
    """A BGE-base-width BERT checkpoint directory, as ``save_pretrained``
    lays one out: ``config.json``, ``vocab.txt`` and ``model.safetensors``
    (written by the port's own writer) with seeded random weights; the
    cross-encoder's under ``bert.`` with a one-label ``classifier``.
    Returns the arrays by name."""
    from pathway_tpu_torch.models.convert import save_safetensors

    vocab = smoke_vocab()
    with open(os.path.join(root, "vocab.txt"), "w") as f:
        f.write("\n".join(vocab))
    config = {
        "architectures": ["BertForSequenceClassification" if cross else "BertModel"],
        "model_type": "bert", "_name_or_path": "bge-reranker-base-smoke" if cross else "bge-base-smoke",
        "vocab_size": len(vocab), "hidden_size": HIDDEN, "num_hidden_layers": 12,
        "num_attention_heads": 12, "intermediate_size": 4 * HIDDEN, "max_position_embeddings": 512,
        "type_vocab_size": 2, "hidden_act": "gelu", "layer_norm_eps": 1e-12,
    }
    if cross:
        config.update(id2label={"0": "LABEL_0"}, label2id={"LABEL_0": 0})
    with open(os.path.join(root, "config.json"), "w") as f:
        json.dump(config, f)
    rng = np.random.default_rng(seed)
    pre = "bert." if cross else ""

    def normal(*shape, mean=0.0):
        return (rng.standard_normal(shape, dtype=np.float32) * 0.02 + mean).astype(np.float32)

    arrays = {f"{pre}embeddings.word_embeddings.weight": normal(len(vocab), HIDDEN),
              f"{pre}embeddings.position_embeddings.weight": normal(512, HIDDEN),
              f"{pre}embeddings.token_type_embeddings.weight": normal(2, HIDDEN)}

    def ln(name):
        arrays[f"{name}.weight"] = normal(HIDDEN, mean=1.0)
        arrays[f"{name}.bias"] = normal(HIDDEN)

    def linear(name, n_out, n_in):
        arrays[f"{name}.weight"] = normal(n_out, n_in)
        arrays[f"{name}.bias"] = normal(n_out)

    ln(f"{pre}embeddings.LayerNorm")
    for i in range(12):
        p = f"{pre}encoder.layer.{i}"
        for name in ("query", "key", "value"):
            linear(f"{p}.attention.self.{name}", HIDDEN, HIDDEN)
        linear(f"{p}.attention.output.dense", HIDDEN, HIDDEN)
        ln(f"{p}.attention.output.LayerNorm")
        linear(f"{p}.intermediate.dense", 4 * HIDDEN, HIDDEN)
        linear(f"{p}.output.dense", HIDDEN, 4 * HIDDEN)
        ln(f"{p}.output.LayerNorm")
    linear(f"{pre}pooler.dense", HIDDEN, HIDDEN)
    if cross:
        linear("classifier", 1, HIDDEN)
    save_safetensors(os.path.join(root, "model.safetensors"), arrays)
    return arrays


def phase_checkpoint(torch, dev, compared_widths: set) -> dict:
    """Phase 9: BGE-base-width checkpoint directories written here from the
    seed, loaded on the card by ``TorchEncoderEmbedder(model=dir)`` and
    ``CrossEncoderReranker(dir)``; their outputs against the plain forward
    of the same weights."""
    import tempfile

    import numpy as np

    from pathway_tpu_torch import CrossEncoderReranker, TorchEncoderEmbedder, kernels
    from pathway_tpu_torch.models import WordPieceTokenizer

    res: dict = {}
    t_phase = time.perf_counter()
    docs = synthetic_docs(np, DOC_BATCH, SEED + 9)
    questions = synthetic_questions(np, docs, DOC_BATCH, SEED + 10)
    widths: set = set()
    with tempfile.TemporaryDirectory() as root:
        bi_dir, cross_dir = os.path.join(root, "bi"), os.path.join(root, "cross")
        os.mkdir(bi_dir)
        os.mkdir(cross_dir)
        bi = write_checkpoint(np, bi_dir, False, SEED + 11)
        cross = write_checkpoint(np, cross_dir, True, SEED + 12)
        res["write_s"] = time.perf_counter() - t_phase
        t0 = time.perf_counter()
        emb = TorchEncoderEmbedder(bi_dir, max_batch_size=DOC_BATCH, device=dev)
        rer = CrossEncoderReranker(cross_dir, max_batch_size=RERANK_BATCH, device=dev)
        torch.cuda.synchronize()
        res["load_s"] = time.perf_counter() - t0
    for name, enc, arrays, pre in (("embedder", emb.encoder, bi, ""), ("reranker", rer.encoder, cross, "bert.")):
        cfg = enc.config
        if (cfg.hidden, cfg.layers, cfg.mlp_dim, cfg.pool) != (HIDDEN, 12, 4 * HIDDEN, "cls"):
            fail(f"{name}: config {cfg} is not BGE-base's shape with CLS pooling")
        if not isinstance(enc.tokenizer, WordPieceTokenizer):
            fail(f"{name}: the checkpoint's vocab.txt did not give a WordPiece tokenizer")
        state = enc.model.state_dict()
        for ours, theirs in (("embeddings.word.weight", "embeddings.word_embeddings.weight"),
                             ("layer_11.attention.query.bias", "encoder.layer.11.attention.self.query.bias"),
                             ("layer_7.mlp_down.weight", "encoder.layer.7.output.dense.weight")):
            if not np.array_equal(state[ours].cpu().numpy(), arrays[pre + theirs]):
                fail(f"{name}: {ours} is not the checkpoint's {pre + theirs}")
    if not np.array_equal(rer.encoder.model.classifier.bias.detach().cpu().numpy(), cross["classifier.bias"]):
        fail("reranker: the classifier is not the checkpoint's")

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    got = np.stack(emb.__batch__(docs))
    t1 = time.perf_counter()
    pairs = [{"text": d} for d in docs]
    scores = np.asarray(rer.__batch__(pairs, questions), np.float32)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    res["launches"] = kernels.launch_counts()
    res["embed_docs_per_s"] = len(docs) / (t1 - t0)
    res["rerank_pairs_per_s"] = len(docs) / (t2 - t1)
    zero = [n for n in ("attention", "bias_act", "add_layer_norm", "embed_ln", "pool_normalize")
            if res["launches"][n] == 0]
    if zero:
        fail(f"kernels not launched on the checkpoint path: {zero}")

    # the plain forward of the same loaded weights on the same batches
    enc = emb.encoder
    ref = []
    for i in range(0, len(docs), DOC_BATCH):
        batch = enc.tokenizer.encode_batch(docs[i : i + DOC_BATCH], max_len=enc.max_len)
        widths.add(batch[0].shape[1])
        (args,), n = enc._upload_parts(*batch)
        with torch.inference_mode():
            ref.append(plain_forward(enc.model, *args)[:n].float().cpu().numpy())
    ref = np.concatenate(ref)
    cos = (got * ref).sum(1) / np.linalg.norm(got, axis=1) / np.linalg.norm(ref, axis=1)
    emb_err = float(np.abs(got - ref).max())
    cross_enc = rer.encoder
    plain = []
    for i in range(0, len(docs), RERANK_BATCH):
        batch = cross_enc.tokenizer.encode_batch(questions[i : i + RERANK_BATCH], pair=docs[i : i + RERANK_BATCH],
                                                 max_len=cross_enc.max_len)
        widths.add(batch[0].shape[1])
        (args,), n = cross_enc._upload_parts(*batch)
        with torch.inference_mode():
            plain.append(plain_forward(cross_enc.model, *args)[:n].float().cpu().numpy())
    score_err = float(np.abs(scores - np.concatenate(plain)).max())
    res["embed_vs_plain"] = {"min_cos": float(cos.min()), "max_abs_err": emb_err}
    res["score_vs_plain_max_abs_err"] = score_err
    res["attention_widths"] = sorted(widths)
    res["wall_s"] = time.perf_counter() - t_phase
    log(f"checkpoint path: {json.dumps(res)}")
    if not (np.isfinite(got).all() and cos.min() >= EMBED_COS and emb_err <= EMBED_ATOL):
        fail(f"checkpoint embeddings against the plain forward: cosine {cos.min()}, err {emb_err}")
    if not (np.isfinite(scores).all() and score_err <= SCORE_ATOL):
        fail(f"checkpoint rerank scores against the plain forward: err {score_err}")
    if not widths <= compared_widths:
        fail(f"checkpoint path widths {sorted(widths)} outside the shapes phase 2 compared")
    return res


def phase_parallel(torch, dev, ctx: dict, pairs: tuple) -> dict:
    """Phase 10: sequence and tensor parallelism at BGE-base width (768 x
    12 layers, 12 heads, bf16) on meshes that repeat the card, and the
    flagship tiny f32 config end to end (C5).  ``ctx`` is phase 3's;
    ``pairs`` phase 4's (questions, passages)."""
    import numpy as np

    from pathway_tpu_torch import (
        BGE_BASE, BGE_RERANKER_BASE, ShardedKnnIndex, TextEncoderModel, TorchEncoder, kernels, make_mesh,
    )

    res: dict = {"launches": {}}
    t_phase = time.perf_counter()
    docs, keys = ctx["docs"][:SP_DOCS], ctx["keys"][:SP_DOCS]
    single = ctx["embedder"].encoder
    mesh4 = make_mesh({"data": SEQ_SHARDS}, [dev] * SEQ_SHARDS)

    def gap(a, b) -> dict:
        cos = (a * b).sum(1) / np.linalg.norm(a, axis=1) / np.linalg.norm(b, axis=1)
        return {"max_abs_err": float(np.abs(a - b).max()), "min_cos": float(cos.min())}

    def counted(path: str, fn):
        """``fn()`` with every launch count at 0 before it, read after it
        (and added to the path's earlier runs)."""
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        got, prev = kernels.launch_counts(), res["launches"].get(path)
        res["launches"][path] = got if prev is None else {k: prev[k] + n for k, n in got.items()}
        return out

    # ---- (a) SP at the preset's length: 1,024 documents padded to 512,
    # blocks of 128, against phase 3's single-device (K1) encoder on the same
    # weights (the same seed) and against the f32 forward of those weights
    sp = TorchEncoder(BGE_BASE, max_batch=DOC_BATCH, seed=SEED, mesh=mesh4, sequence_axis="data")
    sp.encode(docs[:8])  # first-call set-up, untimed
    emb_1 = single.encode(docs)
    t0 = time.perf_counter()
    emb_sp = counted("sp", lambda: sp.encode(docs))
    res["sp_docs_per_s"] = len(docs) / (time.perf_counter() - t0)
    model32 = TextEncoderModel(dataclasses.replace(single.config, dtype=torch.float32), device=dev)
    model32.load_state_dict(single.model.state_dict())
    ref32 = []
    for i in range(0, len(docs), DOC_BATCH):
        (args,), n = single._upload_parts(*single.tokenizer.encode_batch(docs[i : i + DOC_BATCH],
                                                                           max_len=single.max_len))
        with torch.inference_mode():
            ref32.append(plain_forward(model32, *args)[:n].cpu().numpy())
    del model32
    ref32 = np.concatenate(ref32)
    res["sp_vs_single"] = gap(emb_sp, emb_1)
    res["sp_vs_f32"], res["single_vs_f32"] = gap(emb_sp, ref32), gap(emb_1, ref32)
    log(f"SP at L=512 over {SEQ_SHARDS} blocks: {res['sp_docs_per_s']:.1f} docs/s, vs single "
        f"{json.dumps(res['sp_vs_single'])}, vs f32 {json.dumps(res['sp_vs_f32'])} (single "
        f"{json.dumps(res['single_vs_f32'])})")
    if not (np.isfinite(emb_sp).all() and res["sp_vs_single"]["max_abs_err"] <= SP_ATOL):
        fail(f"SP embeddings against the single-device encoder: {res['sp_vs_single']} (tol {SP_ATOL})")
    if not res["sp_vs_f32"]["max_abs_err"] <= F32_RATIO * res["single_vs_f32"]["max_abs_err"]:
        fail(f"SP embeddings further from the f32 forward than {F32_RATIO}x the single-device path")
    del sp

    # ---- (b) long documents: max_len 8,192 over 4 blocks of 2,048, against
    # a 1-device sequence axis (K14 in one step over 8,192 keys) and the
    # plain forward (ring_attention_plain and the plain kernels)
    cfg_long = dataclasses.replace(BGE_BASE, max_len=LONG_LEN)
    enc4 = TorchEncoder(cfg_long, max_batch=16, seed=SEED, mesh=mesh4, sequence_axis="data")
    enc1 = TorchEncoder(cfg_long, max_batch=16, seed=SEED, mesh=make_mesh({"data": 1}, [dev]),
                        sequence_axis="data")
    rng = np.random.default_rng(SEED + 5)
    long_docs = [" ".join(f"w{w}" for w in rng.integers(0, 50_000, LONG_LEN + 100)) for _ in range(LONG_DOCS)]
    long_keys = [f"long-{i}" for i in range(LONG_DOCS)]
    ids, mask, types = enc4.tokenizer.encode_batch(long_docs, max_len=LONG_LEN)
    if ids.shape != (LONG_DOCS, LONG_LEN) or not mask.all():
        fail(f"long documents tokenized to {ids.shape}, {int(mask.sum())} tokens")
    lb = LONG_LEN // SEQ_SHARDS
    edge = np.zeros((7, LONG_LEN), np.int32)  # tests/test_tpu_plane.py's edge rows, at blocks of 2,048
    edge[0, : lb - 1] = 1
    edge[1, :lb] = 1
    edge[2, : lb + 1] = 1
    edge[3, : LONG_LEN - 1] = 1
    edge[4, 2 * lb : 3 * lb] = 1  # valid tokens only inside block 2
    edge[5, :1] = 1
    # edge[6] stays all zero: the fully masked row
    masked_row = LONG_DOCS + 6
    batch = [np.concatenate([a, b]) for a, b in (
        (ids, rng.integers(1000, cfg_long.vocab_size, edge.shape)), (mask, edge), (types, np.zeros_like(edge)))]
    args = [torch.from_numpy(a.astype(np.int32)).to(dev) for a in batch]
    with torch.inference_mode():
        enc4.model(*args)  # first-call set-up
        outs, peaks, secs = {}, {}, {}
        for name, enc in (("4way", enc4), ("1way", enc1)):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            outs[name] = (counted("sp_long", lambda: enc.model(*args)) if name == "4way"
                          else enc.model(*args)).cpu().numpy()
            secs[name] = time.perf_counter() - t0
            peaks[name] = torch.cuda.max_memory_allocated() / 1e9
        plain = plain_forward(enc4.model, *args).cpu().numpy()
    torch.cuda.empty_cache()
    valid = int(batch[1].sum())
    res["long"] = {
        "rows": int(batch[0].shape[0]), "len": LONG_LEN, "valid_tokens": valid,
        "tokens_per_s": {k: valid / v for k, v in secs.items()},
        "peak_mem_gb": peaks,
        "4way_vs_1way": gap(outs["4way"], outs["1way"]),
        "4way_vs_plain": gap(outs["4way"], plain), "1way_vs_plain": gap(outs["1way"], plain),
        "masked_row_vs_plain": gap(outs["4way"][masked_row : masked_row + 1], plain[masked_row : masked_row + 1]),
    }
    for name, o in (*outs.items(), ("plain", plain)):
        if not np.isfinite(o).all():
            fail(f"long documents: non-finite embeddings on the {name} path")
    for what in ("4way_vs_1way", "4way_vs_plain", "1way_vs_plain", "masked_row_vs_plain"):
        g = res["long"][what]
        if not (g["max_abs_err"] <= EMBED_ATOL and g["min_cos"] >= EMBED_COS):
            fail(f"long documents {what}: {g} (tol {EMBED_ATOL}, cosine {EMBED_COS})")
    # encode_into: the 4-way embeddings in an index answer as the 1-way ones do
    idx4 = ShardedKnnIndex(HIDDEN, metric="cos", capacity=1024, device=dev)
    idx1 = ShardedKnnIndex(HIDDEN, metric="cos", capacity=1024, device=dev)
    t0 = time.perf_counter()
    enc4.encode_into(idx4, long_keys, long_docs)
    torch.cuda.synchronize()
    res["long"]["encode_into_tokens_per_s"] = LONG_DOCS * LONG_LEN / (time.perf_counter() - t0)
    enc1.encode_into(idx1, long_keys, long_docs)
    q1 = enc1.encode(long_docs)
    res["long"]["search_max_abs_err"] = compare_rows(idx4.search(q1, LONG_DOCS), idx1.search(q1, LONG_DOCS),
                                                     LONG_DOCS, EMBED_ATOL, "long-document search, 4-way vs 1-way")
    res["long"]["profile"] = profile_call(torch, lambda: enc4.encode(long_docs), LONG_DOCS)
    log(f"long documents: {json.dumps(res['long'])}")
    del enc4, enc1, idx4, idx1, args, plain, outs
    torch.cuda.empty_cache()

    # ---- (c) TP: heads and MLP width over "model", one group per data
    # replica.  On the first seed, embeddings and phase 4's pair scores
    # within TP_ATOL of one device; on every seed of TP_SEEDS, the scores
    # no further, on average, from the f32 forward of the same weights than
    # F32_RATIO times one device's, with the control (f32 partial products
    # summed, rounded once) read beside them on the 1 x 2 mesh and on one
    # device.  The card's bytes per encoder: each shard once, no full copy
    pair_qs, pair_docs = pairs
    meshes = {"data1_model2": make_mesh({"data": 1, "model": 2}, [dev] * 2),
              "data2_model2": make_mesh({"data": 2, "model": 2}, [dev] * 4)}

    def built(make):
        """``make()`` and the bytes it leaves allocated on the card (a
        model's grid holds the model itself: the encoders dropped before
        go with the garbage collector)."""
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        obj = make()
        torch.cuda.synchronize()
        return obj, torch.cuda.memory_allocated() - base

    def cross_scores(seed, **where):
        return TorchEncoder(BGE_RERANKER_BASE, cross=True, max_batch=RERANK_BATCH, seed=seed,
                            **where).score_pairs(pair_qs, pair_docs)

    res["tp"] = {"seeds": {}}
    for seed in TP_SEEDS:
        scores_32 = TorchEncoder(dataclasses.replace(BGE_RERANKER_BASE, dtype=torch.float32), cross=True,
                                 max_batch=RERANK_BATCH, seed=seed, device=dev).score_pairs(pair_qs, pair_docs)
        cross1, one_bytes = built(lambda: TorchEncoder(
            BGE_RERANKER_BASE, cross=True, max_batch=RERANK_BATCH, seed=seed, device=dev))
        scores_1 = cross1.score_pairs(pair_qs, pair_docs)
        with f32_partial_sums():
            control_1 = cross1.score_pairs(pair_qs, pair_docs)
        del cross1

        def vs(scores) -> dict:
            return {"vs_one_device_max": float(np.abs(scores - scores_1).max()),
                    "vs_f32_mean": float(np.abs(scores - scores_32).mean()),
                    "vs_f32_max": float(np.abs(scores - scores_32).max())}

        row = {"max_abs_score": float(np.abs(scores_1).max()), "one_device": vs(scores_1),
               "one_device_weights_gb": one_bytes / 1e9, "control_one_device": vs(control_1)}
        for name, mesh in meshes.items():
            cross, weights = built(lambda: TorchEncoder(
                BGE_RERANKER_BASE, cross=True, max_batch=RERANK_BATCH, seed=seed, mesh=mesh))
            enc = TorchEncoder(BGE_BASE, max_batch=DOC_BATCH, seed=SEED, mesh=mesh) if seed == SEED else None
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            if enc is not None:
                emb, scores = counted("tp", lambda: (enc.encode(docs), cross.score_pairs(pair_qs, pair_docs)))
                del enc
                row[f"{name}_embed_vs_one_device"] = g = gap(emb, emb_1)
                if not (np.isfinite(emb).all() and g["max_abs_err"] <= TP_ATOL):
                    fail(f"TP {name} embeddings against one device: {g} (tol {TP_ATOL})")
            else:
                scores = cross.score_pairs(pair_qs, pair_docs)
            row[name] = r = {**vs(scores), "weights_gb": weights / 1e9,
                             "peak_gb": (torch.cuda.max_memory_allocated() - base) / 1e9}
            if name == "data1_model2":
                with f32_partial_sums():
                    row["control_" + name] = vs(cross.score_pairs(pair_qs, pair_docs))
            del cross
            if not np.isfinite(scores).all():
                fail(f"TP {name}: non-finite pair scores on seed {seed}")
            if seed == SEED and not r["vs_one_device_max"] <= TP_ATOL:
                fail(f"TP {name} pair scores against one device: {r} (tol {TP_ATOL})")
            if not r["vs_f32_mean"] <= F32_RATIO * row["one_device"]["vs_f32_mean"]:
                fail(f"TP {name} pair scores on seed {seed} further from the f32 forward than "
                     f"{F32_RATIO}x one device: {r}, one device {row['one_device']}")
            if weights > TP_WEIGHTS_RATIO * one_bytes:
                fail(f"TP {name}: {weights / 1e9} GB of weights on the card against {one_bytes / 1e9} GB "
                     "for one device: a full copy beside the shards")
        res["tp"]["seeds"][seed] = row
        log(f"TP, seed {seed}: {json.dumps(row)}")
    res["tp"]["pairs"] = len(pair_qs)

    # ---- (d) C5 end to end: the flagship tiny f32 config (2 layers, hidden
    # 64, 4 heads of 16) through the 4-way sequence axis (K14) and on one
    # device (K1), each against its plain forward
    tiny = dataclasses.replace(BGE_BASE, layers=2, hidden=64, heads=4, mlp_dim=128, dtype=torch.float32,
                               max_len=64)
    tiny_sp = TorchEncoder(tiny, max_batch=64, seed=SEED, mesh=mesh4, sequence_axis="data")
    tiny_1 = TorchEncoder(tiny, max_batch=64, seed=SEED, device=dev)
    texts = ctx["docs"][:128]
    e_sp, e_1 = counted("f32", lambda: (tiny_sp.encode(texts), tiny_1.encode(texts)))
    res["f32"] = {}
    for name, enc, got in (("sp", tiny_sp, e_sp), ("one_device", tiny_1, e_1)):
        ref = []
        for i in range(0, len(texts), enc.max_batch):
            (args,), n = enc._upload_parts(*enc.tokenizer.encode_batch(texts[i : i + enc.max_batch],
                                                                       max_len=enc.max_len))
            with torch.inference_mode():
                ref.append(plain_forward(enc.model, *args)[:n].cpu().numpy())
        err = float(np.abs(got - np.concatenate(ref)).max())
        res["f32"][name] = err
        if not (np.isfinite(got).all() and err <= F32_ATOL):
            fail(f"f32 tiny config ({name}) against its plain forward: {err} > {F32_ATOL}")
    log(f"C5, the f32 tiny config against its plain forward: {json.dumps(res['f32'])}")

    for path, kernels_run in (("sp", ("ring_block", "bias_act", "add_layer_norm", "embed_ln", "pool_normalize")),
                              ("sp_long", ("ring_block", "bias_act", "add_layer_norm", "embed_ln", "pool_normalize")),
                              ("tp", ("attention", "bias_act", "add_layer_norm", "embed_ln", "pool_normalize")),
                              ("f32", ("attention", "ring_block", "bias_act", "add_layer_norm", "embed_ln",
                                       "pool_normalize"))):
        zero = [name for name in kernels_run if res["launches"][path][name] == 0]
        if zero:
            fail(f"kernels not launched on the {path} path: {zero}")
    if res["launches"]["sp"]["attention"] or res["launches"]["sp_long"]["attention"]:
        fail("K1 launched on a sequence-parallel path: its attention is K14's")
    res["wall_s"] = time.perf_counter() - t_phase
    log(f"phase 10 wall {res['wall_s']:.1f} s")
    return res


def profile_cards(torch, fn, cards: list) -> dict:
    """One call of ``fn`` on several ``cards``, traced: the host's time to
    enqueue it, the wall time to its end, and for each card the device
    time by kernel, its busy time and the span from the call's start to
    its last event."""
    from torch.profiler import ProfilerActivity, profile, record_function

    for c in cards:
        torch.cuda.synchronize(c)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("profile_cards"):
            t0 = time.perf_counter()
            fn()
            enqueue = time.perf_counter() - t0
            for c in cards:
                torch.cuda.synchronize(c)
            wall = time.perf_counter() - t0
    events = prof.events()
    on_device = [e for e in events if str(getattr(e, "device_type", "")).endswith("CUDA")]
    call = next(e for e in events if e.name == "profile_cards" and e not in on_device)
    start = call.time_range.start
    per_card: dict = {}
    for e in on_device:
        if e.name == "profile_cards" or e.time_range.start < start:
            continue
        card = per_card.setdefault(e.device_index, {"busy_ms": 0.0, "end_ms": 0.0, "by_kernel": {}})
        ms = e.time_range.elapsed_us() / 1e3
        card["busy_ms"] += ms
        card["end_ms"] = max(card["end_ms"], (e.time_range.end - start) / 1e3)
        name = e.name[:60]
        card["by_kernel"][name] = card["by_kernel"].get(name, 0.0) + ms
    for card in per_card.values():
        card["by_kernel"] = dict(sorted(card["by_kernel"].items(), key=lambda kv: -kv[1])[:6])
    return {"enqueue_ms": enqueue * 1e3, "wall_ms": wall * 1e3, "cards": per_card}


def phase_distinct_cards(torch, cards: list) -> dict:
    """``--distinct-cards``, on four ``cards``: what a mesh that repeats one
    card cannot show.  The ring over four distinct cards (K/V blocks
    handed on by copies between cards) against the same ring on a mesh
    that repeats card 0; the sequence-parallel BGE-base encoder at 8,192
    tokens over four cards against the same encoder on the repeated card;
    tensor parallelism (``{"data": 1, "model": 2}`` over two cards,
    ``{"data": 2, "model": 2}`` over four) against the repeated card, and
    each card's bytes.  The same kernels run on the same blocks in the
    same order, so the outputs are expected equal to the bit."""
    import numpy as np

    from pathway_tpu_torch import BGE_BASE, BGE_RERANKER_BASE, TorchEncoder, make_mesh
    from pathway_tpu_torch.ops.ring_attention import ring_attention

    res: dict = {}

    def sync_all() -> None:
        for c in cards:
            torch.cuda.synchronize(c)

    def timed(fn, iters: int = 3):
        """(``fn()``, mean seconds of ``iters`` more calls, all cards synced)."""
        out = fn()
        sync_all()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        sync_all()
        return out, (time.perf_counter() - t0) / iters

    # ---- the ring alone: B=8, L=8,192, BGE-base's heads, bf16
    g = torch.Generator(device=cards[0]).manual_seed(SEED + 11)
    B, L, H, D = RING_B, LONG_LEN, RING_H, RING_D
    q, k, v = (torch.randn((B, L, H, D), generator=g, device=cards[0]).bfloat16() for _ in range(3))
    lens = torch.randint(1, L + 1, (B,), generator=g, device=cards[0])
    mask = (torch.arange(L, device=cards[0])[None] < lens[:, None]).to(torch.uint8)
    mask[B - 1] = 0  # no valid key anywhere
    apart, t_apart = timed(lambda: ring_attention(q, k, v, mask, mesh=make_mesh({"data": 4}, cards)))
    same, t_same = timed(lambda: ring_attention(q, k, v, mask, mesh=make_mesh({"data": 4}, [cards[0]] * 4)))
    err = (apart.float() - same.float()).abs().max().item()
    # the ring alone, its blocks already on their cards (the list form),
    # and the copy it makes each step: one K block from card 0 to card 1
    blocks = [[c.to(d).contiguous() for c, d in zip(t.chunk(4, dim=1), cards)] for t in (q, k, v, mask)]
    _, t_blocks = timed(lambda: ring_attention(*blocks, mesh=make_mesh({"data": 4}, cards)))
    ring_profile = profile_cards(torch, lambda: ring_attention(*blocks, mesh=make_mesh({"data": 4}, cards)),
                                 cards)
    kb = blocks[1][0]
    _, t_copy = timed(lambda: kb.to(cards[1]), 10)
    res["ring"] = {"shape": f"B={B} L={L} H={H} D={D} bf16 over 4 blocks", "max_abs_err": err,
                   "ms_four_cards": t_apart * 1e3, "ms_one_card": t_same * 1e3,
                   "ms_four_cards_blocks_in_place": t_blocks * 1e3,
                   "peer_access_0_1": torch.cuda.can_device_access_peer(cards[0], cards[1]),
                   "block_copy_ms": t_copy * 1e3,
                   "block_copy_gb_per_s": kb.numel() * kb.element_size() / t_copy / 1e9,
                   "profile_blocks_in_place": ring_profile}
    del blocks, kb
    log(f"ring over four cards: {json.dumps(res['ring'])}")
    if not (bool(torch.isfinite(apart.float()).all()) and err <= RING_ATOL * same.float().abs().max().item()):
        fail(f"ring attention over four cards against one card: {err}")
    del q, k, v, apart, same

    # ---- the sequence-parallel encoder at 8,192 tokens
    cfg_long = dataclasses.replace(BGE_BASE, max_len=LONG_LEN)
    rng = np.random.default_rng(SEED + 5)
    docs = [" ".join(f"w{w}" for w in rng.integers(0, 50_000, LONG_LEN + 100)) for _ in range(LONG_DOCS)]
    docs += [" ".join(["w"] * n) for n in (1, 2047, 2049, 5000)]
    embs, secs = {}, {}
    for name, devs in (("four_cards", cards), ("one_card", [cards[0]] * 4)):
        enc = TorchEncoder(cfg_long, max_batch=16, seed=SEED, mesh=make_mesh({"data": 4}, devs),
                           sequence_axis="data")
        embs[name], secs[name] = timed(lambda: enc.encode(docs), 2)
        del enc
        torch.cuda.empty_cache()
    e = float(np.abs(embs["four_cards"] - embs["one_card"]).max())
    res["sp_long"] = {"docs": len(docs), "max_abs_err": e,
                      "tokens_per_s": {n: len(docs) * LONG_LEN / t for n, t in secs.items()}}
    log(f"sequence-parallel encoder over four cards: {json.dumps(res['sp_long'])}")
    if not (np.isfinite(embs["four_cards"]).all() and e <= EMBED_ATOL):
        fail(f"SP encoder over four cards against one card: {e}")

    # ---- tensor parallelism: scores and each card's bytes
    rng = np.random.default_rng(SEED + 6)
    qs = [" ".join(f"q{w}" for w in rng.integers(0, 5000, 12)) for _ in range(256)]
    ds = [" ".join(f"w{w}" for w in rng.integers(0, 50_000, 300)) for _ in range(256)]
    one = TorchEncoder(BGE_RERANKER_BASE, cross=True, max_batch=RERANK_BATCH, seed=SEED, device=cards[0])
    one_bytes = sum(p.numel() * p.element_size() for p in one.model.parameters())
    del one
    res["tp"] = {"one_device_weights_gb": one_bytes / 1e9}
    for name, shape, devs in (("data1_model2", {"data": 1, "model": 2}, cards[:2]),
                              ("data2_model2", {"data": 2, "model": 2}, cards)):
        out = {}
        for where, mesh_devs in (("apart", devs), ("same", [cards[0]] * len(devs))):
            gc.collect()
            sync_all()
            torch.cuda.empty_cache()
            base = [torch.cuda.memory_allocated(c) for c in cards]
            cross = TorchEncoder(BGE_RERANKER_BASE, cross=True, max_batch=RERANK_BATCH, seed=SEED,
                                 mesh=make_mesh(shape, mesh_devs))
            sync_all()
            held = [(torch.cuda.memory_allocated(c) - b) / 1e9 for c, b in zip(cards, base)]
            for c in cards:
                torch.cuda.reset_peak_memory_stats(c)
            out[where], t = timed(lambda: cross.score_pairs(qs, ds), 2)
            peak = [(torch.cuda.max_memory_allocated(c) - b) / 1e9 for c, b in zip(cards, base)]
            if where == "apart":
                res["tp"][name] = {"weights_gb_per_card": held, "peak_gb_per_card": peak,
                                   "pairs_per_s": len(qs) / t}
            del cross
        err = float(np.abs(out["apart"] - out["same"]).max())
        res["tp"][name]["max_abs_err"] = err
        log(f"TP {name} over distinct cards: {json.dumps(res['tp'][name])}")
        most = max(res["tp"][name]["weights_gb_per_card"])
        if not (np.isfinite(out["apart"]).all() and err <= TP_ATOL and most < 0.75 * one_bytes / 1e9):
            fail(f"TP {name} over distinct cards: {res['tp'][name]} (one device holds {one_bytes / 1e9} GB)")
    res.update(phase_distinct_data(torch, cards, sync_all))
    return res


def phase_distinct_data(torch, cards: list, sync_all) -> dict:
    """``--distinct-cards``' data-parallel part: the sharded index (B12:
    K3 on each shard's card, the lists copied to the first card and
    merged), the data-parallel encoder's replicas and the data-parallel
    train step, each over ``{"data": 4}`` on four cards against the same
    mesh on card 0.  The index and the encoder run the same kernels on the
    same rows: equal to the bit.  The train step sums four replicas'
    gradients in order on the first card where one card's single replica
    adds them up in autograd's order: its parameters within 1e-6 (a key
    bias, whose exact gradient is 0, within 2 lr)."""
    import numpy as np

    from pathway_tpu_torch import BGE_BASE, TorchEncoder, make_mesh, train
    from pathway_tpu_torch.models import TextEncoderModel
    from pathway_tpu_torch.parallel import ShardedKnnIndex

    res: dict = {}
    meshes = {"apart": list(cards), "same": [cards[0]] * 4}
    rng = np.random.default_rng(SEED + 31)
    vecs = rng.standard_normal((8192, HIDDEN)).astype(np.float32)
    qv = vecs[:32] + 0.01 * rng.standard_normal((32, HIDDEN)).astype(np.float32)
    got = {}
    for where, devs in meshes.items():
        idx = ShardedKnnIndex(HIDDEN, metric="cos", capacity=1 << 18, mesh=make_mesh({"data": 4}, devs))
        idx.add_batch(list(range(len(vecs))), vecs)
        idx.remove(list(range(0, 64, 7)))
        got[where] = [idx.search(qv, K), idx.search(qv[:8], SELECT_K)]
        t0 = time.perf_counter()
        idx.search(qv, K)
        sync_all()
        got[where].append(time.perf_counter() - t0)
        del idx
    res["sharded_index"] = {"equal": got["apart"][:2] == got["same"][:2],
                            "search_s": {w: got[w][2] for w in got}}
    log(f"B12 over distinct cards: {json.dumps(res['sharded_index'])}")
    if not res["sharded_index"]["equal"]:
        fail("the sharded index over four cards answers otherwise than the same mesh on one card")

    texts = synthetic_docs(np, 512, SEED + 32)
    emb = {}
    for where, devs in meshes.items():
        enc = TorchEncoder(BGE_BASE, seed=SEED, mesh=make_mesh({"data": 4}, devs), max_batch=256)
        emb[where] = enc.encode(texts)
        sync_all()
        del enc
        torch.cuda.empty_cache()
    res["dp_encoder"] = {"max_abs_err": float(np.abs(emb["apart"] - emb["same"]).max()),
                         "equal": bool(np.array_equal(emb["apart"], emb["same"]))}
    log(f"DP encoder over distinct cards: {json.dumps(res['dp_encoder'])}")
    if not res["dp_encoder"]["equal"]:
        fail(f"the DP encoder over four cards differs from the same mesh on one card: {res['dp_encoder']}")

    cfg = dataclasses.replace(BGE_BASE, dtype=torch.float32)
    ids_np, mask_np = synthetic_pairs(np, 16, 64, cfg.vocab_size, SEED + 33)
    params, losses = {}, {}
    for where, devs in meshes.items():
        mesh = make_mesh({"data": 4}, devs)
        model = TextEncoderModel(cfg, device=devs[0], seed=SEED)
        opt = train.Adam(train.trainable(model, mesh), lr=TRAIN_LR)
        ids, mask = torch.from_numpy(ids_np).to(devs[0]), torch.from_numpy(mask_np).to(devs[0])
        losses[where] = float(train.train_step(model, opt, ids, mask, mesh))
        sync_all()
        params[where] = {n: p.detach().cpu() for n, p in model.named_parameters()}
        del model, opt
        torch.cuda.empty_cache()
    worst = 0.0
    for name, p in params["apart"].items():
        e = float((p - params["same"][name]).abs().max())
        bound = 2 * TRAIN_LR if name.endswith("attention.key.bias") else 1e-6
        if e > bound:
            fail(f"DP train step over distinct cards: {name} differs by {e} > {bound}")
        if not name.endswith("attention.key.bias"):
            worst = max(worst, e)
    res["dp_train"] = {"losses": losses, "param_max_abs_err": worst}
    log(f"DP train step over distinct cards: {json.dumps(res['dp_train'])}")
    if abs(losses["apart"] - losses["same"]) > 1e-6 * abs(losses["same"]):
        fail(f"DP train step losses over distinct cards: {losses}")
    return res


def parent_kernel_module(parent: str, name: str, imports: dict | None = None):
    """``kernels/<name>.py`` of the tree unpacked under ``parent``;
    ``imports`` maps this tree's kernel modules that it imports from to the
    parent's own copies."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        f"parent_{name}", os.path.join(parent, "pathway_tpu_torch", "kernels", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    saved = {key: sys.modules[key] for key in (imports or {})}
    sys.modules.update(imports or {})
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.modules.update(saved)
    return mod


def phase_against_parent(torch, dev, parent: str) -> dict:
    """``--against-parent DIR``: K14 (bf16 and f32), K3's row-streaming pass
    (nq 1 and 4, k=10), K1 (bf16 and f32 at B=256 L=256 D=64, the serving
    shape), K12 (nq 1 and 32 over a 1M-row IVF at phase 6's shape), K16
    (act none at [8,192, 768], GELU at [8,192, 3,072]), K15 (the train
    step's [64, 128, 12, 64] and [2, 512, 4, 128], a row of no present key
    in each), K19 (over copies of every BGE-base parameter), K17, K9, K7
    (CLS bf16, mean bf16 and f32 at B=256 L=256), K2 (scatter and clear at
    phase 2's shape), the ingest tail (CLS and mean, against the parent's
    K7 then K2), B8's head (bf16 at CROSS_HEAD_SHAPES, against the parent's
    five launches, ``head_chain``) and K18 (the train step's loss and d emb
    through autograd against the parent's six launches; its pool backward
    at [64, 128, 768] CLS) of this tree against
    the same kernels built from the sources under ``DIR`` (an unpacked
    ``git archive`` of another commit), on one card, timed in turns (parent,
    this tree, this tree, parent) by CUDA events and by the profiler's
    device time, beside the one PyTorch call that computes the same
    function.  The parent's side is the parent's own wrapper modules (their
    checks, allocations and launch helper, ``kernels/_launch.py``), this
    tree's its wrappers; a kernel whose sources are unchanged is one binary,
    launched both ways.  Both
    builds must pass phase 2's gates on the same inputs: K14 a middle step
    at B=8, 2,048 keys, 12 heads of 64 (state against the plain version's),
    K3 over 1,048,576 x 768 unit f32 rows with 10% invalid (TOPK_ATOL
    against the plain version), K1 at B=256 L=256 H=12 D=64 with 64-256
    present keys, K12 TOPK_ATOL against its plain version, K16 and K15
    BWD_RTOL, K19 the same bits as the parent's K19 for p, m and v after
    two steps, K17 BWD_RTOL and K9 HEAD_ATOL (K17's residual form at the
    train step's [8,192, 768], its embedding form at BGE-base's tables and
    random or all-ones ids, K9 at an image chunk; B8 phase 2's tolerance,
    K18 BWD_RTOL).  Gates: DEVICE_GATED
    rows (K12 at nq=1, K16 act none, K15, K19, K17, K9, K7, K2, B8, K18) by device time
    (``queued_ms``), the others (K1, K3, K14, K12 at
    nq=32, K16 GELU) by CUDA events; each row no slower than the parent
    where this tree runs code the parent does not (``"strict"``: a library
    rebuilt from changed sources, in the form the parent's wrapper also
    runs there or not), else within PARENT_RATIO.  Each side's
    ``ms_spread`` is the gap between its two event turns over their
    mean."""
    import types

    import torch.nn.functional as F

    from pathway_tpu_torch.kernels import (
        adam_step,
        attention,
        attention_bwd,
        attention_bwd_plain,
        attention_plain,
        bias_act_bwd,
        bias_act_bwd_plain,
        contrastive_loss_plain,
        cross_head,
        cross_head_plain,
        embed_ln_bwd,
        embed_ln_bwd_plain,
        ivf_scan,
        ivf_scan_plain,
        knn_topk,
        knn_topk_plain,
        layer_norm_bwd,
        layer_norm_bwd_plain,
        pool_normalize,
        pool_normalize_bwd,
        pool_normalize_bwd_plain,
        pool_normalize_into,
        pool_normalize_into_plain,
        pool_normalize_plain,
        ring_block,
        ring_block_plain,
        ring_state,
        slab_clear,
        slab_scatter,
        slab_scatter_plain,
        vision_head,
        vision_head_plain,
    )
    from pathway_tpu_torch.kernels import _build
    from pathway_tpu_torch.kernels.attention import bwd_form
    from pathway_tpu_torch.kernels.contrastive_loss import in_batch_loss

    def parent_module(name, imports=None):
        return parent_kernel_module(parent, name, imports)

    pb = parent_module("_build")
    # a kernel whose source and headers are unchanged since the parent is
    # the same binary (the same build name): the parent's side launches
    # this tree's build of it (a second copy of one library fails to
    # launch), through the parent's launch path
    names = ("ring_block", "knn_topk", "attention", "ivf_scan", "bias_act_bwd", "attention_bwd", "adam",
             "layer_norm_bwd", "vision_head", "pool_normalize", "slab_scatter", "bias_act", "contrastive_loss")
    same = [n for n in names if pb._target(n).name == _build._target(n).name]
    t0 = time.perf_counter()
    pb.build_all(tuple(n for n in names if n not in same))
    log(f"parent kernels built from {parent}: {time.perf_counter() - t0:.1f} s; unchanged, built once: {same}")
    builds = types.SimpleNamespace(library=lambda name: (_build if name in same else pb).library(name))
    parent_launch = parent_module("_launch").launch

    def parent_wrappers(module, imports=None):
        """The parent's wrapper module: its host path and checks, its
        launch helper, its kernels."""
        mod = parent_module(module, imports)
        mod._build, mod.launch = builds, parent_launch
        return mod

    p_knn_mod = parent_wrappers("knn_topk")
    p_scan_mod = parent_wrappers("ivf_scan")
    p_scan_mod.merge_partials = p_knn_mod.merge_partials
    parent_ring = parent_wrappers("ring_block").ring_block
    parent_knn = p_knn_mod.knn_topk
    p_attention_mod = parent_wrappers("attention")
    parent_attention = p_attention_mod.attention
    parent_attention_bwd = p_attention_mod.attention_bwd
    # a parent without K15's form choice runs the two-pass form at every shape
    parent_bwd_form = getattr(p_attention_mod, "bwd_form", lambda L, D: "two_pass")
    parent_adam = parent_wrappers("adam").adam_step
    parent_scan = p_scan_mod.ivf_scan
    p_bias_mod = parent_wrappers("bias_act")
    parent_bias_bwd = p_bias_mod.bias_act_bwd
    p_ln_mod = parent_wrappers("add_layer_norm")
    parent_ln_bwd = p_ln_mod.layer_norm_bwd
    parent_embed_bwd = parent_wrappers(
        "embed_ln", {"pathway_tpu_torch.kernels.add_layer_norm": p_ln_mod}).embed_ln_bwd
    parent_vision_head = parent_wrappers("vision_head").vision_head
    p_slab_mod = parent_wrappers("slab_scatter")
    parent_scatter, parent_clear = p_slab_mod.slab_scatter, p_slab_mod.slab_clear
    p_pool_mod = parent_wrappers("pool_normalize")
    parent_pool = p_pool_mod.pool_normalize
    p_loss_mod = parent_wrappers("contrastive_loss")

    def turns(parent_fn, fn, iters: int, lib: str, strict: bool | None = None) -> dict:
        """Events, queued and profiled device ms of both in turns: parent,
        tree, tree, parent; ``iters`` calls a turn, enough for about 5 ms
        or more of device time, so that one stall of the host moves a mean
        by little.  ``strict``: this tree runs code the parent does not
        (by default, when ``lib`` was rebuilt from changed sources)."""
        t = {"parent": [], "tree": []}
        for who in ("parent", "tree", "tree", "parent"):
            f = parent_fn if who == "parent" else fn
            t[who].append({"ms": time_ms(torch, f, iters), "queued_ms": queued_ms(torch, f, iters),
                           "device_ms": device_ms(torch, f, iters)})
        out = {who: {key: sum(r[key] for r in rs) / 2 for key in ("ms", "queued_ms", "device_ms")}
               | {"ms_spread": abs(rs[0]["ms"] - rs[1]["ms"]) * 2 / (rs[0]["ms"] + rs[1]["ms"]), "turns": rs}
               for who, rs in t.items()}
        return out | {"strict": lib not in same if strict is None else strict}

    def library(fn, iters: int) -> dict:
        return {"ms": time_ms(torch, fn, iters), "queued_ms": queued_ms(torch, fn, iters),
                "device_ms": device_ms(torch, fn, iters)}

    res: dict = {}
    g = torch.Generator(device=dev).manual_seed(SEED + 12)
    bf16, f32 = torch.bfloat16, torch.float32

    def lengths_mask(B, L, min_len=1):
        lens = torch.randint(min_len, L + 1, (B,), generator=g, device=dev)
        lens[0] = L
        return (torch.arange(L, device=dev)[None] < lens[:, None]).to(torch.uint8)

    # ---- K14: a middle step, from the state a plain first step left
    B, L, H, D = RING_B, RING_L, RING_H, RING_D
    for dt in (bf16, f32):
        tag = "bf16" if dt == bf16 else "f32"
        q, k0, v0, k1, v1 = (torch.randn((B, L, H, D), generator=g, device=dev).to(dt) for _ in range(5))
        m0, m1 = lengths_mask(B, L), lengths_mask(B, L)
        any_key = torch.maximum(m0, m1).amax(dim=1)
        st0 = ring_state(B, L, H, D, dev)
        ring_block_plain(q, k0, v0, m0, *st0)
        ref = [t.clone() for t in st0]
        ring_block_plain(q, k1, v1, m1, *ref)
        tol = F32_ATOL if dt == f32 else RING_STATE_RTOL
        err = {}
        for who, fn in (("parent", parent_ring), ("tree", ring_block)):
            st = [t.clone() for t in st0]
            fn(q, k1, v1, m1, *st, any_key=any_key)
            torch.cuda.synchronize()
            e, em = ring_state_err(st, ref)
            if not (e <= tol and em <= tol):
                fail(f"{who} ring_block {tag}: state err {e}, running max err {em} > {tol}")
            err[who] = e
        sp, st = [t.clone() for t in st0], [t.clone() for t in st0]
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k1, v1))
        bmask = m1.bool()[:, None, None, :]
        name = f"K14 {tag} B={B} Lb={L} H={H} D={D}"
        res[name] = {
            "state_err": err,
            **turns(lambda: parent_ring(q, k1, v1, m1, *sp, any_key=any_key),
                    lambda: ring_block(q, k1, v1, m1, *st, any_key=any_key), 20, "ring_block"),
            "library": library(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=bmask), 10),
        }
        log(f"{name}: {json.dumps(res[name])}")
        del q, k0, v0, k1, v1, st0, ref, sp, st, qt, kt, vt
        torch.cuda.empty_cache()

    # ---- K3's row-streaming pass at nq 1 and 4, k=10, over the 1M f32 slab
    slab = torch.randn((CAPACITY, HIDDEN), generator=g, device=dev)
    slab /= slab.norm(dim=1, keepdim=True)
    valid = (torch.rand((CAPACITY,), generator=g, device=dev) >= 0.1).float()
    qs = torch.randn((64, HIDDEN), generator=g, device=dev)
    qs /= qs.norm(dim=1, keepdim=True)
    cases = [(nq, K, slab, valid, "") for nq in (1, 4)]
    for nq, k, rows, flags, where in cases:
        q = qs[:nq]
        pv, pi = knn_topk_plain(q, rows, flags, k, "dot")

        def parent_fn(q=q, k=k, rows=rows, flags=flags):
            return parent_knn(q, rows, flags, k, "dot")

        def tree_fn(q=q, k=k, rows=rows, flags=flags):
            return knn_topk(q, rows, flags, k, "dot")

        err = {}
        for who, fn in (("parent", parent_fn), ("tree", tree_fn)):
            kv, ki = fn()
            err[who] = compare_topk(kv, ki, pv, pi, TOPK_ATOL)
        name = f"K3 nq={nq} k={k}{where}"
        res[name] = {
            "max_abs_err": err,
            **turns(parent_fn, tree_fn, 5, "knn_topk"),
            "library": library(lambda q=q, k=k, rows=rows: torch.topk(torch.matmul(q, rows.T), k), 5),
        }
        log(f"{name}: {json.dumps(res[name])}")
    del slab, valid, cases, rows, flags
    torch.cuda.empty_cache()

    # ---- K1: bf16 and f32 at the embed path's shape
    B, L, H, D = DOC_BATCH, 256, 12, 64
    for dt in (bf16, f32):
        tag = "bf16" if dt == bf16 else "f32"
        q, k, v = (torch.randn((B, L, H, D), generator=g, device=dev).to(dt) for _ in range(3))
        mask = lengths_mask(B, L, 64)
        ref = attention_plain(q, k, v, mask).float()
        tol = F32_ATOL if dt == f32 else ATTN_ATOL
        err = {}
        for who, fn in (("parent", parent_attention), ("tree", attention)):
            d = (fn(q, k, v, mask).float() - ref).abs()
            if not bool((d <= tol + (0.0 if dt == f32 else ATTN_RTOL) * ref.abs()).all()):
                fail(f"{who} attention {tag}: max err {d.max().item()}")
            err[who] = d.max().item()
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        sdpa_mask = mask.bool()[:, None, None, :]
        name = f"K1 {tag} B={B} L={L} H={H} D={D}"
        res[name] = {
            "max_abs_err": err,
            **turns(lambda: parent_attention(q, k, v, mask), lambda: attention(q, k, v, mask), 30, "attention"),
            "library": library(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=sdpa_mask), 10),
        }
        log(f"{name}: {json.dumps(res[name])}")
    torch.cuda.empty_cache()

    # ---- K12: a 1M-row IVF at phase 6's shape (1,024 bf16 cells of 16,384
    # slots, 500-1,500 live rows each and one crowded cell of 9,000 that
    # every other query probes), queries at nq 1 and 32
    nlist, cap = IVF_NLIST, 4 * IVF_CELL_CAP
    cells = torch.zeros((nlist, cap, HIDDEN), dtype=bf16, device=dev)
    cvalid = torch.zeros((nlist, cap), device=dev)
    fill = torch.randint(500, 1500, (nlist,), generator=torch.Generator().manual_seed(SEED)).tolist()
    fill[7] = 9000
    for c, n in enumerate(fill):
        x = torch.randn((n, HIDDEN), generator=g, device=dev)
        cells[c, :n] = (x / x.norm(dim=1, keepdim=True)).to(bf16)
        cvalid[c, :n] = 1.0
    cents = torch.randn((nlist, HIDDEN), generator=g, device=dev)
    cents /= cents.norm(dim=1, keepdim=True)
    for nq in (1, 32):
        q = qs[:nq].contiguous()
        probe = knn_topk(q, cents, torch.ones((nlist,), device=dev), IVF_NPROBE, "dot")[1]
        probe[::2, 5] = 7
        pv, pi = ivf_scan_plain(q, probe, cells, cvalid, K, query_block=1)
        err = {}
        for who, fn in (("parent", parent_scan), ("tree", ivf_scan)):
            kv, ki = fn(q, probe, cells, cvalid, K)
            err[who] = compare_topk(kv, ki, pv, pi, TOPK_ATOL)
        name = f"K12 nq={nq} k={K}"
        res[name] = {"max_abs_err": err, **turns(lambda: parent_scan(q, probe, cells, cvalid, K),
                                                  lambda: ivf_scan(q, probe, cells, cvalid, K), 40 if nq == 1 else 10,
                                                  "ivf_scan")}
        log(f"{name}: {json.dumps(res[name])}")
    del cells, cvalid, qs
    torch.cuda.empty_cache()

    # ---- K16: act none (db only) and the mlp_up GELU, at the train step's shapes
    M = TRAIN_B * TRAIN_L
    for n, act in ((HIDDEN, "none"), (4 * HIDDEN, "gelu_tanh")):
        y, dy = (torch.randn((M, n), generator=g, device=dev) for _ in range(2))
        bias = torch.randn((n,), generator=g, device=dev)
        want = bias_act_bwd_plain(dy, y, bias, act)
        err = {}
        for who, fn in (("parent", parent_bias_bwd), ("tree", bias_act_bwd)):
            got = fn(dy, y, bias, act)
            torch.cuda.synchronize()
            err[who] = max(float((a - b).abs().max()) / float(b.abs().max()) for a, b in zip(got, want))
            if not err[who] <= BWD_RTOL:
                fail(f"{who} bias_act_bwd {act}: {err[who]} of max|ref| > {BWD_RTOL}")
        name = f"K16 {act} [{M}, {n}]"
        iters = 200 if act == "none" else 50
        res[name] = {"max_rel_err": err, **turns(lambda: parent_bias_bwd(dy, y, bias, act),
                                                  lambda: bias_act_bwd(dy, y, bias, act), iters, "bias_act_bwd")}
        if act == "none":
            res[name]["library"] = library(lambda: dy.sum(0), iters)
        log(f"{name}: {json.dumps(res[name])}")
        del y, dy, bias, want

    # ---- K15 at the train step's shape and at D = 128 over 512 keys, a
    # batch row of no present key in each; both builds within BWD_RTOL of
    # the plain version
    for B, L, H, D in ((TRAIN_B, TRAIN_L, 12, 64), (2, 512, 4, 128)):
        m = torch.rand((B, L), generator=g, device=dev) < 0.7
        m[1] = False
        m = m.to(torch.uint8)
        q, k, v, do = (torch.randn((B, L, H, D), generator=g, device=dev) for _ in range(4))
        out, lse = attention(q, k, v, m, with_lse=True)
        want = attention_bwd_plain(q, k, v, out, do, m, lse)
        err = {}
        for who, fn in (("parent", parent_attention_bwd), ("tree", attention_bwd)):
            got = fn(q, k, v, out, do, m, lse)
            torch.cuda.synchronize()
            err[who] = max(float((a - b).abs().max()) / float(b.abs().max()) for a, b in zip(got, want))
            if not err[who] <= BWD_RTOL:
                fail(f"{who} attention_bwd at {(B, L, H, D)}: {err[who]} of max|ref| > {BWD_RTOL}")
        name = f"K15 {bwd_form(L, D)} B={B} L={L} H={H} D={D}"
        # K15 picks its form by shape: where both sides run the same form of
        # a rebuilt library, this tree runs the parent's code
        changed = "attention_bwd" not in same and bwd_form(L, D) != parent_bwd_form(L, D)
        res[name] = {"max_rel_err": err, **turns(lambda: parent_attention_bwd(q, k, v, out, do, m, lse),
                                                  lambda: attention_bwd(q, k, v, out, do, m, lse), 20,
                                                  "attention_bwd", changed)}
        log(f"{name}: {json.dumps(res[name])}")
        del q, k, v, do, out, lse, want, got

    # ---- K19 over copies of every BGE-base parameter (f32): the same bits
    # as the parent's K19 for p, m and v after two steps on the same inputs
    from pathway_tpu_torch import BGE_BASE
    from pathway_tpu_torch.models import TextEncoderModel

    model = TextEncoderModel(dataclasses.replace(BGE_BASE, dtype=f32), device=dev, seed=SEED)
    ps = [p.detach().clone() for p in model.parameters()]
    del model
    gs = [torch.randn(p.shape, generator=g, device=dev) * 1e-3 for p in ps]
    sides = {who: [[t.clone() for t in ps], [torch.zeros_like(t) for t in ps], [torch.zeros_like(t) for t in ps]]
             for who in ("parent", "tree")}
    for step in (1, 2):
        for who, fn in (("parent", parent_adam), ("tree", adam_step)):
            p, m, v = sides[who]
            fn(p, gs, m, v, step, TRAIN_LR)
    torch.cuda.synchronize()
    equal = all(torch.equal(a, b) for xs, ys in zip(sides["parent"], sides["tree"]) for a, b in zip(xs, ys))
    if not equal:
        fail("K19 gives other bits than the parent's K19 after two steps on the same inputs")
    name = f"K19 {sum(p.numel() for p in ps)} params in {len(ps)} tensors"
    count = {"parent": 2, "tree": 2}

    def adam_turn(who, fn):
        def call():
            count[who] += 1
            fn(sides[who][0], gs, sides[who][1], sides[who][2], count[who], TRAIN_LR)
        return call

    res[name] = {"bit_equal_after_two_steps": equal,
                 **turns(adam_turn("parent", parent_adam), adam_turn("tree", adam_step), 10, "adam")}
    log(f"{name}: {json.dumps(res[name])}")
    del ps, gs, sides

    # ---- K17: the residual form at the train step's [8,192, 768], and the
    # embedding form at BGE-base's tables, at random ids and at the
    # reference's all-ones ids; both builds within BWD_RTOL of the plain
    # versions

    def rel_err(got, want):
        return max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                   for a, b in zip(got, want) if b is not None)

    M = TRAIN_B * TRAIN_L
    x, r, dy = (torch.randn((M, HIDDEN), generator=g, device=dev) for _ in range(3))
    gamma = 1 + 0.1 * torch.randn((HIDDEN,), generator=g, device=dev)
    want = layer_norm_bwd_plain(dy, x + r, gamma, 1e-12)
    err = {}
    for who, fn in (("parent", parent_ln_bwd), ("tree", layer_norm_bwd)):
        err[who] = rel_err(fn(dy, x, r, gamma, 1e-12), want)
        if not err[who] <= BWD_RTOL:
            fail(f"{who} layer_norm_bwd: {err[who]} of max|ref| > {BWD_RTOL}")
    name = f"K17 residual [{M}, {HIDDEN}]"
    res[name] = {"max_rel_err": err, **turns(lambda: parent_ln_bwd(dy, x, r, gamma, 1e-12),
                                              lambda: layer_norm_bwd(dy, x, r, gamma, 1e-12), 50, "layer_norm_bwd")}
    log(f"{name}: {json.dumps(res[name])}")
    del x, r, want
    tables = (torch.randn((BGE_BASE.vocab_size, HIDDEN), generator=g, device=dev) * 0.02,
              torch.randn((BGE_BASE.max_len, HIDDEN), generator=g, device=dev) * 0.02,
              torch.randn((BGE_BASE.type_vocab, HIDDEN), generator=g, device=dev) * 0.02)
    for pattern, ids in (
        ("random", torch.randint(1000, BGE_BASE.vocab_size, (TRAIN_B, TRAIN_L), generator=g, device=dev)),
        ("all-ones", torch.ones((TRAIN_B, TRAIN_L), dtype=torch.int64, device=dev)),
    ):
        ids = ids.to(torch.int16)
        want = embed_ln_bwd_plain(dy, ids, None, *tables, gamma, 1e-12)
        err = {}
        for who, fn in (("parent", parent_embed_bwd), ("tree", embed_ln_bwd)):
            err[who] = rel_err(fn(dy, ids, None, *tables, gamma, 1e-12), want)
            if not err[who] <= BWD_RTOL:
                fail(f"{who} embed_ln_bwd at {pattern} ids: {err[who]} of max|ref| > {BWD_RTOL}")
        name = f"K17 embedding {pattern} ids [{TRAIN_B}, {TRAIN_L}, {HIDDEN}]"
        res[name] = {"max_rel_err": err,
                     **turns(lambda ids=ids: parent_embed_bwd(dy, ids, None, *tables, gamma, 1e-12),
                             lambda ids=ids: embed_ln_bwd(dy, ids, None, *tables, gamma, 1e-12), 10,
                             "layer_norm_bwd")}
        log(f"{name}: {json.dumps(res[name])}")
        del want
    del dy, tables
    torch.cuda.empty_cache()

    # ---- K9 at the image path's chunk: IMAGE_BATCH images of N_PATCH rows
    xi = torch.randn((IMAGE_BATCH, N_PATCH, HIDDEN), generator=g, device=dev).to(bf16)
    weight = torch.randn((HIDDEN, HIDDEN), generator=g, device=dev) * 0.02
    hbias = torch.randn((HIDDEN,), generator=g, device=dev) * 0.1
    want = vision_head_plain(xi, weight, hbias)
    err = {}
    for who, fn in (("parent", parent_vision_head), ("tree", vision_head)):
        err[who] = float((fn(xi, weight, hbias) - want).abs().max())
        if not err[who] <= HEAD_ATOL:
            fail(f"{who} vision_head: max err {err[who]} > {HEAD_ATOL}")
    name = f"K9 B={IMAGE_BATCH} P={N_PATCH} H={HIDDEN}"
    res[name] = {"max_abs_err": err, **turns(lambda: parent_vision_head(xi, weight, hbias),
                                              lambda: vision_head(xi, weight, hbias), 50, "vision_head")}
    log(f"{name}: {json.dumps(res[name])}")
    del xi, want

    # ---- K7 at the embed chunk's shape (CLS bf16, BGE-base's tail; mean
    # bf16, E5's; mean f32), each within phase 2's tolerance of the plain
    # version
    B, L = DOC_BATCH, 256
    mask = lengths_mask(B, L, 64)
    for tag, dt, pool in (("CLS bf16", bf16, "cls"), ("mean bf16", bf16, "mean"), ("mean f32", f32, "mean")):
        x = torch.randn((B, L, HIDDEN), generator=g, device=dev).to(dt)
        want = pool_normalize_plain(x, mask, pool, True)
        tol = F32_ATOL if dt == f32 else BF16_RTOL * want.abs() + FUSED_ATOL
        err = {}
        for who, fn in (("parent", parent_pool), ("tree", pool_normalize)):
            d = (fn(x, mask, pool, True) - want).abs()
            if not bool((d <= tol).all()):
                fail(f"{who} pool_normalize {tag}: max err {d.max().item()}")
            err[who] = d.max().item()
        name = f"K7 {tag} B={B} L={L} H={HIDDEN}"
        # the CLS form is the parent's kernel (cls_out_kernel, the same
        # code in the rebuilt library): held within PARENT_RATIO, as every
        # row where both sides run the parent's code; the mean form
        # (rebuilt to be faster) no slower at all
        res[name] = {"max_abs_err": err, **turns(lambda: parent_pool(x, mask, pool, True),
                                                  lambda: pool_normalize(x, mask, pool, True),
                                                  500 if pool == "cls" else 100, "pool_normalize",
                                                  False if pool == "cls" else None)}
        log(f"{name}: {json.dumps(res[name])}")
        del x, want

    # ---- K2 at phase 2's shape: 256 rows (200 live, 56 pads) into a 1M-slot
    # f32 slab, normalised, and their clear; each side against the plain version
    n_live = DOC_BATCH * 25 // 32  # 200 live sequences of 256
    slots = torch.full((B,), CAPACITY, dtype=torch.int32, device=dev)
    slots[:n_live] = torch.randperm(CAPACITY, generator=g, device=dev)[:n_live].int()
    kept = slots[:n_live].long()
    vals = torch.randn((B, HIDDEN), generator=g, device=dev) * 3.0
    slab_ref, valid_ref = torch.zeros((CAPACITY, HIDDEN), device=dev), torch.zeros((CAPACITY,), device=dev)
    slab_scatter_plain(slab_ref, valid_ref, slots, vals, True)
    sides, err = {}, {}
    for who, fn in (("parent", parent_scatter), ("tree", slab_scatter)):
        sides[who] = (torch.zeros((CAPACITY, HIDDEN), device=dev), torch.zeros((CAPACITY,), device=dev))
        fn(*sides[who], slots, vals, True)
        err[who] = (sides[who][0][kept] - slab_ref[kept]).abs().max().item()
        if err[who] > SCATTER_ATOL or not torch.equal(sides[who][1], valid_ref):
            fail(f"{who} slab_scatter: max err {err[who]} or flags differ from the plain version")
    name = f"K2 scatter b={B} ({n_live} live) into [{CAPACITY},{HIDDEN}] f32"
    res[name] = {"max_abs_err": err, **turns(lambda: parent_scatter(*sides["parent"], slots, vals, True),
                                            lambda: slab_scatter(*sides["tree"], slots, vals, True), 500,
                                            "slab_scatter"),
                 "library": library(lambda: sides["tree"][0].index_copy_(0, kept, vals[:n_live]), 500)}
    log(f"{name}: {json.dumps(res[name])}")
    name = f"K2 clear b={B} ({n_live} live) of [{CAPACITY}] flags"
    res[name] = turns(lambda: parent_clear(sides["parent"][1], slots), lambda: slab_clear(sides["tree"][1], slots),
                      500, "slab_scatter")
    log(f"{name}: {json.dumps(res[name])}")

    # ---- the ingest tail (bf16 hidden state into that f32 cosine slab, CLS
    # and mean) against the parent's K7 then K2 on the same inputs; both
    # within phase 2's tolerance of the plain version
    x = torch.randn((B, L, HIDDEN), generator=g, device=dev).to(bf16)
    for pool in ("cls", "mean"):
        pool_normalize_into_plain(slab_ref, valid_ref, slots, x, mask, pool, True, True)
        pool_normalize_into(*sides["tree"], slots, x, mask, pool, True, True)
        parent_scatter(*sides["parent"], slots, parent_pool(x, mask, pool, True), True)
        err = {}
        for who in ("parent", "tree"):
            got, want = sides[who][0][kept], slab_ref[kept]
            d = (got - want).abs()
            if not (bool((d <= BF16_RTOL * want.abs() + FUSED_ATOL).all()) and torch.equal(sides[who][1], valid_ref)):
                fail(f"{who} ingest tail {pool}: max err {d.max().item()} or flags differ from the plain version")
            err[who] = d.max().item()
        name = f"tail {pool} bf16 into f32 cos B={B} L={L} H={HIDDEN} (parent: K7 then K2)"
        res[name] = {"max_abs_err": err,
                     **turns(lambda: parent_scatter(*sides["parent"], slots, parent_pool(x, mask, pool, True), True),
                             lambda: pool_normalize_into(*sides["tree"], slots, x, mask, pool, True, True),
                             500 if pool == "cls" else 100, "pool_normalize", True)}
        log(f"{name}: {json.dumps(res[name])}")
    del x, slab_ref, valid_ref, sides, vals
    torch.cuda.empty_cache()

    # ---- B8, the cross-encoder's head: this tree's one launch against the
    # parent's five (head_chain with the parent's K4), bf16 at a batched
    # chunk and at one question, on the CLS view of the hidden state; both
    # within phase 2's tolerance of the plain chain
    for hb, hl in CROSS_HEAD_SHAPES:
        hidden = torch.randn((hb, hl, HIDDEN), generator=g, device=dev).to(bf16)
        hx = hidden[:, 0]
        hargs = (hx, torch.randn((HIDDEN, HIDDEN), generator=g, device=dev) * 0.02,
                 torch.randn((HIDDEN,), generator=g, device=dev) * 0.5,
                 torch.randn((1, HIDDEN), generator=g, device=dev) * 0.02, torch.randn((1,), generator=g, device=dev))
        want = cross_head_plain(*hargs)
        err = {who: head_err(torch, f"{who} B={hb}", fn(), want, hx, hargs[3], hargs[1], hargs[2])
               for who, fn in (("parent", lambda: head_chain(*hargs, p_bias_mod.bias_act)),
                               ("tree", lambda: cross_head(*hargs)))}
        name = f"B8 head bf16 B={hb} L={hl} H={HIDDEN} (parent: five launches)"
        res[name] = {"max_abs_err": err, **turns(lambda: head_chain(*hargs, p_bias_mod.bias_act),
                                                  lambda: cross_head(*hargs), 200, "cross_head", True)}
        log(f"{name}: {json.dumps(res[name])}")
        del hidden, hx, hargs, want

    # ---- K18: the loss and d emb of the train step's [64, 768] embeddings
    # through autograd, as the step runs them: this tree's two launches
    # against the parent's six (its product, loss kernel, scale and the
    # product's backward); and the pool backward at the train step's CLS
    # shape.  Each within BWD_RTOL of the plain versions
    emb = F.normalize(torch.randn((TRAIN_B, HIDDEN), generator=g, device=dev), dim=1)
    plain_loss, G = contrastive_loss_plain(emb @ emb.T)
    plain_d = (G + G.T) @ emb

    def loss_tail(in_batch_loss):
        def call():
            e = emb.detach().requires_grad_()
            loss = in_batch_loss(e)
            return loss.detach(), torch.autograd.grad(loss, e)[0]
        return call

    sides = {"parent": loss_tail(p_loss_mod.in_batch_loss), "tree": loss_tail(in_batch_loss)}
    err = {}
    for who, fn in sides.items():
        loss, d = fn()
        err[who] = max(abs(float(loss) - float(plain_loss)) / abs(float(plain_loss)),
                       float((d - plain_d).abs().max()) / float(plain_d.abs().max()))
        if not err[who] <= BWD_RTOL:
            fail(f"{who} contrastive loss tail: {err[who]} of max|ref| > {BWD_RTOL}")
    name = f"K18 loss + d emb B={TRAIN_B} H={HIDDEN} (parent: six launches)"
    res[name] = {"max_rel_err": err, **turns(sides["parent"], sides["tree"], 50, "contrastive_loss", True)}
    log(f"{name}: {json.dumps(res[name])}")
    xh = torch.randn((TRAIN_B, TRAIN_L, HIDDEN), generator=g, device=dev)
    gh = torch.randn((TRAIN_B, HIDDEN), generator=g, device=dev)
    hmask = lengths_mask(TRAIN_B, TRAIN_L, TRAIN_L // 4)
    want = pool_normalize_bwd_plain(xh, hmask, gh, "cls", True)
    err = {}
    for who, fn in (("parent", p_pool_mod.pool_normalize_bwd), ("tree", pool_normalize_bwd)):
        err[who] = float((fn(xh, hmask, gh, "cls", True) - want).abs().max()) / float(want.abs().max())
        if not err[who] <= BWD_RTOL:
            fail(f"{who} pool_normalize_bwd: {err[who]} of max|ref| > {BWD_RTOL}")
    name = f"K18 pool backward CLS [{TRAIN_B}, {TRAIN_L}, {HIDDEN}]"
    res[name] = {"max_rel_err": err, **turns(lambda: p_pool_mod.pool_normalize_bwd(xh, hmask, gh, "cls", True),
                                              lambda: pool_normalize_bwd(xh, hmask, gh, "cls", True), 50,
                                              "contrastive_loss", True)}
    log(f"{name}: {json.dumps(res[name])}")
    del emb, G, plain_d, xh, gh, want
    torch.cuda.empty_cache()

    # ---- gates: the parent's code keeps its time through this tree's
    # wrappers; code this tree changed loses none
    slow = []
    for name, row in res.items():
        by = "queued_ms" if name.startswith(DEVICE_GATED) else "ms"
        parent_ms, tree_ms = row["parent"][by], row["tree"][by]
        limit = 1.0 if row["strict"] else PARENT_RATIO
        if not tree_ms <= limit * parent_ms:
            slow.append(f"{name}: {tree_ms:.4f} ms ({by}) against the parent's {parent_ms:.4f}")
    if slow:
        fail("slower than the parent: " + "; ".join(slow))
    return res


# ---------------------------------------------------------------------------
# C6 and C7 on the card, then the train step (B15)


def phase_shape_repairs(torch, dev) -> dict:
    """C6 and C7 on the card, each kernel against its plain version.  C6:
    K1 at L = 576 (B=2), 1,024 and 8,192 (B=1), at head dims 128 and 80
    (B=2, L=512), bf16 and f32, masks with holes and a row with no present
    key (K1's tolerances: bf16 ATTN_ATOL + ATTN_RTOL |ref|, f32 F32_ATOL);
    K14 at D = 128, a middle step from a carried state (the state relative
    to l, RING_STATE_RTOL).  C7: over C7_ROWS unit rows stored with their
    pitch rounded up (``kernels/_pitch.py``) at d = 1,536, 3,072 and 770,
    f32 and bf16: K3 at nq 1 and 32, k=10, and K12 over 64 cells of 4,096
    rows, each held as phases 2 and 6 hold them (scores within TOPK_ATOL,
    f32 sums of unit rows in another order; slots equal but near-ties; the
    largest differences are printed),
    K2 without normalising bit for bit and with it within SCATTER_ATOL (the
    norm summed in another order), K11 on the rows (decided equal).  Also
    K3 at nq=32, k=128 over the 1M slab and over phase 6's 1,024
    centroids, timed beside its plain version and ``topk(matmul)``."""
    from pathway_tpu_torch import kernels
    from pathway_tpu_torch.kernels import attention, attention_plain, ivf_scan_plain, knn_topk_plain
    from pathway_tpu_torch.kernels._pitch import pitched, pitched_zeros
    from pathway_tpu_torch.kernels.ring_block import ring_block, ring_block_plain, ring_state

    res: dict = {"attention": {}, "ring_block": {}, "knn_topk": {}, "ivf_scan": {}, "slab_scatter": {},
                 "ivf_assign": {}}
    g = torch.Generator(device=dev).manual_seed(SEED + 11)
    bf16, f32 = torch.bfloat16, torch.float32
    for B, L, H, D in ((2, 576, 12, 64), (1, 1024, 12, 64), (1, 8192, 12, 64), (2, 512, 12, 128),
                       (2, 512, 12, 80)):
        for dt in (bf16, f32):
            q, k, v = (torch.randn((B, L, H, D), generator=g, device=dev).to(dt) for _ in range(3))
            # B=2: row 0 keeps every key, row 1 none (the uniform average of
            # v); B=1: a row of holes (present runs between masked tiles)
            mask = holes_mask(torch, g, dev, max(B, 4), L)[:B] if B > 1 else holes_mask(torch, g, dev, 4, L)[2:3]
            tag = f"{'f32' if dt == f32 else 'bf16'} B={B} L={L} H={H} D={D}"
            got = attention(q, k, v, mask)
            ref = attention_plain(q, k, v, mask)
            atol, rtol = (F32_ATOL, 0.0) if dt == f32 else (ATTN_ATOL, ATTN_RTOL)
            err = check_attention_case(torch, f"C6 {tag}", v, mask, got, ref, atol, rtol)
            res["attention"][tag] = {"max_abs_err": err,
                                     "ms": time_ms(torch, lambda: attention(q, k, v, mask), 5)}
            del q, k, v, got, ref
    for dt in (bf16, f32):
        B, L, H, D = 4, 2048, 12, 128
        q, k, v = (torch.randn((B, L, H, D), generator=g, device=dev).to(dt) for _ in range(3))
        mask = holes_mask(torch, g, dev, B, L)
        any_key = (mask.sum(1) > 0).to(torch.uint8)
        st = ring_state(B, L, H, D, dev)
        ring_block_plain(q, k, v, mask, *st)  # a carried state
        mine = tuple(t.clone() for t in st)
        ref = tuple(t.clone() for t in st)
        ring_block(q, k, v, mask, *mine, any_key=any_key)
        ring_block_plain(q, k, v, mask, *ref)
        state_err, m_err = ring_state_err(mine, ref)
        tag = f"{'f32' if dt == f32 else 'bf16'} B={B} L={L} H={H} D={D}"
        res["ring_block"][tag] = {"state_rel_err": state_err, "m_rel_err": m_err}
        log(f"C6 K14 {tag}: state err {state_err:.3e} (relative to l), running max {m_err:.3e}")
        if not (state_err <= RING_STATE_RTOL and m_err <= RING_STATE_RTOL):
            fail(f"C6 K14 {tag}: state {state_err}, running max {m_err} > {RING_STATE_RTOL}")
        del q, k, v, st, mine, ref
    torch.cuda.empty_cache()

    # K3 at k=128 and nq=32, with its bound and plain time: over the 1M f32
    # slab, and phase 6's probe (1,024 centroids, all valid)
    slab = torch.randn((CAPACITY, HIDDEN), generator=g, device=dev)
    slab /= slab.norm(dim=1, keepdim=True)
    valid = (torch.rand((CAPACITY,), generator=g, device=dev) >= 0.1).float()
    qs = torch.randn((32, HIDDEN), generator=g, device=dev)
    qs /= qs.norm(dim=1, keepdim=True)
    cents = slab[:IVF_NLIST].clone()
    res["knn_topk_k128"] = {}
    for where, rows, flags in (("slab", slab, valid), ("probe", cents, torch.ones((IVF_NLIST,), device=dev))):
        live = int(flags.sum())
        kv, ki = kernels.knn_topk(qs, rows, flags, 128, "dot")
        pv, pi = knn_topk_plain(qs, rows, flags, 128, "dot")
        b_ms, by = bound(live * HIDDEN * 4 + 32 * HIDDEN * 4 + 32 * 128 * 8, 2 * 32 * live * HIDDEN,
                         PEAK_F32_PRODUCT)
        res["knn_topk_k128"][where] = {
            "max_abs_err": compare_topk(kv, ki, pv, pi, TOPK_ATOL),
            "ms": time_ms(torch, lambda rows=rows, flags=flags: kernels.knn_topk(qs, rows, flags, 128, "dot"), 10),
            "plain_ms": time_ms(torch, lambda rows=rows, flags=flags: knn_topk_plain(qs, rows, flags, 128, "dot"), 5),
            "library_ms": time_ms(torch, lambda rows=rows: torch.topk(torch.matmul(qs, rows.T), 128), 10),
            "bound_ms": b_ms, "bound_by": by, "rows": int(rows.shape[0])}
        log(f"K3 nq=32 k=128 over the {where} ({rows.shape[0]} rows): {json.dumps(res['knn_topk_k128'][where])}")
    del slab, valid, cents
    torch.cuda.empty_cache()

    for d in (1536, 3072, 770):
        for dt in (f32, bf16):
            tag = f"{'f32' if dt == f32 else 'bf16'} d={d}"
            rows = torch.randn((C7_ROWS, d), generator=g, device=dev)
            rows /= rows.norm(dim=1, keepdim=True)
            slab = pitched(rows.to(dt))
            valid = (torch.rand((C7_ROWS,), generator=g, device=dev) >= 0.1).float()
            qs = torch.randn((32, d), generator=g, device=dev)
            qs /= qs.norm(dim=1, keepdim=True)
            res["knn_topk"][tag] = {}
            for nq in (1, 32):
                kv, ki = kernels.knn_topk(qs[:nq], slab, valid, K, "dot")
                pv, pi = knn_topk_plain(qs[:nq], slab, valid, K, "dot")
                err = compare_topk(kv, ki, pv, pi, TOPK_ATOL)
                res["knn_topk"][tag][f"nq{nq}"] = {
                    "max_abs_err": err, "ms": time_ms(torch, lambda nq=nq: kernels.knn_topk(qs[:nq], slab, valid, K, "dot"), 5)}
            cells = slab[: 64 * 4096].view(64, 4096, d) if d % 8 == 0 else pitched(rows[: 64 * 4096].to(dt).view(64, 4096, d))
            cvalid = valid[: 64 * 4096].view(64, 4096)
            probe = torch.randint(0, 64, (32, 8), generator=g, device=dev).to(torch.int32)
            kv, ki = kernels.ivf_scan(qs, probe, cells, cvalid, K)
            pv, pi = ivf_scan_plain(qs, probe, cells, cvalid, K)
            err = compare_topk(kv, ki, pv, pi, TOPK_ATOL)
            res["ivf_scan"][tag] = {"max_abs_err": err}
            raw = torch.randn((4096, d), generator=g, device=dev)
            slots = torch.randperm(C7_ROWS, generator=g, device=dev)[:4096].to(torch.int32)
            errs = {}
            for normalize in (False, True):
                s1, s2 = pitched_zeros((C7_ROWS, d), dt, dev), pitched_zeros((C7_ROWS, d), dt, dev)
                v1, v2 = torch.zeros((C7_ROWS,), device=dev), torch.zeros((C7_ROWS,), device=dev)
                kernels.slab_scatter(s1, v1, slots, raw, normalize)
                kernels.slab_scatter_plain(s2, v2, slots, raw, normalize)
                e = (s1.float() - s2.float()).abs().max().item()
                errs["normalized" if normalize else "copied"] = e
                tol = (SCATTER_ATOL if dt == f32 else 2.0**-8) if normalize else 0.0
                if e > tol or not torch.equal(v1, v2):
                    fail(f"C7 K2 {tag} normalize={normalize}: {e} > {tol}")
                del s1, s2
            res["slab_scatter"][tag] = errs
            if dt == f32:
                c = rows[:1024].contiguous() if d % 4 == 0 else rows[:1024].clone()
                got = kernels.ivf_assign(rows[:65536], c, True)
                want = kernels.ivf_assign_plain(rows[:65536], c, True)
                res["ivf_assign"][tag] = {"disagree": int((got != want).sum())}
                if not torch.equal(got, want):
                    check_assign(torch, rows[:65536], c, True, got, f"C7 ivf_assign {tag}")
            log(f"C7 {tag}: K3 {json.dumps(res['knn_topk'][tag])} K12 {json.dumps(res['ivf_scan'][tag])} "
                f"K2 {json.dumps(errs)}")
            del rows, slab, valid, cells, raw
            torch.cuda.empty_cache()
    res["ivf_scan_plan"] = check_scan_plan()
    res["ivf_scan_crowded"] = check_crowded_scan(torch, dev, g)
    return res


# K12's cell-major plan at the shapes it must take and refuse: (d, bf16,
# k, cap) and the pairs a group (0: the query-major form runs)
SCAN_PLANS = (
    ((768, 1, 10, 16384), 16),  # phase 6: bf16 rows of 768, k=10
    ((768, 0, 128, 4096), 16),  # f32 rows, k = MAX_K
    ((3072, 0, 10, 4096), 8),  # f32 rows of 3,072: 16 queries do not fit
    ((776, 1, 10, 4096), 16),  # a pitch of 776 (d = 770)
    ((768, 1, 129, 4096), 0),  # past MAX_K: the score-only scan
    ((768, 1, 10, 4098), 0),  # flags not 16 bytes apart
    ((768, 1, 10, 1 << 17), 0),  # more than four rounds of flags
    ((16384, 0, 10, 4096), 0),  # a row past the shared memory
)


def check_scan_plan() -> dict:
    """``pw_ivf_scan_cells_plan`` at SCAN_PLANS, with 1,024 cells and
    32 x 128 probe entries (phase 6's): the groups, and the scratch it asks
    for (four shares' lists of k a pair; tickets a cell and a pad group)."""
    import ctypes

    from pathway_tpu_torch.kernels import _build

    lib = _build.library("ivf_scan")
    got = {}
    for (d, bf16, k, cap), want in SCAN_PLANS:
        scratch = (ctypes.c_longlong * 2)()
        groups = lib.pw_ivf_scan_cells_plan(d, bf16, k, IVF_NLIST, cap, 32 * IVF_NPROBE, scratch)
        tag = f"d={d} {'bf16' if bf16 else 'f32'} k={k} cap={cap}"
        got[tag] = {"groups": groups, "scratch": list(scratch) if groups else None}
        if groups != want or (groups and list(scratch) != [32 * IVF_NPROBE * 4 * k, (IVF_NLIST + 1) * 17]):
            fail(f"K12 cell-major plan at {tag}: {got[tag]}, expected {want} pairs a group")
    log(f"K12 cell-major plans: {json.dumps(got)}")
    return got


def check_crowded_scan(torch, dev, g) -> dict:
    """K12 at nq=1,024 over 64 cells of 4,096 slots (90% valid, d=768), bf16
    and f32, where every query probes cell 5 (1,024 pairs: past the 512 a
    cell-major block buffers between flushes) and three probe entries lie
    outside [0, 64): both forms and the wrapper against ``ivf_scan_plain``
    (TOPK_ATOL).  The plain version, which cannot take such an entry, sees
    it as a 65th cell with no valid slot: it adds nothing to a row's best k,
    as the kernels' pads add nothing."""
    from pathway_tpu_torch.kernels import ivf_scan, ivf_scan_plain
    from pathway_tpu_torch.kernels.ivf_scan import _launch as scan_launch

    nlist, cap, d, nq, nprobe = 64, 4096, HIDDEN, 1024, 8
    rows = torch.randn((nlist + 1, cap, d), generator=g, device=dev)
    rows /= rows.norm(dim=2, keepdim=True)
    valid = (torch.rand((nlist + 1, cap), generator=g, device=dev) >= 0.1).float()
    valid[nlist] = 0.0
    q = torch.randn((nq, d), generator=g, device=dev)
    q /= q.norm(dim=1, keepdim=True)
    # cell 5 first in every row, then 7 distinct others
    others = torch.tensor([c for c in range(nlist) if c != 5], device=dev)
    rest = others[torch.rand((nq, nlist - 1), generator=g, device=dev).argsort(1)[:, : nprobe - 1]]
    probe = torch.cat([torch.full((nq, 1), 5, device=dev), rest], 1).to(torch.int32)
    bad = [(7, 2, -1), (9, 4, nlist), (600, 7, 1 << 20)]
    ref_probe = probe.clone()
    for r, c, cell in bad:
        probe[r, c], ref_probe[r, c] = cell, nlist
    if not bool((probe == 5).sum(1).eq(1).all()):
        fail("K12 crowded case: cell 5 not probed once by every query")
    res = {}
    for dt in (torch.bfloat16, torch.float32):
        tag = "bf16" if dt == torch.bfloat16 else "f32"
        cells = rows.to(dt)
        qr = q.to(dt).float().contiguous()
        pv, pi = ivf_scan_plain(q, ref_probe, cells, valid, K)
        errs = {}
        for form, fn in (("query", lambda: scan_launch(qr, probe, cells[:nlist], valid[:nlist], K, False, dev)),
                         ("cell", lambda: scan_launch(qr, probe, cells[:nlist], valid[:nlist], K, True, dev)),
                         ("wrapper", lambda: ivf_scan(q, probe, cells[:nlist], valid[:nlist], K))):
            kv, ki = fn()
            errs[form] = compare_topk(kv, ki, pv, pi, TOPK_ATOL)
        res[tag] = errs
        log(f"K12 nq={nq}, cell 5 probed by every query, {len(bad)} entries out of range, {tag}: "
            f"{json.dumps(errs)}")
        del cells
    del rows, valid
    torch.cuda.empty_cache()
    return res


def synthetic_pairs(np, B: int, L: int, vocab: int, seed: int):
    """``B // 2`` positive pairs: row 2i random ids over a ragged length,
    row 2i + 1 the same row with TRAIN_REDRAW of its tokens redrawn; a pair
    shares its mask."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(1000, vocab, (B, L)).astype(np.int32)
    lens = rng.integers(L // 4, L + 1, B // 2)
    lens[0] = L
    for i in range(B // 2):
        redraw = rng.random(L) < TRAIN_REDRAW
        ids[2 * i + 1] = np.where(redraw, rng.integers(1000, vocab, L), ids[2 * i])
    mask = (np.arange(L)[None] < np.repeat(lens, 2)[:, None]).astype(np.int32)
    return ids, mask


def plain_train_loss(model, ids, mask):
    """The contrastive loss of ``model`` through the kernels' plain versions
    only, out of place, differentiable on whatever device the parameters
    are: the reference the train step is held to.  Nothing on the path
    calls it."""
    import torch
    import torch.nn.functional as F

    from pathway_tpu_torch.kernels import (
        add_layer_norm_plain,
        attention_plain,
        contrastive_loss_plain,
        embed_ln_plain,
        pool_normalize_plain,
    )
    from pathway_tpu_torch.kernels.bias_act import _activate

    cfg = model.cfg
    mask = mask.to(torch.uint8)
    emb = model.embeddings
    types = None if emb.token_type is None else emb.token_type.weight
    x = embed_ln_plain(ids, None, emb.word.weight, emb.position.weight, types, emb.ln.weight, emb.ln.bias,
                       emb.ln.eps, cfg.dtype)
    B, L, _ = x.shape

    def dense(h, lin, act="none"):
        return _activate(F.linear(h, lin.weight) + lin.bias, act)

    for block in model.blocks():
        att = block.attention
        heads = (B, L, cfg.heads, cfg.head_dim)
        q, k, v = (dense(x, lin).view(heads) for lin in (att.query, att.key, att.value))
        a = dense(attention_plain(q, k, v, mask).reshape(B, L, cfg.hidden), att.out)
        x = add_layer_norm_plain(x, a, block.attention_ln.weight, block.attention_ln.bias, cfg.ln_eps)
        h = dense(x, block.mlp_up, "gelu_tanh" if cfg.gelu_approx else "gelu_erf")
        x = add_layer_norm_plain(x, dense(h, block.mlp_down), block.mlp_ln.weight, block.mlp_ln.bias, cfg.ln_eps)
    e = pool_normalize_plain(x, mask, cfg.pool, cfg.normalize)
    return contrastive_loss_plain(e @ e.T)[0]


def grad_errors(torch, named_a, named_b) -> dict:
    """Per tensor, the largest difference of two models' gradients over the
    largest |g| of the second's.  A key bias's exact gradient is 0 (the
    softmax is unchanged when q . b_k is added to every logit of a row):
    both hold rounding noise, read against the key weight's gradient."""
    b = dict(named_b)
    out = {}
    for name, p in named_a:
        ref = b[name].grad
        scale = b[name.replace(".bias", ".weight")].grad if name.endswith("attention.key.bias") else ref
        out[name] = float((p.grad - ref).abs().max()) / max(float(scale.abs().max()), 1e-30)
    return out


def phase_train(torch, dev) -> dict:
    """The contrastive train step (B15) at BGE-base widths in f32 (12
    layers, hidden 768, 12 heads of 64, MLP 3,072, tanh GELU, CLS), B =
    TRAIN_B rows (pairs from ``synthetic_pairs``), L = TRAIN_L, ragged
    masks, TRAIN_STEPS Adam steps at lr TRAIN_LR, all on one card.
    Gates: K15-K19 each within BWD_RTOL of max|ref| of its plain version at
    the step's shapes; the first step's loss within TRAIN_LOSS_RTOL of the
    plain step's (the plain versions' autograd on the card, same weights)
    and every gradient within TRAIN_GRAD_RTOL of its tensor's max|g|; all
    losses finite and the last below the first; K1, K4-K7 and K15-K19
    launched during the steps; every tensor of the step on the card; K15
    at each K15_CASES shape its form's launches and the same bits twice,
    at the train shape one launch, the same bits over K15_REPEATS + 1 more
    calls and by device time (``queued_ms``) no slower than SDPA's
    backward; K19 one launch and by device time no slower than fused
    Adam; K16 act none one launch and by CUDA
    events no slower than ``dy.sum(0)``; K17's residual form one launch a
    call and the same bits twice, its embedding form at most two launches
    a call and ``d_position``, dgamma and dbeta the same bits twice, at
    random, all-ones and tokenizer ids.  Then
    ``train.dryrun_multichip(4)`` on a mesh that repeats the card."""
    import numpy as np
    import torch.nn.functional as F

    from pathway_tpu_torch import BGE_BASE, kernels, train
    from pathway_tpu_torch.kernels import (
        attention,
        attention_bwd_plain,
        bias_act_bwd_plain,
        contrastive_loss_bwd_plain,
        contrastive_loss_fwd_plain,
        contrastive_loss_plain,
        embed_ln_bwd_plain,
        layer_norm_bwd_plain,
        pool_normalize_bwd_plain,
    )
    from pathway_tpu_torch.kernels.adam import adam_step_plain
    from pathway_tpu_torch.kernels.attention import bwd_form
    from pathway_tpu_torch.models import HashTokenizer, TextEncoderModel

    res: dict = {"kernels": {}}
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(BGE_BASE, dtype=torch.float32)
    ids_np, mask_np = synthetic_pairs(np, TRAIN_B, TRAIN_L, cfg.vocab_size, SEED + 21)
    ids = torch.from_numpy(ids_np).to(dev)
    mask = torch.from_numpy(mask_np).to(dev)
    umask = mask.to(torch.uint8)
    valid_tokens = int(mask_np.sum())
    model = TextEncoderModel(cfg, device=dev, seed=SEED)
    ref_model = TextEncoderModel(cfg, device=dev, seed=None)
    ref_model.load_state_dict(model.state_dict())
    g = torch.Generator(device=dev).manual_seed(SEED + 22)
    M, H, F_, heads, D = TRAIN_B * TRAIN_L, cfg.hidden, cfg.mlp_dim, cfg.heads, cfg.head_dim

    def gate(name, got, want):
        """Each of ``got`` within BWD_RTOL of max|want| of its partner."""
        worst = 0.0
        for a, b in zip(got, want):
            if b is None:
                continue
            e = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
            worst = max(worst, e)
        if not worst <= BWD_RTOL:
            fail(f"{name} against its plain version: {worst} of max|ref| > {BWD_RTOL}")
        return worst

    def entry(name, err, ms, plain_ms, nbytes, flops, peak, library_ms, shape):
        b_ms, by = bound(nbytes, flops, peak)
        res["kernels"][name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                                "bound_by": by, "library_ms": library_ms, "shape": shape}
        log(f"{name} at the train step: {json.dumps(res['kernels'][name])}")

    # ---- K16: the mlp_up GELU and a plain bias (first: act none's event
    # gate reads the host's launch path, which every profiler session run
    # before it in the process makes dearer, and K15's and K19's gates
    # below run the profiler)
    # (the mlp_up GELU is the entry; the plain bias of the other five dense
    # layers rides beside it: dx is dy there, only db is computed, which
    # one torch call, dy.sum(0), computes too).  Gates beside the plain
    # version's: act none is one launch a call and, by CUDA events, no
    # slower than dy.sum(0) in this run
    for n, act in ((H, "none"), (F_, "gelu_tanh")):
        y, dy = (torch.randn((M, n), generator=g, device=dev) for _ in range(2))
        bias = torch.randn((n,), generator=g, device=dev)
        before = kernels.bias_act_bwd.launches
        got = kernels.bias_act_bwd(dy, y, bias, act)
        per_call = kernels.bias_act_bwd.launches - before
        err = gate(f"K16 bias_act_bwd {act}", got, bias_act_bwd_plain(dy, y, bias, act))
        nbytes = (3 if act != "none" else 1) * M * n * 4 + 2 * n * 4
        none = res["kernels"].pop("bias_act_bwd", None)
        kern = lambda: kernels.bias_act_bwd(dy, y, bias, act)  # noqa: E731
        lib = lambda: dy.sum(0)  # noqa: E731
        # act none against dy.sum(0) in turns (kernel, library, library,
        # kernel; 50 calls each): both are host-bound, and the host's speed
        # drifts over a run
        turns = None
        if act == "none":
            turns = {"kernel": [], "library": []}
            for who in ("kernel", "library", "library", "kernel"):
                turns[who].append(time_ms(torch, kern if who == "kernel" else lib, 50))
        entry("bias_act_bwd", err,
              sum(turns["kernel"]) / 2 if turns else time_ms(torch, kern, 50),
              time_ms(torch, lambda: bias_act_bwd_plain(dy, y, bias, act), 50), nbytes, 20 * M * n, PEAK_F32,
              sum(turns["library"]) / 2 if turns else None, [M, n])
        row = res["kernels"]["bias_act_bwd"]
        if turns:
            row["turns_ms"] = turns
        row["launches_per_call"] = per_call
        # the profiler's device time beside it: a call at act none is one
        # short launch, and CUDA events read the host's launch rate too
        row["device_ms"] = {
            "kernel": device_ms(torch, kern),
            "plain": device_ms(torch, lambda: bias_act_bwd_plain(dy, y, bias, act)),
            **({"library": device_ms(torch, lib)} if act == "none" else {}),
        }
        log(f"K16 {act}: {per_call} launches a call, device ms {json.dumps(row['device_ms'])}")
        if act == "none":
            if per_call != 1:
                fail(f"K16 act none made {per_call} launches a call, not 1")
            if not row["ms"] <= row["library_ms"]:
                fail(f"K16 act none takes {row['ms']:.4f} ms by CUDA events, slower than dy.sum(0) "
                     f"({row['library_ms']:.4f} ms)")
        if none is not None:
            row["act_none"] = none
        del y, dy, bias, got
    # ---- K17, second (as K16: K15's and K19's gates below run the
    # profiler, which makes every later launch dearer): the residual
    # LayerNorm at [M, H], then the embeddings' with their tables at three
    # id patterns.  Gates: each within BWD_RTOL of its plain version; one
    # launch a call for the residual form, at most two for the embedding
    # form; the same bits on a second call (the residual form's whole
    # output; the embedding form's d_position, dgamma and dbeta: its word
    # and type rows are summed by atomics)
    x, r, dy = (torch.randn((M, H), generator=g, device=dev) for _ in range(3))
    gamma = 1 + 0.1 * torch.randn((H,), generator=g, device=dev)
    before = kernels.layer_norm_bwd.launches
    got = kernels.layer_norm_bwd(dy, x, r, gamma, cfg.ln_eps)
    per_call = kernels.layer_norm_bwd.launches - before
    err = gate("K17 layer_norm_bwd", got, layer_norm_bwd_plain(dy, x + r, gamma, cfg.ln_eps))
    same_bits = all(torch.equal(a, b) for a, b in zip(got, kernels.layer_norm_bwd(dy, x, r, gamma, cfg.ln_eps)))
    s = (x + r).requires_grad_()
    w, b = gamma.clone().requires_grad_(), torch.zeros((H,), device=dev, requires_grad=True)
    ln = F.layer_norm(s, (H,), w, b, cfg.ln_eps)
    kern = lambda: kernels.layer_norm_bwd(dy, x, r, gamma, cfg.ln_eps)  # noqa: E731
    lib = lambda: torch.autograd.grad(ln, (s, w, b), dy, retain_graph=True)  # noqa: E731
    entry("layer_norm_bwd", err, time_ms(torch, kern, 20),
          time_ms(torch, lambda: layer_norm_bwd_plain(dy, x + r, gamma, cfg.ln_eps), 10), 4 * M * H * 4 + 3 * H * 4,
          15 * M * H, PEAK_F32, time_ms(torch, lib, 10), [M, H])
    row = res["kernels"]["layer_norm_bwd"]
    row["launches_per_call"] = per_call
    row["same_bits_twice"] = same_bits
    row["queued_ms"] = {"kernel": queued_ms(torch, kern, 20), "library": queued_ms(torch, lib, 20)}
    row["device_ms"] = {"kernel": device_ms(torch, kern, 20)}
    log(f"K17 residual: {per_call} launch(es) a call, same bits twice: {same_bits}, queued ms "
        f"{json.dumps(row['queued_ms'])}, device ms {json.dumps(row['device_ms'])}")
    if per_call != 1:
        fail(f"K17's residual form made {per_call} launches a call, not 1")
    if not same_bits:
        fail("K17's residual form gave other bits on a second call on the same inputs")
    del x, r, s, w, b, ln, got, kern, lib
    # the embedding form at phase 12's random ids, at the reference's own
    # all-ones ids, and at the tokenizer's ids over phase 3's documents
    # padded to TRAIN_L (CLS at every row's start, SEP, PAD tails; the
    # tokenizer's type ids, all zero)
    emb = model.embeddings
    tables = (emb.word.weight.detach(), emb.position.weight.detach(), emb.token_type.weight.detach())
    tok_ids, _, tok_types = HashTokenizer(cfg.vocab_size).encode_batch(
        synthetic_docs(np, TRAIN_B, SEED), max_len=TRAIN_L, bucket_len=False)
    patterns = {
        "random": (ids.to(torch.int16), None),
        "all_ones": (torch.ones_like(ids, dtype=torch.int16), None),
        "tokenizer": (torch.from_numpy(tok_ids).to(dev, torch.int16), torch.from_numpy(tok_types).to(dev, torch.uint8)),
    }
    cases = {}
    for name, (pids, ptypes) in patterns.items():
        before = kernels.embed_ln_bwd.launches
        got = kernels.embed_ln_bwd(dy, pids, ptypes, *tables, gamma, cfg.ln_eps)
        per_call = kernels.embed_ln_bwd.launches - before
        err = gate(f"K17 embed_ln_bwd at {name} ids", got,
                   embed_ln_bwd_plain(dy, pids, ptypes, *tables, gamma, cfg.ln_eps))
        again = kernels.embed_ln_bwd(dy, pids, ptypes, *tables, gamma, cfg.ln_eps)
        same_bits = all(torch.equal(got[i], again[i]) for i in (1, 3, 4))
        distinct = int(torch.unique(pids).numel())
        nbytes = embed_bwd_bytes(cfg, M, TRAIN_L, distinct, 1, type_bytes=0 if ptypes is None else 1)
        b_ms, by = bound(nbytes, 15 * M * H, PEAK_F32)

        def kern(pids=pids, ptypes=ptypes):
            return kernels.embed_ln_bwd(dy, pids, ptypes, *tables, gamma, cfg.ln_eps)

        cases[name] = {"max_abs_err": err, "ms": time_ms(torch, kern, 10), "queued_ms": queued_ms(torch, kern, 10),
                       "bound_ms": b_ms, "bound_by": by, "distinct_words": distinct,
                       "launches_per_call": per_call, "same_bits_twice": same_bits}
        if per_call > 2:
            fail(f"K17's embedding form made {per_call} launches a call at {name} ids, more than 2")
        if not same_bits:
            fail(f"K17's embedding form gave other d_position, dgamma or dbeta bits on a second call at {name} ids")
        del got, again
    rand_ids = patterns["random"][0]
    entry("embed_ln_bwd", max(c["max_abs_err"] for c in cases.values()), cases["random"]["ms"],
          time_ms(torch, lambda: embed_ln_bwd_plain(dy, rand_ids, None, *tables, gamma, cfg.ln_eps), 5),
          embed_bwd_bytes(cfg, M, TRAIN_L, cases["random"]["distinct_words"], 1), 15 * M * H, PEAK_F32, None, [M, H])
    row = res["kernels"]["embed_ln_bwd"]
    row["cases"] = cases
    row["launches_per_call"] = max(c["launches_per_call"] for c in cases.values())
    row["same_bits_twice"] = all(c["same_bits_twice"] for c in cases.values())
    row["queued_ms"] = {"kernel": cases["random"]["queued_ms"]}
    log(f"K17 embedding form by id pattern: {json.dumps(cases)}")
    del dy, patterns, rand_ids, tables
    # ---- K15 at the other forms it is built for (K15_CASES).  Masks: row
    # 0 has no present key (p = 1 / L), row 1 keys at random, row 2 keys
    # only among the first 128 and row 3 only among the last 64 (in the
    # cluster form over several blocks, blocks whose keys no row attends
    # write zero dK and dV and still join dQ's sum).  Each case within
    # BWD_RTOL of the plain version, the same bits on a second call, and
    # its form (kernels.attention.bwd_form) in its launches a call (1 in
    # the cluster form, 2 in the two-pass form)
    res["attention_bwd_cases"] = {}
    for cb, cl, ch, cd in K15_CASES:
        cm = torch.rand((cb, cl), generator=g, device=dev) < 0.7
        cm[0] = False
        cm[1, 0] = True
        if cb > 2:
            cm[2, 128:] = False
            cm[2, min(5, cl - 1)] = True
        if cb > 3:
            cm[3, :max(cl - 64, 0)] = False
            cm[3, cl - 1] = True
        cq, ck, cv, cdo = (torch.randn((cb, cl, ch, cd), generator=g, device=dev) for _ in range(4))
        cm = cm.to(torch.uint8)
        cout, clse = attention(cq, ck, cv, cm, with_lse=True)
        before = kernels.attention_bwd.launches
        got = kernels.attention_bwd(cq, ck, cv, cout, cdo, cm, clse)
        per_call = kernels.attention_bwd.launches - before
        form = bwd_form(cl, cd)
        name = f"B={cb} L={cl} H={ch} D={cd}"
        if per_call != (1 if form == "cluster" else 2):
            fail(f"K15 at {name} ({form} form) made {per_call} launches a call")
        again = kernels.attention_bwd(cq, ck, cv, cout, cdo, cm, clse)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            fail(f"K15 at {name} ({form} form) gave other bits on a second call on the same inputs")
        res["attention_bwd_cases"][name] = {
            "max_rel_err": gate(f"K15 attention_bwd at {name}", got,
                                attention_bwd_plain(cq, ck, cv, cout, cdo, cm, clse)),
            "form": form, "launches_per_call": per_call, "same_bits_twice": True,
        }
    log(f"K15 against its plain version, a row of no present key in each: {json.dumps(res['attention_bwd_cases'])}")
    del cq, ck, cv, cdo, cm, cout, clse, got, again
    # ---- K15: attention backward at [64, 128, 12, 64], the batch's masks
    # and a batch row of no present key: within BWD_RTOL of the plain
    # version, one launch (the cluster form), the same bits on a second
    # call and on K15_REPEATS more (no atomics; the warps of a block meet
    # before a tile's loads overwrite what the last one read), and by
    # device time (queued_ms) no slower than SDPA's f32 backward
    q, k, v, do = (torch.randn((TRAIN_B, TRAIN_L, heads, D), generator=g, device=dev) for _ in range(4))
    kmask = umask.clone()
    kmask[1] = 0
    out, lse = attention(q, k, v, kmask, with_lse=True)
    before = kernels.attention_bwd.launches
    got = kernels.attention_bwd(q, k, v, out, do, kmask, lse)
    per_call = kernels.attention_bwd.launches - before
    want = attention_bwd_plain(q, k, v, out, do, kmask, lse)
    err = gate("K15 attention_bwd", got, want)
    again = kernels.attention_bwd(q, k, v, out, do, kmask, lse)
    same_bits = all(torch.equal(a, b) for a, b in zip(got, again))
    differ = torch.zeros((), dtype=torch.bool, device=dev)
    for _ in range(K15_REPEATS):
        for a, b in zip(got, kernels.attention_bwd(q, k, v, out, do, kmask, lse)):
            differ |= (a != b).any()
    same_bits_repeated = not bool(differ)
    present = kmask.sum(1)
    # query rows x the keys they attend (all L in a row of no present key)
    keys = float(torch.where(present > 0, present, TRAIN_L).sum()) * TRAIN_L
    qs, ks, vs = (t.detach().transpose(1, 2).requires_grad_() for t in (q, k, v))
    sd = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=kmask.bool()[:, None, None, :])
    dos = do.transpose(1, 2)
    kern = lambda: kernels.attention_bwd(q, k, v, out, do, kmask, lse)  # noqa: E731
    lib = lambda: torch.autograd.grad(sd, (qs, ks, vs), dos, retain_graph=True)  # noqa: E731
    entry("attention_bwd", err, time_ms(torch, kern, 10),
          time_ms(torch, lambda: attention_bwd_plain(q, k, v, out, do, kmask, lse), 5),
          8 * M * H * 4 + TRAIN_B * heads * TRAIN_L * 4 + TRAIN_B * TRAIN_L, 10 * heads * keys * D,
          PEAK_F32_PRODUCT, time_ms(torch, lib, 10), [TRAIN_B, TRAIN_L, heads, D])
    row = res["kernels"]["attention_bwd"]
    row["cases"] = res.pop("attention_bwd_cases")
    row["form"] = bwd_form(TRAIN_L, D)
    row["launches_per_call"] = per_call
    row["same_bits_twice"] = same_bits
    row["same_bits_repeated"] = {"calls": K15_REPEATS, "equal": same_bits_repeated}
    row["queued_ms"] = {"kernel": queued_ms(torch, kern, 20), "library": queued_ms(torch, lib, 20)}
    row["device_ms"] = {"kernel": device_ms(torch, kern, 20), "library": device_ms(torch, lib, 20)}
    log(f"K15 at the train step: {row['form']} form, {per_call} launch(es) a call, same bits twice: {same_bits}, "
        f"over {K15_REPEATS} more calls: {same_bits_repeated}, queued ms {json.dumps(row['queued_ms'])}, "
        f"device ms {json.dumps(row['device_ms'])}")
    if per_call != 1 or row["form"] != "cluster":
        fail(f"K15 at the train shape ran the {row['form']} form in {per_call} launches, not one cluster launch")
    if not (same_bits and same_bits_repeated):
        fail(f"K15 gave other bits on a later call on the same inputs (second call equal: {same_bits}; "
             f"{K15_REPEATS} more equal: {same_bits_repeated})")
    if not row["queued_ms"]["kernel"] <= row["queued_ms"]["library"]:
        fail(f"K15 takes {row['queued_ms']['kernel']:.4f} ms of device time, slower than SDPA's f32 backward "
             f"({row['queued_ms']['library']:.4f} ms)")
    del q, k, v, do, out, lse, got, want, again, qs, ks, vs, sd, dos, kern, lib, kmask, present
    # ---- K18: the loss of a [64, 768] embedding batch (forward: the
    # product, the loss, raw and lse kept; backward: d emb), and K7's
    # backward.  Gates: each within BWD_RTOL of its plain version on the
    # same inputs, the same bits on a second call; the pool backward at
    # least half of its bound by queued device time
    e = F.normalize(torch.randn((TRAIN_B, H), generator=g, device=dev), dim=1)
    got = kernels.contrastive_loss(e)
    err = gate("K18 contrastive_loss", got, contrastive_loss_fwd_plain(e))
    same_fwd = all(torch.equal(a, b) for a, b in zip(got, kernels.contrastive_loss(e)))
    _, lse, raw = got
    gl = torch.full((), 0.5, device=dev)  # the loss's incoming gradient, read on the card
    dgot = kernels.contrastive_loss_bwd(e, raw, lse, gl)
    err_bwd = gate("K18 contrastive_loss_bwd", (dgot,), (contrastive_loss_bwd_plain(e, raw, lse, gl),))
    same_bwd = torch.equal(dgot, kernels.contrastive_loss_bwd(e, raw, lse, gl))
    # and d emb against the reference's own route: G from the raw logits'
    # plain loss, (G + G^T) @ emb
    G = contrastive_loss_plain(e @ e.T)[1] * gl
    err_bwd = max(err_bwd, gate("K18 contrastive_loss_bwd against (G + G^T) @ emb", (dgot,), ((G + G.T) @ e,)))
    B2 = TRAIN_B * TRAIN_B
    for name, kern, plain, err_k, same, nbytes in (
        ("contrastive_loss", lambda: kernels.contrastive_loss(e), lambda: contrastive_loss_fwd_plain(e), err,
         same_fwd, TRAIN_B * H * 4 + (TRAIN_B + B2 + 1) * 4),
        ("contrastive_loss_bwd", lambda: kernels.contrastive_loss_bwd(e, raw, lse, gl),
         lambda: contrastive_loss_bwd_plain(e, raw, lse, gl), err_bwd, same_bwd,
         2 * TRAIN_B * H * 4 + (TRAIN_B + B2 + 1) * 4),
    ):
        entry(name, err_k, time_ms(torch, kern, 50), time_ms(torch, plain, 20), nbytes, 2 * B2 * H + 12 * B2,
              PEAK_F32_PRODUCT, None, [TRAIN_B, H])
        row = res["kernels"][name]
        row["same_bits_twice"] = same
        row["device_ms"] = {"kernel": device_ms(torch, kern), "plain": device_ms(torch, plain)}
        row["queued_ms"] = {"kernel": queued_ms(torch, kern, 50)}
        log(f"K18 {name}: same bits twice: {same}, device ms {json.dumps(row['device_ms'])}, "
            f"queued ms {json.dumps(row['queued_ms'])}")
        if not same:
            fail(f"K18 {name} gave other bits on a second call on the same inputs")
    xh = torch.randn((TRAIN_B, TRAIN_L, H), generator=g, device=dev)
    gg = torch.randn((TRAIN_B, H), generator=g, device=dev)
    got = kernels.pool_normalize_bwd(xh, umask, gg, cfg.pool, True)
    err = gate("K18 pool_normalize_bwd", (got,), (pool_normalize_bwd_plain(xh, umask, gg, cfg.pool, True),))
    same = torch.equal(got, kernels.pool_normalize_bwd(xh, umask, gg, cfg.pool, True))
    kern = lambda: kernels.pool_normalize_bwd(xh, umask, gg, cfg.pool, True)  # noqa: E731
    plain = lambda: pool_normalize_bwd_plain(xh, umask, gg, cfg.pool, True)  # noqa: E731
    entry("pool_normalize_bwd", err, time_ms(torch, kern, 50), time_ms(torch, plain, 20),
          (M * H + 2 * TRAIN_B * H) * 4 + M, 6 * TRAIN_B * H, PEAK_F32, None, [TRAIN_B, TRAIN_L, H])
    row = res["kernels"]["pool_normalize_bwd"]
    row["same_bits_twice"] = same
    row["device_ms"] = {"kernel": device_ms(torch, kern), "plain": device_ms(torch, plain)}
    row["queued_ms"] = {"kernel": queued_ms(torch, kern, 50)}
    row["bound_share_queued"] = row["bound_ms"] / row["queued_ms"]["kernel"]
    log(f"K18 pool_normalize_bwd: same bits twice: {same}, device ms {json.dumps(row['device_ms'])}, "
        f"queued ms {json.dumps(row['queued_ms'])}, {row['bound_share_queued']:.3f} of its bound")
    if not same:
        fail("K18 pool_normalize_bwd gave other bits on a second call on the same inputs")
    if not row["bound_share_queued"] >= 0.5:
        fail(f"K18 pool_normalize_bwd takes {row['queued_ms']['kernel']:.4f} ms of device time, "
             f"under half of its bound {row['bound_ms']:.4f}")
    del xh, gg, got, e, raw, lse, dgot, G, kern, plain
    # ---- K19: Adam over copies of every parameter, random gradients:
    # within BWD_RTOL of the plain version, one launch a step, and by
    # device time (queued_ms) no slower than torch.optim.Adam(fused=True);
    # the CUDA-event ms a call (the host's launch path included) beside it
    ps = [p.detach().clone() for p in model.parameters()]
    gs = [torch.randn(p.shape, generator=g, device=dev) * 1e-3 for p in ps]
    ms = [torch.zeros_like(p) for p in ps]
    vs = [torch.zeros_like(p) for p in ps]
    cp = [[t.clone() for t in ts] for ts in (ps, ms, vs)]
    before = kernels.adam_step.launches
    kernels.adam_step(ps, gs, ms, vs, 1, TRAIN_LR)
    per_step = kernels.adam_step.launches - before
    adam_step_plain(cp[0], gs, cp[1], cp[2], 1, TRAIN_LR)
    err = gate("K19 adam", ps + ms + vs, cp[0] + cp[1] + cp[2])
    n_params = sum(p.numel() for p in ps)
    lib_ps = [p.clone().requires_grad_() for p in cp[0]]
    lib = torch.optim.Adam(lib_ps, lr=TRAIN_LR, fused=True)
    for p, gr in zip(lib_ps, gs):
        p.grad = gr
    lib.step()
    kern = lambda: kernels.adam_step(ps, gs, ms, vs, 2, TRAIN_LR)  # noqa: E731
    entry("adam", err, time_ms(torch, kern, 10),
          time_ms(torch, lambda: adam_step_plain(cp[0], gs, cp[1], cp[2], 2, TRAIN_LR), 3),
          28 * n_params, 12 * n_params, PEAK_F32, time_ms(torch, lib.step, 10), [n_params, len(ps)])
    row = res["kernels"]["adam"]
    row["launches_per_call"] = per_step
    row["device_ms"] = {"kernel": device_ms(torch, kern, 10), "library": device_ms(torch, lib.step, 10)}
    row["queued_ms"] = {"kernel": queued_ms(torch, kern, 10), "library": queued_ms(torch, lib.step, 10)}
    # the library step's kernels as the profiler sees one call of it
    row["library_kernels"] = profile_call(torch, lib.step, 1)["top"]
    log(f"K19: {per_step} launch a step, device ms {json.dumps(row['device_ms'])}, queued ms "
        f"{json.dumps(row['queued_ms'])}, host ms a call by CUDA events {row['ms']:.4f}; fused Adam's kernels "
        f"{json.dumps(row['library_kernels'])}")
    if per_step != 1:
        fail(f"K19 made {per_step} launches a step, not 1")
    if not row["queued_ms"]["kernel"] <= row["queued_ms"]["library"]:
        fail(f"K19 takes {row['queued_ms']['kernel']:.4f} ms of device time, slower than "
             f"torch.optim.Adam(fused=True) ({row['queued_ms']['library']:.4f} ms)")
    res["params"] = n_params
    del ps, gs, ms, vs, cp, lib, lib_ps, kern
    torch.cuda.empty_cache()

    # ---- the first step against the plain step, same weights and batch
    opt = train.Adam(model.named_parameters(), lr=TRAIN_LR)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    loss = train.contrastive_loss(model, ids, mask)
    loss.backward()
    ref_loss = plain_train_loss(ref_model, ids, mask)
    ref_loss.backward()
    res["first_step"] = {"loss": float(loss), "plain_loss": float(ref_loss),
                         "loss_rel_err": abs(float(loss) - float(ref_loss)) / abs(float(ref_loss))}
    errs = grad_errors(torch, list(model.named_parameters()), list(ref_model.named_parameters()))
    worst = max(errs, key=errs.get)
    res["first_step"]["grad_rel_err_max"] = errs[worst]
    res["first_step"]["grad_rel_err_worst_tensor"] = worst
    res["first_step"]["grad_rel_err"] = {k2: v2 for k2, v2 in sorted(errs.items(), key=lambda kv: -kv[1])[:8]}
    log(f"train step 1 against the plain step: {json.dumps(res['first_step'])}")
    if not res["first_step"]["loss_rel_err"] <= TRAIN_LOSS_RTOL:
        fail(f"train step 1 loss {float(loss)} against the plain step's {float(ref_loss)}")
    if not errs[worst] <= TRAIN_GRAD_RTOL:
        fail(f"train step 1 gradient of {worst}: {errs[worst]} of max|g| > {TRAIN_GRAD_RTOL}")
    del ref_model, ref_loss
    opt.step()
    opt.zero_grad()
    losses = [float(loss)]
    torch.cuda.synchronize()
    step_s = [time.perf_counter() - t0]
    torch.cuda.reset_peak_memory_stats()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    step_ms = []
    for _ in range(TRAIN_STEPS - 2):
        start.record()
        losses.append(float(train.train_step(model, opt, ids, mask)))
        end.record()
        end.synchronize()
        step_ms.append(start.elapsed_time(end))
    prof = profile_call(torch, lambda: losses.append(float(train.train_step(model, opt, ids, mask))), TRAIN_B,
                        keep_all=True)
    res["launches"] = kernels.launch_counts()
    res["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    on_card = {str(t.device) for t in (*model.parameters(), *opt.mu, *opt.nu, ids, mask)}
    flops = train_flops(cfg, TRAIN_B, TRAIN_L)
    ms = sum(step_ms) / len(step_ms)
    res.update({
        "losses": losses, "step_ms": step_ms, "ms_per_step": ms, "tokens_per_s": valid_tokens / (ms / 1e3),
        "rows_per_s": TRAIN_B / (ms / 1e3), "valid_tokens": valid_tokens, "flops_per_step": flops,
        "f32_peak_share": flops / (ms / 1e3) / PEAK_F32_PRODUCT, "profile": prof, "split": step_split(prof),
        "devices": sorted(on_card),
    })
    log(f"train: losses {losses}, {ms:.2f} ms a step (CUDA events), {res['tokens_per_s']:.0f} valid tokens/s, "
        f"peak {res['peak_mem_gb']:.2f} GB, share of the f32 product peak {res['f32_peak_share']:.3f}, "
        f"idle {prof['device_idle_share']:.3f}, split {json.dumps(res['split'])}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"train losses {losses}: not finite, or the last not below the first")
    if on_card != {str(dev)}:
        fail(f"train step tensors on {on_card}, want only {dev}")
    zero = [n for n in TRAIN_KERNELS if res["launches"][n] == 0]
    if zero:
        fail(f"kernels not launched on the train path: {zero}")
    # the loss tail: the loss's two launches and the pool backward, one each a step
    res["loss_tail_launches_per_step"] = {
        n: res["launches"][n] / TRAIN_STEPS for n in ("contrastive_loss", "contrastive_loss_bwd", "pool_normalize_bwd")}
    if any(v != 1 for v in res["loss_tail_launches_per_step"].values()):
        fail(f"loss tail launches a step {json.dumps(res['loss_tail_launches_per_step'])}: one each expected")
    del model, opt
    torch.cuda.empty_cache()

    # ---- dryrun_multichip(4) on a mesh that repeats the card
    kernels.reset_launch_counts()
    res["dryrun"] = train.dryrun_multichip(4, device=dev)
    res["dryrun_launches"] = kernels.launch_counts()
    res["wall_s"] = time.perf_counter() - t_phase
    return res


def embed_bwd_bytes(cfg, m: int, seq: int, distinct: int, types_used: int, id_bytes: int = 2,
                    type_bytes: int = 0) -> int:
    """Bytes K17's embedding form must move for ``m`` rows: each input read
    once (dy, the ids and type ids, gamma, and the table rows the rows
    gathered: ``distinct`` word rows, the ``seq`` position rows,
    ``types_used`` type rows) and each output written once, the dense
    gradient tables whole (vocab + max_len + type_vocab rows) beside dgamma
    and dbeta."""
    h = cfg.hidden
    reads = m * h * 4 + m * (id_bytes + type_bytes) + (distinct + seq + types_used) * h * 4 + h * 4
    writes = (cfg.vocab_size + cfg.max_len + cfg.type_vocab) * h * 4 + 2 * h * 4
    return reads + writes


def train_flops(cfg, B: int, L: int) -> float:
    """Operations of one contrastive step: the dense products forward (2
    flops a multiply-add) and backward (twice that), attention's two
    products forward and five backward over every key, and the loss's two
    [B, B] products."""
    M = B * L
    dense = 2 * M * (4 * cfg.hidden**2 + 2 * cfg.hidden * cfg.mlp_dim) * cfg.layers
    attn = 2 * B * cfg.heads * L * L * cfg.head_dim * 7 * cfg.layers
    return 3 * dense + attn + 3 * 2 * B * B * cfg.hidden


def step_split(prof: dict) -> dict:
    """A profiled step's device time by kind: the dense products (cuBLAS),
    the port's kernels (by source), the rest, and the idle share."""
    kinds = {"gemm": 0.0, "gemm_calls": 0, "forward_kernels": 0.0, "backward_kernels_K15_K18": 0.0,
             "adam_K19": 0.0, "other": 0.0}
    fwd = ("wgmma_kernel", "tf32_kernel", "bias_act", "add_ln", "embed_ln", "pool_norm")
    bwd = ("bwd_kernel", "dq_kernel", "dkv_kernel", "dx_kernel", "colsum", "loss_fwd_kernel", "pool_bwd")
    for row in prof.pop("all"):
        n = row["name"]
        if "gemm" in n or "sm90_xmma" in n or "cutlass" in n or "Kernel2" in n:
            kinds["gemm"] += row["ms"]
            kinds["gemm_calls"] += row["calls"]
        elif "adam_kernel" in n:
            kinds["adam_K19"] += row["ms"]
        elif any(s in n for s in bwd):
            kinds["backward_kernels_K15_K18"] += row["ms"]
        elif any(s in n for s in fwd):
            kinds["forward_kernels"] += row["ms"]
        else:
            kinds["other"] += row["ms"]
    kinds["idle_share"] = prof["device_idle_share"]
    kinds["wall_ms"] = prof["wall_ms"]
    return kinds


def phase_f32_vision(torch, dev) -> dict:
    """C8 end to end: the tiny f32 dual encoder (32-pixel images in 8-pixel
    patches, 2 layers, hidden 64, 2 heads, MLP 128, projection to 64; the
    text tower the same width) on the card, its image embeddings and
    logits against the same model through the kernels' plain versions
    (``plain_vision_forward``, ``plain_forward``, ``dual_logits_plain``),
    at F32_ATOL.  K8 and K9 run in their f32 forms."""
    import numpy as np

    from pathway_tpu_torch import DualEncoderModel, EncoderConfig, VisionConfig, kernels
    from pathway_tpu_torch.kernels import dual_logits_plain
    from pathway_tpu_torch.models import HashTokenizer

    f32 = torch.float32
    vcfg = VisionConfig(image_size=32, patch=8, hidden=64, layers=2, heads=2, mlp_dim=128, embed_dim=64,
                        dtype=f32)
    tcfg = EncoderConfig(hidden=64, layers=2, heads=2, mlp_dim=128, max_len=32, dtype=f32)
    model = DualEncoderModel(vcfg, tcfg, device=dev, seed=SEED)
    g = torch.Generator(device=dev).manual_seed(SEED + 9)
    images = torch.randint(0, 256, (24, 32, 32, 3), generator=g, device=dev, dtype=torch.uint8)
    tok = HashTokenizer(tcfg.vocab_size)
    ids, mask, _ = tok.encode_batch(synthetic_docs(np, 16, SEED + 9), max_len=tcfg.max_len)
    ids, mask = torch.from_numpy(ids).to(dev), torch.from_numpy(mask.astype(np.uint8)).to(dev)
    kernels.reset_launch_counts()
    with torch.inference_mode():
        img = model.embed_image(images)
        logits = model(images, ids, mask)
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        img_plain = plain_vision_forward(model.vision, images)
        txt_plain = plain_forward(model.text, ids, mask)
        logits_plain = dual_logits_plain(img_plain, txt_plain, model.logit_scale, model.logit_bias)
    res = {
        "images_max_abs_err": float((img - img_plain).abs().max()),
        "logits_max_abs_err": float((logits - logits_plain).abs().max()),
        "launches": launches,
    }
    if img.dtype != f32 or img.shape != (24, 64) or logits.shape != (24, 16):
        fail(f"f32 dual encoder: {img.dtype} {tuple(img.shape)}, logits {tuple(logits.shape)}")
    if not (bool(img.isfinite().all()) and bool(logits.isfinite().all())
            and res["images_max_abs_err"] <= F32_ATOL and res["logits_max_abs_err"] <= F32_ATOL):
        fail(f"f32 dual encoder against its plain path: {res} (tol {F32_ATOL})")
    path = ("patchify", "vision_head", "bias_act", "attention", "add_layer_norm", "embed_ln", "pool_normalize",
            "dual_logits")
    zero = [name for name in path if launches[name] == 0]
    if zero:
        fail(f"kernels not launched by the f32 dual encoder: {zero}")
    log(f"C8, the tiny f32 dual encoder against its plain path: {json.dumps(res)}")
    return res


def phase_engine(torch, dev, ctx: dict, encode_into_docs_per_s: float, smi: str) -> dict:
    """The host plane's engine core on the card (ROADMAP item 12): (a) the
    groupby first target and a join over 100,000 generated rows through
    ``pathway_tpu_torch.debug``, each against a plain-Python computation of
    the same result, with the port's own native module loaded; (b) phase
    3's 8,192 documents through ``table_from_pandas -> select(emb=
    TorchEncoderEmbedder(...)(text)) -> table_to_dicts`` at BGE-base width
    with phase 3's seeded weights, every row against ``TorchEncoder.encode``
    of the same text (phase 3's encoder) at phase 3's gates, K1 and K4-K7
    launched; the UDF's ``__batch__`` also from a worker thread."""
    import threading
    from collections import defaultdict

    import numpy as np

    import pathway_tpu_torch as pw
    from pathway_tpu_torch import BGE_BASE, TorchEncoderEmbedder, kernels
    from pathway_tpu_torch.internals import native

    res: dict = {}
    t_phase = time.perf_counter()
    mod = native.load()  # built with g++ from the package's own source at first use
    load_s = time.perf_counter() - t_phase
    build_dir = os.path.join(os.path.dirname(os.path.abspath(pw.__file__)), "native", "build")
    if mod is None or mod.__name__ != native.MODULE_NAME or os.path.dirname(os.path.abspath(mod.__file__)) != build_dir:
        fail(f"the port's native module is not loaded from its own build: {mod!r}")
    foreign = sorted(m for m in sys.modules if m == "pathway_native" or m.split(".")[0] in ("jax", "pathway_tpu"))
    if foreign:
        fail(f"modules of the JAX package loaded beside the port: {foreign}")
    res["native"] = {"module": mod.__name__, "file": os.path.relpath(mod.__file__), "load_s": load_s}
    rng = np.random.default_rng(SEED + 12)

    # ---- (a) the first target: markdown -> groupby -> reduce
    words = [f"w{int(i)}" for i in rng.integers(0, 50, ENGINE_MD_ROWS)]
    counts = rng.integers(1, 100, ENGINE_MD_ROWS)
    md = "word | cnt\n" + "\n".join(f"{w} | {int(c)}" for w, c in zip(words, counts))
    pw.G.clear()
    t = pw.debug.table_from_markdown(md)
    _, cols = pw.debug.table_to_dicts(t.groupby(t.word).reduce(t.word, total=pw.reducers.sum(t.cnt),
                                                                n=pw.reducers.count()))
    got = {cols["word"][k]: (cols["total"][k], cols["n"][k]) for k in cols["word"]}
    want: dict = defaultdict(lambda: (0, 0))
    for w, c in zip(words, counts):
        want[w] = (want[w][0] + int(c), want[w][1] + 1)
    if got != dict(want):
        fail("the groupby first target differs from its plain-Python result")
    res["first_target_groups"] = len(got)

    # ---- (a) a join over ENGINE_ROWS generated orders, then a groupby
    cust = rng.integers(0, ENGINE_CUSTOMERS, ENGINE_ROWS)
    amount = rng.integers(1, 1000, ENGINE_ROWS)
    region = {c: f"r{c % 7}" for c in range(ENGINE_CUSTOMERS)}
    pw.G.clear()
    t0 = time.perf_counter()
    orders = pw.debug.table_from_rows(pw.schema_from_types(order=int, customer=int, amount=int),
                                      [(i, int(c), int(a)) for i, (c, a) in enumerate(zip(cust, amount))])
    customers = pw.debug.table_from_rows(pw.schema_from_types(customer=int, region=str), list(region.items()))
    joined = orders.join(customers, orders.customer == customers.customer).select(
        orders.order, customers.region, orders.amount)
    by_region = joined.groupby(joined.region).reduce(joined.region, total=pw.reducers.sum(joined.amount),
                                                     n=pw.reducers.count())
    t1 = time.perf_counter()
    (jrows, _), (grows, _) = pw.debug._run_capture(joined, by_region)
    t2 = time.perf_counter()
    got_join = {v[0]: (v[1], v[2]) for v in jrows.values()}
    want_join = {i: (region[int(c)], int(a)) for i, (c, a) in enumerate(zip(cust, amount))}
    got_groups = {v[0]: (v[1], v[2]) for v in grows.values()}
    want_groups: dict = defaultdict(lambda: (0, 0))
    for c, a in zip(cust, amount):
        r = region[int(c)]
        want_groups[r] = (want_groups[r][0] + int(a), want_groups[r][1] + 1)
    if len(jrows) != ENGINE_ROWS or got_join != want_join or got_groups != dict(want_groups):
        fail("the join over generated rows differs from its plain-Python result")
    res["join"] = {"rows": ENGINE_ROWS, "customers": ENGINE_CUSTOMERS, "build_s": t1 - t0, "run_s": t2 - t1,
                   "rows_per_s": ENGINE_ROWS / (t2 - t1)}
    log(f"engine: join + groupby over {ENGINE_ROWS} rows: {json.dumps(res['join'])}")

    # ---- (b) the embedder as a UDF, through the engine, on the card
    import pandas as pd

    docs = ctx["docs"]
    embedder = TorchEncoderEmbedder("bge-base", config=BGE_BASE, max_batch_size=ENGINE_UDF_BATCH, seed=SEED,
                                    device=dev)
    pw.G.clear()
    t0 = time.perf_counter()
    table = pw.debug.table_from_pandas(pd.DataFrame({"doc_id": np.arange(len(docs)), "text": docs}))
    out = table.select(table.doc_id, emb=embedder(table.text))
    t1 = time.perf_counter()
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    keys, cols = pw.debug.table_to_dicts(out)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    res["launches"] = kernels.launch_counts()
    pw.G.clear()
    got = np.stack([np.asarray(cols["emb"][k], np.float32) for k in sorted(keys, key=lambda k: cols["doc_id"][k])])
    ref = ctx["embedder"].encoder.encode(docs)
    cos = (got * ref).sum(1) / np.linalg.norm(got, axis=1) / np.linalg.norm(ref, axis=1)
    res["udf"] = {
        "docs": len(keys), "max_batch_size": ENGINE_UDF_BATCH, "table_build_s": t1 - t0, "run_s": t3 - t2,
        "docs_per_s": len(keys) / (t3 - t2), "encode_into_docs_per_s": encode_into_docs_per_s,
        "max_abs_err": float(np.abs(got - ref).max()), "min_cos": float(cos.min()),
    }
    if got.shape != (len(docs), HIDDEN) or not np.isfinite(got).all():
        fail(f"embedder UDF: {got.shape} rows or non-finite values")
    if not (res["udf"]["min_cos"] >= EMBED_COS and res["udf"]["max_abs_err"] <= EMBED_ATOL):
        fail(f"embedder UDF against TorchEncoder.encode: {res['udf']} (cosine {EMBED_COS}, tol {EMBED_ATOL})")
    zero = [name for name in ("attention", "bias_act", "add_layer_norm", "embed_ln", "pool_normalize")
            if res["launches"][name] == 0]
    if zero:
        fail(f"kernels not launched by the embedder UDF: {zero}")
    log(f"engine: {len(keys)} docs through the embedder UDF at {res['udf']['docs_per_s']:.1f} docs/s "
        f"(phase 3's encode_into: {encode_into_docs_per_s:.1f} docs/s) on {smi}: {json.dumps(res['udf'])}")

    # the UDF's batch call from a worker thread, as the engine's workers
    # make it: its launches must reach the encoder's card
    box: dict = {}

    def work():
        try:
            box["rows"] = embedder.__batch__(docs[:DOC_BATCH])
        except BaseException as e:  # noqa: BLE001 - reported on the main thread
            box["error"] = e

    worker = threading.Thread(target=work)
    worker.start()
    worker.join(timeout=300)
    if worker.is_alive() or "error" in box:
        fail(f"embedder UDF from a worker thread: {box.get('error', 'timed out')!r}")
    err = float(np.abs(np.stack(box["rows"]) - got[:DOC_BATCH]).max())
    if not err <= EMBED_ATOL:
        fail(f"embedder UDF from a worker thread: {err} > {EMBED_ATOL}")
    res["udf"]["worker_thread_max_abs_err"] = err
    res["wall_s"] = time.perf_counter() - t_phase
    return res


def epoch_spans(tracing, since_ns: int) -> list:
    """(start, end) ns of the engine epochs since ``since_ns``, in order
    (the scheduler's ``epoch_process`` spans of a streaming run; where the
    engine cuts an epoch is its own choice, so an input time may span
    several)."""
    return sorted((int(e["ts"] * 1e3), int((e["ts"] + e["dur"]) * 1e3))
                  for e in tracing.chrome_events(since_ns=since_ns, all_spans=True) if e["name"] == "epoch_process")


def epoch_ms_of(spans: list, t_ns: int) -> float | None:
    """Wall ms of the epoch in ``spans`` that was running at ``t_ns``."""
    return next(((b - a) / 1e6 for a, b in spans if a <= t_ns <= b), None)


def replies_of(table_cols: list, rows: dict, by: str) -> dict:
    """A ``DataIndex`` reply table's rows as {row[by]: [(doc id, score,
    doc data), ...]}, best first (the data is the document row's columns
    as the index held them when it answered)."""
    from pathway_tpu_torch.stdlib.indexing.data_index import REPLY_DATA, REPLY_ID, REPLY_SCORE

    at = table_cols.index(by)
    ids, score, data = (table_cols.index(c) for c in (REPLY_ID, REPLY_SCORE, REPLY_DATA))
    return {values[at]: list(zip(values[ids], map(float, values[score]), values[data])) for values in rows.values()}


def phase_live_rag(torch, dev, ctx: dict, rerank: dict, smi: str, rates: dict) -> dict:
    """Phase 14: the live retrieval pipeline through ``DataIndex`` (ROADMAP
    items 14 and 13), each part a ``pw.debug`` run of the port's engine on
    the card.  (a) phase 3's 8,192 documents as an update stream (all of
    them, then 256 new texts and N_REMOVED deletes, which fill the delta
    segment past its cap: a background merge) into
    ``BruteForceKnnFactory(embedder=TorchEncoderEmbedder(BGE-base, phase 3's
    seed))`` over 1,048,576 slots, queried as of now by 32 questions in one
    epoch, 20 one-question epochs and LIVE_SELF unchanged documents' own
    texts, k=10; every reply against the direct path (the same batches
    through ``TorchEncoder.encode`` into a ``ShardedKnnIndex``), no deleted
    key, self-retrieval, a merge run, K1, K2, K3 and K4-K7 launched, and a
    profile of one query epoch.  (b) phase 4's 1,024 (question, candidate)
    pairs scored by ``CrossEncoderReranker`` as a UDF (phase 4's seed, chunks
    of 256) and kept by ``rerank_topk_filter`` as a UDF, against phase 4's
    ``__batch__`` scores; one head launch a chunk, no K4 tanh.  (c) 65,536
    mixture rows as a vector column into ``UsearchKnnFactory(nlist=1,024,
    nprobe=128)`` (the IVF trains inside the pipeline), 256 mixture queries
    at k=10: recall@10 against exact f32, K11 and K12 launched."""
    import numpy as np

    import pathway_tpu_torch as pw
    from pathway_tpu_torch import BGE_BASE, CrossEncoderReranker, ShardedKnnIndex, TorchEncoderEmbedder, kernels
    from pathway_tpu_torch.internals import tracing
    from pathway_tpu_torch.stdlib.indexing.adapters import IvfAdapter

    res: dict = {"card": smi, "beside": rates}
    launches: dict = {}
    t_phase = time.perf_counter()

    def count(now: dict) -> None:
        for name, n in now.items():
            launches[name] = launches.get(name, 0) + n

    def capture_adapters(inner) -> list:
        """Make ``inner`` keep the adapter it makes, with the host seconds
        its ``add`` and ``search`` take (``adapter.seconds``)."""
        made: list = []
        make = inner.make_adapter

        def keep():
            adapter = make()
            adapter.seconds = {"add": 0.0, "search": 0.0}
            adapter.calls = []  # (name, start ns, end ns, items), on the trace's clock
            for name in adapter.seconds:
                def timed(*args, _fn=getattr(adapter, name), _name=name):
                    t0 = tracing.now_ns()
                    try:
                        return _fn(*args)
                    finally:
                        t1 = tracing.now_ns()
                        adapter.seconds[_name] += (t1 - t0) / 1e9
                        adapter.calls.append((_name, t0, t1, len(args[0])))

                setattr(adapter, name, timed)
            made.append(adapter)
            return adapter

        inner.make_adapter = keep
        return made

    def stream_md(cols: tuple, rows: list):
        """A keyed update stream of ``rows`` (key first, then ``__time__``
        and ``__diff__``) through ``pw.debug``'s markdown reader, whose
        stream tables share one replay clock: epochs keep their order
        across tables."""
        lines = [" | ".join(("id", *cols, "__time__", "__diff__"))]
        lines += [" | ".join(str(v) for v in (row[0], *row)) for row in rows]
        return pw.debug.table_from_markdown("\n".join(lines))

    # ---- (a) brute force, live
    docs = ctx["docs"]
    n_docs = len(docs)
    rng = np.random.default_rng(SEED + 19)
    picked = [int(i) for i in rng.permutation(n_docs)]
    new_text = dict(zip(sorted(picked[:LIVE_UPSERTS]), synthetic_docs(np, LIVE_UPSERTS, SEED + 19)))
    removed = set(picked[LIVE_UPSERTS : LIVE_UPSERTS + N_REMOVED])
    final = {i: new_text.get(i, docs[i]) for i in range(n_docs) if i not in removed}
    unchanged = [i for i in range(n_docs) if i not in new_text and i not in removed]
    questions = synthetic_questions(np, [final[i] for i in sorted(final)], N_QUESTIONS + N_SINGLE, SEED + 20)
    self_ids = unchanged[:LIVE_SELF]

    class Recording(TorchEncoderEmbedder):
        """The embedder UDF, keeping each batch the engine hands it and its
        rows (the direct path encodes the same batches) and its time."""

        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            self.batches: list = []
            self.seconds = 0.0

        def __batch__(self, texts):
            t0 = time.perf_counter()
            rows = super().__batch__(texts)
            self.seconds += time.perf_counter() - t0
            self.batches.append(([str(t) for t in texts], np.stack(rows)))
            return rows

    embedder = Recording(model="bge-base", config=BGE_BASE, max_batch_size=ENGINE_UDF_BATCH, seed=SEED,
                         device=dev)
    doc_rows = [(i, docs[i], 2, 1) for i in range(n_docs)]
    for i, text in new_text.items():
        doc_rows += [(i, docs[i], 4, -1), (i, text, 4, 1)]
    doc_rows += [(i, docs[i], 4, -1) for i in sorted(removed)]
    q_text = dict(enumerate(questions[:N_QUESTIONS]))
    q_rows = [(j, q, 6, 1) for j, q in q_text.items()]
    for j, q in enumerate(questions[N_QUESTIONS:]):
        q_text[N_QUESTIONS + j] = q
        q_rows.append((N_QUESTIONS + j, q, 8 + 2 * j, 1))
    self_q = {}
    for j, i in enumerate(self_ids):
        qid = N_QUESTIONS + N_SINGLE + j
        q_text[qid], self_q[qid] = docs[i], i
        q_rows.append((qid, docs[i], 8 + 2 * N_SINGLE, 1))
    n_epochs = 2 + len({r[2] for r in q_rows})

    pw.G.clear()
    doc_t = stream_md(("doc_id", "text"), doc_rows)
    q_t = stream_md(("qid", "text"), q_rows)
    factory = pw.indexing.BruteForceKnnFactory(reserved_space=CAPACITY, metric="cos", embedder=embedder,
                                               delta_cap=LIVE_DELTA_CAP, device=dev)
    inner = factory.build_index(doc_t.text, doc_t)
    adapters = capture_adapters(inner)
    out = pw.indexing.DataIndex(doc_t, inner).query_as_of_now(q_t.text, number_of_matches=K)
    # the analyzer's capacity estimate of this graph at this run's sizes,
    # for phase_analysis to set beside the card's peak
    estimate = pw.estimate_memory(rows=len(doc_rows) + len(q_rows), distinct_keys=n_docs + len(q_text),
                                  str_bytes=int(np.mean([len(d) for d in docs])), array_bytes=4 * HIDDEN)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    allocated0 = torch.cuda.memory_allocated()
    kernels.reset_launch_counts()
    since = tracing.now_ns()
    t0 = time.perf_counter()
    ((rows, stream),) = pw.debug._run_capture(out)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    res["memory"] = {
        "estimate_bytes": estimate.total_bytes, "estimate_level": estimate.level,
        "estimate_params": dataclasses.asdict(estimate.params),
        "estimate_top": [(f"{o.name}#{o.node_id}", o.growth, o.total_bytes)
                         for o in sorted(estimate.operators, key=lambda o: -o.total_bytes)[:4]],
        "device_allocated_before_bytes": allocated0, "device_max_allocated_bytes": torch.cuda.max_memory_allocated(),
    }
    seg = adapters[0].index
    if seg._maintenance is not None:
        seg._maintenance.drain()  # a merge's launches count with the run's
    torch.cuda.synchronize()
    live_launches = kernels.launch_counts()
    count(live_launches)
    stats = adapters[0].stats()
    spans = epoch_spans(tracing, since)
    calls = adapters[0].calls
    added, ingest_end = 0, None
    for name, _a, end, n in calls:
        if name == "add" and ingest_end is None:
            added += n
            ingest_end = end if added >= n_docs else None
    if ingest_end is None:
        fail(f"live index: the index's adds hold {added} of {n_docs} documents")
    upsert = next(((a, b) for name, a, b, n in calls if name == "add" and b > ingest_end), None)
    query_ms: dict = {}
    for name, a, _b, n in calls:
        if name == "search":
            query_ms.setdefault(n, []).append(epoch_ms_of(spans, a))
    got = replies_of(out._column_names, rows, "qid")
    pw.G.clear()

    if len(got) != len(q_rows) or any(len(r) != K for r in got.values()):
        fail(f"live index: {len(got)} replies for {len(q_rows)} queries, or not {K} matches each")
    returned = [d for values in [v for _k, v, _t, diff in stream if diff > 0] for d in values[-1]]
    if any(d["doc_id"] in removed for d in returned):
        fail("live index: a deleted document was returned")
    if any(d["doc_id"] in new_text and d["text"] != new_text[d["doc_id"]] for d in returned):
        fail("live index: an upserted document was returned with its old text")
    self_fail = [(qid, got[qid][0][2]["doc_id"], got[qid][0][1]) for qid, i in self_q.items()
                 if got[qid][0][2]["doc_id"] != i or got[qid][0][1] < SELF_COS]
    if self_fail:
        fail(f"live index: unchanged documents not their own top-1: {self_fail[:5]}")
    if not (stats["merges_total"] >= 1 and stats["merge_failures"] == 0 and stats["size"] == len(final)):
        fail(f"live index: no background merge ran, or one failed, or the size is wrong: {stats}")

    # the direct path: the engine's batches through TorchEncoder.encode,
    # the final corpus into a ShardedKnnIndex on the same card
    first_q = next(b for b, (texts, _) in enumerate(embedder.batches) if questions[0] in texts)
    emb_err, doc_emb, want = 0.0, {}, {}
    direct = ShardedKnnIndex(HIDDEN, metric="cos", capacity=CAPACITY, device=dev)
    for b, (texts, udf_rows) in enumerate(embedder.batches):
        enc = embedder.encoder.encode(texts)
        emb_err = max(emb_err, float(np.abs(enc - udf_rows).max()))
        if b < first_q:
            doc_emb.update(zip(texts, enc))
        else:
            want.update(zip(texts, enc))
    ids = sorted(final)
    direct.add_batch(ids, np.stack([doc_emb[final[i]] for i in ids]))
    q_texts = list(want)
    want = dict(zip(q_texts, direct.search(np.stack([want[t] for t in q_texts]), K)))
    exact_sets = sum({d["doc_id"] for *_, d in got[qid]} == {k for k, _ in want[t]} for qid, t in q_text.items())
    worst = compare_rows([[(d["doc_id"], s) for _, s, d in got[qid]] for qid in sorted(q_text)],
                         [want[q_text[qid]] for qid in sorted(q_text)], K, TOPK_ATOL, "live index vs direct path")
    if not emb_err <= EMBED_ATOL:
        fail(f"live index: the UDF's rows differ from TorchEncoder.encode of the same batches by {emb_err}")
    del direct
    missing = [n for n in ("attention", "bias_act", "add_layer_norm", "embed_ln", "pool_normalize", "slab_scatter",
                           "slab_clear", "knn_topk") if live_launches[n] == 0]
    if missing:
        fail(f"kernels not launched by the live index: {missing}")
    singles = [ms for ms in query_ms.get(1, []) if ms is not None]
    if len(query_ms.get(1, [])) != N_SINGLE or len(query_ms.get(N_QUESTIONS, [])) != 1:
        fail(f"live index: searches by batch size {json.dumps({n: len(v) for n, v in query_ms.items()})}; "
             f"one of {N_QUESTIONS} and {N_SINGLE} of one expected")
    res["brute_force"] = {
        "docs": n_docs, "upserts": LIVE_UPSERTS, "deletes": N_REMOVED, "queries": len(q_rows),
        "input_times": n_epochs, "epochs": len(spans), "run_s": run_s,
        "epoch_ms": [(b - a) / 1e6 for a, b in spans], "stats": stats, "udf_batches": len(embedder.batches),
        "udf_s": embedder.seconds, "index_s": dict(adapters[0].seconds),
        # from the run's start to the end of the index's add of the last first-epoch document
        "ingest_docs_per_s": n_docs / ((ingest_end - since) / 1e9),
        "upsert_epoch_ms": epoch_ms_of(spans, upsert[0]) if upsert else None,
        "batched_epoch_ms": query_ms[N_QUESTIONS][0],
        "single_epoch_p50_ms": float(np.percentile(singles, 50)) if singles else None,
        "single_epoch_p99_ms": float(np.percentile(singles, 99)) if singles else None,
        "self_epoch_ms": query_ms.get(LIVE_SELF, [None])[0],
        "max_abs_err_vs_direct": worst, "exact_key_sets": exact_sets, "udf_vs_encode_max_abs_err": emb_err,
        "self_top1": len(self_q),
    }
    log(f"live index on {smi}: {n_docs} docs indexed at {res['brute_force']['ingest_docs_per_s']:.1f} docs/s "
        f"(the run's start to the index's add of the last one; phase 3's encode_into "
        f"{rates['encode_into_docs_per_s']:.1f}, the engine phase's UDF {rates['udf_docs_per_s']:.1f} docs/s); "
        f"{json.dumps(res['brute_force'])}")

    # one query epoch profiled: the 32 questions over the same index (the
    # adapter, merged, handed to a new pipeline with no document updates)
    pw.G.clear()
    d0 = pw.debug.table_from_rows(pw.schema_from_types(doc_id=int, text=str), [])
    q0 = pw.debug.table_from_rows(pw.schema_from_types(qid=int, text=str), list(q_text.items())[:N_QUESTIONS])
    inner0 = factory.build_index(d0.text, d0)
    inner0.make_adapter = lambda: adapters[0]
    out0 = pw.indexing.DataIndex(d0, inner0).query_as_of_now(q0.text, number_of_matches=K)
    box: dict = {}
    res["query_epoch_profile"] = profile_call(
        torch, lambda: box.update(rows=pw.debug._run_capture(out0)[0][0]), N_QUESTIONS)
    again = replies_of(out0._column_names, box["rows"], "qid")
    pw.G.clear()
    if any({k for k, *_ in again[j]} != {k for k, *_ in got[j]} for j in range(N_QUESTIONS)):
        fail("live index: the profiled query epoch answers differently from the pipeline's")
    log(f"live index: one query epoch ({N_QUESTIONS} questions) profiled on {smi}: idle "
        f"{res['query_epoch_profile']['device_idle_share']:.3f}, {json.dumps(res['query_epoch_profile'])}")
    seg.close()
    del adapters, embedder, seg
    torch.cuda.empty_cache()

    # ---- (b) rerank as UDFs
    pair_qs, pair_texts = rerank["_pairs"]
    want_scores = np.asarray(rerank["_pair_scores"], np.float32)
    class TimedReranker(CrossEncoderReranker):
        """The reranker UDF, with the time spent in its batch calls."""

        seconds = 0.0

        def __batch__(self, docs, queries):
            t0 = time.perf_counter()
            try:
                return super().__batch__(docs, queries)
            finally:
                self.seconds += time.perf_counter() - t0

    reranker = TimedReranker(max_batch_size=RERANK_BATCH, seed=SEED, device=dev)
    pw.G.clear()
    pairs_t = pw.debug.table_from_rows(
        pw.schema_from_types(pair=int, qi=int, question=str, doc=str),
        [(i, i // RERANK_K, q, d) for i, (q, d) in enumerate(zip(pair_qs, pair_texts))])
    scored = pairs_t.select(pairs_t.pair, pairs_t.qi, score=reranker(pairs_t.doc, pairs_t.question))
    by_q = scored.groupby(scored.qi).reduce(scored.qi, pairs=pw.reducers.tuple(scored.pair),
                                            scores=pw.reducers.tuple(scored.score))
    kept_t = by_q.select(by_q.qi, top=pw.rerank_topk_filter(by_q.pairs, by_q.scores, RERANK_KEEP))
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    tanh_before = kernels.bias_act.launches_by_act["tanh"]
    t0 = time.perf_counter()
    (srows, _), (krows, _) = pw.debug._run_capture(scored, kept_t)
    torch.cuda.synchronize()
    rr_s = time.perf_counter() - t0
    rr_launches = kernels.launch_counts()
    count(rr_launches)
    pw.G.clear()
    udf_s = reranker.seconds
    del reranker
    scores = np.zeros(len(pair_qs), np.float32)
    for pair, _qi, score in srows.values():
        scores[pair] = score
    err = np.abs(scores - want_scores)
    kept = {qi: set(top[0]) for qi, top in krows.values()}
    decided = 0
    for qi in range(N_QUESTIONS):
        sl = slice(qi * RERANK_K, (qi + 1) * RERANK_K)
        ranked = np.sort(want_scores[sl])[::-1]
        if ranked[RERANK_KEEP - 1] - ranked[RERANK_KEEP] <= 2 * err.max():
            continue  # a tie within the two runs' difference: either five is right
        decided += 1
        want_kept = set(pw.rerank_topk_filter.__wrapped_fun__(list(range(sl.start, sl.stop)), want_scores[sl].tolist(),
                                                                RERANK_KEEP)[0])
        if kept[qi] != want_kept:
            fail(f"rerank UDF: question {qi} keeps {sorted(kept[qi])}, phase 4's scores keep {sorted(want_kept)}")
    chunks = -(-len(pair_qs) // RERANK_BATCH)
    res["rerank"] = {
        "pairs": len(pair_qs), "chunks": chunks, "run_s": rr_s, "pairs_per_s": len(pair_qs) / rr_s,
        "udf_s": udf_s, "udf_pairs_per_s": len(pair_qs) / udf_s,
        "phase4_pairs_per_s": rerank["batched"]["pairs_per_s"], "max_abs_err_vs_phase4": float(err.max()),
        "questions": len(kept), "questions_decided": decided, "cross_head_launches": rr_launches["cross_head"],
        "bias_act_tanh_launches": kernels.bias_act.launches_by_act["tanh"] - tanh_before,
    }
    log(f"live rerank UDFs on {smi}: {json.dumps(res['rerank'])}")
    if len(srows) != len(pair_qs) or len(kept) != N_QUESTIONS or not np.isfinite(scores).all():
        fail(f"rerank UDF: {len(srows)} scores for {len(pair_qs)} pairs, {len(kept)} questions kept")
    if not err.max() <= SCORE_ATOL:
        fail(f"rerank UDF scores differ from phase 4's by {err.max()} > {SCORE_ATOL}")
    if res["rerank"]["cross_head_launches"] != chunks or res["rerank"]["bias_act_tanh_launches"]:
        fail(f"rerank UDF: {json.dumps(res['rerank'])}; one head launch a chunk and no K4 tanh expected")
    missing = [n for n in ("attention", "bias_act", "add_layer_norm", "embed_ln") if rr_launches[n] == 0]
    if missing:
        fail(f"kernels not launched by the rerank UDF: {missing}")
    torch.cuda.empty_cache()

    # ---- (c) IVF, live: the index trains inside the pipeline
    rows_ivf = mixture(np, LIVE_IVF_ROWS, HIDDEN, SEED, LIVE_IVF_ROWS)[0]
    qs_ivf = mixture(np, IVF_QUERIES, HIDDEN, SEED + 1, IVF_QUERIES)[0]
    pw.G.clear()
    # the rows are the run's first epoch (static), the queries its second
    vt = pw.debug.table_from_rows(pw.schema_from_types(row=int, v=np.ndarray), list(enumerate(rows_ivf)))
    q_schema = pw.schema_builder({"qid": pw.column_definition(dtype=int, primary_key=True),
                                  "v": pw.column_definition(dtype=np.ndarray)})
    qt = pw.debug.table_from_rows(q_schema, [(i, q, 2, 1) for i, q in enumerate(qs_ivf)], is_stream=True)
    inner = pw.indexing.UsearchKnnFactory(dimensions=HIDDEN, reserved_space=CAPACITY, nlist=LIVE_IVF_NLIST,
                                          nprobe=LIVE_IVF_NPROBE, device=dev).build_index(vt.v, vt)
    adapters = capture_adapters(inner)
    out = pw.indexing.DataIndex(vt, inner).query_as_of_now(qt.v, number_of_matches=K)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    since = tracing.now_ns()
    t0 = time.perf_counter()
    ((rows, _),) = pw.debug._run_capture(out)
    torch.cuda.synchronize()
    ivf_s = time.perf_counter() - t0
    ivf_launches = kernels.launch_counts()
    count(ivf_launches)
    got = replies_of(out._column_names, rows, "qid")
    main = adapters[0].index.main
    ivf_seconds = dict(adapters[0].seconds)
    ivf_query_ms = [epoch_ms_of(epoch_spans(tracing, since), a) for name, a, _b, _n in adapters[0].calls
                    if name == "search"]
    pw.G.clear()
    if not isinstance(adapters[0], IvfAdapter) or not main.trained or (main.nlist, main.nprobe) != (
            LIVE_IVF_NLIST, LIVE_IVF_NPROBE):
        fail(f"live IVF: {type(adapters[0]).__name__}, trained {main.trained}, nlist/nprobe "
             f"{main.nlist}/{main.nprobe}")
    x = torch.from_numpy(rows_ivf).to(dev)
    q = torch.from_numpy(qs_ivf).to(dev)
    truth = (torch.nn.functional.normalize(q, dim=1) @ torch.nn.functional.normalize(x, dim=1).T).topk(K).indices
    truth = truth.cpu().numpy()
    del x, q
    if len(got) != IVF_QUERIES:
        fail(f"live IVF: {len(got)} replies for {IVF_QUERIES} queries")
    hits = sum(len({d["row"] for *_, d in got[i]} & set(truth[i].tolist())) for i in range(IVF_QUERIES))
    res["ivf"] = {
        "rows": LIVE_IVF_ROWS, "queries": IVF_QUERIES, "nlist": main.nlist, "nprobe": main.nprobe,
        "cell_cap": main.cell_cap, "run_s": ivf_s, "query_epoch_ms": ivf_query_ms, "index_s": ivf_seconds,
        "ingest_rows_per_s": LIVE_IVF_ROWS / ivf_seconds["add"],
        "recall_at_10": hits / (IVF_QUERIES * K), "ivf_assign_launches": ivf_launches["ivf_assign"],
        "ivf_scan_launches": ivf_launches["ivf_scan"],
    }
    log(f"live IVF on {smi}: {json.dumps(res['ivf'])}")
    if not res["ivf"]["recall_at_10"] >= IVF_RECALL:
        fail(f"live IVF recall@{K} {res['ivf']['recall_at_10']:.4f} < {IVF_RECALL}")
    missing = [n for n in ("ivf_assign", "ivf_scan", "slab_scatter", "knn_topk") if ivf_launches[n] == 0]
    if missing:
        fail(f"kernels not launched by the live IVF: {missing}")
    adapters[0].index.close()
    del adapters, main
    torch.cuda.empty_cache()
    res["launches"] = launches
    res["wall_s"] = time.perf_counter() - t_phase
    return res


def phase_rag_server(torch, dev, ctx: dict, smi: str, rates: dict) -> dict:
    """Phase 15: the RAG server (ROADMAP item 15) on the card, through the
    entry points a user calls.  The first N_SERVER_DOCS of phase 3's
    documents are written as files (``modified_at`` SERVER_MTIME0 + i) and
    read by ``pw.io.fs.read(format="binary", mode="streaming",
    with_metadata=True)`` into ``VectorStoreServer`` (phase 3's BGE-base
    weights as ``TorchEncoderEmbedder``, a 1,048,576-slot
    ``BruteForceKnnFactory``, ``TokenCountSplitter(16, 128)``); a
    ``BaseRAGQuestionAnswerer`` over the same store with a stand-in chat (a
    digest of its messages) serves ``QASummaryRestServer`` on a second
    port; one ``run(threaded=True)`` of the ``DocumentStoreServer`` that
    ``server.run_server`` builds starts both on 127.0.0.1, once
    ``analyse_before_run`` has read the whole graph.
    Checks: the statistics reach N_SERVER_DOCS; some documents split; 64
    one-question ``/v1/retrieve`` requests at k=10 and 64 documents queried
    by their first chunk (its own top-1), each reply against the direct
    path (the engine's own batches through ``TorchEncoder.encode`` into a
    ``ShardedKnnIndex`` on the card: ``compare_rows`` at TOPK_ATOL); 32
    requests from 8 client threads, against the direct path and against
    the one-at-a-time replies (``compare_rows`` at EMBED_ATOL: a query
    batched with others embeds in another batch shape); ``/v1/inputs`` with
    a glob, ``/v1/retrieve`` with a glob and with a metadata filter,
    against a Python filter over the files (the index's over-fetch of 4k,
    then the filter, then k); 8 ``/v1/pw_ai_answer`` requests whose context
    docs equal ``/v1/retrieve`` at ``search_topk`` and whose response is
    the stand-in's digest; a live change (files added, rewritten and
    deleted in place) visible within SERVER_DEADLINE_S; K1, K4-K7, K2 and
    K3 launched between the server's start and the end of the live change;
    the scheduler stops and its thread joins."""
    import fnmatch
    import hashlib
    import shutil
    import socket
    import tempfile
    import threading
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    import pathway_tpu_torch as pw
    from pathway_tpu_torch import BGE_BASE, ShardedKnnIndex, TorchEncoderEmbedder, kernels
    from pathway_tpu_torch.xpacks.llm import prompts
    from pathway_tpu_torch.xpacks.llm.llms import BaseChat, prompt_chat_single_qa
    from pathway_tpu_torch.xpacks.llm.question_answering import BaseRAGQuestionAnswerer
    from pathway_tpu_torch.xpacks.llm.servers import DocumentStoreServer
    from pathway_tpu_torch.xpacks.llm.splitters import TokenCountSplitter
    from pathway_tpu_torch.xpacks.llm.vector_store import VectorStoreClient, VectorStoreServer

    res: dict = {"card": smi, "beside": rates}
    t_phase = time.perf_counter()
    port, qa_port = free_port(), free_port()

    # ---- the files, and what the splitter makes of them
    docs = list(ctx["docs"][:N_SERVER_DOCS])
    root = tempfile.mkdtemp(prefix="rag_server_")

    def path_of(i: int) -> str:
        return os.path.join(root, f"doc{i:05d}.txt")

    def write(i: int, text: str, mtime: int | None = None) -> None:
        with open(path_of(i), "w") as f:
            f.write(text)
        if mtime is not None:
            os.utime(path_of(i), (mtime, mtime))

    for i, text in enumerate(docs):
        write(i, text, SERVER_MTIME0 + i)
    splitter = TokenCountSplitter(min_tokens=SERVER_SPLIT[0], max_tokens=SERVER_SPLIT[1])

    def chunks_of(text: str) -> list:
        return [c for c, _ in splitter.__wrapped__(text)]

    doc_chunks = [chunks_of(t) for t in docs]
    key_info = [(path_of(i), c) for i, cs in enumerate(doc_chunks) for c in cs]
    key_of = {info: g for g, info in enumerate(key_info)}

    def keyed(hits: list) -> list:
        """A reply's chunks as [(chunk key, score), ...]."""
        return [(key_of[(d["metadata"]["path"], d["text"])], d["score"]) for d in hits]
    res["chunks"] = len(key_info)
    res["split_docs"] = sum(len(cs) > 1 for cs in doc_chunks)
    if not res["split_docs"]:
        fail(f"rag server: no document of {N_SERVER_DOCS} splits into two or more chunks")

    lock = threading.Lock()

    class Recording(TorchEncoderEmbedder):
        """The embedder UDF, keeping each batch the engine hands it (texts,
        rows, thread) in order; the direct path encodes the same batches."""

        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            self.batches: list = []

        def __batch__(self, texts):
            rows = super().__batch__(texts)
            with lock:
                self.batches.append(([str(t) for t in texts], np.stack(rows), threading.current_thread().name))
            return rows

    class DigestChat(BaseChat):
        """A stand-in chat: the digest of its messages."""

        def __wrapped__(self, messages, **kwargs):
            return "digest:" + hashlib.sha256(json.dumps(messages).encode()).hexdigest()[:16]

    embedder = Recording(model="bge-base", config=BGE_BASE, max_batch_size=ENGINE_UDF_BATCH, seed=SEED, device=dev)
    if embedder.encoder.device != dev:
        fail(f"rag server: the embedder's encoder is on {embedder.encoder.device}, not {dev}")
    pw.G.clear()
    files = pw.io.fs.read(root, format="binary", mode="streaming", with_metadata=True)
    server = VectorStoreServer(
        files,
        index_factory=pw.indexing.BruteForceKnnFactory(embedder=embedder, reserved_space=CAPACITY, device=dev),
        splitter=splitter,
    )
    adapters: list = []
    inner = server.document_store.index.inner
    make = inner.make_adapter

    def keep_adapter():
        adapters.append(make())
        return adapters[-1]

    inner.make_adapter = keep_adapter
    rag = BaseRAGQuestionAnswerer(DigestChat(), server.document_store, search_topk=SERVER_QA_TOPK)
    rag.build_server("127.0.0.1", qa_port)
    client = VectorStoreClient(port=port, timeout=SERVER_DEADLINE_S)
    qa = VectorStoreClient(port=qa_port, timeout=SERVER_DEADLINE_S)

    def timed(fn, *args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        return out, (time.perf_counter() - t0) * 1e3

    def stats_count():
        try:
            return client.get_vectorstore_statistics()["file_count"]
        except OSError:
            return None

    # what ``server.run_server`` does, in its two steps: the REST routes
    # join the graph, then pw.run starts it; the graph is analysed between
    rest = DocumentStoreServer("127.0.0.1", port, server.document_store)
    res["analysis"] = analyse_before_run(pw)
    strict_env = os.environ.get("PATHWAY_STRICT")
    if res["analysis"]["strict"]["started"]:
        os.environ["PATHWAY_STRICT"] = "1"  # the server's own pw.run refuses the graph on an error finding
    pw.G.active_scheduler = None
    mport = free_port()
    mport_env = os.environ.get("PATHWAY_MONITORING_HTTP_PORT")
    os.environ["PATHWAY_MONITORING_HTTP_PORT"] = str(mport)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t_start = time.perf_counter()
    # what ``rest.run(threaded=True)`` does, with the monitoring server on
    thread = threading.Thread(target=pw.run, kwargs={"with_http_server": True}, daemon=True, name="pw_server")
    thread.start()
    try:
        # ---- ready: every file in the statistics (an epoch after the
        # files' epoch, whose index updates are done by then)
        deadline = t_start + SERVER_DEADLINE_S
        while stats_count() != N_SERVER_DOCS:
            if time.perf_counter() > deadline or not thread.is_alive():
                fail(f"rag server: the statistics did not reach {N_SERVER_DOCS} files in {SERVER_DEADLINE_S} s")
            time.sleep(0.02)
        res["ingest_s"] = time.perf_counter() - t_start
        res["ingest_docs_per_s"] = N_SERVER_DOCS / res["ingest_s"]
        ingest_batches = len(embedder.batches)
        # the run executes the plan that explain() printed
        plan, sched = pw.G.last_plan, pw.G.active_scheduler
        if plan is None or plan.level != res["analysis"]["level"] or sched.execution_plan is not plan:
            fail(f"rag server: pw.run did not execute the optimize={res['analysis']['level']} plan ({plan!r})")
        if plan.format() != res["analysis"]["plan"] or sched.plan_counters != res["analysis"]["counters"]:
            fail("rag server: the plan pw.run executes is not the one pw.explain() printed")
        if sched.analysis_findings != res["analysis"]["by_severity"]:
            fail(f"rag server: pw.run counted findings {sched.analysis_findings}, pw.analyze() "
                 f"{res['analysis']['by_severity']}")
        # ---- the monitoring server, scraped once while the server runs
        status_raw, status_ms = scrape(mport, "/status")
        status = json.loads(status_raw)
        res["monitoring"] = {"port": mport, "status_ms": status_ms, "status_bytes": len(status_raw),
                             "epoch": status["epoch"], "operators": status["operators"],
                             "device_counters": status["device"].get("counters"), "serving": status["serving"],
                             "serving_imported": "pathway_tpu_torch.serving" in sys.modules}
        if status["operators"] != len(sched.graph.nodes) or not status["index"]:
            fail(f"rag server: /status reads {status['operators']} operators and {len(status['index'])} indexes, "
                 f"the run has {len(sched.graph.nodes)} nodes")
        res["indexes"] = len(adapters)
        for a in adapters:
            main = a.index.main
            if getattr(main, "device", dev) != dev:
                fail(f"rag server: an index is on {main.device}, not {dev}")

        # ---- one question at a time, then the documents by their first chunk
        rng = np.random.default_rng(SEED + 21)
        questions = synthetic_questions(np, docs, SERVER_QUESTIONS + SERVER_CONCURRENT, SEED + 21)
        rounds: dict = {}

        def served(name: str, texts: list, ask) -> list:
            start = len(embedder.batches)
            out = [timed(ask, t) for t in texts]
            rounds[name] = (texts, [o for o, _ in out], start, len(embedder.batches))
            return [ms for _, ms in out]

        single_ms = served("single", questions[:SERVER_QUESTIONS], lambda q: client.query(q, k=K))
        self_docs = [int(i) for i in rng.choice(N_SERVER_DOCS, SERVER_QUESTIONS, replace=False)]
        served("self", [doc_chunks[i][0] for i in self_docs], lambda q: client.query(q, k=K))
        bad_self = [i for i, hits in zip(self_docs, rounds["self"][1])
                    if (hits[0]["metadata"]["path"], hits[0]["text"]) != (path_of(i), doc_chunks[i][0])]
        if bad_self:
            fail(f"rag server: documents not their first chunk's top-1: {bad_self[:5]}")

        # ---- concurrent requests
        conc = questions[SERVER_QUESTIONS:SERVER_QUESTIONS + SERVER_CONCURRENT]
        start = len(embedder.batches)
        with ThreadPoolExecutor(max_workers=SERVER_CLIENTS) as pool:
            conc_out = list(pool.map(lambda q: timed(client.query, q, k=K), conc))
        rounds["concurrent"] = (conc, [o for o, _ in conc_out], start, len(embedder.batches))
        conc_ms = [ms for _, ms in conc_out]
        alone = [client.query(q, k=K) for q in conc]

        # ---- filters
        def glob_ok(path: str) -> bool:
            return fnmatch.fnmatch(path, SERVER_GLOB)

        def mtime_ok(path: str) -> bool:
            return os.stat(path).st_mtime < SERVER_MTIME0 + 1024

        listed = client.get_input_files(filepath_globpattern=SERVER_GLOB)
        want_listed = {path_of(i): SERVER_MTIME0 + i for i in range(N_SERVER_DOCS) if glob_ok(path_of(i))}
        if {m["path"]: m["modified_at"] for m in listed} != want_listed or len(listed) != len(want_listed):
            fail(f"rag server: /v1/inputs with {SERVER_GLOB!r} lists {len(listed)} files, not the "
                 f"{len(want_listed)} the glob matches")
        served("glob", questions[:SERVER_FILTERED], lambda q: client.query(q, k=K, filepath_globpattern=SERVER_GLOB))
        served("filter", questions[:SERVER_FILTERED], lambda q: client.query(q, k=K, metadata_filter=SERVER_FILTER))
        for name, ok in (("glob", glob_ok), ("filter", mtime_ok)):
            if any(not ok(d["metadata"]["path"]) for hits in rounds[name][1] for d in hits):
                fail(f"rag server: /v1/retrieve with the {name} returned a file the {name} excludes")

        # ---- question answering: context docs against /v1/retrieve at search_topk
        qa_out = [timed(qa._post, "/v1/pw_ai_answer", {"prompt": q, "return_context_docs": True})
                  for q in questions[:SERVER_QA]]
        qa_ms = [ms for _, ms in qa_out]
        for q, (answer, _ms) in zip(questions[:SERVER_QA], qa_out):
            ctx_docs = answer["context_docs"]
            again = qa.query(q, k=SERVER_QA_TOPK)
            compare_rows([keyed(ctx_docs)], [keyed(again)], SERVER_QA_TOPK, TOPK_ATOL,
                         "rag server: QA context docs vs /v1/retrieve")
            digest = DigestChat().__wrapped__(prompt_chat_single_qa(prompts.prompt_qa_geometric_rag(q, ctx_docs)))
            if answer["response"] != digest:
                fail(f"rag server: the QA response {answer['response']!r} is not the stand-in's {digest!r}")

        # ---- one served question profiled
        res["served_profile"] = profile_call(torch, lambda: client.query(questions[0], k=K), 1)

        # ---- the live change, in place
        n0 = N_SERVER_DOCS
        changed = [int(i) for i in rng.permutation(N_SERVER_DOCS)[:SERVER_REWRITTEN + SERVER_DELETED]]
        rewritten, deleted = changed[:SERVER_REWRITTEN], changed[SERVER_REWRITTEN:]
        new_docs = dict(zip(range(n0, n0 + SERVER_ADDED), synthetic_docs(np, SERVER_ADDED, SEED + 24)))
        new_docs.update(zip(rewritten, synthetic_docs(np, SERVER_REWRITTEN, SEED + 25)))
        old_first = {i: doc_chunks[i][0] for i in rewritten + deleted}
        old_chunks = {(path_of(i), c) for i in rewritten + deleted for c in doc_chunks[i]}
        t_change = time.perf_counter()
        for i, text in new_docs.items():
            write(i, text)
        for i in deleted:
            os.remove(path_of(i))
        want_count = N_SERVER_DOCS + SERVER_ADDED - SERVER_DELETED

        def live_failures(new_ids: list, old_ids: list) -> list:
            """New and rewritten documents not their first chunk's top-1;
            old texts whose query returns a chunk of a file's old text."""
            out = []
            for i in new_ids:
                first = chunks_of(new_docs[i])[0]
                hits = client.query(first, k=K)
                if (hits[0]["metadata"]["path"], hits[0]["text"]) != (path_of(i), first):
                    out.append(("not its own top-1", i))
            for i in old_ids:
                if any((d["metadata"]["path"], d["text"]) in old_chunks for d in client.query(old_first[i], k=K)):
                    out.append(("old text returned", i))
            return out

        visible_s, checks = None, 0
        while True:
            if time.perf_counter() - t_change > SERVER_DEADLINE_S:
                fail(f"rag server: the live change was not visible in {SERVER_DEADLINE_S} s "
                     f"(statistics {stats_count()}, expected {want_count})")
            if stats_count() == want_count and not live_failures([n0, rewritten[0]], [rewritten[0], deleted[0]]):
                visible_s = visible_s or time.perf_counter() - t_change
                checks += 1
                if not live_failures(list(new_docs), list(old_first)):
                    break
            time.sleep(0.05)
        res["live_change"] = {"added": SERVER_ADDED, "rewritten": SERVER_REWRITTEN, "deleted": SERVER_DELETED,
                              "visible_s": visible_s, "full_checks": checks, "files": want_count}
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
    finally:
        if strict_env is None:
            os.environ.pop("PATHWAY_STRICT", None)
        else:
            os.environ["PATHWAY_STRICT"] = strict_env
        if mport_env is None:
            os.environ.pop("PATHWAY_MONITORING_HTTP_PORT", None)
        else:
            os.environ["PATHWAY_MONITORING_HTTP_PORT"] = mport_env
        sched = getattr(pw.G, "active_scheduler", None)
        if sched is not None:
            sched.stop()
        thread.join(timeout=SERVER_DEADLINE_S)
        run_ctx = getattr(pw.G, "last_run_ctx", None)
        pw.G.clear()
        shutil.rmtree(root, ignore_errors=True)
    if thread.is_alive():
        fail("rag server: the scheduler's thread did not join after stop()")
    try:
        socket.create_connection(("127.0.0.1", mport), timeout=2).close()
        fail("rag server: the monitoring server outlived its run")
    except OSError:
        pass
    res["columnar_rows"] = dict(run_ctx.stats.get("columnar_rows", {})) if run_ctx is not None else None
    ops = run_ctx.stats.get("operators", {}).values() if run_ctx is not None else ()
    res["operators_top"] = [(p["name"], round(p["total_ms"], 1), p["epochs"], p["rows_in"])
                            for p in sorted(ops, key=lambda p: -p["total_ms"])[:10]]
    res["launches"] = launches
    missing = [n for n in ("attention", "bias_act", "add_layer_norm", "embed_ln", "pool_normalize", "slab_scatter",
                           "knn_topk") if launches[n] == 0]
    if missing:
        fail(f"kernels not launched by the RAG server: {missing}")

    # ---- the direct path: the engine's own batches through TorchEncoder.encode
    # into a ShardedKnnIndex on the same card
    encoder = embedder.encoder
    emb_err, doc_emb, encoded = 0.0, {}, {}
    for texts, rows, _thread in embedder.batches[:ingest_batches]:
        # each index side embeds the same batches: encode each batch once
        batch = tuple(texts)
        if batch not in encoded:
            encoded[batch] = encoder.encode(texts)
            doc_emb.update(zip(texts, encoded[batch]))
        emb_err = max(emb_err, float(np.abs(encoded[batch] - rows).max()))
    embedded = sorted(t for texts, _, _ in embedder.batches[:ingest_batches] for t in texts)
    if embedded != sorted(c for _, c in key_info for _ in range(res["indexes"])):
        fail(f"rag server: the index sides embedded {len(embedded)} chunk rows, not the splitter's "
             f"{len(key_info)} chunks once an index ({res['indexes']} indexes)")
    direct = ShardedKnnIndex(HIDDEN, metric="cos", capacity=CAPACITY, device=dev)
    direct.add_batch(list(range(len(key_info))), np.stack([doc_emb[c] for _, c in key_info]))
    direct_ms = []
    worst = 0.0
    for name, (texts, replies, b0, b1) in rounds.items():
        q_emb = {}
        for b_texts, rows, _thread in embedder.batches[b0:b1]:
            enc = encoder.encode(b_texts)
            emb_err = max(emb_err, float(np.abs(enc - rows).max()))
            q_emb.update(zip(b_texts, enc))
        missing_q = [t for t in texts if t not in q_emb]
        if missing_q:
            fail(f"rag server: {len(missing_q)} {name} queries not found among the engine's batches")
        fetch = K * 4 if name in ("glob", "filter") else K
        want = direct.search(np.stack([q_emb[t] for t in texts]), fetch)
        got_rows = [keyed(hits) for hits in replies]
        if name in ("glob", "filter"):
            ok = glob_ok if name == "glob" else (lambda path: int(path[-9:-4]) < 1024)
            want = [[(k, s) for k, s in row if ok(key_info[k][0])][:K] for row in want]
            if [len(r) for r in got_rows] != [len(r) for r in want]:
                fail(f"rag server: /v1/retrieve with the {name} gives {[len(r) for r in got_rows]} results, "
                     f"the Python filter over the direct path {[len(r) for r in want]}")
            for g, w in zip(got_rows, want):
                if w:
                    worst = max(worst, compare_rows([g], [w], len(w), TOPK_ATOL, f"rag server {name} vs direct path"))
        else:
            worst = max(worst, compare_rows(got_rows, want, K, TOPK_ATOL, f"rag server {name} vs direct path"))
    for q in questions[:SERVER_QUESTIONS]:
        t0 = time.perf_counter()
        direct.search(encoder.encode([q]), K)
        torch.cuda.synchronize()
        direct_ms.append((time.perf_counter() - t0) * 1e3)
    if not emb_err <= EMBED_ATOL:
        fail(f"rag server: the UDF's rows differ from TorchEncoder.encode of the same batches by {emb_err}")
    conc_vs_alone = compare_rows([keyed(hits) for hits in rounds["concurrent"][1]], [keyed(hits) for hits in alone],
                                 K, EMBED_ATOL, "rag server: concurrent vs one at a time")
    del direct
    torch.cuda.empty_cache()

    def pct(xs, p):
        return float(np.percentile(xs, p))

    threads_seen = sorted({b[2] for b in embedder.batches})
    res.update({
        "docs": N_SERVER_DOCS, "questions": SERVER_QUESTIONS, "k": K,
        "http_single_p50_ms": pct(single_ms, 50), "http_single_p99_ms": pct(single_ms, 99),
        "http_concurrent_p50_ms": pct(conc_ms, 50), "http_concurrent_p99_ms": pct(conc_ms, 99),
        "concurrent": {"requests": SERVER_CONCURRENT, "clients": SERVER_CLIENTS},
        "direct_query_p50_ms": pct(direct_ms, 50), "direct_query_p99_ms": pct(direct_ms, 99),
        "qa_p50_ms": pct(qa_ms, 50), "qa_requests": SERVER_QA,
        "max_abs_err_vs_direct": worst, "rule": "batches recovered: compare_rows at TOPK_ATOL",
        "concurrent_vs_alone_max_abs_err": conc_vs_alone, "udf_vs_encode_max_abs_err": emb_err,
        "udf_batches": len(embedder.batches), "distinct_ingest_batches": len(encoded), "udf_threads": threads_seen,
        "chunk_rows_embedded_per_s": len(embedded) / res["ingest_s"],
    })
    res["wall_s"] = time.perf_counter() - t_phase
    log(f"rag server on {smi}: {N_SERVER_DOCS} files searchable {res['ingest_s']:.2f} s after the run's start, "
        f"{res['ingest_docs_per_s']:.1f} docs/s ({res['chunks']} chunks, {res['indexes']} indexes; phase 3's "
        f"encode_into {rates['encode_into_docs_per_s']:.1f}, phase 13's UDF {rates['udf_docs_per_s']:.1f}, "
        f"phase 14's live ingest {rates['live_ingest_docs_per_s']:.1f} docs/s)")
    log(f"rag server on {smi}: HTTP one question p50 {res['http_single_p50_ms']:.2f} ms, p99 "
        f"{res['http_single_p99_ms']:.2f}; {SERVER_CONCURRENT} from {SERVER_CLIENTS} clients p50 "
        f"{res['http_concurrent_p50_ms']:.2f}, p99 {res['http_concurrent_p99_ms']:.2f}; direct path "
        f"(encode + search) p50 {res['direct_query_p50_ms']:.2f} ms; QA p50 {res['qa_p50_ms']:.2f} ms")
    mo = res["monitoring"]
    log(f"rag server on {smi}: /status scraped mid-run in {mo['status_ms']:.2f} ms ({mo['status_bytes']} B): epoch "
        f"{mo['epoch']}, {mo['operators']} operators, device counters {json.dumps(mo['device_counters'])}; "
        f"serving layer imported: {mo['serving_imported']}")
    log(f"rag server on {smi}: one served question idle {res['served_profile']['device_idle_share']:.3f}; "
        f"live change visible in {res['live_change']['visible_s']:.2f} s; phase wall {res['wall_s']:.1f} s; "
        f"{json.dumps({k: v for k, v in res.items() if k not in ('launches', 'beside', 'card')})}")
    return res


def analyse_before_run(pw) -> dict:
    """The pre-flight of the captured graph, as a user reads it before
    starting it: ``pw.analyze()``'s findings by severity and code,
    ``pw.explain()``'s plan (the columnar decision of each node, the
    rewrite counters), each timed.  Then strict mode: a graph with an
    error finding must be refused by ``pw.run(strict=True)`` before any
    source starts (the refusal's findings are kept); a clean one is for the
    caller to start with ``PATHWAY_STRICT=1`` (``strict.started``)."""
    from pathway_tpu_torch.analysis import SEV_ERROR, AnalysisError, count_by_severity, resolve_level

    level = resolve_level(None)  # pw.run's: PATHWAY_OPTIMIZE, else 2
    t0 = time.perf_counter()
    diags = pw.analyze(optimize=level)
    t1 = time.perf_counter()
    plan = pw.explain()
    t2 = time.perf_counter()
    by_code: dict = {}
    for d in diags:
        by_code[d.code] = by_code.get(d.code, 0) + 1
    out = {
        "level": level, "by_severity": count_by_severity(diags), "by_code": dict(sorted(by_code.items())),
        "analyze_ms": (t1 - t0) * 1e3, "explain_ms": (t2 - t1) * 1e3,
        "nodes": [plan.nodes_before, plan.nodes_after], "counters": plan.counters(),
        "columnar": plan.columnar_lines(), "plan": plan.format(),
        "columnar_nodes": sum(p == "columnar" for _n, p, _r in plan.columnar),
    }
    errors = [d for d in diags if d.severity == SEV_ERROR]
    if not errors:
        out["strict"] = {"started": True}
        return out
    pw.G.active_scheduler = None
    try:
        pw.run(strict=True, monitoring_level=pw.MonitoringLevel.NONE)
    except AnalysisError as e:
        refused = [d.format() for d in e.diagnostics if d.severity == SEV_ERROR]
    else:
        fail("pw.run(strict=True) ran a graph with error findings")
    if pw.G.active_scheduler is not None:
        fail("pw.run(strict=True) built a scheduler before it refused the graph")
    if sorted(refused) != sorted(d.format() for d in errors):
        fail("pw.run(strict=True) refused with other findings than pw.analyze() gives")
    out["strict"] = {"started": False, "refused_by": refused}
    return out


def phase_analysis(torch, dev, rag: dict, live: dict, smi: str) -> dict:
    """Phase 16: the analyzer and the plan compiler (slice 16a) on the
    card's machine.  (a) Phase 15's pre-flight and its run through the
    rewritten plan.  (b) Phase 13's join + groupby over ENGINE_ROWS orders
    and ENGINE_CUSTOMERS customers, written as JSON-lines files and read
    by ``pw.io.jsonlines.read(mode="static")`` (the orders through a
    filter that keeps every row, which the plan can run on frames), run by
    ``pw.run(optimize=...)`` at the levels of ANALYSIS_LEVELS in turns:
    rows/s at each level, the scheduler's ``columnar_rows`` (columnar rows
    at 2 or the phase fails), the plan's counters, both levels equal to
    each other and to plain Python.  (c) A11's ``device_profile()`` over
    the installed port (an unwaived error fails).  (d) Phase 14's
    ``estimate_memory`` beside the card's peak while that graph ran."""
    import shutil
    import tempfile
    from collections import defaultdict

    import numpy as np

    import pathway_tpu_torch as pw
    from pathway_tpu_torch.analysis.device import device_profile

    res: dict = {"card": smi}
    t_phase = time.perf_counter()

    # ---- (a) phase 15's pre-flight, and its numbers through the plan
    an = rag["analysis"]
    res["rag_server"] = {key: an[key] for key in ("by_severity", "by_code", "analyze_ms", "explain_ms", "nodes",
                                                  "counters", "columnar_nodes", "strict")}
    res["rag_server"]["preflight_ms"] = an["analyze_ms"] + an["explain_ms"]
    res["rag_server"]["columnar_rows"] = rag["columnar_rows"]
    log(f"analysis: the RAG server's graph on {smi}: findings {json.dumps(an['by_severity'])} by code "
        f"{json.dumps(an['by_code'])}; analyze {an['analyze_ms']:.1f} ms, explain {an['explain_ms']:.1f} ms; "
        f"nodes {an['nodes'][0]} -> {an['nodes'][1]}; counters {json.dumps(an['counters'])}")
    for line in an["columnar"]:
        log(f"analysis: the RAG server's plan, columnar: {line}")
    if an["strict"]["started"]:
        log("analysis: pw.run(strict=True) started the RAG server (no error finding)")
    else:
        for line in an["strict"]["refused_by"]:
            log(f"analysis: pw.run(strict=True) refused the RAG server: {line}")
    served = {key: rag[key] for key in ("ingest_docs_per_s", "http_single_p50_ms", "http_single_p99_ms",
                                        "http_concurrent_p50_ms", "http_concurrent_p99_ms")}
    served["served_idle_share"] = rag["served_profile"]["device_idle_share"]
    res["rag_server"]["served_at_optimize_2"] = served
    log(f"analysis: the RAG server at optimize=2 on {smi}: {json.dumps(served)}; its scheduler's "
        f"columnar_rows {json.dumps(rag['columnar_rows'])}")

    # ---- (b) the engine's join + groupby at each level
    rng = np.random.default_rng(SEED + 12)
    rng.integers(0, 50, ENGINE_MD_ROWS)  # phase 13's markdown rows are drawn first
    rng.integers(1, 100, ENGINE_MD_ROWS)
    cust = rng.integers(0, ENGINE_CUSTOMERS, ENGINE_ROWS)
    amount = rng.integers(1, 1000, ENGINE_ROWS)
    region = {c: f"r{c % 7}" for c in range(ENGINE_CUSTOMERS)}
    want: dict = defaultdict(lambda: (0, 0))
    for c, a in zip(cust, amount):
        r = region[int(c)]
        want[r] = (want[r][0] + int(a), want[r][1] + 1)
    root = tempfile.mkdtemp(prefix="analysis_")
    try:
        orders_path, customers_path = os.path.join(root, "orders.jsonl"), os.path.join(root, "customers.jsonl")
        with open(orders_path, "w") as f:
            f.write("\n".join(json.dumps({"order": i, "customer": int(c), "amount": int(a)})
                              for i, (c, a) in enumerate(zip(cust, amount))))
        with open(customers_path, "w") as f:
            f.write("\n".join(json.dumps({"customer": c, "region": r}) for c, r in region.items()))
        runs: list = []
        for level in ANALYSIS_LEVELS:
            pw.G.clear()
            orders = pw.io.jsonlines.read(orders_path, mode="static",
                                          schema=pw.schema_from_types(order=int, customer=int, amount=int))
            customers = pw.io.jsonlines.read(customers_path, mode="static",
                                             schema=pw.schema_from_types(customer=int, region=str))
            orders = orders.filter(orders.amount > 0)
            joined = orders.join(customers, orders.customer == customers.customer).select(
                orders.order, customers.region, orders.amount)
            by_region = joined.groupby(joined.region).reduce(joined.region, total=pw.reducers.sum(joined.amount),
                                                             n=pw.reducers.count())
            got: dict = {}

            def on_change(key, row, time, is_addition, got=got):
                if is_addition:
                    got[row["region"]] = (row["total"], row["n"])
                elif got.get(row["region"]) == (row["total"], row["n"]):
                    del got[row["region"]]

            pw.io.subscribe(by_region, on_change=on_change)
            t0 = time.perf_counter()
            ctx = pw.run(optimize=level, monitoring_level=pw.MonitoringLevel.NONE)
            run_s = time.perf_counter() - t0
            plan = pw.G.last_plan
            if plan is None or plan.level != level:
                fail(f"analysis: pw.run(optimize={level}) ran plan {plan!r}")
            if got != dict(want):
                fail(f"analysis: the join + groupby at optimize={level} differs from its plain-Python result")
            runs.append({"level": level, "run_s": run_s, "rows_per_s": ENGINE_ROWS / run_s,
                         "columnar_rows": dict(ctx.stats.get("columnar_rows", {})), "counters": plan.counters(),
                         "columnar": plan.columnar_lines()})
            pw.G.clear()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    by_level = {}
    for level in sorted(set(ANALYSIS_LEVELS)):
        at = [r for r in runs if r["level"] == level]
        by_level[f"optimize_{level}"] = {
            "rows_per_s": [r["rows_per_s"] for r in at], "columnar_rows": [r["columnar_rows"] for r in at],
            "counters": at[0]["counters"], "columnar": at[0]["columnar"],
        }
    res["engine_join"] = {"rows": ENGINE_ROWS, "customers": ENGINE_CUSTOMERS, **by_level}
    if not all(r["columnar_rows"].get("columnar", 0) > 0 for r in runs if r["level"] == 2):
        fail(f"analysis: the join + groupby at optimize=2 ran no columnar rows: {json.dumps(by_level)}")
    log(f"analysis: join + groupby over {ENGINE_ROWS} rows on {smi}: " + "; ".join(
        f"optimize={lvl[-1]} rows/s {', '.join(f'{x:.0f}' for x in v['rows_per_s'])}, columnar_rows "
        f"{json.dumps(v['columnar_rows'][0])}" for lvl, v in by_level.items()))

    # ---- (c) A11 over the installed port
    profile = device_profile(refresh=True)
    res["device_profile"] = profile
    log(f"analysis: A11 device_profile of the installed port: {json.dumps(profile)}")
    if profile["errors"]:
        fail(f"analysis: A11 finds {profile['errors']} unwaived error(s) in the port")

    # ---- (d) phase 14's estimate beside the card's peak
    res["live_index_memory"] = live["memory"]
    log(f"analysis: phase 14's live-index graph on {smi}: estimate_memory {live['memory']['estimate_bytes']} B "
        f"(host state at optimize={live['memory']['estimate_level']}, top {json.dumps(live['memory']['estimate_top'])}) "
        f"beside torch.cuda.max_memory_allocated {live['memory']['device_max_allocated_bytes']} B "
        f"({live['memory']['device_allocated_before_bytes']} B before the run)")
    res["wall_s"] = time.perf_counter() - t_phase
    return res


class EncoderAdapter:
    """A ``TorchEncoder`` as the serving layer's embedder
    (``RagServingApp(embedder=)``): ``dim``, and one text a call, as
    ``StageCoScheduler._embed_batch`` and ``RagServingApp._ingest_batch``
    call it."""

    def __init__(self, encoder):
        self.encoder = encoder
        self.dim = encoder.config.hidden

    def __call__(self, text: str):
        return self.encoder.encode([text])[0]


def post_json(port: int, path: str, payload: dict, timeout: float = SERVING_DEADLINE_S) -> tuple:
    """One JSON POST on 127.0.0.1: (status, Retry-After, JSON body)."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.headers.get("Retry-After"), json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Retry-After"), json.loads(e.read())


def free_port() -> int:
    import socket

    sock = socket.socket()
    try:
        sock.bind(("127.0.0.1", 0))
    except OSError as e:
        fail(f"a loopback socket does not bind on this machine: {e!r}")
    port = sock.getsockname()[1]
    sock.close()
    return port


def scrape(port: int, path: str) -> tuple:
    """GET ``path`` of the monitoring server: (body, ms)."""
    import urllib.request

    t0 = time.perf_counter()
    body = urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=SERVING_DEADLINE_S).read()
    return body, (time.perf_counter() - t0) * 1e3


def wait_until(what: str, cond, hub, deadline_s: float = SERVING_DEADLINE_S) -> float:
    """Generation-wait on ``hub`` until ``cond()``; its seconds, or the
    phase fails at the deadline."""
    t0 = time.perf_counter()
    while True:
        seen = hub.seq()
        if cond():
            return time.perf_counter() - t0
        if time.perf_counter() - t0 > deadline_s:
            fail(f"serving: {what} not reached in {deadline_s} s")
        hub.wait(seen, 0.05)


def phase_serving(torch, dev, smi: str) -> dict:
    """Phase 17: the serving layer (slice 16b) on the card, through the
    entry points a user calls.  ``RagServingApp`` with BGE-base (phase 3's
    seed) through ``EncoderAdapter`` and a CAPACITY-slot f32 cosine
    ``SegmentedIndex(ShardedKnnIndex)`` on the card (delta cap
    SERVING_DELTA_CAP); ``/v1/answer`` served over REST.
    (a) SERVING_DOCS of phase 15's documents upserted (SERVING_CHUNK_WORDS
    a chunk), then LoadGen for SERVING_LOAD_S (tenant ``alice``
    interactive, ``bob`` batch, ``noisy`` batch over its rate) while
    SERVING_REWRITTEN documents get new texts and SERVING_DELETED are
    deleted; once the index holds exactly the live chunks, SERVING_CHECKED
    answers against the direct path (the adapter over each live chunk's
    text and the query, one text a call as the app embeds them, and an
    exact numpy top-k: ``compare_rows`` at TOPK_ATOL); lookahead probes
    and ``SegmentedIndex.probes_dispatched`` above 0; K1-K7 launched.
    (b) ``/v1/answer``: 200s with the same answers as ``app.answer``, a
    tenant over its rate answered 429 with ``Retry-After``, the admission
    counters' change equal to the replies; one request profiled.
    (c) ``start_http_server(app.sched)``: ``/metrics`` with the serving
    latency series by tenant class, ``/status`` whose admitted counts equal
    ``app.admission.stats()`` and whose device counters moved bytes both
    ways, ``/debug/stacks``.  (d) ``RagServingApp(shards=2)`` over two
    FAILOVER_SLOTS-slot shards on the card, FAILOVER_DOCS documents: one
    owner killed while queries run answers ``partial`` with 1 of 2 shards,
    ``ShardFailoverSupervisor`` restores it, and the FAILOVER_QUERIES
    answers equal those before the kill."""
    import threading

    import numpy as np

    import pathway_tpu_torch as pw
    from pathway_tpu_torch import BGE_BASE, ShardedKnnIndex, TorchEncoder, kernels, serving
    from pathway_tpu_torch.internals.monitoring_server import start_http_server
    from pathway_tpu_torch.serving.graph import simple_splitter
    from pathway_tpu_torch.stdlib.indexing.segments import SegmentedIndex

    res: dict = {"card": smi}
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    adapter = EncoderAdapter(TorchEncoder(BGE_BASE, seed=SEED, device=dev))
    policies = {
        "alice": serving.TenantPolicy("interactive", rate_per_s=400.0, burst=80, queue_cap=64),
        "bob": serving.TenantPolicy("batch", rate_per_s=200.0, burst=40, queue_cap=32),
        "noisy": serving.TenantPolicy("batch", rate_per_s=5.0, burst=2, queue_cap=2),
        "rest_slow": serving.TenantPolicy("batch", rate_per_s=0.01, burst=1, queue_cap=4),
        "drill": serving.TenantPolicy("interactive", rate_per_s=1e6, burst=1e6, queue_cap=1024),
    }
    docs = {f"doc{i:05d}": text for i, text in enumerate(synthetic_docs(np, SERVING_DOCS, SEED))}

    def chunks(items) -> dict:
        return {cid: text for doc_id, t in items for cid, text in simple_splitter(doc_id, t, SERVING_CHUNK_WORDS)}

    index = SegmentedIndex(ShardedKnnIndex(HIDDEN, metric="cos", capacity=CAPACITY, device=dev),
                           delta_cap=SERVING_DELTA_CAP)
    pw.G.clear()
    app = serving.RagServingApp(policies, embedder=adapter, index=index, k=K, chunk_words=SERVING_CHUNK_WORDS)
    rest_port = free_port()
    app.serve_rest(host="127.0.0.1", port=rest_port)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    app.start()
    try:
        # ---- (a) ingest
        first = chunks(docs.items())
        res["docs"], res["chunks"] = len(docs), len(first)
        res["split_docs"] = sum(1 for cid in first if cid.endswith("#1"))
        t0 = time.perf_counter()
        for i, (doc_id, text) in enumerate(docs.items()):
            app.upsert(doc_id, text, tenant=("alice", "bob")[i % 2])
        res["ingest_s"] = wait_until("the first ingest", lambda: app.ingested_chunks >= len(first)
                                     and len(app.index) == len(first), app.hub)
        res["ingest_chunks_per_s"] = len(first) / res["ingest_s"]
        merges_before_load = app.index.stats()["merges_total"]
        log(f"serving on {smi}: {res['docs']} documents, {res['chunks']} chunks ({res['split_docs']} split) "
            f"searchable in {res['ingest_s']:.2f} s ({res['ingest_chunks_per_s']:.1f} chunks/s, one encode a "
            f"chunk), {merges_before_load} merges")

        # ---- (a) load, with documents rewritten and deleted meanwhile
        questions = synthetic_questions(np, list(docs.values()), 64, SEED + 31)
        lg = serving.LoadGen(app, [serving.TenantLoad("alice", qps=30.0, queries=questions),
                                   serving.TenantLoad("bob", qps=10.0, queries=questions),
                                   serving.TenantLoad("noisy", qps=80.0, queries=questions)],
                             duration_s=SERVING_LOAD_S, seed=SEED)
        report: dict = {}
        loader = threading.Thread(target=lambda: report.update(lg.run()), name="loadgen", daemon=True)
        loader.start()
        rng = np.random.default_rng(SEED + 32)
        picked = [f"doc{i:05d}" for i in rng.permutation(SERVING_DOCS)[:SERVING_REWRITTEN + SERVING_DELETED]]
        rewritten = dict(zip(picked[:SERVING_REWRITTEN], synthetic_docs(np, SERVING_REWRITTEN, SEED + 33)))
        deleted = picked[SERVING_REWRITTEN:]
        for doc_id, text in rewritten.items():
            app.upsert(doc_id, text, tenant="bob")
        for doc_id in deleted:
            app.delete(doc_id)
        loader.join(SERVING_LOAD_S + 2 * SERVING_DEADLINE_S)
        if loader.is_alive() or not report:
            fail("serving: LoadGen did not finish")
        final = dict(docs)
        final.update(rewritten)
        for doc_id in deleted:
            del final[doc_id]
        live = chunks(final.items())
        n_rewritten = len(chunks(rewritten.items()))
        res["settle_s"] = wait_until(
            "the churn's settling", lambda: app.ingested_chunks >= len(first) + n_rewritten
            and set(app.index.keys()) == set(live), app.hub)
        res["load"] = report
        res["admission_after_load"] = app.admission.stats()
        cls = report["classes"]
        ten = report["tenants"]
        for c, row in sorted(cls.items()):
            log(f"serving on {smi}: class {c}: {row['achieved_qps']:.1f} answers/s of {row['offered_qps']:.0f} "
                f"offered, p50 {row['p50_ms']:.2f} ms, p99 {row['p99_ms']:.2f} ms, sent {row['sent']}, shed "
                f"{row['shed']}, errors {row['errors']}")
        log(f"serving on {smi}: tenants {json.dumps(ten)}; admission {json.dumps(res['admission_after_load'])}; "
            f"scheduler {json.dumps(app.scheduler.stats())}")
        if ten["noisy"]["shed"] == 0:
            fail(f"serving: the tenant over its rate was never shed: {json.dumps(ten['noisy'])}")
        # the interactive class holds (no shed, no error, every request answered); the
        # batch class may be shed by brownout when the engine reports pressure
        a = ten["alice"]
        if a["shed"] or a["errors"] or a["completed"] != a["sent"]:
            fail(f"serving: the interactive tenant lost requests: {json.dumps(a)}")
        if any(ten[t]["errors"] or ten[t]["completed"] + ten[t]["shed"] != ten[t]["sent"] for t in ten):
            fail(f"serving: requests neither answered nor shed: {json.dumps(ten)}")

        # ---- (a) the checked round
        asked = synthetic_questions(np, list(final.values()), SERVING_CHECKED, SEED + 34)
        answers = []
        for i in range(0, len(asked), 16):
            futs = [app.submit_query(q, tenant="alice") for q in asked[i:i + 16]]
            answers.extend(f.result(timeout=SERVING_DEADLINE_S) for f in futs)
        got_rows = [[(d["id"], d["score"]) for d in a["docs"]] for a in answers]
        if any(a["partial"] for a in answers):
            fail("serving: an answer over the one-owner index says partial")
        for a in answers:
            top = a["docs"][0]
            if a["answer"] != f"[{top['id']}] {live[top['id']][:240]}" or top["text"] != live[top["id"]]:
                fail(f"serving: the extractive answer or a doc's text does not match chunk {top['id']}")

        # ---- (b) REST
        rest = {"start_s": wait_until("the REST route's start", lambda: _answers(rest_port), app.hub)}
        before = app.admission.stats()
        replies = [post_json(rest_port, "/v1/answer", {"query": q, "tenant": "alice", "k": K}) for q in asked[:8]]
        for (status, _, body), want in zip(replies, answers[:8]):
            if status != 200 or [d["id"] for d in body["docs"]] != [d["id"] for d in want["docs"]]:
                fail(f"serving: /v1/answer gave {status} or other hits than app.answer for the same question")
        slow = [post_json(rest_port, "/v1/answer", {"query": asked[0], "tenant": "rest_slow"}) for _ in range(2)]
        if slow[0][0] != 200 or slow[1][0] != 429 or not slow[1][1] or int(slow[1][1]) < 1 \
                or "rate limited" not in slow[1][2]["error"]:
            fail(f"serving: the over-rate tenant's replies: {[(s, ra, b if s != 200 else '...') for s, ra, b in slow]}")
        after = app.admission.stats()
        d_admitted = {c: n - before["admitted_total"].get(c, 0) for c, n in after["admitted_total"].items()
                      if n != before["admitted_total"].get(c, 0)}
        d_shed = {c: n - before["shed_total"].get(c, 0) for c, n in after["shed_total"].items()
                  if n != before["shed_total"].get(c, 0)}
        if d_admitted != {"interactive": 8, "batch": 1} or d_shed != {"batch": 1} or after["inflight"]:
            fail(f"serving: admission counted {d_admitted} admitted, {d_shed} shed, {after['inflight']} in "
                 "flight for 9 200s and one 429")
        rest.update({"ok": len(replies) + 1, "retry_after": slow[1][1], "error": slow[1][2]["error"]})
        res["rest"] = rest
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        res["launches"] = launches
        res["coscheduler"] = app.coscheduler.stats()
        res["index"] = app.index.stats()
        res["ingested_chunks"], res["removed_chunks"] = app.ingested_chunks, app.removed_chunks
        res["merges_during_load"] = res["index"]["merges_total"] - merges_before_load

        # ---- (a) the direct path: the adapter over each live chunk and question
        t0 = time.perf_counter()
        ids = sorted(live)
        mat = np.stack([adapter(live[cid]) for cid in ids]).astype(np.float32)
        mat /= np.maximum(np.linalg.norm(mat, axis=1, keepdims=True), 1e-30)
        qv = np.stack([adapter(q) for q in asked]).astype(np.float32)
        qv /= np.maximum(np.linalg.norm(qv, axis=1, keepdims=True), 1e-30)
        scores = qv @ mat.T
        want_rows = []
        for row in scores:
            top = np.argsort(-row, kind="stable")[:K]
            want_rows.append([(ids[j], float(row[j])) for j in top])
        res["direct_s"] = time.perf_counter() - t0
        res["max_abs_err_vs_direct"] = compare_rows(got_rows, want_rows, K, TOPK_ATOL, "serving vs direct path")
        co = res["coscheduler"]
        if not co["lookahead_probes"] > 0 or not res["index"]["probes_dispatched"] > 0:
            fail(f"serving: no lookahead probe ({co['lookahead_probes']}) or dispatched probe "
                 f"({res['index']['probes_dispatched']})")
        missing = [n for n in ("attention", "slab_scatter", "knn_topk", "bias_act", "add_layer_norm", "embed_ln",
                               "pool_normalize") if launches[n] == 0]
        if missing:
            fail(f"kernels not launched by the serving path: {missing}")
        res["served_profile"] = profile_call(
            torch, lambda: post_json(rest_port, "/v1/answer", {"query": asked[1], "tenant": "alice"}), 1)

        # ---- (c) the monitoring server
        mport = free_port()
        start_http_server(app.sched, port=mport)
        _, metrics_first_ms = scrape(mport, "/metrics")  # the first scrape may pay A11's scan of the port
        metrics, metrics_ms = scrape(mport, "/metrics")
        status_raw, status_ms = scrape(mport, "/status")
        stacks, stacks_ms = scrape(mport, "/debug/stacks")
        app.sched._monitoring_server.shutdown()
        app.sched._monitoring_server.server_close()
        metrics, status, stacks = metrics.decode(), json.loads(status_raw), stacks.decode()
        for c in ("interactive", "batch"):
            if f'pathway_tpu_stage_latency_ms{{stage="serve_e2e",tenant_class="{c}",quantile="p99"}}' not in metrics:
                fail(f"serving: /metrics has no serve_e2e latency series for tenant_class {c}")
        adm = app.admission.stats()
        if status["serving"]["admission"]["admitted_total"] != adm["admitted_total"]:
            fail(f"serving: /status admitted {status['serving']['admission']['admitted_total']}, the controller "
                 f"{adm['admitted_total']}")
        ctr = status["device"]["counters"]
        if not (ctr["h2d_bytes"] > 0 and ctr["d2h_bytes"] > 0) or "--- Thread" not in stacks:
            fail(f"serving: /status device counters {ctr} or /debug/stacks without threads")
        res["monitoring"] = {"metrics_first_ms": metrics_first_ms, "metrics_ms": metrics_ms, "status_ms": status_ms,
                             "stacks_ms": stacks_ms,
                             "metrics_bytes": len(metrics), "status_bytes": len(status_raw),
                             "device_counters": ctr, "admitted_total": adm["admitted_total"],
                             "shed_total": adm["shed_total"]}
    finally:
        app.close()
        pw.G.clear()
    del app, index
    gc.collect()
    torch.cuda.empty_cache()

    # ---- (d) failover: two shards on the card, one owner killed under load
    fo_docs = dict(list(docs.items())[:FAILOVER_DOCS])
    fo_live = chunks(fo_docs.items())
    part = serving.PartitionedIndex(
        lambda: SegmentedIndex(ShardedKnnIndex(HIDDEN, metric="cos", capacity=FAILOVER_SLOTS, device=dev),
                               delta_cap=FAILOVER_DELTA_CAP),
        n_shards=2, snapshot_every=FAILOVER_SNAPSHOT_EVERY)
    app2 = serving.RagServingApp(policies, embedder=adapter, index=part, shards=2, k=K,
                                 chunk_words=SERVING_CHUNK_WORDS)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    app2.start()
    sup = None
    try:
        for doc_id, text in fo_docs.items():
            app2.upsert(doc_id, text, tenant="drill")
        fo: dict = {"docs": len(fo_docs), "chunks": len(fo_live)}
        fo["ingest_s"] = wait_until("the two-shard ingest", lambda: app2.ingested_chunks >= len(fo_live)
                                    and len(app2.index) == len(fo_live), app2.hub)
        fo_q = synthetic_questions(np, list(fo_docs.values()), FAILOVER_QUERIES, SEED + 35)

        def answer_all() -> list:
            return [app2.answer(q, tenant="drill", timeout=SERVING_DEADLINE_S) for q in fo_q]

        healthy = answer_all()
        if any(a["partial"] or a["shards_answered"] != 2 for a in healthy):
            fail("serving: a healthy two-shard answer says partial")
        stop, after_kill = threading.Event(), []
        killed = threading.Event()
        errors: list = []

        def load() -> None:
            i = 0
            while not stop.is_set():
                try:
                    a = app2.answer(fo_q[i % len(fo_q)], tenant="drill", timeout=SERVING_DEADLINE_S)
                except BaseException as e:  # noqa: BLE001 - the drill counts them
                    errors.append(repr(e))
                    return
                if killed.is_set():
                    after_kill.append((a["partial"], a["shards_answered"], a["shards_total"]))
                i += 1

        loader = threading.Thread(target=load, name="failover_load", daemon=True)
        loader.start()
        t_kill = time.perf_counter()
        app2.index.fail_shard(1)
        killed.set()
        wait_until("answers after the kill", lambda: len(after_kill) >= 8 or errors, app2.hub)
        degraded = [app2.answer(q, tenant="drill", timeout=SERVING_DEADLINE_S) for q in fo_q[:8]]
        stop.set()
        loader.join(SERVING_DEADLINE_S)
        if errors or loader.is_alive():
            fail(f"serving: queries failed while a shard was dead: {errors[:3]}")
        if any((p, a, t) != (True, 1, 2) for p, a, t in after_kill[1:]) \
                or any(not d["partial"] or d["shards_answered"] != 1 for d in degraded):
            fail(f"serving: answers with a dead shard are not partial over 1 of 2: {after_kill[:8]}")
        sup = serving.ShardFailoverSupervisor(app2.index, scheduler=app2.scheduler)
        fo["restore_s"] = wait_until("the supervisor's restore", lambda: app2.index.stats()["shards_healthy"] == 2,
                                     app2.hub)
        fo["kill_to_healthy_s"] = time.perf_counter() - t_kill
        restored = answer_all()
        if any(a["partial"] for a in restored):
            fail("serving: an answer after the restore says partial")
        fo["max_abs_err_restored_vs_healthy"] = compare_rows(
            [[(d["id"], d["score"]) for d in a["docs"]] for a in restored],
            [[(d["id"], d["score"]) for d in a["docs"]] for a in healthy], K, TOPK_ATOL,
            "serving: answers after the restore vs before the kill")
        st = app2.index.stats()
        hist = st["failover_seconds"]
        fo.update({"answers_after_kill": len(after_kill), "degraded_responses": st["degraded_responses"],
                   "standby_serves": st["standby_serves"], "failovers": st["failovers_total"],
                   "failover_seconds": hist.get("max_ns", 0) / 1e9,
                   "owners": [{k: o[k] for k in ("alive", "incarnation", "tail_replayed", "restores_total",
                                                  "snapshot_seq")} for o in st["shards"]]})
        torch.cuda.synchronize()
        res["failover_launches"] = kernels.launch_counts()
        res["failover"] = fo
        missing = [n for n in ("slab_scatter", "knn_topk") if res["failover_launches"][n] == 0]
        if missing:
            fail(f"kernels not launched by the two-shard serving path: {missing}")
    finally:
        if sup is not None:
            sup.close()
        app2.close()
        pw.G.clear()
    res["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    res["wall_s"] = time.perf_counter() - t_phase

    lc = {n: c for n, c in res["launches"].items() if c}
    log(f"serving on {smi}: chunks ingested {res['ingested_chunks']}, removed {res['removed_chunks']}, merges "
        f"{res['index']['merges_total']} ({res['merges_during_load']} from the load's start); settled "
        f"{res['settle_s']:.2f} s after the load")
    log(f"serving on {smi}: {SERVING_CHECKED} answers vs the direct path: max score error "
        f"{res['max_abs_err_vs_direct']:.2e} (direct path {res['direct_s']:.1f} s); lookahead probes "
        f"{co['lookahead_probes']}, mean overlap {co['overlap_ms_mean']:.3f} ms; probes dispatched "
        f"{res['index']['probes_dispatched']}, recovered {res['index']['probes_recovered']}")
    sp = res["served_profile"]
    log(f"serving on {smi}: one /v1/answer: wall {sp['wall_ms']:.2f} ms, busy {sp['device_busy_ms']:.3f} ms, "
        f"idle {sp['device_idle_share']:.3f}; REST 429 Retry-After {res['rest']['retry_after']} "
        f"({res['rest']['error']!r})")
    log(f"serving on {smi}: launches by kernel {json.dumps(lc)} (K13 topk_select {res['launches']['topk_select']})")
    mo = res["monitoring"]
    log(f"serving on {smi}: monitoring /metrics {mo['metrics_ms']:.2f} ms ({mo['metrics_bytes']} B; the first "
        f"scrape {mo['metrics_first_ms']:.2f} ms), /status "
        f"{mo['status_ms']:.2f} ms ({mo['status_bytes']} B), /debug/stacks {mo['stacks_ms']:.2f} ms; device "
        f"counters {json.dumps(mo['device_counters'])}")
    log(f"serving on {smi}: failover: {fo['chunks']} chunks over 2 shards of {FAILOVER_SLOTS} slots in "
        f"{fo['ingest_s']:.2f} s; {fo['answers_after_kill']} answers under load after the kill, partial over 1 of 2 "
        f"({fo['degraded_responses']} degraded, {fo['standby_serves']} shard answers from the standby); "
        f"restored in {fo['restore_s']:.3f} s (failover_seconds {fo['failover_seconds']:.4f}, kill to healthy "
        f"{fo['kill_to_healthy_s']:.3f} s); hits after the restore within {fo['max_abs_err_restored_vs_healthy']:.1e} "
        f"of before the kill; owners {json.dumps(fo['owners'])}")
    log(f"serving on {smi}: peak {res['peak_mem_gb']:.2f} GB; phase wall {res['wall_s']:.1f} s")
    return res


PERSIST_PROGRAM = """
import json, os, sys, time
_t0 = time.perf_counter()
sys.path.insert(0, {repo!r})
import dataclasses
import numpy as np
import torch
import pathway_tpu_torch as pw
from pathway_tpu_torch import kernels
from pathway_tpu_torch.engine.external_index import ExternalIndexNode
from pathway_tpu_torch.persistence import Backend, Config, PersistenceHooks, PersistenceMode, _FsBackend
from pathway_tpu_torch.stdlib.indexing import DataIndex
from pathway_tpu_torch.stdlib.indexing.data_index import BruteForceKnn

import_s = time.perf_counter() - _t0
_generation = os.environ.get("PATHWAY_WORKER_RESTARTS", "0")
_kill_rank = int(os.environ.get("CHAOS_KILL_RANK", "-1"))
if _kill_rank >= 0:
    from pathway_tpu_torch.testing.chaos import chaos as _chaos

    _c = _chaos(seed=int(os.environ.get("CHAOS_SEED", "0")))
    _c.__enter__()  # never restored: this process dies or exits
    _c.kill_worker_mid_merge(_kill_rank, on_nth_merge=int(os.environ["CHAOS_KILL_MERGE"]))

# where a checkpoint's and a restore's time goes
timers = {{"state_dict_s": [], "write_s": [], "restore_s": 0.0}}
restored = {{}}
_snapshot_state = ExternalIndexNode.snapshot_state
_on_restore = ExternalIndexNode.on_restore
_put_blob = _FsBackend.put_blob
_load = PersistenceHooks.load_operator_snapshot


def _timed_snapshot(self, ctx):
    t = time.perf_counter()
    out = _snapshot_state(self, ctx)
    if out is not None:
        timers["state_dict_s"].append(time.perf_counter() - t)
    return out


def _timed_restore(self, ctx):
    t = time.perf_counter()
    _on_restore(self, ctx)
    timers["restore_s"] += time.perf_counter() - t


def _timed_put(self, name, data):
    t = time.perf_counter()
    _put_blob(self, name, data)
    timers["write_s"].append(time.perf_counter() - t)


def _noted_load(self, worker):
    snap = _load(self, worker)
    if snap is not None:
        restored["epoch"] = snap["epoch"]
        restored["consumed"] = sum(snap["consumed"].values())
    return snap


ExternalIndexNode.snapshot_state = _timed_snapshot
ExternalIndexNode.on_restore = _timed_restore
_FsBackend.put_blob = _timed_put
PersistenceHooks.load_operator_snapshot = _noted_load

free_at_start, total_mem = torch.cuda.mem_get_info() if torch.cuda.is_available() else (0, 0)
embedded = [0]


class CountingEmbedder(pw.TorchEncoderEmbedder):
    def __batch__(self, texts):
        embedded[0] += len(texts)
        with open({dump!r} + ".gen" + _generation, "w") as f:  # survives the kill
            f.write(str(embedded[0]))
        return super().__batch__(texts)


class Doc(pw.Schema):
    doc: str = pw.column_definition(primary_key=True)
    text: str


class Q(pw.Schema):
    qid: str = pw.column_definition(primary_key=True)
    text: str


class DocSubject(pw.io.python.ConnectorSubject):
    deterministic_replay = True  # same file, same order, every generation

    def run(self):
        n = 0
        with open({docs!r}) as f:
            for line in f:
                row = json.loads(line)
                self.next(doc=row["doc"], text=row["text"])
                n += 1
                if n % {commit_every} == 0:
                    self.commit()
        self.commit()


_t_model = time.perf_counter()
emb = CountingEmbedder({embedder}, max_batch_size={batch}, seed={seed}, device={device!r})
model_s = time.perf_counter() - _t_model
docs = pw.io.python.read(DocSubject(), schema=Doc)
docs = docs.select(doc=pw.this.doc, vec=emb(pw.this.text))
queries = pw.io.jsonlines.read({queries!r}, schema=Q, mode="static")
queries = queries.select(qid=pw.this.qid, qvec=emb(pw.this.text))
di = DataIndex(docs, BruteForceKnn(docs.vec, dimensions={dim}, reserved_space={slots}, metric="cos",
                                   delta_cap={delta_cap}, device={device!r}))
reply = di.query(queries.qvec, number_of_matches={k})
out = reply.select(
    qid=pw.this.qid,
    ids=pw.apply(lambda ds: [d["doc"] for d in ds if d], pw.this._pw_index_reply),
    scores=pw.apply(lambda ss: [float(s) for s in ss], pw.this._pw_index_reply_score),
)
pw.io.jsonlines.write(out, {output!r})
pconf = Config.simple_config(Backend.filesystem({persist!r}),
                             persistence_mode=PersistenceMode.OPERATOR_PERSISTING)
kernels.reset_launch_counts()
if torch.cuda.is_available():
    torch.cuda.reset_peak_memory_stats()
startup_s = time.perf_counter() - _t0
t_run = time.perf_counter()
pw.run(autocommit_duration_ms=20, persistence_config=pconf, monitoring_level="none",
       with_http_server={http_server})
run_s = time.perf_counter() - t_run

node = reply._node
st = pw.G.last_run_ctx.state(node)
name_of = {{key: data["doc"] for key, (data, _meta) in st["docs"].items()}}
seg = node.adapter.state_dict()["index"]
main = seg["main"]
tombs = set(seg["tombstones"])
live = {{key: main["vectors"][slot] for key, slot in main["slot_of"].items() if key not in tombs}}
bad_flags = sum(1 for key, slot in main["slot_of"].items() if main["valid"][slot] != 1.0)
live.update(zip(seg["delta_keys"], seg["delta_vectors"]))
names = sorted(live, key=lambda key: name_of[key])
qcol = queries._column_names
qrows = {{values[qcol.index("qid")]: values[qcol.index("qvec")] for values in st["queries"].values()}}
np.savez({vectors!r},
         names=np.array([name_of[key] for key in names]),
         vectors=np.stack([np.asarray(live[key], np.float32) for key in names]),
         qids=np.array(sorted(qrows)),
         qvecs=np.stack([np.asarray(qrows[q], np.float32) for q in sorted(qrows)]))
sched = pw.G.active_scheduler
with open({dump!r}, "w") as f:
    json.dump({{
        **node.adapter.stats(),
        "embedded": embedded[0],
        "launches": kernels.launch_counts(),
        "checkpoint": sched.persistence.checkpoint_snapshot(),
        "max_memory_allocated": torch.cuda.max_memory_allocated() if torch.cuda.is_available() else 0,
        "free_at_start": free_at_start,
        "total_mem": total_mem,
        "startup_s": startup_s,
        "import_s": import_s,
        "model_s": model_s,
        "run_s": run_s,
        "restored": restored,
        "bad_flags": bad_flags,
        "zero_rows": int(sum(1 for v in live.values() if not np.any(v))),
        "state_dict_s": timers["state_dict_s"],
        "write_s": timers["write_s"],
        "restore_s": timers["restore_s"],
        "generation": int(_generation),
    }}, f)
"""


def chip_index_drill(np, device: str):
    """``IndexDrill`` at BGE-base width on the card: the drill of
    ``pathway_tpu_torch.testing.chaos`` with this script's documents,
    program and recall.  One process (``ClusterSupervisor`` over
    ``processes=1``) runs ``pw.run(persistence_config=...)`` under
    OPERATOR_PERSISTING: a Python reader of PERSIST_DOCS documents then
    PERSIST_REUPSERTS new texts for seeded ids, ``TorchEncoderEmbedder``
    as the UDF over the text, ``DataIndex`` over ``BruteForceKnn`` on the
    card (``SegmentedIndex`` over a ``ShardedKnnIndex`` of PERSIST_SLOTS
    slots), PERSIST_QUESTIONS questions embedded by the same UDF,
    answered at k = K into a JSON-lines sink.  Each run dumps the
    adapter's stats, the rows it embedded, its launch counts, its last
    checkpoint and its peak memory, and saves the recovered index's
    vectors and the questions' vectors."""
    from pathway_tpu_torch.testing.chaos import IndexDrill

    repo = os.path.dirname(os.path.abspath(__file__))

    class ChipIndexDrill(IndexDrill):
        def __init__(self, workdir: str):
            super().__init__(
                workdir, seed=SEED, processes=1, n_docs=PERSIST_DOCS, n_upserts=PERSIST_REUPSERTS, dim=HIDDEN,
                n_queries=PERSIST_QUESTIONS, k=K, delta_cap=PERSIST_DELTA_CAP, kill_merge=PERSIST_KILL_MERGE,
                recall_target=PERSIST_RECALL, checkpoint_interval_s=PERSIST_CHECKPOINT_S,
                epoch_max_rows=PERSIST_EPOCH_ROWS, max_restarts=2, timeout_s=PERSIST_RUN_S)
            self.walls: list[float] = []
            self.http_port = free_port()
            self.paths: dict = {}
            self.n_rows = 0

        def _write_inputs(self) -> tuple[str, str]:
            texts = synthetic_docs(np, self.n_docs, self.seed)
            fresh = synthetic_docs(np, self.n_upserts, self.seed + 1)
            ids = np.random.default_rng(self.seed + 2).integers(0, self.n_docs, self.n_upserts)
            rows = [(f"doc-{i}", t) for i, t in enumerate(texts)] + [(f"doc-{int(i)}", t) for i, t in zip(ids, fresh)]
            self._final = dict(rows)
            self.n_rows = len(rows)
            asked = synthetic_questions(np, [self._final[d] for d in sorted(self._final)], self.n_queries,
                                        self.seed + 3)
            self._queries = {f"q{j}": q for j, q in enumerate(asked)}
            docs_path = os.path.join(self.workdir, "docs.jsonl")
            with open(docs_path, "w") as f:
                f.writelines(json.dumps({"doc": d, "text": t}) + "\n" for d, t in rows)
            queries_path = os.path.join(self.workdir, "queries.jsonl")
            with open(queries_path, "w") as f:
                f.writelines(json.dumps({"qid": q, "text": t}) + "\n" for q, t in self._queries.items())
            return docs_path, queries_path

        def _write_index_program(self, tag: str, docs_path: str, queries_path: str,
                                 persist_tag: str | None = None) -> tuple[str, str, str]:
            paths = {name: os.path.join(self.workdir, f"{tag}_{name}") for name in
                     ("out.jsonl", "index.json", "vectors.npz", "prog.py")}
            paths["snap"] = os.path.join(self.workdir, f"{persist_tag or tag}_snap")
            self.paths[tag] = paths
            with open(paths["prog.py"], "w") as f:
                if tag == "baseline":  # the baseline serves /status for the phase's scrape
                    f.write(f"import os\nos.environ['PATHWAY_MONITORING_HTTP_PORT'] = '{self.http_port}'\n")
                f.write(PERSIST_PROGRAM.format(
                    repo=repo, docs=docs_path, queries=queries_path, output=paths["out.jsonl"],
                    persist=paths["snap"], dump=paths["index.json"], vectors=paths["vectors.npz"],
                    dim=self.dim, slots=PERSIST_SLOTS, delta_cap=self.delta_cap, k=self.k,
                    commit_every=PERSIST_COMMIT, batch=PERSIST_BATCH, seed=SEED, device=device,
                    embedder=PERSIST_EMBEDDER, http_server=tag == "baseline"))
            return paths["prog.py"], paths["out.jsonl"], paths["index.json"]

        def _recall(self, output_path: str) -> float:
            """Recall@k of the sink's final answers against the baseline's."""
            want = self._final_answers(self.paths["baseline"]["out.jsonl"])
            got = self._final_answers(output_path)
            hits = sum(len(set(ids) & set(got.get(q, ()))) for q, ids in want.items())
            return hits / max(sum(len(ids) for ids in want.values()), 1)

        def _run_supervised(self, prog: str, extra_env: dict) -> object:
            t0 = time.perf_counter()
            report = super()._run_supervised(prog, extra_env)
            self.walls.append(time.perf_counter() - t0)
            return report

    return ChipIndexDrill


def final_scores(path: str) -> dict:
    """A JSON-lines query sink consolidated to each question's final
    ``[(id, score), ...]``."""
    state: dict = {}
    with open(path) as f:
        for line in f:
            row = json.loads(line)
            pair = list(zip(row["ids"], row["scores"]))
            if row["diff"] > 0:
                state[row["qid"]] = pair
            elif state.get(row["qid"]) == pair:
                del state[row["qid"]]
    return state


def log_record_kinds(workdir: str) -> dict:
    """Record kinds of every input log under ``workdir`` (the drill's
    storage), read back through the port's filesystem backend."""
    import glob
    import pickle

    from pathway_tpu_torch.persistence import _FsBackend

    kinds: dict = {}
    impl = _FsBackend(workdir)
    for path in glob.glob(os.path.join(workdir, "*.log")):
        for rec in impl.read_all(os.path.basename(path)[: -len(".log")]):
            kind = pickle.loads(rec)[0]
            kinds[kind] = kinds.get(kind, 0) + 1
    return kinds


def persistence_slab(torch, dev) -> dict:
    """Phase 3's slab for ``--persistence`` alone: CAPACITY f32 cosine
    slots, the bulk rows phase 3 adds and its N_DOCS documents through
    ``encode_into``, and the first PERSIST_SLAB_QUERIES documents
    re-embedded as queries."""
    import numpy as np

    from pathway_tpu_torch import ShardedKnnIndex, TorchEncoderEmbedder

    index = ShardedKnnIndex(HIDDEN, metric="cos", capacity=CAPACITY, device=dev)
    n_bulk = CAPACITY - N_DOCS - 1024
    rng = np.random.default_rng(SEED)
    for start in range(0, n_bulk, 65536):
        n = min(65536, n_bulk - start)
        index.add_batch(range(start, start + n), rng.standard_normal((n, HIDDEN), dtype=np.float32))
    embedder = TorchEncoderEmbedder("bge-base", max_batch_size=DOC_BATCH, seed=SEED, device=dev)
    docs = synthetic_docs(np, N_DOCS, SEED)
    keys = [f"doc-{i}" for i in range(N_DOCS)]
    embedder.encoder.encode_into(index, keys, docs)
    index.remove(keys[-N_REMOVED:])
    return {"index": index, "q_all": embedder.encoder.encode(docs[:PERSIST_SLAB_QUERIES])}


def phase_persistence(torch, dev, smi: str, ctx: dict) -> dict:
    """Phase 18: persistence and the chaos drill (slice 16c) on the card.
    ``chip_index_drill``'s pipeline runs three times in subprocesses under
    ``ClusterSupervisor``: (1) a fault-free baseline, whose ``/status`` is
    scraped once a checkpoint has landed; (2) the drill:
    ``chaos.kill_worker_mid_merge(0, on_nth_merge=PERSIST_KILL_MERGE)``
    kills the process between a finished merge (K2) and its commit, the
    supervisor respawns it, and the new generation restores the
    checkpointed slab and replays the tail; (3) the same program over the
    drill's storage with no new input.  Checks: the drill recovers
    (returns 0, at least one restart) with the index holding each of the
    PERSIST_DOCS documents once; its final answers equal an exact numpy
    top-k over the vectors the recovered index holds (``compare_rows`` at
    TOPK_ATOL) and reach recall@k PERSIST_RECALL against the baseline's,
    and each document's stored vector is within phase 3's bf16 tolerance
    of the baseline's (EMBED_ATOL, cosine EMBED_COS); the recovering
    generation embeds fewer rows than the input holds, and the third run
    embeds none and adds no sink row; K1-K7 launched in the recovering
    generation; the input logs hold the native module's binary records.
    Then phase 3's 1M-slot slab alone: ``state_dict``, ``pickle.dumps``,
    ``load_state_dict`` into a fresh index on the card, each timed, and K3
    before and after gives the same ids and the same score bits for
    PERSIST_SLAB_QUERIES queries."""
    import pickle
    import shutil
    import tempfile
    import threading
    import urllib.request

    import numpy as np

    from pathway_tpu_torch import ShardedKnnIndex, kernels
    from pathway_tpu_torch.internals import native

    res: dict = {"card": smi}
    t_phase = time.perf_counter()
    # the drill's processes load the native module that writes the logs'
    # binary records; build it here (phase 13 has, in the whole script)
    if native.load() is None:
        fail("persistence: the native module pathway_torch_native did not build")
    device = "cuda" if dev.type == "cuda" else str(dev)
    workdir = tempfile.mkdtemp(prefix="pw_persist_")
    drill = chip_index_drill(np, device)(workdir)
    status: dict = {}
    done = threading.Event()

    def scrape_status() -> None:
        """``/status`` of the baseline run, once a checkpoint has landed."""
        while not done.is_set():
            try:
                t0 = time.perf_counter()
                body = json.loads(urllib.request.urlopen(
                    f"http://127.0.0.1:{drill.http_port}/status", timeout=10).read())
                ms = (time.perf_counter() - t0) * 1e3
                ckpt = body.get("checkpoint") or {}
                if ckpt.get("count"):
                    status.update(checkpoint=ckpt, ms=ms)
                    return
            except OSError:
                pass
            done.wait(0.05)

    scraper = threading.Thread(target=scrape_status, daemon=True)
    scraper.start()
    try:
        report = drill.run()
        done.set()
        scraper.join(10)
        docs_path = os.path.join(workdir, "docs.jsonl")
        queries_path = os.path.join(workdir, "queries.jsonl")
        prog, third_out, third_dump = drill._write_index_program("third", docs_path, queries_path,
                                                                 persist_tag="drill")
        third = drill._run_supervised(prog, {})
        if third.returncode != 0:
            fail(f"persistence: the third run failed: {third.failures}")
        with open(drill.paths["baseline"]["index.json"]) as f:
            base = json.load(f)
        with open(drill.paths["drill"]["index.json"]) as f:
            rec = json.load(f)
        with open(third_dump) as f:
            again = json.load(f)
        gen0_path = drill.paths["drill"]["index.json"] + ".gen0"
        gen0 = int(open(gen0_path).read()) if os.path.exists(gen0_path) else 0
        kinds = log_record_kinds(drill.paths["drill"]["snap"])

        total = drill.n_rows + PERSIST_QUESTIONS
        res.update({
            "baseline_s": drill.walls[0], "drill_s": drill.walls[1], "third_s": drill.walls[2],
            "recovery_seconds": report["recovery_seconds"], "restarts": report["restarts"],
            "docs_per_s": {tag: drill.n_rows / wall for tag, wall in zip(("baseline", "drill", "third"),
                                                                         drill.walls)},
            "merges": {"baseline": report["baseline_merges_total"], "drill": report["merges_total"],
                       "third": again["merges_total"]},
            "embedded": {"baseline": base["embedded"], "drill_gen0": gen0, "drill_gen1": rec["embedded"],
                         "third": again["embedded"]},
            "input_events": total,
            "events_past_checkpoint": total - rec["restored"].get("consumed", 0),
            "restored_epoch": rec["restored"].get("epoch"),
            "checkpoint": {tag: d["checkpoint"] for tag, d in (("baseline", base), ("drill", rec))},
            "state_dict_s": {tag: d["state_dict_s"] for tag, d in (("baseline", base), ("drill", rec))},
            "write_s": {tag: d["write_s"] for tag, d in (("baseline", base), ("drill", rec))},
            "restore_s": rec["restore_s"],
            "startup_s": {tag: {key: d[key] for key in ("startup_s", "import_s", "model_s")}
                          for tag, d in (("baseline", base), ("drill_gen1", rec), ("third", again))},
            "run_s": {"baseline": base["run_s"], "drill_gen1": rec["run_s"], "third": again["run_s"]},
            "peak_gb": {tag: d["max_memory_allocated"] / 1e9 for tag, d in
                        (("baseline", base), ("drill_gen1", rec), ("third", again))},
            "free_gb_at_respawn": rec["free_at_start"] / 1e9, "card_gb": rec["total_mem"] / 1e9,
            "log_records": kinds, "status_checkpoint": status.get("checkpoint"), "status_ms": status.get("ms"),
            "recall": report["recall"],
        })
        log(f"persistence on {smi}: baseline {res['baseline_s']:.2f} s, drill {res['drill_s']:.2f} s "
            f"(recovery_seconds {report['recovery_seconds']}), third run {res['third_s']:.2f} s; docs/s "
            f"{json.dumps(res['docs_per_s'])}")
        log(f"persistence: /status of the baseline run ({res['status_ms']} ms): checkpoint "
            f"{json.dumps(res['status_checkpoint'])}")
        log(f"persistence: checkpoints {json.dumps(res['checkpoint'])}; state_dict s {json.dumps(res['state_dict_s'])};"
            f" write s {json.dumps(res['write_s'])}")
        log(f"persistence: merges {json.dumps(res['merges'])}; rows embedded {json.dumps(res['embedded'])} of "
            f"{total} input events, {res['events_past_checkpoint']} past the checkpoint's consumed count "
            f"(epoch {res['restored_epoch']}); restore {res['restore_s']:.3f} s, start-up s "
            f"{json.dumps(res['startup_s'])}, run s {json.dumps(res['run_s'])}")
        log(f"persistence: peak GB {json.dumps(res['peak_gb'])}; {res['free_gb_at_respawn']:.2f} of "
            f"{res['card_gb']:.2f} GB free when the respawned generation started; log records {json.dumps(kinds)}")

        # ---- check 1: exactly once
        if report["returncode"] != 0 or report["restarts"] < 1:
            fail(f"persistence: the drill did not recover once: {report}")
        if not report["exactly_once"] or report["recovered_size"] != PERSIST_DOCS:
            fail(f"persistence: the recovered index holds {report['recovered_size']} documents, expected "
                 f"{PERSIST_DOCS}")
        for tag, d in (("baseline", base), ("drill", rec), ("third", again)):
            if d["bad_flags"] or d["zero_rows"]:
                fail(f"persistence: the {tag} index has {d['bad_flags']} slots without their flag and "
                     f"{d['zero_rows']} zero rows")
        # ---- check 2: answers
        rv = np.load(drill.paths["drill"]["vectors.npz"])
        bv = np.load(drill.paths["baseline"]["vectors.npz"])
        answers = final_scores(drill.paths["drill"]["out.jsonl"])
        names = list(rv["names"])
        qv = rv["qvecs"] / np.linalg.norm(rv["qvecs"], axis=1, keepdims=True)
        scores = qv.astype(np.float64) @ rv["vectors"].astype(np.float64).T
        want, got = [], []
        for i, qid in enumerate(rv["qids"]):
            top = np.argsort(-scores[i], kind="stable")[:K]
            want.append([(names[j], float(scores[i, j])) for j in top])
            got.append(answers.get(str(qid), []))
        if len(answers) != PERSIST_QUESTIONS or len(rv["qids"]) != PERSIST_QUESTIONS:
            fail(f"persistence: {len(answers)} answers and {len(rv['qids'])} questions, expected "
                 f"{PERSIST_QUESTIONS}")
        res["answer_err"] = compare_rows(got, want, K, TOPK_ATOL, "persistence: the drill's answers")
        if report["recall"] < PERSIST_RECALL:
            fail(f"persistence: recall@{K} {report['recall']:.4f} against the baseline < {PERSIST_RECALL}")
        if list(bv["names"]) != names:
            fail("persistence: the drill's index holds other documents than the baseline's")
        a, b = rv["vectors"], bv["vectors"]
        res["vector_err"] = float(np.abs(a - b).max())
        res["vector_min_cos"] = float((a * b).sum(1).min())
        if not res["vector_err"] <= EMBED_ATOL or not res["vector_min_cos"] >= EMBED_COS:
            fail(f"persistence: stored vectors differ from the baseline's by {res['vector_err']}, "
                 f"cosine {res['vector_min_cos']}")
        log(f"persistence: {len(got)} answers within {res['answer_err']:.2e} of numpy top-{K} over the recovered "
            f"vectors, recall@{K} {report['recall']:.4f} against the baseline, stored vectors within "
            f"{res['vector_err']:.2e} (cosine >= {res['vector_min_cos']:.6f})")
        # ---- check 3: restore, not re-embed
        if not rec["embedded"] < total:
            fail(f"persistence: the recovering generation embedded {rec['embedded']} of {total} rows")
        third_rows = sum(1 for _ in open(third_out)) if os.path.exists(third_out) else 0
        res["third_sink_rows"] = third_rows
        if again["embedded"] or third_rows:
            fail(f"persistence: the third run embedded {again['embedded']} rows and wrote {third_rows} sink rows")
        # ---- check 4: launches in the recovering generation
        want_k = ("attention", "slab_scatter", "knn_topk", "bias_act", "add_layer_norm", "embed_ln",
                  "pool_normalize")
        zero = [name for name in want_k if rec["launches"].get(name, 0) == 0]
        log(f"persistence: the recovering generation's launches {json.dumps(rec['launches'])}; K13 "
            f"{rec['launches'].get('topk_select', 0)}")
        if zero:
            fail(f"persistence: not launched in the recovering generation: {zero}")
        if not ({"addmany_b", "addframe"} & set(kinds)) or "addmany" in kinds:
            fail(f"persistence: the input logs hold {json.dumps(kinds)}, not the native module's records")
        launches = {name: sum(d["launches"].get(name, 0) for d in (base, rec, again))
                    for name in set(base["launches"]) | set(rec["launches"])}
    finally:
        done.set()
        shutil.rmtree(workdir, ignore_errors=True)

    # ---- check 5: the 1M slab alone
    index, q32 = ctx["index"], ctx["q_all"][:PERSIST_SLAB_QUERIES]
    torch.cuda.synchronize()
    before_counts = kernels.launch_counts()
    want_rows = index.search(q32, K)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = index.state_dict()
    t1 = time.perf_counter()
    blob = pickle.dumps(state, protocol=pickle.HIGHEST_PROTOCOL)
    t2 = time.perf_counter()
    del state
    fresh = ShardedKnnIndex(HIDDEN, metric="cos", capacity=CAPACITY, device=dev)
    loaded = pickle.loads(blob)
    t3 = time.perf_counter()
    fresh.load_state_dict(loaded)
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    got_rows = fresh.search(q32, K)
    torch.cuda.synchronize()
    after_counts = kernels.launch_counts()
    for name in after_counts:
        launches[name] = launches.get(name, 0) + after_counts[name] - before_counts.get(name, 0)
    slab = {"bytes": len(blob), "state_dict_s": t1 - t0, "pickle_s": t2 - t1, "unpickle_s": t3 - t2,
            "load_state_dict_s": t4 - t3}
    del blob, loaded, fresh
    if got_rows != want_rows:
        fail("persistence: K3 over the restored 1M slab gives other ids or score bits than before")
    res["slab_1m"] = slab
    log(f"persistence: the {CAPACITY}-slot slab: {slab['bytes']} bytes, state_dict {slab['state_dict_s']:.3f} s, "
        f"pickle.dumps {slab['pickle_s']:.3f} s, pickle.loads {slab['unpickle_s']:.3f} s, load_state_dict "
        f"{slab['load_state_dict_s']:.3f} s; {PERSIST_SLAB_QUERIES} queries' ids and score bits equal")
    res["launches"] = launches
    res["wall_s"] = time.perf_counter() - t_phase
    log(f"persistence: launches on the path {json.dumps(launches)}; phase {res['wall_s']:.1f} s")
    if res["wall_s"] > PERSIST_PHASE_S:
        log(f"persistence: the phase took {res['wall_s']:.1f} s, above its {PERSIST_PHASE_S} s")
    return res


def stdlib_data(np, n_docs: int, n_labelled: int, n_questions: int, seed: int) -> dict:
    """Phase 19's inputs, from ``seed``: ``n_docs`` documents from
    ``synthetic_docs``, each starting with its topic's word (one of
    STDLIB_TOPICS) STDLIB_TOPIC_REPEAT times, so that neighbours tend to
    share a topic; event times that rise one second a document with a
    jitter of two, STDLIB_LATE_SHARE of them arriving up to STDLIB_LATE_S
    seconds late; the first ``n_labelled`` documents (in event-time order
    but for the jitter) carry their label, the rest are to be classified;
    and ``n_questions`` questions,
    each with an event time among the classified documents' and a topic."""
    rng = np.random.default_rng(seed + 19)
    topic = rng.integers(0, STDLIB_TOPICS, n_docs)
    texts = [" ".join([f"topic{int(j)}"] * STDLIB_TOPIC_REPEAT) + " " + text
             for j, text in zip(topic, synthetic_docs(np, n_docs, seed + 19))]
    t = np.arange(n_docs) + rng.integers(-2, 3, n_docs)
    late = rng.random(n_docs) < STDLIB_LATE_SHARE
    arrival = t + np.where(late, rng.integers(1, STDLIB_LATE_S + 1, n_docs), 0)
    lo, hi = int(t[n_labelled:].min()), int(t.max())
    return {
        "texts": texts, "topic": [int(j) for j in topic], "t": [int(x) for x in t],
        "labelled": [i < n_labelled for i in range(n_docs)], "late": int(late.sum()),
        "order": [int(i) for i in np.argsort(arrival, kind="stable")],
        "questions": [(q, int(qt), int(qj)) for q, (qt, qj) in enumerate(zip(
            rng.integers(lo, hi + 1, n_questions), rng.integers(0, STDLIB_TOPICS, n_questions)))],
    }


class FinalRows:
    """A ``pw.io.subscribe`` sink: every update counted, and the final rows
    (each (key, row) by its net count)."""

    def __init__(self) -> None:
        import collections

        self.net: collections.Counter = collections.Counter()
        self.updates = 0

    def __call__(self, key, row, time, is_addition) -> None:
        self.net[(int(key), tuple(sorted(row.items())))] += 1 if is_addition else -1
        self.updates += 1

    def rows(self) -> list[dict]:
        return [dict(row) for (_key, row), n in sorted(self.net.items()) if n > 0]


def recording_embedder(cls):
    """``cls`` (an embedder UDF class) whose ``__batch__`` also keeps each
    text's vector in ``seen``, each batch it is handed with its rows in
    ``batches``, and its docs and seconds in ``docs``/``secs``."""

    class Recording(cls):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.seen: dict = {}
            self.batches: list = []
            self.docs, self.secs = 0, 0.0
            self._lock = threading.Lock()

        def __batch__(self, texts):
            t0 = time.perf_counter()
            out = super().__batch__(texts)
            with self._lock:
                self.secs += time.perf_counter() - t0
                self.docs += len(texts)
                self.seen.update(zip(texts, out))
                self.batches.append(([str(t) for t in texts], out))
            return out

    return Recording


def stdlib_graph(pw, embedder, dim: int, data: dict, graph_n: int, knn: dict, commit: int = STDLIB_COMMIT) -> dict:
    """Phase 19's pipeline in the package ``pw`` (the port on the card; the
    CPU tests also build it in the JAX package): documents from a Python
    connector, embedded by ``embedder``; ``knn_lsh_train`` over the
    labelled ones (euclidean: K3's l2sq form) and ``knn_lsh_classify`` of
    the rest; sliding windows per predicted topic with a delay; an interval
    join of the questions with the classified documents on topic; a kNN
    graph over the first ``graph_n`` documents (``KNNIndex``,
    ``get_nearest_items``), its PageRank and its Bellman-Ford distances
    from document 0 (through ``pw.iterate``).  ``knn`` goes to the indexes
    (the port's ``device=``).  Returns the sinks by name."""

    class Doc(pw.Schema):
        doc: int = pw.column_definition(primary_key=True)
        text: str
        t: int
        label: int
        labelled: bool

    class Feed(pw.io.python.ConnectorSubject):
        def run(self) -> None:
            for n, i in enumerate(data["order"]):
                self.next(doc=i, text=data["texts"][i], t=data["t"][i], label=data["topic"][i],
                          labelled=data["labelled"][i])
                if (n + 1) % commit == 0:
                    self.commit()
            self.commit()

    sinks = {name: FinalRows() for name in ("predictions", "windows", "join", "edges", "ranks", "distances")}
    docs = pw.io.python.read(Feed(), schema=Doc).select(
        doc=pw.this.doc, t=pw.this.t, label=pw.this.label, labelled=pw.this.labelled, vec=embedder(pw.this.text))
    labelled = docs.filter(pw.this.labelled).select(doc=pw.this.doc, label=pw.this.label, data=pw.this.vec)
    incoming = docs.filter(~pw.this.labelled).select(doc=pw.this.doc, t=pw.this.t, vec=pw.this.vec)
    index = pw.ml.classifiers.knn_lsh_train(labelled, d=dim, type="euclidean", **knn)
    predicted = pw.ml.classifiers.knn_lsh_classify(index, incoming.vec, k=STDLIB_CLASSIFY_K)
    classified = incoming.join(predicted, pw.left.id == pw.right.id, id=pw.left.id).select(
        doc=pw.left.doc, t=pw.left.t, predicted_label=pw.right.predicted_label)
    windows = classified.windowby(
        classified.t, window=pw.temporal.sliding(hop=STDLIB_HOP, duration=STDLIB_DURATION),
        instance=classified.predicted_label, behavior=pw.temporal.common_behavior(delay=STDLIB_DELAY),
    ).reduce(topic=pw.this._pw_instance, start=pw.this._pw_window_start, count=pw.reducers.count())
    questions = pw.debug.table_from_rows(pw.schema_from_types(qid=int, t=int, topic=int), data["questions"])
    joined = pw.temporal.interval_join(
        questions, classified, questions.t, classified.t, pw.temporal.interval(*STDLIB_JOIN),
        questions.topic == classified.predicted_label).select(qid=pw.left.qid)
    join_counts = joined.groupby(joined.qid).reduce(qid=joined.qid, count=pw.reducers.count())

    graph_docs = docs.filter(pw.this.doc < graph_n)
    gdata = graph_docs.select(doc=pw.this.doc, data=pw.this.vec)
    gindex = pw.ml.KNNIndex(gdata.data, gdata, n_dimensions=dim, distance_type="euclidean", **knn)
    queries = graph_docs.select(u=pw.this.doc, qvec=pw.this.vec)
    nearest = gindex.get_nearest_items(queries.qvec, k=STDLIB_GRAPH_K, with_distances=True)
    pairs = nearest.select(u=pw.this.u, pairs=pw.apply(
        lambda u, vs, ds: tuple((int(v), float(d)) for v, d in zip(vs, ds) if v != u)[:STDLIB_GRAPH_K - 1],
        pw.this.u, pw.this.doc, pw.this.dist))
    edges = pairs.flatten(pairs.pairs).select(
        u=pw.this.u, v=pw.apply(lambda p: p[0], pw.this.pairs), dist=pw.apply(lambda p: p[1], pw.this.pairs))
    ranks = pw.graphs.pagerank(edges.select(u=pw.this.u, v=pw.this.v), steps=STDLIB_PAGERANK_STEPS)
    vertices = graph_docs.select(name=pw.this.doc, dist=pw.apply(lambda d: 0.0 if d == 0 else None, pw.this.doc))
    vertices = vertices.with_id_from(pw.this.name)
    weighted = edges.select(u=vertices.pointer_from(edges.u), v=vertices.pointer_from(edges.v), dist=edges.dist)
    dists = pw.graphs.bellman_ford(vertices, weighted)
    named = dists.join(vertices, pw.left.id == pw.right.id).select(doc=pw.right.name, dist=pw.left.dist)

    for name, table in (("predictions", classified), ("windows", windows), ("join", join_counts),
                        ("edges", edges), ("ranks", ranks), ("distances", named)):
        pw.io.subscribe(table, on_change=sinks[name])
    return sinks


def index_vectors(np, adapter) -> list:
    """The vectors a ``DataIndex`` adapter's ``SegmentedIndex`` holds, from
    its ``state_dict`` (the main slab's valid slots and the delta segment,
    less the tombstones), as rows of f32."""
    state = adapter.index.state_dict()
    main = state["main"]
    out = {key: main["vectors"][slot] for key, slot in main["slot_of"].items() if main["valid"][slot] > 0}
    out.update(zip(state["delta_keys"], state["delta_vectors"]))
    for key in state["tombstones"]:
        out.pop(key, None)
    return [np.asarray(v, np.float32) for v in out.values()]


def vote(labels) -> object:
    """``knn_lsh_classify``'s vote: the most common label, the nearest
    first among equal counts."""
    from collections import Counter

    labels = [label for label in labels if label is not None]
    return Counter(labels).most_common(1)[0][0] if labels else None


def stdlib_check(np, data: dict, sinks: dict, stored: list, graph_stored: list, seen: dict) -> dict:
    """Phase 19's checks over the sinks' final rows.  ``stored`` and
    ``graph_stored`` are the vectors the classifier's and the graph's
    indexes hold, ``seen`` each text's vector as the embedder gave it
    (a stored vector is told by its bytes).  Returns the numbers it read
    and, under ``failed``, what did not hold."""
    import math
    from collections import Counter

    import scipy.sparse
    from scipy.sparse.csgraph import dijkstra

    failed: list = []
    res: dict = {}
    vec = [np.asarray(seen[text], np.float32) for text in data["texts"]]
    doc_of = {v.tobytes(): i for i, v in enumerate(vec)}
    incoming = [i for i, lab in enumerate(data["labelled"]) if not lab]

    def rows_of(stored_rows: list, what: str) -> tuple:
        docs = [doc_of.get(v.tobytes()) for v in stored_rows]
        if None in docs:
            failed.append(f"{what}: a stored vector is no document's embedding")
        return np.stack(stored_rows).astype(np.float64), docs

    def l2sq(mat, q):
        return (q * q).sum(-1, keepdims=True) + (mat * mat).sum(1)[None, :] - 2.0 * (q @ mat.T)

    def nearest(dist, n: int):
        """The ``n`` smallest of ``dist`` in order, equal values by position."""
        part = np.argpartition(dist, min(n, len(dist) - 1))[:n]
        return part[np.lexsort((part, dist[part]))]

    # ---- 1: each prediction against numpy's exact l2sq top-k vote over the stored vectors
    by_doc = {row["doc"]: row["predicted_label"] for row in sinks["predictions"].rows()}
    if sorted(by_doc) != incoming:
        failed.append(f"predictions for {len(by_doc)} documents, expected {len(incoming)}")
    mat, docs = rows_of(stored, "the classifier's index")
    if sorted(d for d in docs if d is not None) != [i for i, lab in enumerate(data["labelled"]) if lab]:
        failed.append(f"the classifier's index holds {len(docs)} rows, not the labelled documents")
    labels = [None if d is None else data["topic"][d] for d in docs]
    ties = wrong = compared = 0
    k = STDLIB_CLASSIFY_K
    qs = [i for i in incoming if i in by_doc]
    for start in range(0, len(qs), 512):
        chunk = qs[start : start + 512]
        dist = l2sq(mat, np.stack([vec[i] for i in chunk]).astype(np.float64))
        for row, i in enumerate(chunk):
            order = nearest(dist[row], k + 1)
            top = dist[row, order]
            near = np.abs(np.diff(top)) <= STDLIB_TIE_RTOL * np.maximum(np.abs(top[1:]), 1e-12)
            labs = [labels[j] for j in order]
            want = vote(labs[:k])
            # a tie: two neighbours (the 10th and 11th among them) whose distances
            # are within STDLIB_TIE_RTOL and whose swap changes the vote
            if any(near[p] and vote((labs[:p] + [labs[p + 1], labs[p]] + labs[p + 2 :])[:k]) != want
                   for p in range(len(near))):
                ties += 1
                continue
            compared += 1
            wrong += by_doc[i] != want
    share = compared / max(1, len(qs))
    res.update(classify_compared=compared, classify_ties=ties, classify_wrong=wrong, compared_share=share)
    if wrong or share < STDLIB_COMPARED:
        failed.append(f"classification: {wrong} of {compared} predictions differ from numpy's vote, {ties} ties, "
                      f"{share:.4f} compared")
    # ---- 2: windows against a Python count over the predictions received
    want_w: Counter = Counter()
    for i, label in by_doc.items():
        t = data["t"][i]
        for n in range(math.floor((t - STDLIB_DURATION) / STDLIB_HOP) + 1, math.floor(t / STDLIB_HOP) + 1):
            want_w[(label, n * STDLIB_HOP)] += 1
    got_w = {(row["topic"], row["start"]): row["count"] for row in sinks["windows"].rows()}
    res["windows"] = len(got_w)
    if got_w != dict(want_w):
        bad = sorted(set(got_w.items()) ^ set(want_w.items()))[:5]
        failed.append(f"windows: {len(got_w)} (topic, window) counts against Python's {len(want_w)}: {bad}")
    # ---- 3: the interval join's counts per question
    by_topic: dict = {}
    for i, label in by_doc.items():
        by_topic.setdefault(label, []).append(data["t"][i])
    want_j = {q: n for q, qt, topic in data["questions"]
              if (n := sum(STDLIB_JOIN[0] <= t - qt <= STDLIB_JOIN[1] for t in by_topic.get(topic, ())))}
    got_j = {row["qid"]: row["count"] for row in sinks["join"].rows()}
    res["questions_matched"] = len(got_j)
    if got_j != want_j:
        failed.append(f"interval join: {len(got_j)} questions' counts against Python's {len(want_j)}")
    # ---- 4: the edges against numpy's exact top-k over the graph slab's vectors
    edges = sinks["edges"].rows()
    out_of: dict = {}
    for e in edges:
        out_of.setdefault(e["u"], []).append((e["dist"], e["v"]))
    gmat, gdocs = rows_of(graph_stored, "the graph's index")
    edge_abs, edge_bad, fifth = 0.0, 0, []
    for u, got in sorted(out_of.items()):
        dist = l2sq(gmat, vec[u].astype(np.float64)[None, :])[0]
        want = [(float(dist[j]), gdocs[j]) for j in nearest(dist, STDLIB_GRAPH_K) if gdocs[j] != u]
        want, got = want[: STDLIB_GRAPH_K - 1], sorted(got)
        fifth.append(want[-1][0])
        # a neighbour may trade places with one whose distance is within TOPK_ATOL
        if len(got) != len(want) or any(g[1] != w[1] and abs(g[0] - w[0]) > TOPK_ATOL
                                         for g, w in zip(got, want)):
            edge_bad += 1
            continue
        for g, w in zip(got, want):
            edge_abs = max(edge_abs, abs(g[0] - w[0]))
    res.update(edges=len(edges), edge_abs_err=edge_abs, fifth_dist_median=float(np.median(fifth)) if fifth else None)
    if len(out_of) != len(graph_stored) or edge_bad or edge_abs > TOPK_ATOL:
        failed.append(f"edges: {len(out_of)} vertices with edges of {len(graph_stored)}, {edge_bad} neighbour "
                      f"lists differ from numpy's, distances within {edge_abs:.2e} of numpy's (gate {TOPK_ATOL})")
    # ---- 5: PageRank and Bellman-Ford over the edges received
    verts = sorted({e["u"] for e in edges} | {e["v"] for e in edges})
    deg = Counter(e["u"] for e in edges)
    rank = dict.fromkeys(verts, 1.0)
    for _ in range(STDLIB_PAGERANK_STEPS):
        total: dict = {}
        for e in edges:
            total[e["v"]] = total.get(e["v"], 0.0) + rank[e["u"]] / deg[e["u"]]
        rank = {w: 0.15 + 0.85 * total.get(w, 0.0) for w in verts}
    got_r = {row["w"]: row["rank"] for row in sinks["ranks"].rows()}
    rank_err = max((abs(got_r[w] - rank[w]) / rank[w] for w in verts if w in got_r), default=0.0)
    res["rank_rel_err"] = rank_err
    if sorted(got_r) != verts or rank_err > STDLIB_GRAPH_RTOL:
        failed.append(f"pagerank: {len(got_r)} ranks of {len(verts)} vertices, within {rank_err:.2e} relative")
    pos = {v: j for j, v in enumerate(verts)}
    csr = scipy.sparse.csr_matrix(([e["dist"] for e in edges], ([pos[e["u"]] for e in edges],
                                   [pos[e["v"]] for e in edges])), shape=(len(verts), len(verts)))
    want_d = dijkstra(csr, directed=True, indices=pos[0]) if 0 in pos else np.full(len(verts), np.inf)
    got_d = {row["doc"]: row["dist"] for row in sinks["distances"].rows()}
    dist_err, dist_bad = 0.0, 0
    for v, j in pos.items():
        g, w = got_d.get(v), float(want_d[j])
        if g is None or math.isinf(g) != math.isinf(w) or (w == 0.0) != (g == 0.0):
            dist_bad += 1
        elif not math.isinf(w) and w > 0.0:
            dist_err = max(dist_err, abs(g - w) / w)
    res.update(reachable=int(np.isfinite(want_d).sum()), dist_rel_err=dist_err)
    if sorted(got_d) != verts or dist_bad or dist_err > STDLIB_GRAPH_RTOL:
        failed.append(f"bellman-ford: {len(got_d)} distances of {len(verts)} vertices, {dist_bad} differ from "
                      f"scipy's in reach, within {dist_err:.2e} relative")
    res["failed"] = failed
    return res


def phase_stdlib(torch, dev, smi: str) -> dict:
    """Phase 19: the streaming stdlib on the card (slice 16d).  One
    ``pw.run`` of ``stdlib_graph`` over ``stdlib_data``'s STDLIB_DOCS
    documents and STDLIB_QUESTIONS questions, embedded by BGE-base
    (``TorchEncoderEmbedder``, bf16, phase 3's seed) as a UDF: the
    classifier's slab starts at ``KNNIndex``'s own reserve and grows on the
    card (each grow timed) to hold the labelled documents (K2 scatters,
    K3 searches in its l2sq form); every check of ``stdlib_check``, and
    K1-K7 launched on the path.  Then K3's l2sq form on the graph slab
    against its plain version (the sign, and the clamp at 0 on the rows'
    own distances), and one classify epoch's device work profiled."""
    import numpy as np

    import pathway_tpu_torch as pw
    from pathway_tpu_torch import TorchEncoderEmbedder, kernels
    from pathway_tpu_torch.engine.external_index import ExternalIndexNode
    from pathway_tpu_torch.internals.iterate import IterateNode
    import importlib
    from pathway_tpu_torch.parallel import ShardedKnnIndex, sharded_knn

    res: dict = {"card": smi}
    t_phase = time.perf_counter()
    data = stdlib_data(np, STDLIB_DOCS, STDLIB_LABELLED, STDLIB_QUESTIONS, SEED)
    embedder = recording_embedder(TorchEncoderEmbedder)("bge-base", max_batch_size=STDLIB_BATCH, seed=SEED,
                                                         device=dev)
    grows: list = []
    k3_metrics: dict = {}
    real_grow, real_k3 = ShardedKnnIndex._grow, sharded_knn.knn_topk

    def timed_grow(self) -> None:
        torch.cuda.synchronize()
        t0, before = time.perf_counter(), self.capacity
        real_grow(self)
        torch.cuda.synchronize()
        grows.append({"from": before, "to": self.capacity, "s": time.perf_counter() - t0})

    def k3_by_metric(queries, slab, valid, k, metric, offset=0):
        k3_metrics[metric] = k3_metrics.get(metric, 0) + 1
        return real_k3(queries, slab, valid, k, metric, offset=offset)

    pw.G.clear()
    sinks = stdlib_graph(pw, embedder, HIDDEN, data, STDLIB_GRAPH, {"device": dev})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ShardedKnnIndex._grow, sharded_knn.knn_topk = timed_grow, k3_by_metric
    kernels.reset_launch_counts()
    try:
        t0 = time.perf_counter()
        pw.run(monitoring_level=pw.MonitoringLevel.NONE)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
    finally:
        ShardedKnnIndex._grow, sharded_knn.knn_topk = real_grow, real_k3
    launches = kernels.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    nodes = pw.G.engine_graph.nodes
    adapters = [n.adapter for n in nodes if isinstance(n, ExternalIndexNode)]
    rounds = [n.rounds for n in nodes if isinstance(n, IterateNode)]
    if len(adapters) != 2 or len(rounds) != 1:
        fail(f"stdlib: {len(adapters)} index nodes and {len(rounds)} iterate nodes, expected 2 and 1")
    classifier, graph = sorted(adapters, key=lambda a: -len(a.index))
    for a in adapters:
        a.index.merge(wait=True)
    stored, graph_stored = index_vectors(np, classifier), index_vectors(np, graph)
    t0 = time.perf_counter()
    checked = stdlib_check(np, data, sinks, stored, graph_stored, embedder.seen)
    check_s = time.perf_counter() - t0
    res.update({
        "run_s": run_s, "docs_classified_per_s": (STDLIB_DOCS - STDLIB_LABELLED) / run_s,
        "docs_per_s_end_to_end": STDLIB_DOCS / run_s,
        "udf_docs_per_s": embedder.docs / embedder.secs, "udf_docs": embedder.docs, "udf_s": embedder.secs,
        "grows": grows, "late_docs": data["late"], "k3_calls_by_metric": k3_metrics,
        "windows_emitted": sinks["windows"].updates, "iterate_rounds": rounds[0],
        "sink_updates": {name: sink.updates for name, sink in sinks.items()},
        "peak_gb": peak_gb, "check_s": check_s, "launches": launches,
        **{key: val for key, val in checked.items() if key != "failed"},
    })
    log(f"stdlib on {smi}: pw.run {run_s:.2f} s for {STDLIB_DOCS} documents ({STDLIB_DOCS - STDLIB_LABELLED} "
        f"classified: {res['docs_classified_per_s']:.1f} docs/s end to end; {res['docs_per_s_end_to_end']:.1f} "
        f"documents/s in all), the UDF {embedder.docs} docs in {embedder.secs:.2f} s "
        f"({res['udf_docs_per_s']:.1f} docs/s), {data['late']} late; peak {peak_gb:.2f} GB")
    log(f"stdlib: slab grows {json.dumps(grows)}; K3 calls by metric {json.dumps(k3_metrics)}; "
        f"ties excluded {checked.get('classify_ties')}, compared {checked.get('classify_compared')} "
        f"({checked.get('compared_share')}); windows {checked.get('windows')} with {sinks['windows'].updates} "
        f"updates emitted; questions matched {checked.get('questions_matched')}; edges {checked.get('edges')} "
        f"(abs err {checked.get('edge_abs_err')}); ranks rel err {checked.get('rank_rel_err')}, distances rel err "
        f"{checked.get('dist_rel_err')} ({checked.get('reachable')} reachable); bellman_ford's pw.iterate rounds "
        f"per solve {rounds[0]}; sink updates {json.dumps(res['sink_updates'])}; checks {check_s:.1f} s")
    log(f"stdlib: launches on the path {json.dumps(launches)}; K13 {launches.get('topk_select', 0)}")
    if checked["failed"]:
        fail("stdlib: " + "; ".join(checked["failed"]))
    want_k = ("attention", "slab_scatter", "knn_topk", "bias_act", "add_layer_norm", "embed_ln", "pool_normalize")
    zero = [name for name in want_k if launches.get(name, 0) == 0]
    if zero or not k3_metrics.get("l2sq"):
        fail(f"stdlib: not launched on the path: {zero}; K3 calls by metric {k3_metrics}")
    if len(grows) < 1:
        fail("stdlib: the classifier's slab never grew from KNNIndex's reserve")

    # ---- K3's l2sq form on the graph slab against its plain version
    k3_mod = importlib.import_module("pathway_tpu_torch.kernels.knn_topk")
    main = graph.index.main
    rows = torch.nonzero(main._valid > 0).flatten()[:256]
    q = main._vectors[rows].float()
    got_v, got_i = k3_mod.knn_topk(q, main._vectors, main._valid, STDLIB_GRAPH_K, "l2sq")
    want_v, _ = k3_mod.knn_topk_plain(q, main._vectors, main._valid, STDLIB_GRAPH_K, "l2sq")
    k3_err = float((got_v - want_v).abs().max())
    # both against the exact squared distances of the slots K3 chose (f64, by differences)
    exact = ((q.double()[:, None, :] - main._vectors.double()[got_i.long()]) ** 2).sum(-1)
    res.update(k3_l2sq_err=k3_err, k3_l2sq_exact_err=float((got_v.double() + exact).abs().max()),
               plain_l2sq_exact_err=float((want_v.double() + exact).abs().max()))
    # rows against themselves: the form's cancellation is at its largest (q.x near |q||x|)
    if (max(k3_err, res["k3_l2sq_exact_err"]) > TOPK_ATOL or float(got_v.max()) > 0.0
            or not torch.equal(got_i[:, 0], rows.to(got_i.dtype))):
        fail(f"stdlib: K3 l2sq against its plain version: {k3_err:.2e}, against the exact distances "
             f"{res['k3_l2sq_exact_err']:.2e}, max score {float(got_v.max())} (negated distances are <= 0), "
             f"self first {bool(torch.equal(got_i[:, 0], rows.to(got_i.dtype)))}")
    log(f"stdlib: K3 l2sq on {len(rows)} graph rows within {k3_err:.2e} of its plain version; every score <= 0, "
        f"each row's own slot first (its distance clamped at {float(got_v[:, 0].max()):.3e}); against the exact "
        f"squared distances K3 {res['k3_l2sq_exact_err']:.2e}, its plain version {res['plain_l2sq_exact_err']:.2e}")

    # ---- one classify epoch: STDLIB_COMMIT documents embedded and searched at k=10
    texts = [data["texts"][i] for i in range(STDLIB_LABELLED, STDLIB_LABELLED + STDLIB_COMMIT)]

    def classify_epoch() -> None:
        vecs = np.stack(TorchEncoderEmbedder.__batch__(embedder, texts))
        classifier.index.search(vecs, STDLIB_CLASSIFY_K)

    classify_epoch()
    res["classify_epoch_profile"] = profile_call(torch, classify_epoch, len(texts))
    prof = res["classify_epoch_profile"]
    log(f"stdlib: one classify epoch ({len(texts)} documents embedded, searched at k={STDLIB_CLASSIFY_K}): "
        f"{prof['wall_ms']:.1f} ms, device busy {prof['device_busy_ms']:.1f} ms, idle share "
        f"{prof['device_idle_share']:.3f}; top {json.dumps(prof['top'][:6])}")
    res["wall_s"] = time.perf_counter() - t_phase
    log(f"stdlib: phase {res['wall_s']:.1f} s")
    if res["wall_s"] > STDLIB_PHASE_S:
        log(f"stdlib: the phase took {res['wall_s']:.1f} s, above its {STDLIB_PHASE_S} s")
    pw.G.clear()
    return res


APPS_YAML = """\
# A RAG app in the reference's template form (integration_tests/rag_evals/app.yaml)
$sources:
  - !pw.io.fs.read
    path: {docs_dir}
    format: binary
    mode: static
    with_metadata: true

$llm: !apps_helpers.DigestChat

$embedder: !pw.xpacks.llm.embedders.TorchEncoderEmbedder
  model: bge-base
  config: {config}
  max_batch_size: {batch}
  seed: {seed}
  device: {device}

$splitter: !pw.xpacks.llm.splitters.TokenCountSplitter
  min_tokens: {min_tokens}
  max_tokens: {max_tokens}

$parser: !pw.xpacks.llm.parsers.ParseUtf8

$retriever_factory: !pw.stdlib.indexing.BruteForceKnnFactory
  reserved_space: {capacity}
  embedder: $embedder
  device: {device}

$document_store: !pw.xpacks.llm.document_store.DocumentStore
  docs: $sources
  parser: $parser
  splitter: $splitter
  retriever_factory: $retriever_factory

question_answerer: !pw.xpacks.llm.question_answering.BaseRAGQuestionAnswerer
  llm: $llm
  indexer: $document_store
  search_topk: {topk}

host: "127.0.0.1"
port: {port}
"""

APPS_HELPERS = '''\
"""The YAML app's stand-in chat: the digest of its messages."""
import hashlib
import json

from pathway_tpu_torch.xpacks.llm.llms import BaseChat


class DigestChat(BaseChat):
    def __wrapped__(self, messages, **kwargs):
        return "digest:" + hashlib.sha256(json.dumps(messages).encode()).hexdigest()[:16]
'''

APPS_PROGRAM = '''\
"""A RAG app deployed from app.yaml beside this file, as
``python -m pathway_tpu_torch.cli spawn --threads 2 python app.py`` starts
it.  With APPS_STOP naming a file, a watcher stops the run once that file
appears, and the program then writes its kernel launches and the batches
its embedder encoded to the file APPS_RESULT names."""
import json
import os
import threading
import time

import pathway_tpu_torch as pw
from pathway_tpu_torch import kernels

HERE = os.path.dirname(os.path.abspath(__file__))
with open(os.path.join(HERE, "app.yaml")) as f:
    app = pw.load_yaml(f)
qa = app["question_answerer"]
encoder = qa.indexer.retriever_factory.embedder.encoder
batches = []
encode = encoder.encode


def recorded(texts):
    batches.append([str(t) for t in texts])
    return encode(texts)


encoder.encode = recorded
stop = os.environ.get("APPS_STOP")
if stop:
    def watch():
        while not os.path.exists(stop) or pw.G.active_scheduler is None:
            time.sleep(0.05)
        pw.G.active_scheduler.stop()

    threading.Thread(target=watch, daemon=True).start()
kernels.reset_launch_counts()
t0 = time.perf_counter()
qa.run_server(app["host"], app["port"])
if stop:
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()
    with open(os.environ["APPS_RESULT"], "w") as f:
        json.dump({"launches": kernels.launch_counts(), "batches": batches, "run_s": time.perf_counter() - t0,
                   "threads": os.environ.get("PATHWAY_THREADS"), "process": os.environ.get("PATHWAY_PROCESS_ID"),
                   "encoder_device": str(encoder.device)}, f)
'''


def lint_key(line: str) -> str:
    """A finding's line without its node number and trace: what a graph
    built in another process (``cli lint``) and in this one share."""
    import re

    line = re.sub(r" at [^\[\]]*$", "", line)
    return re.sub(r"#\d+\]$", "]", line)


def apps_yaml_app(torch, dev, np, smi: str) -> dict:
    """Phase 20 (a): ``APPS_YAML`` (the reference's template form: BGE-base
    as ``TorchEncoderEmbedder`` on the card with phase 3's seed, a
    ``BruteForceKnnFactory`` of CAPACITY slots, phase 15's splitter, a
    stand-in chat) over phase 15's APPS_DOCS files, started by
    ``python -m pathway_tpu_torch.cli spawn --threads 2 python app.py`` in
    a child process group; ``cli lint app.py`` in another meanwhile.
    Checks: APPS_QUESTIONS /v1/retrieve replies at k=K against the direct
    path built here on the same seed (the child's own encoder batches
    through ``TorchEncoder.encode``, a ``ShardedKnnIndex`` on the card):
    ids equal, scores within TOPK_ATOL; ``evaluate_retrieval`` of both equal;
    APPS_QA answers whose context equals /v1/retrieve at search_topk and
    whose response is the stand-in's digest; the child's launches (K1,
    K4-K7, K2, K3 above 0) from the file it writes at exit; its exit code
    0; ``lint``'s findings equal to ``pw.analyze`` of the same graph built
    in this process."""
    import shutil
    import signal
    import tempfile

    import pathway_tpu_torch as pw
    from pathway_tpu_torch import ShardedKnnIndex
    from pathway_tpu_torch.analysis import format_diagnostics
    from pathway_tpu_torch.xpacks.llm import prompts
    from pathway_tpu_torch.xpacks.llm.llms import prompt_chat_single_qa
    from pathway_tpu_torch.xpacks.llm.rag_eval import RagEvalItem, evaluate_retrieval
    from pathway_tpu_torch.xpacks.llm.splitters import TokenCountSplitter

    res: dict = {"card": smi}
    t_part = time.perf_counter()
    docs = synthetic_docs(np, N_DOCS, SEED)[:APPS_DOCS]
    root = tempfile.mkdtemp(prefix="apps_")
    docs_dir, app_dir = os.path.join(root, "docs"), os.path.join(root, "app")
    os.makedirs(docs_dir)
    os.makedirs(app_dir)
    for i, text in enumerate(docs):
        with open(os.path.join(docs_dir, f"doc{i:05d}.txt"), "w") as f:
            f.write(text)
    port = free_port()
    app_yaml = APPS_YAML.format(
        docs_dir=docs_dir, config=APPS_CONFIG, batch=APPS_BATCH, seed=SEED, device=APPS_DEVICE,
        min_tokens=SERVER_SPLIT[0], max_tokens=SERVER_SPLIT[1], capacity=CAPACITY, topk=SERVER_QA_TOPK, port=port)
    with open(os.path.join(app_dir, "app.yaml"), "w") as f:
        f.write(app_yaml)
    for name, text in (("app.py", APPS_PROGRAM), ("apps_helpers.py", APPS_HELPERS)):
        with open(os.path.join(app_dir, name), "w") as f:
            f.write(text)
    app_py = os.path.join(app_dir, "app.py")
    stop, result = os.path.join(root, "stop"), os.path.join(root, "result.json")
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(p for p in (repo, os.environ.get("PYTHONPATH")) if p))
    cli = [sys.executable, "-m", "pathway_tpu_torch.cli"]
    app_log = open(os.path.join(root, "app.log"), "w")
    t0 = time.perf_counter()
    proc = subprocess.Popen([*cli, "spawn", "--threads", str(APPS_THREADS), sys.executable, app_py], cwd=app_dir,
                            env={**env, "APPS_STOP": stop, "APPS_RESULT": result,
                                 "PATHWAY_INDEX_DELTA_CAP": str(APPS_DELTA_CAP)}, stdout=app_log,
                            stderr=subprocess.STDOUT, start_new_session=True)
    lint = subprocess.Popen([*cli, "lint", app_py], cwd=app_dir, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, start_new_session=True)

    def app_tail() -> str:
        app_log.flush()
        with open(os.path.join(root, "app.log")) as f:
            return f.read()[-3000:]

    def post(path: str, payload: dict):
        status, _retry, body = post_json(port, path, payload, timeout=APPS_DEADLINE_S)
        if status != 200:
            fail(f"apps: {path} answered {status}: {body}")
        return body

    try:
        # ---- the app's start: every file in its statistics
        while True:
            if proc.poll() is not None:
                fail(f"apps: the spawned app exited with {proc.returncode} before it served:\n{app_tail()}")
            if time.perf_counter() - t0 > APPS_DEADLINE_S:
                fail(f"apps: the app did not serve {APPS_DOCS} files in {APPS_DEADLINE_S} s:\n{app_tail()}")
            try:
                if post_json(port, "/v1/statistics", {}, timeout=5.0)[2].get("file_count") == APPS_DOCS:
                    break
            except OSError:
                pass
            time.sleep(0.1)
        res["ready_s"] = time.perf_counter() - t0
        # ---- the questions, one at a time, and the answers
        rng = np.random.default_rng(SEED + 21)
        source = [int(i) for i in rng.integers(0, len(docs), APPS_QUESTIONS)]
        questions = synthetic_questions(np, docs, APPS_QUESTIONS, SEED + 21)
        replies, ms = [], []
        for q in questions:
            t1 = time.perf_counter()
            replies.append(post("/v1/retrieve", {"query": q, "k": K}))
            ms.append((time.perf_counter() - t1) * 1e3)
        answers = [post("/v1/pw_ai_answer", {"prompt": q, "return_context_docs": True}) for q in questions[:APPS_QA]]
        contexts = [post("/v1/retrieve", {"query": q, "k": SERVER_QA_TOPK}) for q in questions[:APPS_QA]]
        with open(stop, "w"):
            pass
        rc = proc.wait(timeout=APPS_DEADLINE_S)
        res["app_s"] = time.perf_counter() - t0
        if rc != 0:
            fail(f"apps: the spawned app exited with {rc}:\n{app_tail()}")
        lint_out, lint_err = lint.communicate(timeout=APPS_DEADLINE_S)
        with open(result) as f:
            child = json.load(f)
    finally:
        for p in (proc, lint):
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
        app_log.close()
        with open(os.path.join(root, "app.log")) as f:
            res["app_log_tail"] = f.read()[-2000:]
        shutil.rmtree(root, ignore_errors=True)
    launches = child["launches"]
    res.update(launches=launches, child_threads=child["threads"], child_encoder_device=child["encoder_device"],
               child_run_s=child["run_s"], encoder_batches=len(child["batches"]))
    missing = [n for n in ("attention", "bias_act", "add_layer_norm", "embed_ln", "pool_normalize", "slab_scatter",
                           "knn_topk") if launches.get(n, 0) == 0]
    if missing or child["threads"] != str(APPS_THREADS) or not child["encoder_device"].startswith("cuda"):
        fail(f"apps: the app launched no {missing}; threads {child['threads']}, encoder on "
             f"{child['encoder_device']}")

    # ---- the same graph built here: pw.analyze against cli lint
    pw.G.clear()
    os.makedirs(app_dir)
    for name, text in (("apps_helpers.py", APPS_HELPERS),):
        with open(os.path.join(app_dir, name), "w") as f:
            f.write(text)
    sys.path.insert(0, app_dir)
    try:
        app = pw.load_yaml(app_yaml)
        app["question_answerer"].build_server(app["host"], app["port"])
        findings = pw.analyze()
    finally:
        sys.path.remove(app_dir)
        sys.modules.pop("apps_helpers", None)
        shutil.rmtree(root, ignore_errors=True)
    want_lint = [lint_key(line) for line in format_diagnostics(findings).splitlines()]
    got_lint = [lint_key(line) for line in lint_out.splitlines() if line.startswith("PW-")]
    res["lint"] = {"findings": len(got_lint), "summary": lint_err.strip().splitlines()[-1] if lint_err else "",
                   "codes": sorted({line.split(" ", 1)[0] for line in got_lint})}
    if lint.returncode not in (0, 1) or got_lint != want_lint:
        fail(f"apps: cli lint (exit {lint.returncode}) printed {got_lint}, pw.analyze here {want_lint}: {lint_err}")

    # ---- the direct path: the child's batches through TorchEncoder.encode on the same seed
    encoder = app["question_answerer"].indexer.retriever_factory.embedder.encoder
    pw.G.clear()
    emb: dict = {}
    for texts in child["batches"]:
        for t, row in zip(texts, encoder.encode(texts)):
            if t in emb and not np.array_equal(emb[t], row):
                fail(f"apps: the text {t[:40]!r} embeds differently in two of the app's batches")
            emb[t] = row
    splitter = TokenCountSplitter(min_tokens=SERVER_SPLIT[0], max_tokens=SERVER_SPLIT[1])
    key_info = [(os.path.join(docs_dir, f"doc{i:05d}.txt"), c) for i, text in enumerate(docs)
                for c, _ in splitter.__wrapped__(text)]
    key_of = {info: g for g, info in enumerate(key_info)}
    direct = ShardedKnnIndex(HIDDEN, metric="cos", capacity=CAPACITY, device=dev)
    direct.add_batch(list(range(len(key_info))), np.stack([emb[c] for _, c in key_info]))
    # one question a search, as the app's index searched each request
    want = [direct.search(emb[q][None], K)[0] for q in questions]
    got = [[(key_of[(d["metadata"]["path"], d["text"])], d["score"]) for d in hits] for hits in replies]
    worst = compare_rows(got, want, K, TOPK_ATOL, "apps: /v1/retrieve against the direct path")
    # ids rank by rank; where they differ, the two chunks' exact cosines to
    # the question must be a near-tie (the app's rows still in its delta
    # segment are scored on the host, in another order of summation)
    ids_equal, near_ties = 0, []

    def cos(q: str, key: int) -> float:
        a, b = np.asarray(emb[q], np.float64), np.asarray(emb[key_info[key][1]], np.float64)
        return float(a @ b / np.linalg.norm(a) / np.linalg.norm(b))

    for q, g, w in zip(questions, got, want):
        swapped = [(a, b) for (a, _), (b, _) in zip(g, w) if a != b]
        ids_equal += not swapped
        near_ties += [abs(cos(q, a) - cos(q, b)) for a, b in swapped]
    if near_ties and max(near_ties) > TOPK_ATOL:
        fail(f"apps: {len(questions) - ids_equal} replies differ from the direct path's ids, by up to "
             f"{max(near_ties):.2e} of cosine: beyond a near-tie")
    items = [RagEvalItem(q, {os.path.join(docs_dir, f"doc{i:05d}.txt")}) for q, i in zip(questions, source)]
    served = evaluate_retrieval(items, lambda q, k: [key_info[key][0] for key, _ in got[questions.index(q)]][:k], k=K)
    by_hand = evaluate_retrieval(items, lambda q, k: [key_info[key][0] for key, _ in want[questions.index(q)]][:k],
                                 k=K)
    if served.recall_at_k != by_hand.recall_at_k:
        fail(f"apps: recall@{K} served {served.recall_at_k}, direct path {by_hand.recall_at_k}")
    for q, answer, ctx in zip(questions, answers, contexts):
        if [(d["metadata"]["path"], d["text"]) for d in answer["context_docs"]] != \
                [(d["metadata"]["path"], d["text"]) for d in ctx]:
            fail("apps: a QA answer's context docs are not /v1/retrieve's at search_topk")
        digest = "digest:" + __import__("hashlib").sha256(json.dumps(prompt_chat_single_qa(
            prompts.prompt_qa_geometric_rag(q, answer["context_docs"]))).encode()).hexdigest()[:16]
        if answer["response"] != digest:
            fail(f"apps: the QA response {answer['response']!r} is not the stand-in's {digest!r}")
    del direct
    torch.cuda.empty_cache()
    res.update({
        "docs": APPS_DOCS, "chunks": len(key_info), "questions": APPS_QUESTIONS, "k": K,
        "http_p50_ms": float(np.percentile(ms, 50)), "http_p99_ms": float(np.percentile(ms, 99)),
        "ids_equal": ids_equal, "near_tie_swaps": len(near_ties), "max_abs_err_vs_direct": worst, "recall_at_k": served.recall_at_k,
        "qa_checked": APPS_QA, "wall_s": time.perf_counter() - t_part,
    })
    log(f"apps (a) on {smi}: the YAML app spawned with --threads {APPS_THREADS} served {APPS_DOCS} files "
        f"({len(key_info)} chunks) {res['ready_s']:.1f} s after its start; {APPS_QUESTIONS} questions at k={K}: "
        f"p50 {res['http_p50_ms']:.2f} ms, p99 {res['http_p99_ms']:.2f} ms, ids equal to the direct path's "
        f"{ids_equal}/{APPS_QUESTIONS} (near-tie swaps {len(near_ties)}), scores within {worst:.2e}, recall@{K} {served.recall_at_k}; lint "
        f"{res['lint']['summary']!r} equal to pw.analyze; the app's launches {json.dumps(launches)}")
    return res


def same_rows(got: list, want: list, what: str) -> int:
    """Rows (value tuples) equal as multisets, floats within
    APPS_FLOAT_RTOL; returns the row count."""
    def key(row):
        return tuple((0, round(v, 6)) if isinstance(v, float) else (1, repr(v)) for v in row)

    got, want = sorted(got, key=key), sorted(want, key=key)
    ok = len(got) == len(want) and all(
        len(g) == len(w) and all(
            abs(a - b) <= APPS_FLOAT_RTOL * max(1.0, abs(a), abs(b)) if isinstance(b, float) else a == b
            for a, b in zip(g, w))
        for g, w in zip(got, want))
    if not ok:
        fail(f"apps: {what}: {len(got)} rows against sqlite's {len(want)}; first differing "
             f"{next(((g, w) for g, w in zip(got, want) if g != w), None)}")
    return len(got)


#: phase 20's statements over ``docs(doc, topic, word, nearest_topic,
#: score)`` and ``topics(tid, tname, parity)``, each run by pw.sql and by
#: sqlite3; "grouped" is the LiveTable's and the viz's
APPS_SQL = {
    "grouped": "SELECT topic, COUNT(*) AS n, SUM(score) AS total, MIN(score) AS lo, MAX(score) AS hi "
               "FROM docs GROUP BY topic HAVING COUNT(*) > 0",
    "having": "SELECT nearest_topic, COUNT(*) AS n, AVG(score) AS mean FROM docs "
              "WHERE score > 0.5 GROUP BY nearest_topic HAVING COUNT(*) > 100",
    "join": "SELECT doc, tname, score FROM docs JOIN topics ON docs.nearest_topic = topics.tid "
            "WHERE topic <> nearest_topic",
    "setops": "SELECT nearest_topic FROM docs WHERE topic = nearest_topic UNION SELECT tid FROM topics "
              "WHERE parity = 1 EXCEPT SELECT tid FROM topics WHERE tid < 4",
    "intersect": "SELECT topic FROM docs WHERE word LIKE 'w1%' INTERSECT SELECT tid FROM topics WHERE parity = 0",
    "in_subquery": "SELECT doc, score FROM docs WHERE nearest_topic IN (SELECT tid FROM topics WHERE parity = 1) "
                   "AND score > 0.9",
    "case": "SELECT doc, CASE WHEN score >= 0.95 THEN 'high' WHEN score BETWEEN 0.8 AND 0.95 THEN 'mid' "
            "ELSE 'low' END AS tier FROM docs WHERE word LIKE 'w2%' AND doc < 4096",
}


def apps_stream(torch, dev, np, smi: str) -> dict:
    """Phase 20 (b) with ``PATHWAY_INDEX_DELTA_CAP`` at APPS_DELTA_CAP, so
    that the 16 topic rows go past the delta segment into the slab (K2)."""
    saved = os.environ.get("PATHWAY_INDEX_DELTA_CAP")
    os.environ["PATHWAY_INDEX_DELTA_CAP"] = str(APPS_DELTA_CAP)
    try:
        return _apps_stream(torch, dev, np, smi)
    finally:
        if saved is None:
            os.environ.pop("PATHWAY_INDEX_DELTA_CAP", None)
        else:
            os.environ["PATHWAY_INDEX_DELTA_CAP"] = saved


def _apps_stream(torch, dev, np, smi: str) -> dict:
    """Phase 20 (b): ``pw.demo.generate_custom_stream`` streams phase 19's
    APPS_STREAM_DOCS documents into BGE-base as a UDF on the card; each is
    searched at k=1 (``KNNIndex``, cosine: K2 scatters the 16 topic
    queries, K3 searches) for its ``nearest_topic`` and ``score``; the
    APPS_SQL statements run over that table and a ``topics`` table, the
    grouped one read through ``pw.live`` during the run (interactive mode)
    and drawn by ``table_viz`` and ``plot``; the scored table is
    ``export_table``d.  Then a second graph ``import_table``s it, indexes
    its embeddings on the card and answers APPS_IMPORT_QUESTIONS questions
    at k=10.  Checks: every statement equals sqlite3's over the rows the
    pipeline wrote; nearest topics and scores against numpy (f64) over the
    UDF's embeddings (TOPK_ATOL; near-ties excluded); the LiveTable's final
    rows equal sqlite's, with a partial read during the run; the HTML and
    SVG hold the grouped rows' values; the imported index's top-10 against
    numpy's exact top-10 (``compare_topk`` at TOPK_ATOL); K1, K4-K7, K2 and
    K3 launched; one SQL epoch profiled."""
    import html
    import sqlite3

    import pathway_tpu_torch as pw
    from pathway_tpu_torch import TorchEncoderEmbedder, kernels
    from pathway_tpu_torch.internals import interactive

    res: dict = {"card": smi}
    t_part = time.perf_counter()
    data = stdlib_data(np, APPS_STREAM_DOCS, STDLIB_LABELLED, STDLIB_QUESTIONS, SEED)
    texts, topic = data["texts"], data["topic"]
    words = [t.split(" ")[STDLIB_TOPIC_REPEAT] for t in texts]  # a document's first own word
    queries = [" ".join([f"topic{j}"] * STDLIB_TOPIC_REPEAT) for j in range(STDLIB_TOPICS)]
    embedder = recording_embedder(TorchEncoderEmbedder)("bge-base", max_batch_size=APPS_BATCH, seed=SEED,
                                                         device=dev)

    def scored_docs(stream):
        """``stream``'s documents embedded and searched against the topic
        queries: (the scored table with ``emb``, the SQL tables)."""
        docs = stream.select(doc=pw.this.doc, topic=pw.this.topic, word=pw.this.word, emb=embedder(pw.this.text))
        topics = pw.debug.table_from_rows(pw.schema_from_types(tid=int, tname=str, parity=int, query=str),
                                          [(j, f"topic{j}", j % 2, q) for j, q in enumerate(queries)])
        tdata = topics.select(tid=pw.this.tid, temb=embedder(pw.this.query))
        tindex = pw.ml.KNNIndex(tdata.temb, tdata, n_dimensions=HIDDEN, distance_type="cosine", device=dev)
        near = tindex.get_nearest_items(docs.emb, k=1, with_distances=True)
        scored = near.select(
            doc=pw.this.doc, topic=pw.this.topic, word=pw.this.word, emb=pw.this.emb,
            nearest_topic=pw.apply_with_type(lambda t: int(t[0]), int, pw.this.tid),
            score=pw.apply_with_type(lambda d: -float(d[0]), float, pw.this.dist))
        sql_docs = scored.select(doc=pw.this.doc, topic=pw.this.topic, word=pw.this.word,
                                 nearest_topic=pw.this.nearest_topic, score=pw.this.score)
        return scored, {"docs": sql_docs, "topics": topics.select(pw.this.tid, pw.this.tname, pw.this.parity)}

    schema = pw.schema_from_types(doc=int, text=str, topic=int, word=str)
    pw.G.clear()
    pw.enable_interactive_mode()
    stream = pw.demo.generate_custom_stream(
        {"doc": lambda i: i, "text": lambda i: texts[i], "topic": lambda i: topic[i], "word": lambda i: words[i]},
        schema=schema, nb_rows=APPS_STREAM_DOCS, input_rate=APPS_INPUT_RATE)
    scored, tables = scored_docs(stream)
    results = {name: pw.sql(stmt, **tables) for name, stmt in APPS_SQL.items()}
    sinks = {name: FinalRows() for name in results}
    for name, table in results.items():
        pw.io.subscribe(table, on_change=sinks[name])
    written: dict = {}

    def keep(key, row, time, is_addition):
        if is_addition:
            written[key] = row
        else:
            written.pop(key, None)

    pw.io.subscribe(scored, on_change=keep)
    exported = pw.export_table(scored)
    view = pw.viz.table_viz(results["grouped"])
    plot = pw.viz.plot(results["grouped"], sorting_col="topic")
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    live = pw.live(results["grouped"])
    reads = []
    while not exported.closed:
        snap = live.snapshot()
        reads.append({"s": time.perf_counter() - t0, "rows": len(snap), "docs": sum(r[1] for r in snap.values())})
        if time.perf_counter() - t0 > APPS_DEADLINE_S:
            fail(f"apps: the stream did not end in {APPS_DEADLINE_S} s")
        time.sleep(0.5)
    if not live.wait_closed(APPS_DEADLINE_S):
        fail("apps: the LiveTable did not close")
    run_thread = interactive._interactive["thread"]
    run_thread.join(APPS_DEADLINE_S)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = kernels.launch_counts()
    partial = [r for r in reads if 0 < r["docs"] < APPS_STREAM_DOCS]
    if run_thread.is_alive() or not partial:
        fail(f"apps: the run's thread alive {run_thread.is_alive()}; LiveTable reads during the run "
             f"{reads[:3]}...{reads[-3:]} (none partial)")

    # ---- the rows the pipeline wrote, in sqlite
    rows = sorted(written.values(), key=lambda r: r["doc"])
    if [r["doc"] for r in rows] != list(range(APPS_STREAM_DOCS)):
        fail(f"apps: the scored table holds {len(rows)} documents, not {APPS_STREAM_DOCS}")
    db = sqlite3.connect(":memory:")
    db.execute("CREATE TABLE docs (doc, topic, word, nearest_topic, score)")
    db.executemany("INSERT INTO docs VALUES (?, ?, ?, ?, ?)",
                   [(r["doc"], r["topic"], r["word"], r["nearest_topic"], r["score"]) for r in rows])
    db.execute("CREATE TABLE topics (tid, tname, parity)")
    db.executemany("INSERT INTO topics VALUES (?, ?, ?)", [(j, f"topic{j}", j % 2) for j in range(STDLIB_TOPICS)])
    sql_rows = {}
    for name, stmt in APPS_SQL.items():
        cols = results[name]._column_names
        got = [tuple(row[c] for c in cols) for row in sinks[name].rows()]
        sql_rows[name] = same_rows(got, db.execute(stmt).fetchall(), f"pw.sql {name!r} against sqlite3")
    want_grouped = db.execute(APPS_SQL["grouped"]).fetchall()
    db.close()
    same_rows(list(live.snapshot().values()), want_grouped, "the LiveTable after wait_closed")
    if len(want_grouped) != STDLIB_TOPICS:
        fail(f"apps: the grouped result has {len(want_grouped)} rows, not {STDLIB_TOPICS}")

    # ---- nearest topics and scores against numpy over the UDF's embeddings
    doc_emb = np.stack([np.asarray(r["emb"], np.float64) for r in rows])
    top_emb = np.stack([np.asarray(embedder.seen[q], np.float64) for q in queries])
    if not np.allclose(doc_emb, np.stack([np.asarray(embedder.seen[texts[r["doc"]]], np.float64) for r in rows])):
        fail("apps: the scored table's embeddings are not the UDF's")
    sims = (doc_emb / np.linalg.norm(doc_emb, axis=1, keepdims=True)) @ \
        (top_emb / np.linalg.norm(top_emb, axis=1, keepdims=True)).T
    order = np.sort(sims, axis=1)
    clear = order[:, -1] - order[:, -2] > TOPK_ATOL
    score_err = float(np.abs(np.array([r["score"] for r in rows]) - order[:, -1]).max())
    wrong = int(((np.array([r["nearest_topic"] for r in rows]) != sims.argmax(1)) & clear).sum())
    if wrong or not score_err <= TOPK_ATOL:
        fail(f"apps: {wrong} nearest topics differ from numpy's; scores within {score_err:.2e} of numpy's")

    # ---- the viz: the grouped rows' values in the HTML and the SVG
    page, svg = view._repr_html_(), plot.to_svg()
    cells_missing = [row for row in want_grouped
                     if not all(f"<td>{html.escape(str(v))}</td>" in page for v in row[:2])]
    numeric = 4  # n, total, lo, hi over topic
    values = [v for row in want_grouped for v in row[1:]]
    if cells_missing or svg.count("<circle") != numeric * STDLIB_TOPICS or f">{max(values):g}<" not in svg \
            or f">{min(values):g}<" not in svg:
        fail(f"apps: the viz misses grouped rows: HTML without {cells_missing[:2]}, SVG with "
             f"{svg.count('<circle')} points")

    # ---- a second graph from the exported table: its embeddings indexed on the card
    pw.G.clear()
    questions = synthetic_questions(np, texts, APPS_IMPORT_QUESTIONS, SEED + 20)
    imported = pw.import_table(exported)
    data_t = imported.select(doc=pw.this.doc, emb=pw.this.emb)
    index = pw.ml.KNNIndex(data_t.emb, data_t, n_dimensions=HIDDEN, distance_type="cosine", device=dev)
    asked = pw.debug.table_from_rows(pw.schema_from_types(qid=int, q=str), list(enumerate(questions)))
    asked = asked.select(qid=pw.this.qid, qvec=embedder(pw.this.q))
    answers = index.get_nearest_items(asked.qvec, k=K, with_distances=True)
    replies: dict = {}
    pw.io.subscribe(answers, on_change=lambda key, row, time, is_addition:
                    replies.__setitem__(row["qid"], row) if is_addition else None)
    before = dict(kernels.launch_counts())
    t1 = time.perf_counter()
    pw.run(monitoring_level=pw.MonitoringLevel.NONE)
    torch.cuda.synchronize()
    import_s = time.perf_counter() - t1
    import_launches = {n: v - before.get(n, 0) for n, v in kernels.launch_counts().items()}
    if sorted(replies) != list(range(APPS_IMPORT_QUESTIONS)):
        fail(f"apps: the imported table's index answered {len(replies)} of {APPS_IMPORT_QUESTIONS} questions")
    q_emb = np.stack([np.asarray(embedder.seen[q], np.float64) for q in questions])
    q_emb /= np.linalg.norm(q_emb, axis=1, keepdims=True)
    exact = q_emb @ (doc_emb / np.linalg.norm(doc_emb, axis=1, keepdims=True)).T
    top = np.argsort(-exact, axis=1, kind="stable")[:, :K]
    kv = torch.tensor([[-d for d in replies[i]["dist"]] for i in range(APPS_IMPORT_QUESTIONS)], dtype=torch.float64)
    ki = torch.tensor([list(replies[i]["doc"]) for i in range(APPS_IMPORT_QUESTIONS)])
    pv = torch.from_numpy(np.take_along_axis(exact, top, 1))
    pi = torch.from_numpy(top)
    import_err = compare_topk(kv, ki, pv, pi, TOPK_ATOL)
    for name in ("attention", "bias_act", "add_layer_norm", "embed_ln", "pool_normalize", "slab_scatter",
                 "knn_topk"):
        if launches.get(name, 0) == 0 or import_launches.get(name, 0) == 0:
            fail(f"apps: {name} not launched (stream {launches.get(name)}, import {import_launches.get(name)})")

    # ---- one SQL epoch profiled: APPS_EPOCH_ROWS documents embedded, scored and grouped
    pw.G.clear()
    epoch = pw.debug.table_from_rows(schema, [(i, texts[i], topic[i], words[i]) for i in range(APPS_EPOCH_ROWS)])
    _scored, small = scored_docs(epoch)
    grouped_small = pw.sql(APPS_SQL["grouped"], **small)
    pw.debug._run_capture(grouped_small)
    res["sql_epoch_profile"] = profile_call(torch, lambda: pw.debug._run_capture(grouped_small), APPS_EPOCH_ROWS)
    pw.G.clear()
    prof = res["sql_epoch_profile"]
    res.update({
        "docs": APPS_STREAM_DOCS, "run_s": run_s, "docs_per_s": APPS_STREAM_DOCS / run_s,
        "udf_docs_per_s": embedder.docs / embedder.secs, "live_reads": len(reads), "live_partial_reads": len(partial),
        "sql_rows": sql_rows, "score_max_abs_err": score_err, "near_ties": int((~clear).sum()),
        "import_questions": APPS_IMPORT_QUESTIONS, "import_s": import_s, "import_max_abs_err": import_err,
        "launches": launches, "import_launches": import_launches, "wall_s": time.perf_counter() - t_part,
    })
    log(f"apps (b) on {smi}: {APPS_STREAM_DOCS} demo-stream documents embedded and scored in {run_s:.2f} s "
        f"({res['docs_per_s']:.1f} docs/s; the UDF {res['udf_docs_per_s']:.1f} docs/s); pw.sql rows equal to "
        f"sqlite3's {json.dumps(sql_rows)}; scores within {score_err:.2e} of numpy ({res['near_ties']} near-ties); "
        f"LiveTable read {len(reads)} times, {len(partial)} partial; imported table's top-{K} for "
        f"{APPS_IMPORT_QUESTIONS} questions within {import_err:.2e} of numpy's ({import_s:.2f} s)")
    log(f"apps (b): launches, stream {json.dumps(launches)}; import {json.dumps(import_launches)}; one SQL epoch "
        f"({APPS_EPOCH_ROWS} documents) {prof['wall_ms']:.1f} ms, device busy {prof['device_busy_ms']:.1f} ms, "
        f"idle share {prof['device_idle_share']:.3f}; top {json.dumps(prof['top'][:6])}")
    return res


def phase_apps(torch, dev, smi: str) -> dict:
    """Phase 20 (slice 16e): (a) ``apps_yaml_app``, (b) ``apps_stream``;
    the launches of both, summed by kernel, count on the main path."""
    import numpy as np

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    yaml_app = apps_yaml_app(torch, dev, np, smi)
    torch.cuda.empty_cache()
    stream = apps_stream(torch, dev, np, smi)
    launches = {name: yaml_app["launches"].get(name, 0) + stream["launches"].get(name, 0)
                + stream["import_launches"].get(name, 0)
                for name in set(yaml_app["launches"]) | set(stream["launches"])}
    res = {"yaml_app": yaml_app, "stream": stream, "launches": launches, "wall_s": time.perf_counter() - t_phase}
    log(f"apps: phase {res['wall_s']:.1f} s (a {yaml_app['wall_s']:.1f} s, b {stream['wall_s']:.1f} s)")
    return res


def _answers(port: int) -> bool:
    """True once ``/v1/answer`` on ``port`` answers a request."""
    try:
        return post_json(port, "/v1/answer", {"query": "w1", "tenant": "drill"}, timeout=5.0)[0] == 200
    except OSError:
        return False


def phase_rag_server_levels(torch, dev, smi: str) -> dict:
    """``--rag-server-levels``: phase 15 alone (over phase 3's synthetic
    documents) with ``PATHWAY_OPTIMIZE`` and ``PATHWAY_DISABLE_COLUMNAR``
    set by SERVER_LEVEL_RUNS in turns, to set the served numbers of the
    rewritten plan (with and without its columnar paths) beside those of
    the captured graph in one call, on one card; each run's busiest
    operators by the scheduler's probe."""
    import numpy as np

    docs = synthetic_docs(np, N_DOCS, SEED)
    unset = {"encode_into_docs_per_s": float("nan"), "udf_docs_per_s": float("nan"),
             "live_ingest_docs_per_s": float("nan")}
    saved = {name: os.environ.get(name) for name in ("PATHWAY_OPTIMIZE", "PATHWAY_DISABLE_COLUMNAR")}
    runs = []
    try:
        for level, row_only in SERVER_LEVEL_RUNS:
            os.environ["PATHWAY_OPTIMIZE"] = str(level)
            os.environ["PATHWAY_DISABLE_COLUMNAR"] = "1" if row_only else "0"
            rs = phase_rag_server(torch, dev, {"docs": docs}, smi, unset)
            runs.append({"level": level, "columnar_off": row_only, "ingest_s": rs["ingest_s"],
                         "ingest_docs_per_s": rs["ingest_docs_per_s"], "udf_batches": rs["udf_batches"],
                         "distinct_ingest_batches": rs["distinct_ingest_batches"],
                         "operators_top": rs["operators_top"],
                         **{key: rs[key] for key in ("http_single_p50_ms", "http_single_p99_ms",
                                                     "http_concurrent_p50_ms", "http_concurrent_p99_ms",
                                                     "qa_p50_ms", "columnar_rows")},
                         "served_idle_share": rs["served_profile"]["device_idle_share"],
                         "counters": rs["analysis"]["counters"]})
            torch.cuda.empty_cache()
    finally:
        for name, value in saved.items():
            if value is None:
                os.environ.pop(name, None)
            else:
                os.environ[name] = value
    return {"card": smi, "runs": runs}


def check_stream_handles(torch) -> None:
    """The launch helper's stream handle (read without a ``torch.cuda.Stream``)
    is PyTorch's current stream on the card, on the default stream and
    inside a side stream."""
    from pathway_tpu_torch.kernels._launch import stream_of

    dev = torch.device("cuda", torch.cuda.current_device())
    side = torch.cuda.Stream()
    got = [stream_of(dev)]
    with torch.cuda.stream(side):
        got.append(stream_of(dev))
    want = [torch.cuda.current_stream(dev).cuda_stream, side.cuda_stream]
    if got != want:
        fail(f"launch helper's stream handles {got} are not PyTorch's {want}")
    log(f"stream handles: {got} equal PyTorch's current streams")


def document_parser():
    """Phase 21's parser UDF: ``OpenParse`` for PDFs and
    ``ParseUnstructured(mode="elements")`` for the rest (told apart by the
    ``%PDF`` header), keeping each output by the digest of its bytes and
    the host seconds and calls of each parser."""
    import hashlib
    import threading

    from pathway_tpu_torch.internals.udfs import UDF
    from pathway_tpu_torch.xpacks.llm.parsers import OpenParse, ParseUnstructured

    class Parser(UDF):
        def __init__(self) -> None:
            super().__init__()
            self.by_kind = {"pdf": OpenParse(), "docx": ParseUnstructured(mode="elements")}
            self.seen: dict = {}
            self.secs = {"pdf": 0.0, "docx": 0.0}
            self.calls = {"pdf": 0, "docx": 0}
            self._lock = threading.Lock()

        @staticmethod
        def kind(contents: bytes) -> str:
            return "pdf" if contents.lstrip()[:4] == b"%PDF" else "docx"

        def __wrapped__(self, contents, **kwargs):
            kind = self.kind(contents)
            t0 = time.perf_counter()
            out = self.by_kind[kind].__wrapped__(contents)
            secs = time.perf_counter() - t0
            with self._lock:
                self.secs[kind] += secs
                self.calls[kind] += 1
                self.seen[hashlib.sha256(contents).hexdigest()] = out
            return out

    return Parser()


def documents_served(torch, dev, np, smi: str) -> dict:
    """Phase 21 (a): DOCS_FILES files generated from ``synthetic_docs``
    (half PDFs by ``make_pdf``, every other one flate-compressed; half DOCX
    by ``make_docx``), read by ``pw.io.fs.read(format="binary",
    mode="streaming", with_metadata=True)`` into ``VectorStoreServer``
    (``document_parser``: ``OpenParse`` for the PDFs,
    ``ParseUnstructured(mode="elements")`` for the DOCX files; phase 15's
    splitter; BGE-base as ``TorchEncoderEmbedder``; a CAPACITY-slot
    ``BruteForceKnnFactory`` whose delta segment holds at most
    DOCS_DELTA_CAP rows), served over REST by ``run_server``.
    Checks: every parser output in the run equals the same parser's on the
    same bytes in-process; DOCS_QUESTIONS one-question ``/v1/retrieve``
    replies at k=K against the direct path (the in-process chunks, the
    embedder's own batches through ``TorchEncoder.encode`` into a
    ``ShardedKnnIndex`` of CAPACITY slots, one question a K3 search):
    scores within DOCS_REPLY_ATOL, ids equal but for near-ties (phase 20's
    rule); DOCS_CONCURRENT of them sent at once from SERVER_CLIENTS
    threads, against the one-at-a-time replies at EMBED_ATOL; a PDF
    rewritten and a DOCX deleted in place, each visible within
    DOCS_DEADLINE_S; K1, K4-K7, K2 and K3 launched."""
    import hashlib
    import shutil
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    import pathway_tpu_torch as pw
    from pathway_tpu_torch import BGE_BASE, ShardedKnnIndex, TorchEncoderEmbedder, kernels
    from pathway_tpu_torch.xpacks.llm.splitters import TokenCountSplitter
    from pathway_tpu_torch.xpacks.llm.vector_store import VectorStoreClient, VectorStoreServer

    res: dict = {"card": smi}
    t_phase = time.perf_counter()
    texts = synthetic_docs(np, DOCS_FILES, SEED + 26)
    n_pdf = DOCS_FILES // 2
    root = tempfile.mkdtemp(prefix="documents_")
    blobs: dict = {}  # digest -> bytes, every version written

    def path_of(i: int) -> str:
        return os.path.join(root, f"doc{i:05d}.pdf" if i < n_pdf else f"doc{i:05d}.docx")

    def make(i: int, text: str) -> bytes:
        return make_pdf(text, f"Report {i}", compress=bool(i % 2)) if i < n_pdf else make_docx(text, f"Memo {i}")

    def write(i: int, data: bytes) -> None:
        blobs[hashlib.sha256(data).hexdigest()] = data
        with open(path_of(i), "wb") as f:
            f.write(data)

    t0 = time.perf_counter()
    files0 = [make(i, t) for i, t in enumerate(texts)]
    res["generate_s"] = time.perf_counter() - t0
    for i, data in enumerate(files0):
        write(i, data)
    res["bytes"] = {"pdf": sum(len(b) for b in files0[:n_pdf]), "docx": sum(len(b) for b in files0[n_pdf:])}

    # ---- the direct path's parse, timed by parser
    direct_parser = document_parser()
    splitter = TokenCountSplitter(min_tokens=SERVER_SPLIT[0], max_tokens=SERVER_SPLIT[1])
    parse_s = {"pdf": 0.0, "docx": 0.0}

    def chunks_of(data: bytes) -> list:
        kind = direct_parser.kind(data)
        t1 = time.perf_counter()
        parsed = direct_parser.by_kind[kind].__wrapped__(data)
        parse_s[kind] += time.perf_counter() - t1
        return [c for text, _meta in parsed for c, _ in splitter.__wrapped__(text)]

    file_chunks = [chunks_of(data) for data in files0]
    res["parse_in_process_s"] = dict(parse_s)
    key_info = [(path_of(i), c) for i, cs in enumerate(file_chunks) for c in cs]
    key_of = {info: g for g, info in enumerate(key_info)}
    if len(key_of) != len(key_info):
        fail(f"documents: {len(key_info) - len(key_of)} chunks repeat a (path, text) of the same file")
    res["chunks"] = {"pdf": sum(len(cs) for cs in file_chunks[:n_pdf]),
                     "docx": sum(len(cs) for cs in file_chunks[n_pdf:])}

    embedder = recording_embedder(TorchEncoderEmbedder)(model="bge-base", config=BGE_BASE,
                                                     max_batch_size=ENGINE_UDF_BATCH, seed=SEED, device=dev)
    parser = document_parser()
    port = free_port()
    pw.G.clear()
    files = pw.io.fs.read(root, format="binary", mode="streaming", with_metadata=True)
    server = VectorStoreServer(
        files,
        index_factory=pw.indexing.BruteForceKnnFactory(embedder=embedder, reserved_space=CAPACITY,
                                                       delta_cap=DOCS_DELTA_CAP, device=dev),
        parser=parser, splitter=splitter,
    )
    client = VectorStoreClient(port=port, timeout=DOCS_DEADLINE_S)

    def stats_count():
        try:
            return client.get_vectorstore_statistics()["file_count"]
        except OSError:
            return None

    def timed(fn, *args, **kwargs):
        t1 = time.perf_counter()
        out = fn(*args, **kwargs)
        return out, (time.perf_counter() - t1) * 1e3

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t_start = time.perf_counter()
    thread = server.run_server("127.0.0.1", port, threaded=True, with_cache=False)
    try:
        deadline = t_start + DOCS_DEADLINE_S
        while stats_count() != DOCS_FILES:
            if time.perf_counter() > deadline or not thread.is_alive():
                fail(f"documents: the statistics did not reach {DOCS_FILES} files in {DOCS_DEADLINE_S} s")
            time.sleep(0.02)
        res["ingest_s"] = time.perf_counter() - t_start
        res["files_searchable_per_s"] = DOCS_FILES / res["ingest_s"]
        ingest_batches = len(embedder.batches)

        # ---- questions, one at a time, then DOCS_CONCURRENT at once
        questions = synthetic_questions(np, texts, DOCS_QUESTIONS, SEED + 26)
        start = len(embedder.batches)
        single = [timed(client.query, q, k=K) for q in questions]
        single_batches = (start, len(embedder.batches))
        conc = questions[:DOCS_CONCURRENT]
        with ThreadPoolExecutor(max_workers=SERVER_CLIENTS) as pool:
            conc_out = list(pool.map(lambda q: timed(client.query, q, k=K), conc))
        res["served_profile"] = profile_call(torch, lambda: client.query(questions[0], k=K), 1)

        # ---- the live change: a PDF rewritten, a DOCX deleted, in place
        rewritten, deleted = 1, n_pdf + 1
        new_data = make(rewritten, synthetic_docs(np, 1, SEED + 27)[0])
        new_first = chunks_of(new_data)[0]
        old_first = {i: file_chunks[i][0] for i in (rewritten, deleted)}
        t_change = time.perf_counter()
        write(rewritten, new_data)
        os.remove(path_of(deleted))

        def returned(query: str) -> set:
            return {(d["metadata"]["path"], d["text"]) for d in client.query(query, k=K)}

        visible: dict = {}
        old_rewritten = {(path_of(rewritten), c) for c in file_chunks[rewritten]}
        while len(visible) < 2:
            now = time.perf_counter() - t_change
            if now > DOCS_DEADLINE_S:
                fail(f"documents: the live change was not visible in {DOCS_DEADLINE_S} s ({visible})")
            hits = client.query(new_first, k=K)
            if ("rewritten_pdf_s" not in visible
                    and (hits[0]["metadata"]["path"], hits[0]["text"]) == (path_of(rewritten), new_first)
                    and not returned(old_first[rewritten]) & old_rewritten):
                visible["rewritten_pdf_s"] = now
            if ("deleted_docx_s" not in visible and stats_count() == DOCS_FILES - 1
                    and not any(p == path_of(deleted) for p, _ in returned(old_first[deleted]))):
                visible["deleted_docx_s"] = now
            time.sleep(0.05)
        res["live_change"] = visible
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
    finally:
        sched = getattr(pw.G, "active_scheduler", None)
        if sched is not None:
            sched.stop()
        if thread is not None:
            thread.join(timeout=DOCS_DEADLINE_S)
        pw.G.clear()
        shutil.rmtree(root, ignore_errors=True)
    if thread is not None and thread.is_alive():
        fail("documents: the server's thread did not join after stop()")
    res["launches"] = launches
    missing = [n for n in ("attention", "bias_act", "add_layer_norm", "embed_ln", "pool_normalize", "slab_scatter",
                           "knn_topk") if launches.get(n, 0) == 0]
    if missing:
        fail(f"kernels not launched by the document server: {missing}")

    # ---- chunks: every parser output of the run against the same parser in-process
    differ = [d for d, out in parser.seen.items() if out != direct_parser.by_kind[
        direct_parser.kind(blobs[d])].__wrapped__(blobs[d])]
    if differ or set(parser.seen) != set(blobs):
        fail(f"documents: {len(differ)} parser outputs differ from the in-process parse; the run parsed "
             f"{len(parser.seen)} distinct files of the {len(blobs)} written")
    res["parse_in_run_s"], res["parse_calls"] = dict(parser.secs), dict(parser.calls)

    # ---- the direct path
    emb = direct_embeddings(np, embedder, "documents")
    embedded = {t for batch, _ in embedder.batches[:ingest_batches] for t in batch}
    if not {c for _, c in key_info} <= embedded:
        fail("documents: chunks of the in-process parse missing from the run's ingest batches")
    direct = ShardedKnnIndex(HIDDEN, metric="cos", capacity=CAPACITY, device=dev)
    direct.add_batch(list(range(len(key_info))), np.stack([emb[c] for _, c in key_info]))
    want = [direct.search(emb[q][None], K)[0] for q in questions]
    got = [[(key_of[(d["metadata"]["path"], d["text"])], d["score"]) for d in hits] for hits, _ in single]
    worst = compare_rows(got, want, K, DOCS_REPLY_ATOL, "documents: /v1/retrieve against the direct path")
    ids_equal, near_ties = 0, []

    def cos(q: str, key: int) -> float:
        a, b = np.asarray(emb[q], np.float64), np.asarray(emb[key_info[key][1]], np.float64)
        return float(a @ b / np.linalg.norm(a) / np.linalg.norm(b))

    for q, g, w in zip(questions, got, want):
        swapped = [(a, b) for (a, _), (b, _) in zip(g, w) if a != b]
        ids_equal += not swapped
        near_ties += [abs(cos(q, a) - cos(q, b)) for a, b in swapped]
    if near_ties and max(near_ties) > TOPK_ATOL:
        fail(f"documents: {DOCS_QUESTIONS - ids_equal} replies differ from the direct path's ids, by up to "
             f"{max(near_ties):.2e} of cosine: beyond a near-tie")
    conc_err = compare_rows([[(key_of[(d["metadata"]["path"], d["text"])], d["score"]) for d in hits]
                             for hits, _ in conc_out], got[:DOCS_CONCURRENT], K, EMBED_ATOL,
                            "documents: concurrent against one at a time")
    del direct
    torch.cuda.empty_cache()

    # ---- one ingest epoch: DOCS_EPOCH_FILES files parsed, split, embedded and indexed
    epoch_files = files0[:DOCS_EPOCH_FILES // 2] + files0[n_pdf:n_pdf + DOCS_EPOCH_FILES // 2]
    scratch = ShardedKnnIndex(HIDDEN, metric="cos", capacity=1 << 16, device=dev)

    def ingest_epoch() -> None:
        chunks = [c for data in epoch_files for c in chunks_of(data)]
        rows = []
        for lo in range(0, len(chunks), ENGINE_UDF_BATCH):
            rows += TorchEncoderEmbedder.__batch__(embedder, chunks[lo:lo + ENGINE_UDF_BATCH])
        scratch.add_batch(list(range(len(rows))), np.stack(rows))

    ingest_epoch()
    res["ingest_epoch_profile"] = profile_call(torch, ingest_epoch, len(epoch_files))
    del scratch

    ms = [m for _, m in single]
    conc_ms = [m for _, m in conc_out]
    res.update({
        "files": DOCS_FILES, "questions": DOCS_QUESTIONS, "k": K,
        "http_single_p50_ms": float(np.percentile(ms, 50)), "http_single_p99_ms": float(np.percentile(ms, 99)),
        "http_concurrent_p50_ms": float(np.percentile(conc_ms, 50)),
        "http_concurrent_p99_ms": float(np.percentile(conc_ms, 99)),
        "ids_equal": ids_equal, "near_tie_swaps": len(near_ties), "max_abs_err_vs_direct": worst,
        "concurrent_vs_alone_max_abs_err": conc_err,
        "udf_batches": len(embedder.batches), "question_batches": single_batches,
    })
    res["wall_s"] = time.perf_counter() - t_phase
    prof, iprof = res["served_profile"], res["ingest_epoch_profile"]
    log(f"documents on {smi}: {DOCS_FILES} files ({n_pdf} PDFs, {DOCS_FILES - n_pdf} DOCX) searchable "
        f"{res['ingest_s']:.2f} s after the server's start, {res['files_searchable_per_s']:.1f} files/s; chunks "
        f"{json.dumps(res['chunks'])}; parse s in the run {json.dumps(res['parse_in_run_s'])}, in-process "
        f"{json.dumps(res['parse_in_process_s'])}")
    log(f"documents on {smi}: HTTP one question p50 {res['http_single_p50_ms']:.2f} ms, p99 "
        f"{res['http_single_p99_ms']:.2f}; {DOCS_CONCURRENT} at once p50 {res['http_concurrent_p50_ms']:.2f}, p99 "
        f"{res['http_concurrent_p99_ms']:.2f}; ids equal {ids_equal}/{DOCS_QUESTIONS} (near-tie swaps "
        f"{len(near_ties)}), scores within {worst:.2e} of the direct path; live change {json.dumps(visible)}")
    log(f"documents on {smi}: one served question {prof['wall_ms']:.2f} ms, idle {prof['device_idle_share']:.3f}; "
        f"one ingest epoch ({DOCS_EPOCH_FILES} files) {iprof['wall_ms']:.1f} ms, idle "
        f"{iprof['device_idle_share']:.3f}; launches {json.dumps(launches)}; part (a) {res['wall_s']:.1f} s")
    return res


def direct_embeddings(np, embedder, what: str) -> dict:
    """{text: row} from ``TorchEncoder.encode`` of each batch the embedder
    UDF was handed (a text keeps its first batch's row); fails if the UDF's
    rows are further than EMBED_ATOL from them."""
    emb: dict = {}
    err = 0.0
    for batch, rows in embedder.batches:
        enc = embedder.encoder.encode(batch)
        err = max(err, float(np.abs(enc - np.stack(rows)).max()))
        for t, row in zip(batch, enc):
            emb.setdefault(t, row)
    if not err <= EMBED_ATOL:
        fail(f"{what}: the UDF's rows differ from TorchEncoder.encode of the same batches by {err}")
    return emb


def documents_stream(torch, dev, np, smi: str) -> dict:
    """Phase 21 (b): phase 19's STDLIB_DOCS documents as JSON messages on a
    ``MockBroker`` topic through ``pw.io.kafka.read`` into a ``DataIndex``
    (BGE-base as ``TorchEncoderEmbedder``, a CAPACITY-slot cosine slab);
    on the same broker a Debezium topic of DOCS_CDC[0] creates, then
    DOCS_CDC[1] updates and DOCS_CDC[2] deletes of those keys, through
    ``pw.io.debezium.read`` into a second ``DataIndex`` (its own embedder,
    same weights).  Once both indexes hold their final sets,
    DOCS_STREAM_QUESTIONS questions arrive on a third topic and each index
    answers them at k=K; the replies go to ``pw.io.postgres.write`` over a
    ``sqlite3`` file, to ``pw.io.null.write`` and to ``pw.io.subscribe``,
    and after the run ``pw.io.sqlite.read`` reads them back.
    Checks: each index's replies against the direct path over its final
    set (its embedder's own batches through ``TorchEncoder.encode`` into a
    ``ShardedKnnIndex``, searched in the engine's question batches): scores
    within TOPK_ATOL, ids equal but for near-ties; no deleted key in a
    reply; every updated key's stored row within DOCS_REPLY_ATOL of its
    new text's encoding; the rows read back equal the rows written; K1 and
    K3 launched."""
    import sqlite3
    import tempfile

    import pathway_tpu_torch as pw
    from pathway_tpu_torch import TorchEncoderEmbedder, kernels
    from pathway_tpu_torch.internals import tracing
    from pathway_tpu_torch.parallel import ShardedKnnIndex
    from pathway_tpu_torch.stdlib.indexing.data_index import REPLY_DATA, REPLY_SCORE

    res: dict = {"card": smi}
    t_phase = time.perf_counter()
    texts = stdlib_data(np, STDLIB_DOCS, STDLIB_LABELLED, STDLIB_QUESTIONS, SEED)["texts"]
    questions = synthetic_questions(np, texts, DOCS_STREAM_QUESTIONS, SEED + 28)
    n_create, n_update, n_delete = DOCS_CDC
    rng = np.random.default_rng(SEED + 28)
    order = [int(i) for i in rng.permutation(n_create)]
    updated = {i: texts[n_create + j] for j, i in enumerate(order[:n_update])}
    deleted = set(order[n_update:n_update + n_delete])
    finals = {"kafka": dict(enumerate(texts)),
              "debezium": {i: updated.get(i, texts[i]) for i in range(n_create) if i not in deleted}}

    url = f"mock://documents-{os.getpid()}-{time.monotonic_ns()}"
    broker = pw.io.kafka.MockBroker.get(url)
    for i, text in enumerate(texts):
        broker.produce("docs", json.dumps({"doc_id": i, "text": text}).encode())
    broker.close_topic("docs")

    def envelope(op: str, before, after) -> bytes:
        return json.dumps({"schema": {}, "payload": {"op": op, "before": before, "after": after}}).encode()

    for i in range(n_create):
        broker.produce("cdc", envelope("c", None, {"doc_id": i, "text": texts[i]}))
    for i, text in updated.items():
        broker.produce("cdc", envelope("u", {"doc_id": i, "text": texts[i]}, {"doc_id": i, "text": text}))
    for i in sorted(deleted):
        broker.produce("cdc", envelope("d", {"doc_id": i, "text": texts[i]}, None))
    broker.close_topic("cdc")

    class Doc(pw.Schema):
        doc_id: int = pw.column_definition(primary_key=True)
        text: str

    class Question(pw.Schema):
        qid: int = pw.column_definition(primary_key=True)
        text: str

    pw.G.clear()
    settings = {"bootstrap.servers": url}
    tables = {"kafka": pw.io.kafka.read(settings, topic="docs", schema=Doc, format="json"),
              "debezium": pw.io.debezium.read(settings, topic_name="cdc", schema=Doc)}
    qs = pw.io.kafka.read(settings, topic="questions", schema=Question, format="json")
    embedders, adapters, replies = {}, {}, []
    for name, table in tables.items():
        embedders[name] = recording_embedder(TorchEncoderEmbedder)("bge-base", max_batch_size=STDLIB_BATCH, seed=SEED,
                                                               device=dev)
        factory = pw.indexing.BruteForceKnnFactory(reserved_space=CAPACITY, metric="cos", embedder=embedders[name],
                                                   delta_cap=DOCS_DELTA_CAP, device=dev)
        inner = factory.build_index(table.text, table)
        make = inner.make_adapter

        def keep(make=make, name=name):
            adapters[name] = make()
            return adapters[name]

        inner.make_adapter = keep
        out = pw.indexing.DataIndex(table, inner).query_as_of_now(qs.text, number_of_matches=K)
        replies.append(out.select(
            qid=out.qid, source=name,
            reply=pw.apply(lambda data, scores: json.dumps([[d["doc_id"], float(s)] for d, s in zip(data, scores)]),
                           out[REPLY_DATA], out[REPLY_SCORE])))
    replied = replies[0].concat_reindex(replies[1])
    db_dir = tempfile.mkdtemp(prefix="documents_db_")
    db = os.path.join(db_dir, "replies.db")
    conn = sqlite3.connect(db)
    conn.execute("CREATE TABLE replies (qid INTEGER, source TEXT, reply TEXT, time INTEGER, diff INTEGER)")
    conn.commit()
    conn.close()
    pw.io.postgres.write(replied, None, "replies", connection=lambda: sqlite3.connect(db, check_same_thread=False))
    pw.io.null.write(replied)
    sink = FinalRows()
    pw.io.subscribe(replied, on_change=sink)

    ready: dict = {}

    def feed_questions() -> None:
        """The questions, once both indexes hold their final sets."""
        deadline = time.perf_counter() + DOCS_STREAM_DEADLINE_S
        while len(ready) < 2 and time.perf_counter() < deadline:
            for name, adapter in list(adapters.items()):
                if name not in ready and len(adapter.index) == len(finals[name]):
                    ready[name] = time.perf_counter() - t_run
            time.sleep(0.01)
        for j, q in enumerate(questions):
            broker.produce("questions", json.dumps({"qid": j, "text": q}).encode())
        broker.close_topic("questions")

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    since = tracing.now_ns()
    t_run = time.perf_counter()
    feeder = threading.Thread(target=feed_questions, daemon=True, name="documents_questions")
    feeder.start()
    pw.run(monitoring_level=pw.MonitoringLevel.NONE)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t_run
    feeder.join(timeout=DOCS_STREAM_DEADLINE_S)
    launches = kernels.launch_counts()
    spans = epoch_spans(tracing, since)
    if len(ready) < 2:
        fail(f"documents stream: the indexes did not reach their final sets in {DOCS_STREAM_DEADLINE_S} s "
             f"({json.dumps(ready)})")
    written = sorted((r["qid"], r["source"], r["reply"]) for r in sink.rows())
    pw.G.clear()

    # ---- the rows read back from sqlite3 against the rows written
    class Back(pw.Schema):
        qid: int
        source: str
        reply: str
        diff: int

    keys, cols = pw.debug.table_to_dicts(pw.io.sqlite.read(db, "replies", Back, mode="static"))
    back = sorted((cols["qid"][k], cols["source"][k], cols["reply"][k]) for k in keys)
    if back != written or len(written) != 2 * DOCS_STREAM_QUESTIONS or any(cols["diff"][k] != 1 for k in keys):
        fail(f"documents stream: {len(back)} rows read back from sqlite3, {len(written)} written; equal "
             f"{back == written}")
    pw.G.clear()

    # ---- each index against the direct path over its final set
    got = {name: {} for name in tables}
    for qid, name, reply in written:
        got[name][questions[qid]] = [(int(d), float(s)) for d, s in json.loads(reply)]
    checked, emb_b = {}, None
    for name, final in finals.items():
        emb = direct_embeddings(np, embedders[name], f"documents stream ({name})")
        ids = sorted(final)
        direct = ShardedKnnIndex(HIDDEN, metric="cos", capacity=CAPACITY, device=dev)
        direct.add_batch(ids, np.stack([emb[final[i]] for i in ids]))
        want = {}
        asked = set(questions)
        for batch, _ in embedders[name].batches:
            batch = [q for q in batch if q in asked]
            if batch:
                want.update(zip(batch, direct.search(np.stack([emb[q] for q in batch]), K)))
        worst = compare_rows([got[name][q] for q in questions], [want[q] for q in questions], K, TOPK_ATOL,
                             f"documents stream: the {name} index against the direct path")
        ids_equal, near = 0, []
        for q in questions:
            swapped = [(a, b) for (a, _), (b, _) in zip(got[name][q], want[q]) if a != b]
            ids_equal += not swapped
            qa = np.asarray(emb[q], np.float64)
            for a, b in swapped:
                ea, eb = (np.asarray(emb[final[x]], np.float64) for x in (a, b))
                near.append(abs(qa @ ea / np.linalg.norm(ea) - qa @ eb / np.linalg.norm(eb)) / np.linalg.norm(qa))
        if near and max(near) > TOPK_ATOL:
            fail(f"documents stream: the {name} index's ids differ from the direct path's beyond a near-tie "
                 f"({max(near):.2e})")
        checked[name] = {"ids_equal": ids_equal, "near_tie_swaps": len(near), "max_abs_err_vs_direct": worst}
        emb_b = emb
        del direct
    torch.cuda.empty_cache()
    if any(d in deleted for r in got["debezium"].values() for d, _ in r):
        fail("documents stream: a deleted key came back in a reply")
    cdc = adapters["debezium"]
    cdc.index.merge(wait=True)
    stored = np.stack(index_vectors(np, cdc))
    new_rows = np.stack([emb_b[t] for t in updated.values()]).astype(np.float32)
    new_rows /= np.linalg.norm(new_rows, axis=1, keepdims=True)
    nearest = np.argmax(new_rows @ stored.T, axis=1)
    upd_err = float(np.abs(stored[nearest] - new_rows).max())
    if not upd_err <= DOCS_REPLY_ATOL:
        fail(f"documents stream: an updated key's stored row is {upd_err:.2e} from its new text's encoding")
    if launches.get("attention", 0) == 0 or launches.get("knn_topk", 0) == 0:
        fail(f"documents stream: K1 or K3 not launched: {json.dumps(launches)}")

    # ---- one epoch: a commit of documents embedded and added, a commit of questions searched
    epoch_texts, epoch_q = texts[:STDLIB_COMMIT], questions[:STDLIB_COMMIT]
    scratch = ShardedKnnIndex(HIDDEN, metric="cos", capacity=1 << 16, device=dev)
    kafka_index, embedder = adapters["kafka"].index, embedders["kafka"]

    def epoch() -> None:
        vecs = np.stack(TorchEncoderEmbedder.__batch__(embedder, epoch_texts))
        scratch.add_batch(list(range(len(vecs))), vecs)
        kafka_index.search(np.stack(TorchEncoderEmbedder.__batch__(embedder, epoch_q)), K)

    epoch()
    res["epoch_profile"] = profile_call(torch, epoch, len(epoch_texts))
    del scratch
    udf_docs = sum(e.docs for e in embedders.values())
    udf_s = sum(e.secs for e in embedders.values())
    res.update({
        "docs": STDLIB_DOCS, "cdc": {"creates": n_create, "updates": n_update, "deletes": n_delete,
                                     "live": len(finals["debezium"])},
        "questions": DOCS_STREAM_QUESTIONS, "run_s": run_s, "indexes_ready_s": ready,
        "kafka_docs_per_s": STDLIB_DOCS / ready["kafka"],
        "udf_docs_per_s": udf_docs / udf_s, "udf_docs": udf_docs,
        "epochs": len(spans), "checked": checked, "update_row_max_abs_err": upd_err,
        "rows_written": len(written), "rows_read_back": len(back), "launches": launches,
    })
    res["wall_s"] = time.perf_counter() - t_phase
    prof = res["epoch_profile"]
    log(f"documents stream on {smi}: {STDLIB_DOCS} Kafka documents indexed {ready['kafka']:.2f} s after the run's "
        f"start ({res['kafka_docs_per_s']:.1f} docs/s through Kafka into the UDF), {n_create}+{n_update}+{n_delete} "
        f"CDC events {ready['debezium']:.2f} s; the UDFs {res['udf_docs_per_s']:.1f} docs/s; {len(spans)} epochs, "
        f"pw.run {run_s:.2f} s; replies {json.dumps(checked)}; updated rows within {upd_err:.2e}; "
        f"{len(back)} rows read back equal to the {len(written)} written")
    log(f"documents stream on {smi}: one epoch ({STDLIB_COMMIT} documents embedded and added, {STDLIB_COMMIT} "
        f"questions searched) {prof['wall_ms']:.1f} ms, idle {prof['device_idle_share']:.3f}; launches "
        f"{json.dumps(launches)}; part (b) {res['wall_s']:.1f} s")
    return res


def phase_documents(torch, dev, smi: str) -> dict:
    """Phase 21: the document parsers and the connectors of slice 16f on
    the card: (a) ``documents_served``, (b) ``documents_stream``."""
    import numpy as np

    t_phase = time.perf_counter()
    served = documents_served(torch, dev, np, smi)
    torch.cuda.empty_cache()
    stream = documents_stream(torch, dev, np, smi)
    torch.cuda.empty_cache()
    launches = {name: served["launches"].get(name, 0) + stream["launches"].get(name, 0)
                for name in set(served["launches"]) | set(stream["launches"])}
    wall = time.perf_counter() - t_phase
    log(f"documents: phase {wall:.1f} s")
    if wall > DOCS_PHASE_S:
        log(f"documents: the phase took {wall:.1f} s, above its {DOCS_PHASE_S} s")
    return {"served": served, "stream": stream, "launches": launches, "wall_s": wall}


def _pdf_str(text: str) -> bytes:
    """``text`` as the body of a PDF literal string."""
    return text.replace("\\", "\\\\").replace("(", "\\(").replace(")", "\\)").encode("latin-1")


def make_pdf(text: str, title: str, compress: bool, pages: int = DOCS_PDF_PAGES) -> bytes:
    """A PDF of ``pages`` pages showing ``text`` (built as
    ``tests/test_parsers.py``'s ``_minimal_pdf`` builds one, a content
    stream a page, each flate-compressed when ``compress``): each page a
    heading at 18 pt (``title``, then ``title`` with its part), body lines
    of DOCS_LINE_WORDS words at 10 pt, and on the first page a table of
    three x-aligned columns under its header row."""
    words = text.split()
    lines = [" ".join(words[i:i + DOCS_LINE_WORDS]) for i in range(0, len(words), DOCS_LINE_WORDS)]
    per = -(-len(lines) // pages)
    streams = []
    for p in range(pages):
        ops = [b"BT /F1 18 Tf 72 760 Td (" + _pdf_str(title if p == 0 else f"{title}, part {p + 1}") + b") Tj ET"]
        y = 730
        for line in lines[p * per:(p + 1) * per]:
            ops.append(b"BT /F1 10 Tf 72 %d Td (" % y + _pdf_str(line) + b") Tj ET")
            y -= 12
        if p == 0:
            y -= 16
            table = [("Term", "Count", "Rank")] + [(words[j], str(7 * len(words[j]) + j), str(j + 1))
                                                   for j in range(min(3, len(words)))]
            for row in table:
                ops.append(b"BT /F1 10 Tf " + b" ".join(b"1 0 0 1 %d %d Tm (" % (x, y) + _pdf_str(cell) + b") Tj"
                                                          for x, cell in zip((72, 200, 320), row)) + b" ET")
                y -= 14
        streams.append(b"\n".join(ops))
    objs = [b"<< /Type /Catalog /Pages 2 0 R >>",
            b"<< /Type /Pages /Kids [" + b" ".join(b"%d 0 R" % (3 + p) for p in range(pages))
            + b"] /Count %d >>" % pages]
    objs += [b"<< /Type /Page /Parent 2 0 R /Contents %d 0 R >>" % (3 + pages + p) for p in range(pages)]
    for content in streams:
        data = zlib.compress(content) if compress else content
        filt = b"/Filter /FlateDecode " if compress else b""
        objs.append(b"<< " + filt + b"/Length %d >>\nstream\n" % len(data) + data + b"\nendstream")
    return (b"%PDF-1.4\n" + b"".join(b"%d 0 obj\n" % (i + 1) + o + b"\nendobj\n" for i, o in enumerate(objs))
            + b"trailer\n<< /Root 1 0 R >>\n%%EOF\n")


def make_docx(text: str, title: str) -> bytes:
    """A DOCX (a zip of WordprocessingML, as ``tests/test_parsers.py``'s
    ``_minimal_docx``) of ``text``: a Heading1 ``title``, paragraphs of
    3 x DOCS_LINE_WORDS words in two runs each, three list items of
    three words, then a table of two columns, and a Heading2 before the
    last paragraphs."""
    import io
    import zipfile
    from xml.sax.saxutils import escape

    w_ns = "http://schemas.openxmlformats.org/wordprocessingml/2006/main"
    words = text.split()
    step = 3 * DOCS_LINE_WORDS
    paras = [words[i:i + step] for i in range(0, len(words), step)]

    def p(body: str, style: str | None = None, numbered: bool = False) -> str:
        ppr = ""
        if style:
            ppr = f'<w:pPr><w:pStyle w:val="{style}"/></w:pPr>'
        elif numbered:
            ppr = '<w:pPr><w:numPr><w:ilvl w:val="0"/></w:numPr></w:pPr>'
        return f"<w:p>{ppr}{body}</w:p>"

    def runs(ws: list) -> str:
        half = len(ws) // 2
        return "".join(f'<w:r><w:t xml:space="preserve">{escape(part)}</w:t></w:r>'
                       for part in (" ".join(ws[:half]) + " ", " ".join(ws[half:])) if part.strip())

    body = [p(runs([title]), "Heading1")]
    for i, ws in enumerate(paras):
        if i == max(1, len(paras) - 1):
            body.append(p(runs([f"{title} notes"]), "Heading2"))
        body.append(p(runs(ws)))
        if i == 0:
            body += [p(runs(words[3 * j:3 * j + 3]), numbered=True) for j in range(3)]
            cells = [("Term", "Count")] + [(words[j], str(7 * len(words[j]) + j)) for j in range(min(2, len(words)))]
            body.append("<w:tbl>" + "".join(
                "<w:tr>" + "".join(f"<w:tc>{p(runs([c]))}</w:tc>" for c in row) + "</w:tr>" for row in cells)
                + "</w:tbl>")
    document = (f'<?xml version="1.0" encoding="UTF-8" standalone="yes"?>\n<w:document xmlns:w="{w_ns}"><w:body>'
                + "".join(body) + "</w:body></w:document>")
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as zf:
        zf.writestr("[Content_Types].xml", '<?xml version="1.0"?><Types xmlns="http://schemas.openxmlformats.org/'
                    'package/2006/content-types"/>')
        zf.writestr("word/document.xml", document)
    return buf.getvalue()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available; this script runs the port on a card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from pathway_tpu_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    _build.build_all(EDGE_KERNELS if "--k3-edge" in sys.argv[1:] else _build.NAMES)
    log(f"kernel build: {time.perf_counter() - t0:.1f} s")
    check_stream_handles(torch)
    for name in _build.NAMES:
        for line in _build.ptxas_report(name).splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line or "smem" in line:
                print(f"ptxas {name}: {line.strip()}", file=sys.stderr)
                if name in ("attention", "ring_block", "knn_topk", "ivf_assign", "ivf_scan", "dual_logits"):
                    # K1, K3, K10-K12 and K14 on stdout too
                    log(f"ptxas {name}: {line.strip()}")
    dev = torch.device("cuda:0")
    if "--k3-edge" in sys.argv[1:]:
        rest = sys.argv[sys.argv.index("--k3-edge") + 1:]
        ke = phase_k3_edge(torch, dev, rest[0] if rest and not rest[0].startswith("--") else None)
        log("k3 edge: " + json.dumps(ke))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
        }}))
        return 0
    if "--against-parent" in sys.argv[1:]:
        parent = sys.argv[sys.argv.index("--against-parent") + 1]
        log("against parent: " + json.dumps(phase_against_parent(torch, dev, parent)))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
        }}))
        return 0
    if "--rag-server-levels" in sys.argv[1:]:
        log("rag server by level: " + json.dumps(phase_rag_server_levels(torch, dev, smi)))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
        }}))
        return 0
    if "--serving" in sys.argv[1:]:
        import numpy as np

        ctx = {"docs": synthetic_docs(np, N_DOCS, SEED)}
        rates = dict.fromkeys(("encode_into_docs_per_s", "udf_docs_per_s", "live_ingest_docs_per_s"), float("nan"))
        rs = phase_rag_server(torch, dev, ctx, smi, rates)
        log("serving only: rag server " + json.dumps({k: v for k, v in rs.items() if k not in ("launches", "analysis")}))
        torch.cuda.empty_cache()
        sv = phase_serving(torch, dev, smi)
        log("serving only: " + json.dumps({k: v for k, v in sv.items() if k not in ("launches", "failover_launches")}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
        }}))
        return 0
    if "--persistence" in sys.argv[1:]:
        ps = phase_persistence(torch, dev, smi, persistence_slab(torch, dev))
        log("persistence only: " + json.dumps({k: v for k, v in ps.items() if k != "launches"}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
        }}))
        return 0
    if "--stdlib" in sys.argv[1:]:
        st = phase_stdlib(torch, dev, smi)
        log("stdlib only: " + json.dumps({k: v for k, v in st.items() if k not in ("launches", "classify_epoch_profile")}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
        }}))
        return 0
    if "--apps" in sys.argv[1:]:
        ap = phase_apps(torch, dev, smi)
        log("apps only: " + json.dumps({part: {key: val for key, val in ap[part].items() if key != "sql_epoch_profile"}
                                        for part in ("yaml_app", "stream")}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
        }}))
        return 0
    if "--documents" in sys.argv[1:]:
        dc = phase_documents(torch, dev, smi)
        log("documents only: " + json.dumps({part: {key: val for key, val in dc[part].items()
                                                    if key not in ("launches", "served_profile",
                                                                   "ingest_epoch_profile", "epoch_profile")}
                                             for part in ("served", "stream")}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
        }}))
        return 0
    if "--distinct-cards" in sys.argv[1:]:
        if torch.cuda.device_count() < 4:
            fail(f"--distinct-cards needs four cards, found {torch.cuda.device_count()}")
        cards = [torch.device("cuda", i) for i in range(4)]
        log("distinct cards: " + json.dumps(phase_distinct_cards(torch, cards)))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
        }}))
        return 0

    k_out = phase_kernels(torch, dev)
    by_nq = k_out.pop("_knn_topk_by_nq")
    paths = k_out.pop("_knn_paths")
    k128 = k_out.pop("_knn_k128")
    k256 = k_out.pop("_knn_k256")
    knn_edge = k_out.pop("_knn_edge")
    c15_edge = k_out.pop("_c15_edge")
    select_rows = k_out.pop("_topk_select_rows")
    attn_l512 = k_out.pop("_attention_b32_l512")
    attn_rerank = k_out.pop("_attention_rerank")
    attn_image = k_out.pop("_attention_image")
    compared_widths = k_out.pop("_attention_widths")
    torch.cuda.empty_cache()
    f_out = phase_fused(torch, dev)
    fused_shapes = {name: f_out.pop(f"_{name}_shapes")
                    for name in ("bias_act", "add_layer_norm", "embed_ln", "pool_normalize", "pool_normalize_into",
                                 "cross_head")}
    k_out.update(f_out)
    torch.cuda.empty_cache()
    v_out = phase_vision_kernels(torch, dev)
    fv_out = phase_f32_vision(torch, dev)
    fused_shapes["patchify"] = v_out.pop("_patchify_shapes")
    fused_shapes["bias_act_pos"] = v_out.pop("bias_act_pos")
    k_out.update(v_out)
    torch.cuda.empty_cache()
    f32_out = phase_f32_ring_kernels(torch, dev)
    k_out["ring_block"] = f32_out.pop("ring_block")
    for name, row in f32_out.items():
        k_out[name]["f32"] = row
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    repairs = phase_shape_repairs(torch, dev)
    repairs["wall_s"] = time.perf_counter() - t_phase
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    s_out, ctx = phase_slice(torch, dev, compared_widths)
    wall = {"embed_s": time.perf_counter() - t_phase}
    t_phase = time.perf_counter()
    r_out = phase_rerank(torch, dev, ctx, compared_widths)
    wall["rerank_s"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    en_out = phase_engine(torch, dev, ctx, s_out["embed_docs_per_s"], smi)
    wall["engine_s"] = time.perf_counter() - t_phase
    torch.cuda.empty_cache()
    lr_out = phase_live_rag(torch, dev, ctx, r_out, smi, {"encode_into_docs_per_s": s_out["embed_docs_per_s"],
                                                           "udf_docs_per_s": en_out["udf"]["docs_per_s"]})
    wall["live_rag_s"] = lr_out["wall_s"]
    r_out.pop("_pair_scores")
    torch.cuda.empty_cache()
    rs_out = phase_rag_server(torch, dev, ctx, smi, {
        "encode_into_docs_per_s": s_out["embed_docs_per_s"], "udf_docs_per_s": en_out["udf"]["docs_per_s"],
        "live_ingest_docs_per_s": lr_out["brute_force"]["ingest_docs_per_s"]})
    wall["rag_server_s"] = rs_out["wall_s"]
    pa_out = phase_analysis(torch, dev, rs_out, lr_out, smi)
    wall["analysis_s"] = pa_out["wall_s"]
    torch.cuda.empty_cache()
    sv_out = phase_serving(torch, dev, smi)
    wall["serving_s"] = sv_out["wall_s"]
    torch.cuda.empty_cache()
    ps_out = phase_persistence(torch, dev, smi, ctx)
    wall["persistence_s"] = ps_out["wall_s"]
    torch.cuda.empty_cache()
    st_out = phase_stdlib(torch, dev, smi)
    wall["stdlib_s"] = st_out["wall_s"]
    torch.cuda.empty_cache()
    ap_out = phase_apps(torch, dev, smi)
    wall["apps_s"] = ap_out["wall_s"]
    torch.cuda.empty_cache()
    dc_out = phase_documents(torch, dev, smi)
    wall["documents_s"] = dc_out["wall_s"]
    torch.cuda.empty_cache()
    sh_out = phase_sharded(torch, dev, ctx)
    wall["sharded_s"] = sh_out["wall_s"]
    log(f"embed docs/s: data parallel over {SHARDS} shards {sh_out['dp_embed_docs_per_s']:.1f}, "
        f"one device {s_out['embed_docs_per_s']:.1f}; query p50/p99 ms: sharded {json.dumps(sh_out['search'])}, "
        f"unsharded {json.dumps(s_out['search'])}")
    torch.cuda.empty_cache()
    p10_out = phase_parallel(torch, dev, ctx, r_out.pop("_pairs"))
    wall["parallel_s"] = p10_out["wall_s"]
    del ctx
    torch.cuda.empty_cache()
    i_out = phase_image(torch, dev, compared_widths)
    wall["image_s"] = i_out["wall_s"]["total_s"]
    torch.cuda.empty_cache()
    ivf_out = phase_ivf(torch, dev)
    wall["ivf_s"] = ivf_out["wall_s"]["total_s"]
    torch.cuda.empty_cache()
    c3_out = phase_ivf_defaults(torch, dev)
    wall["ivf_defaults_s"] = c3_out["wall_s"]
    torch.cuda.empty_cache()
    ck_out = phase_checkpoint(torch, dev, compared_widths)
    wall["checkpoint_s"] = ck_out["wall_s"]
    k_out.update(ivf_out.pop("kernels"))
    ivf_scan_nq32 = k_out["ivf_scan"].pop("_nq32")
    torch.cuda.empty_cache()
    tr_out = phase_train(torch, dev)
    wall["train_s"] = tr_out["wall_s"]
    k_out.update(tr_out.pop("kernels"))

    csrc = "pathway_tpu_torch/kernels/csrc/"
    sources = {
        "attention": ("attention.cu", "pathway_tpu/models/encoder.py:113"),
        "slab_scatter": ("slab_scatter.cu", "pathway_tpu/parallel/sharded_knn.py:166"),
        "slab_clear": ("slab_scatter.cu", "pathway_tpu/parallel/sharded_knn.py:133"),
        "knn_topk": ("knn_topk.cu", "pathway_tpu/parallel/sharded_knn.py:336"),
        "bias_act": ("bias_act.cu", "pathway_tpu/models/encoder.py:139"),
        "add_layer_norm": ("add_layer_norm.cu", "pathway_tpu/models/encoder.py:135"),
        "embed_ln": ("embed_ln.cu", "pathway_tpu/models/encoder.py:156"),
        "pool_normalize": ("pool_normalize.cu", "pathway_tpu/models/encoder.py:196"),
        # the ingest tail: K7's pooling and normalise (encoder.py:196) with the
        # scatter into the slab
        "pool_normalize_into": ("pool_normalize.cu", "pathway_tpu/parallel/sharded_knn.py:166"),
        "patchify": ("patchify.cu", "pathway_tpu/models/vision.py:60"),
        "vision_head": ("vision_head.cu", "pathway_tpu/models/vision.py:81"),
        "dual_logits": ("dual_logits.cu", "pathway_tpu/models/vision.py:120"),
        "ivf_assign": ("ivf_assign.cu", "pathway_tpu/parallel/ivf_knn.py:44"),
        "ivf_scan": ("ivf_scan.cu", "pathway_tpu/parallel/ivf_knn.py:316"),
        "topk_select": ("topk_select.cu", "pathway_tpu/parallel/sharded_knn.py:364"),
        "ring_block": ("ring_block.cu", "pathway_tpu/ops/ring_attention.py:47"),
        "attention_bwd": ("attention_bwd.cu", "__graft_entry__.py:128"),
        "bias_act_bwd": ("bias_act_bwd.cu", "__graft_entry__.py:128"),
        "layer_norm_bwd": ("layer_norm_bwd.cu", "__graft_entry__.py:128"),
        "embed_ln_bwd": ("layer_norm_bwd.cu", "__graft_entry__.py:128"),
        "contrastive_loss": ("contrastive_loss.cu", "__graft_entry__.py:117"),
        "contrastive_loss_bwd": ("contrastive_loss.cu", "__graft_entry__.py:128"),
        "pool_normalize_bwd": ("contrastive_loss.cu", "__graft_entry__.py:128"),
        "adam": ("adam.cu", "__graft_entry__.py:129"),
        "cross_head": ("cross_head.cu", "pathway_tpu/models/encoder.py:222"),
    }
    entries = []
    for name, (src, replaces) in sources.items():
        m = k_out[name]
        by_path = {"embed": s_out["launches"][name], "rerank": r_out["launches"][name],
                   "image": i_out["launches"][name], "ivf": ivf_out["launches"][name],
                   "ivf_defaults": c3_out["launches"][name], "sharded": sh_out["launches"][name],
                   "checkpoint": ck_out["launches"][name], "engine": en_out["launches"][name],
                   "live_rag": lr_out["launches"].get(name, 0),
                   "rag_server": rs_out["launches"].get(name, 0),
                   "serving": sv_out["launches"].get(name, 0),
                   "serving_failover": sv_out["failover_launches"].get(name, 0),
                   "persistence": ps_out["launches"].get(name, 0),
                   "stdlib": st_out["launches"].get(name, 0),
                   "apps": ap_out["launches"].get(name, 0),
                   "documents": dc_out["launches"].get(name, 0),
                   "f32_vision": fv_out["launches"][name],
                   **{path: counts[name] for path, counts in p10_out["launches"].items()},
                   "train": tr_out["launches"][name], "dryrun": tr_out["dryrun_launches"][name]}
        entries.append({
            "name": name, "route": "cuda", "source": csrc + src, "replaces": replaces,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": m["max_abs_err"],
            "ms": m["ms"], "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"], "library_ms": m["library_ms"], "shape": m["shape"],
            **{key: m[key] for key in ("device_ms", "queued_ms", "f32", "launches_per_call", "act_none", "cases",
                                       "form", "same_bits_twice") if key in m},
        })
    summary = {
        "card": smi,
        "embed_docs_per_s": s_out["embed_docs_per_s"],
        "encoder_batches": s_out["encoder_batches"],
        "bulk_rows_per_s": s_out["bulk_rows_per_s"],
        "search": s_out["search"],
        "peak_mem_gb": s_out["peak_mem_gb"],
        "transfers": s_out["transfers"],
        "knn_topk_by_nq": by_nq,
        "knn_pass1_paths": paths,
        "knn_topk_k128_ms": k128,
        "knn_topk_k256": k256,
        "knn_topk_edge": knn_edge,
        "c15_edge": c15_edge,
        "topk_select_shapes": select_rows,
        "attention_b32_l512": attn_l512,
        "attention_rerank_b256_l512": attn_rerank,
        "attention_image_b256_l196": attn_image,
        "fused_shapes": fused_shapes,
        "attention_widths": s_out["attention_widths"],
        "tokenize_tokens_per_s": s_out["tokenize_tokens_per_s"],
        "profile": s_out["profile"],
        "rerank": r_out,
        "image": i_out,
        "ivf": ivf_out,
        "ivf_defaults": c3_out,
        "sharded": sh_out,
        "checkpoint": ck_out,
        "parallel": p10_out,
        "ivf_scan_nq32": ivf_scan_nq32,
        "ivf_assign_lloyd": {key: k_out["ivf_assign"][f"lloyd_{key}"] for key in ("ms", "library_ms", "bound_ms")},
        "shape_repairs": repairs,
        "engine": {key: val for key, val in en_out.items() if key != "launches"},
        "live_rag": {key: val for key, val in lr_out.items() if key != "launches"},
        "rag_server": {key: val for key, val in rs_out.items() if key not in ("launches", "analysis")},
        "analysis": pa_out,
        "serving": {key: val for key, val in sv_out.items() if key not in ("launches", "failover_launches")},
        "persistence": {key: val for key, val in ps_out.items() if key != "launches"},
        "stdlib": {key: val for key, val in st_out.items() if key != "launches"},
        "apps": {part: {key: val for key, val in ap_out[part].items() if key not in ("launches", "import_launches")}
                 for part in ("yaml_app", "stream")},
        "documents": {part: {key: val for key, val in dc_out[part].items() if key != "launches"}
                      for part in ("served", "stream")},
        "f32_vision": {key: val for key, val in fv_out.items() if key != "launches"},
        "train": {key: val for key, val in tr_out.items() if key not in ("launches", "dryrun_launches")},
        "phase_wall_s": wall,
    }
    log("summary: " + json.dumps(summary))
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
