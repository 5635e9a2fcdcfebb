"""Smoke run of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py [--seed 0] [--rows 1000000] [--iters 5]

1. Prints the software and the card (name and power limit from
   ``nvidia-smi``), and builds every CUDA kernel of the port from the
   sources in this checkout (one ``nvcc`` per source, all at once).
2. For each histogram kernel (K1, K2), at the shapes the main-path fits
   give it (K1 also at the node-batched shape of two unported builds;
   the full-resolution B=256 shapes of the EFB and monotone fits, and
   K2 over a bundled matrix with random non-full routing ranges),
   holds the kernel (in the id form the grower calls) against
   its plain PyTorch version, its gathered-row form and the previous
   kernel on the same inputs on the card: int32 limb histograms
   bit-identical and new node ids identical.  Times the kernel and the
   previous kernel in turns (previous, kernel, kernel, previous), K2's
   route kernel alone, the plain version and, where one PyTorch call
   computes the same function, that call (device time after warm-up);
   computes the least time the card could take from the bytes moved, the
   achieved share of 3.35 TB/s, and prints each feature set's geometry
   (features per block, tile, groups, shared bytes, resident blocks per
   SM and the gathers in flight per SM).
3. Fits the same small problem on the card and on the CPU: split
   features must agree and margins within 1e-4.
4. Drives the main path, ``Pipeline([GBDTClassifier(...)]).fit`` then
   ``transform``, at 1M rows x 28 features: once at the default
   ``maxBin=255`` (two-level histograms: both kernels) and once at
   ``maxBin=63`` (the fused kernel alone).  Kernel launch counts are
   reset just before and read just after each fit; every kernel of the
   path must have launched, and the holdout AUC must exceed 0.8.
5. Profiles one more default fit with ``torch.profiler``: device time by
   kernel and the device's busy share of the fit's wall clock.
6. Holds the paged decode-attention kernels (K3) against their plain
   version at the LLM engine's shapes (Llama-3.2-1B heads: H=32, KV=8,
   D=64; 16 slots of 2048 positions; seeded ragged spans including 1, the
   tile and chunk edges and 2048): bf16 at S = 1, 2, 4, 8 and 32 through
   the split kernel (S=32 spreads its 128 query rows per kv head over two
   row chunks; atol = rtol = 1e-2 on rows with a live key) and f32 at S = 1
   through the f32 split kernel (atol 1e-5); each call launches the split
   kernel at its shape.  Times, on the device alone,
   the kernel, the previous kernel on the same inputs (in turns: previous,
   kernel, kernel, previous), the plain version and one
   ``scaled_dot_product_attention`` call over the full cache rows with a
   boolean span mask, each call on another of 6 copies of the cache so
   that it reads K/V cold from device memory as in the engine; computes
   the bound, the achieved share of 3.35 TB/s and the ratio to SDPA.
   The same at the caches of phases 19c, 20a and 27 (27a: f32, 4 slots
   of 512, at S=1 and at the drafts' widest verify S=8; 27b: bf16 at
   S=1, 8 slots of 2048).  The previous kernel's times and errors enter
   the kernels line under its own launch key (``variant=previous``).
7. The decode engine on the card against the engine on the CPU, f32, at
   Llama-3.2-1B width and 2 layers (max_len 512, 4 slots, ragged
   repeated-phrase prompts admitted as slots free), once plain and once
   with ``spec_draft_len=4``, each on the card both eagerly and with
   ``warmup="sync"`` (every step a CUDA graph replay): greedy tokens must
   be equal on all three, equal to the port's dense ``generate`` on the
   card, and K3 must have launched on the card (the graph engine: at S=1
   in the plain run and at S>1 in the speculative run, counted through
   the replays, with one replay per step and no stall).
8. The main LLM path at full width and depth: ``LlamaConfig.llama3_1b(
   max_len=2048)`` in bf16 (16 layers, vocab 128,256, tied head), random
   weights from ``--seed``, ``SlotEngine(n_slots=16)`` over 24 requests
   of 64-1536 prompt tokens and 64 new tokens each, admitted as slots
   free, with ``spec_draft_len=0`` and with 7, each run eagerly and with
   ``warmup="sync"`` in turns (eager, graph, graph, eager).  K3's launch
   counts are reset just before and read just after each run: the S=1
   shape must have launched in each plain run, an S>1 shape in each
   speculative run; a graph run must replay once per step and stall
   never.  Reports per run decode tokens/s, mean step ms, admit (TTFT)
   p50/p90, decode K/V bytes per token (the reference's tile ledger and
   the exact live spans the kernel reads), and for a graph run the
   plane's warm-up seconds, the graph pool's bytes, replays and stalls;
   then the graph runs' token agreement with the eager runs and the
   eager runs' agreement with a dense-backend engine (reported, not
   asserted: random bf16 weights give near-tied argmaxes).
9. Profiles a window of full-width plain decode steps with
   ``torch.profiler``, eagerly and with graphs: the step's wall, the
   device's busy share, K3's device time, the top kernels, the kernels
   and ``cudaGraphLaunch`` calls per step, the host time inside PyTorch's
   operators and CUDA runtime calls per step, and the operators that
   take the most host time.

10. GBDT breadth at full width (1M x 28, 100k holdout, ``--iters``
    iterations; launch counts reset just before and read just after each
    fit): (a) ``GBDTClassifier(growthPolicy="lossguide", numLeaves=31,
    maxBin=255)``: both K1 shapes of a lossguide fit (coarse S=1 over the
    left child, K refined rows by id) must launch once per tree root and
    split, holdout AUC > 0.8; reports s/iteration beside the depthwise
    fit's (phase 4) and profiles one fit (the histogram kernels' device
    ms and the busy share); (b) three classes from the tertiles of the
    label concept's score with ``baggingFraction=0.8, baggingFreq=1``,
    depthwise: K2's root pass must launch for 3 trees per iteration,
    holdout accuracy > 0.55; reports multi_logloss and s/iteration.
11. Breadth, the card against the CPU on 8,192 rows, 2 iterations:
    lossguide (two-level on and off), bagging, GOSS, DART, RF,
    multiclass, multiclassova, huber, poisson, 4 categorical
    columns of 100 levels, EFB over 8 one-hot blocks of 32 levels
    depthwise and lossguide, monotone constraints (basic, intermediate,
    advanced, each depthwise and lossguide), a validation fit with early
    stopping (the same best iteration, eval histories within 1e-9) and
    a checkpoint resume: equal splits, tree classes and weights, margins
    within 1e-4; the fit's gradients (float64 rounded to f32) equal on
    the card and the CPU at 1M rows, beside the count of rows where f32
    ``sigmoid``/``exp``/``softmax`` alone differ; the bagging mask and
    GOSS weights drawn on the card bit-identical to the CPU's, at 65,536
    and 1,000,003 rows.
12. GBDT breadth II at full width (500k x 28, 100k holdout, fresh data
    from ``--seed``), each fit through ``GBDTClassifier`` with its launch
    check: (a) a 100k-row validation set (``validationIndicatorCol``,
    ``earlyStoppingRound=5``, AUC, learning rate 0.5): best iteration,
    its AUC and s/iteration beside the same fit without validation for
    as many iterations, and one evaluation's parts timed apart; (b) ``checkpointInterval=5``: 5 iterations, then
    resumed to 10, trees equal to an uninterrupted 10-iteration fit; (c)
    4 categorical columns of 100 levels, holdout AUC > 0.8; (d) 8
    one-hot blocks of 32 levels (284 features): EFB against unbundled,
    both at ``two_level_hist="off"``, depthwise and lossguide, held to
    the JAX package's EFB property (split features equal, split bins
    within 1, margins within 1e-3), with the bundle count, both fits'
    s/iteration, K2's waves over the bundled columns (> 0) and the
    splits on features that share a bundle, which route through a
    non-full range (> 0); (e)
    monotone constraints on 3 features, each method: sweeps of each
    constrained feature over 1,000 holdout rows find no violation.
13. GBDT breadth III (fresh data from ``--seed``; launch counts reset
    just before and read just after each fit): (a) ``GBDTRanker
    (numLeaves=31, maxBin=255)`` at MSLR-WEB10K's shape, 10,000 queries
    of 1-239 rows (~1.2M rows) x 136 features, relevance 0-4, and 1,000
    validation queries flagged by ``validationIndicatorCol`` (metric
    ndcg): K1 and K2 launched at F=136, validation ndcg@10 above random
    scores' by 0.1; reports s/iteration, the lambdarank objective's
    device ms and ``Dataset.to_numpy``'s host seconds; (b) a streamed fit
    at HIGGS's shape, 11,000,000 x 28 from an SMLC file under ``build/``
    through ``ChunkedColumnSource``: ingest s, training s, s/iteration,
    holdout AUC > 0.8 on 100k rows, and the peak of ``tracemalloc``'s
    traced host allocations during ``train`` below a quarter of the raw
    feature bytes; phase 4's 1M rows streamed from a file grow the
    in-memory fit's trees; (c) phase 4's model, phase 10b's three-class
    model and the ranker exported with ``get_model_string`` and
    re-imported on the card: margins within 1e-6, the imported model's
    export a fixed point; (d) ``featuresShapCol`` on 1,000 holdout rows
    of phase 4's model and 200 of the ranker: each row's contributions
    and bias sum to the card's margin within 1e-4; host s per 1,000 rows.

14. The DL text path (``models/dl``, plain PyTorch: no kernel of the
    port): (a) the tiny ``TextEncoder`` at f32, dropout 0: three adamw
    steps on the card against the CPU from the same seeded weights,
    losses, parameters and eval logits within 1e-4 (bf16 reported); (b)
    the main path, ``Pipeline([DeepTextClassifier(modelSize="base",
    vocabSize=30522, maxTokenLen=128, batchSize=128, precision="bf16",
    maxEpochs=2)]).fit`` then ``transform``: 4,096 texts of random words
    from a 45,000-word list (the tokenizer fills its 30,522 ids), each
    class planted by 10 marker words, 2,048 held-out texts at accuracy >
    0.8; (c) bench.py's window, BERT-base at batch 128 x seq 128: 10
    steps after 3 of warm-up, median of 3 windows, ``bf16`` and
    ``bf16_grad`` in turns: samples/s, step ms and MFU (6·P·128 over
    989 TFLOP/s); (d) ``torch.profiler`` over 5 bf16 steps: the device's
    busy share, device ms by kernel kind and the top kernels.
15. The DL vision path: (a) ResNet-18 at 16x16, f32, eval and train
    forwards on the card against the CPU: logits and the new batch
    statistics within 1e-4; (b) ``DeepVisionClassifier(backbone=
    "resnet50", batchSize=256)`` at 224x224x3 on 4,096 seeded images
    with a planted class marker, 2 epochs (32 steps, so the BatchNorm
    running averages forget their init), then ``transform`` of 512:
    accuracy reported; (c) a window as in 14(c) at batch 256, bf16: samples/s, the
    forward flops per image counted from the convolution shapes
    (2·kh·kw·Cin·Cout·Ho·Wo each, plus the head; x3 for a training step)
    and MFU; (d) a profile as in 14(d).
16. The online learners (``models/online``, plain PyTorch with CUDA
    graphs: no kernel of the port): (a) at f32, 4,096 rows, each learner
    fit on the card and on the CPU: ``OnlineSGDClassifier`` (logistic,
    hinge), ``OnlineSGDRegressor`` (squared, quantile, poisson),
    ``OnlineGeneric`` on VW lines, ``OnlineGenericProgressive`` (its
    card seconds reported) and ``ContextualBandit``: states and outputs
    within 1e-4 of their scale, and ``train_sgd``'s graph pass
    bit-identical to its eager pass; (b) the main path at Criteo
    display-ads' column shape (13 log1p counts, 26 categorical columns
    over the published cardinalities with a Zipf tail; clicks from a
    hidden logistic model over the hashed features at Criteo's 25.6%
    rate): ``HashingFeaturizer(numBits=12)`` then
    ``Pipeline([OnlineSGDClassifier(numPasses=1, batchSize=32)]).fit``
    on 131,072 rows and ``transform`` of 32,768 (262,144 and 65,536
    before PR 20), holdout AUC > 0.75;
    then one upload of the 2.1 GB blocked matrix and passes eager and
    with graphs, one pass each: rows/s, states bit-identical to
    each other and to the estimator's fit; ``torch.profiler`` over a
    graph pass and 512 eager steps: busy share and kernels a step.
17. The MoE text encoder: (a) the tiny encoder with 4 experts card
    against CPU at f32 (limit 1e-4), and the MoE FFN's gather form
    against the reference's dense form on the card (limit 1e-5); (b)
    ``DeepTextClassifier(modelSize="base", numExperts=8, moeTopK=2)``
    (8 experts on every other FFN, capacity factor 1.25): 14(c)'s
    window in bf16 with samples/s, step ms, peak memory, the share of
    choices dropped by the capacity and MFU over the FLOPs executed
    (the E·C padded slots counted), then a 64-step fit → transform on
    14(b)'s corpus, holdout accuracy > 0.8; (c) a profile as in 14(d).

18. The LLM served over HTTP: ``LLMServer(n_slots=16, max_len=2048,
    warmup="background")`` over phase 8's model; ``/readyz`` must answer
    503 "warming" at once and 200 after the plane's thread has captured
    the graphs.  Phase 8's 24 requests are posted at once from client
    threads, every other one streamed; K3's counts are reset just before
    and read just after.  Every reply must equal phase 8's graph engine
    driven directly, K3 must launch, and ``/metrics``'s
    ``llm_engine_tokens_total`` must equal the tokens served.  Reports
    HTTP tokens/s against the direct engine's, the client's time to the
    stream's first byte (p50/p90) against the engine's admit ms, the
    step ms and the ``/sloz`` TTFT objective.
19. Fine-tune, then serve speculatively, at bench.py's configuration
    (``LlamaConfig.tiny(vocab_size=512, d_model=1024, num_layers=12,
    num_heads=16, num_kv_heads=4, max_len=256)``): (a) 3 adamw steps at
    f32 on the card and the CPU from the same weights at lr 1e-4 (every
    weight within 1e-4, losses within 1e-5 relative); (b) ``finetune_lm``
    over 120 batches (250 before PR 20) of ``templated_log_corpus(rng,
    32, 8)`` at lr 5e-4 in
    bf16: first and final loss, steps/s, tokens/s, MFU over 6·P·tokens,
    and a ``torch.profiler`` breakdown of 5 steps;
    (c) the trained and the random-init model each served by
    ``LLMServer`` with ``spec_draft_len=7`` and plain, 8 prompts x 64
    tokens: speculative replies must equal the plain ones; reports the
    committed tokens per slot-step, the drafter's hit rate and
    acceptance (this random init repeats one token, which prompt lookup
    drafts perfectly, so it is the anchor and not held to a ratio; the
    1.5x contrast is ``tests/test_torch_llm_finetune.py``'s, at the JAX
    test's configuration).
20. The rest of the LLM slice.  (a) ``LlamaConfig.tiny(num_layers=2)``
    at f32, the same weights on the card and on the CPU, 4 slots of 128
    positions: ``llama_from_pretrained`` on an HF directory written here
    (logits within 1e-4), ``quantize_int8`` (int8 arrays and scales
    bit-identical) and the int8 engine, a restore from the host KV arena
    into a relaunched engine (equal to a cold ``generate`` of the whole
    prompt), preempt → resume through the arena (equal to the
    uninterrupted run), ``generate_speculative`` (equal to ``generate``,
    stats equal) and ``LLMTransformer`` (equal to ``generate``'s decoded
    tokens): tokens equal on both devices; then a child process serving
    with a journal under ``build/`` is SIGKILLed at
    ``kvtier.journal_append`` after 3 appends, and a fresh server on the
    card replays the journal: the resumed reply must equal the
    uninterrupted greedy one.  (b) Phase 8's model written as an HF
    directory with Llama-3.2-1B's published ``config.json`` (~2.5 GB of
    bf16 safetensors), read back by ``llama_from_pretrained(...,
    max_len=2048)`` (logits bitwise equal to the model's), then
    ``quantize_int8``: the reference test's relative logit error (held
    below 0.05 at that test's configuration, reported at full width);
    phase 8's 24 requests through a 16-slot graph engine, int8 then
    bf16: decode tokens/s, step ms, K3
    launches (equal), greedy agreement, and a profile of each step.  (c)
    ``LLMServer(n_slots=16, kv_arena_bytes=2 GiB, journal_dir=...)``: 24
    two-turn conversations (turn 2 = turn 1's prompt + reply + 16 new
    tokens), each turn posted at once; every session's journal must hold
    its turn 2; reports the arena's restores and restored tokens, admit
    ms restored against cold, spill ms and bytes per retirement, the
    journal's µs per token, HTTP tokens/s against phase 18's, and turn
    2's agreement with a cold engine (bf16: reported); then a full-width
    slot preempted mid-decode and resumed from the arena must give the
    uninterrupted run's tokens bit for bit.  K3's launches of 20a-c's
    card runs join the kernels line; every shape they launched is one
    phase 6 holds (phase 6 adds 20a's f32 shape: 4 slots, H=8, KV=4,
    D=16, T=128).
21. ONNX batch inference and the image stages (``models/onnx``,
    ``image``; no kernel of the port: XLA computes these in the JAX
    package): (a) a small conv/BN/pool/gemm graph, a tiny BERT
    classifier (2 layers, 32 wide, a padded mask) and ResNet-50 on one
    3x64x64 image, f32 and bf16, and an ``ImageTransformer`` chain, on
    the card against the port's CPU path (f32 within 1e-5 of scale,
    ResNet-50 1e-4 with the argmax equal, bf16 2e-2, BERT bf16 5e-2);
    (b) bench.py's ResNet-50 window (batch 32, 3x224x224, 1,000
    classes, seed 0) through ``compile_onnx`` at f32 (TF32 off) and
    bf16 in turns: images/s (median of 3 windows of 60 dispatches), step
    ms, TFLOP/s over the convolutions' and head's flops counted from
    their shapes, the folded and per-call node counts and no upload a
    call; (c) ``ONNXModel.transform`` over 1,024 seeded images at
    ``miniBatchSize`` 128, f32 and bf16: images/s, and a profiled run's
    device kernel ms against the rest (host); (d) ``ImageTransformer``
    (resize 256x256, center crop 224, ImageNet normalize) then a headless
    ``ImageFeaturizer`` (ResNet-50's 2,048-d Flatten) over 512 seeded
    256x320 images: features/s, features equal to the sliced
    ``ONNXModel`` on the same tensors; (e) a BERT-base-width ONNX
    classifier (12 layers, 768, 12 heads, seq 128, vocab 30,522, a
    seeded HF-named state dict) at batch 64, f32 and bf16 in turns:
    sequences/s and the argmax agreement; (f) ``torch.profiler`` over 5
    bf16 ResNet-50 calls of (b): launches, device ms by kind, busy share.
    Every line carries the card's name and power limit.
22. The explainers and the classic estimators (``explainers``, ``nn``,
    ``isolationforest``, ``recommendation``, ``cyber``; no TPU kernel in
    the JAX package, so no K-kernel: only (c)'s GBDT fit may launch, K1
    and K2 as in phase 4, counted as the kernels line's run
    ``phase22c``):
    (a) each module at a small size on the card and through the port's
    CPU path on the same inputs, each largest difference printed beside
    its limit: the batched float64 solvers (B = 64), Tabular/Vector/Text/
    Image LIME and SHAP (SHAP's efficiency sum too) and ICE over a host
    logistic model, KNN 4,096 x 32 with duplicated points, an isolation
    forest on 10,000 x 8, SAR 500 x 300 with tied items and access-anomaly
    ALS 400 x 200; (b) ``ImageLIME`` over bench.py's ResNet-50 zoo graph
    (``ImageTransformer`` normalize then ``ImageFeaturizer(headless=
    False)``, f32) explaining one class's logit on 2 seeded 224² images,
    1,000 samples each, ``cellSize`` 16: explained images/s, scored
    samples/s and the host perturbation / scoring / solve seconds; (c) a
    ``GBDTClassifier`` (100 iterations, 31 leaves) at bench.py's 1M x 28
    task, then ``TabularSHAP`` and ``TabularLIME`` over 128 rows at 1,000
    samples: rows explained/s and the largest SHAP efficiency residual;
    (d) KNN at SIFT1M's shape (1,000,000 x 128 f32 index, 10,000
    queries, k = 100, ``leafSize`` 1024): queries/s, the top-100 of 100
    queries equal, as sets, to a float64 brute force, and
    ``ConditionalKNN`` over 10 labels with 1,000 queries; (e) an
    isolation forest at the Credit Card Fraud dataset's shape (284,807 x
    30, 100 trees of 256 samples): fit s and scored rows/s; (f) SAR at
    MovieLens-1M's shape (6,040 users, 3,706 items, 1,000,209 timed
    ratings, jaccard): fit s, ``recommend_for_all_users(10)`` s and
    ``RankingEvaluator`` ndcg@10 on a per-user held-out quarter; (g)
    ``AccessAnomaly`` on one tenant of 20,000 users x 5,000 resources and
    1,000,000 access triples (rank 10, 25 iterations, regParam 1.0): fit
    s, ms per ALS iteration and scored pairs/s.
23. Serving on the card (``serving_paths``; only (b)'s fit launches K1
    and K2, counted as the kernels line's run ``phase23``; any other
    launch in the phase raises): (b) bench.py's task at HIGGS's width,
    500,000 x 28 on a 1/64 grid plus a label, written as a 145 MB CSV
    whose fields are each value's exact decimal, read back bit for bit
    by ``Dataset.from_csv`` (the native parser must have read it:
    ``native.CSV_PARSES``), parse s and MB/s; the permissive parse of
    50,000 lines with 1% ragged or unparseable, whose quarantine must
    hold exactly those lines with their line numbers;
    ``csv_to_colstore`` read back equal through a ``ChunkedColumnSource``;
    then ``GBDTClassifier`` (100 iterations, 31 leaves, maxBin 255) fit
    from the CSV's Dataset; (a) the booster served from the card and,
    carried as LightGBM text, from the CPU by ``PipelineServer``: 2,048
    records over HTTP, each server's replies equal to one ``transform``
    over the same rows, card against CPU margins within 1e-4 and labels
    equal; (c) the walk of all trees at once against the per-tree walk
    (bit-equal, in turns), then ``PipelineServer`` (batch 64, 10 ms) at
    ``num_workers`` 1 and 2: 16 keep-alive HTTP clients x 64 records
    (records/s, latency p50/p99, replies equal to one transform), the
    per-batch split (parse, ``from_rows``, transform with its CUDA-event
    stream span, format + reply) and, at one worker, a
    ``ContinuousClient`` sending 2,048 frames in windows of 128
    (marginal ms/record and solo round trip, medians of 3); (d) a
    ``MultiPipelineServer`` with ``/gbdt`` and ``/bert`` (phase 21e's
    BERT-base-width classifier in bf16, 128 token ids a record): each
    API's records/s alone and both loaded at once, every reply a 200 of
    its own API's shape; (e) the row guard on served batches, each with
    exact statuses: NaN-poisoned records (1%) 422 under a ``skip``
    pipeline whose first stage declares its input columns; the
    ``rowguard.poison_row`` site armed on 3 of 64 records 500s exactly
    those within the isolation budget; a real CUDA out-of-memory error
    above 12 records halves the batch (every record 200, the
    ``rowguard_safe_batch_size`` gauge set, the card usable after); a
    ``PreemptionError`` 503s the batch after one transform; a
    ``quarantine`` pipeline dead-letters 3 of 512 rows under their
    pipeline-input row numbers and ``Quarantine.replay`` through the
    fixed pipeline equals a clean run.
24. The profiling and tuning plane: (a) the ``Autotuner`` runs
    ``gbdt_hist_geometry`` at the four histogram geometries the default
    1M x 28 fit launches with (K2's coarse 32 bins over 28 features and
    refined 256 over 8, at 16 slots and 1; K1's refined build) and
    ``paged_attn_variant`` at phase 8's cache (S=1, S=8) and phase 19c's
    (S=1), every candidate first held against the plain version (K1
    exactly, K3 within 1e-2), each candidate's device ms printed and the
    winners persisted into a table under ``build/phase24/``; (b) a new
    plane on that table: the 1M x 28 fit's histogram consults load, its
    launches carry the winners' (features per block, tile) and its trees
    equal an untuned fit's bit for bit; a bf16 engine at 19c's geometry
    launches the winning K3 variant (held within 1e-2 of plain; greedy
    tokens against the default variant printed); (c) ``StepProfiler`` on
    that fit, unprofiled and profiled in turns (segments sum to the
    total within 1%, trees equal, s/iteration of both), on a BERT-base
    ``DeepTextClassifier`` fit with ``capture_xla`` (MFU in (0, 1], the
    captured flops beside the analytic count; the profiler's per-step
    sync timed against bare steps) and on the 1B graph engine (profiled
    steps = engine steps, tokens equal an unprofiled run); (d) ``GET
    /tunez`` on an ``LLMServer`` (200, ``check_tunez``, the engine's
    consults); (e) ``core.trace`` around a short fit names
    ``hist_rows_kernel``.
25. The parallel layer (``synapseml_tpu_torch.parallel``): a gang of two
    ranks, both on the one card over gloo (``run_on_local_cluster(...,
    device="cuda", backend="gloo")``), each loading phase 1's kernel
    build (its build time printed; a rank that compiles again fails):
    (a) ``cluster_report`` on both ranks (sums, gathers, placement, the
    device table naming the card), and the same on one NCCL rank; (b)
    ``psum``, ``all_gather``, ``reduce_scatter``, ``ring_allreduce`` and
    ``compressed_psum`` at bf16 and int8 on a wave's coarse histograms,
    CUDA tensors against the same op over the CPU on the same seeded
    values, bit-equal, with ms a call and the staged host bytes; (c) each
    rank fits ``Pipeline([GBDTClassifier(numShards=0)])`` on phase 4's
    1M x 28 task (500k rows a rank, maxBin 255, ``--iters``) with the
    histogram wire in f32 and in int8: both ranks' models equal (md5),
    rank 0's holdout AUC > 0.8 for both, K1 and K2 launched in each rank
    (the kernels line's runs ``phase25r0`` and ``phase25r1``), the
    all-reduces and their wire bytes an iteration (int8 fewer), and
    beside them the one-process default fit's s/iteration
    (informational: the ranks share the card); (d) on one NCCL rank, a
    fit over the group bit-equal to the fit without one; (e) a 2-rank
    fit at 10,000 rows on the card and over the CPU: splits equal,
    margins within 1e-4, and the same at 10,000 rows for a
    feature-parallel, a voting-parallel and a data-parallel lambdarank
    fit, and ``train_sgd`` over the ranks at sync 0 and 4 (states within
    1e-5); (f) ``GBDTClassifier(parallelism="feature_parallel",
    numShards=0)`` on the 1M x 28 task (all rows, 14 features a rank):
    both ranks' models equal, equal to the one-process depthwise fit at
    two-level off, AUC > 0.8, K1 at the node-batched shape (F=14, B=256,
    S=16) launched (runs ``phase25r<rank>_featpar``), the routing
    all-reduces and their bytes an iteration; (g) voting-parallel at
    topK 20 and 28 and the data-parallel lossguide fit at two-level off
    (runs ``_vote``, ``_vote28``, ``_dplg``): ranks equal, AUC within
    0.005, topK=28 splitting as data-parallel, the histogram psums and
    bytes an iteration of each; (h) phase 13a's ranker (1.2M x 136)
    through ``GBDTRanker(numShards=0)``, whole queries packed onto the
    ranks: rankers equal, validation NDCG@10 within 0.01 of phase 13's
    (runs ``_ranker``); (i) ``train_sgd`` over phase 16b's 131,072 x
    4,096 rows (left by phase 16 under ``build/``) at sync 0 and 4:
    states equal on both ranks, holdout AUC > 0.75.  Every shape the
    new runs launch is one phase 2 held.  The NCCL rank's gang runs
    beside the gloo gang.  Its functions run small on
    the CPU (``parallel_gang(seed, torch.device("cpu"), "cpu", rows,
    iters, check_path, small_rows=..., nccl_rows=..., ranker_shape=(
    queries, validation queries, features), online_auc_floor=...)``).
26. Elastic resume (``core/checkpoint.py``, the supervisor's resize,
    the kernel build cache): every gang a ``GangSupervisor`` of gloo
    ranks on the one card with ``checkpoint_dir``, ``compile_cache_dir``
    (empty for (a), so its first attempt builds; seeded with phase 1's
    build for (b) and (c)) and ``heartbeat_interval_s``, the three gangs
    (a)-(c) at once.  (a) 2
    ranks fit ``GBDTClassifier(numShards=0, checkpointDir=...,
    checkpointInterval=1)`` on phase 25c's 1M x 28 rows at maxBin 255;
    ``SML_FAULTS="gbdt.checkpoint=kill_rank:rank=1:after=2:times=1"``
    kills rank 1 after its third checkpoint, a ``RetryPolicy`` relaunches
    the gang at 2, which resumes from iteration 3: restarts >= 1, both
    ranks' model strings equal 25c's fault-free fit (md5) and its margins
    on 8 rows bit for bit, ``last_recovery_s`` > 0, K1 and K2 launched in
    each rank's resumed attempt (runs ``phase26a_r<rank>_resumed``); (b)
    the same gang with ``min_ranks=1, shrink_after=1`` and rank 1 killed
    at every attempt: ``resize_history`` (2, 1, "shrink"), the one rank
    resumes from iteration >= 2 on all 1M rows with the
    ``gbdt.resize_resume`` note 2 → 1, the full tree count, holdout AUC
    within 0.005 of 25c's, K2 and K1 launched (run
    ``phase26b_r0_resumed``); (c) a 1-rank gang fits
    ``DeepVisionClassifier(backbone="resnet50", precision="f32")`` on 16
    seeded 224² images, batch 8, 2 epochs, a checkpoint every step,
    under deterministic cuDNN and cuBLAS (``CUBLAS_WORKSPACE_CONFIG``
    through ``env_extra``), killed after its second checkpoint: the
    relaunch resumes from step 2, and its probabilities match the
    uninterrupted fit's (run by the relaunched rank) within ``rtol=1e-4,
    atol=1e-5``; the checkpoint's bytes and seconds a save; (d) (a)'s
    dead attempt built every kernel library into its empty cache (each
    library a miss on at least one rank), and every relaunched or
    resized attempt builds nothing and loads each library from its
    cache; the dead attempts' reports are read from their log tails.  Its functions run small on the CPU
    (``elastic_resume(seed, torch.device("cpu"), "cpu", rows, iters,
    check_path, p25c, dl=dict(backbone="resnet18", n=8, size=32,
    batch=4, epochs=2, faults=P26_DL["faults"]))`` with ``p25c`` from a
    fault-free 2-rank ``phase26_gbdt`` gang; ~45 s).
27. The LLM served across replicas (``serving/distributed.py``,
    ``serving/disagg.py``, ``serving/autoscaler.py``): (a) f32 at the
    Llama-3.2-1B width and 2 layers (max_len 512, 4 slots, seeded prompts
    of 12-200 tokens): an ``LLMServer`` with a ``PrefillPool`` of one
    ``PrefillWorker`` (a 2-slot engine on the same model) and a host
    arena against a colocated ``LLMServer`` over HTTP, greedy tokens
    equal and every handoff ``ok``; then with ``disagg.transfer=corrupt``,
    ``=drop`` and ``disagg.prefill=error`` armed in turn (outcomes
    ``corrupt``, ``timeout``, ``fallback``, tokens still equal); then two
    decode servers sharing a journal behind a ``ReplicaRouter`` with
    roles ``decode, decode, prefill``: the pinned one closes,
    ``route_request(role="decode")`` repins to the survivor, whose
    ``resume`` equals turn 1 and whose turn 2 equals the colocated
    server's; K3 launched in every decode server (runs ``phase27a_*``).
    (b) A 2-rank gloo gang on the one card: each rank a
    ``DistributedServingServer`` echo (rank 0 reaches both; rank 1's
    ``leave()``s at the end) and, in two passes, an
    ``LLMServer(LlamaConfig.llama3_1b(max_len=2048))`` in bf16 (random
    weights from ``--seed``, equal on both), 8 slots, a 1 GiB arena and
    a shared journal directory, first with a ``PrefillPool`` over a
    2-slot engine on the same model, then without; in each pass the LLM
    servers' table gathered with ``exchange_routing_table`` over the
    gang's mesh; rank 0 drives 16 sessions x 2 turns (64-1,024 prompt
    tokens and 32 new, then 16-64 appended) through ``route_request``
    from 8 client threads; after 8 sessions' first turns rank 1 starts
    to leave (readyz draining, then the zero-drop drain once the
    traffic is done): every request 200, ``repin`` = the sessions on
    rank 1 (each resumed from the journal on rank 0, equal to its turn
    1), ``hit`` for every other second turn, K3 at S=1 on both ranks
    (runs ``phase27b_r0``, ``phase27b_r1``, ``phase27b_nopool_r0``,
    ``phase27b_nopool_r1``), and in the pool's pass every fresh turn's
    handoff ``ok``; reports tokens/s and TTFT p50/p90 of both passes
    (the same traffic straight to one server, ``p27_gang(direct=True)``,
    is left out of the full run, to make room for phase 28), the
    handoff latency, bytes a handoff, the gathers' ms and the bf16
    turn-1 agreement of the two passes.  (c) A
    ``ServingReplicaSet`` of ``LLMServer``s over phase 20a's f32 engine
    shape under an ``Autoscaler`` on the ``SloStore`` (2 s windows): an
    open-loop burst that sheds grows it 1 → 2, a trickle lets it shrink
    2 → 1, every request ends 200, the decisions are grow then shrink
    (flight-recorded), the departed replica's breaker and probe row are
    released (run ``phase27c``).  Its parts run small on the CPU
    (``p27_exact``, ``p27_gang`` and ``p27_autoscale`` with tiny configs
    and ``torch.device("cpu")``, ~15 s).
28. DL training over a gang of ranks (``models/dl`` over
    ``parallel.mesh``): two gloo ranks sharing the card.  (a) f32, IEEE
    products: BERT-base width (d 768, 12 heads, d_ff 3072, seq 128) cut
    to 2 layers with 8 experts top-2 on the MoE block at capacity factor
    0.5 (choices drop), five steps of 8 rows from the same seeded
    weights and batches, each mesh fit against this process's one-rank
    fit on the card (losses and parameters within 1e-5): (i) the data
    mesh D=2, (ii) data 1 x expert 2, (iii) ``zero1`` (against (i), with
    half the moment bytes); (iv) ``DeepVisionClassifier(numDevices=0)``
    on 26c's backbone (ResNet-50, 224², sgd) against one process:
    BatchNorm running statistics and the f32 probabilities within 1e-4
    of their scale; (v) int8 + error feedback + the sharded update
    within 0.05 of the f32 sync after 8 steps; (vi) the data mesh D=2
    with dropout 0.1 at 32 rows a step, sgd, against this process's
    one-rank fit (losses and parameters within 1e-5; step ms and peak
    memory of both).  (b) Phase 17b's model at ``expertParallelism=2``
    in bf16 (batch 128 x 128): each rank's samples/s, step ms, peak
    memory against 17b's, the MoE all-reduces' bytes and ms a step, and
    against 17b's one-process steps on the same weights and batch the
    losses of the first 3 steps and step 1's gradient sums of squares
    (experts summed over ranks, routers, the rest) within
    ``P28_FULL_LIMITS``.  (c) An int8 + EF + sharded-update text fit
    under a ``GangSupervisor``: rank 1 dies after its fourth checkpoint,
    the gang shrinks to one rank, which resumes twice from the same
    checkpoint bit-identically (the resize noted 2 → 1), runs only the
    steps after the checkpoint and ends within ``P28_ELASTIC_LIMIT`` of
    an uninterrupted one-rank fit's losses.  (d) The step profiler's
    cost capture over the 2-rank mesh for a GBDT and a DL fit: the same
    cost on both ranks and the fits equal to the uncaptured ones.  Every
    reading is printed before a failed check raises.  Its parts run
    small on the CPU
    (``dl_gang(0, torch.device("cpu"), "cpu", sizes=...)`` with tiny
    ``P28_*`` replacements, ~35 s).
30. The JAX-free stages over the GBDT (``ops``, ``automl``, ``causal``;
    ``a8_stages``).  (a) ``TrainClassifier(GBDTClassifier(
    numIterations=10))`` on 1M rows of bench.py's 28 columns, an 8-level
    string column and a "yes"/"no" label (Featurize: 28 + 8 one-hot
    columns, two-level histograms), transform and
    ``ComputeModelStatistics`` on 100,000 holdout rows: featurize, label
    index, GBDT fit (s/iteration) and transform seconds from the stages'
    per-verb records, holdout AUC > 0.8 (run ``phase30a``); the same
    stage at 20,000 rows on the card and on the CPU: equal trees
    (``split_digest``), margins within 1e-6, equal labels.  (b)
    ``TuneHyperparameters`` over ``GBDTClassifier(numIterations=10)`` on
    numLeaves {15, 31} x learningRate {0.1, 0.2} at 250,000 rows, at
    parallelism 1 and 4 in this process (runs ``phase30b_p1``,
    ``phase30b_p4``): equal ``allMetrics``, ``bestParams``,
    ``bestMetric`` and launch counts by shape; both walls.  (c)
    ``DoubleMLEstimator(maxIter=2)`` with GBDT nuisance models on 125,000
    rows, a binary treatment and an ATE of 2.0: within 0.1 and inside
    its interval; ``OrthoForestDMLEstimator``'s default forest (on the
    card) on an effect of 1.5 (x1 <= 0) and 3.0 (x1 > 0): the groups'
    mean effects ordered (run ``phase30c``); DML at 5,000 rows on the
    card and on the CPU (nuisance fits of 10 iterations): raw effects
    within 1e-6.  Every shape the runs
    launch is one phase 2 held against the plain version.  Small on the
    CPU: ``a8_stages(0, torch.device("cpu"), "cpu", check_path,
    rows=20000, hold=4000, tune_rows=20000, dml_rows=20000, small=3000,
    forest_cpu=True, auc_floor=0.7)`` (~2 min; its 30c ATE check needs
    the full rows).
31. The clients beside the card (``services``, ``io.powerbi``,
    ``downloader``; ``clients_beside_the_card``), against a recording
    HTTP server the phase starts on 127.0.0.1 (no network).  (a)
    ``OpenAIEmbedding`` over 2,048 short texts at concurrency 8, the mock
    answering each with a 1,536-wide vector (ada-002's width) drawn from
    the seed and a hash of the text: the vectors must be the mock's; then
    ``KNN(k=10)`` fit/transform on the card and on the CPU: equal
    neighbour ids; the stage's records/s and the KNN's walls.  (b)
    ``ModelDownloader`` fetches a manifest and ``onnx_small_cnn(seed)``'s
    bytes, checks the sha256 and refuses a tampered copy; ``ONNXModel``
    runs the download on the card and on the CPU within phase 21a's f32
    limit (1e-5 over scale).  (c) ``GBDTClassifier(numIterations=iters)``
    fits on the card over 100,000 rows of bench.py's 28 columns (run
    ``phase31``: K2's launches, strict), and ``PowerBIWriter`` posts the
    predictions in batches of 1,000: the sink holds every row once, with
    equal values; its rows/s.  (d) ``TextSentiment`` and
    ``SimpleDetectAnomalies`` with an injected 503 (retried at zero
    delay) and a 400 (``"400 Bad Request"`` in ``errors``).  Small on
    the CPU: ``clients_beside_the_card(0, torch.device("cpu"), "cpu", 2,
    lambda n, r: None, root)`` with smaller ``P31_*`` values.

Every phase's wall is printed on its own line, and their sum at the
end.

Phase 2 also holds K2 and K1 at the shapes of phase 13 (F=136 at ~1.2M
rows, F=28 at 11M rows: wave, root and refined build) and of phase 25
(K1 at F=14, B=256, S=16 over 1M rows; F=28, B=256, S=1 over 500k);
phase 26's resumed attempts launch phase 4's two-level shapes (500k
rows a rank, and 1M on the one rank left after the shrink), and
phase 11 adds lambdarank (groups of 1-239 rows, some past 128; with
``labelGain``) and streamed fits from a ``ChunkedColumnSource`` (an odd
``chunk_rows``) and a ``SparseChunkedSource`` with EFB.

Prints the kernels' JSON line (each K1/K2 shape with its launches summed
over the runs that launch it, and by run), then the card's name and
power limit,
then ``{"ok": true, "device": {...}}`` as the last line.  Any failed
check raises, and the script exits nonzero without that line.  Without
a card it exits 1 before printing any result.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import os
import shutil
import subprocess
import sys
import time
from typing import Optional

import numpy as np
import torch

#: published peaks of one H100 SXM (NVIDIA data sheet): HBM bytes/s,
#: non-tensor-core 32-bit operations/s and dense bf16 tensor-core flops/s
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12
PEAK_BF16_S = 989e12
#: requests of the full-width LLM run (phase 8): 1.5 waves of 16 slots
LLM_REQUESTS = 24
#: where phases 11 and 12 write their checkpoints (``build/`` is not
#: committed); each run removes its own
CKPT_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                         "chip_smoke_checkpoints")
#: phase 13's shapes: MSLR-WEB10K's 136 features over 10,000 queries of
#: 1-239 rows (and 1,000 validation queries); HIGGS's 11,000,000 x 28
RANK_Q, RANK_VQ, RANK_F, RANK_MAXG = 10_000, 1_000, 136, 239
HIGGS_N = 11_000_000
#: copies of the K/V cache K3's timed calls rotate over (phase 6): at 16
#: slots x 2048 positions, 6 x 67 MB in bf16, so no call finds its K/V in
#: the 50 MB L2
K3_COPIES = 6


def log(*a):
    print(*a, flush=True)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device milliseconds of ``fn()`` on the current stream.  The
    calls queue behind a ~10 ms sleep kernel, so the events time the
    device's back-to-back work and not the host's dispatch of it."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def bound(nbytes: int, nops: int, peak_ops: float = PEAK_OPS_S):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over ``peak_ops`` (default the 32-bit rate)."""
    tb = nbytes / PEAK_BYTES_S * 1e3
    to = nops / peak_ops * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def gbdt_labels(rng, X, extra=0.0):
    """bench.py's label concept for train and holdout (plus ``extra``, a
    generated columns' part of the score)."""
    return (X[:, 0] * 2 - X[:, 1] + X[:, 2] * X[:, 3] + extra
            + rng.normal(scale=0.5, size=len(X)) > 0).astype(np.float64)


#: phase 12's generated columns: 4 categorical columns of 100 levels, 8
#: one-hot blocks of 32 levels (which EFB bundles into 8 columns beside
#: the 28 dense ones)
CAT_COLS, CAT_LEVELS = 4, 100
OH_BLOCKS, OH_LEVELS = 8, 32
#: phase 12's monotone constraints: x0 up, x1 down, x2 up (the task's
#: x2·x3 term is not monotone in x2)
MONO = [1, -1, 1] + [0] * 25


def with_categorical(rng, X):
    """X with 4 categorical columns (codes of 100 levels) appended, and
    their part of the label score (category subsets)."""
    c = rng.integers(0, CAT_LEVELS, (len(X), CAT_COLS))
    extra = ((c[:, 0] % 3 == 0) * 1.0 - (c[:, 1] % 4 == 1) * 1.0
             + (c[:, 2] < 20) * 0.5)
    return np.concatenate([X, c.astype(np.float32)], axis=1), extra


def with_onehot(rng, X):
    """X with 8 one-hot blocks of 32 levels appended, and their part of
    the label score."""
    n = len(X)
    c = rng.integers(0, OH_LEVELS, (n, OH_BLOCKS))
    oh = np.zeros((n, OH_BLOCKS * OH_LEVELS), np.float32)
    oh[np.arange(n)[:, None], np.arange(OH_BLOCKS) * OH_LEVELS + c] = 1.0
    # level sets of two blocks, and single levels of four more, so that
    # trees split on one-hot features (which share a bundle) as well as
    # on the dense ones
    extra = ((c[:, 0] < 8) * 1.0 - (c[:, 1] % 5 == 0) * 0.8
             + 2.0 * ((c[:, 2] == 0) * 1.0 - (c[:, 3] == 1) + (c[:, 4] == 2)
                      - (c[:, 5] == 3)))
    return np.concatenate([X, oh], axis=1), extra


def sweep_violations(booster, base, feats_dirs, n_grid=32):
    """Each constrained feature swept over ``n_grid`` values in [-3, 3]
    from every base row, the other features fixed: → {feature: (steps
    against its direction by more than 1e-6, the largest such step)}."""
    out = {}
    grid = np.linspace(-3, 3, n_grid, dtype=np.float32)
    for f, d in feats_dirs:
        probes = np.repeat(base, n_grid, axis=0)
        probes[:, f] = np.tile(grid, len(base))
        m = booster.predict_margin(probes).reshape(len(base), n_grid)
        step = np.diff(m, axis=1) * d
        out[f] = (int((step < -1e-6).sum()), max(0.0, -float(step.min())))
    return out


# --------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# --------------------------------------------------------------------------

def vals_for(rng, N, dev):
    from synapseml_tpu_torch.models.gbdt.hist import prep_hist_vals
    grad = torch.as_tensor(rng.normal(size=N).astype(np.float32), device=dev)
    hess = torch.as_tensor((rng.random(N) * 0.25).astype(np.float32),
                           device=dev)
    mask = torch.ones(N, dtype=torch.float32, device=dev)
    return prep_hist_vals(grad.to(torch.bfloat16), hess.to(torch.bfloat16),
                          mask)


def in_turns(kernel, previous, iters: int = 20):
    """(kernel ms, previous kernel ms) on the same inputs, timed in turns
    previous, kernel, kernel, previous; each the better of its two."""
    prev_a = cuda_ms(previous, iters=iters)
    ms = [cuda_ms(kernel, iters=iters) for _ in range(2)]
    prev_b = cuda_ms(previous, iters=iters)
    return min(ms), min(prev_a, prev_b)


def geometry(nfeat, width, S) -> dict:
    """hist_rows_kernel's geometry for one feature set: features per
    block, tile, groups, dynamic shared bytes, the blocks an SM's shared
    memory holds and the gathers one SM keeps in flight."""
    from synapseml_tpu_torch.models.gbdt import hist as H
    fpb, tile, groups, smem = H.rows_geometry(nfeat, width, S)
    per_sm = H.rows_blocks_per_sm(smem)
    return dict(fpb=fpb, tile=tile, groups=groups, smem=smem,
                blocks_per_sm=per_sm,
                flight_per_sm=per_sm * tile * (8 + 4 * fpb))


def check_equal(what, got, want) -> int:
    """→ the largest difference between two tuples of int32 outputs;
    raises unless it is 0."""
    err = 0
    for a, b in zip(got, want):
        if (a is None) != (b is None):
            raise AssertionError(f"{what}: outputs differ in kind")
        if a is not None and a.numel():
            err = max(err, int((a.long() - b.long()).abs().max()))
    if err:
        raise AssertionError(f"{what}: outputs differ by {err}")
    return err


def draw_bins(rng, B: int, F: int, N: int) -> np.ndarray:
    """(F, N) int32 bins uniform in [0, B), drawn as int32: a quarter of
    the host time of an int64 draw cast down (phase 2 draws ~2.3 billion
    of them; to make room for phase 29)."""
    return rng.integers(0, B, (F, N), dtype=np.int32)


def k2_case(rng, dev, N, F, S, B, shift, K, ranges="full"):
    """One mid-tree wave (S pending leaves among 2S node ids) or, with
    S=1, a tree's root pass (every row in leaf 0, split all-left), in the
    id form the grower calls: split and refined features are row ids of
    the binned matrix.  ``ranges="bundle"``: an EFB wave over bundled
    columns, each split routing through a random range (rlo, rhi] inside
    the column, its threshold within the range and the rows outside by a
    random ``dflt``."""
    from synapseml_tpu_torch.models.gbdt import hist as H
    i32 = torch.int32
    bins = torch.as_tensor(draw_bins(rng, B, F, N), device=dev)
    vals, _ = vals_for(rng, N, dev)
    root = S == 1
    if root:
        node_id = torch.zeros(N, dtype=i32, device=dev)
        leaf = torch.zeros(1, dtype=i32, device=dev)
        feat = torch.zeros(1, dtype=i32, device=dev)
        t1 = torch.full((1,), B, dtype=i32, device=dev)
        l_id = torch.zeros(1, dtype=i32, device=dev)
        r_id = l_id
    else:
        node_id = torch.as_tensor(rng.integers(0, 2 * S, N).astype(np.int32),
                                  device=dev)
        leaf = torch.arange(S, dtype=i32, device=dev) * 2 + 1
        feat = torch.as_tensor(rng.integers(0, F, S).astype(np.int32),
                               device=dev)
        t1 = torch.as_tensor(rng.integers(0, B, S).astype(np.int32),
                             device=dev)
        l_id = torch.arange(S, dtype=i32, device=dev) * 2 + 2 * S
        r_id = l_id + 1
    rlo, rhi, dflt = (torch.full((S,), v, dtype=i32, device=dev)
                      for v in (-1, B, 1))
    if ranges == "bundle":
        lo = rng.integers(0, B // 2, S)
        hi = lo + rng.integers(1, B // 2, S)
        rlo, rhi, t1, dflt = (
            torch.as_tensor(a.astype(np.int32), device=dev) for a in (
                lo, hi, lo + rng.integers(0, hi - lo + 1),
                rng.integers(0, 2, S)))
    feat_k = (torch.as_tensor(rng.permutation(F)[:K].astype(np.int32),
                              device=dev) if K else None)
    # the previous kernel and the JAX signature take gathered rows
    sel = bins.index_select(0, feat.long())
    sel_k = bins.index_select(0, feat_k.long()) if K else None
    route = (node_id, leaf)
    split = (t1, rlo, rhi, dflt, l_id, r_id)
    ids = (bins, *route, feat, *split, vals, S, B, shift, feat_k)
    gathered = (bins, *route, sel, *split, vals, S, B, shift, sel_k)
    out_k = H.route_and_hist_ids_limbs(*ids)
    out_p = H.route_and_hist_plain(*gathered)
    torch.cuda.synchronize()
    err = max(check_equal("route_and_hist (ids)", out_k, out_p),
              check_equal("route_and_hist (sel)",
                          H.route_and_hist_limbs(*gathered), out_p),
              check_equal("route_and_hist_previous",
                          H.route_and_hist_limbs_previous(*gathered), out_p))
    Bh = H.coarse_bins(B, shift) if shift else B
    # reads: bins (the split bins and the K refined rows are rows of it),
    # node ids, limbs, the split table and ids; writes: new ids and the
    # histograms (8 int32 lanes)
    nbytes = (F * N * 4 + N * 4 + N * 8 + 8 * S * 4 + K * 4 + N * 4
              + F * Bh * S * 32 + K * B * S * 32)
    b_ms, b_by = bound(nbytes, N * (F + K) * 7 + N * 4)
    ms, prev = in_turns(lambda: H.route_and_hist_ids_limbs(*ids),
                        lambda: H.route_and_hist_limbs_previous(*gathered))
    r = dict(
        ms=ms, previous_ms=prev,
        route_ms=cuda_ms(lambda: H.route_rows(node_id, leaf, bins, feat,
                                              *split, S), iters=20),
        plain_ms=cuda_ms(lambda: H.route_and_hist_plain(*gathered), iters=3),
        library_ms=None, bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
        bytes=nbytes, rows_listed=int((H.route_plain(
            node_id, leaf, sel, *split)[1] >= 0).sum()),
        geometry=[geometry(F, Bh, S)] + ([geometry(K, B, S)] if K else []))
    r["bw_share"] = nbytes / (ms * 1e-3) / PEAK_BYTES_S
    return r


def k1_case(rng, dev, N, F, S, B, shift, K=0):
    """The two-level fine build (S=1, the K refined rows of F features by
    id), lossguide's per-split coarse build (S=1, all F features) or a
    node-batched build (S slots, all F features).  Slots are drawn in
    [-1, S), so at S=1 about half the rows are listed, as a left child's
    are."""
    from synapseml_tpu_torch.models.gbdt import hist as H
    bins = torch.as_tensor(draw_bins(rng, B, F, N), device=dev)
    slot = torch.as_tensor(rng.integers(-1, S, N).astype(np.int32),
                           device=dev)
    vals, _ = vals_for(rng, N, dev)
    feat = (torch.as_tensor(rng.permutation(F)[:K].astype(np.int32),
                            device=dev) if K else None)
    bins_k = bins.index_select(0, feat.long()) if K else bins
    Fk = K or F
    args = (bins, slot, vals, S, B, shift, feat)
    out_k = H.build_hist_nodes_limbs(*args)
    out_p = H.build_hist_nodes_plain(*args)
    torch.cuda.synchronize()
    err = max(check_equal("build_hist_nodes", [out_k], [out_p]),
              check_equal("build_hist_nodes_previous", [
                  H.build_hist_nodes_limbs_previous(bins_k, slot, vals, S,
                                                    B, shift)], [out_p]))
    # the library yardstick: one index_add_ over precomputed flat
    # (feature, bin, slot) ids, rows without a slot sent to a dump row
    Bh = H.coarse_bins(B, shift) if shift else B
    ok = slot >= 0
    ids = torch.where(ok[None, :],
                      (torch.arange(Fk, device=dev)[:, None] * Bh
                       + (bins_k.long() >> shift)) * S + slot.long()[None, :],
                      Fk * Bh * S).reshape(-1)
    src = vals.int()[None].expand(Fk, N, 8).reshape(-1, 8).contiguous()
    acc = torch.zeros((Fk * Bh * S + 1, 8), dtype=torch.int32, device=dev)
    lib = acc.clone().index_add_(0, ids, src)[:-1].view(Fk, Bh, S, 8)
    if not torch.equal(lib, out_k):
        raise AssertionError("build_hist_nodes: index_add_ yardstick "
                             "disagrees")
    # reads: the slots, then the bins and limbs of the rows they list
    # (what this run's slots need) and the feature ids; writes: the
    # histograms (8 int32 lanes)
    listed = int(ok.sum())
    nbytes = N * 4 + listed * (Fk * 4 + 8) + K * 4 + Fk * Bh * S * 32
    b_ms, b_by = bound(nbytes, listed * Fk * 7)
    ms, prev = in_turns(
        lambda: H.build_hist_nodes_limbs(*args),
        lambda: H.build_hist_nodes_limbs_previous(bins_k, slot, vals, S, B,
                                                  shift))
    r = dict(
        ms=ms, previous_ms=prev,
        plain_ms=cuda_ms(lambda: H.build_hist_nodes_plain(*args), iters=3),
        library_ms=cuda_ms(lambda: acc.clone().index_add_(0, ids, src)),
        bound_ms=b_ms, bound_by=b_by, max_abs_err=err, bytes=nbytes,
        rows_listed=listed, geometry=[geometry(Fk, Bh, S)])
    r["bw_share"] = nbytes / (ms * 1e-3) / PEAK_BYTES_S
    return r


# --------------------------------------------------------------------------
# phases 3 to 5: the main path
# --------------------------------------------------------------------------

def card_vs_cpu(X, y, Xh, kernels, iters: int = 2, valid=None,
                resume: bool = False, train_kw=None, **kw):
    """The same fit through ``train`` on the card and on the CPU: → the
    largest margin difference on ``Xh``; raises if any tree splits on
    another feature or bin, the trees' classes or weights differ, or a
    kernel in ``kernels`` never ran on the card.  ``valid``: the fits
    evaluate it every iteration and must stop at the same iteration with
    eval histories within 1e-9.  ``resume``: each device stops after
    half the iterations (checkpoints every iteration under ``build/``)
    and resumes.  ``X`` may be a chunked source (``y`` None);
    ``train_kw`` goes to ``train`` (``group``, ``valid_group``)."""
    from synapseml_tpu_torch.kernels import launches as L
    from synapseml_tpu_torch.models.gbdt.booster import BoostingConfig, train
    res = {}
    for d in ("cuda", "cpu"):
        L.reset()
        if resume:
            ck = os.path.join(CKPT_ROOT, f"card_vs_cpu_{d}")
            shutil.rmtree(ck, ignore_errors=True)
            for n in (iters // 2, iters):
                booster, hist = train(X, y, BoostingConfig(
                    num_iterations=n, **kw), checkpoint_dir=ck,
                    checkpoint_interval=1, device=d)
            shutil.rmtree(ck)
        else:
            booster, hist = train(X, y, BoostingConfig(num_iterations=iters,
                                                       **kw),
                                  valid=valid, device=d, **(train_kw or {}))
        if d == "cuda" and any(L.total(k) == 0 for k in kernels):
            raise AssertionError(f"{kw}: a kernel never ran on the card: "
                                 f"{L.BY_SHAPE}")
        res[d] = (booster, booster.predict_margin(Xh, device="cpu"), hist)
    bc, bp = res["cuda"][0], res["cpu"][0]
    if (bc.tree_class, bc.tree_weights) != (bp.tree_class, bp.tree_weights):
        raise AssertionError(f"{kw}: card and CPU trees differ in class or "
                             "weight")
    for tc, tp in zip(bc.trees, bp.trees):
        n = int(tc.num_nodes)
        if int(tp.num_nodes) != n or not (
                np.array_equal(tc.split_feature[:n], tp.split_feature[:n])
                and np.array_equal(tc.split_bin[:n], tp.split_bin[:n])):
            raise AssertionError(f"{kw}: card and CPU trees split "
                                 "differently")
    hc, hp = res["cuda"][2], res["cpu"][2]
    if valid is not None and (
            bc.best_iteration != bp.best_iteration or len(hc) != len(hp)
            or max(abs(a.value - b.value) for a, b in zip(hc, hp)) > 1e-9):
        raise AssertionError(f"{kw}: card and CPU validation differ: best "
                             f"iteration {bc.best_iteration} against "
                             f"{bp.best_iteration}, {len(hc)} against "
                             f"{len(hp)} evaluations")
    return float(np.max(np.abs(res["cuda"][1] - res["cpu"][1])))


def masks_card_vs_cpu(dev, n: int, seed: int) -> None:
    """The bagging mask and the GOSS weights drawn on the card equal the
    CPU's bit for bit (the same threefry keys; GOSS on the same |grad|)."""
    from synapseml_tpu_torch.models.gbdt import prng
    from synapseml_tpu_torch.models.gbdt.booster import bag_mask, goss_weights
    cpu = torch.device("cpu")
    bag_key = prng.fold_in(prng.prng_key(3), 0)
    goss_key = prng.prng_key((seed * 100003) & 0xffffffff)
    bag = bag_mask(bag_key, n, 0.8, dev)
    if not torch.equal(bag.cpu(), bag_mask(bag_key, n, 0.8, cpu)):
        raise AssertionError(f"n={n}: the bagging masks differ")
    g = torch.as_tensor(np.abs(np.random.default_rng(seed).normal(
        size=n)).astype(np.float32))
    got = goss_weights(g.to(dev), bag, goss_key, 0.2, 0.1).cpu()
    if not torch.equal(got, goss_weights(g, bag.cpu(), goss_key, 0.2, 0.1)):
        raise AssertionError(f"n={n}: the GOSS weights differ")


def objectives_card_vs_cpu(dev, n: int, seed: int) -> dict:
    """Rows whose f32 ``sigmoid`` / ``exp`` / 3-class ``softmax`` differ
    between the card and the CPU, evaluated in f32 and (as
    ``booster._grad_hess`` does) in float64 rounded to f32; raises if the
    objectives' gradients as the fit computes them differ."""
    from synapseml_tpu_torch.models.gbdt import objectives as O
    from synapseml_tpu_torch.models.gbdt.booster import _grad_hess
    rng = np.random.default_rng(seed)
    m = n // 3
    x = torch.as_tensor(rng.normal(scale=3, size=3 * m).astype(np.float32))
    out = {}
    for name, fn in (("sigmoid", torch.sigmoid), ("exp", torch.exp),
                     ("softmax", lambda t: torch.softmax(t.view(m, 3), -1))):
        for prec, cast in (("f32", lambda t: t),
                           ("f64", lambda t: t.double())):
            a, b = fn(cast(x.to(dev))).float().cpu(), fn(cast(x)).float()
            out[f"{name}_{prec}_rows_differing"] = int((a != b).sum())
    lab = torch.as_tensor(rng.integers(0, 3, 3 * m).astype(np.float32))
    onehot = torch.nn.functional.one_hot(lab[:m].long(), 3).float()
    for what, fn, s0, args in (
            ("binary", O.binary, x, ((lab > 0).float(), torch.ones(3 * m))),
            ("poisson", O.poisson, x, (lab, torch.ones(3 * m))),
            ("softmax", O.softmax_grad_hess, x.view(m, 3),
             (onehot, torch.ones(m)))):
        got = _grad_hess(fn, s0.to(dev), *(a.to(dev) for a in args))
        want = _grad_hess(fn, s0, *args)
        if not all(torch.equal(g.cpu(), w) for g, w in zip(got, want)):
            raise AssertionError(f"{what}: the fit's gradients differ "
                                 "between the card and the CPU")
    return out


def fit_path(X, y, Xh, yh, iters, device="cuda", valid=None, **params):
    """``Pipeline([GBDTClassifier(**params)]).fit`` then ``transform`` on
    the holdout; launch counts are reset just before the fit and read
    just after it.  ``valid`` = (Xv, yv): rows appended to the training
    set and flagged by ``validationIndicatorCol``.  → (result, the
    fitted model stage)."""
    from synapseml_tpu_torch.core import Dataset, Pipeline
    from synapseml_tpu_torch.kernels import launches as L
    from synapseml_tpu_torch.models.gbdt.estimators import GBDTClassifier
    from synapseml_tpu_torch.models.gbdt.metrics import auc, multi_logloss
    if valid is None:
        ds = Dataset({"features": list(X), "label": y})
    else:
        ds = Dataset({"features": list(np.concatenate([X, valid[0]])),
                      "label": np.concatenate([y, valid[1]]),
                      "isValid": np.arange(len(X) + len(valid[0]))
                      >= len(X)})
        params = dict(params, validationIndicatorCol="isValid")
    hold = Dataset({"features": list(Xh), "label": yh})
    L.reset()
    t0 = time.perf_counter()
    model = Pipeline(stages=[GBDTClassifier(
        numIterations=iters, device=device, **params)]).fit(ds)
    if device == "cuda":
        torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = {k: L.total(k) for k in ("build_hist_nodes",
                                        "route_and_hist")}
    shapes = dict(L.BY_SHAPE)
    t0 = time.perf_counter()
    out = model.transform(hold)
    transform_s = time.perf_counter() - t0
    proba = np.stack(out["probability"])
    n_class = len(np.unique(y))
    if proba.shape != (len(Xh), n_class) or not np.all(np.isfinite(proba)):
        raise AssertionError(f"transform gave {proba.shape} / non-finite")
    if set(out.columns) != {"features", "label", "rawPrediction",
                            "probability", "prediction"}:
        raise AssertionError(f"transform columns {out.columns}")
    gbdt = model.get_or_default("stages")[0]
    m = gbdt.training_measures
    trees = gbdt.booster.trees
    r = dict(fit_s=fit_s, train_s=m.training_s,
             s_per_iter=m.seconds_per_iteration(), eval_s=m.eval_s,
             iterations=m.iterations,
             binning_s=m.binning_s, transform_s=transform_s,
             trees=len(trees),
             splits=sum((int(t.num_nodes) - 1) // 2 for t in trees),
             launches=launches, shapes=shapes,
             two_level=gbdt.booster.config.two_level_hist)
    if n_class == 2:
        r["auc"] = float(auc(yh, proba[:, 1]))
    else:
        r["accuracy"] = float(np.mean(np.asarray(out["prediction"]) == yh))
        r["multi_logloss"] = float(multi_logloss(yh, np.log(proba)))
    return r, gbdt


def profile_fit(X, y, iters: int, **params) -> dict:
    """Device time by kernel over one fit, from ``torch.profiler`` (which
    adds host overhead to the fit it watches): → {wall_s, binning_s,
    train_s, kernel_s, busy_share, hist_ms (the histogram kernels'
    device ms), top: [[name, ms, calls], ...]}."""
    from torch.profiler import ProfilerActivity, profile

    from synapseml_tpu_torch.core import Dataset
    from synapseml_tpu_torch.models.gbdt.estimators import GBDTClassifier
    ds = Dataset({"features": list(X), "label": y})
    est = GBDTClassifier(numIterations=iters, **params)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        m = est.fit(ds).training_measures
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    kern.sort(key=lambda e: -e.self_device_time_total)
    total = sum(e.self_device_time_total for e in kern) / 1e6
    hist_ms = sum(e.self_device_time_total for e in kern
                  if "route_kernel" in e.key or "hist_rows_kernel" in e.key
                  ) / 1e3
    return dict(wall_s=wall, binning_s=m.binning_s, train_s=m.training_s,
                kernel_s=total, busy_share=total / wall, hist_ms=hist_ms,
                hist_share=hist_ms / 1e3 / wall,
                top=[[e.key[:60], e.self_device_time_total / 1e3, e.count]
                     for e in kern[:10]])


# --------------------------------------------------------------------------
# phases 6 to 9: the LLM decode path (SlotEngine over K3)
# --------------------------------------------------------------------------

def k3_case(dev, seed, B, S, H, KV, D, T, dtype, spans):
    """K3 against its plain version on the same inputs, timed beside the
    previous kernel (one block per (kv head, slot)), the plain version and
    one ``scaled_dot_product_attention`` call over the full cache rows with
    a boolean span mask (its inputs transposed to its head-major layout
    beforehand)."""
    from synapseml_tpu_torch.kernels import launches as L
    from synapseml_tpu_torch.models.llm import paged_attn as PA
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    q = torch.randn((B, S, H, D), generator=g, device=dev).to(dtype)
    k = torch.randn((B, T, KV, D), generator=g, device=dev).to(dtype)
    v = torch.randn((B, T, KV, D), generator=g, device=dev).to(dtype)
    q_in = q[:, 0] if S == 1 else q       # the decode step passes (B, H, D)
    sp = torch.as_tensor(np.asarray(spans, np.int32), device=dev)
    L.reset()
    out = PA.paged_decode_attention(q_in, k, v, sp)
    key = L.launch_key("paged_decode_attention", B=B, S=S, H=H, KV=KV, D=D,
                       T=T, dtype=PA._DTYPE_NAMES[dtype], variant="split")
    if L.BY_SHAPE != {key: 1}:
        raise AssertionError(f"K3 at {key} launched {L.BY_SHAPE}")
    prev = PA.paged_decode_attention_previous(q_in, k, v, sp)
    ref = PA.paged_decode_attention_plain(q_in, k, v, sp)
    out, prev, ref = (x.reshape(q.shape).float() for x in (out, prev, ref))
    lim = sp.long()[:, None] - (S - 1) + torch.arange(S, device=dev)[None]
    live = lim > 0                         # rows with at least one key
    atol, rtol = (1e-5, 0.0) if dtype == torch.float32 else (1e-2, 1e-2)
    for what, x in (("kernel", out), ("previous kernel", prev)):
        diff = (x - ref).abs()[live]
        if not bool((diff <= atol + rtol * ref.abs()[live]).all()):
            raise AssertionError(f"paged_decode_attention S={S} {dtype}: "
                                 f"{what} and plain differ by {diff.max()}")
    diff = (out - ref).abs()[live]
    diff_prev = (prev - ref).abs()[live]
    qt = q.transpose(1, 2).contiguous()                        # (B, H, S, D)
    kt = k.transpose(1, 2).contiguous()                        # (B, KV, T, D)
    vt = v.transpose(1, 2).contiguous()
    mask = (torch.arange(T, device=dev)[None, None] < lim[:, :, None])[:, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention

    lib_err = float((sdpa(qt, kt, vt, attn_mask=mask, enable_gqa=True)
                     .transpose(1, 2).float() - ref).abs()[live].max())
    if lib_err > 10 * atol + 0.05:
        raise AssertionError(f"SDPA yardstick disagrees by {lib_err}")
    item = torch.empty((), dtype=dtype).element_size()
    live_keys = int(np.minimum(np.asarray(spans), T).sum())
    # reads: each live K and V row once per kv head, q and the spans;
    # writes: out.  Flops: q.k and p.v over each slot's span per query row
    nbytes = (2 * live_keys * KV * D * item + 2 * B * S * H * D * item
              + 4 * B)
    flops = 4 * S * H * D * live_keys
    b_ms, b_by = bound(nbytes, flops, PEAK_BF16_S if dtype == torch.bfloat16
                       else PEAK_OPS_S)
    # Timed calls read the cache cold, as the engine's call does after the
    # other layers ran: each reads the next of K3_COPIES copies of K and V,
    # together past the 50 MB L2.  The kernel and the previous one run in
    # turns: previous, kernel, kernel, previous.
    kv = itertools.cycle([(k, v)] + [(k.clone(), v.clone())
                                     for _ in range(K3_COPIES - 1)])
    kvt = itertools.cycle([(kt, vt)] + [(kt.clone(), vt.clone())
                                        for _ in range(K3_COPIES - 1)])

    def on_copies(fn):
        return lambda: fn(q_in, *next(kv), sp)

    def lib():
        return sdpa(qt, *next(kvt), attn_mask=mask, enable_gqa=True)
    ms, prev = in_turns(on_copies(PA.paged_decode_attention),
                        on_copies(PA.paged_decode_attention_previous))
    r = dict(
        ms=ms, previous_ms=prev,
        plain_ms=cuda_ms(on_copies(PA.paged_decode_attention_plain),
                         iters=5),
        library_ms=cuda_ms(lib, iters=20), bound_ms=b_ms, bound_by=b_by,
        max_abs_err=float(diff.max()),
        previous_max_abs_err=float(diff_prev.max()), bytes=nbytes,
        sdpa_err=lib_err, launch_key=key)
    # achieved share of the memory rate, and the time against SDPA's
    r["bw_share"] = nbytes / (r["ms"] * 1e-3) / PEAK_BYTES_S
    r["vs_sdpa"] = r["ms"] / r["library_ms"]
    return r


def phrase_prompts(rng, lengths, vocab, period):
    """Repeated-phrase prompts (bench.py's spec-decode leg: a random
    phrase tiled to length), one phrase per request."""
    out = []
    for n in lengths:
        base = rng.integers(1, vocab, period)
        out.append(np.tile(base, -(-int(n) // period))[:n].astype(np.int32))
    return out


def drive(engine, prompts, new_tokens) -> dict:
    """Admit requests in order as slots free and step until all finish:
    → {outs (request -> generated ids), ttft_s (admit wall per request),
    step_s (wall per step), step_tokens, wall_s}.  Both ``admit`` and
    ``step`` end in a device-to-host copy, so their host clocks cover
    the device work."""
    pending = list(range(len(prompts)))
    req_of = {}
    outs, ttft, step_s = {}, [], []
    step_tokens = 0
    t0 = time.perf_counter()
    while pending or engine.active.any():
        while pending and engine.free_slot_count:
            i = pending.pop(0)
            ta = time.perf_counter()
            r = engine.admit(prompts[i], int(new_tokens[i]))
            ttft.append(time.perf_counter() - ta)
            req_of[r.slot] = i
            if r.finished:
                outs[i] = engine.generated_ids(r.slot)
        ts = time.perf_counter()
        events = engine.step()
        step_s.append(time.perf_counter() - ts)
        step_tokens += len(events)
        for ev in events:
            if ev.finished:
                outs[req_of[ev.slot]] = engine.generated_ids(ev.slot)
    return dict(outs=outs, ttft_s=ttft, step_s=step_s,
                step_tokens=step_tokens, wall_s=time.perf_counter() - t0)


def llm_card_vs_cpu(dev, seed: int) -> dict:
    """Phase 7: the engine on the card and on the CPU at f32, plain and
    speculative; raises on any token difference."""
    from synapseml_tpu_torch.kernels import launches as L
    from synapseml_tpu_torch.models.llm import (LlamaConfig, LlamaModel,
                                                SlotEngine, generate)
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on: the f32 check needs "
                             "full f32 products")
    cfg = LlamaConfig.llama3_1b(num_layers=2, max_len=512,
                                dtype=torch.float32)
    cpu = LlamaModel(cfg, device="cpu", seed=seed)
    card = LlamaModel(cfg, device=dev, seed=seed)
    card.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(seed)
    prompts = phrase_prompts(rng, [21, 40, 13, 33, 57, 9], cfg.vocab_size, 5)
    new = [12, 9, 16, 10, 12, 8]
    dense = [generate(card, p[None], max_new_tokens=n)[0]
             for p, n in zip(prompts, new)]
    res = {}
    for spec in (0, 4):
        outs, shapes = {}, {}
        for d, m, warmup in (("cpu", cpu, "off"), ("card", card, "off"),
                             ("graph", card, "sync")):
            eng = SlotEngine(m, n_slots=4, max_len=cfg.max_len,
                             spec_draft_len=spec, warmup=warmup,
                             device=m.device)
            L.reset()
            outs[d] = drive(eng, prompts, new)["outs"]
            if d == "cpu":
                continue
            shapes[d] = L.shapes("paged_decode_attention")
            verify = [k for k in shapes[d] if ",S=1," not in k]
            if not shapes[d] or (spec and not verify) or (
                    not spec and len(verify) == len(shapes[d])):
                raise AssertionError(f"spec={spec}: K3 did not launch on "
                                     f"the {d}: {shapes[d]}")
            if warmup == "sync":
                plane = eng.compile_plane
                if plane.stalls or plane.replays != eng.steps_run:
                    raise AssertionError(
                        f"spec={spec}: {plane.replays} replays and "
                        f"{plane.stalls} stalls in {eng.steps_run} steps")
        for i in range(len(prompts)):
            if not (np.array_equal(outs["cpu"][i], outs["card"][i])
                    and np.array_equal(outs["graph"][i], outs["card"][i])
                    and np.array_equal(outs["card"][i], dense[i])):
                raise AssertionError(
                    f"spec={spec} request {i}: card {outs['card'][i]}, "
                    f"graph {outs['graph'][i]}, CPU {outs['cpu'][i]}, "
                    f"dense generate {dense[i]}")
        res[spec] = dict(
            launches=shapes, steps=eng.steps_run, spec_steps=eng.spec_steps,
            replays=eng.compile_plane.replays,
            tokens=int(sum(len(o) for o in outs["card"].values())))
    return res


def llm_main_path(model, prompts, new, spec: int, backend: str = "auto",
                  warmup: str = "off"):
    """One full-width engine run; K3's counts are reset just before and
    read just after it.  A graph run (``warmup="sync"``) must replay once
    per step and never stall."""
    from synapseml_tpu_torch.kernels import launches as L
    from synapseml_tpu_torch.models.llm import SlotEngine
    eng = SlotEngine(model, n_slots=16, spec_draft_len=spec,
                     attention_backend=backend, warmup=warmup,
                     device=model.device)
    L.reset()
    r = drive(eng, prompts, new)
    shapes = L.shapes("paged_decode_attention")
    vocab = model.cfg.vocab_size
    for i, n in enumerate(new):
        o = r["outs"].get(i)
        if o is None or len(o) != n or o.min() < 0 or o.max() >= vocab:
            raise AssertionError(f"spec={spec}: request {i} gave {o}")
    steps = np.asarray(r["step_s"])
    plane = {}
    if eng.compile_plane is not None:
        plane = eng.compile_plane.snapshot()
        if plane["stalls"] or plane["replays"] != eng.steps_run:
            raise AssertionError(f"spec={spec}: {plane['replays']} replays "
                                 f"and {plane['stalls']} stalls in "
                                 f"{eng.steps_run} steps")
    return dict(
        backend=eng.attention_backend, spec=spec, warmup=warmup,
        warmup_s=plane.get("warmup_seconds"),
        pool_bytes=plane.get("pool_bytes"), replays=plane.get("replays"),
        stalls=plane.get("stalls"), requests=len(prompts),
        steps=eng.steps_run, spec_steps=eng.spec_steps,
        acceptance=eng.spec_acceptance_rate,
        decode_tokens=r["step_tokens"],
        decode_tokens_per_s=r["step_tokens"] / float(steps.sum()),
        mean_step_ms=float(steps.mean() * 1e3),
        ttft_p50_ms=float(np.median(r["ttft_s"]) * 1e3),
        ttft_p90_ms=float(np.percentile(r["ttft_s"], 90) * 1e3),
        wall_s=r["wall_s"],
        # decode K/V bytes per committed token: the reference's tile
        # ledger, and the exact live spans the CUDA kernel reads
        ledger_bytes_per_token=eng.decode_attn_bytes / max(
            1, r["step_tokens"]),
        live_bytes_per_token=eng.decode_attn_live_bytes / max(
            1, r["step_tokens"]),
        launches=shapes), r["outs"]


def profile_decode(model, prompts, new, warmup: str = "off",
                   steps: int = 12) -> dict:
    """Device time by kernel over a window of full-width decode steps
    (16 slots busy, after 3 warm steps), from ``torch.profiler``, and the
    host time inside PyTorch's operators and the CUDA runtime's calls
    (self time; the rest of the wall is Python and the profiler)."""
    from torch.profiler import ProfilerActivity, profile

    from synapseml_tpu_torch.models.llm import SlotEngine
    eng = SlotEngine(model, n_slots=16, warmup=warmup, device=model.device)
    for p, n in list(zip(prompts, new))[:16]:
        eng.admit(p, n)
    for _ in range(3):
        eng.step()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    kern.sort(key=lambda e: -e.self_device_time_total)
    total = sum(e.self_device_time_total for e in kern) / 1e6
    # the host side: device kernels launched per step, and the operators
    # that spend the most host time themselves
    host = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CPU
            and e.self_cpu_time_total > 0]
    host.sort(key=lambda e: -e.self_cpu_time_total)
    # K3's kernels (split and combine at bf16)
    k3_ms = sum(e.self_device_time_total for e in kern
                if "paged_" in e.key) / 1e3
    runtime = [e for e in host if e.key.startswith("cuda")]
    return dict(warmup=warmup, steps=steps, wall_s=wall,
                step_ms=wall / steps * 1e3, kernel_s=total,
                busy_share=total / wall, k3_ms=k3_ms,
                launches_per_step=sum(e.count for e in kern) / steps,
                graph_launches_per_step=sum(
                    e.count for e in host if e.key == "cudaGraphLaunch")
                / steps,
                op_host_ms_per_step=sum(e.self_cpu_time_total for e in host)
                / 1e3 / steps,
                runtime_host_ms_per_step=sum(
                    e.self_cpu_time_total for e in runtime) / 1e3 / steps,
                top=[[e.key[:60], e.self_device_time_total / 1e3, e.count]
                     for e in kern[:10]],
                top_host=[[e.key[:40], e.self_cpu_time_total / 1e3, e.count]
                          for e in host[:10]])


def eval_parts(bst, Xv, yv, dev, reps: int = 20) -> dict:
    """One validation step's parts on the card, as ``booster.train``
    runs them: the last tree's traversal of the validation bins and the
    device AUC, each in device ms (the host's dispatch hidden), and the
    whole step (traversal, add, AUC, its one copy to the host) on the
    host's clock."""
    from synapseml_tpu_torch.models.gbdt import binning as BN
    from synapseml_tpu_torch.models.gbdt import booster as BO
    from synapseml_tpu_torch.models.gbdt.metrics import auc_t
    bins_v = BN.bin_features(Xv, bst.bin_mapper, dev)
    tree = type(bst.trees[-1])(*[torch.as_tensor(a).to(dev)
                                 for a in bst.trees[-1]])
    depth = max(2, bst.config.num_leaves)
    yv_t = torch.as_tensor(yv, device=dev)
    mv = BO.predict_binned_tree(bins_v, tree, depth)

    def traverse():
        return BO.predict_binned_tree(bins_v, tree, depth)

    def step():
        return float(auc_t(yv_t, mv + traverse()))

    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        step()
    host_ms = (time.perf_counter() - t0) / reps * 1e3
    return dict(eval_traverse_ms=cuda_ms(traverse),
                eval_auc_ms=cuda_ms(lambda: auc_t(yv_t, mv)),
                eval_step_host_ms=host_ms)


def breadth2(seed: int, N: int, F: int, iters: int, check_path,
             device: str = "cuda") -> None:
    """Phase 12: validation, checkpoint resume, categorical features, EFB
    and monotone constraints at full width, each fit through
    ``fit_path``; ``check_path(name, result)`` holds each run's launches
    to its phase-2 shapes.  Raises on any failed check."""
    FO, FB = F + OH_BLOCKS * OH_LEVELS, F + OH_BLOCKS
    r12 = np.random.default_rng(seed + 12)
    X = r12.normal(size=(N, F)).astype(np.float32)
    y = gbdt_labels(r12, X)
    Xh = r12.normal(size=(100_000, F)).astype(np.float32)
    yh = gbdt_labels(r12, Xh)
    # 12a. a 100k-row validation set with early stopping, then the same
    # fit without it for as many iterations
    Xv = r12.normal(size=(100_000, F)).astype(np.float32)
    yv = gbdt_labels(r12, Xv)
    vkw = dict(learningRate=0.5, metric="auc")
    r, gbdt = fit_path(X, y, Xh, yh, 100, device=device, valid=(Xv, yv),
                       earlyStoppingRound=5, **vkw)
    check_path("validation", r)
    hist, best = gbdt._eval_history, gbdt.booster.best_iteration
    if len(hist) != r["iterations"] or not 0 <= best < len(hist):
        raise AssertionError(f"validation: {len(hist)} evaluations in "
                             f"{r['iterations']} iterations, best {best}")
    r0, _ = fit_path(X, y, Xh, yh, r["iterations"], device=device, **vkw)
    r.update(best_iteration=best, best_valid_auc=hist[best].value,
             evaluations=len(hist), stopped_early=len(hist) < 100,
             eval_s_per_iter=r["eval_s"] / r["iterations"],
             s_per_iter_without_validation=r0["s_per_iter"])
    if device == "cuda":
        r.update(eval_parts(gbdt.booster, Xv, yv, torch.device(device)))
    log(f"fit validation 100k rows, earlyStoppingRound=5: {json.dumps(r)}")
    del Xv

    # 12b. checkpoints every 5 iterations: stopped after 5, resumed to 10,
    # against 10 uninterrupted
    ck = os.path.join(CKPT_ROOT, "phase12")
    shutil.rmtree(ck, ignore_errors=True)
    r_full, gb_full = fit_path(X, y, Xh, yh, 10, device=device)
    fit_path(X, y, Xh, yh, 5, device=device, checkpointDir=ck,
             checkpointInterval=5)
    r, gb_res = fit_path(X, y, Xh, yh, 10, device=device, checkpointDir=ck,
                         checkpointInterval=5)
    shutil.rmtree(ck)
    check_path("resumed", r)
    same = gb_res.booster.num_trees == 10 and all(
        np.array_equal(getattr(a, f), getattr(b, f))
        for a, b in zip(gb_full.booster.trees, gb_res.booster.trees)
        for f in ("split_feature", "split_bin", "threshold", "leaf_value"))
    if not same or r["auc"] != r_full["auc"]:
        raise AssertionError("resumed: the trees differ from the "
                             "uninterrupted fit's")
    r["uninterrupted_auc"] = r_full["auc"]
    log(f"fit resumed after 5 of 10 iterations: trees equal to the "
        f"uninterrupted fit's; {json.dumps(r)}")

    # 12c. 4 categorical columns of 100 levels
    Xc, extra = with_categorical(r12, X)
    Xhc, extra_h = with_categorical(r12, Xh)
    r, gbdt = fit_path(Xc, gbdt_labels(r12, X, extra), Xhc,
                       gbdt_labels(r12, Xh, extra_h), iters, device=device,
                       categoricalSlotIndexes=list(range(F, F + CAT_COLS)))
    check_path("categorical", r)
    if r["auc"] <= 0.8 or not gbdt.booster.bin_mapper.has_categorical:
        raise AssertionError(f"categorical: holdout AUC {r['auc']}")
    log(f"fit categorical 4 x 100 levels: {json.dumps(r)}")
    del Xc, Xhc

    # 12d. 8 one-hot blocks of 32 levels: EFB against unbundled, both at
    # two-level off, held to the JAX package's EFB property.  At half the
    # rows (two-level is off, so no launch shape depends on them), to
    # make room for phase 29: four fits bin 284 columns each
    Xd = X[:len(X) // 2]
    log(f"phase 12d at {len(Xd)} rows (cut from {len(X)})")
    Xo, extra = with_onehot(r12, Xd)
    Xho, extra_h = with_onehot(r12, Xh)
    yo, yho = gbdt_labels(r12, Xd, extra), gbdt_labels(r12, Xh, extra_h)
    for policy in ("depthwise", "lossguide"):
        fits = {}
        for efb in (True, False):
            name = f"{'EFB' if efb else 'unbundled'} {policy}"
            r, gbdt = fit_path(Xo, yo, Xho, yho, iters, device=device,
                               growthPolicy=policy, enableBundle=efb,
                               passThroughArgs={"two_level_hist": "off"})
            check_path(name, r)
            fits[efb] = (r, gbdt.booster)
        (re_, be), (ru, bu) = fits[True], fits[False]
        # K2's waves over the bundled columns (F=FB is no other fit's
        # width), each routing through its split features' ranges, and
        # the splits on features that share a bundle, whose ranges are
        # not their column's full range
        bundled = sum(n for k, n in re_["shapes"].items()
                      if k.startswith(f"route_and_hist[F={FB},")
                      and ",S=1," not in k)
        shares = np.bincount(be.bundler.bundle_of)[be.bundler.bundle_of] > 1
        shared_splits = sum(int(shares[t.split_feature[t.split_feature >= 0]]
                                .sum()) for t in be.trees)
        feat_equal = all(np.array_equal(a.split_feature, b.split_feature)
                         for a, b in zip(be.trees, bu.trees))
        bin_diff = max(int(np.abs(a.split_bin - b.split_bin).max())
                       for a, b in zip(be.trees, bu.trees))
        margin_diff = float(np.abs(be.predict_margin(Xho[:20_000])
                                   - bu.predict_margin(Xho[:20_000])).max())
        out = dict(bundles=be.bundler.num_bundles, features=FO,
                   s_per_iter=re_["s_per_iter"],
                   unbundled_s_per_iter=ru["s_per_iter"],
                   k2_bundled_waves=bundled,
                   splits_in_shared_bundles=shared_splits, auc=re_["auc"],
                   unbundled_auc=ru["auc"], split_feature_equal=feat_equal,
                   split_bin_max_diff=bin_diff, margin_max_diff=margin_diff,
                   trees_equal=all(
                       np.array_equal(getattr(a, f), getattr(b, f))
                       for a, b in zip(be.trees, bu.trees)
                       for f in ("split_feature", "split_bin",
                                 "leaf_value")),
                   launches=re_["shapes"], unbundled_launches=ru["shapes"])
        if (out["bundles"] != FB or not feat_equal or bin_diff > 1
                or margin_diff > 1e-3
                or shared_splits == 0
                or (policy == "depthwise" and bundled == 0)):
            raise AssertionError(f"EFB {policy}: {out}")
        log(f"fit EFB {policy} against unbundled, {FO} features: "
            f"{json.dumps(out)}")
    del Xo, Xho, yo, yho, Xd

    # 12e. monotone constraints on x0 (up), x1 (down), x2 (up): sweeps of
    # each from 1,000 holdout rows, against the unconstrained 10-iteration
    # fit of 12b
    base = Xh[:1000]
    fd = [(f, d) for f, d in enumerate(MONO) if d]
    log(f"sweep violations, unconstrained fit: "
        f"{json.dumps(sweep_violations(gb_full.booster, base, fd))}")
    for method in ("basic", "intermediate", "advanced"):
        r, gbdt = fit_path(X, y, Xh, yh, iters, device=device,
                           monotoneConstraints=MONO,
                           monotoneConstraintsMethod=method)
        check_path(f"monotone {method}", r)
        r["violations"] = sweep_violations(gbdt.booster, base, fd)
        if any(n for n, _ in r["violations"].values()) or r["auc"] <= 0.8:
            raise AssertionError(f"monotone {method}: {r}")
        log(f"fit monotone {method}: {json.dumps(r)}")
    del X, y, Xh, yh, gb_full, gb_res


def rank_data(rng, Q: int, F: int, max_group: int = RANK_MAXG):
    """Q queries of 1..max_group rows (uniform), F normal features and
    relevance 0-4 from a noisy linear score (the ranking fixture's
    concept, tests/test_benchmark_fixtures.py): → (X, y, group sizes)."""
    sizes = rng.integers(1, max_group + 1, Q)
    n = int(sizes.sum())
    X = rng.normal(size=(n, F)).astype(np.float32)
    rel = np.clip(X[:, 0] + 0.5 * X[:, 1] + rng.normal(scale=0.3, size=n),
                  0, None)
    return X, np.digitize(rel, [0.5, 1.2, 2.0, 2.8]).astype(np.float64), \
        sizes


def groups_to(sizes, n: int):
    """The leading group sizes that cover n rows, the last one cut."""
    c = np.cumsum(sizes)
    k = int(np.searchsorted(c, n)) + 1
    out = sizes[:k].copy()
    out[-1] -= int(c[k - 1]) - n
    return out


def ranker_path(X, y, sizes, Xv, yv, vsizes, iters, device="cuda",
                **params):
    """``GBDTRanker(**params).fit`` over queries ``sizes`` plus validation
    queries ``vsizes`` flagged by ``validationIndicatorCol`` (metric
    ndcg), query ids shuffled across the rows so that the estimator
    sorts them; launch counts reset just before the fit and read just
    after.  → (result, the model)."""
    from synapseml_tpu_torch.core import Dataset
    from synapseml_tpu_torch.kernels import launches as L
    from synapseml_tpu_torch.models.gbdt.estimators import GBDTRanker
    qid = np.repeat(np.arange(len(sizes) + len(vsizes)),
                    np.concatenate([sizes, vsizes]))
    feats = np.concatenate([X, Xv])
    ds = Dataset({"features": list(feats), "label": np.concatenate([y, yv]),
                  "query": qid, "isValid": qid >= len(sizes)})
    t0 = time.perf_counter()
    ds.to_numpy(["features"])
    to_numpy_s = time.perf_counter() - t0
    del feats
    L.reset()
    t0 = time.perf_counter()
    model = GBDTRanker(numIterations=iters, device=device, metric="ndcg",
                       validationIndicatorCol="isValid", **params).fit(ds)
    if device == "cuda":
        torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    m = model.training_measures
    r = dict(fit_s=fit_s, train_s=m.training_s,
             s_per_iter=m.seconds_per_iteration(), eval_s=m.eval_s,
             binning_s=m.binning_s, iterations=m.iterations,
             to_numpy_s=to_numpy_s, rows=len(X), valid_rows=len(Xv),
             queries=len(sizes), launches={
                 k: L.total(k) for k in ("build_hist_nodes",
                                         "route_and_hist")},
             shapes=dict(L.BY_SHAPE),
             two_level=model.booster.config.two_level_hist,
             valid_ndcg=[e.value for e in model._eval_history])
    return r, model


def lambdarank_ms(sizes, y, dev, reps: int = 5) -> float:
    """Device ms of one evaluation of the fit's lambdarank objective
    (float64, rounded to f32) at the groups ``sizes``."""
    from synapseml_tpu_torch.models.gbdt.booster import _grad_hess
    from synapseml_tpu_torch.models.gbdt.ranking import (
        build_group_index, make_lambdarank_objective)
    q, m = build_group_index(sizes)
    n = len(y)
    fn = make_lambdarank_objective(q, m, n, device=dev)
    rng = np.random.default_rng(0)
    s = torch.as_tensor(rng.normal(size=n).astype(np.float32), device=dev)
    lab = torch.as_tensor(y.astype(np.float32), device=dev)
    w = torch.ones(n, dtype=torch.float32, device=dev)
    return cuda_ms(lambda: _grad_hess(fn, s, lab, w), iters=reps)


def breadth3(seed: int, iters: int, check_path, models, n_queries=RANK_Q,
             n_valid_queries=RANK_VQ, n_stream=HIGGS_N, n_mem=1_000_000,
             device: str = "cuda") -> dict:
    """Phase 13: the ranker at MSLR-WEB10K's shape, a streamed fit at
    HIGGS's shape, LightGBM text export and import, TreeSHAP.  ``models``
    holds phase 4's model stage, its holdout (``"default"``, ``"Xh"``) and
    phase 10b's three-class model (``"three"``).  Raises on any failed
    check.  → {"ranker": 13a's validation NDCG@10 and rows}."""
    import tracemalloc

    from synapseml_tpu_torch.core import Dataset
    from synapseml_tpu_torch.io.colstore import ChunkedColumnSource, \
        write_matrix
    from synapseml_tpu_torch.kernels import launches as L
    from synapseml_tpu_torch.models.gbdt.booster import BoostingConfig, train
    from synapseml_tpu_torch.models.gbdt.estimators import (
        GBDTClassificationModel, GBDTRankerModel)
    from synapseml_tpu_torch.models.gbdt.metrics import auc, ndcg_at
    dev = torch.device(device)
    r13 = np.random.default_rng(seed + 13)

    # 13a. the ranker at MSLR-WEB10K's shape
    X, y, sizes = rank_data(r13, n_queries, RANK_F)
    Xv, yv, vsizes = rank_data(r13, n_valid_queries, RANK_F)
    r, ranker = ranker_path(X, y, sizes, Xv, yv, vsizes, iters,
                            device=device, numLeaves=31, maxBin=255)
    check_path("ranker", r)
    ndcg10 = ndcg_at(10)
    got = ndcg10(yv, ranker.booster.predict_margin(Xv), vsizes)
    rand = ndcg10(yv, r13.normal(size=len(yv)), vsizes)
    r.update(valid_ndcg10=got, random_ndcg10=rand,
             objective_ms=(lambdarank_ms(sizes, y, dev) if device == "cuda"
                           else None),
             max_group=int(sizes.max()),
             groups_past_128=int((sizes > 128).sum()))
    log(f"fit ranker {len(X)} rows x {RANK_F}, {len(sizes)} queries: "
        f"{json.dumps(r)} | {gpu_line() if device == 'cuda' else 'cpu'}")
    if not got > rand + 0.1:
        raise AssertionError(f"ranker: validation ndcg@10 {got} against "
                             f"random {rand}")
    ranker_out = dict(valid_ndcg10=float(got), rows=len(X))
    del X, y

    # 13b. a streamed fit at HIGGS's shape, from an SMLC file
    os.makedirs(os.path.join(os.path.dirname(CKPT_ROOT)), exist_ok=True)
    path = os.path.join(os.path.dirname(CKPT_ROOT), "phase13_stream.smlc")
    F = 28
    t0 = time.perf_counter()
    Z = r13.normal(size=(n_stream, F + 1)).astype(np.float32)
    Z[:, F] = gbdt_labels(r13, Z[:, :F])
    write_matrix(path, Z)
    raw = n_stream * F * 4
    del Z
    write_s = time.perf_counter() - t0
    Xh = r13.normal(size=(100_000, F)).astype(np.float32)
    yh = gbdt_labels(r13, Xh)
    cfg = BoostingConfig(objective="binary", num_iterations=iters)
    runs = {}
    for traced in (False, True):
        src = ChunkedColumnSource(path, label_col=F)
        L.reset()
        if traced:
            tracemalloc.start()
        t0 = time.perf_counter()
        try:
            b, _ = train(src, None, cfg, device=device)
            if device == "cuda":
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            peak = tracemalloc.get_traced_memory()[1] if traced else None
        finally:
            if traced:
                tracemalloc.stop()
        m = b.measures
        runs[traced] = dict(wall_s=wall, ingest_s=m.binning_s,
                            prep_s=m.data_prep_s, train_s=m.training_s,
                            s_per_iter=m.seconds_per_iteration(),
                            holdout_auc=float(auc(yh, b.predict_margin(Xh))),
                            shapes=dict(L.BY_SHAPE),
                            two_level=b.config.two_level_hist,
                            traced_peak_bytes=peak)
    r = dict(runs[False], rows=n_stream, features=F, raw_bytes=raw,
             write_s=write_s, traced_run=runs[True],
             peak_share=runs[True]["traced_peak_bytes"] / raw)
    check_path("streamed", r)
    log(f"fit streamed {n_stream} x {F} from {os.path.basename(path)}: "
        f"{json.dumps(r)} | {gpu_line() if device == 'cuda' else 'cpu'}")
    os.remove(path)
    if r["holdout_auc"] <= 0.8 or r["peak_share"] >= 0.25:
        raise AssertionError(f"streamed: AUC {r['holdout_auc']}, traced "
                             f"peak {r['peak_share']} of the raw bytes")
    # phase 4's 1M rows from a file: the in-memory fit's trees
    drng = np.random.default_rng(seed)
    X1 = drng.normal(size=(n_mem, F)).astype(np.float32)
    y1 = gbdt_labels(drng, X1)
    path1 = os.path.join(os.path.dirname(CKPT_ROOT), "phase13_1m.smlc")
    write_matrix(path1, np.concatenate([X1, y1[:, None].astype(np.float32)],
                                       axis=1))
    bs, _ = train(ChunkedColumnSource(path1, label_col=F, chunk_rows=65_521),
                  None, cfg, device=device)
    bm, _ = train(X1, y1, cfg, device=device)
    os.remove(path1)
    same = bs.num_trees == bm.num_trees and all(
        np.array_equal(a.split_feature, c.split_feature)
        and np.array_equal(a.split_bin, c.split_bin)
        for a, c in zip(bs.trees, bm.trees))
    diff = float(np.abs(bs.predict_margin(Xh) - bm.predict_margin(Xh)).max())
    log(f"streamed {n_mem} rows against in memory: trees equal {same}, "
        f"margins within {diff:.3g}")
    if not same or diff > 1e-5:
        raise AssertionError(f"streamed 1M: trees equal {same}, margins "
                             f"{diff}")
    del X1, y1

    # 13c. LightGBM text: export, import on the card, re-export
    stage = models["default"]
    Xh4 = models["Xh"]
    out = {}
    for name, model, rows in (("default", stage, Xh4),
                              ("three-class", models["three"], Xh4),
                              ("ranker", ranker, Xv)):
        t0 = time.perf_counter()
        text = model.get_model_string()
        cls = (GBDTRankerModel if name == "ranker"
               else GBDTClassificationModel)
        back = cls.load_native_model_from_string(text, device=device)
        io_s = time.perf_counter() - t0
        again = back.get_model_string()
        fixed = cls.load_native_model_from_string(
            again, device=device).get_model_string() == again
        md = float(np.abs(back.booster.predict_margin(rows)
                          - model.booster.predict_margin(rows)).max())
        out[name] = dict(bytes=len(text), trees=model.booster.num_trees,
                         margin_max_diff=md, export_import_s=io_s,
                         reexport_fixed_point=fixed,
                         reexport_equals_first=again == text)
        if md > 1e-6 or not fixed:
            raise AssertionError(f"LightGBM text, {name}: {out[name]}")
    log(f"LightGBM text round trips on the card: {json.dumps(out)}")

    # 13d. TreeSHAP through featuresShapCol, against the card's margins
    out = {}
    for name, model, rows in (("default", stage, Xh4[:1000]),
                              ("ranker", ranker, Xv[:200])):
        model.set("featuresShapCol", "shap")
        t0 = time.perf_counter()
        res = model.transform(Dataset({"features": list(rows)}))
        wall = time.perf_counter() - t0
        model.set("featuresShapCol", "")
        shap = np.stack(res["shap"])
        margin = (np.stack(res["rawPrediction"])[:, 1] if name == "default"
                  else np.asarray(res["prediction"]))
        err = float(np.abs(shap.sum(1) - margin).max())
        out[name] = dict(rows=len(rows), trees=model.booster.num_trees,
                         transform_s=wall,
                         s_per_1000_rows=wall / len(rows) * 1000,
                         additivity_max_err=err)
        if err > 1e-4 or shap.shape != (len(rows), rows.shape[1] + 1):
            raise AssertionError(f"TreeSHAP, {name}: {out[name]}")
    log(f"TreeSHAP (featuresShapCol, host) against the card's margins: "
        f"{json.dumps(out)}")
    return {"ranker": ranker_out}


# --------------------------------------------------------------------------
# phases 14 and 15: the DL estimators (plain PyTorch; no kernel of the port)

class ieee_f32:
    """Within: float32 matmuls and cuDNN convolutions in IEEE f32 (PyTorch
    lets cuDNN convolutions take TF32 products by default), so an f32
    card-against-CPU check compares f32 with f32."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.saved


def synchronize(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _max_diff(a: dict, b: dict) -> float:
    return max(float((a[k].float().cpu() - b[k].float().cpu()).abs().max())
               for k in a)


def dl_text_card_vs_cpu(dev, seed: int, dtype=torch.float32,
                        steps: int = 3, num_experts: int = 0) -> dict:
    """The tiny ``TextEncoder`` (dropout 0; with ``num_experts``, MoE FFNs
    on every other block): ``steps`` adamw steps (clip 1.0,
    warmup-cosine) on ``dev`` and on the CPU from the same seeded weights
    and batches → the largest difference of the losses, the parameters
    and the eval logits after the steps."""
    from synapseml_tpu_torch.models.dl import (DLTrainer, OptimizerConfig,
                                               TextEncoder,
                                               TransformerConfig)
    rng = np.random.default_rng(seed)
    batches = []
    for _ in range(steps):
        ids = rng.integers(0, 1024, (16, 32)).astype(np.int32)
        mask = np.ones((16, 32), bool)
        mask[::4, 20:] = False
        batches.append((ids, mask, rng.integers(0, 2, 16).astype(np.int32)))
    cfg = TransformerConfig.tiny(dtype=dtype, dropout_rate=0.0,
                                 num_experts=num_experts)
    runs = {}
    for d in (dev, torch.device("cpu")):
        model = TextEncoder(cfg, device=d, seed=None)
        tr = DLTrainer(model, OptimizerConfig(
            learning_rate=1e-3, schedule="cosine", warmup_steps=1,
            total_steps=steps, grad_clip_norm=1.0), d)
        state = tr.init_state(seed)
        step = tr.train_step()
        losses = []
        for ids, mask, lab in batches:
            bi, bm, bl = tr.shard_batch((ids, mask, lab))
            state, m = step(state, (bi, bm), bl, seed)
            losses.append(m["loss"])
        logits = tr.eval_step()(state, tr.shard_batch(batches[0][:2]))
        runs[d.type] = (torch.stack(losses), logits, model.state_dict())
    (lc, gc, pc), (lh, gh, ph) = runs[dev.type], runs["cpu"]
    return dict(loss=float((lc.cpu() - lh).abs().max()),
                logits=float((gc.float().cpu() - gh.float()).abs().max()),
                params=_max_diff(pc, ph))


def make_words(rng, n: int):
    """``n`` distinct lowercase words of 3-10 letters."""
    words = set()
    while len(words) < n:
        lens = rng.integers(3, 11, n)
        letters = rng.integers(0, 26, (n, 10))
        for w, k in zip(letters, lens):
            words.add("".join(chr(97 + c) for c in w[:k]))
    return sorted(words)[:n]


def text_corpus(rng, words, n: int, n_markers: int = 10,
                length=(100, 140)):
    """``n`` texts of random words from ``words[20:]``, each with
    ``n_markers`` of its class's 10 marker words (``words[:10]`` for class
    0, ``words[10:20]`` for class 1) at random places in the first 120
    words → (texts, labels)."""
    labels = rng.integers(0, 2, n)
    body = words[20:]
    texts = []
    for y in labels:
        k = int(rng.integers(*length))
        toks = [body[i] for i in rng.integers(0, len(body), k)]
        for pos, m in zip(rng.choice(min(k, 120), n_markers, replace=False),
                          rng.integers(0, 10, n_markers)):
            toks[pos] = words[10 * y + m]
        texts.append(" ".join(toks))
    return texts, labels.astype(np.float64)


def train_windows(steps: dict, batch_size: int, n_steps: int = 20,
                  windows: int = 3, warmup: int = 3) -> dict:
    """Samples/s of each train step of ``steps`` ({name: fn()}, each one
    update that returns its loss on the device): ``warmup`` steps each,
    then ``windows`` rounds in which every step runs a window of
    ``n_steps`` in turns; a window ends in a read of its last loss (a host
    barrier).  → {name: {"sps": median, "windows": [...]}}."""
    for fn in steps.values():
        for _ in range(warmup):
            loss = fn()
        float(loss)
    rates = {k: [] for k in steps}
    for _ in range(windows):
        for name, fn in steps.items():
            t0 = time.perf_counter()
            for _ in range(n_steps):
                loss = fn()
            float(loss)
            rates[name].append(n_steps * batch_size
                               / (time.perf_counter() - t0))
    return {k: {"sps": sorted(v)[len(v) // 2], "windows": v}
            for k, v in rates.items()}


#: kernel-name fragments → the category a DL profile sums them under
#: (first match wins)
KERNEL_KINDS = (("conv", ("cudnn", "conv", "implicit_gemm")),
                ("gemm", ("nvjet", "gemm", "cutlass", "xmma", "cublas")),
                ("batch_norm", ("batch_norm",)),
                ("softmax", ("softmax",)),
                ("dropout_rng", ("distribution", "philox", "uniform")),
                ("optimizer", ("multi_tensor_apply",)),
                ("reduce", ("reduce_kernel",)),
                ("elementwise", ("elementwise",)))


def kernel_kind(name: str) -> str:
    low = name.lower()
    for kind, frags in KERNEL_KINDS:
        if any(f in low for f in frags):
            return kind
    return "other"


def profile_steps(fn, n: int = 5) -> dict:
    """Device time by kernel over ``n`` train steps (after the caller's
    warm-up), from ``torch.profiler``: busy share of the wall, the device
    ms a step by kernel kind and the top kernels.  The optimizer's
    annotation range is not a kernel and is left out."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if torch.cuda.is_available() else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            loss = fn()
        float(loss)
        wall = time.perf_counter() - t0
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0
            and not e.key.startswith(("Optimizer.", "ProfilerStep"))]
    kern.sort(key=lambda e: -e.self_device_time_total)
    total = sum(e.self_device_time_total for e in kern) / 1e6
    kinds: dict = {}
    for e in kern:
        k = kernel_kind(e.key)
        kinds[k] = kinds.get(k, 0.0) + e.self_device_time_total / 1e3 / n
    return dict(step_ms=wall / n * 1e3, kernel_ms_per_step=total / n * 1e3,
                busy_share=total / wall,
                host_ms_per_step=sum(
                    e.self_cpu_time_total for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CPU)
                / 1e3 / n,
                launches_per_step=sum(e.count for e in kern) / n,
                ms_by_kind=dict(sorted(kinds.items(), key=lambda kv: -kv[1])),
                top=[[e.key[:90], e.self_device_time_total / 1e3 / n,
                      e.count // n] for e in kern[:12]])


def _step_fn(trainer, state, inputs, labels, seed: int):
    step = trainer.train_step()
    box = [state]

    def run():
        box[0], m = step(box[0], inputs, labels, seed)
        return m["loss"]
    return run


def dl_text(seed: int, dev, n_train: int = 8192, n_hold: int = 2048,
            n_words: int = 45_000, model_size: str = "base",
            vocab: int = 30522, batch: int = 128, seq: int = 128,
            epochs: int = 2, n_steps: int = 20, windows: int = 3) -> dict:
    """Phase 14.  Raises on a failed check."""
    from synapseml_tpu_torch.core import Dataset, Pipeline
    from synapseml_tpu_torch.models.dl import (DeepTextClassifier, DLTrainer,
                                               OptimizerConfig, TextEncoder,
                                               resolve_precision)
    out = {}
    # 14a. the tiny encoder at f32, three steps on the card against the CPU
    with ieee_f32():
        d = dl_text_card_vs_cpu(dev, seed)
    if max(d.values()) > 1e-4:
        raise AssertionError(f"text card vs CPU at f32: {d}")
    out["card_vs_cpu_f32"] = d
    out["card_vs_cpu_bf16"] = dl_text_card_vs_cpu(dev, seed, torch.bfloat16)
    log(f"phase 14a: text card vs CPU, f32 {d} (limit 1e-4); bf16 "
        f"{out['card_vs_cpu_bf16']} (reported)")

    # 14b. the main path: fit then transform through a Pipeline
    rng = np.random.default_rng(seed + 14)
    words = make_words(rng, n_words)
    texts, labels = text_corpus(rng, words, n_train + n_hold)
    train = Dataset({"text": texts[:n_train], "label": labels[:n_train]})
    hold = Dataset({"text": texts[n_train:], "label": labels[n_train:]})
    est = DeepTextClassifier(modelSize=model_size, vocabSize=vocab,
                             maxTokenLen=seq, batchSize=batch,
                             precision="bf16", maxEpochs=epochs, seed=seed,
                             device=str(dev))
    t0 = time.perf_counter()
    pm = Pipeline([est]).fit(train)
    synchronize(dev)
    fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = pm.transform(hold)
    transform_s = time.perf_counter() - t0
    acc = float((res["prediction"] == hold["label"]).mean())
    model = pm.get_or_default("stages")[0]
    proba = np.stack(list(res["probability"]))
    if not (np.isfinite(proba).all() and proba.shape == (n_hold, 2)):
        raise AssertionError("text transform: non-finite or misshapen "
                             "probabilities")
    out["main_path"] = dict(
        fit_s=fit_s, transform_s=transform_s, holdout_accuracy=acc,
        steps=-(-n_train // batch) * epochs,
        history=model.modelPayload["history"],
        vocab_words=len(words))
    log(f"phase 14b: text main path {json.dumps(out['main_path'])}")
    if acc <= 0.8:
        raise AssertionError(f"text holdout accuracy {acc}")

    # 14c. timed windows, bf16 and bf16_grad in turns; 14d. a profile
    wrng = np.random.default_rng(seed)
    ids = wrng.integers(0, vocab, (batch, seq)).astype(np.int32)
    mask = np.ones((batch, seq), bool)
    lab = wrng.integers(0, 2, batch).astype(np.int32)
    steps, n_params = {}, 0
    for prec in ("bf16", "bf16_grad"):
        pol = resolve_precision(prec)
        # bench.py's model: the estimator's config at this size (for
        # "base", TransformerConfig.bert_base(max_len=seq))
        cfg = dataclasses.replace(est._model_config(2),
                                  dtype=pol.compute_dtype)
        tr = DLTrainer(TextEncoder(cfg, device=dev, seed=None),
                       OptimizerConfig(learning_rate=2e-5), dev,
                       precision=pol)
        state = tr.init_state(seed)
        n_params = sum(p.numel() for p in tr.model.parameters())
        bi, bm, bl = tr.shard_batch((ids, mask, lab))
        steps[prec] = _step_fn(tr, state, (bi, bm), bl, seed)
    win = train_windows(steps, batch, n_steps, windows)
    flops = 6.0 * n_params * seq
    for prec, r in win.items():
        r.update(step_ms=batch / r["sps"] * 1e3,
                 mfu=r["sps"] * flops / PEAK_BF16_S)
    out["windows"] = dict(n_params=n_params, flops_per_sample=flops,
                          **win)
    log(f"phase 14c: {model_size} fine-tune, batch {batch}, seq {seq}: "
        f"{json.dumps(out['windows'])}")
    out["profile"] = prof = profile_steps(steps["bf16"])
    # the profiler slows the host; the device's share of an unprofiled
    # step is its kernel time over the window's step time
    prof["busy_share_of_window_step"] = (prof["kernel_ms_per_step"]
                                         / win["bf16"]["step_ms"])
    log(f"phase 14d: profile bf16 {json.dumps(prof)}")
    return out


def conv_flops(model, size: int) -> float:
    """Forward flops of one ``size``² image counted from the shapes:
    2·kh·kw·Cin·Cout·Ho·Wo per convolution and 2·in·out for the head
    (BatchNorm, ReLU, pooling and adds are not counted)."""
    from synapseml_tpu_torch.models.dl.resnet import Conv
    total = [0.0]

    def hook(mod, inp, out):
        kh, kw, cin, cout = mod.kernel.shape
        total[0] += 2.0 * kh * kw * cin * cout * out.shape[2] * out.shape[3]

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, Conv)]
    with torch.no_grad():
        model(torch.zeros((1, size, size, 3), device=model.device))
    for h in hooks:
        h.remove()
    k = model.head.kernel.shape
    return total[0] + 2.0 * k[0] * k[1]


def vision_images(rng, n: int, size: int):
    """``n`` images of uniform noise in [0, 0.5); class 1 brightens the
    top-left quarter by 0.5, class 0 the bottom-right (values stay below 2,
    so the estimator does not rescale by 255) → (images, labels)."""
    labels = rng.integers(0, 2, n)
    imgs = rng.random((n, size, size, 3), dtype=np.float32) * 0.5
    q = size // 4
    imgs[labels == 1, :q, :q] += 0.5
    imgs[labels == 0, -q:, -q:] += 0.5
    return imgs, labels.astype(np.float64)


def dl_vision(seed: int, dev, n_train: int = 4096, n_hold: int = 512,
              backbone: str = "resnet50", size: int = 224, batch: int = 256,
              epochs: int = 2, n_steps: int = 20, windows: int = 3,
              small: int = 16) -> dict:
    """Phase 15.  Raises on a failed check."""
    from synapseml_tpu_torch.core import Dataset
    from synapseml_tpu_torch.models.dl import (DeepVisionClassifier,
                                               DLTrainer, OptimizerConfig,
                                               make_backbone)
    out = {}
    # 15a. ResNet-18 at f32, the card against the CPU
    x = np.random.default_rng(seed).normal(
        size=(8, small, small, 3)).astype(np.float32)
    diffs = {}
    for train in (False, True):
        res = {}
        for d in (dev, torch.device("cpu")):
            net = make_backbone("resnet18", 3, dtype=torch.float32,
                                device=d, seed=seed)
            with torch.no_grad(), ieee_f32():
                logits = net(torch.from_numpy(x).to(d), train=train)
            net.commit_batch_stats()
            res[d.type] = (logits, dict(net.named_buffers()))
        (gc, sc), (gh, sh) = res[dev.type], res["cpu"]
        diffs["train" if train else "eval"] = dict(
            logits=float((gc.cpu() - gh).abs().max()),
            batch_stats=_max_diff(sc, sh))
    if max(v for r in diffs.values() for v in r.values()) > 1e-4:
        raise AssertionError(f"ResNet-18 card vs CPU at f32: {diffs}")
    out["card_vs_cpu_f32"] = diffs
    log(f"phase 15a: ResNet-18 {small}x{small} card vs CPU at f32 {diffs} "
        "(limit 1e-4)")

    # 15b. the main path: fit then transform
    rng = np.random.default_rng(seed + 15)
    imgs, labels = vision_images(rng, n_train + n_hold, size)
    train = Dataset({"image": list(imgs[:n_train]),
                     "label": labels[:n_train]})
    hold = Dataset({"image": list(imgs[n_train:]), "label": labels[n_train:]})
    del imgs
    est = DeepVisionClassifier(backbone=backbone, batchSize=batch,
                               maxEpochs=epochs, learningRate=1e-3,
                               precision="bf16", seed=seed, device=str(dev))
    t0 = time.perf_counter()
    model = est.fit(train)
    synchronize(dev)
    fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = model.transform(hold)
    transform_s = time.perf_counter() - t0
    proba = np.stack(list(res["probability"]))
    if not (np.isfinite(proba).all() and proba.shape == (n_hold, 2)):
        raise AssertionError("vision transform: non-finite or misshapen "
                             "probabilities")
    out["main_path"] = dict(
        fit_s=fit_s, transform_s=transform_s,
        holdout_accuracy=float((res["prediction"] == hold["label"]).mean()),
        steps=-(-n_train // batch) * epochs,
        history=model.modelPayload["history"])
    log(f"phase 15b: {backbone} {size}x{size} main path "
        f"{json.dumps(out['main_path'])}")
    del train, hold, res

    # 15c. a timed window and a profile at bf16
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    net = make_backbone(backbone, 2, device=dev, seed=None)
    tr = DLTrainer(net, OptimizerConfig(learning_rate=1e-4), dev,
                   has_batch_stats=True, train_kwarg="train")
    state = tr.init_state(seed)
    wrng = np.random.default_rng(seed)
    bi, bl = tr.shard_batch(vision_images(wrng, batch, size))
    bl = bl.long()
    fn = _step_fn(tr, state, (bi,), bl, seed)
    win = train_windows({"bf16": fn}, batch, n_steps, windows)["bf16"]
    fwd = conv_flops(net, size)
    win.update(step_ms=batch / win["sps"] * 1e3, fwd_flops_per_sample=fwd,
               train_flops_per_sample=3 * fwd,
               mfu=win["sps"] * 3 * fwd / PEAK_BF16_S)
    if dev.type == "cuda":
        win["peak_mem_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    out["windows"] = win
    log(f"phase 15c: {backbone} {size}x{size} fine-tune, batch {batch}: "
        f"{json.dumps(win)}")
    out["profile"] = prof = profile_steps(fn)
    prof["busy_share_of_window_step"] = (prof["kernel_ms_per_step"]
                                         / win["step_ms"])
    log(f"phase 15d: profile bf16 {json.dumps(prof)}")
    return out


# --------------------------------------------------------------------------
# phase 16: the online learners (plain PyTorch and CUDA graphs; no kernel)

#: Criteo display-ads (the Kaggle release): distinct values of each of its
#: 26 categorical columns, C1-C26
CRITEO_CARDINALITY = (1460, 583, 10131227, 2202608, 305, 24, 12517, 633, 3,
                      93145, 5683, 8351593, 3194, 27, 14992, 5461306, 10,
                      5652, 2173, 4, 7046547, 18, 15, 286181, 105, 142572)
#: the share of clicks in Criteo's training days
CRITEO_CTR = 0.256


def criteo_columns(rng, n: int) -> dict:
    """``n`` rows in Criteo display-ads' column shape: 13 integer counts
    I1-I13 (heavy-tailed, 0 where missing, log1p as usually fed to a
    linear learner) and 26 categorical columns C1-C26 of 8-hex-digit ids,
    drawn with a Zipf tail over each column's published cardinality."""
    cols = {}
    for j in range(13):
        mean = float(np.exp(rng.uniform(0, 6)))
        v = rng.negative_binomial(1, 1.0 / (1.0 + mean), n)
        v[rng.random(n) < rng.uniform(0.0, 0.4)] = 0
        cols[f"I{j + 1}"] = np.log1p(v).astype(np.float32)
    for j, card in enumerate(CRITEO_CARDINALITY):
        rank = np.minimum(rng.zipf(1.1 + 0.4 * rng.random(), n), card) - 1
        uniq, inv = np.unique(rank, return_inverse=True)
        ids = (uniq.astype(np.uint64) * np.uint64(2654435761)
               + np.uint64(j * 97)) % np.uint64(2 ** 32)
        vocab = np.asarray([f"{int(x):08x}" for x in ids], object)
        cols[f"C{j + 1}"] = vocab[inv]
    return cols


def hidden_clicks(rng, parts):
    """Clicks from a hidden logistic model over the hashed features of
    each matrix of ``parts``: one weight per hashed index, the margin
    scaled to a standard deviation of 2 over all rows and shifted to
    Criteo's click rate → one label array per part."""
    w = rng.normal(size=parts[0].shape[1]).astype(np.float32)
    ms = [X @ w for X in parts]
    m = np.concatenate(ms)
    mu, sd = float(m.mean()), max(float(m.std()), 1e-6)
    shift = np.log(CRITEO_CTR / (1 - CRITEO_CTR))
    out = []
    for mp in ms:
        p = 1.0 / (1.0 + np.exp(-((mp - mu) / sd * 2.0 + shift)))
        out.append((rng.random(len(p)) < p).astype(np.float64))
    return out


def _state_diff(a, b) -> float:
    """The largest difference of two SGD states, each field over its own
    scale (max(1, max |x|))."""
    from synapseml_tpu_torch.models.online import state_to_numpy
    na, nb = state_to_numpy(a), state_to_numpy(b)
    return max(float(np.max(np.abs(na[f] - nb[f])))
               / max(1.0, float(np.max(np.abs(nb[f])))) for f in na)


def _states_equal(a, b) -> bool:
    return all(torch.equal(x.cpu(), y.cpu()) for x, y in zip(a, b))


def online_card_vs_cpu(dev, seed: int, n: int = 4096, d: int = 256) -> dict:
    """Phase 16a: every online learner fit on the card and on the CPU from
    the same seeded data → the largest state (and output) difference of
    each, each over its scale; and ``train_sgd`` on the card with and
    without its CUDA graphs (bit-identical states)."""
    from synapseml_tpu_torch.core import Dataset
    from synapseml_tpu_torch.models import online as O
    rng = np.random.default_rng(seed + 16)
    X = (rng.normal(size=(n, d))
         * rng.uniform(0.1, 3.0, size=d)).astype(np.float32)
    m = X @ rng.normal(size=d) / np.sqrt(d) * 3
    m = m / m.std()
    wcol = rng.uniform(0.5, 2.0, n).astype(np.float32)
    labels = {
        "logistic": (m + 0.3 * rng.normal(size=n) > 0).astype(np.float64),
        "squared": m + 0.1 * rng.normal(size=n),
        "poisson": rng.poisson(np.exp(0.3 * m)).astype(np.float64)}
    labels["hinge"] = labels["logistic"]
    labels["quantile"] = labels["squared"]
    out = {}

    def both(make, ds, out_col):
        models = {k: make(k).fit(ds) for k in (str(dev), "cpu")}
        res = {k: np.stack(list(mdl.transform(ds)[out_col])).astype(
            np.float64) for k, mdl in models.items()}
        st = {k: (mdl.state if mdl.state is not None else mdl.get("state"))
              for k, mdl in models.items()}
        scale = max(1.0, float(np.abs(res["cpu"]).max()))
        return dict(state=_state_diff(st[str(dev)], st["cpu"]),
                    output=float(np.abs(res[str(dev)] - res["cpu"]).max())
                    / scale)

    for loss in ("logistic", "hinge"):
        ds = Dataset({"features": list(X), "label": labels[loss], "w": wcol})
        out[f"classifier {loss}"] = both(
            lambda k: O.OnlineSGDClassifier(lossFunction=loss, numPasses=2,
                                            weightCol="w", device=k),
            ds, "rawPrediction")
    for loss in ("squared", "quantile", "poisson"):
        ds = Dataset({"features": list(X), "label": labels[loss], "w": wcol})
        # poisson's exp(margin) overflows at the default rate here
        lr = 0.02 if loss == "poisson" else 0.5
        out[f"regressor {loss}"] = both(
            lambda k: O.OnlineSGDRegressor(lossFunction=loss, numPasses=2,
                                           quantileTau=0.3, weightCol="w",
                                           learningRate=lr, device=k),
            ds, "prediction")
    lines = np.asarray([
        f"{1 if c else -1} {rng.uniform(0.5, 2):.3f} |w "
        + " ".join(f"t{v}" for v in rng.integers(0, 400, 6))
        + (" pos" if c else " neg") + f" |n x:{rng.normal():.4f}"
        for c in rng.integers(0, 2, n)], object)
    vw = Dataset({"value": lines})
    out["generic logistic"] = both(
        lambda k: O.OnlineGeneric(lossFunction="logistic", numPasses=2,
                                  numBits=10, device=k), vw, "prediction")
    t0 = time.perf_counter()
    prog = O.OnlineGenericProgressive(lossFunction="logistic", numBits=10,
                                      device=str(dev)).transform(
        Dataset({"value": lines[:1024]}))["prediction"]
    prog_s = time.perf_counter() - t0
    prog_cpu = O.OnlineGenericProgressive(
        lossFunction="logistic", numBits=10, device="cpu").transform(
        Dataset({"value": lines[:1024]}))["prediction"]
    out["progressive logistic"] = dict(
        output=float(np.abs(prog - prog_cpu).max()),
        card_s=prog_s, card_ms_per_batch=prog_s / (1024 / 32) * 1e3)
    acts = np.eye(4, dtype=np.float32)
    shared = rng.normal(size=(n // 4, 3)).astype(np.float32)
    chosen = rng.integers(0, 4, n // 4)
    cost = np.where(chosen == (shared[:, 0] > 0).astype(int), -1.0, 0.5)
    bandit = Dataset({"shared": list(shared),
                      "features": [list(acts)] * (n // 4),
                      "chosenAction": chosen + 1,
                      "label": cost.astype(np.float32),
                      "probability": np.full(n // 4, 0.25, np.float32)})
    out["contextual bandit"] = both(
        lambda k: O.ContextualBandit(numPasses=2, device=k), bandit,
        "prediction")
    # train_sgd with its CUDA graphs (n / 32 = 128 steps: two replays of
    # 64) against the same steps eagerly
    y = np.where(labels["logistic"] > 0, 1.0, -1.0).astype(np.float32)
    cfg = O.SGDConfig(loss="logistic", num_passes=2)
    g, _ = O.train_sgd(X, y, cfg, sample_weight=wcol, device=dev, graph=True)
    e, _ = O.train_sgd(X, y, cfg, sample_weight=wcol, device=dev,
                       graph=False)
    out["graph_equals_eager"] = _states_equal(g, e)
    return out


def save_rows(path: str, **arrays) -> None:
    """Write matrices as CSR (``<name>_data``, ``_indices``, ``_indptr``,
    ``_shape``) and vectors as they are into one ``.npz``."""
    out = {}
    for name, a in arrays.items():
        if a.ndim == 2:
            rows, cols = np.nonzero(a)
            out[f"{name}_data"] = a[rows, cols]
            out[f"{name}_indices"] = cols.astype(np.int32)
            out[f"{name}_indptr"] = np.concatenate(
                [[0], np.cumsum(np.bincount(rows, minlength=len(a)))])
            out[f"{name}_shape"] = np.asarray(a.shape)
        else:
            out[name] = a
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez(path, **out)


def load_rows(path: str) -> dict:
    """:func:`save_rows`'s arrays, matrices dense again."""
    out = {}
    with np.load(path) as z:
        names = {k.rsplit("_", 1)[0] for k in z.files if k.endswith("_shape")}
        for name in names:
            a = np.zeros(tuple(z[f"{name}_shape"]), np.float32)
            ptr = z[f"{name}_indptr"]
            rows = np.repeat(np.arange(len(ptr) - 1), np.diff(ptr))
            a[rows, z[f"{name}_indices"]] = z[f"{name}_data"]
            out[name] = a
        for k in z.files:
            if k.rsplit("_", 1)[0] not in names:
                out[k] = z[k]
    return out


def online(seed: int, dev, n_train: int = 262_144, n_hold: int = 65_536,
           num_bits: int = 12, batch: int = 32, turns: int = 3,
           auc_floor: float = 0.75, save: Optional[str] = None) -> dict:
    """Phase 16.  ``save``: a path where 16b's featurized rows and labels
    are written (sparse, :func:`save_rows`) for phase 25i's gang.
    Raises on a failed check."""
    from synapseml_tpu_torch.core import Dataset, Pipeline
    from synapseml_tpu_torch.models.gbdt.metrics import auc
    from synapseml_tpu_torch.models.online import (HashingFeaturizer,
                                                   OnlineSGDClassifier,
                                                   SGDConfig)
    from synapseml_tpu_torch.models.online import sgd as SGD
    out = {}
    # 16a. every learner, the card against the CPU at f32
    t0 = time.perf_counter()
    with ieee_f32():
        a = online_card_vs_cpu(dev, seed)
    a["wall_s"] = time.perf_counter() - t0
    worst = max(max(v for k, v in r.items() if k in ("state", "output"))
                for r in a.values() if isinstance(r, dict))
    out["card_vs_cpu"] = a
    log(f"phase 16a: online learners card vs CPU, f32: {json.dumps(a)}; "
        f"largest difference {worst:.3g} (limit 1e-4)")
    if worst > 1e-4 or not a["graph_equals_eager"]:
        raise AssertionError(f"online card vs CPU: {a}")

    # 16b. the main path at Criteo's column shape
    rng = np.random.default_rng(seed + 161)
    t0 = time.perf_counter()
    cols = criteo_columns(rng, n_train + n_hold)
    columns_s = time.perf_counter() - t0
    names = [f"I{j}" for j in range(1, 14)] + [f"C{j}" for j in range(1, 27)]
    hasher = HashingFeaturizer(inputCols=names, numBits=num_bits)
    t0 = time.perf_counter()
    tr = hasher.transform(Dataset({k: v[:n_train] for k, v in cols.items()}))
    ho = hasher.transform(Dataset({k: v[n_train:] for k, v in cols.items()}))
    featurize_s = time.perf_counter() - t0
    del cols
    t0 = time.perf_counter()
    Xtr = tr.to_numpy(["features"], np.float32)
    Xho = ho.to_numpy(["features"], np.float32)
    to_numpy_s = time.perf_counter() - t0
    ytr, yho = hidden_clicks(rng, [Xtr, Xho])
    if save is not None:
        save_rows(save, Xtr=Xtr, ytr=ytr, Xho=Xho, yho=yho)
    tr = tr.with_column("label", ytr)
    ho = ho.with_column("label", yho)
    est = OnlineSGDClassifier(numPasses=1, batchSize=batch, device=str(dev))
    t0 = time.perf_counter()
    pm = Pipeline([est]).fit(tr)
    synchronize(dev)
    fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = pm.transform(ho)
    transform_s = time.perf_counter() - t0
    margin = np.asarray(res["rawPrediction"], np.float64)
    if not (np.isfinite(margin).all() and margin.shape == (n_hold,)):
        raise AssertionError("online transform: non-finite or misshapen "
                             "margins")
    hold_auc = float(auc(yho, margin))
    model = pm.get_or_default("stages")[0]
    out["main_path"] = dict(
        rows=n_train, holdout_rows=n_hold, dim=1 << num_bits,
        columns_s=columns_s, featurize_s=featurize_s, to_numpy_s=to_numpy_s,
        fit_s=fit_s, transform_s=transform_s,
        holdout_auc=hold_auc, auc_floor=auc_floor,
        click_rate=float(ytr.mean()),
        average_loss=model.training_stats["average_loss"],
        blocked_matrix_bytes=int(Xtr.nbytes))
    log(f"phase 16b: online main path {json.dumps(out['main_path'])}")
    if hold_auc <= auc_floor:
        raise AssertionError(f"online holdout AUC {hold_auc}")

    # eager against graph in turns on one upload: eager, graph, graph,
    # eager, eager, graph ...; every pass from the same initial state
    cfg = SGDConfig(loss="logistic", batch_size=batch)
    y_pm = np.where(ytr > 0, 1.0, -1.0).astype(np.float32)
    init = SGD.init_state(Xtr.shape[1], dev)
    t0 = time.perf_counter()
    run = SGD.BlockPass(cfg, init, SGD._pad_blocks(
        Xtr, y_pm, np.ones(n_train, np.float32), batch), dev)
    synchronize(dev)
    upload_s = time.perf_counter() - t0
    times = {"eager": [], "graph": []}
    finals = {}
    order = [m for i in range(turns) for m in
             (("eager", "graph") if i % 2 == 0 else ("graph", "eager"))]
    for mode in order:
        run.reset(init)
        t0 = time.perf_counter()
        run.run_pass(graph=mode == "graph")
        float(run.loss_sum)
        times[mode].append(time.perf_counter() - t0)
        finals.setdefault(mode, [t.clone() for t in run.state])
    same = all(torch.equal(a_, b_) for a_, b_ in zip(finals["eager"],
                                                     finals["graph"]))
    ref = [t.cpu() for t in model.state]
    same_as_fit = all(torch.equal(a_.cpu(), b_)
                      for a_, b_ in zip(finals["graph"], ref))
    med = {k: sorted(v)[len(v) // 2] for k, v in times.items()}
    out["passes"] = dict(
        upload_s=upload_s, train_s=times, median_s=med,
        rows_per_s={k: n_train / v for k, v in med.items()},
        graph_speedup=med["eager"] / med["graph"],
        graph_equals_eager=same, equals_estimator_fit=same_as_fit,
        steps=run.n_blocks, graph_chunk=SGD.GRAPH_CHUNK)
    log(f"phase 16b: passes {json.dumps(out['passes'])}")
    if not (same and same_as_fit):
        raise AssertionError("online: the graph pass, the eager pass and "
                             "the estimator's fit differ")
    # device busy share and kernels a step: the first 512 steps with
    # graphs and eagerly, each under the profiler (a whole pass would
    # leave ~475,000 kernel events to sum up)
    from torch.profiler import ProfilerActivity, profile
    prof_out = {}
    del run
    short = SGD.BlockPass(cfg, init, SGD._pad_blocks(
        Xtr[:512 * batch], y_pm[:512 * batch],
        np.ones(512 * batch, np.float32), batch), dev)
    for mode in ("graph", "eager"):
        rp = short
        rp.reset(init)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            rp.run_pass(graph=mode == "graph")
            float(rp.loss_sum)
            wall = time.perf_counter() - t0
        kern = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and e.self_device_time_total > 0]
        total = sum(e.self_device_time_total for e in kern) / 1e6
        launches = sum(e.count for e in kern)
        prof_out[mode] = dict(
            steps=rp.n_blocks, wall_s=wall, kernel_s=total,
            busy_share=total / wall,
            # the profiler slows the host: the device's share of an
            # unprofiled pass is its kernel time over that pass's time
            busy_share_unprofiled=total / rp.n_blocks
            / (med[mode] / n_train * batch),
            kernels_per_step=launches / rp.n_blocks,
            device_us_per_step=total / rp.n_blocks * 1e6,
            top=[[e.key[:60], e.self_device_time_total / 1e3, e.count]
                 for e in sorted(kern, key=lambda e:
                                 -e.self_device_time_total)[:6]])
    out["profile"] = prof_out
    log(f"phase 16b: profile {json.dumps(prof_out)}")
    return out


# --------------------------------------------------------------------------
# phase 17: the MoE text encoder (plain PyTorch; no kernel)

def moe_gather_vs_dense(dev, seed: int) -> dict:
    """The MoE FFN's gather form against the reference's dense einsum form
    on ``dev`` at f32: the largest output and gradient differences."""
    from synapseml_tpu_torch.models.dl.moe import MoEFFN
    ffn = MoEFFN(8, 64, 128, top_k=2, capacity_factor=1.0,
                 dtype=torch.float32, device=dev)
    with torch.no_grad():
        ffn.reset_parameters(torch.Generator().manual_seed(seed))
    x = torch.randn(4, 32, 64, generator=torch.Generator().manual_seed(
        seed + 1)).to(dev)
    outs, grads = [], []
    for dense in (False, True):
        ffn.zero_grad()
        xx = x.clone().requires_grad_(True)
        o = ffn(xx, dense=dense)
        (o.square().sum() + ffn.aux_loss).backward()
        outs.append(o.detach())
        grads.append([xx.grad] + [p.grad for p in ffn.parameters()])
    return dict(output=float((outs[0] - outs[1]).abs().max()),
                grads=max(float((a - b).abs().max())
                          for a, b in zip(*grads)),
                dropped=float(ffn.dropped))


def moe_flops_per_step(model, batch: int, seq: int) -> dict:
    """The FLOPs one training step executes: 6 x the parameters outside
    the experts x the tokens (bench.py's dense count), plus each MoE
    layer's expert GEMMs over all E·C slots, padded ones included
    (2 GEMMs of 2·E·C·D·d_ff, x3 for forward and backward)."""
    cfg = model.cfg
    n_tok = batch * seq
    moe = [getattr(model, f"layer_{i}").moe_ffn
           for i in range(cfg.num_layers) if cfg.uses_moe(i)]
    p_all = sum(p.numel() for p in model.parameters())
    p_exp = sum(m.w_up.numel() + m.w_down.numel() for m in moe)
    from synapseml_tpu_torch.models.dl.moe import capacity
    C = capacity(cfg.moe_capacity_factor, cfg.moe_top_k, n_tok,
                 cfg.num_experts)
    expert = len(moe) * 3 * 2 * (2 * cfg.num_experts * C * cfg.d_model
                                 * cfg.d_ff)
    dense = 6.0 * (p_all - p_exp) * n_tok
    return dict(params=p_all, expert_params=p_exp, capacity=C,
                moe_layers=len(moe), dense_flops=dense,
                expert_flops=float(expert), flops=dense + expert)


def dl_moe(seed: int, dev, model_size: str = "base", vocab: int = 30522,
           batch: int = 128, seq: int = 128, experts: int = 8,
           top_k: int = 2, n_train: int = 4096, n_hold: int = 1024,
           n_words: int = 45_000, epochs: int = 2, n_steps: int = 20,
           windows: int = 3) -> dict:
    """Phase 17.  Raises on a failed check."""
    from synapseml_tpu_torch.core import Dataset, Pipeline
    from synapseml_tpu_torch.models.dl import (DeepTextClassifier, DLTrainer,
                                               OptimizerConfig, TextEncoder,
                                               resolve_precision)
    out = {}
    # 17a. the tiny MoE encoder card against CPU; gather against dense
    with ieee_f32():
        d = dl_text_card_vs_cpu(dev, seed, num_experts=4)
        g = moe_gather_vs_dense(dev, seed)
    out["card_vs_cpu_f32"], out["gather_vs_dense_f32"] = d, g
    log(f"phase 17a: MoE text card vs CPU, f32 {d} (limit 1e-4); gather vs "
        f"dense on the card {g} (limit 1e-5)")
    if max(d.values()) > 1e-4 or max(g["output"], g["grads"]) > 1e-5:
        raise AssertionError(f"MoE card vs CPU {d}, gather vs dense {g}")

    # 17b. BERT-base width with Switch-Base-8's expert layout, top-2
    est = DeepTextClassifier(modelSize=model_size, vocabSize=vocab,
                             maxTokenLen=seq, batchSize=batch,
                             precision="bf16", maxEpochs=epochs, seed=seed,
                             numExperts=experts, moeTopK=top_k,
                             device=str(dev))
    pol = resolve_precision("bf16")
    cfg = dataclasses.replace(est._model_config(2), dtype=pol.compute_dtype)
    tr = DLTrainer(TextEncoder(cfg, device=dev, seed=None),
                   OptimizerConfig(learning_rate=2e-5), dev, precision=pol)
    state = tr.init_state(seed)
    wrng = np.random.default_rng(seed)
    ids = wrng.integers(0, vocab, (batch, seq)).astype(np.int32)
    mask = np.ones((batch, seq), bool)
    lab = wrng.integers(0, 2, batch).astype(np.int32)
    bi, bm, bl = tr.shard_batch((ids, mask, lab))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    step = _step_fn(tr, state, (bi, bm), bl, seed)
    first, grad_sq = [], []
    head = P28_FULL["warmup"] + P28_FULL["steps"]

    def counted():
        loss = step()
        if not grad_sq:
            grad_sq.append(grad_sums(tr.model))    # step 1's gradients
        if len(first) < head:
            first.append(loss)        # steps 1.., from the seeded weights
        return loss

    win = train_windows({"bf16": counted}, batch, n_steps, windows)["bf16"]
    moe = [getattr(tr.model, f"layer_{i}").moe_ffn
           for i in range(cfg.num_layers) if cfg.uses_moe(i)]
    fl = moe_flops_per_step(tr.model, batch, seq)
    win.update(
        loss1=float(first[0]), losses_head=[float(x) for x in first],
        grad_sq1=grad_sq[0],
        step_ms=batch / win["sps"] * 1e3,
        mfu=win["sps"] * fl["flops"] / batch / PEAK_BF16_S,
        peak_gb=(torch.cuda.max_memory_allocated(dev) / 1e9
                 if dev.type == "cuda" else None),
        dropped_share=float(np.mean([float(m.dropped) for m in moe])),
        **fl)
    out["window"] = win
    log(f"phase 17b: {model_size} MoE (E={experts}, top-{top_k}, every "
        f"{cfg.moe_layer_freq}nd FFN, capacity factor "
        f"{cfg.moe_capacity_factor}), batch {batch}, seq {seq}, bf16: "
        f"{json.dumps(win)}")
    # 17c. where the MoE step's time goes
    out["profile"] = prof = profile_steps(step)
    prof["busy_share_of_window_step"] = (prof["kernel_ms_per_step"]
                                         / win["step_ms"])
    log(f"phase 17c: profile MoE bf16 {json.dumps(prof)}")
    del tr, state, bi, bm, bl, step
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # the main path on phase 14's corpus: fit then transform
    rng = np.random.default_rng(seed + 14)
    words = make_words(rng, n_words)
    texts, labels = text_corpus(rng, words, n_train + n_hold)
    train = Dataset({"text": texts[:n_train], "label": labels[:n_train]})
    hold = Dataset({"text": texts[n_train:], "label": labels[n_train:]})
    t0 = time.perf_counter()
    pm = Pipeline([est]).fit(train)
    synchronize(dev)
    fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = pm.transform(hold)
    transform_s = time.perf_counter() - t0
    acc = float((res["prediction"] == hold["label"]).mean())
    proba = np.stack(list(res["probability"]))
    if not (np.isfinite(proba).all() and proba.shape == (n_hold, 2)):
        raise AssertionError("MoE transform: non-finite or misshapen "
                             "probabilities")
    model = pm.get_or_default("stages")[0]
    out["main_path"] = dict(
        fit_s=fit_s, transform_s=transform_s, holdout_accuracy=acc,
        steps=-(-n_train // batch) * epochs,
        history=model.modelPayload["history"])
    log(f"phase 17b: MoE main path {json.dumps(out['main_path'])}")
    if acc <= 0.8:
        raise AssertionError(f"MoE holdout accuracy {acc}")
    return out


def http_generate(url: str, payload: dict, timeout: float = 600.0,
                  headers: Optional[dict] = None):
    """POST one request to an ``LLMServer`` → (ids, seconds to the first
    body byte, seconds to the end).  A streamed reply must carry one line
    per token, then a ``done`` line with the same ids.  ``headers`` are
    added to the request's (a router's trace and tenant headers)."""
    import http.client
    from urllib.parse import urlsplit
    u = urlsplit(url)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=timeout)
    t0 = time.perf_counter()
    try:
        conn.request("POST", u.path, body=json.dumps(payload),
                     headers={"Content-Type": "application/json",
                              **(headers or {})})
        resp = conn.getresponse()
        first = resp.readline()
        ttfb = time.perf_counter() - t0
        body = first + resp.read()
        if resp.status != 200:
            raise AssertionError(f"HTTP {resp.status}: {body[:200]!r}")
    finally:
        conn.close()
    lines = [json.loads(ln) for ln in body.splitlines() if ln.strip()]
    ids = lines[-1]["ids"]
    if payload.get("stream"):
        toks = [ln["token"] for ln in lines[:-1]]
        if not lines[-1].get("done") or toks != ids:
            raise AssertionError(f"stream lines {toks} against done {ids}")
    return ids, ttfb, time.perf_counter() - t0


def http_get(url: str):
    """GET → (status, body bytes); an HTTP error status is returned."""
    import urllib.error
    import urllib.request
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def serve_all(srv, prompts, new, stream_every: int = 2, extra=None):
    """Post every prompt from its own client thread (every
    ``stream_every``-th streamed; ``extra(i)`` adds fields to request
    i's body) → (ids per request, TTFB per streamed request, wall s);
    raises on a failed request."""
    import threading
    res, errs = {}, []

    def call(i):
        try:
            res[i] = http_generate(srv.url, {
                "ids": [int(t) for t in prompts[i]],
                "max_new_tokens": int(new[i]),
                "stream": i % stream_every == 1,
                **(extra(i) if extra else {})})
        except Exception as e:          # re-raised below, on this thread
            errs.append((i, e))
    t0 = time.perf_counter()
    threads = [threading.Thread(target=call, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    wall = time.perf_counter() - t0
    if errs or len(res) != len(prompts):
        raise AssertionError(f"requests failed: {errs}")
    ttfb = [res[i][1] for i in range(len(prompts))
            if i % stream_every == 1]
    return [res[i][0] for i in range(len(prompts))], ttfb, wall


def timed_steps(engine) -> list:
    """Record the host wall of every ``engine.step()`` (it ends in a copy
    to the host, so it covers the device work) and, per step, the slots
    that took part → [(seconds, active slots, events)]."""
    real = engine.step
    log_ = []

    def step():
        n = engine.active_count
        t = time.perf_counter()
        ev = real()
        log_.append((time.perf_counter() - t, n, len(ev)))
        return ev
    engine.step = step
    return log_


def prom_value(text: str, family: str, **labels) -> float:
    """One sample of a Prometheus text body (0.0 when absent)."""
    want = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    for line in text.splitlines():
        if line.startswith(f"{family}{{{want}}} "):
            return float(line.split()[-1])
    return 0.0


def llm_http(model, prompts, new, want, dev, name: str = "phase18",
             n_slots: int = 16, max_len: int = 2048,
             ttft_slo_s: float = 5.0) -> dict:
    """Phase 18: ``LLMServer`` over the full-width model, warmed in the
    background (``/readyz`` 503 while warming, 200 after), all requests
    posted at once from client threads, every other one streamed.  K3's
    counts are reset just before the traffic and read just after it.
    Raises unless every reply equals ``want`` (the same engine
    configuration driven directly), K3 launched, and the engine's
    ``llm_engine_tokens_total`` equals the tokens served."""
    from synapseml_tpu_torch.kernels import launches as L
    from synapseml_tpu_torch.serving import LLMServer
    t0 = time.perf_counter()
    srv = LLMServer(model, n_slots=n_slots, max_len=max_len,
                    warmup="background", ttft_slo_s=ttft_slo_s,
                    device=dev, engine_kwargs={"name": name})
    try:
        construct_s = time.perf_counter() - t0
        ready = srv.server.url_for("/readyz")
        first, body = http_get(ready)
        if first != 503 or json.loads(body)["status"] != "warming":
            raise AssertionError(f"/readyz while warming: {first} {body}")
        plane = srv.engine.compile_plane
        if not plane.wait(600):
            raise AssertionError("the compile plane did not warm")
        after, _ = http_get(ready)
        if after != 200:
            raise AssertionError(f"/readyz after warm-up: {after}")
        steps = timed_steps(srv.engine)
        L.reset()
        outs, ttfb, wall = serve_all(srv, prompts, new)
        shapes = L.shapes("paged_decode_attention")
        metrics = http_get(srv.server.url_for("/metrics"))[1].decode()
        sloz = json.loads(http_get(srv.server.url_for("/sloz"))[1])
        snap = plane.snapshot()
    finally:
        srv.close()
    for i, o in enumerate(outs):
        if not np.array_equal(np.asarray(o), np.asarray(want[i])):
            raise AssertionError(f"request {i}: HTTP {o} against the "
                                 f"direct engine {list(want[i])}")
    if dev.type == "cuda" and not shapes:
        raise AssertionError("K3 never launched while the server answered")
    served = int(sum(len(o) for o in outs))
    counted = prom_value(metrics, "llm_engine_tokens_total", engine=name)
    if counted != served:
        raise AssertionError(f"llm_engine_tokens_total {counted} against "
                             f"{served} tokens served")
    if snap["stalls"] or snap["replays"] != len(steps):
        raise AssertionError(f"{snap['replays']} replays and "
                             f"{snap['stalls']} stalls in {len(steps)} "
                             "steps")
    st = np.asarray([s[0] for s in steps])
    plane_slo = sloz["planes"]["/generate"]["slo"]
    return dict(requests=len(prompts), tokens=served,
                http_tokens_per_s=served / wall, wall_s=wall,
                construct_s=construct_s, readyz=[first, after],
                warmup_s=snap.get("warmup_seconds"),
                ttfb_p50_ms=float(np.median(ttfb) * 1e3),
                ttfb_p90_ms=float(np.percentile(ttfb, 90) * 1e3),
                steps=len(steps), mean_step_ms=float(st.mean() * 1e3),
                decode_tokens_per_s=float(sum(s[2] for s in steps)
                                          / st.sum()),
                sloz_ttft=plane_slo.get("ttft"), launches=shapes)


def spec_serve(model, prompts, new, dev, name: str, spec: int,
               n_slots: int = 8):
    """One ``LLMServer`` run of ``prompts`` (graphs, warmed before the
    traffic) → (ids per request, committed tokens per slot-step, the
    engine's drafter hit rate and acceptance, and K3's launches by shape,
    counted from just before the traffic to just after it).  Raises on
    the card if K3 never launched."""
    from synapseml_tpu_torch.kernels import launches as L
    from synapseml_tpu_torch.serving import LLMServer
    srv = LLMServer(model, n_slots=n_slots, max_len=model.cfg.max_len,
                    spec_draft_len=spec, warmup="sync", device=dev,
                    api_path=f"/{name}", engine_kwargs={"name": name})
    try:
        steps = timed_steps(srv.engine)
        L.reset()
        outs, _, wall = serve_all(srv, prompts, new)
        shapes = L.shapes("paged_decode_attention")
        eng = srv.engine
    finally:
        srv.close()
    if dev.type == "cuda" and not shapes:
        raise AssertionError(f"{name}: K3 never launched while the server "
                             "answered")
    drafted = eng.spec_draft_hits + eng.spec_draft_misses
    return outs, dict(launches=shapes,
        tokens_per_step=sum(s[2] for s in steps) / max(
            1, sum(s[1] for s in steps)),
        hit_rate=eng.spec_draft_hits / max(1, drafted),
        acceptance=eng.spec_acceptance_rate, steps=len(steps),
        wall_s=wall)


def spec_vs_plain(models: dict, prompts, new, dev, tag: str,
                  n_slots: int = 8) -> dict:
    """Each model served plain and with ``spec_draft_len=7``: raises
    unless the speculative replies equal the plain ones → each model's
    speculative stats and the second's tokens per slot-step over the
    first's (``ratio``)."""
    out = {}
    for label, m in models.items():
        plain, plain_stats = spec_serve(m, prompts, new, dev,
                                        f"{tag}-{label}-plain", 0, n_slots)
        spec, stats = spec_serve(m, prompts, new, dev,
                                 f"{tag}-{label}-spec", 7, n_slots)
        for i, (a, b) in enumerate(zip(plain, spec)):
            if a != b:
                raise AssertionError(f"{tag} {label} request {i}: "
                                     f"speculative {b} against greedy {a}")
        out[label] = dict(stats, plain_launches=plain_stats["launches"])
    first, second = (out[k]["tokens_per_step"] for k in models)
    out["ratio"] = second / first
    return out


def finetune_serve(seed: int, dev, steps: int = 250, batch: int = 32,
                   n_rec: int = 8, lr: float = 5e-4, check_batch: int = 4,
                   check_steps: int = 3, **cfg_kw) -> dict:
    """Phase 19 at bench.py's configuration (``LlamaConfig.tiny(
    vocab_size=512, d_model=1024, num_layers=12, num_heads=16,
    num_kv_heads=4, max_len=256)``): (a) ``check_steps`` adamw steps at
    f32 on the card and on the CPU from the same weights at lr 1e-4,
    every weight within 1e-4; (b) ``finetune_lm``
    over ``steps`` batches of ``templated_log_corpus(rng, batch, n_rec)``
    at bf16, and a profile of 5 steps; (c) the trained model served through ``LLMServer(spec_draft_len=7)`` on 8 prompts of
    ``templated_log_corpus(rng, 8, 3)`` x 64 new tokens, and the random
    init beside it: replies equal the plain greedy server's.  Raises on
    a failed check."""
    from synapseml_tpu_torch.models.llm import (LlamaConfig, LlamaModel,
                                                finetune_lm, lm_loss_fn,
                                                make_lm_train_step,
                                                templated_log_corpus)
    shape = dict(vocab_size=512, d_model=1024, num_layers=12, num_heads=16,
                 num_kv_heads=4, max_len=256)
    shape.update(cfg_kw)
    out = {}
    # 19a. three f32 steps, card against CPU.  Adam's first steps move a
    # weight by ~lr x a ratio of gradient moments, so where a gradient is
    # a near-cancelling sum, f32 summation order moves the update by a
    # share of lr: the check runs at lr 1e-4 (PRs 12-19 also reported
    # the fine-tune's lr beside it: a spread that scales with lr)
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on: the f32 check needs "
                             "full f32 products")
    cfg32 = LlamaConfig.tiny(dtype=torch.float32, **shape)
    rng = np.random.default_rng(seed)
    batches = [templated_log_corpus(rng, check_batch, n_rec)
               for _ in range(check_steps)]
    start = LlamaModel(cfg32, device="cpu", seed=seed).state_dict()

    def steps_from_start(device, step_lr):
        m = LlamaModel(cfg32, device=device, seed=seed)
        m.load_state_dict(start)
        init, step = make_lm_train_step(m, step_lr)
        opt = init()
        losses = [float(step(opt, torch.as_tensor(b, device=device)))
                  for b in batches]
        return {k: v.cpu() for k, v in m.state_dict().items()}, losses

    out["card_vs_cpu"] = {}
    for step_lr in (1e-4,):
        (w_cpu, l_cpu), (w_card, l_card) = (steps_from_start("cpu", step_lr),
                                            steps_from_start(dev, step_lr))
        r = dict(lr=step_lr, steps=check_steps,
                 max_weight_diff=max(float((w_card[k] - v).abs().max())
                                     for k, v in w_cpu.items()),
                 max_loss_rel_diff=max(abs(a - b) / abs(b)
                                       for a, b in zip(l_card, l_cpu)),
                 losses=l_card)
        out["card_vs_cpu"][str(step_lr)] = r
        log(f"fine-tune card vs CPU, f32, {check_steps} steps: "
            f"{json.dumps(r)}")
    checked = out["card_vs_cpu"]["0.0001"]
    if checked["max_weight_diff"] > 1e-4 \
            or checked["max_loss_rel_diff"] > 1e-5:
        raise AssertionError(f"f32 fine-tune, card vs CPU: {checked}")
    # 19b. finetune_lm at bf16
    cfg = LlamaConfig.tiny(**shape)
    model = LlamaModel(cfg, device=dev, seed=seed)
    init_state = {k: v.clone() for k, v in model.state_dict().items()}
    rng = np.random.default_rng(seed + 1)
    data = [templated_log_corpus(rng, batch, n_rec) for _ in range(steps)]
    with torch.no_grad():
        first = float(lm_loss_fn(model)(torch.as_tensor(data[0],
                                                        device=dev)))
    synchronize(dev)
    t0 = time.perf_counter()
    _, final = finetune_lm(model, iter(data), learning_rate=lr,
                           device=dev)
    synchronize(dev)
    train_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    tokens = steps * batch * data[0].shape[1]
    out["finetune"] = dict(
        steps=steps, batch=list(data[0].shape), params=n_params,
        first_loss=first, final_loss=final, train_s=train_s,
        steps_per_s=steps / train_s, tokens_per_s=tokens / train_s,
        step_ms=train_s / steps * 1e3,
        mfu=6 * n_params * tokens / train_s / PEAK_BF16_S)
    if not final < first:
        raise AssertionError(f"the loss did not fall: {first} → {final}")
    log(f"finetune_lm bf16: {json.dumps(out['finetune'])}")
    # where a step's time goes: 5 profiled steps of a fresh model (after 2)
    probe = LlamaModel(cfg, device=dev, seed=seed)
    init, step = make_lm_train_step(probe, lr)
    opt = init()
    toks = torch.as_tensor(data[0], device=dev)
    for _ in range(2):
        step(opt, toks)
    out["profile"] = profile_steps(lambda: step(opt, toks))
    del probe, opt
    log(f"profile finetune step: {json.dumps(out['profile'])}")
    # 19c. served speculatively, trained against random init.  At this
    # configuration the random init repeats one token per request, which
    # prompt lookup drafts perfectly, so the anchor commits close to the
    # spec_draft_len + 1 = 8 tokens a slot-step that bound any model:
    # reported beside the trained model, not held to a ratio (the
    # contrast is tests/test_torch_llm_finetune.py's, at the JAX test's
    # configuration)
    prompts = list(templated_log_corpus(rng, 8, 3))
    new = [64] * len(prompts)
    random_init = LlamaModel(cfg, device=dev, seed=seed)
    random_init.load_state_dict(init_state)
    out["serve"] = spec_vs_plain(
        {"random_init": random_init, "finetuned": model}, prompts, new, dev,
        "p19")
    log(f"LLMServer spec_draft_len=7, 8 prompts x 64 tokens, replies equal "
        f"the greedy server's: {json.dumps(out['serve'])}")
    return out


# ---------------------------------------------------------------------------
# phase 20: the rest of the LLM slice (arena, journal, int8, speculative
# generate, LLMTransformer, llama_from_pretrained)
# ---------------------------------------------------------------------------

#: Llama-3.2-1B's published config.json (meta-llama/Llama-3.2-1B on the
#: Hugging Face hub): phase 20b writes it beside random weights
LLAMA_32_1B_CONFIG = {
    "architectures": ["LlamaForCausalLM"], "model_type": "llama",
    "vocab_size": 128256, "hidden_size": 2048, "intermediate_size": 8192,
    "num_hidden_layers": 16, "num_attention_heads": 32,
    "num_key_value_heads": 8, "head_dim": 64, "hidden_act": "silu",
    "max_position_embeddings": 131072, "rms_norm_eps": 1e-5,
    "rope_theta": 500000.0, "tie_word_embeddings": True,
    "rope_scaling": {"factor": 32.0, "high_freq_factor": 4.0,
                     "low_freq_factor": 1.0,
                     "original_max_position_embeddings": 8192,
                     "rope_type": "llama3"},
    "bos_token_id": 128000, "eos_token_id": 128001,
    "torch_dtype": "bfloat16"}
#: where phase 20 writes its checkpoints and journals (``build/`` is not
#: committed); each run removes its own
TIER_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                         "phase20")
#: phase 20a's engines: 4 slots of ``LlamaConfig.tiny(num_layers=2)`` over
#: 128 positions (K3 at H=8, KV=4, D=16, f32; phase 6 holds that shape)
TIER_SLOTS, TIER_LEN = 4, 128


def hf_config(cfg) -> dict:
    """config.json of an HF Llama checkpoint for the port config ``cfg``
    (the keys the loader reads)."""
    return {"vocab_size": cfg.vocab_size, "hidden_size": cfg.d_model,
            "intermediate_size": cfg.d_ff,
            "num_hidden_layers": cfg.num_layers,
            "num_attention_heads": cfg.num_heads,
            "num_key_value_heads": cfg.num_kv_heads,
            "max_position_embeddings": cfg.max_len,
            "rms_norm_eps": cfg.rms_norm_eps, "rope_theta": cfg.rope_theta,
            "tie_word_embeddings": cfg.tie_embeddings}


def write_hf_llama(path: str, model, config: dict) -> int:
    """Write ``model``'s weights as an HF LlamaForCausalLM directory:
    ``config.json`` and one ``model.safetensors`` (an 8-byte little-endian
    header length, the JSON header, then each tensor's little-endian
    bytes; bf16 as its bit patterns), written one tensor at a time →
    the file's bytes.  Projection kernels transpose to ``(out, in)``."""
    import struct
    names = {"tok_embed.embedding": "model.embed_tokens.weight",
             "ln_final.scale": "model.norm.weight",
             "lm_head.kernel": "lm_head.weight"}
    hf = {}
    for key, t in model.state_dict().items():
        if key in names:
            hf_key = names[key]
        else:
            _, i, *rest = key.split(".")
            sub = ".".join(rest[:-1])
            hf_key = f"model.layers.{i}." + {
                "ln_attn": "input_layernorm", "ln_mlp":
                "post_attention_layernorm"}.get(
                sub, ("self_attn." + sub[5:]) if sub.startswith("attn.")
                else "mlp." + sub)
            hf_key += ".weight"
        hf[hf_key] = t.T if key.endswith(".kernel") else t
    codes = {torch.float32: "F32", torch.bfloat16: "BF16"}
    header, off = {}, 0
    for k, t in hf.items():
        n = t.numel() * t.element_size()
        header[k] = {"dtype": codes[t.dtype], "shape": list(t.shape),
                     "data_offsets": [off, off + n]}
        off += n
    os.makedirs(path, exist_ok=True)
    h = json.dumps(header).encode()
    with open(os.path.join(path, "model.safetensors"), "wb") as f:
        f.write(struct.pack("<Q", len(h)) + h)
        for t in hf.values():
            c = t.contiguous().cpu()
            if c.dtype == torch.bfloat16:
                c = c.view(torch.int16)
            f.write(c.numpy().tobytes())
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config, f)
    return 8 + len(h) + off


_TIER_CHILD = r"""
import json, os, sys, urllib.request
import torch
from synapseml_tpu_torch.models.llm import LlamaConfig, LlamaModel
from synapseml_tpu_torch.resilience import get_faults
from synapseml_tpu_torch.serving import LLMServer

cfg = LlamaConfig.tiny(num_layers=2, max_len=int(os.environ["P20_LEN"]),
                       dtype=torch.float32)
dev = os.environ["P20_DEVICE"]
model = LlamaModel(cfg, device=dev)
model.load_state_dict(torch.load(os.environ["P20_WEIGHTS"]))
p1 = json.loads(os.environ["P20_P1"])
srv = LLMServer(model, n_slots=int(os.environ["P20_SLOTS"]),
                max_len=cfg.max_len, journal_dir=os.environ["P20_JDIR"],
                device=dev, engine_kwargs={"name": "phase20-child"})

def post(payload):
    req = urllib.request.Request(srv.url, data=json.dumps(payload).encode(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())

out1 = post({"ids": p1, "session": "conv", "max_new_tokens": 5})["ids"]
print("TURN1", json.dumps(out1), flush=True)
# turn 2 journals 3 tokens, then the 4th append SIGKILLs this process
get_faults().configure("kvtier.journal_append=kill:after=3")
post({"ids": p1 + out1 + [3, 1, 4, 1, 5], "session": "conv",
      "max_new_tokens": 8})
print("UNREACHABLE", flush=True)
"""


def tier_card_vs_cpu(dev, seed: int, root: str) -> dict:
    """Phase 20a: ``LlamaConfig.tiny(num_layers=2)`` at f32 on the card
    and on the CPU (the same weights): ``llama_from_pretrained`` logits
    within 1e-4; ``quantize_int8`` bit-identical and the int8 engine's
    tokens equal; an arena restore equal to a cold ``generate`` of the
    whole prompt; preempt → resume through the arena equal to the
    uninterrupted run; ``generate_speculative`` equal to ``generate``;
    ``LLMTransformer`` equal to ``generate``'s decoded tokens; then the
    SIGKILL failover on the card.  K3's counts are reset just before and
    read just after the card's engines run.  Raises on any difference."""
    from synapseml_tpu_torch.core import Dataset
    from synapseml_tpu_torch.kernels import launches as L
    from synapseml_tpu_torch.models.dl.tokenizer import WordTokenizer
    from synapseml_tpu_torch.models.llm import (
        HostKVArena, LlamaConfig, LlamaModel, LLMTransformer, SessionJournal,
        SlotEngine, generate, generate_speculative, llama_from_pretrained,
        quantize_int8)
    from synapseml_tpu_torch.serving import LLMServer
    cfg = LlamaConfig.tiny(num_layers=2, max_len=TIER_LEN,
                           dtype=torch.float32)
    cpu = LlamaModel(cfg, device="cpu", seed=seed)
    card = LlamaModel(cfg, device=dev, seed=seed)
    card.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(seed + 20)
    V = cfg.vocab_size
    out, toks = {}, {"cpu": {}, "card": {}}

    def same(what, a, b):
        if not np.array_equal(np.asarray(a), np.asarray(b)):
            raise AssertionError(f"20a {what}: {a} against {b}")

    def engine(m, name, **kw):
        return SlotEngine(m, n_slots=TIER_SLOTS, max_len=TIER_LEN,
                          warmup="sync", name=name, device=m.device, **kw)
    # llama_from_pretrained on a directory written here
    path = os.path.join(root, "tiny_hf")
    write_hf_llama(path, cpu, hf_config(cfg))
    ids = torch.as_tensor(rng.integers(1, V, (2, 24)).astype(np.int32))
    with torch.no_grad():
        lc = llama_from_pretrained(path, dtype=torch.float32,
                                   device="cpu")(ids)
        ld = llama_from_pretrained(path, dtype=torch.float32,
                                   device=dev)(ids.to(dev)).cpu()
        want = cpu(ids)
    out["pretrained_max_abs_err"] = float((lc - ld).abs().max())
    if out["pretrained_max_abs_err"] > 1e-4 or not torch.equal(lc, want):
        raise AssertionError(f"20a pretrained: card {out} and CPU "
                             f"{float((lc - want).abs().max())}")
    qc, qd = quantize_int8(cpu), quantize_int8(card)
    for k, v in qc.state_dict().items():
        if not torch.equal(v, qd.state_dict()[k].cpu()):
            raise AssertionError(f"20a quantize_int8: {k} differs")
    p_int8 = [rng.integers(1, V, n).astype(np.int32) for n in (9, 17, 30, 6)]
    p1 = rng.integers(1, V, 20).astype(np.int32)
    suffix = rng.integers(1, V, 7).astype(np.int32)
    p_long = rng.integers(1, V, 26).astype(np.int32)
    rows = np.stack([np.tile(rng.integers(1, V, 4), 3),
                     rng.integers(1, V, 12)]).astype(np.int32)
    for d, m, q in (("cpu", cpu, qc), ("card", card, qd)):
        L.reset()
        t = toks[d]
        eng = engine(q, f"p20a-int8-{d}")
        t["int8"] = drive(eng, p_int8, [12] * 4)["outs"]
        for i, p in enumerate(p_int8):
            same(f"int8 {d} request {i}", t["int8"][i],
                 generate(q, p[None], max_new_tokens=12)[0])
        arena = HostKVArena(1 << 24, name=f"p20a-arena-{d}")
        e1 = engine(m, f"p20a-arena-{d}", kv_arena=arena)
        r1 = e1.admit(p1, 8)
        o1 = e1.run_to_completion()[r1.slot]
        p2 = np.concatenate([p1, o1, suffix])
        e2 = engine(m, f"p20a-arena-{d}", kv_arena=arena)
        r2 = e2.admit(p2, 8)
        if r2.reused_tokens != len(p1) + 7 or e2.restore_count != 1:
            raise AssertionError(f"20a {d}: no restore ({r2})")
        t["restore"] = e2.run_to_completion()[r2.slot]
        same(f"restore {d}", t["restore"],
             generate(m, p2[None], max_new_tokens=8)[0])
        e3 = engine(m, f"p20a-preempt-{d}",
                    kv_arena=HostKVArena(1 << 24, name=f"p20a-pre-{d}"))
        r3 = e3.admit(p_long, 16)
        for _ in range(5):
            e3.step()
        ticket = e3.preempt(r3.slot)
        slot = e3.resume(ticket)
        if e3.restore_count != 1:
            raise AssertionError(f"20a {d}: resume did not restore")
        e3.run_to_completion()
        t["resume"] = e3.generated_ids(slot)
        same(f"resume {d}", t["resume"],
             generate(m, p_long[None], max_new_tokens=16)[0])
        if d == "card":
            out["launches"] = L.shapes("paged_decode_attention")
            if dev.type == "cuda" and not out["launches"]:
                raise AssertionError("20a: K3 never launched on the card")
        for e in (eng, e2, e3):
            if e.compile_plane.stalls:
                raise AssertionError(f"20a {d}: a stall")
        sp, st = generate_speculative(m, rows, max_new_tokens=14,
                                      draft_len=4)
        t["spec"] = sp
        same(f"speculative {d}", sp, generate(m, rows, max_new_tokens=14))
        t["spec_stats"] = st
    words = [f"w{i}" for i in range(300)]
    tok = WordTokenizer.fit([" ".join(words[i:i + 30])
                             for i in range(0, 300, 30)], vocab_size=V)
    # distinct lengths: the stage calls generate once per prompt, as here
    texts = [" ".join(rng.choice(words, n)) for n in (4, 6, 8)]
    for d, m in (("cpu", cpu), ("card", card)):
        got = LLMTransformer(bundle={"model": m, "tokenizer": tok},
                             maxNewTokens=6).transform(
            Dataset({"prompt": texts}))["completion"]
        enc = [[t for t in row if t] for row in
               tok.encode(texts, TIER_LEN - 6)[0]]
        exp = [tok.decode(generate(m, np.asarray([e], np.int32),
                                   max_new_tokens=6))[0] for e in enc]
        if list(got) != exp:
            raise AssertionError(f"20a LLMTransformer {d}: {got} vs {exp}")
        toks[d]["stage"] = list(got)
    for k in ("restore", "resume", "spec", "stage"):
        same(f"{k} card vs CPU", toks["card"][k], toks["cpu"][k])
    for i in toks["cpu"]["int8"]:
        same(f"int8 card vs CPU {i}", toks["card"]["int8"][i],
             toks["cpu"]["int8"][i])
    if toks["card"]["spec_stats"] != toks["cpu"]["spec_stats"]:
        raise AssertionError("20a speculative stats differ")
    out["spec_stats"] = toks["card"]["spec_stats"]
    # the SIGKILL failover on the card
    jdir = os.path.join(root, "journal")
    weights = os.path.join(root, "tiny.pt")
    torch.save(cpu.state_dict(), weights)
    pk = rng.integers(1, V, 10).astype(np.int32)
    env = dict(os.environ, P20_WEIGHTS=weights, P20_JDIR=jdir,
               P20_P1=json.dumps([int(t) for t in pk]),
               P20_SLOTS=str(TIER_SLOTS), P20_LEN=str(TIER_LEN),
               P20_DEVICE=str(dev),
               PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    env.pop("SML_FAULTS", None)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", _TIER_CHILD],
                          capture_output=True, text=True, timeout=300,
                          env=env, cwd=root)
    out["child_s"] = time.perf_counter() - t0
    if proc.returncode != -9 or "UNREACHABLE" in proc.stdout:
        raise AssertionError(f"20a child: rc {proc.returncode} "
                             f"{proc.stdout[-500:]} {proc.stderr[-2000:]}")
    turn1 = json.loads(next(ln for ln in proc.stdout.splitlines()
                            if ln.startswith("TURN1")).split(None, 1)[1])
    ref1 = generate(card, pk[None], max_new_tokens=5)[0]
    same("failover turn 1", turn1, ref1)
    pk2 = np.concatenate([pk, ref1, [3, 1, 4, 1, 5]]).astype(np.int32)
    ref2 = generate(card, pk2[None], max_new_tokens=8)[0]
    st = SessionJournal(jdir, name="p20a-probe").replay("conv")
    if st.prompt != [int(t) for t in pk2] or \
            st.committed != [int(t) for t in ref2[:3]]:
        raise AssertionError(f"20a journal after the kill: {st}")
    srv = LLMServer(card, n_slots=TIER_SLOTS, max_len=TIER_LEN,
                    journal_dir=jdir, warmup="sync", device=dev,
                    engine_kwargs={"name": "p20a-failover"})
    try:
        L.reset()
        got, _, _ = http_generate(srv.url, {"session": "conv",
                                            "resume": True})
        out["launches_failover"] = L.shapes("paged_decode_attention")
    finally:
        srv.close()
    same("failover resume", got, ref2)
    out["failover_committed_before_kill"] = len(st.committed)
    shutil.rmtree(root, ignore_errors=True)
    return out


def depth_cut(model, layers: int):
    """A LlamaModel of ``model``'s first ``layers`` blocks, its embedding
    and final norm, sharing ``model``'s tensors."""
    from synapseml_tpu_torch.models.llm import LlamaModel
    cut = LlamaModel(dataclasses.replace(model.cfg, num_layers=layers),
                     device=model.device)
    keep = {k: v for k, v in model.state_dict().items()
            if not k.startswith("layers.") or int(k.split(".")[1]) < layers}
    cut.load_state_dict(keep, assign=True)
    return cut


#: phase 20b writes and reads back the first 2 of the 1B model's 16
#: blocks with its embedding (0.77 GB; the whole 2.47 GB took 2.3 s to
#: write and 10.1 s to read back on the H100's host), to make room for
#: phase 29
P20B_HF_LAYERS = 2


def pretrained_int8(model, prompts, new, dev, root: str,
                    config: dict = LLAMA_32_1B_CONFIG,
                    max_len: int = 2048,
                    turns=("int8", "bf16", "bf16", "int8"),
                    hf_layers: Optional[int] = None) -> dict:
    """Phase 20b: ``model``'s weights (Llama-3.2-1B in bf16), cut to its
    first ``hf_layers`` blocks (None: every block), written as an HF
    directory with Llama-3.2-1B's published config.json (its layer count
    cut alike), read back by ``llama_from_pretrained(..., max_len=2048)``
    (logits bitwise equal to the cut model's), then ``quantize_int8`` of
    ``model``: the logits' relative error against bf16 (the reference
    test's measure, < 0.05 at that test's configuration, reported at full
    width); phase 8's requests through a 16-slot graph engine, int8 and
    bf16 in ``turns``.  Removes the directory.  Raises on a failed
    check."""
    from synapseml_tpu_torch.models.llm import (LlamaConfig, LlamaModel,
                                                cast_params,
                                                llama_from_pretrained,
                                                quantize_int8)
    path = os.path.join(root, "llama32_1b_hf")
    out = {}
    written = model
    if hf_layers is not None and hf_layers < model.cfg.num_layers:
        written = depth_cut(model, hf_layers)
        config = dict(config, num_hidden_layers=hf_layers)
    out["hf_layers"] = written.cfg.num_layers
    t0 = time.perf_counter()
    out["file_bytes"] = write_hf_llama(path, written, config)
    out["write_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = cast_params(llama_from_pretrained(
        path, dtype=torch.bfloat16, max_len=max_len, device=dev),
        torch.bfloat16)
    synchronize(dev)
    out["load_s"] = time.perf_counter() - t0
    shutil.rmtree(path, ignore_errors=True)
    if loaded.cfg != written.cfg:
        raise AssertionError(f"20b config {loaded.cfg} against "
                             f"{written.cfg}")
    # the reference test's measure (tests/test_llm.py, the int8 tests):
    # max |int8 - bf16| over max |bf16| of the logits of 2 x 12 ids drawn
    # uniformly from the vocabulary, held below 0.05 at that test's
    # configuration (tiny, 4 layers, bf16) and reported at full width,
    # beside the same measure over the first 128 positions of two of the
    # requests
    tiny = cast_params(LlamaModel(LlamaConfig.tiny(max_len=64), device=dev),
                       torch.bfloat16)
    tid = torch.as_tensor(np.random.default_rng(0).integers(
        0, tiny.cfg.vocab_size, (2, 12)).astype(np.int32), device=dev)
    with torch.no_grad():
        full, quant = tiny(tid), quantize_int8(tiny)(tid)
    out["int8_rel_err_reference_config"] = float(
        (quant - full).abs().max() / full.abs().max())
    if not out["int8_rel_err_reference_config"] < 0.05:
        raise AssertionError(f"20b int8 relative error {out}")
    ids = torch.as_tensor(np.random.default_rng(0).integers(
        0, model.cfg.vocab_size, (2, 12)).astype(np.int32), device=dev)
    ids128 = torch.as_tensor(np.stack([prompts[0][:128], prompts[1][:128]]),
                             device=dev)
    with torch.no_grad():
        if not (torch.equal(loaded(ids), written(ids))
                and torch.equal(loaded(ids128), written(ids128))):
            raise AssertionError("20b: llama_from_pretrained's logits are "
                                 "not bitwise the model's")
        del loaded, written
        want, want128 = model(ids), model(ids128)
        t0 = time.perf_counter()
        q = quantize_int8(model)
        synchronize(dev)
        out["quantize_s"] = time.perf_counter() - t0
        got, got128 = q(ids), q(ids128)
    out["int8_rel_err"] = float((got - want).abs().max()
                                / want.abs().max())
    out["int8_rel_err_prompts_2x128"] = float(
        (got128 - want128).abs().max() / want128.abs().max())
    out["int8_weight_bytes"] = int(sum(
        p.numel() * p.element_size() for p in q.parameters()))
    out["bf16_weight_bytes"] = int(sum(
        p.numel() * p.element_size() for p in model.parameters()))
    runs, outs = {"int8": [], "bf16": []}, {}
    for label in turns:
        r, o = llm_main_path(q if label == "int8" else model, prompts, new,
                             0, warmup="sync")
        runs[label].append(r)
        outs.setdefault(label, o)
    out["agreement"] = float(np.mean([np.mean(outs["int8"][i]
                                              == outs["bf16"][i])
                                      for i in range(len(prompts))]))
    for label, rs in runs.items():
        out[label] = dict(
            decode_tokens_per_s=[r["decode_tokens_per_s"] for r in rs],
            mean_step_ms=[r["mean_step_ms"] for r in rs],
            ttft_p50_ms=[r["ttft_p50_ms"] for r in rs],
            k3_launches=[sum(r["launches"].values()) for r in rs],
            launches=rs[0]["launches"])
    if out["int8"]["k3_launches"][0] != out["bf16"]["k3_launches"][0]:
        raise AssertionError(f"20b K3 launches {out}")
    # where the int8 step's time goes, beside the bf16 step's
    for label, m in (("int8", q), ("bf16", model)):
        out[f"profile_{label}"] = profile_decode(m, prompts, new, "sync")
    return out


def arena_journal_http(model, prompts, new, dev, root: str,
                       http18_tokens_per_s: float,
                       name: str = "phase20") -> dict:
    """Phase 20c: ``LLMServer(n_slots=16, kv_arena_bytes=2 GiB,
    journal_dir=...)`` over phase 8's model; 24 two-turn conversations
    (turn 2 = turn 1's prompt + reply + 16 new tokens), all posted at
    once per turn, so the conversations whose slots were reclaimed
    restore from the host.  K3's counts are reset before turn 1 and read
    after turn 2.  Then a full-width slot preempted mid-decode and resumed
    from the arena must give the uninterrupted run's tokens bit for bit.
    Raises on a failed check."""
    from synapseml_tpu_torch.kernels import launches as L
    from synapseml_tpu_torch.models.llm import HostKVArena, SlotEngine
    from synapseml_tpu_torch.serving import LLMServer
    jdir = os.path.join(root, "journal_http")
    srv = LLMServer(model, n_slots=16, max_len=2048, kv_arena_bytes=2 << 30,
                    journal_dir=jdir, warmup="sync", device=dev,
                    engine_kwargs={"name": name})
    eng, jnl = srv.engine, srv.journal
    admits, appends = [], []
    real_admit, real_append = eng.admit, jnl.append_tokens

    def admit(ids, n, **kw):
        r0 = eng.restore_count
        t = time.perf_counter()
        r = real_admit(ids, n, **kw)
        admits.append((time.perf_counter() - t, eng.restore_count > r0,
                       len(ids), 0 if r is None else r.reused_tokens))
        return r

    def append(*a, **kw):
        t = time.perf_counter()
        real_append(*a, **kw)
        appends.append(time.perf_counter() - t)
    eng.admit, jnl.append_tokens = admit, append
    rng = np.random.default_rng(20)
    try:
        def sess(i):
            return {"session": f"c{i}"}
        L.reset()
        out1, _, wall1 = serve_all(srv, prompts, new, extra=sess)
        n1 = len(admits)
        p2 = [np.concatenate([p, o, rng.integers(1, model.cfg.vocab_size,
                                                 16)]).astype(np.int32)
              for p, o in zip(prompts, out1)]
        out2, _, wall2 = serve_all(srv, p2, new, extra=sess)
        shapes = L.shapes("paged_decode_attention")
        for i, p in enumerate(p2):
            st = jnl.replay(f"c{i}")
            if st.ids != [int(t) for t in p] + list(out2[i]):
                raise AssertionError(f"20c journal of c{i}: {st}")
    finally:
        srv.close()
        shutil.rmtree(jdir, ignore_errors=True)
    if eng.restore_count < 1 or (dev.type == "cuda" and not shapes):
        raise AssertionError(f"20c: {eng.restore_count} restores, K3 "
                             f"{shapes}")
    # the cold re-run covers the first 16 conversations, one wave of the
    # 16 slots (cut from all 24, two waves, to make room for phase 27)
    t0 = time.perf_counter()
    _, cold = llm_main_path(model, p2[:16], new[:16], 0, warmup="sync")
    cold_s = time.perf_counter() - t0
    agree = float(np.mean([np.mean(np.asarray(out2[i]) == cold[i])
                           for i in range(len(cold))]))
    restored = [a for a in admits[n1:] if a[1]]
    turn1 = admits[:n1]
    out = dict(
        restores=eng.restore_count, restored_tokens=eng.restore_tokens,
        restore_hits_turn2=len(restored),
        device_prefix_hits_turn2=sum(1 for a in admits[n1:]
                                     if a[3] and not a[1]),
        admit_ms_restored_p50=float(np.median([a[0] for a in restored])
                                    * 1e3),
        restored_prompt_tokens_p50=float(np.median([a[2]
                                                    for a in restored])),
        admit_ms_cold_turn1_p50=float(np.median([a[0] for a in turn1])
                                      * 1e3),
        cold_prompt_tokens_p50=float(np.median([a[2] for a in turn1])),
        spills=eng.spill_count,
        spill_ms_per_retirement=eng.spill_seconds / max(1, eng.spill_count)
        * 1e3,
        spill_bytes_per_retirement=eng.spill_bytes / max(1,
                                                         eng.spill_count),
        journal_appends=len(appends),
        journal_us_per_token=float(np.mean(appends) * 1e6),
        journal_us_per_token_p90=float(np.percentile(appends, 90) * 1e6),
        http_tokens_per_s_turn1=sum(len(o) for o in out1) / wall1,
        http_tokens_per_s_turn2=sum(len(o) for o in out2) / wall2,
        http_tokens_per_s_phase18=http18_tokens_per_s,
        turn2_agreement_with_cold=agree, cold_conversations=len(cold),
        cold_s=cold_s, launches=shapes)
    # a full-width slot preempted mid-decode, resumed from the arena
    arena = HostKVArena(2 << 30, name=f"{name}-preempt")
    ref = SlotEngine(model, n_slots=16, warmup="sync", device=dev,
                     name=f"{name}-uninterrupted")
    want = drive(ref, prompts[:17], new[:17])["outs"]
    e = SlotEngine(model, n_slots=16, warmup="sync", kv_arena=arena,
                   device=dev, name=f"{name}-preempt")
    slots = [e.admit(p, n).slot for p, n in zip(prompts[:16], new[:16])]
    for _ in range(min(new[:16]) // 3):       # a third of the budget
        e.step()
    victim = int(np.argmax([len(p) for p in prompts[:16]]))
    t0 = time.perf_counter()
    ticket = e.preempt(slots[victim])
    out["preempt_ms"] = (time.perf_counter() - t0) * 1e3
    other = e.admit(prompts[16], new[16])        # takes the freed slot
    while not e.free_slot_count:
        e.step()
    t0 = time.perf_counter()
    slot = e.resume(ticket)
    out["resume_ms"] = (time.perf_counter() - t0) * 1e3
    if e.restore_count != 1 or other.slot != slots[victim]:
        raise AssertionError(f"20c preempt: {e.restore_count} restores")
    e.run_to_completion()
    out["preempt_span_tokens"] = int(ticket["kv_len"])
    if not np.array_equal(e.generated_ids(slot), want[victim]):
        raise AssertionError(f"20c preempt/resume: {e.generated_ids(slot)} "
                             f"against {want[victim]}")
    if e.compile_plane.stalls:
        raise AssertionError("20c: a stall")
    return out


# -- phase 21: ONNX batch inference and the image stages ---------------------

#: bench.py's ResNet-50 configuration (``bench_resnet50``): batch 32 of
#: 3x224x224, 1,000 classes, seed 0, 60 dispatches a window
ONNX_BATCH, ONNX_HW, ONNX_STEPS = 32, 224, 60
#: ImageNet's channel statistics, the usual ImageFeaturizer preprocessing
IMAGENET_STATS = ([0.485, 0.456, 0.406], [0.229, 0.224, 0.225])


def random_bert_state_dict(seed: int, vocab_size: int, d_model: int,
                           num_layers: int, intermediate: int,
                           num_labels: int, max_positions: int = 512,
                           std: float = 0.02) -> dict:
    """A BertForSequenceClassification state dict under HF's tensor names,
    drawn from ``seed`` with numpy (normal(0, ``std``) matrices,
    embeddings and biases, LayerNorm gains 1 + normal(0, ``std``)) — what
    the zoo's ``build_bert_classifier`` takes, without ``transformers``."""
    rng = np.random.default_rng(seed)
    sd = {}

    def normal(*shape):
        return (rng.normal(size=shape) * std).astype(np.float32)

    def dense(name, n_out, n_in):
        sd[name + ".weight"] = normal(n_out, n_in)
        sd[name + ".bias"] = normal(n_out)

    def norm(name):
        sd[name + ".weight"] = 1 + normal(d_model)
        sd[name + ".bias"] = normal(d_model)

    sd["bert.embeddings.word_embeddings.weight"] = normal(vocab_size, d_model)
    sd["bert.embeddings.position_embeddings.weight"] = normal(max_positions,
                                                              d_model)
    sd["bert.embeddings.token_type_embeddings.weight"] = normal(2, d_model)
    norm("bert.embeddings.LayerNorm")
    for i in range(num_layers):
        p = f"bert.encoder.layer.{i}."
        for name in ("query", "key", "value"):
            dense(p + "attention.self." + name, d_model, d_model)
        dense(p + "attention.output.dense", d_model, d_model)
        norm(p + "attention.output.LayerNorm")
        dense(p + "intermediate.dense", intermediate, d_model)
        dense(p + "output.dense", d_model, intermediate)
        norm(p + "output.LayerNorm")
    dense("bert.pooler.dense", d_model, d_model)
    dense("classifier", num_labels, d_model)
    return sd


def onnx_small_cnn(seed: int) -> bytes:
    """A small conv/BN/pool/gemm ONNX graph (16x16 images, 5 classes)."""
    from synapseml_tpu_torch.models.onnx import GraphBuilder
    rng = np.random.default_rng(seed)
    b = GraphBuilder("cnn")
    x = b.input("image", (None, 3, 16, 16))
    h = b.node("Conv", [x, b.initializer(
        "w1", (rng.normal(size=(8, 3, 3, 3)) * 0.3).astype(np.float32)),
        b.initializer("b1", rng.normal(size=8).astype(np.float32))],
        kernel_shape=[3, 3], pads=[1, 0, 2, 1])
    h = b.node("BatchNormalization", [h] + [b.initializer(
        k, v) for k, v in (("s", rng.uniform(0.5, 1.5, 8)),
                           ("bb", rng.normal(size=8)),
                           ("m", rng.normal(size=8)),
                           ("v", rng.uniform(0.5, 2, 8)))], epsilon=1e-5)
    h = b.node("Relu", [h])
    h = b.node("MaxPool", [h], kernel_shape=[3, 3], strides=[2, 2],
               pads=[1, 1, 1, 1])
    h = b.node("AveragePool", [h], kernel_shape=[2, 2], pads=[0, 0, 1, 1])
    h = b.node("Flatten", [b.node("GlobalAveragePool", [h])], axis=1)
    b.output(b.node("Gemm", [h, b.initializer(
        "wf", rng.normal(size=(5, 8)).astype(np.float32)), b.initializer(
        "bf", rng.normal(size=5).astype(np.float32))], transB=1,
        outputs=["logits"]))
    return b.build()


def _scale_err(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.abs(got.astype(np.float64) - want).max()
                 / max(1.0, float(np.abs(want).max())))


def onnx_card_vs_cpu(dev, seed: int, resnet: bytes) -> dict:
    """21a: the small CNN, a tiny BERT classifier (2 layers, 32 wide, a
    padded mask) and ResNet-50 on one 3x64x64 image, f32 and bf16, and the
    image stages, on ``dev`` against the port's CPU path → the largest
    differences over scale.  Raises past f32 1e-5 (ResNet-50 1e-4, argmax
    equal), bf16 2e-2 (BERT 5e-2), stages 1e-5.  Also the bf16 products
    whose float32 result is kept (a bias or scale follows): MatMul/Gemm's
    and a convolution's on bf16 operands against the CPU's float32
    product of the same values, within 1e-5 (a result rounded to bf16
    would be off by ~1e-3)."""
    import torch.nn.functional as F
    from synapseml_tpu_torch.core import Dataset
    from synapseml_tpu_torch.device import full_f32
    from synapseml_tpu_torch.image import ImageTransformer
    from synapseml_tpu_torch.models.onnx import compile_onnx, ops, zoo
    rng = np.random.default_rng(seed)
    out = {}

    def bf16(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(
            np.float32)).bfloat16()

    a, b, a3 = bf16(64, 256), bf16(256, 96), bf16(4, 64, 256)
    x, w = bf16(2, 64, 14, 14), bf16(32, 64, 3, 3)
    with full_f32():
        products = {
            "mm_bf16_f32out": (ops.matmul_f32(a.to(dev), b.to(dev)),
                               a.float() @ b.float()),
            "bmm_bf16_f32out": (ops.matmul_f32(a3.to(dev), a3.to(dev).mT),
                                a3.float() @ a3.float().mT),
            "conv_bf16_f32out": (ops._conv_f32(F.conv2d, x.to(dev),
                                               w.to(dev), padding=1),
                                 F.conv2d(x.float(), w.float(), padding=1))}
    for label, (got, want) in products.items():
        if got.dtype != torch.float32:
            raise AssertionError(f"21a {label}: {got.dtype}")
        out[label] = _scale_err(got.cpu().numpy(), want.numpy())
        if out[label] > 1e-5:
            raise AssertionError(f"21a {label}: {out[label]} > 1e-5")
    sd = random_bert_state_dict(seed, vocab_size=120, d_model=32,
                                num_layers=2, intermediate=64,
                                num_labels=3, max_positions=64)
    mask = np.ones((4, 10), np.float32)
    mask[1, 6:] = 0
    mask[3, 3:] = 0
    cases = {
        "cnn": (onnx_small_cnn(seed), {"image": rng.normal(
            size=(4, 3, 16, 16)).astype(np.float32)}, 1e-5, 2e-2),
        "bert_tiny": (zoo.build_bert_classifier(sd, num_layers=2,
                                                num_heads=4, seq_len=10),
                      {"input_ids": rng.integers(0, 120, (4, 10)),
                       "attention_mask": mask}, 1e-5, 5e-2),
        "resnet50_64": (resnet, {"data": rng.normal(
            size=(1, 3, 64, 64)).astype(np.float32)}, 1e-4, 2e-2)}
    for name, (payload, feeds, tol32, tol16) in cases.items():
        for dt, tol in ((None, tol32), ("bfloat16", tol16)):
            got = {}
            for d in (dev, torch.device("cpu")):
                fn = compile_onnx(payload, dtype=dt, device=d)
                got[d.type] = {k: v.float().cpu().numpy()
                               for k, v in fn(**feeds).items()}
            for k, want in got["cpu"].items():
                err = _scale_err(got[dev.type][k], want)
                label = f"{name}_{'f32' if dt is None else 'bf16'}"
                out[label] = err
                if err > tol:
                    raise AssertionError(f"21a {label}: card vs CPU {err} "
                                         f"> {tol}")
                if name == "resnet50_64" and dt is None and \
                        got[dev.type][k].argmax() != want.argmax():
                    raise AssertionError("21a resnet50 f32 argmax differs")
    imgs = [rng.uniform(0, 255, (40, 52, 3)).astype(np.float32)
            for _ in range(4)]
    stages = []
    for d in (dev.type, "cpu"):
        prep = (ImageTransformer(inputCol="img", outputCol="t", device=d)
                .resize(36, 40).center_crop(32, 32).blur(5, 1.2).flip(1)
                .normalize(*IMAGENET_STATS))
        stages.append(np.stack(list(prep.transform(
            Dataset({"img": imgs}))["t"])))
    out["image_stages"] = _scale_err(*stages)
    if out["image_stages"] > 1e-5:
        raise AssertionError(f"21a image stages: {out['image_stages']}")
    return out


def onnx_conv_flops(payload: bytes, hw: int, dev) -> float:
    """Forward flops of one ``hw``² image, counted from the shapes of every
    Conv and Gemm node's output (2·Cin/group·kh·kw per output element of
    a convolution, 2·in per output of a Gemm)."""
    from synapseml_tpu_torch.models.onnx import load_graph
    from synapseml_tpu_torch.models.onnx.runner import evaluate
    g = load_graph(payload)
    nodes = [n for n in g.nodes if n.op_type in ("Conv", "Gemm")]
    outs = evaluate(g, {g.input_names[0]: np.zeros((1, 3, hw, hw),
                                                   np.float32)},
                    [n.outputs[0] for n in nodes], device=dev)
    total = 0.0
    for n in nodes:
        w = g.initializers[n.inputs[1]]
        o = outs[n.outputs[0]]
        per_out = (2.0 * np.prod(w.shape[1:]) if n.op_type == "Conv"
                   else 2.0 * w.shape[1 if n.attrs.get("transB") else 0])
        total += per_out * o.numel()
    return total


def onnx_windows(fns: dict, inputs: dict, batch: int, steps: int,
                 windows: int = 3) -> dict:
    """Items/s of each ``fns[label](**inputs)`` as a median over
    ``windows`` rounds of ``steps`` dispatches, the labels in turns; a
    window ends in a read of one output value (the barrier)."""
    def run(fn):
        out = fn(**inputs)
        return next(iter(out.values())).reshape(-1)[:1].cpu()

    for fn in fns.values():
        run(fn)
    rates = {k: [] for k in fns}
    for _ in range(windows):
        for label, fn in fns.items():
            t0 = time.perf_counter()
            for _ in range(steps - 1):
                fn(**inputs)
            run(fn)
            rates[label].append(steps * batch / (time.perf_counter() - t0))
    return {k: dict(per_s=sorted(v)[len(v) // 2], windows=v,
                    step_ms=batch / sorted(v)[len(v) // 2] * 1e3)
            for k, v in rates.items()}


def onnx_transform_split(model, ds, dev) -> dict:
    """One ``model.transform(ds)`` timed (wall), then one under
    ``torch.profiler``: the device's kernel ms over the transform and the
    rest of the profiled wall (host work the device waited on)."""
    from torch.profiler import ProfilerActivity, profile
    synchronize(dev)
    t0 = time.perf_counter()
    out = model.transform(ds)
    wall = time.perf_counter() - t0
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if dev.type == "cuda" else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        model.transform(ds)
        pwall = time.perf_counter() - t0
    dev_ms = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    return dict(out=out, wall_s=wall, per_s=ds.num_rows / wall,
                profiled_wall_s=pwall, device_ms=dev_ms,
                host_ms=pwall * 1e3 - dev_ms,
                device_share=dev_ms / (pwall * 1e3))


def onnx_image(seed: int, dev, card: str, resnet: bytes,
               batch: int = ONNX_BATCH, hw: int = ONNX_HW,
               steps: int = ONNX_STEPS, n_rows: int = 1024,
               mini_batch: int = 128, n_images: int = 512,
               img_hw=(256, 320), resize_to: int = 256,
               bert_layers: int = 12, bert_width: int = 768,
               bert_heads: int = 12, bert_seq: int = 128,
               bert_vocab: int = 30522, bert_batch: int = 64,
               bert_steps: int = 20) -> dict:
    """Phase 21 (b-f).  Raises on a failed check."""
    from synapseml_tpu_torch.core import Dataset
    from synapseml_tpu_torch.image import ImageTransformer
    from synapseml_tpu_torch.models.onnx import (ImageFeaturizer, ONNXModel,
                                                 compile_onnx, load_graph, zoo)
    res = {}
    rng = np.random.default_rng(seed)
    # 21b. bench.py's ResNet-50 window through compile_onnx
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(batch, 3, hw, hw)).astype(np.float32)).to(dev)
    fns = {"f32": compile_onnx(resnet, device=dev),
           "bf16": compile_onnx(resnet, dtype="bfloat16", device=dev)}
    res["flops_per_image"] = onnx_conv_flops(resnet, hw, dev)
    win = onnx_windows(fns, {"data": x}, batch, steps)
    for label, fn in fns.items():
        plan = fn.plan(["data"])
        peak = PEAK_OPS_S if label == "f32" else PEAK_BF16_S
        win[label].update(
            folded_nodes=plan.n_folded, per_call_nodes=plan.n_per_call,
            uploads_per_call=plan.uploads,
            tflops=win[label]["per_s"] * res["flops_per_image"] / 1e12,
            share_of_peak=win[label]["per_s"] * res["flops_per_image"]
            / peak)
        if plan.uploads:
            raise AssertionError(f"21b {label}: {plan.uploads} uploads a "
                                 "call")
    res["resnet50_window"] = win
    log(f"phase 21b: ResNet-50 b{batch} {hw}² compile_onnx | {card}: "
        + "; ".join(f"{k} {v['per_s']:.1f} images/s, step "
                    f"{v['step_ms']:.3f} ms, {v['tflops']:.2f} TFLOP/s "
                    f"({v['share_of_peak']:.3f} of peak), folded "
                    f"{v['folded_nodes']} / per call {v['per_call_nodes']}"
                    for k, v in win.items()))
    # 21f. a profile of the bf16 window
    bf = fns["bf16"]
    res["resnet50_bf16_profile"] = profile_steps(
        lambda: bf(data=x)["logits"][0, 0], n=5)
    log(f"phase 21f: ResNet-50 bf16 b{batch} profile | {card}: "
        f"{json.dumps(res['resnet50_bf16_profile'])}")
    del fns, bf, x
    # 21c. ONNXModel.transform over a Dataset of images
    imgs = rng.standard_normal((n_rows, 3, hw, hw), dtype=np.float32)
    ds = Dataset({"image": list(imgs)})
    g = load_graph(resnet)
    feat = [n for n in g.nodes if n.op_type == "Gemm"][-1].inputs[0]
    trans = {}
    for label in ("f32", "bf16"):
        m = ONNXModel(resnet, feedDict={"data": "image"},
                      fetchDict={"logits": "logits"},
                      miniBatchSize=mini_batch,
                      dtype="float32" if label == "f32" else "bfloat16",
                      device=str(dev))
        m.transform(Dataset({"image": list(imgs[:mini_batch])}))  # plan
        r = onnx_transform_split(m, ds, dev)
        logits = np.stack(list(r.pop("out")["logits"]))
        if logits.shape != (n_rows, 1000) or not np.isfinite(logits).all():
            raise AssertionError(f"21c {label}: logits {logits.shape}")
        trans[label] = r
        trans[label + "_argmax"] = logits.argmax(1)
    res["onnxmodel_agreement"] = float(
        (trans.pop("f32_argmax") == trans.pop("bf16_argmax")).mean())
    res["onnxmodel_transform"] = trans
    log(f"phase 21c: ONNXModel.transform {n_rows} images {hw}² "
        f"miniBatchSize {mini_batch} | {card}: "
        + "; ".join(f"{k} {v['per_s']:.1f} images/s (wall "
                    f"{v['wall_s']:.3f} s; profiled: device "
                    f"{v['device_ms']:.1f} ms, host {v['host_ms']:.1f} ms, "
                    f"device share {v['device_share']:.3f})"
                    for k, v in trans.items())
        + f"; f32/bf16 argmax agreement {res['onnxmodel_agreement']:.4f}")
    del ds, imgs
    # 21d. ImageTransformer then the headless ImageFeaturizer
    raw = [im for im in rng.uniform(0, 255, (n_images, *img_hw, 3)).astype(
        np.float32)]
    raw_ds = Dataset({"img": raw})
    prep = (ImageTransformer(inputCol="img", outputCol="t", device=str(dev))
            .resize(resize_to, resize_to).center_crop(hw, hw)
            .normalize(*IMAGENET_STATS))
    fz = ImageFeaturizer(ONNXModel(resnet), inputCol="t",
                         featureTensorName=feat, miniBatchSize=mini_batch,
                         device=str(dev))
    fz.transform(prep.transform(Dataset({"img": raw[:mini_batch]})))
    synchronize(dev)
    t0 = time.perf_counter()
    tensors = prep.transform(raw_ds)
    t1 = time.perf_counter()
    feats = fz.transform(tensors)
    t2 = time.perf_counter()
    f = np.stack(list(feats["features"]))
    sliced = (ONNXModel(resnet, miniBatchSize=mini_batch, device=str(dev))
              .slice_at_output(feat).set_feed_dict({"data": "t"}))
    ref = np.stack(list(sliced.transform(tensors)[feat])).reshape(f.shape)
    res["featurizer"] = dict(
        features_per_s=n_images / (t2 - t0), prep_s=t1 - t0,
        featurize_s=t2 - t1, dim=int(f.shape[1]),
        vs_sliced_model=_scale_err(f, ref))
    if f.shape != (n_images, 2048) or res["featurizer"]["vs_sliced_model"] \
            > 1e-6:
        raise AssertionError(f"21d: features {f.shape}, "
                             f"{res['featurizer']['vs_sliced_model']}")
    log(f"phase 21d: ImageTransformer (resize {resize_to}, center crop {hw}, "
        f"normalize) + headless ImageFeaturizer over {n_images} "
        f"{img_hw[0]}x{img_hw[1]} images | {card}: "
        f"{json.dumps(res['featurizer'])}")
    del raw, raw_ds, tensors, feats
    # 21e. a BERT-base-width ONNX classifier
    sd = random_bert_state_dict(seed, vocab_size=bert_vocab,
                                d_model=bert_width, num_layers=bert_layers,
                                intermediate=4 * bert_width, num_labels=2)
    payload = zoo.build_bert_classifier(sd, num_layers=bert_layers,
                                        num_heads=bert_heads,
                                        seq_len=bert_seq)
    del sd
    ids = torch.from_numpy(rng.integers(0, bert_vocab, (bert_batch, bert_seq))
                           ).to(dev)
    lens = rng.integers(bert_seq // 4, bert_seq + 1, bert_batch)
    mask = torch.from_numpy((np.arange(bert_seq)[None] < lens[:, None])
                            .astype(np.float32)).to(dev)
    bert = {"f32": compile_onnx(payload, device=dev),
            "bf16": compile_onnx(payload, dtype="bfloat16", device=dev)}
    win = onnx_windows(bert, {"input_ids": ids, "attention_mask": mask},
                       bert_batch, bert_steps)
    logits = {k: fn(input_ids=ids, attention_mask=mask)["logits"].float()
              .cpu().numpy() for k, fn in bert.items()}
    win["argmax_agreement"] = float((logits["f32"].argmax(1)
                                     == logits["bf16"].argmax(1)).mean())
    win["bf16_vs_f32"] = _scale_err(logits["bf16"], logits["f32"])
    if not all(np.isfinite(v).all() for v in logits.values()) or \
            win["bf16_vs_f32"] > 5e-2:
        raise AssertionError(f"21e: bf16 against f32 {win['bf16_vs_f32']}")
    res["bert_base"] = win
    # phase 23d serves this classifier beside the GBDT
    res["bert"] = dict(payload=payload, seq=bert_seq, vocab=bert_vocab)
    log(f"phase 21e: BERT-base-width ONNX classifier ({bert_layers} layers, "
        f"{bert_width}, {bert_heads} heads, seq {bert_seq}, vocab "
        f"{bert_vocab}) b{bert_batch} | {card}: "
        f"f32 {win['f32']['per_s']:.1f} sequences/s (step "
        f"{win['f32']['step_ms']:.2f} ms), bf16 {win['bf16']['per_s']:.1f} "
        f"(step {win['bf16']['step_ms']:.2f} ms), argmax agreement "
        f"{win['argmax_agreement']:.4f}, bf16 vs f32 {win['bf16_vs_f32']:.4g}")
    return res


# -- phase 22: the explainers and the classic estimators ---------------------

#: phase 22's public shapes: SIFT1M (ANN-benchmarks' sift-128-euclidean,
#: k = its ground truth's depth), the Credit Card Fraud dataset,
#: MovieLens-1M, and one access-anomaly tenant
SIFT_N, SIFT_D, SIFT_Q, SIFT_K = 1_000_000, 128, 10_000, 100
FRAUD_N, FRAUD_D = 284_807, 30
ML_USERS, ML_ITEMS, ML_RATINGS = 6_040, 3_706, 1_000_209
AA_USERS, AA_RES, AA_TRIPLES = 20_000, 5_000, 1_000_000


def a6_models():
    """The host models 22a explains (numpy, so both devices score the same
    values and only the explainers' device work differs)."""
    from synapseml_tpu_torch.core import Transformer

    class Logistic(Transformer):
        def _transform(self, ds):
            x = np.stack([ds[c].astype(np.float64) for c in "abcd"], 1)
            p = 1.0 / (1.0 + np.exp(-(x @ np.array([2.0, -3.0, 0.5, 0.0])
                                      + 0.25)))
            return ds.with_column("probability",
                                  [np.array([1 - v, v]) for v in p])

    class VectorScore(Transformer):
        def _transform(self, ds):
            m = np.stack([np.asarray(v, np.float64) for v in ds["features"]])
            return ds.with_column("score", m[:, 0] + 2 * m[:, 2] - m[:, 3])

    class TokenScore(Transformer):
        def _transform(self, ds):
            return ds.with_column("score", np.array(
                [1.0 * ("good" in t.split()) - 0.5 * ("bad" in t.split())
                 for t in map(str, ds["text"])]))

    class Bright(Transformer):
        def _transform(self, ds):
            return ds.with_column("score", np.array(
                [np.asarray(v, np.float64)[:16, :16].mean()
                 for v in ds["image"]]))

    return Logistic, VectorScore, TokenScore, Bright


def blocky_images(rng, n: int, hw: int, block: int) -> list:
    """Flat random blocks plus mild noise, 0-255 HWC float32."""
    out = []
    for _ in range(n):
        low = rng.uniform(0, 255, (hw // block, hw // block, 3))
        img = np.kron(low, np.ones((block, block, 1))).astype(np.float32)
        out.append(img + rng.normal(0, 2, img.shape).astype(np.float32))
    return out


def ratings(rng, n_users: int, n_items: int, n: int) -> dict:
    """Timed 1-5 ratings: every user has 20 or more (as in MovieLens-1M)
    while ``n`` allows, user activity lognormal, item popularity
    Zipf-like."""
    act = rng.lognormal(0.0, 1.0, n_users)
    pop = rng.permutation(1.0 / (np.arange(n_items) + 10.0))
    base = np.repeat(np.arange(n_users), 20)[:n]
    users = np.concatenate([base, rng.choice(n_users, n - len(base),
                                             p=act / act.sum())])
    return {"user": users,
            "item": rng.choice(n_items, n, p=pop / pop.sum()),
            "rating": rng.integers(1, 6, n).astype(np.float32),
            "time": 9.6e8 + rng.uniform(0, 3 * 365 * 86400, n)}


def access_triples(rng, n_users: int, n_res: int, n: int,
                   n_groups: int = 50) -> dict:
    """One tenant's accesses: each user mostly reaches its group's pool of
    resources, sometimes any resource."""
    users = rng.integers(0, n_users, n)
    pool = n_res // n_groups
    res = (users % n_groups) * pool + rng.integers(0, pool, n)
    stray = rng.random(n) < 0.02
    res[stray] = rng.integers(0, n_res, int(stray.sum()))
    return {"tenant": np.full(n, "t0", dtype=object),
            "user": users.astype(str).astype(object),
            "res": res.astype(str).astype(object),
            "likelihood": rng.integers(1, 20, n).astype(np.float64)}


def a6_card_vs_cpu(dev, seed: int) -> dict:
    """Phase 22a: each module of the slice on ``dev`` and on the CPU, same
    inputs.  → {check: {"err", "limit"}}; raises when one is over."""
    import synapseml_tpu_torch.explainers as E
    from synapseml_tpu_torch.core import Dataset
    from synapseml_tpu_torch.cyber import AccessAnomaly
    from synapseml_tpu_torch.isolationforest import IsolationForest
    from synapseml_tpu_torch.nn import KNN
    from synapseml_tpu_torch.recommendation import SAR
    rng = np.random.default_rng(seed)
    devs = (str(dev), "cpu")
    out = {}

    def check(name, err, limit):
        out[name] = {"err": float(err), "limit": limit}

    # the batched solvers, B = 64 well-conditioned problems
    x = rng.normal(size=(64, 200, 10)).astype(np.float32)
    y = (x @ rng.normal(size=10) + 0.1 * rng.normal(size=(64, 200))
         ).astype(np.float32)
    w = rng.uniform(0.1, 1.0, (64, 200)).astype(np.float32)
    for name, fn in (("least_squares", E.solvers.least_squares_batched),
                     ("lasso", lambda *a, device: E.solvers.lasso_batched(
                         a[0], a[1], 0.05, a[2], device=device))):
        a, b = (fn(x, y, w, device=d).coefficients.cpu().numpy()
                for d in devs)
        check(name, _scale_err(a, b), 1e-6)

    # the explainers over host models: the solves run in float64 on both
    # devices (SHAP's efficiency sum within 1e-4 of the outputs' scale)
    Logistic, VectorScore, TokenScore, Bright = a6_models()
    tab = {c: rng.normal(size=8) for c in "abcd"}
    bg_tab = Dataset({c: rng.normal(size=64) for c in "abcd"})
    vec = {"features": list(rng.normal(size=(6, 5)))}
    bg_vec = Dataset({"features": list(rng.normal(size=(32, 5)))})
    text = {"text": np.array(["good film bad end", "a bad bad day",
                              "good good good", "plain words here"],
                             dtype=object)}
    imgs = {"image": blocky_images(rng, 2, 32, 8)}
    cases = {
        "tabular_lime": (E.TabularLIME, Logistic, tab, dict(
            inputCols=list("abcd"), backgroundData=bg_tab)),
        "tabular_shap": (E.TabularSHAP, Logistic, tab, dict(
            inputCols=list("abcd"), backgroundData=bg_tab)),
        "vector_lime": (E.VectorLIME, VectorScore, vec, dict(
            inputCol="features", targetCol="score", backgroundData=bg_vec)),
        "vector_shap": (E.VectorSHAP, VectorScore, vec, dict(
            inputCol="features", targetCol="score", backgroundData=bg_vec)),
        "text_lime": (E.TextLIME, TokenScore, text, dict(targetCol="score")),
        "text_shap": (E.TextSHAP, TokenScore, text, dict(targetCol="score")),
        "image_lime": (E.ImageLIME, Bright, imgs, dict(
            targetCol="score", cellSize=8.0, modifier=40.0)),
        "image_shap": (E.ImageSHAP, Bright, imgs, dict(
            targetCol="score", cellSize=8.0, modifier=40.0)),
    }
    for name, (cls, model, data, kw) in cases.items():
        a, b = (cls(model(), numSamples=128, seed=seed, device=d, **kw)
                .transform(Dataset(dict(data))) for d in devs)
        check(name, max(_scale_err(p, q) for p, q in
                        zip(a["explanation"], b["explanation"])), 1e-6)
        if name.endswith("shap"):
            fx = [float(np.asarray(v).ravel()[-1]) for v in
                  model().transform(Dataset(dict(data)))[kw.get(
                      "targetCol", "probability")]]
            check(name + "_efficiency", max(
                abs(e[0, 1:].sum() - (fx[i] - e[0, 0]))
                for i, e in enumerate(a["explanation"]))
                / max(1.0, max(map(abs, fx))), 1e-4)
        for col in ("superpixels", "tokens"):
            if col in a.columns and any(
                    not np.array_equal(np.asarray(p), np.asarray(q))
                    for p, q in zip(a[col], b[col])):
                raise AssertionError(f"22a {name}: {col} differ")
    ice = [E.ICETransformer(Logistic(), numericFeatures=["a", "b"],
                            numSplits=5).transform(Dataset(dict(tab)))
           for _ in devs]
    check("ice", _scale_err(np.stack(ice[0]["a_dependence"]),
                            np.stack(ice[1]["a_dependence"])), 0.0)

    # KNN 4,096 x 32: every point twice, queries among the points
    base = rng.normal(size=(2048, 32)).astype(np.float32)
    index = np.concatenate([base, base])
    queries = np.concatenate([index[::16], rng.normal(size=(256, 32)).astype(
        np.float32)])
    res = []
    for d in devs:
        m = KNN(k=10, leafSize=1024, device=d).fit(Dataset(
            {"features": index, "values": np.arange(len(index))}))
        res.append(m.transform(Dataset({"features": queries}))["output"])
    if any([e["value"] for e in p] != [e["value"] for e in q]
           for p, q in zip(*res)):
        raise AssertionError("22a: KNN neighbours differ card vs CPU")
    check("knn", max(abs(e["distance"] - f["distance"])
                     / max(f["distance"], 1e-30)
                     for p, q in zip(*res) for e, f in zip(p, q)), 1e-6)

    # an isolation forest on 10,000 x 8
    xf = rng.normal(size=(10_000, 8)).astype(np.float32)
    xf[:50] += 5.0
    sc = [IsolationForest(numEstimators=50, device=d).fit(
        Dataset({"features": xf})).transform(Dataset({"features": xf}))
        for d in devs]
    if not np.array_equal(sc[0]["predictedLabel"], sc[1]["predictedLabel"]):
        raise AssertionError("22a: isolation forest labels differ")
    check("isolation_forest", np.abs(sc[0]["outlierScore"]
                                     - sc[1]["outlierScore"]).max(), 1e-6)

    # SAR 500 users x 300 items; items 0-3 tied (bought by the same users)
    r = ratings(rng, 500, 296, 12_000)
    r["item"] = r["item"] + 4
    tied = np.repeat(np.arange(0, 500, 7), 4)
    for k in ("user", "item", "rating", "time"):
        extra = {"user": tied, "item": np.tile(np.arange(4), len(tied) // 4),
                 "rating": np.ones(len(tied), np.float32),
                 "time": np.full(len(tied), 9.6e8)}[k]
        r[k] = np.concatenate([r[k], extra])
    sars = [SAR(supportThreshold=2, timeCol="time", device=d).fit(
        Dataset(dict(r))) for d in devs]
    sims = [np.asarray(m.get("itemSimilarity")) for m in sars]
    check("sar_similarity", np.abs(sims[0] - sims[1]).max()
          / max(np.abs(sims[1]).max(), 1e-30), 1e-6)
    recs = [m.recommend_for_all_users(10)["recommendations"] for m in sars]
    if any([e["item"] for e in p] != [e["item"] for e in q]
           for p, q in zip(*recs)):
        raise AssertionError("22a: SAR top-10 differ card vs CPU")
    check("sar_scores", max((abs(e["rating"] - f["rating"])
                             / max(abs(f["rating"]), 1e-30)
                             for p, q in zip(*recs) for e, f in zip(p, q)),
                            default=0.0), 1e-6)

    # access-anomaly ALS on 400 users x 200 resources
    trip = access_triples(rng, 400, 200, 8_000, n_groups=8)
    aa = [AccessAnomaly(device=d).fit(Dataset(dict(trip))) for d in devs]
    s = [m.transform(Dataset(dict(trip)))["anomaly_score"] for m in aa]
    fin = np.isfinite(s[1])
    if not np.array_equal(fin, np.isfinite(s[0])):
        raise AssertionError("22a: ALS finite scores differ card vs CPU")
    check("als_scores", np.max(np.abs(s[0][fin] - s[1][fin])
                               / np.maximum(1.0, np.abs(s[1][fin]))), 1e-4)
    over = {k: v for k, v in out.items() if not v["err"] <= v["limit"]}
    if over:
        raise AssertionError(f"22a: card vs CPU over the limit: {over}; "
                             f"all checks: {out}")
    return out


def a6_paths(seed: int, dev, card: str, resnet: bytes, n_images: int = 8,
             lime_samples: int = 1000, img_hw: int = 224, lime_class: int = 7,
             gbdt_rows: int = 1_000_000, gbdt_iters: int = 100,
             n_explain: int = 256, tab_samples: int = 1000,
             knn_n: int = SIFT_N, knn_q: int = SIFT_Q, knn_k: int = SIFT_K,
             knn_check: int = 100, cknn_q: int = 1_000,
             fraud_n: int = FRAUD_N, ml=(ML_USERS, ML_ITEMS, ML_RATINGS),
             aa=(AA_USERS, AA_RES, AA_TRIPLES)) -> dict:
    """Phase 22 (b-g) at the public shapes (smaller ones for a CPU run).
    Only 22c's GBDT fit may launch a K-kernel (K1/K2, counted in
    ``res["gbdt"]["shapes"]``); every other step must launch none.
    Raises on a failed check."""
    import synapseml_tpu_torch.explainers as E
    from synapseml_tpu_torch.kernels import launches as L
    from synapseml_tpu_torch.core import Dataset, PipelineModel, Transformer
    from synapseml_tpu_torch.cyber import AccessAnomaly, access_anomaly
    from synapseml_tpu_torch.image import ImageTransformer
    from synapseml_tpu_torch.isolationforest import IsolationForest
    from synapseml_tpu_torch.models.gbdt.estimators import GBDTClassifier
    from synapseml_tpu_torch.models.onnx import ImageFeaturizer, ONNXModel
    from synapseml_tpu_torch.nn import KNN, ConditionalKNN
    from synapseml_tpu_torch.recommendation import RankingEvaluator, SAR
    rng = np.random.default_rng(seed + 22)
    d = str(dev)
    res = {}
    L.reset()

    def no_kernel(step: str) -> None:
        if L.BY_SHAPE:
            raise AssertionError(f"{step} launched {dict(L.BY_SHAPE)}")

    # 22b. ImageLIME over ResNet-50: normalize, then the logits
    stats = [[v * 255.0 for v in vs] for vs in IMAGENET_STATS]
    scorer = PipelineModel(stages=[
        ImageTransformer(inputCol="image", outputCol="t", device=d)
        .normalize(*stats),
        ImageFeaturizer(ONNXModel(resnet), inputCol="t", headless=False,
                        miniBatchSize=250, device=d)])
    imgs = blocky_images(rng, n_images, img_hw, 16)
    lime = E.ImageLIME(scorer, inputCol="image", targetCol="features",
                       targetClasses=[lime_class], numSamples=lime_samples,
                       cellSize=16.0, samplingFraction=0.7, seed=seed,
                       device=d)
    t0 = time.perf_counter()
    out = lime.transform(Dataset({"image": imgs}))
    wall_s = time.perf_counter() - t0
    coefs = np.stack([e[0] for e in out["explanation"]], 0)
    n_seg = [int(sp.max()) + 1 for sp in out["superpixels"]]
    if not np.all(np.isfinite(coefs)) or coefs.shape[0] != n_images:
        raise AssertionError(f"22b: explanations {coefs.shape}")
    res["image_lime"] = dict(
        images=n_images, samples=lime_samples, superpixels=n_seg,
        wall_s=wall_s, images_per_s=n_images / wall_s,
        samples_per_s=n_images * lime_samples / wall_s,
        **{f"{k}_s": v for k, v in lime.timings.items()},
        host_share=lime.timings["perturb"] / wall_s,
        mean_r2=float(np.mean([r[0] for r in out["r2"]])))
    log(f"phase 22b: ImageLIME over ResNet-50 ({n_images} {img_hw}² images, "
        f"{lime_samples} samples, cellSize 16) | {card}: "
        f"{json.dumps(res['image_lime'])}")

    # 22c. TabularSHAP and TabularLIME over a GBDT at bench.py's task
    X = rng.normal(size=(gbdt_rows, 28)).astype(np.float32)
    yv = gbdt_labels(rng, X)
    no_kernel("22b")
    t0 = time.perf_counter()
    gbdt = GBDTClassifier(numIterations=gbdt_iters, numLeaves=31,
                          device=d).fit(Dataset({"features": X,
                                                 "label": yv}))
    synchronize(dev)
    fit_s = time.perf_counter() - t0
    fit_shapes = dict(L.BY_SHAPE)
    L.reset()
    cols = [f"x{j}" for j in range(28)]

    class Assemble(Transformer):
        def _transform(self, ds):
            return ds.with_column("features", np.stack(
                [ds[c] for c in cols], 1).astype(np.float32))

    model = PipelineModel(stages=[Assemble(), gbdt])
    rows = Dataset({c: X[:n_explain, j] for j, c in enumerate(cols)})
    bg = Dataset({c: X[-2048:, j] for j, c in enumerate(cols)})
    fx = np.stack(model.transform(rows)["probability"])[:, 1]
    res["gbdt"] = dict(rows=gbdt_rows, iterations=gbdt_iters, fit_s=fit_s,
                       shapes=fit_shapes)
    for name, cls in (("tabular_shap", E.TabularSHAP),
                      ("tabular_lime", E.TabularLIME)):
        ex = cls(model, inputCols=cols, backgroundData=bg,
                 numSamples=tab_samples, seed=seed, device=d)
        t0 = time.perf_counter()
        o = ex.transform(rows)
        wall_s = time.perf_counter() - t0
        r = dict(rows=n_explain, samples=tab_samples, wall_s=wall_s,
                 rows_per_s=n_explain / wall_s,
                 scored_rows_per_s=n_explain * tab_samples / wall_s,
                 **{f"{k}_s": v for k, v in ex.timings.items()})
        if name == "tabular_shap":
            r["max_efficiency_residual"] = float(max(
                abs(e[0, 1:].sum() - (fx[i] - e[0, 0]))
                for i, e in enumerate(o["explanation"])))
            if r["max_efficiency_residual"] > 1e-3:
                raise AssertionError(f"22c: efficiency {r}")
        res[name] = r
    log(f"phase 22c: GBDT {gbdt_rows} x 28, {gbdt_iters} iterations, 31 "
        f"leaves, then SHAP and LIME over {n_explain} rows x {tab_samples} "
        f"samples | {card}: gbdt {json.dumps(res['gbdt'])} shap "
        f"{json.dumps(res['tabular_shap'])} lime "
        f"{json.dumps(res['tabular_lime'])}")
    del X, yv, gbdt, model
    no_kernel("22c's explainers")

    # 22d. KNN at SIFT1M's shape, held to a float64 brute force
    g = torch.Generator(device=dev).manual_seed(seed)
    index_t = torch.randn((knn_n, SIFT_D), generator=g, device=dev)
    index = index_t.cpu().numpy()
    queries = torch.randn((knn_q, SIFT_D), generator=g,
                          device=dev).cpu().numpy()
    knn = KNN(k=knn_k, leafSize=1024, device=d).fit(
        Dataset({"features": index}))
    knn.transform(Dataset({"features": queries[:16]}))  # warm-up
    synchronize(dev)
    t0 = time.perf_counter()
    found = knn.transform(Dataset({"features": queries}))["output"]
    knn_s = time.perf_counter() - t0
    q64 = torch.as_tensor(queries[:knn_check], dtype=torch.float64,
                          device=dev)
    d2 = torch.cat([((q64[:, None] - index_t[lo:lo + 65536].double()[None])
                     ** 2).sum(-1) for lo in range(0, knn_n, 65536)], 1)
    truth = torch.sort(d2, dim=1, stable=True).indices[:, :knn_k].cpu()
    sets_equal = all(set(truth[i].tolist()) ==
                     {e["value"] for e in found[i]} for i in range(knn_check))
    order_equal = sum(truth[i].tolist() == [e["value"] for e in found[i]]
                      for i in range(knn_check))
    del d2, q64
    if not sets_equal:
        raise AssertionError("22d: KNN top-k differs from float64 brute force")
    labels = rng.integers(0, 10, knn_n)
    cond = [list(rng.choice(10, size=int(c), replace=False))
            for c in rng.integers(1, 4, cknn_q)]
    cknn = ConditionalKNN(k=10, leafSize=1024, device=d).fit(
        Dataset({"features": index, "labels": labels}))
    t0 = time.perf_counter()
    cout = cknn.transform(Dataset({"features": queries[:cknn_q],
                                   "conditioner": cond}))["output"]
    cknn_s = time.perf_counter() - t0
    if any(e["label"] not in set(c) for c, row in zip(cond, cout)
           for e in row) or any(len(row) != 10 for row in cout):
        raise AssertionError("22d: conditional matches outside their labels")
    res["knn"] = dict(index=[knn_n, SIFT_D], queries=knn_q, k=knn_k,
                      transform_s=knn_s, queries_per_s=knn_q / knn_s,
                      checked=knn_check, sets_equal=sets_equal,
                      order_equal=order_equal, conditional_queries=cknn_q,
                      conditional_queries_per_s=cknn_q / cknn_s)
    log(f"phase 22d: KNN at SIFT1M's shape | {card}: "
        f"{json.dumps(res['knn'])}")
    del index_t, index, knn, cknn

    # 22e. isolation forest at the Credit Card Fraud dataset's shape
    xf = rng.normal(size=(fraud_n, FRAUD_D)).astype(np.float32)
    xf[:492] += 4.0                     # the dataset's 492 frauds
    t0 = time.perf_counter()
    forest = IsolationForest(numEstimators=100, maxSamples=256, seed=seed,
                             device=d).fit(Dataset({"features": xf}))
    fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sc = forest.transform(Dataset({"features": xf}))["outlierScore"]
    score_s = time.perf_counter() - t0
    if not (np.all((sc > 0) & (sc < 1))
            and sc[:492].mean() > sc[492:].mean()):
        raise AssertionError("22e: outlier scores")
    res["iforest"] = dict(rows=fraud_n, fit_s=fit_s, score_s=score_s,
                          rows_per_s=fraud_n / score_s,
                          fraud_mean=float(sc[:492].mean()),
                          rest_mean=float(sc[492:].mean()))
    log(f"phase 22e: isolation forest {fraud_n} x {FRAUD_D}, 100 trees "
        f"| {card}: {json.dumps(res['iforest'])}")

    # 22f. SAR at MovieLens-1M's shape, ndcg@10 on a held-out quarter
    r = ratings(rng, *ml)
    held = rng.random(len(r["user"])) < 0.25
    train = {k: v[~held] for k, v in r.items()}
    t0 = time.perf_counter()
    sar = SAR(timeCol="time", supportThreshold=4, device=d).fit(
        Dataset(train))
    fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    recs = sar.recommend_for_all_users(10)
    rec_s = time.perf_counter() - t0
    # each user's held-out items by rating desc, item asc, the top 10
    hu, hi, hr = r["user"][held], r["item"][held], r["rating"][held]
    order = np.lexsort((hi, -hr, hu))
    truth = {}
    for u, i in zip(hu[order], hi[order]):
        lst = truth.setdefault(int(u), [])
        if len(lst) < 10:
            lst.append(int(i))
    users = [int(u) for u in recs["user"] if int(u) in truth]
    rec_map = {int(u): [e["item"] for e in row] for u, row in
               zip(recs["user"], recs["recommendations"])}
    ev_ds = Dataset({"user": np.array(users),
                     "prediction": [[int(i) for i in rec_map[u]]
                                    for u in users],
                     "label": [truth[u] for u in users]})
    ndcg = RankingEvaluator(k=10, metricName="ndcgAt").evaluate(ev_ds)
    if not 0.0 < ndcg <= 1.0:
        raise AssertionError(f"22f: ndcg@10 {ndcg}")
    res["sar"] = dict(users=len(recs["user"]), items=int(len(
        sar.get("itemVocabulary"))), ratings=int((~held).sum()), fit_s=fit_s,
        recommend_s=rec_s, ndcg_at_10=ndcg, evaluated_users=len(users))
    log(f"phase 22f: SAR at MovieLens-1M's shape | {card}: "
        f"{json.dumps(res['sar'])}")

    # 22g. AccessAnomaly: one tenant, dense ALS on the device
    trip = access_triples(rng, *aa)
    t0 = time.perf_counter()
    aam = AccessAnomaly(device=d).fit(Dataset(dict(trip)))
    fit_s = time.perf_counter() - t0
    nu, nr = len(aam.get("userVectors")["t0"]), len(aam.get("resVectors")["t0"])
    w = torch.rand((nu, nr), generator=g, device=dev)
    tgt = (w > 0.99).to(torch.float32)
    access_anomaly._als(w, tgt, 10, 2, 1.0, seed)         # warm-up
    synchronize(dev)
    t0 = time.perf_counter()
    access_anomaly._als(w, tgt, 10, 25, 1.0, seed)
    synchronize(dev)
    als_ms = (time.perf_counter() - t0) * 1e3 / 25
    del w, tgt
    t0 = time.perf_counter()
    sc = aam.transform(Dataset(dict(trip)))["anomaly_score"]
    score_s = time.perf_counter() - t0
    fin = sc[np.isfinite(sc)]
    if not (abs(fin.mean()) < 0.1 and 0.5 < fin.std() < 1.5):
        raise AssertionError(f"22g: training scores {fin.mean()} {fin.std()}")
    no_kernel("22d-g")
    res["access_anomaly"] = dict(
        users=nu, resources=nr, triples=len(trip["user"]), fit_s=fit_s,
        als_ms_per_iteration=als_ms, score_s=score_s,
        pairs_per_s=len(trip["user"]) / score_s)
    log(f"phase 22g: AccessAnomaly {nu} users x {nr} resources | {card}: "
        f"{json.dumps(res['access_anomaly'])}")
    return res


# -- phase 23: serving on the card ---------------------------------------------

#: phase 23c's HTTP load (16 keep-alive clients x 256 records) and the
#: continuous client's records per window run (in windows of 128)
SERVE_THREADS, SERVE_PER_THREAD, SERVE_FRAMES = 16, 256, 4096


def exact_csv_bytes(M: np.ndarray) -> bytes:
    """The CSV text of ``M``, whose values are multiples of 1/64 in
    (-10, 10): each field is ``±d.dddddd``, the value's exact decimal
    expansion (q/64 = q·15625/10⁶), so any correct parse gives ``M`` back
    bit for bit.  Formatted with integer array arithmetic (no per-value
    Python)."""
    q = np.rint(np.asarray(M, np.float64) * 64).astype(np.int32)
    if np.abs(q).max(initial=0) >= 640:
        raise ValueError("exact_csv_bytes takes |value| < 10")
    a = np.abs(q) * np.int32(15625)
    out = np.empty(M.shape + (10,), np.uint8)
    out[..., 0] = np.where(q < 0, ord("-"), ord("+"))
    out[..., 1] = ord("0") + a // 1_000_000
    out[..., 2] = ord(".")
    frac = a % 1_000_000
    for k in range(6):
        out[..., 8 - k] = ord("0") + frac % 10
        frac //= 10
    out[..., 9] = ord(",")
    out[:, -1, 9] = ord("\n")
    return out.tobytes()


#: the HTTP load generator: a child Python process (stdlib only), so the
#: clients' threads do not share the server's interpreter lock.  argv:
#: host port path threads bodies-file (one JSON body a line) out-file
_HTTP_CLIENT = r"""
import http.client, json, sys, threading, time
host, port, path, threads, src, dst = sys.argv[1:7]
bodies = open(src, "rb").read().split(b"\n")[:-1]
out, errors = [None] * len(bodies), []
share = -(-len(bodies) // int(threads))
def run(lo):
    conn = http.client.HTTPConnection(host, int(port), timeout=60)
    try:
        for i in range(lo, min(lo + share, len(bodies))):
            t0 = time.perf_counter()
            conn.request("POST", path, body=bodies[i],
                         headers={"Content-Type": "application/json"})
            r = conn.getresponse()
            data = r.read()
            out[i] = [r.status, data.decode(), time.perf_counter() - t0]
    except Exception as e:
        errors.append(repr(e))
    finally:
        conn.close()
ts = [threading.Thread(target=run, args=(lo,))
      for lo in range(0, len(bodies), share)]
t0 = time.perf_counter()
for t in ts:
    t.start()
for t in ts:
    t.join()
json.dump({"wall": time.perf_counter() - t0, "rows": out,
           "errors": errors}, open(dst, "w"))
"""


def http_start(url: str, bodies, threads: int, workdir: str):
    """Start the load generator: ``threads`` keep-alive HTTP/1.1
    connections in a child process, each thread POSTing its contiguous
    share of ``bodies`` one at a time.  → a handle for :func:`http_wait`."""
    import tempfile
    from urllib.parse import urlsplit
    u = urlsplit(url)
    fd, src = tempfile.mkstemp(suffix=".jsonl", dir=workdir)
    with os.fdopen(fd, "wb") as f:
        f.write(b"\n".join(bodies) + b"\n")
    dst = src[:-len(".jsonl")] + ".out.json"
    proc = subprocess.Popen([sys.executable, "-c", _HTTP_CLIENT, u.hostname,
                             str(u.port), u.path or "/", str(threads), src,
                             dst])
    return proc, src, dst


def http_wait(handle):
    """→ (wall s, [(status, reply bytes, latency s)] in body order)."""
    proc, src, dst = handle
    try:
        if proc.wait(timeout=600) != 0:
            raise AssertionError(f"the HTTP load generator exited "
                                 f"{proc.returncode}")
        with open(dst) as f:
            res = json.load(f)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        for path in (src, dst):
            if os.path.exists(path):
                os.remove(path)
    if res["errors"]:
        raise AssertionError(f"HTTP clients failed: {res['errors'][:3]}")
    return res["wall"], [(st, body.encode(), lat)
                         for st, body, lat in res["rows"]]


def http_many(url: str, bodies, threads: int, workdir: str):
    return http_wait(http_start(url, bodies, threads, workdir))


def latency_ms(rows, q: float) -> float:
    lat = sorted(r[2] for r in rows)
    return lat[min(len(lat) - 1, int(len(lat) * q))] * 1e3


class CudaTimed:
    """Duck-typed model that records a CUDA event pair on the current
    stream around each ``transform`` of ``inner`` (the stream span of the
    call: its kernels, copies and the gaps between them)."""

    def __init__(self, inner, dev):
        import threading
        self.inner, self.dev, self.pairs = inner, dev, []
        self._lock = threading.Lock()

    def transform(self, ds):
        if self.dev.type != "cuda":
            return self.inner.transform(ds)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = self.inner.transform(ds)
        b.record()
        with self._lock:
            self.pairs.append((a, b))
        return out

    def span_ms(self) -> float:
        """Mean stream span of a call, ms (NaN on the CPU)."""
        if not self.pairs:
            return float("nan")
        torch.cuda.synchronize(self.dev)
        return float(np.mean([a.elapsed_time(b) for a, b in self.pairs]))


def walk_ms(booster, X: np.ndarray, dev, reps: int = 4) -> dict:
    """ms of ``trainer.predict_raw_features`` (every tree at once, the
    served path) and of ``predict_raw_features_per_tree`` (the previous
    walk) over ``X``, host clock ended by a synchronize, in turns
    (previous, batched, batched, previous); raises unless both give the
    same margins and leaves bit for bit."""
    from synapseml_tpu_torch.models.gbdt import trainer
    stacked = booster._stacked_for_class(0, None, dev)
    x = torch.as_tensor(np.ascontiguousarray(X, np.float32), device=dev)
    depth = booster.depth_bound()
    fns = {"batched": trainer.predict_raw_features,
           "per_tree": trainer.predict_raw_features_per_tree}
    outs = {k: fn(x, stacked, depth) for k, fn in fns.items()}
    if not (torch.equal(outs["batched"][0], outs["per_tree"][0])
            and torch.equal(outs["batched"][1], outs["per_tree"][1])):
        raise AssertionError("the batched walk differs from the per-tree "
                             "walk")
    times = {k: [] for k in fns}
    for k in ("per_tree", "batched", "batched", "per_tree"):
        synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(reps):
            fns[k](x, stacked, depth)
        synchronize(dev)
        times[k].append((time.perf_counter() - t0) / reps * 1e3)
    return dict(rows=len(X), trees=int(stacked.split_feature.shape[0]),
                depth=depth, equal=True,
                **{f"{k}_ms": float(np.mean(v)) for k, v in times.items()})


def phase23_stages():
    """The served pipelines' own stages.  ``Assemble`` declares
    ``inputCols`` (the 28 feature columns, so the row guard's NaN screen
    covers them) and stacks them into ``features``, raising on a batch
    with a first feature above ``bug_above`` (a deliberate bug, for the
    quarantine-and-replay case); ``ReplyCols`` packs each row's margin,
    probability and label into one JSON-ready ``reply`` value."""
    from synapseml_tpu_torch.core import Transformer
    from synapseml_tpu_torch.core.params import FloatParam, ListParam

    class Assemble(Transformer):
        inputCols = ListParam(doc="feature columns",
                              default=[f"f{j}" for j in range(28)])
        bug_above = FloatParam(doc="raise on a batch whose first feature "
                               "exceeds this (a deliberate bug)")

        def _transform(self, ds):
            cols = self.get_or_default("inputCols")
            cut = self.get_or_default("bug_above")
            if cut is not None and (np.asarray(ds[cols[0]]) > cut).any():
                raise ValueError(f"{cols[0]} above {cut}")
            return ds.with_column("features", np.column_stack(
                [ds[c] for c in cols]).astype(np.float32))

    class ReplyCols(Transformer):
        def _transform(self, ds):
            raw, p = ds["rawPrediction"], ds["probability"]
            lab = ds["prediction"]
            return ds.with_column("reply", [
                {"raw": float(raw[i][1]), "probability": float(p[i][1]),
                 "label": float(lab[i])} for i in range(ds.num_rows)])
    return Assemble, ReplyCols


def feature_columns(X: np.ndarray) -> dict:
    return {f"f{j}": X[:, j] for j in range(X.shape[1])}


def serving_paths(seed: int, dev, card: str, bert: dict, check_path,
                  n_rows: int = 1_000_000, iters: int = 100,
                  n_lenient: int = 100_000, n_card_cpu: int = 2048,
                  threads: int = SERVE_THREADS,
                  per_thread: int = SERVE_PER_THREAD,
                  n_frames: int = SERVE_FRAMES, n_bert: int = 1024,
                  n_gbdt_multi: int = 2048,
                  n_nan: int = 1024, root=None) -> dict:
    """Phase 23 (a-e): CSV → ``Dataset.from_csv`` → ``GBDTClassifier.fit``
    on the card (K1/K2, counted as run ``phase23`` through
    ``check_path``) → ``PipelineServer`` / ``MultiPipelineServer``,
    HTTP/1.1 and framed clients, and the row guard on served batches.
    Only the fit may launch a K-kernel.  ``bert`` is phase 21e's
    classifier: {"payload", "seq", "vocab"}.  Raises on a failed check;
    smaller sizes run it on the CPU."""
    import json as _json
    from synapseml_tpu_torch import native
    from synapseml_tpu_torch.core import Dataset, PipelineModel
    from synapseml_tpu_torch.io import colstore as CS
    from synapseml_tpu_torch.kernels import launches as L
    from synapseml_tpu_torch.models.gbdt.estimators import (
        GBDTClassificationModel, GBDTClassifier)
    from synapseml_tpu_torch.models.gbdt.metrics import auc
    from synapseml_tpu_torch.models.onnx import ONNXModel
    from synapseml_tpu_torch.resilience import get_faults
    from synapseml_tpu_torch.resilience.faults import PreemptionError
    from synapseml_tpu_torch.resilience.rowguard import (
        Quarantine, is_oom_error, isolation_budget, reset_safe_batch,
        safe_batch_size)
    from synapseml_tpu_torch.serving import (ContinuousClient,
                                             MultiPipelineServer,
                                             PipelineServer, ServingRequest)
    from synapseml_tpu_torch.telemetry import get_registry
    d = str(dev)
    F = 28
    root = root or os.path.join(os.path.dirname(CKPT_ROOT), "phase23")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    rng = np.random.default_rng(seed + 23)
    res = {}
    Assemble, ReplyCols = phase23_stages()

    def no_kernel(step: str) -> None:
        if L.BY_SHAPE:
            raise AssertionError(f"23{step} launched {dict(L.BY_SHAPE)}")

    def parse_features(r):
        return {"features": np.asarray(r.json()["features"], np.float32)}

    # 23b. the CSV: bench.py's task at HIGGS's width, values on a 1/64 grid
    X = (np.clip(np.rint(rng.normal(size=(n_rows, F)) * 64), -639, 639)
         / 64).astype(np.float32)
    y = gbdt_labels(rng, X).astype(np.float32)
    csv = os.path.join(root, "higgs_shape.csv")
    t0 = time.perf_counter()
    text = exact_csv_bytes(np.column_stack([X, y]))
    header = (",".join([f"f{j}" for j in range(F)] + ["label"]) + "\n"
              ).encode()
    with open(csv, "wb") as f:
        f.write(header)
        f.write(text)
    write_s = time.perf_counter() - t0
    nbytes = len(header) + len(text)
    before = native.CSV_PARSES["native"]
    t0 = time.perf_counter()
    ds_csv = Dataset.from_csv(csv)
    parse_s = time.perf_counter() - t0
    if native.CSV_PARSES["native"] != before + 1:
        raise AssertionError(f"23b: the native parser did not read the "
                             f"file ({dict(native.CSV_PARSES)})")
    if ds_csv.columns != [f"f{j}" for j in range(F)] + ["label"] or not (
            all(np.array_equal(ds_csv[f"f{j}"], X[:, j]) for j in range(F))
            and np.array_equal(ds_csv["label"], y)):
        raise AssertionError("23b: from_csv did not read the matrix back")
    # 1% of the first lines ragged (a field dropped) or unparseable
    lines = text[:n_lenient * (F + 1) * 10].split(b"\n")[:n_lenient]
    bad = np.sort(rng.choice(n_lenient, n_lenient // 100, replace=False))
    ragged = set(bad[::2].tolist())
    for i in bad:
        fields = lines[i].split(b",")
        lines[i] = b",".join(fields[:-1] if i in ragged
                             else [b"oops"] + fields[1:])
    lenient = os.path.join(root, "lenient.csv")
    with open(lenient, "wb") as f:
        f.write(header + b"\n".join(lines) + b"\n")
    store = Quarantine(os.path.join(root, "quarantine_ingest"))
    t0 = time.perf_counter()
    ds_len = Dataset.from_csv(lenient, handle_invalid="quarantine",
                              quarantine=store)
    lenient_s = time.perf_counter() - t0
    recs = sorted(store.records("Dataset.from_csv"),
                  key=lambda r: r.row_index)
    raw = store.rows("Dataset.from_csv")
    keep = np.setdiff1d(np.arange(n_lenient), bad)
    if ([r.row_index for r in recs] != bad.tolist()
            or any(not r.error_message.startswith(f"line {i + 2}:")
                   for r, i in zip(recs, bad))
            or sorted(raw.source_index.tolist()) != bad.tolist()
            or {s for s in raw["raw"]} != {lines[i].decode() for i in bad}
            or ds_len.source_index.tolist() != keep.tolist()
            or not np.array_equal(ds_len["f5"], X[keep, 5])):
        raise AssertionError("23b: the quarantine does not hold exactly "
                             "the bad lines")
    smlc = os.path.join(root, "higgs_shape.smlc")
    t0 = time.perf_counter()
    rows_c, names_c = CS.csv_to_colstore(csv, smlc)
    colstore_s = time.perf_counter() - t0
    src = CS.ChunkedColumnSource(smlc, label_col=F, chunk_rows=65_536)
    back = np.concatenate([c[0] for c in src.iter_chunks()])
    if (rows_c != n_rows or not np.array_equal(back, X)
            or not np.array_equal(src.read_labels(), y)):
        raise AssertionError("23b: csv_to_colstore did not read back equal")
    del back, src, text, lines
    # the fit, from the CSV's Dataset
    ds_fit = Dataset({"features": np.column_stack(
        [ds_csv[f"f{j}"] for j in range(F)]), "label": ds_csv["label"]})
    del ds_csv
    L.reset()
    t0 = time.perf_counter()
    model = GBDTClassifier(numIterations=iters, numLeaves=31, maxBin=255,
                           device=d).fit(ds_fit)
    synchronize(dev)
    fit_s = time.perf_counter() - t0
    shapes = dict(L.BY_SHAPE)
    check_path("phase23", dict(shapes=shapes, rows=n_rows, iterations=iters,
                               fit_s=fit_s))
    L.reset()
    Xh = (np.clip(np.rint(rng.normal(size=(100_000, F)) * 64), -639, 639)
          / 64).astype(np.float32)
    yh = gbdt_labels(rng, Xh)
    fit_auc = float(auc(yh, np.stack(model.transform(Dataset(
        {"features": Xh}))["probability"])[:, 1]))
    if fit_auc <= 0.8:
        raise AssertionError(f"23b: holdout AUC {fit_auc}")
    res["b"] = dict(
        rows=n_rows, csv_bytes=nbytes, write_s=write_s, parse_s=parse_s,
        parse_mb_per_s=nbytes / parse_s / 1e6, parser="native",
        lenient_lines=n_lenient, quarantined=len(recs),
        lenient_s=lenient_s,
        lenient_mb_per_s=os.path.getsize(lenient) / lenient_s / 1e6,
        csv_to_colstore_s=colstore_s, fit_s=fit_s, holdout_auc=fit_auc,
        shapes=shapes)
    log(f"phase 23b: CSV ingest {n_rows} x {F} + label ({nbytes} B) | "
        f"{card}: {_json.dumps(res['b'])}")
    no_kernel("b's scoring")

    # 23a. the same booster served from the card and from the CPU
    cpu_model = GBDTClassificationModel.load_native_model_from_string(
        model.get_model_string(), device="cpu")
    idx = rng.choice(len(Xh), n_card_cpu, replace=False)
    bodies = [_json.dumps({"features": Xh[i].tolist()}).encode()
              for i in idx]
    served, direct = {}, {}
    for where, m in (("card", model), ("cpu", cpu_model)):
        pipe = PipelineModel(stages=[m, ReplyCols()])
        direct[where] = list(pipe.transform(Dataset(
            {"features": Xh[idx]}))["reply"])
        ps = PipelineServer(pipe, parse_features, output_col="reply",
                            batch_size=64, batch_timeout_s=0.01)
        try:
            _, rows = http_many(ps.url, bodies, threads, root)
        finally:
            ps.close()
        if any(r[0] != 200 for r in rows):
            raise AssertionError(f"23a {where}: statuses "
                                 f"{sorted({r[0] for r in rows})}")
        served[where] = [_json.loads(r[1])["prediction"] for r in rows]
        if served[where] != direct[where]:
            raise AssertionError(f"23a {where}: served replies differ from "
                                 "one transform over the same rows")
    raw_diff = max(abs(a["raw"] - b["raw"])
                   for a, b in zip(served["card"], served["cpu"]))
    labels_equal = all(a["label"] == b["label"]
                       for a, b in zip(served["card"], served["cpu"]))
    if raw_diff > 1e-4 or not labels_equal:
        raise AssertionError(f"23a: card vs CPU margins {raw_diff}, labels "
                             f"equal {labels_equal}")
    res["a"] = dict(records=n_card_cpu, max_margin_diff=raw_diff,
                    limit=1e-4, labels_equal=labels_equal,
                    served_equals_transform=True)
    log(f"phase 23a: PipelineServer card vs CPU, {n_card_cpu} records | "
        f"{card}: {_json.dumps(res['a'])}")
    no_kernel("a")

    # 23c. PipelineServer over the card model: HTTP, frames, the split;
    # first the served walk (all trees at once) against the per-tree
    # walk on one 16-row batch, in turns, equal bit for bit
    res["c"] = {"walk": walk_ms(model.booster, Xh[:16], dev)}
    log(f"phase 23c: GBDT walk of 16 rows, {iters} trees | {card}: "
        f"{_json.dumps(res['c']['walk'])}")
    pipe = PipelineModel(stages=[model, ReplyCols()])
    n_http = threads * per_thread
    hidx = rng.choice(len(Xh), n_http, replace=True)
    bodies = [_json.dumps({"features": Xh[i].tolist()}).encode()
              for i in hidx]
    want = list(pipe.transform(Dataset({"features": Xh[hidx]}))["reply"])
    for workers in (1, 2):
        timed = CudaTimed(pipe, dev)
        ps = PipelineServer(timed, parse_features, output_col="reply",
                            batch_size=64, batch_timeout_s=0.01,
                            num_workers=workers)
        try:
            http_many(ps.url, bodies[:threads * 8], threads, root)  # warm
            t_before = dict(ps._loop.timings)
            timed.pairs.clear()
            wall, rows = http_many(ps.url, bodies, threads, root)
            t_after = dict(ps._loop.timings)
            if any(r[0] != 200 for r in rows) or [
                    _json.loads(r[1])["prediction"] for r in rows] != want:
                raise AssertionError(f"23c workers={workers}: replies "
                                     "differ from one transform")
            nb = t_after["batches"] - t_before["batches"]
            split = {k[:-2] + "_ms_per_batch":
                     (t_after[k] - t_before[k]) / max(nb, 1) * 1e3
                     for k in ("parse_s", "from_rows_s", "transform_s",
                               "reply_s")}
            r = dict(records=n_http, clients=threads,
                     records_per_s=n_http / wall,
                     latency_p50_ms=latency_ms(rows, 0.5),
                     latency_p99_ms=latency_ms(rows, 0.99),
                     batches=nb, records_per_batch=(
                         t_after["records"] - t_before["records"]) / max(
                             nb, 1),
                     transform_stream_ms_per_call=timed.span_ms(), **split)
            if workers == 1:
                host, port = ps.server.address
                marg, solo = [], []
                frames = [_json.dumps({"features": Xh[i].tolist()}).encode()
                          for i in rng.choice(len(Xh), n_frames)]
                with ContinuousClient(host, port, "/", timeout_s=60) as c:
                    c.request(frames[0])
                    for _ in range(3):
                        t0 = time.perf_counter()
                        got = c.request_many(frames, window=128)
                        marg.append((time.perf_counter() - t0)
                                    / len(frames) * 1e3)
                        if any(s != 200 for s, _ in got):
                            raise AssertionError("23c: a framed reply "
                                                 "failed")
                        t0 = time.perf_counter()
                        c.request(frames[1])
                        solo.append((time.perf_counter() - t0) * 1e3)
                r.update(frames=len(frames), window=128,
                         continuous_marginal_ms_per_record=float(
                             np.median(marg)),
                         continuous_solo_rtt_ms=float(np.median(solo)),
                         continuous_marginal_runs=marg,
                         continuous_solo_runs=solo)
        finally:
            ps.close()
        res["c"][f"workers={workers}"] = r
        log(f"phase 23c: PipelineServer batch 64, timeout 10 ms, "
            f"num_workers={workers} | {card}: {_json.dumps(r)}")
    no_kernel("c")

    # 23d. MultiPipelineServer: the GBDT and phase 21e's BERT classifier
    seq, vocab = bert["seq"], bert["vocab"]
    bert_model = ONNXModel(bert["payload"], feedDict={
        "input_ids": "input_ids", "attention_mask": "attention_mask"},
        fetchDict={"logits": "logits"}, miniBatchSize=64,
        dtype="bfloat16", device=d)

    def parse_ids(r):
        ids = np.asarray(r.json()["ids"], np.int64)
        if ids.shape != (seq,):
            raise ValueError(f"ids must be {seq} token ids")
        return {"input_ids": ids,
                "attention_mask": np.ones(seq, np.float32)}

    id_bodies = [_json.dumps({"ids": rng.integers(0, vocab, seq).tolist()})
                 .encode() for _ in range(n_bert)]
    srv = MultiPipelineServer({
        "/gbdt": {"model": pipe, "input_parser": parse_features,
                  "output_col": "reply", "batch_size": 64},
        "/bert": {"model": bert_model, "input_parser": parse_ids,
                  "output_col": "logits", "batch_size": 64}})
    try:
        http_many(srv.url_for("/bert"), id_bodies[:threads * 4], threads,
                  root)
        loads = {"/gbdt": bodies[:n_gbdt_multi], "/bert": id_bodies}

        def check(api, rows):
            for status, body, _ in rows:
                p = _json.loads(body)["prediction"] if status == 200 else None
                ok = status == 200 and (
                    isinstance(p, dict) and "label" in p if api == "/gbdt"
                    else isinstance(p, list) and len(p) == 2
                    and all(np.isfinite(p)))
                if not ok:
                    raise AssertionError(f"23d {api}: {status} {body[:200]}")

        def rates(api, wall, rows):
            check(api, rows)
            return dict(records=len(rows), records_per_s=len(rows) / wall,
                        latency_p50_ms=latency_ms(rows, 0.5),
                        latency_p99_ms=latency_ms(rows, 0.99))
        alone = {api: rates(api, *http_many(srv.url_for(api), bs, threads,
                                            root))
                 for api, bs in loads.items()}
        handles = {api: http_start(srv.url_for(api), bs, threads // 2, root)
                   for api, bs in loads.items()}
        try:
            both = {api: rates(api, *http_wait(h))
                    for api, h in handles.items()}
        finally:
            for proc, _, _ in handles.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
    finally:
        srv.close()
    res["d"] = dict(alone=alone, together=both, bert_seq=seq)
    log(f"phase 23d: MultiPipelineServer /gbdt + /bert (BERT-base width, "
        f"bf16, seq {seq}) | {card}: {_json.dumps(res['d'])}")
    no_kernel("d")

    # 23e. the row guard on served batches
    e = {}
    # (1) NaN-poisoned records under a skip pipeline: 422, the rest 200
    skip_pipe = PipelineModel(stages=[Assemble(), model, ReplyCols()],
                              handleInvalid="skip")
    eidx = rng.choice(len(Xh), n_nan, replace=False)
    rows_x = Xh[eidx].copy()
    poisoned = np.sort(rng.choice(n_nan, n_nan // 100, replace=False))
    rows_x[poisoned, rng.integers(0, F, len(poisoned))] = np.nan
    ebodies = [_json.dumps({"features": [None if np.isnan(v) else float(v)
                                         for v in r]}).encode()
               for r in rows_x]
    clean = list(PipelineModel(stages=[Assemble(), model, ReplyCols()])
                 .transform(Dataset(feature_columns(Xh[eidx])))["reply"])

    def parse_columns(r):
        v = r.json()["features"]
        return {f"f{j}": np.nan if x is None else float(x)
                for j, x in enumerate(v)}

    ps = PipelineServer(skip_pipe, parse_columns, output_col="reply",
                        batch_size=64, batch_timeout_s=0.01)
    try:
        _, rows = http_many(ps.url, ebodies, threads, root)
    finally:
        ps.close()
    status = [r[0] for r in rows]
    if ([i for i, s in enumerate(status) if s != 200] != poisoned.tolist()
            or any(status[i] != 422 for i in poisoned)
            or any(_json.loads(rows[i][1])["prediction"] != clean[i]
                   for i in range(n_nan) if status[i] == 200)):
        raise AssertionError(f"23e(1): statuses {sorted(set(status))}")
    e["nan_skip"] = dict(records=n_nan, status_422=len(poisoned),
                         status_200=n_nan - len(poisoned))

    def direct_replies(m, n):
        ps = PipelineServer(m, lambda r: r, output_col="reply",
                            batch_size=n, batch_timeout_s=0.01)
        got = {}
        ps._loop.api.reply = lambda rid, rep: got.__setitem__(rid, rep)
        reqs = [ServingRequest(id=f"r{i}", method="POST", path="/",
                               headers={}, body=b"") for i in range(n)]
        return ps, got, reqs

    # (2) the rowguard.poison_row site armed on 3 of 64 records
    faults = get_faults()
    faults.clear()
    poison = {7, 30, 51}
    faults.inject("rowguard.poison_row", "poison",
                  when=lambda c: bool(poison & set(map(int, c["rows"]))))
    calls = []

    class Sited:
        def transform(self, ds):
            calls.append(ds.num_rows)
            faults.raise_point("rowguard.poison_row", stage="served",
                               rows=ds["id"], n=ds.num_rows)
            return pipe.transform(ds.drop("id"))

    ps, got, reqs = direct_replies(Sited(), 64)
    try:
        ps._loop._transform_reply(reqs, [{"features": Xh[i], "id": i}
                                         for i in range(64)])
    finally:
        ps.close()
        faults.clear()
    want = list(pipe.transform(Dataset({"features": Xh[:64]}))["reply"])
    if ({i for i in range(64) if got[f"r{i}"].status == 500} != poison
            or any(got[f"r{i}"].status != 200 or _json.loads(
                got[f"r{i}"].body)["prediction"] != want[i]
                for i in range(64) if i not in poison)
            or len(calls) > isolation_budget(64)):
        raise AssertionError(f"23e(2): {len(calls)} transforms, statuses "
                             f"{ {k: v.status for k, v in got.items()} }")
    e["poison_row"] = dict(records=64, status_500=sorted(poison),
                           transforms=len(calls),
                           budget=isolation_budget(64))
    # (3) a real CUDA out-of-memory error above 12 records a batch
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        per_row = torch.cuda.mem_get_info(dev)[0] // 12
        ooms = []

        class Hungry:
            def transform(self, ds):
                try:
                    buf = torch.empty(per_row * ds.num_rows,
                                      dtype=torch.uint8, device=dev)
                except Exception as err:
                    ooms.append(err)
                    raise
                del buf
                return pipe.transform(ds)

        ps, got, reqs = direct_replies(Hungry(), 64)
        try:
            ps._loop._transform_reply(reqs, [{"features": Xh[i]}
                                             for i in range(64)])
            safe = safe_batch_size(ps._loop._oom_key, 64)
            gauge = get_registry().gauge(
                "rowguard_safe_batch_size", "", ("key",)).value(
                    key=ps._loop._oom_key)
        finally:
            reset_safe_batch()
            ps.close()
            torch.cuda.empty_cache()
        after = list(pipe.transform(Dataset({"features": Xh[:64]}))["reply"])
        if (not ooms or not all(isinstance(x, torch.OutOfMemoryError)
                                and is_oom_error(x) for x in ooms)
                or safe > 12 or gauge != safe
                or any(got[f"r{i}"].status != 200 or _json.loads(
                    got[f"r{i}"].body)["prediction"] != want[i]
                    for i in range(64)) or after != want):
            raise AssertionError(f"23e(3): {len(ooms)} OOMs, safe {safe}, "
                                 f"gauge {gauge}")
        e["cuda_oom"] = dict(records=64, ooms=len(ooms), safe_batch=safe,
                             gauge=gauge, card_usable_after=True)
    # (4) a preemption: 503 for the batch, one transform, no halving
    calls.clear()

    class Preempted:
        def transform(self, ds):
            calls.append(ds.num_rows)
            raise PreemptionError("evicted")

    ps, got, reqs = direct_replies(Preempted(), 64)
    try:
        ps._loop._transform_reply(reqs, [{"features": Xh[i]}
                                         for i in range(64)])
    finally:
        ps.close()
    if calls != [64] or {r.status for r in got.values()} != {503} \
            or len(got) != 64:
        raise AssertionError(f"23e(4): transforms {calls}")
    e["preemption"] = dict(records=64, status_503=64, transforms=len(calls))
    # (5) quarantine with pipeline-input row numbers, then replay
    qdir = os.path.join(root, "quarantine_serving")
    qrows = Xh[:512].copy()
    bug_rows = [40, 222, 480]
    qrows[:, 0] = np.minimum(qrows[:, 0], 3.0)
    qrows[bug_rows, 0] = 4.0
    buggy = Assemble(bug_above=3.5)
    qpipe = PipelineModel(stages=[buggy, model, ReplyCols()],
                          handleInvalid="quarantine", quarantineDir=qdir)
    fixed = PipelineModel(stages=[Assemble(), model, ReplyCols()])
    qds = Dataset(feature_columns(qrows))
    out = qpipe.transform(qds)
    store = Quarantine(qdir)
    recs = store.records(buggy.uid)
    replayed = store.replay(fixed, stage_uid=buggy.uid)
    clean_all = list(fixed.transform(qds)["reply"])
    order = np.argsort(replayed.source_index)
    kept = [i for i in range(512) if i not in bug_rows]
    if (sorted(r.row_index for r in recs) != bug_rows
            or sorted(replayed.source_index.tolist()) != bug_rows
            or [replayed["reply"][k] for k in order]
            != [clean_all[i] for i in bug_rows]
            or out.source_index.tolist() != kept
            or list(out["reply"]) != [clean_all[i] for i in kept]
            or store.rows(buggy.uid) is not None):
        raise AssertionError(f"23e(5): records {[r.row_index for r in recs]}")
    e["quarantine_replay"] = dict(rows=512, quarantined=bug_rows,
                                  replay_equals_clean=True)
    res["e"] = e
    log(f"phase 23e: the row guard on served batches | {card}: "
        f"{_json.dumps(e)}")
    no_kernel("e")
    shutil.rmtree(root, ignore_errors=True)
    return res


# ---------------------------------------------------------------------------
# phase 24: the profiling and tuning plane on the card
# ---------------------------------------------------------------------------

#: where phase 24 writes its tuning table and trace (``build/`` is not
#: committed); removed at the end of the phase
P24_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "phase24")
#: the histogram geometries the default 1M x 28 fit launches with
#: (two-level on: K2's coarse 32 bins over 28 features and its refined
#: 256 over 8, at a wave's 16 slots and the root's 1; K1's refined build)
P24_HIST_GEOMETRIES = ((28, 32, 16), (28, 32, 1), (8, 256, 16), (8, 256, 1))
#: phase 19c's model (bench.py's 12-layer configuration)
P24_SHAPE_19C = dict(vocab_size=512, d_model=1024, num_layers=12,
                     num_heads=16, num_kv_heads=4, max_len=256)
#: K3's tuned caches: phase 8's (16 slots x 2048, H=32, KV=8) at S=1 and
#: S=8, and phase 19c's (8 slots x 256, H=16, KV=4) at S=1; D=64, bf16
P24_K3 = (("phase 8", 16, 32, 8, 2048, 1), ("phase 8", 16, 32, 8, 2048, 8),
          ("phase 19c", 8, 16, 4, 256, 1))


def _same_trees(a, b) -> bool:
    return len(a) == len(b) and all(
        all(np.array_equal(np.asarray(x), np.asarray(y))
            for x, y in zip(ta, tb)) for ta, tb in zip(a, b))


def tune_kernels(seed: int, dev, card: str, table_dir: str,
                 rows: int = 1_000_000, hist_geometries=P24_HIST_GEOMETRIES,
                 k3=P24_K3) -> dict:
    """Phase 24a: ``gbdt_hist_geometry`` and ``paged_attn_variant`` run by
    the ``Autotuner`` on the card, every candidate held against the plain
    version first (exact for K1, K3's bf16 tolerance), the winners
    persisted into a table in ``table_dir``."""
    from synapseml_tpu_torch.models.gbdt import hist as H
    from synapseml_tpu_torch.telemetry.autotune import (Autotuner,
                                                        registered_spaces)
    from synapseml_tpu_torch.telemetry.tunetable import TunePlane
    plane = TunePlane(directory=table_dir)
    tuner = Autotuner(plane=plane, blocks=3)
    spaces = registered_spaces()
    out = {"hist": {}, "variant": {}}
    for nf, width, S in hist_geometries:
        r = tuner.run(spaces["gbdt_hist_geometry"], num_features=nf,
                      total_bins=width, n_slots=S, n_rows=rows, device=dev,
                      seed=seed)
        fpb, tile = H.rows_geometry(nf, width, S)[:2]
        default_ms = r["trials_ms"][f"fpb={fpb},tile={tile}"]
        out["hist"][r["geometry"]] = dict(
            winner=r["winner"], ms=r["measured_ms"],
            default={"fpb": fpb, "tile": tile}, default_ms=default_ms,
            default_over_best=default_ms / r["measured_ms"],
            candidates=r["trial_count"])
        log(f"phase 24a: gbdt_hist_geometry {r['geometry']}, {rows} rows "
            f"| {card}: {r['trial_count']} candidates equal to the plain "
            f"version; winner {r['winner']} {r['measured_ms']:.4f} ms, "
            f"default (fpb={fpb}, tile={tile}) {default_ms:.4f} ms "
            f"({default_ms / r['measured_ms']:.3f}x the best); every "
            f"candidate's ms {json.dumps(r['trials_ms'])}")
    for label, B, Hh, KV, T, S in k3:
        r = tuner.run(spaces["paged_attn_variant"], max_len=T, num_heads=Hh,
                      num_kv_heads=KV, d_head=64, n_slots=B, span=S,
                      dtype="bfloat16", device=dev, seed=seed)
        out["variant"][r["geometry"]] = dict(
            cache=label, winner=r["winner"]["variant"],
            ms=r["measured_ms"], trials_ms=r["trials_ms"])
        log(f"phase 24a: paged_attn_variant {label} {r['geometry']} "
            f"(full spans) | {card}: both variants within 1e-2 of the plain "
            f"version; winner {r['winner']['variant']}; "
            f"{json.dumps(r['trials_ms'])} ms")
    out["entries"] = len(plane.snapshot()["entries"])
    log(f"phase 24a: table {os.path.relpath(plane.directory)} holds "
        f"{out['entries']} entries keyed "
        f"{sorted({e['device_kind'] for e in plane.snapshot()['entries']})}")
    return out


def tuned_gbdt(seed: int, dev, card: str, table_dir: str, tuned: dict,
               rows: int = 1_000_000, iters: int = 5) -> dict:
    """Phase 24b-c (GBDT): the 1M x 28 fit untuned, then tuned with and
    without a ``StepProfiler`` in turns (unprofiled, profiled, profiled,
    unprofiled) under a new plane on the table.  Every fit's trees equal
    the untuned fit's bit for bit; the tuned launches carry the winners'
    ``(fpb, tile)``; a profiled iteration's segments sum to its total."""
    from synapseml_tpu_torch.kernels import launches as L
    from synapseml_tpu_torch.models.gbdt import hist as H
    from synapseml_tpu_torch.models.gbdt.booster import BoostingConfig, train
    from synapseml_tpu_torch.telemetry import tunetable as TT
    from synapseml_tpu_torch.telemetry.gangplane import StepProfiler
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(rows, 28)).astype(np.float32)
    y = gbdt_labels(rng, X)
    cfg = BoostingConfig(objective="binary", num_iterations=iters)
    prev = TT.set_tuneplane(TT.TunePlane(directory=None))
    try:
        base, _ = train(X, y, cfg, device=dev)
        plane = TT.TunePlane(directory=table_dir)
        TT.set_tuneplane(plane)
        fits = {"plain": [], "profiled": []}
        profs = []
        seen = {}

        def fit(kind):
            """One tuned fit → its s/iteration (a self-timed leg)."""
            prof = (StepProfiler("phase24_gbdt") if kind == "profiled"
                    else None)
            L.reset()
            H.LAUNCH_GEOMETRY.clear()
            b, _ = train(X, y, cfg, device=dev, step_profiler=prof)
            if not _same_trees(b.trees, base.trees):
                raise AssertionError(f"a tuned {kind} fit's trees differ "
                                     "from the untuned fit's")
            fits[kind].append(b.measures.seconds_per_iteration())
            if prof is not None:
                profs.append(prof)
            seen.update(launched=dict(L.BY_SHAPE),
                        geometry=dict(H.LAUNCH_GEOMETRY))
            return fits[kind][-1]
        # the paired protocol: unprofiled and profiled fits in alternating
        # order, the median of each block's differences, the best block
        base_s, delta_s = StepProfiler.measure(
            (lambda: fit("plain"), lambda: fit("profiled")), blocks=2,
            pairs=2)
        launched, geometry = seen["launched"], seen["geometry"]
        consults = [c for c in plane.snapshot()["consults"]
                    if c["space"] == H.HIST_GEOMETRY_SPACE]
    finally:
        TT.set_tuneplane(prev)
    loaded = {c["geometry"] for c in consults if c["outcome"] == "loaded"}
    if not loaded or loaded - set(tuned):
        raise AssertionError(f"phase 24b: hist consults {consults}")
    # each launch's (fpb, tile): the winner where its geometry was tuned
    for key, geo in geometry.items():
        if not launched.get(key):
            continue
        dims = dict(kv.split("=") for kv in key[key.index("[") + 1:-1]
                    .split(","))
        F, B, S = int(dims["F"]), int(dims["B"]), int(dims["S"])
        shift = int(dims["shift"])
        Bh = H.coarse_bins(B, shift) if shift else B
        sets = ([(F, Bh)] if key.startswith("build_hist_nodes")
                else [(F, Bh), (int(dims["K"]), B)])
        want = []
        for nf, width in sets:
            g = H.hist_geometry_key(nf, width, S)
            w = tuned.get(g, {}).get("winner")
            want += ([w["fpb"], w["tile"]] if w and g in loaded
                     else list(H.rows_geometry(nf, width, S)[:2]) if nf
                     else [0, 0])
        if list(geo) != want:
            raise AssertionError(f"phase 24b: {key} launched with "
                                 f"(fpb, tile) {geo}, expected {want}")
    for prof in profs:
        summ = prof.summary()
        if summ["steps"] != iters:
            raise AssertionError(f"profiled {summ['steps']} iterations")
        for rec in summ["last_steps"]:
            parts = sum(rec[s] for s in prof.SEGMENTS)
            if abs(parts - rec["total"]) > 0.01 * rec["total"]:
                raise AssertionError(f"segments {rec} do not sum to the "
                                     "total")
    seg = profs[-1].summary()["per_step_avg_seconds"]
    out = dict(s_per_iter_plain=fits["plain"],
               s_per_iter_profiled=fits["profiled"],
               paired_base_s=base_s, paired_delta_s=delta_s,
               profiler_overhead=delta_s / base_s,
               segments_per_iter=seg, consults_loaded=sorted(loaded),
               launch_geometry={k: list(v) for k, v in geometry.items()
                                if launched.get(k)},
               shapes=launched)
    log(f"phase 24b: 1M x 28 fit under the table | {card}: trees equal the "
        f"untuned fit's bit for bit; hist consults loaded "
        f"{sorted(loaded)}; launches' (fpb, tile) "
        f"{json.dumps(out['launch_geometry'])}")
    log(f"phase 24c: StepProfiler on the 1M x 28 fit | {card}: s/iteration "
        f"unprofiled {fits['plain']} against profiled {fits['profiled']} "
        f"in alternating pairs; paired median difference "
        f"{out['profiler_overhead']:+.4f} of {base_s:.5f}; segments a "
        f"iteration "
        f"{json.dumps(seg)}")
    return out


def tuned_engines(seed: int, dev, card: str, table_dir: str, llm, prompts,
                  new_tokens: int = 16, n_19c: int = 8,
                  shape19=P24_SHAPE_19C) -> dict:
    """Phase 24b-c (LLM): a bf16 engine at phase 19c's geometry under the
    table launches the winning K3 variant (its output held within 1e-2 of
    the plain version); greedy tokens against the default variant are
    printed.  Then phase 8's 1B engine in graph mode, unprofiled and with
    a ``StepProfiler`` (``capture_xla``): profiled steps equal engine
    steps and the tokens are equal."""
    from synapseml_tpu_torch.kernels import launches as L
    from synapseml_tpu_torch.models.llm import (LlamaConfig, LlamaModel,
                                                SlotEngine, cast_params)
    from synapseml_tpu_torch.models.llm import paged_attn as PA
    from synapseml_tpu_torch.telemetry import tunetable as TT
    from synapseml_tpu_torch.telemetry.gangplane import StepProfiler
    out = {}
    cfg = LlamaConfig.tiny(**shape19)
    T19, H19, KV19 = cfg.max_len, cfg.num_heads, cfg.num_kv_heads
    m19 = cast_params(LlamaModel(cfg, device=dev, seed=seed), cfg.dtype)
    rng = np.random.default_rng(seed + 24)
    p19 = [rng.integers(1, cfg.vocab_size, int(n)).astype(np.int32)
           for n in rng.integers(16, T19 * 5 // 8, n_19c)]
    runs = {}
    prev = TT.set_tuneplane(TT.TunePlane(directory=table_dir))
    try:
        for label, table in (("tuned", True), ("default", False)):
            if not table:
                TT.set_tuneplane(TT.TunePlane(directory=None))
            eng = SlotEngine(m19, n_slots=8, max_len=T19, device=dev,
                             name=f"phase24_{label}")
            L.reset()
            r = drive(eng, p19, [new_tokens * 2] * len(p19))
            runs[label] = dict(variant=eng.paged_variant or
                               PA.default_variant(cfg.dtype),
                               launches=L.shapes("paged_decode_attention"),
                               outs=r["outs"])
        won = runs["tuned"]["variant"]
        key_variant = "split" if won == "split" else "previous"
        if dev.type == "cuda" and not runs["tuned"]["launches"] or not all(
                k.endswith(f",variant={key_variant}]")
                for k in runs["tuned"]["launches"]):
            raise AssertionError(f"phase 24b: the tuned engine launched "
                                 f"{runs['tuned']['launches']}, winner {won}")
        # K3 at that shape through the winning variant, against plain
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        D19 = cfg.d_head
        q = torch.randn((8, H19, D19), generator=g, device=dev).bfloat16()
        k = torch.randn((8, T19, KV19, D19), generator=g,
                        device=dev).bfloat16()
        v = torch.randn((8, T19, KV19, D19), generator=g,
                        device=dev).bfloat16()
        sp = torch.as_tensor(np.linspace(1, T19, 8).astype(np.int32),
                             device=dev)
        got = PA.paged_decode_attention(q, k, v, sp, variant=won).float()
        ref = PA.paged_decode_attention_plain(q, k, v, sp).float()
        err = float((got - ref).abs().max())
        if not bool(((got - ref).abs() <= 1e-2 + 1e-2 * ref.abs()).all()):
            raise AssertionError(f"phase 24b: K3 {won} differs by {err}")
        agree = float(np.mean([np.mean(runs["tuned"]["outs"][i]
                                       == runs["default"]["outs"][i])
                               for i in range(len(p19))]))
        out["19c"] = dict(winner=won, k3_max_abs_err=err,
                          launches=runs["tuned"]["launches"],
                          token_agreement_vs_default=agree)
        log(f"phase 24b: bf16 SlotEngine at 19c's geometry | {card}: "
            f"variant {won} from the table, launches "
            f"{json.dumps(runs['tuned']['launches'])}, K3 within 1e-2 of "
            f"plain (max abs err {err:.3g}); greedy tokens against the "
            f"default {runs['default']['variant']}: agreement {agree:.4f} "
            "(printed, not held: bf16 on random weights)")
        # 24c. the 1B engine in graph mode, unprofiled then profiled
        TT.set_tuneplane(TT.TunePlane(directory=table_dir))
        res = {}
        n = 16
        for label in ("plain", "profiled"):
            prof = (StepProfiler("phase24_llm", capture_xla=True)
                    if label == "profiled" else None)
            eng = SlotEngine(llm, n_slots=16, warmup="sync", device=dev,
                             step_profiler=prof, name=f"phase24_{label}")
            L.reset()
            r = drive(eng, prompts[:n], [new_tokens] * n)
            res[label] = dict(outs=r["outs"], steps=eng.steps_run,
                              variant=eng.paged_variant,
                              launches=L.shapes("paged_decode_attention"),
                              replays=eng.compile_plane.snapshot()["replays"],
                              step_ms=float(np.median(r["step_s"]) * 1e3),
                              prof=prof)
        p, q_ = res["plain"], res["profiled"]
        if p["variant"] != q_["variant"] or any(
                not np.array_equal(p["outs"][i], q_["outs"][i])
                for i in range(n)):
            raise AssertionError("phase 24c: the profiled graph engine's "
                                 "tokens differ from the unprofiled one's")
        summ = q_["prof"].summary()
        if summ["steps"] != q_["steps"] or q_["replays"] != q_["steps"]:
            raise AssertionError(f"phase 24c: {summ['steps']} profiled "
                                 f"steps, {q_['steps']} engine steps, "
                                 f"{q_['replays']} replays")
        cost = summ["roofline"].get(next(iter(summ["roofline"]), ""), None)
        out["llm"] = dict(variant=p["variant"], steps=q_["steps"],
                          step_ms_median_plain=p["step_ms"],
                          step_ms_median_profiled=q_["step_ms"],
                          compute_ms=summ["per_step_avg_seconds"]["compute"]
                          * 1e3,
                          cost={k: v for k, v in (cost or {}).items()
                                if k in ("flops", "matmul_flops",
                                         "bytes_accessed",
                                         "achieved_bytes_per_sec",
                                         "top_ops")})
        log(f"phase 24c: StepProfiler on the 1B bf16 graph engine | {card}: "
            f"{json.dumps(out['llm'])}")
        out["launches"] = {k: v["launches"] for k, v in res.items()}
    finally:
        TT.set_tuneplane(prev)
    return out


def profiled_bert(seed: int, dev, card: str, n_steps: int = 4,
                  batch: int = 128, seq: int = 128, vocab: int = 30522,
                  model_size: str = "base", window: int = 10) -> dict:
    """Phase 24c (DL): a BERT-base ``DeepTextClassifier`` fit at phase
    14's shape for ``n_steps`` steps under a ``StepProfiler`` with
    ``capture_xla``: MFU in (0, 1], the captured flops beside the
    analytic 6 x parameters x tokens.  Then the profiler's cost on a
    step: ``window`` trainer steps bare and under step_begin / sync /
    mark / step_end, in turns (bare, profiled, profiled, bare)."""
    from synapseml_tpu_torch.core import Dataset
    from synapseml_tpu_torch.models.dl import (DeepTextClassifier, DLTrainer,
                                               OptimizerConfig, TextEncoder,
                                               resolve_precision)
    from synapseml_tpu_torch.telemetry.gangplane import StepProfiler
    rng = np.random.default_rng(seed + 24)
    words = make_words(rng, 4096)
    texts, labels = text_corpus(rng, words, n_steps * batch)
    prof = StepProfiler("phase24_bert", capture_xla=True)
    est = DeepTextClassifier(modelSize=model_size, vocabSize=vocab,
                             maxTokenLen=seq, batchSize=batch,
                             precision="bf16", maxEpochs=1, seed=seed,
                             stepProfiler=prof, device=str(dev))
    est.fit(Dataset({"text": texts, "label": labels}))
    summ = prof.summary()
    cost = summ["roofline"]["dl_text_step"]
    compute_s = summ["per_step_avg_seconds"]["compute"]
    mfu = cost["flops"] / compute_s / PEAK_BF16_S
    if summ["steps"] != n_steps or not 0 < mfu <= 1:
        raise AssertionError(f"phase 24c: {summ['steps']} steps, MFU {mfu}")
    cfg = dataclasses.replace(est._model_config(2), dtype=torch.bfloat16)
    pol = resolve_precision("bf16")
    tr = DLTrainer(TextEncoder(cfg, device=dev, seed=None),
                   OptimizerConfig(learning_rate=2e-5), dev, precision=pol)
    state = tr.init_state(seed)
    n_params = sum(p.numel() for p in tr.model.parameters())
    analytic = 6.0 * n_params * seq * batch
    ids = rng.integers(0, vocab, (batch, seq)).astype(np.int32)
    inputs = tr.shard_batch((ids, np.ones((batch, seq), bool),
                             rng.integers(0, 2, batch).astype(np.int32)))
    step = tr.train_step()
    box = [state]
    bare_prof = StepProfiler("phase24_bert_window")

    def bare():
        for _ in range(window):
            box[0], _ = step(box[0], inputs[:2], inputs[2], seed)
        synchronize(dev)

    def profiled():
        for i in range(window):
            bare_prof.step_begin(i)
            box[0], _ = step(box[0], inputs[:2], inputs[2], seed)
            synchronize(dev)
            bare_prof.mark("compute")
            bare_prof.step_end()
    bare()
    times = {"bare": [], "profiled": []}
    for kind in ("bare", "profiled", "profiled", "bare"):
        t0 = time.perf_counter()
        (bare if kind == "bare" else profiled)()
        times[kind].append((time.perf_counter() - t0) / window * 1e3)
    out = dict(steps=summ["steps"], mfu=mfu, compute_ms=compute_s * 1e3,
               captured_flops=cost["flops"],
               captured_matmul_flops=cost["matmul_flops"],
               analytic_flops=analytic, n_params=n_params,
               bytes_accessed=cost["bytes_accessed"],
               bytes_per_sample=cost["bytes_per_sample"],
               top_ops=cost["top_ops"][:5],
               step_ms_bare=times["bare"], step_ms_profiled=times["profiled"],
               sync_overhead=min(times["profiled"]) / min(times["bare"]) - 1)
    log(f"phase 24c: StepProfiler on a BERT-base DeepTextClassifier fit, "
        f"batch {batch}, seq {seq}, capture_xla | {card}: "
        f"{json.dumps(out)}")
    return out


def tunez_and_trace(seed: int, dev, card: str, table_dir: str,
                    trace_dir: str, shape19=P24_SHAPE_19C,
                    trace_rows: int = 100_000) -> dict:
    """Phase 24d-e: ``GET /tunez`` on an ``LLMServer`` under the table (200,
    ``check_tunez`` holds, the engine's consults listed), and
    ``core.trace`` around a short fit names ``hist_rows_kernel``."""
    from synapseml_tpu_torch.core import trace
    from synapseml_tpu_torch.models.gbdt.booster import BoostingConfig, train
    from synapseml_tpu_torch.models.llm import (LlamaConfig, LlamaModel,
                                                cast_params)
    from synapseml_tpu_torch.serving import LLMServer
    from synapseml_tpu_torch.telemetry import tunetable as TT
    out = {}
    prev = TT.set_tuneplane(TT.TunePlane(directory=table_dir))
    try:
        cfg = LlamaConfig.tiny(**shape19)
        m = cast_params(LlamaModel(cfg, device=dev, seed=seed), cfg.dtype)
        srv = LLMServer(m, n_slots=8, max_len=cfg.max_len, device=dev,
                        engine_kwargs={"name": "phase24d"})
        try:
            status, body = http_get(srv.server.url_for("/tunez"))
        finally:
            srv.close()
        if status != 200:
            raise AssertionError(f"/tunez answered {status}: {body[:200]}")
        snap = json.loads(body)
        TT.check_tunez(snap)
        sites = sorted({(c["site"], c["space"], c["outcome"])
                        for c in snap["consults"]})
        if ("SlotEngine", "paged_attn_variant", "loaded") not in sites:
            raise AssertionError(f"/tunez consults {sites}")
        out["tunez"] = dict(entries=len(snap["entries"]),
                            device_kind=snap["device_kind"],
                            consults=[list(s) for s in sites])
        log(f"phase 24d: GET /tunez on an LLMServer | {card}: 200, "
            f"check_tunez holds; {json.dumps(out['tunez'])}")
    finally:
        TT.set_tuneplane(prev)
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(trace_rows, 28)).astype(np.float32)
    y = gbdt_labels(rng, X)
    with trace(trace_dir):
        train(X, y, BoostingConfig(objective="binary", num_iterations=1),
              device=dev)
        synchronize(dev)
    files = [os.path.join(trace_dir, f) for f in os.listdir(trace_dir)]
    text = "".join(open(f, encoding="utf-8").read() for f in files)
    if "hist_rows_kernel" not in text:
        raise AssertionError(f"the trace {files} names no hist_rows_kernel")
    out["trace"] = dict(files=len(files), bytes=len(text))
    log(f"phase 24e: core.trace around a {trace_rows}-row fit | {card}: "
        f"{len(files)} file(s), {len(text)} bytes, names hist_rows_kernel")
    return out


# --------------------------------------------------------------------------
# phase 25: the parallel layer, a local gang of ranks on the one card
# --------------------------------------------------------------------------

#: every gang phase 25 launches ends within this many seconds
P25_GANG_TIMEOUT_S = 300.0
#: phase 25e's rows (the card against the CPU; 20,000 until phase 28 took
#: their time) and 25d's (one NCCL rank)
P25_SMALL_ROWS, P25_NCCL_ROWS = 10_000, 65_536


def p25_data(seed: int, rows: int, hold: int = 100_000, F: int = 28):
    """Phase 4's task from ``seed``: (X, y, Xh, yh); every rank draws it
    whole, identically."""
    drng = np.random.default_rng(seed)
    X = drng.normal(size=(rows, F)).astype(np.float32)
    y = gbdt_labels(drng, X)
    Xh = drng.normal(size=(hold, F)).astype(np.float32)
    yh = gbdt_labels(drng, Xh)
    return X, y, Xh, yh


def p25_build(device: str) -> dict:
    """This rank's kernel build: the libraries phase 1 left under
    ``build/kernels`` load, nothing compiles again (a CPU rank builds
    nothing)."""
    from synapseml_tpu_torch.kernels._build import build_all
    if device != "cuda":
        return dict(build_s=0.0, cached=None)
    t0 = time.perf_counter()
    built = build_all()
    return dict(build_s=time.perf_counter() - t0,
                cached=all(b["cached"] for b in built.values()))


def p25_collectives(card, host, seed: int, reps: int = 5) -> dict:
    """Phase 25b on this rank: each collective on CUDA tensors over the
    gloo group (``card``) and the same op on the same seeded values over
    the CPU (``host``, the same group): bit-equal, ms a call (median of
    ``reps``, synchronized), staged host bytes a call.  The values are a
    depthwise wave's coarse histograms, (16, 28, 32, 3) f32."""
    from synapseml_tpu_torch.parallel import collectives as C
    from synapseml_tpu_torch.parallel import compression as Z
    rng = np.random.default_rng(seed + 25 + card.rank)
    x = rng.normal(size=(16, 28, 32, 3)).astype(np.float32)
    x[..., 2] = np.round(np.abs(x[..., 2]) * 300)        # a count channel
    cfg = {c: Z.CollectiveConfig(compression=c, strategy="flat")
           for c in ("bf16", "int8")}
    ops = {
        "psum": lambda m, t: C.psum(t, m),
        "all_gather": lambda m, t: C.all_gather(t, m),
        "reduce_scatter": lambda m, t: C.reduce_scatter(t, m),
        "ring_allreduce": lambda m, t: C.ring_allreduce(t, m),
        "compressed_psum_bf16": lambda m, t: Z.compressed_psum(
            t, m, "data", cfg["bf16"]),
        "compressed_psum_int8": lambda m, t: Z.compressed_psum(
            t, m, "data", cfg["int8"]),
    }
    xc, xh = torch.as_tensor(x, device=card.device), torch.as_tensor(x)
    out = {}
    for name, op in ops.items():
        want = op(host, xh).numpy().tobytes()
        equal = op(card, xc).cpu().numpy().tobytes() == want
        staged = card.staged_bytes
        times = []
        for _ in range(reps):
            synchronize(card.device)
            t0 = time.perf_counter()
            op(card, xc)
            synchronize(card.device)
            times.append(time.perf_counter() - t0)
        out[name] = dict(equal=equal, ms=sorted(times)[reps // 2] * 1e3,
                         staged_bytes=(card.staged_bytes - staged) // reps,
                         payload_bytes=int(x.nbytes))
    return out


def p25_card_vs_cpu(card, host, seed: int, iters: int,
                    rows: int = P25_SMALL_ROWS) -> dict:
    """Phase 25e on this rank: the same data-parallel fit over the gloo
    group on the card and on the CPU: → whether every tree splits on the
    same features and bins, and the largest margin difference on 4,096
    holdout rows (phase 3's rule: 1e-4)."""
    from synapseml_tpu_torch.models.gbdt.booster import BoostingConfig, train
    X, y, Xh, _ = p25_data(seed + 251, rows, hold=4096)
    cfg = BoostingConfig(objective="binary", num_iterations=iters)
    bc, _ = train(X, y, cfg, mesh=card, device=card.device)
    bp, _ = train(X, y, cfg, mesh=host, device="cpu")
    same = len(bc.trees) == len(bp.trees) and all(
        int(tc.num_nodes) == int(tp.num_nodes)
        and np.array_equal(tc.split_feature[:int(tc.num_nodes)],
                           tp.split_feature[:int(tc.num_nodes)])
        and np.array_equal(tc.split_bin[:int(tc.num_nodes)],
                           tp.split_bin[:int(tc.num_nodes)])
        for tc, tp in zip(bc.trees, bp.trees))
    diff = float(np.abs(bc.predict_margin(Xh, device="cpu")
                        - bp.predict_margin(Xh, device="cpu")).max())
    return dict(rows=rows, same_splits=bool(same), margin_diff=diff)


def p25_main(card, seed: int, rows: int, iters: int) -> dict:
    """Phase 25c on this rank: ``Pipeline([GBDTClassifier(numShards=0)])
    .fit`` over the gang at ``rows`` x 28 (this rank holds half), with
    the histogram wire in f32 and in int8.  Launch counts are reset just
    before each fit and read just after; every histogram all-reduce is
    counted (calls, logical and wire bytes by the codec's model, host
    seconds between synchronizations).  Rank 0 transforms the 100k
    holdout.  → per codec: fit s, s/iteration, the model string's md5,
    launches, all-reduces and bytes an iteration, ms an all-reduce, and
    rank 0's holdout AUC."""
    import hashlib
    from synapseml_tpu_torch.core import Dataset, Pipeline
    from synapseml_tpu_torch.kernels import launches as L
    from synapseml_tpu_torch.models.gbdt import booster as B
    from synapseml_tpu_torch.models.gbdt.estimators import GBDTClassifier
    from synapseml_tpu_torch.models.gbdt.metrics import auc
    from synapseml_tpu_torch.parallel.compression import (codec_eligible,
                                                          wire_nbytes)
    X, y, Xh, yh = p25_data(seed, rows)
    ds = Dataset({"features": list(X), "label": y})
    hold = (Dataset({"features": list(Xh), "label": yh}) if card.rank == 0
            else None)
    orig = B.planned_psum
    out = {}
    for codec in ("none", "int8"):
        acc = dict(calls=0, logical=0, wire=0, seconds=0.0)

        def counted(h, mesh, axis, config, op, acc=acc):
            synchronize(card.device)
            t0 = time.perf_counter()
            res = orig(h, mesh, axis, config, op=op)
            synchronize(card.device)
            acc["seconds"] += time.perf_counter() - t0
            acc["calls"] += 1
            acc["logical"] += h.numel() * h.element_size()
            live = config if codec_eligible(h.shape, h.dtype,
                                            config) else None
            acc["wire"] += wire_nbytes(h, live, channel_major=True)
            return res

        B.planned_psum = counted
        try:
            L.reset()
            t0 = time.perf_counter()
            model = Pipeline(stages=[GBDTClassifier(
                numShards=0, numIterations=iters, device=str(card.device),
                collectiveCompression=codec)]).fit(ds)
            synchronize(card.device)
            fit_s = time.perf_counter() - t0
            shapes = dict(L.BY_SHAPE)
            launches = {k: L.total(k) for k in ("build_hist_nodes",
                                                "route_and_hist")}
        finally:
            B.planned_psum = orig
        gbdt = model.get_or_default("stages")[0]
        r = dict(fit_s=fit_s,
                 s_per_iter=gbdt.training_measures.seconds_per_iteration(),
                 md5=hashlib.md5(gbdt.get_model_string().encode())
                 .hexdigest(), trees=len(gbdt.booster.trees),
                 launches=launches, shapes=shapes,
                 allreduces_per_iter=acc["calls"] / iters,
                 logical_bytes_per_iter=acc["logical"] / iters,
                 wire_bytes_per_iter=acc["wire"] / iters,
                 allreduce_ms=acc["seconds"] / max(acc["calls"], 1) * 1e3,
                 allreduce_s_per_iter=acc["seconds"] / iters,
                 margins8=[float(v) for v in
                           gbdt.booster.predict_margin(X[:8])])
        if hold is not None:
            t0 = time.perf_counter()
            res = model.transform(hold)
            r["transform_s"] = time.perf_counter() - t0
            r["auc"] = float(auc(yh, np.stack(res["probability"])[:, 1]))
        out[codec] = r
    return out


#: where phase 16 leaves 16b's featurized rows for phase 25i's gang
P25_ONLINE_ROWS = os.path.join(os.path.dirname(CKPT_ROOT),
                               "phase25_online.npz")
#: phase 25i's sync schedules (sync_every_batches)
P25_SYNCS = (0, 4)


def coll_count(ops) -> dict:
    """Calls and logical bytes of each collective ``op`` on the data axis
    so far in this process (the registry's ``collective_*_total``)."""
    from synapseml_tpu_torch.telemetry import get_registry
    reg = get_registry()
    calls = reg.get("collective_calls_total")
    nbytes = reg.get("collective_bytes_total")
    return {op: (calls.value(op=op, axis="data") if calls else 0.0,
                 nbytes.value(op=op, axis="data") if nbytes else 0.0)
            for op in ops}


def coll_delta(before: dict, iters: int) -> dict:
    """Each op's calls and bytes an iteration since ``before``."""
    after = coll_count(before)
    return {op: dict(calls_per_iter=(after[op][0] - before[op][0]) / iters,
                     bytes_per_iter=(after[op][1] - before[op][1]) / iters)
            for op in before}


def model_md5(booster) -> str:
    import hashlib
    return hashlib.md5(booster.to_string().encode()).hexdigest()


def split_digest(booster) -> str:
    """md5 of every tree's split features, bins and thresholds (the nodes
    in use), leaf values left out."""
    import hashlib
    h = hashlib.md5()
    for t in booster.trees:
        n = int(t.num_nodes)
        for a in (t.split_feature, t.split_bin, t.threshold, t.left_child):
            h.update(np.ascontiguousarray(np.asarray(a)[:n]).tobytes())
    return h.hexdigest()


def p25_fit(card, X, y, iters: int, ops, holdout=None, **params) -> dict:
    """One ``booster.train`` over the gang with the launch counts reset
    just before and read just after, and the collectives ``ops`` counted
    → fit s, s/iteration, model md5, split digest, launches, shapes, the
    ops an iteration, and the holdout AUC where ``holdout`` = (Xh, yh)."""
    from synapseml_tpu_torch.kernels import launches as L
    from synapseml_tpu_torch.models.gbdt.booster import BoostingConfig, train
    from synapseml_tpu_torch.models.gbdt.metrics import auc
    cfg = BoostingConfig(objective="binary", num_iterations=iters, **params)
    before = coll_count(ops)
    L.reset()
    t0 = time.perf_counter()
    b, _ = train(X, y, cfg, mesh=card, device=card.device)
    synchronize(card.device)
    r = dict(fit_s=time.perf_counter() - t0,
             s_per_iter=b.measures.seconds_per_iteration(), md5=model_md5(b),
             splits=split_digest(b), trees=b.num_trees,
             launches={k: L.total(k) for k in ("build_hist_nodes",
                                               "route_and_hist")},
             shapes=dict(L.BY_SHAPE), collectives=coll_delta(before, iters))
    if holdout is not None:
        r["auc"] = float(auc(holdout[1], b.predict_margin(holdout[0])))
    return r


def p25_featpar(card, seed: int, rows: int, iters: int) -> dict:
    """Phase 25f on this rank: ``GBDTClassifier(parallelism=
    "feature_parallel", numShards=0).fit`` at ``rows`` x 28 (all rows, 14
    features a rank), launches and the routing all-reduces counted;
    rank 0 transforms the 100k holdout."""
    from synapseml_tpu_torch.core import Dataset
    from synapseml_tpu_torch.kernels import launches as L
    from synapseml_tpu_torch.models.gbdt.estimators import GBDTClassifier
    from synapseml_tpu_torch.models.gbdt.metrics import auc
    X, y, Xh, yh = p25_data(seed, rows)
    ds = Dataset({"features": list(X), "label": y})
    ops = ("featpar_route_psum", "featpar_pick_gather",
           "featpar_root_gather")
    before = coll_count(ops)
    L.reset()
    t0 = time.perf_counter()
    model = GBDTClassifier(parallelism="feature_parallel", numShards=0,
                           numIterations=iters,
                           device=str(card.device)).fit(ds)
    synchronize(card.device)
    r = dict(fit_s=time.perf_counter() - t0,
             s_per_iter=model.training_measures.seconds_per_iteration(),
             md5=model_md5(model.booster), trees=model.booster.num_trees,
             launches={k: L.total(k) for k in ("build_hist_nodes",
                                               "route_and_hist")},
             shapes=dict(L.BY_SHAPE), collectives=coll_delta(before, iters))
    if card.rank == 0:
        res = model.transform(Dataset({"features": list(Xh), "label": yh}))
        r["auc"] = float(auc(yh, np.stack(res["probability"])[:, 1]))
    return r


def p25_voting(card, seed: int, rows: int, iters: int) -> dict:
    """Phase 25g on this rank: voting-parallel at ``rows`` x 28 (this rank
    holds half) with topK=20 and topK=F=28, and the data-parallel
    lossguide fit at two-level off they are held against; rank 0 scores
    the holdout."""
    X, y, Xh, yh = p25_data(seed, rows)
    hold = (Xh, yh) if card.rank == 0 else None
    vote_ops = ("gbdt_vote_psum",)
    out = {k: p25_fit(card, X, y, iters, vote_ops, hold,
                      parallelism="voting_parallel", top_k=k_)
           for k, k_ in (("top20", 20), ("top28", 28))}
    out["dp_lossguide"] = p25_fit(card, X, y, iters, ("psum",), hold,
                                  growth_policy="lossguide",
                                  two_level_hist="off")
    return out


def p25_ranker(card, seed: int, iters: int, n_queries: int = RANK_Q,
               n_valid: int = RANK_VQ, n_feat: int = RANK_F) -> dict:
    # (n_queries, n_valid, n_feat smaller only for a run on the CPU)
    """Phase 25h on this rank: phase 13a's ranker (its generator and
    config) over the gang, whole queries packed onto the ranks; rank 0
    scores NDCG@10 on the validation queries."""
    from synapseml_tpu_torch.models.gbdt.metrics import ndcg_at
    r13 = np.random.default_rng(seed + 13)
    X, y, sizes = rank_data(r13, n_queries, n_feat)
    Xv, yv, vsizes = rank_data(r13, n_valid, n_feat)
    r, ranker = ranker_path(X, y, sizes, Xv, yv, vsizes, iters,
                            device=card.device.type, numLeaves=31,
                            maxBin=255, numShards=0)
    r["md5"] = model_md5(ranker.booster)
    if card.rank == 0:
        r["valid_ndcg10"] = float(ndcg_at(10)(
            yv, ranker.booster.predict_margin(Xv), vsizes))
    return r


def p25_online_rows(args: dict) -> dict:
    """Phase 16b's rows (Xtr, ytr, Xho, yho) from phase 16's file, or,
    without one (a run on the CPU), a small generated set."""
    path = args.get("online_rows")
    if path:
        return load_rows(path)
    rng = np.random.default_rng(args["seed"] + 161)
    d = args.get("online_dim", 256)
    X = np.zeros((args.get("online_n", 8192) + 2048, d), np.float32)
    cols = rng.integers(0, d, size=(len(X), 8))
    X[np.arange(len(X))[:, None], cols] = 1.0
    ytr, yho = hidden_clicks(rng, [X[:-2048], X[-2048:]])
    return dict(Xtr=X[:-2048], ytr=ytr, Xho=X[-2048:], yho=yho)


def p25_online(card, args: dict, batch: int = 32) -> dict:
    """Phase 25i on this rank: ``train_sgd(mesh=...)`` over phase 16b's
    rows (this rank holds half) at each schedule of :data:`P25_SYNCS`;
    rank 0 scores the holdout."""
    import hashlib
    from synapseml_tpu_torch.models.gbdt.metrics import auc
    from synapseml_tpu_torch.models.online import sgd as SGD
    d = p25_online_rows(args)
    y_pm = np.where(d["ytr"] > 0, 1.0, -1.0).astype(np.float32)
    out = {"rows": len(y_pm), "dim": int(d["Xtr"].shape[1])}
    for k in P25_SYNCS:
        cfg = SGD.SGDConfig(loss="logistic", batch_size=batch,
                            sync_every_batches=k)
        ops = ("sgd_sync_psum", "pmax")
        before = coll_count(ops)
        t0 = time.perf_counter()
        state, stats = SGD.train_sgd(d["Xtr"], y_pm, cfg, mesh=card,
                                     device=card.device)
        synchronize(card.device)
        arr = SGD.state_to_numpy(state)
        r = dict(fit_s=time.perf_counter() - t0, examples=stats["examples"],
                 average_loss=stats["average_loss"],
                 md5=hashlib.md5(b"".join(arr[f].tobytes() for f in
                                          sorted(arr))).hexdigest(),
                 collectives=coll_delta(before, 1))
        if card.rank == 0:
            r["auc"] = float(auc(d["yho"], SGD.predict_margin(state,
                                                              d["Xho"])))
        out[f"sync{k}"] = r
    return out


def p25_modes_card_vs_cpu(card, host, seed: int, iters: int,
                          rows: int = P25_SMALL_ROWS) -> dict:
    """Phase 25e for the new modes on this rank: feature-parallel,
    voting-parallel and a data-parallel lambdarank fit at ``rows`` rows
    over the gloo group on the card and on the CPU (same splits, margins
    within 1e-4 on 4,096 rows), and ``train_sgd`` over the group at each
    schedule of :data:`P25_SYNCS` (states within 1e-5) → per mode: same
    splits, largest difference, the card fit's shapes."""
    from synapseml_tpu_torch.kernels import launches as L
    from synapseml_tpu_torch.models.gbdt.booster import BoostingConfig, train
    from synapseml_tpu_torch.models.online import sgd as SGD
    X, y, Xh, _ = p25_data(seed + 253, rows, hold=4096)
    rng = np.random.default_rng(seed + 254)
    Xr, yr, sizes = rank_data(rng, rows // (RANK_MAXG // 2), 28)
    out = {}
    modes = {"featpar": (X, y, dict(objective="binary",
                                    parallelism="feature_parallel"), {}),
             "vote": (X, y, dict(objective="binary",
                                 parallelism="voting_parallel"), {}),
             "lambdarank": (Xr, yr, dict(objective="lambdarank"),
                            dict(group=sizes))}
    for name, (Xm, ym, kw, extra) in modes.items():
        cfg = BoostingConfig(num_iterations=iters, **kw)
        L.reset()
        bc, _ = train(Xm, ym, cfg, mesh=card, device=card.device, **extra)
        shapes = dict(L.BY_SHAPE)
        bp, _ = train(Xm, ym, cfg, mesh=host, device="cpu", **extra)
        probe = Xh if name != "lambdarank" else Xr[:4096]
        out[name] = dict(
            same_splits=split_digest(bc) == split_digest(bp),
            margin_diff=float(np.abs(bc.predict_margin(probe, device="cpu")
                                     - bp.predict_margin(probe,
                                                         device="cpu"))
                              .max()), shapes=shapes)
    d = p25_online_rows(dict(seed=seed + 255, online_n=rows - 2048))
    y_pm = np.where(d["ytr"] > 0, 1.0, -1.0).astype(np.float32)
    for k in P25_SYNCS:
        cfg = SGD.SGDConfig(loss="logistic", batch_size=32,
                            sync_every_batches=k)
        sc, _ = SGD.train_sgd(d["Xtr"], y_pm, cfg, mesh=card,
                              device=card.device)
        sp, _ = SGD.train_sgd(d["Xtr"], y_pm, cfg, mesh=host, device="cpu")
        a, b = SGD.state_to_numpy(sc), SGD.state_to_numpy(sp)
        out[f"online_sync{k}"] = dict(state_diff=max(
            float(np.abs(a[f] - b[f]).max()) for f in a))
    return out


def p25_new_modes(ranks, seed: int, dev, card: str, rows: int, iters: int,
                  check_path, small_rows: int, ranker_ndcg10,
                  online_auc_floor: float) -> dict:
    """Phase 25e (the new modes), f, g, h and i from the ranks' results:
    the checks and the lines.  Raises on a failed check."""
    from synapseml_tpu_torch.models.gbdt.booster import BoostingConfig, train
    on_card = dev.type == "cuda"
    out = {}
    # (e) each new mode at small_rows, the card against the CPU
    for r, res in enumerate(ranks):
        m = res["modes_card_vs_cpu"]
        for name in ("featpar", "vote", "lambdarank"):
            e = m[name]
            if not e["same_splits"] or e["margin_diff"] > 1e-4:
                raise AssertionError(f"phase 25e {name} rank {r}: {e}")
            check_path(f"phase25r{r}_small_{name}", e, strict=True)
        for k in P25_SYNCS:
            if m[f"online_sync{k}"]["state_diff"] > 1e-5:
                raise AssertionError(f"phase 25e online sync {k} rank {r}: "
                                     f"{m[f'online_sync{k}']}")
    m0 = ranks[0]["modes_card_vs_cpu"]
    log(f"phase 25e: feature-parallel, voting-parallel and lambdarank fits "
        f"at {small_rows} rows over 2 ranks, card vs CPU: same splits, "
        f"margins within "
        f"{max(m0[n]['margin_diff'] for n in ('featpar', 'vote', 'lambdarank')):.3g}"
        f"; train_sgd over the ranks at sync "
        f"{', '.join(map(str, P25_SYNCS))}: states within "
        f"{max(m0[f'online_sync{k}']['state_diff'] for k in P25_SYNCS):.3g}")
    # (f) feature-parallel at full width
    fp = [res["featpar"] for res in ranks]
    if fp[0]["md5"] != fp[1]["md5"]:
        raise AssertionError("phase 25f: the ranks' models differ")
    if fp[0]["auc"] <= 0.8:
        raise AssertionError(f"phase 25f: holdout AUC {fp[0]['auc']}")
    X, y, _, _ = p25_data(seed, rows, hold=1)
    t0 = time.perf_counter()
    solo, _ = train(X, y, BoostingConfig(objective="binary",
                                         num_iterations=iters,
                                         two_level_hist="off"), device=dev)
    solo_s = time.perf_counter() - t0
    del X, y
    if model_md5(solo) != fp[0]["md5"]:
        raise AssertionError("phase 25f: the feature-parallel model differs "
                             "from the one-process depthwise fit at "
                             "two-level off")
    for r, f in enumerate(fp):
        check_path(f"phase25r{r}_featpar", f, strict=True)
        if on_card and f["launches"]["build_hist_nodes"] <= 0:
            raise AssertionError(f"phase 25f rank {r}: K1 never launched")
    out["featpar"] = {r: {k: v for k, v in f.items() if k != "shapes"}
                      for r, f in enumerate(fp)}
    out["featpar_one_process_s"] = solo_s
    log(f"phase 25f: GBDTClassifier(parallelism=feature_parallel) over 2 "
        f"gloo ranks on the card, {rows} x 28 (14 features a rank), {iters} "
        f"iterations: ranks' models equal, equal to the one-process "
        f"depthwise fit at two-level off ({solo_s:.2f} s) | {card}: "
        f"{json.dumps(out['featpar'])}")
    # (g) voting-parallel, against the data-parallel lossguide fit
    vt = [res["vote"] for res in ranks]
    for k in ("top20", "top28", "dp_lossguide"):
        if vt[0][k]["md5"] != vt[1][k]["md5"]:
            raise AssertionError(f"phase 25g {k}: the ranks' models differ")
    a_dp, a_v = vt[0]["dp_lossguide"]["auc"], vt[0]["top20"]["auc"]
    if abs(a_v - a_dp) > 0.005:
        raise AssertionError(f"phase 25g: voting AUC {a_v} against the "
                             f"data-parallel lossguide fit's {a_dp}")
    if vt[0]["top28"]["splits"] != vt[0]["dp_lossguide"]["splits"]:
        raise AssertionError("phase 25g: topK=F split differently from the "
                             "data-parallel lossguide fit")
    for r, v in enumerate(vt):
        for k, run in (("top20", ""), ("top28", "28"),
                       ("dp_lossguide", "_dplg")):
            check_path(f"phase25r{r}_vote{run}", v[k], strict=True)
    out["vote"] = {r: {k: {kk: vv for kk, vv in v[k].items()
                           if kk != "shapes"} for k in v}
                   for r, v in enumerate(vt)}
    log(f"phase 25g: voting-parallel (lossguide) over 2 gloo ranks, "
        f"{rows} x 28, topK 20 and 28, against the data-parallel "
        f"lossguide fit at two-level off: ranks equal, AUC {a_v:.4f} vs "
        f"{a_dp:.4f}, topK=28 splits equal | {card}: "
        f"{json.dumps(out['vote'])}")
    # (h) the distributed ranker
    rk = [res["ranker"] for res in ranks]
    if rk[0]["md5"] != rk[1]["md5"]:
        raise AssertionError("phase 25h: the ranks' rankers differ")
    got = rk[0]["valid_ndcg10"]
    if ranker_ndcg10 is not None and abs(got - ranker_ndcg10) > 0.01:
        raise AssertionError(f"phase 25h: NDCG@10 {got} against phase 13's "
                             f"{ranker_ndcg10}")
    for r, k in enumerate(rk):
        check_path(f"phase25r{r}_ranker", k, strict=True)
    out["ranker"] = {r: {k: v for k, v in x.items() if k != "shapes"}
                     for r, x in enumerate(rk)}
    log(f"phase 25h: GBDTRanker(numShards=0) over 2 gloo ranks, whole "
        f"queries packed onto the ranks: rankers equal, validation NDCG@10 "
        f"{got:.4f} against phase 13's {ranker_ndcg10} | {card}: "
        f"{json.dumps(out['ranker'])}")
    # (i) the online learners' mesh
    on = [res["online"] for res in ranks]
    for k in P25_SYNCS:
        key = f"sync{k}"
        if on[0][key]["md5"] != on[1][key]["md5"]:
            raise AssertionError(f"phase 25i sync {k}: the ranks' states "
                                 "differ")
        if on[0][key]["auc"] <= online_auc_floor:
            raise AssertionError(f"phase 25i sync {k}: holdout AUC "
                                 f"{on[0][key]['auc']}")
    out["online"] = {r: o for r, o in enumerate(on)}
    log(f"phase 25i: train_sgd over 2 gloo ranks, phase 16b's "
        f"{on[0]['rows']} rows x {on[0]['dim']}, sync "
        f"{', '.join(map(str, P25_SYNCS))}: states equal on both ranks | "
        f"{card}: {json.dumps(out['online'])}")
    return out


def phase25_gang(args: dict) -> dict:
    """One rank of phase 25's two-rank gang, both ranks on the one card
    over gloo (run by ``run_on_local_cluster``): the build, (a) the
    cluster report, (b) the collectives card against CPU, (e) small fits
    card against CPU in every mode, (c) the data-parallel main path, (f)
    feature-parallel, (g) voting-parallel, (h) the distributed ranker and
    (i) the online learners' mesh.  ``parallel_gang`` checks."""
    from synapseml_tpu_torch.parallel.distributed import rendezvous_seconds
    from synapseml_tpu_torch.parallel.mesh import data_parallel_mesh
    from synapseml_tpu_torch.parallel.selfcheck import cluster_report
    dev = args.get("device", "cuda")
    out = dict(task_start_unix=time.time(),
               rendezvous_s=rendezvous_seconds(), **p25_build(dev))
    out["report"] = cluster_report({"device": dev})
    card = data_parallel_mesh(device=dev)
    host = data_parallel_mesh(device="cpu")
    seconds = out["part_s"] = {}
    parts = (
        ("collectives", lambda: p25_collectives(card, host, args["seed"])),
        ("card_vs_cpu", lambda: p25_card_vs_cpu(
            card, host, args["seed"], args["iters"], args["small_rows"])),
        ("main", lambda: p25_main(card, args["seed"], args["rows"],
                                  args["iters"])),
        ("modes_card_vs_cpu", lambda: p25_modes_card_vs_cpu(
            card, host, args["seed"], args["iters"], args["small_rows"])),
        ("featpar", lambda: p25_featpar(card, args["seed"], args["rows"],
                                        args["iters"])),
        ("vote", lambda: p25_voting(card, args["seed"], args["rows"],
                                    args["iters"])),
        ("ranker", lambda: p25_ranker(card, args["seed"], args["iters"],
                                      *args.get("ranker_shape", ()))),
        ("online", lambda: p25_online(card, args)))
    for name, run in parts:
        t0 = time.perf_counter()
        out[name] = run()
        seconds[name] = time.perf_counter() - t0
    return out


def phase25_nccl(args: dict) -> dict:
    """Phase 25 (a) and (d) on a one-rank NCCL group: the cluster report,
    and a fit over the group against the fit without one."""
    import hashlib
    from synapseml_tpu_torch.models.gbdt.booster import BoostingConfig, train
    from synapseml_tpu_torch.parallel.distributed import rendezvous_seconds
    from synapseml_tpu_torch.parallel.mesh import data_parallel_mesh
    from synapseml_tpu_torch.parallel.selfcheck import cluster_report
    dev = args.get("device", "cuda")
    out = dict(task_start_unix=time.time(),
               rendezvous_s=rendezvous_seconds(), **p25_build(dev))
    out["report"] = cluster_report({"device": dev})
    X, y, _, _ = p25_data(args["seed"] + 252, args.get(
        "nccl_rows", P25_NCCL_ROWS), hold=1)
    cfg = BoostingConfig(objective="binary", num_iterations=args["iters"])
    alone, _ = train(X, y, cfg, device=dev)
    grouped, _ = train(X, y, cfg, mesh=data_parallel_mesh(device=dev),
                       device=dev)
    out["equal"] = alone.to_string() == grouped.to_string()
    out["md5"] = hashlib.md5(grouped.to_string().encode()).hexdigest()
    return out


def parallel_gang(seed: int, dev, card: str, rows: int, iters: int,
                  check_path, small_rows: int = P25_SMALL_ROWS,
                  nccl_rows: int = P25_NCCL_ROWS,
                  ranker_ndcg10: Optional[float] = None,
                  online_rows: Optional[str] = None, ranker_shape=(),
                  online_auc_floor: float = 0.75,
                  solo_s_per_iter: Optional[float] = None) -> dict:
    """Phase 25 from the launching process: the two-rank gloo gang and,
    beside it at once, the one-rank NCCL gang on the one card, then the
    one-process default fit.  Each
    rank's default fit is the kernels line's run ``phase25r<rank>``, its
    feature-parallel fit ``phase25r<rank>_featpar``, its voting fits
    ``_vote`` (topK=20), ``_vote28`` and the data-parallel lossguide fit
    ``_dplg``, its ranker ``_ranker`` (``check_path``; the new runs
    strictly: every shape they launch is one phase 2 held).
    ``ranker_ndcg10``: phase 13a's validation NDCG@10 (25h is held to it
    within 0.01); ``online_rows``: phase 16's file of 16b's rows (None:
    small generated rows); ``solo_s_per_iter``: the one-process default
    fit's s/iteration on the same rows (phase 4's; None: fit it here).
    With ``dev`` the CPU it runs small there
    (``ranker_shape`` = (queries, validation queries, features); the
    NCCL gang is a gloo rank).  Raises on a failed check."""
    from synapseml_tpu_torch.parallel import run_on_local_cluster
    on_card = dev.type == "cuda"
    kind = torch.cuda.get_device_name(0) if on_card else "cpu"
    args = dict(seed=seed, rows=rows, iters=iters, device=dev.type,
                small_rows=small_rows, nccl_rows=nccl_rows,
                online_rows=online_rows, ranker_shape=list(ranker_shape))
    # (d)'s one-rank NCCL gang runs beside the two-rank gang
    from concurrent.futures import ThreadPoolExecutor
    backend = "nccl" if on_card else "gloo"

    def nccl_gang():
        t_start = time.time()
        (res,) = run_on_local_cluster("chip_smoke:phase25_nccl", 1,
                                      task_args=args, device=dev.type,
                                      backend=backend,
                                      timeout_s=P25_GANG_TIMEOUT_S)
        return res, t_start, time.time() - t_start

    pool = ThreadPoolExecutor(1)
    nccl_future = pool.submit(nccl_gang)
    t0 = time.time()
    try:
        ranks = run_on_local_cluster("chip_smoke:phase25_gang", 2,
                                     task_args=args, device=dev.type,
                                     backend="gloo",
                                     timeout_s=P25_GANG_TIMEOUT_S)
        one, t_nccl, out_nccl_s = nccl_future.result()
    finally:
        pool.shutdown(wait=True)
    gang_s = time.time() - t0
    out = {"gang_s": gang_s}
    for r, res in enumerate(ranks):
        log(f"phase 25 rank {r}: seconds a part "
            f"{json.dumps(res['part_s'])} | {card}")
        log(f"phase 25 rank {r}: build {res['build_s']:.4f} s (cached "
            f"{res['cached']}), launch to task "
            f"{res['task_start_unix'] - t0:.2f} s, rendezvous "
            f"{res['rendezvous_s']:.3f} s | {card}")
        if on_card and not res["cached"]:
            raise AssertionError(f"phase 25: rank {r} compiled the kernels "
                                 "again instead of loading phase 1's build")
    # (a) the cluster report, both ranks on the one card
    for r, res in enumerate(ranks):
        rep = res["report"]
        if (rep["process_index"], rep["process_count"], rep["backend"]) \
                != (r, 2, "gloo") or rep["psum_local"] != [1.0] \
                or rep["all_gather"] != [0.0, 1.0] \
                or rep["device_table"] != [[0, kind], [1, kind]] \
                or rep["placement"] != ranks[0]["report"]["placement"]:
            raise AssertionError(f"phase 25a rank {r}: {rep}")
    log(f"phase 25a: two gloo ranks on the card: sums, gathers and "
        f"placement as expected, device table {ranks[0]['report']['device_table']}")
    # (b) the collectives on CUDA tensors, bit-equal to the CPU group's
    for r, res in enumerate(ranks):
        bad = {k: v for k, v in res["collectives"].items() if not v["equal"]}
        if bad:
            raise AssertionError(f"phase 25b rank {r}: card differs from "
                                 f"the CPU group: {bad}")
    out["collectives"] = ranks[0]["collectives"]
    log(f"phase 25b: collectives on CUDA tensors over gloo, bit-equal to "
        f"the CPU group (ms a call, staged host bytes a call) | {card}: "
        f"{json.dumps(out['collectives'])}")
    # (e) a 2-rank fit on the card against the CPU
    for r, res in enumerate(ranks):
        e = res["card_vs_cpu"]
        if not e["same_splits"] or e["margin_diff"] > 1e-4:
            raise AssertionError(f"phase 25e rank {r}: {e}")
    log(f"phase 25e: 2-rank fit at {small_rows} rows, card vs CPU: "
        f"same splits, margins within "
        f"{max(r['card_vs_cpu']['margin_diff'] for r in ranks):.3g}")
    # (c) the main path over the gang
    main = [res["main"] for res in ranks]
    for codec in ("none", "int8"):
        if main[0][codec]["md5"] != main[1][codec]["md5"]:
            raise AssertionError(f"phase 25c {codec}: the ranks' models "
                                 "differ")
        if main[0][codec]["auc"] <= 0.8:
            raise AssertionError(f"phase 25c {codec}: holdout AUC "
                                 f"{main[0][codec]['auc']}")
        for r, m in enumerate(main):
            # (on the CPU the plain versions run and nothing launches)
            if on_card and min(m[codec]["launches"].values()) <= 0:
                raise AssertionError(f"phase 25c {codec} rank {r}: a kernel "
                                     f"never launched {m[codec]['launches']}")
    if main[0]["int8"]["wire_bytes_per_iter"] >= \
            main[0]["none"]["wire_bytes_per_iter"]:
        raise AssertionError("phase 25c: int8 moved no fewer wire bytes")
    for r, m in enumerate(main):
        check_path(f"phase25r{r}", {"shapes": m["none"]["shapes"]})
    out["main"] = {codec: {r: {k: v for k, v in m[codec].items()
                               if k != "shapes"} for r, m in enumerate(main)}
                   for codec in ("none", "int8")}
    log(f"phase 25c: GBDTClassifier(numShards=0) over 2 gloo ranks on the "
        f"card, {rows} x 28, {iters} iterations (f32 and int8 histogram "
        f"wire) | {card}: {json.dumps(out['main'])}")
    out.update(p25_new_modes(ranks, seed, dev, card, rows, iters,
                             check_path, small_rows, ranker_ndcg10,
                             online_auc_floor))
    # (d) one rank over NCCL (its gang ran beside the two-rank one)
    out["nccl_gang_s"] = out_nccl_s
    rep = one["report"]
    if (rep["backend"], rep["psum_local"], rep["device_table"]) != (
            backend, [0.0], [[0, kind]]) or (on_card and not one["cached"]):
        raise AssertionError(f"phase 25a ({backend}): {one}")
    if not one["equal"]:
        raise AssertionError("phase 25d: the one-rank NCCL fit differs from "
                             "the fit without a group")
    log(f"phase 25d: one {backend} rank: report as expected, trees "
        f"bit-equal to the fit without a group ({nccl_rows} rows); build "
        f"{one['build_s']:.4f} s, launch to task "
        f"{one['task_start_unix'] - t_nccl:.2f} s, rendezvous "
        f"{one['rendezvous_s']:.3f} s")
    # beside them, the one-process default fit (informational: the two
    # ranks share the one card)
    if solo_s_per_iter is None:
        X, y, Xh, yh = p25_data(seed, rows)
        solo_s_per_iter = fit_path(X, y, Xh, yh, iters,
                                   device=dev.type)[0]["s_per_iter"]
    out["one_process_s_per_iter"] = solo_s_per_iter
    log(f"phase 25: s/iteration one process {solo_s_per_iter:.4f}, two "
        f"gloo ranks f32 {main[0]['none']['s_per_iter']:.4f}, int8 "
        f"{main[0]['int8']['s_per_iter']:.4f} (informational: both ranks "
        f"share the card) | {card}")
    return out


# --------------------------------------------------------------------------
# phase 26: elastic resume on the card

#: phase 26's scratch: each gang's checkpoint directory and the kernel
#: build caches (``build/`` is not committed); removed at the end of the
#: phase
P26_ROOT = os.path.join(os.path.dirname(CKPT_ROOT), "phase26")
P26_GANG_TIMEOUT_S = 300.0
#: the line a phase-26 rank writes with its build report: a killed
#: attempt's report is read back from its log tail
P26_BUILD_MARKER = "P26_BUILD:"
#: 26c: ResNet-50 at phase 15's 224², 16 images, batch 8 (32 at batch 16
#: until phase 28 took their time), 2 epochs (4 optimizer steps), a
#: checkpoint every step; the fresh attempt is killed after its second
#: checkpoint
P26_DL = dict(backbone="resnet50", n=16, size=224, batch=8, epochs=2,
              faults="dl.checkpoint=kill:after=1:times=1")
#: deterministic cuBLAS for 26c's rank (with cuDNN's deterministic
#: algorithms, which the task sets)
P26_DETERMINISTIC_ENV = {"CUBLAS_WORKSPACE_CONFIG": ":4096:8"}


def p26_build(device: str) -> dict:
    """This rank's kernels through the gang's build cache (the worker
    pointed the builds at ``SMLTPU_COMPILE_CACHE_DIR`` before the task):
    the build directory, the libraries found there (hits) and built
    (misses).  Written on a line of its own, so a killed attempt's report
    survives in its log tail.  A CPU rank builds nothing."""
    from synapseml_tpu_torch.kernels._build import build_all, build_dir
    from synapseml_tpu_torch.parallel.compilecache import cache_stats
    from synapseml_tpu_torch.telemetry.gangplane import write_wire_line
    t0 = time.perf_counter()
    if device == "cuda":
        build_all()
    r = dict(build_s=time.perf_counter() - t0, build_dir=str(build_dir()),
             **cache_stats())
    write_wire_line(P26_BUILD_MARKER + json.dumps(r))
    return r


def p26_reports(sup) -> dict:
    """rank → the build report a dead attempt's rank wrote (the last
    failure's log tails)."""
    out = {}
    logs = sup.last_failure.logs if sup.last_failure is not None else {}
    for r, text in logs.items():
        for line in text.splitlines():
            if line.startswith(P26_BUILD_MARKER):
                out[r] = json.loads(line[len(P26_BUILD_MARKER):])
    return out


def p26_latest_iteration(directory: str) -> int:
    """The newest ``iter_<n>.json`` of a GBDT checkpoint directory (0: none)."""
    import re
    names = os.listdir(directory) if os.path.isdir(directory) else []
    found = [int(m.group(1)) for m in
             map(re.compile(r"iter_(\d+)\.json$").match, names) if m]
    return max(found, default=0)


def phase26_gbdt(args: dict) -> dict:
    """One rank of phase 26a/26b's gang: ``GBDTClassifier(numShards=0,
    checkpointDir=$SMLTPU_CKPT_DIR, checkpointInterval=1)`` on phase 25c's
    rows (``p25_data``, maxBin 255), resuming from the newest checkpoint
    there.  Launch counts are reset just before the fit and read just
    after.  → the build report, the iteration resumed from, fit s,
    launches and shapes, the model string's md5, margins on 8 rows, the
    ``gbdt.resize_resume`` notes, and rank 0's holdout AUC."""
    import hashlib
    import torch.distributed as dist
    from synapseml_tpu_torch.core import Dataset
    from synapseml_tpu_torch.kernels import launches as L
    from synapseml_tpu_torch.models.gbdt.estimators import GBDTClassifier
    from synapseml_tpu_torch.models.gbdt.metrics import auc
    from synapseml_tpu_torch.parallel.mesh import data_parallel_mesh
    from synapseml_tpu_torch.resilience import get_faults
    out = dict(task_start_unix=time.time(), **p26_build(args["device"]))
    faults = get_faults()
    faults.record_calls = True
    ckpt = os.environ["SMLTPU_CKPT_DIR"]
    dev = data_parallel_mesh(device=args["device"]).device
    out.update(rank=dist.get_rank(), world_size=dist.get_world_size(),
               resumed_from=p26_latest_iteration(ckpt))
    X, y, Xh, yh = p25_data(args["seed"], args["rows"])
    ds = Dataset({"features": list(X), "label": y})
    L.reset()
    t0 = time.perf_counter()
    model = GBDTClassifier(numShards=0, numIterations=args["iters"],
                           device=str(dev), checkpointDir=ckpt,
                           checkpointInterval=1).fit(ds)
    synchronize(dev)
    out["fit_s"] = time.perf_counter() - t0
    out["shapes"] = dict(L.BY_SHAPE)
    out["launches"] = {k: L.total(k) for k in ("build_hist_nodes",
                                               "route_and_hist")}
    b = model.booster
    out.update(md5=hashlib.md5(model.get_model_string().encode())
               .hexdigest(), trees=b.num_trees,
               margins8=[float(v) for v in b.predict_margin(X[:8])],
               resize_notes=[dict(c) for c in
                             faults.calls_for("gbdt.resize_resume")])
    if out["rank"] == 0:
        res = model.transform(Dataset({"features": list(Xh), "label": yh}))
        out["auc"] = float(auc(yh, np.stack(res["probability"])[:, 1]))
    return out


def phase26_dl(args: dict) -> dict:
    """Phase 26c's rank: ``DeepVisionClassifier(precision="f32")`` at
    ``args["dl"]`` (``P26_DL``: backbone, images) with step checkpoints in
    ``$SMLTPU_CKPT_DIR`` through a manager that times each save, under
    deterministic cuDNN and cuBLAS.  The fresh attempt arms
    ``P26_DL["faults"]`` itself (a relaunched process starts its fault
    counters at zero, so a rule armed by the environment would fire
    again in the resumed attempt); the relaunched attempt resumes, then
    fits the same model uninterrupted in the same process as the
    reference.  → the step resumed from, the saves (bytes, s), both
    fits' probabilities."""
    from synapseml_tpu_torch.core import Dataset
    from synapseml_tpu_torch.core.checkpoint import CheckpointManager
    from synapseml_tpu_torch.models.dl import DeepVisionClassifier
    from synapseml_tpu_torch.resilience import get_faults
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    dev = args["device"]
    out = dict(task_start_unix=time.time(), **p26_build(dev))
    saves = []

    class TimedManager(CheckpointManager):
        def save(self, step, pytree, metrics=None):
            if dev == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            path = super().save(step, pytree, metrics)
            saves.append(dict(step=int(step), seconds=time.perf_counter()
                              - t0, bytes=os.path.getsize(
                                  os.path.join(path, "arrays.npz"))))
            return path

    mgr = TimedManager(os.environ["SMLTPU_CKPT_DIR"], max_to_keep=2)
    out["resumed_from"] = mgr.latest_step() or 0
    c = args["dl"]
    if out["resumed_from"] == 0:
        get_faults().configure(c["faults"])
    imgs, labels = vision_images(np.random.default_rng(args["seed"] + 26),
                                 c["n"], c["size"])
    ds = Dataset({"image": list(imgs), "label": labels})
    kw = dict(backbone=c["backbone"], batchSize=c["batch"],
              maxEpochs=c["epochs"], learningRate=1e-3,
              lrSchedule="constant", seed=args["seed"], precision="f32",
              validationFraction=0.0, device=dev)
    t0 = time.perf_counter()
    model = DeepVisionClassifier(**kw, checkpointManager=mgr,
                                 checkpointInterval=1).fit(ds)
    out["fit_s"] = time.perf_counter() - t0
    out["saves"] = saves
    out["probs"] = np.stack(model.transform(ds)["probability"]).tolist()
    ref = DeepVisionClassifier(**kw).fit(ds)
    out["ref_probs"] = np.stack(ref.transform(ds)["probability"]).tolist()
    return out


def elastic_resume(seed: int, dev, card: str, rows: int, iters: int,
                   check_path, p25c: dict, dl: Optional[dict] = None
                   ) -> dict:
    """Phase 26 from the launching process: (a) a 2-rank gloo gang on
    the card killed at rank 1's third checkpoint and relaunched at the
    same size, (b) the same gang under a persistent rank-1 loss, shrunk
    to one rank, (c) ResNet-50 killed after its second step checkpoint
    in a 1-rank gang and resumed, (d) every gang's kernels through a
    build cache: (a)'s starts empty, so its dead attempt builds and its
    relaunch loads what that attempt built; (b) and (c) share one seeded
    with phase 1's build.  The three gangs run at once.  ``p25c``: phase 25c's f32-wire fit (md5, margins on 8
    rows and rank 0's AUC), the fault-free reference of (a) and (b).
    The resumed attempts' runs are ``phase26a_r<rank>_resumed`` and
    ``phase26b_r0_resumed`` (``check_path``, strictly).  ``dl``: 26c's
    model and images (default ``P26_DL``).  With ``dev`` the CPU it runs
    small (no kernel loads; a small ``dl``).  Raises on a failed check."""
    from synapseml_tpu_torch.kernels import _build
    from synapseml_tpu_torch.parallel import GangSupervisor
    from synapseml_tpu_torch.resilience import RetryPolicy
    on_card = dev.type == "cuda"
    if iters < 4:
        raise AssertionError("phase 26 kills a rank at its third "
                             "checkpoint: --iters must be at least 4")
    shutil.rmtree(P26_ROOT, ignore_errors=True)
    caches = {"a": os.path.join(P26_ROOT, "kernels_a"),
              "b": os.path.join(P26_ROOT, "kernels"),
              "c": os.path.join(P26_ROOT, "kernels")}
    for d in caches.values():
        os.makedirs(d, exist_ok=True)
    if on_card:
        # (b) and (c)'s cache holds phase 1's build, as a first gang
        # would leave it; (a)'s stays empty
        for info in _build.build_all().values():
            shutil.copy2(info["path"], caches["b"])
    n_libs = len(_build.SOURCES) if on_card else 0
    out = {}

    def gang(part, task, n, faults, task_args, env=None, **kw):
        cache = caches[part]
        sup = GangSupervisor(
            f"chip_smoke:{task}", n, task_args=task_args, device=dev.type,
            backend="gloo", timeout_s=P26_GANG_TIMEOUT_S,
            heartbeat_interval_s=1.0,
            checkpoint_dir=os.path.join(P26_ROOT, part),
            compile_cache_dir=cache,
            env_extra={**({"SML_FAULTS": faults} if faults else {}),
                       **(env or {})},
            retry_policy=RetryPolicy(max_retries=2, base_s=0.01, seed=seed),
            **kw)
        t0 = time.time()
        ranks = sup.run()
        first = p26_reports(sup)
        for r, res in enumerate(ranks):
            # 26d: every relaunched or resized attempt loads each library
            # from the cache and builds nothing
            if (res["compiles"], res["cache_misses"], res["cache_hits"]) \
                    != (0, 0, n_libs) or res["build_dir"] != cache:
                raise AssertionError(f"phase 26{part} rank {r}: the "
                                     f"relaunch did not load the cache: "
                                     f"{res}")
        # the one dead attempt ran at the gang's first size, n ranks
        if sup.restarts < 1 or len(first) != n or any(
                (rep["cache_hits"] + rep["cache_misses"],
                 rep["build_dir"]) != (n_libs, cache)
                for rep in first.values()):
            raise AssertionError(f"phase 26{part}: restarts "
                                 f"{sup.restarts}, the dead attempt's "
                                 f"build reports {first}")
        # (a)'s cache started empty: each library was built by at least
        # one rank of the dead attempt (ranks that started together may
        # both build it), and the relaunch loaded those builds
        if part == "a" and sum(rep["cache_misses"]
                               for rep in first.values()) < n_libs:
            raise AssertionError(f"phase 26a: the dead attempt found its "
                                 f"empty cache filled: {first}")
        return sup, ranks, first, time.time() - t0

    args = dict(seed=seed, rows=rows, iters=iters, device=dev.type)
    ref = {"md5": p25c["md5"], "margins8": p25c["margins8"],
           "auc": p25c["auc"]}
    c = dict(dl or P26_DL)
    # the three gangs run at once on the card (each one's seconds are
    # taken under the others' load)
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(3) as pool:
        runs = {
            "a": pool.submit(
                gang, "a", "phase26_gbdt", 2,
                "gbdt.checkpoint=kill_rank:rank=1:after=2:times=1", args),
            "b": pool.submit(
                gang, "b", "phase26_gbdt", 2,
                "gbdt.checkpoint=kill_rank:rank=1:after=2", args,
                min_ranks=1, shrink_after=1),
            "c": pool.submit(
                gang, "c", "phase26_dl", 1, None,
                dict(seed=seed, device=dev.type, dl=c),
                env=P26_DETERMINISTIC_ENV)}
        runs = {k: f.result() for k, f in runs.items()}
    # (a) same-size kill and resume
    sup, ranks, first, wall = runs["a"]
    for r, res in enumerate(ranks):
        if res["md5"] != ref["md5"] or res["margins8"] != ref["margins8"]:
            raise AssertionError(f"phase 26a rank {r}: the resumed model "
                                 f"differs from 25c's fault-free fit: "
                                 f"{res['md5']} against {ref['md5']}")
        if res["resumed_from"] < 1 or res["trees"] != iters:
            raise AssertionError(f"phase 26a rank {r}: {res}")
        if on_card and min(res["launches"].values()) <= 0:
            raise AssertionError(f"phase 26a rank {r}: a kernel never "
                                 f"launched {res['launches']}")
        check_path(f"phase26a_r{r}_resumed", {"shapes": res["shapes"]},
                   strict=True)
    if not (sup.last_recovery_s or 0) > 0:
        raise AssertionError(f"phase 26a: recovery {sup.last_recovery_s}")
    out["a"] = dict(wall_s=wall, restarts=sup.restarts,
                    recovery_s=sup.last_recovery_s, first_attempt=first,
                    ranks={r: {k: v for k, v in res.items()
                               if k not in ("shapes", "margins8")}
                           for r, res in enumerate(ranks)})
    log(f"phase 26a: 2 gloo ranks, rank 1 SIGKILLed after its third "
        f"checkpoint, relaunched at 2: resumed from iteration "
        f"{ranks[0]['resumed_from']}, models equal to 25c's fault-free "
        f"fit (md5, margins on 8 rows), recovery "
        f"{sup.last_recovery_s:.2f} s | {card}: {json.dumps(out['a'])}")
    # (b) shrink to survive a persistent rank loss
    sup, ranks, first, wall = runs["b"]
    got = [(e["from"], e["to"], e["direction"]) for e in sup.resize_history]
    (one,) = ranks
    gap = abs(one["auc"] - ref["auc"])
    if got != [(2, 1, "shrink")] or one["world_size"] != 1 \
            or one["resumed_from"] < 2 or one["trees"] != iters \
            or one["resize_notes"] != [{"saved": 2, "current": 1}] \
            or gap > 0.005:
        raise AssertionError(f"phase 26b: resizes {got}, {one}, AUC gap "
                             f"{gap}")
    if on_card and min(one["launches"].values()) <= 0:
        raise AssertionError(f"phase 26b: a kernel never launched "
                             f"{one['launches']}")
    check_path("phase26b_r0_resumed", {"shapes": one["shapes"]},
               strict=True)
    out["b"] = dict(wall_s=wall, restarts=sup.restarts, resizes=got,
                    recovery_s=sup.last_recovery_s, auc_gap=gap,
                    first_attempt=first,
                    rank0={k: v for k, v in one.items()
                           if k not in ("shapes", "margins8")})
    log(f"phase 26b: 2 gloo ranks, rank 1 lost at every attempt: shrunk "
        f"2 → 1, resumed from iteration {one['resumed_from']} on all "
        f"{rows} rows, holdout AUC {one['auc']:.6f} against 25c's "
        f"{ref['auc']:.6f} (gap {gap:.6f}, limit 0.005) | {card}: "
        f"{json.dumps(out['b'])}")
    # (c) ResNet-50 killed after its second step checkpoint, resumed
    sup, (dl,), first, wall = runs["c"]
    probs, ref_probs = np.asarray(dl["probs"]), np.asarray(dl["ref_probs"])
    diff = float(np.abs(probs - ref_probs).max())
    ok = np.allclose(probs, ref_probs, rtol=1e-4, atol=1e-5)
    saves = dl["saves"]
    out["c"] = dict(wall_s=wall, restarts=sup.restarts,
                    resumed_from=dl["resumed_from"], fit_s=dl["fit_s"],
                    max_prob_diff=diff, saves=saves, first_attempt=first)
    log(f"phase 26c: {c['backbone']} f32, {c['n']} images of "
        f"{c['size']}², batch {c['batch']}, {c['epochs']} epochs, killed "
        f"after step 2's checkpoint: "
        f"resumed from step {dl['resumed_from']}, probabilities within "
        f"{diff:.3g} of the uninterrupted fit (rtol 1e-4, atol 1e-5); a "
        f"checkpoint {saves[0]['bytes'] if saves else 0} B in "
        f"{np.mean([s['seconds'] for s in saves]) if saves else 0:.3f} s "
        f"| {card}: {json.dumps(out['c'])}")
    if dl["resumed_from"] != 2 or not ok:
        raise AssertionError(f"phase 26c: resumed from "
                             f"{dl['resumed_from']}, probabilities differ "
                             f"by {diff}")
    log(f"phase 26d: the build caches {caches}: (a)'s dead attempt "
        f"built every library into its empty cache; every relaunched or "
        f"resized attempt built nothing and loaded each of {n_libs} "
        f"libraries from its cache; the dead attempts found "
        f"{json.dumps({k: v['first_attempt'] for k, v in out.items()})}")
    shutil.rmtree(P26_ROOT, ignore_errors=True)
    return out


# -- phase 27: the LLM served across replicas ---------------------------------

#: 27b's traffic: sessions of two turns, client threads, the sessions
#: whose first turn runs before rank 1 leaves, turn 1's prompt lengths
#: and new tokens, turn 2's appended tokens
P27_SESSIONS, P27_THREADS, P27_BEFORE_LEAVE = 16, 8, 8
P27_PROMPT, P27_NEW, P27_APPEND = (64, 1024), 32, (16, 64)
P27_GANG_TIMEOUT_S = 600.0
#: 27b's host KV arena a rank (at least 512 MB)
P27_ARENA_BYTES = 1 << 30
P27_ROOT = os.path.join(os.path.dirname(CKPT_ROOT), "phase27")


def p27_config(spec: dict):
    """``{"kind": "llama3_1b" | "tiny", **LlamaConfig overrides}`` → the
    config (the gang's ranks rebuild it from JSON task arguments)."""
    from synapseml_tpu_torch.models.llm import LlamaConfig
    spec = dict(spec)
    kind = spec.pop("kind")
    if "dtype" in spec:
        spec["dtype"] = getattr(torch, spec["dtype"])
    return getattr(LlamaConfig, kind)(**spec)


def weight_digest(model) -> str:
    """md5 of the model's first 4,096 parameter values of each tensor
    (equal weights on two ranks)."""
    import hashlib
    h = hashlib.md5()
    for p in model.parameters():
        h.update(p.detach().flatten()[:4096].float().cpu().numpy().tobytes())
    return h.hexdigest()


def handoff_counts(name: str) -> dict:
    from synapseml_tpu_torch.serving.disagg import HANDOFF_OUTCOMES
    from synapseml_tpu_torch.telemetry import get_registry
    m = get_registry().get("disagg_handoffs_total")
    return {o: 0.0 if m is None else m.value(pool=name, outcome=o)
            for o in HANDOFF_OUTCOMES}


class FrameSizes:
    """Records the bytes of every KV transfer frame the pools pack (the
    pool imports ``kvtier.pack_kv_transfer`` at each handoff)."""

    def __init__(self):
        from synapseml_tpu_torch.models.llm import kvtier
        self._mod, self._real = kvtier, kvtier.pack_kv_transfer
        self.sizes, self.tokens, self.seconds = [], [], []

        def pack(ids, *a, **kw):
            t0 = time.perf_counter()
            blob = self._real(ids, *a, **kw)
            self.seconds.append(time.perf_counter() - t0)
            self.sizes.append(len(blob))
            self.tokens.append(len(ids))
            return blob
        kvtier.pack_kv_transfer = pack

    def close(self):
        self._mod.pack_kv_transfer = self._real


def p27_exact(seed: int, dev, cfg, root: str, n_slots: int = 4,
              prompt_range=(12, 200), n_fresh: int = 12, n_fault: int = 4,
              new: int = 16) -> dict:
    """Phase 27a at f32, one process: (1) an ``LLMServer`` with a
    ``PrefillPool`` of one ``PrefillWorker`` (a 2-slot engine on the same
    model) and a host arena against a colocated ``LLMServer`` on the same
    weights, over HTTP: greedy tokens equal for every request, and every
    fresh request's handoff ``ok``; (2) the same with
    ``disagg.transfer=corrupt``, then ``=drop``, then
    ``disagg.prefill=error`` armed: outcomes ``corrupt`` / ``timeout`` /
    ``fallback``, tokens still equal; (3) two decode ``LLMServer``s
    sharing a journal directory behind a ``ReplicaRouter(roles=["decode",
    "decode", "prefill"])``: the pinned replica closes mid-conversation,
    ``route_request(role="decode")`` answers ``repin`` on the survivor
    (never the prefill rank), whose ``resume`` equals the first turn and
    whose second turn equals the colocated server's.  K3's counts are
    reset just before and read just after each server's traffic (runs
    ``phase27a_*``); each decode server must have launched it.  Raises on
    a failed check."""
    from types import SimpleNamespace

    from synapseml_tpu_torch.kernels import launches as L
    from synapseml_tpu_torch.models.llm import (LlamaModel, SessionJournal,
                                                SlotEngine)
    from synapseml_tpu_torch.parallel import find_free_port
    from synapseml_tpu_torch.resilience import get_faults
    from synapseml_tpu_torch.serving import (DistributedServingServer,
                                             LLMServer, PrefillPool,
                                             PrefillWorker, ReplicaRouter)
    on_card = dev.type == "cuda"
    model = LlamaModel(cfg, device=dev, seed=seed)
    rng = np.random.default_rng(seed + 27)
    n_all = n_fresh + 3 * n_fault
    prompts = [rng.integers(1, cfg.vocab_size, int(n)).astype(np.int32)
               for n in rng.integers(prompt_range[0], prompt_range[1] + 1,
                                     n_all)]
    news = [new] * n_all
    runs, out = {}, {}
    faults = get_faults()
    colo = LLMServer(model, n_slots=n_slots, max_len=cfg.max_len,
                     api_path="/p27a-colo", device=dev,
                     engine_kwargs={"name": "p27a-colo"})
    try:
        L.reset()
        want, _, _ = serve_all(colo, prompts, news)
        runs["phase27a_colocated"] = L.shapes("paged_decode_attention")
        worker = PrefillWorker(SlotEngine(model, n_slots=2,
                                          max_len=cfg.max_len, device=dev,
                                          name="p27a-pf"))
        pool = PrefillPool([worker], name="p27a")
        dis = LLMServer(model, n_slots=n_slots, max_len=cfg.max_len,
                        api_path="/p27a-disagg", kv_arena_bytes=256 << 20,
                        prefill_pool=pool, device=dev,
                        engine_kwargs={"name": "p27a-disagg"})
        sections = (("ok", None, range(n_fresh)),
                    ("corrupt", "disagg.transfer=corrupt",
                     range(n_fresh, n_fresh + n_fault)),
                    ("timeout", "disagg.transfer=drop",
                     range(n_fresh + n_fault, n_fresh + 2 * n_fault)),
                    ("fallback", "disagg.prefill=error",
                     range(n_fresh + 2 * n_fault, n_all)))
        try:
            for outcome, rule, idx in sections:
                faults.clear()
                if rule:
                    faults.configure(rule)
                before = handoff_counts("p27a")
                L.reset()
                got, _, _ = serve_all(dis, [prompts[i] for i in idx],
                                      [news[i] for i in idx])
                runs[f"phase27a_{outcome}"] = L.shapes(
                    "paged_decode_attention")
                faults.clear()
                after = handoff_counts("p27a")
                delta = {o: after[o] - before[o] for o in after}
                want_delta = {o: float(len(idx)) if o == outcome else 0.0
                              for o in after}
                if delta != want_delta:
                    raise AssertionError(f"27a {outcome}: handoffs {delta}")
                for j, i in enumerate(idx):
                    if list(got[j]) != list(want[i]):
                        raise AssertionError(
                            f"27a {outcome} request {i}: disaggregated "
                            f"{list(got[j])} against colocated "
                            f"{list(want[i])}")
                out[outcome] = len(idx)
            out["restores"] = dis.engine.restore_count
        finally:
            faults.clear()
            dis.close()
        if out["restores"] < n_fresh:
            raise AssertionError(f"27a: {out['restores']} restores for "
                                 f"{n_fresh} ok handoffs")
        # (3) repin → journal resume behind a role-aware router
        jdir = os.path.join(root, "journal")
        reps = [LLMServer(model, n_slots=n_slots, max_len=cfg.max_len,
                          journal=SessionJournal(jdir, name=f"p27a-fo{i}"),
                          api_path=f"/p27a-fo{i}", device=dev,
                          engine_kwargs={"name": f"p27a-fo{i}"})
                for i in range(2)]
        try:
            table = [r.server.address for r in reps] + [
                ("127.0.0.1", find_free_port())]
            stub = SimpleNamespace(router=ReplicaRouter(
                table, name="p27a-fo", roles=["decode", "decode", "prefill"],
                failure_threshold=1))
            p1 = prompts[0]
            res = DistributedServingServer.route_request(
                stub, session="conv", role="decode")
            if res.outcome != "miss" or res.rank not in (0, 1):
                raise AssertionError(f"27a repin: first route {res}")
            L.reset()
            ids1 = http_generate(reps[res.rank].url, {
                "ids": [int(t) for t in p1], "session": "conv",
                "max_new_tokens": new}, headers=res.headers)[0]
            runs[f"phase27a_replica{res.rank}"] = L.shapes(
                "paged_decode_attention")
            if list(ids1) != list(want[0]):
                raise AssertionError(f"27a repin: turn 1 {ids1}")
            stub.router.report(res.rank, ok=True, addr=res.addr)
            hit = DistributedServingServer.route_request(
                stub, session="conv", role="decode")
            dead = res.rank
            reps[dead].close()
            stub.router.report(dead, ok=False, addr=res.addr)
            res2 = DistributedServingServer.route_request(
                stub, session="conv", role="decode")
            if hit.outcome != "hit" or res2.outcome != "repin" \
                    or res2.rank in (dead, 2):
                raise AssertionError(f"27a repin: {hit}, then {res2}")
            survivor = reps[res2.rank]
            L.reset()
            resumed = http_generate(survivor.url, {
                "session": "conv", "resume": True}, headers=res2.headers)[0]
            p2 = np.concatenate([p1, np.asarray(ids1, np.int32),
                                 prompts[1][:8]]).astype(np.int32)
            turn2 = http_generate(survivor.url, {
                "ids": [int(t) for t in p2], "session": "conv",
                "max_new_tokens": new}, headers=res2.headers)[0]
            runs[f"phase27a_replica{res2.rank}"] = L.shapes(
                "paged_decode_attention")
        finally:
            for r in reps:
                r.close()
        want2 = http_generate(colo.url, {"ids": [int(t) for t in p2],
                                         "max_new_tokens": new})[0]
        if list(resumed) != list(ids1) or list(turn2) != list(want2):
            raise AssertionError(f"27a repin: resume {resumed} against "
                                 f"{ids1}; turn 2 {turn2} against {want2}")
    finally:
        colo.close()
        shutil.rmtree(os.path.join(root, "journal"), ignore_errors=True)
    if on_card:
        silent = [r for r, sh in runs.items() if not sh]
        if silent:
            raise AssertionError(f"27a: K3 never launched in {silent}")
    out.update(requests=n_all, launches=runs)
    return out


def p27_post(url: str, payload: dict, timeout: float = 120.0) -> dict:
    """POST one JSON request → the JSON reply (an HTTP error raises
    ``urllib.error.HTTPError``)."""
    import urllib.request
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(), method="POST",
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def phase27_gang(args: dict) -> dict:
    """Phase 27b on one rank of the 2-rank gloo gang: (1) a
    ``DistributedServingServer`` with an echo loop (rank 0 routes one
    request to every rank; rank 1's loop also takes the ``leave`` cue);
    (2) two passes of the same traffic, each over an ``LLMServer`` of
    ``args["cfg"]`` (random weights from the seed, equal on both ranks)
    with 8 slots, a host arena and a journal directory both ranks share:
    ``"pool"`` with a ``PrefillPool`` of one ``PrefillWorker`` over a
    2-slot engine on the same model, then ``"nopool"`` without it; in
    each, the LLM servers' table and roles are gathered with
    ``exchange_routing_table`` over the gang's mesh, rank 0 drives the
    sessions through a ``ReplicaRouter`` over that table
    (:func:`p27_drive`) while K3's counts run on both ranks, and rank 1
    completes its leave with the zero-drop drain; (3) rank 1's echo
    server ``leave()``s; rank 0 then serves the same traffic straight to
    one server without the pool (``args["direct"]``)."""
    import threading

    from synapseml_tpu_torch.kernels import launches as L
    from synapseml_tpu_torch.models.llm import (LlamaModel, SlotEngine,
                                                cast_params)
    from synapseml_tpu_torch.parallel import collectives as C
    from synapseml_tpu_torch.parallel.mesh import data_parallel_mesh
    from synapseml_tpu_torch.serving import (DistributedServingServer,
                                             LLMServer, PrefillPool,
                                             PrefillWorker, ServingReply,
                                             exchange_routing_table)
    from synapseml_tpu_torch.telemetry import get_registry
    device = args["device"]
    mesh = data_parallel_mesh(device=device)
    rank, dev = mesh.rank, mesh.device
    out = {"rank": rank}
    echo = DistributedServingServer(device=device,
                                    gather_timeout_s=60.0)
    llm = {}
    stop = threading.Event()

    def echo_loop():
        while not stop.is_set():
            for req in echo.get_batch(max_rows=8, timeout_s=0.05):
                body = req.json()
                if body.get("cmd") == "leave":
                    # the leave's first step: readyz turns 503 draining
                    # while accepted work finishes; the drain completes
                    # once rank 0's traffic is done
                    llm["server"].server.health.begin_drain()
                echo.reply(req.id, ServingReply(200, json.dumps(
                    {"rank": rank, "echo": body.get("x")}).encode()))

    t = threading.Thread(target=echo_loop, daemon=True)
    t.start()
    cfg = p27_config(args["cfg"])
    model = LlamaModel(cfg, device=dev, seed=args["seed"])
    if cfg.dtype != torch.float32:
        model = cast_params(model, cfg.dtype)
    out["weights"] = weight_digest(model)
    name = f"p27b-r{rank}"

    def serve_pass(label: str, pool) -> dict:
        jdir = os.path.join(args["journal_dir"], label)
        os.makedirs(jdir, exist_ok=True)
        srv = llm["server"] = LLMServer(
            model, n_slots=8, max_len=cfg.max_len,
            kv_arena_bytes=args["arena_bytes"], journal_dir=jdir,
            prefill_pool=pool, device=dev, engine_kwargs={"name": f"{name}-{label}"})
        res = {}
        try:
            t0 = time.perf_counter()
            table, roles = exchange_routing_table(
                *srv.server.address, timeout_s=60.0, role=0, device=device)
            res["gather_ms"] = (time.perf_counter() - t0) * 1e3
            res["table"], res["roles"] = [[h, p] for h, p in table], roles
            C.barrier(None, mesh)
            L.reset()
            if rank == 0:
                res["drive"] = p27_drive(table, roles, args, cfg.vocab_size,
                                         echo.url_for_rank(1), label)
            C.barrier(None, mesh)        # the routed traffic is done
            res["launches"] = L.shapes("paged_decode_attention")
            res["restores"] = srv.engine.restore_count
            if rank == 1:
                t0 = time.perf_counter()
                res["left"] = srv.drain(timeout_s=60.0)
                res["leave_s"] = time.perf_counter() - t0
        finally:
            srv.close()
        return res

    try:
        C.barrier(None, mesh)            # every echo listener is up
        if rank == 0:
            import urllib.request
            out["echoes"] = []
            for r in range(len(echo.routing_table)):
                with urllib.request.urlopen(urllib.request.Request(
                        echo.url_for_rank(r), data=json.dumps(
                            {"x": r * 10}).encode()), timeout=30) as rep:
                    out["echoes"].append(json.loads(rep.read()))
        out["echo_table"] = [[h, p] for h, p in echo.routing_table]
        pool = PrefillPool([PrefillWorker(SlotEngine(
            model, n_slots=2, max_len=cfg.max_len, device=dev,
            name=f"{name}-pf"))], name=name)
        frames = FrameSizes()
        try:
            out["pool"] = serve_pass("pool", pool)
        finally:
            frames.close()
        out["handoffs"] = handoff_counts(name)
        lat = get_registry().get("disagg_handoff_latency_seconds")
        st = lat.stats(pool=name) if lat is not None else {"count": 0}
        out["handoff_latency"] = dict(
            count=st["count"],
            p50_ms=lat.quantile(0.5, pool=name) * 1e3 if st["count"] else
            None,
            p90_ms=lat.quantile(0.9, pool=name) * 1e3 if st["count"] else
            None)
        out["frame_bytes"] = frames.sizes
        out["frame_tokens"] = frames.tokens
        out["pack_ms"] = [s * 1e3 for s in frames.seconds]
        out["nopool"] = serve_pass("nopool", None)
        if rank == 1:
            out["echo_left"] = echo.leave(timeout_s=30.0)
        elif args.get("direct", True):
            out["direct"] = p27_direct(model, cfg, args)
    finally:
        stop.set()
        t.join(timeout=5)
        echo.close()
    return out


def p27_sessions(args: dict, vocab: int):
    rng = np.random.default_rng(args["seed"] + 2700)
    lo, hi = args["prompt"]
    n = args["sessions"]
    prompts = [rng.integers(1, vocab, int(k)).astype(np.int32)
               for k in rng.integers(lo, hi + 1, n)]
    adds = [rng.integers(1, vocab, int(k)).astype(np.int32)
            for k in rng.integers(args["append"][0], args["append"][1] + 1,
                                  n)]
    return prompts, adds


def p27_drive(table, roles, args: dict, vocab: int, leave_url: str,
              label: str) -> dict:
    """27b's traffic from rank 0 through a ``ReplicaRouter`` (named
    ``p27b-<label>``) over the gathered table, ``args["threads"]`` client
    threads, every request streamed: the first ``before_leave`` sessions'
    first turns; then rank 1 is told to leave, a probe must see it
    ``draining``; the other first turns (all to rank 0); then every
    second turn (the conversation plus appended tokens): a session pinned
    to rank 1 routes ``repin`` and is sent as ``{"session", "resume"}``
    first (the survivor replays the shared journal: it must equal turn
    1), then its second turn; every other second turn must route ``hit``.
    → the outcomes, TTFTs, tokens and walls; raises on a non-200 or a
    failed check."""
    from concurrent.futures import ThreadPoolExecutor
    from types import SimpleNamespace

    from synapseml_tpu_torch.serving import (DistributedServingServer,
                                             ROLE_NAMES, ReplicaRouter)
    prompts, adds = p27_sessions(args, vocab)
    new = args["new"]
    router = ReplicaRouter([tuple(a) for a in table], name=f"p27b-{label}",
                           roles=[ROLE_NAMES[r] for r in roles])
    stub = SimpleNamespace(router=router)
    first, second, resumed = {}, {}, {}
    rank_of, outcome1, outcome2 = {}, {}, {}
    ttft = {"turn1": [], "turn2": []}

    def turn1(i):
        res = DistributedServingServer.route_request(
            stub, "/generate", session=f"s{i}")
        ids, ttfb, _ = http_generate(res.url, {
            "ids": [int(t) for t in prompts[i]], "max_new_tokens": new,
            "session": f"s{i}", "stream": True}, headers=res.headers)
        router.report(res.rank, ok=True, addr=res.addr)
        first[i], rank_of[i], outcome1[i] = ids, res.rank, res.outcome
        ttft["turn1"].append(ttfb)

    def turn2(i):
        res = DistributedServingServer.route_request(
            stub, "/generate", session=f"s{i}")
        outcome2[i] = res.outcome
        if res.outcome == "repin":
            resumed[i] = http_generate(res.url, {
                "session": f"s{i}", "resume": True,
                "max_new_tokens": new}, headers=res.headers)[0]
        conv = np.concatenate([prompts[i], np.asarray(first[i], np.int32),
                               adds[i]])
        ids, ttfb, _ = http_generate(res.url, {
            "ids": [int(t) for t in conv], "max_new_tokens": new,
            "session": f"s{i}", "stream": True}, headers=res.headers)
        router.report(res.rank, ok=True, addr=res.addr)
        second[i] = (res.rank, ids)
        ttft["turn2"].append(ttfb)

    n, cut = args["sessions"], args["before_leave"]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(args["threads"]) as ex:
        list(ex.map(turn1, range(cut)))
        p27_post(leave_url, {"cmd": "leave"})
        statuses = router.probe_all()
        if statuses.get(1) != "draining" or statuses.get(0) != "healthy":
            raise AssertionError(f"27b: probes after the leave {statuses}")
        list(ex.map(turn1, range(cut, n)))
        list(ex.map(turn2, range(n)))
    wall = time.perf_counter() - t0
    on_rank1 = sorted(i for i in range(n) if rank_of[i] == 1)
    if any(rank_of[i] != 0 for i in range(cut, n)):
        raise AssertionError(f"27b: a first turn after the leave went to "
                             f"rank 1: {rank_of}")
    if any(second[i][0] != 0 for i in range(n)):
        raise AssertionError("27b: a second turn went to rank 1")
    repins = sorted(i for i in range(n) if outcome2[i] == "repin")
    hits = sorted(i for i in range(n) if outcome2[i] == "hit")
    if repins != on_rank1 or len(hits) != n - len(on_rank1) \
            or not on_rank1:
        raise AssertionError(f"27b: repin {repins}, hit {hits}, sessions "
                             f"on rank 1 {on_rank1}")
    for i in repins:
        if list(resumed[i]) != list(first[i]):
            raise AssertionError(f"27b: session {i} resumed as "
                                 f"{resumed[i]}, turn 1 was {first[i]}")
    tokens = sum(len(first[i]) + len(second[i][1]) for i in range(n))
    return dict(
        statuses_after_leave=statuses, first_rank=rank_of,
        outcomes_turn1=outcome1, outcomes_turn2=outcome2,
        repin=len(repins), hit=len(hits), on_rank1=on_rank1,
        requests=2 * n + len(repins), tokens=tokens, wall_s=wall,
        tokens_per_s=tokens / wall,
        ttft_ms=ttft_quantiles(ttft["turn1"] + ttft["turn2"]),
        ttft_turn1_ms=ttft_quantiles(ttft["turn1"]),
        ttft_turn2_ms=ttft_quantiles(ttft["turn2"]),
        outs={str(i): [list(map(int, first[i])),
                       list(map(int, second[i][1]))] for i in range(n)})


def ttft_quantiles(seconds) -> dict:
    a = np.asarray(seconds) * 1e3
    return {"p50": float(np.median(a)), "p90": float(np.percentile(a, 90)),
            "n": int(len(a))}


def p27_direct(model, cfg, args: dict) -> dict:
    """27b's traffic again on rank 0 alone, straight to one ``LLMServer``
    of the same configuration without the prefill pool and without the
    router: turn 1 then turn 2 of every session from the client threads,
    streamed → tokens/s and TTFT p50/p90."""
    from concurrent.futures import ThreadPoolExecutor

    from synapseml_tpu_torch.serving import LLMServer
    prompts, adds = p27_sessions(args, cfg.vocab_size)
    new, n = args["new"], args["sessions"]
    srv = LLMServer(model, n_slots=8, max_len=cfg.max_len,
                    kv_arena_bytes=args["arena_bytes"],
                    api_path="/p27b-direct", device=model.device,
                    engine_kwargs={"name": "p27b-direct"})
    first, second, ttft = {}, {}, []

    def turn(i, two):
        conv = prompts[i] if not two else np.concatenate(
            [prompts[i], np.asarray(first[i], np.int32), adds[i]])
        ids, ttfb, _ = http_generate(srv.url, {
            "ids": [int(t) for t in conv], "max_new_tokens": new,
            "stream": True})
        (second if two else first)[i] = ids
        ttft.append(ttfb)
    try:
        t0 = time.perf_counter()
        with ThreadPoolExecutor(args["threads"]) as ex:
            list(ex.map(lambda i: turn(i, False), range(n)))
            list(ex.map(lambda i: turn(i, True), range(n)))
        wall = time.perf_counter() - t0
    finally:
        srv.close()
    tokens = sum(len(first[i]) + len(second[i]) for i in range(n))
    return dict(tokens=tokens, wall_s=wall, tokens_per_s=tokens / wall,
                ttft_ms=ttft_quantiles(ttft))


def p27_gang(seed: int, dev, cfg_spec: dict, root: str,
             sessions: int = P27_SESSIONS, threads: int = P27_THREADS,
             before_leave: int = P27_BEFORE_LEAVE, prompt=P27_PROMPT,
             new: int = P27_NEW, append=P27_APPEND,
             arena_bytes: int = P27_ARENA_BYTES, direct: bool = True) -> dict:
    """Phase 27b from the launching process: the 2-rank gloo gang on the
    one card (``phase27_gang`` on each rank), then its checks: the echo
    reached both ranks, one table and equal weights on both; in each pass
    (``pool``, ``nopool``) every request answered, ``repin`` = the
    sessions pinned to rank 1, ``hit`` for every other second turn,
    rank 1's drain dropped nothing and K3's S=1 shape launched on each
    rank (runs ``phase27b_r0``, ``phase27b_r1``, ``phase27b_nopool_r0``,
    ``phase27b_nopool_r1``); in the ``pool`` pass every fresh turn's
    handoff ``ok`` on the rank that served it, one transfer frame packed
    for each; rank 1's echo server left clean.  → TTFT and tokens/s of
    both passes (the same routed traffic over the same two ranks, with
    and without the pool) and of the direct run, the handoffs' latency
    and bytes, the gathers' ms and the bf16 turn-1 agreement of the two
    passes.  Raises on a failed check."""
    from synapseml_tpu_torch.parallel import run_on_local_cluster
    on_card = dev.type == "cuda"
    jdir = os.path.join(root, "journal")
    os.makedirs(jdir, exist_ok=True)
    args = dict(seed=seed, device=dev.type, cfg=cfg_spec,
                journal_dir=jdir, arena_bytes=arena_bytes,
                sessions=sessions, threads=threads,
                before_leave=before_leave, prompt=list(prompt), new=new,
                append=list(append), direct=direct)
    t0 = time.perf_counter()
    try:
        ranks = run_on_local_cluster("chip_smoke:phase27_gang", 2,
                                     task_args=args, device=dev.type,
                                     backend="gloo",
                                     timeout_s=P27_GANG_TIMEOUT_S)
    finally:
        shutil.rmtree(jdir, ignore_errors=True)
    gang_s = time.perf_counter() - t0
    r0, r1 = ranks
    if r0["echoes"] != [{"rank": 0, "echo": 0}, {"rank": 1, "echo": 10}]:
        raise AssertionError(f"27b: echoes {r0['echoes']}")
    if r0["weights"] != r1["weights"] \
            or r0["echo_table"] != r1["echo_table"] or not r1["echo_left"]:
        raise AssertionError(f"27b: weights {r0['weights']} / "
                             f"{r1['weights']}, echo tables "
                             f"{r0['echo_table']} / {r1['echo_table']}, "
                             f"echo left {r1['echo_left']}")
    for label in ("pool", "nopool"):
        a, b = r0[label], r1[label]
        if a["table"] != b["table"] or a["roles"] != [0, 0] \
                or b["roles"] != [0, 0]:
            raise AssertionError(f"27b {label}: tables {a['table']} / "
                                 f"{b['table']}, roles {a['roles']} / "
                                 f"{b['roles']}")
        if not b.get("left"):
            raise AssertionError(f"27b {label}: rank 1's drain dropped work")
        if on_card:
            for r, res in enumerate((a, b)):
                if not any(",S=1," in k for k in res["launches"]):
                    raise AssertionError(
                        f"27b {label} rank {r}: K3 at S=1 never launched: "
                        f"{res['launches']}")
    drive, base = r0["pool"]["drive"], r0["nopool"]["drive"]
    # fresh turns a rank served: its sessions' first turns, and on rank 0
    # every second turn (a resume skips the pool)
    served = {0: sessions, 1: 0}
    for i in range(sessions):
        served[int(drive["first_rank"][str(i)])] += 1
    for r, res in enumerate(ranks):
        h = res["handoffs"]
        if h["ok"] != served[r] or sum(h.values()) != served[r] \
                or len(res["frame_bytes"]) != served[r]:
            raise AssertionError(f"27b rank {r}: handoffs {h} and "
                                 f"{len(res['frame_bytes'])} frames for "
                                 f"{served[r]} fresh turns")
    frames = r0["frame_bytes"] + r1["frame_bytes"]
    toks = r0["frame_tokens"] + r1["frame_tokens"]
    agree = [float(np.mean(np.asarray(drive["outs"][str(i)][0])
                           == np.asarray(base["outs"][str(i)][0])))
             for i in range(sessions)]
    out = dict(
        gang_s=gang_s,
        gather_ms={label: [r0[label]["gather_ms"], r1[label]["gather_ms"]]
                   for label in ("pool", "nopool")},
        repin=drive["repin"], hit=drive["hit"], on_rank1=drive["on_rank1"],
        repin_nopool=base["repin"], hit_nopool=base["hit"],
        on_rank1_nopool=base["on_rank1"],
        requests_answered_200=drive["requests"] + base["requests"],
        rank1_drained_clean=[r1["pool"]["left"], r1["nopool"]["left"]],
        rank1_echo_left=r1["echo_left"],
        statuses_after_leave=drive["statuses_after_leave"],
        leave_s=[r1["pool"]["leave_s"], r1["nopool"]["leave_s"]],
        wall_s_routed=drive["wall_s"], wall_s_routed_nopool=base["wall_s"],
        tokens_per_s_routed=drive["tokens_per_s"],
        tokens_per_s_routed_nopool=base["tokens_per_s"],
        ttft_routed_ms=drive["ttft_ms"],
        ttft_routed_turn1_ms=drive["ttft_turn1_ms"],
        ttft_routed_turn2_ms=drive["ttft_turn2_ms"],
        ttft_routed_nopool_ms=base["ttft_ms"],
        ttft_routed_nopool_turn1_ms=base["ttft_turn1_ms"],
        ttft_routed_nopool_turn2_ms=base["ttft_turn2_ms"],
        handoffs=[r0["handoffs"], r1["handoffs"]],
        handoff_latency_ms=[r0["handoff_latency"], r1["handoff_latency"]],
        handoff_bytes_mean=float(np.mean(frames)),
        handoff_bytes_per_token=float(np.sum(frames) / np.sum(toks)),
        pack_ms_p50=float(np.median(r0["pack_ms"] + r1["pack_ms"])),
        restores=[r0["pool"]["restores"], r1["pool"]["restores"]],
        turn1_agreement_bf16_pool_nopool=float(np.mean(agree)),
        launches={"phase27b_r0": r0["pool"]["launches"],
                  "phase27b_r1": r1["pool"]["launches"],
                  "phase27b_nopool_r0": r0["nopool"]["launches"],
                  "phase27b_nopool_r1": r1["nopool"]["launches"]})
    if direct:
        d = r0["direct"]
        out.update(wall_s_direct=d["wall_s"],
                   tokens_per_s_direct=d["tokens_per_s"],
                   ttft_direct_ms=d["ttft_ms"])
    return out


def p27_autoscale(seed: int, dev, root: str, cfg_spec: dict,
                  n_slots: int = TIER_SLOTS, max_len: int = TIER_LEN,
                  ttft_slo_s: float = 0.05, burst_threads: int = 24,
                  burst_s: float = 4.0, idle_s: float = 12.0,
                  new: int = 24, window_s: float = 2.0) -> dict:
    """Phase 27c: a ``ServingReplicaSet`` whose factory builds an
    ``LLMServer`` over phase 20a's f32 engine shape (``n_slots`` x
    ``max_len``) on ``dev``, behind a ``ReplicaRouter``; an
    ``Autoscaler`` (max 2 replicas) polls the in-process ``SloStore``'s
    plane of the replicas' api path (a ``window_s`` window).  An
    open-loop burst (``burst_threads`` clients, no think time) sheds and
    must grow the set 1 → 2; then a trickle (one client, a request every
    0.1 s) must let it shrink 2 → 1.  Every request ends in a 200 (a shed
    503 or a refused connection is retried after a short wait, counted);
    the decisions other than hold must be exactly grow then shrink, each
    in the flight ring as ``autoscale_decide``; the departed replica's
    breaker and probe row are released; K3 launched (run ``phase27c``).
    Raises on a failed check."""
    import threading
    import urllib.error

    from synapseml_tpu_torch.kernels import launches as L
    from synapseml_tpu_torch.models.llm import LlamaModel
    from synapseml_tpu_torch.resilience import breaker as PB
    from synapseml_tpu_torch.serving import (AutoscalePolicy, Autoscaler,
                                             LLMServer, ReplicaRouter,
                                             ServingReplicaSet)
    from synapseml_tpu_torch.telemetry import get_registry
    from synapseml_tpu_torch.telemetry.flight import get_flight
    from synapseml_tpu_torch.telemetry.slo import get_slo_store
    cfg = p27_config(cfg_spec)
    model = LlamaModel(cfg, device=dev, seed=seed)
    api = "/p27c"
    store = get_slo_store()
    store.window(api, window_s=window_s, slices=4)
    made = itertools.count()

    def factory():
        i = next(made)
        return LLMServer(model, n_slots=n_slots, max_len=max_len,
                         api_path=api, ttft_slo_s=ttft_slo_s, device=dev,
                         engine_kwargs={"name": f"p27c-{i}"})

    def source():
        snap = store.snapshot()
        return dict(snap, window_s=window_s,
                    planes={api: snap["planes"][api]})

    pool = ServingReplicaSet(factory, drain_timeout_s=30.0)
    pool.grow(1)
    router = ReplicaRouter(pool.addresses(), name="p27c")
    pool.router = router
    scaler = Autoscaler(pool, source=source, name="p27c",
                        poll_interval_s=0.25,
                        policy=AutoscalePolicy(
                            min_replicas=1, max_replicas=2,
                            sustain_polls=2, grow_cooldown_s=1.0,
                            shrink_cooldown_s=1.0))
    rng = np.random.default_rng(seed + 2727)
    stats = {"requests": 0, "retries_503": 0, "retries_conn": 0}
    lock = threading.Lock()
    stop = threading.Event()
    errors = []
    ranks_seen = set()

    def one_request():
        ids = rng.integers(1, cfg.vocab_size, int(rng.integers(8, 48)))
        payload = {"ids": [int(t) for t in ids], "max_new_tokens": new}
        for _ in range(400):
            try:
                res = router.route(api)
            except Exception:            # noqa: BLE001 — a refresh race
                time.sleep(0.02)
                continue
            try:
                p27_post(res.url, payload)
            except urllib.error.HTTPError as e:
                if e.code not in (429, 503):
                    raise
                with lock:
                    stats["retries_503"] += 1
                time.sleep(0.02)
                continue
            except (urllib.error.URLError, ConnectionError):
                with lock:
                    stats["retries_conn"] += 1
                time.sleep(0.02)
                continue
            with lock:
                stats["requests"] += 1
                ranks_seen.add(tuple(res.addr))
            return
        raise AssertionError("27c: a request never got a 200")

    def client(until: threading.Event, think_s: float):
        try:
            while not until.is_set():
                one_request()
                if think_s:
                    time.sleep(think_s)
        except Exception as e:           # re-raised on the calling thread
            errors.append(repr(e))

    # the controller's decisions as the flight ring records them, read
    # while the run goes (the ring is bounded; requests fill it too)
    flight, seen = get_flight(), {}

    def read_flight():
        for e in flight.events():
            if e["kind"] == "autoscale_decide" \
                    and e.get("scaler") == "p27c":
                seen[e["seq"]] = e["verdict"]

    t0 = time.perf_counter()
    L.reset()
    scaler.start()
    trickle = threading.Thread(target=client, args=(stop, 0.1), daemon=True)
    trickle.start()
    try:
        burst_stop = threading.Event()
        burst = [threading.Thread(target=client, args=(burst_stop, 0.0),
                                  daemon=True) for _ in range(burst_threads)]
        for b in burst:
            b.start()
        deadline = time.perf_counter() + burst_s
        grown_at = None
        while time.perf_counter() < deadline or grown_at is None:
            read_flight()
            if pool.replica_count() == 2 and grown_at is None:
                grown_at = time.perf_counter() - t0
                router.probe_all()
            if time.perf_counter() - t0 > burst_s + 30:
                break
            time.sleep(0.05)
        burst_stop.set()
        for b in burst:
            b.join(timeout=120)
        burst_end = time.perf_counter() - t0
        departed = pool.addresses()[-1] if pool.replica_count() == 2 \
            else None
        deadline = time.perf_counter() + idle_s + 30
        shrunk_at = None
        while time.perf_counter() < deadline:
            read_flight()
            if departed is not None and pool.replica_count() == 1:
                shrunk_at = time.perf_counter() - t0
                break
            time.sleep(0.05)
        time.sleep(0.5)                  # the trickle flows past the shrink
        read_flight()
    finally:
        stop.set()
        trickle.join(timeout=60)
        scaler.stop()
        shapes = L.shapes("paged_decode_attention")
        pool.close()
    if errors:
        raise AssertionError(f"27c: clients failed: {errors[:3]}")
    acts = [d.verdict for d in scaler.decisions if d.verdict != "hold"]
    if acts != ["grow", "shrink"] or grown_at is None or shrunk_at is None:
        raise AssertionError(f"27c: decisions {acts}, grown at {grown_at}, "
                             f"shrunk at {shrunk_at}: "
                             f"{[d.reason for d in scaler.decisions][-8:]}")
    evs = [v for _, v in sorted(seen.items()) if v != "hold"]
    key = f"replica:p27c:{departed[0]}:{departed[1]}"
    probe = get_registry().gauge("serving_replica_probe_status", "",
                                 ("router", "rank"))
    if evs != ["grow", "shrink"] or key in PB._breakers \
            or ("p27c", "1") in probe.series():
        raise AssertionError(f"27c: flight {evs}, departed breaker kept "
                             f"{key in PB._breakers}, probe rows "
                             f"{list(probe.series())}")
    if dev.type == "cuda" and not shapes:
        raise AssertionError("27c: K3 never launched")
    return dict(decisions=acts, grown_at_s=grown_at, burst_end_s=burst_end,
                shrunk_at_s=shrunk_at, polls=len(scaler.decisions),
                replicas_routed=len(ranks_seen), launches=shapes,
                reasons=[d.reason for d in scaler.decisions
                         if d.verdict != "hold"], **stats)


def replicated_serving(seed: int, dev, card: str, root: str,
                       exact_cfg: dict, gang_cfg: dict,
                       scale_cfg: dict) -> dict:
    """Phase 27: 27a (:func:`p27_exact`), 27b (:func:`p27_gang`) and 27c
    (:func:`p27_autoscale`), each logged with the card; → their results.
    The parts run small on the CPU when called one by one with tiny
    configs and smaller sizes (``dev`` the CPU)."""
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    out = {}
    try:
        t0 = time.perf_counter()
        out["a"] = p27_exact(seed, dev, p27_config(exact_cfg), root)
        log(f"phase 27a: f32 disaggregated turns equal the colocated "
            f"server's under every handoff outcome, repin → journal resume "
            f"on the survivor | {card}: {json.dumps(out['a'])} in "
            f"{time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        # without the direct run (7.6 s; ROADMAP A0.9's named cut), to
        # make room for phase 28
        out["b"] = p27_gang(seed, dev, gang_cfg, root, direct=False)
        log(f"phase 27b: 2 gloo ranks, an LLMServer each behind the "
            f"gathered routing table, with a PrefillPool and then without, "
            f"rank 1 left mid-run in both passes | {card}: "
            f"{json.dumps(out['b'])} in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        out["c"] = p27_autoscale(seed, dev, root, scale_cfg)
        log(f"phase 27c: the autoscaler grew 1 → 2 under a shedding burst "
            f"and shrank 2 → 1 at idle | {card}: {json.dumps(out['c'])} in "
            f"{time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


# -- phase 28: DL training over a gang of ranks ------------------------------

P28_ROOT = os.path.join(os.path.dirname(CKPT_ROOT), "phase28")
P28_GANG_TIMEOUT_S = 600.0
#: 28a: BERT-base width (d 768, 12 heads, d_ff 3072, seq 128) cut to 2
#: layers, 8 experts on the MoE block (layer 1), top-2, capacity factor
#: 0.5 (choices drop), f32, dropout 0; 8 rows a step
P28_TEXT = dict(vocab_size=30522, max_len=128, num_layers=2, num_heads=12,
                d_model=768, d_ff=3072, num_classes=2, dropout_rate=0.0,
                num_experts=8, moe_top_k=2, moe_capacity_factor=0.5)
#: 28a(v)'s codec fits run 8 steps (12 until phase 30 took their time)
P28_ROWS, P28_STEPS, P28_CODEC_STEPS = 8, 5, 8
P28_OPT = dict(name="adamw", learning_rate=1e-4, weight_decay=0.01,
               schedule="constant", total_steps=P28_CODEC_STEPS,
               grad_clip_norm=1.0)
#: 28a(v)'s codec: int8 with error feedback and the sharded update
P28_CODEC = dict(compression="int8", error_feedback=True,
                 sharded_update=True, min_size=2048)
#: 28a(iv): phase 26c's backbone and images (ResNet-50 at 224²), 16
#: images at batch 8, one epoch (2 steps), f32, sgd (adam's g / |g| would
#: turn the two sums' last-bit differences of near-zero gradients into
#: whole steps)
P28_VISION = dict(backbone="resnet50", n=16, size=224, batch=8, epochs=1)
#: 28a(vi): the data mesh at D=2 with dropout on against the launching
#: process's one-process fit, 32 rows a step, sgd (adamw's g / sqrt(v)
#: turned the two reductions' last-bit differences of near-zero gradients
#: into 1.43e-5 of parameter on the H100, as 28a(iv) notes for adam);
#: losses and parameters within 1e-5
P28_DROP = dict(rows=32, rate=0.1,
                opt=dict(P28_OPT, name="sgd", learning_rate=1e-2))
#: 28b: phase 17b's model at expertParallelism=2 (BERT-base, 8 experts,
#: top-2, batch 128 x 128, bf16): warm-up and window steps
#: (4 steps until phase 30 took their time)
P28_FULL = dict(batch=128, seq=128, experts=8, warmup=1, steps=2)
#: 28b's limits against 17b's one-process steps on the same weights and
#: batch: the largest relative gap of the first warmup + steps losses
#: and of step 1's gradient sums of squares (experts, routers, the rest).
#: Read on the H100: both gaps 0.0 (the expert-parallel step is bit-equal
#: to one process); the limits leave room for last-bit reorderings only
P28_FULL_LIMITS = dict(losses=1e-4, grad_sums=1e-4)
#: 28c: the resumed fit's per-epoch losses against an uninterrupted fit
#: at one rank (absolute; read 1.44e-4 on the H100 and 3.3e-4 small on
#: the CPU: int8 + EF at 2 ranks for the first 4 steps)
P28_ELASTIC_LIMIT = 2e-3
#: 28c: the small text classifier, int8 + EF + sharded update, 144 texts
#: at batch 24 (6 steps an epoch), 2 epochs, a checkpoint every step;
#: rank 1 dies after its fourth checkpoint (the rule fires past 3 passes)
P28_ELASTIC = dict(n=144, batch=24, epochs=2,
                   faults="dl.checkpoint=kill_rank:rank=1:after=3")


def p28_sizes(over: Optional[dict]) -> None:
    """Replace phase 28's sizes (``P28_*``) with ``over``'s, for a small
    run on the CPU; the gang's ranks get the same ``over``."""
    globals().update({k: v for k, v in (over or {}).items()
                      if k.startswith("P28_")})


def empty_cache(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def p28_batches(seed: int, steps: int, rows: int, seq: int, vocab: int):
    """``steps`` seeded (ids, mask, labels) batches of ``rows`` rows."""
    rng = np.random.default_rng(seed + 28)
    out = []
    for _ in range(steps):
        mask = np.ones((rows, seq), bool)
        mask[::3, seq // 2:] = False
        out.append((rng.integers(0, vocab, (rows, seq)).astype(np.int64),
                    mask, rng.integers(0, 2, rows).astype(np.int64)))
    return out


def p28_text_fit(dev, mesh, seed: int, steps: int, rows: int = 0,
                 dropout: float = 0.0, opt: Optional[dict] = None,
                 **trainer_kw) -> dict:
    """28a's text model over ``mesh`` (None: this process alone) from
    ``seed``'s weights: ``steps`` f32 steps (``opt``, default
    ``P28_OPT``) on ``p28_batches`` of ``rows`` rows (0: ``P28_ROWS``)
    at ``dropout``, each rank on its rows
    → losses, this rank's moment bytes, the whole model's state (host)
    after step ``P28_STEPS``, the step seconds and this process's peak
    memory."""
    from synapseml_tpu_torch.models.dl import (DLTrainer, OptimizerConfig,
                                               TextEncoder,
                                               TransformerConfig)
    cfg = TransformerConfig(dtype=torch.float32,
                            **dict(P28_TEXT, dropout_rate=dropout))
    empty_cache(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    model = TextEncoder(cfg, device=dev, seed=None, mesh=mesh)
    tr = DLTrainer(model, OptimizerConfig(**(opt or P28_OPT)), dev,
                   mesh=mesh, **trainer_kw)
    state = tr.init_state(seed)
    step = tr.train_step()
    losses, drop = [], []
    synchronize(dev)
    t0 = time.perf_counter()
    for ids, mask, lab in p28_batches(seed, steps, rows or P28_ROWS,
                                      cfg.max_len, cfg.vocab_size):
        rows = tr.local_rows(np.arange(len(lab)))
        state, m = step(state, tr.shard_batch((ids[rows], mask[rows])),
                        tr.shard_batch((lab[rows],))[0], seed)
        losses.append(float(m["loss"]))
        drop.append(float(model.layer_1.moe_ffn.dropped))
        if len(losses) == P28_STEPS:
            snap = {k: v.detach().cpu().numpy().copy()
                    for k, v in model.full_state_dict().items()}
    step_s = (time.perf_counter() - t0) / steps
    return dict(losses=losses, dropped=drop, step_s=step_s,
                moment_bytes=state.opt.moment_bytes(), state=snap,
                peak_gb=(torch.cuda.max_memory_allocated(dev) / 1e9
                         if dev.type == "cuda" else None))


def p28_save_npz(path: str, arrays: dict) -> None:
    """Write ``arrays`` to ``path`` atomically (a reader polls for it)."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def p28_wait_npz(path: str, timeout_s: float = P28_GANG_TIMEOUT_S) -> dict:
    """The arrays of ``path`` once the launching process has written it."""
    t0 = time.time()
    while not os.path.exists(path):
        if time.time() - t0 > timeout_s:
            raise TimeoutError(f"phase 28: {path} never appeared")
        time.sleep(0.2)
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def p28_max_diff(a: dict, b: dict) -> float:
    return max(float(np.abs(a[k].astype(np.float64) - b[k]).max())
               for k in b)


def p28_vision_fit(seed: int, dev: str, numDevices: int) -> dict:
    """28a(iv): ``DeepVisionClassifier`` on 26c's backbone at f32 →
    probabilities on the images, the BatchNorm running statistics and
    the history."""
    from synapseml_tpu_torch.core import Dataset
    from synapseml_tpu_torch.models.dl import (DeepVisionClassifier,
                                               make_backbone)
    from synapseml_tpu_torch.models.dl.training import to_device
    c = P28_VISION
    imgs, labels = vision_images(np.random.default_rng(seed + 26), c["n"],
                                 c["size"])
    ds = Dataset({"image": list(imgs), "label": labels})
    model = DeepVisionClassifier(
        backbone=c["backbone"], batchSize=c["batch"], maxEpochs=c["epochs"],
        optimizer="sgd", learningRate=1e-2, lrSchedule="constant",
        seed=seed, precision="f32", numDevices=numDevices,
        device=dev).fit(ds)
    var = model.modelPayload["variables"]
    # the probabilities of the fitted f32 model (DeepVisionModel scores
    # in bf16, its default compute dtype)
    net = make_backbone(c["backbone"], num_classes=2, dtype=torch.float32,
                        device=dev, seed=None)
    net.load_state_dict({k: torch.from_numpy(v) for k, v in var.items()})
    with torch.no_grad():
        (x,) = to_device((imgs,), torch.device(dev))
        proba = torch.softmax(net(x, train=False), -1).cpu().numpy()
    return dict(proba=proba, stats={k: v for k, v in var.items()
                                    if k.endswith((".mean", ".var"))},
                history=model.modelPayload["history"])


def grad_sums(model, mesh=None) -> dict:
    """The sums of squares of the last backward's gradients, by group:
    the experts' weights (summed over ``expert``: each rank holds its
    experts), the routers' and every other parameter's."""
    from synapseml_tpu_torch.parallel.collectives import psum
    from synapseml_tpu_torch.parallel.mesh import EXPERT_AXIS, axis_size
    groups = {"expert": [], "router": [], "other": []}
    for k, p in model.named_parameters():
        if p.grad is None:
            continue
        g = ("expert" if k.endswith(("moe_ffn.w_up", "moe_ffn.w_down")) else
             "router" if k.endswith("moe_ffn.router") else "other")
        groups[g].append(p.grad.float().square().sum())
    zero = torch.zeros((), device=next(model.parameters()).device)
    sums = torch.stack([sum(v, zero) for v in groups.values()])
    if axis_size(mesh, EXPERT_AXIS) > 1:
        sums[0] = psum(sums[0], mesh, EXPERT_AXIS, op="phase28b_grad_sums")
    return dict(zip(groups, sums.tolist()))


def p28_full_width(seed: int, dev, mesh) -> dict:
    """28b on this rank: phase 17b's model at expertParallelism=2 in
    bf16: the losses of the first ``warmup + steps`` steps on 17b's batch
    (the same batch every step), step 1's gradient sums, samples/s and
    step ms over a window, this rank's peak memory, and the MoE
    collectives' bytes and seconds a step."""
    from synapseml_tpu_torch.models.dl import (DeepTextClassifier, DLTrainer,
                                               OptimizerConfig, TextEncoder,
                                               resolve_precision)
    from synapseml_tpu_torch.telemetry.gangplane import StepProfiler
    c = P28_FULL
    est = DeepTextClassifier(modelSize="base", vocabSize=30522,
                             maxTokenLen=c["seq"], batchSize=c["batch"],
                             numExperts=c["experts"], moeTopK=2)
    pol = resolve_precision("bf16")
    cfg = dataclasses.replace(est._model_config(2), dtype=pol.compute_dtype,
                              **P28_FULL.get("cfg", {}))
    empty_cache(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    tr = DLTrainer(TextEncoder(cfg, device=dev, seed=None, mesh=mesh),
                   OptimizerConfig(learning_rate=2e-5), dev, precision=pol,
                   mesh=mesh)
    state = tr.init_state(seed)
    wrng = np.random.default_rng(seed)       # 17b's batch
    ids = wrng.integers(0, cfg.vocab_size, (c["batch"], c["seq"])
                        ).astype(np.int32)
    mask = np.ones((c["batch"], c["seq"]), bool)
    lab = wrng.integers(0, 2, c["batch"]).astype(np.int32)
    bi, bm, bl = tr.shard_batch((ids, mask, lab))
    step = tr.train_step()
    state, m = step(state, (bi, bm), bl, seed)
    loss1 = float(m["loss"])
    grad_sq1 = grad_sums(tr.model, mesh)
    losses = [m["loss"]]
    for _ in range(c["warmup"] - 1):
        state, m = step(state, (bi, bm), bl, seed)
        losses.append(m["loss"])
    float(m["loss"])
    ops = ("moe_combine", "moe_token_grad", "moe_gate_grad")

    def moe_bytes():
        from synapseml_tpu_torch.telemetry import get_registry
        c = get_registry().get("collective_bytes_total")
        return sum(c.value(op=o, axis="expert") for o in ops) if c else 0.0

    before = moe_bytes()
    prof = StepProfiler("phase28b")
    t0 = time.perf_counter()
    for i in range(c["steps"]):
        prof.step_begin(i)
        state, m = step(state, (bi, bm), bl, seed)
        synchronize(dev)
        prof.mark("compute")
        prof.step_end()
        losses.append(m["loss"])
    wall = time.perf_counter() - t0
    per_step = (moe_bytes() - before) / c["steps"]
    return dict(loss1=loss1, losses=[float(x) for x in losses],
                grad_sq1=grad_sq1, sps=c["steps"] * c["batch"] / wall,
                step_ms=wall / c["steps"] * 1e3,
                peak_gb=(torch.cuda.max_memory_allocated(dev) / 1e9
                         if dev.type == "cuda" else None),
                moe_allreduce_bytes_per_step=per_step,
                collective_ms_per_step=prof.totals["collective"]
                / c["steps"] * 1e3)


def p28_capture(seed: int, dev: str, mesh) -> dict:
    """28d on this rank: a data-parallel GBDT fit and a DL fit over the
    mesh, each with and without the step profiler's cost capture → the
    fits' digests and the captured costs."""
    import hashlib
    from synapseml_tpu_torch.core import Dataset
    from synapseml_tpu_torch.models.dl import DeepTextClassifier
    from synapseml_tpu_torch.models.gbdt import booster as B
    from synapseml_tpu_torch.telemetry.gangplane import StepProfiler
    X, y, _, _ = p25_data(seed, 65_536, hold=10)
    cfg = B.BoostingConfig(objective="binary", num_iterations=3,
                           num_leaves=31)
    plain, _ = B.train(X, y, cfg, mesh=mesh, device=dev)
    prof = StepProfiler("phase28d_gbdt", capture_xla=True)
    cap, _ = B.train(X, y, cfg, mesh=mesh, device=dev, step_profiler=prof)
    out = {"gbdt": dict(equal=plain.to_string() == cap.to_string(),
                        cost={k: prof.costs["gbdt_step"][k]
                              for k in ("flops", "bytes_accessed")}
                        if prof.costs.get("gbdt_step") else None)}
    rng = np.random.default_rng(seed + 28)
    words = make_words(rng, 2000)
    texts, labels = text_corpus(rng, words, 96)
    ds = Dataset({"text": texts, "label": labels})
    kw = dict(modelSize="tiny", maxTokenLen=64, vocabSize=2048,
              batchSize=32, maxEpochs=1, seed=seed, device=dev)

    def digest(m):
        h = hashlib.md5()
        for k, v in sorted(m.modelPayload["variables"].items()):
            h.update(np.ascontiguousarray(v).tobytes())
        return h.hexdigest()

    dl_prof = StepProfiler("phase28d_dl", capture_xla=True)
    a = DeepTextClassifier(**kw).fit(ds)
    b = DeepTextClassifier(stepProfiler=dl_prof, **kw).fit(ds)
    cost = dl_prof.costs.get("dl_text_step")
    out["dl"] = dict(equal=digest(a) == digest(b),
                     cost=None if cost is None else
                     {k: cost[k] for k in ("flops", "bytes_accessed")})
    return out


def phase28_gang(args: dict) -> dict:
    """One rank of phase 28's two-rank gloo gang on the card: 28a's mesh
    fits held against the one-process fits the launching process wrote,
    28b's full-width expert-parallel window and 28d's captures."""
    from synapseml_tpu_torch.parallel.mesh import (data_parallel_mesh,
                                                   dp_ep_mesh)
    p28_sizes(args.get("sizes"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev_name = args["device"]
    out = dict(task_start_unix=time.time(), **p25_build(dev_name))
    data = data_parallel_mesh(device=dev_name)
    expert = dp_ep_mesh(2, device=dev_name)
    dev, seed = data.device, args["seed"]
    from synapseml_tpu_torch.parallel.compression import CollectiveConfig
    # (i) is the f32 sync's first P28_STEPS steps, (v) runs on to
    # P28_CODEC_STEPS beside the int8 fit
    fits = {"d2": (data, P28_CODEC_STEPS, {}),
            "ep2": (expert, P28_STEPS, {}),
            "zero1": (data, P28_STEPS, {"zero1": True}),
            "int8_ef_sharded": (data, P28_CODEC_STEPS, {
                "collective": CollectiveConfig(**P28_CODEC)})}
    a, states = {}, {}
    for name, (mesh, steps, kw) in fits.items():
        r = p28_text_fit(dev, mesh, seed, steps, **kw)
        states[name] = r.pop("state")
        a[name] = r
    ref = p28_wait_npz(args["reference"])
    for name in ("d2", "ep2", "zero1"):
        a[name]["param_diff"] = p28_max_diff(states.pop(name), ref)
    del states, ref
    # (vi) dropout on: the data mesh against the launching process's
    # one-process fit (each rank draws its rows of those masks)
    d2 = p28_text_fit(dev, data, seed, P28_STEPS, rows=P28_DROP["rows"],
                      dropout=P28_DROP["rate"], opt=P28_DROP["opt"])
    dref = p28_wait_npz(args["dropout_reference"])
    alone = {k[2:]: v for k, v in dref.items() if k.startswith("s.")}
    a["dropout"] = dict(
        losses={"d2": d2["losses"], "alone": dref["losses"].tolist()},
        loss_rel=max(abs(x - y) / abs(y) for x, y in
                     zip(d2["losses"], dref["losses"].tolist())),
        param_diff=p28_max_diff(d2["state"], alone),
        step_ms={"d2": d2["step_s"] * 1e3,
                 "alone": float(dref["step_s"]) * 1e3},
        peak_gb={"d2": d2["peak_gb"], "alone": float(dref["peak_gb"])})
    del d2, dref, alone
    v = p28_vision_fit(seed, dev_name, 0)
    vref = p28_wait_npz(args["vision_reference"])
    a["vision"] = dict(
        proba_rel=float(np.abs(v["proba"] - vref["proba"]).max()
                        / np.abs(vref["proba"]).max()),
        stats_rel=max(float(np.abs(v["stats"][k] - vref[f"s.{k}"]).max()
                            / max(np.abs(vref[f"s.{k}"]).max(), 1e-30))
                      for k in v["stats"]),
        history=v["history"])
    out["a"] = a
    empty_cache(dev)
    out["b"] = p28_full_width(seed, dev, expert)
    empty_cache(dev)
    out["d"] = p28_capture(seed, dev_name, data)
    return out


def phase28_elastic(args: dict) -> dict:
    """28c's rank: the small text classifier with int8 + EF + the sharded
    update over the gang (``numDevices=0``), a checkpoint every step in
    ``$SMLTPU_CKPT_DIR``.  Resumed at one rank, it first copies the
    checkpoint it resumes from, then fits a second time from the copy,
    then once more without a checkpoint → each fit's history, weight
    digest and steps run, the step resumed from and the resize notes."""
    import hashlib
    from synapseml_tpu_torch.core import Dataset
    from synapseml_tpu_torch.core.checkpoint import CheckpointManager
    from synapseml_tpu_torch.models.dl import DeepTextClassifier
    from synapseml_tpu_torch.parallel.compression import CollectiveConfig
    from synapseml_tpu_torch.resilience import get_faults
    from synapseml_tpu_torch.telemetry.gangplane import StepProfiler
    import torch.distributed as dist
    p28_sizes(args.get("sizes"))
    faults = get_faults()
    faults.record_calls = True
    c = P28_ELASTIC
    rng = np.random.default_rng(args["seed"] + 280)
    words = make_words(rng, 2000)
    texts, labels = text_corpus(rng, words, c["n"])
    ds = Dataset({"text": texts, "label": labels})
    ckpt = os.environ["SMLTPU_CKPT_DIR"]
    resumed_from = CheckpointManager(ckpt).latest_step() or 0
    world = dist.get_world_size()
    copy = ckpt.rstrip("/") + "_copy"
    if world == 1 and resumed_from:
        shutil.rmtree(copy, ignore_errors=True)
        shutil.copytree(ckpt, copy)
    kw = dict(modelSize="small", maxTokenLen=64, vocabSize=2048,
              batchSize=c["batch"], maxEpochs=c["epochs"],
              seed=args["seed"], learningRate=1e-3, lrSchedule="constant",
              collectiveCompression=CollectiveConfig(**P28_CODEC),
              device=args["device"])

    def fit(directory):
        prof = StepProfiler("phase28c")
        ck = dict(checkpointDir=directory, checkpointInterval=1) \
            if directory else {}
        m = DeepTextClassifier(stepProfiler=prof, **ck, **kw).fit(ds)
        h = hashlib.md5()
        for k, v in sorted(m.modelPayload["variables"].items()):
            h.update(np.ascontiguousarray(v).tobytes())
        return dict(history=m.modelPayload["history"], md5=h.hexdigest(),
                    steps=prof.steps)

    out = dict(world=world, resumed_from=resumed_from, first=fit(ckpt))
    if world == 1 and resumed_from:
        out["second"] = fit(copy)
        out["uninterrupted"] = fit(None)
    out["resize_notes"] = [dict(n) for n in
                           faults.calls_for("dl.resize_resume")]
    return out


def p28_elastic(seed: int, dev, sizes: Optional[dict]):
    """28c from the launching process: the elastic text fit under a
    ``GangSupervisor`` whose rank 1 dies after its fourth checkpoint
    (``P28_ELASTIC``) → (supervisor, the one rank's result, wall s)."""
    from synapseml_tpu_torch.parallel import GangSupervisor
    from synapseml_tpu_torch.resilience import RetryPolicy
    t0 = time.time()
    sup = GangSupervisor(
        "chip_smoke:phase28_elastic", 2,
        task_args=dict(seed=seed, device=dev.type, sizes=sizes),
        device=dev.type, backend="gloo", timeout_s=P28_GANG_TIMEOUT_S,
        heartbeat_interval_s=1.0,
        checkpoint_dir=os.path.join(P28_ROOT, "elastic"),
        env_extra={"SML_FAULTS": P28_ELASTIC["faults"]}, min_ranks=1,
        shrink_after=1,
        retry_policy=RetryPolicy(max_retries=2, base_s=0.01, seed=seed))
    (one,) = sup.run()
    return sup, one, time.time() - t0


def dl_gang(seed: int, dev, card: str, p17b: Optional[dict] = None,
            sizes: Optional[dict] = None) -> dict:
    """Phase 28 from the launching process: the one-process references on
    the card, the two-rank gloo gang (28a, 28b, 28d) and 28c's elastic
    fit under a supervisor, which runs beside the gang.  ``p17b``: phase
    17b's window (its step-1 loss and peak memory; None: 17b's first step
    runs here).  ``sizes`` replaces ``P28_*`` here and in the ranks (a
    small run with ``dev`` the CPU).  Raises on a failed check."""
    from synapseml_tpu_torch.parallel import run_on_local_cluster
    p28_sizes(sizes)
    shutil.rmtree(P28_ROOT, ignore_errors=True)
    os.makedirs(P28_ROOT)
    ref_path = os.path.join(P28_ROOT, "reference.npz")
    dref_path = os.path.join(P28_ROOT, "dropout_reference.npz")
    vref_path = os.path.join(P28_ROOT, "vision_reference.npz")
    # 28c under its supervisor and the main gang start at once; this
    # process fits the one-process references meanwhile (the ranks wait
    # for them after their own fits)
    from concurrent.futures import ThreadPoolExecutor
    if dev.type == "cuda":
        # this process's CUDA context comes up before the pool's threads
        # start the gangs' processes
        torch.zeros(1, device=dev)
        synchronize(dev)
    pool = ThreadPoolExecutor(2)
    elastic = pool.submit(p28_elastic, seed, dev, sizes)
    t0 = time.time()
    gang = pool.submit(
        run_on_local_cluster, "chip_smoke:phase28_gang", 2,
        task_args=dict(seed=seed, device=dev.type, reference=ref_path,
                       dropout_reference=dref_path,
                       vision_reference=vref_path, sizes=sizes),
        device=dev.type, backend="gloo", timeout_s=P28_GANG_TIMEOUT_S)
    try:
        with ieee_f32():
            one = p28_text_fit(dev, None, seed, P28_STEPS)
            p28_save_npz(ref_path, one["state"])
            drop = p28_text_fit(dev, None, seed, P28_STEPS,
                                rows=P28_DROP["rows"],
                                dropout=P28_DROP["rate"],
                                opt=P28_DROP["opt"])
            p28_save_npz(dref_path, dict(
                losses=np.asarray(drop["losses"]),
                step_s=np.asarray(drop["step_s"]),
                peak_gb=np.asarray(np.nan if drop["peak_gb"] is None
                                   else drop["peak_gb"]),
                **{f"s.{k}": v for k, v in drop.pop("state").items()}))
            vone = p28_vision_fit(seed, str(dev), 1)
            p28_save_npz(vref_path, dict(
                proba=vone["proba"],
                **{f"s.{k}": v for k, v in vone["stats"].items()}))
        if p17b is None:
            r17 = p28_full_width(seed, dev, None)
            p17b = dict(loss1=r17["loss1"], losses_head=r17["losses"],
                        grad_sq1=r17["grad_sq1"], peak_gb=None)
        loss17 = p17b["loss1"]
        log(f"phase 28: one-process references on the card: 28a text "
            f"losses {one['losses']} (dropped {one['dropped']}), vision "
            f"history {vone['history']}, 17b's step-1 loss {loss17:.6f} | "
            f"{card}")
        ranks = gang.result()
        gang_s = time.time() - t0
        sup, one_rank, elastic_s = elastic.result()
    finally:
        pool.shutdown(wait=True)
    out = {"gang_s": gang_s}
    # every reading is printed before a failed check raises
    fails = []
    for r, res in enumerate(ranks):
        a = res["a"]
        for name in ("d2", "ep2", "zero1"):
            base = one if name != "zero1" else a["d2"]
            loss_rel = max(abs(x - y) / abs(y) for x, y in
                           zip(a[name]["losses"][:P28_STEPS],
                               base["losses"]))
            if loss_rel > 1e-5 or a[name]["param_diff"] > 1e-5:
                fails.append(
                    f"phase 28a rank {r} {name}: losses {a[name]['losses']}"
                    f" against {base['losses']} ({loss_rel}), parameters "
                    f"{a[name]['param_diff']} (limits 1e-5)")
        if min(a["d2"]["dropped"]) <= 0:
            fails.append(f"phase 28a: the capacity never dropped "
                                 f"{a['d2']['dropped']}")
        if not a["zero1"]["moment_bytes"] * 2 <= \
                a["d2"]["moment_bytes"] + 64:
            fails.append(f"phase 28a(iii): zero1 holds "
                                 f"{a['zero1']['moment_bytes']} moment "
                                 f"bytes against {a['d2']['moment_bytes']}")
        gap = abs(a["int8_ef_sharded"]["losses"][-1]
                  - a["d2"]["losses"][-1])
        if gap >= 0.05 or not np.isfinite(a["int8_ef_sharded"]["losses"]
                                          ).all():
            fails.append(f"phase 28a(v) rank {r}: int8 loss gap "
                                 f"{gap} after {P28_CODEC_STEPS} steps")
        v = a["vision"]
        if v["proba_rel"] > 1e-4 or v["stats_rel"] > 1e-4:
            fails.append(f"phase 28a(iv) rank {r}: {v}")
        dr = a["dropout"]
        if dr["loss_rel"] > 1e-5 or dr["param_diff"] > 1e-5:
            fails.append(f"phase 28a(vi) rank {r}: dropout {dr}")
        b = res["b"]
        b["gaps"] = gaps = dict(
            losses=max(abs(x - y) / abs(y) for x, y in
                       zip(b["losses"], p17b["losses_head"])),
            grad_sums=max(abs(b["grad_sq1"][k] - y) / abs(y)
                          for k, y in p17b["grad_sq1"].items()))
        if not (np.isfinite(b["losses"]).all()
                and len(b["losses"]) == len(p17b["losses_head"])
                and all(gaps[k] <= P28_FULL_LIMITS[k] for k in gaps)):
            fails.append(
                f"phase 28b rank {r}: losses {b['losses']} and gradient "
                f"sums {b['grad_sq1']} against 17b's {p17b['losses_head']}"
                f" and {p17b['grad_sq1']}: gaps {gaps} (limits "
                f"{P28_FULL_LIMITS})")
        d = res["d"]
        if not (d["gbdt"]["equal"] and d["dl"]["equal"]
                and d["gbdt"]["cost"] and d["dl"]["cost"]):
            fails.append(f"phase 28d rank {r}: {d}")
    if ranks[0]["d"] != ranks[1]["d"]:
        fails.append(f"phase 28d: the ranks captured different "
                             f"costs {ranks[0]['d']} / {ranks[1]['d']}")
    out["a"] = {r: res["a"] for r, res in enumerate(ranks)}
    out["b"] = {r: res["b"] for r, res in enumerate(ranks)}
    out["d"] = ranks[0]["d"]
    log(f"phase 28a: 2 gloo ranks on the card, BERT-base width cut to 2 "
        f"layers with 8 experts top-2 (capacity factor 0.5), f32: the data "
        f"mesh, data 1 x expert 2 and zero1 equal the one-process fit "
        f"(losses, parameters within 1e-5), int8 + EF + sharded update "
        f"within 0.05 of the f32 sync after {P28_CODEC_STEPS} steps, "
        f"ResNet-50 at D=2 equal to one process (rtol 1e-4), the data "
        f"mesh with dropout {P28_DROP['rate']} at {P28_DROP['rows']} rows "
        f"equal to one process (sgd; losses and parameters within 1e-5) "
        f"| {card}: "
        f"{json.dumps(out['a'])}")
    for r, res in enumerate(ranks):
        dr = res["a"]["dropout"]
        log(f"phase 28a(vi) rank {r}: dropout {P28_DROP['rate']}, "
            f"{P28_DROP['rows']} rows a step, D=2 against one process: "
            f"step {dr['step_ms']['d2']:.1f} against "
            f"{dr['step_ms']['alone']:.1f} ms, peak {dr['peak_gb']['d2']} "
            f"against {dr['peak_gb']['alone']} GB, losses within "
            f"{dr['loss_rel']:.3g}, parameters within "
            f"{dr['param_diff']:.3g} | {card}")
    for r, b in out["b"].items():
        log(f"phase 28b rank {r}: phase 17b's model at expertParallelism=2 "
            f"(data 1 x expert 2), bf16, batch {P28_FULL['batch']} x "
            f"{P28_FULL['seq']}: {b['sps']:.1f} samples/s, "
            f"{b['step_ms']:.1f} ms a step, peak {b['peak_gb']} GB "
            f"(17b one process: {p17b['peak_gb']}), MoE all-reduce "
            f"{b['moe_allreduce_bytes_per_step'] / 1e6:.1f} MB and "
            f"{b['collective_ms_per_step']:.1f} ms a step, step-1 loss "
            f"{b['loss1']:.6f} (17b one process {loss17:.6f}), losses of "
            f"steps 1-{len(b['losses'])} {b['losses']} against "
            f"{p17b['losses_head']}, step-1 gradient sums of squares "
            f"{b['grad_sq1']} against {p17b['grad_sq1']}: gaps "
            f"{b['gaps']} (limits {P28_FULL_LIMITS}) | {card}")
    log(f"phase 28d: the cost capture over 2 ranks, GBDT and DL, the same "
        f"on both ranks, fits equal to the uncaptured fits | {card}: "
        f"{json.dumps(out['d'])}")
    if fails:
        raise AssertionError("; ".join(fails))

    # 28c: rank 1 died after its fourth checkpoint, the gang shrank to one
    got = [(e["from"], e["to"]) for e in sup.resize_history]
    first, second = one_rank["first"], one_rank.get("second")
    alone = one_rank.get("uninterrupted")
    losses = [h["loss"] for h in first["history"]]
    # the resumed fit runs only the steps after its checkpoint and ends
    # where an uninterrupted one-rank fit ends (its history holds the
    # epochs it ran to their end)
    tail = alone["history"][-len(losses):] if alone and losses else []
    gap = (max(abs(h - u["loss"]) for h, u in zip(losses, tail))
           if len(tail) == len(losses) else None)
    if got != [(2, 1)] or one_rank["world"] != 1 \
            or one_rank["resumed_from"] < 4 or second is None \
            or first != second \
            or one_rank["resize_notes"] != [{"saved": 2, "current": 1}] * 2 \
            or not np.isfinite(losses).all() \
            or gap is None or gap > P28_ELASTIC_LIMIT \
            or first["steps"] != alone["steps"] - one_rank["resumed_from"]:
        raise AssertionError(f"phase 28c: resizes {got}, gap {gap}, "
                             f"{one_rank}")
    out["c"] = dict(wall_s=elastic_s, restarts=sup.restarts,
                    recovery_s=sup.last_recovery_s, **one_rank)
    log(f"phase 28c: int8 + EF + sharded update over 2 ranks, rank 1 "
        f"killed after its fourth checkpoint, shrunk to 1 rank: resumed from "
        f"step {one_rank['resumed_from']} (noted 2 -> 1), ran "
        f"{first['steps']} of {alone['steps']} steps, two resumes "
        f"bit-identical, losses {losses} against the uninterrupted one-rank "
        f"fit's {[u['loss'] for u in tail]} (gap {gap:.3g}, "
        f"limit {P28_ELASTIC_LIMIT}) | {card}: "
        f"{json.dumps(out['c'])}")
    shutil.rmtree(P28_ROOT, ignore_errors=True)
    return out


# -- phase 29: model parallelism over a gang -----------------------------------

P29_ROOT = os.path.join(os.path.dirname(CKPT_ROOT), "phase29")
P29_GANG_TIMEOUT_S = 600.0
#: 29a: BERT-base (12 layers, d 768, 12 heads, d_ff 3072, sequence 128)
#: at modelParallelism=2 through the text classifier's trainer: 5 adamw
#: steps at batch 32, dropout 0.1, f32 with IEEE products, against one
#: process from the same seed's weights and batches
P29_TEXT = dict(cfg=dict(vocab_size=30522, max_len=128, num_layers=12,
                         num_heads=12, d_model=768, d_ff=3072,
                         num_classes=2, dropout_rate=0.1),
                batch=32, steps=5, lr=1e-4)
#: 29a's limits: phase 28a's data-mesh limits (losses relative,
#: parameters absolute); its data mesh read 2.3e-6 on the H100
P29_TEXT_LIMITS = dict(losses=1e-5, params=1e-5)
#: 29b: Llama-3.2-1B's shapes (16 layers, d 2048, 32 heads, 8 key-value
#: heads, d_ff 8192, tied 128,256-token head) in f32 at tp=2: greedy
#: generate of 16 new tokens for 4 prompts of 32 tokens
P29_LLAMA = dict(cfg=dict(max_len=64), prompts=4, prompt_len=32, new=16)
#: 29b's limit on the first step's logits against one process (absolute;
#: f32 sums in another order through 16 layers)
P29_LLAMA_LIMIT = 1e-4
#: 29c: ring attention at BERT-base head widths, B 1, S 8192 over seq=2
P29_RING = dict(B=1, S=8192, H=12, D=64)
#: 29c's limit on the output and on the q/k/v gradients of Σ out·w
#: against full attention in one process (the reference's own at long
#: sequences)
P29_RING_LIMIT = 2e-5
#: 29d: BERT-base's 12 blocks as 2 stages of 6, 4 microbatches of 8 rows
#: of 128 tokens, dropout off, f32
P29_PIPE = dict(cfg=dict(vocab_size=30522, max_len=128, num_layers=12,
                         num_heads=12, d_model=768, d_ff=3072,
                         num_classes=2, dropout_rate=0.0),
                stages=2, micro=4, mb=8)
#: 29d's limits: the reference's (tests/test_pipeline_parallel.py)
P29_PIPE_LIMITS = dict(loss_rtol=5e-5, grad_rtol=2e-3, grad_atol=1e-5)


def p29_sizes(over: Optional[dict]) -> None:
    """Replace phase 29's sizes (``P29_*``) with ``over``'s, for a small
    run (tests/test_torch_dl_tp_cuda.py, the CPU)."""
    for k, v in (over or {}).items():
        globals()[k] = v


def p29_model_axis_ops() -> dict:
    """This process's all-reduce calls and bytes over the ``model`` axis
    so far (the counters of parallel.collectives)."""
    from synapseml_tpu_torch.telemetry import get_registry
    out = {}
    for name in ("collective_calls_total", "collective_bytes_total"):
        c = get_registry().get(name)
        out[name] = sum(v for (op, axis), v in
                        (c.series().items() if c else ())
                        if axis == "model" and op.startswith("tp_"))
    return out


def p29_text_batches(seed: int):
    c = P29_TEXT
    rng = np.random.default_rng(seed + 29)
    seq, vocab = c["cfg"]["max_len"], c["cfg"]["vocab_size"]
    out = []
    for _ in range(c["steps"]):
        mask = np.ones((c["batch"], seq), bool)
        mask[::3, seq // 2:] = False
        out.append((rng.integers(0, vocab, (c["batch"], seq)).astype(
            np.int64), mask, rng.integers(0, 2, c["batch"]).astype(np.int64)))
    return out


def p29_text(dev, mesh, seed: int) -> dict:
    """29a on this process (``mesh`` None: alone): BERT-base through
    ``DLTrainer`` from ``seed``'s weights → losses, the whole model's
    state (host), step ms, peak GB and the model axis's all-reduces a
    step."""
    from synapseml_tpu_torch.models.dl import (DLTrainer, OptimizerConfig,
                                               TextEncoder,
                                               TransformerConfig)
    c = P29_TEXT
    cfg = TransformerConfig(dtype=torch.float32, **c["cfg"])
    empty_cache(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    model = TextEncoder(cfg, device=dev, seed=None, mesh=mesh)
    tr = DLTrainer(model, OptimizerConfig(learning_rate=c["lr"],
                                          grad_clip_norm=1.0), dev,
                   mesh=mesh)
    state = tr.init_state(seed)
    from synapseml_tpu_torch.telemetry.flight import get_flight
    step = tr.train_step()
    losses, times, waits = [], [], []
    before = p29_model_axis_ops()
    for ids, mask, lab in p29_text_batches(seed):
        synchronize(dev)
        t0 = time.perf_counter()
        seq = get_flight().last_seq
        rows = tr.local_rows(np.arange(len(lab)))
        state, m = step(state, tr.shard_batch((ids[rows], mask[rows])),
                        tr.shard_batch((lab[rows],))[0], seed)
        losses.append(float(m["loss"]))
        times.append(time.perf_counter() - t0)
        # the host's seconds inside the model axis's collectives (the
        # flight ring's collective.end events, the backward's included)
        waits.append(sum(e.get("seconds", 0.0) for e in
                         get_flight().events_since(seq)
                         if e["kind"] == "collective.end"
                         and e.get("axis") == "model"))
    after = p29_model_axis_ops()
    n = len(losses)
    state_np = {k: v.detach().cpu().numpy()
                for k, v in model.full_state_dict().items()}
    return dict(losses=losses, state=state_np,
                # the first step pays the allocator's growth
                step_ms=float(np.median(times[1:] or times)) * 1e3,
                step_ms_all=[t * 1e3 for t in times],
                collective_ms=float(np.median(waits[1:] or waits)) * 1e3,
                peak_gb=(torch.cuda.max_memory_allocated(dev) / 1e9
                         if dev.type == "cuda" else None),
                model_allreduces_per_step=(
                    after["collective_calls_total"]
                    - before["collective_calls_total"]) / n,
                model_allreduce_mb_per_step=(
                    after["collective_bytes_total"]
                    - before["collective_bytes_total"]) / n / 1e6)


def p29_prompts(seed: int, vocab: int) -> np.ndarray:
    c = P29_LLAMA
    return np.random.default_rng(seed + 290).integers(
        1, vocab, (c["prompts"], c["prompt_len"])).astype(np.int32)


def p29_llama(dev, mesh, seed: int) -> dict:
    """29b on this process: the f32 Llama (sharded over ``mesh``'s model
    axis, or whole) from ``seed`` → the first step's logits (the
    prompts' last position), the greedy tokens and ms a token."""
    from synapseml_tpu_torch.models.llm import (LlamaConfig, LlamaModel,
                                                generate)
    c = P29_LLAMA
    cfg = LlamaConfig.llama3_1b(dtype=torch.float32, **c["cfg"])
    empty_cache(dev)
    model = LlamaModel(cfg, device=dev, seed=seed, mesh=mesh)
    prompts = p29_prompts(seed, cfg.vocab_size)
    with torch.no_grad():
        first = model(torch.as_tensor(prompts, device=dev))[:, -1]
    first = first.cpu().numpy()
    generate(model, prompts[:, :4], max_new_tokens=2)        # warm-up
    synchronize(dev)
    t0 = time.perf_counter()
    tokens = generate(model, prompts, max_new_tokens=c["new"])
    synchronize(dev)
    wall = time.perf_counter() - t0
    del model
    empty_cache(dev)
    return dict(first=first, tokens=tokens,
                ms_per_token=wall / c["new"] * 1e3)


def p29_ring_inputs(seed: int):
    c = P29_RING
    rng = np.random.default_rng(seed + 291)
    shape = (c["B"], c["S"], c["H"], c["D"])
    q, k, v, w = [rng.normal(size=shape).astype(np.float32)
                  for _ in range(4)]
    mask = np.ones((c["B"], c["S"]), bool)
    mask[:, c["S"] - c["S"] // 16:] = False
    return dict(q=q, k=k, v=v, w=w, mask=mask)


def p29_ring(dev, mesh, seed: int) -> dict:
    """29c: ``mesh`` given, this rank's ring attention block and its
    q/k/v gradients of ``Σ out·w`` (gathered over ``seq``); None, full
    attention in this process with autograd.  → out, dq, dk, dv (host)
    and the wall ms."""
    from synapseml_tpu_torch.models.dl.ring_attention import (ring_attention,
                                                              shard_blocks)
    z = p29_ring_inputs(seed)
    empty_cache(dev)
    synchronize(dev)
    t0 = time.perf_counter()
    if mesh is not None:
        from synapseml_tpu_torch.parallel.collectives import all_gather
        q, k, v = [shard_blocks(z[n], mesh).requires_grad_(True)
                   for n in ("q", "k", "v")]
        w, mask = shard_blocks(z["w"], mesh), shard_blocks(z["mask"], mesh)
        out = ring_attention(q, k, v, mask, mesh)
        (out * w).sum().backward()

        def whole(t):
            parts = all_gather(t.detach().contiguous(), mesh, "seq")
            return torch.cat(list(parts.unbind(0)), dim=1).cpu().numpy()

        rec = dict(out=whole(out), dq=whole(q.grad), dk=whole(k.grad),
                   dv=whole(v.grad))
    else:
        q, k, v = [torch.as_tensor(z[n], device=dev).requires_grad_(True)
                   for n in ("q", "k", "v")]
        D = q.shape[-1]
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / float(np.sqrt(D))
        logits = logits.masked_fill(
            ~torch.as_tensor(z["mask"], device=dev)[:, None, None],
            float(np.finfo(np.float32).min))
        out = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(logits, -1), v)
        (out * torch.as_tensor(z["w"], device=dev)).sum().backward()
        del logits
        rec = dict(out=out.detach().cpu().numpy(),
                   dq=q.grad.cpu().numpy(), dk=k.grad.cpu().numpy(),
                   dv=v.grad.cpu().numpy())
    synchronize(dev)
    rec["ms"] = (time.perf_counter() - t0) * 1e3
    empty_cache(dev)
    return rec


def p29_pipe(dev, mesh, seed: int) -> dict:
    """29d: ``mesh`` given (a ``pipe`` axis), ``pp_train_loss`` over it
    and its gradients (stage leaves gathered over ``pipe``); None, the
    sequential TextEncoder's loss and gradients.  Both from ``seed``'s
    weights on the same batch; the step (forward + backward) runs twice
    from fresh gradients → loss, gradients (host) of the second, and the
    first (``first_ms``) and second (``ms``) steps' wall ms."""
    from synapseml_tpu_torch.models.dl import (TextEncoder,
                                               TransformerConfig)
    from synapseml_tpu_torch.models.dl.pipeline import (merge_encoder_stages,
                                                        pp_train_loss,
                                                        split_encoder_stages)
    c = P29_PIPE
    cfg = TransformerConfig(dtype=torch.float32, **c["cfg"])
    B = c["micro"] * c["mb"]
    rng = np.random.default_rng(seed + 292)
    S = cfg.max_len
    ids = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)),
                          device=dev)
    mask = torch.ones((B, S), dtype=torch.bool, device=dev)
    mask[::4, S // 2:] = False
    labels = torch.as_tensor(rng.integers(0, cfg.num_classes, B),
                             device=dev)
    empty_cache(dev)
    model = TextEncoder(cfg, device=dev, seed=seed)
    if mesh is not None:
        from synapseml_tpu_torch.parallel.pipeline import local_stage
        whole = {k: v.detach() for k, v in model.state_dict().items()}
        del model
        outer0, stacked = split_encoder_stages(whole, c["stages"])
        mine0 = local_stage(stacked, mesh)
        loss_fn = pp_train_loss(cfg, mesh, c["micro"])
    times = []
    for _ in range(2):
        synchronize(dev)
        t0 = time.perf_counter()
        if mesh is None:
            model.zero_grad()
            loss = torch.nn.functional.cross_entropy(
                model(ids, mask).float(), labels)
            loss.backward()
        else:
            outer = {k: v.clone().requires_grad_(True)
                     for k, v in outer0.items()}
            mine = {k: v.clone().requires_grad_(True)
                    for k, v in mine0.items()}
            loss = loss_fn(outer, mine, ids, mask, labels)
            loss.backward()
        synchronize(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    if mesh is None:
        grads = {k: p.grad.cpu().numpy()
                 for k, p in model.named_parameters()}
    else:
        from synapseml_tpu_torch.parallel.collectives import all_gather
        gathered = {k: torch.cat(list(all_gather(
            v.grad, mesh, "pipe").unbind(0))) for k, v in mine.items()}
        grads = {k: v.cpu().numpy() for k, v in merge_encoder_stages(
            {k: v.grad for k, v in outer.items()}, gathered).items()}
    empty_cache(dev)
    return dict(loss=float(loss.detach()), grads=grads, first_ms=times[0],
                ms=times[1])


def phase29_gang(args: dict) -> dict:
    """One rank of phase 29's two-rank gloo gang on the card: 29a on the
    (data 1, model 2) mesh, 29b on a model axis of 2, 29c on (data 1,
    seq 2), 29d on pipe 2.  Rank 0 writes each part's arrays under
    ``args["root"]``; every rank returns its readings."""
    from synapseml_tpu_torch.parallel.mesh import ProcessMesh, dp_tp_mesh
    p29_sizes(args.get("sizes"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev_name, seed, root = args["device"], args["seed"], args["root"]
    out = dict(task_start_unix=time.time())
    walls = {}
    t0 = time.perf_counter()
    tp = dp_tp_mesh(2, device=dev_name)
    dev = tp.device
    rank0 = tp.rank == 0
    a = p29_text(dev, tp, seed)
    if rank0:
        p28_save_npz(os.path.join(root, "a.npz"), a.pop("state"))
    a.pop("state", None)
    out["a"] = a
    walls["a"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    b = p29_llama(dev, tp, seed)
    if rank0:
        p28_save_npz(os.path.join(root, "b.npz"),
                     dict(first=b["first"], tokens=b["tokens"]))
    out["b"] = dict(ms_per_token=b["ms_per_token"],
                    tokens=b["tokens"].tolist())
    walls["b"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    c = p29_ring(dev, ProcessMesh({"data": 1, "seq": 2}, device=dev_name),
                 seed)
    if rank0:
        p28_save_npz(os.path.join(root, "c.npz"),
                     {k: v for k, v in c.items() if k != "ms"})
    out["c"] = dict(ms=c["ms"])
    walls["c"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    d = p29_pipe(dev, ProcessMesh({"pipe": 2}, device=dev_name), seed)
    if rank0:
        p28_save_npz(os.path.join(root, "d.npz"),
                     {"loss": np.asarray(d["loss"]), **{
                         f"g.{k}": v for k, v in d["grads"].items()}})
    out["d"] = dict(loss=d["loss"], ms=d["ms"], first_ms=d["first_ms"])
    walls["d"] = time.perf_counter() - t0
    out["walls"] = walls
    return out


def model_parallel(seed: int, dev, card: str,
                   sizes: Optional[dict] = None) -> dict:
    """Phase 29 from the launching process: the two-rank gloo gang on the
    card (``phase29_gang``) and, beside it, the one-process references
    here; then every check.  ``sizes`` replaces ``P29_*`` here and in the
    ranks (a small run).  Raises on a failed check, after printing every
    reading."""
    from concurrent.futures import ThreadPoolExecutor

    from synapseml_tpu_torch.parallel import run_on_local_cluster
    p29_sizes(sizes)
    shutil.rmtree(P29_ROOT, ignore_errors=True)
    os.makedirs(P29_ROOT)
    if dev.type == "cuda":
        torch.zeros(1, device=dev)
        synchronize(dev)
    pool = ThreadPoolExecutor(1)
    t0 = time.time()
    gang = pool.submit(
        run_on_local_cluster, "chip_smoke:phase29_gang", 2,
        task_args=dict(seed=seed, device=dev.type, root=P29_ROOT,
                       sizes=sizes),
        device=dev.type, backend="gloo", timeout_s=P29_GANG_TIMEOUT_S)
    try:
        with ieee_f32():
            one = dict(a=p29_text(dev, None, seed))
            one["b"] = p29_llama(dev, None, seed)
            one["c"] = p29_ring(dev, None, seed)
            one["d"] = p29_pipe(dev, None, seed)
        ranks = gang.result()
    finally:
        pool.shutdown(wait=True)
    gang_s = time.time() - t0
    fails = []
    # 29a: losses and the final parameters against one process
    a1 = one["a"]
    got = p28_wait_npz(os.path.join(P29_ROOT, "a.npz"))
    a_loss = max(abs(x - y) / abs(y) for r in ranks for x, y in
                 zip(r["a"]["losses"], a1["losses"]))
    a_param = p28_max_diff(got, a1["state"])
    if a_loss > P29_TEXT_LIMITS["losses"] or \
            a_param > P29_TEXT_LIMITS["params"] or \
            not np.isfinite([x for r in ranks for x in r["a"]["losses"]]).all():
        fails.append(f"phase 29a: losses {[r['a']['losses'] for r in ranks]}"
                     f" against {a1['losses']} ({a_loss:.3g}), parameters "
                     f"{a_param:.3g} (limits {P29_TEXT_LIMITS})")
    # 29b: the first step's logits, then the tokens
    b1 = one["b"]
    bz = p28_wait_npz(os.path.join(P29_ROOT, "b.npz"))
    b_logit = float(np.abs(bz["first"] - b1["first"]).max())
    if b_logit > P29_LLAMA_LIMIT:
        fails.append(f"phase 29b: first-step logits differ by {b_logit:.3g} "
                     f"(limit {P29_LLAMA_LIMIT})")
    divergence = None
    tok_tp, tok_one = bz["tokens"], b1["tokens"]
    if any(r["b"]["tokens"] != tok_tp.tolist() for r in ranks):
        fails.append("phase 29b: the ranks generated different tokens")
    if not np.array_equal(tok_tp, tok_one):
        row, col = [int(i[0]) for i in np.nonzero(tok_tp != tok_one)]
        # the one-process logits at the first divergence: their top-2 gap
        from synapseml_tpu_torch.models.llm import LlamaConfig, LlamaModel
        cfg = LlamaConfig.llama3_1b(dtype=torch.float32, **P29_LLAMA["cfg"])
        model = LlamaModel(cfg, device=dev, seed=seed)
        ctx = np.concatenate([p29_prompts(seed, cfg.vocab_size)[row],
                              tok_one[row, :col]])
        with torch.no_grad(), ieee_f32():
            lg = model(torch.as_tensor(ctx[None], device=dev))[0, -1]
        top = torch.topk(lg.float(), 2).values.cpu().numpy()
        del model
        empty_cache(dev)
        divergence = dict(row=row, token=col, top2_gap=float(top[0] - top[1]))
        log(f"phase 29b: tokens part at row {row}, token {col}: the top-2 "
            f"logit gap there is {divergence['top2_gap']:.3g} (limit "
            f"{P29_LLAMA_LIMIT})")
        if divergence["top2_gap"] >= P29_LLAMA_LIMIT:
            fails.append(f"phase 29b: tokens differ at {divergence}")
    # 29c: output and gradients within the limit of full attention
    cz = p28_wait_npz(os.path.join(P29_ROOT, "c.npz"))
    c_err = {k: float(np.abs(cz[k] - one["c"][k]).max())
             for k in ("out", "dq", "dk", "dv")}
    if max(c_err.values()) > P29_RING_LIMIT:
        fails.append(f"phase 29c: ring against full attention {c_err} "
                     f"(limit {P29_RING_LIMIT})")
    # 29d: the pipelined loss and gradients against the sequential model
    dz = p28_wait_npz(os.path.join(P29_ROOT, "d.npz"))
    d1 = one["d"]
    L = P29_PIPE_LIMITS
    d_loss = abs(float(dz["loss"]) - d1["loss"]) / abs(d1["loss"])
    # each leaf's largest error as a share of what the reference's
    # allclose allows (atol + rtol |want|): over 1 fails
    d_grad, worst = 0.0, None
    for k, want in d1["grads"].items():
        share = float(np.max(np.abs(dz[f"g.{k}"] - want)
                             / (L["grad_atol"] + L["grad_rtol"]
                                * np.abs(want))))
        if share > d_grad:
            d_grad, worst = share, k
    if d_loss > L["loss_rtol"] or d_grad > 1.0 or \
            any(abs(r["d"]["loss"] - float(dz["loss"])) > 0 for r in ranks):
        fails.append(f"phase 29d: loss {float(dz['loss'])} against "
                     f"{d1['loss']} ({d_loss:.3g}), gradient {worst} at "
                     f"{d_grad:.3g} of its allowance {L}")
    out = dict(
        gang_s=gang_s, walls={r: res["walls"] for r, res in
                              enumerate(ranks)},
        a=dict(loss_rel=a_loss, param_diff=a_param,
               losses=ranks[0]["a"]["losses"], one_losses=a1["losses"],
               step_ms={r: res["a"]["step_ms"] for r, res in
                        enumerate(ranks)},
               one_step_ms=a1["step_ms"],
               peak_gb={r: res["a"]["peak_gb"] for r, res in
                        enumerate(ranks)},
               one_peak_gb=a1["peak_gb"],
               allreduces_per_step=ranks[0]["a"]["model_allreduces_per_step"],
               collective_ms={r: res["a"]["collective_ms"] for r, res in
                              enumerate(ranks)},
               allreduce_mb_per_step=ranks[0]["a"][
                   "model_allreduce_mb_per_step"]),
        b=dict(logit_diff=b_logit, tokens_equal=bool(
            np.array_equal(tok_tp, tok_one)), divergence=divergence,
            ms_per_token={r: res["b"]["ms_per_token"] for r, res in
                          enumerate(ranks)},
            one_ms_per_token=b1["ms_per_token"]),
        c=dict(err=c_err, ms={r: res["c"]["ms"] for r, res in
                              enumerate(ranks)}, one_ms=one["c"]["ms"]),
        d=dict(loss=float(dz["loss"]), one_loss=d1["loss"], loss_rel=d_loss,
               grad_share=d_grad, grad_worst=worst,
               ms={r: res["d"]["ms"] for r, res in enumerate(ranks)},
               first_ms={r: res["d"]["first_ms"] for r, res in
                         enumerate(ranks)},
               one_ms=d1["ms"], one_first_ms=d1["first_ms"]))
    a = out["a"]
    log(f"phase 29a: BERT-base at modelParallelism=2 (2 gloo ranks on the "
        f"card), f32, dropout {P29_TEXT['cfg']['dropout_rate']}, batch "
        f"{P29_TEXT['batch']}: losses {a['losses']} against one process "
        f"{a['one_losses']} (within {a['loss_rel']:.3g}), parameters within "
        f"{a['param_diff']:.3g} (limits {P29_TEXT_LIMITS}); step ms "
        f"{a['step_ms']} against {a['one_step_ms']:.1f}; "
        f"{a['allreduces_per_step']:.0f} all-reduces over model a step, "
        f"{a['allreduce_mb_per_step']:.1f} MB, {a['collective_ms']} ms of "
        f"collectives a step; peak GB a rank "
        f"{a['peak_gb']} against {a['one_peak_gb']} | {card}")
    b = out["b"]
    log(f"phase 29b: Llama-3.2-1B shapes, f32, tp=2: first-step logits "
        f"within {b['logit_diff']:.3g} of one process (limit "
        f"{P29_LLAMA_LIMIT}), tokens equal {b['tokens_equal']}; ms a token "
        f"{b['ms_per_token']} against {b['one_ms_per_token']:.2f} "
        f"({P29_LLAMA['prompts']} prompts of {P29_LLAMA['prompt_len']}, "
        f"{P29_LLAMA['new']} new) | {card}")
    c = out["c"]
    log(f"phase 29c: ring attention over seq=2, B {P29_RING['B']}, S "
        f"{P29_RING['S']}, H {P29_RING['H']}, D {P29_RING['D']}, f32: "
        f"output and q/k/v gradients within {c['err']} of full attention "
        f"(limit {P29_RING_LIMIT}); ms forward + backward {c['ms']} against "
        f"{c['one_ms']:.1f} | {card}")
    d = out["d"]
    log(f"phase 29d: GPipe, BERT-base width's "
        f"{P29_PIPE['cfg']['num_layers']} blocks as {P29_PIPE['stages']} "
        f"stages, {P29_PIPE['micro']} microbatches of {P29_PIPE['mb']}: loss "
        f"{d['loss']:.7f} against {d['one_loss']:.7f} ({d['loss_rel']:.3g}),"
        f" gradients within {d['grad_share']:.3g} of the allowed error "
        f"(atol + rtol |g|, worst {d['grad_worst']}; limits "
        f"{P29_PIPE_LIMITS}); a step's forward + backward ms {d['ms']} "
        f"against {d['one_ms']:.1f} (first steps {d['first_ms']} against "
        f"{d['one_first_ms']:.1f}) | {card}")
    log(f"phase 29: gang {gang_s:.1f} s, rank walls {json.dumps(out['walls'])}")
    shutil.rmtree(P29_ROOT, ignore_errors=True)
    if fails:
        raise AssertionError("; ".join(fails))
    return out


# -- phase 30: the stages over the GBDT (ROADMAP A8) ---------------------------

#: 30a's frame: bench.py's 28 columns (one column each), an 8-level
#: string column and a string label; 30b's and 30c's rows
P30_LEVELS = 8
P30_ITERS = 10
P30_TUNE_ROWS = 250_000
#: 30c's rows: 125,000 (at 250,000 DML took 21.0 s and the forest 12.5 s
#: of a 1,146 s run, ROADMAP A0.9)
P30_DML_ROWS = 125_000
#: the card-against-CPU rows of 30a, and of 30c's DML (at 20,000 the
#: latter took 22.1 s, most of it the CPU's nuisance fits)
P30_SMALL = 20_000
P30_DML_SMALL = 5_000
#: 30c's nuisance models: enough boosting that the residuals leave little
#: of the confounding behind (the ATE's bias is the nuisance fits' error)
P30_NUISANCE = dict(numIterations=40, learningRate=0.3)
#: the nuisance models of 30c's card-against-CPU run: 10 iterations (40
#: took 29.8 s on the CPU at one bootstrap iteration)
P30_CHECK_NUISANCE = dict(P30_NUISANCE, numIterations=10)


def a8_frame(rng, n: int, F: int = 28) -> dict:
    """30a's columns: x0..x27 (bench.py's task), ``color`` (8 levels, two
    of them in the label's score) and the label as "yes"/"no"."""
    X = rng.normal(size=(n, F)).astype(np.float32)
    color = rng.integers(0, P30_LEVELS, n)
    y = gbdt_labels(rng, X, extra=(color == 1) * 1.0 - (color == 5) * 1.0)
    cols = {f"x{i}": X[:, i] for i in range(F)}
    cols["color"] = [f"c{c}" for c in color]
    cols["label"] = np.where(y > 0, "yes", "no").astype(object)
    return cols


class VerbTimes:
    """The per-verb records the port's stages log (``core.logging``):
    seconds summed by (class, verb) while the block is open."""

    def __init__(self):
        import logging

        class _H(logging.Handler):
            def emit(h, record):
                try:
                    d = json.loads(record.getMessage())
                except (ValueError, TypeError):
                    return
                if "elapsedMs" in d:
                    k = (d["className"], d["method"])
                    self.s[k] = self.s.get(k, 0.0) + d["elapsedMs"] / 1e3
        self.s = {}
        self._h = _H()

    def __enter__(self):
        from synapseml_tpu_torch.core.logging import logger
        self._level = logger.level
        logger.setLevel("INFO")
        logger.addHandler(self._h)
        return self

    def __exit__(self, *exc):
        from synapseml_tpu_torch.core.logging import logger
        logger.removeHandler(self._h)
        logger.setLevel(self._level)

    def get(self, cls: str, verb: str) -> float:
        return self.s.get((cls, verb), 0.0)


def a8_train(cols: dict, hold: dict, dev, iters: int):
    """``TrainClassifier(GBDTClassifier)`` fit on ``cols``, then transform
    and ``ComputeModelStatistics`` on ``hold``, the launch counts reset
    just before the fit and read just after it.  → (readings, model)."""
    from synapseml_tpu_torch.core import Dataset
    from synapseml_tpu_torch.kernels import launches as L
    from synapseml_tpu_torch.models.gbdt.estimators import GBDTClassifier
    from synapseml_tpu_torch.ops import ComputeModelStatistics, TrainClassifier
    ds, hds = Dataset(dict(cols)), Dataset(dict(hold))
    with VerbTimes() as vt:
        L.reset()
        t0 = time.perf_counter()
        model = TrainClassifier(model=GBDTClassifier(
            numIterations=iters, device=dev.type), labelCol="label").fit(ds)
        synchronize(dev)
        fit_s = time.perf_counter() - t0
        shapes = L.snapshot()
        fit_verbs = dict(vt.s)
        vt.s.clear()
        t0 = time.perf_counter()
        out = model.transform(hds)
        transform_s = time.perf_counter() - t0
        tr_verbs = dict(vt.s)
    stats = ComputeModelStatistics(
        labelCol="label", scoredLabelsCol="prediction",
        scoresCol="probability", evaluationMetric="classification"
    ).transform(out)
    inner = model.innerModel
    m = inner.training_measures
    proba = np.stack(out["probability"])
    if proba.shape != (len(hold["label"]), 2) or not np.all(
            np.isfinite(proba)):
        raise AssertionError(f"30a: transform gave {proba.shape} or "
                             "non-finite probabilities")
    if not set(out["prediction"]) <= {"yes", "no"}:
        raise AssertionError("30a: predictions are not the label values")

    def verbs(d, cls_verbs):
        return sum(d.get(k, 0.0) for k in cls_verbs)
    r = dict(
        rows=len(cols["label"]), features=int(inner.booster.bin_mapper
                                                .num_features),
        fit_s=fit_s, transform_s=transform_s,
        featurize_s=verbs(fit_verbs, [("Featurize", "fit"),
                                      ("FeaturizeModel", "transform")]),
        index_s=verbs(fit_verbs, [("ValueIndexer", "fit"),
                                  ("ValueIndexerModel", "transform")]),
        gbdt_fit_s=fit_verbs.get(("GBDTClassifier", "fit"), 0.0),
        train_s=m.training_s, binning_s=m.binning_s,
        s_per_iter=m.seconds_per_iteration(),
        transform_featurize_s=tr_verbs.get(("FeaturizeModel", "transform"),
                                           0.0),
        transform_gbdt_s=tr_verbs.get(("GBDTClassificationModel",
                                       "transform"), 0.0),
        auc=float(stats["AUC"][0]), accuracy=float(stats["accuracy"][0]),
        shapes=shapes)
    return r, model


def a8_tune(X, y, dev, parallelism: int, iters: int):
    """30b: ``TuneHyperparameters`` over ``GBDTClassifier`` on the
    2 x 2 grid at ``parallelism``, the launch counts reset just before
    and read just after."""
    from synapseml_tpu_torch.automl import (DiscreteHyperParam, GridSpace,
                                            HyperparamBuilder,
                                            TuneHyperparameters)
    from synapseml_tpu_torch.core import Dataset
    from synapseml_tpu_torch.kernels import launches as L
    from synapseml_tpu_torch.models.gbdt.estimators import GBDTClassifier
    est = GBDTClassifier(numIterations=iters, device=dev.type)
    space = GridSpace(HyperparamBuilder()
                      .add_hyperparam(est, "numLeaves",
                                      DiscreteHyperParam([15, 31]))
                      .add_hyperparam(est, "learningRate",
                                      DiscreteHyperParam([0.1, 0.2]))
                      .build())
    ds = Dataset({"features": list(X), "label": y})
    L.reset()
    t0 = time.perf_counter()
    m = TuneHyperparameters(models=[est], paramSpace=space,
                            parallelism=parallelism,
                            evaluationMetric="AUC").fit(ds)
    synchronize(dev)
    return dict(wall_s=time.perf_counter() - t0,
                all_metrics=m.get("allMetrics"),
                best_params=m.get("bestParams"),
                best_metric=m.get("bestMetric"), shapes=L.snapshot())


def a8_causal_rows(rng, n: int, F: int = 28, heterogeneous: bool = False):
    """30c's rows: ``F`` confounders, a binary treatment whose propensity
    depends on x0, and an outcome with the effect 2.0 (heterogeneous:
    1.5 where x1 <= 0 and 3.0 above)."""
    X = rng.normal(size=(n, F)).astype(np.float32)
    t = (rng.random(n) < 1 / (1 + np.exp(-X[:, 0]))).astype(np.float32)
    tau = np.where(X[:, 1] > 0, 3.0, 1.5) if heterogeneous else 2.0
    yv = (tau * t + 1.5 * X[:, 0] - X[:, 2] + X[:, 3] * X[:, 4]
          + rng.normal(0, 0.5, n)).astype(np.float32)
    return {"features": list(X), "treatment": t, "outcome": yv}


def a8_nuisance(dev, nuisance=None):
    """30c's (treatment, outcome) nuisance models on ``dev``
    (``nuisance``: their params, default :data:`P30_NUISANCE`)."""
    from synapseml_tpu_torch.models.gbdt.estimators import (GBDTClassifier,
                                                            GBDTRegressor)
    kw = nuisance or P30_NUISANCE
    return (GBDTClassifier(device=dev.type, **kw),
            GBDTRegressor(device=dev.type, **kw))


def a8_dml(cols, dev, max_iter: int = 2, seed: int = 0, nuisance=None):
    from synapseml_tpu_torch.causal import DoubleMLEstimator
    from synapseml_tpu_torch.core import Dataset
    tm, om = a8_nuisance(dev, nuisance)
    return DoubleMLEstimator(
        treatmentModel=tm, outcomeModel=om, treatmentCol="treatment", outcomeCol="outcome", maxIter=max_iter,
        seed=seed).fit(Dataset(dict(cols)))


def a8_forest(cols, dev, seed: int = 0, forest=None):
    """``OrthoForestDMLEstimator`` with GBDT nuisance models and its
    default forest (on the card), or ``forest``."""
    from synapseml_tpu_torch.causal import OrthoForestDMLEstimator
    from synapseml_tpu_torch.core import Dataset
    tm, om = a8_nuisance(dev)
    kw = {} if forest is None else {"heterogeneityModel": forest}
    return OrthoForestDMLEstimator(
        treatmentModel=tm, outcomeModel=om, treatmentCol="treatment", outcomeCol="outcome", seed=seed,
        **kw).fit(Dataset(dict(cols)))


def a8_stages(seed: int, dev, card: str, check_path, rows: int = 1_000_000,
              hold: int = 100_000, tune_rows: int = P30_TUNE_ROWS,
              dml_rows: int = P30_DML_ROWS, small: int = P30_SMALL,
              dml_small: int = P30_DML_SMALL, iters: int = P30_ITERS,
              auc_floor: float = 0.8, forest_cpu: bool = False) -> dict:
    """Phase 30: the JAX-free stages over the GBDT on ``dev``.  (a)
    ``TrainClassifier`` → ``ComputeModelStatistics`` at ``rows`` (run
    ``phase30a``), and the same stage at ``small`` rows on ``dev`` and on
    the CPU: equal trees (``split_digest``), margins within 1e-6, equal
    labels.  (b) ``TuneHyperparameters`` at parallelism 1 and 4 (runs
    ``phase30b_p1``, ``phase30b_p4``): equal results and equal launch
    counts by shape.  (c) ``DoubleMLEstimator(maxIter=2)`` on a binary
    treatment with ATE 2.0 and ``OrthoForestDMLEstimator``'s default
    forest on a heterogeneous effect (run ``phase30c``), and DML (nuisance
    fits of 10 iterations) at ``dml_small`` rows on ``dev`` and on the
    CPU: raw effects within 1e-6.
    ``forest_cpu``: the forest on the CPU (its default device is the
    card; a small run on the CPU).  Raises on a failed check, after
    printing every reading."""
    from synapseml_tpu_torch.core import Dataset
    from synapseml_tpu_torch.kernels import launches as L
    rng = np.random.default_rng(seed + 30)
    out, fails = {}, []
    marks = [time.perf_counter()]

    def part(name: str) -> None:
        marks.append(time.perf_counter())
        out.setdefault("walls", {})[name] = marks[-1] - marks[-2]

    # (a) TrainClassifier at full width
    cols, hcols = a8_frame(rng, rows), a8_frame(rng, hold)
    a, _ = a8_train(cols, hcols, dev, iters)
    check_path("phase30a", a)
    out["a"] = a
    log(f"phase 30a: TrainClassifier(GBDTClassifier(numIterations={iters}))"
        f" on {rows} x 28 numeric + 1 string column (8 levels), string "
        f"label, holdout {hold} | {card}: featurize {a['featurize_s']:.2f} "
        f"s, label index {a['index_s']:.2f} s, GBDT fit {a['gbdt_fit_s']:.2f}"
        f" s ({a['s_per_iter']:.4f} s/iteration, binning "
        f"{a['binning_s']:.2f} s), stage fit {a['fit_s']:.2f} s; transform "
        f"{a['transform_s']:.2f} s (featurize {a['transform_featurize_s']:.2f}"
        f", GBDT {a['transform_gbdt_s']:.2f}); ComputeModelStatistics AUC "
        f"{a['auc']:.4f}, accuracy {a['accuracy']:.4f}; launches "
        f"{json.dumps(a['shapes'])}")
    if a["auc"] <= auc_floor:
        fails.append(f"30a: holdout AUC {a['auc']}")
    del cols
    small_cols = {k: v[:small] for k, v in a8_frame(
        np.random.default_rng(seed + 301), small).items()}
    h_small = {k: v[:4096] for k, v in hcols.items()}
    fits = {}
    t0 = time.perf_counter()
    for d in (dev, torch.device("cpu")):
        _, fits[d.type] = a8_train(small_cols, h_small, d, iters)
    bc, bp = (fits[dev.type].innerModel.booster,
              fits["cpu"].innerModel.booster)
    oc = fits[dev.type].transform(Dataset(dict(h_small)))
    op = fits["cpu"].transform(Dataset(dict(h_small)))
    diff = float(np.abs(np.stack(oc["rawPrediction"])
                        - np.stack(op["rawPrediction"])).max())
    same = split_digest(bc) == split_digest(bp)
    labels = list(oc["prediction"]) == list(op["prediction"])
    out["a_card_vs_cpu"] = dict(rows=small, same_trees=same,
                                margin_diff=diff, labels_equal=labels,
                                seconds=time.perf_counter() - t0)
    log(f"phase 30a: card vs CPU at {small} rows: "
        f"{json.dumps(out['a_card_vs_cpu'])}")
    if not (same and labels and diff <= 1e-6):
        fails.append(f"30a card vs CPU: {out['a_card_vs_cpu']}")
    del hcols
    part("a")

    # (b) the tuner at parallelism 1 and 4
    X = rng.normal(size=(tune_rows, 28)).astype(np.float32)
    y = gbdt_labels(rng, X)
    b = {p: a8_tune(X, y, dev, p, iters) for p in (1, 4)}
    for p in (1, 4):
        check_path(f"phase30b_p{p}", b[p])
    out["b"] = b
    keys = ("all_metrics", "best_params", "best_metric")
    log(f"phase 30b: TuneHyperparameters over GBDTClassifier(numIterations="
        f"{iters}), numLeaves {{15, 31}} x learningRate {{0.1, 0.2}}, AUC, "
        f"{tune_rows} rows (75% fit) | {card}: parallelism 1 wall "
        f"{b[1]['wall_s']:.2f} s, parallelism 4 wall {b[4]['wall_s']:.2f} s"
        f"; results {json.dumps({k: b[1][k] for k in keys})}; launches "
        f"{json.dumps(b[1]['shapes'])}")
    if any(b[1][k] != b[4][k] for k in keys):
        fails.append(f"30b: parallelism 4 gave "
                     f"{ {k: b[4][k] for k in keys} }")
    if b[1]["shapes"] != b[4]["shapes"]:
        fails.append(f"30b: launches at parallelism 4 {b[4]['shapes']} "
                     f"against {b[1]['shapes']}")
    del X, y
    part("b")

    # (c) double ML and the orthogonal forest
    crng = np.random.default_rng(seed + 302)
    dml_cols = a8_causal_rows(crng, dml_rows)
    het_cols = a8_causal_rows(crng, dml_rows, heterogeneous=True)
    forest = None
    if forest_cpu:
        from synapseml_tpu_torch.models.gbdt.estimators import GBDTRegressor
        forest = GBDTRegressor(boostingType="rf", numIterations=32,
                               maxDepth=4, device="cpu")
    L.reset()
    t0 = time.perf_counter()
    dml = a8_dml(dml_cols, dev)
    dml_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ortho = a8_forest(het_cols, dev, forest=forest)
    eff = ortho.transform(Dataset(dict(het_cols)))["treatmentEffect"]
    synchronize(dev)
    forest_s = time.perf_counter() - t0
    c = dict(shapes=L.snapshot(), dml_s=dml_s, forest_s=forest_s)
    check_path("phase30c", c)
    ate = dml.get_avg_treatment_effect()
    lo, hi = dml.get_confidence_interval()
    x1 = np.stack(het_cols["features"])[:, 1]
    hi_eff, lo_eff = float(eff[x1 > 0].mean()), float(eff[x1 <= 0].mean())
    c.update(ate=ate, ci=[lo, hi], effects=dml.get("rawTreatmentEffects"),
             group_effects={"x1>0": hi_eff, "x1<=0": lo_eff})
    s_cols = {k: v[:dml_small] for k, v in dml_cols.items()}
    t0 = time.perf_counter()
    raw = {d.type: a8_dml(s_cols, d, nuisance=P30_CHECK_NUISANCE).get(
        "rawTreatmentEffects") for d in (dev, torch.device("cpu"))}
    c["card_vs_cpu"] = dict(rows=dml_small, nuisance=P30_CHECK_NUISANCE,
                            effects=raw,
                            diff=float(np.max(np.abs(np.subtract(
                                raw[dev.type], raw["cpu"])))),
                            seconds=time.perf_counter() - t0)
    out["c"] = c
    log(f"phase 30c: DoubleMLEstimator(maxIter=2) with GBDTClassifier "
        f"treatment and GBDTRegressor outcome models "
        f"({json.dumps(P30_NUISANCE)}) "
        f"on {dml_rows} rows, ATE 2.0 | {card}: ATE {ate:.4f}, CI "
        f"[{lo:.4f}, {hi:.4f}], {dml_s:.2f} s; OrthoForestDMLEstimator's "
        f"default forest on an effect of 1.5 (x1 <= 0) and 3.0 (x1 > 0): "
        f"group means {json.dumps(c['group_effects'])}, {forest_s:.2f} s; "
        f"card vs CPU at {dml_small} rows {json.dumps(c['card_vs_cpu'])}; "
        f"launches {json.dumps(c['shapes'])}")
    if not (abs(ate - 2.0) <= 0.1 and lo <= ate <= hi):
        fails.append(f"30c: ATE {ate}, CI {lo, hi}")
    if not hi_eff > lo_eff + 0.3:
        fails.append(f"30c: group effects {c['group_effects']}")
    if c["card_vs_cpu"]["diff"] > 1e-6:
        fails.append(f"30c card vs CPU: {c['card_vs_cpu']}")
    part("c")
    log(f"phase 30 parts' walls {json.dumps(out['walls'])}")
    if fails:
        raise AssertionError("phase 30: " + "; ".join(fails))
    return out


# -- phase 31: the clients beside the card (ROADMAP A9) -----------------------

#: 31a: texts embedded through the mock at the width of OpenAI's ada-002,
#: at 8 requests in flight; the KNN's neighbours
P31_TEXTS, P31_EMBED_DIM, P31_CONCURRENCY, P31_K = 2048, 1536, 8, 10
#: 31c: the GBDT fit's rows (bench.py's 28 columns) and the sink's batch
P31_ROWS, P31_BATCH = 100_000, 1000
#: 31d: rows of the sentiment and anomaly legs
P31_SENTIMENT_ROWS, P31_GROUPS, P31_GROUP_ROWS = 64, 8, 16
#: where 31b's downloader keeps its cache; the phase removes it
P31_ROOT = os.path.join(os.path.dirname(CKPT_ROOT), "phase31")


def p31_embedding(text: str, seed: int) -> list:
    """The mock's embedding of ``text``: normal draws from a generator
    seeded by ``seed`` and a hash of the text, rounded to 6 decimals (the
    JSON the mock sends).  A text that starts ``topic <t>`` lies at half
    that scale around topic t's center (drawn from ``seed`` and t), as
    texts on one subject do: with ``P31_K`` texts a topic, each text's
    k nearest are its topic's, far nearer than any other, so which ids
    win does not hang on the last bits of the two devices' distances."""
    import hashlib
    h = int.from_bytes(hashlib.sha256(text.encode()).digest()[:8], "little")
    v = np.random.default_rng([seed, h]).normal(size=P31_EMBED_DIM)
    words = text.split()
    if words[0] == "topic":
        v = 0.5 * v + np.random.default_rng(
            [seed, int(words[1])]).normal(size=P31_EMBED_DIM)
    return np.round(v, 6).tolist()


class P31Server:
    """A local HTTP server on 127.0.0.1 (port 0, its own threads) that
    answers phase 31's clients: ``/embeddings`` (an OpenAI embedding
    per text), ``/models/<file>`` (the downloader's manifest and model),
    ``/push`` (the PowerBI sink: every posted row is kept), ``/sentiment``
    and ``/anomaly`` (the text-analytics and anomaly shapes).  A text or
    series whose first timestamp holds ``flaky`` is answered 503 once and
    then served; one holding ``reject`` is answered 400.  Counts every
    request by path."""

    def __init__(self, seed: int, files: dict):
        import threading
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
        from urllib.parse import urlparse
        self.seed, self.files = seed, files
        self.rows, self.counts, self.seen = [], {}, set()
        self.lock = threading.Lock()
        outer = self

        class H(BaseHTTPRequestHandler):
            # headers and body leave in separate writes: without this,
            # Nagle holds the body until the client's delayed ACK (~40 ms
            # a request)
            disable_nagle_algorithm = True

            def log_message(self, *a):
                pass

            def reply(self, data: bytes, status: int = 200):
                self.send_response(status)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                path = urlparse(self.path).path
                outer.count(path)
                data = outer.files.get(path.rsplit("/", 1)[-1])
                if data is None:
                    self.send_error(404)
                else:
                    self.reply(data)

            def do_POST(self):
                path = urlparse(self.path).path
                outer.count(path)
                n = int(self.headers.get("Content-Length", 0) or 0)
                body = json.loads(self.rfile.read(n))
                if path == "/embeddings":
                    self.reply(json.dumps({"data": [{"embedding":
                        p31_embedding(body["input"], outer.seed)}]})
                        .encode())
                elif path == "/push":
                    with outer.lock:
                        outer.rows.extend(body)
                    self.reply(b"")
                elif path in ("/sentiment", "/anomaly"):
                    key = (body["documents"][0]["text"]
                           if path == "/sentiment"
                           else body["series"][0]["timestamp"])
                    status = outer.injected(key)
                    if status:
                        self.send_error(status)
                    elif path == "/sentiment":
                        self.reply(json.dumps({"documents": [{
                            "id": "0", "sentiment": "positive" if "good"
                            in key else "negative"}]}).encode())
                    else:
                        self.reply(json.dumps({"isAnomaly": [
                            p["value"] > 50 for p in body["series"]]})
                            .encode())
                else:
                    self.send_error(404)

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), H)
        self.httpd.daemon_threads = True
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)
        self.thread.start()
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"

    def count(self, path: str) -> None:
        with self.lock:
            self.counts[path] = self.counts.get(path, 0) + 1

    def injected(self, key: str):
        """503 on a ``flaky`` key's first request, 400 on ``reject``."""
        if "reject" in key:
            return 400
        with self.lock:
            if "flaky" in key and key not in self.seen:
                self.seen.add(key)
                return 503
        return None

    def close(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(timeout=10)


def p31_embed_knn(srv, seed: int, dev) -> dict:
    """31a: ``OpenAIEmbedding`` over ``P31_TEXTS`` texts, ``P31_K`` a
    topic, at concurrency 8 (the vectors must be the mock's), then
    ``KNN(k=10)`` fit/transform on ``dev`` and on the CPU: equal
    neighbour ids, each text its own nearest."""
    from synapseml_tpu_torch.core import Dataset
    from synapseml_tpu_torch.nn import KNN
    from synapseml_tpu_torch.resilience import RetryPolicy
    from synapseml_tpu_torch.services import OpenAIEmbedding
    rng = np.random.default_rng(seed + 31)
    texts = np.array([f"topic {i // P31_K} ticket {i}: " + " ".join(
        f"w{w}" for w in rng.integers(0, 5000, 12))
        for i in range(P31_TEXTS)])
    t0 = time.perf_counter()
    emb = OpenAIEmbedding(url=srv.url + "/embeddings", model="ada-002",
                          concurrency=P31_CONCURRENCY,
                          retryPolicy=RetryPolicy(max_retries=2, base_s=0.0)
                          ).transform(Dataset({"text": texts}))
    embed_s = time.perf_counter() - t0
    if any(e is not None for e in emb["errors"]):
        raise AssertionError("31a: embedding errors "
                             f"{[e for e in emb['errors'] if e][:3]}")
    vecs = np.stack(list(emb["output"]))
    want = np.asarray([p31_embedding(t, seed) for t in texts], np.float32)
    if vecs.shape != (P31_TEXTS, P31_EMBED_DIM) or vecs.dtype != np.float32 \
            or not np.array_equal(vecs, want):
        raise AssertionError(f"31a: embeddings {vecs.shape} {vecs.dtype} "
                             "are not the mock's vectors")
    ds = Dataset({"features": list(vecs), "values": np.arange(P31_TEXTS)})
    ids, walls = {}, {}
    for d in (dev.type, "cpu"):
        t0 = time.perf_counter()
        out = KNN(k=P31_K, device=d).fit(ds).transform(ds)
        walls[d] = time.perf_counter() - t0
        ids[d] = [[int(m["value"]) for m in row] for row in out["output"]]
    if ids[dev.type] != ids["cpu"]:
        bad = sum(a != b for a, b in zip(ids[dev.type], ids["cpu"]))
        raise AssertionError(f"31a: KNN ids differ in {bad} rows")
    full = P31_TEXTS // P31_K * P31_K      # texts of the full topics
    if any(row[0] != i or len(row) != P31_K or (
            i < full and {j // P31_K for j in row} != {i // P31_K})
           for i, row in enumerate(ids["cpu"])):
        raise AssertionError("31a: a text's nearest are not itself and "
                             "its topic's")
    return dict(texts=P31_TEXTS, width=P31_EMBED_DIM,
                concurrency=P31_CONCURRENCY, embed_s=embed_s,
                records_per_s=P31_TEXTS / embed_s,
                knn_card_s=walls[dev.type], knn_cpu_s=walls["cpu"],
                requests=srv.counts.get("/embeddings", 0))


def p31_download_onnx(srv, seed: int, dev, root: str) -> dict:
    """31b: ``ModelDownloader`` fetches the manifest and the small CNN
    from the server (sha256 checked), refuses a tampered copy, and
    ``ONNXModel`` runs the downloaded model on ``dev`` and on the CPU:
    error over scale within phase 21a's f32 limit (1e-5)."""
    import hashlib
    from synapseml_tpu_torch.core import Dataset
    from synapseml_tpu_torch.downloader import ModelDownloader
    from synapseml_tpu_torch.models.onnx import ONNXModel
    dl = ModelDownloader(os.path.join(root, "models"), srv.url + "/models")
    t0 = time.perf_counter()
    got = dl.downloadByName("small_cnn")
    download_s = time.perf_counter() - t0
    payload = srv.files["small_cnn.onnx"]
    with open(got.uri, "rb") as f:
        data = f.read()
    if data != payload or hashlib.sha256(data).hexdigest() != got.hash:
        raise AssertionError("31b: downloaded bytes differ from the model")
    try:
        dl.downloadByName("small_cnn_tampered")
    except ValueError as e:
        if "hash mismatch" not in str(e):
            raise
    else:
        raise AssertionError("31b: a tampered model passed its sha256")
    if os.path.exists(os.path.join(root, "models", "small_cnn_tampered"
                                                   ".onnx")):
        raise AssertionError("31b: the tampered file was kept")
    images = np.random.default_rng(seed + 31).normal(
        size=(256, 3, 16, 16)).astype(np.float32)
    ds = Dataset({"image": list(images)})
    out = {}
    for d in (dev.type, "cpu"):
        m = ONNXModel(got.uri, feedDict={"image": "image"}, device=d)
        out[d] = np.stack(list(m.transform(ds)["logits"]))
    err = _scale_err(out[dev.type], out["cpu"])
    if out["cpu"].shape != (256, 5) or err > 1e-5:
        raise AssertionError(f"31b: ONNX card vs CPU {err} > 1e-5 "
                             f"({out['cpu'].shape})")
    return dict(bytes=len(payload), download_s=download_s,
                onnx_err_over_scale=err)


def p31_gbdt_sink(srv, seed: int, dev, iters: int, check_path) -> dict:
    """31c: ``GBDTClassifier`` fit on ``dev`` over ``P31_ROWS`` rows of
    bench.py's 28 columns (launch counts reset just before the fit, read
    just after, held by ``check_path("phase31", ...)``), transform, then
    ``PowerBIWriter`` posts id, prediction and probability in batches of
    ``P31_BATCH``, 4 at a time: the sink must hold every row once, with
    equal values."""
    from synapseml_tpu_torch.core import Dataset
    from synapseml_tpu_torch.io import PowerBIWriter
    from synapseml_tpu_torch.kernels import launches as L
    from synapseml_tpu_torch.models.gbdt import GBDTClassifier
    rng = np.random.default_rng(seed + 31)
    X = rng.normal(size=(P31_ROWS, 28)).astype(np.float32)
    y = gbdt_labels(rng, X)
    ds = Dataset({"features": list(X), "label": y})
    L.reset()
    t0 = time.perf_counter()
    model = GBDTClassifier(numIterations=iters, device=dev.type).fit(ds)
    synchronize(dev)
    fit_s = time.perf_counter() - t0
    r = dict(rows=P31_ROWS, fit_s=fit_s, shapes=dict(L.BY_SHAPE))
    check_path("phase31", r)
    out = model.transform(ds)
    proba = np.stack(list(out["probability"]))[:, 1]
    pred = np.asarray(out["prediction"], np.float64)
    sink = Dataset({"id": np.arange(P31_ROWS), "prediction": pred,
                    "probability": proba})
    srv.rows.clear()
    t0 = time.perf_counter()
    PowerBIWriter.write(sink, srv.url + "/push",
                        {"batchSize": str(P31_BATCH), "concurrency": "4"})
    sink_s = time.perf_counter() - t0
    rows = sorted(srv.rows, key=lambda row: row["id"])
    if [row["id"] for row in rows] != list(range(P31_ROWS)):
        raise AssertionError(f"31c: the sink holds {len(rows)} rows, not "
                             f"each of {P31_ROWS} once")
    if [row["prediction"] for row in rows] != pred.tolist() or \
            [row["probability"] for row in rows] != proba.tolist():
        raise AssertionError("31c: the sink's values differ from the "
                             "predictions")
    r.update(sink_s=sink_s, sink_rows_per_s=P31_ROWS / sink_s,
             posts=srv.counts.get("/push", 0),
             accuracy=float(np.mean(pred == y)))
    if r["posts"] != P31_ROWS // P31_BATCH or r["accuracy"] < 0.7:
        raise AssertionError(f"31c: {r['posts']} posts, accuracy "
                             f"{r['accuracy']}")
    return r


def p31_failures(srv) -> dict:
    """31d: ``TextSentiment`` and ``SimpleDetectAnomalies`` through the
    same server at zero-delay retries: the injected 503 is retried and
    the row served; the 400 lands in ``errors`` as the reference's
    ``"400 Bad Request"``; every other row is served."""
    from synapseml_tpu_torch.core import Dataset
    from synapseml_tpu_torch.resilience import RetryPolicy
    from synapseml_tpu_torch.services import (SimpleDetectAnomalies,
                                              TextSentiment)
    policy = RetryPolicy(max_retries=2, base_s=0.0)
    n = P31_SENTIMENT_ROWS
    texts = [("good" if i % 2 else "awful") + f" day {i}" for i in range(n)]
    texts[3], texts[10] = "good flaky day", "awful reject day"
    t0 = time.perf_counter()
    out = TextSentiment(url=srv.url + "/sentiment", concurrency=4,
                        retryPolicy=policy).transform(
        Dataset({"text": np.array(texts)}))
    sentiment_s = time.perf_counter() - t0
    errs = list(out["errors"])
    want = [None] * n
    want[10] = "400 Bad Request"
    if errs != want:
        raise AssertionError(f"31d: sentiment errors {errs}")
    for i, t in enumerate(texts):
        got = out["output"][i]
        if i != 10 and got["sentiment"] != ("positive" if "good" in t
                                           else "negative"):
            raise AssertionError(f"31d: row {i} sentiment {got}")
    G, R = P31_GROUPS, P31_GROUP_ROWS
    groups = np.repeat([f"g{g}" for g in range(G)], R)
    stamp = {"g2": "flaky-", "g5": "reject-"}
    ts = np.array([f"{stamp.get(g, '')}t{i % R:02d}"
                   for i, g in enumerate(groups)])
    vals = np.random.default_rng(31).uniform(0, 100, G * R)
    t0 = time.perf_counter()
    an = SimpleDetectAnomalies(url=srv.url + "/anomaly", groupbyCol="group",
                               concurrency=4, retryPolicy=policy).transform(
        Dataset({"group": groups, "timestamp": ts, "value": vals}))
    anomaly_s = time.perf_counter() - t0
    for i, g in enumerate(groups):
        e, o = an["errors"][i], an["output"][i]
        if g == "g5":
            if e != "400 Bad Request" or o is not None:
                raise AssertionError(f"31d: anomaly row {i}: {e} {o}")
        elif e is not None or o["isAnomaly"] != (vals[i] > 50):
            raise AssertionError(f"31d: anomaly row {i}: {e} {o}")
    counts = dict(sentiment=srv.counts.get("/sentiment", 0),
                  anomaly=srv.counts.get("/anomaly", 0))
    if counts != dict(sentiment=n + 1, anomaly=G + 1):
        raise AssertionError(f"31d: requests {counts}, want one retry each")
    return dict(sentiment_s=sentiment_s, anomaly_s=anomaly_s,
                sentiment_records_per_s=n / sentiment_s, requests=counts)


def clients_beside_the_card(seed: int, dev, card: str, iters: int,
                            check_path, root: str) -> dict:
    """Phase 31: the service clients, the downloader and the PowerBI sink
    against a local server, feeding stages that run on ``dev``
    (``p31_*``).  Raises on a failed check, after printing the
    readings."""
    import hashlib
    payload = onnx_small_cnn(seed)
    tampered = bytearray(payload)
    tampered[-1] ^= 0xFF
    sha = hashlib.sha256(payload).hexdigest()
    files = {"small_cnn.onnx": payload,
             "small_cnn_tampered.onnx": bytes(tampered),
             "manifest.json": json.dumps([
                 {"name": "small_cnn", "uri": "small_cnn.onnx",
                  "hash": sha, "size": len(payload)},
                 {"name": "small_cnn_tampered",
                  "uri": "small_cnn_tampered.onnx", "hash": sha,
                  "size": len(payload)}]).encode()}
    shutil.rmtree(root, ignore_errors=True)
    srv = P31Server(seed, files)
    out, marks = {}, [time.perf_counter()]
    try:
        for leg, fn in (
                ("a", lambda: p31_embed_knn(srv, seed, dev)),
                ("b", lambda: p31_download_onnx(srv, seed, dev, root)),
                ("c", lambda: p31_gbdt_sink(srv, seed, dev, iters,
                                            check_path)),
                ("d", lambda: p31_failures(srv))):
            out[leg] = fn()
            marks.append(time.perf_counter())
            out[leg]["wall_s"] = marks[-1] - marks[-2]
            log(f"phase 31{leg} | {card}: {json.dumps(out[leg])}")
    finally:
        srv.close()
        shutil.rmtree(root, ignore_errors=True)
    a, c = out["a"], out["c"]
    log(f"phase 31: OpenAIEmbedding {a['records_per_s']:.1f} records/s "
        f"({a['texts']} texts x {a['width']}, concurrency "
        f"{a['concurrency']}), KNN(k={P31_K}) card {a['knn_card_s']:.3f} s "
        f"/ CPU {a['knn_cpu_s']:.3f} s; GBDT fit {c['fit_s']:.2f} s at "
        f"{c['rows']} rows, PowerBI sink {c['sink_rows_per_s']:.0f} rows/s "
        f"| {card}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        log("no CUDA device: this script runs the port on a card")
        return 1
    from synapseml_tpu_torch.kernels import launches as L
    from synapseml_tpu_torch.kernels._build import build_all

    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    card = gpu_line()
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    log(f"device {name} | {card}")
    walls = {}
    mark = [time.perf_counter()]

    def wall(phase: str) -> None:
        """Print the wall of the phase that just ended, on its own line."""
        now = time.perf_counter()
        walls[phase] = now - mark[0]
        mark[0] = now
        log(f"phase {phase} wall {walls[phase]:.1f} s")

    # -- 1. build ------------------------------------------------------------
    t0 = time.perf_counter()
    built = build_all()
    log(f"built {sorted(built)} in {time.perf_counter() - t0:.2f} s")
    for lib, info in built.items():
        for line in info["log"].splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                log(f"  {lib}: {line.strip()}")

    wall("1")

    # -- 2. kernels at the main path's shapes --------------------------------
    rng = np.random.default_rng(args.seed)
    N, F, S, K = args.rows, 28, 16, 8
    src = "synapseml_tpu_torch/csrc/gbdt_hist.cu"
    refs = {"route_and_hist": "synapseml_tpu/models/gbdt/pallas_hist.py:526",
            "build_hist_nodes": "synapseml_tpu/models/gbdt/pallas_hist.py:317"}
    # (kernel, shape, the main-path runs that launch it): each depthwise
    # tree's root pass runs K2 at one slot, every other wave at S slots;
    # K1 builds the two-level root's K refined rows, and in a lossguide
    # fit the root and every split's left child, coarse and refined
    # phase 12's widths: the categorical fit's 28 + 4 columns, the EFB
    # task's 28 + 8 x 32 columns and its bundles (one per dense column,
    # one per one-hot block)
    FC, FO, FB = F + CAT_COLS, F + OH_BLOCKS * OH_LEVELS, F + OH_BLOCKS
    # the ranker's rows: 10,000 queries of 1-239 rows drawn as phase 13
    # draws them
    N_RANK = int(np.random.default_rng(args.seed + 13).integers(
        1, RANK_MAXG + 1, RANK_Q).sum())
    two_level = ("maxBin=255", "multiclass", "validation", "resumed",
                 "phase22c", "phase23", "phase24", "phase25r0", "phase25r1",
                 # phase 26's resumed attempts: 2 ranks of 500k rows, and
                 # one rank of all 1M after the shrink
                 "phase26a_r0_resumed", "phase26a_r1_resumed",
                 "phase26b_r0_resumed")
    # phase 25's runs on each of its two ranks (f: feature-parallel, 1M
    # rows a rank; v: voting and the data-parallel lossguide fit it is
    # held against, 500k rows a rank; r: the distributed ranker)
    p25 = {k: tuple(f"phase25r{r}_{k}{x}" for r in (0, 1)
                    for x in (("", "28", "_dplg") if k == "vote" else ("",)))
           for k in ("featpar", "vote", "ranker")}
    mono = ("monotone basic", "monotone intermediate", "monotone advanced")
    # phase 30's runs: 30a's TrainClassifier fit (two-level at 1M rows over
    # the featurized 28 + 8 one-hot columns), 30b's tuner at parallelism 1
    # and 4 (~187,500 rows: two-level off) and 30c's DML and forest fits
    # (62,500-125,000 rows: two-level off)
    p30b = ("phase30b_p1", "phase30b_p4")
    p30_full = p30b + ("phase30c",)
    # phase 31c's GBDT fit at 100,000 rows: two-level off, K2 at full
    # resolution (its roots and waves)
    p31 = ("phase31",)
    shapes = [
        ("route_and_hist", dict(F=F, B=64, shift=0, K=0, S=1),
         ("maxBin=63",)),
        ("route_and_hist", dict(F=F, B=64, shift=0, K=0, S=S),
         ("maxBin=63",)),
        ("route_and_hist", dict(F=F, B=256, shift=3, K=0, S=1), two_level),
        ("route_and_hist", dict(F=F, B=256, shift=3, K=K, S=S), two_level),
        # the two-level fine build: K of the F rows, by id
        ("build_hist_nodes", dict(F=F, B=256, shift=0, S=1, K=K),
         two_level + ("lossguide", "categorical", "phase30a")),
        # lossguide's per-split coarse build: all F rows at one slot over
        # a left child's rows
        ("build_hist_nodes", dict(F=F, B=256, shift=3, S=1), ("lossguide",)),
        # the node-batched shape of the depthwise grower's unfused build
        # (trainer.py:1220, not ported): checked and timed, but no fit of
        # the port launches it
        ("build_hist_nodes", dict(F=F, B=64, shift=0, S=S), ()),
        # the feature-parallel grower's node-batched build (trainer.py:
        # 1657): each of phase 25's two ranks builds its 14 of the 28
        # features over all rows, 16 slots a wave (the root in slot 0)
        ("build_hist_nodes", dict(F=F // 2, B=256, shift=0, S=S),
         p25["featpar"]),
        # voting-parallel: lossguide at full resolution over a rank's
        # half of the rows, one slot a split (and the data-parallel
        # lossguide fit with two-level off it is held against)
        ("build_hist_nodes", dict(F=F, B=256, shift=0, S=1, N=N // 2),
         p25["vote"]),
        # the categorical fit (two-level, 32 columns)
        ("route_and_hist", dict(F=FC, B=256, shift=3, K=0, S=1),
         ("categorical",)),
        ("route_and_hist", dict(F=FC, B=256, shift=3, K=K, S=S),
         ("categorical",)),
        # EFB and monotone constraints switch two-level off: K2 and K1 at
        # full resolution, B=256; the EFB waves route through each split
        # feature's range in its bundled column
        ("route_and_hist", dict(F=FB, B=256, shift=0, K=0, S=S,
                                ranges="bundle"), ("EFB depthwise",)),
        ("route_and_hist", dict(F=FB, B=256, shift=0, K=0, S=1),
         ("EFB depthwise",)),
        ("route_and_hist", dict(F=FO, B=256, shift=0, K=0, S=S),
         ("unbundled depthwise",)),
        ("route_and_hist", dict(F=FO, B=256, shift=0, K=0, S=1),
         ("unbundled depthwise",)),
        ("route_and_hist", dict(F=F, B=256, shift=0, K=0, S=S),
         mono + p30_full + p31),
        ("route_and_hist", dict(F=F, B=256, shift=0, K=0, S=1),
         mono + p30_full + p31),
        # phase 30a's waves and roots over 28 + 8 featurized columns, and
        # 30b's numLeaves=15 trials (14 slots a wave)
        ("route_and_hist", dict(F=F + P30_LEVELS, B=256, shift=3, K=K, S=S),
         ("phase30a",)),
        ("route_and_hist", dict(F=F + P30_LEVELS, B=256, shift=3, K=0, S=1),
         ("phase30a",)),
        ("route_and_hist", dict(F=F, B=256, shift=0, K=0, S=14,
                                N=P30_TUNE_ROWS * 3 // 4), p30b),
        ("build_hist_nodes", dict(F=FB, B=256, shift=0, S=1),
         ("EFB lossguide",)),
        ("build_hist_nodes", dict(F=FO, B=256, shift=0, S=1),
         ("unbundled lossguide",)),
        # phase 13's ranker at MSLR-WEB10K's width (two-level on at ~1.2M
        # rows): its waves, roots and refined builds over 136 features
        # (and phase 25's distributed ranker, ~600k rows a rank: the
        # same launch keys)
        ("route_and_hist", dict(F=RANK_F, B=256, shift=3, K=K, S=S,
                                N=N_RANK), ("ranker",) + p25["ranker"]),
        ("route_and_hist", dict(F=RANK_F, B=256, shift=3, K=0, S=1,
                                N=N_RANK), ("ranker",) + p25["ranker"]),
        ("build_hist_nodes", dict(F=RANK_F, B=256, shift=0, S=1, K=K,
                                  N=N_RANK), ("ranker",) + p25["ranker"]),
        # phase 13's streamed fit at HIGGS's 11M rows
        ("route_and_hist", dict(F=F, B=256, shift=3, K=K, S=S, N=HIGGS_N),
         ("streamed",)),
        ("route_and_hist", dict(F=F, B=256, shift=3, K=0, S=1, N=HIGGS_N),
         ("streamed",)),
        ("build_hist_nodes", dict(F=F, B=256, shift=0, S=1, K=K,
                                  N=HIGGS_N), ("streamed",)),
    ]
    cases = []
    for kern, dims, runs in shapes:
        n_case = dims.pop("N", N)
        if kern == "route_and_hist":
            r = k2_case(rng, dev, n_case, **dims)
            dims.pop("ranges", None)
            key = L.launch_key(kern, **dims, variant="rows")
        else:
            r = k1_case(rng, dev, n_case, **dims)
            key = L.launch_key(kern, F=dims.get("K") or dims["F"],
                               B=dims["B"], shift=dims["shift"], S=dims["S"],
                               variant="rows")
        r["N"] = n_case
        torch.cuda.empty_cache()
        route = (f", route alone {r['route_ms']:.4f} ms"
                 if "route_ms" in r else "")
        log(f"{key} N={n_case}: identical to plain and to the previous "
            f"kernel; kernel "
            f"{r['ms']:.4f} ms, previous kernel {r['previous_ms']:.4f} ms"
            f"{route}, plain {r['plain_ms']:.4f} ms, library "
            f"{r['library_ms']} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bytes']} B, {r['bound_by']}; {r['bw_share']:.3f} of "
            f"3.35 TB/s); rows listed {r['rows_listed']}; geometry "
            f"{json.dumps(r['geometry'])}")
        cases.append((key, kern, runs, r))

    wall("2")

    # -- data: bench.py's task at full width, and a holdout -----------------
    drng = np.random.default_rng(args.seed)
    X = drng.normal(size=(N, F)).astype(np.float32)
    y = gbdt_labels(drng, X)
    Xh = drng.normal(size=(100_000, F)).astype(np.float32)
    yh = gbdt_labels(drng, Xh)
    # -- 3. the card against the CPU --------------------------------------
    # two-level forced on (K1, coarse+refine K2 and the two-level split
    # pick, as the default fit runs them at 1M rows) and off (plain K2);
    # this also loads the CUDA modules the fit uses, so the main path
    # below is timed in a warm process
    n_small = 65_536
    for tl in ("on", "off"):
        diff = card_vs_cpu(X[:n_small], y[:n_small], Xh[:4096],
                           ("route_and_hist",) + (("build_hist_nodes",)
                                                  if tl == "on" else ()),
                           two_level_hist=tl)
        if diff > 1e-4:
            raise AssertionError(f"two_level={tl}: card and CPU margins "
                                 f"differ by {diff}")
        log(f"card vs CPU, two_level={tl}: same splits, margins within "
            f"{diff:.3g}")

    wall("3")

    # -- 4. the main path at full width ------------------------------------
    # counts are reset just before and read just after each fit
    paths = {}

    def check_path(name, r, strict: bool = False):
        """Every kernel shape of the run ``name`` launched in it; with
        ``strict``, every shape it launched is one phase 2 held against
        the plain version."""
        for key, _, runs, _ in cases:
            if name in runs and r["shapes"].get(key, 0) <= 0:
                raise AssertionError(f"{name}: {key} never launched on "
                                     "the main path")
        held = {key for key, _, _, _ in cases}
        unheld = {k for k, v in r["shapes"].items() if v and k not in held}
        if strict and unheld:
            raise AssertionError(f"{name}: launched {unheld}, shapes phase 2 "
                                 "did not hold against the plain version")
        paths[name] = r

    models = {"Xh": Xh}          # phase 13 exports these
    for max_bin in (255, 63):
        r, stage = fit_path(X, y, Xh, yh, args.iters, maxBin=max_bin)
        if max_bin == 255:
            models["default"] = stage
            # phase 25's one-process fit: the same rows and config
            solo_s_per_iter = r["s_per_iter"]
        log(f"fit maxBin={max_bin}: {json.dumps(r)}")
        check_path(f"maxBin={max_bin}", r)
        if r["auc"] <= 0.8:
            raise AssertionError(f"maxBin={max_bin}: holdout AUC "
                                 f"{r['auc']}")

    wall("4")

    # -- 5. where the time goes --------------------------------------------
    log(f"profile maxBin=255: {json.dumps(profile_fit(X, y, 2))}")
    del X, y, yh
    wall("5")

    # -- 6. K3 at the engine's shapes ---------------------------------------
    from synapseml_tpu_torch.models.llm import (LlamaConfig, LlamaModel,
                                                cast_params)
    krng = np.random.default_rng(args.seed)
    B, H, KV, D, T = 16, 32, 8, 64, 2048
    edges = [1, 63, 64, 65, 255, 256, 257, 2047, 2048]
    spans = np.concatenate([edges, krng.integers(1, T + 1, B - len(edges))])
    # phase 19c's engine: 8 slots of bench.py's 12-layer model (16 heads,
    # 4 kv heads of 64) over a 256-token cache
    B19, H19, KV19, T19 = 8, 16, 4, 256
    spans19 = np.concatenate([[1, 63, 64, 65, 128, 255, 256],
                              krng.integers(1, T19 + 1, 1)])
    # phase 20a's engines: 4 slots of the tiny model (8 heads, 4 kv heads
    # of 16) over 128 positions, f32
    spans20 = [1, 31, 64, 128]
    # phase 27a's decode servers: 4 slots of the 1B width over 512
    # positions, f32; 27b's: 8 slots of the 1B model over 2048, bf16
    spans27a = [1, 64, 213, 512]
    spans27b = [1, 63, 65, 256, 1100, 1187, 2047, 2048]
    k3 = {}
    for S, dt, geo in (
            *((S, torch.bfloat16, (B, H, KV, D, T, spans))
              for S in (1, 2, 4, 8, 32)),
            (1, torch.float32, (B, H, KV, D, T, spans)),
            *((S, torch.bfloat16, (B19, H19, KV19, D, T19, spans19))
              for S in (1, 2, 4, 8)),
            (1, torch.float32, (TIER_SLOTS, 8, 4, 16, TIER_LEN, spans20)),
            (1, torch.float32, (4, H, KV, D, 512, spans27a)),
            (8, torch.float32, (4, H, KV, D, 512, spans27a)),
            (1, torch.bfloat16, (8, H, KV, D, T, spans27b))):
        b, h, kv, d, t, sp = geo
        r = k3_case(dev, args.seed + S, b, S, h, kv, d, t, dt, sp)
        key = r["launch_key"]
        log(f"{key}: max_abs_err {r['max_abs_err']:.3g} (SDPA "
            f"{r['sdpa_err']:.3g}); kernel {r['ms']:.4f} ms, previous "
            f"kernel {r['previous_ms']:.4f} ms, plain {r['plain_ms']:.4f} "
            f"ms, SDPA {r['library_ms']:.4f} ms (kernel/SDPA "
            f"{r['vs_sdpa']:.3f}), bound {r['bound_ms']:.4f} ms "
            f"({r['bytes']} B, {r['bound_by']}; {r['bw_share']:.3f} of "
            f"3.35 TB/s)")
        k3[key] = r
        # the previous kernel at this shape, which a tuning table may pick
        # for an engine (phase 24): held and timed above
        k3[key.replace(",variant=split]", ",variant=previous]")] = \
            dict(r, ms=r["previous_ms"],
                 max_abs_err=r["previous_max_abs_err"])

    wall("6")

    # -- 7. the engine on the card against the engine on the CPU ------------
    t0 = time.perf_counter()
    log(f"LLM card vs CPU, f32, 2 layers: tokens equal (and equal to dense "
        f"generate): {json.dumps(llm_card_vs_cpu(dev, args.seed))} in "
        f"{time.perf_counter() - t0:.1f} s")

    wall("7")

    # -- 8. the LLM main path at full width and depth -----------------------
    cfg = LlamaConfig.llama3_1b(max_len=T)
    model = cast_params(LlamaModel(cfg, device=dev, seed=args.seed),
                        cfg.dtype)
    prng = np.random.default_rng(args.seed)
    lengths = prng.integers(64, 1537, LLM_REQUESTS)
    prompts = phrase_prompts(prng, lengths, cfg.vocab_size, 8)
    new = [64] * LLM_REQUESTS
    # each speculative setting eagerly and with graphs, in turns: eager,
    # graph, graph, eager; runs[spec][warmup] lists that mode's runs
    runs = {0: {"off": [], "sync": []}, 7: {"off": [], "sync": []}}
    outs = {0: {}, 7: {}}
    for spec in (0, 7):
        for warmup in ("off", "sync", "sync", "off"):
            r, o = llm_main_path(model, prompts, new, spec, warmup=warmup)
            log(f"LLM llama3_1b bf16, 16 slots, spec_draft_len={spec}, "
                f"warmup={warmup}: {json.dumps(r)}")
            runs[spec][warmup].append(r)
            outs[spec].setdefault(warmup, o)
            if spec == 0 and not any(
                    k.endswith(",S=1,H=32,KV=8,D=64,T=2048,dtype=bf16,"
                               "variant=split]") for k in r["launches"]):
                raise AssertionError(f"the plain run (warmup={warmup}) "
                                     "never launched K3 at S=1")
            if spec and not any(",S=1," not in k for k in r["launches"]):
                raise AssertionError(f"the speculative run (warmup="
                                     f"{warmup}) never launched K3 at S>1")
        eager, graph = runs[spec]["off"], runs[spec]["sync"]
        agree = float(np.mean([np.mean(outs[spec]["sync"][i]
                                       == outs[spec]["off"][i])
                               for i in range(len(prompts))]))
        log(f"graph vs eager, spec_draft_len={spec}: decode tokens/s "
            f"{[r['decode_tokens_per_s'] for r in graph]} against "
            f"{[r['decode_tokens_per_s'] for r in eager]}, mean step ms "
            f"{[r['mean_step_ms'] for r in graph]} against "
            f"{[r['mean_step_ms'] for r in eager]}, TTFT p50 ms "
            f"{[r['ttft_p50_ms'] for r in graph]} against "
            f"{[r['ttft_p50_ms'] for r in eager]}; token agreement "
            f"{agree:.4f}")
    # the main path is the graph engine: its first runs give the kernels
    # line's launches
    llm_runs = {spec: runs[spec]["sync"][0] for spec in (0, 7)}
    dense, dense_outs = llm_main_path(model, prompts, new, 0, "dense")
    log(f"LLM llama3_1b bf16, dense backend: {json.dumps(dense)}")
    for spec in (0, 7):
        agree = float(np.mean([np.mean(outs[spec]["off"][i] == dense_outs[i])
                               for i in range(len(prompts))]))
        log(f"token agreement, paged spec_draft_len={spec} vs dense: "
            f"{agree:.4f} (reported; random bf16 weights give near-tied "
            "argmaxes)")

    wall("8")

    # -- 9. where the decode time goes ------------------------------------
    for warmup in ("off", "sync"):
        log(f"profile LLM decode, warmup={warmup}: "
            f"{json.dumps(profile_decode(model, prompts, new, warmup))}")
    wall("9")

    # -- 10. GBDT breadth at full width ------------------------------------
    drng = np.random.default_rng(args.seed)
    X = drng.normal(size=(N, F)).astype(np.float32)
    y = gbdt_labels(drng, X)
    Xh = drng.normal(size=(100_000, F)).astype(np.float32)
    yh = gbdt_labels(drng, Xh)
    # 10a. lossguide: K1 at one slot per split, coarse and refined
    r, gbdt = fit_path(X, y, Xh, yh, args.iters, growthPolicy="lossguide",
                       numLeaves=31, maxBin=255)
    check_path("lossguide", r)
    builds = r["trees"] + r["splits"]          # the root and every split
    lg_keys = [key for key, _, runs, _ in cases if "lossguide" in runs]
    if r["two_level"] != "on" or any(r["shapes"][k] != builds
                                     for k in lg_keys):
        raise AssertionError(f"lossguide: {builds} builds, launches "
                             f"{r['shapes']}, two_level {r['two_level']}")
    if r["auc"] <= 0.8:
        raise AssertionError(f"lossguide: holdout AUC {r['auc']}")
    # one host sync per split attempt: the splits, and a last check
    # unless the leaf budget ended the tree
    r["host_syncs_per_tree"] = sum(
        min(30, (int(t.num_nodes) - 1) // 2 + 1)
        for t in gbdt.booster.trees) / r["trees"]
    r["depthwise_s_per_iter"] = paths["maxBin=255"]["s_per_iter"]
    log(f"fit lossguide maxBin=255: {json.dumps(r)}")
    log(f"profile lossguide maxBin=255: "
        f"{json.dumps(profile_fit(X, y, 2, growthPolicy='lossguide'))}")
    # 10b. multiclass with bagging: three classes from the tertiles of
    # the label concept's score, depthwise, K trees per iteration
    cut = np.quantile(X[:, 0] * 2 - X[:, 1] + X[:, 2] * X[:, 3], [1 / 3,
                                                                   2 / 3])

    def three(Z, rng):
        return np.digitize(Z[:, 0] * 2 - Z[:, 1] + Z[:, 2] * Z[:, 3]
                           + rng.normal(scale=0.5, size=len(Z)),
                           cut).astype(np.float64)
    y3, yh3 = three(X, drng), three(Xh, drng)
    r, models["three"] = fit_path(X, y3, Xh, yh3, args.iters, maxBin=255,
                                  baggingFraction=0.8, baggingFreq=1)
    check_path("multiclass", r)
    root = L.launch_key("route_and_hist", F=F, B=256, shift=3, K=0, S=1,
                        variant="rows")
    if r["trees"] != 3 * args.iters or r["shapes"][root] != r["trees"]:
        raise AssertionError(f"multiclass: {r['trees']} trees, K2 roots "
                             f"{r['shapes'].get(root)}")
    if r["accuracy"] <= 0.55:
        raise AssertionError(f"multiclass: holdout accuracy "
                             f"{r['accuracy']}")
    log(f"fit multiclass bagging 0.8 maxBin=255: {json.dumps(r)}")

    wall("10")

    # -- 11. breadth: the card against the CPU ------------------------------
    # at an eighth of phase 3's rows: each config's CPU fit is what takes
    # the time (32,768 rows took 67.2 s of wall and 16,384 rows 35.9 s)
    n11 = n_small // 8
    log(f"phase 11 at {n11} rows (cut from 32768 to make room for phase "
        f"27: 67.2 s of wall at 32768, 35.9 s at 16384)")
    Xs, Xhs = X[:n11], Xh[:4096]
    score = Xs[:, 0] * 2 - Xs[:, 1] + Xs[:, 2] * Xs[:, 3]
    ys = {"binary": y[:n11], "multi": y3[:n11],
          "huber": 0.3 * score.astype(np.float64),
          "poisson": np.exp(0.5 * Xs[:, 0] + 0.2 * Xs[:, 1]).astype(
              np.float64) * drng.gamma(2.0, 0.5, n11)}
    data = {kind: (Xs, yk, Xhs) for kind, yk in ys.items()}
    # phase 12's generated columns at this size, and a validation
    # set of the task's next 16,384 rows
    r11 = np.random.default_rng(args.seed + 11)
    for kind, add in (("categorical", with_categorical),
                      ("onehot", with_onehot)):
        Xk, extra = add(r11, Xs)
        data[kind] = (Xk, gbdt_labels(r11, Xs, extra), add(r11, Xhs)[0])
    valid_s = (X[n11:n11 + 16_384], y[n11:n11 + 16_384],
               None)
    # lambdarank over groups of 1-239 rows (some past 128), and streamed
    # fits from an SMLC file (an odd chunk size) and from an SMLS file of
    # the one-hot blocks with EFB
    rel = np.clip(Xs[:, 0] + 0.5 * Xs[:, 1]
                  + r11.normal(scale=0.3, size=n11), 0, None)
    data["rank"] = (Xs, np.digitize(rel, [0.5, 1.2, 2.0, 2.8]).astype(
        np.float64), Xhs)
    gsizes = groups_to(r11.integers(1, RANK_MAXG + 1, n11), n11)
    from synapseml_tpu_torch.io import colstore as CS
    build_dir = os.path.dirname(CKPT_ROOT)
    os.makedirs(build_dir, exist_ok=True)
    p_dense = os.path.join(build_dir, "phase11.smlc")
    CS.write_matrix(p_dense, np.concatenate(
        [Xs, ys["binary"][:, None].astype(np.float32)], axis=1))
    Xo, yo, Xho = data["onehot"]
    p_sparse = os.path.join(build_dir, "phase11.smls")
    CS.write_csr(p_sparse, *CS.dense_to_csr(Xo), Xo.shape[1], labels=yo)
    data["stream"] = (CS.ChunkedColumnSource(p_dense, label_col=F,
                                             chunk_rows=4099), None, Xhs)
    data["stream_sparse"] = (CS.SparseChunkedSource(p_sparse,
                                                    chunk_rows=5001), None,
                             Xho)
    del X, y, Xh, yh, y3, yh3
    k1, k2 = ("build_hist_nodes",), ("route_and_hist",)
    breadth = [
        ("lossguide, two-level on", "binary", k1,
         dict(objective="binary", growth_policy="lossguide",
              two_level_hist="on")),
        ("lossguide, two-level off", "binary", k1,
         dict(objective="binary", growth_policy="lossguide",
              two_level_hist="off")),
        ("bagging", "binary", k2, dict(objective="binary",
                                       bagging_fraction=0.8, bagging_freq=1)),
        ("goss", "binary", k2, dict(objective="binary", boosting_type="goss")),
        ("dart", "binary", k2, dict(objective="binary", boosting_type="dart",
                                    skip_drop=0.0, drop_rate=0.5)),
        ("rf", "binary", k2, dict(objective="binary", boosting_type="rf",
                                  bagging_fraction=0.7, bagging_freq=1)),
        ("multiclass", "multi", k2, dict(objective="multiclass",
                                         num_class=3)),
        ("multiclassova", "multi", k2, dict(objective="multiclassova",
                                            num_class=3)),
        ("huber", "huber", k2, dict(objective="huber",
                                    min_sum_hessian_in_leaf=1.0)),
        ("poisson", "poisson", k2, dict(objective="poisson")),
        ("categorical", "categorical", k2, dict(
            objective="binary",
            categorical_feature=list(range(F, F + CAT_COLS)))),
        ("EFB depthwise", "onehot", k2, dict(objective="binary",
                                             enable_bundle=True)),
        ("EFB lossguide", "onehot", k1, dict(objective="binary",
                                             enable_bundle=True,
                                             growth_policy="lossguide")),
    ] + [(f"monotone {m} {g}", "binary", k1 if g == "lossguide" else k2,
          dict(objective="binary", monotone_constraints=MONO,
               monotone_constraints_method=m, growth_policy=g))
         for m in ("basic", "intermediate", "advanced")
         for g in ("depthwise", "lossguide")]
    runs11 = [(what, kind, kern, kw, {}) for what, kind, kern, kw in breadth]
    runs11 += [
        ("validation, early stopping", "binary", k2,
         dict(objective="binary", learning_rate=0.5, early_stopping_round=3,
              metric="auc"), dict(iters=40, valid=valid_s)),
        ("checkpoint resume", "binary", k2, dict(objective="binary"),
         dict(iters=4, resume=True)),
        ("lambdarank, groups of 1-239 rows", "rank", k2,
         dict(objective="lambdarank"),
         dict(train_kw=dict(group=gsizes))),
        ("lambdarank, labelGain", "rank", k2,
         dict(objective="lambdarank", label_gain=[0.0, 1.0, 2.5, 6.0, 20.0]),
         dict(train_kw=dict(group=gsizes))),
        ("streamed, ChunkedColumnSource chunk_rows=4099", "stream", k2,
         dict(objective="binary"), {}),
        ("streamed, SparseChunkedSource with EFB", "stream_sparse", k2,
         dict(objective="binary", enable_bundle=True), {}),
    ]
    for what, kind, kern, kw, extra in runs11:
        Xk, yk, Xhk = data[kind]
        diff = card_vs_cpu(Xk, yk, Xhk, kern, **{"iters": 2, **extra, **kw})
        if diff > 1e-4:
            raise AssertionError(f"{what}: card and CPU margins differ by "
                                 f"{diff}")
        log(f"card vs CPU, {what}: same splits, margins within {diff:.3g}")
    os.remove(p_dense)
    os.remove(p_sparse)
    log(f"card vs CPU, f32 against float64-rounded transcendentals at "
        f"{N // 3 * 3} rows (the fit's gradients equal): "
        f"{json.dumps(objectives_card_vs_cpu(dev, N, args.seed))}")
    for n in (n_small, N + 3):
        masks_card_vs_cpu(dev, n, args.seed)
    log(f"card vs CPU: bagging masks and GOSS weights bit-identical at "
        f"{n_small} and {N + 3} rows")

    wall("11")

    # -- 12. GBDT breadth II at half the rows (500k: two-level still on) ----
    breadth2(args.seed, N // 2, F, args.iters, check_path)
    wall("12")

    # -- 13. GBDT breadth III: ranker, streamed ingestion, text, TreeSHAP ----
    p13 = breadth3(args.seed, args.iters, check_path, models)
    del models
    wall("13")

    # -- 14. the DL text path: a BERT-base fine-tune ------------------------
    torch.cuda.empty_cache()
    # 4,096 training texts (64 steps) and 10-step windows, to make room
    # for phase 28 (8,192 texts and 20-step windows took 52.5-61.8 s)
    log("phase 14 at 4096 training texts and 10-step windows (cut from "
        "8192 and 20)")
    dl_text(args.seed, dev, n_train=4096, n_steps=10)
    wall("14")

    # -- 15. the DL vision path: ResNet-50 ----------------------------------
    torch.cuda.empty_cache()
    # 10-step windows, for phase 28 (20-step windows took 32.8-34.5 s;
    # the fit keeps its 32 steps for the BatchNorm averages)
    log("phase 15 at 10-step windows (cut from 20)")
    dl_vision(args.seed, dev, n_steps=10)
    wall("15")

    # -- 16. the online learners at Criteo's column shape --------------------
    torch.cuda.empty_cache()
    # one turn (eager, then graph): three turns cost ~17 s more; 16b's
    # rows are left for phase 25i.  65,536 + 16,384 rows, to make room for
    # phase 28 (131,072 + 32,768 took 42.0-44.4 s; 262,144 + 65,536 cost
    # ~15 s more than that here and ~3 s in 25i)
    log("phase 16 at 65536 + 16384 rows (cut from 131072 + 32768)")
    online(args.seed, dev, n_train=65_536, n_hold=16_384, turns=1,
           save=P25_ONLINE_ROWS)
    wall("16")

    # -- 17. the MoE text encoder at BERT-base width -------------------------
    torch.cuda.empty_cache()
    # 10-step windows, for phase 28 (20-step windows took 39.0-42.2 s)
    log("phase 17 at 10-step windows (cut from 20)")
    p17 = dl_moe(args.seed, dev, n_steps=10)
    wall("17")

    # -- 18. the LLM served over HTTP at full width ---------------------------
    torch.cuda.empty_cache()
    http = llm_http(model, prompts, new, outs[0]["sync"], dev)
    direct = llm_runs[0]
    direct_tokens = int(sum(len(o) for o in outs[0]["sync"].values()))
    log(f"LLMServer llama3_1b bf16, 16 slots, {LLM_REQUESTS} requests "
        f"(every other streamed), replies equal the direct engine's: "
        f"{json.dumps(http)}")
    log(f"HTTP {http['http_tokens_per_s']:.1f} tokens/s against the direct "
        f"engine's {direct_tokens / direct['wall_s']:.1f} (tokens over the "
        f"run's wall); decode {http['decode_tokens_per_s']:.1f} against "
        f"{direct['decode_tokens_per_s']:.1f} tokens/s, step "
        f"{http['mean_step_ms']:.3f} against {direct['mean_step_ms']:.3f} "
        f"ms; client TTFT p50/p90 {http['ttfb_p50_ms']:.1f}/"
        f"{http['ttfb_p90_ms']:.1f} ms against admit "
        f"{direct['ttft_p50_ms']:.1f}/{direct['ttft_p90_ms']:.1f} ms; "
        f"/sloz TTFT {json.dumps(http['sloz_ttft'])}")
    wall("18")

    # -- 19. fine-tune, then serve speculatively -------------------------------
    torch.cuda.empty_cache()
    # 120 fine-tune steps (250 cost ~11 s more; the loss still falls)
    p19 = finetune_serve(args.seed, dev, steps=120)
    wall("19")

    # -- 20. the rest of the LLM slice: arena, journal, int8, pretrained ------
    torch.cuda.empty_cache()
    shutil.rmtree(TIER_ROOT, ignore_errors=True)
    os.makedirs(TIER_ROOT)
    t0 = time.perf_counter()
    p20a = tier_card_vs_cpu(dev, args.seed, os.path.join(TIER_ROOT, "a"))
    log(f"phase 20a: tiny f32 card vs CPU, tokens equal (pretrained logits, "
        f"int8 engine, arena restore, preempt/resume, speculative, "
        f"LLMTransformer) and the SIGKILL failover resumed token-exact: "
        f"{json.dumps(p20a)} in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    # one turn of each engine (int8, bf16): two turns cost ~10 s more
    # the HF round trip over the first P20B_HF_LAYERS blocks, to make
    # room for phase 29 (all 16 blocks' 2.47 GB: 2.3 s write, 10.1 s read)
    log(f"phase 20b's HF directory at {P20B_HF_LAYERS} of 16 blocks (cut "
        f"from 16: 2.47 GB)")
    p20b = pretrained_int8(model, prompts, new, dev,
                           os.path.join(TIER_ROOT, "b"),
                           turns=("int8", "bf16"),
                           hf_layers=P20B_HF_LAYERS)
    log(f"phase 20b: Llama-3.2-1B from an HF directory, int8 against bf16: "
        f"{json.dumps(p20b)} in {time.perf_counter() - t0:.1f} s")
    log(f"phase 20b: decode tokens/s int8 {p20b['int8']['decode_tokens_per_s']}"
        f" against bf16 {p20b['bf16']['decode_tokens_per_s']}; step ms "
        f"{p20b['int8']['mean_step_ms']} against "
        f"{p20b['bf16']['mean_step_ms']}; K3 launches "
        f"{p20b['int8']['k3_launches']} against "
        f"{p20b['bf16']['k3_launches']}; greedy agreement "
        f"{p20b['agreement']:.4f}; relative logit error "
        f"{p20b['int8_rel_err']:.4g}")
    t0 = time.perf_counter()
    p20c = arena_journal_http(model, prompts, new, dev,
                              os.path.join(TIER_ROOT, "c"),
                              http["http_tokens_per_s"])
    log(f"phase 20c: LLMServer with a 2 GiB arena and a journal, 24 two-turn "
        f"conversations on 16 slots: {json.dumps(p20c)} in "
        f"{time.perf_counter() - t0:.1f} s")
    log(f"phase 20c's cold re-run over the first {p20c['cold_conversations']}"
        f" conversations, one wave of the 16 slots (cut from 24, two waves, "
        f"to make room for phase 27): {p20c['cold_s']:.1f} s")
    shutil.rmtree(TIER_ROOT, ignore_errors=True)
    wall("20")

    # -- 21. ONNX batch inference and the image stages -------------------------
    torch.cuda.empty_cache()
    from synapseml_tpu_torch.models.onnx import zoo
    resnet = zoo.build_resnet50(num_classes=1000, seed=args.seed)[0]
    p21a = onnx_card_vs_cpu(dev, args.seed, resnet)
    log(f"phase 21a: ONNX and image stages card vs CPU (error over scale) "
        f"| {card}: {json.dumps(p21a)}")
    p21 = onnx_image(args.seed, dev, card, resnet)
    wall("21")

    # -- 22. the explainers and the classic estimators -------------------------
    torch.cuda.empty_cache()
    L.reset()
    p22a = a6_card_vs_cpu(dev, args.seed)
    log(f"phase 22a: explainers and estimators card vs CPU (error, limit) "
        f"| {card}: {json.dumps(p22a)}")
    if L.BY_SHAPE:
        raise AssertionError(f"phase 22a launched {dict(L.BY_SHAPE)}")
    # ImageLIME over 2 images and tabular SHAP/LIME over 128 rows (8
    # images and 256 rows cost ~24 s more); AccessAnomaly on 10,000 users
    # x 5,000 resources and 500,000 triples, to make room for phase 28
    # (20,000 and 1,000,000: a 10.4 s fit)
    log("phase 22g at 10000 users and 500000 triples (cut from 20000 and "
        "1000000)")
    p22 = a6_paths(args.seed, dev, card, resnet, n_images=2, n_explain=128,
                   aa=(AA_USERS // 2, AA_RES, AA_TRIPLES // 2))
    check_path("phase22c", p22["gbdt"])
    log(f"phase 22: no K-kernel on this slice's path (the JAX package has "
        f"no TPU kernel here): the explainers, KNN, the isolation forest, "
        f"SAR and ALS launched none; K1/K2 launched only in 22c's GBDT fit "
        f"{json.dumps(p22['gbdt']['shapes'])}")
    del resnet
    wall("22")

    # -- 23. serving on the card: CSV → fit → PipelineServer ----------------
    torch.cuda.empty_cache()
    # 64 records a client, the two-API load at a quarter of its records,
    # 2,048 frames and 50,000 permissive lines, to make room for phase 27
    # (128 records, half the load, 4,096 frames and 100,000 lines took
    # 54.9-79.3 s of wall); the CSV keeps 500k rows, the fewest at which
    # the fit takes the two-level histograms its launch check expects
    log("phase 23 at 64 records a client, 256 + 512 records of the "
        "two-API load, 2048 frames and 50000 permissive lines (cut from "
        "128, 512 + 1024, 4096 and 100000: 54.9-79.3 s of wall before "
        "the cut)")
    serving_paths(args.seed, dev, card, p21.pop("bert"), check_path,
                  n_rows=N // 2, per_thread=64, n_bert=256,
                  n_gbdt_multi=512, n_frames=2048, n_lenient=50_000)
    del p21
    log(f"phase 23: no K-kernel outside the fit: K1/K2 launched only in "
        f"23b's GBDT fit {json.dumps(paths['phase23']['shapes'])}")
    wall("23")

    # -- 24. the profiling and tuning plane -----------------------------------
    torch.cuda.empty_cache()
    shutil.rmtree(P24_ROOT, ignore_errors=True)
    table_dir = os.path.join(P24_ROOT, "tunetable")
    p24 = {"a": tune_kernels(args.seed, dev, card, table_dir, rows=N)}
    p24["gbdt"] = tuned_gbdt(args.seed, dev, card, table_dir,
                             p24["a"]["hist"], rows=N, iters=args.iters)
    check_path("phase24", {"shapes": p24["gbdt"]["shapes"]})
    p24["llm"] = tuned_engines(args.seed, dev, card, table_dir, model,
                               prompts)
    p24["bert"] = profiled_bert(args.seed, dev, card)
    p24["de"] = tunez_and_trace(args.seed, dev, card, table_dir,
                                os.path.join(P24_ROOT, "trace"))
    shutil.rmtree(P24_ROOT, ignore_errors=True)
    wall("24")

    # -- 25. the parallel layer: a local gang of ranks on the one card -------
    torch.cuda.empty_cache()
    p25_out = parallel_gang(args.seed, dev, card, N, args.iters, check_path,
                            ranker_ndcg10=p13["ranker"]["valid_ndcg10"],
                            online_rows=P25_ONLINE_ROWS,
                            solo_s_per_iter=solo_s_per_iter)
    os.remove(P25_ONLINE_ROWS)
    wall("25")

    # -- 26. elastic resume: checkpoints, resize and the build cache ---------
    torch.cuda.empty_cache()
    elastic_resume(args.seed, dev, card, N, args.iters, check_path,
                   p25_out["main"]["none"][0])
    wall("26")

    # -- 27. the LLM served across replicas -----------------------------------
    torch.cuda.empty_cache()
    p27 = replicated_serving(
        args.seed, dev, card, P27_ROOT,
        exact_cfg=dict(kind="llama3_1b", num_layers=2, max_len=512,
                       dtype="float32"),
        gang_cfg=dict(kind="llama3_1b", max_len=2048),
        scale_cfg=dict(kind="tiny", num_layers=2, max_len=TIER_LEN,
                       dtype="float32"))
    wall("27")

    # -- 28. DL training over a gang of ranks ---------------------------------
    torch.cuda.empty_cache()
    dl_gang(args.seed, dev, card, p17b=p17["window"])
    wall("28")

    # -- 29. model parallelism over a gang ------------------------------------
    torch.cuda.empty_cache()
    L.reset()
    model_parallel(args.seed, dev, card)
    if L.BY_SHAPE:
        raise AssertionError(f"phase 29 launched {dict(L.BY_SHAPE)}")
    wall("29")

    # -- 30. the stages over the GBDT -----------------------------------------
    torch.cuda.empty_cache()
    log(f"phase 30c at {P30_DML_ROWS} rows and its card-against-CPU DML at "
        f"{P30_DML_SMALL} (cut from 250000 and 20000 for phase 31: 21.0 + "
        "12.5 and 22.1 s of a 1146.1 s run)")
    a8_stages(args.seed, dev, card, lambda n, r: check_path(n, r, True),
              rows=N)
    wall("30")

    # -- 31. the clients beside the card ---------------------------------------
    torch.cuda.empty_cache()
    clients_beside_the_card(args.seed, dev, card, args.iters,
                            lambda n, r: check_path(n, r, True), P31_ROOT)
    wall("31")
    log(f"phase walls {json.dumps(walls)}; total "
        f"{sum(walls.values()):.1f} s")

    # -- results -----------------------------------------------------------
    # each shape's launches in the runs that launch it
    kernels = []
    for key, kern, runs, r in cases:
        if not runs:
            continue
        by_run = {run: paths[run]["shapes"][key] for run in runs}
        kernels.append(dict(
            name=key if r["N"] == N else f"{key}@N={r['N']}", route="cuda",
            source=src, replaces=refs[kern], rows=r["N"],
            launches=sum(by_run.values()), launches_by_run=by_run,
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"], previous_ms=r["previous_ms"]))
    # each K3 shape with its launches in the LLM runs that run it: phase
    # 8's plain and speculative engines, phase 18's HTTP server and phase
    # 19c's servers; a verify width the drafts never reached is checked
    # in phase 6 and left out here.  Every shape a run launched must be
    # one phase 6 held against the plain version
    k3_runs = {"engine": llm_runs[0]["launches"],
               "engine_spec": llm_runs[7]["launches"],
               "http": http["launches"]}
    for label in ("random_init", "finetuned"):
        st = p19["serve"][label]
        k3_runs[f"p19_{label}_plain"] = st["plain_launches"]
        k3_runs[f"p19_{label}_spec"] = st["launches"]
    # phase 20's runs: the tiny engines and the failover server on the
    # card (20a), the int8 and bf16 engines (20b) and the arena server
    # (20c)
    k3_runs["p20a_engines"] = p20a["launches"]
    k3_runs["p20a_failover"] = p20a["launches_failover"]
    k3_runs["p20b_int8"] = p20b["int8"]["launches"]
    k3_runs["p20b_bf16"] = p20b["bf16"]["launches"]
    k3_runs["p20c_http"] = p20c["launches"]
    # phase 24's engines: 19c's geometry under the table, and the 1B
    # graph engine unprofiled and profiled
    k3_runs["p24_19c_tuned"] = p24["llm"]["19c"]["launches"]
    for label in ("plain", "profiled"):
        k3_runs[f"p24_graph_{label}"] = p24["llm"]["launches"][label]
    # phase 27's servers: 27a's colocated, disaggregated (by handoff
    # outcome) and failover replicas, 27b's two ranks in each pass, 27c's
    # replica set
    k3_runs.update(p27["a"]["launches"])
    k3_runs.update(p27["b"]["launches"])
    k3_runs["phase27c"] = p27["c"]["launches"]
    unchecked = {k for sh in k3_runs.values() for k in sh} - set(k3)
    if unchecked:
        raise AssertionError(f"K3 launched at shapes phase 6 did not hold "
                             f"against the plain version: {unchecked}")
    for key, r in k3.items():
        by_run = {run: sh[key] for run, sh in k3_runs.items()
                  if sh.get(key)}
        if not by_run:
            continue
        kernels.append(dict(
            name=key, route="cuda",
            source="synapseml_tpu_torch/csrc/paged_attn.cu",
            replaces="synapseml_tpu/models/llm/pallas_attn.py:315",
            launches=sum(by_run.values()), launches_by_run=by_run,
            max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
            previous_ms=r["previous_ms"]))
    log(json.dumps({"kernels": kernels}))
    log(gpu_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
